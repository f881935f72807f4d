"""/tpu/trends — windowed history over the history store.

The port's copy of ``headlamp_tpu/pages/trends_page.py``. A pure function
of ``HistoryStore.trend_view()``'s plain dict (no snapshot, no transport:
trends must paint even while the cluster sync is the thing under
investigation). One section per captured metric, each series drawn as a
strip chart: fixed-bucket inline-style bars with a stats line
underneath. Window selection is plain links: ``?window=`` round-trips
through the app's dispatch, keeping the page itself stateless.
"""

from __future__ import annotations

import urllib.parse
from typing import Any

from ..ui.components import NameValueTable, SectionBox
from ..ui.vdom import Element, h
from .common import cursor_controls

#: Window links offered in the header. Values are seconds; the store
#: clamps anything past its retention, so the 6 h link degrades to
#: "everything retained" on a shorter-retention store.
WINDOW_CHOICES: tuple[tuple[str, int], ...] = (
    ("15m", 900),
    ("1h", 3600),
    ("6h", 21600),
)

#: Buckets per strip chart. Fixed so the markup size is bounded by the
#: page, not by the retention (288-point shards at 48 buckets re-bucket
#: 6:1 at full window).
STRIP_BUCKETS = 48


def _fmt_value(value: float) -> str:
    if value != value:  # NaN guard — never propagate into markup
        return "–"
    if abs(value) >= 1000:
        return f"{value:,.0f}"
    if abs(value) >= 10:
        return f"{value:.1f}"
    return f"{value:.3f}"


def _fmt_age(seconds: float) -> str:
    if seconds >= 3600:
        return f"{seconds / 3600:.1f}h"
    if seconds >= 60:
        return f"{seconds / 60:.0f}m"
    return f"{seconds:.0f}s"


def _strip_chart(points: list[tuple[float, float]], window_s: float) -> Element:
    """Bucket (age_s, value) points onto a fixed time grid — newest at
    the right edge — and draw one proportional bar per bucket. Bars are
    scaled to the series' own [min, max] (a trend chart answers "how
    did it MOVE", not "how big is it" — the stats line carries the
    magnitudes); a flat series renders mid-height rather than empty."""
    buckets: list[list[float]] = [[] for _ in range(STRIP_BUCKETS)]
    span = max(window_s, 1e-9)
    for age_s, value in points:
        # age 0 (newest) → last bucket; age == window → bucket 0.
        idx = int((1.0 - min(age_s / span, 1.0)) * (STRIP_BUCKETS - 1))
        buckets[idx].append(value)
    means = [sum(b) / len(b) if b else None for b in buckets]
    present = [m for m in means if m is not None]
    lo, hi = min(present), max(present)
    scale = hi - lo
    cells = []
    for mean in means:
        if mean is None:
            cells.append(h("span", {"class_": "hl-trend-cell hl-trend-gap"}))
            continue
        frac = (mean - lo) / scale if scale > 0 else 0.5
        height = 8 + frac * 92  # floor keeps the minimum visible
        cells.append(
            h(
                "span",
                {
                    "class_": "hl-trend-cell",
                    "style": f"height:{height:.1f}%",
                    "title": _fmt_value(mean),
                },
            )
        )
    return h("div", {"class_": "hl-trend-strip"}, *cells)


def _series_block(series: dict[str, Any], window_s: float) -> Element:
    stats = series["stats"]
    slope = stats.get("slope_per_step", 0.0)
    arrow = "↗" if slope > 1e-9 else ("↘" if slope < -1e-9 else "→")
    oldest = max((age for age, _ in series["points"]), default=0.0)
    return h(
        "div",
        {"class_": "hl-trend-series"},
        h(
            "div",
            {"class_": "hl-trend-series-head"},
            h("strong", None, series["label"]),
            h(
                "span",
                {"class_": "hl-hint"},
                f"{arrow} latest {_fmt_value(stats['latest'])} · "
                f"mean {_fmt_value(stats['mean'])} · "
                f"min {_fmt_value(stats['min'])} · "
                f"max {_fmt_value(stats['max'])} · "
                f"{int(stats['n'])} pts over {_fmt_age(oldest)}",
            ),
        ),
        _strip_chart(series["points"], window_s),
    )


def _window_nav(active_s: float) -> Element:
    links = []
    for label, seconds in WINDOW_CHOICES:
        cls = "hl-trend-window"
        if abs(active_s - seconds) < 0.5:
            cls += " active"
        links.append(
            h("a", {"class_": cls, "href": f"/tpu/trends?window={seconds}"}, label)
        )
    return h("div", {"class_": "hl-trend-windows"}, "Window:", *links)


def _browse_href(metric: str, window_s: float) -> str:
    return (
        "/tpu/trends?metric="
        + urllib.parse.quote(metric, safe="")
        + f"&window={int(window_s)}&limit=64"
    )


def _browse_section(view: dict[str, Any]) -> Element:
    """Browse mode: every in-window series of one metric, label-sorted
    and cursor-windowed, the surface the grouped view's busiest-N cap
    would otherwise make unreachable."""
    browse = view["browse"]
    window_s = float(view["window_s"])
    window = browse["window"]
    controls = cursor_controls(
        "/tpu/trends",
        window,
        what="series",
        extra_params={
            "metric": browse["metric"],
            "window": str(int(window_s)),
        },
    )
    children: list[Any] = [
        h(
            "p",
            {"class_": "hl-hint"},
            h("a", {"href": f"/tpu/trends?window={int(window_s)}", "class_": "hl-res-link"}, "← all metrics"),
            " — every series, by label",
        ),
        controls,
        *[_series_block(series, window_s) for series in browse["series"]],
    ]
    if not browse["series"]:
        children.append(
            h(
                "p",
                {"class_": "hl-hint"},
                "No in-window series for this metric.",
            )
        )
    return SectionBox(f"{browse['metric']} — all series", *children)


def trends_page(view: dict[str, Any]) -> Element:
    """``view`` is ``HistoryStore.trend_view(window_s=...)``."""
    store = view["store"]
    window_s = float(view["window_s"])
    sections: list[Any] = [_window_nav(window_s)]
    if view.get("browse"):
        sections.append(_browse_section(view))
        return h("div", {"class_": "hl-trends"}, *sections)
    if not view["groups"]:
        sections.append(
            h(
                "p",
                {"class_": "hl-hint"},
                "No history captured yet — the store fills as scrapes and "
                "cluster syncs complete in the background (first points "
                "within one refresh TTL).",
            )
        )
    for group in view["groups"]:
        shown = group["series"]
        hidden = group["series_total"] - len(shown)
        children: list[Any] = [
            _series_block(series, window_s) for series in shown
        ]
        if hidden > 0:
            # Not a dead-end hint: the hidden tail is reachable through
            # the cursor-windowed browse mode.
            children.append(
                h(
                    "p",
                    {"class_": "hl-hint"},
                    f"Busiest {len(shown)} shown — ",
                    h(
                        "a",
                        {
                            "href": _browse_href(group["metric"], window_s),
                            "class_": "hl-res-link hl-browse-all",
                        },
                        f"browse all {group['series_total']} series",
                    ),
                )
            )
        sections.append(SectionBox(group["metric"], *children))
    sections.append(
        SectionBox(
            "History store",
            NameValueTable(
                [
                    ("Points captured", f"{store['points']:,}"),
                    ("Points evicted", f"{store['points_evicted']:,}"),
                    ("Series (shards)", f"{store['shards']:,}"),
                    ("Shards evicted", f"{store['shards_evicted']:,}"),
                    ("Scrapes / syncs", f"{store['scrapes']:,} / {store['syncs']:,}"),
                    ("Memory", f"{store['memory_bytes'] / 1024:.1f} KiB"),
                    (
                        "Answerable span",
                        f"{_fmt_age(store['window_span_s'])} of "
                        f"{_fmt_age(store['retention_s'])} retention",
                    ),
                ]
            ),
        )
    )
    return h("div", {"class_": "hl-trends"}, *sections)

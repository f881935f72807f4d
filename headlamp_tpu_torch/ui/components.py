"""Common components — the slice of the JAX package's kit
(``headlamp_tpu/ui/components.py``) that the port's pages render.

Semantics mirror the Headlamp kit the reference composes (SectionBox,
SectionHeader, SimpleTable, NameValueTable, StatusLabel, Loader,
PercentageBar), plus the SLO page's BudgetBar. Each returns an
:class:`Element`; ``class_`` names (``hl-*``) are the stable hooks tests
and the stylesheet key off.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Mapping, Sequence

from .vdom import Element, h

# Column spec: {"label": str, "getter": callable(row) -> Child} or
# {"label": str, "key": str} for dict rows — SimpleTable's two forms.
Column = Mapping[str, Any]


def SectionBox(title: str | None, *children: Any, class_: str = "") -> Element:
    """Titled section container (SectionBox + implicit SectionHeader)."""
    cls = f"hl-section {class_}".strip()
    return h(
        "section",
        {"class_": cls},
        h("h2", {"class_": "hl-section-title"}, title) if title else None,
        *children,
    )


def SectionHeader(title: str, *actions: Any) -> Element:
    return h(
        "header",
        {"class_": "hl-section-header"},
        h("h2", None, title),
        h("div", {"class_": "hl-actions"}, *actions) if actions else None,
    )


def SimpleTable(
    columns: Sequence[Column],
    data: Iterable[Any],
    *,
    empty_message: str = "No data",
    row_key: Callable[[Any], str] | None = None,
    row_salt: Callable[[Any], Any] | None = None,
) -> Element:
    """Column-spec table (label + getter or key per column), with the
    empty state built in. With ``row_key``/``row_salt`` each ``<tr>``
    becomes a :class:`~headlamp_tpu_torch.ui.fragment.FragmentBoundary`
    keyed and salted as the JAX package keys it; the rendered bytes are
    the same either way."""
    rows = list(data)
    if not rows:
        return h("p", {"class_": "hl-empty"}, empty_message)

    def cell(col: Column, row: Any) -> Any:
        getter: Callable[[Any], Any] | None = col.get("getter")
        if getter is not None:
            return getter(row)
        key = col.get("key")
        if isinstance(row, Mapping) and key is not None:
            return row.get(key, "")
        return ""

    def tr(row: Any) -> Any:
        return h("tr", None, [h("td", None, cell(c, row)) for c in columns])

    if row_key is not None and row_salt is not None:
        from .fragment import fragment

        body = [fragment(row_key(row), row_salt(row), lambda row=row: tr(row)) for row in rows]
    else:
        body = [tr(row) for row in rows]

    return h(
        "table",
        {"class_": "hl-table"},
        h("tr", None, [h("th", None, c["label"]) for c in columns]),
        body,
    )


def NameValueTable(rows: Sequence[tuple[Any, Any]]) -> Element:
    """Two-column name/value layout (detail cards)."""
    return h(
        "dl",
        {"class_": "hl-namevalue"},
        [
            (h("dt", None, name), h("dd", None, value))
            for name, value in rows
        ],
    )


#: status -> css class; mirrors Headlamp's StatusLabel palette.
_STATUS_CLASSES = {"success": "ok", "warning": "warn", "error": "err", "": "neutral"}


def StatusLabel(status: str, text: Any) -> Element:
    """Colored status chip: status in {'success','warning','error',''}."""
    cls = _STATUS_CLASSES.get(status, "neutral")
    return h("span", {"class_": f"hl-status hl-status-{cls}", "data-status": status}, text)


#: Utilization-bar thresholds shared by the kit (the reference's 70/90).
BAR_WARN_PCT = 70
BAR_CRIT_PCT = 90


def UtilizationBar(used: float, capacity: float, *, unit: str = "") -> Element:
    """Single-value meter with 70/90% warn/crit coloring."""
    pct = 0.0 if capacity <= 0 else min(100.0, used / capacity * 100)
    level = "err" if pct >= BAR_CRIT_PCT else "warn" if pct >= BAR_WARN_PCT else "ok"
    label = f"{used:g}/{capacity:g}{(' ' + unit) if unit else ''} ({pct:.0f}%)"
    return h(
        "div",
        {"class_": f"hl-utilbar hl-utilbar-{level}", "data-pct": f"{pct:.0f}"},
        h("div", {"class_": "hl-utilbar-fill", "style": f"width:{pct:.1f}%"}),
        h("span", {"class_": "hl-utilbar-label"}, label),
    )


def BudgetBar(remaining_ratio: float) -> Element:
    """Error-budget meter of the SLO page: the unspent fraction, colored
    by how little is left (err at 10% or less, warn at 30% or less), the
    inverse reading of UtilizationBar on the same thresholds."""
    pct = max(0.0, min(1.0, float(remaining_ratio))) * 100
    level = "err" if pct <= 100 - BAR_CRIT_PCT else "warn" if pct <= 100 - BAR_WARN_PCT else "ok"
    return h(
        "div",
        {"class_": f"hl-budgetbar hl-utilbar hl-utilbar-{level}", "data-pct": f"{pct:.0f}"},
        h("div", {"class_": "hl-utilbar-fill", "style": f"width:{pct:.1f}%"}),
        h("span", {"class_": "hl-utilbar-label"}, f"{pct:.1f}% budget left"),
    )


def PercentageBar(parts: Sequence[tuple[str, float]]) -> Element:
    """Stacked distribution bar: [(label, value)]. Renders each part with
    a width percentage of the parts' sum and a legend (the GPU-type
    distribution bar, `OverviewPage.tsx:275-312`)."""
    values = [(str(label), max(0.0, float(v))) for label, v in parts]
    denom = sum(v for _, v in values) or 1.0
    return h(
        "div",
        {"class_": "hl-pctbar"},
        h(
            "div",
            {"class_": "hl-pctbar-track"},
            [
                h(
                    "div",
                    {
                        "class_": "hl-pctbar-part",
                        "style": f"width:{v / denom * 100:.1f}%",
                        "title": f"{label}: {v:g}",
                    },
                )
                for label, v in values
                if v > 0
            ],
        ),
        h(
            "div",
            {"class_": "hl-pctbar-legend"},
            [h("span", None, f"{label}: {v:g}") for label, v in values],
        ),
    )


def Loader(title: str = "Loading…") -> Element:
    return h("div", {"class_": "hl-loader", "role": "progressbar"}, title)


def EmptyContent(*children: Any) -> Element:
    return h("div", {"class_": "hl-empty-content"}, *children)


def ErrorBox(message: str) -> Element:
    """The aggregated-error banner every page shows when
    ``snapshot.error`` is set (`OverviewPage.tsx:162-168`)."""
    return h("div", {"class_": "hl-error", "role": "alert"}, "Error: ", message)

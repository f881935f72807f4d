"""The HTML faces of the port's telemetry: the trace waterfall, the SLO
status page, the profiler's flame view, the generation timeline and the
incident timeline.

The port's copy of ``headlamp_tpu/obs/debug_pages.py``. Each page is a registered route
(``registration.py``) built from the ``ui/vdom.py`` components and
painted through the host's chrome, from a snapshot dict alone, never a
cluster snapshot, so it paints while the sync is what is being debugged.
The JSON twins (``/debug/traces``, ``/sloz``, ``/debug/profilez``,
``/debug/generationz``, ``/debug/incidentz``) are served by the host
directly.

Waterfall: traces slowest first, a row per span with an indented label,
a bar at the span's offset within the request, and its duration and
attributes; each trace section carries an ``id="trace-<trace_id>"``
anchor, the target of the SLO page's exemplar links. SLO page: a section
per objective with its state, burn rate per window against the page and
warn thresholds, the error-budget meter and its exemplar links, and the
self-forecast's projection. Wall-clock stamps are display only.
"""

from __future__ import annotations

import time
from typing import Any

from ..ui.components import BudgetBar, StatusLabel
from ..ui.vdom import Element, h


def _fmt_ms(ms: float) -> str:
    return f"{ms:.2f} ms" if ms < 100 else f"{ms:.0f} ms"


def _fmt_attrs(attrs: dict[str, Any]) -> str:
    return " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))


def _span_rows(
    span: dict[str, Any], trace_ms: float, depth: int
) -> list[Element]:
    """Flatten one span subtree into waterfall rows, depth-first —
    children render under their parent at one more indent level, which
    reads as the call tree without nested markup."""
    scale = max(trace_ms, 1e-6)
    left = min(span["start_ms"] / scale * 100.0, 100.0)
    width = max(min(span["duration_ms"] / scale * 100.0, 100.0 - left), 0.5)
    rows = [
        h(
            "div",
            {"class_": "hl-span-row"},
            h(
                "span",
                {
                    "class_": "hl-span-label",
                    "style": f"padding-left:{depth * 16}px",
                },
                span["name"],
            ),
            h(
                "span",
                {"class_": "hl-span-track"},
                h(
                    "span",
                    {
                        "class_": "hl-span-bar",
                        "style": f"margin-left:{left:.2f}%;width:{width:.2f}%",
                    },
                ),
            ),
            h("span", {"class_": "hl-span-ms"}, _fmt_ms(span["duration_ms"])),
            span["attrs"]
            and h("span", {"class_": "hl-span-attrs"}, _fmt_attrs(span["attrs"])),
        )
    ]
    for child in span["children"]:
        rows.extend(_span_rows(child, trace_ms, depth + 1))
    return rows


def _trace_section(trace: dict[str, Any]) -> Element:
    started = time.strftime(
        "%H:%M:%S", time.localtime(trace["started_at"])
    )  # wall clock is for DISPLAY only (ADR-013); durations are monotonic
    status = trace["status"]
    status_class = "hl-status-ok" if status < 400 else "hl-status-err"
    trace_id = trace.get("trace_id", "")
    props: dict[str, Any] = {"class_": "hl-section hl-trace"}
    if trace_id:
        # The anchor /sloz/html exemplar links (and any /metricsz
        # exemplar copy-paste) land on.
        props["id"] = f"trace-{trace_id}"
    return h(
        "section",
        props,
        h(
            "header",
            {"class_": "hl-trace-header"},
            h("span", {"class_": f"hl-status {status_class}"}, str(status)),
            h("strong", None, trace["route"]),
            h(
                "span",
                {"class_": "hl-hint"},
                f"{_fmt_ms(trace['duration_ms'])} · {trace['device_gets']} "
                f"device_get(s) · started {started}"
                + (f" · trace {trace_id}" if trace_id else ""),
            ),
        ),
        [_span_rows(s, trace["duration_ms"], 0) for s in trace["spans"]]
        or h("p", {"class_": "hl-hint"}, "No instrumented stages recorded."),
    )


def traces_page(traces: list[dict[str, Any]]) -> Element:
    """The waterfall page. ``traces`` is ``trace_ring.snapshot()`` —
    newest first; re-sorted slowest-first here because that is the
    question the page answers."""
    ordered = sorted(traces, key=lambda t: -t["duration_ms"])
    return h(
        "div",
        {"class_": "hl-traces"},
        h("h1", None, "Request Traces"),
        h(
            "p",
            {"class_": "hl-hint"},
            f"{len(ordered)} recent request(s), slowest first. "
            "Raw JSON: /debug/traces · correlate device_get counts with "
            "/metricsz transfer counters (OPERATIONS.md runbook).",
        ),
        [_trace_section(t) for t in ordered]
        if ordered
        else h(
            "div",
            {"class_": "hl-empty-content"},
            "No traces captured yet — load a page, then refresh.",
        ),
    )


#: Engine state → StatusLabel status vocabulary.
_SLO_STATE_STATUS = {"ok": "success", "warn": "warning", "page": "error"}


def _forecast_line(forecast: dict[str, Any] | None) -> Element | None:
    if forecast is None:
        return None
    windows = forecast.get("projected_exhaustion_windows")
    if windows is not None:
        text = (
            f"Self-forecast ({forecast['slo']}): projected error-budget "
            f"exhaustion in {windows} × {forecast.get('window', '1h')} "
            f"window(s) at burn {forecast.get('projected_burn_rate', 0)}."
        )
    else:
        text = (
            f"Self-forecast ({forecast['slo']}): no projection "
            f"({forecast.get('reason', 'unknown')}; "
            f"{forecast.get('points', 0)} latency sample(s))."
        )
    return h("p", {"class_": "hl-hint hl-slo-forecast"}, text)


def _exemplar_links(exemplars: list[dict[str, Any]]) -> Element | None:
    if not exemplars:
        return None
    return h(
        "p",
        {"class_": "hl-slo-exemplars hl-hint"},
        "Exemplar traces: ",
        [
            h(
                "a",
                {
                    "class_": "hl-slo-exemplar",
                    "href": f"/debug/traces/html#trace-{e['trace_id']}",
                },
                f"{e['trace_id'][:8]} ({e['value'] * 1000:.0f} ms)",
            )
            for e in exemplars
            if e.get("trace_id")
        ],
    )


def _slo_section(slo: dict[str, Any], page_burn: float, warn_burn: float) -> Element:
    state = slo["state"]
    burn_rows = []
    for window, rate in slo["burn_rates"].items():
        events = slo["events"][window]
        level = "err" if rate >= page_burn else "warn" if rate >= warn_burn else "ok"
        burn_rows.append(
            h(
                "div",
                {"class_": f"hl-slo-burn hl-slo-burn-{level}", "data-window": window},
                h("span", {"class_": "hl-slo-burn-window"}, window),
                h("span", {"class_": "hl-slo-burn-rate"}, f"{rate:g}×"),
                h(
                    "span",
                    {"class_": "hl-hint"},
                    f"{events['good']} good / {events['bad']} bad",
                ),
            )
        )
    return h(
        "section",
        {"class_": "hl-section hl-slo", "data-slo": slo["name"], "data-state": state},
        h(
            "header",
            {"class_": "hl-slo-header"},
            StatusLabel(_SLO_STATE_STATUS.get(state, ""), state),
            h("strong", None, slo["name"]),
            h(
                "span",
                {"class_": "hl-hint"},
                f"{slo['description']} · target {slo['target'] * 100:g}% "
                f"within {slo['threshold_s'] * 1000:g} ms",
            ),
        ),
        h("div", {"class_": "hl-slo-burns"}, burn_rows),
        BudgetBar(slo["budget_remaining_ratio"]),
        _exemplar_links(slo.get("exemplars", [])),
    )


def _flame_rows(
    node: dict[str, Any], scale: float, offset: float, depth: int
) -> list[Element]:
    """Flatten one call-tree subtree into flame rows, depth-first: the
    bar spans the node's share of its root's samples, positioned at the
    cumulative offset of its elder siblings — the classic flamegraph
    geometry, one row per tree position (same row kit as the trace
    waterfall so style.py themes both)."""
    left = min(offset / scale * 100.0, 100.0)
    width = max(min(node["total"] / scale * 100.0, 100.0 - left), 0.5)
    rows = [
        h(
            "div",
            {"class_": "hl-span-row hl-flame-row"},
            h(
                "span",
                {
                    "class_": "hl-span-label",
                    "style": f"padding-left:{depth * 16}px",
                },
                node["name"],
            ),
            h(
                "span",
                {"class_": "hl-span-track"},
                h(
                    "span",
                    {
                        "class_": "hl-span-bar",
                        "style": f"margin-left:{left:.2f}%;width:{width:.2f}%",
                    },
                ),
            ),
            h(
                "span",
                {"class_": "hl-span-ms"},
                f"{node['total']} ({node['self']} self)",
            ),
        )
    ]
    child_offset = offset
    for child in node["children"]:
        rows.extend(_flame_rows(child, scale, child_offset, depth + 1))
        child_offset += child["total"]
    return rows


def _route_flame_section(root: dict[str, Any]) -> Element:
    """One section per attribution root (the route segment the sampled
    thread published, or ``(untracked)``)."""
    scale = max(float(root["total"]), 1.0)
    return h(
        "section",
        {"class_": "hl-section hl-flame", "data-route": root["name"]},
        h(
            "header",
            {"class_": "hl-trace-header"},
            h("strong", None, root["name"]),
            h(
                "span",
                {"class_": "hl-hint"},
                f"{root['total']} sampled stack(s)",
            ),
        ),
        [
            row
            for child in root["children"]
            for row in _flame_rows(child, scale, 0.0, 0)
        ]
        or h("p", {"class_": "hl-hint"}, "No frames recorded yet."),
    )


def profile_page(snapshot: dict[str, Any]) -> Element:
    """The flame view over ``SamplingProfiler.snapshot()`` (ADR-019).
    Routes sort by sampled weight — the page exists to answer "where is
    Python time going", so the heaviest attribution root leads.

    Reading caveat (OPERATIONS.md runbook): a sampler sees *time*, not
    calls, and charges device/C waits to the Python frame blocking on
    them — the graph cost ledger in /healthz (runtime.graphs) tells
    which device program ran."""
    tree = snapshot.get("tree", {})
    roots = sorted(
        tree.get("children", []), key=lambda n: -n["total"]
    )
    overhead = snapshot.get("overhead_ns_per_sample")
    status = (
        f"{snapshot.get('samples', 0)} sample(s) · "
        f"{snapshot.get('stacks', 0)} stack(s) · "
        f"{snapshot.get('nodes', 0)}/{snapshot.get('max_nodes', 0)} node(s)"
        + (
            f" · {snapshot.get('collapsed_stacks', 0)} collapsed"
            if snapshot.get("collapsed_stacks")
            else ""
        )
        + (f" · {overhead:.0f} ns/sample" if overhead is not None else "")
        + (" · BURSTING" if snapshot.get("bursting") else "")
    )
    return h(
        "div",
        {"class_": "hl-flames"},
        h("h1", None, "Continuous Profile"),
        h(
            "p",
            {"class_": "hl-hint"},
            status + ". Raw JSON: /debug/profilez · folded stacks: "
            "/debug/profilez/folded · burst: /debug/profilez?burst=30 · "
            "samples measure wall time, not call counts (OPERATIONS.md "
            "runbook).",
        ),
        [_route_flame_section(r) for r in roots]
        if roots
        else h(
            "div",
            {"class_": "hl-empty-content"},
            "No samples captured yet — the sampler starts with serve(), "
            "or POST a burst via /debug/profilez?burst=30.",
        ),
    )


def slo_page(report: dict[str, Any]) -> Element:
    """The SLO status page. ``report`` is ``SLOEngine.report()`` —
    burning objectives sort first because they are why the page was
    opened."""
    state_rank = {"page": 0, "warn": 1, "ok": 2}
    ordered = sorted(
        report.get("slos", []), key=lambda s: state_rank.get(s["state"], 3)
    )
    page_burn = report.get("page_burn_threshold", 0.0)
    warn_burn = report.get("warn_burn_threshold", 0.0)
    return h(
        "div",
        {"class_": "hl-slos"},
        h("h1", None, "Service Level Objectives"),
        h(
            "p",
            {"class_": "hl-hint"},
            f"{len(ordered)} objective(s); page ≥ {page_burn:g}× on the fast "
            f"windows, warn ≥ {warn_burn:g}× on the slow ones. Raw JSON: "
            "/sloz · pinned bad requests: /debug/flightz (OPERATIONS.md "
            "runbook).",
        ),
        _forecast_line(report.get("budget_forecast")),
        [_slo_section(s, page_burn, warn_burn) for s in ordered]
        if ordered
        else h("div", {"class_": "hl-empty-content"}, "No SLOs declared."),
    )


def _generation_section(entry: dict[str, Any], threshold_s: float) -> Element:
    """One generation's lifecycle as a waterfall: stage bars positioned
    by their wall stamps relative to the generation's first stamp
    (display only — the LAG numbers alongside each bar came from the
    injected monotonic, ADR-013), trace ids linking each stage to its
    request waterfall."""
    stages = entry.get("stages", {})
    walls = [s["wall"] for s in stages.values()]
    first_wall = min(walls) if walls else 0.0
    total_ms = max((max(walls) - first_wall) * 1000.0, 1e-6) if walls else 1.0
    trace_ids = entry.get("trace_ids", {})
    rows: list[Element] = []
    for stage, stamp in stages.items():
        left = min((stamp["wall"] - first_wall) * 1000.0 / total_ms * 100.0, 100.0)
        width = 0.5
        if stamp.get("lag_ms"):
            width = max(min(stamp["lag_ms"] / total_ms * 100.0, left), 0.5)
        trace_id = trace_ids.get(stage)
        rows.append(
            h(
                "div",
                {"class_": "hl-span-row"},
                h("span", {"class_": "hl-span-label"}, stage),
                h(
                    "span",
                    {"class_": "hl-span-track"},
                    h(
                        "span",
                        {
                            "class_": "hl-span-bar",
                            "style": (
                                f"margin-left:{max(left - width, 0.0):.2f}%;"
                                f"width:{width:.2f}%"
                            ),
                        },
                    ),
                ),
                h(
                    "span",
                    {"class_": "hl-span-ms"},
                    _fmt_ms(stamp["lag_ms"]) if stamp.get("lag_ms") is not None else "—",
                ),
                trace_id
                and h(
                    "a",
                    {
                        "class_": "hl-span-attrs",
                        "href": f"/debug/traces/html#trace-{trace_id}",
                    },
                    f"trace {trace_id}",
                ),
            )
        )
    age_ms = entry.get("age_at_paint_ms")
    breached = bool(entry.get("breached"))
    status_class = "hl-status-err" if breached else "hl-status-ok"
    badge = "STALE" if breached else entry.get("role", "?")
    origin = entry.get("origin") or {}
    origin_trace = origin.get("trace_id")
    hint = (
        f"age at first paint {_fmt_ms(age_ms)} (threshold "
        f"{threshold_s * 1000:.0f} ms)"
        if age_ms is not None
        else "not painted yet"
    )
    if origin_trace:
        hint += f" · origin trace {origin_trace}"
    return h(
        "section",
        {"class_": "hl-section hl-trace"},
        h(
            "header",
            {"class_": "hl-trace-header"},
            h("span", {"class_": f"hl-status {status_class}"}, badge),
            h("strong", None, f"generation {entry['generation']}"),
            h("span", {"class_": "hl-hint"}, hint),
        ),
        rows
        or h("p", {"class_": "hl-hint"}, "No lifecycle stages recorded."),
    )


def _transition_line(transition: dict[str, Any]) -> Element:
    stamp = time.strftime(
        "%H:%M:%S", time.localtime(transition.get("wall", 0.0))
    )  # display only (ADR-013)
    return h(
        "p",
        {"class_": "hl-hint"},
        f"{stamp} · {transition.get('kind', '?')} "
        f"(fencing {transition.get('fencing', 0)})",
    )


def generations_page(snapshot: dict[str, Any]) -> Element:
    """The generation-provenance timeline (ADR-028). ``snapshot`` is
    ``GenerationLedger.snapshot()`` — freshness-SLO breaches pinned
    first (they are why the page was opened), then recent generations
    newest-first, leadership transitions at the bottom where a
    failover explains a lag cliff."""
    pinned = snapshot.get("pinned", [])
    recent = snapshot.get("generations", [])
    threshold_s = float(snapshot.get("freshness_threshold_s", 0.0))
    transitions = snapshot.get("transitions", [])
    return h(
        "div",
        {"class_": "hl-traces hl-generations"},
        h("h1", None, "Generation Provenance"),
        h(
            "p",
            {"class_": "hl-hint"},
            f"role {snapshot.get('role', '?')} · {len(recent)} recent "
            f"generation(s) · {snapshot.get('breaches', 0)} freshness "
            f"breach(es), threshold {threshold_s:g} s. Raw JSON: "
            "/debug/generationz · stage lags: "
            "headlamp_tpu_torch_generation_stage_seconds on /metricsz "
            "(OPERATIONS.md runbook).",
        ),
        pinned
        and [
            h("h2", None, "Pinned freshness breaches"),
            [_generation_section(e, threshold_s) for e in pinned],
        ],
        [_generation_section(e, threshold_s) for e in recent]
        if recent
        else h(
            "div",
            {"class_": "hl-empty-content"},
            "No generations recorded yet — sync once, then refresh.",
        ),
        transitions
        and [
            h("h2", None, "Leadership transitions"),
            [_transition_line(t) for t in reversed(transitions)],
        ],
    )


_INCIDENT_SOURCE_CLASS = {
    "scenario": "hl-status-warn",
    "slo": "hl-status-err",
    "gateway": "hl-status-err",
    "push": "hl-status-warn",
    "elector": "hl-status-ok",
}


def _incident_row(event: dict[str, Any], first_wall: float, span_s: float) -> Element:
    """One timeline event as a waterfall row: label source/kind, a bar at
    the event's wall offset within the drill (display only: the order
    came from the timeline's sequence), its detail summarized beside."""
    wall = event.get("wall") or first_wall
    left = min(max((wall - first_wall) / span_s * 100.0, 0.0), 99.5)
    stamp = time.strftime("%H:%M:%S", time.localtime(wall))  # display only
    detail = event.get("detail") or {}
    summary = " ".join(f"{k}={detail[k]}" for k in sorted(detail))[:120]
    status_class = _INCIDENT_SOURCE_CLASS.get(event.get("source", ""), "hl-status-ok")
    return h(
        "div",
        {"class_": "hl-span-row"},
        h(
            "span",
            {"class_": f"hl-status {status_class}"},
            event.get("source", "?"),
        ),
        h("span", {"class_": "hl-span-label"}, event.get("kind", "?")),
        h(
            "span",
            {"class_": "hl-span-track"},
            h(
                "span",
                {
                    "class_": "hl-span-bar",
                    "style": f"margin-left:{left:.2f}%;width:0.50%",
                },
            ),
        ),
        h("span", {"class_": "hl-span-ms"}, stamp),
        summary and h("span", {"class_": "hl-span-attrs"}, summary),
    )


def incidents_page(snapshot: dict[str, Any]) -> Element:
    """The incident timeline. ``snapshot`` is ``IncidentTimeline.snapshot()``:
    scenario injections, SLO state flips, gateway rulings, hub evictions
    and leadership transitions as one ordered waterfall. It paints from
    the timeline alone, never a cluster snapshot: mid-incident is when it
    must paint."""
    events = snapshot.get("events", [])
    active = snapshot.get("active")
    walls = [e["wall"] for e in events if e.get("wall") is not None]
    first_wall = min(walls) if walls else 0.0
    span_s = max((max(walls) - first_wall), 1e-6) if walls else 1.0
    hint = (
        f"{snapshot.get('events_total', 0)} event(s) recorded · "
        f"{snapshot.get('drills_total', 0)} drill(s) · ring capacity "
        f"{snapshot.get('capacity', 0)}. Raw JSON: /debug/incidentz · "
        "triage path: incidentz → /sloz/html (which objective burned) → "
        "/debug/flightz (which requests paid) — OPERATIONS.md runbook."
    )
    return h(
        "div",
        {"class_": "hl-traces hl-incidents"},
        h("h1", None, "Incident Timeline"),
        h("p", {"class_": "hl-hint"}, hint),
        active
        and h(
            "section",
            {"class_": "hl-section"},
            h(
                "header",
                {"class_": "hl-trace-header"},
                h("span", {"class_": "hl-status hl-status-warn"}, "DRILL ACTIVE"),
                h("strong", None, str(active.get("active", "?"))),
                h(
                    "span",
                    {"class_": "hl-hint"},
                    f"phase {active.get('phase') or '—'} · "
                    f"{active.get('injections', 0)} injection(s) — faults "
                    "on this host are currently REHEARSED",
                ),
            ),
        ),
        h(
            "section",
            {"class_": "hl-section hl-trace"},
            [_incident_row(e, first_wall, span_s) for e in events]
            if events
            else h(
                "div",
                {"class_": "hl-empty-content"},
                "No incident events recorded — run a drill "
                "(bench.py --scenario NAME) or wait for real trouble.",
            ),
        ),
    )

"""TopologyPage — ICI pod-slice mesh view.

The genuinely new page (SURVEY.md §7 step 5; no reference analogue —
Intel GPUs have no inter-device fabric to draw). Per slice: identity,
health, worker table, and a rendered chip mesh — cells positioned by the
pure geometry in ``topology.mesh``, colored per worker (host), with ICI
links summarized per axis (drawing thousands of individual link lines
at 1024-node scale would swamp the DOM; counts + wrap flags carry the
same information).

With a metrics snapshot available (progressive enhancement — the host
passes its TTL-cached snapshot and NEVER fetches for this page), cells
also carry a live utilization heat band: the topology × telemetry join
no other surface shows — which chips of which slice are hot, in place
on the fabric.
"""

from __future__ import annotations

from typing import Any, Mapping

from ..context.accelerator_context import ClusterSnapshot
from ..metrics.format import format_percent, normalize_fraction
from ..topology.mesh import MeshLayout, build_mesh_layout
from ..topology.slices import SliceInfo, group_slices, summarize_slices
from ..ui import (
    EmptyContent,
    Loader,
    NameValueTable,
    SectionBox,
    SimpleTable,
    StatusLabel,
    h,
)
from ..ui.vdom import Element
from .common import error_banner, ready_label

#: Cell size in px for the HTML mesh rendering.
_CELL = 28
_GAP = 6

_HEALTH_TEXT = {
    "success": "Healthy",
    "warning": "Degraded",
    "error": "Incomplete",
}


def _chip_utilization(
    by_node: Mapping[str, list[Any]] | None, sl: SliceInfo
) -> dict[tuple[int, int], float]:
    """(worker_id, local chip ordinal) -> utilization fraction, joined
    from the snapshot's per-node rows (``by_node`` computed ONCE per
    page — it rebuilds a fleet-wide dict). The ordinal is the chip's
    numeric accelerator_id when parseable — an exporter that drops idle
    chips' samples must not shift the remaining heat onto the wrong
    cells — falling back to list position for non-numeric ids.
    TensorCore utilization preferred, duty cycle as the fallback
    series."""
    if not by_node:
        return {}
    out: dict[tuple[int, int], float] = {}
    for w in sl.workers:
        rows = by_node.get(w.node_name)
        if not rows:
            continue
        for position, row in enumerate(rows):
            util = row.tensorcore_utilization
            if util is None:
                util = row.duty_cycle
            if util is None:
                continue
            chip_id = str(row.accelerator_id)
            ordinal = int(chip_id) if chip_id.isdigit() else position
            out[(w.worker_id, ordinal)] = util
    return out


def _heat_band(util: float) -> int:
    """0-4 heat band from a utilization fraction: <25, <50, <70, <90,
    ≥90 — the top band matching the UI kit's critical threshold.
    ``normalize_fraction`` is the ONE scale authority (shared with
    format_percent), so the band and the title percent can never
    disagree on the same sample."""
    fraction = normalize_fraction(util) or 0.0
    pct = fraction * 100
    for band, ceiling in enumerate((25, 50, 70, 90)):
        if pct < ceiling:
            return band
    return 4


def mesh_grid(
    layout: MeshLayout, sl: SliceInfo, by_node: Mapping[str, list[Any]] | None = None
) -> Element:
    """Absolute-positioned chip cells; one color class per worker
    (worker_id % 8). Unready/missing workers render hatched. With
    telemetry rows (``by_node``), cells gain a heat band + utilization
    in the title."""
    ready_by_worker = {w.worker_id: w.ready for w in sl.workers}
    utilization = _chip_utilization(by_node, sl)
    worker_ordinal: dict[int, int] = {}
    cells = []
    for cell in layout.cells:
        ready = ready_by_worker.get(cell.worker_id)
        state = "ok" if ready else ("missing" if ready is None else "down")
        # Cells arrive in chip_index order, so per-worker arrival order
        # IS the local chip ordinal the metrics join keys on.
        ordinal = worker_ordinal.get(cell.worker_id, 0)
        worker_ordinal[cell.worker_id] = ordinal + 1
        util = utilization.get((cell.worker_id, ordinal))
        heat = f" hl-heat-{_heat_band(util)}" if util is not None else ""
        # Same formatter as the metrics page (clamp + pre-scaled
        # normalization) so the two surfaces can never disagree on the
        # same sample.
        util_text = (
            f" util {format_percent(util, digits=0)}" if util is not None else ""
        )
        cells.append(
            h(
                "div",
                {
                    "class_": (
                        f"hl-mesh-cell hl-worker-{cell.worker_id % 8} "
                        f"hl-mesh-{state}{heat}"
                    ),
                    "style": (
                        f"left:{cell.px * (_CELL + _GAP)}px;"
                        f"top:{cell.py * (_CELL + _GAP)}px;"
                        f"width:{_CELL}px;height:{_CELL}px"
                    ),
                    "title": (
                        f"chip {cell.chip_index} coord {cell.coord} "
                        f"worker {cell.worker_id}{util_text}"
                    ),
                    "data-worker": cell.worker_id,
                },
            )
        )
    width = layout.width * (_CELL + _GAP)
    height = layout.height * (_CELL + _GAP)
    axis_counts: dict[int, int] = {}
    wrap_axes: set[int] = set()
    for link in layout.links:
        axis_counts[link.axis] = axis_counts.get(link.axis, 0) + 1
        if link.wrap:
            wrap_axes.add(link.axis)
    link_summary = ", ".join(
        f"axis {axis}: {count} links" + (" (torus)" if axis in wrap_axes else "")
        for axis, count in sorted(axis_counts.items())
    )
    return h(
        "div",
        {"class_": "hl-mesh"},
        h(
            "div",
            {
                "class_": "hl-mesh-grid",
                "style": f"position:relative;width:{width}px;height:{height}px",
            },
            cells,
        ),
        h("p", {"class_": "hl-mesh-links"}, f"ICI: {link_summary}" if link_summary else
          "ICI topology unknown"),
    )


def slice_card(
    sl: SliceInfo, by_node: Mapping[str, list[Any]] | None = None
) -> Element:
    layout = build_mesh_layout(sl)
    worker_table = SimpleTable(
        [
            {"label": "Worker", "getter": lambda w: w.worker_id},
            {"label": "Node", "getter": lambda w: w.node_name},
            {"label": "Ready", "getter": lambda w: ready_label(w.ready)},
            {"label": "Chips", "getter": lambda w: w.chip_capacity},
        ],
        sl.workers,
    )
    missing = sl.missing_worker_ids
    return SectionBox(
        f"Slice: {sl.slice_id}",
        NameValueTable(
            [
                ("Health", StatusLabel(sl.health, _HEALTH_TEXT[sl.health])),
                ("Generation", sl.generation),
                ("Topology", sl.topology or "unknown"),
                ("Chips", sl.total_chips),
                ("Hosts", f"{sl.actual_hosts}/{sl.expected_hosts}"),
                ("Multi-host", "yes" if sl.is_multi_host else "no"),
                *(
                    [("Missing workers", ", ".join(map(str, missing)))]
                    if missing
                    else []
                ),
            ]
        ),
        mesh_grid(layout, sl, by_node),
        worker_table,
        class_="hl-slice-card",
    )


def topology_page(
    snap: ClusterSnapshot,
    *,
    provider_name: str = "tpu",
    max_slices: int = 64,
    metrics: Any = None,
) -> Element:
    """Fleet slice summary + per-slice cards. ``max_slices`` caps the
    card list the same way the overview caps its pod table — at the
    1024-node fixture there are hundreds of slices; unhealthy ones sort
    first so the cap never hides a problem. ``metrics`` (a TTL-cached
    TpuMetricsSnapshot, or None) turns the meshes into utilization
    heatmaps — hosts must pass a cache PEEK, never fetch for this."""
    if snap.loading:
        return h("div", {"class_": "hl-page hl-topology"}, Loader())

    state = snap.provider(provider_name)
    slices = group_slices(state.nodes)

    if not slices:
        return h(
            "div",
            {"class_": "hl-page hl-topology"},
            error_banner(snap),
            EmptyContent(
                h("h3", None, "No TPU slices found"),
                h("p", None, "No TPU nodes to derive slice topology from."),
            ),
        )

    ssum = summarize_slices(slices)
    summary = SectionBox(
        "Slice Summary",
        NameValueTable(
            [
                ("Slices", ssum["total"]),
                ("Healthy", ssum["healthy"]),
                ("Degraded", ssum["degraded"]),
                ("Incomplete", ssum["incomplete"]),
                ("Multi-host", ssum["multi_host"]),
                ("Total chips", ssum["total_chips"]),
            ]
        ),
        h(
            "p",
            {"class_": "hl-hint"},
            "Each slice is one ICI domain — chips inside it talk over the "
            "high-bandwidth interconnect drawn below; traffic BETWEEN "
            "slices rides the datacenter network (DCN). Schedule "
            "collective-heavy workloads within a slice.",
        ),
    )

    health_rank = {"error": 0, "warning": 1, "success": 2}
    ordered = sorted(slices, key=lambda s: (health_rank[s.health], s.slice_id))
    shown = ordered[:max_slices]
    truncation = None
    if len(ordered) > max_slices:
        truncation = h(
            "p",
            {"class_": "hl-hint"},
            f"Showing {max_slices} of {len(ordered)} slices "
            "(unhealthy first).",
        )

    # The fleet-wide per-node row index is built ONCE per page (the
    # by_node property rebuilds a dict over every chip row).
    by_node = metrics.by_node if metrics is not None else None
    heat_hint = None
    if by_node:
        heat_hint = h(
            "p",
            {"class_": "hl-hint"},
            "Mesh cells are tinted by live chip utilization "
            "(<25 / <50 / <70 / <90 / ≥90%), joined from the cached "
            "telemetry snapshot.",
        )

    return h(
        "div",
        {"class_": "hl-page hl-topology"},
        error_banner(snap),
        summary,
        heat_hint,
        truncation,
        [slice_card(s, by_node) for s in shown],
    )

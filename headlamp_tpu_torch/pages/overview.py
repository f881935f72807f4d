"""OverviewPage — the fleet dashboard.

Section-for-section rebuild of the reference's overview
(`src/components/OverviewPage.tsx`): plugin status,
daemon pods, node summary with generation distribution, allocation
summary with utilization bar, workload phases, and a capped
active-workloads table — plus a TPU-only section the Intel plugin has no
analogue for: pod-slice health (multi-host slices are the TPU fleet's
real scheduling unit).
"""

from __future__ import annotations

from typing import Any

from ..context.accelerator_context import ClusterSnapshot
from ..domain import objects as obj
from ..domain import tpu
from ..topology.slices import group_slices, summarize_slices
from ..ui import (
    Loader,
    NameValueTable,
    PercentageBar,
    SectionBox,
    SimpleTable,
    StatusLabel,
    UtilizationBar,
    fragment,
    h,
)
from ..ui.vdom import Element
from .common import (
    age_cell,
    error_banner,
    phase_label,
    plugin_not_detected_box,
)
from .native import pod_link

#: Running-pods table cap (`OverviewPage.tsx:414` caps at 10).
ACTIVE_PODS_CAP = 10


def overview_page(
    snap: ClusterSnapshot, *, now: float, provider_name: str = "tpu"
) -> Element:
    if snap.loading:
        return h("div", {"class_": "hl-page hl-overview"}, Loader())

    state = snap.provider(provider_name)
    children: list[Any] = [error_banner(snap)]

    if not state.plugin_installed:
        children.append(plugin_not_detected_box(state))

    if not state.workload_available:
        # The CRD/DaemonSet-source-missing notice (ADR-003 analogue,
        # `OverviewPage.tsx:199-219`): visibility is reduced, not broken.
        children.append(
            h(
                "div",
                {"class_": "hl-notice hl-workload-missing"},
                h("h3", None, "Device-plugin workload status not available"),
                h(
                    "p",
                    None,
                    "The DaemonSet/CRD source could not be read; node and pod "
                    "visibility remains available.",
                ),
            )
        )

    # Device-plugin workload status (`OverviewPage.tsx:222-249`).
    if state.workloads:
        children.append(
            SectionBox(
                "Device Plugin",
                SimpleTable(
                    [
                        {"label": "Name", "getter": obj.name},
                        {
                            "label": "Status",
                            "getter": lambda ds: StatusLabel(
                                tpu.daemonset_status_to_status(ds),
                                tpu.daemonset_status_text(ds),
                            ),
                        },
                        {"label": "Age", "getter": lambda ds: age_cell(ds, now)},
                    ],
                    state.workloads,
                ),
            )
        )

    # Daemon pods (`OverviewPage.tsx:252-272`).
    if state.plugin_pods:
        children.append(
            SectionBox(
                "Plugin Pods",
                SimpleTable(
                    [
                        {"label": "Pod", "getter": pod_link},
                        {"label": "Node", "getter": lambda p: obj.pod_node_name(p) or "—"},
                        {"label": "Phase", "getter": phase_label},
                        {"label": "Restarts", "getter": obj.pod_restarts},
                    ],
                    state.plugin_pods,
                ),
            )
        )

    # Every aggregate below comes from one fleet_stats() call — the XLA
    # fused rollup on jax hosts, pure-Python fallback elsewhere
    # (analytics/stats.py; ADR-006).
    stats = state.fleet_stats()

    # Node summary + generation distribution (`OverviewPage.tsx:275-312`).
    # A cell-group boundary (ADR-027): keyed on the differ's
    # ``cell:tpu.nodes`` vocabulary, salted with every rollup value the
    # section paints, so a stable fleet splices it from cached bytes.
    gen_counts = {
        tpu.format_generation(g): c for g, c in stats["generation_counts"].items()
    }

    def nodes_section() -> Element:
        return SectionBox(
            "TPU Nodes",
            NameValueTable(
                [
                    ("Total", stats["nodes_total"]),
                    ("Ready", stats["nodes_ready"]),
                    ("Not Ready", stats["nodes_total"] - stats["nodes_ready"]),
                ]
            ),
            PercentageBar(sorted(gen_counts.items())) if gen_counts else None,
        )

    children.append(
        fragment(
            "cell:tpu.nodes",
            (stats["nodes_total"], stats["nodes_ready"], tuple(sorted(gen_counts.items()))),
            nodes_section,
        )
    )

    # Allocation summary (`OverviewPage.tsx:316-357`) plus the fleet
    # pressure signals the rollup computes (hot = node util ≥ 90%).
    def allocation_section() -> Element:
        return SectionBox(
            "Chip Allocation",
            NameValueTable(
                [
                    ("Capacity", tpu.format_chip_count(stats["capacity"])),
                    ("Allocatable", tpu.format_chip_count(stats["allocatable"])),
                    ("In use", tpu.format_chip_count(stats["in_use"])),
                    ("Free", tpu.format_chip_count(stats["free"])),
                    ("Hot nodes (≥90%)", stats["hot_nodes"]),
                    (
                        "Max node utilization",
                        f"{stats['max_node_util_pct']:.0f}%",
                    ),
                ]
            ),
            UtilizationBar(stats["in_use"], stats["capacity"], unit="chips"),
        )

    children.append(
        fragment(
            "cell:tpu.in_use",
            (
                stats["capacity"],
                stats["allocatable"],
                stats["in_use"],
                stats["free"],
                stats["hot_nodes"],
                stats["max_node_util_pct"],
            ),
            allocation_section,
        )
    )

    # Slice health — TPU-first addition (SURVEY.md §2.3: the slice, not
    # the node, is the schedulable unit of a multi-host TPU fleet).
    slices = group_slices(state.nodes)
    if slices:
        ssum = summarize_slices(slices)
        children.append(
            fragment(
                "slices",
                (
                    ssum["total"],
                    ssum["healthy"],
                    ssum["degraded"],
                    ssum["incomplete"],
                    ssum["multi_host"],
                ),
                lambda: SectionBox(
                    "Pod Slices",
                    NameValueTable(
                        [
                            ("Slices", ssum["total"]),
                            ("Healthy", ssum["healthy"]),
                            ("Degraded", ssum["degraded"]),
                            ("Incomplete", ssum["incomplete"]),
                            ("Multi-host", ssum["multi_host"]),
                        ]
                    ),
                ),
            )
        )

    # Workload phases (`OverviewPage.tsx:360-390`).
    phases = stats["phase_counts"]
    children.append(
        fragment(
            "cell:tpu.pods",
            tuple(phases.items()),
            lambda: SectionBox(
                "TPU Workloads",
                NameValueTable([(k, v) for k, v in phases.items() if v or k != "Other"]),
            ),
        )
    )

    # Active pods, capped (`OverviewPage.tsx:393-417`).
    running = [p for p in state.pods if obj.pod_phase(p) == "Running"]
    running.sort(key=lambda p: obj.creation_timestamp(p) or "", reverse=True)
    children.append(
        SectionBox(
            f"Active TPU Pods (top {ACTIVE_PODS_CAP})",
            SimpleTable(
                [
                    {"label": "Pod", "getter": pod_link},
                    {"label": "Node", "getter": lambda p: obj.pod_node_name(p) or "—"},
                    {
                        "label": "Chips",
                        "getter": lambda p: tpu.format_chip_count(
                            tpu.get_pod_chip_request(p)
                        ),
                    },
                    {"label": "Age", "getter": lambda p: age_cell(p, now)},
                ],
                running[:ACTIVE_PODS_CAP],
                empty_message="No running TPU pods",
                # Bare ``ns/name`` keys — the differ's pod vocabulary —
                # so a pod change evicts this row via the cache's
                # key→pages index even though it lives under ``/tpu``.
                row_key=lambda p: f"{obj.namespace(p)}/{obj.name(p)}",
                row_salt=lambda p: (
                    obj.namespace(p),
                    obj.name(p),
                    obj.pod_node_name(p),
                    tpu.get_pod_chip_request(p),
                    age_cell(p, now),
                ),
            ),
        )
    )

    return h("div", {"class_": "hl-page hl-overview"}, children)

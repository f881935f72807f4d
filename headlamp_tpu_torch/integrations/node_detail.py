"""Node detail-page injection.

The port's copy of ``headlamp_tpu/integrations/node_detail.py``
(`NodeDetailSection.tsx`): renders inside the native Node page, so it
takes the single node being viewed plus the shared snapshot for
pods-on-node context. Returns None (renders nothing) for non-TPU nodes
(`:44,64-66`) — the injection must be invisible on a CPU node's page.
"""

from __future__ import annotations

from typing import Any

from ..context.accelerator_context import ClusterSnapshot
from ..domain import objects as obj
from ..domain import tpu
from ..topology.slices import group_slices
from ..ui import NameValueTable, SectionBox, StatusLabel, UtilizationBar, h
from ..ui.vdom import Element
from .common import unwrap_json_data


def node_detail_section(node: Any, snap: ClusterSnapshot | None = None) -> Element | None:
    node = unwrap_json_data(node)
    if not tpu.is_tpu_node(node):
        return None
    capacity = tpu.get_node_chip_capacity(node)
    allocatable = tpu.get_node_chip_allocatable(node)
    if capacity == 0 and allocatable == 0:
        # Labeled but no TPU resource registered (`:64-66` shows nothing
        # when no capacity/allocatable keys exist).
        return None

    node_name = obj.name(node)
    rows: list[tuple[str, Any]] = [
        ("Generation", tpu.format_accelerator(tpu.get_node_accelerator(node))),
        ("Topology", tpu.get_node_topology(node) or "—"),
        ("Chips (capacity)", capacity),
        ("Chips (allocatable)", allocatable),
    ]

    if snap is not None and not snap.loading:
        state = snap.provider("tpu")
        node_pods = [p for p in state.pods if obj.pod_node_name(p) == node_name]
        in_use = sum(
            tpu.get_pod_chip_request(p) for p in node_pods if obj.pod_phase(p) == "Running"
        )
        rows.append(("Chips in use", UtilizationBar(in_use, allocatable, unit="chips")))
        # Slice membership — which slice this host belongs to and its
        # worker index.
        for sl in group_slices(state.nodes):
            for w in sl.workers:
                if w.node_name == node_name:
                    rows.append(("Slice", sl.slice_id))
                    rows.append(("Worker index", w.worker_id))
                    rows.append(("Slice health", StatusLabel(sl.health, sl.health)))
                    break
        pod_list = h(
            "ul",
            {"class_": "hl-node-pods"},
            [
                h(
                    "li",
                    None,
                    f"{obj.namespace(p)}/{obj.name(p)} "
                    f"({tpu.format_chip_count(tpu.get_pod_chip_request(p))})",
                )
                for p in node_pods
            ]
            or [h("li", None, "No TPU pods on this node")],
        )
    else:
        # Context not hydrated: node-local facts with a loading hint for
        # the rest (`:125-133`'s 'Loading…' state).
        pod_list = h("p", {"class_": "hl-loading-inline"}, "Loading…")

    return SectionBox("TPU", NameValueTable(rows), pod_list, class_="hl-node-detail")

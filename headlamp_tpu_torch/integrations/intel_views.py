"""Intel GPU native-view integrations — the reference's own injections
(`src/components/NodeDetailSection.tsx`, `PodDetailSection.tsx`,
`integrations/NodeColumns.tsx`), hosted beside the TPU ones: the port's
copy of ``headlamp_tpu/integrations/intel_views.py``. Same null-render
contracts; a host registers both providers' sections and each guards
itself.
"""

from __future__ import annotations

from typing import Any

from ..context.accelerator_context import ClusterSnapshot
from ..domain import intel
from ..domain import objects as obj
from ..pages.common import phase_label
from ..ui import NameValueTable, SectionBox, UtilizationBar, h
from ..ui.vdom import Element
from .common import unwrap_json_data


def intel_node_detail_section(
    node: Any, snap: ClusterSnapshot | None = None
) -> Element | None:
    """(`NodeDetailSection.tsx`: non-GPU null `:44`, no-capacity null
    `:64-66`, utilization `:69-123`, pods list `:125-133`.)"""
    node = unwrap_json_data(node)
    if not intel.is_intel_gpu_node(node):
        return None
    capacity = intel.get_node_gpu_count(node)
    allocatable = intel.get_node_gpu_allocatable(node)
    if capacity == 0 and allocatable == 0:
        return None

    node_name = obj.name(node)
    rows: list[tuple[str, Any]] = [
        ("Type", intel.format_gpu_type(intel.get_node_gpu_type(node))),
        ("Devices (capacity)", capacity),
        ("Devices (allocatable)", allocatable),
    ]
    pod_list: Any
    if snap is not None and not snap.loading:
        state = snap.provider("intel")
        node_pods = [p for p in state.pods if obj.pod_node_name(p) == node_name]
        in_use = sum(
            intel.get_pod_device_request(p)
            for p in node_pods
            if obj.pod_phase(p) == "Running"
        )
        rows.append(("In use", UtilizationBar(in_use, allocatable, unit="GPUs")))
        pod_list = h(
            "ul",
            {"class_": "hl-node-pods"},
            [
                h(
                    "li",
                    None,
                    f"{obj.namespace(p)}/{obj.name(p)} "
                    f"({intel.get_pod_device_request(p)} GPUs)",
                )
                for p in node_pods
            ]
            or [h("li", None, "No GPU pods on this node")],
        )
    else:
        pod_list = h("p", {"class_": "hl-loading-inline"}, "Loading…")

    return SectionBox(
        "Intel GPU", NameValueTable(rows), pod_list, class_="hl-node-detail"
    )


def intel_pod_detail_section(pod: Any) -> Element | None:
    """(`PodDetailSection.tsx`: pure props `:25`, non-GPU null `:31`,
    per container×resource rows `:57-83`, summary `:93-111`.)"""
    pod = unwrap_json_data(pod)
    if not intel.is_gpu_requesting_pod(pod):
        return None

    rows: list[tuple[str, Any]] = [
        ("Phase", phase_label(pod)),
        ("Node", obj.pod_node_name(pod) or "—"),
    ]
    gpu_containers = 0
    for c in obj.pod_containers(pod):
        resources = intel.get_container_gpu_resources(c)
        if resources:
            gpu_containers += 1
        for resource, (req, lim) in resources.items():
            rows.append(
                (
                    f"{c.get('name', '?')} → {intel.format_gpu_resource_name(resource)}",
                    f"request {req} / limit {lim}",
                )
            )
    rows.insert(2, ("GPU containers", gpu_containers))

    return SectionBox("Intel GPU", NameValueTable(rows), class_="hl-pod-detail")


def build_node_intel_columns() -> list[dict[str, Any]]:
    """(`NodeColumns.tsx:17-48`: 'GPU Type' and 'GPU Devices' with
    '—' fallback.)"""

    def type_cell(node: Any) -> str:
        node = unwrap_json_data(node)
        if not intel.is_intel_gpu_node(node):
            return "—"
        return intel.format_gpu_type(intel.get_node_gpu_type(node))

    def devices_cell(node: Any) -> str:
        node = unwrap_json_data(node)
        if not intel.is_intel_gpu_node(node):
            return "—"
        return str(intel.get_node_gpu_count(node))

    return [
        {"label": "GPU Type", "getter": type_cell},
        {"label": "GPU Devices", "getter": devices_cell},
    ]

"""Intel GPU pages — the reference plugin's own surface, hosted here.

The port's copy of ``headlamp_tpu/pages/intel.py``: a user of
`privilegedescalation/headlamp-intel-gpu-plugin` keeps every view the
reference ships (`src/components/` — Overview, DevicePlugins, Nodes,
Pods, Metrics), rendered through the port's UI kit and fed by the same
AcceleratorDataContext that serves TPU. Per-section reference citations
below; TPU remains the first-class provider (registration order) with
Intel as the compatibility provider. Host code only: no page here runs
a device program.
"""

from __future__ import annotations

from typing import Any, Mapping

from ..context.accelerator_context import ClusterSnapshot
from ..domain import intel
from ..domain import objects as obj
from ..metrics.intel_client import (
    INTEL_METRIC_AVAILABILITY,
    IntelMetricsSnapshot,
    format_watts,
)
from ..metrics.client import PROMETHEUS_SERVICES
from ..ui import (
    EmptyContent,
    Loader,
    NameValueTable,
    PercentageBar,
    SectionBox,
    SimpleTable,
    StatusLabel,
    UtilizationBar,
    h,
)
from ..ui.vdom import Element
from ..viewport import pods_by_node
from .native import node_link, pod_link
from .common import (
    age_cell,
    cap_nodes_for_cards,
    error_banner,
    filter_and_page_nodes,
    phase_label,
    ready_label,
    waiting_reason,
)

#: Running-pods cap (`OverviewPage.tsx:414`).
_ACTIVE_CAP = 10


def _crd_missing_notice() -> Element:
    """(`OverviewPage.tsx:199-219`.)"""
    return h(
        "div",
        {"class_": "hl-notice hl-workload-missing"},
        h("h3", None, "GpuDevicePlugin CRD not available"),
        h(
            "p",
            None,
            "The Intel Device Plugins Operator CRD could not be read; node "
            "and pod visibility remains available.",
        ),
    )


def _not_detected_box() -> Element:
    """(`OverviewPage.tsx:171-196` with its Helm hint.)"""
    return h(
        "div",
        {"class_": "hl-notice hl-plugin-missing"},
        h("h3", None, "Intel GPU Plugin Not Detected"),
        h(
            "p",
            None,
            "Install the device plugin operator: helm repo add intel "
            "https://intel.github.io/helm-charts && helm install "
            "intel-device-plugins-operator intel/intel-device-plugins-operator",
        ),
    )


def intel_overview_page(snap: ClusterSnapshot, *, now: float) -> Element:
    """(`OverviewPage.tsx` section for section.)"""
    if snap.loading:
        return h("div", {"class_": "hl-page hl-intel-overview"}, Loader())
    state = snap.provider("intel")
    children: list[Any] = [error_banner(snap)]

    if not state.plugin_installed:
        children.append(_not_detected_box())
    if not state.workload_available:
        children.append(_crd_missing_notice())

    if state.workloads:
        children.append(
            SectionBox(
                "Device Plugins",
                SimpleTable(
                    [
                        {"label": "Name", "getter": obj.name},
                        {
                            "label": "Status",
                            "getter": lambda p: StatusLabel(
                                intel.plugin_status_to_status(p),
                                intel.plugin_status_text(p),
                            ),
                        },
                        {"label": "Age", "getter": lambda p: age_cell(p, now)},
                    ],
                    state.workloads,
                ),
            )
        )

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

    # Node summary + type distribution (`OverviewPage.tsx:275-312`).
    type_counts: dict[str, int] = {}
    ready_nodes = 0
    for n in state.nodes:
        key = intel.format_gpu_type(intel.get_node_gpu_type(n))
        type_counts[key] = type_counts.get(key, 0) + 1
        if obj.is_node_ready(n):
            ready_nodes += 1
    children.append(
        SectionBox(
            "GPU Nodes",
            NameValueTable(
                [
                    ("Total", len(state.nodes)),
                    ("Ready", ready_nodes),
                    ("Not Ready", len(state.nodes) - ready_nodes),
                ]
            ),
            PercentageBar(sorted(type_counts.items())) if type_counts else None,
        )
    )

    # Allocation (`OverviewPage.tsx:316-357`).
    alloc = state.allocation_summary()
    children.append(
        SectionBox(
            "GPU Allocation",
            NameValueTable(
                [
                    ("Capacity", f"{alloc['capacity']} devices"),
                    ("Allocatable", f"{alloc['allocatable']} devices"),
                    ("In use", f"{alloc['in_use']} devices"),
                    ("Free", f"{alloc['free']} devices"),
                ]
            ),
            UtilizationBar(alloc["in_use"], alloc["capacity"], unit="devices"),
        )
    )

    # Phases + top-10 (`OverviewPage.tsx:360-417`).
    phases = obj.count_pod_phases(state.pods)
    children.append(
        SectionBox(
            "GPU Workloads",
            NameValueTable([(k, v) for k, v in phases.items() if v or k != "Other"]),
        )
    )
    running = [p for p in state.pods if obj.pod_phase(p) == "Running"]
    running.sort(key=lambda p: obj.creation_timestamp(p) or "", reverse=True)
    children.append(
        SectionBox(
            f"Active GPU Pods (top {_ACTIVE_CAP})",
            SimpleTable(
                [
                    {"label": "Pod", "getter": pod_link},
                    {"label": "Node", "getter": lambda p: obj.pod_node_name(p) or "—"},
                    {
                        "label": "GPUs",
                        "getter": lambda p: intel.get_pod_device_request(p),
                    },
                    {"label": "Age", "getter": lambda p: age_cell(p, now)},
                ],
                running[:_ACTIVE_CAP],
                empty_message="No running GPU pods",
            ),
        )
    )
    return h("div", {"class_": "hl-page hl-intel-overview"}, children)


def intel_device_plugins_page(snap: ClusterSnapshot, *, now: float) -> Element:
    """(`DevicePluginsPage.tsx`: per-CRD cards `:110-182`, unavailable
    box `:64-85`, empty state `:88-108`, pod table `:185-217`.)"""
    if snap.loading:
        return h("div", {"class_": "hl-page hl-intel-plugins"}, Loader())
    state = snap.provider("intel")
    children: list[Any] = [error_banner(snap)]

    if not state.workload_available:
        children.append(_crd_missing_notice())
    elif not state.workloads:
        children.append(
            EmptyContent(
                h("h3", None, "No GpuDevicePlugin resources found"),
                h("p", None, "The CRD exists but no GpuDevicePlugin has been created."),
            )
        )

    for plugin in state.workloads:
        spec = obj.spec(plugin)
        s = obj.status(plugin)
        desired = obj.parse_int(s.get("desiredNumberScheduled"))
        ready = obj.parse_int(s.get("numberReady"))
        selector = spec.get("nodeSelector")
        selector_text = (
            ", ".join(f"{k}={v}" for k, v in sorted(selector.items()))
            if isinstance(selector, Mapping) and selector
            else "—"
        )
        children.append(
            SectionBox(
                f"GpuDevicePlugin: {obj.name(plugin)}",
                NameValueTable(
                    [
                        (
                            "Status",
                            StatusLabel(
                                intel.plugin_status_to_status(plugin),
                                intel.plugin_status_text(plugin),
                            ),
                        ),
                        ("Image", spec.get("image", "—")),
                        ("Shared devices", spec.get("sharedDevNum", 1)),
                        (
                            "Allocation policy",
                            spec.get("preferredAllocationPolicy", "none"),
                        ),
                        ("Monitoring", "yes" if spec.get("enableMonitoring") else "no"),
                        (
                            "Resource manager",
                            "yes" if spec.get("resourceManager") else "no",
                        ),
                        ("Desired", desired),
                        ("Ready", ready),
                        # The CRD status carries no numberUnavailable
                        # (a DaemonSet-only field) — derive it.
                        ("Unavailable", max(0, desired - ready)),
                        ("Node selector", selector_text),
                        ("Age", age_cell(plugin, now)),
                    ]
                ),
                class_="hl-plugin-card",
            )
        )

    children.append(
        SectionBox(
            "Plugin Pods",
            SimpleTable(
                [
                    {"label": "Pod", "getter": pod_link},
                    {"label": "Node", "getter": lambda p: obj.pod_node_name(p) or "—"},
                    {"label": "Phase", "getter": phase_label},
                    {"label": "Restarts", "getter": obj.pod_restarts},
                    {"label": "Age", "getter": lambda p: age_cell(p, now)},
                ],
                state.plugin_pods,
                empty_message="No device-plugin pods found",
            ),
        )
    )
    return h("div", {"class_": "hl-page hl-intel-plugins"}, children)


def intel_nodes_page(
    snap: ClusterSnapshot, *, now: float, page: int = 1, query: str = ""
) -> Element:
    """(`NodesPage.tsx`: summary `:252-282`, alloc bar `:35-63`, cards
    `:69-139`, empty state `:228-249`.)"""
    if snap.loading:
        return h("div", {"class_": "hl-page hl-intel-nodes"}, Loader())
    state = snap.provider("intel")
    by_node = pods_by_node(state)

    if not state.nodes:
        return h(
            "div",
            {"class_": "hl-page hl-intel-nodes"},
            error_banner(snap),
            EmptyContent(
                h("h3", None, "No Intel GPU nodes found"),
                h(
                    "p",
                    None,
                    "No node carries the NFD Intel GPU labels or advertises "
                    "gpu.intel.com/* capacity.",
                ),
            ),
        )

    def alloc_bar(node: Any) -> Element:
        node_pods = by_node.get(obj.name(node), [])
        in_use = sum(
            intel.get_pod_device_request(p)
            for p in node_pods
            if obj.pod_phase(p) == "Running"
        )
        return UtilizationBar(in_use, intel.get_node_gpu_allocatable(node), unit="GPUs")

    table_nodes, table_controls = filter_and_page_nodes(
        state.nodes,
        page=page,
        query=query,
        base_url="/intel/nodes",
        what="Intel GPU nodes",
    )
    summary = SectionBox(
        "Intel GPU Nodes",
        table_controls,
        SimpleTable(
            [
                {"label": "Name", "getter": node_link},
                {"label": "Ready", "getter": lambda n: ready_label(obj.is_node_ready(n))},
                {
                    "label": "Type",
                    "getter": lambda n: intel.format_gpu_type(intel.get_node_gpu_type(n)),
                },
                {"label": "Devices", "getter": intel.get_node_gpu_count},
                {"label": "Allocation", "getter": alloc_bar},
                {
                    "label": "GPU Pods",
                    "getter": lambda n: len(by_node.get(obj.name(n), [])),
                },
                {"label": "Age", "getter": lambda n: age_cell(n, now)},
            ],
            table_nodes,
        ),
    )

    shown, truncation = cap_nodes_for_cards(state)
    cards = []
    for node in shown:
        info = obj.node_info(node)
        resources = {
            k: v
            for k, v in obj.node_capacity(node).items()
            if k.startswith(intel.INTEL_GPU_RESOURCE_PREFIX)
        }
        cards.append(
            SectionBox(
                obj.name(node),
                NameValueTable(
                    [
                        ("Type", intel.format_gpu_type(intel.get_node_gpu_type(node))),
                        *[
                            (intel.format_gpu_resource_name(k), v)
                            for k, v in sorted(resources.items())
                        ],
                        ("OS", info.get("osImage", "—")),
                        ("Kernel", info.get("kernelVersion", "—")),
                        ("Kubelet", info.get("kubeletVersion", "—")),
                    ]
                ),
                class_="hl-node-card",
            )
        )
    return h(
        "div",
        {"class_": "hl-page hl-intel-nodes"},
        error_banner(snap),
        summary,
        truncation,
        cards,
    )


def intel_pods_page(snap: ClusterSnapshot, *, now: float) -> Element:
    """(`PodsPage.tsx`: summary `:166-198`, container req/lim list
    `:49-88`, pending attention `:239-268`.)"""
    if snap.loading:
        return h("div", {"class_": "hl-page hl-intel-pods"}, Loader())
    state = snap.provider("intel")

    if not state.pods:
        return h(
            "div",
            {"class_": "hl-page hl-intel-pods"},
            error_banner(snap),
            EmptyContent(
                h("h3", None, "No GPU pods found"),
                h("p", None, "No pod requests gpu.intel.com/* in any namespace."),
            ),
        )

    def container_list(pod: Any) -> Element:
        lines = []
        for c in obj.pod_containers(pod):
            for resource, (req, lim) in intel.get_container_gpu_resources(c).items():
                lines.append(
                    h(
                        "div",
                        {"class_": "hl-container-chips"},
                        f"{c.get('name', '?')}: {intel.format_gpu_resource_name(resource)} "
                        f"req={req} lim={lim}",
                    )
                )
        return h("div", None, lines)

    phases = obj.count_pod_phases(state.pods)
    summary = SectionBox(
        "GPU Workload Summary",
        NameValueTable(
            [
                ("Total pods", len(state.pods)),
                *[(k, v) for k, v in phases.items() if v or k != "Other"],
            ]
        ),
    )
    table = SectionBox(
        "All GPU Pods",
        SimpleTable(
            [
                {"label": "Pod", "getter": pod_link},
                {"label": "Phase", "getter": phase_label},
                {"label": "Node", "getter": lambda p: obj.pod_node_name(p) or "—"},
                {"label": "Containers", "getter": container_list},
                {"label": "Restarts", "getter": obj.pod_restarts},
                {"label": "Age", "getter": lambda p: age_cell(p, now)},
            ],
            state.pods,
        ),
    )
    pending = [p for p in state.pods if obj.pod_phase(p) == "Pending"]
    attention = None
    if pending:
        attention = SectionBox(
            "Attention: Pending GPU Pods",
            SimpleTable(
                [
                    {"label": "Pod", "getter": pod_link},
                    {
                        "label": "GPUs requested",
                        "getter": intel.get_pod_device_request,
                    },
                    {"label": "Reason", "getter": lambda p: waiting_reason(p) or "—"},
                    {"label": "Age", "getter": lambda p: age_cell(p, now)},
                ],
                pending,
            ),
            class_="hl-attention",
        )
    return h(
        "div",
        {"class_": "hl-page hl-intel-pods"},
        error_banner(snap),
        summary,
        table,
        attention,
    )


def intel_metrics_page(metrics: IntelMetricsSnapshot | None) -> Element:
    """(`MetricsPage.tsx`: availability matrix `:125-185`, unreachable
    box `:270-286`, no-i915 diagnostic `:288-316`, power summary
    `:318-346`, per-chip power bars `:50-119`.)"""
    matrix = SectionBox(
        "Metric Availability",
        SimpleTable(
            [
                {"label": "Metric", "getter": lambda r: r[0]},
                {
                    "label": "Available",
                    "getter": lambda r: StatusLabel(
                        "success" if r[1] else "warning", "Yes" if r[1] else "No"
                    ),
                },
                {"label": "Notes", "getter": lambda r: r[2]},
            ],
            INTEL_METRIC_AVAILABILITY,
        ),
    )
    children: list[Any] = [matrix]

    if metrics is None:
        children.append(
            h(
                "div",
                {"class_": "hl-notice hl-prom-missing"},
                h("h3", None, "Prometheus not reachable"),
                h(
                    "ul",
                    None,
                    [h("li", None, f"{ns}/{svc}") for ns, svc in PROMETHEUS_SERVICES],
                ),
            )
        )
        return h("div", {"class_": "hl-page hl-intel-metrics"}, children)

    if not metrics.chips:
        children.append(
            h(
                "div",
                {"class_": "hl-notice hl-no-tpu-metrics"},
                h("h3", None, "No i915 Metrics"),
                h(
                    "p",
                    None,
                    f"Prometheus at {metrics.namespace}/{metrics.service} is "
                    "reachable but has no node_hwmon i915 series. Power needs "
                    "discrete i915 GPUs, node-exporter hwmon, and ≥5m of "
                    "scrape history.",
                ),
            )
        )
        return h("div", {"class_": "hl-page hl-intel-metrics"}, children)

    power_samples = [c.power_watts for c in metrics.chips if c.power_watts is not None]
    # Same missing-vs-zero rule as Total power: '—' only when NO chip
    # carries a TDP sample; a fleet of present-but-zero samples sums to
    # a real 'Total TDP 0.0 W'.
    tdp_samples = [c.tdp_watts for c in metrics.chips if c.tdp_watts is not None]
    children.append(
        SectionBox(
            "Power Summary",
            NameValueTable(
                [
                    ("Chips reporting", len(metrics.chips)),
                    # '—' when NO chip has a power sample yet (<5m of
                    # scrape history) — 'Total power 0.0 W' would assert
                    # the GPUs draw nothing.
                    (
                        "Total power",
                        format_watts(sum(power_samples)) if power_samples else "—",
                    ),
                    (
                        "Total TDP",
                        format_watts(sum(tdp_samples)) if tdp_samples else "—",
                    ),
                ]
            ),
            h(
                "p",
                {"class_": "hl-hint"},
                f"Source: {metrics.namespace}/{metrics.service}; scrape→join "
                f"took {metrics.fetch_ms:g} ms.",
            ),
        )
    )
    for c in metrics.chips:
        rows: list[tuple[str, Any]] = [("Power", format_watts(c.power_watts))]
        # None means the sample is missing; 0 is a real reading — a
        # present-but-zero node_hwmon_power_max_watt still gets its TDP
        # row, and the scrape-history hint is reserved for a genuinely
        # absent power rate (mirrors IntelMetricsPage.tsx ChipPowerCard).
        if c.tdp_watts is not None:
            rows.append(("TDP", format_watts(c.tdp_watts)))
            if c.power_watts is not None and c.tdp_watts > 0:
                rows.append(
                    ("Of TDP", UtilizationBar(round(c.power_watts, 1), round(c.tdp_watts, 1), unit="W"))
                )
        if c.power_watts is None:
            rows.append(
                ("Hint", "needs ≥5m of scrape history for rate() to produce data")
            )
        children.append(
            SectionBox(f"{c.node} · {c.chip}", NameValueTable(rows), class_="hl-chip-card")
        )
    return h("div", {"class_": "hl-page hl-intel-metrics"}, children)

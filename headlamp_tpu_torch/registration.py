"""Plugin registration: the routes, sidebar entries, detail sections and
column processors the host serves.

The port's counterpart of ``headlamp_tpu/registration.py``, with the
same ``SidebarEntry``, ``Route``, ``DetailSection``, ``ColumnsProcessor``
and ``Registry`` types. :func:`register_plugin` registers, in the JAX
order (`registration.py:130-191`), the TPU surface: the
Overview at ``/tpu``, the Fleet drill-down at ``/tpu/fleet``, Nodes,
Workloads, Device Plugin, Topology, Metrics and Trends (``/tpu/trends``,
painted from the host's history store), the native nodes table at
``/nodes``, the TPU Node and Pod detail sections (rendered by the host's
``/node/<name>`` and ``/pod/<namespace>/<name>`` views) and the TPU
columns processor, then the telemetry pages: the trace waterfall
(``/debug/traces/html``), the SLO status page (``/sloz/html``), the
profiler's flame view (``/debug/profilez/html``), the generation
timeline (``/debug/generationz/html``) and the incident timeline
(``/debug/incidentz/html``), registered routes outside the sidebar as in
JAX. Beside the TPU half it registers the Intel GPU half, as JAX does:
the Intel sidebar under :data:`INTEL_SIDEBAR_ROOT`, its five routes
(``/intel``, ``/intel/nodes``, ``/intel/pods``, ``/intel/deviceplugins``
and ``/intel/metrics``), the Intel Node and Pod detail sections and the
Intel columns processor on the native nodes table.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from .integrations import (
    build_node_intel_columns,
    build_node_tpu_columns,
    intel_node_detail_section,
    intel_pod_detail_section,
    node_detail_section,
    pod_detail_section,
)
from .obs.debug_pages import (
    generations_page,
    incidents_page,
    profile_page,
    slo_page,
    traces_page,
)
from .pages import (
    device_plugins_page,
    metrics_page,
    nodes_page,
    overview_page,
    pods_page,
    topology_page,
    trends_page,
    viewport_page,
)
from .pages.intel import (
    intel_device_plugins_page,
    intel_metrics_page,
    intel_nodes_page,
    intel_overview_page,
    intel_pods_page,
)
from .pages.native import native_nodes_page


@dataclass(frozen=True)
class SidebarEntry:
    name: str
    label: str
    url: str
    parent: str | None = None


@dataclass(frozen=True)
class Route:
    path: str
    name: str
    #: Page factory; hosts dispatch on ``kind``: 'snapshot' pages take
    #: (snap, now=…), 'metrics' takes the metrics snapshot and the
    #: forecast view, 'topology' takes (snap, metrics=…), 'viewport'
    #: takes (snap, now=…, region=…), 'native-nodes' takes
    #: (snap, now=…, registry=…) and 'trends' takes the history store's
    #: trend view and no snapshot.
    component: Callable[..., Any]
    kind: str = "snapshot"
    #: True for routes whose component accepts ``page=``/``query=`` —
    #: the big node tables. Hosts forward ?page=N&q=… only to these.
    paged: bool = False
    #: True for routes whose component accepts ``limit=``/``cursor=`` —
    #: the cursor-windowed tables. Absent params keep the legacy
    #: rendering byte-identical.
    windowed: bool = False


@dataclass(frozen=True)
class DetailSection:
    #: Kubernetes kind this section attaches to ('Node' | 'Pod') — the
    #: reference guards on resource.kind (`index.tsx:153,168`).
    resource_kind: str
    component: Callable[..., Any]


@dataclass(frozen=True)
class ColumnsProcessor:
    #: Table id to extend — the reference targets 'headlamp-nodes'
    #: (`index.tsx:178`).
    table_id: str
    build_columns: Callable[[], list[dict[str, Any]]]


@dataclass
class Registry:
    sidebar_entries: list[SidebarEntry] = field(default_factory=list)
    routes: list[Route] = field(default_factory=list)
    detail_sections: list[DetailSection] = field(default_factory=list)
    columns_processors: list[ColumnsProcessor] = field(default_factory=list)

    def route_for(self, path: str) -> Route | None:
        for r in self.routes:
            if r.path == path:
                return r
        return None

    def sections_for(self, resource_kind: str) -> list[DetailSection]:
        return [s for s in self.detail_sections if s.resource_kind == resource_kind]


#: The sidebar roots the entries hang under, as in the JAX package. TPU
#: first by design (accelerator.PROVIDERS order); Intel is the
#: compatibility provider carrying the reference plugin's full surface.
SIDEBAR_ROOT = "tpu"
INTEL_SIDEBAR_ROOT = "intel"


def register_plugin(registry: Registry | None = None) -> Registry:
    """Populate a registry with the pages, sections and columns this
    package renders, for both providers (each section and column set
    null-guards the other provider's resources)."""
    reg = registry if registry is not None else Registry()
    reg.sidebar_entries.extend(
        [
            SidebarEntry(SIDEBAR_ROOT, "Cloud TPU", "/tpu", parent=None),
            SidebarEntry("tpu-overview", "Overview", "/tpu", parent=SIDEBAR_ROOT),
            SidebarEntry("tpu-fleet", "Fleet", "/tpu/fleet", parent=SIDEBAR_ROOT),
            SidebarEntry("tpu-nodes", "Nodes", "/tpu/nodes", parent=SIDEBAR_ROOT),
            SidebarEntry("tpu-pods", "Workloads", "/tpu/pods", parent=SIDEBAR_ROOT),
            SidebarEntry(
                "tpu-deviceplugins", "Device Plugin", "/tpu/deviceplugins", parent=SIDEBAR_ROOT
            ),
            SidebarEntry("tpu-topology", "Topology", "/tpu/topology", parent=SIDEBAR_ROOT),
            SidebarEntry("tpu-metrics", "Metrics", "/tpu/metrics", parent=SIDEBAR_ROOT),
            SidebarEntry("tpu-trends", "Trends", "/tpu/trends", parent=SIDEBAR_ROOT),
            SidebarEntry(INTEL_SIDEBAR_ROOT, "Intel GPU", "/intel", parent=None),
            SidebarEntry("intel-overview", "Overview", "/intel", parent=INTEL_SIDEBAR_ROOT),
            SidebarEntry("intel-nodes", "Nodes", "/intel/nodes", parent=INTEL_SIDEBAR_ROOT),
            SidebarEntry("intel-pods", "Workloads", "/intel/pods", parent=INTEL_SIDEBAR_ROOT),
            SidebarEntry(
                "intel-deviceplugins", "Device Plugins", "/intel/deviceplugins",
                parent=INTEL_SIDEBAR_ROOT,
            ),
            SidebarEntry("intel-metrics", "Metrics", "/intel/metrics", parent=INTEL_SIDEBAR_ROOT),
            # The host's own native surface: the nodes table the column
            # processors extend.
            SidebarEntry("cluster", "Cluster", "/nodes", parent=None),
            SidebarEntry("cluster-nodes", "Nodes", "/nodes", parent="cluster"),
        ]
    )
    reg.routes.extend(
        [
            Route("/tpu", "tpu-overview", overview_page),
            # The drill-down: fleet → cluster → slice → node. Its kind
            # dispatch forwards ?region= beside the cursor-window params.
            Route("/tpu/fleet", "tpu-fleet", viewport_page, kind="viewport", windowed=True),
            Route("/tpu/nodes", "tpu-nodes", nodes_page, paged=True, windowed=True),
            Route("/tpu/pods", "tpu-pods", pods_page, windowed=True),
            Route("/tpu/deviceplugins", "tpu-deviceplugins", device_plugins_page),
            Route("/tpu/topology", "tpu-topology", topology_page, kind="topology"),
            Route("/tpu/metrics", "tpu-metrics", metrics_page, kind="metrics"),
            # The history tier's trend surface: its kind dispatch hands it
            # the store's windowed view instead of a cluster snapshot, so
            # it paints while the sync is the thing under investigation.
            Route("/tpu/trends", "tpu-trends", trends_page, kind="trends"),
            Route("/intel", "intel-overview", intel_overview_page),
            Route("/intel/nodes", "intel-nodes", intel_nodes_page, paged=True),
            Route("/intel/pods", "intel-pods", intel_pods_page),
            Route("/intel/deviceplugins", "intel-deviceplugins", intel_device_plugins_page),
            Route("/intel/metrics", "intel-metrics", intel_metrics_page, kind="intel-metrics"),
            Route(
                "/nodes", "cluster-nodes", native_nodes_page, kind="native-nodes", paged=True
            ),
            # The telemetry pages: registered, so they paint through the
            # host's chrome, but operator tools outside the sidebar. Their
            # kind dispatch hands each its snapshot, never a cluster
            # snapshot; the JSON twins are the host's own routes.
            Route("/debug/traces/html", "debug-traces", traces_page, kind="traces"),
            Route("/sloz/html", "slo-status", slo_page, kind="slo"),
            Route("/debug/profilez/html", "debug-profile", profile_page, kind="profile"),
            Route(
                "/debug/generationz/html", "debug-generations", generations_page,
                kind="generations",
            ),
            Route(
                "/debug/incidentz/html", "debug-incidents", incidents_page, kind="incidents"
            ),
        ]
    )
    reg.detail_sections.extend(
        [
            DetailSection("Node", node_detail_section),
            DetailSection("Pod", pod_detail_section),
            DetailSection("Node", intel_node_detail_section),
            DetailSection("Pod", intel_pod_detail_section),
        ]
    )
    reg.columns_processors.append(ColumnsProcessor("headlamp-nodes", build_node_tpu_columns))
    reg.columns_processors.append(ColumnsProcessor("headlamp-nodes", build_node_intel_columns))
    return reg

"""Plugin registration: the routes and sidebar entries the host serves.

The port's counterpart of ``headlamp_tpu/registration.py``, with the
same ``SidebarEntry``, ``Route`` and ``Registry`` types.
:func:`register_plugin` registers, in the JAX order
(`registration.py:130-186`), only the routes whose page this package
renders: the Overview at ``/tpu``, Nodes, Workloads, Device Plugin,
Topology and Metrics. ``/tpu/fleet``, ``/tpu/trends``, the native detail
views and the Intel pages are not registered, so the host answers them
with a 404 and never with a stand-in page.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from .pages import (
    device_plugins_page,
    metrics_page,
    nodes_page,
    overview_page,
    pods_page,
    topology_page,
)


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
    #: forecast view, 'topology' takes (snap, metrics=…).
    component: Callable[..., Any]
    kind: str = "snapshot"
    #: True for routes whose component accepts ``page=``/``query=`` —
    #: the big node tables. Hosts forward ?page=N&q=… only to these.
    paged: bool = False
    #: True for routes whose component accepts ``limit=``/``cursor=`` —
    #: the cursor-windowed tables. Absent params keep the legacy
    #: rendering byte-identical.
    windowed: bool = False


@dataclass
class Registry:
    sidebar_entries: list[SidebarEntry] = field(default_factory=list)
    routes: list[Route] = field(default_factory=list)

    def route_for(self, path: str) -> Route | None:
        for r in self.routes:
            if r.path == path:
                return r
        return None


#: The sidebar root the entries hang under, as in the JAX package.
SIDEBAR_ROOT = "tpu"


def register_plugin(registry: Registry | None = None) -> Registry:
    """Populate a registry with the pages this package renders."""
    reg = registry if registry is not None else Registry()
    reg.sidebar_entries.extend(
        [
            SidebarEntry(SIDEBAR_ROOT, "Cloud TPU", "/tpu", parent=None),
            SidebarEntry("tpu-overview", "Overview", "/tpu", parent=SIDEBAR_ROOT),
            SidebarEntry("tpu-nodes", "Nodes", "/tpu/nodes", parent=SIDEBAR_ROOT),
            SidebarEntry("tpu-pods", "Workloads", "/tpu/pods", parent=SIDEBAR_ROOT),
            SidebarEntry(
                "tpu-deviceplugins", "Device Plugin", "/tpu/deviceplugins", parent=SIDEBAR_ROOT
            ),
            SidebarEntry("tpu-topology", "Topology", "/tpu/topology", parent=SIDEBAR_ROOT),
            SidebarEntry("tpu-metrics", "Metrics", "/tpu/metrics", parent=SIDEBAR_ROOT),
        ]
    )
    reg.routes.extend(
        [
            Route("/tpu", "tpu-overview", overview_page),
            Route("/tpu/nodes", "tpu-nodes", nodes_page, paged=True, windowed=True),
            Route("/tpu/pods", "tpu-pods", pods_page, windowed=True),
            Route("/tpu/deviceplugins", "tpu-deviceplugins", device_plugins_page),
            Route("/tpu/topology", "tpu-topology", topology_page, kind="topology"),
            Route("/tpu/metrics", "tpu-metrics", metrics_page, kind="metrics"),
        ]
    )
    return reg

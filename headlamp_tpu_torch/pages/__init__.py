"""Pages — pure functions from snapshots to element trees: Overview,
Fleet (the drill-down), Nodes, Pods, DevicePlugins, Topology, Metrics
and Trends (a function of the history store's view, not of a snapshot),
as in the JAX package; the native node and pod views are in
``native``, the five Intel GPU pages in ``intel``."""

from .device_plugins import device_plugins_page
from .metrics_page import metrics_page
from .nodes import nodes_page
from .overview import overview_page
from .pods import pods_page
from .topology_page import topology_page
from .trends_page import trends_page
from .viewport_page import viewport_page

__all__ = [
    "device_plugins_page",
    "metrics_page",
    "nodes_page",
    "overview_page",
    "pods_page",
    "topology_page",
    "trends_page",
    "viewport_page",
]

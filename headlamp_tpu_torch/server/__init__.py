"""Dashboard hosting: the HTTP host for the metrics page (``app``), run
with ``python -m headlamp_tpu_torch.server``, and demo mode's fixture
fleets with synthetic Prometheus series (``demo``)."""

from .app import DashboardApp, DashboardServer, serve
from .demo import DEMO_FLEETS, add_demo_prometheus, make_demo_transport

__all__ = [
    "DEMO_FLEETS",
    "DashboardApp",
    "DashboardServer",
    "add_demo_prometheus",
    "make_demo_transport",
    "serve",
]

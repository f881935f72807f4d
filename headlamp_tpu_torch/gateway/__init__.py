"""Request gateway: the admission layer between the socket server and
``DashboardApp.handle``.

The port's copy of ``headlamp_tpu/gateway``: a bounded priority render
pool (``pool.py``), burn-rate shedding off the port's SLO engine
(``shed.py``) and whole-page render coalescing (``coalesce.py``) behind
one front door (``gateway.py``). Outside this package only the host's
socket wiring calls the app's render path.
"""

from .coalesce import RenderCoalescer
from .gateway import OPS_ROUTES, RETRY_AFTER_S, GatewayResponse, RenderGateway, set_active
from .pool import (
    PRIORITY_DEBUG,
    PRIORITY_INTERACTIVE,
    PRIORITY_NAMES,
    PRIORITY_OPS,
    Job,
    QueueFull,
    RenderPool,
)
from .shed import Decision, ShedPolicy, degraded_active, degraded_scope

__all__ = [
    "Decision",
    "GatewayResponse",
    "Job",
    "OPS_ROUTES",
    "PRIORITY_DEBUG",
    "PRIORITY_INTERACTIVE",
    "PRIORITY_NAMES",
    "PRIORITY_OPS",
    "QueueFull",
    "RETRY_AFTER_S",
    "RenderCoalescer",
    "RenderGateway",
    "RenderPool",
    "ShedPolicy",
    "degraded_active",
    "degraded_scope",
    "set_active",
]

"""Dashboard hosting. This package carries demo mode only; the HTTP
server and gateway are not part of it yet."""

from .demo import DEMO_FLEETS, add_demo_prometheus, make_demo_transport

__all__ = ["DEMO_FLEETS", "add_demo_prometheus", "make_demo_transport"]

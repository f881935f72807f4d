"""Transport layer — how the dashboard talks to a Kubernetes API server:
one JSON-over-HTTP request function behind which all cluster access
happens, injectable with :class:`MockTransport`."""

from .api_proxy import DEFAULT_TIMEOUT_S, ApiError, MockTransport, Transport, WatchFeed

__all__ = ["DEFAULT_TIMEOUT_S", "ApiError", "MockTransport", "Transport", "WatchFeed"]

"""Transport layer — how the dashboard talks to a Kubernetes API server:
one JSON-over-HTTP request function behind which all cluster access
happens, real (:class:`KubeTransport` over a keep-alive
:class:`ConnectionPool`) or injectable (:class:`MockTransport`)."""

from .api_proxy import (
    DEFAULT_TIMEOUT_S,
    ApiError,
    KubeTransport,
    MockTransport,
    RequestTimeout,
    Transport,
    WatchFeed,
    WatchTransport,
    with_timeout,
)
from .pool import (
    ConnectionPool,
    FanoutScheduler,
    PooledResponse,
    PoolExhausted,
    choose_width,
    fanout,
    pool_of,
)

__all__ = [
    "DEFAULT_TIMEOUT_S",
    "ApiError",
    "ConnectionPool",
    "FanoutScheduler",
    "KubeTransport",
    "MockTransport",
    "PooledResponse",
    "PoolExhausted",
    "RequestTimeout",
    "Transport",
    "WatchFeed",
    "WatchTransport",
    "choose_width",
    "fanout",
    "pool_of",
    "with_timeout",
]

"""Request-scoped span tracing and bounded trace retention.

The port's copy of ``headlamp_tpu/obs/trace.py``, trimmed to what the
dashboard host's metrics path uses. ``DashboardApp.handle`` opens a
:class:`trace_request` around each request; every instrumented stage
below it (the metrics fetch, the forecast history query and fit, the
transfer flush, the HTML render) wraps itself in :func:`span`, and the
completed trace lands in :data:`trace_ring`, which ``/debug/traces``
serves.

The active span rides a :mod:`contextvars` ContextVar: under
``ThreadingHTTPServer`` each request thread sees only its own trace,
and a background refit started with ``contextvars.copy_context`` (see
``runtime/refresh.py``) attaches its spans to the request that kicked
it off.

Span durations come from ``time.perf_counter``; each trace carries one
wall-clock ``started_at``, passed in through ``trace_request``'s
``wall`` seam, for display only.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextvars import ContextVar
from typing import Any, Callable

#: Completed traces retained for /debug/traces, oldest dropped first.
TRACE_RING_CAPACITY = 64


class Span:
    """One timed stage. ``t0``/``t1`` are perf_counter stamps; children
    nest in call order. Written only by the context that opened it."""

    __slots__ = ("name", "t0", "t1", "attrs", "children")

    def __init__(self, name: str, attrs: dict[str, Any]) -> None:
        self.name = name
        self.t0 = time.perf_counter()
        self.t1: float | None = None
        self.attrs = attrs
        self.children: list[Span] = []


#: The innermost open span of the calling context; None means no trace
#: is active (CLI renders, tests) and spans do nothing.
_ACTIVE: ContextVar[Span | None] = ContextVar("hl_torch_active_span", default=None)
#: The whole Trace of the calling context.
_TRACE: ContextVar[Trace | None] = ContextVar("hl_torch_active_trace", default=None)


def current_trace_id() -> str | None:
    """Trace id of the calling context's request, or None outside one."""
    trace = _TRACE.get()
    return trace.trace_id if trace is not None else None


class span:
    """``with span("forecast.fit", series=64):`` times the block as a
    child of the innermost open span. Yields the Span (for late attrs)
    or None when no trace is active."""

    __slots__ = ("_name", "_attrs", "_node", "_token")

    def __init__(self, name: str, **attrs: Any) -> None:
        self._name = name
        self._attrs = attrs
        self._node: Span | None = None

    def __enter__(self) -> Span | None:
        parent = _ACTIVE.get()
        if parent is None:
            return None
        node = Span(self._name, self._attrs)
        parent.children.append(node)
        self._node = node
        self._token = _ACTIVE.set(node)
        return node

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        node = self._node
        if node is not None:
            _ACTIVE.reset(self._token)
            node.t1 = time.perf_counter()
            if exc_type is not None:
                # The stage that failed is the one an operator reads
                # the trace for.
                node.attrs["error"] = exc_type.__name__
        return False


def set_remote_parent(trace_id: str | None) -> None:
    """Link the calling context's trace to a trace in another process
    (no-op outside a trace or with a None id): the seam a replica's apply
    uses when the leader's trace id becomes known mid-trace, from the bus
    record, after the poll trace opened."""
    trace = _TRACE.get()
    if trace is not None and trace_id:
        trace.remote_parent = trace_id


def annotate(**attrs: Any) -> None:
    """Attach attributes to the innermost open span (no-op without one)."""
    node = _ACTIVE.get()
    if node is not None:
        node.attrs.update(attrs)


class Trace:
    """One request's span tree plus display metadata. ``trace_id`` is a
    process-unique 16-hex id. ``remote_parent`` is the trace id of the
    request in another process this trace continues (a leader's bus
    serve joins the polling replica's trace, a replica's apply joins the
    leader's publishing trace): a link, never an identity override."""

    __slots__ = (
        "path", "started_at", "trace_id", "remote_parent", "root", "route", "status",
        "device_gets",
    )

    def __init__(
        self, path: str, *, started_at: float = 0.0, remote_parent: str | None = None
    ) -> None:
        self.path = path
        self.started_at = started_at
        self.trace_id = os.urandom(8).hex()
        self.remote_parent = remote_parent
        self.root = Span("request", {})
        self.route = path
        self.status = 0
        self.device_gets = 0

    def finish(self, *, route: str, status: int, device_gets: int) -> None:
        self.route = route
        self.status = status
        self.device_gets = device_gets
        if self.root.t1 is None:
            self.root.t1 = time.perf_counter()

    def to_dict(self) -> dict[str, Any]:
        t0 = self.root.t0
        end = self.root.t1 if self.root.t1 is not None else t0
        out = {
            "trace_id": self.trace_id,
            "path": self.path,
            "route": self.route,
            "status": self.status,
            "started_at": round(self.started_at, 3),
            "duration_ms": round((end - t0) * 1000, 3),
            "device_gets": self.device_gets,
            "spans": [_span_dict(c, t0) for c in self.root.children],
        }
        if self.remote_parent is not None:
            out["remote_parent"] = self.remote_parent
        return out


def _span_dict(s: Span, t0: float) -> dict[str, Any]:
    end = s.t1 if s.t1 is not None else s.t0
    return {
        "name": s.name,
        "start_ms": round((s.t0 - t0) * 1000, 3),
        "duration_ms": round((end - s.t0) * 1000, 3),
        "attrs": dict(s.attrs),
        "children": [_span_dict(c, t0) for c in s.children],
    }


class trace_request:
    """Install a fresh trace for the calling context. Yields the Trace,
    or None when the caller opted out (``enabled=False``: health and
    metrics probes stay out of the ring) or a trace is already active.
    ``wall`` supplies the display-only ``started_at`` stamp;
    ``remote_parent`` is the 16-hex trace id parsed from an inbound
    ``traceparent`` header (``obs/propagate.py``)."""

    __slots__ = (
        "_path", "_enabled", "_wall", "_remote_parent", "_trace", "_token", "_trace_token",
    )

    def __init__(
        self,
        path: str,
        *,
        enabled: bool = True,
        wall: Callable[[], float] = time.time,
        remote_parent: str | None = None,
    ) -> None:
        self._path = path
        self._enabled = enabled
        self._wall = wall
        self._remote_parent = remote_parent
        self._trace: Trace | None = None

    def __enter__(self) -> Trace | None:
        if not self._enabled or _ACTIVE.get() is not None:
            return None
        trace = Trace(self._path, started_at=self._wall(), remote_parent=self._remote_parent)
        self._trace = trace
        self._token = _ACTIVE.set(trace.root)
        self._trace_token = _TRACE.set(trace)
        return trace

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        trace = self._trace
        if trace is not None:
            _ACTIVE.reset(self._token)
            _TRACE.reset(self._trace_token)
            trace.root.t1 = time.perf_counter()
        return False


class TraceRing:
    """Bounded FIFO of completed traces, kept as JSON-ready dicts so the
    debug surface never serializes a live span tree."""

    def __init__(self, capacity: int = TRACE_RING_CAPACITY) -> None:
        self.capacity = capacity
        self._lock = threading.Lock()
        self._traces: deque[dict[str, Any]] = deque(maxlen=capacity)

    def record(self, trace: dict[str, Any]) -> None:
        with self._lock:
            self._traces.append(trace)

    def snapshot(self) -> list[dict[str, Any]]:
        """Newest first."""
        with self._lock:
            return list(reversed(self._traces))

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)


#: Process-wide ring: one server, one recent-request debug surface.
trace_ring = TraceRing()

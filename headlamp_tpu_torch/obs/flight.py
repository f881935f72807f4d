"""Flight recorder: one bounded wide event per request.

The port's copy of ``headlamp_tpu/obs/flight.py``: the triage surface
between a burning SLO and a span waterfall. Every recorded request
collapses into one wide event (the request line, its route and status,
the duration of each top-level stage of its span tree, and what it moved
in the runtime counters) and lands in a bounded ring. A request that
answered 5xx or violated a request-backed objective is also pinned into
a second ring that healthy traffic cannot evict, so ``/debug/flightz``
still shows it after thousands of good requests.

The trace ring keeps full span trees for the last 64 requests; the
recorder keeps flat summaries of more, plus the pinned bad ones, and
carries the trace id that joins the two. Counter deltas are process-wide
reads taken around the request: under concurrent traffic a delta can
include a neighbour's activity, which a triage surface accepts.
"""

from __future__ import annotations

import sys
import threading
from collections import deque
from typing import Any, Mapping

#: Healthy-traffic retention: flat events of about 0.5 KB each.
FLIGHT_RING_CAPACITY = 256

#: Pinned (error or SLO-violating) retention, evicted only by newer
#: pinned events.
PINNED_RING_CAPACITY = 64


def counters_delta(before: Mapping[str, Any], after: Mapping[str, Any]) -> dict[str, float]:
    """Nonzero numeric movements between two flat counter snapshots; a
    key only ``after`` holds counts from zero."""
    delta: dict[str, float] = {}
    for key, after_value in after.items():
        if not isinstance(after_value, (int, float)) or isinstance(after_value, bool):
            continue
        before_value = before.get(key, 0)
        if not isinstance(before_value, (int, float)) or isinstance(before_value, bool):
            before_value = 0
        moved = after_value - before_value
        if moved:
            delta[key] = round(moved, 6) if isinstance(moved, float) else moved
    return delta


def wide_event(
    *,
    path: str,
    route: str,
    status: int,
    duration_s: float,
    trace: Mapping[str, Any] | None = None,
    violations: tuple[str, ...] | list[str] = (),
    counters_before: Mapping[str, Any] | None = None,
    counters_after: Mapping[str, Any] | None = None,
    gateway: Mapping[str, Any] | None = None,
    replication: Mapping[str, Any] | None = None,
) -> dict[str, Any]:
    """One request's flight-recorder event. ``trace`` is the frozen trace
    dict the trace ring records; its top-level spans become the stage
    durations (name → ms), the nested detail stays in the ring.
    ``gateway`` is the admission story of a request the gateway admitted
    (priority class, queue wait, degraded flag): it tells a slow queue
    from a slow render. ``replication`` is the replication role, the
    applied generation and the bus cursor: it tells whether the paint
    served stale data."""
    stages: dict[str, float] = {}
    trace_id = None
    if trace is not None:
        trace_id = trace.get("trace_id")
        for span in trace.get("spans", ()):
            name = str(span.get("name", ""))
            stages[name] = round(stages.get(name, 0.0) + float(span.get("duration_ms", 0.0)), 3)
    event: dict[str, Any] = {
        "request": f"GET {path}",
        "route": route,
        "status": status,
        "duration_ms": round(duration_s * 1000, 3),
        "trace_id": trace_id,
        "stages": stages,
        "slo_violations": list(violations),
    }
    if counters_before is not None and counters_after is not None:
        event["counters"] = counters_delta(counters_before, counters_after)
    if gateway is not None:
        event["gateway"] = dict(gateway)
    if replication is not None:
        event["replication"] = dict(replication)
    return event


class FlightRecorder:
    """Two bounded FIFO rings (recent and pinned) of frozen events."""

    def __init__(
        self, capacity: int = FLIGHT_RING_CAPACITY, pinned_capacity: int = PINNED_RING_CAPACITY
    ) -> None:
        self.capacity = capacity
        self.pinned_capacity = pinned_capacity
        self._lock = threading.Lock()
        self._recent: deque[dict[str, Any]] = deque(maxlen=capacity)
        self._pinned: deque[dict[str, Any]] = deque(maxlen=pinned_capacity)

    def record(self, event: dict[str, Any], *, pinned: bool = False) -> None:
        """Every event lands in recent; a pinned one in pinned too."""
        with self._lock:
            self._recent.append(event)
            if pinned:
                self._pinned.append(event)

    def snapshot(self) -> dict[str, list[dict[str, Any]]]:
        """Both rings, newest first."""
        with self._lock:
            return {"pinned": list(reversed(self._pinned)), "recent": list(reversed(self._recent))}

    def clear(self) -> None:
        with self._lock:
            self._recent.clear()
            self._pinned.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._recent)

    def memory_bytes(self) -> int:
        """Recursive shallow size of both rings, an event held by both
        counted once."""
        seen: set[int] = set()

        def size(obj: Any) -> int:
            if id(obj) in seen:
                return 0
            seen.add(id(obj))
            total = sys.getsizeof(obj)
            if isinstance(obj, dict):
                total += sum(size(k) + size(v) for k, v in obj.items())
            elif isinstance(obj, (list, tuple)):
                total += sum(size(item) for item in obj)
            return total

        with self._lock:
            return sum(size(e) for e in self._recent) + sum(
                size(e) for e in self._pinned if id(e) not in seen
            )


#: The process recorder: one server, one /debug/flightz.
flight_recorder = FlightRecorder()

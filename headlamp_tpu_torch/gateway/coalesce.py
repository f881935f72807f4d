"""Whole-page render coalescing: keyed single flight.

The port's copy of ``headlamp_tpu/gateway/coalesce.py:29-85``. Identical
concurrent requests cost one pool slot and one render: the followers
wait on the leader's flight and receive its bytes. The key carries
everything that could change the bytes (path, canonical query, snapshot
generation, cache epoch, degraded flag), so anything keyed the same is
the same page. Followers hold no pool slot: they wait in their own
request thread.
"""

from __future__ import annotations

import threading
from typing import Any, Hashable


class Flight:
    """One leader render in flight. Followers wait on ``done``."""

    __slots__ = ("done", "result", "error", "followers")

    def __init__(self) -> None:
        self.done = threading.Event()
        self.result: Any = None
        self.error: BaseException | None = None
        #: Requests that joined this flight, the leader excluded.
        self.followers = 0


class RenderCoalescer:
    """Keyed single-flight map. The leader must call :meth:`finish` (in a
    ``finally``), or its followers wait out their whole timeout."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._flights: dict[Hashable, Flight] = {}

    def join_or_lead(self, key: Hashable) -> tuple[Flight, bool]:
        """(flight, is_leader): a leader gets a fresh flight registered
        under ``key``, a follower the existing one."""
        with self._lock:
            flight = self._flights.get(key)
            if flight is not None:
                flight.followers += 1
                return flight, False
            flight = Flight()
            self._flights[key] = flight
            return flight, True

    def finish(
        self, key: Hashable, flight: Flight, *, result: Any = None,
        error: BaseException | None = None,
    ) -> None:
        """Publish the leader's result and release the followers. The
        flight is removed first, so a request arriving after completion
        leads a fresh render."""
        with self._lock:
            if self._flights.get(key) is flight:
                del self._flights[key]
        flight.result = result
        flight.error = error
        flight.done.set()

    def inflight(self) -> int:
        with self._lock:
            return len(self._flights)

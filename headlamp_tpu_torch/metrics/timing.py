"""Shared fetch-stamp discipline for the metrics client.

Wall clock for the DISPLAYED ``fetched_at`` stamp, ``perf_counter`` for
the MEASURED ``fetch_ms`` duration — never mixed, because an NTP step
mid-fetch would corrupt a wall-clock elapsed but can only relabel a
display timestamp.
"""

from __future__ import annotations

import time
from typing import Callable


class FetchTimer:
    """Started at construction; :meth:`stamp` closes the measurement.

    >>> timer = FetchTimer(clock)
    >>> ...  # discovery + fan-out + join
    >>> fetched_at, fetch_ms = timer.stamp()
    """

    __slots__ = ("_clock", "_t0")

    def __init__(self, clock: Callable[[], float]) -> None:
        self._clock = clock
        self._t0 = time.perf_counter()

    def stamp(self) -> tuple[float, float]:
        """(fetched_at, fetch_ms) — wall stamp from the injected clock,
        duration from perf_counter, rounded the way every snapshot
        field is."""
        fetch_ms = round((time.perf_counter() - self._t0) * 1000, 1)
        return self._clock(), fetch_ms

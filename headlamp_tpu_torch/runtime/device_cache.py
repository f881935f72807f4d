"""Process-scoped warm-start forecast carries.

The port's counterpart of ``headlamp_tpu/runtime/device_cache.py``'s
``WarmCarryCache`` and ``warm_carries``. The fleet-column cache and the
fused rollup results wait for the rollups.
"""

from __future__ import annotations

import threading
from typing import Any, Hashable


class WarmCarryCache:
    """Warm-start carries (fitted params and Adam state, a
    ``models.forecast.WarmState``) per chip-set key, for the whole
    process: a rebuilt ``DashboardApp`` (a fresh server, a test's fresh
    app) warm-starts from what the process already learned for that chip
    set instead of paying the cold fit again.

    Carries stay on the device. The JAX package stages them on the host
    at every ``store`` for two reasons that do not hold here. Its warm
    program donates the carry's buffers, so a device-resident carry
    would be dead after one fit; the port donates nothing, and its
    ``_train`` clones the params and optimizer state it is handed. And a
    module global releasing XLA buffers at interpreter exit races XLA's
    own teardown; torch frees CUDA memory through its caching allocator,
    which outlives such globals. The JAX staging copy also fenced the
    fit; here ``fetch_host`` has already copied the fit's predictions
    and MSE to the host, which waits for the stream, before the carry is
    stored, so a stored carry is never a computation still in flight.

    ``take()`` pops: a carry feeds exactly one fit at a time, so two
    concurrent takers never refine the same lineage twice. The loser of
    the pop cold-fits, which is correct, merely slower. The caller stores
    the new carry when its fit returns. Entries beyond ``max_keys`` are
    evicted least recently stored first: a carry is about 2 MB of params
    and moments, and a dashboard serves a handful of fleets."""

    def __init__(self, *, max_keys: int = 8) -> None:
        self._lock = threading.Lock()
        self._entries: dict[Hashable, Any] = {}
        self.max_keys = max_keys
        self.hits = 0
        self.lookups = 0
        self.evictions = 0

    def take(self, key: Hashable) -> Any | None:
        """Remove and return the carry for ``key`` (None on a miss)."""
        with self._lock:
            self.lookups += 1
            state = self._entries.pop(key, None)
            if state is not None:
                self.hits += 1
            return state

    def store(self, key: Hashable, state: Any) -> None:
        with self._lock:
            # Re-insert at the end: dict order is the eviction order.
            self._entries.pop(key, None)
            self._entries[key] = state
            while len(self._entries) > self.max_keys:
                del self._entries[next(iter(self._entries))]
                self.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def invalidate(self) -> None:
        with self._lock:
            self._entries.clear()

    def counters(self) -> dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "lookups": self.lookups, "evictions": self.evictions}


#: The process-wide carry store: only a chip set this process has never
#: fit pays a cold fit.
warm_carries = WarmCarryCache()

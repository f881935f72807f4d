"""Device-resident fleet columns and process-scoped warm-start carries.

The port's counterpart of ``headlamp_tpu/runtime/device_cache.py``'s
``DeviceFleetCache`` (`:68-231`, its ``seed`` at `:155-182`),
``RollupResultCache`` (`:234-280`),
``WarmCarryCache`` and ``warm_carries``. The fleet columns and the
parked rollup results belong to each data context, not to the process.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import TYPE_CHECKING, Any, Hashable

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..obs.metrics import registry as _metrics_registry
from ..obs.trace import annotate as _annotate
from ..obs.trace import span as _span

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..analytics.encode import FleetArrays
    from ..domain.accelerator import FleetView


def _to_device(fleet: FleetArrays, device: torch.device) -> FleetArrays:
    """A FleetArrays twin with every numpy column copied to ``device``.
    Scalars (n_nodes/n_pods) and node_names stay host-side. The calling
    thread's stream is synchronized before the twin is returned: an
    entry is published complete, so a request thread reading it on its
    own stream never races the copy (JAX's ``block_until_ready``). A
    read-only column (a view over ``bytes``) is copied on the host first:
    ``torch.from_numpy`` would alias memory it may not write."""
    replacements = {
        field.name: torch.from_numpy(value if value.flags.writeable else value.copy()).to(device)
        for field in dataclasses.fields(fleet)
        if isinstance(value := getattr(fleet, field.name), np.ndarray)
    }
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return dataclasses.replace(fleet, **replacements)


class DeviceFleetCache:
    """Per-provider device-resident ``FleetArrays``, one entry each,
    keyed by the view's snapshot ``version``: a warm request re-uses the
    columns already on the device and pays the rollup and its one copy
    only; encode and upload happen once per snapshot version.

    Invalidation contract: the snapshot generation IS the key. The data
    context that owns this cache stamps a monotone ``version`` onto every
    ``FleetView`` it builds; a clean tick reuses the version (hit), a
    changed fleet gets a new one (miss → re-encode + re-upload, old entry
    dropped). Views without a version are never cached: they take the
    encode path every call and the rollup copies their columns.

    Thread-safe for the server's access pattern. The lock guards only
    dict bookkeeping; encode + upload happen outside it, so two threads
    racing the same cold version upload twice rather than serializing
    every warm hit behind an upload. An upload publishes its entry only
    over an older version (or none): a request thread finishing the
    upload of a snapshot it read before the background loop warmed a
    newer one must not replace the newer entry. :meth:`seed` installs
    columns that arrived already encoded. Failures propagate. The columns
    live on CUDA unless the caller asks for the CPU; without CUDA the
    constructor raises."""

    def __init__(self, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._entries: dict[str, tuple[int, FleetArrays]] = {}
        self.hits = 0
        self.misses = 0
        #: Encodes copied to the device (versioned misses and warms).
        self.uploads = 0
        #: Columns that arrived encoded (a worker's segment) and were
        #: copied to the device with no encode.
        self.seeds = 0
        # Process-wide instruments (get-or-create) for /metricsz; the
        # ints above are this cache's own, for /healthz and tests.
        self._hits_total = _metrics_registry.counter(
            "headlamp_tpu_torch_fleet_cache_hits_total",
            "fleet_for calls served from device-resident columns",
        )
        self._misses_total = _metrics_registry.counter(
            "headlamp_tpu_torch_fleet_cache_misses_total",
            "fleet_for calls that paid an encode (and, versioned, an upload)",
        )

    def _count(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.hits += 1
            else:
                self.misses += 1
        (self._hits_total if hit else self._misses_total).inc()

    def _upload(self, view: FleetView) -> FleetArrays:
        from ..analytics.encode import encode_fleet

        with _span("device_cache.upload", nodes=len(view.nodes)):
            fleet = _to_device(encode_fleet(view.nodes, view.pods), self.device)
        with self._lock:
            self.uploads += 1
            held = self._entries.get(view.provider.name)
            if held is None or held[0] < view.version:
                self._entries[view.provider.name] = (view.version, fleet)
        return fleet

    def _current(self, view: FleetView) -> FleetArrays | None:
        with self._lock:
            entry = self._entries.get(view.provider.name)
        return entry[1] if entry is not None and entry[0] == view.version else None

    def fleet_for(self, view: FleetView) -> FleetArrays:
        """The columnar fleet for ``view`` — device-resident from cache
        when the version matches, freshly encoded (and uploaded and
        cached when the view carries a version) otherwise. Annotates the
        enclosing span (the rollup's) with the outcome."""
        if view.version is None:
            from ..analytics.encode import encode_fleet

            self._count(hit=False)
            _annotate(fleet_cache="unversioned")
            return encode_fleet(view.nodes, view.pods)
        fleet = self._current(view)
        self._count(hit=fleet is not None)
        _annotate(fleet_cache="miss" if fleet is None else "hit")
        return fleet if fleet is not None else self._upload(view)

    def warm(self, view: FleetView) -> bool:
        """Encode + upload ``view`` now so the next request hits warm: the
        background sync's hook, run off the request path for each new
        snapshot version. Returns True when an upload happened, False
        when the entry was already current or the view is unversioned."""
        if view.version is None or self._current(view) is not None:
            return False
        self._upload(view)
        return True

    def seed(self, provider: str, version: int, fleet: FleetArrays) -> None:
        """Copy columns that arrived already encoded to this cache's device
        and install them for ``(provider, version)``, with no encode: a
        worker that read a published segment holds the packed columns, so
        the first render of that generation must not pay the per-node
        encode loop. Installed over an older version (or none), or over an
        equal one that a racing request encoded from the same snapshot; a
        newer entry stays. An upload that raises propagates and installs
        nothing: host columns never stand in for device ones (JAX installs
        its host arrays when the upload fails, `device_cache.py:173-177`)."""
        version = int(version)
        with _span("device_cache.seed", nodes=int(fleet.n_nodes)):
            on_device = _to_device(fleet, self.device)
        with self._lock:
            self.seeds += 1
            held = self._entries.get(provider)
            if held is None or held[0] <= version:
                self._entries[provider] = (version, on_device)

    def invalidate(self) -> None:
        """Drop every entry (frees the device columns)."""
        with self._lock:
            self._entries.clear()

    def counters(self) -> dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses, "uploads": self.uploads}

    def snapshot(self) -> dict[str, Any]:
        """The /healthz block."""
        with self._lock:
            entries = {name: version for name, (version, _f) in self._entries.items()}
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "uploads": self.uploads,
                "seeds": self.seeds,
                "hit_rate": round(self.hits / total, 4) if total else 0.0,
                "entries": entries,
                "device": str(self.device),
            }


class RollupResultCache:
    """Host rollup dicts the fused rollup+forecast already computed
    (``models/service.py``), keyed ``(provider, snapshot version)`` with
    one entry per provider: the invalidation contract of
    :class:`DeviceFleetCache`, so a parked result never serves a newer
    fleet. The overview's ``fleet_stats`` for the same snapshot then
    serves the parked dict with no device work and no copy. Entries are
    stored finalized (``rollup_host_view``) and handed out as copies, so
    a caller's ``generation_counts`` override cannot reach the cache.

    One per data context, beside its :class:`DeviceFleetCache`, where
    JAX keeps one for the process: a version is a context's own counter,
    so a process-wide cache would serve one context's rollup to
    another's equal version (JAX's fleet-cache collision)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: dict[str, tuple[int, dict]] = {}
        self.hits = 0
        self.lookups = 0

    def store(self, provider: str, version: int, stats: dict) -> None:
        with self._lock:
            self._entries[provider] = (version, dict(stats))

    def get(self, provider: str, version: int | None) -> dict | None:
        if version is None:
            return None
        with self._lock:
            self.lookups += 1
            entry = self._entries.get(provider)
            if entry is None or entry[0] != version:
                return None
            self.hits += 1
            return dict(entry[1])

    def invalidate(self) -> None:
        with self._lock:
            self._entries.clear()

    def counters(self) -> dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "lookups": self.lookups}


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

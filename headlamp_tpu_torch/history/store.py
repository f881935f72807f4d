"""Bounded columnar history store: the capture half of the history tier.

The port's copy of ``headlamp_tpu/history/store.py``. One
:class:`HistoryStore` holds a map of per-series ring-buffer shards. Each
shard is two preallocated host columns, ``float32`` values and
``float64`` monotonic stamps (``array.array``): scrapes arrive one row at
a time from the host, and the float32 ring is what keeps the trend
page's bytes equal to the JAX package's. Appending is an index write plus
a ring-head bump. Everything is bounded up front: a shard never grows
past its capacity (overwrites count as evictions) and the shard map never
grows past ``max_shards`` (the least-recently-appended shard is dropped,
counted), so a soak can run for weeks without the history tier becoming
the leak.

Who writes: the metrics refresher's ``on_store`` hook (every successful
scrape, on the refit path, off the request's critical path) and the
cluster-sync loop (one row per snapshot). Who reads: the ``/tpu/trends``
page (:meth:`HistoryStore.trend_view`, whose per-series statistics run as
one batched program on the store's device, ``analytics.trends``), the
forecaster (:meth:`HistoryStore.utilization_history`: real history in
place of a range query once one training window has accumulated),
``/healthz`` (:meth:`snapshot`), ``/metricsz`` (the gauges below) and the
counter view (:meth:`counters`).

Locally measured durations (the scrape's own fetch time, the SLO
engine's mirror of the paint latencies, the profiler's per-sample
overhead) pass the ``capture_timings`` gate, so a replay harness can
drop them wholesale: a timing read on the replaying host is noise that
would break byte parity between two runs of one recording. A series may
reserve a ring longer than the default (:meth:`HistoryStore.reserve`):
the SLO engine's mirror holds as many points as the engine's own series.

Clock discipline: stamps are injected monotonic readings; retention and
window math never touch the wall clock. Wall time enters only where a
caller hands one in (``utilization_history(clock=...)`` stamps the
output's display ``end``).
"""

from __future__ import annotations

import array
import threading
import time
import weakref
from typing import Any, Callable, Iterable

import torch

from ..device import DeviceLike, resolve_device
from ..obs.metrics import registry as _metrics_registry

#: Points each shard retains. 288 points at a 60 s scrape cadence is
#: 4.8 h; a faster cadence trades span for resolution in the same memory.
SHARD_CAPACITY = 288
#: Oldest age served by windowed reads (6 h). Older points still sit in
#: the ring until overwritten; reads filter them out.
RETENTION_S = 6 * 3600.0
#: Shard-map bound: 1024 nodes x 4 chips x 2 per-chip metrics plus the
#: fleet and sync aggregate series fit with headroom. Past it, the
#: least-recently-appended shard is evicted (counted, never silent).
MAX_SHARDS = 8704

# Counters dual-account with the per-store ints (the same transition
# writes both): the registry is the process view, the ints the /healthz
# and test view.
_POINTS_TOTAL = _metrics_registry.counter(
    "headlamp_tpu_torch_history_points_total",
    "Samples appended to the in-process history tier.",
)
_EVICTED_TOTAL = _metrics_registry.counter(
    "headlamp_tpu_torch_history_evicted_total",
    "History samples dropped by the memory bound (ring overwrites plus "
    "points lost with evicted shards).",
)


class _Shard:
    """One series: fixed-capacity float32 value / float64 monotonic-stamp
    ring columns. Mutated only under the owning store's lock."""

    __slots__ = ("capacity", "values", "stamps", "size", "head", "last_mono")

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self.values = array.array("f", bytes(4 * capacity))
        self.stamps = array.array("d", bytes(8 * capacity))
        self.size = 0
        self.head = 0  # next write slot
        self.last_mono = float("-inf")

    def append(self, mono: float, value: float) -> int:
        """Write one point; returns how many points were overwritten."""
        evicted = 1 if self.size == self.capacity else 0
        self.values[self.head] = value
        self.stamps[self.head] = mono
        self.head = (self.head + 1) % self.capacity
        if self.size < self.capacity:
            self.size += 1
        self.last_mono = mono
        return evicted

    def ordered(self) -> tuple[array.array, array.array]:
        """(stamps, values) oldest to newest, as fresh arrays (two
        C-level slice copies, no per-point Python loop)."""
        if self.size < self.capacity:
            return self.stamps[: self.size], self.values[: self.size]
        return (
            self.stamps[self.head :] + self.stamps[: self.head],
            self.values[self.head :] + self.values[: self.head],
        )

    def oldest_mono(self) -> float:
        if self.size == 0:
            return float("inf")
        if self.size < self.capacity:
            return self.stamps[0]
        return self.stamps[self.head]

    def memory_bytes(self) -> int:
        return 4 * self.capacity + 8 * self.capacity


class HistoryStore:
    """Bounded in-process history tier. One plain lock guards the shard
    map, taken once per batch (a scrape appends every chip row under a
    single acquisition); the counter view reads ints without it.

    ``device`` is where :meth:`trend_view` computes its per-series
    statistics: CUDA unless the caller asks for ``"cpu"``; without CUDA
    the constructor raises."""

    def __init__(
        self,
        *,
        shard_capacity: int = SHARD_CAPACITY,
        retention_s: float = RETENTION_S,
        max_shards: int = MAX_SHARDS,
        monotonic: Callable[[], float] | None = None,
        device: DeviceLike = None,
    ) -> None:
        if shard_capacity < 2:
            raise ValueError("shard_capacity must be >= 2")
        self.device = resolve_device(device)
        self.shard_capacity = shard_capacity
        self.retention_s = retention_s
        self.max_shards = max_shards
        self._monotonic = monotonic or time.monotonic
        #: False drops every locally measured timing row (``fleet.scrape_ms``
        #: and :meth:`record_timing`): a replay harness sets it so two
        #: runs of one recording stay byte-identical.
        self.capture_timings = True
        self._lock = threading.Lock()
        self._shards: dict[tuple[str, tuple[str, ...]], _Shard] = {}
        #: Ring length per metric where it differs from shard_capacity.
        self._capacity: dict[str, int] = {}
        # Monotone ints (the counter view; registry counters mirror the
        # same transitions).
        self.points = 0
        self.points_evicted = 0
        self.shards_evicted = 0
        self.scrapes = 0
        self.syncs = 0

    # -- write path ------------------------------------------------------

    def append(self, metric: str, value: float, *, labels: Iterable[str] = ()) -> None:
        self.append_many(((metric, tuple(labels), value),))

    def append_many(self, rows: Iterable[tuple[str, tuple[str, ...], float]]) -> int:
        """Append a batch of ``(metric, labels, value)`` rows stamped at
        one monotonic instant (a scrape is one instant: per-chip rows
        must land on the same grid point). Returns rows appended."""
        now = self._monotonic()
        appended = 0
        overwritten = 0
        dropped = 0
        with self._lock:
            for metric, labels, value in rows:
                key = (metric, labels)
                shard = self._shards.get(key)
                created = shard is None
                if created:
                    capacity = self._capacity.get(metric, self.shard_capacity)
                    shard = self._shards[key] = _Shard(capacity)
                overwritten += shard.append(now, float(value))
                appended += 1
                if created:
                    # Enforced after the first append: the new shard now
                    # carries a current stamp, so the LRU pick can never
                    # evict the series being written.
                    dropped += self._enforce_shard_bound_locked()
            self.points += appended
            self.points_evicted += overwritten + dropped
        if appended:
            _POINTS_TOTAL.inc(appended)
        if overwritten + dropped:
            _EVICTED_TOTAL.inc(overwritten + dropped)
        return appended

    def reserve(self, metric: str, capacity: int) -> None:
        """Give every new series of ``metric`` a ring of ``capacity``
        points in place of ``shard_capacity`` (a series already created
        keeps its ring)."""
        if capacity < 2:
            raise ValueError("capacity must be >= 2")
        with self._lock:
            self._capacity[metric] = int(capacity)

    def _enforce_shard_bound_locked(self) -> int:
        """Drop least-recently-appended shards past ``max_shards``;
        returns live points lost. Caller holds the lock."""
        dropped = 0
        while len(self._shards) > self.max_shards:
            victim = min(self._shards, key=lambda k: self._shards[k].last_mono)
            dropped += self._shards[victim].size
            del self._shards[victim]
            self.shards_evicted += 1
        return dropped

    # -- capture adapters ------------------------------------------------

    def record_scrape(self, snapshot: Any) -> int:
        """Capture one successful TPU metrics scrape
        (``TpuMetricsSnapshot``): per-chip utilization and duty-cycle
        shards plus fleet aggregates, all on one grid stamp. Returns rows
        appended; a snapshot without chips is worth 0 rows, never an
        exception (capture must not break serving)."""
        try:
            chips = snapshot.chips
        except AttributeError:
            return 0
        rows: list[tuple[str, tuple[str, ...], float]] = []
        util_sum, util_n = 0.0, 0
        for chip in chips:
            chip_key = (str(chip.node), str(chip.accelerator_id))
            util = chip.tensorcore_utilization
            if util is not None:
                rows.append(("chip.tensorcore_utilization", chip_key, util))
                util_sum += util
                util_n += 1
            duty = chip.duty_cycle
            if duty is not None:
                rows.append(("chip.duty_cycle", chip_key, duty))
        rows.append(("fleet.chips_reporting", (), float(len(chips))))
        if util_n:
            rows.append(("fleet.mean_tensorcore_utilization", (), util_sum / util_n))
        fetch_ms = getattr(snapshot, "fetch_ms", None)
        if fetch_ms is not None and self.capture_timings:
            rows.append(("fleet.scrape_ms", (), float(fetch_ms)))
        appended = self.append_many(rows)
        self.scrapes += 1
        return appended

    def record_timing(self, metric: str, value: float, *, labels: Iterable[str] = ()) -> bool:
        """Capture one locally measured duration or overhead, through the
        ``capture_timings`` gate. Returns whether the row was captured."""
        if not self.capture_timings:
            return False
        self.append(metric, float(value), labels=labels)
        return True

    def record_sync(self, *, generation: int, nodes: int, errors: int = 0) -> None:
        """Capture one cluster-sync snapshot generation."""
        self.append_many(
            (
                ("sync.generation", (), float(generation)),
                ("sync.nodes", (), float(nodes)),
                ("sync.errors", (), float(errors)),
            )
        )
        self.syncs += 1

    # -- read paths ------------------------------------------------------

    def series(
        self,
        metric: str,
        labels: Iterable[str] = (),
        *,
        window_s: float | None = None,
    ) -> tuple[list[float], list[float]]:
        """(ages_s, values) oldest to newest for one series, windowed to
        ``window_s`` (default: full retention). Ages are seconds before
        "now" on the injected monotonic clock."""
        now = self._monotonic()
        cutoff = now - min(self.retention_s, window_s if window_s is not None else self.retention_s)
        with self._lock:
            shard = self._shards.get((metric, tuple(labels)))
            if shard is None:
                return [], []
            stamps, values = shard.ordered()
        ages: list[float] = []
        vals: list[float] = []
        for stamp, value in zip(stamps, values):
            if stamp >= cutoff:
                ages.append(now - stamp)
                vals.append(value)
        return ages, vals

    def window_arrays(
        self,
        metric: str,
        labels: Iterable[str] = (),
        *,
        window_s: float | None = None,
        device: DeviceLike = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(ages, values) as float32 tensors on ``device`` (CUDA unless
        the caller asks for ``"cpu"``), so analytics and models consume
        history without a Python-loop copy."""
        dev = resolve_device(device)
        ages, vals = self.series(metric, labels, window_s=window_s)
        return (
            torch.tensor(ages, dtype=torch.float32, device=dev),
            torch.tensor(vals, dtype=torch.float32, device=dev),
        )

    def utilization_history(
        self,
        *,
        clock: Callable[[], float],
        min_points: int,
        max_chips: int = 256,
    ) -> Any | None:
        """The forecaster's input, built from captured per-chip
        utilization instead of a live range query: a
        ``UtilizationHistory`` when at least one chip shard holds
        ``min_points`` retained points, else None (the caller falls back
        to the live window: the store must fill one training window
        before it may claim to be the data source). ``clock`` (wall)
        stamps only the output's display ``end``; alignment runs on the
        scrape grid itself, since every chip row of one scrape shares one
        monotonic stamp."""
        from ..metrics.client import UtilizationHistory

        now = self._monotonic()
        cutoff = now - self.retention_s
        picked: list[tuple[tuple[str, str], list[float], list[float]]] = []
        with self._lock:
            for (metric, labels), shard in self._shards.items():
                if metric != "chip.tensorcore_utilization" or len(labels) != 2:
                    continue
                if shard.size < min_points:
                    continue
                stamps, values = shard.ordered()
                if stamps[-min_points] < cutoff:
                    continue  # the window would reach past retention
                picked.append(
                    (
                        (labels[0], labels[1]),
                        stamps[-min_points:].tolist(),
                        values[-min_points:].tolist(),
                    )
                )
                if len(picked) >= max_chips:
                    break
        if not picked:
            return None
        picked.sort(key=lambda row: row[0])
        stamps = picked[0][1]
        deltas = [b - a for a, b in zip(stamps, stamps[1:])]
        deltas = [d for d in deltas if d > 0]
        step_s = max(1, round(sorted(deltas)[len(deltas) // 2])) if deltas else 1
        return UtilizationHistory(
            keys=[key for key, _, _ in picked],
            series=[values for _, _, values in picked],
            step_s=step_s,
            end=clock(),
            resolved_query="history:chip.tensorcore_utilization",
        )

    def trend_view(
        self,
        *,
        window_s: float,
        max_series_per_metric: int = 8,
        metric: str = "",
        series_cursor: str | None = None,
        series_limit: int | None = None,
    ) -> dict[str, Any]:
        """Page-ready view for ``/tpu/trends``: per-metric groups of
        windowed series with stats, plus the store's own health numbers.
        Plain data; the page is a pure function of this dict.

        Two passes, so the page path is O(shards + rendered points): a
        cheap scan picks each metric's busiest ``max_series_per_metric``
        series by newest value (stamps only grow, so a shard has
        in-window points iff its newest stamp does), then only the
        winners materialize points. Their statistics come out of one
        batched program on the store's device with one copy back
        (``series_stats_batch``); an error there propagates.

        With ``metric`` set the view is the browse mode instead: a
        label-sorted cursor window over every in-window series of that
        one metric, so nothing the grouped view's busiest-N cap hides is
        unreachable."""
        from ..analytics.trends import series_stats_batch

        window_s = min(max(window_s, 1.0), self.retention_s)
        now = self._monotonic()
        cutoff = now - window_s
        candidates: dict[str, list[tuple[float, tuple[str, ...], _Shard]]] = {}
        with self._lock:
            for (m, labels), shard in self._shards.items():
                if shard.size == 0 or shard.last_mono < cutoff:
                    continue
                newest = shard.values[shard.head - 1]
                candidates.setdefault(m, []).append((newest, labels, shard))

        materialized: list[dict[str, Any]] = []

        def materialize(labels: tuple[str, ...], shard: _Shard) -> dict[str, Any] | None:
            with self._lock:
                stamps, values = shard.ordered()
            points = [(now - stamp, value) for stamp, value in zip(stamps, values) if stamp >= cutoff]
            if not points:
                return None  # evicted between the passes
            series = {"label": "/".join(labels) or "fleet", "points": points, "stats": None}
            materialized.append(series)
            return series

        def fill_stats() -> None:
            stats = series_stats_batch(
                [[v for _, v in s["points"]] for s in materialized], device=self.device
            )
            for series, row in zip(materialized, stats):
                series["stats"] = row

        if metric:
            from ..viewport.window import window_series

            rows = candidates.get(metric, [])
            pairs = [("/".join(labels) or "fleet", (labels, shard)) for _newest, labels, shard in rows]
            win = window_series(
                pairs,
                limit=series_limit if series_limit is not None else 64,
                cursor=series_cursor,
            )
            series = [s for labels, shard in win.rows if (s := materialize(labels, shard)) is not None]
            fill_stats()
            return {
                "window_s": window_s,
                "retention_s": self.retention_s,
                "groups": [],
                "browse": {"metric": metric, "series": series, "window": win},
                "store": self.snapshot(),
            }
        groups = []
        for group_metric in sorted(candidates):
            rows = candidates[group_metric]
            # Busiest series first; the cap keeps a 4096-chip fleet's
            # trend page a page, not a dump.
            rows.sort(key=lambda r: (-r[0], r[1]))
            series = [
                s
                for _newest, labels, shard in rows[:max_series_per_metric]
                if (s := materialize(labels, shard)) is not None
            ]
            if series:
                groups.append({"metric": group_metric, "series": series, "series_total": len(rows)})
        fill_stats()
        return {
            "window_s": window_s,
            "retention_s": self.retention_s,
            "groups": groups,
            "store": self.snapshot(),
        }

    # -- observability ---------------------------------------------------

    def memory_bytes(self) -> int:
        with self._lock:
            return sum(s.memory_bytes() for s in self._shards.values())

    def window_span_s(self) -> float:
        """Age of the oldest retained point: how far back a trend
        question can currently be answered."""
        now = self._monotonic()
        with self._lock:
            oldest = min((s.oldest_mono() for s in self._shards.values() if s.size), default=None)
        if oldest is None:
            return 0.0
        return min(max(now - oldest, 0.0), self.retention_s)

    def counters(self) -> dict[str, int]:
        """Monotone ints only, lock-free."""
        return {
            "points": self.points,
            "points_evicted": self.points_evicted,
            "shards_evicted": self.shards_evicted,
            "scrapes": self.scrapes,
            "syncs": self.syncs,
        }

    def snapshot(self) -> dict[str, Any]:
        """/healthz ``runtime.history`` block."""
        with self._lock:
            shards = len(self._shards)
        return {
            "points": self.points,
            "points_evicted": self.points_evicted,
            "shards": shards,
            "shards_evicted": self.shards_evicted,
            "scrapes": self.scrapes,
            "syncs": self.syncs,
            "memory_bytes": self.memory_bytes(),
            "window_span_s": round(self.window_span_s(), 3),
            "retention_s": self.retention_s,
        }


# ---------------------------------------------------------------------------
# Active-store gauges: the latest store a host wires is the one
# /metricsz describes; a dropped store is not kept alive by its gauges.
# ---------------------------------------------------------------------------

_ACTIVE: Any | None = None


def set_active_store(store: HistoryStore) -> None:
    global _ACTIVE
    _ACTIVE = weakref.ref(store)


def active_store() -> HistoryStore | None:
    return _ACTIVE() if _ACTIVE is not None else None


def _memory_sample() -> float | None:
    store = active_store()
    return float(store.memory_bytes()) if store is not None else None


def _span_sample() -> float | None:
    store = active_store()
    return float(store.window_span_s()) if store is not None else None


_metrics_registry.gauge_fn(
    "headlamp_tpu_torch_history_memory_bytes",
    "Bytes held by the history tier's ring columns (bounded by shard "
    "capacity x max shards).",
    _memory_sample,
)
_metrics_registry.gauge_fn(
    "headlamp_tpu_torch_history_window_span_seconds",
    "Age of the oldest retained history point: how far back /tpu/trends "
    "can currently answer.",
    _span_sample,
)

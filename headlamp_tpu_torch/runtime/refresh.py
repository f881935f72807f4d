"""Stale-while-revalidate keyed refresher.

The port's copy of ``headlamp_tpu/runtime/refresh.py``. A forecast fit
costs a cold request tens to hundreds of milliseconds; :class:`Refresher`
keeps that cost off every request but the first:

- **fresh** (``age <= ttl_s``): serve from cache, touch nothing.
- **stale** (``ttl_s < age <= grace_s``): serve the stale value at once
  and start exactly one background recompute (single flight per key and
  epoch); the next request after it lands sees fresh data.
- **cold / past grace / epoch bumped**: the only case that blocks, and
  concurrent requests for the same key join the one compute in flight.

Every age comparison runs on the injected ``monotonic``: tests drive
expiry by advancing a list cell, never by sleeping.

Failure policy: a foreground compute error propagates to every joined
waiter. A background refit error is absorbed, so the stale value keeps
serving until grace runs out, but it is counted in ``refit_errors`` and
its text kept in ``last_refit_error``: on the card a failed kernel build
or launch in a refit shows in ``/healthz`` instead of hiding behind the
stale page.

Background refits run on daemon threads, as in the reference, so a hung
fit never holds up interpreter exit; :meth:`drain` waits for every
compute in flight and joins every refit thread, which is how a server's
``close()`` ends with none left running.
"""

from __future__ import annotations

import contextvars
import threading
import time
from typing import Any, Callable, Hashable

from ..obs.metrics import registry as _metrics_registry
from ..obs.trace import span as _span

# Registry instruments (the ``refresher`` label tells the metrics cache
# from the forecast cache). The per-instance ints below are the
# /healthz and test view; both move on the same transitions.
_SERVED_FRESH = _metrics_registry.counter(
    "headlamp_tpu_torch_refresh_served_fresh_total",
    "Cache reads answered by a within-TTL value (no work scheduled).",
    labels=("refresher",),
)
_SERVED_STALE = _metrics_registry.counter(
    "headlamp_tpu_torch_refresh_served_stale_total",
    "Cache reads answered by a stale-but-in-grace value while a background refresh ran.",
    labels=("refresher",),
)
_REFITS = _metrics_registry.counter(
    "headlamp_tpu_torch_refresh_refits_total",
    "Recomputes executed (foreground cold fills and background refreshes).",
    labels=("refresher",),
)
_REFIT_ERRORS = _metrics_registry.counter(
    "headlamp_tpu_torch_refresh_refit_errors_total",
    "Recomputes that raised (foreground errors also reach their caller).",
    labels=("refresher",),
)
_DEMOTIONS = _metrics_registry.counter(
    "headlamp_tpu_torch_refresh_demotions_to_cold_total",
    "Warm-start fits demoted to cold refits (reported by the compute fn via note_demotion).",
    labels=("refresher",),
)
_FIT_HIST = _metrics_registry.histogram(
    "headlamp_tpu_torch_refresh_fit_duration_seconds",
    "Wall duration of refresher recomputes.",
    labels=("refresher",),
)


class _Flight:
    """One in-flight compute for a (key, epoch): late arrivals wait on
    ``done`` instead of recomputing."""

    __slots__ = ("done", "value", "error")

    def __init__(self) -> None:
        self.done = threading.Event()
        self.value: Any = None
        self.error: BaseException | None = None


class _Entry:
    __slots__ = ("value", "fetched_mono", "epoch")

    def __init__(self, value: Any, fetched_mono: float, epoch: int) -> None:
        self.value = value
        self.fetched_mono = fetched_mono
        self.epoch = epoch


class Refresher:
    """Keyed single-flight cache with a TTL (fresh) and a grace (stale
    but servable) window. ``compute`` callables always run outside the
    map lock, so a long fit never blocks readers of other keys or, within
    grace, of the same key."""

    def __init__(
        self,
        name: str,
        *,
        ttl_s: float,
        grace_s: float,
        monotonic: Callable[[], float] | None = None,
        max_entries: int = 8,
    ) -> None:
        if grace_s < ttl_s:
            raise ValueError("grace_s must be >= ttl_s (grace extends the TTL)")
        self.name = name
        self.ttl_s = ttl_s
        self.grace_s = grace_s
        self.max_entries = max_entries
        self._monotonic = monotonic or time.monotonic
        self._lock = threading.Lock()
        self._entries: dict[Hashable, _Entry] = {}
        self._flights: dict[tuple[Hashable, int], _Flight] = {}
        #: Background refit threads not yet joined by :meth:`drain`.
        self._threads: list[threading.Thread] = []
        self.served_fresh = 0
        self.served_stale = 0
        self.refits = 0
        self.refit_errors = 0
        #: ``"<ExceptionType>: <message>"`` of the last compute that
        #: raised, or None.
        self.last_refit_error: str | None = None
        self.demotions_to_cold = 0
        #: Called with (key, value) after every successful store, outside
        #: the map lock; a hook that raises never breaks the cache.
        self.on_store: Callable[[Hashable, Any], None] | None = None

    # -- read paths ------------------------------------------------------

    def _serve_cached_locked(
        self, key: Hashable, epoch: int, compute: Callable[[], Any], now: float
    ) -> tuple[bool, Any]:
        """(True, value) when a same-epoch entry within grace answers the
        read (a stale one also starts the background refit); (False,
        None) otherwise. Caller holds ``self._lock``."""
        entry = self._entries.get(key)
        if entry is None or entry.epoch != epoch:
            return False, None
        age = now - entry.fetched_mono
        if age <= self.ttl_s:
            self.served_fresh += 1
            _SERVED_FRESH.inc(refresher=self.name)
            return True, entry.value
        if age <= self.grace_s:
            self.served_stale += 1
            _SERVED_STALE.inc(refresher=self.name)
            self._spawn_refit_locked(key, epoch, compute)
            return True, entry.value
        return False, None

    def get(self, key: Hashable, compute: Callable[[], Any], *, epoch: int = 0) -> Any:
        """Value for ``key``, running or joining ``compute`` as needed.
        Blocks only when no same-epoch value within grace exists."""
        now = self._monotonic()
        with self._lock:
            hit, value = self._serve_cached_locked(key, epoch, compute, now)
            if hit:
                return value
            fkey = (key, epoch)
            flight = self._flights.get(fkey)
            leader = flight is None
            if leader:
                flight = self._flights[fkey] = _Flight()
        if leader:
            return self._foreground_fill(key, epoch, compute, flight)
        flight.done.wait()
        if flight.error is not None:
            raise flight.error
        return flight.value

    def get_nowait(
        self, key: Hashable, compute: Callable[[], Any], *, epoch: int = 0
    ) -> Any | None:
        """Non-blocking get: fresh and stale-within-grace values return at
        once (a stale one starts one background refresh, as in
        :meth:`get`); a cold, past-grace or epoch-bumped key starts the
        single-flight compute in the background and returns None."""
        now = self._monotonic()
        with self._lock:
            hit, value = self._serve_cached_locked(key, epoch, compute, now)
            if hit:
                return value
            self._spawn_refit_locked(key, epoch, compute)
            return None

    def peek(
        self, key: Hashable, *, epoch: int = 0, max_age_s: float | None = None
    ) -> Any | None:
        """The cached value if it matches ``epoch`` and is younger than
        ``max_age_s`` (default: the grace window), else None. Never
        computes."""
        limit = self.grace_s if max_age_s is None else max_age_s
        now = self._monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry.epoch != epoch or now - entry.fetched_mono > limit:
                return None
            return entry.value

    # -- compute paths ---------------------------------------------------

    def _spawn_refit_locked(
        self, key: Hashable, epoch: int, compute: Callable[[], Any]
    ) -> None:
        """Start the single-flight background compute for (key, epoch)
        unless one is already running. Caller holds ``self._lock``. The
        caller's contextvars are copied into the thread, so the refit's
        ``refresh.fit`` span attaches to the request that started it."""
        fkey = (key, epoch)
        if fkey in self._flights:
            return
        flight = self._flights[fkey] = _Flight()
        ctx = contextvars.copy_context()
        # Ended threads need no join; keep the list as long as the
        # refits still running.
        self._threads = [t for t in self._threads if t.is_alive()]
        thread = threading.Thread(
            target=ctx.run,
            args=(self._background_refit, key, epoch, compute, flight),
            name=f"refresh-{self.name}",
            daemon=True,
        )
        self._threads.append(thread)
        thread.start()

    def _run_compute(self, compute: Callable[[], Any]) -> Any:
        """The timed, traced recompute, shared by foreground and
        background so the histogram sees every fit."""
        t0 = time.perf_counter()
        try:
            with _span("refresh.fit", refresher=self.name):
                return compute()
        finally:
            _FIT_HIST.observe(time.perf_counter() - t0, refresher=self.name)

    def _store(self, key: Hashable, value: Any, epoch: int) -> None:
        with self._lock:
            self._entries[key] = _Entry(value, self._monotonic(), epoch)
            self.refits += 1
            while len(self._entries) > self.max_entries:
                oldest = min(self._entries, key=lambda k: self._entries[k].fetched_mono)
                del self._entries[oldest]
        _REFITS.inc(refresher=self.name)
        hook = self.on_store
        if hook is not None:
            try:
                hook(key, value)
            except Exception:  # noqa: BLE001 — an observer never breaks caching
                pass

    def _land(self, key: Hashable, epoch: int, flight: _Flight, value: Any) -> None:
        self._store(key, value, epoch)
        with self._lock:
            self._flights.pop((key, epoch), None)
        flight.value = value
        flight.done.set()

    def _fail(
        self, key: Hashable, epoch: int, flight: _Flight, exc: BaseException | None
    ) -> None:
        """Unwind a flight that raised. ``exc`` is None for an interrupt,
        which is not a refit error."""
        with self._lock:
            if exc is not None:
                self.refit_errors += 1
                self.last_refit_error = f"{type(exc).__name__}: {exc}"
            self._flights.pop((key, epoch), None)
        if exc is not None:
            _REFIT_ERRORS.inc(refresher=self.name)
        flight.done.set()

    def _foreground_fill(
        self, key: Hashable, epoch: int, compute: Callable[[], Any], flight: _Flight
    ) -> Any:
        try:
            value = self._run_compute(compute)
        except BaseException as exc:
            flight.error = exc
            self._fail(key, epoch, flight, exc)
            raise
        self._land(key, epoch, flight, value)
        return value

    def _background_refit(
        self, key: Hashable, epoch: int, compute: Callable[[], Any], flight: _Flight
    ) -> None:
        try:
            value = self._run_compute(compute)
        except Exception as exc:
            # Absorbed by design: the stale value keeps serving until
            # grace runs out, with the error counted and named.
            self._fail(key, epoch, flight, exc)
            return
        except BaseException:
            # KeyboardInterrupt/SystemExit: unwind the flight so waiters
            # do not hang, count nothing, and let it end the thread.
            self._fail(key, epoch, flight, None)
            raise
        self._land(key, epoch, flight, value)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Block until no compute is in flight and every background refit
        thread has ended, or ``timeout_s`` runs out (then False). For
        tests, benchmarks and a server's ``close()``; the serving path
        never calls it. Waits on real time: the injected monotonic only
        governs ages."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                flights = list(self._flights.values())
                threads = list(self._threads)
            if not flights and not threads:
                return True
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            if flights:
                flights[0].done.wait(min(remaining, 0.25))
                continue
            threads[0].join(remaining)
            # A refit spawned since the snapshot rebuilt the list without
            # its ended threads, so the joined one may be gone already:
            # prune by liveness under the lock, never remove by identity.
            with self._lock:
                self._threads = [t for t in self._threads if t.is_alive()]

    # -- observability ---------------------------------------------------

    def note_demotion(self) -> None:
        """Record a warm-to-cold demotion (the compute fn knows of it; the
        refresher owns the counters)."""
        with self._lock:
            self.demotions_to_cold += 1
        _DEMOTIONS.inc(refresher=self.name)

    def counters(self) -> dict[str, int]:
        """Monotone counters only."""
        with self._lock:
            return {
                "served_fresh": self.served_fresh,
                "served_stale": self.served_stale,
                "refits": self.refits,
                "refit_errors": self.refit_errors,
                "demotions_to_cold": self.demotions_to_cold,
            }

    def snapshot(self) -> dict[str, Any]:
        """The /healthz view: the counters, the last refit error's text
        and the number of cached entries."""
        counters = self.counters()
        with self._lock:
            return {
                **counters,
                "last_refit_error": self.last_refit_error,
                "entries": len(self._entries),
            }

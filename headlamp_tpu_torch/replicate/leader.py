"""Lease-based leader election with generation fencing.

The port's copy of ``headlamp_tpu/replicate/leader.py``. One leadership
term is one lease with one fencing token, a monotone integer the store
mints on every acquisition. The token fences the snapshot generation
band itself: a newly elected leader floors its context's generation
counter at ``fencing × GENERATION_STRIDE``, so every generation it
publishes carries its term in the high digits. A deposed leader's
publishes sit in a lower band and are rejected by the same generation
monotonicity that keys ETags, coalesce keys and push frames.

Every TTL comparison runs on the injected monotonic clock, so a test
drives acquire, expiry, takeover and a rejected stale publish with a
fake clock and no sleeps. The store is in memory (drills and one-host
supervisors); a distributed store needs the same four methods with
compare-and-swap semantics.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

from ..obs.metrics import registry as _metrics_registry

#: Lease duration: a failed leader is replaced within one TTL; renewal
#: ticks run at a fraction of it.
DEFAULT_LEASE_TTL_S = 15.0

#: Width of one term's generation band. Local generations count syncs,
#: so a term would need weeks of continuous syncing to overflow it.
GENERATION_STRIDE = 1_000_000

_FAILOVERS = _metrics_registry.counter(
    "headlamp_tpu_torch_replicate_failovers_total",
    "Leadership transitions observed: elections won, depositions noticed and "
    "resignations, by kind.",
    labels=("kind",),
)


@dataclass
class Lease:
    """One term: its holder, its fencing token and the monotonic instant
    it expires."""

    holder: str
    fencing: int
    expires_at: float

    def expired(self, now: float) -> bool:
        return now >= self.expires_at


class LeaseStore:
    """In-memory lease store with compare-and-swap semantics on the
    injected monotonic clock. :meth:`try_acquire` succeeds only on a free
    or expired lease and mints a strictly larger token; :meth:`renew`
    succeeds only for the lease currently held and unexpired, so a
    deposed leader renewing its old lease loses."""

    def __init__(self, *, monotonic: Callable[[], float] | None = None) -> None:
        self._mono = monotonic or time.monotonic
        self._lock = threading.Lock()
        self._lease: Lease | None = None
        self._fence = 0

    def try_acquire(self, holder: str, ttl_s: float = DEFAULT_LEASE_TTL_S) -> Lease | None:
        now = self._mono()
        with self._lock:
            current = self._lease
            if current is not None and not current.expired(now):
                return None
            self._fence += 1
            lease = Lease(holder=holder, fencing=self._fence, expires_at=now + ttl_s)
            self._lease = lease
            return lease

    def renew(self, lease: Lease, ttl_s: float = DEFAULT_LEASE_TTL_S) -> bool:
        now = self._mono()
        with self._lock:
            current = self._lease
            if current is None or current.fencing != lease.fencing:
                return False  # superseded: a newer term holds the lease
            if current.expired(now):
                return False  # the term lapsed before renewal
            current.expires_at = now + ttl_s
            return True

    def release(self, lease: Lease) -> bool:
        """Voluntary step-down: frees the lease, so a successor need not
        wait out the TTL."""
        with self._lock:
            current = self._lease
            if current is None or current.fencing != lease.fencing:
                return False
            self._lease = None
            return True

    def holder(self) -> Lease | None:
        """A copy of the current lease if live, else None (an expired
        lease reads as free)."""
        now = self._mono()
        with self._lock:
            current = self._lease
            if current is None or current.expired(now):
                return None
            return Lease(current.holder, current.fencing, current.expires_at)


class LeaderElector:
    """One node's part in the election: each :meth:`tick` renews the held
    lease or tries to acquire a free one, and calls ``on_elected(fencing)``
    or ``on_deposed()`` on a transition. The tick is the whole protocol:
    tests call it against a fake clock, a server calls :meth:`start` for
    a renewal thread. A callback that raises propagates out of
    :meth:`tick`, after the transition is recorded. An ``on_elected`` that
    raises also gives the term back, so the node never leads without the
    fencing and generation floor the callback sets, and the next tick
    acquires anew and runs it again. On the renewal thread a raising tick
    is counted in ``errors`` and named in ``last_error``; ``failing``
    holds until a tick passes, and the thread goes on electing."""

    def __init__(
        self,
        store: LeaseStore,
        node_id: str,
        *,
        ttl_s: float = DEFAULT_LEASE_TTL_S,
        monotonic: Callable[[], float] | None = None,
        on_elected: Callable[[int], None] | None = None,
        on_deposed: Callable[[], None] | None = None,
        ledger: Any = None,
    ) -> None:
        self.store = store
        self.node_id = node_id
        self.ttl_s = ttl_s
        self._mono = monotonic or time.monotonic
        self._on_elected = on_elected
        self._on_deposed = on_deposed
        #: Optional GenerationLedger: transitions land on the
        #: /debug/generationz timeline, where a failover explains a lag.
        self._ledger = ledger
        self._lease: Lease | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.elections = 0
        self.depositions = 0
        self.errors = 0
        self.last_error: str | None = None
        self.failing = False

    @property
    def is_leader(self) -> bool:
        lease = self._lease
        return lease is not None and not lease.expired(self._mono())

    @property
    def fencing(self) -> int:
        lease = self._lease
        return lease.fencing if lease is not None else 0

    def _deposed(self, kind: str, lease: Lease) -> None:
        self.depositions += 1
        _FAILOVERS.inc(kind=kind)
        if self._ledger is not None:
            self._ledger.note_transition(kind, fencing=lease.fencing)
        if self._on_deposed is not None:
            self._on_deposed()

    def tick(self) -> bool:
        """One protocol step; returns whether this node leads after it."""
        lease = self._lease
        if lease is not None:
            if self.store.renew(lease, self.ttl_s):
                return True
            # Superseded or lapsed. The lease drops before the callback,
            # so is_leader reads False inside it.
            self._lease = None
            self._deposed("deposed", lease)
        acquired = self.store.try_acquire(self.node_id, self.ttl_s)
        if acquired is None:
            return False
        self._lease = acquired
        self.elections += 1
        _FAILOVERS.inc(kind="elected")
        if self._ledger is not None:
            self._ledger.note_transition("elected", fencing=acquired.fencing)
        if self._on_elected is not None:
            try:
                self._on_elected(acquired.fencing)
            except BaseException:
                self.resign()
                raise
        return True

    def resign(self) -> None:
        """Voluntary step-down: release the lease (the successor skips
        the TTL wait) and report deposed."""
        lease = self._lease
        if lease is None:
            return
        self.store.release(lease)
        self._lease = None
        self._deposed("resigned", lease)

    # -- renewal thread ---------------------------------------------------

    def start(self) -> None:
        """Tick on a thread of its own every third of the TTL until
        :meth:`stop`."""
        if self._thread is not None:
            return
        interval = self.ttl_s / 3.0
        self._stop.clear()

        def renewal_loop() -> None:
            while not self._stop.is_set():
                try:
                    self.tick()
                    self.failing = False
                except Exception as e:  # noqa: BLE001 — counted, named in /healthz, ok false
                    self.errors += 1
                    self.last_error = f"{type(e).__name__}: {e}"
                    self.failing = True
                self._stop.wait(interval)

        thread = threading.Thread(
            target=renewal_loop, name="hl-torch-lease-renewal", daemon=True
        )
        self._thread = thread
        thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        """Stop the renewal thread and join it; raises TimeoutError if it
        outlives ``timeout_s``."""
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout_s)
            if thread.is_alive():
                raise TimeoutError(f"the lease renewal outlived {timeout_s} s")
            self._thread = None

    def snapshot(self) -> dict[str, Any]:
        lease = self._lease
        return {
            "node_id": self.node_id,
            "is_leader": self.is_leader,
            "fencing": self.fencing,
            "ttl_s": self.ttl_s,
            "elections": self.elections,
            "depositions": self.depositions,
            "errors": self.errors,
            "last_error": self.last_error,
            "failing": self.failing,
            "lease_remaining_s": (
                round(max(lease.expires_at - self._mono(), 0.0), 3)
                if lease is not None
                else None
            ),
        }


def generation_floor(fencing: int) -> int:
    """The first generation of a term's band: a new leader floors its
    context here, fencing out every earlier term."""
    return int(fencing) * GENERATION_STRIDE

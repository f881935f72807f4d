"""Burn-rate-driven load shedding.

The port's copy of ``headlamp_tpu/gateway/shed.py:43-208``. It acts on
the port's SLO engine (``obs/slo.py``): when a request-backed objective
pages,

- **debug traffic sheds**: /debug/* gets a fast 503 with Retry-After and
  a machine-readable body;
- **interactive traffic degrades, never sheds**: a page of a route the
  paging objective governs renders from caches only (the last published
  snapshot, ``Refresher.peek``, no forecast fit for a cold key), inside
  a contextvar scope the render worker enters around the handler;
- **ops traffic is untouched**: /metricsz, /sloz and /healthz are what
  an operator triages the incident with.

The engine's state is cached for ``ttl_s`` on the injected monotonic:
burn windows are minutes wide, and the gateway sits on every request.
:meth:`ShedPolicy.paging` is the push hub's shed check: the same
condition closes debug-class ``/events`` streams. A replica sets
:attr:`ShedPolicy.degraded_probe` to its stale-feed check: while the bus
is quiet every interactive render is degraded, whatever the burn rate.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Callable, Iterator

from ..obs import slo as slo_mod
from .pool import PRIORITY_DEBUG, PRIORITY_INTERACTIVE

#: True inside a render the gateway admitted degraded. Per request (it is
#: decided at admission and sealed into the coalesce key), so a render on
#: another worker thread never sees it.
_DEGRADED: ContextVar[bool] = ContextVar("headlamp_tpu_torch_gateway_degraded", default=False)


def degraded_active() -> bool:
    """Is the current render running in gateway-degraded mode?"""
    return _DEGRADED.get()


@contextmanager
def degraded_scope(active: bool = True) -> Iterator[None]:
    """Mark the enclosed render degraded (entered by the pool worker
    around the handler, so the flag travels with the render)."""
    token = _DEGRADED.set(active)
    try:
        yield
    finally:
        _DEGRADED.reset(token)


class Decision:
    """One admission ruling: shed, degrade or serve normally.
    ``burn_state`` is the engine's health block at decision time; it
    rides into the shed response's body."""

    __slots__ = ("shed", "degraded", "burn_state")

    def __init__(
        self, *, shed: bool = False, degraded: bool = False,
        burn_state: dict[str, str] | None = None,
    ) -> None:
        self.shed = shed
        self.degraded = degraded
        self.burn_state = burn_state or {}


class ShedPolicy:
    """Maps (route label, priority class) and the engine's state to a
    :class:`Decision`. ``engine`` is a zero-argument callable returning
    the SLO engine (by default ``obs.slo.engine``, so ``set_engine``
    re-points the gateway)."""

    def __init__(
        self,
        *,
        engine: Callable[[], Any] | None = None,
        ttl_s: float = 1.0,
        monotonic: Callable[[], float] | None = None,
    ) -> None:
        self._engine = engine or slo_mod.engine
        self.ttl_s = ttl_s
        self._monotonic = monotonic or time.monotonic
        #: A degrade condition beside the burn rate: a replica whose bus
        #: feed went quiet degrades every interactive render (the same
        #: cache-only reads and ``X-Headlamp-Stale: 1``). A probe that
        #: raises is counted in ``probe_errors`` and reads as stale: a
        #: feed nobody can vouch for is not fresh.
        self.degraded_probe: Callable[[], bool] | None = None
        self.probe_errors = 0
        self._cached_at: float | None = None
        self._cached_states: dict[str, str] = {}
        #: Route labels governed by a paging request-backed objective,
        #: refreshed with the states cache.
        self._paging_routes: set[str] = set()
        self.evaluations = 0
        #: Observers called as ``observer(kind, detail)`` on "shed",
        #: "degrade", "paging" and "restore": the seam an incident
        #: timeline reads. Their exceptions are counted, never raised.
        self.observers: list[Callable[[str, dict[str, Any]], None]] = []
        self.observer_events = 0
        self.observer_errors = 0

    def _notify(self, kind: str, **detail: Any) -> None:
        for observer in list(self.observers):
            self.observer_events += 1
            try:
                observer(kind, detail)
            except Exception:  # noqa: BLE001 — an observer must never fail a ruling
                self.observer_errors += 1

    def states(self) -> dict[str, str]:
        """The engine's health block, cached for ``ttl_s``. An engine that
        raises reads as all ok: the shed path never fails a request."""
        now = self._monotonic()
        if self._cached_at is not None and now - self._cached_at <= self.ttl_s:
            return self._cached_states
        previous = set(self._paging_routes)
        try:
            eng = self._engine()
            states = dict(eng.health_block())
            paging_routes: set[str] = set()
            for spec in getattr(eng, "specs", ()):
                if spec.latency_metric != slo_mod.REQUEST_DURATION:
                    continue
                if states.get(spec.name) != "page":
                    continue
                paging_routes.update(spec.latency_where.get("route", ()))
            self._paging_routes = paging_routes
        except Exception:  # noqa: BLE001 — the shed evaluation must never fail a request
            states = {}
            self._paging_routes = set()
        self.evaluations += 1
        self._cached_at = now
        self._cached_states = states
        # Regime transitions, at most one per ttl_s.
        if previous and not self._paging_routes:
            self._notify("restore", routes=sorted(previous))
        elif self._paging_routes and not previous:
            self._notify("paging", routes=sorted(self._paging_routes))
        return states

    def decide(self, route: str, priority: int) -> Decision:
        states = self.states()
        probe = self.degraded_probe
        if probe is not None and priority == PRIORITY_INTERACTIVE:
            try:
                stale = bool(probe())
            except Exception:  # noqa: BLE001 — counted; an unknown feed reads as stale
                self.probe_errors += 1
                stale = True
            if stale:
                # The data itself is stale, not one objective's routes.
                self._notify("degrade", route=route, reason="stale_feed")
                return Decision(degraded=True, burn_state=states)
        if not self._paging_routes:
            return Decision(burn_state=states)
        if priority == PRIORITY_DEBUG:
            # Any paging request-backed objective sheds debug traffic: the
            # overload is process-wide (one interpreter, one pool, one card).
            self._notify("shed", route=route, priority="debug")
            return Decision(shed=True, burn_state=states)
        if priority == PRIORITY_INTERACTIVE and route in self._paging_routes:
            # Only the routes the paging objective governs degrade.
            self._notify("degrade", route=route, reason="burn_rate")
            return Decision(degraded=True, burn_state=states)
        return Decision(burn_state=states)

    def paging(self) -> bool:
        """Is any request-backed objective paging now? The push hub's
        shed probe: the condition that sheds /debug requests also closes
        debug-class SSE streams. It rides the states() TTL cache, so
        long-lived streams can poll it freely."""
        self.states()
        return bool(self._paging_routes)

    def invalidate(self) -> None:
        """Drop the TTL cache (the next ruling re-reads the engine)."""
        self._cached_at = None

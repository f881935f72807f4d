"""RenderGateway: the admission layer between sockets and renders.

The port's copy of ``headlamp_tpu/gateway/gateway.py``. Every request
the socket server accepts goes through :meth:`RenderGateway.handle`
instead of calling ``DashboardApp.handle`` itself. The gateway composes
three policies:

1. **Bounded pool** (``pool.py``): renders run on a fixed worker set with
   strict priority (interactive > ops > debug), a queue depth per class,
   a concurrency cap per route and queue-wait deadlines.
2. **Burn-rate shedding** (``shed.py``): when a request-backed objective
   pages, debug traffic gets fast 503s and interactive traffic renders
   degraded (from caches only, no fit).
3. **Render coalescing** (``coalesce.py``): identical concurrent
   interactive requests share one render; followers receive the leader's
   bytes without holding a pool slot.

``/healthz`` bypasses all of it: liveness must answer while every worker
is busy.

SLO accounting, each request exactly once: the gateway's own 503s (shed,
queue full, expired, timeout) and its 304s count in
``headlamp_tpu_torch_requests_total`` and never in the duration
histogram. A coalesced follower counts with the leader's status and
observes its own wait as its duration when the status is below 500: a
follower is a served request and spends real budget.

The gateway holds callables (handle, route label, generation, epoch),
not the app, so tests drive it with fakes. It adopts the app's push
pipeline (:meth:`RenderGateway.attach_push`): its snapshot then counts
the SSE connections, which live in the hub and never in the render
pool, and the hub sheds debug-class streams off this gateway's policy.
An inbound ``traceparent`` rides into the render that answers it: the
coalescing leader's does, a follower's is dropped (its bytes came from a
render it did not cause). It is forwarded as a keyword only when present,
so handle callables without the parameter keep working; the gateway
never writes the header.
"""

from __future__ import annotations

import json
import time
import weakref
from typing import Any, Callable, ContextManager, NamedTuple
from urllib.parse import parse_qsl, urlparse

from ..obs import slo as slo_mod
from ..obs.metrics import registry as _metrics_registry
from ..push.conditional import count_not_modified, etag_for, if_none_match_matches, window_token
from .coalesce import Flight, RenderCoalescer
from .pool import (
    PRIORITY_DEBUG,
    PRIORITY_INTERACTIVE,
    PRIORITY_NAMES,
    PRIORITY_OPS,
    QueueFull,
    RenderPool,
)
from .shed import Decision, ShedPolicy, degraded_scope

#: Route labels of the ops class: the surfaces an operator triages an
#: incident with. Never shed, never coalesced, ahead of debug dumps.
OPS_ROUTES = frozenset({"/metricsz", "/sloz", "/sloz/html"})

#: Seconds a shed client should back off: burn windows are minutes wide.
RETRY_AFTER_S = 5

_REQUESTS = _metrics_registry.counter(
    "headlamp_tpu_torch_gateway_requests_total",
    "Requests through the render gateway, by priority class and outcome "
    "(rendered/coalesced/shed/queue_full/expired/timeout/bypass/failed/not_modified).",
    labels=("priority", "outcome"),
)
_SHED = _metrics_registry.counter(
    "headlamp_tpu_torch_gateway_shed_total",
    "Gateway 503s, by route template and reason "
    "(burn_rate/queue_full/queue_deadline/gateway_timeout).",
    labels=("route", "reason"),
)
_QUEUE_WAIT = _metrics_registry.histogram(
    "headlamp_tpu_torch_gateway_queue_wait_seconds",
    "Admission-to-execution wait in the render pool, by priority class.",
    labels=("priority",),
)

#: The serving gateway, for the queue gauges: a weak reference, so the
#: gauges follow the gateway actually serving.
_ACTIVE: weakref.ref | None = None


def set_active(gateway: RenderGateway | None) -> None:
    global _ACTIVE
    _ACTIVE = weakref.ref(gateway) if gateway is not None else None


def _active() -> RenderGateway | None:
    return _ACTIVE() if _ACTIVE is not None else None


def _queue_depth_samples() -> list[tuple[tuple[str], float]]:
    gw = _active()
    if gw is None:
        return []
    return [((name,), float(depth)) for name, depth in gw.pool.queue_depths().items()]


def _inflight_sample() -> float | None:
    gw = _active()
    return float(gw.pool.inflight()) if gw is not None else None


_metrics_registry.gauge_samples_fn(
    "headlamp_tpu_torch_gateway_queue_depth_count",
    "Jobs waiting in the render pool, by priority class.",
    ("priority",),
    _queue_depth_samples,
)
_metrics_registry.gauge_fn(
    "headlamp_tpu_torch_gateway_inflight_renders_count",
    "Renders currently executing on pool workers.",
    _inflight_sample,
)


class GatewayResponse(NamedTuple):
    """The app's (status, content type, body) plus response headers. A
    302 keeps the app's convention of the Location in ``content_type``."""

    status: int
    content_type: str
    body: str
    headers: tuple[tuple[str, str], ...] = ()


class RenderGateway:
    def __init__(
        self,
        handle: Callable[..., tuple[int, str, str]],
        *,
        route_label: Callable[[str], str],
        generation: Callable[[], int] | None = None,
        epoch: Callable[[], int] | None = None,
        engine: Callable[[], Any] | None = None,
        workers: int = 4,
        queue_depth: dict[int, int] | None = None,
        queue_deadline_s: dict[int, float] | None = None,
        route_limit: int | None = None,
        request_timeout_s: float = 30.0,
        shed_ttl_s: float = 1.0,
        monotonic: Callable[[], float] | None = None,
        worker_context: Callable[[], ContextManager[Any]] | None = None,
    ) -> None:
        self._handle = handle
        self._route_label = route_label
        self._generation = generation or (lambda: 0)
        self._epoch = epoch or (lambda: 0)
        self._monotonic = monotonic or time.monotonic
        self.request_timeout_s = request_timeout_s
        self.pool = RenderPool(
            workers=workers, queue_depth=queue_depth, queue_deadline_s=queue_deadline_s,
            route_limit=route_limit, monotonic=self._monotonic, worker_context=worker_context,
        )
        self.coalescer = RenderCoalescer()
        self.shed_policy = ShedPolicy(engine=engine, ttl_s=shed_ttl_s, monotonic=self._monotonic)
        # The host's request instruments (get-or-create), so the SLO
        # engine's observers see gateway 503s and follower waits.
        self._req_total = _metrics_registry.counter(
            slo_mod.REQUESTS_TOTAL, slo_mod.REQUESTS_TOTAL_HELP, labels=("route", "status")
        )
        self._req_hist = _metrics_registry.histogram(
            slo_mod.REQUEST_DURATION, slo_mod.REQUEST_DURATION_HELP, labels=("route",)
        )
        # Monotone per-instance counters (/healthz, flight-recorder deltas).
        self.admitted = 0
        self.rendered = 0
        self.coalesced_followers = 0
        self.shed_burn = 0
        self.shed_queue_full = 0
        self.expired = 0
        self.timeouts = 0
        self.degraded_renders = 0
        self.bypassed = 0
        self.not_modified = 0
        #: The app's push pipeline once attached (:meth:`attach_push`).
        self.push: Any = None

    # -- classification --------------------------------------------------

    @staticmethod
    def classify(route: str) -> int:
        """Priority class of a route label. Unknown routes ('other') ride
        interactive: they are cheap."""
        if route in OPS_ROUTES:
            return PRIORITY_OPS
        if route.startswith("/debug"):
            return PRIORITY_DEBUG
        return PRIORITY_INTERACTIVE

    def _coalesce_key(self, path: str, route: str, degraded: bool) -> tuple | None:
        """Single-flight key, or None when this request must not coalesce:
        /refresh has side effects (each click runs), and the ops and debug
        surfaces change per request and are cheap."""
        if route == "/refresh" or self.classify(route) != PRIORITY_INTERACTIVE:
            return None
        parsed = urlparse(path)
        query = tuple(sorted(parse_qsl(parsed.query, keep_blank_values=True)))
        return (parsed.path.rstrip("/") or "/tpu", query, self._generation(), self._epoch(), degraded)

    # -- responses -------------------------------------------------------

    def _page_headers(
        self, generation: int, degraded: bool, window: str = ""
    ) -> tuple[tuple[str, str], ...]:
        """A page's headers: the strong ETag, ``Cache-Control: no-cache``
        (intermediaries revalidate through the ETag), the generation and
        the stale badge of a degraded paint."""
        return (
            ("ETag", etag_for(generation, self._epoch(), degraded, window=window)),
            ("Cache-Control", "no-cache"),
            ("X-Headlamp-Generation", str(int(generation))),
            ("X-Headlamp-Stale", "1" if degraded else "0"),
        )

    def _shed_response(self, route: str, reason: str, burn_state: dict[str, str]) -> GatewayResponse:
        """The machine-readable overload 503: counted in requests_total
        (the engine's error feed), never in the duration histogram."""
        self._req_total.inc(route=route, status="503")
        _SHED.inc(route=route, reason=reason)
        body = json.dumps({
            "shed": reason != "gateway_timeout",
            "route": route,
            "reason": reason,
            "burn_state": burn_state,
            "retry_after_s": RETRY_AFTER_S,
        })
        return GatewayResponse(503, "application/json", body, (("Retry-After", str(RETRY_AFTER_S)),))

    # -- the request path ------------------------------------------------

    def handle(
        self,
        path: str,
        *,
        accept: str | None = None,
        if_none_match: str | None = None,
        traceparent: str | None = None,
    ) -> GatewayResponse:
        route = self._route_label(path)
        if route == "/healthz":
            # Liveness bypass: no queue, no shed, no coalescing.
            self.bypassed += 1
            _REQUESTS.inc(priority="ops", outcome="bypass")
            extra = dict(traceparent=traceparent) if traceparent else {}
            return GatewayResponse(*self._handle(path, accept=accept, **extra))
        priority = self.classify(route)
        pname = PRIORITY_NAMES[priority]
        decision = self.shed_policy.decide(route, priority)
        if decision.shed:
            self.shed_burn += 1
            _REQUESTS.inc(priority=pname, outcome="shed")
            return self._shed_response(route, "burn_rate", decision.burn_state)

        if if_none_match and priority == PRIORITY_INTERACTIVE and route != "/refresh":
            # The ETag holds the coalesce key's invariants: the same
            # generation, epoch, degraded flag and window mean a render
            # would reproduce the client's bytes, so answer 304 before
            # admission (requests_total once, no duration observation).
            generation = self._generation()
            window = window_token(path)
            etag = etag_for(generation, self._epoch(), decision.degraded, window=window)
            if if_none_match_matches(if_none_match, etag):
                self.not_modified += 1
                _REQUESTS.inc(priority=pname, outcome="not_modified")
                self._req_total.inc(route=route, status="304")
                count_not_modified(route)
                return GatewayResponse(
                    304, "text/html", "", self._page_headers(generation, decision.degraded, window)
                )

        key = self._coalesce_key(path, route, decision.degraded)
        if key is not None:
            flight, leader = self.coalescer.join_or_lead(key)
            if not leader:
                return self._follow(flight, route, pname, decision.burn_state)
            try:
                response = self._render(
                    path, route, priority, pname, accept, decision, traceparent=traceparent
                )
            except BaseException as exc:
                self.coalescer.finish(key, flight, error=exc)
                raise
            self.coalescer.finish(key, flight, result=response)
            return response
        return self._render(
            path, route, priority, pname, accept, decision, traceparent=traceparent
        )

    def _follow(
        self, flight: Flight, route: str, pname: str, burn_state: dict[str, str]
    ) -> GatewayResponse:
        """Wait for the leader's bytes. A follower counts with the leader's
        status and observes its own wait (below 500 only)."""
        t0 = self._monotonic()
        if not flight.done.wait(self.request_timeout_s) or (
            flight.error is not None or flight.result is None
        ):
            # Timed out, or the leader failed before publishing: an honest
            # 503 (the next request leads a fresh flight).
            self.timeouts += 1
            _REQUESTS.inc(priority=pname, outcome="timeout")
            return self._shed_response(route, "gateway_timeout", burn_state)
        response: GatewayResponse = flight.result
        self.coalesced_followers += 1
        _REQUESTS.inc(priority=pname, outcome="coalesced")
        self._req_total.inc(route=route, status=str(response.status))
        if response.status < 500:
            self._req_hist.observe(self._monotonic() - t0, route=route)
        return response

    def _render(
        self, path: str, route: str, priority: int, pname: str, accept: str | None,
        decision: Decision, *, traceparent: str | None = None,
    ) -> GatewayResponse:
        """Admit into the pool and wait. Every 503 here is the gateway's
        own: requests_total only (the handler never ran)."""
        degraded = bool(decision.degraded)
        admitted_mono = self._monotonic()

        def run() -> tuple[int, str, str]:
            wait_s = self._monotonic() - admitted_mono
            _QUEUE_WAIT.observe(wait_s, priority=pname)
            info = {"priority": pname, "queue_wait_ms": round(wait_s * 1e3, 3), "degraded": degraded}
            # Only the leader's traceparent reaches a render.
            extra = dict(traceparent=traceparent) if traceparent else {}
            with degraded_scope(degraded):
                return self._handle(path, accept=accept, gateway_info=info, **extra)

        try:
            job = self.pool.submit(route, priority, run)
        except QueueFull:
            self.shed_queue_full += 1
            _REQUESTS.inc(priority=pname, outcome="queue_full")
            return self._shed_response(route, "queue_full", decision.burn_state)
        self.admitted += 1
        if not job.done.wait(self.request_timeout_s):
            # The render runs on to its end; its result is dropped.
            self.timeouts += 1
            _REQUESTS.inc(priority=pname, outcome="timeout")
            return self._shed_response(route, "gateway_timeout", decision.burn_state)
        if job.outcome == "expired":
            self.expired += 1
            _REQUESTS.inc(priority=pname, outcome="expired")
            return self._shed_response(route, "queue_deadline", decision.burn_state)
        if job.outcome == "failed":
            # handle() answers its own errors with a 500 page, so a worker
            # failure is the gateway's plumbing: still one answer, one feed.
            _REQUESTS.inc(priority=pname, outcome="failed")
            self._req_total.inc(route=route, status="503")
            return GatewayResponse(503, "text/plain", f"gateway error: {type(job.error).__name__}")
        self.rendered += 1
        if degraded:
            self.degraded_renders += 1
        _REQUESTS.inc(priority=pname, outcome="rendered")
        response = GatewayResponse(*job.result)
        if priority == PRIORITY_INTERACTIVE and response.status == 200:
            # Stamped before the caller publishes the flight, so followers
            # inherit the headers: the ETag's fields are the key's own.
            response = response._replace(
                headers=response.headers
                + self._page_headers(self._generation(), degraded, window_token(path))
            )
        return response

    # -- observability and lifetime -------------------------------------

    def counters(self) -> dict[str, int]:
        """Monotone ints, read without a lock (flight-recorder deltas)."""
        out = {
            "admitted": self.admitted,
            "rendered": self.rendered,
            "coalesced_followers": self.coalesced_followers,
            "shed_burn": self.shed_burn,
            "shed_queue_full": self.shed_queue_full,
            "expired": self.expired,
            "timeouts": self.timeouts,
            "degraded_renders": self.degraded_renders,
            "bypassed": self.bypassed,
            "not_modified": self.not_modified,
        }
        for key, value in self.pool.counters().items():
            out[f"pool_{key}"] = value
        return out

    def snapshot(self) -> dict[str, Any]:
        """The /healthz ``runtime.gateway`` block: the counters, the live
        queue and in-flight gauges and the current burn states."""
        out: dict[str, Any] = dict(self.counters())
        out["queue_depth"] = self.pool.queue_depths()
        out["inflight_renders"] = self.pool.inflight()
        out["coalesce_inflight"] = self.coalescer.inflight()
        out["workers"] = self.pool.workers
        out["burn_state"] = self.shed_policy.states()
        if self.push is not None:
            # Streams live in the hub, not in the render pool: this line
            # is where an operator sees that separation.
            out["sse_connections"] = self.push.hub.connected()
        return out

    def attach_push(self, pipeline: Any) -> None:
        """Adopt the push pipeline: the snapshot gains the SSE connection
        count, and the hub's shed probe becomes this gateway's policy, so
        debug-class streams close under the same paging burn that sheds
        /debug requests."""
        self.push = pipeline
        pipeline.hub.set_shed_check(self.shed_policy.paging)

    def close(self, timeout_s: float = 30.0) -> bool:
        """Stop and join the pool's workers; False if one outlived
        ``timeout_s``."""
        return self.pool.close(timeout_s)


__all__ = ["GatewayResponse", "OPS_ROUTES", "RETRY_AFTER_S", "RenderGateway", "set_active"]

"""SSE broadcast hub.

The port's copy of ``headlamp_tpu/push/hub.py``. One fleet change is one
diff and N cheap frame writes. The hub owns the long-lived ``/events``
subscriptions: a bounded outbox per client (a consumer that stops
reading is evicted, never buffered without bound), heartbeats on the
injected monotonic clock, and ``Last-Event-ID`` resume against a bounded
per-page backlog, with a full-paint fallback when the client is too far
behind to replay honestly.

Subscriptions hold no render-pool worker: the socket server parks one
handler thread per connection in :meth:`BroadcastHub.next_event`'s
condition wait, and :meth:`BroadcastHub.publish` (called by the differ on
the sync path, off the request path) fans frames out as deque appends
and notifies.

Shedding: while a request-backed objective pages, the policy that 503s
``/debug`` requests also closes debug-class streams (a ``bye`` event
with reason ``shed``). Interactive streams stay: frames are the cheap
path, and closing them would send clients back to full-paint polling
exactly when the process is overloaded.

Wire format (Server-Sent Events)::

    id: g<generation>
    event: delta | paint
    data: <compact JSON>
    <blank line>

Heartbeats are comment frames (``: hb``): they keep intermediaries from
idling the connection out without advancing ``Last-Event-ID``, so a
resume after a quiet spell replays from the last real frame.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable

from ..obs.metrics import registry as _metrics_registry

#: Seconds between keep-alive comment frames on an idle stream. Under
#: common LB idle timeouts (60 s) with margin; overridable per app.
HEARTBEAT_S = 15.0

#: Events a client may have queued before it counts as a slow consumer
#: and is evicted. 64 frames is minutes of fleet churn — a reading
#: client drains in microseconds; only a stalled socket accumulates.
OUTBOX_LIMIT = 64

#: Per-page resume backlog (generations of frames kept for
#: ``Last-Event-ID`` replay). Past this, a resuming client gets the
#: full-paint fallback instead of a fabricated partial history.
BACKLOG_LIMIT = 32

_FRAMES = _metrics_registry.counter(
    "headlamp_tpu_torch_push_frames_total",
    "Delta/paint frames delivered to SSE subscribers, by page.",
    labels=("page",),
)
_BROADCASTS = _metrics_registry.counter(
    "headlamp_tpu_torch_push_broadcasts_total",
    "Generation broadcasts fanned out by the hub (one per fleet change "
    "that produced any frame).",
)
_HEARTBEATS = _metrics_registry.counter(
    "headlamp_tpu_torch_push_heartbeats_total",
    "Keep-alive comment frames sent on idle SSE streams.",
)
_EVICTIONS = _metrics_registry.counter(
    "headlamp_tpu_torch_push_evictions_total",
    "SSE subscriptions closed by the hub, by reason "
    "(slow_consumer/shed/shutdown).",
    labels=("reason",),
)
_RESUME_FALLBACKS = _metrics_registry.counter(
    "headlamp_tpu_torch_push_resume_fallbacks_total",
    "Last-Event-ID resumes answered with a full-paint fallback because "
    "the client was behind the retained backlog.",
)


class Subscription:
    """One connected SSE client. The condition serializes outbox access
    between the hub (publish/evict) and the connection's handler thread
    (poll/next_event); ``last_write_mono`` is when the stream last had
    bytes written, driving the heartbeat cadence."""

    __slots__ = (
        "pages",
        "priority",
        "outbox",
        "cond",
        "last_write_mono",
        "evicted_reason",
        "closed",
    )

    def __init__(self, pages: frozenset[str], priority: str, now: float) -> None:
        self.pages = pages
        self.priority = priority
        self.outbox: deque[dict[str, Any]] = deque()
        self.cond = threading.Condition()
        self.last_write_mono = now
        self.evicted_reason: str | None = None
        self.closed = False


#: Which serving process this is, as a short label ("w0", "w1", …), set
#: once at a worker process's entry (``workers/worker.py``); None in
#: single-process serving. Process-global on purpose: a worker process is
#: one identity, and the SSE handler and the push snapshot both stamp it.
_WORKER_IDENTITY: str | None = None


def set_worker_identity(label: str | None) -> None:
    """Install this process's worker label (a worker process calls it
    before its socket opens). None restores single-process behaviour."""
    global _WORKER_IDENTITY
    _WORKER_IDENTITY = label


def worker_identity() -> str | None:
    return _WORKER_IDENTITY


def parse_last_event_id(value: str | None) -> int | None:
    """``g<generation>`` → generation, else None (an unparseable id is
    ignored rather than 400d — the stream still serves live frames)."""
    if not value:
        return None
    value = value.strip()
    if not value.startswith("g"):
        return None
    try:
        return int(value[1:].split("-", 1)[0])
    except ValueError:
        return None


def format_event(event: dict[str, Any]) -> str:
    """One event dict → its SSE wire text (always blank-line
    terminated). ``data`` is compact single-line JSON, so no multi-line
    ``data:`` splitting is ever needed."""
    kind = event.get("kind")
    if kind == "heartbeat":
        return ": hb\n\n"
    lines = []
    if event.get("id"):
        lines.append(f"id: {event['id']}")
    lines.append(f"event: {kind}")
    data = json.dumps(event.get("data", {}), separators=(",", ":"), sort_keys=True)
    lines.append(f"data: {data}")
    return "\n".join(lines) + "\n\n"


class BroadcastHub:
    def __init__(
        self,
        *,
        monotonic: Callable[[], float] | None = None,
        heartbeat_s: float = HEARTBEAT_S,
        outbox_limit: int = OUTBOX_LIMIT,
        backlog_limit: int = BACKLOG_LIMIT,
        shed_check: Callable[[], bool] | None = None,
    ) -> None:
        self._mono = monotonic or time.monotonic
        self.heartbeat_s = heartbeat_s
        self.outbox_limit = outbox_limit
        self.backlog_limit = backlog_limit
        #: Zero-arg "is a request-backed SLO paging?" probe (wired to
        #: ShedPolicy.paging()). Checked on publish AND on poll ticks so
        #: debug streams close promptly even on a quiet fleet.
        self._shed_check = shed_check
        self._lock = threading.Lock()
        self._subs: set[Subscription] = set()
        #: Per-page (generation, frame) resume backlog.
        self._backlog: dict[str, deque[tuple[int, dict[str, Any]]]] = {}
        #: Oldest generation from which replay is COMPLETE: bumped past
        #: every backlog eviction, so resume never fabricates a partial
        #: history. None until the first publish.
        self._complete_from: int | None = None
        self._last_generation = 0
        # Monotone per-instance ints (healthz block + flight deltas; the
        # labeled registry counters are the fleet view).
        self.frames_sent = 0
        self.broadcasts = 0
        self.heartbeats = 0
        self.evictions = 0
        self.resume_fallbacks = 0
        self.subscribed_total = 0
        #: Eviction observers, called as ``observer(reason, detail)`` from
        #: the one eviction point, so an incident timeline sees every
        #: ``bye`` the moment it is queued. Nothing subscribes yet. They
        #: run while the subscription's condition is held, so they must be
        #: cheap and must not touch hub state; an observer that raises is
        #: counted, and never loses the ``bye`` frame.
        self.eviction_observers: list[Callable[[str, dict[str, Any]], None]] = []
        self.observer_errors = 0
        #: Set by :meth:`close`: a subscriber that arrives afterwards is
        #: evicted at once, so a server's close never waits on a stream
        #: its shutdown admitted late (the JAX hub has no such state).
        self._closed_reason: str | None = None

    def set_shed_check(self, shed_check: Callable[[], bool] | None) -> None:
        """(Re)wire the paging probe — called by the gateway when it
        adopts the pipeline, so the hub sheds off the SAME policy (and
        TTL cache) that 503s /debug requests."""
        self._shed_check = shed_check

    # -- subscription lifecycle ------------------------------------------

    def subscribe(
        self,
        pages: Iterable[str],
        *,
        last_event_id: str | None = None,
        priority: str = "interactive",
    ) -> Subscription:
        """Register a client. Resume events (replayed deltas, or the
        full-paint fallback) are pre-loaded into the outbox so the
        handler drains them through the same poll/next_event path as
        live frames."""
        sub = Subscription(frozenset(pages), priority, self._mono())
        replay = self._resume_events(sub, parse_last_event_id(last_event_id))
        with self._lock:
            self._subs.add(sub)
            self.subscribed_total += 1
            closed = self._closed_reason
        with sub.cond:
            sub.outbox.extend(replay)
            if closed is not None:
                self._evict_locked(sub, closed)
            elif replay:
                sub.cond.notify_all()
        return sub

    def _resume_events(
        self, sub: Subscription, last_gen: int | None
    ) -> list[dict[str, Any]]:
        if last_gen is None:
            return []
        with self._lock:
            current = self._last_generation
            if last_gen >= current and self._complete_from is not None:
                return []  # already caught up
            if self._complete_from is None or last_gen < self._complete_from - 1:
                # Too far behind (or a fresh process that retains no
                # backlog): replaying would fabricate history. Tell the
                # client to repaint each page instead.
                self.resume_fallbacks += 1
                _RESUME_FALLBACKS.inc()
                return [
                    {
                        "kind": "paint",
                        "id": f"g{current}",
                        "data": {
                            "page": page,
                            "generation": current,
                            "reason": "resync",
                        },
                    }
                    for page in sorted(sub.pages)
                ]
            events: list[dict[str, Any]] = []
            for page in sorted(sub.pages):
                for generation, frame in self._backlog.get(page, ()):
                    if generation > last_gen:
                        events.append(
                            {"kind": "delta", "id": f"g{generation}", "data": frame}
                        )
            events.sort(key=lambda e: parse_last_event_id(e["id"]) or 0)
            return events

    def unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            self._subs.discard(sub)
        with sub.cond:
            sub.closed = True
            sub.cond.notify_all()

    def connected(self) -> int:
        with self._lock:
            return len(self._subs)

    # -- fan-out ----------------------------------------------------------

    def publish(self, generation: int, frames: dict[str, dict[str, Any]]) -> int:
        """Fan one generation's frames out to every matching
        subscription. Returns deliveries (the bench's ``frame_writes``
        numerator). Cheap by construction: per delivery one deque
        append + one notify — the render/diff already happened, once."""
        self.shed_streams()
        with self._lock:
            self._last_generation = max(self._last_generation, int(generation))
            if frames and self._complete_from is None:
                self._complete_from = int(generation)
            for page, frame in frames.items():
                backlog = self._backlog.setdefault(page, deque())
                backlog.append((int(generation), frame))
                while len(backlog) > self.backlog_limit:
                    evicted_gen, _ = backlog.popleft()
                    if self._complete_from is None or self._complete_from <= evicted_gen:
                        self._complete_from = evicted_gen + 1
            if not frames:
                return 0
            subs = list(self._subs)
            self.broadcasts += 1
        _BROADCASTS.inc()
        delivered = 0
        for sub in subs:
            for page, frame in frames.items():
                if page not in sub.pages:
                    continue
                event = {"kind": "delta", "id": f"g{int(generation)}", "data": frame}
                if self._enqueue(sub, event):
                    delivered += 1
                    self.frames_sent += 1
                    _FRAMES.inc(page=page)
        return delivered

    def _enqueue(self, sub: Subscription, event: dict[str, Any]) -> bool:
        with sub.cond:
            if sub.closed or sub.evicted_reason is not None:
                return False
            if len(sub.outbox) >= self.outbox_limit:
                self._evict_locked(sub, "slow_consumer")
                return False
            sub.outbox.append(event)
            sub.cond.notify_all()
            return True

    def _evict_locked(self, sub: Subscription, reason: str) -> None:
        """Caller holds sub.cond. The outbox is replaced by a single
        ``bye`` so the handler writes one last honest frame ("you were
        evicted, repaint and reconnect") instead of a silent FIN."""
        sub.evicted_reason = reason
        sub.outbox.clear()
        sub.outbox.append(
            {"kind": "bye", "id": None, "data": {"reason": reason}}
        )
        sub.cond.notify_all()
        self.evictions += 1
        _EVICTIONS.inc(reason=reason)
        for observer in list(self.eviction_observers):
            try:
                observer(
                    reason,
                    {"priority": sub.priority, "pages": sorted(sub.pages)},
                )
            except Exception:  # noqa: BLE001 — observers must never lose a bye
                self.observer_errors += 1

    def shed_streams(self) -> int:
        """Close debug-class streams while a request-backed objective
        pages (the gateway's shed ruling, extended to long-lived
        connections). Interactive streams stay: frames are the cheap
        path, and closing them would send clients back to polling
        mid-incident."""
        if self._shed_check is None:
            return 0
        try:
            paging = bool(self._shed_check())
        except Exception:  # noqa: BLE001 — shed eval must never kill a stream
            paging = False
        if not paging:
            return 0
        with self._lock:
            debug_subs = [s for s in self._subs if s.priority == "debug"]
        shed = 0
        for sub in debug_subs:
            with sub.cond:
                if sub.evicted_reason is None and not sub.closed:
                    self._evict_locked(sub, "shed")
                    shed += 1
        return shed

    # -- consumption -------------------------------------------------------

    def poll(self, sub: Subscription) -> dict[str, Any] | None:
        """Non-blocking: the next queued event, else a heartbeat when
        one is due, else None. The test seam — with an injected clock
        this drives the whole wire protocol with zero real sleeps."""
        self.shed_streams()
        with sub.cond:
            return self._poll_locked(sub)

    def _poll_locked(self, sub: Subscription) -> dict[str, Any] | None:
        now = self._mono()
        if sub.outbox:
            sub.last_write_mono = now
            return sub.outbox.popleft()
        if now - sub.last_write_mono >= self.heartbeat_s:
            sub.last_write_mono = now
            self.heartbeats += 1
            _HEARTBEATS.inc()
            return {"kind": "heartbeat", "id": None, "data": {}}
        return None

    def next_event(
        self, sub: Subscription, *, max_wait_s: float | None = None
    ) -> dict[str, Any] | None:
        """Blocking companion of poll() for the socket handler thread:
        waits on the subscription's condition until a frame arrives or
        the heartbeat comes due. ``max_wait_s`` bounds the total wait
        (None → bounded by the heartbeat interval anyway)."""
        deadline = None if max_wait_s is None else self._mono() + max_wait_s
        while True:
            self.shed_streams()
            with sub.cond:
                event = self._poll_locked(sub)
                if event is not None:
                    return event
                if sub.closed:
                    return None
                now = self._mono()
                wait = self.heartbeat_s - (now - sub.last_write_mono)
                if deadline is not None:
                    if deadline - now <= 0:
                        return None
                    wait = min(wait, deadline - now)
                sub.cond.wait(max(wait, 0.005))

    # -- lifecycle / observability ----------------------------------------

    def close(self, reason: str = "shutdown") -> None:
        """Evict every subscription (server shutdown, bench teardown) —
        each parked handler thread wakes, writes the ``bye``, and
        exits."""
        with self._lock:
            self._closed_reason = reason
            subs = list(self._subs)
        for sub in subs:
            with sub.cond:
                if sub.evicted_reason is None and not sub.closed:
                    self._evict_locked(sub, reason)

    def counters(self) -> dict[str, int]:
        return {
            "frames_sent": self.frames_sent,
            "broadcasts": self.broadcasts,
            "heartbeats": self.heartbeats,
            "evictions": self.evictions,
            "resume_fallbacks": self.resume_fallbacks,
            "subscribed_total": self.subscribed_total,
        }

    def snapshot(self) -> dict[str, Any]:
        out: dict[str, Any] = dict(self.counters())
        with self._lock:
            out["connected"] = len(self._subs)
            out["last_generation"] = self._last_generation
            out["backlog_pages"] = {
                page: len(entries) for page, entries in self._backlog.items()
            }
            out["resume_complete_from"] = self._complete_from
        worker = worker_identity()
        if worker is not None:
            # Under multi-process serving the hub and its clients are
            # per worker: say which one this block is.
            out["worker"] = worker
        return out


__all__ = [
    "BACKLOG_LIMIT",
    "BroadcastHub",
    "HEARTBEAT_S",
    "OUTBOX_LIMIT",
    "Subscription",
    "format_event",
    "parse_last_event_id",
    "set_worker_identity",
    "worker_identity",
]

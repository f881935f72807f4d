"""Keep-alive connection pool and RTT-aware fan-out scheduling.

The port's copy of ``headlamp_tpu/transport/pool.py:134-668``. A
scrape→paint is round-trip bound, and a fresh TCP (and TLS) handshake
per Kubernetes or Prometheus call pays one more round trip each time:

- :class:`ConnectionPool` — per-host keep-alive ``http.client``
  connections with a bounded concurrent-checkout cap, LRU idle eviction,
  and stale-socket detection with one transparent retry. Every open,
  reuse and eviction is counted twice, in per-pool ints (``/healthz``)
  and in the process registry (``/metricsz``); each connect's latency
  feeds ``headlamp_tpu_torch_transport_connect_latency_seconds``, the
  ``transport_connect`` objective's feed; ``transport.connect`` and
  ``transport.reuse`` spans land in the request's trace.
- :class:`FanoutScheduler` — a fan-out whose width is chosen from the
  pool's measured RTT statistics: idle pooled sockets are free
  concurrency, and each socket beyond them must save more serial
  round-trip time than its connect costs. Without a pool
  (``MockTransport``) it is a fixed-width map.

:meth:`ConnectionPool.request` is the one place in the port that writes
the outbound ``traceparent`` header (``obs/propagate.py``), so a call made
inside a trace joins the trace its peer opens.
"""

from __future__ import annotations

import contextvars
import http.client
import ssl
import threading
import time
import weakref
from typing import Any, Callable, Iterator, Sequence, TypeVar
from urllib.parse import urlsplit

from ..obs import slo as slo_mod
from ..obs.metrics import registry as _metrics_registry
from ..obs.propagate import TRACEPARENT_HEADER, current_traceparent, record_injected
from ..obs.trace import span as _span

#: Concurrent checked-out connections per host: one full-width fan-out
#: never queues, and no caller can open a socket flood at the apiserver.
DEFAULT_MAX_PER_HOST = 8

#: Idle keep-alive lifetime: the pool, not the peer, decides when a
#: socket dies, which keeps the stale-retry path rare.
DEFAULT_IDLE_TTL_S = 60.0

#: EWMA smoothing of the connect and request RTT estimates the width
#: choice reads (about the last five observations dominate).
EWMA_ALPHA = 0.3

_T = TypeVar("_T")
_R = TypeVar("_R")

#: Failures of a kept-alive socket the peer already closed: the
#: retry-once set. A refused connect, DNS or TLS failure fails on a fresh
#: socket too and is never retried into a double send.
_STALE_ERRORS = (
    http.client.RemoteDisconnected,
    http.client.CannotSendRequest,
    http.client.ResponseNotReady,
    BrokenPipeError,
    ConnectionResetError,
    ConnectionAbortedError,
)

# Registry instruments (get-or-create: many pools per process share one
# set), written on the same transitions as the per-pool ints.
_OPENED = _metrics_registry.counter(
    "headlamp_tpu_torch_transport_connections_opened_total",
    "TCP(+TLS) connections the transport pool opened, per host.",
    labels=("host",),
)
_REUSED = _metrics_registry.counter(
    "headlamp_tpu_torch_transport_connections_reused_total",
    "Requests served over an already-open pooled connection, per host.",
    labels=("host",),
)
_EVICTED = _metrics_registry.counter(
    "headlamp_tpu_torch_transport_idle_evicted_total",
    "Idle pooled connections closed by TTL expiry or idle-slot overflow.",
)
_STALE_RETRIES = _metrics_registry.counter(
    slo_mod.STALE_RETRIES,
    "Requests retried on a fresh connection after a kept-alive socket turned out closed.",
)
_CONNECT_HIST = _metrics_registry.histogram(
    slo_mod.CONNECT_LATENCY,
    "TCP(+TLS) connection establishment latency, per host.",
    labels=("host",),
)
_CONNECT_FAILED = _metrics_registry.counter(
    slo_mod.CONNECT_FAILURES,
    "TCP(+TLS) connection attempts that raised before a socket was established, per host.",
    labels=("host",),
)

#: Live pools, for the process-wide pool-size gauge.
_LIVE_POOLS: weakref.WeakSet[ConnectionPool] = weakref.WeakSet()

_metrics_registry.gauge_fn(
    "headlamp_tpu_torch_transport_pool_connections_count",
    "Open pooled connections (idle and checked out) across live pools.",
    lambda: float(sum(p.open_connections for p in list(_LIVE_POOLS))),
)


class PoolExhausted(Exception):
    """A checkout blocked past its budget: every slot of the host stayed
    checked out. Local saturation, not a server failure."""


class _PooledConn:
    """One keep-alive connection, its host key and its idle stamp."""

    __slots__ = ("raw", "key", "idle_since")

    def __init__(self, raw: http.client.HTTPConnection, key: tuple) -> None:
        self.raw = raw
        self.key = key
        self.idle_since = 0.0


class _HostSlot:
    """Per-(scheme, host, port) state: the idle stack (most recently
    returned on top), the checkout semaphore and the open count."""

    __slots__ = ("idle", "sem", "open_count", "lock")

    def __init__(self, max_per_host: int) -> None:
        self.idle: list[_PooledConn] = []
        self.sem = threading.BoundedSemaphore(max_per_host)
        self.open_count = 0
        self.lock = threading.Lock()


class PooledResponse:
    """A response whose connection returns to the pool on close.

    The connection goes back only when the body was read to its end and
    the server did not ask to close; anything else discards the socket.
    ``close`` is idempotent and always releases the checkout slot, on the
    non-2xx paths too."""

    def __init__(
        self, pool: ConnectionPool, conn: _PooledConn, resp: http.client.HTTPResponse
    ) -> None:
        self._pool = pool
        self._conn = conn
        self._resp = resp
        self._closed = False

    @property
    def status(self) -> int:
        return self._resp.status

    def read(self) -> bytes:
        return self._resp.read()

    def __iter__(self) -> Iterator[bytes]:
        return iter(self._resp)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        reusable = self._resp.isclosed() and not self._resp.will_close
        if not reusable:
            # An abandoned body may leave bytes on the socket.
            self._resp.close()
        self._pool._release(self._conn, reusable=reusable)

    def __enter__(self) -> PooledResponse:
        return self

    def __exit__(self, *_exc: Any) -> None:
        self.close()


class ConnectionPool:
    """Bounded per-host keep-alive pool over ``http.client``.

    Thread-safe: request threads, the fan-out workers and
    :func:`~headlamp_tpu_torch.transport.api_proxy.with_timeout`'s threads
    check out concurrently. A checkout past ``max_per_host`` blocks up to
    the request's timeout, then raises :class:`PoolExhausted`.
    ``monotonic`` drives the idle TTL."""

    def __init__(
        self,
        *,
        max_per_host: int = DEFAULT_MAX_PER_HOST,
        max_idle_per_host: int | None = None,
        idle_ttl_s: float = DEFAULT_IDLE_TTL_S,
        monotonic: Callable[[], float] = time.monotonic,
    ) -> None:
        self.max_per_host = max_per_host
        self.max_idle_per_host = (
            max_idle_per_host if max_idle_per_host is not None else max_per_host
        )
        self.idle_ttl_s = idle_ttl_s
        self._mono = monotonic
        self._lock = threading.Lock()
        self._hosts: dict[tuple, _HostSlot] = {}
        self.opened = 0
        self.reused = 0
        self.evicted = 0
        self.stale_retries = 0
        # RTT estimates the fan-out width reads (a pool fronts one base URL).
        self._connect_ewma_ms: float | None = None
        self._rtt_ewma_ms: float | None = None
        _LIVE_POOLS.add(self)

    # -- stats ---------------------------------------------------------

    @property
    def open_connections(self) -> int:
        with self._lock:
            slots = list(self._hosts.values())
        return sum(s.open_count for s in slots)

    def idle_count(self) -> int:
        with self._lock:
            slots = list(self._hosts.values())
        return sum(len(s.idle) for s in slots)

    def connect_ewma_ms(self) -> float | None:
        return self._connect_ewma_ms

    def rtt_ewma_ms(self) -> float | None:
        return self._rtt_ewma_ms

    def counters(self) -> dict[str, int]:
        """Monotone counters only, read without a lock: the flight
        recorder's per-request delta view."""
        return {
            "connections_opened": self.opened,
            "connections_reused": self.reused,
            "idle_evicted": self.evicted,
            "stale_retries": self.stale_retries,
        }

    def snapshot(self) -> dict[str, Any]:
        """The /healthz ``runtime.transport`` block."""
        total = self.opened + self.reused
        return {
            **self.counters(),
            "open_connections": self.open_connections,
            "idle_connections": self.idle_count(),
            "reuse_rate": round(self.reused / total, 4) if total else None,
            "connect_ewma_ms": (
                round(self._connect_ewma_ms, 2) if self._connect_ewma_ms is not None else None
            ),
            "rtt_ewma_ms": round(self._rtt_ewma_ms, 2) if self._rtt_ewma_ms is not None else None,
        }

    def _observe_connect(self, host_label: str, seconds: float) -> None:
        _CONNECT_HIST.observe(seconds, host=host_label)
        ms = seconds * 1000.0
        prev = self._connect_ewma_ms
        self._connect_ewma_ms = ms if prev is None else prev + EWMA_ALPHA * (ms - prev)

    def _observe_rtt(self, seconds: float) -> None:
        ms = seconds * 1000.0
        prev = self._rtt_ewma_ms
        self._rtt_ewma_ms = ms if prev is None else prev + EWMA_ALPHA * (ms - prev)

    # -- checkout and release ------------------------------------------

    def _slot(self, key: tuple) -> _HostSlot:
        with self._lock:
            slot = self._hosts.get(key)
            if slot is None:
                slot = self._hosts[key] = _HostSlot(self.max_per_host)
            return slot

    def _evict_expired(self, slot: _HostSlot, now: float) -> None:
        # Under slot.lock; the list holds at most max_idle_per_host.
        keep: list[_PooledConn] = []
        for conn in slot.idle:
            if now - conn.idle_since > self.idle_ttl_s:
                conn.raw.close()
                slot.open_count -= 1
                self.evicted += 1
                _EVICTED.inc()
            else:
                keep.append(conn)
        slot.idle[:] = keep

    def _checkout(
        self, key: tuple, timeout_s: float, context: ssl.SSLContext | None
    ) -> tuple[_PooledConn, bool]:
        """(connection, was_reused) under an acquired slot. The caller
        routes the connection into _release (through PooledResponse.close)
        or _discard plus a semaphore release, exactly once."""
        scheme, host, port = key
        slot = self._slot(key)
        if not slot.sem.acquire(timeout=max(timeout_s, 0.001)):
            raise PoolExhausted(
                f"{host}:{port}: all {self.max_per_host} pooled connections "
                f"stayed checked out for {timeout_s:g}s"
            )
        counted = False
        try:
            with slot.lock:
                self._evict_expired(slot, self._mono())
                if slot.idle:
                    conn = slot.idle.pop()
                    self.reused += 1
                    _REUSED.inc(host=f"{host}:{port}")
                    # Re-arm the timeout of whichever request opened it.
                    if conn.raw.sock is not None:
                        conn.raw.sock.settimeout(timeout_s)
                    return conn, True
                slot.open_count += 1
                counted = True
            host_label = f"{host}:{port}"
            with _span("transport.connect", host=host_label):
                t0 = time.perf_counter()
                if scheme == "https":
                    raw: http.client.HTTPConnection = http.client.HTTPSConnection(
                        host, port, timeout=timeout_s, context=context
                    )
                else:
                    raw = http.client.HTTPConnection(host, port, timeout=timeout_s)
                try:
                    raw.connect()
                except Exception:
                    # A failed open never reaches the latency histogram; it
                    # is the transport_connect objective's error feed. An
                    # interrupt is not a transport failure.
                    _CONNECT_FAILED.inc(host=host_label)
                    raise
                self._observe_connect(host_label, time.perf_counter() - t0)
            self.opened += 1
            _OPENED.inc(host=host_label)
            return _PooledConn(raw, key), False
        except BaseException:
            # The reserved slot never became a connection: undo it.
            if counted:
                self._drop_open_count(slot)
            slot.sem.release()
            raise

    def _drop_open_count(self, slot: _HostSlot) -> None:
        with slot.lock:
            if slot.open_count > 0:
                slot.open_count -= 1

    def _release(self, conn: _PooledConn, *, reusable: bool) -> None:
        slot = self._slot(conn.key)
        if reusable:
            with slot.lock:
                conn.idle_since = self._mono()
                slot.idle.append(conn)
                # Idle-slot overflow: evict the least recently used.
                while len(slot.idle) > self.max_idle_per_host:
                    victim = slot.idle.pop(0)
                    victim.raw.close()
                    slot.open_count -= 1
                    self.evicted += 1
                    _EVICTED.inc()
        else:
            conn.raw.close()
            self._drop_open_count(slot)
        slot.sem.release()

    def _discard(self, conn: _PooledConn) -> None:
        """Close a checked-out connection without releasing its slot."""
        conn.raw.close()
        self._drop_open_count(self._slot(conn.key))

    # -- the request entry point ---------------------------------------

    def request(
        self,
        url: str,
        *,
        headers: dict[str, str] | None = None,
        timeout_s: float = 2.0,
        context: ssl.SSLContext | None = None,
        method: str = "GET",
    ) -> PooledResponse:
        """Issue ``method url`` over a pooled connection and return the
        live response; the caller closes it (a context manager). A
        request that fails with a peer-closed symptom on a reused socket
        is retried once on a fresh connection; a failure on a fresh one
        propagates. Inside a trace it carries the trace's
        ``traceparent``, unless the caller set one."""
        parts = urlsplit(url)
        scheme = parts.scheme or "http"
        host = parts.hostname or ""
        port = parts.port or (443 if scheme == "https" else 80)
        key = (scheme, host, port)
        path = parts.path or "/"
        if parts.query:
            path += "?" + parts.query
        # The one write of the traceparent header (TRC001), before the
        # attempt loop: a stale retry is the same logical request.
        send_headers = dict(headers) if headers else {}
        if TRACEPARENT_HEADER not in send_headers:
            traceparent = current_traceparent()
            if traceparent is not None:
                send_headers[TRACEPARENT_HEADER] = traceparent
                record_injected()
        slot = self._slot(key)
        for attempt in (0, 1):
            conn, reused = self._checkout(key, timeout_s, context)
            if reused:
                with _span("transport.reuse", host=f"{host}:{port}"):
                    pass
            t0 = time.perf_counter()
            try:
                conn.raw.request(method, path, headers=send_headers)
                resp = conn.raw.getresponse()
            except _STALE_ERRORS:
                self._discard(conn)
                slot.sem.release()
                if reused and attempt == 0:
                    self.stale_retries += 1
                    _STALE_RETRIES.inc()
                    continue
                raise
            except BaseException:
                self._discard(conn)
                slot.sem.release()
                raise
            self._observe_rtt(time.perf_counter() - t0)
            return PooledResponse(self, conn, resp)
        raise AssertionError("unreachable: the retry loop exits by return or raise")

    def close(self) -> None:
        """Close every idle connection (checked-out ones close through
        their response). Idempotent; the pool stays usable."""
        with self._lock:
            slots = list(self._hosts.values())
        for slot in slots:
            with slot.lock:
                for conn in slot.idle:
                    conn.raw.close()
                    slot.open_count -= 1
                slot.idle.clear()


# ---------------------------------------------------------------------------
# RTT-aware fan-out scheduling
# ---------------------------------------------------------------------------

#: Upper bound on one fan-out's width: a full-width fan-out fills one
#: host's checkout cap exactly and never queues behind itself.
DEFAULT_MAX_WIDTH = DEFAULT_MAX_PER_HOST

def choose_width(
    n_items: int,
    *,
    idle: int,
    connect_ms: float | None,
    rtt_ms: float | None,
    max_width: int = DEFAULT_MAX_WIDTH,
) -> int:
    """How many sockets ``n_items`` queries should spread across. Idle
    pooled sockets are free, so the width starts there (at least 1); each
    socket beyond them costs ``connect_ms`` and is worth it while going
    from w to w+1 saves more, ``rtt_ms * n * (1/w - 1/(w+1))``. With no
    measurements yet the full width applies."""
    cap = max(1, min(n_items, max_width))
    if n_items <= 1:
        return cap
    if connect_ms is None or rtt_ms is None:
        return cap
    width = max(1, min(idle, cap))
    while width < cap:
        serial_saving_ms = rtt_ms * n_items * (1.0 / width - 1.0 / (width + 1))
        if serial_saving_ms <= connect_ms:
            break
        width += 1
    return width


class FanoutScheduler:
    """The fan-out and the width policy above.

    Work is split into ``width`` chunks, each running its items in order
    on a thread of its own, started in chunk order, so at most ``width``
    connections are in flight for a fan-out. The chunk threads
    run under the caller's copied contextvars, so their spans land in the
    request's trace, and are joined before :meth:`map` returns: no thread
    outlives a fan-out. (JAX keeps a persistent 16-thread executor; a
    scrape fans out two batches, and the port keeps no thread that a
    ``close()`` would have to find.)"""

    def __init__(self, *, max_width: int = DEFAULT_MAX_WIDTH) -> None:
        self.max_width = max_width

    def width_for(self, n_items: int, pool: ConnectionPool | None) -> int:
        if pool is None:
            return max(1, min(n_items, self.max_width))
        return choose_width(
            n_items,
            idle=pool.idle_count(),
            connect_ms=pool.connect_ewma_ms(),
            rtt_ms=pool.rtt_ewma_ms(),
            max_width=min(self.max_width, pool.max_per_host),
        )

    def map(
        self, fn: Callable[[_T], _R], items: Sequence[_T], *, pool: ConnectionPool | None = None
    ) -> list[_R]:
        """``[fn(x) for x in items]`` at the chosen width, in input order.
        The first exception (in chunk order) propagates once every chunk
        has ended."""
        n = len(items)
        if n == 0:
            return []
        width = self.width_for(n, pool)
        if width <= 1 or n == 1:
            return [fn(item) for item in items]
        out: list[Any] = [None] * n
        errors: list[BaseException | None] = [None] * width

        def run_chunk(start: int) -> None:
            try:
                for i in range(start, n, width):
                    out[i] = fn(items[i])
            except BaseException as exc:  # noqa: BLE001 — re-raised in the caller
                errors[start] = exc

        threads = [
            threading.Thread(
                target=contextvars.copy_context().run, args=(run_chunk, start),
                name=f"hl-torch-fanout-{start}", daemon=True,
            )
            for start in range(width)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        error = next((e for e in errors if e is not None), None)
        if error is not None:
            raise error
        return out


#: The process fan-out scheduler the Prometheus client uses.
fanout = FanoutScheduler()


def pool_of(transport: Any) -> ConnectionPool | None:
    """The transport's connection pool when it has one (``KubeTransport``),
    else None: the fan-out's width policy engages exactly when real
    sockets are in play."""
    pool = getattr(transport, "pool", None)
    return pool if isinstance(pool, ConnectionPool) else None

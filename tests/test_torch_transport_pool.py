"""The port's real transport (``headlamp_tpu_torch/transport``: the
keep-alive ``ConnectionPool``, the fan-out scheduler and
``KubeTransport``) against the JAX package's, on the CPU.

Every socket scenario of ``tests/test_transport_pool.py`` runs once per
package against a fresh local HTTP/1.1 keep-alive server that counts the
TCP connections it accepts: reuse, reuse after a non-2xx, the unread-body
discard, the checkout cap, ``PoolExhausted``, idle eviction by TTL and by
overflow, the stale-socket retry. Each scenario's observations — the
server's accept count beside the pool's own counters — are held equal
between the packages, exactly. The port's counters are also held
against its ``/metricsz`` families (dual accounting), and each connect
feeds the ``transport_connect`` objective. ``choose_width`` is equal on
a grid of RTT statistics, and ``fetch_tpu_metrics`` through each
package's ``KubeTransport`` against one stand-in apiserver gives equal
snapshots (the measured ``fetch_ms`` aside). Only ``127.0.0.1`` is
contacted.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from headlamp_tpu.metrics import client as jclient
from headlamp_tpu.server import make_demo_transport as jax_demo_transport
from headlamp_tpu.transport import ApiError as JaxApiError
from headlamp_tpu.transport import KubeTransport as JaxKube
from headlamp_tpu.transport import pool as jpool
from headlamp_tpu_torch.metrics import client as tclient
from headlamp_tpu_torch.obs import slo as tslo
from headlamp_tpu_torch.obs.metrics import registry as tregistry
from headlamp_tpu_torch.server import make_demo_transport
from headlamp_tpu_torch.server.standin import StandInApiserver
from headlamp_tpu_torch.transport import ApiError, KubeTransport, RequestTimeout, with_timeout
from headlamp_tpu_torch.transport import pool as tpool

PACKAGES = {"jax": (jpool, JaxKube, JaxApiError), "port": (tpool, KubeTransport, ApiError)}
CLOCK = 1785283200.0


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path.startswith("/slow"):
            time.sleep(self.server.slow_s)
        if self.path.startswith("/missing"):
            status, body = 404, b'{"kind":"Status","code":404}'
        elif self.path.startswith("/watch"):
            status, body = 200, b'{"type":"ADDED","object":{"n":1}}\n\n{"type":"BOOKMARK"}\n'
        else:
            status, body = 200, json.dumps({"path": self.path}).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


class _CountingServer(ThreadingHTTPServer):
    daemon_threads = True
    slow_s = 0.0

    def __init__(self):
        super().__init__(("127.0.0.1", 0), _Handler)
        self.connects = 0
        self.sockets = []
        self._lock = threading.Lock()
        threading.Thread(target=self.serve_forever, daemon=True).start()

    def get_request(self):
        sock, addr = super().get_request()
        with self._lock:
            self.connects += 1
            self.sockets.append(sock)
        return sock, addr

    def url(self, path="/x"):
        return f"http://127.0.0.1:{self.server_address[1]}{path}"

    def kill_connections(self):
        with self._lock:
            sockets, self.sockets = self.sockets, []
        for sock in sockets:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            sock.close()
        time.sleep(0.02)

    def stop(self):
        self.shutdown()
        self.kill_connections()
        self.server_close()


def _both(scenario):
    out = {}
    for name, mods in PACKAGES.items():
        server = _CountingServer()
        try:
            out[name] = scenario(server, *mods)
        finally:
            server.stop()
    return out


def _drain(pool, url, **kw):
    with pool.request(url, **kw) as resp:
        return resp.status, resp.read()


def test_sequential_requests_and_a_404_reuse_one_connection():
    def scenario(server, pool_mod, kube, api_error):
        pool = pool_mod.ConnectionPool()
        bodies = [_drain(pool, server.url(f"/q{i}")) for i in range(6)]
        missing = _drain(pool, server.url("/missing"))
        transport = kube(server.url(""), pool=pool)
        with pytest.raises(api_error) as excinfo:
            transport.request("/missing")
        got = transport.request("/after")
        snap = pool.snapshot()
        return (bodies[-1], missing, excinfo.value.status, got, server.connects, pool.opened,
                pool.reused, snap["reuse_rate"], sorted(snap))

    got = _both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][4:7] == (1, 1, 8)


def test_an_unread_body_discards_its_socket():
    def scenario(server, pool_mod, _kube, _err):
        pool = pool_mod.ConnectionPool()
        with pool.request(server.url()) as resp:
            status = resp.status  # the body is left unread
        idle = pool.idle_count()
        _drain(pool, server.url())
        return status, idle, pool.opened, server.connects

    got = _both(scenario)
    assert got["port"] == got["jax"] == (200, 0, 2, 2)


def test_the_checkout_cap_and_an_exhausted_pool():
    def scenario(server, pool_mod, _kube, _err):
        server.slow_s = 0.15
        pool = pool_mod.ConnectionPool(max_per_host=2)
        errors = []

        def one(i):
            try:
                _drain(pool, server.url(f"/slow/{i}"), timeout_s=5.0)
            except Exception as exc:  # noqa: BLE001 — collected for the assert
                errors.append(exc)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        capped = (errors, server.connects, pool.opened, pool.reused, pool.open_connections)
        server.slow_s = 0.0
        single = pool_mod.ConnectionPool(max_per_host=1)
        held = single.request(server.url("/held"))
        try:
            with pytest.raises(pool_mod.PoolExhausted):
                single.request(server.url("/blocked"), timeout_s=0.05)
        finally:
            held.read()
            held.close()
        after = _drain(single, server.url("/after"))
        return capped, after, single.opened

    got = _both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][0] == ([], 2, 2, 4, 2)


def test_idle_eviction_by_ttl_and_by_overflow():
    def scenario(server, pool_mod, _kube, _err):
        clock = [0.0]
        pool = pool_mod.ConnectionPool(idle_ttl_s=30.0, monotonic=lambda: clock[0])
        _drain(pool, server.url())
        clock[0] = 10.0
        _drain(pool, server.url())
        clock[0] = 50.0
        _drain(pool, server.url())
        ttl = (pool.reused, pool.evicted, pool.opened)
        server.slow_s = 0.1
        over = pool_mod.ConnectionPool(max_per_host=4, max_idle_per_host=1)
        responses = [over.request(server.url(f"/slow/{i}")) for i in range(3)]
        for resp in responses:
            resp.read()
            resp.close()
        return ttl, (over.opened, over.idle_count(), over.evicted), server.connects

    got = _both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][:2] == ((1, 1, 2), (3, 1, 2))


def test_a_peer_closed_socket_is_retried_once():
    def scenario(server, pool_mod, kube, _err):
        transport = kube(server.url(""))
        first = transport.request("/a")
        server.kill_connections()
        second = transport.request("/b")
        pool = transport.pool
        port = server.server_address[1]
        server.stop()
        fresh = pool_mod.ConnectionPool()
        with pytest.raises(OSError):
            fresh.request(f"http://127.0.0.1:{port}/x", timeout_s=0.5)
        return first, second, pool.stale_retries, pool.opened, fresh.stale_retries, \
            fresh.open_connections

    got = {}
    for name, mods in PACKAGES.items():
        got[name] = scenario(_CountingServer(), *mods)
    assert got["port"] == got["jax"] == ({"path": "/a"}, {"path": "/b"}, 1, 2, 0, 0)


def test_pool_ints_registry_counters_and_the_connect_objective_agree():
    names = ("connections_opened_total", "connections_reused_total", "idle_evicted_total",
             "stale_retries_total")

    def total(name):
        metric = next((m for m in tregistry if m.name == name), None)
        return 0.0 if metric is None else sum(v for _labels, v in metric.samples())

    server = _CountingServer()
    try:
        before = {n: total(f"headlamp_tpu_torch_transport_{n}") for n in names}
        hist = tregistry.histogram(tslo.CONNECT_LATENCY, "", labels=("host",))
        host = f"127.0.0.1:{server.server_address[1]}"
        connects_before = hist.count_for(host=host)
        engine = tslo.SLOEngine()
        previous = tslo.set_engine(engine)
        try:
            clock = [0.0]
            pool = tpool.ConnectionPool(idle_ttl_s=30.0, monotonic=lambda: clock[0])
            for _ in range(3):
                _drain(pool, server.url())
            clock[0] = 100.0  # TTL eviction, then a fresh open
            _drain(pool, server.url())
            server.kill_connections()  # a stale retry, then a fresh open
            _drain(pool, server.url())
            report = {s["name"]: s for s in engine.report()["slos"]}["transport_connect"]
        finally:
            tslo.set_engine(previous)
        deltas = {n: total(f"headlamp_tpu_torch_transport_{n}") - before[n] for n in names}
        assert deltas == {"connections_opened_total": 3, "connections_reused_total": 3,
                          "idle_evicted_total": 1, "stale_retries_total": 1}
        assert (pool.opened, pool.reused, pool.evicted, pool.stale_retries) == (3, 3, 1, 1)
        assert pool.counters() == {k: pool.snapshot()[k] for k in pool.counters()}
        # Three connects observed for the objective; the stale retry is its error feed.
        assert hist.count_for(host=host) - connects_before == 3
        # Three good connects and the stale retry's bad event.
        assert report["events"]["5m"] == {"good": 3, "bad": 1}
        text = tregistry.render()
        assert "headlamp_tpu_torch_transport_pool_connections_count" in text
        pool.close()
        assert pool.open_connections == 0
    finally:
        server.stop()


def test_choose_width_and_the_fanout_map_are_equal():
    grid = itertools.product((1, 2, 3, 8, 16, 23), (0, 1, 4, 8), (None, 0.5, 1.0, 100.0, 200.0),
                             (None, 10.0, 90.0, 100.0), (4, 8))
    for n, idle, connect_ms, rtt_ms, max_width in grid:
        kw = dict(idle=idle, connect_ms=connect_ms, rtt_ms=rtt_ms, max_width=max_width)
        assert tpool.choose_width(n, **kw) == jpool.choose_width(n, **kw), (n, kw)
    assert tpool.choose_width(8, idle=0, connect_ms=100.0, rtt_ms=100.0) == 3
    sched = tpool.FanoutScheduler()
    items = list(range(23))
    seen = set()

    def double(x):
        seen.add(threading.current_thread().name)
        return x * 2

    assert sched.map(double, items) == jpool.FanoutScheduler().map(lambda x: x * 2, items)
    assert len(seen) == sched.max_width and threading.current_thread().name not in seen
    # Every chunk thread is joined before map returns.
    assert not [t for t in threading.enumerate() if t.name.startswith("hl-torch-fanout")]

    def boom(x):
        if x == 5:
            raise ValueError("query 5")
        return x

    with pytest.raises(ValueError, match="query 5"):
        sched.map(boom, items)
    tid = []
    sched.map(lambda _x: tid.append(threading.get_ident()), [1])
    assert tid == [threading.get_ident()]  # one item: no thread
    assert tpool.pool_of(make_demo_transport("v5e4")) is None
    assert isinstance(tpool.pool_of(KubeTransport("http://127.0.0.1:1")), tpool.ConnectionPool)


def test_watch_streams_timeouts_and_errors():
    def scenario(server, _pool, kube, api_error):
        transport = kube(server.url(""))
        events = transport.watch("/watch?watch=true&timeoutSeconds=1")
        with pytest.raises(api_error) as missing:
            transport.watch("/missing?watch=true")
        return events, missing.value.status, transport.pool.reused

    got = _both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][0] == [{"type": "ADDED", "object": {"n": 1}}, {"type": "BOOKMARK"}]
    release = threading.Event()
    with pytest.raises(RequestTimeout) as excinfo:
        with_timeout(lambda: release.wait(5.0), 0.05, "/stalled")
    release.set()
    assert isinstance(excinfo.value, ApiError) and excinfo.value.timeout_s == 0.05
    assert str(excinfo.value) == "/stalled: timed out after 0.05s"
    with pytest.raises(ApiError) as refused:
        KubeTransport("http://127.0.0.1:9").request("/x", timeout_s=1.0)
    assert "request failed" in str(refused.value)


@pytest.mark.parametrize("fleet", ["v5p32", "large"])
def test_fetch_tpu_metrics_over_the_pool_equals_jax(fleet):
    """One stand-in apiserver serving the demo fleet; each package's
    KubeTransport fans its Prometheus queries out over its own pool."""
    stand = StandInApiserver(make_demo_transport(fleet))
    try:
        port_t, jax_t = KubeTransport(stand.url), JaxKube(stand.url)
        got = tclient.fetch_tpu_metrics(port_t, clock=lambda: CLOCK)
        want = jclient.fetch_tpu_metrics(jax_t, clock=lambda: CLOCK)
        local = jclient.fetch_tpu_metrics(jax_demo_transport(fleet), clock=lambda: CLOCK)
        fields = [dataclasses.asdict(s) for s in (got, want, local)]
        for f in fields:
            f.pop("fetch_ms")
        assert fields[0] == fields[1] == fields[2]
        assert len(got.chips) > 0
        # A warm fetch skips discovery and rides the pooled sockets.
        reused, requests = port_t.pool.reused, stand.requests
        again = tclient.fetch_tpu_metrics(port_t, clock=lambda: CLOCK)
        assert dataclasses.asdict(again)["chips"] == fields[0]["chips"]
        assert port_t.pool.reused > reused and stand.requests > requests
        port_t.pool.close()
        jax_t.pool.close()
    finally:
        stand.close()

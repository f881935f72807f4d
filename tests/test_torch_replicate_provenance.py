"""Provenance across processes on the port's host, on the CPU, against
JAX's.

The flight recorder's wide event keeps the gateway's admission block: a
request through each package's gateway leaves a newest ``/debug/flightz``
event with the same keys and an equal ``gateway`` block (priority,
degraded; ``queue_wait_ms`` present). An inbound ``traceparent`` becomes
the request trace's ``remote_parent`` in both hosts; the gateway hands a
coalescing leader's header to the render and drops a follower's; the
pool stamps the calling trace's header once per request. Over sockets a
replica's ``/replicate/poll`` trace names the leader's publishing trace
and the leader's ``/replicate/bus`` serve names the poll's, and
``/debug/generationz`` on a leader and on a replica equals JAX's (trace
ids masked), with the ``published`` and ``applied`` stamps and the
leadership transitions.
"""

from __future__ import annotations

import http.client
import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from headlamp_tpu import replicate as jrep
from headlamp_tpu.obs import slo as jslo
from headlamp_tpu.obs.flight import flight_recorder as jax_flight
from headlamp_tpu.runtime import device_cache as jax_device_cache
from headlamp_tpu.server import DashboardApp as JaxApp
from headlamp_tpu.server.app import add_demo_prometheus as jax_add_prometheus
from headlamp_tpu.fleet import fixtures as jfx
from headlamp_tpu_torch import replicate as trep
from headlamp_tpu_torch.fleet import fixtures as tfx
from headlamp_tpu_torch.gateway import RenderGateway
from headlamp_tpu_torch.models import aot
from headlamp_tpu_torch.obs import slo as tslo
from headlamp_tpu_torch.obs.flight import flight_recorder
from headlamp_tpu_torch.obs.metrics import registry as treg
from headlamp_tpu_torch.obs.propagate import format_traceparent
from headlamp_tpu_torch.obs.trace import current_trace_id, trace_request, trace_ring
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport
from headlamp_tpu_torch.server.demo import add_demo_prometheus
from headlamp_tpu_torch.transport import ConnectionPool

CLOCK = 1785283200.0
_HEX16 = re.compile(r"\b[0-9a-f]{16}\b")


def clock():
    return CLOCK


def _wait(pred, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.005)


def mono():
    return 1000.0


@pytest.fixture(autouse=True)
def fresh_engines(monkeypatch):
    monkeypatch.setattr(tslo, "_engine", tslo.SLOEngine())
    monkeypatch.setattr(aot, "_REGISTRY", aot.AotProgramRegistry())


def test_the_flight_event_keeps_the_gateway_block_as_jaxs():
    port = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=clock)
    jax = JaxApp(jfx.fleet_transport(jfx.fleet_v5e4()), clock=clock)
    gws = [port.ensure_gateway(workers=1, engine=lambda: tslo.SLOEngine()),
           jax.ensure_gateway(workers=1, engine=lambda: jslo.SLOEngine())]
    try:
        jax_device_cache.fleet_cache.invalidate()
        assert [gw.handle("/tpu").status for gw in gws] == [200, 200]
        got = flight_recorder.snapshot()["recent"][0]
        want = jax_flight.snapshot()["recent"][0]
        assert got["route"] == want["route"] == "/tpu"
        assert set(got) == set(want)
        for block in (got["gateway"], want["gateway"]):
            assert set(block) == {"priority", "queue_wait_ms", "degraded"}
        assert {k: got["gateway"][k] for k in ("priority", "degraded")} == {
            k: want["gateway"][k] for k in ("priority", "degraded")} == {
            "priority": "interactive", "degraded": False}
        # A direct handle() call has no admission story, in both.
        port.handle("/tpu/nodes")
        jax.handle("/tpu/nodes")
        assert "gateway" not in flight_recorder.snapshot()["recent"][0]
        assert "gateway" not in jax_flight.snapshot()["recent"][0]
    finally:
        port.close()
        gws[1].close()


def test_an_inbound_traceparent_becomes_the_remote_parent_as_in_jax():
    port = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=clock)
    jax = JaxApp(jfx.fleet_transport(jfx.fleet_v5e4()), clock=clock)
    try:
        wire = format_traceparent("feedfacefeedface")
        for header, parent in ((wire, "feedfacefeedface"), ("00-bad", None), (None, None)):
            assert port.handle("/tpu", traceparent=header)[0] == 200
            got = next(t for t in trace_ring.snapshot() if t["route"] == "/tpu")
            assert got.get("remote_parent") == parent
            assert jax.handle("/tpu", traceparent=header)[0] == 200
            from headlamp_tpu.obs.trace import trace_ring as jax_ring

            want = next(t for t in jax_ring.snapshot() if t["route"] == "/tpu")
            assert set(got) == set(want) and want.get("remote_parent") == parent
    finally:
        port.close()


def test_the_gateway_forwards_the_leaders_traceparent_and_drops_a_followers():
    seen, entered, release = [], threading.Event(), threading.Event()

    def handle(path, *, accept=None, gateway_info=None, **extra):
        seen.append((path, extra.get("traceparent")))
        entered.set()
        release.wait(5.0)
        return 200, "text/html", "page"

    gw = RenderGateway(handle, route_label=lambda p: p.split("?")[0], workers=2,
                       request_timeout_s=10.0, engine=lambda: tslo.SLOEngine())
    try:
        lead_tp, follow_tp = format_traceparent("a" * 16), format_traceparent("b" * 16)
        results = {}
        leader = threading.Thread(target=lambda: results.setdefault(
            "leader", gw.handle("/tpu", traceparent=lead_tp)))
        leader.start()
        assert entered.wait(5.0)
        follower = threading.Thread(target=lambda: results.setdefault(
            "follower", gw.handle("/tpu", traceparent=follow_tp)))
        follower.start()
        flight = next(iter(gw.coalescer._flights.values()))
        _wait(lambda: flight.followers == 1)
        release.set()
        leader.join(5.0)
        follower.join(5.0)
        assert not leader.is_alive() and not follower.is_alive()
        assert results["leader"].status == results["follower"].status == 200
        # One render, and it carried the leader's header only.
        assert seen == [("/tpu", lead_tp)] and gw.counters()["coalesced_followers"] == 1
        # /healthz bypasses the pool and still forwards the header.
        seen.clear()
        release.set()
        gw.handle("/healthz", traceparent=lead_tp)
        gw.handle("/tpu?x=1")
        assert seen == [("/healthz", lead_tp), ("/tpu?x=1", None)]
    finally:
        release.set()
        gw.close()


def test_the_pool_stamps_the_calling_trace_once_per_request():
    headers = []

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_GET(self):  # noqa: N802
            headers.append(self.headers.get("traceparent"))
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever)
    thread.start()
    pool = ConnectionPool()
    counter = treg._metrics["headlamp_tpu_torch_trace_propagation_total"]
    before = counter.value_for(direction="injected")
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/x"
        with pool.request(url) as resp:
            resp.read()
        with trace_request("/t") as trace:
            for _ in range(2):
                with pool.request(url) as resp:
                    resp.read()
            with pool.request(url, headers={"traceparent": "00-caller"}) as resp:
                resp.read()
        assert headers == [None, format_traceparent(trace.trace_id),
                           format_traceparent(trace.trace_id), "00-caller"]
        assert counter.value_for(direction="injected") - before == 2
        assert current_trace_id() is None
    finally:
        pool.close()
        server.shutdown()
        server.server_close()
        thread.join(5.0)


def test_bus_traces_link_both_ways_over_sockets():
    fleet = tfx.fleet_v5e4()
    transport = tfx.fleet_transport(fleet)
    add_demo_prometheus(transport, fleet)
    leader = DashboardApp(transport, device="cpu", clock=clock, min_sync_interval_s=3600.0)
    leader.replication = trep.BusPublisher(wall=clock, ledger=leader.ledger)
    server = leader.serve("127.0.0.1", 0)
    replica = trep.ReplicaApp(device="cpu", clock=clock)
    replica_server = replica.serve("127.0.0.1", 0)
    pool = ConnectionPool()
    try:
        # One leader request: its inline sync publishes under its trace.
        assert leader.handle("/tpu")[0] == 200
        leader_trace = next(t for t in trace_ring.snapshot() if t["route"] == "/tpu")
        consumer = trep.BusConsumer(replica, trep.pool_fetch(server.url, pool=pool))
        assert consumer.poll_once() == 1
        poll = next(t for t in trace_ring.snapshot() if t["route"] == "/replicate/poll")
        serve = next(t for t in trace_ring.snapshot() if t["route"] == "/replicate/bus")
        assert poll["remote_parent"] == leader_trace["trace_id"]
        assert serve["remote_parent"] == poll["trace_id"]
        apply_span = next(s for s in poll["spans"] if s["name"] == "replicate.apply")
        assert apply_span["attrs"]["origin_trace_id"] == leader_trace["trace_id"]
        host, port = server.url.rsplit(":", 1)
        conn = http.client.HTTPConnection(host[len("http://"):], int(port), timeout=10)
        generation = leader.snapshot_generation()
        for cursor, lines in ((None, 2), (f"g{generation}", 1), ("junk", 2)):
            conn.request("GET", "/replicate/bus",
                         headers={"Last-Generation": cursor} if cursor else {})
            resp = conn.getresponse()
            body = resp.read().decode()
            assert resp.status == 200 and resp.getheader("Content-Type") == "application/x-ndjson"
            assert resp.getheader("X-Headlamp-Generation") == str(generation)
            assert len(body.splitlines()) == lines, cursor
        conn.close()
        # A host with no publisher has no bus.
        rhost, rport = replica_server.url.rsplit(":", 1)
        conn = http.client.HTTPConnection(rhost[len("http://"):], int(rport), timeout=10)
        conn.request("GET", "/replicate/bus")
        assert conn.getresponse().status == 404
        conn.close()
        health = json.loads(replica.handle("/healthz")[2])["runtime"]["replication"]
        assert health["role"] == "replica" and health["applied"] == 1
        assert json.loads(leader.handle("/healthz")[2])["runtime"]["replication"]["pulls"] == 4
    finally:
        pool.close()
        replica_server.close()
        server.close()


def _mask(text):
    return _HEX16.sub("<id>", text)


def _generationz(leader_cls, add_prometheus, fixtures, mod, **kwargs):
    fleet = fixtures.fleet_v5e4()
    transport = fixtures.fleet_transport(fleet)
    add_prometheus(transport, fleet)
    leader = leader_cls(transport, clock=clock, monotonic=mono, min_sync_interval_s=3600.0,
                        **kwargs)
    publisher = mod.BusPublisher(wall=clock, monotonic=mono, ledger=leader.ledger)
    leader.replication = publisher
    elector = mod.LeaderElector(mod.LeaseStore(monotonic=mono), "leader", monotonic=mono,
                                ledger=leader.ledger)
    elector.tick()
    elector.resign()
    assert leader.handle("/tpu")[0] == 200
    replica = mod.ReplicaApp(clock=clock, monotonic=mono, **kwargs)
    _, records = mod.parse_payload(publisher.payload_after(None))
    assert all(replica.apply_record(r) for r in records)
    assert replica.handle("/tpu")[0] == 200
    out = []
    for app in (leader, replica):
        snapshot = json.loads(app.handle("/debug/generationz")[2])
        page = app.handle("/debug/generationz/html")[2]
        out.append((_mask(json.dumps(snapshot, sort_keys=True)),
                    _mask(re.search("<main>(.*)</main>", page, re.S).group(1)), snapshot))
    if hasattr(leader, "close"):
        leader.close()
        replica.close()
    return out


def test_generationz_on_a_leader_and_a_replica_equals_jaxs():
    jax_device_cache.fleet_cache.invalidate()
    want = _generationz(JaxApp, jax_add_prometheus, jfx, jrep)
    got = _generationz(DashboardApp, add_demo_prometheus, tfx, trep, device="cpu")
    for (got_json, got_page, _), (want_json, want_page, _) in zip(got, want):
        assert got_json == want_json
        # The hint names each package's own stage histogram.
        assert got_page == want_page.replace(
            "headlamp_tpu_generation", "headlamp_tpu_torch_generation")
    leader, replica = got[0][2], got[1][2]
    assert [t["kind"] for t in leader["transitions"]] == ["elected", "resigned"]
    assert "published" in leader["generations"][0]["stages"]
    assert replica["role"] == "replica" and "applied" in replica["generations"][0]["stages"]
    assert replica["generations"][0]["origin"]["trace_id"]

"""The port's read replicas against the port's leader, on the CPU.

A ``ReplicaApp`` that applied a leader's records paints every page of
the slice (``/tpu``, ``/tpu/nodes``, ``/tpu/pods``, ``/tpu/topology``,
``/tpu/metrics``, ``/tpu/deviceplugins``, ``/tpu/fleet``, ``/tpu/trends``)
with the leader's bytes for the same generation, behind its gateway with
the leader's ETags, a leader ETag is a 304 on it, and a fleet change gives
both the same ``/events`` wire. Its metrics page paints the record's
forecast and fits nothing. The failover drill runs on injected clocks:
the leader dies, the replica answers with ``X-Headlamp-Stale: 1`` and no
5xx, a new leader is elected at fencing 2 with its generations floored at
2 000 000, a deposed leader's publish is ``rejected_stale``, and the
replica converges. A publish that raises, an apply that raises on the
poll thread and an election callback that raises on the renewal thread
are counted, named in ``/healthz`` ``runtime.replication`` and turn
``ok`` false until a clean one; the raising callback also gives its term
back. ``--replica`` needs CUDA unless
``--device cpu`` is given.
"""

from __future__ import annotations

import copy
import json
import re
import time

import pytest

from headlamp_tpu.gateway.shed import ShedPolicy as JaxShedPolicy
from headlamp_tpu.replicate import ReplicaApp as JaxReplicaApp
from headlamp_tpu_torch.fleet import fleet_transport, fleet_viewport
from headlamp_tpu_torch.gateway.pool import PRIORITY_DEBUG, PRIORITY_INTERACTIVE, PRIORITY_OPS
from headlamp_tpu_torch.gateway.shed import ShedPolicy
from headlamp_tpu_torch.models import aot
from headlamp_tpu_torch.models.fused_forward import LAUNCHES
from headlamp_tpu_torch.obs import slo as tslo
from headlamp_tpu_torch.obs.trace import trace_ring
from headlamp_tpu_torch.push import format_event
from headlamp_tpu_torch.replicate import (
    BusConsumer,
    BusPublisher,
    LeaderElector,
    LeaseStore,
    ReplicaApp,
    generation_floor,
    parse_payload,
)
from headlamp_tpu_torch.runtime.device_cache import warm_carries
from headlamp_tpu_torch.server import DashboardApp
from headlamp_tpu_torch.server import app as app_mod
from headlamp_tpu_torch.server.__main__ import main as server_main
from headlamp_tpu_torch.server.demo import add_demo_prometheus
from headlamp_tpu_torch.transport import ApiError

CLOCK = 1785283200.0
PAGES = ("/tpu", "/tpu/nodes", "/tpu/pods", "/tpu/topology", "/tpu/metrics",
         "/tpu/deviceplugins", "/tpu/fleet", "/tpu/trends")


def clock():
    return CLOCK


class FakeClock:
    def __init__(self, now: float = 1000.0) -> None:
        self.now = now

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds


@pytest.fixture(autouse=True)
def fresh_engine(monkeypatch):
    # Gateways shed off the process SLO engine: 5xx earlier tests served in
    # the process must not page it here.
    monkeypatch.setattr(tslo, "_engine", tslo.SLOEngine())
    warm_carries.invalidate()


def _leader(n=64, mono=None):
    fleet = fleet_viewport(n)
    transport = fleet_transport(fleet)
    add_demo_prometheus(transport, fleet)
    app = DashboardApp(transport, device="cpu", clock=clock, min_sync_interval_s=30.0,
                       monotonic=mono or FakeClock())
    # Measured timings stay out of both stores, so the trend pages compare.
    app.history.capture_timings = False
    publisher = BusPublisher(monotonic=mono, wall=clock, ledger=app.ledger)
    app.replication = publisher
    return transport, app, publisher


def _bump(app):
    """One more leader generation: lift the floor, reopen the sync window."""
    app._ctx.advance_generation_floor(app.snapshot_generation() + 1)
    app._last_sync = float("-inf")
    app._synced_snapshot()


def _replica(mono=None, **kwargs):
    rep = ReplicaApp(device="cpu", clock=clock, monotonic=mono or FakeClock(), **kwargs)
    rep.history.capture_timings = False
    return rep


def _apply_all(rep, publisher, cursor=None):
    _, records = parse_payload(publisher.payload_after(cursor))
    return [rep.apply_record(r) for r in records]


def _primed_pair():
    mono = FakeClock()
    transport, app, pub = _leader(mono=mono)
    app._synced_snapshot()
    # The peeks ship once a metrics page has fetched and fit.
    assert app.handle("/tpu/metrics")[0] == 200
    _bump(app)
    rep = _replica(mono)
    assert all(_apply_all(rep, pub))
    return transport, app, pub, rep


def test_replica_paints_equal_the_leaders_and_fit_nothing():
    _, app, pub, rep = _primed_pair()
    try:
        assert rep.snapshot_generation() == app.snapshot_generation() == pub.last_generation
        launches = LAUNCHES.n
        refits = rep._forecast_refresher.snapshot()["refits"]
        for path in PAGES:
            got, want = rep.handle(path), app.handle(path)
            assert got[0] == want[0] == 200, path
            assert got == want, path
        assert "Utilization Forecast" in rep.handle("/tpu/metrics")[2]
        assert LAUNCHES.n == launches and rep._forecast_refresher.snapshot()["refits"] == refits
        assert rep.history.syncs == rep.applied == 2 and rep.history.scrapes == 1
        health = json.loads(rep.handle("/healthz")[2])
        assert health["ok"] is True and "replication" not in health["runtime"]
    finally:
        app.close()
        rep.close()


def test_replica_etags_304s_and_push_wire_equal_the_leaders():
    transport, app, pub, rep = _primed_pair()
    gws = [app.ensure_gateway(workers=1), rep.ensure_gateway(workers=1)]
    try:
        subs = [a.push.hub.subscribe(("/tpu", "/tpu/nodes", "/tpu/pods")) for a in (app, rep)]
        for path in ("/tpu", "/tpu/nodes?limit=5", "/tpu/fleet"):
            lead, repl = gws[0].handle(path), gws[1].handle(path)
            assert lead.status == repl.status == 200 and lead.body == repl.body, path
            assert dict(lead.headers) == dict(repl.headers), path
            etag = dict(lead.headers)["ETag"]
            assert [gw.handle(path, if_none_match=etag).status for gw in gws] == [304, 304]
        assert dict(gws[1].handle("/tpu").headers)["X-Headlamp-Stale"] == "0"
        # A real change between generations: a node's Ready flips.
        node = copy.deepcopy(app._last_snapshot.provider("tpu").nodes[3])
        for cond in node["status"]["conditions"]:
            if cond["type"] == "Ready":
                cond["status"] = "False" if cond["status"] == "True" else "True"
        transport.node_feed.push("MODIFIED", node)
        app._ctx.enable_watch()
        _bump(app)
        assert all(_apply_all(rep, pub, rep.snapshot_generation()))

        def drain(hub, sub):
            out = []
            while (event := hub.poll(sub)) is not None:
                out.append(format_event(event))
            return out

        wires = [drain(a.push.hub, s) for a, s in zip((app, rep), subs)]
        assert wires[0] and wires[0] == wires[1]
        assert any(node["metadata"]["name"] in w for w in wires[1])
    finally:
        app.close()
        rep.close()


def test_the_failover_drill_serves_stale_with_no_5xx_and_converges():
    mono = FakeClock()
    _, app, pub = _leader(mono=mono)
    app._synced_snapshot()
    reps = [_replica(mono, stale_after_s=30.0) for _ in range(2)]
    consumers = [BusConsumer(r, pub.payload_after) for r in reps]
    gws = [r.ensure_gateway(workers=1) for r in reps]
    store_clock = FakeClock()
    store = LeaseStore(monotonic=store_clock)
    old = LeaderElector(store, "old", ttl_s=15.0, monotonic=store_clock, ledger=app.ledger)
    try:
        assert old.tick() and old.fencing == 1
        assert [c.poll_once() for c in consumers] == [1, 1]
        assert all(dict(gw.handle("/tpu").headers)["X-Headlamp-Stale"] == "0" for gw in gws)

        def dead(cursor):
            raise ApiError("/replicate/bus", "connection refused")

        for c in consumers:
            c._fetch = dead
        mono.advance(31.0)
        assert [c.poll_once() for c in consumers] == [0, 0]
        assert [c.fetch_failures for c in consumers] == [1, 1] and all(r.stale() for r in reps)
        for i, gw in enumerate(gws):
            gw.shed_policy.invalidate()
            for path in ("/tpu", "/tpu/nodes", "/tpu/fleet", "/tpu/metrics", f"/tpu?loss={i}"):
                resp = gw.handle(path)
                assert resp.status == 200 and dict(resp.headers)["X-Headlamp-Stale"] == "1", path
            health = json.loads(gw.handle("/healthz").body)
            assert health["runtime"]["replication"]["stale"] is True
            assert health["runtime"]["replication"]["last_fetch_error"].startswith("ApiError")
        # The old term lapses; a new leader takes fencing 2 and floors its band.
        store_clock.advance(16.0)
        _, app2, pub2 = _leader(mono=mono)
        new = LeaderElector(
            store, "new", ttl_s=15.0, monotonic=store_clock, ledger=app2.ledger,
            on_elected=lambda f: (pub2.set_fencing(f),
                                  app2._ctx.advance_generation_floor(generation_floor(f))),
        )
        assert new.tick() and new.fencing == 2
        assert not old.tick() and old.depositions == 1
        app2._synced_snapshot()
        assert app2.snapshot_generation() == 2_000_001
        # The deposed leader's next generation sits in the lower band.
        stale_gen = app.snapshot_generation() + 1
        assert pub2.publish(app._last_snapshot, generation=stale_gen) is False
        assert pub2.rejected_stale == 1
        for c in consumers:
            c._fetch = pub2.payload_after
        assert [c.poll_once() for c in consumers] == [1, 1]
        for rep, gw in zip(reps, gws):
            assert rep.snapshot_generation() == 2_000_001 and not rep.stale()
            gw.shed_policy.invalidate()
            resp = gw.handle("/tpu?recovered=1")
            headers = dict(resp.headers)
            assert resp.status == 200 and headers["X-Headlamp-Stale"] == "0"
            assert headers["X-Headlamp-Generation"] == "2000001"
        # An old-band record reaching a replica is fenced out too.
        _, old_records = parse_payload(pub.payload_after(None))
        assert reps[0].apply_record(old_records[-1]) is False and reps[0].rejected_stale == 1
        kinds = [t["kind"] for t in app.ledger.snapshot()["transitions"]]
        assert kinds == ["elected", "deposed"]
        assert [t["fencing"] for t in app2.ledger.snapshot()["transitions"]] == [2]
        app2.close()
    finally:
        app.close()
        for rep in reps:
            rep.close()


def test_a_raising_publish_is_counted_named_and_fails_healthz():
    _, app, pub = _leader()
    try:
        app._synced_snapshot()
        real = pub.publish

        def broken(*args, **kwargs):
            raise RuntimeError("encode failed")

        pub.publish = broken
        _bump(app)
        generation = app.snapshot_generation()
        health = json.loads(app.handle("/healthz")[2])
        block = health["runtime"]["replication"]
        assert health["ok"] is False and block["errors"] == 1
        assert block["last_error"] == "RuntimeError: encode failed"
        # The sync's own bookkeeping and the differ ran first.
        assert app.history.series("sync.generation")[1][-1] == generation
        assert app.push.generation == generation
        pub.publish = real
        _bump(app)
        health = json.loads(app.handle("/healthz")[2])
        assert health["ok"] is True and health["runtime"]["replication"]["published"] == 2
        assert health["runtime"]["replication"]["last_error"] == "RuntimeError: encode failed"
    finally:
        app.close()


def test_a_raising_on_elected_gives_the_term_back_and_fails_healthz():
    mono = FakeClock()
    _, app, pub = _leader(mono=mono)
    store = LeaseStore(monotonic=mono)
    broken = {"on": True}

    def elected(fencing):
        if broken["on"]:
            raise RuntimeError("floor refused")
        pub.set_fencing(fencing)
        app._ctx.advance_generation_floor(generation_floor(fencing))

    elector = LeaderElector(store, "leader", ttl_s=0.03, monotonic=mono,
                            on_elected=elected, ledger=app.ledger)
    pub.elector = elector
    try:
        with pytest.raises(RuntimeError):
            elector.tick()  # a direct tick propagates it
        # The term went back: no lease held, none left in the store.
        assert not elector.is_leader and store.holder() is None
        elector.start()
        _wait(lambda: elector.errors >= 2)
        health = json.loads(app.handle("/healthz")[2])
        block = health["runtime"]["replication"]["election"]
        assert health["ok"] is False and block["failing"] is True
        assert block["last_error"] == "RuntimeError: floor refused"
        broken["on"] = False
        _wait(lambda: elector.is_leader and not elector.failing)
        elector.stop()
        # The callback ran for the term that holds: its fencing and floor.
        fencing = elector.fencing
        assert pub.fencing == fencing and store.holder().fencing == fencing
        app._synced_snapshot()
        assert app.snapshot_generation() > generation_floor(fencing)
        assert json.loads(app.handle("/healthz")[2])["ok"] is True
    finally:
        elector.stop()
        app.close()


def _wait(pred, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.005)


def test_a_raising_apply_on_the_poll_thread_is_counted_and_retried():
    mono = FakeClock()
    _, app, pub = _leader(mono=mono)
    app._synced_snapshot()
    rep = _replica(mono)
    consumer = BusConsumer(rep, pub.payload_after, interval_s=0.01)
    real = rep.apply_record
    broken = {"on": True}

    def apply_record(record):
        if broken["on"]:
            raise KeyError("snapshot")
        return real(record)

    rep.apply_record = apply_record
    try:
        with pytest.raises(KeyError):
            consumer.poll_once()  # a direct poll propagates it
        assert consumer.cursor == 0 and consumer.errors == 0
        consumer.start()
        _wait(lambda: consumer.errors >= 2)
        health = json.loads(rep.handle("/healthz")[2])
        block = health["runtime"]["replication"]
        assert health["ok"] is False and block["last_error"] == "KeyError: 'snapshot'"
        assert block["cursor"] == 0 and block["applied"] == 0  # retried, never skipped
        broken["on"] = False
        _wait(lambda: rep.applied == 1)
        _wait(lambda: not consumer.failing)
        consumer.stop()
        assert consumer.cursor == 1 and json.loads(rep.handle("/healthz")[2])["ok"] is True
    finally:
        app.close()
        rep.close()
    assert consumer._thread is None


def test_the_consumer_and_the_probe_behave_as_jax():
    mono = FakeClock()
    _, app, pub = _leader(mono=mono)
    rep = _replica(mono)
    try:
        assert rep.stale() and rep.lag_s() is None
        # Before the first record: JAX's honest loading page, not a 5xx.
        got, want = rep.handle("/tpu"), JaxReplicaApp(clock=clock).handle("/tpu")
        assert got[0] == want[0] == 200
        assert re.search("<main>(.*)</main>", got[2], re.S).group(1) == re.search(
            "<main>(.*)</main>", want[2], re.S).group(1)
        app._synced_snapshot()
        _bump(app)
        consumer = BusConsumer(rep, pub.payload_after)
        assert consumer.poll_once() == 2 and consumer.cursor == app.snapshot_generation()
        assert consumer.poll_once() == 0 and consumer.cursor == app.snapshot_generation()
        mono.advance(12.5)
        assert rep.lag_s() == 12.5 and not rep.stale()
        # A foreign payload is a fetch failure, never applied.
        consumer._fetch = lambda cursor: '{"kind":"header","format":"x","v":1}\n'
        assert consumer.poll_once() == 0 and consumer.fetch_failures == 1
        with pytest.raises(RuntimeError):
            rep.start_background_sync(1.0)
        with pytest.raises(ApiError):
            rep._transport.request("/api/v1/nodes")
        # The probe degrades interactive renders only, as JAX's does.
        for policy_cls in (ShedPolicy, JaxShedPolicy):
            policy = policy_cls(engine=tslo.SLOEngine if policy_cls is ShedPolicy else None)
            policy.degraded_probe = lambda: True
            ruling = [policy.decide("/tpu", p).degraded
                      for p in (PRIORITY_INTERACTIVE, PRIORITY_OPS, PRIORITY_DEBUG)]
            assert ruling == [True, False, False]
        policy = ShedPolicy(engine=tslo.SLOEngine)
        policy.degraded_probe = lambda: 1 / 0
        assert policy.decide("/tpu", PRIORITY_INTERACTIVE).degraded and policy.probe_errors == 1
    finally:
        app.close()
        rep.close()


def test_the_leaders_tick_trace_shows_the_publish_after_the_differ():
    transport, app, pub = _leader(n=256)
    try:
        app._ctx.enable_watch()
        app._background_tick()
        tick = trace_ring.snapshot()[0]
        assert tick["route"] == "/sync"
        names = [s["name"] for s in tick["spans"]]
        assert names.index("push.diff") < names.index("replicate.publish")
        publish = next(s for s in tick["spans"] if s["name"] == "replicate.publish")
        attrs = {k: v for k, v in publish["attrs"].items() if k not in ("gc_full_ms", "gc_full")}
        assert attrs == {"generation": app.snapshot_generation()}
        publishing_trace = tick["trace_id"]
        app._background_tick()  # quiet: the same generation, rejected by the fence
        assert pub.published == 1 and pub.rejected_stale == 1
        # A quiet tick records no trace.
        assert [t["trace_id"] for t in trace_ring.snapshot() if t["route"] == "/sync"][0] == (
            publishing_trace
        )
        generations = {g["generation"]: g for g in app.ledger.snapshot()["generations"]}
        assert "published" in generations[app.snapshot_generation()]["stages"]
        # The record names the tick's trace as its publisher.
        _, records = parse_payload(pub.payload_after(None))
        assert records[0]["obs"]["trace_id"] == publishing_trace
    finally:
        app.close()


def test_the_replica_entry_point_needs_cuda_unless_asked_for_the_cpu(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(aot, "_REGISTRY", aot.AotProgramRegistry())
    seen = {}

    def wait(server):
        seen["app"] = type(server.app).__name__
        seen["healthz"] = json.loads(server.app.handle("/healthz")[2])
        seen["consumer"] = server.app.replication._thread is not None
        raise KeyboardInterrupt

    monkeypatch.setattr(app_mod.DashboardServer, "wait", wait)
    url = "http://127.0.0.1:9"  # nothing listens: the replica serves stale
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            server_main(["--replica", url, "--port", "0"])
    server_main(["--replica", url, "--device", "cpu", "--port", "0"])
    assert seen["app"] == "ReplicaApp" and seen["consumer"]
    runtime = seen["healthz"]["runtime"]
    assert runtime["replication"]["role"] == "replica"
    assert runtime["device"]["torch_device"] == "cpu"
    assert re.search(r"replica on http://127\.0\.0\.1:\d+/tpu \(bus http://127\.0\.0\.1:9, "
                     r"device cpu\)", capsys.readouterr().out)
    for extra in (["--demo", "v5e4"], ["--replication-leader"], ["--background-sync", "5"]):
        with pytest.raises(SystemExit):
            server_main(["--replica", url, "--device", "cpu", *extra])

"""The port's segment consumer and the worker seed, on the CPU.

A ``ShmConsumer`` applies a leader's generation off the segment once; a
missing, version-gated or corrupt segment is a counted and named rung
down to the bus, and a dead bus degrades the worker to stale-honest
serving with ``ok`` still true. After an apply the consumer seeds the
segment's columns into the worker's own fleet cache at the generation's
version, so the first render of it calls ``encode_fleet`` 0 times and
opens no ``device_cache.upload`` span. A seed that raises is counted,
named and holds ``/healthz`` ``ok`` false until a later seed succeeds,
and installs nothing; an apply that raises on the poll thread does the
same until a record applies. On the leader a mirror that overflows or
raises is counted and named while the bus carries the generation. A JAX
leader's segment feeds a port worker as its bus feeds a port replica.
"""

from __future__ import annotations

import json
import warnings

import numpy as np
import pytest

from headlamp_tpu import workers as jworkers
from headlamp_tpu.server.app import DashboardApp as JaxApp
from headlamp_tpu.server.app import add_demo_prometheus as jax_add_prometheus
from headlamp_tpu.fleet import fixtures as jfx
from headlamp_tpu_torch.analytics import encode as encode_mod
from headlamp_tpu_torch.fleet import fixtures as tfx
from headlamp_tpu_torch.obs import slo as tslo
from headlamp_tpu_torch.obs.trace import trace_request, trace_ring
from headlamp_tpu_torch.replicate import ReplicaApp, parse_payload
from headlamp_tpu_torch.runtime import columns as tcolumns
from headlamp_tpu_torch.runtime import device_cache
from headlamp_tpu_torch.runtime.device_cache import warm_carries
from headlamp_tpu_torch.server import DashboardApp
from headlamp_tpu_torch.server.demo import add_demo_prometheus
from headlamp_tpu_torch.workers import (
    SegmentBusPublisher,
    ShmConsumer,
    SnapshotSegment,
    WorkerStatusBoard,
)

CLOCK = 1785283200.0


def clock():
    return CLOCK


@pytest.fixture(autouse=True)
def fresh_engine(monkeypatch):
    monkeypatch.setattr(tslo, "_engine", tslo.SLOEngine())
    warm_carries.invalidate()


def _leader(path, size=8 << 20):
    # 64 TPU nodes: the rollup runs on the device path, through the cache.
    fleet = tfx.fleet_viewport(64)
    transport = tfx.fleet_transport(fleet)
    add_demo_prometheus(transport, fleet)
    app = DashboardApp(transport, device="cpu", clock=clock, min_sync_interval_s=30.0)
    seg = SnapshotSegment(str(path), size=size)
    pub = SegmentBusPublisher(seg, wall=clock, ledger=app.ledger)
    app.replication = pub
    app._synced_snapshot()
    return app, pub, seg


def _bump(app):
    app._ctx.advance_generation_floor(app.snapshot_generation() + 1)
    app._last_sync = float("-inf")
    app._synced_snapshot()


def _span_names(spans):
    return [s["name"] for s in spans] + [
        n for s in spans for n in _span_names(s["children"])]


def _health(app):
    return json.loads(app.handle("/healthz")[2])


def test_the_segment_feed_applies_once_and_reports_the_worker_role(tmp_path):
    app, pub, seg = _leader(tmp_path / "l.seg")
    rep = ReplicaApp(device="cpu", clock=clock, monotonic=lambda: 1000.0)
    board = WorkerStatusBoard.create(str(tmp_path / "b.wsb"), n_slots=1)
    consumer = ShmConsumer(rep, seg.path, slot=board.slot(0))
    try:
        assert consumer.poll_once() == 1 and consumer.poll_once() == 0
        assert (consumer.applied_shm, consumer.applied_fallback, rep.applied) == (1, 0, 1)
        assert rep.snapshot_generation() == app.snapshot_generation() == consumer.cursor
        assert board.rows()[0]["generations_applied"] == 1
        block = _health(rep)["runtime"]["replication"]
        assert block == consumer.snapshot()
        assert block["role"] == "worker" and block["segment_attached"] is True
        # One seed per provider, TPU and Intel, as JAX's worker seeds.
        assert block["seeds"] == 2 and block["seed_errors"] == 0 and block["stale"] is False
        assert rep.handle("/tpu") == app.handle("/tpu")
    finally:
        rep.close()
        app.close()
        seg.close()
        board.close()


@pytest.mark.parametrize("rung", ["missing", "version", "corrupt_record"])
def test_each_segment_rung_is_counted_named_and_the_bus_supplies_it(tmp_path, rung):
    app, pub, seg = _leader(tmp_path / "l.seg")
    rep = ReplicaApp(device="cpu", clock=clock)
    path = seg.path
    gated = None
    if rung == "missing":
        path = str(tmp_path / "never-created.seg")
    elif rung == "version":
        gated = SnapshotSegment(str(tmp_path / "gated.seg"), size=1 << 20, version=99)
        path = gated.path
    consumer = ShmConsumer(rep, path, fallback_fetch=pub.payload_after)
    try:
        if rung == "corrupt_record":
            assert consumer.poll_once() == 1  # the first generation off the segment
            before = rep.snapshot_generation()
            _bump(app)
            # A clean seqlock around an unparseable record: never half-applied.
            seg.publish("{not json", {}, generation=app.snapshot_generation())
        assert consumer.poll_once() == 1
        assert consumer.attach_failures == 1 and consumer.applied_fallback == 1
        assert consumer.last_attach_error.split(":")[0] == {
            "missing": "SegmentUnavailable", "version": "SegmentVersionGated",
            "corrupt_record": "JSONDecodeError"}[rung]
        assert rep.snapshot_generation() == app.snapshot_generation()
        if rung == "corrupt_record":
            assert rep.snapshot_generation() > before and consumer.seeds == 2
        assert rep.handle("/tpu") == app.handle("/tpu")
        assert _health(rep)["ok"] is True
    finally:
        rep.close()
        app.close()
        seg.close()
        if gated is not None:
            gated.close()


def test_a_dead_bus_degrades_to_stale_honest_serving(tmp_path):
    rep = ReplicaApp(device="cpu", clock=clock)

    def dead(cursor):
        raise OSError("connection refused")

    consumer = ShmConsumer(rep, str(tmp_path / "missing.seg"), fallback_fetch=dead)
    try:
        assert consumer.poll_once() == 0
        assert (consumer.attach_failures, consumer.fallback_failures) == (1, 1)
        assert consumer.last_fetch_error == "OSError: connection refused"
        health = _health(rep)
        assert health["ok"] is True and health["runtime"]["replication"]["stale"] is True
        assert rep.handle("/tpu")[0] == 200
    finally:
        rep.close()


def test_the_seed_makes_the_first_render_encode_nothing(tmp_path, monkeypatch):
    app, pub, seg = _leader(tmp_path / "l.seg")
    rep = ReplicaApp(device="cpu", clock=clock)
    consumer = ShmConsumer(rep, seg.path)
    encodes = []
    real = encode_mod.encode_fleet
    monkeypatch.setattr(encode_mod, "encode_fleet", lambda *a: encodes.append(1) or real(*a))
    try:
        assert consumer.poll_once() == 1 and encodes == []
        cache = rep._ctx.fleet_cache
        providers = rep._last_snapshot.providers
        assert cache.seeds == consumer.seeds == len(providers)
        for name, state in providers.items():
            version, fleet = cache._entries[name]
            assert version == state.view.version == rep.snapshot_generation()
            want = real(state.view.nodes, state.view.pods)
            for field in tcolumns.ARRAY_FIELDS:
                assert np.array_equal(getattr(fleet, field).numpy(), getattr(want, field))
        encodes.clear()
        first = rep.handle("/tpu")
        trace = next(t for t in trace_ring.snapshot() if t["route"] == "/tpu")  # newest first
        names = _span_names(trace["spans"])
        assert "device_cache.upload" not in names and "analytics.rollup" in names
        assert first == app.handle("/tpu") and rep.handle("/tpu/fleet") == app.handle("/tpu/fleet")
        assert rep._ctx.fleet_cache.counters() == {"hits": 2, "misses": 0, "uploads": 0}
        # Only the leader's paints encoded; the worker's encoded nothing.
        assert len(encodes) == app._ctx.fleet_cache.uploads
        assert _health(rep)["runtime"]["fleet_cache"]["seeds"] == 2
    finally:
        rep.close()
        app.close()
        seg.close()


def test_a_seed_that_raises_installs_nothing_and_turns_ok_false(tmp_path, monkeypatch):
    app, pub, seg = _leader(tmp_path / "l.seg")
    rep = ReplicaApp(device="cpu", clock=clock)
    consumer = ShmConsumer(rep, seg.path)
    real = device_cache._to_device

    def broken(fleet, device):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(device_cache, "_to_device", broken)
    try:
        assert consumer.poll_once() == 1  # applied; the seed failed after it
        assert (consumer.seeds, consumer.seed_errors) == (0, 1)
        assert consumer.last_seed_error == "RuntimeError: CUDA error: out of memory"
        assert rep._ctx.fleet_cache._entries == {}
        health = _health(rep)
        assert health["ok"] is False
        assert health["runtime"]["replication"]["last_seed_error"] == consumer.last_seed_error
        monkeypatch.setattr(device_cache, "_to_device", real)
        assert rep.handle("/tpu") == app.handle("/tpu")  # a plain cache miss encodes
        assert _health(rep)["ok"] is False
        _bump(app)
        assert consumer.poll_once() == 1 and consumer.seeds == 2
        assert _health(rep)["ok"] is True and consumer.seed_errors == 1
    finally:
        rep.close()
        app.close()
        seg.close()


def test_the_seed_keeps_the_caches_publish_contract():
    fleet = tfx.fleet_v5e4()
    rep = ReplicaApp(device="cpu", clock=clock)
    cache = rep._ctx.fleet_cache
    cols = encode_mod.encode_fleet(fleet["nodes"], fleet["pods"])
    blob = tcolumns.pack_fleet(cols)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # read-only views upload with no warning
            cache.seed("tpu", 5, tcolumns.unpack_fleet(blob))
            newer = cache._entries["tpu"][1]
            cache.seed("tpu", 4, tcolumns.unpack_fleet(bytearray(blob)))  # older: kept out
            assert cache._entries["tpu"] == (5, newer)
            cache.seed("tpu", 5, tcolumns.unpack_fleet(bytearray(blob)))  # equal: replaces
        assert cache._entries["tpu"][0] == 5 and cache._entries["tpu"][1] is not newer
        assert cache.seeds == 3 and cache.uploads == 0
        assert cache.snapshot()["seeds"] == 3 and "seeds" not in cache.counters()
    finally:
        rep.close()


def test_an_apply_that_raises_on_the_poll_thread_is_counted(tmp_path, monkeypatch):
    app, pub, seg = _leader(tmp_path / "l.seg")
    rep = ReplicaApp(device="cpu", clock=clock)
    consumer = ShmConsumer(rep, seg.path)
    real = rep.apply_record

    def broken(record):
        raise KeyError("snapshot")

    monkeypatch.setattr(rep, "apply_record", broken)
    try:
        assert consumer.tick() == 0
        assert consumer.errors == 1 and consumer.last_error == "KeyError: 'snapshot'"
        assert _health(rep)["ok"] is False and consumer.counters()["errors"] == 1
        monkeypatch.setattr(rep, "apply_record", real)
        consumer.start()
        try:
            deadline = 200
            while rep.applied == 0 and deadline:
                consumer._stop.wait(0.02)
                deadline -= 1
        finally:
            consumer.stop()
        assert rep.applied == 1 and _health(rep)["ok"] is True and consumer._thread is None
    finally:
        rep.close()
        app.close()
        seg.close()


def test_a_mirror_that_fails_is_counted_and_the_bus_carries_the_generation(tmp_path,
                                                                          monkeypatch):
    app, pub, seg = _leader(tmp_path / "tiny.seg", size=4096)  # too small for a record
    try:
        assert pub.published == 1 and pub.segment_publishes == 0
        assert pub.segment_failures == 1 and seg.overflows == 1
        assert pub.last_segment_error.startswith("overflow: generation 1")

        def broken(*a, **k):
            raise OSError("mmap closed")

        monkeypatch.setattr(seg, "publish", broken)
        _bump(app)
        assert pub.published == 2 and pub.segment_failures == 2
        assert pub.last_segment_error == "OSError: mmap closed"
        block = _health(app)["runtime"]["replication"]
        assert block["segment_failures"] == 2 and block["last_segment_error"] == pub.last_segment_error
        assert _health(app)["ok"] is True
        _, records = parse_payload(pub.payload_after(0))
        assert [r["generation"] for r in records] == [1, app.snapshot_generation()]
        monkeypatch.undo()
        with trace_request("/sync") as trace:
            _bump(app)
        assert pub.segment_failures == 3  # still too small: counted again
        assert "workers.segment" in _span_names(trace.to_dict()["spans"])
    finally:
        app.close()
        seg.close()


def test_a_jax_leaders_segment_feeds_a_port_worker(tmp_path):
    fleet = jfx.fleet_v5e4()
    transport = jfx.fleet_transport(fleet)
    jax_add_prometheus(transport, fleet)
    japp = JaxApp(transport, min_sync_interval_s=30.0)
    jseg = jworkers.SnapshotSegment(str(tmp_path / "jax.seg"), size=8 << 20)
    jpub = jworkers.SegmentBusPublisher(jseg, wall=clock)
    japp.replication = jpub
    japp._synced_snapshot()
    worker = ReplicaApp(device="cpu", clock=clock)
    replica = ReplicaApp(device="cpu", clock=clock)
    consumer = ShmConsumer(worker, jseg.path)
    try:
        assert consumer.poll_once() == 1 and consumer.applied_shm == 1
        # Both providers' columns are seeded, Intel's included, as JAX's
        # worker seeds them.
        assert set(worker._ctx.fleet_cache._entries) == {"tpu", "intel"}
        assert consumer.seeds == 2
        _, records = parse_payload(jpub.payload_after(0))
        assert all(replica.apply_record(r) for r in records)
        assert worker.snapshot_generation() == replica.snapshot_generation()
        for path in ("/tpu", "/tpu/nodes", "/tpu/fleet"):
            assert worker.handle(path) == replica.handle(path), path
    finally:
        worker.close()
        replica.close()
        jseg.close()


def test_readers_racing_a_writer_never_see_a_torn_frame(tmp_path):
    # The seqlock under contention: a writer thread publishes generations
    # back to back while more reader threads than cores read, with the
    # interpreter switching threads as often as it can. A frame whose
    # header generation differs from its record's (or whose columns are
    # not that generation's) would be a torn read.
    import os
    import sys
    import threading

    from headlamp_tpu_torch.workers import SegmentCorrupt, SegmentReader

    fleet = tfx.fleet_v5e4()
    base = encode_mod.encode_fleet(fleet["nodes"], fleet["pods"])
    seg = SnapshotSegment(str(tmp_path / "race.seg"), size=1 << 20)
    stop = threading.Event()
    torn, frames, unstable = [], [0], [0]

    def write():
        generation = 0
        while not stop.is_set():
            generation += 1
            cols = {"tpu": type(base)(**{**base.__dict__, "node_generation":
                                         base.node_generation + generation + 10**8})}
            # Records of one length: a torn read parses, and shows.
            seg.publish(json.dumps({"generation": generation + 10**8}), cols,
                        generation=generation + 10**8)

    def read():
        reader = SegmentReader(seg.path)
        try:
            while not stop.is_set():
                try:
                    frame = reader.read()
                except SegmentCorrupt:
                    unstable[0] += 1
                    continue
                if frame is None:
                    continue
                gen = frame.generation
                got = frame.columns["tpu"].node_generation - base.node_generation
                if frame.record()["generation"] != gen or not (got == gen).all():
                    torn.append(gen)
                frames[0] += 1
        finally:
            reader.close()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=write)] + [
        threading.Thread(target=read) for _ in range((os.cpu_count() or 1) + 2)]
    try:
        for t in threads:
            t.start()
        stop.wait(1.5)
    finally:
        stop.set()
        for t in threads:
            t.join(10.0)
        sys.setswitchinterval(interval)
        seg.close()
    assert not any(t.is_alive() for t in threads)
    assert torn == [] and frames[0] > 0

"""The port's shared-memory snapshot plane against JAX's, on the CPU.

``pack_fleet`` gives JAX's blob byte for byte for the same columns (each
provider's, the Intel view's included), and
both packages' ``unpack_fleet`` refuse the same foreign, truncated and
incomplete blobs. For one generation of one fleet the port's leader
writes the segment JAX's leader writes, byte for byte over the written
range (the header, the bus record line, the packed columns), and each
package's reader reads the other's segment. The ladder's rungs (missing,
version-gated, corrupt, a wedged seqlock, an overflow) are raised alike.
The status board's file equals JAX's after the same slot writes, its
``headlamp_tpu_torch_worker_*`` families render every worker's counters
and ``/healthz`` shows ``runtime.workers``. The front door: the strategy
probe, the round-robin proxy, ``serve()`` adopting a shared listener and
two hosts binding one port with ``SO_REUSEPORT``, and the worker identity
on the push snapshot and on ``/events``.
"""

from __future__ import annotations

import http.client
import json
import socket
import struct

import numpy as np
import pytest

from headlamp_tpu import workers as jworkers
from headlamp_tpu.analytics.encode import encode_fleet as jax_encode_fleet
from headlamp_tpu.context.accelerator_context import AcceleratorDataContext as JaxContext
from headlamp_tpu.fleet import fixtures as jfx
from headlamp_tpu.runtime import columns as jcolumns
from headlamp_tpu_torch import workers as tworkers
from headlamp_tpu_torch.analytics.encode import encode_fleet
from headlamp_tpu_torch.context import AcceleratorDataContext
from headlamp_tpu_torch.fleet import fixtures as tfx
from headlamp_tpu_torch.push.hub import set_worker_identity, worker_identity
from headlamp_tpu_torch.replicate import ReplicaApp
from headlamp_tpu_torch.runtime import columns as tcolumns
from headlamp_tpu_torch.workers.shm import HEADER_SIZE
from headlamp_tpu_torch.workers.worker import _BoardHealth

CLOCK = 1785283200.0
FLEETS = ("fleet_v5p32_degraded", "fleet_large")


def clock():
    return CLOCK


def _fleet(name):
    return {"fleet_large": lambda m: m.fleet_large(256)}.get(name, lambda m: getattr(m, name)())


def _snapshots(name):
    """One fleet synced by each package's context, both with the TPU and
    the Intel provider."""
    make = _fleet(name)
    jctx = JaxContext(jfx.fleet_transport(make(jfx)), clock=clock)
    with AcceleratorDataContext(tfx.fleet_transport(make(tfx)), device="cpu",
                                clock=clock) as tctx:
        return jctx.sync(), tctx.sync()


def _columns(jsnap, tsnap, provider="tpu"):
    jview, tview = jsnap.providers[provider].view, tsnap.providers[provider].view
    return jax_encode_fleet(jview.nodes, jview.pods), encode_fleet(tview.nodes, tview.pods)


@pytest.mark.parametrize("name", FLEETS)
def test_pack_fleet_equals_jax_byte_for_byte(name):
    jsnap, tsnap = _snapshots(name)
    # The Intel view's packed columns too: a worker seeds them.
    jintel, tintel = _columns(jsnap, tsnap, "intel")
    assert tcolumns.pack_fleet(tintel) == jcolumns.pack_fleet(jintel)
    jfleet, tfleet = _columns(jsnap, tsnap)
    blob = tcolumns.pack_fleet(tfleet)
    assert blob == jcolumns.pack_fleet(jfleet) and blob == tcolumns.pack_fleet(tfleet)
    assert tcolumns.COLUMNS_MAGIC == jcolumns.COLUMNS_MAGIC
    assert tcolumns.ARRAY_FIELDS == jcolumns.ARRAY_FIELDS
    # Views over the blob, no copy; writable only over a writable buffer.
    for source, writable in ((blob, False), (bytearray(blob), True)):
        out = tcolumns.unpack_fleet(source)
        assert (out.n_nodes, out.n_pods, out.node_names) == (
            tfleet.n_nodes, tfleet.n_pods, list(tfleet.node_names))
        for field in tcolumns.ARRAY_FIELDS:
            arr = getattr(out, field)
            assert np.array_equal(arr, getattr(tfleet, field)), field
            assert arr.dtype == getattr(jfleet, field).dtype, field
            assert not arr.flags["OWNDATA"] and arr.flags.writeable is writable, field


def test_both_unpackers_refuse_the_same_blobs():
    _, tfleet = _columns(*_snapshots("fleet_v5e4"))
    blob = tcolumns.pack_fleet(tfleet)
    toc_len = struct.unpack_from("<I", blob, 8)[0]
    toc = json.loads(blob[12:12 + toc_len])
    toc["columns"] = [c for c in toc["columns"] if c[0] != "pod_valid"]
    short_toc = json.dumps(toc, sort_keys=True, separators=(",", ":")).encode()
    missing = b"HLTPCOL1" + struct.pack("<I", len(short_toc)) + short_toc + b"\0" * 64
    for bad in (b"", b"HLTP", b"XXXXXXXX" + blob[8:], blob[: len(blob) // 2], blob[:20],
                missing):
        messages = []
        for mod in (jcolumns, tcolumns):
            with pytest.raises(ValueError) as err:
                mod.unpack_fleet(bad)
            messages.append(str(err.value))
        assert messages[0] == messages[1]


def _publish_both(tmp_path, name, generation=7):
    jsnap, tsnap = _snapshots(name)
    jseg = jworkers.SnapshotSegment(str(tmp_path / "jax.seg"), size=8 << 20)
    tseg = tworkers.SnapshotSegment(str(tmp_path / "torch.seg"), size=8 << 20)
    jpub = jworkers.SegmentBusPublisher(jseg, wall=clock)
    tpub = tworkers.SegmentBusPublisher(tseg, wall=clock)
    assert jpub.publish(jsnap, generation=generation)
    assert tpub.publish(tsnap, generation=generation)
    return (jseg, jpub), (tseg, tpub), tsnap


@pytest.mark.parametrize("name", FLEETS + ("fleet_mixed",))
def test_one_generations_segment_equals_jaxs_byte_for_byte(tmp_path, name):
    (jseg, jpub), (tseg, tpub), _ = _publish_both(tmp_path, name)
    try:
        assert tpub.segment_publishes == jpub.segment_publishes == 1
        assert tpub.segment_failures == 0 and tpub.last_segment_error is None
        assert tpub._backlog[-1][1] == jpub._backlog[-1][1]
        jbytes, tbytes = bytes(jseg._map), bytes(tseg._map)
        cols_off, cols_len = struct.unpack_from("<QQ", tbytes, 56)
        written = cols_off + cols_len
        assert written > HEADER_SIZE and tbytes[:written] == jbytes[:written]
        # Each package reads the other's segment.
        jframe = jworkers.SegmentReader(tseg.path).read()
        tframe = tworkers.SegmentReader(jseg.path).read()
        assert tframe.record_line == jframe.record_line == tpub._backlog[-1][1]
        assert (tframe.generation, tframe.fencing) == (jframe.generation, jframe.fencing) == (7, 0)
        assert set(tframe.columns) == set(jframe.columns) == {"tpu", "intel"}
        for provider in ("tpu", "intel"):
            for field in tcolumns.ARRAY_FIELDS:
                got = getattr(tframe.columns[provider], field)
                assert np.array_equal(got, getattr(jframe.columns[provider], field))
                assert got.flags.writeable, field  # the frame owns a bytearray
        if name == "fleet_mixed":
            assert (tframe.columns["intel"].n_nodes, tframe.columns["intel"].n_pods) == (2, 2)
    finally:
        jseg.close()
        tseg.close()


def test_the_ladders_rungs_are_raised_as_jaxs(tmp_path):
    outcomes = {}
    for label, mod in (("jax", jworkers), ("torch", tworkers)):
        root = tmp_path / label
        root.mkdir()
        rungs = []

        def rung(fn):
            try:
                fn()
            except mod.SegmentError as e:
                rungs.append(type(e).__name__)
            else:
                rungs.append("none")

        rung(lambda: mod.SegmentReader(str(root / "missing.seg")))
        gated = mod.SnapshotSegment(str(root / "v.seg"), size=1 << 20, version=99)
        rung(lambda: mod.SegmentReader(gated.path))
        (root / "junk.seg").write_bytes(b"not a segment at all" * 100)
        rung(lambda: mod.SegmentReader(str(root / "junk.seg")))
        (root / "short.seg").write_bytes(b"HL")
        rung(lambda: mod.SegmentReader(str(root / "short.seg")))
        seg = mod.SnapshotSegment(str(root / "w.seg"), size=1 << 20)
        reader = mod.SegmentReader(seg.path)
        assert reader.generation() == 0 and reader.read() is None
        assert seg.publish('{"generation":1}', {}, generation=1) and reader.generation() == 1
        struct.pack_into("<Q", seg._map, 16, 3)  # a writer that died mid-publish
        rung(reader.read)
        tiny = mod.SnapshotSegment(str(root / "s.seg"), size=HEADER_SIZE + 64)
        assert not tiny.publish("x" * 4096, {}, generation=1)
        assert (tiny.overflows, tiny.published) == (1, 0)
        assert mod.SegmentReader(tiny.path).read() is None  # the header never flipped
        outcomes[label] = rungs
        for s in (gated, seg, tiny):
            s.close()
        reader.close()
    assert outcomes["torch"] == outcomes["jax"] == [
        "SegmentUnavailable", "SegmentVersionGated", "SegmentCorrupt", "SegmentCorrupt",
        "SegmentCorrupt",
    ]
    for port in (8631, 8632):
        for kind in ("seg", "wsb"):
            assert tworkers.default_segment_path(port, kind=kind) == (
                jworkers.default_segment_path(port, kind=kind))
    assert tworkers.default_segment_path(8631) != tworkers.default_segment_path(8632)


def test_the_status_board_equals_jaxs_and_refuses_what_jaxs_does(tmp_path):
    boards = []
    for label, mod in (("jax", jworkers), ("torch", tworkers)):
        board = mod.WorkerStatusBoard.create(str(tmp_path / f"{label}.wsb"), n_slots=3)
        s0, s1 = board.slot(0), board.slot(1)
        s0.pid = s1.pid = 4242  # the file holds the pid: pin it for the comparison
        s0.applied(5)
        s0.applied(6)
        s1.attach_failure()
        s1.fallback_decode()
        with pytest.raises(ValueError):
            board.slot(3)
        boards.append(board)
    jboard, tboard = boards
    try:
        assert bytes(tboard._map) == bytes(jboard._map)
        assert tboard.rows() == jboard.rows()
        assert [r["worker"] for r in tboard.rows()] == [0, 1]  # slot 2 never registered
        assert tboard.samples("generations_applied") == [(("w0",), 2), (("w1",), 0)]
        assert tboard.snapshot(self_id=1) == jboard.snapshot(self_id=1)
        assert tboard.snapshot(self_id=1)["live"] == 2
        # Another attachment (another process) reads the slots, JAX's too.
        other = tworkers.WorkerStatusBoard.attach(jboard.path)
        assert other.rows() == jboard.rows()
        other.close()
        (tmp_path / "junk.wsb").write_bytes(b"x" * 256)
        (tmp_path / "short.wsb").write_bytes(b"x")
        for junk in ("junk.wsb", "short.wsb"):
            with pytest.raises(ValueError):
                tworkers.WorkerStatusBoard.attach(str(tmp_path / junk))
    finally:
        jboard.close()
        tboard.close()


def test_metric_families_and_healthz_show_every_worker(tmp_path):
    board = tworkers.WorkerStatusBoard.create(str(tmp_path / "m.wsb"), n_slots=2)
    board.slot(0).applied(3)
    slot1 = board.slot(1)
    slot1.applied(4)
    slot1.fallback_decode()
    tworkers.register_worker_metrics(board)
    rep = ReplicaApp(device="cpu")
    try:
        body = rep.handle("/metricsz")[2]
        for line in (
            'headlamp_tpu_torch_worker_generations_applied_total{worker="w0"} 1',
            'headlamp_tpu_torch_worker_generations_applied_total{worker="w1"} 1',
            'headlamp_tpu_torch_worker_fallback_decodes_total{worker="w1"} 1',
            'headlamp_tpu_torch_worker_shm_attach_failures_total{worker="w0"} 0',
            "# TYPE headlamp_tpu_torch_worker_generations_applied_total counter",
        ):
            assert line in body, line
        assert "headlamp_tpu_worker_" not in body
        assert "workers" not in json.loads(rep.handle("/healthz")[2])["runtime"]
        rep.workers = _BoardHealth(board, 1)
        health = json.loads(rep.handle("/healthz")[2])
        block = health["runtime"]["workers"]
        assert block == board.snapshot(self_id=1)
        assert (block["self"], block["slots"], block["live"]) == ("w1", 2, 2)
        assert block["workers"][1]["generation"] == 4 and health["ok"] is True
    finally:
        rep.close()
        board.close()


def test_the_front_door_strategies():
    assert tworkers.pick_strategy() == jworkers.pick_strategy() == (
        "reuseport" if tworkers.reuseport_supported() else "fd-passing")
    bal = tworkers.RoundRobinBalancer("127.0.0.1", 0, [("127.0.0.1", 1001), ("127.0.0.1", 1002)])
    assert [bal.pick()[1] for _ in range(4)] == [1001, 1002, 1001, 1002]
    assert bal.snapshot()["connections"] == 4
    bal.stop()
    with pytest.raises(ValueError):
        tworkers.RoundRobinBalancer("127.0.0.1", 0, [])
    backend = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    backend.bind(("127.0.0.1", 0))
    backend.listen(4)
    bal = tworkers.RoundRobinBalancer("127.0.0.1", 0, [backend.getsockname()])
    bal.start()
    try:
        client = socket.create_connection(bal.address, timeout=5.0)
        upstream, _ = backend.accept()
        client.sendall(b"ping")
        assert upstream.recv(64) == b"ping"
        upstream.sendall(b"pong")
        assert client.recv(64) == b"pong"
        client.close()
        upstream.close()
    finally:
        bal.stop()
        backend.close()
    assert not bal._threads


def _get(port, path, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def test_serve_adopts_a_shared_listener_or_binds_with_reuse_port():
    listener = tworkers.shared_listener("127.0.0.1", 0)
    port = listener.getsockname()[1]
    rep = ReplicaApp(device="cpu")
    server = rep.serve("127.0.0.1", port, listen_socket=listener)
    try:
        assert server._httpd.socket is listener and server.url.endswith(f":{port}")
        assert _get(port, "/healthz")[0] == 200
    finally:
        server.close()
    if not tworkers.reuseport_supported():
        return
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    apps = [ReplicaApp(device="cpu") for _ in range(2)]
    servers = [a.serve("127.0.0.1", port, reuse_port=True) for a in apps]
    try:
        assert all(s.url.endswith(f":{port}") for s in servers)
        assert {_get(port, "/healthz")[0] for _ in range(4)} == {200}
    finally:
        for s in servers:
            s.close()
    # The default stays a plain bind: a second host on a taken port fails.
    first = ReplicaApp(device="cpu").serve("127.0.0.1", 0)
    try:
        with pytest.raises(OSError):
            ReplicaApp(device="cpu").serve("127.0.0.1", int(first.url.rsplit(":", 1)[1]))
    finally:
        first.close()


def test_the_worker_identity_stamps_the_push_snapshot_and_events():
    rep = ReplicaApp(device="cpu")
    server = None
    try:
        assert worker_identity() is None and "worker" not in rep.push.hub.snapshot()
        set_worker_identity("w3")
        assert rep.push.hub.snapshot()["worker"] == "w3"
        server = rep.serve("127.0.0.1", 0)
        conn = http.client.HTTPConnection("127.0.0.1", int(server.url.rsplit(":", 1)[1]),
                                          timeout=10)
        conn.request("GET", "/events")
        resp = conn.getresponse()
        assert resp.status == 200 and resp.getheader("X-Headlamp-Worker") == "w3"
        conn.close()
    finally:
        set_worker_identity(None)
        if server is not None:
            server.close()
        else:
            rep.close()

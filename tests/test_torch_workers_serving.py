"""The port's workers serving a leader's generations, on the CPU.

Two segment-fed workers (``ReplicaApp`` + ``ShmConsumer``) paint the
leader's eight pages byte for byte for the same generation, answer with
its ETags, turn its ETag into a 304 and write the leader's ``/events``
wire for a fleet change; their metrics paint is the record's forecast and
launches nothing. The leader-kill drill on injected clocks: the segment
freezes, the bus dies, every paint is stamped stale and none is a 5xx.
The supervisor starts its workers with ``spawn`` (never a fork of a
process that may hold a CUDA context), every argument of ``worker_main``
pickles, and ``stop`` joins and unlinks what ``start`` made. The entry
point's ``--workers`` excludes ``--replica`` and
``--replication-leader``, and needs CUDA unless ``--device cpu`` is
given. The slow test runs ``--workers 2 --device cpu`` as processes.
"""

from __future__ import annotations

import copy
import json
import os
import pickle
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from headlamp_tpu_torch.fleet import fleet_transport, fleet_viewport
from headlamp_tpu_torch.models.fused_forward import LAUNCHES
from headlamp_tpu_torch.obs import slo as tslo
from headlamp_tpu_torch.push import format_event
from headlamp_tpu_torch.replicate import ReplicaApp
from headlamp_tpu_torch.runtime.device_cache import warm_carries
from headlamp_tpu_torch.server import DashboardApp
from headlamp_tpu_torch.server.__main__ import main as server_main
from headlamp_tpu_torch.server.demo import add_demo_prometheus
from headlamp_tpu_torch.workers import (
    SegmentBusPublisher,
    ShmConsumer,
    SnapshotSegment,
    WorkerSupervisor,
    worker_main,
)
from headlamp_tpu_torch.workers import supervisor as supervisor_mod

CLOCK = 1785283200.0
PAGES = ("/tpu", "/tpu/nodes", "/tpu/pods", "/tpu/topology", "/tpu/metrics",
         "/tpu/deviceplugins", "/tpu/fleet", "/tpu/trends")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    monkeypatch.setattr(tslo, "_engine", tslo.SLOEngine())
    warm_carries.invalidate()


def _bump(app):
    app._ctx.advance_generation_floor(app.snapshot_generation() + 1)
    app._last_sync = float("-inf")
    app._synced_snapshot()


def _plane(tmp_path, mono, n=2, fallback=False):
    """A leader publishing into a segment, primed so its record ships the
    metrics and forecast peeks, and ``n`` workers that applied it."""
    fleet = fleet_viewport(64)
    transport = fleet_transport(fleet)
    add_demo_prometheus(transport, fleet)
    app = DashboardApp(transport, device="cpu", clock=clock, min_sync_interval_s=30.0,
                       monotonic=mono)
    app.history.capture_timings = False
    seg = SnapshotSegment(str(tmp_path / "plane.seg"), size=8 << 20)
    pub = SegmentBusPublisher(seg, monotonic=mono, wall=clock, ledger=app.ledger)
    app.replication = pub
    app._synced_snapshot()
    workers = []
    for _ in range(n):
        rep = ReplicaApp(device="cpu", clock=clock, monotonic=mono, stale_after_s=30.0)
        rep.history.capture_timings = False
        consumer = ShmConsumer(rep, seg.path,
                               fallback_fetch=pub.payload_after if fallback else None)
        workers.append((rep, consumer))
    # Each worker applies both generations, so its history (and
    # /tpu/trends) holds what the leader's does.
    assert [c.poll_once() for _, c in workers] == [1] * n
    assert app.handle("/tpu/metrics")[0] == 200
    _bump(app)
    assert [c.poll_once() for _, c in workers] == [1] * n
    return transport, app, pub, seg, workers


def _close(app, seg, workers):
    for rep, _ in workers:
        rep.close()
    app.close()
    seg.close()


def test_workers_paint_the_leaders_bytes_and_fit_nothing(tmp_path):
    _, app, _, seg, workers = _plane(tmp_path, FakeClock())
    try:
        launches = LAUNCHES.n
        for path in PAGES:
            want = app.handle(path)
            assert want[0] == 200, path
            for rep, _ in workers:
                assert rep.handle(path) == want, path
        assert "Utilization Forecast" in workers[0][0].handle("/tpu/metrics")[2]
        assert LAUNCHES.n == launches
        # Two generations, each seeding both providers' columns.
        assert all(c.applied_shm == 2 and c.seeds == 4 for _, c in workers)
    finally:
        _close(app, seg, workers)


def test_workers_answer_the_leaders_etags_and_304s(tmp_path):
    _, app, _, seg, workers = _plane(tmp_path, FakeClock())
    gateways = [app.ensure_gateway(workers=1)] + [r.ensure_gateway(workers=1) for r, _ in workers]
    try:
        for path in ("/tpu", "/tpu/nodes?limit=5", "/tpu/fleet"):
            responses = [gw.handle(path) for gw in gateways]
            assert len({r.body for r in responses}) == 1, path
            assert len({json.dumps(dict(r.headers), sort_keys=True) for r in responses}) == 1
            etag = dict(responses[0].headers)["ETag"]
            # A client may land on any worker with its validator.
            assert [gw.handle(path, if_none_match=etag).status for gw in gateways] == [304] * 3
    finally:
        _close(app, seg, workers)


def test_workers_write_the_leaders_events_wire(tmp_path):
    transport, app, _, seg, workers = _plane(tmp_path, FakeClock())
    pages = ("/tpu", "/tpu/nodes", "/tpu/pods")
    subs = [(a.push.hub, a.push.hub.subscribe(pages)) for a in [app] + [r for r, _ in workers]]
    try:
        node = copy.deepcopy(app._last_snapshot.provider("tpu").nodes[3])
        for cond in node["status"]["conditions"]:
            if cond["type"] == "Ready":
                cond["status"] = "False" if cond["status"] == "True" else "True"
        transport.node_feed.push("MODIFIED", node)
        app._ctx.enable_watch()
        _bump(app)
        assert [c.poll_once() for _, c in workers] == [1, 1]

        def drain(hub, sub):
            out = []
            while (event := hub.poll(sub)) is not None:
                out.append(format_event(event))
            return out

        wires = [drain(hub, sub) for hub, sub in subs]
        assert wires[0] and all(w == wires[0] for w in wires[1:])
        assert any(node["metadata"]["name"] in frame for frame in wires[1])
    finally:
        _close(app, seg, workers)


def test_after_the_leader_dies_workers_serve_stale_with_no_5xx(tmp_path):
    mono = FakeClock()
    _, app, pub, seg, workers = _plane(tmp_path, mono, fallback=True)
    gateways = [r.ensure_gateway(workers=1) for r, _ in workers]
    try:
        for gw in gateways:
            assert dict(gw.handle("/tpu?t=0").headers)["X-Headlamp-Stale"] == "0"

        def dead(cursor):
            raise OSError("connection refused")

        # The leader dies: the segment stays, frozen at its last
        # generation, and the bus stops answering.
        for _, consumer in workers:
            consumer._fallback = dead
        mono.advance(31.0)
        for (rep, consumer), gw in zip(workers, gateways):
            assert consumer.poll_once() == 0 and rep.stale()
            gw.shed_policy.invalidate()
            for i, path in enumerate(PAGES):
                resp = gw.handle(f"{path}?loss={i}")
                assert resp.status == 200, path
                assert dict(resp.headers)["X-Headlamp-Stale"] == "1", path
            health = json.loads(rep.handle("/healthz")[2])
            assert health["ok"] is True and health["runtime"]["replication"]["stale"] is True
    finally:
        _close(app, seg, workers)


class _FakeProcess:
    def __init__(self, target, args, kwargs, daemon, name):
        self.target, self.args, self.kwargs, self.name = target, args, kwargs, name
        self.pid = None
        self.alive = False
        self.terminated = self.joined = False

    def start(self):
        self.alive = True
        self.pid = 1000 + self.args[0]

    def is_alive(self):
        return self.alive

    def terminate(self):
        self.terminated = True
        self.alive = False

    def join(self, timeout=None):
        self.joined = True


class _FakeContext:
    def __init__(self):
        self.processes = []

    def Process(self, **kwargs):  # noqa: N802 (multiprocessing API)
        proc = _FakeProcess(**kwargs)
        self.processes.append(proc)
        return proc


def test_the_supervisor_starts_workers_with_spawn(tmp_path, monkeypatch):
    methods = []
    fake = _FakeContext()

    def get_context(method):
        methods.append(method)
        return fake

    monkeypatch.setattr(supervisor_mod.multiprocessing, "get_context", get_context)
    fleet = fleet_viewport(64)
    sup = WorkerSupervisor(
        lambda: DashboardApp(fleet_transport(fleet), device="cpu", min_sync_interval_s=3600.0),
        port=0, workers=2, segment_path=str(tmp_path / "s.seg"),
        board_path=str(tmp_path / "b.wsb"), strategy="fd-passing", sync_interval_s=0.05,
        device="cpu",
    )
    sup.start()
    try:
        assert methods == ["spawn"] == [supervisor_mod.START_METHOD]
        assert [p.args[0] for p in fake.processes] == [0, 1]
        for proc in fake.processes:
            assert proc.target is worker_main and proc.kwargs["device"] == "cpu"
            assert proc.kwargs["listen_socket"] is sup._listener
            # What a spawned child receives must pickle (the listener goes
            # as a passed descriptor, multiprocessing's own reduction).
            plain = {k: v for k, v in proc.kwargs.items() if k != "listen_socket"}
            assert pickle.loads(pickle.dumps((proc.target, proc.args, plain)))[0] is worker_main
        deadline = time.monotonic() + 30.0
        while sup.publisher.segment_publishes == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        polled = sup.poll()
        assert polled["start_method"] == "spawn" and polled["alive"] == 2
        assert polled["replication"]["segment_publishes"] >= 1
        bus = urllib.request.urlopen(sup.bus_url + "/replicate/bus", timeout=10).read()
        assert b'"kind":"generation"' in bus
    finally:
        sup.stop()
    assert all(p.terminated and p.joined for p in fake.processes)
    assert not os.path.exists(tmp_path / "s.seg") and not os.path.exists(tmp_path / "b.wsb")
    assert sup._listener is None and sup._bus_server is None


def test_the_entry_point_excludes_replica_and_leader_and_needs_cuda(monkeypatch):
    for argv in (["--replica", "http://127.0.0.1:1", "--workers", "2", "--device", "cpu"],
                 ["--demo", "v5e4", "--workers", "2", "--replication-leader",
                  "--device", "cpu"]):
        with pytest.raises(SystemExit) as err:
            server_main(argv)
        assert err.value.code == 2
    started = []
    monkeypatch.setattr(supervisor_mod.multiprocessing, "get_context",
                        lambda method: started.append(method))
    # CUDA is absent here: the supervisor refuses before it starts anything.
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server_main(["--demo", "v5e4", "--workers", "2", "--port", "0"])
    assert started == []
    with pytest.raises(ValueError):
        WorkerSupervisor(lambda: None, workers=0, device="cpu")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.slow
def test_two_worker_processes_serve_one_etag():
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "headlamp_tpu_torch.server", "--demo", "v5p32", "--workers", "2",
         "--port", str(port), "--background-sync", "0.5", "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
    )
    try:
        deadline = time.monotonic() + 120.0
        body = None
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                    body = json.loads(r.read())
                if (body["runtime"]["workers"]["live"] == 2
                        and body["runtime"]["replication"]["applied"] >= 1):
                    break
            except OSError:
                pass
            time.sleep(0.5)
        assert body is not None, "the supervisor never came up"
        assert body["runtime"]["workers"]["live"] == 2
        assert body["runtime"]["replication"]["role"] == "worker"
        assert body["runtime"]["device"]["torch_device"] == "cpu"
        etags = set()
        for _ in range(6):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/tpu", timeout=10) as r:
                assert r.status == 200
                etags.add(r.headers["ETag"])
        assert len(etags) == 1
    finally:
        proc.terminate()
        assert proc.wait(timeout=60) == 0

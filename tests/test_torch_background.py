"""The port host's background sync on the CPU, as ``tests/test_watch.py``
pins the JAX host's, plus what the port adds.

The loop syncs with list+watch (one LIST chain per track, ever), restarts
cleanly (a stale stop handle cannot disable a newer loop's watch) and
wakes on ``/refresh``. A changed tick's new snapshot version is warmed
onto the device once, off the request path, so the next requests upload
nothing; a warm that raises shows in ``/healthz`` (``ok`` false) and the
next request that needs the columns is a 500 naming the error. The
``/healthz`` failure and wedged rules run on an injected monotonic
clock. An upload of an older version that finishes late never replaces
a newer entry, also under concurrent requests while events land.
``close()`` and the ``--background-sync`` entry point leave no thread
behind. Every wait is bounded (10 s) so a hang fails one test.
"""

import copy
import json
import sys
import threading
import time

import pytest
import torch

from headlamp_tpu_torch.analytics import encode as encode_mod
from headlamp_tpu_torch.analytics.stats import python_fleet_stats
from headlamp_tpu_torch.domain.accelerator import classify_fleet
from headlamp_tpu_torch.fleet import fixtures as tfx
from headlamp_tpu_torch.models import aot
from headlamp_tpu_torch.obs.trace import trace_ring
from headlamp_tpu_torch.runtime.device_cache import DeviceFleetCache
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport
from headlamp_tpu_torch.server import app as app_mod
from headlamp_tpu_torch.server.__main__ import main as server_main
from headlamp_tpu_torch.transport import ApiError

torch.set_num_threads(1)

CLOCK = 1785283200.0
WAIT_S = 10.0


def clock():
    return CLOCK


def _wait(pred, what):
    deadline = time.monotonic() + WAIT_S
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


def _ticks(app):
    return app._background_counters["ticks"]


def _tick(app):
    """Wake the loop and wait for the tick it runs."""
    n = _ticks(app)
    app._background_wake.set()
    _wait(lambda: _ticks(app) > n, "a background tick")


def _list_calls(t):
    return [c for c in t.calls if c.startswith(("/api/v1/nodes?", "/api/v1/pods?")) and "limit=" in c]


def _span_names(trace):
    stack, names = list(trace["spans"]), []
    while stack:
        node = stack.pop()
        names.append(node["name"])
        stack.extend(node["children"])
    return names


def _viewport_app(n=256, **kw):
    t = tfx.fleet_transport(tfx.fleet_viewport(n))
    return DashboardApp(t, device="cpu", clock=clock, min_sync_interval_s=3600.0, **kw), t


def test_loop_syncs_with_watch_one_list_chain_per_track():
    t = make_demo_transport("v5e4")
    app = DashboardApp(t, device="cpu", clock=clock, min_sync_interval_s=3600.0)
    app.start_background_sync(0.02)
    try:
        _wait(lambda: len(t.watch_calls) >= 6, "six watch polls")
        assert _list_calls(t) == ["/api/v1/nodes?limit=500", "/api/v1/pods?limit=500"]
        assert app.handle("/tpu")[0] == 200
        assert len(_list_calls(t)) == 2  # the request read the published snapshot
        assert trace_ring.snapshot()[0]["spans"][0]["attrs"]["source"] == "background"
        health = json.loads(app.handle("/healthz")[2])
        assert health["background_sync"] and health["ok"]
        assert health["runtime"]["watch"]["nodes"]["relists"] == 1
        assert health["runtime"]["history"]["syncs"] == _ticks(app) >= 3
    finally:
        app.close()
    assert not app._background_live() and not app._ctx._watch_enabled


def test_restart_replaces_the_loop_and_a_stale_stop_is_harmless():
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", min_sync_interval_s=3600.0)
    stop_a = app.start_background_sync(3600.0)
    stop_b = app.start_background_sync(3600.0)
    try:
        assert stop_a.is_set() and not stop_b.is_set()
        stop_a.set()  # the stale handle fires again
        assert app._ctx._watch_enabled and app._background_live()
        _wait(lambda: not app._background_threads[0].is_alive(), "the old loop to exit")
    finally:
        stop_b.set()  # the active handle turns watch off
        assert not app._ctx._watch_enabled and not app._background_live()
        app.close()
    assert not any(t.is_alive() for t in app._background_threads)


def test_refresh_wakes_the_loop():
    t = make_demo_transport("v5e4")
    app = DashboardApp(t, device="cpu", clock=clock, min_sync_interval_s=3600.0)
    app.start_background_sync(3600.0)
    try:
        _wait(lambda: _ticks(app) == 1, "the hydrating tick")
        watches = len(t.watch_calls)
        assert app.handle("/refresh?back=/tpu/fleet") == (302, "/tpu/fleet", "")
        _wait(lambda: _ticks(app) == 2, "the tick /refresh woke")
        assert len(t.watch_calls) == watches + 2 and app._cache_epoch == 1
    finally:
        app.close()


def test_new_version_is_warmed_once_off_the_request_path():
    app, t = _viewport_app()
    app.start_background_sync(3600.0)
    try:
        _wait(lambda: _ticks(app) == 1, "the hydrating tick")
        cache = app._ctx.fleet_cache
        assert app._background_counters["warms"] == 1 and cache.counters()["uploads"] == 1
        assert "device_cache.upload" in _span_names(app.last_tick_trace)
        for path in ("/tpu/fleet", "/tpu", "/tpu/fleet?region=cluster/1"):
            assert app.handle(path)[0] == 200
            assert "device_cache.upload" not in _span_names(trace_ring.snapshot()[0]), path
        assert cache.counters()["uploads"] == 1
        _tick(app)  # quiet: same version, nothing uploaded
        assert app._background_counters["warms"] == 1 and cache.counters()["uploads"] == 1
        view = app._last_snapshot.provider("tpu").view
        node = copy.deepcopy(view.nodes[5])
        node["metadata"]["labels"]["example.com/marker"] = "x"
        t.node_feed.push("MODIFIED", node)
        t.pod_feed.push("ADDED", tfx.make_tpu_pod("late-0", node=node["metadata"]["name"]))
        _tick(app)
        new_view = app._last_snapshot.provider("tpu").view
        assert new_view.version == view.version + 1
        assert app._background_counters["warms"] == 2 and cache.counters()["uploads"] == 2
        assert app.handle("/tpu/fleet")[0] == 200
        assert "device_cache.upload" not in _span_names(trace_ring.snapshot()[0])
        assert cache.snapshot()["entries"] == {"tpu": new_view.version}
        assert app._ctx.watch_stats["nodes"]["events"] == 1
        assert app._ctx.watch_stats["pods"]["events"] == 1
    finally:
        app.close()
    assert cache.snapshot()["entries"] == {}


def test_a_raising_warm_shows_in_healthz_and_the_next_request_is_a_500(monkeypatch):
    app, t = _viewport_app()

    def broken_upload(view):
        raise RuntimeError("device upload failed")

    monkeypatch.setattr(app._ctx.fleet_cache, "_upload", broken_upload)
    app.start_background_sync(3600.0)
    try:
        _wait(lambda: _ticks(app) == 1, "the hydrating tick")
        health = json.loads(app.handle("/healthz")[2])
        background = health["runtime"]["background"]
        assert health["ok"] is False and background["warm_errors"] == 1 and background["warms"] == 0
        assert background["last_warm_error"] == "RuntimeError: device upload failed"
        status, _, body = app.handle("/tpu/fleet")
        assert status == 500 and "RuntimeError: device upload failed" in body
        monkeypatch.undo()  # the card recovers: the next version's warm clears ok
        node = copy.deepcopy(app._last_snapshot.provider("tpu").nodes[0])
        node["metadata"]["labels"]["example.com/marker"] = "x"
        t.node_feed.push("MODIFIED", node)
        _tick(app)
        health = json.loads(app.handle("/healthz")[2])
        assert health["ok"] is True and health["runtime"]["background"]["warms"] == 1
        assert app.handle("/tpu/fleet")[0] == 200
    finally:
        app.close()


def test_healthz_failure_and_wedged_rules_on_the_monotonic_clock():
    mono = [5000.0]
    app, t = _viewport_app(64, monotonic=lambda: mono[0])
    app.start_background_sync(60.0)
    try:
        _wait(lambda: _ticks(app) == 1, "the hydrating tick")
        health = json.loads(app.handle("/healthz")[2])
        assert health["ok"] and health["last_sync_age_s"] == 0.0
        # Wedged: older than max(3 intervals, 30 s) with the loop live.
        mono[0] += 180.0
        assert json.loads(app.handle("/healthz")[2])["ok"] is True
        mono[0] += 0.5
        health = json.loads(app.handle("/healthz")[2])
        assert health["ok"] is False and health["last_sync_age_s"] == 180.5
        _tick(app)
        assert json.loads(app.handle("/healthz")[2])["ok"] is True
        # Failing: the node list and watch answer 503 for three ticks.
        t.add_override("/api/v1/nodes", ApiError("/api/v1/nodes", "HTTP 503", status=503))
        for want_ok, failures in ((True, 1), (True, 2), (False, 3)):
            _tick(app)
            health = json.loads(app.handle("/healthz")[2])
            assert (health["ok"], health["consecutive_sync_failures"]) == (want_ok, failures)
        assert health["runtime"]["background"]["last_sync_error"].startswith("nodes: ")
        assert health["errors"] == ["nodes: /api/v1/nodes: HTTP 503"]
    finally:
        app.close()


def test_a_late_upload_of_an_older_version_never_replaces_a_newer_one(monkeypatch):
    fleet = tfx.fleet_viewport(128)
    old, new = (classify_fleet(fleet["nodes"], fleet["pods"][: 90 + i])["tpu"] for i in (0, 6))
    old.version, new.version = 1, 2
    cache = DeviceFleetCache("cpu")
    started, release = threading.Event(), threading.Event()
    real_encode = encode_mod.encode_fleet

    def encode(nodes, pods):
        if len(pods) == len(old.pods):  # the older snapshot's upload stalls
            started.set()
            assert release.wait(WAIT_S)
        return real_encode(nodes, pods)

    monkeypatch.setattr(encode_mod, "encode_fleet", encode)
    got = []
    late = threading.Thread(target=lambda: got.append(cache.fleet_for(old)))
    late.start()
    assert started.wait(WAIT_S)
    assert cache.warm(new)  # the newer version lands first
    release.set()
    late.join(WAIT_S)
    assert not late.is_alive() and got[0].n_pods == len(old.pods)
    assert cache.snapshot()["entries"] == {"tpu": 2} and cache.counters()["uploads"] == 2
    assert cache.fleet_for(new).n_pods == len(new.pods)
    assert cache.counters() == {"hits": 1, "misses": 1, "uploads": 2}
    assert not cache.warm(new)


def test_requests_during_changed_ticks_serve_the_published_fleet():
    # Four request threads paint while the loop applies events; the
    # shortened switch interval interleaves them finely. Every paint is
    # a 200, and afterwards the cached entry is the published version's
    # and its rollup equals the Python oracle's.
    app, t = _viewport_app()
    app.start_background_sync(3600.0)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    statuses, done = [], threading.Event()

    def paint():
        while not done.is_set():
            statuses.append(app.handle("/tpu/fleet")[0])

    workers = [threading.Thread(target=paint) for _ in range(4)]
    try:
        _wait(lambda: _ticks(app) == 1, "the hydrating tick")
        for w in workers:
            w.start()
        nodes = app._last_snapshot.provider("tpu").nodes
        for i in range(6):
            node = copy.deepcopy(nodes[i])
            node["status"]["conditions"] = [{"type": "Ready", "status": "False"}]
            t.node_feed.push("MODIFIED", node)
            _tick(app)
    finally:
        done.set()
        for w in workers:
            w.join(WAIT_S)
        sys.setswitchinterval(switch)
    try:
        assert not any(w.is_alive() for w in workers) and statuses and set(statuses) == {200}
        state = app._last_snapshot.provider("tpu")
        assert app._ctx.fleet_cache.snapshot()["entries"] == {"tpu": state.view.version}
        assert state.fleet_stats() == python_fleet_stats(state.view)
    finally:
        app.close()


def test_close_and_the_entry_point_leave_no_thread(monkeypatch):
    before = set(threading.enumerate())
    # The entry point's serve() starts the process's program registry: a
    # fresh one for this test.
    monkeypatch.setattr(aot, "_REGISTRY", aot.AotProgramRegistry())
    app, _t = _viewport_app()
    app.start_background_sync(0.02)
    _wait(lambda: _ticks(app) >= 2, "two ticks")
    app.close()
    seen = {}

    def wait(server):
        seen.update(live=server.app._background_live(), interval=server.app._background_interval)
        _wait(lambda: _ticks(server.app) >= 1, "the entry point's first tick")
        raise KeyboardInterrupt

    monkeypatch.setattr(app_mod.DashboardServer, "wait", wait)
    server_main(["--demo", "v5e4", "--device", "cpu", "--port", "0", "--background-sync", "5"])
    assert seen == {"live": True, "interval": 5.0}
    left = [t.name for t in set(threading.enumerate()) - before if t.name.startswith("hl-")]
    assert left == []


@pytest.mark.parametrize("interval", [None, 0.5])
def test_default_interval(interval):
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", min_sync_interval_s=3.0)
    app.start_background_sync(interval)
    try:
        assert app._background_interval == (3.0 if interval is None else 0.5)
        assert json.loads(app.handle("/healthz")[2])["runtime"]["background"]["interval_s"] == (
            app._background_interval
        )
    finally:
        app.close()

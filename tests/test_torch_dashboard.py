"""The port's snapshot pages against the JAX host's, on the CPU.

``<main>`` of ``/tpu``, ``/tpu/nodes`` (the legacy ``?page=`` pager and a
``?limit=``/``?cursor=`` window), ``/tpu/pods``, ``/tpu/deviceplugins``
and ``/tpu/topology`` from the port's ``DashboardApp(device="cpu")`` is
byte-identical to the JAX ``DashboardApp``'s, with the wall clock pinned
and both apps syncing on every request (so their snapshot generations,
which the cursors carry, advance together). The JAX app paints once with
its default fragment cache and once without one. Then the host's own
routes: ``/refresh``, an unregistered page, ``/healthz``'s new blocks,
the topology heatmap from the metrics peek, and a rollup that raises.
"""

import json
import re
from urllib.parse import quote

import pytest

from headlamp_tpu.runtime import device_cache as jax_device_cache
from headlamp_tpu.server import DashboardApp as JaxApp
from headlamp_tpu.server import make_demo_transport as jax_demo_transport
from headlamp_tpu_torch.analytics import fleet_torch
from headlamp_tpu_torch.analytics import stats as tstats
from headlamp_tpu_torch.obs.trace import trace_ring
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

CLOCK = 1785283200.0
PAGES = (
    "/tpu",
    "/tpu/nodes",
    "/tpu/nodes?page=2",
    "/tpu/nodes?limit=10",
    "/tpu/nodes?limit=10&cursor={cursor}",
    "/tpu/pods",
    "/tpu/pods?limit=5",
    "/tpu/deviceplugins",
    "/tpu/topology",
)
_CURSOR = re.compile(r'cursor=([A-Za-z0-9_-]+)" class="hl-res-link hl-cursor-next"')


def clock():
    return CLOCK


def _main(body):
    return re.search(r"<main>(.*)</main>", body, re.S).group(1)


def _span(name):
    """The newest trace's first span called ``name``."""
    stack = list(trace_ring.snapshot()[0]["spans"])
    while stack:
        node = stack.pop(0)
        if node["name"] == name:
            return node
        stack.extend(node["children"])
    raise AssertionError(f"no {name} span")


def _paint(app):
    """Status and <main> of every page, in order; the cursor of the
    first node window continues the second."""
    out, cursor = {}, ""
    for path in PAGES:
        status, _, body = app.handle(path.format(cursor=quote(cursor)))
        out[path] = (status, _main(body))
        if path == "/tpu/nodes?limit=10" and (found := _CURSOR.search(body)):
            cursor = found.group(1)
    return out


@pytest.fixture(scope="module", params=["v5p32", "large"])
def painted(request):
    fleet = request.param
    tstats.calibration.reset()
    port = DashboardApp(make_demo_transport(fleet), device="cpu", clock=clock,
                        min_sync_interval_s=0.0)
    jax_apps = {
        "fragments": JaxApp(jax_demo_transport(fleet), clock=clock, min_sync_interval_s=0.0),
        "plain": JaxApp(jax_demo_transport(fleet), clock=clock, min_sync_interval_s=0.0,
                        fragments=False),
    }
    try:
        out = {"port": _paint(port)}
        for name, app in jax_apps.items():
            # The JAX package keeps one process-wide fleet cache keyed by
            # (provider, snapshot version): an app that ran earlier in this
            # process at the same version would serve its fleet's rollup.
            jax_device_cache.fleet_cache.invalidate()
            jax_device_cache.rollup_results.invalidate()
            out[name] = _paint(app)
    finally:
        port.close()
        tstats.calibration.reset()
    return fleet, out


@pytest.mark.parametrize("jax_app", ["fragments", "plain"])
def test_snapshot_pages_main_bytes_match_jax(painted, jax_app):
    fleet, out = painted
    for path in PAGES:
        status, main = out["port"][path]
        want_status, want = out[jax_app][path]
        assert status == want_status == 200, path
        assert main == want, f"{fleet} {path}"
    # The sections each page exists for are there.
    for path, title in (("/tpu", "Chip Allocation"), ("/tpu/nodes", "TPU Nodes"),
                        ("/tpu/pods", "All TPU Pods"), ("/tpu/deviceplugins", "Plugin Pods"),
                        ("/tpu/topology", "Slice Summary")):
        assert title in out["port"][path][1], path
    if fleet == "large":
        assert "rows 11–20 of" in out["port"]["/tpu/nodes?limit=10&cursor={cursor}"][1]


def test_refresh_unregistered_and_healthz():
    tstats.calibration.reset()
    app = DashboardApp(make_demo_transport("large"), device="cpu", clock=clock)
    try:
        health = json.loads(app.handle("/healthz")[2])
        assert health["loading"] and health["analytics"]["calibrated"] is False
        assert app.handle("/refresh?back=/tpu")[:2] == (302, "/tpu")
        assert app.handle("/refresh?back=//evil.example")[:2] == (302, "/tpu")
        assert app.handle("/tpu/no-such-page")[0] == 404
        # The telemetry pages paint from their own snapshots: no sync either.
        for path in ("/debug/generationz/html", "/debug/traces/html", "/sloz/html",
                     "/debug/incidentz/html"):
            assert app.handle(path)[0] == 200, path
        assert app.handle("/tpu/trends")[0] == 200  # reads no snapshot: the app stays unsynced
        assert json.loads(app.handle("/healthz")[2])["loading"]

        assert app.handle("/tpu")[0] == 200
        # The Intel pages are registered, as in JAX: served from the same
        # synced snapshot (the large fleet has no Intel node).
        status, _, body = app.handle("/intel")
        assert status == 200 and "Intel GPU Plugin Not Detected" in body
        health = json.loads(app.handle("/healthz")[2])
        assert health["nodes"] == 1024 and not health["loading"] and health["errors"] == []
        analytics = health["analytics"]
        assert analytics["calibrated"] and analytics["backend"] == "torch"
        assert analytics["tpu_nodes"] == 991 and analytics["floor_nodes"] == 64
        assert analytics["chosen_backend"] in ("torch", "python")
        fleet_cache = health["runtime"]["fleet_cache"]
        # Two refreshes and a sync built three snapshot versions.
        assert fleet_cache["uploads"] == 1 and fleet_cache["entries"] == {"tpu": 3}
        assert fleet_cache["device"] == "cpu"
    finally:
        app.close()
        tstats.calibration.reset()
    assert json.loads(app.handle("/healthz")[2])["runtime"]["fleet_cache"]["entries"] == {}


def test_sync_interval_coalesces_and_the_trace_names_the_rollup():
    tstats.calibration.reset()
    mono = [100.0]
    transport = make_demo_transport("large")
    app = DashboardApp(transport, device="cpu", clock=clock, monotonic=lambda: mono[0])

    def node_lists():
        return sum(c.startswith("/api/v1/nodes?limit") for c in transport.calls)

    try:
        assert app.handle("/tpu")[0] == 200
        rollup = _span("analytics.rollup")
        assert rollup["attrs"]["backend"] == "torch" and rollup["attrs"]["fleet_cache"] == "miss"
        attrs = _span("sync.snapshot")["attrs"]
        attrs = {k: v for k, v in attrs.items() if k not in ("gc_full_ms", "gc_full")}
        assert attrs == {"source": "inline-sync", "nodes": 1024}
        lists = node_lists()
        mono[0] += 4.0  # inside the 5 s interval: coalesced, stats reused
        assert app.handle("/tpu")[0] == 200 and node_lists() == lists
        assert _span("sync.snapshot")["attrs"]["source"] == "coalesced"
        with pytest.raises(AssertionError, match="no analytics.rollup span"):
            _span("analytics.rollup")
        assert app._ctx.fleet_cache.counters()["uploads"] == 1
        mono[0] += 1.5  # past it: one re-list, a new version
        assert app.handle("/tpu/nodes")[0] == 200 and node_lists() == lists + 3
    finally:
        app.close()
        tstats.calibration.reset()


def test_topology_heatmap_comes_from_the_metrics_peek():
    app = DashboardApp(make_demo_transport("v5p32"), device="cpu", clock=clock)
    try:
        calls = app._transport.calls
        assert "hl-heat-" not in _main(app.handle("/tpu/topology")[2])
        assert not any("/proxy/api/v1/query" in c for c in calls)  # never fetches
        assert app._cached_metrics() is not None
        body = _main(app.handle("/tpu/topology")[2])
        assert "hl-heat-" in body and "joined from the cached telemetry snapshot" in body
    finally:
        app.close()


def test_rollup_error_is_a_500_naming_it(monkeypatch):
    def broken(fleet, device=None):
        raise RuntimeError("rollup kernel failed")

    monkeypatch.setattr(fleet_torch, "rollup_to_dict", broken)
    tstats.calibration.reset()
    app = DashboardApp(make_demo_transport("large"), device="cpu", clock=clock,
                       min_sync_interval_s=0.0)
    try:
        for _ in range(2):  # nothing is pinned broken and nothing falls back
            status, ctype, body = app.handle("/tpu")
            assert (status, ctype) == (500, "text/html")
            assert "Internal error: RuntimeError: rollup kernel failed" in body
        assert app.handle("/tpu/nodes")[0] == 200  # pages without the rollup serve
    finally:
        app.close()
        tstats.calibration.reset()

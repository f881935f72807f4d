"""Push and the fragment cache on the card, at ``fleet_viewport(1024)``
with the demo Prometheus: a node's Ready flip is one diff and one delta
per subscriber, with no kernel launch, and the differ's region cells
equal the region rollup on the card exactly; paints through the fragment
cache equal ``fragments=False`` paints, and a refit forced by
``/refresh`` launches ``forecast_mlp_forward`` once and re-renders the
forecast fragment; ``/events`` over the socket streams the delta and a
``bye`` on close, and leaves no handler thread. The kernel has no CPU
mode, so every test here needs a CUDA device and skips without one. On
the card:

    python -m pytest tests/test_torch_cuda_push.py -q -s
"""

from __future__ import annotations

import copy
import http.client
import json
import threading

import pytest
import torch

from headlamp_tpu_torch.analytics.fleet_torch import REGION_CLUSTER_SEGMENTS
from headlamp_tpu_torch.fleet import fleet_transport, fleet_viewport
from headlamp_tpu_torch.models import aot
from headlamp_tpu_torch.models.fused_forward import LAUNCHES
from headlamp_tpu_torch.obs import graphcost
from headlamp_tpu_torch.obs import slo as tslo
from headlamp_tpu_torch.push import REGION_PAGE_PREFIX
from headlamp_tpu_torch.runtime.device_cache import warm_carries
from headlamp_tpu_torch.server import DashboardApp
from headlamp_tpu_torch.server.demo import add_demo_prometheus
from headlamp_tpu_torch.viewport import tree as vt

CLOCK = 1785283200.0
FIVE_PAGES = ("/tpu", "/tpu/nodes", "/tpu/pods", "/tpu/metrics", "/tpu/fleet")


def clock():
    return CLOCK


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    monkeypatch.setattr(graphcost, "_LEDGER", graphcost.GraphCostLedger())
    monkeypatch.setattr(aot, "_REGISTRY", aot.AotProgramRegistry())
    monkeypatch.setattr(tslo, "_engine", tslo.SLOEngine())
    warm_carries.invalidate()


def _app(**kwargs):
    fleet = fleet_viewport(1024)
    transport = fleet_transport(fleet)
    add_demo_prometheus(transport, fleet)
    mono = [5000.0]
    app = DashboardApp(transport, device="cuda", clock=clock, monotonic=lambda: mono[0],
                       min_sync_interval_s=3600.0, **kwargs)
    app._ctx.enable_watch()
    app._background_tick()
    return transport, app


def _flip(transport, app, index):
    node = copy.deepcopy(app._last_snapshot.provider("tpu").nodes[index])
    for cond in node["status"]["conditions"]:
        if cond["type"] == "Ready":
            cond["status"] = "False" if cond["status"] == "True" else "True"
    transport.node_feed.push("MODIFIED", node)
    app._background_tick()
    return node["metadata"]["name"]


def test_a_flip_is_one_diff_no_launch_and_region_cells_equal_the_card(card):
    transport, app = _app()
    try:
        LAUNCHES.reset()
        assert app.handle("/tpu/metrics")[0] == 200
        torch.cuda.synchronize()
        assert LAUNCHES.n == 1
        _flip(transport, app, 3)  # the metrics model now diffs with its peeks
        subs = [app.open_event_stream("/events") for _ in range(4)]
        LAUNCHES.reset()
        diffs = app.push.counters()["diffs"]
        name = _flip(transport, app, 7)
        torch.cuda.synchronize()
        for sub in subs:
            event = app.push.hub.poll(sub)
            assert event["data"]["page"] == "/tpu/nodes" and list(event["data"]["rows"]) == [name]
            assert app.push.hub.poll(sub) is None
        assert app.push.counters()["diffs"] == diffs + 1 and LAUNCHES.n == 0
        state = app._last_snapshot.provider("tpu")
        region_of, _, _, cluster_id, slice_id = vt._assignments(state.nodes)
        clusters, slices = vt._device_sums(state, cluster_id, slice_id, region_of,
                                           REGION_CLUSTER_SEGMENTS)
        pairs = [(vt.region_path(c), clusters[i]) for c, i in cluster_id.items()]
        pairs += [(vt.region_path(c, s), slices[i]) for (c, s), i in slice_id.items()]
        for path, stats in pairs:
            cells = app.push._models[REGION_PAGE_PREFIX + path]["cells"]
            assert (cells["nodes_total"], cells["nodes_ready"], cells["capacity"],
                    cells["allocatable"], cells["in_use"]) == (
                stats["nodes"], stats["ready"], stats["capacity"], stats["allocatable"],
                stats["in_use"]), path
    finally:
        app.close()


def test_fragment_paints_on_the_card_equal_the_oracle(card):
    (t_on, on), (t_off, off) = _app(), _app(fragments=False)
    off._metrics_refresher = on._metrics_refresher  # one scrape and one fit for both
    off._forecast_refresher = on._forecast_refresher
    try:
        LAUNCHES.reset()
        for _ in range(2):
            bodies = [[a.handle(p)[2] for p in FIVE_PAGES] for a in (on, off)]
            assert bodies[0] == bodies[1]
        torch.cuda.synchronize()
        assert LAUNCHES.n == 1 and on.fragments.snapshot()["hits"] > 0
        _flip(t_on, on, 11)
        _flip(t_off, off, 11)
        assert on.handle("/tpu/nodes")[2] == off.handle("/tpu/nodes")[2]
        for a in (on, off):
            assert a.handle("/refresh?back=/tpu/metrics")[0] == 302
        LAUNCHES.reset()
        misses = on.fragments.counters()["misses"]
        assert on.handle("/tpu/metrics")[2] == off.handle("/tpu/metrics")[2]
        torch.cuda.synchronize()
        assert LAUNCHES.n == 1 and on.fragments.counters()["misses"] > misses
    finally:
        on.close()
        off.close()


def test_events_over_the_socket_on_the_card_leave_no_thread(card):
    before = set(threading.enumerate())
    transport, app = _app()
    server = app.serve("127.0.0.1", 0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", int(server.url.rsplit(":", 1)[1]),
                                          timeout=60)
        conn.request("GET", "/events?pages=/tpu/nodes")
        resp = conn.getresponse()
        assert resp.status == 200 and resp.getheader("Content-Type") == "text/event-stream"
        name = _flip(transport, app, 5)
        lines = [resp.fp.readline().decode() for _ in range(4)]
        assert lines[1] == "event: delta\n"
        assert list(json.loads(lines[2][len("data: "):])["rows"]) == [name]
    finally:
        server.close()
    assert resp.read() == b'event: bye\ndata: {"reason":"shutdown"}\n\n'
    conn.close()
    left = [t.name for t in set(threading.enumerate()) - before
            if t.name.startswith(("hl-torch-", "refresh-", "Thread-"))]
    assert left == []

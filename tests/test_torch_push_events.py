"""``/events`` and the differ hook on the port's host, on the CPU.

``open_event_stream`` admits the same pages and priority class as the JAX
host's for every query shape (``?pages=``, ``?region=``, a bad region,
``?class=debug``) and counts the stream once at admission. The hook at
the end of ``_record_sync``: the first snapshot is a baseline with no
frames, a quiet tick (the same generation) is skipped, a generation bump
produces frames (timed as the tick's ``push.diff`` span), and the forecast the differ reads is a peek that never
fits. A differ that raises is counted and named in ``/healthz``
``runtime.push``, with ``ok`` false until a later generation diffs
cleanly. Over a real socket ``/events`` answers ``text/event-stream``,
streams one delta after a node flip and a ``bye`` on the server's close,
and leaves no handler thread. The gateway counts the SSE connections,
and its policy's ``paging()`` equals JAX's and sheds debug streams only.
"""

import copy
import http.client
import json
import threading

from headlamp_tpu.gateway.shed import ShedPolicy as JaxShedPolicy
from headlamp_tpu.obs import slo as jslo
from headlamp_tpu.server import DashboardApp as JaxApp
from headlamp_tpu.server import make_demo_transport as jax_demo_transport
from headlamp_tpu_torch import push as tpush
from headlamp_tpu_torch.fleet import fleet_transport, fleet_viewport
from headlamp_tpu_torch.gateway.shed import ShedPolicy
from headlamp_tpu_torch.models import aot
from headlamp_tpu_torch.obs import slo as tslo
from headlamp_tpu_torch.obs.metrics import registry as metrics_registry
from headlamp_tpu_torch.runtime.device_cache import warm_carries
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

CLOCK = 1785283200.0


def clock():
    return CLOCK


def _live_app(n=256):
    """A port app on ``fleet_viewport(n)`` with watch on, ticked by hand."""
    transport = fleet_transport(fleet_viewport(n))
    app = DashboardApp(transport, device="cpu", clock=clock, min_sync_interval_s=3600.0)
    app._ctx.enable_watch()
    return transport, app


def _flip(transport, app, index=3):
    node = copy.deepcopy(app._last_snapshot.provider("tpu").nodes[index])
    for cond in node["status"]["conditions"]:
        if cond["type"] == "Ready":
            cond["status"] = "False" if cond["status"] == "True" else "True"
    transport.node_feed.push("MODIFIED", node)
    return node["metadata"]["name"]


def _events_total():
    text = metrics_registry.render()
    line = [x for x in text.splitlines()
            if x.startswith("headlamp_tpu_torch_requests_total{") and 'route="/events"' in x]
    return float(line[0].rsplit(" ", 1)[1]) if line else 0.0


def test_open_event_stream_parses_as_the_jax_host_does():
    port = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=clock)
    try:
        jax = JaxApp(jax_demo_transport("v5e4"), clock=clock)
        paths = [
            "/events", "/events?pages=/tpu,/tpu/pods", "/events?pages=/tpu/bogus,/tpu/nodes",
            "/events?pages=/nope", "/events?region=cluster/3", "/events?region=cluster/3/slice/p-7",
            "/events?region=/cluster/3/", "/events?region=nope/3", "/events?class=debug",
            "/events?class=debug&pages=/tpu/metrics", "/events?class=other",
        ]
        before = _events_total()
        for path in paths:
            got = port.open_event_stream(path, last_event_id="g0")
            want = jax.open_event_stream(path, last_event_id="g0")
            assert (got.pages, got.priority) == (want.pages, want.priority), path
        assert _events_total() - before == len(paths)
        assert port.open_event_stream("/events?region=cluster/3").pages == {"region:cluster/3"}
        assert port._route_label("/events") == jax._route_label("/events") == "/events"
        # handle() is not the stream: JAX's answers 404 too.
        assert port.handle("/events")[0] == jax.handle("/events")[0] == 404
        assert port.push.hub.connected() == len(paths) + 1
    finally:
        port.close()
    assert port.push.hub.snapshot()["evictions"] == len(paths) + 1


def test_the_sync_hook_baselines_skips_a_quiet_tick_and_diffs_a_bump():
    transport, app = _live_app()
    try:
        sub = app.open_event_stream("/events")
        app._background_tick()
        assert app.push.counters()["baselines"] == 1 and app.push.hub.poll(sub) is None
        generation = app.snapshot_generation()
        app._background_tick()  # quiet: the same generation
        assert app.snapshot_generation() == generation
        assert app.push.counters()["skipped_stale"] == 1 and app.push.counters()["diffs"] == 0
        name = _flip(transport, app)
        app._background_tick()
        assert app.snapshot_generation() == generation + 1
        event = app.push.hub.poll(sub)
        assert event["kind"] == "delta" and event["id"] == f"g{generation + 1}"
        assert event["data"]["page"] == "/tpu/nodes" and list(event["data"]["rows"]) == [name]
        assert app.push.hub.poll(sub) is None  # region pages were not asked for
        # The differ's time is its own span of the tick's trace.
        spans = {s["name"]: s for s in app.last_tick_trace["spans"]}
        assert spans["push.diff"]["attrs"] == {"generation": generation + 1}
        health = json.loads(app.handle("/healthz")[2])
        assert health["ok"] is True and health["runtime"]["push"]["diffs"] == 1
        ledger = app.ledger.snapshot()
        stamps = [g for g in ledger["generations"] if g["generation"] == generation + 1]
        assert stamps and stamps[0]["stages"].get("diff_framed") is not None
    finally:
        app.close()


def test_the_differ_peeks_the_forecast_and_never_fits():
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=clock,
                       min_sync_interval_s=0.0)
    try:
        assert app._peek_forecast() is None
        refits = app._forecast_refresher.snapshot()["refits"]
        app.handle("/tpu")  # an inline sync: the hook peeks a cold cache
        assert app._forecast_refresher.snapshot()["refits"] == refits
        assert app.handle("/tpu/metrics")[0] == 200  # one fit
        view = app._peek_forecast()
        assert view is not None and view.inference_path == "torch"
        models = tpush.build_page_models(
            app._last_snapshot, metrics=app._peek_metrics(), forecast=view
        )
        cells = models["/tpu/metrics"]["cells"]
        assert cells["forecast"] is True and cells["chips"] == len(view.chips)
        assert app._forecast_refresher.snapshot()["refits"] == refits + 1
    finally:
        app.close()


def test_a_raising_differ_is_counted_named_and_turns_ok_false(monkeypatch):
    transport, app = _live_app()
    try:
        app._background_tick()

        def broken(*args, **kwargs):
            raise RuntimeError("model build failed")

        monkeypatch.setattr(tpush, "build_page_models", broken)
        _flip(transport, app)
        app._background_tick()
        health = json.loads(app.handle("/healthz")[2])
        push = health["runtime"]["push"]
        assert health["ok"] is False
        assert push["errors"] == 1 and push["last_error"] == "RuntimeError: model build failed"
        # The sync itself published its snapshot before the hook ran.
        assert health["consecutive_sync_failures"] == 0 and app.snapshot_generation() == 2
        monkeypatch.undo()
        _flip(transport, app, index=4)
        app._background_tick()
        health = json.loads(app.handle("/healthz")[2])
        assert health["ok"] is True and health["runtime"]["push"]["errors"] == 1
    finally:
        app.close()


def test_events_over_a_socket_stream_a_delta_and_a_bye_and_leave_no_thread(monkeypatch):
    monkeypatch.setattr(aot, "_REGISTRY", aot.AotProgramRegistry())
    monkeypatch.setattr(tslo, "_engine", tslo.SLOEngine())
    warm_carries.invalidate()
    before = set(threading.enumerate())
    transport, app = _live_app()
    app._background_tick()
    server = app.serve("127.0.0.1", 0)
    try:
        host, port = server.url[len("http://"):].split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=30)
        conn.request("GET", "/events?pages=/tpu/nodes")
        resp = conn.getresponse()
        assert resp.status == 200 and resp.getheader("Content-Type") == "text/event-stream"
        assert resp.getheader("Cache-Control") == "no-cache"
        assert resp.getheader("X-Headlamp-Generation") == str(app.snapshot_generation())
        assert resp.getheader("X-Headlamp-Worker") is None
        assert app.gateway.snapshot()["sse_connections"] == 1
        name = _flip(transport, app)
        app._background_tick()
        lines = [resp.fp.readline().decode() for _ in range(4)]
        assert lines[0] == f"id: g{app.snapshot_generation()}\n" and lines[1] == "event: delta\n"
        assert json.loads(lines[2][len("data: "):])["rows"] == {name: ["tpu", False, 4, 4]}
    finally:
        server.close()
    assert resp.read().decode() == 'event: bye\ndata: {"reason":"shutdown"}\n\n'
    conn.close()
    left = [t.name for t in set(threading.enumerate()) - before
            if t.name.startswith(("hl-torch-", "refresh-", "Thread-"))]
    assert left == [] and app.push.hub.connected() == 0


def _paging(slo_mod):
    eng = slo_mod.SLOEngine(monotonic=lambda: 1000.0)
    for _ in range(600):
        eng.record("dashboard_render", False)
    assert eng.health_block()["dashboard_render"] == "page"
    return eng


def test_the_gateway_counts_streams_and_sheds_debug_ones_on_paging():
    for quiet in (True, False):
        engines = (tslo.SLOEngine(), jslo.SLOEngine()) if quiet else (
            _paging(tslo), _paging(jslo))
        got = ShedPolicy(engine=lambda: engines[0]).paging()
        want = JaxShedPolicy(engine=lambda: engines[1]).paging()
        assert got == want == (not quiet)
    engines = {"now": tslo.SLOEngine()}
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=clock)
    gateway = app.ensure_gateway(workers=1, engine=lambda: engines["now"])
    try:
        debug = app.open_event_stream("/events?class=debug")
        wall = app.open_event_stream("/events")
        assert gateway.snapshot()["sse_connections"] == 2
        assert gateway.snapshot()["inflight_renders"] == 0
        assert app.push.hub.shed_streams() == 0
        engines["now"] = _paging(tslo)
        gateway.shed_policy.invalidate()
        assert app.push.hub.shed_streams() == 1
        assert app.push.hub.poll(debug) == {"kind": "bye", "id": None, "data": {"reason": "shed"}}
        assert wall.evicted_reason is None and app.push.hub.poll(wall) is None
    finally:
        app.close()

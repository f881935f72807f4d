"""Thread hygiene of the port's entry points, on the CPU.

Each test takes the process's live ``hl-torch*`` threads before it builds
an object and again after the object's ``close()`` (or after a call that
closes what it builds), and holds that no thread started in between is
still alive. A thread an earlier test left behind is in both sets, so no
test here depends on another. Where it can, a test also shows that the
object did start a thread of its own, so that an empty difference is a
join and not an idle path. Covered: the CLI's ``render_page``,
``AcceleratorDataContext`` with watch off and on, ``DashboardApp`` with
its background sync, ``serve()`` and its shutdown (the registry's startup
capture, the profiler, the render workers, an ``/events`` stream), a bind
that fails, in ``serve()`` and through the server entry point, and a
scenario run, the read-tier drill with its replica among them.
"""

import http.client
import socket
import threading
import time

import pytest

from headlamp_tpu_torch import cli
from headlamp_tpu_torch.context import AcceleratorDataContext
from headlamp_tpu_torch.fleet import fixtures as tfx
from headlamp_tpu_torch.models import aot
from headlamp_tpu_torch.obs import slo as slo_mod
from headlamp_tpu_torch.scenarios import get_scenario, run_scenario
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport
from headlamp_tpu_torch.server.__main__ import main as server_main

CLOCK = 1785283200.0
WAIT_S = 30.0


def clock():
    return CLOCK


def _live():
    return {t for t in threading.enumerate() if t.name.startswith("hl-torch")}


def _left(before):
    """Names of the ``hl-torch*`` threads started since ``before`` that are
    still alive."""
    return sorted(t.name for t in _live() - before)


def _recording(transport):
    """``transport`` with each request's thread name kept in the returned set."""
    names, inner = set(), transport.request

    def request(path, *args, **kwargs):
        names.add(threading.current_thread().name)
        return inner(path, *args, **kwargs)

    transport.request = request
    return transport, names


def _wait(pred, what):
    deadline = time.monotonic() + WAIT_S
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


@pytest.mark.parametrize("page", ["overview", "cluster-nodes"])
def test_render_page_joins_the_context_it_builds(page):
    before = _live()
    transport, names = _recording(make_demo_transport("v5e4"))
    text = cli.render_page(page, transport, clock=clock, device="cpu")
    assert text and "hl-torch-reactive_0" in names  # the node track ran on its worker
    assert _left(before) == []


@pytest.mark.parametrize("watch", [False, True])
def test_context_close_joins_its_node_track_worker(watch):
    before = _live()
    transport, names = _recording(tfx.fleet_transport(tfx.fleet_viewport(256)))
    ctx = AcceleratorDataContext(transport, device="cpu", clock=clock, watch=watch)
    try:
        for _ in range(2):
            assert ctx.sync().error is None
        assert "hl-torch-reactive_0" in _left(before)
        assert ctx.watch_stats["nodes"]["watches"] == (1 if watch else 0)
    finally:
        ctx.close()
    assert _left(before) == []


def test_app_close_joins_the_background_sync_and_the_context():
    before = _live()
    app = DashboardApp(tfx.fleet_transport(tfx.fleet_viewport(256)), device="cpu", clock=clock,
                       min_sync_interval_s=3600.0)
    try:
        app.start_background_sync(0.02)
        _wait(lambda: app._background_counters["ticks"] >= 2, "two background ticks")
        assert app.handle("/tpu")[0] == 200
        started = _left(before)
        assert "hl-torch-reactive_0" in started and len(started) >= 2
    finally:
        app.close()
    assert _left(before) == []


def test_server_close_joins_what_serve_started(monkeypatch):
    # A registry of this test's own, so serve() starts its capture here.
    monkeypatch.setattr(aot, "_REGISTRY", aot.AotProgramRegistry())
    monkeypatch.setattr(slo_mod, "_engine", slo_mod.SLOEngine())
    before = _live()
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=clock)
    server = app.serve("127.0.0.1", 0)
    host, port = server.url[len("http://"):].split(":")
    page, events = (http.client.HTTPConnection(host, int(port), timeout=30) for _ in range(2))
    try:
        page.request("GET", "/tpu")
        response = page.getresponse()
        assert response.status == 200 and response.read()
        events.request("GET", "/events")
        stream = events.getresponse()
        assert stream.status == 200
        assert aot.registry().wait_ready(WAIT_S)
        started = _left(before)
        for name in ("hl-torch-serve", "hl-torch-render-0"):
            assert name in started, started
    finally:
        server.close()
    # The stream's handler wrote its goodbye before the server's close joined it.
    assert stream.read() == b'event: bye\ndata: {"reason":"shutdown"}\n\n'
    page.close()
    events.close()
    assert _left(before) == []


def test_a_bind_that_fails_starts_nothing(monkeypatch):
    monkeypatch.setattr(aot, "_REGISTRY", aot.AotProgramRegistry())
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        port = taken.getsockname()[1]
        before = _live()
        app = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=clock)
        try:
            with pytest.raises(OSError):
                app.serve("127.0.0.1", port)
            assert app.gateway is None and aot.registry().state == "idle"
        finally:
            app.close()
        assert _left(before) == []
        # The entry point: its background sync and elector started, then the
        # bind failed; it closes the app and stops the elector on the way out.
        with pytest.raises(OSError):
            server_main(["--demo", "v5e4", "--device", "cpu", "--port", str(port),
                         "--background-sync", "0.05", "--replication-leader"])
    assert _left(before) == []


@pytest.mark.parametrize("name", ["preemption_wave", "leader_kill_mid_churn"])
def test_a_scenario_run_closes_every_app_it_built(name):
    before = _live()
    report = run_scenario(get_scenario(name), device="cpu")
    assert report.passed
    assert _left(before) == []

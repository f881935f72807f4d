"""The incident timeline on the port's host against JAX's on the CPU:
``/healthz`` carries ``runtime.scenarios`` only during a drill, with JAX's
block; ``/debug/incidentz`` answers JAX's JSON and the ``<main>`` of
``/debug/incidentz/html`` JAX's bytes for the same timeline; a gateway
built by ``ensure_gateway`` puts its shed rulings on the timeline and the
push hub its evictions, through the seams the earlier slices left; the
scenario runner closes every app it built, the live hub after a restart
included; and its entry points need CUDA unless asked for the CPU.
"""

from __future__ import annotations

import json
import re
import threading

import pytest
import torch

from headlamp_tpu.server import DashboardApp as JaxApp
from headlamp_tpu.server import make_demo_transport as jax_demo_transport
from headlamp_tpu_torch.obs import slo as tslo
from headlamp_tpu_torch.obs.trace import trace_ring
from headlamp_tpu_torch.replicate.replica import ReplicaApp
from headlamp_tpu_torch.scenarios import (
    ScenarioContext,
    ScenarioRunner,
    get_scenario,
    run_scenario,
)
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

pytestmark = pytest.mark.scenario

CLOCK = 1785283200.0


class Clock:
    def __init__(self, now: float) -> None:
        self.now = now

    def __call__(self) -> float:
        return self.now


def _main(body):
    return re.search(r"<main>(.*)</main>", body, re.S).group(1)


@pytest.fixture
def apps():
    """A port host and a JAX host on one pair of scripted clocks."""
    mono, wall = Clock(1000.0), Clock(CLOCK)
    port = DashboardApp(make_demo_transport("v5p32"), device="cpu", clock=wall,
                        monotonic=mono, min_sync_interval_s=0.0)
    jax = JaxApp(jax_demo_transport("v5p32"), clock=wall, monotonic=mono,
                 min_sync_interval_s=0.0)
    try:
        yield mono, wall, port, jax
    finally:
        port.close()


def _both(apps_, method, *args):
    for app in apps_:
        getattr(app.incidents, method)(*args)


def test_healthz_carries_the_drill_only_while_it_runs(apps):
    mono, wall, port, jax = apps
    for app in (port, jax):
        assert "scenarios" not in json.loads(app.handle("/healthz")[2])["runtime"]
    _both((port, jax), "begin_drill", "healthz_drill")
    _both((port, jax), "set_phase", "inject")
    _both((port, jax), "inject", "healthz_drill", "transport_errors", {})
    blocks = [json.loads(app.handle("/healthz")[2])["runtime"]["scenarios"] for app in (port, jax)]
    assert blocks[0] == blocks[1] == {
        "active": "healthz_drill", "phase": "inject", "injections": 1, "events": 3,
    }
    _both((port, jax), "end_drill", "passed")
    for app in (port, jax):
        assert "scenarios" not in json.loads(app.handle("/healthz")[2])["runtime"]


def test_incidentz_json_and_html_main_equal_jaxs(apps):
    mono, wall, port, jax = apps
    empty = [app.handle("/debug/incidentz") for app in (port, jax)]
    assert empty[0] == empty[1]
    assert empty[0][:2] == (200, "application/json")
    snap = json.loads(empty[0][2])
    assert snap["capacity"] == 256 and snap["events"] == [] and snap["active"] is None
    pages = [app.handle("/debug/incidentz/html") for app in (port, jax)]
    assert pages[0][0] == pages[1][0] == 200
    assert _main(pages[0][2]) == _main(pages[1][2])
    assert "No incident events recorded" in pages[0][2]
    _both((port, jax), "begin_drill", "incidentz_drill")
    for step in range(3):
        mono.now += 30.0
        wall.now += 30.0
        _both((port, jax), "inject", "incidentz_drill", "clock_skew", {"step": step})
        _both((port, jax), "gateway_observer", "shed", {"route": "/debug/traces"})
    during = [app.handle("/debug/incidentz/html")[2] for app in (port, jax)]
    assert _main(during[0]) == _main(during[1])
    assert "DRILL ACTIVE" in during[0] and "Incident Timeline" in during[0]
    _both((port, jax), "end_drill", "passed")
    bodies = [app.handle("/debug/incidentz") for app in (port, jax)]
    assert bodies[0] == bodies[1]
    kinds = [(e["source"], e["kind"]) for e in json.loads(bodies[0][2])["events"]]
    assert kinds[0] == ("scenario", "drill_start") and kinds[-1] == ("scenario", "drill_end")
    after = [app.handle("/debug/incidentz/html")[2] for app in (port, jax)]
    assert _main(after[0]) == _main(after[1])
    assert _main(after[0]).count('class="hl-span-row"') == 8


def test_the_routes_are_registered_labelled_and_kept_out_of_the_ring(apps):
    mono, wall, port, jax = apps
    route = port._registry.route_for("/debug/incidentz/html")
    assert (route.name, route.kind) == ("debug-incidents", "incidents")
    assert port._route_label("/debug/incidentz") == jax._route_label("/debug/incidentz")
    assert port._route_label("/debug/incidentz/html") == "/debug/incidentz/html"
    before = len(trace_ring.snapshot())
    port.handle("/debug/incidentz")
    port.handle("/debug/incidentz/html")
    assert len(trace_ring.snapshot()) == before


def _paging(objective):
    eng = tslo.SLOEngine(monotonic=lambda: 1000.0)
    for _ in range(600):
        eng.record(objective, False)
    assert eng.health_block()[objective] == "page"
    return eng


def test_a_gateways_rulings_and_the_hubs_evictions_land_on_the_timeline():
    engines = {"now": tslo.SLOEngine()}
    app = DashboardApp(make_demo_transport("v5p32"), device="cpu", clock=lambda: CLOCK,
                       min_sync_interval_s=3600.0)
    gw = app.ensure_gateway(workers=2, engine=lambda: engines["now"])
    try:
        assert gw.shed_policy.observers == [app.incidents.gateway_observer]
        assert app.incidents.eviction_observer in app.push.hub.eviction_observers
        stream = app.open_event_stream("/events?class=debug")
        assert gw.handle("/tpu").status == 200
        engines["now"] = _paging("dashboard_render")
        gw.shed_policy.invalidate()
        assert gw.handle("/debug/traces").status == 503
        assert dict(gw.handle("/tpu").headers)["X-Headlamp-Stale"] == "1"
        # A paging burn closes the debug-class stream with one bye.
        app.push.hub.poll(stream)
        assert stream.evicted_reason is not None
        engines["now"] = tslo.SLOEngine()
        gw.shed_policy.invalidate()
        assert dict(gw.handle("/tpu").headers)["X-Headlamp-Stale"] == "0"
        events = json.loads(app.handle("/debug/incidentz")[2])["events"]
        kinds = [(e["source"], e["kind"]) for e in events]
        for want in (("gateway", "paging"), ("gateway", "shed"), ("gateway", "degrade"),
                     ("push", "eviction"), ("gateway", "restore")):
            assert want in kinds, want
        assert kinds.index(("gateway", "paging")) < kinds.index(("gateway", "shed"))
        assert kinds.index(("push", "eviction")) < kinds.index(("gateway", "restore"))
        shed = next(e for e in events if e["kind"] == "shed")
        assert shed["detail"]["route"] == "/debug/traces"
        eviction = next(e for e in events if e["kind"] == "eviction")
        assert eviction["detail"]["reason"] == stream.evicted_reason
        assert [e["seq"] for e in events] == sorted(e["seq"] for e in events)
    finally:
        app.close()
    rep = ReplicaApp(device="cpu")
    try:
        assert rep.incidents.eviction_observer in rep.push.hub.eviction_observers
        assert rep.incidents.ledger is rep.ledger
    finally:
        rep.close()


def test_the_runner_closes_every_app_it_built_the_live_hub_too():
    seen = {}

    def keep(ctx):
        seen["ctx"] = ctx

    report = ScenarioRunner(get_scenario("hub_restart_herd"), device="cpu", sabotage=keep).run()
    assert report.passed
    ctx = seen["ctx"]
    assert ctx.apps == [ctx.app]
    hub = ctx.app.push.hub
    assert hub is ctx.hub() and report.extra["resume_fallbacks"] == 6
    assert hub._closed_reason == "shutdown"
    assert all(sub.evicted_reason == "shutdown" for sub in ctx.faults["herd"])
    report = ScenarioRunner(get_scenario("leader_kill_mid_churn"), device="cpu",
                            sabotage=keep).run()
    assert report.passed and seen["ctx"].apps == [seen["ctx"].app, seen["ctx"].replica]
    assert not [t for t in threading.enumerate()
                if t.name.startswith("refresh-") and t.is_alive()]
    previous = tslo.engine()
    ScenarioRunner(get_scenario("clock_skew_scrape"), device="cpu").run()
    assert tslo.engine() is previous


def test_the_runners_entry_points_need_cuda_unless_asked_for_the_cpu():
    spec = get_scenario("clock_skew_scrape")
    if not torch.cuda.is_available():
        for call in (lambda: ScenarioRunner(spec), lambda: run_scenario(spec),
                     lambda: ScenarioContext(spec)):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
    ctx = ScenarioContext(spec, device="cpu")
    try:
        assert ctx.device == torch.device("cpu") and ctx.app.device == torch.device("cpu")
    finally:
        ctx.close()
    with pytest.raises(ValueError, match="unsupported device"):
        ScenarioRunner(spec, device="meta")

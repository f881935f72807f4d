"""The port's telemetry beyond spans against the JAX package's on the CPU:
the metric registry's renders (OpenMetrics with exemplars, the text
format without), its observers and readers; the flight recorder's wide
events and rings; the sampling profiler's call tree, fold and snapshot
on the same duck-typed frames under a scripted clock; and the generation
ledger's snapshot. Then the port's host wiring: exemplars on
``/metricsz`` that name traces in ``/debug/traces``, wide events pinned
for a 5xx or a violated objective, the ledger's sync→paint stamps, and
the profiler thread that only ``serve()`` starts and ``close()`` joins.

JAX's module state is left as found: its exemplar source is restored,
and its profiler and ledger counters are swapped for scratch instruments
for the duration of a test.
"""

import importlib
import json
import re
import threading
import urllib.request

import numpy as np
import pytest

from headlamp_tpu.obs import flight as jflight
from headlamp_tpu.obs import ledger as jledger
from headlamp_tpu.obs import metrics as jmetrics
from headlamp_tpu_torch.obs import flight as tflight
from headlamp_tpu_torch.obs import ledger as tledger
from headlamp_tpu_torch.obs import metrics as tmetrics
from headlamp_tpu_torch.obs import profiler as tprof
from headlamp_tpu_torch.obs import slo as tslo
from headlamp_tpu_torch.obs.trace import trace_ring
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport
from headlamp_tpu_torch.server import app as app_mod

# The JAX package's obs namespace exports a function named profiler,
# which shadows the module of that name as an attribute.
jprof = importlib.import_module("headlamp_tpu.obs.profiler")

CLOCK = 1785283200.0


def _port_to_jax(text: str) -> str:
    return text.replace("headlamp_tpu_torch_", "headlamp_tpu_")


@pytest.fixture
def exemplar_ids():
    """Both packages' exemplar sources read the same scripted cell;
    restored afterwards."""
    current = [None]
    saved = (jmetrics._EXEMPLAR_SOURCE, tmetrics._EXEMPLAR_SOURCE)
    jmetrics.set_exemplar_source(lambda: current[0])
    tmetrics.set_exemplar_source(lambda: current[0])
    try:
        yield current
    finally:
        jmetrics.set_exemplar_source(saved[0])
        tmetrics.set_exemplar_source(saved[1])


def _drive_registry(mod, prefix, current, seen):
    """The same instruments and observations on one package's registry."""
    reg = mod.MetricRegistry()
    requests = reg.counter(f"{prefix}requests_total", "Requests.", labels=("route", "status"))
    requests.add_observer(lambda v, labels: seen.append(("counter", v, dict(labels))))
    gauge = reg.gauge(f"{prefix}depth_count", "Depth.\nTwo lines.", labels=("queue",))
    hist = reg.histogram(f"{prefix}latency_seconds", "Latency.", labels=("route",))
    hist.add_observer(lambda v, labels: seen.append(("hist", v, dict(labels))))
    plain = reg.histogram(f"{prefix}fit_seconds", "Fits.", buckets=(0.1, 1.0, 10.0))
    reg.gauge_fn(f"{prefix}ratio_ratio", "A ratio.", lambda: 0.25)
    reg.gauge_fn(f"{prefix}missing_ratio", "No value yet.", lambda: None)
    reg.gauge_samples_fn(f"{prefix}slo_state_info", "States.", ("slo", "state"),
                         lambda: [(("render", "ok"), 1.0), (("fit", "warn"), 1), (("bad",), 2)])
    reg.counter_samples_fn(f"{prefix}worker_total", "Per worker.", ("worker",),
                           lambda: [(("0",), 3), ((1,), 4.5)])
    reg.gauge_samples_fn(f"{prefix}broken_info", "Raises.", ("x",), lambda: 1 / 0)
    rng = np.random.default_rng(4)
    for i in range(60):
        route = ("/tpu", "/tpu/metrics", 'we"ird\\')[i % 3]
        current[0] = f"{i:016x}" if i % 4 else None
        hist.observe(float(rng.lognormal(-3.0, 1.5)), route=route)
        requests.inc(route=route, status="200" if i % 7 else "500")
        plain.observe(float(rng.uniform(0, 20)))
        gauge.set(float(i), queue=str(i % 2))
    current[0] = None
    return reg, requests, hist


def test_registry_renders_equal_jax_up_to_the_prefix(exemplar_ids):
    jseen, tseen = [], []
    jreg, jreq, jhist = _drive_registry(jmetrics, "headlamp_tpu_x_", exemplar_ids, jseen)
    treg, treq, thist = _drive_registry(tmetrics, "headlamp_tpu_torch_x_", exemplar_ids, tseen)
    for openmetrics in (True, False):
        want = jreg.render(openmetrics=openmetrics)
        assert _port_to_jax(treg.render(openmetrics=openmetrics)) == want, openmetrics
    om = treg.render(openmetrics=True)
    assert om.endswith("# EOF\n") and ' # {trace_id="' in om
    assert ' # {trace_id="' not in treg.render()
    assert tseen == jseen and len(tseen) == 120
    assert thist.exemplars() == jhist.exemplars() and thist.exemplars()
    assert treq.samples() == jreq.samples()
    for route in ("/tpu", "/tpu/metrics"):
        assert treq.value_for(route=route, status="500") == jreq.value_for(route=route, status="500")
        assert thist.count_for(route=route) == jhist.count_for(route=route)
    for accept in (None, "", "text/plain", "application/openmetrics-text",
                   "text/plain;q=0.5, application/openmetrics-text; version=1.0.0; q=0.9",
                   "application/openmetrics-text;q=0", "application/openmetrics-text;q=x",
                   "APPLICATION/OPENMETRICS-TEXT"):
        assert tmetrics.negotiate_openmetrics(accept) == jmetrics.negotiate_openmetrics(accept)
    assert tmetrics.OPENMETRICS_CONTENT_TYPE == jmetrics.OPENMETRICS_CONTENT_TYPE


def _trace(i):
    return {
        "trace_id": f"{i:016x}",
        "spans": [
            {"name": "sync.snapshot", "duration_ms": 1.5 * i, "children": []},
            {"name": "page.component", "duration_ms": 3.25, "children": [
                {"name": "analytics.rollup", "duration_ms": 2.0, "children": []}]},
            {"name": "page.component", "duration_ms": 0.125, "children": []},
        ],
    }


def test_wide_events_and_recorder_equal_jax():
    recorders = (jflight.FlightRecorder(capacity=6, pinned_capacity=3),
                 tflight.FlightRecorder(capacity=6, pinned_capacity=3))
    for i in range(11):
        kwargs = dict(
            path=f"/tpu?page={i}", route="/tpu", status=500 if i % 4 == 3 else 200,
            duration_s=0.0123 * i, trace=_trace(i) if i % 2 else None,
            violations=["dashboard_render"] if i % 5 == 2 else [],
            counters_before={"transfer.blocking_gets": i, "history.syncs": 2, "flag": True,
                             "label": "x", "ratio": 0.5},
            counters_after={"transfer.blocking_gets": i + (i % 3), "history.syncs": 2,
                            "flag": False, "label": "y", "ratio": 0.75, "new.counter": 4},
        )
        events = [mod.wide_event(**kwargs) for mod in (jflight, tflight)]
        assert events[1] == events[0]
        pinned = bool(kwargs["violations"]) or kwargs["status"] >= 500
        for rec, event in zip(recorders, events):
            rec.record(event, pinned=pinned)
    want, got = (r.snapshot() for r in recorders)
    assert got == want and len(got["pinned"]) == 3 and len(got["recent"]) == 6
    assert len(recorders[1]) == len(recorders[0])
    assert recorders[1].memory_bytes() == recorders[0].memory_bytes()
    assert tflight.counters_delta({"a": 1}, {"a": 1.5, "b": 2}) == jflight.counters_delta(
        {"a": 1}, {"a": 1.5, "b": 2})


class _Code:
    def __init__(self, filename, name, line):
        self.co_filename, self.co_name, self.co_firstlineno = filename, name, line


class _Frame:
    def __init__(self, code, back=None):
        self.f_code, self.f_back = code, back


def _stack(*funcs):
    """A leaf frame whose f_back chain runs to the first of ``funcs``."""
    frame = None
    for filename, name, line in funcs:
        frame = _Frame(_Code(filename, name, line), frame)
    return frame


def _frames(rng):
    files = ["/srv/app/tests/test_load.py", "/usr/lib/python3.12/threading.py", "/srv/lib/mod.py"]
    out = {}
    for ident in (101, 102, 103):
        depth = int(rng.integers(1, 6))
        out[ident] = _stack(*[(files[int(rng.integers(3))], f"fn{int(rng.integers(9))}",
                               int(rng.integers(1, 400))) for _ in range(depth)])
    return out


def test_profiler_tree_fold_and_snapshot_equal_jax(monkeypatch):
    for mod in (jprof, tprof):
        scratch = mod._registry.__class__()
        name = "headlamp_tpu_scratch_" if mod is jprof else "headlamp_tpu_torch_scratch_"
        monkeypatch.setattr(mod, "_SAMPLES_TOTAL", scratch.counter(name + "samples_total", "s"))
        monkeypatch.setattr(mod, "_STACKS_TOTAL",
                            scratch.counter(name + "stacks_total", "s", labels=("route",)))
        monkeypatch.setattr(mod, "_COLLAPSED_TOTAL", scratch.counter(name + "collapsed_total", "s"))
        monkeypatch.setattr(mod, "_history_store", lambda: None)
        monkeypatch.setitem(mod._THREAD_ROUTES, 101, ("/tpu/metrics", "00000000000000aa"))
        monkeypatch.setitem(mod._THREAD_ROUTES, 102, ("/tpu", None))
    t = [500.0]
    profs = [mod.SamplingProfiler(monotonic=lambda: t[0], max_nodes=24, max_depth=4)
             for mod in (jprof, tprof)]
    rng = np.random.default_rng(11)
    frames = [None]
    for prof in profs:  # tick() samples the scripted frames
        prof.sample_once = (lambda sample=prof.sample_once: sample(frames[0]))
    ticks = []
    for step in range(80):
        t[0] += 0.05
        if step == 30:
            assert profs[1].burst(5.0) == profs[0].burst(5.0) == 5.0
        frames[0] = _frames(rng)
        ticks.append([prof.tick() for prof in profs])
    assert all(a == b for a, b in ticks) and sum(a for a, _ in ticks) > 20
    want, got = (p.snapshot() for p in profs)
    for snap in (want, got):
        assert snap.pop("overhead_ns_per_sample") is not None
    assert got == want and got["collapsed_stacks"] > 0
    assert got["routes"]["/tpu/metrics"]["last_trace_id"] == "00000000000000aa"
    assert profs[1].folded() == profs[0].folded() != ""
    assert profs[1].counters() == profs[0].counters()
    assert profs[1].burst(600) == profs[0].burst(600) == tprof.PROFILER_MAX_BURST_S


def test_ledger_snapshots_equal_jax(monkeypatch):
    mono, wall = [100.0], [CLOCK]
    ledgers = []
    for mod, name in ((jledger, "headlamp_tpu_"), (tledger, "headlamp_tpu_torch_")):
        scratch = mod.registry.__class__()
        monkeypatch.setattr(mod, "_STAGE_SECONDS", scratch.histogram(
            name + "stage_seconds", "s", labels=("stage",)))
        monkeypatch.setattr(mod, "_AGE_AT_PAINT", scratch.histogram(
            name + "age_seconds", "s", labels=("role",)))
        ledgers.append(mod.GenerationLedger(monotonic=lambda: mono[0], wall=lambda: wall[0],
                                            capacity=4, pinned_capacity=2))

    def both(method, *args, **kwargs):
        out = [getattr(led, method)(*args, **kwargs) for led in ledgers]
        assert out[1] == out[0], (method, args)
        return out[0]

    def advance(seconds):
        mono[0] += seconds
        wall[0] += seconds

    for gen in range(1, 8):
        both("scrape_started")
        advance(0.25 * gen)
        both("synced", gen, trace_id=f"{gen:016x}")
        advance(1.5 if gen != 2 else 12.0)  # generation 2 breaches freshness
        if gen == 3:
            both("published", gen)
            both("diff_framed", gen)
        age = both("paint", gen, trace_id=f"{gen + 100:016x}")
        assert age is not None and both("paint", gen) is None
        advance(0.125)
    both("applied", 9, origin={"published_wall": wall[0] - 2.0, "scrape_start_wall": wall[0] - 3.0})
    advance(0.5)
    assert both("paint", 9) is not None
    both("synced", 0)
    both("note_transition", "elected", fencing=3)
    assert both("provenance", 7) and both("provenance", 1) is None
    want, got = (led.snapshot() for led in ledgers)
    assert got == want and got["breaches"] == 1 and got["pinned"][0]["generation"] == 2
    assert tledger.STAGES == jledger.STAGES
    assert tledger.FRESHNESS_THRESHOLD_S == jledger.FRESHNESS_THRESHOLD_S


@pytest.fixture
def engine():
    """A fresh port SLO engine as the process engine, restored after."""
    eng = tslo.SLOEngine(device="cpu")
    previous = tslo.set_engine(eng)
    try:
        yield eng
    finally:
        eng.drain()
        tslo.set_engine(previous)


def test_metricsz_exemplars_name_traces_in_the_ring(engine, monkeypatch):
    # A metrics registry of this test's own for the app and the engine:
    # each bucket of the process-wide histogram keeps the latest exemplar
    # of any earlier test, and the engine lists the 8 slowest buckets.
    own = tmetrics.MetricRegistry()
    monkeypatch.setattr(app_mod, "metrics_registry", own)
    monkeypatch.setattr(tslo, "_metrics_registry", own)
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=lambda: CLOCK)
    try:
        for path in ("/tpu", "/tpu/metrics", "/tpu/nodes", "/tpu/metrics"):
            assert app.handle(path)[0] == 200
        status, ctype, body = app.handle("/metricsz", "application/openmetrics-text")
        assert (status, ctype) == (200, tmetrics.OPENMETRICS_CONTENT_TYPE)
        assert body.endswith("# EOF\n")
        ids = set(re.findall(r'^headlamp_tpu_torch_request_duration_seconds_bucket\{[^}]*\} \d+ '
                             r'# \{trace_id="([0-9a-f]{16})"\} ', body, re.M))
        traces = json.loads(app.handle("/debug/traces")[2])["traces"][:4]
        # Each bucket keeps its latest exemplar: this test's last request
        # of each route is there, and names a trace in the ring.
        latest = {t["route"]: t["trace_id"] for t in reversed(traces)}
        assert set(latest.values()) <= ids
        status, ctype, text = app.handle("/metricsz", "text/plain")
        assert ctype == tmetrics.TEXT_CONTENT_TYPE and "# {trace_id" not in text
        exemplars = engine.report(include_forecast=False)["slos"][0]["exemplars"]
        assert latest["/tpu/metrics"] in {e["trace_id"] for e in exemplars}
        assert all(e["labels"] == {"route": "/tpu/metrics"} for e in exemplars)
    finally:
        app.close()


def test_wide_events_pin_a_5xx_and_a_violated_objective(monkeypatch):
    strict = tslo.SLOSpec(name="strict_render", description="every /tpu paint under 0 s",
                          target=0.99, threshold_s=0.0, latency_where={"route": ("/tpu",)})
    # The process engine for this test only (monkeypatch restores it).
    monkeypatch.setattr(tslo, "_engine", tslo.SLOEngine((strict,), device="cpu"))
    tflight.flight_recorder.clear()
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=lambda: CLOCK)
    try:
        assert app.handle("/tpu")[0] == 200
        assert app.handle("/tpu/pods")[0] == 200
        assert app.handle("/healthz")[0] == 200  # probes are not recorded

        def broken():
            raise RuntimeError("rollup launch failed")

        monkeypatch.setattr(app, "_synced_snapshot", broken)
        assert app.handle("/tpu/nodes")[0] == 500
        flight = json.loads(app.handle("/debug/flightz")[2])
    finally:
        app.close()
    assert [e["route"] for e in flight["recent"]] == ["/tpu/nodes", "/tpu/pods", "/tpu"]
    pinned = {e["route"]: e for e in flight["pinned"]}
    assert set(pinned) == {"/tpu", "/tpu/nodes"}
    assert pinned["/tpu"]["slo_violations"] == ["strict_render"]
    assert pinned["/tpu/nodes"]["status"] == 500
    first = pinned["/tpu"]
    ring = {t["trace_id"]: t for t in trace_ring.snapshot()}
    assert first["trace_id"] in ring and "render.html" in first["stages"]
    assert first["counters"]["history.syncs"] == 1  # the inline sync it paid


def test_the_ledger_stamps_each_generation_from_sync_to_first_paint():
    """An inline sync stamps the scrape and the snapshot, the push
    differ its diff, the page its first paint (later paints of the
    generation stamp nothing); a background tick stamps the next scrape
    and sync."""
    mono = [1000.0]
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=lambda: CLOCK,
                       monotonic=lambda: mono[0], min_sync_interval_s=60.0)
    try:
        assert app.handle("/tpu")[0] == 200
        first_trace = trace_ring.snapshot()[0]["trace_id"]
        mono[0] += 2.0
        assert app.handle("/tpu/pods")[0] == 200  # coalesced: the same generation
        gen = app.snapshot_generation()
        entry = json.loads(app.handle("/debug/generationz")[2])["generations"][0]
        app._background_tick()
        after_tick = app.ledger.snapshot()
        page = app.handle("/debug/generationz/html")
    finally:
        app.close()
    assert entry["generation"] == gen > 0
    assert list(entry["stages"]) == ["scrape_start", "synced", "diff_framed", "first_paint"]
    assert entry["age_at_paint_ms"] == 0.0 and not entry["breached"]
    assert entry["trace_ids"] == {"synced": first_trace, "first_paint": first_trace}
    assert entry["stages"]["first_paint"]["lag_ms"] == 0.0
    assert app.ledger._pending_scrape is None  # the tick's scrape became a generation
    assert after_tick["generations"][0]["stages"].keys() >= {"scrape_start", "synced"}
    assert page[0] == 200 and "Generation Provenance" in page[2]


def test_serve_starts_the_profiler_and_close_joins_it(engine):
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=lambda: CLOCK)
    server = app.serve("127.0.0.1", 0)
    prof = tprof.profiler()
    try:
        assert prof.running()
        with urllib.request.urlopen(server.url + "/debug/profilez?burst=5", timeout=60) as resp:
            assert json.loads(resp.read())["burst_granted_s"] == 5.0
        for _ in range(3):
            with urllib.request.urlopen(server.url + "/tpu", timeout=60) as resp:
                assert resp.status == 200
        req = urllib.request.Request(server.url + "/metricsz",
                                     headers={"Accept": "application/openmetrics-text"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.headers["Content-Type"].startswith("application/openmetrics-text")
        health = json.loads(urllib.request.urlopen(server.url + "/healthz", timeout=60).read())
        assert health["runtime"]["profiler"]["running"] is True
    finally:
        server.close()
    assert not prof.running()
    assert not any(t.name == "hl-torch-profiler" for t in threading.enumerate())

"""The port's debug pages (``headlamp_tpu_torch/obs/debug_pages.py``)
against the JAX package's on the CPU: for the same snapshot dicts, the
trace waterfall, the SLO status page, the profiler's flame view and the
generation timeline render to the same bytes (the timeline's hint names
the port's own stage-lag metric), empty states included; and the host
paints each page inside its ``<main>`` from the snapshot its JSON twin
serves, reading no cluster snapshot.
"""

import copy
import json

import pytest

from headlamp_tpu.obs import debug_pages as jpages
from headlamp_tpu.obs import slo as jslo
from headlamp_tpu.ui import components as jcomponents
from headlamp_tpu.ui.vdom import render_html as jrender
from headlamp_tpu_torch.obs import debug_pages as tpages
from headlamp_tpu_torch.obs import profiler as tprof
from headlamp_tpu_torch.obs.ledger import GenerationLedger
from headlamp_tpu_torch.obs.trace import trace_ring
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport
from headlamp_tpu_torch.ui import components as tcomponents
from headlamp_tpu_torch.ui.vdom import render_html as trender

CLOCK = 1785283200.0


def _equal(name, snapshot):
    want = jrender(getattr(jpages, name)(copy.deepcopy(snapshot)))
    got = trender(getattr(tpages, name)(copy.deepcopy(snapshot)))
    assert got == want.replace("headlamp_tpu_generation", "headlamp_tpu_torch_generation"), name
    return got


@pytest.fixture(scope="module")
def host_snapshots():
    """Real snapshots from a port host: its traces, its ledger."""
    mono = [500.0]
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=lambda: CLOCK,
                       monotonic=lambda: mono[0])
    try:
        for path in ("/tpu", "/tpu/nodes?page=2", "/tpu/metrics", "/nodes", "/node/nope"):
            mono[0] += 0.75
            app.handle(path)
        return {"traces": trace_ring.snapshot()[:5], "ledger": app.ledger.snapshot()}
    finally:
        app.close()


def test_traces_page_equals_jax(host_snapshots):
    traces = host_snapshots["traces"]
    assert len(traces) == 5 and any(t["status"] == 404 for t in traces)
    html = _equal("traces_page", traces)
    assert html.count('class="hl-section hl-trace"') == 5
    for t in traces:
        assert f'id="trace-{t["trace_id"]}"' in html


def _slo_report():
    """A JAX engine's report through a burn, with exemplars and each kind
    of budget-forecast line."""
    t = [1000.0]
    eng = jslo.SLOEngine(monotonic=lambda: t[0])
    for minute in range(90):
        t[0] = 1000.0 + 60 * minute
        for i in range(10):
            bad = minute > 60 and i < 4
            eng.feed_latency(jslo.REQUEST_DURATION, 0.9 if bad else 0.05, {"route": "/tpu"})
            eng.feed_latency(jslo.REQUEST_DURATION, 2.5 if bad else 0.3, {"route": "/tpu/metrics"})
        eng.feed_latency(jslo.FIT_DURATION, 1.0, {"refresher": "forecast"})
    report = eng.report(include_exemplars=False, include_forecast=False)
    report["slos"][0]["exemplars"] = [
        {"trace_id": "0123456789abcdef", "le": "2.048", "value": 1.8421, "labels": {}},
        {"trace_id": "", "le": "4.096", "value": 3.0, "labels": {}},
    ]
    return report


@pytest.mark.parametrize("forecast", [
    None,
    {"slo": "scrape_paint", "points": 512, "window": "1h", "data_source": "history",
     "projected_exhaustion_windows": 7, "projected_burn_rate": 12.5},
    {"slo": "scrape_paint", "points": 512, "window": "1h", "data_source": "history",
     "projected_exhaustion_windows": None, "reason": "fit_failed", "error": "RuntimeError: x"},
])
def test_slo_page_equals_jax(forecast):
    report = _slo_report()
    if forecast is not None:
        report["budget_forecast"] = forecast
    html = _equal("slo_page", report)
    states = [s["state"] for s in report["slos"]]
    assert "page" in states and html.index('data-state="page"') < html.index('data-state="ok"')


def test_profile_page_equals_jax():
    prof = tprof.SamplingProfiler(monotonic=lambda: 0.0, max_nodes=6)

    class Code:
        def __init__(self, name, line):
            self.co_filename, self.co_name, self.co_firstlineno = "/x/tests/t.py", name, line

    class Frame:
        def __init__(self, code, back):
            self.f_code, self.f_back = code, back

    frames = {}
    for ident in range(1, 7):
        frame = None
        for depth in range(ident % 4 + 1):
            frame = Frame(Code(f"f{(ident + depth) % 5}", depth + 1), frame)
        frames[ident] = frame
    for _ in range(3):
        prof.sample_once(frames)
    snap = prof.snapshot()
    assert snap["collapsed_stacks"] > 0
    _equal("profile_page", snap)
    _equal("profile_page", dict(snap, bursting=True, overhead_ns_per_sample=None))


def test_generations_page_equals_jax(host_snapshots):
    _equal("generations_page", host_snapshots["ledger"])
    mono, wall = [0.0], [CLOCK]
    led = GenerationLedger(monotonic=lambda: mono[0], wall=lambda: wall[0], capacity=2)
    for gen in (1, 2, 3, 4):
        led.scrape_started()
        mono[0] += 0.5
        wall[0] += 0.5
        led.synced(gen, trace_id=f"{gen:016x}")
        step = 15.0 if gen == 1 else 0.25
        mono[0] += step
        wall[0] += step
        led.paint(gen, trace_id=f"{gen + 8:016x}")
    led.applied(7, origin={"trace_id": "feedfacefeedface", "published_wall": wall[0] - 1})
    led.note_transition("elected", fencing=2)
    snap = led.snapshot()
    assert snap["pinned"] and snap["transitions"]
    html = _equal("generations_page", snap)
    assert "headlamp_tpu_torch_generation_stage_seconds" in html and "STALE" in html


@pytest.mark.parametrize("name,empty", [
    ("traces_page", []),
    ("slo_page", {}),
    ("profile_page", {}),
    ("generations_page", {}),
])
def test_empty_pages_equal_jax(name, empty):
    assert "hl-empty-content" in _equal(name, empty)


def test_budget_bar_and_section_header_equal_jax():
    for ratio in (-1.0, 0.0, 0.05, 0.1, 0.2999, 0.3, 0.5, 1.0, 2.0):
        assert trender(tcomponents.BudgetBar(ratio)) == jrender(jcomponents.BudgetBar(ratio))
    assert trender(tcomponents.SectionHeader("Objectives", "a", "b")) == jrender(
        jcomponents.SectionHeader("Objectives", "a", "b"))
    assert trender(tcomponents.SectionHeader("Bare")) == jrender(jcomponents.SectionHeader("Bare"))


def test_the_host_paints_each_page_from_its_json_twins_snapshot():
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=lambda: CLOCK)
    try:
        for path, twin, page in (
            ("/debug/generationz/html", "/debug/generationz", tpages.generations_page),
            ("/debug/profilez/html", "/debug/profilez", tpages.profile_page),
            ("/debug/traces/html", "/debug/traces", None),
        ):
            snapshot = json.loads(app.handle(twin)[2])
            status, ctype, body = app.handle(path)
            assert (status, ctype) == (200, "text/html")
            if page is None:
                page, snapshot = tpages.traces_page, snapshot["traces"]
            assert body.split("<main>")[1].split("</main>")[0] == trender(page(snapshot))
        status, _, body = app.handle("/sloz/html")
        assert status == 200 and "Service Level Objectives" in body
        assert app._last_snapshot is None  # no page here read a cluster snapshot
    finally:
        app.close()

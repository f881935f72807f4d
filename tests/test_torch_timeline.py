"""The port's incident timeline (``headlamp_tpu_torch/obs/timeline.py``)
against JAX's on the CPU: the same scripted marks, injections, drill
phases, SLO samples, observer calls and ledger transitions, fed to both on
the same injected clocks, give equal ``snapshot()`` JSON and equal
``health_block()``; the ring keeps its bound; a ledger transition lands
where JAX's wall merge puts it; and a raising ledger is counted and named
by the port (JAX swallows it) while both still paint their own events.
"""

from __future__ import annotations

import json

import pytest

from headlamp_tpu.obs import debug_pages as jpages
from headlamp_tpu.obs.ledger import GenerationLedger as JaxLedger
from headlamp_tpu.obs.timeline import IncidentTimeline as JaxTimeline
from headlamp_tpu.ui.vdom import render_html as jrender
from headlamp_tpu_torch.obs import debug_pages as tpages
from headlamp_tpu_torch.obs import metrics as tmetrics
from headlamp_tpu_torch.obs.ledger import GenerationLedger
from headlamp_tpu_torch.obs.timeline import TIMELINE_CAPACITY, IncidentTimeline
from headlamp_tpu_torch.ui.vdom import render_html as trender

pytestmark = pytest.mark.scenario


class Clock:
    def __init__(self, now: float) -> None:
        self.now = now

    def __call__(self) -> float:
        return self.now


def _pair(capacity: int = TIMELINE_CAPACITY, ledgers: bool = False):
    """A JAX and a port timeline on one pair of scripted clocks (and, with
    ``ledgers``, each its own package's ledger on the same clocks)."""
    mono, wall = Clock(1000.0), Clock(1_700_000_000.0)
    jt = JaxTimeline(monotonic=mono, wall=wall, capacity=capacity)
    tt = IncidentTimeline(monotonic=mono, wall=wall, capacity=capacity)
    if ledgers:
        jt.ledger = JaxLedger(monotonic=mono, wall=wall)
        tt.ledger = GenerationLedger(monotonic=mono, wall=wall)
    return mono, wall, jt, tt


def _both(timelines, method, *args):
    return [getattr(t, method)(*args) for t in timelines]


def _dump(timeline) -> str:
    return json.dumps(timeline.snapshot(), sort_keys=True)


def _script(mono, wall, timelines, ledgers=()):
    """A drill's worth of every source, on scripted clocks."""
    _both(timelines, "mark", "scenario", "note", {"before": True})
    mono.now += 5.0
    wall.now += 5.0
    _both(timelines, "begin_drill", "parity_drill")
    health = [[t.health_block() for t in timelines]]
    _both(timelines, "set_phase", "inject")
    _both(timelines, "inject", "parity_drill", "preemption", {"node": "tpu-0"})
    for step, states in enumerate(
        [{"dashboard_render": "warn"}, {"dashboard_render": "page", "scrape_paint": "ok"},
         {"dashboard_render": "page", "scrape_paint": "warn"}, {"dashboard_render": "ok"}]
    ):
        mono.now += 30.0
        wall.now += 30.0
        if step == 1:
            for ledger in ledgers:
                ledger.note_transition("elected", fencing=2)
        assert len({t.sample_slo(states) for t in timelines}) == 1
        _both(timelines, "gateway_observer", "shed", {"route": "/debug/traces", "priority": 2})
    health.append([t.health_block() for t in timelines])
    _both(timelines, "set_phase", "recover")
    _both(timelines, "eviction_observer", "slow_consumer", {"priority": "interactive",
                                                            "pages": ["fleet"]})
    _both(timelines, "gateway_observer", "restore", {})
    health.append([t.health_block() for t in timelines])
    _both(timelines, "end_drill", "passed")
    health.append([t.health_block() for t in timelines])
    return health


def test_the_same_script_gives_equal_snapshots_and_health_blocks():
    mono, wall, jt, tt = _pair(ledgers=True)
    health = _script(mono, wall, (jt, tt), (jt.ledger, tt.ledger))
    for jax_block, port_block in health:
        assert port_block == jax_block
    assert health[0][1]["active"] == "parity_drill" and health[-1][1] is None
    assert health[1][1] == {"active": "parity_drill", "phase": "inject", "injections": 1,
                            "events": 12}
    assert _dump(tt) == _dump(jt)
    snap = tt.snapshot()
    sources = [e["source"] for e in snap["events"]]
    assert {"scenario", "slo", "gateway", "push", "elector"} == set(sources)
    assert snap["events"][0].get("scenario") is None
    assert snap["events"][-1]["kind"] == "drill_end"
    assert tt.ledger_errors == 0 and tt.last_ledger_error is None


def test_the_ring_keeps_its_bound_and_the_newest_events():
    mono, wall, jt, tt = _pair(capacity=16)
    for i in range(40):
        mono.now += 1.0
        _both((jt, tt), "mark", "scenario", "tick", {"i": i})
    snap = tt.snapshot()
    assert snap["capacity"] == 16 and snap["events_total"] == 40
    assert [e["seq"] for e in snap["events"]] == list(range(25, 41))
    assert _dump(tt) == _dump(jt)
    assert IncidentTimeline().snapshot()["capacity"] == TIMELINE_CAPACITY == 256


@pytest.mark.parametrize("offset", [-10.0, 0.0, 7.5, 10.0, 35.0, 1e6])
def test_a_ledger_transition_lands_where_the_wall_merge_puts_it(offset):
    mono, wall, jt, tt = _pair(ledgers=True)
    base = wall.now
    for i in range(4):
        _both((jt, tt), "mark", "gateway", "shed", {"i": i})
        wall.now += 10.0
        mono.now += 10.0
    wall.now = base + offset
    for ledger in (jt.ledger, tt.ledger):
        ledger.note_transition("deposed", fencing=3)
    events = tt.events()
    assert events == jt.events()
    position = [e["source"] for e in events].index("elector")
    # Before the first own event stamped at or after the transition.
    assert position == sum(1 for e in events if e["source"] != "elector" and e["wall"] < base + offset)
    assert events[position] == {"seq": None, "mono": None, "wall": base + offset,
                                "source": "elector", "kind": "deposed", "detail": {"fencing": 3}}


class _BrokenLedger:
    def snapshot(self):
        raise RuntimeError("ledger lock poisoned")


def test_a_raising_ledger_is_counted_named_and_painted_without_transitions():
    mono, wall, jt, tt = _pair()
    jt.ledger = tt.ledger = _BrokenLedger()
    _both((jt, tt), "begin_drill", "broken_ledger")
    _both((jt, tt), "inject", "broken_ledger", "leader_kill", {"fencing": 1})
    assert _dump(tt) == _dump(jt)
    assert tt.ledger_errors == 1
    assert tt.last_ledger_error == "RuntimeError: ledger lock poisoned"
    assert [e["source"] for e in tt.events()] == ["scenario", "scenario"]
    assert tt.ledger_errors == 2
    html = trender(tpages.incidents_page(tt.snapshot()))
    assert html == jrender(jpages.incidents_page(jt.snapshot()))
    assert html.count('class="hl-span-row"') == 2 and "DRILL ACTIVE" in html
    assert set(tt.snapshot()) == {"capacity", "events_total", "drills_total", "active", "events"}


def test_sample_slo_records_only_flips_from_an_implicit_ok():
    mono, wall, jt, tt = _pair()
    assert [t.sample_slo({"a": "ok", "b": "warn"}) for t in (jt, tt)] == [1, 1]
    assert [t.sample_slo({"a": "ok", "b": "warn"}) for t in (jt, tt)] == [0, 0]
    assert [t.sample_slo({"a": "page"}) for t in (jt, tt)] == [1, 1]
    kinds = [(e["detail"]["slo"], e["detail"]["from"], e["detail"]["to"]) for e in tt.events()]
    assert kinds == [("b", "ok", "warn"), ("a", "ok", "page")]
    assert _dump(tt) == _dump(jt)


def test_the_counters_carry_the_ports_names():
    timeline = IncidentTimeline(monotonic=Clock(5.0), wall=Clock(6.0))
    timeline.begin_drill("names_drill")
    timeline.inject("names_drill", "clock_skew", {"step_s": 3600.0})
    timeline.end_drill("passed")
    text = tmetrics.registry.render()
    for name in ("scenario_injections_total", "scenario_timeline_events_total",
                 "scenario_runs_total"):
        assert f"headlamp_tpu_torch_{name}" in text, name
    assert 'headlamp_tpu_torch_scenario_injections_total{scenario="names_drill",fault="clock_skew"}' in text
    assert 'headlamp_tpu_torch_scenario_runs_total{scenario="names_drill",outcome="passed"}' in text

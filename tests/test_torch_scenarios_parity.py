"""The port's six incident drills (``headlamp_tpu_torch/scenarios``) against
JAX's on the CPU: for each drill the port's transcript equals JAX's byte
for byte, and so do its timeline events, its counters and its response
metrics; two port runs are byte-identical; the response values are the
ones JAX's drill matrix records; the catalog's names and order are JAX's.

Real request durations feed the drills' scripted-clock SLO engines (as in
both hosts), so a first paint that compiles or warms up could page a
drill. Both packages run every drill once before the comparisons, and
JAX's process-wide fleet cache is cleared before each JAX drill.
"""

from __future__ import annotations

import json

import pytest

from headlamp_tpu.runtime.device_cache import fleet_cache as jax_fleet_cache
from headlamp_tpu.scenarios import SCENARIO_NAMES as JAX_NAMES
from headlamp_tpu.scenarios import ScenarioRunner as JaxRunner
from headlamp_tpu.scenarios import get_scenario as jax_scenario
from headlamp_tpu_torch.scenarios import (
    SCENARIO_NAMES,
    ScenarioAssertionError,
    ScenarioRunner,
    all_scenarios,
    get_scenario,
    run_scenario,
)

pytestmark = pytest.mark.scenario

#: The response values of JAX's drill matrix on the CPU (its recorded
#: ``bench_scenarios`` round): ratios fixed by the scripted clocks.
RESPONSE_VALUES = {
    "preemption_wave": {"shed_rate_debug": 0.75, "stale_paint_rate": 0.5,
                        "windows_to_page": 0.0, "recovery_windows": 4.0},
    "prom_flapping": {"shed_rate_debug": 11 / 19, "stale_paint_rate": 11 / 57,
                      "windows_to_page": 0.0, "recovery_windows": 2.5},
    "leader_kill_mid_churn": {"shed_rate_debug": 0.0, "stale_paint_rate": 2 / 11,
                              "windows_to_page": None, "recovery_windows": None},
}


def _jax_run(name):
    jax_fleet_cache.invalidate()
    return JaxRunner(jax_scenario(name)).run()


def _port_run(name):
    return ScenarioRunner(get_scenario(name), device="cpu").run()


@pytest.fixture(scope="module")
def warmed():
    """Every drill once in each package: JAX's first paints compile."""
    for name in SCENARIO_NAMES:
        _jax_run(name)
        _port_run(name)


def test_the_catalog_is_jaxs():
    assert SCENARIO_NAMES == JAX_NAMES == (
        "preemption_wave",
        "prom_flapping",
        "hub_restart_herd",
        "slow_loris_sse",
        "clock_skew_scrape",
        "leader_kill_mid_churn",
    )
    assert [s.name for s in all_scenarios()] == list(SCENARIO_NAMES)
    assert get_scenario("preemption_wave") is not get_scenario("preemption_wave")
    for name in SCENARIO_NAMES:
        port, jax = get_scenario(name), jax_scenario(name)
        assert (port.description, port.tick_s, port.read_tier) == (
            jax.description, jax.tick_s, jax.read_tier)
        assert [(p.kind, p.duration_s, len(p.enter), len(p.tick)) for p in port.phases] == [
            (p.kind, p.duration_s, len(p.enter), len(p.tick)) for p in jax.phases]
    with pytest.raises(KeyError, match="preemption_wave"):
        get_scenario("nope")


@pytest.mark.parametrize("name", SCENARIO_NAMES)
def test_the_drill_equals_jaxs_byte_for_byte(warmed, name):
    jax = _jax_run(name)
    first = _port_run(name)
    second = _port_run(name)
    assert jax.passed and first.passed and second.passed, [str(f) for f in first.failures]
    assert first.counters["non_shed_5xx"] == 0
    assert first.transcript, "the drill recorded no transcript"
    lines = first.transcript.splitlines()
    assert json.loads(lines[0])["note"] == f"scenario:{name}"
    assert first.transcript == jax.transcript
    assert first.transcript == second.transcript
    events = json.dumps(first.events, sort_keys=True)
    assert events == json.dumps(jax.events, sort_keys=True)
    assert events == json.dumps(second.events, sort_keys=True)
    assert first.counters == jax.counters == second.counters
    assert first.metrics == jax.metrics == second.metrics
    kinds = [(e["source"], e["kind"]) for e in first.events]
    assert ("scenario", "drill_start") in kinds and ("scenario", "drill_end") in kinds
    if name == "leader_kill_mid_churn":
        assert "elector" in {e["source"] for e in first.events}
    for key, want in RESPONSE_VALUES.get(name, {}).items():
        got = first.metrics[key]
        assert got == (want if want is None else pytest.approx(want, abs=1e-12)), key


def test_run_scenario_returns_a_pass_and_raises_the_first_failed_check(warmed):
    report = run_scenario(get_scenario("clock_skew_scrape"), device="cpu")
    assert report.passed and report.metrics["zero_5xx"] is True

    def stale_everywhere(ctx):
        ctx.policy.degraded_probe = lambda: True

    with pytest.raises(ScenarioAssertionError, match=r"\[clock_skew_scrape\] no_stale_paints"):
        run_scenario(get_scenario("clock_skew_scrape"), device="cpu", sabotage=stale_everywhere)

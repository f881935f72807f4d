"""Each of the port's drill assertions fires against the broken policy it
guards: JAX's seven counterexample cases (``tests/test_scenarios.py``),
rebuilt over the port's doubles (its ``Decision``, its ``BroadcastHub``, its
engine, policy, hub and replica), each trip exactly its own check (the
swallowed page, the checks that depend on a page too), with the same
messages as JAX's doubles, and the drill's ``drill_end`` on the timeline
reads ``failed``. A scenario that cannot fail proves nothing.
"""

from __future__ import annotations

import pytest

from headlamp_tpu.gateway.shed import Decision as JaxDecision
from headlamp_tpu.push.hub import BroadcastHub as JaxHub
from headlamp_tpu.runtime.device_cache import fleet_cache as jax_fleet_cache
from headlamp_tpu.scenarios import ScenarioRunner as JaxRunner
from headlamp_tpu.scenarios import get_scenario as jax_scenario
from headlamp_tpu_torch.gateway.shed import Decision
from headlamp_tpu_torch.push.hub import BroadcastHub
from headlamp_tpu_torch.scenarios import ScenarioRunner, get_scenario

pytestmark = pytest.mark.scenario


def _shedding_disabled(decision_type):
    """Admission never sheds (a 503-free gateway)."""

    def sabotage(ctx):
        original = ctx.policy.decide

        def decide(route, priority):
            ruling = original(route, priority)
            return decision_type(
                shed=False, degraded=ruling.degraded, burn_state=ruling.burn_state
            )

        ctx.policy.decide = decide

    return sabotage


def _paging_swallowed(ctx):
    """The engine reports burn but never ``page``."""
    original = ctx.engine.health_block

    def health_block():
        return {
            name: ("ok" if state == "page" else state)
            for name, state in original().items()
        }

    ctx.engine.health_block = health_block
    ctx.policy.invalidate()


def _dishonest(hub_type):
    """A hub that answers pre-restart resumes with fabricated delta
    frames instead of the full-paint resync fallback."""

    class DishonestHub(hub_type):
        def _resume_events(self, sub, last_gen):
            if last_gen is None:
                return []
            with self._lock:
                current = self._last_generation
            return [
                {
                    "kind": "delta",
                    "id": f"g{current}",
                    "data": {"page": page, "generation": current, "ops": []},
                }
                for page in sorted(sub.pages)
            ]

    def sabotage(ctx):
        ctx.faults["hub_factory"] = DishonestHub

    return sabotage


def _unbounded_outbox(ctx):
    """No outbox bound: stalled consumers are never evicted."""
    ctx.hub().outbox_limit = 10**9


def _wall_clocked_probe(ctx):
    """A staleness probe on the wall clock: the injected NTP step fakes
    'stale' and degrades healthy paints."""
    start = ctx.wall()
    ctx.policy.degraded_probe = lambda: ctx.wall() - start > 600.0


def _generation_laundering(ctx):
    """The replica rewrites each incoming record's generation to its
    snapshot's + 1, so the zombie leader's writes always apply."""
    replica = ctx.replica
    original = replica.apply_record

    def apply_record(record):
        laundered = dict(record)
        laundered["generation"] = replica.snapshot_generation() + 1
        return original(laundered)

    replica.apply_record = apply_record


def _probe_disabled(ctx):
    """The replica claims freshness during the outage."""
    ctx.policy.degraded_probe = lambda: False


#: (drill, the port's double, JAX's double, the check it must trip, the
#: checks that trip with it). A page that never comes also takes away the
#: shed and the restore that follow it; every other double breaks one
#: promise alone.
CASES = [
    ("preemption_wave", _shedding_disabled(Decision), _shedding_disabled(JaxDecision),
     "debug_sheds_first", ()),
    ("prom_flapping", _paging_swallowed, _paging_swallowed, "pages_within",
     ("debug_sheds_first", "recovery_unpages")),
    ("hub_restart_herd", _dishonest(BroadcastHub), _dishonest(JaxHub), "hub_honest", ()),
    ("slow_loris_sse", _unbounded_outbox, _unbounded_outbox, "slow_consumers_evicted", ()),
    ("clock_skew_scrape", _wall_clocked_probe, _wall_clocked_probe, "no_stale_paints", ()),
    ("leader_kill_mid_churn", _generation_laundering, _generation_laundering, "failover", ()),
    ("leader_kill_mid_churn", _probe_disabled, _probe_disabled, "stale_paints_during_outage",
     ()),
]


@pytest.fixture(scope="module")
def warmed():
    """One clean drill in each package first: JAX's first paints compile,
    and a slow first paint would page a drill on its own."""
    jax_fleet_cache.invalidate()
    JaxRunner(jax_scenario("preemption_wave")).run()
    ScenarioRunner(get_scenario("preemption_wave"), device="cpu").run()


@pytest.mark.parametrize(
    "name,port_double,jax_double,expected,with_it",
    CASES,
    ids=[f"{n}-{c}" for n, _, _, c, _ in CASES],
)
def test_the_assertion_fires_against_its_broken_double(
    warmed, name, port_double, jax_double, expected, with_it
):
    report = ScenarioRunner(get_scenario(name), device="cpu", sabotage=port_double).run()
    assert not report.passed
    tripped = {failure.check for failure in report.failures}
    assert tripped == {expected, *with_it}, f"{name}: tripped {sorted(tripped)}"
    jax_fleet_cache.invalidate()
    jax = JaxRunner(jax_scenario(name), sabotage=jax_double).run()
    assert tripped == {failure.check for failure in jax.failures}
    assert [str(f) for f in report.failures] == [str(f) for f in jax.failures]
    end = report.first_event("scenario", "drill_end")
    assert end is not None and end["detail"]["outcome"] == "failed"
    assert report.counters == jax.counters

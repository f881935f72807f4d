"""The incident library: six named drills.

The port's copy of ``headlamp_tpu/scenarios/catalog.py``. Each spec
scripts a fault the stack has a designed response to, and its checks
assert that response end to end. Durations are scripted seconds (SLOT_S
= 60 s windows; ticks 30 s unless a spec says otherwise), so the whole
matrix runs in about a second of real time.

Timing of the burn drills: a page needs both fast windows (5 m, 1 h)
above 14.4×, and clears when the 5 m window drains, about 300 s of
scripted time after the last bad observation; so recover phases run at
least 360 s and the recovery budget is 8 windows.
"""

from __future__ import annotations

from . import assertions as a
from . import inject as inj
from .dsl import Phase, ScenarioSpec


def _preemption_wave() -> ScenarioSpec:
    return ScenarioSpec(
        name="preemption_wave",
        description=(
            "A wave of TPU node preemptions churns the fleet while "
            "dashboard renders slow past the SLO threshold; the stack "
            "must page fast, shed debug, degrade interactive, and stand "
            "down after the fleet restores."
        ),
        phases=(
            Phase(
                "inject",
                90.0,
                tick=(
                    inj.preemption_wave(per_tick=2),
                    inj.slow_paints("/tpu", 1.2, 20),
                ),
            ),
            Phase("hold", 120.0, tick=(inj.slow_paints("/tpu", 1.2, 20),)),
            Phase(
                "recover",
                390.0,
                enter=(inj.restore_fleet(),),
                tick=(inj.good_paints("/tpu", 30),),
            ),
        ),
        checks=(
            a.assert_pages_within(4.0),
            a.assert_debug_sheds_first(),
            a.assert_zero_5xx(),
            a.assert_recovery_unpages(8.0),
        ),
    )


def _prom_flapping() -> ScenarioSpec:
    return ScenarioSpec(
        name="prom_flapping",
        description=(
            "The Prometheus proxy flaps — alternating ticks of 503s and "
            "slow scrapes — and scrape_paint burns; ops surfaces stay "
            "untouchable throughout and the page clears once the scrape "
            "path heals."
        ),
        phases=(
            Phase("inject", 60.0, tick=(inj.prometheus_flap(bad_per_tick=12),)),
            Phase("hold", 120.0, tick=(inj.prometheus_flap(bad_per_tick=12),)),
            Phase(
                "recover",
                390.0,
                enter=(inj.transport_errors(False, match=("prometheus",)),),
                tick=(inj.good_paints("/tpu/metrics", 20, latency_s=0.3),),
            ),
        ),
        checks=(
            a.assert_pages_within(4.0),
            a.assert_debug_sheds_first(),
            a.assert_zero_5xx(),
            a.assert_recovery_unpages(8.0),
        ),
    )


def _hub_restart_herd() -> ScenarioSpec:
    return ScenarioSpec(
        name="hub_restart_herd",
        description=(
            "The push hub restarts (worker bounce) and six SSE clients "
            "stampede back with pre-restart Last-Event-IDs; every resume "
            "must be answered with an honest full-paint fallback, never "
            "fabricated deltas."
        ),
        tick_s=15.0,
        phases=(
            Phase("inject", 30.0, tick=(inj.publish_frames(8),)),
            Phase(
                "hold",
                30.0,
                enter=(inj.hub_restart(clients=6),),
                tick=(inj.publish_frames(4),),
            ),
            Phase("recover", 30.0, tick=(inj.publish_frames(4),)),
        ),
        checks=(
            a.assert_hub_honest(min_clients=6),
            a.assert_zero_5xx(),
            a.assert_never_pages(),
        ),
    )


def _slow_loris_sse() -> ScenarioSpec:
    return ScenarioSpec(
        name="slow_loris_sse",
        description=(
            "Two SSE consumers stop reading while fleet churn keeps "
            "publishing; their bounded outboxes must fill and the hub "
            "must evict each with exactly one honest bye frame."
        ),
        tick_s=15.0,
        phases=(
            Phase(
                "inject",
                15.0,
                enter=(inj.slow_loris(subscribers=2),),
                tick=(inj.publish_frames(24),),
            ),
            Phase("hold", 30.0, tick=(inj.publish_frames(24),)),
            Phase("recover", 15.0, tick=(inj.publish_frames(4),)),
        ),
        checks=(
            a.assert_slow_consumers_evicted(2),
            a.assert_zero_5xx(),
            a.assert_never_pages(),
        ),
    )


def _clock_skew_scrape() -> ScenarioSpec:
    return ScenarioSpec(
        name="clock_skew_scrape",
        description=(
            "The wall clock steps one hour forward mid-scrape (NTP "
            "correction) while healthy traffic continues; every TTL, "
            "burn window, and staleness probe rides the monotonic clock "
            "(ADR-013), so nothing may page, degrade, or 5xx."
        ),
        phases=(
            Phase("inject", 60.0, enter=(inj.clock_skew(3600.0),)),
            Phase("hold", 120.0),
            Phase("recover", 60.0),
        ),
        checks=(
            a.assert_never_pages(("scrape_paint", "dashboard_render")),
            a.assert_no_stale_paints(),
            a.assert_zero_5xx(),
        ),
    )


def _leader_kill_mid_churn() -> ScenarioSpec:
    return ScenarioSpec(
        name="leader_kill_mid_churn",
        description=(
            "The read-tier leader dies mid preemption churn; the replica "
            "must degrade its paints honestly while the feed is silent, "
            "the standby must take over with a higher fencing term, and "
            "the zombie leader's generation-band writes must be rejected."
        ),
        read_tier=True,
        phases=(
            Phase(
                "inject",
                90.0,
                tick=(inj.preemption_wave(per_tick=1), inj.leader_publish()),
            ),
            Phase("hold", 120.0, enter=(inj.kill_leader(),)),
            Phase(
                "recover",
                120.0,
                tick=(
                    inj.standby_takeover(),
                    inj.leader_publish(),
                    inj.stale_publish(1),
                ),
            ),
        ),
        checks=(
            a.assert_failover(min_rejected=3),
            a.assert_stale_paints_during_outage(),
            a.assert_zero_5xx(),
        ),
    )


_BUILDERS = {
    "preemption_wave": _preemption_wave,
    "prom_flapping": _prom_flapping,
    "hub_restart_herd": _hub_restart_herd,
    "slow_loris_sse": _slow_loris_sse,
    "clock_skew_scrape": _clock_skew_scrape,
    "leader_kill_mid_churn": _leader_kill_mid_churn,
}

#: Stable drill order (bench rounds and the test matrix iterate this).
SCENARIO_NAMES: tuple[str, ...] = tuple(_BUILDERS)


def get_scenario(name: str) -> ScenarioSpec:
    """Build a fresh spec by name (fresh = no shared closure state
    between runs; injectors keep per-run state on the context)."""
    try:
        return _BUILDERS[name]()
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {', '.join(SCENARIO_NAMES)}"
        ) from None


def all_scenarios() -> list[ScenarioSpec]:
    return [get_scenario(name) for name in SCENARIO_NAMES]


__all__ = ["SCENARIO_NAMES", "all_scenarios", "get_scenario"]

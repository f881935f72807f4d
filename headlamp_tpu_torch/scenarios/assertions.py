"""Response assertions: what the observability stack must do.

The port's copy of ``headlamp_tpu/scenarios/assertions.py``. Each
factory returns a check over a completed
:class:`~.runner.ScenarioReport`; a broken promise raises
:class:`~.dsl.ScenarioAssertionError` with the scenario and check names.
Checks hold the stack's response to the fault (paging within budget,
shedding the right class first, honest resume, zero 5xx, standing down
after recovery), not its internals, so they keep passing across
refactors and keep firing against the broken-policy doubles of
``tests/test_torch_scenarios_fires.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

from .dsl import ScenarioAssertionError

Check = Callable[[Any], None]


def _fail(report: Any, check: str, message: str) -> None:
    raise ScenarioAssertionError(report.name, check, message)


def assert_pages_within(max_windows: float) -> Check:
    """The burn must PAGE within ``max_windows`` SLOT_S windows of the
    first injection — detection latency is the first SLO of an
    observability stack."""

    def check(report: Any) -> None:
        windows = report.metrics.get("windows_to_page")
        if windows is None:
            _fail(
                report,
                "pages_within",
                f"no paging transition observed within the drill "
                f"(expected within {max_windows} windows of first injection)",
            )
        if windows > max_windows:
            _fail(
                report,
                "pages_within",
                f"paged after {windows} windows, budget {max_windows}",
            )

    return check


def assert_debug_sheds_first() -> Check:
    """Under the page, DEBUG traffic sheds (fast 503s) while
    INTERACTIVE traffic is never shed — it degrades to stale paints
    instead (the gateway's priority judgement, end to end)."""

    def check(report: Any) -> None:
        counts = report.counters
        if not counts.get("debug_shed"):
            _fail(
                report,
                "debug_sheds_first",
                f"no debug request was shed "
                f"(debug_total={counts.get('debug_total', 0)})",
            )
        if not counts.get("interactive_degraded"):
            _fail(
                report,
                "debug_sheds_first",
                "no interactive render degraded to a stale paint while "
                "the SLO paged",
            )

    return check


def assert_zero_5xx() -> Check:
    """No request may 5xx end-to-end during the drill. Gateway shed
    503s are excluded by construction — shedding debug traffic is the
    intended response, not a failure."""

    def check(report: Any) -> None:
        if not report.metrics.get("zero_5xx", False):
            _fail(
                report,
                "zero_5xx",
                f"{report.counters.get('non_shed_5xx', 0)} non-shed 5xx "
                "responses served during the drill",
            )

    return check


def assert_recovery_unpages(max_windows: float = 6.0) -> Check:
    """After the recover phase starts, paging must clear (a gateway
    ``restore`` event) within ``max_windows`` windows, and every SLO
    must end the drill out of the page state — an alert that never
    stands down is as broken as one that never fires."""

    def check(report: Any) -> None:
        windows = report.metrics.get("recovery_windows")
        if windows is None:
            _fail(
                report,
                "recovery_unpages",
                "paging never cleared after the recover phase began",
            )
        if windows > max_windows:
            _fail(
                report,
                "recovery_unpages",
                f"paging cleared {windows} windows after recovery, "
                f"budget {max_windows}",
            )
        final = report.metrics.get("final_states", {})
        still = sorted(n for n, s in final.items() if s == "page")
        if still:
            _fail(
                report,
                "recovery_unpages",
                f"SLOs still paging at drill end: {still}",
            )

    return check


def assert_never_pages(slos: Iterable[str] = ()) -> Check:
    """The drill must NOT page — the fault is one the stack is supposed
    to absorb (a wall-clock step under injected clocks). With ``slos``,
    only those objectives are held to it; without, all of them."""

    names = tuple(slos)

    def check(report: Any) -> None:
        for mono, states in report.states_history:
            for name, state in states.items():
                if names and name not in names:
                    continue
                if state == "page":
                    _fail(
                        report,
                        "never_pages",
                        f"SLO {name!r} paged at mono={mono} — the stack "
                        "flinched at a fault it must absorb",
                    )

    return check


def assert_no_stale_paints() -> Check:
    """No interactive render may degrade during the drill — the
    wall-skew drill's core promise: staleness and TTL math ride the
    monotonic clock, so a wall step must not fake a stale feed."""

    def check(report: Any) -> None:
        degraded = report.counters.get("interactive_degraded", 0)
        if degraded:
            _fail(
                report,
                "no_stale_paints",
                f"{degraded} interactive renders degraded to stale "
                "paints with no real staleness present",
            )

    return check


def assert_hub_honest(min_clients: int = 1) -> Check:
    """Every post-restart resume must be answered honestly: the fresh
    hub retains no backlog, so each herd client gets full-paint
    fallbacks (reason ``resync``) — never replayed deltas the hub
    cannot actually vouch for."""

    def check(report: Any) -> None:
        herds = report.extra.get("herd_events")
        if not herds or len(herds) < min_clients:
            _fail(
                report,
                "hub_honest",
                f"expected ≥{min_clients} reconnecting clients, "
                f"saw {len(herds or [])}",
            )
        fallbacks = report.extra.get("resume_fallbacks", 0)
        if fallbacks < min_clients:
            _fail(
                report,
                "hub_honest",
                f"only {fallbacks} resume fallbacks for "
                f"{len(herds)} herd clients — the hub replayed history "
                "it does not retain",
            )
        for i, events in enumerate(herds):
            if not events:
                continue
            first = events[0]
            if first["kind"] != "paint" or first["data"].get("reason") != "resync":
                _fail(
                    report,
                    "hub_honest",
                    f"herd client {i}'s first frame was "
                    f"{first['kind']!r}/{first['data'].get('reason')!r}, "
                    "not an honest resync paint",
                )

    return check


def assert_slow_consumers_evicted(count: int) -> Check:
    """Each slow-loris subscriber must be evicted as a slow consumer
    with exactly one honest ``bye`` frame queued — bounded outboxes are
    what keep a stalled socket from buffering the process down."""

    def check(report: Any) -> None:
        loris = report.extra.get("loris", [])
        if len(loris) != count:
            _fail(
                report,
                "slow_consumers_evicted",
                f"expected {count} loris subscribers, saw {len(loris)}",
            )
        for i, sub in enumerate(loris):
            if sub["evicted_reason"] != "slow_consumer":
                _fail(
                    report,
                    "slow_consumers_evicted",
                    f"loris {i} evicted_reason={sub['evicted_reason']!r}, "
                    "expected 'slow_consumer' — the hub let a stalled "
                    "socket keep buffering",
                )
            if sub["outbox_kinds"] != ["bye"]:
                _fail(
                    report,
                    "slow_consumers_evicted",
                    f"loris {i} outbox is {sub['outbox_kinds']} — eviction "
                    "must leave exactly one honest bye frame",
                )

    return check


def assert_failover(min_rejected: int = 1) -> Check:
    """Leader kill must fail over honestly: fencing strictly advances
    across the ledger's transitions, the zombie leader's generation-band
    writes are rejected (``min_rejected`` at least), and the replica
    ends the drill FRESH — fed by the new term."""

    def check(report: Any) -> None:
        replica = report.extra.get("replica")
        if replica is None:
            _fail(report, "failover", "no replica in a read-tier drill")
        fencings = [f for f in replica["fencings"] if f]
        if len(set(fencings)) < 2:
            _fail(
                report,
                "failover",
                f"fencing never advanced (ledger fencings: {fencings}) — "
                "no new leadership term was established",
            )
        if replica["rejected_stale"] < min_rejected:
            _fail(
                report,
                "failover",
                f"only {replica['rejected_stale']} zombie records "
                f"rejected, expected ≥{min_rejected} — split-brain writes "
                "reached the replica",
            )
        if replica["stale"]:
            _fail(
                report,
                "failover",
                "replica still stale at drill end — the new term never "
                "fed it",
            )

    return check


def assert_stale_paints_during_outage() -> Check:
    """While no leader is publishing, the replica's interactive paints
    must go DEGRADED (honest staleness at the HTTP layer) — and a shed
    must never stand in for a degrade."""

    def check(report: Any) -> None:
        if not report.counters.get("interactive_degraded"):
            _fail(
                report,
                "stale_paints_during_outage",
                "no interactive render degraded while the bus feed was "
                "silent — the replica claimed freshness it did not have",
            )

    return check


__all__ = [
    "Check",
    "assert_debug_sheds_first",
    "assert_failover",
    "assert_hub_honest",
    "assert_never_pages",
    "assert_no_stale_paints",
    "assert_pages_within",
    "assert_recovery_unpages",
    "assert_slow_consumers_evicted",
    "assert_stale_paints_during_outage",
    "assert_zero_5xx",
]

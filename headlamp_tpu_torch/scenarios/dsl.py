"""Scenario DSL: declarative phased incident drills.

The port's copy of ``headlamp_tpu/scenarios/dsl.py``. A
:class:`ScenarioSpec` is a named, ordered tuple of :class:`Phase` objects:
**inject** (break something), **hold** (let the observability stack
react), **recover** (un-break it and watch it stand down). Each phase has
a scripted duration and two action lists: ``enter`` runs once at the
phase boundary, ``tick`` every ``tick_s`` of scripted time inside the
phase. Actions are plain callables over the runner's
:class:`~.runner.ScenarioContext`: the DSL owns *when*, the injectors
(``inject.py``) own *what*, the runner owns *driving*.

Everything runs on the injected monotonic clock (WCK001 scans this
package): a "5 minute" hold advances a fake clock 5 minutes in
microseconds of real time, which makes two runs of one scenario
byte-identical and the whole matrix cheap enough to gate on.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Tuple

#: An action over the runner's ScenarioContext. Actions flip faults,
#: drive traffic or feed the SLO engine; they never sleep and never read
#: the real clock.
Action = Callable[[Any], None]

#: The three phase kinds, in the order a drill runs them.
PHASE_KINDS = ("inject", "hold", "recover")


class ScenarioError(Exception):
    """A malformed spec (bad phase kind, non-positive duration)."""


class ScenarioAssertionError(AssertionError):
    """A response assertion tripped: the observability stack did not
    react to the drill as the scenario demands. Carries the scenario and
    check names, so a matrix failure reads as which drill and which
    promise."""

    def __init__(self, scenario: str, check: str, message: str) -> None:
        super().__init__(f"[{scenario}] {check}: {message}")
        self.scenario = scenario
        self.check = check


@dataclass(frozen=True)
class Phase:
    """One scripted phase of a drill."""

    kind: str
    duration_s: float
    enter: Tuple[Action, ...] = ()
    tick: Tuple[Action, ...] = ()

    def __post_init__(self) -> None:
        if self.kind not in PHASE_KINDS:
            raise ScenarioError(
                f"phase kind {self.kind!r} not one of {PHASE_KINDS}"
            )
        if self.duration_s <= 0:
            raise ScenarioError(
                f"phase {self.kind!r} duration must be > 0, got {self.duration_s}"
            )


@dataclass(frozen=True)
class ScenarioSpec:
    """One named drill: its phases and the response checks that gate it.

    ``checks`` are callables over the completed
    :class:`~.runner.ScenarioReport`; each raises
    :class:`ScenarioAssertionError` when its promise is broken.
    ``read_tier`` asks the runner for a leader and a replica instead of a
    single app: the leader-kill drill needs a successor to fail over to."""

    name: str
    description: str
    phases: Tuple[Phase, ...]
    tick_s: float = 30.0
    checks: Tuple[Callable[[Any], None], ...] = ()
    read_tier: bool = False
    extra: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.phases:
            raise ScenarioError(f"scenario {self.name!r} has no phases")
        if self.tick_s <= 0:
            raise ScenarioError(
                f"scenario {self.name!r} tick_s must be > 0, got {self.tick_s}"
            )
        order = [p.kind for p in self.phases]
        # An inject after a recover is a new scenario, not a phase.
        ranks = [PHASE_KINDS.index(k) for k in order]
        if ranks != sorted(ranks):
            raise ScenarioError(
                f"scenario {self.name!r} phases out of order: {order}"
            )

    def ticks_in(self, phase: Phase) -> int:
        """Whole ticks the runner executes inside ``phase``."""
        return max(int(phase.duration_s // self.tick_s), 1)


__all__ = [
    "Action",
    "PHASE_KINDS",
    "Phase",
    "ScenarioAssertionError",
    "ScenarioError",
    "ScenarioSpec",
]

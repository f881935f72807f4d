"""Incident scenario engine: deterministic drills on scripted clocks.

The port's copy of ``headlamp_tpu/scenarios``. A declarative DSL
(:mod:`.dsl`) scripts inject, hold and recover phases on injected
clocks; fault injectors (:mod:`.inject`) break real seams; a runner
(:mod:`.runner`) drives a real in-process app on the caller's device (or
a leader and a replica) through the drill, recording a JSONL transcript;
and response assertions (:mod:`.assertions`) gate what the observability
stack must do about each fault. The named drills live in :mod:`.catalog`;
the incident timeline they narrate is served at ``/debug/incidentz``
(:mod:`..obs.timeline`).
"""

from .catalog import SCENARIO_NAMES, all_scenarios, get_scenario
from .dsl import (
    Phase,
    ScenarioAssertionError,
    ScenarioError,
    ScenarioSpec,
)
from .runner import (
    ScenarioContext,
    ScenarioReport,
    ScenarioRunner,
    run_scenario,
)

__all__ = [
    "Phase",
    "SCENARIO_NAMES",
    "ScenarioAssertionError",
    "ScenarioContext",
    "ScenarioError",
    "ScenarioReport",
    "ScenarioRunner",
    "ScenarioSpec",
    "all_scenarios",
    "get_scenario",
    "run_scenario",
]

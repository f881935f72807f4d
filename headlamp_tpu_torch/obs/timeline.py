"""Incident timeline: one ordered view of a drill or a real incident.

The port's copy of ``headlamp_tpu/obs/timeline.py``. During an incident
the evidence is scattered: the scenario engine knows what it injected,
the SLO engine when states flipped, the shed policy what it answered
503, the push hub whom it evicted, and the generation ledger when
leadership moved. :class:`IncidentTimeline` merges the five into one
ordered event list, served at ``/debug/incidentz`` (JSON) and
``/debug/incidentz/html`` (waterfall).

Sources:

- **scenario marks**: ``inject()``, ``begin_drill()`` and the phase
  transitions, called by the scenario runner;
- **SLO state transitions**: ``sample_slo()`` diffs the engine's health
  block against the last sample and records each flip;
- **gateway rulings**: :meth:`IncidentTimeline.gateway_observer` plugs
  into ``ShedPolicy.observers``;
- **hub evictions**: :meth:`IncidentTimeline.eviction_observer` plugs
  into ``BroadcastHub.eviction_observers``;
- **elector transitions**: merged at read time from the attached
  :class:`~.ledger.GenerationLedger`'s transitions.

The timeline's own events order on a sequence number stamped under its
lock, on the injected clocks. Ledger transitions carry only a wall stamp
(they may come from another process), so the merge positions them by
the injected wall, the one axis the two share.

The eviction observer runs while the hub holds a subscription's
condition; ``mark()`` takes only the timeline's own lock and never calls
back into the hub, so no lock cycle exists.

Unlike JAX's, which reads a raising ledger as no transitions, the read
counts the failure in ``ledger_errors`` and names it in
``last_ledger_error`` (attributes, not snapshot keys: the
``/debug/incidentz`` JSON stays JAX's) and still paints the timeline's
own events.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Mapping

from .metrics import registry

#: Events kept, a bounded ring: a drill records tens of events, so 256
#: holds several drills.
TIMELINE_CAPACITY = 256

_INJECTIONS = registry.counter(
    "headlamp_tpu_torch_scenario_injections_total",
    "Fault injections performed by the incident scenario engine, by "
    "scenario and fault kind.",
    labels=("scenario", "fault"),
)
_EVENTS = registry.counter(
    "headlamp_tpu_torch_scenario_timeline_events_total",
    "Events recorded onto the incident timeline, by source "
    "(scenario/slo/gateway/push).",
    labels=("source",),
)
_RUNS = registry.counter(
    "headlamp_tpu_torch_scenario_runs_total",
    "Incident drills completed, by scenario and outcome (passed/failed).",
    labels=("scenario", "outcome"),
)


class IncidentTimeline:
    """Per-app merged incident event log. Thread-safe: observers fire
    from request threads, the sync loop and the scenario runner."""

    def __init__(
        self,
        *,
        monotonic: Callable[[], float] | None = None,
        wall: Callable[[], float] = time.time,
        capacity: int = TIMELINE_CAPACITY,
    ) -> None:
        self._mono = monotonic or time.monotonic
        self._wall = wall
        self._lock = threading.Lock()
        self._events: deque[dict[str, Any]] = deque(maxlen=capacity)
        self._seq = 0
        self._last_slo: dict[str, str] = {}
        #: The active drill, or None outside one: ``/healthz``
        #: ``runtime.scenarios`` is present only while it is set.
        self.active: dict[str, Any] | None = None
        #: Optional GenerationLedger whose leadership transitions are
        #: merged into every read. The host attaches its own.
        self.ledger: Any = None
        self.events_total = 0
        self.drills_total = 0
        #: Ledger reads that raised, and the last one's error.
        self.ledger_errors = 0
        self.last_ledger_error: str | None = None

    # -- recording --------------------------------------------------------

    def mark(
        self,
        source: str,
        kind: str,
        detail: Mapping[str, Any] | None = None,
    ) -> dict[str, Any]:
        """Append one event. ``source`` is the merge lane (scenario, slo,
        gateway, push); ``kind`` the event's name within it."""
        with self._lock:
            self._seq += 1
            event: dict[str, Any] = {
                "seq": self._seq,
                "mono": round(self._mono(), 6),
                "wall": round(self._wall(), 6),
                "source": source,
                "kind": kind,
                "detail": dict(detail or {}),
            }
            if self.active is not None:
                event["scenario"] = self.active["scenario"]
                event["phase"] = self.active.get("phase")
            self._events.append(event)
            self.events_total += 1
        _EVENTS.inc(source=source)
        return event

    def inject(
        self,
        scenario: str,
        fault: str,
        detail: Mapping[str, Any] | None = None,
    ) -> dict[str, Any]:
        """One fault injection: the counter, plus the event every
        assertion anchors its "after the injection" window on."""
        _INJECTIONS.inc(scenario=scenario, fault=fault)
        with self._lock:
            if self.active is not None:
                self.active["injections"] += 1
        merged = dict(detail or {})
        merged["fault"] = fault
        return self.mark("scenario", "inject", merged)

    def begin_drill(self, scenario: str) -> None:
        with self._lock:
            self.active = {"scenario": scenario, "phase": None, "injections": 0}
            self.drills_total += 1
        self.mark("scenario", "drill_start", {"name": scenario})

    def set_phase(self, phase: str) -> None:
        with self._lock:
            if self.active is not None:
                self.active["phase"] = phase
        self.mark("scenario", "phase", {"phase": phase})

    def end_drill(self, outcome: str) -> None:
        active = self.active
        scenario = active["scenario"] if active else "unknown"
        self.mark("scenario", "drill_end", {"outcome": outcome})
        _RUNS.inc(scenario=scenario, outcome=outcome)
        with self._lock:
            self.active = None

    def sample_slo(self, states: Mapping[str, str]) -> int:
        """Diff the engine's health block against the last sample and
        record each state flip; returns how many flipped."""
        with self._lock:
            previous, self._last_slo = self._last_slo, dict(states)
        flips = 0
        for name, state in states.items():
            if previous.get(name, "ok") != state:
                self.mark(
                    "slo",
                    "transition",
                    {"slo": name, "from": previous.get(name, "ok"), "to": state},
                )
                flips += 1
        return flips

    # -- observer adapters ------------------------------------------------

    def gateway_observer(self, kind: str, detail: Mapping[str, Any]) -> None:
        """Plugs into ``ShedPolicy.observers``."""
        self.mark("gateway", kind, detail)

    def eviction_observer(self, reason: str, detail: Mapping[str, Any]) -> None:
        """Plugs into ``BroadcastHub.eviction_observers``. Runs under the
        evicted subscription's condition; ``mark()`` takes only the
        timeline's lock, so this is cycle-free and cheap."""
        merged = dict(detail)
        merged["reason"] = reason
        self.mark("push", "eviction", merged)

    # -- reading ----------------------------------------------------------

    def health_block(self) -> dict[str, Any] | None:
        """The ``/healthz`` ``runtime.scenarios`` block, present only
        while a drill is active."""
        with self._lock:
            if self.active is None:
                return None
            return {
                "active": self.active["scenario"],
                "phase": self.active.get("phase"),
                "injections": self.active["injections"],
                "events": self.events_total,
            }

    def _ledger_transitions(self) -> list[dict[str, Any]]:
        ledger = self.ledger
        if ledger is None:
            return []
        try:
            return list(ledger.snapshot().get("transitions", []))
        except Exception as exc:  # noqa: BLE001 — a broken ledger must not fail triage
            with self._lock:
                self.ledger_errors += 1
                self.last_ledger_error = f"{type(exc).__name__}: {exc}"
            return []

    def events(self) -> list[dict[str, Any]]:
        """Own events in sequence order, the ledger's transitions placed
        among them by injected wall (see the module docstring)."""
        with self._lock:
            merged = [dict(e) for e in self._events]
        walls = [e["wall"] for e in merged]
        for t in self._ledger_transitions():
            event = {
                "seq": None,
                "mono": None,
                "wall": t.get("wall"),
                "source": "elector",
                "kind": t.get("kind", "transition"),
                "detail": {"fencing": t.get("fencing", 0)},
            }
            # Before the first own event stamped later: a binary search
            # over the (already ordered) walls.
            lo, hi = 0, len(walls)
            wall = event["wall"] or 0.0
            while lo < hi:
                mid = (lo + hi) // 2
                if walls[mid] < wall:
                    lo = mid + 1
                else:
                    hi = mid
            merged.insert(lo, event)
            walls.insert(lo, wall)
        return merged

    def snapshot(self) -> dict[str, Any]:
        """The ``/debug/incidentz`` body."""
        return {
            "capacity": self._events.maxlen,
            "events_total": self.events_total,
            "drills_total": self.drills_total,
            "active": self.health_block(),
            "events": self.events(),
        }


__all__ = ["IncidentTimeline", "TIMELINE_CAPACITY"]

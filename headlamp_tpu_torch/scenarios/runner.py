"""Scenario runner: drive a real app through a drill.

The port's copy of ``headlamp_tpu/scenarios/runner.py``. The runner
builds the objects the host serves with (a
:class:`~..server.app.DashboardApp` over the demo fixture transport on
``device``, plus, for ``read_tier`` specs, a leader and a
:class:`~..replicate.replica.ReplicaApp` with real electors over a shared
lease), a fresh SLO engine, a :class:`~..gateway.shed.ShedPolicy` and the
app's live push hub. It walks the spec's phases on scripted clocks,
firing each phase's actions and a fixed per-tick traffic script through
the admission path (``policy.decide`` → ``degraded_scope`` →
``app.handle``; a shed ruling answers the gateway's 503 without a
render, as the gateway would).

Admission is driven directly, not through
:class:`~..gateway.gateway.RenderGateway`, because the gateway's render
pool is real threads and their scheduling order would leak into the
transcript. The ruling, the degraded scope and the handler are the
production code; only the thread hop is left out.

Both clocks are scripted, and the drill's whole request and ruling
sequence is recorded through a :class:`~..history.record.Recorder` on
them, so two runs of one scenario give byte-identical transcripts, on
the card as on the CPU.

The app's metric observers feed whatever ``slo_mod.engine()`` returns, so
the runner installs its scripted-clock engine with ``set_engine`` for the
drill and restores the previous one in a ``finally``. Unlike JAX's, the
runner also closes every app it built there, so their refreshers' refit
threads are joined and nothing it started outlives the run.

``sabotage`` is the counterexample seam: a test passes a callable that
breaks one policy after setup (shedding off, a hub that fabricates resume
history, a wall-clocked staleness probe) to show that each assertion
fires against the misbehaviour it guards.
"""

from __future__ import annotations

import io
from typing import Any, Callable, Mapping

from ..device import DeviceLike, resolve_device
from ..gateway.gateway import RenderGateway
from ..gateway.pool import PRIORITY_DEBUG, PRIORITY_INTERACTIVE
from ..gateway.shed import ShedPolicy, degraded_scope
from ..history.record import Recorder
from ..obs import slo as slo_mod
from ..obs.slo import SLOT_S, SLOEngine
from ..obs.timeline import IncidentTimeline
from .dsl import ScenarioAssertionError, ScenarioSpec
from .inject import FaultTransport

#: The fixed per-tick request script: two interactive paints, the
#: metrics page, one debug surface and one ops surface, so every priority
#: class is exercised every tick.
DEFAULT_TRAFFIC: tuple[str, ...] = (
    "/tpu",
    "/tpu/metrics",
    "/tpu",
    "/debug/traces",
    "/metricsz",
)

#: The read tier's script leaves out /tpu/metrics: a replica serves the
#: fleet pages from applied records; the Prometheus chain is the leader's.
READ_TIER_TRAFFIC: tuple[str, ...] = (
    "/tpu",
    "/tpu",
    "/debug/traces",
    "/metricsz",
)


class ScriptedClock:
    """A callable fake clock; actions advance it, nothing sleeps."""

    def __init__(self, start: float) -> None:
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        self.now += float(dt)
        return self.now


class ScenarioReport:
    """Everything a response assertion reads off one run."""

    def __init__(self, name: str) -> None:
        self.name = name
        #: JSONL transcript of the whole request and ruling sequence.
        self.transcript = ""
        #: The incident timeline's events (the /debug/incidentz view).
        self.events: list[dict[str, Any]] = []
        #: (mono, states) per tick: the SLO trajectory.
        self.states_history: list[tuple[float, dict[str, str]]] = []
        self.counters: dict[str, int] = {}
        self.metrics: dict[str, Any] = {}
        self.extra: dict[str, Any] = {}
        #: The spec's checks that failed (empty means passed).
        self.failures: list[ScenarioAssertionError] = []

    @property
    def passed(self) -> bool:
        return not self.failures

    def first_event(
        self, source: str, kind: str, *, after: float | None = None
    ) -> dict[str, Any] | None:
        """The earliest timeline event matching (source, kind), with
        ``after`` at or after that monotonic stamp. Ledger-merged events
        carry ``mono=None`` and never match an ``after`` filter."""
        for event in self.events:
            if event.get("source") != source or event.get("kind") != kind:
                continue
            if after is not None:
                mono = event.get("mono")
                if mono is None or mono < after:
                    continue
            return event
        return None


class ScenarioContext:
    """Mutable drill state handed to every phase action: the real
    objects (apps, engine, policy, the hub accessor), the scripted clocks
    and a ``faults`` scratchpad the injectors coordinate through.
    ``device`` is where the apps fit and roll up: CUDA unless the caller
    asks for ``"cpu"``."""

    def __init__(
        self,
        spec: ScenarioSpec,
        *,
        device: DeviceLike = None,
        start_mono: float = 1_000.0,
        start_wall: float = 1_700_000_000.0,
    ) -> None:
        from ..server import DashboardApp, make_demo_transport

        self.spec = spec
        self.device = resolve_device(device)
        self.mono = ScriptedClock(start_mono)
        self.wall = ScriptedClock(start_wall)
        self.faults: dict[str, Any] = {}
        self.transport = FaultTransport(
            make_demo_transport(), advance=self.mono.advance
        )
        self.app = DashboardApp(
            self.transport, device=self.device, clock=self.wall, monotonic=self.mono
        )
        #: Every app this context built, closed by :meth:`close`.
        self.apps: list[Any] = [self.app]
        self.push = self.app.push
        self.engine = SLOEngine(monotonic=self.mono)
        self.policy = ShedPolicy(monotonic=self.mono)
        self.timeline: IncidentTimeline = self.app.incidents
        self.policy.observers.append(self.timeline.gateway_observer)
        # The app registered this observer already; JAX's runner registers
        # it a second time, so each eviction is marked twice, and so is
        # it here: the timeline's events stay equal to JAX's.
        self.push.hub.eviction_observers.append(self.timeline.eviction_observer)
        self.recorder = Recorder(
            io.StringIO(),
            monotonic=self.mono,
            wall=self.wall,
            note=f"scenario:{spec.name}",
        )
        # Per-priority accounting the assertions read.
        self.counts = {
            "interactive_total": 0,
            "interactive_degraded": 0,
            "debug_total": 0,
            "debug_shed": 0,
            "ops_total": 0,
            "shed_503": 0,
            "non_shed_5xx": 0,
        }
        self.replica: Any = None
        self.leader_elector: Any = None
        self.standby_elector: Any = None
        if spec.read_tier:
            try:
                self._build_read_tier()
            except BaseException:
                self.close()
                raise

    def _build_read_tier(self) -> None:
        from ..replicate.leader import LeaderElector, LeaseStore
        from ..replicate.replica import ReplicaApp

        self.replica = ReplicaApp(
            device=self.device, clock=self.wall, monotonic=self.mono, stale_after_s=60.0
        )
        self.apps.append(self.replica)
        # The replica's timeline and ledger are the drill's: transitions
        # of both electors land in the ledger the /debug/incidentz merge
        # reads.
        self.timeline = self.replica.incidents
        self.policy.observers = [self.timeline.gateway_observer]
        self.policy.degraded_probe = self.replica.stale
        store = LeaseStore(monotonic=self.mono)
        self.leader_elector = LeaderElector(
            store, "leader-0", ttl_s=600.0,
            monotonic=self.mono, ledger=self.replica.ledger,
        )
        self.standby_elector = LeaderElector(
            store, "replica-0", ttl_s=600.0,
            monotonic=self.mono, ledger=self.replica.ledger,
        )
        self.leader_elector.tick()
        # Prime the leader's snapshot (one real sync) and the replica's
        # feed (one accepted record), so the drill starts healthy.
        self.app.handle("/tpu")
        self.publish_generation()

    # -- accessors actions use -------------------------------------------

    def hub(self) -> Any:
        """The app's live hub, read per call: the hub-restart injector
        replaces it mid-drill."""
        return self.push.hub

    def inject(self, fault: str, detail: Mapping[str, Any] | None = None) -> None:
        self.timeline.inject(self.spec.name, fault, detail)

    def install_engine(self, engine: Any) -> None:
        """Swap the drill's engine (a counterexample installs a
        wall-clocked one); the process accessor follows, so the app's
        observers and the policy do too."""
        self.engine = engine
        slo_mod.set_engine(engine)
        self.policy.invalidate()

    def publish_generation(self, *, fencing: int | None = None) -> bool:
        """Build one generation record off the leader app's snapshot and
        offer it to the replica, fenced into ``fencing``'s generation band
        (by default the live lease holder's)."""
        from ..replicate.bus import build_record
        from ..replicate.leader import generation_floor

        if fencing is None:
            for elector in (self.standby_elector, self.leader_elector):
                if elector is not None and elector.is_leader:
                    fencing = elector.fencing
                    break
        fencing = int(fencing or 1)
        seqs: dict[int, int] = self.faults.setdefault("pub_seq", {})
        seqs[fencing] = seqs.get(fencing, 0) + 1
        generation = generation_floor(fencing) + seqs[fencing]
        record = build_record(
            self.app._last_snapshot, generation=generation, fencing=fencing
        )
        return bool(self.replica.apply_record(record))

    # -- driving ----------------------------------------------------------

    def advance(self, dt: float) -> None:
        self.mono.advance(dt)
        self.wall.advance(dt)

    def request(self, path: str) -> int:
        """One request through the production admission path; the ruling
        and the status land in the transcript."""
        target = self.replica if self.spec.read_tier else self.app
        route = target._route_label(path)
        priority = RenderGateway.classify(route)
        decision = self.policy.decide(route, priority)
        if priority == PRIORITY_INTERACTIVE:
            self.counts["interactive_total"] += 1
        elif priority == PRIORITY_DEBUG:
            self.counts["debug_total"] += 1
        else:
            self.counts["ops_total"] += 1
        if decision.shed:
            # The gateway's shed answer, without paying the render.
            self.counts["debug_shed"] += 1
            self.counts["shed_503"] += 1
            self.recorder.record_ok(
                path, {"status": 503, "shed": True, "degraded": False}
            )
            return 503
        with degraded_scope(decision.degraded):
            status, _ctype, _body = target.handle(path)
        if decision.degraded:
            self.counts["interactive_degraded"] += 1
        if status >= 500:
            self.counts["non_shed_5xx"] += 1
        self.recorder.record_ok(
            path,
            {"status": status, "shed": False, "degraded": decision.degraded},
        )
        return status

    def traffic(self) -> None:
        script = self.spec.extra.get(
            "traffic",
            READ_TIER_TRAFFIC if self.spec.read_tier else DEFAULT_TRAFFIC,
        )
        for path in script:
            self.request(path)

    def sample(self) -> dict[str, str]:
        """One observability sample: refresh the policy's view of the
        engine (firing its paging and restore observers) and diff the SLO
        states onto the timeline."""
        states = dict(self.policy.states())
        self.timeline.sample_slo(states)
        return states

    def close(self) -> None:
        """Close every app this context built, the replica first: each
        joins its refits and closes its live hub. An app whose close
        raises an error leaves none of the others open; the first error
        propagates. An interrupt propagates at once."""
        error: Exception | None = None
        for app in reversed(self.apps):
            try:
                app.close()
            except Exception as exc:  # noqa: BLE001 — re-raised below
                error = error or exc
        if error is not None:
            raise error


class ScenarioRunner:
    """Runs one spec: phases, ticks, report, checks. ``device`` goes to
    the apps: CUDA unless the caller asks for ``"cpu"``; without CUDA the
    constructor raises."""

    def __init__(
        self,
        spec: ScenarioSpec,
        *,
        device: DeviceLike = None,
        sabotage: Callable[[ScenarioContext], None] | None = None,
        start_mono: float = 1_000.0,
        start_wall: float = 1_700_000_000.0,
    ) -> None:
        self.spec = spec
        self.device = resolve_device(device)
        self.sabotage = sabotage
        self.start_mono = start_mono
        self.start_wall = start_wall

    def run(self) -> ScenarioReport:
        spec = self.spec
        previous_engine = slo_mod.engine()
        report = ScenarioReport(spec.name)
        ctx: ScenarioContext | None = None
        try:
            ctx = ScenarioContext(
                spec, device=self.device,
                start_mono=self.start_mono, start_wall=self.start_wall,
            )
            slo_mod.set_engine(ctx.engine)
            ctx.policy.invalidate()
            if self.sabotage is not None:
                self.sabotage(ctx)
            ctx.timeline.begin_drill(spec.name)
            for phase in spec.phases:
                ctx.timeline.set_phase(phase.kind)
                for action in phase.enter:
                    action(ctx)
                for _ in range(spec.ticks_in(phase)):
                    for action in phase.tick:
                        action(ctx)
                    ctx.traffic()
                    ctx.advance(spec.tick_s)
                    report.states_history.append((ctx.mono(), ctx.sample()))
            self._finalize(ctx, report)
            for check in spec.checks:
                try:
                    check(report)
                except ScenarioAssertionError as failure:
                    report.failures.append(failure)
            ctx.timeline.end_drill("passed" if report.passed else "failed")
            report.events = ctx.timeline.events()
        finally:
            try:
                if ctx is not None:
                    ctx.close()
            finally:
                slo_mod.set_engine(previous_engine)
        return report

    def _finalize(self, ctx: ScenarioContext, report: ScenarioReport) -> None:
        report.transcript = ctx.recorder._sink.getvalue()
        report.counters = dict(ctx.counts)
        report.events = ctx.timeline.events()
        self._drain_subscribers(ctx, report)
        if ctx.replica is not None:
            report.extra["replica"] = {
                "rejected_stale": ctx.replica.rejected_stale,
                "stale": bool(ctx.replica.stale()),
                "fencings": [
                    t.get("fencing", 0)
                    for t in ctx.replica.ledger.snapshot().get("transitions", [])
                ],
            }
        report.extra["hub"] = ctx.hub().snapshot()
        report.metrics.update(self._derive_metrics(ctx, report))

    def _drain_subscribers(self, ctx: ScenarioContext, report: ScenarioReport) -> None:
        herd = ctx.faults.get("herd") or []
        if herd:
            drained = []
            hub = ctx.hub()
            for sub in herd:
                kinds: list[dict[str, Any]] = []
                while True:
                    event = hub.poll(sub)
                    if event is None or event["kind"] == "heartbeat":
                        break
                    kinds.append(
                        {"kind": event["kind"], "data": event.get("data", {})}
                    )
                drained.append(kinds)
            report.extra["herd_events"] = drained
            report.extra["resume_fallbacks"] = ctx.hub().resume_fallbacks
        loris = ctx.faults.get("loris") or []
        if loris:
            report.extra["loris"] = [
                {
                    "evicted_reason": sub.evicted_reason,
                    "outbox_kinds": [e["kind"] for e in sub.outbox],
                }
                for sub in loris
            ]

    def _derive_metrics(
        self, ctx: ScenarioContext, report: ScenarioReport
    ) -> dict[str, Any]:
        counts = report.counters
        first_inject = report.first_event("scenario", "inject")
        first_page = report.first_event("gateway", "paging")
        metrics: dict[str, Any] = {
            "shed_rate_debug": (
                counts["debug_shed"] / counts["debug_total"]
                if counts["debug_total"]
                else 0.0
            ),
            "stale_paint_rate": (
                counts["interactive_degraded"] / counts["interactive_total"]
                if counts["interactive_total"]
                else 0.0
            ),
            "zero_5xx": counts["non_shed_5xx"] == 0,
            "windows_to_page": None,
            "recovery_windows": None,
        }
        if first_inject and first_page:
            metrics["windows_to_page"] = round(
                (first_page["mono"] - first_inject["mono"]) / SLOT_S, 2
            )
        recover = None
        for event in report.events:
            if (
                event.get("source") == "scenario"
                and event.get("kind") == "phase"
                and event.get("detail", {}).get("phase") == "recover"
            ):
                recover = event
                break
        if recover is not None and recover.get("mono") is not None:
            restore = report.first_event(
                "gateway", "restore", after=recover["mono"]
            )
            if restore is not None:
                metrics["recovery_windows"] = round(
                    (restore["mono"] - recover["mono"]) / SLOT_S, 2
                )
        if report.states_history:
            metrics["final_states"] = dict(report.states_history[-1][1])
        return metrics


def run_scenario(
    spec: ScenarioSpec,
    *,
    device: DeviceLike = None,
    sabotage: Callable[[ScenarioContext], None] | None = None,
) -> ScenarioReport:
    """Run one drill on ``device`` and raise its first failed check, with
    the scenario and check names in the message."""
    report = ScenarioRunner(spec, device=device, sabotage=sabotage).run()
    if report.failures:
        raise report.failures[0]
    return report


__all__ = [
    "DEFAULT_TRAFFIC",
    "READ_TIER_TRAFFIC",
    "ScenarioContext",
    "ScenarioReport",
    "ScenarioRunner",
    "ScriptedClock",
    "run_scenario",
]

"""Fault injectors: the *what* of a drill.

The port's copy of ``headlamp_tpu/scenarios/inject.py``. Each public
function is an action factory: it returns a closure over the runner's
:class:`~.runner.ScenarioContext` for a :class:`~.dsl.Phase`'s ``enter``
or ``tick`` list. Injectors break real seams, not simulations of them:

- :class:`FaultTransport` wraps the app's transport at the same
  ``request(path, timeout_s)`` interface the connection pool and
  :class:`~..history.record.RecordingTransport` decorate, so errors and
  latency hit every consumer above the seam (the sync, the metrics
  refresher, the Prometheus probe chain) with no special casing;
- a preemption wave pushes NotReady and DELETED events through the
  fixture fleet's :class:`~..transport.api_proxy.WatchFeed`, the
  list+watch protocol a real apiserver speaks;
- the hub restart and the slow loris act on the live
  :class:`~..push.hub.BroadcastHub`; the leader kill on the live elector.

Latency is scripted: an injected-latency transport advances the drill's
fake clock instead of sleeping, and SLO burn is fed through the engine's
own ``feed_latency`` seam (the reduction the instrument observers
perform) with scripted values, so the burn is deterministic while
everything downstream (states, paging, shedding, evictions) is the
production code.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Tuple

from ..obs import slo as slo_mod
from ..push.hub import BroadcastHub
from ..transport import ApiError

#: The message of every injected transport error: greppable in logs and
#: transcripts, and distinct from any real apiserver message.
INJECTED_ERROR = "injected fault (incident drill)"


class FaultTransport:
    """Transport decorator injecting errors and scripted latency.

    Delegates everything else (the fixture's ``node_feed`` and
    ``pod_feed`` too) to ``inner``; ``request`` reads the fault flags per
    call, so a phase action can flip them mid-drill. Latency "passes" by
    advancing the drill's clock through ``advance``, never a sleep."""

    def __init__(
        self,
        inner: Any,
        *,
        advance: Callable[[float], None] | None = None,
    ) -> None:
        self.inner = inner
        self._advance = advance
        #: Fail matching requests with a 503 ApiError while True.
        self.failing = False
        #: Substrings selecting the paths the faults apply to; empty
        #: means every path.
        self.match: Tuple[str, ...] = ()
        #: Scripted seconds each matching request "takes".
        self.latency_s = 0.0
        self.requests = 0
        self.injected_errors = 0
        self.injected_latency_s = 0.0

    def _matches(self, path: str) -> bool:
        return not self.match or any(s in path for s in self.match)

    def request(self, path: str, timeout_s: float = 2.0) -> Any:
        self.requests += 1
        if self._matches(path):
            if self.latency_s and self._advance is not None:
                self._advance(self.latency_s)
                self.injected_latency_s += self.latency_s
            if self.failing:
                self.injected_errors += 1
                raise ApiError(path, INJECTED_ERROR, 503)
        return self.inner.request(path, timeout_s)

    def __getattr__(self, name: str) -> Any:
        return getattr(self.inner, name)


# -- transport faults --------------------------------------------------


def transport_errors(on: bool = True, match: Tuple[str, ...] = ()) -> Any:
    """Turn transport 503s on or off (the recover phase passes
    ``on=False``)."""

    def action(ctx: Any) -> None:
        ctx.transport.failing = on
        ctx.transport.match = tuple(match)
        fault = "transport_error" if on else "transport_recover"
        ctx.inject(fault, {"match": list(match)})

    return action


def transport_latency(latency_s: float, match: Tuple[str, ...] = ()) -> Any:
    """Give matching transport requests a scripted duration."""

    def action(ctx: Any) -> None:
        ctx.transport.latency_s = float(latency_s)
        ctx.transport.match = tuple(match)
        ctx.inject("transport_latency", {"latency_s": latency_s})

    return action


# -- SLO burn feeds ----------------------------------------------------


def slow_paints(route: str, latency_s: float, count: int) -> Any:
    """Tick action: feed ``count`` breaching paint latencies for
    ``route`` into the engine, the deterministic stand-in for the
    observer reduction of that many slow renders."""

    def action(ctx: Any) -> None:
        for _ in range(count):
            ctx.engine.feed_latency(
                slo_mod.REQUEST_DURATION, float(latency_s), {"route": route}
            )

    return action


def good_paints(route: str, count: int, latency_s: float = 0.05) -> Any:
    """Tick action: feed healthy paint latencies (the recover phase's
    traffic turning the burn back down)."""

    def action(ctx: Any) -> None:
        for _ in range(count):
            ctx.engine.feed_latency(
                slo_mod.REQUEST_DURATION, float(latency_s), {"route": route}
            )

    return action


# -- Prometheus flapping -----------------------------------------------


def prometheus_flap(route: str = "/tpu/metrics", bad_per_tick: int = 8) -> Any:
    """Tick action: alternate the Prometheus proxy between broken and
    healthy each tick, the half-dead scrape target. Odd ticks fail the
    proxy paths and feed breaching scrape latencies; even ticks restore
    it and feed healthy ones, so the burn rides the flap."""

    def action(ctx: Any) -> None:
        ctx.faults["flap_tick"] = ctx.faults.get("flap_tick", 0) + 1
        flapped_down = ctx.faults["flap_tick"] % 2 == 1
        ctx.transport.failing = flapped_down
        ctx.transport.match = ("prometheus",)
        if flapped_down:
            ctx.inject("prom_flap_down", {"tick": ctx.faults["flap_tick"]})
            for _ in range(bad_per_tick):
                ctx.engine.feed_latency(
                    slo_mod.REQUEST_DURATION, 5.0, {"route": route}
                )
        else:
            for _ in range(bad_per_tick // 2):
                ctx.engine.feed_latency(
                    slo_mod.REQUEST_DURATION, 0.05, {"route": route}
                )

    return action


# -- preemption wave ---------------------------------------------------


def preemption_wave(per_tick: int = 2) -> Any:
    """Tick action: preempt ``per_tick`` more TPU nodes: mark them
    NotReady and DELETE their pods through the fixture's watch feeds, the
    deltas a real preemption pushes through list+watch."""

    def action(ctx: Any) -> None:
        node_feed = ctx.transport.node_feed
        pod_feed = ctx.transport.pod_feed
        preempted: set[str] = ctx.faults.setdefault("preempted", set())
        victims = []
        for item in node_feed._items.values():
            name = item["metadata"]["name"]
            labels = item["metadata"].get("labels", {})
            if "cloud.google.com/gke-tpu-accelerator" not in labels:
                continue
            if name in preempted:
                continue
            victims.append(item)
            if len(victims) >= per_tick:
                break
        for node in victims:
            name = node["metadata"]["name"]
            preempted.add(name)
            downed = copy.deepcopy(node)
            for cond in downed.get("status", {}).get("conditions", []):
                if cond.get("type") == "Ready":
                    cond["status"] = "False"
                    cond["reason"] = "NodePreempted"
            node_feed.push("MODIFIED", downed)
            for pod in list(pod_feed._items.values()):
                if pod.get("spec", {}).get("nodeName") == name:
                    pod_feed.push("DELETED", pod)
            ctx.inject("preemption", {"node": name})

    return action


def restore_fleet() -> Any:
    """Recover-phase enter action: bring every preempted node back Ready.
    Pods stay gone: recovery restores capacity, not workloads, as when a
    real preemption wave ends."""

    def action(ctx: Any) -> None:
        node_feed = ctx.transport.node_feed
        preempted: set[str] = ctx.faults.get("preempted", set())
        for item in list(node_feed._items.values()):
            name = item["metadata"]["name"]
            if name not in preempted:
                continue
            restored = copy.deepcopy(item)
            for cond in restored.get("status", {}).get("conditions", []):
                if cond.get("type") == "Ready":
                    cond["status"] = "True"
                    cond["reason"] = "KubeletReady"
            node_feed.push("MODIFIED", restored)
        preempted.clear()
        ctx.inject("fleet_restore", {})

    return action


# -- push hub faults ---------------------------------------------------


def hub_restart(clients: int = 6) -> Any:
    """Enter action: restart the broadcast hub (a worker bounce) and
    stampede ``clients`` resumers at it with pre-restart Last-Event-IDs.
    The fresh hub keeps no backlog, so the honest answer to each is the
    full-paint fallback, never a fabricated delta history.

    A closed hub stays closed in the port, so the pipeline gets a fresh
    one, which takes the shed probe from its constructor (the gateway's
    ``attach_push`` installed it on the old one) and the timeline's
    eviction observer. The app's ``close()`` closes the live hub."""

    def action(ctx: Any) -> None:
        old = ctx.hub()
        last_gen = old.snapshot()["last_generation"]
        old.close(reason="shutdown")
        # ``hub_factory`` is the counterexample seam: a test installs a
        # hub that fabricates resume history, which the honesty
        # assertion must catch.
        factory = ctx.faults.get("hub_factory", BroadcastHub)
        fresh = factory(
            monotonic=ctx.mono,
            shed_check=ctx.policy.paging,
        )
        fresh.eviction_observers.append(ctx.timeline.eviction_observer)
        ctx.push.hub = fresh
        ctx.inject("hub_restart", {"pre_restart_generation": last_gen})
        herd = []
        for _ in range(int(clients)):
            sub = fresh.subscribe(
                ["fleet"], last_event_id=f"g{max(last_gen, 1)}"
            )
            herd.append(sub)
        ctx.faults["herd"] = herd
        ctx.inject("reconnect_herd", {"clients": len(herd)})

    return action


def slow_loris(subscribers: int = 2) -> Any:
    """Enter action: attach ``subscribers`` SSE clients that never drain
    their outboxes, kept in ``ctx.faults['loris']``. Frame ticks fill
    their outboxes until the hub evicts each (reason ``slow_consumer``)
    with one honest ``bye``."""

    def action(ctx: Any) -> None:
        subs = [
            ctx.hub().subscribe(["fleet"], priority="interactive")
            for _ in range(int(subscribers))
        ]
        ctx.faults["loris"] = subs
        ctx.inject("slow_loris", {"subscribers": len(subs)})

    return action


def publish_frames(frames_per_tick: int = 24) -> Any:
    """Tick action: fan synthetic fleet frames through the hub, the
    steady churn that fills a non-draining outbox and keeps honest
    clients' resume cursors moving."""

    def action(ctx: Any) -> None:
        hub = ctx.hub()
        for _ in range(int(frames_per_tick)):
            ctx.faults["gen"] = ctx.faults.get("gen", 0) + 1
            gen = ctx.faults["gen"]
            hub.publish(gen, {"fleet": {"page": "fleet", "ops": [], "generation": gen}})

    return action


# -- clock skew --------------------------------------------------------


def clock_skew(step_s: float) -> Any:
    """Enter action: step the wall clock by ``step_s`` (negative is
    backwards) while the monotonic clock keeps marching, the NTP
    correction mid-scrape. Every TTL, burn window and staleness probe
    runs on the monotonic clock, so nothing downstream may flinch;
    display stamps honestly jump."""

    def action(ctx: Any) -> None:
        ctx.wall.advance(float(step_s))
        ctx.inject("clock_skew", {"step_s": step_s})

    return action


# -- leader kill (read tier) -------------------------------------------


def kill_leader() -> Any:
    """Enter action: the leader vanishes mid-churn: it resigns its lease
    (the crash-fast path; a lapsed TTL plays out the same protocol) and
    stops publishing. The replica's feed goes stale; the standby elector
    takes over on a later tick."""

    def action(ctx: Any) -> None:
        fencing = ctx.leader_elector.fencing
        ctx.faults["dead_fencing"] = fencing
        ctx.leader_elector.resign()
        ctx.inject("leader_kill", {"fencing": fencing})

    return action


def leader_publish() -> Any:
    """Tick action: whichever elector holds the lease publishes one
    generation record to the replica: the healthy bus churn and, after
    the failover, the new term's records, whose fencing band outranks
    any zombie write."""

    def action(ctx: Any) -> None:
        ctx.publish_generation()

    return action


def standby_takeover() -> Any:
    """Tick action: tick the standby elector (a server runs this on its
    renewal thread); on the tick that wins the lease the new term's
    fencing token floors the generation band."""

    def action(ctx: Any) -> None:
        was = ctx.standby_elector.is_leader
        now = ctx.standby_elector.tick()
        if now and not was:
            ctx.inject(
                "standby_elected", {"fencing": ctx.standby_elector.fencing}
            )

    return action


def stale_publish(generations: int = 1) -> Any:
    """Tick action: the deposed leader keeps publishing records in its
    old generation band, the split-brain writes fencing exists to reject.
    The replica must discard every one."""

    def action(ctx: Any) -> None:
        for _ in range(int(generations)):
            ctx.publish_generation(fencing=ctx.faults.get("dead_fencing", 1))

    return action


__all__ = [
    "FaultTransport",
    "INJECTED_ERROR",
    "clock_skew",
    "good_paints",
    "hub_restart",
    "kill_leader",
    "leader_publish",
    "preemption_wave",
    "prometheus_flap",
    "publish_frames",
    "restore_fleet",
    "slow_loris",
    "slow_paints",
    "stale_publish",
    "standby_takeover",
    "transport_errors",
    "transport_latency",
]

"""Replica-mode dashboard host and the bus consumer.

The port's copy of ``headlamp_tpu/replicate/replica.py``. A replica is a
:class:`DashboardApp` fed by bus records instead of a cluster: no
cluster transport, no Prometheus chain and no forecast fit. Each applied
record delivers the snapshot, the metrics and forecast peeks and the
history rows the leader already paid for. Everything downstream is the
host's own and runs on the replica's card: the gateway (admission,
coalescing, shedding), the fleet and region rollups over columns it
uploads once per applied generation, the trend statistics, the push hub
and the ETag/304 tier, all keyed by the generation the record carries.
A replica's ``/tpu/metrics`` paints the record's forecast and launches
the forecast kernel 0 times.

When the feed goes quiet past ``stale_after_s`` (a dead leader, a
partition) the replica keeps answering: its :meth:`ReplicaApp.stale`
probe is wired into the gateway's shed policy, so every interactive
paint is degraded and carries ``X-Headlamp-Stale: 1`` until a new
leader's first generation lands. It never fabricates a generation.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Any, Callable

import torch

from ..context.accelerator_context import ClusterSnapshot, ProviderState
from ..device import DeviceLike
from ..domain.accelerator import PROVIDERS, classify_fleet
from ..gateway import RenderGateway
from ..metrics.client import TpuMetricsSnapshot
from ..models.service import ForecastView
from ..obs.metrics import registry as _metrics_registry
from ..obs.trace import (
    annotate,
    current_trace_id,
    set_remote_parent,
    span,
    trace_request,
    trace_ring,
)
from ..registration import Registry
from ..server.app import DashboardApp
from ..transport import ApiError, ConnectionPool
from .bus import (
    _BYTES,
    _ERRORS,
    _GENERATIONS,
    decode_forecast,
    decode_metrics,
    decode_snapshot,
    parse_payload,
)

#: Bus silence after which a replica stamps its paints stale: two lease
#: TTLs. One quiet tick is routine (a clean sync publishes nothing);
#: silence across a whole failover window is not fresh data.
DEFAULT_STALE_AFTER_S = 30.0

#: The row every shipped scrape carries (``bus.history_rows``).
_SCRAPE_MARKER = "fleet.chips_reporting"


class _ReplicaTransport:
    """The replica's transport slot. A cluster request is a fault (a
    replica has no reactive track), so it raises, never returns an empty
    fleet."""

    def request(self, path: str, timeout_s: float = 2.0) -> Any:
        raise ApiError(path, "replica mode: no cluster transport", status=503)


class ReplicaApp(DashboardApp):
    """A :class:`DashboardApp` fed by bus records instead of syncs.
    ``device`` is the replica's card (CUDA unless the caller asks for
    ``"cpu"``), where its rollups and trend statistics run."""

    def __init__(
        self,
        *,
        device: DeviceLike = None,
        registry: Registry | None = None,
        clock: Callable[[], float] = time.time,
        monotonic: Callable[[], float] = time.monotonic,
        stale_after_s: float = DEFAULT_STALE_AFTER_S,
    ) -> None:
        super().__init__(
            _ReplicaTransport(),
            device=device,
            registry=registry,
            # No inline sync ever: _synced_snapshot is replaced outright.
            min_sync_interval_s=float("inf"),
            clock=clock,
            monotonic=monotonic,
        )
        self.stale_after_s = stale_after_s
        # Re-roled before the first stamp: a replica's entries (and the
        # age_at_paint role label) say so.
        self.ledger.role = "replica"
        #: Monotonic stamp of the last applied record, the staleness and
        #: lag anchor (never the record's fetched_at: the leader's wall
        #: clock is not this process's).
        self._last_apply_mono: float | None = None
        #: The peeks of the last applied record, served where the host
        #: would read its refreshers.
        self._bus_metrics: TpuMetricsSnapshot | None = None
        self._bus_forecast: ForecastView | None = None
        self.applied = 0
        self.rejected_stale = 0
        self._empty_snapshot: ClusterSnapshot | None = None

    # -- feed ------------------------------------------------------------

    def apply_record(self, record: dict[str, Any]) -> bool:
        """Apply one generation record: rebuild the snapshot on this
        replica's card, refresh the peeks, append the history rows and
        hand the snapshot to the push differ, the replica's mirror of the
        leader's sync bookkeeping. A generation at or below the current
        one is rejected: with generation bands that discards a deposed
        leader's records. Returns whether it applied."""
        generation = int(record.get("generation") or 0)
        obs = record.get("obs") or None
        with span("replicate.apply", generation=generation) as node:
            if obs and obs.get("trace_id"):
                # The record names the leader trace that published it:
                # link the poll trace under it.
                set_remote_parent(obs["trace_id"])
                annotate(origin_trace_id=obs["trace_id"])
            if generation <= self.snapshot_generation():
                self.rejected_stale += 1
                _GENERATIONS.inc(role="rejected_stale")
                if node is not None:
                    node.attrs["outcome"] = "rejected_stale"
                return False
            snap = decode_snapshot(
                record["snapshot"], generation=generation, device=self._device,
                fleet_cache=self._ctx.fleet_cache, rollup_results=self._ctx.rollup_results,
            )
            metrics = decode_metrics(record.get("metrics"))
            forecast = decode_forecast(record.get("forecast"))
            rows = [
                (str(metric), tuple(labels), float(value))
                for metric, labels, value in record.get("history") or []
            ]
            if rows:
                self.history.append_many(rows)
            self.history.syncs += 1
            if any(row[0] == _SCRAPE_MARKER for row in rows):
                # The record shipped a fresh scrape's rows: the trend
                # page's scrape count matches the leader's.
                self.history.scrapes += 1
            # The snapshot reference flips first (renders and /healthz
            # read it without a lock), then the peeks, then the differ
            # broadcasts: a request racing the flip paints one generation
            # consistently.
            now = self._mono()
            self._last_snapshot = snap
            self._last_snapshot_mono = now
            self._last_apply_mono = now
            self._bus_metrics = metrics
            self._bus_forecast = forecast
            self._sync_failures = 0
            self.applied += 1
            self.ledger.applied(generation, origin=obs, trace_id=current_trace_id())
            with span("push.diff", generation=generation):
                self.push.on_snapshot(
                    snap, generation=generation, metrics=metrics, forecast=forecast
                )
        _GENERATIONS.inc(role="applied")
        return True

    def stale(self) -> bool:
        """Has the feed gone quiet past ``stale_after_s``? True before the
        first record too: a replica that never heard a leader does not
        claim freshness."""
        mono = self._last_apply_mono
        return mono is None or self._mono() - mono > self.stale_after_s

    def lag_s(self) -> float | None:
        """Seconds since the last applied record (None before the first)."""
        mono = self._last_apply_mono
        return max(self._mono() - mono, 0.0) if mono is not None else None

    # -- host seams the bus replaces --------------------------------------

    def _synced_snapshot(self) -> ClusterSnapshot:
        # The last applied record, or before the first an honest loading
        # snapshot (no node or pod list: every page paints its skeleton).
        snap = self._last_snapshot
        if snap is not None:
            return snap
        if self._empty_snapshot is None:
            views = classify_fleet([], [])
            self._empty_snapshot = ClusterSnapshot(
                all_nodes=None,
                all_pods=None,
                providers={
                    p.name: ProviderState(
                        provider=p, view=views[p.name], workloads=[], device=self._device,
                        fleet_cache=self._ctx.fleet_cache,
                        rollup_results=self._ctx.rollup_results,
                    )
                    for p in PROVIDERS
                },
                errors=[],
                fetched_at=0.0,
                refresh_count=0,
            )
        return self._empty_snapshot

    def _cached_metrics(self) -> TpuMetricsSnapshot | None:
        return self._bus_metrics

    def _peek_metrics(self) -> TpuMetricsSnapshot | None:
        return self._bus_metrics

    def _peek_forecast(self) -> ForecastView | None:
        return self._bus_forecast

    def _forecast_for(self, metrics: TpuMetricsSnapshot | None) -> ForecastView | None:
        # Forecasts arrive on the bus: a replica never fits.
        return self._bus_forecast

    def start_background_sync(self, interval_s: float | None = None) -> threading.Event:
        raise RuntimeError("replica mode: the feed comes from the bus, not a sync loop")

    def ensure_gateway(self, **overrides: Any) -> RenderGateway:
        gateway = super().ensure_gateway(**overrides)
        # A quiet feed degrades every interactive paint (cache-only reads,
        # X-Headlamp-Stale: 1) with no code in the render path itself.
        gateway.shed_policy.degraded_probe = self.stale
        return gateway

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop the bus consumer's thread first (a late apply must not
        republish into a closing app), then close the host."""
        consumer = self.replication
        if consumer is not None:
            consumer.stop(timeout_s)
        super().close(timeout_s)


class BusConsumer:
    """Pulls the leader's bus and applies its records to one replica.
    :meth:`poll_once` is the whole protocol (tests call it directly); a
    server calls :meth:`start` for a poll thread on the replica's card.

    A fetch or parse failure (a dead or foreign leader) is counted in
    ``fetch_failures`` and named in ``last_fetch_error``: the designed way
    into stale-honest serving, never a fabricated generation. An
    apply that raises on the poll thread is counted in ``errors`` and
    named in ``last_error``; ``failing`` holds (the replica's ``/healthz``
    reads ``ok`` false) until a later record applies. The cursor stays
    behind the failed record, so the next poll retries it."""

    def __init__(
        self,
        app: ReplicaApp,
        fetch: Callable[[int], str],
        *,
        interval_s: float = 1.0,
    ) -> None:
        self.app = app
        self._fetch = fetch
        self.interval_s = interval_s
        self.cursor = 0
        self.fetch_failures = 0
        self.polls = 0
        self.bytes_applied = 0
        self.last_fetch_error: str | None = None
        self.errors = 0
        self.last_error: str | None = None
        self.failing = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # The replica's /healthz runtime.replication block reads this.
        app.replication = self
        set_active_consumer(self)

    def poll_once(self) -> int:
        """One pull: fetch everything past the cursor, apply it in order
        and move the cursor past every record seen, applied or fenced out
        (a rejected generation is never fetched again). Returns the
        records applied.

        Runs under its own ``/replicate/poll`` trace: the pool stamps its
        id onto the pull as ``traceparent`` (the leader's bus serve joins
        it), and an applied record's ``obs.trace_id`` links it under the
        leader's publishing trace. Only a poll that applied a record
        lands in the trace ring."""
        self.polls += 1
        with trace_request("/replicate/poll", wall=self.app._clock) as trace:
            try:
                payload = self._fetch(self.cursor)
                _, records = parse_payload(payload, origin="<bus-consumer>")
            except Exception as e:  # noqa: BLE001 — a dead or foreign leader: counted, stale
                self.fetch_failures += 1
                self.last_fetch_error = f"{type(e).__name__}: {e}"
                return 0
            self.bytes_applied += len(payload)
            _BYTES.inc(len(payload), role="applied")
            applied = 0
            for record in records:
                if self.app.apply_record(record):
                    applied += 1
                    self.failing = False
                self.cursor = max(self.cursor, int(record.get("generation") or 0))
            if trace is not None and applied:
                trace.finish(route="/replicate/poll", status=200, device_gets=0)
                trace_ring.record(trace.to_dict())
        return applied

    # -- poll thread -------------------------------------------------------

    def start(self) -> None:
        """Poll on a thread of its own, on the replica's card, every
        ``interval_s`` until :meth:`stop`."""
        if self._thread is not None:
            return
        interval = self.interval_s
        self._stop.clear()
        index = self.app._cuda_index

        def consume_loop() -> None:
            on_card = (
                torch.cuda.device(index) if index is not None else contextlib.nullcontext()
            )
            with on_card:
                while not self._stop.is_set():
                    try:
                        self.poll_once()
                    except Exception as e:  # noqa: BLE001 — counted, named in /healthz, ok false
                        self.errors += 1
                        self.last_error = f"{type(e).__name__}: {e}"
                        self.failing = True
                        _ERRORS.inc(role="replica")
                    self._stop.wait(interval)

        thread = threading.Thread(target=consume_loop, name="hl-torch-bus-consumer", daemon=True)
        self._thread = thread
        thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        """Stop the poll thread and join it; raises TimeoutError if it
        outlives ``timeout_s``."""
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout_s)
            if thread.is_alive():
                raise TimeoutError(f"the bus consumer outlived {timeout_s} s")
            self._thread = None

    def snapshot(self) -> dict[str, Any]:
        """The /healthz ``runtime.replication`` block (replica role)."""
        app = self.app
        lag = app.lag_s()
        return {
            "role": "replica",
            "cursor": self.cursor,
            "last_generation": app.snapshot_generation(),
            "applied": app.applied,
            "rejected_stale": app.rejected_stale,
            "polls": self.polls,
            "fetch_failures": self.fetch_failures,
            "last_fetch_error": self.last_fetch_error,
            "bytes_applied": self.bytes_applied,
            "errors": self.errors,
            "last_error": self.last_error,
            "stale": app.stale(),
            "lag_s": round(lag, 3) if lag is not None else None,
        }

    def counters(self) -> dict[str, int]:
        """Monotone ints for the flight recorder's deltas."""
        return {
            "applied": self.app.applied,
            "rejected_stale": self.app.rejected_stale,
            "polls": self.polls,
            "fetch_failures": self.fetch_failures,
            "bytes_applied": self.bytes_applied,
            "errors": self.errors,
        }


def pool_fetch(
    base_url: str, *, pool: ConnectionPool | None = None, timeout_s: float = 5.0
) -> Callable[[int], str]:
    """A fetch callable for :class:`BusConsumer` over the connection pool:
    ``GET {base_url}/replicate/bus`` with the cursor in ``Last-Generation``
    (the push hub's ``g<N>`` grammar), on a socket kept alive across
    polls."""
    pool = pool or ConnectionPool()
    base = base_url.rstrip("/")

    def fetch(cursor: int) -> str:
        with pool.request(
            f"{base}/replicate/bus", headers={"Last-Generation": f"g{cursor}"},
            timeout_s=timeout_s,
        ) as resp:
            body = resp.read()
            if resp.status != 200:
                raise ApiError(
                    "/replicate/bus", f"bus pull failed: HTTP {resp.status}", status=resp.status
                )
            return body.decode("utf-8")

    return fetch


# -- the lag gauge's active consumer ------------------------------------------

_ACTIVE: weakref.ref | None = None


def set_active_consumer(consumer: BusConsumer | None) -> None:
    global _ACTIVE
    _ACTIVE = weakref.ref(consumer) if consumer is not None else None


def _lag_sample() -> float | None:
    consumer = _ACTIVE() if _ACTIVE is not None else None
    if consumer is None:
        return None
    return consumer.app.lag_s()


_metrics_registry.gauge_fn(
    "headlamp_tpu_torch_replicate_lag_seconds",
    "Seconds since the active replica applied a bus record "
    "(absent on leaders and before the first record).",
    _lag_sample,
)

"""Dashboard HTTP host: the cluster dashboard and the metrics page, over a socket.

The port's counterpart of ``headlamp_tpu/server/app.py``. It serves,
over stdlib ``http.server``:

- ``GET /tpu``                the Overview, its aggregates from the fleet
  rollup on the app's device (``analytics.stats.fleet_stats``);
- ``GET /tpu/fleet``          the drill-down (fleet, ``?region=cluster/<c>``,
  ``?region=cluster/<c>/slice/<s>`` with ``?limit=``/``?cursor=``), its
  per-region sums from the region rollup on the app's device
  (``viewport.viewport_tree``);
- ``GET /tpu/nodes``, ``/tpu/pods``, ``/tpu/deviceplugins``,
  ``/tpu/topology``           the other snapshot pages (the node table
  paged by ``?page=``/``?q=`` or windowed by ``?limit=``/``?cursor=``,
  the pod table windowed; the topology heatmap from a peek of the
  metrics cache, never a fetch);
- ``GET /nodes``, ``/node/<name>``, ``/pod/<namespace>/<name>`` the
  native views with the registered TPU columns and detail sections (an
  unknown node or pod is a 404);
- ``GET /tpu/metrics``        the metrics page with its utilization
  forecast, fit on the app's device (on the captured history once the
  history store holds a training window, else on a range query) and
  served by the fused CUDA kernel ``forecast_mlp_forward`` on a card (its
  plain version on the CPU);
- ``GET /tpu/trends``         the history store's series (``?window=``,
  ``?metric=`` with ``?limit=``/``?cursor=``), their statistics computed
  in one program on the app's device; it reads no snapshot;
- ``GET /refresh?back=<url>`` wake the background sync (or, without
  one, re-run the snapshot's imperative track), invalidate the metrics
  and forecast caches (and with ``recalibrate=1`` the rollup calibration
  and the device columns), then redirect to a registered route or a node
  or pod detail path;
- ``GET /healthz``            liveness and the runtime counters, as JSON;
- ``GET /metricsz``           Prometheus text self-exposition, or
  OpenMetrics with exemplars when the Accept header asks for it;
- ``GET /sloz``               the SLO engine's report (burn rates, budgets,
  exemplars, the budget self-forecast fit on the app's device), as JSON;
- ``GET /debug/traces``, ``/debug/flightz``, ``/debug/generationz``,
  ``/debug/profilez`` (``?burst=SECONDS``) and ``/debug/profilez/folded``
  the trace ring, the flight recorder, the generation ledger and the
  sampling profiler; ``/debug/traces/html``, ``/sloz/html``,
  ``/debug/profilez/html`` and ``/debug/generationz/html`` are their
  registered HTML pages, painted from the same snapshots and never from
  a cluster snapshot.

Every other path is a 404. Every snapshot page reads a cluster snapshot
from the app's ``AcceleratorDataContext``. Without background sync it is
synced inline at most once per ``min_sync_interval_s`` and shared
otherwise (the JAX host's inline branch, `app.py:755-773`). With
:meth:`DashboardApp.start_background_sync` a thread syncs with
list+watch: a quiet tick keeps the snapshot and its version, a changed
tick publishes a new one and uploads its fleet columns to the app's
device off the request path, and pages read the published snapshot
without the sync lock. Every sync and every metrics scrape lands in the
app's history store. The metrics fetch and the forecast sit behind two
stale-while-revalidate refreshers: the first request for a fleet fits
cold, and after the TTL a stale page is served at once while one
background refit warm-starts from the process-wide carry
(``runtime.device_cache.warm_carries``).

:func:`serve` starts the process's program registry (``models/aot.py``)
capturing every hot device program as a CUDA graph per bucket on a
background thread; once it is ready the fits and rollups replay their
graphs, and a warm refit with the published TPU view runs the rollup and
the refinement as one fused replay whose rollup the overview then reads.
``/healthz`` carries the graph cost ledger (``runtime.graphs``) and the
registry (``runtime.aot``); a failed capture turns ``ok`` false.

Each request runs in its own trace with its route published to the
sampling profiler; its latency (a non-5xx) is observed inside the trace,
so the histogram's exemplar carries the trace id, and feeds the SLO
engine; its wide event, with what it moved in the runtime counters,
goes to the flight recorder, pinned when it answered 5xx or violated an
objective. The generation ledger stamps each sync's scrape and snapshot
and each generation's first paint. :func:`serve` also starts the
sampling profiler's thread; the server's ``close()`` stops it.

The gateway, push, replication, workers, the fragment cache, the
incident timeline and the pages not listed above are not part of this
host; ``/healthz`` leaves out the keys of the JAX host's that describe
them.
"""

from __future__ import annotations

import contextlib
import html
import json
import re
import threading
import time
from functools import lru_cache
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable
from urllib.parse import parse_qs, urlparse

import torch

from ..analytics import stats as rollup_stats
from ..analytics.encode import _bucket
from ..context.accelerator_context import AcceleratorDataContext, ClusterSnapshot
from ..device import DeviceLike, resolve_device
from ..history import HistoryStore, set_active_store
from ..metrics.client import TpuMetricsSnapshot, fetch_tpu_metrics
from ..models import aot
from ..models.fused_forward import LAUNCHES, kernel_build_info
from ..models.service import ForecastView, compute_forecast_incremental
from ..obs import graphcost
from ..obs import slo as slo_mod
from ..obs.flight import flight_recorder, wide_event
from ..obs.ledger import GenerationLedger
from ..obs.metrics import OPENMETRICS_CONTENT_TYPE, TEXT_CONTENT_TYPE, negotiate_openmetrics
from ..obs.metrics import registry as metrics_registry
from ..obs.profiler import attribution, profiler
from ..obs.trace import annotate, current_trace_id, span, trace_request, trace_ring
from ..pages.native import native_node_page, native_pod_page
from ..registration import Registry, register_plugin
from ..runtime.device_cache import warm_carries
from ..runtime.refresh import Refresher
from ..runtime.transfer import TransferBatch, transfer_stats
from ..transport.api_proxy import Transport
from ..ui import Element, render_html
from .style import STYLESHEET

#: Paths the host answers itself, outside the registry.
_OWN_ROUTES = (
    "/healthz",
    "/refresh",
    "/metricsz",
    "/debug/traces",
    "/sloz",
    "/debug/flightz",
    "/debug/profilez",
    "/debug/profilez/folded",
    "/debug/generationz",
)

#: The native detail paths (`app.py:65-70` of the JAX host): Kubernetes
#: names only, so a detail path is a bounded route label and a safe
#: redirect target.
_NODE_DETAIL_RE = re.compile(r"^/node/([a-z0-9.-]{1,253})$")
_POD_DETAIL_RE = re.compile(r"^/pod/([a-z0-9.-]{1,253})/([a-z0-9.-]{1,253})$")

#: Route labels whose traces stay out of the ring and whose requests stay
#: out of the flight recorder: a probe polling /healthz or a scraper on
#: /metricsz would evict every page trace, and tracing the debug surfaces
#: would make them describe themselves. Their request metrics still count.
_RING_EXCLUDED = frozenset(
    {
        "/healthz",
        "/metricsz",
        "/debug/traces",
        "/debug/traces/html",
        "/sloz",
        "/sloz/html",
        "/debug/flightz",
        "/debug/profilez",
        "/debug/profilez/folded",
        "/debug/profilez/html",
        "/debug/generationz",
        "/debug/generationz/html",
    }
)

#: Route kinds painted from a telemetry snapshot, never a cluster one.
_DEBUG_KINDS = ("traces", "slo", "profile", "generations")


@lru_cache(maxsize=64)
def _nav_html(entries: tuple[tuple[str, str], ...], active: str) -> str:
    """Sidebar nav markup, memoized per (entries, active route): the
    entry set is fixed once the plugin is registered."""
    return "".join(
        f'<a href="{url}"' + (' class="active"' if url == active else "") + f">{label}</a>"
        for url, label in entries
    )


class DashboardApp:
    """The dashboard host's request handling, without sockets
    (:meth:`handle`), plus :meth:`serve` to put it on one.

    ``device`` is where the forecast fits and runs and where the fleet
    rollup runs: CUDA unless the caller asks for ``"cpu"``; without CUDA
    the constructor raises. ``clock`` (wall time) is only for displayed
    timestamps (page ages, the snapshot's fetch time) and the Prometheus
    range-query bounds; ``monotonic`` drives every TTL, age and the sync
    interval, so tests advance a list cell instead of sleeping."""

    #: Forecasts are fresh this long: the history grid gains a point per
    #: step, and the fit must not run on every page view.
    FORECAST_TTL_S = 60.0
    #: Past the TTL but within this total age, a forecast is served at
    #: once while a background worker refits; only a key idle longer
    #: than this pays a blocking fit.
    FORECAST_GRACE_S = 600.0
    #: Instant metrics fetches are cached briefly too.
    METRICS_TTL_S = 5.0
    METRICS_GRACE_S = 60.0
    #: How stale a cached metrics snapshot may be and still tint the
    #: topology heatmap: a minute-old tint beats none, and the page must
    #: never pay the Prometheus chain for it.
    METRICS_PEEK_MAX_AGE_S = 60.0
    #: Consecutive failing syncs at which /healthz flips ``ok`` to false:
    #: one blip must not restart a pod, a persistent failure must not
    #: hide behind a hard-coded true.
    HEALTH_FAILURE_THRESHOLD = 3
    #: With background sync live, a snapshot older than this many
    #: intervals means the loop is wedged (thread died, sync hanging).
    HEALTH_MAX_STALE_INTERVALS = 3.0
    #: Staleness floor for the wedged check: a tick spans the two bounded
    #: watch windows plus the imperative track, so at small intervals
    #: ``intervals × interval`` alone would flap on a healthy cluster.
    HEALTH_MIN_STALE_S = 30.0

    def __init__(
        self,
        transport: Transport,
        *,
        device: DeviceLike = None,
        registry: Registry | None = None,
        min_sync_interval_s: float = 5.0,
        clock: Callable[[], float] = time.time,
        monotonic: Callable[[], float] = time.monotonic,
    ) -> None:
        self._device = resolve_device(device)
        self._transport = transport
        self._registry = registry if registry is not None else register_plugin()
        self._clock = clock
        self._mono = monotonic
        #: The cluster snapshot every page reads; it owns the snapshot's
        #: device-resident fleet columns (``self._ctx.fleet_cache``).
        self._ctx = AcceleratorDataContext(transport, device=self._device, clock=clock)
        #: The card the background loop works on, fixed here: its thread
        #: starts with no CUDA context and must not land on another card.
        self._cuda_index: int | None = None
        if self._device.type == "cuda":
            self._cuda_index = (
                self._device.index if self._device.index is not None
                else torch.cuda.current_device()
            )
        self._min_sync = min_sync_interval_s
        # -inf, not 0.0: the monotonic clock's epoch is arbitrary, and 0.0
        # could suppress the first sync for up to min_sync seconds.
        self._last_sync = float("-inf")
        #: Serializes syncs, refreshes and the check-then-act on
        #: _last_sync; renders of a built snapshot stay lock-free.
        self._sync_lock = threading.Lock()
        #: The last published snapshot: every page read and every
        #: background tick publishes it (one reference assignment), and
        #: /healthz and the background branch of the request path read it
        #: without the sync lock.
        self._last_snapshot: ClusterSnapshot | None = None
        #: Monotonic stamp of the last completed sync, for /healthz.
        self._last_snapshot_mono: float | None = None
        #: The background loop (see start_background_sync): its stop
        #: handle, wake event, interval and threads (joined by close).
        self._background_stop: threading.Event | None = None
        self._background_wake = threading.Event()
        self._background_interval: float | None = None
        self._background_threads: list[threading.Thread] = []
        #: Serializes loop restarts against a stop handle's set(): the
        #: stale-handle guard is a check-then-act. Reentrant, because a
        #: restart sets the old handle while holding it.
        self._bg_lock = threading.RLock()
        #: Consecutive syncs that raised or built an errors-bearing
        #: snapshot, and the last such error.
        self._sync_failures = 0
        self._last_sync_error: str | None = None
        #: The background loop's counters (under self._lock): ticks,
        #: warm uploads, warm errors. A failed warm holds /healthz ok
        #: false until a later warm succeeds.
        self._background_counters = {"ticks": 0, "warms": 0, "warm_errors": 0}
        self._last_warm_error: str | None = None
        self._warm_failing = False
        #: The last background tick's trace (span tree), never ringed: a
        #: quiet cluster's ticks would evict every page trace.
        self.last_tick_trace: dict[str, Any] | None = None
        self._metrics_refresher = Refresher(
            "metrics", ttl_s=self.METRICS_TTL_S, grace_s=self.METRICS_GRACE_S,
            monotonic=monotonic,
        )
        self._forecast_refresher = Refresher(
            "forecast", ttl_s=self.FORECAST_TTL_S, grace_s=self.FORECAST_GRACE_S,
            monotonic=monotonic,
        )
        #: The history tier, one per app on its monotonic clock; its
        #: trend statistics run on the app's device. The module-level
        #: active store only feeds the /metricsz gauges (latest app wins).
        self.history = HistoryStore(monotonic=monotonic, device=self._device)
        set_active_store(self.history)
        # The process SLO engine mirrors its paint latencies into (and
        # trains its budget forecast from) this store, on this app's
        # device: the latest app wins, as with the store's gauges.
        engine = slo_mod.engine()
        engine.history_store = self.history
        engine.device = self._device
        #: Lifecycle stamps of every snapshot generation this app syncs
        #: and paints, on the app's clocks.
        self.ledger = GenerationLedger(monotonic=monotonic, wall=clock, role="leader")
        # Every scrape the metrics refresher stores (background refits
        # and cold fills) lands in the history store.
        self._metrics_refresher.on_store = self._capture_metrics_store
        #: Warm-start carries per forecast key, for the whole process: a
        #: rebuilt app warm-starts from what the process already learned.
        self._warm_forecast_states = warm_carries
        #: Guards the epoch and the request counters below (request
        #: threads update them concurrently).
        self._lock = threading.Lock()
        #: Bumped by /refresh. Cache entries record the epoch current when
        #: their compute started; a mismatch invalidates them without
        #: touching the refreshers' locks, so the redirect never waits
        #: behind a fit.
        self._cache_epoch = 0
        self.requests_served = 0
        self.request_device_gets = 0
        #: Device-to-host copies the last request waited for: 1 on a cold
        #: or blocking metrics request on the card, 0 on a cached paint.
        self.last_request_device_gets = 0
        # Get-or-create: many apps in one process share the instruments.
        self._req_hist = metrics_registry.histogram(
            slo_mod.REQUEST_DURATION, slo_mod.REQUEST_DURATION_HELP, labels=("route",)
        )
        self._req_total = metrics_registry.counter(
            slo_mod.REQUESTS_TOTAL, slo_mod.REQUESTS_TOTAL_HELP, labels=("route", "status")
        )
        self._sync_fail_total = metrics_registry.counter(
            "headlamp_tpu_torch_sync_failures_total",
            "Cluster syncs that raised or built an errors-bearing snapshot.",
        )

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def _home(self) -> str:
        """Where /refresh returns by default: the first registered page."""
        return self._registry.routes[0].path

    def snapshot_generation(self) -> int:
        """The generation of the last published snapshot (0 before any
        sync), read without a lock."""
        snap = self._last_snapshot
        if snap is None:
            return 0
        return next((int(s.view.version) for s in snap.providers.values() if s.view.version), 0)

    # ------------------------------------------------------------------
    # The cluster snapshot
    # ------------------------------------------------------------------

    def start_background_sync(self, interval_s: float | None = None) -> threading.Event:
        """Sync the cluster on a thread of its own every ``interval_s``
        seconds (default ``max(min_sync_interval_s, 1)``), with
        list+watch: page views read the last published snapshot instead
        of syncing inline. A changed tick's new snapshot version has its
        TPU fleet columns uploaded to the app's device off the request
        path; a quiet tick keeps the version and uploads nothing. Returns
        the stop handle; :meth:`close` stops and joins the loop. A sync
        that raises is counted and retried on the next tick."""
        app = self

        class _StopEvent(threading.Event):
            """Setting stop also wakes the loop, so it exits at once, and
            (only while this is still the active loop's handle) turns
            watch back off: the inline sync of the request path must
            cost plain LISTs, not watch windows. A stale handle's set()
            must not disable a newer loop's watch."""

            wake: threading.Event

            def set(self) -> None:  # noqa: A003 (threading.Event API)
                super().set()
                with app._bg_lock:
                    if app._background_stop is self:
                        app._ctx.enable_watch(False)
                self.wake.set()

        with self._bg_lock:
            # A restart replaces a live loop: stop it first so two loops
            # never share the context, and give the new loop its own wake
            # event, so an orphaned loop cannot consume a /refresh wake.
            if self._background_live():
                self._background_stop.set()
            wake = threading.Event()
            self._background_wake = wake
            stop = _StopEvent()
            stop.wake = wake
            interval = interval_s if interval_s is not None else max(self._min_sync, 1.0)
            self._background_interval = interval
            self._background_stop = stop
            # Enabled once this handle is the active one, so a stale set()
            # re-checking under the same lock cannot undo it.
            self._ctx.enable_watch()
            self._background_threads = [t for t in self._background_threads if t.is_alive()]

        def loop() -> None:
            on_card = (
                torch.cuda.device(self._cuda_index) if self._cuda_index is not None
                else contextlib.nullcontext()
            )
            with on_card:
                self._background_tick()  # hydrate at once
                while True:
                    wake.wait(interval)
                    wake.clear()
                    if stop.is_set():
                        return
                    self._background_tick()

        thread = threading.Thread(target=loop, name="hl-torch-sync", daemon=True)
        with self._bg_lock:
            self._background_threads.append(thread)
        thread.start()
        return stop

    def _background_tick(self) -> None:
        """One background sync: publish the snapshot, record it, warm its
        fleet columns. Runs under a trace of its own that is kept as
        ``last_tick_trace``, not in the ring."""
        status = 200
        with trace_request("/sync", wall=self._clock) as trace:
            try:
                with span("sync.snapshot", source="background"), self._sync_lock:
                    self.ledger.scrape_started()
                    self._ctx.sync()
                    now = self._mono()
                    self._last_sync = now
                    snap = self._ctx.snapshot()
                    self._last_snapshot = snap
                    self._last_snapshot_mono = now
                    annotate(nodes=len(snap.all_nodes or []))
            except Exception as e:  # noqa: BLE001 — the loop must keep ticking
                status = 500
                self._record_sync(None, error=e)
            else:
                self._record_sync(snap)
                self._warm_device_cache(snap)
            with self._lock:
                self._background_counters["ticks"] += 1
        if trace is not None:
            trace.finish(route="/sync", status=status, device_gets=0)
            self.last_tick_trace = trace.to_dict()

    def _warm_device_cache(self, snap: ClusterSnapshot) -> None:
        """Upload the TPU fleet's columns to the app's device as soon as a
        new snapshot lands, so the first request against it is a cache
        hit. Gated on the rollup floor: below it the policy serves the
        Python rollup, which never reads the columns. An error is counted
        and flips /healthz ``ok`` to false; the next request runs the
        same upload and answers 500 naming it."""
        state = snap.providers.get("tpu")
        if state is None or state.view.version is None:
            return
        if len(state.view.nodes) < rollup_stats.DEVICE_ROLLUP_MIN_NODES:
            return
        try:
            uploaded = self._ctx.fleet_cache.warm(state.view)
        except Exception as e:  # noqa: BLE001 — recorded, and the request path re-raises it
            with self._lock:
                self._background_counters["warm_errors"] += 1
                self._last_warm_error = f"{type(e).__name__}: {e}"
                self._warm_failing = True
            return
        with self._lock:
            self._background_counters["warms"] += int(uploaded)
            self._warm_failing = False
        # The buckets this fleet actually encodes to get both rollups
        # captured in the background (a no-op before the registry's
        # startup and for buckets it holds), off the request path.
        aot.registry().ensure_rollup_shapes(
            _bucket(max(len(state.view.nodes), 1)), _bucket(max(len(state.view.pods), 1)),
            self._device,
        )

    def _capture_metrics_store(self, key: Any, value: Any) -> None:
        """Refresher ``on_store`` hook: record each fetched metrics
        snapshot into the history tier. A cached failure (None) appends
        nothing: the gap is the record of the outage."""
        if value is not None and getattr(value, "chips", None):
            self.history.record_scrape(value)

    def _record_sync(self, snap: ClusterSnapshot | None, error: Exception | None = None) -> None:
        """Capture each completed sync's generation, node count and error
        count into the history tier, and count consecutive failing syncs
        for /healthz: a sync fails when it raised (``snap`` None) or its
        snapshot carries reactive-track errors (transport failures never
        raise out of ``sync()``; they degrade into the error streams)."""
        if snap is not None:
            generation = next(
                (int(s.view.version) for s in snap.providers.values() if s.view.version), 0
            )
            self.history.record_sync(
                generation=generation, nodes=len(snap.all_nodes or []), errors=len(snap.errors)
            )
            # The scrape became this generation.
            self.ledger.synced(generation, trace_id=current_trace_id())
        if snap is not None and not snap.errors:
            self._sync_failures = 0
            return
        self._sync_failures += 1
        self._last_sync_error = (
            f"{type(error).__name__}: {error}" if error is not None else snap.error
        )
        self._sync_fail_total.inc()

    def _background_live(self) -> bool:
        stop = self._background_stop
        return stop is not None and not stop.is_set()

    def _synced_snapshot(self) -> ClusterSnapshot:
        """The snapshot for a page. With the background loop live: the
        published snapshot, read without the sync lock (a tick holds it
        across its watch windows). Otherwise one inline sync under the
        sync lock when ``min_sync_interval_s`` has passed on the
        monotonic clock since the last, else the current snapshot
        (coalesced)."""
        with span("sync.snapshot"):
            if self._background_live():
                snap = self._last_snapshot
                if snap is not None:
                    annotate(source="background", nodes=len(snap.all_nodes or []))
                    return snap
                # Not hydrated yet: build one under the lock (it races the
                # loop's first tick harmlessly; the lock serializes them).
            with self._sync_lock:
                now = self._mono()
                if not self._background_live() and now - self._last_sync >= self._min_sync:
                    self.ledger.scrape_started()
                    self._ctx.sync()
                    self._last_sync = now
                    snap = self._ctx.snapshot()
                    self._record_sync(snap)
                    self._last_snapshot_mono = now
                    annotate(source="inline-sync")
                else:
                    snap = self._ctx.snapshot()
                    annotate(source="coalesced")
                self._last_snapshot = snap
                annotate(nodes=len(snap.all_nodes or []))
                return snap

    # ------------------------------------------------------------------
    # Metrics and forecast, behind the refreshers
    # ------------------------------------------------------------------

    @staticmethod
    def _metrics_key(metrics: TpuMetricsSnapshot) -> Any:
        """Forecast cache key: the Prometheus target and the chip set.
        Sample values change every scrape; a forecast is wrong for the
        fleet only when the chips themselves change."""
        return (
            metrics.namespace,
            metrics.service,
            frozenset((c.node, c.accelerator_id) for c in metrics.chips),
        )

    def _cached_metrics(self) -> TpuMetricsSnapshot | None:
        """``fetch_tpu_metrics`` behind its refresher. A failed fetch
        (None) is cached too, so a down Prometheus is not probed on every
        view. The epoch is read before the fetch: a /refresh arriving
        mid-fetch leaves the entry born stale."""
        r = self._metrics_refresher
        # Re-read per call: the class attributes are operator and test knobs.
        r.ttl_s = self.METRICS_TTL_S
        r.grace_s = max(self.METRICS_GRACE_S, self.METRICS_TTL_S)
        return r.get(
            "metrics",
            lambda: fetch_tpu_metrics(self._transport, clock=self._clock),
            epoch=self._cache_epoch,
        )

    def _forecast_for(self, metrics: TpuMetricsSnapshot | None) -> ForecastView | None:
        """Forecast view for the metrics page, or None when there are no
        chips or no usable history. A fit that raises propagates: the
        page answers 500 naming it, and never drops the forecast panel
        in silence."""
        if metrics is None or not metrics.chips:
            return None
        r = self._forecast_refresher
        r.ttl_s = self.FORECAST_TTL_S
        r.grace_s = max(self.FORECAST_GRACE_S, self.FORECAST_TTL_S)
        return r.get(
            self._metrics_key(metrics),
            lambda: self._compute_forecast(metrics),
            epoch=self._cache_epoch,
        )

    def _peek_metrics(self) -> TpuMetricsSnapshot | None:
        """The cached metrics snapshot if younger than
        ``METRICS_PEEK_MAX_AGE_S``, else None — never fetches. For the
        topology heatmap, a progressive enhancement that reuses what a
        recent metrics view already paid for."""
        return self._metrics_refresher.peek(
            "metrics", epoch=self._cache_epoch, max_age_s=self.METRICS_PEEK_MAX_AGE_S
        )

    def _metrics_and_forecast(self) -> tuple[TpuMetricsSnapshot | None, ForecastView | None]:
        with span("page.data.metrics"):
            metrics = self._cached_metrics()
        with span("page.data.forecast"):
            forecast = self._forecast_for(metrics)
        return metrics, forecast

    def _compute_forecast(self, metrics: TpuMetricsSnapshot) -> ForecastView | None:
        """One fit for ``metrics``' chip set, warm from the process carry
        when there is one. The carry is taken, not read, so it feeds one
        fit at a time; the new carry is stored back. A fit that raises
        left the taken carry untouched (the fit clones what it is
        handed), so it is stored back before the error propagates."""
        key = self._metrics_key(metrics)
        state = self._warm_forecast_states.take(key)
        # The published TPU view: when the warm carry and a captured
        # bucket line up, the rollup and the refinement run as one fused
        # replay, and the overview's next fleet_stats reads its parked
        # rollup.
        snap = self._last_snapshot
        tpu = snap.providers.get("tpu") if snap is not None else None
        try:
            # Once the history store holds a full training window, the
            # fit trains on captured history, with no range query.
            view, new_state = compute_forecast_incremental(
                self._transport, metrics, state=state, clock=self._clock, device=self._device,
                history_store=self.history,
                fleet_view=tpu.view if tpu is not None else None,
                fleet_cache=self._ctx.fleet_cache,
                rollup_results=self._ctx.rollup_results,
            )
        except BaseException:
            if state is not None:
                self._warm_forecast_states.store(key, state)
            raise
        if new_state is not None:
            self._warm_forecast_states.store(key, new_state)
        if view is not None and view.warm_demotion_reason is not None:
            self._forecast_refresher.note_demotion()
        return view

    # ------------------------------------------------------------------
    # Request handling
    # ------------------------------------------------------------------

    def _route_label(self, path: str) -> str:
        """Bounded-cardinality route label: unknown paths collapse to
        'other', so a scanner walking random paths mints no new labels."""
        route_path = urlparse(path).path.rstrip("/") or "/tpu"
        if route_path in _OWN_ROUTES:
            return route_path
        if _NODE_DETAIL_RE.match(route_path):
            return "/node/{name}"
        if _POD_DETAIL_RE.match(route_path):
            return "/pod/{namespace}/{name}"
        if self._registry.route_for(route_path) is not None:
            return route_path
        return "other"

    def handle(self, path: str, accept: str | None = None) -> tuple[int, str, str]:
        """(status, content_type, body) for a GET; for a 302 the content
        type slot holds the Location. ``accept`` is the Accept header;
        only /metricsz reads it. Never raises: an exception becomes a 500
        page that names it.

        Each request runs in its own transfer batch, which counts the
        device-to-host copies it waits for, and its own trace, which
        lands in the trace ring, with its route published to the sampling
        profiler. Its latency is observed inside the trace (the bucket's
        exemplar carries the trace id); a 5xx stays out of the latency
        histogram and counts once, in requests_total, which is how the
        SLO engine sees it. A recorded request's wide event, with the
        runtime counters it moved, goes to the flight recorder, pinned
        when it answered 5xx or violated an objective."""
        t0 = time.perf_counter()
        route_label = self._route_label(path)
        batch = TransferBatch()
        status = 500
        recorded = route_label not in _RING_EXCLUDED
        counters_before = self._runtime_counters() if recorded else None
        with trace_request(path, enabled=recorded, wall=self._clock) as trace, attribution(
            route_label
        ):
            try:
                with batch.scope():
                    status, content_type, body = self._handle(path, accept)
                    return status, content_type, body
            except Exception as e:  # noqa: BLE001 — the request's error boundary
                body = self._page_html(
                    "Error",
                    "<div class='hl-error' role='alert'>Internal error: "
                    f"{html.escape(type(e).__name__)}: {html.escape(str(e))}</div>",
                )
                return 500, "text/html", body
            finally:
                with self._lock:
                    self.requests_served += 1
                    self.request_device_gets += batch.blocking_gets
                    self.last_request_device_gets = batch.blocking_gets
                duration_s = time.perf_counter() - t0
                # A 5xx counts in requests_total only: a fast error is not
                # a good latency observation.
                if status < 500:
                    self._req_hist.observe(duration_s, route=route_label)
                self._req_total.inc(route=route_label, status=str(status))
                trace_dict = None
                if trace is not None:
                    trace.finish(route=route_label, status=status, device_gets=batch.blocking_gets)
                    trace_dict = trace.to_dict()
                    trace_ring.record(trace_dict)
                if counters_before is not None:
                    violations = slo_mod.engine().violations(route_label, duration_s, status)
                    flight_recorder.record(
                        wide_event(
                            path=path, route=route_label, status=status, duration_s=duration_s,
                            trace=trace_dict, violations=violations,
                            counters_before=counters_before,
                            counters_after=self._runtime_counters(),
                        ),
                        pinned=bool(violations) or status >= 500,
                    )

    def _runtime_counters(self) -> dict[str, float]:
        """The flat, dotted monotone counters a wide event reports the
        movement of: plain reads, taken twice per recorded request."""
        out: dict[str, float] = {}
        blocks: list[tuple[str, dict[str, Any]]] = [
            ("transfer", transfer_stats.snapshot()),
            ("fleet_cache", self._ctx.fleet_cache.counters()),
            ("warm_carries", self._warm_forecast_states.counters()),
            ("history", self.history.counters()),
            ("graphs", graphcost.ledger().counters()),
            ("aot", aot.registry().counters()),
            ("profiler", profiler().counters()),
        ]
        blocks += [
            (f"refresh.{r.name}", r.counters())
            for r in (self._metrics_refresher, self._forecast_refresher)
        ]
        for prefix, counters in blocks:
            for key, value in counters.items():
                out[f"{prefix}.{key}"] = value
        return out

    def _handle(self, path: str, accept: str | None = None) -> tuple[int, str, str]:
        parsed = urlparse(path)
        route_path = parsed.path.rstrip("/") or "/tpu"

        if route_path == "/healthz":
            return 200, "application/json", json.dumps(self._health())
        if route_path == "/metricsz":
            # Exemplars ride the OpenMetrics rendering only: a text-format
            # scraper would fail the whole scrape on them.
            if negotiate_openmetrics(accept):
                return 200, OPENMETRICS_CONTENT_TYPE, metrics_registry.render(openmetrics=True)
            return 200, TEXT_CONTENT_TYPE, metrics_registry.render()
        if route_path == "/debug/traces":
            return 200, "application/json", json.dumps(
                {"capacity": trace_ring.capacity, "traces": trace_ring.snapshot()}
            )
        if route_path == "/sloz":
            return 200, "application/json", json.dumps(slo_mod.engine().report())
        if route_path == "/debug/flightz":
            snapshot = flight_recorder.snapshot()
            return 200, "application/json", json.dumps({
                "capacity": flight_recorder.capacity,
                "pinned_capacity": flight_recorder.pinned_capacity,
                "pinned": snapshot["pinned"],
                "recent": snapshot["recent"],
            })
        if route_path == "/debug/generationz":
            return 200, "application/json", json.dumps(self.ledger.snapshot())
        if route_path == "/debug/profilez":
            # ?burst=N samples at the burst rate for N seconds (clamped).
            prof = profiler()
            query = parse_qs(parsed.query)
            granted: float | None = None
            if "burst" in query:
                try:
                    granted = prof.burst(float(query["burst"][0]))
                except ValueError:
                    granted = None
            out = prof.snapshot()
            if granted is not None:
                out["burst_granted_s"] = granted
            return 200, "application/json", json.dumps(out)
        if route_path == "/debug/profilez/folded":
            return 200, "text/plain", profiler().folded()
        if route_path == "/refresh":
            # With the background loop live, waking it covers both tracks
            # and the redirect never waits on the sync lock the loop holds
            # across its ticks. Without it, re-run the imperative track
            # inline, as the reference's refreshKey effect does. Then bump
            # the epoch: every cached metrics and forecast entry is stale
            # from now on, and the redirect never waits behind a fit.
            if self._background_live():
                self._background_wake.set()
            else:
                with self._sync_lock:
                    self._ctx.refresh()
            with self._lock:
                self._cache_epoch += 1
            query = parse_qs(parsed.query)
            if query.get("recalibrate", ["0"])[0] in ("1", "true"):
                # Explicit opt-in only: the bare /refresh is every page's
                # header link, and a re-probe per click would re-pay it.
                rollup_stats.calibration.reset()
                self._ctx.fleet_cache.invalidate()
            back = query.get("back", [self._home])[0]
            # Only registered route paths and strictly-shaped native
            # detail paths may be redirect targets: no open redirects
            # ('//evil', absolute URLs), no header injection.
            if self._registry.route_for(back) is None and not (
                _NODE_DETAIL_RE.match(back) or _POD_DETAIL_RE.match(back)
            ):
                back = self._home
            return 302, back, ""

        # The native views the detail sections inject into
        # (`index.tsx:152-170`); a data-notfound page is a 404.
        if node_match := _NODE_DETAIL_RE.match(route_path):
            snap = self._synced_snapshot()
            with span("page.component", kind="native-node-detail"):
                el = native_node_page(
                    snap, node_match.group(1), now=self._clock(), registry=self._registry
                )
            return self._detail_response(el, f"Node {node_match.group(1)}", route_path)
        if pod_match := _POD_DETAIL_RE.match(route_path):
            snap = self._synced_snapshot()
            with span("page.component", kind="native-pod-detail"):
                el = native_pod_page(
                    snap, pod_match.group(1), pod_match.group(2), now=self._clock(),
                    registry=self._registry,
                )
            return self._detail_response(el, f"Pod {pod_match.group(2)}", route_path)

        route = self._registry.route_for(route_path)
        if route is None:
            return 404, "text/html", self._page_html("Not Found", "<p>No such page.</p>")
        if route.kind == "trends":
            return self._trends_response(route, parse_qs(parsed.query), route_path)
        if route.kind in _DEBUG_KINDS:
            return self._debug_page_response(route, route_path)
        snap = self._synced_snapshot()
        now = self._clock()
        params = parse_qs(parsed.query)
        paging: dict[str, Any] = {}
        if route.paged:
            try:
                paging["page"] = int(params.get("page", ["1"])[0])
            except ValueError:
                paging["page"] = 1
            # Rendered escaped like any cluster string; capped so a
            # hostile URL cannot make the name filter arbitrarily costly.
            paging["query"] = params.get("q", [""])[0][:253]
        if route.windowed:
            # Forwarded only when present, so their absence keeps the
            # legacy rendering byte-identical.
            if "limit" in params:
                try:
                    paging["limit"] = int(params["limit"][0])
                except ValueError:
                    pass
            if "cursor" in params:
                paging["cursor"] = params["cursor"][0][:512]
        if route.kind == "metrics":
            with span("page.data", kind=route.kind):
                metrics, forecast = self._metrics_and_forecast()
        with span("page.component", kind=route.kind):
            if route.kind == "metrics":
                el = route.component(metrics, forecast)
            elif route.kind == "topology":
                # Cache PEEK only: the heatmap must never pay the
                # Prometheus chain.
                el = route.component(snap, metrics=self._peek_metrics())
            elif route.kind == "native-nodes":
                el = route.component(snap, now=now, registry=self._registry, **paging)
            elif route.kind == "viewport":
                # ?region= names the drill-down level, capped like a
                # Kubernetes name; the cursor window applies at slice
                # depth only.
                region = params.get("region", [""])[0][:253]
                el = route.component(snap, now=now, region=region, **paging)
            else:
                el = route.component(snap, now=now, **paging)
        with span("render.html"):
            body = self._page_html(route.name, render_html(el), route_path)
        # The generation's first paint, stamped after its bytes are built;
        # a later paint of the same generation is a no-op.
        self.ledger.paint(self.snapshot_generation(), trace_id=current_trace_id())
        return 200, "text/html", body

    def _debug_page_response(self, route: Any, route_path: str) -> tuple[int, str, str]:
        """A telemetry page, painted from its snapshot alone: it reads no
        cluster snapshot and never syncs, so it paints while the sync is
        what is being debugged."""
        with span("page.component", kind=route.kind):
            if route.kind == "traces":
                el = route.component(trace_ring.snapshot())
            elif route.kind == "slo":
                el = route.component(slo_mod.engine().report())
            elif route.kind == "profile":
                el = route.component(profiler().snapshot())
            else:
                el = route.component(self.ledger.snapshot())
        with span("render.html"):
            body = self._page_html(route.name, render_html(el), route_path)
        return 200, "text/html", body

    def _trends_response(
        self, route: Any, params: dict[str, list[str]], route_path: str
    ) -> tuple[int, str, str]:
        """``/tpu/trends``: a pure function of the history store's view,
        so it reads no snapshot and never syncs. ``?window=`` picks the
        lookback (the store clamps it to [1 s, retention]); ``?metric=``
        switches to the browse mode, windowed by ``?limit=`` and
        ``?cursor=``."""
        try:
            window_s = float(params.get("window", ["3600"])[0])
        except ValueError:
            window_s = 3600.0
        series_limit: int | None = None
        if "limit" in params:
            try:
                series_limit = int(params["limit"][0])
            except ValueError:
                series_limit = None
        cursor = params.get("cursor", [None])[0]
        with span("page.data", kind=route.kind):
            view = self.history.trend_view(
                window_s=window_s,
                metric=params.get("metric", [""])[0][:253],
                series_cursor=cursor[:512] if cursor else None,
                series_limit=series_limit,
            )
        with span("page.component", kind=route.kind):
            el = route.component(view)
        with span("render.html"):
            body = self._page_html(route.name, render_html(el), route_path)
        return 200, "text/html", body

    def _detail_response(self, el: Element, title: str, route_path: str) -> tuple[int, str, str]:
        """A native detail view's response: 404 when the view is the
        not-found page, else 200."""
        status = 404 if el.props.get("data-notfound") else 200
        with span("render.html"):
            body = self._page_html(title, render_html(el), route_path)
        return status, "text/html", body

    def _page_html(self, title: str, body: str, active: str = "") -> str:
        nav = _nav_html(
            tuple((e.url, e.label) for e in self._registry.sidebar_entries if e.parent is not None),
            active,
        )
        refresh = f'<a class="hl-refresh" href="/refresh?back={active or self._home}">Refresh</a>'
        return (
            "<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{title} · TPU Dashboard</title>"
            f"<style>{STYLESHEET}</style></head>"
            f"<body><nav class='hl-nav'>{nav}{refresh}</nav>"
            f"<main>{body}</main></body></html>"
        )

    def _health(self) -> dict[str, Any]:
        """The /healthz body. Never syncs and never waits on the sync
        lock: it reads the last published snapshot. ``ok`` is false after
        ``HEALTH_FAILURE_THRESHOLD`` failing syncs in a row, while the
        background loop's snapshot is older than its wedged limit, while
        the last background warm failed, once a capture of the program
        registry failed, or while the SLO engine's last budget fit
        failed. Ages run on the injected monotonic clock."""
        snap = self._last_snapshot
        failures = self._sync_failures
        ok = (
            failures < self.HEALTH_FAILURE_THRESHOLD
            and not self._warm_failing
            and aot.registry().compile_errors == 0
            and slo_mod.engine().budget_fit_error is None
        )
        background = self._background_live()
        health: dict[str, Any] = {"ok": ok, "loading": snap is None or snap.loading}
        if snap is not None:
            stamp = self._last_snapshot_mono
            age = max(self._mono() - stamp, 0.0) if stamp is not None else 0.0
            interval = self._background_interval
            wedged = background and interval is not None and age > max(
                self.HEALTH_MAX_STALE_INTERVALS * interval, self.HEALTH_MIN_STALE_S
            )
            health.update(
                ok=ok and not wedged,
                errors=snap.errors,
                fetched_at=snap.fetched_at,
                last_sync_age_s=round(age, 3),
                nodes=len(snap.all_nodes or []),
            )
        else:
            health["errors"] = []
        health.update(
            consecutive_sync_failures=failures,
            background_sync=background,
            analytics=self._analytics_health(),
            runtime=self._runtime_health(),
        )
        return health

    def _analytics_health(self) -> dict[str, Any]:
        """The rollup calibration for /healthz: the measured timings,
        whether they are stale, and the backend the policy picks for the
        last snapshot's TPU nodes on this app's device."""
        cal = rollup_stats.calibration
        now = time.monotonic()
        snap = self._last_snapshot
        tpu_nodes = len(snap.provider("tpu").nodes) if snap is not None else 0
        return {
            "calibrated": cal.device_ms is not None,
            "stale": cal.expired(now),
            "age_s": round(now - cal.calibrated_at, 1) if cal.calibrated_at is not None else None,
            "backend": cal.backend,
            "device_ms": round(cal.device_ms, 4) if cal.device_ms is not None else None,
            "python_ms_per_node": (
                round(cal.python_ms_per_node, 6) if cal.python_ms_per_node is not None else None
            ),
            "floor_nodes": rollup_stats.DEVICE_ROLLUP_MIN_NODES,
            "tpu_nodes": tpu_nodes,
            "chosen_backend": rollup_stats.chosen_backend(tpu_nodes, self._device),
        }

    def _runtime_health(self) -> dict[str, Any]:
        """The /healthz runtime block: device-to-host copies paid, the
        device-resident fleet columns, the warm carries, both
        refreshers, the graph cost ledger and the program registry, the
        context's watch counters, the background loop, the history
        store, the SLO states with the last budget fit's error, the
        profiler's counters, and the device with its kernel."""
        with self._lock:
            background = {
                **self._background_counters,
                "interval_s": self._background_interval,
                "last_warm_error": self._last_warm_error,
                "last_sync_error": self._last_sync_error,
            }
        engine, prof = slo_mod.engine(), profiler()
        overhead = prof.overhead_ns_per_sample()
        return {
            "transfer": transfer_stats.snapshot(),
            "fleet_cache": self._ctx.fleet_cache.snapshot(),
            "watch": {track: dict(c) for track, c in self._ctx.watch_stats.items()},
            "background": background,
            "history": self.history.snapshot(),
            "warm_carries": {
                **self._warm_forecast_states.counters(),
                "entries": len(self._warm_forecast_states),
            },
            "refresh": {
                r.name: r.snapshot() for r in (self._metrics_refresher, self._forecast_refresher)
            },
            "graphs": graphcost.ledger().snapshot(),
            "aot": aot.registry().snapshot(),
            "slo": {
                "states": engine.health_block(),
                "budget_fit_error": engine.budget_fit_error,
            },
            "profiler": {
                **prof.counters(),
                "nodes": prof.node_count(),
                "running": prof.running(),
                "overhead_ns_per_sample": None if overhead is None else round(overhead, 1),
            },
            "device": self._device_health(),
        }

    def _device_health(self) -> dict[str, Any]:
        """Where the forecast runs: the torch device, the card's name (on
        a card), the inference path, the kernel's launches in this
        process and how its library was obtained (None before the first
        launch)."""
        dev = self._device
        info = kernel_build_info()
        out: dict[str, Any] = {"torch_device": str(dev)}
        if dev.type == "cuda":
            out["name"] = torch.cuda.get_device_name(dev)
        out.update(
            kernel="forecast_mlp_forward",
            kernel_path="cuda" if dev.type == "cuda" else "torch",
            launches=LAUNCHES.n,
            build=None if info is None else {
                "cache_hit": info.cache_hit, "seconds": round(info.seconds, 3),
            },
        )
        return out

    # ------------------------------------------------------------------
    # Lifetime
    # ------------------------------------------------------------------

    def serve(self, host: str = "127.0.0.1", port: int = 8632) -> DashboardServer:
        """Serve this app on ``(host, port)``; see :func:`serve`."""
        return serve(self, host, port)

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop the background loop and join its thread, wait for every
        refit in flight (the SLO engine's budget fit too) and join its
        thread, join the context's reactive worker, then drop the
        process's warm carries and the snapshot's device columns and wait
        for the card's queued work, so nothing this app started is still
        running (the loop is joined first, so a late warm cannot
        republish columns after the drop). Raises TimeoutError if a
        thread outlives ``timeout_s``."""
        with self._bg_lock:
            stop = self._background_stop
            threads = list(self._background_threads)
        if stop is not None:
            stop.set()
        for thread in threads:
            thread.join(timeout_s)
            if thread.is_alive():
                raise TimeoutError(f"the background sync outlived {timeout_s} s")
        for r in (self._metrics_refresher, self._forecast_refresher):
            if not r.drain(timeout_s):
                raise TimeoutError(f"the {r.name} refresher's refits outlived {timeout_s} s")
        # A /sloz read may have started the engine's budget fit.
        if not slo_mod.engine().drain(timeout_s):
            raise TimeoutError(f"the SLO budget fit outlived {timeout_s} s")
        self._ctx.close()
        self._warm_forecast_states.invalidate()
        self._ctx.fleet_cache.invalidate()
        self._ctx.rollup_results.invalidate()
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)


class DashboardServer:
    """A :class:`DashboardApp` serving on a socket, from a thread of its
    own; :func:`serve` starts one."""

    def __init__(self, app: DashboardApp, httpd: ThreadingHTTPServer) -> None:
        self.app = app
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever, name="hl-torch-serve", daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def wait(self) -> None:
        """Block until the server stops (for a process that only serves)."""
        self._thread.join()

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop accepting, close the socket, join the request threads,
        release the sampling profiler (its thread stops and is joined
        with the last server's close), then close the app: its refits
        and the SLO budget fit drained, the warm carries and device
        columns dropped and no CUDA work left in flight."""
        self._httpd.shutdown()
        self._thread.join()
        # ThreadingHTTPServer blocks on close: server_close joins every
        # request thread it started.
        self._httpd.server_close()
        if not profiler().stop(timeout_s):
            raise TimeoutError(f"the sampling profiler outlived {timeout_s} s")
        # The registry's captures serve() started (or a backfill): the
        # graphs stay in the process registry, the threads end here.
        if not aot.registry().join(timeout_s):
            raise TimeoutError(f"the program registry's captures outlived {timeout_s} s")
        self.app.close(timeout_s)


def serve(app: DashboardApp, host: str = "127.0.0.1", port: int = 8632) -> DashboardServer:
    """Bind ``(host, port)`` (port 0 picks a free one) and serve ``app``
    on a ``ThreadingHTTPServer``, one thread per request; start the
    process's program registry capturing its startup set on the app's
    device on a background thread (`app.py:1745-1755` of the JAX host;
    a no-op once started), and the sampling profiler's thread
    (`app.py:1741`). Requests that arrive before the registry is ready
    run their programs eagerly. Building an app never starts either.
    Returns the running server; its ``close()`` stops everything it
    started."""
    aot.registry().compile_startup(app.device)
    profiler().start()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self) -> None:  # noqa: N802 (http.server API)
            status, content_type, body = app.handle(self.path, self.headers.get("Accept"))
            if status == 302:
                self.send_response(302)
                self.send_header("Location", content_type)
                self.end_headers()
                return
            data = body.encode()
            self.send_response(status)
            self.send_header("Content-Type", f"{content_type}; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args: Any) -> None:
            pass

    return DashboardServer(app, ThreadingHTTPServer((host, port), Handler))

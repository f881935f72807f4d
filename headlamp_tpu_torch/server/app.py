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
- ``GET /events``             Server-Sent Events: a patch frame per changed
  page (``?pages=``, default the four diffable pages) or per changed
  drill-down region (``?region=cluster/<c>[/slice/<s>]``) on every sync
  that bumps the generation, ``Last-Event-ID`` resume, heartbeats, and
  ``?class=debug`` for a stream that is shed first; it bypasses the
  gateway and holds no render worker;
- ``GET /replicate/bus``      on a replication leader (``app.replication``
  a ``replicate.BusPublisher``), the bus records newer than the
  ``Last-Generation: g<N>`` cursor, as JSONL; it bypasses the gateway;
- ``GET /healthz``            liveness and the runtime counters, as JSON;
- ``GET /metricsz``           Prometheus text self-exposition, or
  OpenMetrics with exemplars when the Accept header asks for it;
- ``GET /sloz``               the SLO engine's report (burn rates, budgets,
  exemplars, the budget self-forecast fit on the app's device), as JSON;
- ``GET /debug/traces``, ``/debug/flightz``, ``/debug/generationz``,
  ``/debug/incidentz``, ``/debug/profilez`` (``?burst=SECONDS``) and
  ``/debug/profilez/folded`` the trace ring, the flight recorder, the
  generation ledger, the incident timeline and the sampling profiler;
  ``/debug/traces/html``, ``/sloz/html``, ``/debug/profilez/html``,
  ``/debug/generationz/html`` and ``/debug/incidentz/html`` are their
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

Over the socket every GET goes through the app's request gateway
(:meth:`DashboardApp.ensure_gateway`, ``gateway/``) before it reaches
:meth:`DashboardApp.handle`: renders run on a bounded pool of workers
pinned to the app's card, identical concurrent page requests share one
render, a request whose ``If-None-Match`` holds the page's current ETag
is a 304 without a render, and while a request-backed objective pages
the debug surfaces answer 503 and the governed pages render from caches
only (``X-Headlamp-Stale: 1``, no fit for a cold key). ``/healthz``
bypasses the gateway. Bodies are gzipped when the client accepts it,
keyed by the ETag. With a pooled transport (:class:`KubeTransport`)
``/healthz`` carries the connection pool's counters.

Every sync that bumps the snapshot generation hands the snapshot, with
peeks of the cached metrics and forecast (never a fetch or a fit), to the
app's push pipeline (``push/``): the differ builds page models, diffs
them against the previous generation's, evicts the changed keys from the
fragment cache and fans the frames out to the ``/events`` subscribers.
Snapshot pages paint through that fragment cache (``ui/fragment.py``):
each keyed, salted boundary whose bytes are cached for the paint's
epoch and degraded flag is spliced, not re-rendered, and the bytes equal
a plain paint's. ``fragments=False`` turns the cache off.

With ``app.replication`` set to a ``replicate.BusPublisher`` the host
leads a read tier: every sync that bumps the generation, after the push
differ, hands the same snapshot and peeks to the publisher (its own
``replicate.publish`` span), and ``/replicate/bus`` serves the records. A
``replicate.ReplicaApp`` is this host fed by those records instead of a
cluster. An inbound ``traceparent`` header links a request's trace to the
caller's trace in another process (``remote_parent``).

Each app keeps an incident timeline (``obs/timeline.py``): the gateway's
shed policy and the push hub report their rulings and evictions to it,
the scenario engine (``scenarios/``) marks its injections and phases on
it, and the generation ledger's leadership transitions are merged into
it; ``/healthz`` carries ``runtime.scenarios`` only while a drill runs.
On a worker process (``workers/``) ``/healthz`` carries the shared status
board as ``runtime.workers``. The host serves both providers, as JAX's
does: the five Intel GPU pages under ``/intel`` (``/intel/metrics``
fetches the i915 power series from Prometheus on each paint), the Intel
columns on ``/nodes`` and the Intel sections on the node and pod views.
"""

from __future__ import annotations

import contextlib
import html
import json
import re
import socket
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
from ..gateway import RenderGateway, degraded_active, set_active
from ..history import HistoryStore, set_active_store
from ..metrics.client import TpuMetricsSnapshot, fetch_tpu_metrics
from ..metrics.intel_client import fetch_intel_gpu_metrics
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
from ..obs.propagate import parse_traceparent
from ..obs.timeline import IncidentTimeline
from ..obs.trace import annotate, current_trace_id, span, trace_request, trace_ring
from ..pages.native import native_node_page, native_pod_page
from ..push import PAGES as PUSH_PAGES
from ..push import (
    REGION_PAGE_PREFIX,
    PushPipeline,
    Subscription,
    format_event,
    set_active_push,
    worker_identity,
)
from ..push.hub import parse_last_event_id
from ..push.conditional import encode_body
from ..registration import Registry, register_plugin
from ..runtime.device_cache import warm_carries
from ..runtime.refresh import Refresher
from ..runtime.transfer import TransferBatch, transfer_stats
from ..transport.api_proxy import Transport
from ..transport.pool import pool_of
from ..ui import Element, FragmentCache, FragmentPaint, render_html, set_active_fragments
from ..viewport import parse_region, region_path
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
    "/debug/incidentz",
    "/events",
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
        "/debug/incidentz",
        "/debug/incidentz/html",
    }
)

#: Route kinds painted from a telemetry snapshot, never a cluster one.
_DEBUG_KINDS = ("traces", "slo", "profile", "generations", "incidents")


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
    interval, so tests advance a list cell instead of sleeping.
    ``fragments=False`` paints without the fragment cache: the plain
    oracle its paints are held byte-equal to."""

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
        pod_field_selector: str | None = None,
        fragments: bool = True,
    ) -> None:
        self._device = resolve_device(device)
        self._transport = transport
        self._registry = registry if registry is not None else register_plugin()
        self._clock = clock
        self._mono = monotonic
        #: The cluster snapshot every page reads; it owns the snapshot's
        #: device-resident fleet columns (``self._ctx.fleet_cache``).
        #: ``pod_field_selector`` filters the pod list at the apiserver.
        self._ctx = AcceleratorDataContext(
            transport, device=self._device, clock=clock, pod_field_selector=pod_field_selector
        )
        #: The request gateway the socket server routes through, built on
        #: first use (:meth:`ensure_gateway`); None for a direct caller.
        self.gateway: RenderGateway | None = None
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
        #: Scenario marks, SLO flips, gateway rulings, hub evictions and
        #: the ledger's leadership transitions as one ordered log, served
        #: at /debug/incidentz. Idle, it costs nothing.
        self.incidents = IncidentTimeline(monotonic=monotonic, wall=clock)
        self.incidents.ledger = self.ledger
        #: Rendered HTML per differ key, per app (two fleets never share
        #: bytes). ``fragments=False`` turns it off: the non-incremental
        #: oracle the byte-identity checks compare against.
        self.fragments: FragmentCache | None = None
        if fragments:
            self.fragments = FragmentCache()
            set_active_fragments(self.fragments)
        #: The snapshot differ and the SSE hub. Building it starts no
        #: thread: /events handler threads belong to the socket server,
        #: and the differ runs on whichever thread syncs. The module-level
        #: active pipeline only feeds the connected-clients gauge.
        self.push = PushPipeline(monotonic=monotonic, fragments=self.fragments, ledger=self.ledger)
        self.push.hub.eviction_observers.append(self.incidents.eviction_observer)
        set_active_push(self.push)
        #: The read tier's hook: on a leader a ``replicate.BusPublisher``
        #: (every generation the sync publishes goes to it, and
        #: /replicate/bus serves it), on a replica its ``BusConsumer``.
        #: None serves alone.
        self.replication: Any = None
        #: On a worker process (``workers/worker.py``): the shared status
        #: board's view, stamped with which worker answered, for /healthz
        #: ``runtime.workers``. None everywhere else.
        self.workers: Any = None
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
        raise out of ``sync()``; they degrade into the error streams).
        Then, with that bookkeeping done, the snapshot goes to the push
        pipeline: a generation bump diffs its page models and broadcasts
        the frames; a clean tick (the same generation) is skipped. The
        metrics and forecast it diffs are peeks, never a fetch or a fit,
        so the sync heartbeat grows no Prometheus probe chain. A differ
        that raises is counted and named in /healthz ``runtime.push``.
        On a replication leader the publisher gets the same snapshot and
        peeks last; a publish that raises is counted and named in
        /healthz ``runtime.replication``."""
        generation = 0
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
        else:
            self._sync_failures += 1
            self._last_sync_error = (
                f"{type(error).__name__}: {error}" if error is not None else snap.error
            )
            self._sync_fail_total.inc()
        if snap is not None:
            # Its own span, so a background tick's trace (last_tick_trace)
            # and an inline sync's request trace show the differ's share.
            with span("push.diff", generation=generation):
                self.push.on_snapshot(
                    snap, generation=generation,
                    metrics=self._peek_metrics, forecast=self._peek_forecast,
                )
            if self.replication is not None:
                # Its own span: a tick's trace shows the encode's share.
                with span("replicate.publish", generation=generation):
                    self.replication.on_snapshot(
                        snap, generation=generation,
                        metrics=self._peek_metrics, forecast=self._peek_forecast,
                    )

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
            if degraded_active() and self._last_snapshot is not None:
                # A gateway-degraded render paints the last published
                # snapshot and never syncs behind the overload; only the
                # first request of the app's life still needs one.
                annotate(source="degraded-stale")
                return self._last_snapshot
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
        mid-fetch leaves the entry born stale. A gateway-degraded render
        only peeks: a cold cache paints the no-data state."""
        r = self._metrics_refresher
        # Re-read per call: the class attributes are operator and test knobs.
        r.ttl_s = self.METRICS_TTL_S
        r.grace_s = max(self.METRICS_GRACE_S, self.METRICS_TTL_S)
        if degraded_active():
            return r.peek("metrics", epoch=self._cache_epoch)
        return r.get(
            "metrics",
            lambda: fetch_tpu_metrics(self._transport, clock=self._clock),
            epoch=self._cache_epoch,
        )

    def _forecast_for(self, metrics: TpuMetricsSnapshot | None) -> ForecastView | None:
        """Forecast view for the metrics page, or None when there are no
        chips or no usable history. A fit that raises propagates: the
        page answers 500 naming it, and never drops the forecast panel
        in silence. A gateway-degraded render only peeks: a cold key
        paints the page without the forecast panel and launches nothing,
        and no background refit starts."""
        if metrics is None or not metrics.chips:
            return None
        r = self._forecast_refresher
        r.ttl_s = self.FORECAST_TTL_S
        r.grace_s = max(self.FORECAST_GRACE_S, self.FORECAST_TTL_S)
        if degraded_active():
            return r.peek(self._metrics_key(metrics), epoch=self._cache_epoch)
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

    def _peek_forecast(self) -> ForecastView | None:
        """The cached forecast for the metrics peek's chip set, or None:
        never fetches and never fits (``Refresher.peek`` reads the entry
        map only). For the push differ: the metrics page model diffs the
        forecast a recent metrics view already paid for, and a cold cache
        diffs the page without its forecast rows."""
        metrics = self._peek_metrics()
        if metrics is None or not metrics.chips:
            return None
        return self._forecast_refresher.peek(self._metrics_key(metrics), epoch=self._cache_epoch)

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

    def handle(
        self,
        path: str,
        accept: str | None = None,
        *,
        gateway_info: dict[str, Any] | None = None,
        traceparent: str | None = None,
    ) -> tuple[int, str, str]:
        """(status, content_type, body) for a GET; for a 302 the content
        type slot holds the Location. ``accept`` is the Accept header;
        only /metricsz reads it. ``gateway_info`` is the gateway's
        admission story (priority class, queue wait, degraded flag),
        recorded as the trace's ``gateway.admission`` span and the wide
        event's ``gateway`` block. ``traceparent`` is the inbound header:
        the caller's trace in another process becomes this trace's
        ``remote_parent`` (this process still mints its own id). Never
        raises: an exception becomes a 500 page that names it.

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
        remote = parse_traceparent(traceparent)
        with trace_request(
            path, enabled=recorded, wall=self._clock,
            remote_parent=remote.trace_id if remote is not None else None,
        ) as trace, attribution(route_label):
            try:
                if gateway_info:
                    # A zero-length marker: the wait already happened
                    # before this worker ran; its attributes tell it.
                    with span("gateway.admission", **gateway_info):
                        pass
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
                            gateway=gateway_info,
                            replication=self._replication_info(),
                        ),
                        pinned=bool(violations) or status >= 500,
                    )

    def _replication_info(self) -> dict[str, Any] | None:
        """The wide event's replication block: role, applied generation
        and bus cursor (the triage keys of ``runtime.replication``), or
        None when the host serves alone."""
        replication = self.replication
        if replication is None:
            return None
        block = replication.snapshot()
        return {
            k: block[k] for k in ("role", "cursor", "last_generation", "applied") if k in block
        }

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
        if self.gateway is not None:
            blocks.append(("gateway", self.gateway.counters()))
        pool = pool_of(self._transport)
        if pool is not None:
            blocks.append(("transport", pool.counters()))
        blocks.append(("push", self.push.counters()))
        if self.replication is not None:
            blocks.append(("replicate", self.replication.counters()))
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
        if route_path == "/debug/incidentz":
            return 200, "application/json", json.dumps(self.incidents.snapshot())
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
        elif route.kind == "intel-metrics":
            # Fetched on every paint, as in JAX: the Intel page keeps no
            # metrics cache.
            with span("page.data", kind=route.kind):
                intel_metrics = fetch_intel_gpu_metrics(self._transport, clock=self._clock)
        paint = self._fragment_paint(route_path)
        with span("page.component", kind=route.kind):
            if route.kind == "metrics":
                el = route.component(metrics, forecast)
            elif route.kind == "intel-metrics":
                el = route.component(intel_metrics)
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
            if paint is not None:
                # Every stale boundary renders into the cache here, so this
                # span keeps covering all the tree's construction work.
                paint.prerender(el)
        inner: str | None = None
        if paint is not None:
            # Cached-byte assembly bills to its own stage: a warm paint
            # spends next to nothing here, and a paint where it dominates
            # has a salt that churns per request.
            with span("fragment.splice", rendered=paint.rendered, spliced=paint.spliced):
                inner = paint.splice(el)
        with span("render.html"):
            if inner is None:
                inner = render_html(el)
            body = self._page_html(route.name, inner, route_path)
        # The generation's first paint, stamped after its bytes are built;
        # a later paint of the same generation is a no-op.
        self.ledger.paint(self.snapshot_generation(), trace_id=current_trace_id())
        return 200, "text/html", body

    def _fragment_paint(self, page: str) -> FragmentPaint | None:
        """The paint-scoped fragment context for ``page`` (None with the
        cache off): the cache and the invariants its entries key on, the
        /refresh epoch and the degraded flag."""
        if self.fragments is None:
            return None
        return FragmentPaint(
            self.fragments, page=page, epoch=self._cache_epoch, degraded=degraded_active(),
        )

    def _debug_page_response(self, route: Any, route_path: str) -> tuple[int, str, str]:
        """A telemetry page, painted from its snapshot alone: it reads no
        cluster snapshot and never syncs, so it paints while the sync is
        what is being debugged."""
        snapshots: dict[str, Callable[[], Any]] = {
            "traces": trace_ring.snapshot,
            "slo": lambda: slo_mod.engine().report(),
            "profile": lambda: profiler().snapshot(),
            "generations": self.ledger.snapshot,
            "incidents": self.incidents.snapshot,
        }
        with span("page.component", kind=route.kind):
            el = route.component(snapshots[route.kind]())
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
        registry failed, while the SLO engine's last budget fit failed,
        while the push differ's last generation failed, or while the last
        replication publish (leader) or apply (replica) failed. Ages run
        on the injected monotonic clock."""
        snap = self._last_snapshot
        failures = self._sync_failures
        ok = (
            failures < self.HEALTH_FAILURE_THRESHOLD
            and not self._warm_failing
            and aot.registry().compile_errors == 0
            and slo_mod.engine().budget_fit_error is None
            and not self.push.failing
            and not (self.replication is not None and self.replication.failing)
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
        profiler's counters, the push pipeline (its differ and SSE hub),
        and the device with its kernel; with the fragment cache on its
        entries, bytes and hit rate, with replication the leader's
        publisher or the replica's (or worker's) consumer, on a worker
        process the shared status board, during a drill the incident
        timeline's drill, with a gateway its admission counters and
        queues, with a pooled transport its connection pool."""
        with self._lock:
            background = {
                **self._background_counters,
                "interval_s": self._background_interval,
                "last_warm_error": self._last_warm_error,
                "last_sync_error": self._last_sync_error,
            }
        engine, prof = slo_mod.engine(), profiler()
        overhead = prof.overhead_ns_per_sample()
        out: dict[str, Any] = {
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
            "push": self.push.snapshot(),
            "device": self._device_health(),
        }
        if self.fragments is not None:
            out["render"] = self.fragments.snapshot()
        if self.replication is not None:
            out["replication"] = self.replication.snapshot()
        if self.workers is not None:
            # Every worker's slot off the shared board: triage must not
            # depend on which process the kernel handed the socket to.
            out["workers"] = self.workers.snapshot()
        drill = self.incidents.health_block()
        if drill is not None:
            # Present only during a drill: a probe reader must know the
            # faults it sees are rehearsed.
            out["scenarios"] = drill
        if self.gateway is not None:
            out["gateway"] = self.gateway.snapshot()
        pool = pool_of(self._transport)
        if pool is not None:
            out["transport"] = pool.snapshot()
        return out

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
            # This process's caching allocator: a worker process's share
            # of the card (its CUDA context's own overhead not included).
            out["memory_allocated_bytes"] = torch.cuda.memory_allocated(dev)
            out["memory_reserved_bytes"] = torch.cuda.memory_reserved(dev)
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

    def ensure_gateway(self, **overrides: Any) -> RenderGateway:
        """The app's request gateway, built on first use (``overrides`` go
        to :class:`RenderGateway`: workers, queue depths, timeouts, the
        SLO engine). :func:`serve` calls it, so the socket path always
        goes through it; a direct :meth:`handle` call stays the seam of
        the tests and the CLI. Each render worker runs on the app's card:
        the current device is per thread."""
        if self.gateway is None:
            index = self._cuda_index
            self.gateway = RenderGateway(
                self.handle,
                route_label=self._route_label,
                generation=self.snapshot_generation,
                epoch=lambda: self._cache_epoch,
                monotonic=self._mono,
                worker_context=(
                    (lambda: torch.cuda.device(index)) if index is not None
                    else contextlib.nullcontext
                ),
                **overrides,
            )
            set_active(self.gateway)
            # Its snapshot gains the SSE connection count, and the hub
            # sheds debug-class streams off the gateway's paging policy.
            self.gateway.attach_push(self.push)
            # Its shed, degrade, paging and restore rulings land on the
            # incident timeline.
            self.gateway.shed_policy.observers.append(self.incidents.gateway_observer)
        return self.gateway

    def open_event_stream(self, path: str, *, last_event_id: str | None = None) -> Subscription:
        """Admit one ``/events`` subscription: the accounting half of the
        endpoint, apart from the socket loop, so tests drive the protocol
        without sockets. ``?region=`` (canonicalized through the viewport
        parser) subscribes to that drill-down region's frames only; an
        unparseable region falls back to the full page set. Otherwise
        ``?pages=`` is a comma-separated list (unknown pages dropped,
        none left means all). ``?class=debug`` puts the stream in the
        class shed first under a paging burn.

        The stream counts once in requests_total at admission (status 200)
        and never in the latency histogram: a connection's lifetime is
        not a paint latency."""
        query = parse_qs(urlparse(path).query)
        region = query.get("region", [""])[0][:253]
        if region:
            parsed_region = parse_region(region)
            if parsed_region is not None:
                pages = [REGION_PAGE_PREFIX + region_path(*parsed_region)]
            else:
                pages = list(PUSH_PAGES)
        else:
            requested = [p for p in query.get("pages", [""])[0].split(",") if p]
            pages = [p for p in requested if p in PUSH_PAGES] or list(PUSH_PAGES)
        priority = "debug" if query.get("class", [""])[0] == "debug" else "interactive"
        self._req_total.inc(route="/events", status="200")
        return self.push.hub.subscribe(pages, last_event_id=last_event_id, priority=priority)

    def serve(
        self, host: str = "127.0.0.1", port: int = 8632, *, reuse_port: bool = False,
        listen_socket: socket.socket | None = None,
    ) -> DashboardServer:
        """Serve this app on ``(host, port)``; see :func:`serve`."""
        return serve(self, host, port, reuse_port=reuse_port, listen_socket=listen_socket)

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop the gateway and join its render workers, stop the
        background loop and join its thread, wait for every refit in
        flight (the SLO engine's budget fit too) and join its thread,
        join the context's reactive worker, then drop the process's warm
        carries and the snapshot's device columns and wait for the work
        queued on the card's default stream, the stream its threads use,
        so nothing this app started is still running (the
        loop is joined first, so a late warm cannot republish columns
        after the drop). Every ``/events`` subscription is evicted first
        (each gets ``bye``). Raises TimeoutError if a thread outlives
        ``timeout_s``."""
        self.push.close()
        gateway = self.gateway
        if gateway is not None:
            if not gateway.close(timeout_s):
                raise TimeoutError(f"the gateway's render workers outlived {timeout_s} s")
            set_active(None)
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
            # The app's threads queue their work on the card's default
            # stream. A device-wide synchronize would also meet a capture
            # in progress on another thread (the process registry's
            # startup capture, on a side stream), which CUDA refuses.
            torch.cuda.default_stream(self._device).synchronize()


class DashboardServer:
    """A :class:`DashboardApp` serving on a socket, from the accept thread
    :func:`serve` started."""

    def __init__(
        self, app: DashboardApp, httpd: ThreadingHTTPServer, thread: threading.Thread
    ) -> None:
        self.app = app
        self._httpd = httpd
        self._thread = thread

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def wait(self) -> None:
        """Block until the server stops (for a process that only serves)."""
        self._thread.join()

    def close(self, timeout_s: float = 30.0) -> None:
        """Evict every ``/events`` stream (each parked handler wakes,
        writes ``bye`` and ends), stop accepting, close the socket, join
        the request threads, release the sampling profiler (its thread
        stops and is joined with the last server's close), then close the
        app: its refits and the SLO budget fit drained, the warm carries
        and device columns dropped and no CUDA work left in flight."""
        self.app.push.close()
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


class _ReusePortServer(ThreadingHTTPServer):
    """Binds with ``SO_REUSEPORT``: several worker processes bind one
    address and the kernel spreads the accepts."""

    def server_bind(self) -> None:
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()


def serve(
    app: DashboardApp, host: str = "127.0.0.1", port: int = 8632, *, reuse_port: bool = False,
    listen_socket: socket.socket | None = None,
) -> DashboardServer:
    """Bind ``(host, port)`` (port 0 picks a free one) and serve ``app``
    on a ``ThreadingHTTPServer``. For multi-process serving
    (`app.py:1720-1760`, `:1895-1915` of the JAX host) ``reuse_port``
    binds with ``SO_REUSEPORT`` and ``listen_socket`` adopts a listener
    already bound and listening (a supervisor's, handed to its worker);
    the default is a plain bind. Each request thread hands its GET to
    the app's gateway (:meth:`DashboardApp.ensure_gateway`, `app.py:1757-1810`
    of the JAX host) and waits; a 304 goes out without a body, a 200 is
    gzipped when the client accepts it. ``/events`` never reaches the
    gateway: its thread subscribes to the push hub and writes each event
    as it comes (`app.py:1858-1892`) until a ``bye`` or the client
    leaves. ``/replicate/bus`` never reaches it either: a leader's backlog
    copy is answered on the request thread (`app.py:1819-1852`), a host
    without a publisher answers 404. Start the process's program registry
    capturing its startup
    set on the app's device on a background thread (`app.py:1745-1755`;
    a no-op once started), and the sampling profiler's thread
    (`app.py:1741`). Requests that arrive
    before the registry is ready run their programs eagerly. Building an
    app never starts either. Returns the running server; its ``close()``
    stops everything it started; a bind that fails starts nothing."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self) -> None:  # noqa: N802 (http.server API)
            if urlparse(self.path).path.rstrip("/") == "/events":
                # Parked on this handler thread in the hub's condition
                # wait, never on a render worker: a wall of idle
                # dashboards must not hold render capacity.
                self._serve_events()
                return
            if urlparse(self.path).path.rstrip("/") == "/replicate/bus":
                # A backlog copy, microseconds: replica pulls never queue
                # behind renders.
                self._serve_bus()
                return
            response = gateway.handle(
                self.path,
                accept=self.headers.get("Accept"),
                if_none_match=self.headers.get("If-None-Match"),
                traceparent=self.headers.get("traceparent"),
            )
            status, content_type, body = response[:3]
            if status == 302:
                self.send_response(302)
                self.send_header("Location", content_type)
                self.end_headers()
                return
            if status == 304:
                # RFC 7232: no body and no Content-Type, only the
                # validators the gateway stamped.
                self.send_response(304)
                for name, value in response.headers:
                    self.send_header(name, value)
                self.end_headers()
                return
            data = body.encode()
            encoding = None
            if status == 200:
                # The strong ETag keys the gzip output cache.
                etag = next((v for n, v in response.headers if n.lower() == "etag"), None)
                data, encoding = encode_body(
                    data, self.headers.get("Accept-Encoding"), etag=etag
                )
            self.send_response(status)
            self.send_header("Content-Type", f"{content_type}; charset=utf-8")
            if status == 200:
                # The representation varies by negotiation even when this
                # response went out as identity.
                self.send_header("Vary", "Accept-Encoding")
            if encoding is not None:
                self.send_header("Content-Encoding", encoding)
            self.send_header("Content-Length", str(len(data)))
            for name, value in response.headers:
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(data)

        def _serve_bus(self) -> None:
            replication = app.replication
            if replication is None or not hasattr(replication, "payload_after"):
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            cursor = parse_last_event_id(self.headers.get("Last-Generation"))
            # The polling replica's traceparent names its poll trace; this
            # serve joins it. Ringed only when records shipped: a 1 Hz
            # stream of empty polls would rotate every page trace out.
            remote = parse_traceparent(self.headers.get("traceparent"))
            with trace_request(
                "/replicate/bus", wall=app._clock,
                remote_parent=remote.trace_id if remote is not None else None,
            ) as trace:
                with span("replicate.serve", cursor=cursor or 0):
                    payload = replication.payload_after(cursor).encode()
                if trace is not None and payload.count(b"\n") > 1:
                    trace.finish(route="/replicate/bus", status=200, device_gets=0)
                    trace_ring.record(trace.to_dict())
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("X-Headlamp-Generation", str(replication.last_generation))
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _serve_events(self) -> None:
            sub = app.open_event_stream(self.path, last_event_id=self.headers.get("Last-Event-ID"))
            hub = app.push.hub
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("X-Headlamp-Generation", str(app.snapshot_generation()))
                # Which worker process the stream is pinned to, when the
                # host runs several.
                worker = worker_identity()
                if worker is not None:
                    self.send_header("X-Headlamp-Worker", worker)
                self.end_headers()
                while True:
                    event = hub.next_event(sub)
                    if event is None:
                        return
                    self.wfile.write(format_event(event).encode())
                    self.wfile.flush()
                    if event.get("kind") == "bye":
                        return
            except OSError:
                # The client went away mid-stream: the normal end of an
                # SSE connection. A hub eviction was counted already.
                pass
            finally:
                hub.unsubscribe(sub)

        def log_message(self, *args: Any) -> None:
            pass

    if listen_socket is not None:
        httpd = ThreadingHTTPServer((host, port), Handler, bind_and_activate=False)
        httpd.socket.close()
        httpd.socket = listen_socket
        httpd.server_address = listen_socket.getsockname()[:2]
    elif reuse_port:
        httpd = _ReusePortServer((host, port), Handler)
    else:
        httpd = ThreadingHTTPServer((host, port), Handler)
    # Bound: start what the server's close() stops. No request is read
    # before DashboardServer starts the accept loop.
    gateway = app.ensure_gateway()
    aot.registry().compile_startup(app.device)
    profiler().start()
    thread = threading.Thread(target=httpd.serve_forever, name="hl-torch-serve", daemon=True)
    thread.start()
    return DashboardServer(app, httpd, thread)

"""AcceleratorDataContext — single source of truth for cluster state.

The port's copy of ``headlamp_tpu/context/accelerator_context.py``, with
one provider:

- **Reactive track**: node + all-namespace pod lists (the ``useList``
  analogue, `IntelGpuDataContext.tsx:98-99`). Fetched paginated on the
  first sync; with watch enabled (``enable_watch``, turned on by the
  server's background sync) later syncs poll a bounded
  ``watch=true&resourceVersion=`` delta stream and apply
  ADDED/MODIFIED/DELETED events to per-track object stores, re-listing
  only on 410 Gone or a failed watch. The node track runs on one
  persistent worker thread while the calling thread runs the pod track.
  A failure leaves the previous list in place and records the error
  stream.
- **Imperative track**: per-provider workload objects (DaemonSets) and
  plugin daemon pods via fallback chains with per-request timeouts,
  silent per-path failure, and UID dedup (`:113-190`). Workload-source
  absence degrades to ``workload_available=False`` instead of erroring.
- ``refresh()`` re-runs the imperative track only, mirroring the
  reference's ``refreshKey`` effect (`:109-111,190`); ``sync()`` runs
  both tracks.

Derived per-provider views are computed once per sync, not per page
render. Each snapshot's views carry a monotone ``version``, the key of
the device-resident fleet columns (``runtime.device_cache``). A clean
tick (a quiet watch, unchanged imperative results, stable error
streams) keeps the snapshot and its version, so the columns stay on the
device.
"""

from __future__ import annotations

import concurrent.futures
import time
import urllib.parse
from dataclasses import dataclass, replace
from typing import Any, Callable, Mapping

from ..device import DeviceLike, resolve_device
from ..domain import objects as obj
from ..domain.accelerator import PROVIDERS, FleetView, Provider, classify_fleet
from ..obs.trace import span
from ..runtime.device_cache import DeviceFleetCache, RollupResultCache
from ..transport.api_proxy import DEFAULT_TIMEOUT_S, ApiError, Transport
from ..transport.pool import fanout, pool_of
from .sources import (
    NODES_PATH,
    PODS_PATH,
    ProviderSource,
    default_sources,
    workload_matches_provider,
)


class _WatchExpired(Exception):
    """The watch cursor predates the apiserver's retained window (410
    Gone, as an HTTP status or an ERROR event): the protocol's signal to
    resync with a full re-list."""


@dataclass
class ProviderState:
    """One provider's slice of the snapshot — the per-provider
    generalization of ``IntelGpuContextValue``
    (`IntelGpuDataContext.tsx:28-52`)."""

    provider: Provider
    view: FleetView
    #: Workload objects (TPU: DaemonSets).
    workloads: list[Any]
    #: False when every workload path failed — the ``crdAvailable``
    #: analogue (`:133-137`); pages show a "not available" notice.
    workload_available: bool = True
    #: Set when every plugin-pod selector path failed for this provider.
    #: Kept per provider (not in the global error banner) so an absent
    #: provider degrades independently.
    plugin_pods_error: str | None = None
    #: Where the fleet rollup runs, the context's device-resident
    #: columns (None: encode and upload on every call) and the rollups
    #: the fused rollup+forecast parked for its snapshots.
    device: DeviceLike = None
    fleet_cache: DeviceFleetCache | None = None
    rollup_results: RollupResultCache | None = None
    #: Lazily computed dashboard aggregates (see analytics.stats).
    _stats: Mapping[str, Any] | None = None

    @property
    def nodes(self) -> list[Any]:
        return self.view.nodes

    @property
    def pods(self) -> list[Any]:
        return self.view.pods

    @property
    def plugin_pods(self) -> list[Any]:
        return self.view.plugin_pods

    @property
    def plugin_installed(self) -> bool:
        """Workloads seen OR daemon pods seen OR devices advertised
        (`:222` generalized; the device-advertised arm covers TPU's
        no-CRD world)."""
        return bool(self.workloads) or self.view.plugin_installed

    def allocation_summary(self) -> Mapping[str, int]:
        return self.view.allocation_summary()

    def fleet_stats(self) -> Mapping[str, Any]:
        """Every dashboard aggregate for this provider, computed once per
        snapshot: the torch rollup on the state's device or the Python
        pass, whichever the measured-winner policy picks — identical
        keys either way (``analytics/stats.py``)."""
        if self._stats is None:
            from ..analytics.stats import fleet_stats

            self._stats = fleet_stats(
                self.view, device=self.device, fleet_cache=self.fleet_cache,
                rollup_results=self.rollup_results,
            )
        return self._stats


@dataclass
class ClusterSnapshot:
    """Immutable view handed to pages; ``None`` lists mean the track has
    never succeeded (the reference's ``loading`` definition `:214`)."""

    all_nodes: list[Any] | None
    all_pods: list[Any] | None
    providers: dict[str, ProviderState]
    errors: list[str]
    fetched_at: float
    refresh_count: int

    @property
    def loading(self) -> bool:
        return self.all_nodes is None or self.all_pods is None

    @property
    def error(self) -> str | None:
        """The page-facing aggregate: streams joined by '; '
        (`IntelGpuDataContext.tsx:216-220`)."""
        return "; ".join(self.errors) if self.errors else None

    def provider(self, name: str) -> ProviderState:
        return self.providers[name]


class AcceleratorDataContext:
    """Owns cluster state; pages read snapshots, never the transport.

    ``transport`` and ``clock`` are injected for testability. ``device``
    is where the snapshot's fleet rollup runs: CUDA unless the caller
    asks for ``"cpu"``; without CUDA the constructor raises. The context
    owns the device-resident fleet columns of its snapshots
    (``fleet_cache``) and the rollups the fused rollup+forecast parked
    for them (``rollup_results``), both keyed by its own snapshot
    versions."""

    #: Reactive-track page size. 500 keeps each page's JSON well under
    #: what a 2 s per-request timeout can move even on a slow apiserver;
    #: a 10k-pod fleet costs 20 requests, each individually timed out.
    PAGE_LIMIT = 500
    #: Runaway-loop backstop for a server that keeps returning continue
    #: tokens (200 pages × 500 = 100k objects).
    MAX_PAGES = 200
    #: Server-side watch window (``timeoutSeconds=``): the apiserver holds
    #: the bounded watch open this long collecting events. Short, because
    #: each sync is a delta poll; the background loop sets the cadence.
    WATCH_WINDOW_S = 1.0

    def __init__(
        self,
        transport: Transport,
        *,
        device: DeviceLike = None,
        providers: tuple[Provider, ...] = PROVIDERS,
        sources: Mapping[str, ProviderSource] | None = None,
        clock: Callable[[], float] = time.time,
        watch: bool = False,
        pod_field_selector: str | None = None,
    ) -> None:
        self._device = resolve_device(device)
        self.fleet_cache = DeviceFleetCache(self._device)
        self.rollup_results = RollupResultCache()
        self._transport = transport
        self._providers = providers
        self._sources = dict(sources if sources is not None else default_sources())
        self._timeout_s = DEFAULT_TIMEOUT_S
        # Wall clock on purpose: it only stamps snapshot.fetched_at, a
        # displayed timestamp. Elapsed-time telemetry (sync coalescing,
        # cache TTLs) lives in the server app on its monotonic clock.
        self._clock = clock
        #: Incremental reactive syncs (list+watch). Off by default: a
        #: one-shot render or an infrequent inline sync gains nothing
        #: from a delta protocol; the server's background loop turns it
        #: on (``DashboardApp.start_background_sync``).
        self._watch_enabled = watch
        #: Optional server-side pod filter (``ACTIVE_PODS_FIELD_SELECTOR``
        #: drops Succeeded and Failed pods) on the reactive pod list.
        self._pod_field_selector = pod_field_selector

        self._all_nodes: list[Any] | None = None
        self._all_pods: list[Any] | None = None
        self._node_error: str | None = None
        self._pod_error: str | None = None
        #: Per-track object store (key -> object, insertion-ordered) and
        #: watch cursor. An empty cursor means no successful LIST yet:
        #: watch stays disarmed until one lands.
        self._track_store: dict[str, dict[str, Any]] = {"nodes": {}, "pods": {}}
        self._track_rv: dict[str, str] = {"nodes": "", "pods": ""}
        #: Full re-lists, watch polls and applied events per track.
        self.watch_stats: dict[str, dict[str, int]] = {
            "nodes": {"relists": 0, "watches": 0, "events": 0},
            "pods": {"relists": 0, "watches": 0, "events": 0},
        }
        #: The node track's worker, created on the first sync.
        self._reactive_pool: concurrent.futures.ThreadPoolExecutor | None = None
        self._workloads: dict[str, list[Any]] = {}
        self._workload_available: dict[str, bool] = {}
        self._fallback_plugin_pods: dict[str, list[Any]] = {}
        self._plugin_pod_errors: dict[str, str | None] = {}
        self._refresh_count = 0
        self._cached_snapshot: ClusterSnapshot | None = None
        #: Monotone snapshot generation, bumped by every _build_snapshot
        #: and stamped onto each provider FleetView (FleetView.version).
        #: A clean tick reuses the cached snapshot and therefore the
        #: generation: unchanged fleet ⇒ same version ⇒ the device
        #: columns stay valid.
        self._snapshot_generation = 0
        #: Set by either track when a sync changed state (watch events
        #: applied, a re-list ran, imperative results differed, an error
        #: stream flipped). Without watch every successful sync re-lists;
        #: with it a quiet tick is clean. Written from the reactive worker
        #: too: a bool store is GIL-atomic, and within a sync it only goes
        #: from False to True.
        self._changed = True

    def advance_generation_floor(self, floor: int) -> None:
        """Raise the generation counter to at least ``floor``: a newly
        elected replication leader floors its context at ``fencing ×
        GENERATION_STRIDE``, so every generation it publishes carries its
        term in the high digits and replicas reject a deposed leader's
        lower band by plain monotonicity. Never moves backwards. The
        cached snapshot's views carry pre-floor versions, so the next
        build restamps them."""
        if floor > self._snapshot_generation:
            self._snapshot_generation = int(floor)
            self._changed = True

    # ------------------------------------------------------------------
    # Track 1: reactive lists
    # ------------------------------------------------------------------

    def _list_paginated(self, path: str) -> tuple[list[Any], str]:
        """Full list via ``limit=N&continue=<token>`` chunks — the
        fleet-scale replacement for the reference's single unpaginated
        ``useList`` GET: on a 1 000+ node cluster one monolithic list
        cannot finish inside the per-request timeout, while every
        500-object page can. Each page request gets the full
        ``timeout_s``. Any mid-chain failure raises; the caller keeps the
        previous good list. Returns ``(items, resourceVersion)``: the
        first page's list RV, the cursor a later watch resumes from."""
        items: list[Any] = []
        continue_token = ""
        resource_version = ""
        sep = "&" if "?" in path else "?"
        for _ in range(self.MAX_PAGES):
            url = f"{path}{sep}limit={self.PAGE_LIMIT}"
            if continue_token:
                url += "&continue=" + urllib.parse.quote(continue_token, safe="")
            data = self._transport.request(url, self._timeout_s)
            items.extend(obj.kube_list_items(data))
            continue_token = ""
            if isinstance(data, Mapping):
                metadata = data.get("metadata")
                if isinstance(metadata, Mapping):
                    continue_token = str(metadata.get("continue") or "")
                    if not resource_version:
                        resource_version = str(metadata.get("resourceVersion") or "")
            if not continue_token:
                return items, resource_version
        raise ApiError(path, f"list did not terminate within {self.MAX_PAGES} pages")

    def enable_watch(self, enabled: bool = True) -> None:
        """Switch the reactive track to incremental list+watch syncs.
        Takes effect on the next ``sync()``; the first one after a cold
        start still pays a full LIST (there is no cursor yet)."""
        self._watch_enabled = enabled

    @staticmethod
    def _obj_key(o: Any) -> str:
        """Store key: the UID when present (the identity Kubernetes
        dedups by), the name otherwise."""
        return obj.uid(o) or obj.name(o)

    def _watch_path(self, path: str, resource_version: str) -> str:
        sep = "&" if "?" in path else "?"
        return (
            f"{path}{sep}watch=true"
            f"&resourceVersion={urllib.parse.quote(resource_version, safe='')}"
            "&allowWatchBookmarks=true"
            f"&timeoutSeconds={max(int(self.WATCH_WINDOW_S), 1)}"
        )

    def _apply_watch_events(self, track: str, events: list[Any]) -> int:
        """Apply a watch response to the track's store; returns the
        object events applied. Raises :class:`_WatchExpired` on a 410
        ERROR event and :class:`ApiError` on any other ERROR; both make
        the caller re-list. ADDED appends (or keeps the place of a known
        key), MODIFIED keeps its place, DELETED removes: the store's
        order is the page order."""
        store = self._track_store[track]
        applied = 0
        for event in events:
            if not isinstance(event, Mapping):
                continue
            etype = str(event.get("type", ""))
            payload = event.get("object")
            if etype == "ERROR":
                code = payload.get("code") if isinstance(payload, Mapping) else None
                if code == 410:
                    raise _WatchExpired()
                raise ApiError(track, f"watch ERROR event: {payload}")
            if not isinstance(payload, Mapping):
                continue
            if etype in ("ADDED", "MODIFIED"):
                store[self._obj_key(payload)] = payload
                applied += 1
            elif etype == "DELETED":
                store.pop(self._obj_key(payload), None)
                applied += 1
            # Every event advances the cursor, bookmarks included: that is
            # their purpose, moving it past quiet stretches so it cannot
            # expire.
            rv = obj.metadata(payload).get("resourceVersion")
            if rv:
                self._track_rv[track] = str(rv)
        return applied

    def _sync_track(self, track: str, path: str) -> str | None:
        """Sync one reactive list; returns the stream's error (or None).
        An incremental watch when enabled, armed (a LIST recorded a
        cursor) and supported by the transport; a full paginated re-list
        otherwise, and after any failed watch, 410 Gone included, so a
        watch-incapable or degraded server costs what a sync without
        watch costs."""
        stats = self.watch_stats[track]
        watcher = getattr(self._transport, "watch", None)
        if self._watch_enabled and watcher is not None and self._track_rv[track]:
            try:
                events = watcher(
                    self._watch_path(path, self._track_rv[track]),
                    self.WATCH_WINDOW_S + self._timeout_s,
                )
                applied = self._apply_watch_events(track, events)
            except (_WatchExpired, ApiError):
                pass  # re-list below
            else:
                stats["watches"] += 1
                stats["events"] += applied
                if applied:
                    self._changed = True
                return None
        try:
            items, resource_version = self._list_paginated(path)
        except ApiError as e:
            return f"{track}: {e}"
        self._track_store[track] = {self._obj_key(o): o for o in items}
        self._track_rv[track] = resource_version
        stats["relists"] += 1
        self._changed = True
        return None

    def _pods_path(self) -> str:
        if self._pod_field_selector:
            return (
                PODS_PATH + "?fieldSelector="
                + urllib.parse.quote(self._pod_field_selector, safe="")
            )
        return PODS_PATH

    def _sync_reactive(self) -> None:
        # The two tracks are independent (own stores, cursors and error
        # streams) and run concurrently: with watch on, a quiet bounded
        # watch blocks its whole server-side window, and serial polls
        # would double every tick. One persistent worker carries the node
        # track while the calling thread runs the pod track.
        pool = self._reactive_pool
        if pool is None:
            pool = self._reactive_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="hl-torch-reactive"
            )
        try:
            nodes_future = pool.submit(self._sync_track, "nodes", NODES_PATH)
        except RuntimeError:
            # close() shut the pool down between the read and the submit:
            # run both tracks inline this once; the next sync recreates it.
            nodes_future = None
        if nodes_future is None:
            self._node_error = self._sync_track("nodes", NODES_PATH)
            self._pod_error = self._sync_track("pods", self._pods_path())
        else:
            self._pod_error = self._sync_track("pods", self._pods_path())
            self._node_error = nodes_future.result()
        if self._node_error is None:
            self._all_nodes = list(self._track_store["nodes"].values())
        if self._pod_error is None:
            self._all_pods = list(self._track_store["pods"].values())

    # ------------------------------------------------------------------
    # Track 2: imperative per-provider fetches
    # ------------------------------------------------------------------

    def _sync_imperative(self, detect_changes: bool = True) -> None:
        """Per-provider chains run concurrently: the chains are
        independent, and a blackholed provider (firewalled Intel
        namespaces on a TPU-only cluster) must cost the slowest single
        chain, not the sum of every chain's timeouts. A provider with no
        source reads ``workload_available=False``.

        Change detection: the refetched results are fingerprint-compared
        to the previous tick's — (uid, resourceVersion) per object, not
        a deep dict walk. Only a real difference marks the sync dirty
        (see ``_changed``)."""
        sourced = [
            (p, self._sources[p.name]) for p in self._providers if p.name in self._sources
        ]
        for p in self._providers:
            if p.name not in self._sources:
                self._workload_available[p.name] = False
        # refresh() invalidates the snapshot unconditionally — skip the
        # fingerprint walks when nobody will read the verdict.
        before = self._imperative_fingerprint() if detect_changes else None

        def fetch_one(item: tuple[Provider, ProviderSource]) -> None:
            provider, source = item
            self._fetch_workloads(provider, source)
            self._fetch_plugin_pods(provider, source)

        # One chain runs inline; fanout.map joins its threads on return.
        fanout.map(fetch_one, sourced, pool=pool_of(self._transport))
        if detect_changes and self._imperative_fingerprint() != before:
            self._changed = True

    def _imperative_fingerprint(self) -> tuple:
        """Cheap identity of the imperative-track results: (uid,
        resourceVersion) per object instead of deep dict equality —
        plugin daemon pods scale with the fleet. Every apiserver write
        bumps resourceVersion, so the fingerprint is exact for the
        transitions that matter."""

        def fp(objs: list[Any]) -> tuple:
            return tuple(
                (obj.uid(o), str(obj.metadata(o).get("resourceVersion", ""))) for o in objs
            )

        return (
            {name: fp(objs) for name, objs in self._workloads.items()},
            dict(self._workload_available),
            {name: fp(objs) for name, objs in self._fallback_plugin_pods.items()},
            dict(self._plugin_pod_errors),
        )

    def _fetch_workloads(self, provider: Provider, source: ProviderSource) -> None:
        """Fallback chain; total failure degrades silently to
        ``workload_available=False`` (a cluster without a visible
        DaemonSet is healthy, not broken). A path that succeeds with zero
        matches does NOT stop the chain: a plugin DaemonSet labeled
        differently from the primary selector returns an empty 200
        there, and only the namespace fallback with client-side matching
        can find it. Any HTTP success keeps ``workload_available`` True."""
        matched: list[Any] = []
        any_success = False
        for path in source.workload_paths:
            try:
                data = self._transport.request(path, self._timeout_s)
            except ApiError:
                continue
            any_success = True
            items = obj.kube_list_items(data) if obj.is_kube_list(data) else (
                [data] if isinstance(data, Mapping) else []
            )
            matched = [w for w in items if workload_matches_provider(source, w)]
            if matched:
                break
        self._workloads[provider.name] = obj.dedup_by_uid(matched) if matched else []
        self._workload_available[provider.name] = any_success

    def _fetch_plugin_pods(self, provider: Provider, source: ProviderSource) -> None:
        """Sequential fallback paths, silent per-path catch, UID dedup
        (`IntelGpuDataContext.tsx:155-174`). Collected pods supplement
        the reactive pod list for clusters where the all-namespace list
        is RBAC-restricted but namespaced reads are allowed."""
        collected: list[Any] = []
        any_success = False
        for path in source.plugin_pod_paths:
            if collected and "labelSelector=" not in path:
                # As in the JAX context: the unfiltered whole-namespace
                # list is skipped once a selector path found confirmed
                # daemon pods.
                continue
            try:
                data = self._transport.request(path, self._timeout_s)
            except ApiError:
                continue
            any_success = True
            collected.extend(p for p in obj.kube_list_items(data) if source.plugin_pod_filter(p))
        # Total failure is recorded per provider, NOT in the global error
        # banner, so an absent provider degrades independently.
        self._plugin_pod_errors[provider.name] = (
            None if any_success else "failed to query device-plugin pods"
        )
        self._fallback_plugin_pods[provider.name] = obj.dedup_by_uid(collected)

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def sync(self) -> ClusterSnapshot:
        """Run both tracks and return a snapshot. A CLEAN tick —
        unchanged imperative results, stable error streams, no list that
        succeeded — preserves the previous snapshot object (with its
        lazily computed fleet stats) and only advances ``fetched_at``."""
        old_errors = (self._node_error, self._pod_error)
        self._changed = False
        self._sync_reactive()
        self._sync_imperative()
        if (self._node_error, self._pod_error) != old_errors:
            self._changed = True
        if not self._changed and self._cached_snapshot is not None:
            self._cached_snapshot = replace(self._cached_snapshot, fetched_at=self._clock())
            return self._cached_snapshot
        self._cached_snapshot = None
        return self.snapshot()

    def refresh(self) -> ClusterSnapshot:
        """Imperative track only — the ``refreshKey`` semantics
        (`:109-111`: hooks stay reactive, manual refresh re-fires the
        DaemonSet/daemon-pod effect)."""
        self._refresh_count += 1
        self._sync_imperative(detect_changes=False)
        self._cached_snapshot = None
        return self.snapshot()

    def close(self) -> None:
        """Stop the node track's worker thread and join it. Idempotent; a
        closed context can still sync (the worker is recreated lazily).
        Call it when no sync is running: the join waits for one."""
        pool, self._reactive_pool = self._reactive_pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def __enter__(self) -> AcceleratorDataContext:
        return self

    def __exit__(self, *_exc: Any) -> None:
        self.close()

    def snapshot(self) -> ClusterSnapshot:
        """The current snapshot, built once per sync/refresh and cached:
        N page reads between syncs must not cost N fleet
        reclassifications."""
        if self._cached_snapshot is not None:
            return self._cached_snapshot
        self._cached_snapshot = self._build_snapshot()
        return self._cached_snapshot

    def _build_snapshot(self) -> ClusterSnapshot:
        nodes, pods = self._all_nodes or [], self._all_pods or []
        with span("sync.build", nodes=len(nodes), pods=len(pods),
                  generation=self._snapshot_generation + 1):
            with span("sync.classify"):
                views = classify_fleet(nodes, pods, self._providers)
            self._snapshot_generation += 1
            providers: dict[str, ProviderState] = {}
            for p in self._providers:
                view = views[p.name]
                view.version = self._snapshot_generation
                # Merge imperative-track plugin pods not already present in
                # the reactive list (UID dedup across tracks).
                seen = {obj.uid(pod) for pod in view.plugin_pods}
                for pod in self._fallback_plugin_pods.get(p.name, []):
                    if obj.uid(pod) not in seen:
                        view.plugin_pods.append(pod)
                providers[p.name] = ProviderState(
                    provider=p,
                    view=view,
                    workloads=list(self._workloads.get(p.name, [])),
                    workload_available=self._workload_available.get(p.name, True),
                    plugin_pods_error=self._plugin_pod_errors.get(p.name),
                    device=self._device,
                    fleet_cache=self.fleet_cache,
                    rollup_results=self.rollup_results,
                )

            errors = [e for e in (self._node_error, self._pod_error) if e]
            return ClusterSnapshot(
                all_nodes=self._all_nodes,
                all_pods=self._all_pods,
                providers=providers,
                errors=errors,
                fetched_at=self._clock(),
                refresh_count=self._refresh_count,
            )

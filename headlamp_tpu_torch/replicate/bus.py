"""Snapshot-distribution bus: one record per published generation.

The port's copy of ``headlamp_tpu/replicate/bus.py``. The payload is
JSONL: a versioned header line, then generation records. Every record
is self-contained (the raw node and pod lists with each provider's
imperative-track state, the metrics and forecast peeks current at
publish time, and the history rows this generation contributed), so a
replica that missed generations applies the newest retained record and
is current: resume never fabricates state.

Wire format (one JSON object per line, canonical: sorted keys, compact
separators, so re-encoding a parsed record reproduces its bytes, and the
port's records equal the JAX package's byte for byte)::

    {"format": "headlamp-tpu-bus", "kind": "header", "note": <str>,
     "recorded_unix": <float>, "v": 1}
    {"fencing": <int>, "forecast": <obj|null>, "generation": <int>,
     "history": [[metric, [labels...], value], ...], "kind": "generation",
     "metrics": <obj|null>, "obs": <obj, optional>, "snapshot": <obj>}

Replicas pull ``GET /replicate/bus`` with a ``Last-Generation: g<N>``
cursor (the push hub's ``Last-Event-ID`` grammar, parsed by the same
function) and receive only records newer than the cursor.

Views are pure functions of the raw lists (``classify_fleet``), so the
bus ships lists, not views: a replica reclassifies them and stamps each
view's ``version`` with the record's generation, which makes its ETags,
coalesce keys and push frames equal the leader's for that generation.
Backlog ages run on the injected monotonic clock; the header's
``recorded_unix`` comes through the injectable ``wall`` seam.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import asdict
from typing import Any, Callable

from ..context.accelerator_context import ClusterSnapshot, ProviderState
from ..device import DeviceLike
from ..domain.accelerator import PROVIDERS, classify_fleet
from ..metrics.client import TpuChipMetrics, TpuMetricsSnapshot
from ..models.service import ChipForecast, ForecastView
from ..obs.metrics import registry as _metrics_registry
from ..obs.trace import current_trace_id
from ..runtime.device_cache import DeviceFleetCache, RollupResultCache

BUS_VERSION = 1
BUS_FORMAT = "headlamp-tpu-bus"

#: Full-snapshot records kept for cursor catch-up. Small on purpose: a
#: replica behind the backlog loses nothing, it applies the newest record.
BACKLOG_LIMIT = 16

_GENERATIONS = _metrics_registry.counter(
    "headlamp_tpu_torch_replicate_generations_total",
    "Snapshot generations moved through the replication bus, by role "
    "(published by the leader, applied by a replica, rejected_stale by fencing).",
    labels=("role",),
)
_BYTES = _metrics_registry.counter(
    "headlamp_tpu_torch_replicate_bytes_total",
    "Bus payload bytes, by role (served by the leader, applied by a replica).",
    labels=("role",),
)
_ERRORS = _metrics_registry.counter(
    "headlamp_tpu_torch_replicate_errors_total",
    "Publishes (leader) and applies (replica) that raised, by role.",
    labels=("role",),
)


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------


def _dumps(obj: Any) -> str:
    """Canonical line encoding: ``_dumps(json.loads(line)) == line``."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def dumps_record(record: dict[str, Any]) -> str:
    """One record dict as its canonical wire line (no newline)."""
    return _dumps(record)


def header_line(*, wall: Callable[[], float] = time.time, note: str = "") -> str:
    return _dumps(
        {"v": BUS_VERSION, "kind": "header", "format": BUS_FORMAT, "recorded_unix": wall(),
         "note": note}
    )


def encode_snapshot(snap: ClusterSnapshot) -> dict[str, Any]:
    """A snapshot as a JSON-able payload: the raw object lists plus each
    provider's imperative-track state, which the classifier cannot
    rebuild (workloads, the plugin pods merged with the fallback track's,
    the degradation markers). Views are not shipped."""
    providers: dict[str, Any] = {}
    for name, state in (snap.providers or {}).items():
        providers[name] = {
            "workloads": list(state.workloads),
            "workload_available": bool(state.workload_available),
            "plugin_pods_error": state.plugin_pods_error,
            # Already merged with the fallback pods (UID-deduped): shipped
            # as is, so the replica's rebuild is exact.
            "plugin_pods": list(state.view.plugin_pods),
        }
    return {
        "all_nodes": snap.all_nodes,
        "all_pods": snap.all_pods,
        "errors": list(snap.errors),
        "fetched_at": snap.fetched_at,
        "refresh_count": snap.refresh_count,
        "providers": providers,
    }


def decode_snapshot(
    payload: dict[str, Any],
    *,
    generation: int,
    device: DeviceLike = None,
    fleet_cache: DeviceFleetCache | None = None,
    rollup_results: RollupResultCache | None = None,
) -> ClusterSnapshot:
    """Rebuild a snapshot on a replica: reclassify the raw lists, stamp
    every view with the record's generation and restore the shipped
    per-provider state. ``device``, ``fleet_cache`` and ``rollup_results``
    are the replica's own: its rollups run on its card, over columns it
    uploads once per applied generation."""
    views = classify_fleet(payload.get("all_nodes") or [], payload.get("all_pods") or [])
    shipped = payload.get("providers") or {}
    providers: dict[str, ProviderState] = {}
    for p in PROVIDERS:
        view = views[p.name]
        view.version = int(generation)
        extra = shipped.get(p.name) or {}
        plugin_pods = extra.get("plugin_pods")
        if plugin_pods is not None:
            view.plugin_pods = list(plugin_pods)
        providers[p.name] = ProviderState(
            provider=p,
            view=view,
            workloads=list(extra.get("workloads") or []),
            workload_available=bool(extra.get("workload_available", True)),
            plugin_pods_error=extra.get("plugin_pods_error"),
            device=device,
            fleet_cache=fleet_cache,
            rollup_results=rollup_results,
        )
    return ClusterSnapshot(
        all_nodes=payload.get("all_nodes"),
        all_pods=payload.get("all_pods"),
        providers=providers,
        errors=list(payload.get("errors") or []),
        fetched_at=float(payload.get("fetched_at") or 0.0),
        refresh_count=int(payload.get("refresh_count") or 0),
    )


def encode_metrics(metrics: TpuMetricsSnapshot | None) -> dict[str, Any] | None:
    """The dataclass's fields, nested chips included; None passes through
    (an absent peek is a state, not an error)."""
    return None if metrics is None else asdict(metrics)


def decode_metrics(payload: dict[str, Any] | None) -> TpuMetricsSnapshot | None:
    if payload is None:
        return None
    chips = [TpuChipMetrics(**chip) for chip in payload.get("chips") or []]
    fields = {k: v for k, v in payload.items() if k != "chips"}
    return TpuMetricsSnapshot(chips=chips, **fields)


def encode_forecast(forecast: ForecastView | None) -> dict[str, Any] | None:
    return None if forecast is None else asdict(forecast)


def decode_forecast(payload: dict[str, Any] | None) -> ForecastView | None:
    if payload is None:
        return None
    chips = [ChipForecast(**chip) for chip in payload.get("chips") or []]
    fields = {k: v for k, v in payload.items() if k != "chips"}
    return ForecastView(chips=chips, **fields)


def history_rows(
    snap: ClusterSnapshot,
    generation: int,
    *,
    metrics: TpuMetricsSnapshot | None = None,
    include_scrape: bool = False,
) -> list[list[Any]]:
    """The history rows this generation contributes: the ``sync.*`` rows
    the leader's store captured for it and, when the metrics peek is
    fresh (the first record shipping that scrape), the per-chip and fleet
    scrape rows ``HistoryStore.record_scrape`` writes, so a replica's
    trend page answers from the same series. ``[metric, [labels...],
    value]`` triples; a replica appends them on its own monotonic."""
    rows: list[list[Any]] = [
        ["sync.generation", [], float(generation)],
        ["sync.nodes", [], float(len(snap.all_nodes or []))],
        ["sync.errors", [], float(len(snap.errors or []))],
    ]
    if not include_scrape or metrics is None:
        return rows
    chips = metrics.chips or []
    util_sum, util_n = 0.0, 0
    for chip in chips:
        chip_key = [str(chip.node), str(chip.accelerator_id)]
        if chip.tensorcore_utilization is not None:
            rows.append(["chip.tensorcore_utilization", chip_key, chip.tensorcore_utilization])
            util_sum += chip.tensorcore_utilization
            util_n += 1
        if chip.duty_cycle is not None:
            rows.append(["chip.duty_cycle", chip_key, chip.duty_cycle])
    rows.append(["fleet.chips_reporting", [], float(len(chips))])
    if util_n:
        rows.append(["fleet.mean_tensorcore_utilization", [], util_sum / util_n])
    return rows


def build_record(
    snap: ClusterSnapshot,
    *,
    generation: int,
    fencing: int = 0,
    metrics: TpuMetricsSnapshot | None = None,
    forecast: ForecastView | None = None,
    history: list[list[Any]] | None = None,
    obs: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """One self-contained generation record, not yet encoded. ``obs`` is
    the optional provenance block (the publishing trace id and the
    leader's wall stamps, ``GenerationLedger.provenance``): omitted when
    absent, so a record without it encodes as before the field existed."""
    record = {
        "kind": "generation",
        "generation": int(generation),
        "fencing": int(fencing),
        "snapshot": encode_snapshot(snap),
        "metrics": encode_metrics(metrics),
        "forecast": encode_forecast(forecast),
        "history": history if history is not None else history_rows(snap, generation),
    }
    if obs:
        record["obs"] = obs
    return record


def parse_payload(
    text: str, *, origin: str = "<bus>"
) -> tuple[dict[str, Any], list[dict[str, Any]]]:
    """Parse a bus payload (header line, then records). A foreign-format
    or other-version payload raises ValueError and is never half-applied;
    records of an unknown kind are skipped."""
    lines = [line for line in text.splitlines() if line.strip()]
    if not lines:
        raise ValueError(f"{origin}: empty bus payload")
    header = json.loads(lines[0])
    if header.get("kind") != "header" or header.get("format") != BUS_FORMAT:
        raise ValueError(f"{origin}: not a {BUS_FORMAT} payload")
    version = header.get("v")
    if version != BUS_VERSION:
        raise ValueError(
            f"{origin}: bus version {version!r} not supported (this build reads v{BUS_VERSION})"
        )
    records: list[dict[str, Any]] = []
    for line in lines[1:]:
        entry = json.loads(line)
        if entry.get("kind") == "generation":
            records.append(entry)
    return header, records


# ---------------------------------------------------------------------------
# Publisher (leader side)
# ---------------------------------------------------------------------------


class BusPublisher:
    """The leader's half of the bus: encodes each published generation
    once and keeps a bounded backlog of encoded lines for cursor
    catch-up. The host calls :meth:`on_snapshot` at the end of its sync
    bookkeeping, after the push differ, with the same snapshot and peeks.

    Fencing: :meth:`publish` rejects a generation at or below the last
    one published. With the elector's generation bands
    (``leader.GENERATION_STRIDE``) a deposed leader's publishes sit in a
    lower band and never overwrite newer state.

    A publish that raises is counted in ``errors`` and named in
    ``last_error``; ``failing`` holds (and the host's ``/healthz`` reads
    ``ok`` false) until a later generation publishes cleanly. The sync
    itself goes on. The node's ``elector``, where one is attached, shows
    in :meth:`snapshot`, and its failing renewal ticks fail the publisher
    the same way. :meth:`on_snapshot` runs on whichever thread syncs,
    :meth:`payload_after` on request threads; one lock guards the state."""

    def __init__(
        self,
        *,
        backlog_limit: int = BACKLOG_LIMIT,
        monotonic: Callable[[], float] | None = None,
        wall: Callable[[], float] = time.time,
        note: str = "leader",
        ledger: Any = None,
    ) -> None:
        self._mono = monotonic or time.monotonic
        #: Optional GenerationLedger: each accepted publish is stamped and
        #: the record carries the ledger's provenance block.
        self._ledger = ledger
        self._lock = threading.Lock()
        self.backlog_limit = backlog_limit
        self._header = header_line(wall=wall, note=note)
        #: (generation, encoded line) in publish order.
        self._backlog: deque[tuple[int, str]] = deque()
        self.last_generation = 0
        #: The current term's fencing token (the elector's on_elected sets
        #: it); informational on the wire, the generation band enforces.
        self.fencing = 0
        self._last_scrape_stamp: float | None = None
        self._last_publish_mono: float | None = None
        self.published = 0
        self.rejected_stale = 0
        self.pulls = 0
        self.bytes_served = 0
        self.errors = 0
        self.last_error: str | None = None
        self._publish_failing = False
        #: This node's LeaderElector, when one runs (the server wires it).
        self.elector: Any = None

    @property
    def failing(self) -> bool:
        """Whether the last publish raised or the elector's last renewal
        tick did: the host's ``/healthz`` reads ``ok`` false while so."""
        elector = self.elector
        return self._publish_failing or (elector is not None and elector.failing)

    def set_fencing(self, fencing: int) -> None:
        self.fencing = int(fencing)

    # -- publish ---------------------------------------------------------

    def on_snapshot(
        self,
        snap: ClusterSnapshot | None,
        *,
        generation: int,
        metrics: Callable[[], Any] | None = None,
        forecast: Callable[[], Any] | None = None,
    ) -> bool:
        """The publish hook: read the peeks once, build the record, keep
        it. Returns whether the generation was accepted. An exception is
        counted and named, not raised into the sync."""
        if snap is None:
            return False
        try:
            metrics_value = metrics() if callable(metrics) else metrics
            forecast_value = forecast() if callable(forecast) else forecast
            accepted = self.publish(
                snap, generation=generation, metrics=metrics_value, forecast=forecast_value
            )
        except Exception as e:  # noqa: BLE001 — counted, named in /healthz, ok false
            with self._lock:
                self.errors += 1
                self.last_error = f"{type(e).__name__}: {e}"
                self._publish_failing = True
            _ERRORS.inc(role="leader")
            return False
        if accepted:
            self._publish_failing = False
        return accepted

    def publish(
        self,
        snap: ClusterSnapshot,
        *,
        generation: int,
        metrics: TpuMetricsSnapshot | None = None,
        forecast: ForecastView | None = None,
    ) -> bool:
        """Encode and keep one generation; a generation at or below the
        last published is rejected (the fencing check)."""
        generation = int(generation)
        with self._lock:
            if generation <= self.last_generation:
                self.rejected_stale += 1
                _GENERATIONS.inc(role="rejected_stale")
                return False
            stamp = getattr(metrics, "fetched_at", None)
            fresh_scrape = metrics is not None and stamp != self._last_scrape_stamp
            obs = None
            if self._ledger is not None:
                # Stamped before the record is built, so its provenance
                # block carries this publish to the replicas.
                self._ledger.published(generation, trace_id=current_trace_id())
                obs = self._ledger.provenance(generation)
            record = build_record(
                snap,
                generation=generation,
                fencing=self.fencing,
                metrics=metrics,
                forecast=forecast,
                history=history_rows(
                    snap, generation, metrics=metrics, include_scrape=fresh_scrape
                ),
                obs=obs,
            )
            if fresh_scrape:
                self._last_scrape_stamp = stamp
            self._backlog.append((generation, dumps_record(record)))
            while len(self._backlog) > self.backlog_limit:
                self._backlog.popleft()
            self.last_generation = generation
            self._last_publish_mono = self._mono()
            self.published += 1
        _GENERATIONS.inc(role="published")
        return True

    # -- serve -----------------------------------------------------------

    def payload_after(self, cursor: int | None) -> str:
        """One replica pull: the header and every kept record newer than
        ``cursor`` (None: everything kept)."""
        after = int(cursor) if cursor is not None else 0
        with self._lock:
            lines = [self._header]
            lines.extend(line for generation, line in self._backlog if generation > after)
            self.pulls += 1
            payload = "\n".join(lines) + "\n"
            self.bytes_served += len(payload)
        _BYTES.inc(len(payload), role="served")
        return payload

    # -- observability ---------------------------------------------------

    def counters(self) -> dict[str, int]:
        return {
            "published": self.published,
            "rejected_stale": self.rejected_stale,
            "pulls": self.pulls,
            "bytes_served": self.bytes_served,
            "errors": self.errors,
        }

    def snapshot(self) -> dict[str, Any]:
        """The /healthz ``runtime.replication`` block (leader role). Plain
        reads without the lock, as :meth:`counters`: a publish holds the
        lock for the whole encode, and /healthz and every request's wide
        event must not wait on it."""
        mono = self._last_publish_mono
        elector = self.elector
        return {
            "role": "leader",
            **self.counters(),
            "last_generation": self.last_generation,
            "fencing": self.fencing,
            "backlog": len(self._backlog),
            "last_publish_age_s": (
                round(max(self._mono() - mono, 0.0), 3) if mono is not None else None
            ),
            "last_error": self.last_error,
            "election": elector.snapshot() if elector is not None else None,
        }

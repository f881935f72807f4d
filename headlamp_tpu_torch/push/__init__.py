"""Push pipeline: generation-keyed snapshot deltas, an SSE broadcast hub,
and conditional and compressed full paints.

The port's copy of ``headlamp_tpu/push``. Three parts make "push, don't
poll":

1. ``differ.py``: on each sync that bumps the generation, reduce the
   snapshot (with non-blocking metrics and forecast peeks) to compact
   page models and diff them against the previous generation's; a
   changed page becomes a JSON patch frame, an unchanged one nothing.
2. ``hub.py``: fan each generation's frames out to the connected
   ``/events`` subscribers: one fleet change is one diff and N cheap frame
   writes, whatever N is.
3. ``conditional.py``: for clients still polling full paints, strong
   ETags answer ``If-None-Match`` with a 304 before render-pool
   admission, and bodies ship gzipped when the client accepts it.

This package never imports ``..gateway`` (the gateway imports
``conditional``; the dependency runs one way) and never starts a thread:
the pipeline is built in ``DashboardApp.__init__``, and the socket server
parks its own handler threads in ``hub.next_event``.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable

from ..obs.flight import flight_recorder
from ..obs.metrics import registry as _metrics_registry
from .conditional import (
    GZIP_CACHE_LIMIT,
    GZIP_LEVEL,
    MIN_GZIP_SIZE,
    count_not_modified,
    encode_body,
    etag_for,
    gzip_accepted,
    gzip_cache_clear,
    gzip_cache_len,
    if_none_match_matches,
    window_token,
)
from .differ import (
    CELL_KEY_PREFIX,
    PAGES,
    REGION_PAGE_PREFIX,
    ChangeLog,
    build_page_models,
    diff_models,
    frame_changed_keys,
)
from .hub import (
    BACKLOG_LIMIT,
    HEARTBEAT_S,
    OUTBOX_LIMIT,
    BroadcastHub,
    Subscription,
    format_event,
    parse_last_event_id,
    set_worker_identity,
    worker_identity,
)

_DIFF_SECONDS = _metrics_registry.histogram(
    "headlamp_tpu_torch_push_diff_seconds",
    "Page-model build and diff time per sync generation bump (on the "
    "sync thread, off the request path).",
)
_DIFF_ERRORS = _metrics_registry.counter(
    "headlamp_tpu_torch_push_diff_errors_total",
    "Sync generations whose model build, diff or fan-out raised.",
)

#: The serving pipeline, for the connected-clients gauge: tests build many
#: pipelines per process, and the gauge follows the live one.
_ACTIVE: weakref.ref | None = None


def set_active_push(pipeline: "PushPipeline | None") -> None:
    global _ACTIVE
    _ACTIVE = weakref.ref(pipeline) if pipeline is not None else None


def _clients_sample() -> float | None:
    pipeline = _ACTIVE() if _ACTIVE is not None else None
    return float(pipeline.hub.connected()) if pipeline is not None else None


_metrics_registry.gauge_fn(
    "headlamp_tpu_torch_push_clients_count",
    "SSE subscribers currently connected to /events.",
    _clients_sample,
)


class PushPipeline:
    """Differ and hub, hooked in after ``_record_sync``: every sync that
    bumps the generation diffs the new snapshot's page models against
    the previous generation's and broadcasts the patch frames. The first
    snapshot is the baseline: clients hold current state from their
    first full paint, so it produces no frames.

    Unlike the JAX pipeline, which returns 0 from any exception, a
    failure is counted in ``errors`` and named in ``last_error``
    (``/healthz`` ``runtime.push``), and ``failing`` holds until a later
    generation diffs cleanly; the host turns ``ok`` false meanwhile. The
    sync's own bookkeeping is done before the hook runs, so it still
    publishes the snapshot."""

    def __init__(
        self,
        *,
        monotonic: Callable[[], float] | None = None,
        fragments: Any = None,
        ledger: Any = None,
    ) -> None:
        self._mono = monotonic or time.monotonic
        #: The hub runs on its module constants; the gateway installs the
        #: shed probe (``RenderGateway.attach_push``).
        self.hub = BroadcastHub(monotonic=self._mono)
        #: Serializes generations: the background loop's first tick and a
        #: request's inline sync can both reach the hook.
        self._lock = threading.Lock()
        self._models: dict[str, dict[str, Any]] | None = None
        self.generation = 0
        #: Per-generation change sets, recorded from the frames this
        #: pipeline built (:meth:`changed_keys`), never a second diff.
        self.changes = ChangeLog()
        #: The app's fragment cache, when one is wired: every diffed
        #: generation evicts exactly the keys its change set names.
        self._fragments = fragments
        #: The app's generation ledger: each diffed generation stamps
        #: ``diff_framed`` after its frames are built.
        self._ledger = ledger
        # Monotone per-instance ints (/healthz and flight deltas).
        self.diffs = 0
        self.baselines = 0
        self.frames_built = 0
        self.skipped_stale = 0
        self.fragment_invalidations = 0
        self.errors = 0
        self.last_error: str | None = None
        self.failing = False

    def on_snapshot(
        self,
        snap: Any,
        *,
        generation: int,
        metrics: Callable[[], Any] | None = None,
        forecast: Callable[[], Any] | None = None,
    ) -> int:
        """The diff-and-broadcast hook, called from the sync path (the
        background loop and inline syncs). ``metrics`` and ``forecast``
        are zero-argument non-blocking peeks, read here once so every page
        model sees one consistent pair. Returns the frames delivered."""
        with self._lock:
            if snap is None or generation <= self.generation:
                self.skipped_stale += 1
                return 0
            try:
                delivered = self._diff_and_publish(snap, int(generation), metrics, forecast)
            except Exception as e:  # noqa: BLE001 — counted, named in /healthz, ok false
                self.errors += 1
                self.last_error = f"{type(e).__name__}: {e}"
                self.failing = True
                _DIFF_ERRORS.inc()
                return 0
            self.failing = False
            return delivered

    def _diff_and_publish(
        self, snap: Any, generation: int, metrics: Any, forecast: Any
    ) -> int:
        t0 = self._mono()
        metrics_value = metrics() if callable(metrics) else metrics
        forecast_value = forecast() if callable(forecast) else forecast
        models = build_page_models(snap, metrics=metrics_value, forecast=forecast_value)
        frames = {} if self._models is None else diff_models(self._models, models)
        baseline = self._models is None
        self._models = models
        self.generation = generation
        _DIFF_SECONDS.observe(max(self._mono() - t0, 0.0))
        if self._ledger is not None:
            self._ledger.diff_framed(generation)
        if baseline:
            self.baselines += 1
            return 0
        self.diffs += 1
        # The change set comes from the frames just built and evicts the
        # cached bytes of exactly the keys that changed, before the
        # broadcast, so a paint racing this sync never splices bytes the
        # differ knows are stale.
        changed = self.changes.record(generation, frames)
        if self._fragments is not None and changed:
            keys: set[str] = set()
            for page, page_keys in changed.items():
                keys |= page_keys
                if page.startswith(REGION_PAGE_PREFIX):
                    # A changed region page also evicts the region's own
                    # row (viewport rows key on the bare drill-down path).
                    keys.add(page[len(REGION_PAGE_PREFIX):])
            self.fragment_invalidations += self._fragments.invalidate(keys)
        for frame in frames.values():
            frame["generation"] = generation
        self.frames_built += len(frames)
        delivered = self.hub.publish(generation, frames)
        if frames:
            # One flat wide event per fan-out: /debug/flightz answers
            # "what did that fleet change push, to how many clients".
            flight_recorder.record(
                {
                    "request": f"PUSH g{generation}",
                    "route": "/events",
                    "status": 200,
                    "duration_ms": round((self._mono() - t0) * 1000, 3),
                    "trace_id": None,
                    "stages": {},
                    "slo_violations": [],
                    "counters": {
                        "push.pages_changed": len(frames),
                        "push.frames_delivered": delivered,
                        "push.connected": self.hub.connected(),
                    },
                }
            )
        return delivered

    def changed_keys(self, page: str, gen: int) -> set[str] | None:
        """Which of ``page``'s keys changed since generation ``gen``; None
        when ``gen`` predates the ring (treat everything as changed)."""
        return self.changes.changed_keys(page, gen)

    def counters(self) -> dict[str, int]:
        out = {
            "diffs": self.diffs,
            "baselines": self.baselines,
            "frames_built": self.frames_built,
            "skipped_stale": self.skipped_stale,
            "fragment_invalidations": self.fragment_invalidations,
            "errors": self.errors,
        }
        out.update(self.hub.counters())
        return out

    def snapshot(self) -> dict[str, Any]:
        """The /healthz ``runtime.push`` block."""
        out: dict[str, Any] = {
            "generation": self.generation,
            "diffs": self.diffs,
            "baselines": self.baselines,
            "frames_built": self.frames_built,
            "skipped_stale": self.skipped_stale,
            "fragment_invalidations": self.fragment_invalidations,
            "errors": self.errors,
            "last_error": self.last_error,
        }
        out.update(self.hub.snapshot())
        return out

    def close(self) -> None:
        """Evict every subscription: each parked handler writes ``bye``."""
        self.hub.close()


__all__ = [
    "BACKLOG_LIMIT",
    "CELL_KEY_PREFIX",
    "GZIP_CACHE_LIMIT",
    "GZIP_LEVEL",
    "HEARTBEAT_S",
    "MIN_GZIP_SIZE",
    "OUTBOX_LIMIT",
    "PAGES",
    "REGION_PAGE_PREFIX",
    "BroadcastHub",
    "ChangeLog",
    "PushPipeline",
    "Subscription",
    "build_page_models",
    "count_not_modified",
    "diff_models",
    "encode_body",
    "etag_for",
    "format_event",
    "frame_changed_keys",
    "gzip_accepted",
    "gzip_cache_clear",
    "gzip_cache_len",
    "if_none_match_matches",
    "parse_last_event_id",
    "set_active_push",
    "set_worker_identity",
    "window_token",
    "worker_identity",
]

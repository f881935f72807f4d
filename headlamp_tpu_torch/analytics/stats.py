"""Fleet stats — the serving-path entry to the fleet rollup.

The port of ``headlamp_tpu/analytics/stats.py``. One function,
:func:`fleet_stats`, computes every dashboard aggregate for a provider
view: from the torch rollup on the view's device
(``fleet_torch.rollup_to_dict`` over the device-resident columns) or
from the pure-Python pass, whichever the measured-winner policy picks.
Both produce the IDENTICAL key set; the Python pass is also the numeric
oracle the rollup is tested against.

Backends are named as the forecast's inference paths are: ``"cuda"``
for the rollup on a card, ``"torch"`` for it on the CPU, ``"python"``.

Deliberate difference from the JAX package: nothing here catches a
device error. The JAX dispatch falls back to the Python pass on any
device-side failure and pins a backend broken after repeated failures
(`stats.py:404-408`); here an exception from the rollup propagates, so
the page answers 500 naming it.

Keys: capacity, allocatable, in_use, free, utilization_pct,
nodes_total, nodes_ready, phase_counts, generation_counts,
per_node_in_use, max_node_util_pct, hot_nodes.
"""

from __future__ import annotations

import statistics
import threading
import time
from typing import TYPE_CHECKING, Any, Callable

import torch

from ..device import DeviceLike, resolve_device
from ..domain import objects, tpu
from ..domain.accelerator import FleetView
from ..obs.metrics import registry as _metrics_registry
from ..obs.trace import annotate as _annotate
from ..obs.trace import span as _span

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..runtime.device_cache import DeviceFleetCache, RollupResultCache

#: Node-utilization percentage at or above which a node counts as hot —
#: the UI kit's critical threshold (`NodesPage.tsx:38`).
HOT_NODE_PCT = 90.0


def _generation_counts(nodes: list[Any]) -> dict[str, int]:
    """Generation histogram preserving the ACTUAL inferred generation —
    a future 'tpu-v7x-slice' counts as 'v7x', never as 'other'. The
    rollup's histogram is vocabulary-bucketed, so :func:`fleet_stats`
    overrides its counts with this exact host-side pass, which keeps the
    two backends byte-identical."""
    counts: dict[str, int] = {}
    for n in nodes:
        generation = tpu.get_node_generation(n)
        counts[generation] = counts.get(generation, 0) + 1
    return counts


def python_fleet_stats(view: FleetView) -> dict[str, Any]:
    """Pure-Python reference implementation: same aggregates, same key
    set, no torch. Also the numeric oracle the rollup is tested
    against."""
    _annotate(backend="python")
    provider = view.provider
    summary = dict(
        objects.allocation_summary(
            view.nodes,
            view.pods,
            provider.node_device_capacity,
            provider.node_device_allocatable,
            provider.pod_device_request,
        )
    )

    nodes_ready = sum(1 for n in view.nodes if objects.is_node_ready(n))

    # Per-node in-use from Running pods, in view.nodes order.
    in_use_by_node: dict[str, int] = {}
    for pod in view.pods:
        if objects.pod_phase(pod) != "Running":
            continue
        node_name = objects.pod_node_name(pod)
        if node_name:
            in_use_by_node[node_name] = in_use_by_node.get(
                node_name, 0
            ) + provider.pod_device_request(pod)
    per_node_in_use = [in_use_by_node.get(objects.name(n), 0) for n in view.nodes]

    max_util = 0.0
    hot_nodes = 0
    for node, in_use in zip(view.nodes, per_node_in_use):
        allocatable = provider.node_device_allocatable(node)
        if allocatable <= 0:
            continue
        util = in_use / allocatable * 100.0
        max_util = max(max_util, util)
        if util >= HOT_NODE_PCT:
            hot_nodes += 1

    return {
        **summary,
        "nodes_total": len(view.nodes),
        "nodes_ready": nodes_ready,
        "phase_counts": objects.count_pod_phases(view.pods),
        "generation_counts": _generation_counts(view.nodes),
        "per_node_in_use": per_node_in_use,
        "max_node_util_pct": float(max_util),
        "hot_nodes": hot_nodes,
    }


#: Fleet size below which the Python pass ALWAYS serves, with no probe:
#: the JAX package's ``XLA_ROLLUP_MIN_NODES`` kept under the port's name.
#: Above it the winner depends on the host and the device, so the policy
#: measures both backends once per window and picks the winner per
#: request.
DEVICE_ROLLUP_MIN_NODES = 64

#: Probe expiry: a single anomalous probe must not lock a backend for
#: the process lifetime, and host conditions drift. Deliberately NOT
#: tied to /refresh (the routine header link); ``/refresh?recalibrate=1``
#: is the operator's lever.
CALIBRATION_TTL_S = 15 * 60.0


def device_backend(device: torch.device) -> str:
    """The backend name of the rollup on ``device``."""
    return "cuda" if device.type == "cuda" else "torch"


class _Calibration:
    """Rollup timings, re-probed at most once per ``CALIBRATION_TTL_S``:
    the first at-scale request measures the device rollup on its cached
    columns and the Python pass (median of three each), and every later
    at-scale request inside the window serves the measured winner. The
    measurement is published in one atomic swap. Probe ENTRY is guarded
    by a non-blocking lock (``try_begin_probe``), so under
    ThreadingHTTPServer only ONE request pays the probe per window; a
    concurrent request that loses the race serves the stale measured
    winner, or the Python pass on a first calibration."""

    def __init__(self) -> None:
        # Created once and deliberately NOT recreated by reset(): a
        # thread mid-probe must release the lock it acquired.
        self._probe_lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        """Drop the measurement (``/refresh?recalibrate=1``), so the next
        at-scale request re-probes."""
        #: (backend, device_ms, python_ms_per_node, calibrated_at) — ONE
        #: reference, swapped atomically by :meth:`publish`.
        self._measured: tuple[str, float, float, float] | None = None

    def publish(
        self, *, backend: str, device_ms: float, python_ms_per_node: float, calibrated_at: float
    ) -> None:
        self._measured = (backend, device_ms, python_ms_per_node, calibrated_at)

    @property
    def backend(self) -> str | None:
        m = self._measured
        return m[0] if m else None

    @property
    def device_ms(self) -> float | None:
        m = self._measured
        return m[1] if m else None

    @property
    def python_ms_per_node(self) -> float | None:
        m = self._measured
        return m[2] if m else None

    @property
    def calibrated_at(self) -> float | None:
        m = self._measured
        return m[3] if m else None

    def measured_winner(self, n_nodes: int, backend: str) -> str | None:
        """The backend the last published measurement picks for an
        ``n_nodes`` fleet — ``backend`` or "python" — or None when no
        measurement of ``backend`` exists. Ignores the TTL: callers
        decide whether staleness matters."""
        m = self._measured
        if m is None or m[0] != backend:
            return None
        _, device_ms, per_node, _ = m
        return "python" if per_node * n_nodes < device_ms else backend

    def crossover_nodes(self) -> float | None:
        """The fleet size at which the measured backends tie."""
        m = self._measured
        if m is None or m[2] <= 0:
            return None
        return m[1] / m[2]

    def try_begin_probe(self) -> bool:
        return self._probe_lock.acquire(blocking=False)

    def end_probe(self) -> None:
        self._probe_lock.release()

    def expired(self, now: float) -> bool:
        return self.calibrated_at is not None and now - self.calibrated_at > CALIBRATION_TTL_S


calibration = _Calibration()

# Calibration state as scrapeable gauges: /healthz's analytics block and
# /metricsz read the same tuple. Uncalibrated omits the sample.
_metrics_registry.gauge_fn(
    "headlamp_tpu_torch_calibration_device_seconds",
    "Measured device rollup latency from the last calibration probe",
    lambda: calibration.device_ms / 1000.0 if calibration.device_ms is not None else None,
)
_metrics_registry.gauge_fn(
    "headlamp_tpu_torch_calibration_python_per_node_seconds",
    "Measured Python rollup latency per node from the last calibration probe",
    lambda: (
        calibration.python_ms_per_node / 1000.0
        if calibration.python_ms_per_node is not None
        else None
    ),
)


def chosen_backend(n_nodes: int, device: DeviceLike = None) -> str:
    """Which backend the policy would serve an ``n_nodes`` fleet on
    ``device`` right now — "python", the device's backend ("cuda" or
    "torch"), or "calibrating" (probe not yet run, or expired)."""
    if n_nodes < DEVICE_ROLLUP_MIN_NODES:
        return "python"
    backend = device_backend(resolve_device(device))
    winner = calibration.measured_winner(n_nodes, backend)
    if winner is None or calibration.expired(time.monotonic()):
        return "calibrating"
    return winner


def fleet_stats(
    view: FleetView,
    *,
    device: DeviceLike = None,
    fleet_cache: DeviceFleetCache | None = None,
    backend: str | None = None,
    rollup_results: RollupResultCache | None = None,
) -> dict[str, Any]:
    """Serving-path aggregates for one provider view.

    Policy: the Python pass below ``DEVICE_ROLLUP_MIN_NODES``; at scale,
    the first request calibrates (:func:`_calibrate`) and serves the
    device rollup, and every later request serves whichever measured
    faster for its fleet size. ``backend`` pins a path for tests and
    benches ("python", or the device's backend). Nothing falls back: an
    exception from the device rollup propagates.

    Traced as ``analytics.rollup`` with the node count, annotated with
    the backend that served and, for the device rollup, the fleet
    cache's outcome. ``rollup_results`` holds the rollups the fused
    rollup+forecast parked: the device rollup serves one for the view's
    version with no device work."""
    dev = resolve_device(device)
    with _span("analytics.rollup", nodes=len(view.nodes)):
        return _fleet_stats_dispatch(view, dev, fleet_cache, rollup_results, backend)


def _fleet_stats_dispatch(
    view: FleetView,
    device: torch.device,
    fleet_cache: DeviceFleetCache | None,
    rollup_results: RollupResultCache | None,
    backend: str | None,
) -> dict[str, Any]:
    name = device_backend(device)
    if backend is not None:
        if backend == "python":
            return python_fleet_stats(view)
        if backend != name:
            raise ValueError(f"backend {backend!r} does not run on {device}")
        return _device_stats(view, device, fleet_cache, rollup_results)
    n = len(view.nodes)
    choice = chosen_backend(n, device)
    if choice == "calibrating":
        if calibration.try_begin_probe():
            try:
                # Double-check under the lock: a probe that finished
                # between the read above and the acquire already
                # published fresh timings.
                if chosen_backend(n, device) == "calibrating":
                    return _calibrate(view, device, fleet_cache, rollup_results)
            finally:
                calibration.end_probe()
            choice = chosen_backend(n, device)
        elif calibration.measured_winner(n, name) == name:
            # Another request is mid-probe: serve the stale winner.
            choice = name
        else:
            choice = "python"
    if choice == name:
        return _device_stats(view, device, fleet_cache, rollup_results)
    return python_fleet_stats(view)


def _calibrate(
    view: FleetView,
    device: torch.device,
    fleet_cache: DeviceFleetCache | None,
    rollup_results: RollupResultCache | None,
) -> dict[str, Any]:
    """First at-scale request of a window: serve the device rollup (it
    uploads the columns), then time three more device rollups on the
    cached columns — what steady-state requests will serve — and three
    Python passes, and publish the medians. Paid once per window, on the
    request that found the policy uncalibrated."""

    def timed(fn: Callable[[], Any]) -> float:
        samples = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            samples.append((time.perf_counter() - t0) * 1000)
        return statistics.median(samples)

    stats = _device_stats(view, device, fleet_cache, rollup_results)
    with _span("analytics.calibrate", nodes=len(view.nodes)):
        device_ms = timed(lambda: _device_stats(view, device, fleet_cache, rollup_results))
        python_ms = timed(lambda: python_fleet_stats(view))
    calibration.publish(
        backend=device_backend(device),
        device_ms=device_ms,
        python_ms_per_node=python_ms / max(1, len(view.nodes)),
        calibrated_at=time.monotonic(),
    )
    return stats


def _device_stats(
    view: FleetView,
    device: torch.device,
    fleet_cache: DeviceFleetCache | None,
    rollup_results: RollupResultCache | None,
) -> dict[str, Any]:
    """The rollup on ``device`` over the view's columns: the dict the
    fused rollup+forecast parked for the view's version when there is
    one (no device work, `stats.py:453-475` of the JAX package), else
    the rollup on the columns, cached on the device when the fleet cache
    holds the view's version, encoded (and copied by the rollup)
    otherwise."""
    from .encode import encode_fleet
    from .fleet_torch import rollup_to_dict

    _annotate(backend=device_backend(device))
    parked = (
        rollup_results.get(view.provider.name, view.version)
        if rollup_results is not None
        else None
    )
    if parked is not None:
        _annotate(rollup_source="fused")
        parked["generation_counts"] = _generation_counts(view.nodes)
        return parked
    fleet = (
        fleet_cache.fleet_for(view)
        if fleet_cache is not None
        else encode_fleet(view.nodes, view.pods)
    )
    stats = rollup_to_dict(fleet, device)
    # Exact generation names (see _generation_counts): the device-side
    # histogram is fixed-vocabulary; the display histogram is not.
    stats["generation_counts"] = _generation_counts(view.nodes)
    return stats

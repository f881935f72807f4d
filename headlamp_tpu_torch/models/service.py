"""Forecast service: UtilizationHistory → page-ready forecast view.

The glue between the metrics client's range-query output and the
metrics page, as in ``headlamp_tpu/models/service.py``: fit the
forecaster on the fetched traces and summarize per-chip risk. Pages stay
pure — they render a ForecastView; this module owns the torch calls.

A forecast is ``None`` only for the data conditions that say there is
nothing to fit: no metrics snapshot, no chips, or no usable history. An
exception from the fit, the kernel build or the kernel propagates.

With a history store (``history.HistoryStore``), the incremental entry
trains on the captured tier first once it holds one full training
window, with no range query; the view's ``data_source`` says so.

Once the program registry is ready (``models/aot.py``) and a warm carry
meets a versioned TPU fleet of ``DEVICE_ROLLUP_MIN_NODES`` or more, the
fleet rollup and the warm refinement run as one replay of the fused
graph (:func:`_fused_rollup_forecast`), in one device-to-host copy.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

import torch

from ..analytics.encode import GENERATION_IDS, PHASE_IDS
from ..analytics.fleet_torch import COLUMNS
from ..device import DeviceLike, resolve_device
from ..metrics.client import UtilizationHistory, fetch_utilization_history
from ..obs.trace import span
from ..runtime import transfer
from .forecast import (
    _DEMOTION_MSE_FLOOR,
    COLD_MSE_TOLERANCE,
    WARM_STEPS,
    AdamState,
    ForecastConfig,
    InferenceDispatch,
    Params,
    WarmState,
    _as_series,
    _inference_path,
    carry_from_tensors,
    carry_tensors,
    clone_carry,
    fetch_host,
    fit_and_forecast_incremental,
    fit_and_forecast_with_dispatch,
    pad_series_to_bucket,
)


@dataclass
class ChipForecast:
    node: str
    accelerator_id: str
    current: float
    predicted_peak: float
    predicted_mean: float
    #: True when the chip is predicted to cross the 90% saturation line
    #: within the horizon.
    saturation_risk: bool


@dataclass
class ForecastView:
    horizon_s: int
    window_s: int
    chips: list[ChipForecast] = field(default_factory=list)
    fit_ms: float = 0.0
    #: Inference path that served the prediction: "cuda[-warm]" for the
    #: fused CUDA kernel, "torch[-warm]" for its plain version on the
    #: CPU, "repeat" for persistence.
    inference_path: str = "cuda"
    #: Kept for field parity with the JAX view; always None here.
    inference_fallback_reason: str | None = None
    #: Final training MSE of the online fit (None on the persistence path).
    fit_mse: float | None = None
    #: Generation of the warm-start carry this fit refined; None when the
    #: fit was from-scratch cold with no carry consulted.
    carried_from_generation: int | None = None
    #: Why a warm refinement self-demoted to a cold refit.
    warm_demotion_reason: str | None = None
    #: What the fit trained on: "live-window" for a fresh range query,
    #: "history" for the captured tier.
    data_source: str = "live-window"

    @property
    def at_risk(self) -> list[ChipForecast]:
        return [c for c in self.chips if c.saturation_risk]


#: Saturation line shared with the UI kit's critical threshold.
SATURATION_PCT = 90.0


def _fetch_history(
    transport: Any, metrics: Any, clock: Callable[[], float] | None
) -> UtilizationHistory | None:
    return fetch_utilization_history(
        transport,
        prometheus=(metrics.namespace, metrics.service),
        clock=clock or time.time,
        preferred_query=metrics.resolved_series.get("tensorcore_utilization"),
    )


def compute_forecast(
    transport: Any,
    metrics: Any,
    *,
    clock: Callable[[], float] | None = None,
    device: DeviceLike = None,
) -> ForecastView | None:
    """Metrics-route glue: fetch history for the snapshot's Prometheus
    and fit. None when there are no metrics, no chips or no usable
    history."""
    dev = resolve_device(device)
    if metrics is None or not metrics.chips:
        return None
    history = _fetch_history(transport, metrics, clock)
    if history is None:
        return None
    return forecast_from_history(history, device=dev)


def forecast_from_history(
    history: UtilizationHistory,
    cfg: ForecastConfig | None = None,
    *,
    steps: int = 60,
    init: Params | None = None,
    device: DeviceLike = None,
) -> ForecastView:
    """Fit + predict + summarize. Deterministic (fixed seed, or the
    given ``init`` params)."""
    cfg = cfg or ForecastConfig()
    dev = resolve_device(device)
    t0 = time.perf_counter()
    preds, dispatch = fit_and_forecast_with_dispatch(
        np.asarray(history.series, dtype=np.float32), cfg,
        steps=steps, init=init, device=dev,
    )
    if dispatch.fit_mse is not None:
        # Predictions and the fit-quality scalar in one device copy.
        preds_host, fit_mse = fetch_host(preds, dispatch.fit_mse)
    else:
        preds_host, fit_mse = transfer.fetch(preds).numpy(), None
    fit_ms = round((time.perf_counter() - t0) * 1000, 1)
    return _summarize(history, cfg, preds_host, dispatch, fit_ms, fit_mse)


def _summarize(
    history: UtilizationHistory,
    cfg: ForecastConfig,
    preds: np.ndarray,
    dispatch: InferenceDispatch,
    fit_ms: float,
    fit_mse: float | None,
) -> ForecastView:
    """Host-side per-chip risk summary shared by the cold and warm
    entries — one definition so they cannot drift on what "at risk"
    means."""
    chips = []
    for key, trace, pred in zip(history.keys, history.series, preds):
        peak = float(pred.max())
        chips.append(
            ChipForecast(
                node=key[0],
                accelerator_id=key[1],
                current=float(trace[-1]),
                predicted_peak=peak,
                predicted_mean=float(pred.mean()),
                saturation_risk=peak * 100 >= SATURATION_PCT,
            )
        )
    chips.sort(key=lambda c: -c.predicted_peak)
    n_samples = len(history.series[0]) if history.series else 0
    return ForecastView(
        horizon_s=cfg.horizon * history.step_s,
        # The fit consumes the WHOLE fetched trace (sliding windows over
        # all of it), so report that — not cfg.window — as the history
        # span shown to operators.
        window_s=max(0, (n_samples - 1)) * history.step_s,
        chips=chips,
        fit_ms=fit_ms,
        inference_path=dispatch.path,
        inference_fallback_reason=dispatch.fallback_reason,
        fit_mse=fit_mse,
        carried_from_generation=dispatch.carried_from_generation,
        warm_demotion_reason=dispatch.warm_demotion_reason,
        data_source=dispatch.data_source,
    )


def forecast_from_history_incremental(
    history: UtilizationHistory,
    cfg: ForecastConfig | None = None,
    *,
    state: WarmState | None = None,
    steps: int = 60,
    warm_steps: int = WARM_STEPS,
    init: Params | None = None,
    device: DeviceLike = None,
    data_source: str = "live-window",
) -> tuple[ForecastView, WarmState | None]:
    """Warm-start variant of :func:`forecast_from_history`: refines the
    carried :class:`WarmState` and returns the new carry with the view.
    ``data_source`` names what ``history`` is ("history" for the
    captured tier, "live-window" for a fresh range query) and is stamped
    into the dispatch record the view mirrors and into the fit's span."""
    cfg = cfg or ForecastConfig()
    dev = resolve_device(device)
    t0 = time.perf_counter()
    with span(
        "forecast.fit", series=len(history.series), steps=steps, warm=state is not None
    ) as fit_span:
        preds, dispatch, new_state = fit_and_forecast_incremental(
            np.asarray(history.series, dtype=np.float32), cfg,
            state=state, steps=steps, warm_steps=warm_steps, init=init, device=dev,
        )
        dispatch = dispatch._replace(data_source=data_source)
        if fit_span is not None:
            fit_span.attrs["inference_path"] = dispatch.path
            fit_span.attrs["data_source"] = data_source
    fit_ms = round((time.perf_counter() - t0) * 1000, 1)
    fit_mse = None if dispatch.fit_mse is None else float(dispatch.fit_mse)
    view = _summarize(history, cfg, preds, dispatch, fit_ms, fit_mse)
    return view, new_state


def _fused_rollup_forecast(
    history: UtilizationHistory,
    cfg: ForecastConfig,
    state: WarmState | None,
    fleet_view: Any,
    data_source: str,
    *,
    device: torch.device,
    fleet_cache: Any,
    rollup_results: Any,
) -> tuple[ForecastView, WarmState | None] | None:
    """Serve the fleet rollup AND the warm refinement from one replay of
    the ``fused.rollup_and_forecast`` graph (`service.py:274-423` of the
    JAX package): the context's device-resident columns and the carry
    are copied into its static inputs, and the rollup, the predictions
    and the MSE cross to the host in ONE ``transfer.fetch``. The rollup's
    host dict is parked in the context's ``rollup_results``, so the
    overview's ``fleet_stats`` for the same snapshot version does no
    device work.

    Returns ``(view, new_state)``, or None when the fused path does not
    serve and the caller takes the split path: the registry is not ready;
    the view is unversioned, not the TPU provider's or under
    ``DEVICE_ROLLUP_MIN_NODES``; the series is too short; there is no
    carry or it does not match; or no bucket covers the shape (a novel
    shape schedules a background capture for the next request). A replay
    that raises propagates."""
    from ..analytics.fleet_torch import rollup_host_view, rollup_key, unpack_rollup
    from ..analytics.stats import DEVICE_ROLLUP_MIN_NODES
    from . import aot

    reg = aot.registry()
    if not reg.ready():
        return None
    if fleet_view is None or fleet_view.version is None or fleet_cache is None:
        return None
    if fleet_view.provider.name != "tpu":
        return None
    if len(fleet_view.nodes) < DEVICE_ROLLUP_MIN_NODES:
        # Below the floor the Python rollup serves the overview: fusing
        # would force device work the policy avoids.
        return None
    series = _as_series(history.series, device)
    n_chips, length = series.shape
    if length < cfg.window + cfg.horizon:
        return None
    if state is None or state.cfg != cfg or state.n_chips != n_chips:
        return None
    bucket = aot.chip_bucket_for(n_chips)
    if bucket is None:
        reg.note_bucket_miss(aot.FUSED_PROGRAM)
        return None
    fleet = fleet_cache.fleet_for(fleet_view)
    key = (*rollup_key(fleet), bucket, length, cfg, WARM_STEPS)
    program = reg.executable(aot.FUSED_PROGRAM, key, device)
    if program is None:
        reg.ensure(aot.FUSED_PROGRAM, key, device)
        return None

    t0 = time.perf_counter()
    padded, weights = pad_series_to_bucket(series, bucket)
    carry = carry_tensors(state.params, state.opt_state)
    cols = [getattr(fleet, name).to(device) for name in COLUMNS]
    n_rollup = 8 + len(PHASE_IDS) + len(GENERATION_IDS) + fleet.n_nodes_padded

    def finish(outputs: tuple[torch.Tensor, ...]) -> tuple[np.ndarray, Params, AdamState]:
        packed, out, mse = outputs[0], outputs[1], outputs[-1]
        kept = clone_carry(*carry_from_tensors(outputs[2:-1]))
        host = transfer.fetch(torch.cat(
            (packed, out[:n_chips].reshape(-1).double(), mse.reshape(1).double())
        ))
        return host.numpy(), *kept

    with span("forecast.fused", nodes=len(fleet_view.nodes), chips=n_chips):
        host, params, opt_state = reg.replay(
            aot.FUSED_PROGRAM, key, program, [*cols, padded, weights, *carry], finish,
            donated=sum(t.numel() * t.element_size() for t in carry),
        )
    preds = host[n_rollup:-1].astype(np.float32).reshape(n_chips, cfg.horizon)
    warm_mse = float(host[-1])
    rollup_results.store(
        fleet_view.provider.name,
        fleet_view.version,
        rollup_host_view(unpack_rollup(torch.from_numpy(host[:n_rollup])), fleet.n_nodes),
    )

    bound = COLD_MSE_TOLERANCE * max(state.cold_mse, _DEMOTION_MSE_FLOOR)
    if warm_mse > bound:
        # The classic demotion: the refinement is thrown away and a cold
        # refit runs (the parked rollup stands: it never read the carry),
        # with the lineage stitched so the record says which generation
        # was consulted and why it was rejected.
        reason = (
            f"warm mse {warm_mse:.3g} > {COLD_MSE_TOLERANCE:g}x "
            f"cold {state.cold_mse:.3g}"
        )
        view, new_state = forecast_from_history_incremental(
            history, cfg, state=None, device=device, data_source=data_source
        )
        if new_state is not None:
            new_state = new_state._replace(generation=state.generation + 1)
        view.carried_from_generation = state.generation
        view.warm_demotion_reason = reason
        return view, new_state

    new_state = WarmState(params, opt_state, state.cold_mse, state.generation, cfg, n_chips)
    dispatch = InferenceDispatch(
        f"{_inference_path(device)}-warm", fit_mse=warm_mse,
        carried_from_generation=state.generation, data_source=data_source,
    )
    fit_ms = round((time.perf_counter() - t0) * 1000, 1)
    return _summarize(history, cfg, preds, dispatch, fit_ms, warm_mse), new_state


def compute_forecast_incremental(
    transport: Any,
    metrics: Any,
    *,
    state: WarmState | None = None,
    clock: Callable[[], float] | None = None,
    device: DeviceLike = None,
    history_store: Any = None,
    fleet_view: Any = None,
    fleet_cache: Any = None,
    rollup_results: Any = None,
) -> tuple[ForecastView | None, WarmState | None]:
    """:func:`compute_forecast` with the warm-start carry: returns
    ``(view, new_state)``. Without metrics, chips or usable history it
    returns ``(None, state)``, so the carry survives a thin scrape.

    With a ``history_store`` the captured tier is consulted first: once
    it holds one full training window (``window + horizon`` points) of
    aligned per-chip scrapes, the fit trains on it with no range query
    and ``data_source="history"``. A thin store falls through to the
    live range query.

    Both branches try the fused rollup+forecast first
    (:func:`_fused_rollup_forecast`) with the published TPU ``fleet_view``
    and its context's ``fleet_cache`` and ``rollup_results``, as JAX does
    at `service.py:463` and `:480`; when it declines they take the split
    path."""
    dev = resolve_device(device)
    if metrics is None or not metrics.chips:
        return None, state
    cfg = ForecastConfig()

    def fused(history: UtilizationHistory, data_source: str) -> Any:
        return _fused_rollup_forecast(
            history, cfg, state, fleet_view, data_source,
            device=dev, fleet_cache=fleet_cache, rollup_results=rollup_results,
        )

    if history_store is not None:
        # length >= window + horizon is the fit's floor (below it the
        # incremental entry serves persistence): requiring it keeps
        # "history" meaning "trained on history".
        captured = history_store.utilization_history(
            clock=clock or time.time, min_points=cfg.window + cfg.horizon
        )
        if captured is not None:
            served = fused(captured, "history")
            if served is not None:
                return served
            return forecast_from_history_incremental(
                captured, cfg, state=state, device=dev, data_source="history"
            )
    with span("forecast.history"):
        history = _fetch_history(transport, metrics, clock)
    if history is None:
        return None, state
    served = fused(history, "live-window")
    if served is not None:
        return served
    return forecast_from_history_incremental(history, state=state, device=dev)

"""Forecast service: UtilizationHistory → page-ready forecast view.

The glue between the metrics client's range-query output and the
metrics page, as in ``headlamp_tpu/models/service.py``: fit the
forecaster on the fetched traces and summarize per-chip risk. Pages stay
pure — they render a ForecastView; this module owns the torch calls.

A forecast is ``None`` only for the data conditions that say there is
nothing to fit: no metrics snapshot, no chips, or no usable history. An
exception from the fit, the kernel build or the kernel propagates.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from ..device import DeviceLike, resolve_device
from ..metrics.client import UtilizationHistory, fetch_utilization_history
from .forecast import (
    WARM_STEPS,
    ForecastConfig,
    InferenceDispatch,
    Params,
    WarmState,
    fetch_host,
    fit_and_forecast_incremental,
    fit_and_forecast_with_dispatch,
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
    #: What the fit trained on ("live-window" for a fresh range query).
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
        preds_host, fit_mse = preds.cpu().numpy(), None
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
) -> tuple[ForecastView, WarmState | None]:
    """Warm-start variant of :func:`forecast_from_history`: refines the
    carried :class:`WarmState` and returns the new carry with the view."""
    cfg = cfg or ForecastConfig()
    dev = resolve_device(device)
    t0 = time.perf_counter()
    preds, dispatch, new_state = fit_and_forecast_incremental(
        np.asarray(history.series, dtype=np.float32), cfg,
        state=state, steps=steps, warm_steps=warm_steps, init=init, device=dev,
    )
    fit_ms = round((time.perf_counter() - t0) * 1000, 1)
    fit_mse = None if dispatch.fit_mse is None else float(dispatch.fit_mse)
    view = _summarize(history, cfg, preds, dispatch, fit_ms, fit_mse)
    return view, new_state


def compute_forecast_incremental(
    transport: Any,
    metrics: Any,
    *,
    state: WarmState | None = None,
    clock: Callable[[], float] | None = None,
    device: DeviceLike = None,
) -> tuple[ForecastView | None, WarmState | None]:
    """:func:`compute_forecast` with the warm-start carry on the
    live-window path: returns ``(view, new_state)``. Without metrics,
    chips or usable history it returns ``(None, state)``, so the carry
    survives a thin scrape."""
    dev = resolve_device(device)
    if metrics is None or not metrics.chips:
        return None, state
    history = _fetch_history(transport, metrics, clock)
    if history is None:
        return None, state
    return forecast_from_history_incremental(history, state=state, device=dev)

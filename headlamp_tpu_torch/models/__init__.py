"""Models — the utilization forecaster on PyTorch.

Counterpart of ``headlamp_tpu/models``: the MLP forecaster over per-chip
utilization windows, its online Adam fit with warm starts, the fused
CUDA inference kernel's wrapper (:mod:`.fused_forward`) and the service
glue that turns a utilization history into the metrics page's view
(:mod:`.service`).
"""

from .forecast import (
    AdamState,
    ForecastConfig,
    ForecastMLP,
    InferenceDispatch,
    WarmState,
    fit_and_forecast,
    fit_and_forecast_incremental,
    fit_and_forecast_with_dispatch,
    forecast_next,
    forecast_next_with_dispatch,
    forward,
    init_params,
    loss_fn,
    make_train_step,
    make_windows,
    synthetic_telemetry,
)

__all__ = [
    "AdamState",
    "ForecastConfig",
    "ForecastMLP",
    "InferenceDispatch",
    "WarmState",
    "fit_and_forecast",
    "fit_and_forecast_incremental",
    "fit_and_forecast_with_dispatch",
    "forecast_next",
    "forecast_next_with_dispatch",
    "forward",
    "init_params",
    "loss_fn",
    "make_train_step",
    "make_windows",
    "synthetic_telemetry",
]

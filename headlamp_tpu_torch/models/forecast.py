"""Utilization forecaster: windows of chip telemetry → near-future load.

The PyTorch counterpart of ``headlamp_tpu/models/forecast.py``. Three
dense layers (window 32 → hidden 128 → hidden 128 → horizon 8) with
bf16-rounded matmul operands and f32 products, sums, biases and
activations, as the JAX forward computes them. Parameters keep the JAX
names and the ``[in, out]`` weight layout (``w1 b1 w2 b2 w3 b3``), so
the JAX package's params load as they are (see :mod:`.convert`).

The model is fit online on each chip's utilization history every time
the metrics page is built: 60 Adam steps cold, 10 warm from a carried
:class:`WarmState`. The fit is torch ops (forward, autograd, an explicit
Adam that matches ``optax.adam``); inference on each chip's latest window
is the fused CUDA kernel on a CUDA device and its plain PyTorch version
on the CPU (:mod:`.fused_forward`). Nothing falls back: an exception from
the fit, the kernel build or the kernel propagates to the caller.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device

Params = dict[str, torch.Tensor]

#: Parameter names, in the order the JAX params dict lists them.
PARAM_NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


@dataclass(frozen=True)
class ForecastConfig:
    window: int = 32      #: history samples per example
    hidden: int = 128     #: hidden width
    horizon: int = 8      #: future samples predicted
    learning_rate: float = 1e-3


def init_params(
    generator: torch.Generator, cfg: ForecastConfig, *, device: DeviceLike = None
) -> Params:
    """Glorot-normal weights (``normal * sqrt(2 / (fan_in + fan_out))``)
    and zero biases, drawn on the CPU from ``generator`` so a seed gives
    the same params on every device."""
    dev = resolve_device(device)

    def glorot(shape: tuple[int, int]) -> torch.Tensor:
        scale = math.sqrt(2.0 / (shape[0] + shape[1]))
        return torch.randn(shape, generator=generator, dtype=torch.float32) * scale

    params = {
        "w1": glorot((cfg.window, cfg.hidden)),
        "b1": torch.zeros(cfg.hidden),
        "w2": glorot((cfg.hidden, cfg.hidden)),
        "b2": torch.zeros(cfg.hidden),
        "w3": glorot((cfg.hidden, cfg.horizon)),
        "b3": torch.zeros(cfg.horizon),
    }
    return {name: t.to(dev) for name, t in params.items()}


def _bf16_operand(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and widen back: the product of two such values is
    exact in f32, so the matmul below has bf16 operands with f32
    products and accumulation, like ``preferred_element_type=float32``."""
    return t.to(torch.bfloat16).to(torch.float32)


def _dense_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _bf16_operand(x) @ _bf16_operand(w) + b


def forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """[batch, window] -> [batch, horizon] utilization fractions in
    [0, 1]. GELU is the tanh form, ``jax.nn.gelu``'s default."""
    h = F.gelu(_dense_bf16(x, params["w1"], params["b1"]), approximate="tanh")
    h = F.gelu(_dense_bf16(h, params["w2"], params["b2"]), approximate="tanh")
    return torch.sigmoid(_dense_bf16(h, params["w3"], params["b3"]))


def loss_fn(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((forward(params, x) - y) ** 2)


class ForecastMLP(nn.Module):
    """The forecaster as a module. Its parameters carry the JAX names
    and ``[in, out]`` layout; construction copies ``params``, so the
    module never aliases a caller's (or a carried state's) tensors."""

    def __init__(self, params: Params) -> None:
        super().__init__()
        for name in PARAM_NAMES:
            self.register_parameter(
                name, nn.Parameter(params[name].detach().clone())
            )

    def as_params(self) -> Params:
        """The live parameters as a params dict (autograd-tracked)."""
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def detached_params(self) -> Params:
        return {name: p.detach() for name, p in self.as_params().items()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # noqa: D102
        return forward(self.as_params(), x)


# ---------------------------------------------------------------------------
# Synthetic telemetry (deterministic; demos/tests/the chip smoke run)
# ---------------------------------------------------------------------------

def synthetic_telemetry(
    n_series: int,
    length: int,
    generator: torch.Generator | None = None,
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """[n_series, length] utilization traces: per-chip base load + two
    harmonics + noise, clipped to [0, 1]. Drawn on the CPU from
    ``generator`` (seed 20260729 when omitted), so they reproduce."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(20260729)
    t = torch.arange(length, dtype=torch.float32)
    base = 0.25 + 0.45 * torch.rand((n_series, 1), generator=g)
    phase = 2 * math.pi * torch.rand((n_series, 2), generator=g)
    wave = 0.18 * torch.sin(t[None, :] / 17.0 + phase[:, :1]) + 0.09 * torch.sin(
        t[None, :] / 5.0 + phase[:, 1:]
    )
    noise = 0.04 * torch.randn((n_series, length), generator=g)
    return torch.clamp(base + wave + noise, 0.0, 1.0).to(dev)


def make_windows(
    series: torch.Tensor, window: int, horizon: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sliding (x, y) examples from [n_series, length] traces, flattened
    across series (series-major, as the JAX gather orders them)."""
    n_series, length = series.shape
    n_pos = length - window - horizon + 1
    if n_pos <= 0:
        raise ValueError("series shorter than window + horizon")
    examples = series.unfold(1, window + horizon, 1)  # [n_series, n_pos, w+h]
    x = examples[..., :window].reshape(n_series * n_pos, window)
    y = examples[..., window:].reshape(n_series * n_pos, horizon)
    return x, y


# ---------------------------------------------------------------------------
# Adam, matching optax.adam(learning_rate) with its defaults
# ---------------------------------------------------------------------------

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


class AdamState(NamedTuple):
    """Counterpart of optax's ``ScaleByAdamState``: the step count (an
    int32 device scalar) and the first and second moments per param."""

    count: torch.Tensor
    mu: Params
    nu: Params


def adam_init(params: Params) -> AdamState:
    any_param = next(iter(params.values()))
    return AdamState(
        torch.zeros((), dtype=torch.int32, device=any_param.device),
        {name: torch.zeros_like(p) for name, p in params.items()},
        {name: torch.zeros_like(p) for name, p in params.items()},
    )


def _clone_adam(state: AdamState, device: torch.device) -> AdamState:
    return AdamState(
        state.count.to(device).clone(),
        {name: t.to(device).clone() for name, t in state.mu.items()},
        {name: t.to(device).clone() for name, t in state.nu.items()},
    )


@torch.no_grad()
def adam_update_(
    params: Params, grads: Params, state: AdamState, learning_rate: float
) -> None:
    """One Adam step, in place on ``params`` and ``state`` (the port
    updates in place where JAX returns new arrays). Bias-corrected as in
    optax's ``scale_by_adam``; the count stays on the device, so the
    step never syncs the host."""
    state.count.add_(1)
    count = state.count.to(torch.float32)
    bias1 = 1.0 - torch.pow(ADAM_B1, count)
    bias2 = 1.0 - torch.pow(ADAM_B2, count)
    for name, g in grads.items():
        mu, nu = state.mu[name], state.nu[name]
        mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
        nu.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
        update = (mu / bias1) / (torch.sqrt(nu / bias2) + ADAM_EPS)
        params[name].sub_(learning_rate * update)


def _train(
    x: torch.Tensor,
    y: torch.Tensor,
    params: Params,
    opt_state: AdamState,
    cfg: ForecastConfig,
    steps: int,
) -> tuple[Params, AdamState, torch.Tensor]:
    """THE training loop: the cold fit is this loop from a fresh init,
    the warm fit this loop from a carry, so the two never train
    different models. Returns new (params, opt_state, final MSE); the
    inputs are copied, never modified. The MSE is taken at the RETURNED
    params (one more loss after the last step), as a device scalar."""
    model = ForecastMLP(params)
    state = _clone_adam(opt_state, x.device)
    live = model.as_params()
    weights = list(live.values())
    for _ in range(steps):
        loss = loss_fn(live, x, y)
        grads = torch.autograd.grad(loss, weights)
        adam_update_(live, dict(zip(live, grads)), state, cfg.learning_rate)
    fitted = model.detached_params()
    with torch.no_grad():
        final = loss_fn(fitted, x, y)
    return fitted, state, final


# ---------------------------------------------------------------------------
# Fit + forecast entry points
# ---------------------------------------------------------------------------

class InferenceDispatch(NamedTuple):
    """Which inference path served a forecast, with the fit's record."""

    #: "cuda[-warm]" (the fused CUDA kernel), "torch[-warm]" (its plain
    #: PyTorch version, on the CPU) or "repeat" (persistence, no model).
    path: str
    #: Kept from the JAX record for field parity; always None here, as
    #: the port has no fallback path.
    fallback_reason: str | None = None
    #: Final training MSE: a device scalar from the cold entry (the
    #: caller fetches it with the predictions in one copy), a host float
    #: from the incremental entry. None on the persistence path.
    fit_mse: Any = None
    #: Generation of the WarmState this fit consulted (warm, or demoted
    #: to cold); None on a from-scratch cold fit.
    carried_from_generation: int | None = None
    #: Why a warm refinement was thrown away for a cold refit.
    warm_demotion_reason: str | None = None
    #: What the fit trained on: the port has only the live range query.
    data_source: str = "live-window"

    @property
    def warm(self) -> bool:
        return self.path.endswith("-warm")


def _inference_path(device: torch.device) -> str:
    return "cuda" if device.type == "cuda" else "torch"


def _as_series(series: Any, device: torch.device) -> torch.Tensor:
    if isinstance(series, torch.Tensor):
        return series.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(series, dtype=np.float32), device=device)


def _on(params: Params, device: torch.device) -> Params:
    return {name: params[name].to(device=device, dtype=torch.float32) for name in PARAM_NAMES}


def _initial_params(
    init: Params | None, seed: int, cfg: ForecastConfig, device: torch.device
) -> Params:
    """The cold fit's starting point: ``init`` when given, else the
    params seeded by ``seed``."""
    if init is not None:
        return _on(init, device)
    return init_params(torch.Generator().manual_seed(seed), cfg, device=device)


def _repeat_last(series: torch.Tensor, horizon: int) -> torch.Tensor:
    """Persistence: repeat each trace's last value over the horizon."""
    return series[:, -1:].repeat(1, horizon)


def _infer_recent(
    params: Params, series: torch.Tensor, cfg: ForecastConfig
) -> torch.Tensor:
    """Predict the next horizon from each trace's latest window: the
    fused kernel on a CUDA device, its plain version on the CPU."""
    from .fused_forward import forecast_forward

    return forecast_forward(params, series[:, -cfg.window:].contiguous())


def fetch_host(preds: torch.Tensor, mse: torch.Tensor) -> tuple[np.ndarray, float]:
    """Predictions and the fit MSE to the host in ONE device copy."""
    host = torch.cat((preds.reshape(-1), mse.reshape(1).to(preds.dtype))).cpu()
    return host[:-1].reshape(preds.shape).numpy(), float(host[-1])


def fit_and_forecast_with_dispatch(
    series: Any,
    cfg: ForecastConfig | None = None,
    *,
    steps: int = 60,
    seed: int = 0,
    init: Params | None = None,
    device: DeviceLike = None,
) -> tuple[torch.Tensor, InferenceDispatch]:
    """Cold online fit on the given traces, then predict the next
    horizon from each trace's latest window: [n_chips, T] ->
    ([n_chips, horizon] on the device, dispatch record whose ``fit_mse``
    is a device scalar). ``init`` replaces the seeded initial params
    (tests start from the JAX package's init). Traces shorter than
    window + horizon get persistence, recorded as path "repeat"."""
    cfg = cfg or ForecastConfig()
    dev = resolve_device(device)
    series = _as_series(series, dev)
    if series.shape[1] < cfg.window + cfg.horizon:
        return _repeat_last(series, cfg.horizon), InferenceDispatch("repeat")
    params = _initial_params(init, seed, cfg, dev)
    x, y = make_windows(series, cfg.window, cfg.horizon)
    params, _, mse = _train(x, y, params, adam_init(params), cfg, steps)
    out = _infer_recent(params, series, cfg)
    return out, InferenceDispatch(_inference_path(dev), fit_mse=mse)


# ---------------------------------------------------------------------------
# Warm-start incremental fitting
# ---------------------------------------------------------------------------

#: Refinement steps for a warm fit: the carried params already sit near
#: a minimum for this fleet's dynamics; ~1/6 of the cold budget tracks
#: the drift between refreshes.
WARM_STEPS = 10

#: A warm fit whose final MSE exceeds ``tolerance × last cold MSE``
#: self-demotes to a cold refit.
COLD_MSE_TOLERANCE = 2.0

#: Absolute MSE floor for the demotion comparison: near-zero cold MSEs
#: (flat traces) would otherwise make any warm fit look like a regression.
_DEMOTION_MSE_FLOOR = 1e-4


class WarmState(NamedTuple):
    """Fitted params + optimizer state carried across refreshes.
    ``cold_mse`` anchors the demotion check; ``generation`` counts cold
    fits for this carry's lineage."""

    params: Params
    opt_state: AdamState
    cold_mse: float        #: host float — the fetch was already paid
    generation: int        #: increments on every cold (re)fit
    cfg: ForecastConfig    #: carry is invalid if the caller's cfg changed
    n_chips: int           #: a fleet resize means different dynamics


def fit_and_forecast_incremental(
    series: Any,
    cfg: ForecastConfig | None = None,
    *,
    state: WarmState | None = None,
    steps: int = 60,
    warm_steps: int = WARM_STEPS,
    seed: int = 0,
    init: Params | None = None,
    device: DeviceLike = None,
) -> tuple[np.ndarray, InferenceDispatch, WarmState | None]:
    """Warm-start entry: refine the carried :class:`WarmState` with a
    short fit instead of refitting from scratch.

    Returns ``(host predictions, dispatch, new_state)``; the dispatch's
    ``fit_mse`` is a host float, fetched with the predictions in one
    copy. Demotion policy, always recorded in ``warm_demotion_reason``:
    a carry whose cfg or chip count differs, or a warm fit whose final
    MSE exceeds ``COLD_MSE_TOLERANCE × max(cold_mse, 1e-4)``, is
    replaced by a cold refit. An exception propagates; it does not
    demote. Persistence ("repeat") passes the state through untouched."""
    cfg = cfg or ForecastConfig()
    dev = resolve_device(device)
    series = _as_series(series, dev)
    n_chips, length = series.shape
    if length < cfg.window + cfg.horizon:
        preds = _repeat_last(series, cfg.horizon).cpu().numpy()
        return preds, InferenceDispatch("repeat"), state

    path = _inference_path(dev)
    x, y = make_windows(series, cfg.window, cfg.horizon)
    demotion: str | None = None
    carried_gen: int | None = None
    if state is not None:
        carried_gen = state.generation
        if state.cfg != cfg or state.n_chips != n_chips:
            demotion = (
                f"carry mismatch: cfg/fleet changed "
                f"(chips {state.n_chips}->{n_chips})"
            )
        else:
            params, opt_state, mse = _train(
                x, y, _on(state.params, dev), state.opt_state, cfg, warm_steps
            )
            preds, warm_mse = fetch_host(_infer_recent(params, series, cfg), mse)
            bound = COLD_MSE_TOLERANCE * max(state.cold_mse, _DEMOTION_MSE_FLOOR)
            if warm_mse > bound:
                demotion = (
                    f"warm mse {warm_mse:.3g} > {COLD_MSE_TOLERANCE:g}x "
                    f"cold {state.cold_mse:.3g}"
                )
            else:
                new_state = WarmState(
                    params, opt_state, state.cold_mse, state.generation, cfg, n_chips
                )
                dispatch = InferenceDispatch(
                    f"{path}-warm", fit_mse=warm_mse,
                    carried_from_generation=state.generation,
                )
                return preds, dispatch, new_state

    # Cold fit — from scratch, or demoted from a rejected warm attempt.
    params = _initial_params(init, seed, cfg, dev)
    params, opt_state, mse = _train(x, y, params, adam_init(params), cfg, steps)
    preds, cold_mse = fetch_host(_infer_recent(params, series, cfg), mse)
    generation = (state.generation + 1) if state is not None else 0
    new_state = WarmState(params, opt_state, cold_mse, generation, cfg, n_chips)
    dispatch = InferenceDispatch(
        path, fit_mse=cold_mse,
        carried_from_generation=carried_gen,
        warm_demotion_reason=demotion,
    )
    return preds, dispatch, new_state

"""The port's CUDA kernel on the card: its wrapper against its plain
version at widths and batches the CPU tests cannot reach, its operand
checks, its replay inside a CUDA graph, and the fit on the card against
the same fit on the CPU. The kernel has no CPU mode, so every test here
needs a CUDA device and skips without one. On the card:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from headlamp_tpu_torch.models import forecast as tf
from headlamp_tpu_torch.models import fused_forward as ff
from headlamp_tpu_torch.models.forecast import (
    ForecastConfig,
    fit_and_forecast_incremental,
    init_params,
    synthetic_telemetry,
)

#: Kernel against its plain version, max-abs (chip_smoke.py's bound).
KERNEL_TOL = 1e-3
#: Params after 5 Adam steps on the card against the same steps on the
#: CPU, max-abs: the devices sum in another order and nothing else.
STEP_TOL = 1e-4
#: 60-step fit on the card against the CPU's, predictions max-abs and MSE
#: relative. Adam amplifies f32 summation-order noise over 60 steps: the
#: CPU fit moves this far (up to about 3e-2) when its input moves by one
#: ulp, which the test measures and prints beside the card's difference.
FIT_TOL = 5e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _params(window, hidden, horizon, device, seed=0):
    """Seeded params with non-zero biases, on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    cfg = ForecastConfig(window=window, hidden=hidden, horizon=horizon)
    params = init_params(gen, cfg, device="cpu")
    return {k: (v + 0.05 * torch.randn(v.shape, generator=gen)).to(device)
            for k, v in params.items()}


def _rows(rows, window, device):
    return torch.rand((rows, window), generator=torch.Generator().manual_seed(rows)).to(device)


@pytest.mark.parametrize(
    "rows,window,hidden,horizon",
    [
        (65, 32, 128, 8),      # one full 64-row tile and a one-row tail
        (300, 5, 20, 3),       # widths that fill no warp; ragged tail
        (129, 128, 128, 128),  # every dimension at the guard's limit
        (7, 1, 1, 1),
    ],
)
def test_kernel_matches_plain_version(cuda, rows, window, hidden, horizon):
    params = _params(window, hidden, horizon, cuda)
    x = _rows(rows, window, cuda)
    before = ff.LAUNCHES.n
    got = ff.forecast_forward(params, x)
    assert ff.LAUNCHES.n == before + 1
    want = ff.forecast_forward_reference(params, x)
    assert got.shape == (rows, horizon) and got.device.type == "cuda"
    assert float((got - want).abs().max()) <= KERNEL_TOL


def test_wrapper_rejects_bad_operands(cuda):
    params = _params(32, 128, 8, cuda)
    x = _rows(4, 32, cuda)
    with pytest.raises(TypeError):
        ff.forecast_forward_cuda(params, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        ff.forecast_forward_cuda(params, _rows(32, 4, cuda).t())
    with pytest.raises(ValueError, match="is on"):
        ff.forecast_forward_cuda(dict(params, b1=params["b1"].cpu()), x)
    with pytest.raises(ValueError, match="single-tile"):
        ff.forecast_forward_cuda(dict(params, w1=torch.zeros((32, 256), device=cuda)), x)


def test_kernel_replays_in_a_cuda_graph(cuda):
    # The wrapper never syncs the host, so it can be captured; the replay
    # reads the captured input buffer anew.
    params = _params(32, 128, 8, cuda)
    x = _rows(256, 32, cuda)
    ff.forecast_forward_cuda(params, x)  # build and configure outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ff.forecast_forward_cuda(params, x)
    x.copy_(_rows(256, 32, "cpu").flip(0))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ff.forecast_forward_cuda(params, x))


def test_training_steps_on_card_match_cpu(cuda):
    cfg = ForecastConfig()
    x, y = tf.make_windows(synthetic_telemetry(64, 61, device="cpu"), cfg.window, cfg.horizon)
    init = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    diffs = {}
    for steps in (1, 5, 20, 60):
        on_cpu, _, _ = tf._train(x, y, init, tf.adam_init(init), cfg, steps)
        card_init = {k: v.to(cuda) for k, v in init.items()}
        on_card, _, _ = tf._train(
            x.to(cuda), y.to(cuda), card_init, tf.adam_init(card_init), cfg, steps
        )
        diffs[steps] = max(float((on_cpu[k] - on_card[k].cpu()).abs().max()) for k in on_cpu)
    print("card vs CPU params max-abs by steps:", {k: f"{v:.3g}" for k, v in diffs.items()})
    assert diffs[5] <= STEP_TOL


def test_fit_on_card_matches_cpu(cuda):
    series = synthetic_telemetry(64, 61, device="cpu").numpy()
    on_card, card, _ = fit_and_forecast_incremental(series, device=cuda)
    on_cpu, cpu, _ = fit_and_forecast_incremental(series, device="cpu")
    nudged, cpu_nudged, _ = fit_and_forecast_incremental(
        np.nextafter(series, np.float32(2.0)), device="cpu"
    )
    assert card.path == "cuda" and cpu.path == "torch"

    def gap(preds, dispatch):
        return (float(np.abs(preds - on_cpu).max()),
                abs(dispatch.fit_mse - cpu.fit_mse) / cpu.fit_mse)

    pred_diff, mse_rel = gap(on_card, card)
    noise_pred, noise_mse = gap(nudged, cpu_nudged)
    print(f"card vs CPU fit: preds max-abs {pred_diff:.3g}, mse rel {mse_rel:.3g}; "
          f"CPU vs CPU on a one-ulp nudge: {noise_pred:.3g}, {noise_mse:.3g}")
    assert pred_diff <= FIT_TOL and mse_rel <= FIT_TOL

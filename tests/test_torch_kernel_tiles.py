"""The forecaster kernel's tiling, held on the CPU.

The kernel (``kernels/forecast_mlp.cu``) runs only on the card; its
tests there are in tests/test_torch_cuda.py. Here, with the same numpy
inputs, the port's forward on the CPU is held against JAX ``forward``
and the interpret-mode Pallas kernel at the batches of the kernel's tile
edges (64-row tiles) and at odd widths. On the CPU the forward is the
plain version, which has no tiles: the edge batches pin its batch
handling, and the card tests carry the tiles themselves. A numpy model
of the tensor core's summation order shows why the card's 1e-3 bound
holds; the exact-arithmetic inputs the card checks use are shown exact;
the path hands the kernel an aligned x even for one trace; and the
source and flags are held to the Hopper design. Tolerances (``pytest
-s`` prints the measured gaps):
- forward vs JAX and Pallas: max-abs 1e-4, the port's forward bound;
- tensor-core order vs the plain version: 1e-3, the card's bound;
- exact inputs, plain version vs a float64 model: 1e-6 (expf ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import exact_inputs
from headlamp_tpu.models import forecast as jf
from headlamp_tpu.models.pallas_forward import forecast_forward_pallas
from headlamp_tpu_torch.kernels import build
from headlamp_tpu_torch.models import forecast as tf
from headlamp_tpu_torch.models import fused_forward as ff
from headlamp_tpu_torch.models.convert import params_from_jax

#: pytest-xdist runs several workers on the same cores: one intra-op
#: thread each keeps torch's spinning thread pools from oversubscribing
#: them.
torch.set_num_threads(1)

FORWARD_TOL = 1e-4
KERNEL_TOL = 1e-3
EXACT_TOL = 1e-6
SOURCE = build.KERNEL_DIR / "forecast_mlp.cu"


def _case(window, hidden, horizon, rows, seed=0):
    """Seeded numpy params (non-zero biases) and x in [0, 1)."""
    rng = np.random.default_rng(seed)
    shapes = {"w1": (window, hidden), "b1": (hidden,), "w2": (hidden, hidden),
              "b2": (hidden,), "w3": (hidden, horizon), "b3": (horizon,)}
    params = {}
    for name, shape in shapes.items():
        scale = np.sqrt(2.0 / sum(shape)) if len(shape) == 2 else 0.05
        params[name] = (scale * rng.standard_normal(shape)).astype(np.float32)
    x = rng.uniform(size=(rows, window)).astype(np.float32)
    return params, x


@pytest.mark.parametrize(
    "batches,window,hidden,horizon",
    [
        # One row, a short tile, one tile (the demo page's 64 chips), a
        # tile and a one-row tail, two tiles and a tail.
        ((1, 63, 64, 65, 129), 32, 128, 8),
        ((300,), 5, 20, 3),        # widths that fill no fragment
        ((7,), 1, 1, 1),           # arrays below one 16-byte bulk copy
        ((65,), 128, 128, 128),    # every width at the guard's limit
    ],
)
def test_forward_matches_jax_and_pallas_at_tile_edges(batches, window, hidden, horizon):
    cfg = jf.ForecastConfig(window=window, hidden=hidden, horizon=horizon)
    for rows in batches:
        params, x = _case(window, hidden, horizon, rows, seed=rows + window)
        jparams = {k: jnp.asarray(v) for k, v in params.items()}
        ref = np.asarray(jf.forward(jparams, x))
        pal = np.asarray(forecast_forward_pallas(jparams, x, cfg, interpret=True))
        got = ff.forecast_forward(params_from_jax(params, "cpu"), torch.from_numpy(x)).numpy()
        assert got.shape == (rows, horizon)
        gaps = (np.abs(got - ref).max(), np.abs(got - pal).max())
        print(f"rows={rows} widths=({window},{hidden},{horizon}): "
              f"vs jax {gaps[0]:.3g}, vs pallas interpret {gaps[1]:.3g}")
        assert max(gaps) <= FORWARD_TOL, rows


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _gelu(v):
    c = np.float32(0.7978845608028654)
    return (np.float32(0.5) * v * (1 + np.tanh(c * (v + np.float32(0.044715) * v * v * v))))


def _tensor_core_dense(a, w, b):
    """bf16 operands; each k16 chunk's 16 products summed in f32, the
    chunks added to the f32 accumulator in order, as wgmma's k16 steps."""
    a, w = _bf16(a), _bf16(w)
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 16):
        chunk = (a[:, k0:k0 + 16, None] * w[None, k0:k0 + 16, :]).sum(axis=1, dtype=np.float32)
        acc = (acc + chunk).astype(np.float32)
    return acc + b


def test_tensor_core_summation_order_stays_within_the_card_bound():
    params, x = _case(32, 128, 8, 4097, seed=11)
    h = _gelu(_tensor_core_dense(x, params["w1"], params["b1"]))
    h = _gelu(_tensor_core_dense(h, params["w2"], params["b2"]))
    model = 1.0 / (1.0 + np.exp(-_tensor_core_dense(h, params["w3"], params["b3"])))
    plain = ff.forecast_forward_reference(params_from_jax(params, "cpu"), torch.from_numpy(x))
    gap = float(np.abs(model - plain.numpy()).max())
    print(f"tensor-core summation order vs plain version, 4097 rows: max-abs {gap:.3g}")
    assert gap <= KERNEL_TOL


def test_exact_inputs_leave_only_the_final_expf():
    params, x = exact_inputs(32, 128, 8, 4097, seed=5)
    p64 = {k: v.numpy().astype(np.float64) for k, v in params.items()}
    x64 = x.numpy().astype(np.float64)
    pre1 = x64 @ p64["w1"] + p64["b1"]
    pre2 = np.maximum(pre1, 0) @ p64["w2"] + p64["b2"]
    pre3 = np.maximum(pre2, 0) @ p64["w3"] + p64["b3"]
    # Every hidden pre-activation is 0 or at least 16 in magnitude, where
    # tanh-GELU is ReLU exactly; each is an integer of 8 significant bits.
    for pre in (pre1, pre2):
        assert np.all((pre == 0) | (np.abs(pre) >= 16))
        assert np.all(pre == _bf16(pre))
    assert np.abs(pre1).max() > 0 and np.abs(pre3).max() > 0.5
    want = 1.0 / (1.0 + np.exp(-pre3))
    got = ff.forecast_forward_reference(params, x).numpy()
    gap = float(np.abs(got - want).max())
    print(f"exact inputs: plain version vs float64 model max-abs {gap:.3g}")
    assert gap <= EXACT_TOL


def test_wrapper_rejects_a_misaligned_operand():
    params = params_from_jax(_case(32, 128, 8, 4)[0], "cpu")
    buf = torch.zeros(4 * 32 + 1)
    assert ff._check_operands(params, buf[:-1].view(4, 32)) == (4, 32, 128, 8)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ff._check_operands(params, buf[1:].view(4, 32))  # 4 bytes off
    shifted = torch.zeros(8 + 1)[1:]
    with pytest.raises(ValueError, match="b3 must start"):
        ff._check_operands(dict(params, b3=shifted), buf[:-1].view(4, 32))


def test_kernel_source_is_the_hopper_design():
    src = SOURCE.read_text()
    for needle in ("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                   "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16",
                   "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes",
                   "mbarrier.try_wait.parity", "pallas_forward.py"):
        assert needle in src, needle
    assert "fmaf(" not in src  # no scalar-FMA matmul loop is left
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert not any("fast_math" in flag or "fast-math" in flag for flag in build.NVCC_FLAGS)


def test_one_trace_window_reaches_the_kernel_aligned(monkeypatch):
    # One trace of 61 samples: its last 32 are a contiguous slice 29
    # floats (116 bytes) into the series. The fit entries must hand the
    # forward a copy on a 16-byte boundary, which the kernel's bulk
    # copies need and its wrapper checks.
    seen = []
    real = ff.forecast_forward

    def checked(params, x):
        seen.append(ff._check_operands(params, x))
        return real(params, x)

    monkeypatch.setattr(ff, "forecast_forward", checked)
    series = tf.synthetic_telemetry(1, 61, device="cpu")
    assert series[:, -32:].is_contiguous() and series[:, -32:].data_ptr() % ff.ALIGN
    preds, cold, state = tf.fit_and_forecast_incremental(series, steps=2, device="cpu")
    _, warm, _ = tf.fit_and_forecast_incremental(series, state=state, warm_steps=1, device="cpu")
    out, _ = tf.fit_and_forecast_with_dispatch(series, steps=2, device="cpu")
    assert (cold.path, warm.path) == ("torch", "torch-warm")
    assert seen == [(1, 32, 128, 8)] * 3
    np.testing.assert_allclose(out.numpy(), preds, rtol=0, atol=0)

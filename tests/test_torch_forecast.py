"""Parity of the port's forecaster math with the JAX package on the CPU.

The same numpy inputs go through the JAX function (the Pallas kernel in
interpret mode, as tests/test_pallas.py runs it) and the port's
counterpart with ``device="cpu"``. Tolerances, with the differences
these tests measure (``pytest -s`` prints them):
- forward and the kernel's plain version: max-abs 1e-4 (measured
  5.3e-6; the differences are f32 summation order and the points where
  a hidden activation rounds to the other bf16 neighbour);
- make_windows: bit-identical (a pure gather).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headlamp_tpu.models import forecast as jf
from headlamp_tpu.models.pallas_forward import forecast_forward_pallas
from headlamp_tpu_torch.models import forecast as tf
from headlamp_tpu_torch.models import fused_forward as ff
from headlamp_tpu_torch.models.convert import params_from_jax

#: pytest-xdist runs several workers on the same cores: one intra-op
#: thread each keeps torch's spinning thread pools from oversubscribing
#: them (it cuts these tests' CPU time about fourfold).
torch.set_num_threads(1)

FORWARD_TOL = 1e-4


@pytest.fixture(scope="module")
def jax_params():
    return jf.init_params(jax.random.PRNGKey(3), jf.ForecastConfig())


class TestMath:
    @pytest.mark.parametrize(
        "n_series,length,window,horizon", [(3, 48, 32, 8), (64, 61, 32, 8), (5, 20, 4, 3)]
    )
    def test_make_windows_bit_identical(self, n_series, length, window, horizon):
        series = np.random.default_rng(1).uniform(size=(n_series, length)).astype(np.float32)
        jx, jy = jf.make_windows(jnp.asarray(series), window, horizon)
        tx, ty = tf.make_windows(torch.from_numpy(series), window, horizon)
        assert np.array_equal(np.asarray(jx), tx.numpy())
        assert np.array_equal(np.asarray(jy), ty.numpy())

    def test_make_windows_rejects_short_series(self):
        with pytest.raises(ValueError):
            tf.make_windows(torch.zeros((2, 10)), 8, 4)

    @pytest.mark.parametrize("rows", [3, 200, 256])
    def test_forward_matches_jax_and_pallas(self, jax_params, rows):
        cfg = jf.ForecastConfig()
        x = np.random.default_rng(rows).uniform(size=(rows, cfg.window)).astype(np.float32)
        ref = np.asarray(jf.forward(jax_params, x))
        pal = np.asarray(forecast_forward_pallas(jax_params, x, cfg, interpret=True))
        params = params_from_jax(jax_params, "cpu")
        xt = torch.from_numpy(x)
        with torch.no_grad():
            fwd = tf.forward(params, xt).numpy()
        plain = ff.forecast_forward_reference(params, xt).numpy()
        served = ff.forecast_forward(params, xt).numpy()
        assert plain.shape == (rows, cfg.horizon)
        for got in (fwd, plain, served):
            assert np.abs(got - ref).max() <= FORWARD_TOL
            assert np.abs(got - pal).max() <= FORWARD_TOL
        print(f"forward rows={rows}: max-abs vs jax {np.abs(plain - ref).max():.3g}, "
              f"vs pallas interpret {np.abs(plain - pal).max():.3g}")

    def test_module_matches_functional_forward(self, jax_params):
        params = params_from_jax(jax_params, "cpu")
        model = tf.ForecastMLP(params)
        assert [n for n, _ in model.named_parameters()] == list(tf.PARAM_NAMES)
        for name, p in model.named_parameters():
            assert tuple(p.shape) == tuple(jax_params[name].shape)  # [in, out]
            assert p.data_ptr() != params[name].data_ptr()  # copied, not aliased
        x = torch.rand((5, 32), generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            assert torch.equal(model(x), tf.forward(params, x))

    def test_init_params_layout_and_scale(self):
        cfg = tf.ForecastConfig()
        params = tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        ref = jf.init_params(jax.random.PRNGKey(0), jf.ForecastConfig())
        for name in tf.PARAM_NAMES:
            assert tuple(params[name].shape) == tuple(ref[name].shape)
            assert params[name].dtype == torch.float32
        assert float(params["b1"].abs().max()) == 0.0
        # Glorot-normal: std sqrt(2 / (fan_in + fan_out)).
        assert abs(float(params["w2"].std()) - (2 / 256) ** 0.5) < 0.01
        again = tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        assert all(torch.equal(params[n], again[n]) for n in tf.PARAM_NAMES)

    def test_synthetic_telemetry_deterministic_and_bounded(self):
        a = tf.synthetic_telemetry(16, 61, device="cpu")
        b = tf.synthetic_telemetry(16, 61, device="cpu")
        c = tf.synthetic_telemetry(16, 61, torch.Generator().manual_seed(1), device="cpu")
        assert a.shape == (16, 61) and torch.equal(a, b) and not torch.equal(a, c)
        assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0

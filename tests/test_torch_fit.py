"""Parity of the port's fits, its Adam and its kernel guard with the JAX
package on the CPU, from the same init and series. Tolerances, with the
differences these tests measure (``pytest -s`` prints them): a 60-step
cold fit and a 10-step warm fit agree in final MSE within 1e-2 relative
(measured 5.0e-4 cold, 3.7e-4 warm) and in predictions within 1e-2
max-abs (measured 3.5e-3 cold, 1.5e-3 warm) — per-step f32 order
differences compound through Adam. One Adam step matches optax to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from headlamp_tpu.models import forecast as jf
from headlamp_tpu.models.pallas_forward import forecast_forward_pallas
from headlamp_tpu_torch.models import forecast as tf
from headlamp_tpu_torch.models import fused_forward as ff
from headlamp_tpu_torch.models.convert import (
    opt_state_from_optax,
    params_from_jax,
    params_to_numpy,
)

#: pytest-xdist runs several workers on the same cores: one intra-op
#: thread each keeps torch's spinning thread pools from oversubscribing
#: them (it cuts these tests' CPU time about fourfold).
torch.set_num_threads(1)

FIT_MSE_REL_TOL = 1e-2
FIT_PRED_TOL = 1e-2


@pytest.fixture(scope="module")
def jax_params():
    return jf.init_params(jax.random.PRNGKey(3), jf.ForecastConfig())


@pytest.fixture(scope="module")
def cold_fit():
    """JAX's 60-step cold fit on synthetic_telemetry(64, 61) from
    PRNGKey(0), and the port's from the same init and series."""
    cfg = jf.ForecastConfig()
    series = jf.synthetic_telemetry(64, 61)
    out, params, opt_state, mse = jf._fit_forecast_state_program(
        series, jax.random.PRNGKey(0), cfg, 60, "xla", 0
    )
    init = params_from_jax(jf.init_params(jax.random.PRNGKey(0), cfg), "cpu")
    preds, dispatch, state = tf.fit_and_forecast_incremental(
        np.asarray(series), tf.ForecastConfig(), steps=60, init=init, device="cpu"
    )
    return {
        "series": np.asarray(series),
        "jax": (np.asarray(out), params, opt_state, float(mse)),
        "port": (preds, dispatch, state),
    }


class TestKernelGuard:
    def _wide(self):
        params = tf.init_params(torch.Generator().manual_seed(0), tf.ForecastConfig(), device="cpu")
        params["w1"] = torch.zeros((32, 256))
        return params

    def test_hidden_256_rejected(self):
        with pytest.raises(ValueError, match="single-tile kernel width 128"):
            ff.forecast_forward(self._wide(), torch.zeros((4, 32)))

    def test_hidden_256_rejected_like_pallas(self):
        big = jf.init_params(jax.random.PRNGKey(0), jf.ForecastConfig())
        big["w1"] = jnp.zeros((32, 256))
        with pytest.raises(ValueError):
            forecast_forward_pallas(big, jnp.zeros((4, 32)), interpret=True)
        with pytest.raises(ValueError):
            ff.forecast_forward(self._wide(), torch.zeros((4, 32)))

    @pytest.mark.parametrize("dims", [(129, 128, 8), (32, 128, 129), (32, 256, 8)])
    def test_check_single_tile(self, dims):
        with pytest.raises(ValueError):
            ff.check_single_tile(*dims)
        ff.check_single_tile(128, 128, 128)


class TestAdam:
    def test_update_matches_optax(self, jax_params):
        # Three steps of optax.adam(1e-3) and of the explicit Adam on the
        # same gradients: params and moments agree to f32 rounding.
        rng = np.random.default_rng(0)
        grads = [
            {k: rng.normal(size=np.shape(v)).astype(np.float32) for k, v in jax_params.items()}
            for _ in range(3)
        ]
        opt = optax.adam(1e-3)
        jp, js = jax_params, opt.init(jax_params)
        tp = params_from_jax(jax_params, "cpu")
        ts = tf.adam_init(tp)
        for g in grads:
            updates, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
            jp = optax.apply_updates(jp, updates)
            tf.adam_update_(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts, 1e-3)
        assert int(ts.count) == int(js[0].count) == 3
        for name in tf.PARAM_NAMES:
            assert np.abs(np.asarray(jp[name]) - tp[name].numpy()).max() <= 1e-6
            assert np.abs(np.asarray(js[0].mu[name]) - ts.mu[name].numpy()).max() <= 1e-6
            assert np.abs(np.asarray(js[0].nu[name]) - ts.nu[name].numpy()).max() <= 1e-6


class TestFitParity:
    def test_cold_fit_matches_jax(self, cold_fit):
        j_out, _, _, j_mse = cold_fit["jax"]
        preds, dispatch, state = cold_fit["port"]
        assert dispatch.path == "torch" and dispatch.fallback_reason is None
        assert abs(dispatch.fit_mse - j_mse) / j_mse <= FIT_MSE_REL_TOL
        assert preds.shape == j_out.shape == (64, 8)
        assert np.abs(preds - j_out).max() <= FIT_PRED_TOL
        print(f"cold fit: mse rel diff {abs(dispatch.fit_mse - j_mse) / j_mse:.3g}, "
              f"preds max-abs {np.abs(preds - j_out).max():.3g}")
        assert state.generation == 0 and state.cold_mse == dispatch.fit_mse

    def test_cold_fit_params_track_jax(self, cold_fit):
        _, j_params, _, _ = cold_fit["jax"]
        _, _, state = cold_fit["port"]
        got = params_to_numpy(state.params)
        diff = max(np.abs(np.asarray(j_params[n]) - got[n]).max() for n in tf.PARAM_NAMES)
        assert diff <= 1e-2
        assert int(state.opt_state.count) == 60
        print(f"cold fit: params max-abs {diff:.3g}")

    def test_warm_fit_from_carried_jax_state(self, cold_fit):
        series = cold_fit["series"]
        _, j_params, j_opt, j_mse = cold_fit["jax"]
        cfg = tf.ForecastConfig()
        w_out, _, _, w_mse = jf._warm_fit_forecast_program(
            jnp.asarray(series), j_params, j_opt, jf.ForecastConfig(), 10, "xla", 0
        )
        carry = tf.WarmState(
            params_from_jax(j_params, "cpu"), opt_state_from_optax(j_opt, "cpu"),
            j_mse, 0, cfg, series.shape[0],
        )
        preds, dispatch, state = tf.fit_and_forecast_incremental(
            series, cfg, state=carry, device="cpu"
        )
        assert dispatch.path == "torch-warm" and dispatch.carried_from_generation == 0
        assert dispatch.warm_demotion_reason is None
        assert abs(dispatch.fit_mse - float(w_mse)) / float(w_mse) <= FIT_MSE_REL_TOL
        assert np.abs(preds - np.asarray(w_out)).max() <= FIT_PRED_TOL
        print(f"warm fit: mse rel diff {abs(dispatch.fit_mse - float(w_mse)) / float(w_mse):.3g}, "
              f"preds max-abs {np.abs(preds - np.asarray(w_out)).max():.3g}")
        assert int(state.opt_state.count) == 70
        # The carry itself is never modified in place.
        assert int(carry.opt_state.count) == 60

    def test_cold_entry_with_dispatch_matches_jax(self):
        series = np.asarray(jf.synthetic_telemetry(8, 48))
        j_out, j_disp = jf.fit_and_forecast_with_dispatch(series, steps=20)
        init = params_from_jax(jf.init_params(jax.random.PRNGKey(0), jf.ForecastConfig()), "cpu")
        out, disp = tf.fit_and_forecast_with_dispatch(series, steps=20, init=init, device="cpu")
        assert disp.path == "torch" and isinstance(disp.fit_mse, torch.Tensor)
        assert np.abs(out.numpy() - np.asarray(j_out)).max() <= FIT_PRED_TOL
        j_mse = float(j_disp.fit_mse)
        assert abs(float(disp.fit_mse) - j_mse) / j_mse <= FIT_MSE_REL_TOL

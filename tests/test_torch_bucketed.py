"""The port's masked bucketed fits against JAX's on the CPU: the cold
``_bucketed_fit_forecast_state_program`` and the warm
``_bucketed_warm_fit_forecast_program`` of ``headlamp_tpu/models/
forecast.py`` (run with ``"xla", 0``) and their counterparts in
``headlamp_tpu_torch/models/forecast.py``, from the same init, the same
padded series and, warm, the same carry. Three fleets: 64 chips and 50
chips at bucket 64, one chip at bucket 8.

Tolerances are ROADMAP Queue 3's fit bounds: final MSE within 1e-2
relative and predictions within 1e-2 max-abs (``pytest -s`` prints the
measured values; f32 summation order compounds through Adam). Padding
is held exactly: padded rows get zero gradient and move nothing.
The JAX programs compile once per (bucket, length) shape: four compiles
on a short series."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headlamp_tpu.models import forecast as jf
from headlamp_tpu_torch.models import forecast as tf
from headlamp_tpu_torch.models.convert import opt_state_from_optax, params_from_jax

torch.set_num_threads(1)

MSE_REL_TOL = 1e-2
PRED_TOL = 1e-2
LENGTH = 48
FLEETS = [(64, 64), (64, 50), (8, 1)]


def _series(n_chips: int) -> np.ndarray:
    return np.array(jf.synthetic_telemetry(n_chips, LENGTH, jax.random.PRNGKey(5)), np.float32)


@pytest.fixture(scope="module")
def cold_runs():
    """(bucket, chips) -> JAX's cold outputs, its padded inputs and init."""
    cfg, runs = jf.ForecastConfig(), {}
    for bucket, n in FLEETS:
        padded, weights = jf.pad_series_to_bucket(jnp.asarray(_series(n)), bucket)
        key = jax.random.PRNGKey(0)
        runs[bucket, n] = dict(
            padded=padded, weights=weights, init=jf.init_params(key, cfg),
            out=jf._bucketed_fit_forecast_state_program(padded, weights, key, cfg, 60, "xla", 0),
        )
    return runs


def _gaps(label, n, jax_out, port_out, jax_mse, port_mse):
    pred = float(np.abs(np.asarray(jax_out)[:n] - port_out[:n].numpy()).max())
    mse = abs(float(port_mse) - float(jax_mse)) / float(jax_mse)
    print(f"{label}: predictions max-abs {pred:.3g}, mse rel {mse:.3g}")
    assert pred <= PRED_TOL and mse <= MSE_REL_TOL
    return pred, mse


@pytest.mark.parametrize("bucket,n", FLEETS)
def test_cold_program_matches_jax(cold_runs, bucket, n):
    run = cold_runs[bucket, n]
    series, weights = tf.pad_series_to_bucket(torch.from_numpy(_series(n)), bucket)
    np.testing.assert_array_equal(series.numpy(), np.asarray(run["padded"]))
    np.testing.assert_array_equal(weights.numpy(), np.asarray(run["weights"]))
    out, params, opt_state, mse = tf._bucketed_fit_forecast_state_program(
        series, weights, params_from_jax(run["init"], "cpu"), tf.ForecastConfig(), 60
    )
    jout, _, jopt, jmse = run["out"]
    assert out.shape == (bucket, 8) and int(opt_state.count) == int(jopt[0].count) == 60
    _gaps(f"cold, {n} chips at bucket {bucket}", n, jout, out, jmse, mse)


@pytest.mark.parametrize("bucket,n", FLEETS)
def test_warm_program_from_the_same_carry_matches_jax(cold_runs, bucket, n):
    run = cold_runs[bucket, n]
    _, jparams, jopt, _ = run["out"]
    params, opt_state = params_from_jax(jparams, "cpu"), opt_state_from_optax(jopt, "cpu")
    # JAX's warm program donates the carry: hand it copies.
    jout, _, jopt2, jmse = jf._bucketed_warm_fit_forecast_program(
        run["padded"], run["weights"], *jax.tree_util.tree_map(jnp.copy, (jparams, jopt)),
        jf.ForecastConfig(), jf.WARM_STEPS, "xla", 0,
    )
    out, _, opt_state, mse = tf._bucketed_warm_fit_forecast_program(
        torch.from_numpy(np.array(run["padded"])), torch.from_numpy(np.array(run["weights"])),
        params, opt_state, tf.ForecastConfig(), tf.WARM_STEPS,
    )
    assert int(opt_state.count) == int(jopt2[0].count) == 60 + tf.WARM_STEPS
    _gaps(f"warm, {n} chips at bucket {bucket}", n, jout, out, jmse, mse)


def test_padded_rows_get_exactly_zero_gradient():
    cfg = tf.ForecastConfig()
    real = torch.from_numpy(_series(5))
    padded, weights = tf.pad_series_to_bucket(real, 8)
    poisoned = padded.clone()
    poisoned[5:] = 1e6
    params = tf.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")

    def grads(series):
        series = series.clone().requires_grad_(True)
        x, y = tf.make_windows(series, cfg.window, cfg.horizon)
        w = weights.repeat_interleave(x.shape[0] // 8)
        live = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = tf._masked_loss_fn(live, x, y, w)
        return loss.detach(), torch.autograd.grad(loss, [series, *live.values()])

    clean_loss, clean = grads(padded)
    dirty_loss, dirty = grads(poisoned)
    assert clean_loss.item() == dirty_loss.item()
    assert bool((clean[0][5:] == 0).all()) and bool((dirty[0][5:] == 0).all())
    for a, b in zip(clean, dirty):
        assert torch.equal(a[:5] if a.shape == padded.shape else a,
                           b[:5] if b.shape == padded.shape else b)
    # With every weight 1 the masked loss is the plain mean.
    x, y = tf.make_windows(real, cfg.window, cfg.horizon)
    plain = tf.loss_fn(params, x, y)
    masked = tf._masked_loss_fn(params, x, y, torch.ones(x.shape[0]))
    assert float(masked) == pytest.approx(float(plain), rel=1e-6)


def test_pad_series_to_bucket_round_trips():
    real = torch.from_numpy(_series(5))
    padded, weights = tf.pad_series_to_bucket(real, 8)
    jpadded, jweights = jf.pad_series_to_bucket(jnp.asarray(real.numpy()), 8)
    assert padded.shape == (8, LENGTH) and padded.dtype == weights.dtype == torch.float32
    assert torch.equal(padded[:5], real) and bool((padded[5:] == 0).all())
    assert weights.tolist() == [1, 1, 1, 1, 1, 0, 0, 0]
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jpadded))
    np.testing.assert_array_equal(weights.numpy(), np.asarray(jweights))
    # The predictions of a bucketed fit slice back to the real chips.
    out, *_ = tf._bucketed_fit_forecast_state_program(
        padded, weights, tf.init_params(torch.Generator().manual_seed(0), tf.ForecastConfig(),
                                        device="cpu"), tf.ForecastConfig(), 2)
    assert out[:5].shape == (5, 8) and bool(torch.isfinite(out).all())

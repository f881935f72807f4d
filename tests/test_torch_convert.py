"""Round trips of forecaster state between the JAX package and the port."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from headlamp_tpu.models import forecast as jf
from headlamp_tpu_torch.models import forecast as tf
from headlamp_tpu_torch.models.convert import (
    opt_state_from_optax,
    opt_state_to_numpy,
    params_from_jax,
    params_to_numpy,
)

#: pytest-xdist runs several workers on the same cores: one intra-op
#: thread each keeps torch's spinning thread pools from oversubscribing
#: them (it cuts these tests' CPU time about fourfold).
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trained():
    """JAX params and optax state after three Adam steps (non-zero
    moments, count 3)."""
    cfg = jf.ForecastConfig()
    params = jf.init_params(jax.random.PRNGKey(1), cfg)
    opt = optax.adam(cfg.learning_rate)
    state = opt.init(params)
    x = jax.random.uniform(jax.random.PRNGKey(2), (16, cfg.window))
    y = jax.random.uniform(jax.random.PRNGKey(3), (16, cfg.horizon))
    for _ in range(3):
        grads = jax.grad(jf.loss_fn)(params, x, y)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return params, state


def test_params_round_trip_exact(trained):
    params, _ = trained
    port = params_from_jax(params, "cpu")
    assert list(port) == list(tf.PARAM_NAMES)
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in port.values())
    back = params_to_numpy(port)
    for name in tf.PARAM_NAMES:
        assert np.array_equal(back[name], np.asarray(params[name]))
    # And the JAX forward accepts the round-tripped params as they are.
    x = jnp.ones((2, 32))
    assert np.array_equal(np.asarray(jf.forward(back, x)), np.asarray(jf.forward(params, x)))


def test_opt_state_round_trip_exact(trained):
    _, state = trained
    port = opt_state_from_optax(state, "cpu")
    assert port.count.dtype == torch.int32 and int(port.count) == 3
    count, mu, nu = opt_state_to_numpy(port)
    rebuilt = (optax.ScaleByAdamState(count=jnp.asarray(count), mu=mu, nu=nu), optax.EmptyState())
    for a, b in zip(jax.tree_util.tree_leaves(rebuilt), jax.tree_util.tree_leaves(state)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_opt_state_from_bare_adam_entry(trained):
    _, state = trained
    port = opt_state_from_optax(state[0], "cpu")
    assert int(port.count) == 3
    assert np.array_equal(port.mu["w2"].numpy(), np.asarray(state[0].mu["w2"]))


def test_opt_state_without_adam_rejected():
    with pytest.raises(ValueError):
        opt_state_from_optax((optax.EmptyState(),), "cpu")


def test_converted_state_continues_like_optax(trained):
    # One more step from the converted carry equals optax's next step.
    params, state = trained
    rng = np.random.default_rng(4)
    grads = {k: rng.normal(size=np.shape(v)).astype(np.float32) for k, v in params.items()}
    updates, _ = optax.adam(1e-3).update({k: jnp.asarray(v) for k, v in grads.items()}, state, params)
    want = optax.apply_updates(params, updates)
    port_params = params_from_jax(params, "cpu")
    port_state = opt_state_from_optax(state, "cpu")
    tf.adam_update_(port_params, {k: torch.from_numpy(v) for k, v in grads.items()}, port_state, 1e-3)
    for name in tf.PARAM_NAMES:
        assert np.abs(port_params[name].numpy() - np.asarray(want[name])).max() <= 1e-6

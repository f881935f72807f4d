"""tests/test_forecast.py::TestWarmStart's cases, run through both
packages on the CPU: the same demotion decisions, reasons and lineage."""

import numpy as np
import pytest
import torch

from headlamp_tpu.models import forecast as jf
from headlamp_tpu_torch.models import forecast as tf

#: pytest-xdist runs several workers on the same cores: one intra-op
#: thread each keeps torch's spinning thread pools from oversubscribing
#: them (it cuts these tests' CPU time about fourfold).
torch.set_num_threads(1)


def _series(n_chips=3, length=48):
    base = np.linspace(0.2, 0.8, length, dtype="float32")
    return np.tile(base, (n_chips, 1)) + 0.01 * np.arange(n_chips, dtype="float32").reshape(-1, 1)


class TestWarmStartOutcomes:
    def test_cold_fit_seeds_state(self):
        _, jd, js = jf.fit_and_forecast_incremental(_series(), steps=12)
        _, d, state = tf.fit_and_forecast_incremental(_series(), steps=12, device="cpu")
        assert d.path == "torch" and not d.warm and not jd.warm
        assert d.warm_demotion_reason is None and d.carried_from_generation is None
        assert state.generation == js.generation == 0
        assert state.cold_mse == d.fit_mse and state.n_chips == js.n_chips == 3

    def test_warm_fit_within_tolerance_of_cold(self):
        series = _series()
        _, cold, state = tf.fit_and_forecast_incremental(series, steps=30, device="cpu")
        out, warm, state2 = tf.fit_and_forecast_incremental(
            series, state=state, steps=30, warm_steps=5, device="cpu"
        )
        _, jcold, jstate = jf.fit_and_forecast_incremental(series, steps=30)
        _, jwarm, _ = jf.fit_and_forecast_incremental(series, state=jstate, steps=30, warm_steps=5)
        assert warm.warm == jwarm.warm is True
        assert warm.path == "torch-warm" and warm.warm_demotion_reason is None
        assert warm.carried_from_generation == jwarm.carried_from_generation == 0
        assert warm.fit_mse <= tf.COLD_MSE_TOLERANCE * max(cold.fit_mse, 1e-4)
        assert state2.generation == 0 and out.shape[0] == 3

    def test_fleet_resize_demotes_with_reason(self):
        _, _, state = tf.fit_and_forecast_incremental(_series(3), steps=12, device="cpu")
        out, d, state2 = tf.fit_and_forecast_incremental(
            _series(5), state=state, steps=12, device="cpu"
        )
        _, _, jstate = jf.fit_and_forecast_incremental(_series(3), steps=12)
        _, jd, _ = jf.fit_and_forecast_incremental(_series(5), state=jstate, steps=12)
        assert not d.warm and d.path == "torch"
        assert d.warm_demotion_reason == jd.warm_demotion_reason
        assert "chips 3->5" in d.warm_demotion_reason
        assert d.carried_from_generation == 0
        assert state2.generation == 1 and state2.n_chips == 5 and out.shape[0] == 5

    def test_cfg_change_demotes(self):
        _, _, state = tf.fit_and_forecast_incremental(_series(), steps=4, device="cpu")
        other = tf.ForecastConfig(learning_rate=2e-3)
        _, d, state2 = tf.fit_and_forecast_incremental(
            _series(), other, state=state, steps=4, device="cpu"
        )
        assert "carry mismatch" in d.warm_demotion_reason and state2.cfg == other

    def test_bad_warm_mse_demotes_to_cold(self):
        series = _series()
        _, _, state = tf.fit_and_forecast_incremental(series, steps=12, device="cpu")
        rigged = state._replace(cold_mse=1e-12)
        _, d, state2 = tf.fit_and_forecast_incremental(
            series, state=rigged, steps=12, warm_steps=2, device="cpu"
        )
        _, _, jstate = jf.fit_and_forecast_incremental(series, steps=12)
        _, jd, jstate2 = jf.fit_and_forecast_incremental(
            series, state=jstate._replace(cold_mse=1e-12), steps=12, warm_steps=2
        )
        assert not d.warm and not jd.warm
        assert d.warm_demotion_reason.startswith("warm mse")
        assert jd.warm_demotion_reason.startswith("warm mse")
        assert state2.generation == jstate2.generation == 1
        assert state2.cold_mse == d.fit_mse

    def test_short_history_passes_state_through(self):
        cfg = tf.ForecastConfig()
        _, _, state = tf.fit_and_forecast_incremental(_series(), steps=12, device="cpu")
        short = np.full((3, cfg.window // 2), 0.4, dtype="float32")
        out, d, state2 = tf.fit_and_forecast_incremental(short, state=state, device="cpu")
        jout, jd, _ = jf.fit_and_forecast_incremental(short)
        assert d.path == jd.path == "repeat"
        assert state2 is state
        assert np.array_equal(out, np.asarray(jout))

    def test_repeat_path_of_cold_entry(self):
        short = np.random.default_rng(2).uniform(size=(4, 20)).astype(np.float32)
        out, d = tf.fit_and_forecast_with_dispatch(short, device="cpu")
        jout, jd = jf.fit_and_forecast_with_dispatch(short)
        assert d.path == jd.path == "repeat" and d.fit_mse is None
        assert np.array_equal(out.numpy(), np.asarray(jout))

    def test_fit_exception_propagates(self, monkeypatch):
        # No demotion on an exception: it reaches the caller.
        _, _, state = tf.fit_and_forecast_incremental(_series(), steps=4, device="cpu")

        def broken(*a, **k):
            raise RuntimeError("fit exploded")

        monkeypatch.setattr(tf, "_train", broken)
        with pytest.raises(RuntimeError, match="fit exploded"):
            tf.fit_and_forecast_incremental(_series(), state=state, device="cpu")

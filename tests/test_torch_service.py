"""The port's forecast service against the JAX package's, on the CPU.

The forecast fit from the JAX init must give the same view apart from
its timing and inference label (predictions within 1e-2, as in
test_torch_fit.py). A forecast is missing only when there is nothing to
fit; errors from the fit or the kernel propagate — the port has no
blanket except that turns them into a missing forecast.
"""

import dataclasses

import jax
import pytest
import torch

from headlamp_tpu.metrics import client as jclient
from headlamp_tpu.models import forecast as jf
from headlamp_tpu.models import service as jservice
from headlamp_tpu.server import make_demo_transport as jax_demo_transport
from headlamp_tpu_torch import cli
from headlamp_tpu_torch.metrics import client
from headlamp_tpu_torch.models import forecast as tf
from headlamp_tpu_torch.models import fused_forward as ff
from headlamp_tpu_torch.models import service
from headlamp_tpu_torch.models.convert import params_from_jax
from headlamp_tpu_torch.server.demo import make_demo_transport
from headlamp_tpu_torch.transport.api_proxy import MockTransport

#: pytest-xdist runs several workers on the same cores: one intra-op
#: thread each keeps torch's spinning thread pools from oversubscribing
#: them (it cuts these tests' CPU time about fourfold).
torch.set_num_threads(1)

CLOCK = 1785283200.0
PROM = ("monitoring", "prometheus-k8s:9090")
PRED_TOL = 1e-2
#: Chips whose predicted peak lies this close to the 90% line may fall
#: on either side of it between the two packages; they are left out of
#: the at-risk comparison.
RISK_MARGIN = 1e-2


def clock():
    return CLOCK


@pytest.fixture(scope="module")
def history():
    return client.fetch_utilization_history(
        make_demo_transport("v5p32"), prometheus=PROM, clock=clock
    )


@pytest.fixture(scope="module")
def views(history):
    """The JAX view and the port's, both fit from JAX's PRNGKey(0) init."""
    jax_history = jclient.fetch_utilization_history(
        jax_demo_transport("v5p32"), prometheus=PROM, clock=clock
    )
    want = jservice.forecast_from_history(jax_history)
    init = params_from_jax(jf.init_params(jax.random.PRNGKey(0), jf.ForecastConfig()), "cpu")
    got = service.forecast_from_history(history, init=init, device="cpu")
    return got, want


class TestForecastView:
    def test_fields_equal_apart_from_timing_and_label(self, views):
        got, want = views
        assert got.inference_path == "torch" and want.inference_path == "xla"
        for name in ("horizon_s", "window_s", "inference_fallback_reason",
                     "carried_from_generation", "warm_demotion_reason", "data_source"):
            assert getattr(got, name) == getattr(want, name), name
        assert abs(got.fit_mse - want.fit_mse) / want.fit_mse <= 1e-2
        assert {(c.node, c.accelerator_id) for c in got.chips} == {
            (c.node, c.accelerator_id) for c in want.chips
        }

    def test_predictions_within_tolerance(self, views):
        got, want = views
        ref = {(c.node, c.accelerator_id): c for c in want.chips}
        for c in got.chips:
            r = ref[(c.node, c.accelerator_id)]
            assert c.current == r.current
            assert abs(c.predicted_peak - r.predicted_peak) <= PRED_TOL
            assert abs(c.predicted_mean - r.predicted_mean) <= PRED_TOL

    def test_at_risk_sets_identical(self, views):
        got, want = views

        def decided(view):
            return {
                (c.node, c.accelerator_id): c.saturation_risk
                for c in view.chips
                if abs(c.predicted_peak * 100 - service.SATURATION_PCT) > RISK_MARGIN * 100
            }

        port, ref = decided(got), decided(want)
        common = port.keys() & ref.keys()
        assert len(common) >= len(got.chips) - 2
        assert {k for k in common if port[k]} == {k for k in common if ref[k]}

    def test_view_field_names_match_jax(self):
        names = {f.name for f in dataclasses.fields(service.ForecastView)}
        assert names == {f.name for f in dataclasses.fields(jservice.ForecastView)}
        chip = {f.name for f in dataclasses.fields(service.ChipForecast)}
        assert chip == {f.name for f in dataclasses.fields(jservice.ChipForecast)}


class TestComputeForecast:
    def test_none_only_for_data_conditions(self):
        t = make_demo_transport("v5e4")
        assert service.compute_forecast(t, None, clock=clock, device="cpu") is None
        snap = client.fetch_tpu_metrics(t, clock=clock)
        empty = dataclasses.replace(snap, chips=[])
        assert service.compute_forecast(t, empty, clock=clock, device="cpu") is None
        # Prometheus answers instant queries but holds no history.
        no_history = MockTransport()
        assert service.compute_forecast(no_history, snap, clock=clock, device="cpu") is None

    def test_incremental_carry_survives_missing_history(self):
        t = make_demo_transport("v5e4")
        snap = client.fetch_tpu_metrics(t, clock=clock)
        view, state = service.compute_forecast_incremental(t, snap, clock=clock, device="cpu")
        assert view.inference_path == "torch" and state is not None
        again, kept = service.compute_forecast_incremental(
            MockTransport(), snap, state=state, clock=clock, device="cpu"
        )
        assert again is None and kept is state
        warm, _ = service.compute_forecast_incremental(
            t, snap, state=state, clock=clock, device="cpu"
        )
        assert warm.inference_path == "torch-warm" and warm.carried_from_generation == 0

    def test_fit_error_propagates(self, monkeypatch):
        def broken(*a, **k):
            raise RuntimeError("fit exploded")

        monkeypatch.setattr(tf, "_train", broken)
        t = make_demo_transport("v5e4")
        snap = client.fetch_tpu_metrics(t, clock=clock)
        with pytest.raises(RuntimeError, match="fit exploded"):
            service.compute_forecast(t, snap, clock=clock, device="cpu")
        with pytest.raises(RuntimeError, match="fit exploded"):
            service.compute_forecast_incremental(t, snap, clock=clock, device="cpu")

    def test_one_forward_per_forecast_on_the_page_path(self, monkeypatch):
        # The counts chip_smoke.py requires of the kernel on the card: the
        # render's cold fit, then a cold and a warm incremental fit, each
        # ending in exactly one forward.
        calls = []
        real = ff.forecast_forward

        def counted(params, x):
            calls.append(x.shape[0])
            return real(params, x)

        monkeypatch.setattr(ff, "forecast_forward", counted)
        t = make_demo_transport("v5e4")
        cli.render_page("metrics", t, clock=clock, device="cpu")
        assert len(calls) == 1
        snap = client.fetch_tpu_metrics(t, clock=clock)
        cold, state = service.compute_forecast_incremental(t, snap, clock=clock, device="cpu")
        warm, _ = service.compute_forecast_incremental(
            t, snap, state=state, clock=clock, device="cpu"
        )
        assert warm.inference_path == "torch-warm"
        assert calls == [len(cold.chips)] * 3

    def test_kernel_error_propagates(self, monkeypatch):
        def broken(*a, **k):
            raise RuntimeError("kernel failed")

        monkeypatch.setattr(ff, "forecast_forward_reference", broken)
        t = make_demo_transport("v5e4")
        snap = client.fetch_tpu_metrics(t, clock=clock)
        with pytest.raises(RuntimeError, match="kernel failed"):
            service.compute_forecast(t, snap, clock=clock, device="cpu")
        with pytest.raises(RuntimeError, match="kernel failed"):
            cli.render_page("metrics", t, clock=clock, device="cpu")

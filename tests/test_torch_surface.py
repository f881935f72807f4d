"""The rest of the JAX package's public surface in the port, on the CPU.

``models``: ``forecast_next`` and ``forecast_next_with_dispatch`` on
params converted from JAX's give JAX ``forecast_next``'s predictions
within ``FORWARD_TOL`` (1e-4, as ``tests/test_torch_forecast.py``), and
``fit_and_forecast`` from JAX's initial params gives JAX
``fit_and_forecast``'s within ``PRED_TOL`` (1e-2, as
``tests/test_torch_service.py``). ``metrics`` re-exports JAX's discovery
names; ``history.RECORDING_VERSION`` is JAX's; ``analytics.series_stats``
gives JAX's statistics (n, latest, min and max exact; mean and slope to
1e-5 relative). ``obs.trace``: with ``set_tracing(False)`` no trace is
captured, in the port as in JAX, and ``TraceRing.clear`` and
``memory_bytes`` give JAX's numbers on the same traces.
"""

import jax
import numpy as np
import pytest
import torch

import headlamp_tpu.analytics as janalytics
import headlamp_tpu.history as jhistory
import headlamp_tpu.metrics as jmetrics
import headlamp_tpu.models as jmodels
from headlamp_tpu.obs import trace as jtrace
import headlamp_tpu_torch.analytics as tanalytics
import headlamp_tpu_torch.history as thistory
import headlamp_tpu_torch.metrics as tmetrics
import headlamp_tpu_torch.models as tmodels
from headlamp_tpu_torch.metrics import client as tclient
from headlamp_tpu_torch.models import forecast as tf
from headlamp_tpu_torch.models.convert import params_from_jax
from headlamp_tpu_torch.obs import trace as ttrace
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

FORWARD_TOL = 1e-4
PRED_TOL = 1e-2
STAT_RTOL, STAT_ATOL = 1e-5, 1e-6


def test_forecast_next_matches_jax():
    cfg = jmodels.ForecastConfig()
    jparams = jmodels.init_params(jax.random.PRNGKey(5), cfg)
    recent = np.random.default_rng(5).uniform(size=(37, cfg.window)).astype(np.float32)
    want = np.asarray(jmodels.forecast_next(jparams, recent, cfg))
    params = params_from_jax(jparams, "cpu")
    out, dispatch = tmodels.forecast_next_with_dispatch(params, recent, cfg, device="cpu")
    assert out.shape == (37, cfg.horizon) and out.device.type == "cpu"
    assert np.abs(out.numpy() - want).max() <= FORWARD_TOL
    assert dispatch.path == "torch" and dispatch.fallback_reason is None and not dispatch.warm
    again = tmodels.forecast_next(params, torch.from_numpy(recent), device="cpu")
    assert torch.equal(again, out)


def test_fit_and_forecast_matches_jax(monkeypatch):
    cfg = jmodels.ForecastConfig()
    init = params_from_jax(jmodels.init_params(jax.random.PRNGKey(0), cfg), "cpu")
    monkeypatch.setattr(
        tf, "init_params",
        lambda gen, cfg, device=None: {k: v.clone().to(device) for k, v in init.items()},
    )
    series = np.asarray(jmodels.synthetic_telemetry(8, 96, jax.random.PRNGKey(1)))
    want = np.asarray(jmodels.fit_and_forecast(series, cfg, steps=40, seed=0))
    got = tmodels.fit_and_forecast(series, cfg, steps=40, seed=0, device="cpu")
    assert got.shape == want.shape == (8, cfg.horizon)
    assert np.abs(got.numpy() - want).max() <= PRED_TOL
    # Too short for a window: persistence, in both.
    short = series[:, :10]
    assert np.array_equal(tmodels.fit_and_forecast(short, cfg, device="cpu").numpy(),
                          np.asarray(jmodels.fit_and_forecast(short, cfg)))


def test_metrics_history_and_analytics_exports_match_jax():
    names = ("cached_prometheus", "find_prometheus_path", "invalidate_prometheus",
             "resolve_prometheus")
    for name in names:
        assert name in tmetrics.__all__ and name in jmetrics.__all__
        assert getattr(tmetrics, name) is getattr(tclient, name)
    assert set(jmetrics.__all__) <= set(tmetrics.__all__)
    assert thistory.RECORDING_VERSION == jhistory.RECORDING_VERSION == 1
    assert "RECORDING_VERSION" in thistory.__all__
    # JAX's NamedSharding specs have the mesh's shard_params as counterpart.
    assert set(jmodels.__all__) - set(tmodels.__all__) == {"param_shardings"}
    rng = np.random.default_rng(9)
    for values in ([], [0.25], rng.random(288).astype(np.float32).tolist(),
                   (np.arange(40, dtype=np.float32) * 0.5).tolist()):
        got = tanalytics.series_stats(values, device="cpu")
        want = janalytics.series_stats(values)
        assert set(got) == set(want)
        for key in ("n", "latest", "min", "max"):
            assert got[key] == want[key], key
        for key in ("mean", "slope_per_step"):
            assert got[key] == pytest.approx(want[key], rel=STAT_RTOL, abs=STAT_ATOL), key


def test_the_tracing_switch_and_the_rings_clear_and_size_match_jax():
    assert ttrace.tracing_enabled() and jtrace.tracing_enabled()
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu")
    try:
        ttrace.set_tracing(False)
        jtrace.set_tracing(False)
        assert not ttrace.tracing_enabled() and not jtrace.tracing_enabled()
        with ttrace.trace_request("/x") as tt, jtrace.trace_request("/x") as jt:
            assert tt is None and jt is None
        before = len(ttrace.trace_ring)
        assert app.handle("/tpu")[0] == 200
        assert len(ttrace.trace_ring) == before  # nothing captured
    finally:
        ttrace.set_tracing(True)
        jtrace.set_tracing(True)
        app.close()
    with ttrace.trace_request("/y") as trace:
        with ttrace.span("work", n=3):
            pass
    assert trace is not None
    traces = [trace.to_dict() for _ in range(3)]
    tring, jring = ttrace.TraceRing(capacity=2), jtrace.TraceRing(capacity=2)
    assert tring.memory_bytes() == jring.memory_bytes() == 0
    for t in traces:
        tring.record(t)
        jring.record(t)
    assert len(tring) == len(jring) == 2
    assert tring.memory_bytes() == jring.memory_bytes() > 0
    tring.clear()
    jring.clear()
    assert len(tring) == len(jring) == 0 and tring.memory_bytes() == 0

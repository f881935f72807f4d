"""The SLO engine's budget self-forecast on the card
(``models.service.forecast_slo_burn``): a 512-point series replays the
registry's captured 8-chip × 512-sample fit graph, with the forecast
kernel inside it, and its predictions stay within 5e-2 of the port's CPU
fit on the same series and init (the bound the 60-step fit meets on 64
synthetic chips); a warm refinement replays the warm graph; another
length runs eagerly, counted in the graph cost ledger. A CUDA graph has
no CPU mode, so every test here needs a CUDA device and skips without
one. On the card:

    python -m pytest tests/test_torch_cuda_slo.py -q -s
"""

import numpy as np
import pytest
import torch

from headlamp_tpu_torch.models import aot
from headlamp_tpu_torch.models import forecast as tf
from headlamp_tpu_torch.models import fused_forward as ff
from headlamp_tpu_torch.models import service
from headlamp_tpu_torch.obs import graphcost
from headlamp_tpu_torch.obs import slo

#: Card against CPU after the 60-step cold fit (ROADMAP Queue 3).
CARD_CPU_TOL = 5e-2
CFG = tf.ForecastConfig()


def _series(n=aot.SLO_SERIES_STEADY, seed=5):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    series = 0.2 + 0.07 * np.sin(t / 29.0) + 0.02 * rng.standard_normal(n)
    return np.clip(series, 0.02, 1.5).astype(np.float32).tolist()


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    monkeypatch.setattr(graphcost, "_LEDGER", graphcost.GraphCostLedger())
    reg = aot.AotProgramRegistry(specs=[
        (tf.COLD_PROGRAM, (8, aot.SLO_SERIES_STEADY, CFG, slo.SELF_FORECAST_STEPS)),
        (tf.WARM_PROGRAM, (8, aot.SLO_SERIES_STEADY, CFG, tf.WARM_STEPS)),
    ])
    reg.compile_startup("cuda", block=True)
    assert reg.ready() and reg.compile_errors == 0, reg.snapshot()
    monkeypatch.setattr(aot, "_REGISTRY", reg)
    return reg


def _row(name):
    return graphcost.ledger().snapshot()["programs"].get(name, {"replays": 0, "eager": 0})


def test_the_self_forecast_replays_the_slo_bucket_and_launches_the_kernel(card):
    series = _series()
    init = tf.init_params(torch.Generator().manual_seed(0), CFG)
    ff.LAUNCHES.reset()
    got, state = service.forecast_slo_burn(series, init=init, device="cuda")
    torch.cuda.synchronize()
    assert ff.LAUNCHES.n == 1
    row = _row(service.SLO_BURN_PROGRAM)
    assert (row["replays"], row["eager"]) == (1, 0)
    assert _row(tf.COLD_PROGRAM)["replays"] == 1
    want, _ = service.forecast_slo_burn(series, init=init, device="cpu")
    diff = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    print(f"slo burn forecast, 512 points: card vs CPU max diff {diff:.3e} (tol {CARD_CPU_TOL})")
    assert len(got) == CFG.horizon and diff <= CARD_CPU_TOL
    warm, _ = service.forecast_slo_burn(series, state=state, device="cuda")
    torch.cuda.synchronize()
    assert ff.LAUNCHES.n == 2 and _row(tf.WARM_PROGRAM)["replays"] == 1
    assert _row(service.SLO_BURN_PROGRAM)["replays"] == 2 and all(np.isfinite(warm))


def test_another_length_runs_eagerly_and_is_counted(card):
    hits = card.bucket_hits
    got, _ = service.forecast_slo_burn(_series(300), device="cuda")
    assert len(got) == CFG.horizon and all(np.isfinite(got))
    row = _row(service.SLO_BURN_PROGRAM)
    assert (row["replays"], row["eager"]) == (0, 1) and card.bucket_hits == hits


def test_the_engine_projects_from_the_card(card):
    t = [0.0]
    eng = slo.SLOEngine(monotonic=lambda: t[0], device="cuda")
    for v in _series():
        eng.feed_latency(slo.REQUEST_DURATION, v, {"route": "/tpu/metrics"})
    assert eng.budget_forecast()["reason"] == "fit_pending"
    assert eng.drain(300.0)
    forecast = eng.budget_forecast()
    assert forecast["reason"] == "no_projected_burn" and forecast["points"] == 512
    assert eng.budget_fit_error is None
    assert _row(service.SLO_BURN_PROGRAM)["replays"] == 1

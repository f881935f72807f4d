"""The program registry's CUDA graphs on the card
(``headlamp_tpu_torch/models/aot.py``): each replay against the same
program run eagerly on the same inputs, the forecast kernel inside a
replay against its plain version, the kernel's launches counted per
replay (warm-up and capture count for no path), the rollups' replays
against their Python oracles, and one device-to-host copy per fused
request. A graph has no CPU mode, so every test here needs a CUDA
device and skips without one. On the card:

    python -m pytest tests/test_torch_cuda_graphs.py -q -s
"""

import numpy as np
import pytest
import torch

from headlamp_tpu_torch.models import aot
from headlamp_tpu_torch.models import forecast as tf
from headlamp_tpu_torch.models import fused_forward as ff
from headlamp_tpu_torch.obs import graphcost
from headlamp_tpu_torch.runtime.transfer import transfer_stats

#: Replay against the eager program: the cold fit's 60 Adam steps may
#: amplify a summation-order difference as the card-vs-CPU page fit
#: does (chip_smoke.py's PAGE_FIT_TOL); the 10-step warm fit and the
#: kernel against its plain version are held to the kernel's bound.
COLD_TOL = 1e-2
WARM_TOL = 1e-3
KERNEL_TOL = 1e-3
CFG = tf.ForecastConfig()


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    monkeypatch.setattr(graphcost, "_LEDGER", graphcost.GraphCostLedger())
    return torch.device("cuda")


def _registry(monkeypatch, specs, device):
    reg = aot.AotProgramRegistry(specs=specs)
    monkeypatch.setattr(aot, "_REGISTRY", reg)
    reg.compile_startup(device, block=True)
    assert reg.ready() and reg.compile_errors == 0, reg.snapshot()
    return reg


def test_fit_replays_equal_eager_and_count_their_launches(cuda, monkeypatch):
    reg = _registry(monkeypatch, [
        (aot.COLD_PROGRAM, (64, 61, CFG, 60)), (aot.WARM_PROGRAM, (64, 61, CFG, tf.WARM_STEPS)),
    ], cuda)
    series = tf.synthetic_telemetry(50, 61, torch.Generator().manual_seed(3), device="cpu")
    ff.LAUNCHES.reset()  # the captures above launched nothing that counts
    preds, cold, state = tf.fit_and_forecast_incremental(series.numpy(), device=cuda)
    torch.cuda.synchronize()
    assert cold.path == "cuda" and ff.LAUNCHES.n == 1 and reg.bucket_hits == 1
    padded, weights = tf.pad_series_to_bucket(series.to(cuda), 64)
    init = tf._initial_params(None, 0, CFG, cuda)
    with ff.LAUNCHES.tally():
        eager_out, _, _, _ = tf._bucketed_fit_forecast_state_program(padded, weights, init, CFG, 60)
    cold_diff = float(np.abs(preds - eager_out[:50].cpu().numpy()).max())
    recent = series[:, -CFG.window:].to(cuda)
    kernel_diff = float(np.abs(
        preds - ff.forecast_forward_reference(state.params, recent).cpu().numpy()).max())

    warm_preds, warm, _ = tf.fit_and_forecast_incremental(series.numpy(), state=state, device=cuda)
    torch.cuda.synchronize()
    assert warm.path == "cuda-warm" and ff.LAUNCHES.n == 2 and reg.bucket_hits == 2
    with ff.LAUNCHES.tally():
        eager_warm, _, _, _ = tf._bucketed_warm_fit_forecast_program(
            padded, weights, state.params, state.opt_state, CFG, tf.WARM_STEPS)
    warm_diff = float(np.abs(warm_preds - eager_warm[:50].cpu().numpy()).max())
    print(f"replay vs eager: cold {cold_diff:.3g}, warm {warm_diff:.3g}; "
          f"kernel in the replay vs its plain version {kernel_diff:.3g}")
    assert cold_diff <= COLD_TOL and warm_diff <= WARM_TOL and kernel_diff <= KERNEL_TOL
    led = graphcost.ledger().counters()
    assert led["replays"] == 2 and led["request_captures"] == 0 and led["eager_runs"] == 0


def test_rollup_replays_equal_their_oracles(cuda, monkeypatch):
    from headlamp_tpu_torch.analytics import stats
    from headlamp_tpu_torch.analytics.fleet_torch import REGION_CLUSTER_SEGMENTS
    from headlamp_tpu_torch.context import AcceleratorDataContext
    from headlamp_tpu_torch.fleet import fleet_transport, fleet_viewport
    from headlamp_tpu_torch.viewport import tree as vt

    reg = _registry(monkeypatch, [
        (aot.FLEET_ROLLUP, ((1024,), (1024,))), (aot.REGION_ROLLUP, ((1024,), (1024,))),
    ], cuda)
    with AcceleratorDataContext(fleet_transport(fleet_viewport(1024)), device=cuda) as ctx:
        state = ctx.sync().provider("tpu")
    got = stats.fleet_stats(state.view, device=cuda, fleet_cache=state.fleet_cache,
                            backend="cuda")
    assert got == stats.python_fleet_stats(state.view)
    tree = vt.viewport_tree(state)
    _, _, _, cluster_id, slice_id = vt._assignments(state.nodes)
    clusters, _ = vt._host_sums(
        state, cluster_id, slice_id, dict(tree.region_of), REGION_CLUSTER_SEGMENTS)
    assert [c.stats for c in tree.clusters] == clusters
    rows = graphcost.ledger().snapshot()["programs"]
    assert rows[aot.FLEET_ROLLUP]["replays"] == 1 and rows[aot.REGION_ROLLUP]["replays"] == 1
    assert reg.bucket_hits == 2


def test_a_fused_request_is_one_replay_and_one_copy(cuda, monkeypatch):
    from headlamp_tpu_torch.analytics import stats
    from headlamp_tpu_torch.domain.accelerator import classify_fleet
    from headlamp_tpu_torch.fleet import fleet_large
    from headlamp_tpu_torch.metrics.client import UtilizationHistory
    from headlamp_tpu_torch.models import service
    from headlamp_tpu_torch.runtime.device_cache import DeviceFleetCache, RollupResultCache

    key = ((1024,), (1024,), 64, 61, CFG, tf.WARM_STEPS)
    _registry(monkeypatch, [(aot.FUSED_PROGRAM, key)], cuda)
    fleet = fleet_large(1024)
    view = classify_fleet(fleet["nodes"], fleet["pods"])["tpu"]
    view.version = 5
    cache, results = DeviceFleetCache(cuda), RollupResultCache()
    assert cache.warm(view)
    series = tf.synthetic_telemetry(64, 61, torch.Generator().manual_seed(4), device="cpu")
    history = UtilizationHistory(keys=[(f"n{i}", "0") for i in range(64)],
                                 series=series.tolist(), step_s=60, end=0.0, resolved_query="t")
    _, state = service.forecast_from_history_incremental(history, device=cuda)
    ff.LAUNCHES.reset()
    before = transfer_stats.blocking_gets
    fused = service._fused_rollup_forecast(
        history, CFG, state, view, "live-window",
        device=cuda, fleet_cache=cache, rollup_results=results)
    assert fused is not None and fused[0].inference_path == "cuda-warm"
    assert transfer_stats.blocking_gets - before == 1 and ff.LAUNCHES.n == 1
    before = transfer_stats.blocking_gets
    got = stats.fleet_stats(view, device=cuda, fleet_cache=cache, rollup_results=results,
                            backend="cuda")
    assert transfer_stats.blocking_gets == before and got == stats.python_fleet_stats(view)
    assert graphcost.ledger().snapshot()["programs"][aot.FUSED_PROGRAM]["replays"] == 1

"""The port's CUDA kernel on the card: its wrapper against its plain
version at widths and batches the CPU tests cannot reach, its operand
checks, its replay inside a CUDA graph, the fit on the card against the
same fit on the CPU, the fleet rollup on the card against its Python
oracle, the viewport tree's region rollup on the card against
``_host_sums``, the trend statistics on the card against their plain
version, and the host's background warm landing on the app's card. The
kernel has no CPU mode, so every test here needs a CUDA device and skips
without one. On the card:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import exact_inputs
from headlamp_tpu_torch.metrics.client import UtilizationHistory
from headlamp_tpu_torch.models import forecast as tf
from headlamp_tpu_torch.models import fused_forward as ff
from headlamp_tpu_torch.models.forecast import (
    ForecastConfig,
    fit_and_forecast_incremental,
    init_params,
    synthetic_telemetry,
)
from headlamp_tpu_torch.models.service import (
    forecast_from_history,
    forecast_from_history_incremental,
)

#: Kernel against its plain version, max-abs (chip_smoke.py's bound).
KERNEL_TOL = 1e-3
#: Kernel against its plain version on exact_inputs, where every bf16
#: operand, product and partial sum is exact: only expf's ulps differ.
EXACT_TOL = 1e-6
#: Params after 5 Adam steps on the card against the same steps on the
#: CPU, max-abs: the devices sum in another order and nothing else.
STEP_TOL = 1e-4
#: 60-step fit on the card against the CPU's, predictions max-abs and MSE
#: relative. Adam amplifies f32 summation-order noise over 60 steps: the
#: CPU fit moves this far (up to about 3e-2) when its input moves by one
#: ulp, which the test measures and prints beside the card's difference.
FIT_TOL = 5e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _params(window, hidden, horizon, device, seed=0):
    """Seeded params with non-zero biases, on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    cfg = ForecastConfig(window=window, hidden=hidden, horizon=horizon)
    params = init_params(gen, cfg, device="cpu")
    return {k: (v + 0.05 * torch.randn(v.shape, generator=gen)).to(device)
            for k, v in params.items()}


def _rows(rows, window, device):
    return torch.rand((rows, window), generator=torch.Generator().manual_seed(rows)).to(device)


@pytest.mark.parametrize(
    "batches,window,hidden,horizon",
    [
        # The 64-row tiles' edges at the main path's widths, up to more
        # tiles than the grid's warpgroups take in one pass.
        ((1, 63, 64, 65, 127, 128, 129, 4097), 32, 128, 8),
        ((300,), 5, 20, 3),        # widths that fill no fragment; ragged tail
        ((129,), 128, 128, 128),   # every dimension at the guard's limit
        ((7,), 1, 1, 1),           # arrays below one 16-byte bulk copy
    ],
)
def test_kernel_matches_plain_version(cuda, batches, window, hidden, horizon):
    params = _params(window, hidden, horizon, cuda)
    for rows in batches:
        x = _rows(rows, window, cuda)
        before = ff.LAUNCHES.n
        got = ff.forecast_forward(params, x)
        assert ff.LAUNCHES.n == before + 1
        want = ff.forecast_forward_reference(params, x)
        assert got.shape == (rows, horizon) and got.device.type == "cuda"
        err = float((got - want).abs().max())
        print(f"kernel vs plain ({rows}, {window}, {hidden}, {horizon}): max-abs {err:.3g}")
        assert err <= KERNEL_TOL, rows


@pytest.mark.parametrize(
    "rows,window,hidden,horizon",
    [(4097, 32, 128, 8), (300, 5, 20, 3), (129, 128, 128, 128)],
)
def test_kernel_exact_arithmetic(cuda, rows, window, hidden, horizon):
    # A wrong wgmma descriptor or fragment map moves outputs by far more
    # than the 1e-6 left to expf here.
    params, x = exact_inputs(window, hidden, horizon, rows, seed=rows)
    params = {k: v.to(cuda) for k, v in params.items()}
    got = ff.forecast_forward_cuda(params, x.to(cuda))
    want = ff.forecast_forward_reference(params, x.to(cuda))
    err = float((got - want).abs().max())
    print(f"exact inputs ({rows}, {window}, {hidden}, {horizon}): max-abs {err:.3g}")
    assert err <= EXACT_TOL


def test_wrapper_rejects_misaligned_operands(cuda):
    params = _params(32, 128, 8, cuda)
    buf = torch.zeros(4 * 32 + 1, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ff.forecast_forward_cuda(params, buf[1:].view(4, 32))
    shifted = torch.zeros(128 * 128 + 1, device=cuda)[1:].view(128, 128)
    with pytest.raises(ValueError, match="w2 must start"):
        ff.forecast_forward_cuda(dict(params, w2=shifted), buf[:-1].view(4, 32))


def test_one_chip_forecast_runs_the_kernel(cuda):
    # One chip, 61 samples: the latest window is a contiguous slice that
    # starts 116 bytes into the series, so the path must copy it to an
    # aligned x before the kernel's bulk copies read it.
    series = synthetic_telemetry(1, 61, device="cpu")
    history = UtilizationHistory(keys=[("node-0", "0")], series=series.tolist(), step_s=60,
                                 end=0.0, resolved_query="tensorcore_utilization")
    before = ff.LAUNCHES.n
    cold, state = forecast_from_history_incremental(history, device=cuda)
    warm, _ = forecast_from_history_incremental(history, state=state, device=cuda)
    plain = forecast_from_history(history, device=cuda)
    assert ff.LAUNCHES.n == before + 3
    assert [v.inference_path for v in (cold, warm, plain)] == ["cuda", "cuda-warm", "cuda"]
    want = ff.forecast_forward_reference(state.params, series[:, -32:].to(cuda))[0]
    assert abs(cold.chips[0].predicted_peak - float(want.max())) <= KERNEL_TOL
    assert abs(cold.chips[0].predicted_mean - float(want.mean())) <= KERNEL_TOL


def test_wrapper_rejects_bad_operands(cuda):
    params = _params(32, 128, 8, cuda)
    x = _rows(4, 32, cuda)
    with pytest.raises(TypeError):
        ff.forecast_forward_cuda(params, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        ff.forecast_forward_cuda(params, _rows(32, 4, cuda).t())
    with pytest.raises(ValueError, match="is on"):
        ff.forecast_forward_cuda(dict(params, b1=params["b1"].cpu()), x)
    with pytest.raises(ValueError, match="single-tile"):
        ff.forecast_forward_cuda(dict(params, w1=torch.zeros((32, 256), device=cuda)), x)


def test_kernel_replays_in_a_cuda_graph(cuda):
    # The wrapper never syncs the host, so it can be captured; the replay
    # reads the captured input buffer anew.
    params = _params(32, 128, 8, cuda)
    x = _rows(256, 32, cuda)
    ff.forecast_forward_cuda(params, x)  # build and configure outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ff.forecast_forward_cuda(params, x)
    x.copy_(_rows(256, 32, "cpu").flip(0))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ff.forecast_forward_cuda(params, x))


def test_training_steps_on_card_match_cpu(cuda):
    cfg = ForecastConfig()
    x, y = tf.make_windows(synthetic_telemetry(64, 61, device="cpu"), cfg.window, cfg.horizon)
    init = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    diffs = {}
    for steps in (1, 5, 20, 60):
        on_cpu, _, _ = tf._train(x, y, init, tf.adam_init(init), cfg, steps)
        card_init = {k: v.to(cuda) for k, v in init.items()}
        on_card, _, _ = tf._train(
            x.to(cuda), y.to(cuda), card_init, tf.adam_init(card_init), cfg, steps
        )
        diffs[steps] = max(float((on_cpu[k] - on_card[k].cpu()).abs().max()) for k in on_cpu)
    print("card vs CPU params max-abs by steps:", {k: f"{v:.3g}" for k, v in diffs.items()})
    assert diffs[5] <= STEP_TOL


def test_fit_on_card_matches_cpu(cuda):
    series = synthetic_telemetry(64, 61, device="cpu").numpy()
    on_card, card, _ = fit_and_forecast_incremental(series, device=cuda)
    on_cpu, cpu, _ = fit_and_forecast_incremental(series, device="cpu")
    nudged, cpu_nudged, _ = fit_and_forecast_incremental(
        np.nextafter(series, np.float32(2.0)), device="cpu"
    )
    assert card.path == "cuda" and cpu.path == "torch"

    def gap(preds, dispatch):
        return (float(np.abs(preds - on_cpu).max()),
                abs(dispatch.fit_mse - cpu.fit_mse) / cpu.fit_mse)

    pred_diff, mse_rel = gap(on_card, card)
    noise_pred, noise_mse = gap(nudged, cpu_nudged)
    print(f"card vs CPU fit: preds max-abs {pred_diff:.3g}, mse rel {mse_rel:.3g}; "
          f"CPU vs CPU on a one-ulp nudge: {noise_pred:.3g}, {noise_mse:.3g}")
    assert pred_diff <= FIT_TOL and mse_rel <= FIT_TOL


def test_dashboard_host_round_trip_on_card(cuda):
    # The server on the card: a cold GET fits once through the kernel,
    # and after the TTL a background refit warm-starts from the carry.
    import urllib.request

    from headlamp_tpu_torch.runtime.device_cache import warm_carries
    from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

    from headlamp_tpu_torch.models import aot

    warm_carries.invalidate()
    mono = [0.0]
    app = DashboardApp(make_demo_transport("v5e4"), device=cuda, monotonic=lambda: mono[0])
    # serve() starts the process's program registry: a fresh one, restored
    # after, so the later card tests keep their eager path.
    previous = aot.set_registry(aot.AotProgramRegistry())
    server = app.serve("127.0.0.1", 0)

    def view():
        m = app._cached_metrics()
        return app._forecast_refresher.peek(app._metrics_key(m), epoch=app._cache_epoch)

    try:
        before = ff.LAUNCHES.n
        with urllib.request.urlopen(server.url + "/tpu/metrics", timeout=120) as resp:
            assert resp.status == 200
        assert ff.LAUNCHES.n == before + 1 and view().inference_path == "cuda"
        assert app.last_request_device_gets == 1
        mono[0] += app.FORECAST_TTL_S + 1
        with urllib.request.urlopen(server.url + "/tpu/metrics", timeout=120) as resp:
            assert resp.status == 200
        assert app._forecast_refresher.drain()
        assert ff.LAUNCHES.n == before + 2 and view().inference_path == "cuda-warm"
    finally:
        server.close()
        aot.set_registry(previous)


def _tpu_view(n_nodes, version=None):
    from headlamp_tpu_torch.domain.accelerator import classify_fleet
    from headlamp_tpu_torch.fleet import fleet_large

    fleet = fleet_large(n_nodes)
    view = classify_fleet(fleet["nodes"], fleet["pods"])["tpu"]
    view.version = version
    return view


@pytest.mark.parametrize("n_nodes", [1024, 4096])
def test_fleet_rollup_on_card_matches_the_oracle(cuda, n_nodes):
    from headlamp_tpu_torch.analytics import stats

    view = _tpu_view(n_nodes)
    got = stats.fleet_stats(view, device=cuda, backend="cuda")
    assert got == stats.python_fleet_stats(view)


def test_fleet_rollup_reads_columns_uploaded_by_another_thread(cuda):
    # One thread uploads the columns on its own stream; another rolls
    # them up on its own: the entry is published only once complete.
    import threading

    from headlamp_tpu_torch.analytics import stats
    from headlamp_tpu_torch.runtime.device_cache import DeviceFleetCache

    view = _tpu_view(4096, version=1)
    cache = DeviceFleetCache(cuda)

    def upload():
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            assert cache.warm(view)

    t = threading.Thread(target=upload)
    t.start()
    t.join()
    with torch.cuda.stream(torch.cuda.Stream(cuda)):
        got = stats.fleet_stats(view, device=cuda, fleet_cache=cache, backend="cuda")
    assert cache.counters() == {"hits": 1, "misses": 0, "uploads": 1}
    assert got == stats.python_fleet_stats(view)


def _viewport_state(n_nodes, device):
    from headlamp_tpu_torch.context import AcceleratorDataContext
    from headlamp_tpu_torch.fleet import fleet_transport, fleet_viewport

    with AcceleratorDataContext(fleet_transport(fleet_viewport(n_nodes)), device=device) as ctx:
        return ctx.sync().provider("tpu")


def _tree_against_host_sums(state):
    """The tree's cluster and slice stats beside ``_host_sums``'."""
    from headlamp_tpu_torch.analytics.fleet_torch import REGION_CLUSTER_SEGMENTS
    from headlamp_tpu_torch.viewport import tree as vt

    tree = vt.viewport_tree(state)
    _, _, _, cluster_id, slice_id = vt._assignments(state.nodes)
    clusters, slices = vt._host_sums(
        state, cluster_id, slice_id, dict(tree.region_of), REGION_CLUSTER_SEGMENTS
    )
    got_clusters = [c.stats for c in tree.clusters]
    got_slices = {s.path: s.stats for c in tree.clusters for s in c.children}
    want_slices = {vt.region_path(*pair): slices[sid] for pair, sid in slice_id.items()}
    return tree, (got_clusters, got_slices), (clusters, want_slices)


@pytest.mark.parametrize("n_nodes", [1024, 16384])
def test_region_rollup_on_card_matches_host_sums(cuda, n_nodes):
    from headlamp_tpu_torch.runtime.transfer import transfer_stats

    state = _viewport_state(n_nodes, cuda)
    before = transfer_stats.blocking_gets
    tree, got, want = _tree_against_host_sums(state)
    assert tree.source == "device" and transfer_stats.blocking_gets == before + 1
    assert got == want


def test_region_tree_reads_columns_uploaded_by_another_thread(cuda):
    # One thread uploads the columns on its own stream; another builds
    # the tree on its own: the entry is published only once complete.
    import threading

    state = _viewport_state(4096, cuda)

    def upload():
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            assert state.fleet_cache.warm(state.view)

    t = threading.Thread(target=upload)
    t.start()
    t.join()
    out = {}

    def build():
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            out["result"] = _tree_against_host_sums(state)

    t = threading.Thread(target=build)
    t.start()
    t.join()
    tree, got, want = out["result"]
    assert state.fleet_cache.counters() == {"hits": 1, "misses": 0, "uploads": 1}
    assert tree.source == "device" and got == want


def test_trend_stats_on_card_match_the_plain_version(cuda):
    from headlamp_tpu_torch.analytics.trends import python_series_stats, series_stats_batch

    rng = np.random.default_rng(5)
    cases = [[], [float(np.float32(0.3))], [float(np.float32(0.1))] * 288,
             rng.random(288).astype(np.float32).tolist(),
             (rng.random(17) * 1000).astype(np.float32).tolist()]
    for got, case in zip(series_stats_batch(cases, device=cuda), cases):
        want = python_series_stats(case)
        assert all(got[k] == want[k] for k in ("n", "latest", "min", "max"))
        for k in ("mean", "slope_per_step"):
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k
    assert series_stats_batch(cases[2:3], device=cuda)[0]["slope_per_step"] == 0.0


def test_background_warm_lands_on_the_apps_card(cuda):
    # The loop's thread starts with no CUDA context: its warm must land
    # on the app's card, and the request path then only reads it.
    import copy
    import time

    from headlamp_tpu_torch.fleet import fleet_transport, fleet_viewport
    from headlamp_tpu_torch.server import DashboardApp

    t = fleet_transport(fleet_viewport(1024))
    app = DashboardApp(t, device=cuda, min_sync_interval_s=3600.0)
    app.start_background_sync(3600.0)

    def wait_ticks(n):
        deadline = time.monotonic() + 60
        while app._background_counters["ticks"] < n:
            assert time.monotonic() < deadline
            time.sleep(0.005)

    try:
        wait_ticks(1)
        cache = app._ctx.fleet_cache
        view = app._last_snapshot.provider("tpu").view
        cols = cache.fleet_for(view)
        assert cols.node_capacity.device == torch.device("cuda", torch.cuda.current_device())
        assert cache.counters()["uploads"] == 1 and app._background_counters["warms"] == 1
        assert app.handle("/tpu/fleet")[0] == 200 and app.last_request_device_gets == 1
        node = copy.deepcopy(view.nodes[0])
        node["metadata"]["labels"]["example.com/marker"] = "x"
        t.node_feed.push("MODIFIED", node)
        app._background_wake.set()
        wait_ticks(2)
        assert app._background_counters["warms"] == 2 and cache.counters()["uploads"] == 2
        assert app.handle("/tpu/fleet")[0] == 200 and cache.counters()["uploads"] == 2
    finally:
        app.close()

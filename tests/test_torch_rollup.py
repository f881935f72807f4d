"""The port's fleet rollup against the JAX package's, on the CPU.

From the same fleet, both encoders give the same columns; from the same
columns, the port's ``rollup_to_dict`` on the CPU equals JAX's exactly,
and ``fleet_stats`` on either backend equals the Python oracle of both
packages, exactly. The edge fleet holds zero-allocatable, not-ready,
unscheduled and out-of-vocabulary-generation rows. Then the backend
policy: Python below the floor, one probe per window, ``recalibrate``
resets, and a device rollup that raises propagates with no Python
fallback.
"""

import numpy as np
import pytest

from headlamp_tpu.analytics import encode as jenc
from headlamp_tpu.analytics import fleet_jax
from headlamp_tpu.analytics import stats as jstats
from headlamp_tpu.domain import accelerator as jacc
from headlamp_tpu.fleet import fixtures as jfx
from headlamp_tpu_torch.analytics import encode as tenc
from headlamp_tpu_torch.analytics import fleet_torch
from headlamp_tpu_torch.analytics import stats as tstats
from headlamp_tpu_torch.domain import accelerator as tacc
from headlamp_tpu_torch.obs.trace import trace_request
from headlamp_tpu_torch.runtime.device_cache import DeviceFleetCache
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

CLOCK = 1785283200.0


def _edge_fleet():
    """Rows the padding, masking and vocabulary rules must get right."""
    nodes = [
        jfx.make_tpu_node("zero-alloc", chips=0, pool="edge"),
        jfx.make_tpu_node("down", chips=4, ready=False, pool="edge"),
        jfx.make_tpu_node("v7x", accelerator="tpu-v7x-slice", topology="2x2", chips=8),
        jfx.make_tpu_node("full", chips=4, pool="full"),
        jfx.make_plain_node("cpu-only"),
    ]
    pods = [
        jfx.make_tpu_pod("on-zero", node="zero-alloc", chips=1),
        jfx.make_tpu_pod("on-down", node="down", chips=4),
        jfx.make_tpu_pod("on-v7x", node="v7x", chips=7),
        jfx.make_tpu_pod("full-a", node="full", chips=4),
        jfx.make_tpu_pod("unscheduled-running", node=None, chips=2),
        jfx.make_tpu_pod("pending", node=None, chips=4, phase="Pending"),
        jfx.make_tpu_pod("on-cpu-node", node="cpu-only", chips=1),
        jfx.make_tpu_pod("done", node="full", chips=4, phase="Succeeded"),
        jfx.make_tpu_pod("odd-phase", node="full", chips=4, phase="Weird"),
    ]
    return {"nodes": nodes, "pods": pods}


FLEETS = {
    "v5e4": jfx.fleet_v5e4,
    "v5p32": jfx.fleet_v5p32,
    "v5p32_degraded": jfx.fleet_v5p32_degraded,
    "large": lambda: jfx.fleet_large(1024),
    "edge": _edge_fleet,
}


@pytest.fixture(autouse=True)
def _fresh_calibration():
    tstats.calibration.reset()
    yield
    tstats.calibration.reset()


def _views(fleet):
    f = FLEETS[fleet]()
    jview = jacc.classify_fleet(f["nodes"], f["pods"], (jacc.TPU_PROVIDER,))["tpu"]
    tview = tacc.classify_fleet(f["nodes"], f["pods"])["tpu"]
    return jview, tview


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_rollup_matches_jax_and_the_oracle(fleet):
    jview, tview = _views(fleet)
    jcols = jenc.encode_fleet(jview.nodes, jview.pods)
    tcols = tenc.encode_fleet(tview.nodes, tview.pods)
    for name in fleet_torch.COLUMNS:
        got, want = getattr(tcols, name), getattr(jcols, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert tcols.node_names == jcols.node_names

    # The same columns through both rollups: exactly equal host dicts.
    got = fleet_torch.rollup_to_dict(tcols, "cpu")
    want = fleet_jax.rollup_to_dict(jcols)
    assert got == want
    assert all(type(v) is int for v in got["per_node_in_use"])

    # The served stats, on the device rollup and on the Python pass,
    # equal both packages' oracle.
    oracle = jstats.python_fleet_stats(jview)
    assert tstats.python_fleet_stats(tview) == oracle
    assert tstats.fleet_stats(tview, device="cpu", backend="torch") == oracle
    if fleet == "edge":
        assert got["generation_counts"]["other"] == 1 and oracle["generation_counts"]["v7x"] == 1
        assert got["in_use"] == 1 + 4 + 7 + 4 + 2 + 1  # every Running pod
        assert got["per_node_in_use"] == [1, 4, 7, 4]  # no row for the unscheduled
        assert got["hot_nodes"] == 2 and got["max_node_util_pct"] == 100.0


def test_small_fleet_serves_python_and_never_probes():
    _, view = _views("v5p32")
    assert tstats.chosen_backend(len(view.nodes), "cpu") == "python"
    with trace_request("/t") as trace:
        stats = tstats.fleet_stats(view, device="cpu")
    rollup = trace.to_dict()["spans"][0]
    assert rollup["name"] == "analytics.rollup" and rollup["attrs"]["backend"] == "python"
    assert stats == tstats.python_fleet_stats(view)
    assert tstats.calibration.device_ms is None


def test_one_probe_per_window_and_the_measured_winner_serves(monkeypatch):
    _, view = _views("large")
    view.version = 1
    cache = DeviceFleetCache("cpu")
    assert tstats.chosen_backend(len(view.nodes), "cpu") == "calibrating"
    with trace_request("/t") as trace:
        first = tstats.fleet_stats(view, device="cpu", fleet_cache=cache)
    rollup = trace.to_dict()["spans"][0]
    assert rollup["attrs"]["backend"] == "torch" and rollup["attrs"]["fleet_cache"] == "miss"
    assert [c["name"] for c in rollup["children"]] == ["device_cache.upload", "analytics.calibrate"]
    # One upload, then four rollups on the cached columns' entry.
    assert cache.counters() == {"hits": 3, "misses": 1, "uploads": 1}
    stamp = tstats.calibration.calibrated_at
    assert stamp is not None and tstats.calibration.backend == "torch"
    assert first == tstats.python_fleet_stats(view)

    # Inside the window the winner serves, without a probe.
    winner = tstats.chosen_backend(len(view.nodes), "cpu")
    assert winner in ("torch", "python")
    assert tstats.fleet_stats(view, device="cpu", fleet_cache=cache) == first
    assert tstats.calibration.calibrated_at == stamp

    # Past the TTL the next request re-probes; a request that loses the
    # probe lock serves the stale winner meanwhile.
    now = stamp + tstats.CALIBRATION_TTL_S + 1
    monkeypatch.setattr(tstats.time, "monotonic", lambda: now)
    assert tstats.chosen_backend(len(view.nodes), "cpu") == "calibrating"
    assert tstats.calibration.try_begin_probe()
    try:
        with trace_request("/t") as trace:
            tstats.fleet_stats(view, device="cpu", fleet_cache=cache)
        assert trace.to_dict()["spans"][0]["attrs"]["backend"] == winner
        assert tstats.calibration.calibrated_at == stamp
    finally:
        tstats.calibration.end_probe()
    tstats.fleet_stats(view, device="cpu", fleet_cache=cache)
    assert tstats.calibration.calibrated_at == now

    # A first calibration lost to a probe in flight serves Python.
    tstats.calibration.reset()
    assert tstats.calibration.try_begin_probe()
    try:
        with trace_request("/t") as trace:
            tstats.fleet_stats(view, device="cpu", fleet_cache=cache)
        assert trace.to_dict()["spans"][0]["attrs"]["backend"] == "python"
    finally:
        tstats.calibration.end_probe()


def test_recalibrate_resets_the_measurement_and_the_device_columns():
    app = DashboardApp(make_demo_transport("large"), device="cpu", clock=lambda: CLOCK)
    try:
        assert app.handle("/tpu")[0] == 200
        assert tstats.calibration.device_ms is not None
        assert app._ctx.fleet_cache.snapshot()["entries"] == {"tpu": 1}
        # The routine header link keeps both.
        assert app.handle("/refresh?back=/tpu") == (302, "/tpu", "")
        assert tstats.calibration.device_ms is not None
        assert app.handle("/refresh?back=/tpu&recalibrate=1") == (302, "/tpu", "")
        assert tstats.calibration.device_ms is None
        assert app._ctx.fleet_cache.snapshot()["entries"] == {}
    finally:
        app.close()


def test_device_rollup_error_propagates_without_fallback(monkeypatch):
    def broken(fleet, device=None):
        raise RuntimeError("rollup kernel failed")

    python_calls = []
    monkeypatch.setattr(fleet_torch, "rollup_to_dict", broken)
    monkeypatch.setattr(
        tstats, "python_fleet_stats", lambda view: python_calls.append(view) or {}
    )
    _, view = _views("large")
    for _ in range(3):  # no failure is memoized: every call raises again
        with pytest.raises(RuntimeError, match="rollup kernel failed"):
            tstats.fleet_stats(view, device="cpu")
    with pytest.raises(RuntimeError, match="rollup kernel failed"):
        tstats.fleet_stats(view, device="cpu", backend="torch")
    assert python_calls == []
    with pytest.raises(ValueError, match="does not run on cpu"):
        tstats.fleet_stats(view, device="cpu", backend="cuda")

"""The port's push differ against the JAX package's, on the CPU.

Each package syncs a snapshot of the same fixture fleet with both
providers (``fleet_mixed`` carries Intel nodes and pods beside the TPU
ones), and
``build_page_models`` must be JSON-equal across the packages, region
models included. The same metrics and forecast peek objects (made from a
seed with numpy) fill both metrics models. The same churn applied to both
fleets (a node's Ready flip, an added pod, a removed node, a forecast
moved by 1e-9 and by 1e-3) gives equal ``diff_models`` frames and equal
``ChangeLog`` change sets, and every frame survives ``json.dumps``.
Everything is exact.
"""

import copy
import json
from types import SimpleNamespace

import numpy as np
import pytest

from headlamp_tpu.context import AcceleratorDataContext as JaxContext
from headlamp_tpu.fleet import fixtures as jfx
from headlamp_tpu.push import differ as jdiffer
from headlamp_tpu_torch.context import AcceleratorDataContext
from headlamp_tpu_torch.fleet import fixtures as tfx
from headlamp_tpu_torch.push import differ as tdiffer

CLOCK = 1785283200.0
FLEETS = {
    "v5p32": lambda m: m.fleet_v5p32(),
    "v5p32_degraded": lambda m: m.fleet_v5p32_degraded(),
    "large1024": lambda m: m.fleet_large(1024),
    "viewport1024": lambda m: m.fleet_viewport(1024),
    "mixed": lambda m: m.fleet_mixed(),
}


def _snaps(jax_fleet, torch_fleet):
    jctx = JaxContext(jfx.fleet_transport(jax_fleet), clock=lambda: CLOCK)
    tctx = AcceleratorDataContext(
        tfx.fleet_transport(torch_fleet), device="cpu", clock=lambda: CLOCK
    )
    return jctx.sync(), tctx.sync()


def _peeks(n_chips, seed=0, shift=0.0):
    """One metrics peek and one forecast peek, shared by both packages."""
    rng = np.random.default_rng(seed)
    chips = [
        SimpleNamespace(
            node=f"node-{i // 4}", accelerator_id=str(i % 4),
            tensorcore_utilization=float(rng.random()),
            duty_cycle=None if i % 7 == 0 else float(rng.random()),
            hbm_bytes_used=float(rng.integers(0, 2**34)), hbm_bytes_total=float(2**34),
        )
        for i in range(n_chips)
    ]
    forecast_chips = []
    for c in chips:
        peak = min(float(rng.random()) + shift, 1.0)
        forecast_chips.append(SimpleNamespace(
            node=c.node, accelerator_id=c.accelerator_id, current=c.tensorcore_utilization,
            predicted_peak=peak, predicted_mean=peak / 2, saturation_risk=peak >= 0.9,
        ))
    return SimpleNamespace(chips=chips), SimpleNamespace(horizon_s=900, chips=forecast_chips)


def _jsonable(models):
    return json.loads(json.dumps(models, sort_keys=True))


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_page_models_equal_jax_on_every_fixture_fleet(fleet):
    make = FLEETS[fleet]
    jsnap, tsnap = _snaps(make(jfx), make(tfx))
    metrics, forecast = _peeks(16)
    want = jdiffer.build_page_models(jsnap, metrics=metrics, forecast=forecast)
    got = tdiffer.build_page_models(tsnap, metrics=metrics, forecast=forecast)
    assert _jsonable(got) == _jsonable(want)
    assert set(got) == set(want)
    regions = [k for k in got if k.startswith(tdiffer.REGION_PAGE_PREFIX)]
    if fleet == "mixed":
        # The Intel provider's overview cells are in the models.
        assert any(k.startswith("intel.") for k in got["/tpu"]["cells"])
    if fleet == "viewport1024":
        # 8 clusters of 32-host slices: every cluster and slice has a model.
        assert len([r for r in regions if "/slice/" not in r]) == 8
    assert len(regions) > 0
    # Without peeks the metrics model says so, in both packages.
    assert _jsonable(tdiffer.build_page_models(tsnap)["/tpu/metrics"]) == _jsonable(
        jdiffer.build_page_models(jsnap)["/tpu/metrics"]
    ) == {"cells": {"available": False, "forecast": False}, "rows": {}}


def test_metrics_rows_round_as_jax_does():
    metrics, forecast = _peeks(64, seed=3)
    for package in (tdiffer, jdiffer):
        assert package.PAGES == ("/tpu", "/tpu/nodes", "/tpu/pods", "/tpu/metrics")
    jsnap, tsnap = _snaps(jfx.fleet_v5p32(), tfx.fleet_v5p32())
    want = jdiffer.build_page_models(jsnap, metrics=metrics, forecast=forecast)["/tpu/metrics"]
    got = tdiffer.build_page_models(tsnap, metrics=metrics, forecast=forecast)["/tpu/metrics"]
    assert got == want
    assert got["cells"]["chips"] == 64 and len(got["rows"]) == 128
    row = got["rows"]["node-0/1"]
    assert row[0] == round(metrics.chips[1].tensorcore_utilization, 4)


def _churn(fleet, step):
    """The fleet after churn ``step``: 1 flips a node's Ready, 2 also adds
    a pod, 3 also removes a node."""
    fleet = copy.deepcopy(fleet)
    if step >= 1:
        for cond in fleet["nodes"][1]["status"]["conditions"]:
            if cond["type"] == "Ready":
                cond["status"] = "False" if cond["status"] == "True" else "True"
    if step >= 2:
        node = fleet["nodes"][2]["metadata"]["name"]
        fleet["pods"].append(tfx.make_tpu_pod("churn-train", namespace="team-churn", node=node))
    if step >= 3:
        del fleet["nodes"][3]
    return fleet


@pytest.mark.parametrize("fleet", ["v5p32", "viewport1024", "mixed"])
def test_churn_frames_and_change_sets_equal_jax(fleet):
    base = FLEETS[fleet](tfx)
    metrics, forecast = _peeks(16, seed=1)
    steps = [(0, forecast)]
    steps += [(s, forecast) for s in (1, 2, 3)]
    # A forecast moved by 1e-9 is no change; by 1e-3 it is.
    _, tiny = _peeks(16, seed=1, shift=1e-9)
    _, moved = _peeks(16, seed=1, shift=1e-3)
    steps += [(3, tiny), (3, moved)]
    jlog, tlog = jdiffer.ChangeLog(), tdiffer.ChangeLog()
    jprev = tprev = None
    frame_counts = []
    for gen, (step, fc) in enumerate(steps, start=1):
        jsnap, tsnap = _snaps(_churn(base, step), _churn(base, step))
        jmodels = jdiffer.build_page_models(jsnap, metrics=metrics, forecast=fc)
        tmodels = tdiffer.build_page_models(tsnap, metrics=metrics, forecast=fc)
        if tprev is not None:
            want = jdiffer.diff_models(jprev, jmodels)
            got = tdiffer.diff_models(tprev, tmodels)
            assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
            assert tlog.record(gen, got) == jlog.record(gen, want)
            frame_counts.append(len(got))
            for frame in got.values():
                assert json.loads(json.dumps(frame)) == frame
        jprev, tprev = jmodels, tmodels
    # flip, pod, removal, 1e-9 (no frame), 1e-3 (the metrics page only).
    assert frame_counts[0] > 0 and frame_counts[3] == 0 and frame_counts[4] == 1
    for page in ("/tpu/nodes", "/tpu/pods", "/tpu/metrics", "/tpu"):
        for gen in (0, 2, 4, 6):
            assert tlog.changed_keys(page, gen) == jlog.changed_keys(page, gen)
    assert tlog.oldest() == jlog.oldest() == 2


def test_change_log_horizon_and_frame_keys_match_jax():
    frame = {"page": "/tpu", "cells": {"errors": 1}, "rows": {"a": [1]}, "removed": ["b"]}
    assert tdiffer.frame_changed_keys(frame) == jdiffer.frame_changed_keys(frame) == {
        "a", "b", "cell:errors"
    }
    tlog, jlog = tdiffer.ChangeLog(limit=2), jdiffer.ChangeLog(limit=2)
    for gen in (3, 4, 5):
        frames = {"/tpu": dict(frame, rows={f"r{gen}": [gen]})}
        assert tlog.record(gen, frames) == jlog.record(gen, frames)
    for gen in (0, 2, 3, 4, 5, 9):
        assert tlog.changed_keys("/tpu", gen) == jlog.changed_keys("/tpu", gen)
    assert tlog.changed_keys("/tpu", 2) is None and tlog.oldest() == 4

"""The port's program registry (``headlamp_tpu_torch/models/aot.py``) on
the CPU, where each builder returns the program as an eager callable:
the lifecycle on a scripted clock, hit and miss counting, the ``ensure``
backfill, a broken spec, and the bucket tables against JAX's
``headlamp_tpu/models/aot.py``. The graphs themselves are held on the
card by ``tests/test_torch_cuda_graphs.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from headlamp_tpu.analytics import encode as jax_encode
from headlamp_tpu.models import aot as jax_aot
from headlamp_tpu_torch.analytics import encode as port_encode
from headlamp_tpu_torch.models import aot
from headlamp_tpu_torch.models import forecast as tf
from headlamp_tpu_torch.obs import graphcost
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

torch.set_num_threads(1)

CFG = tf.ForecastConfig()
ROLLUP_8 = ("analytics.fleet_rollup", ((8,), (8,)))


class _Perf:
    """Scripted perf_counter: each read advances ``step`` seconds."""

    def __init__(self, step: float) -> None:
        self.now, self.step = 0.0, step

    def __call__(self) -> float:
        value, self.now = self.now, self.now + self.step
        return value


@pytest.fixture()
def fresh(monkeypatch):
    """A fresh process registry and ledger for one test."""

    def install(reg: aot.AotProgramRegistry) -> aot.AotProgramRegistry:
        monkeypatch.setattr(aot, "_REGISTRY", reg)
        return reg

    monkeypatch.setattr(graphcost, "_LEDGER", graphcost.GraphCostLedger())
    return install


def _series(n_chips: int, length: int = 48) -> np.ndarray:
    rng = np.random.default_rng(n_chips)
    return (0.3 + 0.4 * rng.random((n_chips, length))).astype(np.float32)


def test_blocking_startup_captures_every_spec_on_a_scripted_clock(fresh):
    reg = fresh(aot.AotProgramRegistry(
        specs=[(aot.COLD_PROGRAM, (8, 48, CFG, 2)), ROLLUP_8], perf=_Perf(0.5),
    ))
    assert reg.state == "idle" and not reg.ready()
    reg.compile_startup("cpu", block=True)
    assert reg.ready() and reg.wait_ready(0.1) and reg.programs_compiled == 2
    assert reg.compile_errors == 0 and reg.last_error is None
    # Each capture reads the scripted clock twice: 500 ms each.
    assert reg.compile_ms_total == pytest.approx(1000.0)
    snap = reg.snapshot()
    assert snap["state"] == "ready" and snap["device"] == "cpu"
    assert snap["programs"] == sorted([aot.COLD_PROGRAM, ROLLUP_8[0]])
    assert all(isinstance(v, int) for v in reg.counters().values())
    reg.compile_startup("cpu", block=True)  # idempotent
    assert reg.programs_compiled == 2


def test_background_startup_is_ledger_tracked_and_joins(fresh):
    reg = fresh(aot.AotProgramRegistry(specs=[ROLLUP_8]))
    reg.compile_startup("cpu")
    assert reg.wait_ready(60.0) and reg.join(60.0)
    led = graphcost.ledger()
    assert led.counters()["startup_captures"] == 1 and led.request_captures() == 0
    program = reg.lookup(*ROLLUP_8, torch.device("cpu"))
    cols = [torch.zeros(8, dtype=torch.int32) for _ in range(9)]
    reg.replay(*ROLLUP_8, program, cols, lambda out: out[0].clone())
    row = led.snapshot()["programs"]["analytics.fleet_rollup"]
    assert (row["captures"], row["startup_captures"], row["replays"]) == (1, 1, 1)
    assert led.request_captures() == 0


def test_lookups_count_hits_and_misses_and_a_miss_runs_eagerly(fresh):
    reg = fresh(aot.AotProgramRegistry(specs=[
        (aot.COLD_PROGRAM, (8, 48, CFG, 4)), (aot.WARM_PROGRAM, (8, 48, CFG, 2)),
    ]))
    cpu = torch.device("cpu")
    assert reg.lookup(*ROLLUP_8, cpu) is None and reg.bucket_misses == 0  # not started
    reg.compile_startup("cpu", block=True)
    # A hit: the bucketed cold and warm programs serve 5 chips at bucket 8.
    _, cold, state = tf.fit_and_forecast_incremental(_series(5), steps=4, device="cpu")
    _, warm, _ = tf.fit_and_forecast_incremental(
        _series(5), state=state, steps=4, warm_steps=2, device="cpu")
    assert cold.path == "torch" and warm.path == "torch-warm"
    assert reg.bucket_hits == 2 and reg.bucket_misses == 0
    assert reg.donation_saved_bytes == sum(
        t.numel() * t.element_size() for t in tf.carry_tensors(state.params, state.opt_state))
    # Misses: a key no spec holds, a chip count above every bucket.
    assert reg.executable(*ROLLUP_8, cpu) is None
    tf.fit_and_forecast_incremental(_series(300), steps=1, device="cpu")
    tf.fit_and_forecast_incremental(_series(5), steps=3, device="cpu")
    assert reg.bucket_hits == 2 and reg.bucket_misses == 3
    rows = graphcost.ledger().snapshot()["programs"]
    assert rows[aot.COLD_PROGRAM]["replays"] == 1 and rows[aot.WARM_PROGRAM]["replays"] == 1
    assert rows["forecast.fit_forecast_state_program"]["eager"] == 2
    assert graphcost.ledger().request_captures() == 0


def test_ensure_backfills_in_the_background(fresh):
    reg = fresh(aot.AotProgramRegistry(specs=[]))
    reg.compile_startup("cpu", block=True)
    reg.ensure_rollup_shapes(8, 8, "cpu")
    assert reg.join(60.0)
    cpu = torch.device("cpu")
    assert reg.executable(*ROLLUP_8, cpu) is not None
    assert reg.executable("analytics.region_rollup", ROLLUP_8[1], cpu) is not None
    assert reg.ensure(*ROLLUP_8, "cpu") is False  # captured: never twice
    assert graphcost.ledger().counters()["startup_captures"] == 2


def test_ensure_is_a_no_op_before_startup(fresh):
    reg = fresh(aot.AotProgramRegistry(specs=[]))
    assert reg.ensure(*ROLLUP_8, "cpu") is False
    reg.ensure_rollup_shapes(8, 8, "cpu")
    assert reg.join(1.0) and reg.programs_compiled == 0 and reg.state == "idle"


def test_a_broken_spec_is_recorded_and_turns_healthz_ok_false(fresh):
    reg = fresh(aot.AotProgramRegistry(specs=[
        ("analytics.fleet_rollup", "not-a-shape-key"), ("no.such.program", ()), ROLLUP_8,
    ]))
    reg.compile_startup("cpu", block=True)
    assert reg.ready() and reg.compile_errors == 2 and reg.programs_compiled == 1
    assert "no builder" in reg.last_error
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu")
    try:
        health = app._health()
        assert health["ok"] is False and health["runtime"]["aot"]["compile_errors"] == 2
        metricsz = app.handle("/metricsz")[2]
        assert "headlamp_tpu_torch_aot_compile_errors_total 2" in metricsz
        family = "headlamp_tpu_torch_graph_startup_captures_total"
        assert f'{family}{{program="analytics.fleet_rollup"}}' in metricsz
    finally:
        app.close()


def test_the_device_cache_warm_backfills_the_observed_rollup_buckets(fresh):
    from headlamp_tpu_torch.fleet import fleet_transport, fleet_viewport

    reg = fresh(aot.AotProgramRegistry(specs=[]))
    reg.compile_startup("cpu", block=True)
    app = DashboardApp(fleet_transport(fleet_viewport(1024)), device="cpu")
    try:
        app._background_tick()
        assert reg.join(60.0)
        key = ((1024,), (1024,))
        cpu = torch.device("cpu")
        assert reg.executable(aot.FLEET_ROLLUP, key, cpu) is not None
        assert reg.executable(aot.REGION_ROLLUP, key, cpu) is not None
        # The next paint replays both rollups: no request pays a capture.
        assert app.handle("/tpu")[0] == app.handle("/tpu/fleet")[0] == 200
        rows = graphcost.ledger().snapshot()["programs"]
        assert rows[aot.REGION_ROLLUP]["replays"] == 1 and rows[aot.REGION_ROLLUP]["eager"] == 0
        assert rows[aot.FLEET_ROLLUP]["eager"] == 0 and graphcost.ledger().request_captures() == 0
    finally:
        app.close()


def test_a_replay_that_raises_is_counted_and_answers_500(fresh, monkeypatch):
    reg = fresh(aot.AotProgramRegistry(specs=[(aot.COLD_PROGRAM, (64, 61, CFG, 60))]))
    reg.compile_startup("cpu", block=True)
    program = reg.executable(aot.COLD_PROGRAM, (64, 61, CFG, 60), torch.device("cpu"))

    def broken(inputs, finish):
        raise RuntimeError("replay failed")

    monkeypatch.setattr(program, "run", broken)
    app = DashboardApp(make_demo_transport("large"), device="cpu")
    try:
        status, _, body = app.handle("/tpu/metrics")
        assert status == 500 and "RuntimeError: replay failed" in body
        assert reg.exec_failures == 1 and "replay failed" in reg.last_error
    finally:
        app.close()


def test_default_specs_equal_jax_without_the_mesh_entries():
    # The mesh entries differ in their mesh size alone: JAX's is its
    # device count, the port's the process's fleet mesh's (1 unless a
    # group was launched).
    jax_all = jax_aot.default_specs()
    jax_specs = [(n, k) for n, k in jax_all if not n.startswith("mesh.")]
    port_mesh = [(n, k) for n, k in aot.default_specs() if n.startswith("mesh.")]
    assert port_mesh == [(n, (k[0], (1,), *k[2:])) for n, k in jax_all if n.startswith("mesh.")]
    assert port_mesh == [("mesh.rollup", ("psum", (1,), (256,), (256,)))]

    def port_form(name, key):
        if name.startswith("forecast."):  # the port keys no inference path
            bucket, length, cfg, steps, inference, batch_p = key
            assert (inference, batch_p) == ("xla", 0)
            return name, (bucket, length, dataclasses.asdict(cfg), steps)
        if name.startswith("fused."):
            node, pod, bucket, length, cfg, steps, _inference, _batch_p = key
            return name, (node, pod, bucket, length, dataclasses.asdict(cfg), steps)
        return name, key

    def cfg_form(name, key):
        if name.startswith("forecast."):
            bucket, length, cfg, steps = key
            return name, (bucket, length, dataclasses.asdict(cfg), steps)
        if name.startswith("fused."):
            node, pod, bucket, length, cfg, steps = key
            return name, (node, pod, bucket, length, dataclasses.asdict(cfg), steps)
        return name, key

    assert [cfg_form(*s) for s in aot.default_specs()[:-1]] == [port_form(*s) for s in jax_specs]
    assert len(aot.default_specs()) == len(jax_all) == 15
    for name in ("CHIP_BUCKETS", "ROLLUP_BUCKETS", "FUSED_BUCKETS", "VIEWPORT_FLEET_SIZES",
                 "LIVE_WINDOW_SAMPLES", "SLO_SERIES_STEADY"):
        assert getattr(aot, name) == getattr(jax_aot, name), name
    assert [aot.chip_bucket_for(n) for n in (1, 8, 9, 64, 256, 257)] == [
        jax_aot.chip_bucket_for(n) for n in (1, 8, 9, 64, 256, 257)] == [8, 8, 64, 64, 256, None]


def test_viewport_bucket_gaps_are_empty():
    assert aot.viewport_bucket_gaps() == [] == jax_aot.viewport_bucket_gaps()
    assert aot.viewport_bucket_gaps(specs=[]) == jax_aot.viewport_bucket_gaps(specs=[])


def test_pow2_bucket_equals_the_encoders():
    for n in (0, 1, 7, 8, 9, 248, 991, 1024, 1025, 3945, 15674, 16384, 16385):
        assert aot._pow2_bucket(n) == port_encode._bucket(n) == jax_encode._bucket(n), n
        assert aot._pow2_bucket(n) == jax_aot._pow2_bucket(n), n

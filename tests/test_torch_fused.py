"""The port's fused rollup+forecast (``models/service.py::
_fused_rollup_forecast``) against JAX's (``headlamp_tpu/models/
service.py:274-423``) on the CPU: the same 256-node fleet, the same
64-chip history and the same warm carry, each side's registry holding
its fused program at the (256, 256) bucket (one JAX compile for the
module). JAX's process-wide fleet cache and parked results are cleared
before each JAX call, as the dashboard tests do.

Held: the parked rollup dict equals JAX's exactly; the predictions meet
the warm-fit bound (1e-2 max-abs, MSE 1e-2 relative; ``pytest -s``
prints the measured values); a parked rollup serves ``fleet_stats``
with no device work and no copy; the declines and the demotion's
lineage match JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headlamp_tpu.domain import accelerator as jacc
from headlamp_tpu.fleet import fixtures as jfx
from headlamp_tpu.metrics.client import UtilizationHistory as JaxHistory
from headlamp_tpu.models import aot as jax_aot
from headlamp_tpu.models import forecast as jf
from headlamp_tpu.models import service as jsvc
from headlamp_tpu.runtime import device_cache as jcache
from headlamp_tpu_torch.analytics import stats as tstats
from headlamp_tpu_torch.domain import accelerator as tacc
from headlamp_tpu_torch.metrics.client import UtilizationHistory
from headlamp_tpu_torch.models import aot
from headlamp_tpu_torch.models import forecast as tf
from headlamp_tpu_torch.models import service as tsvc
from headlamp_tpu_torch.models.convert import opt_state_from_optax, params_from_jax
from headlamp_tpu_torch.obs import graphcost
from headlamp_tpu_torch.runtime import transfer
from headlamp_tpu_torch.runtime.device_cache import DeviceFleetCache, RollupResultCache

torch.set_num_threads(1)

VERSION = 73
PRED_TOL = 1e-2
MSE_REL_TOL = 1e-2
KEY = ((256,), (256,), 64, 61, tf.ForecastConfig(), tf.WARM_STEPS)


@pytest.fixture(scope="module")
def env():
    """Both registries ready with the fused program; the fleet, the
    history and JAX's cold carry."""
    fleet = jfx.fleet_large(256)
    jview = jacc.classify_fleet(fleet["nodes"], fleet["pods"], (jacc.TPU_PROVIDER,))["tpu"]
    tview = tacc.classify_fleet(fleet["nodes"], fleet["pods"])["tpu"]
    jview.version = tview.version = VERSION
    series = np.array(jf.synthetic_telemetry(64, 61, jax.random.PRNGKey(9)), np.float32)
    keys = [(f"n{i}", f"a{i}") for i in range(64)]
    jhist = JaxHistory(keys=keys, series=series.tolist(), step_s=60, end=1000.0,
                       resolved_query="t")
    thist = UtilizationHistory(keys=keys, series=series.tolist(), step_s=60, end=1000.0,
                               resolved_query="t")
    jreg = jax_aot.AotProgramRegistry(specs=[(
        "fused.rollup_and_forecast", ((256,), (256,), 64, 61, jf.ForecastConfig(),
                                      jf.WARM_STEPS, "xla", 0))])
    jreg.compile_startup(block=True)
    assert jreg.compile_errors == 0, jreg.snapshot()
    treg = aot.AotProgramRegistry(specs=[(aot.FUSED_PROGRAM, KEY)])
    treg.compile_startup("cpu", block=True)
    jprev, tprev = jax_aot.set_registry(jreg), aot.set_registry(treg)
    try:
        _, jstate = jsvc.forecast_from_history_incremental(jhist, jf.ForecastConfig())
        yield dict(jview=jview, tview=tview, jhist=jhist, thist=thist, jstate=jstate,
                   treg=treg)
    finally:
        jax_aot.set_registry(jprev)
        aot.set_registry(tprev)


def _carries(env, **changes):
    """(JAX carry, port carry): copies of JAX's cold state, since JAX's
    fused program donates the carry it is handed."""
    js = env["jstate"]._replace(**changes)
    jcopy = js._replace(
        params=jax.tree_util.tree_map(jnp.copy, js.params),
        opt_state=jax.tree_util.tree_map(jnp.copy, js.opt_state),
    )
    tstate = tf.WarmState(
        params_from_jax(js.params, "cpu"), opt_state_from_optax(js.opt_state, "cpu"),
        js.cold_mse, js.generation, tf.ForecastConfig(), js.n_chips,
    )
    return jcopy, tstate


def _jax_fused(env, jstate, view=None, data_source="history"):
    jcache.fleet_cache.invalidate()
    jcache.rollup_results.invalidate()
    return jsvc._fused_rollup_forecast(
        env["jhist"], jf.ForecastConfig(), jstate,
        env["jview"] if view is None else view, data_source,
    )


def _port_fused(env, tstate, view=None, data_source="history", history=None):
    caches = DeviceFleetCache("cpu"), RollupResultCache()
    out = tsvc._fused_rollup_forecast(
        env["thist"] if history is None else history, tf.ForecastConfig(), tstate,
        env["tview"] if view is None else view, data_source,
        device=torch.device("cpu"), fleet_cache=caches[0], rollup_results=caches[1],
    )
    return out, caches


def test_fused_rollup_equals_jax_and_predictions_meet_the_warm_bound(env):
    jstate, tstate = _carries(env)
    jres = _jax_fused(env, jstate)
    jparked = jcache.rollup_results.get("tpu", VERSION)
    led = graphcost.ledger()
    before = led.snapshot()
    (tview, new_state), (fleet_cache, results) = _port_fused(env, tstate)
    jview, jnew = jres
    assert results.get("tpu", VERSION) == jparked
    assert (tview.inference_path, jview.inference_path) == ("torch-warm", "xla-warm")
    assert tview.data_source == jview.data_source == "history"
    assert tview.carried_from_generation == jview.carried_from_generation == 0
    assert new_state.generation == jnew.generation and new_state.n_chips == 64
    jpeak = {(c.node, c.accelerator_id): c.predicted_peak for c in jview.chips}
    pred = max(abs(c.predicted_peak - jpeak[(c.node, c.accelerator_id)]) for c in tview.chips)
    mse = abs(tview.fit_mse - jview.fit_mse) / jview.fit_mse
    print(f"fused vs JAX: predicted peaks max-abs {pred:.3g}, mse rel {mse:.3g}")
    assert pred <= PRED_TOL and mse <= MSE_REL_TOL
    after = led.snapshot()
    assert after["programs"][aot.FUSED_PROGRAM]["replays"] == (
        before["programs"][aot.FUSED_PROGRAM]["replays"] + 1)
    assert after["request_captures"] == before["request_captures"]
    assert fleet_cache.counters()["uploads"] == 1 and env["treg"].donation_saved_bytes > 0


def test_a_parked_rollup_serves_fleet_stats_with_no_transfer(env, monkeypatch):
    _, tstate = _carries(env)
    (_, _), (fleet_cache, results) = _port_fused(env, tstate)
    fetches = []
    monkeypatch.setattr(transfer, "fetch", lambda t: fetches.append(t) or t.cpu())
    rollups = graphcost.ledger().snapshot()["programs"].get("analytics.fleet_rollup")
    got = tstats.fleet_stats(env["tview"], device="cpu", fleet_cache=fleet_cache,
                             rollup_results=results, backend="torch")
    assert fetches == [] and fleet_cache.counters()["hits"] == 0
    assert graphcost.ledger().snapshot()["programs"].get("analytics.fleet_rollup") == rollups
    assert got == tstats.python_fleet_stats(env["tview"])
    assert results.counters() == {"hits": 1, "lookups": 1}


def test_the_fused_path_declines_as_jax_does(env):
    small = tacc.classify_fleet(*(jfx.fleet_large(32)[k] for k in ("nodes", "pods")))["tpu"]
    small.version = VERSION
    jsmall = jacc.classify_fleet(*(jfx.fleet_large(32)[k] for k in ("nodes", "pods")),
                                 (jacc.TPU_PROVIDER,))["tpu"]
    jsmall.version = VERSION
    unversioned = dataclasses.replace(env["tview"], version=None)
    junversioned = dataclasses.replace(env["jview"], version=None)
    jstate, tstate = _carries(env)
    for jview, tview in ((junversioned, unversioned), (jsmall, small)):
        assert _jax_fused(env, jstate, view=jview) is None
        assert _port_fused(env, tstate, view=tview)[0] is None
    assert _jax_fused(env, None) is None and _port_fused(env, None)[0] is None
    other = tf.ForecastConfig(learning_rate=2e-3)
    assert _port_fused(env, tstate._replace(cfg=other))[0] is None
    assert _port_fused(env, tstate._replace(n_chips=63))[0] is None
    short = dataclasses.replace(env["thist"], series=[row[:39] for row in env["thist"].series])
    assert _port_fused(env, tstate, history=short)[0] is None


def test_no_bucket_or_no_registry_declines_and_a_novel_shape_is_backfilled(env, monkeypatch):
    _, tstate = _carries(env)
    large = tacc.classify_fleet(*(jfx.fleet_large(1024)[k] for k in ("nodes", "pods")))["tpu"]
    large.version = VERSION
    treg = env["treg"]
    misses = treg.bucket_misses
    assert _port_fused(env, tstate, view=large)[0] is None  # (1024, 1024) not captured
    assert treg.bucket_misses == misses + 1 and treg.join(60.0)
    assert treg.executable(aot.FUSED_PROGRAM, ((1024,), (1024,), *KEY[2:]),
                           torch.device("cpu")) is not None
    monkeypatch.setattr(aot, "_REGISTRY", aot.AotProgramRegistry(specs=[]))
    assert _port_fused(env, tstate)[0] is None  # never started


def test_demotion_stitches_the_lineage_as_jax_does(env):
    jstate, tstate = _carries(env, cold_mse=1e-12, generation=4)
    jview, jnew = _jax_fused(env, jstate)
    (tview, tnew), (_, results) = _port_fused(env, tstate)
    assert tview.warm_demotion_reason.startswith("warm mse")
    assert jview.warm_demotion_reason.startswith("warm mse")
    assert tview.carried_from_generation == jview.carried_from_generation == 4
    assert tnew.generation == jnew.generation == 5
    assert tview.inference_path == "torch" and jview.inference_path == "xla"
    assert tview.data_source == jview.data_source == "history"
    assert results.get("tpu", VERSION) is not None  # the rollup half stands

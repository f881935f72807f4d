"""The port's sequence-parallel windows and dp×tp train step against
the JAX package's, on the CPU, and the port's multichip drill.

``sharded_make_windows`` (gathered over the ranks) equals JAX's on a
``seq`` mesh exactly, at sizes 4 and 1, and raises where JAX's raises.
One dp×tp step at ``data 2 × model 2`` (gloo ranks on threads) is held
to JAX's ``make_train_step`` on ``train_mesh(4)`` with the same numpy
params and batch: the loss to 1e-5 relative and the gathered params to
1e-4 absolute (summation order differs across the model shards; ``-s``
prints the measured diffs). The sharded step is held to the port's own
unsharded step, and that one to JAX's single-device step, the same way.
``dryrun_multichip`` runs its six sections on 4 and 3 ranks.
"""

import jax
import numpy as np
import pytest
import torch

from headlamp_tpu.models import forecast as jf
from headlamp_tpu.parallel import mesh as jmesh
from headlamp_tpu_torch.models import forecast as tf
from headlamp_tpu_torch.parallel import dryrun
from headlamp_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

CFG = tf.ForecastConfig()
JCFG = jf.ForecastConfig()
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4


def _numpy_params(seed=5):
    rng = np.random.default_rng(seed)

    def glorot(shape):
        return (rng.normal(size=shape) * np.sqrt(2.0 / sum(shape))).astype(np.float32)

    return {
        "w1": glorot((CFG.window, CFG.hidden)), "b1": (0.05 * rng.normal(size=CFG.hidden)).astype(np.float32),
        "w2": glorot((CFG.hidden, CFG.hidden)), "b2": (0.05 * rng.normal(size=CFG.hidden)).astype(np.float32),
        "w3": glorot((CFG.hidden, CFG.horizon)), "b3": (0.05 * rng.normal(size=CFG.horizon)).astype(np.float32),
    }


def _numpy_batch(seed=6):
    series = np.random.default_rng(seed).uniform(0.2, 0.8, size=(4, 96)).astype(np.float32)
    x, y = tf.make_windows(torch.from_numpy(series), CFG.window, CFG.horizon)
    return x.numpy(), y.numpy()  # 228 rows: even, so the data axis splits them


def _jax_step(params, x, y, mesh=None):
    jparams = {k: jax.numpy.asarray(v) for k, v in params.items()}
    jx, jy = jax.numpy.asarray(x), jax.numpy.asarray(y)
    if mesh is not None:
        shardings = jf.param_shardings(mesh)
        jparams = {k: jax.device_put(v, shardings[k]) for k, v in jparams.items()}
        jx = jax.device_put(jx, jf.batch_sharding(mesh))
        jy = jax.device_put(jy, jf.batch_sharding(mesh))
    step, optimizer = jf.make_train_step(JCFG)
    new, _, loss = step(jparams, optimizer.init(jparams), jx, jy)
    return {k: np.asarray(v) for k, v in new.items()}, float(loss)


def _port_sharded_step(params, x, y, size):
    meshes = tmesh.local_train_meshes(size, "cpu", timeout=tmesh.DEFAULT_TIMEOUT / 4)

    def rank(mesh):
        shards = tf.shard_params({k: torch.from_numpy(v) for k, v in params.items()}, mesh)
        step = tf.make_sharded_train_step(CFG, mesh)
        new, state, loss = step(shards, tf.adam_init(shards),
                                tf.batch_block(torch.from_numpy(x), mesh),
                                tf.batch_block(torch.from_numpy(y), mesh))
        assert int(state.count) == 1
        full = tf.gather_params(new, mesh)
        return {k: v.numpy() for k, v in full.items()}, float(loss)

    try:
        return tmesh.run_spmd(meshes, rank, timeout_s=60.0)
    finally:
        tmesh.close_meshes(meshes)


def _diffs(got, want):
    params = max(float(np.abs(got[0][k] - want[0][k]).max()) for k in tf.PARAM_NAMES)
    loss = abs(got[1] - want[1]) / abs(want[1])
    return loss, params


@pytest.mark.parametrize("size", [4, 1])
def test_sharded_windows_equal_jax(size):
    series = np.random.default_rng(size).uniform(size=(3, 48 * size)).astype(np.float32)
    jx, jy, jvalid = jmesh.sharded_make_windows(series, CFG.window, CFG.horizon,
                                                jmesh.seq_mesh(size))
    meshes = tmesh.local_meshes(size, "seq", "cpu", timeout=tmesh.DEFAULT_TIMEOUT / 4)
    try:
        ranks = tmesh.run_spmd(meshes, lambda m: [t.numpy() for t in tmesh.gather_windows(
            tmesh.sharded_make_windows(series, CFG.window, CFG.horizon, m), m)])
        local = tmesh.run_spmd(meshes, lambda m: tmesh.sharded_make_windows(
            series, CFG.window, CFG.horizon, m)[0].shape)
    finally:
        tmesh.close_meshes(meshes)
    for x, y, valid in ranks:
        np.testing.assert_array_equal(x, np.asarray(jx))
        np.testing.assert_array_equal(y, np.asarray(jy))
        np.testing.assert_array_equal(valid, np.asarray(jvalid))
    assert local == [(3, 48, CFG.window)] * size
    n_pos = 48 * size - CFG.window - CFG.horizon + 1
    x_ref, _ = tf.make_windows(torch.from_numpy(series), CFG.window, CFG.horizon)
    np.testing.assert_array_equal(ranks[0][0][:, :n_pos], x_ref.numpy().reshape(3, n_pos, -1))


def test_sharded_windows_raise_as_jax():
    (mesh,) = tmesh.local_meshes(1, "seq", "cpu")
    meshes = tmesh.local_meshes(2, "seq", "cpu", timeout=tmesh.DEFAULT_TIMEOUT / 4)
    try:
        for series, size, match in ((np.zeros((1, 97), np.float32), 2, "divisible by seq=2"),
                                    (np.zeros((1, 60), np.float32), 2, "halo 39 exceeds")):
            with pytest.raises(ValueError, match=match):
                jmesh.sharded_make_windows(series, 32, 8, jmesh.seq_mesh(size))
            with pytest.raises(ValueError, match=match):
                tmesh.run_spmd(meshes, lambda m, s=series: tmesh.sharded_make_windows(s, 32, 8, m))
        with pytest.raises(ValueError, match="halo 39 exceeds"):
            tmesh.sharded_make_windows(np.zeros((1, 38), np.float32), 32, 8, mesh)
    finally:
        tmesh.close_meshes([mesh, *meshes])


def test_dp_tp_step_matches_jax_on_train_mesh_4():
    params, (x, y) = _numpy_params(), _numpy_batch()
    want = _jax_step(params, x, y, jmesh.train_mesh(4))
    assert dict(jmesh.train_mesh(4).shape) == {"data": 2, "model": 2}
    ranks = _port_sharded_step(params, x, y, 4)
    for got in ranks:
        loss_diff, param_diff = _diffs(got, want)
        print(f"dp×tp step vs JAX train_mesh(4): loss rel diff {loss_diff:.3e} "
              f"(tol {LOSS_RTOL:g}), params max abs diff {param_diff:.3e} (tol {PARAM_ATOL:g})")
        assert loss_diff <= LOSS_RTOL and param_diff <= PARAM_ATOL
    for got in ranks[1:]:  # every rank holds the same replicated result
        assert got[1] == ranks[0][1]
        for k in tf.PARAM_NAMES:
            np.testing.assert_array_equal(got[0][k], ranks[0][0][k])


def test_sharded_step_matches_the_unsharded_step():
    params, (x, y) = _numpy_params(7), _numpy_batch(8)
    step = tf.make_train_step(CFG)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    new, state, loss = step(tparams, tf.adam_init(tparams), torch.from_numpy(x), torch.from_numpy(y))
    assert int(state.count) == 1 and all(torch.equal(tparams[k], torch.from_numpy(params[k]))
                                         for k in tf.PARAM_NAMES)  # inputs untouched
    want = ({k: v.numpy() for k, v in new.items()}, float(loss))
    for size in (4, 2):
        loss_diff, param_diff = _diffs(_port_sharded_step(params, x, y, size)[0], want)
        print(f"sharded step ({size} ranks) vs unsharded: loss rel diff {loss_diff:.3e}, "
              f"params max abs diff {param_diff:.3e}")
        assert loss_diff <= LOSS_RTOL and param_diff <= PARAM_ATOL


def test_unsharded_step_matches_jax():
    params, (x, y) = _numpy_params(9), _numpy_batch(10)
    want = _jax_step(params, x, y)
    step = tf.make_train_step(CFG)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    new, _, loss = step(tparams, tf.adam_init(tparams), torch.from_numpy(x), torch.from_numpy(y))
    loss_diff, param_diff = _diffs(({k: v.numpy() for k, v in new.items()}, float(loss)), want)
    print(f"unsharded step vs JAX: loss rel diff {loss_diff:.3e}, params {param_diff:.3e}")
    assert loss_diff <= LOSS_RTOL and param_diff <= PARAM_ATOL


@pytest.mark.parametrize("n", [4, 3])
def test_dryrun_multichip_passes(n, capsys):
    line = dryrun.dryrun_multichip(n, device="cpu")
    assert capsys.readouterr().out.strip() == line
    data, model = tmesh.train_shape(n)
    assert line.startswith(f"dryrun_multichip ok: {n} devices; train mesh "
                           f"{{'data': {data}, 'model': {model}}} loss=")
    assert f"fleet rollup over {{'hosts': {n}}} capacity=16 (psum+ring agree)" in line
    assert f"seq-parallel windows over {{'seq': {n}}} ({96 * n // 2 - 39} positions" in line
    assert "(4 nodes over 6 buckets)" in line and "(capacity=12, psum+ring agree)" in line


def test_default_group_meshes_as_a_launch_builds_them(monkeypatch):
    """A launched default group (world size 1 here, gloo) gives the
    process's fleet and train meshes: the same rollup and step as the
    in-process meshes."""
    import torch.distributed as dist

    from headlamp_tpu_torch.analytics.encode import encode_fleet
    from headlamp_tpu_torch.domain.accelerator import classify_fleet
    from headlamp_tpu_torch.fleet import fleet_v5p32

    monkeypatch.setattr(tmesh, "_PROCESS_MESHES", {})
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        assert tmesh.process_mesh_size() == 1
        hosts, train = tmesh.fleet_mesh("cpu"), tmesh.train_mesh("cpu")
        assert hosts.group is dist.group.WORLD and tmesh.is_process_mesh(hosts)
        assert tmesh.seq_mesh("cpu").group is hosts.group and train.shape == {"data": 1, "model": 1}
        fleet = fleet_v5p32()
        view = classify_fleet(fleet["nodes"], fleet["pods"])["tpu"]
        arrays = encode_fleet(view.nodes, view.pods)
        (local,) = tmesh.local_meshes(1, "hosts", "cpu")
        try:
            assert tmesh.sharded_rollup(arrays, hosts) == tmesh.sharded_rollup(arrays, local)
        finally:
            local.close()
        params, (x, y) = _numpy_params(11), _numpy_batch(12)
        got = _port_sharded_step(params, x, y, 1)[0]
        shards = tf.shard_params({k: torch.from_numpy(v) for k, v in params.items()}, train)
        new, _, loss = tf.make_sharded_train_step(CFG, train)(
            shards, tf.adam_init(shards), torch.from_numpy(x), torch.from_numpy(y))
        assert float(loss) == got[1]
        for k in tf.PARAM_NAMES:
            np.testing.assert_array_equal(new[k].numpy(), got[0][k])
    finally:
        dist.destroy_process_group()


@pytest.mark.slow
def test_a_launch_of_four_gloo_processes_passes_the_drill():
    """``torchrun`` with one process per rank over the default group."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "headlamp_tpu_torch.parallel.dryrun", "--device", "cpu"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=str(repo)), capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.count("dryrun_multichip ok: 4 devices; train mesh {'data': 2, 'model': 2}") == 1

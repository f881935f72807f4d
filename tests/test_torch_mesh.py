"""The port's mesh (``headlamp_tpu_torch/parallel/mesh.py``) against the
JAX package's ``headlamp_tpu/parallel/mesh.py`` on the CPU.

The port's ranks are gloo groups on threads of this process; JAX runs
the same mesh size on the virtual CPU devices ``tests/conftest.py`` sets.
Every rank's psum and ring rollups, region rollup and all-to-all
histogram equal JAX's exactly and the Python oracles, at mesh sizes 4 and
3 (3 takes the uneven padding), on ``fleet_v5p32``, its degraded twin and
``fleet_large(1024)``, and the region rollup on
``fleet_viewport(4096, clusters=70)``, whose clusters past 63 alias into
the last segment. Size 1 runs the ring with no hop and the halo as a
local copy. A gloo group declared on CUDA, or given a tensor on another
device, raises. The mesh rollup on the process mesh replays the
registry's program.
"""

import numpy as np
import pytest
import torch

from headlamp_tpu.analytics import encode as jax_encode
from headlamp_tpu.domain import accelerator as jacc
from headlamp_tpu.fleet import fixtures as jfx
from headlamp_tpu.parallel import mesh as jmesh
from headlamp_tpu_torch.analytics import encode as tencode
from headlamp_tpu_torch.analytics import fleet_torch
from headlamp_tpu_torch.analytics import stats as tstats
from headlamp_tpu_torch.domain import accelerator as tacc
from headlamp_tpu_torch.fleet import fixtures as tfx
from headlamp_tpu_torch.models import aot
from headlamp_tpu_torch.obs import graphcost
from headlamp_tpu_torch.parallel import mesh as tmesh
from headlamp_tpu_torch.viewport import tree as ttree

torch.set_num_threads(1)

FLEETS = {
    "v5p32": lambda m: m.fleet_v5p32(),
    "v5p32_degraded": lambda m: m.fleet_v5p32_degraded(),
    "large256": lambda m: m.fleet_large(256),
    "large1024": lambda m: m.fleet_large(1024),
    "viewport4096x70": lambda m: m.fleet_viewport(4096, clusters=70),
}
ORACLE_KEYS = ("capacity", "allocatable", "in_use", "free", "nodes_total", "nodes_ready",
               "phase_counts", "per_node_in_use")


def _views(fleet):
    make = FLEETS[fleet]
    jfleet, tfleet = make(jfx), make(tfx)
    jview = jacc.classify_fleet(jfleet["nodes"], jfleet["pods"])["tpu"]
    tview = tacc.classify_fleet(tfleet["nodes"], tfleet["pods"])["tpu"]
    return jview, tview


def _encoded(fleet):
    jview, tview = _views(fleet)
    return (jax_encode.encode_fleet(jview.nodes, jview.pods),
            tencode.encode_fleet(tview.nodes, tview.pods), tview)


def _spmd(size, fn, axis="hosts"):
    meshes = tmesh.local_meshes(size, axis, "cpu", timeout=tmesh.DEFAULT_TIMEOUT / 4)
    try:
        return tmesh.run_spmd(meshes, fn, timeout_s=60.0)
    finally:
        tmesh.close_meshes(meshes)


def _jsonable(rollup):
    return {k: (np.asarray(v).tolist() if hasattr(v, "shape") else v) for k, v in rollup.items()}


@pytest.mark.parametrize("fleet", ["v5p32", "v5p32_degraded", "large1024"])
@pytest.mark.parametrize("size", [4, 3])
def test_sharded_and_ring_rollups_equal_jax_and_the_oracle(size, fleet):
    jcols, tcols, tview = _encoded(fleet)
    want = jmesh.sharded_rollup(jcols, jmesh.fleet_mesh(size))
    assert jmesh.ring_rollup(jcols, jmesh.fleet_mesh(size)) == want
    ranks = _spmd(size, lambda m: (tmesh.sharded_rollup(tcols, m), tmesh.ring_rollup(tcols, m),
                                   tmesh.shard_fleet_arrays(tcols, m)))
    for psum, ring, _ in ranks:
        assert psum == ring == want
    for name in tmesh.NODE_COLUMNS + tmesh.POD_COLUMNS:  # the row blocks tile the padded column
        column = getattr(tcols, name)
        whole = torch.cat([blocks[name] for _, _, blocks in ranks]).numpy()
        assert whole.size % size == 0 and whole.size - column.size < size
        np.testing.assert_array_equal(whole[: column.size], column)
        assert not whole[column.size :].any()
    oracle = tstats.python_fleet_stats(tview)
    assert {k: ranks[0][0][k] for k in ORACLE_KEYS} == {k: oracle[k] for k in ORACLE_KEYS}


@pytest.mark.parametrize("size", [4, 3])
def test_region_sharded_rollup_equals_jax(size):
    for fleet in ("viewport4096x70", "large1024"):
        jcols, tcols, tview = _encoded(fleet)
        region_of, _, _, cluster_id, slice_id = ttree._assignments(tview.nodes)
        node_cluster = np.zeros(tcols.n_nodes_padded, np.int32)
        node_slice = np.zeros(tcols.n_nodes_padded, np.int32)
        for i, name in enumerate(tcols.node_names):
            ck, sk = region_of[name]
            node_cluster[i] = cluster_id[ck]  # unclamped: the device's clamp aliases
            node_slice[i] = slice_id[(ck, sk)]
        want = jmesh.region_sharded_rollup(jcols, node_cluster, node_slice,
                                           jmesh.fleet_mesh(size))
        ranks = _spmd(size, lambda m: (
            tmesh.region_sharded_rollup(tcols, node_cluster, node_slice, m),
            tmesh.region_sharded_rollup(tcols, node_cluster, node_slice, m, reducer="ring")))
        single = fleet_torch.unpack_region_rollup(fleet_torch.pack_region_rollup(
            fleet_torch.region_rollup_arrays(tcols, node_cluster, node_slice, "cpu")))
        n_pad = tcols.n_nodes_padded
        for psum, ring in ranks:
            assert set(psum) == set(want) == set(fleet_torch.REGION_KEYS)
            for key in fleet_torch.REGION_KEYS:
                np.testing.assert_array_equal(psum[key], np.asarray(want[key]), err_msg=key)
                np.testing.assert_array_equal(ring[key], psum[key], err_msg=key)
                # The single-device rollup, on the encoder's node axis.
                width = fleet_torch.REGION_CLUSTER_SEGMENTS if key.startswith("cluster") else n_pad
                np.testing.assert_array_equal(psum[key][:width], single[key], err_msg=key)
        if fleet == "viewport4096x70":
            assert node_cluster.max() == 69
            limit = fleet_torch.REGION_CLUSTER_SEGMENTS
            assert ranks[0][0]["cluster_nodes"][limit - 1] > ranks[0][0]["cluster_nodes"][limit - 2]


def test_alltoall_histogram_equals_jax_and_bincount():
    for size in (4, 3):
        for fleet in ("v5p32", "v5p32_degraded", "large1024"):
            jcols, tcols, _ = _encoded(fleet)
            want = np.asarray(jmesh.alltoall_generation_histogram(jcols, jmesh.fleet_mesh(size)))
            oracle = np.bincount(tcols.node_generation[tcols.node_valid > 0],
                                 minlength=len(tencode.GENERATION_IDS))
            for got in _spmd(size, lambda m: tmesh.alltoall_generation_histogram(tcols, m)):
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(got, oracle)


class _NoPointToPoint:
    """A group whose send and recv fail: size 1 must make no hop."""

    def __init__(self, group):
        self._group = group

    def __getattr__(self, name):
        return getattr(self._group, name)

    def send(self, *args):
        raise AssertionError("a point-to-point send at size 1")

    recv = send


def test_size_one_ring_has_no_hop_and_the_halo_is_a_local_copy():
    (made,) = tmesh.local_meshes(1, "seq", "cpu")
    mesh = tmesh.HostMesh(_NoPointToPoint(made.group), "seq", 0, 1, made.device)
    try:
        x = torch.arange(6, dtype=torch.int64)
        assert torch.equal(tmesh.ring_allreduce(x, mesh), x)
        series = np.arange(2 * 48, dtype=np.float32).reshape(2, 48) / 96.0
        xs, ys, valid = tmesh.sharded_make_windows(series, 32, 8, mesh)
        jx, jy, jvalid = jmesh.sharded_make_windows(series, 32, 8, jmesh.seq_mesh(1))
        np.testing.assert_array_equal(xs.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ys.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        fleet = dict(zip(("j", "t", "view"), _encoded("large1024")))
        hosts = tmesh.HostMesh(mesh.group, "hosts", 0, 1, mesh.device)
        want = jmesh.sharded_rollup(fleet["j"], jmesh.fleet_mesh(1))
        assert tmesh.sharded_rollup(fleet["t"], hosts) == tmesh.ring_rollup(fleet["t"], hosts) == want
        assert _jsonable(want)["per_node_in_use"] == tstats.python_fleet_stats(
            fleet["view"])["per_node_in_use"]
    finally:
        made.close()


def test_a_gloo_group_on_cuda_raises_and_devices_must_match():
    (mesh,) = tmesh.local_meshes(1, "hosts", "cpu")
    try:
        # Declared on CUDA: refused by the backend check before any CUDA call.
        with pytest.raises(ValueError, match="needs a nccl group, not gloo"):
            tmesh.HostMesh(mesh.group, "hosts", 0, 1, torch.device("cuda", 0))
        # Columns on another device than the mesh's.
        _, tcols, _ = _encoded("v5p32")
        moved = tencode.FleetArrays(**{
            **tcols.__dict__,
            "node_capacity": torch.as_tensor(tcols.node_capacity, device="meta"),
        })
        with pytest.raises(ValueError, match="given to a mesh on cpu"):
            tmesh.sharded_rollup(moved, mesh)
        with pytest.raises(ValueError, match="given to a mesh on cpu"):
            tmesh.all_reduce_(torch.zeros(2, device="meta"), mesh)
        with pytest.raises(ValueError, match="unknown reducer"):
            tmesh.build_rollup_shard(mesh, "tree", 8)
    finally:
        mesh.close()


def test_the_process_mesh_rollup_replays_the_registry_program(monkeypatch):
    monkeypatch.setattr(graphcost, "_LEDGER", graphcost.GraphCostLedger())
    key = ("psum", (tmesh.process_mesh_size(),), (256,), (256,))
    assert (tmesh.MESH_ROLLUP, key) in aot.default_specs()
    reg = aot.AotProgramRegistry(specs=[(tmesh.MESH_ROLLUP, key)])
    monkeypatch.setattr(aot, "_REGISTRY", reg)
    reg.compile_startup("cpu", block=True)
    assert reg.ready() and reg.compile_errors == 0 and reg.programs_compiled == 1
    jcols, tcols, _ = _encoded("large256")
    assert (tcols.n_nodes_padded, tcols.n_pods_padded) == (256, 256)
    want = jmesh.sharded_rollup(jcols, jmesh.fleet_mesh(1))
    process = tmesh.fleet_mesh("cpu")
    assert tmesh.is_process_mesh(process) and tmesh.fleet_mesh("cpu") is process
    assert tmesh.sharded_rollup(tcols, process) == want
    assert reg.bucket_hits == 1
    row = graphcost.ledger().snapshot()["programs"][tmesh.MESH_ROLLUP]
    assert row["replays"] == 1 and row["eager"] == 0
    # Another mesh of the same size runs the body eagerly, counted; the
    # ring is not captured, so it is a counted bucket miss.
    (other,) = tmesh.local_meshes(1, "hosts", "cpu")
    try:
        assert tmesh.sharded_rollup(tcols, other) == want
    finally:
        other.close()
    assert tmesh.ring_rollup(tcols, process) == want
    row = graphcost.ledger().snapshot()["programs"][tmesh.MESH_ROLLUP]
    assert row["replays"] == 1 and row["eager"] == 2 and reg.bucket_misses == 1

"""The mesh on the card (``headlamp_tpu_torch/parallel/mesh.py``): world
size 1 over NCCL. The psum and ring rollups and the region rollup equal
the single-device rollups exactly; the registry's ``mesh.rollup``
program, captured as a CUDA graph with its NCCL all-reduce inside,
replays to exactly what its eager run gives; a gloo group on CUDA
tensors raises, on the mesh and on the columns. Needs a CUDA device and
skips without one. On the card:

    python -m pytest tests/test_torch_cuda_mesh.py -q
"""

import numpy as np
import pytest
import torch

from headlamp_tpu_torch.analytics import fleet_torch
from headlamp_tpu_torch.analytics.encode import encode_fleet
from headlamp_tpu_torch.domain.accelerator import classify_fleet
from headlamp_tpu_torch.fleet import fleet_large, fleet_viewport
from headlamp_tpu_torch.models import aot
from headlamp_tpu_torch.obs import graphcost
from headlamp_tpu_torch.parallel import mesh as tmesh
from headlamp_tpu_torch.viewport import tree as ttree


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mesh on the card is NCCL")
    monkeypatch.setattr(graphcost, "_LEDGER", graphcost.GraphCostLedger())
    monkeypatch.setattr(aot, "_REGISTRY", aot.AotProgramRegistry())
    return torch.device("cuda")


def _fleet(fixture):
    view = classify_fleet(fixture["nodes"], fixture["pods"])["tpu"]
    return view, encode_fleet(view.nodes, view.pods)


def test_world_one_nccl_rollups_equal_the_single_device_rollups(cuda):
    (mesh,) = tmesh.local_meshes(1, "hosts", cuda)
    try:
        assert tmesh._backend_of(mesh.group) == "nccl"
        for n in (256, 1024, 4096):
            _, arrays = _fleet(fleet_large(n))
            single = fleet_torch.rollup_to_dict(arrays, cuda)
            for rollup in (tmesh.sharded_rollup, tmesh.ring_rollup):
                got = rollup(arrays, mesh)
                assert got == {k: single[k] for k in got}, (rollup.__name__, n)
        view, arrays = _fleet(fleet_viewport(4096, clusters=70))
        region_of, _, _, cluster_id, slice_id = ttree._assignments(view.nodes)
        node_cluster, node_slice = ttree._region_ids(arrays, cluster_id, slice_id, region_of,
                                                     fleet_torch.REGION_CLUSTER_SEGMENTS)
        single = fleet_torch.region_rollup_host(arrays, node_cluster, node_slice, cuda)
        for reducer in ("psum", "ring"):
            got = tmesh.region_sharded_rollup(arrays, node_cluster, node_slice, mesh, reducer)
            for key in fleet_torch.REGION_KEYS:
                np.testing.assert_array_equal(got[key], single[key], err_msg=key)
    finally:
        mesh.close()


def test_mesh_rollup_replay_equals_its_eager_run(cuda, monkeypatch):
    reg = aot.AotProgramRegistry(specs=[(tmesh.MESH_ROLLUP, ("psum", (1,), (1024,), (1024,)))])
    monkeypatch.setattr(aot, "_REGISTRY", reg)
    try:
        reg.compile_startup(cuda, block=True)
        assert reg.ready() and reg.compile_errors == 0, reg.snapshot()
        process = tmesh.fleet_mesh(cuda)
        _, arrays = _fleet(fleet_large(1024))
        replayed = tmesh.sharded_rollup(arrays, process)
        row = graphcost.ledger().snapshot()["programs"][tmesh.MESH_ROLLUP]
        assert row["replays"] == 1 and row["eager"] == 0 and reg.bucket_hits == 1
        (other,) = tmesh.local_meshes(1, "hosts", cuda)  # not the registry's mesh: eager
        try:
            eager = tmesh.sharded_rollup(arrays, other)
        finally:
            other.close()
        assert graphcost.ledger().snapshot()["programs"][tmesh.MESH_ROLLUP]["eager"] == 1
        assert replayed == eager == tmesh.ring_rollup(arrays, process)
    finally:
        tmesh.close_process_meshes()


def test_a_gloo_group_on_cuda_tensors_raises(cuda):
    (gloo,) = tmesh.local_meshes(1, "hosts", "cpu")
    try:
        with pytest.raises(ValueError, match="needs a nccl group, not gloo"):
            tmesh.HostMesh(gloo.group, "hosts", 0, 1, torch.device("cuda", 0))
        with pytest.raises(ValueError, match="given to a mesh on cpu"):
            tmesh.all_reduce_(torch.ones(4, device=cuda), gloo)
        _, arrays = _fleet(fleet_large(256))
        on_card = type(arrays)(**{**arrays.__dict__, "node_capacity":
                                  torch.as_tensor(arrays.node_capacity, device=cuda)})
        with pytest.raises(ValueError, match="given to a mesh on cpu"):
            tmesh.sharded_rollup(on_card, gloo)
    finally:
        gloo.close()

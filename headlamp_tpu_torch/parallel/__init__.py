"""Parallelism: the mesh over ``torch.distributed``.

The port of ``headlamp_tpu/parallel``: the fleet and region rollups
partitioned over a ``hosts`` axis with one packed all-reduce (or an
explicit ring of point-to-point hops), the generation histogram by an
all-to-all regroup, sequence-parallel windows with a halo exchange over
a ``seq`` axis, and the ``(data, model)`` train mesh of the dp×tp train
step (``models/forecast.py``). SPMD: every rank calls the same function.
NCCL on the card, gloo ranks on threads for the CPU tests;
:mod:`.dryrun` drives all of it as the JAX package's multichip drill.
"""

from .mesh import (
    HostMesh,
    TrainMesh,
    all_gather,
    all_reduce_,
    all_to_all,
    alltoall_generation_histogram,
    close_meshes,
    close_process_meshes,
    fleet_mesh,
    gather_windows,
    local_meshes,
    local_train_meshes,
    region_sharded_rollup,
    ring_allreduce,
    ring_rollup,
    run_spmd,
    seq_mesh,
    shard_fleet_arrays,
    sharded_make_windows,
    sharded_rollup,
    train_mesh,
)

__all__ = [
    "HostMesh",
    "TrainMesh",
    "all_gather",
    "all_reduce_",
    "all_to_all",
    "alltoall_generation_histogram",
    "close_meshes",
    "close_process_meshes",
    "fleet_mesh",
    "gather_windows",
    "local_meshes",
    "local_train_meshes",
    "region_sharded_rollup",
    "ring_allreduce",
    "ring_rollup",
    "run_spmd",
    "seq_mesh",
    "shard_fleet_arrays",
    "sharded_make_windows",
    "sharded_rollup",
    "train_mesh",
]

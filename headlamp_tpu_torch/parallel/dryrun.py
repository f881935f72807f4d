"""The multichip drill: every mesh path once, held to its oracle.

The port's twin of ``dryrun_multichip`` (``__graft_entry__.py:73-236``),
with its six sections on an ``n``-rank mesh:

1. one dp×tp train step, whose loss must be finite and below 1e3;
2. the psum rollup of ``fleet_v5p32`` against ``allocation_summary()``;
3. the ring rollup against it too;
4. sequence-parallel windows over ``2 × 48·n`` samples against
   ``make_windows``, exactly;
5. the all-to-all generation histogram against ``np.bincount``;
6. ``fleet_v5p32_degraded`` (a worker gone, another NotReady) classified
   ``incomplete``, with both rollups intact.

SPMD: each rank runs the sections on its own meshes. In one process
the ``n`` ranks are threads: gloo groups on the CPU, NCCL with one card
per rank (world size 1 on one card). Under a launch (``torchrun``) each
process is a rank of the default group. Any disagreement raises;
success prints JAX's one-line summary.

    python -m headlamp_tpu_torch.parallel.dryrun 4 --device cpu
    torchrun --standalone --nproc-per-node 4 -m headlamp_tpu_torch.parallel.dryrun --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
from typing import Any

import numpy as np

from ..device import DeviceLike, resolve_device

#: The dp×tp step's batch: 4 synthetic traces of 96 samples.
TRAIN_SERIES, TRAIN_LENGTH = 4, 96
#: Samples per rank of the sequence-parallel trace: the per-rank span
#: must cover the halo (window + horizon - 1 = 39).
SEQ_SAMPLES_PER_RANK = 48
ROLLUP_KEYS = ("capacity", "allocatable", "in_use")


def _rank_sections(n: int, fleet_mesh: Any, train: Any) -> dict[str, Any]:
    """The six sections on one rank; raises at the first disagreement."""
    import torch

    from ..analytics.encode import GENERATION_IDS, encode_fleet
    from ..domain.accelerator import classify_fleet
    from ..fleet.fixtures import fleet_v5p32, fleet_v5p32_degraded
    from ..models.forecast import (
        ForecastConfig,
        adam_init,
        batch_block,
        init_params,
        make_sharded_train_step,
        make_windows,
        shard_params,
        synthetic_telemetry,
    )
    from ..topology import group_slices, summarize_slices
    from .mesh import (
        alltoall_generation_histogram,
        gather_windows,
        ring_rollup,
        sharded_make_windows,
        sharded_rollup,
    )

    # 1. The dp×tp train step.
    cfg = ForecastConfig(window=32, hidden=128, horizon=8)
    params = init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    x, y = make_windows(synthetic_telemetry(TRAIN_SERIES, TRAIN_LENGTH, device="cpu"),
                        cfg.window, cfg.horizon)
    rows = (x.shape[0] // train.data.size) * train.data.size
    shards = shard_params(params, train)
    step = make_sharded_train_step(cfg, train)
    _, _, loss = step(shards, adam_init(shards), batch_block(x[:rows], train),
                      batch_block(y[:rows], train))
    loss_value = float(loss)
    if not (math.isfinite(loss_value) and loss_value < 1e3):
        raise RuntimeError(f"train step produced bad loss: {loss_value}")

    # 2-3. The psum and ring rollups against the oracle.
    fleet = fleet_v5p32()
    view = classify_fleet(fleet["nodes"], fleet["pods"])["tpu"]
    arrays = encode_fleet(view.nodes, view.pods)
    expected = view.allocation_summary()
    rolled = sharded_rollup(arrays, fleet_mesh)
    ringed = ring_rollup(arrays, fleet_mesh)
    for name, got in (("sharded", rolled), ("ring", ringed)):
        for key in ROLLUP_KEYS:
            if got[key] != expected[key]:
                raise RuntimeError(f"{name} rollup mismatch on {key}: {got[key]} != {expected[key]}")

    # 4. Sequence-parallel windows (the halo exchange) against make_windows,
    #    over the same group under the ``seq`` axis.
    seq = dataclasses.replace(fleet_mesh, axis="seq")
    series = synthetic_telemetry(2, SEQ_SAMPLES_PER_RANK * n, device="cpu")
    x_sp, y_sp, valid = gather_windows(
        sharded_make_windows(series, cfg.window, cfg.horizon, seq), seq)
    n_pos = series.shape[1] - cfg.window - cfg.horizon + 1
    if int(valid.sum()) != n_pos:
        raise RuntimeError(f"seq-parallel windowing: {int(valid.sum())} valid positions != {n_pos}")
    x_ref, y_ref = make_windows(series, cfg.window, cfg.horizon)
    if not torch.equal(x_sp[:, :n_pos].cpu(), x_ref.reshape(2, n_pos, cfg.window)):
        raise RuntimeError("seq-parallel x windows diverge from make_windows")
    if not torch.equal(y_sp[:, :n_pos].cpu(), y_ref.reshape(2, n_pos, cfg.horizon)):
        raise RuntimeError("seq-parallel y windows diverge from make_windows")

    # 5. The all-to-all regroup against np.bincount.
    hist = alltoall_generation_histogram(arrays, fleet_mesh)
    oracle = np.bincount(arrays.node_generation[arrays.node_valid > 0],
                         minlength=len(GENERATION_IDS))
    if not np.array_equal(hist, oracle):
        raise RuntimeError(f"all_to_all histogram {list(hist)} diverges from oracle {list(oracle)}")

    # 6. A degraded slice: a host drops mid-mesh.
    degraded = fleet_v5p32_degraded()
    dview = classify_fleet(degraded["nodes"], degraded["pods"])["tpu"]
    dslices = group_slices(dview.nodes)
    if len(dslices) != 1 or dslices[0].health != "error":
        raise RuntimeError(f"degraded slice misclassified: {[(s.slice_id, s.health) for s in dslices]}")
    dsummary = dict(summarize_slices(dslices))
    want = {"total": 1, "healthy": 0, "degraded": 0, "incomplete": 1, "multi_host": 1,
            "total_chips": 16}
    if dsummary != want:
        raise RuntimeError(f"degraded slice summary {dsummary} != {want}")
    darrays = encode_fleet(dview.nodes, dview.pods)
    dexpected = dview.allocation_summary()
    drolled = sharded_rollup(darrays, fleet_mesh)
    dringed = ring_rollup(darrays, fleet_mesh)
    for key in ROLLUP_KEYS:
        if drolled[key] != dexpected[key] or dringed[key] != dexpected[key]:
            raise RuntimeError(
                f"degraded-fleet rollup mismatch on {key}: psum={drolled[key]} "
                f"ring={dringed[key]} oracle={dexpected[key]}"
            )
    return {"loss": loss_value, "train_shape": train.shape, "fleet_shape": fleet_mesh.shape,
            "seq_shape": seq.shape, "capacity": rolled["capacity"], "n_pos": n_pos, "nodes": int(oracle.sum()),
            "degraded_capacity": drolled["capacity"]}


def _summary(n_devices: int, ranks: list[dict[str, Any]]) -> str:
    """JAX's one-line summary, once every rank gave the same answer."""
    from ..analytics.encode import GENERATION_IDS

    first = ranks[0]
    if any(r != first for r in ranks[1:]):
        raise RuntimeError(f"the ranks disagree: {ranks}")
    return (
        f"dryrun_multichip ok: {n_devices} devices; "
        f"train mesh {first['train_shape']} loss={first['loss']:.4f}; "
        f"fleet rollup over {first['fleet_shape']} capacity={first['capacity']} "
        f"(psum+ring agree); seq-parallel windows over {first['seq_shape']} "
        f"({first['n_pos']} positions, halo exchange verified); all_to_all generation "
        f"regroup verified ({first['nodes']} nodes over {len(GENERATION_IDS)} buckets); "
        f"degraded slice (host drop) classified incomplete with rollup intact "
        f"(capacity={first['degraded_capacity']}, psum+ring agree)"
    )


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> str:
    """Run the six sections on an ``n_devices``-rank mesh built in this
    process on ``device`` (CUDA unless the caller asks for the CPU),
    hold every rank to the same answer, print the one-line summary and
    return it."""
    from .mesh import close_meshes, local_meshes, local_train_meshes, run_spmd

    dev = resolve_device(device)
    fleet_meshes = local_meshes(n_devices, "hosts", dev)
    train_meshes = local_train_meshes(n_devices, dev)
    try:
        ranks = run_spmd(list(zip(fleet_meshes, train_meshes)),
                         lambda pair: _rank_sections(n_devices, *pair))
    finally:
        close_meshes(fleet_meshes + train_meshes)
    line = _summary(n_devices, ranks)
    print(line)
    return line


def dryrun_launched(device: DeviceLike = None) -> str:
    """The six sections in one process of a launch (``torchrun``: one
    process per rank, ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` and the
    rendezvous address in the environment) over the default group: NCCL
    with rank ``r`` on card ``LOCAL_RANK`` on the card, gloo on the CPU.
    Rank 0 prints the summary; every rank returns it."""
    import torch
    import torch.distributed as dist

    from .mesh import DEFAULT_TIMEOUT, close_process_meshes, fleet_mesh, train_mesh

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", timeout=DEFAULT_TIMEOUT)
    try:
        n = dist.get_world_size()
        ranks: list[Any] = [None] * n
        dist.all_gather_object(ranks, _rank_sections(n, fleet_mesh(dev), train_mesh(dev)))
        line = _summary(n, ranks)
        if dist.get_rank() == 0:
            print(line)
        close_process_meshes()
    finally:
        dist.destroy_process_group()
    return line


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_devices", type=int, nargs="?", default=1,
                        help="ranks of the in-process mesh (a launch sets its own)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if "WORLD_SIZE" in os.environ:
        dryrun_launched(args.device)
    else:
        dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

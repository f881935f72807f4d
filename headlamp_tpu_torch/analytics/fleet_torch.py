"""The fleet rollup on the columns' device.

The port of ``headlamp_tpu/analytics/fleet_jax.py``'s ``fleet_rollup``
(`:30-71`, `:98-150`) and its host view (`:74-95`, `:361-397`): every
dashboard aggregate in one pass of torch ops over the columnar fleet,
with no Python loop over rows and no data-dependent control flow.

What is held exactly to the JAX program:

- segment sums go by ``index_add_`` into ``n_segments + 1`` slots and the
  sentinel slot is sliced off, as ``segment_sum(..., num_segments=
  n_nodes_pad + 1)[:n_nodes_pad]`` does: unscheduled pods point at the
  padding row ``n_nodes_pad`` (``encode``), which stays inside the
  segments (a CUDA ``index_add_`` past its end is a device-side assert,
  not a dropped row). Counts stay integers;
- ``torch.sum`` of int32 is int64 where ``jnp.sum`` is int32; the host
  dict holds Python ints either way;
- per-node utilization is float32 in the JAX order
  (``in_use / alloc * 100``, 0 where nothing is allocatable), so the
  ``>= 90`` hot-node test flips on the same nodes.

:func:`rollup_to_dict` packs every host-bound value into one float64
tensor on the device (each value is an integer below 2**53 or a float32,
both exact in float64) and crosses to the host in one counted copy
through ``runtime.transfer.fetch``, as JAX's one ``device_get`` does.
Both rollups dispatch through the program registry (``models/aot.py``):
a replay of the graph captured at the columns' bucket once the registry
is ready, the same torch ops eagerly otherwise.

The region rollup (`fleet_jax.py:153-318`) sums both drill-down levels
of the viewport tree — per cluster and per slice — in the same way, from
the same columns plus two per-node id columns the host builds
(``viewport/tree.py``). Cluster ids are clamped into
``REGION_CLUSTER_SEGMENTS`` and pods reach their region through
sentinel-extended id columns, as in JAX. Every value is an integer count,
so :func:`pack_region_rollup` packs the twelve vectors into one int64
tensor for the one copy.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from ..device import DeviceLike, resolve_device
from .encode import GENERATION_IDS, PHASE_IDS, FleetArrays

#: Phase indices of 'Running' and 'Pending' in the stable vocabulary.
_RUNNING = PHASE_IDS.index("Running")
_PENDING = PHASE_IDS.index("Pending")

#: The columns the rollup reads, in its argument order.
COLUMNS = (
    "node_capacity",
    "node_allocatable",
    "node_ready",
    "node_generation",
    "node_valid",
    "pod_request",
    "pod_phase",
    "pod_node_idx",
    "pod_valid",
)

#: Scalars at the head of the packed host-bound tensor, in order.
_PACKED_SCALARS = (
    "capacity",
    "allocatable",
    "in_use",
    "free",
    "nodes_total",
    "nodes_ready",
    "hot_nodes",
    "max_node_util_pct",
)


def _segment_sum(values: torch.Tensor, segment_ids: torch.Tensor, n_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` for in-range ids: ``values`` summed into
    ``n_segments`` slots of their own dtype."""
    out = torch.zeros(n_segments, dtype=values.dtype, device=values.device)
    return out.index_add_(0, segment_ids, values)


def local_aggregates(
    node_capacity: torch.Tensor,
    node_allocatable: torch.Tensor,
    node_ready: torch.Tensor,
    node_generation: torch.Tensor,
    node_valid: torch.Tensor,
    pod_request: torch.Tensor,
    pod_phase: torch.Tensor,
    pod_node_idx: torch.Tensor,
    pod_valid: torch.Tensor,
    *,
    n_nodes_pad: int,
) -> dict[str, torch.Tensor]:
    """The shared reduction body (`fleet_jax.py:30-71`): sums and
    histograms over the rows it is given, per-node in-use segmented into
    the node index space plus its sentinel slot."""
    cap = node_capacity * node_valid
    alloc = node_allocatable * node_valid
    running = ((pod_phase == _RUNNING) & (pod_valid == 1)).to(torch.int32)
    req_running = pod_request * running
    per_node_in_use = _segment_sum(req_running, pod_node_idx, n_nodes_pad + 1)[:n_nodes_pad]
    return {
        "capacity": cap.sum(),
        "allocatable": alloc.sum(),
        "in_use": req_running.sum(),
        "nodes_total": node_valid.sum(),
        "nodes_ready": (node_ready * node_valid).sum(),
        "phase_counts": _segment_sum(pod_valid, pod_phase, len(PHASE_IDS)),
        "generation_counts": _segment_sum(node_valid, node_generation, len(GENERATION_IDS)),
        "per_node_in_use": per_node_in_use,
    }


def fleet_rollup(
    node_capacity: torch.Tensor,
    node_allocatable: torch.Tensor,
    node_ready: torch.Tensor,
    node_generation: torch.Tensor,
    node_valid: torch.Tensor,
    pod_request: torch.Tensor,
    pod_phase: torch.Tensor,
    pod_node_idx: torch.Tensor,
    pod_valid: torch.Tensor,
) -> dict[str, torch.Tensor]:
    """All fleet aggregates (`fleet_jax.py:98-150`), as tensors on the
    columns' device:

    - capacity/allocatable/in_use/free, nodes_total/nodes_ready: int64
      scalars;
    - phase_counts[len(PHASE_IDS)], generation_counts[len(GENERATION_IDS)];
    - per_node_in_use[N_pad]: chips used by Running pods on each node;
    - per_node_util_pct[N_pad]: 0-100 float32, 0 where allocatable=0;
    - max_node_util_pct / hot_nodes (util >= 90): fleet pressure."""
    out = local_aggregates(
        node_capacity,
        node_allocatable,
        node_ready,
        node_generation,
        node_valid,
        pod_request,
        pod_phase,
        pod_node_idx,
        pod_valid,
        n_nodes_pad=node_capacity.shape[0],
    )
    alloc_f = (node_allocatable * node_valid).to(torch.float32)
    util = torch.where(
        alloc_f > 0,
        out["per_node_in_use"].to(torch.float32) / alloc_f * 100.0,
        torch.zeros_like(alloc_f),
    )
    return {
        **out,
        "free": out["allocatable"] - out["in_use"],
        "per_node_util_pct": util,
        "max_node_util_pct": util.max(),
        "hot_nodes": (util >= 90.0).sum(),
    }


def pack_rollup(out: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The host-bound values of one rollup in one float64 tensor on its
    device: the scalars, then phase counts, generation counts and the
    per-node in-use vector."""
    scalars = torch.stack([out[k].to(torch.float64) for k in _PACKED_SCALARS])
    return torch.cat(
        [
            scalars,
            out["phase_counts"].to(torch.float64),
            out["generation_counts"].to(torch.float64),
            out["per_node_in_use"].to(torch.float64),
        ]
    )


def unpack_rollup(packed: torch.Tensor) -> dict[str, Any]:
    """Inverse of :func:`pack_rollup` on the host copy."""
    values = packed.numpy()
    out: dict[str, Any] = dict(zip(_PACKED_SCALARS, values[: len(_PACKED_SCALARS)]))
    at = len(_PACKED_SCALARS)
    for name, width in (("phase_counts", len(PHASE_IDS)), ("generation_counts", len(GENERATION_IDS))):
        out[name] = values[at : at + width]
        at += width
    out["per_node_in_use"] = values[at:]
    return out


def aggregates_to_host_dict(out: Mapping[str, Any], n_nodes: int) -> dict[str, Any]:
    """Shared host-side conversion (the one copy happens in the caller):
    scalars to ints, vocabulary vectors to name→count maps."""
    allocatable = int(out["allocatable"])
    in_use = int(out["in_use"])
    return {
        "capacity": int(out["capacity"]),
        "allocatable": allocatable,
        "in_use": in_use,
        "free": allocatable - in_use,
        "nodes_total": int(out["nodes_total"]),
        "nodes_ready": int(out["nodes_ready"]),
        "phase_counts": {name: int(c) for name, c in zip(PHASE_IDS, out["phase_counts"])},
        "generation_counts": {
            name: int(c)
            for name, c in zip(GENERATION_IDS, out["generation_counts"])
            if int(c) > 0
        },
        "per_node_in_use": [int(v) for v in out["per_node_in_use"][:n_nodes]],
    }


def rollup_key(fleet: FleetArrays) -> tuple[tuple[int], tuple[int]]:
    """The program registry's key of both rollups over ``fleet``: its
    ``((node_pad,), (pod_pad,))`` column buckets."""
    return ((fleet.n_nodes_padded,), (fleet.n_pods_padded,))


def _fetch_packed(outputs: tuple[torch.Tensor, ...]) -> torch.Tensor:
    from ..runtime import transfer

    return transfer.fetch(outputs[0])


def rollup_to_dict(fleet: FleetArrays, device: DeviceLike = None) -> dict[str, Any]:
    """Host-side view of the rollup: scalars as ints, vocabulary vectors
    as name→count mappings — the shape ``allocation_summary`` and
    ``count_pod_phases`` produce, so pages can swap implementations. One
    counted device-to-host copy: inside a request's ``TransferBatch`` it
    is that request's copy.

    Dispatched through the program registry (`fleet_jax.py:320-358`):
    with a graph captured at ``analytics.fleet_rollup`` and the columns'
    bucket, the columns are copied into its static inputs and it is
    replayed; otherwise the torch ops run eagerly, counted in the graph
    cost ledger."""
    from ..models import aot
    from ..obs import graphcost
    from ..runtime import transfer

    cols = [torch.as_tensor(getattr(fleet, name), device=device) for name in COLUMNS]
    reg, key = aot.registry(), rollup_key(fleet)
    program = reg.lookup(aot.FLEET_ROLLUP, key, cols[0].device)
    if program is not None:
        packed = reg.replay(aot.FLEET_ROLLUP, key, program, cols, _fetch_packed)
    else:
        with graphcost.eager(aot.FLEET_ROLLUP):
            packed = transfer.fetch(pack_rollup(fleet_rollup(*cols)))
    return rollup_host_view(unpack_rollup(packed), fleet.n_nodes)


def rollup_host_view(out: Mapping[str, Any], n_nodes: int) -> dict[str, Any]:
    """Finalize a fetched rollup into the serving dict (`fleet_jax.py:380-397`)."""
    result = aggregates_to_host_dict(out, n_nodes)
    result.update(
        {
            "utilization_pct": (
                round(result["in_use"] / result["capacity"] * 100)
                if result["capacity"] > 0
                else 0
            ),
            "max_node_util_pct": float(out["max_node_util_pct"]),
            "hot_nodes": int(out["hot_nodes"]),
        }
    )
    return result


#: Static cluster-axis segment count of the region rollup, as in JAX
#: (`fleet_jax.py:159`). Fleets with more clusters clamp the overflow
#: into the last segment.
REGION_CLUSTER_SEGMENTS = 64

#: The fleet columns the region rollup reads, around the two id columns.
REGION_NODE_COLUMNS = ("node_capacity", "node_allocatable", "node_ready", "node_valid")
REGION_POD_COLUMNS = ("pod_request", "pod_phase", "pod_node_idx", "pod_valid")

#: The region rollup's vectors in packed order: six per cluster
#: (``REGION_CLUSTER_SEGMENTS`` long), then six per slice (``N_pad``).
REGION_KEYS = tuple(
    f"{level}_{stat}"
    for level in ("cluster", "slice")
    for stat in ("capacity", "allocatable", "nodes", "ready", "in_use", "pending")
)


def local_region_aggregates(
    node_capacity: torch.Tensor,
    node_allocatable: torch.Tensor,
    node_ready: torch.Tensor,
    node_valid: torch.Tensor,
    node_cluster: torch.Tensor,
    node_slice: torch.Tensor,
    pod_request: torch.Tensor,
    pod_phase: torch.Tensor,
    pod_node_idx: torch.Tensor,
    pod_valid: torch.Tensor,
    *,
    n_nodes_pad: int,
    n_clusters: int = REGION_CLUSTER_SEGMENTS,
    cluster_ext: torch.Tensor | None = None,
    slice_ext: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """Per-region sums for both drill-down levels (`fleet_jax.py:162-239`):
    cluster vectors [n_clusters] and slice vectors [n_nodes_pad]. Pods
    reach their region through their node's ids, the id columns extended
    by one sentinel row that the encoder's padding index
    (``n_nodes_pad``, "no node") selects; the sentinel segment is sliced
    off. The sharded mesh rollup passes replicated full-fleet extended
    columns, since ``pod_node_idx`` is a global row index that a rank's
    node block cannot answer; the single-device rollup leaves them None."""
    cluster = node_cluster.clamp(0, n_clusters - 1) * node_valid
    slc = node_slice * node_valid
    running = ((pod_phase == _RUNNING) & (pod_valid == 1)).to(torch.int32)
    pending = ((pod_phase == _PENDING) & (pod_valid == 1)).to(torch.int32)
    req_running = pod_request * running
    if cluster_ext is None:
        cluster_ext = torch.cat([cluster, cluster.new_full((1,), n_clusters)])
    if slice_ext is None:
        slice_ext = torch.cat([slc, slc.new_full((1,), n_nodes_pad)])
    pod_cluster = cluster_ext.index_select(0, pod_node_idx)
    pod_slice = slice_ext.index_select(0, pod_node_idx)

    def per_cluster(values: torch.Tensor) -> torch.Tensor:
        return _segment_sum(values, cluster, n_clusters)

    def per_slice(values: torch.Tensor) -> torch.Tensor:
        return _segment_sum(values, slc, n_nodes_pad)

    return {
        "cluster_capacity": per_cluster(node_capacity * node_valid),
        "cluster_allocatable": per_cluster(node_allocatable * node_valid),
        "cluster_nodes": per_cluster(node_valid),
        "cluster_ready": per_cluster(node_ready * node_valid),
        "cluster_in_use": _segment_sum(req_running, pod_cluster, n_clusters + 1)[:n_clusters],
        "cluster_pending": _segment_sum(pending, pod_cluster, n_clusters + 1)[:n_clusters],
        "slice_capacity": per_slice(node_capacity * node_valid),
        "slice_allocatable": per_slice(node_allocatable * node_valid),
        "slice_nodes": per_slice(node_valid),
        "slice_ready": per_slice(node_ready * node_valid),
        "slice_in_use": _segment_sum(req_running, pod_slice, n_nodes_pad + 1)[:n_nodes_pad],
        "slice_pending": _segment_sum(pending, pod_slice, n_nodes_pad + 1)[:n_nodes_pad],
    }


def region_rollup(
    node_capacity: torch.Tensor,
    node_allocatable: torch.Tensor,
    node_ready: torch.Tensor,
    node_valid: torch.Tensor,
    node_cluster: torch.Tensor,
    node_slice: torch.Tensor,
    pod_request: torch.Tensor,
    pod_phase: torch.Tensor,
    pod_node_idx: torch.Tensor,
    pod_valid: torch.Tensor,
) -> dict[str, torch.Tensor]:
    """Both drill-down levels of the viewport tree in one pass on the
    columns' device (`fleet_jax.py:243-272`): what crosses to the host is
    a few region-sized vectors, never the node rows."""
    return local_region_aggregates(
        node_capacity,
        node_allocatable,
        node_ready,
        node_valid,
        node_cluster,
        node_slice,
        pod_request,
        pod_phase,
        pod_node_idx,
        pod_valid,
        n_nodes_pad=node_capacity.shape[0],
    )


def region_rollup_arrays(
    fleet: FleetArrays, node_cluster: Any, node_slice: Any, device: DeviceLike = None
) -> dict[str, torch.Tensor]:
    """:func:`region_rollup` on ``device`` (CUDA unless the caller asks
    for the CPU) over ``fleet``'s columns and the host-built per-node
    region ids (padded to the fleet's node bucket). Columns already on
    the device are used in place; numpy arrays are copied to it."""
    dev = resolve_device(device)

    def on_device(names: tuple[str, ...]) -> list[torch.Tensor]:
        return [torch.as_tensor(getattr(fleet, name), device=dev) for name in names]

    ids = [torch.as_tensor(node_cluster, device=dev), torch.as_tensor(node_slice, device=dev)]
    return region_rollup(*on_device(REGION_NODE_COLUMNS), *ids, *on_device(REGION_POD_COLUMNS))


def region_rollup_host(
    fleet: FleetArrays, node_cluster: Any, node_slice: Any, device: DeviceLike = None
) -> dict[str, Any]:
    """The region rollup's host view (:func:`unpack_region_rollup`) in one
    counted copy, dispatched through the program registry as
    :func:`rollup_to_dict` is, under ``analytics.region_rollup`` and the
    same key (`fleet_jax.py:274-317`): a replay of the captured graph
    with the columns and the id columns copied into its static inputs,
    or :func:`region_rollup_arrays` eagerly."""
    from ..models import aot
    from ..obs import graphcost
    from ..runtime import transfer

    dev = resolve_device(device)
    reg, key = aot.registry(), rollup_key(fleet)
    program = reg.lookup(aot.REGION_ROLLUP, key, dev)
    if program is not None:
        inputs = (
            [torch.as_tensor(getattr(fleet, name), device=dev) for name in REGION_NODE_COLUMNS]
            + [torch.as_tensor(node_cluster, device=dev), torch.as_tensor(node_slice, device=dev)]
            + [torch.as_tensor(getattr(fleet, name), device=dev) for name in REGION_POD_COLUMNS]
        )
        packed = reg.replay(aot.REGION_ROLLUP, key, program, inputs, _fetch_packed)
    else:
        with graphcost.eager(aot.REGION_ROLLUP):
            out = region_rollup_arrays(fleet, node_cluster, node_slice, dev)
            packed = transfer.fetch(pack_region_rollup(out))
    return unpack_region_rollup(packed)


def pack_region_rollup(out: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The twelve region vectors in one int64 tensor on their device, in
    :data:`REGION_KEYS` order."""
    return torch.cat([out[k].to(torch.int64) for k in REGION_KEYS])


def unpack_region_rollup(packed: torch.Tensor) -> dict[str, Any]:
    """Inverse of :func:`pack_region_rollup` on the host copy: numpy
    vectors by name."""
    values = packed.numpy()
    n_slices = (values.size - 6 * REGION_CLUSTER_SEGMENTS) // 6
    out: dict[str, Any] = {}
    at = 0
    for key in REGION_KEYS:
        width = REGION_CLUSTER_SEGMENTS if key.startswith("cluster_") else n_slices
        out[key] = values[at : at + width]
        at += width
    return out

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
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from ..device import DeviceLike
from .encode import GENERATION_IDS, PHASE_IDS, FleetArrays

#: Phase index of 'Running' in the stable vocabulary.
_RUNNING = PHASE_IDS.index("Running")

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


def rollup_arrays(fleet: FleetArrays, device: DeviceLike = None) -> dict[str, torch.Tensor]:
    """:func:`fleet_rollup` over ``fleet``'s columns. Device-resident
    columns (``runtime.device_cache``) are used in place; numpy columns
    are copied to ``device`` first (the unversioned path)."""
    cols = [torch.as_tensor(getattr(fleet, name), device=device) for name in COLUMNS]
    return fleet_rollup(*cols)


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


def rollup_to_dict(fleet: FleetArrays, device: DeviceLike = None) -> dict[str, Any]:
    """Host-side view of the rollup: scalars as ints, vocabulary vectors
    as name→count mappings — the shape ``allocation_summary`` and
    ``count_pod_phases`` produce, so pages can swap implementations. One
    counted device-to-host copy: inside a request's ``TransferBatch`` it
    is that request's copy."""
    from ..runtime import transfer

    packed = transfer.fetch(pack_rollup(rollup_arrays(fleet, device)))
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

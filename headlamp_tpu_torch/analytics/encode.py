"""Snapshot → columnar arrays.

The port's copy of ``headlamp_tpu/analytics/encode.py``. Pure numpy
(no torch at encode time — encoding happens host-side once per
snapshot version); fixed categorical vocabularies so column values are
stable across fleets and the device rollup never sees strings.

Shapes are padded to the next power-of-two bucket, as in the
JAX package, whose compiled programs are cached per shape; the padding
convention (unscheduled pods point at the padding node row) is what the
rollup's sentinel segment relies on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Sequence

import numpy as np

from ..domain import objects as obj
from ..domain import tpu

#: Stable generation vocabulary (index = id). 'other' absorbs future
#: generations so encoding is total.
GENERATION_IDS: tuple[str, ...] = ("v4", "v5e", "v5p", "v6e", "unknown", "other")

#: Stable pod-phase vocabulary, mirroring count_pod_phases' buckets.
PHASE_IDS: tuple[str, ...] = ("Running", "Pending", "Succeeded", "Failed", "Other")


def _gen_id(generation: str) -> int:
    try:
        return GENERATION_IDS.index(generation)
    except ValueError:
        return GENERATION_IDS.index("other")


def _phase_id(phase: str) -> int:
    try:
        return PHASE_IDS.index(phase)
    except ValueError:
        return PHASE_IDS.index("Other")


def _bucket(n: int, minimum: int = 8) -> int:
    size = minimum
    while size < n:
        size *= 2
    return size


@dataclass
class FleetArrays:
    """Fixed-shape columnar fleet. ``n_nodes``/``n_pods`` are the live
    counts; rows beyond them are zero padding with valid=0."""

    n_nodes: int
    n_pods: int
    # Node columns [N_pad]
    node_capacity: np.ndarray
    node_allocatable: np.ndarray
    node_ready: np.ndarray
    node_generation: np.ndarray
    node_valid: np.ndarray
    # Pod columns [P_pad]
    pod_request: np.ndarray
    pod_phase: np.ndarray
    pod_node_idx: np.ndarray  # index into node rows; n_nodes_pad = "no node"
    pod_valid: np.ndarray
    node_names: list[str]

    @property
    def n_nodes_padded(self) -> int:
        return int(self.node_capacity.shape[0])

    @property
    def n_pods_padded(self) -> int:
        return int(self.pod_request.shape[0])


def encode_fleet(nodes: Sequence[Any], pods: Iterable[Any]) -> FleetArrays:
    """Encode a provider view (TPU nodes + TPU-requesting pods) into
    columnar arrays. Unscheduled pods point at the padding node row, so
    segment-sums need no masking beyond ``pod_valid``."""
    node_list = list(nodes)
    pod_list = list(pods)
    n_nodes, n_pods = len(node_list), len(pod_list)
    np_nodes = _bucket(max(n_nodes, 1))
    np_pods = _bucket(max(n_pods, 1))

    node_capacity = np.zeros(np_nodes, dtype=np.int32)
    node_allocatable = np.zeros(np_nodes, dtype=np.int32)
    node_ready = np.zeros(np_nodes, dtype=np.int32)
    node_generation = np.zeros(np_nodes, dtype=np.int32)
    node_valid = np.zeros(np_nodes, dtype=np.int32)
    node_names: list[str] = []
    index_of: dict[str, int] = {}
    for i, node in enumerate(node_list):
        node_capacity[i] = tpu.get_node_chip_capacity(node)
        node_allocatable[i] = tpu.get_node_chip_allocatable(node)
        node_ready[i] = 1 if obj.is_node_ready(node) else 0
        node_generation[i] = _gen_id(tpu.get_node_generation(node))
        node_valid[i] = 1
        name = obj.name(node)
        node_names.append(name)
        index_of[name] = i

    pod_request = np.zeros(np_pods, dtype=np.int32)
    pod_phase = np.zeros(np_pods, dtype=np.int32)
    pod_node_idx = np.full(np_pods, np_nodes, dtype=np.int32)
    pod_valid = np.zeros(np_pods, dtype=np.int32)
    for j, pod in enumerate(pod_list):
        pod_request[j] = tpu.get_pod_chip_request(pod)
        pod_phase[j] = _phase_id(obj.pod_phase(pod))
        node_name = obj.pod_node_name(pod)
        if node_name and node_name in index_of:
            pod_node_idx[j] = index_of[node_name]
        pod_valid[j] = 1

    return FleetArrays(
        n_nodes=n_nodes,
        n_pods=n_pods,
        node_capacity=node_capacity,
        node_allocatable=node_allocatable,
        node_ready=node_ready,
        node_generation=node_generation,
        node_valid=node_valid,
        pod_request=pod_request,
        pod_phase=pod_phase,
        pod_node_idx=pod_node_idx,
        pod_valid=pod_valid,
        node_names=node_names,
    )

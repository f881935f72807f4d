"""Hierarchical drill-down tree: fleet → cluster → slice → node.

The port of ``headlamp_tpu/viewport/tree.py``. Region identity is
name-based and total: every node belongs to exactly one cluster (its
:data:`~headlamp_tpu_torch.domain.constants.HEADLAMP_CLUSTER_LABEL`
value, ``"0"`` when unlabelled — every single-cluster deployment) and
one slice (its GKE node pool, ``"-"`` for single-host and plain nodes).
A drill-down path is ``cluster/<ck>`` or ``cluster/<ck>/slice/<sk>``.

Per-region rollups are computed before anything crosses to the host: at
``DEVICE_ROLLUP_MIN_NODES`` and above the sums come from the region
rollup (``analytics.fleet_torch.region_rollup``) over the context's
device-resident columns, both drill-down levels in one dispatch and one
counted copy of region-sized vectors; below the floor one Python pass
(:func:`_host_sums`, also the oracle the device numbers are held to)
computes the identical numbers. Either way the tree is memoized on the
snapshot view, so it costs O(N) once per snapshot generation and
O(regions) per request after that.

Deliberate difference from the JAX package: nothing here catches a
device error. JAX falls back to the Python pass when the device rollup
raises (`tree.py:244-247`); here the error propagates, and the page
answers 500 naming it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Mapping

import numpy as np

from ..domain import objects as obj
from ..domain import tpu
from ..domain.constants import HEADLAMP_CLUSTER_LABEL
from ..obs.trace import annotate as _annotate
from ..obs.trace import span as _span

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..analytics.encode import FleetArrays

#: Cluster key for nodes without the federation label.
DEFAULT_CLUSTER = "0"
#: Slice key for nodes outside any GKE node pool.
NO_SLICE = "-"

_MEMO_LOCK = threading.Lock()

#: Rollup stat keys, in render order — one vocabulary for the device
#: vectors and the host pass.
STAT_KEYS = ("nodes", "ready", "capacity", "allocatable", "in_use", "pending")


def node_region(node: Any) -> tuple[str, str]:
    """(cluster key, slice key) for ``node`` — total over any fleet."""
    cluster = obj.labels(node).get(HEADLAMP_CLUSTER_LABEL) or DEFAULT_CLUSTER
    return cluster, tpu.get_node_pool(node) or NO_SLICE


def region_path(cluster: str, slice_: str | None = None) -> str:
    """Canonical drill-down path for a region."""
    if slice_ is None:
        return f"cluster/{cluster}"
    return f"cluster/{cluster}/slice/{slice_}"


def parse_region(path: str) -> tuple[str, str | None] | None:
    """Parse a drill-down path back into (cluster, slice-or-None); None
    for anything that is not a canonical region path. Keys are opaque
    label values — only the path grammar is validated."""
    parts = path.strip("/").split("/")
    if len(parts) == 2 and parts[0] == "cluster" and parts[1]:
        return parts[1], None
    if (
        len(parts) == 4
        and parts[0] == "cluster"
        and parts[2] == "slice"
        and parts[1]
        and parts[3]
    ):
        return parts[1], parts[3]
    return None


@dataclass(frozen=True)
class Region:
    """One drill-down region: its canonical path, display key, rollup
    stats (:data:`STAT_KEYS`) and child regions (clusters carry their
    slices; slices carry none — node rows come from the window layer)."""

    path: str
    key: str
    level: str  # "cluster" | "slice"
    stats: dict[str, int]
    children: tuple["Region", ...] = ()


@dataclass(frozen=True)
class ViewportTree:
    """The whole drill-down hierarchy for one snapshot generation."""

    generation: int | None
    total: dict[str, int]
    clusters: tuple[Region, ...]
    #: node name -> (cluster key, slice key)
    region_of: Mapping[str, tuple[str, str]]
    #: region path -> member node names (both levels)
    members: Mapping[str, tuple[str, ...]]
    source: str  # "device" | "host"

    def region(self, path: str) -> Region | None:
        for cluster in self.clusters:
            if cluster.path == path:
                return cluster
            for slc in cluster.children:
                if slc.path == path:
                    return slc
        return None


def _assignments(
    nodes: list[Any],
) -> tuple[
    dict[str, tuple[str, str]],
    list[str],
    list[tuple[str, str]],
    dict[str, int],
    dict[tuple[str, str], int],
]:
    """One pass over the node list: per-node region, sorted cluster and
    slice vocabularies, and key→ordinal maps (the segment ids the device
    rollup sums into)."""
    region_of: dict[str, tuple[str, str]] = {}
    for node in nodes:
        region_of[obj.name(node)] = node_region(node)
    clusters = sorted({ck for ck, _sk in region_of.values()})
    slices = sorted(set(region_of.values()))
    cluster_id = {ck: i for i, ck in enumerate(clusters)}
    slice_id = {pair: i for i, pair in enumerate(slices)}
    return region_of, clusters, slices, cluster_id, slice_id


def _region_ids(
    fleet: FleetArrays,
    cluster_id: dict[str, int],
    slice_id: dict[tuple[str, str], int],
    region_of: dict[str, tuple[str, str]],
    segments_limit: int,
) -> tuple[np.ndarray, np.ndarray]:
    """The per-node (cluster, slice) segment ids in ``fleet``'s row
    order, padded to its node bucket: the two columns the region rollup
    reads beside the fleet's."""
    pad = fleet.n_nodes_padded
    node_cluster = np.zeros(pad, dtype=np.int32)
    node_slice = np.zeros(pad, dtype=np.int32)
    for i, name in enumerate(fleet.node_names):
        ck, sk = region_of[name]
        node_cluster[i] = min(cluster_id[ck], segments_limit - 1)
        node_slice[i] = slice_id[(ck, sk)]
    return node_cluster, node_slice


def _device_sums(
    state: Any,
    cluster_id: dict[str, int],
    slice_id: dict[tuple[str, str], int],
    region_of: dict[str, tuple[str, str]],
    segments_limit: int,
) -> tuple[list[dict[str, int]], list[dict[str, int]]]:
    """Per-cluster and per-slice stat dicts from one region rollup on
    ``state.device`` over the context's device-resident columns
    (``state.fleet_cache``; encoded here when the state has none), with
    the two per-node id columns uploaded beside them, and one counted
    copy back."""
    from ..analytics.encode import encode_fleet
    from ..analytics.fleet_torch import region_rollup_host

    view = state.view
    cache = state.fleet_cache
    fleet = cache.fleet_for(view) if cache is not None else encode_fleet(view.nodes, view.pods)
    with _span("viewport.region_ids"):
        node_cluster, node_slice = _region_ids(
            fleet, cluster_id, slice_id, region_of, segments_limit
        )
    host = region_rollup_host(fleet, node_cluster, node_slice, state.device)

    def stats_at(prefix: str, idx: int) -> dict[str, int]:
        return {key: int(host[f"{prefix}_{key}"][idx]) for key in STAT_KEYS}

    cluster_stats = [
        stats_at("cluster", min(cid, segments_limit - 1)) for cid in range(len(cluster_id))
    ]
    slice_stats = [stats_at("slice", sid) for sid in range(len(slice_id))]
    return cluster_stats, slice_stats


def _host_sums(
    state: Any,
    cluster_id: dict[str, int],
    slice_id: dict[tuple[str, str], int],
    region_of: dict[str, tuple[str, str]],
    segments_limit: int,
) -> tuple[list[dict[str, int]], list[dict[str, int]]]:
    """Python twin of :func:`_device_sums` — the below-floor path, and
    the oracle the device numbers are held to."""
    zeros = lambda: {k: 0 for k in STAT_KEYS}  # noqa: E731
    cluster_stats = [zeros() for _ in cluster_id]
    slice_stats = [zeros() for _ in slice_id]

    def effective_cid(ck: str) -> int:
        return min(cluster_id[ck], segments_limit - 1)

    merged: dict[int, dict[str, int]] = {}
    for node in state.nodes:
        ck, sk = region_of[obj.name(node)]
        cid, sid = effective_cid(ck), slice_id[(ck, sk)]
        cstats = merged.setdefault(cid, zeros())
        for stats in (cstats, slice_stats[sid]):
            stats["nodes"] += 1
            stats["ready"] += 1 if obj.is_node_ready(node) else 0
            stats["capacity"] += tpu.get_node_chip_capacity(node)
            stats["allocatable"] += tpu.get_node_chip_allocatable(node)
    for pod in state.pods:
        node_name = obj.pod_node_name(pod)
        if not node_name or node_name not in region_of:
            continue
        ck, sk = region_of[node_name]
        cid, sid = effective_cid(ck), slice_id[(ck, sk)]
        cstats = merged.setdefault(cid, zeros())
        phase = obj.pod_phase(pod)
        if phase == "Running":
            request = tpu.get_pod_chip_request(pod)
            cstats["in_use"] += request
            slice_stats[sid]["in_use"] += request
        elif phase == "Pending":
            cstats["pending"] += 1
            slice_stats[sid]["pending"] += 1
    # Clusters clamped into one segment all read the merged sums — the
    # same aliasing the device's clamp produces past the segment limit.
    for ck, cid in cluster_id.items():
        cluster_stats[cid] = dict(merged.get(effective_cid(ck), zeros()))
    return cluster_stats, slice_stats


def _build_tree(state: Any) -> ViewportTree:
    from ..analytics.fleet_torch import REGION_CLUSTER_SEGMENTS
    from ..analytics.stats import DEVICE_ROLLUP_MIN_NODES

    view = state.view
    nodes = state.nodes
    with _span(
        "viewport.tree", nodes=len(nodes), pods=len(state.pods),
        generation=getattr(view, "version", None),
    ):
        with _span("viewport.assign"):
            region_of, clusters, slices, cluster_id, slice_id = _assignments(nodes)

        source = "device" if len(nodes) >= DEVICE_ROLLUP_MIN_NODES else "host"
        sums = _device_sums if source == "device" else _host_sums
        with _span(
            "analytics.region_rollup", nodes=len(nodes), clusters=len(clusters),
            slices=len(slices),
        ):
            _annotate(source=source)
            cluster_stats, slice_stats = sums(
                state, cluster_id, slice_id, region_of, REGION_CLUSTER_SEGMENTS
            )

        with _span("viewport.members"):
            members: dict[str, list[str]] = {}
            for name, (ck, sk) in region_of.items():
                members.setdefault(region_path(ck), []).append(name)
                members.setdefault(region_path(ck, sk), []).append(name)
            frozen_members = {path: tuple(sorted(names)) for path, names in members.items()}

            cluster_regions: list[Region] = []
            for ck in clusters:
                child_regions = tuple(
                    Region(
                        path=region_path(ck, sk),
                        key=sk,
                        level="slice",
                        stats=slice_stats[slice_id[(ck, sk)]],
                    )
                    for ck2, sk in slices
                    if ck2 == ck
                )
                cluster_regions.append(
                    Region(
                        path=region_path(ck),
                        key=ck,
                        level="cluster",
                        stats=cluster_stats[cluster_id[ck]],
                        children=child_regions,
                    )
                )

            total = {key: 0 for key in STAT_KEYS}
            for region in cluster_regions:
                # Slice stats are exact per slice; the fleet total sums the SLICE
                # rows so segment-limit aliasing never double-counts.
                for child in region.children:
                    for key in STAT_KEYS:
                        total[key] += child.stats[key]

            return ViewportTree(
                generation=getattr(view, "version", None),
                total=total,
                clusters=tuple(cluster_regions),
                region_of=region_of,
                members=frozen_members,
                source=source,
            )


def viewport_tree(state: Any) -> ViewportTree:
    """The drill-down tree for ``state`` (a ``ProviderState``) — memoized
    on the snapshot view, so every consumer of one generation shares one
    O(N) build and one device rollup."""
    view = state.view
    cached = getattr(view, "_viewport_tree", None)
    if cached is not None:
        return cached
    tree = _build_tree(state)
    if getattr(view, "version", None) is not None:
        with _MEMO_LOCK:
            cached = getattr(view, "_viewport_tree", None)
            if cached is None:
                view._viewport_tree = tree
            else:
                tree = cached
    return tree

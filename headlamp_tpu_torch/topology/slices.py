"""Pod-slice modeling: from GKE node labels to slice membership.

The hardest structural difference from the Intel reference: one logical
TPU "device" (a pod slice) can span many Kubernetes nodes (hosts). GKE
exposes only per-node labels — accelerator, topology string, node pool —
so slice identity, expected host counts, and worker ordering must all be
*derived*. This module does that derivation purely (no I/O), feeding both
the TopologyPage and the health model (SURVEY.md §7 hard part (a)).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping

from ..domain import objects as obj
from ..domain import tpu

# ---------------------------------------------------------------------------
# Topology strings
# ---------------------------------------------------------------------------

_TOPOLOGY_RE = re.compile(r"^\d+(x\d+)*$")


def parse_topology(topology: str | None) -> tuple[int, ...]:
    """'4x4x4' -> (4, 4, 4). Invalid/absent input -> () — callers treat an
    empty tuple as "unknown topology" and degrade, never raise."""
    if not topology or not _TOPOLOGY_RE.match(topology.strip()):
        return ()
    dims = tuple(int(d) for d in topology.strip().split("x"))
    if any(d <= 0 for d in dims):
        return ()
    return dims


def topology_chip_count(dims: tuple[int, ...]) -> int:
    count = 1
    for d in dims:
        count *= d
    return count if dims else 0


#: Default chips attached to one host (VM) per generation, used only when
#: no node in a slice advertises capacity. v4/v5p hosts always carry 4
#: chips; v5e/v6e multi-host pools carry 4 (single-host pools carry the
#: whole topology and are detected from capacity instead).
DEFAULT_CHIPS_PER_HOST = {"v4": 4, "v5p": 4, "v5e": 4, "v6e": 4, "unknown": 4}


def infer_chips_per_host(generation: str, dims: tuple[int, ...], observed: int = 0) -> int:
    """Chips per host for a slice. The observed per-node capacity wins —
    it disambiguates cases like v5e '2x4', which GKE offers both as one
    8-chip host and as two 4-chip hosts depending on machine type (the
    label alone cannot tell them apart)."""
    total = topology_chip_count(dims)
    if observed > 0:
        return min(observed, total) if total else observed
    default = DEFAULT_CHIPS_PER_HOST.get(generation, 4)
    if total and total < default:
        return total
    # 2D generations pack small topologies onto one host.
    if total and len(dims) == 2 and generation in ("v5e", "v6e") and total <= 8:
        return total
    return default


def expected_host_count(generation: str, dims: tuple[int, ...], observed_chips: int = 0) -> int:
    total = topology_chip_count(dims)
    if total == 0:
        return 1
    cph = infer_chips_per_host(generation, dims, observed_chips)
    return max(1, -(-total // cph))  # ceil


# ---------------------------------------------------------------------------
# Slice grouping
# ---------------------------------------------------------------------------

_NATURAL_SPLIT = re.compile(r"(\d+)")


def _natural_key(name: str) -> tuple:
    """'pool-w10' sorts after 'pool-w2' — worker ordering must be numeric,
    not lexicographic, or 16-host slices interleave wrongly."""
    return tuple(int(p) if p.isdigit() else p for p in _NATURAL_SPLIT.split(name))


@dataclass
class SliceWorker:
    node: Any
    worker_id: int
    ready: bool
    chip_capacity: int

    @property
    def node_name(self) -> str:
        return obj.name(self.node)


@dataclass
class SliceInfo:
    """One pod slice: the unit the TopologyPage renders and the health
    model reasons about."""

    slice_id: str
    node_pool: str
    accelerator: str | None
    generation: str
    topology: str | None
    dims: tuple[int, ...]
    workers: list[SliceWorker] = field(default_factory=list)

    @property
    def total_chips(self) -> int:
        if self.dims:
            return topology_chip_count(self.dims)
        return sum(w.chip_capacity for w in self.workers)

    @property
    def chips_per_host(self) -> int:
        observed = max((w.chip_capacity for w in self.workers), default=0)
        return infer_chips_per_host(self.generation, self.dims, observed)

    @property
    def expected_hosts(self) -> int:
        observed = max((w.chip_capacity for w in self.workers), default=0)
        if not self.dims:
            return max(1, len(self.workers))
        return expected_host_count(self.generation, self.dims, observed)

    @property
    def actual_hosts(self) -> int:
        return len(self.workers)

    @property
    def is_multi_host(self) -> bool:
        return self.expected_hosts > 1

    @property
    def complete(self) -> bool:
        """Every expected worker slot is filled. Defined via
        missing_worker_ids so explicit out-of-range ids (e.g. workers
        {0,1,2,4} of an expected 4) count as incomplete instead of
        reporting a healthy slice that also lists a missing worker."""
        return not self.missing_worker_ids

    @property
    def ready_hosts(self) -> int:
        return sum(1 for w in self.workers if w.ready)

    @property
    def missing_worker_ids(self) -> list[int]:
        present = {w.worker_id for w in self.workers}
        return [i for i in range(self.expected_hosts) if i not in present]

    @property
    def health(self) -> str:
        """'success' when all expected hosts are present and ready;
        'warning' when present but not all ready; 'error' when hosts are
        missing — an incomplete multi-host slice cannot schedule any
        slice-wide workload, so it outranks mere unreadiness."""
        if not self.complete:
            return "error"
        if self.ready_hosts < self.actual_hosts:
            return "warning"
        return "success"


def group_slices(nodes: Iterable[Any]) -> list[SliceInfo]:
    """Group TPU nodes into slices.

    Slice identity on GKE: one *multi-host* node pool hosts exactly one
    pod slice, so (node pool) is the slice key — but only when the pool's
    topology actually spans hosts. A single-host pool (topology fits on
    one node, e.g. an autoscaled v5e-4 pool) holds one independent slice
    *per node*; merging those would undercount chips and misreport
    health. Nodes without a pool label each form a degenerate
    single-node slice. Worker order: explicit gke-tpu-worker-id labels
    when every node in the slice carries a distinct one, else natural
    name order (stable across refreshes).
    """
    by_pool: dict[str, list[Any]] = {}
    singletons: list[Any] = []
    for n in nodes:
        if not tpu.is_tpu_node(n):
            continue
        pool = tpu.get_node_pool(n)
        if pool:
            by_pool.setdefault(pool, []).append(n)
        else:
            singletons.append(n)

    slices: list[SliceInfo] = []
    for pool, members in sorted(by_pool.items()):
        if _pool_is_multi_host(members):
            slices.append(_build_slice(pool, pool, members))
        else:
            for n in sorted(members, key=lambda n: _natural_key(obj.name(n))):
                node_name = obj.name(n) or "node"
                slices.append(_build_slice(f"{pool}/{node_name}", pool, [n]))
    for n in singletons:
        node_name = obj.name(n) or "node"
        slices.append(_build_slice(f"node/{node_name}", f"(no pool) {node_name}", [n]))
    return slices


def _labeled_member(members: list[Any]) -> Any:
    """The member to read slice-level labels from: prefer one whose
    topology label has propagated — is_tpu_node tolerates the label/
    device-plugin registration race, so the first node in input order may
    know only its capacity while its siblings carry the full labels."""
    for n in members:
        if tpu.get_node_topology(n):
            return n
    return members[0]


def _pool_is_multi_host(members: list[Any]) -> bool:
    """A pool's topology spans hosts when the slice needs more than one
    node: topology chip count exceeds the chips observed on a member."""
    labeled = _labeled_member(members)
    dims = parse_topology(tpu.get_node_topology(labeled))
    if not dims:
        return False
    generation = tpu.get_tpu_generation(tpu.get_node_accelerator(labeled))
    observed = max((tpu.get_node_chip_capacity(n) for n in members), default=0)
    return expected_host_count(generation, dims, observed) > 1


def _build_slice(slice_id: str, pool_name: str, members: list[Any]) -> SliceInfo:
    first = _labeled_member(members)
    accelerator = tpu.get_node_accelerator(first)
    topology = tpu.get_node_topology(first)
    generation = tpu.get_tpu_generation(accelerator)
    dims = parse_topology(topology)

    explicit = [tpu.get_node_worker_id(n) for n in members]
    ids_ok = all(i is not None for i in explicit) and len(set(explicit)) == len(explicit)

    if ids_ok:
        ordered = sorted(zip(explicit, members), key=lambda t: t[0])  # type: ignore[arg-type]
        workers = [
            SliceWorker(
                node=n,
                worker_id=int(wid),  # type: ignore[arg-type]
                ready=obj.is_node_ready(n),
                chip_capacity=tpu.get_node_chip_capacity(n),
            )
            for wid, n in ordered
        ]
    else:
        ordered_nodes = sorted(members, key=lambda n: _natural_key(obj.name(n)))
        workers = [
            SliceWorker(
                node=n,
                worker_id=i,
                ready=obj.is_node_ready(n),
                chip_capacity=tpu.get_node_chip_capacity(n),
            )
            for i, n in enumerate(ordered_nodes)
        ]

    return SliceInfo(
        slice_id=slice_id,
        node_pool=pool_name,
        accelerator=accelerator,
        generation=generation,
        topology=topology,
        dims=dims,
        workers=workers,
    )


def summarize_slices(slices: Iterable[SliceInfo]) -> Mapping[str, int]:
    """Fleet-level slice counters for the Overview/Topology headers."""
    total = healthy = degraded = incomplete = multi_host = chips = 0
    for s in slices:
        total += 1
        chips += s.total_chips
        if s.is_multi_host:
            multi_host += 1
        if s.health == "success":
            healthy += 1
        elif s.health == "warning":
            degraded += 1
        else:
            incomplete += 1
    return {
        "total": total,
        "healthy": healthy,
        "degraded": degraded,
        "incomplete": incomplete,
        "multi_host": multi_host,
        "total_chips": chips,
    }

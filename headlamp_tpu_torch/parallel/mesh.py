"""The mesh over ``torch.distributed``: sharded fleet and region rollups,
an explicit ring, an all-to-all regroup and sequence-parallel windows.

The port of ``headlamp_tpu/parallel/mesh.py``. JAX runs one controller
over a ``Mesh`` of devices and ``shard_map`` hands each device its
shard. The port is SPMD instead: every rank (a process of a ``torchrun``
launch, or a thread of one process in the tests) calls the same function
with the same host :class:`~..analytics.encode.FleetArrays`, reduces its
own row block and gets the replicated result, which is what
``out_specs=P()`` gives each JAX shard.

A :class:`HostMesh` is one rank's view of a 1-D mesh: the c10d group,
the axis name, the rank, the size and the explicit device. On a CUDA
device the group must be NCCL: gloo takes CUDA tensors for some
collectives by staging them through the host, so a gloo group on CUDA
raises, and so does a tensor on any device other than the mesh's.
Two constructors: :meth:`HostMesh.from_default_group` (an initialized
default group, as ``torchrun`` gives each process) and
:func:`local_meshes` (``size`` groups built in one process over a
``HashStore`` with a ``PrefixStore`` per mesh: the CPU tests' gloo ranks
on threads, and world size 1 on the card). Every group carries a
timeout, so a collective that never completes raises.

The reduction bodies are the single-device ones
(``analytics/fleet_torch.py``'s ``local_aggregates`` and
``local_region_aggregates``): each rank reduces into the GLOBAL padded
node index space, packs every aggregate into one int64 buffer, and one
collective completes them all. Integer sums stay exact. Both rollups
dispatch through the program registry (``models/aot.py``) under
``mesh.rollup`` and ``mesh.region_rollup`` when the caller's mesh is the
process's fleet mesh (:func:`fleet_mesh`), the one the registry captures
on; any other mesh, a bucket miss, or a registry that is not ready runs
the same body eagerly, counted in the graph cost ledger. A replay that
raises propagates.

Point-to-point hops (the ring and the halo) post their send and receive
in rank-parity order, so a ring of blocking sends never waits on itself,
and a hop to the rank's own self (the halo at size 1) is a local copy:
the identity permutation.
"""

from __future__ import annotations

import dataclasses
import datetime
import threading
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..analytics.encode import GENERATION_IDS, PHASE_IDS, FleetArrays
from ..analytics.fleet_torch import (
    REGION_CLUSTER_SEGMENTS,
    REGION_NODE_COLUMNS,
    REGION_POD_COLUMNS,
    _segment_sum,
    aggregates_to_host_dict,
    local_aggregates,
    local_region_aggregates,
    pack_region_rollup,
    unpack_region_rollup,
)
from ..device import DeviceLike, canonical_device as _canonical
from ..obs.trace import span as _span

#: Every group's timeout: a collective that does not complete in this
#: time raises instead of hanging its caller.
DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)

#: The fleet columns, in the rollup's argument order.
NODE_COLUMNS = ("node_capacity", "node_allocatable", "node_ready", "node_generation", "node_valid")
POD_COLUMNS = ("pod_request", "pod_phase", "pod_node_idx", "pod_valid")

#: Registry names of the two mesh programs (JAX's names).
MESH_ROLLUP = "mesh.rollup"
MESH_REGION_ROLLUP = "mesh.region_rollup"


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


def _backend_of(group: Any) -> str:
    if isinstance(group, dist.ProcessGroup):
        return str(dist.get_backend(group))
    return str(group.name())


def _check_backend(group: Any, device: torch.device) -> None:
    """A CUDA mesh is NCCL and a CPU mesh gloo: no hidden host hop."""
    backend = _backend_of(group)
    want = "nccl" if device.type == "cuda" else "gloo"
    if backend != want:
        raise ValueError(
            f"a mesh on {device} needs a {want} group, not {backend}: gloo would "
            "stage CUDA tensors through the host"
        )


@dataclass(frozen=True, eq=False)
class HostMesh:
    """One rank's view of a 1-D mesh: its c10d group, the axis name
    (``"hosts"`` or ``"seq"``, or a train mesh's ``"data"``/``"model"``),
    its rank and the size, and the device its tensors live on."""

    group: Any
    axis: str
    rank: int
    size: int
    device: torch.device

    def __post_init__(self) -> None:
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a mesh of {self.size}")
        _check_backend(self.group, self.device)

    @property
    def shape(self) -> dict[str, int]:
        """``{axis: size}``, as a JAX mesh's ``shape`` reads."""
        return {self.axis: self.size}

    @classmethod
    def from_default_group(cls, axis: str = "hosts", device: DeviceLike = None) -> HostMesh:
        """This process's mesh over the initialized default group (a
        ``torchrun`` launch): NCCL on the card."""
        if not dist.is_initialized():
            raise RuntimeError("no default process group: call init_process_group first")
        return cls(dist.group.WORLD, axis, dist.get_rank(), dist.get_world_size(),
                   _canonical(device))

    def check(self, *tensors: torch.Tensor) -> None:
        """Every tensor must lie on the mesh's device."""
        for t in tensors:
            if t.device != self.device:
                raise ValueError(f"a tensor on {t.device} given to a mesh on {self.device}")

    def close(self) -> None:
        """Shut the group down (its threads and connections)."""
        _shutdown(self.group)


def _shutdown(group: Any) -> None:
    """Shut down a group this module built; a launch's default group and
    its subgroups belong to ``destroy_process_group``."""
    if not isinstance(group, dist.ProcessGroup):
        group.shutdown()


@dataclass(frozen=True, eq=False)
class TrainMesh:
    """One rank's view of the 2-D ``(data, model)`` train mesh: a
    sub-mesh per axis. Rank ``data_rank * model + model_rank`` holds this
    view, JAX's row-major device grid."""

    data: HostMesh
    model: HostMesh

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data.size, "model": self.model.size}

    @property
    def device(self) -> torch.device:
        return self.data.device

    def close(self) -> None:
        self.data.close()
        self.model.close()


def train_shape(size: int) -> tuple[int, int]:
    """``(data, model)`` of a train mesh of ``size`` ranks: model 2 when
    the size is even and at least 2, as JAX's ``train_mesh`` picks."""
    model = 2 if size % 2 == 0 and size >= 2 else 1
    return size // model, model


def _rank_device(device: torch.device, rank: int) -> torch.device:
    return torch.device("cuda", rank) if device.type == "cuda" else device


def _make_groups(
    store: Any,
    members: Sequence[tuple[str, int, int]],
    device: torch.device,
    timeout: datetime.timedelta,
) -> list[Any]:
    """One group per ``(prefix, rank, size)`` over ``store``. Gloo's
    constructor meets its peers, so the ranks of a gloo group are built
    on a thread each; NCCL meets them at its first collective."""
    groups: list[Any] = [None] * len(members)
    errors: list[BaseException] = []

    def build(i: int) -> None:
        prefix, rank, size = members[i]
        sub = dist.PrefixStore(prefix, store)
        try:
            if device.type == "cuda":
                from torch.distributed import ProcessGroupNCCL

                options = ProcessGroupNCCL.Options()
                options._timeout = timeout
                groups[i] = ProcessGroupNCCL(sub, rank, size, options)
            else:
                groups[i] = dist.ProcessGroupGloo(sub, rank, size, timeout)
        except Exception as exc:  # noqa: BLE001 — re-raised by the caller below
            errors.append(exc)

    if device.type == "cuda" or len(members) == 1:
        for i in range(len(members)):
            build(i)
    else:
        threads = [threading.Thread(target=build, args=(i,), daemon=True)
                   for i in range(len(members))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout.total_seconds() + 10.0)
        if any(t.is_alive() for t in threads):
            raise TimeoutError("the mesh's groups did not meet in time")
    if errors:
        raise errors[0]
    return groups


def local_meshes(
    size: int,
    axis: str = "hosts",
    device: DeviceLike = None,
    *,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> list[HostMesh]:
    """Every rank's :class:`HostMesh` of one ``size``-rank mesh, built in
    this process over one ``HashStore``: gloo ranks for threads on the
    CPU, NCCL on the card (rank ``r`` on ``cuda:r``)."""
    dev = _canonical(device)
    if dev.type == "cuda" and size > torch.cuda.device_count():
        raise ValueError(f"a {size}-rank NCCL mesh needs {size} cards")
    store = dist.HashStore()
    groups = _make_groups(store, [(f"{axis}/", r, size) for r in range(size)], dev, timeout)
    return [HostMesh(groups[r], axis, r, size, _rank_device(dev, r)) for r in range(size)]


def local_train_meshes(
    size: int, device: DeviceLike = None, *, timeout: datetime.timedelta = DEFAULT_TIMEOUT
) -> list[TrainMesh]:
    """Every rank's :class:`TrainMesh` of one ``size``-rank train mesh,
    built in this process: one ``data`` group per model column and one
    ``model`` group per data row."""
    dev = _canonical(device)
    data, model = train_shape(size)
    if dev.type == "cuda" and size > torch.cuda.device_count():
        raise ValueError(f"a {size}-rank NCCL mesh needs {size} cards")
    members = [(f"data{m}/", d, data) for d in range(data) for m in range(model)]
    members += [(f"model{d}/", m, model) for d in range(data) for m in range(model)]
    groups = _make_groups(dist.HashStore(), members, dev, timeout)
    meshes = []
    for d in range(data):
        for m in range(model):
            r = d * model + m
            rank_dev = _rank_device(dev, r)
            meshes.append(TrainMesh(
                HostMesh(groups[r], "data", d, data, rank_dev),
                HostMesh(groups[data * model + r], "model", m, model, rank_dev),
            ))
    return meshes


def run_spmd(meshes: Sequence[Any], fn: Callable[[Any], Any], *, timeout_s: float = 300.0) -> list:
    """``fn(mesh)`` for every rank of an in-process mesh, each rank on
    its own thread (a group's collectives run on that group's thread),
    and the results in rank order. The first exception of any rank is
    raised; a rank still running after ``timeout_s`` raises
    ``TimeoutError``. One rank runs on the calling thread."""
    if len(meshes) == 1:
        return [fn(meshes[0])]
    results: list[Any] = [None] * len(meshes)
    errors: list[BaseException | None] = [None] * len(meshes)

    def body(i: int) -> None:
        try:
            results[i] = fn(meshes[i])
        except Exception as exc:  # noqa: BLE001 — re-raised on the calling thread
            errors[i] = exc

    threads = [threading.Thread(target=body, args=(i,), name=f"hl-torch-rank-{i}", daemon=True)
               for i in range(len(meshes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"a rank did not finish in {timeout_s} s")
    for exc in errors:
        if exc is not None:
            raise exc
    return results


def close_meshes(meshes: Sequence[Any]) -> None:
    for mesh in meshes:
        mesh.close()


# ---------------------------------------------------------------------------
# The process's meshes (what the program registry captures on)
# ---------------------------------------------------------------------------

_PROCESS_MESHES: dict[tuple[str, str], Any] = {}
_PROCESS_LOCK = threading.Lock()


def process_mesh_size() -> int:
    """The size of this process's fleet mesh: the default group's world
    size when one was launched, else 1."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _process_mesh(kind: str, device: DeviceLike) -> Any:
    dev = _canonical(device)
    with _PROCESS_LOCK:
        return _cached_mesh(kind, dev)


def _cached_mesh(kind: str, dev: torch.device) -> Any:
    """The process mesh ``kind`` (``"hosts"``, ``"seq"`` or ``"train"``)
    on ``dev``, built once; ``seq`` shares the ``hosts`` group."""
    key = (kind, str(dev))
    if key not in _PROCESS_MESHES:
        launched = dist.is_initialized()
        if kind == "train":
            mesh = _default_train_mesh(dev) if launched else local_train_meshes(1, dev)[0]
        elif kind == "hosts":
            mesh = (HostMesh.from_default_group("hosts", dev) if launched
                    else local_meshes(1, "hosts", dev)[0])
        else:
            mesh = dataclasses.replace(_cached_mesh("hosts", dev), axis=kind)
        _PROCESS_MESHES[key] = mesh
    return _PROCESS_MESHES[key]


def _default_train_mesh(device: torch.device) -> TrainMesh:
    """The default group split into ``(data, model)`` subgroups; every
    rank creates every subgroup, in the same order."""
    size, rank = dist.get_world_size(), dist.get_rank()
    data, model = train_shape(size)
    mine: dict[str, HostMesh] = {}
    for m in range(model):
        ranks = [d * model + m for d in range(data)]
        group = dist.new_group(ranks, timeout=DEFAULT_TIMEOUT)
        if rank in ranks:
            mine["data"] = HostMesh(group, "data", ranks.index(rank), data, device)
    for d in range(data):
        ranks = [d * model + m for m in range(model)]
        group = dist.new_group(ranks, timeout=DEFAULT_TIMEOUT)
        if rank in ranks:
            mine["model"] = HostMesh(group, "model", ranks.index(rank), model, device)
    return TrainMesh(mine["data"], mine["model"])


def fleet_mesh(device: DeviceLike = None) -> HostMesh:
    """This process's 1-D ``hosts`` mesh on ``device``: over the default
    group when one was launched, else a world-size-1 group of its own.
    Built once per device; the registry's mesh programs run on it."""
    return _process_mesh("hosts", device)


def seq_mesh(device: DeviceLike = None) -> HostMesh:
    """The fleet mesh's group under the ``seq`` axis: traces shard over
    time."""
    return _process_mesh("seq", device)


def train_mesh(device: DeviceLike = None) -> TrainMesh:
    """This process's ``(data, model)`` train mesh (:func:`train_shape`)."""
    return _process_mesh("train", device)


def is_process_mesh(mesh: HostMesh) -> bool:
    return _PROCESS_MESHES.get(("hosts", str(mesh.device))) is mesh


def close_process_meshes() -> None:
    """Shut down every process mesh's group; the next call builds anew."""
    with _PROCESS_LOCK:
        meshes = list(_PROCESS_MESHES.values())
        _PROCESS_MESHES.clear()
    groups = {}
    for mesh in meshes:
        for sub in (mesh.data, mesh.model) if isinstance(mesh, TrainMesh) else (mesh,):
            groups[id(sub.group)] = sub.group
    for group in groups.values():
        _shutdown(group)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def all_reduce_(t: torch.Tensor, mesh: HostMesh) -> torch.Tensor:
    """Sum ``t`` over the mesh, in place; returns ``t``."""
    mesh.check(t)
    mesh.group.allreduce([t]).wait()
    return t


def _exchange(mesh: HostMesh, send: torch.Tensor, to: int, src: int) -> torch.Tensor:
    """Send ``send`` to rank ``to`` and receive a tensor of its shape
    from rank ``src``: one hop of a permutation. Even ranks send first
    and odd ranks receive first, so a ring of blocking hops never waits
    on itself; a hop to the rank itself is a local copy."""
    mesh.check(send)
    send = send.contiguous()
    recv = torch.empty_like(send)
    if to == mesh.rank and src == mesh.rank:
        return recv.copy_(send)
    ops = [lambda: mesh.group.send([send], to, 0), lambda: mesh.group.recv([recv], src, 0)]
    for op in ops if mesh.rank % 2 == 0 else ops[::-1]:
        op().wait()
    return recv


def ring_allreduce(x: torch.Tensor, mesh: HostMesh) -> torch.Tensor:
    """All-reduce as ``size - 1`` explicit hops around the ring
    (`mesh.py:358-380`): each hop forwards the ORIGINAL contribution the
    rank last received to its right neighbour, while a local accumulator
    sums what arrives and is never sent."""
    acc, buf = x.clone(), x
    right, left = (mesh.rank + 1) % mesh.size, (mesh.rank - 1) % mesh.size
    for _ in range(mesh.size - 1):
        buf = _exchange(mesh, buf, right, left)
        acc += buf
    return acc


def all_to_all(chunks: torch.Tensor, mesh: HostMesh) -> torch.Tensor:
    """``[size, ...]`` chunks, chunk ``c`` to rank ``c``; returns
    ``[size, ...]`` with row ``r`` from rank ``r``."""
    mesh.check(chunks)
    chunks = chunks.contiguous()
    out = torch.empty_like(chunks)
    mesh.group.alltoall_base(out, chunks, [], []).wait()
    return out


def all_gather(t: torch.Tensor, mesh: HostMesh, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim``, in rank order (a
    tiled all-gather)."""
    mesh.check(t)
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(mesh.size)]
    mesh.group.allgather([outs], [t]).wait()
    return torch.cat(outs, dim=dim)


def _reducer(mesh: HostMesh, reducer: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if reducer == "psum":
        return lambda t: all_reduce_(t, mesh)
    if reducer == "ring":
        return lambda t: ring_allreduce(t, mesh)
    raise ValueError(f"unknown reducer {reducer!r}: use 'psum' or 'ring'")


# ---------------------------------------------------------------------------
# Row blocks
# ---------------------------------------------------------------------------


def _padded_len(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _pad_to_multiple(a: np.ndarray, multiple: int, fill: int = 0) -> np.ndarray:
    rem = a.shape[0] % multiple
    if rem == 0:
        return a
    return np.concatenate([a, np.full((multiple - rem,), fill, a.dtype)])


def _row_block(column: Any, mesh: HostMesh) -> torch.Tensor:
    """This rank's block of ``column`` padded with zeros to a multiple
    of the mesh size, on the mesh's device. A host column is padded and
    cut on the host, so only the block is copied; a tensor must already
    lie on the mesh's device."""
    if isinstance(column, torch.Tensor):
        mesh.check(column)
        n = column.shape[0]
        padded = torch.cat([column, column.new_zeros(_padded_len(n, mesh.size) - n)])
    else:
        padded = _pad_to_multiple(np.asarray(column), mesh.size)
    block = padded.shape[0] // mesh.size
    part = padded[mesh.rank * block : (mesh.rank + 1) * block]
    return torch.as_tensor(np.ascontiguousarray(part) if isinstance(part, np.ndarray) else part,
                           device=mesh.device).contiguous()


def shard_fleet_arrays(fleet: FleetArrays, mesh: HostMesh) -> dict[str, torch.Tensor]:
    """This rank's padded row block of every fleet column, on the mesh's
    device (`mesh.py:505-524`), for callers composing their own sharded
    computations."""
    return {name: _row_block(getattr(fleet, name), mesh) for name in NODE_COLUMNS + POD_COLUMNS}


# ---------------------------------------------------------------------------
# The sharded rollups
# ---------------------------------------------------------------------------

#: Scalars at the head of the packed aggregates, in order.
_AGG_SCALARS = ("capacity", "allocatable", "in_use", "nodes_total", "nodes_ready")


def pack_aggregates(local: dict[str, torch.Tensor]) -> torch.Tensor:
    """Every aggregate of :func:`local_aggregates` in one int64 tensor:
    the scalars, phase counts, generation counts, per-node in-use. One
    collective reduces it; every value is an integer sum, exact."""
    return torch.cat([
        torch.stack([local[k].to(torch.int64) for k in _AGG_SCALARS]),
        local["phase_counts"].to(torch.int64),
        local["generation_counts"].to(torch.int64),
        local["per_node_in_use"].to(torch.int64),
    ])


def unpack_aggregates(packed: torch.Tensor) -> dict[str, np.ndarray]:
    """Inverse of :func:`pack_aggregates` on the host copy."""
    values = packed.numpy()
    out: dict[str, Any] = dict(zip(_AGG_SCALARS, values[: len(_AGG_SCALARS)]))
    at = len(_AGG_SCALARS)
    for name, width in (("phase_counts", len(PHASE_IDS)), ("generation_counts", len(GENERATION_IDS))):
        out[name] = values[at : at + width]
        at += width
    out["per_node_in_use"] = values[at:]
    return out


def build_rollup_shard(mesh: HostMesh, reducer: str, n_nodes_pad: int) -> Callable[..., tuple]:
    """The rank's rollup program (`mesh.py:70-114`): the shared
    reduction body over its nine row blocks into the global node index
    space of ``n_nodes_pad`` rows, packed, then one cross-rank reduction
    chosen by ``reducer`` (``"psum"`` or ``"ring"``). The serving path
    and the registry's capture run this same body."""
    reduce = _reducer(mesh, reducer)

    def rollup_body(*cols: torch.Tensor) -> tuple[torch.Tensor]:
        return (reduce(pack_aggregates(local_aggregates(*cols, n_nodes_pad=n_nodes_pad))),)

    return rollup_body


def build_region_rollup_shard(mesh: HostMesh, reducer: str, n_nodes_pad: int) -> Callable[..., tuple]:
    """The rank's region rollup program (`mesh.py:117-164`): six node
    row blocks, the two replicated sentinel-extended id columns, four
    pod row blocks; the twelve region vectors packed into one int64
    tensor and reduced once."""
    reduce = _reducer(mesh, reducer)

    def region_body(cap, alloc, ready, valid, cluster, slc, cluster_ext, slice_ext,
                    req, phase, nidx, pvalid) -> tuple[torch.Tensor]:
        local = local_region_aggregates(
            cap, alloc, ready, valid, cluster, slc, req, phase, nidx, pvalid,
            n_nodes_pad=n_nodes_pad, cluster_ext=cluster_ext, slice_ext=slice_ext,
        )
        return (reduce(pack_region_rollup(local)),)

    return region_body


def _fetch_first(outputs: tuple[torch.Tensor, ...]) -> torch.Tensor:
    from ..runtime import transfer

    return transfer.fetch(outputs[0])


def _dispatch(name: str, key: tuple, mesh: HostMesh, body: Callable[..., tuple],
              inputs: list[torch.Tensor]) -> torch.Tensor:
    """Run a mesh program and fetch its packed result in one counted
    copy: a replay of the registry's graph on the process mesh, else the
    body eagerly, counted in the graph cost ledger."""
    from ..models import aot
    from ..obs import graphcost

    reg = aot.registry()
    program = reg.lookup(name, key, mesh.device) if is_process_mesh(mesh) else None
    if program is not None:
        return reg.replay(name, key, program, inputs, _fetch_first)
    with graphcost.eager(name):
        return _fetch_first(body(*inputs))


def _rollup_with_reducer(fleet: FleetArrays, mesh: HostMesh, reducer: str) -> dict[str, Any]:
    """Shared body of the two sharded rollups (`mesh.py:254-320`)."""
    n_nodes_pad = _padded_len(fleet.n_nodes_padded, mesh.size)
    n_pods_pad = _padded_len(fleet.n_pods_padded, mesh.size)
    inputs = [_row_block(getattr(fleet, name), mesh) for name in NODE_COLUMNS + POD_COLUMNS]
    key = (reducer, (mesh.size,), (n_nodes_pad,), (n_pods_pad,))
    with _span(MESH_ROLLUP, reducer=reducer, hosts=mesh.size):
        packed = _dispatch(MESH_ROLLUP, key, mesh,
                           build_rollup_shard(mesh, reducer, n_nodes_pad), inputs)
    return aggregates_to_host_dict(unpack_aggregates(packed), fleet.n_nodes)


def sharded_rollup(fleet: FleetArrays, mesh: HostMesh) -> dict[str, Any]:
    """The fleet rollup over the ``hosts`` axis with one all-reduce of
    the packed aggregates. Per-node in-use is segmented into the GLOBAL
    node space before the reduction: a pod and its node may sit in
    different ranks' blocks."""
    return _rollup_with_reducer(fleet, mesh, "psum")


def ring_rollup(fleet: FleetArrays, mesh: HostMesh) -> dict[str, Any]:
    """:func:`sharded_rollup` with the reduction carried by
    :func:`ring_allreduce`: the same numbers, an explicit schedule."""
    return _rollup_with_reducer(fleet, mesh, "ring")


def _region_ext_columns(
    node_cluster: Any, node_slice: Any, node_valid: Any, n_nodes_pad: int
) -> tuple[np.ndarray, np.ndarray]:
    """The replicated sentinel-extended id columns (`mesh.py:196-215`),
    built from the UNPADDED masked ids: the encoder parks unscheduled
    pods at the row past its last node, so every index from there to
    ``n_nodes_pad`` must select the sentinel segment."""
    valid = np.asarray(node_valid)
    masked_cluster = np.clip(np.asarray(node_cluster), 0, REGION_CLUSTER_SEGMENTS - 1) * valid
    masked_slice = np.asarray(node_slice) * valid
    tail = n_nodes_pad + 1 - masked_cluster.shape[0]
    cluster_ext = np.concatenate([masked_cluster, np.full(tail, REGION_CLUSTER_SEGMENTS)])
    slice_ext = np.concatenate([masked_slice, np.full(tail, n_nodes_pad)])
    return cluster_ext.astype(np.int32), slice_ext.astype(np.int32)


def region_sharded_rollup(
    fleet: FleetArrays, node_cluster: Any, node_slice: Any, mesh: HostMesh,
    reducer: str = "psum",
) -> dict[str, np.ndarray]:
    """The viewport region rollup over the ``hosts`` axis
    (`mesh.py:167-251`): node and pod columns row-sharded, the id
    columns' sentinel-extended copies replicated. Returns the twelve
    vectors by name (``fleet_torch.unpack_region_rollup``); the slice
    vectors run the full mesh-padded node axis."""
    n_nodes_pad = _padded_len(fleet.n_nodes_padded, mesh.size)
    n_pods_pad = _padded_len(fleet.n_pods_padded, mesh.size)
    cluster_ext, slice_ext = _region_ext_columns(node_cluster, node_slice, fleet.node_valid,
                                                n_nodes_pad)
    inputs = (
        [_row_block(getattr(fleet, name), mesh) for name in REGION_NODE_COLUMNS]
        + [_row_block(node_cluster, mesh), _row_block(node_slice, mesh)]
        + [torch.as_tensor(cluster_ext, device=mesh.device),
           torch.as_tensor(slice_ext, device=mesh.device)]
        + [_row_block(getattr(fleet, name), mesh) for name in REGION_POD_COLUMNS]
    )
    key = (reducer, (mesh.size,), (n_nodes_pad,), (n_pods_pad,))
    with _span(MESH_REGION_ROLLUP, reducer=reducer, hosts=mesh.size):
        packed = _dispatch(MESH_REGION_ROLLUP, key, mesh,
                           build_region_rollup_shard(mesh, reducer, n_nodes_pad), inputs)
    return unpack_region_rollup(packed)


# ---------------------------------------------------------------------------
# All-to-all and sequence parallelism
# ---------------------------------------------------------------------------


def alltoall_generation_histogram(fleet: FleetArrays, mesh: HostMesh) -> np.ndarray:
    """The generation histogram by bucket regrouping (`mesh.py:390-443`):
    a local histogram over the bucket space padded to a multiple of the
    mesh size, an all-to-all that hands rank ``b`` every rank's partials
    for the buckets it owns, a local sum, and a tiled all-gather.
    Returns the ``[len(GENERATION_IDS)]`` histogram on the host."""
    from ..runtime import transfer

    vocab = len(GENERATION_IDS)
    vocab_pad = _padded_len(vocab, mesh.size)
    gen = _row_block(fleet.node_generation, mesh)
    valid = _row_block(fleet.node_valid, mesh)
    local = _segment_sum((valid > 0).to(torch.int32), gen, vocab_pad)
    arrived = all_to_all(local.reshape(mesh.size, vocab_pad // mesh.size), mesh)
    full = all_gather(arrived.sum(dim=0, dtype=torch.int32), mesh)
    return transfer.fetch(full)[:vocab].numpy()


def sharded_make_windows(
    series: Any, window: int, horizon: int, mesh: HostMesh
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequence-parallel sliding windows with a halo exchange
    (`mesh.py:446-502`). The rank holds ``series[:, r*T/s:(r+1)*T/s]``
    and sends its first ``window + horizon - 1`` columns to rank ``r-1``
    around the ring, never the whole series. Returns the rank's local
    ``(x [n, T/s, window], y [n, T/s, horizon], valid [T/s])``: position
    ``p`` is valid iff ``p <= T - window - horizon`` (the halo the last
    rank receives wraps around and is masked). :func:`gather_windows`
    assembles the global result."""
    series = torch.as_tensor(series, dtype=torch.float32)
    n_series, total_t = series.shape
    s = mesh.size
    if total_t % s != 0:
        raise ValueError(
            f"series length {total_t} must be divisible by seq={s}: pad or "
            "trim the trace to a multiple of the mesh size"
        )
    local_t = total_t // s
    halo = window + horizon - 1
    if halo > local_t:
        raise ValueError(
            f"halo {halo} exceeds the per-shard span {local_t}: use fewer "
            "seq shards or longer traces"
        )
    block = series[:, mesh.rank * local_t : (mesh.rank + 1) * local_t].to(mesh.device)
    halo_block = _exchange(mesh, block[:, :halo], (mesh.rank - 1) % s, (mesh.rank + 1) % s)
    extended = torch.cat([block, halo_block], dim=1)
    starts = torch.arange(local_t, device=mesh.device)
    x = extended[:, starts[:, None] + torch.arange(window, device=mesh.device)[None, :]]
    y = extended[:, starts[:, None] + window + torch.arange(horizon, device=mesh.device)[None, :]]
    valid = mesh.rank * local_t + starts <= total_t - window - horizon
    return x, y, valid


def gather_windows(
    local: tuple[torch.Tensor, torch.Tensor, torch.Tensor], mesh: HostMesh
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The global ``(x, y, valid)`` of :func:`sharded_make_windows` on
    every rank: the time blocks gathered in rank order."""
    x, y, valid = local
    flags = all_gather(valid.to(torch.uint8), mesh).bool()  # collectives carry no bool
    return all_gather(x, mesh, dim=1), all_gather(y, mesh, dim=1), flags

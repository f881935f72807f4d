"""ICI mesh geometry: chip coordinates, host blocks, inter-host links,
and a 2D projection the TopologyPage can render directly.

Pure integer geometry — no I/O, no floats beyond pixel positions — so the
TS mirror (`plugin/src/api/topology.ts`) can reproduce it exactly and the
shared-fixture tests can diff the two (tests/test_ts_parity.py).

Physical model (public TPU system architecture):
- A slice's chips form an N-D grid given by the topology label
  (2D for v5e/v6e, 3D for v4/v5p).
- Each host (VM) owns a contiguous block of chips: (2,2,1) on 3D
  generations, (2,2) on 2D multi-host pools, the whole grid on
  single-host pools.
- ICI links connect grid neighbours along each axis; 3D generations form
  a torus (wrap links) along axes of size >= 4.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

from .slices import SliceInfo

# ---------------------------------------------------------------------------
# Host blocks
# ---------------------------------------------------------------------------

def host_block(dims: tuple[int, ...], chips_per_host: int) -> tuple[int, ...]:
    """Shape of the chip block owned by one host.

    Factor ``chips_per_host`` over the leading axes as evenly as possible
    (4 chips -> (2,2) or (2,2,1) when divisible; degenerate topologies fall
    back to filling the first axis)."""
    if not dims:
        return ()
    if chips_per_host <= 1:
        return tuple(1 for _ in dims)
    block = [1] * len(dims)
    remaining = chips_per_host
    # Prefer square-ish blocks: repeatedly halve over axes that divide.
    axis = 0
    guard = 0
    while remaining > 1 and guard < 64:
        guard += 1
        placed = False
        for i in range(len(dims)):
            a = (axis + i) % len(dims)
            if remaining % 2 == 0 and dims[a] % (block[a] * 2) == 0:
                block[a] *= 2
                remaining //= 2
                axis = (a + 1) % len(dims)
                placed = True
                break
        if not placed:
            # Odd or non-dividing remainder: stack what's left on the first
            # axis that can absorb it; else give the host the whole grid.
            for a in range(len(dims)):
                if dims[a] % (block[a] * remaining) == 0:
                    block[a] *= remaining
                    remaining = 1
                    placed = True
                    break
            if not placed:
                return dims
    return tuple(block)


def _grid_iter(dims: tuple[int, ...]) -> Iterator[tuple[int, ...]]:
    """Row-major iteration over all coordinates (first axis slowest)."""
    if not dims:
        return
    coord = [0] * len(dims)
    total = 1
    for d in dims:
        total *= d
    for _ in range(total):
        yield tuple(coord)
        for a in range(len(dims) - 1, -1, -1):
            coord[a] += 1
            if coord[a] < dims[a]:
                break
            coord[a] = 0


def chip_worker(coord: tuple[int, ...], block: tuple[int, ...], host_grid: tuple[int, ...]) -> int:
    """Worker (host) index owning a chip coordinate: row-major index of the
    host-block coordinate."""
    idx = 0
    for a in range(len(coord)):
        idx = idx * host_grid[a] + (coord[a] // block[a] if block[a] else 0)
    return idx


# ---------------------------------------------------------------------------
# Mesh layout
# ---------------------------------------------------------------------------

@dataclass
class MeshCell:
    chip_index: int
    coord: tuple[int, ...]
    worker_id: int
    #: 2D projection for rendering (grid units, not pixels).
    px: int
    py: int


@dataclass
class MeshLink:
    a: int  # chip_index
    b: int  # chip_index
    axis: int
    wrap: bool


@dataclass
class MeshLayout:
    dims: tuple[int, ...]
    host_grid: tuple[int, ...]
    block: tuple[int, ...]
    cells: list[MeshCell] = field(default_factory=list)
    links: list[MeshLink] = field(default_factory=list)
    width: int = 0
    height: int = 0


#: Generations whose inter-host ICI forms a torus (wrap links) on axes of
#: size >= 4. 2D generations (v5e/v6e) are plain meshes.
_TORUS_GENERATIONS = ("v4", "v5p")

#: Horizontal gap (in grid units) between z-layers in the 3D projection.
_LAYER_GAP = 1


def build_mesh_layout(sl: SliceInfo) -> MeshLayout:
    """Geometry for one slice. Unknown topology -> one row of hosts with
    no links (the honest fallback; the page labels it 'topology unknown')."""
    dims = sl.dims
    if not dims:
        cells = [
            MeshCell(chip_index=i, coord=(i,), worker_id=w.worker_id, px=i, py=0)
            for i, w in enumerate(sl.workers)
        ]
        return MeshLayout(
            dims=(),
            host_grid=(len(cells),) if cells else (0,),
            block=(1,),
            cells=cells,
            links=[],
            width=max(len(cells), 1),
            height=1,
        )

    cph = sl.chips_per_host
    block = host_block(dims, cph)
    host_grid = tuple(d // b if b else 1 for d, b in zip(dims, block))

    coords = list(_grid_iter(dims))
    index_of = {c: i for i, c in enumerate(coords)}

    cells: list[MeshCell] = []
    for i, c in enumerate(coords):
        worker = chip_worker(c, block, host_grid)
        px, py = _project(c, dims)
        cells.append(MeshCell(chip_index=i, coord=c, worker_id=worker, px=px, py=py))

    torus = sl.generation in _TORUS_GENERATIONS
    links: list[MeshLink] = []
    for i, c in enumerate(coords):
        for axis in range(len(dims)):
            size = dims[axis]
            if size < 2:
                continue
            nxt = list(c)
            nxt[axis] += 1
            if nxt[axis] < size:
                links.append(MeshLink(a=i, b=index_of[tuple(nxt)], axis=axis, wrap=False))
            elif torus and size >= 4:
                nxt[axis] = 0
                links.append(MeshLink(a=i, b=index_of[tuple(nxt)], axis=axis, wrap=True))

    width = max((cell.px for cell in cells), default=0) + 1
    height = max((cell.py for cell in cells), default=0) + 1
    return MeshLayout(
        dims=dims, host_grid=host_grid, block=block,
        cells=cells, links=links, width=width, height=height,
    )


def _project(coord: tuple[int, ...], dims: tuple[int, ...]) -> tuple[int, int]:
    """2D projection: 1D -> a row; 2D -> identity; 3D+ -> layers side by
    side, each layer an x-y grid. Axes beyond the second collapse into a
    single row-major layer index so even a future 4D topology keeps
    every chip at a distinct position."""
    if len(coord) == 1:
        return coord[0], 0
    if len(coord) == 2:
        return coord[0], coord[1]
    layer = 0
    for a in range(2, len(coord)):
        layer = layer * dims[a] + coord[a]
    return coord[0] + layer * (dims[0] + _LAYER_GAP), coord[1]

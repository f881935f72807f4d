"""ICI pod-slice topology: slice grouping and mesh geometry."""

from .mesh import MeshCell, MeshLayout, MeshLink, build_mesh_layout, host_block  # noqa: F401
from .slices import (  # noqa: F401
    SliceInfo,
    SliceWorker,
    expected_host_count,
    group_slices,
    infer_chips_per_host,
    parse_topology,
    summarize_slices,
    topology_chip_count,
)

"""Viewport layer: O(what-the-viewer-sees) serving.

The port's copy of ``headlamp_tpu/viewport``: pages ask for a drill-down
tree (``tree.viewport_tree`` — per-region rollups computed on the device
at scale), a cursor-stable row window (``window_nodes`` /
``window_pods``, optionally scoped to one region — seek cursors that
survive fleet churn; ``window_series`` over trend series) or a memoized derived map (``pods_by_node``), and
the O(N) passes run once per snapshot generation, memoized on the
snapshot view itself.
"""

from .cursor import decode_cursor, encode_cursor, query_hash
from .tree import (
    Region,
    ViewportTree,
    node_region,
    parse_region,
    region_path,
    viewport_tree,
)
from .window import (
    Window,
    clamp_limit,
    pending_pods,
    pods_by_node,
    running_chips,
    window_nodes,
    window_pods,
    window_series,
)

__all__ = [
    "Region",
    "ViewportTree",
    "Window",
    "clamp_limit",
    "decode_cursor",
    "encode_cursor",
    "node_region",
    "parse_region",
    "pending_pods",
    "pods_by_node",
    "query_hash",
    "region_path",
    "running_chips",
    "viewport_tree",
    "window_nodes",
    "window_pods",
    "window_series",
]

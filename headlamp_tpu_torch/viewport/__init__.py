"""Viewport layer: O(what-the-viewer-sees) serving.

The port's copy of the row windows of ``headlamp_tpu/viewport``: pages
ask for a cursor-stable row window (``window_nodes`` / ``window_pods`` —
seek cursors that survive fleet churn) or a memoized derived map
(``pods_by_node``), and the O(N) passes run once per snapshot generation,
memoized on the snapshot view itself. The drill-down tree arrives with
the region rollup.
"""

from .cursor import decode_cursor, encode_cursor, query_hash
from .window import (
    Window,
    clamp_limit,
    pending_pods,
    pods_by_node,
    running_chips,
    window_nodes,
    window_pods,
)

__all__ = [
    "Window",
    "clamp_limit",
    "decode_cursor",
    "encode_cursor",
    "pending_pods",
    "pods_by_node",
    "query_hash",
    "running_chips",
    "window_nodes",
    "window_pods",
]

"""Nodes-table column integration.

The port's copy of ``headlamp_tpu/integrations/node_columns.py``
(`NodeColumns.tsx`): column definitions appended to the native Nodes
table, each getter guarded so non-TPU rows show '—' (`:17-48`). Consumed
by the registration layer's columns processor.
"""

from __future__ import annotations

from typing import Any

from ..domain import tpu
from .common import unwrap_json_data


def _gen_cell(node: Any) -> str:
    node = unwrap_json_data(node)
    if not tpu.is_tpu_node(node):
        return "—"
    return tpu.format_accelerator(tpu.get_node_accelerator(node))


def _chips_cell(node: Any) -> str:
    node = unwrap_json_data(node)
    if not tpu.is_tpu_node(node):
        return "—"
    return str(tpu.get_node_chip_capacity(node))


def _topology_cell(node: Any) -> str:
    node = unwrap_json_data(node)
    if not tpu.is_tpu_node(node):
        return "—"
    return tpu.get_node_topology(node) or "—"


def build_node_tpu_columns() -> list[dict[str, Any]]:
    """Column defs: label + getter, the SimpleTable/processor contract
    (`NodeColumns.tsx:17` returns the same shape for the Headlamp
    table)."""
    return [
        {"label": "TPU Type", "getter": _gen_cell},
        {"label": "TPU Chips", "getter": _chips_cell},
        {"label": "TPU Topology", "getter": _topology_cell},
    ]

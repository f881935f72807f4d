"""Columnar fleet to flat bytes and back: the shared-memory segment's
column layout.

The port's copy of ``headlamp_tpu/runtime/columns.py``. The
:class:`~headlamp_tpu_torch.analytics.encode.FleetArrays` columns are
contiguous fixed-dtype numpy arrays, the shape a shared-memory segment
wants. :func:`pack_fleet` serializes one to a self-describing blob (magic,
a JSON table of contents, then 8-aligned raw column bytes), byte for byte
the JAX package's blob for the same columns; :func:`unpack_fleet` rebuilds
it as ``np.frombuffer`` views over the source buffer, so a worker that
read a published segment parses a small table of contents and never runs
``encode_fleet``'s per-node loop.

The magic carries the layout version: a reader that sees another magic
refuses the blob outright, never half-decodes a foreign layout.

The views are as writable as the buffer they wrap. The segment reader
(``workers/shm.py``) copies the payload out of the map into a
``bytearray`` it owns, so the views are writable and the seed hands them
to ``torch.from_numpy`` with no second host copy; a ``bytes`` source
gives read-only views.
"""

from __future__ import annotations

import json
import struct
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..analytics.encode import FleetArrays

#: The layout version rides in the magic: bump the trailing digit for an
#: incompatible change, and old readers refuse it by the magic.
COLUMNS_MAGIC = b"HLTPCOL1"

#: The array fields serialized, in a fixed order (the table of contents
#: repeats the names, so the order is for determinism, not decoding).
ARRAY_FIELDS: tuple[str, ...] = (
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

_LEN = struct.Struct("<I")


def _pad8(n: int) -> int:
    return (-n) % 8


def pack_fleet(fleet: FleetArrays) -> bytes:
    """One FleetArrays as self-describing bytes. Deterministic (canonical
    JSON table of contents, fixed field order, zero padding): two packs of
    the same columns are byte-identical, in either package."""
    parts: list[bytes] = []
    columns: list[list[object]] = []
    offset = 0
    for name in ARRAY_FIELDS:
        arr = np.ascontiguousarray(getattr(fleet, name))
        raw = arr.tobytes()
        columns.append([name, arr.dtype.str, int(arr.shape[0]), offset])
        parts.append(raw)
        pad = _pad8(len(raw))
        if pad:
            parts.append(b"\x00" * pad)
        offset += len(raw) + pad
    toc = json.dumps(
        {
            "n_nodes": int(fleet.n_nodes),
            "n_pods": int(fleet.n_pods),
            "node_names": list(fleet.node_names),
            "columns": columns,
        },
        sort_keys=True,
        separators=(",", ":"),
    ).encode("utf-8")
    head = COLUMNS_MAGIC + _LEN.pack(len(toc))
    lead = len(head) + len(toc)
    return head + toc + b"\x00" * _pad8(lead) + b"".join(parts)


def unpack_fleet(buf: bytes | bytearray | memoryview) -> FleetArrays:
    """Bytes to a FleetArrays whose columns are ``frombuffer`` views over
    ``buf`` (no copy). Raises ``ValueError`` on a foreign magic, a
    truncated blob or a missing column: a corrupt segment surfaces as an
    exception the worker's ladder counts, never as garbage arrays."""
    from ..analytics.encode import FleetArrays

    view = memoryview(buf)
    if len(view) < len(COLUMNS_MAGIC) + _LEN.size:
        raise ValueError("column blob truncated before header")
    if bytes(view[: len(COLUMNS_MAGIC)]) != COLUMNS_MAGIC:
        raise ValueError(f"column blob magic mismatch (expected {COLUMNS_MAGIC!r})")
    (toc_len,) = _LEN.unpack_from(view, len(COLUMNS_MAGIC))
    toc_start = len(COLUMNS_MAGIC) + _LEN.size
    if len(view) < toc_start + toc_len:
        raise ValueError("column blob truncated inside toc")
    toc = json.loads(bytes(view[toc_start : toc_start + toc_len]))
    lead = toc_start + toc_len
    data_start = lead + _pad8(lead)
    arrays: dict[str, np.ndarray] = {}
    for name, dtype, length, offset in toc["columns"]:
        if name not in ARRAY_FIELDS:
            continue  # a newer writer's extra column: skipped, not fatal
        dt = np.dtype(dtype)
        end = data_start + offset + length * dt.itemsize
        if end > len(view):
            raise ValueError(f"column blob truncated inside column {name!r}")
        arrays[name] = np.frombuffer(view, dtype=dt, count=length, offset=data_start + offset)
    missing = [name for name in ARRAY_FIELDS if name not in arrays]
    if missing:
        raise ValueError(f"column blob missing columns: {missing}")
    return FleetArrays(
        n_nodes=int(toc["n_nodes"]),
        n_pods=int(toc["n_pods"]),
        node_names=[str(n) for n in toc["node_names"]],
        **arrays,
    )


__all__ = ["ARRAY_FIELDS", "COLUMNS_MAGIC", "pack_fleet", "unpack_fleet"]

"""Seek cursors for windowed tables — the port's copy of
``headlamp_tpu/viewport/cursor.py``.

A cursor is NOT an offset. Offsets break under churn: delete one node
while a viewer is on page 3 and every later page shifts — rows skip or
repeat. A seek cursor instead records the SORT KEY of the last row the
client saw; the next window is "rows strictly after this key", which is
stable against insertions and deletions anywhere else in the fleet (a
surviving row is never skipped or repeated; for a pinned generation the
pages tile the fleet exactly).

The token is urlsafe base64 over compact JSON — opaque to clients,
inspectable in a debugger — carrying:

``g``
    snapshot generation the window was cut from (observability + the
    ETag/coalesce key; seek semantics do not need it to be current).
``s``
    sort id (``rn`` ready-then-name node order, ``nn`` namespaced pod
    name, ``lb`` trend-series label). A cursor replayed against a different sort is ignored, never
    misapplied.
``q``
    8-hex hash of the filter query the window was cut under — same
    guard, a cursor never carries across filters.
``k``
    the last row's sort key (JSON array of ints/strings).

Malformed, truncated, or tampered tokens decode to ``None`` and the
window starts from the top — a cursor can degrade a request to page 1,
never break it.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import json
from dataclasses import dataclass

#: Sort ids — the ``s`` vocabulary.
SORT_NODES = "rn"
SORT_PODS = "nn"
SORT_SERIES = "lb"

_MAX_TOKEN = 512  # hard cap: a cursor is ~tens of bytes, never KBs


def query_hash(query: str) -> str:
    """Stable 8-hex digest binding a cursor to its filter."""
    return hashlib.sha1(query.encode("utf-8")).hexdigest()[:8]


@dataclass(frozen=True)
class Cursor:
    generation: int
    sort: str
    query_hash: str
    last_key: tuple


def encode_cursor(
    *, generation: int, sort: str, query: str, last_key: tuple
) -> str:
    payload = json.dumps(
        {
            "g": int(generation),
            "s": sort,
            "q": query_hash(query),
            "k": list(last_key),
        },
        separators=(",", ":"),
        sort_keys=True,
    )
    return (
        base64.urlsafe_b64encode(payload.encode("utf-8"))
        .decode("ascii")
        .rstrip("=")
    )


def decode_cursor(token: str) -> Cursor | None:
    if not token or len(token) > _MAX_TOKEN:
        return None
    try:
        padded = token + "=" * (-len(token) % 4)
        payload = json.loads(base64.urlsafe_b64decode(padded.encode("ascii")))
    except (binascii.Error, ValueError, UnicodeDecodeError):
        return None
    if not isinstance(payload, dict):
        return None
    generation = payload.get("g")
    sort = payload.get("s")
    qh = payload.get("q")
    key = payload.get("k")
    if (
        not isinstance(generation, int)
        or not isinstance(sort, str)
        or not isinstance(qh, str)
        or not isinstance(key, list)
        or not all(isinstance(part, (int, str)) for part in key)
    ):
        return None
    return Cursor(
        generation=generation, sort=sort, query_hash=qh, last_key=tuple(key)
    )

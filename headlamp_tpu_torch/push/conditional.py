"""Conditional and compressed full paints.

The port's copy of ``headlamp_tpu/push/conditional.py:81-235``. Strong
ETags derive from ``(generation, cache epoch, degraded, window)``: the
invariants the gateway's coalesce key already uses to decide that two
renders give the same bytes. When they match, the bytes the client holds
are the bytes a render would produce, so ``If-None-Match`` answers 304
before render-pool admission: a poll against an unchanged fleet costs a
string compare, not a pool slot.

Gzip is negotiated per request from ``Accept-Encoding`` and applied at
the socket layer (the gateway trades in ``str`` bodies). ``mtime=0``
keeps the compressed bytes deterministic, so an ETag-keyed cache can
reuse them.

This is the polling half of the push package: a client on ``/events``
gets patch frames from the differ and the hub instead, and repaints in
full only on a ``paint`` event or after a ``bye``.
"""

from __future__ import annotations

import gzip as _gzip
import hashlib
import threading
import zlib
from collections import OrderedDict
from urllib.parse import parse_qsl, urlparse

from ..obs.metrics import registry as _metrics_registry

#: Bodies below this size skip gzip: the header and deflate bookkeeping
#: can grow a tiny payload.
MIN_GZIP_SIZE = 512

#: zlib's default level: a fleet paint compresses about 10x at level 1
#: already, and level 9 buys nothing measurable for milliseconds more.
GZIP_LEVEL = 6

#: Gzip output cache bound. Strong ETags change with every generation, so
#: entries age out; 64 covers the routes and windows a poll fleet touches
#: within one generation.
GZIP_CACHE_LIMIT = 64

_GZIP_BYTES = _metrics_registry.counter(
    "headlamp_tpu_torch_push_gzip_bytes_total",
    "Full-paint body bytes through the negotiated-gzip encoder, raw vs compressed.",
    labels=("kind",),
)
_NOT_MODIFIED = _metrics_registry.counter(
    "headlamp_tpu_torch_push_not_modified_total",
    "Conditional requests answered 304 before render-pool admission, by route template.",
    labels=("route",),
)
_GZIP_CACHE_EVENTS = _metrics_registry.counter(
    "headlamp_tpu_torch_push_gzip_cache_total",
    "Gzip output cache traffic for ETag-keyed full paints (hit, miss, evicted).",
    labels=("outcome",),
)

#: (etag, raw length, raw crc32) -> gzip bytes, or None when the body
#: proved incompressible. The ETag alone is not a safe key: two routes at
#: one generation share a tag while painting different bodies, so the
#: length and crc pin the cached bytes to the exact body.
_GZIP_CACHE: OrderedDict[tuple[str, int, int], bytes | None] = OrderedDict()
_GZIP_CACHE_LOCK = threading.Lock()


def etag_for(generation: int, epoch: int, degraded: bool, window: str = "") -> str:
    """Strong, quoted ETag for the current paint invariants. ``window`` is
    the request's :func:`window_token`; empty for a bare path."""
    tag = f"g{int(generation)}-e{int(epoch)}-d{1 if degraded else 0}"
    if window:
        tag += f"-w{window}"
    return f'"{tag}"'


def window_token(path: str) -> str:
    """A short stable token for a request's query string: the coalesce
    key's sorted-params normalization, hashed. ``""`` without a query."""
    query = urlparse(path).query
    if not query:
        return ""
    pairs = sorted(parse_qsl(query, keep_blank_values=True))
    if not pairs:
        return ""
    encoded = "&".join(f"{key}={value}" for key, value in pairs)
    return hashlib.sha1(encoded.encode("utf-8")).hexdigest()[:8]


def if_none_match_matches(header: str | None, etag: str) -> bool:
    """Does an ``If-None-Match`` header validate against ``etag``? Weak
    comparison (RFC 7232 §3.2): ``W/"x"`` matches ``"x"``, and ``*``
    matches any current representation."""
    if not header:
        return False
    header = header.strip()
    if header == "*":
        return True
    for candidate in header.split(","):
        candidate = candidate.strip()
        if candidate.startswith("W/"):
            candidate = candidate[2:]
        if candidate == etag:
            return True
    return False


def count_not_modified(route: str) -> None:
    """Record one pre-admission 304 (the gateway feeds requests_total
    itself; this family is the conditional path's own view)."""
    _NOT_MODIFIED.inc(route=route)


def gzip_accepted(accept_encoding: str | None) -> bool:
    """Did the client offer gzip with a non-zero q? Honours ``gzip;q=0``
    (an explicit refusal) and ``*``."""
    if not accept_encoding:
        return False
    wildcard_q: float | None = None
    for part in accept_encoding.split(","):
        bits = part.strip().split(";")
        coding = bits[0].strip().lower()
        q = 1.0
        for param in bits[1:]:
            param = param.strip()
            if param.startswith("q="):
                try:
                    q = float(param[2:])
                except ValueError:
                    q = 0.0
        if coding == "gzip":
            return q > 0.0
        if coding == "*":
            wildcard_q = q
    return wildcard_q is not None and wildcard_q > 0.0


def encode_body(
    data: bytes, accept_encoding: str | None, *, etag: str | None = None
) -> tuple[bytes, str | None]:
    """(payload, content-encoding or None) for a full-paint body: gzip
    only when the client accepts it, the body clears ``MIN_GZIP_SIZE`` and
    compression shrank it. With ``etag`` the output is cached, so a poll
    fleet on an unchanged route pays one encode per generation."""
    if len(data) < MIN_GZIP_SIZE or not gzip_accepted(accept_encoding):
        return data, None
    key = None
    if etag:
        key = (etag, len(data), zlib.crc32(data))
        with _GZIP_CACHE_LOCK:
            if key in _GZIP_CACHE:
                cached = _GZIP_CACHE[key]
                _GZIP_CACHE.move_to_end(key)
                _GZIP_CACHE_EVENTS.inc(outcome="hit")
                if cached is None:
                    return data, None
                return cached, "gzip"
        _GZIP_CACHE_EVENTS.inc(outcome="miss")
    compressed = _gzip.compress(data, GZIP_LEVEL, mtime=0)
    shrank = len(compressed) < len(data)
    if key is not None:
        with _GZIP_CACHE_LOCK:
            _GZIP_CACHE[key] = compressed if shrank else None
            _GZIP_CACHE.move_to_end(key)
            while len(_GZIP_CACHE) > GZIP_CACHE_LIMIT:
                _GZIP_CACHE.popitem(last=False)
                _GZIP_CACHE_EVENTS.inc(outcome="evicted")
    if not shrank:
        return data, None
    _GZIP_BYTES.inc(len(data), kind="raw")
    _GZIP_BYTES.inc(len(compressed), kind="compressed")
    return compressed, "gzip"


def gzip_cache_clear() -> None:
    """Empty the output cache (the counters stay)."""
    with _GZIP_CACHE_LOCK:
        _GZIP_CACHE.clear()


def gzip_cache_len() -> int:
    with _GZIP_CACHE_LOCK:
        return len(_GZIP_CACHE)

"""Conditional and compressed full paints: the ETag, ``If-None-Match``
and gzip helpers the request gateway and the socket layer use. The port's
copy of the part of ``headlamp_tpu/push`` those two need; the differ,
the hub and ``/events`` are not part of this package yet."""

from .conditional import (
    GZIP_CACHE_LIMIT,
    GZIP_LEVEL,
    MIN_GZIP_SIZE,
    count_not_modified,
    encode_body,
    etag_for,
    gzip_accepted,
    gzip_cache_clear,
    gzip_cache_len,
    if_none_match_matches,
    window_token,
)

__all__ = [
    "GZIP_CACHE_LIMIT",
    "GZIP_LEVEL",
    "MIN_GZIP_SIZE",
    "count_not_modified",
    "encode_body",
    "etag_for",
    "gzip_accepted",
    "gzip_cache_clear",
    "gzip_cache_len",
    "if_none_match_matches",
    "window_token",
]

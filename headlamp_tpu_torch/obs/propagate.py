"""W3C-style ``traceparent`` propagation across processes.

The port's copy of ``headlamp_tpu/obs/propagate.py``. The one transport
seam (``transport/pool.py``) stamps the calling context's trace id as a
``traceparent`` request header on every outbound request, and the host
reads it back, so a replica's bus poll, the leader's bus serve and a
gateway request join one logical trace. Each process still mints its own
trace id (``obs/trace.py``) and records the caller's as
``remote_parent``.

Format: ``00-<trace-id 32 hex>-<parent-id 16 hex>-<flags 2 hex>``. The
native trace ids are 16 hex characters (``os.urandom(8)``), so formatting
left-pads them to the 32-hex field and parsing takes the last 16: a round
trip is the identity for native ids, and a full-width id from another
tracer keeps its low 64 bits. The parent-id field carries the trace id
too: spans have no ids of their own, so the request root is the parent.

This module owns the header's name, format and parse, and never writes a
header mapping: ``transport/pool.py`` is the one place in the port that
builds the outbound header (the TRC001 rule holds it). Every injection,
extraction and rejection is counted in
``headlamp_tpu_torch_trace_propagation_total{direction}``, so a proxy
that strips the header shows on /metricsz rather than as unjoined traces.
"""

from __future__ import annotations

import re
from typing import NamedTuple

from .metrics import registry
from .trace import current_trace_id

#: The one header name, lower-case on the wire (``http.server`` matches
#: header names case-insensitively on read).
TRACEPARENT_HEADER = "traceparent"

#: Version 00 only, the only version defined; anything else is rejected
#: (counted, never raised).
_TRACEPARENT_RE = re.compile(r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

#: All-zero ids are invalid in the W3C grammar.
_ZERO_TRACE = "0" * 32
_ZERO_SPAN = "0" * 16

_PROPAGATION = registry.counter(
    "headlamp_tpu_torch_trace_propagation_total",
    "traceparent headers injected at the transport seam, extracted by the "
    "host, or rejected as malformed",
    labels=("direction",),
)


class RemoteParent(NamedTuple):
    """A parsed inbound ``traceparent``. ``trace_id`` is the 16-hex native
    form (the low 64 bits of the wire field), what ``Trace.remote_parent``
    stores."""

    trace_id: str
    span_id: str
    sampled: bool


def format_traceparent(trace_id: str, span_id: str | None = None, *, sampled: bool = True) -> str:
    """The wire value for a native 16-hex (or a full 32-hex) trace id.
    ``span_id`` defaults to the trace id: the request root is the parent
    span."""
    span_part = (span_id or trace_id)[-16:].rjust(16, "0")
    return f"00-{trace_id[-32:].rjust(32, '0')}-{span_part}-{'01' if sampled else '00'}"


def parse_traceparent(value: str | None) -> RemoteParent | None:
    """Parse an inbound header value: None, counted ``invalid``, for
    anything malformed, of another version or with a zero id. A missing
    header (None or empty) is not an error and is not counted."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip())
    if m is None:
        _PROPAGATION.inc(direction="invalid")
        return None
    trace_hex, span_hex, flags = m.group(1), m.group(2), m.group(3)
    if trace_hex == _ZERO_TRACE or span_hex == _ZERO_SPAN:
        _PROPAGATION.inc(direction="invalid")
        return None
    _PROPAGATION.inc(direction="extracted")
    return RemoteParent(
        trace_id=trace_hex[-16:], span_id=span_hex, sampled=bool(int(flags, 16) & 0x01)
    )


def current_traceparent() -> str | None:
    """The wire value for the calling context's trace, or None outside
    one."""
    trace_id = current_trace_id()
    if trace_id is None:
        return None
    return format_traceparent(trace_id)


def record_injected() -> None:
    """Count one outbound injection; only the transport seam calls it,
    where it writes the header."""
    _PROPAGATION.inc(direction="injected")

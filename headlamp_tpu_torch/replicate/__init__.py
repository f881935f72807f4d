"""The read tier: one sync leader, any number of paint and push replicas.

The port's copy of ``headlamp_tpu/replicate/``. Everything downstream of
a snapshot generation is a function of (snapshot, metrics peek, history
window), and this package splits the process along that seam:

- **bus.py** — each generation, with its peeks and the history rows it
  contributed, encoded as one versioned JSONL record, kept in a bounded
  backlog and served to replicas from a ``Last-Generation`` cursor (the
  push hub's ``g<N>`` grammar).
- **leader.py** — lease-based election on the injected monotonic clock.
  The lease's fencing token fences generation bands (``generation =
  fencing × GENERATION_STRIDE + local``), so a deposed leader's publishes
  are rejected by the generation monotonicity that keys ETags, coalesce
  keys and push frames.
- **replica.py** — a :class:`ReplicaApp` fed by a :class:`BusConsumer`:
  each applied record feeds the push differ and the history store, and
  the gateway, the rollups on the replica's card, the push hub and the
  ETag/304 tier serve unchanged. While the leader is gone the replica
  answers with ``X-Headlamp-Stale: 1`` and converges on the new leader's
  first generation.
"""

from __future__ import annotations

from .bus import (
    BUS_FORMAT,
    BUS_VERSION,
    BusPublisher,
    build_record,
    decode_forecast,
    decode_metrics,
    decode_snapshot,
    dumps_record,
    encode_forecast,
    encode_metrics,
    encode_snapshot,
    history_rows,
    parse_payload,
)
from .leader import (
    DEFAULT_LEASE_TTL_S,
    GENERATION_STRIDE,
    LeaderElector,
    Lease,
    LeaseStore,
    generation_floor,
)
from .replica import BusConsumer, ReplicaApp, pool_fetch, set_active_consumer

__all__ = [
    "BUS_FORMAT",
    "BUS_VERSION",
    "BusConsumer",
    "BusPublisher",
    "DEFAULT_LEASE_TTL_S",
    "GENERATION_STRIDE",
    "LeaderElector",
    "Lease",
    "LeaseStore",
    "ReplicaApp",
    "build_record",
    "decode_forecast",
    "decode_metrics",
    "decode_snapshot",
    "dumps_record",
    "encode_forecast",
    "encode_metrics",
    "encode_snapshot",
    "generation_floor",
    "history_rows",
    "parse_payload",
    "pool_fetch",
    "set_active_consumer",
]

"""Multi-process serving: N worker processes behind one port.

The port's copy of ``headlamp_tpu/workers/``. N worker processes accept
on one port (``SO_REUSEPORT`` where the kernel offers it, a shared
listener otherwise), each a ``ReplicaApp`` on its own card context fed
through the read tier's ``apply_record``. Snapshot generations reach them
through a shared-memory segment on the host (a generation header, a
seqlock, the bus record line and the packed columns, which each worker
uploads to its card with no encode); the bus stays the cross-host wire
format and the counted fallback. The supervisor starts the workers with
``spawn``.
"""

from .balancer import RoundRobinBalancer, pick_strategy, reuseport_supported, shared_listener
from .shm import (
    SEGMENT_VERSION,
    SegmentBusPublisher,
    SegmentCorrupt,
    SegmentError,
    SegmentFrame,
    SegmentReader,
    SegmentUnavailable,
    SegmentVersionGated,
    SnapshotSegment,
    default_segment_path,
)
from .status import WorkerStatusBoard, register_worker_metrics
from .supervisor import WorkerSupervisor, run_supervisor
from .worker import ShmConsumer, worker_main

__all__ = [
    "RoundRobinBalancer",
    "SEGMENT_VERSION",
    "SegmentBusPublisher",
    "SegmentCorrupt",
    "SegmentError",
    "SegmentFrame",
    "SegmentReader",
    "SegmentUnavailable",
    "SegmentVersionGated",
    "ShmConsumer",
    "SnapshotSegment",
    "WorkerStatusBoard",
    "WorkerSupervisor",
    "default_segment_path",
    "pick_strategy",
    "register_worker_metrics",
    "reuseport_supported",
    "run_supervisor",
    "shared_listener",
    "worker_main",
]

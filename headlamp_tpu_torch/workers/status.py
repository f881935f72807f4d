"""The cross-worker status board: every worker's counters, readable from
any process on the host.

The port's copy of ``headlamp_tpu/workers/status.py``. A second small
mmap'd file: each worker owns one fixed slot that it alone writes (no
lock, one writer per slot), and any process on the host reads them all.
Under ``SO_REUSEPORT`` a ``/metricsz`` scrape or a ``/healthz`` probe
lands on an arbitrary worker, so every worker renders every worker's
counters from the board, and the answer does not depend on which process
took the socket.

Layout::

    0   magic    8s  b"HLTPWSB\\0"
    8   version  u32
    12  n_slots  u32
    16  slots, 48 bytes each:
        u32 worker_id   u32 pid   u64 generation
        u64 generations_applied   u64 shm_attach_failures
        u64 fallback_decodes

Slot reads take no seqlock: every field is monotone on its own (or an id
or pid set once), so a torn read shows a value between two true ones.
"""

from __future__ import annotations

import mmap
import os
import struct
import tempfile
from typing import Any

from ..obs.metrics import registry as _metrics_registry

BOARD_MAGIC = b"HLTPWSB\x00"
BOARD_VERSION = 1
_BOARD_HEADER = struct.Struct("<8sII")
_SLOT = struct.Struct("<IIQQQQ")
SLOT_SIZE = _SLOT.size  # 48

#: The per-worker counter families, labelled by worker slot and rendered
#: from the board at scrape time.
WORKER_METRIC_FAMILIES = (
    "headlamp_tpu_torch_worker_generations_applied_total",
    "headlamp_tpu_torch_worker_shm_attach_failures_total",
    "headlamp_tpu_torch_worker_fallback_decodes_total",
)


class WorkerSlot:
    """One worker's writer handle: the counters are plain ints here, and
    every change writes the packed slot through."""

    def __init__(self, board: WorkerStatusBoard, worker_id: int) -> None:
        self._board = board
        self.worker_id = int(worker_id)
        self.pid = os.getpid()
        self.generation = 0
        self.generations_applied = 0
        self.shm_attach_failures = 0
        self.fallback_decodes = 0
        self._write()

    def _write(self) -> None:
        self._board._write_slot(
            self.worker_id, self.pid, self.generation, self.generations_applied,
            self.shm_attach_failures, self.fallback_decodes,
        )

    def applied(self, generation: int) -> None:
        self.generation = int(generation)
        self.generations_applied += 1
        self._write()

    def attach_failure(self) -> None:
        self.shm_attach_failures += 1
        self._write()

    def fallback_decode(self) -> None:
        self.fallback_decodes += 1
        self._write()


class WorkerStatusBoard:
    """The mmap'd board. :meth:`create` (the supervisor) makes a zeroed
    file through a temp file and a rename; :meth:`attach` (a worker, a
    reader) maps the existing file writable, so each worker can write its
    own slot."""

    def __init__(self, path: str, *, n_slots: int, _map: mmap.mmap, _file: Any) -> None:
        self.path = path
        self.n_slots = int(n_slots)
        self._map = _map
        self._file = _file

    @classmethod
    def create(cls, path: str, *, n_slots: int) -> WorkerStatusBoard:
        size = _BOARD_HEADER.size + int(n_slots) * SLOT_SIZE
        directory = os.path.dirname(path) or "."
        fd, tmp = tempfile.mkstemp(prefix=".hltp-wsb-", dir=directory)
        try:
            os.ftruncate(fd, size)
            header = bytearray(_BOARD_HEADER.size)
            _BOARD_HEADER.pack_into(header, 0, BOARD_MAGIC, BOARD_VERSION, n_slots)
            os.pwrite(fd, bytes(header), 0)
            file = os.fdopen(os.dup(fd), "r+b")
            os.replace(tmp, path)
        except BaseException:
            os.close(fd)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        os.close(fd)
        return cls(path, n_slots=n_slots, _map=mmap.mmap(file.fileno(), size), _file=file)

    @classmethod
    def attach(cls, path: str) -> WorkerStatusBoard:
        """Map an existing board; a foreign or truncated file raises
        ``ValueError``."""
        file = open(path, "r+b")
        try:
            size = os.fstat(file.fileno()).st_size
            if size < _BOARD_HEADER.size:
                raise ValueError(f"status board at {path} is smaller than its header")
            m = mmap.mmap(file.fileno(), size)
            magic, version, n_slots = _BOARD_HEADER.unpack_from(m, 0)
            if magic != BOARD_MAGIC or version != BOARD_VERSION:
                m.close()
                raise ValueError(f"foreign status board at {path}")
        except BaseException:
            file.close()
            raise
        return cls(path, n_slots=n_slots, _map=m, _file=file)

    def slot(self, worker_id: int) -> WorkerSlot:
        if not 0 <= int(worker_id) < self.n_slots:
            raise ValueError(f"worker id {worker_id} outside board ({self.n_slots} slots)")
        return WorkerSlot(self, worker_id)

    def _write_slot(self, worker_id: int, *values: int) -> None:
        offset = _BOARD_HEADER.size + int(worker_id) * SLOT_SIZE
        _SLOT.pack_into(self._map, offset, int(worker_id), *[int(v) for v in values])

    def rows(self) -> list[dict[str, int]]:
        """Every registered slot (pid != 0), in worker-id order."""
        out: list[dict[str, int]] = []
        for i in range(self.n_slots):
            offset = _BOARD_HEADER.size + i * SLOT_SIZE
            worker_id, pid, generation, applied, attach_failures, fallbacks = _SLOT.unpack_from(
                self._map, offset
            )
            if pid == 0:
                continue
            out.append({
                "worker": worker_id,
                "pid": pid,
                "generation": generation,
                "generations_applied": applied,
                "shm_attach_failures": attach_failures,
                "fallback_decodes": fallbacks,
            })
        return out

    def samples(self, field: str) -> list[tuple[tuple[str, ...], int]]:
        """``((worker,), value)`` pairs of one counter field: the scrape
        feed of the per-worker families."""
        return [((f"w{row['worker']}",), row[field]) for row in self.rows()]

    def snapshot(self, *, self_id: int | None = None) -> dict[str, Any]:
        """The /healthz ``runtime.workers`` block: which worker answered,
        how many slots are live, and every worker's counters."""
        rows = self.rows()
        return {
            "self": f"w{self_id}" if self_id is not None else None,
            "slots": self.n_slots,
            "live": len(rows),
            "workers": rows,
        }

    def close(self) -> None:
        try:
            self._map.close()
        finally:
            self._file.close()

    def unlink(self) -> None:
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


def register_worker_metrics(board: WorkerStatusBoard) -> None:
    """Wire the three per-worker counter families to ``board``: callback
    counters rendered from the shared slots at scrape time, the latest
    producer winning, so every process that attaches the board may call
    this."""
    _metrics_registry.counter_samples_fn(
        "headlamp_tpu_torch_worker_generations_applied_total",
        "Snapshot generations applied by each worker process (from the shared "
        "status board; labelled by worker slot).",
        ("worker",),
        lambda: board.samples("generations_applied"),
    )
    _metrics_registry.counter_samples_fn(
        "headlamp_tpu_torch_worker_shm_attach_failures_total",
        "Shared-memory segment attach or read failures per worker (each a "
        "counted step down to the bus).",
        ("worker",),
        lambda: board.samples("shm_attach_failures"),
    )
    _metrics_registry.counter_samples_fn(
        "headlamp_tpu_torch_worker_fallback_decodes_total",
        "Generations a worker applied off the bus instead of the shared-memory segment.",
        ("worker",),
        lambda: board.samples("fallback_decodes"),
    )


__all__ = [
    "BOARD_MAGIC",
    "BOARD_VERSION",
    "SLOT_SIZE",
    "WORKER_METRIC_FAMILIES",
    "WorkerSlot",
    "WorkerStatusBoard",
    "register_worker_metrics",
]

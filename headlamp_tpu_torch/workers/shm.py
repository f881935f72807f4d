"""The shared-memory snapshot plane: one segment per serving host.

The port's copy of ``headlamp_tpu/workers/shm.py``. The supervisor (the
leader) publishes each generation into one mmap'd file-backed segment,
and every worker process attaches it read-only. Layout, byte for byte the
JAX package's::

    0   magic            8s   b"HLTPSHM\\0"
    8   version          u32  SEGMENT_VERSION (readers refuse others)
    12  reserved         u32
    16  seq              u64  seqlock: odd while a write is in progress
    24  generation       u64  snapshot generation of the payload
    32  fencing          u64  leadership term that published it
    40  record_off       u64  the canonical bus record line
    48  record_len       u64
    56  columns_off      u64  per-provider packed columns (runtime/columns.py)
    64  columns_len      u64
    128 payload area

Seqlock: the writer bumps ``seq`` to an odd value, writes the payload,
then the header fields, then bumps ``seq`` to the next even value. A
reader reads ``seq`` (retrying while odd), copies the payload out of the
map, reads ``seq`` again, and parses only when the two reads match: a
torn write costs a retry, never a half-applied snapshot.

The record inside the segment is the exact line the bus publisher keeps
(``replicate.bus.dumps_record``), so a record applied from the segment is
the one a replica applies off the bus, and its pages, ETags, 304s and
push frames are the same bytes.

Fallback ladder: no segment at the path raises ``SegmentUnavailable``; a
foreign layout version ``SegmentVersionGated``; a short file, a bad
magic, an unstable seqlock or a payload that fails to parse
``SegmentCorrupt``. A worker counts each rung and takes the bus.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import tempfile
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

from ..obs.trace import span
from ..replicate.bus import BusPublisher
from ..runtime.columns import pack_fleet, unpack_fleet

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..analytics.encode import FleetArrays

SEGMENT_MAGIC = b"HLTPSHM\x00"
SEGMENT_VERSION = 1

#: The fixed header area; the payload starts here.
HEADER_SIZE = 128

#: The default segment size. A 16384-node record is about 18.7 MB plus
#: its columns; the file is sparse until written. A payload that does not
#: fit is refused and counted, and the workers ride the bus for it.
DEFAULT_SEGMENT_SIZE = 64 * 1024 * 1024

_HEADER = struct.Struct("<8sII7Q")  # magic, version, reserved, seq..columns_len
_SEQ = struct.Struct("<Q")
_SEQ_OFF = 16
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


class SegmentError(Exception):
    """The base of the fallback ladder's rungs."""


class SegmentUnavailable(SegmentError):
    """No segment at the path (no supervisor, or not publishing yet)."""


class SegmentVersionGated(SegmentError):
    """A segment that speaks another layout version."""


class SegmentCorrupt(SegmentError):
    """A bad magic, a truncated payload or an unstable seqlock read."""


def default_segment_path(port: int, *, kind: str = "seg") -> str:
    """The per-port rendezvous path: /dev/shm where the host has it (no
    disk traffic), the temp directory otherwise. Both sides derive it from
    the serving port alone."""
    base = "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()
    return os.path.join(base, f"headlamp-tpu-{int(port)}.{kind}")


def _pack_columns(columns: dict[str, FleetArrays]) -> bytes:
    """The columns section: a u32 count, then per provider (sorted) a
    u32-length-prefixed UTF-8 name and a u64-length-prefixed
    ``pack_fleet`` blob."""
    parts = [_U32.pack(len(columns))]
    for name in sorted(columns):
        blob = pack_fleet(columns[name])
        encoded = name.encode("utf-8")
        parts += [_U32.pack(len(encoded)), encoded, _U64.pack(len(blob)), blob]
    return b"".join(parts)


def _unpack_columns(buf: bytearray) -> dict[str, FleetArrays]:
    """The columns section back to FleetArrays whose columns are writable
    views over ``buf`` (JAX copies each blob into ``bytes``, `shm.py:134`,
    which gives read-only views)."""
    out: dict[str, FleetArrays] = {}
    view = memoryview(buf)
    if len(view) < _U32.size:
        raise ValueError("columns section truncated")
    (count,) = _U32.unpack_from(view, 0)
    pos = _U32.size
    for _ in range(count):
        (name_len,) = _U32.unpack_from(view, pos)
        pos += _U32.size
        name = bytes(view[pos : pos + name_len]).decode("utf-8")
        pos += name_len
        (blob_len,) = _U64.unpack_from(view, pos)
        pos += _U64.size
        if pos + blob_len > len(view):
            raise ValueError(f"columns section truncated in {name!r}")
        out[name] = unpack_fleet(view[pos : pos + blob_len])
        pos += blob_len
    return out


@dataclass
class SegmentFrame:
    """One stable read of the segment: the generation header and the
    payload copied out of the map (the frame owns the column bytes, so a
    later publish never changes them under a reader)."""

    generation: int
    fencing: int
    record_line: str
    columns: dict[str, FleetArrays]

    def record(self) -> dict[str, Any]:
        """The bus record, ready for ``ReplicaApp.apply_record``."""
        return json.loads(self.record_line)


class SnapshotSegment:
    """The writer: the supervisor's publish target. Creation is atomic (a
    temp file, then a rename), so a reader never attaches a half-written
    header."""

    def __init__(
        self, path: str, *, size: int = DEFAULT_SEGMENT_SIZE, version: int = SEGMENT_VERSION
    ) -> None:
        self.path = path
        self.size = int(size)
        self.version = int(version)
        self.published = 0
        self.overflows = 0
        directory = os.path.dirname(path) or "."
        fd, tmp = tempfile.mkstemp(prefix=".hltp-seg-", dir=directory)
        try:
            os.ftruncate(fd, self.size)
            header = bytearray(HEADER_SIZE)
            _HEADER.pack_into(header, 0, SEGMENT_MAGIC, self.version, 0, 0, 0, 0, 0, 0, 0, 0)
            os.pwrite(fd, bytes(header), 0)
            self._file = os.fdopen(os.dup(fd), "r+b")
            os.replace(tmp, path)
        except BaseException:
            os.close(fd)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        os.close(fd)
        self._map = mmap.mmap(self._file.fileno(), self.size)
        self._seq = 0

    def publish(
        self,
        record_line: str,
        columns: dict[str, FleetArrays],
        *,
        generation: int,
        fencing: int = 0,
    ) -> bool:
        """Overwrite the payload with a new generation under the seqlock.
        Returns False (counted in ``overflows``) when the payload does not
        fit: the bus backlog still carries the generation."""
        record = record_line.encode("utf-8")
        cols = _pack_columns(columns)
        record_off = HEADER_SIZE
        columns_off = record_off + len(record) + (-len(record)) % 8
        if columns_off + len(cols) > self.size:
            self.overflows += 1
            return False
        m = self._map
        self._seq += 1  # odd: write in progress
        _SEQ.pack_into(m, _SEQ_OFF, self._seq)
        m[record_off : record_off + len(record)] = record
        m[columns_off : columns_off + len(cols)] = cols
        struct.pack_into(
            "<QQQQQQ", m, 24, int(generation), int(fencing), record_off, len(record),
            columns_off, len(cols),
        )
        self._seq += 1  # even: stable
        _SEQ.pack_into(m, _SEQ_OFF, self._seq)
        self.published += 1
        return True

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


class SegmentReader:
    """The reader: a worker attaches read-only and pulls stable frames.
    The constructor raises the ladder's rung that applies; :meth:`read`
    re-checks the header every call (a newer supervisor can replace the
    file under the path)."""

    #: Seqlock retries before the segment counts as unstable: a writer
    #: that died mid-publish leaves ``seq`` odd for good.
    MAX_RETRIES = 64

    def __init__(self, path: str) -> None:
        self.path = path
        try:
            self._file = open(path, "rb")
        except FileNotFoundError as exc:
            raise SegmentUnavailable(f"no segment at {path}") from exc
        try:
            size = os.fstat(self._file.fileno()).st_size
            if size < HEADER_SIZE:
                raise SegmentCorrupt(f"segment at {path} smaller than header")
            self._map = mmap.mmap(self._file.fileno(), size, access=mmap.ACCESS_READ)
        except SegmentError:
            self._file.close()
            raise
        except (OSError, ValueError) as exc:
            self._file.close()
            raise SegmentCorrupt(f"segment at {path} unmappable") from exc
        try:
            self._check_header()
        except SegmentError:
            self.close()
            raise

    def _check_header(self) -> None:
        magic, version, *_rest = _HEADER.unpack_from(self._map, 0)
        if magic != SEGMENT_MAGIC:
            raise SegmentCorrupt(f"segment at {self.path} has foreign magic {magic!r}")
        if version != SEGMENT_VERSION:
            raise SegmentVersionGated(
                f"segment at {self.path} is layout v{version}; this build reads "
                f"v{SEGMENT_VERSION}"
            )

    def generation(self) -> int:
        """The header's generation, the poll's "anything new?" peek (one
        u64 read, no payload copy); :meth:`read` re-validates."""
        return _U64.unpack_from(self._map, 24)[0]

    def read(self) -> SegmentFrame | None:
        """One stable frame, or None while nothing was published
        (generation 0). Raises ``SegmentVersionGated`` or
        ``SegmentCorrupt`` per the ladder."""
        self._check_header()
        m = self._map
        for _ in range(self.MAX_RETRIES):
            (seq1,) = _SEQ.unpack_from(m, _SEQ_OFF)
            if seq1 & 1:
                continue  # a write in progress
            generation, fencing, record_off, record_len, cols_off, cols_len = struct.unpack_from(
                "<QQQQQQ", m, 24
            )
            if generation == 0:
                return None
            end = max(record_off + record_len, cols_off + cols_len)
            if end > len(m) or record_off < HEADER_SIZE:
                raise SegmentCorrupt(f"segment at {self.path} header points outside the map")
            # Copied before the confirming seq read: the copy is what it
            # validates. The columns land in a bytearray this frame owns,
            # in one copy.
            with memoryview(m) as whole:
                record = bytes(whole[record_off : record_off + record_len])
                cols = bytearray(whole[cols_off : cols_off + cols_len])
            (seq2,) = _SEQ.unpack_from(m, _SEQ_OFF)
            if seq1 != seq2:
                continue  # torn read: retry
            try:
                return SegmentFrame(
                    generation=int(generation),
                    fencing=int(fencing),
                    record_line=record.decode("utf-8"),
                    columns=_unpack_columns(cols),
                )
            except (ValueError, UnicodeDecodeError) as exc:
                raise SegmentCorrupt(f"segment at {self.path} payload failed to parse") from exc
        raise SegmentCorrupt(f"segment at {self.path} seqlock never stabilized")

    def close(self) -> None:
        try:
            self._map.close()
        finally:
            self._file.close()


class SegmentBusPublisher(BusPublisher):
    """A :class:`BusPublisher` that also mirrors every accepted generation
    into the segment: the bus record line verbatim, plus each provider's
    columns encoded once more with ``encode_fleet`` (JAX's semantics). The
    bus backlog stays the truth: a mirror that overflows or raises is
    counted in ``segment_failures`` and named in ``last_segment_error``,
    and the workers take the bus for that generation. The mirror runs in
    its own ``workers.segment`` span, inside the sync's
    ``replicate.publish``."""

    def __init__(self, segment: SnapshotSegment, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.segment = segment
        self.segment_publishes = 0
        self.segment_failures = 0
        self.last_segment_error: str | None = None

    def publish(
        self, snap: Any, *, generation: int, metrics: Any = None, forecast: Any = None
    ) -> bool:
        accepted = super().publish(snap, generation=generation, metrics=metrics, forecast=forecast)
        if not accepted:
            return False
        with self._lock:
            line = self._backlog[-1][1]
        try:
            from ..analytics.encode import encode_fleet

            with span("workers.segment", generation=int(generation)):
                columns = {
                    name: encode_fleet(state.view.nodes, state.view.pods)
                    for name, state in (snap.providers or {}).items()
                }
                written = self.segment.publish(
                    line, columns, generation=generation, fencing=self.fencing
                )
            if written:
                self.segment_publishes += 1
            else:
                self.segment_failures += 1
                self.last_segment_error = (
                    f"overflow: generation {generation} does not fit {self.segment.size} bytes"
                )
        except Exception as e:  # noqa: BLE001 — counted and named; the bus carries the generation
            self.segment_failures += 1
            self.last_segment_error = f"{type(e).__name__}: {e}"
        return True

    def snapshot(self) -> dict[str, Any]:
        out = super().snapshot()
        out.update(
            segment_publishes=self.segment_publishes,
            segment_failures=self.segment_failures,
            last_segment_error=self.last_segment_error,
            segment_path=self.segment.path,
        )
        return out


__all__ = [
    "DEFAULT_SEGMENT_SIZE",
    "HEADER_SIZE",
    "SEGMENT_MAGIC",
    "SEGMENT_VERSION",
    "SegmentBusPublisher",
    "SegmentCorrupt",
    "SegmentError",
    "SegmentFrame",
    "SegmentReader",
    "SegmentUnavailable",
    "SegmentVersionGated",
    "SnapshotSegment",
    "default_segment_path",
]

"""A worker process: a read replica fed from the shared-memory segment.

The port's copy of ``headlamp_tpu/workers/worker.py``. A worker is the
read tier's :class:`~headlamp_tpu_torch.replicate.replica.ReplicaApp`
with another feed: :class:`ShmConsumer` peeks the segment's generation on
each tick, reads it under the seqlock only when it moved, and steps down
to the bus (counted) when the segment is missing, version-gated or
corrupt. The segment carries the bus record line verbatim, so a
segment-applied generation paints the bytes, ETags, 304s and push frames
a bus-applied one does.

The segment also carries each provider's columns already encoded. After
``apply_record`` the consumer seeds them into the worker's own fleet
cache on its card (``DeviceFleetCache.seed``, one upload and no
encode), so the worker's first render of the generation skips
``encode_fleet``'s per-node loop. A seed that raises is counted in
``seed_errors``, named in ``last_seed_error`` and holds ``/healthz``
``ok`` false until a later seed succeeds; the render then encodes as any
cache miss does, and no host column is installed in a card's cache.
"""

from __future__ import annotations

import contextlib
import signal
import threading
from typing import Any, Callable

import torch

from ..device import DeviceLike
from ..obs.trace import span, trace_request, trace_ring
from ..replicate.bus import _BYTES, _ERRORS, parse_payload
from ..replicate.replica import ReplicaApp, set_active_consumer
from .shm import SegmentError, SegmentReader
from .status import WorkerSlot


def _error_name(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"


class ShmConsumer:
    """Pulls generations off the segment into one :class:`ReplicaApp`,
    with the bus as the counted fallback. :meth:`poll_once` is the whole
    protocol (tests call it directly); a worker calls :meth:`start` for a
    poll thread on its card.

    Counted and named, none raised: a segment rung (``attach_failures``,
    ``last_attach_error``), a bus fetch or parse that fails
    (``fallback_failures``, ``last_fetch_error``), a seed that raises
    (``seed_errors``, ``last_seed_error``), and on the poll thread an
    apply that raises (``errors``, ``last_error``). The last two hold
    ``failing`` (the worker's ``/healthz`` reads ``ok`` false) until a
    later seed succeeds or a later record applies."""

    def __init__(
        self,
        app: ReplicaApp,
        segment_path: str,
        *,
        fallback_fetch: Callable[[int], str] | None = None,
        slot: WorkerSlot | None = None,
        interval_s: float = 0.25,
    ) -> None:
        self.app = app
        self.segment_path = segment_path
        self._fallback = fallback_fetch
        self.slot = slot
        self.interval_s = interval_s
        self._reader: SegmentReader | None = None
        self.cursor = 0
        self.polls = 0
        self.applied_shm = 0
        self.applied_fallback = 0
        self.attach_failures = 0
        self.last_attach_error: str | None = None
        self.fallback_failures = 0
        self.last_fetch_error: str | None = None
        self.seeds = 0
        self.seed_errors = 0
        self.last_seed_error: str | None = None
        self._seed_failing = False
        self.errors = 0
        self.last_error: str | None = None
        self._poll_failing = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # The worker's /healthz runtime.replication block reads this.
        app.replication = self
        set_active_consumer(self)

    @property
    def failing(self) -> bool:
        """Whether the last seed raised or the poll thread's last apply
        did: the worker's ``/healthz`` reads ``ok`` false while so."""
        return self._seed_failing or self._poll_failing

    # -- one tick ----------------------------------------------------------

    def poll_once(self) -> int:
        """One tick: read the segment if its generation moved, apply the
        record, seed its columns. A segment rung drops the attachment (the
        next tick re-opens: a new supervisor may have replaced the file)
        and takes the bus. Returns the generations applied. Runs under its
        own ``/workers/poll`` trace (spans ``workers.read``,
        ``replicate.apply``, ``device_cache.seed``), ringed only when it
        applied a generation."""
        self.polls += 1
        with trace_request("/workers/poll", wall=self.app._clock) as trace:
            applied = self._poll()
            if trace is not None and applied:
                trace.finish(route="/workers/poll", status=200, device_gets=0)
                trace_ring.record(trace.to_dict())
        return applied

    def _poll(self) -> int:
        frame = record = None
        try:
            reader = self._reader
            if reader is None:
                reader = self._reader = SegmentReader(self.segment_path)
            if reader.generation() > self.app.snapshot_generation():
                with span("workers.read"):
                    frame = reader.read()
                if frame is not None:
                    record = frame.record()
        except (SegmentError, ValueError) as e:
            # ValueError: a segment that read cleanly around an
            # unparseable record, the same rung as a corrupt one.
            self._attach_failed(e)
            return self._poll_fallback()
        if record is None:
            return 0  # the segment is healthy and holds nothing newer
        generation = int(record.get("generation") or 0)
        applied = self.app.apply_record(record)
        self.cursor = max(self.cursor, generation)
        if not applied:
            return 0
        self.applied_shm += 1
        self._poll_failing = False
        if self.slot is not None:
            self.slot.applied(generation)
        self._seed_columns(frame.columns, generation)
        return 1

    def _attach_failed(self, e: Exception) -> None:
        self._drop_reader()
        self.attach_failures += 1
        self.last_attach_error = _error_name(e)
        if self.slot is not None:
            self.slot.attach_failure()

    def _drop_reader(self) -> None:
        reader, self._reader = self._reader, None
        if reader is not None:
            reader.close()

    def _seed_columns(self, columns: dict[str, Any], generation: int) -> None:
        """Upload the segment's columns into the worker's own fleet cache
        at the version ``decode_snapshot`` stamped (the generation), so
        the first render of it finds them on the card. Every provider the
        applied snapshot has is seeded, Intel included, as JAX's worker
        seeds them: a segment's columns for a provider the snapshot lacks
        are skipped."""
        cache = self.app._ctx.fleet_cache
        providers = self.app._last_snapshot.providers
        columns = {name: fleet for name, fleet in columns.items() if name in providers}
        try:
            for provider, fleet in columns.items():
                cache.seed(provider, generation, fleet)
        except Exception as e:  # noqa: BLE001 — counted, named in /healthz, ok false
            self.seed_errors += 1
            self.last_seed_error = _error_name(e)
            self._seed_failing = True
            _ERRORS.inc(role="worker")
            return
        self.seeds += len(columns)
        self._seed_failing = False

    def _poll_fallback(self) -> int:
        """The bus rung: one pull through the injected fetch (absent where
        the topology has only the segment)."""
        if self._fallback is None:
            return 0
        try:
            payload = self._fallback(self.cursor)
            _, records = parse_payload(payload, origin="<worker-fallback>")
        except Exception as e:  # noqa: BLE001 — a dead leader: counted, stale-honest serving
            self.fallback_failures += 1
            self.last_fetch_error = _error_name(e)
            return 0
        _BYTES.inc(len(payload), role="applied")
        applied = 0
        for record in records:
            generation = int(record.get("generation") or 0)
            if self.app.apply_record(record):
                applied += 1
                self.applied_fallback += 1
                self._poll_failing = False
                if self.slot is not None:
                    self.slot.applied(generation)
                    self.slot.fallback_decode()
            self.cursor = max(self.cursor, generation)
        return applied

    def tick(self) -> int:
        """:meth:`poll_once` with an apply that raises counted in
        ``errors`` and named in ``last_error`` (``failing`` until a record
        applies), the poll thread's body and a worker's first fill."""
        try:
            return self.poll_once()
        except Exception as e:  # noqa: BLE001 — counted, named in /healthz, ok false
            self.errors += 1
            self.last_error = _error_name(e)
            self._poll_failing = True
            _ERRORS.inc(role="worker")
            return 0

    # -- poll thread ---------------------------------------------------------

    def start(self) -> None:
        """Poll on a thread of its own, on the worker's card, every
        ``interval_s`` until :meth:`stop`."""
        if self._thread is not None:
            return
        self._stop.clear()
        index = self.app._cuda_index

        def consume_loop() -> None:
            on_card = torch.cuda.device(index) if index is not None else contextlib.nullcontext()
            with on_card:
                while not self._stop.is_set():
                    self.tick()
                    self._stop.wait(self.interval_s)

        thread = threading.Thread(target=consume_loop, name="hl-torch-shm-consumer", daemon=True)
        self._thread = thread
        thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        """Stop the poll thread, join it and release the segment; raises
        TimeoutError if the thread outlives ``timeout_s``."""
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout_s)
            if thread.is_alive():
                raise TimeoutError(f"the segment consumer outlived {timeout_s} s")
            self._thread = None
        self._drop_reader()

    def snapshot(self) -> dict[str, Any]:
        """The /healthz ``runtime.replication`` block (worker role)."""
        app = self.app
        lag = app.lag_s()
        return {
            "role": "worker",
            "segment_path": self.segment_path,
            "segment_attached": self._reader is not None,
            "cursor": self.cursor,
            "last_generation": app.snapshot_generation(),
            "applied": app.applied,
            "applied_shm": self.applied_shm,
            "applied_fallback": self.applied_fallback,
            "attach_failures": self.attach_failures,
            "last_attach_error": self.last_attach_error,
            "fallback_failures": self.fallback_failures,
            "last_fetch_error": self.last_fetch_error,
            "seeds": self.seeds,
            "seed_errors": self.seed_errors,
            "last_seed_error": self.last_seed_error,
            "errors": self.errors,
            "last_error": self.last_error,
            "rejected_stale": app.rejected_stale,
            "polls": self.polls,
            "stale": app.stale(),
            "lag_s": round(lag, 3) if lag is not None else None,
        }

    def counters(self) -> dict[str, int]:
        """Monotone ints for the flight recorder's deltas."""
        return {
            "applied": self.app.applied,
            "rejected_stale": self.app.rejected_stale,
            "polls": self.polls,
            "applied_shm": self.applied_shm,
            "applied_fallback": self.applied_fallback,
            "attach_failures": self.attach_failures,
            "fallback_failures": self.fallback_failures,
            "seeds": self.seeds,
            "seed_errors": self.seed_errors,
            "errors": self.errors,
        }


class _BoardHealth:
    """/healthz ``runtime.workers``: the whole board, stamped with the
    worker that answered."""

    def __init__(self, board: Any, worker_id: int) -> None:
        self._board = board
        self._worker_id = worker_id

    def snapshot(self) -> dict[str, Any]:
        return self._board.snapshot(self_id=self._worker_id)


def _exit_on_sigterm(signum: int, frame: Any) -> None:
    raise SystemExit(0)


def worker_main(
    worker_id: int,
    host: str,
    port: int,
    *,
    segment_path: str,
    board_path: str,
    fallback_url: str | None = None,
    listen_socket: Any = None,
    device: DeviceLike = None,
) -> None:
    """One serving worker's process entry: a :class:`ReplicaApp` on
    ``device`` (CUDA unless ``"cpu"``), fed by a :class:`ShmConsumer`,
    its slot on the status board, accepting on the shared port (through
    ``listen_socket`` when the supervisor passed one, else with
    ``SO_REUSEPORT``). Every argument pickles: the supervisor starts it
    with the ``spawn`` method. Serves until SIGTERM (the supervisor's
    ``stop``) or SIGINT, then closes the server, which closes the app and
    joins the consumer. A board that cannot be attached raises: the
    supervisor made it before starting the worker."""
    from ..push.hub import set_worker_identity
    from ..replicate.replica import pool_fetch
    from .status import WorkerStatusBoard, register_worker_metrics

    signal.signal(signal.SIGTERM, _exit_on_sigterm)
    board = WorkerStatusBoard.attach(board_path)
    try:
        app = ReplicaApp(device=device)
        slot = board.slot(worker_id)
        register_worker_metrics(board)
        app.workers = _BoardHealth(board, worker_id)
        set_worker_identity(f"w{worker_id}")
        consumer = ShmConsumer(
            app, segment_path, fallback_fetch=pool_fetch(fallback_url) if fallback_url else None,
            slot=slot,
        )
        index = app._cuda_index
        with torch.cuda.device(index) if index is not None else contextlib.nullcontext():
            consumer.tick()  # the first fill, before the socket opens
        consumer.start()
        # The server's close() closes the app, which stops the consumer.
        server = app.serve(
            host, port, reuse_port=listen_socket is None, listen_socket=listen_socket
        )
        try:
            server.wait()
        except (KeyboardInterrupt, SystemExit):
            pass  # the supervisor's stop: closing below is the handling
        finally:
            server.close()
    finally:
        board.close()


__all__ = ["ShmConsumer", "worker_main"]

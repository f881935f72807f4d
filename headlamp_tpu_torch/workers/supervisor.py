"""The supervisor: one leader, N serving worker processes.

The port's copy of ``headlamp_tpu/workers/supervisor.py``. The supervisor
owns the only cluster-facing ``DashboardApp``: it syncs in the background,
publishes each generation through a :class:`SegmentBusPublisher` (the
segment and the bus backlog in one call) and serves the bus on an
internal loopback port, the workers' fallback. The workers never touch
the cluster: each runs :func:`~.worker.worker_main`, a ``ReplicaApp`` on
its own card context fed from the segment, accepting on the public port
through ``SO_REUSEPORT`` or the shared listener.

Workers start with the ``spawn`` method, where JAX forks
(`supervisor.py:103`). CUDA does not survive a fork, and the parent may
already hold a CUDA context (``resolve_device`` initialises CUDA to
find the card, and a caller such as a test or ``chip_smoke.py`` has its
own), so a forked child's first CUDA call could fail. A spawned child
starts a fresh interpreter: ``worker_main`` and its arguments pickle, the shared
listener reaches it as a passed descriptor, and the parent's entry code
must sit under ``if __name__ == "__main__"``.
"""

from __future__ import annotations

import multiprocessing
import os
import signal
import socket
import time
from typing import Any, Callable

from ..device import DeviceLike, resolve_device
from .balancer import pick_strategy, shared_listener
from .shm import SegmentBusPublisher, SnapshotSegment, default_segment_path
from .status import WorkerStatusBoard
from .worker import _exit_on_sigterm, worker_main

#: The supervisor's background sync interval: the heartbeat every
#: worker's feed rides on.
DEFAULT_SYNC_INTERVAL_S = 2.0

#: How workers start: a fresh interpreter each, never a fork of a process
#: that may hold a CUDA context.
START_METHOD = "spawn"

#: Seconds a worker gets to close after SIGTERM before it is killed (its
#: close joins the registry's captures on the card).
STOP_TIMEOUT_S = 30.0


class WorkerSupervisor:
    """Builds the leader app, publishes into the shared-memory plane and
    keeps N worker processes accepting on the public port.

    ``app_factory`` returns the cluster-facing ``DashboardApp`` (a demo
    transport, an apiserver, in-cluster). ``device`` is each worker's
    (CUDA unless ``"cpu"``); the factory places the leader. :meth:`start`
    starts the workers and the sync loop, :meth:`poll` reports liveness,
    :meth:`stop` stops the workers and closes the plane."""

    def __init__(
        self,
        app_factory: Callable[[], Any],
        *,
        host: str = "127.0.0.1",
        port: int = 8632,
        workers: int = 2,
        segment_path: str | None = None,
        board_path: str | None = None,
        sync_interval_s: float = DEFAULT_SYNC_INTERVAL_S,
        strategy: str | None = None,
        device: DeviceLike = None,
    ) -> None:
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self._app_factory = app_factory
        self.host = host
        self.port = int(port)
        self.workers = int(workers)
        self.segment_path = segment_path or default_segment_path(port)
        self.board_path = board_path or default_segment_path(port, kind="wsb")
        self.sync_interval_s = sync_interval_s
        self.strategy = strategy or pick_strategy()
        # Resolved here, before anything starts: without CUDA and without
        # "cpu" the supervisor raises rather than start workers that would.
        self.device = str(resolve_device(device))
        self.app: Any = None
        self.publisher: SegmentBusPublisher | None = None
        self.segment: SnapshotSegment | None = None
        self.board: WorkerStatusBoard | None = None
        self.bus_url: str | None = None
        self._bus_server: Any = None
        self._listener: socket.socket | None = None
        self._procs: list[Any] = []

    def start(self) -> None:
        """Bring the plane up in dependency order: the segment and the
        board (workers attach them at entry), the shared listener where
        the strategy needs one, the workers, then the leader app, its
        internal bus endpoint and the sync loop."""
        self.segment = SnapshotSegment(self.segment_path)
        self.board = WorkerStatusBoard.create(self.board_path, n_slots=self.workers)
        listener = None
        if self.strategy != "reuseport":
            listener = self._listener = shared_listener(self.host, self.port)
        # The bus endpoint's port goes to the workers as their fallback
        # URL, so it is chosen before they start and served once the
        # leader app exists.
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as probe:
            probe.bind((self.host, 0))
            bus_port = probe.getsockname()[1]
        self.bus_url = f"http://{self.host}:{bus_port}"
        ctx = multiprocessing.get_context(START_METHOD)
        for worker_id in range(self.workers):
            proc = ctx.Process(
                target=worker_main,
                args=(worker_id, self.host, self.port),
                kwargs={
                    "segment_path": self.segment_path,
                    "board_path": self.board_path,
                    "fallback_url": self.bus_url,
                    "listen_socket": listener,
                    "device": self.device,
                },
                daemon=True,
                name=f"headlamp-torch-worker-{worker_id}",
            )
            proc.start()
            self._procs.append(proc)
        app = self.app = self._app_factory()
        self.publisher = SegmentBusPublisher(
            self.segment, ledger=app.ledger, note=f"supervisor {self.host}:{self.port}"
        )
        app.replication = self.publisher
        self._bus_server = app.serve(self.host, bus_port)
        app.start_background_sync(self.sync_interval_s)

    def poll(self) -> dict[str, Any]:
        """Liveness and the plane's counters, the supervisor's own view
        (the workers answer /healthz on the public port)."""
        alive = [p.pid for p in self._procs if p.is_alive()]
        out: dict[str, Any] = {
            "strategy": self.strategy,
            "start_method": START_METHOD,
            "workers": self.workers,
            "alive": len(alive),
            "pids": alive,
            "segment_path": self.segment_path,
        }
        if self.publisher is not None:
            out["replication"] = self.publisher.snapshot()
        if self.board is not None:
            out["board"] = self.board.snapshot()
        return out

    def wait(self) -> None:
        """Park the caller until SIGINT or SIGTERM: ``--workers N``'s
        steady state."""
        try:
            while True:
                time.sleep(3600)
        except (KeyboardInterrupt, SystemExit):  # analysis: disable=EXC001
            pass  # the top of the process: stopping is the handling

    def stop(self) -> None:
        """SIGTERM every worker (each closes its server and app), kill one
        that outlives ``STOP_TIMEOUT_S``, join them all, then close the
        leader's server and app (the app alone when its server never
        started), the listener, and the segment and the
        board (their files unlinked)."""
        for proc in self._procs:
            if proc.is_alive():
                proc.terminate()
        for proc in self._procs:
            proc.join(STOP_TIMEOUT_S)
            if proc.is_alive():
                proc.kill()
                proc.join()
        self._procs.clear()
        if self._bus_server is not None:
            self._bus_server.close()  # closes the leader app too
            self._bus_server = None
        elif self.app is not None:
            self.app.close()  # a start that failed before the bus served
        if self._listener is not None:
            self._listener.close()
            self._listener = None
        for part in (self.segment, self.board):
            if part is not None:
                part.close()
                part.unlink()
        self.segment = self.board = None


def run_supervisor(
    app_factory: Callable[[], Any],
    *,
    host: str,
    port: int,
    workers: int,
    sync_interval_s: float = DEFAULT_SYNC_INTERVAL_S,
    device: DeviceLike = None,
) -> None:
    """The ``--workers N`` entry: start, announce, park until SIGINT or
    SIGTERM, stop."""
    signal.signal(signal.SIGTERM, _exit_on_sigterm)
    sup = WorkerSupervisor(
        app_factory, host=host, port=port, workers=workers,
        sync_interval_s=sync_interval_s, device=device,
    )
    try:
        sup.start()
        print(
            f"TPU dashboard supervisor: {workers} workers on http://{host}:{port}/tpu "
            f"({sup.strategy}, {START_METHOD}; device {sup.device}; pid {os.getpid()})",
            flush=True,
        )
        sup.wait()
    finally:
        sup.stop()


__all__ = ["DEFAULT_SYNC_INTERVAL_S", "START_METHOD", "WorkerSupervisor", "run_supervisor"]

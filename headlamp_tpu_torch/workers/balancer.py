"""One port, N accepting processes: the front door.

The port's copy of ``headlamp_tpu/workers/balancer.py``. The ladder:

1. ``SO_REUSEPORT``: each worker binds the same ``(host, port)`` and the
   kernel spreads the accepts (Linux and the BSDs);
2. a shared listener: the supervisor binds one listening socket before it
   starts the workers and hands each a copy (:func:`shared_listener`;
   ``multiprocessing`` passes the descriptor to a spawned child), and the
   kernel wakes one accepter per connection;
3. :class:`RoundRobinBalancer`: a plain round-robin TCP proxy for workers
   that had to bind distinct ports. Never the production default.

To a client all three are one address, and an accepted connection stays
on one worker for its life: an SSE stream is per worker, and a reconnect
that lands elsewhere resumes from that worker's hub by ``Last-Event-ID``
or falls back to a full paint.
"""

from __future__ import annotations

import socket
import threading
from typing import Any


def reuseport_supported() -> bool:
    """Does this host offer ``SO_REUSEPORT``? Probed by setting the option
    on a throwaway socket: the constant can exist where the kernel
    refuses it."""
    if not hasattr(socket, "SO_REUSEPORT"):
        return False
    probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        return True
    except OSError:
        return False
    finally:
        probe.close()


def pick_strategy() -> str:
    """``"reuseport"`` where the kernel offers it, ``"fd-passing"``
    otherwise: the supervisor's default."""
    return "reuseport" if reuseport_supported() else "fd-passing"


def shared_listener(host: str, port: int, *, backlog: int = 128) -> socket.socket:
    """The shared-listener strategy's one socket: bound and listening
    before the workers start, so every worker accepts on its queue."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host, port))
    sock.listen(backlog)
    sock.set_inheritable(True)
    return sock


class RoundRobinBalancer:
    """A minimal round-robin TCP proxy: accept on one port, pin each
    connection to the next backend, pump bytes both ways until either
    side closes, one thread per direction. :meth:`stop` closes the
    listener and joins the accept thread; pump threads end with their
    connections."""

    def __init__(
        self,
        host: str,
        port: int,
        backends: list[tuple[str, int]],
        *,
        backlog: int = 128,
    ) -> None:
        if not backends:
            raise ValueError("balancer needs at least one backend")
        self.backends = list(backends)
        self._next = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.connections = 0
        self.failures = 0
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(backlog)
        self.address = self._sock.getsockname()[:2]

    def pick(self) -> tuple[str, int]:
        with self._lock:
            backend = self.backends[self._next % len(self.backends)]
            self._next += 1
            self.connections += 1
        return backend

    def start(self) -> None:
        if self._threads:
            return
        self._stop.clear()
        self._sock.settimeout(0.2)

        def _pump(src: socket.socket, dst: socket.socket) -> None:
            try:
                while True:
                    chunk = src.recv(65536)
                    if not chunk:
                        break
                    dst.sendall(chunk)
            except OSError:
                pass  # either side closing ends the stream
            finally:
                for s in (src, dst):
                    try:
                        s.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass

        def _accept_loop() -> None:
            while not self._stop.is_set():
                try:
                    client, _addr = self._sock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return  # listener closed: stop()
                host, port = self.pick()
                try:
                    upstream = socket.create_connection((host, port), timeout=5.0)
                except OSError:
                    self.failures += 1
                    client.close()
                    continue
                for pair in ((client, upstream), (upstream, client)):
                    t = threading.Thread(target=_pump, args=pair, daemon=True)
                    t.start()

        accepter = threading.Thread(
            target=_accept_loop, name="hl-torch-balancer", daemon=True
        )
        self._threads.append(accepter)
        accepter.start()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()

    def snapshot(self) -> dict[str, Any]:
        return {
            "backends": [f"{h}:{p}" for h, p in self.backends],
            "connections": self.connections,
            "failures": self.failures,
        }


__all__ = [
    "RoundRobinBalancer",
    "pick_strategy",
    "reuseport_supported",
    "shared_listener",
]

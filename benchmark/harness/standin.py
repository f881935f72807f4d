"""A stand-in apiserver, run in a process of its own.

A frozen copy of the port's ``server/standin.py`` (a threading HTTP/1.1
keep-alive server that closes every kept-alive socket on close), fed not
by a mock transport of the program but by the fleet this benchmark draws
from ``--seed``. It answers what the port's ``KubeTransport`` asks of a
cluster:

- ``/api/v1/nodes`` and ``/api/v1/pods``: paginated LISTs (``limit``,
  ``continue``) stamped with the current resourceVersion, and
  ``watch=true`` requests, answered with the events since the cursor as
  NDJSON (410 Gone for a cursor older than the first), as the port's
  ``WatchFeed`` answers them;
- the TPU device-plugin daemonsets;
- 404 for everything else, as an apiserver answers an absent resource.

The traffic's fleet changes (``benchmark/fleets``) are applied here, at
times the run gives: each flipped host is a MODIFIED event with a new
resourceVersion, and the LIST shows it from then on.

Nothing here imports the program.
"""

from __future__ import annotations

import json
import socket
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any

from ..fleets import FLEETS_DIR, change_hosts, flip_ready, make_fleet

_LIST_PARAMS = frozenset({"limit", "continue", "fieldSelector", "resourceVersion"})
NODES, PODS = "/api/v1/nodes", "/api/v1/pods"
RESOURCE_VERSION = 1000


class Source:
    """The cluster one configuration serves, from a seed, and its changes."""

    def __init__(self, config: dict[str, Any], seed: int,
                 changes: dict[str, Any] | None = None, fleets_dir: Path = FLEETS_DIR) -> None:
        self.fleet = make_fleet(config["fleet"], seed, fleets_dir)
        self.seed = seed
        self.changes = changes or {}
        self.lists = {NODES: list(self.fleet["nodes"]), PODS: list(self.fleet["pods"])}
        self.routes: dict[str, Any] = {
            "/apis/apps/v1/daemonsets?labelSelector=k8s-app%3Dtpu-device-plugin": {
                "kind": "List", "items": self.fleet.get("daemonsets", []),
            },
        }
        self.resource_version = RESOURCE_VERSION
        #: (resourceVersion, event) pairs of the nodes' watch, oldest first.
        self.events: list[tuple[int, bytes]] = []
        self._lock = threading.Lock()

    def apply_change(self, k: int) -> None:
        """Flip the hosts of change ``k``: one MODIFIED event each."""
        with self._lock:
            nodes = self.lists[NODES] = list(self.lists[NODES])
            for i in change_hosts(self.fleet, self.seed, k, int(self.changes["hosts"])):
                self.resource_version += 1
                nodes[i] = flip_ready(nodes[i], self.resource_version)
                event = {"type": "MODIFIED", "object": nodes[i]}
                self.events.append((self.resource_version, (json.dumps(event) + "\n").encode()))

    def respond(self, path: str) -> tuple[int, bytes]:
        parsed = urllib.parse.urlparse(path)
        query = urllib.parse.parse_qs(parsed.query)
        with self._lock:
            items = self.lists.get(parsed.path)
            rv_now, events = self.resource_version, list(self.events)
        if items is not None and query.get("watch", [""])[0] == "true":
            rv = int(query.get("resourceVersion", ["0"])[0] or 0)
            if rv < RESOURCE_VERSION:
                event = {"type": "ERROR", "object": {"kind": "Status", "code": 410,
                                                     "reason": "Expired"}}
                return 200, (json.dumps(event) + "\n").encode()
            if parsed.path != NODES:
                return 200, b""
            return 200, b"".join(body for v, body in events if v > rv)
        if items is not None and not set(query) - _LIST_PARAMS:
            return 200, json.dumps(self._list(items, query, rv_now)).encode()
        if path in self.routes:
            return 200, json.dumps(self.routes[path]).encode()
        return 404, json.dumps({"kind": "Status", "code": 404}).encode()

    @staticmethod
    def _list(items: list[Any], query: dict[str, list[str]], rv: int) -> dict[str, Any]:
        metadata: dict[str, Any] = {"resourceVersion": str(rv)}
        limit = int(query.get("limit", ["0"])[0] or 0)
        if not limit:
            return {"kind": "List", "metadata": metadata, "items": items}
        offset = int(query.get("continue", ["0"])[0] or 0)
        if offset + limit < len(items):
            metadata["continue"] = str(offset + limit)
        return {"kind": "List", "metadata": metadata, "items": items[offset : offset + limit]}


class _Server(ThreadingHTTPServer):
    """Keeps every accepted socket, so close() can cut the kept-alive ones
    its handler threads are parked on."""

    daemon_threads = True

    def __init__(self, source: Source, address: tuple[str, int]) -> None:
        super().__init__(address, _Handler)
        self.source = source
        self.lock = threading.Lock()
        self.sockets: list[socket.socket] = []

    def get_request(self) -> tuple[socket.socket, Any]:
        sock, addr = super().get_request()
        with self.lock:
            self.sockets.append(sock)
        return sock, addr


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: _Server

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        status, body = self.server.source.respond(self.path)
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *_args: Any) -> None:
        pass


class StandIn:
    """``source`` served on 127.0.0.1 (a free port) from a thread, until
    :meth:`close`."""

    def __init__(self, source: Source) -> None:
        self._httpd = _Server(source, ("127.0.0.1", 0))
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="bench-standin")
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def close(self) -> None:
        self._httpd.shutdown()
        self._thread.join()
        with self._httpd.lock:
            sockets, self._httpd.sockets = self._httpd.sockets, []
        for sock in sockets:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            sock.close()
        self._httpd.server_close()


def process_main(config: dict[str, Any], seed: int, changes: dict[str, Any] | None,
                 conn: Any, fleets_dir: Path = FLEETS_DIR) -> None:
    """The stand-in process. Sends its port, then takes commands until
    ``"stop"`` (or the parent going away): ``("change", k)`` applies
    change ``k`` at once and answers when it is served; ``("schedule",
    [(at, k), ...])`` applies each change ``k`` at ``time.monotonic()``
    ``at`` from a thread of its own. At ``"stop"`` it sends back when
    each change was applied, ``{k: monotonic time}``."""
    source = Source(config, seed, changes, fleets_dir)
    server = StandIn(source)
    applied: dict[int, float] = {}
    halt = threading.Event()
    timer: threading.Thread | None = None

    def run_schedule(plan: list[tuple[float, int]]) -> None:
        for at, k in plan:
            if halt.wait(max(at - time.monotonic(), 0.0)):
                return
            source.apply_change(k)
            applied[k] = time.monotonic()

    try:
        conn.send(server.port)
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                break
            if msg == "stop":
                break
            if msg[0] == "change":
                source.apply_change(msg[1])
                applied[msg[1]] = time.monotonic()
                conn.send("applied")
            elif msg[0] == "schedule":
                timer = threading.Thread(target=run_schedule, args=(msg[1],),
                                         name="bench-standin-changes")
                timer.start()
    finally:
        halt.set()
        if timer is not None:
            timer.join()
        server.close()
    try:
        conn.send(applied)
    except (BrokenPipeError, EOFError, OSError):
        pass

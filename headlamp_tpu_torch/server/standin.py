"""A local stand-in apiserver: any transport's answers over real sockets.

``KubeTransport`` needs an apiserver to talk to. This serves the paths of
a source transport (a demo fleet's ``MockTransport``: the node and pod
lists, the plugin chains, the Prometheus service proxy) on a local
HTTP/1.1 keep-alive socket, the way ``kubectl proxy`` serves a real
cluster, so the pooled transport, its fan-out and the host run end to
end without a cluster (JAX's ``bench.py`` ``bench_transport_pool`` does
the same). A ``watch=true`` request answers the source's watch events as
newline-delimited JSON; an ``ApiError`` answers its status.

    python -m headlamp_tpu_torch.server.standin --demo large --port 8001
    python -m headlamp_tpu_torch.server --apiserver http://127.0.0.1:8001 --device cpu

It counts the connections it accepted and the requests it answered (the
server's side of the pool's reuse), and :meth:`StandInApiserver.close`
cuts every kept-alive connection, then joins every thread it started.
"""

from __future__ import annotations

import argparse
import json
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib.parse import parse_qs, urlparse

from ..transport.api_proxy import ApiError, Transport
from .demo import DEMO_FLEETS, make_demo_transport


class _Server(ThreadingHTTPServer):
    """Counts and keeps every accepted socket, so close() can cut the
    kept-alive ones its handler threads are parked on."""

    daemon_threads = True

    def __init__(self, source: Transport, address: tuple[str, int]) -> None:
        super().__init__(address, _Handler)
        self.source = source
        self.lock = threading.Lock()
        self.connects = 0
        self.requests = 0
        self.sockets: list[socket.socket] = []

    def get_request(self) -> tuple[socket.socket, Any]:
        sock, addr = super().get_request()
        with self.lock:
            self.connects += 1
            self.sockets.append(sock)
        return sock, addr


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # keep-alive, as kubectl proxy speaks
    server: _Server

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        source = self.server.source
        with self.server.lock:
            self.server.requests += 1
        watch = parse_qs(urlparse(self.path).query).get("watch", [""])[0] == "true"
        try:
            if watch and hasattr(source, "watch"):
                events = source.watch(self.path)
                body = "".join(json.dumps(e) + "\n" for e in events).encode()
            else:
                body = json.dumps(source.request(self.path)).encode()
            status = 200
        except ApiError as e:
            status = e.status or 502
            body = json.dumps({"kind": "Status", "code": status, "message": str(e)}).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *_args: Any) -> None:
        pass


class StandInApiserver:
    """``source``'s answers on ``(host, port)`` (port 0 picks a free one),
    served from a thread of its own until :meth:`close`."""

    def __init__(self, source: Transport, host: str = "127.0.0.1", port: int = 0) -> None:
        self._httpd = _Server(source, (host, port))
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="hl-torch-standin", daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    @property
    def connects(self) -> int:
        """TCP connections accepted so far."""
        return self._httpd.connects

    @property
    def requests(self) -> int:
        """Requests answered so far."""
        return self._httpd.requests

    def close(self) -> None:
        """Stop accepting, cut the kept-alive connections (their handler
        threads are parked on them) and join every handler thread and
        the serving thread."""
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


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog="headlamp_tpu_torch.server.standin")
    parser.add_argument("--demo", choices=sorted(DEMO_FLEETS), default="v5p32")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8001)
    args = parser.parse_args(argv)
    server = StandInApiserver(make_demo_transport(args.demo), args.host, args.port)
    print(f"stand-in apiserver for demo fleet '{args.demo}' on {server.url}", flush=True)
    try:
        server._thread.join()
    except KeyboardInterrupt:  # analysis: disable=EXC001
        pass  # top of the process: a clean stop is the handling
    finally:
        server.close()


if __name__ == "__main__":
    main()

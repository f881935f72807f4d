"""The operator clients: one load process of its own, speaking HTTP/1.1 like a browser.

The dashboard host runs its Python under one interpreter lock, so a
client in the same process would steal the server's time: the clients
run in one process started with ``spawn``, which imports nothing but this
module and the standard library. Each operator is a thread of that
process with one keep-alive connection; it asks for gzip, follows a
redirect on that connection, and runs its paints in a closed loop from
the window's start until its end: each paint is sent when the last one
has arrived, with no think time, and is timed from its send until its
last byte arrived. The threads wait on their sockets nearly all the
time, so the load takes one core at most and leaves the host's cores to
the host.

The bodies of a few paints, chosen by the run from the seed, are
unzipped and kept in files for the correctness check; every other body
is read and dropped as it came.
"""

from __future__ import annotations

import gzip
import http.client
import os
import resource
import threading
import time
from typing import Any

HEADERS = {"Accept": "text/html", "Accept-Encoding": "gzip", "User-Agent": "portbench-operator"}


class Browser:
    """One keep-alive connection to the host, reopened after an error."""

    def __init__(self, port: int, timeout_s: float = 120.0) -> None:
        self.port = port
        self.timeout_s = timeout_s
        self.conn: http.client.HTTPConnection | None = None

    def get(self, path: str, unzip: bool = True) -> tuple[int, dict[str, str], bytes]:
        """(status, headers, body) of one GET; the body is as it came on
        the wire unless ``unzip``."""
        if self.conn is None:
            self.conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=self.timeout_s)
        try:
            self.conn.request("GET", path, headers=HEADERS)
            resp = self.conn.getresponse()
            body = resp.read()
        except (OSError, http.client.HTTPException):
            self.close()
            return 0, {}, b""
        headers = {k.lower(): v for k, v in resp.getheaders()}
        if unzip and headers.get("content-encoding") == "gzip":
            body = gzip.decompress(body)
            del headers["content-encoding"]
        return resp.status, headers, body

    def paint(self, path: str, follow: bool, unzip: bool = True
              ) -> tuple[int, str, bytes, dict[str, str]]:
        """(final status, final path, body, headers) of one paint."""
        status, headers, body = self.get(path, unzip)
        if follow and status in (301, 302, 303, 307) and "location" in headers:
            path = headers["location"]
            status, headers, body = self.get(path, unzip)
        return status, path, body, headers

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()
            self.conn = None


def _operator(index: int, paints: list[dict[str, Any]], keep: set[int], out_dir: str,
              port: int, start: float, end: float, records: list[tuple[Any, ...]]) -> None:
    """One operator's closed loop: paint from ``start`` until ``end``."""
    kept_routes: set[str] = set()
    browser = Browser(port)
    try:
        while time.monotonic() < start:
            time.sleep(min(0.01, max(start - time.monotonic(), 0.0)))
        i = 0
        while True:
            sent = time.monotonic()
            if sent >= end:
                break
            paint = paints[i % len(paints)]
            status, final, body, headers = browser.paint(paint["path"], paint["follow"],
                                                         unzip=False)
            done = time.monotonic()
            # Stale: the host's ``X-Headlamp-Stale: 1``, a render from
            # caches only.
            records.append((index, i, paint["route"], sent, done, status, len(body),
                            headers.get("x-headlamp-stale") == "1"))
            if status == 200 and (i in keep or paint["route"] not in kept_routes):
                kept_routes.add(paint["route"])
                if headers.get("content-encoding") == "gzip":
                    body = gzip.decompress(body)
                name = os.path.join(out_dir, f"c{index}-p{i}.html.gz")
                with gzip.open(name, "wb", compresslevel=1) as f:
                    f.write(final.encode() + b"\n" + body)
            i += 1
    finally:
        browser.close()


def load_main(operators: list[tuple[list[dict[str, Any]], set[int]]], out_dir: str,
              conn: Any) -> None:
    """The load process. ``operators`` holds each operator's paints and
    the indices of the paints whose bodies it keeps. Waits for ``(port,
    start, end)`` on ``conn`` (the host's port, and ``time.monotonic``
    stamps: one clock for every process of the machine), runs every
    operator's loop on a thread of its own, then sends back one record
    per paint started, ``(operator, paint index, route, sent, done,
    status, bytes on the wire, stale)``, and the CPU seconds the process
    used in the window. The bodies of the paints kept, and of each
    operator's first paint of each route, go to ``out_dir``."""
    conn.send("ready")
    port, start, end = conn.recv()
    cpu0 = resource.getrusage(resource.RUSAGE_SELF)
    records: list[tuple[Any, ...]] = []
    threads = [threading.Thread(target=_operator, name=f"portbench-operator-{i}",
                                args=(i, paints, keep, out_dir, port, start, end, records))
               for i, (paints, keep) in enumerate(operators)]
    try:
        for t in threads:
            t.start()
    finally:
        for t in threads:
            if t.is_alive():
                t.join()
        cpu1 = resource.getrusage(resource.RUSAGE_SELF)
        conn.send((records, (cpu1.ru_utime - cpu0.ru_utime) + (cpu1.ru_stime - cpu0.ru_stime)))
        conn.close()

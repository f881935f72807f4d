"""Record and replay of transport traffic.

The port's copy of ``headlamp_tpu/history/record.py`` (standard library
only). :class:`RecordingTransport` wraps any transport and writes every
``request()`` exchange (path, offset on the injected monotonic clock,
and the parsed JSON response or the :class:`~..transport.api_proxy.ApiError`
it raised) to a versioned JSONL artifact. :class:`ReplaySource` plays an
artifact back as a transport, so everything above the seam (context,
analytics, pages, the host) runs unmodified against recorded traffic.

Determinism: a replay's answers depend only on the artifact, the request
sequence and the injected clock. Two replays of one recording driven by
the same clock return byte-identical responses in the same order.

Two pacing modes:

- **sequential** (``clock=None``): each path keeps a cursor advancing one
  recorded exchange per request and sticking at the last. Independent of
  the caller's timing.
- **timed** (``clock=`` an injected monotonic): a recorded exchange
  becomes visible once ``t_rel <= elapsed * rate``; before that the
  earliest exchange serves. ``rate=3.0`` plays an hour in twenty minutes.

Format (one JSON object per line), the ``headlamp-tpu-recording`` v1
format byte for byte:

    {"v": 1, "kind": "header", "format": "headlamp-tpu-recording",
     "recorded_unix": <float>, "note": <str>}
    {"kind": "request", "t": <float rel-seconds>, "path": <str>,
     "status": "ok", "response": <json>}
    {"kind": "request", "t": ..., "path": ..., "status": "error",
     "error": {"message": <str>, "status": <int|null>}}

Pacing runs on injected monotonic clocks only. The one wall reading
(``recorded_unix``) is provenance through the ``wall`` seam; replay never
reads it. A :class:`ReplaySource` answers ``request`` only (no
``watch``), so a replayed host syncs with imperative LISTs.
"""

from __future__ import annotations

import io
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, TextIO

from ..transport.api_proxy import ApiError

RECORDING_VERSION = 1
RECORDING_FORMAT = "headlamp-tpu-recording"


@dataclass(frozen=True)
class Exchange:
    """One recorded request/response pair. ``response`` is the parsed
    JSON on success; ``error`` is ``(message, status)`` on failure."""

    t_rel: float
    path: str
    response: Any = None
    error: tuple[str, int | None] | None = None


@dataclass
class Recording:
    """A parsed artifact: header metadata plus exchanges in wire order."""

    version: int
    recorded_unix: float
    note: str
    exchanges: list[Exchange] = field(default_factory=list)

    @property
    def span_s(self) -> float:
        return self.exchanges[-1].t_rel if self.exchanges else 0.0

    def paths(self) -> list[str]:
        seen: dict[str, None] = {}
        for ex in self.exchanges:
            seen.setdefault(ex.path, None)
        return list(seen)


class Recorder:
    """Serializes exchanges to JSONL. Thread-safe (request threads may
    fetch concurrently); offsets are relative to the first write on the
    INJECTED monotonic, so artifacts are machine-portable and immune to
    wall steps mid-recording."""

    def __init__(
        self,
        sink: TextIO,
        *,
        monotonic: Callable[[], float] | None = None,
        wall: Callable[[], float] = time.time,
        note: str = "",
    ) -> None:
        self._sink = sink
        self._monotonic = monotonic or time.monotonic
        self._lock = threading.Lock()
        self._t0: float | None = None
        self.exchanges = 0
        header = {
            "v": RECORDING_VERSION,
            "kind": "header",
            "format": RECORDING_FORMAT,
            "recorded_unix": wall(),
            "note": note,
        }
        self._sink.write(json.dumps(header, sort_keys=True) + "\n")

    def _t_rel(self) -> float:
        now = self._monotonic()
        if self._t0 is None:
            self._t0 = now
        return round(now - self._t0, 6)

    def record_ok(self, path: str, response: Any) -> None:
        with self._lock:
            line = json.dumps(
                {
                    "kind": "request",
                    "t": self._t_rel(),
                    "path": path,
                    "status": "ok",
                    "response": response,
                },
                sort_keys=True,
            )
            self._sink.write(line + "\n")
            self.exchanges += 1

    def record_error(
        self, path: str, message: str, status: int | None
    ) -> None:
        with self._lock:
            line = json.dumps(
                {
                    "kind": "request",
                    "t": self._t_rel(),
                    "path": path,
                    "status": "error",
                    "error": {"message": message, "status": status},
                },
                sort_keys=True,
            )
            self._sink.write(line + "\n")
            self.exchanges += 1


class RecordingTransport:
    """Transport decorator: pass traffic through ``inner`` verbatim,
    teeing every exchange (including failures) into ``recorder``.
    Transparent to callers — same responses, same exceptions."""

    def __init__(self, inner: Any, recorder: Recorder) -> None:
        self.inner = inner
        self.recorder = recorder

    def request(self, path: str, timeout_s: float = 2.0) -> Any:
        try:
            response = self.inner.request(path, timeout_s)
        except ApiError as err:
            # str(err) is "path: message"; strip the prefix we re-add
            # at replay so the round trip is exact.
            message = str(err)
            if message.startswith(path + ": "):
                message = message[len(path) + 2 :]
            self.recorder.record_error(path, message, err.status)
            raise
        self.recorder.record_ok(path, response)
        return response


def load_recording(path: str) -> Recording:
    """Parse a JSONL artifact, enforcing the version gate."""
    with io.open(path, "r", encoding="utf-8") as fh:
        return _parse_recording(fh, origin=path)


def _parse_recording(fh: Any, *, origin: str = "<stream>") -> Recording:
    first = fh.readline()
    if not first.strip():
        raise ValueError(f"{origin}: empty recording")
    header = json.loads(first)
    if (
        header.get("kind") != "header"
        or header.get("format") != RECORDING_FORMAT
    ):
        raise ValueError(f"{origin}: not a {RECORDING_FORMAT} artifact")
    version = header.get("v")
    if version != RECORDING_VERSION:
        raise ValueError(
            f"{origin}: recording version {version!r} not supported "
            f"(this build reads v{RECORDING_VERSION})"
        )
    rec = Recording(
        version=version,
        recorded_unix=float(header.get("recorded_unix", 0.0)),
        note=str(header.get("note", "")),
    )
    for lineno, line in enumerate(fh, start=2):
        if not line.strip():
            continue
        entry = json.loads(line)
        if entry.get("kind") != "request":
            continue  # forward-compat: unknown kinds skipped, not fatal
        if entry.get("status") == "error":
            err = entry.get("error") or {}
            rec.exchanges.append(
                Exchange(
                    t_rel=float(entry["t"]),
                    path=entry["path"],
                    error=(str(err.get("message", "")), err.get("status")),
                )
            )
        else:
            rec.exchanges.append(
                Exchange(
                    t_rel=float(entry["t"]),
                    path=entry["path"],
                    response=entry.get("response"),
                )
            )
    return rec


class ReplaySource:
    """A Transport that answers from a :class:`Recording`.

    Recorded errors re-raise as :class:`ApiError` with the recorded
    message/status; a path the recording never saw raises ApiError 404
    (the same shape an apiserver gives for an absent resource), so a
    replay run can never silently invent data.
    """

    def __init__(
        self,
        recording: Recording,
        *,
        clock: Callable[[], float] | None = None,
        rate: float = 1.0,
    ) -> None:
        if rate <= 0:
            raise ValueError("rate must be > 0")
        self.recording = recording
        self.rate = rate
        self._clock = clock  # injected monotonic; None → sequential mode
        self._t0: float | None = None
        self._lock = threading.Lock()
        self._by_path: dict[str, list[Exchange]] = {}
        for ex in recording.exchanges:
            self._by_path.setdefault(ex.path, []).append(ex)
        self._cursor: dict[str, int] = {}
        self.requests_served = 0
        self.requests_unknown = 0

    def _elapsed(self) -> float:
        now = self._clock()  # type: ignore[misc] — timed mode only
        if self._t0 is None:
            self._t0 = now
        return (now - self._t0) * self.rate

    def _pick(self, entries: list[Exchange], path: str) -> Exchange:
        if self._clock is None:
            # Sequential mode: recorded order per path, stick at last.
            i = self._cursor.get(path, 0)
            self._cursor[path] = min(i + 1, len(entries) - 1)
            return entries[i]
        # Timed mode: newest exchange whose offset has elapsed.
        horizon = self._elapsed()
        chosen = entries[0]
        for ex in entries:
            if ex.t_rel <= horizon:
                chosen = ex
            else:
                break
        return chosen

    def request(self, path: str, timeout_s: float = 2.0) -> Any:
        with self._lock:
            entries = self._by_path.get(path)
            if not entries:
                self.requests_unknown += 1
                raise ApiError(path, "not present in recording", 404)
            ex = self._pick(entries, path)
            self.requests_served += 1
        if ex.error is not None:
            raise ApiError(path, ex.error[0], ex.error[1])
        # Deep-copy via the JSON round trip: replayed responses must be
        # as mutation-isolated as freshly parsed wire responses.
        return json.loads(json.dumps(ex.response))

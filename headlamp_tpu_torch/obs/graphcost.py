"""Graph cost ledger: which device programs ran as captured CUDA graphs.

The port's counterpart of ``headlamp_tpu/obs/jaxcost.py``. JAX's ledger
sorts every jitted call into a compile (the first call of a ``(program,
signature)`` pair) or a warm dispatch. The port compiles nothing at run
time; what it pays once per bucket is the capture of a CUDA graph
(``models/aot.py``). So :func:`track` sorts each call into one of three
kinds:

- a **capture**, the first time a ``(program, signature)`` pair is seen,
  with the phase it was paid in: ``"startup"`` for the registry's
  startup pass and its background backfills, ``"request"`` otherwise;
- a **replay** of a graph captured before;
- an **eager** run (:func:`eager`): the program's torch ops launched one
  by one, which is what a bucket miss runs, and every run before the
  registry is ready.

A caller whose device work runs through other programs (the SLO burn
self-forecast, whose fit is a registry program) gets a row of its own
with :func:`covering`: a call counts as a replay when everything it ran
inside replayed, else as an eager run.

:meth:`GraphCostLedger.request_captures` is the number that must stay 0
once the registry is ready: a request never pays a capture. Device-to-
host bytes dual-account with ``runtime.transfer``'s ``blocking_gets``:
the funnel's counted copy calls :func:`note_transfer`.

Surfaces: the ``headlamp_tpu_torch_graph_*`` families on ``/metricsz``,
the ``runtime.graphs`` block of ``/healthz`` (:meth:`snapshot`).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Iterator

from .metrics import registry as _registry

_CAPTURES = _registry.counter(
    "headlamp_tpu_torch_graph_captures_total",
    "CUDA graph captures per program: a (program, signature) pair seen for "
    "the first time paid warm-up and capture, not just a replay.",
    labels=("program",),
)
_STARTUP_CAPTURES = _registry.counter(
    "headlamp_tpu_torch_graph_startup_captures_total",
    "Captures paid by the program registry's startup pass and backfills: the "
    "complement of request-path captures, which stay zero once it is ready.",
    labels=("program",),
)
_REPLAYS = _registry.counter(
    "headlamp_tpu_torch_graph_replays_total",
    "Replays per program of a graph captured before.",
    labels=("program",),
)
_EAGER = _registry.counter(
    "headlamp_tpu_torch_graph_eager_runs_total",
    "Runs of a program as eager torch ops: bucket misses, and every run before "
    "the registry is ready.",
    labels=("program",),
)
_CAPTURE_SECONDS = _registry.histogram(
    "headlamp_tpu_torch_graph_capture_seconds",
    "Wall-clock cost of a capture per program (warm-up runs included).",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
    labels=("program",),
)
_TRANSFER_BYTES = _registry.counter(
    "headlamp_tpu_torch_graph_transfer_bytes_total",
    "Device-to-host payload bytes through the counted transfer funnel, "
    "dual-accounting with headlamp_tpu_torch_transfer_blocking_gets_total "
    "(copy waves there, bytes here).",
    labels=("direction",),
)


def _row() -> dict[str, Any]:
    return {
        "captures": 0, "startup_captures": 0, "replays": 0, "eager": 0,
        "capture_s": 0.0, "replay_s": 0.0, "eager_s": 0.0, "signatures": 0,
    }


class GraphCostLedger:
    """Per-process capture / replay / eager / transfer accounting.
    Thread-safe; every serving thread shares one instance. ``perf`` is
    the injectable duration seam (tests script it)."""

    def __init__(self, *, perf: Callable[[], float] = time.perf_counter) -> None:
        self._perf = perf
        self._lock = threading.Lock()
        self._seen: set[tuple[str, Any]] = set()
        self._programs: dict[str, dict[str, Any]] = {}
        #: Per-thread [replays, eager runs], read by covering().
        self._local = threading.local()
        self.captures = 0
        self.startup_captures = 0
        self.replays = 0
        self.eager_runs = 0
        self.transfers = 0
        self.transfer_bytes = 0

    @contextmanager
    def track(
        self, program: str, signature: Any = None, *, phase: str = "request"
    ) -> Iterator[None]:
        """Wrap one capture or replay of ``program`` at ``signature``
        (the registry's key). The first successful call of a pair is a
        capture, paid in ``phase``; every later one a replay. A raising
        call records nothing."""
        t0 = self._perf()
        yield
        elapsed = self._perf() - t0
        key = (program, signature)
        startup = phase == "startup"
        with self._lock:
            first = key not in self._seen
            self._seen.add(key)
            row = self._programs.setdefault(program, _row())
            if first:
                row["captures"] += 1
                row["capture_s"] += elapsed
                row["signatures"] += 1
                self.captures += 1
                if startup:
                    row["startup_captures"] += 1
                    self.startup_captures += 1
            else:
                row["replays"] += 1
                row["replay_s"] += elapsed
                self.replays += 1
        if not first:
            self._thread_counts()[0] += 1
        if first:
            _CAPTURES.inc(program=program)
            if startup:
                _STARTUP_CAPTURES.inc(program=program)
            _CAPTURE_SECONDS.observe(elapsed, program=program)
        else:
            _REPLAYS.inc(program=program)

    @contextmanager
    def eager(self, program: str) -> Iterator[None]:
        """Wrap one eager run of ``program``. A raising run records
        nothing."""
        t0 = self._perf()
        yield
        elapsed = self._perf() - t0
        self._record_eager(program, elapsed)
        self._thread_counts()[1] += 1

    def _record_eager(self, program: str, elapsed: float) -> None:
        with self._lock:
            row = self._programs.setdefault(program, _row())
            row["eager"] += 1
            row["eager_s"] += elapsed
            self.eager_runs += 1
        _EAGER.inc(program=program)

    def _thread_counts(self) -> list[int]:
        counts = getattr(self._local, "counts", None)
        if counts is None:
            counts = self._local.counts = [0, 0]
        return counts

    @contextmanager
    def covering(self, program: str) -> Iterator[None]:
        """Wrap one call whose device work runs through other programs on
        this thread. It counts as a replay of ``program`` when it ran at
        least one replay and no eager run, else as an eager run. A
        raising call records nothing."""
        counts = self._thread_counts()
        replays0, eager0 = counts
        t0 = self._perf()
        yield
        elapsed = self._perf() - t0
        if counts[0] > replays0 and counts[1] == eager0:
            with self._lock:
                row = self._programs.setdefault(program, _row())
                row["replays"] += 1
                row["replay_s"] += elapsed
                self.replays += 1
            _REPLAYS.inc(program=program)
        else:
            self._record_eager(program, elapsed)

    def request_captures(self) -> int:
        """Captures paid outside the startup phase: 0 once the registry is
        ready, on every path the registry covers."""
        return self.captures - self.startup_captures

    def note_transfer(self, n_bytes: int, *, direction: str = "d2h") -> None:
        """Account one funnel copy's payload (``runtime.transfer``)."""
        n_bytes = int(n_bytes)
        with self._lock:
            self.transfers += 1
            self.transfer_bytes += n_bytes
        if n_bytes > 0:
            _TRANSFER_BYTES.inc(n_bytes, direction=direction)

    def counters(self) -> dict[str, int]:
        """Monotone ints, lock-free."""
        return {
            "captures": self.captures,
            "startup_captures": self.startup_captures,
            "request_captures": self.request_captures(),
            "replays": self.replays,
            "eager_runs": self.eager_runs,
            "transfers": self.transfers,
            "transfer_bytes": self.transfer_bytes,
        }

    def snapshot(self) -> dict[str, Any]:
        """The ``/healthz`` ``runtime.graphs`` block: the totals and a
        table per program (counts and cumulative milliseconds per kind,
        distinct signatures captured)."""
        with self._lock:
            programs = {
                name: {
                    "captures": row["captures"],
                    "startup_captures": row["startup_captures"],
                    "replays": row["replays"],
                    "eager": row["eager"],
                    "capture_ms": round(row["capture_s"] * 1000.0, 1),
                    "replay_ms": round(row["replay_s"] * 1000.0, 1),
                    "eager_ms": round(row["eager_s"] * 1000.0, 1),
                    "signatures": row["signatures"],
                }
                for name, row in sorted(self._programs.items())
            }
        return {**self.counters(), "programs": programs}


#: The process ledger; set_ledger swaps it for tests and the module-level
#: wrappers read through the accessor.
_LEDGER = GraphCostLedger()


def ledger() -> GraphCostLedger:
    return _LEDGER


def set_ledger(instance: GraphCostLedger) -> GraphCostLedger:
    """Install ``instance`` as the process ledger; returns the one it
    replaced so tests can restore."""
    global _LEDGER
    previous, _LEDGER = _LEDGER, instance
    return previous


@contextmanager
def track(program: str, signature: Any = None, *, phase: str = "request") -> Iterator[None]:
    """:meth:`GraphCostLedger.track` against the live ledger."""
    with _LEDGER.track(program, signature, phase=phase):
        yield


@contextmanager
def eager(program: str) -> Iterator[None]:
    """:meth:`GraphCostLedger.eager` against the live ledger."""
    with _LEDGER.eager(program):
        yield


@contextmanager
def covering(program: str) -> Iterator[None]:
    """:meth:`GraphCostLedger.covering` against the live ledger."""
    with _LEDGER.covering(program):
        yield


def note_transfer(n_bytes: int, *, direction: str = "d2h") -> None:
    """:meth:`GraphCostLedger.note_transfer` against the live ledger."""
    _LEDGER.note_transfer(n_bytes, direction=direction)

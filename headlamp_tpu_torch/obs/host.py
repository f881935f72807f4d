"""The host process's own costs as ``/metricsz`` counters: the
interpreter's garbage collections and the process's CPU.

:func:`install` registers, once per process (a second app's call is a
no-op), one ``gc.callbacks`` entry and three counter families:

- ``headlamp_tpu_torch_gc_collections_total{generation}`` and
  ``headlamp_tpu_torch_gc_pause_seconds_total{generation}``: every
  collection and the ``perf_counter`` seconds it held the interpreter,
  by generation, all three generations sampled from registration on;
- ``headlamp_tpu_torch_process_cpu_seconds_total``: user plus system
  CPU of the whole process (``getrusage``), read at scrape.

With tracing on, a full collection (generation 2) also adds its pause
to the innermost open span of the thread that paid it, as the span
attributes ``gc_full_ms`` and ``gc_full`` (a count): a slow stage's
trace then says how much of it was the collector. Young and middle
collections stay counters only: they land in nearly every request,
and a span attribute per one would make span trees vary run to run.

The callback runs on whichever thread triggered the collection, with
the interpreter held, so no two calls overlap and the counters need no
lock.
"""

from __future__ import annotations

import gc
import resource
import threading
import time
from typing import Any

from . import trace
from .metrics import registry

GC_COLLECTIONS = "headlamp_tpu_torch_gc_collections_total"
GC_PAUSE = "headlamp_tpu_torch_gc_pause_seconds_total"
PROCESS_CPU = "headlamp_tpu_torch_process_cpu_seconds_total"

_counts = [0, 0, 0]
_pause_s = [0.0, 0.0, 0.0]
_started = 0.0
_install_lock = threading.Lock()
_installed = False


def _on_gc(phase: str, info: dict[str, Any]) -> None:
    global _started
    if phase == "start":
        _started = time.perf_counter()
        return
    paused = time.perf_counter() - _started
    generation = info["generation"]
    _counts[generation] += 1
    _pause_s[generation] += paused
    if generation == 2 and trace.tracing_enabled():
        node = trace.open_span()
        if node is not None:
            attrs = node.attrs
            attrs["gc_full_ms"] = round(attrs.get("gc_full_ms", 0.0) + paused * 1000, 3)
            attrs["gc_full"] = attrs.get("gc_full", 0) + 1


def process_cpu_s() -> float:
    """User plus system CPU seconds of this process, all threads."""
    usage = resource.getrusage(resource.RUSAGE_SELF)
    return usage.ru_utime + usage.ru_stime


def gc_counts() -> tuple[int, ...]:
    """Collections so far per generation, since :func:`install`."""
    return tuple(_counts)


def gc_pause_s() -> tuple[float, ...]:
    """Seconds the collector held the interpreter per generation."""
    return tuple(_pause_s)


def install() -> None:
    """Hook the collector and register the three families. Idempotent."""
    global _installed
    with _install_lock:
        if _installed:
            return
        registry.counter_samples_fn(
            GC_COLLECTIONS, "Garbage collections of the host process, by generation.",
            ("generation",), lambda: [((g,), n) for g, n in enumerate(gc_counts())],
        )
        registry.counter_samples_fn(
            GC_PAUSE,
            "Seconds the host process's garbage collector held the interpreter, by generation.",
            ("generation",), lambda: [((g,), s) for g, s in enumerate(gc_pause_s())],
        )
        registry.counter_samples_fn(
            PROCESS_CPU, "User and system CPU seconds of the host process.",
            (), lambda: [((), process_cpu_s())],
        )
        gc.callbacks.append(_on_gc)
        _installed = True

"""Bounded sampling wall-clock profiler: where the host's Python time goes.

The port's copy of ``headlamp_tpu/obs/profiler.py``. A sampler walks
``sys._current_frames()`` and interns each thread's stack into a bounded
call tree, so ``/debug/profilez`` answers without per-call
instrumentation:

- **Injected-clock scheduling**: whether a sample is due is decided on
  an injected monotonic clock in :meth:`SamplingProfiler.tick`, so tests
  script the cadence. Only the sample's own cost reads ``perf_counter``.
- **Bounded**: the tree never grows past ``max_nodes``; a stack that
  would collapses into its parent's ``(other)`` bucket and is counted.
  Walks stop at ``max_depth`` frames.
- **Attribution**: the sampler thread cannot read a request thread's
  ContextVars, so a request thread publishes its route and trace id on
  entry (:func:`attribution`, entered by ``DashboardApp.handle``) and
  each sampled stack is rooted at its thread's route.
- **Low rate, bursts on demand**: about 7 Hz always, about 97 Hz for a
  bounded window after ``GET /debug/profilez?burst=SECONDS``.

A sampler sees time, not calls; code shorter than one period between
samples is invisible; and work on the card charges its wait to the
Python frame that blocks on it (the graph cost ledger,
``obs/graphcost.py``, tells which program ran).
"""

from __future__ import annotations

import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Iterator, Mapping

from .metrics import registry as _registry
from .trace import current_trace_id

#: Always-on rate: slow and off any round period, so it cannot alias
#: with a 100 ms poller.
PROFILER_IDLE_HZ = 7.0
#: Burst rate, prime for the same reason.
PROFILER_BURST_HZ = 97.0
#: Longest burst one request may ask for.
PROFILER_MAX_BURST_S = 60.0
#: Call-tree bound; past it new stacks collapse into ``(other)``.
PROFILER_MAX_NODES = 2048
#: Deepest stack interned; a deeper walk keeps the leaf-most frames.
PROFILER_MAX_DEPTH = 64
#: Per-sample overhead budget (one frame walk over every live thread).
PROFILER_SAMPLE_BUDGET_NS = 500_000

#: Root segment of stacks on threads that published no route.
UNATTRIBUTED = "(untracked)"
#: The per-parent collapse bucket once the tree is full.
OTHER_FRAME = "(other)"

#: Thread ident → (route, trace_id), written only by the owning thread
#: (on entry and exit) and read by the sampler; a race puts one stack on
#: the previous route.
_THREAD_ROUTES: dict[int, tuple[str, str | None]] = {}


@contextmanager
def attribution(route: str) -> Iterator[None]:
    """Publish the calling thread's route and active trace id for the
    sampler. Entered inside the request's trace scope, so the trace id
    resolves on the thread that owns it."""
    ident = threading.get_ident()
    prev = _THREAD_ROUTES.get(ident)
    _THREAD_ROUTES[ident] = (route, current_trace_id())
    try:
        yield
    finally:
        if prev is None:
            _THREAD_ROUTES.pop(ident, None)
        else:
            _THREAD_ROUTES[ident] = prev


def _frame_key(frame: Any) -> str:
    """``func (path:line)``, the path cut to its tail inside the repo, so
    folded output compares across machines."""
    code = frame.f_code
    filename = code.co_filename.replace("\\", "/")
    for marker in ("/headlamp_tpu_torch/", "/headlamp_tpu/", "/tests/"):
        idx = filename.rfind(marker)
        if idx >= 0:
            filename = filename[idx + 1:]
            break
    else:
        filename = filename.rsplit("/", 1)[-1]
    return f"{code.co_name} ({filename}:{code.co_firstlineno})"


class _Node:
    """One interned call-tree position: ``self_samples`` stacks ended
    here, ``total_samples`` passed through."""

    __slots__ = ("key", "self_samples", "total_samples", "children")

    def __init__(self, key: str) -> None:
        self.key = key
        self.self_samples = 0
        self.total_samples = 0
        self.children: dict[str, _Node] = {}

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.key,
            "self": self.self_samples,
            "total": self.total_samples,
            "children": [
                c.to_dict() for c in sorted(self.children.values(), key=lambda n: -n.total_samples)
            ],
        }


class _CallTree:
    """Interned, bounded call tree. ``node_count`` excludes the root;
    at ``max_nodes`` new positions collapse into one ``(other)`` bucket
    per parent, so the hard ceiling is twice ``max_nodes``."""

    def __init__(self, max_nodes: int) -> None:
        self.max_nodes = max_nodes
        self.root = _Node("(root)")
        self.node_count = 0

    def intern(self, path: tuple[str, ...]) -> bool:
        """Add one root→leaf stack; True when part of it collapsed."""
        node = self.root
        node.total_samples += 1
        collapsed = False
        for key in path:
            child = node.children.get(key)
            if child is None:
                if self.node_count >= self.max_nodes:
                    child = node.children.get(OTHER_FRAME)
                    if child is None:
                        child = node.children[OTHER_FRAME] = _Node(OTHER_FRAME)
                        self.node_count += 1
                    child.total_samples += 1
                    collapsed = True
                    node = child
                    break  # (other) is terminal: the tail collapses into it
                child = node.children[key] = _Node(key)
                self.node_count += 1
            child.total_samples += 1
            node = child
        node.self_samples += 1
        return collapsed

    def fold(self) -> list[str]:
        """Flamegraph folded-stack lines ``seg;seg;... count``, one per
        position with self samples."""
        lines: list[str] = []

        def walk(node: _Node, prefix: str) -> None:
            path = f"{prefix};{node.key}" if prefix else node.key
            if node.self_samples:
                lines.append(f"{path} {node.self_samples}")
            for child in sorted(node.children.values(), key=lambda n: n.key):
                walk(child, path)

        for child in sorted(self.root.children.values(), key=lambda n: n.key):
            walk(child, "")
        return lines


class SamplingProfiler:
    """The sampler. Tests drive :meth:`tick` on a scripted clock and feed
    :meth:`sample_once` duck-typed frames; the host's ``serve()`` starts
    the thread (:meth:`start`) and its ``close()`` stops and joins it
    (:meth:`stop`). Building an app never starts it."""

    def __init__(
        self,
        *,
        monotonic: Callable[[], float] = time.monotonic,
        idle_hz: float = PROFILER_IDLE_HZ,
        burst_hz: float = PROFILER_BURST_HZ,
        max_nodes: int = PROFILER_MAX_NODES,
        max_depth: int = PROFILER_MAX_DEPTH,
    ) -> None:
        self._monotonic = monotonic
        self.idle_interval_s = 1.0 / idle_hz
        self.burst_interval_s = 1.0 / burst_hz
        self.max_depth = max_depth
        self._lock = threading.Lock()
        self._tree = _CallTree(max_nodes)
        self._next_due = float("-inf")  # the first tick samples
        self._burst_until = float("-inf")
        self._routes: dict[str, dict[str, Any]] = {}
        # Monotone ints: the flight recorder's counter view.
        self.samples = 0
        self.stacks = 0
        self.collapsed_stacks = 0
        self.last_thread_count = 0
        self._overhead_ns_total = 0
        #: The sampling thread, its stop event, and the servers holding it.
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._thread_lock = threading.Lock()
        self._users = 0

    # -- scheduling (injected clock) --------------------------------------

    def interval_s(self, now: float | None = None) -> float:
        now = self._monotonic() if now is None else now
        return self.burst_interval_s if now < self._burst_until else self.idle_interval_s

    def bursting(self) -> bool:
        return self._monotonic() < self._burst_until

    def burst(self, seconds: float) -> float:
        """Sample at ``burst_hz`` for ``seconds`` (clamped to
        ``PROFILER_MAX_BURST_S``); returns the granted window."""
        granted = max(0.0, min(float(seconds), PROFILER_MAX_BURST_S))
        self._burst_until = self._monotonic() + granted
        return granted

    def tick(self) -> bool:
        """Sample iff a period has passed on the injected clock."""
        now = self._monotonic()
        if now < self._next_due:
            return False
        self.sample_once()
        self._next_due = now + self.interval_s(now)
        return True

    # -- sampling -----------------------------------------------------------

    def sample_once(self, frames: Mapping[int, Any] | None = None) -> int:
        """Intern one frame snapshot (``sys._current_frames()`` unless
        ``frames`` is given) into the call tree, skipping the calling
        thread and the sampler's own. Returns the stacks interned. The
        sample's own cost goes to the history store's
        ``profiler.sample_overhead_ns`` series, through its timing gate."""
        t0 = time.perf_counter()
        if frames is None:
            frames = sys._current_frames()
        me = threading.get_ident()
        own = self._thread.ident if self._thread is not None else None
        interned = 0
        routes: list[str] = []
        with self._lock:
            for ident, frame in frames.items():
                if ident == me or ident == own:
                    continue
                keys: list[str] = []
                f = frame
                while f is not None and len(keys) < self.max_depth:
                    keys.append(_frame_key(f))
                    f = f.f_back
                if not keys:
                    continue
                keys.reverse()  # root→leaf
                route, trace_id = _THREAD_ROUTES.get(ident, (UNATTRIBUTED, None))
                if self._tree.intern((route, *keys)):
                    self.collapsed_stacks += 1
                    _COLLAPSED_TOTAL.inc()
                interned += 1
                row = self._routes.setdefault(route, {"stacks": 0, "last_trace_id": None})
                row["stacks"] += 1
                if trace_id is not None:
                    row["last_trace_id"] = trace_id
                routes.append(route)
            self.samples += 1
            self.stacks += interned
            self.last_thread_count = interned
        for route in routes:
            _STACKS_TOTAL.inc(route=route)
        _SAMPLES_TOTAL.inc()
        overhead_ns = int((time.perf_counter() - t0) * 1e9)
        self._overhead_ns_total += overhead_ns
        store = _history_store()
        if store is not None:
            store.record_timing("profiler.sample_overhead_ns", float(overhead_ns))
        return interned

    # -- the sampling thread --------------------------------------------------

    def start(self) -> None:
        """Hold the sampling thread, starting it if it is not running."""
        with self._thread_lock:
            self._users += 1
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, name="hl-torch-profiler", daemon=True)
            self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> bool:
        """Release one :meth:`start`; the last release stops the thread
        and joins it. False if it outlived ``timeout_s``."""
        with self._thread_lock:
            self._users = max(self._users - 1, 0)
            if self._users:
                return True
            thread = self._thread
            self._stop.set()
        if thread is not None:
            thread.join(timeout_s)
            if thread.is_alive():
                return False
        with self._thread_lock:
            if self._thread is thread:
                self._thread = None
        return True

    def _run(self) -> None:
        # The poll period bounds how fast a burst takes effect; whether a
        # sample is due is tick()'s decision on the injected clock.
        while not self._stop.wait(self.burst_interval_s):
            self.tick()

    # -- read surfaces ----------------------------------------------------------

    def running(self) -> bool:
        thread = self._thread
        return thread is not None and thread.is_alive()

    def overhead_ns_per_sample(self) -> float | None:
        if not self.samples:
            return None
        return self._overhead_ns_total / self.samples

    def node_count(self) -> int:
        return self._tree.node_count

    def folded(self) -> str:
        """``/debug/profilez/folded``: folded-stack text, newline
        terminated, empty before any sample."""
        with self._lock:
            lines = self._tree.fold()
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict[str, Any]:
        """``/debug/profilez``."""
        with self._lock:
            tree = self._tree.root.to_dict()
            routes = {route: dict(row) for route, row in sorted(self._routes.items())}
        overhead = self.overhead_ns_per_sample()
        return {
            "samples": self.samples,
            "stacks": self.stacks,
            "collapsed_stacks": self.collapsed_stacks,
            "nodes": self.node_count(),
            "max_nodes": self._tree.max_nodes,
            "last_thread_count": self.last_thread_count,
            "running": self.running(),
            "bursting": self.bursting(),
            "interval_s": round(self.interval_s(), 4),
            "overhead_ns_per_sample": round(overhead, 1) if overhead is not None else None,
            "overhead_budget_ns": PROFILER_SAMPLE_BUDGET_NS,
            "routes": routes,
            "tree": tree,
        }

    def counters(self) -> dict[str, int]:
        """Monotone ints, lock-free: the flight recorder's delta view."""
        return {
            "samples": self.samples,
            "stacks": self.stacks,
            "collapsed_stacks": self.collapsed_stacks,
        }


def _history_store() -> Any | None:
    """The active history store (imported here: the history package
    imports obs)."""
    from ..history.store import active_store

    return active_store()


_SAMPLES_TOTAL = _registry.counter(
    "headlamp_tpu_torch_profiler_samples_total",
    "Sampler wake-ups that walked the process frame snapshot.",
)
_STACKS_TOTAL = _registry.counter(
    "headlamp_tpu_torch_profiler_stacks_total",
    "Thread stacks interned into the profiler call tree, by the route the "
    "owning thread published.",
    labels=("route",),
)
_COLLAPSED_TOTAL = _registry.counter(
    "headlamp_tpu_torch_profiler_collapsed_stacks_total",
    "Stacks that hit the call-tree node bound and collapsed into a per-parent "
    "(other) bucket.",
)

#: The process profiler; set_profiler swaps it, and the gauges read
#: through the accessor.
_PROFILER = SamplingProfiler()


def profiler() -> SamplingProfiler:
    return _PROFILER


def set_profiler(instance: SamplingProfiler) -> SamplingProfiler:
    """Install ``instance`` as the process profiler; returns the one it
    replaced."""
    global _PROFILER
    previous, _PROFILER = _PROFILER, instance
    return previous


def _overhead_sample() -> float | None:
    """Mean per-sample overhead in seconds; None before the first."""
    overhead = _PROFILER.overhead_ns_per_sample()
    return overhead / 1e9 if overhead is not None else None


_registry.gauge_fn(
    "headlamp_tpu_torch_profiler_nodes_count",
    f"Interned call-tree nodes held by the profiler (bounded by {PROFILER_MAX_NODES} "
    "plus per-parent collapse buckets).",
    lambda: float(_PROFILER.node_count()),
)
_registry.gauge_fn(
    "headlamp_tpu_torch_profiler_overhead_seconds",
    "Mean sampler overhead per wake-up (perf_counter around the frame walk; "
    f"budget {PROFILER_SAMPLE_BUDGET_NS} ns).",
    _overhead_sample,
)

"""Bounded render worker pool with priority admission.

The port's copy of ``headlamp_tpu/gateway/pool.py:63-289``. A
thread-per-request server lets every page load race every other for the
interpreter and the card; the pool makes request threads cheap waiters
and runs renders on a fixed number of workers. Admission is where policy
lives: a queue depth per class (reject, never buffer without bound), a
concurrency cap per route (one route's stampede must not take every
worker) and a queue-wait deadline (a render nobody waits for any more
must not run).

Priority is strict: interactive pages (class 0) pop before the ops
surfaces (/metricsz, /sloz; class 1), which pop before /debug/* (class
2). Starving class 2 under sustained interactive load is intended.

Queue-wait ages run on the injected ``monotonic``. Expiry is judged at
pop time: a job found past its deadline completes as ``expired`` without
running. ``worker_context`` is the seam a device-bound caller uses to
pin each worker thread (the dashboard host enters its card there).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Callable, ContextManager, Mapping

#: Priority classes, lowest number pops first.
PRIORITY_INTERACTIVE = 0
PRIORITY_OPS = 1
PRIORITY_DEBUG = 2

PRIORITY_NAMES: dict[int, str] = {
    PRIORITY_INTERACTIVE: "interactive",
    PRIORITY_OPS: "ops",
    PRIORITY_DEBUG: "debug",
}

#: Queue depth per class: interactive buffers a burst of real users,
#: debug almost nothing (a /debug stampede hits 503s at once).
DEFAULT_QUEUE_DEPTH: dict[int, int] = {
    PRIORITY_INTERACTIVE: 64,
    PRIORITY_OPS: 32,
    PRIORITY_DEBUG: 8,
}

#: Queue-wait deadline per class (seconds): past it the client has given
#: up, or the answer is too old to matter.
DEFAULT_QUEUE_DEADLINE_S: dict[int, float] = {
    PRIORITY_INTERACTIVE: 10.0,
    PRIORITY_OPS: 5.0,
    PRIORITY_DEBUG: 2.0,
}


class QueueFull(Exception):
    """Admission rejected: the priority class's queue is at depth."""

    def __init__(self, priority: int, depth: int) -> None:
        self.priority = priority
        self.depth = depth
        super().__init__(f"{PRIORITY_NAMES.get(priority, priority)} queue full (depth {depth})")


class Job:
    """One admitted render. The request thread waits on ``done``; the
    worker fills ``result`` or ``error`` and an ``outcome``."""

    __slots__ = (
        "route", "priority", "fn", "enqueued_mono", "done", "result", "error", "outcome",
        "queue_wait_s",
    )

    def __init__(
        self, route: str, priority: int, fn: Callable[[], Any], enqueued_mono: float
    ) -> None:
        self.route = route
        self.priority = priority
        self.fn = fn
        self.enqueued_mono = enqueued_mono
        self.done = threading.Event()
        self.result: Any = None
        self.error: BaseException | None = None
        #: "rendered" | "failed" | "expired" (None while pending).
        self.outcome: str | None = None
        self.queue_wait_s: float = 0.0


class RenderPool:
    """Fixed worker threads over strict-priority bounded queues.

    ``route_limit`` caps how many workers one route label may hold at
    once; a job whose route is saturated is skipped (not popped), so jobs
    on other routes are not blocked behind it."""

    def __init__(
        self,
        *,
        workers: int = 4,
        queue_depth: Mapping[int, int] | None = None,
        queue_deadline_s: Mapping[int, float] | None = None,
        route_limit: int | None = None,
        monotonic: Callable[[], float] | None = None,
        worker_context: Callable[[], ContextManager[Any]] | None = None,
    ) -> None:
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self.workers = workers
        self.queue_depth = dict(DEFAULT_QUEUE_DEPTH)
        if queue_depth:
            self.queue_depth.update(queue_depth)
        self.queue_deadline_s = dict(DEFAULT_QUEUE_DEADLINE_S)
        if queue_deadline_s:
            self.queue_deadline_s.update(queue_deadline_s)
        # One worker stays free for other routes while a single route
        # stampedes; a 1-worker pool must allow that route the whole pool.
        self.route_limit = route_limit if route_limit else max(1, workers - 1)
        self._monotonic = monotonic or time.monotonic
        self._worker_context = worker_context or contextlib.nullcontext
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues: dict[int, deque[Job]] = {p: deque() for p in sorted(PRIORITY_NAMES)}
        self._inflight_by_route: dict[str, int] = {}
        self._inflight = 0
        self._stopping = False
        # Monotone per-instance counters (/healthz and flight-recorder view).
        self.submitted = 0
        self.executed = 0
        self.expired = 0
        self.failed = 0
        self._threads = [
            threading.Thread(target=self._worker, name=f"hl-torch-render-{i}", daemon=True)
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()

    # -- admission -------------------------------------------------------

    def submit(self, route: str, priority: int, fn: Callable[[], Any]) -> Job:
        """Admit a render or raise :class:`QueueFull`; the caller waits on
        the returned job's ``done``."""
        if priority not in self._queues:
            raise ValueError(f"unknown priority class {priority!r}")
        job = Job(route, priority, fn, self._monotonic())
        with self._cond:
            if self._stopping:
                raise QueueFull(priority, 0)
            depth = self.queue_depth[priority]
            if len(self._queues[priority]) >= depth:
                raise QueueFull(priority, depth)
            self._queues[priority].append(job)
            self.submitted += 1
            self._cond.notify()
        return job

    # -- worker loop -----------------------------------------------------

    def _pop_locked(self) -> Job | None:
        """The next runnable or expired job in strict priority order; the
        caller holds the lock. An expired job is returned marked, so the
        worker completes it without running it."""
        now = self._monotonic()
        for priority in sorted(self._queues):
            queue = self._queues[priority]
            deadline = self.queue_deadline_s[priority]
            skipped: list[Job] = []
            taken: Job | None = None
            while queue:
                job = queue.popleft()
                job.queue_wait_s = now - job.enqueued_mono
                if job.queue_wait_s > deadline:
                    job.outcome = "expired"
                    self.expired += 1
                    taken = job
                    break
                if (
                    self._inflight_by_route.get(job.route, 0) >= self.route_limit
                    and self._inflight < self.workers
                ):
                    # Route saturated while a worker is idle: try the next
                    # job. (With every worker busy the cap is moot.)
                    skipped.append(job)
                    continue
                self._inflight_by_route[job.route] = self._inflight_by_route.get(job.route, 0) + 1
                self._inflight += 1
                taken = job
                break
            for job in reversed(skipped):
                queue.appendleft(job)
            if taken is not None:
                return taken
        return None

    def _worker(self) -> None:
        with self._worker_context():
            self._work()

    def _work(self) -> None:
        while True:
            with self._cond:
                job = self._pop_locked()
                while job is None:
                    if self._stopping:
                        return
                    self._cond.wait()
                    job = self._pop_locked()
            if job.outcome == "expired":
                job.done.set()
                continue
            try:
                job.result = job.fn()
                job.outcome = "rendered"
            except BaseException as exc:  # noqa: BLE001 — the worker must survive; the waiter reads it
                job.error = exc
                job.outcome = "failed"
            finally:
                with self._cond:
                    self.executed += 1
                    if job.outcome == "failed":
                        self.failed += 1
                    count = self._inflight_by_route.get(job.route, 1) - 1
                    if count <= 0:
                        self._inflight_by_route.pop(job.route, None)
                    else:
                        self._inflight_by_route[job.route] = count
                    self._inflight -= 1
                    self._cond.notify_all()
                job.done.set()

    # -- observability and lifetime -------------------------------------

    def queue_depths(self) -> dict[str, int]:
        with self._lock:
            return {PRIORITY_NAMES[p]: len(q) for p, q in sorted(self._queues.items())}

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def counters(self) -> dict[str, int]:
        """Monotone ints, read without the lock (flight-recorder deltas)."""
        return {
            "submitted": self.submitted,
            "executed": self.executed,
            "expired": self.expired,
            "failed": self.failed,
        }

    def close(self, timeout_s: float = 30.0) -> bool:
        """Stop the workers and join them. Queued jobs complete as expired,
        so no waiter hangs; a render in flight runs to its end. Returns
        False when a worker outlived ``timeout_s``."""
        with self._cond:
            self._stopping = True
            pending = [job for q in self._queues.values() for job in q]
            for q in self._queues.values():
                q.clear()
            self._cond.notify_all()
        for job in pending:
            job.outcome = "expired"
            job.done.set()
        deadline = time.monotonic() + timeout_s
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
        return not any(t.is_alive() for t in self._threads)

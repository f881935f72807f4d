"""The device's activity in a traced window, from ``torch.profiler``.

The traced run wraps its window in ``torch.profiler.profile`` with CUDA
activity only (CUPTI traces every kernel, copy and set on the card, from
any thread). The profiler's clock is its own, so the window opens with a
marker kernel (``torch.cuda._sleep``) launched at a known host time; the
marker's start on the device ties the two clocks together, to within
the launch latency.

From the intervals it gives the seconds in which some operation ran
(their union), the operations that took most time, and the longest idle
gaps, each named by the host span that was open at its middle.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Iterator

MARKER = "spin"


class DeviceTrace:
    """Device intervals ``(start, end, name)`` on the host's monotonic clock."""

    def __init__(self, intervals: list[tuple[float, float, str]]) -> None:
        self.intervals = sorted(intervals)

    def within(self, start: float, end: float) -> list[tuple[float, float, str]]:
        return [
            (max(a, start), min(b, end), n) for a, b, n in self.intervals if b > start and a < end
        ]

    def busy_s(self, start: float, end: float) -> float:
        """Seconds of [start, end] in which some operation ran."""
        busy, cursor = 0.0, start
        for a, b, _ in self.within(start, end):
            a = max(a, cursor)
            if b > a:
                busy += b - a
                cursor = b
        return busy

    def top_ops(self, start: float, end: float, n: int = 10) -> list[list[Any]]:
        totals: dict[str, float] = {}
        for a, b, name in self.within(start, end):
            totals[name] = totals.get(name, 0.0) + (b - a)
        return [[k[:64], v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]

    def gaps(self, start: float, end: float) -> list[tuple[float, float]]:
        out, cursor = [], start
        for a, b, _ in self.within(start, end):
            if a > cursor:
                out.append((cursor, a))
            cursor = max(cursor, b)
        if end > cursor:
            out.append((cursor, end))
        return out



def _is_device(event: Any) -> bool:
    return "CUDA" in str(getattr(event, "device_type", "")).upper()


@contextmanager
def profiled(device: Any) -> Iterator[dict[str, Any]]:
    """Profile the card's activity inside the block; on exit the yielded
    dict holds ``trace``, a :class:`DeviceTrace`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out: dict[str, Any] = {}
    # The default stream only: the program's registry may capture a CUDA
    # graph on a side stream, and a device-wide synchronize meets it.
    stream = torch.cuda.default_stream(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        stream.synchronize()
        marked = time.monotonic()
        with torch.cuda.device(device):
            torch.cuda._sleep(1000)
        stream.synchronize()
        yield out
        stream.synchronize()
    events = [e for e in prof.events() if _is_device(e)]
    marker = min((e for e in events if MARKER in e.name), key=lambda e: e.time_range.start)
    offset = marked - marker.time_range.start / 1e6
    out["trace"] = DeviceTrace([
        (e.time_range.start / 1e6 + offset, e.time_range.end / 1e6 + offset, e.name)
        for e in events if e is not marker
    ])


def host_span_at(traces: list[dict[str, Any]], at_wall: float) -> str:
    """The innermost span open at wall time ``at_wall`` in any request
    trace, or ``no_host_span``."""
    best: tuple[float, str] | None = None

    def walk(spans: list[dict[str, Any]], base: float, depth: int) -> None:
        nonlocal best
        for s in spans:
            a = base + s["start_ms"] / 1000
            b = a + s["duration_ms"] / 1000
            if a <= at_wall <= b:
                key = (depth, s["name"])
                if best is None or key[0] >= best[0]:
                    best = key
                walk(s.get("children", []), base, depth + 1)

    for t in traces:
        start = t["started_at"]
        if start <= at_wall <= start + t["duration_ms"] / 1000:
            walk(t.get("spans", []), start, 1)
    return best[1] if best is not None else "no_host_span"

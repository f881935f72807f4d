"""What one run measured, as the metric readers see it.

The readers in ``benchmark/metrics/`` take a :class:`Run` and return a
number or None (nothing to read in this cell). A :class:`Run` holds the
clients' paint records, the window's bounds, the request traces the
program recorded in a traced run, the program's ``/metricsz`` and
``/healthz`` before and after the window, and the device trace.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Iterator

_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)")


def parse_metricsz(text: str) -> dict[tuple[str, str], float]:
    """Prometheus text exposition as ``{(name, labels): value}``."""
    out: dict[tuple[str, str], float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if m is None:
            continue
        try:
            out[(m.group(1), m.group(2) or "")] = float(m.group(3))
        except ValueError:
            continue
    return out


@dataclass
class Paint:
    client: int
    index: int
    route: str
    sent: float
    done: float
    status: int
    nbytes: int   #: the body's bytes as they came on the wire
    stale: bool   #: the host rendered it from caches only (degraded)
    ok: bool = True  #: False once the correctness check found it wrong

    @property
    def ms(self) -> float:
        """Latency from the paint's send until its last byte."""
        return (self.done - self.sent) * 1000


@dataclass
class Run:
    start: float
    end: float
    setup_s: float
    paints: list[Paint]
    metricsz_before: dict[tuple[str, str], float]
    metricsz_after: dict[tuple[str, str], float]
    healthz_before: dict[str, Any]
    healthz_after: dict[str, Any]
    traces: list[dict[str, Any]] = field(default_factory=list)
    device: Any = None           #: a devtrace.DeviceTrace in a traced run
    wall_minus_mono: float = 0.0  #: time.time() - time.monotonic()

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def completed(self) -> list[Paint]:
        """Pages answered 200, judged right, and done inside the window."""
        return [p for p in self.paints if p.status == 200 and p.ok and p.done <= self.end]

    def metric_sum(self, name: str, when: str = "after") -> float:
        table = self.metricsz_after if when == "after" else self.metricsz_before
        return sum(v for (n, _), v in table.items() if n == name)

    def metric_delta(self, name: str) -> float:
        return self.metric_sum(name, "after") - self.metric_sum(name, "before")

    def window_traces(self) -> list[dict[str, Any]]:
        lo, hi = self.start + self.wall_minus_mono, self.end + self.wall_minus_mono
        return [t for t in self.traces if lo <= t["started_at"] <= hi]

    def spans(self, *names: str, outermost: bool = False
              ) -> Iterator[tuple[dict[str, Any], dict[str, Any]]]:
        """Every span named one of ``names`` in the window's traces, with
        its trace, outer before inner; with ``outermost`` a matching span
        inside a matching span is left out."""
        def walk(spans: list[dict[str, Any]], trace: dict[str, Any]) -> Iterator[Any]:
            for s in spans:
                if s["name"] in names:
                    yield s, trace
                    if outermost:
                        continue
                yield from walk(s.get("children", []), trace)

        for t in self.window_traces():
            yield from walk(t.get("spans", []), t)


def self_ms(span: dict[str, Any]) -> float:
    """A span's duration less the part its children cover."""
    return span["duration_ms"] - sum(c["duration_ms"] for c in span.get("children", []))


def has_span(trace: dict[str, Any], name: str) -> bool:
    def walk(spans: list[dict[str, Any]]) -> bool:
        return any(s["name"] == name or walk(s.get("children", [])) for s in spans)
    return walk(trace.get("spans", []))

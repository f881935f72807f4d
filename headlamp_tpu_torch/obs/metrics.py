"""Metric registry and Prometheus text exposition for ``/metricsz``.

The port's copy of ``headlamp_tpu/obs/metrics.py``, trimmed to the
dashboard host's metrics path: counters, gauges, callback gauges and
fixed-bucket histograms in a get-or-create registry, rendered in the
Prometheus text format 0.0.4. Every name carries the port's own prefix,
``headlamp_tpu_torch_``, and lives in this module's :data:`registry`, so
a process that imports both packages never mixes the two expositions.

Each instrument takes its own lock around a read-modify-write; the
registry lock is taken only at wiring time, when a caller gets or
creates an instrument and keeps the reference.
"""

from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left
from typing import Any, Callable, Iterator

_NAME_RE = re.compile(r"^headlamp_tpu_torch_[a-z0-9_]+$")

#: Content type of the text exposition format.
TEXT_CONTENT_TYPE = "text/plain"

#: Unit suffixes a name must end in: ``_total`` for counters, base units
#: for measurements, ``_count`` for cardinalities, ``_ratio`` for 0..1,
#: ``_info`` for 0/1 flags.
UNIT_SUFFIXES = ("_total", "_seconds", "_bytes", "_ratio", "_count", "_info")

#: Fixed log-2 latency buckets, 1 ms to about 16 s: from a cached paint
#: to a cold fit with a kernel build, with constant relative error.
DEFAULT_LATENCY_BUCKETS = tuple(0.001 * 2.0**i for i in range(15))


def _validate_name(name: str, kind: str) -> None:
    if not _NAME_RE.match(name):
        raise ValueError(f"metric name {name!r} must match {_NAME_RE.pattern}")
    if not name.endswith(UNIT_SUFFIXES):
        raise ValueError(f"metric name {name!r} must end in one of {UNIT_SUFFIXES}")
    if kind == "counter" and not name.endswith("_total"):
        raise ValueError(f"counter {name!r} must end in '_total'")
    if kind == "histogram" and not name.endswith(("_seconds", "_bytes")):
        # _bucket/_sum/_count derive from the base name, so the base
        # itself carries the unit.
        raise ValueError(f"histogram {name!r} must end in '_seconds' or '_bytes'")


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(value: float) -> str:
    """Integral floats render as integers, everything else as repr."""
    f = float(value)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(labels: tuple[str, ...], values: tuple[str, ...]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"' for k, v in zip(labels, values)) + "}"


def _label_key(name: str, labels: tuple[str, ...], given: dict[str, Any]) -> tuple[str, ...]:
    if set(given) != set(labels):
        raise ValueError(f"{name}: expected labels {labels}, got {tuple(given)}")
    return tuple(str(given[label]) for label in labels)


class Counter:
    """Monotone counter, optionally labeled."""

    kind = "counter"

    def __init__(self, name: str, help: str, labels: tuple[str, ...] = ()) -> None:
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self._lock = threading.Lock()
        self._values: dict[tuple[str, ...], float] = {}

    def inc(self, amount: float = 1, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = _label_key(self.name, self.labels, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    @property
    def value(self) -> float:
        """Unlabeled value (0 before the first inc)."""
        with self._lock:
            return self._values.get((), 0.0)

    def render_into(self, out: list[str]) -> None:
        with self._lock:
            samples = sorted(self._values.items()) or [((), 0.0)]
        for values, v in samples:
            out.append(f"{self.name}{_label_str(self.labels, values)} {_fmt(v)}")


class Gauge(Counter):
    """Settable gauge: Counter's labeled storage, with ``set`` and
    movement in both directions."""

    kind = "gauge"

    def inc(self, amount: float = 1, **labels: Any) -> None:
        key = _label_key(self.name, self.labels, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set(self, value: float, **labels: Any) -> None:
        key = _label_key(self.name, self.labels, labels)
        with self._lock:
            self._values[key] = float(value)


class CallbackGauge:
    """Gauge computed at scrape time by a zero-arg callable. A callback
    that returns None or raises omits its sample: a scrape never fails
    because one producer broke."""

    kind = "gauge"

    def __init__(self, name: str, help: str, fn: Callable[[], float | None]) -> None:
        self.name = name
        self.help = help
        self.labels: tuple[str, ...] = ()
        self.fn = fn

    def render_into(self, out: list[str]) -> None:
        try:
            value = self.fn()
        except Exception:  # noqa: BLE001 — the scrape survives a broken producer
            value = None
        if value is not None:
            out.append(f"{self.name} {_fmt(float(value))}")


class _HistogramChild:
    __slots__ = ("counts", "sum", "count", "lock")

    def __init__(self, n_buckets: int) -> None:
        # counts[i]: observations in (bucket[i-1], bucket[i]];
        # counts[n]: observations above the last finite bucket.
        self.counts = [0] * (n_buckets + 1)
        self.sum = 0.0
        self.count = 0
        self.lock = threading.Lock()


class Histogram:
    """Fixed-bucket histogram, rendered cumulative with a ``+Inf`` bucket."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS,
        labels: tuple[str, ...] = (),
    ) -> None:
        if list(buckets) != sorted(buckets) or len(set(buckets)) != len(buckets):
            raise ValueError(f"{name}: buckets must be strictly increasing")
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self.buckets = tuple(float(b) for b in buckets)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], _HistogramChild] = {}

    def observe(self, value: float, **labels: Any) -> None:
        key = _label_key(self.name, self.labels, labels)
        with self._lock:
            child = self._children.setdefault(key, _HistogramChild(len(self.buckets)))
        value = float(value)
        idx = bisect_left(self.buckets, value)
        with child.lock:
            child.counts[idx] += 1
            child.sum += value
            child.count += 1

    def render_into(self, out: list[str]) -> None:
        with self._lock:
            items = sorted(self._children.items())
        if not items and not self.labels:
            # An unlabeled histogram shows its series before traffic.
            items = [((), _HistogramChild(len(self.buckets)))]
        for values, child in items:
            with child.lock:
                counts, total, total_sum = list(child.counts), child.count, child.sum
            cumulative = 0
            for bound, n in zip(self.buckets, counts):
                cumulative += n
                le = _label_str(self.labels + ("le",), values + (_fmt(bound),))
                out.append(f"{self.name}_bucket{le} {cumulative}")
            inf = _label_str(self.labels + ("le",), values + ("+Inf",))
            out.append(f"{self.name}_bucket{inf} {total}")
            out.append(f"{self.name}_sum{_label_str(self.labels, values)} {_fmt(total_sum)}")
            out.append(f"{self.name}_count{_label_str(self.labels, values)} {total}")


class MetricRegistry:
    """Name -> instrument map with get-or-create semantics: many apps in
    one process share (and accumulate into) one instrument per name."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, Any] = {}

    def _get_or_create(self, name: str, factory: Callable[[], Any], kind: str) -> Any:
        _validate_name(name, kind)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if existing.kind != kind:
                    raise ValueError(f"metric {name!r} already registered as {existing.kind}")
                return existing
            metric = factory()
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str, labels: tuple[str, ...] = ()) -> Counter:
        return self._get_or_create(name, lambda: Counter(name, help, labels), "counter")

    def gauge(self, name: str, help: str, labels: tuple[str, ...] = ()) -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, help, labels), "gauge")

    def gauge_fn(self, name: str, help: str, fn: Callable[[], float | None]) -> CallbackGauge:
        """Callback gauge; registering the same name again swaps the
        callback (the latest producer wins)."""
        gauge = self._get_or_create(name, lambda: CallbackGauge(name, help, fn), "gauge")
        if isinstance(gauge, CallbackGauge):
            gauge.fn = fn
        return gauge

    def histogram(
        self,
        name: str,
        help: str,
        buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS,
        labels: tuple[str, ...] = (),
    ) -> Histogram:
        return self._get_or_create(
            name, lambda: Histogram(name, help, buckets, labels), "histogram"
        )

    def __iter__(self) -> Iterator[Any]:
        with self._lock:
            metrics = list(self._metrics.values())
        return iter(sorted(metrics, key=lambda m: m.name))

    def render(self) -> str:
        """The /metricsz body: one HELP and TYPE block per metric, its
        samples after."""
        out: list[str] = []
        for metric in self:
            out.append(f"# HELP {metric.name} {_escape_help(metric.help)}")
            out.append(f"# TYPE {metric.name} {metric.kind}")
            metric.render_into(out)
        return "\n".join(out) + "\n"


#: The process registry: everything the port's /metricsz serves.
registry = MetricRegistry()

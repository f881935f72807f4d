"""Metric registry and Prometheus text exposition for ``/metricsz``.

The port's copy of ``headlamp_tpu/obs/metrics.py``: counters, gauges,
callback gauges (one sample or a labeled set) and fixed-bucket
histograms in a get-or-create registry, rendered in the Prometheus text
format 0.0.4 or, when the scraper asks for it, in OpenMetrics 1.0 with
exemplars on the histogram buckets. Every name carries the port's own
prefix, ``headlamp_tpu_torch_``, and lives in this module's
:data:`registry`, so a process that imports both packages never mixes
the two expositions.

Each instrument takes its own lock around a read-modify-write; the
registry lock is taken only at wiring time, when a caller gets or
creates an instrument and keeps the reference. Counters and histograms
take observers (``add_observer``), called after each update: that is
how the SLO engine (``obs/slo.py``) is fed without its producers
knowing of it.
"""

from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left
from typing import Any, Callable, Iterator

_NAME_RE = re.compile(r"^headlamp_tpu_torch_[a-z0-9_]+$")

#: Content type of the OpenMetrics rendering, the only exposition that
#: may carry exemplar clauses: the 0.0.4 text parser reads a trailing
#: ``#`` token as a malformed timestamp and fails the whole scrape.
OPENMETRICS_CONTENT_TYPE = "application/openmetrics-text; version=1.0.0"
#: Content type of the text exposition format.
TEXT_CONTENT_TYPE = "text/plain"


def negotiate_openmetrics(accept: str | None) -> bool:
    """True iff the Accept header opts into OpenMetrics: a clause whose
    media type is ``application/openmetrics-text`` with a q above 0. An
    absent or unparsable header keeps the text format."""
    if not accept:
        return False
    for clause in accept.split(","):
        parts = [p.strip() for p in clause.split(";")]
        if parts[0].lower() != "application/openmetrics-text":
            continue
        q = 1.0
        for param in parts[1:]:
            if param.lower().startswith("q="):
                try:
                    q = float(param[2:])
                except ValueError:
                    q = 0.0
        if q > 0:
            return True
    return False

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


#: Zero-arg callable returning the active request's trace id (or None),
#: installed by ``obs/exemplars.py`` so this module imports nothing of
#: the trace layer. None turns exemplar capture off.
_EXEMPLAR_SOURCE: Callable[[], str | None] | None = None


def set_exemplar_source(fn: Callable[[], str | None] | None) -> None:
    global _EXEMPLAR_SOURCE
    _EXEMPLAR_SOURCE = fn


Observer = Callable[[float, dict[str, Any]], None]


def _notify(observers: tuple[Observer, ...], value: float, labels: dict[str, Any]) -> None:
    for fn in observers:
        try:
            fn(value, labels)
        except Exception:  # noqa: BLE001 — a broken subscriber never fails the producer
            pass


def _label_key(name: str, labels: tuple[str, ...], given: dict[str, Any]) -> tuple[str, ...]:
    if set(given) != set(labels):
        raise ValueError(f"{name}: expected labels {labels}, got {tuple(given)}")
    return tuple(str(given[label]) for label in labels)


class Counter:
    """Monotone counter, optionally labeled. Observers ``fn(amount,
    labels)`` run after each ``inc``."""

    kind = "counter"

    def __init__(self, name: str, help: str, labels: tuple[str, ...] = ()) -> None:
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self._lock = threading.Lock()
        self._values: dict[tuple[str, ...], float] = {}
        self._observers: tuple[Observer, ...] = ()

    def add_observer(self, fn: Observer) -> None:
        self._observers = self._observers + (fn,)

    def inc(self, amount: float = 1, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = _label_key(self.name, self.labels, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount
        if self._observers:
            _notify(self._observers, amount, labels)

    @property
    def value(self) -> float:
        """Unlabeled value (0 before the first inc)."""
        with self._lock:
            return self._values.get((), 0.0)

    def value_for(self, **labels: Any) -> float:
        key = _label_key(self.name, self.labels, labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def samples(self) -> list[tuple[tuple[str, ...], float]]:
        with self._lock:
            return sorted(self._values.items())

    def render_into(self, out: list[str], openmetrics: bool = False) -> None:
        for values, v in self.samples() or [((), 0.0)]:
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

    def render_into(self, out: list[str], openmetrics: bool = False) -> None:
        try:
            value = self.fn()
        except Exception:  # noqa: BLE001 — the scrape survives a broken producer
            value = None
        if value is not None:
            out.append(f"{self.name} {_fmt(float(value))}")


class MultiCallbackGauge:
    """Labeled callback gauge: ``fn`` returns ``(label_values, value)``
    pairs at scrape time, for sample sets that are themselves dynamic
    (per-SLO states and burn rates). Raising, or a pair of the wrong
    arity, omits samples, as with :class:`CallbackGauge`."""

    kind = "gauge"

    def __init__(
        self, name: str, help: str, labels: tuple[str, ...], fn: Callable[[], Any]
    ) -> None:
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self.fn = fn

    def render_into(self, out: list[str], openmetrics: bool = False) -> None:
        try:
            samples = list(self.fn() or ())
        except Exception:  # noqa: BLE001 — the scrape survives a broken producer
            return
        for values, value in samples:
            values = tuple(str(v) for v in values)
            if len(values) != len(self.labels):
                continue
            out.append(f"{self.name}{_label_str(self.labels, values)} {_fmt(float(value))}")


class MultiCallbackCounter(MultiCallbackGauge):
    """Labeled callback counter: :class:`MultiCallbackGauge`'s contract,
    rendered as ``TYPE counter``, for monotone values kept outside this
    process's instruments. The callback is trusted to be monotone."""

    kind = "counter"


class _HistogramChild:
    __slots__ = ("counts", "sum", "count", "lock", "exemplars")

    def __init__(self, n_buckets: int) -> None:
        # counts[i]: observations in (bucket[i-1], bucket[i]];
        # counts[n]: observations above the last finite bucket.
        self.counts = [0] * (n_buckets + 1)
        self.sum = 0.0
        self.count = 0
        self.lock = threading.Lock()
        #: Per-bucket most recent (trace_id, value), allocated at the
        #: first traced observe.
        self.exemplars: list[tuple[str, float] | None] | None = None


def _exemplar_suffix(exemplars: list[tuple[str, float] | None] | None, idx: int) -> str:
    """OpenMetrics exemplar clause of one bucket line, without the
    optional timestamp: ``# {trace_id="<16hex>"} 0.093``."""
    if exemplars is None or exemplars[idx] is None:
        return ""
    trace_id, value = exemplars[idx]
    return f' # {{trace_id="{_escape_label(trace_id)}"}} {_fmt(value)}'


class Histogram:
    """Fixed-bucket histogram, rendered cumulative with a ``+Inf``
    bucket. With an exemplar source installed, each observe inside a
    traced request keeps the request's trace id against the bucket the
    value landed in; the OpenMetrics rendering emits it."""

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
        self._observers: tuple[Observer, ...] = ()

    def add_observer(self, fn: Observer) -> None:
        self._observers = self._observers + (fn,)

    def observe(self, value: float, **labels: Any) -> None:
        source = _EXEMPLAR_SOURCE
        trace_id = source() if source is not None else None
        key = _label_key(self.name, self.labels, labels)
        with self._lock:
            child = self._children.setdefault(key, _HistogramChild(len(self.buckets)))
        value_f = float(value)
        idx = bisect_left(self.buckets, value_f)
        with child.lock:
            child.counts[idx] += 1
            child.sum += value_f
            child.count += 1
            if trace_id is not None:
                if child.exemplars is None:
                    child.exemplars = [None] * len(child.counts)
                child.exemplars[idx] = (trace_id, value_f)
        if self._observers:
            _notify(self._observers, value, labels)

    def count_for(self, **labels: Any) -> int:
        key = _label_key(self.name, self.labels, labels)
        with self._lock:
            child = self._children.get(key)
        return child.count if child is not None else 0

    def exemplars(self) -> list[tuple[tuple[str, ...], str, str, float]]:
        """``(label_values, le, trace_id, value)`` for every bucket that
        holds an exemplar."""
        with self._lock:
            items = sorted(self._children.items())
        out: list[tuple[tuple[str, ...], str, str, float]] = []
        for values, child in items:
            with child.lock:
                exemplars = list(child.exemplars) if child.exemplars else []
            for idx, ex in enumerate(exemplars):
                if ex is None:
                    continue
                le = _fmt(self.buckets[idx]) if idx < len(self.buckets) else "+Inf"
                out.append((values, le, ex[0], ex[1]))
        return out

    def render_into(self, out: list[str], openmetrics: bool = False) -> None:
        with self._lock:
            items = sorted(self._children.items())
        if not items and not self.labels:
            # An unlabeled histogram shows its series before traffic.
            items = [((), _HistogramChild(len(self.buckets)))]
        for values, child in items:
            with child.lock:
                counts, total, total_sum = list(child.counts), child.count, child.sum
                # Exemplars only in OpenMetrics: on the text format they
                # would fail the whole scrape.
                exemplars = list(child.exemplars) if openmetrics and child.exemplars else None
            cumulative = 0
            for i, (bound, n) in enumerate(zip(self.buckets, counts)):
                cumulative += n
                le = _label_str(self.labels + ("le",), values + (_fmt(bound),))
                out.append(f"{self.name}_bucket{le} {cumulative}" + _exemplar_suffix(exemplars, i))
            inf = _label_str(self.labels + ("le",), values + ("+Inf",))
            out.append(
                f"{self.name}_bucket{inf} {total}" + _exemplar_suffix(exemplars, len(self.buckets))
            )
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

    def gauge_samples_fn(
        self, name: str, help: str, labels: tuple[str, ...], fn: Callable[[], Any]
    ) -> MultiCallbackGauge:
        """Labeled callback gauge; the latest producer wins, as with
        :meth:`gauge_fn`."""
        gauge = self._get_or_create(
            name, lambda: MultiCallbackGauge(name, help, labels, fn), "gauge"
        )
        if isinstance(gauge, MultiCallbackGauge):
            gauge.fn = fn
        return gauge

    def counter_samples_fn(
        self, name: str, help: str, labels: tuple[str, ...], fn: Callable[[], Any]
    ) -> MultiCallbackCounter:
        """Labeled callback counter; the latest producer wins."""
        counter = self._get_or_create(
            name, lambda: MultiCallbackCounter(name, help, labels, fn), "counter"
        )
        if isinstance(counter, MultiCallbackCounter):
            counter.fn = fn
        return counter

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

    def render(self, *, openmetrics: bool = False) -> str:
        """The /metricsz body: one HELP and TYPE block per metric, its
        samples after, in the text format 0.0.4 without exemplars. With
        ``openmetrics``: OpenMetrics 1.0, counter families named without
        their ``_total`` suffix (the samples keep it), exemplar clauses
        on histogram buckets and the ``# EOF`` terminator."""
        out: list[str] = []
        for metric in self:
            family = metric.name
            if openmetrics and metric.kind == "counter":
                family = family[: -len("_total")]
            out.append(f"# HELP {family} {_escape_help(metric.help)}")
            out.append(f"# TYPE {family} {metric.kind}")
            metric.render_into(out, openmetrics=openmetrics)
        if openmetrics:
            out.append("# EOF")
        return "\n".join(out) + "\n"


#: The process registry: everything the port's /metricsz serves.
registry = MetricRegistry()

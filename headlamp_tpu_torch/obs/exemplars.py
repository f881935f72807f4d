"""Trace exemplars: histogram buckets linked to the request that filled them.

The port's copy of ``headlamp_tpu/obs/exemplars.py``. Once
:func:`install` has run (the package does it at import), every histogram
observe made inside a traced request records the request's trace id
against the bucket the value landed in, and ``/metricsz`` under
``Accept: application/openmetrics-text`` emits it on the bucket line::

    headlamp_tpu_torch_request_duration_seconds_bucket{route="/tpu/metrics",le="2.048"} 17 # {trace_id="9f3a..."} 1.842

So a burning latency objective resolves in two hops: ``/sloz`` names it
and lists its exemplars, and ``/debug/traces`` (or its waterfall page)
shows where each of those requests spent its time.

The module keeps the layers acyclic: ``obs/metrics.py`` imports nothing
of the trace layer, and ``obs/trace.py`` knows no histogram.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

from .metrics import Histogram, set_exemplar_source
from .trace import current_trace_id


def install() -> None:
    """Point the metrics layer's exemplar source at the active trace.
    Idempotent."""
    set_exemplar_source(current_trace_id)


def uninstall() -> None:
    """Turn exemplar capture off."""
    set_exemplar_source(None)


def exemplars_matching(
    histogram: Histogram, where: Callable[[dict[str, str]], bool] | None = None
) -> Iterable[dict[str, Any]]:
    """The exemplars of ``histogram`` whose label set passes ``where``,
    JSON-ready; each bucket keeps only its most recent one."""
    for values, le, trace_id, value in histogram.exemplars():
        labels = dict(zip(histogram.labels, values))
        if where is not None and not where(labels):
            continue
        yield {"trace_id": trace_id, "le": le, "value": round(value, 6), "labels": labels}

"""Intel GPU Prometheus client — i915 hwmon power telemetry.

The port's copy of ``headlamp_tpu/metrics/intel_client.py``, a
capability port of the reference's metrics client
(`src/api/metrics.ts:96-159`) onto the port's transport: the same four queries (chip discovery, 5-minute energy rate
→ power W, TDP, instance→node map) joined on (chip, instance), sharing
the TPU client's service-discovery chain. The well-known availability
facts the reference documents in its UI (`MetricsPage.tsx:4-27`) are
encoded in :data:`INTEL_METRIC_AVAILABILITY`: frequency/utilization and
iGPU power are NOT obtainable from a standard node-exporter setup.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

from ..transport.api_proxy import ApiError, Transport
from ..transport.pool import fanout, pool_of
from .client import (
    _build_instance_map,
    _node_of,
    _proxy_query_path,
    _sample_labels,
    _sample_value,
    _vector_result,
    resolve_prometheus,
)
from .timing import FetchTimer

#: The reference's PromQL set (`metrics.ts:101-116`). The power rate
#: needs ≥5m of scrape history before it returns data — the UI hint at
#: `MetricsPage.tsx:105` carries over.
INTEL_QUERIES = {
    "chips": 'node_hwmon_chip_names{chip_name="i915"}',
    "power": (
        "rate(node_hwmon_energy_joule_total[5m]) "
        '* on(chip,instance) group_left(chip_name) '
        'node_hwmon_chip_names{chip_name="i915"}'
    ),
    "tdp": (
        "node_hwmon_power_max_watt "
        '* on(chip,instance) group_left(chip_name) '
        'node_hwmon_chip_names{chip_name="i915"}'
    ),
    "node_map": "node_uname_info",
}

#: What a standard node-exporter i915 hwmon setup can and cannot
#: provide (`MetricsPage.tsx:125-185` renders exactly this honesty).
INTEL_METRIC_AVAILABILITY = (
    ("Package power (W)", True, "rate of node_hwmon_energy_joule_total, discrete i915"),
    ("TDP / power limit (W)", True, "node_hwmon_power_max_watt"),
    ("GPU frequency", False, "node-exporter's drm collector is AMD-only"),
    ("GPU utilization %", False, "needs intel-gpu-exporter / XPU manager"),
    ("Integrated GPU power", False, "iGPU shares the package sensor"),
)


@dataclass
class GpuChipMetrics:
    """One discrete i915 chip (`metrics.ts:21-32`)."""

    node: str
    chip: str
    power_watts: float | None = None
    tdp_watts: float | None = None

    @property
    def power_fraction(self) -> float | None:
        if self.power_watts is None or not self.tdp_watts:
            return None
        return self.power_watts / self.tdp_watts


@dataclass
class IntelMetricsSnapshot:
    namespace: str
    service: str
    chips: list[GpuChipMetrics] = field(default_factory=list)
    fetched_at: float = 0.0
    fetch_ms: float = 0.0


def format_watts(watts: float | None) -> str:
    """(`metrics.ts:161-164`)."""
    if watts is None:
        return "—"
    return f"{watts:.1f} W"


def fetch_intel_gpu_metrics(
    transport: Transport,
    *,
    timeout_s: float = 2.0,
    clock: Callable[[], float] = time.time,
    prometheus: tuple[str, str] | None = None,
) -> IntelMetricsSnapshot | None:
    """Discover (shared chain, cached per transport) then run the 4
    queries in parallel over the transport's connection pool and join
    per (node, chip). None when no Prometheus answers
    (`metrics.ts:97-98`). A query that answers ``ApiError`` reads as an
    empty vector: the page's designed "not available" state."""
    timer = FetchTimer(clock)
    found = prometheus or resolve_prometheus(transport, timeout_s)
    if found is None:
        return None
    namespace, service = found

    def run_query(promql: str) -> list[Any]:
        try:
            data = transport.request(
                _proxy_query_path(namespace, service, promql), timeout_s
            )
        except ApiError:
            return []
        return _vector_result(data)

    names = list(INTEL_QUERIES)
    results = dict(
        zip(
            names,
            fanout.map(
                run_query,
                [INTEL_QUERIES[n] for n in names],
                pool=pool_of(transport),
            ),
        )
    )

    instance_map = _build_instance_map(results["node_map"])

    # One shared instance→node join with the TPU client (_node_of) so
    # both providers key chips identically under identical failures.
    chips: dict[tuple[str, str], GpuChipMetrics] = {}
    for sample in results["chips"]:
        labels = _sample_labels(sample)
        key = (_node_of(labels, instance_map), str(labels.get("chip", "?")))
        chips.setdefault(key, GpuChipMetrics(node=key[0], chip=key[1]))
    for field_name, result_key in (("power_watts", "power"), ("tdp_watts", "tdp")):
        for sample in results[result_key]:
            labels = _sample_labels(sample)
            value = _sample_value(sample)
            if value is None:
                continue
            key = (_node_of(labels, instance_map), str(labels.get("chip", "?")))
            row = chips.setdefault(key, GpuChipMetrics(node=key[0], chip=key[1]))
            setattr(row, field_name, value)

    fetched_at, fetch_ms = timer.stamp()
    return IntelMetricsSnapshot(
        namespace=namespace,
        service=service,
        chips=sorted(chips.values(), key=lambda c: (c.node, c.chip)),
        fetched_at=fetched_at,
        fetch_ms=fetch_ms,
    )

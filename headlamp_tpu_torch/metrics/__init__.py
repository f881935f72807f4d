"""Metrics layer — Prometheus clients for TPU and Intel GPU telemetry
(counterpart of ``headlamp_tpu/metrics``): service discovery over a
candidate chain, batched PromQL queries through the kube-apiserver service proxy, sample
joining, honest availability reporting, and the range-query utilization
history the forecaster fits on."""

from .client import (
    LOGICAL_METRICS,
    PROMETHEUS_SERVICES,
    TpuChipMetrics,
    TpuMetricsSnapshot,
    UtilizationHistory,
    cached_prometheus,
    fetch_tpu_metrics,
    fetch_utilization_history,
    find_prometheus_path,
    invalidate_prometheus,
    resolve_prometheus,
)
from .format import format_bytes, format_percent, format_ratio_bar

__all__ = [
    "LOGICAL_METRICS",
    "PROMETHEUS_SERVICES",
    "TpuChipMetrics",
    "TpuMetricsSnapshot",
    "UtilizationHistory",
    "cached_prometheus",
    "fetch_tpu_metrics",
    "fetch_utilization_history",
    "find_prometheus_path",
    "format_bytes",
    "format_percent",
    "format_ratio_bar",
    "invalidate_prometheus",
    "resolve_prometheus",
]

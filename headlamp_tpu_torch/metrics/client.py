"""TPU Prometheus client: discovery, fan-out queries, chip-level join.

Mirrors the reference client's four-stage shape
(`src/api/metrics.ts:61-154`) with TPU content:

1. **Service discovery** — probe a candidate chain of Prometheus
   services through the apiserver service proxy with a trivial query
   (``query=1``), first responder wins (`metrics.ts:61-90`). The chain
   adds Google Managed Prometheus's in-cluster frontend to the three
   community-standard services. The winner is cached per transport
   (ADR-014): a warm request skips the probe chain entirely — the
   chain is up to 6 serial round trips, pure RTT waste once the
   answer is known — and the cache self-invalidates when the fan-out
   proves the cached service dead.
2. **Fan-out** — every candidate series of every logical metric is
   queried (`metrics.ts:101-116`), folded into matcher-joined batches
   that run in parallel through the process fan-out scheduler
   (``transport/pool.py``), at a width chosen from the transport's
   connection pool when it has one, a fixed width otherwise.
3. **Schema tolerance** — each *logical* metric (tensorcore
   utilization, HBM used/total, memory-bandwidth utilization, duty
   cycle) is a fallback chain of candidate series names, because the
   tpu-device-plugin and libtpu exporters disagree on naming and label
   schema (SURVEY.md §7 hard part (c)). First non-empty result wins.
4. **Join** — samples join into per-chip rows keyed on
   (node, accelerator_id), with an instance→node fallback map built
   from ``node_uname_info`` when samples carry only ``instance``
   (`metrics.ts:119-124`).

Returns ``None`` when no Prometheus is reachable (`metrics.ts:97-98`) —
pages render the guided "install kube-prometheus/GMP" box, never crash.
"""

from __future__ import annotations

import re
import time
import urllib.parse
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

from ..obs.trace import span as _span
from ..transport.api_proxy import ApiError, Transport
from ..transport.pool import ConnectionPool, fanout, pool_of
from .timing import FetchTimer

# ---------------------------------------------------------------------------
# Service discovery
# ---------------------------------------------------------------------------

#: Candidate (namespace, service:port) pairs, probed in order. The chain
#: is a superset of the reference's (`metrics.ts:61-65` probes
#: kube-prometheus-stack-prometheus:9090, prometheus-operated:9090, and
#: prometheus:9090): it carries all three of those, adds the
#: prometheus-operator (prometheus-k8s) and Helm-chart
#: (prometheus-server) service names, and finishes with Google Managed
#: Prometheus's in-cluster query frontend — GMP is the default metrics
#: stack on the GKE clusters TPU fleets run on.
PROMETHEUS_SERVICES: tuple[tuple[str, str], ...] = (
    ("monitoring", "prometheus-k8s:9090"),
    ("monitoring", "kube-prometheus-stack-prometheus:9090"),
    ("monitoring", "prometheus-operated:9090"),
    ("monitoring", "prometheus:9090"),
    ("monitoring", "prometheus-server:80"),
    ("gmp-system", "frontend:9090"),
)


def _proxy_query_path(namespace: str, service: str, promql: str) -> str:
    """Apiserver service-proxy path for one instant query — the same
    route the reference uses (`metrics.ts:71-79`), so no direct network
    path to Prometheus is needed."""
    q = urllib.parse.quote(promql, safe="")
    return (
        f"/api/v1/namespaces/{namespace}/services/{service}"
        f"/proxy/api/v1/query?query={q}"
    )


def _proxy_range_path(
    namespace: str, service: str, promql: str, start: float, end: float, step_s: int
) -> str:
    """Service-proxy path for a range query (utilization history — feeds
    the forecaster; the reference has no range queries, its only
    windowing is the 5m rate() in PromQL `metrics.ts:106`)."""
    q = urllib.parse.quote(promql, safe="")
    return (
        f"/api/v1/namespaces/{namespace}/services/{service}"
        f"/proxy/api/v1/query_range?query={q}"
        f"&start={start:.0f}&end={end:.0f}&step={step_s}"
    )


def find_prometheus_path(
    transport: Transport, timeout_s: float = 2.0
) -> tuple[str, str] | None:
    """Probe the chain with ``query=1``; return the first working
    (namespace, service) or None. Always probes — use
    :func:`resolve_prometheus` on hot paths to amortize the chain."""
    for namespace, service in PROMETHEUS_SERVICES:
        try:
            data = transport.request(
                _proxy_query_path(namespace, service, "1"), timeout_s
            )
        except ApiError:
            continue
        if isinstance(data, Mapping) and data.get("status") == "success":
            return namespace, service
    return None


#: Discovered (namespace, service) per live transport. Weak keys: a
#: transport's cache entry dies with it, and tests' throwaway
#: MockTransports never accumulate. Positive results only — a cluster
#: with no Prometheus yet must keep getting re-probed (the app's own
#: metrics TTL bounds how often that happens).
_DISCOVERY_CACHE: "weakref.WeakKeyDictionary[Any, tuple[str, str]]" = (
    weakref.WeakKeyDictionary()
)


def cached_prometheus(transport: Transport) -> tuple[str, str] | None:
    """The cached discovery for ``transport``, without probing."""
    try:
        return _DISCOVERY_CACHE.get(transport)
    except TypeError:  # unhashable / non-weakrefable transport
        return None


def resolve_prometheus(
    transport: Transport, timeout_s: float = 2.0
) -> tuple[str, str] | None:
    """Cached :func:`find_prometheus_path`: the probe chain (up to 6
    serial round trips against a dark cluster) runs once per transport;
    every later call is a dict hit. :func:`invalidate_prometheus` drops
    the entry when the cached service stops answering (ADR-014)."""
    cached = cached_prometheus(transport)
    if cached is not None:
        return cached
    found = find_prometheus_path(transport, timeout_s)
    if found is not None:
        try:
            _DISCOVERY_CACHE[transport] = found
        except TypeError:
            pass
    return found


def invalidate_prometheus(transport: Transport) -> None:
    """Forget ``transport``'s cached discovery — next fetch re-probes."""
    try:
        _DISCOVERY_CACHE.pop(transport, None)
    except TypeError:
        pass


# ---------------------------------------------------------------------------
# Logical metrics and their candidate series
# ---------------------------------------------------------------------------

#: logical name -> candidate PromQL expressions, tried until one returns
#: a non-empty vector. Order: BASELINE.json's canonical names first, then
#: the GKE tpu-device-plugin's kubelet-style names, then libtpu exporter
#: variants.
LOGICAL_METRICS: dict[str, tuple[str, ...]] = {
    "tensorcore_utilization": (
        "tensorcore_utilization",
        "tpu_tensorcore_utilization",
        "kubernetes_io_node_accelerator_tensorcore_utilization",
    ),
    "memory_bandwidth_utilization": (
        "memory_bandwidth_utilization",
        "tpu_memory_bandwidth_utilization",
        "kubernetes_io_node_accelerator_memory_bandwidth_utilization",
    ),
    "hbm_bytes_used": (
        "hbm_bytes_used",
        "tpu_hbm_memory_usage_bytes",
        "memory_used{accelerator=~\"tpu.*\"}",
    ),
    "hbm_bytes_total": (
        "hbm_bytes_total",
        "tpu_hbm_memory_total_bytes",
        "memory_total{accelerator=~\"tpu.*\"}",
    ),
    "duty_cycle": (
        "duty_cycle{accelerator=~\"tpu.*\"}",
        "tpu_duty_cycle",
    ),
}

#: Instance→node mapping series, used when TPU samples carry only
#: ``instance`` (`metrics.ts:119-124` builds the same map from it).
NODE_MAP_QUERY = "node_uname_info"


# ---------------------------------------------------------------------------
# Batched scrape (ADR-015): matcher-joined instant queries
# ---------------------------------------------------------------------------

#: ``name`` or ``name{selector}`` — the only shapes our candidate
#: queries take. Anything fancier (functions, offsets) is unbatchable
#: and keeps its own request.
_SELECTOR_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?$")


def _parse_selector(promql: str) -> tuple[str, str] | None:
    """Split a simple series selector into (metric name, label selector
    body) — ``("duty_cycle", 'accelerator=~"tpu.*"')`` — or None when
    the expression is not a plain selector."""
    m = _SELECTOR_RE.match(promql)
    if m is None:
        return None
    return m.group(1), m.group(2) or ""


def batched_instant_queries(
    queries: list[str],
) -> list[tuple[str, dict[str, str]]]:
    """Union per-metric instant queries into matcher-joined batches:
    every candidate sharing a label selector collapses into ONE
    ``{__name__=~"a|b|c",selector}`` query, and the response demuxes
    back per metric by the ``__name__`` label. Our 16-query fan-out
    (15 candidates + node map) folds into 2 batches — the single
    biggest term in BENCH_r06's 28 HTTP requests per paint.

    Returns ``[(batched_promql, {series_name: original_promql})]`` in
    first-seen selector order; an unbatchable expression rides along as
    its own singleton batch so callers need no special case."""
    groups: dict[str, list[tuple[str, str]]] = {}
    order: list[str] = []
    out: list[tuple[str, dict[str, str]]] = []
    for promql in queries:
        parsed = _parse_selector(promql)
        if parsed is None:
            out.append((promql, {promql: promql}))
            continue
        name, selector = parsed
        if selector not in groups:
            groups[selector] = []
            order.append(selector)
        if all(name != n for n, _ in groups[selector]):
            groups[selector].append((name, promql))
    for selector in order:
        pairs = groups[selector]
        # Metric names are [a-zA-Z0-9_:] — no regex metacharacters —
        # so the alternation needs no escaping. Anchored: Prometheus
        # fully anchors __name__=~ itself.
        matcher = "__name__=~\"" + "|".join(n for n, _ in pairs) + "\""
        body = matcher + ("," + selector if selector else "")
        out.append(("{" + body + "}", {n: q for n, q in pairs}))
    return out


# ---------------------------------------------------------------------------
# Result model
# ---------------------------------------------------------------------------

@dataclass
class TpuChipMetrics:
    """One TPU chip's (or one host aggregate's) telemetry row — the
    analogue of ``GpuChipMetrics`` (`metrics.ts:21-32`). Fractions are
    normalized to 0-1; None means that series had no sample for this
    chip."""

    node: str
    accelerator_id: str
    tensorcore_utilization: float | None = None
    memory_bandwidth_utilization: float | None = None
    hbm_bytes_used: float | None = None
    hbm_bytes_total: float | None = None
    duty_cycle: float | None = None


@dataclass
class TpuMetricsSnapshot:
    """Everything the MetricsPage needs, including the honesty matrix:
    ``availability`` says which logical metrics actually returned data —
    rendered to the user exactly as the reference's Metric Availability
    section does (`MetricsPage.tsx:125-185`)."""

    namespace: str
    service: str
    chips: list[TpuChipMetrics] = field(default_factory=list)
    availability: dict[str, bool] = field(default_factory=dict)
    #: Which candidate expression satisfied each available metric —
    #: surfaced in diagnostics so operators know which exporter they run.
    resolved_series: dict[str, str] = field(default_factory=dict)
    fetched_at: float = 0.0
    #: Wall-clock cost of discovery + fan-out + join — the scrape→paint
    #: instrumentation the BASELINE <2s target is measured against
    #: (SURVEY.md §5 tracing carry-over).
    fetch_ms: float = 0.0

    @property
    def by_node(self) -> dict[str, list[TpuChipMetrics]]:
        out: dict[str, list[TpuChipMetrics]] = {}
        for chip in self.chips:
            out.setdefault(chip.node, []).append(chip)
        return out


# ---------------------------------------------------------------------------
# Fetch + join
# ---------------------------------------------------------------------------

def _vector_result(data: Any) -> list[Mapping[str, Any]]:
    """Extract a successful instant-query vector; anything else -> []."""
    if not isinstance(data, Mapping) or data.get("status") != "success":
        return []
    inner = data.get("data")
    if not isinstance(inner, Mapping) or inner.get("resultType") != "vector":
        return []
    result = inner.get("result")
    return [s for s in result if isinstance(s, Mapping)] if isinstance(result, list) else []


def _sample_value(sample: Mapping[str, Any]) -> float | None:
    value = sample.get("value")
    if not isinstance(value, (list, tuple)) or len(value) != 2:
        return None
    try:
        return float(value[1])
    except (TypeError, ValueError):
        return None


def _sample_labels(sample: Mapping[str, Any]) -> Mapping[str, str]:
    metric = sample.get("metric")
    return metric if isinstance(metric, Mapping) else {}


#: Label keys that may carry the node name, by exporter variant.
_NODE_LABELS = ("node", "node_name", "exported_node", "kubernetes_node")
#: Label keys that may carry the chip/accelerator identity.
_CHIP_LABELS = ("accelerator_id", "device", "chip", "tpu", "gpu")


def _node_of(labels: Mapping[str, str], instance_map: Mapping[str, str]) -> str:
    for key in _NODE_LABELS:
        if labels.get(key):
            return str(labels[key])
    instance = str(labels.get("instance", ""))
    if instance in instance_map:
        return instance_map[instance]
    # Strip the port: '10.0.0.7:9100' and '10.0.0.7:8431' are one host.
    host = instance.rsplit(":", 1)[0]
    return instance_map.get(host, host or "unknown")


def _chip_of(labels: Mapping[str, str]) -> str:
    for key in _CHIP_LABELS:
        if labels.get(key):
            return str(labels[key])
    return "0"


def _build_instance_map(samples: list[Mapping[str, Any]]) -> dict[str, str]:
    """instance (with and without port) -> nodename, from node_uname_info
    (`metrics.ts:119-124`)."""
    out: dict[str, str] = {}
    for s in samples:
        labels = _sample_labels(s)
        nodename = str(labels.get("nodename", ""))
        instance = str(labels.get("instance", ""))
        if nodename and instance:
            out[instance] = nodename
            out[instance.rsplit(":", 1)[0]] = nodename
    return out


_FRACTION_METRICS = (
    "tensorcore_utilization",
    "memory_bandwidth_utilization",
    "duty_cycle",
)

#: Per-series scale detection threshold. A genuine utilization fraction
#: is bounded by 1.0, so a sample clearly above it can only come from a
#: 0-100 exporter and the whole series is divided by 100 — including a
#: near-idle 0-100 series (max 1.3 ⇒ 1.3%) that the old >1.5 cutoff
#: left rendering as 130%. The margin above 1.0 is deliberately wide:
#: Prometheus ``rate()`` extrapolation can overshoot a saturated 0-1
#: chip past 1.0, and misreading that as percent would divide a
#: saturated fleet by 100 (hiding saturation) — a far worse error than
#: an idle percent-exporter in the residual (1.0, 1.2] band rendering
#: as the clamped 100% (see format_percent).
FRACTION_MAX = 1.2


def _strip_name_label(sample: Mapping[str, Any]) -> Mapping[str, Any]:
    """Demuxed sample minus its ``__name__`` label, for exact parity
    with what the corresponding per-metric query returns from the
    fixtures (the join itself never reads ``__name__``)."""
    labels = _sample_labels(sample)
    if "__name__" not in labels:
        return sample
    out = dict(sample)
    out["metric"] = {k: v for k, v in labels.items() if k != "__name__"}
    return out


def _fanout_batched(
    run_query: Callable[[str], list[Mapping[str, Any]]],
    queries: list[str],
    pool: ConnectionPool | None,
) -> dict[str, list[Mapping[str, Any]]]:
    """Run the instant-query fan-out as matcher-joined batches, demuxing
    per-candidate samples by ``__name__``. Batching saves requests and
    changes no answer: a batch that fails at the
    transport layer, returns non-success, or comes back EMPTY falls
    back to its member queries one by one — some frontends (GMP) are
    entitled to reject a cross-metric ``__name__`` regex, and an empty
    batch is indistinguishable from that rejection, so only the
    unbatched answer is treated as authoritative."""
    batches = batched_instant_queries(queries)
    batch_results = fanout.map(run_query, [b[0] for b in batches], pool=pool)
    results: dict[str, list[Mapping[str, Any]]] = {q: [] for q in queries}
    fallback: list[str] = []
    for (_, by_name), samples in zip(batches, batch_results):
        if not samples:
            fallback.extend(by_name.values())
            continue
        for sample in samples:
            target = by_name.get(str(_sample_labels(sample).get("__name__", "")))
            if target is not None:
                results[target].append(_strip_name_label(sample))
    if fallback:
        for q, r in zip(fallback, fanout.map(run_query, fallback, pool=pool)):
            results[q] = r
    return results


def fetch_tpu_metrics(
    transport: Transport,
    *,
    timeout_s: float = 2.0,
    clock: Callable[[], float] = time.time,
    prometheus: tuple[str, str] | None = None,
) -> TpuMetricsSnapshot | None:
    """Discover Prometheus (unless ``prometheus`` pins it; cached per
    transport otherwise), query all logical-metric candidates plus the
    node map as matcher-joined batches, and join into per-chip rows.
    None when no Prometheus answers."""
    timer = FetchTimer(clock)
    found = prometheus or resolve_prometheus(transport, timeout_s)
    if found is None:
        return None
    namespace, service = found

    transport_failures: list[str] = []
    issued: list[str] = []

    def run_query(promql: str) -> list[Mapping[str, Any]]:
        issued.append(promql)  # list.append is atomic under the GIL
        try:
            data = transport.request(
                _proxy_query_path(namespace, service, promql), timeout_s
            )
        except ApiError:
            transport_failures.append(promql)
            return []
        return _vector_result(data)

    # Every candidate of every logical metric plus the node map, batched
    # into matcher-joined queries (two requests instead of sixteen) and
    # fanned out, so one slow series costs max(latency), not the sum.
    # Candidate order still decides which result is used.
    queries: list[str] = [NODE_MAP_QUERY]
    for candidates in LOGICAL_METRICS.values():
        queries.extend(candidates)
    with _span("metrics.fanout", queries=len(queries), service=service):
        results = _fanout_batched(run_query, queries, pool_of(transport))

    if issued and len(transport_failures) == len(issued):
        # Every query actually issued (batched AND the per-metric
        # fallbacks) failed at the transport layer: the discovered
        # service is gone (rolled, rescheduled). Drop the cached
        # discovery so the next fetch re-probes the chain instead of
        # fanning out against a corpse forever.
        invalidate_prometheus(transport)

    instance_map = _build_instance_map(results[NODE_MAP_QUERY])

    chips: dict[tuple[str, str], TpuChipMetrics] = {}
    availability: dict[str, bool] = {}
    resolved: dict[str, str] = {}
    for logical, candidates in LOGICAL_METRICS.items():
        samples: list[Mapping[str, Any]] = []
        for promql in candidates:
            samples = results[promql]
            if samples:
                resolved[logical] = promql
                break
        availability[logical] = bool(samples)
        # Scale is decided ONCE per resolved series, mirroring the
        # range-query path (see fetch_utilization_history). A genuine
        # utilization *fraction* cannot exceed 1.0, so any sample above
        # FRACTION_MAX (1.0 plus rate-jitter allowance) proves a 0-100
        # exporter — including a near-idle one reporting 1.2 meaning
        # 1.2%. Only the (1.0, FRACTION_MAX] sliver stays ambiguous;
        # the render-time clamp in format_percent bounds that residue.
        scale = 1.0
        if logical in _FRACTION_METRICS and samples:
            values = [v for v in map(_sample_value, samples) if v is not None]
            if values and max(values) > FRACTION_MAX:
                scale = 100.0
        for sample in samples:
            labels = _sample_labels(sample)
            value = _sample_value(sample)
            if value is None:
                continue
            if logical in _FRACTION_METRICS:
                value = value / scale
            key = (_node_of(labels, instance_map), _chip_of(labels))
            row = chips.get(key)
            if row is None:
                row = chips[key] = TpuChipMetrics(node=key[0], accelerator_id=key[1])
            setattr(row, logical, value)

    ordered = sorted(chips.values(), key=lambda c: (c.node, c.accelerator_id))
    fetched_at, fetch_ms = timer.stamp()
    return TpuMetricsSnapshot(
        namespace=namespace,
        service=service,
        chips=ordered,
        availability=availability,
        resolved_series=resolved,
        fetched_at=fetched_at,
        fetch_ms=fetch_ms,
    )


# ---------------------------------------------------------------------------
# Utilization history (range queries) — forecaster input
# ---------------------------------------------------------------------------

@dataclass
class UtilizationHistory:
    """Aligned per-chip utilization traces: ``series[i]`` belongs to
    ``keys[i] = (node, accelerator_id)``; every row has ``n_samples``
    points ``step_s`` apart ending at ``end``. Gaps are forward-filled
    (Prometheus staleness already interpolates short ones)."""

    keys: list[tuple[str, str]]
    series: list[list[float]]
    step_s: int
    end: float
    resolved_query: str


#: Minimum fraction of grid points a trace must actually have before it
#: is used for forecasting — forward-filling a handful of fresh samples
#: into a full window would fabricate history (the honesty analogue of
#: the reference's '≥5m of scrape history' hint, `MetricsPage.tsx:105`).
MIN_REAL_SAMPLE_FRACTION = 0.5


def fetch_utilization_history(
    transport: Transport,
    *,
    prometheus: tuple[str, str],
    window_s: int = 3600,
    step_s: int = 60,
    timeout_s: float = 2.0,
    clock: Callable[[], float] = time.time,
    preferred_query: str | None = None,
) -> UtilizationHistory | None:
    """One range query per candidate series until one returns usable
    data. ``preferred_query`` (e.g. the instant fetch's
    ``resolved_series['tensorcore_utilization']``) is tried first so a
    page view doesn't re-walk candidates the instant path already
    eliminated. None when no candidate has enough real history."""
    namespace, service = prometheus
    # Wall clock ON PURPOSE (clock-skew audit, ADR-013): start/end are
    # Prometheus range-query bounds — epoch timestamps the server
    # interprets — not elapsed-time math. Monotonic belongs to
    # durations (fetch_ms uses perf_counter); never to these.
    end = clock()
    start = end - window_s
    n_samples = int(window_s // step_s) + 1
    min_real = max(3, int(n_samples * MIN_REAL_SAMPLE_FRACTION))

    # Node-name join map, same as the instant path (`metrics.ts:119-124`)
    # — forecast rows must key identically to the chip cards beside them.
    instance_map: dict[str, str] = {}
    try:
        data = transport.request(
            _proxy_query_path(namespace, service, NODE_MAP_QUERY), timeout_s
        )
        instance_map = _build_instance_map(_vector_result(data))
    except ApiError:
        pass

    candidates = list(
        LOGICAL_METRICS["tensorcore_utilization"] + LOGICAL_METRICS["duty_cycle"]
    )
    if preferred_query and preferred_query in candidates:
        candidates.remove(preferred_query)
        candidates.insert(0, preferred_query)

    for promql in candidates:
        try:
            data = transport.request(
                _proxy_range_path(namespace, service, promql, start, end, step_s),
                timeout_s,
            )
        except ApiError:
            continue
        if not isinstance(data, Mapping) or data.get("status") != "success":
            continue
        inner = data.get("data")
        if not isinstance(inner, Mapping) or inner.get("resultType") != "matrix":
            continue
        result = inner.get("result")
        if not isinstance(result, list) or not result:
            continue

        keys: list[tuple[str, str]] = []
        series: list[list[float]] = []
        for entry in result:
            if not isinstance(entry, Mapping):
                continue
            labels = _sample_labels(entry)
            key = (_node_of(labels, instance_map), _chip_of(labels))
            values = entry.get("values")
            if not isinstance(values, list):
                continue
            # Align onto the fixed grid, forward-filling short gaps.
            by_ts = {}
            for v in values:
                if isinstance(v, (list, tuple)) and len(v) == 2:
                    try:
                        by_ts[round(float(v[0]))] = float(v[1])
                    except (TypeError, ValueError):
                        continue
            if len(by_ts) < min_real:
                continue  # mostly-fabricated trace: skip, stay honest
            # Scale is decided ONCE per series: normalizing per sample
            # would mix scales within one trace from a 0-100 exporter
            # (an idle 0.9% sample passing the threshold unscaled while
            # busy samples get divided), fabricating saturation. Same
            # FRACTION_MAX rule as the instant path: fractions cannot
            # exceed 1.0, so anything above it proves a 0-100 exporter.
            scale = 100.0 if max(by_ts.values()) > FRACTION_MAX else 1.0
            grid: list[float] = []
            last = next(iter(by_ts.values()))
            for i in range(n_samples):
                ts = round(start + i * step_s)
                last = by_ts.get(ts, last)
                grid.append(last / scale)
            keys.append(key)
            series.append(grid)
        if series:
            return UtilizationHistory(
                keys=keys,
                series=series,
                step_s=step_s,
                end=end,
                resolved_query=promql,
            )
    return None

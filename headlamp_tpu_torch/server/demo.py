"""Demo mode: fixture fleets with synthetic Prometheus data.

The TPU part of ``headlamp_tpu/server/app.py``'s demo mode — the
zero-cluster path for demos, verification and the chip smoke run. The
series are the same deterministic functions of the fleet as the JAX
package's, so both packages serve identical metrics for a fleet. Also
the mode flags the server and the CLI share: a demo fleet, or a real
apiserver over ``KubeTransport``.
"""

from __future__ import annotations

import argparse
import math
import urllib.parse
from typing import Any

from ..fleet import fixtures as fx
from ..metrics.client import LOGICAL_METRICS, NODE_MAP_QUERY, batched_instant_queries
from ..transport.api_proxy import KubeTransport, MockTransport, Transport

#: Demo fleet name -> fixture generator.
DEMO_FLEETS = {
    "v5e4": fx.fleet_v5e4,
    "v5p32": fx.fleet_v5p32,
    "large": lambda: fx.fleet_large(1024),
}

_PROM = "/api/v1/namespaces/monitoring/services/prometheus-k8s:9090/proxy/api/v1"


def make_demo_transport(fleet_name: str = "v5p32") -> MockTransport:
    """MockTransport serving a fixture fleet plus synthetic Prometheus."""
    fleet = DEMO_FLEETS[fleet_name]()
    t = fx.fleet_transport(fleet)
    add_demo_prometheus(t, fleet)
    return t


def _vec(values: list[tuple[dict, float]]) -> dict:
    return {
        "status": "success",
        "data": {
            "resultType": "vector",
            "result": [{"metric": labels, "value": [0, str(v)]} for labels, v in values],
        },
    }


def add_demo_prometheus(t: MockTransport, fleet: dict[str, Any]) -> MockTransport:
    """Wire synthetic Prometheus (instant + range queries) for a fixture
    fleet onto an existing transport: utilization and HBM series for the
    first 64 TPU hosts' chips, and a utilization history for the first
    16 hosts' chips on exactly the requested grid."""

    def q(promql: str) -> str:
        return f"{_PROM}/query?query={urllib.parse.quote(promql, safe='')}"

    tpu_nodes = [
        n["metadata"]["name"]
        for n in fleet["nodes"]
        if "cloud.google.com/gke-tpu-accelerator" in n["metadata"].get("labels", {})
    ]

    GIB = 1024**3
    util, used, total = [], [], []
    for i, node in enumerate(tpu_nodes[:64]):
        for chip in range(4):
            labels = {"node": node, "accelerator_id": str(chip)}
            util.append((labels, round(0.35 + 0.13 * ((i * 4 + chip) % 5), 2)))
            used.append((labels, (8 + (i + chip) % 7) * GIB))
            total.append((labels, 16 * GIB))
    t.add(q("1"), {"status": "success", "data": {"resultType": "scalar", "result": [0, "1"]}})
    t.add(q("tensorcore_utilization"), _vec(util))
    t.add(q("hbm_bytes_used"), _vec(used))
    t.add(q("hbm_bytes_total"), _vec(total))

    # The client's scrape sends matcher-joined
    # `{__name__=~...}` queries; serve them the union of the same samples
    # with __name__ injected for the demux. Batches whose members have no
    # demo data stay unrouted, so the client re-asks per metric.
    demo_series: dict[str, list[tuple[dict, float]]] = {
        "tensorcore_utilization": util,
        "hbm_bytes_used": used,
        "hbm_bytes_total": total,
        NODE_MAP_QUERY: [],
    }
    batchable = [NODE_MAP_QUERY]
    for candidates in LOGICAL_METRICS.values():
        batchable.extend(candidates)
    for batched_promql, by_name in batched_instant_queries(batchable):
        samples = [
            ({**labels, "__name__": name}, v)
            for name in by_name
            for labels, v in demo_series.get(name, [])
        ]
        if samples:
            t.add(q(batched_promql), _vec(samples))

    def range_response(path: str) -> dict:
        query = urllib.parse.parse_qs(urllib.parse.urlparse(path).query)
        if "tensorcore_utilization" not in urllib.parse.unquote(query["query"][0]):
            return {"status": "success", "data": {"resultType": "matrix", "result": []}}
        start = float(query["start"][0])
        end = float(query["end"][0])
        step = int(query["step"][0])
        result = []
        for i, node in enumerate(tpu_nodes[:16]):
            for chip in range(4):
                base = 0.4 + 0.1 * ((i + chip) % 3)
                values = []
                ts = start
                while ts <= end:
                    v = base + 0.25 * math.sin(ts / 600 + i + chip) + 0.15 * math.sin(
                        ts / 150 + chip
                    )
                    values.append([ts, f"{min(max(v, 0.0), 1.0):.4f}"])
                    ts += step
                result.append(
                    {
                        "metric": {"node": node, "accelerator_id": str(chip)},
                        "values": values,
                    }
                )
        return {"status": "success", "data": {"resultType": "matrix", "result": result}}

    # Registered BEFORE the generic /query prefix: prefix routes match in
    # insertion order and '…/query' is a prefix of '…/query_range'.
    t.add_prefix(f"{_PROM}/query_range", range_response)
    t.add_prefix(f"{_PROM}/query", _vec([]))
    return t


def transport_from_args(
    parser: argparse.ArgumentParser, args: argparse.Namespace
) -> tuple[Transport, str]:
    """The transport the mode flags name and a label for it: one of
    ``--demo``, ``--apiserver`` and ``--in-cluster`` (the demo fleet
    ``v5p32`` when none is given)."""
    modes = [bool(args.demo), bool(args.apiserver), bool(args.in_cluster)]
    if sum(modes) > 1:
        parser.error("choose one of --demo, --apiserver URL, --in-cluster")
    if args.in_cluster:
        return KubeTransport.in_cluster(), "in-cluster"
    if args.apiserver:
        return KubeTransport(args.apiserver), args.apiserver
    demo = args.demo or "v5p32"
    return make_demo_transport(demo), f"demo fleet '{demo}'"


def add_mode_arguments(parser: argparse.ArgumentParser) -> None:
    """``--demo [FLEET]``, ``--apiserver URL`` and ``--in-cluster``."""
    parser.add_argument("--demo", nargs="?", const="v5p32", choices=sorted(DEMO_FLEETS), default=None)
    parser.add_argument("--apiserver", default=None, help="kube-apiserver base URL (e.g. kubectl proxy)")
    parser.add_argument("--in-cluster", action="store_true", help="service-account auth inside a pod")

"""The plain reference of the cluster pages: the facts every page shows.

Worked out from the fleet the run drew from its seed, by the dashboard's
stated rules, with plain Python loops and no code of the program:

- a node is ready when its ``Ready`` condition is ``True``; its chips are
  the ``google.com/tpu`` capacity and allocatable;
- a region is a cluster (the ``headlamp.io/cluster`` label) or one of its
  slices (the GKE node pool); its chips in use are the TPU requests of
  the Running pods bound to its nodes, its pending pods the Pending pods
  bound to them;
- a pod's chips are the sum of its containers' ``google.com/tpu``
  requests (limits where a request is absent);
- node windows list not-ready nodes first, then by name.

The check of each page is a file of its own, ``reference/pages/<route>.py``,
with a ``check(mismatches, facts, path, body)`` function.

``counts`` gives the type the sums are accumulated in: exact integers by
default, or a narrower float type for the control, which breaks the
configuration's guarantee of exact counts.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from . import html as H

TPU = "google.com/tpu"
ACCEL = "cloud.google.com/gke-tpu-accelerator"
TOPOLOGY = "cloud.google.com/gke-tpu-topology"
POOL = "cloud.google.com/gke-nodepool"
WORKER = "cloud.google.com/gke-tpu-worker-id"
CLUSTER = "headlamp.io/cluster"

#: The generation an accelerator label names, as the pages show it.
GENERATIONS = {
    "tpu-v4-podslice": "TPU v4",
    "tpu-v5-lite-podslice": "TPU v5e",
    "tpu-v5-lite-device": "TPU v5e",
    "tpu-v5p-slice": "TPU v5p",
    "tpu-v6e-slice": "TPU v6e",
}


def _int(v: Any) -> int:
    try:
        return int(str(v))
    except ValueError:
        return 0


def pod_chips(pod: dict[str, Any]) -> int:
    total = 0
    for c in pod.get("spec", {}).get("containers", []):
        res = c.get("resources", {})
        total += _int(res.get("requests", {}).get(TPU, res.get("limits", {}).get(TPU, 0)))
    return total


@dataclass
class Node:
    name: str
    ready: bool
    capacity: int
    allocatable: int
    accel: str | None
    topology: str | None
    cluster: str
    pool: str | None
    worker: str | None
    pods: list[dict[str, Any]] = field(default_factory=list)

    @property
    def in_use(self) -> int:
        return sum(pod_chips(p) for p in self.pods if p["status"]["phase"] == "Running")


class Facts:
    """The fleet, indexed, with every region's sums."""

    def __init__(self, fleet: dict[str, Any], counts: Callable[[list[int]], int] | None = None) -> None:
        self.sum = counts or (lambda xs: int(sum(xs)))
        self.nodes: dict[str, Node] = {}
        for n in fleet["nodes"]:
            labels = n["metadata"].get("labels", {})
            conds = n.get("status", {}).get("conditions", [])
            self.nodes[n["metadata"]["name"]] = Node(
                name=n["metadata"]["name"],
                ready=any(c.get("type") == "Ready" and c.get("status") == "True" for c in conds),
                capacity=_int(n["status"]["capacity"].get(TPU, 0)),
                allocatable=_int(n["status"]["allocatable"].get(TPU, 0)),
                accel=labels.get(ACCEL),
                topology=labels.get(TOPOLOGY),
                cluster=labels.get(CLUSTER) or "0",
                pool=labels.get(POOL),
                worker=labels.get(WORKER),
            )
        self.pods: dict[tuple[str, str], dict[str, Any]] = {}
        for p in fleet["pods"]:
            self.pods[(p["metadata"]["namespace"], p["metadata"]["name"])] = p
            node = self.nodes.get(p.get("spec", {}).get("nodeName") or "")
            if node is not None:
                node.pods.append(p)

        self.by_region: dict[tuple[str, str | None], list[Node]] = {}
        for n in self.nodes.values():
            if n.accel:
                self.by_region.setdefault((n.cluster, None), []).append(n)
                self.by_region.setdefault((n.cluster, n.pool), []).append(n)

    def region(self, cluster: str, pool: str | None = None) -> dict[str, int]:
        return self.stats(self.by_region.get((cluster, pool), []))

    def fleet_stats(self) -> dict[str, int]:
        return self.stats([n for n in self.nodes.values() if n.accel])

    def stats(self, members: list[Node]) -> dict[str, int]:
        pending = [
            1 for n in members for p in n.pods if p["status"]["phase"] == "Pending"
        ]
        return {
            "nodes": self.sum([1 for _ in members]),
            "ready": self.sum([1 for n in members if n.ready]),
            "capacity": self.sum([n.capacity for n in members]),
            "allocatable": self.sum([n.allocatable for n in members]),
            "in_use": self.sum([n.in_use for n in members]),
            "pending": self.sum(pending),
        }

    def clusters(self) -> list[str]:
        return sorted({c for c, p in self.by_region if p is None})

    def slices(self, cluster: str) -> list[str]:
        return sorted({p for c, p in self.by_region if c == cluster and p is not None})


def half_counts(xs: list[int]) -> int:
    """The control's accumulation: float16, as a narrower counter would
    add. Above 2048 it cannot hold every integer."""
    acc = np.float16(0)
    for x in xs:
        acc = np.float16(acc + np.float16(x))
    return int(acc) if np.isfinite(acc) else -1


def ratio(label: str) -> str:
    m = re.match(r"(\d+)/(\d+)", label)
    return f"{m.group(1)}/{m.group(2)}" if m else label


def node_order(nodes: list[Node]) -> list[Node]:
    return sorted(nodes, key=lambda n: (n.ready, n.name))


class Mismatches:
    """Fields a page shows otherwise than the reference; each is counted."""

    def __init__(self) -> None:
        self.items: list[str] = []

    def check(self, where: str, what: str, shown: Any, expected: Any) -> None:
        if str(shown) != str(expected):
            self.items.append(f"{where}: {what} shows {shown!r}, expected {expected!r}")


def check_pairs(m: Mismatches, where: str, shown: list[tuple[str, str]],
                expected: dict[str, Any]) -> None:
    got = dict(shown)
    for key, value in expected.items():
        m.check(where, key, got.get(key), value)


def check_fleet_page(m: Mismatches, facts: Facts, path: str, body: str) -> None:
    main = H.main(body)
    region = re.search(r"[?&]region=([^&]*)", path)
    parts = region.group(1).split("/") if region else []
    pairs = H.pairs(main)
    tables = H.tables(main)
    if not parts:
        s = facts.fleet_stats()
        check_pairs(m, path, pairs, {
            "Clusters": len(facts.clusters()), "Nodes": s["nodes"],
            "Ready": f"{s['ready']}/{s['nodes']}", "Chips (capacity)": s["capacity"],
            "Chips in use": s["in_use"], "Pending pods": s["pending"],
        })
        expected_rows = {c: facts.region(c) for c in facts.clusters()}
    elif len(parts) == 2:
        c = parts[1]
        s = facts.region(c)
        check_pairs(m, path, pairs, {
            "Slices": len(facts.slices(c)), "Nodes": s["nodes"],
            "Ready": f"{s['ready']}/{s['nodes']}", "Chips in use": s["in_use"],
            "Pending pods": s["pending"],
        })
        expected_rows = {p: facts.region(c, p) for p in facts.slices(c)}
    else:
        c, pool = parts[1], parts[3]
        s = facts.region(c, pool)
        check_pairs(m, path, pairs, {
            "Nodes": s["nodes"], "Ready": f"{s['ready']}/{s['nodes']}",
            "Chips (capacity)": s["capacity"], "Chips in use": s["in_use"],
            "Pending pods": s["pending"],
        })
        members = node_order(facts.by_region.get((c, pool), []))
        rows = tables[0][1:] if tables else []
        m.check(path, "rows", len(rows), min(len(members), 64))
        for row, node in zip(rows, members):
            m.check(path, "row", row[:4], [
                node.name, "Ready" if node.ready else "Not Ready", str(node.capacity),
                str(node.worker),
            ])
        return
    rows = {r[0]: r for r in (tables[0][1:] if tables else [])}
    m.check(path, "rows", len(rows), len(expected_rows))
    for key, s in expected_rows.items():
        row = rows.get(key)
        if row is None:
            m.check(path, f"row {key}", None, "present")
            continue
        m.check(path, f"row {key}", [row[1], row[2], row[3], ratio(row[4]), row[5]], [
            str(s["nodes"]), f"{s['ready']}/{s['nodes']}", str(s["capacity"]),
            f"{s['in_use']}/{s['capacity']}", str(s["pending"]),
        ])

"""The drill-down fleet: a frozen copy of the port's ``fleet_viewport``.

A test holds it equal to the program's at the program's default seed;
the benchmark draws it with a seed taken from ``--seed``.
"""

from __future__ import annotations

import random
from typing import Any

from .objects import make_plugin_daemonset, make_tpu_node, make_tpu_pod


def make(
    n_nodes: int = 16384, seed: int = 7, clusters: int = 8
) -> dict[str, Any]:
    """The drill-down fleet. Every node is a TPU host stamped with a
    :data:`HEADLAMP_CLUSTER_LABEL` value and a node pool, so the viewport
    tree has real structure at every level: ``clusters`` clusters ×
    ~32-host slices × 4 chips. Exactly 3 pods per 4 nodes, so the
    encoder's power-of-two buckets come out SQUARE — (1024,1024),
    (4096,4096), (16384,16384). Deterministic like every generator
    here."""
    rng = random.Random(seed)
    nodes: list[dict[str, Any]] = []
    pods: list[dict[str, Any]] = []
    slice_hosts = 32

    i = 0
    while len(nodes) < n_nodes:
        cluster = str(i % clusters)
        pool = f"c{cluster}-slice-{i // clusters}"
        for w in range(min(slice_hosts, n_nodes - len(nodes))):
            nodes.append(
                make_tpu_node(
                    f"gke-c{cluster}-s{i // clusters}-w{w}",
                    pool=pool,
                    cluster=cluster,
                    accelerator="tpu-v5-lite-podslice",
                    topology="4x8",
                    chips=4,
                    worker_id=w,
                    ready=rng.random() > 0.02,
                    age_seconds=rng.randrange(3600, 3600 * 24 * 30),
                )
            )
        i += 1

    phases = ["Running"] * 8 + ["Pending", "Failed"]
    for j in range(len(nodes)):
        # Exactly 3 pods per 4 nodes: the pod count lands in the same
        # power-of-two bucket as the node count.
        if j % 4 == 3:
            continue
        phase = rng.choice(phases)
        pods.append(
            make_tpu_pod(
                f"vp-workload-{j}",
                namespace=f"team-{j % 5}",
                node=nodes[j]["metadata"]["name"] if phase != "Pending" else None,
                chips=4,
                phase=phase,
                age_seconds=rng.randrange(60, 3600 * 24 * 7),
                waiting_reason="Unschedulable" if phase == "Pending" else None,
            )
        )

    return {
        "nodes": nodes,
        "pods": pods,
        "daemonsets": [make_plugin_daemonset(desired=len(nodes))],
    }

"""Fleet fixture generators for the TPU and mixed configurations.

The fleets of ``headlamp_tpu/fleet/fixtures.py``, generated the same
way (seeded, fixed clock), so the port and the JAX package see identical
objects:

- ``fleet_v5e4``   — GKE v5e-4 single-host node pool
- ``fleet_v5p32``  — v5p-32 multi-host pod slice: 16 chips over 4 hosts
- ``fleet_v5p32_degraded`` — the same slice after a host drop
- ``fleet_mixed``  — Intel Arc dGPU nodes + v5e nodes in one cluster
- ``fleet_large``  — deterministic 1024-node stress fleet
- ``fleet_viewport`` — the drill-down fleet: TPU hosts in labelled
                     clusters of 32-host slices (16384 by default)
"""

from __future__ import annotations

import copy
import random
from typing import Any

from ..domain.constants import (
    GKE_NODEPOOL_LABEL,
    GKE_TPU_ACCELERATOR_LABEL,
    GKE_TPU_TOPOLOGY_LABEL,
    GKE_TPU_WORKER_ID_LABEL,
    HEADLAMP_CLUSTER_LABEL,
    TPU_PLUGIN_NAMESPACE,
    TPU_RESOURCE,
)
from ..transport.api_proxy import MockTransport

#: Fixed "now" for deterministic ages: 2026-07-29T00:00:00Z.
FIXTURE_NOW_EPOCH = 1785283200.0


def _ts(age_seconds: int) -> str:
    import datetime

    dt = datetime.datetime.fromtimestamp(
        FIXTURE_NOW_EPOCH - age_seconds, tz=datetime.timezone.utc
    )
    return dt.strftime("%Y-%m-%dT%H:%M:%SZ")


# ---------------------------------------------------------------------------
# Objects
# ---------------------------------------------------------------------------

def make_tpu_node(
    name: str,
    *,
    pool: str | None = None,
    accelerator: str = "tpu-v5-lite-podslice",
    topology: str | None = "2x2",
    chips: int = 4,
    ready: bool = True,
    worker_id: int | None = None,
    age_seconds: int = 3600 * 24,
    uid: str | None = None,
    cluster: str | None = None,
) -> dict[str, Any]:
    labels: dict[str, str] = {GKE_TPU_ACCELERATOR_LABEL: accelerator}
    if topology:
        labels[GKE_TPU_TOPOLOGY_LABEL] = topology
    if pool:
        labels[GKE_NODEPOOL_LABEL] = pool
    if worker_id is not None:
        labels[GKE_TPU_WORKER_ID_LABEL] = str(worker_id)
    if cluster is not None:
        labels[HEADLAMP_CLUSTER_LABEL] = cluster
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {
            "name": name,
            "uid": uid or f"uid-node-{name}",
            "labels": labels,
            "creationTimestamp": _ts(age_seconds),
        },
        "status": {
            "capacity": {"cpu": "96", "memory": "407Gi", TPU_RESOURCE: str(chips)},
            "allocatable": {"cpu": "95", "memory": "400Gi", TPU_RESOURCE: str(chips)},
            "conditions": [{"type": "Ready", "status": "True" if ready else "False"}],
            "nodeInfo": {
                "osImage": "Container-Optimized OS from Google",
                "kernelVersion": "6.1.0-gke",
                "kubeletVersion": "v1.30.2-gke",
                "architecture": "amd64",
            },
        },
    }


def make_plain_node(name: str, *, age_seconds: int = 3600 * 24) -> dict[str, Any]:
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {
            "name": name,
            "uid": f"uid-node-{name}",
            "labels": {},
            "creationTimestamp": _ts(age_seconds),
        },
        "status": {
            "capacity": {"cpu": "8", "memory": "32Gi"},
            "allocatable": {"cpu": "8", "memory": "31Gi"},
            "conditions": [{"type": "Ready", "status": "True"}],
        },
    }


def make_intel_node(
    name: str,
    *,
    gpus: int = 1,
    discrete: bool = True,
    ready: bool = True,
    age_seconds: int = 3600 * 24,
) -> dict[str, Any]:
    labels = {"intel.feature.node.kubernetes.io/gpu": "true"}
    if discrete:
        labels["node-role.kubernetes.io/gpu"] = "true"
    else:
        labels["node-role.kubernetes.io/igpu"] = "true"
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {
            "name": name,
            "uid": f"uid-node-{name}",
            "labels": labels,
            "creationTimestamp": _ts(age_seconds),
        },
        "status": {
            "capacity": {"cpu": "16", "memory": "64Gi", "gpu.intel.com/i915": str(gpus)},
            "allocatable": {"cpu": "16", "memory": "62Gi", "gpu.intel.com/i915": str(gpus)},
            "conditions": [{"type": "Ready", "status": "True" if ready else "False"}],
        },
    }


def make_tpu_pod(
    name: str,
    *,
    namespace: str = "default",
    node: str | None = None,
    chips: int = 4,
    phase: str = "Running",
    ready: bool | None = None,
    restarts: int = 0,
    age_seconds: int = 3600,
    waiting_reason: str | None = None,
) -> dict[str, Any]:
    if ready is None:
        ready = phase == "Running"
    state: dict[str, Any] = {}
    if waiting_reason:
        state = {"waiting": {"reason": waiting_reason}}
    elif phase == "Running":
        state = {"running": {"startedAt": _ts(age_seconds)}}
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "uid": f"uid-pod-{namespace}-{name}",
            "labels": {"app": "training"},
            "creationTimestamp": _ts(age_seconds),
        },
        "spec": {
            "nodeName": node,
            "containers": [
                {
                    "name": "worker",
                    "image": "example/jax-train:latest",
                    "resources": {
                        "requests": {TPU_RESOURCE: str(chips)},
                        "limits": {TPU_RESOURCE: str(chips)},
                    },
                }
            ],
        },
        "status": {
            "phase": phase,
            "conditions": [{"type": "Ready", "status": "True" if ready else "False"}],
            "containerStatuses": [
                {
                    "name": "worker",
                    "ready": ready,
                    "restartCount": restarts,
                    **({"state": state} if state else {}),
                }
            ],
        },
    }


def make_intel_pod(
    name: str,
    *,
    namespace: str = "default",
    node: str | None = None,
    gpus: int = 1,
    phase: str = "Running",
    age_seconds: int = 3600,
) -> dict[str, Any]:
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "uid": f"uid-pod-{namespace}-{name}",
            "creationTimestamp": _ts(age_seconds),
        },
        "spec": {
            "nodeName": node,
            "containers": [
                {
                    "name": "app",
                    "resources": {
                        "requests": {"gpu.intel.com/i915": str(gpus)},
                        "limits": {"gpu.intel.com/i915": str(gpus)},
                    },
                }
            ],
        },
        "status": {
            "phase": phase,
            "conditions": [{"type": "Ready", "status": "True" if phase == "Running" else "False"}],
            "containerStatuses": [{"name": "app", "ready": phase == "Running", "restartCount": 0}],
        },
    }


def make_plugin_pod(
    name: str,
    *,
    provider: str = "tpu",
    node: str | None = None,
    ready: bool = True,
    restarts: int = 0,
    age_seconds: int = 3600 * 48,
) -> dict[str, Any]:
    if provider == "tpu":
        labels = {"k8s-app": "tpu-device-plugin"}
        namespace = TPU_PLUGIN_NAMESPACE
    else:
        labels = {"app": "intel-gpu-plugin"}
        namespace = "inteldeviceplugins-system"
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "uid": f"uid-pod-{namespace}-{name}",
            "labels": labels,
            "creationTimestamp": _ts(age_seconds),
        },
        "spec": {"nodeName": node, "containers": [{"name": "device-plugin"}]},
        "status": {
            "phase": "Running",
            "conditions": [{"type": "Ready", "status": "True" if ready else "False"}],
            "containerStatuses": [
                {"name": "device-plugin", "ready": ready, "restartCount": restarts}
            ],
        },
    }


def make_plugin_daemonset(
    *, desired: int = 1, ready: int | None = None, unavailable: int = 0
) -> dict[str, Any]:
    if ready is None:
        ready = desired
    return {
        "apiVersion": "apps/v1",
        "kind": "DaemonSet",
        "metadata": {
            "name": "tpu-device-plugin",
            "namespace": TPU_PLUGIN_NAMESPACE,
            "uid": "uid-ds-tpu-device-plugin",
            "creationTimestamp": _ts(3600 * 72),
        },
        "status": {
            "desiredNumberScheduled": desired,
            "numberReady": ready,
            "numberUnavailable": unavailable,
            "numberAvailable": ready,
        },
    }


def make_intel_crd(
    name: str = "gpudeviceplugin-sample",
    *,
    desired: int = 1,
    ready: int | None = None,
    shared_dev_num: int = 1,
    age_seconds: int = 3600 * 72,
) -> dict[str, Any]:
    """A GpuDevicePlugin CR shaped like the reference's domain model
    (`src/api/k8s.ts:56-80`)."""
    if ready is None:
        ready = desired
    return {
        "apiVersion": "deviceplugin.intel.com/v1",
        "kind": "GpuDevicePlugin",
        "metadata": {
            "name": name,
            "uid": f"uid-crd-{name}",
            "creationTimestamp": _ts(age_seconds),
        },
        "spec": {
            "image": "intel/intel-gpu-plugin:0.30.0",
            "sharedDevNum": shared_dev_num,
            "preferredAllocationPolicy": "balanced",
            "enableMonitoring": True,
            "nodeSelector": {"intel.feature.node.kubernetes.io/gpu": "true"},
        },
        "status": {
            "desiredNumberScheduled": desired,
            "numberReady": ready,
        },
    }


def fleet_transport(fleet: dict[str, Any]) -> MockTransport:
    """MockTransport serving a fixture fleet on the URL surface the
    dashboard lists: the node and pod lists as watchable lists (limit /
    continue pagination plus the watch-delta protocol; their feeds are
    ``t.node_feed`` and ``t.pod_feed``, for scenarios that mutate the
    fleet mid-run), the TPU device-plugin daemonsets and, where the
    fleet has them, the Intel GpuDevicePlugin CRs."""
    t = MockTransport()
    t.node_feed = t.add_watchable_list("/api/v1/nodes", fleet["nodes"])
    t.pod_feed = t.add_watchable_list("/api/v1/pods", fleet["pods"])
    t.add(
        "/apis/apps/v1/daemonsets?labelSelector=k8s-app%3Dtpu-device-plugin",
        {"kind": "List", "items": fleet.get("daemonsets", [])},
    )
    if "gpudeviceplugins" in fleet:
        t.add(
            "/apis/deviceplugin.intel.com/v1/gpudeviceplugins",
            {"kind": "List", "items": fleet["gpudeviceplugins"]},
        )
    return t


# ---------------------------------------------------------------------------
# BASELINE config fleets
# ---------------------------------------------------------------------------

def fleet_v5e4() -> dict[str, Any]:
    """Config #2: one v5e-4 single-host node (2x2 topology, 4 chips)."""
    node = make_tpu_node(
        "gke-tpu-v5e-pool-a1b2", pool="v5e-pool",
        accelerator="tpu-v5-lite-podslice", topology="2x2", chips=4,
    )
    pods = [
        make_tpu_pod("train-step-0", node=node["metadata"]["name"], chips=4),
        make_tpu_pod("eval-job", node=None, chips=4, phase="Pending",
                     waiting_reason="Unschedulable"),
    ]
    plugin = make_plugin_pod("tpu-device-plugin-x1", node=node["metadata"]["name"])
    return {
        "nodes": [node, make_plain_node("gke-default-pool-c3d4")],
        "pods": pods + [plugin],
        "daemonsets": [make_plugin_daemonset(desired=1)],
    }


def fleet_v5p32() -> dict[str, Any]:
    """Config #3: v5p-32 multi-host pod slice — 16 chips (32 TensorCores)
    over 4 hosts of 4 chips, 2x2x4 topology."""
    nodes = [
        make_tpu_node(
            f"gke-v5p-pool-w{i}", pool="v5p-pool",
            accelerator="tpu-v5p-slice", topology="2x2x4", chips=4,
            worker_id=i, ready=(i != 3),
        )
        for i in range(4)
    ]
    pods = [
        make_tpu_pod(f"megatrain-{i}", namespace="ml", node=nodes[i]["metadata"]["name"], chips=4)
        for i in range(3)
    ]
    plugins = [
        make_plugin_pod(f"tpu-device-plugin-{i}", node=nodes[i]["metadata"]["name"])
        for i in range(4)
    ]
    return {
        "nodes": nodes + [make_plain_node("gke-default-pool-e5f6")],
        "pods": pods + plugins,
        "daemonsets": [make_plugin_daemonset(desired=4)],
    }


def fleet_v5p32_degraded() -> dict[str, Any]:
    """The v5p-32 slice after a host drop: worker 3 gone entirely and
    worker 2 NotReady — an incomplete multi-host slice, whose health
    outranks mere unreadiness."""
    fleet = copy.deepcopy(fleet_v5p32())
    fleet["nodes"] = [
        n for n in fleet["nodes"] if n["metadata"]["name"] != "gke-v5p-pool-w3"
    ]
    for n in fleet["nodes"]:
        if n["metadata"]["name"] == "gke-v5p-pool-w2":
            for c in n.get("status", {}).get("conditions", []):
                if c.get("type") == "Ready":
                    c["status"] = "False"
    return fleet


def fleet_mixed() -> dict[str, Any]:
    """Intel Arc dGPU nodes + v5e nodes in one cluster."""
    tpu_nodes = [
        make_tpu_node(
            f"gke-v5e16-pool-w{i}", pool="v5e16-pool",
            accelerator="tpu-v5-lite-podslice", topology="4x4", chips=4,
        )
        for i in range(4)
    ]
    intel_nodes = [
        make_intel_node("arc-node-1", gpus=2),
        make_intel_node("arc-node-2", gpus=1, discrete=True, ready=False),
    ]
    pods = [
        make_tpu_pod("llm-shard-0", namespace="ml", node=tpu_nodes[0]["metadata"]["name"], chips=4),
        make_tpu_pod("llm-shard-1", namespace="ml", node=tpu_nodes[1]["metadata"]["name"], chips=4),
        make_intel_pod("transcode-1", node="arc-node-1", gpus=1),
        make_intel_pod("transcode-2", node="arc-node-1", gpus=1, phase="Pending"),
    ]
    plugins = [
        make_plugin_pod("tpu-device-plugin-a", node=tpu_nodes[0]["metadata"]["name"]),
        make_plugin_pod("intel-gpu-plugin-a", provider="intel", node="arc-node-1"),
    ]
    return {
        "nodes": tpu_nodes + intel_nodes + [make_plain_node("gke-default-pool-m1")],
        "pods": pods + plugins,
        "daemonsets": [make_plugin_daemonset(desired=4)],
        "gpudeviceplugins": [make_intel_crd(desired=2)],
    }


def fleet_large(n_nodes: int = 1024, seed: int = 42) -> dict[str, Any]:
    """Config #5: deterministic stress fleet. ~1/8 plain nodes; the rest
    TPU hosts spread over multi-host v5e-16 / v5p pools plus single-host
    v5e and v6e pools, with a pod population exercising every phase."""
    rng = random.Random(seed)
    nodes: list[dict[str, Any]] = []
    pods: list[dict[str, Any]] = []

    pool_idx = 0
    while len(nodes) < n_nodes:
        remaining = n_nodes - len(nodes)
        kind = rng.random()
        if remaining >= 8 and kind < 0.35:
            # v5e-16 multi-host pool: 4 hosts x 4 chips.
            pool = f"v5e16-pool-{pool_idx}"
            for w in range(4):
                nodes.append(
                    make_tpu_node(
                        f"gke-{pool}-w{w}", pool=pool,
                        accelerator="tpu-v5-lite-podslice", topology="4x4",
                        chips=4, worker_id=w,
                        ready=rng.random() > 0.03,
                        age_seconds=rng.randrange(3600, 3600 * 24 * 30),
                    )
                )
        elif remaining >= 8 and kind < 0.55:
            # v5p pool: 8 hosts x 4 chips, 2x4x4 topology.
            pool = f"v5p-pool-{pool_idx}"
            for w in range(8):
                nodes.append(
                    make_tpu_node(
                        f"gke-{pool}-w{w}", pool=pool,
                        accelerator="tpu-v5p-slice", topology="2x4x4",
                        chips=4, worker_id=w,
                        ready=rng.random() > 0.03,
                        age_seconds=rng.randrange(3600, 3600 * 24 * 30),
                    )
                )
        elif kind < 0.85:
            # Single-host v5e / v6e node. Chips follow the topology — a
            # "2x4" single host carries exactly 8 chips on GKE; drawing
            # them independently would fabricate impossible slices.
            accel = "tpu-v6e-slice" if rng.random() < 0.4 else "tpu-v5-lite-podslice"
            pool = f"single-pool-{pool_idx}"
            topology = rng.choice(["2x2", "2x4", "1x1"])
            chips = {"1x1": 1, "2x2": 4, "2x4": 8}[topology]
            nodes.append(
                make_tpu_node(
                    f"gke-{pool}-x0", pool=pool, accelerator=accel,
                    topology=topology, chips=chips,
                    ready=rng.random() > 0.02,
                    age_seconds=rng.randrange(3600, 3600 * 24 * 30),
                )
            )
        else:
            nodes.append(make_plain_node(f"gke-cpu-pool-n{pool_idx}"))
        pool_idx += 1

    nodes = nodes[:n_nodes]
    tpu_node_names = [
        n["metadata"]["name"]
        for n in nodes
        if GKE_TPU_ACCELERATOR_LABEL in n["metadata"]["labels"]
    ]

    phases = ["Running"] * 7 + ["Pending", "Succeeded", "Failed"]
    for i, node_name in enumerate(tpu_node_names):
        if rng.random() < 0.7:
            phase = rng.choice(phases)
            pods.append(
                make_tpu_pod(
                    f"workload-{i}", namespace=f"team-{i % 7}",
                    node=node_name if phase != "Pending" else None,
                    chips=rng.choice([1, 4, 4, 8]),
                    phase=phase,
                    restarts=rng.choice([0, 0, 0, 1, 3]),
                    age_seconds=rng.randrange(60, 3600 * 24 * 7),
                    waiting_reason="Unschedulable" if phase == "Pending" else None,
                )
            )
        if rng.random() < 0.995:
            pods.append(make_plugin_pod(f"tpu-device-plugin-{i}", node=node_name))

    return {
        "nodes": nodes,
        "pods": pods,
        "daemonsets": [make_plugin_daemonset(desired=len(tpu_node_names))],
    }


def fleet_viewport(
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

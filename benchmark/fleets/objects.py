"""Kubernetes objects as the fleet generators make them: frozen copies of
the port's fixture makers (``fleet/fixtures.py``), so the benchmark's
fleets never move when the program's fixtures do.

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Any

TPU_RESOURCE = "google.com/tpu"
GKE_TPU_ACCELERATOR_LABEL = "cloud.google.com/gke-tpu-accelerator"
GKE_TPU_TOPOLOGY_LABEL = "cloud.google.com/gke-tpu-topology"
GKE_NODEPOOL_LABEL = "cloud.google.com/gke-nodepool"
GKE_TPU_WORKER_ID_LABEL = "cloud.google.com/gke-tpu-worker-id"
HEADLAMP_CLUSTER_LABEL = "headlamp.io/cluster"
TPU_PLUGIN_NAMESPACE = "kube-system"

#: Fixed "now" for deterministic ages: 2026-07-29T00:00:00Z.
FIXTURE_NOW_EPOCH = 1785283200.0


def _ts(age_seconds: int) -> str:
    import datetime

    dt = datetime.datetime.fromtimestamp(
        FIXTURE_NOW_EPOCH - age_seconds, tz=datetime.timezone.utc
    )
    return dt.strftime("%Y-%m-%dT%H:%M:%SZ")


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

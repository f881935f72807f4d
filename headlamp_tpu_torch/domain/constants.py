"""GKE Cloud TPU constants — the TPU-side analogue of the reference's Intel
constant block (`src/api/k8s.ts:13-31`).

The names the port uses, copied from
``headlamp_tpu/domain/constants.py``. Everything the framework knows
about a cluster flows from these names:
extended-resource keys on node capacity/allocatable and pod requests, and
node labels stamped by GKE when a TPU node pool is created.
"""

# ---------------------------------------------------------------------------
# Extended resource
# ---------------------------------------------------------------------------

#: Kubernetes extended resource advertised by the GKE TPU device plugin.
#: Unlike Intel's gpu.intel.com/* family this is a single resource name,
#: so detection matches it exactly rather than by prefix.
TPU_RESOURCE = "google.com/tpu"

# ---------------------------------------------------------------------------
# GKE node labels
# ---------------------------------------------------------------------------

#: Accelerator machine family, e.g. "tpu-v5-lite-podslice", "tpu-v5p-slice",
#: "tpu-v4-podslice", "tpu-v6e-slice".
GKE_TPU_ACCELERATOR_LABEL = "cloud.google.com/gke-tpu-accelerator"

#: Physical chip topology of the slice this node belongs to, e.g. "2x4" for
#: v5e or "4x4x4" for v5p/v4.
GKE_TPU_TOPOLOGY_LABEL = "cloud.google.com/gke-tpu-topology"

#: Node pool name. All hosts of one multi-host pod slice live in one node
#: pool; we group slice membership by this label.
GKE_NODEPOOL_LABEL = "cloud.google.com/gke-nodepool"

#: Optional worker index within a multi-host slice. Not all GKE versions
#: stamp it; slice grouping falls back to deterministic name ordering.
GKE_TPU_WORKER_ID_LABEL = "cloud.google.com/gke-tpu-worker-id"

#: Federation cluster membership (the viewport tree's first level).
#: Multi-cluster fleets arrive through one aggregated snapshot; this label
#: names the source cluster on every node. Nodes without it (every
#: single-cluster deployment) fall into the implicit cluster "0" — the
#: viewport tree is total over any fleet, labelled or not.
HEADLAMP_CLUSTER_LABEL = "headlamp.io/cluster"

# ---------------------------------------------------------------------------
# TPU device plugin DaemonSet
# ---------------------------------------------------------------------------

#: Label values identifying TPU device-plugin daemon pods. GKE runs the
#: plugin in kube-system; third-party installs vary, so detection accepts
#: any of these label pairs (mirrors the reference's 3-variant matching,
#: `src/api/k8s.ts:271-282`).
TPU_PLUGIN_POD_LABELS = (
    ("k8s-app", "tpu-device-plugin"),
    ("app", "tpu-device-plugin"),
    ("app.kubernetes.io/name", "tpu-device-plugin"),
)

#: Namespace GKE deploys the device plugin into.
TPU_PLUGIN_NAMESPACE = "kube-system"

# ---------------------------------------------------------------------------
# Accelerator label value -> TPU generation
# ---------------------------------------------------------------------------

#: Known gke-tpu-accelerator label values. Order matters only for docs.
TPU_ACCELERATOR_GENERATIONS = {
    "tpu-v4-podslice": "v4",
    "tpu-v5-lite-podslice": "v5e",
    "tpu-v5-lite-device": "v5e",
    "tpu-v5p-slice": "v5p",
    "tpu-v6e-slice": "v6e",
}

#: Human-readable generation names for UI display.
TPU_GENERATION_DISPLAY = {
    "v4": "TPU v4",
    "v5e": "TPU v5e",
    "v5p": "TPU v5p",
    "v6e": "TPU v6e (Trillium)",
    "unknown": "TPU (unknown gen)",
}

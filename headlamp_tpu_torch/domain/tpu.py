"""TPU domain model — detection, chip accounting, formatting.

Role-equivalent to the reference's pure domain layer
(`src/api/k8s.ts`), redesigned around GKE Cloud TPU
primitives: `google.com/tpu` extended resources and
`cloud.google.com/gke-tpu-*` node labels. Pure functions over plain dicts;
zero imports outside the package (mirrors k8s.ts:1-6's zero-dep contract).
"""

from __future__ import annotations

from typing import Any, Mapping

from . import objects as obj
from .constants import (
    GKE_NODEPOOL_LABEL,
    GKE_TPU_ACCELERATOR_LABEL,
    GKE_TPU_TOPOLOGY_LABEL,
    GKE_TPU_WORKER_ID_LABEL,
    TPU_ACCELERATOR_GENERATIONS,
    TPU_GENERATION_DISPLAY,
    TPU_PLUGIN_POD_LABELS,
    TPU_RESOURCE,
)

# ---------------------------------------------------------------------------
# Node detection
# ---------------------------------------------------------------------------

def is_tpu_node(node: Any) -> bool:
    """A node is a TPU node if GKE stamped the accelerator label OR its
    capacity advertises `google.com/tpu` (label-OR-capacity, the same
    two-signal detection the reference uses for Intel nodes,
    k8s.ts:125-152 — either signal alone is sufficient because label
    propagation and device-plugin registration can race)."""
    labels = obj.labels(node)
    if labels.get(GKE_TPU_ACCELERATOR_LABEL):
        return True
    if obj.parse_int(obj.node_capacity(node).get(TPU_RESOURCE)) > 0:
        return True
    return False


def get_node_chip_capacity(node: Any) -> int:
    """Chips advertised in capacity (k8s.ts:171-180 analogue; TPU has a
    single resource name, not i915+xe)."""
    return obj.parse_int(obj.node_capacity(node).get(TPU_RESOURCE))


def get_node_chip_allocatable(node: Any) -> int:
    return obj.parse_int(obj.node_allocatable(node).get(TPU_RESOURCE))


def get_node_accelerator(node: Any) -> str | None:
    """Raw gke-tpu-accelerator label value, e.g. 'tpu-v5-lite-podslice'."""
    val = obj.labels(node).get(GKE_TPU_ACCELERATOR_LABEL)
    return str(val) if val else None


def get_node_topology(node: Any) -> str | None:
    """Raw gke-tpu-topology label value, e.g. '2x4' or '4x4x4'."""
    val = obj.labels(node).get(GKE_TPU_TOPOLOGY_LABEL)
    return str(val) if val else None


def get_node_pool(node: Any) -> str | None:
    val = obj.labels(node).get(GKE_NODEPOOL_LABEL)
    return str(val) if val else None


def get_node_worker_id(node: Any) -> int | None:
    """Explicit worker index within a multi-host slice, when stamped.
    Returns None (not 0) when absent so callers can fall back to
    deterministic name ordering — see topology.slices.group_slices."""
    val = obj.labels(node).get(GKE_TPU_WORKER_ID_LABEL)
    if val is None or str(val).strip() == "":
        return None
    parsed = obj.parse_int(val)
    if parsed == 0 and str(val).strip() not in ("0", "+0", "-0"):
        return None
    return parsed


def get_tpu_generation(accelerator: str | None) -> str:
    """Map an accelerator label value to a generation ('v4','v5e','v5p',
    'v6e','unknown'). Unknown future values degrade gracefully rather than
    failing detection — the TPU analogue of the reference's
    discrete/integrated/unknown trichotomy (k8s.ts:183-192)."""
    if not accelerator:
        return "unknown"
    gen = TPU_ACCELERATOR_GENERATIONS.get(accelerator)
    if gen:
        return gen
    # Heuristic for future label values: "tpu-v7x-..." -> "v7x"
    if accelerator.startswith("tpu-v"):
        tail = accelerator[len("tpu-"):]
        gen_guess = tail.split("-", 1)[0]
        if len(gen_guess) <= 4:
            return gen_guess
    return "unknown"


def get_node_generation(node: Any) -> str:
    return get_tpu_generation(get_node_accelerator(node))


def is_multi_host_node(node: Any) -> bool:
    """True when the node's slice spans multiple hosts (topology chip count
    exceeds the chips attached to this host). Needs only node-local data."""
    topology = get_node_topology(node)
    if not topology:
        return False
    from ..topology.slices import parse_topology, topology_chip_count

    dims = parse_topology(topology)
    if not dims:
        return False
    chips_here = get_node_chip_capacity(node)
    return chips_here > 0 and topology_chip_count(dims) > chips_here


# ---------------------------------------------------------------------------
# Pod detection & chip accounting
# ---------------------------------------------------------------------------

def is_tpu_requesting_pod(pod: Any) -> bool:
    """Any container (incl. init) requesting or limited by google.com/tpu
    (requests-OR-limits over the container union, k8s.ts:250-264)."""
    for c in obj.pod_containers(pod):
        if TPU_RESOURCE in obj.container_requests(c) or TPU_RESOURCE in obj.container_limits(c):
            return True
    return False


def get_pod_chip_request(pod: Any) -> int:
    """Effective chips the pod occupies: Kubernetes reserves
    max(max(initContainers), sum(containers)) — init containers run
    sequentially before the main ones, so their requests overlap rather
    than add (the reference sums both, k8s.ts:289-301; that overcounts).
    For extended resources requests==limits is API-server-enforced, so
    requests (falling back to limits) are exact per container."""

    def chip_req(c: Mapping[str, Any]) -> int:
        req = obj.container_requests(c).get(TPU_RESOURCE)
        if req is None:
            req = obj.container_limits(c).get(TPU_RESOURCE)
        return obj.parse_int(req)

    main_sum = sum(chip_req(c) for c in obj.pod_containers(pod, include_init=False))
    init_max = max((chip_req(c) for c in obj.pod_init_containers(pod)), default=0)
    return max(main_sum, init_max)


def is_tpu_plugin_pod(pod: Any) -> bool:
    """TPU device-plugin daemon pod, by any accepted label variant
    (3-variant matching mirrors k8s.ts:271-282)."""
    labels = obj.labels(pod)
    if not labels:
        return False
    return any(labels.get(k) == v for k, v in TPU_PLUGIN_POD_LABELS)


# ---------------------------------------------------------------------------
# DaemonSet status (TPU has no operator CRD — ADR-003 analogue)
# ---------------------------------------------------------------------------

def daemonset_status_to_status(ds: Any) -> str:
    """'success' | 'warning' | 'error' from DaemonSet rollout counters —
    the reference applies the same state machine to its CRD status
    (k8s.ts:370-379); with no TPU CRD we read the DaemonSet directly."""
    s = obj.status(ds)
    desired = obj.parse_int(s.get("desiredNumberScheduled"))
    ready = obj.parse_int(s.get("numberReady"))
    unavailable = obj.parse_int(s.get("numberUnavailable"))
    if desired == 0:
        return "warning"
    if unavailable > 0:
        return "warning"
    if ready == desired:
        return "success"
    return "error"


def daemonset_status_text(ds: Any) -> str:
    s = obj.status(ds)
    desired = obj.parse_int(s.get("desiredNumberScheduled"))
    ready = obj.parse_int(s.get("numberReady"))
    if desired == 0:
        return "No nodes scheduled"
    return f"{ready}/{desired} ready"


# ---------------------------------------------------------------------------
# Formatting
# ---------------------------------------------------------------------------

def format_generation(generation: str) -> str:
    known = TPU_GENERATION_DISPLAY.get(generation)
    if known:
        return known
    # Future generations inferred by get_tpu_generation still display
    # usefully ("TPU v7x") instead of collapsing to unknown.
    if generation and generation != "unknown":
        return f"TPU {generation}"
    return TPU_GENERATION_DISPLAY["unknown"]


def format_accelerator(accelerator: str | None) -> str:
    """Display name for an accelerator label value:
    'tpu-v5-lite-podslice' -> 'TPU v5e'."""
    return format_generation(get_tpu_generation(accelerator))


def format_chip_count(count: int) -> str:
    return f"{count} chip" if count == 1 else f"{count} chips"


# ---------------------------------------------------------------------------
# Fleet summaries (pure aggregation used by pages and analytics)
# ---------------------------------------------------------------------------


#: Provider-neutral phase histogram — lives in objects; re-exported here
#: for the established TPU-page call sites.
count_pod_phases = obj.count_pod_phases

"""Intel GPU provider — the second accelerator provider.

The port's copy of ``headlamp_tpu/domain/intel.py``. Intel Arc dGPU
nodes and TPU nodes coexist and degrade independently behind one
abstraction. This module re-implements the *semantics* of the
reference's Intel detection (`src/api/k8s.ts:17-31,125-152,250-301`) in
dict-based style; it is thinner than the TPU provider — TPU is
first-class here, Intel is the compatibility provider. Pure host code:
no tensor is touched.
"""

from __future__ import annotations

from typing import Any, Iterable

from . import objects as obj

INTEL_GPU_RESOURCE_PREFIX = "gpu.intel.com/"
INTEL_GPU_I915_RESOURCE = "gpu.intel.com/i915"
INTEL_GPU_XE_RESOURCE = "gpu.intel.com/xe"

INTEL_GPU_NODE_LABEL = "intel.feature.node.kubernetes.io/gpu"
INTEL_DISCRETE_GPU_ROLE = "node-role.kubernetes.io/gpu"
INTEL_INTEGRATED_GPU_ROLE = "node-role.kubernetes.io/igpu"

INTEL_PLUGIN_POD_LABELS = (
    ("app", "intel-gpu-plugin"),
    ("app.kubernetes.io/name", "intel-gpu-plugin"),
    ("component", "intel-gpu-plugin"),
)

#: Device-counting resources. Shared/monitoring resources (millicores,
#: memory.max, tiles) are capacity metadata, not devices.
_DEVICE_RESOURCES = (INTEL_GPU_I915_RESOURCE, INTEL_GPU_XE_RESOURCE)


def is_intel_gpu_node(node: Any) -> bool:
    """NFD-label OR gpu.intel.com/* capacity (k8s.ts:125-152)."""
    labels = obj.labels(node)
    if "true" in (
        labels.get(INTEL_GPU_NODE_LABEL),
        labels.get(INTEL_DISCRETE_GPU_ROLE),
        labels.get(INTEL_INTEGRATED_GPU_ROLE),
    ):
        return True
    return any(k.startswith(INTEL_GPU_RESOURCE_PREFIX) for k in obj.node_capacity(node))


def filter_intel_gpu_nodes(items: Iterable[Any]) -> list[Any]:
    return [n for n in items if is_intel_gpu_node(n)]


def get_node_gpu_count(node: Any) -> int:
    """i915 + xe capacity sum (k8s.ts:171-180)."""
    capacity = obj.node_capacity(node)
    return sum(obj.parse_int(capacity.get(r)) for r in _DEVICE_RESOURCES)


def get_node_gpu_allocatable(node: Any) -> int:
    allocatable = obj.node_allocatable(node)
    return sum(obj.parse_int(allocatable.get(r)) for r in _DEVICE_RESOURCES)


def get_node_gpu_type(node: Any) -> str:
    """'discrete' | 'integrated' | 'unknown' (k8s.ts:185-192)."""
    labels = obj.labels(node)
    if labels.get(INTEL_DISCRETE_GPU_ROLE) == "true":
        return "discrete"
    if labels.get(INTEL_INTEGRATED_GPU_ROLE) == "true":
        return "integrated"
    return "unknown"


def is_gpu_requesting_pod(pod: Any) -> bool:
    """Any container with a gpu.intel.com/* request or limit
    (k8s.ts:250-264)."""
    for c in obj.pod_containers(pod):
        merged = {**obj.container_requests(c), **obj.container_limits(c)}
        if any(k.startswith(INTEL_GPU_RESOURCE_PREFIX) for k in merged):
            return True
    return False


def filter_gpu_requesting_pods(items: Iterable[Any]) -> list[Any]:
    return [p for p in items if is_gpu_requesting_pod(p)]


def get_container_gpu_resources(container: Any) -> dict[str, tuple[int, int]]:
    """Per-container ``{resource: (request, limit)}`` over the merged
    requests∪limits key set, gpu.intel.com/* only — the single
    definition behind the pods-page container list and the pod
    detail-section rows (the reference merges the same way,
    `PodsPage.tsx:49-88`, `PodDetailSection.tsx:57-83`)."""
    requests = obj.container_requests(container)
    limits = obj.container_limits(container)
    return {
        resource: (
            obj.parse_int(requests.get(resource)),
            obj.parse_int(limits.get(resource)),
        )
        for resource in sorted({*requests, *limits})
        if resource.startswith(INTEL_GPU_RESOURCE_PREFIX)
    }


def get_pod_gpu_requests(pod: Any) -> dict[str, int]:
    """Per-resource effective requests: max(sum over main containers,
    max over init containers) — init containers run before the main ones
    and overlap rather than add (the reference sums both, k8s.ts:289-301,
    which overcounts)."""
    main: dict[str, int] = {}
    for c in obj.pod_containers(pod, include_init=False):
        for key, value in obj.container_requests(c).items():
            if key.startswith(INTEL_GPU_RESOURCE_PREFIX):
                main[key] = main.get(key, 0) + obj.parse_int(value)
    init: dict[str, int] = {}
    for c in obj.pod_init_containers(pod):
        for key, value in obj.container_requests(c).items():
            if key.startswith(INTEL_GPU_RESOURCE_PREFIX):
                init[key] = max(init.get(key, 0), obj.parse_int(value))
    return {k: max(main.get(k, 0), init.get(k, 0)) for k in {*main, *init}}


def get_pod_device_request(pod: Any) -> int:
    """Device-count request (i915 + xe only), for allocation math."""
    totals = get_pod_gpu_requests(pod)
    return sum(totals.get(r, 0) for r in _DEVICE_RESOURCES)


def is_intel_plugin_pod(pod: Any) -> bool:
    labels = obj.labels(pod)
    if not labels:
        return False
    return any(labels.get(k) == v for k, v in INTEL_PLUGIN_POD_LABELS)


# ---------------------------------------------------------------------------
# GpuDevicePlugin CRD status (reference: k8s.ts:56-80,370-386)
# ---------------------------------------------------------------------------

def plugin_status_to_status(plugin: Any) -> str:
    """'success' | 'warning' | 'error' from the CRD's rollout counters —
    the reference's state machine (k8s.ts:370-379): no desired nodes ⇒
    warning; all ready ⇒ success; else error."""
    s = obj.status(plugin)
    desired = obj.parse_int(s.get("desiredNumberScheduled"))
    ready = obj.parse_int(s.get("numberReady"))
    if desired == 0:
        return "warning"
    if ready == desired:
        return "success"
    return "error"


def plugin_status_text(plugin: Any) -> str:
    """Human rollout text (k8s.ts:381-386)."""
    s = obj.status(plugin)
    desired = obj.parse_int(s.get("desiredNumberScheduled"))
    ready = obj.parse_int(s.get("numberReady"))
    if desired == 0:
        return "No nodes scheduled"
    return f"{ready}/{desired} ready"


def format_gpu_resource_name(resource_key: str) -> str:
    """'gpu.intel.com/i915' -> 'GPU (i915)' (k8s.ts:354-364)."""
    if not resource_key.startswith(INTEL_GPU_RESOURCE_PREFIX):
        return resource_key
    suffix = resource_key[len(INTEL_GPU_RESOURCE_PREFIX):]
    pretty = {
        "i915": "GPU (i915)",
        "xe": "GPU (xe)",
        "millicores": "GPU millicores",
        "memory.max": "GPU memory",
        "tiles": "GPU tiles",
    }
    return pretty.get(suffix, f"GPU ({suffix})")


def format_gpu_type(gpu_type: str) -> str:
    """(k8s.ts:194-199)."""
    return {
        "discrete": "Discrete GPU",
        "integrated": "Integrated GPU",
    }.get(gpu_type, "Intel GPU")


def filter_intel_plugin_pods(items: Iterable[Any]) -> list[Any]:
    return [p for p in items if is_intel_plugin_pod(p)]

"""Per-provider data-source descriptors.

The port's copy of ``headlamp_tpu/context/sources.py``, with the TPU
and Intel sources. The reference hard-codes its imperative fetch targets
inside the context (`IntelGpuDataContext.tsx:125`, `:142-151`); this
module lifts them into data so each provider declares *where* its
plugin state lives and the context stays provider-agnostic.

Terminology: a provider's **workload object** is the API object that
describes the device-plugin deployment — the Intel operator's
``GpuDevicePlugin`` CRD for Intel, the device-plugin ``DaemonSet`` for
TPU (GKE ships no TPU operator CRD, so the DaemonSet *is* the
installation record).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping

from ..domain import objects as obj
from ..domain import intel, tpu
from ..domain.constants import TPU_PLUGIN_NAMESPACE

#: Reactive-track list endpoints (the ``useList`` analogues,
#: `IntelGpuDataContext.tsx:98-99` — Pod.useList({namespace: ''}) is the
#: all-namespaces list).
NODES_PATH = "/api/v1/nodes"
PODS_PATH = "/api/v1/pods"

#: Optional server-side pod filter for fleet-scale clusters: completed
#: pods keep their TPU/GPU requests in spec but hold no devices, and on
#: batch-heavy clusters they dominate the list. Pass it as
#: ``AcceleratorDataContext(pod_field_selector=...)`` to drop them at the
#: apiserver.
ACTIVE_PODS_FIELD_SELECTOR = "status.phase!=Succeeded,status.phase!=Failed"


@dataclass(frozen=True)
class ProviderSource:
    """Where one provider's imperative-track state lives.

    ``plugin_pod_paths`` is a fallback chain tried sequentially with
    silent per-path failure, results merged and UID-deduped — the
    reference's daemon-pod strategy (`IntelGpuDataContext.tsx:142-174`).
    ``workload_paths`` is the same kind of chain for the workload object;
    a miss on every path flips ``workload_available`` to False *without*
    surfacing an error (graceful degradation).
    """

    provider_name: str
    workload_kind: str
    workload_paths: tuple[str, ...]
    plugin_pod_paths: tuple[str, ...]
    #: Client-side filter applied to pods fetched from namespace-wide
    #: fallback paths (label-selector paths already filter server-side,
    #: but re-filtering is harmless and keeps merging uniform).
    plugin_pod_filter: Callable[[Any], bool]


TPU_SOURCE = ProviderSource(
    provider_name="tpu",
    workload_kind="DaemonSet",
    workload_paths=(
        "/apis/apps/v1/daemonsets?labelSelector=k8s-app%3Dtpu-device-plugin",
        f"/apis/apps/v1/namespaces/{TPU_PLUGIN_NAMESPACE}/daemonsets",
    ),
    plugin_pod_paths=(
        "/api/v1/pods?labelSelector=k8s-app%3Dtpu-device-plugin",
        "/api/v1/pods?labelSelector=app%3Dtpu-device-plugin",
        f"/api/v1/namespaces/{TPU_PLUGIN_NAMESPACE}/pods",
    ),
    plugin_pod_filter=tpu.is_tpu_plugin_pod,
)


INTEL_SOURCE = ProviderSource(
    provider_name="intel",
    workload_kind="GpuDevicePlugin",
    workload_paths=(
        # The operator CRD list — the reference's only workload source
        # (`IntelGpuDataContext.tsx:125`).
        "/apis/deviceplugin.intel.com/v1/gpudeviceplugins",
    ),
    plugin_pod_paths=(
        "/api/v1/pods?labelSelector=app%3Dintel-gpu-plugin",
        "/api/v1/pods?labelSelector=app.kubernetes.io%2Fname%3Dintel-gpu-plugin",
        "/api/v1/namespaces/inteldeviceplugins-system/pods",
    ),
    plugin_pod_filter=intel.is_intel_plugin_pod,
)


def default_sources() -> dict[str, ProviderSource]:
    return {s.provider_name: s for s in (TPU_SOURCE, INTEL_SOURCE)}


def workload_matches_provider(source: ProviderSource, workload: Any) -> bool:
    """Keep only workload objects that belong to the provider when a
    fallback path returned a whole namespace's worth. DaemonSets match by
    name/label mention of the plugin; CRD lists are already scoped by
    group so any kind match passes."""
    if not isinstance(workload, Mapping):
        return False
    kind = str(workload.get("kind", ""))
    if source.workload_kind == "GpuDevicePlugin":
        return kind in ("", "GpuDevicePlugin")
    needle = f"{source.provider_name}-device-plugin"
    return needle in obj.name(workload) or needle in obj.labels(workload).values()

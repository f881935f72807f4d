"""Provider-agnostic accelerator abstraction.

The port's copy of ``headlamp_tpu/domain/accelerator.py``, with both
providers: Cloud TPU and Intel GPU coexist in one snapshot and degrade
independently. A Provider describes how to detect its nodes/pods and
count devices; ``classify_fleet`` partitions one cluster snapshot into
per-provider views in a single pass.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping

from . import intel, objects, tpu


@dataclass(frozen=True)
class Provider:
    """One accelerator family. ``device_unit`` is the display word for a
    schedulable device ('chip' for TPU, 'device' for Intel GPU)."""

    name: str
    display_name: str
    device_unit: str
    is_accel_node: Callable[[Any], bool]
    is_accel_pod: Callable[[Any], bool]
    is_plugin_pod: Callable[[Any], bool]
    node_device_capacity: Callable[[Any], int]
    node_device_allocatable: Callable[[Any], int]
    pod_device_request: Callable[[Any], int]
    #: Fast-path pod detection: a pure predicate over the pod's merged
    #: resource-key set (objects.pod_resource_keys). classify_fleet
    #: computes the set ONCE per pod and asks each provider's predicate,
    #: instead of every provider re-walking the container list. Must
    #: decide exactly what ``is_accel_pod`` decides; None falls back to
    #: ``is_accel_pod``.
    pod_resource_test: Callable[[set[str]], bool] | None = None


TPU_PROVIDER = Provider(
    name="tpu",
    display_name="Cloud TPU",
    device_unit="chip",
    is_accel_node=tpu.is_tpu_node,
    is_accel_pod=tpu.is_tpu_requesting_pod,
    is_plugin_pod=tpu.is_tpu_plugin_pod,
    node_device_capacity=tpu.get_node_chip_capacity,
    node_device_allocatable=tpu.get_node_chip_allocatable,
    pod_device_request=tpu.get_pod_chip_request,
    pod_resource_test=lambda keys: tpu.TPU_RESOURCE in keys,
)

INTEL_PROVIDER = Provider(
    name="intel",
    display_name="Intel GPU",
    device_unit="device",
    is_accel_node=intel.is_intel_gpu_node,
    is_accel_pod=intel.is_gpu_requesting_pod,
    is_plugin_pod=intel.is_intel_plugin_pod,
    node_device_capacity=intel.get_node_gpu_count,
    node_device_allocatable=intel.get_node_gpu_allocatable,
    pod_device_request=intel.get_pod_device_request,
    pod_resource_test=lambda keys: any(
        k.startswith(intel.INTEL_GPU_RESOURCE_PREFIX) for k in keys
    ),
)

#: Registration order = sidebar/priority order. TPU first by design.
PROVIDERS: tuple[Provider, ...] = (TPU_PROVIDER, INTEL_PROVIDER)


@dataclass
class FleetView:
    """One provider's slice of a cluster snapshot."""

    provider: Provider
    nodes: list[Any] = field(default_factory=list)
    pods: list[Any] = field(default_factory=list)
    plugin_pods: list[Any] = field(default_factory=list)
    #: Snapshot generation this view was built from — stamped by the
    #: data context's ``_build_snapshot`` (monotone per context, bumped
    #: only when a sync changed state). It is the device-cache key
    #: (``runtime.device_cache.DeviceFleetCache``): same version ⇒
    #: identical nodes/pods ⇒ the device-resident columns may be reused.
    #: ``None`` (raw ``classify_fleet`` views: CLI one-shots, tests)
    #: opts out of caching entirely.
    version: int | None = None

    @property
    def plugin_installed(self) -> bool:
        """Plugin presence = daemon pods seen OR devices advertised. The
        TPU side has no operator CRD, so allocatable devices are accepted
        as installation evidence."""
        if self.plugin_pods:
            return True
        return any(self.provider.node_device_allocatable(n) > 0 for n in self.nodes)

    def allocation_summary(self) -> Mapping[str, int]:
        return objects.allocation_summary(
            self.nodes,
            self.pods,
            self.provider.node_device_capacity,
            self.provider.node_device_allocatable,
            self.provider.pod_device_request,
        )


def classify_fleet(
    nodes: Iterable[Any],
    pods: Iterable[Any],
    providers: tuple[Provider, ...] = PROVIDERS,
) -> dict[str, FleetView]:
    """Partition a cluster snapshot into per-provider views in one pass
    over nodes and one over pods."""
    views = {p.name: FleetView(provider=p) for p in providers}
    for n in nodes:
        for p in providers:
            if p.is_accel_node(n):
                views[p.name].nodes.append(n)
    for pod in pods:
        # One container walk per pod, shared by every provider's
        # resource predicate (see Provider.pod_resource_test).
        resource_keys = objects.pod_resource_keys(pod)
        for p in providers:
            if (
                p.pod_resource_test(resource_keys)
                if p.pod_resource_test is not None
                else p.is_accel_pod(pod)
            ):
                views[p.name].pods.append(pod)
            if p.is_plugin_pod(pod):
                views[p.name].plugin_pods.append(pod)
    return views

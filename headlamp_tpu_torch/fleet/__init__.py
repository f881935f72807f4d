"""Deterministic fleet fixtures: TPU fleets and the mixed TPU + Intel fleet."""

from .fixtures import (  # noqa: F401
    FIXTURE_NOW_EPOCH,
    fleet_large,
    fleet_mixed,
    fleet_transport,
    fleet_v5e4,
    fleet_v5p32,
    fleet_v5p32_degraded,
    fleet_viewport,
    make_intel_crd,
    make_intel_node,
    make_intel_pod,
    make_plain_node,
    make_plugin_daemonset,
    make_plugin_pod,
    make_tpu_node,
    make_tpu_pod,
)

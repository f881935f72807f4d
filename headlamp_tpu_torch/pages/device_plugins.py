"""DevicePluginsPage — plugin deployment detail.

Rebuild of `src/components/DevicePluginsPage.tsx` for a
world without an operator CRD: the TPU device plugin is a DaemonSet, so
the per-CRD cards (`:110-182`) become per-DaemonSet cards (rollout
counters, node selector, age), with the CRD-not-available box (`:64-85`)
becoming the workload-source-unavailable box, and the same daemon-pod
table with restarts (`:185-217`).
"""

from __future__ import annotations

from typing import Any, Mapping

from ..context.accelerator_context import ClusterSnapshot
from ..domain import objects as obj
from ..domain import tpu
from ..ui import (
    EmptyContent,
    Loader,
    NameValueTable,
    SectionBox,
    SimpleTable,
    StatusLabel,
    h,
)
from ..ui.vdom import Element
from .common import age_cell, error_banner, phase_label
from .native import pod_link


def _ds_node_selector(ds: Any) -> str:
    template = obj.spec(ds).get("template")
    template = template if isinstance(template, Mapping) else {}
    tmpl_spec = template.get("spec")
    tmpl_spec = tmpl_spec if isinstance(tmpl_spec, Mapping) else {}
    selector = tmpl_spec.get("nodeSelector")
    if isinstance(selector, Mapping) and selector:
        return ", ".join(f"{k}={v}" for k, v in sorted(selector.items()))
    return "—"


def _ds_image(ds: Any) -> str:
    template = obj.spec(ds).get("template")
    template = template if isinstance(template, Mapping) else {}
    tmpl_spec = template.get("spec")
    tmpl_spec = tmpl_spec if isinstance(tmpl_spec, Mapping) else {}
    containers = tmpl_spec.get("containers")
    if isinstance(containers, list) and containers and isinstance(containers[0], Mapping):
        return str(containers[0].get("image", "—"))
    return "—"


def device_plugins_page(
    snap: ClusterSnapshot, *, now: float, provider_name: str = "tpu"
) -> Element:
    if snap.loading:
        return h("div", {"class_": "hl-page hl-deviceplugins"}, Loader())

    state = snap.provider(provider_name)
    children: list[Any] = [error_banner(snap)]

    if not state.workload_available:
        # Source unreadable (`DevicePluginsPage.tsx:64-85` analogue).
        children.append(
            h(
                "div",
                {"class_": "hl-notice hl-workload-missing"},
                h("h3", None, "Plugin workload status not available"),
                h(
                    "p",
                    None,
                    "Neither the DaemonSet API nor the device-plugin CRD could "
                    "be read. Daemon pods below (if any) are discovered via "
                    "label selectors.",
                ),
            )
        )
    elif not state.workloads:
        # Readable but empty (`:88-108`).
        children.append(
            EmptyContent(
                h("h3", None, "No device-plugin workloads found"),
                h(
                    "p",
                    None,
                    "The API is reachable but no tpu-device-plugin DaemonSet "
                    "exists. On GKE it appears when the first TPU node pool "
                    "is created.",
                ),
            )
        )

    # Per-workload detail cards (`:110-182`).
    for ds in state.workloads:
        s = obj.status(ds)
        children.append(
            SectionBox(
                f"DaemonSet: {obj.namespace(ds)}/{obj.name(ds)}",
                NameValueTable(
                    [
                        (
                            "Status",
                            StatusLabel(
                                tpu.daemonset_status_to_status(ds),
                                tpu.daemonset_status_text(ds),
                            ),
                        ),
                        ("Image", _ds_image(ds)),
                        ("Desired", obj.parse_int(s.get("desiredNumberScheduled"))),
                        ("Ready", obj.parse_int(s.get("numberReady"))),
                        ("Unavailable", obj.parse_int(s.get("numberUnavailable"))),
                        ("Node selector", _ds_node_selector(ds)),
                        ("Age", age_cell(ds, now)),
                    ]
                ),
                class_="hl-plugin-card",
            )
        )

    # Daemon-pod table with restarts (`:185-217`).
    children.append(
        SectionBox(
            "Plugin Pods",
            SimpleTable(
                [
                    {"label": "Pod", "getter": pod_link},
                    {"label": "Node", "getter": lambda p: obj.pod_node_name(p) or "—"},
                    {"label": "Phase", "getter": phase_label},
                    {"label": "Restarts", "getter": obj.pod_restarts},
                    {"label": "Age", "getter": lambda p: age_cell(p, now)},
                ],
                state.plugin_pods,
                empty_message="No device-plugin pods found",
            ),
        )
    )

    return h("div", {"class_": "hl-page hl-deviceplugins"}, children)

"""Native-style resource views — the host surface for the integrations.

The port's copy of ``headlamp_tpu/pages/native.py`` (`:43-231`). In the
reference, the detail sections render inside Headlamp's native Node and
Pod pages and the column definitions extend Headlamp's native nodes table
(`index.tsx:152-182`): the host owns a generic Kubernetes view and the
plugin injects into it. Here the package's own server is the host, so
this module provides those views, registered at ``/nodes``,
``/node/<name>`` and ``/pod/<namespace>/<name>``:

- :func:`native_nodes_page` — the ``'headlamp-nodes'`` table analogue
  (`index.tsx:178`): ALL cluster nodes (not just accelerator nodes), base
  columns plus every registered columns processor's columns, each getter
  guarded so non-matching rows show '—' (`NodeColumns.tsx:21-46`).
- :func:`native_node_page` / :func:`native_pod_page` — generic detail
  views that call ``Registry.sections_for(kind)`` and append whatever
  each registered section renders (`index.tsx:152-170`); sections
  null-render for non-matching resources.

Node and pod names across the dashboard link here (:func:`node_link`,
:func:`pod_link`).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

from ..context.accelerator_context import ClusterSnapshot
from ..domain import objects as obj
from ..ui import EmptyContent, Loader, NameValueTable, SectionBox, SimpleTable, h
from ..ui.vdom import Element
from .common import age_cell, error_banner, filter_and_page_nodes, phase_label, ready_label

if TYPE_CHECKING:  # registration imports pages/* — avoid the cycle
    from ..registration import Registry

#: Native table id the processors target (`index.tsx:178`).
NODES_TABLE_ID = "headlamp-nodes"


def node_href(node_name: str) -> str:
    return f"/node/{node_name}"


def pod_href(pod: Any) -> str:
    return f"/pod/{obj.namespace(pod) or 'default'}/{obj.name(pod)}"


def node_link(node: Any) -> Element:
    name = obj.name(node)
    return h("a", {"href": node_href(name), "class_": "hl-res-link"}, name)


def pod_link(pod: Any) -> Element:
    ns = obj.namespace(pod)
    label = f"{ns}/{obj.name(pod)}" if ns else obj.name(pod)
    return h("a", {"href": pod_href(pod), "class_": "hl-res-link"}, label)


def _find_node(snap: ClusterSnapshot, name: str) -> Any | None:
    for node in snap.all_nodes or []:
        if obj.name(node) == name:
            return node
    return None


def _find_pod(snap: ClusterSnapshot, namespace: str, name: str) -> Any | None:
    for pod in snap.all_pods or []:
        if obj.name(pod) == name and (obj.namespace(pod) or "default") == namespace:
            return pod
    return None


def _not_found(kind: str, name: str) -> Element:
    # data-notfound lets the HTTP host answer 404 without re-doing the
    # lookup; it renders as a harmless boolean attribute otherwise.
    return h(
        "div",
        {"class_": "hl-page hl-native-detail", "data-notfound": True},
        EmptyContent(
            h("h3", None, f"{kind} not found"),
            h("p", None, f"No {kind.lower()} named {name} in the cluster snapshot."),
        ),
    )


def native_nodes_page(
    snap: ClusterSnapshot,
    *,
    now: float,
    registry: Registry,
    page: int = 1,
    query: str = "",
) -> Element:
    """All cluster nodes with base columns + processor columns — the
    native nodes table the processors extend. Paged and name-filterable
    (``?page=N&q=…``) so every row of a 1024-node fleet is reachable."""
    if snap.loading:
        return h("div", {"class_": "hl-page hl-native-nodes"}, Loader())

    columns: list[dict[str, Any]] = [
        {"label": "Name", "getter": node_link},
        {"label": "Ready", "getter": lambda n: ready_label(obj.is_node_ready(n))},
        {"label": "Age", "getter": lambda n: age_cell(n, now)},
    ]
    # Every registered processor targeting this table, in registration
    # order (`index.tsx:177-182`).
    for proc in registry.columns_processors:
        if proc.table_id == NODES_TABLE_ID:
            columns.extend(proc.build_columns())

    nodes, controls = filter_and_page_nodes(
        list(snap.all_nodes or []), page=page, query=query, base_url="/nodes"
    )
    return h(
        "div",
        {"class_": "hl-page hl-native-nodes"},
        error_banner(snap),
        SectionBox(
            "Nodes",
            controls,
            SimpleTable(
                columns,
                nodes,
                empty_message="No nodes match" if query else "No nodes in the cluster",
            ),
        ),
    )


def native_node_page(
    snap: ClusterSnapshot, node_name: str, *, now: float, registry: Registry
) -> Element:
    """Generic node detail + every registered Node section that chooses
    to render for this node (`index.tsx:152-165`)."""
    if snap.loading:
        return h("div", {"class_": "hl-page hl-native-detail"}, Loader())
    node = _find_node(snap, node_name)
    if node is None:
        return _not_found("Node", node_name)

    info = obj.node_info(node)
    pods_here = [p for p in snap.all_pods or [] if obj.pod_node_name(p) == node_name]
    base = SectionBox(
        node_name,
        NameValueTable(
            [
                ("Ready", ready_label(obj.is_node_ready(node))),
                ("Age", age_cell(node, now)),
                ("OS", info.get("osImage", "—")),
                ("Kernel", info.get("kernelVersion", "—")),
                ("Kubelet", info.get("kubeletVersion", "—")),
                ("Pods on node", len(pods_here)),
            ]
        ),
        class_="hl-native-node",
    )

    injected = []
    for section in registry.sections_for("Node"):
        el = section.component(node, snap)
        if el is not None:
            injected.append(el)

    return h("div", {"class_": "hl-page hl-native-detail"}, error_banner(snap), base, injected)


def native_pod_page(
    snap: ClusterSnapshot, namespace: str, pod_name: str, *, now: float, registry: Registry
) -> Element:
    """Generic pod detail + every registered Pod section that chooses to
    render (`index.tsx:167-170`; pod sections are pure props,
    `PodDetailSection.tsx:25`)."""
    if snap.loading:
        return h("div", {"class_": "hl-page hl-native-detail"}, Loader())
    pod = _find_pod(snap, namespace, pod_name)
    if pod is None:
        return _not_found("Pod", f"{namespace}/{pod_name}")

    node_name = obj.pod_node_name(pod)
    base = SectionBox(
        f"{namespace}/{pod_name}",
        NameValueTable(
            [
                ("Phase", phase_label(pod)),
                (
                    "Node",
                    h("a", {"href": node_href(node_name), "class_": "hl-res-link"}, node_name)
                    if node_name
                    else "—",
                ),
                ("Containers", len(obj.pod_containers(pod, include_init=False))),
                ("Restarts", obj.pod_restarts(pod)),
                ("Age", age_cell(pod, now)),
            ]
        ),
        class_="hl-native-pod",
    )

    injected = []
    for section in registry.sections_for("Pod"):
        el = section.component(pod)
        if el is not None:
            injected.append(el)

    return h("div", {"class_": "hl-page hl-native-detail"}, error_banner(snap), base, injected)

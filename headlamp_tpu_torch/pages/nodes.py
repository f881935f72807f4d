"""NodesPage — per-node summary table and detail cards.

Rebuild of `src/components/NodesPage.tsx`: summary table
(ready, type, devices, allocation bar, pods, age), per-node detail cards
with OS/kernel/kubelet info, empty state — with TPU columns (generation,
topology, slice pool, worker index) replacing the Intel type column.
"""

from __future__ import annotations

from typing import Any

from ..context.accelerator_context import ClusterSnapshot
from ..domain import objects as obj
from ..domain import tpu
from ..ui import (
    EmptyContent,
    Loader,
    NameValueTable,
    SectionBox,
    SimpleTable,
    UtilizationBar,
    fragment,
    h,
)
from ..ui.vdom import Element
from ..viewport import pods_by_node, window_nodes
from .native import node_link
from .common import (
    age_cell,
    cap_nodes_for_cards,
    cursor_controls,
    error_banner,
    filter_and_page_nodes,
    ready_label,
)


def _node_allocation(node: Any, node_pods: list[Any]) -> tuple[int, int]:
    """(chips in use by Running pods on this node, allocatable chips) —
    the per-node bar inputs (`NodesPage.tsx:35-63`)."""
    in_use = sum(
        tpu.get_pod_chip_request(p)
        for p in node_pods
        if obj.pod_phase(p) == "Running"
    )
    return in_use, tpu.get_node_chip_allocatable(node)


def nodes_page(
    snap: ClusterSnapshot,
    *,
    now: float,
    provider_name: str = "tpu",
    page: int = 1,
    query: str = "",
    limit: int | None = None,
    cursor: str | None = None,
) -> Element:
    if snap.loading:
        return h("div", {"class_": "hl-page hl-nodes"}, Loader())

    state = snap.provider(provider_name)
    by_node = pods_by_node(state)

    if not state.nodes:
        # Empty state (`NodesPage.tsx:228-249`).
        return h(
            "div",
            {"class_": "hl-page hl-nodes"},
            error_banner(snap),
            EmptyContent(
                h("h3", None, "No TPU nodes found"),
                h(
                    "p",
                    None,
                    "No node carries the cloud.google.com/gke-tpu-accelerator "
                    "label or advertises google.com/tpu capacity.",
                ),
            ),
        )

    def alloc_bar(node: Any) -> Element:
        in_use, allocatable = _node_allocation(node, by_node.get(obj.name(node), []))
        return UtilizationBar(in_use, allocatable, unit="chips")

    def row_salt(node: Any) -> tuple:
        """Every summary-row cell input (ADR-027 salt-completeness):
        the formatted age string is in here ON PURPOSE — ages tick
        with the clock, not the generation, and a salt that omitted
        them would splice yesterday's \"5m\" forever."""
        name = obj.name(node)
        in_use, allocatable = _node_allocation(node, by_node.get(name, []))
        return (
            name,
            obj.is_node_ready(node),
            tpu.get_node_accelerator(node),
            tpu.get_node_topology(node),
            tpu.get_node_chip_capacity(node),
            in_use,
            allocatable,
            len(by_node.get(name, [])),
            age_cell(node, now),
        )

    # The summary table is paged + name-filterable past the cap (rows
    # are lighter than cards but 1024 of them still unbounds the
    # response, and a cap alone made the tail unreachable). With
    # ``?limit=``/``?cursor=`` the selection instead comes from the
    # viewport layer (ADR-026): an O(limit) seek window whose cursor
    # survives fleet churn — the mode that keeps a 16k-node paint at
    # 1k-node cost. The legacy ``?page=N`` offset pager stays untouched.
    if limit is not None or cursor is not None:
        window = window_nodes(
            state,
            limit=limit if limit is not None else 64,
            cursor=cursor,
            query=query,
        )
        table_nodes = window.rows
        table_controls = cursor_controls(
            "/tpu/nodes", window, what="TPU nodes", query=query
        )
    else:
        table_nodes, table_controls = filter_and_page_nodes(
            state.nodes, page=page, query=query, base_url="/tpu/nodes", what="TPU nodes"
        )
    summary = SectionBox(
        "TPU Nodes",
        table_controls,
        SimpleTable(
            [
                {"label": "Name", "getter": node_link},
                {"label": "Ready", "getter": lambda n: ready_label(obj.is_node_ready(n))},
                {
                    "label": "Generation",
                    "getter": lambda n: tpu.format_accelerator(tpu.get_node_accelerator(n)),
                },
                {"label": "Topology", "getter": lambda n: tpu.get_node_topology(n) or "—"},
                {"label": "Chips", "getter": tpu.get_node_chip_capacity},
                {"label": "Allocation", "getter": alloc_bar},
                {
                    "label": "TPU Pods",
                    "getter": lambda n: len(by_node.get(obj.name(n), [])),
                },
                {"label": "Age", "getter": lambda n: age_cell(n, now)},
            ],
            table_nodes,
            row_key=obj.name,
            row_salt=row_salt,
        ),
    )

    # Per-node detail cards (`NodesPage.tsx:69-139,285-291`), capped
    # not-ready-first at fleet scale.
    shown, truncation = cap_nodes_for_cards(state)

    def node_card(node: Any) -> Element:
        info = obj.node_info(node)
        worker = tpu.get_node_worker_id(node)
        in_use, allocatable = _node_allocation(node, by_node.get(obj.name(node), []))
        return SectionBox(
            obj.name(node),
            NameValueTable(
                [
                    ("Generation", tpu.format_accelerator(tpu.get_node_accelerator(node))),
                    ("Accelerator label", tpu.get_node_accelerator(node) or "—"),
                    ("Topology", tpu.get_node_topology(node) or "—"),
                    ("Node pool", tpu.get_node_pool(node) or "—"),
                    ("Worker index", worker if worker is not None else "—"),
                    ("Chips (capacity)", tpu.get_node_chip_capacity(node)),
                    ("Chips (allocatable)", allocatable),
                    ("Chips in use", in_use),
                    ("OS", info.get("osImage", "—")),
                    ("Kernel", info.get("kernelVersion", "—")),
                    ("Kubelet", info.get("kubeletVersion", "—")),
                ]
            ),
            class_="hl-node-card",
        )

    def card_salt(node: Any) -> tuple:
        info = obj.node_info(node)
        in_use, allocatable = _node_allocation(node, by_node.get(obj.name(node), []))
        return (
            obj.name(node),
            tpu.get_node_accelerator(node),
            tpu.get_node_topology(node),
            tpu.get_node_pool(node),
            tpu.get_node_worker_id(node),
            tpu.get_node_chip_capacity(node),
            allocatable,
            in_use,
            info.get("osImage"),
            info.get("kernelVersion"),
            info.get("kubeletVersion"),
        )

    # Cards key with a ``card:`` prefix: the cache namespace is shared
    # with the summary rows above, and the same node renders DIFFERENT
    # bytes in each. Push eviction targets the bare row key; card
    # staleness is caught by the salt (complete inputs, compared on
    # every paint), which is the ADR-027 correctness backstop.
    cards = [
        fragment(f"card:{obj.name(node)}", card_salt(node), lambda node=node: node_card(node))
        for node in shown
    ]

    return h(
        "div",
        {"class_": "hl-page hl-nodes"},
        error_banner(snap),
        summary,
        truncation,
        cards,
    )

"""PodsPage — TPU-requesting workloads.

Rebuild of `src/components/PodsPage.tsx`: phase summary,
all-pods table with per-container chip requests (req=/lim= display,
`:49-88`), restarts, and the "Attention: Pending TPU Pods" table with
the first container's waiting reason (`:239-268`).
"""

from __future__ import annotations

from typing import Any

from ..context.accelerator_context import ClusterSnapshot
from ..domain import objects as obj
from ..domain import tpu
from ..domain.constants import TPU_RESOURCE
from ..ui import (
    EmptyContent,
    Loader,
    NameValueTable,
    SectionBox,
    SimpleTable,
    h,
)
from ..ui.vdom import Element
from ..viewport import pending_pods, running_chips, window_pods
from .common import (
    age_cell,
    cursor_controls,
    error_banner,
    phase_label,
    waiting_reason,
)
from .native import pod_link


def _pod_key(pod: Any) -> str:
    """The differ's pod-row vocabulary (``ns/name``) — boundary keys
    must match it exactly for push eviction to land (ADR-027)."""
    return f"{obj.namespace(pod)}/{obj.name(pod)}"


def _container_chips(pod: Any) -> tuple:
    return tuple(
        (
            c.get("name"),
            obj.parse_int(obj.container_requests(c).get(TPU_RESOURCE)),
            obj.parse_int(obj.container_limits(c).get(TPU_RESOURCE)),
        )
        for c in obj.pod_containers(pod)
    )


def container_chip_list(pod: Any) -> Element:
    """Per-container `name: req=N lim=M` lines (`PodsPage.tsx:49-88`
    merges requests and limits per container)."""
    lines = []
    for c in obj.pod_containers(pod):
        req = obj.parse_int(obj.container_requests(c).get(TPU_RESOURCE))
        lim = obj.parse_int(obj.container_limits(c).get(TPU_RESOURCE))
        if req or lim:
            lines.append(
                h(
                    "div",
                    {"class_": "hl-container-chips"},
                    f"{c.get('name', '?')}: req={req} lim={lim}",
                )
            )
    return h("div", None, lines)


def pods_page(
    snap: ClusterSnapshot,
    *,
    now: float,
    provider_name: str = "tpu",
    limit: int | None = None,
    cursor: str | None = None,
) -> Element:
    if snap.loading:
        return h("div", {"class_": "hl-page hl-pods"}, Loader())

    state = snap.provider(provider_name)

    if not state.pods:
        return h(
            "div",
            {"class_": "hl-page hl-pods"},
            error_banner(snap),
            EmptyContent(
                h("h3", None, "No TPU pods found"),
                h("p", None, "No pod requests google.com/tpu in any namespace."),
            ),
        )

    # Phase summary (`PodsPage.tsx:102-104,166-198`). Both aggregates
    # come from the viewport layer's per-generation memos (ADR-026) —
    # the page itself never walks the pod list.
    phases = tpu.count_pod_phases(state.pods)
    total_chips = running_chips(state)
    summary = SectionBox(
        "TPU Workload Summary",
        NameValueTable(
            [
                ("Total pods", len(state.pods)),
                *[(k, v) for k, v in phases.items() if v or k != "Other"],
                ("Chips in use (Running)", tpu.format_chip_count(total_chips)),
            ]
        ),
    )

    # All-pods table: cursor-windowed through the viewport layer when
    # ``?limit=``/``?cursor=`` is present (ADR-026 — O(limit) rows in
    # namespaced-name order, churn-stable continuation); the full
    # legacy table otherwise.
    if limit is not None or cursor is not None:
        window = window_pods(
            state, limit=limit if limit is not None else 64, cursor=cursor
        )
        table_pods: Any = window.rows
        pods_controls = cursor_controls("/tpu/pods", window, what="TPU pods")
    else:
        table_pods = state.pods
        pods_controls = None
    all_pods = SectionBox(
        "All TPU Pods",
        pods_controls,
        SimpleTable(
            [
                {"label": "Pod", "getter": pod_link},
                {"label": "Phase", "getter": phase_label},
                {"label": "Node", "getter": lambda p: obj.pod_node_name(p) or "—"},
                {"label": "Containers", "getter": container_chip_list},
                {
                    "label": "Chips",
                    "getter": lambda p: tpu.get_pod_chip_request(p),
                },
                {"label": "Restarts", "getter": obj.pod_restarts},
                {"label": "Age", "getter": lambda p: age_cell(p, now)},
            ],
            table_pods,
            row_key=_pod_key,
            row_salt=lambda p: (
                _pod_key(p),
                obj.pod_phase(p),
                obj.pod_node_name(p),
                _container_chips(p),
                tpu.get_pod_chip_request(p),
                obj.pod_restarts(p),
                age_cell(p, now),
            ),
        ),
    )

    # Pending attention table (`PodsPage.tsx:239-268`).
    pending = pending_pods(state)
    attention = None
    if pending:
        attention = SectionBox(
            "Attention: Pending TPU Pods",
            SimpleTable(
                [
                    {"label": "Pod", "getter": pod_link},
                    {
                        "label": "Chips requested",
                        "getter": lambda p: tpu.format_chip_count(
                            tpu.get_pod_chip_request(p)
                        ),
                    },
                    {"label": "Reason", "getter": lambda p: waiting_reason(p) or "—"},
                    {"label": "Age", "getter": lambda p: age_cell(p, now)},
                ],
                pending,
                # ``pending:`` prefix: the same pod renders different
                # bytes here than in the all-pods table, and the two
                # share the page's cache namespace. Staleness is the
                # salt's job; the prefix only prevents key collision.
                row_key=lambda p: f"pending:{_pod_key(p)}",
                row_salt=lambda p: (
                    _pod_key(p),
                    tpu.get_pod_chip_request(p),
                    waiting_reason(p),
                    age_cell(p, now),
                ),
            ),
            class_="hl-attention",
        )

    return h(
        "div",
        {"class_": "hl-page hl-pods"},
        error_banner(snap),
        summary,
        all_pods,
        attention,
    )

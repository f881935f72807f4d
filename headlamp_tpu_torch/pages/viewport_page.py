"""FleetPage — the drill-down surface: fleet → cluster → slice → node,
every level O(what-is-on-screen).

The port's copy of ``headlamp_tpu/pages/viewport_page.py``. The root
shows per-cluster rollup rows (computed on the device at scale); a
cluster shows its slices; a slice shows a cursor-windowed node table. No
level ever renders a row per fleet node, so the 16k-node fleet paints in
the same bytes as the 1k one. Each drill-down path is also the key of a
region-scoped push stream (``/events?region=<path>``), and the page
says so.
"""

from __future__ import annotations

import urllib.parse
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
    h,
)
from ..ui.vdom import Element
from ..viewport import parse_region, viewport_tree, window_nodes
from ..viewport.tree import Region
from .common import cursor_controls, error_banner, ready_label
from .native import node_link

BASE_URL = "/tpu/fleet"


def _region_salt(region: Region) -> tuple:
    """Everything a rollup row paints. The stats dict comes from the
    viewport tree's per-generation memo, so this costs six dict reads."""
    return (
        region.path,
        region.key,
        region.stats["nodes"],
        region.stats["ready"],
        region.stats["capacity"],
        region.stats["allocatable"],
        region.stats["in_use"],
        region.stats["pending"],
    )


def _region_href(path: str) -> str:
    return f"{BASE_URL}?region={urllib.parse.quote(path, safe='/')}"


def _region_link(region: Region) -> Element:
    return h("a", {"href": _region_href(region.path), "class_": "hl-res-link"}, region.key)


def _stats_columns(link_label: str) -> list[dict[str, Any]]:
    return [
        {"label": link_label, "getter": _region_link},
        {"label": "Nodes", "getter": lambda r: r.stats["nodes"]},
        {"label": "Ready", "getter": lambda r: f"{r.stats['ready']}/{r.stats['nodes']}"},
        {"label": "Chips", "getter": lambda r: r.stats["capacity"]},
        {
            "label": "Allocation",
            "getter": lambda r: UtilizationBar(
                r.stats["in_use"], r.stats["allocatable"], unit="chips"
            ),
        },
        {"label": "Pending pods", "getter": lambda r: r.stats["pending"]},
    ]


def _breadcrumbs(cluster: str | None = None, slice_: str | None = None) -> Element:
    bits: list[Any] = [h("a", {"href": BASE_URL, "class_": "hl-res-link"}, "Fleet")]
    if cluster is not None:
        bits.append(" › ")
        if slice_ is None:
            bits.append(f"cluster {cluster}")
        else:
            bits.append(
                h(
                    "a",
                    {"href": _region_href(f"cluster/{cluster}"), "class_": "hl-res-link"},
                    f"cluster {cluster}",
                )
            )
            bits.append(f" › slice {slice_}")
    return h("p", {"class_": "hl-hint hl-breadcrumbs"}, *bits)


def _events_hint(path: str) -> Element:
    return h(
        "p",
        {"class_": "hl-hint hl-region-events"},
        "Live updates for this region: ",
        h("code", None, f"/events?region={path}"),
    )


def _unknown_region(region: str) -> Element:
    return EmptyContent(
        h("h3", None, "No such region"),
        h(
            "p",
            None,
            f"“{region}” matches no drill-down path in this snapshot. "
            "Paths look like cluster/<name> or cluster/<name>/slice/<pool>.",
        ),
    )


def viewport_page(
    snap: ClusterSnapshot,
    *,
    now: float,  # noqa: ARG001 — uniform snapshot-page signature
    provider_name: str = "tpu",
    region: str = "",
    limit: int | None = None,
    cursor: str | None = None,
) -> Element:
    if snap.loading:
        return h("div", {"class_": "hl-page hl-fleet"}, Loader())

    state = snap.provider(provider_name)
    tree = viewport_tree(state)

    if not tree.clusters:
        return h(
            "div",
            {"class_": "hl-page hl-fleet"},
            error_banner(snap),
            EmptyContent(
                h("h3", None, "No TPU fleet"),
                h("p", None, "The snapshot holds no TPU nodes to drill into."),
            ),
        )

    body: list[Any] = [error_banner(snap)]

    parsed = parse_region(region) if region else None
    if region and parsed is None:
        body.extend([_breadcrumbs(), _unknown_region(region)])
        return h("div", {"class_": "hl-page hl-fleet"}, *body)

    if parsed is None:
        # Fleet root: totals + one row per cluster.
        body.append(_breadcrumbs())
        body.append(
            SectionBox(
                "Fleet",
                NameValueTable(
                    [
                        ("Clusters", len(tree.clusters)),
                        ("Nodes", tree.total["nodes"]),
                        ("Ready", f"{tree.total['ready']}/{tree.total['nodes']}"),
                        ("Chips (capacity)", tree.total["capacity"]),
                        ("Chips in use", tree.total["in_use"]),
                        ("Pending pods", tree.total["pending"]),
                        ("Rollup source", tree.source),
                    ]
                ),
            )
        )
        body.append(
            SectionBox(
                "Clusters",
                # Region rows key on the drill-down path, as in JAX.
                SimpleTable(
                    _stats_columns("Cluster"),
                    list(tree.clusters),
                    row_key=lambda r: r.path,
                    row_salt=_region_salt,
                ),
            )
        )
        return h("div", {"class_": "hl-page hl-fleet"}, *body)

    cluster_key, slice_key = parsed
    cluster = tree.region(f"cluster/{cluster_key}")
    if cluster is None:
        body.extend([_breadcrumbs(), _unknown_region(region)])
        return h("div", {"class_": "hl-page hl-fleet"}, *body)

    if slice_key is None:
        # Cluster level: one row per slice.
        body.append(_breadcrumbs(cluster_key))
        body.append(
            SectionBox(
                f"Cluster {cluster_key}",
                NameValueTable(
                    [
                        ("Slices", len(cluster.children)),
                        ("Nodes", cluster.stats["nodes"]),
                        ("Ready", f"{cluster.stats['ready']}/{cluster.stats['nodes']}"),
                        ("Chips in use", cluster.stats["in_use"]),
                        ("Pending pods", cluster.stats["pending"]),
                    ]
                ),
                SimpleTable(
                    _stats_columns("Slice"),
                    list(cluster.children),
                    row_key=lambda r: r.path,
                    row_salt=_region_salt,
                ),
            )
        )
        body.append(_events_hint(cluster.path))
        return h("div", {"class_": "hl-page hl-fleet"}, *body)

    slice_region = tree.region(f"cluster/{cluster_key}/slice/{slice_key}")
    if slice_region is None:
        body.extend([_breadcrumbs(cluster_key), _unknown_region(region)])
        return h("div", {"class_": "hl-page hl-fleet"}, *body)

    # Slice level: region-scoped cursor window of node rows.
    window = window_nodes(
        state,
        limit=limit if limit is not None else 64,
        cursor=cursor,
        region=slice_region.path,
    )
    body.append(_breadcrumbs(cluster_key, slice_key))
    body.append(
        SectionBox(
            f"Slice {slice_key}",
            NameValueTable(
                [
                    ("Nodes", slice_region.stats["nodes"]),
                    ("Ready", f"{slice_region.stats['ready']}/{slice_region.stats['nodes']}"),
                    ("Chips (capacity)", slice_region.stats["capacity"]),
                    ("Chips in use", slice_region.stats["in_use"]),
                    ("Pending pods", slice_region.stats["pending"]),
                ]
            ),
            cursor_controls(
                BASE_URL,
                window,
                what="nodes",
                extra_params={"region": slice_region.path},
            ),
            SimpleTable(
                [
                    {"label": "Name", "getter": node_link},
                    {"label": "Ready", "getter": lambda n: ready_label(obj.is_node_ready(n))},
                    {"label": "Chips", "getter": tpu.get_node_chip_capacity},
                    {
                        "label": "Worker",
                        "getter": lambda n: (
                            w if (w := tpu.get_node_worker_id(n)) is not None else "—"
                        ),
                    },
                ],
                window.rows,
                row_key=obj.name,
                row_salt=lambda n: (
                    obj.name(n),
                    obj.is_node_ready(n),
                    tpu.get_node_chip_capacity(n),
                    tpu.get_node_worker_id(n),
                ),
            ),
        )
    )
    body.append(_events_hint(slice_region.path))
    return h("div", {"class_": "hl-page hl-fleet"}, *body)

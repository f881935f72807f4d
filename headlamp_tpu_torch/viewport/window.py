"""Cursor-windowed row selection over the snapshot.

The port's copy of ``headlamp_tpu/viewport/window.py``: the node and pod
tables, the drill-down page and the trend page's browse mode use it.

The cost model: the first window cut from a new snapshot generation pays
one O(N log N) sort per (collection, filter, region); the result is
memoized on the snapshot view, and every later window — any client, any
page depth — is a binary search plus an O(limit) slice. Region
membership comes from the viewport tree (``tree.py``).

Sort orders are the ones the legacy pages pinned: nodes not-ready-first
then by name, pods by namespaced name. The sort KEY doubles as the
cursor key — see ``cursor.py`` for why seek cursors survive churn where
offsets do not.
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from dataclasses import dataclass
from typing import Any, Callable

from ..domain import objects as obj
from .cursor import SORT_NODES, SORT_PODS, SORT_SERIES, decode_cursor, encode_cursor, query_hash
from .tree import viewport_tree

#: Default window size — one screenful of rows.
DEFAULT_LIMIT = 64
#: Hard ceiling; a windowed response is bounded no matter the query.
MAX_LIMIT = 512

_MEMO_LOCK = threading.Lock()


@dataclass(frozen=True)
class Window:
    """One cursor window: the rows, where they sit, how to continue."""

    rows: list[Any]
    total: int
    start: int
    next_cursor: str | None
    generation: int | None
    limit: int


def clamp_limit(limit: int) -> int:
    return min(max(int(limit), 1), MAX_LIMIT)


def _view_memo(view: Any) -> dict:
    """The per-snapshot memo dict, attached to the view object itself —
    its lifetime IS the generation's lifetime, so there is no staleness
    to manage and no cross-app key collision."""
    memo = getattr(view, "_viewport_memo", None)
    if memo is None:
        with _MEMO_LOCK:
            memo = getattr(view, "_viewport_memo", None)
            if memo is None:
                memo = {}
                view._viewport_memo = memo
    return memo


def _memoized(view: Any, key: tuple, build: Callable[[], Any]) -> Any:
    """Versioned views memoize ``build()`` under ``key``; unversioned
    views (CLI one-shots, raw test views) compute every call — exactly
    the device cache's contract."""
    if getattr(view, "version", None) is None:
        return build()
    memo = _view_memo(view)
    value = memo.get(key)
    if value is None:
        value = build()
        with _MEMO_LOCK:
            value = memo.setdefault(key, value)
    return value


def pods_by_node(state: Any) -> dict[str, list[Any]]:
    """nodeName -> pods, built once per snapshot generation."""

    def build() -> dict[str, list[Any]]:
        out: dict[str, list[Any]] = {}
        for p in state.pods:
            node = obj.pod_node_name(p)
            if node:
                out.setdefault(node, []).append(p)
        return out

    return _memoized(state.view, ("pods_by_node",), build)


def running_chips(state: Any) -> int:
    """Chips requested by Running pods — the workload-summary number,
    computed once per generation. Counts every Running pod, scheduled or
    not."""
    from ..domain import tpu

    def build() -> int:
        return sum(
            tpu.get_pod_chip_request(p) for p in state.pods if obj.pod_phase(p) == "Running"
        )

    return _memoized(state.view, ("running_chips",), build)


def pending_pods(state: Any) -> list[Any]:
    """Pending pods in snapshot order, once per generation — the
    attention-table input."""

    def build() -> list[Any]:
        return [p for p in state.pods if obj.pod_phase(p) == "Pending"]

    return _memoized(state.view, ("pending_pods",), build)


def _node_key(node: Any) -> tuple[int, str]:
    return (1 if obj.is_node_ready(node) else 0, obj.name(node))


def _pod_key(pod: Any) -> tuple[str]:
    ns = obj.namespace(pod)
    name = obj.name(pod)
    return (f"{ns}/{name}" if ns else name,)


def _sorted_nodes(state: Any, query: str, region: str | None) -> tuple[list[tuple], list[Any]]:
    """(sorted keys, same-order nodes) for one (filter, region) — THE
    per-generation O(N log N) pass."""

    def build() -> tuple[list[tuple], list[Any]]:
        nodes = state.nodes
        if region is not None:
            member = set(viewport_tree(state).members.get(region, ()))
            nodes = [n for n in nodes if obj.name(n) in member]
        if query:
            needle = query.lower()
            nodes = [n for n in nodes if needle in obj.name(n).lower()]
        keyed = sorted(((_node_key(n), n) for n in nodes), key=lambda kv: kv[0])
        return [k for k, _n in keyed], [n for _k, n in keyed]

    return _memoized(state.view, ("nodes", query_hash(query), region or ""), build)


def _sorted_pods(state: Any, query: str, region: str | None) -> tuple[list[tuple], list[Any]]:
    def build() -> tuple[list[tuple], list[Any]]:
        pods = state.pods
        if region is not None:
            member = set(viewport_tree(state).members.get(region, ()))
            pods = [p for p in pods if (obj.pod_node_name(p) or "") in member]
        if query:
            needle = query.lower()
            pods = [p for p in pods if needle in _pod_key(p)[0].lower()]
        keyed = sorted(((_pod_key(p), p) for p in pods), key=lambda kv: kv[0])
        return [k for k, _p in keyed], [p for _k, p in keyed]

    return _memoized(state.view, ("pods", query_hash(query), region or ""), build)


def _cut(
    keys: list[tuple],
    items: list[Any],
    *,
    sort: str,
    query: str,
    limit: int,
    cursor: str | None,
    generation: int | None,
) -> Window:
    """Seek + slice: binary-search past the cursor key, take ``limit``
    rows, mint the continuation cursor from the last one."""
    limit = clamp_limit(limit)
    start = 0
    decoded = decode_cursor(cursor) if cursor else None
    if decoded is not None and decoded.sort == sort and decoded.query_hash == query_hash(query):
        start = bisect_right(keys, decoded.last_key)
    rows = items[start : start + limit]
    next_cursor = None
    if start + limit < len(items) and rows:
        next_cursor = encode_cursor(
            generation=generation or 0,
            sort=sort,
            query=query,
            last_key=keys[start + len(rows) - 1],
        )
    return Window(
        rows=rows,
        total=len(items),
        start=start,
        next_cursor=next_cursor,
        generation=generation,
        limit=limit,
    )


def window_nodes(
    state: Any,
    *,
    limit: int = DEFAULT_LIMIT,
    cursor: str | None = None,
    query: str = "",
    region: str | None = None,
) -> Window:
    """A cursor window of nodes, not-ready-first then by name —
    optionally restricted to one drill-down region."""
    keys, items = _sorted_nodes(state, query, region)
    return _cut(
        keys,
        items,
        sort=SORT_NODES,
        query=query,
        limit=limit,
        cursor=cursor,
        generation=getattr(state.view, "version", None),
    )


def window_pods(
    state: Any,
    *,
    limit: int = DEFAULT_LIMIT,
    cursor: str | None = None,
    query: str = "",
    region: str | None = None,
) -> Window:
    """A cursor window of pods in namespaced-name order — optionally
    restricted to the pods on one drill-down region's nodes."""
    keys, items = _sorted_pods(state, query, region)
    return _cut(
        keys,
        items,
        sort=SORT_PODS,
        query=query,
        limit=limit,
        cursor=cursor,
        generation=getattr(state.view, "version", None),
    )


def window_series(
    labels_and_items: list[tuple[str, Any]],
    *,
    limit: int = DEFAULT_LIMIT,
    cursor: str | None = None,
    query: str = "",
    generation: int | None = None,
) -> Window:
    """A cursor window over trend series, sorted by label: label order is
    stable under value churn, which is why the busiest-first grouped view
    cannot page and this listing can. The caller passes (label, item)
    pairs; there is no snapshot memo, as the history tier already hands
    over a point-in-time list."""
    keyed = sorted(labels_and_items, key=lambda kv: kv[0])
    keys: list[tuple] = [(label,) for label, _item in keyed]
    items = [item for _label, item in keyed]
    return _cut(
        keys,
        items,
        sort=SORT_SERIES,
        query=query,
        limit=limit,
        cursor=cursor,
        generation=generation,
    )

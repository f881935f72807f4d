"""Provider-neutral Kubernetes object helpers.

All cluster data enters the framework as plain JSON-shaped dicts (the same
contract the TS plugin gets from Headlamp's ApiProxy after jsonData
unwrapping). These helpers are total: any malformed input yields a neutral
value rather than raising, mirroring the boundary-validation discipline of
the reference domain layer (`src/api/k8s.ts:125-131`).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Mapping


from collections.abc import Mapping as _AbcMapping


def _is_mapping(value: Any) -> bool:
    """dict fast path first: all real API data is plain dicts, and an
    abc-Mapping isinstance is ~10x the cost of the exact-type check —
    measurable at fleet scale (hundreds of thousands of calls per
    dashboard paint)."""
    return type(value) is dict or isinstance(value, _AbcMapping)


def _as_mapping(value: Any) -> Mapping[str, Any]:
    return value if _is_mapping(value) else {}


def metadata(obj: Any) -> Mapping[str, Any]:
    return _as_mapping(_as_mapping(obj).get("metadata"))


def name(obj: Any) -> str:
    return str(metadata(obj).get("name", ""))


def namespace(obj: Any) -> str:
    return str(metadata(obj).get("namespace", ""))


def uid(obj: Any) -> str:
    return str(metadata(obj).get("uid", ""))


def labels(obj: Any) -> Mapping[str, str]:
    return _as_mapping(metadata(obj).get("labels"))


def creation_timestamp(obj: Any) -> str | None:
    ts = metadata(obj).get("creationTimestamp")
    return str(ts) if ts else None


def status(obj: Any) -> Mapping[str, Any]:
    return _as_mapping(_as_mapping(obj).get("status"))


def spec(obj: Any) -> Mapping[str, Any]:
    return _as_mapping(_as_mapping(obj).get("spec"))


# ---------------------------------------------------------------------------
# Node helpers
# ---------------------------------------------------------------------------

def node_capacity(node: Any) -> Mapping[str, Any]:
    return _as_mapping(status(node).get("capacity"))


def node_allocatable(node: Any) -> Mapping[str, Any]:
    return _as_mapping(status(node).get("allocatable"))


def _has_ready_condition(obj: Any) -> bool:
    conditions = status(obj).get("conditions")
    if not isinstance(conditions, list):
        return False
    return any(
        _is_mapping(c) and c.get("type") == "Ready" and c.get("status") == "True"
        for c in conditions
    )


def is_node_ready(node: Any) -> bool:
    """Ready condition check (reference: k8s.ts:329-331)."""
    return _has_ready_condition(node)


def node_info(node: Any) -> Mapping[str, Any]:
    return _as_mapping(status(node).get("nodeInfo"))


# ---------------------------------------------------------------------------
# Pod helpers
# ---------------------------------------------------------------------------

def pod_phase(pod: Any) -> str:
    return str(status(pod).get("phase") or "Unknown")


def pod_node_name(pod: Any) -> str | None:
    node = spec(pod).get("nodeName")
    return str(node) if node else None


def pod_containers(pod: Any, include_init: bool = True) -> list[Mapping[str, Any]]:
    """All container specs, optionally including initContainers — the same
    union the reference scans for resource requests (k8s.ts:250-264)."""
    s = spec(pod)
    out: list[Mapping[str, Any]] = []
    for key in ("containers", "initContainers") if include_init else ("containers",):
        items = s.get(key)
        if isinstance(items, list):
            out.extend(c for c in items if _is_mapping(c))
    return out


def pod_init_containers(pod: Any) -> list[Mapping[str, Any]]:
    items = spec(pod).get("initContainers")
    return [c for c in items if _is_mapping(c)] if isinstance(items, list) else []


def container_requests(container: Mapping[str, Any]) -> Mapping[str, Any]:
    return _as_mapping(_as_mapping(container.get("resources")).get("requests"))


def container_limits(container: Mapping[str, Any]) -> Mapping[str, Any]:
    return _as_mapping(_as_mapping(container.get("resources")).get("limits"))


def pod_resource_keys(pod: Any) -> set[str]:
    """Union of requests∪limits resource names over every container
    (init included). One pass feeds every provider's pod detection in
    classify_fleet — each provider re-walking the container list was
    the sync path's hottest loop at fleet scale."""
    keys: set[str] = set()
    for c in pod_containers(pod):
        keys.update(container_requests(c))
        keys.update(container_limits(c))
    return keys


def pod_restarts(pod: Any) -> int:
    """Total container restart count (reference: k8s.ts:307-309)."""
    statuses = status(pod).get("containerStatuses")
    if not isinstance(statuses, list):
        return 0
    total = 0
    for c in statuses:
        if _is_mapping(c):
            total += parse_int(c.get("restartCount"))
    return total


# ---------------------------------------------------------------------------
# Scalar parsing / formatting
# ---------------------------------------------------------------------------

def parse_int(value: Any) -> int:
    """Lenient integer parse: ints, numeric strings, floats; else 0.

    Matches the `parseInt(v, 10) || 0` idiom used throughout the reference
    (k8s.ts:177, k8s.ts:296).
    """
    if isinstance(value, bool):
        return int(value)
    if isinstance(value, int):
        return value
    if isinstance(value, float):
        return int(value)
    if isinstance(value, str):
        digits = ""
        stripped = value.strip()
        for i, ch in enumerate(stripped):
            if ch.isdigit() or (i == 0 and ch in "+-"):
                digits += ch
            else:
                break
        try:
            return int(digits)
        except ValueError:
            return 0
    return 0


def is_kube_list(value: Any) -> bool:
    """List-envelope guard (reference: k8s.ts:320-323)."""
    return _is_mapping(value) and isinstance(value.get("items"), list)


def kube_list_items(value: Any) -> list[Any]:
    return list(value["items"]) if is_kube_list(value) else []


def dedup_by_uid(objs: Iterable[Any]) -> list[Any]:
    """Drop objects with duplicate (or missing) UIDs, preserving order —
    the multi-selector merge used for plugin daemon pods
    (`src/api/IntelGpuDataContext.tsx:168-174`)."""
    seen: set[str] = set()
    out = []
    for o in objs:
        u = uid(o)
        if not u or u in seen:
            continue
        seen.add(u)
        out.append(o)
    return out


def allocation_summary(
    nodes: Iterable[Any],
    pods: Iterable[Any],
    capacity_fn: Callable[[Any], int],
    allocatable_fn: Callable[[Any], int],
    request_fn: Callable[[Any], int],
) -> dict[str, int]:
    """Capacity/allocatable from nodes; in-use from Running pods' device
    requests — the OverviewPage allocation summary
    (`src/components/OverviewPage.tsx:88-116`),
    parameterized over a provider's counting functions so TPU and Intel
    share one implementation."""
    capacity = sum(capacity_fn(n) for n in nodes)
    allocatable = sum(allocatable_fn(n) for n in nodes)
    in_use = sum(request_fn(p) for p in pods if pod_phase(p) == "Running")
    pct = round(in_use / capacity * 100) if capacity > 0 else 0
    return {
        "capacity": capacity,
        "allocatable": allocatable,
        "in_use": in_use,
        "free": allocatable - in_use,
        "utilization_pct": pct,
    }


def count_pod_phases(pods: Iterable[Any]) -> dict[str, int]:
    """Phase histogram with an Other bucket (`OverviewPage.tsx:122-130`).
    Provider-neutral: both the TPU and Intel overview/pods pages consume
    it."""
    counts = {"Running": 0, "Pending": 0, "Succeeded": 0, "Failed": 0, "Other": 0}
    for p in pods:
        phase = pod_phase(p)
        counts[phase if phase in counts else "Other"] += 1
    return counts


def format_age(timestamp: str | None, now_epoch_s: float) -> str:
    """Human age from an RFC3339 timestamp: s/m/h/d buckets
    (reference: k8s.ts:337-348). ``now_epoch_s`` is explicit so callers and
    tests control the clock."""
    if not timestamp:
        return "unknown"
    import datetime

    try:
        ts = timestamp.replace("Z", "+00:00")
        then = datetime.datetime.fromisoformat(ts).timestamp()
    except ValueError:
        return "unknown"
    secs = int(now_epoch_s - then)
    if secs < 0:
        secs = 0
    if secs < 60:
        return f"{secs}s"
    mins = secs // 60
    if mins < 60:
        return f"{mins}m"
    hours = mins // 60
    if hours < 24:
        return f"{hours}h"
    return f"{hours // 24}d"

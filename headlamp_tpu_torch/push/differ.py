"""Generation-keyed snapshot differ.

The port's copy of ``headlamp_tpu/push/differ.py``. Pages rebuild whole
element trees per request (there is no tree diff), so the differ works
one level up: it reduces each diffable page to a compact page model,
scalar cells plus keyed rows of scalars, and diffs the models of one
sync generation against the previous one's. Changed cells, changed rows
and removed row keys become one JSON patch frame per page; an unchanged
page produces no frame. A frame is what the page displays, not how it
is painted.

Models are pure functions of (snapshot, metrics peek, forecast peek):
building one never fetches, never locks and never touches a device. It
runs on the sync thread right after ``_record_sync``.

Floats are rounded to four digits before comparison: a refit that moves
a prediction by 1e-9 is not a fleet change, and noise frames would turn
push back into polling.
"""

from __future__ import annotations

from typing import Any, Mapping

from ..viewport.tree import node_region, region_path

#: The diffable page set: the surfaces whose content is a function of the
#: snapshot generation and the metrics and forecast peeks. Debug pages
#: change per request and are left out. Region pages are not listed:
#: their keys are dynamic (``region:cluster/<c>[/slice/<s>]``, one per
#: drill-down region), and a client opts into one with ``?region=``.
PAGES = ("/tpu", "/tpu/nodes", "/tpu/pods", "/tpu/metrics")

#: Page-key prefix of the per-region models and frames. A region page's
#: rows are the same row lists as ``/tpu/nodes`` (shared references); its
#: cells are the region's rollup sums, so one node flipping Ready makes a
#: frame whose size follows the region, not the fleet.
REGION_PAGE_PREFIX = "region:"


def _node_ready(node: Mapping[str, Any]) -> bool:
    for cond in ((node.get("status") or {}).get("conditions")) or []:
        if cond.get("type") == "Ready":
            return cond.get("status") == "True"
    return False


def _name(obj: Mapping[str, Any]) -> str:
    return str(((obj.get("metadata") or {}).get("name")) or "")


def _round(value: Any, digits: int = 4) -> Any:
    if isinstance(value, float):
        return round(value, digits)
    return value


def build_page_models(
    snap: Any, *, metrics: Any = None, forecast: Any = None
) -> dict[str, dict[str, Any]]:
    """Page models for every diffable page, each
    ``{"cells": {name: scalar}, "rows": {key: [scalar, ...]}}`` and
    JSON-able by construction (frames go out ``json.dumps``ed as is)."""
    overview_cells: dict[str, Any] = {
        "errors": len(getattr(snap, "errors", []) or []),
        "loading": bool(getattr(snap, "loading", False)),
    }
    node_rows: dict[str, list[Any]] = {}
    pod_rows: dict[str, list[Any]] = {}
    region_models: dict[str, dict[str, Any]] = {}

    def _region(key: str) -> dict[str, Any]:
        model = region_models.get(key)
        if model is None:
            model = region_models[key] = {
                "cells": {
                    "nodes_total": 0,
                    "nodes_ready": 0,
                    "capacity": 0,
                    "allocatable": 0,
                    "in_use": 0,
                    "pods_total": 0,
                },
                "rows": {},
            }
        return model

    for pname, state in (getattr(snap, "providers", {}) or {}).items():
        view = state.view
        summary = view.allocation_summary()
        for key, value in summary.items():
            overview_cells[f"{pname}.{key}"] = value
        overview_cells[f"{pname}.nodes"] = len(view.nodes)
        overview_cells[f"{pname}.pods"] = len(view.pods)
        overview_cells[f"{pname}.plugin_installed"] = bool(view.plugin_installed)
        provider = view.provider
        # Regions are a TPU-fleet concept (cluster label and node pool).
        track_regions = pname == "tpu"
        region_keys_of: dict[str, tuple[str, str]] = {}
        for node in view.nodes:
            name = _name(node)
            ready = _node_ready(node)
            capacity = int(provider.node_device_capacity(node))
            allocatable = int(provider.node_device_allocatable(node))
            row = [pname, ready, capacity, allocatable]
            node_rows[name] = row
            if track_regions:
                ck, sk = node_region(node)
                cluster_key = REGION_PAGE_PREFIX + region_path(ck)
                slice_key = REGION_PAGE_PREFIX + region_path(ck, sk)
                region_keys_of[name] = (cluster_key, slice_key)
                for region_key in (cluster_key, slice_key):
                    model = _region(region_key)
                    model["rows"][name] = row  # shared reference
                    cells = model["cells"]
                    cells["nodes_total"] += 1
                    cells["nodes_ready"] += 1 if ready else 0
                    cells["capacity"] += capacity
                    cells["allocatable"] += allocatable
        for pod in view.pods:
            meta = pod.get("metadata") or {}
            key = f"{meta.get('namespace', '')}/{meta.get('name', '')}"
            phase = str(((pod.get("status") or {}).get("phase")) or "")
            node_name = str(((pod.get("spec") or {}).get("nodeName")) or "")
            request = int(provider.pod_device_request(pod))
            pod_rows[key] = [pname, phase, node_name, request]
            if track_regions and node_name in region_keys_of:
                for region_key in region_keys_of[node_name]:
                    cells = _region(region_key)["cells"]
                    cells["pods_total"] += 1
                    if phase == "Running":
                        cells["in_use"] += request

    metrics_cells: dict[str, Any] = {"available": metrics is not None}
    metrics_rows: dict[str, list[Any]] = {}
    if metrics is not None:
        metrics_cells["chips"] = len(metrics.chips)
        for chip in metrics.chips:
            metrics_rows[f"{chip.node}/{chip.accelerator_id}"] = [
                _round(chip.tensorcore_utilization),
                _round(chip.duty_cycle),
                _round(chip.hbm_bytes_used, 0),
                _round(chip.hbm_bytes_total, 0),
            ]
    metrics_cells["forecast"] = forecast is not None
    if forecast is not None:
        metrics_cells["forecast_horizon_s"] = int(forecast.horizon_s)
        metrics_cells["forecast_at_risk"] = sum(1 for c in forecast.chips if c.saturation_risk)
        for chip in forecast.chips:
            metrics_rows[f"forecast:{chip.node}/{chip.accelerator_id}"] = [
                _round(chip.current),
                _round(chip.predicted_peak),
                _round(chip.predicted_mean),
                bool(chip.saturation_risk),
            ]

    models: dict[str, dict[str, Any]] = {
        "/tpu": {"cells": overview_cells, "rows": {}},
        "/tpu/nodes": {"cells": {"total": len(node_rows)}, "rows": node_rows},
        "/tpu/pods": {"cells": {"total": len(pod_rows)}, "rows": pod_rows},
        "/tpu/metrics": {"cells": metrics_cells, "rows": metrics_rows},
    }
    models.update(region_models)
    return models


def diff_models(
    prev: Mapping[str, Mapping[str, Any]],
    new: Mapping[str, Mapping[str, Any]],
) -> dict[str, dict[str, Any]]:
    """Per-page patch frames: cells whose value changed, rows added or
    changed (whole rows: a row is a handful of scalars), and removed row
    keys. A page with no change gets no entry."""
    frames: dict[str, dict[str, Any]] = {}
    for page, model in new.items():
        before = prev.get(page) or {"cells": {}, "rows": {}}
        prev_cells = before.get("cells", {})
        prev_rows = before.get("rows", {})
        cells = {
            key: value
            for key, value in model.get("cells", {}).items()
            if prev_cells.get(key, _MISSING) != value
        }
        rows = {
            key: value
            for key, value in model.get("rows", {}).items()
            if prev_rows.get(key, _MISSING) != value
        }
        removed = sorted(key for key in prev_rows if key not in model.get("rows", {}))
        if cells or rows or removed:
            frames[page] = {"page": page, "cells": cells, "rows": rows, "removed": removed}
    return frames


#: Change-set key prefix of a changed cell, so a consumer tells "row
#: node-0007 changed" from "the overview total moved".
CELL_KEY_PREFIX = "cell:"


def frame_changed_keys(frame: Mapping[str, Any]) -> set[str]:
    """The change set of one patch frame: every row key added, changed or
    removed, plus ``cell:``-prefixed names of changed cells. Read off the
    frame the differ built, never a second diff."""
    keys: set[str] = set(frame.get("rows") or ())
    keys.update(frame.get("removed") or ())
    keys.update(CELL_KEY_PREFIX + name for name in (frame.get("cells") or ()))
    return keys


class ChangeLog:
    """Bounded ring of per-generation change sets.

    ``record`` runs at diff time on the sync thread; ``changed_keys``
    answers "which of page P's keys changed since generation G". It
    answers None (unknown: treat everything as changed) when G predates
    the ring; the fragment cache's salts make over-invalidation safe."""

    def __init__(self, limit: int = 64) -> None:
        self._limit = max(1, int(limit))
        #: generation -> {page: keys}, in insertion order (the pipeline
        #: only records rising generations).
        self._gens: dict[int, dict[str, set[str]]] = {}

    def record(
        self, generation: int, frames: Mapping[str, Mapping[str, Any]]
    ) -> dict[str, set[str]]:
        changed = {page: frame_changed_keys(frame) for page, frame in frames.items()}
        self._gens[int(generation)] = changed
        while len(self._gens) > self._limit:
            del self._gens[next(iter(self._gens))]
        return changed

    def oldest(self) -> int | None:
        return next(iter(self._gens)) if self._gens else None

    def changed_keys(self, page: str, gen: int) -> set[str] | None:
        """Keys of ``page`` changed in any generation after ``gen``; None
        when ``gen`` is older than the ring's horizon."""
        gens = self._gens
        if gens:
            oldest = next(iter(gens))
            if gen < oldest - 1:
                return None
        out: set[str] = set()
        for generation, pages in gens.items():
            if generation > gen:
                out |= pages.get(page, set())
        return out


class _Missing:
    """Sentinel unequal to every model value (None is a real cell value:
    an absent metric sample)."""

    __slots__ = ()

    def __eq__(self, other: object) -> bool:
        return other is self

    def __ne__(self, other: object) -> bool:
        return other is not self


_MISSING = _Missing()


__all__ = [
    "CELL_KEY_PREFIX",
    "PAGES",
    "REGION_PAGE_PREFIX",
    "ChangeLog",
    "build_page_models",
    "diff_models",
    "frame_changed_keys",
]

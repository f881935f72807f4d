"""The result line of one run."""

from __future__ import annotations

from typing import Any

from . import devtrace
from .spec import Cell


def result_line(cell: Cell, record: dict[str, Any], trace: bool) -> dict[str, Any]:
    run = record["run"]
    metrics: dict[str, dict[str, Any]] = {}
    for metric in cell.per_layer if trace else cell.end_to_end:
        value = metric.read(run)
        if value is not None:
            metrics[metric.name] = {"value": value, "unit": metric.unit}
    compared = record["compared"]
    correct = all(
        c["value"] <= c["limit"]
        for name, c in compared.items()
        if c["limit"] is not None and not name.startswith("control.")
    )
    device: dict[str, Any] = {
        "platform": "gpu", "kind": record["kind"], "count": cell.chips,
        "memory_peak_bytes": record["memory_peak_bytes"],
    }
    line: dict[str, Any] = {
        "correct": bool(correct),
        "attempted": len(run.paints),
        "failed": sum(1 for p in run.paints if p.status != 200 or not p.ok),
        "metrics": metrics,
        "device": device,
    }
    if trace and run.device is not None:
        device["busy_s"] = run.device.busy_s(run.start, run.end)
        device["window_s"] = run.seconds
        gaps = sorted(run.device.gaps(run.start, run.end), key=lambda g: g[0] - g[1])[:10]
        line["breakdown"] = {
            "device_ops": run.device.top_ops(run.start, run.end),
            "idle_gaps": [
                [devtrace.host_span_at(run.traces, (a + b) / 2 + run.wall_minus_mono), b - a]
                for a, b in gaps
            ],
        }
    line["compared"] = compared
    return line

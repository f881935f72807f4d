"""Find a cell's pieces by name: ``BENCHMARK.json`` and the files it names.

A cell names a configuration and a traffic mix; each is a file of its own
(``configs/<name>.json``, ``traffic/<name>.json``), and each metric is a
reader of its own (``metrics/<name>.py``, a ``read(run)`` function that
returns a number or None). The configuration names its fleet's generator
(``fleets/<generator>.py``) and the traffic its judge
(``judges/<judge>.py``), whose page checks are ``reference/pages/
<route>.py``. Adding a cell, a mix, a fleet, a page or a metric is adding
files; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable[[Any], float | None]


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict[str, Any]
    traffic_name: str
    traffic: dict[str, Any]
    end_to_end: list[Metric]
    per_layer: list[Metric]
    #: The benchmark's folder the cell's files were found in.
    bench_dir: Path = BENCH_DIR


def load_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable[[Any], float | None]:
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _applies(entry: dict[str, Any], cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(workload: str, root: Path, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = json.loads((root / config_entry["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{entry['traffic']}.json").read_text())

    def metrics(key: str) -> list[Metric]:
        return [
            Metric(m["name"], m["unit"], load_reader(m["name"], bench_dir))
            for m in spec[key] if _applies(m, workload)
        ]

    return Cell(
        name=workload, chips=int(entry["chips"]), config_name=entry["config"], config=config,
        traffic_name=entry["traffic"], traffic=traffic,
        end_to_end=metrics("end_to_end"), per_layer=metrics("per_layer"), bench_dir=bench_dir,
    )

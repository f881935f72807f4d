"""Shared fixtures of the benchmark's tests.

They run on the CPU: the harness hosts the port with ``device="cpu"``
(the kernel's plain version) at fleets a test can hold, through the same
session, clients, stand-in and reference as a run on the card. None
needs the card.
"""

from __future__ import annotations

import copy
import time
from pathlib import Path
from typing import Any

from benchmark.harness import report, session
from benchmark.harness.spec import load_cell

ROOT = Path(__file__).resolve().parents[2]

DRILL = "v5e16k.drilldown"

#: Fleets a CPU test can hold, per configuration.
SMALL_FLEETS = {
    "gke_v5e_16k": {"generator": "fleet_viewport", "nodes": 512, "clusters": 8},
}

#: A CPU run's traffic: a fast background sync, fleet changes inside a
#: window of a few seconds, and kept answers drawn from as many paints as
#: a client makes in it.
SMALL_TRAFFIC = {
    "background_sync_s": 0.25,
    "keep": {"per_client": 8, "within_first": 200},
    "fleet_changes": {"hosts": 8, "at_s": [0.5, 1.5]},
}


def small_cell(workload: str = DRILL, clients: int = 3, fleet: dict[str, Any] | None = None,
               **traffic: Any) -> Any:
    cell = load_cell(workload, ROOT)
    cell.config = copy.deepcopy(cell.config)
    cell.config["fleet"] = fleet or SMALL_FLEETS[cell.config_name]
    cell.traffic = {**copy.deepcopy(cell.traffic), "clients": clients, **SMALL_TRAFFIC,
                    **traffic}
    return cell


def run_small(cell: Any, seed: int = 1234567890123, seconds: float = 3.0, trace: bool = False,
              control: bool = False) -> tuple[dict[str, Any], dict[str, Any]]:
    """One run of ``cell`` on the CPU: (the session's record, the result
    line). A benchmark run is a process of its own; the tests share one,
    so each run starts the port's process-wide SLO engine afresh (an
    earlier run's slow paints would otherwise page it and degrade this
    run's renders)."""
    from headlamp_tpu_torch.obs import slo

    previous = slo.engine()
    slo.set_engine(slo.SLOEngine())
    try:
        record = session.run_cell(cell, seed, seconds, trace, t0=time.monotonic(), device="cpu",
                                  control=control)
    finally:
        slo.set_engine(previous)
    return record, report.result_line(cell, record, trace)

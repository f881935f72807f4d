"""The fleets a configuration names, and the changes a traffic mix makes to them.

A configuration's ``fleet`` block names a generator, which is the file
``fleets/<generator>.py`` with a ``make(n_nodes, seed=..., **kwargs)``
function; a later configuration adds a generator by adding a file. The
fleet is drawn with the configuration's own seed where it fixes the
fleet's shape, else with the run's.

A traffic mix may change the fleet while it runs (``fleet_changes``):
change ``k`` flips the readiness of ``hosts`` TPU hosts drawn from the
seed and ``k``, as the apiserver reports a host that fails or recovers.
Every seed changes as many hosts; which ones changes with the seed. The
stand-in apiserver applies the changes and the correctness check works
out each generation's pages from the same draws.

Nothing here imports the program.
"""

from __future__ import annotations

import copy
import importlib.util
import random
from pathlib import Path
from typing import Any

FLEETS_DIR = Path(__file__).resolve().parent


def make_fleet(spec: dict[str, Any], seed: int, fleets_dir: Path = FLEETS_DIR) -> dict[str, Any]:
    """The fleet ``spec`` names (``{"generator": "fleet_viewport", "nodes": 16384}``),
    drawn with ``spec["seed"]`` where it has one, else with ``seed``."""
    path = fleets_dir / f"{spec['generator']}.py"
    module_spec = importlib.util.spec_from_file_location(f"benchmark.fleets.{spec['generator']}", path)
    if module_spec is None or module_spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(module_spec)
    module.__package__ = "benchmark.fleets"
    module_spec.loader.exec_module(module)
    kwargs = {k: v for k, v in spec.items() if k not in ("generator", "nodes", "seed")}
    return module.make(spec["nodes"], seed=int(spec.get("seed", seed)), **kwargs)


def change_hosts(fleet: dict[str, Any], seed: int, k: int, hosts: int) -> list[int]:
    """Indices into ``fleet["nodes"]`` of the TPU hosts change ``k`` flips."""
    tpu = [i for i, n in enumerate(fleet["nodes"])
           if "google.com/tpu" in n.get("status", {}).get("capacity", {})]
    return sorted(random.Random(f"{seed}:change:{k}").sample(tpu, min(hosts, len(tpu))))


def flip_ready(node: dict[str, Any], resource_version: int | None = None) -> dict[str, Any]:
    """A copy of ``node`` with its ``Ready`` condition flipped (and, for
    the apiserver, stamped with the write's resourceVersion)."""
    out = copy.deepcopy(node)
    for cond in out["status"]["conditions"]:
        if cond.get("type") == "Ready":
            cond["status"] = "False" if cond.get("status") == "True" else "True"
    if resource_version is not None:
        out["metadata"]["resourceVersion"] = str(resource_version)
    return out


def generation(fleet: dict[str, Any], seed: int, changes: dict[str, Any],
               upto: int) -> dict[str, Any]:
    """The fleet after changes ``1..upto``."""
    nodes = list(fleet["nodes"])
    for k in range(1, upto + 1):
        for i in change_hosts(fleet, seed, k, int(changes["hosts"])):
            nodes[i] = flip_ready(nodes[i])
    return {**fleet, "nodes": nodes}

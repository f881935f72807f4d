"""The yardstick's pieces: the frozen fleet, the stand-in's fleet changes,
the import rule, and finding files by name."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.fleets import generation, make_fleet
from benchmark.harness import session, standin
from benchmark.harness.spec import load_cell

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("n, port_seed", [(16384, 7), (512, 3)])
def test_the_frozen_fleet_equals_the_ports_at_its_seed(n: int, port_seed: int) -> None:
    from headlamp_tpu_torch.fleet import fixtures

    spec = {"generator": "fleet_viewport", "nodes": n}
    assert make_fleet(spec, port_seed) == fixtures.fleet_viewport(n, seed=port_seed)


def test_the_stand_in_serves_each_change_as_list_and_watch() -> None:
    config = {"fleet": {"generator": "fleet_viewport", "nodes": 256, "clusters": 8}}
    changes = {"hosts": 5, "at_s": []}
    source = standin.Source(config, seed=99, changes=changes)
    fleet = make_fleet(config["fleet"], 99)
    source.apply_change(1)
    source.apply_change(2)
    listed = json.loads(source.respond("/api/v1/nodes?limit=500")[1])
    expected = generation(fleet, 99, changes, 2)["nodes"]

    def ready(nodes: list) -> list:
        return [n["status"]["conditions"][0]["status"] for n in nodes]

    assert ready(listed["items"]) == ready(expected) != ready(fleet["nodes"])
    assert listed["metadata"]["resourceVersion"] == str(standin.RESOURCE_VERSION + 10)
    events = source.respond(f"/api/v1/nodes?watch=true&resourceVersion={standin.RESOURCE_VERSION + 5}")[1]
    lines = [json.loads(x) for x in events.decode().splitlines()]
    assert [e["type"] for e in lines] == ["MODIFIED"] * 5
    assert [e["object"]["metadata"]["resourceVersion"] for e in lines] == [
        str(standin.RESOURCE_VERSION + k) for k in range(6, 11)]
    gone = json.loads(source.respond("/api/v1/nodes?watch=true&resourceVersion=1")[1])
    assert gone["object"]["code"] == 410
    assert source.respond(f"/api/v1/pods?watch=true&resourceVersion={standin.RESOURCE_VERSION}")[1] == b""


def test_the_import_check_compares_whole_top_level_names(monkeypatch: pytest.MonkeyPatch) -> None:
    import types

    monkeypatch.setitem(sys.modules, "headlamp_tpu_torchlike", types.ModuleType("x"))
    assert "headlamp_tpu" not in session.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "headlamp_tpu.fleet", types.ModuleType("y"))
    assert session.loaded_forbidden() == ["headlamp_tpu"]


def test_the_reference_and_the_processes_load_nothing_of_the_program() -> None:
    code = (
        "import sys\n"
        "import benchmark.reference.fleet, benchmark.harness.standin\n"
        "import benchmark.harness.client, benchmark.harness.traffic\n"
        "from benchmark.harness.session import load_judge\n"
        "judge = load_judge('pages')\n"
        "for route in ('fleet', 'cluster', 'slice', 'nodes', 'node', 'pod'):\n"
        "    judge.load_check(route)\n"
        "print(sorted({m.partition('.')[0] for m in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"jax", "jaxlib", "flax", "headlamp_tpu", "headlamp_tpu_torch"}


def test_pieces_are_found_by_name_and_a_new_cell_needs_only_new_files(tmp_path: Path) -> None:
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    (tmp_path / "benchmark/traffic/fleet_only.json").write_text(json.dumps({
        "clients": 2, "judge": "pages", "session": [{"route": "fleet", "path": "/tpu/fleet"}],
    }))
    (tmp_path / "benchmark/metrics/pages.count.py").write_text(
        "def read(run):\n    return float(len(run.completed()))\n"
    )
    spec["workloads"].append({"name": "v5e16k.fleet_only", "config": "gke_v5e_16k",
                              "traffic": "fleet_only", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "pages.count", "unit": "pages", "better": "higher",
                              "source": "host_clock", "layer": "Pages", "moves": "pages_per_s",
                              "workloads": ["v5e16k.fleet_only"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = load_cell("v5e16k.fleet_only", tmp_path, tmp_path / "benchmark")
    assert cell.traffic["session"][0]["path"] == "/tpu/fleet"
    assert [m.name for m in cell.per_layer][-1] == "pages.count"
    assert [m.name for m in cell.end_to_end] == ["pages_per_s", "setup_s"]
    after = {p: p.read_bytes() for p in before}
    assert after == before

"""Whole runs on the CPU at small fleets: the result line, a cell added
as files, the control that has to fail, and the faults planted under the
timed path that ``correct`` has to catch."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from benchmark.harness.spec import load_cell

from .conftest import ROOT, run_small, small_cell


def test_the_result_line_has_the_contracts_keys() -> None:
    record, line = run_small(small_cell(), seconds=2.5)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True, record["notes"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"pages_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["compared"]) == {"page_mismatches", "generation_lag_s", "non_200"}
    assert all(set(c) == {"value", "limit"} for c in line["compared"].values())
    assert record["changes_applied"] == 2 and record["judged"]["generations"] == 4
    json.dumps(line)


def test_a_cell_with_a_new_route_and_a_new_generator_runs_from_new_files(tmp_path: Path) -> None:
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    bench = tmp_path / "benchmark"
    (bench / "fleets/fleet_two_clusters.py").write_text(
        "from benchmark.fleets.objects import make_plugin_daemonset, make_tpu_node\n\n\n"
        "def make(n_nodes, seed=0):\n"
        "    nodes = [make_tpu_node(f'n{i}', pool=f'p{i % 4}', cluster=str(i % 2),\n"
        "                           worker_id=i // 4, ready=(i + seed) % 7 != 0)\n"
        "             for i in range(n_nodes)]\n"
        "    return {'nodes': nodes, 'pods': [], 'daemonsets': [make_plugin_daemonset()]}\n"
    )
    (bench / "reference/pages/overview.py").write_text(
        "from benchmark.reference import fleet as F\n"
        "from benchmark.reference import html as H\n\n\n"
        "def check(m, facts, path, body):\n"
        "    s = facts.fleet_stats()\n"
        "    F.check_pairs(m, path, H.pairs(H.main(body)), {'Total': s['nodes'], 'Ready': s['ready']})\n"
    )
    (bench / "configs/two_clusters.json").write_text(json.dumps({
        "fleet": {"generator": "fleet_two_clusters", "nodes": 48},
        "limits": {"page_mismatches": 0, "generation_lag_s": 30, "non_200": 0},
    }))
    (bench / "traffic/overview_and_fleet.json").write_text(json.dumps({
        "clients": 2, "judge": "pages",
        "session": [{"route": "overview", "path": "/tpu"}, {"route": "fleet", "path": "/tpu/fleet"}],
        "fleet_changes": {"hosts": 3, "at_s": [0.5]},
        "background_sync_s": 0.25,
    }))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "two_clusters", "source": "test", "reduced": [], "why": "test",
                            "file": "benchmark/configs/two_clusters.json"})
    spec["workloads"].append({"name": "two.overview", "config": "two_clusters",
                              "traffic": "overview_and_fleet", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = load_cell("two.overview", tmp_path, bench)
    record, line = run_small(cell, seconds=2.0)
    assert line["correct"], record["notes"]
    routes = {p.route for p in record["run"].paints}
    assert routes == {"overview", "fleet"} and line["metrics"]["pages_per_s"]["value"] > 0
    assert record["judged"]["answers"] >= 4
    assert {p: p.read_bytes() for p in before} == before


def test_the_control_breaks_exact_counts() -> None:
    # Half precision holds every count below 2048 and multiples of 4 to
    # 8192: the control fails only where counts pass that, as at 4096
    # hosts (16384 chips) and at the cell's 16384.
    fleet = {"generator": "fleet_viewport", "nodes": 4096, "clusters": 8}
    record, line = run_small(small_cell(fleet=fleet), seconds=2.5, control=True)
    assert line["correct"], record["notes"]
    assert line["compared"]["control.page_mismatches"]["value"] > 0


def _sums_fault(kind: str):
    from headlamp_tpu_torch.viewport import tree

    def wrap(original):
        def sums(state, cluster_id, slice_id, region_of, limit):
            if kind == "half":
                class Half:
                    nodes = state.nodes[: len(state.nodes) // 2]
                    pods = state.pods
                    view = state.view
                return original(Half, cluster_id, slice_id, region_of, limit)
            clusters, slices = original(state, cluster_id, slice_id, region_of, limit)
            slices[0] = {**slices[0], "in_use": slices[0]["in_use"] + 4}
            return clusters, slices
        return sums

    return tree, wrap


@pytest.mark.parametrize("kind", ["altered", "half"])
def test_planted_faults_in_the_rollup_come_out_not_correct(
        kind: str, monkeypatch: pytest.MonkeyPatch) -> None:
    tree, wrap = _sums_fault(kind)
    if kind == "half":
        # The host pass reads the nodes it is handed; the device pass
        # reads the snapshot's columns, so the fault goes under the host pass.
        from headlamp_tpu_torch.analytics import stats

        monkeypatch.setattr(stats, "DEVICE_ROLLUP_MIN_NODES", 10**9)
    monkeypatch.setattr(tree, "_device_sums", wrap(tree._device_sums))
    monkeypatch.setattr(tree, "_host_sums", wrap(tree._host_sums))
    _, line = run_small(small_cell(), seconds=2.0)
    assert line["correct"] is False
    assert line["compared"]["page_mismatches"]["value"] > 0


def test_a_sync_that_keeps_its_state_unchanged_comes_out_not_correct(
        monkeypatch: pytest.MonkeyPatch) -> None:
    # The watch's events are read and dropped: the pages keep showing the
    # generation from before the window's first change.
    from headlamp_tpu_torch.context import accelerator_context

    monkeypatch.setattr(accelerator_context.AcceleratorDataContext, "_apply_watch_events",
                        lambda self, track, events: 0)
    cell = small_cell(fleet_changes={"hosts": 8, "at_s": [0.3]})
    cell.config["limits"] = {**cell.config["limits"], "generation_lag_s": 2.0}
    record, line = run_small(cell, seconds=6.0)
    assert line["correct"] is False
    assert line["compared"]["generation_lag_s"]["value"] > 2.0

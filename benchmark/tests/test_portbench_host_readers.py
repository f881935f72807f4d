"""The readers of the host's hidden time, each on a synthetic run: the
collector's share and the process's CPU per page from ``/metricsz``
deltas, the render's CPU self time, the changed sync ticks and the
drill-down tree builds from the request traces. Each reads None where
the program records nothing to read, as a program without those
counters and spans does."""

from __future__ import annotations

from typing import Any

import pytest

from benchmark.harness.readings import Paint, Run
from benchmark.harness.spec import load_reader

GC = "headlamp_tpu_torch_gc_pause_seconds_total"
CPU = "headlamp_tpu_torch_process_cpu_seconds_total"


def _span(name: str, ms: float, cpu: float | None, children: list | None = None,
          **attrs: Any) -> dict[str, Any]:
    out = {"name": name, "start_ms": 0.0, "duration_ms": ms, "attrs": attrs,
           "children": children or []}
    if cpu is not None:
        out["cpu_ms"] = cpu
    return out


def _trace(route: str, at: float, spans: list, ms: float = 10.0) -> dict[str, Any]:
    return {"trace_id": "0" * 16, "path": route, "route": route, "status": 200,
            "started_at": at, "duration_ms": ms, "device_gets": 0, "spans": spans}


def _run(traces: list | None = None, before: dict | None = None, after: dict | None = None,
         pages: int = 4) -> Run:
    paints = [Paint(client=0, index=i, route="fleet", sent=101.0, done=102.0, status=200,
                    nbytes=1, stale=False) for i in range(pages)]
    return Run(start=100.0, end=150.0, setup_s=1.0, paints=paints,
               metricsz_before=before or {}, metricsz_after=after or {},
               healthz_before={}, healthz_after={}, traces=traces or [], wall_minus_mono=0.0)


def _page(at: float, cpu: bool = True) -> dict[str, Any]:
    c = (lambda x: x) if cpu else (lambda x: None)
    component = _span("page.component", 30.0, c(12.0),
                      [_span("analytics.rollup", 5.0, c(2.0))])
    return _trace("/tpu/fleet", at, [component, _span("render.html", 20.0, c(6.0))])


def test_gc_share_is_the_windows_pause_over_its_seconds() -> None:
    read = load_reader("host.gc_share")
    before = {(GC, '{generation="0"}'): 1.0, (GC, '{generation="2"}'): 4.0}
    after = {(GC, '{generation="0"}'): 3.5, (GC, '{generation="2"}'): 14.0}
    assert read(_run(before=before, after=after)) == pytest.approx(100 * 12.5 / 50)
    assert read(_run()) is None


def test_cpu_per_page_is_the_windows_cpu_over_the_completed_pages() -> None:
    read = load_reader("host.cpu_ms_per_page")
    assert read(_run(before={(CPU, ""): 10.0}, after={(CPU, ""): 12.0})) == pytest.approx(500.0)
    assert read(_run(before={(CPU, ""): 10.0}, after={(CPU, ""): 12.0}, pages=0)) is None
    assert read(_run()) is None


def test_render_cpu_is_the_cpu_self_time_per_painted_page() -> None:
    read = load_reader("pages.render_cpu_ms")
    run = _run([_page(110.0), _page(120.0), _page(90.0)])  # the last is before the window
    assert read(run) == pytest.approx(((12.0 - 2.0) + 6.0) * 2 / 2)
    assert read(_run([_page(110.0, cpu=False)])) is None
    assert read(_run()) is None


def test_changed_tick_reads_the_sync_traces_that_built_a_snapshot() -> None:
    read = load_reader("sync.changed_tick_ms")
    build = _span("sync.snapshot", 900.0, 800.0,
                  [_span("sync.build", 300.0, 290.0, [_span("sync.classify", 100.0, 99.0)])])
    failed = _span("sync.snapshot", 5.0, 5.0, error="RuntimeError")
    run = _run([_trace("/sync", 110.0, [build], ms=2000.0),
                _trace("/sync", 112.0, [build], ms=3000.0),
                _trace("/sync", 114.0, [failed], ms=5.0),
                _trace("/tpu/fleet", 116.0, [_span("sync.build", 1.0, 1.0)], ms=7.0)])
    assert read(run) == pytest.approx(2500.0)
    assert read(_run([_trace("/sync", 114.0, [failed])])) is None


def _tree(at: float, generation: int | None, ms: float) -> dict[str, Any]:
    tree = _span("viewport.tree", ms, ms / 2, [
        _span("viewport.assign", 1.0, 1.0),
        _span("analytics.region_rollup", 2.0, 2.0, [_span("viewport.region_ids", 1.0, 1.0)]),
        _span("viewport.members", 1.0, 1.0)], generation=generation)
    return _trace("/tpu/fleet", at, [_span("page.component", ms + 1, ms, [tree])])


def test_tree_time_is_the_mean_of_the_outermost_builds() -> None:
    read = load_reader("viewport.tree_ms")
    assert read(_run([_tree(110.0, 3, 1800.0), _tree(111.0, 3, 2200.0)])) == pytest.approx(2000.0)
    assert read(_run([_page(110.0)])) is None


def test_tree_builds_count_builds_per_generation() -> None:
    read = load_reader("viewport.tree_builds")
    run = _run([_tree(110.0, 3, 10.0), _tree(111.0, 3, 10.0), _tree(112.0, 3, 10.0),
                _tree(113.0, 4, 10.0)])
    assert read(run) == pytest.approx(4 / 2)
    assert read(_run([_tree(110.0, 3, 10.0)])) == 1.0
    assert read(_run([_page(110.0)])) is None

"""The host's hidden time, as the port traces and counts it.

A background tick that builds a new snapshot generation, or fails,
lands in the trace ring under route ``/sync`` with the snapshot build
(``sync.build`` > ``sync.classify``); a quiet tick lands nowhere. Every
span carries its thread's CPU (``cpu_ms``) beside its wall time, on
the clock the device trace is put on. The interpreter's collections
and the process's CPU are ``/metricsz`` counters (``obs/host.py``),
and a full collection names the span that paid for it. The drill-down
tree's build is split into its parts.
"""

from __future__ import annotations

import copy
import gc
import re
import time

import pytest

from headlamp_tpu_torch.fleet import fixtures as tfx
from headlamp_tpu_torch.obs import host
from headlamp_tpu_torch.obs.metrics import registry
from headlamp_tpu_torch.obs.trace import (
    set_tracing,
    span,
    trace_request,
    trace_ring,
    tracing_enabled,
)
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

CLOCK = 1785283200.0


def _sync_ids():
    return [t["trace_id"] for t in trace_ring.snapshot() if t["route"] == "/sync"]


def _names(spans):
    for s in spans:
        yield s["name"]
        yield from _names(s["children"])


def _find(spans, name):
    for s in spans:
        if s["name"] == name:
            return s
        found = _find(s["children"], name)
        if found is not None:
            return found
    return None


def _thread_clock_step():
    """The thread CPU clock's step in seconds: the largest of a few
    observed increments, or the clock's stated resolution if larger."""
    steps = [time.get_clock_info("thread_time").resolution]
    t_stop = time.perf_counter() + 5.0
    for _ in range(3):
        c0 = time.thread_time()
        c1 = c0
        while c1 == c0 and time.perf_counter() < t_stop:
            c1 = time.thread_time()
        steps.append(c1 - c0)
    return max(steps)


def _scrape(name):
    """``{labels: value}`` of one family in the registry's exposition."""
    out = {}
    for line in registry.render().splitlines():
        m = re.match(rf"^{name}(\{{[^}}]*\}})? (\S+)$", line)
        if m:
            out[m.group(1) or ""] = float(m.group(2))
    return out


@pytest.fixture
def viewport_app():
    transport = tfx.fleet_transport(tfx.fleet_viewport(256))
    app = DashboardApp(transport, device="cpu", clock=lambda: CLOCK, min_sync_interval_s=3600.0)
    app._ctx.enable_watch()
    try:
        yield app, transport
    finally:
        app.close()


def test_a_changed_tick_is_ringed_with_its_build_a_quiet_one_is_not(viewport_app):
    app, transport = viewport_app
    before = _sync_ids()
    app._background_tick()  # hydrates: generation 1
    after_first = _sync_ids()
    assert len(after_first) == len(before) + 1
    app._background_tick()  # quiet: the same generation
    assert _sync_ids() == after_first
    node = copy.deepcopy(app._last_snapshot.provider("tpu").view.nodes[3])
    node["metadata"]["labels"]["example.com/marker"] = "x"
    transport.node_feed.push("MODIFIED", node)
    app._background_tick()
    ids = _sync_ids()
    assert len(ids) == len(after_first) + 1
    tick = trace_ring.snapshot()[0]
    assert (tick["trace_id"], tick["route"], tick["status"]) == (ids[0], "/sync", 200)
    build = _find(tick["spans"], "sync.build")
    assert build is not None and [c["name"] for c in build["children"]] == ["sync.classify"]
    snap = app._last_snapshot
    assert build["attrs"]["generation"] == app.snapshot_generation() == 2
    assert (build["attrs"]["nodes"], build["attrs"]["pods"]) == (256, len(snap.all_pods))
    assert _find(tick["spans"], "sync.snapshot")["children"][0]["name"] == "sync.build"


def test_a_failing_tick_is_ringed_with_status_500(viewport_app, monkeypatch):
    app, _ = viewport_app
    app._background_tick()

    def broken():
        raise RuntimeError("apiserver gone")

    monkeypatch.setattr(app._ctx, "sync", broken)
    before = _sync_ids()
    app._background_tick()
    assert len(_sync_ids()) == len(before) + 1
    tick = trace_ring.snapshot()[0]
    assert (tick["route"], tick["status"]) == ("/sync", 500)
    assert _find(tick["spans"], "sync.snapshot")["attrs"]["error"] == "RuntimeError"


def test_every_span_carries_its_threads_cpu():
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=lambda: CLOCK)
    try:
        assert app.handle("/tpu")[0] == 200
        trace = next(t for t in trace_ring.snapshot() if t["route"] == "/tpu")
    finally:
        app.close()
    stack = list(trace["spans"])
    assert stack
    while stack:
        s = stack.pop()
        assert s["cpu_ms"] >= 0.0, s["name"]
        stack.extend(s["children"])
    # The thread CPU clock may tick coarsely (10 ms steps on some hosts):
    # spin for several of its steps, and allow one step past the wall time.
    step = _thread_clock_step()
    with trace_request("/t") as tr:
        with span("busy"):
            c_end = time.thread_time() + max(0.02, 5 * step)
            t_stop = time.perf_counter() + 10.0
            while time.thread_time() < c_end and time.perf_counter() < t_stop:
                pass
    busy = tr.to_dict()["spans"][0]
    assert 0.0 < busy["cpu_ms"] <= busy["duration_ms"] + max(1.0, step * 1000)
    # The trace's own keys stay the ones JAX's traces have.
    assert "cpu_ms" not in tr.to_dict()


def test_a_full_collection_is_counted_and_names_its_span():
    host.install()
    host.install()  # idempotent: one callback per process
    assert gc.callbacks.count(host._on_gc) == 1
    counts = _scrape("headlamp_tpu_torch_gc_collections_total")
    pauses = _scrape("headlamp_tpu_torch_gc_pause_seconds_total")
    assert set(counts) == set(pauses) == {f'{{generation="{g}"}}' for g in range(3)}
    with trace_request("/t") as tr:
        with span("outer"):
            with span("collects"):
                gc.collect()
    spans = tr.to_dict()["spans"]
    collects = spans[0]["children"][0]
    assert collects["attrs"]["gc_full"] == 1 and collects["attrs"]["gc_full_ms"] >= 0.0
    assert "gc_full" not in spans[0]["attrs"]
    full = '{generation="2"}'
    assert _scrape("headlamp_tpu_torch_gc_collections_total")[full] >= counts[full] + 1
    assert _scrape("headlamp_tpu_torch_gc_pause_seconds_total")[full] > pauses[full]


def test_with_tracing_off_collections_are_counted_and_nothing_is_traced():
    host.install()
    was = tracing_enabled()
    ring = len(trace_ring)
    n = host.gc_counts()[2]
    set_tracing(False)
    try:
        with trace_request("/t") as tr:
            with span("collects") as node:
                gc.collect()
    finally:
        set_tracing(was)
    assert tr is None and node is None and len(trace_ring) == ring
    assert host.gc_counts()[2] >= n + 1


def test_the_viewport_tree_build_is_split_into_its_parts():
    app = DashboardApp(tfx.fleet_transport(tfx.fleet_viewport(256)), device="cpu",
                       clock=lambda: CLOCK, min_sync_interval_s=3600.0)
    try:
        assert app.handle("/tpu/fleet")[0] == 200
        trace = next(t for t in trace_ring.snapshot() if t["route"] == "/tpu/fleet")
        state = app._last_snapshot.provider("tpu")
    finally:
        app.close()
    tree = _find(trace["spans"], "viewport.tree")
    attrs = {k: v for k, v in tree["attrs"].items() if k not in ("gc_full_ms", "gc_full")}
    assert attrs == {"nodes": 256, "pods": len(state.pods), "generation": state.view.version}
    parts = ("viewport.assign", "analytics.region_rollup", "viewport.region_ids",
             "viewport.members")
    assert [n for n in _names(tree["children"]) if n in parts] == list(parts)
    assert [c["name"] for c in tree["children"]] == [
        "viewport.assign", "analytics.region_rollup", "viewport.members"]
    rollup = _find(tree["children"], "analytics.region_rollup")
    assert rollup["attrs"]["source"] == "device"


def test_the_process_cpu_counter_is_monotone():
    host.install()
    first = _scrape("headlamp_tpu_torch_process_cpu_seconds_total")[""]
    t_end = time.perf_counter() + 0.05
    while time.perf_counter() < t_end:
        pass
    second = _scrape("headlamp_tpu_torch_process_cpu_seconds_total")[""]
    assert 0.0 < first < second
    assert "# TYPE headlamp_tpu_torch_process_cpu_seconds_total counter" in registry.render()


def test_spans_share_the_device_traces_clock():
    # The device trace is put on time.monotonic; a span's start, mapped
    # from the trace's wall anchor by one offset, lands on it.
    with trace_request("/t") as tr:
        with span("s"):
            inside = time.perf_counter()
    trace = tr.to_dict()
    s = trace["spans"][0]
    offset = time.time() - time.monotonic()
    assert abs(trace["started_at"] + s["start_ms"] / 1000 - offset - inside) < 0.002

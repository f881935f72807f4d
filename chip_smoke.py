#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernel from the checkout (no spills allowed),
holds it against its plain PyTorch version on the card at the 64-row
tiles' edges and on exact-arithmetic inputs, times it beside the launch
floor, its plain version and the library chain, then drives the port's main
path — the metrics page with its forecast, through the CLI entry point,
the forecast at fleet scale, the forecast of a single chip, and the
dashboard host serving the metrics page over a socket (cold fit, stale
page with a background warm refit, blocking warm refit, concurrent cold
requests) — and checks that each went through the kernel. Then the
cluster dashboard: the fleet rollup on the card against its Python
oracle at 256 to 16384 nodes (timed, with its upload and its kernels
counted), and the host serving the five snapshot pages over a socket at
``--demo large``, each request's device-to-host copies held to what the
code implies. Then the fleet drill-down: the viewport tree's region
rollup on the card against its Python oracle at ``fleet_viewport`` 1024
to 16384 nodes and past 64 clusters (timed, its kernels counted), the
host serving ``/tpu/fleet`` at every depth over a socket at each size
(one copy on the first paint of a snapshot, none after), and the native
node, pod and nodes-table views. Then the live host: the background
sync with list+watch at ``fleet_viewport`` 1024 and 16384 nodes (quiet
ticks that list, upload and copy nothing; a changed tick whose new
version is warmed onto the card off the request path; 410 Gone), the
history-first forecast through the kernel, and ``/tpu/trends`` over a
4096-chip history with its statistics on the card. Then the program
registry's CUDA graphs (its startup capture beside a request, the fused
request, each bucket's replay against its eager program). Then the mesh
over NCCL at world size 1: the multichip drill, the psum, ring and region
rollups replayed and eager against the single-device rollups and their
oracles, and the dp×tp train step against the unsharded one. Then record
and replay: a recorded demo run of the host replayed twice, byte for
byte. Then telemetry: the host's SLO engine fits its own scrape→paint
series on the card as a replay of the registry's 8×512 graph, and its
exemplars, flight recorder, profiler, generation ledger and debug pages
are checked over the socket. Then the request gateway every socket request
now goes through: a saturation curve, sixteen identical cold requests as
one render and one kernel launch, a 304, shedding and a degraded render
that launches nothing; and the pooled ``KubeTransport`` against a local
stand-in apiserver, painting what the demo transport paints. Then push
and the fragment cache: a node flip served to 34 ``/events`` clients as
one diff and one frame each, with no render and no launch, the differ's
region cells against the card's region rollup, resume, shedding, and
fragment paints byte-identical to plain ones. Then provenance and
replication: a leader publishing its generations on ``/replicate/bus``
and two read replicas on the card painting its bytes from the records
(ETags, 304s and ``/events`` frames too) with no forecast launch, the
traces linked both ways through ``traceparent``, a failover drill on
injected clocks (stale-honest paints, fencing, convergence), the
``--replica`` entry point as a process of its own, and the bus's costs
at 16384 nodes. Then multi-process serving: a shared-memory segment at
16384 nodes feeding two workers on the card, which paint the leader's
bytes and upload the segment's columns with no encode, beside a bus
replica that encodes; then ``--workers 2`` and ``--workers 1`` as
processes, with their saturation curves. Then the incident drills: the
six scenario drills twice on the card and once on the CPU with
byte-identical transcripts and timelines, and the live host's incident
timeline through a page, a shed, a degraded render, an evicted stream and
a restore. Then the Intel GPU provider: the host at ``--demo mixed`` on the
card, its Intel pages, Intel columns and Intel sections byte for byte the
same app's on the CPU; a mixed fleet of 16384 TPU and 512 Intel nodes whose
TPU rollup on the card equals its oracle with no Intel node in the card's
columns, the Intel provider's cost per sync tick and the Intel paints; and
a bus replica and a segment worker painting the leader's Intel pages. Last,
apps on the card closed while the program registry captures on its own
thread, a capture held open across one close and a whole startup set
beside a stream of them: every close returns, no capture fails, and the
graphs replay what the eager program computes. It
exits non-zero at the first failure, and without CUDA or without the
package beside it.
The last line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import http.client
import json
import math
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable

ROOT = Path(__file__).resolve().parent

#: Published dense peaks of one H100 SXM at its 700 W limit.
BF16_DENSE_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12

#: Fixed wall clock for the demo's Prometheus range queries.
FIXED_CLOCK = 1785283200.0

#: Step 24's pause between two apps closed beside the startup capture.
CAPTURE_CLOSE_PAUSE_S = 0.05

#: Batches the kernel is held to its plain version at: the 64-row tiles'
#: edges, the demo page's 64 chips and the at-scale forecast's 4096.
CHECK_ROWS = (1, 3, 63, 64, 65, 127, 128, 129, 200, 256, 4096, 4097, 16384)
#: The exact-arithmetic check (exact_inputs below): every bf16
#: operand, product and partial sum is exact, so only expf's ulps differ.
EXACT_ROWS = 4097
EXACT_TOL = 1e-6
TIME_ROWS = (64, 256, 4096, 16384)
#: The at-scale forecast's chip count (fleet_large(1024) has 4096 chips);
#: the kernels line reports the kernel at this batch.
SCALE_CHIPS = 4096
KERNEL_TOL = 1e-3
#: A 5-step fit on the card vs the same fit on the CPU, predictions
#: max-abs: summation order is all that differs.
STEP_TOL = 1e-4
#: The demo page's 60-step cold fit on the card vs the CPU's, predicted
#: peak max-abs. Measured 6.2e-4 on an H100; the bound leaves 16x room
#: for summation order, which Adam amplifies over 60 steps (on synthetic
#: traces tests/test_torch_cuda.py reads up to 3e-2 from a one-ulp
#: input change, but that is not this page's history).
PAGE_FIT_TOL = 1e-2
#: Kernel launches each path must make: the page path fits three times
#: (the render's cold fit, then a cold and a warm incremental fit), the
#: at-scale path twice (cold, warm); each fit ends in one forward.
PAGE_LAUNCHES = 3
SCALE_LAUNCHES = 2
#: A one-chip history: its latest window is a contiguous slice that
#: starts 29 floats into the series, off the bulk copies' 16-byte
#: alignment unless the path copies it. One cold and one warm
#: incremental fit, then one plain cold fit.
ONE_CHIP_LAUNCHES = 3
#: The dashboard host's launches: a cold request, the background warm
#: refit after the TTL, the blocking warm refit past the grace window,
#: and one fit for four concurrent requests on a fresh app.
SERVE_LAUNCHES = 4
#: Requests per paint time the host's phase reports (p50 of each).
SERVE_TIMED = 5
#: Fleet sizes the rollup is held to its oracle and timed at
#: (``fleet_large(n)``; about 7/8 of the nodes are TPU hosts).
ROLLUP_NODES = (256, 1024, 4096, 16384)
#: Rollups timed per size (p50), and Python passes.
ROLLUP_TIMED = 21
PYTHON_TIMED = 5
#: The snapshot pages and the section title each must show.
SNAPSHOT_PAGES = {
    "/tpu": "Chip Allocation",
    "/tpu/nodes": "TPU Nodes",
    "/tpu/pods": "All TPU Pods",
    "/tpu/deviceplugins": "Plugin Pods",
    "/tpu/topology": "Slice Summary",
}
#: bench.py's four-page paint, in its order.
FOUR_PAGES = ("/tpu", "/tpu/nodes", "/tpu/topology", "/tpu/pods")
#: The cluster dashboard path's kernel launches: its one metrics GET
#: (a fit), which feeds the topology heatmap's peek.
CLUSTER_LAUNCHES = 1
#: Drill-down fleets the region rollup is held to its oracle and timed
#: at, (nodes, clusters) of ``fleet_viewport``: bench_viewport's three
#: sizes, and one with more clusters than the rollup's 64 segments.
VIEWPORT_FLEETS = ((1024, 8), (4096, 8), (16384, 8), (4096, 70))
#: Fleet sizes the host serves the drill-down at, and paints per p50.
VIEWPORT_PAINT_NODES = (1024, 4096, 16384)
VIEWPORT_TIMED = 9
#: bench_viewport's acceptance envelope: a 16k paint within 3x the 1k
#: paint. Printed beside the ratio, not checked: host times move by tens
#: of percent between runs.
VIEWPORT_ENVELOPE = 3.0
#: The drill-down and native views run no forecast.
VIEWPORT_LAUNCHES = 0
#: The live host's fleets (``fleet_viewport``), its loop interval, the
#: quiet ticks held per fleet and the changed ticks timed per fleet.
LIVE_NODES = (1024, 16384)
LIVE_INTERVAL_S = 0.2
LIVE_QUIET_TICKS = 3
LIVE_CHANGED_TICKS = 3
#: The first /tpu/fleet at 16384 nodes when the request path synced and
#: encoded inline, before background sync (two runs; PERF.md section 5).
INLINE_FIRST_FLEET_MS = (565.4, 626.5)
#: The history-first forecast: 61 scrapes 60 s apart of the demo
#: Prometheus's 64 range-query chips; a cold fit, then a warm refit.
HISTORY_SCRAPES = 61
LIVE_LAUNCHES = 2
#: The trend page at full size: chips x 2 per-chip metrics x points.
TREND_CHIPS = 4096
TREND_POINTS = 288
TREND_TIMED = 9
#: Batched statistics vs the plain version: mean and slope, relative.
STATS_RTOL = 1e-5
STATS_ATOL = 1e-6
#: FP64 peak of one H100 SXM outside the tensor cores (NVIDIA data
#: sheet); the statistics reduce in float64.
FP64_FLOP_PER_S = 34e12
#: The telemetry step: /tpu/metrics paints that fill the scrape→paint
#: series past the SLO bucket's 512 points; the budget fit's card-vs-CPU
#: bound (the 60-step fit's on 64 synthetic chips, ROADMAP Queue 3); the
#: non-bucket series length its eager fit is timed at.
TELEMETRY_PAINTS = 540
TELEMETRY_FIT_TOL = 5e-2
TELEMETRY_EAGER_POINTS = 500
#: The gateway step: concurrent keep-alive clients of the saturation
#: curve and requests per client (bench.py's ``_saturation_curve``), the
#: unloaded paints, the identical cold burst, and the warm paints over the
#: pooled transport with their ADR-014 acceptance (``bench.py:1053-1057``).
GATEWAY_CONCURRENCY = (1, 4, 16, 32)
GATEWAY_REQUESTS = 8
GATEWAY_UNLOADED = 20
GATEWAY_BURST = 16
TRANSPORT_PAINTS = 5
MAX_OPENED_PER_PAINT = 1.0
MIN_REUSE_RATE = 0.9
#: The gateway step's launches: the cold GET, the burst's one fit, the
#: restored render after the degraded one, the demo and KubeTransport
#: paints, and one fit per fresh app of the warm paints on each transport.
GATEWAY_LAUNCHES = 1 + 1 + 1 + 2 + 2 * TRANSPORT_PAINTS
#: The push step: the fleet (``fleet_viewport``, 8 clusters), interactive
#: /events clients, warm rounds of the five pages timed with fragments on
#: and off, and its launches: the first /tpu/metrics, the fragment apps'
#: one shared fit, and the refit forced by /refresh.
PUSH_NODES = 1024
PUSH_CLIENTS = 32
PUSH_WARM_ROUNDS = 9
FIVE_PAGES = ("/tpu", "/tpu/nodes", "/tpu/pods", "/tpu/metrics", "/tpu/fleet")
PUSH_LAUNCHES = 3
#: The replication step's launches: the leader's one refit (its forecast
#: is what the records ship); the replicas paint it and fit nothing.
REPLICATION_LAUNCHES = 1
#: The workers step: the in-process fleet (``fleet_viewport``), the
#: supervisor's worker counts and its saturation curve's clients, and its
#: launches: the leader's one refit; the workers fit nothing.
WORKERS_NODES = 16384
WORKERS_COUNTS = (2, 1)
WORKERS_CONCURRENCY = (32,)
WORKERS_LAUNCHES = 1
#: Step 22: each card run of a drill launches the kernel once per fit.
#: Its cold fits (the metrics page's first fill, in the request) are
#: fixed; the read-tier drill paints a replica that never fits. A drill
#: that outlives the forecast's 60 s TTL (all but the slow loris, whose
#: drill is 60 scripted seconds) also starts a background warm refit at
#: its first stale read, and how many follow is not fixed: a refit lands
#: on the scripted clock at whatever tick its real fit ends, and an
#: early landing leaves room for another stale read. So the warm refits
#: are counted, not held to a constant. The live segment launches once,
#: for the restored /tpu/metrics.
SCENARIO_COLD_FITS = {
    "preemption_wave": 1,
    "prom_flapping": 1,
    "hub_restart_herd": 1,
    "slow_loris_sse": 1,
    "clock_skew_scrape": 1,
    "leader_kill_mid_churn": 0,
}
SCENARIO_LIVE_LAUNCHES = 1
#: The drill run once on each device, and discarded, before the matrix.
SCENARIO_WARMUP = "preemption_wave"
SCENARIO_PAINTS = 21
#: Step 23, the Intel provider. The host's paths at ``--demo mixed``, each
#: held byte for byte to the same app on the CPU; then the mixed fleet at
#: full size: ``fleet_viewport(INTEL_TPU_NODES)`` plus INTEL_NODES Intel
#: nodes, INTEL_PODS Intel pods and one CR; the quiet and changed ticks
#: timed per provider set, in turns; the Intel paints timed at that size.
INTEL_HOST_PATHS = ("/intel", "/intel/nodes?page=1", "/intel/pods", "/intel/deviceplugins",
                    "/intel/metrics", "/nodes", "/node/arc-node-1",
                    "/node/gke-v5e16-pool-w0", "/pod/default/transcode-1")
INTEL_TPU_NODES = 16384
INTEL_NODES = 512
INTEL_PODS = 1024
INTEL_TICKS = 5
INTEL_TIMED = 9
INTEL_SCALE_PAGES = ("/intel", "/intel/nodes", "/intel/pods")
#: The read tier's Intel pages: a replica and a worker paint the leader's.
INTEL_SNAPSHOT_PAGES = ("/intel", "/intel/nodes", "/intel/pods", "/intel/deviceplugins")
#: Step 23's launches: /tpu/metrics's cold fit on the demo host. The
#: full-size fleet, the leader, the replica and the worker fit nothing.
INTEL_LAUNCHES = 1
#: The two measured durations a metrics page prints (masked to compare).
PAGE_TIMINGS = re.compile(r"(history in|took) [0-9.e+-]+ ms")
#: The forecast section of /tpu/metrics: the card's fit and the CPU's
#: agree to PAGE_FIT_TOL, not byte for byte.
FORECAST_SECTION = re.compile(
    r'<section class="hl-section"><h2 class="hl-section-title">Utilization Forecast.*?</section>',
    re.S)
#: Calls time_device_ms times after warm-up; the spin it queues ahead of
#: them (GPU cycles) covers their enqueue.
TIMED_CALLS = 200
SPIN_CYCLES = 200_000_000


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, message: str) -> None:
    if not ok:
        raise SmokeFailure(message)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def http_get_no_redirect(url: str) -> tuple[int, str | None]:
    """(status, Location) of one GET that does not follow a redirect."""
    parsed = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(parsed.hostname, parsed.port, timeout=120)
    try:
        conn.request("GET", parsed.path + (f"?{parsed.query}" if parsed.query else ""))
        resp = conn.getresponse()
        resp.read()
        return resp.status, resp.getheader("Location")
    finally:
        conn.close()


def http_get(url: str) -> tuple[int, str]:
    """(status, body) of one GET over the socket."""
    try:
        with urllib.request.urlopen(url, timeout=120) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def span_totals(trace: dict[str, Any]) -> dict[str, float]:
    """Milliseconds by span name over a recorded trace's span tree."""
    totals: dict[str, float] = {}
    stack = list(trace["spans"])
    while stack:
        node = stack.pop(0)
        totals[node["name"]] = totals.get(node["name"], 0.0) + node["duration_ms"]
        stack.extend(node["children"])
    return totals


def record_ticks(app: Any) -> list[dict[str, Any]]:
    """Every background tick's trace from now on, quiet ticks too (the
    trace ring keeps only the changed ones): each tick runs inside a
    trace opened here, so the tick's own ``trace_request`` yields None
    and its spans land in this one."""
    from headlamp_tpu_torch.obs.trace import trace_request

    ticks: list[dict[str, Any]] = []
    run_tick = app._background_tick

    def recorded_tick() -> None:
        with trace_request("/sync") as trace:
            run_tick()
        if trace is not None:
            trace.finish(route="/sync", status=0, device_gets=0)
            ticks.append(trace.to_dict())

    app._background_tick = recorded_tick
    return ticks


def profile_device(torch: Any, fn: Callable[[], Any]) -> tuple[float, int, list]:
    """(device-busy ms, device events, top five kernels by time) for one
    call of ``fn``, from torch.profiler's CUDA events. Kernels on one
    stream do not overlap, so their summed durations are the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return sum(by_name.values()), len(device), top


def time_device_ms(fn: Callable[[], Any]) -> tuple[float, float]:
    """(median, mean) device time of one call over TIMED_CALLS calls
    after warm-up: the median from CUDA events around each call, the
    mean from one event pair around all of them. A GPU spin is queued
    ahead of the timed calls, so they run back to back on the device and
    the events time the device, not the host's enqueue."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_CALLS + 1)]
    torch.cuda._sleep(SPIN_CYCLES)
    marks[0].record()
    for mark in marks[1:]:
        fn()
        mark.record()
    torch.cuda.synchronize()
    per_call = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return statistics.median(per_call), marks[0].elapsed_time(marks[-1]) / TIMED_CALLS


def exact_inputs(window: int, hidden: int, horizon: int, rows: int, seed: int = 0):
    """(params, x), f32 on the CPU, on which the forward's arithmetic is
    exact up to the last sigmoid: every bf16 operand, product and f32
    partial sum is a small multiple of a power of two, in any summation
    order. x is 0 or 1; each weight column has at most 8 non-zeros, ±16
    in W1, ±1 in W2 and ±2^-10 in W3; b1 and b2 are multiples of 16. So
    every hidden pre-activation is 0 or at least 16 in magnitude, where
    tanh-GELU is exactly the identity or 0, and every hidden activation
    is an integer of at most 8 significant bits, exact in bf16. Two
    implementations can then differ only by the ulps of their final
    ``expf``: a wrong fragment map or descriptor shows at once."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def sparse(k: int, n: int, scale: float) -> Any:
        w = np.zeros((k, n), np.float32)
        for col in range(n):
            nz = rng.choice(k, size=min(8, k), replace=False)
            w[nz, col] = rng.choice([-1.0, 1.0], size=nz.size) * scale
        return w

    arrays = {
        "w1": sparse(window, hidden, 16.0),
        "b1": 16.0 * rng.integers(-2, 3, hidden),
        "w2": sparse(hidden, hidden, 1.0),
        "b2": 16.0 * rng.integers(-2, 3, hidden),
        "w3": sparse(hidden, horizon, 2.0 ** -10),
        "b3": rng.integers(-8, 9, horizon) / 8.0,
    }
    params = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in arrays.items()}
    x = torch.from_numpy(rng.integers(0, 2, (rows, window)).astype(np.float32))
    return params, x


def bound_ms(rows: int, window: int, hidden: int, horizon: int) -> tuple[float, str]:
    """The least time the card could take for the forward: the larger of
    its FLOP at the bf16 dense peak and its bytes (x read once, out
    written once, f32 params read once) at the HBM rate."""
    flop = 2 * rows * (window * hidden + hidden * hidden + hidden * horizon)
    n_params = window * hidden + hidden * hidden + hidden * horizon + 2 * hidden + horizon
    nbytes = 4 * (rows * window + rows * horizon + n_params)
    t_ops = flop / BF16_DENSE_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def dashboard_host_phase(torch: Any, clock: Callable[[], float], smi: str) -> int:
    """Step 9: ``DashboardApp`` on the card, served on 127.0.0.1 and
    driven over the socket by urllib, its TTL clock a list cell. Checks
    each request's launches and copies, prints the paint times, and
    returns the kernel launches of the checked requests."""
    from headlamp_tpu_torch.models.fused_forward import LAUNCHES
    from headlamp_tpu_torch.obs import slo
    from headlamp_tpu_torch.runtime.device_cache import warm_carries
    from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

    mono = [1000.0]
    metrics_gets = 0

    def forecast_view(app: Any) -> Any:
        m = app._cached_metrics()
        return app._forecast_refresher.peek(app._metrics_key(m), epoch=app._cache_epoch)

    def get_metrics(server: Any) -> tuple[int, str]:
        nonlocal metrics_gets
        metrics_gets += 1
        return http_get(server.url + "/tpu/metrics")

    # The step's gateways rule on an engine of their own that nothing
    # feeds: the cold GET is the process's first paint, beside the startup
    # capture, and one paint past scrape_paint's 2 s alone would page the
    # process engine and degrade the requests this step checks.
    gateway_engine = slo.SLOEngine()

    def serve_app() -> tuple[Any, Any]:
        app = DashboardApp(make_demo_transport("large"), device="cuda", clock=clock,
                           monotonic=lambda: mono[0])
        app.ensure_gateway(engine=lambda: gateway_engine)
        return app, app.serve("127.0.0.1", 0)

    warm_carries.invalidate()
    LAUNCHES.reset()
    app, server = serve_app()
    try:
        t0 = time.perf_counter()
        status, body = get_metrics(server)
        cold_ms = (time.perf_counter() - t0) * 1e3
        view = forecast_view(app)
        check(status == 200, f"cold GET /tpu/metrics answered {status}")
        check("inference via CUDA kernel (H100)." in body, "the page does not name the CUDA path")
        check(view.inference_path == "cuda" and len(view.chips) == 64,
              f"cold view: path {view.inference_path}, {len(view.chips)} chips")
        check(LAUNCHES.n == 1, f"the cold request launched the kernel {LAUNCHES.n} times")
        check(app.last_request_device_gets == 1,
              f"the cold request made {app.last_request_device_gets} device-to-host copies")
        traces = json.loads(http_get(server.url + "/debug/traces")[1])["traces"]
        spans: dict[str, float] = {}
        stack = list(traces[0]["spans"])
        while stack:
            node = stack.pop(0)
            spans[node["name"]] = node["duration_ms"]
            stack.extend(node["children"])
        print(f"serve: cold GET {cold_ms:.1f} ms, trace {traces[0]['duration_ms']} ms, "
              f"spans {spans}; launches 1, device-to-host copies 1")

        mono[0] += app.FORECAST_TTL_S + 1  # stale, inside the grace window
        status, body = get_metrics(server)
        check(status == 200 and "CUDA kernel (H100)." in body, "the stale page was not served")
        check(app._forecast_refresher.drain(), "the background refit did not finish")
        status, body = get_metrics(server)
        view = forecast_view(app)
        check(status == 200 and "CUDA kernel (H100), warm-start fit." in body,
              "the refreshed page does not name the warm CUDA path")
        check(view.inference_path == "cuda-warm" and view.carried_from_generation == 0
              and view.warm_demotion_reason is None,
              f"background refit: path {view.inference_path}, generation "
              f"{view.carried_from_generation}, demotion {view.warm_demotion_reason}")
        check(LAUNCHES.n == 2, f"after the background refit the kernel ran {LAUNCHES.n} times")

        mono[0] += app.FORECAST_GRACE_S + 1  # past the grace window: blocks
        status, body = get_metrics(server)
        view = forecast_view(app)
        check(status == 200 and view.inference_path == "cuda-warm",
              f"blocking refit: status {status}, path {view.inference_path}")
        check(LAUNCHES.n == 3, f"after the blocking refit the kernel ran {LAUNCHES.n} times")

        health = json.loads(http_get(server.url + "/healthz")[1])["runtime"]
        device = health["device"]
        check(device["name"] == torch.cuda.get_device_name(0)
              and device["kernel"] == "forecast_mlp_forward" and device["kernel_path"] == "cuda",
              f"/healthz device block {device}")
        carries = health["warm_carries"]
        check(carries["hits"] >= 2, f"/healthz warm carries {carries}")
        for name, block in health["refresh"].items():
            check(block["refit_errors"] == 0, f"{name} refresher: {block}")
        print(f"serve: /healthz device {device}; warm_carries {carries}")
    finally:
        server.close()

    # Four concurrent requests on a fresh app with a cold key: one fit.
    app, server = serve_app()
    try:
        with ThreadPoolExecutor(4) as pool:
            statuses = [s for s, _ in pool.map(lambda _: get_metrics(server), range(4))]
        refits = app._forecast_refresher.snapshot()["refits"]
        check(statuses == [200] * 4, f"concurrent GETs answered {statuses}")
        check(refits == 1, f"four concurrent cold GETs ran {refits} fits")
    finally:
        server.close()
    torch.cuda.synchronize()
    serve_launches = LAUNCHES.n
    print(f"serve: 4 concurrent cold GETs -> {refits} fit; dashboard host "
          f"forecast_mlp_forward launches={serve_launches} (want {SERVE_LAUNCHES})")
    check(serve_launches == SERVE_LAUNCHES,
          f"the dashboard host launched the kernel {serve_launches} times, not {SERVE_LAUNCHES}")

    # Paint times over the socket: cold (a fresh app, no carry), warm
    # refit (past the grace window, blocking) and cached (within the TTL).
    paint_ms: dict[str, list[float]] = {"cold": [], "warm_refit": [], "cached": []}

    def timed_get(server: Any, kind: str) -> None:
        t0 = time.perf_counter()
        status, _ = get_metrics(server)
        paint_ms[kind].append((time.perf_counter() - t0) * 1e3)
        check(status == 200, f"{kind} paint answered {status}")

    for _ in range(SERVE_TIMED):
        warm_carries.invalidate()
        _, server = serve_app()
        try:
            timed_get(server, "cold")
        finally:
            server.close()
    _, server = serve_app()
    try:
        get_metrics(server)
        for _ in range(SERVE_TIMED):
            mono[0] += DashboardApp.FORECAST_GRACE_S + 1
            timed_get(server, "warm_refit")
        for _ in range(SERVE_TIMED):
            timed_get(server, "cached")
        metricsz = http_get(server.url + "/metricsz")[1]
    finally:
        server.close()
    line = 'headlamp_tpu_torch_requests_total{route="/tpu/metrics",status="200"} '
    served = [ln for ln in metricsz.splitlines() if ln.startswith(line)]
    check(served == [f"{line}{metrics_gets}"], f"/metricsz reads {served}, want {metrics_gets}")
    p50 = {k: statistics.median(v) for k, v in paint_ms.items()}
    print(f"serve: /tpu/metrics over the socket, demo large, p50 of {SERVE_TIMED}: "
          f"cold {p50['cold']:.1f} ms, warm refit {p50['warm_refit']:.1f} ms, "
          f"cached {p50['cached']:.1f} ms; all {json.dumps(paint_ms)}; "
          f"requests_total {metrics_gets}; on {smi}")
    return serve_launches


def device_event_names(torch: Any, fn: Callable[[], Any]) -> list[str]:
    """Names of the device events (kernels, copies, sets) one call of
    ``fn`` makes, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def p50_ms(fn: Callable[[], Any], n: int) -> float:
    """Median host time of ``n`` calls of ``fn`` (each ends on the host)."""
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def fleet_rollup_phase(torch: Any, smi: str) -> list[dict[str, Any]]:
    """Step 10: the fleet rollup on the card against ``python_fleet_stats``,
    exactly, at each of ROLLUP_NODES; its p50 on cached columns (dispatch
    plus the one copy), its device time, the Python pass's p50, the
    encode and the upload, its device events per call, and its bound."""
    from headlamp_tpu_torch.analytics import stats
    from headlamp_tpu_torch.analytics.encode import encode_fleet
    from headlamp_tpu_torch.analytics.fleet_torch import (
        COLUMNS,
        fleet_rollup,
        rollup_to_dict,
    )
    from headlamp_tpu_torch.domain.accelerator import classify_fleet
    from headlamp_tpu_torch.fleet import fleet_large
    from headlamp_tpu_torch.runtime.device_cache import DeviceFleetCache, _to_device

    dev = torch.device("cuda")
    rows = []
    for n in ROLLUP_NODES:
        fleet = fleet_large(n)
        view = classify_fleet(fleet["nodes"], fleet["pods"])["tpu"]
        view.version = 1
        t0 = time.perf_counter()
        host_cols = encode_fleet(view.nodes, view.pods)
        encode_ms = (time.perf_counter() - t0) * 1e3
        upload_ms = p50_ms(lambda: _to_device(host_cols, dev), 5)
        cache = DeviceFleetCache(dev)
        check(cache.warm(view), f"no upload at {n} nodes")
        got = stats.fleet_stats(view, device=dev, fleet_cache=cache, backend="cuda")
        want = stats.python_fleet_stats(view)
        bad = sorted(k for k in want if got.get(k) != want[k])
        check(got.keys() == want.keys() and not bad,
              f"cuda rollup differs from the oracle at {n} nodes in {bad}")
        cols = cache.fleet_for(view)
        rollup_ms = p50_ms(lambda: rollup_to_dict(cols, dev), ROLLUP_TIMED)
        python_ms = p50_ms(lambda: stats.python_fleet_stats(view), PYTHON_TIMED)
        tensors = [getattr(cols, name) for name in COLUMNS]
        device_ms, _ = time_device_ms(lambda: fleet_rollup(*tensors))
        events = device_event_names(torch, lambda: rollup_to_dict(cols, dev))
        kernels = [e for e in events if not e.startswith(("Memcpy", "Memset"))]
        nbytes = 4 * (5 * cols.n_nodes_padded + 4 * cols.n_pods_padded)
        row = dict(
            nodes=n, tpu_nodes=len(view.nodes), pods=len(view.pods),
            n_pad=cols.n_nodes_padded, p_pad=cols.n_pods_padded,
            rollup_ms=rollup_ms, device_ms=device_ms, python_ms=python_ms,
            encode_ms=encode_ms, upload_ms=upload_ms,
            kernels=len(kernels), device_events=len(events),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        )
        rows.append(row)
        print(f"rollup: {n} nodes ({row['tpu_nodes']} TPU, {row['pods']} pods; pad "
              f"{row['n_pad']}/{row['p_pad']}): equal to python_fleet_stats; p50 rollup_ms="
              f"{rollup_ms:.4f} (dispatch + one copy), device_ms={device_ms:.6f}, "
              f"python_ms={python_ms:.4f}, encode_ms={encode_ms:.2f}, upload_ms={upload_ms:.4f}, "
              f"bound_ms={row['bound_ms']:.6f} (bytes); {len(kernels)} kernels and "
              f"{len(events)} device events per rollup")
    names: dict[str, int] = {}
    for name in kernels:
        short = name.split("<")[0].split("(")[0].removeprefix("void ")
        names[short] = names.get(short, 0) + 1
    print(f"rollup: kernels of one rollup at {ROLLUP_NODES[-1]} nodes, by name: {names}")
    wins = [r["nodes"] for r in rows if r["rollup_ms"] < r["python_ms"]]
    tie = rows[1]["rollup_ms"] / (rows[1]["python_ms"] / rows[1]["tpu_nodes"])
    print(f"rollup: the cuda rollup beats the Python pass at {wins} nodes of {list(ROLLUP_NODES)}; "
          f"measured at {ROLLUP_NODES[1]} nodes the two tie near {tie:.0f} TPU nodes "
          f"(floor {stats.DEVICE_ROLLUP_MIN_NODES}); on {smi}")
    return rows


def cluster_dashboard_phase(torch: Any, clock: Callable[[], float], smi: str) -> int:
    """Step 11: the host at --demo large on the card, over the socket:
    the five snapshot pages, the calibrating cold paint, the copies of a
    coalesced paint and of a paint after the sync interval, the topology
    heatmap from the metrics peek, and the pages' paint p50s. Returns
    the kernel launches of the path."""
    from headlamp_tpu_torch.analytics import stats
    from headlamp_tpu_torch.models.fused_forward import LAUNCHES
    from headlamp_tpu_torch.obs.trace import trace_ring
    from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

    def span_attrs(name: str) -> dict[str, Any]:
        stack = list(trace_ring.snapshot()[0]["spans"])
        while stack:
            node = stack.pop(0)
            if node["name"] == name:
                return node["attrs"]
            stack.extend(node["children"])
        raise SmokeFailure(f"the last request's trace has no {name} span")

    def main_of(body: str) -> str:
        return body[body.index("<main>"):]

    stats.calibration.reset()
    mono = [5000.0]
    transport = make_demo_transport("large")
    app = DashboardApp(transport, device="cuda", clock=clock, monotonic=lambda: mono[0])
    cache = app._ctx.fleet_cache

    def relists() -> int:
        return sum(c == "/api/v1/nodes?limit=500" for c in transport.calls)

    LAUNCHES.reset()
    server = app.serve("127.0.0.1", 0)
    try:
        t0 = time.perf_counter()
        status, body = http_get(server.url + "/tpu")
        cold_ms = (time.perf_counter() - t0) * 1e3
        check(status == 200 and "Chip Allocation" in body, f"cold GET /tpu answered {status}")
        rollup = span_attrs("analytics.rollup")
        counters = cache.counters()
        print(f"cluster: cold GET /tpu {cold_ms:.1f} ms: analytics.rollup backend "
              f"{rollup.get('backend')}, fleet_cache {rollup.get('fleet_cache')}; rollups "
              f"{counters['hits'] + counters['misses']}, uploads {counters['uploads']}, "
              f"device-to-host copies {app.last_request_device_gets}; calibration "
              f"{stats.calibration.backend} {stats.calibration.device_ms:.4f} ms vs python "
              f"{stats.calibration.python_ms_per_node * 1e3:.3f} us/node, crossover "
              f"{stats.calibration.crossover_nodes():.0f} nodes")
        check(rollup.get("backend") == "cuda" and rollup.get("fleet_cache") == "miss",
              f"the cold /tpu rollup span reads {rollup}")
        check(counters["hits"] + counters["misses"] == 4 and counters["uploads"] == 1
              and app.last_request_device_gets == 4,
              f"the calibrating paint: {counters}, copies {app.last_request_device_gets}")
        n_tpu = len(app._last_snapshot.provider("tpu").nodes)
        check(stats.chosen_backend(n_tpu, "cuda") == "cuda",
              f"the measured winner at {n_tpu} nodes is {stats.chosen_backend(n_tpu, 'cuda')}")

        lists = relists()
        mono[0] += 1.0  # inside the sync interval: the snapshot and its stats
        status, _ = http_get(server.url + "/tpu")
        check(status == 200 and app.last_request_device_gets == 0 and relists() == lists
              and cache.counters()["uploads"] == 1,
              f"coalesced paint: copies {app.last_request_device_gets}, "
              f"re-lists {relists() - lists}, {cache.counters()}")
        mono[0] += 5.0  # past it: one re-list, a new version, its upload
        status, _ = http_get(server.url + "/tpu")
        check(status == 200 and app.last_request_device_gets == 1 and relists() == lists + 1
              and cache.counters()["uploads"] == 2
              and span_attrs("analytics.rollup").get("backend") == "cuda",
              f"paint past the interval: copies {app.last_request_device_gets}, "
              f"re-lists {relists() - lists}, {cache.counters()}")
        print("cluster: device-to-host copies per /tpu: calibrating 4, coalesced 0, "
              "past the sync interval 1 (1 re-list, 1 upload)")

        for path, title in SNAPSHOT_PAGES.items():
            status, body = http_get(server.url + path)
            check(status == 200 and title in body, f"GET {path} answered {status}")
        check("hl-heat-" not in main_of(body), "the topology page painted a heatmap cold")
        status, body = http_get(server.url + "/tpu/metrics")
        check(status == 200 and "CUDA kernel (H100)" in body, f"GET /tpu/metrics answered {status}")
        status, body = http_get(server.url + "/tpu/topology")
        check(status == 200 and "hl-heat-" in main_of(body),
              "the topology page did not paint the heatmap from the peek")
        health = json.loads(http_get(server.url + "/healthz")[1])
        print(f"cluster: five pages 200; /tpu/topology heatmap from the metrics peek; /healthz "
              f"nodes {health['nodes']}, analytics {health['analytics']}, fleet_cache "
              f"{health['runtime']['fleet_cache']}")
    finally:
        server.close()
    torch.cuda.synchronize()
    launches = LAUNCHES.n
    print(f"cluster: forecast_mlp_forward launches={launches} (want {CLUSTER_LAUNCHES})")
    check(launches == CLUSTER_LAUNCHES,
          f"the cluster dashboard launched the kernel {launches} times, not {CLUSTER_LAUNCHES}")

    # Paint times, as bench.py paints: an app that syncs on every request.
    app = DashboardApp(make_demo_transport("large"), device="cuda", clock=clock,
                       min_sync_interval_s=0.0)
    server = app.serve("127.0.0.1", 0)
    page_ms: dict[str, list[float]] = {p: [] for p in SNAPSHOT_PAGES}
    four_ms: list[float] = []
    try:
        def get(path: str) -> None:
            t0 = time.perf_counter()
            status, _ = http_get(server.url + path)
            page_ms[path].append((time.perf_counter() - t0) * 1e3)
            check(status == 200, f"GET {path} answered {status}")

        for path in FOUR_PAGES:  # warm-up
            http_get(server.url + path)
        for _ in range(SERVE_TIMED):
            t0 = time.perf_counter()
            for path in FOUR_PAGES:
                get(path)
            four_ms.append((time.perf_counter() - t0) * 1e3)
            get("/tpu/deviceplugins")
    finally:
        server.close()
    last_tpu = next(t for t in trace_ring.snapshot() if t["path"] == "/tpu")
    print(f"cluster: the last timed /tpu: handle() {last_tpu['duration_ms']} ms, "
          f"spans {span_totals(last_tpu)}")
    p50 = {p: round(statistics.median(v), 1) for p, v in page_ms.items()}
    print(f"cluster: page paint p50 of {SERVE_TIMED} over the socket, demo large, sync on "
          f"every request: {p50}; all {json.dumps(page_ms)}; on {smi}")
    print(f"cluster: four-page paint p50 {statistics.median(four_ms):.1f} ms "
          f"({', '.join(FOUR_PAGES)}; {', '.join(f'{v:.1f}' for v in four_ms)})")
    return launches


def region_rollup_phase(torch: Any, smi: str) -> list[dict[str, Any]]:
    """Step 12a: the viewport tree on the card against ``_host_sums``,
    exactly, at each of VIEWPORT_FLEETS, its first build in one copy;
    then the region rollup's p50 on cached columns (the id upload,
    dispatch and the one copy), the sums with their Python id pass, its
    device time, the host pass, its device events per call and its
    bound."""
    from headlamp_tpu_torch.analytics.fleet_torch import (
        REGION_CLUSTER_SEGMENTS,
        REGION_NODE_COLUMNS,
        REGION_POD_COLUMNS,
        pack_region_rollup,
        region_rollup,
        region_rollup_arrays,
        unpack_region_rollup,
    )
    from headlamp_tpu_torch.context import AcceleratorDataContext
    from headlamp_tpu_torch.fleet import fleet_transport, fleet_viewport
    from headlamp_tpu_torch.runtime import transfer
    from headlamp_tpu_torch.viewport import tree as vt

    dev = torch.device("cuda")
    rows = []
    for n, n_clusters in VIEWPORT_FLEETS:
        transport = fleet_transport(fleet_viewport(n, clusters=n_clusters))
        state = AcceleratorDataContext(transport, device=dev).sync().provider("tpu")
        before = transfer.transfer_stats.blocking_gets
        t0 = time.perf_counter()
        tree = vt.viewport_tree(state)
        build_ms = (time.perf_counter() - t0) * 1e3
        copies = transfer.transfer_stats.blocking_gets - before
        check(tree.source == "device" and copies == 1,
              f"the tree at {n} nodes: source {tree.source}, {copies} copies")
        region_of, _, _, cluster_id, slice_id = vt._assignments(state.nodes)
        args = (cluster_id, slice_id, region_of, REGION_CLUSTER_SEGMENTS)
        want_clusters, want_slices = vt._host_sums(state, *args)
        got_slices = [None] * len(slice_id)
        for cluster in tree.clusters:
            for slc in cluster.children:
                got_slices[slice_id[(cluster.key, slc.key)]] = slc.stats
        check([c.stats for c in tree.clusters] == want_clusters and got_slices == want_slices,
              f"the card's region rollup differs from _host_sums at {n} nodes, "
              f"{n_clusters} clusters")
        check(vt._device_sums(state, *args) == (want_clusters, want_slices),
              f"_device_sums differs from _host_sums at {n} nodes")

        fleet = state.fleet_cache.fleet_for(state.view)
        ids = vt._region_ids(fleet, cluster_id, slice_id, region_of, REGION_CLUSTER_SEGMENTS)

        def one_rollup() -> Any:
            out = region_rollup_arrays(fleet, *ids, dev)
            return unpack_region_rollup(transfer.fetch(pack_region_rollup(out)))

        rollup_ms = p50_ms(one_rollup, ROLLUP_TIMED)
        sums_ms = p50_ms(lambda: vt._device_sums(state, *args), PYTHON_TIMED)
        host_ms = p50_ms(lambda: vt._host_sums(state, *args), PYTHON_TIMED)
        tensors = (
            [getattr(fleet, name) for name in REGION_NODE_COLUMNS]
            + [torch.as_tensor(a, device=dev) for a in ids]
            + [getattr(fleet, name) for name in REGION_POD_COLUMNS]
        )
        device_ms, _ = time_device_ms(lambda: region_rollup(*tensors))
        events = device_event_names(torch, one_rollup)
        kernels = [e for e in events if not e.startswith(("Memcpy", "Memset"))]
        names: dict[str, int] = {}
        for name in kernels:
            short = name.split("<")[0].split("(")[0].removeprefix("void ")
            names[short] = names.get(short, 0) + 1
        n_pad, p_pad = fleet.n_nodes_padded, fleet.n_pods_padded
        nbytes = 4 * (6 * n_pad + 4 * p_pad) + 8 * 6 * (REGION_CLUSTER_SEGMENTS + n_pad)
        row = dict(
            nodes=n, clusters=len(cluster_id), slices=len(slice_id), pods=len(state.pods),
            n_pad=n_pad, p_pad=p_pad, tree_build_ms=build_ms, rollup_ms=rollup_ms,
            sums_ms=sums_ms, device_ms=device_ms, host_ms=host_ms,
            kernels=len(kernels), device_events=len(events),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        )
        rows.append(row)
        print(f"region: {n} nodes, {row['clusters']} clusters, {row['slices']} slices, "
              f"{row['pods']} pods (pad {n_pad}/{p_pad}): equal to _host_sums, first build "
              f"{build_ms:.2f} ms in 1 copy; p50 rollup_ms={rollup_ms:.4f} (id upload + "
              f"dispatch + one copy), sums_ms={sums_ms:.4f} (with the id pass), "
              f"device_ms={device_ms:.6f}, host_ms={host_ms:.4f} (_host_sums), "
              f"bound_ms={row['bound_ms']:.6f} (bytes); {len(kernels)} kernels and "
              f"{len(events)} device events per rollup, by name {names}; on {smi}")
    return rows


def viewport_host_phase(torch: Any, clock: Callable[[], float], smi: str) -> int:
    """Step 12b: the host on the card over the socket, built as
    bench_viewport builds it (``fleet_viewport(n)``, one sync per hour):
    ``/tpu/fleet`` at the root, a cluster, a slice, the slice's next
    window and an unknown region, the copies of each request, and the
    paint p50s of ``/tpu/fleet`` and ``/tpu/nodes?limit=64``; then the
    native views at ``--demo large``. Returns the forecast kernel's
    launches on these paths."""
    from headlamp_tpu_torch.fleet import fleet_large, fleet_transport, fleet_viewport
    from headlamp_tpu_torch.models.fused_forward import LAUNCHES
    from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

    LAUNCHES.reset()
    paint: dict[str, dict[int, float]] = {"/tpu/fleet": {}, "/tpu/nodes?limit=64": {}}
    for n in VIEWPORT_PAINT_NODES:
        app = DashboardApp(fleet_transport(fleet_viewport(n)), device="cuda", clock=clock,
                           min_sync_interval_s=3600.0)
        server = app.serve("127.0.0.1", 0)
        try:
            t0 = time.perf_counter()
            status, body = http_get(server.url + "/tpu/fleet")
            cold_ms = (time.perf_counter() - t0) * 1e3
            check(status == 200 and "<dt>Rollup source</dt><dd>device</dd>" in body
                  and app.last_request_device_gets == 1,
                  f"first GET /tpu/fleet at {n} nodes: {status}, "
                  f"copies {app.last_request_device_gets}")
            trace = json.loads(http_get(server.url + "/debug/traces")[1])["traces"][0]
            slice_path = "/tpu/fleet?region=cluster/0/slice/c0-slice-0&limit=10"
            status, body = http_get(server.url + slice_path)
            cursor = re_cursor(body)
            drill = {
                "/tpu/fleet?region=cluster/0": "Cluster 0",
                slice_path: "rows 1–10 of 32 nodes",
                f"{slice_path}&cursor={cursor}": "rows 11–20 of 32 nodes",
                "/tpu/fleet?region=cluster/0/slice/nope": "No such region",
                "/tpu/fleet": "Rollup source",
            }
            for path, text in drill.items():
                status, body = http_get(server.url + path)
                check(status == 200 and text in body and app.last_request_device_gets == 0,
                      f"GET {path} at {n} nodes: {status}, {text!r} "
                      f"{'found' if text in body else 'missing'}, copies "
                      f"{app.last_request_device_gets}")
            for path in paint:
                http_get(server.url + path)  # warm: the per-generation sort
                samples = []
                for _ in range(VIEWPORT_TIMED):
                    t0 = time.perf_counter()
                    status, _ = http_get(server.url + path)
                    samples.append((time.perf_counter() - t0) * 1e3)
                    check(status == 200, f"GET {path} at {n} nodes answered {status}")
                paint[path][n] = statistics.median(samples)
            uploads = app._ctx.fleet_cache.counters()["uploads"]
            check(uploads == 1, f"{uploads} uploads at {n} nodes")
        finally:
            server.close()
        print(f"viewport: {n} nodes: first GET /tpu/fleet {cold_ms:.1f} ms with 1 copy, "
              f"handle() {trace['duration_ms']} ms, spans {span_totals(trace)}; cluster, "
              f"slice, next window, unknown region and root again 200 with 0 copies; "
              f"1 upload")
    lo, hi = VIEWPORT_PAINT_NODES[0], VIEWPORT_PAINT_NODES[-1]
    for path, by_n in paint.items():
        ratio = by_n[hi] / by_n[lo]
        print(f"viewport: {path} paint p50 of {VIEWPORT_TIMED} over the socket: "
              + ", ".join(f"{n} nodes {ms:.2f} ms" for n, ms in by_n.items())
              + f"; {hi}/{lo} ratio {ratio:.2f} (bench_viewport envelope "
              f"{VIEWPORT_ENVELOPE:g}x: {'within' if ratio <= VIEWPORT_ENVELOPE else 'OUTSIDE'})"
              f"; on {smi}")

    fleet = fleet_large(1024)
    tpu_node = next(n["metadata"]["name"] for n in fleet["nodes"]
                    if "cloud.google.com/gke-tpu-accelerator" in n["metadata"]["labels"])
    tpu_pod = next(p for p in fleet["pods"]
                   if p["spec"]["nodeName"] and "google.com/tpu" in str(p["spec"]["containers"]))
    pod_path = f"/pod/{tpu_pod['metadata']['namespace']}/{tpu_pod['metadata']['name']}"
    server = DashboardApp(make_demo_transport("large"), device="cuda", clock=clock).serve(
        "127.0.0.1", 0)
    tpu_section = '<h2 class="hl-section-title">TPU</h2>'
    try:
        for path, want, text in (
            ("/nodes", 200, "<th>TPU Type</th>"),
            ("/nodes?page=2", 200, "page 2 of 2"),
            (f"/node/{tpu_node}", 200, tpu_section),
            ("/node/no-such-node", 404, "Node not found"),
            (pod_path, 200, tpu_section),
        ):
            status, body = http_get(server.url + path)
            check(status == want and text in body, f"GET {path}: {status}, want {want} "
                  f"with {text!r}")
        back = f"/node/{tpu_node}"
        redirect = http_get_no_redirect(server.url + f"/refresh?back={back}")
        check(redirect == (302, back), f"/refresh?back={back} answered {redirect}")
    finally:
        server.close()
    print(f"native: /nodes (and ?page=2), /node/{tpu_node} (TPU section), "
          f"/node/no-such-node 404, {pod_path} (TPU section), /refresh?back={back} 302")
    torch.cuda.synchronize()
    launches = LAUNCHES.n
    print(f"viewport: forecast_mlp_forward launches={launches} (want {VIEWPORT_LAUNCHES})")
    check(launches == VIEWPORT_LAUNCHES,
          f"the drill-down and native views launched the kernel {launches} times")
    return launches


def _wait_for(pred: Callable[[], bool], what: str, timeout_s: float = 120.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise SmokeFailure(f"timed out waiting for {what}")
        time.sleep(0.002)


def live_sync_phase(torch: Any, clock: Callable[[], float], smi: str, n: int) -> dict[str, Any]:
    """Step 13a at ``fleet_viewport(n)``: the background loop every
    LIVE_INTERVAL_S with list+watch. Hydration lists each track once;
    quiet ticks list nothing, watch twice, keep the version and upload
    nothing, and repeated pages copy nothing; a changed tick (a MODIFIED
    node, an ADDED pod) applies 2 events, bumps the version by 1 and
    warms its columns once before the next request, whose trace has no
    upload and whose rollup over the warm columns equals the Python
    oracle; 410 Gone re-lists each track once. Returns the times."""
    from headlamp_tpu_torch.analytics import stats
    from headlamp_tpu_torch.fleet import fleet_transport, fleet_viewport, make_tpu_pod
    from headlamp_tpu_torch.obs.trace import trace_ring
    from headlamp_tpu_torch.server import DashboardApp

    transport = fleet_transport(fleet_viewport(n))
    mono = [9000.0]
    app = DashboardApp(transport, device="cuda", clock=clock, min_sync_interval_s=3600.0,
                       monotonic=lambda: mono[0])
    ctx, cache = app._ctx, app._ctx.fleet_cache
    ticks = record_ticks(app)  # every tick's trace, for its times

    def lists(track: str) -> list[str]:
        return [c for c in transport.calls if c.startswith(f"/api/v1/{track}?limit=")]

    def counters() -> dict[str, Any]:
        # Under the sync lock no tick is inside its sync.
        with app._sync_lock:
            return {
                "lists": len(lists("nodes")) + len(lists("pods")),
                "watch_calls": len(transport.watch_calls),
                "watches": {k: dict(v) for k, v in ctx.watch_stats.items()},
                "version": app._last_snapshot.provider("tpu").view.version,
                "uploads": cache.counters()["uploads"],
                "warms": app._background_counters["warms"],
            }

    def get(path: str) -> tuple[int, str, float]:
        t0 = time.perf_counter()
        status, body = http_get(server.url + path)
        return status, body, (time.perf_counter() - t0) * 1e3

    server = app.serve("127.0.0.1", 0)
    out: dict[str, Any] = {"nodes": n}
    try:
        app.start_background_sync(LIVE_INTERVAL_S)
        _wait_for(lambda: app._background_counters["ticks"] >= 1, "the hydrating tick")
        pods = len(app._last_snapshot.all_pods)
        want_lists = (math.ceil(n / 500), math.ceil(pods / 500))
        got_lists = (len(lists("nodes")), len(lists("pods")))
        check(got_lists == want_lists and lists("nodes")[0] == "/api/v1/nodes?limit=500",
              f"hydration at {n} nodes listed {got_lists} pages, want {want_lists}")
        check(app._background_counters["warms"] == 1 and cache.counters()["uploads"] == 1,
              f"hydration at {n} nodes: {app._background_counters}, {cache.counters()}")
        for path in ("/tpu", "/tpu/fleet"):  # first paints of the version
            check(get(path)[0] == 200, f"GET {path} at {n} nodes")
        # Quiet ticks are timed from here: the first paints above hold
        # the interpreter for hundreds of ms at 16k nodes, and a tick
        # beside them would time the paint, not the tick.
        first_quiet = len(ticks)
        before = counters()
        _wait_for(lambda: counters()["watches"]["nodes"]["watches"]
                  >= before["watches"]["nodes"]["watches"] + LIVE_QUIET_TICKS, "quiet ticks")
        copies = []
        for path in ("/tpu", "/tpu/fleet", "/tpu", "/tpu/fleet"):
            status, _, _ = get(path)
            copies.append(app.last_request_device_gets)
            check(status == 200 and "device_cache.upload" not in span_totals(trace_ring.snapshot()[0]),
                  f"quiet GET {path} at {n} nodes: {status}")
        after = counters()
        quiet = after["watches"]["nodes"]["watches"] - before["watches"]["nodes"]["watches"]
        check(after["lists"] == before["lists"] and after["version"] == before["version"]
              and after["uploads"] == before["uploads"] and after["warms"] == before["warms"]
              and after["watch_calls"] - before["watch_calls"] == 2 * quiet
              and after["watches"]["pods"]["watches"] - before["watches"]["pods"]["watches"] == quiet
              and copies == [0, 0, 0, 0],
              f"quiet ticks at {n} nodes: before {before}, after {after}, copies {copies}")
        quiet_ms = [t["duration_ms"] for t in ticks[first_quiet:]
                    if "device_cache.upload" not in span_totals(t)]
        out["quiet_ticks"] = quiet

        view = app._last_snapshot.provider("tpu").view
        node_name = view.nodes[7]["metadata"]["name"]
        changed_ms, warm_ms, first_fleet_ms, diff_ms = [], [], [], []
        for i in range(LIVE_CHANGED_TICKS):
            before = counters()
            node = json.loads(json.dumps(app._last_snapshot.provider("tpu").nodes[7]))
            node["metadata"]["labels"]["example.com/live-marker"] = str(i)
            pod = make_tpu_pod(f"live-train-{i}", namespace="team-live", node=node_name)
            n_ticks = len(ticks)
            with app._sync_lock:  # both events land in one tick
                transport.node_feed.push("MODIFIED", node)
                transport.pod_feed.push("ADDED", pod)
            app._background_wake.set()
            _wait_for(lambda: counters()["warms"] == before["warms"] + 1, "the changed tick's warm")
            after = counters()
            events = [after["watches"][k]["events"] - before["watches"][k]["events"]
                      for k in ("nodes", "pods")]
            check(events == [1, 1] and after["version"] == before["version"] + 1
                  and after["uploads"] == before["uploads"] + 1 and after["lists"] == before["lists"],
                  f"changed tick {i} at {n} nodes: before {before}, after {after}")
            _wait_for(lambda: any("device_cache.upload" in span_totals(t) for t in ticks[n_ticks:]),
                      "the changed tick's trace")
            changed = next(t for t in ticks[n_ticks:] if "device_cache.upload" in span_totals(t))
            changed_ms.append(changed["duration_ms"])
            if i == 0:
                out["changed_tick_spans"] = span_totals(changed)
            warm_ms.append(span_totals(changed)["device_cache.upload"])
            # The push differ's share of the tick (its own span; the app's
            # monotonic clock is frozen here, so push_diff_seconds reads 0).
            diff_ms.append(span_totals(changed).get("push.diff", 0.0))
            status, body, _ = get("/tpu")
            trace = trace_ring.snapshot()[0]
            check(status == 200 and "device_cache.upload" not in span_totals(trace)
                  and cache.counters()["uploads"] == after["uploads"],
                  f"GET /tpu after changed tick {i} at {n} nodes: {status}, spans "
                  f"{span_totals(trace)}, {cache.counters()}")
            state = app._last_snapshot.provider("tpu")
            got = stats.fleet_stats(state.view, device="cuda", fleet_cache=cache, backend="cuda")
            want = stats.python_fleet_stats(state.view)
            bad = sorted(k for k in want if got.get(k) != want[k])
            check(not bad and cache.counters()["uploads"] == after["uploads"],
                  f"the rollup over the warm columns differs from the oracle at {n} nodes in {bad}")
            status, body, ms = get("/tpu/fleet")
            check(status == 200 and "<dt>Rollup source</dt><dd>device</dd>" in body,
                  f"first GET /tpu/fleet after changed tick {i} at {n} nodes: {status}")
            first_fleet_ms.append(ms)
            if i == 0:
                out["first_fleet_trace"] = span_totals(trace_ring.snapshot()[0])

        before = counters()
        snap = app._last_snapshot
        relist_pages = math.ceil(len(snap.all_nodes) / 500) + math.ceil((len(snap.all_pods) + 1) / 500)
        node = json.loads(json.dumps(snap.provider("tpu").nodes[7]))
        node["metadata"]["labels"]["example.com/live-marker"] = "gone"
        with app._sync_lock:  # an event each, then compaction: both cursors expire
            transport.node_feed.push("MODIFIED", node)
            transport.pod_feed.push("ADDED", make_tpu_pod("live-gone", namespace="team-live"))
            transport.node_feed.compact()
            transport.pod_feed.compact()
        app._background_wake.set()
        _wait_for(lambda: counters()["watches"]["pods"]["relists"] == before["watches"]["pods"]["relists"] + 1
                  and counters()["watches"]["nodes"]["relists"] == before["watches"]["nodes"]["relists"] + 1,
                  "the re-lists after 410 Gone")
        after = counters()
        check(after["version"] == before["version"] + 1
              and after["lists"] - before["lists"] == relist_pages,
              f"410 Gone at {n} nodes: before {before}, after {after}")
        health = json.loads(http_get(server.url + "/healthz")[1])
        check(health["ok"] and health["background_sync"]
              and health["runtime"]["background"]["warm_errors"] == 0,
              f"/healthz at {n} nodes: ok {health['ok']}, {health['runtime']['background']}")
    finally:
        server.close()
    check(not any(t.is_alive() for t in app._background_threads), "the loop outlived close()")
    out.update(
        quiet_tick_ms=statistics.median(quiet_ms), changed_tick_ms=statistics.median(changed_ms),
        warm_upload_ms=statistics.median(warm_ms), first_fleet_ms=first_fleet_ms,
        push_diff_ms=statistics.median(diff_ms),
        quiet_all=quiet_ms, changed_all=changed_ms, warm_all=warm_ms, diff_all=diff_ms,
        watch=health["runtime"]["watch"],
    )
    inline = (f"; with an inline sync and encode it took {INLINE_FIRST_FLEET_MS[0]} / "
              f"{INLINE_FIRST_FLEET_MS[1]} ms" if n == 16384 else "")
    print(f"live: {n} nodes ({pods} pods): hydration {want_lists[0]}+{want_lists[1]} LIST pages, 1 warm; "
          f"{quiet} quiet ticks: 0 LISTs, 2 watches each, same version, 0 uploads, copies {copies}; "
          f"{LIVE_CHANGED_TICKS} changed ticks: 2 events, version +1, 1 warm upload each before the "
          f"next request, no device_cache.upload on /tpu, rollup equal to python_fleet_stats; "
          f"410 Gone: 1 re-list per track, version +1; watch {out['watch']}")
    print(f"live: {n} nodes: tick p50 quiet {out['quiet_tick_ms']:.3f} ms (of {len(quiet_ms)}), "
          f"changed {out['changed_tick_ms']:.3f} ms, of which push.diff {out['push_diff_ms']:.3f} ms "
          f"(all changed {json.dumps(changed_ms)}, push.diff {json.dumps(diff_ms)}); "
          f"warm upload p50 {out['warm_upload_ms']:.3f} ms; "
          f"first /tpu/fleet after a change {', '.join(f'{v:.1f}' for v in first_fleet_ms)} ms over "
          f"the socket{inline}; its spans {out['first_fleet_trace']}; a changed tick's spans "
          f"{out['changed_tick_spans']}; a quiet tick's {span_totals(ticks[first_quiet])}; on {smi}")
    return out


def history_forecast_phase(torch: Any, clock: Callable[[], float], smi: str) -> int:
    """Step 13b: an app whose history store holds HISTORY_SCRAPES scrapes
    60 s apart of the demo Prometheus's 64 chips serves /tpu/metrics
    cold and again after the forecast TTL: data_source "history", paths
    cuda then cuda-warm, no range query, 2 kernel launches; the cold
    forecast against the same fit called directly on the card
    (KERNEL_TOL) and on the CPU (PAGE_FIT_TOL). Returns the launches."""
    from types import SimpleNamespace

    from headlamp_tpu_torch.metrics.client import fetch_tpu_metrics
    from headlamp_tpu_torch.models.forecast import ForecastConfig, synthetic_telemetry
    from headlamp_tpu_torch.models.fused_forward import LAUNCHES
    from headlamp_tpu_torch.models.service import forecast_from_history_incremental
    from headlamp_tpu_torch.runtime.device_cache import warm_carries
    from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

    cfg = ForecastConfig()
    mono = [20000.0]
    transport = make_demo_transport("large")
    chips = fetch_tpu_metrics(make_demo_transport("large"), clock=clock).chips[:64]
    values = synthetic_telemetry(64, HISTORY_SCRAPES, torch.Generator().manual_seed(7),
                                 device="cpu").tolist()
    warm_carries.invalidate()
    app = DashboardApp(transport, device="cuda", clock=clock, monotonic=lambda: mono[0])
    for step in range(HISTORY_SCRAPES):
        app.history.record_scrape(SimpleNamespace(chips=[
            SimpleNamespace(node=c.node, accelerator_id=c.accelerator_id,
                            tensorcore_utilization=values[i][step], duty_cycle=None)
            for i, c in enumerate(chips)
        ], fetch_ms=None))
        mono[0] += 60.0

    def forecast_view() -> Any:
        m = app._cached_metrics()
        return app._forecast_refresher.peek(app._metrics_key(m), epoch=app._cache_epoch)

    server = app.serve("127.0.0.1", 0)
    LAUNCHES.reset()
    try:
        t0 = time.perf_counter()
        status, body = http_get(server.url + "/tpu/metrics")
        cold_ms = (time.perf_counter() - t0) * 1e3
        cold = forecast_view()
        history = app.history.utilization_history(clock=clock, min_points=cfg.window + cfg.horizon)
        check(status == 200 and "of captured history in" in body and cold.data_source == "history"
              and cold.inference_path == "cuda" and len(cold.chips) == 64,
              f"cold history GET: {status}, {cold.data_source}, {cold.inference_path}")
        mono[0] += app.FORECAST_TTL_S + 1
        status, _ = http_get(server.url + "/tpu/metrics")
        check(status == 200 and app._forecast_refresher.drain(), "the warm refit did not finish")
        warm = forecast_view()
        check(warm.data_source == "history" and warm.inference_path == "cuda-warm",
              f"warm history refit: {warm.data_source}, {warm.inference_path}")
        torch.cuda.synchronize()
        launches = LAUNCHES.n
        ranges = [c for c in transport.calls if "query_range" in c]
        check(launches == LIVE_LAUNCHES and not ranges,
              f"history path: {launches} launches (want {LIVE_LAUNCHES}), {len(ranges)} range queries")
    finally:
        server.close()
    direct, _ = forecast_from_history_incremental(history, device="cuda")
    on_cpu, _ = forecast_from_history_incremental(history, device="cpu")

    def diff(a: Any, b: Any) -> float:
        peaks = {(c.node, c.accelerator_id): c.predicted_peak for c in b.chips}
        return max(abs(c.predicted_peak - peaks[(c.node, c.accelerator_id)]) for c in a.chips)

    kernel_diff, cpu_diff = diff(cold, direct), diff(cold, on_cpu)
    check(kernel_diff <= KERNEL_TOL and cpu_diff <= PAGE_FIT_TOL,
          f"history forecast vs direct {kernel_diff} (tol {KERNEL_TOL}), vs CPU {cpu_diff} "
          f"(tol {PAGE_FIT_TOL})")
    print(f"live: history-first forecast, {HISTORY_SCRAPES} scrapes x 64 chips: cold GET "
          f"{cold_ms:.1f} ms (fit_ms {cold.fit_ms}), data_source history, paths cuda then cuda-warm, "
          f"0 range queries, forecast_mlp_forward launches={launches} (want {LIVE_LAUNCHES}); "
          f"predicted peaks vs the direct fit {kernel_diff:.3e} (tol {KERNEL_TOL:g}), vs the CPU "
          f"{cpu_diff:.3e} (tol {PAGE_FIT_TOL:g}); on {smi}")
    return launches


def trends_phase(torch: Any, clock: Callable[[], float], smi: str) -> list[dict[str, Any]]:
    """Step 13c: /tpu/trends over TREND_CHIPS chips x 2 metrics x
    TREND_POINTS points: the grouped page, the browse page and its next
    window, one copy each; their statistics and every series' batched
    statistics against the plain version; the paint p50 and the
    statistics program's device time. Returns the device-program rows."""
    import numpy as np

    from headlamp_tpu_torch.analytics.trends import (
        python_series_stats,
        series_stats_batch,
        series_stats_tensor,
    )
    from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

    mono = [50000.0]
    app = DashboardApp(make_demo_transport("large"), device="cuda", clock=clock,
                       monotonic=lambda: mono[0])
    keys = [(f"trend-node-{c // 4}", str(c % 4)) for c in range(TREND_CHIPS)]
    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    for step in range(TREND_POINTS):
        util = rng.random(TREND_CHIPS).tolist()
        duty = rng.random(TREND_CHIPS).tolist()
        app.history.append_many(
            [("chip.tensorcore_utilization", k, u) for k, u in zip(keys, util)]
            + [("chip.duty_cycle", k, d) for k, d in zip(keys, duty)]
        )
        mono[0] += 60.0
    fill_s = time.perf_counter() - t0

    def close_enough(got: dict[str, float], want: dict[str, float]) -> bool:
        return all(got[k] == want[k] for k in ("n", "latest", "min", "max")) and all(
            abs(got[k] - want[k]) <= STATS_ATOL + STATS_RTOL * abs(want[k])
            for k in ("mean", "slope_per_step"))

    server = app.serve("127.0.0.1", 0)
    paint_ms: list[float] = []
    try:
        browse = "/tpu/trends?metric=chip.tensorcore_utilization&limit=64"
        status, body = http_get(server.url + browse)
        cursor = re_cursor(body)
        for path, text in (("/tpu/trends", f"browse all {TREND_CHIPS} series"),
                           (browse, f"rows 1–64 of {TREND_CHIPS}"),
                           (f"{browse}&cursor={cursor}", f"rows 65–128 of {TREND_CHIPS}")):
            status, body = http_get(server.url + path)
            check(status == 200 and text in body and app.last_request_device_gets == 1,
                  f"GET {path}: {status}, {text!r} {'found' if text in body else 'missing'}, "
                  f"copies {app.last_request_device_gets}")
        for _ in range(TREND_TIMED):
            t0 = time.perf_counter()
            status, _ = http_get(server.url + "/tpu/trends")
            paint_ms.append((time.perf_counter() - t0) * 1e3)
            check(status == 200, f"GET /tpu/trends answered {status}")
    finally:
        server.close()
    views = [app.history.trend_view(window_s=21600.0),
             app.history.trend_view(window_s=21600.0, metric="chip.tensorcore_utilization",
                                    series_limit=64)]
    painted = [s for g in views[0]["groups"] for s in g["series"]] + views[1]["browse"]["series"]
    bad = [s["label"] for s in painted
           if not close_enough(s["stats"], python_series_stats([v for _, v in s["points"]]))]
    check(not bad, f"the painted statistics differ from the plain version for {bad[:4]}")
    every = [app.history.series(m, k)[1] for m in ("chip.tensorcore_utilization", "chip.duty_cycle")
             for k in keys]
    batched = series_stats_batch(every, device="cuda")
    bad = [i for i, (got, vals) in enumerate(zip(batched, every))
           if not close_enough(got, python_series_stats(vals))]
    check(not bad, f"the batched statistics of {len(bad)} of {len(every)} series differ")
    rows = []
    for label, series in (("browse page", [[v for _, v in s["points"]] for s in views[1]["browse"]["series"]]),
                          ("every series", every)):
        n_series, width = len(series), max(len(v) for v in series)
        vals = torch.tensor(series, dtype=torch.float32, device="cuda")
        lengths = torch.full((n_series,), width, dtype=torch.int32, device="cuda")
        device_ms, _ = time_device_ms(lambda: series_stats_tensor(vals, lengths))
        events = device_event_names(torch, lambda: series_stats_tensor(vals, lengths))
        kernels = [e for e in events if not e.startswith(("Memcpy", "Memset"))]
        plain_ms = p50_ms(lambda: [python_series_stats(v) for v in series], 3)
        batch_ms = p50_ms(lambda: series_stats_batch(series, device="cuda"), 9)
        nbytes = 4 * n_series * width + 4 * n_series + 8 * 6 * n_series
        flop = 12 * n_series * width
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flop / FP64_FLOP_PER_S * 1e3
        rows.append(dict(series=n_series, points=width, ms=device_ms, batch_ms=batch_ms,
                         kernels=len(kernels), device_events=len(events),
                         plain_ms=plain_ms, library_ms=None, bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations"))
        print(f"live: trend statistics, {label} ({n_series} x {width}): device_ms={device_ms:.6f}, "
              f"series_stats_batch p50 {batch_ms:.3f} ms (pad, upload, program, one copy), plain "
              f"Python {plain_ms:.3f} ms, bound_ms={rows[-1]['bound_ms']:.6f} ({rows[-1]['bound_by']}); "
              f"{len(kernels)} kernels and {len(events)} device events per program; "
              f"equal to the plain version (n, latest, min, max exact; mean, slope {STATS_RTOL:g} rel)")
    print(f"live: /tpu/trends over {TREND_CHIPS} chips x 2 metrics x {TREND_POINTS} points (filled in "
          f"{fill_s:.1f} s): grouped, browse (limit 64) and its next window 200 with 1 copy each; "
          f"paint p50 {statistics.median(paint_ms):.2f} ms of {TREND_TIMED} "
          f"({', '.join(f'{v:.1f}' for v in paint_ms)}); on {smi}")
    return rows


def live_host_phase(torch: Any, clock: Callable[[], float], smi: str) -> tuple[int, list, list]:
    """Step 13: the live host. Returns the forecast kernel's launches on
    its paths, the sync rows and the trend statistics rows."""
    from headlamp_tpu_torch.models.fused_forward import LAUNCHES

    LAUNCHES.reset()
    sync_rows = [live_sync_phase(torch, clock, smi, n) for n in LIVE_NODES]
    torch.cuda.synchronize()
    check(LAUNCHES.n == 0, f"the background sync launched the forecast kernel {LAUNCHES.n} times")
    launches = history_forecast_phase(torch, clock, smi)
    trend_rows = trends_phase(torch, clock, smi)
    return launches, sync_rows, trend_rows


class _Registry:
    """Install a program registry (and, with ``ledger``, a fresh graph
    cost ledger) for a block, restoring the previous ones after."""

    def __init__(self, reg: Any, ledger: Any = None) -> None:
        self.reg, self.ledger = reg, ledger

    def __enter__(self) -> Any:
        from headlamp_tpu_torch.models import aot
        from headlamp_tpu_torch.obs import graphcost

        self._prev = aot.set_registry(self.reg)
        self._prev_ledger = graphcost.set_ledger(self.ledger) if self.ledger is not None else None
        return self.reg

    def __exit__(self, *_exc: Any) -> None:
        from headlamp_tpu_torch.models import aot
        from headlamp_tpu_torch.obs import graphcost

        aot.set_registry(self._prev)
        if self._prev_ledger is not None:
            graphcost.set_ledger(self._prev_ledger)


def registry_startup_phase(torch: Any, clock: Callable[[], float], smi: str) -> dict[str, Any]:
    """Step 14a: a fresh program registry's startup capture on the card
    while a request thread GETs /tpu/metrics at --demo large; ready with
    no capture error. Then, at --demo large with the registry ready: a
    warm refit with the published TPU view is ONE fused replay and ONE
    device-to-host copy, and /tpu reads the parked rollup with 0 copies;
    a fresh app's cold and warm /tpu/metrics replay their fits; /tpu and
    /tpu/fleet at fleet_viewport 1024/4096/16384 replay both rollups.
    No request pays a capture. Returns the launches and the capture
    times."""
    from headlamp_tpu_torch.fleet import fleet_transport, fleet_viewport
    from headlamp_tpu_torch.models import aot
    from headlamp_tpu_torch.models.fused_forward import LAUNCHES
    from headlamp_tpu_torch.obs import graphcost
    from headlamp_tpu_torch.obs.trace import trace_ring
    from headlamp_tpu_torch.runtime.device_cache import warm_carries
    from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

    reg, led = aot.registry(), graphcost.ledger()
    mono = [70000.0]
    warm_carries.invalidate()
    LAUNCHES.reset()
    app = DashboardApp(make_demo_transport("large"), device="cuda", clock=clock,
                       min_sync_interval_s=3600.0, monotonic=lambda: mono[0])
    t0 = time.perf_counter()
    server = app.serve("127.0.0.1", 0)  # starts the startup capture
    out: dict[str, Any] = {}
    try:
        with ThreadPoolExecutor(1) as pool:
            cold = pool.submit(lambda: (http_get(server.url + "/tpu/metrics"), time.perf_counter()))
            check(reg.wait_ready(600.0), "the startup capture did not finish in 600 s")
            ready_s = time.perf_counter() - t0
            (status, body), got_at = cold.result()
        check(status == 200 and "CUDA kernel (H100)" in body, f"/tpu/metrics during startup: {status}")
        snap = reg.snapshot()
        check(snap["state"] == "ready" and snap["compile_errors"] == 0 and snap["last_error"] is None
              and snap["programs_compiled"] == len(aot.default_specs()),
              f"the registry after startup: {snap}")
        captures = {name: (row["capture_ms"], row["signatures"])
                    for name, row in led.snapshot()["programs"].items() if row["captures"]}
        check(snap["programs_compiled"] == 15 and "mesh.rollup" in captures,
              f"the startup set is not 15 programs with the mesh rollup: {sorted(captures)}")
        out.update(ready_s=ready_s, capture_ms_total=snap["compile_ms_total"], captures=captures)
        print(f"aot: startup capture of {snap['programs_compiled']} programs ready in "
              f"{ready_s:.2f} s ({snap['compile_ms_total']} ms capturing) while a request thread "
              f"GET /tpu/metrics ({status}, answered {got_at - t0:.2f} s after serve()); "
              f"0 capture errors; capture ms (signatures) per program {captures}; on {smi}")
        request_captures = led.request_captures()

        # The fused request: a warm carry (the cold GET's) and the published
        # TPU view of the 1024-node fleet.
        check(http_get(server.url + "/tpu/nodes")[0] == 200, "GET /tpu/nodes")
        before = led.snapshot()["programs"].get(aot.FUSED_PROGRAM, {}).get("replays", 0)
        launches = LAUNCHES.n
        mono[0] += app.FORECAST_GRACE_S + 1  # past the grace window: a blocking warm refit
        status, body = http_get(server.url + "/tpu/metrics")
        fused_trace = trace_ring.snapshot()[0]
        replays = led.snapshot()["programs"][aot.FUSED_PROGRAM]["replays"] - before
        check(status == 200 and "warm-start fit." in body and replays == 1
              and app.last_request_device_gets == 1 and LAUNCHES.n == launches + 1
              and "forecast.fused" in span_totals(fused_trace),
              f"the fused request: {status}, {replays} replays, "
              f"{app.last_request_device_gets} copies, {LAUNCHES.n - launches} launches, "
              f"spans {span_totals(fused_trace)}")
        status, body = http_get(server.url + "/tpu")
        rollup = next(s for s in _spans(trace_ring.snapshot()[0]) if s["name"] == "analytics.rollup")
        check(status == 200 and "Chip Allocation" in body and app.last_request_device_gets == 0
              and rollup["attrs"].get("rollup_source") == "fused",
              f"/tpu after the fused request: {status}, {app.last_request_device_gets} copies, "
              f"rollup span {rollup['attrs']}")
        out["fused_ms"] = fused_trace["duration_ms"]
        print(f"aot: --demo large, warm refit with the published TPU view: 1 fused replay, 1 "
              f"device-to-host copy, 1 kernel launch, handle() {fused_trace['duration_ms']} ms "
              f"(spans {span_totals(fused_trace)}); then /tpu from the parked rollup with 0 "
              f"copies (rollup_source fused)")
    finally:
        server.close()

    # A fresh app: its cold and warm /tpu/metrics replay the fit graphs.
    warm_carries.invalidate()
    app = DashboardApp(make_demo_transport("large"), device="cuda", clock=clock,
                       monotonic=lambda: mono[0])
    server = app.serve("127.0.0.1", 0)
    try:
        hits, launches = reg.bucket_hits, LAUNCHES.n
        for label in ("cold", "warm"):
            status, body = http_get(server.url + "/tpu/metrics")
            check(status == 200 and app.last_request_device_gets == 1,
                  f"{label} /tpu/metrics after startup: {status}, {app.last_request_device_gets} copies")
            mono[0] += app.FORECAST_GRACE_S + 1
        check(reg.bucket_hits == hits + 2 and LAUNCHES.n == launches + 2,
              f"cold and warm /tpu/metrics: {reg.bucket_hits - hits} hits, "
              f"{LAUNCHES.n - launches} launches")
    finally:
        server.close()
    for n in VIEWPORT_PAINT_NODES:
        app = DashboardApp(fleet_transport(fleet_viewport(n)), device="cuda", clock=clock,
                           min_sync_interval_s=3600.0)
        before = led.snapshot()["programs"]
        server = app.serve("127.0.0.1", 0)
        try:
            for path in ("/tpu", "/tpu/fleet"):
                check(http_get(server.url + path)[0] == 200, f"GET {path} at {n} nodes")
        finally:
            server.close()
        after = led.snapshot()["programs"]
        for name in (aot.FLEET_ROLLUP, aot.REGION_ROLLUP):
            check(after[name]["replays"] > before[name]["replays"]
                  and after[name]["eager"] == before[name]["eager"],
                  f"{name} at {n} nodes: {before[name]} -> {after[name]}")
    check(led.request_captures() == request_captures == 0,
          f"request-phase captures after startup: {led.request_captures()}")
    out["launches"] = LAUNCHES.n
    print(f"aot: request-phase captures 0 after startup over /tpu/metrics (cold, warm, fused), "
          f"/tpu and /tpu/fleet at {list(VIEWPORT_PAINT_NODES)} nodes (every rollup a replay, "
          f"none eager); registry {reg.counters()}; ledger {led.counters()}")
    return out


def _spans(trace: dict[str, Any]) -> list[dict[str, Any]]:
    stack, spans = list(trace["spans"]), []
    while stack:
        node = stack.pop(0)
        spans.append(node)
        stack.extend(node["children"])
    return spans


def registry_programs_phase(torch: Any, smi: str) -> tuple[int, list[dict[str, Any]]]:
    """Step 14b, on the ready registry: every forecast bucket's cold and
    warm replay against the same masked program run eagerly on the card,
    the kernel's output inside each replay against its plain version on
    the fitted params, one launch per replay; the replayed fleet and
    region rollups exactly equal to their Python oracles at every
    size; replay against eager times and device times; the card's busy
    share during a replayed cold fit. Returns the launches and rows."""
    import numpy as np

    from headlamp_tpu_torch.analytics import stats
    from headlamp_tpu_torch.analytics.fleet_torch import (
        COLUMNS,
        REGION_CLUSTER_SEGMENTS,
        fleet_rollup,
        pack_rollup,
        region_rollup_host,
        rollup_key,
        rollup_to_dict,
    )
    from headlamp_tpu_torch.context import AcceleratorDataContext
    from headlamp_tpu_torch.domain.accelerator import classify_fleet
    from headlamp_tpu_torch.fleet import fleet_large, fleet_transport, fleet_viewport
    from headlamp_tpu_torch.models import aot
    from headlamp_tpu_torch.models import forecast as tf
    from headlamp_tpu_torch.models.fused_forward import LAUNCHES, forecast_forward_reference
    from headlamp_tpu_torch.obs import graphcost
    from headlamp_tpu_torch.runtime.device_cache import DeviceFleetCache
    from headlamp_tpu_torch.viewport import tree as vt

    dev = torch.device("cuda")
    reg, led = aot.registry(), graphcost.ledger()
    idle = aot.AotProgramRegistry()  # never started: every program runs eagerly
    rows: list[dict[str, Any]] = []
    LAUNCHES.reset()
    carries: dict[int, Any] = {}
    for name, key in aot.default_specs():
        if name not in (aot.COLD_PROGRAM, aot.WARM_PROGRAM):
            continue
        bucket, length, cfg, steps = key
        n = 64 if bucket == 64 else 1
        series = tf.synthetic_telemetry(n, length, torch.Generator().manual_seed(21), device=dev)
        padded, weights = tf.pad_series_to_bucket(series, bucket)
        if name == aot.COLD_PROGRAM:
            params, opt_state = tf._initial_params(None, 0, cfg, dev), None
        else:
            params, opt_state = carries[bucket]
        launches = LAUNCHES.n
        preds, new_params, new_opt, mse = tf._try_aot_forecast(
            name, series, params, opt_state, cfg, steps)
        torch.cuda.synchronize()
        check(LAUNCHES.n == launches + 1, f"{name} at {key[:2]}: {LAUNCHES.n - launches} launches")
        carries[bucket] = (new_params, new_opt)
        with LAUNCHES.tally():  # the comparisons launch for no path
            if name == aot.COLD_PROGRAM:
                eager = tf._bucketed_fit_forecast_state_program(padded, weights, params, cfg, steps)
            else:
                eager = tf._bucketed_warm_fit_forecast_program(
                    padded, weights, params, opt_state, cfg, steps)
            plain = forecast_forward_reference(new_params, series[:, -cfg.window:].contiguous())
        diff = float(np.abs(preds - eager[0][:n].cpu().numpy()).max())
        kernel_diff = float(np.abs(preds - plain.cpu().numpy()).max())
        tol = PAGE_FIT_TOL if name == aot.COLD_PROGRAM else KERNEL_TOL
        print(f"aot: {name} at (bucket {bucket}, length {length}, {steps} steps), {n} chips: "
              f"replay vs eager masked program max-abs {diff:.3e} (tol {tol:g}); kernel inside "
              f"the replay vs forecast_forward_reference on the fitted params {kernel_diff:.3e} "
              f"(tol {KERNEL_TOL:g}); mse {mse:.6g}; 1 launch")
        check(diff <= tol and kernel_diff <= KERNEL_TOL and math.isfinite(mse),
              f"{name} at {key[:2]}: replay vs eager {diff}, kernel {kernel_diff}")
    launches = LAUNCHES.n

    for n in ROLLUP_NODES:
        f = fleet_large(n)
        view = classify_fleet(f["nodes"], f["pods"])["tpu"]
        view.version = 1
        cache = DeviceFleetCache(dev)
        cache.warm(view)
        before = led.snapshot()["programs"][aot.FLEET_ROLLUP]
        got = stats.fleet_stats(view, device=dev, fleet_cache=cache, backend="cuda")
        after = led.snapshot()["programs"][aot.FLEET_ROLLUP]
        check(got == stats.python_fleet_stats(view) and after["replays"] == before["replays"] + 1
              and after["eager"] == before["eager"],
              f"the replayed fleet rollup at fleet_large({n}): {before} -> {after}")
    for n in VIEWPORT_PAINT_NODES:
        state = AcceleratorDataContext(fleet_transport(fleet_viewport(n)), device=dev).sync()
        state = state.provider("tpu")
        region_of, _, _, cluster_id, slice_id = vt._assignments(state.nodes)
        args = (cluster_id, slice_id, region_of, REGION_CLUSTER_SEGMENTS)
        before = led.snapshot()["programs"][aot.REGION_ROLLUP]
        got = vt._device_sums(state, *args)
        after = led.snapshot()["programs"][aot.REGION_ROLLUP]
        check(got == vt._host_sums(state, *args) and after["replays"] == before["replays"] + 1
              and after["eager"] == before["eager"],
              f"the replayed region rollup at fleet_viewport({n}): {before} -> {after}")
    print(f"aot: replayed fleet rollup equal to python_fleet_stats at fleet_large "
          f"{list(ROLLUP_NODES)}, replayed region rollup equal to _host_sums at fleet_viewport "
          f"{list(VIEWPORT_PAINT_NODES)}; one replay each, no eager run")

    # Replay against eager, in turns on the same inputs; the registry
    # swapped for an idle one runs the same call eagerly.
    series = tf.synthetic_telemetry(64, 61, torch.Generator().manual_seed(22), device="cpu").numpy()
    _, _, state = tf.fit_and_forecast_incremental(series, device=dev)
    f = fleet_large(1024)
    view = classify_fleet(f["nodes"], f["pods"])["tpu"]
    view.version = 1
    cache = DeviceFleetCache(dev)
    cache.warm(view)
    cols = cache.fleet_for(view)
    vstate = AcceleratorDataContext(fleet_transport(fleet_viewport(1024)), device=dev).sync()
    vstate = vstate.provider("tpu")
    vfleet = vstate.fleet_cache.fleet_for(vstate.view)
    region_of, _, _, cluster_id, slice_id = vt._assignments(vstate.nodes)
    ids = vt._region_ids(vfleet, cluster_id, slice_id, region_of, REGION_CLUSTER_SEGMENTS)
    calls = {
        "cold fit, 64 chips": lambda: tf.fit_and_forecast_incremental(series, device=dev),
        "warm fit, 64 chips": lambda: tf.fit_and_forecast_incremental(series, state=state, device=dev),
        "fleet rollup, 1024 nodes": lambda: rollup_to_dict(cols, dev),
        "region rollup, fleet_viewport 1024": lambda: region_rollup_host(vfleet, *ids, dev),
    }
    with LAUNCHES.tally():
        for label, call in calls.items():
            samples: dict[str, list[float]] = {"replay": [], "eager": []}
            for _ in range(5):
                for kind in ("replay", "eager", "eager", "replay"):
                    with _Registry(reg if kind == "replay" else idle):
                        t0 = time.perf_counter()
                        call()
                        samples[kind].append((time.perf_counter() - t0) * 1e3)
            row = {"program": label, "replay_ms": statistics.median(samples["replay"]),
                   "eager_ms": statistics.median(samples["eager"])}
            rows.append(row)
            print(f"aot: {label}: replay p50 {row['replay_ms']:.3f} ms, eager p50 "
                  f"{row['eager_ms']:.3f} ms (host clock, one copy each, 10 calls each in turns); "
                  f"on {smi}")
        # Device time of one replay (copy-in and graph) against the eager
        # ops, CUDA events around TIMED_CALLS calls.
        fit_key = (64, 61, tf.ForecastConfig(), 60)
        padded, weights = tf.pad_series_to_bucket(torch.as_tensor(series, device=dev), 64)
        init = tf._initial_params(None, 0, tf.ForecastConfig(), dev)
        program = reg.lookup(aot.COLD_PROGRAM, fit_key, dev)
        fit_inputs = [padded, weights, *tf.carry_tensors(init)]
        fleet_program = reg.lookup(aot.FLEET_ROLLUP, rollup_key(cols), dev)
        tensors = [getattr(cols, name) for name in COLUMNS]
        # The eager fit's thousands of launches outrun any spin queued
        # ahead of them, so its events would time the host's enqueue: it
        # gets the busy share below instead.
        device_rows = {
            "cold fit graph, 64 chips": (
                lambda: program.run(fit_inputs, lambda out: None), None),
            "fleet rollup graph, 1024 nodes": (
                lambda: fleet_program.run(tensors, lambda out: None),
                lambda: pack_rollup(fleet_rollup(*tensors))),
        }
        for label, (replay, eager) in device_rows.items():
            replay_ms, _ = time_device_ms(replay)
            eager_ms = time_device_ms(eager)[0] if eager is not None else None
            print(f"aot: {label}: device_ms replay {replay_ms:.6f} (copy-in and graph), eager "
                  f"{'not measured' if eager_ms is None else f'{eager_ms:.6f}'} (CUDA events, "
                  f"median of {TIMED_CALLS}); on {smi}")
            rows.append({"program": label, "replay_device_ms": replay_ms,
                         "eager_device_ms": eager_ms})
        # The card's busy share during one replayed cold fit.
        t0 = time.perf_counter()
        tf.fit_and_forecast_incremental(series, device=dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, n_events, top = profile_device(
            torch, lambda: tf.fit_and_forecast_incremental(series, device=dev))
    if n_events == 0:
        print("aot: replayed cold fit: device busy share not measured (no CUDA events)")
    else:
        print(f"aot: replayed cold fit, 64 chips: device busy {busy_ms:.3f} ms in {n_events} "
              f"device events over {wall_ms:.3f} ms unprofiled; busy share {busy_ms / wall_ms:.3f}; "
              f"top {[(name[:60], round(ms, 3)) for name, ms in top]}; on {smi}")
        rows.append({"program": "replayed cold fit busy share", "busy_ms": busy_ms,
                     "wall_ms": wall_ms, "device_events": n_events})
    return launches, rows


def program_registry_phase(torch: Any, clock: Callable[[], float], smi: str) -> tuple[int, list]:
    """Step 14: the program registry as CUDA graphs. A fresh registry and
    ledger for the step, so its startup capture is seen from the start.
    Returns the kernel launches of its paths and the timing rows."""
    from headlamp_tpu_torch.models import aot
    from headlamp_tpu_torch.obs import graphcost

    with _Registry(aot.AotProgramRegistry(), graphcost.GraphCostLedger()):
        host = registry_startup_phase(torch, clock, smi)
        launches, rows = registry_programs_phase(torch, smi)
    return host["launches"] + launches, [{"startup": host}] + rows


def _region_stats(host: dict[str, Any], cluster_id: dict, slice_id: dict) -> tuple[list, list]:
    """Per-cluster and per-slice stat dicts from a region rollup's host
    vectors, read as ``viewport/tree.py``'s ``_device_sums`` reads them."""
    from headlamp_tpu_torch.analytics.fleet_torch import REGION_CLUSTER_SEGMENTS
    from headlamp_tpu_torch.viewport.tree import STAT_KEYS

    def at(prefix: str, idx: int) -> dict[str, int]:
        return {key: int(host[f"{prefix}_{key}"][idx]) for key in STAT_KEYS}

    return ([at("cluster", min(cid, REGION_CLUSTER_SEGMENTS - 1)) for cid in range(len(cluster_id))],
            [at("slice", sid) for sid in range(len(slice_id))])


def mesh_phase(torch: Any, smi: str) -> tuple[int, list[dict[str, Any]]]:
    """Step 15: the mesh over NCCL at world size 1. The multichip drill;
    a registry of the mesh programs and the single-device rollups at the
    1024 buckets, captured with 0 errors (each capture's ms printed); the
    psum and ring rollups of fleet_large(1024) and both region rollups of
    fleet_viewport(1024) on the process mesh, replayed and eager, exactly
    equal to the single-device rollups and their Python oracles, with
    host p50s in turns beside the single-device replay; the dp×tp train
    step on a world-1 train mesh against the unsharded step. Returns the
    forecast kernel's launches (0: the mesh launches none) and rows."""
    import numpy as np

    from headlamp_tpu_torch.analytics import stats
    from headlamp_tpu_torch.analytics.encode import encode_fleet
    from headlamp_tpu_torch.analytics.fleet_torch import (
        REGION_CLUSTER_SEGMENTS,
        REGION_KEYS,
        region_rollup_host,
        rollup_to_dict,
    )
    from headlamp_tpu_torch.domain.accelerator import classify_fleet
    from headlamp_tpu_torch.fleet import fleet_large, fleet_viewport
    from headlamp_tpu_torch.models import aot
    from headlamp_tpu_torch.models import forecast as tf
    from headlamp_tpu_torch.models.fused_forward import LAUNCHES
    from headlamp_tpu_torch.obs import graphcost
    from headlamp_tpu_torch.parallel import mesh as tmesh
    from headlamp_tpu_torch.parallel.dryrun import dryrun_multichip
    from headlamp_tpu_torch.viewport import tree as vt

    dev = torch.device("cuda")
    LAUNCHES.reset()
    t0 = time.perf_counter()
    line = dryrun_multichip(1, device="cuda")
    check(line.startswith("dryrun_multichip ok: 1 devices;"), f"the drill: {line}")
    print(f"mesh: dryrun_multichip(1, device='cuda') over NCCL in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    key = ((1024,), (1024,))
    specs = [(aot.FLEET_ROLLUP, key), (aot.REGION_ROLLUP, key)] + [
        (name, (reducer, (1,), *key))
        for name in (tmesh.MESH_ROLLUP, tmesh.MESH_REGION_ROLLUP) for reducer in ("psum", "ring")]
    reg, idle = aot.AotProgramRegistry(specs=specs), aot.AotProgramRegistry()
    rows: list[dict[str, Any]] = []
    with _Registry(reg, graphcost.GraphCostLedger()):
        led = graphcost.ledger()
        reg.compile_startup(dev, block=True)
        snap = reg.snapshot()
        check(snap["state"] == "ready" and snap["compile_errors"] == 0
              and snap["programs_compiled"] == len(specs), f"the mesh registry: {snap}")
        captures = {name: row["capture_ms"] for name, row in led.snapshot()["programs"].items()}
        print(f"mesh: {len(specs)} programs captured with 0 errors (the mesh programs hold their "
              f"NCCL all-reduce or ring inside the graph); capture ms {captures}; on {smi}")
        rows.append({"captures_ms": captures})
        mesh = tmesh.fleet_mesh(dev)
        check(mesh.size == 1 and tmesh._backend_of(mesh.group) == "nccl", f"process mesh {mesh}")

        f = fleet_large(1024)
        view = classify_fleet(f["nodes"], f["pods"])["tpu"]
        arrays = encode_fleet(view.nodes, view.pods)
        oracle = stats.python_fleet_stats(view)
        v = fleet_viewport(1024)
        vview = classify_fleet(v["nodes"], v["pods"])["tpu"]
        varrays = encode_fleet(vview.nodes, vview.pods)
        region_of, _, _, cluster_id, slice_id = vt._assignments(vview.nodes)
        ids = vt._region_ids(varrays, cluster_id, slice_id, region_of, REGION_CLUSTER_SEGMENTS)

        class _State:  # what _host_sums reads of a provider state
            nodes, pods = vview.nodes, vview.pods

        region_oracle = vt._host_sums(_State, cluster_id, slice_id, region_of,
                                      REGION_CLUSTER_SEGMENTS)
        calls = {
            "fleet rollup (single device), fleet_large 1024": (
                aot.FLEET_ROLLUP, lambda: rollup_to_dict(arrays, dev)),
            "sharded_rollup (psum), fleet_large 1024": (
                tmesh.MESH_ROLLUP, lambda: tmesh.sharded_rollup(arrays, mesh)),
            "ring_rollup, fleet_large 1024": (
                tmesh.MESH_ROLLUP, lambda: tmesh.ring_rollup(arrays, mesh)),
            "region rollup (single device), fleet_viewport 1024": (
                aot.REGION_ROLLUP, lambda: region_rollup_host(varrays, *ids, dev)),
            "region_sharded_rollup (psum), fleet_viewport 1024": (
                tmesh.MESH_REGION_ROLLUP,
                lambda: tmesh.region_sharded_rollup(varrays, *ids, mesh)),
            "region_sharded_rollup (ring), fleet_viewport 1024": (
                tmesh.MESH_REGION_ROLLUP,
                lambda: tmesh.region_sharded_rollup(varrays, *ids, mesh, "ring")),
        }
        single: dict[str, Any] = {}
        for label, (name, call) in calls.items():
            results = {}
            for kind in ("replay", "eager"):
                before = led.snapshot()["programs"][name]
                with _Registry(reg if kind == "replay" else idle):
                    results[kind] = call()
                after = led.snapshot()["programs"][name]
                ran = "replays" if kind == "replay" else "eager"
                check(after[ran] == before[ran] + 1, f"{label} {kind}: {before} -> {after}")
            got, eager = results["replay"], results["eager"]
            if name in (aot.FLEET_ROLLUP, tmesh.MESH_ROLLUP):
                same = got == eager and all(got[k] == oracle[k] for k in got
                                            if k not in ("generation_counts",))
                if name == aot.FLEET_ROLLUP:
                    single["fleet"] = got
                else:
                    same = same and got == {k: single["fleet"][k] for k in got}
            else:
                same = all(np.array_equal(got[k], eager[k]) for k in REGION_KEYS) and (
                    _region_stats(got, cluster_id, slice_id) == region_oracle)
                if name == aot.REGION_ROLLUP:
                    single["region"] = got
                else:
                    same = same and all(np.array_equal(got[k], single["region"][k])
                                        for k in REGION_KEYS)
            check(same, f"{label}: replay, eager, single device and oracle disagree")
            samples: dict[str, list[float]] = {"replay": [], "eager": []}
            for _ in range(5):
                for kind in ("replay", "eager", "eager", "replay"):
                    with _Registry(reg if kind == "replay" else idle):
                        t0 = time.perf_counter()
                        call()
                        samples[kind].append((time.perf_counter() - t0) * 1e3)
            row = {"program": label, "replay_ms": statistics.median(samples["replay"]),
                   "eager_ms": statistics.median(samples["eager"])}
            rows.append(row)
            print(f"mesh: {label}: equal to the single-device rollup and the oracle, replayed and "
                  f"eager; host p50 replay {row['replay_ms']:.3f} ms, eager {row['eager_ms']:.3f} "
                  f"ms (one copy each, 10 calls each in turns); on {smi}")

    # The dp×tp train step on a world-1 train mesh against the unsharded step.
    (train,) = tmesh.local_train_meshes(1, dev)
    try:
        cfg = tf.ForecastConfig()
        params = tf.init_params(torch.Generator().manual_seed(1), cfg, device=dev)
        x, y = tf.make_windows(tf.synthetic_telemetry(64, 61, device=dev), cfg.window, cfg.horizon)
        plain_step, sharded_step = tf.make_train_step(cfg), tf.make_sharded_train_step(cfg, train)
        shards = tf.shard_params(params, train)
        want = plain_step(params, tf.adam_init(params), x, y)
        got = sharded_step(shards, tf.adam_init(shards), tf.batch_block(x, train),
                           tf.batch_block(y, train))
        torch.cuda.synchronize()
        loss_diff = abs(float(got[2]) - float(want[2])) / abs(float(want[2]))
        param_diff = max(float((got[0][k] - want[0][k]).abs().max()) for k in tf.PARAM_NAMES)
        check(loss_diff <= 1e-5 and param_diff <= 1e-4 and math.isfinite(float(got[2])),
              f"the dp×tp step vs the unsharded step: loss {loss_diff}, params {param_diff}")

        def timed(step: Callable[[], Any]) -> float:
            return p50_ms(lambda: (step(), torch.cuda.synchronize()), 21)

        plain_ms = timed(lambda: plain_step(params, tf.adam_init(params), x, y))
        sharded_ms = timed(lambda: sharded_step(shards, tf.adam_init(shards), x, y))
    finally:
        train.close()
    rows.append({"program": "train step, 64 chips x 61 samples", "sharded_ms": sharded_ms,
                 "unsharded_ms": plain_ms, "loss_rel_diff": loss_diff, "param_abs_diff": param_diff})
    print(f"mesh: dp×tp train step (data 1 x model 1, NCCL) on {x.shape[0]} windows: loss "
          f"{float(got[2]):.6g}, vs the unsharded step loss rel diff {loss_diff:.3e} (tol 1e-5), "
          f"params max abs diff {param_diff:.3e} (tol 1e-4); host p50 sharded {sharded_ms:.3f} ms, "
          f"unsharded {plain_ms:.3f} ms; on {smi}")
    check(LAUNCHES.n == 0, f"the mesh launched the forecast kernel {LAUNCHES.n} times")
    return LAUNCHES.n, rows


def record_replay_phase(torch: Any, smi: str) -> int:
    """Step 16: a demo run of the port's host on the card at --demo
    large, recorded through RecordingTransport on scripted clocks, then
    replayed twice through fresh apps over a ReplaySource: every page's
    <main> bytes identical across the replays and to the recorded run.
    Returns the forecast kernel's launches (0: no page here forecasts)."""
    import tempfile

    from headlamp_tpu_torch.history import Recorder, RecordingTransport, ReplaySource, load_recording
    from headlamp_tpu_torch.models.fused_forward import LAUNCHES
    from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

    pages = ("/tpu", "/tpu/nodes", "/tpu/pods", "/tpu/deviceplugins", "/tpu/fleet",
             "/tpu/topology", "/nodes")
    wall0 = 1_700_000_000.0

    class Clock:
        def __init__(self, now: float) -> None:
            self.now = now

        def __call__(self) -> float:
            return self.now

    def paint(transport: Any) -> dict[str, str]:
        mono, wall = Clock(1000.0), Clock(wall0)
        app = DashboardApp(transport, device="cuda", min_sync_interval_s=0.0, clock=wall,
                           monotonic=mono)
        try:
            out = {}
            for path in pages:
                status, _, body = app.handle(path)
                check(status == 200, f"{path} in a replay round: {status}")
                out[path] = re.search(r"<main>(.*)</main>", body, re.S).group(1)
                mono.now += 61.0
                wall.now += 61.0
            return out
        finally:
            app.close()

    LAUNCHES.reset()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "demo.jsonl"
        t0 = time.perf_counter()
        with open(path, "w", encoding="utf-8") as sink:
            recorder = Recorder(sink, monotonic=lambda: 0.0, wall=lambda: wall0, note="chip smoke")
            live = paint(RecordingTransport(make_demo_transport("large"), recorder))
        record_ms = (time.perf_counter() - t0) * 1e3
        recording = load_recording(str(path))
        size = path.stat().st_size
    rounds, round_ms = [], []
    for _ in range(2):
        source = ReplaySource(recording)
        t0 = time.perf_counter()
        rounds.append(paint(source))
        round_ms.append((time.perf_counter() - t0) * 1e3)
        check(source.requests_unknown == 0 and source.requests_served == recorder.exchanges,
              f"a replay round served {source.requests_served} of {recorder.exchanges} exchanges, "
              f"{source.requests_unknown} unknown")
    check(rounds[0] == rounds[1] == live, "the replay rounds' pages differ from each other or "
          "from the recorded run")
    check("Chip Allocation" in live["/tpu"], "the recorded /tpu has no allocation")
    print(f"record: --demo large on the card, {len(pages)} pages: {recorder.exchanges} exchanges "
          f"({size} bytes) recorded in {record_ms:.1f} ms; two sequential replays "
          f"({round_ms[0]:.1f}, {round_ms[1]:.1f} ms) paint <main> bytes identical to each other "
          f"and to the recorded run; 0 unknown paths; on {smi}")
    check(LAUNCHES.n == 0, f"the replayed pages launched the kernel {LAUNCHES.n} times")
    return LAUNCHES.n


def _slo_bench() -> dict[str, float]:
    """The SLO engine's, the exemplars' and the flight recorder's host
    costs, as bench.py's bench_slo defines them (`bench.py:951-1039`):
    the three calls a request adds to the engine (latency feed, status
    feed, violation check) on a scratch engine; a traced histogram
    observe with the exemplar source installed minus the same without;
    the resident size of a full flight ring of representative events."""
    from headlamp_tpu_torch.obs import exemplars
    from headlamp_tpu_torch.obs.flight import FlightRecorder, wide_event
    from headlamp_tpu_torch.obs.metrics import Histogram
    from headlamp_tpu_torch.obs.slo import REQUEST_DURATION, REQUESTS_TOTAL, SLOEngine
    from headlamp_tpu_torch.obs.trace import trace_request

    n = 5000
    engine = SLOEngine(device="cuda")
    latency_labels, status_labels = {"route": "/tpu"}, {"route": "/tpu", "status": "200"}
    t0 = time.perf_counter()
    for _ in range(n):
        engine.feed_latency(REQUEST_DURATION, 0.012, latency_labels)
        engine.feed_error(REQUESTS_TOTAL, 1, status_labels)
        engine.violations("/tpu", 0.012, 200)
    per_request_us = (time.perf_counter() - t0) / n * 1e6

    hist = Histogram("headlamp_tpu_torch_smoke_scratch_seconds", "scratch")

    def observe_ns() -> float:
        with trace_request("/smoke-exemplar"):
            t0 = time.perf_counter()
            for _ in range(n):
                hist.observe(0.012)
            return (time.perf_counter() - t0) / n * 1e9

    try:
        with_ns = observe_ns()
        exemplars.uninstall()
        without_ns = observe_ns()
    finally:
        exemplars.install()

    ring = FlightRecorder()
    event = wide_event(
        path="/tpu/metrics?window=1h", route="/tpu/metrics", status=200, duration_s=0.137,
        trace={"trace_id": "deadbeef00112233", "spans": [
            {"name": "sync.snapshot", "duration_ms": 12.0, "children": []},
            {"name": "metrics.fanout", "duration_ms": 80.0, "children": []},
            {"name": "render.html", "duration_ms": 9.0, "children": []},
        ]},
        counters_before={"transport.reused": 10, "cache.hits": 5},
        counters_after={"transport.reused": 14, "cache.hits": 6},
    )
    for _ in range(ring.capacity):
        ring.record(dict(event))
    for _ in range(ring.pinned_capacity):
        ring.record(dict(event, slo_violations=["scrape_paint"]), pinned=True)
    return {
        "slo_eval_overhead_us_per_request": per_request_us,
        "exemplar_overhead_ns_per_observe": with_ns - without_ns,
        "flight_ring_memory_kb": ring.memory_bytes() / 1024,
    }


def telemetry_phase(torch: Any, clock: Callable[[], float], smi: str) -> tuple[int, dict[str, Any]]:
    """Step 17: telemetry beyond spans. The host at --demo large on the
    card, started with serve() under a fresh SLO engine: dashboard pages
    and TELEMETRY_PAINTS /tpu/metrics paints over the socket (each paint
    feeds the scrape→paint objective and its history mirror), the
    profiler bursting, and one request failed by an injected sync error.
    Then /sloz is polled until the budget forecast leaves fit_pending:
    no fit_failed, the fit replayed the (8, 512) graph with no eager run
    (the ledger's slo.burn_forecast row), the kernel launched on that
    path, its output equal to its plain version on the fitted params and
    the predictions within TELEMETRY_FIT_TOL of the port's CPU fit on the
    same series. /metricsz's OpenMetrics exemplars name traces in
    /debug/traces, /debug/flightz pins the failed request, /debug/profilez
    attributes samples to the routes driven, /debug/generationz shows each
    generation's sync→paint stamps and every HTML page answers 200.
    Prints the host's own numbers. Returns the kernel's launches on the
    SLO path and a device_programs row."""
    import numpy as np

    from headlamp_tpu_torch.models import aot, service
    from headlamp_tpu_torch.models.forecast import COLD_PROGRAM, ForecastConfig
    from headlamp_tpu_torch.models.fused_forward import LAUNCHES, forecast_forward_reference
    from headlamp_tpu_torch.obs import flight, graphcost, slo
    from headlamp_tpu_torch.obs.profiler import profiler
    from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

    costs = _slo_bench()
    engine = slo.SLOEngine()
    previous_engine = slo.set_engine(engine)
    flight.flight_recorder.clear()
    cfg = ForecastConfig()
    reg, led = aot.registry(), graphcost.ledger()
    app = DashboardApp(make_demo_transport("large"), device="cuda", clock=clock)
    check(engine.history_store is app.history and str(engine.device) == str(app.device),
          "the host did not wire the SLO engine")
    # The gateway rules on an engine of its own: the failed request this
    # step pins on purpose would page dashboard_render on the step's
    # engine and shed the debug pages the step reads (step 18 sheds).
    gateway_engine = slo.SLOEngine()
    app.ensure_gateway(engine=lambda: gateway_engine)
    server = app.serve("127.0.0.1", 0)
    out: dict[str, Any] = {}
    try:
        check(reg.wait_ready(600.0) and reg.ready(), f"the program registry: {reg.snapshot()}")
        check(profiler().running(), "serve() did not start the profiler")
        burst = json.loads(http_get(server.url + "/debug/profilez?burst=60")[1])
        check(burst.get("burst_granted_s") == 60.0, f"/debug/profilez?burst=60: {burst}")
        driven = ("/tpu", "/tpu/nodes", "/tpu/pods", "/tpu/fleet", "/tpu/metrics")
        for _ in range(3):
            for path in driven:
                check(http_get(server.url + path)[0] == 200, f"GET {path}")

        def failing_sync() -> Any:
            raise RuntimeError("injected sync failure (chip smoke)")

        app._synced_snapshot = failing_sync
        try:
            status, _ = http_get(server.url + "/tpu/nodes")
        finally:
            del app._synced_snapshot
        check(status == 500, f"the injected failing request answered {status}")
        t0 = time.perf_counter()
        for _ in range(TELEMETRY_PAINTS):
            check(http_get(server.url + "/tpu/metrics")[0] == 200, "GET /tpu/metrics")
        paints_s = time.perf_counter() - t0
        check(app._forecast_refresher.drain() and app._metrics_refresher.drain(),
              "the page's refits did not finish")
        _ages, series = app.history.series(slo.PAINT_LATENCY_SERIES)
        check(len(series) == aot.SLO_SERIES_STEADY,
              f"the paint-latency mirror holds {len(series)} points")

        # The budget forecast: a background fit, polled through /sloz.
        before = led.snapshot()["programs"]
        LAUNCHES.reset()
        t0 = time.perf_counter()
        polls = 0
        while True:
            polls += 1
            status, body = http_get(server.url + "/sloz")
            check(status == 200, f"/sloz answered {status}")
            forecast = json.loads(body)["budget_forecast"]
            if forecast.get("reason") != "fit_pending":
                break
            check(time.perf_counter() - t0 < 300.0, "the budget forecast stayed fit_pending 300 s")
            time.sleep(0.05)
        fit_wait_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        launches = LAUNCHES.n
        after = led.snapshot()["programs"]

        def moved(name: str, kind: str) -> int:
            return after.get(name, {}).get(kind, 0) - before.get(name, {}).get(kind, 0)

        check(forecast.get("reason") != "fit_failed" and engine.budget_fit_error is None,
              f"the budget forecast failed: {forecast}")
        check(forecast["data_source"] == "history" and forecast["points"] == aot.SLO_SERIES_STEADY,
              f"the budget forecast trained on {forecast}")
        burn = (moved(service.SLO_BURN_PROGRAM, "replays"), moved(service.SLO_BURN_PROGRAM, "eager"))
        cold = moved(COLD_PROGRAM, "replays")
        check(burn == (1, 0) and cold == 1,
              f"slo.burn_forecast replays/eager {burn}, cold-fit replays {cold}")
        check(launches == 1, f"the SLO path launched forecast_mlp_forward {launches} times")
        health = json.loads(http_get(server.url + "/healthz")[1])
        check(health["ok"] and health["runtime"]["slo"]["budget_fit_error"] is None,
              f"/healthz after the budget fit: ok {health['ok']}, slo {health['runtime']['slo']}")

        # The card's predictions: against the kernel's plain version on the
        # fitted params, and against the port's CPU fit on the same series.
        card = engine.budget_predictions()
        check(card is not None and len(card) == cfg.horizon and all(map(math.isfinite, card)),
              f"card predictions {card}")
        params = engine._warm_state.params
        recent = torch.tensor(series[-cfg.window:], device="cuda")[None, :]
        plain = forecast_forward_reference(params, recent)[0].cpu().numpy()
        plain_err = float(np.max(np.abs(np.asarray(card) - plain)))
        cpu, _ = service.forecast_slo_burn(series, device="cpu")
        fit_diff = float(np.max(np.abs(np.asarray(card) - np.asarray(cpu))))
        print(f"telemetry: budget forecast after {polls} /sloz polls ({fit_wait_ms:.1f} ms): "
              f"{forecast}; slo.burn_forecast +{burn[0]} replay, +{burn[1]} eager; "
              f"forecast_mlp_forward launches={launches}; predictions {[round(p, 6) for p in card]}")
        print(f"telemetry: card predictions vs the kernel's plain version {plain_err:.3e} "
              f"(tol {KERNEL_TOL:g}); vs the CPU fit on the same 512 points {fit_diff:.3e} "
              f"(tol {TELEMETRY_FIT_TOL:g})")
        check(plain_err <= KERNEL_TOL, f"SLO kernel output vs plain: {plain_err}")
        check(fit_diff <= TELEMETRY_FIT_TOL, f"card vs CPU budget fit: {fit_diff}")

        # The burn fit's own time, inside the engine's TTL (no refit runs
        # beside it): replayed at 512 points, eager at a non-bucket length.
        def fit_ms(points: list[float], n: int) -> float:
            return p50_ms(lambda: service.forecast_slo_burn(points, device="cuda"), n)

        replay_before = led.snapshot()["programs"][service.SLO_BURN_PROGRAM]
        replay_ms = fit_ms(series, 7)
        eager_ms = fit_ms(series[-TELEMETRY_EAGER_POINTS:], 3)
        replay_after = led.snapshot()["programs"][service.SLO_BURN_PROGRAM]
        check(replay_after["replays"] - replay_before["replays"] == 7
              and replay_after["eager"] - replay_before["eager"] == 3,
              f"slo.burn_forecast while timed: {replay_before} -> {replay_after}")
        events = device_event_names(torch, lambda: service.forecast_slo_burn(series, device="cuda"))
        kernel_events = sum("forecast_mlp" in name for name in events)

        # Exemplars on /metricsz name traces in the ring.
        req = urllib.request.Request(server.url + "/metricsz",
                                     headers={"Accept": "application/openmetrics-text"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            ctype, metricsz = resp.headers["Content-Type"], resp.read().decode()
        ids = set(re.findall(r'^headlamp_tpu_torch_request_duration_seconds_bucket\{[^}]*\} '
                             r'\d+ # \{trace_id="([0-9a-f]{16})"\} ', metricsz, re.M))
        traces = json.loads(http_get(server.url + "/debug/traces")[1])["traces"]
        latest = {}
        for trace in traces:
            latest.setdefault(trace["route"], trace["trace_id"])
        linked = ids & {t["trace_id"] for t in traces}
        check(ctype.startswith("application/openmetrics-text") and metricsz.endswith("# EOF\n")
              and latest["/tpu/metrics"] in ids and linked,
              f"/metricsz exemplars: {len(ids)} ids, {len(linked)} in /debug/traces")

        # The flight recorder pinned the failed request.
        flightz = json.loads(http_get(server.url + "/debug/flightz")[1])
        failed = [e for e in flightz["pinned"] if e["status"] == 500 and e["route"] == "/tpu/nodes"]
        check(len(failed) == 1, f"/debug/flightz pinned {flightz['pinned'][:3]}")

        # The profiler attributed samples to the routes driven.
        prof = json.loads(http_get(server.url + "/debug/profilez")[1])
        sampled = {r: row["stacks"] for r, row in prof["routes"].items() if r in driven}
        check("/tpu/metrics" in sampled and prof["samples"] > 0,
              f"/debug/profilez routes {prof['routes']}")
        folded = http_get(server.url + "/debug/profilez/folded")[1]
        check(any(line.startswith("/tpu/metrics;") for line in folded.splitlines()),
              "no folded stack under /tpu/metrics")

        # The generation ledger's sync→paint stamps.
        gens = json.loads(http_get(server.url + "/debug/generationz")[1])["generations"]
        stamped = [g for g in gens if {"scrape_start", "synced", "first_paint"} <= set(g["stages"])]
        check(bool(stamped) and all(g["age_at_paint_ms"] is not None for g in stamped),
              f"/debug/generationz: {gens[:2]}")
        for path in ("/sloz/html", "/debug/traces/html", "/debug/profilez/html",
                     "/debug/generationz/html"):
            check(http_get(server.url + path)[0] == 200, f"GET {path}")
        sloz_ms = []
        for _ in range(15):
            t0 = time.perf_counter()
            status, _, body = app.handle("/sloz/html")
            sloz_ms.append((time.perf_counter() - t0) * 1e3)
            check(status == 200 and "Service Level Objectives" in body, "/sloz/html")

        overhead = profiler().overhead_ns_per_sample()
        out = dict(
            costs, sloz_paint_ms=statistics.median(sloz_ms),
            profiler_overhead_ns_per_sample=overhead, profiler_samples=prof["samples"],
            burn_fit_replay_ms=replay_ms, burn_fit_eager_ms=eager_ms,
            eager_points=TELEMETRY_EAGER_POINTS, paints=TELEMETRY_PAINTS,
            paints_s=paints_s, max_abs_err=plain_err, card_vs_cpu=fit_diff,
        )
        print(f"telemetry: {TELEMETRY_PAINTS} /tpu/metrics paints in {paints_s:.2f} s; profiler "
              f"{prof['samples']} samples, stacks by route {sampled}; exemplars {len(ids)} "
              f"({len(linked)} in the ring); {len(stamped)} generation(s) stamped sync->paint, "
              f"first {stamped[0]['stages']}; flight pinned {len(flightz['pinned'])}")
        print(f"telemetry: slo_eval_overhead_us_per_request {costs['slo_eval_overhead_us_per_request']:.3f}, "
              f"exemplar_overhead_ns_per_observe {costs['exemplar_overhead_ns_per_observe']:.1f}, "
              f"flight_ring_memory_kb {costs['flight_ring_memory_kb']:.1f}, sloz_paint_ms p50 "
              f"{out['sloz_paint_ms']:.3f}, profiler overhead_ns_per_sample {overhead:.1f}; "
              f"burn fit replayed at 512 points {replay_ms:.3f} ms p50 vs eager at "
              f"{TELEMETRY_EAGER_POINTS} points {eager_ms:.3f} ms p50; forecast_mlp device events "
              f"in one replay {kernel_events} of {len(events)}; on {smi}")
    finally:
        server.close()
        slo.set_engine(previous_engine)
    check(not profiler().running(), "the server's close() left the profiler running")
    return launches, {"name": "slo.burn_forecast", "route": "cuda graphs",
                      "replaces": "headlamp_tpu/models/service.py:231", "rows": [out]}


def _keepalive_get(port: int, path: str, conn: Any = None,
                   headers: dict[str, str] | None = None) -> tuple[int, dict[str, str], bytes, float]:
    """(status, headers, body, ms) of one GET; with ``conn`` on that
    client connection (http.client reopens it when the server closes)."""
    own = conn is None
    if own:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        t0 = time.perf_counter()
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        body = resp.read()
        return resp.status, dict(resp.getheaders()), body, (time.perf_counter() - t0) * 1e3
    finally:
        if own:
            conn.close()


def _saturation_curve(port: int, concurrency: tuple[int, ...] = GATEWAY_CONCURRENCY,
                      path: str = "/tpu/metrics") -> dict[str, float]:
    """bench.py's client loop (``bench.py:1255-1310``) on ``path``: c
    clients released by a barrier, each on its own keep-alive connection,
    unique query strings so coalescing never hides the pool's queueing."""
    import threading

    out: dict[str, float] = {}
    for c in concurrency:
        lat: list[float] = []
        statuses: list[int] = []
        lock = threading.Lock()
        barrier = threading.Barrier(c)

        def client(worker: int, c: int = c) -> None:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            barrier.wait()
            mine = [_keepalive_get(port, f"{path}?c={c}&w={worker}&i={i}", conn)
                    for i in range(GATEWAY_REQUESTS)]
            conn.close()
            with lock:
                lat.extend(m[3] for m in mine)
                statuses.extend(m[0] for m in mine)

        threads = [threading.Thread(target=client, args=(w,)) for w in range(c)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall_s = time.perf_counter() - t0
        check(statuses == [200] * (c * GATEWAY_REQUESTS), f"c={c}: statuses {set(statuses)}")
        lat.sort()
        out[f"p50_ms_c{c}"] = statistics.median(lat)
        out[f"p99_ms_c{c}"] = lat[max(0, int(len(lat) * 0.99) - 1)]
        out[f"agg_rps_c{c}"] = len(lat) / wall_s
    return out


def gateway_phase(torch: Any, clock: Callable[[], float], smi: str) -> tuple[int, dict[str, Any]]:
    """Step 18: the request gateway and the real transport, at --demo
    large on the card. The host is served with ``serve()`` (its gateway on
    a switchable SLO engine, its TTL clock a frozen list cell, so no
    background refit launches in the step): ``/healthz`` shows the
    gateway; the unloaded /tpu/metrics p50 and a saturation curve at
    1/4/16/32 keep-alive clients. After ``/refresh``, sixteen identical
    cold /tpu/metrics GETs fired together are one render and one fit (one
    kernel launch, a replay: no eager run), the leader held until the
    other fifteen joined it; their ETag answers a 304 with no body and no
    render. With a paging engine /debug/traces is a 503 with Retry-After
    5, /metricsz and /sloz answer, and after an epoch bump /tpu/metrics
    renders degraded with no launch, replay or eager run; restored, a
    render launches again. Then a local stand-in apiserver serves the
    demo fleet: an app on ``KubeTransport`` paints /tpu and /tpu/metrics
    over the socket with the demo app's ``<main>`` (the measured timings
    masked), one launch for its fit, and five fresh-app paints over the
    one transport open at most one connection per paint and reuse at
    least 0.9 of them. Returns the kernel's launches and the numbers."""
    from headlamp_tpu_torch.models import aot
    from headlamp_tpu_torch.models.fused_forward import LAUNCHES
    from headlamp_tpu_torch.obs import graphcost, slo
    from headlamp_tpu_torch.runtime.device_cache import warm_carries
    from headlamp_tpu_torch.server import DashboardApp, make_demo_transport
    from headlamp_tpu_torch.server.standin import StandInApiserver
    from headlamp_tpu_torch.transport import KubeTransport

    def paging_engine() -> Any:
        eng = slo.SLOEngine(monotonic=lambda: 1000.0)
        for objective in ("dashboard_render", "scrape_paint"):
            for _ in range(600):
                eng.record(objective, False)
        check(eng.health_block()["scrape_paint"] == "page", "the storm did not page")
        return eng

    def ledger_kinds() -> tuple[int, int]:
        programs = graphcost.ledger().snapshot()["programs"].values()
        return sum(p.get("replays", 0) for p in programs), sum(p.get("eager", 0) for p in programs)

    launches = 0
    out: dict[str, Any] = {}
    mono = [5000.0]
    engines = {"now": slo.SLOEngine()}
    warm_carries.invalidate()
    app = DashboardApp(make_demo_transport("large"), device="cuda", clock=clock,
                       monotonic=lambda: mono[0], min_sync_interval_s=3600.0)
    gateway = app.ensure_gateway(engine=lambda: engines["now"])
    server = app.serve("127.0.0.1", 0)
    port = int(server.url.rsplit(":", 1)[1])
    try:
        check(aot.registry().wait_ready(600.0), f"the program registry: {aot.registry().snapshot()}")
        health = json.loads(http_get(server.url + "/healthz")[1])["runtime"]
        check(health.get("gateway", {}).get("workers") == 4, f"/healthz gateway {health.get('gateway')}")
        LAUNCHES.reset()
        status, _, _, cold_ms = _keepalive_get(port, "/tpu/metrics")
        check(status == 200, f"cold GET /tpu/metrics answered {status}")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        unloaded = [_keepalive_get(port, f"/tpu/metrics?u={i}", conn)[3]
                    for i in range(GATEWAY_UNLOADED)]
        conn.close()
        curve = _saturation_curve(port)
        torch.cuda.synchronize()
        check(LAUNCHES.n == 1, f"the cold GET and cached paints launched {LAUNCHES.n} times")
        launches += LAUNCHES.n
        out.update(unloaded_p50_ms=statistics.median(unloaded), cold_ms=cold_ms, **curve)
        print(f"gateway: /tpu/metrics cold {cold_ms:.1f} ms; unloaded p50 "
              f"{out['unloaded_p50_ms']:.2f} ms ({GATEWAY_UNLOADED} paints, one client); on {smi}")
        print("gateway: saturation " + "; ".join(
            f"c={c} p50 {curve[f'p50_ms_c{c}']:.2f} p99 {curve[f'p99_ms_c{c}']:.2f} ms "
            f"{curve[f'agg_rps_c{c}']:.1f} req/s" for c in GATEWAY_CONCURRENCY) + f"; on {smi}")

        # Coalescing: after /refresh every cache is cold; sixteen identical
        # requests fired together cost one render and one fit.
        check(http_get_no_redirect(server.url + "/refresh?back=/tpu/metrics")[0] == 302,
              "/refresh did not redirect")
        inner = gateway._handle

        def gated(path: str, **kw: Any) -> Any:
            deadline = time.perf_counter() + 30.0
            while not any(f.followers == GATEWAY_BURST - 1
                          for f in list(gateway.coalescer._flights.values())):
                check(time.perf_counter() < deadline, "the burst never gathered")
                time.sleep(0.0005)
            return inner(path, **kw)

        gateway._handle = gated
        before, kinds = gateway.counters(), ledger_kinds()
        refits = app._forecast_refresher.snapshot()["refits"]
        conns = [http.client.HTTPConnection("127.0.0.1", port, timeout=120)
                 for _ in range(GATEWAY_BURST)]
        for c in conns:
            c.connect()
        LAUNCHES.reset()
        t0 = time.perf_counter()
        for c in conns:
            c.request("GET", "/tpu/metrics")
        burst = []
        for c in conns:
            resp = c.getresponse()
            burst.append((resp.status, resp.getheader("ETag"), resp.read()))
            c.close()
        burst_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        gateway._handle = inner
        after, kinds_after = gateway.counters(), ledger_kinds()
        rendered = after["rendered"] - before["rendered"]
        followers = after["coalesced_followers"] - before["coalesced_followers"]
        fits = app._forecast_refresher.snapshot()["refits"] - refits
        replays, eager = kinds_after[0] - kinds[0], kinds_after[1] - kinds[1]
        leader = json.loads(http_get(server.url + "/debug/traces")[1])["traces"][0]
        check({b[0] for b in burst} == {200} and len({b[2] for b in burst}) == 1
              and len({b[1] for b in burst}) == 1,
              f"burst: statuses {sorted({b[0] for b in burst})}, "
              f"{len({b[2] for b in burst})} bodies, {len({b[1] for b in burst})} ETags")
        check(rendered == 1 and followers == GATEWAY_BURST - 1,
              f"burst: rendered +{rendered}, coalesced_followers +{followers}")
        check(fits == 1 and LAUNCHES.n == 1 and replays >= 1 and eager == 0,
              f"burst: {fits} fits, {LAUNCHES.n} launches, +{replays} replays, +{eager} eager")
        launches += LAUNCHES.n
        etag = burst[0][1]
        renders = gateway.counters()["rendered"]
        status, headers, body, _ = _keepalive_get(port, "/tpu/metrics", headers={"If-None-Match": etag})
        torch.cuda.synchronize()
        check(status == 304 and body == b"" and headers.get("ETag") == etag
              and gateway.counters()["rendered"] == renders and LAUNCHES.n == 1,
              f"If-None-Match: {status}, {len(body)} bytes, rendered "
              f"{gateway.counters()['rendered'] - renders}, launches {LAUNCHES.n}")
        out.update(burst_ms=burst_ms, leader_ms=leader["duration_ms"], burst_replays=replays)
        print(f"gateway: {GATEWAY_BURST} identical cold GETs after /refresh in {burst_ms:.1f} ms "
              f"(leader's render {leader['duration_ms']} ms): rendered +{rendered}, "
              f"coalesced_followers +{followers}, fits {fits}, forecast_mlp_forward launches "
              f"{LAUNCHES.n}, graph replays +{replays}, eager +{eager}; one ETag {etag}; "
              f"If-None-Match -> 304, 0 bytes, +0 renders, +0 launches; on {smi}")

        # Shedding on a paging engine.
        engines["now"] = paging_engine()
        gateway.shed_policy.invalidate()
        status, headers, body, _ = _keepalive_get(port, "/debug/traces")
        shed = json.loads(body)
        check(status == 503 and headers.get("Retry-After") == "5" and shed["reason"] == "burn_rate"
              and shed["shed"] is True, f"/debug/traces under paging: {status} {headers} {shed}")
        for path in ("/metricsz", "/sloz"):
            check(_keepalive_get(port, path)[0] == 200, f"{path} under paging")
        check(http_get_no_redirect(server.url + "/refresh?back=/tpu/metrics")[0] == 302,
              "/refresh under paging")
        kinds = ledger_kinds()
        LAUNCHES.reset()
        status, headers, body, degraded_ms = _keepalive_get(port, "/tpu/metrics")
        check(app._forecast_refresher.drain(), "a refit outlived the degraded render")
        torch.cuda.synchronize()
        check(status == 200 and headers.get("X-Headlamp-Stale") == "1"
              and b"Utilization Forecast" not in body and LAUNCHES.n == 0
              and ledger_kinds() == kinds,
              f"degraded /tpu/metrics: {status}, stale {headers.get('X-Headlamp-Stale')}, "
              f"launches {LAUNCHES.n}, ledger {kinds} -> {ledger_kinds()}")
        engines["now"] = slo.SLOEngine()
        gateway.shed_policy.invalidate()
        status, headers, body, restored_ms = _keepalive_get(port, "/tpu/metrics")
        torch.cuda.synchronize()
        check(status == 200 and headers.get("X-Headlamp-Stale") == "0"
              and b"Utilization Forecast" in body and LAUNCHES.n == 1,
              f"restored /tpu/metrics: {status}, launches {LAUNCHES.n}")
        launches += LAUNCHES.n
        print(f"gateway: paging -> /debug/traces 503 Retry-After 5 {shed['burn_state']}; "
              f"/metricsz, /sloz 200; degraded /tpu/metrics {degraded_ms:.1f} ms, stale, no "
              f"forecast panel, 0 launches, 0 replays, 0 eager; restored {restored_ms:.1f} ms, "
              f"1 launch; gateway {gateway.counters()}")
    finally:
        server.close()

    # The real transport against a local stand-in apiserver.
    stand = StandInApiserver(make_demo_transport("large"))
    kube = KubeTransport(stand.url)
    try:
        mains = {}
        for name, transport in (("demo", make_demo_transport("large")), ("kube", kube)):
            warm_carries.invalidate()
            app = DashboardApp(transport, device="cuda", clock=clock, monotonic=lambda: mono[0],
                               min_sync_interval_s=3600.0)
            app.ensure_gateway(engine=lambda: engines["now"])
            server = app.serve("127.0.0.1", 0)
            try:
                LAUNCHES.reset()
                pages = [http_get(server.url + path) for path in ("/tpu", "/tpu/metrics")]
                torch.cuda.synchronize()
                check([s for s, _ in pages] == [200, 200] and LAUNCHES.n == 1,
                      f"{name}: statuses {[s for s, _ in pages]}, launches {LAUNCHES.n}")
                launches += LAUNCHES.n
                mains[name] = [PAGE_TIMINGS.sub(r"\1 # ms", b.split("<main>")[1]) for _, b in pages]
                if name == "kube":
                    block = json.loads(http_get(server.url + "/healthz")[1])["runtime"]["transport"]
            finally:
                server.close()
        check(mains["kube"] == mains["demo"], "KubeTransport's <main> differs from the demo's")
        paint_ms: dict[str, list[float]] = {"demo": [], "kube": []}
        before = kube.pool.snapshot()
        LAUNCHES.reset()
        for name in ("demo", "kube"):
            for _ in range(TRANSPORT_PAINTS):
                transport = kube if name == "kube" else make_demo_transport("large")
                app = DashboardApp(transport, device="cuda", clock=clock,
                                   monotonic=lambda: mono[0], min_sync_interval_s=0.0)
                gw = app.ensure_gateway(engine=lambda: engines["now"])
                t0 = time.perf_counter()
                response = gw.handle("/tpu/metrics")
                paint_ms[name].append((time.perf_counter() - t0) * 1e3)
                check(response.status == 200, f"{name} paint answered {response.status}")
                app.close()
        torch.cuda.synchronize()
        check(LAUNCHES.n == 2 * TRANSPORT_PAINTS, f"the fresh-app paints launched {LAUNCHES.n}")
        launches += LAUNCHES.n
        after = kube.pool.snapshot()
        opened = after["connections_opened"] - before["connections_opened"]
        reused = after["connections_reused"] - before["connections_reused"]
        opened_per_paint = opened / TRANSPORT_PAINTS
        reuse_rate = reused / (opened + reused)
        check(opened_per_paint <= MAX_OPENED_PER_PAINT and reuse_rate >= MIN_REUSE_RATE,
              f"pool over {TRANSPORT_PAINTS} paints: opened {opened}, reused {reused}")
        p50 = {k: statistics.median(v) for k, v in paint_ms.items()}
        out.update(kube_paint_p50_ms=p50["kube"], demo_paint_p50_ms=p50["demo"],
                   connections_opened_per_request=opened_per_paint,
                   connection_reuse_rate=reuse_rate, stand_in_connects=stand.connects,
                   stand_in_requests=stand.requests)
        print(f"transport: KubeTransport <main> of /tpu and /tpu/metrics equal to the demo's; "
              f"/healthz transport {block}")
        print(f"transport: scrape->paint p50 over {TRANSPORT_PAINTS} fresh apps: KubeTransport "
              f"{p50['kube']:.1f} ms vs demo {p50['demo']:.1f} ms; connections_opened_per_request "
              f"{opened_per_paint:.3f} (<= {MAX_OPENED_PER_PAINT:g}), connection_reuse_rate "
              f"{reuse_rate:.4f} (>= {MIN_REUSE_RATE:g}); stand-in accepted {stand.connects} "
              f"connections for {stand.requests} requests; all {json.dumps(paint_ms)}; on {smi}")
    finally:
        kube.pool.close()
        stand.close()
    check(launches == GATEWAY_LAUNCHES, f"the gateway step launched {launches}, not {GATEWAY_LAUNCHES}")
    return launches, out


def _paging_engine(slo: Any) -> Any:
    """An SLO engine of its own on which dashboard_render and scrape_paint
    page (600 failed observations each on a frozen clock)."""
    eng = slo.SLOEngine(monotonic=lambda: 1000.0)
    for objective in ("dashboard_render", "scrape_paint"):
        for _ in range(600):
            eng.record(objective, False)
    check(eng.health_block()["scrape_paint"] == "page", "the storm did not page")
    return eng


class _SseClient:
    """One ``/events`` connection, read event by event on its socket
    (heartbeat comments skipped)."""

    def __init__(self, port: int, path: str, headers: dict[str, str] | None = None) -> None:
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        self.conn.request("GET", path, headers=headers or {})
        self.resp = self.conn.getresponse()
        check(self.resp.status == 200
              and self.resp.getheader("Content-Type") == "text/event-stream",
              f"GET {path}: {self.resp.status} {self.resp.getheader('Content-Type')}")

    def next_event(self) -> dict[str, Any]:
        """The next event's fields (``id``, ``event``, ``data`` parsed) and
        its size on the wire in ``bytes``."""
        lines: list[str] = []
        size = 0
        while True:
            raw = self.resp.fp.readline()
            check(raw != b"", "an /events stream ended early")
            size += len(raw)
            line = raw.decode().rstrip("\n")
            if line:
                lines.append(line)
                continue
            fields = [x for x in lines if not x.startswith(":")]
            if fields:
                event: dict[str, Any] = dict(x.split(": ", 1) for x in fields)
                event["data"] = json.loads(event["data"])
                event["bytes"] = size
                return event
            lines, size = [], 0  # a heartbeat

    def close(self) -> None:
        self.conn.close()


def _flip_ready(app: Any, transport: Any, index: int) -> str:
    """Push a MODIFIED event that flips one node's Ready condition."""
    node = json.loads(json.dumps(app._last_snapshot.provider("tpu").nodes[index]))
    for cond in node["status"]["conditions"]:
        if cond["type"] == "Ready":
            cond["status"] = "False" if cond["status"] == "True" else "True"
    transport.node_feed.push("MODIFIED", node)
    return node["metadata"]["name"]


def push_phase(torch: Any, clock: Callable[[], float], smi: str) -> tuple[int, dict[str, Any]]:
    """Step 19: push and the fragment cache at ``fleet_viewport(1024)``
    with the demo Prometheus, on the card. The host is served with
    ``serve()`` and a 0.2 s background sync; one /tpu/metrics GET puts a
    forecast on the card. 32 interactive ``/events`` clients, one region
    client and one debug client connect one at a time (the listen backlog
    is 5), and the gateway counts 34 SSE connections with no render
    worker busy. One node's Ready flip is one diff and one delta per
    interactive client (id ``g<gen>``, the changed page only), the region
    client's frame only for its region, with 0 renders, kernel launches,
    replays or eager programs; the differ's region cells equal the region
    rollup on the card exactly. A resume one generation back replays the
    missed delta, one past the backlog repaints each page (``resync``).
    Under a paging engine the next flip sheds the debug stream (``bye``,
    ``shed``) and reaches every interactive one. Then two apps on the
    same fixture and a frozen clock, one painting through its fragment
    cache and one with ``fragments=False`` (sharing the metrics and
    forecast refreshers, so both paint one scrape and one fit): warm
    paints of the five pages are byte-identical, the hit rate and the
    5-page p50s on and off are printed, a flip re-renders the changed
    boundaries of /tpu/nodes, and a refit forced by /refresh re-renders
    the forecast fragment with one kernel launch. ``server.close()``
    joins every SSE handler thread. Returns the launches and numbers."""
    from headlamp_tpu_torch import push as push_mod
    from headlamp_tpu_torch.analytics.fleet_torch import REGION_CLUSTER_SEGMENTS
    from headlamp_tpu_torch.fleet import fleet_transport, fleet_viewport
    from headlamp_tpu_torch.models.fused_forward import LAUNCHES
    from headlamp_tpu_torch.obs import graphcost, slo
    from headlamp_tpu_torch.obs.trace import trace_ring
    from headlamp_tpu_torch.runtime.device_cache import warm_carries
    from headlamp_tpu_torch.server import DashboardApp
    from headlamp_tpu_torch.server.demo import add_demo_prometheus
    from headlamp_tpu_torch.viewport import tree as vt

    def fixture() -> Any:
        fleet = fleet_viewport(PUSH_NODES)
        transport = fleet_transport(fleet)
        add_demo_prometheus(transport, fleet)
        return transport

    def ledger_kinds() -> tuple[int, int]:
        programs = graphcost.ledger().snapshot()["programs"].values()
        return sum(p.get("replays", 0) for p in programs), sum(p.get("eager", 0) for p in programs)

    def diff_seconds() -> tuple[float, int]:
        child = push_mod._DIFF_SECONDS._children.get(())
        return (child.sum, child.count) if child is not None else (0.0, 0)

    def sse_threads() -> list[Any]:
        return [t for t in threading.enumerate() if "process_request_thread" in t.name]

    # One reset for the whole step; each segment reads its own delta and
    # is held to its count, so a refit anywhere in the step (a warm round
    # included, where it would skew the hit rate and the p50s) shows.
    LAUNCHES.reset()
    segments: dict[str, int] = {}

    def segment(name: str, want: int) -> None:
        torch.cuda.synchronize()
        n = LAUNCHES.n - sum(segments.values())
        segments[name] = n
        check(n == want, f"step 19's {name} launched forecast_mlp_forward {n} times, not {want}")

    out: dict[str, Any] = {}
    t_step = time.perf_counter()
    warm_carries.invalidate()
    engines = {"now": slo.SLOEngine()}
    transport = fixture()
    app = DashboardApp(transport, device="cuda", clock=clock, min_sync_interval_s=3600.0)
    gateway = app.ensure_gateway(engine=lambda: engines["now"])
    server = app.serve("127.0.0.1", 0)
    port = int(server.url.rsplit(":", 1)[1])
    clients: list[_SseClient] = []
    try:
        app.start_background_sync(LIVE_INTERVAL_S)
        _wait_for(lambda: app._background_counters["ticks"] >= 1, "the hydrating tick")
        segment("setup", 0)
        check(http_get(server.url + "/tpu/metrics")[0] == 200, "GET /tpu/metrics")
        segment("first /tpu/metrics", 1)
        check(app._peek_forecast() is not None, "no forecast to peek after /tpu/metrics")
        # The baseline models were built before any metrics were cached:
        # one flip first, so the metrics model diffs with its peeks from
        # here on and the measured flip changes /tpu/nodes alone.
        diffs = app.push.counters()["diffs"]
        _flip_ready(app, transport, 3)
        app._background_wake.set()
        _wait_for(lambda: app.push.counters()["diffs"] == diffs + 1, "the warm-up diff")

        # Streams, one connect at a time.
        interactive = [_SseClient(port, "/events") for _ in range(PUSH_CLIENTS)]
        clients += interactive
        flip_index = 7
        node_name = app._last_snapshot.provider("tpu").nodes[flip_index]["metadata"]["name"]
        cluster, _ = vt.node_region(app._last_snapshot.provider("tpu").nodes[flip_index])
        region_page = f"region:cluster/{cluster}"
        region = _SseClient(port, f"/events?region=cluster/{cluster}")
        debug = _SseClient(port, "/events?class=debug")
        clients += [region, debug]
        health = json.loads(http_get(server.url + "/healthz")[1])["runtime"]
        check(health["gateway"]["sse_connections"] == PUSH_CLIENTS + 2
              and health["gateway"]["inflight_renders"] == 0
              and health["push"]["connected"] == PUSH_CLIENTS + 2,
              f"/healthz gateway {health['gateway']}, push {health['push']}")
        segment("warm-up flip and connects", 0)

        # One fleet change.
        before = dict(app.push.counters())
        renders, kinds, diff_before = gateway.counters()["rendered"], ledger_kinds(), diff_seconds()
        gen = app.snapshot_generation()
        t0 = time.perf_counter()
        flipped = _flip_ready(app, transport, flip_index)
        app._background_wake.set()
        events = [c.next_event() for c in interactive]
        fanout_ms = (time.perf_counter() - t0) * 1e3
        region_event = region.next_event()
        debug_event = debug.next_event()
        torch.cuda.synchronize()
        after = app.push.counters()
        new_gen = app.snapshot_generation()
        check(flipped == node_name and new_gen == gen + 1, f"generation {gen} -> {new_gen}")
        for event in events + [debug_event]:
            check(event["id"] == f"g{new_gen}" and event["event"] == "delta"
                  and event["data"]["page"] == "/tpu/nodes"
                  and list(event["data"]["rows"]) == [node_name]
                  and event["data"]["cells"] == {} and event["data"]["removed"] == [],
                  f"an interactive client read {event}")
        check(region_event["event"] == "delta" and region_event["data"]["page"] == region_page
              and list(region_event["data"]["rows"]) == [node_name],
              f"the region client read {region_event}")
        check(after["diffs"] == before["diffs"] + 1
              and after["broadcasts"] == before["broadcasts"] + 1
              and after["frames_sent"] - before["frames_sent"] == PUSH_CLIENTS + 2,
              f"push counters {before} -> {after}")
        segment("fan-out", 0)
        check(gateway.counters()["rendered"] == renders and ledger_kinds() == kinds,
              f"the fan-out rendered {gateway.counters()['rendered'] - renders}, ledger "
              f"{kinds} -> {ledger_kinds()}")
        diff_after = diff_seconds()
        diff_ms = (diff_after[0] - diff_before[0]) * 1e3
        check(diff_after[1] == diff_before[1] + 1,
              f"diff observations {diff_before} -> {diff_after}")
        frame_bytes = events[0]["bytes"]
        out.update(diff_ms=diff_ms, frame_bytes=frame_bytes, fanout_ms=fanout_ms,
                   region_frame_bytes=region_event["bytes"],
                   frames=after["frames_sent"] - before["frames_sent"])
        print(f"push: {PUSH_NODES} nodes, one Ready flip of {node_name}: 1 diff in "
              f"{diff_ms:.3f} ms (push_diff_seconds), {PUSH_CLIENTS} interactive deltas of "
              f"{frame_bytes} bytes (page /tpu/nodes only), region {region_page} frame "
              f"{region_event['bytes']} bytes, debug 1; flip to the last client's delta "
              f"{fanout_ms:.1f} ms; 0 renders, 0 launches, 0 replays, 0 eager; on {smi}")

        # The differ's region cells against the card's region rollup.
        snap = app._last_snapshot
        state = snap.provider("tpu")
        check(app.push.generation == new_gen and state.view.version == new_gen,
              f"the differ holds generation {app.push.generation}, the snapshot {new_gen}")
        region_of, _, _, cluster_id, slice_id = vt._assignments(state.nodes)
        clusters, slices = vt._device_sums(state, cluster_id, slice_id, region_of,
                                           REGION_CLUSTER_SEGMENTS)
        models = app.push._models
        keys = (("nodes_total", "nodes"), ("nodes_ready", "ready"), ("capacity", "capacity"),
                ("allocatable", "allocatable"), ("in_use", "in_use"))
        mismatches = []
        pairs = [(vt.region_path(ck), clusters[cid]) for ck, cid in cluster_id.items()]
        pairs += [(vt.region_path(ck, sk), slices[sid]) for (ck, sk), sid in slice_id.items()]
        for path, stats in pairs:
            cells = models[push_mod.REGION_PAGE_PREFIX + path]["cells"]
            if any(cells[a] != stats[b] for a, b in keys):
                mismatches.append((path, cells, stats))
        check(not mismatches, f"region cells differ from the card's rollup: {mismatches[:3]}")
        print(f"push: region cells of {len(cluster_id)} clusters and {len(slice_id)} slices "
              f"(nodes, ready, capacity, allocatable, in_use) equal the card's region rollup "
              f"exactly")
        segment("region cells", 0)

        # Resume.
        replay = _SseClient(port, "/events", {"Last-Event-ID": f"g{new_gen - 1}"})
        clients.append(replay)
        missed = replay.next_event()
        check(missed["id"] == f"g{new_gen}" and missed["event"] == "delta"
              and missed["data"]["page"] == "/tpu/nodes", f"the resume replayed {missed}")
        stale = _SseClient(port, "/events", {"Last-Event-ID": "g0"})
        clients.append(stale)
        repaints = [stale.next_event() for _ in push_mod.PAGES]
        check([e["event"] for e in repaints] == ["paint"] * len(push_mod.PAGES)
              and sorted(e["data"]["page"] for e in repaints) == sorted(push_mod.PAGES)
              and {e["data"]["reason"] for e in repaints} == {"resync"},
              f"a resume past the backlog read {repaints}")
        print(f"push: Last-Event-ID g{new_gen - 1} replays the missed delta; g0 (past the "
              f"backlog) repaints {len(repaints)} pages with reason resync")
        segment("resume", 0)

        # Shedding: the next fleet change closes the debug stream only.
        engines["now"] = _paging_engine(slo)
        gateway.shed_policy.invalidate()
        _flip_ready(app, transport, flip_index)
        app._background_wake.set()
        bye = debug.next_event()
        check(bye["event"] == "bye" and bye["data"] == {"reason": "shed"},
              f"the debug stream read {bye}")
        nexts = [c.next_event() for c in interactive]
        check(all(e["id"] == f"g{new_gen + 1}" and e["event"] == "delta" for e in nexts),
              f"interactive streams after the shed: {sorted({e['id'] for e in nexts})}")
        engines["now"] = slo.SLOEngine()
        gateway.shed_policy.invalidate()
        segment("shed", 0)
        print(f"push: paging -> the debug stream got bye/shed; all {PUSH_CLIENTS} interactive "
              f"streams read g{new_gen + 1} next (exactly one delta each before it); hub "
              f"{app.push.hub.counters()}")
        handlers = len(sse_threads())
    finally:
        t_close = time.perf_counter()
        server.close()
        close_ms = (time.perf_counter() - t_close) * 1e3
        for c in clients:
            c.close()
    left = len(sse_threads())
    check(left == 0, f"{left} SSE handler threads outlived server.close()")
    segment("close", 0)
    out.update(close_ms=close_ms, handlers=handlers)
    print(f"push: server.close() in {close_ms:.1f} ms joined {handlers} request threads "
          f"({len(clients)} streams), {left} left")

    # Fragments against the oracle.
    mono = [7000.0]
    apps = {}
    for name, fragments in (("on", True), ("off", False)):
        apps[name] = DashboardApp(fixture(), device="cuda", clock=clock,
                                  monotonic=lambda: mono[0], min_sync_interval_s=3600.0,
                                  fragments=fragments)
    on, off = apps["on"], apps["off"]
    # One scrape and one fit for both: the oracle reads the same cached
    # metrics and forecast, so the measured times in the page are shared.
    off._metrics_refresher = on._metrics_refresher
    off._forecast_refresher = on._forecast_refresher
    try:
        for app_ in (on, off):
            app_._ctx.enable_watch()
            app_._background_tick()
            for path in FIVE_PAGES:
                check(app_.handle(path)[0] == 200, f"{path} answered")
        segment("fragment apps' first paints", 1)
        before = on.fragments.counters()
        times: dict[str, list[float]] = {"on": [], "off": []}
        for _ in range(PUSH_WARM_ROUNDS):
            bodies = {}
            for name, app_ in apps.items():
                t0 = time.perf_counter()
                bodies[name] = [app_.handle(path)[2] for path in FIVE_PAGES]
                times[name].append((time.perf_counter() - t0) * 1e3)
            check(bodies["on"] == bodies["off"], "a fragment paint differs from the oracle's")
        segment("warm rounds", 0)
        after = on.fragments.counters()
        hits, misses = after["hits"] - before["hits"], after["misses"] - before["misses"]
        hit_rate = hits / max(hits + misses, 1)
        p50 = {k: statistics.median(v) for k, v in times.items()}
        out.update(hit_rate=hit_rate, warm_p50_on_ms=p50["on"], warm_p50_off_ms=p50["off"])
        print(f"fragments: {PUSH_WARM_ROUNDS} warm rounds of {', '.join(FIVE_PAGES)} "
              f"byte-identical to fragments=False (no mask: one shared scrape and fit); hit "
              f"rate {hit_rate:.4f} ({hits} hits, {misses} misses); warm 5-page p50 "
              f"{p50['on']:.1f} ms with fragments, {p50['off']:.1f} ms without; all "
              f"{json.dumps(times)}; on {smi}")

        gen = on.snapshot_generation()
        for app_ in (on, off):
            _flip_ready(app_, app_._transport, 11)
            app_._background_tick()
        changed = on.push.changed_keys("/tpu/nodes", gen)
        bodies = {name: app_.handle("/tpu/nodes")[2] for name, app_ in apps.items()}
        splice = next(s for s in trace_ring.snapshot()[1]["spans"]
                      if s["name"] == "fragment.splice")["attrs"]
        check(bodies["on"] == bodies["off"] and changed is not None
              and 1 <= splice["rendered"] <= len(changed) + 1,
              f"after a flip /tpu/nodes re-rendered {splice} for changed keys {changed}")
        print(f"fragments: after one flip /tpu/nodes re-rendered {splice['rendered']} boundaries "
              f"and spliced {splice['spliced']}, for {len(changed)} changed keys {sorted(changed)}")
        segment("flip repaint", 0)

        misses = on.fragments.counters()["misses"]
        for app_ in (on, off):
            check(app_.handle("/refresh?back=/tpu/metrics")[0] == 302, "/refresh")
        bodies = {name: app_.handle("/tpu/metrics")[2] for name, app_ in apps.items()}
        segment("forced refit", 1)
        splice = next(s for s in trace_ring.snapshot()[1]["spans"]
                      if s["name"] == "fragment.splice")["attrs"]
        check(bodies["on"] == bodies["off"] and splice["rendered"] >= 1
              and on.fragments.counters()["misses"] > misses,
              f"the forced refit: splice {splice}")
        print(f"fragments: a refit forced by /refresh launched forecast_mlp_forward "
              f"once and re-rendered {splice['rendered']} boundaries of "
              f"/tpu/metrics (the new epoch misses every entry), bytes equal to the oracle's")
    finally:
        for app_ in apps.values():
            app_.close()
    launches = LAUNCHES.n
    check(launches == sum(segments.values()) == PUSH_LAUNCHES,
          f"the push step launched {launches} ({segments}), not {PUSH_LAUNCHES}")
    out["seconds"] = time.perf_counter() - t_step
    print(f"push: step 19 launched forecast_mlp_forward {launches} times, by segment "
          f"{json.dumps(segments)}; took {out['seconds']:.1f} s")
    return launches, out


def _main_of(body: str) -> str:
    found = re.search(r"<main>(.*)</main>", body, re.S)
    check(found is not None, "a page without <main>")
    return found.group(1)


def _replica_entry_point(url: str, leader: Any, wall: list[float]) -> dict[str, Any]:
    """Step 20's entry point: ``python -m headlamp_tpu_torch.server
    --replica URL`` as a process of its own on the card (the default
    device), polled until its /healthz reads role replica, device cuda
    and one applied record; its /tpu ``<main>`` equals the leader's,
    painted at the same wall time (age cells are relative). Interrupted
    and joined before this returns."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "headlamp_tpu_torch.server", "--replica", url, "--port",
         str(port)],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        health: dict[str, Any] = {}
        deadline = time.monotonic() + 180.0
        while True:
            if proc.poll() is not None:
                raise SmokeFailure(f"the replica process exited: {proc.communicate()}")
            check(time.monotonic() < deadline, f"the replica process never applied: {health}")
            try:
                status, _, body, _ = _keepalive_get(port, "/healthz")
            except OSError:
                time.sleep(0.2)
                continue
            health = json.loads(body)
            block = health["runtime"].get("replication", {})
            if block.get("applied", 0) >= 1:
                break
            time.sleep(0.2)
        ready_s = time.perf_counter() - t0
        check(health["runtime"]["replication"]["role"] == "replica"
              and health["runtime"]["device"]["torch_device"].startswith("cuda")
              and health["runtime"]["replication"]["last_generation"]
              == leader.snapshot_generation(),
              f"the replica process's /healthz: {health['runtime'].get('replication')}, "
              f"{health['runtime']['device']}")
        wall[0] = time.time()
        status, _, body, replica_ms = _keepalive_get(port, "/tpu")
        want = leader.handle("/tpu")
        check(status == want[0] == 200 and _main_of(body.decode()) == _main_of(want[2]),
              "the replica process's /tpu differs from the leader's")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            out, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        wall[0] = FIXED_CLOCK
    check(proc.returncode == 0, f"the replica process exited {proc.returncode}: {err[-2000:]}")
    print(f"replication: python -m headlamp_tpu_torch.server --replica {url}: applied "
          f"{health['runtime']['replication']['applied']} record(s) {ready_s:.2f} s after start, "
          f"/healthz role replica on {health['runtime']['device']['torch_device']}, first /tpu "
          f"{replica_ms:.1f} ms with the leader's <main>; SIGINT exit 0; banner "
          f"{out.strip().splitlines()[:1]}")
    return {"process_ready_s": ready_s, "process_first_tpu_ms": replica_ms}


def replication_phase(torch: Any, smi: str) -> tuple[int, dict[str, Any]]:
    """Step 20: provenance and replication on the card. A leader
    ``DashboardApp`` elected on an injected lease clock (fencing 1, its
    generations floored at 1 000 000) publishes on ``/replicate/bus`` at
    ``fleet_viewport(1024)`` with the demo Prometheus; one /tpu/metrics GET
    is its refit (1 launch), and the next generation ships that forecast.
    Two ``ReplicaApp``s on the card, each served, pull it through
    ``BusConsumer`` over ``pool_fetch``. For that generation their eight
    pages equal the leader's byte for byte over the socket, with the
    leader's ETags and a 304 for a leader ETag; the replica's rollup on
    the card equals the Python oracle; a node flip is the same /events
    frame on the leader and a replica; the replicas' metrics paints
    launch nothing. The poll trace names the publishing trace and the
    leader's bus serve names the poll. The failover drill on injected
    clocks: the leader's socket closes, the replicas answer every page
    with ``X-Headlamp-Stale: 1`` and no 5xx, a new leader is elected at
    fencing 2 and floors at 2 000 000, an old-band publish is
    ``rejected_stale``, both replicas converge. The real entry point
    ``--replica`` runs once as a process against the new leader. Then
    full width, ``fleet_viewport(16384)``: record bytes, the
    ``replicate.publish`` span beside ``push.diff`` in a changed tick, the
    cursor-0 pull, apply, publish→apply lag, a replica's first /tpu and
    /tpu/fleet after an apply, its registry's capture and memory, and a
    leader's /healthz and /tpu sent while a publish encodes.
    Returns the launches and the numbers."""
    from headlamp_tpu_torch.analytics import stats
    from headlamp_tpu_torch.fleet import fleet_transport, fleet_viewport
    from headlamp_tpu_torch.models.fused_forward import LAUNCHES
    from headlamp_tpu_torch.obs import slo
    from headlamp_tpu_torch.obs.trace import trace_ring
    from headlamp_tpu_torch.replicate import (
        BusConsumer,
        BusPublisher,
        LeaderElector,
        LeaseStore,
        ReplicaApp,
        generation_floor,
        parse_payload,
        pool_fetch,
    )
    from headlamp_tpu_torch.runtime.device_cache import warm_carries
    from headlamp_tpu_torch.server import DashboardApp
    from headlamp_tpu_torch.server.demo import add_demo_prometheus
    from headlamp_tpu_torch.transport import ConnectionPool

    LAUNCHES.reset()
    segments: dict[str, int] = {}

    def segment(name: str, want: int) -> None:
        torch.cuda.synchronize()
        n = LAUNCHES.n - sum(segments.values())
        segments[name] = n
        check(n == want, f"step 20's {name} launched forecast_mlp_forward {n} times, not {want}")

    out: dict[str, Any] = {}
    t_step = time.perf_counter()
    warm_carries.invalidate()
    engine = slo.SLOEngine()
    wall = [FIXED_CLOCK]
    mono = [20000.0]
    lease_mono = [0.0]
    fleet = fleet_viewport(PUSH_NODES)
    transport = fleet_transport(fleet)
    add_demo_prometheus(transport, fleet)
    store = LeaseStore(monotonic=lambda: lease_mono[0])

    def leader_app(t: Any, node_id: str) -> tuple[Any, Any, Any, Any]:
        app = DashboardApp(t, device="cuda", clock=lambda: wall[0], monotonic=lambda: mono[0],
                           min_sync_interval_s=3600.0)
        # Measured timings stay out of the history, so /tpu/trends compares.
        app.history.capture_timings = False
        pub = BusPublisher(monotonic=lambda: mono[0], wall=lambda: wall[0], ledger=app.ledger)
        app.replication = pub

        def elected(fencing: int) -> None:
            pub.set_fencing(fencing)
            app._ctx.advance_generation_floor(generation_floor(fencing))

        elector = LeaderElector(store, node_id, ttl_s=15.0, monotonic=lambda: lease_mono[0],
                                on_elected=elected, ledger=app.ledger)
        app.ensure_gateway(engine=lambda: engine)
        return app, pub, elector, app.serve("127.0.0.1", 0)

    def sync_now(app: Any, server: Any) -> None:
        """One inline sync on the leader, through a page request: without
        watch every sync re-lists, so each is a new generation."""
        app._last_sync = float("-inf")
        check(http_get(server.url + "/tpu")[0] == 200, "GET /tpu on the leader")

    def get(server: Any, path: str, headers: dict[str, str] | None = None) -> tuple:
        return _keepalive_get(int(server.url.rsplit(":", 1)[1]), path, headers=headers)

    leader, pub, elector, server = leader_app(transport, "leader-a")
    replicas: list[Any] = []
    servers: list[Any] = []
    pool = ConnectionPool()
    leader2 = server2 = None
    try:
        check(elector.tick() and elector.fencing == 1, "leader-a was not elected")
        check(http_get(server.url + "/tpu/metrics")[0] == 200, "GET /tpu/metrics on the leader")
        check(leader.snapshot_generation() == generation_floor(1) + 1,
              f"leader generation {leader.snapshot_generation()}")
        segment("leader refit", 1)
        sync_now(leader, server)  # this generation ships the forecast
        gen = leader.snapshot_generation()
        check(pub.last_generation == gen and pub.published == 2,
              f"published {pub.counters()}, generation {gen}")
        consumers = []
        for _ in range(2):
            rep = ReplicaApp(device="cuda", clock=lambda: wall[0], monotonic=lambda: mono[0])
            rep.history.capture_timings = False
            consumers.append(BusConsumer(rep, pool_fetch(server.url, pool=pool)))
            rep.ensure_gateway(engine=lambda: engine)
            replicas.append(rep)
            servers.append(rep.serve("127.0.0.1", 0))
        polls = [c.poll_once() for c in consumers]
        check(polls == [2, 2] and all(r.snapshot_generation() == gen for r in replicas),
              f"the replicas applied {polls}")
        check(replicas[0]._bus_forecast is not None
              and replicas[0]._bus_forecast.inference_path == "cuda",
              "the record shipped no forecast from the kernel")

        # Provenance: the poll trace names the publishing trace, the bus
        # serve names the poll.
        ring = trace_ring.snapshot()
        poll = next(t for t in ring if t["route"] == "/replicate/poll")
        serve = next(t for t in ring if t["route"] == "/replicate/bus")
        publishing = leader.ledger.provenance(gen)["trace_id"]
        check(any(t["trace_id"] == publishing and t["route"] == "/tpu" for t in ring)
              and poll["remote_parent"] == publishing
              and serve["remote_parent"] == poll["trace_id"],
              f"provenance: poll {poll.get('remote_parent')}, serve {serve.get('remote_parent')}, "
              f"publisher {publishing}")
        print(f"replication: poll trace {poll['trace_id']} -> remote_parent {publishing} (the "
              f"leader's /tpu that published g{gen}); bus serve {serve['trace_id']} -> "
              f"remote_parent {poll['trace_id']}")

        # Identity, page by page, over the sockets.
        pages = ("/tpu", "/tpu/nodes", "/tpu/pods", "/tpu/topology", "/tpu/metrics",
                 "/tpu/deviceplugins", "/tpu/fleet", "/tpu/trends")
        sizes = {}
        for path in pages:
            lead = get(server, path)
            check(lead[0] == 200, f"GET {path} on the leader: {lead[0]}")
            etag = lead[1].get("ETag")
            for i, rserver in enumerate(servers):
                repl = get(rserver, path)
                check(repl[0] == 200 and repl[2] == lead[2],
                      f"replica {i} {path} differs from the leader's ({repl[0]})")
                check(repl[1].get("ETag") == etag and repl[1].get("X-Headlamp-Stale") == "0",
                      f"replica {i} {path} ETag {repl[1].get('ETag')} vs {etag}")
                check(get(rserver, path, {"If-None-Match": etag})[0] == 304,
                      f"replica {i} {path}: the leader's ETag is no 304")
            sizes[path] = len(lead[2])
        segment("replica paints", 0)
        state = replicas[0]._last_snapshot.provider("tpu")
        got = state.fleet_stats()
        want = stats.python_fleet_stats(state.view)
        bad = sorted(k for k in want if got.get(k) != want[k])
        check(state.device.type == "cuda" and not bad,
              f"the replica's card rollup differs from the oracle in {bad}")
        print(f"replication: g{gen} at {PUSH_NODES} nodes: 2 replicas' {', '.join(pages)} "
              f"equal the leader's bytes ({json.dumps(sizes)}), ETags equal, the leader's ETag "
              f"a 304 on each; the replica's rollup on the card equals python_fleet_stats; "
              f"replica /tpu/metrics launched 0")

        # A fleet flip: the same /events frame on the leader and a replica.
        clients = [_SseClient(int(s.url.rsplit(":", 1)[1]), "/events")
                   for s in (server, servers[0])]
        try:
            node = _flip_ready(leader, transport, 5)
            sync_now(leader, server)
            check(consumers[0].poll_once() == 1 and consumers[1].poll_once() == 1,
                  "the flip's record did not apply")
            frames = [c.next_event() for c in clients]
        finally:
            for c in clients:
                c.close()
        check(frames[0] == frames[1] and frames[0]["event"] == "delta"
              and node in json.dumps(frames[0]["data"]),
              f"/events on the leader and the replica: {frames}")
        segment("flip", 0)
        print(f"replication: a Ready flip of {node}: the leader's and the replica's /events "
              f"read the same frame ({frames[0]['id']}, {frames[0]['bytes']} bytes)")

        # Failover on injected clocks: the leader's socket goes away.
        old_gen = leader.snapshot_generation()
        server.close()
        server = None
        mono[0] += 31.0
        check([c.poll_once() for c in consumers] == [0, 0]
              and all(c.fetch_failures == 1 for c in consumers)
              and all(r.stale() for r in replicas), "the replicas did not notice the dead leader")
        statuses = []
        for rserver in servers:
            for path in pages:
                status, headers, _, _ = get(rserver, path)
                statuses.append(status)
                check(status == 200 and headers.get("X-Headlamp-Stale") == "1",
                      f"a stale replica answered {path} with {status}, stale "
                      f"{headers.get('X-Headlamp-Stale')}")
        check(not any(s >= 500 for s in statuses), f"5xx during failover: {statuses}")
        lease_mono[0] += 16.0  # leader-a's lease lapses unrenewed
        leader2, pub2, elector2, server2 = leader_app(transport, "leader-b")
        check(elector2.tick() and elector2.fencing == 2, f"leader-b fencing {elector2.fencing}")
        check(not elector.tick() and elector.depositions == 1, "leader-a was not deposed")
        sync_now(leader2, server2)
        new_gen = leader2.snapshot_generation()
        check(new_gen == generation_floor(2) + 1, f"leader-b generation {new_gen}")
        check(not pub2.publish(leader._last_snapshot, generation=old_gen + 1)
              and pub2.rejected_stale == 1, "an old-band publish was accepted")
        for c in consumers:
            c._fetch = pool_fetch(server2.url, pool=pool)
        check([c.poll_once() for c in consumers] == [1, 1]
              and all(r.snapshot_generation() == new_gen and not r.stale() for r in replicas),
              "the replicas did not converge on leader-b")
        for rserver in servers:
            status, headers, body, _ = get(rserver, "/tpu")
            check(status == 200 and headers.get("X-Headlamp-Stale") == "0"
                  and headers.get("X-Headlamp-Generation") == str(new_gen)
                  and body == get(server2, "/tpu")[2], f"a converged replica: {status} {headers}")
        # leader-a's next generation sits in the lower band: fenced out.
        _, records = parse_payload(pub.payload_after(None))
        stale_record = dict(records[-1], generation=old_gen + 1)
        check(not replicas[0].apply_record(stale_record) and replicas[0].rejected_stale == 1,
              "a replica applied a deposed leader's record")
        segment("failover", 0)
        print(f"replication: failover: leader-a closed, {len(statuses)} stale paints on 2 "
              f"replicas (X-Headlamp-Stale 1, 0 5xx); leader-b elected at fencing 2, generation "
              f"{new_gen}; an old-band publish rejected_stale; both replicas converged, stale 0")

        # The real entry point, as a process of its own.
        out.update(_replica_entry_point(server2.url, leader2, wall))
        segment("entry point", 0)
    finally:
        for s in servers:
            s.close()
        for s in (server, server2):
            if s is not None:
                s.close()
        pool.close()

    # Full width.
    out.update(_replication_at_width(torch, smi))
    segment("full width", 0)
    launches = LAUNCHES.n
    check(launches == sum(segments.values()) == REPLICATION_LAUNCHES,
          f"step 20 launched {launches} ({segments}), not {REPLICATION_LAUNCHES}")
    out["seconds"] = time.perf_counter() - t_step
    print(f"replication: step 20 launched forecast_mlp_forward {launches} times, by segment "
          f"{json.dumps(segments)}; took {out['seconds']:.1f} s")
    return launches, out


def _replication_at_width(torch: Any, smi: str) -> dict[str, Any]:
    """Step 20b at ``fleet_viewport(16384)``, on real clocks, under a fresh
    program registry: a replica's ``serve()`` captures its startup set
    (capture ms, card memory); a leader with background sync publishes
    its hydrating tick and two changed ticks; the replica catches up with
    a cursor-0 pull and applies each record; its first /tpu and /tpu/fleet
    after the apply pay the encode and the upload; then a consumer thread
    every LIVE_INTERVAL_S and LIVE_CHANGED_TICKS more changed ticks, each
    with its ``replicate.publish`` and ``push.diff`` spans and the applied
    stamp's lag from the publish; last, the leader's paints during one
    more changed tick's publish. Each changed tick publishes the full
    snapshot; the records ship no metrics (no /tpu/metrics at this size)."""
    from headlamp_tpu_torch.fleet import fleet_transport, fleet_viewport
    from headlamp_tpu_torch.models import aot
    from headlamp_tpu_torch.obs import graphcost, slo
    from headlamp_tpu_torch.replicate import (
        BusConsumer,
        BusPublisher,
        ReplicaApp,
        parse_payload,
        pool_fetch,
    )
    from headlamp_tpu_torch.server import DashboardApp
    from headlamp_tpu_torch.transport import ConnectionPool

    n = LIVE_NODES[-1]
    engine = slo.SLOEngine()
    out: dict[str, Any] = {"nodes": n}
    pool = ConnectionPool()
    server = rserver = None
    with _Registry(aot.AotProgramRegistry(), graphcost.GraphCostLedger()) as reg:
        try:
            # The replica first, so nothing else runs on the card while its
            # registry captures.
            torch.cuda.synchronize()
            mem0 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
            replica = ReplicaApp(device="cuda")
            replica.ensure_gateway(engine=lambda: engine)
            t0 = time.perf_counter()
            rserver = replica.serve("127.0.0.1", 0)
            check(reg.wait_ready(600.0), "the replica's registry capture did not finish")
            ready_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            mem1 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
            snap = reg.snapshot()
            check(snap["compile_errors"] == 0 and snap["state"] == "ready",
                  f"the replica's registry: {snap}")
            out.update(registry_capture_ms=snap["compile_ms_total"], registry_ready_s=ready_s,
                       registry_allocated_bytes=mem1[0] - mem0[0],
                       registry_reserved_bytes=mem1[1] - mem0[1],
                       registry_programs=snap["programs_compiled"])
            print(f"replication: a replica's serve() captured {snap['programs_compiled']} "
                  f"programs in {snap['compile_ms_total']} ms (ready {ready_s:.2f} s after "
                  f"serve()); card memory +{(mem1[0] - mem0[0]) / 2**20:.1f} MiB allocated, "
                  f"+{(mem1[1] - mem0[1]) / 2**20:.1f} MiB reserved; on {smi}")

            transport = fleet_transport(fleet_viewport(n))
            leader = DashboardApp(transport, device="cuda", min_sync_interval_s=3600.0)
            pub = BusPublisher(ledger=leader.ledger)
            leader.replication = pub
            leader.ensure_gateway(engine=lambda: engine)
            ticks = record_ticks(leader)
            server = leader.serve("127.0.0.1", 0)

            def publishing_tick(gen: int) -> dict[str, Any]:
                """The first tick whose publish span carries ``gen``: the
                changed tick (later quiet ticks offer the same generation
                and are rejected as stale)."""
                def found() -> dict[str, Any] | None:
                    for t in list(ticks):
                        for s in t["spans"]:
                            if s["name"] == "replicate.publish" and s["attrs"].get(
                                    "generation") == gen:
                                return t
                    return None

                _wait_for(lambda: found() is not None, f"the tick that published g{gen}")
                return found()

            leader.start_background_sync(LIVE_INTERVAL_S)
            _wait_for(lambda: pub.published >= 1, "the hydrating tick's publish")
            changed = []
            for i in range(2):
                published = pub.published
                _flip_ready(leader, transport, 100 + i)
                leader._background_wake.set()
                _wait_for(lambda: pub.published == published + 1, "a changed tick's publish")
                changed.append(publishing_tick(pub.last_generation))
            record_bytes = [len(line) for _, line in pub._backlog]

            # The cursor-0 catch-up pull, then each record's apply.
            fetch = pool_fetch(server.url, pool=pool, timeout_s=120.0)
            t0 = time.perf_counter()
            payload = fetch(0)
            pull_ms = (time.perf_counter() - t0) * 1e3
            _, records = parse_payload(payload)
            apply_ms = []
            for record in records:
                t0 = time.perf_counter()
                check(replica.apply_record(record), f"g{record['generation']} did not apply")
                apply_ms.append((time.perf_counter() - t0) * 1e3)
            check(replica.snapshot_generation() == pub.last_generation,
                  "the catch-up left the replica behind")
            rport = int(rserver.url.rsplit(":", 1)[1])
            first: dict[str, list[float]] = {}
            for path in ("/tpu", "/tpu/fleet", "/tpu", "/tpu/fleet"):
                status, _, _, ms = _keepalive_get(rport, path)
                check(status == 200, f"replica GET {path} at {n} nodes: {status}")
                first.setdefault(path, []).append(ms)
            out.update(record_bytes=record_bytes, pull_bytes=len(payload), pull_ms=pull_ms,
                       pull_records=len(records), apply_ms=apply_ms, first_paint_ms=first)
            print(f"replication: {n} nodes, record bytes {record_bytes}; cursor-0 pull of "
                  f"{len(records)} records, {len(payload)} bytes in {pull_ms:.1f} ms; apply ms "
                  f"{[round(x, 1) for x in apply_ms]}; replica /tpu first {first['/tpu'][0]:.1f} "
                  f"ms then {first['/tpu'][1]:.1f}, /tpu/fleet first "
                  f"{first['/tpu/fleet'][0]:.1f} ms then {first['/tpu/fleet'][1]:.1f}")

            # Publish -> apply lag, with the consumer on its thread.
            consumer = BusConsumer(replica, fetch, interval_s=LIVE_INTERVAL_S)
            consumer.cursor = replica.snapshot_generation()
            consumer.start()
            lags = []
            for i in range(LIVE_CHANGED_TICKS):
                target = replica.snapshot_generation() + 1
                _flip_ready(leader, transport, 200 + i)
                leader._background_wake.set()

                def applied() -> dict[str, Any] | None:
                    # The snapshot flips before the ledger's stamp: wait on the stamp.
                    return next((g for g in replica.ledger.snapshot()["generations"]
                                 if g["generation"] == target and "applied" in g["stages"]), None)

                _wait_for(lambda: applied() is not None, f"the replica's apply of g{target}")
                changed.append(publishing_tick(target))
                lags.append(applied()["stages"]["applied"]["lag_ms"])
            consumer.stop()
            check(consumer.errors == 0 and consumer.fetch_failures == 0,
                  f"the consumer thread: {consumer.snapshot()}")
            tick_rows = [{"tick_ms": t["duration_ms"],
                          "push_diff_ms": span_totals(t)["push.diff"],
                          "publish_ms": span_totals(t)["replicate.publish"]} for t in changed]
            out.update(changed_ticks=tick_rows, publish_to_apply_ms=lags)
            print(f"replication: changed ticks at {n} nodes (tick, push.diff, "
                  f"replicate.publish ms, publish share): "
                  + "; ".join(f"{r['tick_ms']:.1f}, {r['push_diff_ms']:.1f}, "
                              f"{r['publish_ms']:.1f}, {r['publish_ms'] / r['tick_ms']:.3f}"
                              for r in tick_rows)
                  + f"; publish->apply lag ms {lags} (consumer every {LIVE_INTERVAL_S} s); "
                  f"on {smi}")
            out["leader_paints_during_publish"] = _leader_paints_during_publish(
                leader, transport, pub, int(server.url.rsplit(":", 1)[1]), smi)
        finally:
            if rserver is not None:
                rserver.close()
            if server is not None:
                server.close()
            pool.close()
    return out


#: A client in a process of its own: it GETs each path in a loop on a
#: keep-alive connection for argv[2] seconds and prints
#: [path, status, start, end] rows on the system-wide monotonic clock. A
#: thread of the server's process could not send while a publish holds
#: the interpreter.
_LOOP_CLIENT = """
import http.client, json, sys, threading, time
port, seconds, paths = int(sys.argv[1]), float(sys.argv[2]), sys.argv[3:]
rows = []
def loop(path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        t0 = time.monotonic()
        conn.request("GET", path)
        resp = conn.getresponse()
        resp.read()
        rows.append([path, resp.status, t0, time.monotonic()])
threads = [threading.Thread(target=loop, args=(p,)) for p in paths]
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps(rows))
"""


def _leader_paints_during_publish(leader: Any, transport: Any, pub: Any, port: int,
                                  smi: str) -> dict[str, Any]:
    """A leader's /healthz and /tpu while a changed tick's publish encodes
    its record (the bus lock is held for the whole encode), from a client
    process that loops on both paths: the requests finished before the
    flip are the quiet ones, those that overlap the publish are timed
    beside it. Quiet ticks' publishes, rejected as stale, are not
    timed."""
    paths = ("/healthz", "/tpu")
    window: dict[str, float] = {}
    real_publish = pub.publish

    def timed_publish(snap: Any, *, generation: int, **kwargs: Any) -> bool:
        if "t0" in window or int(generation) <= pub.last_generation:
            return real_publish(snap, generation=generation, **kwargs)
        window["t0"] = time.monotonic()
        try:
            return real_publish(snap, generation=generation, **kwargs)
        finally:
            window["t1"] = time.monotonic()

    proc = subprocess.Popen([sys.executable, "-c", _LOOP_CLIENT, str(port), "10.0", *paths],
                            stdout=subprocess.PIPE, text=True)
    pub.publish = timed_publish
    try:
        time.sleep(2.0)
        flip = time.monotonic()
        published = pub.published
        _flip_ready(leader, transport, 300)
        leader._background_wake.set()
        _wait_for(lambda: pub.published == published + 1, "the measured tick's publish")
        stdout, _ = proc.communicate(timeout=120)
    finally:
        pub.publish = real_publish
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"the loop client exited {proc.returncode}")
    rows = json.loads(stdout)
    check(all(status == 200 for _, status, _, _ in rows), "a leader GET during publish failed")
    t0, t1 = window["t0"], window["t1"]
    out: dict[str, Any] = {"publish_ms": (t1 - t0) * 1e3}
    for path in paths:
        mine = [(a, b) for p, _, a, b in rows if p == path]
        quiet = [(b - a) * 1e3 for a, b in mine if b < flip]
        during = [(b - a) * 1e3 for a, b in mine if a < t1 and b > t0]
        check(quiet and during, f"no {path} request before the flip or during the publish")
        out[path] = {"quiet_p50_ms": statistics.median(quiet), "during_ms": during}
    print(f"replication: leader paints from a client process during a publish of "
          f"{out['publish_ms']:.1f} ms (quiet p50, then each request that overlapped it): "
          + "; ".join(f"{p} {out[p]['quiet_p50_ms']:.1f}, "
                      f"{[round(x, 1) for x in out[p]['during_ms']]}" for p in paths)
          + f"; on {smi}")
    return out


def re_cursor(body: str) -> str:
    """The next-window cursor a windowed page links to."""
    found = re.search(r'cursor=([A-Za-z0-9_-]+)" class="hl-res-link hl-cursor-next"', body)
    if found is None:
        raise SmokeFailure("the windowed page links no next window")
    return found.group(1)


def _card_memory_used_mib() -> int:
    """The card's memory in use, all processes, by ``nvidia-smi``."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits",
                          "--id=0"], capture_output=True, text=True, timeout=30, check=True)
    return int(out.stdout.strip())


def _newest_trace(route: str) -> dict[str, Any]:
    from headlamp_tpu_torch.obs.trace import trace_ring

    found = next((t for t in trace_ring.snapshot() if t["route"] == route), None)  # newest first
    check(found is not None, f"no {route} trace in the ring")
    return found


def _span_names(spans: list[dict[str, Any]]) -> set[str]:
    return {s["name"] for s in spans} | {n for s in spans for n in _span_names(s["children"])}


def workers_phase(torch: Any, smi: str) -> tuple[int, dict[str, Any]]:
    """Step 21: multi-process serving on the card. (a) In process at
    ``fleet_viewport(16384)``: a leader publishing through a
    ``SegmentBusPublisher`` into a segment in /dev/shm, two ``ReplicaApp``
    workers on the card fed by ``ShmConsumer``, and a bus-fed replica
    (step 20's path) beside them. The workers' eight pages, ETags, 304s and
    a flip's ``/events`` frame equal the leader's; each apply seeds both
    providers' columns (TPU and Intel); a worker's first ``/tpu`` after an apply opens no
    ``device_cache.upload`` span and uploads nothing. Printed: the publish
    (bus encode, second ``encode_fleet`` and map write), each worker's
    read, apply and seed, and the first ``/tpu`` and ``/tpu/fleet`` of a
    worker beside the bus replica's. (b) As processes: ``python -m
    headlamp_tpu_torch.server --demo large --workers N`` for N = 2, then 1:
    both workers live on the card, one ETag over six GETs, each worker's
    pid, card memory and registry, and the saturation curve at 32 clients.
    Nothing about scaling is asserted. Returns the launches (this process
    only: the supervisors' fits are theirs) and the numbers."""
    from headlamp_tpu_torch.models.fused_forward import LAUNCHES

    LAUNCHES.reset()
    segments: dict[str, int] = {}

    def segment(name: str, want: int) -> None:
        torch.cuda.synchronize()
        n = LAUNCHES.n - sum(segments.values())
        segments[name] = n
        check(n == want, f"step 21's {name} launched forecast_mlp_forward {n} times, not {want}")

    t_step = time.perf_counter()
    out = _workers_in_process(torch, smi, segment)
    out["processes"] = _workers_as_processes(smi)
    segment("processes", 0)
    launches = LAUNCHES.n
    check(launches == sum(segments.values()) == WORKERS_LAUNCHES,
          f"step 21 launched {launches} ({segments}), not {WORKERS_LAUNCHES}")
    out["seconds"] = time.perf_counter() - t_step
    print(f"workers: step 21 launched forecast_mlp_forward {launches} times, by segment "
          f"{json.dumps(segments)}; took {out['seconds']:.1f} s")
    return launches, out


def _workers_in_process(torch: Any, smi: str, segment: Callable[[str, int], None]
                        ) -> dict[str, Any]:
    """Step 21a; see :func:`workers_phase`."""
    import tempfile

    from headlamp_tpu_torch.fleet import fleet_transport, fleet_viewport
    from headlamp_tpu_torch.models import aot
    from headlamp_tpu_torch.obs import slo
    from headlamp_tpu_torch.obs.trace import trace_request
    from headlamp_tpu_torch.replicate import BusConsumer, ReplicaApp, pool_fetch
    from headlamp_tpu_torch.runtime.device_cache import warm_carries
    from headlamp_tpu_torch.server import DashboardApp
    from headlamp_tpu_torch.server.demo import add_demo_prometheus
    from headlamp_tpu_torch.transport import ConnectionPool
    from headlamp_tpu_torch.workers import SegmentBusPublisher, ShmConsumer, SnapshotSegment

    n = WORKERS_NODES
    warm_carries.invalidate()
    engine = slo.SLOEngine()
    wall = lambda: FIXED_CLOCK  # noqa: E731
    mono = lambda: 30000.0  # noqa: E731
    fleet = fleet_viewport(n)
    transport = fleet_transport(fleet)
    add_demo_prometheus(transport, fleet)
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()
    seg = SnapshotSegment(os.path.join(shm, f"headlamp-torch-smoke-{os.getpid()}.seg"))
    leader = DashboardApp(transport, device="cuda", clock=wall, monotonic=mono,
                          min_sync_interval_s=3600.0)
    leader.history.capture_timings = False
    pub = SegmentBusPublisher(seg, monotonic=mono, wall=wall, ledger=leader.ledger)
    leader.replication = pub
    leader.ensure_gateway(engine=lambda: engine)
    pool = ConnectionPool()
    apps: list[Any] = []
    servers: list[Any] = []
    out: dict[str, Any] = {"nodes": n, "segment_path": seg.path}

    def replica() -> Any:
        rep = ReplicaApp(device="cuda", clock=wall, monotonic=mono)
        rep.history.capture_timings = False
        rep.ensure_gateway(engine=lambda: engine)
        apps.append(rep)
        return rep

    def port_of(server: Any) -> int:
        return int(server.url.rsplit(":", 1)[1])

    publishes: list[dict[str, float]] = []

    def publish() -> int:
        """One inline sync on the leader, traced: without watch every sync
        re-lists, so each is a new generation, published to the bus and
        mirrored into the segment."""
        leader._last_sync = float("-inf")
        with trace_request("/smoke/sync", wall=wall) as trace:
            leader._synced_snapshot()
        totals = span_totals(trace.to_dict())
        publishes.append({"publish_ms": totals["replicate.publish"],
                          "segment_ms": totals["workers.segment"],
                          "push_diff_ms": totals["push.diff"]})
        check(pub.segment_publishes == len(publishes) and pub.segment_failures == 0,
              f"the segment mirror: {pub.snapshot()}")
        return leader.snapshot_generation()

    polls: list[list[dict[str, float]]] = []

    def poll_workers(gen: int) -> None:
        rows = []
        for i, (rep, consumer) in enumerate(zip(workers, consumers)):
            seeds = rep._ctx.fleet_cache.seeds
            check(consumer.poll_once() == 1 and rep.snapshot_generation() == gen,
                  f"worker {i} did not apply g{gen} off the segment: {consumer.snapshot()}")
            totals = span_totals(_newest_trace("/workers/poll"))
            providers = len(rep._last_snapshot.providers)
            check(rep._ctx.fleet_cache.seeds - seeds == providers == 2
                  and consumer.seed_errors == 0 and consumer.applied_fallback == 0,
                  f"worker {i} seeded {rep._ctx.fleet_cache.seeds - seeds} of {providers}")
            rows.append({"read_ms": totals["workers.read"], "apply_ms": totals["replicate.apply"],
                         "seed_ms": totals["device_cache.seed"]})
        polls.append(rows)

    try:
        lserver = leader.serve("127.0.0.1", 0)
        servers.append(lserver)
        # Process-wide state the first paints below must not pay for: the
        # registry's startup set (ready since step 9 in a whole run).
        check(aot.registry().wait_ready(600.0), "the program registry never became ready")
        workers = [replica() for _ in range(2)]
        consumers = [ShmConsumer(rep, seg.path) for rep in workers]
        bus_rep = replica()
        bus_consumer = BusConsumer(bus_rep, pool_fetch(lserver.url, pool=pool, timeout_s=120.0))
        servers += [rep.serve("127.0.0.1", 0) for rep in workers + [bus_rep]]
        lport, w0port, w1port, bport = (port_of(s) for s in servers)

        poll_workers(publish())
        status = _keepalive_get(lport, "/tpu/metrics")[0]
        check(status == 200, f"GET /tpu/metrics on the leader: {status}")
        segment("leader refit", 1)
        gen = publish()  # this generation ships the forecast
        poll_workers(gen)
        t0 = time.perf_counter()
        check(bus_consumer.poll_once() == 2 and bus_rep.snapshot_generation() == gen,
              "the bus replica did not catch up")
        bus_pull_apply_ms = (time.perf_counter() - t0) * 1e3

        # The leader paints first, so the rollup's calibration at this size
        # is paid before the paints compared below.
        for path in ("/tpu", "/tpu/fleet"):
            check(_keepalive_get(lport, path)[0] == 200, f"GET {path} on the leader")
        # First paints after the apply, a worker on each side of the bus
        # replica: the workers' columns are seeded, the replica encodes.
        first: dict[str, dict[str, list[float]]] = {}
        first_spans: dict[str, dict[str, float]] = {}
        for label, rep, port in (("w0", workers[0], w0port), ("bus_replica", bus_rep, bport),
                                 ("w1", workers[1], w1port)):
            uploads = rep._ctx.fleet_cache.uploads
            first[label] = {}
            for path in ("/tpu", "/tpu/fleet", "/tpu", "/tpu/fleet"):
                status, _, _, ms = _keepalive_get(port, path)
                check(status == 200, f"{label} GET {path} at {n} nodes: {status}")
                first[label].setdefault(path, []).append(ms)
                if len(first[label][path]) == 1 and path == "/tpu":
                    trace = _newest_trace("/tpu")
                    first_spans[label] = {k: v for k, v in span_totals(trace).items() if k in (
                        "sync.snapshot", "page.component", "analytics.rollup",
                        "device_cache.upload", "render.html")}
                    names = _span_names(trace["spans"])
                    check(label == "bus_replica" or "device_cache.upload" not in names,
                          f"{label}'s first /tpu after an apply: spans {sorted(names)}")
            paid = rep._ctx.fleet_cache.uploads - uploads
            check(paid == (1 if label == "bus_replica" else 0),
                  f"{label}'s first paints uploaded {paid} times")
        out.update(publishes=publishes, worker_polls=polls, bus_pull_apply_ms=bus_pull_apply_ms,
                   first_paint_ms=first, first_tpu_spans_ms=first_spans)
        for i, row in enumerate(publishes):
            print(f"workers: {n} nodes, publish {i + 1}: replicate.publish {row['publish_ms']:.1f} "
                  f"ms, of which workers.segment (the second encode_fleet and the map write) "
                  f"{row['segment_ms']:.1f}, bus encode {row['publish_ms'] - row['segment_ms']:.1f}"
                  f"; push.diff {row['push_diff_ms']:.1f}")
        for i, rows in enumerate(polls):
            print(f"workers: {n} nodes, apply {i + 1} off the segment (read, apply, seed ms): "
                  + "; ".join(f"w{j} {r['read_ms']:.1f}, {r['apply_ms']:.1f}, {r['seed_ms']:.1f}"
                              for j, r in enumerate(rows)))
        for label, paints in first.items():
            kind = ("bus replica (1 upload; its cursor-0 pull and two applies "
                    f"{bus_pull_apply_ms:.1f} ms)" if label == "bus_replica"
                    else f"worker {label} (0 uploads, no device_cache.upload span)")
            print(f"workers: {n} nodes, after the apply, {kind}: /tpu first "
                  f"{paints['/tpu'][0]:.1f} ms then {paints['/tpu'][1]:.1f}, /tpu/fleet first "
                  f"{paints['/tpu/fleet'][0]:.1f} then {paints['/tpu/fleet'][1]:.1f}; the first "
                  f"/tpu's spans " + ", ".join(f"{k} {v:.1f}" for k, v in
                                               first_spans[label].items()) + f"; on {smi}")

        # Identity, page by page, over the sockets.
        pages = ("/tpu", "/tpu/nodes", "/tpu/pods", "/tpu/topology", "/tpu/metrics",
                 "/tpu/deviceplugins", "/tpu/fleet", "/tpu/trends")
        for path in pages:
            lead = _keepalive_get(lport, path)
            check(lead[0] == 200, f"GET {path} on the leader: {lead[0]}")
            etag = lead[1].get("ETag")
            for i, port in enumerate((w0port, w1port)):
                got = _keepalive_get(port, path)
                check(got[0] == 200 and got[2] == lead[2] and got[1].get("ETag") == etag,
                      f"worker {i} {path} differs from the leader's ({got[0]})")
                check(_keepalive_get(port, path, headers={"If-None-Match": etag})[0] == 304,
                      f"worker {i} {path}: the leader's ETag is no 304")
        check("Utilization Forecast" in _keepalive_get(w0port, "/tpu/metrics")[2].decode(),
              "the worker's metrics page has no forecast")

        # A fleet flip: the same /events frame on the leader and both workers.
        clients = [_SseClient(port, "/events") for port in (lport, w0port, w1port)]
        try:
            node = _flip_ready(leader, transport, 7)
            poll_workers(publish())
            frames = [c.next_event() for c in clients]
        finally:
            for c in clients:
                c.close()
        check(all(f == frames[0] for f in frames) and frames[0]["event"] == "delta"
              and node in json.dumps(frames[0]["data"]),
              f"/events on the leader and the workers: {frames}")
        segment("workers", 0)
        print(f"workers: g{gen} at {n} nodes: 2 segment-fed workers' {', '.join(pages)} equal "
              f"the leader's bytes, ETags equal, the leader's ETag a 304 on each; a Ready flip "
              f"of {node} is one frame on all three ({frames[0]['id']}, {frames[0]['bytes']} "
              f"bytes); the workers launched 0")
    finally:
        closed = set()
        for server in servers:
            server.close()  # closes its app too
            closed.add(id(server.app))
        for app in [leader] + apps:
            if id(app) not in closed:
                app.close()
        pool.close()
        seg.close()
        seg.unlink()
    return out


def _workers_as_processes(smi: str) -> dict[str, Any]:
    """Step 21b; see :func:`workers_phase`. Each supervisor is its own
    session, stopped with SIGINT and joined (a kill of its process group
    if it outlives 120 s, which fails the step)."""
    import tempfile

    out: dict[str, Any] = {}
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for n in WORKERS_COUNTS:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        log = tempfile.TemporaryFile()
        used_before = _card_memory_used_mib()
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "headlamp_tpu_torch.server", "--demo", "large", "--workers",
             str(n), "--port", str(port)],
            cwd=str(ROOT), env=env, stdout=log, stderr=subprocess.STDOUT, start_new_session=True,
        )
        row: dict[str, Any] = {}
        try:
            ready: dict[str, tuple[dict[str, Any], float]] = {}
            health: dict[str, Any] = {}
            deadline = time.monotonic() + 240.0
            while True:
                if proc.poll() is not None:
                    log.seek(0)
                    raise SmokeFailure(f"--workers {n} exited {proc.returncode}: "
                                       f"{log.read()[-3000:].decode(errors='replace')}")
                check(time.monotonic() < deadline, f"--workers {n} never became ready: {health}")
                try:
                    _, _, body, _ = _keepalive_get(port, "/healthz")
                except OSError:
                    time.sleep(0.2)
                    continue
                health = json.loads(body)
                runtime = health["runtime"]
                board = runtime.get("workers") or {}
                repl = runtime.get("replication") or {}
                if (board.get("live") == n and repl.get("role") == "worker"
                        and repl.get("applied", 0) >= 1 and runtime["aot"]["state"] == "ready"):
                    ready.setdefault(board["self"], (health, time.perf_counter() - t0))
                gens = {r["generation"] for r in board.get("workers", [])}
                if len(ready) == n and len(gens) == 1 and 0 not in gens:
                    break
                time.sleep(0.2)
            etags, generations = set(), set()
            for _ in range(6):
                status, headers, _, _ = _keepalive_get(port, "/tpu")
                check(status == 200, f"--workers {n} GET /tpu: {status}")
                etags.add(headers.get("ETag"))
                generations.add(headers.get("X-Headlamp-Generation"))
            check(len(etags) == 1 and len(generations) == 1,
                  f"--workers {n}: six /tpu GETs carried {etags}, generations {generations}")
            # Inside a container nvidia-smi's per-process query can come
            # back empty: the card's total and each allocator's share
            # stand in.
            used_delta = _card_memory_used_mib() - used_before
            workers = []
            for label in sorted(ready):
                h, ready_s = ready[label]
                me = next(r for r in h["runtime"]["workers"]["workers"]
                          if f"w{r['worker']}" == label)
                device = h["runtime"]["device"]
                check(h["ok"] is True and device["torch_device"].startswith("cuda")
                      and h["runtime"]["replication"]["seed_errors"] == 0
                      and h["runtime"]["aot"]["compile_errors"] == 0,
                      f"--workers {n} {label}: ok {h['ok']}, {device}")
                workers.append({
                    "worker": label, "pid": me["pid"], "ready_s": ready_s,
                    "registry_capture_ms": h["runtime"]["aot"]["compile_ms_total"],
                    "reserved_mib": device["memory_reserved_bytes"] / 2**20,
                    "seeds": h["runtime"]["replication"]["seeds"],
                })
            for w in workers:
                print(f"workers: --workers {n} {w['worker']} pid {w['pid']}: ready (registry "
                      f"captured in {w['registry_capture_ms']} ms, a record applied and seeded) "
                      f"{w['ready_s']:.2f} s after the supervisor started; {w['reserved_mib']:.1f} MiB "
                      f"reserved by its allocator on the card")
            print(f"workers: --workers {n}: the supervisor (pid {proc.pid}) and its workers "
                  f"took {used_delta} MiB of the card (nvidia-smi memory.used, before and "
                  f"after); six /tpu GETs, one ETag {etags.pop()}")
            for i in range(4 * n):
                check(_keepalive_get(port, f"/tpu?warm={i}")[0] == 200, "a warm-up GET")
            curve = _saturation_curve(port, WORKERS_CONCURRENCY, path="/tpu")
            row.update(workers=workers, curve=curve, card_memory_mib=used_delta)
            print(f"workers: --workers {n} at {WORKERS_CONCURRENCY[-1]} clients on /tpu: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in curve.items()) + f"; on {smi}")
        finally:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            log.seek(0)
            tail = log.read()[-3000:].decode(errors="replace")
            log.close()
        check(proc.returncode == 0, f"--workers {n} exited {proc.returncode}: {tail}")
        out[f"w{n}"] = row
    c = WORKERS_CONCURRENCY[-1]
    ratio = out["w2"]["curve"][f"agg_rps_c{c}"] / out["w1"]["curve"][f"agg_rps_c{c}"]
    out["scaling_2v1"] = ratio
    print(f"workers: aggregate rps at {c} clients, --workers 2 over --workers 1: {ratio:.3f} "
          f"(recorded, not asserted: without MPS the workers' kernels time-slice the card)")
    return out


def _header_get(port: int, path: str) -> tuple[int, dict[str, str], str]:
    """(status, headers, body) of one GET over a fresh connection."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read().decode()
        return resp.status, dict(resp.getheaders()), body
    finally:
        conn.close()


def scenarios_phase(torch: Any, smi: str) -> tuple[int, dict[str, Any]]:
    """Step 22: the incident drills on the card. (a) The matrix: each drill
    of ``SCENARIO_NAMES`` run twice with ``device="cuda"`` and once with
    ``device="cpu"`` in this process; both card runs pass with no 5xx,
    their transcripts are byte-identical to each other and to the CPU
    run's, and so are the events, counters and response metrics; the
    metrics-bearing drills infer through the kernel (dispatch ``cuda`` or
    ``cuda-warm``, never ``torch``), each card run launches it once per
    inference, its cold fits are ``SCENARIO_COLD_FITS[name]`` as on the
    CPU, and it refits warm when the CPU run does; the read-tier drill
    launches 0. (b) The live host at
    ``--demo large`` behind its gateway over a socket: before any drill no
    ``runtime.scenarios`` and an empty ``/debug/incidentz``; a process SLO
    engine on a scripted clock of its own fed breaching latencies until
    the policy pages, then a shed ``/debug/traces``, a degraded
    ``/tpu/metrics`` with 0 launches and a debug stream evicted (the
    incident surfaces, debug routes, are shed too); fed good ones until it
    restores, one fresh ``/tpu/metrics`` with 1 launch, and the timeline
    reads paging, shed, degrade, eviction and restore in that order; then the ring
    filled, ``mark()`` timed and both incident surfaces' paint p50s.
    Returns the launches and the numbers."""
    from headlamp_tpu_torch.models.fused_forward import LAUNCHES

    t_step = time.perf_counter()
    LAUNCHES.reset()
    out: dict[str, Any] = {"matrix": _scenario_matrix(torch, smi)}
    matrix_launches = LAUNCHES.n
    want = out["matrix"]["warmup_launches"] + sum(
        sum(row["launches"]) for row in out["matrix"]["drills"])
    check(matrix_launches == want,
          f"the drill matrix launched {matrix_launches} times, its runs {want}")
    LAUNCHES.reset()
    out["live"] = _scenario_live_host(torch, smi)
    torch.cuda.synchronize()
    live_launches = LAUNCHES.n
    check(live_launches == SCENARIO_LIVE_LAUNCHES,
          f"the live incident host launched {live_launches} times, not {SCENARIO_LIVE_LAUNCHES}")
    launches = matrix_launches + live_launches
    out["seconds"] = time.perf_counter() - t_step
    print(f"scenarios: step 22 launched forecast_mlp_forward {launches} times (matrix "
          f"{matrix_launches}, live host {live_launches}); took {out['seconds']:.1f} s")
    return launches, out


def _scenario_matrix(torch: Any, smi: str) -> dict[str, Any]:
    """Step 22a; see :func:`scenarios_phase`. The matrix starts after one
    discarded run of the first drill on each device. The inferences are counted
    where every forecast view is built (``service._summarize``, by its
    dispatch path), and the engine's real request durations are read off
    the request histogram's observers; both hooks only count."""
    from headlamp_tpu_torch.models import service
    from headlamp_tpu_torch.models.fused_forward import LAUNCHES
    from headlamp_tpu_torch.obs import slo
    from headlamp_tpu_torch.obs.metrics import registry
    from headlamp_tpu_torch.scenarios import SCENARIO_NAMES, ScenarioRunner, get_scenario

    inferences: dict[str, int] = {}
    durations: list[float] = []
    listening = [False]
    summarize = service._summarize

    def counted(history: Any, cfg: Any, preds: Any, dispatch: Any, *rest: Any) -> Any:
        inferences[dispatch.path] = inferences.get(dispatch.path, 0) + 1
        return summarize(history, cfg, preds, dispatch, *rest)

    def observe(value: float, labels: Any) -> None:
        if listening[0]:
            durations.append(value)

    registry.histogram(slo.REQUEST_DURATION, slo.REQUEST_DURATION_HELP,
                       labels=("route",)).add_observer(observe)
    rows = []
    service._summarize = counted
    listening[0] = True
    try:
        # Real request durations feed each drill's scripted-clock engine,
        # so a first fit that pays one-time costs (the CPU path's first
        # use in this process) could page a drill: one discarded run per
        # device first.
        warmup_launches = 0
        for device in ("cuda", "cpu"):
            durations.clear()
            before = LAUNCHES.n
            t0 = time.perf_counter()
            report = ScenarioRunner(get_scenario(SCENARIO_WARMUP), device=device).run()
            torch.cuda.synchronize()
            warmup_launches += LAUNCHES.n - before
            print(f"scenarios: warm-up {SCENARIO_WARMUP} on {device}: passed "
                  f"{report.passed}, {(time.perf_counter() - t0) * 1e3:.1f} ms, largest request "
                  f"{max(durations, default=0.0) * 1e3:.1f} ms (discarded)")
        for name in SCENARIO_NAMES:
            runs = []
            for device in ("cuda", "cuda", "cpu"):
                inferences.clear()
                durations.clear()
                before = LAUNCHES.n
                t0 = time.perf_counter()
                report = ScenarioRunner(get_scenario(name), device=device).run()
                if device == "cuda":
                    torch.cuda.synchronize()
                runs.append(dict(
                    device=device, report=report, ms=(time.perf_counter() - t0) * 1e3,
                    launches=LAUNCHES.n - before, inferences=dict(inferences),
                    max_request_ms=max(durations, default=0.0) * 1e3,
                ))
            card, again, cpu = runs
            for run in runs:
                check(run["report"].passed and run["report"].counters["non_shed_5xx"] == 0,
                      f"{name} on {run['device']}: {[str(f) for f in run['report'].failures]}, "
                      f"counters {run['report'].counters}, largest request "
                      f"{run['max_request_ms']:.1f} ms")
            check(card["report"].transcript == again["report"].transcript,
                  f"{name}: the two card transcripts differ")
            for run in (card, again):
                got, want = run["report"], cpu["report"]
                check(got.transcript == want.transcript,
                      f"{name}: the card transcript differs from the CPU's (largest request "
                      f"{run['max_request_ms']:.1f} ms on the card, {cpu['max_request_ms']:.1f} "
                      f"on the CPU)")
                check(json.dumps(got.events, sort_keys=True)
                      == json.dumps(want.events, sort_keys=True),
                      f"{name}: the card's timeline events differ from the CPU's")
                check(got.counters == want.counters and got.metrics == want.metrics,
                      f"{name}: counters {got.counters} / {want.counters}, metrics "
                      f"{got.metrics} / {want.metrics}")
                paths, on_cpu = run["inferences"], cpu["inferences"]
                check(set(paths) <= {"cuda", "cuda-warm"},
                      f"{name}: the card inferred through {paths}")
                check(run["launches"] == sum(paths.values()),
                      f"{name}: {run['launches']} launches for the card's inferences {paths}")
                check(paths.get("cuda", 0) == on_cpu.get("torch", 0) == SCENARIO_COLD_FITS[name]
                      and bool(paths.get("cuda-warm")) == bool(on_cpu.get("torch-warm")),
                      f"{name}: {paths} on the card, {on_cpu} on the CPU, cold fits want "
                      f"{SCENARIO_COLD_FITS[name]}")
            if get_scenario(name).read_tier:
                check(card["launches"] == again["launches"] == 0,
                      f"{name}: a replica that never fits launched the kernel")
            else:
                check(card["launches"] >= 1, f"{name}: no inference went through the kernel")
            metrics = card["report"].metrics
            row = {
                "name": name,
                "ms": [round(r["ms"], 3) for r in runs],
                "launches": [card["launches"], again["launches"]],
                "card_inferences": [card["inferences"], again["inferences"]],
                "cpu_inferences": cpu["inferences"],
                "max_request_ms": [round(r["max_request_ms"], 3) for r in runs],
                **{k: metrics[k] for k in ("windows_to_page", "recovery_windows",
                                           "shed_rate_debug", "stale_paint_rate")},
            }
            rows.append(row)
            print(f"scenarios: {name}: card {row['ms'][0]:.1f}, {row['ms'][1]:.1f} ms "
                  f"({row['launches'][0]}, {row['launches'][1]} launches: "
                  f"{json.dumps(card['inferences'])}, {json.dumps(again['inferences'])}), CPU "
                  f"{row['ms'][2]:.1f} ms ({json.dumps(cpu['inferences'])}); largest request "
                  f"{row['max_request_ms'][0]:.1f} / {row['max_request_ms'][1]:.1f} / "
                  f"{row['max_request_ms'][2]:.1f} ms; windows_to_page "
                  f"{row['windows_to_page']}, recovery_windows {row['recovery_windows']}, "
                  f"shed_rate_debug {row['shed_rate_debug']}, stale_paint_rate "
                  f"{row['stale_paint_rate']}; transcripts card = card = CPU; on {smi}")
    finally:
        listening[0] = False
        service._summarize = summarize
    return {"warmup_launches": warmup_launches, "drills": rows}


def _scenario_live_host(torch: Any, smi: str) -> dict[str, Any]:
    """Step 22b; see :func:`scenarios_phase`."""
    from headlamp_tpu_torch.models import aot
    from headlamp_tpu_torch.models.fused_forward import LAUNCHES
    from headlamp_tpu_torch.obs import slo
    from headlamp_tpu_torch.obs.timeline import TIMELINE_CAPACITY
    from headlamp_tpu_torch.runtime.device_cache import warm_carries
    from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

    out: dict[str, Any] = {}
    engine_now = [7000.0]
    engine = slo.SLOEngine(monotonic=lambda: engine_now[0])
    previous = slo.set_engine(engine)
    warm_carries.invalidate()
    app = DashboardApp(make_demo_transport("large"), device="cuda", clock=lambda: FIXED_CLOCK,
                       min_sync_interval_s=3600.0)
    gateway = app.ensure_gateway()
    server = app.serve("127.0.0.1", 0)
    port = int(server.url.rsplit(":", 1)[1])
    debug = None
    try:
        check(aot.registry().wait_ready(600.0), f"the program registry: {aot.registry().snapshot()}")
        health = json.loads(http_get(server.url + "/healthz")[1])
        check("scenarios" not in health["runtime"], "runtime.scenarios outside a drill")
        status, body = http_get(server.url + "/debug/incidentz")
        snap = json.loads(body)
        check(status == 200 and snap["capacity"] == TIMELINE_CAPACITY == 256
              and snap["events"] == [] and snap["active"] is None,
              f"/debug/incidentz before any drill: {status} {body[:200]}")
        t0 = time.perf_counter()
        check(http_get(server.url + "/tpu")[0] == 200, "GET /tpu")
        first_ms = (time.perf_counter() - t0) * 1e3
        LAUNCHES.reset()

        # Paging: breaching /tpu and /tpu/metrics latencies on the engine's
        # own clock until both objectives page (the first /tpu's real
        # duration, a sync and a calibration, may page dashboard_render
        # alone), then the gateway's policy rules on them.
        fed = 0
        objectives = ("dashboard_render", "scrape_paint")
        while any(engine.health_block()[name] != "page" for name in objectives):
            check(fed < 2000, "the breaching latencies never paged")
            for route, seconds in (("/tpu", 1.2), ("/tpu/metrics", 5.0)):
                engine.feed_latency(slo.REQUEST_DURATION, seconds, {"route": route})
            fed += 1
        gateway.shed_policy.invalidate()
        check(gateway.shed_policy.paging(), "both objectives page and the policy does not")
        status, headers, _ = _header_get(port, "/debug/traces")
        check(status == 503 and headers.get("Retry-After") == "5",
              f"a paging /debug/traces answered {status} {headers}")
        status, headers, body = _header_get(port, "/tpu/metrics")
        torch.cuda.synchronize()
        check(status == 200 and headers.get("X-Headlamp-Stale") == "1" and LAUNCHES.n == 0,
              f"a paging /tpu/metrics: {status}, stale {headers.get('X-Headlamp-Stale')}, "
              f"{LAUNCHES.n} launches")
        # A debug-class stream is closed at its handler's first wake.
        debug = _SseClient(port, "/events?class=debug")
        bye = debug.next_event()
        check(bye["event"] == "bye" and bye["data"] == {"reason": "shed"},
              f"the debug stream read {bye}")
        # The incident surfaces are debug routes: shed like the rest while
        # the page lasts (in JAX too), so they are read after the restore.
        status, _, _ = _header_get(port, "/debug/incidentz")
        check(status == 503, f"a paging /debug/incidentz answered {status}")

        # Restore: once the 5 m window has drained, good latencies until the
        # policy restores.
        engine_now[0] += 400.0
        good = 0
        gateway.shed_policy.invalidate()
        while gateway.shed_policy.paging():
            check(good < 2000, "good latencies never restored the policy")
            engine.feed_latency(slo.REQUEST_DURATION, 0.05, {"route": "/tpu"})
            engine.feed_latency(slo.REQUEST_DURATION, 0.3, {"route": "/tpu/metrics"})
            good += 1
            gateway.shed_policy.invalidate()
        status, headers, body = _header_get(port, "/tpu/metrics")
        torch.cuda.synchronize()
        check(status == 200 and headers.get("X-Headlamp-Stale") == "0"
              and "Utilization Forecast" in body and LAUNCHES.n == 1,
              f"the restored /tpu/metrics: {status}, stale {headers.get('X-Headlamp-Stale')}, "
              f"{LAUNCHES.n} launches")
        status, body = http_get(server.url + "/debug/incidentz")
        events = json.loads(body)["events"]
        kinds = [(e["source"], e["kind"]) for e in events]
        order = [("gateway", "paging"), ("gateway", "shed"), ("gateway", "degrade"),
                 ("push", "eviction"), ("gateway", "restore")]
        check(status == 200 and all(k in kinds for k in order)
              and [kinds.index(k) for k in order] == sorted(kinds.index(k) for k in order),
              f"/debug/incidentz after the restore: {status} {kinds}")
        check(next(e for e in events if e["kind"] == "eviction")["detail"]["reason"] == "shed"
              and next(e for e in events if e["kind"] == "shed")["detail"]["route"]
              == "/debug/traces", f"the eviction and shed events: {events}")
        status, body = http_get(server.url + "/debug/incidentz/html")
        rows = body.count('class="hl-span-row"')
        check(status == 200 and "Incident Timeline" in body and rows == len(events),
              f"/debug/incidentz/html: {status}, {rows} rows for {len(events)} events")
        print(f"scenarios: live host --demo large: first /tpu {first_ms:.1f} ms; {fed} "
              f"breaching feeds paged both objectives, {good} good "
              f"feeds restored; /debug/traces and /debug/incidentz 503, degraded /tpu/metrics "
              f"0 launches, debug stream bye/shed, restored /tpu/metrics 1 launch; timeline "
              f"{' > '.join(kind for _, kind in order)} ({len(events)} events, {rows} rows)")

        # The ring full: mark() per event, then both surfaces' paint p50s.
        timeline = app.incidents
        t0 = time.perf_counter()
        for i in range(TIMELINE_CAPACITY):
            timeline.mark("scenario", "fill", {"i": i})
        mark_us = (time.perf_counter() - t0) * 1e6 / TIMELINE_CAPACITY
        check(len(timeline.snapshot()["events"]) == TIMELINE_CAPACITY, "the ring is not full")
        json_p50 = p50_ms(lambda: http_get(server.url + "/debug/incidentz"), SCENARIO_PAINTS)
        html_p50 = p50_ms(lambda: http_get(server.url + "/debug/incidentz/html"), SCENARIO_PAINTS)
        out.update(fed=fed, good=good, events=len(events), mark_us=mark_us,
                   json_p50_ms=json_p50, html_p50_ms=html_p50)
        print(f"scenarios: mark() {mark_us:.3f} us per event (the eviction observer's cost "
              f"under the hub's subscription condition); with the ring full "
              f"({TIMELINE_CAPACITY} events) /debug/incidentz p50 {json_p50:.3f} ms, "
              f"/debug/incidentz/html p50 {html_p50:.3f} ms over {SCENARIO_PAINTS} GETs; on {smi}")
    finally:
        if debug is not None:
            debug.close()
        server.close()
        slo.set_engine(previous)
    return out


def intel_phase(torch: Any, smi: str) -> tuple[int, dict[str, Any]]:
    """Step 23: the Intel GPU provider on the card. (a) The host at
    ``--demo mixed`` on the card behind its gateway over a socket: every
    path of INTEL_HOST_PATHS, then ``/tpu`` and ``/tpu/metrics`` (its cold
    fit, 1 launch), each ``<main>`` byte for byte the same app's on the
    CPU (the forecast section within PAGE_FIT_TOL instead, the two printed
    durations masked), and ``/healthz``. (b) The mixed fleet at full
    size: ``fleet_viewport(INTEL_TPU_NODES)`` plus INTEL_NODES Intel nodes
    (1 or 2 cards, discrete or integrated, every 16th not Ready),
    INTEL_PODS Intel pods (every 8th Pending) and one CR: the TPU rollup on
    the card equals its Python oracle exactly, the card's columns hold
    exactly the TPU nodes, the Intel view's stats are the Python pass's and
    its device backend is refused; quiet and changed ticks of a context
    with the TPU provider alone and with both, INTEL_TICKS each in turns;
    the Intel pages' paint p50s. (c) A leader with a segment publisher, a
    bus replica and a segment-fed worker on the card at ``--demo mixed``:
    the replica and the worker paint the leader's Intel pages, the worker
    seeds both providers and its Intel columns on the card equal the
    segment's, and neither launches the kernel. Returns the launches and
    the numbers."""
    import copy
    import tempfile

    import numpy as np

    from headlamp_tpu_torch.analytics import stats
    from headlamp_tpu_torch.context import AcceleratorDataContext
    from headlamp_tpu_torch.domain.accelerator import TPU_PROVIDER
    from headlamp_tpu_torch.fleet import (
        fleet_transport,
        fleet_viewport,
        make_intel_crd,
        make_intel_node,
        make_intel_pod,
    )
    from headlamp_tpu_torch.models import aot
    from headlamp_tpu_torch.models.fused_forward import LAUNCHES
    from headlamp_tpu_torch.obs import slo
    from headlamp_tpu_torch.replicate import ReplicaApp, parse_payload
    from headlamp_tpu_torch.runtime.columns import ARRAY_FIELDS
    from headlamp_tpu_torch.runtime.device_cache import warm_carries
    from headlamp_tpu_torch.server import DashboardApp, make_demo_transport
    from headlamp_tpu_torch.workers import (
        SegmentBusPublisher,
        SegmentReader,
        ShmConsumer,
        SnapshotSegment,
    )

    t_step = time.perf_counter()
    clock = lambda: FIXED_CLOCK  # noqa: E731
    out: dict[str, Any] = {}
    warm_carries.invalidate()
    engine = slo.SLOEngine()

    def masked(body: str) -> str:
        return PAGE_TIMINGS.sub("", _main_of(body))

    # (a) The demo host on the card against the same app on the CPU.
    app = DashboardApp(make_demo_transport("mixed"), device="cuda", clock=clock)
    app.ensure_gateway(engine=lambda: engine)
    cpu = DashboardApp(make_demo_transport("mixed"), device="cpu", clock=clock)
    server = app.serve("127.0.0.1", 0)
    port = int(server.url.rsplit(":", 1)[1])
    try:
        # serve() starts the process registry's capture (ready since step
        # 9 in a whole run); no device-wide sync may overlap a capture.
        check(aot.registry().wait_ready(600.0), "the program registry never became ready")
        LAUNCHES.reset()
        host_ms: dict[str, float] = {}
        for path in INTEL_HOST_PATHS + ("/tpu",):
            status, _, body, ms = _keepalive_get(port, path)
            want = cpu.handle(path)
            check(status == want[0] == 200, f"GET {path} answered {status}")
            check(masked(body.decode()) == masked(want[2]),
                  f"{path}: the card's <main> differs from the CPU app's")
            host_ms[path] = ms
        check(LAUNCHES.n == 0, f"the Intel pages launched the kernel {LAUNCHES.n} times")
        status, _, body, ms = _keepalive_get(port, "/tpu/metrics")
        # The CPU app fits cold too: the card's fit left its carry in the
        # process-wide warm-carry cache.
        warm_carries.invalidate()
        want = cpu.handle("/tpu/metrics")
        host_ms["/tpu/metrics"] = ms
        card_page, cpu_page = body.decode(), want[2]
        check(status == 200 and "CUDA kernel (H100)" in card_page,
              f"GET /tpu/metrics answered {status} without the kernel")
        check(FORECAST_SECTION.sub("", masked(card_page))
              == FORECAST_SECTION.sub("", masked(cpu_page)),
              "/tpu/metrics outside the forecast differs from the CPU app's")
        peak = re.compile(r'data-status="\w+">([0-9.]+)%')
        card_peaks = [float(v) for v in peak.findall(FORECAST_SECTION.search(card_page)[0])]
        cpu_peaks = [float(v) for v in peak.findall(FORECAST_SECTION.search(cpu_page)[0])]
        fit_diff = max(abs(a - b) for a, b in zip(sorted(card_peaks), sorted(cpu_peaks))) / 100
        check(len(card_peaks) == len(cpu_peaks) == 16 and fit_diff <= PAGE_FIT_TOL,
              f"the forecast's predicted peaks differ from the CPU's by {fit_diff}")
        torch.cuda.synchronize()
        host_launches = LAUNCHES.n
        check(host_launches == INTEL_LAUNCHES,
              f"the mixed host launched the kernel {host_launches} times, not {INTEL_LAUNCHES}")
        health = json.loads(_keepalive_get(port, "/healthz")[2])
        check(health["ok"] is True and health["nodes"] == 7 and health["errors"] == [],
              f"/healthz at --demo mixed: ok {health['ok']}, nodes {health['nodes']}")
        print(f"intel: --demo mixed on the card over the socket: {len(INTEL_HOST_PATHS) + 2} "
              f"paths with the CPU app's <main> (/tpu/metrics outside its forecast; predicted "
              f"peaks within {fit_diff:.3e} of the CPU fit, tol {PAGE_FIT_TOL:g}); "
              f"forecast_mlp_forward launches {host_launches} (want {INTEL_LAUNCHES}); "
              f"/healthz ok, nodes 7; first-GET ms "
              + ", ".join(f"{p} {v:.1f}" for p, v in host_ms.items()))
    finally:
        server.close()
        cpu.close()
    out["host_ms"] = host_ms

    # (b) The mixed fleet at full size.
    LAUNCHES.reset()
    t0 = time.perf_counter()
    fleet = fleet_viewport(INTEL_TPU_NODES)
    for i in range(INTEL_NODES):
        fleet["nodes"].append(make_intel_node(
            f"arc-{i:03d}", gpus=1 + i % 2, discrete=i % 2 == 0, ready=i % 16 != 0))
    for i in range(INTEL_PODS):
        fleet["pods"].append(make_intel_pod(
            f"gpu-job-{i}", namespace="media", node=f"arc-{i % INTEL_NODES:03d}",
            phase="Pending" if i % 8 == 0 else "Running"))
    fleet["gpudeviceplugins"] = [make_intel_crd(desired=INTEL_NODES)]
    build_s = time.perf_counter() - t0
    big = DashboardApp(fleet_transport(fleet), device="cuda", clock=clock)
    big.ensure_gateway(engine=lambda: engine)
    server = big.serve("127.0.0.1", 0)
    port = int(server.url.rsplit(":", 1)[1])
    try:
        status, _, body, first_ms = _keepalive_get(port, "/tpu")
        check(status == 200 and "Chip Allocation" in body.decode(), f"GET /tpu answered {status}")
        snap = big._last_snapshot
        tpu, intel = snap.provider("tpu"), snap.provider("intel")
        check(len(tpu.nodes) == INTEL_TPU_NODES and len(intel.nodes) == INTEL_NODES
              and len(intel.pods) == INTEL_PODS,
              f"classified {len(tpu.nodes)} TPU and {len(intel.nodes)} Intel nodes")
        cache = big._ctx.fleet_cache
        got = stats.fleet_stats(tpu.view, device="cuda", fleet_cache=cache, backend="cuda")
        want = stats.python_fleet_stats(tpu.view)
        bad = sorted(k for k in want if got.get(k) != want[k])
        check(got.keys() == want.keys() and not bad,
              f"the TPU rollup on the card differs from its oracle in {bad}")
        cols = cache.fleet_for(tpu.view)
        tpu_names = [n["metadata"]["name"] for n in tpu.nodes]
        check(set(cache._entries) == {"tpu"} and cols.n_nodes == INTEL_TPU_NODES
              and list(cols.node_names) == tpu_names
              and not any(name.startswith("arc-") for name in cols.node_names)
              and cols.node_capacity.device.type == "cuda",
              f"the card's columns: {sorted(cache._entries)}, {cols.n_nodes} nodes")
        intel_stats = stats.fleet_stats(intel.view, device="cuda", fleet_cache=cache)
        check(intel_stats == stats.python_fleet_stats(intel.view)
              and intel_stats["nodes_total"] == INTEL_NODES
              and intel_stats["generation_counts"] == {}
              and set(cache._entries) == {"tpu"},
              f"the Intel view's stats: {sorted(intel_stats)}")
        try:
            stats.fleet_stats(intel.view, device="cuda", fleet_cache=cache, backend="cuda")
        except ValueError:
            pass
        else:
            raise SmokeFailure("the device backend was not refused for the Intel view")
        print(f"intel: {INTEL_TPU_NODES} TPU + {INTEL_NODES} Intel nodes, "
              f"{len(tpu.pods)} TPU + {INTEL_PODS} Intel pods (built in {build_s:.1f} s): first "
              f"/tpu {first_ms:.1f} ms; the TPU rollup on the card equals python_fleet_stats; "
              f"the card's columns hold exactly the {cols.n_nodes} TPU nodes (no Intel node); "
              f"the Intel view's stats are the Python pass's "
              f"({intel_stats['capacity']} devices, {intel_stats['in_use']} in use, "
              f"{intel_stats['nodes_ready']} ready) and its device backend is refused")
        paint: dict[str, list[float]] = {p: [] for p in INTEL_SCALE_PAGES}
        for _ in range(INTEL_TIMED):
            for path in INTEL_SCALE_PAGES:
                status, _, body, ms = _keepalive_get(port, path)
                check(status == 200, f"GET {path} at full size answered {status}")
                paint[path].append(ms)
        paint_p50 = {p: round(statistics.median(v), 2) for p, v in paint.items()}
        print(f"intel: paint p50 of {INTEL_TIMED} over the socket at {INTEL_TPU_NODES} + "
              f"{INTEL_NODES} nodes: {paint_p50}; all {json.dumps(paint)}; on {smi}")
        out["paint_p50_ms"] = paint_p50
    finally:
        server.close()
        big.close()

    contexts = {}
    for label, providers in (("tpu_only", (TPU_PROVIDER,)), ("tpu_and_intel", None)):
        transport = fleet_transport(fleet)
        kwargs = {} if providers is None else {"providers": providers}
        ctx = AcceleratorDataContext(transport, device="cuda", clock=clock, watch=True, **kwargs)
        ctx.sync()  # hydrate: one LIST chain per track
        contexts[label] = (ctx, transport)
    ticks: dict[str, dict[str, list[float]]] = {
        label: {"quiet": [], "changed": []} for label in contexts}
    flip = fleet["nodes"][1]
    for i in range(INTEL_TICKS):
        for label, (ctx, transport) in contexts.items():
            before = ctx.snapshot().provider("tpu").view.version
            t0 = time.perf_counter()
            snap = ctx.sync()
            ticks[label]["quiet"].append((time.perf_counter() - t0) * 1e3)
            check(snap.provider("tpu").view.version == before,
                  f"a quiet {label} tick changed the version")
            node = copy.deepcopy(flip)
            for cond in node["status"]["conditions"]:
                if cond["type"] == "Ready":
                    cond["status"] = "False" if i % 2 == 0 else "True"
            node["metadata"]["resourceVersion"] = str(100 + i)
            transport.node_feed.push("MODIFIED", node)
            t0 = time.perf_counter()
            snap = ctx.sync()
            ticks[label]["changed"].append((time.perf_counter() - t0) * 1e3)
            check(snap.provider("tpu").view.version == before + 1,
                  f"a changed {label} tick did not bump the version")
            check(("intel" in snap.providers) == (label == "tpu_and_intel"),
                  f"the {label} snapshot's providers: {sorted(snap.providers)}")
    for ctx, _ in contexts.values():
        ctx.close()
    tick_p50 = {label: {kind: round(statistics.median(v), 3) for kind, v in kinds.items()}
                for label, kinds in ticks.items()}
    cost = {kind: round(tick_p50["tpu_and_intel"][kind] - tick_p50["tpu_only"][kind], 3)
            for kind in ("quiet", "changed")}
    print(f"intel: tick p50 of {INTEL_TICKS} in turns at {INTEL_TPU_NODES} + {INTEL_NODES} "
          f"nodes (watch on): TPU provider alone {tick_p50['tpu_only']}, TPU and Intel "
          f"{tick_p50['tpu_and_intel']} ms; the Intel provider's cost per tick {cost} ms; "
          f"all {json.dumps(ticks)}; on {smi}")
    out.update(tick_p50_ms=tick_p50, intel_tick_cost_ms=cost)
    torch.cuda.synchronize()
    scale_launches = LAUNCHES.n
    check(scale_launches == 0, f"the full-size fleet launched the kernel {scale_launches} times")

    # (c) The read tier at --demo mixed: a bus replica and a segment worker.
    LAUNCHES.reset()
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()
    seg = SnapshotSegment(os.path.join(shm, f"headlamp-torch-intel-{os.getpid()}.seg"),
                          size=8 << 20)
    leader = DashboardApp(make_demo_transport("mixed"), device="cuda", clock=clock,
                          min_sync_interval_s=3600.0)
    pub = SegmentBusPublisher(seg, wall=clock, ledger=leader.ledger)
    leader.replication = pub
    replica = ReplicaApp(device="cuda", clock=clock)
    worker = ReplicaApp(device="cuda", clock=clock)
    consumer = ShmConsumer(worker, seg.path)
    try:
        leader._synced_snapshot()
        record = json.loads(pub._backlog[-1][1])
        check(set(record["snapshot"]["providers"]) == {"tpu", "intel"}
              and record["snapshot"]["providers"]["intel"]["workloads"],
              "the leader's record has no Intel block")
        _, records = parse_payload(pub.payload_after(None))
        check(all(replica.apply_record(r) for r in records), "the replica refused a record")
        check(consumer.poll_once() == 1 and consumer.seeds == 2 and consumer.seed_errors == 0,
              f"the worker's seed: {consumer.snapshot()}")
        reader = SegmentReader(seg.path)
        frame = reader.read()
        reader.close()
        version, seeded = worker._ctx.fleet_cache._entries["intel"]
        check(version == worker.snapshot_generation() and seeded.n_nodes == 2
              and all(getattr(seeded, f).device.type == "cuda" for f in ARRAY_FIELDS)
              and all(np.array_equal(getattr(seeded, f).cpu().numpy(),
                                     getattr(frame.columns["intel"], f)) for f in ARRAY_FIELDS),
              "the worker's Intel columns on the card differ from the segment's")
        for path in INTEL_SNAPSHOT_PAGES + ("/nodes", "/node/arc-node-1"):
            want = leader.handle(path)
            for name, rep in (("replica", replica), ("worker", worker)):
                check(rep.handle(path) == want, f"the {name}'s {path} differs from the leader's")
        torch.cuda.synchronize()
        tier_launches = LAUNCHES.n
        check(tier_launches == 0, f"the read tier launched the kernel {tier_launches} times")
        print(f"intel: leader record with the intel block ({len(pub._backlog[-1][1])} bytes); "
              f"a bus replica and a segment worker on the card paint the leader's "
              f"{', '.join(INTEL_SNAPSHOT_PAGES)}, /nodes and /node/arc-node-1 bytes; the worker "
              f"seeds {consumer.seeds} providers and its Intel columns on the card equal the "
              f"segment's; forecast_mlp_forward launches 0")
    finally:
        for a in (worker, replica, leader):
            a.close()
        seg.close()
        seg.unlink()
    out["seconds"] = time.perf_counter() - t_step
    launches = host_launches + scale_launches + tier_launches
    print(f"intel: step 23 launched forecast_mlp_forward {launches} times; took "
          f"{out['seconds']:.1f} s; on {smi}")
    return launches, out


def _rollup_columns(torch: Any, n: int) -> tuple[list[Any], Any]:
    """The card's fleet columns of ``fleet_large(n)`` (uploaded by a
    context of their own, closed) and their rollup bucket."""
    from headlamp_tpu_torch.analytics import fleet_torch
    from headlamp_tpu_torch.context import AcceleratorDataContext
    from headlamp_tpu_torch.fleet import fleet_large, fleet_transport

    with AcceleratorDataContext(fleet_transport(fleet_large(n)), device="cuda") as ctx:
        view = ctx.sync().provider("tpu").view
        fleet = ctx.fleet_cache.fleet_for(view)
    torch.cuda.synchronize()
    return [getattr(fleet, name) for name in fleet_torch.COLUMNS], fleet_torch.rollup_key(fleet)


def _replay_against_eager(torch: Any, reg: Any, cols: list[Any], key: Any) -> float:
    """The registry's fleet rollup graph at ``key`` replayed on ``cols``
    against the eager program on the same columns: max abs difference."""
    from headlamp_tpu_torch.models import aot

    program = reg.executable(aot.FLEET_ROLLUP, key, cols[0].device)
    check(isinstance(program, aot.GraphProgram), f"no captured fleet rollup at {key}: {program}")
    replayed = reg.replay(aot.FLEET_ROLLUP, key, program, cols, lambda outs: outs[0].clone())
    eager = aot._fleet_rollup_program(*cols)[0]
    torch.cuda.synchronize()
    return float((replayed - eager).abs().max())


def close_during_capture_phase(torch: Any, clock: Callable[[], float], smi: str
                               ) -> tuple[int, dict[str, Any]]:
    """Step 24: ``DashboardApp.close()`` on the card while a startup capture
    runs on the program registry's thread. (a) A fresh registry whose one
    program, the fleet rollup at ``fleet_large(1024)``'s bucket, holds its
    CUDA graph capture open until an app on the card, built and painted
    (``/tpu``, an eager rollup) during it, has returned from ``close()``;
    then the capture ends, the registry is ready with 0 capture errors,
    and the graph's replay equals the eager program on the same columns.
    (b) A fresh registry's whole startup set captured while apps at
    ``--demo v5e4`` are built, painted and closed one after another, a
    pause apart, until it is ready: every close returns, at least one while the capture runs,
    0 capture errors, and the fleet rollup's replay equals its eager
    program. No path here launches the kernel (warm-up and capture count
    for none). Returns the launches and the numbers."""
    from headlamp_tpu_torch.models import aot
    from headlamp_tpu_torch.models.fused_forward import LAUNCHES
    from headlamp_tpu_torch.obs import graphcost
    from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

    t_step = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    cols, key = _rollup_columns(torch, 1024)
    out: dict[str, Any] = {}
    LAUNCHES.reset()

    # (a) One close held inside a capture.
    in_capture, closed = threading.Event(), threading.Event()

    def gated(*inputs: Any) -> Any:
        outputs = aot._fleet_rollup_program(*inputs)
        if torch.cuda.is_current_stream_capturing():
            in_capture.set()
            if not closed.wait(120.0):
                raise SmokeFailure("no app closed during the capture in 120 s")
        return outputs

    def build_gated(bucket: Any, device: Any) -> Any:
        node_shape, pod_shape = bucket
        inputs = aot._columns(node_shape, 5, device) + aot._columns(pod_shape, 4, device)
        return aot._program(gated, inputs)

    build_rollup = aot._BUILDERS[aot.FLEET_ROLLUP]
    aot._BUILDERS[aot.FLEET_ROLLUP] = build_gated
    reg = aot.AotProgramRegistry(specs=[(aot.FLEET_ROLLUP, key)])
    try:
        with _Registry(reg, graphcost.GraphCostLedger()):
            reg.compile_startup(dev)  # on the registry's thread, as serve() starts it
            check(in_capture.wait(120.0), "the gated capture did not start in 120 s")
            app = DashboardApp(make_demo_transport("large"), device="cuda", clock=clock)
            try:
                status = app.handle("/tpu")[0]
            finally:
                try:
                    t0 = time.perf_counter()
                    app.close()
                    close_ms = (time.perf_counter() - t0) * 1e3
                    state = reg.state
                finally:
                    closed.set()  # the capture goes on, whatever the close did
            check(status == 200 and state == "compiling",
                  f"/tpu during the capture: {status}; registry {state} at the close")
            check(reg.wait_ready(120.0) and reg.join(60.0),
                  "the gated capture did not finish in 120 s")
            snap = reg.snapshot()
            check(snap["state"] == "ready" and snap["compile_errors"] == 0
                  and snap["last_error"] is None and snap["programs_compiled"] == 1,
                  f"the registry after the gated capture: {snap}")
            gated_err = _replay_against_eager(torch, reg, cols, key)
    finally:
        aot._BUILDERS[aot.FLEET_ROLLUP] = build_rollup
    check(gated_err == 0.0, f"the gated graph's replay differs from eager by {gated_err}")
    out["gated"] = {"close_ms": close_ms, "replay_vs_eager": gated_err}
    print(f"capture-close: an app at --demo large painted /tpu (200) and closed in "
          f"{close_ms:.1f} ms inside the fleet rollup's graph capture at {key} on the "
          f"registry's thread; the capture then ended with 0 capture errors and its replay "
          f"equals the eager program (max abs diff {gated_err}); on {smi}")

    # (b) Closes beside the whole startup set.
    reg = aot.AotProgramRegistry()
    with _Registry(reg, graphcost.GraphCostLedger()):
        t0 = time.perf_counter()
        reg.compile_startup(dev)
        closes, during, close_ms = 0, 0, []
        while reg.state == "compiling":
            app = DashboardApp(make_demo_transport("v5e4"), device="cuda", clock=clock)
            try:
                check(app.handle("/tpu")[0] == 200, "/tpu beside the startup capture")
            finally:
                t1 = time.perf_counter()
                app.close()
                close_ms.append((time.perf_counter() - t1) * 1e3)
            closes += 1
            during += reg.state == "compiling"
            # Paced: back to back, the apps' Python starves the capture
            # thread of the interpreter (9747 closes stretched the capture
            # to 51.85 s on an H100).
            time.sleep(CAPTURE_CLOSE_PAUSE_S)
        check(reg.wait_ready(600.0) and reg.join(60.0),
              "the startup capture did not finish in 600 s")
        ready_s = time.perf_counter() - t0
        snap = reg.snapshot()
        check(snap["state"] == "ready" and snap["compile_errors"] == 0
              and snap["last_error"] is None
              and snap["programs_compiled"] == len(aot.default_specs()),
              f"the registry after the startup capture: {snap}")
        check(during >= 1, f"no close returned while the startup capture ran ({closes} closes)")
        startup_err = _replay_against_eager(torch, reg, cols, key)
    check(startup_err == 0.0, f"the fleet rollup's replay differs from eager by {startup_err}")
    torch.cuda.synchronize()
    launches = LAUNCHES.n
    check(launches == 0, f"step 24 launched forecast_mlp_forward {launches} times, not 0")
    out["startup"] = {"ready_s": ready_s, "closes": closes, "closes_during": during,
                      "close_ms_p50": statistics.median(close_ms),
                      "programs": snap["programs_compiled"], "replay_vs_eager": startup_err}
    out["seconds"] = time.perf_counter() - t_step
    print(f"capture-close: {closes} apps at --demo v5e4 built, painted and closed beside the "
          f"startup capture of {snap['programs_compiled']} programs ({during} closes returned "
          f"while it ran; close p50 {out['startup']['close_ms_p50']:.1f} ms); ready in "
          f"{ready_s:.2f} s with 0 capture errors; fleet rollup replay vs eager "
          f"{startup_err}; on {smi}")
    print(f"capture-close: step 24 launched forecast_mlp_forward {launches} times; took "
          f"{out['seconds']:.1f} s")
    return launches, out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch.nn.functional as F

    from headlamp_tpu_torch.cli import render_page
    from headlamp_tpu_torch.kernels import build
    from headlamp_tpu_torch.metrics.client import (
        UtilizationHistory,
        fetch_tpu_metrics,
        fetch_utilization_history,
    )
    from headlamp_tpu_torch.models.forecast import (
        ForecastConfig,
        fit_and_forecast_incremental,
        init_params,
        synthetic_telemetry,
    )
    from headlamp_tpu_torch.models.fused_forward import (
        LAUNCHES,
        forecast_forward_cuda,
        forecast_forward_reference,
    )
    from headlamp_tpu_torch.models.service import (
        compute_forecast_incremental,
        forecast_from_history,
        forecast_from_history_incremental,
    )
    from headlamp_tpu_torch.server import make_demo_transport

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # 1. The card.
    smi = nvidia_smi_line()
    print(f"nvidia-smi: {smi}")
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")

    # 2. Build the kernel from the checkout's source.
    _, info = build.load("forecast_mlp")
    print(f"build: forecast_mlp in {info.seconds:.2f} s, cache_hit={info.cache_hit}, "
          f"{info.library.relative_to(ROOT)}")
    for line in info.log.splitlines():
        if any(word in line for word in ("registers", "spill", "wgmma", "Performance")):
            print(f"  ptxas: {line.strip()}")
    spills = [line for line in info.log.splitlines() if "spill stores" in line]
    check(bool(spills) and all(
        "0 bytes spill stores, 0 bytes spill loads" in line for line in spills),
        "ptxas reports spills, or no report was kept")

    # 3. The kernel against its plain version, at full width.
    cfg = ForecastConfig()
    gen = torch.Generator().manual_seed(0)
    params = init_params(gen, cfg, device=dev)
    params = {k: v + 0.05 * torch.randn(v.shape, generator=gen).to(dev)
              for k, v in params.items()}  # non-zero biases
    max_err = 0.0
    for rows in CHECK_ROWS:
        x = torch.rand((rows, cfg.window), generator=gen).to(dev)
        got = forecast_forward_cuda(params, x)
        want = forecast_forward_reference(params, x)
        torch.cuda.synchronize()
        check(got.shape == (rows, cfg.horizon), f"kernel shape {tuple(got.shape)} at {rows}")
        check(bool(torch.isfinite(got).all()), f"non-finite kernel output at {rows} rows")
        err = float((got - want).abs().max())
        print(f"check: rows={rows} max_abs_err={err:.3e} (tol {KERNEL_TOL:g})")
        check(err <= KERNEL_TOL, f"kernel differs from its plain version by {err} at {rows}")
        max_err = max(max_err, err)
    exact_params, exact_x = exact_inputs(cfg.window, cfg.hidden, cfg.horizon, EXACT_ROWS)
    exact_params = {k: v.to(dev) for k, v in exact_params.items()}
    got = forecast_forward_cuda(exact_params, exact_x.to(dev))
    want = forecast_forward_reference(exact_params, exact_x.to(dev))
    torch.cuda.synchronize()
    exact_err = float((got - want).abs().max())
    print(f"check: exact arithmetic, rows={EXACT_ROWS} max_abs_err={exact_err:.3e} "
          f"(tol {EXACT_TOL:g})")
    check(exact_err <= EXACT_TOL, f"kernel differs on exact inputs by {exact_err}")
    wide = dict(params, w1=torch.zeros((cfg.window, 256), device=dev))
    try:
        forecast_forward_cuda(wide, torch.zeros((4, cfg.window), device=dev))
    except ValueError as exc:
        print(f"check: hidden=256 rejected: {exc}")
    else:
        raise SmokeFailure("hidden=256 was not rejected")

    # 4. Time the kernel, its plain version and the unfused library chain.
    bf = {k: v.to(torch.bfloat16) for k, v in params.items()}

    def library_chain(x: Any) -> Any:
        h = F.gelu(torch.addmm(bf["b1"], x.to(torch.bfloat16), bf["w1"]), approximate="tanh")
        h = F.gelu(torch.addmm(bf["b2"], h, bf["w2"]), approximate="tanh")
        return torch.sigmoid(torch.addmm(bf["b3"], h, bf["w3"]).float())

    # The launch floor: one one-element in-place add, the least a launch
    # costs on this card. A kernel near it has nothing left to win.
    one = torch.zeros(1, device=dev)
    floor_ms, floor_mean = time_device_ms(lambda: one.add_(1.0))
    print(f"launch floor: one-element add_ {floor_ms:.6f} ms (mean {floor_mean:.6f})")
    timings: dict[int, dict[str, Any]] = {}
    for rows in TIME_ROWS:
        x = torch.rand((rows, cfg.window), generator=gen).to(dev)
        kernel_ms, kernel_mean = time_device_ms(lambda: forecast_forward_cuda(params, x))
        plain_ms, plain_mean = time_device_ms(lambda: forecast_forward_reference(params, x))
        library_ms, library_mean = time_device_ms(lambda: library_chain(x))
        b_ms, b_by = bound_ms(rows, cfg.window, cfg.hidden, cfg.horizon)
        timings[rows] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=b_ms, bound_by=b_by)
        print(f"time: rows={rows} kernel_ms={kernel_ms:.6f} plain_ms={plain_ms:.6f} "
              f"library_ms={library_ms:.6f} bound_ms={b_ms:.6f} ({b_by}); means "
              f"{kernel_mean:.6f} {plain_mean:.6f} {library_mean:.6f}; "
              f"{kernel_ms / floor_ms:.2f}x the launch floor, "
              f"{'beats' if kernel_ms <= library_ms else 'LOSES TO'} the library chain")

    # 5. The main path: the metrics page through the CLI entry point,
    #    then the warm-start carry on the same transport. Each path's
    #    launches are counted on their own, from 0.
    LAUNCHES.reset()
    clock = lambda: FIXED_CLOCK  # noqa: E731
    transport = make_demo_transport("large")
    t0 = time.perf_counter()
    text = render_page("metrics", transport, clock=clock, device="cuda")
    print(f"main: render_page('metrics', demo large) in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms, {len(text.splitlines())} lines")
    check("Utilization Forecast" in text, "page has no forecast section")
    check("CUDA kernel (H100)" in text, "page does not name the CUDA kernel")
    metrics = fetch_tpu_metrics(transport, clock=clock)
    cold, state = compute_forecast_incremental(transport, metrics, clock=clock, device="cuda")
    warm, state = compute_forecast_incremental(
        transport, metrics, state=state, clock=clock, device="cuda"
    )
    check(cold is not None and warm is not None, "no forecast on the demo fleet")
    check(cold.inference_path == "cuda", f"cold path {cold.inference_path}")
    check(warm.inference_path == "cuda-warm", f"warm path {warm.inference_path}")
    for view in (cold, warm):
        check(view.fit_mse is not None and math.isfinite(view.fit_mse), "non-finite fit MSE")
        check(all(0.0 <= c.predicted_peak <= 1.0 for c in view.chips), "prediction out of [0,1]")
    torch.cuda.synchronize()
    page_launches = LAUNCHES.n
    print(f"main: {len(cold.chips)} chips; cold fit_ms={cold.fit_ms} mse={cold.fit_mse:.6g}; "
          f"warm fit_ms={warm.fit_ms} mse={warm.fit_mse:.6g}")
    print(f"main: metrics page path, forecast_mlp_forward launches={page_launches} "
          f"(want {PAGE_LAUNCHES})")
    check(page_launches == PAGE_LAUNCHES,
          f"the page path launched the kernel {page_launches} times, not {PAGE_LAUNCHES}")

    # 6. At scale: 4096 chips, 61 samples (a 3600 s window at a 60 s step).
    series = synthetic_telemetry(SCALE_CHIPS, 61, torch.Generator().manual_seed(7), device="cpu")
    history = UtilizationHistory(
        keys=[(f"scale-node-{i // 4}", str(i % 4)) for i in range(SCALE_CHIPS)],
        series=series.tolist(), step_s=60, end=FIXED_CLOCK,
        resolved_query="tensorcore_utilization",
    )
    LAUNCHES.reset()
    big_cold, big_state = forecast_from_history_incremental(history, device="cuda")
    big_warm, _ = forecast_from_history_incremental(history, state=big_state, device="cuda")
    check(big_cold.inference_path == "cuda" and big_warm.inference_path == "cuda-warm",
          f"scale paths {big_cold.inference_path}, {big_warm.inference_path}")
    check(len(big_warm.chips) == SCALE_CHIPS, "scale forecast lost chips")
    for view in (big_cold, big_warm):
        check(view.fit_mse is not None and math.isfinite(view.fit_mse), "non-finite scale MSE")
    torch.cuda.synchronize()
    scale_launches = LAUNCHES.n
    print(f"scale: {SCALE_CHIPS} chips; cold fit_ms={big_cold.fit_ms} mse={big_cold.fit_mse:.6g}; "
          f"warm fit_ms={big_warm.fit_ms} mse={big_warm.fit_mse:.6g}")
    print(f"scale: forecast_mlp_forward launches={scale_launches} (want {SCALE_LAUNCHES})")
    check(scale_launches == SCALE_LAUNCHES,
          f"the scale path launched the kernel {scale_launches} times, not {SCALE_LAUNCHES}")

    # 7. One chip, 61 samples: the latest window is a slice that starts
    #    29 floats into the series; the path must hand the kernel an
    #    aligned copy. The cold fit's predictions are held against the
    #    plain version on the params it carries.
    one_chip = UtilizationHistory(
        keys=[("one-chip-node", "0")], series=series[:1].tolist(), step_s=60,
        end=FIXED_CLOCK, resolved_query="tensorcore_utilization",
    )
    LAUNCHES.reset()
    one_cold, one_state = forecast_from_history_incremental(one_chip, device="cuda")
    one_warm, _ = forecast_from_history_incremental(one_chip, state=one_state, device="cuda")
    one_plain = forecast_from_history(one_chip, device="cuda")
    torch.cuda.synchronize()
    one_launches = LAUNCHES.n
    paths = [v.inference_path for v in (one_cold, one_warm, one_plain)]
    check(paths == ["cuda", "cuda-warm", "cuda"], f"one-chip paths {paths}")
    want = forecast_forward_reference(one_state.params, series[:1, -cfg.window:].to(dev))[0]
    got = one_cold.chips[0]
    one_diff = max(abs(got.predicted_peak - float(want.max())),
                   abs(got.predicted_mean - float(want.mean())))
    print(f"one chip: forecast_mlp_forward launches={one_launches} (want {ONE_CHIP_LAUNCHES}); "
          f"cold forecast vs plain version {one_diff:.3e} (tol {KERNEL_TOL:g})")
    check(one_launches == ONE_CHIP_LAUNCHES,
          f"the one-chip path launched the kernel {one_launches} times, not {ONE_CHIP_LAUNCHES}")
    check(one_diff <= KERNEL_TOL, f"one-chip forecast differs from the plain version by {one_diff}")

    # The card's forecast against the same fit on the CPU (same seed,
    # same history): the repo's own reference, on the demo's 64 chips.
    # Five Adam steps differ by summation order alone; over 60 steps Adam
    # amplifies that noise.
    prom = (metrics.namespace, metrics.service)
    demo_history = fetch_utilization_history(transport, prometheus=prom, clock=clock)
    short_card, _, _ = fit_and_forecast_incremental(demo_history.series, steps=5, device="cuda")
    short_cpu, _, _ = fit_and_forecast_incremental(demo_history.series, steps=5, device="cpu")
    step_diff = float(np.abs(short_card - short_cpu).max())
    print(f"check: card vs CPU 5-step fit, max prediction diff {step_diff:.3e} "
          f"(tol {STEP_TOL:g})")
    check(step_diff <= STEP_TOL, f"card's 5-step fit differs from the CPU's by {step_diff}")
    on_cpu, _ = forecast_from_history_incremental(demo_history, device="cpu")
    cpu_peak = {(c.node, c.accelerator_id): c.predicted_peak for c in on_cpu.chips}
    fit_diff = max(abs(c.predicted_peak - cpu_peak[(c.node, c.accelerator_id)])
                   for c in cold.chips)
    print(f"check: card vs CPU cold forecast, max predicted-peak diff {fit_diff:.3e} "
          f"(tol {PAGE_FIT_TOL:g}); MSE {cold.fit_mse:.6g} vs {on_cpu.fit_mse:.6g}")
    check(fit_diff <= PAGE_FIT_TOL, f"card forecast differs from the CPU's by {fit_diff}")

    # Steady-state page time: five more renders, each on a fresh demo
    # transport (so Prometheus discovery is paid every time, as on a cold
    # request), against the fixed clock.
    render_ms = []
    for _ in range(5):
        fresh = make_demo_transport("large")
        t0 = time.perf_counter()
        render_page("metrics", fresh, clock=clock, device="cuda")
        render_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"e2e: render_page('metrics', demo large) x5: p50 {statistics.median(render_ms):.1f} ms "
          f"(min {min(render_ms):.1f}, max {max(render_ms):.1f})")

    # Where the fit's time goes: device-busy time of one cold fit at the
    # demo's 64 chips and one warm fit at 4096, against the unprofiled
    # fit_ms measured above.
    for label, fit_ms, run in (
        ("cold fit, 64 chips", cold.fit_ms,
         lambda: forecast_from_history_incremental(demo_history, device="cuda")),
        (f"warm fit, {SCALE_CHIPS} chips", big_warm.fit_ms,
         lambda: forecast_from_history_incremental(history, state=big_state, device="cuda")),
    ):
        busy_ms, n_events, top = profile_device(torch, run)
        if n_events == 0:
            print(f"profile: {label}: device time not measured (no CUDA events)")
            continue
        print(f"profile: {label}: device busy {busy_ms:.3f} ms in {n_events} device events; "
              f"unprofiled fit_ms {fit_ms}; busy share {busy_ms / fit_ms:.3f}")
        for name, ms in top:
            print(f"  {ms:8.3f} ms  {name[:100]}")

    # 9. The dashboard host over a socket.
    serve_launches = dashboard_host_phase(torch, clock, smi)

    # 10. The fleet rollup on the card against its oracle, timed.
    fleet_rows = fleet_rollup_phase(torch, smi)

    # 11. The cluster dashboard's pages over a socket.
    cluster_launches = cluster_dashboard_phase(torch, clock, smi)

    # 12. The fleet drill-down: the region rollup against its oracle,
    #     timed, then the host's drill-down and native views.
    region_rows = region_rollup_phase(torch, smi)
    viewport_launches = viewport_host_phase(torch, clock, smi)

    # 13. The live host: background sync with list+watch, the warm, 410
    #     Gone, the history-first forecast and the trend page.
    live_launches, _sync_rows, trend_rows = live_host_phase(torch, clock, smi)

    # 14. The program registry: the startup capture beside a request, the
    #     fused request, every bucket's replay against its eager program.
    registry_launches, registry_rows = program_registry_phase(torch, clock, smi)

    # 15. The mesh: the multichip drill, the world-1 NCCL rollups against
    #     the single-device rollups (replayed and eager), the dp×tp step.
    mesh_launches, mesh_rows = mesh_phase(torch, smi)

    # 16. Record and replay: a recorded demo run replayed twice.
    replay_launches = record_replay_phase(torch, smi)

    # 17. Telemetry beyond spans: the SLO engine's budget self-forecast
    #     replayed on the card, exemplars, the flight recorder, the
    #     profiler, the generation ledger and the debug pages.
    telemetry_launches, slo_row = telemetry_phase(torch, clock, smi)

    # 18. The request gateway and the real transport: the bounded pool,
    #     coalescing, 304, shedding and degraded renders over the socket,
    #     then KubeTransport against a local stand-in apiserver.
    gateway_launches, _gateway_row = gateway_phase(torch, clock, smi)

    # 19. Push and the fragment cache: the snapshot differ, the SSE hub
    #     and /events over the socket, and paints through the fragment
    #     cache against the oracle.
    push_launches, _push_row = push_phase(torch, clock, smi)

    # 20. Provenance and replication: a leader's bus, two replicas on the
    #     card, the failover drill, the --replica entry point, and the
    #     bus's costs at 16384 nodes.
    replication_launches, _replication_row = replication_phase(torch, smi)

    # 21. Multi-process serving: the shared-memory segment feeding two
    #     workers on the card at 16384 nodes beside a bus replica, then
    #     --workers 2 and --workers 1 as processes with their curves.
    workers_launches, _workers_row = workers_phase(torch, smi)

    # 22. The incident drills: the six drills twice on the card and once
    #     on the CPU, byte for byte, then the incident timeline of the
    #     live host through a page, a shed, an eviction and a restore.
    scenarios_launches, _scenarios_row = scenarios_phase(torch, smi)

    # 23. The Intel provider: the host at --demo mixed against the CPU app,
    #     the mixed fleet at 16384 + 512 nodes (the TPU rollup, the card's
    #     columns, the Intel provider's cost per tick, the Intel paints),
    #     and a bus replica and a segment worker painting the Intel pages.
    intel_launches, _intel_row = intel_phase(torch, smi)

    # 24. Closing an app on the card while the program registry captures
    #     on its own thread: the close waits on its own stream only.
    capture_close_launches, _capture_close_row = close_during_capture_phase(torch, clock, smi)
    from headlamp_tpu_torch.parallel import close_process_meshes

    close_process_meshes()
    print(json.dumps({"device_programs": [
        {"name": "fleet_rollup", "route": "torch ops",
         "replaces": "headlamp_tpu/analytics/fleet_jax.py:98", "by_nodes": fleet_rows},
        {"name": "region_rollup", "route": "torch ops",
         "replaces": "headlamp_tpu/analytics/fleet_jax.py:243", "by_nodes": region_rows},
        {"name": "trend_stats", "route": "torch ops",
         "replaces": "headlamp_tpu/analytics/trends.py:15", "by_series": trend_rows},
        {"name": "program_registry", "route": "cuda graphs",
         "replaces": "headlamp_tpu/models/aot.py:332", "rows": registry_rows},
        {"name": "mesh", "route": "nccl collectives, cuda graphs",
         "replaces": "headlamp_tpu/parallel/mesh.py:70", "rows": mesh_rows},
        slo_row,
    ]}))

    # 8. The record.
    at = timings[SCALE_CHIPS]
    print('kernels: ["forecast_mlp_forward"]')
    print(json.dumps({"kernels": [{
        "name": "forecast_mlp_forward",
        "route": "cuda",
        "source": "headlamp_tpu_torch/kernels/forecast_mlp.cu",
        "replaces": "headlamp_tpu/models/pallas_forward.py:155",
        "launches": (page_launches + scale_launches + one_launches + serve_launches
                     + cluster_launches + viewport_launches + live_launches + registry_launches
                     + mesh_launches + replay_launches + telemetry_launches
                     + gateway_launches + push_launches + replication_launches
                     + workers_launches + scenarios_launches + intel_launches
                     + capture_close_launches),
        "launches_by_path": {"metrics_page": page_launches,
                             f"forecast_{SCALE_CHIPS}_chips": scale_launches,
                             "forecast_1_chip": one_launches,
                             "dashboard_host": serve_launches,
                             "cluster_dashboard": cluster_launches,
                             "fleet_drilldown": viewport_launches,
                             "live_host": live_launches,
                             "program_registry": registry_launches,
                             "mesh": mesh_launches,
                             "record_replay": replay_launches,
                             "slo_self_forecast": telemetry_launches,
                             "gateway_and_transport": gateway_launches,
                             "push_and_fragments": push_launches,
                             "replication": replication_launches,
                             "workers": workers_launches,
                             "scenarios": scenarios_launches,
                             "intel_provider": intel_launches,
                             "close_during_capture": capture_close_launches},
        "max_abs_err": max_err,
        "ms": at["ms"],
        "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"],
        "library_ms": at["library_ms"],
        "launch_floor_ms": floor_ms,
        "rows": SCALE_CHIPS,
    }]}))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

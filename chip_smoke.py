#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernel from the checkout, holds it against its
plain PyTorch version on the card, times it, then drives the port's main
path — the metrics page with its forecast, through the CLI entry point,
and the forecast at fleet scale — and checks that the path went through
the kernel. It exits non-zero at the first failure, and without CUDA or
without the package beside it. The last line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable

ROOT = Path(__file__).resolve().parent

#: Published dense peaks of one H100 SXM at its 700 W limit.
BF16_DENSE_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12

#: Fixed wall clock for the demo's Prometheus range queries.
FIXED_CLOCK = 1785283200.0

#: Batches the kernel is held to its plain version at: edge sizes, the
#: demo page's 64 chips and the at-scale forecast's 4096.
CHECK_ROWS = (1, 3, 64, 200, 256, 4096, 16384)
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
TIMED_CALLS = 200
#: GPU spin queued ahead of the timed calls, so they run back to back on
#: the device and the events time the device, not the host's enqueue.
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


def time_device_ms(torch: Any, fn: Callable[[], Any]) -> tuple[float, float]:
    """(median, mean) device time of one call over TIMED_CALLS calls
    after warm-up: the median from CUDA events around each call, the
    mean from one event pair around all of them."""
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
        forecast_from_history_incremental,
    )
    from headlamp_tpu_torch.server.demo import make_demo_transport

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
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

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

    timings: dict[int, dict[str, Any]] = {}
    for rows in TIME_ROWS:
        x = torch.rand((rows, cfg.window), generator=gen).to(dev)
        kernel_ms, kernel_mean = time_device_ms(torch, lambda: forecast_forward_cuda(params, x))
        plain_ms, plain_mean = time_device_ms(torch, lambda: forecast_forward_reference(params, x))
        library_ms, library_mean = time_device_ms(torch, lambda: library_chain(x))
        b_ms, b_by = bound_ms(rows, cfg.window, cfg.hidden, cfg.horizon)
        timings[rows] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=b_ms, bound_by=b_by)
        print(f"time: rows={rows} kernel_ms={kernel_ms:.6f} plain_ms={plain_ms:.6f} "
              f"library_ms={library_ms:.6f} bound_ms={b_ms:.6f} ({b_by}); means "
              f"{kernel_mean:.6f} {plain_mean:.6f} {library_mean:.6f}")

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

    # 7. The record.
    at = timings[SCALE_CHIPS]
    print('kernels: ["forecast_mlp_forward"]')
    print(json.dumps({"kernels": [{
        "name": "forecast_mlp_forward",
        "route": "cuda",
        "source": "headlamp_tpu_torch/kernels/forecast_mlp.cu",
        "replaces": "headlamp_tpu/models/pallas_forward.py:155",
        "launches": page_launches + scale_launches,
        "launches_by_path": {"metrics_page": page_launches,
                             f"forecast_{SCALE_CHIPS}_chips": scale_launches},
        "max_abs_err": max_err,
        "ms": at["ms"],
        "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"],
        "library_ms": at["library_ms"],
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

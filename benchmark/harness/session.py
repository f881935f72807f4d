"""One run of one cell: set up, measure a window, check, report.

1. Set-up: start the stand-in apiserver in a process of its own, fed
   from the seed; start the load process of the operator clients
   (``spawn``, one thread per operator); build the
   port's ``DashboardApp`` over ``KubeTransport`` on the card, syncing in
   the background, and ``serve()`` it (every GET goes through its request
   gateway; ``serve()`` starts the program registry's captures). Warm
   the traffic's routes with one session drawn apart from the clients';
   where the traffic changes the fleet, apply its first change and paint
   the same session once the background sync has taken it; wait for every capture
   the warm-up scheduled and paint the session once more on the captured
   programs. The work is the same for every seed.
2. Window: release the clients for ``seconds``; the stand-in applies the
   traffic's fleet changes at their offsets into the window. With
   ``trace`` the window runs under ``torch.profiler`` and every request
   trace the program records is kept.
3. After: read the program's counters and the device's peak memory,
   close the server and the stand-in, collect the clients' records, and
   hand the kept answers to the traffic's judge (``judges/<name>.py``).
"""

from __future__ import annotations

import gc
import gzip
import importlib.util
import json
import multiprocessing
import os
import random
import resource
import sys
import tempfile
import time
from typing import Any

from . import client as client_mod
from . import devtrace, standin
from ..fleets import make_fleet
from .readings import Paint, Run, parse_metricsz
from .spec import BENCH_DIR, Cell
from .traffic import Generator

#: Top-level module names that may not be loaded once the window closes.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "headlamp_tpu")

#: Background sync ticks to wait for after the warm fleet change: the tick
#: running when it lands may have listed before it; the next one has it.
TICKS_PER_CHANGE = 2


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole: ``headlamp_tpu_torch`` is not ``headlamp_tpu``."""
    tops = {name.partition(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def load_judge(name: str, bench_dir: Any = BENCH_DIR) -> Any:
    """The judge module ``judges/<name>.py``: a ``judge(...)`` function."""
    path = bench_dir / "judges" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.judges.{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _get_json(browser: client_mod.Browser, path: str) -> dict[str, Any]:
    status, _, body = browser.get(path)
    return json.loads(body) if status == 200 else {}


def _get_text(browser: client_mod.Browser, path: str) -> str:
    status, _, body = browser.get(path)
    return body.decode() if status == 200 else ""


def _warm(browser: client_mod.Browser, paints: list[dict[str, Any]]) -> None:
    for paint in paints:
        status = browser.paint(paint["path"], paint["follow"])[0]
        if status != 200:
            raise RuntimeError(f"warm-up paint {paint['path']} answered {status}")


def _ticks(browser: client_mod.Browser) -> int:
    health = _get_json(browser, "/healthz")
    return int(health.get("runtime", {}).get("background", {}).get("ticks", 0))


def _wait_ticks(browser: client_mod.Browser, after: int, interval_s: float) -> None:
    deadline = time.monotonic() + 30 * interval_s + 60
    while _ticks(browser) < after + TICKS_PER_CHANGE:
        if time.monotonic() > deadline:
            raise RuntimeError("the background sync did not take a fleet change")
        time.sleep(min(interval_s / 4, 0.25))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, t0: float,
             device: str = "cuda", control: bool = False) -> dict[str, Any]:
    """Run ``cell`` once; return the run's record for the result line."""
    ctx = multiprocessing.get_context("spawn")
    traffic, config = cell.traffic, cell.config
    changes = traffic.get("fleet_changes")
    sync_s = float(traffic.get("background_sync_s", 2.0))
    out_dir = tempfile.mkdtemp(prefix="portbench-")
    procs: list[Any] = []
    server = None
    try:
        parent_end, child_end = ctx.Pipe()
        standin_proc = ctx.Process(target=standin.process_main,
                                   args=(config, seed, changes, child_end,
                                         cell.bench_dir / "fleets"),
                                   name="portbench-standin")
        standin_proc.start()
        procs.append(standin_proc)
        # The stand-in draws the same fleet from the seed.
        fleet = make_fleet(config["fleet"], seed, cell.bench_dir / "fleets")
        gen = Generator(traffic, fleet, seed)
        keep_rng = random.Random(f"{seed}:keep")
        keep_spec = traffic.get("keep", {"per_client": 3, "within_first": 30})
        operators = []
        for i in range(int(traffic["clients"])):
            keep = set(keep_rng.sample(range(int(keep_spec["within_first"])),
                                       int(keep_spec["per_client"])))
            operators.append((gen.client_paints(i), keep))
        # The port is known once the host serves: the load process gets
        # it with the window's bounds.
        load_end, load_child = ctx.Pipe()
        procs.append(ctx.Process(target=client_mod.load_main, name="portbench-load",
                                 args=(operators, out_dir, load_child)))
        if not parent_end.poll(120):
            raise RuntimeError("the stand-in did not start")
        standin_port = parent_end.recv()

        import torch

        from headlamp_tpu_torch.models import aot
        from headlamp_tpu_torch.server.app import DashboardApp
        from headlamp_tpu_torch.transport.api_proxy import KubeTransport

        app = DashboardApp(KubeTransport(f"http://127.0.0.1:{standin_port}"), device=device)
        app.start_background_sync(sync_s)
        server = app.serve("127.0.0.1", 0)
        port = int(server.url.rsplit(":", 1)[1])
        for p in procs[1:]:
            p.start()
        browser = client_mod.Browser(port)
        phases = {"served": time.monotonic() - t0}
        aot.registry().wait_ready(600)
        phases["captured"] = time.monotonic() - t0
        session = gen.warmup_paints()
        _warm(browser, session)
        phases["warmed"] = time.monotonic() - t0
        if changes:
            ticks = _ticks(browser)
            parent_end.send(("change", 1))
            if not parent_end.poll(60) or parent_end.recv() != "applied":
                raise RuntimeError("the stand-in did not apply the warm change")
            _wait_ticks(browser, ticks, sync_s)
            _warm(browser, session)
        # A paint may schedule a capture for a shape it met first:
        # capture, then replay, so the window compiles nothing.
        phases["changed"] = time.monotonic() - t0
        aot.registry().join(600)
        _warm(browser, session)
        aot.registry().join(600)
        if device == "cuda":
            # The default stream only: the registry captures on a side
            # stream, and a device-wide synchronize meets a capture.
            torch.cuda.default_stream().synchronize()
        if not load_end.poll(120) or load_end.recv() != "ready":
            raise RuntimeError("the load process did not start")
        metricsz_before = parse_metricsz(_get_text(browser, "/metricsz"))
        healthz_before = _get_json(browser, "/healthz")

        sink: list[dict[str, Any]] = []
        recorder = None
        if trace:
            from headlamp_tpu_torch.obs.trace import trace_ring

            recorder = trace_ring.record

            def record(t: dict[str, Any]) -> None:
                sink.append(t)
                recorder(t)

            trace_ring.record = record
        profiled = devtrace.profiled(torch.device(device)) if trace and device == "cuda" else None
        prof_out: dict[str, Any] = {}
        if profiled is not None:
            prof_out = profiled.__enter__()
        start = time.monotonic() + 0.05
        end = start + seconds
        if changes:
            # Change 1 was set-up's; the window's are 2, 3, ...
            plan = [(start + float(at), 2 + i)
                    for i, at in enumerate(changes.get("at_s", [])) if float(at) < seconds]
            parent_end.send(("schedule", plan))
        gc_clock = _GcClock()
        gc.callbacks.append(gc_clock)
        load_end.send((port, start, end))
        host_cpu0 = _host_cpu_s()
        if not load_end.poll(end - time.monotonic() + 180):
            raise RuntimeError("the load process sent no records")
        sent_records, load_cpu_s = load_end.recv()
        host_cpu_s = _host_cpu_s() - host_cpu0
        gc.callbacks.remove(gc_clock)
        records = sorted((Paint(*r) for r in sent_records), key=lambda p: (p.client, p.index))
        if profiled is not None:
            profiled.__exit__(None, None, None)
        if recorder is not None:
            from headlamp_tpu_torch.obs.trace import trace_ring

            trace_ring.record = recorder
        metricsz_after = parse_metricsz(_get_text(browser, "/metricsz"))
        healthz_after = _get_json(browser, "/healthz")
        browser.close()
        memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
        server.close()
        server = None
        del app
        # The program registry's mesh programs hold a process group; shut
        # it down with the program's own call, as the server's owner would.
        from headlamp_tpu_torch.parallel.mesh import close_process_meshes

        close_process_meshes()
        parent_end.send("stop")
        applied = parent_end.recv() if parent_end.poll(60) else {}
        for p in procs:
            p.join(60)
        forbidden = loaded_forbidden()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        run = Run(
            start=start, end=end, setup_s=start - t0, paints=records,
            metricsz_before=metricsz_before, metricsz_after=metricsz_after,
            healthz_before=healthz_before, healthz_after=healthz_after,
            traces=sink, device=prof_out.get("trace"),
            wall_minus_mono=time.time() - time.monotonic(),
        )
        verdict = load_judge(traffic["judge"], cell.bench_dir).judge(
            cell=cell, fleet=fleet, seed=seed, run=run, kept=_read_kept(out_dir),
            applied=applied, control=control,
        )
        for key in verdict["wrong"]:
            for paint in run.paints:
                if (paint.client, paint.index) == key:
                    paint.ok = False
        limits = config["limits"]
        compared = {
            name: {"value": float(value), "limit": limits.get(name)}
            for name, value in {**verdict["numbers"],
                                "non_200": sum(1 for p in run.paints if p.status != 200)}.items()
        }
        for name, value in verdict.get("control", {}).items():
            compared[f"control.{name}"] = {"value": float(value), "limit": limits.get(name)}
        return {
            "run": run, "compared": compared, "judged": verdict["judged"],
            "notes": verdict["notes"], "forbidden": forbidden,
            "changes_applied": sum(1 for k in applied if k > 1),
            "setup_phases": phases,
            "window": {**_window_notes(run, host_cpu_s, load_cpu_s), "gc": gc_clock.notes(),
                       "runtime": _runtime_deltas(healthz_before, healthz_after)},
            "memory_peak_bytes": int(memory_peak), "kind": kind,
        }
    finally:
        if server is not None:
            server.close()
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
        for name in os.listdir(out_dir):
            os.unlink(os.path.join(out_dir, name))
        os.rmdir(out_dir)


def _host_cpu_s() -> float:
    """The CPU seconds this process (the host's) has used."""
    usage = resource.getrusage(resource.RUSAGE_SELF)
    return usage.ru_utime + usage.ru_stime


def _window_notes(run: Run, host_cpu_s: float, load_cpu_s: float) -> dict[str, Any]:
    """What the window's numbers came from, for the run's standard error:
    the pages done and the stale ones in each fifth of the window, the
    CPU seconds of the host's process and of the load process in it, and
    the mean kB on the wire of each route's pages."""
    fifth = run.seconds / 5
    done = [0] * 5
    stale = [0] * 5
    for p in run.completed():
        k = min(int((p.done - run.start) / fifth), 4)
        done[k] += 1
        stale[k] += p.stale
    by_route: dict[str, list[int]] = {}
    for p in run.paints:
        by_route.setdefault(p.route, []).append(p.nbytes)
    return {"done_by_fifth": done, "stale_by_fifth": stale,
            "host_cpu_s": round(host_cpu_s, 3), "load_cpu_s": round(load_cpu_s, 3),
            "wire_kb": {r: round(sum(v) / len(v) / 1000, 1) for r, v in sorted(by_route.items())}}


class _GcClock:
    """A ``gc.callbacks`` entry: the host process's collections in the
    window, and the seconds they held the interpreter, by generation."""

    def __init__(self) -> None:
        self.counts = [0, 0, 0]
        self.seconds = [0.0, 0.0, 0.0]
        self._t = 0.0

    def __call__(self, phase: str, info: dict[str, Any]) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = int(info.get("generation", 0))
            self.counts[g] += 1
            self.seconds[g] += time.perf_counter() - self._t

    def notes(self) -> dict[str, Any]:
        return {"collections": self.counts, "seconds": [round(x, 3) for x in self.seconds]}


#: ``/healthz`` runtime blocks whose counters describe a window.
_RUNTIME_BLOCKS = ("background", "watch", "fleet_cache", "graphs", "aot", "transfer")


def _runtime_deltas(before: dict[str, Any], after: dict[str, Any]) -> dict[str, float]:
    """The program's ``/healthz`` runtime counters that moved in the
    window, as ``block.name: delta``."""
    out: dict[str, float] = {}

    def walk(prefix: str, a: Any, b: Any) -> None:
        if isinstance(b, dict):
            for k, v in b.items():
                if k != "programs" and isinstance(a, dict):
                    walk(f"{prefix}.{k}", a.get(k), v)
        elif isinstance(b, (int, float)) and not isinstance(b, bool) and isinstance(a, (int, float)):
            if b != a:
                out[prefix] = round(b - a, 3)

    rb, ra = before.get("runtime", {}), after.get("runtime", {})
    for block in _RUNTIME_BLOCKS:
        walk(block, rb.get(block), ra.get(block))
    return out


def _read_kept(out_dir: str) -> list[tuple[int, int, str, str]]:
    """The kept answers: ``(client, paint index, final path, body)``."""
    out = []
    for name in sorted(os.listdir(out_dir)):
        c, p = name.split(".")[0][1:].split("-p")
        with gzip.open(os.path.join(out_dir, name), "rb") as f:
            path, _, body = f.read().partition(b"\n")
        out.append((int(c), int(p), path.decode(), body.decode()))
    return out

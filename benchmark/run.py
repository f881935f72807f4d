"""Run one cell of the port's benchmark once and print its result line.

    python3 -m benchmark.run --workload v5e16k.drilldown --seed 7 --seconds 51 --trace 0

Hosts the PyTorch port (``headlamp_tpu_torch``) as it is deployed, on the
CUDA card, over its real transport to a stand-in apiserver drawn from
``--seed``, drives it with operator clients (a load process of their
own) for ``--seconds``, checks the answers against the plain reference
under ``benchmark/reference/``, and prints one JSON object as the last
line of standard output. With ``--trace 1`` the metrics are the cell's per-layer
ones, read from the program's request traces, its counters and the
device trace. Without a card, or with fewer cards than the cell asks
for, it prints no result and exits 2. See ``benchmark/README.md``.

Module level imports only the standard library: the client and stand-in
processes start with ``spawn`` and import this module again.
"""

from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / ".cache"


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False,
        )
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def _fmt(value: float) -> str:
    return repr(float(value))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", type=int, choices=(0, 1), default=0,
                        help="also judge the control (benchmark/controls.py); never in a "
                        "benchmark run")
    args = parser.parse_args(argv)

    # Every build and kernel cache at a fixed path inside the checkout
    # (the port's own kernel builds go to headlamp_tpu_torch/kernels/_build).
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")

    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark.run: needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    limit = _power_limit()
    from benchmark.harness import report, session

    record = session.run_cell(cell, args.seed, args.seconds, bool(args.trace), t0=T0,
                              device="cuda", control=bool(args.control))
    if record["forbidden"]:
        print("benchmark.run: modules of JAX or the JAX package were loaded: "
              + ", ".join(record["forbidden"]), file=sys.stderr)
        return 3
    line = report.result_line(cell, record, bool(args.trace))
    for note in record["notes"]:
        print(f"mismatch: {note}", file=sys.stderr)
    print(f"card: {limit}; setup_s {_fmt(record['run'].setup_s)}; judged "
          f"{json.dumps(record['judged'])}; fleet changes in the window "
          f"{record['changes_applied']}; set-up phases (s from start) "
          f"{json.dumps(record['setup_phases'])}; stale paints "
          f"{sum(p.stale for p in record['run'].paints)}", file=sys.stderr)
    print(f"window: {json.dumps(record['window'])}", file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"compared: {name} = {_fmt(c['value'])} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Read a cell's compared numbers for the program, its control and its faults.

    python3 -m benchmark.controls --workload v5e16k.drilldown --seeds 11,12,13 --seconds 51
    python3 -m benchmark.controls --workload v5e16k.drilldown --seeds 11,12,13 --fault state_unchanged

Runs the cell once per seed, each run a process of its own. Without
``--fault`` the control is judged beside the program: the same kept
answers compared once against the plain reference and once against the
control, the reference with its counts summed in float16, which breaks
the configuration's exact counts. With ``--fault`` the program runs with
that fault planted under the timed path:

- ``state_unchanged``: the background sync reads the apiserver's watch
  events and drops them, so the pages keep the fleet generation they had.

Prints one line per seed with every compared number and its limit. The
limits in ``configs/`` are set from these readings (``PERF.md`` keeps
them). The benchmark's own runs never judge the control or plant a fault.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _plant(fault: str) -> None:
    if fault == "state_unchanged":
        from headlamp_tpu_torch.context import accelerator_context

        accelerator_context.AcceleratorDataContext._apply_watch_events = (
            lambda self, track, events: 0
        )
    else:
        raise ValueError(f"no fault {fault!r}")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark.controls")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=51.0)
    parser.add_argument("--fault", choices=("state_unchanged",))
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    run_args = ["--workload", args.workload, "--seconds", str(args.seconds), "--trace", "0"]
    if args.one:
        from benchmark import run

        if args.fault:
            _plant(args.fault)
        return run.main(run_args + ["--seed", args.seeds,
                                    "--control", "0" if args.fault else "1"])
    status = 0
    for seed in args.seeds.split(","):
        cmd = [sys.executable, "-m", "benchmark.controls", "--one", "--seeds", seed,
               "--workload", args.workload, "--seconds", str(args.seconds)]
        if args.fault:
            cmd += ["--fault", args.fault]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, check=False)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(f"seed {seed}: exit {proc.returncode}\n{proc.stderr[-2000:]}", flush=True)
            status = 1
            continue
        line = json.loads(lines[-1])
        print(json.dumps({
            "seed": int(seed), "fault": args.fault, "correct": line["correct"],
            "readings": {k: v["value"] for k, v in line["compared"].items()},
            "limits": {k: v["limit"] for k, v in line["compared"].items()},
        }), flush=True)
    return status


if __name__ == "__main__":
    sys.exit(main())

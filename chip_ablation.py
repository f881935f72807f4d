#!/usr/bin/env python3
"""Where the forecaster kernel's time goes, by ablation, on a CUDA card.

    python3 chip_ablation.py [--rows 64 4096 16384]

Builds ``forecast_mlp.cu`` as it is and in variants that each take one
part out (by text substitution on the source, so a variant can never
drift from the kernel it ablates), then times every variant with CUDA
events at the main path's widths (32, 128, 8). A variant computes wrong
values; only its time is read. The differences between the rows say
what each part costs: the tanh-GELU epilogues, the bf16 conversion pass,
the weights' bulk copies, the tiles' own path (``weights_only`` skips
every tile), a second warpgroup per block, and the launch of a block of
this size (``no_layers`` returns at once).
Prints one line per variant and a JSON object with every median, timed
with chip_smoke.py's device timer. A diagnostic, not part of the
package: a substitution that no longer matches the kernel's text raises.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from chip_smoke import time_device_ms  # noqa: E402
from headlamp_tpu_torch.kernels import build  # noqa: E402

#: (name, [(text in forecast_mlp.cu, replacement), ...]).
VARIANTS: list[tuple[str, list[tuple[str, str]]]] = [
    ("kernel", []),
    ("no_gelu", [("return 0.5f * v * (1.0f + tanhf(inner));", "return v + 0.0f * inner;")]),
    ("no_convert", [("for (int t = threadIdx.x; t < KC * NP; t += kThreads)",
                     "for (int t = threadIdx.x; t < 0; t += kThreads)")]),
    ("no_weights", [("for (int t = threadIdx.x; t < KC * NP; t += kThreads)",
                     "for (int t = threadIdx.x; t < 0; t += kThreads)"),
                    ("  mbar_wait(smem_addr(smem + P::kBars + 8 * L), 0);\n", ""),
                    ("  mbar_expect_tx(bar, w_bytes + b_bytes);\n", "  return;\n")]),
    ("weights_only", [("const bool has = tile < n_tiles;", "const bool has = false;")]),
    ("one_warpgroup", [("constexpr int kWarpgroups = 2;", "constexpr int kWarpgroups = 1;")]),
    ("no_layers", [("  float* sx = reinterpret_cast<float*>(smem + P::kX + wg * P::kXTile);",
                    "  if (a.B > 0) return;\n"
                    "  float* sx = reinterpret_cast<float*>(smem + P::kX + wg * P::kXTile);")]),
]


def variant_source(source: str, subs: list[tuple[str, str]]) -> str:
    for old, new in subs:
        if old not in source:
            raise RuntimeError(f"ablation text not found in forecast_mlp.cu: {old!r}")
        source = source.replace(old, new)
    return source


def build_variants() -> dict[str, ctypes.CDLL]:
    """Compile every variant at once (one nvcc each) and load them."""
    source = (build.KERNEL_DIR / "forecast_mlp.cu").read_text()
    out_dir = build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS:
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(source, subs))
        procs[name] = subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        lib.forecast_mlp_forward.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.forecast_mlp_forward.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, nargs="+", default=[64, 4096, 16384])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablation: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = build_variants()
    gen = torch.Generator().manual_seed(0)
    w, h, z = 32, 128, 8
    shapes = [(w, h), (h,), (h, h), (h,), (h, z), (z,)]
    params = [torch.randn(s, generator=gen).to(dev) * 0.1 for s in shapes]
    one = torch.zeros(1, device=dev)
    results: dict[str, dict[int, float]] = {
        "launch_floor": {0: time_device_ms(lambda: one.add_(1.0))[0]}
    }
    stream = torch.cuda.current_stream().cuda_stream
    for rows in args.rows:
        x = torch.rand((rows, w), generator=gen).to(dev)
        out = torch.empty((rows, z), device=dev)
        ptrs = [x.data_ptr(), *(p.data_ptr() for p in params), out.data_ptr()]
        for name, lib in libs.items():
            def call(lib: ctypes.CDLL = lib) -> None:
                err = lib.forecast_mlp_forward(*ptrs, rows, w, h, z, stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
            results.setdefault(name, {})[rows] = time_device_ms(call)[0]
    for name, by_rows in results.items():
        print(f"{name:>12}: " + "  ".join(f"rows={r} {ms:.6f} ms" for r, ms in by_rows.items()))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build the port's CUDA kernels from this directory's ``.cu`` sources.

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, at first use, into ``_build/<sha256 of source and flags>/``
next to this file, and loads with ``ctypes``. A source compiled once is
a cache hit afterwards, with nvcc's ptxas report read back from beside
the library; an edited source gets a new directory. No
PyTorch headers are involved, so a build takes seconds. A failed build
raises with nvcc's output; nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR / "_build"

#: ``-Xptxas -v`` makes ptxas report registers, shared memory and spills
#: per kernel; the report is kept in :attr:`BuildInfo.log`.
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-Xcompiler",
    "-fPIC",
    "-shared",
    "-Xptxas",
    "-v",
)


@dataclass(frozen=True)
class BuildInfo:
    library: Path
    seconds: float      #: nvcc wall time; 0.0 on a cache hit
    cache_hit: bool
    log: str            #: nvcc's stderr (ptxas report), kept beside the library


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(Path(os.environ[var]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(name: str) -> BuildInfo:
    """Compile ``<name>.cu`` unless its library is already built."""
    source = KERNEL_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()
    out_dir = BUILD_DIR / digest
    library = out_dir / f"lib{name}.so"
    log = out_dir / f"lib{name}.log"
    if library.is_file() and log.is_file():
        return BuildInfo(library, 0.0, True, log.read_text())
    out_dir.mkdir(parents=True, exist_ok=True)
    # Build under private names and rename, the log first: concurrent
    # builds of the same source never load a half-written library, and a
    # library on disk always has its ptxas report beside it.
    private = f"{os.getpid()}.{threading.get_ident()}"
    partial = out_dir / f".lib{name}.{private}.so"
    partial_log = out_dir / f".lib{name}.{private}.log"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-o", str(partial), str(source)],
        capture_output=True,
        text=True,
        check=False,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        partial.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {source.name} (exit {proc.returncode}):\n"
            f"{proc.stderr}{proc.stdout}"
        )
    partial_log.write_text(proc.stderr)
    os.replace(partial_log, log)
    os.replace(partial, library)
    return BuildInfo(library, seconds, False, proc.stderr)


_lock = threading.Lock()
_loaded: dict[str, tuple[ctypes.CDLL, BuildInfo]] = {}


def load(name: str) -> tuple[ctypes.CDLL, BuildInfo]:
    """Build (first call only) and load ``<name>.cu``'s library. The
    handle is kept for the life of the process, as a loaded library
    cannot be unloaded safely while kernels it launched may run."""
    with _lock:
        if name not in _loaded:
            info = build(name)
            _loaded[name] = (ctypes.CDLL(str(info.library)), info)
        return _loaded[name]

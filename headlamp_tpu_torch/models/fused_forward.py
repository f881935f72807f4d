"""Fused forecaster inference: the CUDA kernel, its host wrapper and its
plain PyTorch version.

The counterpart of ``headlamp_tpu/models/pallas_forward.py``, whose
Pallas kernel computed ``sigmoid(gelu(gelu(x@w1+b1)@w2+b2)@w3+b3)`` per
128-row tile with every weight resident on chip. Here the kernel is
hand-written CUDA C++ for Hopper (``kernels/forecast_mlp.cu``: ``wgmma``
on bf16 with f32 accumulation, weights and x tiles staged by
``cp.async.bulk``, persistent 64-row tiles), built by ``nvcc`` at first
use. It takes the true widths (no 128-lane padding) and keeps the TPU
kernel's single-tile guard: every dimension ≤ 128. Its bulk copies need
every operand to start on a 16-byte boundary.

- :func:`forecast_forward_cuda` launches the kernel on a CUDA tensor,
  on PyTorch's current stream, without syncing the host.
- :func:`forecast_forward_reference` is the plain version: the torch
  forward with bf16-rounded operands and tanh-GELU. It serves the tests
  and the CPU; it is never used for a CUDA tensor.
- :func:`forecast_forward` picks between them by the input's device
  alone. There is no fallback: a kernel that fails to build or launch
  raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Iterator

import torch

from ..kernels import build
from .forecast import PARAM_NAMES, Params, forward

#: Every dimension must fit this width (the TPU kernel's lane width,
#: kept as the CUDA kernel's bound on shared memory and registers).
MAX_DIM = 128
#: Operand alignment in bytes: the kernel stages operands by bulk copy.
ALIGN = 16


class LaunchCount:
    """Kernel launches since the last :meth:`reset`; a run can show with
    it that its path went through the kernel. Request threads and
    background refits launch concurrently, so every update holds a lock
    and their launches add up exactly.

    A CUDA graph calls the wrapper once, at capture, and launches the
    kernel on every replay without calling it again. So the thread that
    warms up and captures a graph tallies its launches apart
    (:meth:`tally`), where they count for no path, and each replay adds
    its graph's tally (``models/aot.py``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._local = threading.local()
        self.n = 0

    def add(self, count: int = 1) -> None:
        tally = getattr(self._local, "tally", None)
        if tally is not None:
            tally[0] += count
            return
        with self._lock:
            self.n += count

    @contextlib.contextmanager
    def tally(self) -> Iterator[list[int]]:
        """Tally this thread's launches inside the block in the yielded
        one-element list instead of the count."""
        outer = getattr(self._local, "tally", None)
        self._local.tally = tally = [0]
        try:
            yield tally
        finally:
            self._local.tally = outer

    def reset(self) -> None:
        with self._lock:
            self.n = 0


#: Launches of ``forecast_mlp_forward``, counted where it is launched.
LAUNCHES = LaunchCount()


def check_single_tile(window: int, hidden: int, horizon: int) -> None:
    """Raise unless every dimension fits the kernel's width."""
    if hidden > MAX_DIM or window > MAX_DIM or horizon > MAX_DIM:
        raise ValueError(
            f"window={window}, hidden={hidden}, horizon={horizon}: every "
            f"dimension must fit the single-tile kernel width {MAX_DIM}"
        )


def forecast_forward_reference(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: [batch, window] -> [batch,
    horizon], operands rounded to bf16, f32 products and sums."""
    with torch.no_grad():
        return forward(params, x)


_lib: ctypes.CDLL | None = None
_build_info: build.BuildInfo | None = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel's C interface, once even
    when several threads launch first at the same time."""
    global _lib, _build_info
    with _lib_lock:
        if _lib is None:
            lib, _build_info = build.load("forecast_mlp")
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.forecast_mlp_forward.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
            lib.forecast_mlp_forward.restype = i32
            lib.forecast_mlp_error_string.argtypes = [i32]
            lib.forecast_mlp_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def kernel_build_info() -> build.BuildInfo | None:
    """How this process got the kernel's library (built or a cache hit,
    nvcc's seconds), or None before its first launch."""
    return _build_info


def _check_operands(params: Params, x: torch.Tensor) -> tuple[int, int, int, int]:
    """(B, W, H, Z) after checking every operand's device, dtype,
    contiguity and shape against the kernel's interface."""
    if x.dim() != 2:
        raise ValueError(f"x must be [batch, window], got shape {tuple(x.shape)}")
    batch, window = x.shape
    hidden = params["w1"].shape[-1]
    horizon = params["w3"].shape[-1]
    check_single_tile(window, hidden, horizon)
    expected = {
        "w1": (window, hidden), "b1": (hidden,),
        "w2": (hidden, hidden), "b2": (hidden,),
        "w3": (hidden, horizon), "b3": (horizon,),
    }
    for name, t in [("x", x)] + [(n, params[n]) for n in PARAM_NAMES]:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % ALIGN:
            raise ValueError(
                f"{name} must start on a {ALIGN}-byte aligned address for the "
                f"kernel's bulk copies (data_ptr {t.data_ptr():#x})"
            )
        if name != "x" and tuple(t.shape) != expected[name]:
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, expected {expected[name]}"
            )
    return batch, window, hidden, horizon


def forecast_forward_cuda(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Launch the fused kernel: [batch, window] -> [batch, horizon], all
    f32 and contiguous on one CUDA device. Raises on a bad operand or a
    refused launch; never syncs the host."""
    if x.device.type != "cuda":
        raise ValueError(f"forecast_forward_cuda needs a CUDA tensor, got {x.device}")
    batch, window, hidden, horizon = _check_operands(params, x)
    out = torch.empty((batch, horizon), device=x.device, dtype=torch.float32)
    if batch == 0:
        return out
    lib = _library()
    # The current stream is per thread: a request or refit thread
    # launches on the stream its own fit's torch ops ran on, so the
    # kernel is ordered after the ops that made its operands.
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.forecast_mlp_forward(
            x.data_ptr(),
            *(params[name].data_ptr() for name in PARAM_NAMES),
            out.data_ptr(),
            batch, window, hidden, horizon,
            stream,
        )
    if err != 0:
        reason = lib.forecast_mlp_error_string(err).decode()
        raise RuntimeError(f"forecast_mlp_forward launch failed: {reason} ({err})")
    LAUNCHES.add()
    return out


def forecast_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Inference entry: the kernel for a CUDA tensor, the plain version
    for a CPU tensor. The same width guard applies to both."""
    if x.device.type == "cuda":
        return forecast_forward_cuda(params, x)
    if x.device.type == "cpu":
        check_single_tile(x.shape[-1], params["w1"].shape[-1], params["w3"].shape[-1])
        return forecast_forward_reference(params, x)
    raise ValueError(f"unsupported device {x.device}")

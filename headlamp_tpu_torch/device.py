"""Device policy shared by every public entry point.

Entry points run on the CUDA device unless the caller asks for the CPU.
There is no silent fallback: without CUDA, a caller that did not ask for
``"cpu"`` gets an error, never a CPU run that looks like a GPU one.
"""

from __future__ import annotations

import torch

DeviceLike = str | torch.device | None


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``. Raises ``RuntimeError`` when a CUDA
    device is asked for (explicitly or by default) and none is present,
    and ``ValueError`` for a device type other than CUDA or CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def canonical_device(device: DeviceLike = None) -> torch.device:
    """:func:`resolve_device` with the card's index: ``cuda`` names the
    current card, so what was keyed by ``cuda`` is found from a tensor
    on ``cuda:0``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev

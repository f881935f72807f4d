"""Windowed-series statistics over the history tier.

The port of ``headlamp_tpu/analytics/trends.py``. For each series: the
point count, the latest value, min, max, mean and the per-step
least-squares slope on the centred step index,
``x = arange(n) - (n-1)/2``, ``slope = sum(x*(v-mean)) / sum(x*x)`` (0
when the denominator is 0), the formula of JAX's ``_stats_jax``.

:func:`series_stats_batch` runs every series of one trend view as one
program of torch ops on the caller's device: the series padded into one
``[S, L]`` float32 tensor with a length vector, reduced in float64 (a
constant series' mean is then its value exactly, so its slope is exactly
0), and the ``[S, 6]`` results copied to the host once through
``runtime.transfer`` (JAX reads five scalars per series). An error
propagates. :func:`python_series_stats` is the plain version, the loop
JAX runs on a host without jax: the tests' oracle.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..runtime import transfer

#: Column order of the packed result.
STAT_KEYS = ("n", "latest", "min", "max", "mean", "slope_per_step")


def python_series_stats(values: Sequence[float]) -> dict[str, float]:
    """min/max/mean/latest plus a per-step least-squares slope for one
    series, in Python floats. Empty input is a zeroed record, never an
    error: trend pages render during warm-up."""
    vals = [float(v) for v in values]
    if not vals:
        return dict.fromkeys(STAT_KEYS, 0.0)
    n = len(vals)
    mean = sum(vals) / n
    num = 0.0
    denom = 0.0
    for i, v in enumerate(vals):
        x = i - (n - 1) / 2.0
        num += x * (v - mean)
        denom += x * x
    return {
        "n": float(n),
        "latest": vals[-1],
        "min": min(vals),
        "max": max(vals),
        "mean": mean,
        "slope_per_step": num / denom if denom > 0 else 0.0,
    }


def series_stats_tensor(values: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The statistics of ``S`` padded series as one ``[S, 6]`` float64
    tensor in :data:`STAT_KEYS` order. ``values`` is ``[S, L]`` float32,
    row ``i`` valid in its first ``lengths[i]`` columns; an empty row is
    all zeros."""
    # Python scalars, never a scalar tensor built on the host: a host
    # scalar copied to the card would be a synchronous upload mid-program.
    v = values.to(torch.float64)
    n = lengths.to(torch.float64).unsqueeze(1)
    steps = torch.arange(v.shape[1], device=v.device, dtype=torch.float64).unsqueeze(0)
    valid = steps < n
    count = n.squeeze(1)
    mean = torch.where(valid, v, 0.0).sum(1) / count.clamp(min=1.0)
    x = torch.where(valid, steps - (n - 1.0) / 2.0, 0.0)
    denom = (x * x).sum(1)
    num = (x * (v - mean.unsqueeze(1))).sum(1)
    slope = torch.where(denom > 0, num / denom.clamp(min=1.0), 0.0)
    lo = torch.where(valid, v, float("inf")).amin(1)
    hi = torch.where(valid, v, float("-inf")).amax(1)
    last = (lengths.to(torch.long) - 1).clamp(min=0).unsqueeze(1)
    latest = v.gather(1, last).squeeze(1)
    out = torch.stack([count, latest, lo, hi, mean, slope], dim=1)
    return torch.where((count > 0).unsqueeze(1), out, 0.0)


def series_stats_batch(
    series: Sequence[Sequence[float]], *, device: DeviceLike = None
) -> list[dict[str, float]]:
    """Statistics of every series in one program on ``device`` (CUDA
    unless the caller asks for ``"cpu"``) and one copy back. No series:
    no device work."""
    dev = resolve_device(device)
    if not series:
        return []
    lengths = np.array([len(s) for s in series], dtype=np.int32)
    padded = np.zeros((len(series), max(1, int(lengths.max()))), dtype=np.float32)
    for row, values in enumerate(series):
        padded[row, : len(values)] = values
    out = transfer.fetch(
        series_stats_tensor(torch.from_numpy(padded).to(dev), torch.from_numpy(lengths).to(dev))
    )
    return [dict(zip(STAT_KEYS, row)) for row in out.tolist()]


def series_stats(values: Sequence[float], *, device: DeviceLike = None) -> dict[str, float]:
    """The statistics of one series: :func:`series_stats_batch` of one."""
    return series_stats_batch([list(values)], device=device)[0]


__all__ = [
    "STAT_KEYS",
    "python_series_stats",
    "series_stats",
    "series_stats_batch",
    "series_stats_tensor",
]

"""Display formatters for metric values.

The TPU analogue of the reference's ``formatWatts``/``formatPercent``
(`src/api/metrics.ts:161-168`): tiny, total functions the
pages and tests share.
"""

from __future__ import annotations


def format_percent(fraction: float | None, digits: int = 1) -> str:
    """0.874 -> '87.4%'. None (metric unavailable) -> '—'. Values already
    in percent (>1.5) are assumed pre-scaled — the tpu-device-plugin and
    libtpu exporters disagree on 0-1 vs 0-100 scaling, so the formatter
    normalizes rather than trusting either. The result is clamped to
    [0, 100]: every caller formats a utilization/duty-cycle fraction,
    which cannot legitimately exceed 100%. The clamp only bounds the
    residue the client's per-series scale detection (FRACTION_MAX in
    metrics.client) cannot resolve — rate jitter fractionally above 1.0
    — so nothing real is hidden by it."""
    if fraction is None:
        return "—"
    pct = fraction * 100 if fraction <= 1.5 else fraction
    pct = min(max(pct, 0.0), 100.0)
    return f"{pct:.{digits}f}%"


def normalize_fraction(value: float | None) -> float | None:
    """Scale-tolerant 0-1 normalization (0-100 inputs divided down)."""
    if value is None:
        return None
    return value / 100 if value > 1.5 else value


_BYTE_UNITS = ("B", "KiB", "MiB", "GiB", "TiB", "PiB")


def format_bytes(n: float | None) -> str:
    """16106127360 -> '15.0 GiB'. None -> '—'."""
    if n is None:
        return "—"
    value = float(n)
    for unit in _BYTE_UNITS:
        if abs(value) < 1024 or unit == _BYTE_UNITS[-1]:
            if unit == "B":
                return f"{int(value)} B"
            return f"{value:.1f} {unit}"
        value /= 1024
    return f"{value:.1f} PiB"


def format_ratio_bar(used: float | None, total: float | None) -> str:
    """'12.3 GiB / 15.8 GiB (78%)' — the HBM usage line."""
    if used is None or total is None or total <= 0:
        return "—"
    pct = round(used / total * 100)
    return f"{format_bytes(used)} / {format_bytes(total)} ({pct}%)"

"""The median paint latency in the window, from the clients' clocks: the
steady statistic beside ``http.paint_p95_ms``."""

import statistics


def read(run):
    ms = [p.ms for p in run.paints]
    return statistics.median(ms) if ms else None

"""The 95th percentile (nearest rank) of the latency of every paint sent in
the window, in ms, from the clients' clocks: each paint timed from its
send until its last byte. A per-layer reading: the cell's clients are a
closed loop, so the host runs at its capacity and this tail follows the
queue the loop keeps (``PERF.md`` gives its spreads)."""

import math


def read(run):
    ms = sorted(p.ms for p in run.paints)
    if not ms:
        return None
    return ms[max(math.ceil(0.95 * len(ms)) - 1, 0)]

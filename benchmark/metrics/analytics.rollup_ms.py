"""Mean time of one rollup in the window, in ms: the ``analytics.rollup``
(the fleet rollup) and ``analytics.region_rollup`` (the drill-down
tree's per-cluster and per-slice sums) spans of the request traces. A
rollup runs once per fleet generation, so nothing is read in a window
whose fleet does not change."""


def read(run):
    ms = [s["duration_ms"] for s, _ in run.spans("analytics.rollup", "analytics.region_rollup",
                                                 outermost=True)]
    return sum(ms) / len(ms) if ms else None

"""Mean time of one drill-down tree build in the window, in ms: the
outermost ``viewport.tree`` spans of the request traces (the region
assignment, the region rollup and the members and regions build). A
tree is built once per fleet generation, so nothing is read in a window
whose fleet does not change."""


def read(run):
    ms = [s["duration_ms"] for s, _ in run.spans("viewport.tree", outermost=True)]
    return sum(ms) / len(ms) if ms else None

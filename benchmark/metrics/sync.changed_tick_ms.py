"""Mean time of a background sync tick that built a new snapshot
generation, in ms: the ``/sync`` traces of the window that hold a
``sync.build`` span (the list and watch, the snapshot build, the push
differ, the column upload). A fleet change lands in one or two such
ticks, so nothing is read in a window whose fleet does not change."""

from benchmark.harness.readings import has_span


def read(run):
    ms = [t["duration_ms"] for t in run.window_traces()
          if t.get("route") == "/sync" and has_span(t, "sync.build")]
    return sum(ms) / len(ms) if ms else None

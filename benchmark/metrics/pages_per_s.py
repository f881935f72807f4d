"""Pages answered 200, and judged right where judged, that finished inside
the window, over all clients, per second of the window. A Refresh click
and the page its redirect lands on are one page."""


def read(run):
    return len(run.completed()) / run.seconds

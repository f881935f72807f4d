"""Self time of the page's component build (``page.component``) and its
HTML render (``render.html``) per painted page, in ms, from the window's
request traces."""

from benchmark.harness.readings import has_span, self_ms


def read(run):
    total = sum(self_ms(s) for s, _ in run.spans("page.component", "render.html"))
    pages = sum(1 for t in run.window_traces() if has_span(t, "page.component"))
    return total / pages if pages else None

"""CPU self time of the page's component build (``page.component``) and
its HTML render (``render.html``) per painted page, in ms, from the
window's request traces: each span's ``cpu_ms`` (its thread's CPU while
it was open) less its children's, over the pages counted as
``pages.render_ms`` counts them. Beside ``pages.render_ms`` it tells the
render's own work from its waits for the interpreter lock. None where
the spans carry no CPU time."""

from benchmark.harness.readings import has_span


def read(run):
    spans = [s for s, _ in run.spans("page.component", "render.html")]
    if not spans or any("cpu_ms" not in s for s in spans):
        return None
    total = sum(s["cpu_ms"] - sum(c.get("cpu_ms", 0.0) for c in s.get("children", []))
                for s in spans)
    pages = sum(1 for t in run.window_traces() if has_span(t, "page.component"))
    return total / pages if pages else None

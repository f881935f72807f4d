"""Share of the window's paints the host answered from caches only, in %:
the request gateway's degraded renders (``X-Headlamp-Stale: 1``), which
it serves while a request-backed objective pages."""


def read(run):
    if not run.paints:
        return None
    return 100 * sum(1 for p in run.paints if p.stale) / len(run.paints)

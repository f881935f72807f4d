"""Drill-down tree builds per fleet generation in the window: the count
of the request traces' outermost ``viewport.tree`` spans over the count
of distinct ``generation`` attributes among them. 1 where each
generation is built once; more where concurrent requests each built the
same generation's tree."""


def read(run):
    generations = [s["attrs"].get("generation")
                   for s, _ in run.spans("viewport.tree", outermost=True)]
    return len(generations) / len(set(generations)) if generations else None

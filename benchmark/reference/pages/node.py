"""``/node/<name>``: the node's TPU fields and the TPU pods bound to it."""

from __future__ import annotations

import re

from benchmark.reference import fleet as F
from benchmark.reference import html as H


def check(m: F.Mismatches, facts: F.Facts, path: str, body: str) -> None:
    name = path.rsplit("/", 1)[1]
    node = facts.nodes[name]
    main = H.main(body)
    pairs = H.pairs(main)
    F.check_pairs(m, path, pairs, {
        "Pods on node": len(node.pods),
        "Generation": F.GENERATIONS.get(node.accel, "?"),
        "Topology": node.topology,
        "Chips (capacity)": node.capacity,
        "Chips (allocatable)": node.allocatable,
        "Slice": node.pool,
        "Worker index": node.worker,
    })
    m.check(path, "Chips in use", F.ratio(dict(pairs).get("Chips in use", "")),
            f"{node.in_use}/{node.allocatable}")
    shown = re.findall(r"<li>([^<]+) \((\d+) chips?\)</li>", main)
    expected = sorted(
        (f"{p['metadata']['namespace']}/{p['metadata']['name']}", str(F.pod_chips(p)))
        for p in node.pods if F.pod_chips(p) > 0
    )
    m.check(path, "pods", sorted(shown), expected)

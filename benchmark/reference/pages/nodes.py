"""``/tpu/nodes?limit=64&q=<prefix>``: the total of matching TPU nodes and
the first 64 rows in window order."""

from __future__ import annotations

import re

from benchmark.reference import fleet as F
from benchmark.reference import html as H


def check(m: F.Mismatches, facts: F.Facts, path: str, body: str) -> None:
    main = H.main(body)
    q = re.search(r"[?&]q=([^&]*)", path)
    prefix = q.group(1) if q else ""
    members = F.node_order([n for n in facts.nodes.values()
                           if n.accel and prefix in n.name])
    hint = re.search(r"rows (\d+)–(\d+) of (\d+)", H.text(main))
    m.check(path, "total", hint.group(3) if hint else None, len(members))
    tables = H.tables(main)
    rows = tables[0][1:] if tables else []
    m.check(path, "rows", len(rows), min(len(members), 64))
    for row, node in zip(rows, members):
        tpu_pods = [p for p in node.pods if F.pod_chips(p) > 0]
        m.check(path, "row", [row[0], row[1], row[2], row[3], row[4], F.ratio(row[5]), row[6]], [
            node.name, "Ready" if node.ready else "Not Ready", F.GENERATIONS.get(node.accel, "?"),
            node.topology, str(node.capacity), f"{node.in_use}/{node.allocatable}",
            str(len(tpu_pods)),
        ])

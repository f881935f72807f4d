"""``/pod/<namespace>/<name>``: the pod's phase, node, containers, restarts
and chips."""

from __future__ import annotations

from benchmark.reference import fleet as F
from benchmark.reference import html as H


def check(m: F.Mismatches, facts: F.Facts, path: str, body: str) -> None:
    _, _, ns, name = path.split("/", 3)
    pod = facts.pods[(ns, name)]
    main = H.main(body)
    pairs = dict(H.pairs(main))
    containers = pod["spec"]["containers"]
    restarts = sum(int(s.get("restartCount", 0)) for s in pod["status"].get("containerStatuses", []))
    chips = F.pod_chips(pod)
    expected = {
        "Phase": pod["status"]["phase"],
        "Node": pod["spec"].get("nodeName") or "—",
        "Containers": len(containers),
        "Restarts": restarts,
        "Effective chips": f"{chips} chips" if chips != 1 else "1 chip",
    }
    for key, value in expected.items():
        m.check(path, key, pairs.get(key), value)

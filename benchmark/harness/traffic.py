"""The one traffic generator: a traffic file's sessions, drawn from the seed.

A traffic file (``benchmark/traffic/<name>.json``) gives the number of
operator clients (each a closed loop with no think time), the session
each of them repeats, and how the placeholders in its paths are drawn.
A paint is one page as an operator sees it: a path, with the redirect it
answers followed (a Refresh click and the page it lands on are one
paint).

Placeholders are drawn from the fleet's index:

- ``clusters``: the cluster keys; ``slices_of:<cluster>``: a cluster's
  slices; ``nodes_of:<slice>``: a slice's node names; ``pods_of:<node>``:
  the ``(namespace, name)`` of the pods bound to a node;
- ``zipf`` with exponent ``s`` ranks the members in an order drawn from
  the seed (so which cluster is hot changes with the seed, its size does
  not), ``uniform`` draws any member;
- an ``optional`` draw over an empty set drops the steps that use it.

Every seed gives each client the same number of sessions of the same
shape: only which regions and nodes they name changes.
"""

from __future__ import annotations

import random
import re
from typing import Any

from ..fleets.objects import GKE_NODEPOOL_LABEL, HEADLAMP_CLUSTER_LABEL

#: Sessions drawn per client: more than any client finishes in a window.
SESSIONS_PER_CLIENT = 400

_FIELD = re.compile(r"\{([a-z_]+)\}")


class FleetIndex:
    """The members a draw can name, built once from the fleet."""

    def __init__(self, fleet: dict[str, Any]) -> None:
        self.slices_of: dict[str, list[str]] = {}
        self.nodes_of: dict[str, list[str]] = {}
        for node in fleet["nodes"]:
            labels = node["metadata"].get("labels", {})
            cluster = labels.get(HEADLAMP_CLUSTER_LABEL) or "0"
            pool = labels.get(GKE_NODEPOOL_LABEL)
            if pool is None:
                continue
            if pool not in self.nodes_of:
                self.slices_of.setdefault(cluster, []).append(pool)
            self.nodes_of.setdefault(pool, []).append(node["metadata"]["name"])
        self.clusters = sorted(self.slices_of)
        self.pods_of: dict[str, list[tuple[str, str]]] = {}
        for pod in fleet["pods"]:
            node = pod.get("spec", {}).get("nodeName")
            if node:
                meta = pod["metadata"]
                self.pods_of.setdefault(node, []).append((meta["namespace"], meta["name"]))

    def members(self, source: str, drawn: dict[str, Any]) -> list[Any]:
        kind, _, of = source.partition(":")
        if kind == "clusters":
            return self.clusters
        table = {"slices_of": self.slices_of, "nodes_of": self.nodes_of,
                 "pods_of": self.pods_of}[kind]
        return table.get(drawn[of], [])


def _node_prefix(names: list[str]) -> str:
    """The longest common prefix of a slice's node names: the ``?q=``
    filter that scopes a table to that slice."""
    first, last = min(names), max(names)
    i = 0
    while i < min(len(first), len(last)) and first[i] == last[i]:
        i += 1
    return first[:i]


class Generator:
    def __init__(self, traffic: dict[str, Any], fleet: dict[str, Any], seed: int) -> None:
        self.traffic = traffic
        self.index = FleetIndex(fleet)
        self.seed = seed
        rng = random.Random(f"{seed}:ranks")
        # One rank order per member set, drawn once per run: the hot
        # cluster (and each cluster's hot slice) depends on the seed.
        self._ranks: dict[str, list[Any]] = {}
        self._rank_rng = rng

    def _ranked(self, key: str, members: list[Any]) -> list[Any]:
        ranked = self._ranks.get(key)
        if ranked is None:
            ranked = list(members)
            self._rank_rng.shuffle(ranked)
            self._ranks[key] = ranked
        return ranked

    def _draw(self, rng: random.Random, spec: dict[str, Any], drawn: dict[str, Any],
              key: str) -> Any:
        members = self.index.members(spec["from"], drawn)
        if not members:
            return None
        if spec.get("dist", "uniform") == "zipf":
            ranked = self._ranked(key, members)
            weights = [1.0 / (k + 1) ** float(spec["s"]) for k in range(len(ranked))]
            return rng.choices(ranked, weights=weights)[0]
        return rng.choice(members)

    def session(self, rng: random.Random) -> list[dict[str, Any]]:
        """One session's paints: ``{"path", "route", "follow"}`` each."""
        drawn: dict[str, Any] = {}
        for name, spec in self.traffic.get("draws", {}).items():
            key = f"{name}:{drawn.get(spec['from'].partition(':')[2], '')}"
            drawn[name] = self._draw(rng, spec, drawn, key)
        values: dict[str, str] = {}
        for name, value in drawn.items():
            if isinstance(value, tuple):
                values[f"{name}_ns"], values[f"{name}_name"] = value
            elif value is not None:
                values[name] = str(value)
        if "slice" in values:
            values["slice_prefix"] = _node_prefix(self.index.nodes_of[values["slice"]])
        paints = []
        for step in self.traffic["session"]:
            fields = _FIELD.findall(step["path"])
            if any(f not in values for f in fields):
                continue  # an optional draw came up empty
            paints.append({
                "path": step["path"].format(**values),
                "route": step["route"],
                "follow": bool(step.get("follow", False)),
            })
        return paints

    def client_paints(self, client: int, sessions: int = SESSIONS_PER_CLIENT) -> list[dict[str, Any]]:
        rng = random.Random(f"{self.seed}:client:{client}")
        out: list[dict[str, Any]] = []
        for _ in range(sessions):
            out.extend(self.session(rng))
        return out

    def warmup_paints(self) -> list[dict[str, Any]]:
        """One session, drawn apart from the clients' sessions: every
        route of the traffic once."""
        return self.session(random.Random(f"{self.seed}:warmup"))

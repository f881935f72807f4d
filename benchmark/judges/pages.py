"""Judge the cluster pages a run kept against the plain reference.

Each kept answer is checked by its route's file, ``reference/pages/
<route>.py``, against the facts of the fleet generations it may show.
The stand-in applied the traffic's fleet changes at known times, so the
generations an answer may show are those the apiserver had served by the
time the answer arrived. An answer that matches none of them is wrong,
and every field it shows otherwise than the newest of them is counted in
``page_mismatches``. An answer that matches only a generation the
apiserver had already replaced before the answer was asked for is late:
``generation_lag_s`` is the longest such lag, the seconds between the
replacement and the request.

With ``control`` the same answers are judged a second time against the
control's facts: the reference with its counts summed in float16, a
precision below the configuration's exact integers.

Nothing here imports the program.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Any

from benchmark.fleets import generation
from benchmark.reference import fleet as fleet_ref


#: Mismatched fields kept for standard error.
NOTES = 10


def load_check(route: str, bench_dir: Path = Path(__file__).resolve().parents[1]) -> Any:
    """The ``check`` function of ``reference/pages/<route>.py``."""
    path = bench_dir / "reference" / "pages" / f"{route}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.reference.pages.{route}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.check


def _verdict(check: Any, facts: list[fleet_ref.Facts], since: list[float], path: str, body: str,
             sent: float, done: float) -> tuple[list[str], float | None]:
    """(mismatches against the newest candidate, lag) of one answer; the
    lag is None when no candidate generation matches."""
    candidates = [g for g in range(len(facts)) if since[g] <= done]
    newest: list[str] | None = None
    for g in reversed(candidates):
        m = fleet_ref.Mismatches()
        check(m, facts[g], path, body)
        if not m.items:
            replaced = since[g + 1] if g + 1 < len(since) else float("inf")
            return [], max(sent - replaced, 0.0)
        if newest is None:
            newest = m.items
    return newest or [], None


def judge(*, cell: Any, fleet: dict[str, Any], seed: int, run: Any,
          kept: list[tuple[int, int, str, str]], applied: dict[int, float],
          control: bool) -> dict[str, Any]:
    changes = cell.traffic.get("fleet_changes") or {}
    last = max(applied, default=0)
    fleets = [generation(fleet, seed, changes, g) for g in range(last + 1)]
    # Generation g is what the apiserver served from since[g] on.
    since = [float("-inf")] + [applied.get(g, float("inf")) for g in range(1, last + 1)]
    facts = [fleet_ref.Facts(f) for f in fleets]
    control_facts = [fleet_ref.Facts(f, counts=fleet_ref.half_counts) for f in fleets] if control else []
    route_of = {(p.client, p.index): p for p in run.paints}
    checks: dict[str, Any] = {}
    notes: list[str] = []
    wrong: set[tuple[int, int]] = set()
    mismatches, control_mismatches, lag = 0, 0, 0.0
    for c, i, path, body in kept:
        paint = route_of.get((c, i))
        if paint is None:
            continue
        if paint.route not in checks:
            checks[paint.route] = load_check(paint.route, cell.bench_dir)
        check = checks[paint.route]
        items, late = _verdict(check, facts, since, path, body, paint.sent, paint.done)
        if late is None:
            wrong.add((c, i))
            mismatches += len(items)
            notes.extend(items[: max(NOTES - len(notes), 0)])
        else:
            lag = max(lag, late)
        if control:
            items, late = _verdict(check, control_facts, since, path, body, paint.sent, paint.done)
            control_mismatches += len(items) if late is None else 0
    verdict: dict[str, Any] = {
        "numbers": {"page_mismatches": mismatches, "generation_lag_s": lag},
        "judged": {"answers": len(kept), "generations": len(facts)},
        "notes": notes,
        "wrong": wrong,
    }
    if control:
        verdict["control"] = {"page_mismatches": control_mismatches}
    return verdict

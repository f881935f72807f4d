"""Generation provenance ledger: how old the data was when a user saw it.

The port's copy of ``headlamp_tpu/obs/ledger.py``. A snapshot generation
lives through up to six stages: scraped (``scrape_start``), classified
into a snapshot (``synced``), encoded onto a bus (``published``),
decoded on a replica (``applied``), diffed into push frames
(``diff_framed``) and painted for a user (``first_paint``). The host
stamps the scrape, the sync, the diff and the first paint; a
``replicate.BusPublisher`` stamps ``published`` and ships the
generation's provenance on its record; a ``replicate.ReplicaApp`` stamps
``applied`` against it; the leader elector notes each transition.

:class:`GenerationLedger` stamps each stage on injected clocks (the
monotonic one for every elapsed number, the wall one for display stamps
and for the one cross-process delta a monotonic clock cannot give).
Each stamp observes the lag since the generation's previous stamp into
``headlamp_tpu_torch_generation_stage_seconds{stage}``; a generation's
first paint observes its whole data age into
``headlamp_tpu_torch_generation_age_at_paint_seconds{role}``, inside the
painting request's trace, so its exemplars link to the waterfall. That
histogram feeds the ``data_freshness`` objective (``obs/slo.py``);
generations older than :data:`FRESHNESS_THRESHOLD_S` at their first
paint are pinned, so ``/debug/generationz`` keeps them after the ring
rotates.

Observational only: stamps come after the bytes are built, and the
ledger never raises into a serving path.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Mapping

from .metrics import registry

#: Lifecycle stages in nominal order. Lag is measured against the
#: generation's most recent prior stamp, whichever stage it was.
STAGES = (
    "scrape_start",
    "synced",
    "published",
    "applied",
    "diff_framed",
    "first_paint",
)

#: Recent generations kept, and freshness breaches pinned past rotation.
LEDGER_CAPACITY = 64
PINNED_CAPACITY = 16

#: Data age at first paint past which a generation breaches the
#: ``data_freshness`` objective: between the 5 s metrics TTL and a
#: replica's 30 s stale-paint threshold.
FRESHNESS_THRESHOLD_S = 10.0

STAGE_SECONDS_NAME = "headlamp_tpu_torch_generation_stage_seconds"
AGE_AT_PAINT_NAME = "headlamp_tpu_torch_generation_age_at_paint_seconds"
#: Help text of the age histogram, shared with the SLO engine's feed.
AGE_AT_PAINT_HELP = "Age of a generation's data (since scrape start) at its first paint"

_STAGE_SECONDS = registry.histogram(
    STAGE_SECONDS_NAME,
    "Lag between consecutive lifecycle stages of a snapshot generation",
    labels=("stage",),
)
_AGE_AT_PAINT = registry.histogram(AGE_AT_PAINT_NAME, AGE_AT_PAINT_HELP, labels=("role",))


class GenerationLedger:
    """Per-app lifecycle ledger, written by the sync loop and the request
    threads; thread-safe."""

    def __init__(
        self,
        *,
        monotonic: Callable[[], float] | None = None,
        wall: Callable[[], float] = time.time,
        role: str = "leader",
        capacity: int = LEDGER_CAPACITY,
        pinned_capacity: int = PINNED_CAPACITY,
        freshness_threshold_s: float = FRESHNESS_THRESHOLD_S,
    ) -> None:
        self._mono = monotonic or time.monotonic
        self._wall = wall
        self.role = role
        self.capacity = int(capacity)
        self.freshness_threshold_s = float(freshness_threshold_s)
        self._lock = threading.Lock()
        self._entries: OrderedDict[int, dict[str, Any]] = OrderedDict()
        self._pinned: OrderedDict[int, dict[str, Any]] = OrderedDict()
        self._pinned_capacity = int(pinned_capacity)
        #: (mono, wall) of the scrape that will become the next synced
        #: generation, stamped before its number exists.
        self._pending_scrape: tuple[float, float] | None = None
        #: Leadership transitions, shown on the generationz timeline.
        self._transitions: deque[dict[str, Any]] = deque(maxlen=16)
        self.breaches = 0

    # -- stamping ---------------------------------------------------------

    def _entry(self, generation: int) -> dict[str, Any]:
        entry = self._entries.get(generation)
        if entry is None:
            entry = {
                "generation": int(generation),
                "role": self.role,
                "stages": {},
                "trace_ids": {},
                "origin": None,
                "age_at_paint_ms": None,
                "breached": False,
            }
            self._entries[generation] = entry
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
        return entry

    def _stamp(
        self,
        generation: int,
        stage: str,
        *,
        trace_id: str | None = None,
        origin_wall: float | None = None,
    ) -> bool:
        """Stamp ``stage`` for ``generation`` (the first stamp wins) and
        observe the lag since the generation's latest prior stamp, or,
        for a first replica-side stage, since ``origin_wall`` (clamped at
        0 against skew). True iff this call stamped the stage."""
        if generation is None or generation <= 0:
            return False
        now_mono, now_wall = self._mono(), self._wall()
        with self._lock:
            entry = self._entry(generation)
            stages = entry["stages"]
            if stage in stages:
                return False
            lag_s: float | None = None
            prior = max((s["mono"] for s in stages.values()), default=None)
            if prior is not None:
                lag_s = max(now_mono - prior, 0.0)
            elif origin_wall is not None:
                lag_s = max(now_wall - origin_wall, 0.0)
            stages[stage] = {
                "mono": now_mono,
                "wall": now_wall,
                "lag_ms": None if lag_s is None else round(lag_s * 1000, 3),
            }
            if trace_id:
                entry["trace_ids"][stage] = trace_id
        if lag_s is not None:
            _STAGE_SECONDS.observe(lag_s, stage=stage)
        return True

    def scrape_started(self) -> None:
        """A scrape is in flight; the latest one wins."""
        with self._lock:
            self._pending_scrape = (self._mono(), self._wall())

    def synced(self, generation: int, *, trace_id: str | None = None) -> None:
        """The scrape became snapshot ``generation``: the pending scrape
        stamp becomes its ``scrape_start``, then ``synced`` is stamped."""
        if generation is None or generation <= 0:
            return
        with self._lock:
            pending, self._pending_scrape = self._pending_scrape, None
            entry = self._entry(generation)
            if pending is not None and "scrape_start" not in entry["stages"]:
                entry["stages"]["scrape_start"] = {
                    "mono": pending[0],
                    "wall": pending[1],
                    "lag_ms": None,
                }
        self._stamp(generation, "synced", trace_id=trace_id)

    def published(self, generation: int, *, trace_id: str | None = None) -> None:
        self._stamp(generation, "published", trace_id=trace_id)

    def applied(
        self,
        generation: int,
        *,
        origin: Mapping[str, Any] | None = None,
        trace_id: str | None = None,
    ) -> None:
        """Replica side: keep the leader's provenance as the generation's
        origin and stamp ``applied``, its lag measured from the leader's
        latest wall stamp."""
        if generation is None or generation <= 0:
            return
        origin_wall = None
        if origin:
            with self._lock:
                self._entry(generation)["origin"] = dict(origin)
            for key in ("published_wall", "synced_wall", "scrape_start_wall"):
                if isinstance(origin.get(key), (int, float)):
                    origin_wall = float(origin[key])
                    break
        self._stamp(generation, "applied", trace_id=trace_id, origin_wall=origin_wall)

    def diff_framed(self, generation: int) -> None:
        self._stamp(generation, "diff_framed")

    def paint(self, generation: int, *, trace_id: str | None = None) -> float | None:
        """First paint of ``generation``: stamp ``first_paint`` and
        observe its data age (scrape start to this paint). Later paints
        of the generation do nothing. Returns the age in seconds, or None
        off the first paint or without a scrape anchor."""
        if not self._stamp(generation, "first_paint", trace_id=trace_id):
            return None
        with self._lock:
            entry = self._entries.get(generation)
            if entry is None:
                return None
            stamp = entry["stages"]["first_paint"]
            age_s: float | None = None
            anchor = entry["stages"].get("scrape_start")
            if anchor is not None:
                age_s = max(stamp["mono"] - anchor["mono"], 0.0)
            else:
                origin_scrape = (entry["origin"] or {}).get("scrape_start_wall")
                if isinstance(origin_scrape, (int, float)):
                    age_s = max(stamp["wall"] - float(origin_scrape), 0.0)
            if age_s is None:
                return None
            entry["age_at_paint_ms"] = round(age_s * 1000, 3)
            breached = age_s > self.freshness_threshold_s
            entry["breached"] = breached
            if breached:
                self.breaches += 1
                self._pinned[entry["generation"]] = entry
                while len(self._pinned) > self._pinned_capacity:
                    self._pinned.popitem(last=False)
        _AGE_AT_PAINT.observe(age_s, role=self.role)
        return age_s

    def note_transition(self, kind: str, *, fencing: int = 0) -> None:
        """An election or deposition, for the generationz timeline."""
        with self._lock:
            self._transitions.append({"kind": kind, "fencing": int(fencing), "wall": self._wall()})

    # -- reading ----------------------------------------------------------

    def provenance(self, generation: int) -> dict[str, Any] | None:
        """The compact record a bus would ship beside the generation: the
        publishing trace id and the leader's wall stamps, or None."""
        with self._lock:
            entry = self._entries.get(generation)
            if entry is None:
                return None
            out: dict[str, Any] = {}
            trace_id = entry["trace_ids"].get("published") or entry["trace_ids"].get("synced")
            if trace_id:
                out["trace_id"] = trace_id
            for stage in ("scrape_start", "synced", "published"):
                stamp = entry["stages"].get(stage)
                if stamp is not None:
                    out[f"{stage}_wall"] = round(stamp["wall"], 6)
            return out or None

    def _render(self, entry: dict[str, Any]) -> dict[str, Any]:
        stages = {
            stage: {"wall": round(stamp["wall"], 3), "lag_ms": stamp["lag_ms"]}
            for stage, stamp in entry["stages"].items()
        }
        return {
            "generation": entry["generation"],
            "role": entry["role"],
            "stages": {s: stages[s] for s in STAGES if s in stages},
            "trace_ids": dict(entry["trace_ids"]),
            "origin": dict(entry["origin"]) if entry["origin"] else None,
            "age_at_paint_ms": entry["age_at_paint_ms"],
            "breached": entry["breached"],
        }

    def snapshot(self) -> dict[str, Any]:
        """The ``/debug/generationz`` body: recent generations newest
        first, breaches pinned past rotation, transitions."""
        with self._lock:
            return {
                "role": self.role,
                "freshness_threshold_s": self.freshness_threshold_s,
                "breaches": self.breaches,
                "generations": [self._render(e) for e in reversed(self._entries.values())],
                "pinned": [
                    self._render(e)
                    for e in reversed(self._pinned.values())
                    if e["generation"] not in self._entries
                ],
                "transitions": list(self._transitions),
            }

"""SLO engine: declarative objectives and multi-window burn-rate alerting.

The port's copy of ``headlamp_tpu/obs/slo.py``. Five objectives ship by
default (scrape→paint, dashboard render, forecast fit, transport connect
and data freshness), each a latency threshold with an availability
target. Their good and bad events come from the registry instruments
the serving layers already write, through observers on those histograms
and counters (``obs/metrics.py``): the producers know nothing of SLOs,
and the observers resolve :func:`engine` per event, so swapping the
engine re-points every feed.

Evaluation follows the SRE Workbook's multi-window, multi-burn-rate
method: burn rate = (bad fraction over a window) / (error budget).
``page`` needs both fast windows (5m and 1h) at 14.4× or more; ``warn``
needs both slow windows (30m and 6h) at 6× or more. Windows are counted
in 60 s slots on the engine's injected monotonic clock, so tests drive
ok→warn→page and the recovery by advancing a list cell.

Self-forecast: the scrape→paint latency series (the engine's own, or
its mirror in the host's history store once that holds enough points)
is fit by ``models.service.forecast_slo_burn`` on the engine's device,
behind a stale-while-revalidate :class:`~..runtime.refresh.Refresher`
read without blocking, and ``/sloz`` projects the budget's exhaustion
from the predicted latencies. A fit that raises is recorded: ``/sloz``
reports ``fit_failed`` with the error and the host's ``/healthz`` turns
``ok`` false until a later fit succeeds.

Surfaces: ``GET /sloz`` (:meth:`SLOEngine.report`), ``/sloz/html``,
the per-SLO gauges on ``/metricsz`` and ``runtime.slo`` in ``/healthz``,
all served by ``server/app.py``.
"""

from __future__ import annotations

import math
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

from .exemplars import exemplars_matching
from .ledger import AGE_AT_PAINT_HELP, AGE_AT_PAINT_NAME, FRESHNESS_THRESHOLD_S
from .metrics import registry as _metrics_registry

# -- the instruments the feeds subscribe to (get-or-create: whoever
# registers first, producer or engine, both hold the same instrument) --

REQUEST_DURATION = "headlamp_tpu_torch_request_duration_seconds"
REQUESTS_TOTAL = "headlamp_tpu_torch_requests_total"
FIT_DURATION = "headlamp_tpu_torch_refresh_fit_duration_seconds"
CONNECT_LATENCY = "headlamp_tpu_torch_transport_connect_latency_seconds"
CONNECT_FAILURES = "headlamp_tpu_torch_transport_connect_failures_total"
STALE_RETRIES = "headlamp_tpu_torch_transport_stale_retries_total"
AGE_AT_PAINT = AGE_AT_PAINT_NAME

#: Help texts of the host's request instruments, shared with
#: ``server/app.py`` so the registration order never changes them.
REQUEST_DURATION_HELP = "End-to-end handle() latency per route template (non-5xx responses)."
REQUESTS_TOTAL_HELP = "Requests served, by route template and status code."

#: (name, help, labels) of every histogram the engine observes.
_LATENCY_SOURCES: tuple[tuple[str, str, tuple[str, ...]], ...] = (
    (REQUEST_DURATION, REQUEST_DURATION_HELP, ("route",)),
    (FIT_DURATION, "Wall duration of refresher recomputes.", ("refresher",)),
    (CONNECT_LATENCY, "TCP(+TLS) connection establishment latency, per host.", ("host",)),
    (AGE_AT_PAINT, AGE_AT_PAINT_HELP, ("role",)),
)

#: (name, help, labels) of every counter whose matching incs are bad events.
_ERROR_SOURCES: tuple[tuple[str, str, tuple[str, ...]], ...] = (
    (REQUESTS_TOTAL, REQUESTS_TOTAL_HELP, ("route", "status")),
    (
        CONNECT_FAILURES,
        "TCP(+TLS) connection attempts that raised before a socket was established, per host.",
        ("host",),
    ),
    (
        STALE_RETRIES,
        "Requests retried on a fresh connection after a kept-alive socket turned out closed.",
        (),
    ),
)

# -- window and burn policy --------------------------------------------

#: Slot width of the windows: 6 h retention in at most 362 slots per
#: SLO, window edges within one slot.
SLOT_S = 60.0

#: The evaluation windows: a fast pair for paging, a slow pair for leaks.
WINDOWS: dict[str, float] = {
    "5m": 300.0,
    "30m": 1800.0,
    "1h": 3600.0,
    "6h": 21600.0,
}

#: ``page`` when both fast windows burn at this or more (a 30-day budget
#: gone in about 2 days).
PAGE_BURN = 14.4
PAGE_WINDOWS = ("5m", "1h")

#: ``warn`` when both slow windows burn at this or more (gone in 5 days).
WARN_BURN = 6.0
WARN_WINDOWS = ("30m", "6h")

#: Scrape→paint latencies kept for the self-forecast: the series length
#: of the registry's captured SLO bucket (``models/aot.py``).
SELF_FORECAST_SERIES_MAX = 512
#: Below this many points /sloz reports ``insufficient_history``.
SELF_FORECAST_MIN_POINTS = 48
#: Adam steps of the self-forecast's cold fit.
SELF_FORECAST_STEPS = 60
#: The budget forecast's refresher: one fit a minute at most, served
#: stale for ten.
BUDGET_FORECAST_TTL_S = 60.0
BUDGET_FORECAST_GRACE_S = 600.0
#: The history series the engine mirrors its paint latencies into.
PAINT_LATENCY_SERIES = "slo.paint_latency_s"


@dataclass(frozen=True)
class SLOSpec:
    """One objective. Matchers are label equality sets; the one other
    rule is the ``"5xx"`` sentinel, which matches any status starting
    with '5'."""

    name: str
    description: str
    #: Fraction of events that must be good (0.99 = a 1% error budget).
    target: float
    #: An observation is good iff it is at most this.
    threshold_s: float
    #: Histogram whose observations are classified by the threshold.
    latency_metric: str = REQUEST_DURATION
    #: Label matcher on that histogram ({} = every child).
    latency_where: Mapping[str, tuple[str, ...]] = field(default_factory=dict)
    #: (counter, matcher) pairs whose matching incs are bad events that
    #: never reach the histogram: the host keeps a 5xx out of the latency
    #: histogram, so each event lands in exactly one feed.
    error_feeds: tuple[tuple[str, Mapping[str, tuple[str, ...]]], ...] = ()
    #: Feed this SLO's latency stream into the budget self-forecast.
    self_forecast: bool = False

    @property
    def error_budget(self) -> float:
        return max(1.0 - self.target, 1e-9)


def _matches(where: Mapping[str, tuple[str, ...]], labels: Mapping[str, Any]) -> bool:
    for key, allowed in where.items():
        value = str(labels.get(key, ""))
        if not any(
            value == candidate or (candidate == "5xx" and value.startswith("5"))
            for candidate in allowed
        ):
            return False
    return True


#: Route templates the dashboard-render objective covers: every HTML page
#: but the metrics view, which has the looser scrape_paint objective
#: (JAX's list, Intel pages included).
DASHBOARD_ROUTES: tuple[str, ...] = (
    "/tpu",
    "/tpu/nodes",
    "/tpu/pods",
    "/tpu/deviceplugins",
    "/tpu/topology",
    "/intel",
    "/intel/nodes",
    "/intel/pods",
    "/intel/deviceplugins",
    "/intel/metrics",
    "/nodes",
    "/node/{name}",
    "/pod/{namespace}/{name}",
)


def default_specs() -> tuple[SLOSpec, ...]:
    """The shipped objectives, JAX's, under the port's metric names."""
    return (
        SLOSpec(
            name="scrape_paint",
            description="Prometheus scrape -> metrics page paint under 2 s",
            target=0.99,
            threshold_s=2.0,
            latency_where={"route": ("/tpu/metrics",)},
            error_feeds=((REQUESTS_TOTAL, {"route": ("/tpu/metrics",), "status": ("5xx",)}),),
            self_forecast=True,
        ),
        SLOSpec(
            name="dashboard_render",
            description="Dashboard page render under 500 ms",
            target=0.995,
            threshold_s=0.5,
            latency_where={"route": DASHBOARD_ROUTES},
            error_feeds=((REQUESTS_TOTAL, {"route": DASHBOARD_ROUTES, "status": ("5xx",)}),),
        ),
        SLOSpec(
            name="forecast_fit",
            description="Forecast refresher fit under 8 s",
            target=0.99,
            threshold_s=8.0,
            latency_metric=FIT_DURATION,
            latency_where={"refresher": ("forecast",)},
        ),
        SLOSpec(
            name="transport_connect",
            description="TCP(+TLS) connect under 250 ms, no failed opens or stale-socket retries",
            target=0.999,
            threshold_s=0.25,
            latency_metric=CONNECT_LATENCY,
            latency_where={},
            error_feeds=((CONNECT_FAILURES, {}), (STALE_RETRIES, {})),
        ),
        SLOSpec(
            name="data_freshness",
            description="Painted data younger than the freshness threshold at each "
            "generation's first paint, end to end",
            target=0.99,
            threshold_s=FRESHNESS_THRESHOLD_S,
            latency_metric=AGE_AT_PAINT,
            latency_where={},
        ),
    )


class _WindowCounts:
    """Good and bad counts in SLOT_S slots keyed ``int(now // SLOT_S)``:
    an add is one dict upsert under one lock, a window sum walks the
    retained slots, and slots older than the longest window are pruned."""

    __slots__ = ("_slots", "_lock")

    #: Longest window in slots, plus the edge slot.
    MAX_SLOTS = int(max(WINDOWS.values()) / SLOT_S) + 2

    def __init__(self) -> None:
        self._slots: dict[int, list[int]] = {}
        self._lock = threading.Lock()

    def add(self, now: float, good: bool, count: int = 1) -> None:
        idx = int(now // SLOT_S)
        with self._lock:
            slot = self._slots.get(idx)
            if slot is None:
                slot = self._slots[idx] = [0, 0]
                if len(self._slots) > self.MAX_SLOTS:
                    horizon = idx - self.MAX_SLOTS
                    for stale in [k for k in self._slots if k < horizon]:
                        del self._slots[stale]
            slot[0 if good else 1] += count

    def totals(self, now: float, window_s: float) -> tuple[int, int]:
        """(good, bad) over the trailing ``window_s``."""
        hi = int(now // SLOT_S)
        lo = int((now - window_s) // SLOT_S)
        good = bad = 0
        with self._lock:
            for idx, (g, b) in self._slots.items():
                if lo < idx <= hi:
                    good += g
                    bad += b
        return good, bad


class SLOEngine:
    """Holds the windows, evaluates states and answers every surface.
    One engine per process (:func:`engine`); tests build their own on a
    scripted clock and :func:`set_engine` it.

    ``device`` is where the budget self-forecast fits: CUDA unless the
    caller (or the host, which hands over its own device) asks for
    ``"cpu"``. It is resolved at the fit, so building an engine never
    touches a device."""

    def __init__(
        self,
        specs: tuple[SLOSpec, ...] | None = None,
        *,
        monotonic: Callable[[], float] = time.monotonic,
        device: Any = None,
    ) -> None:
        self.specs = tuple(specs) if specs is not None else default_specs()
        self._monotonic = monotonic
        self._device = device
        self._windows = {spec.name: _WindowCounts() for spec in self.specs}
        self._latency_index: dict[str, list[SLOSpec]] = {}
        self._error_index: dict[str, list[tuple[SLOSpec, Mapping[str, tuple[str, ...]]]]] = {}
        for spec in self.specs:
            self._latency_index.setdefault(spec.latency_metric, []).append(spec)
            for metric, where in spec.error_feeds:
                self._error_index.setdefault(metric, []).append((spec, where))
        self._paint_series: deque[float] = deque(maxlen=SELF_FORECAST_SERIES_MAX)
        self._refresher: Any = None
        self._warm_state: Any = None
        #: The error of the last budget fit, None once one succeeds.
        self.budget_fit_error: str | None = None
        #: A weak reference to the host's history store: the paint feed
        #: mirrors into it and the budget forecast prefers it as its
        #: series. The process engine outlives any one app.
        self._history_store_ref: Any = None

    @property
    def device(self) -> Any:
        return self._device

    @device.setter
    def device(self, device: Any) -> None:
        """Point the budget fit at ``device``; a warm carry of another
        device is dropped."""
        if str(device) != str(self._device):
            self._warm_state = None
        self._device = device

    @property
    def history_store(self) -> Any:
        ref = self._history_store_ref
        return ref() if ref is not None else None

    @history_store.setter
    def history_store(self, store: Any) -> None:
        if store is not None:
            # The mirror keeps as many points as the engine's series, so
            # a history-first fit trains on the captured bucket's length.
            store.reserve(PAINT_LATENCY_SERIES, SELF_FORECAST_SERIES_MAX)
        self._history_store_ref = weakref.ref(store) if store is not None else None

    # -- feeds (hot path: the instrument observers) -----------------------

    def record(self, name: str, good: bool, count: int = 1) -> None:
        """Direct good/bad feed for one SLO."""
        window = self._windows.get(name)
        if window is not None:
            window.add(self._monotonic(), good, count)

    def feed_latency(self, metric: str, value: float, labels: Mapping[str, Any]) -> None:
        for spec in self._latency_index.get(metric, ()):
            if _matches(spec.latency_where, labels):
                value_f = float(value)
                self.record(spec.name, value_f <= spec.threshold_s)
                if spec.self_forecast:
                    self._paint_series.append(value_f)
                    store = self.history_store
                    if store is not None:
                        # A measured duration: the capture gate keeps it
                        # out of a replay harness's store.
                        store.record_timing(PAINT_LATENCY_SERIES, value_f)

    def feed_error(self, metric: str, amount: float, labels: Mapping[str, Any]) -> None:
        count = max(int(amount), 1)
        for spec, where in self._error_index.get(metric, ()):
            if _matches(where, labels):
                self.record(spec.name, False, count)

    # -- request-level judgement (flight-recorder pinning) ---------------

    def violations(self, route: str, duration_s: float, status: int) -> list[str]:
        """Request-backed SLOs this one request violated."""
        out = []
        for spec in self.specs:
            if spec.latency_metric != REQUEST_DURATION:
                continue
            if not _matches(spec.latency_where, {"route": route}):
                continue
            if duration_s > spec.threshold_s or status >= 500:
                out.append(spec.name)
        return out

    # -- evaluation --------------------------------------------------------

    def _evaluate_spec(self, spec: SLOSpec, now: float) -> dict[str, Any]:
        window = self._windows[spec.name]
        burn: dict[str, float] = {}
        events: dict[str, dict[str, int]] = {}
        for label, seconds in WINDOWS.items():
            good, bad = window.totals(now, seconds)
            total = good + bad
            bad_fraction = bad / total if total else 0.0
            burn[label] = round(bad_fraction / spec.error_budget, 4)
            events[label] = {"good": good, "bad": bad}
        if all(burn[w] >= PAGE_BURN for w in PAGE_WINDOWS):
            state = "page"
        elif all(burn[w] >= WARN_BURN for w in WARN_WINDOWS):
            state = "warn"
        else:
            state = "ok"
        consumed = burn["6h"] * (1.0 if events["6h"]["good"] + events["6h"]["bad"] else 0.0)
        return {
            "name": spec.name,
            "description": spec.description,
            "target": spec.target,
            "threshold_s": spec.threshold_s,
            "state": state,
            "burn_rates": burn,
            "events": events,
            # Burn 1.0 for the whole 6 h window spends exactly the budget.
            "budget_remaining_ratio": round(max(0.0, 1.0 - consumed), 4),
        }

    def health_block(self) -> dict[str, str]:
        """{slo: state}."""
        now = self._monotonic()
        return {spec.name: self._evaluate_spec(spec, now)["state"] for spec in self.specs}

    def report(
        self, *, include_exemplars: bool = True, include_forecast: bool = True
    ) -> dict[str, Any]:
        """The /sloz body and the /sloz/html page's input."""
        now = self._monotonic()
        slos = []
        for spec in self.specs:
            status = self._evaluate_spec(spec, now)
            if include_exemplars:
                status["exemplars"] = self._exemplars_for(spec)
            slos.append(status)
        out: dict[str, Any] = {
            "slos": slos,
            "windows_s": dict(WINDOWS),
            "page_burn_threshold": PAGE_BURN,
            "warn_burn_threshold": WARN_BURN,
        }
        if include_forecast:
            out["budget_forecast"] = self.budget_forecast()
        return out

    def _exemplars_for(self, spec: SLOSpec, limit: int = 8) -> list[dict[str, Any]]:
        """Recent exemplars of the SLO's latency histogram, slowest first."""
        for name, help_text, labels in _LATENCY_SOURCES:
            if name == spec.latency_metric:
                hist = _metrics_registry.histogram(name, help_text, labels=labels)
                break
        else:
            return []
        found = list(exemplars_matching(hist, lambda l: _matches(spec.latency_where, l)))
        found.sort(key=lambda e: -e["value"])
        return found[:limit]

    # -- the self-forecast -------------------------------------------------

    def _budget_refresher(self) -> Any:
        if self._refresher is None:
            # Imported at first use: runtime.refresh imports obs.metrics.
            from ..runtime.refresh import Refresher

            self._refresher = Refresher(
                "slo_budget",
                ttl_s=BUDGET_FORECAST_TTL_S,
                grace_s=BUDGET_FORECAST_GRACE_S,
                monotonic=self._monotonic,
            )
        return self._refresher

    def _fit_paint_series(self, series: list[float]) -> list[float] | None:
        """The refresher's compute: one fit on the engine's device. Its
        error is kept for /sloz and /healthz, then propagates to the
        refresher, which counts it."""
        from ..models.service import forecast_slo_burn

        try:
            predictions, state = forecast_slo_burn(
                series, state=self._warm_state, steps=SELF_FORECAST_STEPS, device=self._device
            )
        except Exception as exc:
            self.budget_fit_error = f"{type(exc).__name__}: {exc}"
            raise
        self.budget_fit_error = None
        if state is not None:
            self._warm_state = state
        return predictions

    def budget_forecast(self) -> dict[str, Any] | None:
        """Projected budget exhaustion of the self-forecast SLO: fit the
        scrape→paint latency series through the refresher's non-blocking
        read (a fit never runs in the foreground of a /sloz request),
        classify the predictions against the threshold and turn the
        projected burn into "N 1-hour windows until the 6 h budget is
        gone". A named reason stands in for the projection while the
        history is thin (``insufficient_history``), the first fit runs
        (``fit_pending``), the last fit raised (``fit_failed``, with its
        ``error``) or nothing is projected to burn."""
        spec = next((s for s in self.specs if s.self_forecast), None)
        if spec is None:
            return None
        series = list(self._paint_series)
        data_source = "live-window"
        store = self.history_store
        if store is not None:
            # The mirrored history series, once it holds enough points:
            # the same points /tpu/trends charts.
            _ages, captured = store.series(PAINT_LATENCY_SERIES)
            if len(captured) >= SELF_FORECAST_MIN_POINTS:
                series = list(captured)
                data_source = "history"
        out: dict[str, Any] = {
            "slo": spec.name,
            "points": len(series),
            "window": "1h",
            "data_source": data_source,
            "projected_exhaustion_windows": None,
        }
        if len(series) < SELF_FORECAST_MIN_POINTS:
            out["reason"] = "insufficient_history"
            return out
        refresher = self._budget_refresher()
        predictions = refresher.get_nowait("paint", lambda: self._fit_paint_series(series), epoch=0)
        if predictions is None:
            error = self.budget_fit_error
            if error is not None:
                out["reason"] = "fit_failed"
                out["error"] = error
            else:
                out["reason"] = "fit_pending"
            return out
        if not predictions:
            out["reason"] = "forecast_unavailable"
            return out
        bad_fraction = sum(1 for p in predictions if p > spec.threshold_s) / len(predictions)
        projected_burn = bad_fraction / spec.error_budget
        out["projected_burn_rate"] = round(projected_burn, 4)
        # One 1 h window at burn B spends B × (1h/6h) of the 6 h budget.
        per_window = projected_burn * (WINDOWS["1h"] / WINDOWS["6h"])
        if per_window <= 0:
            out["reason"] = "no_projected_burn"
            return out
        remaining = self._evaluate_spec(spec, self._monotonic())["budget_remaining_ratio"]
        out["projected_exhaustion_windows"] = min(math.ceil(remaining / per_window), 999)
        return out

    def budget_predictions(self) -> list[float] | None:
        """The cached predictions of the last budget fit, never fitting."""
        refresher = self._refresher
        return None if refresher is None else refresher.peek("paint", epoch=0)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Wait for the budget fit in flight, if any; False on timeout."""
        refresher = self._refresher
        return True if refresher is None else refresher.drain(timeout_s)


# -- the process engine and its registry wiring -------------------------

_engine: SLOEngine | None = None
_engine_lock = threading.Lock()


def engine() -> SLOEngine:
    """The process engine, built at first use over the default specs on
    the real monotonic clock. Every feed and surface routes through it."""
    global _engine
    if _engine is None:
        with _engine_lock:
            if _engine is None:
                _engine = SLOEngine()
    return _engine


def set_engine(new_engine: SLOEngine) -> SLOEngine:
    """Install ``new_engine`` as the process engine and return the one it
    replaced, so tests can restore it; window history does not carry
    over."""
    global _engine
    with _engine_lock:
        previous, _engine = _engine, new_engine
    return previous


_attached = False


def _attach_observers() -> None:
    """Subscribe to the producer instruments, once per process."""
    global _attached
    if _attached:
        return
    _attached = True
    for name, help_text, labels in _LATENCY_SOURCES:
        hist = _metrics_registry.histogram(name, help_text, labels=labels)
        hist.add_observer(lambda value, lbls, _n=name: engine().feed_latency(_n, value, lbls))
    for name, help_text, labels in _ERROR_SOURCES:
        counter = _metrics_registry.counter(name, help_text, labels=labels)
        counter.add_observer(lambda amount, lbls, _n=name: engine().feed_error(_n, amount, lbls))


def _burn_rate_samples() -> list[tuple[tuple[str, str], float]]:
    eng = engine()
    now = eng._monotonic()
    out: list[tuple[tuple[str, str], float]] = []
    for spec in eng.specs:
        for window_label, rate in eng._evaluate_spec(spec, now)["burn_rates"].items():
            out.append(((spec.name, window_label), rate))
    return out


def _budget_samples() -> list[tuple[tuple[str], float]]:
    eng = engine()
    now = eng._monotonic()
    return [
        ((spec.name,), eng._evaluate_spec(spec, now)["budget_remaining_ratio"])
        for spec in eng.specs
    ]


def _state_samples() -> list[tuple[tuple[str, str], float]]:
    return [((name, state), 1.0) for name, state in engine().health_block().items()]


_metrics_registry.gauge_samples_fn(
    "headlamp_tpu_torch_slo_burn_rate_ratio",
    "Error-budget burn rate per SLO and evaluation window (1.0 = the budget "
    "spent exactly at the sustainable rate).",
    ("slo", "window"),
    _burn_rate_samples,
)
_metrics_registry.gauge_samples_fn(
    "headlamp_tpu_torch_slo_error_budget_remaining_ratio",
    "Unspent fraction of each SLO's 6h error budget.",
    ("slo",),
    _budget_samples,
)
_metrics_registry.gauge_samples_fn(
    "headlamp_tpu_torch_slo_state_info",
    "Current burn-rate state per SLO (1 on the active state's series).",
    ("slo", "state"),
    _state_samples,
)

_attach_observers()

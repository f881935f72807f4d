"""The port's SLO engine (``headlamp_tpu_torch/obs/slo.py``) against the
JAX package's on the CPU, on the same streams under a scripted monotonic
clock: the reports (states through ok→warn→page and the recovery, burn
rates, budgets) are equal, and so are the budget self-forecasts built on
``forecast_slo_burn``, whose 512-point predictions agree to 1e-2 (``-s``
prints the difference). A fit, replay or kernel error reports
``fit_failed`` naming it and turns the host's ``/healthz`` false until a
later fit succeeds; thin history reports ``insufficient_history``.

JAX's engines here are built on their own and never installed, so JAX's
process engine, its profiler and its ``DashboardApp`` stay untouched.
"""

import functools
import json
import math

import jax
import numpy as np
import pytest
import torch

from headlamp_tpu.models import forecast as jf
from headlamp_tpu.models import service as jservice
from headlamp_tpu.obs import slo as jslo
from headlamp_tpu_torch.models import aot
from headlamp_tpu_torch.models import service as tservice
from headlamp_tpu_torch.models.convert import params_from_jax
from headlamp_tpu_torch.obs import graphcost
from headlamp_tpu_torch.obs import slo as tslo
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

torch.set_num_threads(1)

#: forecast_slo_burn's predictions against JAX's: a 60-step cold fit, as
#: tests/test_torch_fit.py holds the page's fit.
BURN_TOL = 1e-2
#: The metric names of each package, in the engines' feed order.
NAMES = {
    "request": (jslo.REQUEST_DURATION, tslo.REQUEST_DURATION),
    "requests": (jslo.REQUESTS_TOTAL, tslo.REQUESTS_TOTAL),
    "fit": (jslo.FIT_DURATION, tslo.FIT_DURATION),
    "connect": (jslo.CONNECT_LATENCY, tslo.CONNECT_LATENCY),
    "connect_fail": (jslo.CONNECT_FAILURES, tslo.CONNECT_FAILURES),
    "stale": (jslo.STALE_RETRIES, tslo.STALE_RETRIES),
    "age": (jslo.AGE_AT_PAINT, tslo.AGE_AT_PAINT),
}


def _pair(t):
    """A JAX engine and a port engine on the same scripted clock."""
    return (
        jslo.SLOEngine(monotonic=lambda: t[0]),
        tslo.SLOEngine(monotonic=lambda: t[0], device="cpu"),
    )


def _feed(engines, kind, value, labels, *, error=False):
    for eng, name in zip(engines, NAMES[kind]):
        if error:
            eng.feed_error(name, value, labels)
        else:
            eng.feed_latency(name, value, labels)


def _report(eng):
    return eng.report(include_exemplars=False, include_forecast=False)


def _latency_series(n=512, seed=9):
    """A scrape→paint latency series in seconds: a daily-ish swell, noise
    and a few slow paints, all well under the 2 s objective."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    series = 0.18 + 0.08 * np.sin(t / 37.0) + 0.03 * rng.standard_normal(n)
    series[rng.choice(n, 12, replace=False)] += 0.5
    return np.clip(series, 0.02, 1.5).astype(np.float32).tolist()


def _jax_init():
    return params_from_jax(jf.init_params(jax.random.PRNGKey(0), jf.ForecastConfig()), "cpu")


def test_default_specs_equal_jax_up_to_the_metric_names():
    rename = {t: j for j, t in NAMES.values()}
    for js, ts in zip(jslo.default_specs(), tslo.default_specs(), strict=True):
        assert (ts.name, ts.description, ts.target, ts.threshold_s, ts.self_forecast) == (
            js.name, js.description, js.target, js.threshold_s, js.self_forecast)
        assert rename[ts.latency_metric] == js.latency_metric
        assert dict(ts.latency_where) == dict(js.latency_where)
        assert [(rename[m], dict(w)) for m, w in ts.error_feeds] == [
            (m, dict(w)) for m, w in js.error_feeds]
    assert (tslo.WINDOWS, tslo.PAGE_BURN, tslo.WARN_BURN, tslo.SLOT_S) == (
        jslo.WINDOWS, jslo.PAGE_BURN, jslo.WARN_BURN, jslo.SLOT_S)
    assert tslo.DASHBOARD_ROUTES == jslo.DASHBOARD_ROUTES
    assert (tslo.SELF_FORECAST_SERIES_MAX, tslo.SELF_FORECAST_MIN_POINTS) == (
        jslo.SELF_FORECAST_SERIES_MAX, jslo.SELF_FORECAST_MIN_POINTS) == (aot.SLO_SERIES_STEADY, 48)


def test_reports_equal_jax_through_ok_warn_page_and_recovery():
    """Eight scripted hours, one step a minute: healthy traffic, a slow
    leak of bad renders (warn), a sharp burst of 5xx and slow paints
    (page), then healthy traffic until every window has drained. The
    two engines' reports are equal at every checkpoint, and
    dashboard_render reaches ok, warn and page in that order and ends ok."""
    t = [10_000.0]
    engines = _pair(t)
    rng = np.random.default_rng(20261017)
    seen = []
    for minute in range(8 * 60):
        t[0] = 10_000.0 + 60.0 * minute + 0.5
        leak = 0.05 if 60 <= minute < 300 else 0.0
        burst = 0.6 if 270 <= minute < 280 else 0.0
        for _ in range(12):
            route = ("/tpu", "/tpu/nodes", "/node/{name}", "/tpu/metrics")[rng.integers(4)]
            slow = rng.random() < leak + burst
            if rng.random() < burst / 2:
                _feed(engines, "requests", 1, {"route": route, "status": "500"}, error=True)
                continue
            latency = float(rng.uniform(0.6, 3.0) if slow else rng.uniform(0.005, 0.2))
            _feed(engines, "request", latency, {"route": route})
            _feed(engines, "requests", 1, {"route": route, "status": "200"}, error=True)
        if minute % 5 == 0:
            fit = float(rng.uniform(9.0, 12.0) if burst else rng.uniform(0.1, 2.0))
            _feed(engines, "fit", fit, {"refresher": "forecast"})
            _feed(engines, "fit", fit, {"refresher": "metrics"})
            _feed(engines, "age", float(rng.uniform(0.5, 14.0)), {"role": "leader"})
            _feed(engines, "connect", float(rng.uniform(0.001, 0.4)), {"host": "apiserver"})
            if rng.random() < 0.1:
                _feed(engines, "connect_fail", 1, {"host": "apiserver"}, error=True)
                _feed(engines, "stale", 1, {}, error=True)
        if minute % 15 == 14:
            want, got = (_report(e) for e in engines)
            assert got == want, minute
            assert engines[1].health_block() == engines[0].health_block()
            seen.append(got["slos"][1]["state"])
    first = [seen.index(state) for state in ("ok", "warn", "page")]
    assert first == sorted(first) and seen[-1] == "ok", seen


def test_violations_equal_jax():
    t = [0.0]
    jeng, teng = _pair(t)
    for route in ("/tpu", "/tpu/metrics", "/nodes", "/tpu/trends", "/healthz", "other"):
        for duration in (0.01, 0.6, 2.5):
            for status in (200, 404, 500, 503):
                assert teng.violations(route, duration, status) == jeng.violations(
                    route, duration, status), (route, duration, status)


def test_forecast_slo_burn_agrees_with_jax_at_512_points():
    """The self-forecast's fit on a 512-point series, as one chip, from
    JAX's PRNGKey(0) init: predictions within 1e-2 of JAX's, then a warm
    refinement of each package's carry within the same bound."""
    series = _latency_series()
    init = _jax_init()
    want, jstate = jservice.forecast_slo_burn(series, steps=60)
    got, tstate = tservice.forecast_slo_burn(series, steps=60, init=init, device="cpu")
    assert want is not None and len(got) == len(want) == jf.ForecastConfig().horizon
    diff = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    print(f"forecast_slo_burn, 512 points, cold: max |port - jax| = {diff:.3e} (tol {BURN_TOL})")
    assert diff <= BURN_TOL
    assert all(p < tslo.default_specs()[0].threshold_s - BURN_TOL for p in got + want)
    want_w, _ = jservice.forecast_slo_burn(series, state=jstate, steps=60)
    got_w, _ = tservice.forecast_slo_burn(series, state=tstate, steps=60, device="cpu")
    warm = float(np.max(np.abs(np.asarray(got_w) - np.asarray(want_w))))
    print(f"forecast_slo_burn, 512 points, warm: max |port - jax| = {warm:.3e} (tol {BURN_TOL})")
    assert warm <= BURN_TOL


def test_budget_forecasts_equal_jax(monkeypatch):
    """Both engines fed the same 512 paint latencies: fit_pending while
    the background fit runs, then the same projection (the predictions
    sit far below the 2 s threshold, so the count compares exactly). On
    the CPU the port's registry is idle, so the fit ran eagerly and the
    ledger row says so."""
    monkeypatch.setattr(tservice, "forecast_slo_burn",
                        functools.partial(tservice.forecast_slo_burn, init=_jax_init()))
    monkeypatch.setattr(graphcost, "_LEDGER", graphcost.GraphCostLedger())
    t = [50_000.0]
    engines = _pair(t)
    for v in _latency_series():
        _feed(engines, "request", v, {"route": "/tpu/metrics"})
    first = [e.budget_forecast() for e in engines]
    assert first[1] == first[0] and first[0]["reason"] == "fit_pending"
    for eng in engines:
        assert eng._budget_refresher().drain(120.0)
    want, got = (e.budget_forecast() for e in engines)
    assert got == want == {
        "slo": "scrape_paint", "points": 512, "window": "1h", "data_source": "live-window",
        "projected_exhaustion_windows": None, "projected_burn_rate": 0.0,
        "reason": "no_projected_burn",
    }
    row = graphcost.ledger().snapshot()["programs"][tservice.SLO_BURN_PROGRAM]
    assert (row["replays"], row["eager"]) == (0, 1)


def test_thin_history_reports_insufficient_history():
    t = [0.0]
    engines = _pair(t)
    for v in _latency_series(47):
        _feed(engines, "request", v, {"route": "/tpu/metrics"})
    want, got = (e.budget_forecast() for e in engines)
    assert got == want and got["reason"] == "insufficient_history" and got["points"] == 47
    assert engines[1]._refresher is None  # no fit was started


@pytest.fixture
def host_engine():
    """A port engine on a scripted clock installed as the process engine
    for one host, restored afterwards."""
    t = [90_000.0]
    eng = tslo.SLOEngine(monotonic=lambda: t[0])
    previous = tslo.set_engine(eng)
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=lambda: 1.7e9)
    try:
        yield app, eng, t
    finally:
        app.close()
        eng.drain()
        tslo.set_engine(previous)


def _sloz(app):
    status, _, body = app.handle("/sloz")
    assert status == 200
    return json.loads(body)["budget_forecast"]


def _health(app):
    return json.loads(app.handle("/healthz")[2])


def test_a_failing_fit_is_named_and_turns_healthz_false_until_a_fit_succeeds(
    host_engine, monkeypatch
):
    app, eng, t = host_engine
    assert eng.device == app.device and eng.history_store is app.history
    for v in _latency_series(64):
        eng.feed_latency(tslo.REQUEST_DURATION, v, {"route": "/tpu/metrics"})
    real = tservice.forecast_slo_burn

    def broken(*args, **kwargs):
        raise RuntimeError("forecast_mlp_forward launch failed: an illegal memory access")

    monkeypatch.setattr(tservice, "forecast_slo_burn", broken)
    # The read starts the fit in the background, which may already have
    # failed by the time the read reports.
    assert _sloz(app)["reason"] in ("fit_pending", "fit_failed")
    assert eng.drain()
    forecast = _sloz(app)
    assert forecast["reason"] == "fit_failed" and forecast["data_source"] == "history"
    assert forecast["error"] == "RuntimeError: forecast_mlp_forward launch failed: an illegal memory access"
    assert eng.drain()
    health = _health(app)
    assert health["ok"] is False
    assert health["runtime"]["slo"]["budget_fit_error"] == forecast["error"]
    assert eng._budget_refresher().snapshot()["refit_errors"] >= 1
    # A later fit that succeeds clears it.
    monkeypatch.setattr(tservice, "forecast_slo_burn", real)
    assert _sloz(app)["reason"] in ("fit_failed", "fit_pending")  # the retry is in flight
    assert eng.drain()
    assert _sloz(app)["reason"] == "no_projected_burn"
    health = _health(app)
    assert health["ok"] is True and health["runtime"]["slo"]["budget_fit_error"] is None


def test_a_replay_error_reaches_sloz_and_healthz(host_engine, monkeypatch):
    """The registry covers the 512-point series; its replay raises. The
    error is counted by the registry and named by /sloz and /healthz."""
    app, eng, t = host_engine
    cfg = tservice.ForecastConfig()
    reg = aot.AotProgramRegistry(
        specs=[(aot.COLD_PROGRAM, (8, aot.SLO_SERIES_STEADY, cfg, 60))])
    reg.compile_startup("cpu", block=True)
    assert reg.ready() and reg.compile_errors == 0
    monkeypatch.setattr(aot, "_REGISTRY", reg)
    program = reg.executable(aot.COLD_PROGRAM, (8, aot.SLO_SERIES_STEADY, cfg, 60),
                             torch.device("cpu"))

    def raise_on_run(inputs, finish):
        raise RuntimeError("CUDA graph replay failed")

    monkeypatch.setattr(program, "run", raise_on_run)
    for v in _latency_series():
        eng.feed_latency(tslo.REQUEST_DURATION, v, {"route": "/tpu/metrics"})
    assert _sloz(app)["reason"] in ("fit_pending", "fit_failed")
    assert eng.drain()
    forecast = _sloz(app)
    assert forecast["points"] == 512 and forecast["reason"] == "fit_failed"
    assert forecast["error"] == "RuntimeError: CUDA graph replay failed"
    assert eng.drain()
    # Each /sloz read while no value is cached starts another fit.
    assert reg.exec_failures >= 1 and reg.last_error == "forecast.aot_fit_forecast_state: " + forecast["error"]
    assert _health(app)["ok"] is False


def test_the_history_mirror_holds_the_captured_bucket_length():
    """The host wires the engine to its history store: the paint feed
    mirrors into ``slo.paint_latency_s``, whose ring holds 512 points
    (the default ring holds 288), and the budget forecast trains on it."""
    t = [0.0]
    eng = tslo.SLOEngine(monotonic=lambda: t[0], device="cpu")
    from headlamp_tpu_torch.history import HistoryStore

    store = HistoryStore(monotonic=lambda: t[0], device="cpu")
    eng.history_store = store
    for i, v in enumerate(_latency_series(600)):
        t[0] = float(i)
        eng.feed_latency(tslo.REQUEST_DURATION, v, {"route": "/tpu/metrics"})
    _ages, values = store.series(tslo.PAINT_LATENCY_SERIES)
    assert len(values) == 512 and np.allclose(values, _latency_series(600)[-512:])
    store.capture_timings = False
    eng.feed_latency(tslo.REQUEST_DURATION, 0.5, {"route": "/tpu/metrics"})
    assert store.series(tslo.PAINT_LATENCY_SERIES)[1][-1] == values[-1]
    forecast = eng.budget_forecast()
    assert (forecast["data_source"], forecast["points"], forecast["reason"]) == (
        "history", 512, "fit_pending")
    assert eng.drain(120.0)
    assert math.isclose(eng.budget_forecast()["projected_burn_rate"], 0.0)

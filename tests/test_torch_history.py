"""The port's history tier, trend statistics, trends page and history-first
forecast against the JAX package's, on the CPU.

Both ``HistoryStore``s are fed the same rows on the same injected
monotonic clock (ring overwrites and shard evictions included): their
series, ``utilization_history``, ``trend_view`` (everything but the
statistics, in grouped and browse mode), counters and snapshot are
equal. The batched statistics are held to JAX ``series_stats``: n,
latest, min and max exactly, mean and slope within 1e-5 relative and
1e-6 absolute; a constant series' slope is exactly 0. The trends page's
``<main>`` bytes equal JAX's on the same view dict. The history-first
forecast makes no range query, says ``data_source == "history"`` and is
within 1e-2 of JAX's from the same init; a thin store falls through to
the live window. Then ``/tpu/trends``, ``runtime.history`` and the
``headlamp_tpu_torch_history_*`` families on the port host.
"""

import json
import re
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from headlamp_tpu.analytics.trends import series_stats as jax_series_stats
from headlamp_tpu.history import HistoryStore as JaxStore
from headlamp_tpu.models import forecast as jf
from headlamp_tpu.models import service as jservice
from headlamp_tpu.pages.trends_page import trends_page as jax_trends_page
from headlamp_tpu.ui import render_html as jax_render_html
from headlamp_tpu_torch.analytics.trends import python_series_stats, series_stats_batch
from headlamp_tpu_torch.history import HistoryStore
from headlamp_tpu_torch.models import forecast as tf
from headlamp_tpu_torch.models import service
from headlamp_tpu_torch.models.convert import params_from_jax
from headlamp_tpu_torch.pages.trends_page import trends_page
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport
from headlamp_tpu_torch.ui import render_html

torch.set_num_threads(1)

CLOCK = 1785283200.0
PRED_TOL = 1e-2
STAT_RTOL, STAT_ATOL = 1e-5, 1e-6


def clock():
    return CLOCK


class Mono:
    def __init__(self, start=100.0):
        self.now = start

    def __call__(self):
        return self.now


def _scrape(chips, fetch_ms=2.0):
    return SimpleNamespace(
        chips=[SimpleNamespace(node=n, accelerator_id=a, tensorcore_utilization=u,
                               duty_cycle=None if d is None else d)
               for n, a, u, d in chips],
        fetch_ms=fetch_ms,
    )


def _stores(**kw):
    mono = Mono()
    return HistoryStore(monotonic=mono, device="cpu", **kw), JaxStore(monotonic=mono, **kw), mono


def _feed(stores, mono, *, scrapes, chips=12, step=60.0, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(scrapes):
        rows = [(f"node-{c // 4}", str(c % 4), float(rng.random()),
                 None if c == 3 else float(rng.random())) for c in range(chips)]
        for store in stores:
            store.record_scrape(_scrape(rows, fetch_ms=1.0 + i))
            store.record_sync(generation=i + 1, nodes=chips // 4, errors=i % 3 == 0)
            store.append("fleet.const", 0.25)
        mono.now += step


def _strip_stats(view):
    """The view with every series' stats dropped and the browse window's
    fields as a tuple (the two packages' Window types differ)."""
    out = json.loads(json.dumps({k: v for k, v in view.items() if k != "browse"}))
    for group in out["groups"]:
        for series in group["series"]:
            series.pop("stats")
    if "browse" in view:
        browse = view["browse"]
        win = browse["window"]
        out["browse"] = {
            "metric": browse["metric"],
            "series": [{k: v for k, v in s.items() if k != "stats"} for s in browse["series"]],
            "window": (win.total, win.start, win.next_cursor, win.limit, len(win.rows)),
        }
    return json.loads(json.dumps(out))


def _stats_close(got, want):
    for key in ("n", "latest", "min", "max"):
        assert got[key] == want[key], key
    for key in ("mean", "slope_per_step"):
        assert got[key] == pytest.approx(want[key], rel=STAT_RTOL, abs=STAT_ATOL), key


def test_store_matches_jax_on_the_same_rows():
    # Ring overwrites and retention: 55 scrapes into 48-point shards
    # with 40 minutes' retention.
    port, jax_store, mono = _stores(shard_capacity=48, retention_s=2400.0)
    _feed((port, jax_store), mono, scrapes=55, chips=20)
    assert port.points_evicted > 0
    assert sorted(port._shards) == sorted(jax_store._shards)
    for key in sorted(jax_store._shards):
        for window in (None, 600.0):
            assert port.series(*key, window_s=window) == jax_store.series(*key, window_s=window), key
    for min_points in (40, 41, 49):  # only 40 points fit inside retention
        got = port.utilization_history(clock=clock, min_points=min_points)
        want = jax_store.utilization_history(clock=clock, min_points=min_points)
        assert (got is None) == (want is None) == (min_points != 40)
        if got is not None:
            assert (got.keys, got.series, got.step_s, got.end, got.resolved_query) == (
                want.keys, want.series, want.step_s, want.end, want.resolved_query)
    for window in (900.0, 3600.0, 1e9):
        got, want = port.trend_view(window_s=window), jax_store.trend_view(window_s=window)
        assert _strip_stats(got) == _strip_stats(want)
        for g_group, w_group in zip(got["groups"], want["groups"]):
            for g, w in zip(g_group["series"], w_group["series"]):
                _stats_close(g["stats"], w["stats"])
    assert port.counters() == jax_store.counters()
    assert port.snapshot() == jax_store.snapshot()
    # The shard bound: 46 series into 30 shards evict the least recently
    # appended, the same ones in both.
    port, jax_store, mono = _stores(max_shards=30)
    _feed((port, jax_store), mono, scrapes=3, chips=20)
    assert port.shards_evicted > 0 and sorted(port._shards) == sorted(jax_store._shards)
    for key in sorted(jax_store._shards):
        assert port.series(*key) == jax_store.series(*key), key
    assert port.counters() == jax_store.counters() and port.snapshot() == jax_store.snapshot()


def test_browse_mode_and_its_cursor_match_jax():
    port, jax_store, mono = _stores()
    _feed((port, jax_store), mono, scrapes=6, chips=40)
    cursor = None
    for _page in range(3):
        kw = dict(window_s=3600.0, metric="chip.tensorcore_utilization", series_limit=16,
                  series_cursor=cursor)
        got, want = port.trend_view(**kw), jax_store.trend_view(**kw)
        assert _strip_stats(got) == _strip_stats(want)
        for g, w in zip(got["browse"]["series"], want["browse"]["series"]):
            _stats_close(g["stats"], w["stats"])
        cursor = got["browse"]["window"].next_cursor
    assert cursor is None and got["browse"]["window"].start == 32


def test_window_arrays_are_float32_tensors_on_the_device(monkeypatch):
    port, _jax_store, mono = _stores()
    port.append("m", 1.5)
    mono.now += 2.0
    port.append("m", 2.25)
    ages, values = port.window_arrays("m", device="cpu")
    assert ages.dtype == values.dtype == torch.float32 and values.device.type == "cpu"
    assert values.tolist() == [1.5, 2.25] and ages.tolist() == [2.0, 0.0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.window_arrays("m")  # the default is the card
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HistoryStore()


def test_batched_stats_against_jax_series_stats():
    rng = np.random.default_rng(3)
    # float32 values, as the store's rings hold them.
    cases = [
        [],
        [float(np.float32(0.7))],
        [float(np.float32(0.1))] * 288,
        rng.random(288).astype(np.float32).tolist(),
        (np.arange(50, dtype=np.float32) * 0.01 + 3.0).astype(np.float32).tolist(),
        (rng.random(17) * 1000).astype(np.float32).tolist(),
    ]
    got = series_stats_batch(cases, device="cpu")
    assert series_stats_batch([], device="cpu") == []
    for case, stats in zip(cases, got):
        _stats_close(stats, jax_series_stats(case))
        _stats_close(stats, python_series_stats(case))
    assert got[0] == dict.fromkeys(got[0], 0.0)
    assert got[2]["slope_per_step"] == 0.0 and got[1]["slope_per_step"] == 0.0
    assert got[4]["slope_per_step"] == pytest.approx(0.01, rel=1e-4)


def _main(html):
    return re.search(r"<main>(.*)</main>", html, re.S).group(1) if "<main>" in html else html


@pytest.mark.parametrize("mode", ["grouped", "browse", "browse-cursor"])
def test_trends_page_bytes_match_jax(mode):
    port, _jax_store, mono = _stores()
    _feed((port,), mono, scrapes=30, chips=48)
    mono.now += 45.0
    if mode == "grouped":
        view = port.trend_view(window_s=3600.0)
        assert any(g["series_total"] > len(g["series"]) for g in view["groups"])
    else:
        kw = dict(window_s=900.0, metric="chip.duty_cycle", series_limit=10)
        view = port.trend_view(**kw)
        if mode == "browse-cursor":
            view = port.trend_view(series_cursor=view["browse"]["window"].next_cursor, **kw)
            assert view["browse"]["window"].start == 10
    got, want = render_html(trends_page(view)), jax_render_html(jax_trends_page(view))
    assert got == want and "hl-trend-strip" in got


class _NoRangeQuery:
    """A transport the history-first fit must never touch."""

    def request(self, path, timeout_s=2.0):
        raise AssertionError(f"the history fit touched the transport: {path}")


def test_history_first_forecast_matches_jax_with_no_range_query(monkeypatch):
    init = params_from_jax(jf.init_params(jax.random.PRNGKey(0), jf.ForecastConfig()), "cpu")
    monkeypatch.setattr(tf, "init_params",
                        lambda gen, cfg, device=None: {k: v.clone().to(device) for k, v in init.items()})
    port, jax_store, mono = _stores()
    t = np.arange(45)
    for i in range(45):
        rows = [(f"n{c // 4}", str(c % 4), float(0.5 + 0.3 * np.sin(t[i] / 5 + c)), 0.9)
                for c in range(8)]
        for store in (port, jax_store):
            store.record_scrape(_scrape(rows))
        mono.now += 60.0
    metrics = _scrape([("n0", "0", 0.5, 0.9)])
    got, state = service.compute_forecast_incremental(
        _NoRangeQuery(), metrics, clock=clock, device="cpu", history_store=port)
    want, _ = jservice.compute_forecast_incremental(
        _NoRangeQuery(), metrics, clock=clock, history_store=jax_store)
    assert got.data_source == want.data_source == "history" and state is not None
    assert got.inference_path == "torch" and got.window_s == want.window_s == 39 * 60
    peaks = {(c.node, c.accelerator_id): c.predicted_peak for c in want.chips}
    assert len(got.chips) == len(peaks) == 8
    diff = max(abs(c.predicted_peak - peaks[(c.node, c.accelerator_id)]) for c in got.chips)
    assert diff <= PRED_TOL, diff
    warm, _ = service.compute_forecast_incremental(
        _NoRangeQuery(), metrics, state=state, clock=clock, device="cpu", history_store=port)
    assert (warm.data_source, warm.inference_path) == ("history", "torch-warm")


def test_a_thin_store_falls_through_to_the_live_window():
    app = DashboardApp(make_demo_transport("v5p32"), device="cpu", clock=clock,
                       min_sync_interval_s=0.0)
    try:
        status, _, body = app.handle("/tpu/metrics")
        assert status == 200 and "live-window history" in body
        assert any("/query_range" in c for c in app._transport.calls)
        assert app.history.scrapes == 1  # the scrape was captured, one point is no window
    finally:
        app.close()


def test_host_serves_trends_history_health_and_families():
    mono = Mono(1000.0)
    t = make_demo_transport("v5p32")
    app = DashboardApp(t, device="cpu", clock=clock, monotonic=mono, min_sync_interval_s=0.0)
    try:
        assert app.handle("/tpu/metrics")[0] == 200
        assert app.handle("/tpu")[0] == 200
        mono.now += 30.0
        calls = len(t.calls)
        status, ctype, body = app.handle("/tpu/trends")
        assert status == 200 and ctype == "text/html" and len(t.calls) == calls  # no sync
        for text in ("hl-trend-strip", "History store", "fleet.mean_tensorcore_utilization",
                     "sync.generation", 'href="/tpu/trends"'):
            assert text in body, text
        status, _, body = app.handle("/tpu/trends?window=900")
        assert status == 200 and 'hl-trend-window active" href="/tpu/trends?window=900"' in body
        status, _, body = app.handle("/tpu/trends?metric=chip.tensorcore_utilization&limit=4")
        assert status == 200 and "rows 1–4 of" in body and "hl-cursor-next" in body
        history = json.loads(app.handle("/healthz")[2])["runtime"]["history"]
        assert history["scrapes"] == 1 and history["syncs"] == 2 and history["points"] > 0
        metricsz = app.handle("/metricsz")[2]
        for family in ("points_total", "evicted_total", "memory_bytes", "window_span_seconds"):
            assert f"headlamp_tpu_torch_history_{family}" in metricsz, family
        assert "headlamp_tpu_history" not in metricsz
    finally:
        app.close()


def test_host_forecast_trains_on_history_once_the_store_holds_a_window():
    mono = Mono(1000.0)
    t = make_demo_transport("large")
    app = DashboardApp(t, device="cpu", clock=clock, monotonic=mono)
    try:
        metrics = app._cached_metrics()
        # The demo Prometheus's range query serves the first 64 chips.
        chips = metrics.chips[:64]
        values = tf.synthetic_telemetry(
            64, 61, torch.Generator().manual_seed(7), device="cpu").tolist()
        for step in range(61):
            app.history.record_scrape(_scrape([
                (c.node, c.accelerator_id, values[i][step], None) for i, c in enumerate(chips)
            ]))
            mono.now += 60.0
        calls = len(t.calls)
        status, _, body = app.handle("/tpu/metrics")
        view = app._forecast_refresher.peek(app._metrics_key(metrics), epoch=app._cache_epoch)
        assert status == 200 and "of captured history in" in body and "history history" not in body
        assert (view.data_source, view.inference_path, len(view.chips)) == ("history", "torch", 64)
        assert not any("/query_range" in c for c in t.calls[calls:])
    finally:
        app.close()

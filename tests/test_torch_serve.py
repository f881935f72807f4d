"""The port's serving runtime on the CPU: the refresher (stale serve
while a blocked refit runs, single flight, epoch invalidation, as
``tests/test_server.py`` pins for the JAX host, and a drain that a refit
spawned mid-drain cannot break), the warm-carry store,
the ``/metricsz`` text, the launch count under threads, the transfer
funnel, request traces, the ``/healthz`` runtime block, and a real
socket round trip through ``serve()`` and ``close()``."""

import json
import sys
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest
import torch

from headlamp_tpu.obs.metrics import registry as jax_registry
from headlamp_tpu_torch.models import aot
from headlamp_tpu_torch.models import fused_forward as ff
from headlamp_tpu_torch.obs import slo as slo_mod
from headlamp_tpu_torch.obs.metrics import MetricRegistry
from headlamp_tpu_torch.obs.metrics import registry as port_registry
from headlamp_tpu_torch.obs.trace import trace_ring
from headlamp_tpu_torch.runtime import refresh as refresh_mod
from headlamp_tpu_torch.runtime import transfer
from headlamp_tpu_torch.runtime.refresh import Refresher
from headlamp_tpu_torch.runtime.device_cache import WarmCarryCache, warm_carries
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

#: pytest-xdist runs several workers on the same cores: one intra-op
#: thread each keeps torch's spinning thread pools from oversubscribing
#: them.
torch.set_num_threads(1)

CLOCK = 1785283200.0


def clock():
    return CLOCK


def _metrics(*chips):
    return SimpleNamespace(
        namespace="monitoring",
        service="prometheus-k8s:9090",
        chips=[SimpleNamespace(node=n, accelerator_id=a) for n, a in chips],
    )


class TestRefresher:
    def test_slow_refit_never_blocks_stale_reads(self):
        # A reader inside the grace window gets the stale entry at once
        # while exactly one background refit runs, proven with a fit that
        # stays blocked until the test releases it.
        mono = [100.0]
        app = DashboardApp(make_demo_transport("v5e4"), device="cpu", monotonic=lambda: mono[0])
        release = threading.Event()
        fits = []

        def slow_fit(m):
            fits.append(1)
            if len(fits) > 1:
                release.wait(10.0)
            return f"view{len(fits)}"

        app._compute_forecast = slow_fit
        m = _metrics(("n1", "0"))
        try:
            assert app._forecast_for(m) == "view1"  # cold fill
            mono[0] += app.FORECAST_TTL_S + 1  # stale, inside grace
            assert app._forecast_for(m) == "view1"  # served while the refit blocks
            got = []
            t = threading.Thread(target=lambda: got.append(app._forecast_for(m)))
            t.start()
            t.join(5.0)
            assert not t.is_alive()
            assert got == ["view1"] and len(fits) == 2  # one flight, not two
            assert app._forecast_refresher.snapshot()["served_stale"] == 2
        finally:
            release.set()
        assert app._forecast_refresher.drain()
        assert app._forecast_for(m) == "view2"
        assert not app._forecast_refresher._threads

    def test_epoch_bump_and_fleet_change_refit(self):
        app = DashboardApp(make_demo_transport("v5e4"), device="cpu")
        try:
            fits = []
            app._compute_forecast = lambda m: (fits.append(1), f"view{len(fits)}")[1]
            m1 = _metrics(("n1", "0"), ("n1", "1"))
            assert app._forecast_for(m1) == "view1" and app._forecast_for(m1) == "view1"
            # A different chip set never gets another fleet's forecast.
            assert app._forecast_for(_metrics(("n2", "0"))) == "view2"
            # /refresh bumps the epoch: the old entry is invisible and the
            # next read blocks on a fresh fit.
            assert app.handle("/refresh")[0] == 302
            assert app._forecast_refresher.peek(
                app._metrics_key(m1), epoch=app._cache_epoch) is None
            assert app._forecast_for(m1) == "view3" and len(fits) == 3
            # get_nowait: a cold key starts the fit in the background and
            # answers None; once it lands, the value (and on_store saw it).
            stored = []
            r = app._forecast_refresher
            r.on_store = lambda key, value: stored.append(value)
            assert r.get_nowait("cold", lambda: "bg") is None
            assert r.drain() and r.get_nowait("cold", lambda: "again") == "bg"
            assert stored == ["bg"]
        finally:
            app.close()

    def test_drain_survives_a_refit_spawned_between_its_join_and_its_prune(self, monkeypatch):
        # The refit thread's join() spawns another refit once it has
        # ended: the spawn rebuilds the thread list without the joined
        # thread, which drain() used to remove by identity (ValueError).
        r = Refresher("forecast", ttl_s=60.0, grace_s=600.0, monotonic=lambda: 0.0)
        spawned = []

        class SpawningThread(threading.Thread):
            def join(self, timeout=None):
                super().join(timeout)
                if not spawned:
                    spawned.append(r.get_nowait("second", lambda: "two"))

        monkeypatch.setattr(refresh_mod.threading, "Thread", SpawningThread)
        assert r.get_nowait("first", lambda: "one") is None
        assert r.drain(10.0) is True
        assert spawned == [None] and not r._threads
        assert r.get_nowait("first", lambda: "x") == "one"
        assert r.get_nowait("second", lambda: "x") == "two"


def test_warm_carry_cache_pops_and_evicts_least_recently_stored():
    cache = WarmCarryCache()
    assert cache.max_keys == 8
    cache.store("a", 1)
    assert cache.take("a") == 1 and cache.take("a") is None  # pop, not peek
    for i in range(10):
        cache.store(i, i)
    cache.store(2, "again")  # re-stored: now the most recent
    for i in range(3):
        cache.store(100 + i, i)
    assert len(cache) == 8
    assert [k for k in range(10) if cache.take(k) is not None] == [2, 6, 7, 8, 9]
    assert cache.counters() == {"hits": 6, "lookups": 12, "evictions": 5}
    cache.invalidate()
    assert len(cache) == 0


def test_metricsz_text_is_the_ports_own():
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=clock)
    assert app.handle("/healthz")[0] == 200
    status, ctype, text = app.handle("/metricsz")
    assert (status, ctype) == (200, "text/plain")
    names = {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}
    assert names and all(n.startswith("headlamp_tpu_torch_") for n in names)
    assert names.isdisjoint(m.name for m in jax_registry)
    assert "# TYPE headlamp_tpu_torch_requests_total counter" in text
    line = 'headlamp_tpu_torch_requests_total{route="/healthz",status="200"} '
    assert any(s.startswith(line) and int(s[len(line):]) >= 1 for s in text.splitlines())
    assert 'headlamp_tpu_torch_request_duration_seconds_bucket{route="/healthz",le="+Inf"}' in text
    # Names are validated, and each kind renders in the text format.
    reg = MetricRegistry()
    with pytest.raises(ValueError):
        reg.counter("headlamp_tpu_requests_total", "JAX prefix")
    with pytest.raises(ValueError):
        reg.counter("headlamp_tpu_torch_requests", "no unit suffix")
    reg.gauge("headlamp_tpu_torch_depth_count", "g").set(3)
    reg.gauge_fn("headlamp_tpu_torch_gone_ratio", "omitted", lambda: None)
    reg.gauge_fn("headlamp_tpu_torch_broken_ratio", "omitted", lambda: 1 / 0)
    reg.histogram("headlamp_tpu_torch_fit_seconds", "h", buckets=(0.1, 1.0)).observe(0.5)
    assert reg.render().splitlines() == [
        "# HELP headlamp_tpu_torch_broken_ratio omitted",
        "# TYPE headlamp_tpu_torch_broken_ratio gauge",
        "# HELP headlamp_tpu_torch_depth_count g",
        "# TYPE headlamp_tpu_torch_depth_count gauge",
        "headlamp_tpu_torch_depth_count 3",
        "# HELP headlamp_tpu_torch_fit_seconds h",
        "# TYPE headlamp_tpu_torch_fit_seconds histogram",
        'headlamp_tpu_torch_fit_seconds_bucket{le="0.1"} 0',
        'headlamp_tpu_torch_fit_seconds_bucket{le="1"} 1',
        'headlamp_tpu_torch_fit_seconds_bucket{le="+Inf"} 1',
        "headlamp_tpu_torch_fit_seconds_sum 0.5",
        "headlamp_tpu_torch_fit_seconds_count 1",
        "# HELP headlamp_tpu_torch_gone_ratio omitted",
        "# TYPE headlamp_tpu_torch_gone_ratio gauge",
    ]
    assert port_registry is not reg


def test_launch_count_is_exact_under_eight_threads():
    count = ff.LaunchCount()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(8) as pool:
            for f in [pool.submit(lambda: [count.add() for _ in range(5000)]) for _ in range(8)]:
                f.result(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert count.n == 8 * 5000


def test_transfer_counts_only_copies_from_a_card():
    before = transfer.transfer_stats.snapshot()
    batch = transfer.TransferBatch()
    a, b = torch.arange(4.0), torch.ones(2)
    with batch.scope():
        handles = [batch.register(a), batch.register(b)]
        assert torch.equal(handles[0].result(), a) and torch.equal(handles[1].result(), b)
        assert torch.equal(transfer.fetch(a), a)
    # CPU tensors cross no device boundary: nothing blocking is counted.
    assert batch.blocking_gets == 0
    after = transfer.transfer_stats.snapshot()
    assert after["blocking_gets"] == before["blocking_gets"]
    assert after["coalesced_trees"] == before["coalesced_trees"] + 2


def test_metrics_request_trace_and_healthz_runtime():
    warm_carries.invalidate()
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=clock)
    try:
        assert app.handle("/tpu/metrics")[0] == 200
        trace = trace_ring.snapshot()[0]
        assert (trace["route"], trace["status"], trace["device_gets"]) == ("/tpu/metrics", 200, 0)

        def names(spans):
            for s in spans:
                yield s["name"], s["attrs"]
                yield from names(s["children"])

        spans = dict(names(trace["spans"]))
        for name in ("page.data", "page.data.forecast", "refresh.fit", "forecast.history",
                     "forecast.fit", "page.component", "render.html"):
            assert name in spans, name
        assert spans["forecast.fit"]["inference_path"] == "torch"
        status, _, body = app.handle("/healthz")
        health = json.loads(body)
        assert trace_ring.snapshot()[0] == trace  # probes stay out of the ring
        assert set(health) == {
            "ok", "loading", "errors", "fetched_at", "nodes", "analytics", "runtime",
            "last_sync_age_s", "consecutive_sync_failures", "background_sync",
        } and health["ok"] is True
        assert health["nodes"] == 2 and health["analytics"]["chosen_backend"] == "python"
        assert health["background_sync"] is False and health["consecutive_sync_failures"] == 0
        runtime = health["runtime"]
        assert set(runtime) == {
            "transfer", "fleet_cache", "warm_carries", "refresh", "device",
            "watch", "background", "history", "graphs", "aot", "slo", "profiler", "push", "render",
        }
        assert set(runtime["slo"]["states"]) == {
            "scrape_paint", "dashboard_render", "forecast_fit", "transport_connect",
            "data_freshness",
        } and runtime["slo"]["budget_fit_error"] is None
        assert runtime["profiler"]["running"] is False  # only serve() starts it
        # Building an app never starts the registry: the fit ran eagerly.
        assert runtime["aot"]["state"] == aot.registry().state
        assert runtime["graphs"]["programs"]["forecast.fit_forecast_state_program"]["eager"] >= 1
        assert runtime["history"]["scrapes"] == 1  # the metrics fetch was captured
        assert runtime["device"] == {
            "torch_device": "cpu", "kernel": "forecast_mlp_forward", "kernel_path": "torch",
            "launches": ff.LAUNCHES.n, "build": None,
        }
        assert runtime["warm_carries"]["entries"] == 1
        assert set(runtime["refresh"]) == {"metrics", "forecast"}
        assert runtime["refresh"]["forecast"]["refits"] == 1
        assert runtime["refresh"]["forecast"]["last_refit_error"] is None
    finally:
        app.close()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.headers.get_content_type(), resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers.get_content_type(), exc.read().decode()


def test_socket_round_trip_leaves_no_thread_running(monkeypatch):
    before = set(threading.enumerate())
    # serve() starts the process's program registry: a fresh one for this
    # test, so the rest of the process keeps its eager path.
    reg = aot.AotProgramRegistry()
    monkeypatch.setattr(aot, "_REGISTRY", reg)
    # The gateway sheds off the process SLO engine: a fresh one, so the
    # 5xx other tests in this process served cannot degrade these renders.
    monkeypatch.setattr(slo_mod, "_engine", slo_mod.SLOEngine())
    warm_carries.invalidate()
    mono = [0.0]
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=clock,
                       monotonic=lambda: mono[0])
    server = app.serve("127.0.0.1", 0)
    try:
        with ThreadPoolExecutor(4) as pool:
            got = list(pool.map(lambda _: _get(server.url + "/tpu/metrics"), range(4)))
        assert [g[:2] for g in got] == [(200, "text/html")] * 4
        assert app._forecast_refresher.snapshot()["refits"] == 1  # one fit for all four
        mono[0] += app.FORECAST_TTL_S + 1  # the next GET starts a background refit
        assert _get(server.url + "/tpu/metrics")[0] == 200
        assert _get(server.url + "/healthz")[:2] == (200, "application/json")
        assert _get(server.url + "/metricsz")[:2] == (200, "text/plain")
        assert _get(server.url + "/nope")[0] == 404
        with urllib.request.urlopen(server.url + "/refresh?back=//evil", timeout=60) as resp:
            assert resp.url == server.url + "/tpu" and resp.status == 200
    finally:
        server.close()
    # Server, request, refit and capture threads (other tests' threads aside).
    left = [t.name for t in set(threading.enumerate()) - before
            if t.name.startswith(("hl-torch-serve", "hl-torch-aot", "refresh-", "Thread-"))]
    assert left == [] and len(warm_carries) == 0
    assert reg.state == "ready" and reg.compile_errors == 0
    with pytest.raises(OSError):
        urllib.request.urlopen(server.url + "/healthz", timeout=5)

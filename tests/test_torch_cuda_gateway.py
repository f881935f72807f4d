"""The port's host behind its request gateway on the card, at ``--demo
large``: sixteen identical cold ``/tpu/metrics`` requests after
``/refresh`` cost one render and one launch of ``forecast_mlp_forward``
(a replay of the registry's 64 × 61 graph); a degraded render and a 304
launch nothing; ``KubeTransport`` against a local stand-in apiserver
paints what the demo transport paints (the measured timings masked),
with one kernel launch for its fit. The render workers run on the app's
card. A CUDA kernel and a CUDA graph have no CPU mode, so every test here
needs a CUDA device and skips without one. On the card:

    python -m pytest tests/test_torch_cuda_gateway.py -q -s
"""

from __future__ import annotations

import re
import threading
import time

import pytest
import torch

from headlamp_tpu_torch.models import aot
from headlamp_tpu_torch.models import forecast as tf
from headlamp_tpu_torch.models.fused_forward import LAUNCHES
from headlamp_tpu_torch.obs import graphcost
from headlamp_tpu_torch.obs import slo as tslo
from headlamp_tpu_torch.runtime.device_cache import warm_carries
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport
from headlamp_tpu_torch.server.standin import StandInApiserver
from headlamp_tpu_torch.transport import KubeTransport

CLOCK = 1785283200.0
_TIMINGS = re.compile(r"(history in|took) [0-9.e+-]+ ms")


def clock():
    return CLOCK


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel and its graphs have no CPU mode")
    monkeypatch.setattr(graphcost, "_LEDGER", graphcost.GraphCostLedger())
    cfg = tf.ForecastConfig()
    reg = aot.AotProgramRegistry(specs=[
        (tf.COLD_PROGRAM, (64, aot.LIVE_WINDOW_SAMPLES, cfg, 60)),
        (tf.WARM_PROGRAM, (64, aot.LIVE_WINDOW_SAMPLES, cfg, tf.WARM_STEPS)),
    ])
    reg.compile_startup("cuda", block=True)
    assert reg.ready() and reg.compile_errors == 0, reg.snapshot()
    monkeypatch.setattr(aot, "_REGISTRY", reg)
    warm_carries.invalidate()
    return reg


def _app(transport=None):
    return DashboardApp(transport or make_demo_transport("large"), device="cuda", clock=clock,
                        min_sync_interval_s=3600.0)


def test_a_cold_burst_after_refresh_is_one_render_and_one_launch(card):
    app = _app()
    gw = app.ensure_gateway(engine=lambda: tslo.SLOEngine())
    n, inner, seen = 16, gw._handle, []

    def gated(path, **kw):
        seen.append(torch.cuda.current_device())
        deadline = time.monotonic() + 10.0
        while not any(f.followers == n - 1 for f in list(gw.coalescer._flights.values())):
            assert time.monotonic() < deadline
            time.sleep(0.001)
        return inner(path, **kw)

    try:
        assert gw.handle("/tpu/metrics").status == 200
        assert app.handle("/refresh?back=/tpu/metrics")[0] == 302
        gw._handle = gated
        before = gw.counters()
        LAUNCHES.reset()
        results = [None] * n
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, gw.handle("/tpu/metrics"))) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        torch.cuda.synchronize()
        after = gw.counters()
        assert {r.status for r in results} == {200} and len({r.body for r in results}) == 1
        assert after["rendered"] - before["rendered"] == 1
        assert after["coalesced_followers"] - before["coalesced_followers"] == n - 1
        assert LAUNCHES.n == 1 and seen == [app._cuda_index]
        etag = dict(results[0].headers)["ETag"]
        assert gw.handle("/tpu/metrics", if_none_match=etag).status == 304
        assert LAUNCHES.n == 1
    finally:
        app.close()


def test_a_degraded_metrics_render_launches_nothing(card):
    engines = {"now": tslo.SLOEngine()}
    app = _app()
    gw = app.ensure_gateway(engine=lambda: engines["now"])
    try:
        assert gw.handle("/tpu/metrics").status == 200
        assert app.handle("/refresh?back=/tpu/metrics")[0] == 302
        pager = tslo.SLOEngine(monotonic=lambda: 1000.0)
        for _ in range(600):
            pager.record("scrape_paint", False)
        engines["now"] = pager
        gw.shed_policy.invalidate()
        LAUNCHES.reset()
        before = graphcost.ledger().counters()
        degraded = gw.handle("/tpu/metrics")
        torch.cuda.synchronize()
        assert dict(degraded.headers)["X-Headlamp-Stale"] == "1"
        assert "Utilization Forecast" not in degraded.body
        assert LAUNCHES.n == 0 and graphcost.ledger().counters() == before
        engines["now"] = tslo.SLOEngine()
        gw.shed_policy.invalidate()
        assert "Utilization Forecast" in gw.handle("/tpu/metrics").body
        torch.cuda.synchronize()
        assert LAUNCHES.n == 1
    finally:
        app.close()


def test_kube_transport_paints_equal_the_demo_on_the_card(card):
    stand = StandInApiserver(make_demo_transport("large"))
    transport = KubeTransport(stand.url)
    try:
        bodies = {}
        for name, t in (("demo", make_demo_transport("large")), ("kube", transport)):
            warm_carries.invalidate()
            app = _app(t)
            LAUNCHES.reset()
            bodies[name] = [app.handle(p)[2] for p in ("/tpu", "/tpu/metrics")]
            torch.cuda.synchronize()
            assert LAUNCHES.n == 1, name
            app.close()
        for got, want in zip(bodies["kube"], bodies["demo"]):
            assert _TIMINGS.sub("#", got.split("<main>")[1]) == _TIMINGS.sub(
                "#", want.split("<main>")[1])
        assert stand.connects == transport.pool.opened and transport.pool.reused > 0
    finally:
        transport.pool.close()
        stand.close()

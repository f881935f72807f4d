"""The port's host behind its request gateway, on the CPU, against the JAX
host behind its own.

At ``--demo large`` (``fleet_large(1024)``) both hosts answer through
``ensure_gateway()``: the pages' ``<main>`` bytes are equal, and so are
their ``ETag``, ``Cache-Control`` and ``X-Headlamp-*`` headers for the
same generation, epoch and window (exact). A degraded ``/tpu/metrics``
(the scrape_paint objective paging) fits nothing: no refit, no graph
replay or eager run, no forecast panel; a restored engine fits again.
Sixteen identical cold requests after ``/refresh`` cost one render and
one fit. Over the socket a 304 has no body, a 200 is gzipped with
``Vary``, a paged ``/debug/*`` is a 503 with ``Retry-After: 5`` while the
ops surfaces answer, and ``close()`` leaves no render or fan-out thread.
``KubeTransport`` against a local stand-in apiserver paints what the demo
transport paints (the measured timings masked), reusing its sockets. The
entry points build the real transport for ``--apiserver`` and
``--in-cluster``, and ``--active-pods-only`` filters the pod list at the
apiserver as JAX's does.
"""

from __future__ import annotations

import gzip
import json
import re
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from headlamp_tpu.context.sources import ACTIVE_PODS_FIELD_SELECTOR as JAX_ACTIVE_PODS
from headlamp_tpu.obs import slo as jslo
from headlamp_tpu.runtime import device_cache as jax_device_cache
from headlamp_tpu.server import DashboardApp as JaxApp
from headlamp_tpu.server import make_demo_transport as jax_demo_transport
from headlamp_tpu_torch import cli
from headlamp_tpu_torch.context import ACTIVE_PODS_FIELD_SELECTOR
from headlamp_tpu_torch.models import aot
from headlamp_tpu_torch.models.fused_forward import LAUNCHES
from headlamp_tpu_torch.obs import graphcost
from headlamp_tpu_torch.obs import slo as tslo
from headlamp_tpu_torch.obs.trace import trace_ring
from headlamp_tpu_torch.runtime.device_cache import warm_carries
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport
from headlamp_tpu_torch.server import app as app_mod
from headlamp_tpu_torch.server import demo as demo_mod
from headlamp_tpu_torch.server.__main__ import main as server_main
from headlamp_tpu_torch.server.standin import StandInApiserver
from headlamp_tpu_torch.transport import KubeTransport
from headlamp_tpu_torch.transport import api_proxy

torch.set_num_threads(1)

CLOCK = 1785283200.0
PAGES = ("/tpu", "/tpu/nodes?page=2", "/tpu/pods?limit=5", "/tpu/fleet")
#: The two measured durations a metrics page prints.
_TIMINGS = re.compile(r"(history in|took) [0-9.e+-]+ ms")
_FORECAST = "Utilization Forecast"


def clock():
    return CLOCK


def _main(body):
    return re.search(r"<main>(.*)</main>", body, re.S).group(1)


def _page_headers(response):
    return {k: v for k, v in response.headers if k in (
        "ETag", "Cache-Control", "X-Headlamp-Generation", "X-Headlamp-Stale")}


def _paging(slo_mod, objective):
    eng = slo_mod.SLOEngine(monotonic=lambda: 1000.0)
    for _ in range(600):
        eng.record(objective, False)
    assert eng.health_block()[objective] == "page"
    return eng


def _wait(pred, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.005)


def test_pages_behind_both_gateways_have_equal_main_and_headers():
    port = DashboardApp(make_demo_transport("large"), device="cpu", clock=clock,
                        min_sync_interval_s=3600.0)
    jax = JaxApp(jax_demo_transport("large"), clock=clock, min_sync_interval_s=3600.0)
    gws = {
        "port": port.ensure_gateway(workers=2, engine=lambda: tslo.SLOEngine()),
        "jax": jax.ensure_gateway(workers=2, engine=lambda: jslo.SLOEngine()),
    }
    try:
        out = {}
        for name, gw in gws.items():
            if name == "jax":
                jax_device_cache.fleet_cache.invalidate()
                jax_device_cache.rollup_results.invalidate()
            out[name] = [gw.handle(path) for path in PAGES]
        for path, got, want in zip(PAGES, out["port"], out["jax"]):
            assert got.status == want.status == 200, path
            assert _main(got.body) == _main(want.body), path
            assert _page_headers(got) == _page_headers(want), path
        etags = {dict(r.headers)["ETag"] for r in out["port"]}
        # Each window its own validator; the two bare paths share one, as
        # in JAX (the tag hashes the window, not the route).
        assert len(etags) == len(PAGES) - 1
        assert dict(out["port"][0].headers)["ETag"] == f'"g{port.snapshot_generation()}-e0-d0"'
        health = json.loads(gws["port"].handle("/healthz").body)["runtime"]["gateway"]
        assert health["rendered"] == len(PAGES) and health["bypassed"] == 1
        assert health["workers"] == 2 and "transport" not in json.loads(
            gws["port"].handle("/healthz").body)["runtime"]
    finally:
        port.close()
        gws["jax"].close()


def test_a_degraded_metrics_render_fits_nothing_until_restored():
    warm_carries.invalidate()
    engines = {"now": tslo.SLOEngine()}
    app = DashboardApp(make_demo_transport("large"), device="cpu", clock=clock,
                       min_sync_interval_s=3600.0)
    gw = app.ensure_gateway(workers=2, engine=lambda: engines["now"])
    try:
        assert _FORECAST in gw.handle("/tpu/metrics").body  # a cold fit
        assert app.handle("/refresh?back=/tpu/metrics")[0] == 302  # every cache is stale now
        engines["now"] = _paging(tslo, "scrape_paint")
        gw.shed_policy.invalidate()
        before = (app._forecast_refresher.snapshot()["refits"], LAUNCHES.n,
                  graphcost.ledger().counters())
        degraded = gw.handle("/tpu/metrics")
        assert app._forecast_refresher.drain() and app._metrics_refresher.drain()
        after = (app._forecast_refresher.snapshot()["refits"], LAUNCHES.n,
                 graphcost.ledger().counters())
        assert degraded.status == 200 and dict(degraded.headers)["X-Headlamp-Stale"] == "1"
        assert _FORECAST not in degraded.body
        assert after == before  # no fit, no launch, no replay, no eager run
        trace = trace_ring.snapshot()[0]
        admission = next(s for s in trace["spans"] if s["name"] == "gateway.admission")
        assert admission["attrs"]["degraded"] is True and admission["attrs"]["priority"] == "interactive"
        # The dashboard pages stay full fidelity: only scrape_paint pages.
        assert dict(gw.handle("/tpu").headers)["X-Headlamp-Stale"] == "0"
        engines["now"] = tslo.SLOEngine()
        gw.shed_policy.invalidate()
        restored = gw.handle("/tpu/metrics")
        assert dict(restored.headers)["X-Headlamp-Stale"] == "0" and _FORECAST in restored.body
        assert app._forecast_refresher.snapshot()["refits"] == before[0] + 1
        assert gw.counters()["degraded_renders"] == 1
    finally:
        app.close()


def test_sixteen_identical_cold_requests_after_refresh_cost_one_fit():
    warm_carries.invalidate()
    app = DashboardApp(make_demo_transport("large"), device="cpu", clock=clock,
                       min_sync_interval_s=3600.0)
    gw = app.ensure_gateway(engine=lambda: tslo.SLOEngine())
    inner = gw._handle
    n = 16

    def gated(path, **kw):
        # The leader renders once every other request has joined it.
        _wait(lambda: any(f.followers == n - 1 for f in list(gw.coalescer._flights.values())))
        return inner(path, **kw)

    try:
        gw.handle("/tpu/metrics")
        assert app.handle("/refresh?back=/tpu/metrics")[0] == 302
        gw._handle = gated
        before = gw.counters(), app._forecast_refresher.snapshot()["refits"]
        results = [None] * n
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, gw.handle("/tpu/metrics"))) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        after = gw.counters()
        assert {r.status for r in results} == {200} and len({r.body for r in results}) == 1
        assert len({dict(r.headers)["ETag"] for r in results}) == 1
        assert after["rendered"] - before[0]["rendered"] == 1
        assert after["coalesced_followers"] - before[0]["coalesced_followers"] == n - 1
        assert app._forecast_refresher.snapshot()["refits"] - before[1] == 1
        # The epoch is in the validator; a 304 renders nothing.
        etag = dict(results[0].headers)["ETag"]
        assert etag.startswith('"g') and "-e1-d0" in etag
        nm = gw.handle("/tpu/metrics", if_none_match=etag)
        assert (nm.status, nm.body) == (304, "") and gw.counters()["rendered"] == after["rendered"]
    finally:
        app.close()


def _socket_get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read()


def test_the_socket_answers_304_gzip_and_sheds_debug(monkeypatch):
    monkeypatch.setattr(aot, "_REGISTRY", aot.AotProgramRegistry())
    before = set(threading.enumerate())
    engines = {"now": tslo.SLOEngine()}
    app = DashboardApp(make_demo_transport("large"), device="cpu", clock=clock,
                       min_sync_interval_s=3600.0)
    app.ensure_gateway(engine=lambda: engines["now"])
    server = app.serve("127.0.0.1", 0)
    try:
        status, headers, body = _socket_get(server.url + "/tpu", {"Accept-Encoding": "gzip"})
        assert status == 200 and headers["Content-Encoding"] == "gzip"
        assert headers["Vary"] == "Accept-Encoding" and headers["Cache-Control"] == "no-cache"
        page = gzip.decompress(body).decode()
        assert "Chip Allocation" in page and int(headers["Content-Length"]) == len(body)
        status, headers304, body304 = _socket_get(
            server.url + "/tpu", {"If-None-Match": headers["ETag"]})
        assert (status, body304) == (304, b"") and headers304["ETag"] == headers["ETag"]
        assert "Content-Type" not in headers304
        plain = _socket_get(server.url + "/tpu")
        assert plain[0] == 200 and plain[2].decode() == page and "Content-Encoding" not in plain[1]
        health = json.loads(_socket_get(server.url + "/healthz")[2])["runtime"]["gateway"]
        assert health["workers"] == 4 and health["not_modified"] == 1
        engines["now"] = _paging(tslo, "dashboard_render")
        app.gateway.shed_policy.invalidate()
        status, headers, body = _socket_get(server.url + "/debug/traces")
        assert (status, headers["Retry-After"]) == (503, "5")
        assert json.loads(body)["reason"] == "burn_rate"
        for path in ("/metricsz", "/sloz", "/healthz"):
            assert _socket_get(server.url + path)[0] == 200, path
        status, headers, _ = _socket_get(server.url + "/tpu/nodes")
        assert status == 200 and headers["X-Headlamp-Stale"] == "1"
    finally:
        server.close()
    left = [t.name for t in set(threading.enumerate()) - before
            if t.name.startswith(("hl-torch-render", "hl-torch-fanout", "hl-torch-serve"))]
    assert left == [] and app.gateway.pool.inflight() == 0


def _timeless(body):
    return _TIMINGS.sub(r"\1 # ms", _main(body))


def test_kube_transport_paints_equal_the_demo_and_reuse_sockets():
    stand = StandInApiserver(make_demo_transport("large"))
    transport = KubeTransport(stand.url)
    try:
        paints = {}
        for name, t in (("kube", transport), ("demo", make_demo_transport("large"))):
            warm_carries.invalidate()
            app = DashboardApp(t, device="cpu", clock=clock, min_sync_interval_s=3600.0)
            paints[name] = [app.handle(p) for p in ("/tpu", "/tpu/metrics")]
            if name == "kube":
                runtime = json.loads(app.handle("/healthz")[2])["runtime"]
                counters = app._runtime_counters()
            app.close()
        for got, want in zip(paints["kube"], paints["demo"]):
            assert got[0] == want[0] == 200
            assert _timeless(got[2]) == _timeless(want[2])
        assert _FORECAST in paints["kube"][1][2]
        assert runtime["transport"]["connections_opened"] == transport.pool.opened >= 1
        assert counters["transport.connections_reused"] >= 1
        before = transport.pool.snapshot()
        for _ in range(5):  # warm paints on fresh apps over the one transport
            app = DashboardApp(transport, device="cpu", clock=clock, min_sync_interval_s=0.0)
            assert app.handle("/tpu/metrics")[0] == 200
            app.close()
        after = transport.pool.snapshot()
        opened = after["connections_opened"] - before["connections_opened"]
        reused = after["connections_reused"] - before["connections_reused"]
        assert opened / 5 <= 1 and reused / (opened + reused) >= 0.9
        assert stand.connects == transport.pool.opened
    finally:
        transport.pool.close()
        stand.close()


def test_the_entry_points_build_the_real_transport(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(aot, "_REGISTRY", aot.AotProgramRegistry())
    stand = StandInApiserver(make_demo_transport("v5e4"))
    seen = {}

    def wait(server):
        seen["transport"] = type(server.app._transport).__name__
        seen["healthz"] = json.loads(server.app.handle("/healthz")[2])["runtime"]
        raise KeyboardInterrupt

    monkeypatch.setattr(app_mod.DashboardServer, "wait", wait)
    try:
        server_main(["--apiserver", stand.url, "--device", "cpu", "--port", "0",
                     "--active-pods-only"])
        assert seen["transport"] == "KubeTransport" and "gateway" in seen["healthz"]
        assert "transport" in seen["healthz"]
        assert f"({stand.url}, device cpu)" in capsys.readouterr().out
        assert cli.main(["overview", "--apiserver", stand.url, "--device", "cpu"]) == 0
        assert "Chip Allocation" in capsys.readouterr().out
    finally:
        stand.close()
    with pytest.raises(SystemExit):
        server_main(["--demo", "v5e4", "--apiserver", stand.url, "--device", "cpu"])
    # --in-cluster reads the service account's token and CA.
    (tmp_path / "token").write_text("s3cret\n")
    (tmp_path / "ca.crt").write_text("")
    monkeypatch.setattr(api_proxy.KubeTransport, "SERVICE_ACCOUNT_DIR", str(tmp_path))
    monkeypatch.setattr(api_proxy.ssl, "create_default_context", lambda cafile=None: cafile)
    args = type("Args", (), {"demo": None, "apiserver": None, "in_cluster": True})()
    transport, mode = demo_mod.transport_from_args(None, args)
    assert mode == "in-cluster" and transport.base_url == "https://kubernetes.default.svc"
    assert transport._headers["Authorization"] == "Bearer s3cret"
    assert transport._ssl_context == f"{tmp_path}/ca.crt"


def test_active_pods_only_filters_the_pod_list_as_jax_does():
    port_t, jax_t = make_demo_transport("v5e4"), jax_demo_transport("v5e4")
    app = DashboardApp(port_t, device="cpu", clock=clock, pod_field_selector=ACTIVE_PODS_FIELD_SELECTOR)
    jax = JaxApp(jax_t, clock=clock, pod_field_selector=JAX_ACTIVE_PODS)
    assert ACTIVE_PODS_FIELD_SELECTOR == JAX_ACTIVE_PODS
    try:
        assert app.handle("/tpu")[0] == jax.handle("/tpu")[0] == 200
    finally:
        app.close()

    def pod_lists(calls):
        return sorted(c for c in calls if c.startswith("/api/v1/pods?") and "labelSelector" not in c)

    assert pod_lists(port_t.calls) == pod_lists(jax_t.calls)
    assert any("fieldSelector=status.phase%21%3DSucceeded" in c for c in pod_lists(port_t.calls))

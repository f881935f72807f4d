"""The port's dashboard host against the JAX package's, on the CPU.

Both apps serve ``make_demo_transport("v5e4")`` with a fixed wall clock
and a list-cell monotonic clock; the port's cold fits start from the JAX
package's PRNGKey(0) init, so the two fit the same model. The page's
``<main>`` markup outside the forecast section must be byte-identical
(the scrape timer is pinned in both packages, since it reads
``perf_counter``); the forecasts, cold and after a warm background
refit, agree to 1e-2 as in ``tests/test_torch_service.py``. A fit that
raises is a 500 naming it on the request path and a counted, named
refit error on the background path; the Intel routes answer JAX's
pages (and ``/tpu/trends`` a 200, now that the history store is ported), ``/events``
answers an event stream over the socket (``?region=`` a region's), and
``/refresh`` returns home to the Overview.
"""

import http.client
import json
import re

import jax
import pytest
import torch

from headlamp_tpu.metrics import timing as jtiming
from headlamp_tpu.models import forecast as jf
from headlamp_tpu.runtime.device_cache import warm_carries as jax_carries
from headlamp_tpu.server import DashboardApp as JaxApp
from headlamp_tpu.server import make_demo_transport as jax_demo_transport
from headlamp_tpu_torch.metrics import timing
from headlamp_tpu_torch.models import aot
from headlamp_tpu_torch.models import forecast as tf
from headlamp_tpu_torch.models import service
from headlamp_tpu_torch.models.convert import params_from_jax
from headlamp_tpu_torch.obs import slo as slo_mod
from headlamp_tpu_torch.runtime.device_cache import warm_carries
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport
from headlamp_tpu_torch.server.__main__ import main as server_main

#: pytest-xdist runs several workers on the same cores: one intra-op
#: thread each keeps torch's spinning thread pools from oversubscribing
#: them.
torch.set_num_threads(1)

CLOCK = 1785283200.0
PRED_TOL = 1e-2
#: Chips this close to the 90% line may fall on either side of it
#: between the two packages; they are left out of the at-risk sets.
RISK_MARGIN = 1e-2
_FORECAST_SECTION = re.compile(
    r'<section class="hl-section"><h2 class="hl-section-title">Utilization Forecast.*?</section>'
)


def clock():
    return CLOCK


def _pin_scrape_timer(mp):
    for module in (timing, jtiming):
        mp.setattr(module.FetchTimer, "stamp", lambda self: (self._clock(), 12.5))


def _start_from_jax_init(mp):
    init = params_from_jax(jf.init_params(jax.random.PRNGKey(0), jf.ForecastConfig()), "cpu")
    mp.setattr(
        tf, "init_params",
        lambda gen, cfg, device=None: {k: v.clone().to(device) for k, v in init.items()},
    )


def _view(app):
    metrics = app._cached_metrics()
    return app._forecast_refresher.peek(app._metrics_key(metrics), epoch=app._cache_epoch)


def _main_outside_forecast(body):
    main = re.search(r"<main>(.*)</main>", body, re.S).group(1)
    assert len(_FORECAST_SECTION.findall(main)) == 1
    return _FORECAST_SECTION.sub("", main)


@pytest.fixture(scope="module")
def served():
    """Both apps: a cold GET, then a GET past the forecast TTL (stale
    page, background warm refit), drained. Yields what each served."""
    with pytest.MonkeyPatch.context() as mp:
        _pin_scrape_timer(mp)
        _start_from_jax_init(mp)
        warm_carries.invalidate()
        jax_carries.invalidate()
        mono = [100.0]
        apps = {
            "port": DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=clock,
                                 monotonic=lambda: mono[0]),
            "jax": JaxApp(jax_demo_transport("v5e4"), min_sync_interval_s=0.0, clock=clock,
                          monotonic=lambda: mono[0]),
        }
        out = {name: {"cold": (app.handle("/tpu/metrics"), _view(app))}
               for name, app in apps.items()}
        mono[0] += DashboardApp.FORECAST_TTL_S + 1
        for name, app in apps.items():
            stale = app.handle("/tpu/metrics")
            assert app._forecast_refresher.drain()
            out[name]["warm"] = (stale, _view(app))
        apps["port"].close()
        yield out


def _assert_views_agree(got, want):
    assert want.inference_path.replace("xla", "torch") == got.inference_path
    for name in ("horizon_s", "window_s", "carried_from_generation", "warm_demotion_reason",
                 "data_source"):
        assert getattr(got, name) == getattr(want, name), name
    ref = {(c.node, c.accelerator_id): c for c in want.chips}
    assert ref.keys() == {(c.node, c.accelerator_id) for c in got.chips}
    for c in got.chips:
        r = ref[(c.node, c.accelerator_id)]
        assert c.current == r.current
        assert abs(c.predicted_peak - r.predicted_peak) <= PRED_TOL
        assert abs(c.predicted_mean - r.predicted_mean) <= PRED_TOL

    def decided(view):
        return {
            (c.node, c.accelerator_id): c.saturation_risk
            for c in view.chips
            if abs(c.predicted_peak * 100 - service.SATURATION_PCT) > RISK_MARGIN * 100
        }

    port, jax_ = decided(got), decided(want)
    common = port.keys() & jax_.keys()
    assert {k for k in common if port[k]} == {k for k in common if jax_[k]}


def test_cold_page_markup_matches_jax_outside_the_forecast(served):
    (status, ctype, body), _ = served["port"]["cold"]
    (jstatus, jctype, jbody), _ = served["jax"]["cold"]
    assert (status, ctype) == (jstatus, jctype) == (200, "text/html")
    assert _main_outside_forecast(body) == _main_outside_forecast(jbody)
    assert "inference via PyTorch plain version (CPU)." in body


def test_cold_forecast_matches_jax(served):
    _, got = served["port"]["cold"]
    _, want = served["jax"]["cold"]
    assert (got.inference_path, want.inference_path) == ("torch", "xla")
    _assert_views_agree(got, want)


def test_warm_background_refit_matches_jax(served):
    (status, _, body), got = served["port"]["warm"]
    (jstatus, _, _), want = served["jax"]["warm"]
    # The stale page was served while the refit ran; the refit is warm.
    assert status == jstatus == 200 and "warm-start fit" not in body
    assert (got.inference_path, want.inference_path) == ("torch-warm", "xla-warm")
    assert got.carried_from_generation == want.carried_from_generation == 0
    _assert_views_agree(got, want)


def test_fresh_app_warm_starts_from_process_tier():
    warm_carries.invalidate()
    first = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=clock)
    assert first.handle("/tpu/metrics")[0] == 200 and len(warm_carries) == 1
    second = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=clock)
    assert second.handle("/tpu/metrics")[0] == 200
    view = _view(second)
    assert view.inference_path == "torch-warm" and view.carried_from_generation == 0
    # The carry was taken by the second app's fit and its successor stored.
    assert len(warm_carries) == 1 and warm_carries.counters()["hits"] >= 1
    second.close()


def test_foreground_fit_error_is_a_500_naming_it(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(tf, "_train", broken)
    warm_carries.invalidate()
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=clock)
    status, ctype, body = app.handle("/tpu/metrics")
    assert (status, ctype) == (500, "text/html")
    assert "Internal error: RuntimeError: kernel launch failed" in body
    refresh = json.loads(app.handle("/healthz")[2])["runtime"]["refresh"]["forecast"]
    assert refresh["refit_errors"] == 1


def test_background_refit_error_is_counted_and_named_in_healthz(monkeypatch):
    warm_carries.invalidate()
    mono = [0.0]
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=clock,
                       monotonic=lambda: mono[0])
    assert app.handle("/tpu/metrics")[0] == 200

    def broken(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(tf, "_train", broken)
    mono[0] += app.FORECAST_TTL_S + 1
    # The stale page still serves; the refit's error is absorbed, counted
    # and named.
    status, _, body = app.handle("/tpu/metrics")
    assert status == 200 and "Utilization Forecast" in body
    assert app._forecast_refresher.drain()
    forecast = json.loads(app.handle("/healthz")[2])["runtime"]["refresh"]["forecast"]
    assert forecast["refit_errors"] == 1
    assert forecast["last_refit_error"] == "RuntimeError: kernel launch failed"
    # The carry the failed refit took is back for the next attempt.
    assert len(warm_carries) == 1


@pytest.mark.parametrize("path", ["/intel/nodes", "/intel/metrics", "/intel"])
def test_intel_routes_are_served_as_jax_serves_them(path, monkeypatch):
    # The Intel pages are ported: on a TPU-only fleet they answer JAX's
    # "not detected" pages byte for byte, under their own route label.
    _pin_scrape_timer(monkeypatch)
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=clock)
    japp = JaxApp(jax_demo_transport("v5e4"), clock=clock)
    status, ctype, body = app.handle(path)
    jstatus, jctype, jbody = japp.handle(path)
    assert (status, ctype) == (jstatus, jctype) == (200, "text/html")
    assert body.split("<main>")[1] == jbody.split("<main>")[1]
    assert app._route_label(path) == japp._route_label(path) == path
    # The trend page is registered too: served, with its own route label.
    status, ctype, body = app.handle("/tpu/trends")
    assert (status, ctype) == (200, "text/html") and "History store" in body
    assert app._route_label("/tpu/trends") == "/tpu/trends"
    app.close()


def test_events_answer_an_event_stream_and_a_region_stream(monkeypatch):
    # /events is ported: served over the socket as Server-Sent Events,
    # ?region= narrowed to that drill-down region's frames.
    monkeypatch.setattr(aot, "_REGISTRY", aot.AotProgramRegistry())
    monkeypatch.setattr(slo_mod, "_engine", slo_mod.SLOEngine())
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=clock)
    server = app.serve("127.0.0.1", 0)
    streams = []
    try:
        host, port = server.url[len("http://"):].split(":")
        for path in ("/events", "/events?region=cluster/0/slice/v5e-pool"):
            conn = http.client.HTTPConnection(host, int(port), timeout=30)
            conn.request("GET", path)
            resp = conn.getresponse()
            assert resp.status == 200 and resp.getheader("Content-Type") == "text/event-stream"
            streams.append((conn, resp))
        pages = sorted(sorted(sub.pages) for sub in app.push.hub._subs)
        assert pages == [["/tpu", "/tpu/metrics", "/tpu/nodes", "/tpu/pods"],
                         ["region:cluster/0/slice/v5e-pool"]]
        assert json.loads(app.handle("/healthz")[2])["runtime"]["push"]["connected"] == 2
    finally:
        server.close()
    for conn, resp in streams:
        assert resp.read() == b'event: bye\ndata: {"reason":"shutdown"}\n\n'
        conn.close()


def test_refresh_bumps_the_epoch_and_redirects_only_to_routes():
    app = DashboardApp(make_demo_transport("v5e4"), device="cpu", clock=clock)
    assert app.handle("/refresh?back=/tpu/metrics") == (302, "/tpu/metrics", "")
    for back in ("//evil.example", "http://evil.example/", "/tpu/metrics%0d%0aX:1", "/gpu"):
        assert app.handle(f"/refresh?back={back}") == (302, "/tpu", "")
    assert app.handle("/refresh?back=/tpu/trends") == (302, "/tpu/trends", "")
    # The Intel pages are routes now, as in JAX: /refresh returns to them.
    japp = JaxApp(jax_demo_transport("v5e4"), clock=clock)
    assert app.handle("/refresh?back=/intel") == japp.handle("/refresh?back=/intel") \
        == (302, "/intel", "")
    assert app._cache_epoch == 7


def test_server_entry_point_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server_main(["--demo", "v5e4", "--port", "0"])
    with pytest.raises(RuntimeError):
        DashboardApp(make_demo_transport("v5e4"))

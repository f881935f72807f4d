"""The port's fragment cache against the JAX package's, on the CPU.

``FragmentCache`` and ``FragmentPaint`` answer one scripted sequence (hit,
miss on a salt, epoch or degraded change, invalidation across pages, the
LRU bound, counters and snapshot) exactly as JAX's do. Across a churn
script (a node's Ready flip, an added pod, a removed node, a ``/refresh``
that refits the forecast) a host painting through its fragment cache
answers the same bytes as one with ``fragments=False`` on ``/tpu``,
``/tpu/nodes``, ``/tpu/pods``, ``/tpu/metrics`` and ``/tpu/fleet`` at
every depth; only the two measured durations of the metrics page (the
fit and the scrape, both read off ``perf_counter``) are masked. The
port's warm fragment paints equal the JAX host's warm fragment paints on
the pages the port holds byte-equal to JAX. The metrics page's salts
equal JAX's on the same inputs and change with the dispatch path, and the
history-first forecast hint reads "captured history" as JAX's does.
Everything is exact.
"""

import copy
import importlib
import re

import pytest

from headlamp_tpu.runtime import device_cache as jax_device_cache
from headlamp_tpu.server import DashboardApp as JaxApp
from headlamp_tpu.server import make_demo_transport as jax_demo_transport
from headlamp_tpu.models import service as jservice
from headlamp_tpu.ui import h as jh
from headlamp_tpu.ui import render_html as jrender
from headlamp_tpu_torch.analytics import stats as tstats
from headlamp_tpu_torch.fleet import fixtures as tfx
from headlamp_tpu_torch.metrics.client import fetch_tpu_metrics
from headlamp_tpu_torch.models import service as tservice
from headlamp_tpu_torch.obs.trace import trace_ring
from headlamp_tpu_torch.runtime.device_cache import WarmCarryCache
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport
from headlamp_tpu_torch.server.demo import add_demo_prometheus
from headlamp_tpu_torch.ui import h, render_html

# ``ui.fragment`` and ``pages.metrics_page`` are also the names of
# functions each package's ``ui`` and ``pages`` export, so the modules
# come from the import system.
tfragment = importlib.import_module("headlamp_tpu_torch.ui.fragment")
jfragment = importlib.import_module("headlamp_tpu.ui.fragment")
tpage = importlib.import_module("headlamp_tpu_torch.pages.metrics_page")
jpage = importlib.import_module("headlamp_tpu.pages.metrics_page")

CLOCK = 1785283200.0
PATHS = ("/tpu", "/tpu/nodes", "/tpu/pods", "/tpu/metrics", "/tpu/fleet",
         "/tpu/fleet?region=cluster/c1", "/tpu/fleet?region=cluster/c1/slice/c1-slice-0")
#: The metrics page's two measured durations (the fit's and the scrape's).
_TIMINGS = re.compile(r"(history in|took) [0-9.e+-]+ ms")
_HINT = re.compile(r'<p class="hl-hint">Model fit on .*?</p>')


def clock():
    return CLOCK


def _main(body):
    return re.search(r"<main>(.*)</main>", body, re.S).group(1)


def _span(name):
    stack = list(trace_ring.snapshot()[0]["spans"])
    while stack:
        node = stack.pop(0)
        if node["name"] == name:
            return node
        stack.extend(node["children"])
    return None


def _cache_script(module, h, **stamp):
    """One scripted sequence against a package's cache (``h`` is the
    package's element constructor); its transcript. ``stamp`` is the
    generation JAX's cache takes and never matches on; the port's cache
    takes none."""
    cache = module.FragmentCache(max_entries=3)
    inv = dict(epoch=0, degraded=False, **stamp)
    later = dict(inv, generation=9) if stamp else inv
    out = [cache.get("/tpu", "a", 1, **inv)]
    cache.put("/tpu", "a", 1, "<i>a</i>", **inv)
    cache.put("/tpu/nodes", "a", 1, "<b>a</b>", **inv)
    out += [cache.get("/tpu", "a", 1, **inv), cache.get("/tpu", "a", 2, **inv),
            cache.get("/tpu", "a", 1, **dict(inv, epoch=1)),
            cache.get("/tpu", "a", 1, **dict(inv, degraded=True)),
            cache.get("/tpu/nodes", "a", 1, **later)]
    for key in ("b", "c", "d"):  # past the bound: the least recent goes
        cache.put("/tpu", key, key, f"<p>{key}é</p>", **inv)
    out += [len(cache), cache.get("/tpu", "a", 1, **inv), cache.invalidate(["a", "c", "zz"]),
            len(cache), cache.counters(), cache.snapshot()]
    # A paint: the outer boundary caches its bytes with the inner ones in
    # them; a second paint splices the outer one and never visits inside.
    for _ in range(2):
        tree = h("div", None, module.fragment(
            "outer", ("o",), lambda: h("ul", None, [module.fragment(
                f"row{i}", (i,), lambda i=i: h("li", None, str(i))) for i in range(3)])))
        paint = module.FragmentPaint(cache, page="/p", **inv)
        paint.prerender(tree)
        out += [paint.splice(tree), paint.rendered, paint.spliced]
    out += [cache.clear(), cache.snapshot(), module.DEFAULT_MAX_ENTRIES]
    return out


def test_cache_and_paint_semantics_equal_jax():
    got, want = _cache_script(tfragment, h), _cache_script(jfragment, jh, generation=1)
    assert got == want
    assert got[1:7] == ["<i>a</i>", None, None, None, "<b>a</b>", 3]
    tree = h("div", None, tfragment.fragment("k", 1, lambda: h("p", None, "x")))
    jtree = jh("div", None, jfragment.fragment("k", 1, lambda: jh("p", None, "x")))
    assert render_html(tree) == jrender(jtree) == "<div><p>x</p></div>"


def _viewport_transport(fleet):
    t = tfx.fleet_transport(copy.deepcopy(fleet))
    add_demo_prometheus(t, fleet)
    return t


def _churn(transport, app, step):
    snap = app._last_snapshot.provider("tpu")
    if step == "flip":
        node = copy.deepcopy(snap.nodes[5])
        for cond in node["status"]["conditions"]:
            if cond["type"] == "Ready":
                cond["status"] = "False"
        transport.node_feed.push("MODIFIED", node)
    elif step == "pod":
        node = snap.nodes[9]["metadata"]["name"]
        transport.pod_feed.push("ADDED", tfx.make_tpu_pod("churn", namespace="t", node=node))
    elif step == "remove":
        transport.node_feed.push("DELETED", copy.deepcopy(snap.nodes[12]))
    elif step == "refresh":
        app.handle("/refresh?back=/tpu")


def test_fragment_paints_equal_plain_paints_across_churn():
    tstats.calibration.reset()
    fleet = tfx.fleet_viewport(256, clusters=2)
    mono = [100.0]
    apps = {}
    for name, fragments in (("cached", True), ("plain", False)):
        transport = _viewport_transport(fleet)
        app = DashboardApp(transport, device="cpu", clock=clock, monotonic=lambda: mono[0],
                           min_sync_interval_s=3600.0, fragments=fragments)
        # A carry store each: the process-wide one would hand the second
        # app the first one's carry, and its cold fit would run warm.
        app._warm_forecast_states = WarmCarryCache()
        app._ctx.enable_watch()
        app._background_tick()
        apps[name] = (transport, app)
    rendered = {}
    try:
        for step in (None, None, "flip", "pod", "remove", "refresh"):
            bodies = {}
            for name, (transport, app) in apps.items():
                if step is not None:
                    _churn(transport, app, step)
                    app._background_tick()
                bodies[name] = {}
                for path in PATHS:
                    status, _, body = app.handle(path)
                    assert status == 200, (name, path)
                    bodies[name][path] = _TIMINGS.sub(r"\1 # ms", body)
                    if name == "cached" and path == "/tpu/nodes":
                        splice = _span("fragment.splice")["attrs"]
                        rendered[step] = (splice["rendered"], splice["spliced"])
            assert bodies["cached"] == bodies["plain"], step
        cached = apps["cached"][1]
        assert apps["plain"][1].fragments is None and _span("fragment.splice") is None
        # The warm repaint re-renders nothing; a flip re-renders its row
        # (and the card the not-ready-first cap now shows), not the table.
        assert rendered[None][0] == 0 and rendered[None][1] > 100
        assert 1 <= rendered["flip"][0] <= 2
        health = cached.handle("/healthz")[2]
        assert '"render": {"entries"' in health
        assert cached.push.counters()["fragment_invalidations"] >= 3
        assert cached.fragments.snapshot()["hit_rate"] > 0.5
    finally:
        for _, app in apps.values():
            app.close()
        tstats.calibration.reset()


@pytest.mark.parametrize("fleet", ["v5p32", "large"])
def test_warm_fragment_paints_equal_the_jax_hosts(fleet):
    tstats.calibration.reset()
    port = DashboardApp(make_demo_transport(fleet), device="cpu", clock=clock,
                        min_sync_interval_s=0.0)
    jax = JaxApp(jax_demo_transport(fleet), clock=clock, min_sync_interval_s=0.0)
    paths = ("/tpu", "/tpu/nodes", "/tpu/pods", "/tpu/deviceplugins", "/tpu/topology",
             "/tpu/fleet", "/tpu/fleet?region=cluster/0")
    try:
        for round_ in range(2):  # the second round splices cached bytes
            jax_device_cache.fleet_cache.invalidate()
            jax_device_cache.rollup_results.invalidate()
            for path in paths:
                got, want = port.handle(path), jax.handle(path)
                assert got[0] == want[0] == 200, path
                assert _main(got[2]) == _main(want[2]), (round_, path)
        assert port.fragments.snapshot()["hits"] > 0
    finally:
        port.close()
        tstats.calibration.reset()


def _views():
    """One live-window view and one history-first view per package."""
    out = []
    for source, path in (("live-window", "cuda"), ("history", "cuda-warm")):
        pair = []
        for service in (tservice, jservice):
            chips = [service.ChipForecast("n-0", str(i), 0.2 * i, 0.3 * i + 0.05, 0.25 * i,
                                          0.3 * i + 0.05 >= 0.9) for i in range(4)]
            pair.append(service.ForecastView(
                horizon_s=900, window_s=3600, chips=chips, fit_ms=12.5, fit_mse=1.25e-3,
                inference_path=path, data_source=source))
        out.append(pair)
    return out


def test_the_forecast_hint_names_captured_history_as_jax_does():
    for port_view, jax_view in _views():
        got = _HINT.findall(render_html(tpage.forecast_section(port_view)))
        want = _HINT.findall(jrender(jpage.forecast_section(jax_view)))
        assert len(got) == len(want) == 1
        # The inference label names each package's own dispatch path.
        assert got[0].split("; inference via")[0] == want[0].split("; inference via")[0]
        if port_view.data_source == "history":
            assert "of captured history in 12.5 ms" in got[0] and "history history" not in got[0]


def test_metrics_page_salts_equal_jax_and_follow_the_dispatch_path():
    metrics = fetch_tpu_metrics(make_demo_transport("v5e4"), clock=clock)
    port_view, _ = _views()[0]
    assert tpage._forecast_salt(port_view) == jpage._forecast_salt(port_view)
    assert tpage._availability_salt(metrics) == jpage._availability_salt(metrics)
    assert tpage._availability_salt(None) is jpage._availability_salt(None) is None
    for chip in metrics.chips:
        assert tpage._chip_salt(chip) == jpage._chip_salt(chip)
    cache = tfragment.FragmentCache()
    inv = dict(epoch=0, degraded=False)
    painted = []
    for path in ("cuda", "cuda-warm", "repeat", "repeat", "cuda"):
        port_view.inference_path = path
        tree = tpage.metrics_page(metrics, port_view)
        paint = tfragment.FragmentPaint(cache, page="/tpu/metrics", **inv)
        paint.prerender(tree)
        painted.append((paint.splice(tree) == render_html(tree), paint.rendered))
    # The first paint renders every boundary (the availability matrix, the
    # forecast, one card per chip); each change of dispatch path
    # re-renders the forecast section alone, and a repeat hits.
    first = 2 + len(metrics.chips)
    assert painted == [(True, first), (True, 1), (True, 1), (True, 0), (True, 1)]

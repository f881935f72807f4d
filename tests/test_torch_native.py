"""The port's drill-down page and native views against the JAX host's,
on the CPU.

``<main>`` of ``/tpu/fleet`` at the fleet root, a cluster, a slice, the
slice's next cursor window and two unknown regions, from the port's
``DashboardApp(device="cpu")`` at ``fleet_viewport(1024)``, is
byte-identical to the JAX ``DashboardApp``'s (with and without its
fragment cache), both apps syncing on every request so the generations
their cursors carry advance together. So are ``/node/<name>`` (a TPU
node, a plain node, an unknown node — 404 on both hosts) and
``/pod/<namespace>/<name>`` at ``fleet_large(1024)`` and ``fleet_v5p32``.
The port's ``native_nodes_page`` with its own registry (the TPU and the
Intel columns) is held to JAX ``native_nodes_page`` with JAX's full
registry. Then the route labels, the ``/refresh`` allowlist and the
``cluster-nodes`` CLI page.
"""

import re
from urllib.parse import quote

import pytest

from headlamp_tpu import cli as jax_cli
from headlamp_tpu import registration as jax_reg
from headlamp_tpu.context import AcceleratorDataContext as JaxContext
from headlamp_tpu.fleet import fixtures as jfx
from headlamp_tpu.obs import metrics as jax_metrics
from headlamp_tpu.pages import native as jax_native
from headlamp_tpu.runtime import device_cache as jax_device_cache
from headlamp_tpu.runtime.transfer import TransferBatch
from headlamp_tpu.server import DashboardApp as JaxApp
from headlamp_tpu.server import app as jax_app_mod
from headlamp_tpu.server import make_demo_transport as jax_demo_transport
from headlamp_tpu.ui import render_html as jax_render_html
from headlamp_tpu.ui import render_text as jax_render_text
from headlamp_tpu_torch.cli import render_page
from headlamp_tpu_torch.context import AcceleratorDataContext
from headlamp_tpu_torch.fleet import fixtures as tfx
from headlamp_tpu_torch.pages.native import native_nodes_page
from headlamp_tpu_torch.registration import register_plugin
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport
from headlamp_tpu_torch.ui import render_html

CLOCK = 1785283200.0
SLICE = "cluster/3/slice/c3-slice-1"
FLEET_PATHS = (
    "/tpu/fleet",
    "/tpu/fleet?region=cluster/3",
    f"/tpu/fleet?region={SLICE}&limit=10",
    f"/tpu/fleet?region={SLICE}&limit=10&cursor={{cursor}}",
    f"/tpu/fleet?region={SLICE}",
    "/tpu/fleet?region=cluster/99",
    "/tpu/fleet?region=not-a-path",
)
_CURSOR = re.compile(r'cursor=([A-Za-z0-9_-]+)" class="hl-res-link hl-cursor-next"')


def clock():
    return CLOCK


def _main(body):
    return re.search(r"<main>(.*)</main>", body, re.S).group(1)


def _paint(app, paths, handle=None):
    """Status and <main> of every path, in order; the cursor of the first
    slice window continues the second."""
    handle = handle or app.handle
    out, cursor = {}, ""
    for path in paths:
        status, _, body = handle(path.format(cursor=quote(cursor)))
        out[path] = (status, _main(body))
        if (found := _CURSOR.search(body)) and not cursor:
            cursor = found.group(1)
    return out


def _jax_handle(app, path):
    """``app.handle(path)`` of a JAX host, but a detail view (a node or a
    pod) goes through JAX's dispatch without the request wrapper: the
    wrapper would record its route template, ``/node/{name}``, as a label
    in JAX's process-wide metrics registry, where other test files'
    exposition parsers read it."""
    if "{" not in app._route_label(path):
        return app.handle(path)
    with TransferBatch().scope():
        return app._handle(path)


def _jax_apps(make_transport):
    return {
        "fragments": JaxApp(make_transport(), clock=clock, min_sync_interval_s=0.0),
        "plain": JaxApp(make_transport(), clock=clock, min_sync_interval_s=0.0, fragments=False),
    }


def _paint_jax(apps, paths):
    out = {}
    for name, app in apps.items():
        # The JAX package's process-wide fleet cache is keyed by
        # (provider, snapshot version): clear it before each app.
        jax_device_cache.fleet_cache.invalidate()
        jax_device_cache.rollup_results.invalidate()
        out[name] = _paint(app, paths, lambda path, app=app: _jax_handle(app, path))
    return out


@pytest.fixture(scope="module")
def fleet_painted():
    port = DashboardApp(tfx.fleet_transport(tfx.fleet_viewport(1024)), device="cpu",
                        clock=clock, min_sync_interval_s=0.0)
    try:
        out = _paint_jax(_jax_apps(lambda: jfx.fleet_transport(jfx.fleet_viewport(1024))),
                         FLEET_PATHS)
        out["port"] = _paint(port, FLEET_PATHS)
    finally:
        port.close()
    return out


@pytest.mark.parametrize("jax_app", ["fragments", "plain"])
def test_fleet_page_main_bytes_match_jax(fleet_painted, jax_app):
    for path in FLEET_PATHS:
        assert fleet_painted["port"][path] == fleet_painted[jax_app][path], path
    port = fleet_painted["port"]
    assert all(status == 200 for status, _ in port.values())
    assert "<dt>Rollup source</dt><dd>device</dd>" in port["/tpu/fleet"][1]
    assert "Cluster 3" in port["/tpu/fleet?region=cluster/3"][1]
    assert "rows 11–20 of 32 nodes" in port[FLEET_PATHS[3]][1]
    for path in FLEET_PATHS[-2:]:
        assert "No such region" in port[path][1]


def _detail_paths(fleet):
    nodes, pods = fleet["nodes"], fleet["pods"]
    tpu_node = next(n for n in nodes if "cloud.google.com/gke-tpu-accelerator"
                    in n["metadata"]["labels"])
    plain = next(n for n in nodes if not n["metadata"]["labels"])
    tpu_pod = next(p for p in pods if p["spec"]["nodeName"]
                   and "google.com/tpu" in str(p["spec"]["containers"]))
    return (
        f"/node/{tpu_node['metadata']['name']}",
        f"/node/{plain['metadata']['name']}",
        "/node/no-such-node",
        f"/pod/{tpu_pod['metadata']['namespace']}/{tpu_pod['metadata']['name']}",
        "/pod/default/no-such-pod",
    )


@pytest.mark.parametrize("demo", ["v5p32", "large"])
def test_native_detail_main_bytes_match_jax(demo):
    from headlamp_tpu_torch.server.demo import DEMO_FLEETS

    paths = _detail_paths(DEMO_FLEETS[demo]())
    port = DashboardApp(make_demo_transport(demo), device="cpu", clock=clock,
                        min_sync_interval_s=0.0)
    try:
        got = _paint(port, paths)
        want = _paint_jax(_jax_apps(lambda: jax_demo_transport(demo)), paths)
    finally:
        port.close()
    for jax_app in ("fragments", "plain"):
        assert got == want[jax_app]
    assert [status for status, _ in got.values()] == [200, 200, 404, 200, 404]
    tpu_node, plain_node, _, tpu_pod, _ = (got[p][1] for p in paths)
    assert "hl-node-detail" in tpu_node and '<h2 class="hl-section-title">TPU</h2>' in tpu_node
    assert "hl-node-detail" not in plain_node
    assert "hl-pod-detail" in tpu_pod


def _braced_label_values(registry):
    text = registry.render() + registry.render(openmetrics=True)
    return {v for v in re.findall(r'="((?:[^"\\]|\\.)*)"', text) if "{" in v or "}" in v}


def test_jax_detail_paints_leave_no_braced_route_label(monkeypatch):
    # The JAX apps record into a metrics registry of this test's own, so
    # the wrapped dispatch below labels nothing of the process's.
    process = _braced_label_values(jax_metrics.registry)
    own = jax_metrics.MetricRegistry()
    monkeypatch.setattr(jax_app_mod, "metrics_registry", own)
    apps = _jax_apps(lambda: jax_demo_transport("v5p32"))
    paths = _detail_paths(tfx.fleet_v5p32())
    painted = _paint_jax(apps, paths)
    assert [status for status, _ in painted["plain"].values()] == [200, 200, 404, 200, 404]
    assert _braced_label_values(own) == set()
    assert _braced_label_values(jax_metrics.registry) == process
    # JAX's request wrapper labels a detail path with its route template.
    assert apps["plain"].handle(paths[0])[0] == 200
    assert _braced_label_values(own) == {"/node/{name}"}
    assert _braced_label_values(jax_metrics.registry) == process


@pytest.fixture(scope="module")
def snapshots():
    jsnap = JaxContext(jfx.fleet_transport(jfx.fleet_large(1024)), clock=clock).sync()
    with AcceleratorDataContext(tfx.fleet_transport(tfx.fleet_large(1024)), device="cpu",
                                clock=clock) as tctx:
        tsnap = tctx.sync()
    return jsnap, tsnap


@pytest.mark.parametrize("paging", [{}, {"page": 2}, {"query": "v5p-pool"}])
def test_native_nodes_page_matches_jax_with_the_tpu_columns(snapshots, paging):
    jsnap, tsnap = snapshots
    jax_registry = jax_reg.register_plugin()
    want = jax_render_html(jax_native.native_nodes_page(
        jsnap, now=CLOCK, registry=jax_registry, **paging))
    got = render_html(native_nodes_page(tsnap, now=CLOCK, registry=register_plugin(), **paging))
    assert got == want
    assert "<th>TPU Type</th><th>TPU Chips</th><th>TPU Topology</th>" in got
    assert "<th>GPU Type</th><th>GPU Devices</th>" in got
    if paging:
        assert ("page 2 of" if "page" in paging else "matching “v5p-pool”") in got


def test_route_labels_refresh_allowlist_and_cli_match_jax():
    port = DashboardApp(make_demo_transport("large"), device="cpu", clock=clock)
    jax = JaxApp(jax_demo_transport("large"), clock=clock)
    try:
        for path in ("/node/gke-cpu-pool-n3", "/pod/team-1/workload-1", "/tpu/fleet?region=x",
                     "/nodes?page=2", "/node/Bad_Name", "/pod/only-namespace"):
            assert port._route_label(path) == jax._route_label(path), path
        assert port._route_label("/node/a") == "/node/{name}"
        assert port._route_label("/pod/ns/a") == "/pod/{namespace}/{name}"
        for back in ("/node/gke-cpu-pool-n3", "/pod/team-1/workload-1", "/tpu/fleet", "/nodes"):
            assert port.handle(f"/refresh?back={back}") == jax.handle(f"/refresh?back={back}") \
                == (302, back, "")
        for back in ("/node/Bad_Name", "/node//evil", "/pod/a/b/c", "//evil.example"):
            assert port.handle(f"/refresh?back={back}")[:2] == (302, "/tpu")
    finally:
        port.close()

    text = render_page("cluster-nodes", make_demo_transport("large"), clock=clock, device="cpu")
    jsnap = JaxContext(jax_demo_transport("large"), clock=clock).sync()
    assert text == jax_render_text(
        jax_native.native_nodes_page(jsnap, now=CLOCK, registry=jax_reg.register_plugin()))
    assert text == jax_cli.render_page("cluster-nodes", jax_demo_transport("large"), clock=clock)
    assert "cluster-nodes" in jax_cli.PAGES and "TPU Topology" in text

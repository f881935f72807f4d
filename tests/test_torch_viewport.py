"""The port's viewport tree and region rollup against the JAX package's,
on the CPU.

The region rollup of torch ops equals JAX ``region_rollup`` exactly on
the same encoded columns and region ids (every value is an integer
count), including a 70-cluster fleet whose clusters 63-69 alias into the
last segment. ``viewport_tree`` equals JAX's (clusters, slice stats,
total, members, region_of, source) on the drill-down fleets and on a
fleet below the device floor, and its device sums equal ``_host_sums``,
the oracle. The region-scoped windows cut the same rows and cursors as
JAX's. A device rollup that raises propagates out of the tree and makes
``/tpu/fleet`` a 500 naming it.
"""

import numpy as np
import pytest

from headlamp_tpu.analytics import encode as jax_encode
from headlamp_tpu.analytics import fleet_jax
from headlamp_tpu.context import AcceleratorDataContext as JaxContext
from headlamp_tpu.domain import accelerator as jacc
from headlamp_tpu.fleet import fixtures as jfx
from headlamp_tpu.runtime import device_cache as jax_device_cache
from headlamp_tpu.viewport import tree as jax_tree
from headlamp_tpu.viewport import window as jax_window
from headlamp_tpu_torch.analytics import encode as tencode
from headlamp_tpu_torch.analytics import fleet_torch
from headlamp_tpu_torch.context import AcceleratorDataContext
from headlamp_tpu_torch.domain import accelerator as tacc
from headlamp_tpu_torch.fleet import fixtures as tfx
from headlamp_tpu_torch.models import aot
from headlamp_tpu_torch.obs.trace import trace_ring
from headlamp_tpu_torch.server import DashboardApp
from headlamp_tpu_torch.viewport import tree as ttree
from headlamp_tpu_torch.viewport import window as twindow

CLOCK = 1785283200.0
FLEETS = {
    "viewport256x4": (lambda m: m.fleet_viewport(256, clusters=4)),
    "viewport1024": (lambda m: m.fleet_viewport(1024)),
    "viewport4096x70": (lambda m: m.fleet_viewport(4096, clusters=70)),
    "v5p32": (lambda m: m.fleet_v5p32()),
}


def _states(fleet):
    """The TPU provider state of one synced snapshot of ``fleet``, from
    the JAX context and from the port's on the CPU."""
    make = FLEETS[fleet]
    jctx = JaxContext(
        jfx.fleet_transport(make(jfx)), providers=(jacc.TPU_PROVIDER,), clock=lambda: CLOCK
    )
    with AcceleratorDataContext(
        tfx.fleet_transport(make(tfx)), device="cpu", clock=lambda: CLOCK
    ) as tctx:
        return jctx.sync().provider("tpu"), tctx.sync().provider("tpu")


def _jax_tree(state):
    # The JAX package keeps one process-wide fleet cache keyed by
    # (provider, snapshot version): clear it, or an earlier fleet at the
    # same version would be rolled up.
    jax_device_cache.fleet_cache.invalidate()
    return jax_tree.viewport_tree(state)


def _describe(tree):
    def region(r):
        return (r.path, r.key, r.level, r.stats, tuple(region(c) for c in r.children))

    return {
        "generation": tree.generation,
        "total": tree.total,
        "clusters": [region(c) for c in tree.clusters],
        "region_of": dict(tree.region_of),
        "members": dict(tree.members),
        "source": tree.source,
    }


@pytest.mark.parametrize("fleet", ["viewport256x4", "viewport1024", "viewport4096x70"])
def test_region_rollup_matches_jax(fleet):
    make = FLEETS[fleet]
    jfleet, tfleet = make(jfx), make(tfx)
    jview = jacc.classify_fleet(jfleet["nodes"], jfleet["pods"])["tpu"]
    tview = tacc.classify_fleet(tfleet["nodes"], tfleet["pods"])["tpu"]
    jcols = jax_encode.encode_fleet(jview.nodes, jview.pods)
    tcols = tencode.encode_fleet(tview.nodes, tview.pods)
    region_of, _, _, cluster_id, slice_id = ttree._assignments(tview.nodes)
    limit = fleet_torch.REGION_CLUSTER_SEGMENTS
    pad = tcols.n_nodes_padded
    node_cluster = np.zeros(pad, np.int32)
    node_slice = np.zeros(pad, np.int32)
    for i, name in enumerate(tcols.node_names):
        ck, sk = region_of[name]
        # Unclamped ids: the device's clamp alone aliases past segment 63.
        node_cluster[i] = cluster_id[ck]
        node_slice[i] = slice_id[(ck, sk)]
    if fleet == "viewport4096x70":
        assert node_cluster.max() == 69 and len(cluster_id) == 70

    want = fleet_jax.region_rollup(
        jcols.node_capacity, jcols.node_allocatable, jcols.node_ready, jcols.node_valid,
        node_cluster, node_slice, jcols.pod_request, jcols.pod_phase, jcols.pod_node_idx,
        jcols.pod_valid,
    )
    out = fleet_torch.region_rollup_arrays(tcols, node_cluster, node_slice, "cpu")
    got = fleet_torch.unpack_region_rollup(fleet_torch.pack_region_rollup(out))
    assert set(got) == set(want) == set(fleet_torch.REGION_KEYS)
    for key in fleet_torch.REGION_KEYS:
        assert got[key].dtype == np.int64
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
        np.testing.assert_array_equal(out[key].numpy(), got[key], err_msg=key)
    assert got["cluster_nodes"].sum() == len(tview.nodes)
    if fleet == "viewport4096x70":
        # Clusters 63-69 all land in the last segment.
        assert got["cluster_nodes"][limit - 1] > got["cluster_nodes"][limit - 2]


@pytest.mark.parametrize("fleet", list(FLEETS))
def test_viewport_tree_matches_jax_and_the_oracle(fleet):
    jstate, tstate = _states(fleet)
    want = _describe(_jax_tree(jstate))
    tree = ttree.viewport_tree(tstate)
    assert _describe(tree) == want
    assert tree.source == ("host" if fleet == "v5p32" else "device")
    assert ttree.viewport_tree(tstate) is tree  # memoized on the view
    if tree.source == "device":
        _, _, _, cluster_id, slice_id = ttree._assignments(tstate.nodes)
        args = (cluster_id, slice_id, dict(tree.region_of), fleet_torch.REGION_CLUSTER_SEGMENTS)
        assert ttree._device_sums(tstate, *args) == ttree._host_sums(tstate, *args)
        assert tstate.fleet_cache.counters()["uploads"] == 1


def test_region_windows_match_jax():
    jstate, tstate = _states("viewport1024")
    _jax_tree(jstate)
    slice_path = "cluster/2/slice/c2-slice-1"
    for region, limit in ((slice_path, 10), ("cluster/5", 50), (None, 64)):
        cursor_j = cursor_t = None
        for _ in range(3):  # three windows, each continuing the last
            jw = jax_window.window_nodes(jstate, limit=limit, cursor=cursor_j, region=region)
            tw = twindow.window_nodes(tstate, limit=limit, cursor=cursor_t, region=region)
            assert [n["metadata"]["name"] for n in tw.rows] == [
                n["metadata"]["name"] for n in jw.rows
            ]
            assert (tw.total, tw.start, tw.next_cursor) == (jw.total, jw.start, jw.next_cursor)
            cursor_j, cursor_t = jw.next_cursor, tw.next_cursor
    assert twindow.window_nodes(tstate, region=slice_path).total == 32
    for region in ("cluster/5", slice_path, "cluster/none"):
        jw = jax_window.window_pods(jstate, limit=20, region=region)
        tw = twindow.window_pods(tstate, limit=20, region=region)
        assert [p["metadata"]["name"] for p in tw.rows] == [p["metadata"]["name"] for p in jw.rows]
        assert (tw.total, tw.next_cursor) == (jw.total, jw.next_cursor)


def test_tree_build_is_traced_with_its_source():
    app = DashboardApp(
        tfx.fleet_transport(tfx.fleet_viewport(1024)), device="cpu", clock=lambda: CLOCK,
        min_sync_interval_s=3600.0,
    )
    try:
        assert app.handle("/tpu/fleet")[0] == 200
        found = []
        stack = list(trace_ring.snapshot()[0]["spans"])
        while stack:
            node = stack.pop(0)
            found += [node["attrs"]] if node["name"] == "analytics.region_rollup" else []
            stack.extend(node["children"])
        assert found == [{"nodes": 1024, "clusters": 8, "slices": 32, "source": "device",
                          "fleet_cache": "miss"}]
        # Later drill-downs of the generation read the memo: no new rollup.
        assert app.handle("/tpu/fleet?region=cluster/1")[0] == 200
        assert app._ctx.fleet_cache.counters() == {"hits": 0, "misses": 1, "uploads": 1}
    finally:
        app.close()


def test_device_rollup_error_propagates_to_a_500(monkeypatch):
    def broken(fleet, node_cluster, node_slice, device=None):
        raise RuntimeError("region rollup failed")

    monkeypatch.setattr(fleet_torch, "region_rollup_arrays", broken)
    # A registry that never started: every rollup runs region_rollup_arrays.
    # The process registry, once an earlier test started it, would find its
    # captured program (which calls region_rollup) and never reach it.
    monkeypatch.setattr(aot, "_REGISTRY", aot.AotProgramRegistry())
    _, tstate = _states("viewport256x4")
    with pytest.raises(RuntimeError, match="region rollup failed"):
        ttree.viewport_tree(tstate)
    app = DashboardApp(
        tfx.fleet_transport(tfx.fleet_viewport(256, clusters=4)), device="cpu",
        clock=lambda: CLOCK, min_sync_interval_s=3600.0,
    )
    try:
        for path in ("/tpu/fleet", "/tpu/fleet?region=cluster/1"):  # never a host-computed page
            status, ctype, body = app.handle(path)
            assert (status, ctype) == (500, "text/html")
            assert "Internal error: RuntimeError: region rollup failed" in body
        assert app.handle("/tpu/nodes")[0] == 200  # pages without the tree serve
    finally:
        app.close()

"""The port's cluster snapshot context against the JAX package's.

Both contexts sync against their own package's fixture transport for the
same fleet, each with both providers (TPU and Intel GPU) and watch off,
the default: they must send the same requests, pagination included, and
build the same snapshot for each provider. A node list answering 500 and
a transport without the device-plugin DaemonSet route degrade the same
way in both. The TPU view ``classify_fleet`` builds does not depend on
the Intel provider, in either package.
"""

import pytest

from headlamp_tpu.context import AcceleratorDataContext as JaxContext
from headlamp_tpu.domain import accelerator as jacc
from headlamp_tpu.fleet import fixtures as jfx
from headlamp_tpu.transport.api_proxy import ApiError as JaxApiError
from headlamp_tpu_torch.context import (
    INTEL_SOURCE,
    NODES_PATH,
    TPU_SOURCE,
    AcceleratorDataContext,
)
from headlamp_tpu_torch.domain import accelerator as tacc
from headlamp_tpu_torch.domain import objects as obj
from headlamp_tpu_torch.fleet import fixtures as tfx
from headlamp_tpu_torch.transport.api_proxy import ApiError

CLOCK = 1785283200.0
FLEETS = {
    "v5e4": (jfx.fleet_v5e4, tfx.fleet_v5e4),
    "v5p32": (jfx.fleet_v5p32, tfx.fleet_v5p32),
    "large": (lambda: jfx.fleet_large(1024), lambda: tfx.fleet_large(1024)),
    "mixed": (jfx.fleet_mixed, tfx.fleet_mixed),
}
DAEMONSETS = "/apis/apps/v1/daemonsets?labelSelector=k8s-app%3Dtpu-device-plugin"


def _contexts(fleet, *, jax_edit=lambda t: None, port_edit=lambda t: None):
    jmake, tmake = FLEETS[fleet]
    jt, tt = jfx.fleet_transport(jmake()), tfx.fleet_transport(tmake())
    jax_edit(jt)
    port_edit(tt)
    jctx = JaxContext(jt, clock=lambda: CLOCK)
    tctx = AcceleratorDataContext(tt, device="cpu", clock=lambda: CLOCK)
    return (jctx, jt), (tctx, tt)


def _names(objs):
    return [(obj.namespace(o), obj.name(o)) for o in objs]


def _describe(snap):
    """Everything a page reads from the snapshot's provider states."""
    out = {
        "loading": snap.loading,
        "errors": snap.errors,
        "fetched_at": snap.fetched_at,
        "refresh_count": snap.refresh_count,
        "all_nodes": None if snap.all_nodes is None else len(snap.all_nodes),
        "all_pods": None if snap.all_pods is None else len(snap.all_pods),
        "providers": list(snap.providers),
    }
    for name in snap.providers:
        state = snap.provider(name)
        out[name] = {
            "nodes": _names(state.nodes),
            "pods": _names(state.pods),
            "plugin_pods": _names(state.plugin_pods),
            "workloads": _names(state.workloads),
            "workload_available": state.workload_available,
            "plugin_pods_error": state.plugin_pods_error,
            "plugin_installed": state.plugin_installed,
            "version": state.view.version,
            "allocation": dict(state.allocation_summary()),
        }
    return out


def _provider_of(path):
    for source in (TPU_SOURCE, INTEL_SOURCE):
        if path in source.workload_paths + source.plugin_pod_paths:
            return source.provider_name
    return None


def _assert_same_requests(jcalls, tcalls):
    # Both contexts list nodes and pods on two threads and run the two
    # providers' chains concurrently, so only the order within each list
    # and within each provider's chain is fixed.
    assert sorted(tcalls) == sorted(jcalls)
    for prefix in ("/api/v1/nodes?limit", "/api/v1/pods?limit"):
        assert [c for c in tcalls if c.startswith(prefix)] == [
            c for c in jcalls if c.startswith(prefix)
        ]
    for provider in ("tpu", "intel"):
        assert [c for c in tcalls if _provider_of(c) == provider] == [
            c for c in jcalls if _provider_of(c) == provider
        ]
    assert all(
        c.startswith(("/api/v1/nodes?limit", "/api/v1/pods?limit")) or _provider_of(c)
        for c in tcalls
    )


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_same_requests_and_snapshot(fleet):
    (jctx, jt), (tctx, tt) = _contexts(fleet)
    jsnap, tsnap = jctx.sync(), tctx.sync()
    _assert_same_requests(jt.calls, tt.calls)
    assert _describe(tsnap) == _describe(jsnap)
    if fleet == "large":
        # 1024 nodes and 1400-odd pods: the continue chain ran.
        assert any("continue=" in c for c in tt.calls)
    # A refresh re-runs the imperative track only, in both.
    jt.calls.clear()
    tt.calls.clear()
    jref, tref = jctx.refresh(), tctx.refresh()
    _assert_same_requests(jt.calls, tt.calls)
    assert _describe(tref) == _describe(jref)
    jctx.close()


def test_node_list_500_degrades_the_same():
    (jctx, jt), (tctx, tt) = _contexts(
        "v5p32",
        jax_edit=lambda t: t._list_routes.__setitem__(
            NODES_PATH, JaxApiError(NODES_PATH, "HTTP 500", status=500)
        ),
        port_edit=lambda t: t._list_routes.__setitem__(
            NODES_PATH, ApiError(NODES_PATH, "HTTP 500", status=500)
        ),
    )
    jsnap, tsnap = jctx.sync(), tctx.sync()
    assert tsnap.loading and tsnap.error == jsnap.error
    assert "nodes:" in tsnap.error and "HTTP 500" in tsnap.error
    assert _describe(tsnap) == _describe(jsnap)
    _assert_same_requests(jt.calls, tt.calls)
    jctx.close()


def test_missing_daemonset_route_degrades_the_same():
    (jctx, jt), (tctx, tt) = _contexts(
        "v5p32",
        jax_edit=lambda t: t.routes.pop(DAEMONSETS),
        port_edit=lambda t: t.routes.pop(DAEMONSETS),
    )
    jsnap, tsnap = jctx.sync(), tctx.sync()
    state = tsnap.provider("tpu")
    assert state.workloads == [] and not state.workload_available
    assert state.plugin_installed  # daemon pods and chips still show it
    assert _describe(tsnap) == _describe(jsnap)
    _assert_same_requests(jt.calls, tt.calls)
    jctx.close()


def test_tpu_view_does_not_depend_on_the_intel_provider():
    fleet = jfx.fleet_mixed()
    with_intel = jacc.classify_fleet(fleet["nodes"], fleet["pods"])["tpu"]
    tpu_only = jacc.classify_fleet(fleet["nodes"], fleet["pods"], (jacc.TPU_PROVIDER,))["tpu"]
    port_views = tacc.classify_fleet(fleet["nodes"], fleet["pods"])
    port_tpu_only = tacc.classify_fleet(fleet["nodes"], fleet["pods"], (tacc.TPU_PROVIDER,))
    assert [p.name for p in tacc.PROVIDERS] == [p.name for p in jacc.PROVIDERS] == ["tpu", "intel"]
    for view in (tpu_only, port_views["tpu"], port_tpu_only["tpu"]):
        for attr in ("nodes", "pods", "plugin_pods"):
            assert _names(getattr(view, attr)) == _names(getattr(with_intel, attr))
        assert dict(view.allocation_summary()) == dict(with_intel.allocation_summary())
        assert view.plugin_installed == with_intel.plugin_installed
    assert with_intel.nodes and with_intel.pods
    # And the Intel view is JAX's.
    jintel = jacc.classify_fleet(fleet["nodes"], fleet["pods"])["intel"]
    for attr in ("nodes", "pods", "plugin_pods"):
        assert _names(getattr(port_views["intel"], attr)) == _names(getattr(jintel, attr))
    assert dict(port_views["intel"].allocation_summary()) == dict(jintel.allocation_summary())
    assert port_views["intel"].nodes and port_views["intel"].pods


def test_clean_sync_keeps_the_snapshot_and_version():
    # Without watch every sync that lists stamps a new version, in both
    # packages; once both lists fail and stay failed, a sync is clean and
    # keeps the snapshot (with its stats) and its version.
    def run(ctx, transport):
        seen, last = [], None
        for step in range(4):
            if step == 2:
                transport._list_routes.clear()
            state = ctx.sync().provider("tpu")
            seen.append((state.view.version, state is last))
            last = state
        return seen

    (jctx, jt), (tctx, tt) = _contexts("v5e4")
    got, want = run(tctx, tt), run(jctx, jt)
    assert got == want == [(1, False), (2, False), (3, False), (3, True)]
    jctx.close()

"""The port's Intel GPU provider against the JAX package's, on the CPU.

Every function of ``domain/intel.py`` gives JAX's answer on the fixture
objects and on objects made from a seed; ``classify_fleet`` with both
providers builds JAX's views at ``fleet_mixed``, ``fleet_v5p32`` and
``fleet_large(1024)``; a hypothesis property over generated node and pod
dicts (labels, ``gpu.intel.com/i915`` and ``/xe`` capacities and requests,
malformed items) holds that both packages agree and neither raises. The
Intel fixtures are JAX's byte for byte, ``INTEL_SOURCE`` is JAX's, and
``fleet_stats`` on an Intel view is the Python pass (``generation_counts``
empty) while asking for the device backend raises ``ValueError``, as in
JAX. Everything is exact.
"""

import json
import random

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from headlamp_tpu.analytics import stats as jstats
from headlamp_tpu.context import sources as jsources
from headlamp_tpu.domain import accelerator as jacc
from headlamp_tpu.domain import intel as jintel
from headlamp_tpu.fleet import fixtures as jfx
from headlamp_tpu_torch.analytics import stats as tstats
from headlamp_tpu_torch.context import INTEL_SOURCE, default_sources
from headlamp_tpu_torch.context import sources as tsources
from headlamp_tpu_torch.domain import accelerator as tacc
from headlamp_tpu_torch.domain import intel as tintel
from headlamp_tpu_torch.domain import objects as obj
from headlamp_tpu_torch.fleet import fixtures as tfx
from headlamp_tpu_torch.obs.trace import trace_request

NODE_FUNCTIONS = ("is_intel_gpu_node", "get_node_gpu_count", "get_node_gpu_allocatable",
                  "get_node_gpu_type")
POD_FUNCTIONS = ("is_gpu_requesting_pod", "get_pod_gpu_requests", "get_pod_device_request",
                 "is_intel_plugin_pod")
LIST_FUNCTIONS = ("filter_intel_gpu_nodes", "filter_gpu_requesting_pods",
                  "filter_intel_plugin_pods")
CONSTANTS = ("INTEL_GPU_RESOURCE_PREFIX", "INTEL_GPU_I915_RESOURCE", "INTEL_GPU_XE_RESOURCE",
             "INTEL_GPU_NODE_LABEL", "INTEL_DISCRETE_GPU_ROLE", "INTEL_INTEGRATED_GPU_ROLE",
             "INTEL_PLUGIN_POD_LABELS")
RESOURCES = ("gpu.intel.com/i915", "gpu.intel.com/xe", "gpu.intel.com/millicores",
             "gpu.intel.com/memory.max", "gpu.intel.com/tiles", "google.com/tpu", "cpu")


def _seeded_objects(seed=0, n=64):
    """Intel nodes, pods, plugin pods and CRs with seeded counts, plus
    the TPU and plain objects the provider must leave alone."""
    rng = random.Random(seed)
    nodes, pods, crds = [], [], []
    for i in range(n):
        nodes.append(jfx.make_intel_node(
            f"arc-{i}", gpus=rng.randint(0, 4), discrete=rng.random() < 0.5,
            ready=rng.random() < 0.8))
        pods.append(jfx.make_intel_pod(
            f"p-{i}", node=f"arc-{i % 7}", gpus=rng.randint(0, 3),
            phase=rng.choice(["Running", "Pending", "Succeeded"])))
        crds.append(jfx.make_intel_crd(f"c-{i}", desired=rng.randint(0, 4),
                                       ready=rng.randint(0, 4)))
    # An xe card, an NFD label without capacity, init containers.
    nodes.append({"metadata": {"name": "xe-0"}, "status": {"capacity": {"gpu.intel.com/xe": "2"},
                                                           "allocatable": {"gpu.intel.com/xe": "1"}}})
    nodes.append({"metadata": {"name": "nfd", "labels": {jintel.INTEL_GPU_NODE_LABEL: "true"}}})
    pods.append({"metadata": {"name": "init"}, "spec": {
        "initContainers": [{"name": "i", "resources": {"requests": {"gpu.intel.com/i915": "3"}}}],
        "containers": [{"name": "a", "resources": {"requests": {"gpu.intel.com/i915": "1"},
                                                    "limits": {"gpu.intel.com/xe": "2"}}},
                       {"name": "b", "resources": {"requests": {"gpu.intel.com/i915": "1"}}}]}})
    nodes += [jfx.make_tpu_node("t0"), jfx.make_plain_node("plain")]
    pods += [jfx.make_tpu_pod("tp"), jfx.make_plugin_pod("ip", provider="intel"),
             jfx.make_plugin_pod("tpl")]
    return nodes, pods, crds


def _names(objs):
    return [(obj.namespace(o), obj.name(o)) for o in objs]


def test_every_intel_function_matches_jax():
    nodes, pods, crds = _seeded_objects()
    for name in CONSTANTS:
        assert getattr(tintel, name) == getattr(jintel, name), name
    for name in NODE_FUNCTIONS:
        assert [getattr(tintel, name)(n) for n in nodes] == [
            getattr(jintel, name)(n) for n in nodes], name
    for name in POD_FUNCTIONS:
        assert [getattr(tintel, name)(p) for p in pods] == [
            getattr(jintel, name)(p) for p in pods], name
    for name, items in zip(LIST_FUNCTIONS, (nodes, pods, pods)):
        assert _names(getattr(tintel, name)(items)) == _names(getattr(jintel, name)(items))
    containers = [c for p in pods for c in obj.pod_containers(p)]
    assert [tintel.get_container_gpu_resources(c) for c in containers] == [
        jintel.get_container_gpu_resources(c) for c in containers]
    for name in ("plugin_status_to_status", "plugin_status_text"):
        assert [getattr(tintel, name)(c) for c in crds] == [getattr(jintel, name)(c) for c in crds]
    for key in RESOURCES + ("gpu.intel.com/other",):
        assert tintel.format_gpu_resource_name(key) == jintel.format_gpu_resource_name(key)
    for kind in ("discrete", "integrated", "unknown", ""):
        assert tintel.format_gpu_type(kind) == jintel.format_gpu_type(kind)
    # The seeded objects reach every branch.
    assert {tintel.get_node_gpu_type(n) for n in nodes} == {"discrete", "integrated", "unknown"}
    assert {tintel.plugin_status_to_status(c) for c in crds} == {"success", "warning", "error"}
    # Init containers overlap the main ones: max(1 + 1, 3).
    assert tintel.get_pod_gpu_requests(pods[-4]) == {"gpu.intel.com/i915": 3}


def test_crd_state_machine_and_texts():
    # k8s.ts:370-386: desired 0 is a warning, all ready a success, else an error.
    for desired, ready, status, text in ((0, None, "warning", "No nodes scheduled"),
                                         (2, None, "success", "2/2 ready"),
                                         (3, 1, "error", "1/3 ready")):
        crd = tfx.make_intel_crd(desired=desired, ready=ready)
        assert tintel.plugin_status_to_status(crd) == status
        assert tintel.plugin_status_text(crd) == text


def test_the_intel_fixtures_are_jaxs_byte_for_byte():
    def same(a, b):
        return json.dumps(a, sort_keys=False) == json.dumps(b, sort_keys=False)

    assert same(tfx.fleet_mixed(), jfx.fleet_mixed())
    for kwargs in ({}, {"gpus": 3, "discrete": False, "ready": False, "age_seconds": 7}):
        assert same(tfx.make_intel_node("n", **kwargs), jfx.make_intel_node("n", **kwargs))
    for kwargs in ({}, {"namespace": "x", "node": "n", "gpus": 2, "phase": "Pending"}):
        assert same(tfx.make_intel_pod("p", **kwargs), jfx.make_intel_pod("p", **kwargs))
    for kwargs in ({}, {"desired": 4, "ready": 1, "shared_dev_num": 3}):
        assert same(tfx.make_intel_crd(**kwargs), jfx.make_intel_crd(**kwargs))
    for provider in ("tpu", "intel"):
        assert same(tfx.make_plugin_pod("d", provider=provider, node="n"),
                    jfx.make_plugin_pod("d", provider=provider, node="n"))
    # The default stays the TPU plugin pod every earlier caller built.
    assert same(tfx.make_plugin_pod("d"), jfx.make_plugin_pod("d", provider="tpu"))
    path = "/apis/deviceplugin.intel.com/v1/gpudeviceplugins"
    assert same(tfx.fleet_transport(tfx.fleet_mixed()).request(path, 1.0),
                jfx.fleet_transport(jfx.fleet_mixed()).request(path, 1.0))


@pytest.mark.parametrize("fleet", ["fleet_mixed", "fleet_v5p32", "fleet_large"])
def test_classify_fleet_with_both_providers_matches_jax(fleet):
    make = (lambda m: m.fleet_large(1024)) if fleet == "fleet_large" else (
        lambda m: getattr(m, fleet)())
    f = make(jfx)
    jviews = jacc.classify_fleet(f["nodes"], f["pods"])
    tviews = tacc.classify_fleet(f["nodes"], f["pods"])
    assert list(tviews) == list(jviews) == ["tpu", "intel"]
    for name, tview in tviews.items():
        jview = jviews[name]
        for attr in ("nodes", "pods", "plugin_pods"):
            assert _names(getattr(tview, attr)) == _names(getattr(jview, attr)), (name, attr)
        assert dict(tview.allocation_summary()) == dict(jview.allocation_summary())
        assert tview.plugin_installed == jview.plugin_installed
    for field in ("name", "display_name", "device_unit"):
        assert getattr(tacc.INTEL_PROVIDER, field) == getattr(jacc.INTEL_PROVIDER, field)
    if fleet == "fleet_mixed":
        assert len(tviews["intel"].nodes) == 2 and len(tviews["intel"].pods) == 2
    else:
        assert tviews["intel"].nodes == [] and not tviews["intel"].plugin_installed


_label = st.sampled_from([jintel.INTEL_GPU_NODE_LABEL, jintel.INTEL_DISCRETE_GPU_ROLE,
                          jintel.INTEL_INTEGRATED_GPU_ROLE, "app", "app.kubernetes.io/name",
                          "component", "k8s-app", "x"])
_label_value = st.sampled_from(["true", "false", "intel-gpu-plugin", "", "TRUE"])
_quantity = st.one_of(st.integers(-2, 9).map(str), st.integers(-2, 9), st.none(),
                      st.sampled_from(["1k", "abc", "2.5", ""]), st.floats(allow_nan=False))
_resources = st.dictionaries(st.sampled_from(RESOURCES), _quantity, max_size=4)
_junk = st.one_of(st.none(), st.integers(), st.text(max_size=3), st.lists(st.none(), max_size=2))
_metadata = st.one_of(
    _junk,
    st.fixed_dictionaries({"name": st.text(max_size=4)},
                          optional={"labels": st.one_of(_junk, st.dictionaries(
                              _label, _label_value, max_size=3))}),
)
_node = st.one_of(_junk, st.fixed_dictionaries({}, optional={
    "metadata": _metadata,
    "status": st.one_of(_junk, st.fixed_dictionaries({}, optional={
        "capacity": st.one_of(_junk, _resources), "allocatable": st.one_of(_junk, _resources)})),
}))
_container = st.one_of(_junk, st.fixed_dictionaries({"name": st.text(max_size=3)}, optional={
    "resources": st.one_of(_junk, st.fixed_dictionaries({}, optional={
        "requests": st.one_of(_junk, _resources), "limits": st.one_of(_junk, _resources)})),
}))
_pod = st.one_of(_junk, st.fixed_dictionaries({}, optional={
    "metadata": _metadata,
    "spec": st.one_of(_junk, st.fixed_dictionaries({}, optional={
        "containers": st.one_of(_junk, st.lists(_container, max_size=3)),
        "initContainers": st.one_of(_junk, st.lists(_container, max_size=2)),
        "nodeName": st.one_of(st.none(), st.text(max_size=3)),
    })),
    "status": st.one_of(_junk, st.fixed_dictionaries({}, optional={
        "phase": st.sampled_from(["Running", "Pending", "Failed", "", "Weird"]),
        "desiredNumberScheduled": _quantity, "numberReady": _quantity,
    })),
}))


@settings(max_examples=150, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(nodes=st.lists(_node, max_size=6), pods=st.lists(_pod, max_size=6))
def test_generated_and_malformed_items_degrade_as_jax_and_never_raise(nodes, pods):
    for name in NODE_FUNCTIONS:
        assert [getattr(tintel, name)(n) for n in nodes] == [
            getattr(jintel, name)(n) for n in nodes], name
    for name in POD_FUNCTIONS + ("plugin_status_to_status", "plugin_status_text"):
        assert [getattr(tintel, name)(p) for p in pods] == [
            getattr(jintel, name)(p) for p in pods], name
    tviews = tacc.classify_fleet(nodes, pods)
    jviews = jacc.classify_fleet(nodes, pods)
    for name in ("tpu", "intel"):
        for attr in ("nodes", "pods", "plugin_pods"):
            assert getattr(tviews[name], attr) == getattr(jviews[name], attr), (name, attr)
        assert dict(tviews[name].allocation_summary()) == dict(jviews[name].allocation_summary())


def test_intel_source_is_jaxs():
    assert set(default_sources()) == set(jsources.default_sources()) == {"tpu", "intel"}
    for field in ("provider_name", "workload_kind", "workload_paths", "plugin_pod_paths"):
        assert getattr(INTEL_SOURCE, field) == getattr(jsources.INTEL_SOURCE, field), field
    _, pods, crds = _seeded_objects(seed=1, n=8)
    assert [INTEL_SOURCE.plugin_pod_filter(p) for p in pods] == [
        jsources.INTEL_SOURCE.plugin_pod_filter(p) for p in pods]
    workloads = crds + [jfx.make_plugin_daemonset(), {"kind": "Other"}, {}, None, "x"]
    for tsrc, jsrc in ((INTEL_SOURCE, jsources.INTEL_SOURCE),
                       (tsources.TPU_SOURCE, jsources.TPU_SOURCE)):
        assert [tsources.workload_matches_provider(tsrc, w) for w in workloads] == [
            jsources.workload_matches_provider(jsrc, w) for w in workloads]
    assert tsources.workload_matches_provider(INTEL_SOURCE, crds[0])


def test_fleet_stats_on_an_intel_view_is_the_python_pass():
    f = tfx.fleet_mixed()
    f["nodes"] += [tfx.make_intel_node(f"arc-x{i}", gpus=1 + i % 2) for i in range(80)]
    tview = tacc.classify_fleet(f["nodes"], f["pods"])["intel"]
    jview = jacc.classify_fleet(f["nodes"], f["pods"])["intel"]
    assert len(tview.nodes) == 82 >= tstats.DEVICE_ROLLUP_MIN_NODES
    want = jstats.python_fleet_stats(jview)
    assert want["generation_counts"] == {}
    with trace_request("/t") as trace:
        got = tstats.fleet_stats(tview, device="cpu")
    assert got == want == tstats.python_fleet_stats(tview)
    rollup = trace.to_dict()["spans"][0]
    assert rollup["name"] == "analytics.rollup" and rollup["attrs"]["backend"] == "python"
    # Asking for the device backend is refused, in both packages.
    with pytest.raises(ValueError, match="TPU device accessors only"):
        tstats.fleet_stats(tview, device="cpu", backend="torch")
    with pytest.raises(ValueError, match="TPU device accessors only"):
        jstats.fleet_stats(jview, backend="xla")
    # The TPU view beside it keeps its generation histogram.
    tpu = tacc.classify_fleet(f["nodes"], f["pods"])["tpu"]
    assert tstats.python_fleet_stats(tpu)["generation_counts"] == jstats.python_fleet_stats(
        jacc.classify_fleet(f["nodes"], f["pods"])["tpu"])["generation_counts"] != {}

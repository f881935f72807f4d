"""The port's five Intel GPU pages against the JAX package's, on the CPU.

Each package syncs its own context over its own fixture transport for the
same fleet, and the four snapshot pages (Overview, Device Plugins, Nodes,
Workloads) render to the same HTML: at ``fleet_mixed``, on a fleet with no
Intel node (the Helm hint and the CRD-missing notice), with a CR in a
degraded rollout, and with 512 more Intel nodes, whose Nodes table pages
and filters. The Metrics page renders JAX's bytes from the demo's i915
power series (the fetch timer pinned in both), a zero TDP, an unreachable
Prometheus and a Prometheus with no i915 chips, mirroring
``tests/test_intel.py``. Everything is exact.
"""

import pytest

from headlamp_tpu.context import AcceleratorDataContext as JaxContext
from headlamp_tpu.fleet import fixtures as jfx
from headlamp_tpu.metrics import intel_client as jclient
from headlamp_tpu.metrics import timing as jtiming
from headlamp_tpu.pages import intel as jpages
from headlamp_tpu.server.app import make_demo_transport as jax_demo_transport
from headlamp_tpu.transport import MockTransport as JaxMock
from headlamp_tpu.ui import render_html as jax_render_html
from headlamp_tpu_torch.context import AcceleratorDataContext
from headlamp_tpu_torch.fleet import fixtures as tfx
from headlamp_tpu_torch.metrics import intel_client as tclient
from headlamp_tpu_torch.metrics import timing as ttiming
from headlamp_tpu_torch.pages import intel as tpages
from headlamp_tpu_torch.server import make_demo_transport
from headlamp_tpu_torch.transport import MockTransport
from headlamp_tpu_torch.ui import render_html, text_content

CLOCK = 1785283200.0
SNAPSHOT_PAGES = ("intel_overview_page", "intel_device_plugins_page", "intel_nodes_page",
                  "intel_pods_page")


def clock():
    return CLOCK


def _mixed(fx):
    return fx.fleet_mixed()


def _no_intel(fx):
    return fx.fleet_v5p32()


def _degraded(fx):
    fleet = dict(fx.fleet_mixed())
    fleet["gpudeviceplugins"] = [fx.make_intel_crd(desired=4, ready=1),
                                 fx.make_intel_crd("second", desired=0)]
    return fleet


def _large(fx):
    """fleet_mixed plus 512 Intel nodes (1 or 2 cards, discrete or
    integrated, every 16th not Ready) and a pod on every 4th."""
    fleet = fx.fleet_mixed()
    for i in range(512):
        fleet["nodes"].append(fx.make_intel_node(
            f"arc-{i:03d}", gpus=1 + i % 2, discrete=i % 3 != 0, ready=i % 16 != 0))
        if i % 4 == 0:
            fleet["pods"].append(fx.make_intel_pod(
                f"job-{i}", node=f"arc-{i:03d}", phase="Pending" if i % 32 == 0 else "Running"))
    return fleet


FLEETS = {"mixed": _mixed, "no_intel": _no_intel, "degraded_crd": _degraded, "large": _large}


def _snapshots(make):
    jsnap = JaxContext(jfx.fleet_transport(make(jfx)), clock=clock).sync()
    tctx = AcceleratorDataContext(tfx.fleet_transport(make(tfx)), device="cpu", clock=clock)
    return jsnap, tctx.sync()


@pytest.fixture(autouse=True)
def pinned_fetch_timer(monkeypatch):
    for module in (ttiming, jtiming):
        monkeypatch.setattr(module.FetchTimer, "stamp", lambda self: (self._clock(), 12.5))


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_snapshot_pages_equal_jax(fleet):
    jsnap, tsnap = _snapshots(FLEETS[fleet])
    html = {}
    for name in SNAPSHOT_PAGES:
        want = jax_render_html(getattr(jpages, name)(jsnap, now=CLOCK))
        got = render_html(getattr(tpages, name)(tsnap, now=CLOCK))
        assert got == want, (fleet, name)
        html[name] = got
    overview, plugins, nodes, pods = (html[n] for n in SNAPSHOT_PAGES)
    if fleet == "no_intel":
        assert "Intel GPU Plugin Not Detected" in overview and "helm" in overview.lower()
        assert "GpuDevicePlugin CRD not available" in overview
        assert "GpuDevicePlugin CRD not available" in plugins
        assert "No Intel GPU nodes found" in nodes and "No GPU pods found" in pods
    elif fleet == "degraded_crd":
        text = text_content(tpages.intel_device_plugins_page(tsnap, now=CLOCK))
        assert "1/4 ready" in text and "Unavailable 3" in text
        assert "No nodes scheduled" in text
    elif fleet == "mixed":
        text = text_content(tpages.intel_overview_page(tsnap, now=CLOCK))
        assert "Total 2" in text and "Capacity 3 devices" in text and "2/2 ready" in text
        assert "Attention: Pending GPU Pods" in pods and "GPU (i915) 2" in text_content(
            tpages.intel_nodes_page(tsnap, now=CLOCK))
    else:
        # 514 Intel nodes: the table pages at 512 rows, the cards cap at 64.
        assert "page 1 of 2" in nodes and nodes.count("hl-node-card") == 64


@pytest.mark.parametrize("paging", [{"page": 2}, {"query": "arc-01"},
                                    {"page": 99, "query": "nothing-matches"}])
def test_nodes_page_pages_and_filters_as_jax(paging):
    jsnap, tsnap = _snapshots(_large)
    want = jax_render_html(jpages.intel_nodes_page(jsnap, now=CLOCK, **paging))
    got = render_html(tpages.intel_nodes_page(tsnap, now=CLOCK, **paging))
    assert got == want
    if paging.get("page") == 2:
        assert "page 2 of 2" in got and 'href="/intel/nodes?page=1"' in got


def _metrics_cases():
    """label -> (port snapshot, JAX snapshot) for the metrics page."""
    zero_tdp = [dict(node="arc-node-1", chip="card0", power_watts=8.0, tdp_watts=0.0)]
    mixed = [dict(node="arc-node-1", chip="card0", power_watts=20.0, tdp_watts=100.0),
             dict(node="arc-node-2", chip="card0")]

    def snap(mod, chips, **kw):
        return mod.IntelMetricsSnapshot(
            namespace="monitoring", service="prometheus-k8s:9090",
            chips=[mod.GpuChipMetrics(**c) for c in chips], **kw)

    return {
        "demo_series": (
            tclient.fetch_intel_gpu_metrics(make_demo_transport("mixed"), clock=clock),
            jclient.fetch_intel_gpu_metrics(jax_demo_transport("mixed"), clock=clock)),
        "zero_tdp": (snap(tclient, zero_tdp, fetch_ms=10.0), snap(jclient, zero_tdp, fetch_ms=10.0)),
        "missing_power": (snap(tclient, mixed, fetch_ms=321.0), snap(jclient, mixed, fetch_ms=321.0)),
        "unreachable": (tclient.fetch_intel_gpu_metrics(MockTransport(), clock=clock),
                        jclient.fetch_intel_gpu_metrics(JaxMock(), clock=clock)),
        "no_i915": (snap(tclient, []), snap(jclient, [])),
    }


@pytest.mark.parametrize("case", ["demo_series", "zero_tdp", "missing_power", "unreachable",
                                  "no_i915"])
def test_metrics_page_equals_jax(case):
    tsnap, jsnap = _metrics_cases()[case]
    assert (tsnap is None) == (jsnap is None)
    if tsnap is not None:
        assert vars(tsnap) | {"chips": [vars(c) for c in tsnap.chips]} == vars(jsnap) | {
            "chips": [vars(c) for c in jsnap.chips]}
    got = render_html(tpages.intel_metrics_page(tsnap))
    assert got == jax_render_html(jpages.intel_metrics_page(jsnap))
    text = text_content(tpages.intel_metrics_page(tsnap))
    assert "GPU frequency" in text and "AMD-only" in text
    expect = {
        "demo_series": ("Total power 40.0 W", "Total TDP 240.0 W", "hl-utilbar"),
        "zero_tdp": ("0.0 W", "Total TDP 0.0 W"),
        "missing_power": ("Total power 20.0 W", "needs ≥5m of scrape history", "hl-utilbar"),
        "unreachable": ("Prometheus not reachable", "monitoring/prometheus-k8s:9090"),
        "no_i915": ("No i915 Metrics",),
    }[case]
    for needle in expect:
        assert needle in text or needle in got, (case, needle)
    if case == "zero_tdp":
        # A zero TDP is a reading, not a gap: no zero-capacity meter.
        assert "hl-utilbar" not in got and "needs ≥5m" not in text

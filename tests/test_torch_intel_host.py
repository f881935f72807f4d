"""The port's host at ``--demo mixed`` against the JAX host's, on the CPU.

The port's ``DashboardApp(device="cpu")`` and the JAX ``DashboardApp``
serve ``make_demo_transport("mixed")`` with the wall clock and the
Prometheus fetch timer pinned: every ``/intel*`` route (the Nodes page
paged and filtered), ``/nodes`` with the TPU and the Intel columns (JAX's
full registry), the Intel and TPU node views and the Intel pod view give
the same ``<main>`` bytes, under the same route labels, and the port's
fragment paints equal its plain paints across a fleet change. A raising
Intel fetch is a 500 naming the error. ``/healthz`` at ``--demo mixed``
differs from JAX's by exactly the keys it differs by at ``--demo v5p32``:
the Intel provider adds no key to either. ``fetch_intel_gpu_metrics``
gives JAX's snapshot, a query answering ``ApiError`` reading as an empty
vector in both. The CLI's five ``intel*`` pages are JAX's text. A port
leader's bus record carries the ``intel`` block JAX's carries, a port
replica paints the leader's Intel pages, and a port worker fed a JAX
leader's segment seeds both providers' columns.
"""

from __future__ import annotations

import json
import re
import urllib.parse

import numpy as np
import pytest

from headlamp_tpu import cli as jax_cli
from headlamp_tpu import replicate as jrep
from headlamp_tpu import workers as jworkers
from headlamp_tpu.fleet import fixtures as jfx
from headlamp_tpu.metrics import intel_client as jclient
from headlamp_tpu.metrics import timing as jtiming
from headlamp_tpu.runtime.transfer import TransferBatch
from headlamp_tpu.server import DashboardApp as JaxApp
from headlamp_tpu.server.app import add_demo_prometheus as jax_add_prometheus
from headlamp_tpu.server.app import make_demo_transport as jax_demo_transport
from headlamp_tpu.transport import ApiError as JaxApiError
from headlamp_tpu_torch import replicate as trep
from headlamp_tpu_torch.cli import render_page
from headlamp_tpu_torch.fleet import fixtures as tfx
from headlamp_tpu_torch.metrics import intel_client as tclient
from headlamp_tpu_torch.metrics import timing as ttiming
from headlamp_tpu_torch.models.fused_forward import LAUNCHES
from headlamp_tpu_torch.obs import slo as tslo
from headlamp_tpu_torch.runtime import columns as tcolumns
from headlamp_tpu_torch.runtime.device_cache import warm_carries
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport
from headlamp_tpu_torch.server import app as app_mod
from headlamp_tpu_torch.transport import ApiError
from headlamp_tpu_torch.workers import ShmConsumer

CLOCK = 1785283200.0
INTEL_PATHS = ("/intel", "/intel/nodes", "/intel/nodes?page=1", "/intel/nodes?q=arc-node-2",
               "/intel/pods", "/intel/deviceplugins", "/intel/metrics")
NATIVE_PATHS = ("/nodes", "/nodes?q=arc", "/node/arc-node-1", "/node/arc-node-2",
                "/node/gke-v5e16-pool-w0", "/pod/default/transcode-1",
                "/pod/default/transcode-2", "/pod/ml/llm-shard-0")
SNAPSHOT_INTEL = ("/intel", "/intel/nodes", "/intel/pods", "/intel/deviceplugins")


def clock():
    return CLOCK


def _main(body):
    return re.search(r"<main>(.*)</main>", body, re.S).group(1)


@pytest.fixture(autouse=True)
def pinned(monkeypatch):
    for module in (ttiming, jtiming):
        monkeypatch.setattr(module.FetchTimer, "stamp", lambda self: (self._clock(), 12.5))
    monkeypatch.setattr(tslo, "_engine", tslo.SLOEngine())
    warm_carries.invalidate()


def _paint(app, paths, handle=None):
    handle = handle or app.handle
    out = {}
    for path in paths:
        status, ctype, body = handle(path)
        out[path] = (status, ctype, _main(body) if "<main>" in body else body)
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


def test_every_intel_route_and_native_view_is_jaxs():
    port = DashboardApp(make_demo_transport("mixed"), device="cpu", clock=clock)
    jax = JaxApp(jax_demo_transport("mixed"), clock=clock)
    try:
        paths = INTEL_PATHS + NATIVE_PATHS
        got, want = _paint(port, paths), _paint(jax, paths, lambda p: _jax_handle(jax, p))
        for path in paths:
            assert got[path] == want[path], path
            assert got[path][0] == 200, path
            label = port._route_label(path)
            assert label == jax._route_label(path), path
        assert port._route_label("/intel/metrics") == "/intel/metrics"
        assert "<th>GPU Type</th><th>GPU Devices</th>" in got["/nodes"][2]
        assert "<th>TPU Type</th>" in got["/nodes"][2]
        assert '<h2 class="hl-section-title">Intel GPU</h2>' in got["/node/arc-node-1"][2]
        assert '<h2 class="hl-section-title">TPU</h2>' in got["/node/gke-v5e16-pool-w0"][2]
        assert "request 1 / limit 1" in got["/pod/default/transcode-1"][2]
        assert "<dt>Total power</dt><dd>40.0 W</dd>" in got["/intel/metrics"][2]
    finally:
        port.close()


def test_fragment_paints_equal_plain_paints_across_a_fleet_change():
    transports = [make_demo_transport("mixed") for _ in range(2)]
    apps = [DashboardApp(t, device="cpu", clock=clock, min_sync_interval_s=0.0, fragments=f)
            for t, f in zip(transports, (True, False))]
    try:
        for step in range(3):
            if step == 1:
                for t in transports:
                    node = tfx.make_intel_node("arc-node-2", gpus=1, ready=True)
                    t.node_feed.push("MODIFIED", node)
            if step == 2:
                for t in transports:
                    t.pod_feed.push("ADDED", tfx.make_intel_pod("transcode-3", node="arc-node-1"))
            for path in INTEL_PATHS:
                assert _main(apps[0].handle(path)[2]) == _main(apps[1].handle(path)[2]), (
                    step, path)
        assert "transcode-3" in _main(apps[0].handle("/intel/pods")[2])
    finally:
        for app in apps:
            app.close()


def test_a_raising_intel_fetch_is_a_500_naming_it(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("prometheus went away")

    monkeypatch.setattr(app_mod, "fetch_intel_gpu_metrics", broken)
    app = DashboardApp(make_demo_transport("mixed"), device="cpu", clock=clock)
    try:
        status, _, body = app.handle("/intel/metrics")
        assert status == 500 and "RuntimeError" in body and "prometheus went away" in body
        assert app.handle("/intel")[0] == 200
    finally:
        app.close()


def _keys(d, prefix=""):
    out = set()
    if isinstance(d, dict):
        for k, v in d.items():
            out.add(prefix + k)
            out |= _keys(v, prefix + k + ".")
    return out


def _health_keys(demo):
    port = DashboardApp(make_demo_transport(demo), device="cpu", clock=clock)
    jax = JaxApp(jax_demo_transport(demo), clock=clock)
    try:
        for app in (port, jax):
            for path in ("/tpu", "/intel", "/intel/metrics"):
                assert app.handle(path)[0] == 200
        return (_keys(json.loads(port.handle("/healthz")[2])),
                _keys(json.loads(jax.handle("/healthz")[2])))
    finally:
        port.close()


def test_healthz_at_demo_mixed_differs_from_jax_as_at_v5p32():
    port_mixed, jax_mixed = _health_keys("mixed")
    port_tpu, jax_tpu = _health_keys("v5p32")
    assert port_mixed == port_tpu and jax_mixed == jax_tpu
    assert port_mixed - jax_mixed == port_tpu - jax_tpu
    assert jax_mixed - port_mixed == jax_tpu - port_tpu


def test_intel_metrics_fetch_equals_jax_with_a_failing_query():
    def snapshot_dict(snap):
        return None if snap is None else {**vars(snap), "chips": [vars(c) for c in snap.chips]}

    got = tclient.fetch_intel_gpu_metrics(make_demo_transport("mixed"), clock=clock)
    want = jclient.fetch_intel_gpu_metrics(jax_demo_transport("mixed"), clock=clock)
    assert snapshot_dict(got) == snapshot_dict(want)
    assert [(c.node, c.power_watts, c.tdp_watts) for c in got.chips] == [
        ("arc-node-1", 18.5, 120.0), ("arc-node-2", 21.5, 120.0)]
    # The power query answers an error: an empty vector, the chips stay.
    path = ("/api/v1/namespaces/monitoring/services/prometheus-k8s:9090/proxy/api/v1/query"
            f"?query={urllib.parse.quote(tclient.INTEL_QUERIES['power'], safe='')}")
    tt, jt = make_demo_transport("mixed"), jax_demo_transport("mixed")
    tt.add(path, ApiError(path, "HTTP 500", status=500))
    jt.add(path, JaxApiError(path, "HTTP 500", status=500))
    got = tclient.fetch_intel_gpu_metrics(tt, clock=clock)
    want = jclient.fetch_intel_gpu_metrics(jt, clock=clock)
    assert snapshot_dict(got) == snapshot_dict(want)
    assert len(got.chips) == 2 and all(c.power_watts is None for c in got.chips)


def test_the_cli_intel_pages_are_jaxs():
    for page in ("intel", "intel-nodes", "intel-pods", "intel-deviceplugins", "intel-metrics"):
        text = render_page(page, make_demo_transport("mixed"), clock=clock, device="cpu")
        assert text == jax_cli.render_page(page, jax_demo_transport("mixed"), clock=clock), page
    assert "arc-node-1" in text


def _leader(app_cls, transport, **kwargs):
    app = app_cls(transport, clock=clock, min_sync_interval_s=3600.0, **kwargs)
    return app


def test_bus_records_carry_the_intel_block_and_a_replica_paints_it():
    tapp = _leader(DashboardApp, make_demo_transport("mixed"), device="cpu")
    japp = _leader(JaxApp, jax_demo_transport("mixed"))
    tpub, jpub = trep.BusPublisher(wall=clock), jrep.BusPublisher(wall=clock)
    tapp.replication, japp.replication = tpub, jpub
    replica = trep.ReplicaApp(device="cpu", clock=clock)
    try:
        tapp._synced_snapshot()
        japp._synced_snapshot()
        tline, jline = tpub._backlog[-1][1], jpub._backlog[-1][1]
        trecord, jrecord = json.loads(tline), json.loads(jline)
        assert trecord["snapshot"]["providers"] == jrecord["snapshot"]["providers"]
        assert trecord["snapshot"]["providers"]["intel"]["workloads"][0]["kind"] == (
            "GpuDevicePlugin")
        # Byte-equal with the same generation stamp (the leaders' own
        # generations come from their contexts).
        same_gen = trep.dumps_record(trep.build_record(tapp._last_snapshot, generation=5))
        assert same_gen == jrep.dumps_record(jrep.build_record(japp._last_snapshot, generation=5))
        _, records = trep.parse_payload(tpub.payload_after(None))
        assert all(replica.apply_record(r) for r in records)
        launches = LAUNCHES.n
        for path in SNAPSHOT_INTEL + ("/nodes", "/node/arc-node-1", "/pod/default/transcode-1"):
            assert replica.handle(path)[2] == tapp.handle(path)[2], path
        # A replica has no Prometheus: its Intel metrics page says so, as JAX's does.
        status, _, body = replica.handle("/intel/metrics")
        jreplica = jrep.ReplicaApp(clock=clock)
        assert status == 200 and _main(body) == _main(jreplica.handle("/intel/metrics")[2])
        assert "Prometheus not reachable" in body and LAUNCHES.n == launches
    finally:
        replica.close()
        tapp.close()


def test_a_jax_leaders_segment_seeds_both_providers_on_a_port_worker(tmp_path):
    fleet = jfx.fleet_mixed()
    transport = jfx.fleet_transport(fleet)
    jax_add_prometheus(transport, fleet)
    japp = JaxApp(transport, clock=clock, min_sync_interval_s=30.0)
    jseg = jworkers.SnapshotSegment(str(tmp_path / "jax.seg"), size=8 << 20)
    japp.replication = jworkers.SegmentBusPublisher(jseg, wall=clock)
    japp._synced_snapshot()
    worker = trep.ReplicaApp(device="cpu", clock=clock)
    consumer = ShmConsumer(worker, jseg.path)
    try:
        assert consumer.poll_once() == 1 and consumer.seeds == 2
        frame = jworkers.SegmentReader(jseg.path).read()
        cache = worker._ctx.fleet_cache._entries
        assert set(cache) == set(frame.columns) == {"tpu", "intel"}
        for provider in ("tpu", "intel"):
            version, seeded = cache[provider]
            assert version == worker.snapshot_generation()
            for field in tcolumns.ARRAY_FIELDS:
                assert np.array_equal(getattr(seeded, field).numpy(),
                                      getattr(frame.columns[provider], field)), field
        assert cache["intel"][1].n_nodes == 2
        for path in SNAPSHOT_INTEL + ("/nodes",):
            assert _main(worker.handle(path)[2]) == _main(japp.handle(path)[2]), path
    finally:
        worker.close()
        jseg.close()

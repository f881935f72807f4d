"""The port's copied fixtures, demo transport and Prometheus client
against the JAX package's, on the CPU: field-for-field equal fleets,
snapshots, histories and request sequences."""

import dataclasses

import pytest

from headlamp_tpu.fleet import fixtures as jfx
from headlamp_tpu.metrics import client as jclient
from headlamp_tpu.server import make_demo_transport as jax_demo_transport
from headlamp_tpu_torch.fleet import fixtures as fx
from headlamp_tpu_torch.metrics import client
from headlamp_tpu_torch.server.demo import make_demo_transport
from headlamp_tpu_torch.transport.api_proxy import MockTransport

CLOCK = 1785283200.0
PROM = ("monitoring", "prometheus-k8s:9090")


def clock():
    return CLOCK


def _snapshot_fields(snap):
    fields = dataclasses.asdict(snap)
    fields.pop("fetch_ms")  # a measured duration
    return fields


@pytest.mark.parametrize("fleet", ["v5e4", "v5p32", "large"])
def test_fixture_fleets_identical(fleet):
    make = {"v5e4": "fleet_v5e4", "v5p32": "fleet_v5p32"}.get(fleet)
    if make is None:
        assert fx.fleet_large(1024) == jfx.fleet_large(1024)
    else:
        assert getattr(fx, make)() == getattr(jfx, make)()


@pytest.mark.parametrize("fleet", ["v5e4", "v5p32", "large"])
def test_metrics_snapshot_equal_to_jax(fleet):
    got = client.fetch_tpu_metrics(make_demo_transport(fleet), clock=clock)
    want = jclient.fetch_tpu_metrics(jax_demo_transport(fleet), clock=clock)
    assert got is not None and got.chips
    assert _snapshot_fields(got) == _snapshot_fields(want)


def test_batched_scrape_sends_same_requests():
    port_t, jax_t = make_demo_transport("v5p32"), jax_demo_transport("v5p32")
    client.fetch_tpu_metrics(port_t, clock=clock)
    jclient.fetch_tpu_metrics(jax_t, clock=clock)
    assert port_t.calls == jax_t.calls


def test_utilization_history_equal_to_jax():
    got = client.fetch_utilization_history(make_demo_transport("v5p32"), prometheus=PROM, clock=clock)
    want = jclient.fetch_utilization_history(jax_demo_transport("v5p32"), prometheus=PROM, clock=clock)
    assert got is not None and len(got.series) == 16 and len(got.series[0]) == 61
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_no_prometheus_means_no_snapshot():
    assert client.fetch_tpu_metrics(MockTransport(), clock=clock) is None

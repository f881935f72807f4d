"""Replication on the card, at ``fleet_viewport(1024)`` with the demo
Prometheus: the leader's refit launches ``forecast_mlp_forward`` once and
its next record ships that forecast; a ``ReplicaApp`` on the card that
applied the records paints the slice's eight pages with the leader's
bytes, launches the kernel 0 times, and its fleet rollup on the card
equals the Python oracle. The kernel has no CPU mode, so every test here
needs a CUDA device and skips without one. On the card:

    python -m pytest tests/test_torch_cuda_replicate.py -q
"""

from __future__ import annotations

import pytest
import torch

from headlamp_tpu_torch.analytics import stats
from headlamp_tpu_torch.fleet import fleet_transport, fleet_viewport
from headlamp_tpu_torch.models import aot
from headlamp_tpu_torch.models.fused_forward import LAUNCHES
from headlamp_tpu_torch.obs import graphcost
from headlamp_tpu_torch.obs import slo as tslo
from headlamp_tpu_torch.replicate import BusPublisher, ReplicaApp, parse_payload
from headlamp_tpu_torch.runtime.device_cache import warm_carries
from headlamp_tpu_torch.server import DashboardApp
from headlamp_tpu_torch.server.demo import add_demo_prometheus

CLOCK = 1785283200.0
PAGES = ("/tpu", "/tpu/nodes", "/tpu/pods", "/tpu/topology", "/tpu/metrics",
         "/tpu/deviceplugins", "/tpu/fleet", "/tpu/trends")


def clock():
    return CLOCK


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    monkeypatch.setattr(graphcost, "_LEDGER", graphcost.GraphCostLedger())
    monkeypatch.setattr(aot, "_REGISTRY", aot.AotProgramRegistry())
    monkeypatch.setattr(tslo, "_engine", tslo.SLOEngine())
    warm_carries.invalidate()


def test_a_replica_on_the_card_paints_the_leaders_bytes_and_launches_nothing(card):
    fleet = fleet_viewport(1024)
    transport = fleet_transport(fleet)
    add_demo_prometheus(transport, fleet)
    mono = [5000.0]
    leader = DashboardApp(transport, device="cuda", clock=clock, monotonic=lambda: mono[0],
                          min_sync_interval_s=3600.0)
    leader.history.capture_timings = False
    publisher = BusPublisher(monotonic=lambda: mono[0], wall=clock, ledger=leader.ledger)
    leader.replication = publisher
    replica = ReplicaApp(device="cuda", clock=clock, monotonic=lambda: mono[0])
    replica.history.capture_timings = False
    try:
        LAUNCHES.reset()
        assert leader.handle("/tpu/metrics")[0] == 200
        torch.cuda.synchronize()
        assert LAUNCHES.n == 1
        leader._last_sync = float("-inf")
        assert leader.handle("/tpu")[0] == 200  # the generation that ships the forecast
        _, records = parse_payload(publisher.payload_after(None))
        assert [replica.apply_record(r) for r in records] == [True, True]
        assert replica._bus_forecast.inference_path == "cuda"
        for path in PAGES:
            got, want = replica.handle(path), leader.handle(path)
            assert got[0] == want[0] == 200 and got == want, path
        torch.cuda.synchronize()
        assert LAUNCHES.n == 1  # the replica's metrics paints fit nothing
        state = replica._last_snapshot.provider("tpu")
        assert state.device.type == "cuda"
        assert state.fleet_stats() == stats.python_fleet_stats(state.view)
    finally:
        leader.close()
        replica.close()

"""The port's bus codec, publisher, election and trace propagation against
JAX's, on the CPU.

On one fleet synced by each package's context, with the same metrics and
forecast values, ``dumps_record(build_record(…))`` gives the same bytes
in both packages (the provenance block, both providers' blocks with the
Intel one, and fresh scrape rows included),
and both ``parse_payload`` gates refuse the same empty, foreign and
future payloads with the same message. A JAX leader's payload applies on
a port replica and a port leader's on a JAX replica: equal snapshots,
generations and history rows. Both publishers fence and resume alike over
one publish script, both elections run one failover script alike on
injected clocks, and ``format_traceparent``/``parse_traceparent`` agree on
fixed ids and malformed headers, counted alike.
"""

from __future__ import annotations

import pytest

from headlamp_tpu.context.accelerator_context import AcceleratorDataContext as JaxContext
from headlamp_tpu.fleet import fixtures as jfx
from headlamp_tpu.metrics.client import TpuChipMetrics as JaxChip
from headlamp_tpu.metrics.client import TpuMetricsSnapshot as JaxMetrics
from headlamp_tpu.models.service import ChipForecast as JaxChipForecast
from headlamp_tpu.models.service import ForecastView as JaxForecast
from headlamp_tpu.obs import propagate as jprop
from headlamp_tpu import replicate as jrep
from headlamp_tpu.server import DashboardApp as JaxApp
from headlamp_tpu.server.app import add_demo_prometheus as jax_add_prometheus
from headlamp_tpu_torch import replicate as trep
from headlamp_tpu_torch.context import AcceleratorDataContext
from headlamp_tpu_torch.fleet import fixtures as tfx
from headlamp_tpu_torch.metrics.client import TpuChipMetrics, TpuMetricsSnapshot
from headlamp_tpu_torch.models.service import ChipForecast, ForecastView
from headlamp_tpu_torch.obs import propagate as tprop
from headlamp_tpu_torch.server import DashboardApp
from headlamp_tpu_torch.server.demo import add_demo_prometheus

CLOCK = 1785283200.0


def clock():
    return CLOCK


class FakeClock:
    def __init__(self, now: float = 1000.0) -> None:
        self.now = now

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds


def _chips(chip_cls):
    return [
        chip_cls(node=f"n{i}", accelerator_id=str(i % 4), tensorcore_utilization=0.125 * (i % 8),
                 memory_bandwidth_utilization=None if i % 3 else 0.5, hbm_bytes_used=float(i),
                 hbm_bytes_total=16.0, duty_cycle=None if i % 5 == 0 else 0.25 * (i % 4))
        for i in range(10)
    ]


def _metrics(metrics_cls, chip_cls):
    return metrics_cls(
        namespace="monitoring", service="prometheus", chips=_chips(chip_cls),
        availability={"tensorcore_utilization": True, "duty_cycle": True},
        resolved_series={"tensorcore_utilization": "tpu_tensorcore_utilization"},
        fetched_at=CLOCK - 3.5, fetch_ms=12.25,
    )


def _forecast(view_cls, chip_cls):
    chips = [chip_cls(node=f"n{i}", accelerator_id="0", current=0.5, predicted_peak=0.75 + i / 64,
                      predicted_mean=0.6, saturation_risk=i % 2 == 0) for i in range(4)]
    return view_cls(horizon_s=600, window_s=3600, chips=chips, fit_ms=17.5,
                    inference_path="cuda-warm", fit_mse=1.5e-3, carried_from_generation=3,
                    data_source="history")


def _snapshots(fleet_name="fleet_v5p32"):
    # Both contexts classify for both providers, TPU and Intel.
    jctx = JaxContext(jfx.fleet_transport(getattr(jfx, fleet_name)()), clock=clock)
    tctx = AcceleratorDataContext(
        tfx.fleet_transport(getattr(tfx, fleet_name)()), device="cpu", clock=clock
    )
    return jctx.sync(), tctx.sync()


@pytest.mark.parametrize("fleet_name", ["fleet_v5p32", "fleet_v5p32_degraded", "fleet_mixed"])
def test_records_equal_jax_byte_for_byte(fleet_name):
    jsnap, tsnap = _snapshots(fleet_name)
    assert list(tsnap.providers) == list(jsnap.providers) == ["tpu", "intel"]
    jm, tm = _metrics(JaxMetrics, JaxChip), _metrics(TpuMetricsSnapshot, TpuChipMetrics)
    jf, tf = _forecast(JaxForecast, JaxChipForecast), _forecast(ForecastView, ChipForecast)
    obs = {"trace_id": "0123456789abcdef", "stages": {"synced": {"wall": CLOCK, "lag_ms": 1.5}}}
    for include_scrape in (False, True):
        jrows = jrep.history_rows(jsnap, 7, metrics=jm, include_scrape=include_scrape)
        trows = trep.history_rows(tsnap, 7, metrics=tm, include_scrape=include_scrape)
        assert trows == jrows
        want = jrep.dumps_record(jrep.build_record(
            jsnap, generation=7, fencing=2, metrics=jm, forecast=jf, history=jrows, obs=obs))
        got = trep.dumps_record(trep.build_record(
            tsnap, generation=7, fencing=2, metrics=tm, forecast=tf, history=trows, obs=obs))
        assert got == want
    # Without the optional pieces too (no obs key, null peeks, default rows).
    assert trep.dumps_record(trep.build_record(tsnap, generation=1)) == jrep.dumps_record(
        jrep.build_record(jsnap, generation=1))
    # The peeks decode to the port's own dataclasses, equal field by field.
    assert trep.decode_metrics(trep.encode_metrics(tm)) == tm
    assert trep.decode_forecast(jrep.encode_forecast(jf)) == tf


def test_both_gates_refuse_the_same_payloads():
    header = jrep.bus.header_line(wall=clock, note="x")
    record = '{"generation":1,"kind":"generation"}'
    payloads = [
        "", "\n\n",
        '{"kind":"header","format":"other","v":1}\n',
        '{"kind":"record","format":"headlamp-tpu-bus","v":1}\n',
        header.replace('"v":1', '"v":2') + "\n" + record,
        header.replace('"v":1', '"v":"1"') + "\n",
        header + "\n" + record + '\n{"kind":"future","generation":2}\n' + record,
        header + "\n",
    ]
    assert trep.bus.header_line(wall=clock, note="x") == header
    expected = ["refused"] * 6 + ["ok", "ok"]
    for payload, verdict in zip(payloads, expected):
        outcomes = []
        for mod in (jrep, trep):
            try:
                outcomes.append(("ok",) + mod.parse_payload(payload, origin="<t>"))
            except ValueError as e:
                outcomes.append(("refused", str(e)))
        assert outcomes[0] == outcomes[1], payload
        assert outcomes[1][0] == verdict, payload


def _apply_across(leader_cls, add_prometheus, fixtures, replica_factory, replica_mod, leader_mod):
    fleet = fixtures.fleet_v5e4()
    transport = fixtures.fleet_transport(fleet)
    add_prometheus(transport, fleet)
    kwargs = {"device": "cpu"} if leader_cls is DashboardApp else {}
    leader = leader_cls(transport, clock=clock, min_sync_interval_s=3600.0, **kwargs)
    publisher = leader_mod.BusPublisher(wall=clock)
    leader.replication = publisher
    leader._synced_snapshot()
    leader._ctx.advance_generation_floor(leader.snapshot_generation() + 1)
    leader._last_sync = float("-inf")
    leader._synced_snapshot()
    replica = replica_factory()
    _, records = replica_mod.parse_payload(publisher.payload_after(None))
    assert [replica.apply_record(r) for r in records] == [True, True]
    return leader, replica


def test_payloads_cross_between_the_packages_and_apply():
    pairs = [
        # A JAX leader's bus feeding a port replica, and the reverse.
        _apply_across(JaxApp, jax_add_prometheus, jfx,
                      lambda: trep.ReplicaApp(device="cpu", clock=clock), trep, jrep),
        _apply_across(DashboardApp, add_demo_prometheus, tfx,
                      lambda: jrep.ReplicaApp(clock=clock), jrep, trep),
    ]
    for leader, replica in pairs:
        assert replica.snapshot_generation() == leader.snapshot_generation() == 3
        assert trep.encode_snapshot(replica._last_snapshot) == jrep.encode_snapshot(
            leader._last_snapshot)
        assert set(trep.encode_snapshot(replica._last_snapshot)["providers"]) == {"tpu", "intel"}
        for metric in ("sync.generation", "sync.nodes", "sync.errors"):
            assert replica.history.series(metric)[1] == leader.history.series(metric)[1], metric
        assert replica.applied == 2 and replica.history.syncs == 2
    # The port replica's views are the port's own, stamped with the generation.
    port_replica = pairs[0][1]
    tpu = port_replica._last_snapshot.provider("tpu")
    assert tpu.view.version == 3 and str(tpu.device) == "cpu"
    assert tpu.fleet_cache is port_replica._ctx.fleet_cache
    # The port's apps join what they started; JAX's have no close().
    pairs[0][1].close()
    pairs[1][0].close()


def test_publishers_fence_and_resume_as_jax():
    jsnap, tsnap = _snapshots()
    mono = FakeClock()
    pubs = {"jax": jrep.BusPublisher(backlog_limit=3, monotonic=mono, wall=clock),
            "port": trep.BusPublisher(backlog_limit=3, monotonic=mono, wall=clock)}
    snaps = {"jax": jsnap, "port": tsnap}
    script = [1, 2, 2, 1, 5, 1_000_001, 3, 1_000_002, 1_000_003]
    trail = {}
    for name, pub in pubs.items():
        steps = []
        for generation in script:
            steps.append(pub.publish(snaps[name], generation=generation))
            mono.advance(0.5)
        pulls = [pub.payload_after(c) for c in (None, 0, 2, 1_000_001, 1_000_003)]
        trail[name] = (steps, pulls, pub.counters()["published"], pub.rejected_stale,
                       pub.pulls, pub.bytes_served, pub.last_generation)
    assert trail["port"] == trail["jax"]
    # The newest three generations survive; an older cursor catches up from them.
    _, records = trep.parse_payload(pubs["port"].payload_after(0))
    assert [r["generation"] for r in records] == [1_000_001, 1_000_002, 1_000_003]


def test_elections_run_one_failover_script_alike():
    def drive(mod):
        clock_ = FakeClock()
        store = mod.LeaseStore(monotonic=clock_)
        seen = []
        a = mod.LeaderElector(store, "a", ttl_s=15.0, monotonic=clock_,
                              on_elected=lambda f: seen.append(("a", f)),
                              on_deposed=lambda: seen.append(("a", "deposed")))
        b = mod.LeaderElector(store, "b", ttl_s=15.0, monotonic=clock_,
                              on_elected=lambda f: seen.append(("b", f)))
        steps = [a.tick(), b.tick()]
        clock_.advance(10.0)
        steps += [a.tick(), b.tick()]
        clock_.advance(16.0)  # a's renewal lapses
        steps += [b.tick(), a.tick(), b.tick()]
        b.resign()
        steps += [a.tick(), store.holder().fencing, mod.generation_floor(a.fencing)]
        keys = ("node_id", "is_leader", "fencing", "elections", "depositions", "lease_remaining_s")
        return steps, seen, [{k: e.snapshot()[k] for k in keys} for e in (a, b)]

    assert drive(trep) == drive(jrep)
    assert trep.GENERATION_STRIDE == jrep.GENERATION_STRIDE == 1_000_000
    assert trep.DEFAULT_LEASE_TTL_S == jrep.DEFAULT_LEASE_TTL_S


def _propagation(mod, registry):
    name = ("headlamp_tpu_torch" if mod is tprop else "headlamp_tpu") + "_trace_propagation_total"
    counter = registry._metrics[name]
    return {d: counter.value_for(direction=d) for d in ("injected", "extracted", "invalid")}


def test_traceparent_format_and_parse_agree():
    from headlamp_tpu.obs.metrics import registry as jreg
    from headlamp_tpu_torch.obs.metrics import registry as treg

    ids = ["0123456789abcdef", "f" * 32, "00000000000000000000000000000abc", "abc"]
    for trace_id in ids:
        for span_id in (None, "1122334455667788"):
            for sampled in (True, False):
                assert tprop.format_traceparent(trace_id, span_id, sampled=sampled) == (
                    jprop.format_traceparent(trace_id, span_id, sampled=sampled))
    headers = [
        None, "", tprop.format_traceparent("0123456789abcdef"),
        "  00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01 ",
        "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-00",
        "01-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
        "00-" + "0" * 32 + "-00f067aa0ba902b7-01",
        "00-4bf92f3577b34da6a3ce929d0e0e4736-" + "0" * 16 + "-01",
        "00-4BF92F3577B34DA6A3CE929D0E0E4736-00f067aa0ba902b7-01", "garbage", "00-abc-def-01",
    ]
    before = (_propagation(jprop, jreg), _propagation(tprop, treg))
    for value in headers:
        got, want = tprop.parse_traceparent(value), jprop.parse_traceparent(value)
        assert (None if got is None else tuple(got)) == (None if want is None else tuple(want))
    after = (_propagation(jprop, jreg), _propagation(tprop, treg))
    moved = [{d: a[d] - b[d] for d in a} for a, b in zip(after, before)]
    assert moved[0] == moved[1] == {"injected": 0, "extracted": 3, "invalid": 6}
    assert tprop.parse_traceparent(tprop.format_traceparent("0123456789abcdef")).trace_id == (
        "0123456789abcdef")
    assert tprop.TRACEPARENT_HEADER == jprop.TRACEPARENT_HEADER == "traceparent"
    assert tprop.current_traceparent() is None

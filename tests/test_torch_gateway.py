"""The port's request gateway (``headlamp_tpu_torch/gateway``) against the
JAX package's (``headlamp_tpu/gateway``), on the CPU.

Both packages' ``RenderGateway``s and ``RenderPool``s run the same
scripted fake handlers on the same ``FakeMono`` clocks (the pattern of
``tests/test_gateway.py``), and each scenario's outcome — statuses,
JSON bodies, headers, execution order, counters and snapshot keys — is
held equal between the two, exactly. Shedding runs on each package's
real ``SLOEngine`` driven into page on the injected clock. Real threads
only carry execution; every policy decision reads the fake clock.
"""

from __future__ import annotations

import json
import threading
import time

import pytest

from headlamp_tpu import gateway as jgw
from headlamp_tpu.obs import metrics as jmetrics
from headlamp_tpu.obs import slo as jslo
from headlamp_tpu_torch import gateway as tgw
from headlamp_tpu_torch.obs import metrics as tmetrics
from headlamp_tpu_torch.obs import slo as tslo

PACKAGES = {
    "jax": (jgw, jslo, jmetrics.registry),
    "port": (tgw, tslo, tmetrics.registry),
}


class FakeMono:
    def __init__(self, start: float = 1000.0) -> None:
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds


def _route_label(path: str) -> str:
    return path.split("?", 1)[0].rstrip("/") or "/tpu"


def make_gateway(gw_mod, slo_mod, handle, **kwargs):
    kwargs.setdefault("route_label", _route_label)
    kwargs.setdefault("workers", 2)
    kwargs.setdefault("request_timeout_s", 10.0)
    # A fresh all-ok engine: the process engine carries other tests' 5xx.
    kwargs.setdefault("engine", lambda: slo_mod.SLOEngine())
    return gw_mod.RenderGateway(handle, **kwargs)


def ok_handle(path, *, accept=None, gateway_info=None):
    return 200, "text/html", f"page:{path}"


def _wait(pred, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.005)


def _both(scenario):
    """The scenario's result for each package; held equal by the caller."""
    return {name: scenario(*mods) for name, mods in PACKAGES.items()}


def _paged_engine(slo_mod):
    """A real SLOEngine on a fake clock, paging dashboard_render."""
    clock = FakeMono()
    eng = slo_mod.SLOEngine(monotonic=clock)
    eng.clock = clock
    for _ in range(600):
        eng.record("dashboard_render", False)
    assert eng.health_block()["dashboard_render"] == "page"
    return eng


def test_priority_order_under_a_full_queue_and_the_per_route_cap():
    def scenario(gw_mod, _slo, _reg):
        started, release = threading.Event(), threading.Event()
        order, lock = [], threading.Lock()

        def runner(name):
            def fn():
                with lock:
                    order.append(name)
            return fn

        pool = gw_mod.RenderPool(workers=1)
        try:
            pool.submit("/block", gw_mod.PRIORITY_INTERACTIVE,
                        lambda: (started.set(), release.wait(5.0)))
            assert started.wait(5.0)
            jobs = [
                pool.submit("/debug/traces", gw_mod.PRIORITY_DEBUG, runner("debug")),
                pool.submit("/metricsz", gw_mod.PRIORITY_OPS, runner("ops")),
                pool.submit("/tpu", gw_mod.PRIORITY_INTERACTIVE, runner("interactive")),
            ]
            release.set()
            assert all(job.done.wait(5.0) for job in jobs)
        finally:
            pool.close()
        # Route cap 1 on two workers: a second /tpu waits while /nodes runs.
        release = threading.Event()
        running = []

        def tracked(route):
            def fn():
                with lock:
                    running.append(route)
                release.wait(5.0)
            return fn

        pool = gw_mod.RenderPool(workers=2, route_limit=1)
        try:
            jobs = [pool.submit(r, gw_mod.PRIORITY_INTERACTIVE, tracked(r))
                    for r in ("/tpu", "/tpu", "/nodes")]
            _wait(lambda: len(running) == 2)
            time.sleep(0.05)
            with lock:
                capped = sorted(running)
            release.set()
            assert all(job.done.wait(5.0) for job in jobs)
        finally:
            pool.close()
        return order, capped, pool.counters(), pool.route_limit

    got = _both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (["interactive", "ops", "debug"], ["/nodes", "/tpu"])


def test_queue_full_and_deadline_answer_the_same_503s():
    def scenario(gw_mod, slo_mod, _reg):
        clock = FakeMono()
        release = threading.Event()

        def handle(path, *, accept=None, gateway_info=None):
            release.wait(10.0)
            return 200, "text/html", "ok"

        gw = make_gateway(gw_mod, slo_mod, handle, workers=1, monotonic=clock,
                          queue_depth={gw_mod.PRIORITY_INTERACTIVE: 1})
        first = threading.Thread(target=lambda: gw.handle("/tpu"))
        try:
            first.start()
            _wait(lambda: gw.pool.inflight() == 1)
            queued = [None]
            t = threading.Thread(target=lambda: queued.__setitem__(0, gw.handle("/nodes")))
            t.start()
            _wait(lambda: gw.pool.queue_depths()["interactive"] == 1)
            full = gw.handle("/tpu/pods")  # depth 1 is taken: rejected at admission
            clock.advance(60.0)  # past the interactive deadline while queued
            release.set()
            t.join(10.0)
            first.join(10.0)  # its counters move after its response
            expired = queued[0]
        finally:
            gw.close()
        return [(r.status, json.loads(r.body), r.headers) for r in (full, expired)], gw.counters()

    got = _both(scenario)
    assert got["port"] == got["jax"]
    (full, expired), counters = got["port"]
    assert full[0] == expired[0] == 503 and full[2] == (("Retry-After", "5"),)
    assert (full[1]["reason"], expired[1]["reason"]) == ("queue_full", "queue_deadline")
    assert counters["shed_queue_full"] == 1 and counters["expired"] == 1


def test_an_identical_burst_costs_one_render_in_both():
    n = 12

    def scenario(gw_mod, slo_mod, _reg):
        calls, started, release = [], threading.Event(), threading.Event()

        def slow_handle(path, *, accept=None, gateway_info=None):
            calls.append(path)
            started.set()
            release.wait(10.0)
            return 200, "text/html", f"render#{len(calls)}"

        gw = make_gateway(gw_mod, slo_mod, slow_handle, generation=lambda: 7, epoch=lambda: 2)
        try:
            results = [None] * n
            threads = [threading.Thread(target=lambda i=i: results.__setitem__(
                i, gw.handle("/tpu/metrics?x=1"))) for i in range(n)]
            for t in threads:
                t.start()
            assert started.wait(5.0)
            _wait(lambda: any(f.followers == n - 1 for f in list(gw.coalescer._flights.values())))
            release.set()
            for t in threads:
                t.join(10.0)
        finally:
            gw.close()
        return sorted({(r.status, r.body, r.headers) for r in results}), len(calls), gw.counters()

    got = _both(scenario)
    assert got["port"] == got["jax"]
    responses, renders, counters = got["port"]
    assert renders == 1 and len(responses) == 1 and responses[0][:2] == (200, "render#1")
    assert dict(responses[0][2])["ETag"].startswith('"g7-e2-d0-w')
    assert counters["rendered"] == 1 and counters["coalesced_followers"] == n - 1


def test_coalesce_keys_for_queries_refresh_ops_and_generations():
    def scenario(gw_mod, slo_mod, _reg):
        generation = [1]
        gw = make_gateway(gw_mod, slo_mod, ok_handle, generation=lambda: generation[0])
        try:
            key = gw._coalesce_key
            out = [
                key("/tpu/nodes?page=1", "/tpu/nodes", False),
                key("/tpu/nodes?page=2", "/tpu/nodes", False),
                key("/tpu/nodes?a=1&b=2", "/tpu/nodes", False)
                == key("/tpu/nodes?b=2&a=1", "/tpu/nodes", False),
                key("/tpu", "/tpu", True),
                key("/refresh?back=/tpu", "/refresh", False),
                key("/metricsz", "/metricsz", False),
                key("/sloz/html", "/sloz/html", False),
                key("/debug/traces", "/debug/traces", False),
            ]
            generation[0] = 2
            out.append(key("/tpu", "/tpu", False))
            out += [gw.classify(r) for r in ("/tpu", "other", "/metricsz", "/sloz", "/debug/x")]
        finally:
            gw.close()
        return out

    got = _both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][0] != got["port"][1] and got["port"][2] is True
    assert got["port"][4:8] == [None] * 4 and got["port"][8][2] == 2


def test_shed_degrade_and_restore_on_the_paging_engine():
    def scenario(gw_mod, slo_mod, _reg):
        eng = _paged_engine(slo_mod)
        seen = []

        def handle(path, *, accept=None, gateway_info=None):
            seen.append((path, gw_mod.degraded_active(), gateway_info["degraded"]))
            return 200, "text/html", "ok"

        gw = make_gateway(gw_mod, slo_mod, handle, engine=lambda: eng, monotonic=eng.clock)
        try:
            shed = gw.handle("/debug/traces")
            paged = [gw.handle(p) for p in ("/tpu", "/tpu/metrics", "/metricsz", "/sloz")]
            eng.clock.advance(25_000.0)  # the windows slide past the storm
            restored = [gw.handle(p) for p in ("/debug/traces", "/tpu")]
        finally:
            gw.close()
        return ((shed.status, json.loads(shed.body), shed.headers),
                [(r.status, r.headers) for r in paged + restored], seen, gw.counters())

    got = _both(scenario)
    assert got["port"] == got["jax"]
    shed, statuses, seen, counters = got["port"]
    assert shed[0] == 503 and shed[2] == (("Retry-After", "5"),)
    assert shed[1]["reason"] == "burn_rate" and shed[1]["burn_state"]["dashboard_render"] == "page"
    assert [s for s, _ in statuses] == [200] * 6
    # /tpu is governed by the paging dashboard_render objective; /tpu/metrics
    # (scrape_paint) and the ops surfaces are not.
    assert dict(statuses[0][1])["X-Headlamp-Stale"] == "1"
    assert dict(statuses[1][1])["X-Headlamp-Stale"] == "0"
    assert ("/tpu", True, True) in seen and ("/tpu/metrics", False, False) in seen
    assert seen[-1] == ("/tpu", False, False)  # restored
    assert counters["shed_burn"] == 1 and counters["degraded_renders"] == 1


def test_the_shed_states_are_cached_for_the_ttl():
    def scenario(gw_mod, slo_mod, _reg):
        eng = _paged_engine(slo_mod)
        events = []
        gw = make_gateway(gw_mod, slo_mod, ok_handle, engine=lambda: eng, monotonic=eng.clock,
                          shed_ttl_s=1.0)
        gw.shed_policy.observers.append(lambda kind, detail: events.append((kind, detail)))
        try:
            gw.handle("/debug/traces")
            evals = [gw.shed_policy.evaluations]
            gw.handle("/debug/traces")  # inside the TTL
            evals.append(gw.shed_policy.evaluations)
            eng.clock.advance(2.0)
            gw.handle("/debug/traces")
            evals.append(gw.shed_policy.evaluations)
            gw.shed_policy.invalidate()
            gw.handle("/metricsz")
            evals.append(gw.shed_policy.evaluations)
        finally:
            gw.close()
        return evals, events

    got = _both(scenario)
    assert got["port"] == got["jax"]
    evals, events = got["port"]
    assert evals == [1, 1, 2, 3]
    assert [k for k, _ in events] == ["paging", "shed", "shed", "shed"]


def test_healthz_answers_while_every_worker_is_busy():
    def scenario(gw_mod, slo_mod, _reg):
        release = threading.Event()

        def handle(path, *, accept=None, gateway_info=None):
            if path != "/healthz":
                release.wait(10.0)
            return 200, "application/json", "{}"

        gw = make_gateway(gw_mod, slo_mod, handle, workers=1,
                          queue_depth={gw_mod.PRIORITY_INTERACTIVE: 1})
        try:
            threading.Thread(target=lambda: gw.handle("/tpu"), daemon=True).start()
            _wait(lambda: gw.pool.inflight() == 1)
            threading.Thread(target=lambda: gw.handle("/nodes"), daemon=True).start()
            _wait(lambda: gw.pool.queue_depths()["interactive"] == 1)
            t0 = time.monotonic()
            resp = gw.handle("/healthz")
            fast = time.monotonic() - t0 < 2.0
        finally:
            release.set()
            gw.close()
        return resp, fast, gw.bypassed

    got = _both(scenario)
    assert got["port"] == got["jax"] == ((200, "application/json", "{}", ()), True, 1)


def test_304_and_shed_count_once_and_followers_observe_their_wait():
    """The exactly-once rule: a shed 503 and a 304 move requests_total by
    one and the duration histogram by none; a coalesced follower moves
    both by one (the leader's render is observed by the handler)."""

    def scenario(gw_mod, slo_mod, registry):
        total = registry.counter(slo_mod.REQUESTS_TOTAL, "", labels=("route", "status"))
        hist = registry.histogram(slo_mod.REQUEST_DURATION, "", labels=("route",))

        def moved(fn, route, status):
            before = (total.value_for(route=route, status=status), hist.count_for(route=route))
            out = fn()
            return out, (total.value_for(route=route, status=status) - before[0],
                         hist.count_for(route=route) - before[1])

        eng = _paged_engine(slo_mod)
        gw = make_gateway(gw_mod, slo_mod, ok_handle, engine=lambda: eng, monotonic=eng.clock,
                          generation=lambda: 3)
        started, release = threading.Event(), threading.Event()

        def slow(path, *, accept=None, gateway_info=None):
            started.set()
            release.wait(10.0)
            return 200, "text/html", "x"

        gw2 = make_gateway(gw_mod, slo_mod, slow)
        try:
            shed, shed_moved = moved(lambda: gw.handle("/debug/traces"), "/debug/traces", "503")
            etag = dict(gw.handle("/tpu/nodes?page=2").headers)["ETag"]
            nm, nm_moved = moved(lambda: gw.handle("/tpu/nodes?page=2", if_none_match=f"W/{etag}"),
                                 "/tpu/nodes", "304")
            leader = threading.Thread(target=lambda: gw2.handle("/tpu/pods"))
            leader.start()
            assert started.wait(5.0)
            box = [None]

            def follow():
                box[0] = moved(lambda: gw2.handle("/tpu/pods"), "/tpu/pods", "200")

            follower = threading.Thread(target=follow)
            follower.start()
            _wait(lambda: any(f.followers == 1 for f in list(gw2.coalescer._flights.values())))
            release.set()
            leader.join(10.0)
            follower.join(10.0)
        finally:
            gw.close()
            gw2.close()
        return (shed.status, shed_moved, nm.status, nm.body, nm.headers, nm_moved,
                box[0][0].status, box[0][1], gw.not_modified)

    got = _both(scenario)
    assert got["port"] == got["jax"]
    shed, shed_moved, nm, body, headers, nm_moved, follower, f_moved, not_modified = got["port"]
    assert (shed, shed_moved) == (503, (1, 0))
    assert (nm, body, nm_moved, not_modified) == (304, "", (1, 0), 1)
    assert dict(headers)["X-Headlamp-Generation"] == "3"
    assert (follower, f_moved) == (200, (1, 1))


def test_counters_snapshot_and_gateway_info_keys_are_equal():
    def scenario(gw_mod, slo_mod, _reg):
        infos = []

        def handle(path, *, accept=None, gateway_info=None):
            infos.append(sorted(gateway_info))
            if path.endswith("/boom"):
                raise RuntimeError("plumbing")
            return 200, "text/html", "ok"

        gw = make_gateway(gw_mod, slo_mod, handle)
        try:
            gw.handle("/tpu")
            failed = gw.handle("/tpu/boom")
            snap = gw.snapshot()
        finally:
            gw.close()
        snap_keys = sorted(snap)
        return (infos, (failed.status, failed.body), gw.counters(), snap_keys,
                snap["queue_depth"], snap["workers"], sorted(snap["burn_state"]))

    got = _both(scenario)
    assert got["port"] == got["jax"]
    infos, failed, counters, keys, depths, workers, objectives = got["port"]
    assert infos == [["degraded", "priority", "queue_wait_ms"]] * 2
    assert failed == (503, "gateway error: RuntimeError")
    assert counters["rendered"] == 1 and counters["pool_failed"] == 1
    assert depths == {"interactive": 0, "ops": 0, "debug": 0} and workers == 2
    assert "transport_connect" in objectives


def test_the_ports_gateway_families_and_worker_threads_are_its_own():
    gw = make_gateway(tgw, tslo, ok_handle, workers=3)
    tgw.set_active(gw)
    try:
        names = [t.name for t in gw.pool._threads]
        assert gw.handle("/tpu").status == 200
        text = tmetrics.registry.render()
    finally:
        assert gw.close() is True
        tgw.set_active(None)
    assert names == ["hl-torch-render-0", "hl-torch-render-1", "hl-torch-render-2"]
    assert not any(t.is_alive() for t in gw.pool._threads)
    for family in ("requests_total", "shed_total", "queue_wait_seconds", "queue_depth_count",
                   "inflight_renders_count"):
        assert f"# TYPE headlamp_tpu_torch_gateway_{family} " in text
    assert 'headlamp_tpu_torch_gateway_queue_depth_count{priority="interactive"} 0' in text
    assert 'headlamp_tpu_torch_gateway_requests_total{priority="interactive",outcome="rendered"}' in text


def test_a_worker_context_wraps_every_render():
    entered = []

    class Pin:
        def __enter__(self):
            entered.append(threading.current_thread().name)

        def __exit__(self, *exc):
            entered.append("exit")

    seen = []

    def handle(path, *, accept=None, gateway_info=None):
        seen.append(threading.current_thread().name)
        return 200, "text/html", "ok"

    gw = make_gateway(tgw, tslo, handle, workers=2, worker_context=Pin)
    try:
        assert gw.handle("/tpu").status == 200
    finally:
        assert gw.close()
    assert sorted(entered) == ["exit", "exit", "hl-torch-render-0", "hl-torch-render-1"]
    assert seen[0].startswith("hl-torch-render-")

"""The port's SSE broadcast hub against the JAX package's, on the CPU.

One scripted session runs on an injected monotonic clock against each
package's hub: subscribe, publish, poll, heartbeats, a slow consumer
evicted at the outbox limit, resume inside and past the backlog, an
unparseable ``Last-Event-ID``, debug streams shed on a paging check, and
close. The SSE wire text of every event, the counters and the snapshot
must be byte-equal. Everything is exact.
"""

import json

import pytest

from headlamp_tpu.push import hub as jhub
from headlamp_tpu_torch.push import hub as thub


def _frames(gen, pages):
    return {p: {"page": p, "cells": {"n": gen}, "rows": {f"r{gen}": [gen, 0.5]},
                "removed": [], "generation": gen} for p in pages}


def _session(module):
    """The scripted session; returns its transcript."""
    now = [100.0]
    paging = [False]
    hub = module.BroadcastHub(
        monotonic=lambda: now[0], heartbeat_s=15.0, outbox_limit=4, backlog_limit=3,
        shed_check=lambda: paging[0],
    )
    out = []

    def drain(name, sub):
        while True:
            event = hub.poll(sub)
            if event is None:
                return
            out.append((name, module.format_event(event)))

    # A resume against a fresh hub, which retains no backlog, repaints.
    fresh = hub.subscribe(["/tpu"], last_event_id="g5")
    drain("fresh", fresh)
    hub.unsubscribe(fresh)
    wall = hub.subscribe(["/tpu", "/tpu/nodes"])
    debug = hub.subscribe(["/tpu/nodes"], priority="debug")
    slow = hub.subscribe(list(module_pages()))
    out.append(("publish-empty", hub.publish(1, {})))
    for gen in (2, 3, 4, 5, 6):
        out.append(("publish", hub.publish(gen, _frames(gen, ["/tpu", "/tpu/nodes"]))))
        drain("wall", wall)
        drain("debug", debug)
    now[0] += 15.0
    drain("wall-hb", wall)
    now[0] += 5.0
    drain("wall-quiet", wall)
    # The slow consumer never read: past the limit of 4 queued deltas its
    # outbox became one bye.
    for gen in (7, 8):
        out.append(("publish", hub.publish(gen, _frames(gen, ["/tpu/metrics"]))))
    drain("slow", slow)
    # Resume inside the backlog (3 generations per page, so replay is
    # complete from g4 on) and past it.
    inside = hub.subscribe(["/tpu", "/tpu/metrics"], last_event_id="g5")
    drain("inside", inside)
    past = hub.subscribe(["/tpu", "/tpu/metrics"], last_event_id="g2")
    drain("past", past)
    caught_up = hub.subscribe(["/tpu"], last_event_id="g8")
    drain("caught-up", caught_up)
    garbled = hub.subscribe(["/tpu"], last_event_id="x9")
    drain("garbled", garbled)
    # Paging: the debug stream is shed, the interactive ones stay.
    paging[0] = True
    out.append(("shed", hub.shed_streams()))
    drain("debug", debug)
    out.append(("publish", hub.publish(9, _frames(9, ["/tpu/nodes"]))))
    drain("wall", wall)
    paging[0] = False
    snapshot_open = hub.snapshot()
    hub.close()
    drain("wall-close", wall)
    drain("inside-close", inside)
    out.append(("next_event", hub.next_event(wall, max_wait_s=0.0)))
    out.append(("counters", hub.counters()))
    out.append(("snapshot-open", snapshot_open))
    out.append(("snapshot", hub.snapshot()))
    out.append(("connected", hub.connected()))
    return out


def module_pages():
    return ("/tpu", "/tpu/nodes", "/tpu/pods", "/tpu/metrics")


def test_scripted_session_equals_jax_byte_for_byte():
    got, want = _session(thub), _session(jhub)
    assert json.dumps(got) == json.dumps(want)
    kinds = [text.split("\n")[1] if text.startswith("id") else text.split("\n")[0]
             for _, text in (e for e in got if isinstance(e[1], str))]
    assert ": hb" in kinds and "event: paint" in kinds and "event: bye" in kinds
    counters = dict(got)["counters"]
    assert counters["evictions"] == 7 and counters["resume_fallbacks"] == 2
    assert counters["heartbeats"] == 1 and counters["broadcasts"] == 8
    assert ("slow", 'event: bye\ndata: {"reason":"slow_consumer"}\n\n') in got
    assert ("debug", 'event: bye\ndata: {"reason":"shed"}\n\n') in got
    assert ("wall-close", 'event: bye\ndata: {"reason":"shutdown"}\n\n') in got


def test_limits_and_wire_format_equal_jax():
    assert (thub.HEARTBEAT_S, thub.OUTBOX_LIMIT, thub.BACKLOG_LIMIT) == (
        jhub.HEARTBEAT_S, jhub.OUTBOX_LIMIT, jhub.BACKLOG_LIMIT) == (15.0, 64, 32)
    for value in (None, "", "g12", " g7 ", "g3-w1", "gx", "12", "g"):
        assert thub.parse_last_event_id(value) == jhub.parse_last_event_id(value)
    for event in (
        {"kind": "heartbeat", "id": None, "data": {}},
        {"kind": "delta", "id": "g4", "data": {"page": "/tpu", "b": [1.5, None, True], "a": "é"}},
        {"kind": "bye", "id": None, "data": {"reason": "shed"}},
    ):
        assert thub.format_event(event) == jhub.format_event(event)


@pytest.mark.parametrize("label", [None, "w3"])
def test_worker_identity_stamps_the_snapshot_as_jax_does(label):
    try:
        for module in (thub, jhub):
            module.set_worker_identity(label)
        hubs = [module.BroadcastHub(monotonic=lambda: 0.0) for module in (thub, jhub)]
        assert hubs[0].snapshot() == hubs[1].snapshot()
        assert thub.worker_identity() == label
        assert ("worker" in hubs[0].snapshot()) == (label is not None)
    finally:
        thub.set_worker_identity(None)
        jhub.set_worker_identity(None)


def test_eviction_observers_see_every_bye_and_a_closed_hub_evicts_late_subscribers():
    hub = thub.BroadcastHub(monotonic=lambda: 0.0, outbox_limit=1)
    seen = []
    hub.eviction_observers.append(lambda reason, detail: seen.append((reason, detail)))
    hub.eviction_observers.append(lambda reason, detail: 1 / 0)
    sub = hub.subscribe(["/tpu"], priority="debug")
    hub.publish(1, _frames(1, ["/tpu"]))
    hub.publish(2, _frames(2, ["/tpu"]))
    assert seen == [("slow_consumer", {"priority": "debug", "pages": ["/tpu"]})]
    assert hub.observer_errors == 1 and hub.poll(sub)["kind"] == "bye"
    # Unlike JAX's hub, a closed one evicts a subscriber that arrives
    # later at once, so a server's close never waits on it.
    hub.close()
    late = hub.subscribe(["/tpu"])
    assert hub.poll(late) == {"kind": "bye", "id": None, "data": {"reason": "shutdown"}}
    assert late.evicted_reason == "shutdown" and hub.next_event(late, max_wait_s=0.0) is None

"""The port's list+watch protocol against the JAX package's, on the CPU.

``WatchFeed`` answers the same LISTs and watch deltas as JAX's after the
same pushes and compactions. A port context and a JAX context (both
providers), each on its own package's fixture transport, are driven
through one event script with watch on: steady-state deltas, MODIFIED in
place, DELETED, BOOKMARK, 410 Gone, a non-410 ERROR event and a failing
watch. After every sync each track's LIST and watch requests, the
imperative requests, ``watch_stats``, the snapshot version and the
store's object order are equal. The node track runs on a worker thread,
and the providers' chains run concurrently, so requests are compared per
track and per provider, never as one merged list. Then the
clean tick (same snapshot, no upload), an error transition, and the
``<main>`` bytes of ``/tpu``, ``/tpu/nodes`` and ``/tpu/fleet`` after a
MODIFIED node and an ADDED pod against the JAX host's.
"""

import copy
import re
import threading
from urllib.parse import parse_qs, urlparse

import pytest
import torch

from headlamp_tpu.context import AcceleratorDataContext as JaxContext
from headlamp_tpu.fleet import fixtures as jfx
from headlamp_tpu.runtime import device_cache as jax_device_cache
from headlamp_tpu.server import DashboardApp as JaxApp
from headlamp_tpu.transport import ApiError as JaxApiError
from headlamp_tpu.transport import MockTransport as JaxMock
from headlamp_tpu.transport import WatchFeed as JaxFeed
from headlamp_tpu_torch.context import INTEL_SOURCE, TPU_SOURCE, AcceleratorDataContext
from headlamp_tpu_torch.domain import objects as obj
from headlamp_tpu_torch.fleet import fixtures as tfx
from headlamp_tpu_torch.server import DashboardApp
from headlamp_tpu_torch.transport import ApiError, MockTransport, WatchFeed

torch.set_num_threads(1)

CLOCK = 1785283200.0
NODES, PODS = "/api/v1/nodes", "/api/v1/pods"


def clock():
    return CLOCK


def _item(i):
    return {"kind": "Node", "metadata": {"uid": f"u{i}", "name": f"n{i}"}}


def test_watch_feed_answers_as_jax_does():
    feeds = (WatchFeed([_item(i) for i in range(5)], 100), JaxFeed([_item(i) for i in range(5)], 100))

    def answers(feed):
        out = [feed.list_response("/api/v1/nodes"), feed.list_response("/api/v1/nodes?limit=2"),
               feed.list_response("/api/v1/nodes?limit=2&continue=4")]
        feed.push("ADDED", _item(9))
        feed.push("MODIFIED", {**_item(1), "spec": {"x": 1}})
        feed.push("DELETED", _item(2))
        feed.push("BOOKMARK", {"kind": "Bookmark", "metadata": {}})
        out += [feed.events_since(rv) for rv in ("100", "102", "104", "nope")]
        out.append(feed.list_response("/api/v1/nodes?limit=10"))
        feed.compact()
        out += [feed.events_since("103"), feed.events_since(str(feed.resource_version))]
        feed.push("ADDED", _item(7))
        out += [feed.events_since("104"), feed.list_response("/api/v1/nodes")]
        return out

    got, want = (answers(f) for f in feeds)
    assert got == want
    assert got[3][0]["object"]["metadata"]["resourceVersion"] == "101"
    assert got[-4][0]["object"]["code"] == 410 and got[-3] == []


def test_mock_routing_matches_jax():
    # Overrides win over lists; a query-less override breaks the list at
    # any pagination but not a selector sub-query; watch requests match
    # an override by prefix; a path without a feed 404s its watch.
    def drive(t, error):
        t.add_watchable_list(NODES, [_item(i) for i in range(3)])
        t.add_list(PODS, [])
        t.add(PODS + "?labelSelector=a%3Db", {"kind": "List", "items": [_item(0)]})
        out = [t.request(NODES + "?limit=2"), t.watch(NODES + "?watch=true&resourceVersion=1000")]
        t.add_override(PODS, error(PODS, "down", status=503))
        t.add_override(NODES + "?watch=true", error(NODES, "watch down", status=500))
        for call, path in ((t.request, PODS + "?limit=500"), (t.request, PODS + "?labelSelector=a%3Db"),
                           (t.watch, NODES + "?watch=true&resourceVersion=1000"),
                           (t.request, NODES + "?limit=500"), (t.watch, PODS + "?watch=true"),
                           (t.request, "/apis/none")):
            try:
                out.append(call(path))
            except Exception as e:  # noqa: BLE001 — the error is the answer compared
                out.append((type(e).__name__, getattr(e, "status", None), str(e)))
        return out, t.calls, t.watch_calls

    assert drive(MockTransport(), ApiError) == drive(JaxMock(), JaxApiError)


def _once(response, feed):
    """A watch route that answers ``response`` once (an error event list,
    or an exception to raise), then the feed's deltas."""
    state = {"fired": False}

    def respond(path):
        if not state["fired"]:
            state["fired"] = True
            if isinstance(response, Exception):
                raise response
            return response
        return feed.events_since(parse_qs(urlparse(path).query)["resourceVersion"][0])

    return respond


def _contexts(fleet_name, *, watch):
    make = {"v5p32": ("fleet_v5p32", ()), "viewport": ("fleet_viewport", (256,))}[fleet_name]
    jt = jfx.fleet_transport(getattr(jfx, make[0])(*make[1]))
    tt = tfx.fleet_transport(getattr(tfx, make[0])(*make[1]))
    jctx = JaxContext(jt, clock=clock, watch=watch)
    tctx = AcceleratorDataContext(tt, device="cpu", clock=clock, watch=watch)
    return (jctx, jt), (tctx, tt)


def _state(ctx, t, snap):
    def track(calls, path):
        return [c for c in calls if c.startswith(path + "?") and "labelSelector" not in c]

    state = snap.provider("tpu")
    return {
        "lists": {p: track(t.calls, p) for p in (NODES, PODS)},
        "watches": {p: track(t.watch_calls, p) for p in (NODES, PODS)},
        "imperative": {
            source.provider_name: [
                c for c in t.calls
                if not c.startswith((NODES + "?", PODS + "?"))
                and c in source.workload_paths + source.plugin_pod_paths
            ]
            for source in (TPU_SOURCE, INTEL_SOURCE)
        },
        "other": sorted(
            c for c in t.calls
            if not c.startswith((NODES + "?", PODS + "?"))
            and c not in TPU_SOURCE.workload_paths + TPU_SOURCE.plugin_pod_paths
            + INTEL_SOURCE.workload_paths + INTEL_SOURCE.plugin_pod_paths
        ),
        "watch_stats": ctx.watch_stats,
        "version": state.view.version,
        "errors": snap.errors,
        "all_nodes": [obj.name(n) for n in snap.all_nodes],
        "all_pods": [(obj.namespace(p), obj.name(p)) for p in snap.all_pods],
        "tpu_pods": [obj.name(p) for p in state.pods],
    }


def _events(fleet):
    """The script's objects, built from one package's fleet (the two
    packages' fixtures are equal)."""
    nodes, pods = fleet["nodes"], fleet["pods"]
    modified = copy.deepcopy(nodes[1])
    modified["metadata"]["labels"]["example.com/marker"] = "yes"
    modified["status"]["conditions"] = [{"type": "Ready", "status": "False"}]
    added = tfx.make_tpu_pod("late-train-0", node=obj.name(nodes[2]), chips=4)
    return {
        "node_mod": modified,
        "node_del": copy.deepcopy(nodes[3]),
        "pod_add": added,
        "pod_del": copy.deepcopy(pods[0]),
        "pod_mod": {**copy.deepcopy(pods[1]), "status": {"phase": "Failed"}},
        "late_node": tfx.make_tpu_node("late-node-0", pool="late", topology="2x2"),
    }


@pytest.mark.parametrize("fleet_name", ["v5p32", "viewport"])
def test_event_script_matches_jax_per_track(fleet_name):
    (jctx, jt), (tctx, tt) = _contexts(fleet_name, watch=True)
    ev = _events(tfx.fleet_v5p32() if fleet_name == "v5p32" else tfx.fleet_viewport(256))
    script = [
        [],  # the LIST that arms both cursors
        [],  # a quiet watch on each track
        [("nodes", "MODIFIED", ev["node_mod"]), ("pods", "ADDED", ev["pod_add"])],
        [("nodes", "DELETED", ev["node_del"]), ("pods", "MODIFIED", ev["pod_mod"]),
         ("pods", "DELETED", ev["pod_del"]), ("nodes", "BOOKMARK", {"kind": "Bookmark", "metadata": {}})],
        [("nodes", "ADDED", ev["late_node"]), ("nodes", "compact", None)],  # 410 -> re-list
        [("pods", "error-event", None)],  # a non-410 ERROR event -> re-list
        [("nodes", "raise", None), ("pods", "ADDED", ev["pod_del"])],  # a failing watch -> re-list
        [],  # watching again on both re-armed cursors
    ]
    for step, actions in enumerate(script):
        for t, err in ((jt, JaxApiError), (tt, ApiError)):
            for track, kind, payload in actions:
                feed = t.node_feed if track == "nodes" else t.pod_feed
                path = (NODES if track == "nodes" else PODS) + "?watch=true"
                if kind == "compact":
                    feed.compact()
                elif kind == "error-event":
                    t.add_override(path, _once([{"type": "ERROR", "object": {"code": 500}}], feed))
                elif kind == "raise":
                    t.add_override(path, _once(err(path, "stream reset"), feed))
                else:
                    feed.push(kind, copy.deepcopy(payload))
        got = _state(tctx, tt, tctx.sync())
        want = _state(jctx, jt, jctx.sync())
        assert got == want, f"step {step}"
    stats = tctx.watch_stats
    assert stats["nodes"] == {"relists": 3, "watches": 5, "events": 2}
    assert stats["pods"] == {"relists": 2, "watches": 6, "events": 4}
    assert got["version"] == 6  # the quiet tick and the last watch built none
    tctx.close()
    jctx.close()


def test_watch_is_off_by_default_and_needs_a_cursor():
    (jctx, jt), (tctx, tt) = _contexts("v5p32", watch=False)
    for _ in range(2):
        assert _state(tctx, tt, tctx.sync()) == _state(jctx, jt, jctx.sync())
    assert tt.watch_calls == [] and tctx.watch_stats["nodes"]["relists"] == 2
    tctx.enable_watch()
    jctx.enable_watch()
    assert _state(tctx, tt, tctx.sync()) == _state(jctx, jt, jctx.sync())
    assert tctx.watch_stats["nodes"] == {"relists": 2, "watches": 1, "events": 0}
    # Plain lists carry no resourceVersion: the cursor never arms, so a
    # transport without feeds costs a re-list per sync and no error.
    t = MockTransport()
    fleet = tfx.fleet_v5e4()
    t.add_list(NODES, fleet["nodes"])
    t.add_list(PODS, fleet["pods"])
    with AcceleratorDataContext(t, device="cpu", watch=True) as ctx:
        ctx.sync()
        assert ctx.sync().error is None
        assert t.watch_calls == [] and ctx.watch_stats["pods"]["relists"] == 2
    assert ctx._reactive_pool is None


def test_quiet_tick_keeps_the_snapshot_and_its_device_columns():
    tt = tfx.fleet_transport(tfx.fleet_viewport(256))
    mono = [1000.0]
    ctx = AcceleratorDataContext(tt, device="cpu", watch=True, clock=lambda: mono[0])
    snap1 = ctx.sync()
    stats1 = snap1.provider("tpu").fleet_stats()
    uploads = ctx.fleet_cache.counters()["uploads"]
    assert uploads == 1
    mono[0] += 5
    snap2 = ctx.sync()
    assert snap2.providers is snap1.providers and snap2.fetched_at == 1005.0
    assert snap2.provider("tpu").fleet_stats() is stats1
    assert ctx.fleet_cache.fleet_for(snap2.provider("tpu").view) is not None
    assert ctx.fleet_cache.counters()["uploads"] == uploads  # a hit, no upload
    # An event dirties the tick: a new version, its stats and its upload.
    node = copy.deepcopy(snap1.provider("tpu").nodes[0])
    node["status"]["conditions"] = [{"type": "Ready", "status": "False"}]
    tt.node_feed.push("MODIFIED", node)
    snap3 = ctx.sync()
    assert snap3.provider("tpu").view.version == snap1.provider("tpu").view.version + 1
    assert snap3.provider("tpu").fleet_stats()["nodes_ready"] == stats1["nodes_ready"] - 1
    assert ctx.fleet_cache.counters()["uploads"] == uploads + 1
    ctx.close()


def test_error_transition_dirties_the_tick():
    (jctx, jt), (tctx, tt) = _contexts("v5p32", watch=True)
    t_first, j_first = tctx.sync(), jctx.sync()
    # Watch and list both fail: the error stream flips, so the snapshot
    # rebuilds to carry it; recovery flips it back.
    tt.add_override(NODES, ApiError("nodes", "down"))
    jt.add_override(NODES, JaxApiError("nodes", "down"))
    t_down, j_down = tctx.sync(), jctx.sync()
    assert t_down.providers is not t_first.providers
    assert t_down.errors == j_down.errors == ["nodes: nodes: down"]
    assert _state(tctx, tt, t_down) == _state(jctx, jt, j_down)
    assert t_down.all_nodes == t_first.all_nodes  # the previous list stays
    tctx.close()


def _main(body):
    return re.search(r"<main>(.*)</main>", body, re.S).group(1)


def test_pages_after_watch_events_match_the_jax_host():
    port = DashboardApp(tfx.fleet_transport(tfx.fleet_viewport(256)), device="cpu",
                        clock=clock, min_sync_interval_s=0.0)
    jax = JaxApp(jfx.fleet_transport(jfx.fleet_viewport(256)), clock=clock,
                 min_sync_interval_s=0.0, fragments=False)
    for app in (port, jax):
        app._ctx.enable_watch()
    ev = _events(tfx.fleet_viewport(256))
    paths = ("/tpu", "/tpu/nodes?limit=10", "/tpu/fleet", "/tpu/fleet?region=cluster/2")
    jax_device_cache.fleet_cache.invalidate()
    before = {p: (port.handle(p), jax.handle(p)) for p in paths}
    for app in (port, jax):
        t = app._transport
        t.node_feed.push("MODIFIED", copy.deepcopy(ev["node_mod"]))
        t.pod_feed.push("ADDED", copy.deepcopy(ev["pod_add"]))
    for path in paths:
        jax_device_cache.fleet_cache.invalidate()
        (ts, _, tbody), (js, _, jbody) = port.handle(path), jax.handle(path)
        assert ts == js == 200 and _main(tbody) == _main(jbody), path
        assert _main(tbody) != _main(before[path][0][2]) or path.endswith("cluster/2"), path
    assert port._ctx.watch_stats["nodes"]["events"] == 1
    assert port._ctx.watch_stats["pods"]["relists"] == 1
    port.close()
    assert not [t for t in threading.enumerate() if t.name.startswith("hl-torch")]

"""The port's record and replay (``headlamp_tpu_torch/history/record.py``)
against the JAX package's ``headlamp_tpu/history/record.py``.

The ``headlamp-tpu-recording`` v1 format is byte for byte the same: one
script of exchanges recorded through each package's
``RecordingTransport`` on the same scripted clocks writes identical
bytes, and each package loads the other's artifact. Two sequential
replays of a recorded demo run through the port's ``DashboardApp`` paint
byte-identical ``<main>`` markup, equal to the live run's. The timed mode
picks the same exchanges as JAX's ``ReplaySource`` on one scripted clock
at ``rate=3.0``, and a recorded error replays as the port's ``ApiError``.
"""

import io
import json
import re

import pytest

from headlamp_tpu.history import record as jrec
from headlamp_tpu.transport import ApiError as JaxApiError
from headlamp_tpu.transport import MockTransport as JaxMockTransport
from headlamp_tpu_torch.history import record as trec
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport
from headlamp_tpu_torch.transport.api_proxy import ApiError, MockTransport

#: The demo pages a replayed host paints: each a function of the synced
#: snapshot alone, on the fixed clock.
PAGES = ("/tpu", "/tpu/nodes", "/tpu/pods", "/tpu/deviceplugins", "/tpu/fleet", "/tpu/topology",
         "/nodes")
WALL0 = 1_700_000_000.0


class Clock:
    """Scripted monotonic or wall clock: moves only when told."""

    def __init__(self, now=0.0):
        self.now = now

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def _script(mock_cls, error_cls):
    transport = mock_cls()
    transport.add("/api/v1/nodes", {"kind": "NodeList", "items": [{"metadata": {"name": "n-0"}}]})
    transport.add("/ok", {"value": [1, 2.5, "x", None, {"nested": True}]})
    transport.add("/down", error_cls("/down", "boom: upstream", 503))
    return transport


def _record(module, mock_cls, error_cls, api_error):
    mono, sink = Clock(100.0), io.StringIO()
    recorder = module.Recorder(sink, monotonic=mono, wall=lambda: WALL0, note="parity")
    transport = module.RecordingTransport(_script(mock_cls, error_cls), recorder)
    for path, dt in (("/api/v1/nodes", 1.5), ("/ok", 0.25), ("/down", 2.0), ("/ok", 0.125),
                     ("/missing", 1.0), ("/api/v1/nodes", 0.0)):
        try:
            transport.request(path)
        except api_error:
            pass
        mono.advance(dt)
    return sink.getvalue(), recorder.exchanges


def test_recordings_are_byte_identical_and_load_in_both_packages(tmp_path):
    jax_text, jax_n = _record(jrec, JaxMockTransport, JaxApiError, JaxApiError)
    port_text, port_n = _record(trec, MockTransport, ApiError, ApiError)
    assert port_text == jax_text and port_n == jax_n == 6
    (tmp_path / "jax.jsonl").write_text(jax_text, encoding="utf-8")
    (tmp_path / "port.jsonl").write_text(port_text, encoding="utf-8")
    from_jax = trec.load_recording(str(tmp_path / "jax.jsonl"))
    from_port = jrec.load_recording(str(tmp_path / "port.jsonl"))
    assert (from_jax.version, from_jax.recorded_unix, from_jax.note) == (1, WALL0, "parity")
    assert [(e.t_rel, e.path, e.response, e.error) for e in from_jax.exchanges] == [
        (e.t_rel, e.path, e.response, e.error) for e in from_port.exchanges]
    assert from_jax.paths() == from_port.paths() == ["/api/v1/nodes", "/ok", "/down", "/missing"]
    assert from_jax.span_s == from_port.span_s == 4.875
    assert from_jax.exchanges[2].error == ("boom: upstream", 503)
    assert from_jax.exchanges[4].error[1] == 404  # the unrouted path, recorded as an error


def test_version_gate_and_foreign_files_are_refused(tmp_path):
    text, _ = _record(trec, MockTransport, ApiError, ApiError)
    future = tmp_path / "future.jsonl"
    future.write_text(text.replace('"v": 1', '"v": 2', 1), encoding="utf-8")
    with pytest.raises(ValueError, match="version 2 not supported"):
        trec.load_recording(str(future))
    junk = tmp_path / "junk.jsonl"
    junk.write_text('{"kind": "something-else"}\n', encoding="utf-8")
    with pytest.raises(ValueError, match="not a headlamp-tpu-recording artifact"):
        trec.load_recording(str(junk))
    empty = tmp_path / "empty.jsonl"
    empty.write_text("", encoding="utf-8")
    with pytest.raises(ValueError, match="empty recording"):
        trec.load_recording(str(empty))


def test_recorded_error_replays_as_the_ports_api_error(tmp_path):
    text, _ = _record(trec, MockTransport, ApiError, ApiError)
    (tmp_path / "r.jsonl").write_text(text, encoding="utf-8")
    port = trec.ReplaySource(trec.load_recording(str(tmp_path / "r.jsonl")))
    jax = jrec.ReplaySource(jrec.load_recording(str(tmp_path / "r.jsonl")))
    with pytest.raises(JaxApiError) as want:
        jax.request("/down")
    with pytest.raises(ApiError) as got:
        port.request("/down")
    assert type(got.value) is ApiError
    assert (str(got.value), got.value.status, got.value.path) == (
        str(want.value), want.value.status, want.value.path) == ("/down: boom: upstream", 503, "/down")
    with pytest.raises(ApiError) as unknown:
        port.request("/never-recorded")
    assert unknown.value.status == 404 and port.requests_unknown == 1
    first = port.request("/ok")
    first["value"].append("mutated")  # replayed responses are copies
    assert port.request("/ok") == {"value": [1, 2.5, "x", None, {"nested": True}]}


def test_timed_mode_picks_the_same_exchanges_as_jax_at_rate_3():
    lines = [{"kind": "header", "v": 1, "format": "headlamp-tpu-recording",
              "recorded_unix": 0.0, "note": ""}]
    for i, t in enumerate((0.0, 6.0, 12.0, 30.0, 31.5, 90.0)):
        lines.append({"kind": "request", "t": t, "path": "/a", "status": "ok", "response": {"gen": i}})
    for i, t in enumerate((3.0, 45.0)):
        lines.append({"kind": "request", "t": t, "path": "/b", "status": "ok", "response": {"b": i}})
    text = "\n".join(json.dumps(line) for line in lines) + "\n"
    picks = {}
    for name, module in (("jax", jrec), ("port", trec)):
        clock = Clock(500.0)
        source = module.ReplaySource(module._parse_recording(io.StringIO(text)), clock=clock,
                                     rate=3.0)
        got = []
        for dt, path in ((0.0, "/a"), (1.0, "/b"), (1.0, "/a"), (2.0, "/a"), (6.0, "/a"),
                         (4.0, "/b"), (0.5, "/a"), (20.0, "/a"), (100.0, "/b")):
            clock.advance(dt)
            got.append(source.request(path))
        picks[name] = (got, source.requests_served)
    assert picks["port"] == picks["jax"]
    assert [r.get("gen", r.get("b")) for r in picks["port"][0]] == [0, 0, 1, 2, 3, 0, 4, 5, 1]
    with pytest.raises(ValueError, match="rate must be > 0"):
        trec.ReplaySource(trec.Recording(1, 0.0, ""), rate=0.0)


def _main(body):
    return re.search(r"<main>(.*)</main>", body, re.S).group(1)


def _paint(transport, mono, wall):
    app = DashboardApp(transport, device="cpu", min_sync_interval_s=0.0, clock=wall,
                       monotonic=mono)
    try:
        pages = {}
        for path in PAGES:
            status, _, body = app.handle(path)
            assert status == 200, (path, status)
            pages[path] = _main(body)
            mono.advance(61.0)
            wall.advance(61.0)
        return pages
    finally:
        app.close()


def test_two_sequential_replays_paint_the_live_runs_bytes(tmp_path):
    path = tmp_path / "demo.jsonl"
    with open(path, "w", encoding="utf-8") as sink:
        mono, wall = Clock(1000.0), Clock(WALL0)
        recorder = trec.Recorder(sink, monotonic=mono, wall=wall, note="demo")
        live = _paint(trec.RecordingTransport(make_demo_transport("v5p32"), recorder), mono, wall)
    recording = trec.load_recording(str(path))
    assert recorder.exchanges == len(recording.exchanges) > 0
    replays = []
    for _ in range(2):
        source = trec.ReplaySource(recording)
        replays.append(_paint(source, Clock(1000.0), Clock(WALL0)))
        assert source.requests_unknown == 0 and source.requests_served == recorder.exchanges
    assert replays[0] == replays[1] == live
    assert "Chip Allocation" in live["/tpu"]

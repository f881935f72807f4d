"""The repo's gates held over the port, through the analysis engine with
each rule's scope pointed at ``headlamp_tpu_torch`` (the rules' own
scopes name only the JAX package, and ``tools/`` stays as it is):

- the injected-clock gate (``WCK001``, ``tools/analysis/rules/wall_clock.py``):
  every TTL, age, burn, retention, sampling, queue-wait and idle-eviction
  decision in the port's ``obs``, ``history``, ``runtime``, ``transport``,
  ``gateway``, ``push``, ``replicate``, ``workers`` and ``scenarios`` runs on
  an injected clock (JAX's own scope names all nine);
- no raw ``urlopen`` outside ``transport/`` (``URL001``): every HTTP call
  goes through the keep-alive pool;
- no direct render outside the gateway (``RND001``): nothing but the
  gateway, the pages, the UI, the host's wiring and the scenario runner
  (an admission layer itself: ``policy.decide`` → ``degraded_scope`` →
  ``handle`` without the gateway's thread hop, as JAX's rule exempts its
  runner) calls ``.handle()`` or a page renderer;
- exactly-once SLO observation in the gateway (``OBS001``): no outcome
  path observes the request-duration histogram twice, and the shed,
  304 and 5xx paths never do;
- one ``traceparent`` writer (``TRC001``): only ``transport/pool.py``
  builds the outbound header; the host, the gateway and the bus serve
  only read it.

Each finds nothing in the port; a scratch tree with one violation shows
each scoped rule is live.
"""

from __future__ import annotations

import os

from tools.analysis.engine import Engine
from tools.analysis.rules.direct_render import DirectRenderRule
from tools.analysis.rules.raw_urlopen import RawUrlopenRule
from tools.analysis.rules.slo_observation import SloObservationRule
from tools.analysis.rules.trace_propagation import TracePropagationRule
from tools.analysis.rules.wall_clock import WallClockRule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SCOPES = (
    "obs", "history", "runtime", "transport", "gateway", "push", "replicate", "workers", "scenarios",
)


def _port_rule(package: str = "headlamp_tpu_torch") -> WallClockRule:
    rule = WallClockRule()
    rule.top_dirs = (package,)
    rule.scope_dirs = tuple(f"{package}/{d}" for d in PORT_SCOPES)
    return rule


def test_the_port_passes_the_wall_clock_gate():
    result = Engine(rules=[_port_rule()], root=REPO).run()
    assert result.diagnostics == [], "\n".join(str(d) for d in result.diagnostics)
    scanned = set(result.parse_counts)
    for module in ("slo.py", "profiler.py", "ledger.py", "flight.py", "exemplars.py", "timeline.py"):
        assert f"headlamp_tpu_torch/obs/{module}" in scanned, module
    assert "headlamp_tpu_torch/history/store.py" in scanned
    assert "headlamp_tpu_torch/runtime/refresh.py" in scanned
    for module in ("gateway/pool.py", "gateway/shed.py", "transport/pool.py",
                   "push/conditional.py", "replicate/replica.py", "workers/shm.py",
                   "workers/worker.py", "scenarios/runner.py", "scenarios/inject.py"):
        assert f"headlamp_tpu_torch/{module}" in scanned, module
    assert not any(p.startswith("headlamp_tpu_torch/server/") for p in scanned)


def test_the_scoped_rule_flags_an_inline_wall_clock_read(tmp_path):
    obs = tmp_path / "pkg" / "obs"
    obs.mkdir(parents=True)
    (obs / "clean.py").write_text(
        "import time\n\ndef age(monotonic=time.monotonic, wall=time.time):\n"
        "    return monotonic() - 1.0, time.strftime('%H', time.localtime(wall()))\n"
    )
    (obs / "bad.py").write_text("import time\n\ndef stamp():\n    return time.time()\n")
    result = Engine(rules=[_port_rule("pkg")], root=str(tmp_path)).run()
    assert [(d.rule, d.path, d.line) for d in result.diagnostics] == [
        ("WCK001", "pkg/obs/bad.py", 4)
    ]


def _run(rule, root=REPO):
    result = Engine(rules=[rule], root=root).run()
    return result, [(d.rule, d.path, d.line) for d in result.diagnostics]


def test_the_port_makes_no_raw_urlopen_call_outside_its_transport(tmp_path):
    rule = RawUrlopenRule()
    rule.top_dirs = ("headlamp_tpu_torch",)
    rule.exempt_dirs = ("headlamp_tpu_torch/transport",)
    result, found = _run(rule)
    assert found == [], "\n".join(str(d) for d in result.diagnostics)
    assert "headlamp_tpu_torch/metrics/client.py" in result.parse_counts
    assert not any(p.startswith("headlamp_tpu_torch/transport/") for p in result.parse_counts)
    pkg = tmp_path / "pkg"
    (pkg / "transport").mkdir(parents=True)
    (pkg / "transport" / "ok.py").write_text("import urllib.request\nurllib.request.urlopen\n")
    (pkg / "fetch.py").write_text("from urllib.request import urlopen\nurlopen('x')\n")
    rule.top_dirs, rule.exempt_dirs = ("pkg",), ("pkg/transport",)
    assert _run(rule, str(tmp_path))[1] == [("URL001", "pkg/fetch.py", 2)]


def test_only_the_gateway_and_the_host_reach_the_render_path(tmp_path):
    rule = DirectRenderRule()
    rule.top_dirs = ("headlamp_tpu_torch",)
    rule.exempt_dirs = tuple(f"headlamp_tpu_torch/{d}" for d in ("gateway", "ui", "pages"))
    rule.exempt_files = (
        "headlamp_tpu_torch/server/app.py", "headlamp_tpu_torch/scenarios/runner.py",
    )
    result, found = _run(rule)
    assert found == [], "\n".join(str(d) for d in result.diagnostics)
    for module in ("cli.py", "server/standin.py", "obs/debug_pages.py", "history/record.py"):
        assert f"headlamp_tpu_torch/{module}" in result.parse_counts, module
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "bad.py").write_text("def serve(app):\n    return app.handle('/tpu')\n")
    rule.top_dirs, rule.exempt_dirs, rule.exempt_files = ("pkg",), (), ()
    assert _run(rule, str(tmp_path))[1] == [("RND001", "pkg/bad.py", 2)]


def test_the_ports_gateway_observes_each_request_at_most_once(tmp_path):
    rule = SloObservationRule()
    rule.top_dirs = ("headlamp_tpu_torch",)
    rule.scope_dirs = ("headlamp_tpu_torch/gateway/",)
    result, found = _run(rule)
    assert found == [], "\n".join(str(d) for d in result.diagnostics)
    assert "headlamp_tpu_torch/gateway/gateway.py" in result.parse_counts
    gw = tmp_path / "pkg" / "gateway"
    gw.mkdir(parents=True)
    (gw / "bad.py").write_text(
        "class GatewayResponse:\n    pass\n\n\n"
        "class G:\n"
        "    def handle(self, shed):\n"
        "        self._req_hist.observe(1.0)\n"
        "        if shed:\n"
        "            return GatewayResponse(503, 'text/plain', '')\n"
        "        self._req_hist.observe(1.0)\n"
        "        return GatewayResponse(200, 'text/html', 'ok')\n"
    )
    rule = SloObservationRule()
    rule.top_dirs, rule.scope_dirs = ("pkg",), ("pkg/gateway/",)
    assert _run(rule, str(tmp_path))[1] == [
        ("OBS001", "pkg/gateway/bad.py", 9), ("OBS001", "pkg/gateway/bad.py", 11)
    ]


def test_only_the_ports_pool_writes_the_traceparent_header(tmp_path):
    rule = TracePropagationRule()
    rule.top_dirs = ("headlamp_tpu_torch",)
    rule.exempt_files = ("headlamp_tpu_torch/transport/pool.py",)
    result, found = _run(rule)
    assert found == [], "\n".join(str(d) for d in result.diagnostics)
    for module in ("server/app.py", "gateway/gateway.py", "obs/propagate.py",
                   "replicate/replica.py"):
        assert f"headlamp_tpu_torch/{module}" in result.parse_counts, module
    assert "headlamp_tpu_torch/transport/pool.py" not in result.parse_counts
    pkg = tmp_path / "pkg"
    (pkg / "transport").mkdir(parents=True)
    (pkg / "transport" / "pool.py").write_text("h = {}\nh['traceparent'] = 'x'\n")
    (pkg / "relay.py").write_text(
        "def forward(headers, value):\n"
        "    out = {'traceparent': value}\n"
        "    headers['traceparent'] = value\n"
        "    headers.setdefault('traceparent', value)\n"
        "    return headers.get('traceparent'), out\n"
    )
    rule.top_dirs, rule.exempt_files = ("pkg",), ("pkg/transport/pool.py",)
    assert sorted(_run(rule, str(tmp_path))[1]) == [
        ("TRC001", "pkg/relay.py", 2), ("TRC001", "pkg/relay.py", 3), ("TRC001", "pkg/relay.py", 4),
    ]

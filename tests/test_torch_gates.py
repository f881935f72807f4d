"""The repo's injected-clock gate (``WCK001``,
``tools/analysis/rules/wall_clock.py``) held over the port's injected-clock
trees, through the analysis engine with the rule's scope pointed at
``headlamp_tpu_torch`` (the rule's own scope names only the JAX package,
and ``tools/`` stays as it is): every TTL, age, burn, retention and
sampling decision in the port's ``obs``, ``history``, ``runtime`` and
``transport`` runs on an injected clock, so the gate finds nothing.
A scratch tree with one inline wall-clock read shows the scoped rule is
live.
"""

from __future__ import annotations

import os

from tools.analysis.engine import Engine
from tools.analysis.rules.wall_clock import WallClockRule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SCOPES = ("obs", "history", "runtime", "transport")


def _port_rule(package: str = "headlamp_tpu_torch") -> WallClockRule:
    rule = WallClockRule()
    rule.top_dirs = (package,)
    rule.scope_dirs = tuple(f"{package}/{d}" for d in PORT_SCOPES)
    return rule


def test_the_port_passes_the_wall_clock_gate():
    result = Engine(rules=[_port_rule()], root=REPO).run()
    assert result.diagnostics == [], "\n".join(str(d) for d in result.diagnostics)
    scanned = set(result.parse_counts)
    for module in ("slo.py", "profiler.py", "ledger.py", "flight.py", "exemplars.py"):
        assert f"headlamp_tpu_torch/obs/{module}" in scanned, module
    assert "headlamp_tpu_torch/history/store.py" in scanned
    assert "headlamp_tpu_torch/runtime/refresh.py" in scanned
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

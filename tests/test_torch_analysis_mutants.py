"""Each rule family newly held over the port fires on a scratch tree.

``tests/test_torch_analysis.py`` runs every rule over the port and finds
nothing past the port baseline. An empty run proves nothing unless the
port-scoped rule is live, so each family gets a package ``pkg`` under
``tmp_path`` laid out like the port, scoped exactly as the port is (the
same rename tables, the same swapped module tables), with one seeded
violation beside a twin the rule must let pass: THR001, EXC001, VPT001,
REL001, SYN001, the lock rules HTL001 and LCK002, GRD001 over the port's
thread-role table, and the graph-capture seam.
"""

from __future__ import annotations

from test_torch_analysis import GraphCaptureSeamRule, port_scoped

from tools.analysis.engine import Engine
from tools.analysis.rules.guarded_by import GuardedByRule

QUIET = "tests/test_quiet.py"


def _run(tmp_path, files: dict[str, str], rule_id: str, baseline=None):
    for rel, src in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
    with port_scoped("pkg", QUIET) as rules:
        rule = next(r for r in rules if r.rule_id == rule_id)
        result = Engine(rules=[rule], root=str(tmp_path), baseline=baseline).run()
    return result, [(d.path, d.context) for d in result.diagnostics]


def test_thread_spawns_outside_the_ports_seams_fire(tmp_path):
    spawn = "import threading\n\n\ndef {}() -> None:\n    threading.Thread(target=print).start()\n"
    result, found = _run(tmp_path, {
        "pkg/server/app.py": spawn.format("serve") + "\n\n" + spawn.format("helper"),
        "pkg/gateway/pool.py": (
            "import threading\n\n\nclass RenderPool:\n"
            "    def __init__(self) -> None:\n"
            "        threading.Thread(target=self._worker).start()\n"
        ),
        "pkg/models/aot.py": (
            "import concurrent.futures\n\n\nclass AotProgramRegistry:\n"
            "    def _spawn(self) -> None:\n"
            "        concurrent.futures.ThreadPoolExecutor(1)\n"
        ),
    }, "THR001")
    assert found == [("pkg/models/aot.py", "AotProgramRegistry._spawn"),
                     ("pkg/server/app.py", "helper")]


def test_swallowed_interrupts_fire_outside_the_render_loop(tmp_path):
    result, found = _run(tmp_path, {
        "pkg/gateway/pool.py": (
            "class RenderPool:\n"
            "    def _work(self, job):\n"
            "        try:\n            job()\n"
            "        except BaseException as exc:\n            job.error = exc\n"
            "    def _other(self, job):\n"
            "        try:\n            job()\n"
            "        except BaseException as exc:\n            job.error = exc\n"
        ),
        "pkg/server/__main__.py": (
            "def main(server):\n"
            "    try:\n        server.wait()\n"
            "    except KeyboardInterrupt:  # analysis: disable=EXC001\n        pass\n"
            "    try:\n        server.wait()\n"
            "    except (KeyboardInterrupt, SystemExit):\n        pass\n"
            "    try:\n        server.wait()\n"
            "    except BaseException:\n        server.close()\n        raise\n"
        ),
    }, "EXC001")
    assert found == [("pkg/gateway/pool.py", "RenderPool._other"),
                     ("pkg/server/__main__.py", "main")]
    assert [d.line for d in result.suppressed] == [4]


def test_a_page_that_walks_the_fleet_fires(tmp_path):
    result, found = _run(tmp_path, {
        "pkg/pages/fleet.py": (
            "def fleet_page(state, viewport):\n"
            "    header = len(state.nodes)\n"
            "    rows = [n.name for n in viewport.visible]\n"
            "    return header, rows, sorted(state.pods)\n"
        ),
        "pkg/server/app.py": "def tick(state):\n    return [n for n in state.nodes]\n",
    }, "VPT001")
    assert found == [("pkg/pages/fleet.py", "fleet_page")]
    base = [{"rule": "VPT001", "path": "pkg/pages/fleet.py", "context": "fleet_page",
             "reason": "scratch"}]
    assert _run(tmp_path, {}, "VPT001", baseline=base)[1] == []


def test_a_slot_that_leaks_on_a_path_fires(tmp_path):
    result, found = _run(tmp_path, {
        "pkg/transport/pool.py": (
            "class Pool:\n"
            "    def leaky(self, slot, ok):\n"
            "        slot.sem.acquire()\n"
            "        if ok:\n            slot.sem.release()\n"
            "    def careful(self, slot, work):\n"
            "        slot.sem.acquire()\n"
            "        try:\n            work()\n"
            "        finally:\n            slot.sem.release()\n"
        ),
        "pkg/server/app.py": "def leaky(slot):\n    slot.sem.acquire()\n",
    }, "REL001")
    assert found == [("pkg/transport/pool.py", "Pool.leaky")]


def test_a_dead_quiet_set_entry_fires(tmp_path):
    result, found = _run(tmp_path, {
        "pkg/obs/metrics.py": (
            "REQUESTS = 'headlamp_tpu_torch_requests_total'\n"
            "LAG = 'headlamp_tpu_torch_lag_seconds'\n"
        ),
        QUIET: (
            "def test_quiet(quiet):\n"
            "    assert quiet <= {'headlamp_tpu_torch_lag_seconds',\n"
            "                     'headlamp_tpu_torch_renamed_seconds'}\n"
        ),
    }, "SYN001")
    assert [(d.path, d.line) for d in result.diagnostics] == [(QUIET, 3)]
    assert "headlamp_tpu_torch_renamed_seconds" in result.diagnostics[0].message


def test_a_blocking_call_under_a_lock_fires(tmp_path):
    result, found = _run(tmp_path, {
        "pkg/runtime/loop.py": (
            "import time\n\n\nclass Loop:\n"
            "    def held(self):\n"
            "        with self._lock:\n            time.sleep(1.0)\n"
            "    def outside(self):\n"
            "        with self._lock:\n            n = 1\n"
            "        time.sleep(n)\n"
        ),
    }, "HTL001")
    assert found == [("pkg/runtime/loop.py", "Loop.held")]


def test_a_lock_order_cycle_in_the_ports_scopes_fires(tmp_path):
    cycle = (
        "class A:\n"
        "    def m1(self):\n"
        "        with self._lock:\n            with self._bg_lock:\n                pass\n"
        "    def m2(self):\n"
        "        with self._bg_lock:\n            with self._lock:\n                pass\n"
    )
    result, _ = _run(tmp_path, {"pkg/push/x.py": cycle}, "LCK002")
    assert [d.rule for d in result.diagnostics] == ["LCK002"]
    assert "A._lock" in result.diagnostics[0].message
    result, _ = _run(tmp_path / "elsewhere", {"pkg/pages/x.py": cycle}, "LCK002")
    assert result.diagnostics == []


def test_an_unguarded_field_across_the_ports_thread_roles_fires(tmp_path):
    # RenderPool._worker is a render worker only through the role table's
    # port twin; the sampler's thread is a role of its own.
    files = {
        "pkg/gateway/pool.py": (
            "import threading\n\n\nclass RenderPool:\n"
            "    def start(self):\n"
            "        threading.Thread(target=self._sampler).start()\n"
            "    def _worker(self):\n"
            "        with self._lock:\n            self.items.append(1)\n"
            "        with self._lock:\n            self.items.append(2)\n"
            "    def _sampler(self):\n"
            "        with self._lock:\n            self.items.pop()\n"
            "        with self._lock:\n            self.items.clear()\n"
            "        return self.items\n"
        ),
    }
    result, found = _run(tmp_path, files, "GRD001")
    assert found == [("pkg/gateway/pool.py", "RenderPool._sampler")]
    assert "RenderPool.items" in result.diagnostics[0].message
    # Under JAX's role table the worker has no role, and the field one.
    rule = GuardedByRule()
    rule.top_dirs = ("pkg",)
    assert Engine(rules=[rule], root=str(tmp_path)).run().diagnostics == []


def test_graph_capture_outside_the_registry_fires(tmp_path):
    (tmp_path / "pkg" / "models").mkdir(parents=True)
    (tmp_path / "pkg" / "server").mkdir(parents=True)
    (tmp_path / "pkg" / "models" / "aot.py").write_text(
        "import torch\n\n\ndef capture():\n    return torch.cuda.CUDAGraph()\n"
    )
    (tmp_path / "pkg" / "server" / "fast.py").write_text(
        "import re\n"
        "import torch\n"
        "import torch.cuda as tc\n"
        "from torch import compile as jit\n"
        "from torch.cuda import graph\n\n\n"
        "def hot(fn, g):\n"
        "    pattern = re.compile('x')\n"
        "    with tc.graph(g):\n        fn()\n"
        "    with graph(g):\n        fn()\n"
        "    return jit(fn), torch.cuda.CUDAGraph(), pattern, torch.cuda.synchronize\n"
    )
    result = Engine(rules=[GraphCaptureSeamRule("pkg")], root=str(tmp_path)).run()
    assert [(d.path, d.line, d.message.split("`")[1]) for d in result.diagnostics] == [
        ("pkg/server/fast.py", 4, "torch.compile"),
        ("pkg/server/fast.py", 5, "torch.cuda.graph"),
        ("pkg/server/fast.py", 10, "torch.cuda.graph"),
        ("pkg/server/fast.py", 12, "torch.cuda.graph"),
        ("pkg/server/fast.py", 14, "torch.compile"),
        ("pkg/server/fast.py", 14, "torch.cuda.CUDAGraph"),
    ]

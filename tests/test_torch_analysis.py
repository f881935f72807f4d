"""Every rule of the repo's analysis engine held over the port.

``tools.analysis.rules.all_rules()``, all eighteen rules, runs through
one ``Engine`` pass over ``headlamp_tpu_torch``. The rules' own scopes
name only the JAX package, and ``tools/`` stays as it is, so each rule's
scope attributes (``top_dirs``, ``scope_dirs``, ``exempt_dirs``,
``exempt_files``) are repointed on the instance, and the module-level
tables the rules read are swapped for their port twins with pytest's
``MonkeyPatch`` for the length of one run and restored after it:

- THR001's ``SPAWN_ALLOWLIST`` (``rules/thread_spawn.py:46-56``);
- EXC001's ``SERVE_LOOP_ALLOWLIST`` (``rules/exception_breadth.py:33-37``);
- REL001's pool files (``rules/release_paths.py:45-49``);
- the thread-role table GRD001, GRD002 and PUB001 read
  (``flow/threads.py:57-110``);
- SYN001's quiet-set file and family prefix
  (``rules/metrics_allowlist.py:25-26``).

Each JAX row moves to the same path under the port. Where the port
spells a qualname differently, the rename tables below say which and
why. SYN001 reads, for the port, the port's registry families (every
``headlamp_tpu_torch_*`` string literal in the package) against the
port's own quiet set: the one set literal in
``tests/test_torch_metricsz.py``, the port's twin of the quiet-family
check in ``tests/test_metricsz.py``. A dead entry there, a family the
port renamed or removed, is a finding.

With the port baseline below, every rule reports nothing. Each entry
names its twin, and a test checks that the twin exists: a JAX baseline
entry (``tools/analysis/baseline.json``), a JAX pragma at its
``path:line``, or a bold heading of ROADMAP.md's "Deliberate
differences". The port's ``# analysis: disable=`` pragmas are JAX's
own, each at the twin of a JAX pragma site.

The graph-capture seam is the port's JIT001: ``torch.cuda.CUDAGraph``,
``torch.cuda.graph``, ``torch.cuda.make_graphed_callables`` and
``torch.compile`` appear only in ``headlamp_tpu_torch/models/aot.py``,
the program registry. ``tests/test_torch_analysis_mutants.py`` shows
each newly covered rule family firing on a scratch tree.
"""

from __future__ import annotations

import ast
import contextlib
import json
import os
import re
from typing import Iterator

import pytest

from tools.analysis.engine import Diagnostic, Engine, FileContext, Rule, dotted_name
from tools.analysis.flow import threads as flow_threads
from tools.analysis.rules import (
    RULE_IDS,
    all_rules,
    exception_breadth,
    metrics_allowlist,
    release_paths,
    thread_spawn,
)
from tools.analysis.rules.metrics_allowlist import MetricsAllowlistRule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = "headlamp_tpu"
PORT = "headlamp_tpu_torch"
QUIET_FILE = "tests/test_torch_metricsz.py"
QUIET_PREFIX = "headlamp_tpu_torch_"

#: THR001 seams the port spells differently. JAX's ``DashboardApp.serve``
#: binds, starts the registry and the profiler and spawns the accept
#: thread itself; the port's method hands all of that to the module-level
#: ``serve(app, ...)`` (``server/app.py``).
SPAWN_RENAMES = {"DashboardApp.serve": "serve"}
#: EXC001 serve loops. The port's render worker enters the app's device
#: context (``RenderPool._worker``) and runs the loop that hands each
#: job's exception to its waiter in ``RenderPool._work``.
SERVE_LOOP_RENAMES = {"RenderPool._worker": "RenderPool._work"}
#: Thread roles: the request and SSE handlers are nested in the port's
#: module-level ``serve``.
ROLE_RENAMES = {"DashboardApp.serve.<locals>.": "serve.<locals>."}

#: The tables each rule reads at check time: (module, attribute).
TABLES = (
    (thread_spawn, "SPAWN_ALLOWLIST"),
    (exception_breadth, "SERVE_LOOP_ALLOWLIST"),
    (release_paths, "_FILES"),
    (flow_threads, "STATIC_ROLE_ENTRIES"),
    (metrics_allowlist, "_TEST_FILE"),
    (metrics_allowlist, "_PREFIX"),
)
#: The tables as this module found them.
PRISTINE = {(module.__name__, name): getattr(module, name) for module, name in TABLES}


def _moved(path: str, package: str) -> str:
    assert path == JAX or path.startswith(JAX + "/"), path
    return package + path[len(JAX):]


def _renamed(qual: str, renames: dict[str, str]) -> str:
    for old, new in renames.items():
        if qual == old or (old.endswith(".") and qual.startswith(old)):
            return new + qual[len(old):]
    return qual


def port_tables(package: str = PORT, quiet_file: str = QUIET_FILE) -> dict:
    """Each table's JAX rows moved to their port twins, keyed like TABLES."""
    return {
        (thread_spawn, "SPAWN_ALLOWLIST"): tuple(
            (_moved(p, package), _renamed(q, SPAWN_RENAMES))
            for p, q in PRISTINE[(thread_spawn.__name__, "SPAWN_ALLOWLIST")]
        ),
        (exception_breadth, "SERVE_LOOP_ALLOWLIST"): {
            (_moved(p, package), _renamed(q, SERVE_LOOP_RENAMES))
            for p, q in PRISTINE[(exception_breadth.__name__, "SERVE_LOOP_ALLOWLIST")]
        },
        (release_paths, "_FILES"): tuple(
            _moved(p, package) for p in PRISTINE[(release_paths.__name__, "_FILES")]
        ),
        (flow_threads, "STATIC_ROLE_ENTRIES"): tuple(
            (role, _moved(p, package), _renamed(q, ROLE_RENAMES))
            for role, p, q in PRISTINE[(flow_threads.__name__, "STATIC_ROLE_ENTRIES")]
        ),
        (metrics_allowlist, "_TEST_FILE"): quiet_file,
        (metrics_allowlist, "_PREFIX"): QUIET_PREFIX,
    }


def _repoint(rule: Rule, package: str, quiet_file: str) -> Rule:
    def moved(paths: tuple[str, ...]) -> tuple[str, ...]:
        return tuple(_moved(p, package) for p in paths if p == JAX or p.startswith(JAX + "/"))

    rule.top_dirs = moved(rule.top_dirs)
    if rule.scope_dirs is not None:
        rule.scope_dirs = moved(rule.scope_dirs)
    rule.exempt_dirs = moved(rule.exempt_dirs)
    rule.exempt_files = moved(rule.exempt_files)
    if isinstance(rule, MetricsAllowlistRule):
        rule.top_dirs += (quiet_file,)
    return rule


#: What builds or captures a device program.
CAPTURE_APIS = frozenset({
    "torch.compile",
    "torch.cuda.CUDAGraph",
    "torch.cuda.graph",
    "torch.cuda.make_graphed_callables",
    "torch.cuda.graphs.CUDAGraph",
    "torch.cuda.graphs.graph",
    "torch.cuda.graphs.make_graphed_callables",
})


class GraphCaptureSeamRule(Rule):
    """CAP001, the port's JIT001: a CUDA graph is captured, and a program
    compiled, only in the program registry, where startup captures every
    hot program and a request replays it. Flags a reference to any of
    ``CAPTURE_APIS`` in any spelling: attribute chains through
    ``import torch`` or ``import torch.cuda as tc``, ``from torch[.cuda]
    import ...`` bindings and bare-name loads of those bindings."""

    rule_id = "CAP001"
    name = "graph-capture-seam"
    description = "CUDA graphs and compiled programs live only in models/aot.py"

    def __init__(self, package: str = PORT) -> None:
        self.top_dirs = (package,)
        self.exempt_files = (f"{package}/models/aot.py",)

    def check_file(self, ctx: FileContext) -> list[Diagnostic]:
        bound: dict[str, str] = {}
        hits: list[tuple[int, str]] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    head = alias.name.split(".")[0]
                    bound[alias.asname or head] = alias.name if alias.asname else head
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                for alias in node.names:
                    full = f"{node.module}.{alias.name}"
                    bound[alias.asname or alias.name] = full
                    if full in CAPTURE_APIS:
                        hits.append((node.lineno, full))
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Name) and not isinstance(node.ctx, ast.Load):
                continue
            name = dotted_name(node) if isinstance(node, (ast.Attribute, ast.Name)) else None
            if name is None:
                continue
            head, _, rest = name.partition(".")
            full = bound.get(head, head) + (f".{rest}" if rest else "")
            if full in CAPTURE_APIS:
                hits.append((node.lineno, full))
        return [
            Diagnostic(
                self.rule_id, ctx.relpath, line,
                f"`{full}` outside the program registry (models/aot.py): capture it there "
                "so startup captures it once and requests replay it",
                context=ctx.enclosing_qualname(line),
            )
            for line, full in sorted(set(hits))
        ]


def port_rules(package: str = PORT, quiet_file: str = QUIET_FILE) -> list[Rule]:
    """``all_rules()`` scoped to ``package``, and the graph-capture seam."""
    return [_repoint(r, package, quiet_file) for r in all_rules()] + [
        GraphCaptureSeamRule(package)
    ]


@contextlib.contextmanager
def port_scoped(package: str = PORT, quiet_file: str = QUIET_FILE) -> Iterator[list[Rule]]:
    """The port-scoped rules, with every table swapped for its port twin
    until the block ends."""
    tables = port_tables(package, quiet_file)
    with pytest.MonkeyPatch.context() as mp:
        for (module, name), value in tables.items():
            mp.setattr(module, name, value)
        yield port_rules(package, quiet_file)


def _baseline(rule: str, path: str, context: str, reason: str, *twins: tuple) -> dict:
    return {"rule": rule, "path": f"{PORT}/{path}", "context": context, "reason": reason,
            "twins": twins}


def _jax(rule: str, path: str, context: str) -> tuple:
    """A JAX baseline entry."""
    return ("baseline", rule, f"{JAX}/{path}", context)


def _roadmap(heading: str) -> tuple:
    """A bold heading of ROADMAP.md's "Deliberate differences"."""
    return ("roadmap", heading)


_PAGER = "The legacy offset pager, kept byte for byte with JAX's."
_INTEL = "The Intel provider's full-table pages, as the reference plugin's; small fleets."
_FIND = "A detail lookup by name; an indexed lookup is queued in JAX as here."

#: Every port finding the rules allow, with its reason and its twin.
PORT_BASELINE = [
    _baseline("EXC001", "transport/api_proxy.py", "with_timeout.<locals>.runner",
              "The runner thread carries any exception to with_timeout, which re-raises "
              "it on the calling thread.",
              _jax("EXC001", "transport/api_proxy.py", "with_timeout.<locals>.runner")),
    _baseline("EXC001", "transport/pool.py", "FanoutScheduler.map.<locals>.run_chunk",
              "A chunk thread carries any exception to map(), which joins every chunk and "
              "re-raises the first; JAX's executor future does the same.",
              _roadmap("Threads are joined."),
              _jax("EXC001", "transport/api_proxy.py", "with_timeout.<locals>.runner")),
    _baseline("REL001", "transport/pool.py", "ConnectionPool._checkout",
              "_checkout returns holding the slot semaphore; PooledResponse.close or "
              "_discard releases it.",
              _jax("REL001", "transport/pool.py", "ConnectionPool._checkout")),
    _baseline("THR001", "context/accelerator_context.py",
              "AcceleratorDataContext._sync_reactive",
              "One persistent worker carries the node track while the caller runs the pod "
              "track; close() joins it.",
              _jax("THR001", "context/accelerator_context.py",
                   "AcceleratorDataContext._sync_reactive")),
    _baseline("THR001", "models/aot.py", "AotProgramRegistry._spawn",
              "The startup capture and a missed program's single-flight capture both start "
              "here; join() ends them.",
              _jax("THR001", "models/aot.py", "AotProgramRegistry.compile_startup"),
              _jax("THR001", "models/aot.py", "AotProgramRegistry.ensure")),
    _baseline("THR001", "parallel/mesh.py", "_make_groups",
              "Each in-process gloo rank meets the others on a thread of its own.",
              _roadmap("The mesh is SPMD with explicit c10d groups.")),
    _baseline("THR001", "parallel/mesh.py", "run_spmd",
              "Each in-process rank runs its collectives on a thread of its own; all are "
              "joined before run_spmd returns.",
              _roadmap("The mesh is SPMD with explicit c10d groups.")),
    _baseline("THR001", "runtime/refresh.py", "Refresher._spawn_refit_locked",
              "The refresher is the background-refit seam: one single-flight worker per "
              "stale key, joined by drain().",
              _jax("THR001", "runtime/refresh.py", "Refresher._spawn_refit_locked")),
    _baseline("THR001", "server/standin.py", "StandInApiserver.__init__",
              "The local stand-in apiserver serves from a thread of its own; close() joins "
              "it.",
              _roadmap("The stand-in apiserver is a module.")),
    _baseline("THR001", "transport/api_proxy.py", "with_timeout",
              "Stdlib connect and DNS have no deadline: the call runs on a thread the caller "
              "abandons at the deadline, counted.",
              _jax("THR001", "transport/api_proxy.py", "with_timeout")),
    _baseline("THR001", "workers/supervisor.py", "WorkerSupervisor.start",
              "The supervisor is the process-spawn seam: it starts the serving workers.",
              _jax("THR001", "workers/supervisor.py", "WorkerSupervisor.start")),
    _baseline("VPT001", "pages/common.py", "filter_and_page_nodes", _PAGER,
              _jax("VPT001", "pages/common.py", "filter_and_page_nodes")),
    _baseline("VPT001", "pages/intel.py", "intel_overview_page", _INTEL,
              _jax("VPT001", "pages/intel.py", "intel_overview_page")),
    _baseline("VPT001", "pages/intel.py", "intel_pods_page", _INTEL,
              _jax("VPT001", "pages/intel.py", "intel_pods_page")),
    _baseline("VPT001", "pages/native.py", "_find_node", _FIND,
              _jax("VPT001", "pages/native.py", "_find_node")),
    _baseline("VPT001", "pages/native.py", "_find_pod", _FIND,
              _jax("VPT001", "pages/native.py", "_find_pod")),
    _baseline("VPT001", "pages/native.py", "native_nodes_page",
              "The native nodes list pages through the legacy offset pager.",
              _jax("VPT001", "pages/native.py", "native_nodes_page")),
    _baseline("VPT001", "pages/native.py", "native_node_page",
              "A node's detail filters the pod list for that node.",
              _jax("VPT001", "pages/native.py", "native_node_page")),
    _baseline("VPT001", "pages/overview.py", "overview_page",
              "The active-pods section predates the viewport layer.",
              _jax("VPT001", "pages/overview.py", "overview_page")),
]

#: The port's pragmas: (rule, path, context) and the JAX pragma lines
#: they mirror.
PORT_PRAGMAS = {
    ("EXC001", f"{PORT}/server/__main__.py", "_serve_until_interrupted"):
        (f"{JAX}/server/__main__.py:88", f"{JAX}/server/__main__.py:166"),
    ("EXC001", f"{PORT}/server/standin.py", "main"): (f"{JAX}/server/__main__.py:166",),
    ("EXC001", f"{PORT}/workers/supervisor.py", "WorkerSupervisor.wait"):
        (f"{JAX}/workers/supervisor.py:161",),
    ("EXC001", f"{PORT}/workers/worker.py", "worker_main"): (f"{JAX}/workers/worker.py:269",),
}


@pytest.fixture(scope="module")
def port_run():
    with port_scoped() as rules:
        engine = Engine(rules=rules, root=REPO, baseline=PORT_BASELINE)
        result = engine.run()
    return engine, rules, result


def _port_files() -> set[str]:
    out = set()
    for dirpath, dirnames, filenames in os.walk(os.path.join(REPO, PORT)):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out |= {os.path.relpath(os.path.join(dirpath, f), REPO) for f in filenames
                if f.endswith(".py")}
    return out


def test_every_rule_runs_over_every_port_module_once(port_run):
    engine, rules, result = port_run
    assert {r.rule_id for r in rules} == set(RULE_IDS) | {"CAP001"}
    assert len(RULE_IDS) == 18
    assert set(result.rule_ms) == set(RULE_IDS) | {"CAP001"}
    assert set(result.parse_counts) == _port_files() | {QUIET_FILE}
    assert result.files_parsed_once
    for rule in rules:
        assert not any(rule.wants(p) for p in ("headlamp_tpu/server/app.py", "bench.py",
                                               "tools/make_screenshots.py")), rule.rule_id


def test_the_port_reports_nothing_past_its_baseline(port_run):
    _, _, result = port_run
    assert result.diagnostics == [], "\n".join(str(d) for d in result.diagnostics)
    assert result.stale_baseline == []
    entries: dict[str, int] = {}
    for entry in PORT_BASELINE:
        entries[entry["rule"]] = entries.get(entry["rule"], 0) + 1
    assert entries == {"EXC001": 2, "REL001": 1, "THR001": 8, "VPT001": 8}
    sites: dict[str, int] = {}
    for d in result.baselined:
        sites[d.rule] = sites.get(d.rule, 0) + 1
    assert sites == {"EXC001": 2, "REL001": 1, "THR001": 8, "VPT001": 10}


def test_every_baseline_entry_names_a_twin_that_exists():
    with open(os.path.join(REPO, "tools", "analysis", "baseline.json"), encoding="utf-8") as f:
        jax_entries = {(e["rule"], e["path"], e["context"]) for e in json.load(f)["entries"]}
    with open(os.path.join(REPO, "ROADMAP.md"), encoding="utf-8") as f:
        roadmap = f.read()
    start = roadmap.index("**Deliberate differences, not faults.**")
    differences = roadmap[start:roadmap.index("\n**", start + 1)]
    headings = set(re.findall(r"^- \*\*(.+?)\*\*", differences, flags=re.M))
    for entry in PORT_BASELINE:
        assert entry["reason"] and entry["twins"], entry
        for twin in entry["twins"]:
            if twin[0] == "baseline":
                assert twin[1:] in jax_entries, (entry["context"], twin)
            else:
                assert twin[0] == "roadmap" and twin[1] in headings, (entry["context"], twin)


def test_the_ports_pragmas_mirror_jax_pragma_sites(port_run):
    _, _, result = port_run
    assert {(d.rule, d.path, d.context) for d in result.suppressed} == set(PORT_PRAGMAS)
    for (rule, _, _), twins in PORT_PRAGMAS.items():
        for twin in twins:
            path, line = twin.rsplit(":", 1)
            with open(os.path.join(REPO, path), encoding="utf-8") as f:
                source_line = f.read().splitlines()[int(line) - 1]
            assert f"# analysis: disable={rule}" in source_line, twin


def test_every_table_row_names_its_port_twin(port_run):
    engine, _, _ = port_run
    defs = set(engine.project().callgraph().defs)
    quals = {q for _, q in defs}
    tables = port_tables()
    for path, prefix in tables[(thread_spawn, "SPAWN_ALLOWLIST")]:
        assert any(rel == path and q.startswith(prefix) for rel, q in defs), (path, prefix)
    for key in tables[(exception_breadth, "SERVE_LOOP_ALLOWLIST")]:
        assert key in defs, key
    for path in tables[(release_paths, "_FILES")]:
        assert os.path.isfile(os.path.join(REPO, path)), path
    roles = engine.project().threads()
    for role, path, pattern in tables[(flow_threads, "STATIC_ROLE_ENTRIES")]:
        matched = [(rel, q) for rel, q in defs if rel == path and (
            q.startswith(pattern) if pattern.endswith(".") else q == pattern)]
        assert matched, (role, path, pattern)
        assert all(role in roles.roles_of(k) for k in matched), (role, pattern)
    assert "serve" in quals and "RenderPool._work" in quals
    # The request handler and the SSE loop both reach the stream handler,
    # as in JAX's role map.
    assert {"request-handler", "sse-handler"} <= roles.roles_of(
        (f"{PORT}/server/app.py", "serve.<locals>.Handler._serve_events"))


def test_syn001_reads_the_ports_families_against_its_quiet_set(port_run):
    _, rules, result = port_run
    rule = next(r for r in rules if r.rule_id == "SYN001")
    assert result.for_rule("SYN001") == []
    assert rule.allowlisted_seen == 28
    assert QUIET_FILE in result.parse_counts
    assert not any(p.startswith(f"{JAX}/") or p == "tests/test_metricsz.py"
                   for p in result.parse_counts)


def test_graph_capture_lives_only_in_the_program_registry(port_run):
    _, _, result = port_run
    assert result.for_rule("CAP001") == []
    rule = GraphCaptureSeamRule()
    rule.exempt_files = ()
    found = Engine(rules=[rule], root=REPO).run().diagnostics
    assert {(d.path, d.context) for d in found} == {
        (f"{PORT}/models/aot.py", "GraphProgram.__init__"),
    }
    assert {d.message.split("`")[1] for d in found} == {"torch.cuda.CUDAGraph", "torch.cuda.graph"}


def test_the_port_runs_leave_the_analysis_modules_as_found(port_run):
    for module, name in TABLES:
        assert getattr(module, name) is PRISTINE[(module.__name__, name)], name
    with port_scoped():
        assert thread_spawn.SPAWN_ALLOWLIST is not PRISTINE[(thread_spawn.__name__,
                                                             "SPAWN_ALLOWLIST")]
    for module, name in TABLES:
        assert getattr(module, name) is PRISTINE[(module.__name__, name)], name
    assert all(p.startswith(f"{JAX}/") for p, _ in thread_spawn.SPAWN_ALLOWLIST)
    assert metrics_allowlist._TEST_FILE == "tests/test_metricsz.py"

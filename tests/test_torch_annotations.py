"""Annotation coverage over the port, the twin of
``tests/test_annotations.py``: every def under ``headlamp_tpu_torch/``,
nested ones included, annotates its return and every parameter but
``self`` and ``cls``, so a whole-package mypy run over the port never
degrades.
"""

from __future__ import annotations

import ast
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "headlamp_tpu_torch")


def iter_functions() -> list[tuple[str, ast.FunctionDef | ast.AsyncFunctionDef]]:
    out: list[tuple[str, ast.FunctionDef | ast.AsyncFunctionDef]] = []
    for dirpath, dirnames, filenames in os.walk(PACKAGE):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for filename in sorted(filenames):
            if not filename.endswith(".py"):
                continue
            path = os.path.join(dirpath, filename)
            with open(path, "r", encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=path)
            for node in ast.walk(tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.append((os.path.relpath(path, REPO), node))
    return out


def test_every_port_function_is_fully_annotated():
    offenders: list[str] = []
    for path, node in iter_functions():
        args = [
            a
            for a in (
                *node.args.posonlyargs,
                *node.args.args,
                *node.args.kwonlyargs,
                *([node.args.vararg] if node.args.vararg else []),
                *([node.args.kwarg] if node.args.kwarg else []),
            )
            if a.arg not in ("self", "cls")
        ]
        unannotated = [a.arg for a in args if a.annotation is None]
        if node.returns is None or unannotated:
            what = ["return"] if node.returns is None else []
            what.extend(unannotated)
            offenders.append(f"{path}:{node.lineno} {node.name}({', '.join(what)})")
    assert not offenders, "unannotated defs:\n" + "\n".join(offenders)


def test_the_walk_covers_the_whole_port():
    # An empty walk would pass the test above vacuously.
    functions = iter_functions()
    assert len(functions) > 1000
    paths = {path for path, _ in functions}
    for module in ("server/app.py", "models/aot.py", "parallel/mesh.py", "kernels/build.py"):
        assert os.path.join("headlamp_tpu_torch", module) in paths, module

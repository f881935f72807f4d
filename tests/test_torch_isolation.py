"""The PyTorch port stands alone: no module of it, nor chip_smoke.py,
imports JAX, optax or the JAX package, and the package imports with all
three blocked."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import headlamp_tpu_torch

REPO = Path(__file__).resolve().parents[1]
PORT = Path(headlamp_tpu_torch.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "optax", "headlamp_tpu"}


def _package_sources() -> list[Path]:
    """The package's modules; kernel build outputs are not sources."""
    return sorted(
        p for p in PORT.rglob("*.py") if "_build" not in p.relative_to(PORT).parts
    )


def _source_groups() -> dict[str, list[Path]]:
    """Sources by subpackage ("." for the package's own top level), plus
    chip_smoke.py on its own."""
    groups: dict[str, list[Path]] = {"chip_smoke.py": [REPO / "chip_smoke.py"]}
    for path in _package_sources():
        parts = path.relative_to(PORT).parts
        groups.setdefault(parts[0] if len(parts) > 1 else ".", []).append(path)
    return groups


@pytest.mark.parametrize("group", sorted(_source_groups()))
def test_no_jax_or_reference_imports(group):
    for path in _source_groups()[group]:
        tree = ast.parse(path.read_text(encoding="utf-8"))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [alias.name.split(".")[0] for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                roots = [node.module.split(".")[0]]
            else:
                continue
            bad = FORBIDDEN.intersection(roots)
            assert not bad, f"{path.name}:{node.lineno} imports {sorted(bad)}"


def test_package_imports_with_jax_and_reference_blocked():
    modules = sorted(
        "headlamp_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in _package_sources()
        if p.name != "__init__.py"
    )
    code = textwrap.dedent(
        f"""
        import importlib, sys
        for name in ("jax", "jaxlib", "optax", "headlamp_tpu"):
            sys.modules[name] = None
        import headlamp_tpu_torch, headlamp_tpu_torch.cli
        for name in {modules!r}:
            importlib.import_module(name)
        assert not any(m == "jax" or m.startswith(("jax.", "headlamp_tpu."))
                       for m, v in sys.modules.items() if v is not None)
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")

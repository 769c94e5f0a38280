"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program; top-level module names are
compared whole (`bundler_sfm_tpu_torch` begins with `bundler_sfm_tpu`)."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

from sfmbench import harness

PKG = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "bundler_sfm_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax():
    files = [p for p in PKG.rglob("*.py")]
    assert len(files) > 20
    for p in files:
        assert not set(_imports(p)) & JAX, p


def test_reference_imports_nothing_of_the_program():
    for p in (PKG / "reference").rglob("*.py"):
        assert "bundler_sfm_tpu_torch" not in set(_imports(p)), p


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import bundler_sfm_tpu_torch  # noqa: F401
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "bundler_sfm_tpu", raising=False)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]

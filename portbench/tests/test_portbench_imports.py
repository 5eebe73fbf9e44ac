"""What the benchmark may import: no JAX and not the JAX package anywhere,
nothing of the program in the references, and not the JAX package's own
benchmark folder."""

from __future__ import annotations

import ast
import pathlib
import sys

import pytest

from portbench import __main__ as entry

HERE = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
OLD_FOLDER = "benchmarks" + "/"     # the JAX package's benchmark folder


def _imported_roots(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not _imported_roots(path) & FORBIDDEN
    assert OLD_FOLDER not in path.read_text()


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert "repro_torch" not in _imported_roots(path)
    assert not _imported_roots(path) - {"__future__", "math", "statistics",
                                        "typing", "torch", "numpy",
                                        "portbench"}
    src = path.read_text()
    for mod in ("drivers", "harness", "control"):
        assert f"portbench.{mod}" not in src


def test_the_whole_name_decides(monkeypatch):
    before = set(entry.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert set(entry.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "repro.comm", sys)
    assert "repro" in entry.forbidden_modules()

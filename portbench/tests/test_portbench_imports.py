"""No module of the benchmark imports JAX or the JAX package: top-level
names compared whole (``repro_torch``, the program, begins with the JAX
package's name ``repro`` and is allowed)."""
import ast
import sys

import pytest

from portbench.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted((tiny.ROOT / "portbench").rglob("*.py"))


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(tiny.ROOT)))
def test_no_jax_import(path):
    bad = [n for n in imported(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_references_import_nothing_of_the_program():
    for path in (tiny.ROOT / "portbench" / "reference").glob("*.py"):
        assert not [n for n in imported(path)
                    if n.split(".")[0] in {"repro_torch", "portbench"}], path


def test_the_runs_check_compares_whole_names(monkeypatch):
    sys.path.insert(0, str(tiny.ROOT / "portbench"))
    try:
        import run
    finally:
        sys.path.pop(0)
    for name in ("repro_torch", "repro_torch.serving", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    clean = run.forbidden_modules()
    assert "repro_torch" not in clean and "jaxtyping" not in clean
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in run.forbidden_modules()

"""What the benchmark may import: nothing under ``benchmark/`` imports
JAX or the JAX package ``presto_tpu`` (compared by the whole top-level
name, so ``presto_tpu_torch`` is another name), and nothing under
``reference/`` or ``gen/`` imports the program."""

import ast
from pathlib import Path

import pytest

from benchmark import harness

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    bad = set(top_level_imports(path)) & {"jax", "jaxlib", "flax", "presto_tpu"}
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize(
    "path", [p for p in FILES if p.parent.name in ("reference", "gen")],
    ids=lambda p: str(p.relative_to(HERE)))
def test_reference_and_generators_stand_apart(path):
    assert "presto_tpu_torch" not in set(top_level_imports(path))
    # what they import of the benchmark imports nothing of the program
    for mod in set(top_level_imports(path)):
        assert mod in ("benchmark", "torch", "dataclasses", "datetime",
                       "decimal", "hashlib", "typing", "__future__"), mod


def test_the_reference_helpers_stand_apart():
    for name in ("params.py",):
        assert "presto_tpu_torch" not in set(top_level_imports(HERE / name))


def test_forbidden_modules_by_whole_name(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "presto_tpu_torch_probe", types.ModuleType("x"))
    assert "presto_tpu_torch_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.probe", types.ModuleType("y"))
    assert "jaxlib.probe" in harness.forbidden_modules()

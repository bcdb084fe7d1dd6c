"""The PyTorch port stands alone: neither ``presto_tpu_torch`` nor the
chip scripts (``chip_smoke.py``, ``chip_profile.py``) import JAX or
anything of the JAX package."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "presto_tpu_torch"
# build/ holds what the port builds at run time, not its sources
PORT_FILES = sorted(
    p for p in PORT.rglob("*.py") if p.relative_to(PORT).parts[0] != "build"
) + [ROOT / "chip_smoke.py", ROOT / "chip_profile.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "presto_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES]
)
def test_port_file_imports_neither_jax_nor_the_reference(path):
    bad = [(line, m) for line, m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_leaves_jax_unloaded():
    code = (
        "import pkgutil, sys\n"
        "import presto_tpu_torch\n"
        "for m in pkgutil.walk_packages(presto_tpu_torch.__path__,"
        " 'presto_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "import chip_smoke, chip_profile\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'presto_tpu'))\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr

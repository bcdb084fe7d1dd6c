"""Where the benchmark's pieces live, found by name: a cell in
``BENCHMARK.json``, a configuration in ``configs/<name>.json``, a
traffic mix in ``mixes/<name>.json``, a query in ``queries/<name>.sql``
with its parameter space in ``queries/<name>.params.json``, its plain
reference in ``reference/<name>.py``, a metric's reader in
``metrics/<name>.py`` and a table generator in ``gen/<name>.py``."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name) or ".." in name:
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{_checked(name)}.json")


def mix(name: str) -> dict:
    return _json(HERE / "mixes" / f"{_checked(name)}.json")


def query_sql(name: str) -> str:
    return (HERE / "queries" / f"{_checked(name)}.sql").read_text()


def query_meta(name: str) -> dict:
    return _json(HERE / "queries" / f"{_checked(name)}.params.json")


def generator(cfg: dict):
    return importlib.import_module(f"benchmark.gen.{_checked(cfg['generator'])}")


def reference(name: str):
    return importlib.import_module(f"benchmark.reference.{_checked(name)}")


def metric_reader(name: str):
    """The module of ``metrics/<name>.py`` (a name may hold dots)."""
    path = HERE / "metrics" / f"{_checked(name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

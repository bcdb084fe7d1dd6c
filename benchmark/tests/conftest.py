"""The benchmark's CPU tests: ``cpu_run`` runs a cell on the CPU at its
tiny size."""

import pytest

from bench_tiny import TINY, tiny_config
from benchmark import harness, layout


@pytest.fixture
def cpu_run(monkeypatch):
    """``run(cell, seed)``: one run of a cell on the CPU at its tiny size,
    a short window. The look for forbidden modules is left to its own
    test: this process may hold JAX from other test files."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])

    def run(cell, seed, seconds=0.3, trace=False):
        cfg = tiny_config(layout.workload(layout.benchmark(), cell)["config"],
                          TINY[cell])
        return harness.run_cell(cell, seed, seconds, trace, "cpu", 0.0,
                                cfg=cfg, log=lambda msg: None)

    return run

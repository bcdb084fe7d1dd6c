"""The comparison fails what it has to fail: the control (the reference
in float32 in the program's place) on three seeds, and a run with the
timed path broken underneath, once for each fault the cells can have;
a sound run passes."""

import pytest
import torch

from bench_tiny import TINY, tiny_config
from benchmark import control, layout
from benchmark.connector import GeneratedConnector
from presto_tpu_torch.connectors.tpch import DictColumn
from presto_tpu_torch.exec import local_runner

CELLS = list(TINY)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    # Q95's sums stay under float32's exact integers below SF10, so its
    # control runs at the cell's own size
    w = layout.workload(layout.benchmark(), cell)
    cfg = (tiny_config(w["config"], TINY[cell]) if cell.startswith("tpch")
           else layout.config(w["config"]))
    for seed in (1, 2, 3):
        out = control.control_readings(cell, seed, torch.device("cpu"), cfg)
        assert not out["passed"], out


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cpu_run, cell):
    out = cpu_run(cell, 2**31 + 5)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_each_split_left_out(cpu_run, monkeypatch, cell):
    real = GeneratedConnector.create_page_source

    def half(self, split, columns):
        out = real(self, split, columns)
        keep = (split.row_end - split.row_start + 1) // 2
        return {c: (DictColumn(ids=v.ids[:keep], values=v.values)
                    if isinstance(v, DictColumn) else v[:keep])
                for c, v in out.items()}

    monkeypatch.setattr(GeneratedConnector, "create_page_source", half)
    assert not cpu_run(cell, 2**31 + 6)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced(cpu_run, monkeypatch, cell):
    real = local_runner.QueryResult.exact_rows

    def altered(self):
        rows = real(self)
        if not rows:
            return [(None,) * len(self.columns)]
        first = list(rows[0])
        for i in range(len(first) - 1, -1, -1):
            if isinstance(first[i], (int, float)) or hasattr(first[i], "scaleb"):
                first[i] = first[i] + 1
                break
        return [tuple(first)] + rows[1:]

    monkeypatch.setattr(local_runner.QueryResult, "exact_rows", altered)
    assert not cpu_run(cell, 2**31 + 7)["correct"]


def test_traced_run_reports_per_layer_metrics(cpu_run):
    out = cpu_run("tpch_sf10.join", 2**31 + 8, trace=True)
    assert out["correct"], out["checks"]
    assert {"plan_ms", "staging_s", "syncs_per_query"} <= set(out["metrics"])
    assert out["device"]["window_s"] > 0 and "breakdown" in out
    assert list(out)[-1] == "checks"

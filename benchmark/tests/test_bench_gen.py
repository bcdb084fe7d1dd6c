"""The generators: deterministic per seed, different across seeds, the
configured row counts, and the specification's value ranges."""

import pytest
import torch

from benchmark import layout
from benchmark.gen.common import Varchar
from bench_tiny import tiny_config

CONFIGS = [("tpch_sf10", 0.001), ("tpcds_sf10", 0.01)]


def _gen(name, factor, seed):
    cfg = tiny_config(name, factor)
    return cfg, layout.generator(cfg).generate(cfg, seed, torch.device("cpu"))


def _data(col):
    return col.ids if isinstance(col, Varchar) else col


@pytest.mark.parametrize("name,factor", CONFIGS)
def test_same_seed_same_tables(name, factor):
    _, a = _gen(name, factor, 2**31 + 7)
    _, b = _gen(name, factor, 2**31 + 7)
    for t in a:
        for c in a[t]:
            assert torch.equal(_data(a[t][c]), _data(b[t][c])), (t, c)


@pytest.mark.parametrize("name,factor", CONFIGS)
def test_seeds_differ(name, factor):
    _, a = _gen(name, factor, 1)
    _, b = _gen(name, factor, 2)
    differ = [(t, c) for t in a for c in a[t]
              if not torch.equal(_data(a[t][c]), _data(b[t][c]))]
    # the large tables' random columns all differ
    big = "lineitem" if name.startswith("tpch") else "web_sales"
    assert {c for t, c in differ if t == big} >= {
        c for c in a[big] if c not in ("l_orderkey",)} - {"ws_order_number"}


@pytest.mark.parametrize("name,factor", CONFIGS)
def test_rows_columns_and_dictionaries(name, factor):
    cfg, tables = _gen(name, factor, 3)
    for t, spec in cfg["tables"].items():
        assert set(tables[t]) == set(spec["columns"])
        for c, col in tables[t].items():
            assert len(_data(col)) == spec["rows"], (t, c)
            if isinstance(col, Varchar):
                assert list(col.values) == sorted(col.values)
                assert int(col.ids.min()) >= 0
                assert int(col.ids.max()) < len(col.values)


def test_full_size_row_counts():
    from benchmark.gen import tpch, tpcds

    cfg = layout.config("tpch_sf10")
    counts = tpch.row_counts(cfg["scale_factor"])
    assert {t: counts[t] for t in cfg["tables"]} == {
        t: s["rows"] for t, s in cfg["tables"].items()}
    assert counts["lineitem"] == 60_000_000
    ds = layout.config("tpcds_sf10")
    lines = tpcds.lines_per_order(ds["tables"]["web_sales"]["rows"], "cpu")
    assert int(lines.sum()) == 7_197_566
    assert int(lines.min()) >= 8 and int(lines.max()) <= 16


def test_tpch_value_ranges():
    from benchmark.gen import tpch

    _, t = _gen("tpch_sf10", 0.001, 5)
    li, o = t["lineitem"], t["orders"]
    assert int(li["l_quantity"].min()) >= 100
    assert int(li["l_quantity"].max()) <= 5000
    assert int(li["l_discount"].max()) <= 10 and int(li["l_tax"].max()) <= 8
    assert int(o["o_orderdate"].min()) >= tpch.STARTDATE
    assert int(o["o_orderdate"].max()) <= tpch.ENDDATE - 151
    assert bool((o["o_custkey"] % 3 != 0).all())
    # each line ships 1..121 days after its order
    row = {int(k): i for i, k in enumerate(o["o_orderkey"].tolist())}
    od = o["o_orderdate"][[row[int(k)] for k in li["l_orderkey"].tolist()]]
    lag = li["l_shipdate"] - od
    assert int(lag.min()) >= 1 and int(lag.max()) <= 121
    # the partsupp formula keeps suppliers in range
    assert int(li["l_suppkey"].min()) >= 1
    assert int(li["l_suppkey"].max()) <= len(t["supplier"]["s_suppkey"])

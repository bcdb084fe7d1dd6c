"""Parity of the port's window operator (presto_tpu_torch.ops.window)
with the reference's, on the operator and through SQL.

Operator level: the same seeded masked page, with NULL partition and
order keys and tied order keys, goes through ``presto_tpu.ops.window``
and the port's ``window`` with every function ``WindowCall`` lists, in
both aggregate frames, with and without ORDER BY. The outputs must
agree row for row in their (partition, order) sorted order: integer,
decimal and string columns exactly, doubles within rel 1e-9 (the
reference's running float sum is a page-wide cumsum difference, the
port's a segmented doubling tree). SQL level: ``bench.py``'s window
query and the reference tests' window shapes at tpch.tiny."""

from __future__ import annotations

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import expr as RE
from presto_tpu import types as RT
from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu.ops.sort import SortKey as RSortKey
from presto_tpu_torch import convert
from presto_tpu_torch import expr as PE
from presto_tpu_torch import types as PT
from presto_tpu_torch.exec.local_runner import LocalQueryRunner
from presto_tpu_torch.ops.sort import SortKey as PSortKey
from torch_parity import assert_columns_equal, both_pages, jax_live_columns
from torch_parity import one_torch_thread  # noqa: F401

# the modules (``ops.window`` names the function in both packages)
RW = importlib.import_module("presto_tpu.ops.window")
PW = importlib.import_module("presto_tpu_torch.ops.window")

CAP = 256
LIVE = 240

TYPES = {
    "rowid": "bigint", "pk": "bigint", "pk2": "varchar", "ok": "integer",
    "x": "bigint", "f": "double", "dec": "decimal(12,2)", "s": "varchar",
}


def _columns(seed: int = 0):
    rng = np.random.default_rng(seed)
    words = np.asarray(["ant", "bee", "cat", "dog", "eel"], object)
    f = rng.random(CAP) * 100 + 1  # positive: no cancellation in sums
    return {
        "rowid": (np.arange(CAP, dtype=np.int64), None, "bigint", None),
        "pk": (rng.integers(0, 6, CAP).astype(np.int64),
               rng.random(CAP) < 0.9, "bigint", None),
        "pk2": (rng.integers(0, 2, CAP).astype(np.int32), None, "varchar",
                np.asarray(["u", "v"], object)),
        # few distinct values: many ties, which row_number breaks by the
        # stable sort's (input) order
        "ok": (rng.integers(0, 5, CAP).astype(np.int32),
               rng.random(CAP) < 0.85, "integer", None),
        "x": (rng.integers(-1000, 1000, CAP).astype(np.int64),
              rng.random(CAP) < 0.8, "bigint", None),
        "f": (f, rng.random(CAP) < 0.8, "double", None),
        "dec": (rng.integers(-10**6, 10**6, CAP).astype(np.int64),
                rng.random(CAP) < 0.9, "decimal(12,2)", None),
        "s": (rng.integers(0, len(words), CAP).astype(np.int32),
              rng.random(CAP) < 0.8, "varchar", words),
    }


def _masked_pages(seed: int = 0):
    """Both packages' pages of the same rows, masked: a random live mask
    inside the first LIVE rows."""
    ref, port = both_pages(_columns(seed), LIVE)
    rng = np.random.default_rng(seed + 7)
    live = np.zeros(CAP, bool)
    live[:LIVE] = rng.random(LIVE) < 0.85
    n = int(live.sum())
    return (
        dataclasses.replace(ref, live=jnp.asarray(live),
                            num_valid=jnp.asarray(n, jnp.int32)),
        dataclasses.replace(port, live=torch.from_numpy(live),
                            num_valid=torch.tensor(n, dtype=torch.int32)),
    )


#: (partition columns, order (column, descending, nulls_first) keys)
SPECS = {
    "part_order": (["pk"], [("ok", False, None)]),
    "two_parts_two_orders": (["pk2", "pk"], [("ok", True, True),
                                             ("x", False, None)]),
    "order_only": ([], [("ok", False, None)]),
    "part_only": (["pk"], []),
    "whole_page": ([], []),
}


def _calls(E, T, W, frame):
    c = lambda n: E.ColumnRef(n, T.parse_type(TYPES[n]))  # noqa: E731
    default = E.Literal(-7, T.BIGINT)
    calls = [
        W.WindowCall("row_number", None, "rn"),
        W.WindowCall("rank", None, "rk"),
        W.WindowCall("dense_rank", None, "dr"),
        W.WindowCall("ntile", None, "nt", offset=3),
        W.WindowCall("percent_rank", None, "pr"),
        W.WindowCall("cume_dist", None, "cd"),
        W.WindowCall("lag", c("x"), "lag1"),
        W.WindowCall("lag", c("x"), "lag2d", offset=2, default=default),
        W.WindowCall("lead", c("s"), "lead1"),
        W.WindowCall("lead", c("x"), "lead3d", offset=3, default=default),
        W.WindowCall("first_value", c("dec"), "fv"),
        W.WindowCall("last_value", c("s"), "lv"),
        W.WindowCall("nth_value", c("x"), "nv", offset=2),
    ]
    for func, arg in [("sum", "x"), ("sum", "f"), ("sum", "dec"),
                      ("count", "x"), ("count", None), ("avg", "x"),
                      ("avg", "f"), ("avg", "dec"), ("min", "x"),
                      ("max", "x"), ("min", "f"), ("max", "f"),
                      ("min", "s"), ("max", "dec")]:
        calls.append(W.WindowCall(
            func, None if arg is None else c(arg), f"{func}_{arg}",
            frame=frame,
        ))
    return calls


def _run(E, T, W, SortKey, page, spec, frame):
    parts, orders = SPECS[spec]
    c = lambda n: E.ColumnRef(n, T.parse_type(TYPES[n]))  # noqa: E731
    return W.window(
        page,
        [c(p) for p in parts],
        [SortKey(c(o), desc, nf) for o, desc, nf in orders],
        _calls(E, T, W, frame),
    )


@pytest.mark.parametrize("frame", ["range", "rows"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_window_matches_reference(spec, frame):
    ref_page, port_page = _masked_pages()
    ref = _run(RE, RT, RW, RSortKey, ref_page, spec, frame)
    port = _run(PE, PT, PW, PSortKey, port_page, spec, frame)
    # prefix form: the live rows come first, the count is the input's
    assert port.live is None
    assert int(port.num_valid) == int(port_page.num_valid)
    ref_cols = jax_live_columns(ref)
    port_cols = convert.page_to_numpy(port)
    # the rank lanes are int32 data in a BIGINT block, as the reference's
    for name in ("rn", "rk", "dr"):
        assert port_cols[name][0].dtype == np.int32
    assert_columns_equal(ref_cols, port_cols)


def test_row_number_breaks_ties_in_input_order():
    _, port_page = _masked_pages()
    c = lambda n: PE.ColumnRef(n, PT.parse_type(TYPES[n]))  # noqa: E731
    out = PW.window(port_page, [c("pk")], [PSortKey(c("ok"))],
                    [PW.WindowCall("row_number", None, "rn")])
    cols = convert.page_to_numpy(out)

    def equal_to_previous(name):
        # the sort lanes (null rank, then the stored value, which orders
        # NULLs among themselves in both packages) equal the last row's
        d, v = cols[name][0], cols[name][1]
        return (v[1:] == v[:-1]) & (d[1:] == d[:-1])

    # inside a run of equal sort lanes, the input order
    same = equal_to_previous("pk") & equal_to_previous("ok")
    rowid = cols["rowid"][0]
    assert same.sum() > 50  # the data has many ties
    assert (rowid[1:][same] > rowid[:-1][same]).all()
    assert (cols["rn"][0][1:][same] == cols["rn"][0][:-1][same] + 1).all()


# ------------------------------------------------- test_ops.py's shapes


def _from_pydict(data, types):
    rs = {k: RT.parse_type(t) for k, t in types.items()}
    ps = {k: PT.parse_type(t) for k, t in types.items()}
    from presto_tpu.page import Page as RPage
    from presto_tpu_torch.page import Page as PPage

    return (
        (RE, RW, RSortKey, RPage.from_pydict(data, rs, capacity=8), rs),
        (PE, PW, PSortKey,
         PPage.from_pydict(data, ps, capacity=8, device="cpu"), ps),
    )


OPS_SHAPES = {
    "row_number_rank": (
        {"g": ["x", "x", "x", "y", "y"], "v": [10, 10, 20, 5, 7]},
        {"g": "varchar", "v": "bigint"}, ["g"], ["v"],
        [("row_number", None), ("rank", None), ("dense_rank", None)],
    ),
    "partition_aggregate": (
        {"g": [1, 1, 2], "v": [10.0, 30.0, 5.0]},
        {"g": "bigint", "v": "double"}, ["g"], [], [("sum", "v")],
    ),
    "running_sum_with_peers": (
        {"g": [1, 1, 1, 1], "o": [1, 2, 2, 3], "v": [10, 20, 30, 40]},
        {"g": "bigint", "o": "bigint", "v": "bigint"}, ["g"], ["o"],
        [("sum", "v")],
    ),
    "running_min": (
        {"g": [1, 1, 2], "o": [1, 2, 1], "v": [5, 3, 9]},
        {"g": "bigint", "o": "bigint", "v": "bigint"}, ["g"], ["o"],
        [("min", "v")],
    ),
    "running_min_peer_sharing": (
        {"g": [1, 1], "o": [1, 1], "v": [5, 3]},
        {"g": "bigint", "o": "bigint", "v": "bigint"}, ["g"], ["o"],
        [("min", "v")],
    ),
    "running_min_null_frame": (
        {"g": [1, 1], "o": [1, 2], "v": [None, 5]},
        {"g": "bigint", "o": "bigint", "v": "bigint"}, ["g"], ["o"],
        [("min", "v")],
    ),
}


@pytest.mark.parametrize("shape", sorted(OPS_SHAPES))
def test_reference_operator_shapes(shape):
    data, types, parts, orders, calls = OPS_SHAPES[shape]
    outs = []
    for E, W, SortKey, page, schema in _from_pydict(data, types):
        c = lambda n: E.ColumnRef(n, schema[n])  # noqa: E731
        outs.append(W.window(
            page, [c(p) for p in parts], [SortKey(c(o)) for o in orders],
            [W.WindowCall(f, None if a is None else c(a), f"w{i}")
             for i, (f, a) in enumerate(calls)],
        ))
    assert outs[1].to_pylist() == outs[0].to_pylist()


# ----------------------------------------------------------- SQL level

_NAV_WINDOW = """
select o_orderkey,
  lag(o_totalprice) over (partition by o_custkey order by o_orderdate,
                          o_orderkey) as prev_price,
  lead(o_totalprice, 2) over (partition by o_custkey order by o_orderdate,
                              o_orderkey) as next2,
  first_value(o_orderkey) over (partition by o_custkey order by
                                o_orderdate, o_orderkey) as first_ok,
  ntile(4) over (partition by o_orderpriority order by o_totalprice,
                 o_orderkey) as quartile
from tpch.tiny.orders
where o_custkey <= 100
order by o_orderkey
"""

SQL = {
    # bench.py's window configuration (BASELINE.json's fifth)
    "bench_window": """
        select o_orderkey, o_custkey,
          row_number() over (partition by o_custkey order by o_orderdate)
            as rn,
          rank() over (partition by o_orderpriority order by o_totalprice)
            as rk
        from tpch.tiny.orders
    """,
    "navigation": _NAV_WINDOW,
    "lag_default": """
        select o_orderkey,
          lag(o_shippriority, 1, -1) over (partition by o_custkey
            order by o_orderdate, o_orderkey) as p
        from tpch.tiny.orders where o_custkey <= 50
        order by o_orderkey
    """,
    "last_value_frame": """
        select o_orderkey,
          last_value(o_orderkey) over (partition by o_custkey
            order by o_orderdate) as lv
        from tpch.tiny.orders where o_custkey <= 50
        order by o_orderkey
    """,
    "aggregates": """
        select o_orderkey,
          sum(o_totalprice) over (partition by o_orderstatus
            order by o_orderdate) as running,
          avg(o_totalprice) over (partition by o_orderpriority) as mean,
          count(*) over (partition by o_custkey) as n,
          max(o_orderdate) over (partition by o_custkey
            order by o_orderkey rows between unbounded preceding
            and current row) as latest,
          dense_rank() over (order by o_orderstatus) as st
        from tpch.tiny.orders where o_orderkey < 3000
        order by o_orderkey
    """,
    "window_over_aggregate": """
        select c_nationkey, sum(c_acctbal) as bal,
          rank() over (order by sum(c_acctbal) desc) as r
        from tpch.tiny.customer group by c_nationkey
        order by r, c_nationkey
    """,
}


@pytest.fixture(scope="module")
def runners():
    return RefRunner(), LocalQueryRunner(device="cpu")


@pytest.mark.parametrize("name", sorted(SQL))
def test_window_sql_matches_reference(runners, name):
    ref_runner, port_runner = runners
    ref = ref_runner.execute(SQL[name])
    port = port_runner.execute(SQL[name])
    assert port.columns == ref.columns
    assert_columns_equal(
        jax_live_columns(ref.page), convert.page_to_numpy(port.page)
    )
    assert len(port.rows()) > 0

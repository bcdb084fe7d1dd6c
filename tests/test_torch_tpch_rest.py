"""The port's third slice end to end: the TPC-H queries that need LIKE,
EXTRACT and the dictionary transforms (Q2, Q7, Q8, Q9, Q13, Q14, Q16,
Q20, Q22), and UNION ALL with the set operations and grouping sets the
planner builds on it, through ``presto_tpu_torch``'s
``LocalQueryRunner`` on the CPU against the JAX reference's runner over
the same tpch.tiny data.

As in tests/test_torch_tpch_joins.py, the reference runs each query
once and the port runs it under the default session, with whole-plan
execution (``max_fragment_weight=0``) and with dynamic filtering off.

The tpch generator gives every customer orders, so Q22's NOT EXISTS
keeps no row at tiny: Q22 also runs without that clause, which returns
all 7 country codes and holds the transformed key, its IN list and the
one-hot GROUP BY against a non-empty result."""

from __future__ import annotations

import functools

import pytest

from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu_torch import convert
from presto_tpu_torch.exec.local_runner import LocalQueryRunner
from presto_tpu_torch.session import Session
from tpch_queries import QUERIES
from torch_parity import assert_columns_equal, jax_live_columns

TPCH = [2, 7, 8, 9, 13, 14, 16, 20, 22]
#: the first slice's queries, which tests/test_torch_slice.py runs under
#: the default session only: with these all 22 run under all three
FIRST_SLICE = [1, 6]

Q22_NOT_EXISTS = """
    and not exists (
      select * from orders where o_custkey = c_custkey)
"""
assert Q22_NOT_EXISTS in QUERIES[22]

EXTRA = {
    "q22_without_not_exists": QUERIES[22].replace(Q22_NOT_EXISTS, "\n"),
    # UNION ALL (tests/test_union.py's shapes)
    "union_all_strings_cross_dict": (
        "select n_name as x from tpch.tiny.nation where n_nationkey < 3 "
        "union all select r_name from tpch.tiny.region order by x"
    ),
    "union_distinct": (
        "select n_regionkey as k from tpch.tiny.nation "
        "union select r_regionkey from tpch.tiny.region order by k"
    ),
    "union_joined_channels": (
        "select src, sum(rev) as total from ("
        "  select 1 as src, o_totalprice as rev from tpch.tiny.orders "
        "  where o_orderpriority = '1-URGENT'"
        "  union all "
        "  select 2 as src, l_extendedprice from tpch.tiny.lineitem "
        "  where l_shipmode = 'AIR') ch "
        "group by src order by src"
    ),
    # INTERSECT / EXCEPT: a tagged UNION ALL under a GROUP BY
    "intersect": (
        "select n_regionkey as k from tpch.tiny.nation "
        "intersect select r_regionkey from tpch.tiny.region "
        "where r_regionkey < 3 order by k"
    ),
    "except_strings": (
        "select n_name as x from tpch.tiny.nation "
        "except select n_name from tpch.tiny.nation "
        "where n_regionkey = 1 order by x"
    ),
    # grouping sets (tests/test_grouping_sets.py's shapes): one UNION ALL
    # term per set
    "rollup2": (
        "select l_returnflag, l_linestatus, sum(l_quantity) as s "
        "from tpch.tiny.lineitem "
        "group by rollup (l_returnflag, l_linestatus) order by 1, 2"
    ),
    "cube_grouping_fn": (
        "select l_returnflag, l_linestatus, "
        "grouping(l_returnflag, l_linestatus) as g, count(*) as c "
        "from tpch.tiny.lineitem "
        "group by cube (l_returnflag, l_linestatus) order by 1, 2, 3"
    ),
}

SESSIONS = {
    "default": {},
    "whole_plan": {"max_fragment_weight": 0},
    "no_dynamic_filtering": {"enable_dynamic_filtering": False},
}


def _sql(name):
    return QUERIES[name] if isinstance(name, int) else EXTRA[name]


@pytest.fixture(scope="module")
def reference():
    runner = RefRunner()

    @functools.lru_cache(maxsize=None)
    def run(name):
        res = runner.execute(_sql(name))
        return res.columns, jax_live_columns(res.page)

    return run


@pytest.fixture(scope="module")
def ports():
    return {
        k: LocalQueryRunner(device="cpu", session=Session(properties=p))
        for k, p in SESSIONS.items()
    }


@pytest.mark.parametrize("session", sorted(SESSIONS))
@pytest.mark.parametrize("name", FIRST_SLICE + TPCH + sorted(EXTRA), ids=str)
def test_query_matches_reference(reference, ports, name, session):
    ref_columns, ref_cols = reference(name)
    port = ports[session].execute(_sql(name))
    assert port.columns == ref_columns
    assert_columns_equal(ref_cols, convert.page_to_numpy(port.page))


def test_q22_without_not_exists_has_every_country_code(reference):
    _, cols = reference("q22_without_not_exists")
    ids, _, _, values = cols["cntrycode"]
    assert [str(values[i]) for i in ids] == [
        "13", "17", "18", "23", "29", "30", "31"
    ]
    assert len(reference(22)[1]["cntrycode"][0]) == 0  # see the docstring


@pytest.mark.parametrize("name", [22, "q22_without_not_exists"], ids=str)
def test_q22_groups_by_one_onehot_reduction(ports, monkeypatch, name):
    # GROUP BY substring(c_phone, 1, 2): the transformed dictionary
    # bounds the key (25 country codes), so the one-hot path takes it,
    # one onehot_reduce_many call for the whole aggregation
    from presto_tpu_torch.ops import aggregation as PA

    calls = []
    real = PA.onehot_reduce_many

    def spy(gid, requests, nseg):
        calls.append(nseg)
        return real(gid, requests, nseg)

    monkeypatch.setattr(PA, "onehot_reduce_many", spy)
    ports["default"].execute(_sql(name))
    assert calls == [25]

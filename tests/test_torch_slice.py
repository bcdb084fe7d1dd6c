"""The port's first slice end to end: SQL through
``presto_tpu_torch``'s ``LocalQueryRunner`` on the CPU against the JAX
reference's runner over the same tpch.tiny data."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu_torch import convert
from presto_tpu_torch.exec.local_runner import ExecutionError, LocalQueryRunner
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.plan.planner import plan_statement
from presto_tpu_torch.sql import parse_statement
from tpch_queries import QUERIES
from torch_parity import assert_columns_equal, jax_live_columns


def _tiny(sql: str) -> str:
    return sql.replace("from lineitem", "from tpch.tiny.lineitem")


SLICE_QUERIES = {
    "q1": _tiny(QUERIES[1]),
    "q6": _tiny(QUERIES[6]),
    "filter_project": """
        select l_orderkey, l_linenumber, l_extendedprice * (1 - l_discount)
          as net, l_shipdate, l_shipmode
        from tpch.tiny.lineitem
        where l_shipmode = 'AIR' and l_quantity < 3
        order by l_orderkey, l_linenumber
    """,
    "global_mix": """
        select count(*), min(l_shipdate), max(l_shipdate), avg(l_tax),
          sum(l_quantity), min(l_shipmode), max(l_extendedprice),
          var_samp(l_discount)
        from tpch.tiny.lineitem where l_returnflag <> 'N'
    """,
    "orders_group": """
        select o_orderpriority, o_orderstatus, count(*) as c,
          sum(o_totalprice) as total, min(o_orderdate) as first
        from tpch.tiny.orders
        where o_orderdate >= date '1995-01-01'
        group by o_orderpriority, o_orderstatus
        order by o_orderpriority, o_orderstatus
    """,
    "case_coalesce": """
        select l_returnflag,
          sum(case when l_discount > 0.05 then l_extendedprice else 0 end)
            as hi,
          count(*) as c
        from tpch.tiny.lineitem
        where not (l_linestatus = 'O') or l_tax between 0.02 and 0.04
        group by l_returnflag order by l_returnflag
    """,
}


@pytest.fixture(scope="module")
def runners():
    return RefRunner(), LocalQueryRunner(device="cpu")


@pytest.mark.parametrize("name", sorted(SLICE_QUERIES))
def test_query_matches_reference(runners, name):
    ref_runner, port_runner = runners
    sql = SLICE_QUERIES[name]
    ref = ref_runner.execute(sql)
    port = port_runner.execute(sql)
    assert port.columns == ref.columns
    assert_columns_equal(
        jax_live_columns(ref.page), convert.page_to_numpy(port.page)
    )
    assert len(port.rows()) == len(ref.rows()) > 0


def test_q1_result_is_host_resident_and_reuses_staged_table(runners):
    _, port_runner = runners
    port_runner.execute(SLICE_QUERIES["q1"])
    staged = dict(port_runner._tables)
    res = port_runner.execute(SLICE_QUERIES["q1"])
    assert port_runner._tables == staged  # the warm run staged nothing
    assert all(b.data.device.type == "cpu" for b in res.page.blocks)
    assert [r[:2] for r in res.rows()] == [
        ("A", "F"), ("N", "F"), ("N", "O"), ("R", "F")
    ]


def test_overflow_retry_rescales_max_groups(runners):
    ref_runner, port_runner = runners
    sql = SLICE_QUERIES["orders_group"]
    plan = plan_statement(
        parse_statement(sql), port_runner.catalogs, port_runner.session
    )

    def shrink(node):
        changes = {
            f.name: shrink(getattr(node, f.name))
            for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), N.PlanNode)
        }
        if isinstance(node, N.AggregationNode):
            changes["max_groups"] = 1
        return dataclasses.replace(node, **changes)

    small = dataclasses.replace(plan, root=shrink(plan.root))
    res = port_runner.execute_plan(small)
    ref = ref_runner.execute(sql)
    assert_columns_equal(
        jax_live_columns(ref.page), convert.page_to_numpy(res.page)
    )


@pytest.mark.parametrize(
    "sql",
    [
        "select count(*) from tpch.tiny.orders o join tpch.tiny.customer c "
        "on o.o_custkey = c.c_custkey",
        "select l_orderkey, count(*) from tpch.tiny.lineitem "
        "group by l_orderkey",
        "show tables",
    ],
)
def test_unported_plans_raise(runners, sql):
    _, port_runner = runners
    with pytest.raises((ExecutionError, NotImplementedError)):
        port_runner.execute(sql)


def test_runner_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalQueryRunner()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalQueryRunner(device="cuda")
    assert LocalQueryRunner(device="cpu").device == torch.device("cpu")

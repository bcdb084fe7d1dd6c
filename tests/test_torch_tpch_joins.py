"""The port's second slice end to end: TPC-H queries with joins, the
sorted GROUP BY, scalar subqueries and stage-at-a-time execution through
``presto_tpu_torch``'s ``LocalQueryRunner`` on the CPU, against the JAX
reference's runner over the same tpch.tiny data.

The reference runs each query once (a few seconds each here); the port
runs it with the default session, with whole-plan execution
(``max_fragment_weight=0``) and with dynamic filtering off, and every
run must give the reference's rows."""

from __future__ import annotations

import functools
import re

import pytest

from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu_torch import convert
from presto_tpu_torch.exec.local_runner import LocalQueryRunner
from presto_tpu_torch.session import Session
from presto_tpu_torch.utils.metrics import REGISTRY
from tpch_queries import QUERIES
from torch_parity import assert_columns_equal, jax_live_columns
from torch_parity import one_torch_thread  # noqa: F401

TPCH = [3, 4, 5, 10, 11, 12, 15, 17, 18, 19, 21]

EXTRA = {
    "full_outer": """
        select n_name, r_name
        from (select * from tpch.tiny.nation where n_nationkey < 5) n
          full outer join
          (select * from tpch.tiny.region where r_regionkey >= 2) r
          on n_regionkey = r_regionkey
        order by n_name, r_name
    """,
    "cross_join": """
        select r_name, count(*) as c, min(n_nationkey) as lo
        from tpch.tiny.region cross join tpch.tiny.nation
        group by r_name order by r_name
    """,
}

SESSIONS = {
    "default": {},
    "whole_plan": {"max_fragment_weight": 0},
    "no_dynamic_filtering": {"enable_dynamic_filtering": False},
}


#: statements for the root TopN's engagement checks
TOPN_EXTRA = {
    "topn_within_limit": """
        select n_name, n_regionkey from tpch.tiny.nation
        order by n_regionkey, n_name limit 25
    """,
    "scalar_subquery_topn": """
        select n_name, n_nationkey from tpch.tiny.nation
        where n_regionkey = (
            select r_regionkey from tpch.tiny.region
            order by r_name desc limit 1)
          or n_nationkey < 12
        order by n_name desc limit 4
    """,
}


def _sql(name):
    if isinstance(name, int):
        return QUERIES[name]
    return EXTRA[name] if name in EXTRA else TOPN_EXTRA[name]


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
@pytest.mark.parametrize("name", TPCH + sorted(EXTRA), ids=str)
def test_query_matches_reference(reference, ports, name, session):
    ref_columns, ref_cols = reference(name)
    port = ports[session].execute(_sql(name))
    assert port.columns == ref_columns
    assert_columns_equal(ref_cols, convert.page_to_numpy(port.page))


def test_fragments_and_dynamic_filters_run(ports):
    runner = ports["default"]
    before = (runner.fragments_run, runner.dynamic_filters_applied)
    runner.execute(QUERIES[5])
    assert runner.fragments_run > before[0]
    assert runner.dynamic_filters_applied > before[1]
    whole = ports["whole_plan"]
    n = whole.fragments_run
    whole.execute(QUERIES[5])
    assert whole.fragments_run == n == 0
    off = ports["no_dynamic_filtering"]
    off.execute(QUERIES[5])
    assert off.fragments_run > 0 and off.dynamic_filters_applied == 0


def test_q5_groups_by_one_onehot_reduction(ports, monkeypatch):
    # GROUP BY n_name has a 25-value dictionary: the one-hot path, one
    # onehot_reduce_many call for the whole aggregation
    from presto_tpu_torch.ops import aggregation as PA

    calls = []
    real = PA.onehot_reduce_many

    def spy(gid, requests, nseg):
        calls.append(nseg)
        return real(gid, requests, nseg)

    monkeypatch.setattr(PA, "onehot_reduce_many", spy)
    ports["default"].execute(QUERIES[5])
    assert calls == [25]


#: the statements whose root TopN keeps fewer rows than reach it at tiny
TOPN_ENGAGED = {3, 10, "scalar_subquery_topn"}


@pytest.mark.parametrize(
    "name", [3, 10, 2, 18, 21, 1, 6] + sorted(TOPN_EXTRA), ids=str
)
def test_root_topn_runs_on_the_device_only_over_its_limit(
    reference, ports, name
):
    # the statement's own root ORDER BY ... LIMIT k, and only it (a
    # scalar subquery's TopN runs inside its plan), runs on the device
    # when more than k rows reach it: one engagement, n - k rows not
    # copied; Q1 and Q6 (no limit) and a TopN over at most k rows keep
    # the host sort alone. Every statement gives the reference's rows
    sql = _sql(name).strip()
    runner = ports["default"]
    runs = REGISTRY.counter("root_topn.device")
    cut = REGISTRY.counter("root_topn.rows_cut")
    before = (runs.total, cut.total)
    port = runner.execute(sql)
    moved = (runs.total - before[0], cut.total - before[1])
    ref_columns, ref_cols = reference(name)
    assert port.columns == ref_columns
    assert_columns_equal(ref_cols, convert.page_to_numpy(port.page))
    tail = re.search(r"\blimit\s+(\d+)$", sql)
    if tail is None:
        assert name not in TOPN_ENGAGED and moved == (0, 0)
        return
    k = int(tail.group(1))
    n = len(runner.execute(sql[: tail.start()]).rows())
    assert (n > k) == (name in TOPN_ENGAGED), (n, k)
    assert moved == ((1, n - k) if n > k else (0, 0))

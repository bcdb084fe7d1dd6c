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

import pytest

from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu_torch import convert
from presto_tpu_torch.exec.local_runner import LocalQueryRunner
from presto_tpu_torch.session import Session
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

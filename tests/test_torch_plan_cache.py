"""The port's statement-level plan cache (``plan/canonical.py``) and the
statements ``LocalQueryRunner.execute`` dispatches, against the JAX
reference on the CPU.

Canonical keys must be equal across literal variants and across the two
packages; dtype boundaries key separate entries, string literals stay
distinct and a NULL literal is not parameterized. All 22 TPC-H queries
at tiny give the same rows with the cache on, with it off and in the
reference (exact, doubles within rel 1e-9), and none falls back to the
literal-form lane. A repeated query shape and a warm ``EXECUTE`` are
cache hits that plan nothing. ``PREPARE``/``EXECUTE``/``DEALLOCATE`` and
``SET``/``SHOW SESSION``, ``SHOW SCHEMAS``/``TABLES``/``COLUMNS`` give the
reference's results and error messages.
"""

from __future__ import annotations

import functools
import re

import pytest

from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu.plan import canonical as ref_canonical
from presto_tpu.sql import parse_statement as ref_parse
from presto_tpu_torch import convert, queries_tpcds
from presto_tpu_torch.exec.local_runner import ExecutionError, LocalQueryRunner
from presto_tpu_torch.plan import canonical
from presto_tpu_torch.plan.planner import plan_statement
from presto_tpu_torch.sql import parse_statement
from presto_tpu_torch.utils.metrics import REGISTRY
from tpch_queries import QUERIES
from torch_parity import assert_columns_equal, jax_live_columns
from torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def runner():
    return LocalQueryRunner(device="cpu")


@pytest.fixture(scope="module")
def runner_off():
    r = LocalQueryRunner(device="cpu")
    r.session.set("enable_plan_cache", "false")
    return r


@pytest.fixture(scope="module")
def reference():
    ref = RefRunner()

    @functools.lru_cache(maxsize=None)
    def run(sql):
        res = ref.execute(sql)
        return res.columns, jax_live_columns(res.page)

    return run


def _key(pkg_canonical, parse, runner, sql):
    return pkg_canonical.canonicalize_statement(parse(sql), runner.session)


def _count_planning(monkeypatch, runner):
    calls = []
    real = runner._plan_statement

    def counted(stmt):
        calls.append(stmt)
        return real(stmt)

    monkeypatch.setattr(runner, "_plan_statement", counted)
    return calls


# ------------------------------------------------------- canonical form


def test_canonical_key_equal_across_literals_and_packages(runner):
    q = (
        "select l_returnflag, count(*) c from tpch.tiny.lineitem "
        "where l_quantity < {} and l_shipdate >= date '{}' "
        "group by l_returnflag"
    )
    ref = RefRunner()
    keys, values = [], []
    for v, d in ((24, "1995-01-01"), (30, "1996-06-30")):
        k, _, lits = _key(canonical, parse_statement, runner, q.format(v, d))
        rk, _, rlits = _key(ref_canonical, ref_parse, ref, q.format(v, d))
        assert k == rk
        assert [(x.value, str(x.dtype)) for x in lits] == [
            (x.value, str(x.dtype)) for x in rlits
        ]
        keys.append(k)
        values.append([x.value for x in lits])
    assert keys[0] == keys[1]
    assert values[0] != values[1]


def test_hoisted_plan_fingerprint_equal_across_literals(runner):
    q = (
        "select l_returnflag, count(*) c from tpch.tiny.lineitem "
        "where l_quantity < {} group by l_returnflag"
    )
    roots, vals = [], []
    for v in (24, 30):
        plan = plan_statement(
            parse_statement(q.format(v)), runner.catalogs, runner.session
        )
        croot, pvals = canonical.hoist_params(plan.root)
        roots.append(croot)
        vals.append([int(x) for x in pvals])
    assert roots[0].fingerprint() == roots[1].fingerprint()
    assert vals[0] != vals[1]


def test_bind_literal_root_removes_every_slot(runner):
    q = "select count(*) c from tpch.tiny.orders where o_totalprice < 1000"
    _, canon, lits = _key(canonical, parse_statement, runner, q)
    plan = plan_statement(canon, runner.catalogs, runner.session)
    assert "RuntimeParam" in repr(plan.root)
    bound = {i: lit for i, lit in enumerate(lits)}
    lroot = canonical.bind_literal_root(plan.root, bound)
    assert "RuntimeParam" not in repr(lroot)
    assert "Literal(value=1000" in repr(lroot)
    mplan = canonical.materialize_plan(
        canonical._with_bound(plan, bound)
    )
    assert mplan.bound_values is None and "RuntimeParam" not in repr(
        mplan.root)


def test_dtype_boundary_params_bucket_separately(runner):
    q = "select count(*) c from tpch.tiny.orders where o_totalprice < {}"
    k1, _, _ = _key(canonical, parse_statement, runner, q.format("100000"))
    k2, _, _ = _key(canonical, parse_statement, runner, q.format("100000.5"))
    k3, _, _ = _key(canonical, parse_statement, runner, q.format("200000"))
    assert k1 != k2
    assert k1 == k3


def test_statement_key_string_literals_stay_distinct(runner):
    q = (
        "select count(*) c from tpch.tiny.orders "
        "where o_orderpriority = '{}'"
    )
    k1, _, v1 = _key(canonical, parse_statement, runner, q.format("1-URGENT"))
    k2, _, _ = _key(canonical, parse_statement, runner, q.format("2-HIGH"))
    assert k1 != k2
    assert v1 == []


def test_null_literal_not_parameterized(runner, runner_off, reference):
    q = (
        "select count(*) c from tpch.tiny.orders "
        "where o_custkey = null or o_totalprice < 100000"
    )
    _, _, lits = _key(canonical, parse_statement, runner, q)
    assert [x.value for x in lits] == [100000]  # only the number
    assert runner.execute(q).rows() == runner_off.execute(q).rows()
    _, ref_cols = reference(q)
    assert_columns_equal(
        ref_cols, convert.page_to_numpy(runner.execute(q).page)
    )


# ---------------------------------------------- on/off/reference equality

_EQUIV_QUERIES = [
    # range filter + aggregation + decimal projection arithmetic
    "select l_returnflag, count(*) c, sum(l_extendedprice * (1 - "
    "l_discount)) rev from tpch.tiny.lineitem where l_quantity < 24 "
    "group by l_returnflag order by l_returnflag",
    # BETWEEN over decimals + date comparison
    "select count(*) c from tpch.tiny.lineitem where l_discount "
    "between 0.05 and 0.07 and l_shipdate < date '1996-01-01'",
    # IN list over integers (hoisted members), negated IN, a negative
    # literal
    "select count(*) c from tpch.tiny.lineitem where l_linenumber in "
    "(1, 2, 3) and l_suppkey not in (5, 7) and l_quantity > -5",
    # string equality + LIKE stay constants beside hoisted numerics
    "select count(*) c from tpch.tiny.orders where o_orderpriority = "
    "'1-URGENT' and o_comment like '%special%' and o_totalprice < "
    "150000.5",
    # join + HAVING (the Q18 shape, scaled down)
    "select o_orderkey, sum(l_quantity) q from tpch.tiny.orders, "
    "tpch.tiny.lineitem where o_orderkey = l_orderkey and "
    "o_totalprice > 400000 group by o_orderkey having "
    "sum(l_quantity) > 250 order by q desc limit 5",
    # scalar subquery (hoisting inside the subquery's WHERE too)
    "select count(*) c from tpch.tiny.part where p_retailprice > "
    "(select avg(p_retailprice) from tpch.tiny.part where p_size < 25)",
    # a hoisted divisor: the division keeps its zero guard
    "select count(*) c from tpch.tiny.lineitem "
    "where l_extendedprice / 2 > 50000",
]


@pytest.mark.parametrize("qi", range(len(_EQUIV_QUERIES)))
def test_on_off_reference_equivalence(runner, runner_off, reference, qi):
    q = _EQUIV_QUERIES[qi]
    on = runner.execute(q)
    assert on.rows() == runner_off.execute(q).rows()
    ref_columns, ref_cols = reference(q)
    assert on.columns == ref_columns
    assert_columns_equal(ref_cols, convert.page_to_numpy(on.page))
    assert runner.literal_form_reruns == 0


@pytest.fixture(scope="module")
def tpch_runners():
    on = LocalQueryRunner(device="cpu")
    off = LocalQueryRunner(device="cpu")
    off.session.set("enable_plan_cache", False)
    return on, off


@pytest.mark.parametrize("n", sorted(QUERIES))
def test_tpch_cache_on_off_and_reference_agree(tpch_runners, reference, n):
    on, off = tpch_runners
    sql = QUERIES[n]
    res_on = on.execute(sql)
    # the second run of the shape is a hit and gives the same rows
    hits = on.plan_cache.stats()["hits"]
    again = on.execute(sql)
    assert on.plan_cache.stats()["hits"] == hits + 1
    res_off = off.execute(sql)
    got = convert.page_to_numpy(res_on.page)
    assert_columns_equal(convert.page_to_numpy(res_off.page), got, rtol=0.0)
    assert_columns_equal(convert.page_to_numpy(again.page), got, rtol=0.0)
    ref_columns, ref_cols = reference(sql)
    assert res_on.columns == ref_columns
    assert_columns_equal(ref_cols, got)
    assert on.literal_form_reruns == 0
    assert off.plan_cache.stats()["entries"] == 0


def test_repeated_shape_hits_and_plans_nothing(monkeypatch):
    r = LocalQueryRunner(device="cpu")
    q = "select count(*) c from tpch.tiny.nation where n_regionkey < {}"
    assert r.execute(q.format(2)).rows() == [(10,)]
    planned = _count_planning(monkeypatch, r)
    assert r.execute(q.format(4)).rows() == [(20,)]
    assert planned == []
    hist = {s.sql: s for s in r.history.snapshot()}
    assert hist[q.format(2)].plan_cache_hit is False
    assert hist[q.format(4)].plan_cache_hit is True
    assert hist[q.format(4)].planning_ms >= 0.0
    assert r.plan_cache.stats() == {
        "entries": 1, "capacity": 256, "hits": 1, "misses": 1,
        "evictions": 0, "replans": 0,
    }


def test_canonicalize_ms_metric_recorded(runner):
    runner.execute("select count(*) c from tpch.tiny.region")
    names = [n for n, _k, _v in REGISTRY.snapshot()]
    assert any(n.startswith("plan.canonicalize_ms") for n in names)


def test_cache_off_plans_per_variant(monkeypatch):
    r = LocalQueryRunner(device="cpu")
    r.session.set("enable_plan_cache", "false")
    q = "select count(*) c from tpch.tiny.nation where n_nationkey < {}"
    r.execute(q.format(5))
    planned = _count_planning(monkeypatch, r)
    r.execute(q.format(9))
    assert len(planned) == 1
    assert r.plan_cache.stats()["entries"] == 0


def test_unplannable_canonical_form_takes_the_bypass_lane(monkeypatch):
    """A shape whose parameterized form cannot plan is marked BYPASS and
    plans with its literals from then on (never a failed query)."""
    r = LocalQueryRunner(device="cpu")
    real = r._plan_statement

    def refuse_bound(stmt):
        if "BoundParam" in repr(stmt):
            raise RuntimeError("a hoisted literal in a structural spot")
        return real(stmt)

    monkeypatch.setattr(r, "_plan_statement", refuse_bound)
    q = "select count(*) c from tpch.tiny.region where r_regionkey < {}"
    assert r.execute(q.format(3)).rows() == [(3,)]
    assert r.execute(q.format(2)).rows() == [(2,)]
    st = r.plan_cache.stats()
    assert st["entries"] == 0 and st["hits"] == 0 and st["misses"] == 2


def test_literal_form_lane_reruns_a_failing_parameterized_plan(monkeypatch):
    """A RuntimeParam that an operator cannot take re-runs the plan with
    its values bound back as Literals, as the reference's lane does."""
    from presto_tpu_torch import expr as E

    real = E.ExprLowerer._eval_runtimeparam

    def refuse(self, e):
        raise NotImplementedError("an operator that needs the value")

    q = "select count(*) c from tpch.tiny.region where r_regionkey < 3"
    r = LocalQueryRunner(device="cpu")
    monkeypatch.setattr(E.ExprLowerer, "_eval_runtimeparam", refuse)
    assert r.execute(q).rows() == [(3,)]
    assert r.literal_form_reruns == 1
    monkeypatch.setattr(E.ExprLowerer, "_eval_runtimeparam", real)
    assert r.execute(q).rows() == [(3,)]
    assert r.literal_form_reruns == 1


# --------------------------------------------- PREPARE/EXECUTE fast lane


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the message is compared
        return str(e)
    raise AssertionError("no error")


def test_execute_warm_is_a_hit_that_plans_nothing(monkeypatch, reference):
    r = LocalQueryRunner(device="cpu")
    ref = RefRunner()
    prep = (
        "prepare pc_t1 from select count(*) c from tpch.tiny.orders "
        "where o_totalprice < ? and o_orderdate >= ?"
    )
    assert r.execute(prep).rows() == ref.execute(prep).rows() == [
        ("PREPARE",)
    ]
    cold = "execute pc_t1 using 100000, date '1995-01-01'"
    assert r.execute(cold).rows() == ref.execute(cold).rows()
    planned = _count_planning(monkeypatch, r)
    for args in ("150000, date '1994-01-01'", "250000.5, date '1996-06-01'"):
        hits = r.plan_cache.stats()["hits"]
        res = r.execute(f"execute pc_t1 using {args}")
        # a new dtype (decimal(7,1)) keys its own entry: that one plans
        assert r.plan_cache.stats()["hits"] == hits + (
            0 if "." in args else 1
        )
        ref_cols = reference(
            "select count(*) c from tpch.tiny.orders where o_totalprice < "
            f"{args.split(', ')[0]} and o_orderdate >= "
            f"{args.split(', ')[1]}"
        )[1]
        assert_columns_equal(ref_cols, convert.page_to_numpy(res.page))
    assert len(planned) == 1  # only the decimal variant planned


def test_prepare_execute_deallocate_errors_match_reference():
    r = LocalQueryRunner(device="cpu")
    ref = RefRunner()
    prep = (
        "prepare pc_t2 from select count(*) c from tpch.tiny.region "
        "where r_regionkey < ?"
    )
    for runner in (r, ref):
        runner.execute(prep)
    for sql in ("execute pc_t2 using 1, 2", "execute nope using 1",
                "deallocate prepare nope"):
        assert _error(lambda: r.execute(sql)) == _error(
            lambda: ref.execute(sql)
        ), sql
    assert r.execute("deallocate prepare pc_t2").rows() == ref.execute(
        "deallocate prepare pc_t2").rows() == [("DEALLOCATE",)]
    assert _error(lambda: r.execute("execute pc_t2 using 1")) == _error(
        lambda: ref.execute("execute pc_t2 using 1")
    )
    assert "not found" in _error(lambda: r.execute("execute pc_t2 using 1"))


def test_lru_eviction_bounded_entries():
    r = LocalQueryRunner(device="cpu", plan_cache_entries=2)
    ev0 = int(REGISTRY.counter("plan.cache_evict").total)
    qs = [
        "select count(*) c from tpch.tiny.region where r_regionkey < 3",
        "select count(*) c from tpch.tiny.nation where n_nationkey < 7",
        "select r_name from tpch.tiny.region where r_regionkey = 1",
    ]
    for q in qs:
        r.execute(q)
    assert r.plan_cache.stats()["entries"] <= 2
    assert r.plan_cache.stats()["evictions"] == 1
    assert int(REGISTRY.counter("plan.cache_evict").total) > ev0
    assert r.execute(qs[0]).rows() == [(3,)]  # evicted shapes replan


def test_write_statements_raise_with_their_names():
    """The write statements run in the port (tests/test_torch_writes.py);
    against the read-only tpch catalog each is refused with the
    reference's message, directly and through EXECUTE."""
    r, ref = LocalQueryRunner(device="cpu"), RefRunner()
    for sql, msg in (
        ("insert into tpch.tiny.region values (9, 'X', 'y')",
         "catalog tpch is read-only"),
        ("create table t (x bigint)", "catalog tpch is read-only"),
        ("drop table t", "catalog tpch does not support DROP TABLE"),
        ("delete from tpch.tiny.region", "catalog tpch does not support DELETE"),
    ):
        with pytest.raises(ExecutionError, match=msg):
            r.execute(sql)
        with pytest.raises(Exception, match=msg):
            ref.execute(sql)
    r.execute("prepare w from insert into tpch.tiny.region values (?, 'X', 'y')")
    with pytest.raises(ExecutionError, match="catalog tpch is read-only"):
        r.execute("execute w using 9")


# ------------------------------------------------ session and metadata


@pytest.mark.parametrize(
    "sql",
    [
        "show session",
        "show schemas",
        "show schemas from tpcds",
        "show tables",
        "show columns from tpch.tiny.lineitem",
        "describe orders",
        "show columns from tiny.nation",
    ],
)
def test_metadata_statements_match_reference(sql):
    r, ref = LocalQueryRunner(device="cpu"), RefRunner()
    got, want = r.execute(sql), ref.execute(sql)
    assert got.columns == want.columns
    assert got.rows() == want.rows()


def test_set_session_matches_reference():
    r, ref = LocalQueryRunner(device="cpu"), RefRunner()
    for runner in (r, ref):
        assert runner.execute(
            "set session max_fragment_weight = 7"
        ).rows() == [("SET SESSION",)]
        assert runner.session.get("max_fragment_weight") == 7
    assert r.execute("show session").rows() == ref.execute(
        "show session").rows()
    bad = "set session no_such_property = 1"
    assert re.sub(r"\s+", " ", _error(lambda: r.execute(bad))) == re.sub(
        r"\s+", " ", _error(lambda: ref.execute(bad)))


TPCDS = {
    "Q64": queries_tpcds.Q64,
    "Q95": queries_tpcds.Q95,
    **{f"breadth_{k}": v for k, v in queries_tpcds.BREADTH.items()},
}


@pytest.fixture(scope="module")
def tpcds_runners():
    on = LocalQueryRunner(device="cpu")
    off = LocalQueryRunner(device="cpu")
    off.session.set("enable_plan_cache", False)
    return on, off


@pytest.mark.parametrize("name", sorted(TPCDS))
def test_tpcds_cache_on_equals_off(tpcds_runners, name):
    """TPC-DS with its date, decimal and IN-list literals hoisted gives
    the rows of the literal plan, and never needs the literal-form
    lane. The whole corpus runs with the cache on in
    tests/test_torch_tpcds.py, against the oracle."""
    on, off = tpcds_runners
    got = on.execute(TPCDS[name])
    want = off.execute(TPCDS[name])
    assert got.columns == want.columns
    assert_columns_equal(
        convert.page_to_numpy(want.page), convert.page_to_numpy(got.page),
        rtol=0.0,
    )
    assert on.literal_form_reruns == 0

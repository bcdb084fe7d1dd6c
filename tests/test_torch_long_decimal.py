"""Long decimals (p > 18, int128 limb pairs) through both runners on
the CPU: the SQL of the reference's ``tests/test_long_decimal.py`` over
the same 3,000 values, loaded into identical memory tables (the
reference's file reads them from parquet), row for row, and its
documented gates, which raise in both. Decimals compare exactly, as
``decimal.Decimal``; doubles within rel 1e-9."""

from __future__ import annotations

import decimal

import numpy as np
import pytest

from presto_tpu import page as RP
from presto_tpu import types as RT
from presto_tpu_torch import page as PP
from presto_tpu_torch import types as PT
from test_torch_arrays import assert_both_raise, assert_parity, both_runners
from torch_parity import one_torch_thread  # noqa: F401


def _lake_values():
    """The reference file's values: |unscaled| up to ~4e28, straddling
    the int64 boundary, at scale 3."""
    n = 3000
    rng = np.random.RandomState(17)
    base = rng.randint(-(1 << 62), 1 << 62, n)
    mult = rng.choice([1, 1 << 20, (1 << 33) + 3], n)
    return [
        decimal.Decimal(int(x) * int(m)).scaleb(-3)
        for x, m in zip(base, mult)
    ]


GROUP_VALUES = [
    decimal.Decimal("123456789012345678901.01"),
    None,
    decimal.Decimal("123456789012345678901.01"),
    decimal.Decimal("-0.02"),
    None,
    None,
]


@pytest.fixture(scope="module")
def runners():
    vals = _lake_values()
    return both_runners({
        ("s", "t"): (
            lambda T: {"id": T.BIGINT, "amt": T.decimal(30, 3)},
            lambda: {"id": list(range(len(vals))), "amt": vals},
        ),
        ("s", "g"): (
            lambda T: {"x": T.decimal(25, 2)},
            lambda: {"x": GROUP_VALUES},
        ),
    })


def test_page_roundtrip_exact():
    vals = [
        decimal.Decimal("123456789012345678901234567.89"),
        decimal.Decimal("-99999999999999999999.99"),
        None,
        decimal.Decimal("0.01"),
    ]
    for P, T in ((RP, RT), (PP, PT)):
        kw = {} if P is RP else {"device": "cpu"}
        p = P.Page.from_pydict({"x": vals}, {"x": T.decimal(30, 2)},
                               capacity=8, **kw)
        assert [r["x"] for r in p.to_pylist()] == vals


BIG = decimal.Decimal(1 << 70).scaleb(-3)

LONG_SQL = {
    "cast_downscale_and_to_bigint": (
        "select cast(cast(123.456 as decimal(30,6)) as decimal(10,2)) "
        "as a, cast(cast(987654321.987 as decimal(25,3)) as bigint) as b, "
        "cast(cast(-2.5 as decimal(20,1)) as bigint) as c"
    ),
    "scan_count_and_filter": (
        "select count(*) as n from mem.s.t where amt > 0"
    ),
    "compare_wider_than_int64_literal": (
        f"select count(*) as n from mem.s.t where amt > {BIG}"
    ),
    "projection_exact_roundtrip": (
        "select id, amt from mem.s.t where id < 50"
    ),
    "arithmetic_exact": (
        "select id, amt + amt as dbl, amt - amt as zero, -amt as neg "
        "from mem.s.t where id < 20"
    ),
    "literal_arithmetic_exact": (
        "select 12345678901234567890.12 + 98765432109876543210.88 as s"
    ),
    "cast_to_double": (
        "select id, cast(amt as double) as d from mem.s.t where id < 10"
    ),
    "cast_short_to_long_and_back": (
        "select cast(cast(12345.67 as decimal(30,4)) as double) as d"
    ),
    "group_by_long_decimal": (
        "select amt, count(*) as n from mem.s.t group by amt"
    ),
    "group_by_long_decimal_with_nulls": (
        "select x, count(*) as n from mem.s.g group by x"
    ),
    "order_by_long_decimal": (
        "select id, amt from mem.s.t order by amt desc, id limit 50"
    ),
    "device_topn_on_long_decimal": (
        "select id, amt from (select id, amt from mem.s.t "
        "order by amt, id limit 20) s order by id"
    ),
    "distinct_long_decimal": (
        "select distinct amt from mem.s.t where id < 100"
    ),
    "inner_join_on_long_decimal": (
        "select a.id, b.id from mem.s.t a, mem.s.t b "
        "where a.amt = b.amt and a.id < 30 and b.id < 30"
    ),
    "long_plus_double_is_double": (
        "select id, amt + 0.5e0 as s from mem.s.t where id < 5"
    ),
    "case_over_long_decimal": (
        "select id, case when id < 2 then amt else -amt end as v "
        "from mem.s.t where id < 4"
    ),
    "coalesce_and_multiply": (
        "select id, coalesce(case when id % 2 = 0 then amt end, "
        "cast(id as decimal(30,3))) * 3 as v from mem.s.t where id < 8"
    ),
    "unnest_page_with_long_decimal_column": (
        "select id, amt, m from mem.s.t "
        "cross join unnest(array[1, 2]) as u(m) where id < 3"
    ),
    "join_on_long_decimal_count": (
        "select count(*) as n from mem.s.t a, mem.s.t b "
        "where a.amt = b.amt"
    ),
    "element_at_negative_index": (
        "select element_at(array[10, 20, 30], -1) as a, "
        "array[10, 20, 30][-2] as b, element_at(array[10, 20], -5) as c"
    ),
    "element_at_negative_column_index": (
        "select r_regionkey, element_at(array[100, 200], r_regionkey - 3) "
        "as e from tpch.tiny.region order by r_regionkey"
    ),
    "aggregate_after_cast_down": (
        "select sum(cast(amt as double)) as s from mem.s.t"
    ),
    "tpch_filter_on_long_sum": (
        "select count(*) from tpch.tiny.lineitem where "
        "cast(l_extendedprice as decimal(30,2)) + cast(l_tax as "
        "decimal(30,2)) > 50000.05"
    ),
    "tpch_group_by_long_cast": (
        "select cast(l_extendedprice as decimal(25,2)) as p, count(*) as n "
        "from tpch.tiny.lineitem group by 1 order by n desc, p limit 100"
    ),
    "tpch_order_by_long_difference": (
        "select l_orderkey, l_linenumber, cast(l_extendedprice as "
        "decimal(30,2)) - cast(l_discount as decimal(30,2)) as v "
        "from tpch.tiny.lineitem order by v desc, l_orderkey, l_linenumber "
        "limit 100"
    ),
}


@pytest.mark.parametrize("sql", list(LONG_SQL.values()), ids=list(LONG_SQL))
def test_long_decimal_sql_matches_reference(runners, sql):
    assert_parity(
        runners, sql, ordered="order by" in sql or "group by" not in sql
    )


@pytest.mark.parametrize(
    "sql",
    [
        "select sum(amt) from mem.s.t",
        "select id from mem.s.t where amt in "
        "(select amt from mem.s.t where id < 5)",
    ],
    ids=["sum_accumulator", "semi_join_key"],
)
def test_documented_gates_raise_in_both(runners, sql):
    assert_both_raise(runners, sql, "long")

"""Physical ARRAY columns and global order statistics through both
runners on the CPU: the SQL of the reference's ``tests/test_arrays.py``
over identically loaded memory connectors (``append_rows``; the port
does not run INSERT yet), row for row against the reference, and its
gates, which raise in both.

``both_runners`` is shared with the map/row, unnest and long-decimal
parity files."""

from __future__ import annotations

import math

import numpy as np
import pytest

from presto_tpu import types as RT
from presto_tpu.connectors import create_connector as ref_connector
from presto_tpu.connectors.spi import TableHandle as RefHandle
from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu.exec.staging import CatalogManager as RefCatalogs
from presto_tpu_torch import types as PT
from presto_tpu_torch.connectors import create_connector
from presto_tpu_torch.connectors.spi import TableHandle
from presto_tpu_torch.exec.local_runner import LocalQueryRunner
from presto_tpu_torch.exec.staging import CatalogManager, obj_array
from torch_parity import one_torch_thread  # noqa: F401

#: DOUBLE results agree within this relative tolerance
REL = 1e-9


def both_runners(tables):
    """(reference, port) runners over tpch and a ``mem`` memory catalog
    loaded with ``tables``: {(schema, table): (types_fn, rows_fn)}, where
    ``types_fn(T)`` gives the column types in a package's ``types`` and
    ``rows_fn()`` the columns as lists of Python values."""
    out = []
    for T, connector, Handle, Catalogs, runner in (
        (RT, ref_connector, RefHandle, RefCatalogs, RefRunner),
        (PT, create_connector, TableHandle, CatalogManager, LocalQueryRunner),
    ):
        catalogs = Catalogs()
        catalogs.register("tpch", connector("tpch"))
        mem = connector("memory")
        catalogs.register("mem", mem)
        for (schema, table), (types_fn, rows_fn) in tables.items():
            h = Handle("mem", schema, table)
            mem.create_table(h, types_fn(T))
            mem.append_rows(
                h, {c: obj_array(v) for c, v in rows_fn().items()}
            )
        kw = {} if runner is RefRunner else {"device": "cpu"}
        out.append(runner(catalogs=catalogs, **kw))
    return tuple(out)


def append_both(runners, schema: str, table: str, types_fn, rows):
    """Load ``rows`` (tuples) into a new memory table of both runners:
    what CREATE TABLE AS does, by ``append_rows``."""
    for runner, T, Handle in zip(runners, (RT, PT), (RefHandle, TableHandle)):
        mem = runner.catalogs.get("mem")
        h = Handle("mem", schema, table)
        types = types_fn(T)
        mem.create_table(h, types)
        mem.append_rows(
            h,
            {
                c: obj_array([r[i] for r in rows])
                for i, c in enumerate(types)
            },
        )


def same_value(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=REL) or (a != a and b != b)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(map(same_value, a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same_value(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def assert_same_rows(got, want, ordered: bool = True):
    """Row lists equal (in order, or as multisets); doubles within
    ``REL``, everything else exactly, Python types included."""
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert same_value(g, w), (g, w)


def assert_parity(runners, sql: str, ordered: bool = True):
    ref, port = runners
    want = ref.execute(sql).rows()
    assert_same_rows(port.execute(sql).rows(), want, ordered)
    return want


def assert_both_raise(runners, sql: str, needle: str = ""):
    """Both runners raise, with ``needle`` in both messages, and the
    same exception class name."""
    names = []
    for runner in runners:
        with pytest.raises(Exception) as ei:
            runner.execute(sql).rows()
        assert needle.lower() in str(ei.value).lower(), (sql, ei.value)
        names.append(type(ei.value).__name__)
    assert names[0] == names[1], (sql, names)


ARRAY_TABLES = {
    ("default", "t"): (
        lambda T: {"id": T.INTEGER, "arr": T.array(T.BIGINT)},
        lambda: {"id": [1, 2, 3, 4], "arr": [[10, 20, 30], [5], None, []]},
    ),
    ("default", "s"): (
        lambda T: {"id": T.INTEGER, "tags": T.array(T.VARCHAR)},
        lambda: {"id": [1, 2], "tags": [["x", "y"], ["y"]]},
    ),
}


@pytest.fixture(scope="module")
def runners():
    return both_runners(ARRAY_TABLES)


ARRAY_SQL = {
    "store_scan_roundtrip": "select id, arr from mem.default.t order by id",
    "cardinality_and_subscript": (
        "select id, cardinality(arr), element_at(arr, 2), arr[1], "
        "element_at(arr, -1) from mem.default.t order by id"
    ),
    "unnest_with_ordinality": (
        "select id, e, o from mem.default.t "
        "cross join unnest(arr) with ordinality as u(e, o) order by id, o"
    ),
    "unnest_feeds_aggregation": (
        "select sum(e) as s, count(*) as c from mem.default.t "
        "cross join unnest(arr) as u(e)"
    ),
    "filter_preserves_arrays": (
        "select id, arr from mem.default.t where id >= 2 order by id"
    ),
    "array_agg_grouped": (
        "select id % 2 as g, array_agg(id) as a from mem.default.t "
        "group by 1 order by g"
    ),
    "array_agg_global": "select array_agg(id) from mem.default.t",
    "varchar_arrays": (
        "select id, tags, cardinality(tags), tags[2] "
        "from mem.default.s order by id"
    ),
    "varchar_unnest_group": (
        "select e, count(*) as c from mem.default.s "
        "cross join unnest(tags) as u(e) group by e order by e"
    ),
    "array_agg_from_tpch": (
        "select r_regionkey, array_agg(n_nationkey) as ks "
        "from tpch.tiny.nation join tpch.tiny.region "
        "on n_regionkey = r_regionkey "
        "group by r_regionkey order by r_regionkey"
    ),
    "array_agg_orders_unordered": (
        "select o_custkey, array_agg(o_orderkey) from tpch.tiny.orders "
        "group by o_custkey"
    ),
    "array_agg_strings_and_nulls": (
        "select o_orderstatus, array_agg(case when o_orderkey % 3 = 0 "
        "then null else o_orderpriority end) from tpch.tiny.orders "
        "where o_orderkey < 200 group by o_orderstatus order by 1"
    ),
    "array_agg_then_unnest": (
        "select count(*), sum(e) from (select l_orderkey, "
        "array_agg(l_partkey) as a from tpch.tiny.lineitem "
        "group by l_orderkey) t cross join unnest(a) as u(e)"
    ),
    "array_agg_cardinality_first": (
        "select count(*), sum(cardinality(a)), sum(element_at(a, 1)), "
        "max(cardinality(a)) from (select l_orderkey, "
        "array_agg(l_linenumber) as a from tpch.tiny.lineitem "
        "group by l_orderkey) t"
    ),
    "subscript_through_topn": (
        "select id, arr[1] from (select id, arr from mem.default.t "
        "where arr is not null order by id desc limit 2) s order by id"
    ),
}


@pytest.mark.parametrize("sql", list(ARRAY_SQL.values()), ids=list(ARRAY_SQL))
def test_array_sql_matches_reference(runners, sql):
    assert_parity(runners, sql, ordered="order by" in sql)


def test_array_agg_elements_follow_the_row_order(runners):
    """Stable sorts everywhere: each order's linenumbers come out in the
    generator's order, so element 1 is 1 for every order."""
    _, port = runners
    rows = port.execute(
        "select l_orderkey, array_agg(l_linenumber) from "
        "tpch.tiny.lineitem group by l_orderkey"
    ).rows()
    assert rows and all(a == list(range(1, len(a) + 1)) for _, a in rows)


def test_array_agg_roundtrip_unnest(runners):
    """array_agg -> a stored table -> scan -> unnest: the reference's
    CTAS round trip, stored by append_rows in both."""
    rows = assert_parity(
        runners,
        "select id % 2 as g, array_agg(id) as a from mem.default.t "
        "group by 1 order by g",
    )
    append_both(
        runners, "default", "agged",
        lambda T: {"g": T.INTEGER, "a": T.array(T.INTEGER)}, rows,
    )
    got = assert_parity(
        runners,
        "select g, e from mem.default.agged "
        "cross join unnest(a) as u(e) order by g, e",
    )
    assert got == [(0, 2), (0, 4), (1, 1), (1, 3)]


@pytest.mark.parametrize(
    "sql",
    [
        "select arr from mem.default.t group by arr",
        "select arr from mem.default.t order by arr",
    ],
    ids=["group_by_array", "order_by_array"],
)
def test_array_guards_raise_in_both(runners, sql):
    assert_both_raise(runners, sql)


def test_cross_join_keeps_array_rows(runners):
    """A fault of the reference (ROADMAP §3): its cross join gathers an
    array block's flat values by row number and keeps the old offsets,
    so every copy after the first reads other rows' elements. The port
    gathers the block (offsets and values) and returns the Python
    evaluation's rows; the reference's are pinned as they are."""
    sql = (
        "select t.id, t.arr, n.n_nationkey from mem.default.t "
        "cross join tpch.tiny.nation n where n.n_nationkey < 2 "
        "order by t.id, n.n_nationkey"
    )
    arrs = {1: [10, 20, 30], 2: [5], 3: None, 4: []}
    want = [(i, arrs[i], k) for i in (1, 2, 3, 4) for k in (0, 1)]
    ref, port = runners
    assert port.execute(sql).rows() == want
    assert ref.execute(sql).rows() == [
        (1, [10, 20, 30], 0), (1, [], 1), (2, [5], 0), (2, [], 1),
        (3, None, 0), (3, None, 1), (4, [], 0), (4, [], 1),
    ]


WORDS = ["alpha", "beta", "gamma", "delta"]


def _big_rows():
    """500 rows whose arrays and maps hold about 1,000 values each: the
    value axis fills a 1,024 bucket, so two copies of every row need a
    larger one."""
    rng = np.random.default_rng(8)
    arr, m = [], []
    for _ in range(500):
        arr.append(
            None if rng.random() < 0.1
            else [int(x) for x in rng.integers(-999, 999, rng.integers(0, 5))]
        )
        m.append(
            None if rng.random() < 0.1
            else {
                WORDS[int(k)]: int(rng.integers(-9, 9))
                for k in rng.choice(4, rng.integers(0, 5), replace=False)
            }
        )
    return {"id": list(range(500)), "arr": arr, "m": m}


@pytest.mark.parametrize("array_side", ["left", "right"])
def test_cross_join_widens_repeated_array_values(runners, array_side):
    """Every row of a nested column repeats once per row of the other
    side, so its values outgrow the source's value bucket: the port's
    cross join sizes the value axis from the gathered total and returns
    the Python evaluation's rows, whole arrays and maps, cardinality and
    subscripts, with the nested table on either side. (The reference
    corrupts these columns: F2, pinned above.)"""
    cols = _big_rows()
    assert sum(len(a) for a in cols["arr"] if a is not None) > 512
    assert sum(len(d) for d in cols["m"] if d is not None) > 512
    append_both(
        runners, "default", f"big_{array_side}",
        lambda T: {
            "id": T.INTEGER,
            "arr": T.array(T.BIGINT),
            "m": T.map_(T.VARCHAR, T.BIGINT),
        },
        list(zip(cols["id"], cols["arr"], cols["m"])),
    )
    big = f"mem.default.big_{array_side} b"
    nation = "tpch.tiny.nation n"
    tables = (
        f"{big} cross join {nation}"
        if array_side == "left"
        else f"{nation} cross join {big}"
    )
    sql = (
        "select b.id, n.n_nationkey, b.arr, b.m, cardinality(b.arr), "
        "element_at(b.arr, -1), element_at(b.m, 'beta') "
        f"from {tables} where n.n_nationkey < 2 order by b.id, n.n_nationkey"
    )
    want = [
        (
            i, k, a, d,
            None if a is None else len(a),
            None if not a else a[-1],
            None if d is None else d.get("beta"),
        )
        for i, a, d in zip(cols["id"], cols["arr"], cols["m"])
        for k in (0, 1)
    ]
    assert_same_rows(runners[1].execute(sql).rows(), want)


ORDER_STAT_SQL = {
    "roadmap_example": (
        "select approx_percentile(l_quantity, 0.5), "
        "min_by(l_orderkey, l_extendedprice) from tpch.tiny.lineitem"
    ),
    "global_mix": (
        "select approx_percentile(l_extendedprice, 0.9), "
        "max_by(l_orderkey, l_extendedprice), "
        "min_by(l_orderkey, l_discount), approx_percentile(l_discount, 0.01), "
        "approx_percentile(l_tax, 1.0), approx_percentile(l_tax, 0.0) "
        "from tpch.tiny.lineitem"
    ),
    "filtered_and_null_args": (
        "select approx_percentile(case when l_quantity > 10 then l_tax end, "
        "0.5), max_by(l_shipmode, case when l_linenumber = 2 then "
        "l_extendedprice end) from tpch.tiny.lineitem where l_orderkey < 500"
    ),
    "empty_input": (
        "select approx_percentile(l_quantity, 0.5), min_by(l_orderkey, "
        "l_extendedprice) from tpch.tiny.lineitem where l_quantity < 0"
    ),
    "grouped": (
        "select l_returnflag, approx_percentile(l_quantity, 0.5), "
        "min_by(l_orderkey, l_extendedprice) from tpch.tiny.lineitem "
        "group by l_returnflag order by l_returnflag"
    ),
}


@pytest.mark.parametrize(
    "sql", list(ORDER_STAT_SQL.values()), ids=list(ORDER_STAT_SQL)
)
def test_order_statistics_match_reference(runners, sql):
    rows = assert_parity(runners, sql)
    if sql == ORDER_STAT_SQL["roadmap_example"]:
        assert rows == [(26.0, 50435)]


@pytest.mark.parametrize(
    "sql",
    [
        "select l_orderkey, array_agg(l_partkey) from tpch.tiny.lineitem "
        "group by l_orderkey",
        ORDER_STAT_SQL["roadmap_example"],
    ],
    ids=["grouped_array_agg", "global_order_statistics"],
)
def test_order_aggregates_do_not_stream_in_either_package(sql):
    """array_agg and the order statistics have no mergeable partial
    state: over a scan larger than ``max_device_rows`` both packages
    refuse the streaming cut with the same error."""
    from presto_tpu.session import Session as RefSession
    from presto_tpu_torch.session import Session

    props = {"max_device_rows": 8192}
    runners = (
        RefRunner(session=RefSession(properties=props)),
        LocalQueryRunner(device="cpu", session=Session(properties=props)),
    )
    assert_both_raise(runners, sql, "admits no semantics-preserving")

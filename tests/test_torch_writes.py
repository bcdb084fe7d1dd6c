"""The write statements through both runners on the CPU: every case of
the reference's ``tests/test_writes.py`` (INSERT ... VALUES / SELECT,
CREATE TABLE AS, CREATE/DROP TABLE, DELETE, UPDATE and their
PREPARE/EXECUTE forms over the writable memory connector), run by the
reference and by the port over the same rows, with the same results and
counts. Also: CTAS over nested columns and a long decimal, the
blackhole connector as a source and a sink, the column-wise
``_result_columns`` held against the row-wise build, a short decimal
above 2^53 through INSERT ... SELECT (a fault shared with the
reference), date columns read back from a written table (which the
reference cannot stage), split-cache misses after a write, and the
pool bytes of a write's inner queries (the reference leaks them).

``write_runners`` is shared with ``test_torch_mview.py``."""

from __future__ import annotations

import decimal

import numpy as np
import pytest

from presto_tpu import types as RT
from presto_tpu.connectors import create_connector as ref_connector
from presto_tpu.connectors.spi import TableHandle as RefHandle
from presto_tpu.exec import local_runner as ref_local_runner
from presto_tpu.exec.local_runner import ExecutionError as RefExecutionError
from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu.exec.staging import CatalogManager as RefCatalogs
from presto_tpu.utils import memory as ref_memory
from presto_tpu_torch import types as PT
from presto_tpu_torch.connectors import create_connector
from presto_tpu_torch.connectors.spi import TableHandle
from presto_tpu_torch.exec import local_runner as port_local_runner
from presto_tpu_torch.exec.local_runner import ExecutionError, LocalQueryRunner
from presto_tpu_torch.exec.staging import CatalogManager, obj_array
from presto_tpu_torch.utils import memory as port_memory

from test_torch_arrays import (
    assert_both_raise,
    assert_parity,
    assert_same_rows,
    same_value,
)
from torch_parity import one_torch_thread  # noqa: F401

#: the blackhole catalog's tables serve this many (zero) rows
BH_ROWS = 3000


def write_runners(staging_cache_bytes=None):
    """(reference, port) runners over tpch, a writable ``mem`` memory
    catalog and a ``bh`` blackhole catalog, each with a MemoryPool of
    its own (``runner.memory_pool``)."""
    out = []
    for connector, Catalogs, Runner, memory in (
        (ref_connector, RefCatalogs, RefRunner, ref_memory),
        (create_connector, CatalogManager, LocalQueryRunner, port_memory),
    ):
        catalogs = Catalogs()
        catalogs.register("tpch", connector("tpch"))
        catalogs.register("mem", connector("memory"))
        catalogs.register("bh", connector("blackhole", rows_per_table=BH_ROWS))
        kw = {} if Runner is RefRunner else {"device": "cpu"}
        out.append(
            Runner(
                catalogs=catalogs,
                memory_pool=memory.MemoryPool(1 << 30),
                staging_cache_bytes=staging_cache_bytes,
                **kw,
            )
        )
    return tuple(out)


def both(runners, sql: str, ordered: bool = True):
    """Run ``sql`` in both runners; the rows (a write's count too) must
    be the same. Returns them."""
    return assert_parity(runners, sql, ordered)


@pytest.fixture(scope="module")
def runners():
    return write_runners()


def kv(runners, name: str):
    """A fresh mem.default.<name> (k integer, v varchar) in both."""
    both(runners, f"create table mem.default.{name} (k integer, v varchar)")
    return f"mem.default.{name}"


# ----------------------------------------- the reference's test_writes.py


def test_insert_values_and_read_back(runners):
    t = kv(runners, "kv_values")
    assert both(
        runners, f"insert into {t} values (1, 'one'), (2, 'two'), (3, null)"
    ) == [(3,)]
    assert both(runners, f"select k, v from {t} order by k") == [
        (1, "one"), (2, "two"), (3, None),
    ]


def test_insert_select(runners):
    t = kv(runners, "kv_select")
    assert both(
        runners, f"insert into {t} select r_regionkey, r_name from "
        "tpch.tiny.region",
    ) == [(5,)]
    assert both(runners, f"select count(*) as n from {t}") == [(5,)]
    both(runners, f"select k, v from {t} order by k")


def test_create_table_as(runners):
    rows = both(
        runners,
        "create table mem.default.big_orders as "
        "select o_orderkey, o_totalprice from tpch.tiny.orders "
        "where o_totalprice > 500000",
    )
    assert rows[0][0] > 0
    got = both(
        runners,
        "select count(*) as n, min(o_totalprice) as m "
        "from mem.default.big_orders",
    )
    assert got[0][0] == rows[0][0] and got[0][1] > 500000


def test_insert_into_readonly_catalog_fails(runners):
    for runner, err in zip(runners, (RefExecutionError, ExecutionError)):
        with pytest.raises(err, match="read-only"):
            runner.execute("insert into tpch.tiny.region values (9, 'X', 'c')")


def test_insert_arity_mismatch(runners):
    t = kv(runners, "kv_arity")
    for runner, err in zip(runners, (RefExecutionError, ExecutionError)):
        with pytest.raises(err, match="arity"):
            runner.execute(f"insert into {t} values (1, 'a', 2)")


def test_insert_invalidates_cached_pages(runners):
    """A write drops every cached page of the written table: the next
    run over it misses the split cache exactly once, then stages the
    new contents (the reference's regression: the second SELECT
    returned the pre-insert count)."""
    t = kv(runners, "kv_cache")
    port = runners[1]
    count = f"select count(*) as c from {t}"
    both(runners, f"insert into {t} values (1, 'one')")
    assert both(runners, count) == [(1,)]
    misses = port.split_cache.stats()["misses"]
    assert both(runners, count) == [(1,)]
    assert port.split_cache.stats()["misses"] == misses  # a warm hit
    both(runners, f"insert into {t} values (2, 'two')")
    assert both(runners, count) == [(2,)]
    assert port.split_cache.stats()["misses"] == misses + 1
    assert both(runners, count) == [(2,)]
    assert port.split_cache.stats()["misses"] == misses + 1


def test_show_columns_and_describe(runners):
    t = kv(runners, "kv_show")
    rows = both(runners, f"show columns from {t}")
    assert rows == [("k", "integer"), ("v", "varchar")]
    assert both(runners, f"describe {t}") == rows


def test_delete_where(runners):
    t = kv(runners, "kv_delete")
    both(runners, f"insert into {t} values (10, 'a'), (11, 'b'), (12, null)")
    # deletes only TRUE rows: the NULL-valued v row stays
    assert both(runners, f"delete from {t} where v = 'b' and k >= 10") == [
        (1,)
    ]
    assert both(runners, f"select k, v from {t} order by k") == [
        (10, "a"), (12, None),
    ]
    # an unconditional delete empties the table
    assert both(runners, f"delete from {t}") == [(2,)]
    assert both(runners, f"select count(*) as c from {t}") == [(0,)]


def test_prepare_execute_deallocate(runners):
    t = kv(runners, "kv_prep")
    both(runners, f"insert into {t} values (1, 'one'), (2, 'two')")
    both(runners, f"prepare q from select k, v from {t} where k = ? or v = ?")
    assert both(runners, "execute q using 1, 'two'") == [(1, "one"), (2, "two")]
    for runner, err in zip(runners, (RefExecutionError, ExecutionError)):
        with pytest.raises(err, match="2 parameter"):
            runner.execute("execute q using 1")
    both(runners, "deallocate prepare q")
    assert_both_raise(runners, "execute q using 1, 'x'", "not found")


def test_prepared_insert_and_delete(runners):
    t = kv(runners, "kv_prep_write")
    both(runners, f"prepare ins2 from insert into {t} values (?, ?)")
    assert both(runners, "execute ins2 using 77, 'prep'") == [(1,)]
    assert both(runners, f"select v from {t} where k = 77") == [("prep",)]
    both(runners, f"prepare del2 from delete from {t} where k = ?")
    assert both(runners, "execute del2 using 77") == [(1,)]
    assert both(runners, f"select count(*) from {t}") == [(0,)]


def test_create_and_drop_table(runners):
    t = "mem.default.ddl"
    both(runners, f"create table {t} (a bigint, s varchar, d decimal(9,2))")
    assert both(runners, f"show columns from {t}") == [
        ("a", "bigint"), ("s", "varchar"), ("d", "decimal(9,2)"),
    ]
    both(runners, f"insert into {t} values (1, 'x', 2.50)")
    rows = both(runners, f"select a, s, d from {t}")
    assert rows == [(1, "x", decimal.Decimal("2.50"))]
    both(runners, f"drop table {t}")
    for runner, err in zip(runners, (RefExecutionError, ExecutionError)):
        with pytest.raises(err, match="does not exist"):
            runner.execute(f"drop table {t}")
    both(runners, f"drop table if exists {t}")


def test_update(runners):
    t = "mem.default.upd"
    both(runners, f"create table {t} (k bigint, v varchar)")
    both(runners, f"insert into {t} values (1, 'a'), (2, 'b'), (3, null)")
    # NULL predicate rows stay unchanged; the count is the TRUE rows
    assert both(runners, f"update {t} set v = 'z' where v = 'b'") == [(1,)]
    assert both(runners, f"select k, v from {t} order by k") == [
        (1, "a"), (2, "z"), (3, None),
    ]
    # an unconditional update touches every row
    assert both(runners, f"update {t} set k = k + 10") == [(3,)]
    assert both(runners, f"select min(k) as m from {t}") == [(11,)]
    both(runners, f"prepare upd_p from update {t} set v = ? where k = ?")
    assert both(runners, "execute upd_p using 'w', 11") == [(1,)]
    assert both(runners, f"select k, v from {t} order by k") == [
        (11, "w"), (12, "z"), (13, None),
    ]
    both(runners, f"drop table {t}")


# ------------------------------------------------------- beyond the cases


#: a memory table of every column kind, with NULLs, loaded into both
KINDS_ROWS = {
    "i": [1, None, -3, 4],
    "b": [10**12, 5, None, -(2**40)],
    "dbl": [1.5, None, -0.25, 1e300],
    "dec": [decimal.Decimal("12.34"), decimal.Decimal("-0.05"), None,
            decimal.Decimal("99999.99")],
    "ldec": [decimal.Decimal("123456789012345678901234.56"), None,
             decimal.Decimal("-1.00"), decimal.Decimal("0.01")],
    "s": ["x", None, "yy", ""],
    "dt": [None, 0, 9204, 10471],
    "flag": [True, False, None, True],
    "arr": [[1, 2], [], None, [3]],
    "sarr": [["a"], None, ["b", "c"], []],
    "m": [{"k": 1}, None, {}, {"a": 2, "b": None}],
    "r": [{"x": 1, "y": "p"}, {"x": None, "y": "q"}, None, {"x": 3, "y": None}],
}


def _kinds_types(T):
    return {
        "i": T.INTEGER, "b": T.BIGINT, "dbl": T.DOUBLE,
        "dec": T.parse_type("decimal(7,2)"),
        "ldec": T.parse_type("decimal(30,2)"),
        "s": T.VARCHAR, "dt": T.DATE, "flag": T.BOOLEAN,
        "arr": T.array(T.BIGINT), "sarr": T.array(T.VARCHAR),
        "m": T.map_(T.VARCHAR, T.BIGINT),
        "r": T.row(("x", T.BIGINT), ("y", T.VARCHAR)),
    }


@pytest.fixture(scope="module")
def kinds(runners):
    for runner, T, Handle in zip(runners, (RT, PT), (RefHandle, TableHandle)):
        mem = runner.catalogs.get("mem")
        h = Handle("mem", "default", "kinds")
        mem.create_table(h, _kinds_types(T))
        mem.append_rows(h, {c: obj_array(v) for c, v in KINDS_ROWS.items()})
    return "mem.default.kinds"


@pytest.mark.parametrize("col", list(KINDS_ROWS))
def test_result_columns_equal_the_row_wise_build(runners, kinds, col):
    """``_result_columns`` builds the write SPI's columns column by
    column through the decoder ``Page.to_pylist`` uses; the values and
    their Python types equal the row-wise build through ``to_pylist``
    element by element, and the reference's own row-wise
    ``_result_columns`` on the same query, except a short decimal: the
    port writes the exact ``decimal.Decimal`` of its scaled integer,
    whose float is the row decoder's and the reference's value. Dates
    go through ``cast`` here: the reference stages no written date
    (``test_written_dates_read_back``)."""
    expr = f"cast(dt as date) as {col}" if col == "dt" else col
    sql = f"select i, {expr} from {kinds}"
    ref, port = runners
    got = port_local_runner._result_columns(port.execute(sql))
    res = port.execute(sql)
    dicts = res.page.to_pylist()
    row_wise = {c: obj_array([r[c] for r in dicts]) for c in res.columns}
    want = ref_local_runner._result_columns(ref.execute(sql))
    assert list(got) == list(row_wise) == list(want)
    for c in got:
        assert got[c].dtype == object and len(got[c]) == len(want[c])
        for a, b, w in zip(got[c], row_wise[c], want[c]):
            if c == "dec" and a is not None:
                assert isinstance(a, decimal.Decimal), (c, a)
                assert a == a.quantize(decimal.Decimal("0.01")), (c, a)
                assert float(a) == b == w, (c, a, b, w)
                continue
            assert type(a) is type(b) and (a == b or a != a), (c, a, b)
            assert same_value(a, w), (c, a, w)


def test_ctas_over_nested_columns_and_a_long_decimal(runners, kinds):
    both(
        runners,
        "create table mem.default.kinds_copy as "
        f"select i, ldec, arr, sarr, m, r from {kinds} where i is not null "
        "or r is null",
    )
    assert both(runners, "show columns from mem.default.kinds_copy") == [
        ("i", "integer"), ("ldec", "decimal(30,2)"), ("arr", "array(bigint)"),
        ("sarr", "array(varchar)"), ("m", "map(varchar,bigint)"),
        ("r", "row(x bigint, y varchar)"),
    ]
    rows = both(
        runners, "select i, ldec, arr, sarr, m, r from mem.default.kinds_copy "
        "order by i",
    )
    assert rows[0][1] == decimal.Decimal("-1.00")
    assert rows[1][1] == decimal.Decimal("123456789012345678901234.56")
    both(runners, "select i, cardinality(arr), ldec * 2 from "
         "mem.default.kinds_copy order by i")


def test_blackhole_is_a_source_and_a_sink(runners):
    """A blackhole table serves ``BH_ROWS`` zero rows (a string column
    reads 'x'); an INSERT ... SELECT into it returns its row count and
    changes nothing, and so does a CTAS."""
    both(runners, "create table bh.default.sink (a bigint, s varchar)")
    assert both(
        runners, "select count(*), sum(a), min(s) from bh.default.sink"
    ) == [(BH_ROWS, 0, "x")]
    n = both(
        runners,
        "insert into bh.default.sink select l_orderkey, l_comment "
        "from tpch.tiny.lineitem",
    )[0][0]
    assert n > BH_ROWS
    assert both(runners, "select count(*) from bh.default.sink") == [
        (BH_ROWS,)
    ]
    assert both(
        runners, "create table bh.default.ctas as select n_name "
        "from tpch.tiny.nation",
    ) == [(25,)]
    assert both(runners, "select count(*), min(n_name) from "
                "bh.default.ctas") == [(BH_ROWS, "x")]


def test_short_decimal_above_2_53_changes_through_insert_select(runners):
    """The reference's write row format holds a short decimal as a
    Python float (``int / 10**scale``), so a decimal(18,2) whose scaled
    value is above 2^53 reads back another value after INSERT ...
    SELECT: 90071992547409.93 comes back as 90071992547409.94. The
    port writes the exact ``decimal.Decimal`` of the scaled integer, so
    the copy equals its source, through INSERT ... SELECT and CTAS."""
    exact = decimal.Decimal("90071992547409.93")  # 9007199254740993 scaled
    for runner, T, Handle in zip(runners, (RT, PT), (RefHandle, TableHandle)):
        mem = runner.catalogs.get("mem")
        h = Handle("mem", "default", "dedge")
        mem.create_table(h, {"d": T.parse_type("decimal(18,2)"),
                             "tag": T.VARCHAR})
        mem.append_rows(h, {"d": obj_array([exact]),
                            "tag": obj_array(["src"])})
    assert both(
        runners, "insert into mem.default.dedge select d, 'copy' "
        "from mem.default.dedge",
    ) == [(1,)]
    ref, port = runners
    # the difference is computed on the stored scaled integers: the
    # reference's copy moved by one unit of the scale, the port's not
    diff = "select max(d) - min(d) as diff, count(*) as n from mem.default.dedge"
    assert ref.execute(diff).rows() == [(0.01, 2)]
    assert port.execute(diff).rows() == [(0.0, 2)]
    moved = "select tag from mem.default.dedge where d = 90071992547409.94"
    assert ref.execute(moved).rows() == [("copy",)]
    assert port.execute(moved).rows() == []
    kept = (
        "select tag from mem.default.dedge where d = 90071992547409.93 "
        "order by tag"
    )
    assert ref.execute(kept).rows() == [("src",)]
    assert port.execute(kept).rows() == [("copy",), ("src",)]
    # CTAS carries the same exact value in the port
    port.execute(
        "create table mem.default.dedge_ctas as select d from "
        "mem.default.dedge where tag = 'src'"
    )
    mem = port.catalogs.get("mem")
    page = mem.create_page_source(
        mem.get_splits(TableHandle("mem", "default", "dedge_ctas"))
        .next_batch(1)[0], ["d"],
    )
    assert list(page["d"]) == [exact]


def test_written_dates_read_back(runners):
    """A date column a write stored (datetime.date values) stages in the
    port and reads back as written; the reference cannot stage it
    (``Block.from_pylist`` takes only epoch days) and raises TypeError
    (ROADMAP §3)."""
    ref, port = runners
    sql = (
        "create table mem.default.dates as select o_orderkey, o_orderdate "
        "from tpch.tiny.orders where o_orderkey < 100"
    )
    assert_same_rows(port.execute(sql).rows(), ref.execute(sql).rows())
    read = (
        "select count(*), min(o_orderdate), max(o_orderdate) "
        "from mem.default.dates"
    )
    want = port.execute(
        "select count(*), min(o_orderdate), max(o_orderdate) "
        "from tpch.tiny.orders where o_orderkey < 100"
    ).rows()
    assert port.execute(read).rows() == want
    assert ref.execute(
        "select count(*), min(o_orderdate), max(o_orderdate) "
        "from tpch.tiny.orders where o_orderkey < 100"
    ).rows() == want
    with pytest.raises(TypeError, match="datetime.date"):
        ref.execute(read)
    # the date filter of a DELETE runs over the written dates
    n = port.execute(
        "delete from mem.default.dates where o_orderdate < date '1995-01-01'"
    ).rows()[0][0]
    assert port.execute("select count(*) from mem.default.dates").rows() == [
        (want[0][0] - n,)
    ]


def test_writes_release_what_they_reserved():
    """Every write runs its inner queries under a QueryStats of its own
    in the port, so a table larger than the split cache's budget
    (tpch.tiny lineitem under 100,000 bytes) is reserved while the
    statement runs and released after: the pool holds no query-owned
    byte after each statement. The reference runs them with none, and
    its "adhoc" bytes grow with every statement; the rows are the
    same."""
    runners = write_runners(staging_cache_bytes=100_000)
    ref, port = runners
    statements = [
        "create table mem.default.leak as select l_orderkey, l_quantity "
        "from tpch.tiny.lineitem where l_quantity < 1000",
        "insert into mem.default.leak select l_orderkey, l_quantity "
        "from tpch.tiny.lineitem where l_quantity >= 4900",
        "update mem.default.leak set l_quantity = l_quantity + 1 "
        "where l_orderkey < 100",
        "delete from mem.default.leak where l_quantity > 4000",
    ]
    leaked = []
    for sql in statements:
        both(runners, sql)
        assert port.memory_pool.snapshot()["used"] == {}, sql
        leaked.append(ref.memory_pool.used_bytes("adhoc"))
    assert 0 < leaked[0] < leaked[1] < leaked[2] < leaked[3]
    both(runners, "select count(*), sum(l_quantity) from mem.default.leak")
    assert port.memory_pool.snapshot()["used"] == {}
    assert np.all(np.diff(leaked) > 0)


def test_sorted_group_by_over_a_computed_key_without_nulls(runners):
    """A computed GROUP BY key over a null-free column can carry a
    scalar validity (``o_orderkey % 2``: the divisor's check). The
    reference's sorted aggregation fails on it (``ValueError: all keys
    need to be the same shape``); the port broadcasts it and returns the
    groups (ROADMAP §3). A written table's columns are null-free in the
    port (``stage_page`` drops a mask that only the padding needs), so
    this shape is common there."""
    ref, port = runners
    sql = (
        "select o_orderkey % 2 as g, array_agg(o_orderkey) as a "
        "from tpch.tiny.orders where o_orderkey < 40 group by 1 order by g"
    )
    keys = [k for (k,) in port.execute(
        "select o_orderkey from tpch.tiny.orders where o_orderkey < 40"
    ).rows()]
    want = [(g, [k for k in keys if k % 2 == g]) for g in (0, 1)]
    assert port.execute(sql).rows() == want
    with pytest.raises(ValueError, match="same shape"):
        ref.execute(sql)

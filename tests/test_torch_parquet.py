"""The parquet connector (``connectors/parquet.py``) in both packages. The
cases of the reference's ``tests/test_parquet.py`` run once through
``presto_tpu`` (``[ref]``) and once through ``presto_tpu_torch``
(``[port]``, on the CPU): the ``package`` fixture binds the names that
file imports (``torch_packages.bind``). Then one tree, read through both
packages: the rows and the split ranges (row groups pruned from footer
statistics) must be equal, doubles to rel 1e-9 and everything else
exactly.

The reference's cases: parquet connector (SURVEY.md §2.2 L9 file-format readers): read
pyarrow-written files through the SPI, with column pruning, row-group
splits, footer statistics, nulls, decimals, dates, and strings.
"""

import datetime
import decimal

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402

from torch_packages import (  # noqa: E402
    PACKAGES,
    assert_rows_equal,
    bind,
    module,
    split_ranges,
)


@pytest.fixture(scope="module", params=PACKAGES)
def package(request):
    """Each case once per package: the names the reference's file
    imports, bound to that package's objects."""
    bind(globals(), request.param)
    return request.param


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    root = tmp_path_factory.mktemp("lake")
    (root / "sales").mkdir()
    n = 10_000
    rng = np.random.RandomState(7)
    region = rng.choice(["east", "west", "north", None], n, p=[.4, .3, .2, .1])
    table = pa.table(
        {
            "id": pa.array(np.arange(n, dtype=np.int64)),
            "qty": pa.array(rng.randint(1, 100, n).astype(np.int32)),
            "price": pa.array(
                [
                    decimal.Decimal(int(v)) / 100
                    for v in rng.randint(100, 100000, n)
                ],
                type=pa.decimal128(12, 2),
            ),
            "day": pa.array(
                [
                    datetime.date(2024, 1, 1) + datetime.timedelta(days=int(d))
                    for d in rng.randint(0, 365, n)
                ]
            ),
            "region": pa.array(region.tolist()),
            "score": pa.array(rng.rand(n)),
        }
    )
    pq.write_table(
        table, root / "sales" / "orders.parquet", row_group_size=2048
    )
    return root, table


@pytest.fixture(scope="module")
def runner(package, lake):
    root, _ = lake
    catalogs = CatalogManager()
    catalogs.register("tpch", create_connector("tpch"))
    catalogs.register("lake", create_connector("parquet", root=str(root)))
    return LocalQueryRunner(catalogs=catalogs)


def test_metadata_and_stats(package, lake):
    root, table = lake
    conn = create_connector("parquet", root=str(root))
    md = conn.metadata()
    assert md.list_schemas() == ["sales"]
    assert md.list_tables("sales") == ["orders"]
    h = TableHandle("lake", "sales", "orders")
    schema = md.get_table_schema(h)
    assert schema["id"].name == "bigint"
    assert schema["price"].is_decimal and schema["price"].scale == 2
    assert schema["region"].is_string
    st = md.get_table_stats(h)
    assert st.row_count == 10_000
    assert st.columns["qty"].min_value >= 1
    assert st.columns["qty"].max_value <= 99


def test_row_group_splits(package, lake):
    root, _ = lake
    conn = create_connector("parquet", root=str(root))
    h = TableHandle("lake", "sales", "orders")
    src = conn.get_splits(h, target_split_rows=2048)
    splits = []
    while not src.exhausted:
        splits.extend(src.next_batch(16))
    assert len(splits) >= 4
    assert splits[0].row_start == 0
    assert splits[-1].row_end == 10_000


def test_full_scan_agg(package, runner, lake):
    _, table = lake
    rows = runner.execute(
        "select count(*) as n, sum(qty) as q from lake.sales.orders"
    ).rows()
    assert rows == [(10_000, int(np.sum(table.column("qty").to_numpy())))]


def test_strings_nulls_and_groupby(package, runner, lake):
    _, table = lake
    rows = runner.execute(
        "select region, count(*) as n from lake.sales.orders "
        "group by region order by region nulls last"
    ).rows()
    regions = table.column("region").to_pylist()
    import collections

    expect = collections.Counter(regions)
    got = {r: n for r, n in rows}
    assert got == dict(expect)


def test_decimal_exactness(package, runner, lake):
    _, table = lake
    rows = runner.execute(
        "select sum(price) as s from lake.sales.orders where qty < 10"
    ).rows()
    qty = np.asarray(table.column("qty").to_numpy())
    price = [decimal.Decimal(str(v)) for v in table.column("price").to_pylist()]
    expect = sum(p for p, q in zip(price, qty) if q < 10)
    assert rows[0][0] == pytest.approx(float(expect), rel=1e-12)


def test_join_parquet_with_tpch(package, runner, lake):
    _, table = lake
    rows = runner.execute(
        "select r_name, count(*) as n "
        "from lake.sales.orders, tpch.tiny.region "
        "where qty = r_regionkey group by r_name order by r_name"
    ).rows()
    qty = table.column("qty").to_numpy()
    expect = sum(1 for q in qty if 0 <= q <= 4)
    assert sum(n for _, n in rows) == expect
    assert 0 < len(rows) <= 5


def test_date_filter(package, runner, lake):
    _, table = lake
    rows = runner.execute(
        "select count(*) as n from lake.sales.orders "
        "where day >= date '2024-07-01'"
    ).rows()
    days = table.column("day").to_pylist()
    expect = sum(1 for d in days if d >= datetime.date(2024, 7, 1))
    assert rows == [(expect,)]


# --------------------------------------------- both packages, one tree

CROSS_QUERIES = [
    "select count(*) as n, sum(qty) as q, sum(price) as p, sum(score) as s "
    "from lake.sales.orders",
    "select region, count(*) as n, min(day) as d0, max(day) as d1, "
    "sum(price) as p from lake.sales.orders group by region "
    "order by region nulls last",
    "select id, qty, price, day, region, score from lake.sales.orders "
    "where qty between 10 and 12 and region = 'east' order by id",
]


@pytest.fixture(scope="module")
def both_runners(lake):
    root, _ = lake
    out = {}
    for pkg in PACKAGES:
        ns = {}
        bind(ns, pkg)
        catalogs = ns["CatalogManager"]()
        catalogs.register("lake", ns["create_connector"]("parquet", root=str(root)))
        out[pkg] = ns["LocalQueryRunner"](catalogs=catalogs)
    return out


@pytest.mark.parametrize("i", range(len(CROSS_QUERIES)))
def test_port_reads_the_tree_as_the_reference(both_runners, i):
    sql = CROSS_QUERIES[i]
    want = both_runners["ref"].execute(sql).rows()
    assert want
    assert_rows_equal(both_runners["port"].execute(sql).rows(), want)


@pytest.mark.parametrize(
    "constraint",
    [(), (("qty", (3, 97)),), (("id", "range", 2000, 4095),),
     (("id", "range", 9000, 20000),), (("qty", ()),)],
    ids=["none", "values", "range", "tail", "empty"],
)
def test_pruned_row_groups_and_split_ranges_equal_the_reference(lake, constraint):
    """Row-group pruning from footer statistics keeps the same groups,
    and the splits cover the same row ranges, in both packages."""
    root, _ = lake
    got = {}
    for pkg in PACKAGES:
        spi = module(pkg, "connectors.spi")
        cons = tuple(
            (c[0], spi.RangeSet(c[2], c[3])) if len(c) == 4 else c
            for c in constraint
        )
        conn = module(pkg, "connectors").create_connector(
            "parquet", root=str(root)
        )
        h = spi.TableHandle("lake", "sales", "orders")
        got[pkg] = split_ranges(
            conn, h, target_split_rows=2048, constraint=cons
        )
    assert got["port"] == got["ref"]
    if constraint and constraint[0][0] == "id":
        assert got["port"] and got["port"] != [(0, 10_000)]


@pytest.mark.parametrize("seed", range(4))
def test_arrow_string_payload_equals_the_reference(seed):
    """The port ranks a string column's distinct values from arrow's
    ``dictionary_encode``; the ids, the validity and the dictionary are
    the reference's (``np.unique`` over every row)."""
    rng = np.random.RandomState(seed)
    vals = rng.choice(["b", "a", "ä", "", "zz", "Z", None, "a "],
                      rng.randint(1, 400)).tolist()
    if seed == 3:
        vals = [None] * len(vals)
    arr = pa.array(vals, type=pa.string())
    got = module("port", "connectors._arrow")._encode_arrow_strings(arr)
    want = module("ref", "connectors._arrow")._encode_arrow_strings(arr)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_without_pyarrow_a_file_connector_raises(lake, tmp_path, monkeypatch):
    """No pyarrow: the port's file connectors raise an ImportError that
    names it, never an empty table."""
    import shutil
    import sys

    src = lake[0] / "sales" / "orders.parquet"
    (tmp_path / "sales" / "orders").mkdir(parents=True)
    shutil.copy(src, tmp_path / "sales" / "orders.parquet")
    shutil.copy(src, tmp_path / "sales" / "orders.orc")  # never opened
    shutil.copy(src, tmp_path / "sales" / "orders" / "part-0.parquet")
    for name in ("pyarrow", "pyarrow.parquet", "pyarrow.orc"):
        monkeypatch.setitem(sys.modules, name, None)
    spi = module("port", "connectors.spi")
    for kind in ("parquet", "orc", "hive"):
        conn = module("port", "connectors").create_connector(
            kind, root=str(tmp_path)
        )
        with pytest.raises(ImportError, match="pyarrow"):
            conn.metadata().get_table_schema(
                spi.TableHandle("lake", "sales", "orders")
            )

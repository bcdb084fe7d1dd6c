"""The ORC connector (``connectors/orc.py``) in both packages. The cases of
the reference's ``tests/test_orc.py`` run once through ``presto_tpu``
(``[ref]``) and once through ``presto_tpu_torch`` (``[port]``, on the
CPU): the ``package`` fixture binds the names that file imports
(``torch_packages.bind``). Then one tree, read through both packages:
the rows and the split ranges (stripes pruned from the stripe
statistics) must be equal, doubles to rel 1e-9 and everything else
exactly.

The reference's cases: oRC connector (SURVEY.md §2.2 L9 file-format readers): read
pyarrow-written ORC files through the SPI, with column pruning,
stripe-aligned splits, nulls, decimals, dates, and strings — the same
engine-facing contract as the parquet connector, different physical
format.
"""

import datetime
import decimal

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")
orc = pytest.importorskip("pyarrow.orc")

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
    root = tmp_path_factory.mktemp("orclake")
    (root / "sales").mkdir()
    n = 10_000
    rng = np.random.RandomState(11)
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
    # small stripes so split tests exercise multi-stripe mapping
    orc.write_table(table, root / "sales" / "orders.orc", stripe_size=65536)
    return root, table


@pytest.fixture(scope="module")
def runner(package, lake):
    root, _ = lake
    catalogs = CatalogManager()
    catalogs.register("tpch", create_connector("tpch"))
    catalogs.register("lake", create_connector("orc", root=str(root)))
    return LocalQueryRunner(catalogs=catalogs)


def test_metadata_and_stats(package, lake):
    root, _ = lake
    conn = create_connector("orc", root=str(root))
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


def test_stripe_splits_cover_exactly(package, lake):
    root, _ = lake
    conn = create_connector("orc", root=str(root))
    h = TableHandle("lake", "sales", "orders")
    src = conn.get_splits(h, target_split_rows=1024)
    splits = []
    while not src.exhausted:
        splits.extend(src.next_batch(64))
    assert splits[0].row_start == 0
    assert splits[-1].row_end == 10_000
    for a, b in zip(splits, splits[1:]):
        assert a.row_end == b.row_start
    assert len(splits) >= 2


def test_arbitrary_range_read_matches_source(package, lake):
    """Page source must honor exact row ranges, including ranges that
    straddle stripe boundaries at unaligned offsets."""
    root, table = lake
    conn = create_connector("orc", root=str(root))
    h = TableHandle("lake", "sales", "orders")
    offs = conn._stripe_offsets(h)
    assert offs[-1] == 10_000
    mid = offs[1] if len(offs) > 2 else 5000
    ConnectorSplit = module(PKG, "connectors.spi").ConnectorSplit

    lo, hi = mid - 7, mid + 13
    page = conn.create_page_source(ConnectorSplit(h, lo, hi), ["id", "qty"])
    np.testing.assert_array_equal(
        np.asarray(page["id"]), np.arange(lo, hi, dtype=np.int64)
    )
    np.testing.assert_array_equal(
        np.asarray(page["qty"]),
        table.column("qty").to_numpy()[lo:hi].astype(np.int32),
    )


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
    import collections

    expect = collections.Counter(table.column("region").to_pylist())
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


def test_date_filter(package, runner, lake):
    _, table = lake
    rows = runner.execute(
        "select count(*) as n from lake.sales.orders "
        "where day >= date '2024-07-01'"
    ).rows()
    days = table.column("day").to_pylist()
    expect = sum(1 for d in days if d >= datetime.date(2024, 7, 1))
    assert rows == [(expect,)]


def test_empty_orc_table(package, tmp_path):
    """A 0-row ORC file (0 stripes) must scan as an empty result, not
    crash on null-typed arrays."""
    (tmp_path / "s").mkdir()
    empty = pa.table(
        {
            "a": pa.array([], type=pa.int64()),
            "b": pa.array([], type=pa.string()),
        }
    )
    orc.write_table(empty, tmp_path / "s" / "t.orc")

    catalogs = CatalogManager()
    catalogs.register("lake", create_connector("orc", root=str(tmp_path)))
    r = LocalQueryRunner(catalogs=catalogs)
    assert r.execute("select count(*) as n from lake.s.t").rows() == [(0,)]
    assert r.execute("select a, b from lake.s.t").rows() == []


def test_join_orc_with_tpch(package, runner, lake):
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


# --------------------------------------------- both packages, one tree

CROSS_QUERIES = [
    "select count(*) as n, sum(qty) as q, sum(price) as p, sum(score) as s "
    "from lake.sales.orders",
    "select region, count(*) as n, min(day) as d0, max(day) as d1, "
    "sum(price) as p from lake.sales.orders group by region "
    "order by region nulls last",
    "select id, qty, price, day, region, score from lake.sales.orders "
    "where qty between 10 and 12 and region = 'west' order by id",
]


@pytest.fixture(scope="module")
def both_runners(lake):
    root, _ = lake
    out = {}
    for pkg in PACKAGES:
        ns = {}
        bind(ns, pkg)
        catalogs = ns["CatalogManager"]()
        catalogs.register("lake", ns["create_connector"]("orc", root=str(root)))
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
    [(), (("id", "range", 2000, 4095),), (("id", "range", 9000, 20000),),
     (("id", ()),)],
    ids=["none", "range", "tail", "empty"],
)
def test_pruned_stripes_and_split_ranges_equal_the_reference(lake, constraint):
    """Stripe pruning from the once-read stripe statistics keeps the
    same stripes, the splits cover the same row ranges, and the footer
    row count is the same, in both packages."""
    root, _ = lake
    got, offs, rows = {}, {}, {}
    for pkg in PACKAGES:
        spi = module(pkg, "connectors.spi")
        cons = tuple(
            (c[0], spi.RangeSet(c[2], c[3])) if len(c) == 4 else c
            for c in constraint
        )
        conn = module(pkg, "connectors").create_connector(
            "orc", root=str(root)
        )
        h = spi.TableHandle("lake", "sales", "orders")
        got[pkg] = split_ranges(
            conn, h, target_split_rows=1024, constraint=cons
        )
        offs[pkg] = list(conn._stripe_offsets(h))
        rows[pkg] = conn.metadata().get_table_stats(h).row_count
    assert got["port"] == got["ref"]
    assert offs["port"] == offs["ref"] and len(offs["port"]) > 2
    assert rows["port"] == rows["ref"] == 10_000

"""The hive connector (``connectors/hive.py``) in both packages. The cases
of the reference's ``tests/test_hive.py`` run once through
``presto_tpu`` (``[ref]``) and once through ``presto_tpu_torch``
(``[port]``, on the CPU): the ``package`` fixture binds the names that
file imports (``torch_packages.bind``). Then one warehouse, read through
both packages: the rows and the split ranges (partitions pruned) must be
equal, doubles to rel 1e-9 and everything else exactly.

The reference's cases: hive-style connector (SURVEY.md §2.2 production connectors): a table
is a partitioned directory of parquet files; key=value path components
are virtual columns; files map into one global row space so splits stay
format-agnostic.
"""

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
def warehouse(tmp_path_factory):
    root = tmp_path_factory.mktemp("warehouse")
    rng = np.random.RandomState(23)
    rows = []  # (region, year, id, amount, tag)
    i = 0
    for region in ("east", "west"):
        for year in (2023, 2024):
            d = root / "sales" / "orders" / f"region={region}" / f"year={year}"
            d.mkdir(parents=True)
            # two files per partition: multi-file global row space
            for fidx in range(2):
                n = int(rng.randint(50, 150))
                ids = np.arange(i, i + n, dtype=np.int64)
                i += n
                amt = rng.randint(1, 1000, n).astype(np.int64)
                tag = rng.choice(["a", "b", "c"], n)
                pq.write_table(
                    pa.table(
                        {
                            "id": pa.array(ids),
                            "amount": pa.array(amt),
                            "tag": pa.array(tag.tolist()),
                        }
                    ),
                    d / f"part-{fidx}.parquet",
                    row_group_size=64,
                )
                rows += [
                    (region, year, int(a), int(b), str(c))
                    for a, b, c in zip(ids, amt, tag)
                ]
    return root, rows


@pytest.fixture(scope="module")
def runner(package, warehouse):
    root, _ = warehouse
    catalogs = CatalogManager()
    catalogs.register("tpch", create_connector("tpch"))
    catalogs.register("hive", create_connector("hive", root=str(root)))
    return LocalQueryRunner(catalogs=catalogs)


def test_schema_includes_partition_keys(package, warehouse):
    root, _ = warehouse
    conn = create_connector("hive", root=str(root))
    md = conn.metadata()
    assert md.list_schemas() == ["sales"]
    assert md.list_tables("sales") == ["orders"]
    schema = md.get_table_schema(TableHandle("hive", "sales", "orders"))
    assert schema["region"].is_string
    assert schema["year"].name == "bigint"  # all values parse as ints
    assert schema["id"].name == "bigint"
    st = md.get_table_stats(TableHandle("hive", "sales", "orders"))
    assert st.row_count == len(warehouse[1])


def test_full_scan_counts(package, runner, warehouse):
    _, rows = warehouse
    got = runner.execute(
        "select count(*) as n, sum(amount) as s from hive.sales.orders"
    ).rows()
    assert got == [(len(rows), sum(r[3] for r in rows))]


def test_group_by_partition_column(package, runner, warehouse):
    _, rows = warehouse
    got = runner.execute(
        "select region, year, count(*) as n, sum(amount) as s "
        "from hive.sales.orders group by region, year "
        "order by region, year"
    ).rows()
    import collections

    expect = collections.defaultdict(lambda: [0, 0])
    for region, year, _id, amt, _tag in rows:
        e = expect[(region, year)]
        e[0] += 1
        e[1] += amt
    assert got == [
        (r, y, n, s)
        for (r, y), (n, s) in sorted(expect.items())
    ]


def test_filter_on_partition_column(package, runner, warehouse):
    _, rows = warehouse
    got = runner.execute(
        "select count(*) as n from hive.sales.orders "
        "where region = 'east' and year = 2024"
    ).rows()
    expect = sum(1 for r in rows if r[0] == "east" and r[1] == 2024)
    assert got == [(expect,)]


def test_string_column_across_files(package, runner, warehouse):
    """tag dictionaries differ per file: the shared-dictionary re-encode
    must keep values exact across the whole table."""
    _, rows = warehouse
    got = runner.execute(
        "select tag, count(*) as n from hive.sales.orders "
        "group by tag order by tag"
    ).rows()
    import collections

    expect = collections.Counter(r[4] for r in rows)
    assert got == sorted(expect.items())


def test_split_ranges_align_to_files(package, warehouse):
    root, rows = warehouse
    conn = create_connector("hive", root=str(root))
    h = TableHandle("hive", "sales", "orders")
    src = conn.get_splits(h, target_split_rows=64)
    splits = []
    while not src.exhausted:
        splits.extend(src.next_batch(64))
    assert splits[0].row_start == 0
    assert splits[-1].row_end == len(rows)
    for a, b in zip(splits, splits[1:]):
        assert a.row_end == b.row_start


def test_join_with_tpch(package, runner, warehouse):
    _, rows = warehouse
    got = runner.execute(
        "select r_name, count(*) as n from "
        "(select amount % 5 as k from hive.sales.orders) t, "
        "tpch.tiny.region where k = r_regionkey "
        "group by r_name order by r_name"
    ).rows()
    assert sum(n for _, n in got) == len(rows)


def test_partition_pruning_skips_files(package, runner, warehouse, monkeypatch):
    """`where region = 'east' and year = 2024` must open only that
    partition's files (TupleDomain-lite pushdown into get_splits) and
    still be exact."""
    hive_mod = module(PKG, "connectors.hive")

    _, rows = warehouse
    opened = []
    orig = hive_mod.HiveConnector._append_file_range

    def spy(self, f, lo, hi, columns, schema, part_types, out):
        opened.append(f.keys.copy())
        return orig(self, f, lo, hi, columns, schema, part_types, out)

    monkeypatch.setattr(
        hive_mod.HiveConnector, "_append_file_range", spy
    )
    got = runner.execute(
        "select count(*) as n, sum(amount) as s from hive.sales.orders "
        "where region = 'east' and year = 2024"
    ).rows()
    expect = [
        (
            sum(1 for r in rows if r[0] == "east" and r[1] == 2024),
            sum(r[3] for r in rows if r[0] == "east" and r[1] == 2024),
        )
    ]
    assert got == expect
    assert opened, "no files read at all?"
    assert all(
        k == {"region": "east", "year": "2024"} for k in opened
    ), f"pruning leaked partitions: {opened}"


def test_pruned_page_not_cached_for_unconstrained_scan(package, runner, warehouse):
    """The table cache must key on the constraint: a full scan after a
    pruned scan sees ALL partitions."""
    _, rows = warehouse
    runner.execute(
        "select count(*) as n from hive.sales.orders "
        "where region = 'west' and year = 2023"
    ).rows()
    got = runner.execute(
        "select count(*) as n from hive.sales.orders"
    ).rows()
    assert got == [(len(rows),)]


def test_in_list_pruning(package, runner, warehouse):
    _, rows = warehouse
    got = runner.execute(
        "select count(*) as n from hive.sales.orders "
        "where region in ('west', 'north')"
    ).rows()
    assert got == [(sum(1 for r in rows if r[0] == "west"),)]


def test_decimal_scale_evolution_across_files(package, tmp_path):
    """Schema evolution: a later file storing the decimal at a finer
    scale must normalize to the table schema (derived from the first
    file) — the raw-buffer read keeps the as_py-era rescale."""
    import decimal

    d = tmp_path / "s" / "t"
    d.mkdir(parents=True)
    pq.write_table(
        pa.table(
            {
                "v": pa.array(
                    [decimal.Decimal("1.25")], type=pa.decimal128(12, 2)
                )
            }
        ),
        d / "a.parquet",
    )
    pq.write_table(
        pa.table(
            {
                "v": pa.array(
                    [decimal.Decimal("2.375")],
                    type=pa.decimal128(12, 3),
                )
            }
        ),
        d / "b.parquet",
    )
    catalogs = CatalogManager()
    catalogs.register("hive", create_connector("hive", root=str(tmp_path)))
    r = LocalQueryRunner(catalogs=catalogs)
    rows = r.execute("select sum(v) as s from hive.s.t").rows()
    # 1.25 + round_half_up(2.375 -> 2.38) at scale 2
    assert rows[0][0] == pytest.approx(3.63)


def test_merge_column_chunks_unit(package):
    """Split payload merging: differing dictionaries union + remap,
    masked and unmasked chunks mix, same-dictionary fast path holds
    (the latent multi-split bug fixed alongside the hive connector)."""
    DictColumn = module(PKG, "connectors.tpch").DictColumn
    MaskedColumn = module(PKG, "exec.staging").MaskedColumn
    merge_column_chunks = module(PKG, "exec.staging").merge_column_chunks

    a = DictColumn(
        ids=np.array([0, 1], np.int32),
        values=np.asarray(["x", "y"], object),
    )
    b = DictColumn(
        ids=np.array([0, 1], np.int32),
        values=np.asarray(["a", "x"], object),
    )
    m = merge_column_chunks([a, b])
    vals = [str(m.values[i]) for i in m.ids]
    assert vals == ["x", "y", "a", "x"]
    # masked + dict mix
    c = MaskedColumn(
        data=np.array([0, 0], np.int32),
        valid=np.array([True, False]),
        values=("zz",),
    )
    m2 = merge_column_chunks([a, c])
    assert [str(m2.values[i]) for i in m2.data] == ["x", "y", "zz", "zz"]
    assert list(m2.valid) == [True, True, True, False]
    # numeric masked + plain
    m3 = merge_column_chunks(
        [
            np.array([1, 2], np.int64),
            MaskedColumn(
                data=np.array([3, 0], np.int64),
                valid=np.array([True, False]),
            ),
        ]
    )
    assert list(m3.data) == [1, 2, 3, 0]
    assert list(m3.valid) == [True, True, True, False]
    # same-dictionary fast path keeps values identical
    m4 = merge_column_chunks(
        [a, DictColumn(ids=np.array([1], np.int32), values=a.values)]
    )
    assert [str(m4.values[i]) for i in m4.ids] == ["x", "y", "y"]


def test_metastore_declares_key_types(package, tmp_path):
    """metastore.json at the root declares partition-key types (the
    reference's Hive Metastore as a file): a zero-padded numeric-ish
    key stays VARCHAR when declared, and a DATE key materializes as a
    real date column — neither is reachable by inference."""
    import json

    import pyarrow as pa
    import pyarrow.parquet as pq


    root = tmp_path / "wh"
    for code, day, vals in (
        ("001", "2024-01-01", [1, 2]),
        ("002", "2024-02-01", [3]),
    ):
        d = root / "sales" / "events" / f"code={code}" / f"day={day}"
        d.mkdir(parents=True)
        pq.write_table(
            pa.table({"v": pa.array(vals, pa.int64())}),
            d / "part-0.parquet",
        )
    (root / "metastore.json").write_text(json.dumps({
        "schemas": {"sales": {"events": {
            "partition_keys": {"code": "varchar", "day": "date"},
        }}},
    }))
    conn = create_connector("hive", root=str(root))
    schema = conn.metadata().get_table_schema(
        TableHandle("hive", "sales", "events")
    )
    assert schema["code"] == T.VARCHAR
    assert schema["day"].name == "date"

    catalogs = CatalogManager()
    catalogs.register("hive", conn)
    r = LocalQueryRunner(catalogs=catalogs)
    rows = r.execute(
        "select code, day, sum(v) as s from hive.sales.events "
        "group by code, day order by code"
    ).rows()
    import datetime

    assert rows == [
        ("001", datetime.date(2024, 1, 1), 3),
        ("002", datetime.date(2024, 2, 1), 3),
    ]
    # date-key predicate: correct rows despite no enumeration pruning
    assert r.execute(
        "select sum(v) as s from hive.sales.events "
        "where day = date '2024-02-01'"
    ).rows() == [(3,)]


def test_metastore_layout_mismatch_fails(package, tmp_path):
    import json

    import pyarrow as pa
    import pyarrow.parquet as pq


    root = tmp_path / "wh"
    d = root / "s" / "t" / "region=east"
    d.mkdir(parents=True)
    pq.write_table(
        pa.table({"v": pa.array([1], pa.int64())}), d / "p.parquet"
    )
    (root / "metastore.json").write_text(json.dumps({
        "schemas": {"s": {"t": {
            "partition_keys": {"zone": "varchar"},
        }}},
    }))
    conn = create_connector("hive", root=str(root))
    with pytest.raises(ValueError, match="metastore declares"):
        conn.metadata().get_table_schema(TableHandle("hive", "s", "t"))


# ---------------------------------------- both packages, one warehouse

CROSS_QUERIES = [
    "select region, year, count(*) as n, sum(amount) as s "
    "from hive.sales.orders group by region, year order by region, year",
    "select tag, count(*) as n, min(id) as lo, max(id) as hi "
    "from hive.sales.orders where year = 2024 group by tag order by tag",
    "select id, amount, tag, region, year from hive.sales.orders "
    "where region in ('west') and amount < 40 order by id",
]


@pytest.fixture(scope="module")
def both_runners(warehouse):
    root, _ = warehouse
    out = {}
    for pkg in PACKAGES:
        ns = {}
        bind(ns, pkg)
        catalogs = ns["CatalogManager"]()
        catalogs.register("hive", ns["create_connector"]("hive", root=str(root)))
        out[pkg] = ns["LocalQueryRunner"](catalogs=catalogs)
    return out


@pytest.mark.parametrize("i", range(len(CROSS_QUERIES)))
def test_port_reads_the_warehouse_as_the_reference(both_runners, i):
    sql = CROSS_QUERIES[i]
    want = both_runners["ref"].execute(sql).rows()
    assert want
    assert_rows_equal(both_runners["port"].execute(sql).rows(), want)


@pytest.mark.parametrize(
    "constraint",
    [(), (("region", ("east",)),), (("year", "range", 2024, 2024),),
     (("region", ("west",)), ("year", "range", 2023, 2023)),
     (("region", ()),)],
    ids=["none", "region", "year", "both", "empty"],
)
def test_pruned_partitions_and_split_ranges_equal_the_reference(
    warehouse, constraint
):
    """Partition pruning keeps the same files and the splits cover the
    same row ranges in both packages."""
    root, rows = warehouse
    got = {}
    for pkg in PACKAGES:
        spi = module(pkg, "connectors.spi")
        cons = tuple(
            (c[0], spi.RangeSet(c[2], c[3])) if len(c) == 4 else c
            for c in constraint
        )
        conn = module(pkg, "connectors").create_connector(
            "hive", root=str(root)
        )
        h = spi.TableHandle("hive", "sales", "orders")
        got[pkg] = split_ranges(
            conn, h, target_split_rows=128, constraint=cons
        )
    assert got["port"] == got["ref"]
    covered = sum(b - a for a, b in got["port"])
    assert covered <= len(rows) and (covered > 0) == (constraint != (("region", ()),))

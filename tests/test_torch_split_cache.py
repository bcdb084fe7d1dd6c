"""The port's device-resident split cache (``exec/staging.py::SplitCache``)
and its runner integration, against the reference's.

The cache sequences of ``tests/test_staging_cache.py`` replay against
both packages' ``SplitCache`` and ``MemoryPool`` on the same pages: each
keeps the reference test's assertions, and the ``stats()`` and pool
snapshots it passes through must be equal across the packages. Then the
spill round trip bit for bit, and the runner: a repeated query served
from the cache without touching the connector, the byte budget held
through the pool, and a streamed tiny query under
``max_device_rows=8192`` with ``stream_split_cache`` on, equal to the
uncached run and to the reference, whose second run is all hits.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from presto_tpu import types as ref_types
from presto_tpu.connectors import spi as ref_spi
from presto_tpu.connectors import tpch as ref_tpch
from presto_tpu.exec import staging as ref_staging
from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu.utils import memory as ref_memory
from presto_tpu_torch import convert, native
from presto_tpu_torch import types as port_types
from presto_tpu_torch.connectors import spi as port_spi
from presto_tpu_torch.connectors import tpch as port_tpch
from presto_tpu_torch.exec import staging as port_staging
from presto_tpu_torch.exec.local_runner import LocalQueryRunner
from presto_tpu_torch.utils import memory as port_memory
from torch_parity import assert_columns_equal, jax_live_columns
from torch_parity import one_torch_thread  # noqa: F401


def _package(staging, memory, types, spi, tpch, **stage_kw):
    return SimpleNamespace(
        staging=staging, memory=memory, T=types, spi=spi, tpch=tpch,
        stage=lambda data, schema: staging.stage_page(
            data, schema, **stage_kw
        ),
    )


REF = _package(ref_staging, ref_memory, ref_types, ref_spi, ref_tpch)
PORT = _package(
    port_staging, port_memory, port_types, port_spi, port_tpch,
    device="cpu",
)


def _page(pkg, n=1024, fill=1):
    return pkg.stage({"x": np.full(n, fill, np.int64)}, {"x": pkg.T.BIGINT})


def _h(pkg, table):
    return pkg.spi.TableHandle("tpch", "tiny", table)


# ---------------------------------------------- SplitCache sequences
# Each takes a package and returns what it observed; the reference
# test's own assertions run inside, on both packages.


def _lru_under_budget_and_pool(pkg):
    SplitCache = pkg.staging.SplitCache
    pool = pkg.memory.MemoryPool(1 << 20)
    nbytes = pkg.staging.page_nbytes(_page(pkg))
    cache = SplitCache(budget_bytes=int(nbytes * 2.5), pool=pool)
    k1, k2, k3, k4 = [(_h(pkg, "a"), i) for i in range(4)]
    seen = []
    assert cache.put(k1, _page(pkg, fill=1))
    assert cache.put(k2, _page(pkg, fill=2))
    assert pool.used_bytes(SplitCache.OWNER) == cache.used_bytes()
    seen.append(pool.snapshot())
    assert cache.put(k3, _page(pkg, fill=3))  # evicts k1 (LRU)
    assert cache.evictions == 1
    assert cache.used_bytes() <= cache.budget
    assert cache.get(k1) is None
    assert cache.get(k2) is not None  # refreshes k2
    assert cache.put(k4, _page(pkg, fill=4))  # now evicts k3, not k2
    assert cache.get(k3) is None
    assert cache.get(k2) is not None
    stats = cache.stats()
    assert stats["evictions"] == 2
    assert stats["bytes"] == pool.used_bytes(SplitCache.OWNER)
    return seen + [stats, pool.snapshot()]


def _oversized_entry(pkg):
    cache = pkg.staging.SplitCache(budget_bytes=100)
    assert not cache.put((_h(pkg, "a"), 0), _page(pkg))
    assert cache.used_bytes() == 0
    return [cache.stats()]


def _fill_never_kills_a_query(pkg):
    pool = pkg.memory.MemoryPool(10_000)
    pool.reserve("q_running", 9_000)
    cache = pkg.staging.SplitCache(budget_bytes=1 << 20, pool=pool)
    assert not cache.put((_h(pkg, "a"), 0), _page(pkg))  # 8 KB won't fit
    assert pool.used_bytes("q_running") == 9_000
    assert cache.used_bytes() == 0
    return [cache.stats(), pool.snapshot()]


def _pressure_reclaim(pkg):
    SplitCache = pkg.staging.SplitCache
    nbytes = pkg.staging.page_nbytes(_page(pkg))
    pool = pkg.memory.MemoryPool(int(nbytes * 3.5))
    cache = SplitCache(budget_bytes=1 << 20, pool=pool)
    for i in range(3):
        assert cache.put((_h(pkg, "a"), i), _page(pkg, fill=i))
    pool.reserve("q_live", int(nbytes * 2))
    assert pool.used_bytes("q_live") == int(nbytes * 2)
    assert cache.stats()["entries"] <= 1  # LRU entries yielded
    assert pool.used_bytes(SplitCache.OWNER) == cache.used_bytes()
    return [cache.stats(), pool.snapshot()]


def _pinned_entries(pkg):
    SplitCache = pkg.staging.SplitCache
    nbytes = pkg.staging.page_nbytes(_page(pkg))
    pool = pkg.memory.MemoryPool(int(nbytes * 4.5))
    cache = SplitCache(budget_bytes=1 << 20, pool=pool)
    keys = [(_h(pkg, "a"), i) for i in range(3)]
    for i, k in enumerate(keys):
        assert cache.put(k, _page(pkg, fill=i))
    assert cache.get(keys[0], pin=True) is not None
    # pressure for ~2 pages: LRU order would take k0 first, but it is
    # pinned, so k1 and k2 go
    pool.reserve("q_live", int(nbytes * 3))
    assert cache.get(keys[0]) is not None
    assert cache.get(keys[1]) is None and cache.get(keys[2]) is None
    assert pool.used_bytes(SplitCache.OWNER) == cache.used_bytes()
    seen = [cache.stats(), pool.snapshot()]
    # a fully pinned cache cannot meet further pressure
    with pytest.raises(pkg.memory.MemoryLimitExceeded):
        pool.reserve("q_more", int(nbytes * 2))
    cache.unpin(keys[0])
    pool.reserve("q_more", int(nbytes * 1.2))  # now evictable
    assert cache.stats()["entries"] == 0
    return seen + [cache.stats(), pool.snapshot()]


def _failed_reservation_keeps_entries(pkg):
    nbytes = pkg.staging.page_nbytes(_page(pkg))
    pool = pkg.memory.MemoryPool(int(nbytes * 2.5))
    cache = pkg.staging.SplitCache(budget_bytes=int(nbytes * 1.5), pool=pool)
    assert cache.put((_h(pkg, "a"), 0), _page(pkg))
    pool.reserve("q_live", int(nbytes * 1.2))  # the pool is now tight
    assert not cache.put((_h(pkg, "a"), 1), _page(pkg))
    assert cache.stats()["entries"] == 1  # the resident entry survived
    return [cache.stats(), pool.snapshot()]


def _invalidate(pkg):
    SplitCache = pkg.staging.SplitCache
    pool = pkg.memory.MemoryPool(1 << 20)
    cache = SplitCache(budget_bytes=1 << 20, pool=pool)
    cache.put((_h(pkg, "a"), 0), _page(pkg))
    cache.put((_h(pkg, "a"), 1), _page(pkg))
    cache.put((_h(pkg, "b"), 0), _page(pkg))
    assert cache.invalidate(_h(pkg, "a")) == 2
    assert cache.stats()["entries"] == 1
    assert pool.used_bytes(SplitCache.OWNER) == cache.used_bytes()
    cache.clear()
    assert pool.used_bytes() == 0
    return [cache.stats(), pool.snapshot()]


def _spill_lane(pkg):
    """LRU pressure spills to host RAM; a get restages; pressure reclaim
    spills too; a spill budget too small drops instead."""
    SplitCache = pkg.staging.SplitCache
    nbytes = pkg.staging.page_nbytes(_page(pkg))
    pool = pkg.memory.MemoryPool(1 << 20)
    cache = SplitCache(
        budget_bytes=int(nbytes * 2.5), pool=pool,
        spill_bytes=int(nbytes * 1.5),
    )
    keys = [(_h(pkg, "a"), i) for i in range(4)]
    seen = []
    for i, k in enumerate(keys[:3]):
        assert cache.put(k, _page(pkg, fill=i))
    seen.append(cache.stats())  # k0 spilled
    assert cache.get(keys[0]) is not None  # restaged, k1 spilled
    seen.append(cache.stats())
    assert cache.evict_bytes(nbytes) == nbytes  # k2 spills, k1 dropped
    seen.append(cache.stats())
    assert cache.get(keys[1]) is None  # dropped from the spill store
    cache.set_spill_budget(0)
    seen.append(cache.stats())
    assert pool.used_bytes(SplitCache.OWNER) == cache.used_bytes()
    return seen + [pool.snapshot()]


SEQUENCES = {
    f.__name__.strip("_"): f
    for f in (
        _lru_under_budget_and_pool,
        _oversized_entry,
        _fill_never_kills_a_query,
        _pressure_reclaim,
        _pinned_entries,
        _failed_reservation_keeps_entries,
        _invalidate,
        _spill_lane,
    )
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_cache_sequence_matches_reference(name):
    assert SEQUENCES[name](PORT) == SEQUENCES[name](REF)


def test_default_budget_is_the_references():
    assert port_staging.DEFAULT_CACHE_BYTES == ref_staging.DEFAULT_CACHE_BYTES
    assert port_staging.SplitCache.OWNER == ref_staging.SplitCache.OWNER


# ------------------------------------------------------ host-spill lane


def _spill_pages(pkg):
    schema = {"a": pkg.T.BIGINT, "s": pkg.T.VARCHAR, "d": pkg.T.DOUBLE}
    rng = np.random.default_rng(7)

    def mk(seed):
        d = rng.normal(size=500)
        return pkg.stage(
            {
                "a": np.arange(seed, seed + 500, dtype=np.int64),
                "s": pkg.tpch.DictColumn(
                    ids=np.arange(500, dtype=np.int32) % 3,
                    values=np.array(["x", "y", "z"], object),
                ),
                "d": pkg.staging.MaskedColumn(
                    data=d, valid=np.arange(500) % 5 != 0
                ),
            },
            schema,
        )

    return mk(0), mk(7)


def test_spill_round_trip_bit_identical():
    """A page evicted to host RAM and restaged equals the original bit
    for bit: data, validity, dictionary, capacity and num_valid, as the
    reference's does."""
    p1, p2 = _spill_pages(PORT)
    pool = port_memory.MemoryPool(1 << 20)
    c = port_staging.SplitCache(
        budget_bytes=port_staging.page_nbytes(p1) + 64, pool=pool,
        spill_bytes=1 << 20,
    )
    assert c.put("k1", p1)
    assert c.put("k2", p2)  # evicts k1 to the spill store
    st = c.stats()
    assert st["spill_entries"] == 1 and st["spills"] == 1
    assert c.spill_used_bytes() == port_staging.page_nbytes(p1)
    got = c.get("k1")  # restaged from host RAM
    assert got is not None and got is not p1
    assert got.capacity == p1.capacity and got.names == p1.names
    assert int(got.num_valid) == int(p1.num_valid) == 500
    for b_got, b_ref in zip(got.blocks, p1.blocks):
        assert b_got.data.dtype == b_ref.data.dtype
        assert b_got.data.numpy().tobytes() == b_ref.data.numpy().tobytes()
        assert (b_got.valid is None) == (b_ref.valid is None)
        if b_ref.valid is not None:
            assert bool((b_got.valid == b_ref.valid).all())
        assert b_got.dictionary == b_ref.dictionary
    assert c.stats()["restages"] == 1
    assert pool.used_bytes("table-cache") == c.stats()["bytes"]
    c.clear()
    assert pool.used_bytes() == 0 and c.spill_used_bytes() == 0


def test_spill_round_trip_keeps_the_live_mask():
    import torch

    page = _page(PORT, n=2048)
    live = torch.arange(2048) % 3 == 0
    masked = dataclasses.replace(page, live=live)
    back = port_staging.host_to_page(port_staging.page_to_host(masked))
    assert bool((back.live == live).all())
    assert bool((back.blocks[0].data == page.blocks[0].data).all())


def test_spilled_pages_equal_the_references_bytes():
    """The same payload staged and spilled in both packages holds the
    same host bytes."""
    (rp, _), (pp, _) = _spill_pages(REF), _spill_pages(PORT)
    host = port_staging.page_to_host(pp).page
    ref_host = ref_staging.page_to_host(rp)
    for b_port, b_ref in zip(host.blocks, ref_host.blocks):
        np.testing.assert_array_equal(
            b_port.data.numpy(), np.asarray(b_ref.data)
        )
        assert list(b_port.dictionary.values if b_port.dictionary else []) \
            == list(b_ref.dictionary.values if b_ref.dictionary else [])


# ---------------------------------------------------- runner integration


def _spy_connector(runner):
    conn = runner.catalogs.get("tpch")
    calls = []
    orig = conn.create_page_source

    def spy(split, columns):
        calls.append((split.row_start, split.row_end))
        return orig(split, columns)

    conn.create_page_source = spy
    return calls


def test_repeated_query_hits_cache_and_skips_connector():
    r = LocalQueryRunner(device="cpu")
    calls = _spy_connector(r)
    q = "select count(*) as c, sum(r_regionkey) as s from tpch.tiny.region"
    first = r.execute(q)
    assert len(calls) > 0
    calls.clear()
    second = r.execute(q)
    assert calls == [], "the warm run must not touch the connector"
    assert first.rows() == second.rows() == RefRunner().execute(q).rows()
    assert r.split_cache.hits >= 1
    warm_qs = r.history.snapshot()[-1]
    assert warm_qs.staging_cache_hits >= 1
    assert warm_qs.state == "FINISHED" and warm_qs.input_rows == 5


def test_cache_budget_held_through_the_pool():
    """With a budget far below the working set the cache never holds
    more than ``staging_cache_bytes``, the pool's table-cache owner
    equals the cache's bytes, no query-owned bytes outlive a query, and
    eviction keeps the answers right."""
    pool = port_memory.MemoryPool(1 << 30)
    budget = 200_000  # region, nation, supplier fit; lineitem does not
    r = LocalQueryRunner(
        device="cpu", memory_pool=pool, staging_cache_bytes=budget
    )
    queries = [
        "select count(*) as c from tpch.tiny.region",
        "select count(*) as c from tpch.tiny.nation",
        "select count(*) as c from tpch.tiny.supplier",
        "select sum(l_quantity) as s from tpch.tiny.lineitem",
        "select count(*) as c from tpch.tiny.region",
    ]
    expect = [[(5,)], [(25,)], [(100,)], None, [(5,)]]
    for q, exp in zip(queries * 2, expect * 2):
        res = r.execute(q)
        if exp is not None:
            assert res.rows() == exp
        assert r.split_cache.used_bytes() <= budget
        snap = pool.snapshot()
        assert snap["used"].get("table-cache", 0) == r.split_cache.used_bytes()
        assert set(snap["used"]) <= {"table-cache"}, snap
    # lineitem's page is larger than the budget: never cached, staged
    # on both of its runs and accounted under its query meanwhile
    assert r.split_cache.stats()["entries"] == 3


def test_whole_table_entries_pin_for_the_query_and_release():
    r = LocalQueryRunner(device="cpu")
    r.execute("select count(*) from tpch.tiny.nation")
    assert r.split_cache._pins == {}
    qs = r.history.snapshot()[-1]
    assert qs._pinned_keys == []


STREAM_SQL = (
    "select l_returnflag, l_linestatus, count(*) as c, "
    "sum(l_quantity) as q, sum(l_extendedprice * (1 - l_discount)) as r, "
    "avg(l_discount) as d "
    "from tpch.tiny.lineitem where l_shipdate <= date '1998-09-02' "
    "group by l_returnflag, l_linestatus "
    "order by l_returnflag, l_linestatus"
)
STREAM_PROPS = {"max_device_rows": 8192}


def _stream_runner(cache: bool, **kw):
    r = LocalQueryRunner(device="cpu", **kw)
    for k, v in STREAM_PROPS.items():
        r.session.set(k, v)
    r.session.set("stream_split_cache", cache)
    return r


@pytest.fixture(scope="module")
def stream_reference():
    ref = RefRunner()
    for k, v in STREAM_PROPS.items():
        ref.session.set(k, v)
    return jax_live_columns(ref.execute(STREAM_SQL).page)


def test_streamed_split_cache_second_run_is_all_hits(stream_reference):
    plain = _stream_runner(False).execute(STREAM_SQL)
    pool = port_memory.MemoryPool(1 << 30)
    r = _stream_runner(True, memory_pool=pool)
    calls = _spy_connector(r)
    first = r.execute(STREAM_SQL)
    assert r.stream_stats.batches > 1, "the query did not stream"
    n_splits = len(calls)
    st1 = r.split_cache.stats()
    assert st1["misses"] == n_splits > 1 and st1["hits"] == 0
    calls.clear()
    gen_calls = native.gen_uniform.calls
    r.stream_stats = type(r.stream_stats)()
    second = r.execute(STREAM_SQL)
    st2 = r.split_cache.stats()
    assert calls == [], "the cached pass must not touch the connector"
    assert native.gen_uniform.calls == gen_calls
    assert st2["misses"] == st1["misses"]
    assert st2["hits"] == n_splits
    assert r.stream_stats.generate_s == 0.0
    assert r.stream_stats.staged_bytes == 0
    assert r.history.snapshot()[-1].staging_cache_hits == n_splits
    for res in (first, second):
        port_cols = convert.page_to_numpy(res.page)
        assert_columns_equal(convert.page_to_numpy(plain.page), port_cols,
                             rtol=0.0)
        assert_columns_equal(stream_reference, port_cols)
    # pool accounting: the batches are cache-owned, nothing query-owned
    snap = pool.snapshot()
    assert snap["used"] == {"table-cache": r.split_cache.used_bytes()}
    assert r.split_cache._pins == {}


def test_streamed_pass_over_budget_caches_its_first_batches():
    """Pins last as long as the query: a streamed pass larger than the
    budget caches what fits first and stages the rest, as the
    reference's does."""
    probe = _stream_runner(True)
    probe.execute(STREAM_SQL)
    per_batch = probe.split_cache.used_bytes() // probe.split_cache.stats()[
        "entries"]
    r = _stream_runner(True, staging_cache_bytes=3 * per_batch)
    r.execute(STREAM_SQL)
    st = r.split_cache.stats()
    assert st["entries"] == 3 and st["evictions"] == 0
    second = r.execute(STREAM_SQL)
    st2 = r.split_cache.stats()
    assert st2["hits"] == 3
    assert second.rows() == probe.execute(STREAM_SQL).rows()


def test_spilled_vs_unspilled_results_bit_identical(stream_reference):
    """A streamed query whose cached batches were pushed to host RAM by
    pool pressure restages them and returns the same rows."""
    expect = convert.page_to_numpy(_stream_runner(False).execute(
        STREAM_SQL).page)
    pool = port_memory.MemoryPool(1 << 30)
    r = _stream_runner(True, memory_pool=pool, staging_cache_bytes=1 << 20)
    r.split_cache.set_spill_budget(64 << 20)
    first = r.execute(STREAM_SQL)
    freed = r.split_cache.evict_bytes(1 << 30)
    assert freed > 0
    st = r.split_cache.stats()
    assert st["spills"] > 0 and st["bytes"] == 0, st
    second = r.execute(STREAM_SQL)
    st = r.split_cache.stats()
    assert st["restages"] > 0, st
    assert r.history.snapshot()[-1].spilled_bytes > 0
    for res in (first, second):
        got = convert.page_to_numpy(res.page)
        assert_columns_equal(expect, got, rtol=0.0)
        assert_columns_equal(stream_reference, got)


def test_execute_releases_what_it_reserved():
    """EXECUTE runs with a query's lifecycle in the port: a table larger
    than the cache budget is reserved under the query while it runs and
    released after. The reference runs EXECUTE without one, so there
    each EXECUTE leaves that table's bytes reserved under "adhoc"
    (ROADMAP §3); the rows are the same."""
    prep = (
        "prepare p from select count(*) from tpch.tiny.lineitem "
        "where l_quantity < ?"
    )
    budget = 100_000  # lineitem's page does not fit
    port_pool = port_memory.MemoryPool(1 << 30)
    r = LocalQueryRunner(device="cpu", memory_pool=port_pool,
                         staging_cache_bytes=budget)
    ref_pool = ref_memory.MemoryPool(1 << 30)
    ref = RefRunner(memory_pool=ref_pool, staging_cache_bytes=budget)
    r.execute(prep)
    ref.execute(prep)
    leaked = []
    for v in (10, 20, 30):
        sql = f"execute p using {v}"
        assert r.execute(sql).rows() == ref.execute(sql).rows()
        assert port_pool.snapshot()["used"] == {}
        leaked.append(ref_pool.used_bytes("adhoc"))
        assert r.history.snapshot()[-1].sql == sql
    assert leaked[0] > 0 and leaked == [leaked[0] * k for k in (1, 2, 3)]

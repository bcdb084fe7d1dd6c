"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one: a CUDA kernel
has no CPU mode, and on the CPU the wrappers take the plain versions,
which the parity tests (tests/test_torch_aggregation.py) cover. On a
machine with a card, without JAX, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

This file imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from presto_tpu_torch.ops.aggregation import (
    K_MAX,
    onehot_reduce,
    onehot_reduce_lanes,
    onehot_reduce_lanes_plain,
    onehot_reduce_many,
    onehot_reduce_many_plain,
    onehot_reduce_plain,
    onehot_results,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(rows, nseg, dtype, with_valid, seed, dev):
    """Segment ids with dead (== nseg) and out-of-range rows, one empty
    segment, values with a NaN for floats, and an optional null mask."""
    rng = np.random.default_rng(seed)
    g = rng.integers(-1, nseg + 2, rows).astype(np.int32)
    if nseg > 1:
        g[g == nseg - 1] = nseg  # the last segment stays empty
    valid = rng.random(rows) < 0.8 if with_valid else None
    if dtype == torch.int64:
        x = rng.integers(-(2**40), 2**40, rows, dtype=np.int64)
    else:
        x = rng.standard_normal(rows) * 1e3
        if rows:
            x[rows // 2] = np.nan
    tx = torch.from_numpy(x).to(dtype=dtype, device=dev)
    tv = None if valid is None else torch.from_numpy(valid).to(dev)
    return torch.from_numpy(g).to(dev), tx, tv


def _assert_agrees(got, want, op, abs_sum):
    """Integer results and float min/max exactly; float sums within a
    relative ``tol`` of each segment's sum of |x|, because the kernel
    adds in another order than the plain version (1e-12 for float64;
    1e-5 for float32, the bound tools/pallas_groupby.py holds the TPU
    kernel to)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if not got.is_floating_point():
        assert torch.equal(got, want), (got, want)
        return
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    if op in ("min", "max"):
        assert torch.equal(got[~nan], want[~nan]), (got, want)
        return
    tol = 1e-12 if got.dtype == torch.float64 else 1e-5
    err = (got[~nan].double() - want[~nan].double()).abs()
    assert bool((err <= tol * abs_sum[~nan].double()).all()), (got, want)


#: (op, value dtype); count takes no values, so one dtype covers it
OPS = [("count", torch.int64)] + [
    (op, dtype)
    for op in ("sum", "min", "max")
    for dtype in (torch.int64, torch.float64, torch.float32)
]


@pytest.mark.parametrize("op,dtype", OPS)
@pytest.mark.parametrize(
    "rows,nseg", [(0, 6), (1, 1), (1000, 6), (70_001, 256), (1_000_003, 12)]
)
@pytest.mark.parametrize("with_valid", [False, True])
def test_onehot_reduce_matches_plain(cuda, op, dtype, rows, nseg, with_valid):
    g, x, v = _inputs(rows, nseg, dtype, with_valid, rows + nseg, cuda)
    if op == "count":
        x = None
    before = onehot_reduce.launches
    got = onehot_reduce(g, x, v, nseg, op)
    want = onehot_reduce_plain(g, x, v, nseg, op)
    torch.cuda.synchronize()
    assert onehot_reduce.launches == before + 1
    abs_sum = None
    if op == "sum" and x.is_floating_point():
        abs_sum = onehot_reduce_plain(g, x.abs(), v, nseg, "sum")
    _assert_agrees(got, want, op, abs_sum)


def test_onehot_reduce_takes_strided_inputs(cuda):
    g, x, v = _inputs(20_000, 6, torch.int64, True, 3, cuda)
    got = onehot_reduce(g[::2], x[::2], v[::2], 6, "sum")
    want = onehot_reduce_plain(g[::2], x[::2], v[::2], 6, "sum")
    assert torch.equal(got, want)


def test_onehot_reduce_int64_sum_wraps_like_the_plain_version(cuda):
    g = torch.zeros(4, dtype=torch.int32, device=cuda)
    x = torch.full((4,), 2**62, dtype=torch.int64, device=cuda)
    got = onehot_reduce(g, x, None, 1, "sum")
    assert torch.equal(got, onehot_reduce_plain(g, x, None, 1, "sum"))


def test_onehot_reduce_refuses_mixed_devices(cuda):
    g = torch.zeros(8, dtype=torch.int32, device=cuda)
    x = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="device"):
        onehot_reduce(g, x, None, 4, "sum")


# ------------------------------------------ K requests in one launch

#: the per-thread shared-memory layout takes nseg <= 32
#: (kPerThreadMaxSegments in csrc/onehot_reduce.cu); above it, per warp
LAYOUT_LIMIT = 32


def _requests(rows, k, nseg, seed, dev):
    """k requests cycling through every (op, dtype), masked or not."""
    reqs = []
    for i in range(k):
        op, dtype = OPS[i % len(OPS)]
        _, x, v = _inputs(rows, nseg, dtype, i % 3 == 1, seed + i, dev)
        reqs.append((op, None if op == "count" else x, v))
    return reqs


def _assert_many_agrees(g, reqs, nseg, out):
    assert out.shape == (len(reqs), nseg) and out.dtype == torch.int64
    got_rows = onehot_results(out, reqs)
    want_rows = onehot_results(onehot_reduce_many_plain(g, reqs, nseg), reqs)
    for got, want, (op, x, v) in zip(got_rows, want_rows, reqs):
        abs_sum = None
        if op == "sum" and x.is_floating_point():
            abs_sum = onehot_reduce_plain(g, x.abs(), v, nseg, "sum")
        _assert_agrees(got, want, op, abs_sum)


@pytest.mark.parametrize("rows", [0, 1, 1000, 70_001, 1_000_003])
@pytest.mark.parametrize(
    "nseg", [1, LAYOUT_LIMIT, LAYOUT_LIMIT + 1, 256]
)
@pytest.mark.parametrize("k", [1, 16, 17, K_MAX, K_MAX + 1])
def test_onehot_reduce_many_matches_plain(cuda, rows, nseg, k):
    g = _inputs(rows, nseg, torch.int64, False, rows + nseg, cuda)[0]
    reqs = _requests(rows, k, nseg, rows + k, cuda)
    before = onehot_reduce.launches
    out = onehot_reduce_many(g, reqs, nseg)
    torch.cuda.synchronize()
    # one launch for up to K_MAX (64) requests, a second past them
    assert onehot_reduce.launches == before + (1 if k <= K_MAX else 2)
    _assert_many_agrees(g, reqs, nseg, out)


@pytest.mark.parametrize("nseg", [6, LAYOUT_LIMIT + 1])
def test_onehot_reduce_many_takes_unaligned_views(cuda, nseg):
    # g[1:] and x[3:] start off 16-byte alignment; the kernel's scalar
    # head and tail take them
    rows = 100_003
    g, x, v = _inputs(rows + 3, nseg, torch.int64, True, 7, cuda)
    _, xf, _ = _inputs(rows + 3, nseg, torch.float32, False, 8, cuda)
    _, xd, _ = _inputs(rows + 3, nseg, torch.float64, False, 9, cuda)
    g1, v1 = g[1:rows + 1], v[1:rows + 1]
    reqs = [
        ("count", None, v1),
        ("sum", x[3:rows + 3], None),
        ("sum", xf[3:rows + 3], v1),
        ("max", xd[3:rows + 3], None),
        ("min", x[1:rows + 1], v1),
    ]
    _assert_many_agrees(g1, reqs, nseg, onehot_reduce_many(g1, reqs, nseg))


def test_onehot_reduce_many_int64_sum_wraps(cuda):
    g = torch.zeros(70_001, dtype=torch.int32, device=cuda)
    x = torch.full((70_001,), 2**62, dtype=torch.int64, device=cuda)
    reqs = [("sum", x, None), ("count", None, None)]
    out = onehot_reduce_many(g, reqs, 1)
    assert torch.equal(out, onehot_reduce_many_plain(g, reqs, 1))


@pytest.mark.parametrize("nseg", [6, LAYOUT_LIMIT + 1])
def test_onehot_reduce_many_float_sums_are_bit_identical(cuda, nseg):
    g, x, _ = _inputs(2_000_003, nseg, torch.float64, False, 5, cuda)
    x = torch.nan_to_num(x)
    reqs = [("sum", x, None), ("sum", x.to(torch.float32), None)]
    first = onehot_reduce_many(g, reqs, nseg)
    for _ in range(3):
        assert torch.equal(onehot_reduce_many(g, reqs, nseg), first)


# ------------------------------- the direct and large forms, lane by lane


def _assert_lanes_agree(g, reqs, nseg, lanes, out):
    assert out.shape == (len(reqs), lanes * nseg) and out.dtype == torch.int64
    want = onehot_reduce_lanes_plain(g, reqs, nseg, lanes)
    for got, exp, (op, x, v) in zip(
        onehot_results(out, reqs), onehot_results(want, reqs), reqs
    ):
        abs_sum = None
        if op == "sum" and x.is_floating_point():
            req = [("sum", x.abs(), v)]
            abs_sum = onehot_results(
                onehot_reduce_lanes_plain(g, req, nseg, lanes), req)[0]
        _assert_agrees(got, exp, op, abs_sum)


def _lanes_once(g, reqs, nseg, lanes):
    """One lane call: its result, held to one launch and to a second
    call bit for bit."""
    before = onehot_reduce.launches
    out = onehot_reduce_lanes(g, reqs, nseg, lanes)
    torch.cuda.synchronize()
    assert onehot_reduce.launches == before + 1
    assert torch.equal(onehot_reduce_lanes(g, reqs, nseg, lanes), out)
    return out


@pytest.mark.parametrize("rows", [0, 1, 4095])
@pytest.mark.parametrize("nseg", [1, LAYOUT_LIMIT, LAYOUT_LIMIT + 1, 256])
@pytest.mark.parametrize("lanes", [1, 8, 64])
def test_direct_form_matches_plain(cuda, rows, nseg, lanes):
    # lanes of at most 4,096 rows: one block per (request, lane), the
    # result written straight to out; 17 requests cover every op and
    # dtype, masked and not
    g = _inputs(lanes * rows, nseg, torch.int64, False, rows + nseg, cuda)[0]
    reqs = _requests(lanes * rows, 17, nseg, rows + lanes, cuda)
    _assert_lanes_agree(g, reqs, nseg, lanes, _lanes_once(g, reqs, nseg, lanes))


@pytest.mark.parametrize("rows", [4097, 70_001])
@pytest.mark.parametrize("nseg", [1, 6, LAYOUT_LIMIT + 1, 256])
@pytest.mark.parametrize("lanes", [1, 8, 64])
def test_large_lane_form_matches_plain(cuda, rows, nseg, lanes):
    # lanes past 4,096 rows: the persistent grid split over the lanes,
    # each lane combined by its own last block
    g = _inputs(lanes * rows, nseg, torch.int64, False, rows + nseg, cuda)[0]
    reqs = _requests(lanes * rows, 17, nseg, rows + lanes, cuda)
    _assert_lanes_agree(g, reqs, nseg, lanes, _lanes_once(g, reqs, nseg, lanes))


@pytest.mark.parametrize("rows", [100, 4095, 70_001])
@pytest.mark.parametrize("k", [1, 16, 17, K_MAX])
def test_k_requests_over_lanes_are_one_launch(cuda, rows, k):
    lanes, nseg = 8, LAYOUT_LIMIT + 1
    g = _inputs(lanes * rows, nseg, torch.int64, True, rows + k, cuda)[0]
    reqs = _requests(lanes * rows, k, nseg, rows * k, cuda)
    _assert_lanes_agree(g, reqs, nseg, lanes, _lanes_once(g, reqs, nseg, lanes))


def test_lane_form_takes_a_dead_lane_and_unaligned_views(cuda):
    # lane 3 keeps no row; gid and x start off 16-byte alignment
    lanes, rows, nseg = 8, 10_001, 6
    g, x, v = _inputs(lanes * rows + 3, nseg, torch.int64, True, 21, cuda)
    g[1 + 3 * rows:1 + 4 * rows] = nseg
    g = g[1:lanes * rows + 1]  # 4 bytes past an aligned start; odd lanes
    _, xd, _ = _inputs(lanes * rows + 3, nseg, torch.float64, False, 22, cuda)
    reqs = [("count", None, v[2:lanes * rows + 2]),
            ("sum", x[3:lanes * rows + 3], None),
            ("max", xd[1:lanes * rows + 1], v[1:lanes * rows + 1]),
            ("sum", xd[3:lanes * rows + 3], None)]
    out = _lanes_once(g, reqs, nseg, lanes)
    _assert_lanes_agree(g, reqs, nseg, lanes, out)
    assert int(out[0][3 * nseg:4 * nseg].sum()) == 0


# ------------------------------------------- the slice's queries on the card

#: BASELINE.json's window configuration (bench.py's window query)
WINDOW = """
select o_orderkey, o_custkey,
  row_number() over (partition by o_custkey order by o_orderdate) as rn,
  rank() over (partition by o_orderpriority order by o_totalprice) as rk
from tpch.tiny.orders
"""


def _card_queries():
    from tpch_queries import QUERIES

    not_exists = """
    and not exists (
      select * from orders where o_custkey = c_custkey)
"""
    assert not_exists in QUERIES[22]
    out = {q: QUERIES[q] for q in range(1, 23)}
    out["q22_without_not_exists"] = QUERIES[22].replace(not_exists, "\n")
    out["window"] = WINDOW
    return out


def _rows_agree(got, want):
    """Equal rows; doubles within rel 1e-9 (a reduction on the card adds
    in another order)."""
    import math

    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                if not (a == b or math.isclose(a, b, rel_tol=1e-9)
                        or (math.isnan(a) and math.isnan(b))):
                    return False
            elif a != b:
                return False
    return True


@pytest.mark.parametrize("q", sorted(_card_queries(), key=str), ids=str)
def test_tpch_join_queries_on_the_card_equal_the_cpu(cuda, q):
    # all 22 TPC-H queries, Q22 without its NOT EXISTS (which keeps no
    # row at tiny: the generator gives every customer orders) and the
    # window query, on the card against the port's CPU runner: joins,
    # the sorted and one-hot GROUP BYs, LIKE/EXTRACT/dictionary LUTs
    # copied to the card, windows, and stage-at-a-time execution with
    # dynamic filters (Q3, Q5). Q18's HAVING keeps no order at tiny
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner

    sql = _card_queries()[q]
    gpu = LocalQueryRunner(device="cuda")
    cpu = LocalQueryRunner(device="cpu")
    got = gpu.execute(sql).rows()
    assert _rows_agree(got, cpu.execute(sql).rows())
    assert len(got) > 0 or q in (18, 22)
    if q in (3, 5):
        assert gpu.fragments_run > 0 and gpu.dynamic_filters_applied > 0
    assert got == gpu.execute(sql).rows()  # a warm run repeats


# ------------------------------------------------ streamed on the card


@pytest.mark.parametrize("q", ["q1", "q18_250"])
def test_streamed_queries_on_the_card_equal_the_cpu(cuda, q):
    # lineitem (~60k rows at tiny) over a 16,384-row budget streams in
    # 4,096-row batches with host spill buckets; the partial and final
    # one-hot GROUP BYs of Q1 launch the kernel on the card. Q18's
    # HAVING keeps no order at tiny at 300, so it runs at 250
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.session import Session
    from tpch_queries import QUERIES

    from presto_tpu_torch.ops import aggregation as PA

    sql = QUERIES[1] if q == "q1" else QUERIES[18].replace("> 300", "> 250")
    props = {"max_device_rows": 16_384, "page_capacity": 4_096}
    gpu = LocalQueryRunner(device="cuda", session=Session(properties=props))
    cpu = LocalQueryRunner(device="cpu", session=Session(properties=props))
    calls = []
    real = PA.onehot_reduce_many

    def spy(gid, requests, nseg):
        calls.append(len(requests))
        return real(gid, requests, nseg)

    before = onehot_reduce.launches
    PA.onehot_reduce_many = spy
    try:
        got = gpu.execute(sql).rows()
    finally:
        PA.onehot_reduce_many = real
    launches = onehot_reduce.launches - before
    stats = gpu.stream_stats
    assert stats.batches > 0 and stats.buckets > 0
    assert len(got) > 0 and _rows_agree(got, cpu.execute(sql).rows())
    if q == "q1":
        # one one-hot call per batch and per bucket merge, each one
        # launch (a call makes at most K_MAX requests)
        assert len(calls) == stats.batches + stats.buckets
        assert launches == len(calls) > 0 and max(calls) <= K_MAX
    assert got == gpu.execute(sql).rows()  # a warm run repeats


# --------------------------------- one-row results with a broadcast column


@pytest.mark.parametrize("streamed", [False, True], ids=["default", "streamed"])
def test_broadcast_one_row_results_on_the_card_equal_the_cpu(cuda, streamed):
    # a literal beside a global aggregate, two count(distinct) joined by
    # the single-row cross join, and a ROLLUP grand total: each result
    # holds a stride-0 block that page.to_host copies to the host
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.session import Session
    from broadcast_queries import QUERIES

    props = {"max_device_rows": 8_192} if streamed else {}
    gpu = LocalQueryRunner(device="cuda", session=Session(properties=props))
    cpu = LocalQueryRunner(device="cpu", session=Session(properties=props))
    for name, (sql, pinned) in QUERIES.items():
        got = gpu.execute(sql).rows()
        assert _rows_agree(got, cpu.execute(sql).rows()), name
        assert pinned is None or got == pinned, name


# ------------------------------------------------ the caches on the card


def _spy_tpch(runner):
    conn = runner.catalogs.get("tpch")
    calls = []
    orig = conn.create_page_source

    def spy(split, columns):
        calls.append(split.row_start)
        return orig(split, columns)

    conn.create_page_source = spy
    return calls


def test_split_cache_hit_on_the_card_skips_the_connector(cuda):
    # a streamed Q1 with stream_split_cache on: the second pass is all
    # hits, stages nothing and equals the first and the CPU runner;
    # then a whole table, pooled: nothing query-owned outlives a query
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.session import Session
    from presto_tpu_torch.utils.memory import MemoryPool
    from tpch_queries import QUERIES

    props = {"max_device_rows": 16_384, "page_capacity": 4_096,
             "stream_split_cache": True}
    pool = MemoryPool(1 << 34)
    gpu = LocalQueryRunner(device="cuda", memory_pool=pool,
                           session=Session(properties=props))
    calls = _spy_tpch(gpu)
    first = gpu.execute(QUERIES[1]).rows()
    n = len(calls)
    assert n > 1 and gpu.split_cache.stats()["misses"] == n
    calls.clear()
    second = gpu.execute(QUERIES[1]).rows()
    assert calls == [] and gpu.split_cache.stats()["hits"] == n
    assert first == second
    cpu = LocalQueryRunner(device="cpu", session=Session(properties=props))
    assert _rows_agree(second, cpu.execute(QUERIES[1]).rows())
    gpu.execute("select count(*) from tpch.tiny.orders")
    snap = pool.snapshot()
    assert snap["used"] == {"table-cache": gpu.split_cache.used_bytes()}
    page = next(iter(gpu.split_cache._entries.values()))[0]
    assert page.device.type == "cuda"


def test_split_cache_restage_on_the_card_is_bit_identical(cuda):
    # pool pressure pushes every cached batch to host RAM (one batched
    # copy per page); the next pass restages them onto the card
    from presto_tpu_torch.exec import staging
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.session import Session
    from tpch_queries import QUERIES

    props = {"max_device_rows": 16_384, "page_capacity": 4_096,
             "stream_split_cache": True}
    gpu = LocalQueryRunner(device="cuda", session=Session(properties=props))
    gpu.split_cache.set_spill_budget(1 << 30)
    first = gpu.execute(QUERIES[1]).rows()
    key, (page, _) = next(iter(gpu.split_cache._entries.items()))
    host = staging.page_to_host(page)
    assert all(b.data.device.type == "cpu" for b in host.page.blocks)
    back = staging.host_to_page(host)
    assert back.device.type == "cuda"
    for a, b in zip(back.blocks, page.blocks):
        assert torch.equal(a.data, b.data)
    assert gpu.split_cache.evict_bytes(1 << 40) > 0
    assert gpu.split_cache.stats()["bytes"] == 0
    again = gpu.execute(QUERIES[1]).rows()
    st = gpu.split_cache.stats()
    assert st["restages"] > 0 and st["spills"] > 0
    assert again == first
    assert gpu.history.snapshot()[-1].spilled_bytes > 0


def test_prepared_execute_on_the_card_hits_the_plan_cache(cuda):
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner

    gpu = LocalQueryRunner(device="cuda")
    cpu = LocalQueryRunner(device="cpu")
    gpu.execute(
        "prepare p6 from select sum(l_extendedprice * l_discount) as r "
        "from tpch.tiny.lineitem where l_shipdate >= ? and l_quantity < ?"
    )
    for i, (d, q) in enumerate((("1994-01-01", 24), ("1995-01-01", 30),
                                ("1996-01-01", 10))):
        hits = gpu.plan_cache.stats()["hits"]
        got = gpu.execute(f"execute p6 using date '{d}', {q}").rows()
        assert gpu.plan_cache.stats()["hits"] == hits + (i > 0)
        want = cpu.execute(
            "select sum(l_extendedprice * l_discount) as r from "
            f"tpch.tiny.lineitem where l_shipdate >= date '{d}' and "
            f"l_quantity < {q}").rows()
        assert got == want
    assert gpu.literal_form_reruns == 0


# ------------------------------------------------ nested and long decimals


def _nested_runner(device):
    """A runner over tpch and a memory catalog holding arrays, string
    arrays, maps, rows and long decimals (the values of the CPU parity
    files tests/test_torch_{arrays,map_row,long_decimal}.py)."""
    import decimal

    from presto_tpu_torch import types as T
    from presto_tpu_torch.connectors import create_connector
    from presto_tpu_torch.connectors.spi import TableHandle
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.exec.staging import CatalogManager, obj_array

    rng = np.random.RandomState(17)
    base = rng.randint(-(1 << 62), 1 << 62, 3000)
    mult = rng.choice([1, 1 << 20, (1 << 33) + 3], 3000)
    amts = [decimal.Decimal(int(x) * int(m)).scaleb(-3)
            for x, m in zip(base, mult)]
    tables = {
        "t": ({"id": T.INTEGER, "arr": T.array(T.BIGINT),
               "tags": T.array(T.VARCHAR)},
              {"id": [1, 2, 3, 4], "arr": [[10, 20, 30], [5], None, []],
               "tags": [["x", "y"], ["y"], [], None]}),
        "mr": ({"id": T.BIGINT, "m": T.map_(T.VARCHAR, T.BIGINT),
                "im": T.map_(T.INTEGER, T.DOUBLE),
                "r": T.row(("x", T.DOUBLE), ("y", T.VARCHAR))},
               {"id": list(range(5)),
                "m": [{"a": 1, "b": 2}, {}, None, {"c": 30, "a": 10},
                      {"z": None, "q": 7}],
                "im": [{1: 0.5}, {2: 1.5, 3: -2.5}, {}, None, {1: 9.0}],
                "r": [{"x": 1.5, "y": "one"}, {"x": -2.0, "y": "two"}, None,
                      {"x": 0.25, "y": None}, {"x": 9.0, "y": "nine"}]}),
        "ld": ({"id": T.BIGINT, "amt": T.decimal(30, 3)},
               {"id": list(range(3000)), "amt": amts}),
        # about 1,000 array values: two copies outgrow the 1,024 bucket
        "big": ({"id": T.BIGINT, "arr": T.array(T.BIGINT)},
                {"id": list(range(500)),
                 "arr": [[int(x) for x in rng.randint(-99, 99, n)]
                         for n in rng.randint(0, 5, 500)]}),
    }
    catalogs = CatalogManager()
    catalogs.register("tpch", create_connector("tpch"))
    mem = create_connector("memory")
    catalogs.register("mem", mem)
    for name, (types, cols) in tables.items():
        h = TableHandle("mem", "s", name)
        mem.create_table(h, types)
        mem.append_rows(h, {c: obj_array(v) for c, v in cols.items()})
    return LocalQueryRunner(catalogs=catalogs, device=device)


NESTED_CARD_SQL = {
    "arrays": "select id, arr, cardinality(arr), arr[1], element_at(arr, -1)"
              ", tags, tags[2] from mem.s.t order by id",
    "unnest_column": "select id, e, o from mem.s.t cross join unnest(arr) "
                     "with ordinality as u(e, o) order by id, o",
    "unnest_static_over_nested": "select id, arr, u.v from mem.s.t cross "
                                 "join unnest(array[1, 2]) as u(v) "
                                 "order by id, v",
    "array_agg": "select o_orderstatus, array_agg(o_orderkey) from "
                 "tpch.tiny.orders where o_orderkey < 300 group by 1 "
                 "order by 1",
    "array_agg_unnest": "select count(*), sum(e) from (select l_orderkey, "
                        "array_agg(l_partkey) as a from tpch.tiny.lineitem "
                        "group by l_orderkey) t cross join unnest(a) as u(e)",
    "maps_rows": "select id, m, m['a'], element_at(im, 1), cardinality(m), "
                 "r, r.x, r.y from mem.s.mr order by id",
    "row_filter_topn": "select id, r from (select id, r from mem.s.mr "
                       "where r.x > 0 order by id desc limit 2) s "
                       "order by id",
    "long_decimals": "select id, amt, amt + amt, -amt, cast(amt as double) "
                     "from mem.s.ld where amt > 0 and id < 60 order by id",
    "long_group_order": "select amt, count(*) from (select amt from "
                        "mem.s.ld order by amt desc, id limit 40) s "
                        "group by amt order by amt",
    "cross_join_repeats": "select b.id, n.n_nationkey, b.arr, "
                          "element_at(b.arr, -1) from mem.s.big b cross "
                          "join tpch.tiny.nation n where n.n_nationkey < 2 "
                          "order by b.id, n.n_nationkey",
    "order_statistics": "select approx_percentile(l_quantity, 0.5), "
                        "min_by(l_orderkey, l_extendedprice), "
                        "max_by(l_orderkey, l_extendedprice) "
                        "from tpch.tiny.lineitem",
}


@pytest.mark.parametrize(
    "q", list(NESTED_CARD_SQL), ids=list(NESTED_CARD_SQL)
)
def test_nested_queries_on_the_card_equal_the_cpu(cuda, q):
    # array/map/row blocks, both UNNEST forms, array_agg, long decimals
    # and global order statistics on the card against the CPU runner; a
    # warm run repeats
    sql = NESTED_CARD_SQL[q]
    gpu = _nested_runner("cuda")
    got = gpu.execute(sql).rows()
    assert _rows_agree(got, _nested_runner("cpu").execute(sql).rows())
    assert len(got) > 0
    assert got == gpu.execute(sql).rows()


def _block_tensors(blk):
    yield from (t for t in (blk.data, blk.valid, blk.offsets) if t is not None)
    for ch in blk.children or ():
        yield from _block_tensors(ch)


@pytest.mark.parametrize("host_op", [False, True], ids=["none", "order_by"])
def test_root_results_with_nested_columns_live_on_the_host(cuda, host_op):
    # a result page is on the host whether or not the root stage ran a
    # host ORDER BY: nested blocks included
    sql = "select id, arr, tags from mem.s.t" + (
        " order by id desc" if host_op else ""
    )
    page = _nested_runner("cuda").execute(sql).page
    devices = {t.device.type for b in page.blocks for t in _block_tensors(b)}
    assert devices == {"cpu"}


def test_static_unnest_group_by_is_one_launch_on_the_card(cuda):
    # the expanded page (3 x its capacity rows, not a power of two)
    # reduces in exactly one onehot_reduce launch
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner

    sql = ("select l_returnflag, l_linestatus, count(*), sum(u.v) from "
           "tpch.tiny.lineitem cross join unnest(array[l_quantity, "
           "l_discount, l_tax]) as u(v) group by l_returnflag, l_linestatus "
           "order by l_returnflag, l_linestatus")
    gpu = LocalQueryRunner(device="cuda")
    before = onehot_reduce.launches
    got = gpu.execute(sql).rows()
    assert onehot_reduce.launches == before + 1
    assert got == LocalQueryRunner(device="cpu").execute(sql).rows()


# ------------------------------------------ observability on the card


def test_device_probe_on_the_card_runs_all_three_phases(cuda):
    # enumerate the card, build K1, launch it once against its plain
    # version; the outcome is what system.runtime.nodes shows
    import json

    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.utils import devicediag

    before = onehot_reduce.launches
    diag = devicediag.probe_backend()
    assert onehot_reduce.launches == before + 1
    assert (diag.backend, diag.ok, diag.phase) == ("gpu", True, "ok")
    assert diag.device_name == torch.cuda.get_device_name(0)
    assert diag.phases == {"enumerate": "ok", "compile": "ok", "execute": "ok"}
    (row,) = LocalQueryRunner(device="cuda").execute(
        "select backend_diag from system.runtime.nodes"
    ).rows()
    assert json.loads(row[0])["device_name"] == diag.device_name


def test_explain_analyze_on_the_card_equals_the_cpu(cuda):
    # the same per-node rows, estimates and capacities; the one-hot
    # GROUP BY launches K1 once
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from tpch_queries import QUERIES

    sql = "explain analyze " + QUERIES[1]
    before = onehot_reduce.launches
    gpu = [r[0] for r in LocalQueryRunner(device="cuda").execute(sql).rows()]
    assert onehot_reduce.launches == before + 1
    cpu = [r[0] for r in LocalQueryRunner(device="cpu").execute(sql).rows()]
    assert gpu[:-1] == cpu[:-1]
    assert gpu[-1].split(" rows in ")[0] == cpu[-1].split(" rows in ")[0]


def test_program_spans_stay_off_the_device_on_the_card(
    cuda, tmp_path, monkeypatch
):
    # a fresh build of K1 counts one compile on the query that made it;
    # under a profiler with the card's activity, every presto.* span is a
    # host event at FUNCTION scope and none is mirrored on the device
    from torch.autograd import DeviceType

    from presto_tpu_torch import kernels
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from tpch_queries import QUERIES

    monkeypatch.setattr(kernels, "BUILD", tmp_path)
    monkeypatch.delitem(kernels._loaded, "onehot_reduce", raising=False)
    kernels.take_builds()  # a build an earlier test made outside a run
    r = LocalQueryRunner(device="cuda")
    r.execute(QUERIES[1])
    cold = r.history.snapshot()[-1]
    assert cold.device_compiles == 1 and cold.device_compile_ms > 0
    r.execute(QUERIES[1])
    assert r.history.snapshot()[-1].device_compiles == 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        r.execute(QUERIES[1])
        torch.cuda.synchronize()
    events = list(prof.events())
    spans = [e for e in events if e.name.startswith("presto.")]
    assert {"presto.query", "presto.dispatch", "presto.control_read",
            "presto.op.AggregationNode"} <= {e.name for e in spans}
    assert {int(e.scope) for e in spans} == {0}
    assert not [e for e in events if e.device_type == DeviceType.CUDA
                and "presto." in e.name]


def test_the_sorted_group_by_span_stays_off_the_device(cuda):
    # TPC-H Q18's two sorted GROUP BYs: one presto.sorted_agg host event
    # each, at FUNCTION scope, none on the device, and no capacity re-run
    from torch.autograd import DeviceType

    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from tpch_queries import QUERIES

    r = LocalQueryRunner(device="cuda")
    r.execute(QUERIES[18])
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        r.execute(QUERIES[18])
        torch.cuda.synchronize()
    events = list(prof.events())
    spans = [e for e in events if e.name == "presto.sorted_agg"]
    assert len(spans) == 2
    assert {int(e.scope) for e in spans} == {0}
    assert not [e for e in events if e.device_type == DeviceType.CUDA
                and "presto." in e.name]
    assert r.overflow_retries == 0


def _syncs_of(fn):
    """(result, cudaStreamSynchronize-backed waits) of ``fn()``, counted
    through torch's sync debug mode. The mode is switched on once before
    counting: the first switch in a process warns once by itself."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(0)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchronizing" in str(w.message) for w in seen)


@pytest.mark.parametrize("q", [1, 3, 18])
def test_operator_stats_add_no_host_wait_on_the_card(cuda, q):
    # the per-node counts ride the run's one control read: a warm query
    # makes as many host waits with operator stats on as with them off,
    # and the same rows
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from tpch_queries import QUERIES

    results, syncs = [], []
    for on in ("true", "false"):
        r = LocalQueryRunner(device="cuda")
        r.session.set("enable_operator_stats", on)
        r.execute(QUERIES[q])  # cold: stages the tables
        res, n = _syncs_of(lambda: r.execute(QUERIES[q]).rows())
        results.append(res)
        syncs.append(n)
        ops = r.history.snapshot()[-1].all_operator_stats()
        assert bool(ops) == (on == "true")
    assert results[0] == results[1]
    assert syncs[0] == syncs[1] > 0


def test_root_topn_on_the_card_copies_its_limit_and_adds_no_wait(
    cuda, monkeypatch
):
    # Q3's root TopN runs on the card before the result copy: no host
    # wait of its own, as many waits as the same plan under a limit no
    # TopN engages (one control read and one result copy for the run
    # that fetches the result), a copy of 10 rows' bytes, a root_topn
    # span in the query tree and on the profiler's timeline, and the
    # CPU runner's rows
    from presto_tpu_torch.exec import local_runner as LR
    from presto_tpu_torch.utils.metrics import REGISTRY
    from tpch_queries import QUERIES

    q3 = QUERIES[3].strip()
    assert q3.endswith("limit 10")
    wide = q3[: -len("10")] + "1000000"
    copies = []
    real_copy = LR.materialize_page

    def spy_copy(page, n):
        copies.append((n, sum(int(t.nbytes) for t in page.prefix_leaves(n))))
        return real_copy(page, n)

    topn_waits = []
    real_topn = LR.LocalQueryRunner._root_topn

    def spy_topn(self, out, n, topn):
        got, waits = _syncs_of(lambda: real_topn(self, out, n, topn))
        topn_waits.append(waits)
        return got

    monkeypatch.setattr(LR, "materialize_page", spy_copy)
    r = LR.LocalQueryRunner(device="cuda")
    r.execute(q3)  # cold: stages the tables
    r.execute(wide)
    monkeypatch.setattr(LR.LocalQueryRunner, "_root_topn", spy_topn)
    r.execute(q3)
    assert topn_waits == [0]
    monkeypatch.setattr(LR.LocalQueryRunner, "_root_topn", real_topn)

    runs = REGISTRY.counter("root_topn.device")
    before = runs.total
    copies.clear()
    got, waits = _syncs_of(lambda: r.execute(q3).rows())
    names = [
        c["name"]
        for c in r.history.snapshot()[-1].trace.to_tree()[0]["children"][1][
            "children"
        ]
    ]
    wide_rows, wide_waits = _syncs_of(lambda: r.execute(wide).rows())
    assert runs.total == before + 1
    assert waits == wide_waits > 0
    assert names.count("root_topn") == names.count("result_copy") == 1
    assert names.index("root_topn") == len(names) - 3  # copy, host_ops
    assert names[names.index("root_topn") - 1] == "control_read"
    (n, nbytes), (n_wide, wide_bytes) = copies
    assert n == 10 < n_wide and nbytes * n_wide == wide_bytes * 10
    assert got == wide_rows[:10]
    assert _rows_agree(got, LR.LocalQueryRunner(device="cpu").execute(q3).rows())

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        r.execute(q3)
        torch.cuda.synchronize()
    spans = [e for e in prof.events() if e.name == "presto.root_topn"]
    assert len(spans) == 1 and int(spans[0].scope) == 0


# ------------------------------------------- writes and views on the card


def _write_runner(device):
    from presto_tpu_torch.connectors import create_connector
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.exec.staging import CatalogManager
    from presto_tpu_torch.utils.memory import MemoryPool

    catalogs = CatalogManager()
    catalogs.register("tpch", create_connector("tpch"))
    catalogs.register("mem", create_connector("memory"))
    return LocalQueryRunner(
        catalogs=catalogs, device=device, memory_pool=MemoryPool(1 << 34)
    )


WRITE_CARD_STEPS = [
    "create table mem.default.li as select l_orderkey, l_returnflag, "
    "l_linestatus, l_quantity, l_extendedprice, l_discount, l_shipdate "
    "from tpch.tiny.lineitem where l_orderkey < 30000",
    "select l_returnflag, l_linestatus, count(*), sum(l_quantity), "
    "avg(l_extendedprice) from mem.default.li group by 1, 2 order by 1, 2",
    "delete from mem.default.li where l_shipdate > date '1998-01-01'",
    "select l_returnflag, l_linestatus, count(*), sum(l_quantity), "
    "max(l_shipdate) from mem.default.li group by 1, 2 order by 1, 2",
]


def test_writes_on_the_card_equal_the_cpu(cuda):
    # a CTAS, a GROUP BY over the written table (one K1 launch), a
    # DELETE and the GROUP BY again: the same counts and rows as the CPU
    # runner, and the pool holds no query-owned byte after each
    gpu, cpu = _write_runner("cuda"), _write_runner("cpu")
    for sql in WRITE_CARD_STEPS:
        before = onehot_reduce.launches
        got = gpu.execute(sql).rows()
        if sql.startswith("select"):
            assert onehot_reduce.launches == before + 1, sql
        assert _rows_agree(got, cpu.execute(sql).rows()), sql
        # what stays is the split cache's own reservation
        assert set(gpu.memory_pool.snapshot()["used"]) <= {"table-cache"}


def test_aggregate_view_with_one_delta_on_the_card(cuda):
    # an eligible view's full refresh and one incremental merge each
    # launch K1 once; the view equals the defining query and a REFRESH
    # (its average is over whole quantities: an average of fractional
    # decimals may move by an ulp, ROADMAP §3)
    from presto_tpu_torch.connectors.spi import TableHandle

    gpu, cpu = _write_runner("cuda"), _write_runner("cpu")
    view = ("create materialized view mem.default.mv as select "
            "l_returnflag, l_linestatus, sum(l_quantity) as q, count(*) as "
            "c, min(l_discount) as mn, max(l_discount) as mx, "
            "avg(l_quantity) as aq from mem.default.li group by "
            "l_returnflag, l_linestatus")
    direct = ("select l_returnflag, l_linestatus, sum(l_quantity), "
              "count(*), min(l_discount), max(l_discount), "
              "avg(l_quantity) from mem.default.li group by 1, 2 "
              "order by 1, 2")
    read = "select * from mem.default.mv order by 1, 2"
    h = TableHandle("mem", "default", "li")
    delta = {
        "l_orderkey": [1, 2], "l_returnflag": ["R", "A"],
        "l_linestatus": ["F", "F"], "l_quantity": [3.0, 4.0],
        "l_extendedprice": [10.5, 20.25], "l_discount": [0.0, 0.1],
        "l_shipdate": [9000, 9001],
    }
    rows = []
    for r in (gpu, cpu):
        r.execute(WRITE_CARD_STEPS[0])
        before = onehot_reduce.launches
        r.execute(view)
        refresh_launches = onehot_reduce.launches - before
        mem = r.catalogs.get("mem")
        mem.commit_snapshot(h, delta, 1)
        r._invalidate_table_caches(h)
        reg = r.mview_registry
        before = onehot_reduce.launches
        reg.on_commit(h, delta, 1, reg._epoch(h))
        merge_launches = onehot_reduce.launches - before
        mv = reg.lookup(("mem", "default", "mv"))
        assert mv.eligible and mv.incremental_refreshes == 1
        if r is gpu:
            assert (refresh_launches, merge_launches) == (1, 1)
        got = r.execute(read).rows()
        assert _rows_agree(got, r.execute(direct).rows())
        r.execute("refresh materialized view mem.default.mv")
        assert r.execute(read).rows() == got
        assert set(r.memory_pool.snapshot()["used"]) <= {"table-cache"}
        rows.append(got)
    assert _rows_agree(rows[0], rows[1])


# ------------------------------------------------- the server on the card


def test_cluster_on_the_card_answers_q1(cuda):
    # a coordinator and two workers in this process, all on the card:
    # Q1 over HTTP equals the CPU runner, each worker batch's partial
    # GROUP BY and the coordinator's final GROUP BY launch K1
    import math
    import time

    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.server import (
        CoordinatorServer,
        PrestoTpuClient,
        WorkerServer,
    )
    from presto_tpu_torch.session import NodeConfig
    from tpch_queries import QUERIES

    cfg = NodeConfig({
        "staging.cache-bytes": "256MB",
        "query.max-memory-per-node": "4GB",
    })
    coord = CoordinatorServer(config=cfg, device="cuda").start()
    workers = [
        WorkerServer(coordinator_uri=coord.uri, config=cfg, device="cuda")
        .start()
        for _ in range(2)
    ]
    try:
        deadline = time.time() + 30
        while len(coord.active_workers()) < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert len(coord.active_workers()) == 2
        client = PrestoTpuClient(coord.uri, timeout_s=300)
        client.execute("set session distributed_final = false")
        before = onehot_reduce.launches
        res = client.execute(QUERIES[1])
        launches = onehot_reduce.launches - before
        stages = coord.queries[res.query_id].stats.stages
        tasks = sum(len(s.tasks) for s in stages)
        # one partial launch per worker task batch, one final launch
        assert launches >= tasks + 1
        want = LocalQueryRunner(device="cpu").execute(QUERIES[1]).rows()
        got = res.rows()
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                if isinstance(b, float):
                    assert math.isclose(a, b, rel_tol=1e-9), (g, w)
                elif hasattr(b, "isoformat"):
                    assert a == str(b), (g, w)
                else:
                    assert a == b, (g, w)
    finally:
        for w in workers:
            w.shutdown(graceful=False)
        coord.shutdown()


def test_nodes_without_a_visible_card_refuse_to_start(cuda):
    # device=None means CUDA: with the card hidden, a worker and a
    # coordinator raise instead of carrying on on the CPU
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "from presto_tpu_torch.server import CoordinatorServer, WorkerServer\n"
        "for cls in (WorkerServer, CoordinatorServer):\n"
        "    try:\n"
        "        cls()\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA is not available' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit(f'{cls.__name__} started without a card')\n"
        "print('refused')\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=Path(__file__).resolve().parent.parent,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0 and "refused" in out.stdout, out.stderr


Q1_CUT = (
    "select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty, "
    "sum(l_extendedprice * (1 - l_discount)) as sum_disc_price, "
    "avg(l_discount) as avg_disc, count(*) as count_order "
    "from tpch.tiny.lineitem where l_shipdate <= ? "
    "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"
)
CUTOFFS = ["1992-06-01", "1994-01-01", "1996-06-30", "1998-12-01"]


def test_lane_batching_rule_at_256_segments_equals_plain(cuda):
    # K1's batching rule: 32 lanes x 8 segments = 256 in ONE launch per
    # request group, two lanes without a live row, held against one
    # plain reduction per lane
    from presto_tpu_torch.ops.aggregation import (
        onehot_reduce_lanes,
        onehot_reduce_lanes_plain,
    )

    lanes, nseg, rows = 32, 8, 4096
    rng = np.random.default_rng(7)
    g = rng.integers(0, nseg + 1, lanes * rows).astype(np.int32)
    g[3 * rows:4 * rows] = nseg
    g[17 * rows:18 * rows] = nseg
    gid = torch.from_numpy(g).to(cuda)
    x = torch.from_numpy(
        rng.integers(-(2**40), 2**40, lanes * rows, dtype=np.int64)
    ).to(cuda)
    f = torch.from_numpy(rng.standard_normal(lanes * rows)).to(cuda)
    reqs = [("count", None, None), ("sum", x, None), ("min", x, None),
            ("max", x, None), ("sum", f, None)]
    before = onehot_reduce.launches
    got = onehot_reduce_lanes(gid, reqs, nseg, lanes)
    assert onehot_reduce.launches - before == 1
    want = onehot_reduce_lanes_plain(gid, reqs, nseg, lanes)
    torch.cuda.synchronize()
    res, exp = onehot_results(got, reqs), onehot_results(want, reqs)
    for k in range(4):
        assert torch.equal(res[k], exp[k])
    scale = onehot_reduce_lanes_plain(
        gid, [("sum", f.abs(), None)], nseg, lanes)[0].view(torch.float64)
    assert bool(((res[4] - exp[4]).abs() <= 1e-12 * scale).all())
    assert int(res[0][3 * nseg:4 * nseg].sum()) == 0


def _batched_q1(cuda):
    """A CUDA coordinator with a 4-lane window and the result cache on,
    the Q1 shape PREPAREd and warmed."""
    from presto_tpu_torch.server import CoordinatorServer

    coord = CoordinatorServer(device=cuda, max_concurrent_queries=16)
    coord.local.session.set("microbatch_wait_ms", 5000.0)
    coord.local.session.set("microbatch_max", len(CUTOFFS))
    coord.local.session.set("max_fragment_weight", 24)
    coord.local.session.set("enable_result_cache", True)
    prepared = {"q1": Q1_CUT}
    q = coord.submit("execute q1 using date '1997-01-01'", prepared=prepared)
    assert q.done.wait(300) and q.state == "FINISHED", q.error
    return coord, prepared


def _concurrent(coord, sqls, prepared):
    import threading

    out = [None] * len(sqls)
    bar = threading.Barrier(len(sqls))

    def run(i):
        bar.wait(60)
        q = coord.submit(sqls[i], prepared=dict(prepared))
        q.done.wait(300)
        out[i] = q

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(sqls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    return out


def test_q1_batch_of_four_lanes_is_one_launch_equal_to_scalar(cuda):
    import math

    from presto_tpu_torch.exec.local_runner import LocalQueryRunner

    coord, prepared = _batched_q1(cuda)
    try:
        sqls = [f"execute q1 using date '{c}'" for c in CUTOFFS]
        before = onehot_reduce.launches
        qs = _concurrent(coord, sqls, prepared)
        assert onehot_reduce.launches - before == 1
        cpu = LocalQueryRunner(device="cpu")
        for q, c in zip(qs, CUTOFFS):
            assert q.state == "FINISHED", q.error
            assert q.stats.batched and q.stats.batch_size == len(CUTOFFS)
            want = cpu.execute(Q1_CUT.replace("?", f"date '{c}'")).rows()
            assert len(q.rows) == len(want)
            for g, w in zip(q.rows, want):
                for a, b in zip(g, w):
                    if isinstance(b, float):
                        assert math.isclose(a, b, rel_tol=1e-12), (g, w)
                    else:
                        assert a == b, (g, w)
    finally:
        coord.shutdown()


def test_result_cache_hit_on_the_card_launches_nothing(cuda):
    from presto_tpu_torch.utils.telemetry import device_snapshot

    coord, prepared = _batched_q1(cuda)
    try:
        sql = "execute q1 using date '1997-01-01'"
        before = onehot_reduce.launches
        d0 = device_snapshot()["dispatches"]
        q = coord.submit(sql, prepared=prepared)
        assert q.done.wait(300) and q.state == "FINISHED", q.error
        assert q.stats.result_cache == "hit"
        assert onehot_reduce.launches == before
        assert device_snapshot()["dispatches"] == d0
        assert q.rows
    finally:
        coord.shutdown()


def _q1_rows_on_the_cpu():
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from tpch_queries import QUERIES

    return LocalQueryRunner(device="cpu").execute(QUERIES[1]).rows()


def _assert_rows_close(got, want):
    import math

    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert math.isclose(a, b, rel_tol=1e-9), (g, w)
            else:
                assert a == b, (g, w)


def test_worker_killed_mid_producer_recovers_on_the_card(cuda, tmp_path):
    # retry-policy TASK over a shared spool, a coordinator and two
    # workers on the card: the dead worker's second producer re-runs on
    # the survivor (K1 on its batches), its merge partition re-runs over
    # the committed producer re-read from the spool; Q1 equals the CPU
    import time

    from presto_tpu_torch.server import (
        CoordinatorServer,
        PrestoTpuClient,
        WorkerServer,
        task_ids,
    )
    from presto_tpu_torch.session import NodeConfig
    from presto_tpu_torch.utils import faults
    from tpch_queries import QUERIES

    spool = str(tmp_path / "spool")
    base = {"staging.cache-bytes": "256MB", "query.max-memory-per-node": "4GB",
            "exchange.spool-path": spool}
    coord = CoordinatorServer(
        config=NodeConfig({**base, "retry-policy": "TASK"}), device="cuda"
    ).start()
    workers = [
        WorkerServer(coordinator_uri=coord.uri, config=NodeConfig(base),
                     device="cuda").start()
        for _ in range(2)
    ]
    try:
        deadline = time.time() + 30
        while len(coord.active_workers()) < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert len(coord.active_workers()) == 2
        faults.configure({"rules": [
            {"action": "kill_worker", "node": workers[0].node_id,
             "task": ".prod.", "skip": 1, "count": 1},
        ]})
        client = PrestoTpuClient(coord.uri, timeout_s=300)
        before = onehot_reduce.launches
        res = client.execute(QUERIES[1])
        assert onehot_reduce.launches > before
        _assert_rows_close(res.rows(), _q1_rows_on_the_cpu())
        info = client.query_info(res.query_id)
        attempts = [
            task_ids.attempt_of(t["task_id"])
            for st in info["stages"] for t in st["tasks"]
        ]
        assert max(attempts) >= 1
        assert info["spool_pages_served"] > 0
    finally:
        faults.configure(None)
        for w in workers:
            w.shutdown(graceful=False)
        coord.shutdown()


def test_peer_failover_resumes_q1_on_the_card(cuda, tmp_path):
    # two coordinators on the card sharing a control directory;
    # kill_coordinator on coord-0 as Q1 is admitted: the survivor claims
    # the dead lease, resumes the query, and its id resolves by alias
    import socket
    import time

    from presto_tpu_torch.server import CoordinatorServer, PrestoTpuClient
    from presto_tpu_torch.session import NodeConfig
    from presto_tpu_torch.utils import faults
    from tpch_queries import QUERIES

    socks = [socket.socket() for _ in range(2)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    uris = [f"http://127.0.0.1:{p}" for p in ports]
    coords = [
        CoordinatorServer(port=ports[i], device="cuda", config=NodeConfig({
            "node.id": f"coord-{i}",
            "coordinator.journal-path": str(tmp_path / "ctl"),
            "coordinator.peers": uris[1 - i],
            "lease.ttl-s": "0.75",
            "staging.cache-bytes": "256MB",
        })).start()
        for i in range(2)
    ]
    c0, c1 = coords
    try:
        faults.configure({"rules": [
            {"action": "kill_coordinator", "node": "coord-0", "count": 1},
        ]})
        want = _q1_rows_on_the_cpu()
        res = PrestoTpuClient(uris, timeout_s=300).execute(QUERIES[1])
        _assert_rows_close(res.rows(), want)
        deadline = time.time() + 60
        while c1.failover_resumed < 1 and time.time() < deadline:
            time.sleep(0.05)
        assert c1.failover_claims == 1 and c1.failover_resumed == 1
        (dead,) = list(c0.queries)
        alias = c1.lookup_query(dead)
        assert alias is not None and alias.qid != dead
        assert alias.done.wait(300) and alias.state == "FINISHED"
        _assert_rows_close([tuple(r) for r in alias.rows], want)
    finally:
        faults.configure(None)
        for c in coords:
            c.shutdown()


def _k1_calls_by_task(workers):
    """Spy on ``onehot_reduce_many``: (monotonic time, worker task id)
    per call made on a worker task's thread; returns (calls, undo)."""
    import time

    from presto_tpu_torch.ops import aggregation as PA

    calls, real = [], PA.onehot_reduce_many

    def record(gid, requests, nseg):
        for w in workers:
            st = getattr(w.runner._qs_local, "value", None)
            if st is not None:
                calls.append((time.monotonic(), st.task_id))
        return real(gid, requests, nseg)

    PA.onehot_reduce_many = record

    def undo():
        PA.onehot_reduce_many = real

    return calls, undo


def test_preempt_and_resume_on_the_card_runs_k1_on_resumed_ranges(
    cuda, tmp_path
):
    # the QoS plane on a coordinator and two workers on the card: Q1 in
    # the batch lane is suspended by an interactive lookup, resumes under
    # the same logical task ids (no producer re-runs), launches K1 on the
    # ranges it runs after the resume, and equals the CPU
    import time

    from presto_tpu_torch.server import CoordinatorServer, WorkerServer
    from presto_tpu_torch.server import task_ids
    from presto_tpu_torch.session import NodeConfig
    from presto_tpu_torch.utils import faults
    from tpch_queries import QUERIES

    groups = {
        "rootGroups": [
            {"name": "interactive", "weight": 1, "hardConcurrencyLimit": 4,
             "priority": 10},
            {"name": "batch", "weight": 1, "hardConcurrencyLimit": 4,
             "priority": 0},
        ],
        "selectors": [{"user": "inter-.*", "group": "interactive"}],
        "defaultGroup": "batch",
    }
    base = {"staging.cache-bytes": "256MB", "query.max-memory-per-node": "4GB",
            "exchange.spool-path": str(tmp_path / "spool"),
            "qos.enabled": "true", "qos.resume-grace-s": "0.2"}
    coord = CoordinatorServer(
        config=NodeConfig({**base, "retry-policy": "TASK"}), device="cuda",
        max_concurrent_queries=1, resource_groups=groups,
    ).start()
    workers = [
        WorkerServer(coordinator_uri=coord.uri, config=NodeConfig(base),
                     device="cuda").start()
        for _ in range(2)
    ]
    calls, undo = _k1_calls_by_task(workers)
    try:
        deadline = time.time() + 30
        while len(coord.active_workers()) < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert len(coord.active_workers()) == 2
        want = _q1_rows_on_the_cpu()
        faults.configure({"rules": [
            {"action": "delay", "task": ".prod.", "delay_s": 0.25},
        ]})
        qa = coord.submit(QUERIES[1], user="batch-1")
        while qa.state != "RUNNING" and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.3)
        qi = coord.submit("select count(*) as c from tpch.tiny.region",
                          user="inter-1")
        while not getattr(qa, "qos_resumes", 0) and not qa.done.is_set():
            time.sleep(0.005)
        resumed_at = time.monotonic()
        assert qi.done.wait(120) and qi.state == "FINISHED", qi.error
        assert qa.done.wait(300) and qa.state == "FINISHED", qa.error
        _assert_rows_close([tuple(r) for r in qa.rows], want)
        info = coord.query_info(qa)
        assert info["qos"]["suspensions"] >= 1 and info["qos"]["resumes"] >= 1
        for st in info["stages"]:
            if st["kind"] == "producer":
                assert all(task_ids.attempt_of(t["task_id"]) == 0
                           for t in st["tasks"])
        after = [tid for t, tid in calls if t >= resumed_at
                 and tid.startswith(qa.qid)]
        assert after, "no K1 call on the resumed query's ranges"
    finally:
        undo()
        faults.configure(None)
        for w in workers:
            w.shutdown(graceful=False)
        coord.shutdown()


def test_pool_spawned_worker_stages_onto_the_card(cuda):
    # the elastic pool on the card: the autoscaler spawns a preemptible
    # worker through LocalWorkerPoolProvider on the coordinator's device;
    # Q1 runs its batches there (K1 launches) and equals the CPU
    import time

    from presto_tpu_torch.server import CoordinatorServer, PrestoTpuClient
    from presto_tpu_torch.server.launcher import LocalWorkerPoolProvider
    from presto_tpu_torch.session import NodeConfig
    from tpch_queries import QUERIES

    cfg = NodeConfig({"staging.cache-bytes": "256MB",
                      "query.max-memory-per-node": "4GB",
                      "pool.max-workers": "2"})
    coord = CoordinatorServer(config=cfg, device="cuda").start()
    prov = LocalWorkerPoolProvider(coord.uri, config=cfg, device="cuda")
    try:
        coord.attach_pool(prov, min_workers=1, interval_s=0.1)
        deadline = time.time() + 60
        while not coord.active_workers() and time.time() < deadline:
            time.sleep(0.05)
        (node,) = coord.active_workers()
        assert node.preemptible
        (w,) = prov.workers.values()
        assert w.runner.device.type == "cuda"
        calls, undo = _k1_calls_by_task([w])
        try:
            before = onehot_reduce.launches
            res = PrestoTpuClient(coord.uri, timeout_s=300).execute(
                QUERIES[1])
            assert onehot_reduce.launches > before
        finally:
            undo()
        assert calls, "no K1 call on the spawned worker"
        _assert_rows_close(res.rows(), _q1_rows_on_the_cpu())
    finally:
        coord.autoscaler.stop()
        for w in list(prov.workers.values()):
            w.shutdown(graceful=False)
        coord.shutdown()


def test_distributed_q3_on_four_shards_of_the_card(cuda):
    # the multi-device exchange on one card: four shards of
    # cuda:0, low thresholds so tiny Q3's joins and GROUP BY take the
    # all_to_all; the rows equal the single-device runner on the card,
    # with one host read per fragment attempt
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.parallel import DistributedQueryRunner
    from tpch_queries import QUERIES

    r = DistributedQueryRunner(
        devices=[cuda] * 4, broadcast_threshold=1 << 11,
        repl_threshold=1 << 10,
    )
    assert all(d.type == "cuda" for d in r.devices)
    res = r.execute(QUERIES[3])
    assert r.collective_bytes["all_to_all"] > 0
    assert r.fragment_reads == r.fragment_runs + r.balance_retries
    want = LocalQueryRunner(device=cuda).execute(QUERIES[3]).rows()
    _assert_rows_close(res.rows(), want)


def test_ici_lane_q3_on_the_card_equals_http(cuda):
    # the in-slice lane on the card: a coordinator and two workers with
    # exchange.ici-enabled, a partitioned Q3 with the lane off then on:
    # the same rows, ICI edges and no fallback or HTTP shuffle byte
    import time

    from presto_tpu_torch.server import (
        CoordinatorServer,
        PrestoTpuClient,
        WorkerServer,
    )
    from presto_tpu_torch.session import NodeConfig
    from presto_tpu_torch.utils.metrics import REGISTRY
    from tpch_queries import QUERIES

    cfg = NodeConfig({"staging.cache-bytes": "256MB",
                      "query.max-memory-per-node": "4GB",
                      "exchange.ici-enabled": "true"})
    coord = CoordinatorServer(config=cfg, device="cuda").start()
    workers = [
        WorkerServer(coordinator_uri=coord.uri, config=cfg, device="cuda")
        .start()
        for _ in range(2)
    ]

    def count(name):
        return REGISTRY.counter(f"exchange.{name}").total

    try:
        deadline = time.time() + 30
        while len(coord.active_workers()) < 2 and time.time() < deadline:
            time.sleep(0.05)
        client = PrestoTpuClient(coord.uri, timeout_s=300)
        client.execute("set session join_distribution_type = PARTITIONED")
        client.execute("set session exchange_ici_enabled = false")
        off = client.execute(QUERIES[3]).rows()
        client.execute("set session exchange_ici_enabled = true")
        edges, falls, http = (count("ici_edges"), count("ici_fallbacks"),
                              count("http_shuffle_bytes"))
        on = client.execute(QUERIES[3]).rows()
        assert on == off
        assert count("ici_edges") > edges
        assert count("ici_fallbacks") == falls
        assert count("http_shuffle_bytes") == http
    finally:
        for w in workers:
            w.shutdown(graceful=False)
        coord.shutdown()


def test_parquet_group_by_on_the_card_equals_the_cpu(cuda, tmp_path):
    # a GROUP BY over a parquet file (strings with nulls, decimals,
    # dates): one K1 launch on the card, the CPU runner's rows
    pa = pytest.importorskip("pyarrow")
    import decimal

    import pyarrow.parquet as pq

    from presto_tpu_torch.connectors import create_connector
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.exec.staging import CatalogManager

    rng = np.random.default_rng(16)
    n = 50_000
    (tmp_path / "s").mkdir()
    pq.write_table(pa.table({
        "k": pa.array(rng.choice(["a", "b", "c", None], n).tolist()),
        "q": pa.array(rng.integers(1, 100, n)),
        "p": pa.array([decimal.Decimal(int(v)).scaleb(-2)
                       for v in rng.integers(1, 10**6, n)],
                      type=pa.decimal128(12, 2)),
        "d": pa.array(rng.integers(8000, 10000, n).astype(np.int32),
                      type=pa.date32()),
    }), tmp_path / "s" / "t.parquet", row_group_size=8192)
    sql = ("select k, count(*) as n, sum(q) as q, sum(p) as p, max(d) as d "
           "from lake.s.t group by k order by k nulls last")
    rows = {}
    for dev in ("cuda", "cpu"):
        catalogs = CatalogManager()
        catalogs.register("lake", create_connector("parquet", root=str(tmp_path)))
        before = onehot_reduce.launches
        rows[dev] = LocalQueryRunner(catalogs=catalogs, device=dev).execute(
            sql).rows()
        if dev == "cuda":
            assert onehot_reduce.launches == before + 1
    assert rows["cuda"] == rows["cpu"] and len(rows["cpu"]) == 4


def test_fuzz_seed_on_the_card_equals_the_cpu(cuda):
    # a grouping fuzz seed through the port's own fuzzer: no failure on
    # either device, the same rows, K1 launched on the card
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.fuzz import generate_query, run_fuzz
    from presto_tpu_torch.verifier import SqliteOracle

    seed = 10  # a GROUP BY o_orderstatus: one-hot, K1 on the card
    assert "group by o_orderstatus" in generate_query(seed)
    oracle = SqliteOracle("tiny")
    gpu, cpu = LocalQueryRunner(device="cuda"), LocalQueryRunner(device="cpu")
    before = onehot_reduce.launches
    assert run_fuzz([seed], runner=gpu, oracle=oracle) == []
    assert onehot_reduce.launches > before
    assert run_fuzz([seed], runner=cpu, oracle=oracle) == []
    sql = generate_query(seed)
    assert _rows_agree(gpu.execute(sql).rows(), cpu.execute(sql).rows())

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
@pytest.mark.parametrize("k", [1, K_MAX, K_MAX + 1])
def test_onehot_reduce_many_matches_plain(cuda, rows, nseg, k):
    g = _inputs(rows, nseg, torch.int64, False, rows + nseg, cuda)[0]
    reqs = _requests(rows, k, nseg, rows + k, cuda)
    before = onehot_reduce.launches
    out = onehot_reduce_many(g, reqs, nseg)
    torch.cuda.synchronize()
    assert onehot_reduce.launches == before + -(-k // K_MAX)
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
        # one one-hot call per batch and per bucket merge, one launch
        # per K_MAX of its requests
        assert len(calls) == stats.batches + stats.buckets
        assert launches == sum(-(-k // K_MAX) for k in calls) > 0
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

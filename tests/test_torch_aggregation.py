"""Parity of the port's aggregation (presto_tpu_torch.ops.aggregation,
the module that holds the one-hot reduction kernel) with the reference's
``hash_aggregate`` on the CPU, where the kernel's wrapper takes its plain
PyTorch version."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import expr as RE
from presto_tpu import page as RP
from presto_tpu import types as RT
from presto_tpu.ops import aggregation as RA
from presto_tpu_torch import convert
from presto_tpu_torch import expr as PE
from presto_tpu_torch import page as PP
from presto_tpu_torch import types as PT
from presto_tpu_torch.ops import aggregation as PA
from torch_parity import assert_columns_equal, both_pages, jax_live_columns

CAP = 256
LIVE = 230


def _columns(seed: int):
    rng = np.random.default_rng(seed)
    return {
        "flag": (rng.integers(0, 3, CAP).astype(np.int32), None, "varchar",
                 np.asarray(["A", "N", "R"], object)),
        "status": (rng.integers(0, 2, CAP).astype(np.int32), None, "varchar",
                   np.asarray(["F", "O"], object)),
        "mode": (rng.integers(0, 4, CAP).astype(np.int32),
                 rng.random(CAP) < 0.8, "varchar",
                 np.asarray(["AIR", "MAIL", "RAIL", "SHIP"], object)),
        "b": (rng.random(CAP) < 0.5, rng.random(CAP) < 0.85, "boolean", None),
        "i": (rng.integers(-10**6, 10**6, CAP).astype(np.int64),
              rng.random(CAP) < 0.8, "bigint", None),
        "n": (rng.integers(-50, 50, CAP).astype(np.int32), None, "integer",
              None),
        "d": (rng.integers(-10**7, 10**7, CAP).astype(np.int64),
              rng.random(CAP) < 0.9, "decimal(12,2)", None),
        "q": (rng.integers(100, 5000, CAP).astype(np.int64), None,
              "decimal(12,2)", None),
        "f": (rng.standard_normal(CAP) * 1e3, rng.random(CAP) < 0.85,
              "double", None),
        "s": (rng.integers(0, 4, CAP).astype(np.int32),
              rng.random(CAP) < 0.9, "varchar",
              np.asarray(["a", "b", "c", "d"], object)),
    }


def _ref(name):
    return RE.ColumnRef(name, RT.parse_type(_columns(0)[name][2]))


def _port(name):
    return PE.ColumnRef(name, PT.parse_type(_columns(0)[name][2]))


AGGS = [
    ("count_star", None), ("count", "i"), ("count", "s"),
    ("sum", "i"), ("sum", "n"), ("sum", "d"), ("sum", "q"), ("sum", "f"),
    ("avg", "d"), ("avg", "f"), ("avg", "n"),
    ("min", "i"), ("max", "i"), ("min", "d"), ("max", "q"),
    ("min", "f"), ("max", "f"), ("min", "s"), ("max", "s"),
    ("var_samp", "f"), ("var_pop", "d"), ("stddev_samp", "q"),
    ("stddev_pop", "f"),
]


def _agg_calls(col, A, aggs):
    """AggCalls of (func, arg[, arg2 or quantile]) specs."""
    calls = []
    for i, (func, arg, *extra) in enumerate(aggs):
        kw = {}
        if func in ("min_by", "max_by"):
            kw["arg2"] = col(extra[0])
        elif func == "approx_percentile":
            kw["param"] = extra[0]
        calls.append(A.AggCall(
            func, None if arg is None else col(arg), f"a{i}", **kw))
    return calls


KEYSETS = {
    "one_dict": ["flag"],
    "q1_keys": ["flag", "status"],
    "dict_with_nulls": ["mode"],
    "bool_with_nulls": ["b"],
    "dict_and_bool": ["status", "b"],
    "none": [],
    # keys with no provable small domain take the sorted path
    "int": ["n"],
    "bigint_with_nulls": ["i"],
    "double_with_nulls": ["f"],
    "int_and_dict": ["n", "flag"],
    "dict_with_nulls_and_decimal": ["s", "d"],
}


def _run_both(keys, seed, max_groups, live_mask=None, aggs=None, cols=None):
    cols = _columns(seed) if cols is None else cols
    ref_page, port_page = both_pages(cols, LIVE)
    if live_mask is not None:
        ref_page = RP.Page(ref_page.blocks, jnp.asarray(int(live_mask.sum()),
                           jnp.int32), ref_page.names, jnp.asarray(live_mask))
        port_page = PP.Page(port_page.blocks, torch.tensor(
            int(live_mask.sum()), dtype=torch.int32), port_page.names,
            torch.from_numpy(live_mask))
    aggs = AGGS if aggs is None else aggs
    ref_out, ref_ovf = RA.hash_aggregate(
        ref_page, [(k, _ref(k)) for k in keys], _agg_calls(_ref, RA, aggs),
        max_groups,
    )
    port_out, port_ovf = PA.hash_aggregate(
        port_page, [(k, _port(k)) for k in keys], _agg_calls(_port, PA, aggs),
        max_groups,
    )
    assert bool(port_ovf) == bool(ref_ovf)
    assert port_ovf.dtype == torch.bool and port_ovf.dim() == 0
    assert port_out.capacity == ref_out.capacity
    assert int(port_out.num_valid) == int(ref_out.num_valid)
    assert_columns_equal(
        jax_live_columns(ref_out), convert.page_to_numpy(port_out)
    )
    return port_out, bool(port_ovf)


@pytest.mark.parametrize("keyset", sorted(KEYSETS))
@pytest.mark.parametrize("seed", [0, 1])
def test_hash_aggregate_matches_reference(keyset, seed):
    _run_both(KEYSETS[keyset], seed, max_groups=CAP)


@pytest.mark.parametrize(
    "keyset", ["q1_keys", "dict_with_nulls", "none", "int", "int_and_dict"]
)
def test_hash_aggregate_over_masked_page(keyset):
    live = np.random.default_rng(5).random(CAP) < 0.6
    _run_both(KEYSETS[keyset], 2, max_groups=64, live_mask=live)


@pytest.mark.parametrize("keyset", ["q1_keys", "none", "int"])
def test_hash_aggregate_with_no_live_rows(keyset):
    _run_both(KEYSETS[keyset], 3, max_groups=16,
              live_mask=np.zeros(CAP, bool))


def test_onehot_max_groups_overflow():
    out, overflow = _run_both(["flag", "status"], 4, max_groups=4)
    assert overflow and int(out.num_valid) == 4 and out.capacity == 4


def test_onehot_path_is_taken_for_small_domains(monkeypatch):
    # every aggregate of one GROUP BY goes to ONE onehot_reduce_many call
    calls = []
    real = PA.onehot_reduce_many

    def spy(gid, requests, nseg):
        calls.append((nseg, [op for op, _, _ in requests]))
        return real(gid, requests, nseg)

    monkeypatch.setattr(PA, "onehot_reduce_many", spy)
    _run_both(["flag", "status"], 0, max_groups=64)
    assert len(calls) == 1
    nseg, ops = calls[0]
    assert nseg == 6 and ops[0] == "count"
    assert {"count", "sum", "min", "max"} <= set(ops)


def test_sorted_max_groups_overflow():
    out, overflow = _run_both(["n"], 4, max_groups=16)
    assert overflow and int(out.num_valid) == 16 and out.capacity == 16


def test_sorted_path_launches_no_onehot_reduction(monkeypatch):
    def spy(*args):
        raise AssertionError("the sorted path reached onehot_reduce_many")

    monkeypatch.setattr(PA, "onehot_reduce_many", spy)
    _run_both(["n", "flag"], 0, max_groups=CAP)


ORDER_AGGS = [
    ("approx_percentile", "f", 0.3), ("approx_percentile", "d", 0.9),
    ("approx_percentile", "n", 0.5),
    ("min_by", "s", "f"), ("max_by", "i", "d"), ("min_by", "f", "n"),
    ("max_by", "flag", "i"), ("count_star", None), ("sum", "q"),
]


@pytest.mark.parametrize("keyset", ["int", "q1_keys", "dict_with_nulls"])
def test_order_statistic_aggregates_match_reference(keyset):
    # these force the sorted path even over one-hot-able keys
    _run_both(KEYSETS[keyset], 6, max_groups=CAP, aggs=ORDER_AGGS)


def test_sorted_float_min_max_sum_propagate_nan():
    cols = _columns(7)
    f = cols["f"][0].copy()
    keys = cols["n"][0]
    valid = cols["f"][1].copy()
    for k in (-50, 3, 17):  # a NaN in three groups, among other values
        i = np.flatnonzero(keys[:LIVE] == k)[0]
        f[i], valid[i] = np.nan, True
    cols["f"] = (f, valid, "double", None)
    aggs = [("min", "f"), ("max", "f"), ("sum", "f"), ("avg", "f"),
            ("count", "f")]
    out, _ = _run_both(["n"], 7, max_groups=CAP, aggs=aggs, cols=cols)
    res = convert.page_to_numpy(out)
    groups = res["n"][0]
    for k in (-50, 3, 17):
        g = np.flatnonzero(groups == k)[0]
        for name in ("a0", "a1", "a2", "a3"):
            assert np.isnan(res[name][0][g]), (k, name)
    assert np.isfinite(res["a0"][0][groups == 0]).all()


@pytest.mark.parametrize("overflows", [False, True])
def test_sorted_bigint_sum_overflow_trap(overflows):
    big = 2 ** 62
    if overflows:
        # group 0 sums to 2^63: a real per-group overflow
        keys, values = [0, 0, 1], [big, big, 5]
    else:
        # every group sum fits, but the page-wide running total wraps
        keys, values = [0, 0, 1, 2], [big, big - 1, big, -big]
    cols = {
        "k": (np.asarray(keys, np.int32), None, "integer", None),
        "x": (np.asarray(values, np.int64), None, "bigint", None),
    }
    ref_page, port_page = both_pages(cols, len(keys))
    ref_errs, port_errs = [], []
    ref_out, _ = RA.hash_aggregate(
        ref_page, [("k", RE.ColumnRef("k", RT.INTEGER))],
        [RA.AggCall("sum", RE.ColumnRef("x", RT.BIGINT), "s")], 8,
        errors_out=ref_errs,
    )
    port_out, _ = PA.hash_aggregate(
        port_page, [("k", PE.ColumnRef("k", PT.INTEGER))],
        [PA.AggCall("sum", PE.ColumnRef("x", PT.BIGINT), "s")], 8,
        errors_out=port_errs,
    )
    assert len(port_errs) == len(ref_errs) == 1
    assert port_errs[0][0] == ref_errs[0][0] == "bigint sum overflow in s"
    assert bool(port_errs[0][1]) == bool(ref_errs[0][1]) == overflows
    if not overflows:
        assert_columns_equal(
            jax_live_columns(ref_out), convert.page_to_numpy(port_out)
        )
        assert convert.page_to_numpy(port_out)["s"][0].tolist() == [
            2 ** 63 - 1, big, -big
        ]


# ------------------------------------------- the reduction's plain version


def test_plain_onehot_f32_matches_float64_like_the_tool():
    # tools/pallas_groupby.py's parity check: f32 sums over 12 segments
    # within 1e-5 of a float64 numpy reference (relative to the largest)
    rng = np.random.RandomState(0)
    rows, nseg = 1 << 16, 12
    x = rng.rand(rows).astype(np.float32)
    g = rng.randint(0, nseg, rows).astype(np.int32)
    ref = np.array([x[g == s].astype(np.float64).sum() for s in range(nseg)])
    out = PA.onehot_reduce(torch.from_numpy(g), torch.from_numpy(x), None,
                           nseg, "sum")
    assert out.dtype == torch.float32
    err = np.abs(out.numpy().astype(np.float64) - ref).max() / ref.max()
    assert err < 1e-5


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
@pytest.mark.parametrize("op", ["count", "sum", "min", "max"])
def test_plain_onehot_matches_numpy(dtype, op):
    rng = np.random.default_rng(11)
    rows, nseg = 5000, 7
    g = rng.integers(-1, nseg + 2, rows).astype(np.int32)  # out of range: dead
    valid = rng.random(rows) < 0.8
    x = (rng.standard_normal(rows) * 1e6).astype(dtype)
    if dtype == np.float64:
        x[np.flatnonzero((g == 3) & valid)[0]] = np.nan
    g[g == 5] = -7  # segment 5 stays empty
    out = PA.onehot_reduce(
        torch.from_numpy(g), None if op == "count" else torch.from_numpy(x),
        torch.from_numpy(valid), nseg, op,
    ).numpy()
    for s in range(nseg):
        sel = x[(g == s) & valid]
        if op == "count":
            want = len(sel)
        elif op == "sum":
            want = sel.sum() if len(sel) else 0
        elif len(sel) == 0:
            want = PA._onehot_fill(op, torch.from_numpy(x).dtype)
        else:
            want = sel.min() if op == "min" else sel.max()
        if dtype == np.float64 and op != "count":
            np.testing.assert_allclose(out[s], want, rtol=1e-12,
                                       equal_nan=True)
        else:
            assert out[s] == want, (op, s)


def test_onehot_reduce_checks_its_arguments():
    g = torch.zeros(8, dtype=torch.int32)
    x = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError):
        PA.onehot_reduce(g.to(torch.int64), x, None, 4, "sum")
    with pytest.raises(ValueError):
        PA.onehot_reduce(g, None, None, 4, "sum")
    with pytest.raises(ValueError):
        PA.onehot_reduce(g, x, None, 4, "count")
    with pytest.raises(ValueError):
        PA.onehot_reduce(g, x, None, 300, "sum")
    with pytest.raises(ValueError):
        PA.onehot_reduce(g, x.to(torch.int32), None, 4, "sum")
    with pytest.raises(ValueError):
        PA.onehot_reduce(g, x, None, 4, "mean")
    # no silent CPU fallback: a tensor on a device without the kernel
    # (neither the CPU nor CUDA) raises
    with pytest.raises(ValueError, match="no kernel"):
        PA.onehot_reduce(g.to("meta"), x.to("meta"), None, 4, "sum")


# ------------------------- the multi-request reduction's plain version


def _many_requests(rng, rows, k, mix):
    """k requests cycling through ``mix`` of (op, dtype, masked)."""
    reqs = []
    for i in range(k):
        op, dtype, masked = mix[i % len(mix)]
        valid = torch.from_numpy(rng.random(rows) < 0.7) if masked else None
        x = None
        if op != "count":
            if dtype == torch.int64:
                x = torch.from_numpy(
                    rng.integers(-(2**40), 2**40, rows, dtype=np.int64))
            else:
                xn = rng.standard_normal(rows) * 1e3
                if rows and i % 2:
                    xn[rows // 3] = np.nan
                x = torch.from_numpy(xn).to(dtype)
        reqs.append((op, x, valid))
    return reqs


MIXES = {
    "q1": [("count", None, False)] + [("sum", torch.int64, False)] * 4
    + [("sum", torch.float64, False)] * 3,
    "all_ops": [
        ("count", None, True), ("sum", torch.float32, False),
        ("min", torch.int64, True), ("max", torch.float64, False),
        ("min", torch.float32, True), ("max", torch.int64, False),
        ("sum", torch.float64, True), ("min", torch.float64, True),
    ],
}


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("k", [1, 8, 17])
@pytest.mark.parametrize("nseg", [1, 6, 64, 256])
def test_plain_many_matches_plain_per_request(mix, k, nseg):
    rng = np.random.default_rng(nseg * 31 + k)
    rows = 3000
    g = torch.from_numpy(rng.integers(-1, nseg + 2, rows).astype(np.int32))
    reqs = _many_requests(rng, rows, k, MIXES[mix])
    out = PA.onehot_reduce_many(g, reqs, nseg)
    assert out.shape == (k, nseg) and out.dtype == torch.int64
    assert torch.equal(out, PA.onehot_reduce_many_plain(g, reqs, nseg))
    for got, (op, x, valid) in zip(PA.onehot_results(out, reqs), reqs):
        want = PA.onehot_reduce_plain(g, x, valid, nseg, op)
        assert got.dtype == want.dtype
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(got[~torch.isnan(want)], want[~torch.isnan(want)])


def test_onehot_reduce_many_checks_its_arguments():
    g = torch.zeros(8, dtype=torch.int32)
    x = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="no requests"):
        PA.onehot_reduce_many(g, [], 4)
    with pytest.raises(ValueError):
        PA.onehot_reduce_many(g, [("count", None, None), ("sum", None, None)],
                              4)
    with pytest.raises(ValueError):
        PA.onehot_reduce_many(g, [("sum", x[:4], None)], 4)
    with pytest.raises(ValueError, match="no kernel"):
        PA.onehot_reduce_many(g.to("meta"), [("sum", x.to("meta"), None)], 4)

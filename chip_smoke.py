#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (presto_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits
non-zero, and only a run where every phase passed prints the final
``{"ok": true, ...}`` line:

1. device   - the card's name and power limit (nvidia-smi).
2. build    - the port's CUDA kernel, compiled with nvcc into
              presto_tpu_torch/build/ when its library is missing or
              older than its source, and loaded.
3. kernels  - each kernel against its plain PyTorch version on the card,
              at the shapes the main path gives it, timed beside its
              computed bound and one PyTorch library call computing the
              same function (``library_ms``; the port never calls it):
              single reductions at the TPU tool's and Q1's shapes over a
              random gid, then Q1's own aggregation at SF1 as the one
              launch the slice makes (the headline of the kernels line),
              and single reductions over Q1's own gid.
4. slice    - TPC-H Q1 and Q6 at SF1 (lineitem 5,999,995 rows) through
              ``LocalQueryRunner(device="cuda")``, each cold then warm, with
              the kernels' launch counts reset just before and read just
              after, and both results held against an independent numpy
              evaluation over the same generated columns. Q1 must make
              exactly one onehot_reduce launch.
5. joins    - TPC-H Q3 and Q5 at SF10 (lineitem 59,999,997 rows, staged
              whole into the 2^26-row bucket: session ``max_device_rows``
              2^26) through a CUDA runner, each cold then twice warm, with
              the launch counts reset just before and read just after:
              joins, the sorted GROUP BY (Q3), the one-hot GROUP BY over
              25 nations (Q5: exactly one onehot_reduce launch per run)
              and stage-at-a-time execution with dynamic filters. Both
              are held exactly against a numpy evaluation by key lookup
              over the generator's own SF10 columns (Q3: every group, run
              without its LIMIT, and the top 10; Q5: all 5 nations), the
              two warm runs must be identical, and the one-hot reduction
              is checked against its plain version at Q5's own inputs.
6. rest     - the third slice: BASELINE.json's window query over SF10
              orders (15,000,000 rows, default session), every row's rn
              and rk held exactly against a numpy evaluation; TPC-H Q9
              (LIKE, EXTRACT, a six-way join), Q22 and Q22 without its NOT
              EXISTS (a transformed-dictionary key: exactly one
              onehot_reduce launch per run) at SF10 in the joins phase's
              session, exact against numpy; then Q2, Q7, Q8, Q13, Q14, Q16
              and Q20 at SF1, each equal to the same query on the port's
              CPU runner (doubles within rel 1e-9). Each query runs cold
              then twice warm with the launch counts reset just before and
              read just after; the warm runs must agree bit for bit.
7. stream   - the fourth slice, split-streamed execution with host-RAM
              spill, through a CUDA runner: TPC-H Q1 at SF10 under the
              default session (lineitem's 59,999,997 rows over
              ``max_device_rows`` 2^24 stream in 58 batches of 2^20;
              onehot_reduce launches equal the batches plus the bucket
              merges) and Q18 at SF10 (lineitem streams twice, orders is
              replicated whole), each cold then warm and bit-identical,
              Q18 also without its LIMIT (every order over 300 as a set)
              and once more with ``staging_prefetch_depth`` 0 (the
              serial loop, bit-identical to the prefetched runs);
              then Q18 at SF100 (``max_device_rows`` 2^26, batches of
              2^24: lineitem's 599,999,994 rows and orders' 150,000,000
              both exceed the budget, so the outer join takes the
              partitioned build-side spill), once. Every run is exact
              against numpy over the generator's own columns and prints
              its batches, buckets, spilled bytes, retries, host syncs,
              peak device memory and peak RSS.
8. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``.

It needs a CUDA device and the repository beside it; without either it
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import resource
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet, at the full 700 W limit):
#: HBM3 bandwidth, and the float32 rate outside the tensor cores, used
#: for the one compare-and-add per row these kernels do
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

#: lineitem rows at SF1 in the repo's closed-form tpch generator
#: (1,500,000 orders x 1..7 lines; official dbgen makes 6,001,215)
SF1_LINEITEM_ROWS = 5_999_995
CAPACITY = 1 << 23  # the staging bucket of SF1 lineitem
Q1_DATE = 10471  # date '1998-12-01' - interval '90' day, in epoch days

Q1 = """
select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
  sum(l_extendedprice) as sum_base_price,
  sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
  sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
  avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
  avg(l_discount) as avg_disc, count(*) as count_order
from tpch.sf1.lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""

Q6 = """
select sum(l_extendedprice * l_discount) as revenue
from tpch.sf1.lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval '1' year
  and l_discount between 0.05 and 0.07 and l_quantity < 24
"""

#: TPC-H Q3 and Q5 (standard substitution parameters) over the session's
#: schema; the joins phase runs them at sf10
Q3_ALL = """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
  o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
"""
Q3 = Q3_ALL + "limit 10\n"
Q5 = """
select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and l_suppkey = s_suppkey and c_nationkey = s_nationkey
  and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = 'ASIA' and o_orderdate >= date '1994-01-01'
  and o_orderdate < date '1994-01-01' + interval '1' year
group by n_name
order by revenue desc
"""
Q3_DATE = 9204  # date '1995-03-15' in epoch days
Q5_FROM, Q5_TO = 8766, 9131  # 1994-01-01 and 1995-01-01
#: the joins phase's session: SF10 lineitem (~60 M rows) is staged whole
#: into the 2^26-row bucket instead of being streamed
JOINS_SCHEMA = "sf10"
JOINS_MAX_DEVICE_ROWS = 1 << 26


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        check=True,
        capture_output=True,
        text=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = 25) -> float:
    """Median device time of one ``fn()`` call over ``runs`` calls.

    Before each call the L2 cache is flushed (a 256 MB write) and the
    stream is held busy for about a millisecond, so the host has queued
    the start event, the call and the end event before the device
    reaches them: the events then time the device's work, not the
    host's launch overhead."""
    import torch

    flush = torch.empty(1 << 28, dtype=torch.uint8, device="cuda")
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound_ms(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ kernel phase


@functools.lru_cache(maxsize=1)
def sf1_lineitem():
    """Q1's and Q6's lineitem columns at SF1, from the connector's own
    generator (the rows the slice phase stages)."""
    from presto_tpu_torch.connectors.tpch import SCHEMAS, TpchGenerator

    gen = TpchGenerator(SCHEMAS["sf1"])
    check(
        gen.counts["lineitem"] == SF1_LINEITEM_ROWS,
        "unexpected SF1 lineitem row count",
    )
    cols = [
        "l_quantity", "l_extendedprice", "l_discount", "l_tax",
        "l_returnflag", "l_linestatus", "l_shipdate",
    ]
    return gen.generate("lineitem", 0, SF1_LINEITEM_ROWS, cols)


def q1_inputs(dev):
    """Q1's gid and its aggregation's 8 requests at SF1, as the one-hot
    operator builds them: gid = returnflag id * 2 + linestatus id where
    l_shipdate <= Q1_DATE, 6 (dead) elsewhere and in the padding up to
    CAPACITY; the live-row count, the 4 int64 sums (scaled decimals) and
    the 3 float64 sums behind the averages."""
    import numpy as np
    import torch

    d = sf1_lineitem()
    n = SF1_LINEITEM_ROWS
    rf, ls = d["l_returnflag"], d["l_linestatus"]
    nseg = len(rf.values) * len(ls.values)
    check(nseg == 6, f"Q1 has {nseg} groups, expected 6")
    keep = d["l_shipdate"].astype(np.int64) <= Q1_DATE
    g = np.full(CAPACITY, nseg, np.int32)
    g[:n] = np.where(
        keep, rf.ids.astype(np.int32) * len(ls.values) + ls.ids, nseg
    )

    def col(name):
        a = np.zeros(CAPACITY, np.int64)
        a[:n] = d[name]
        return torch.from_numpy(a).to(dev)

    qty, price, disc, tax = (
        col(c) for c in ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
    )
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    reqs = [("count", None, None)]
    reqs += [("sum", x, None) for x in (qty, price, disc_price, charge)]
    reqs += [("sum", x.to(torch.float64) / 100, None) for x in (qty, price, disc)]
    return torch.from_numpy(g).to(dev), reqs, nseg


def fused_case(label, gid, reqs, nseg, card):
    """Hold ``onehot_reduce_many`` against its plain version on the card:
    exact for integers, rel 1e-12 of each segment's sum of |x| for float64
    sums; check that two launches agree bit for bit; time it beside its
    bound and a library yardstick the port never calls (``index_add_``
    over the int64 requests' and the float64 requests' x stacked as
    columns, one call each, in one timed function)."""
    import torch

    from presto_tpu_torch.ops.aggregation import (
        onehot_reduce_many,
        onehot_reduce_many_plain,
        onehot_reduce_plain,
        onehot_results,
    )

    out = onehot_reduce_many(gid, reqs, nseg)
    again = onehot_reduce_many(gid, reqs, nseg)
    want = onehot_reduce_many_plain(gid, reqs, nseg)
    torch.cuda.synchronize()
    check(torch.equal(out, again), f"{label}: two launches differ")
    err = 0.0
    for got, exp, (op, x, valid) in zip(
        onehot_results(out, reqs), onehot_results(want, reqs), reqs
    ):
        if not got.is_floating_point():
            check(torch.equal(got, exp), f"{label}: {op} kernel != plain")
            err = max(err, float((got - exp).abs().max()))
            continue
        scale = onehot_reduce_plain(gid, x.abs(), valid, nseg, "sum")
        diff = (got - exp).abs()
        err = max(err, float(diff.max()))
        check(
            bool((diff <= 1e-12 * scale).all()),
            f"{label}: float sum off by {float(diff.max())} (rel 1e-12)",
        )

    live = (gid >= 0) & (gid < nseg)
    idx = torch.where(live, gid, nseg).to(torch.int64)
    ints = [x for _, x, _ in reqs if x is not None and x.dtype == torch.int64]
    flts = [x for _, x, _ in reqs if x is not None and x.is_floating_point()]
    xi = torch.stack(ints, dim=1) if ints else None
    xf = torch.stack(flts, dim=1) if flts else None

    def library():
        outs = []
        for xs in (xi, xf):
            if xs is not None:
                outs.append(
                    torch.zeros((nseg + 1, xs.shape[1]), dtype=xs.dtype,
                                device=gid.device).index_add_(0, idx, xs)
                )
        return outs

    if xi is not None:
        lib_i = library()[0][:nseg]
        got_i = torch.stack(
            [r for r, (_, x, _) in zip(onehot_results(out, reqs), reqs)
             if x is not None and x.dtype == torch.int64], dim=1)
        check(torch.equal(lib_i, got_i), f"{label}: library call disagrees")

    ms = time_ms(lambda: onehot_reduce_many(gid, reqs, nseg))
    plain_ms = time_ms(lambda: onehot_reduce_many_plain(gid, reqs, nseg))
    library_ms = time_ms(library)

    n_counted = int(live.sum())
    nbytes = 4 * gid.numel() + 8 * len(reqs) * nseg
    for op, x, valid in reqs:
        if valid is not None:
            nbytes += int(live.sum())
        if x is not None:
            nbytes += x.element_size() * n_counted
    b_ms, b_by = bound_ms(nbytes, n_counted * len(reqs))
    rec = {
        "label": label,
        "rows": gid.numel(),
        "nseg": nseg,
        "op": "+".join(op for op, _, _ in reqs),
        "dtype": "mixed",
        "k": len(reqs),
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "bytes": nbytes,
    }
    print(
        f"{label}: ok (K={len(reqs)}, two launches bit-identical), "
        f"max_abs_err {err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, library {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{nbytes} B) [{card}]",
        flush=True,
    )
    return rec


def onehot_case(label, gid, x, valid, nseg, op, tol, card):
    """Hold ``onehot_reduce`` against its plain version on the card and
    time it. ``tol`` is None for exact agreement, else the largest
    allowed |kernel - plain| / max|plain|. Returns the measured record."""
    import torch

    from presto_tpu_torch.ops.aggregation import (
        _onehot_fill,
        onehot_reduce,
        onehot_reduce_plain,
    )

    got = onehot_reduce(gid, x, valid, nseg, op)
    want = onehot_reduce_plain(gid, x, valid, nseg, op)
    torch.cuda.synchronize()
    if got.is_floating_point():
        same_nan = torch.isnan(got) == torch.isnan(want)
        check(bool(same_nan.all()), f"{label}: NaN placement differs")
        fin = ~torch.isnan(want)
        diff = (got[fin].double() - want[fin].double()).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        if tol is None:
            check(err == 0.0, f"{label}: kernel != plain (max abs {err})")
        else:
            scale = float(want[fin].double().abs().max())
            check(
                err <= tol * max(scale, 1e-300),
                f"{label}: max abs err {err} > {tol} x {scale}",
            )
    else:
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"{label}: kernel != plain")

    # the library yardstick: one PyTorch call on the pre-masked input
    keep = (gid >= 0) & (gid < nseg)
    if valid is not None:
        keep &= valid
    idx = torch.where(keep, gid, nseg).to(torch.int64)
    if op == "count":
        src = torch.ones(gid.shape, dtype=torch.int64, device=gid.device)
        def library():
            return torch.zeros(
                nseg + 1, dtype=torch.int64, device=gid.device
            ).index_add_(0, idx, src)
    elif op == "sum":
        def library():
            return torch.zeros(
                nseg + 1, dtype=x.dtype, device=gid.device
            ).index_add_(0, idx, x)
    else:
        fill = _onehot_fill(op, x.dtype)
        def library():
            return torch.full(
                (nseg + 1,), fill, dtype=x.dtype, device=gid.device
            ).scatter_reduce_(0, idx, x, reduce="a" + op)
    lib_out = library()[:nseg]
    torch.cuda.synchronize()
    if tol is None and not got.is_floating_point():
        check(torch.equal(lib_out, got), f"{label}: library call disagrees")

    ms = time_ms(lambda: onehot_reduce(gid, x, valid, nseg, op))
    plain_ms = time_ms(lambda: onehot_reduce_plain(gid, x, valid, nseg, op))
    library_ms = time_ms(library)

    # bytes this data needs: every gid, the validity byte of each
    # in-range row, x of each row that counts, the nseg outputs
    in_range = (gid >= 0) & (gid < nseg)
    n_in = int(in_range.sum())
    n_counted = int(keep.sum())
    nbytes = 4 * gid.numel() + 8 * nseg
    if valid is not None:
        nbytes += n_in
    if x is not None:
        nbytes += x.element_size() * n_counted
    b_ms, b_by = bound_ms(nbytes, n_counted)
    rec = {
        "label": label,
        "rows": gid.numel(),
        "nseg": nseg,
        "op": op,
        "dtype": None if x is None else str(x.dtype).replace("torch.", ""),
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "bytes": nbytes,
    }
    print(
        f"{label}: ok, max_abs_err {err:.3g}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}, {nbytes} B) [{card}]",
        flush=True,
    )
    return rec


def kernel_phase(card: str):
    import numpy as np
    import torch

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    records = []

    # the TPU tool's shape (tools/pallas_groupby.py): f32 x, 12 segments
    n, nseg = CAPACITY, 12
    x_np = rng.random(n, dtype=np.float64).astype(np.float32)
    g_np = rng.integers(0, nseg, n).astype(np.int32)
    ref = np.bincount(g_np, weights=x_np.astype(np.float64), minlength=nseg)
    x = torch.from_numpy(x_np).to(dev)
    g = torch.from_numpy(g_np).to(dev)
    rec = onehot_case("tool f32 sum", g, x, None, nseg, "sum", 1e-5, card)
    from presto_tpu_torch.ops.aggregation import onehot_reduce

    got = onehot_reduce(g, x, None, nseg, "sum").double().cpu().numpy()
    rel = float(np.abs(got - ref).max() / ref.max())
    check(rel <= 1e-5, f"tool f32 sum: rel err {rel} vs float64 > 1e-5")
    print(f"tool f32 sum: max rel err vs float64 numpy {rel:.3g}", flush=True)
    records.append(rec)

    # Q1's shape: 6 segments over the SF1 bucket; padding rows and rows
    # the filter drops carry gid == nseg. Q1's columns have no nulls, so
    # its path passes no validity mask; the masked cases cover nulls
    nseg = 6
    live = np.zeros(CAPACITY, bool)
    live[:SF1_LINEITEM_ROWS] = rng.random(SF1_LINEITEM_ROWS) < 0.98
    g_np = np.where(live, rng.integers(0, nseg, CAPACITY), nseg)
    g = torch.from_numpy(g_np.astype(np.int32)).to(dev)
    v = torch.from_numpy(rng.random(CAPACITY) < 0.95).to(dev)
    xi = torch.from_numpy(
        rng.integers(-(10 ** 9), 10 ** 9, CAPACITY, dtype=np.int64)
    ).to(dev)
    records.append(onehot_case("q1 count", g, None, None, nseg, "count", None, card))
    records.append(onehot_case("q1 i64 sum", g, xi, None, nseg, "sum", None, card))
    records.append(
        onehot_case("q1 count masked", g, None, v, nseg, "count", None, card)
    )
    records.append(
        onehot_case("q1 i64 sum masked", g, xi, v, nseg, "sum", None, card)
    )

    # min/max over nulls with a NaN in one segment
    xf_np = rng.standard_normal(CAPACITY)
    xf_np[int(np.flatnonzero((g_np == 2) & v.cpu().numpy())[0])] = np.nan
    xf = torch.from_numpy(xf_np).to(dev)
    for op in ("min", "max"):
        records.append(onehot_case(f"q1 i64 {op}", g, xi, v, nseg, op, None, card))
        records.append(onehot_case(f"q1 f64 {op}", g, xf, v, nseg, op, None, card))
    records.append(onehot_case("q1 f64 sum", g, xf, v, nseg, "sum", 1e-12, card))

    # Q1's own data: the one launch its aggregation makes (the headline),
    # and the single-column cases again at Q1's gid, whose segments
    # cluster in neighbouring rows
    g, reqs, nseg = q1_inputs(dev)
    records.append(fused_case("q1 fused", g, reqs, nseg, card))
    price = reqs[2][1]
    records.append(
        onehot_case("q1-gid count", g, None, None, nseg, "count", None, card)
    )
    records.append(
        onehot_case("q1-gid i64 sum", g, price, None, nseg, "sum", None, card)
    )
    return records


# ------------------------------------------------------------- slice phase


def numpy_q1_q6():
    """Q1 and Q6 evaluated in numpy over the same generated columns:
    exact int64 sums and counts per (returnflag, linestatus) id pair."""
    import numpy as np

    d = sf1_lineitem()
    qty = d["l_quantity"].astype(np.int64)
    price = d["l_extendedprice"].astype(np.int64)
    disc = d["l_discount"].astype(np.int64)
    tax = d["l_tax"].astype(np.int64)
    ship = d["l_shipdate"].astype(np.int64)
    rf, ls = d["l_returnflag"], d["l_linestatus"]
    keep = ship <= Q1_DATE
    key = rf.ids.astype(np.int64) * len(ls.values) + ls.ids
    q1 = {}
    for k in np.unique(key[keep]):
        m = keep & (key == k)
        disc_price = price[m] * (100 - disc[m])
        q1[(str(rf.values[k // len(ls.values)]), str(ls.values[k % len(ls.values)]))] = {
            "sum_qty": int(qty[m].sum()),
            "sum_base_price": int(price[m].sum()),
            "sum_disc_price": int(disc_price.sum()),
            "sum_charge": int((disc_price * (100 + tax[m])).sum()),
            "avg_qty": qty[m].sum() / 100 / m.sum(),
            "avg_price": price[m].sum() / 100 / m.sum(),
            "avg_disc": disc[m].sum() / 100 / m.sum(),
            "count_order": int(m.sum()),
        }
    m6 = (
        (ship >= 8766) & (ship < 9131)
        & (disc >= 5) & (disc <= 7) & (qty < 2400)
    )
    q6 = int((price[m6] * disc[m6]).sum())
    return q1, q6


def result_columns(res):
    page = res.page
    n = int(page.num_valid)
    out = {}
    for name, blk in zip(page.names, page.blocks):
        data, valid = blk.to_numpy(n)
        check(bool(valid.all()), f"{name}: unexpected NULL in the result")
        if blk.dictionary is not None:
            data = [str(blk.dictionary.values[i]) for i in data]
        out[name] = list(data)
    return n, out


def slice_phase(card: str):
    import torch

    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.ops.aggregation import onehot_reduce

    runner = LocalQueryRunner(device="cuda")
    onehot_reduce.launches = 0
    t0 = time.perf_counter()
    cold = runner.execute(Q1)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    per_q1 = onehot_reduce.launches
    t0 = time.perf_counter()
    warm = runner.execute(Q1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    # Q6 scans other columns under another constraint: its first run
    # stages them (cold), the second reuses them (warm)
    q6_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        q6 = runner.execute(Q6)
        torch.cuda.synchronize()
        q6_s.append(time.perf_counter() - t0)
    launches = onehot_reduce.launches
    check(
        per_q1 == 1,
        f"Q1 made {per_q1} onehot_reduce launches, expected 1 (one per "
        "GROUP BY)",
    )

    want_q1, want_q6 = numpy_q1_q6()
    for res in (cold, warm):
        n, cols = result_columns(res)
        check(n == len(want_q1), f"Q1 returned {n} groups, expected {len(want_q1)}")
        for i in range(n):
            key = (cols["l_returnflag"][i], cols["l_linestatus"][i])
            exp = want_q1[key]
            for name in ("sum_qty", "sum_base_price", "sum_disc_price",
                         "sum_charge", "count_order"):
                check(
                    int(cols[name][i]) == exp[name],
                    f"Q1 {key} {name}: {cols[name][i]} != {exp[name]}",
                )
            for name in ("avg_qty", "avg_price", "avg_disc"):
                got = float(cols[name][i])
                check(
                    abs(got - exp[name]) <= 1e-12 * abs(exp[name]),
                    f"Q1 {key} {name}: {got} vs {exp[name]}",
                )
    n6, cols6 = result_columns(q6)
    check(n6 == 1 and int(cols6["revenue"][0]) == want_q6,
          f"Q6 revenue {cols6['revenue']} != {want_q6}")

    for row in warm.rows():
        print("Q1 row:", row, flush=True)
    print("Q6 row:", q6.rows()[0], flush=True)
    print(
        f"Q1 sf1: cold_s {cold_s:.4f}, warm_s {warm_s:.4f}, "
        f"warm rows/s {SF1_LINEITEM_ROWS / warm_s:.1f}; "
        f"Q6 sf1 cold_s {q6_s[0]:.4f}, warm_s {q6_s[1]:.4f}; onehot_reduce "
        f"launches per Q1 {per_q1}, in the whole slice run {launches} "
        f"[{card}]",
        flush=True,
    )
    return {
        "onehot_reduce": launches,
        "q1_cold_s": cold_s,
        "q1_warm_s": warm_s,
        "q6_cold_s": q6_s[0],
        "q6_warm_s": q6_s[1],
        "per_q1": per_q1,
    }


# ------------------------------------------------------------- joins phase


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def joins_columns():
    """The generator's own columns of the tables Q3 and Q5 read, at the
    joins phase's scale (generated here, not through the port)."""
    from presto_tpu_torch.connectors.tpch import SCHEMAS, TpchGenerator

    gen = TpchGenerator(SCHEMAS[JOINS_SCHEMA])
    want = {
        "lineitem": ["l_orderkey", "l_suppkey", "l_extendedprice",
                     "l_discount", "l_shipdate"],
        "orders": ["o_orderkey", "o_custkey", "o_orderdate",
                   "o_shippriority"],
        "customer": ["c_custkey", "c_mktsegment", "c_nationkey"],
        "supplier": ["s_suppkey", "s_nationkey"],
        "nation": ["n_nationkey", "n_name", "n_regionkey"],
        "region": ["r_regionkey", "r_name"],
    }
    return gen.counts["lineitem"], {
        t: gen.generate(t, 0, gen.counts[t], cols) for t, cols in want.items()
    }


def _lookup(keys, values, fill):
    """values[i] at position keys[i] of a dense array over the key range
    (the numpy join by key lookup)."""
    import numpy as np

    out = np.full(int(keys.max()) + 1, fill, dtype=np.asarray(values).dtype)
    out[keys] = values
    return out


def numpy_q3_q5(d):
    """Q3 (every group: orderkey -> (revenue, orderdate, shippriority))
    and Q5 (nation name -> revenue) in numpy by key lookup: exact int64
    revenue at scale 4, as the query computes it."""
    import numpy as np

    li, o, c = d["lineitem"], d["orders"], d["customer"]
    revenue = li["l_extendedprice"].astype(np.int64) * (
        100 - li["l_discount"].astype(np.int64)
    )
    lk = li["l_orderkey"].astype(np.int64)
    order_row = _lookup(o["o_orderkey"], np.arange(len(o["o_orderkey"])), -1)
    orow = order_row[lk]
    check(bool((orow >= 0).all()), "a lineitem row without its order")

    seg = c["c_mktsegment"]
    building = int(np.flatnonzero(seg.values == "BUILDING")[0])
    cust_building = _lookup(c["c_custkey"], seg.ids == building, False)
    o_ok = (o["o_orderdate"] < Q3_DATE) & cust_building[o["o_custkey"]]
    m3 = o_ok[orow] & (li["l_shipdate"] > Q3_DATE)
    keys3, inv = np.unique(lk[m3], return_inverse=True)
    rev3 = np.zeros(len(keys3), np.int64)
    np.add.at(rev3, inv, revenue[m3])
    q3 = {
        int(k): (int(r), int(o["o_orderdate"][order_row[k]]),
                 int(o["o_shippriority"][order_row[k]]))
        for k, r in zip(keys3, rev3)
    }

    n, r = d["nation"], d["region"]
    asia_id = int(np.flatnonzero(r["r_name"].values == "ASIA")[0])
    asia = int(r["r_regionkey"][r["r_name"].ids == asia_id][0])
    in_asia = _lookup(n["n_nationkey"], n["n_regionkey"] == asia, False)
    cust_nation = _lookup(c["c_custkey"], c["c_nationkey"], -1)
    supp_nation = _lookup(d["supplier"]["s_suppkey"],
                          d["supplier"]["s_nationkey"], -1)
    o_in_1994 = (o["o_orderdate"] >= Q5_FROM) & (o["o_orderdate"] < Q5_TO)
    sn = supp_nation[li["l_suppkey"]]
    m5 = (
        o_in_1994[orow]
        & (cust_nation[o["o_custkey"][orow]] == sn)
        & in_asia[sn]
    )
    name_of = {
        int(k): str(n["n_name"].values[i])
        for k, i in zip(n["n_nationkey"], n["n_name"].ids)
    }
    q5 = {
        name_of[int(k)]: int(revenue[m5 & (sn == k)].sum())
        for k in np.unique(sn[m5])
    }
    return q3, q5


def run_timed(runner, sql, dev):
    t0 = time.perf_counter()
    res = runner.execute(sql)
    sync(dev)
    return res, time.perf_counter() - t0


def joins_phase(card: str, dev=None, records=None):
    """Q3 and Q5 at the joins phase's scale on ``dev`` (the card unless
    a CPU rehearsal passes another), each cold then twice warm. Returns
    the onehot_reduce launches counted over the phase's query runs."""
    import torch

    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.ops import aggregation as PA
    from presto_tpu_torch.session import Session

    dev = torch.device("cuda") if dev is None else dev
    runner = LocalQueryRunner(
        device=dev,
        session=Session(
            schema=JOINS_SCHEMA,
            properties={"max_device_rows": JOINS_MAX_DEVICE_ROWS},
        ),
    )
    t0 = time.perf_counter()
    n_lineitem, cols = joins_columns()
    want_q3, want_q5 = numpy_q3_q5(cols)
    numpy_s = time.perf_counter() - t0
    del cols
    print(f"numpy evaluation of Q3/Q5 at {JOINS_SCHEMA} "
          f"({n_lineitem} lineitem rows): {numpy_s:.2f} s", flush=True)

    launches = 0
    results = {}
    for name, sql in (("Q3", Q3), ("Q5", Q5)):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        frags = runner.fragments_run
        dyn = runner.dynamic_filters_applied
        runs, per_run = [], []
        for _ in range(3):  # cold, warm, warm
            PA.onehot_reduce.launches = 0
            res, secs = run_timed(runner, sql, dev)
            per_run.append(PA.onehot_reduce.launches)
            runs.append((res, secs))
        launches += sum(per_run)
        peak = (
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB"
            if dev.type == "cuda" else "not measured (no card)"
        )
        (cold, cold_s), (w1, w1_s), (w2, w2_s) = runs
        check(w1.rows() == w2.rows(), f"{name}: two warm runs differ")
        check(cold.rows() == w1.rows(), f"{name}: cold and warm runs differ")
        if name == "Q5":
            # a CPU rehearsal takes the plain version: no launch counts
            want = 1 if dev.type == "cuda" else 0
            check(
                per_run == [want] * 3,
                f"Q5 made {per_run} onehot_reduce launches per run, "
                f"expected {want} (its GROUP BY n_name is one launch)",
            )
        results[name] = w1
        print(
            f"{name} {JOINS_SCHEMA}: cold_s {cold_s:.4f}, warm_s {w1_s:.4f} "
            f"/ {w2_s:.4f}, warm lineitem rows/s {n_lineitem / w1_s:.1f}, "
            f"peak memory {peak}, fragments run "
            f"{(runner.fragments_run - frags) // 3} and dynamic filters "
            f"applied {(runner.dynamic_filters_applied - dyn) // 3} per "
            f"run, onehot_reduce launches per run {per_run} [{card}]",
            flush=True,
        )

    # Q3: the top 10 in order, then every group (the query without LIMIT)
    ranked = sorted(
        want_q3.items(), key=lambda kv: (-kv[1][0], kv[1][1], kv[0])
    )
    top = [(k, r, dt, sp) for k, (r, dt, sp) in ranked[:10]]
    got = [
        (row[0], row[1], row[2], row[3])
        for row in result_rows(results["Q3"], (
            "l_orderkey", "revenue", "o_orderdate", "o_shippriority"))
    ]
    check(got == top, f"Q3 top 10 {got} != numpy {top}")
    PA.onehot_reduce.launches = 0
    all_groups, all_s = run_timed(runner, Q3_ALL, dev)
    launches += PA.onehot_reduce.launches
    got_all = {
        k: (r, dt, sp)
        for k, r, dt, sp in result_rows(all_groups, (
            "l_orderkey", "revenue", "o_orderdate", "o_shippriority"))
    }
    check(len(got_all) == len(want_q3) and got_all == want_q3,
          f"Q3 without LIMIT: {len(got_all)} groups, numpy "
          f"{len(want_q3)}, or a group differs")
    got5 = dict(
        (nm, r) for nm, r in result_rows(results["Q5"], ("n_name", "revenue"))
    )
    check(got5 == want_q5, f"Q5 {got5} != numpy {want_q5}")
    for row in results["Q3"].rows():
        print("Q3 row:", row, flush=True)
    for row in results["Q5"].rows():
        print("Q5 row:", row, flush=True)
    print(f"Q3 without LIMIT: {len(got_all)} groups equal numpy's "
          f"({all_s:.4f} s)", flush=True)

    if records is not None:
        # the one-hot reduction at Q5's own inputs (a run not counted)
        seen = []
        real = PA.onehot_reduce_many

        def record(gid, requests, nseg):
            seen.append((gid, list(requests), nseg))
            return real(gid, requests, nseg)

        PA.onehot_reduce_many = record
        try:
            runner.execute(Q5)
        finally:
            PA.onehot_reduce_many = real
        check(len(seen) == 1, f"Q5 made {len(seen)} one-hot calls")
        records.append(fused_case("q5 fused", *seen[0], card))
    return launches


def result_rows(res, names):
    """A result's rows as tuples of exact stored values: scaled int64
    for decimals, epoch days for dates, strings for dictionary ids."""
    _, cols = result_columns(res)
    return list(zip(*(
        [v if isinstance(v, str) else int(v) for v in cols[name]]
        for name in names
    )))


# -------------------------------------------------------------- rest phase

#: BASELINE.json's window configuration (bench.py's window query) at the
#: joins phase's scale: SF10 orders, 15,000,000 rows, fits the default
#: ``max_device_rows`` (2^24) whole
WINDOW_SCHEMA = JOINS_SCHEMA
WINDOW = f"""
select o_orderkey, o_custkey,
  row_number() over (partition by o_custkey order by o_orderdate) as rn,
  rank() over (partition by o_orderpriority order by o_totalprice) as rk
from tpch.{WINDOW_SCHEMA}.orders
"""
#: Q22's NOT EXISTS: the generator gives every customer orders, so it
#: keeps almost no row; Q22 also runs without it
Q22_NOT_EXISTS = """
    and not exists (
      select * from orders where o_custkey = c_custkey)
"""
Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")
#: the third slice's queries the card runs at SF1, each held against the
#: same query on the port's CPU runner
REST_SF1 = (2, 7, 8, 13, 14, 16, 20)
REST_SF1_SCHEMA = "sf1"


def tpch_queries():
    """The TPC-H texts of tests/tpch_queries.py (standard substitution
    parameters, unqualified table names)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from tpch_queries import QUERIES

    q22 = QUERIES[22]
    check(Q22_NOT_EXISTS in q22, "Q22's NOT EXISTS clause not found")
    return {
        **{f"Q{q}": QUERIES[q] for q in (9, 18, 22) + REST_SF1},
        "Q22 without not exists": q22.replace(Q22_NOT_EXISTS, "\n"),
    }


def host_columns(res):
    """(rows, {name: (data, valid, dictionary values or None)}) of a
    result's live rows, undecoded."""
    page = res.page
    n = int(page.num_valid)
    out = {}
    for name, blk in zip(page.names, page.blocks):
        data, valid = blk.to_numpy(n)
        values = None if blk.dictionary is None else blk.dictionary.values
        out[name] = (data, valid, values)
    return n, out


def results_differ(a, b, rel: float = 0.0):
    """None if results ``a`` and ``b`` agree, else what differs: the same
    columns, rows and NULLs; strings (decoded), integers, decimals and
    dates exactly; doubles bit for bit (``rel`` 0) or within ``rel`` of
    the larger magnitude."""
    import numpy as np

    if a.columns != b.columns:
        return f"columns {a.columns} != {b.columns}"
    na, ca = host_columns(a)
    nb, cb = host_columns(b)
    if na != nb:
        return f"{na} rows != {nb} rows"
    for name in ca:
        (da, va, sa), (db, vb, sb) = ca[name], cb[name]
        if not np.array_equal(va, vb):
            return f"{name}: NULLs differ"
        da, db = da[va], db[va]
        if sa is not None:
            same = np.array_equal(sa[da].astype(str), sb[db].astype(str))
        elif da.dtype.kind == "f" and rel > 0:
            scale = np.maximum(np.abs(da), np.abs(db))
            same = bool(((np.abs(da - db) <= rel * scale)
                         | (np.isnan(da) & np.isnan(db))).all())
        elif da.dtype.kind == "f":
            same = da.tobytes() == db.tobytes()
        else:
            same = np.array_equal(da, db)
        if not same:
            return f"{name}: values differ"
    return None


def syncs_per_run(runner, sql, dev):
    """``cudaStreamSynchronize`` calls of one warm run under
    torch.profiler (None on the CPU: nothing to count)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        return None
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        runner.execute(sql)
        torch.cuda.synchronize(dev)
    return sum(
        e.count for e in prof.key_averages()
        if e.key == "cudaStreamSynchronize"
    )


def run_three(runner, name, sql, dev, card, scanned: Optional[int] = None):
    """Cold then twice warm, the launch count reset before each run and
    read after it; the warm runs must agree bit for bit. ``scanned``: the
    rows a warm rate is given for. Returns (the first warm result, its
    record)."""
    import torch

    from presto_tpu_torch.ops import aggregation as PA

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runs, per_run = [], []
    for _ in range(3):
        PA.onehot_reduce.launches = 0
        runs.append(run_timed(runner, sql, dev))
        per_run.append(PA.onehot_reduce.launches)
    (cold, cold_s), (w1, w1_s), (w2, w2_s) = runs
    diff = results_differ(w1, w2)
    check(diff is None, f"{name}: two warm runs differ ({diff})")
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else None)
    rec = {
        "query": name, "rows": int(w1.page.num_valid), "cold_s": cold_s,
        "warm_s": [w1_s, w2_s],
        "rows_per_s": scanned and scanned / min(w1_s, w2_s),
        "peak_gib": peak,
        "syncs_per_warm_run": syncs_per_run(runner, sql, dev),
        "onehot_reduce_launches": per_run,
    }
    rate = (f", {rec['rows_per_s']:.1f} rows/s of {scanned} scanned"
            if scanned else "")
    print(
        f"{name}: {rec['rows']} rows; cold_s {cold_s:.4f}, warm_s "
        f"{w1_s:.4f} / {w2_s:.4f}{rate}, peak memory "
        f"{'not measured (no card)' if peak is None else f'{peak:.3f} GiB'}"
        f", cudaStreamSynchronize per warm run "
        f"{rec['syncs_per_warm_run']}, onehot_reduce launches per run "
        f"{per_run} [{card}]",
        flush=True,
    )
    return w1, rec


def rest_columns(schema: str):
    """The generator's own columns of the tables the window query, Q9
    and Q22 read, at ``schema``'s scale (not through the port)."""
    from presto_tpu_torch.connectors.tpch import SCHEMAS, TpchGenerator

    gen = TpchGenerator(SCHEMAS[schema])
    want = {
        "lineitem": ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                     "l_extendedprice", "l_discount"],
        "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_totalprice",
                   "o_orderpriority"],
        "part": ["p_partkey", "p_name"],
        "partsupp": ["ps_partkey", "ps_suppkey", "ps_supplycost"],
        "supplier": ["s_suppkey", "s_nationkey"],
        "customer": ["c_custkey", "c_phone", "c_acctbal"],
        "nation": ["n_nationkey", "n_name"],
    }
    return {
        t: gen.generate(t, 0, gen.counts[t], cols) for t, cols in want.items()
    }


def numpy_window(o):
    """rn and rk of every order row, in the generator's row order: the
    planner runs the first window (rn) over the scan and the second over
    its output, and each orders its input with a stable sort, so rn
    breaks (custkey, orderdate) ties in row order; rank() gives each row
    its first peer's position."""
    import numpy as np

    def ranks(perm, part, peer):
        pos = np.arange(len(perm))
        head = np.ones(len(perm), bool)
        head[1:] = part[perm][1:] != part[perm][:-1]
        first = head.copy()
        first[1:] |= peer[perm][1:] != peer[perm][:-1]
        start = np.maximum.accumulate(np.where(head, pos, 0))
        out = np.empty(len(perm), np.int64)
        out[perm] = np.maximum.accumulate(np.where(first, pos, 0)) - start + 1
        return out

    ck = o["o_custkey"].astype(np.int64)
    pos = np.arange(len(ck))
    rn = ranks(np.lexsort((o["o_orderdate"], ck)), ck, pos)  # every row a peer
    prio = o["o_orderpriority"].ids.astype(np.int64)
    price = o["o_totalprice"].astype(np.int64)
    rk = ranks(np.lexsort((price, prio)), prio, price)
    return rn, rk


def check_window(res, o):
    import numpy as np

    rn, rk = numpy_window(o)
    n, cols = host_columns(res)
    check(n == len(rn), f"window: {n} rows, expected {len(rn)}")
    for name in ("rn", "rk"):
        check(cols[name][0].dtype == np.int32,
              f"window {name}: {cols[name][0].dtype} data, expected int32")
    row_of = _lookup(o["o_orderkey"], np.arange(len(rn)), -1)
    rows = row_of[cols["o_orderkey"][0]]
    check(bool((rows >= 0).all()) and len(np.unique(rows)) == n,
          "window: the orderkeys are not the table's, each once")
    for name, want in (("o_custkey", o["o_custkey"]), ("rn", rn), ("rk", rk)):
        check(bool(cols[name][1].all()), f"window {name}: a NULL")
        check(np.array_equal(cols[name][0].astype(np.int64),
                             np.asarray(want, np.int64)[rows]),
              f"window {name} differs from numpy")


def numpy_q9(d):
    """Q9 by key lookup: {(nation, year): profit at scale 4, exact}."""
    import numpy as np

    li, p, ps, o = d["lineitem"], d["part"], d["partsupp"], d["orders"]
    green = np.asarray(["green" in str(v) for v in p["p_name"].values])
    part_green = _lookup(p["p_partkey"], green[p["p_name"].ids], False)
    m = part_green[li["l_partkey"]]
    pk, sk = li["l_partkey"][m], li["l_suppkey"][m]
    wide = int(ps["ps_suppkey"].max()) + 1
    ps_key = ps["ps_partkey"] * wide + ps["ps_suppkey"]
    order = np.argsort(ps_key)
    at = np.searchsorted(ps_key[order], pk * wide + sk)
    check(bool((ps_key[order][np.minimum(at, len(order) - 1)]
                == pk * wide + sk).all()), "a lineitem without its partsupp")
    cost = ps["ps_supplycost"][order][at].astype(np.int64)
    amount = (
        li["l_extendedprice"][m].astype(np.int64)
        * (100 - li["l_discount"][m].astype(np.int64))
        - cost * li["l_quantity"][m].astype(np.int64)
    )
    nation = _lookup(d["supplier"]["s_suppkey"],
                     d["supplier"]["s_nationkey"], -1)[sk]
    order_row = _lookup(o["o_orderkey"], np.arange(len(o["o_orderkey"])), -1)
    odate = o["o_orderdate"][order_row[li["l_orderkey"][m]]]
    year = (odate.astype("datetime64[D]").astype("datetime64[Y]")
            .astype(np.int64) + 1970)
    keys, inv = np.unique(nation * 10000 + year, return_inverse=True)
    total = np.zeros(len(keys), np.int64)
    np.add.at(total, inv, amount)
    n = d["nation"]
    name_of = {int(k): str(n["n_name"].values[i])
               for k, i in zip(n["n_nationkey"], n["n_name"].ids)}
    rows = [(name_of[int(k) // 10000], int(k) % 10000, int(t))
            for k, t in zip(keys, total)]
    return sorted(rows, key=lambda r: (r[0], -r[1]))


def numpy_q22(d, not_exists: bool):
    """Q22: [(cntrycode, customers, acctbal at scale 2)], exact. The
    subquery's average is a double; the returned margin is the closest
    any customer's balance comes to it (a comparison that a last-bit
    difference in the average could flip needs a margin near 0)."""
    import numpy as np

    c = d["customer"]
    phone = c["c_phone"]
    code = np.asarray([str(v)[:2] for v in phone.values])[phone.ids]
    inset = np.isin(code, Q22_CODES)
    bal = c["c_acctbal"].astype(np.int64)
    pos = inset & (bal > 0)
    avg = float(bal[pos].sum()) / 100 / int(pos.sum())
    margin = float(np.abs(bal[inset] / 100 - avg).min())
    keep = inset & (bal / 100 > avg)
    if not_exists:
        has_order = np.zeros(int(c["c_custkey"].max()) + 1, bool)
        has_order[d["orders"]["o_custkey"]] = True
        keep &= ~has_order[c["c_custkey"]]
    rows = [(cc, int((keep & (code == cc)).sum()),
             int(bal[keep & (code == cc)].sum()))
            for cc in sorted(Q22_CODES)]
    return [r for r in rows if r[1] > 0], margin


def rest_phase(card: str, dev=None):
    """The third slice's path on ``dev`` (the card unless a CPU rehearsal
    passes another): the window query and Q9/Q22 at SF10, exact against
    numpy; Q2/Q7/Q8/Q13/Q14/Q16/Q20 at SF1 against the port's CPU
    runner. Each query runs cold then twice warm. Returns (the
    onehot_reduce launches of the phase's counted runs, the records)."""
    import torch

    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.session import Session

    dev = torch.device("cuda") if dev is None else dev
    queries = tpch_queries()
    t0 = time.perf_counter()
    d = rest_columns(WINDOW_SCHEMA)
    n_orders, n_lineitem = len(d["orders"]["o_orderkey"]), len(
        d["lineitem"]["l_orderkey"])
    want_q9 = numpy_q9(d)
    want_q22 = {name: numpy_q22(d, name == "Q22")
                for name in ("Q22", "Q22 without not exists")}
    print(f"numpy evaluation of Q9/Q22 at {WINDOW_SCHEMA}: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    launches, records = 0, []

    # the window configuration, default session
    runner = LocalQueryRunner(device=dev)
    res, rec = run_three(runner, "window", WINDOW, dev, card, n_orders)
    launches += sum(rec["onehot_reduce_launches"])
    t0 = time.perf_counter()
    check_window(res, d["orders"])
    print(f"window {WINDOW_SCHEMA}: rn and rk of all {n_orders} orders "
          f"equal numpy's ({time.perf_counter() - t0:.2f} s)", flush=True)
    records.append(rec)
    del runner, res

    # Q9 and Q22 in the joins phase's session
    runner = LocalQueryRunner(
        device=dev,
        session=Session(
            schema=JOINS_SCHEMA,
            properties={"max_device_rows": JOINS_MAX_DEVICE_ROWS},
        ),
    )
    res, rec = run_three(runner, "Q9", queries["Q9"], dev, card, n_lineitem)
    launches += sum(rec["onehot_reduce_launches"])
    check(res.page.block("sum_profit").dtype.scale == 4,
          "Q9 sum_profit is not at scale 4")
    got = result_rows(res, ("nation", "o_year", "sum_profit"))
    check(got == want_q9, f"Q9 {got[:3]}... != numpy {want_q9[:3]}...")
    print(f"Q9 {JOINS_SCHEMA}: all {len(got)} (nation, year) groups equal "
          "numpy's", flush=True)
    records.append(rec)
    for name, (want, margin) in want_q22.items():
        res, rec = run_three(runner, name, queries[name], dev, card,
                             len(d["customer"]["c_custkey"]))
        launches += sum(rec["onehot_reduce_launches"])
        # one onehot_reduce launch per run: GROUP BY substring(c_phone,
        # 1, 2) over the transformed dictionary's 25 country codes
        per = 1 if dev.type == "cuda" else 0
        check(rec["onehot_reduce_launches"] == [per] * 3,
              f"{name} made {rec['onehot_reduce_launches']} onehot_reduce "
              f"launches per run, expected {per}")
        check(margin > 1e-6, f"{name}: a balance within {margin} of the "
              "average")
        check(res.page.block("totacctbal").dtype.scale == 2,
              f"{name} totacctbal is not at scale 2")
        got = result_rows(res, ("cntrycode", "numcust", "totacctbal"))
        check(got == want, f"{name} {got} != numpy {want}")
        print(f"{name} {JOINS_SCHEMA}: {got} equal numpy's (closest "
              f"balance {margin:.4f} from the average)", flush=True)
        records.append(rec)
    del runner, res, d

    # the rest at SF1 against the port's CPU runner
    session = Session(schema=REST_SF1_SCHEMA)
    runner = LocalQueryRunner(device=dev, session=session)
    cpu = LocalQueryRunner(device="cpu", session=session)
    for q in REST_SF1:
        name = f"Q{q}"
        res, rec = run_three(runner, name, queries[name], dev, card)
        launches += sum(rec["onehot_reduce_launches"])
        t0 = time.perf_counter()
        want = cpu.execute(queries[name])
        cpu_s = time.perf_counter() - t0
        diff = results_differ(res, want, rel=1e-9)
        check(diff is None, f"{name} {REST_SF1_SCHEMA}: card != CPU ({diff})")
        check(int(want.page.num_valid) > 0, f"{name}: an empty result")
        print(f"{name} {REST_SF1_SCHEMA}: equal to the CPU runner's "
              f"{rec['rows']} rows (CPU run {cpu_s:.2f} s)", flush=True)
        rec["cpu_s"] = cpu_s
        records.append(rec)
    return launches, records


# ------------------------------------------------------------ stream phase

#: the stream phase's sessions: SF10 under the default session
#: (``max_device_rows`` 2^24, batches of 2^20), SF100 under the joins
#: phase's budget with batches of 2^24 (a CPU rehearsal at a small scale
#: sets smaller budgets here)
STREAM_SF10_PROPS: dict = {}
STREAM_SF100_PROPS = {"max_device_rows": JOINS_MAX_DEVICE_ROWS,
                      "page_capacity": 1 << 24}
#: orders per lineitem cycle: order i of a cycle has i + 1 lines
CYCLE_ORDERS = 7
CYCLE_ROWS = 28
#: Q18's HAVING threshold, unscaled at decimal(18, 2)
Q18_MIN_QTY = 300 * 100


def stream_q1():
    return Q1.replace("tpch.sf1.lineitem", "lineitem")


def stream_q18():
    q18 = tpch_queries()["Q18"]
    q18_all = q18.replace("limit 100", "")
    check(q18_all != q18, "Q18's LIMIT not found")
    return q18, q18_all


def parallel_chunks(total: int, chunk: int, fn):
    """fn(lo, hi) over [0, total) in chunks on 8 host threads (numpy
    releases the GIL), results in chunk order."""
    from concurrent.futures import ThreadPoolExecutor

    ranges = [(lo, min(lo + chunk, total)) for lo in range(0, total, chunk)]
    with ThreadPoolExecutor(max_workers=8) as pool:
        return list(pool.map(lambda r: fn(*r), ranges))


def numpy_q1_stream(schema: str):
    """Q1 over ``schema``'s lineitem in numpy, in chunks: exact int64
    sums and counts per (returnflag, linestatus)."""
    import numpy as np

    from presto_tpu_torch.connectors.tpch import SCHEMAS, TpchGenerator

    gen = TpchGenerator(SCHEMAS[schema])
    cols = ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
            "l_returnflag", "l_linestatus", "l_shipdate"]

    def part(lo, hi):
        d = gen.generate("lineitem", lo, hi, cols)
        rf, ls = d["l_returnflag"], d["l_linestatus"]
        names = [str(v) for v in rf.values], [str(v) for v in ls.values]
        keep = d["l_shipdate"].astype(np.int64) <= Q1_DATE
        qty, price, disc, tax = (d[c].astype(np.int64) for c in cols[:4])
        dp = price * (100 - disc)
        out = {}
        for i, f in enumerate(names[0]):
            for j, st in enumerate(names[1]):
                m = keep & (rf.ids == i) & (ls.ids == j)
                out[(f, st)] = np.array([
                    m.sum(), qty[m].sum(), price[m].sum(), dp[m].sum(),
                    (dp[m] * (100 + tax[m])).sum(), disc[m].sum()], np.int64)
        return out

    total = {}
    for out in parallel_chunks(gen.counts["lineitem"], 1 << 22, part):
        for k, v in out.items():
            total[k] = total.get(k, 0) + v
    q1 = {}
    for k, (n, qty, price, dp, charge, disc) in total.items():
        if n:
            q1[k] = {"count_order": int(n), "sum_qty": int(qty),
                     "sum_base_price": int(price), "sum_disc_price": int(dp),
                     "sum_charge": int(charge), "avg_qty": qty / 100 / n,
                     "avg_price": price / 100 / n, "avg_disc": disc / 100 / n}
    return gen.counts["lineitem"], q1


def numpy_q18(schema: str):
    """Every order of ``schema`` whose lines' quantity sums over 300, as
    Q18 returns it: {orderkey: (c_name, c_custkey, o_orderkey,
    o_orderdate, o_totalprice, sum(l_quantity))}. The generator keeps an
    order's lines together, 1..7 lines per order in cycles of 7 orders,
    so each chunk of whole cycles sums its orders by ``np.add.reduceat``
    over the l_quantity column alone."""
    import numpy as np

    from presto_tpu_torch.connectors.tpch import SCHEMAS, TpchGenerator

    gen = TpchGenerator(SCHEMAS[schema])
    n_orders = gen.counts["orders"]
    lens = np.tile(np.arange(1, CYCLE_ORDERS + 1), (1 << 22) // CYCLE_ORDERS)
    chunk = int(lens.sum())  # rows of whole cycles

    def part(lo, hi):
        qty = gen.generate("lineitem", lo, hi, ["l_quantity"])["l_quantity"]
        first = lo // CYCLE_ROWS * CYCLE_ORDERS
        n = min(len(lens), n_orders - first)
        starts = np.concatenate([[0], np.cumsum(lens[: n - 1])])
        check(int(lens[:n].sum()) == hi - lo, "a chunk splits an order")
        sums = np.add.reduceat(qty.astype(np.int64), starts)
        big = np.flatnonzero(sums > Q18_MIN_QTY)
        return first + big, sums[big]

    idx, sums = (np.concatenate(a) for a in zip(*parallel_chunks(
        gen.counts["lineitem"], chunk, part)))
    ocols = ["o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"]
    rows = {}
    for i, q in zip(idx.tolist(), sums.tolist()):
        o = gen.generate("orders", i, i + 1, ocols)
        ck = int(o["o_custkey"][0])
        c = gen.generate("customer", ck - 1, ck, ["c_name"])["c_name"]
        rows[int(o["o_orderkey"][0])] = (
            str(c.values[c.ids[0]]), ck, int(o["o_orderkey"][0]),
            int(o["o_orderdate"][0]), int(o["o_totalprice"][0]), int(q))
    return gen.counts["lineitem"], rows


def check_q18(name, res, want, limit: Optional[int]):
    """Q18's rows against numpy's: without a LIMIT every qualifying order
    as a set; with one, the rows in (o_totalprice desc, o_orderdate)
    order, each a qualifying order's row, carrying numpy's first
    ``limit`` sort keys (ties at the cut may pick either row)."""
    got = result_rows(res, ("c_name", "c_custkey", "o_orderkey",
                            "o_orderdate", "o_totalprice", "_col5"))
    check(len(set(got)) == len(got), f"{name}: a row twice")
    if limit is None:
        check(set(got) == set(want.values()),
              f"{name}: {len(got)} rows, numpy {len(want)}, or a row differs")
        return
    keys = [(-r[4], r[3]) for r in got]
    check(keys == sorted(keys), f"{name}: rows out of order")
    check(all(want.get(r[2]) == r for r in got), f"{name}: a row differs")
    want_keys = sorted((-r[4], r[3]) for r in want.values())[:limit]
    check(keys == want_keys, f"{name}: not numpy's top {limit}")


@contextlib.contextmanager
def counting_syncs(dev):
    """Counts the host's waits for the card while the block runs: torch's
    sync debug mode warns at each synchronizing call (each
    cudaStreamSynchronize behind a copy or a read of a device value),
    from any thread, and each warning is counted here instead of shown.
    Yields a one-item list; None on the CPU."""
    import warnings

    import torch

    count = [None if dev.type != "cuda" else 0]
    if dev.type != "cuda":
        yield count
        return
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def show(message, category, *args, **kwargs):
            if "synchronizing" in str(message):
                count[0] += 1
            else:
                shown(message, category, *args, **kwargs)

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield count
        finally:
            torch.cuda.set_sync_debug_mode(0)


def stream_run(runner, sql, dev, label, card, scanned, batches_expected):
    """One streamed run with the launch counts and stream counters reset
    just before and read just after; returns (result, record)."""
    import torch

    from presto_tpu_torch.exec.streaming import StreamStats
    from presto_tpu_torch.ops import aggregation as PA

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runner.stream_stats = StreamStats()
    retries = runner.overflow_retries
    PA.onehot_reduce.launches = 0
    with counting_syncs(dev) as syncs:
        res, secs = run_timed(runner, sql, dev)
    launches = PA.onehot_reduce.launches
    st = runner.stream_stats
    check(st.batches == batches_expected,
          f"{label}: {st.batches} batches, expected {batches_expected}")
    check(st.buckets > 0, f"{label}: no spill bucket ran")
    rec = {
        "query": label, "rows": int(res.page.num_valid), "s": secs,
        "rows_per_s": scanned / secs, "batches": st.batches,
        "empty_batches": st.empty_batches, "buckets": st.buckets,
        "spilled_rows": st.spilled_rows, "spilled_bytes": st.spilled_bytes,
        "retries": runner.overflow_retries - retries,
        "syncs": syncs[0],
        "syncs_per_batch": None if syncs[0] is None else syncs[0] / st.batches,
        "onehot_reduce_launches": launches,
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                     if dev.type == "cuda" else None),
        "peak_rss_gib": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2**20,
        "host_s": {"generate": st.generate_s, "stage": st.stage_s,
                   "bucket_of": st.hash_s, "merge_payloads": st.merge_s},
    }
    peak = ("not measured (no card)" if rec["peak_gib"] is None
            else f"{rec['peak_gib']:.3f} GiB")
    print(f"{label}: {rec['rows']} rows in {secs:.4f} s, "
          f"{rec['rows_per_s']:.1f} lineitem rows/s; batches {st.batches} "
          f"({st.empty_batches} empty), buckets {st.buckets}, spilled "
          f"{st.spilled_rows} rows / {st.spilled_bytes} bytes, retries "
          f"{rec['retries']}, host syncs {syncs[0]}, onehot_reduce launches "
          f"{launches}, peak memory {peak}, peak RSS "
          f"{rec['peak_rss_gib']:.3f} GiB; host s {rec['host_s']} [{card}]",
          flush=True)
    return res, rec


def stream_phase(card: str, dev=None, records=None, sf100: str = "sf100"):
    """The fourth slice's path on ``dev`` (the card unless a CPU
    rehearsal passes another): streamed Q1 and Q18 at SF10 under the
    default session, then Q18 at ``sf100`` once. Returns (the
    onehot_reduce launches of the counted runs, the records)."""
    import torch

    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.ops import aggregation as PA
    from presto_tpu_torch.session import Session

    from presto_tpu_torch.connectors.tpch import SCHEMAS, TpchGenerator

    dev = torch.device("cuda") if dev is None else dev
    on_card = dev.type == "cuda"
    out = []
    launches = 0
    q18, q18_all = stream_q18()

    def n_batches(rows, batch):
        return -(-rows // batch)

    # Q1 at SF10, default session: cold, warm
    t0 = time.perf_counter()
    n_li, want_q1 = numpy_q1_stream(JOINS_SCHEMA)
    print(f"numpy evaluation of Q1 at {JOINS_SCHEMA}: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    runner = LocalQueryRunner(device=dev, session=Session(
        schema=JOINS_SCHEMA, properties=STREAM_SF10_PROPS))
    batch = int(runner.session.get("page_capacity"))
    seen, calls = [], []
    real = PA.onehot_reduce_many

    def record(gid, requests, nseg):
        if not seen:
            seen.append((gid, list(requests), nseg))
        calls.append(len(requests))
        return real(gid, requests, nseg)

    q1_runs = []
    for label in ("Q1 stream cold", "Q1 stream warm"):
        calls.clear()
        PA.onehot_reduce_many = record
        try:
            res, rec = stream_run(runner, stream_q1(), dev,
                                  f"{label} {JOINS_SCHEMA}", card, n_li,
                                  n_batches(n_li, batch))
        finally:
            PA.onehot_reduce_many = real
        # one one-hot call per batch (the partial GROUP BY) and per
        # bucket merge (the final one), each one launch per K_MAX
        # requests: the final step sums 11 nullable partial states, each
        # with its count of non-NULL rows, so 22 requests, 2 launches
        check(len(calls) == rec["batches"] + rec["buckets"],
              f"{label}: {len(calls)} one-hot calls, expected one per "
              f"batch and per bucket merge ({rec['batches']} + "
              f"{rec['buckets']})")
        want_launches = (sum(-(-k // PA.K_MAX) for k in calls)
                         if on_card else 0)
        check(rec["onehot_reduce_launches"] == want_launches,
              f"{label}: {rec['onehot_reduce_launches']} onehot_reduce "
              f"launches, expected {want_launches} for the requests "
              f"{sorted(set(calls))}")
        rec["onehot_calls"] = len(calls)
        rec["onehot_requests"] = sorted(set(calls))
        launches += rec["onehot_reduce_launches"]
        n, cols = result_columns(res)
        check(n == len(want_q1), f"{label}: {n} groups, numpy {len(want_q1)}")
        for i in range(n):
            key = (cols["l_returnflag"][i], cols["l_linestatus"][i])
            exp = want_q1[key]
            for name in ("sum_qty", "sum_base_price", "sum_disc_price",
                         "sum_charge", "count_order"):
                check(int(cols[name][i]) == exp[name],
                      f"{label} {key} {name}: {cols[name][i]} != {exp[name]}")
            for name in ("avg_qty", "avg_price", "avg_disc"):
                got = float(cols[name][i])
                check(abs(got - exp[name]) <= 1e-12 * abs(exp[name]),
                      f"{label} {key} {name}: {got} vs {exp[name]}")
        q1_runs.append(res)
        out.append(rec)
    diff = results_differ(*q1_runs)
    check(diff is None, f"Q1 stream: cold and warm differ ({diff})")
    if records is not None and on_card:
        # the one-hot reduction at the first streamed batch's inputs
        records.append(fused_case("q1 stream batch fused", *seen[0], card))
    del runner, q1_runs, seen

    # Q18 at SF10, default session: cold, warm, and without LIMIT
    t0 = time.perf_counter()
    n_li, want18 = numpy_q18(JOINS_SCHEMA)
    print(f"numpy evaluation of Q18 at {JOINS_SCHEMA}: {len(want18)} orders "
          f"over 300 ({time.perf_counter() - t0:.2f} s)", flush=True)
    runner = LocalQueryRunner(device=dev, session=Session(
        schema=JOINS_SCHEMA, properties=STREAM_SF10_PROPS))
    q18_runs = []
    # each run streams lineitem twice: the subquery, then the outer join
    for label, sql, limit in (("Q18 stream cold", q18, 100),
                              ("Q18 stream warm", q18, 100),
                              ("Q18 stream without LIMIT", q18_all, None)):
        res, rec = stream_run(runner, sql, dev, f"{label} {JOINS_SCHEMA}",
                              card, n_li, 2 * n_batches(n_li, batch))
        launches += rec["onehot_reduce_launches"]
        check_q18(label, res, want18, limit)
        if limit:
            q18_runs.append(res)
        out.append(rec)
    # the serial loop (no prefetch thread) gives the same bits
    serial = LocalQueryRunner(device=dev, session=Session(
        schema=JOINS_SCHEMA,
        properties={**STREAM_SF10_PROPS, "staging_prefetch_depth": 0}))
    res, rec = stream_run(serial, q18, dev,
                          f"Q18 stream prefetch depth 0 {JOINS_SCHEMA}",
                          card, n_li, 2 * n_batches(n_li, batch))
    launches += rec["onehot_reduce_launches"]
    out.append(rec)
    q18_runs.append(res)
    for other in q18_runs[1:]:
        diff = results_differ(q18_runs[0], other)
        check(diff is None, f"Q18 stream: two runs differ ({diff})")
    print(f"Q18 {JOINS_SCHEMA}: the top 100 and all {len(want18)} orders "
          "equal numpy's; cold, warm and prefetch depth 0 bit-identical",
          flush=True)
    del runner, serial, q18_runs

    # Q18 at SF100: lineitem and orders both over the budget, once
    t0 = time.perf_counter()
    n_li, want18 = numpy_q18(sf100)
    print(f"numpy evaluation of Q18 at {sf100}: {len(want18)} orders over "
          f"300 ({time.perf_counter() - t0:.2f} s)", flush=True)
    runner = LocalQueryRunner(device=dev, session=Session(
        schema=sf100, properties=STREAM_SF100_PROPS))
    n_orders = TpchGenerator(SCHEMAS[sf100]).counts["orders"]
    batch = STREAM_SF100_PROPS["page_capacity"]
    # the subquery's pass over lineitem, then both join sides' passes
    want_batches = 2 * n_batches(n_li, batch) + n_batches(n_orders, batch)
    res, rec = stream_run(runner, q18, dev, f"Q18 stream {sf100}", card,
                          n_li, want_batches)
    launches += rec["onehot_reduce_launches"]
    check_q18("Q18 stream " + sf100, res, want18, 100)
    out.append(rec)
    print(f"Q18 {sf100}: the top 100 of {len(want18)} orders equal numpy's",
          flush=True)
    return launches, out


def main() -> int:
    if not (ROOT / "presto_tpu_torch").is_dir():
        print(
            "chip_smoke.py: presto_tpu_torch/ is not beside this script",
            file=sys.stderr,
        )
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("device")
    card = card_line()
    print(card, flush=True)

    phase("build")
    from presto_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.load("onehot_reduce")
    print(
        f"onehot_reduce loaded (compiled if stale) in "
        f"{time.perf_counter() - t0:.2f} s",
        flush=True,
    )

    phase("kernels")
    records = kernel_phase(card)

    phase("slice")
    counts = slice_phase(card)

    phase("joins")
    joins_launches = joins_phase(card, records=records)

    phase("rest")
    rest_launches, rest_records = rest_phase(card)

    phase("stream")
    stream_launches, stream_records = stream_phase(card, records=records)

    headline = next(r for r in records if r["label"] == "q1 fused")
    kernels_line = {
        "kernels": [
            {
                "name": "onehot_reduce",
                "route": "cuda",
                "source": "presto_tpu_torch/csrc/onehot_reduce.cu",
                "replaces": "tools/pallas_groupby.py:96",
                "launches": (counts["onehot_reduce"] + joins_launches
                             + rest_launches + stream_launches),
                "max_abs_err": headline["max_abs_err"],
                "ms": headline["ms"],
                "plain_ms": headline["plain_ms"],
                "bound_ms": headline["bound_ms"],
                "bound_by": headline["bound_by"],
                "library_ms": headline["library_ms"],
            }
        ]
    }
    print(json.dumps({"cases": records, "slice": counts,
                      "joins_onehot_reduce": joins_launches,
                      "rest": rest_records, "rest_onehot_reduce": rest_launches,
                      "stream": stream_records,
                      "stream_onehot_reduce": stream_launches,
                      "card": card}))
    print(json.dumps(kernels_line))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
              same function (``library_ms``; the port never calls it).
4. slice    - TPC-H Q1 and Q6 at SF1 (lineitem 5,999,995 rows) through
              ``LocalQueryRunner(device="cuda")``, each cold then warm, with
              the kernels' launch counts reset just before and read just
              after, and both results held against an independent numpy
              evaluation over the same generated columns.
5. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``.

It needs a CUDA device and the repository beside it; without either it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

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
    return records


# ------------------------------------------------------------- slice phase


def numpy_q1_q6():
    """Q1 and Q6 evaluated in numpy over the same generated columns:
    exact int64 sums and counts per (returnflag, linestatus) id pair."""
    import numpy as np

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
    d = gen.generate("lineitem", 0, SF1_LINEITEM_ROWS, cols)
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
    check(per_q1 > 0, "Q1 did not launch the onehot_reduce kernel")

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

    headline = next(r for r in records if r["label"] == "q1 i64 sum")
    kernels_line = {
        "kernels": [
            {
                "name": "onehot_reduce",
                "route": "cuda",
                "source": "presto_tpu_torch/csrc/onehot_reduce.cu",
                "replaces": "tools/pallas_groupby.py:96",
                "launches": counts["onehot_reduce"],
                "max_abs_err": headline["max_abs_err"],
                "ms": headline["ms"],
                "plain_ms": headline["plain_ms"],
                "bound_ms": headline["bound_ms"],
                "bound_by": headline["bound_by"],
                "library_ms": headline["library_ms"],
            }
        ]
    }
    print(json.dumps({"cases": records, "slice": counts, "card": card}))
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

#!/usr/bin/env python3
"""Where the time of a warm TPC-H query goes in the PyTorch/CUDA port.

    python3 chip_profile.py [--runs 5] [--queries q1,q6,q3,q5] [--out FILE]

For Q1 and then Q6 on tpch.sf1, then Q3 and Q5 on tpch.sf10 with
``max_device_rows`` 2^26 (the texts and session of chip_smoke.py; or
the ``--queries`` named, out of those and ``window`` (BASELINE.json's
window query over tpch.sf10.orders, default session), ``q9`` and
``q22`` (on tpch.sf10 in the joins session), and the streamed
``q1_stream`` and ``q18_stream`` (Q1 and Q18 on tpch.sf10 under the
default session: lineitem streams in 2^20-row batches with host-RAM
spill)), each on one ``LocalQueryRunner(device="cuda")``: one cold run
and two warm runs (one for a streamed query), then ``--runs`` warm runs
under ``torch.profiler`` (CPU and CUDA activities). A streamed query also
reports its stream counters over the profiled runs: batches, buckets,
spilled bytes, host seconds in connector generation, staging,
``_bucket_of`` and ``merge_payloads``, and cudaStreamSynchronize per
batch. Prints, per query, the host wall time of a warm run, the
device time of its kernels, the device's busy share of the wall time,
the host time of parsing and planning alone, the device time by kind of
kernel (sort passes, searchsorted, gathers and scatters, scans,
onehot_reduce, the rest), the CUDA runtime calls per query
(``cudaLaunchKernel``, ``cudaStreamSynchronize``, ...), the host's
Python functions by own time (cProfile, ``--runs`` more warm runs), the
kernels by device time and the host operators by CPU time, and writes
the same as JSON to ``--out``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: kinds of kernel by name (lower case), first match wins
KINDS = (
    ("onehot_reduce", ("onehot_reduce", "onehot_many")),
    ("searchsorted", ("searchsorted",)),
    ("sort", ("sort", "radix")),
    ("scan", ("scan",)),
    ("gather/scatter", ("index", "gather", "scatter")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, marks in KINDS:
        if any(m in low for m in marks):
            return kind
    return "other"


def host_functions(runner, sql: str, runs: int, top: int = 10):
    """The host's Python functions by own time over ``runs`` warm runs
    under cProfile: where a host-bound query spends its wall time."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(runs):
        runner.execute(sql)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return [
        {"function": f"{Path(file).name}:{line}({fn})",
         "calls": calls // runs, "own_s": own / runs, "cum_s": cum / runs}
        for (file, line, fn), (_, calls, own, cum, _) in rows
    ]


def profile_query(runner, sql: str, runs: int, warm: int = 2):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from presto_tpu_torch.exec.streaming import StreamStats
    from presto_tpu_torch.plan.planner import plan_statement
    from presto_tpu_torch.sql import parse_statement

    t0 = time.perf_counter()
    runner.execute(sql)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    for _ in range(warm):
        runner.execute(sql)
    torch.cuda.synchronize()

    runner.stream_stats = StreamStats()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            runner.execute(sql)
        torch.cuda.synchronize()
        wall_s = (time.perf_counter() - t0) / runs
    stream = {k: v / runs
              for k, v in dataclasses.asdict(runner.stream_stats).items()}

    # unprofiled warm runs: the profiler's own cost stays out of warm_s
    t0 = time.perf_counter()
    for _ in range(runs):
        runner.execute(sql)
    torch.cuda.synchronize()
    warm_s = (time.perf_counter() - t0) / runs

    # the host front end alone: parse and plan, no device work
    t0 = time.perf_counter()
    for _ in range(runs):
        plan_statement(parse_statement(sql), runner.catalogs, runner.session)
    plan_s = (time.perf_counter() - t0) / runs

    kernels, host = [], []
    for evt in prof.key_averages():
        dev_us = evt.self_device_time_total
        if evt.device_type == DeviceType.CUDA and dev_us > 0:
            kernels.append(
                {"name": evt.key, "calls": evt.count // runs,
                 "device_us": dev_us / runs}
            )
        elif evt.self_cpu_time_total > 0:
            host.append(
                {"name": evt.key, "calls": evt.count // runs,
                 "self_cpu_us": evt.self_cpu_time_total / runs}
            )
    kernels.sort(key=lambda k: -k["device_us"])
    host.sort(key=lambda h: -h["self_cpu_us"])
    device_s = sum(k["device_us"] for k in kernels) / 1e6
    by_kind = {}
    for k in kernels:
        agg = by_kind.setdefault(kind_of(k["name"]), {"device_us": 0.0,
                                                      "calls": 0})
        agg["device_us"] += k["device_us"]
        agg["calls"] += k["calls"]
    runtime = {h["name"]: h["calls"] for h in host
               if h["name"].startswith("cuda")}
    if stream["batches"]:
        stream["syncs_per_batch"] = (
            runtime.get("cudaStreamSynchronize", 0) / stream["batches"]
        )
    return {
        "stream": stream if stream["batches"] else None,
        "host_functions": host_functions(runner, sql, runs),
        "cold_s": cold_s,
        "warm_s": warm_s,
        "plan_s": plan_s,
        "profiled_wall_s": wall_s,
        "device_s": device_s,
        "device_busy_share": device_s / wall_s if device_s else None,
        "by_kind": by_kind,
        "cuda_runtime_calls": runtime,
        "kernels": kernels,
        "host_ops": host,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--queries", default="q1,q6,q3,q5",
                    help="comma-separated subset of "
                    "q1,q6,q3,q5,window,q9,q22,q1_stream,q18_stream")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_profile.py: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (
        JOINS_MAX_DEVICE_ROWS, JOINS_SCHEMA, Q1, Q3, Q5, Q6, WINDOW,
        WINDOW_SCHEMA, card_line, stream_q1, stream_q18, tpch_queries,
    )
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.session import Session

    card = card_line()
    sf1 = LocalQueryRunner(device="cuda")
    joins = LocalQueryRunner(
        device="cuda",
        session=Session(
            schema=JOINS_SCHEMA,
            properties={"max_device_rows": JOINS_MAX_DEVICE_ROWS},
        ),
    )
    stream = LocalQueryRunner(
        device="cuda", session=Session(schema=JOINS_SCHEMA)
    )
    report = {"card": card, "runs": args.runs}
    wanted = args.queries.split(",")
    tpch = tpch_queries()
    for name, schema, runner, sql in (
        ("q1", "sf1", sf1, Q1), ("q6", "sf1", sf1, Q6),
        ("q3", JOINS_SCHEMA, joins, Q3), ("q5", JOINS_SCHEMA, joins, Q5),
        ("window", WINDOW_SCHEMA, sf1, WINDOW),
        ("q9", JOINS_SCHEMA, joins, tpch["Q9"]),
        ("q22", JOINS_SCHEMA, joins, tpch["Q22"]),
        ("q1_stream", JOINS_SCHEMA, stream, stream_q1()),
        ("q18_stream", JOINS_SCHEMA, stream, stream_q18()[0]),
    ):
        if name not in wanted:
            continue
        rec = profile_query(runner, sql, args.runs,
                            warm=1 if runner is stream else 2)
        rec["schema"] = schema
        report[name] = rec
        share = rec["device_busy_share"]
        print(
            f"{name} {schema}: cold_s {rec['cold_s']:.4f}, warm_s "
            f"{rec['warm_s']:.6f} (parse+plan {rec['plan_s']:.6f}), "
            f"device_s {rec['device_s']:.6f}, busy "
            f"share {'not measured' if share is None else f'{share:.4f}'} "
            f"[{card}]",
            flush=True,
        )
        for kind, agg in sorted(rec["by_kind"].items(),
                                key=lambda kv: -kv[1]["device_us"]):
            print(f"  kind   {agg['device_us']:10.1f} us x{agg['calls']:<4} "
                  f"{kind}")
        if rec["stream"]:
            print("  stream per query: " + ", ".join(
                f"{k} {v:.4f}" for k, v in rec["stream"].items()))
        print("  runtime calls per query: " + ", ".join(
            f"{k} {v}" for k, v in sorted(rec["cuda_runtime_calls"].items())))
        for f in rec["host_functions"][:6]:
            print(f"  python {f['own_s'] * 1e6:10.1f} us own "
                  f"{f['cum_s'] * 1e6:10.1f} us cum x{f['calls']:<4} "
                  f"{f['function']}")
        for k in rec["kernels"][:12]:
            print(f"  kernel {k['device_us']:10.1f} us x{k['calls']:<4} "
                  f"{k['name'][:100]}")
        for h in rec["host_ops"][:12]:
            print(f"  host   {h['self_cpu_us']:10.1f} us x{h['calls']:<4} "
                  f"{h['name'][:100]}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

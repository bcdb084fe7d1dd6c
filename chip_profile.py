#!/usr/bin/env python3
"""Where the time of a warm TPC-H or TPC-DS query goes in the PyTorch/CUDA port.

    python3 chip_profile.py [--runs 5] [--queries q1,q6,q3,q5]
                            [--stats-on-off] [--out FILE]

For Q1 and then Q6 on tpch.sf1, then Q3 and Q5 on tpch.sf10 with
``max_device_rows`` 2^26 (the texts and session of chip_smoke.py; or
the ``--queries`` named, out of those and ``window`` (BASELINE.json's
window query over tpch.sf1.orders, default session), ``q9`` and
``q22`` (on tpch.sf10 in the joins session), the streamed
``q1_stream`` and ``q18_stream`` (Q1 and Q18 on tpch.sf10 under the
default session: lineitem streams in 2^20-row batches with host-RAM
spill), ``q1_stream_cached`` (the same streamed Q1 with
``stream_split_cache`` on: after its cold pass fills the split cache,
every profiled pass is served from it), ``q64_sf10`` (TPC-DS Q64 on
tpcds.sf10 in the joins session), ``q95_sf10_stream`` (TPC-DS Q95 on
tpcds.sf10 in chip_smoke.py's Q95 streaming session: web_sales streams
under ``max_device_rows`` 2^22), the nested slice's ``n1_unnest_sf10``
(a static UNNEST into the one-hot GROUP BY), ``n2_array_agg_sf10``
(array_agg by order, unnested again) and ``n3_order_stats_sf10``
(global approx_percentile/min_by/max_by), chip_smoke.py's N1-N3 over
tpch.sf10.lineitem in the joins session, and ``q1_microbatch``: the
serve phase's V3 batch, Q1 over tpch.sf1 with its 8 shipdate cutoffs
answered by one ``execute_plan_microbatch`` pass (8 lanes, one K1
launch through ``onehot_reduce_lanes``, every lane held to the scalar
Q1 of its cutoff), so the trace shows the lane call beside the
operators around it), each on one
``LocalQueryRunner(device="cuda")``: one cold run and two warm runs
(one for a streamed query), then ``--runs`` warm runs
under ``torch.profiler`` (CPU and CUDA activities). A streamed query also
reports its stream counters over the profiled runs: batches, buckets,
spilled bytes, host seconds in connector generation, staging,
``_bucket_of`` and ``merge_payloads``, and cudaStreamSynchronize per
batch, and the split cache's hits and misses over the profiled runs.
Prints, per query, the host wall time of a warm run, the device time of
its kernels, the device's busy share of the wall time, the host time of
parsing and planning alone (``plan_s``, no plan cache) and of parsing
and planning as a warm run does it (``plan_cached_s``: through the plan
cache, a hit after the first run), the device time by kind of
kernel (sort passes, searchsorted, gathers and scatters, scans,
onehot_reduce, the rest), the CUDA runtime calls per query
(``cudaLaunchKernel``, ``cudaStreamSynchronize``, ...), the host's
Python functions by own time (cProfile, ``--runs`` more warm runs), the
kernels by device time and the host operators by CPU time, and writes
the same as JSON to ``--out``. With ``--stats-on-off`` each query then
makes ``--runs`` more warm runs with session ``enable_operator_stats``
on and as many with it off, alternating run by run, checks that their
rows are equal, and prints the wall times of each. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
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


def host_functions(run, runs: int, top: int = 10):
    """The host's Python functions by own time over ``runs`` warm runs
    (``run()`` each) under cProfile: where a host-bound query spends its
    wall time."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(runs):
        run()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return [
        {"function": f"{Path(file).name}:{line}({fn})",
         "calls": calls // runs, "own_s": own / runs, "cum_s": cum / runs}
        for (file, line, fn), (_, calls, own, cum, _) in rows
    ]


def rows_of(res):
    """A run's rows: a query's, or each lane's of a micro-batch."""
    return [r.rows() for r in res] if isinstance(res, list) else res.rows()


def microbatch_run(runner, shape: str, cutoffs):
    """One micro-batch of ``shape`` (one ``?``) over ``cutoffs``, as the
    coordinator's batch queue dispatches it: each member's statement
    through the plan cache, then ONE ``execute_plan_microbatch`` pass.
    Checks that the shape batches and that every lane equals its scalar
    run; returns the function that runs the batch and its results."""
    from presto_tpu_torch.sql import parse_statement

    stmts = [parse_statement(shape.replace("?", f"date '{c}'"))
             for c in cutoffs]
    plan = runner.plan_cached_keyed(stmts[0])[0]
    if not runner.microbatch_plan_eligible(plan):
        raise AssertionError("the micro-batch shape is not eligible")

    def run():
        plans = [runner.plan_cached_keyed(st)[0] for st in stmts]
        res = runner.execute_plan_microbatch(plans, [None] * len(plans))
        if any(r is None for r in res):
            raise AssertionError("a lane fell out of the micro-batch")
        return res

    want = [runner.execute(shape.replace("?", f"date '{c}'")).rows()
            for c in cutoffs]
    if rows_of(run()) != want:
        raise AssertionError("a lane differs from its scalar run")
    return run


def profile_query(runner, sql: str, runs: int, warm: int = 2, run=None):
    """Profile ``run()`` (by default ``runner.execute(sql)``); ``sql``
    is also what the front end's parse and plan times take."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from presto_tpu_torch.exec.streaming import StreamStats
    from presto_tpu_torch.plan.planner import plan_statement
    from presto_tpu_torch.sql import parse_statement

    if run is None:
        run = functools.partial(runner.execute, sql)
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    for _ in range(warm):
        run()
    torch.cuda.synchronize()

    runner.stream_stats = StreamStats()
    cache_before = runner.split_cache.stats()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            run()
        torch.cuda.synchronize()
        wall_s = (time.perf_counter() - t0) / runs
    stream = {k: v if k == "largest_merge_rows" else v / runs
              for k, v in dataclasses.asdict(runner.stream_stats).items()}
    cache_after = runner.split_cache.stats()
    split_cache = {k: (cache_after[k] - cache_before[k]) / runs
                   for k in ("hits", "misses", "evictions")}

    # unprofiled warm runs: the profiler's own cost stays out of warm_s
    t0 = time.perf_counter()
    for _ in range(runs):
        run()
    torch.cuda.synchronize()
    warm_s = (time.perf_counter() - t0) / runs

    # the host front end alone: parse and plan, no device work
    t0 = time.perf_counter()
    for _ in range(runs):
        plan_statement(parse_statement(sql), runner.catalogs, runner.session)
    plan_s = (time.perf_counter() - t0) / runs
    # parse and plan as a warm run does: through the plan cache
    t0 = time.perf_counter()
    for _ in range(runs):
        runner.plan_cached(parse_statement(sql))
    plan_cached_s = (time.perf_counter() - t0) / runs

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
        "host_functions": host_functions(run, runs),
        "cold_s": cold_s,
        "warm_s": warm_s,
        "plan_s": plan_s,
        "plan_cached_s": plan_cached_s,
        "split_cache_per_query": split_cache,
        "profiled_wall_s": wall_s,
        "device_s": device_s,
        "device_busy_share": device_s / wall_s if device_s else None,
        "by_kind": by_kind,
        "cuda_runtime_calls": runtime,
        "kernels": kernels,
        "host_ops": host,
    }


def stats_on_off(runner, run, runs: int):
    """Warm wall times (s, sorted) of ``run()`` with session
    ``enable_operator_stats`` on and off, alternating run by run; every
    run's rows must equal the first's."""
    import torch

    times = {"on": [], "off": []}
    first = None
    for i in range(2 * runs):
        mode = ("on", "off")[i % 2]
        runner.session.set("enable_operator_stats", mode == "on")
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        times[mode].append(time.perf_counter() - t0)
        rows = rows_of(res)
        if first is None:
            first = rows
        elif rows != first:
            raise AssertionError(f"operator stats {mode}: the rows differ")
    runner.session.set("enable_operator_stats", True)
    return {m: sorted(v) for m, v in times.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--queries", default="q1,q6,q3,q5",
                    help="comma-separated subset of "
                    "q1,q6,q3,q5,window,q9,q22,q1_stream,q18_stream,"
                    "q1_stream_cached,q64_sf10,q95_sf10_stream,"
                    "n1_unnest_sf10,n2_array_agg_sf10,n3_order_stats_sf10,"
                    "q1_microbatch")
    ap.add_argument("--stats-on-off", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_profile.py: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (
        JOINS_MAX_DEVICE_ROWS, JOINS_SCHEMA, N1, N2_UNNEST, N3, Q1, Q1_CUTOFFS,
        Q1_CUT_SHAPE, Q3, Q5, Q6, Q95_STREAM_SF10_PROPS,
        SERVE_FRAGMENT_WEIGHT, TPCDS_SF10, WINDOW, WINDOW_SCHEMA,
        cache_budget, card_line, stream_q1, stream_q18, tpcds_queries,
        tpch_queries,
    )
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.session import Session

    card = card_line()
    budget = cache_budget(torch.device("cuda"))
    sf1 = LocalQueryRunner(device="cuda", staging_cache_bytes=budget)
    joins = LocalQueryRunner(
        device="cuda",
        session=Session(
            schema=JOINS_SCHEMA,
            properties={"max_device_rows": JOINS_MAX_DEVICE_ROWS},
        ),
        staging_cache_bytes=budget,
    )
    stream = LocalQueryRunner(
        device="cuda", session=Session(schema=JOINS_SCHEMA),
        staging_cache_bytes=budget,
    )
    stream_cached = LocalQueryRunner(
        device="cuda",
        session=Session(schema=JOINS_SCHEMA,
                        properties={"stream_split_cache": True}),
        staging_cache_bytes=budget,
    )
    q95_stream = LocalQueryRunner(
        device="cuda",
        session=Session(schema=TPCDS_SF10, properties=Q95_STREAM_SF10_PROPS),
        staging_cache_bytes=budget,
    )
    # the serve phase's session for its micro-batch, apart from sf1's
    # default one
    batch = LocalQueryRunner(
        device="cuda",
        session=Session(
            properties={"max_fragment_weight": SERVE_FRAGMENT_WEIGHT}),
        staging_cache_bytes=budget,
    )
    report = {"card": card, "runs": args.runs}
    wanted = args.queries.split(",")
    batch_run = None
    if "q1_microbatch" in wanted:
        batch_run = microbatch_run(batch, Q1_CUT_SHAPE, Q1_CUTOFFS)
    tpch = tpch_queries()
    for name, schema, runner, sql in (
        ("q1", "sf1", sf1, Q1), ("q6", "sf1", sf1, Q6),
        ("q3", JOINS_SCHEMA, joins, Q3), ("q5", JOINS_SCHEMA, joins, Q5),
        ("window", WINDOW_SCHEMA, sf1, WINDOW),
        ("q9", JOINS_SCHEMA, joins, tpch["Q9"]),
        ("q22", JOINS_SCHEMA, joins, tpch["Q22"]),
        ("q1_stream", JOINS_SCHEMA, stream, stream_q1()),
        ("q18_stream", JOINS_SCHEMA, stream, stream_q18()[0]),
        ("q1_stream_cached", JOINS_SCHEMA, stream_cached, stream_q1()),
        ("q64_sf10", TPCDS_SF10, joins, tpcds_queries(TPCDS_SF10)[0]),
        ("q95_sf10_stream", TPCDS_SF10, q95_stream,
         tpcds_queries(TPCDS_SF10)[1]),
        ("n1_unnest_sf10", JOINS_SCHEMA, joins, N1),
        ("n2_array_agg_sf10", JOINS_SCHEMA, joins, N2_UNNEST),
        ("n3_order_stats_sf10", JOINS_SCHEMA, joins, N3),
        ("q1_microbatch", "sf1", batch,
         Q1_CUT_SHAPE.replace("?", f"date '{Q1_CUTOFFS[-1]}'")),
    ):
        if name not in wanted:
            continue
        warm = {stream: 1, stream_cached: 1, q95_stream: 1}.get(runner, 2)
        run = (batch_run if name == "q1_microbatch"
               else functools.partial(runner.execute, sql))
        rec = profile_query(runner, sql, args.runs, warm=warm, run=run)
        rec["schema"] = schema
        report[name] = rec
        share = rec["device_busy_share"]
        print(
            f"{name} {schema}: cold_s {rec['cold_s']:.4f}, warm_s "
            f"{rec['warm_s']:.6f} (parse+plan {rec['plan_s']:.6f}, through "
            f"the plan cache {rec['plan_cached_s']:.6f}), "
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
        print("  split cache per query: " + ", ".join(
            f"{k} {v:.1f}" for k, v in rec["split_cache_per_query"].items()))
        print("  runtime calls per query: " + ", ".join(
            f"{k} {v}" for k, v in sorted(rec["cuda_runtime_calls"].items())))
        for f in rec["host_functions"][:6]:
            print(f"  python {f['own_s'] * 1e6:10.1f} us own "
                  f"{f['cum_s'] * 1e6:10.1f} us cum x{f['calls']:<4} "
                  f"{f['function']}")
        if args.stats_on_off:
            rec["stats_on_off_s"] = times = stats_on_off(runner, run,
                                                         args.runs)
            for mode, ts in times.items():
                print(f"  operator stats {mode}: warm s median "
                      f"{ts[len(ts) // 2]:.6f}, min {ts[0]:.6f}, all "
                      + " ".join(f"{t:.6f}" for t in ts) + f" [{card}]")
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

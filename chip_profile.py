#!/usr/bin/env python3
"""Where the time of a warm TPC-H query goes in the PyTorch/CUDA port.

    python3 chip_profile.py [--runs 5] [--out FILE]

For Q1 and then Q6 on tpch.sf1 (the texts of chip_smoke.py) on one
``LocalQueryRunner(device="cuda")``: one cold run and two warm runs,
then ``--runs`` warm runs under ``torch.profiler`` (CPU and CUDA
activities). Prints, per query, the host wall time of a warm run, the
device time of its kernels, the device's busy share of the wall time,
the host time of parsing and planning alone, the kernels by device time
and the host operators by CPU time, and writes the same as JSON to
``--out``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def profile_query(runner, sql: str, runs: int):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from presto_tpu_torch.plan.planner import plan_statement
    from presto_tpu_torch.sql import parse_statement

    t0 = time.perf_counter()
    runner.execute(sql)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    for _ in range(2):
        runner.execute(sql)
    torch.cuda.synchronize()

    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            runner.execute(sql)
        torch.cuda.synchronize()
        wall_s = (time.perf_counter() - t0) / runs

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
    return {
        "cold_s": cold_s,
        "warm_s": warm_s,
        "plan_s": plan_s,
        "profiled_wall_s": wall_s,
        "device_s": device_s,
        "device_busy_share": device_s / wall_s if device_s else None,
        "kernels": kernels,
        "host_ops": host,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_profile.py: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import Q1, Q6, card_line
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner

    card = card_line()
    runner = LocalQueryRunner(device="cuda")
    report = {"card": card, "schema": "sf1", "runs": args.runs}
    for name, sql in (("q1", Q1), ("q6", Q6)):
        rec = profile_query(runner, sql, args.runs)
        report[name] = rec
        share = rec["device_busy_share"]
        print(
            f"{name} sf1: cold_s {rec['cold_s']:.4f}, warm_s "
            f"{rec['warm_s']:.6f} (parse+plan {rec['plan_s']:.6f}), "
            f"device_s {rec['device_s']:.6f}, busy "
            f"share {'not measured' if share is None else f'{share:.4f}'} "
            f"[{card}]",
            flush=True,
        )
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

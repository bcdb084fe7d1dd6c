#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (presto_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits
non-zero, and only a run where every phase passed prints the final
``{"ok": true, ...}`` line:

1. device   - the card's name and power limit (nvidia-smi).
2. build    - the port's CUDA kernel, compiled with nvcc into
              presto_tpu_torch/build/ when its library is missing or
              older than its source, and loaded; then the host C++
              loops (the generator's fused stream, the string codec),
              compiled with g++ the same way. The ``native:`` line says
              which path the host runs; anything but ``native`` fails.
3. kernels  - each kernel against its plain PyTorch version on the card,
              at the shapes the main path gives it, timed beside its
              computed bound and one PyTorch library call computing the
              same function (``library_ms``; the port never calls it):
              single reductions at the TPU tool's and Q1's shapes over a
              random gid, then Q1's own aggregation at SF1 as the one
              launch the slice makes (the headline of the kernels line),
              single reductions over Q1's own gid, and small calls of
              K = 19 and 40 requests over 5 to 4,096 rows (the direct
              form: one launch each), beside an empty launch's time.
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
6. observe  - the eighth slice, over the slice and joins phases'
              runners and the tables they staged: the device probe
              (``utils/devicediag.py``: enumerate the card, build K1,
              one K1 launch against its plain version); EXPLAIN of Q1 and
              Q5, each equal to the port's CPU runner's text; EXPLAIN
              ANALYZE of Q1 at SF1 and Q5 at SF10 (whole-table, one K1
              launch each), the result exact against numpy and each
              scan's, filter's and aggregation's rows equal to a numpy
              count over the generator's columns; warm Q1 with operator
              stats on and off (the same rows, the same host waits) and
              the warm latency of Q1, Q6 and TPC-DS Q64 at SF1 both ways;
              a history store and adaptive replanning on Q3 at SF10 (its
              EXPLAIN then says ``history``; a cached variant whose
              literals move the lineitem filter's rows past the
              divergence factor replans, exact against numpy); and the
              ``system`` tables read by SQL on the card (runtime.queries,
              metrics, caches, memory, and nodes, whose backend_diag
              names the card with all three probe phases ok).
7. rest     - the third slice: BASELINE.json's window query over SF1
              orders (1,500,000 rows, default session; SF10 until the
              fuzz and files phases needed the time), every row's rn
              and rk held exactly against a numpy evaluation; TPC-H Q9
              (LIKE, EXTRACT, a six-way join), Q22 and Q22 without its NOT
              EXISTS (a transformed-dictionary key: exactly one
              onehot_reduce launch per run) at SF10 in the joins phase's
              session, exact against numpy; then Q2, Q7, Q8, Q13, Q14, Q16
              and Q20 at SF1, each equal to the same query on the port's
              CPU runner (doubles within rel 1e-9). Each query runs cold
              then twice warm with the launch counts reset just before and
              read just after; the warm runs must agree bit for bit.
8. stream   - the fourth slice, split-streamed execution with host-RAM
              spill, through a CUDA runner: TPC-H Q1 at SF10 under the
              default session (lineitem's 59,999,997 rows over
              ``max_device_rows`` 2^24 stream in 58 batches of 2^20;
              onehot_reduce launches equal the batches plus the bucket
              merges) and Q18 at SF10 (lineitem streams twice, orders is
              replicated whole), each cold then warm and bit-identical,
              Q18 also without its LIMIT (every order over 300 as a set)
              and once more with ``staging_prefetch_depth`` 0 (the
              serial loop, bit-identical to the prefetched runs);
              then Q18 at SF10 under ``max_device_rows`` 2^23, batches
              of 2^22: lineitem's 59,999,997 rows and orders' 15,000,000
              both exceed the budget, so the outer join takes the
              partitioned build-side spill (SF100 until the distrib and
              ici phases needed the time, then SF30 until the fuzz and
              files phases did), once.
              Every run is exact
              against numpy over the generator's own columns and prints
              its batches, buckets, spilled bytes, retries, host syncs,
              native generator calls (at least one on the card), peak
              device memory and peak RSS.
9. tpcds    - the fifth slice, TPC-DS through a CUDA runner: Q64 and Q95
              at SF1 in the joins phase's session, each cold then twice
              warm and equal to the port's CPU runner on the same SQL
              (decimals, integers and strings exact, doubles within rel
              1e-9); Q95 at SF10 whole-table, then streamed under
              ``max_device_rows`` 2^22 (web_sales 7,200,000 rows; the
              ws_wh self-join takes the partitioned spill), each exact
              against a numpy evaluation over the generator's own
              columns. Q64 at SF10 against the CPU runner and Q95
              streamed at SF30 (SF100 until the recover phase needed
              the time) left the phase when the fuzz and files phases
              needed it; Q64 at SF10 still runs in the cache phase.
10. cache   - the sixth slice, the runner's caches, through CUDA
              runners: streamed Q1 and Q18 at SF10 in the stream phase's
              default session with ``stream_split_cache`` on and a
              split-cache budget sized from the stream phase's staged
              bytes, each run twice (the first fills the cache, the
              second must make no generator call and no cache miss),
              both bit-identical to the stream phase's uncached runs and
              exact against its numpy evaluations; then Q1, Q18 and Q1
              again under a budget of half Q1's batches with the
              host-spill lane on (evictions, spills and restages, the
              same rows); then the plan cache: Q6 at SF1 with two literal
              variants (a miss, then a hit) and a PREPAREd Q6 EXECUTEd
              with three argument sets (all hits), each exact against
              numpy, on a runner with a MemoryPool that holds no
              query-owned byte after any query and whose table-cache
              owner equals the cache's bytes; then TPC-DS Q64 at SF10,
              warm with the plan cache on and off (planning ms, warm s,
              the same rows). Every runner at SF10 and SF100 in every
              phase takes a split-cache budget of half the card's memory
              (printed), and every warm run must make zero cache misses.
11. nested  - the seventh slice, through CUDA runners: N1, a static
              UNNEST of three lineitem columns into the one-hot GROUP BY
              at SF10 in the joins phase's session (179,999,991 expanded
              rows in a 3 x 2^26-row page, exactly one onehot_reduce
              launch per run), then streamed in the stream phase's
              default session (launches equal batches plus bucket merges,
              bit-identical to the whole-table run); N2, array_agg over
              SF10 lineitem grouped by order, unnested again and read by
              cardinality/element_at, and a materialized array_agg over
              SF1 orders; N3, global approx_percentile/min_by/max_by over
              SF10 lineitem; N4, long-decimal filter, GROUP BY and ORDER
              BY at SF10 (decimal(25..30, 2) casts); all exact against
              numpy over the generator's own columns. Then N5: a memory
              table of 1,048,576 rows (arrays, string arrays, maps, rows
              with NULLs) made with numpy from a fixed seed, six queries
              each equal to a Python evaluation and to the CPU runner.
              Every query runs cold then twice warm (bit-identical) and
              prints its warm s, device ms, syncs, peak memory and
              onehot_reduce launches.
12. write   - the ninth slice, through a CUDA runner in the joins
              phase's session with a ``memory`` catalog ``mem``, a
              ``blackhole`` catalog ``bh`` and a MemoryPool: W1 CTAS of
              Q1 over SF10 lineitem and an INSERT of Q1 over SF1 (one
              onehot_reduce launch each), read back exact against numpy
              (a decimal sum above 2^53 moves through the write path's
              Python float as it does in the reference); W2 a working
              table of ten SF1 lineitem columns for the orders whose lines
              come to at least 524,288 rows, Q1 over it cold then twice
              warm (one launch a run, bit-identical warm runs, the staging
              from object arrays timed); W3 INSERT ... SELECT of the next
              131,072-odd rows, W4 UPDATE, W5 DELETE, each count exact and
              Q1 after it exact with exactly one split-cache miss; W6 an
              aggregate materialized view, two ingest deltas of 65,536
              rows merged incrementally (one launch each), equal to the
              direct query and numpy, a REFRESH bit-identical; W7 the
              auto-rewrite (the plan-cache key names the view), the
              staleness gate after a legacy INSERT and
              ``system.runtime.materialized_views``; W8 a blackhole table
              of 2^24 rows as a source and a sink (a scan after the
              INSERT restages it: one miss, the same rows); W9 the drops,
              after which no page of a dropped table is cached and the
              pool holds no query-owned byte. Every statement prints
              its seconds, launches, misses and peak memory.
13. server  - the tenth slice: a ``CoordinatorServer`` and two
              ``WorkerServer``s in this process on the card, each runner
              with its own split cache and pool (40 GiB in all), driven
              over loopback HTTP by ``PrestoTpuClient``: S1 Q1 at SF10
              (each worker batch's partial GROUP BY and each merge task's
              final one launch K1: the one-hot calls must equal the
              batches plus the merges; one worker batch's K1 call held
              against its plain version), rows equal to the stream
              phase's local result; S2 Q3 and Q18 at SF1 in the default
              session (the dynamic-filter summary stage first, a shuffled
              merge) and S3 Q3 with ``join_distribution_type``
              PARTITIONED (both sides shuffled over HTTP), each equal to
              the coordinator's local runner; S4 distributed EXPLAIN
              ANALYZE of Q1 and ``system.runtime.nodes`` listing both
              workers ACTIVE; S5 a graceful drain of one worker, then Q6
              on the other. One line per step: seconds, wire bytes,
              shuffle bytes, K1 launches, stages.
14. serve   - the eleventh slice, the serving plane: one
              ``CoordinatorServer`` on the card with no worker, the
              micro-batch queue (300 ms window, at most 16 a batch), the
              result cache and the ingest lane on a temporary WAL, driven
              over loopback HTTP by one ``PrestoTpuClient`` per statement:
              V1 16 concurrent point lookups over SF1 orders (15 keys, one
              repeated), V2 8 concurrent Q6 EXECUTEs, V3 8 concurrent Q1
              EXECUTEs with shipdate cutoffs from 1992 to 1998 (every
              member served by one batch, exactly one K1 launch through
              its batching rule, held against one plain reduction per lane
              as "q1 microbatch fused", timed beside two bounds and 8 x
              the kernel phase's "q1 fused"), then the same 8 one at a
              time (8 launches; host waits and seconds side by side); V4 the V3
              statements again (all result-cache hits: no launch, no
              dispatch) and a new literal (a miss); V5 8 seeded batches of
              65,536 rows through ``POST /v1/ingest/{table}`` into a memory
              table with an aggregate view (one K1 launch per delta
              merge), the cache's staleness contract, then a second
              coordinator replaying the same WAL. Every answer is exact
              against numpy; one line per step: seconds, batches and
              lanes, cache hits, K1 launches, dispatches, WAL frames.
15. recover - the twelfth slice, fault-tolerant execution, every spool,
              journal and control directory under one temporary
              directory: R1 Q1 at SF1 on a coordinator and two workers
              with ``retry-policy=TASK`` and a shared spool, a
              ``kill_worker`` rule on one worker's second producer task
              (the lost range re-runs on the survivor, K1 launching on
              its batches; the dead worker's merge partition re-runs
              there over its committed producer, re-read from the spool);
              R2 a partitioned Q3 at SF1, the worker killed as its join
              task starts (its join partition re-runs over the spooled
              producer partitions); R3 ``retry_policy=QUERY``, a killed
              worker restarting the whole Q1; R4 4 QUEUED Q1s across a
              coordinator bounce on its journal, 4 paginating clients
              riding it; R5 two coordinators with peers on one control
              directory, ``kill_coordinator`` on one as Q1 is admitted,
              the survivor claiming, resuming and aliasing it. Every
              answer equals the port's local runner; one line per step:
              seconds, seconds from the fault to the last answer, K1
              launches, tasks retried, spool frames and bytes written
              and re-served, restarts, resumed queries, claims.
16. qos     - the thirteenth slice, the QoS plane and the elastic pool,
              every spool, journal and control directory under one
              temporary directory. A coordinator with ``qos.enabled``,
              one admission slot, an ``interactive`` lane (priority 10)
              above a ``batch`` lane (priority 0), ``retry-policy=TASK``
              over a shared spool, and two workers: P1 Q1 at SF10 in the
              batch lane, then 8 concurrent Q6 at SF1 in the interactive
              lane (Q1 suspends at a range boundary, the 8 finish before
              it resumes, it finishes exact with no producer re-run; the
              interactive p50/p99 from ``system.runtime.qos`` beside the
              same burst behind the same Q1 with the plane off); P2 a
              ``suspend_storm`` of 3 against Q1 (exactly 1 suspension);
              P3 ``kill_worker`` on one worker while Q1 is suspended (no
              query fails, the dead producer's committed partitions
              re-served from the spool). P4 a second coordinator with
              ``pool.max-workers=3``, one stable worker and the
              autoscaler over ``LocalWorkerPoolProvider`` under 3
              concurrent clients of Q1 at SF1 (preemptible workers
              spawned on the card show SCALING_UP, then STABLE, and are
              drained when idle, without flapping); P5 back on the
              first, ``kill_worker_preempt`` on a preemptible worker
              during Q1 at SF10 (it drains within
              ``pool.preempt-grace-s``, its ranges reschedule, merges run
              on the stable node only, no query fails). Every answer
              equals the port's local runner; one line per step:
              seconds, suspensions, resumes, producer re-runs, spool
              frames re-served, workers spawned and drained, K1
              launches.
17. distrib - the fourteenth slice's multi-device exchange:
              ``DistributedQueryRunner(devices=[cuda:0] * 4)``, one
              controller over four shards of the one card. D1 TPC-H Q1,
              Q3, Q5 and Q18 at SF10 (lineitem 59,999,997 rows, about 15 M
              and a 2^24-row bucket per shard), each cold then warm: every
              scan row-sharded, the partial and final one-hot GROUP BYs of
              Q1 and Q5 one K1 call per shard each (one shard's partial
              held against its plain version), Q3's and Q5's big joins
              hash-repartitioned (all_to_all), Q18's l_orderkey GROUP BY
              routed by key hash; each result equal to the same statement
              on the single-device runner (the joins and stream phases'
              results; doubles within rel 1e-9), warm bit-identical to
              cold. Per run: seconds, peak memory, host waits, K1
              launches, bytes routed per collective, fragment reads,
              balance retries. Then the largest all_to_all's routing
              passes on their own inputs, device ms by kernel kind. D2
              the dryrun twin, Q3 at tiny over 8 shards of the card. On
              one card no collective copies bytes between cards.
18. ici     - the in-slice (ICI) lane of the server, every node with
              ``exchange.ici-enabled``: I1 Q1 and a partitioned Q3 at
              SF10 on a coordinator and two workers, each with the lane
              off then on (the same rows; with it on, ICI edges, no
              fallback, no HTTP shuffle byte; the bytes elided and both
              walls printed; a merge task's final K1 call over its
              device-merged page held against its plain version: one
              launch, timed beside an empty launch); I2 Q1
              at SF10 with ``exchange.single-program`` off (the
              per-source gather: the same rows, device dispatches per
              stage beside I1's); I5 a third worker announcing another
              slice joins (Q1 and a partitioned Q3 at SF1 ride both lanes
              per edge, the same rows); I3 a worker drained while a
              partitioned Q3 at SF1 runs under ``retry-policy=TASK`` (every
              FINISHED ICI task of it materialized, no query fails); I4 a
              co-located worker killed mid-join (the query completes over
              the spool with the same rows).
19. fuzz    - the port's own differential fuzzer (``fuzz.py``) against
              its own sqlite oracle (``verifier.py``) over tiny: Z1 seeds
              0-199 on a CUDA runner, Z2 seeds 0-59 over four shards of
              the card, Z3 seeds 450-509 under ``max_device_rows`` 8,192,
              where seeds 738, 1335 and 1961 must raise the known
              ``StreamingError`` (no streaming cut, in both packages) and
              nothing else may fail; seed counts, the median seed's
              seconds and the K1 launches.
20. files   - when pyarrow is installed (else one line says the phase
              did not run): F1 SF10 lineitem's Q1 and Q6 columns
              (59,999,997 rows) written to parquet, the write timed
              apart, then Q1 and Q6 over the file, cold then warm, exact
              against numpy (Q1's one-hot call held against its plain
              version); F2 SF1 orders as ORC, a GROUP BY
              o_orderpriority; F3 SF1 lineitem as a hive tree
              partitioned by ``l_shipmode``, where ``IN ('AIR',
              'MAIL')`` reads 2 of the 7 partitions (F2, F3 equal to the
              same queries over tpch.sf1); F4 a coordinator and two
              workers with ``ingest.wal-path`` and ``lakehouse.path``:
              1,000,000 lineitem rows POSTed in 40 commits, a
              Q1-shaped GROUP BY held to numpy, a restart restoring rows
              and snapshot lineage from the manifest tip, FOR VERSION AS
              OF the 20th commit equal to that prefix, a forced
              compaction under that pinned reader, and the table's
              ``system.runtime.snapshots`` row. Files go to a temporary
              directory the phase removes.
21. a ``{"kernels": [...]}`` line (K1, K1 through its batching rule, a
    distributed shard's K1 call, an ICI merge task's and Q1's over the
    parquet file), then ``{"ok": true, "device": ...}``.

It needs a CUDA device and the repository beside it; without either it
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import importlib.util
import json
import os
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


def cache_budget(dev) -> int:
    """The split-cache budget (``staging_cache_bytes``) of the smoke's
    SF10 and SF100 runners: half the card's memory. The reference's
    4 GiB default holds neither SF10 lineitem's columns in their
    2^26-row bucket nor Q64's tables, so warm runs would restage; the
    whole-table phases check that every warm run makes zero cache
    misses."""
    import torch

    from presto_tpu_torch.exec.staging import DEFAULT_CACHE_BYTES

    if dev.type != "cuda":
        return DEFAULT_CACHE_BYTES
    return torch.cuda.get_device_properties(dev).total_memory // 2


def cache_misses(runner) -> int:
    return runner.split_cache.stats()["misses"]


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


@contextlib.contextmanager
def onehot_calls():
    """Records ``(gid, requests, nseg)`` of every ``onehot_reduce_many``
    call made while the block runs; each call still goes to the wrapper,
    which launches and counts as usual. Yields the list."""
    from presto_tpu_torch.ops import aggregation as PA

    seen = []
    real = PA.onehot_reduce_many

    def record(gid, requests, nseg):
        seen.append((gid, list(requests), nseg))
        return real(gid, requests, nseg)

    PA.onehot_reduce_many = record
    try:
        yield seen
    finally:
        PA.onehot_reduce_many = real


def fused_case(label, gid, reqs, nseg, card):
    """Hold ``onehot_reduce_many`` against its plain version on the card:
    exact for integers, within rel 1e-12 (float64) or 1e-5 (float32) of
    each segment's sum of |x| for float sums; check that two launches
    agree bit for bit; count the launches of one call; time it beside
    its bound and a library yardstick the port never calls
    (``index_add_`` over the sum requests' x, ``scatter_reduce_`` over
    the min and max requests' x, stacked as columns, one call per op and
    dtype, in one timed function; held equal to the kernel on the int64
    requests over the segments that hold rows)."""
    import torch

    from presto_tpu_torch.ops.aggregation import (
        onehot_reduce,
        onehot_reduce_many,
        onehot_reduce_many_plain,
        onehot_reduce_plain,
        onehot_results,
    )

    before = onehot_reduce.launches
    out = onehot_reduce_many(gid, reqs, nseg)
    launches = onehot_reduce.launches - before
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
        if op in ("min", "max"):
            # exact, the identity (+-inf) of an empty segment included
            same = (got == exp) | (torch.isnan(got) & torch.isnan(exp))
            check(bool(same.all()), f"{label}: {op} kernel != plain")
            continue
        scale = onehot_reduce_plain(gid, x.abs(), valid, nseg, "sum")
        diff = (got - exp).abs()
        err = max(err, float(diff.max()))
        tol = 1e-12 if got.dtype == torch.float64 else 1e-5
        check(
            bool((diff <= tol * scale).all()),
            f"{label}: float {op} off by {float(diff.max())} (rel {tol})",
        )

    live = (gid >= 0) & (gid < nseg)
    idx = torch.where(live, gid, nseg).to(torch.int64)
    library = library_yardstick(
        label, idx, reqs, nseg, onehot_results(out, reqs))

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
        "launches_per_call": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "bytes": nbytes,
    }
    print(
        f"{label}: ok (K={len(reqs)}, {launches} launch(es) a call, two "
        f"launches bit-identical), "
        f"max_abs_err {err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, library {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{nbytes} B) [{card}]",
        flush=True,
    )
    return rec


def library_yardstick(label, idx, reqs, nseg, got_all):
    """The library call a K1 case is timed beside (the port never calls
    it): ``index_add_`` over the sum requests' x and ``scatter_reduce_``
    over the min and max requests' x, stacked as columns, one call per
    op and dtype, segment ``idx`` in [0, nseg] (nseg: the sink). Held
    equal to the kernel's results ``got_all`` on the int64 requests over
    the segments that hold rows; returns the function to time."""
    import torch

    from presto_tpu_torch.ops.aggregation import _onehot_fill

    # request positions by (op, dtype): one library call per group
    groups = {}
    for k, (op, x, _) in enumerate(reqs):
        if x is not None and op in ("sum", "min", "max"):
            groups.setdefault((op, x.dtype), []).append(k)
    # a masked row takes the op's identity, so it changes nothing
    stacks = {
        (op, dtype): torch.stack([
            reqs[k][1] if reqs[k][2] is None else torch.where(
                reqs[k][2], reqs[k][1], _onehot_fill(op, dtype))
            for k in ks], dim=1)
        for (op, dtype), ks in groups.items()
    }

    def library():
        outs = {}
        for (op, dtype), xs in stacks.items():
            acc = torch.zeros((nseg + 1, xs.shape[1]), dtype=dtype,
                              device=idx.device)
            if op == "sum":
                outs[op, dtype] = acc.index_add_(0, idx, xs)
            else:
                outs[op, dtype] = acc.scatter_reduce_(
                    0, idx[:, None].expand_as(xs), xs,
                    "amin" if op == "min" else "amax", include_self=False)
        return outs

    held = torch.bincount(idx, minlength=nseg + 1)[:nseg] > 0
    for (op, dtype), col in library().items():
        if dtype != torch.int64:
            continue
        for j, k in enumerate(groups[op, dtype]):
            check(torch.equal(col[:nseg, j][held], got_all[k][held]),
                  f"{label}: library {op} disagrees")
    return library


def empty_launch_ms() -> float:
    """Device time of the least launch PyTorch makes on the current
    stream (a one-element fill), timed as every case is: the floor any
    kernel launch pays, beside the small calls' times. The port never
    calls it."""
    import torch

    one = torch.empty(1, dtype=torch.int32, device="cuda")
    return time_ms(one.zero_)


#: the small calls' requests: every op and value type, a third masked
SMALL_OPS = (
    ("count", None), ("sum", "i64"), ("sum", "f64"), ("min", "i64"),
    ("max", "f64"), ("sum", "f32"), ("min", "f32"), ("max", "i64"),
    ("min", "f64"), ("max", "f32"),
)


def small_inputs(rng, n: int, k: int, nseg: int, dev):
    """A small call's gid (a tenth of the rows dead) and ``k`` requests
    cycling through SMALL_OPS, every third with a validity mask."""
    import numpy as np
    import torch

    g = np.where(rng.random(n) < 0.9, rng.integers(0, nseg, n), nseg)
    reqs = []
    for i in range(k):
        op, kind = SMALL_OPS[i % len(SMALL_OPS)]
        valid = None
        if i % 3 == 1:
            valid = torch.from_numpy(rng.random(n) < 0.8).to(dev)
        x = None
        if kind == "i64":
            x = torch.from_numpy(
                rng.integers(-(10 ** 12), 10 ** 12, n, dtype=np.int64))
        elif kind is not None:
            x = torch.from_numpy(rng.standard_normal(n) * 1e3).to(
                torch.float64 if kind == "f64" else torch.float32)
        reqs.append((op, None if x is None else x.to(dev), valid))
    return torch.from_numpy(g.astype(np.int32)).to(dev), reqs


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

    # small calls (an ICI merge's final and its like): K = 19 and 40
    # requests over a few rows to 4,096, each one launch of the direct
    # form, beside the floor an empty launch pays
    floor = empty_launch_ms()
    print(f"empty launch: {floor:.4f} ms, the floor any kernel pays "
          f"[{card}]", flush=True)
    for k in (19, 40):
        for n in (5, 100, 1000, 4096):
            g, reqs = small_inputs(rng, n, k, 6, dev)
            rec = fused_case(f"small k{k} n{n}", g, reqs, 6, card)
            check(rec["launches_per_call"] == 1,
                  f"small k{k} n{n}: {rec['launches_per_call']} launches")
            rec["floor_ms"] = floor
            records.append(rec)
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


def slice_phase(card: str, keep: Optional[dict] = None):
    """Q1 and Q6 at SF1, cold then warm. With ``keep``, the runner and
    the numpy answers stay there for the observe phase."""
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
    misses = cache_misses(runner)
    t0 = time.perf_counter()
    warm = runner.execute(Q1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(cache_misses(runner) == misses,
          "Q1's warm run missed the split cache")
    # Q6 scans other columns: its first run stages them (cold), the
    # second reuses them (warm)
    q6_s = []
    for _ in range(2):
        misses = cache_misses(runner)
        t0 = time.perf_counter()
        q6 = runner.execute(Q6)
        torch.cuda.synchronize()
        q6_s.append(time.perf_counter() - t0)
    check(cache_misses(runner) == misses,
          "Q6's warm run missed the split cache")
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
    if keep is not None:
        keep.update(slice=runner, want_q1=want_q1, want_q6=want_q6)
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
    return numpy_q3(d), numpy_q5(d)


def numpy_q3(d, order_lt: int = Q3_DATE, ship_gt: int = Q3_DATE):
    """Q3's groups with ``o_orderdate < order_lt`` and ``l_shipdate >
    ship_gt`` (epoch days; Q3's own date for both by default)."""
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
    o_ok = (o["o_orderdate"] < order_lt) & cust_building[o["o_custkey"]]
    m3 = o_ok[orow] & (li["l_shipdate"] > ship_gt)
    keys3, inv = np.unique(lk[m3], return_inverse=True)
    rev3 = np.zeros(len(keys3), np.int64)
    np.add.at(rev3, inv, revenue[m3])
    q3 = {
        int(k): (int(r), int(o["o_orderdate"][order_row[k]]),
                 int(o["o_shippriority"][order_row[k]]))
        for k, r in zip(keys3, rev3)
    }
    return q3


def numpy_q5(d):
    """Q5's nation name -> revenue."""
    import numpy as np

    li, o, c = d["lineitem"], d["orders"], d["customer"]
    revenue = li["l_extendedprice"].astype(np.int64) * (
        100 - li["l_discount"].astype(np.int64)
    )
    order_row = _lookup(o["o_orderkey"], np.arange(len(o["o_orderkey"])), -1)
    orow = order_row[li["l_orderkey"].astype(np.int64)]
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
    return q5


def run_timed(runner, sql, dev):
    t0 = time.perf_counter()
    res = runner.execute(sql)
    sync(dev)
    return res, time.perf_counter() - t0


def joins_phase(card: str, dev=None, records=None, keep=None):
    """Q3 and Q5 at the joins phase's scale on ``dev`` (the card unless
    a CPU rehearsal passes another), each cold then twice warm. Returns
    the onehot_reduce launches counted over the phase's query runs. With
    ``keep``, the runner, the generated columns and the numpy answers
    stay there for the observe phase."""
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
        staging_cache_bytes=cache_budget(dev),
    )
    t0 = time.perf_counter()
    n_lineitem, cols = joins_columns()
    want_q3, want_q5 = numpy_q3_q5(cols)
    numpy_s = time.perf_counter() - t0
    if keep is not None:
        keep.update(joins=runner, joins_cols=cols, want_q3=want_q3,
                    want_q5=want_q5, n_lineitem=n_lineitem)
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
        for i in range(3):  # cold, warm, warm
            PA.onehot_reduce.launches = 0
            misses = cache_misses(runner)
            res, secs = run_timed(runner, sql, dev)
            per_run.append(PA.onehot_reduce.launches)
            runs.append((res, secs))
            check(i == 0 or cache_misses(runner) == misses,
                  f"{name}: a warm run missed the split cache")
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
    if keep is not None:
        # the distrib phase holds its distributed runs to these
        keep.update(q3_rows=results["Q3"].rows(),
                    q5_rows=results["Q5"].rows())
    for row in results["Q3"].rows():
        print("Q3 row:", row, flush=True)
    for row in results["Q5"].rows():
        print("Q5 row:", row, flush=True)
    print(f"Q3 without LIMIT: {len(got_all)} groups equal numpy's "
          f"({all_s:.4f} s)", flush=True)

    if records is not None:
        # the one-hot reduction at Q5's own inputs (a run not counted)
        with onehot_calls() as seen:
            runner.execute(Q5)
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

#: BASELINE.json's window configuration (bench.py's window query) over
#: SF1 orders, 1,500,000 rows, whole under the default ``max_device_rows``
#: (2^24); at SF10 (15,000,000 rows) its numpy check alone took 32-36 s
WINDOW_SCHEMA = "sf1"
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
    if any(blk.dtype.is_nested for blk in a.page.blocks):
        # arrays, maps and rows: their decoded rows, doubles exactly
        return None if a.rows() == b.rows() else "nested rows differ"
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


def warm_profile(runner, sql, dev):
    """(``cudaStreamSynchronize`` calls, device ms of its kernels) of one
    warm run under torch.profiler; (None, None) on the CPU: nothing to
    count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        return None, None
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        runner.execute(sql)
        torch.cuda.synchronize(dev)
    events = prof.key_averages()
    syncs = sum(e.count for e in events if e.key == "cudaStreamSynchronize")
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA)
    return syncs, device_us / 1e3


def run_three(runner, name, sql, dev, card, scanned: Optional[int] = None):
    """Cold then twice warm, the launch count reset before each run and
    read after it; the warm runs must agree bit for bit. ``scanned``: the
    rows a warm rate is given for. Returns (the first warm result, its
    record)."""
    import torch

    from presto_tpu_torch.ops import aggregation as PA

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runs, per_run, misses = [], [], []
    for _ in range(3):
        PA.onehot_reduce.launches = 0
        before = cache_misses(runner)
        runs.append(run_timed(runner, sql, dev))
        per_run.append(PA.onehot_reduce.launches)
        misses.append(cache_misses(runner) - before)
    check(misses[1:] == [0, 0],
          f"{name}: warm runs missed the split cache ({misses})")
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
        "onehot_reduce_launches": per_run,
        "cache_misses": misses,
    }
    rec["syncs_per_warm_run"], rec["device_ms"] = warm_profile(
        runner, sql, dev)
    rate = (f", {rec['rows_per_s']:.1f} rows/s of {scanned} scanned"
            if scanned else "")
    print(
        f"{name}: {rec['rows']} rows; cold_s {cold_s:.4f}, warm_s "
        f"{w1_s:.4f} / {w2_s:.4f}{rate}, peak memory "
        f"{'not measured (no card)' if peak is None else f'{peak:.3f} GiB'}"
        f", cudaStreamSynchronize per warm run "
        f"{rec['syncs_per_warm_run']}, device ms of a warm run "
        f"{rec['device_ms']}, onehot_reduce launches per run "
        f"{per_run}, split-cache misses per run {misses} [{card}]",
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
    passes another): the window query at SF1 and Q9/Q22 at SF10, exact
    against numpy; Q2/Q7/Q8/Q13/Q14/Q16/Q20 at SF1 against the port's
    CPU runner. Each query runs cold then twice warm. Returns (the
    onehot_reduce launches of the phase's counted runs, the records)."""
    import torch

    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.session import Session

    dev = torch.device("cuda") if dev is None else dev
    queries = tpch_queries()
    t0 = time.perf_counter()
    d = rest_columns(JOINS_SCHEMA)
    window_orders = rest_columns(WINDOW_SCHEMA)["orders"]
    n_orders, n_lineitem = len(window_orders["o_orderkey"]), len(
        d["lineitem"]["l_orderkey"])
    want_q9 = numpy_q9(d)
    want_q22 = {name: numpy_q22(d, name == "Q22")
                for name in ("Q22", "Q22 without not exists")}
    print(f"numpy evaluation of Q9/Q22 at {JOINS_SCHEMA}: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    launches, records = 0, []

    # the window configuration, default session
    runner = LocalQueryRunner(device=dev,
                              staging_cache_bytes=cache_budget(dev))
    res, rec = run_three(runner, "window", WINDOW, dev, card, n_orders)
    launches += sum(rec["onehot_reduce_launches"])
    t0 = time.perf_counter()
    check_window(res, window_orders)
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
        staging_cache_bytes=cache_budget(dev),
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
#: (``max_device_rows`` 2^24, batches of 2^20), and the large Q18 at
#: ``STREAM_BIG`` (a CPU rehearsal at a small scale sets smaller budgets
#: here). The large run was at SF100, then SF30 (51.10 s and 7.73 s of
#: numpy in the smoke of PR 16's run 2), cut to make room for the later
#: phases; its budget keeps the SF100 run's shape at SF10: lineitem's
#: 59,999,997 rows and orders' 15,000,000 both exceed it, so the outer
#: join's build side takes the partitioned spill
STREAM_SF10_PROPS: dict = {}
STREAM_BIG = "sf10"
STREAM_BIG_PROPS = {"max_device_rows": 1 << 23, "page_capacity": 1 << 22}
#: tpch scales the connector names no schema for
TPCH_SCALES: dict = {}
#: chip_profile.py's SF100 session (Q95 at SF100): the joins phase's
#: budget with batches of 2^24
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
        # the first switch to the warning mode in a process warns once
        # by itself: switch once before counting
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(0)
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


def stream_run(runner, sql, dev, label, card, scanned, batches_expected,
               served_from_cache: bool = False):
    """One streamed run with the launch counts, the native generator's
    calls and the stream counters reset just before and read just after;
    returns (result, record). ``batches_expected`` None: any number of
    batches but at least one. On the card the generator must have run
    its C++ loop, unless the split cache serves the run
    (``served_from_cache``: the caller checks that it made no call). A
    run labelled warm must make no split-cache miss."""
    import torch

    from presto_tpu_torch import native
    from presto_tpu_torch.exec.streaming import StreamStats
    from presto_tpu_torch.ops import aggregation as PA

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runner.stream_stats = StreamStats()
    retries = runner.overflow_retries
    misses = cache_misses(runner)
    PA.onehot_reduce.launches = 0
    native.gen_uniform.calls = 0
    with counting_syncs(dev) as syncs:
        res, secs = run_timed(runner, sql, dev)
    launches = PA.onehot_reduce.launches
    gen_calls = native.gen_uniform.calls
    misses = cache_misses(runner) - misses
    st = runner.stream_stats
    if batches_expected is None:
        check(st.batches > 0, f"{label}: nothing streamed")
    else:
        check(st.batches == batches_expected,
              f"{label}: {st.batches} batches, expected {batches_expected}")
    check(st.buckets > 0, f"{label}: no spill bucket ran")
    if not served_from_cache:
        check(dev.type != "cuda" or gen_calls > 0,
              f"{label}: the generator never ran its native loop")
    check("warm" not in label or misses == 0,
          f"{label}: the warm run missed the split cache {misses} times")
    rec = {
        "query": label, "rows": int(res.page.num_valid), "s": secs,
        "rows_per_s": scanned / secs, "batches": st.batches,
        "empty_batches": st.empty_batches, "buckets": st.buckets,
        "spilled_rows": st.spilled_rows, "spilled_bytes": st.spilled_bytes,
        "retries": runner.overflow_retries - retries,
        "syncs": syncs[0],
        "syncs_per_batch": None if syncs[0] is None else syncs[0] / st.batches,
        "onehot_reduce_launches": launches,
        "native_gen_calls": gen_calls,
        "cache_misses": misses,
        "staged_bytes": st.staged_bytes,
        "largest_merge_rows": st.largest_merge_rows,
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
          f"{rec['rows_per_s']:.1f} rows/s of the {scanned} scanned; batches "
          f"{st.batches} "
          f"({st.empty_batches} empty), buckets {st.buckets}, spilled "
          f"{st.spilled_rows} rows / {st.spilled_bytes} bytes, retries "
          f"{rec['retries']}, host syncs {syncs[0]}, onehot_reduce launches "
          f"{launches}, native generator calls {gen_calls}, split-cache "
          f"misses {misses}, staged {st.staged_bytes} bytes, largest merged "
          f"join result {st.largest_merge_rows} rows, peak memory {peak}, "
          f"peak RSS "
          f"{rec['peak_rss_gib']:.3f} GiB; host s {rec['host_s']} [{card}]",
          flush=True)
    return res, rec


def check_q1_stream(label, res, want_q1):
    """Q1's groups against numpy's: sums and counts exact, the averages
    within rel 1e-12."""
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


def stream_phase(card: str, dev=None, records=None, big: str = STREAM_BIG):
    """The fourth slice's path on ``dev`` (the card unless a CPU
    rehearsal passes another): streamed Q1 and Q18 at SF10 under the
    default session, then Q18 at ``big`` once. Returns (the
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
        schema=JOINS_SCHEMA, properties=STREAM_SF10_PROPS),
        staging_cache_bytes=cache_budget(dev))
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
        check_q1_stream(label, res, want_q1)
        q1_runs.append(res)
        out.append(rec)
    diff = results_differ(*q1_runs)
    check(diff is None, f"Q1 stream: cold and warm differ ({diff})")
    # what the cache phase holds its cached runs to
    baseline = {"Q1": (want_q1, q1_runs[1], out[-1]["staged_bytes"])}
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
        schema=JOINS_SCHEMA, properties=STREAM_SF10_PROPS),
        staging_cache_bytes=cache_budget(dev))
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
        if label == "Q18 stream warm":
            # its whole tables (orders, customer) stay in the cache
            baseline["Q18"] = (want18, res, rec["staged_bytes"],
                               runner.split_cache.used_bytes())
        out.append(rec)
    # the serial loop (no prefetch thread) gives the same bits
    serial = LocalQueryRunner(device=dev, session=Session(
        schema=JOINS_SCHEMA,
        properties={**STREAM_SF10_PROPS, "staging_prefetch_depth": 0}),
        staging_cache_bytes=cache_budget(dev))
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

    # Q18 at the large scale: lineitem and orders both over the budget,
    # once
    for name, scale in TPCH_SCALES.items():
        SCHEMAS.setdefault(name, scale)
    t0 = time.perf_counter()
    n_li, want18 = numpy_q18(big)
    print(f"numpy evaluation of Q18 at {big}: {len(want18)} orders over "
          f"300 ({time.perf_counter() - t0:.2f} s)", flush=True)
    runner = LocalQueryRunner(device=dev, session=Session(
        schema=big, properties=STREAM_BIG_PROPS),
        staging_cache_bytes=cache_budget(dev))
    n_orders = TpchGenerator(SCHEMAS[big]).counts["orders"]
    batch = STREAM_BIG_PROPS["page_capacity"]
    # the subquery's pass over lineitem, then both join sides' passes
    want_batches = 2 * n_batches(n_li, batch) + n_batches(n_orders, batch)
    res, rec = stream_run(runner, q18, dev, f"Q18 stream {big}", card,
                          n_li, want_batches)
    launches += rec["onehot_reduce_launches"]
    check_q18("Q18 stream " + big, res, want18, 100)
    out.append(rec)
    print(f"Q18 {big}: the top 100 of {len(want18)} orders equal numpy's",
          flush=True)
    return launches, out, baseline


# ------------------------------------------------------------- tpcds phase

#: the tpcds phase's scales (a CPU rehearsal passes smaller ones). Q95's
#: streamed run is at SF10 alone: its large run went from SF100 (88-105
#: s) to SF30, then, with Q64's SF10 run, out of the phase to keep the
#: smoke inside its budget (Q64 at SF10 still runs in the cache phase)
TPCDS_SF1, TPCDS_SF10 = "sf1", "sf10"
#: web_sales has 7.2 M rows at SF10: this budget streams it
Q95_STREAM_SF10_PROPS = {"max_device_rows": 1 << 22}
#: Q95's ship-date window: date '1999-02-01' and 60 days on, epoch days
Q95_FROM = 10623
Q95_TO = Q95_FROM + 60
Q95_COLUMNS = ("order_count", "total_shipping_cost", "total_net_profit")


def tpcds_queries(schema: str):
    """(Q64, Q95) of the port's TPC-DS corpus over tpcds.``schema``."""
    from presto_tpu_torch.queries_tpcds import queries_for

    q64, q95, _ = queries_for(schema)
    return q64, q95


def numpy_q95(schema: str):
    """Q95 over tpcds.``schema`` in numpy, from the generator's own
    columns: (count of distinct orders, sum of ws_ext_ship_cost, sum of
    ws_net_profit), the sums as unscaled int64. An order is in ws_wh
    when its lines carry two different warehouses; the generator keeps
    an order's lines in neighbouring rows, 1..4 lines per order in
    cycles of 10 rows, so each chunk of whole cycles holds whole orders.
    Every column read here is NULL-free (checked), so NULL never
    decides a comparison."""
    import numpy as np

    from presto_tpu_torch.connectors.tpcds import SCHEMAS, TpcdsGenerator

    gen = TpcdsGenerator(SCHEMAS[schema])
    cnt = gen.counts

    def table(name, cols):
        d = gen.generate(name, 0, cnt[name], cols)
        check(all(isinstance(v, np.ndarray) or v.ids.min() >= 0
                  for v in d.values()), f"{name}: a NULL in {cols}")
        return d

    def decoded(col):
        return col.values[col.ids].astype(str)

    dd = table("date_dim", ["d_date_sk", "d_date"])
    in_window = _lookup(dd["d_date_sk"], (dd["d_date"] >= Q95_FROM)
                        & (dd["d_date"] <= Q95_TO), False)
    ca = table("customer_address", ["ca_address_sk", "ca_state"])
    il = _lookup(ca["ca_address_sk"], decoded(ca["ca_state"]) == "IL", False)
    ws = table("web_site", ["web_site_sk", "web_company_name"])
    pri = _lookup(ws["web_site_sk"], decoded(ws["web_company_name"]) == "pri",
                  False)
    cols = ["ws_order_number", "ws_warehouse_sk", "ws_ship_date_sk",
            "ws_ship_addr_sk", "ws_web_site_sk", "ws_ext_ship_cost",
            "ws_net_profit"]

    def part(lo, hi):
        d = gen.generate("web_sales", lo, hi, cols)
        check(all(isinstance(v, np.ndarray) for v in d.values()),
              "web_sales: a column with NULLs")
        order, wh = d["ws_order_number"], d["ws_warehouse_sk"]
        starts = np.flatnonzero(np.r_[True, order[1:] != order[:-1]])
        lines = np.diff(np.r_[starts, len(order)])
        mixed = np.repeat(np.maximum.reduceat(wh, starts)
                          != np.minimum.reduceat(wh, starts), lines)
        keep = (mixed & in_window[d["ws_ship_date_sk"]]
                & il[d["ws_ship_addr_sk"]] & pri[d["ws_web_site_sk"]])
        return (order[keep], d["ws_ext_ship_cost"][keep].astype(np.int64),
                d["ws_net_profit"][keep].astype(np.int64))

    def returned(lo, hi):
        wr = gen.generate("web_returns", lo, hi, ["wr_order_number"])
        check(isinstance(wr["wr_order_number"], np.ndarray),
              "web_returns: wr_order_number with NULLs")
        return np.unique(wr["wr_order_number"])

    chunk = 10 * 400_000  # whole cycles of 10 rows
    order, cost, profit = (np.concatenate(a) for a in zip(*parallel_chunks(
        cnt["web_sales"], chunk, part)))
    wr = np.unique(np.concatenate(parallel_chunks(
        cnt["web_returns"], chunk, returned)))
    keep = np.isin(order, wr)
    return (len(np.unique(order[keep])), int(cost[keep].sum()),
            int(profit[keep].sum()))


def check_q95(label, res, want):
    got = result_rows(res, Q95_COLUMNS)
    check(got == [want], f"{label}: {got} != numpy {[want]}")
    check(want[0] > 0, f"{label}: numpy selects no order")


def tpcds_phase(card: str, dev=None, sf1: str = TPCDS_SF1,
                sf10: str = TPCDS_SF10):
    """The fifth slice's path on ``dev`` (the card unless a CPU
    rehearsal passes another): TPC-DS Q64 and Q95 at ``sf1`` against
    the port's CPU runner; Q95 at ``sf10`` whole-table and streamed,
    each exact against numpy. Returns (the onehot_reduce launches of
    the counted runs, the records)."""
    import torch

    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.session import Session

    dev = torch.device("cuda") if dev is None else dev
    joins = {"max_device_rows": JOINS_MAX_DEVICE_ROWS}
    out, launches = [], 0

    def against_cpu(label, res, schema, sql):
        cpu = LocalQueryRunner(device="cpu", session=Session(
            schema=schema, properties=joins))
        t0 = time.perf_counter()
        want = cpu.execute(sql)
        cpu_s = time.perf_counter() - t0
        diff = results_differ(res, want, rel=1e-9)
        check(diff is None, f"{label}: the card and the CPU runner differ "
              f"({diff})")
        print(f"{label}: equal to the CPU runner ({int(want.page.num_valid)} "
              f"rows; the CPU run took {cpu_s:.2f} s)", flush=True)
        return cpu_s

    # SF1: Q64 and Q95 in the joins session, against the CPU runner
    runner = LocalQueryRunner(device=dev, session=Session(
        schema=sf1, properties=joins))
    for name, sql in zip(("Q64", "Q95"), tpcds_queries(sf1)):
        res, rec = run_three(runner, f"{name} {sf1}", sql, dev, card)
        check(rec["rows"] > 0, f"{name} {sf1}: no row")
        rec["cpu_s"] = against_cpu(f"{name} {sf1}", res, sf1, sql)
        launches += sum(rec["onehot_reduce_launches"])
        out.append(rec)
    del runner

    # SF10, whole tables in the joins session: Q95
    q95 = tpcds_queries(sf10)[1]
    runner = LocalQueryRunner(device=dev, session=Session(
        schema=sf10, properties=joins), staging_cache_bytes=cache_budget(dev))
    t0 = time.perf_counter()
    want = numpy_q95(sf10)
    print(f"numpy evaluation of Q95 at {sf10}: {want} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    res, rec = run_three(runner, f"Q95 {sf10}", q95, dev, card)
    check_q95(f"Q95 {sf10}", res, want)
    launches += sum(rec["onehot_reduce_launches"])
    out.append(rec)
    del runner, res

    # Q95 at SF10 streamed: web_sales over a 2^22-row budget
    from presto_tpu_torch.connectors.tpcds import SCHEMAS, TpcdsGenerator

    streamed = LocalQueryRunner(device=dev, session=Session(
        schema=sf10, properties=Q95_STREAM_SF10_PROPS),
        staging_cache_bytes=cache_budget(dev))
    n_ws = TpcdsGenerator(SCHEMAS[sf10]).counts["web_sales"]
    res, rec = stream_run(streamed, q95, dev, f"Q95 stream {sf10}", card,
                          n_ws, None)
    check_q95(f"Q95 stream {sf10}", res, want)
    launches += rec["onehot_reduce_launches"]
    out.append(rec)
    print(f"Q95 {sf10} (whole and streamed) equals numpy's", flush=True)
    return launches, out


# ------------------------------------------------------------- cache phase

#: TPC-H Q6 with every comparison operand a bare literal, so the plan
#: cache hoists them all: (shipdate from, shipdate to, discount low,
#: discount high, quantity below)
Q6_SHAPE = """
select sum(l_extendedprice * l_discount) as revenue
from tpch.{schema}.lineitem
where l_shipdate >= {} and l_shipdate < {}
  and l_discount between {} and {} and l_quantity < {}
"""
Q6_VARIANTS = [
    ("1994-01-01", "1995-01-01", "0.05", "0.07", "24"),
    ("1995-01-01", "1996-01-01", "0.04", "0.06", "25"),
]
Q6_EXECUTE = [
    ("1993-01-01", "1994-01-01", "0.06", "0.08", "20"),
    ("1996-01-01", "1997-01-01", "0.02", "0.04", "30"),
    ("1997-06-01", "1998-06-01", "0.01", "0.09", "12"),
]


def q6_sql(schema, args):
    d0, d1, lo, hi, q = args
    return Q6_SHAPE.format(f"date '{d0}'", f"date '{d1}'", lo, hi, q,
                           schema=schema)


def numpy_q6(args) -> int:
    """Q6's revenue for one argument set over the SF1 columns the slice
    phase checks, as the unscaled decimal(?, 4) the port returns."""
    return numpy_q6_of(sf1_lineitem(), args)


def numpy_q6_of(d, args) -> int:
    """Q6's revenue for one argument set over the lineitem columns
    ``d``, as the unscaled decimal(?, 4) the port returns."""
    import datetime

    import numpy as np

    d0, d1, lo, hi, q = args
    epoch = datetime.date(1970, 1, 1)

    def days(s):
        return (datetime.date.fromisoformat(s) - epoch).days

    qty = d["l_quantity"].astype(np.int64)
    price = d["l_extendedprice"].astype(np.int64)
    disc = d["l_discount"].astype(np.int64)
    ship = d["l_shipdate"].astype(np.int64)
    m = ((ship >= days(d0)) & (ship < days(d1))
         & (disc >= round(float(lo) * 100)) & (disc <= round(float(hi) * 100))
         & (qty < int(q) * 100))
    return int((price[m] * disc[m]).sum())


def check_pool(label, runner, pool):
    """No query-owned bytes outlive a query, and the pool's table-cache
    owner holds exactly the cache's bytes."""
    used = pool.snapshot()["used"]
    check(set(used) <= {"table-cache"},
          f"{label}: query-owned bytes remain in the pool: {used}")
    check(used.get("table-cache", 0) == runner.split_cache.used_bytes(),
          f"{label}: the pool's table-cache owner holds "
          f"{used.get('table-cache', 0)}, the cache "
          f"{runner.split_cache.used_bytes()}")


def cache_phase(card: str, baseline, dev=None, schema: str = JOINS_SCHEMA,
                q6_schema: str = "sf1", tpcds_schema: str = TPCDS_SF10):
    """The sixth slice's path on ``dev`` (the card unless a CPU rehearsal
    passes another): the split cache under streamed Q1 and Q18 at
    ``schema`` (filled, then warm; then under a budget smaller than the
    working set with the host-spill lane on), the plan cache on Q6 at
    ``q6_schema`` (literal variants, PREPARE/EXECUTE) and on Q64 at
    ``tpcds_schema`` (warm with the cache on and off), and the memory
    pool's accounting. ``baseline``: the stream phase's uncached Q1 and
    Q18 (numpy's rows, the result, its staged bytes). Returns (the
    onehot_reduce launches of the counted runs, the records)."""
    import torch

    from presto_tpu_torch.connectors.tpch import SCHEMAS, TpchGenerator
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.session import Session
    from presto_tpu_torch.utils.memory import MemoryPool

    dev = torch.device("cuda") if dev is None else dev
    on_card = dev.type == "cuda"
    out, launches = [], 0
    want_q1, plain_q1, q1_staged = baseline["Q1"]
    want18, plain_q18, q18_staged, q18_tables = baseline["Q18"]
    q18, _ = stream_q18()
    n_li = TpchGenerator(SCHEMAS[schema]).counts["lineitem"]
    props = {**STREAM_SF10_PROPS, "stream_split_cache": True}
    batch = int(Session(properties=props).get("page_capacity"))
    per_pass = -(-n_li // batch)
    queries = (
        ("Q1", stream_q1(), per_pass, plain_q1,
         lambda label, res: check_q1_stream(label, res, want_q1)),
        ("Q18", q18, 2 * per_pass, plain_q18,
         lambda label, res: check_q18(label, res, want18, 100)),
    )

    def cached_run(runner, name, sql, batches, plain, check_rows, run):
        before = runner.split_cache.stats()
        res, rec = stream_run(runner, sql, dev,
                              f"{name} stream cached {run} {schema}", card,
                              n_li, batches,
                              served_from_cache=(run == "warm"))
        st = runner.split_cache.stats()
        rec["cache"] = {k: st[k] - before[k] for k in (
            "hits", "misses", "evictions", "spills", "restages")}
        rec["cache"]["bytes"] = st["bytes"]
        rec["cache"]["spill_bytes"] = st["spill_bytes"]
        diff = results_differ(res, plain)
        check(diff is None, f"{name} cached {run}: not bit-identical to the "
              f"uncached run ({diff})")
        check_rows(f"{name} cached {run}", res)
        print(f"cache: {name} {schema} {run}: wall s {rec['s']:.4f}, "
              f"generation s {rec['host_s']['generate']:.4f}, staging s "
              f"{rec['host_s']['stage']:.4f}, native generator calls "
              f"{rec['native_gen_calls']}, cache {rec['cache']} [{card}]",
              flush=True)
        out.append(rec)
        return rec

    # (1) the split cache holds both queries' batches: fill, then warm
    budget = q1_staged + q18_staged + q18_tables
    print(f"cache: streamed split-cache budget {budget} bytes = Q1's "
          f"{q1_staged} + Q18's {q18_staged} staged split bytes + Q18's "
          f"{q18_tables} whole-table bytes (the stream phase's uncached "
          f"runs) [{card}]", flush=True)
    runner = LocalQueryRunner(device=dev, session=Session(
        schema=schema, properties=props), staging_cache_bytes=budget)
    for name, sql, batches, plain, check_rows in queries:
        fill = cached_run(runner, name, sql, batches, plain, check_rows,
                          "fill")
        warm = cached_run(runner, name, sql, batches, plain, check_rows,
                          "warm")
        launches += fill["onehot_reduce_launches"]
        launches += warm["onehot_reduce_launches"]
        check(warm["native_gen_calls"] == 0,
              f"{name} cached warm: {warm['native_gen_calls']} generator "
              "calls")
        check(warm["cache"]["misses"] == 0 and warm["cache"]["hits"] > 0,
              f"{name} cached warm: {warm['cache']}")
        check(fill["cache"]["evictions"] == 0,
              f"{name}: the budget did not hold the batches")
    del runner

    # (2) a budget smaller than the working set, the host-spill lane on:
    # Q18's batches push Q1's out to host RAM, Q1 again restages them
    total = (torch.cuda.get_device_properties(dev).total_memory
             if on_card else 1 << 40)
    pool = MemoryPool(total)
    small = q1_staged // 2
    runner = LocalQueryRunner(device=dev, session=Session(
        schema=schema, properties=props), memory_pool=pool,
        staging_cache_bytes=small)
    runner.split_cache.set_spill_budget(q1_staged + q18_staged)
    print(f"cache: spill runs under a {small}-byte budget with a "
          f"{q1_staged + q18_staged}-byte host spill store [{card}]",
          flush=True)
    for (name, sql, batches, plain, check_rows), run in (
        (queries[0], "over budget"), (queries[1], "over budget"),
        (queries[0], "restaged"),
    ):
        rec = cached_run(runner, name, sql, batches, plain, check_rows, run)
        launches += rec["onehot_reduce_launches"]
        check_pool(f"{name} {run}", runner, pool)
        check(runner.split_cache.used_bytes() <= small,
              f"{name} {run}: the cache holds more than its budget")
    st = runner.split_cache.stats()
    check(st["evictions"] > 0 and st["spills"] > 0 and st["restages"] > 0,
          f"the spill runs showed no eviction, spill or restage: {st}")
    spilled = runner.history.snapshot()[-1].spilled_bytes
    check(spilled > 0, "the restaged run paid no restage bytes")
    print(f"cache: spill lane {st}, the last run restaged {spilled} bytes "
          f"[{card}]", flush=True)
    del runner

    # (3) the plan cache on Q6: two literal variants (a miss, then a
    # hit), then PREPARE and three EXECUTEs (all hits), each exact
    # against numpy; the runner's pool holds no query-owned byte after
    # any query
    pool = MemoryPool(total)
    runner = LocalQueryRunner(device=dev, memory_pool=pool)
    plan_rec = {"q6_planning_ms": [], "execute_ms": [],
                "execute_planning_ms": []}
    for i, args in enumerate(Q6_VARIANTS):
        hits = runner.plan_cache.stats()["hits"]
        res, secs = run_timed(runner, q6_sql(q6_schema, args), dev)
        qs = runner.history.snapshot()[-1]
        check(qs.plan_cache_hit == (i > 0) and
              runner.plan_cache.stats()["hits"] == hits + (i > 0),
              f"Q6 variant {i}: plan-cache hit {qs.plan_cache_hit}")
        _, cols = result_columns(res)
        check(int(cols["revenue"][0]) == numpy_q6(args),
              f"Q6 variant {args}: {cols['revenue']} != numpy")
        check_pool(f"Q6 variant {i}", runner, pool)
        plan_rec["q6_planning_ms"].append(qs.planning_ms + qs.optimization_ms)
        print(f"cache: Q6 {q6_schema} {args}: plan-cache "
              f"{'hit' if i else 'miss'}, planning ms "
              f"{qs.planning_ms + qs.optimization_ms:.3f}, wall s "
              f"{secs:.4f} [{card}]", flush=True)
    prepare = "prepare q6p from " + Q6_SHAPE.format(
        "?", "?", "?", "?", "?", schema=q6_schema)
    check(runner.execute(prepare).rows() == [("PREPARE",)], "PREPARE")
    for args in Q6_EXECUTE:
        d0, d1, lo, hi, q = args
        hits = runner.plan_cache.stats()["hits"]
        res, secs = run_timed(
            runner, f"execute q6p using date '{d0}', date '{d1}', {lo}, "
            f"{hi}, {q}", dev)
        qs = runner.history.snapshot()[-1]
        check(runner.plan_cache.stats()["hits"] == hits + 1
              and qs.plan_cache_hit,
              f"EXECUTE {args} was not a plan-cache hit")
        _, cols = result_columns(res)
        check(int(cols["revenue"][0]) == numpy_q6(args),
              f"EXECUTE {args}: {cols['revenue']} != numpy")
        check_pool(f"EXECUTE {args}", runner, pool)
        plan_rec["execute_ms"].append(secs * 1e3)
        plan_rec["execute_planning_ms"].append(qs.planning_ms)
        print(f"cache: EXECUTE q6p {args}: plan-cache hit, planning ms "
              f"{qs.planning_ms:.3f}, wall s {secs:.4f} [{card}]",
              flush=True)
    check(runner.literal_form_reruns == 0, "a literal-form re-run")
    del runner

    # (4) Q64 warm with the plan cache on and off
    q64, _ = tpcds_queries(tpcds_schema)
    runner = LocalQueryRunner(device=dev, session=Session(
        schema=tpcds_schema,
        properties={"max_device_rows": JOINS_MAX_DEVICE_ROWS}),
        staging_cache_bytes=cache_budget(dev))
    first, cold_s = run_timed(runner, q64, dev)
    q64_rec = {"cold_s": cold_s}
    for mode in ("on", "off", "on", "off"):
        runner.session.set("enable_plan_cache", mode == "on")
        misses = cache_misses(runner)
        res, secs = run_timed(runner, q64, dev)
        qs = runner.history.snapshot()[-1]
        check(cache_misses(runner) == misses, "Q64 warm: a split-cache miss")
        check(qs.plan_cache_hit == (mode == "on"),
              f"Q64 cache {mode}: plan-cache hit {qs.plan_cache_hit}")
        diff = results_differ(res, first)
        check(diff is None, f"Q64 cache {mode}: the result differs ({diff})")
        plan_ms = qs.planning_ms + qs.optimization_ms
        q64_rec.setdefault(mode, []).append(
            {"plan_ms": plan_ms, "warm_s": secs})
        print(f"cache: Q64 {tpcds_schema} warm, plan cache {mode}: "
              f"planning ms {plan_ms:.3f} (plan {qs.planning_ms:.3f} + "
              f"optimize {qs.optimization_ms:.3f}), warm s {secs:.4f} "
              f"[{card}]", flush=True)
    check(runner.literal_form_reruns == 0, "a literal-form re-run")
    plan_rec["q64"] = q64_rec
    out.append(plan_rec)
    return launches, out


# ------------------------------------------------------------- nested phase

#: the nested phase's scales (a CPU rehearsal passes smaller ones): the
#: SF10 queries run in the joins phase's session, N2's materialized
#: arrays over SF1 orders, N5 over a memory table of this many rows
NESTED_SF10 = JOINS_SCHEMA
NESTED_SF1 = "sf1"
N5_ROWS = 1 << 20
N5_SEED = 7
#: N5's string vocabulary: 16 words
N5_WORDS = [f"w{i:02d}" for i in range(16)]

N1 = """
select l_returnflag, l_linestatus, count(*) as n, sum(u.v) as s
from lineitem cross join unnest(array[l_quantity, l_discount, l_tax]) as u(v)
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""
N2_UNNEST = """
select count(*) as n, sum(e) as s
from (select l_orderkey, array_agg(l_partkey) as a from lineitem
      group by l_orderkey) t
cross join unnest(a) as u(e)
"""
N2_CARDINALITY = """
select count(*) as n, sum(cardinality(a)) as c, sum(element_at(a, 1)) as f,
  max(cardinality(a)) as m
from (select l_orderkey, array_agg(l_linenumber) as a from lineitem
      group by l_orderkey) t
"""
N2_ORDERS = """
select o_custkey, array_agg(o_orderkey) as a from tpch.{sf1}.orders
group by o_custkey
"""
N3 = """
select approx_percentile(l_extendedprice, 0.5) as p50,
  approx_percentile(l_quantity, 0.9) as q90,
  min_by(l_orderkey, l_extendedprice) as lo,
  max_by(l_orderkey, l_extendedprice) as hi
from lineitem
"""
#: N4's filter threshold, 50000.05 unscaled at scale 2
N4_THRESHOLD = 5_000_005
N4_FILTER = """
select count(*) as n from lineitem
where cast(l_extendedprice as decimal(30,2))
  + cast(l_tax as decimal(30,2)) > 50000.05
"""
# the TopNs sit in subqueries, so the sort runs on the card and the host
# stage orders only their 100 rows
N4_GROUP = """
select p, n from (
  select cast(l_extendedprice as decimal(25,2)) as p, count(*) as n
  from lineitem group by 1 order by n desc, p limit 100) s
order by n desc, p
"""
N4_ORDER = """
select l_orderkey, l_linenumber, v from (
  select l_orderkey, l_linenumber,
    cast(l_extendedprice as decimal(30,2))
      - cast(l_discount as decimal(30,2)) as v
  from lineitem order by v desc, l_orderkey, l_linenumber limit 100) s
order by v desc, l_orderkey, l_linenumber
"""
N5_QUERIES = {
    "N5 arrays": (
        "select count(*) as n, sum(cardinality(arr)) as c, "
        "sum(element_at(arr, 1)) as first, sum(arr[2]) as second, "
        "sum(element_at(arr, -1)) as last from mem.n5.t"
    ),
    "N5 maps": (
        "select count(*) as n, sum(m['w03']) as s, "
        "sum(cardinality(m)) as c, count(element_at(m, 'w11')) as k "
        "from mem.n5.t"
    ),
    "N5 rows": (
        "select count(*) as n, sum(r.x) as sx, sum(r.y) as sy "
        "from mem.n5.t where r.x > 0"
    ),
    "N5 unnest group": (
        "select e, count(*) as n, sum(id) as s from mem.n5.t "
        "cross join unnest(arr) as u(e) group by e order by e"
    ),
    "N5 unnest tags": (
        "select t, count(*) as n from mem.n5.t "
        "cross join unnest(tags) as u(t) group by t order by t"
    ),
    "N5 materialized": (
        "select id, arr, tags, m, r from mem.n5.t "
        "where id % 65536 = 7 order by id"
    ),
}


def numpy_nested(schema: str):
    """The generator's own lineitem columns at ``schema`` and the N1-N4
    answers over them, in numpy: exact int64 at scale 2, order
    statistics at rank ceil(p * n) - 1 of a stable sort."""
    import math

    import numpy as np

    from presto_tpu_torch.connectors.tpch import SCHEMAS, TpchGenerator

    gen = TpchGenerator(SCHEMAS[schema])
    n = gen.counts["lineitem"]
    cols = ["l_orderkey", "l_partkey", "l_linenumber", "l_quantity",
            "l_discount", "l_tax", "l_extendedprice", "l_returnflag",
            "l_linestatus"]
    ints = cols[:7]

    def part(lo, hi):
        g = gen.generate("lineitem", lo, hi, cols)
        rf, ls = g["l_returnflag"], g["l_linestatus"]
        s = sum(g[c].astype(np.int64) for c in ("l_quantity", "l_discount",
                                               "l_tax"))
        n1 = {}
        for i, f in enumerate(rf.values):
            for j, st in enumerate(ls.values):
                m = (rf.ids == i) & (ls.ids == j)
                if m.any():
                    n1[(str(f), str(st))] = (3 * int(m.sum()), int(s[m].sum()))
        return n1, {c: g[c].astype(np.int64) for c in ints}

    parts = parallel_chunks(n, 1 << 22, part)
    n1 = {}
    for p, _ in parts:
        for k, (c, v) in p.items():
            c0, v0 = n1.get(k, (0, 0))
            n1[k] = (c0 + c, v0 + v)
    d = {c: np.concatenate([q[c] for _, q in parts]) for c in ints}
    del parts
    ok, ln = d["l_orderkey"], d["l_linenumber"]
    disc, tax, ep = d["l_discount"], d["l_tax"], d["l_extendedprice"]
    qty = d["l_quantity"]
    # N2: the generator lays out each order's lines together, in
    # linenumber order
    first = np.concatenate([[True], ok[1:] != ok[:-1]])
    check(bool((ln[first] == 1).all()), "an order's first line is not 1")
    check(bool((ln[~first] == ln[np.flatnonzero(~first) - 1] + 1).all()),
          "an order's lines are not in linenumber order")
    n_orders = int(first.sum())
    n2 = {
        "unnest": (n, int(d["l_partkey"].sum())),
        "cardinality": (n_orders, n, n_orders, int(np.diff(
            np.append(np.flatnonzero(first), n)).max())),
    }
    # N3: the value at a rank of the sorted column (np.partition puts
    # it in place); min_by/max_by read the first / last row, in row
    # order, holding the least / greatest price
    def rank(x, p):
        k = min(max(math.ceil(p * len(x)) - 1, 0), len(x) - 1)
        return int(np.partition(x, k)[k])

    lo = int(ok[int(np.argmin(ep))])
    hi = int(ok[n - 1 - int(np.argmax(ep[::-1]))])
    n3 = (rank(ep, 0.5), rank(qty, 0.9), lo, hi)
    # N4: prices are non-negative and below 2^31 unscaled, so a bincount
    # counts each distinct one; the ORDER BY's top 100 come from the rows
    # at or above the 100th largest value, ties included
    n4_filter = int(((ep + tax) > N4_THRESHOLD).sum())
    counts = np.bincount(ep)
    up = np.flatnonzero(counts)
    top = np.lexsort((up, -counts[up]))[:100]
    n4_group = [(int(up[i]), int(counts[up[i]])) for i in top]
    v = ep - disc
    cut = np.partition(v, n - 100)[n - 100]
    cand = np.flatnonzero(v >= cut)
    top = cand[np.lexsort((ln[cand], ok[cand], -v[cand]))][:100]
    n4_order = [(int(ok[i]), int(ln[i]), int(v[i])) for i in top]
    return n, n1, n2, n3, (n4_filter, n4_group, n4_order)


def numpy_n2_orders(schema: str):
    """{custkey: [orderkeys in row order]} over ``schema``'s orders."""
    import numpy as np

    from presto_tpu_torch.connectors.tpch import SCHEMAS, TpchGenerator

    gen = TpchGenerator(SCHEMAS[schema])
    o = gen.generate("orders", 0, gen.counts["orders"],
                     ["o_orderkey", "o_custkey"])
    ck, okeys = o["o_custkey"].astype(np.int64), o["o_orderkey"]
    order = np.argsort(ck, kind="stable")
    ck, okeys = ck[order], okeys[order].astype(np.int64)
    starts = np.flatnonzero(np.concatenate([[True], ck[1:] != ck[:-1]]))
    ends = np.append(starts[1:], len(ck))
    return {int(ck[s]): okeys[s:e].tolist() for s, e in zip(starts, ends)}


def n5_values(rows: int):
    """N5's table as Python values, from numpy with a fixed seed: ids,
    bigint arrays of 0..8 elements (about 10 % NULL rows), arrays over
    a 16-word vocabulary, maps of 0..4 of those words to bigints (some
    NULL values), and row(x bigint, y double) with NULL fields."""
    import numpy as np

    rng = np.random.default_rng(N5_SEED)

    def lists(lens, flat):
        ends = np.cumsum(lens).tolist()
        return [flat[e - n: e] for n, e in zip(lens.tolist(), ends)]

    lens = rng.integers(0, 9, rows)
    arr = lists(lens, rng.integers(0, 1000, int(lens.sum())).tolist())
    arr = [None if z else a
           for a, z in zip(arr, (rng.random(rows) < 0.1).tolist())]
    tlens = rng.integers(0, 4, rows)
    tags = lists(tlens, np.asarray(N5_WORDS, object)[
        rng.integers(0, 16, int(tlens.sum()))].tolist())
    mlens = rng.integers(0, 5, rows)
    keys = np.argsort(rng.random((rows, 16)), axis=1)[:, :4]
    vals = rng.integers(-100, 100, (rows, 4)).tolist()
    vnull = (rng.random((rows, 4)) < 0.1).tolist()
    m = [
        {N5_WORDS[k]: (None if vn[j] else vs[j])
         for j, k in enumerate(ks[:ml])}
        for ks, vs, vn, ml in zip(keys.tolist(), vals, vnull, mlens.tolist())
    ]
    xs = rng.integers(-50, 50, rows).tolist()
    ys = (rng.standard_normal(rows) * 10).tolist()
    xnull = (rng.random(rows) < 0.1).tolist()
    ynull = (rng.random(rows) < 0.1).tolist()
    rnull = (rng.random(rows) < 0.05).tolist()
    r = [
        None if rn else {"x": None if xn else x, "y": None if yn else y}
        for x, y, xn, yn, rn in zip(xs, ys, xnull, ynull, rnull)
    ]
    return {"id": list(range(rows)), "arr": arr, "tags": tags, "m": m,
            "r": r}


def python_n5(v):
    """N5's answers in plain Python over the same lists (SQL semantics:
    NULL rows skip, an out-of-range subscript is NULL)."""
    import collections

    arrs = [a for a in v["arr"] if a is not None]
    def opt_sum(xs):
        xs = [x for x in xs if x is not None]
        return sum(xs) if xs else None

    out = {"N5 arrays": [(len(v["id"]), opt_sum(len(a) for a in arrs),
                          opt_sum(a[0] for a in arrs if a),
                          opt_sum(a[1] for a in arrs if len(a) > 1),
                          opt_sum(a[-1] for a in arrs if a))]}
    maps = [m for m in v["m"] if m is not None]
    out["N5 maps"] = [(len(v["id"]), opt_sum(m.get("w03") for m in maps),
                       opt_sum(len(m) for m in maps),
                       sum(1 for m in maps if m.get("w11") is not None))]
    rows = [r for r in v["r"] if r is not None and r["x"] is not None
            and r["x"] > 0]
    out["N5 rows"] = [(len(rows), opt_sum(r["x"] for r in rows),
                       opt_sum(r["y"] for r in rows))]
    cnt, ids = collections.Counter(), collections.Counter()
    for i, a in zip(v["id"], v["arr"]):
        for e in a or ():
            cnt[e] += 1
            ids[e] += i
    out["N5 unnest group"] = [(e, cnt[e], ids[e]) for e in sorted(cnt)]
    tc = collections.Counter(t for ts in v["tags"] for t in ts)
    out["N5 unnest tags"] = [(t, tc[t]) for t in sorted(tc)]
    out["N5 materialized"] = [
        (i, v["arr"][i], v["tags"][i], v["m"][i], v["r"][i])
        for i in v["id"] if i % 65536 == 7
    ]
    return out


def same_rows(got, want, rel: float = 0.0) -> bool:
    """Row lists equal, doubles within ``rel`` (0: exactly)."""
    def same(a, b):
        if isinstance(a, float) and isinstance(b, float):
            return a == b or abs(a - b) <= rel * max(abs(a), abs(b))
        if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        if isinstance(a, dict) and isinstance(b, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        return a == b
    return len(got) == len(want) and all(map(same, got, want))


def nested_phase(card: str, dev=None, records=None):
    """The seventh slice's path on ``dev`` (the card unless a CPU
    rehearsal passes another): N1-N4 over SF10 lineitem in the joins
    phase's session, N1 again streamed in the stream phase's default
    session, N2's materialized arrays over SF1 orders, and N5 over a
    memory table of nested columns against Python and the CPU runner.
    Every query runs cold then twice warm (bit-identical). With
    ``records`` (on the card), N1's one-hot reduction is held against its
    plain version at N1's own inputs, the expanded page. Returns (the
    onehot_reduce launches of the counted runs, the records)."""
    import decimal

    import torch

    from presto_tpu_torch import types as T
    from presto_tpu_torch.connectors import create_connector
    from presto_tpu_torch.connectors.spi import TableHandle
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.exec.staging import CatalogManager, obj_array
    from presto_tpu_torch.ops import aggregation as PA
    from presto_tpu_torch.session import Session

    dev = torch.device("cuda") if dev is None else dev
    on_card = dev.type == "cuda"
    out, launches = [], 0
    phase_t0 = time.perf_counter()

    t0 = time.perf_counter()
    n_li, want1, want2, want3, want4 = numpy_nested(NESTED_SF10)
    print(f"numpy evaluation of N1-N4 at {NESTED_SF10} ({n_li} lineitem "
          f"rows): {time.perf_counter() - t0:.2f} s", flush=True)
    runner = LocalQueryRunner(
        device=dev,
        session=Session(schema=NESTED_SF10, properties={
            "max_device_rows": JOINS_MAX_DEVICE_ROWS}),
        staging_cache_bytes=cache_budget(dev),
    )

    def run(name, sql, scanned=None):
        nonlocal launches
        res, rec = run_three(runner, f"{name} {NESTED_SF10}", sql, dev, card,
                             scanned)
        launches += sum(rec["onehot_reduce_launches"])
        out.append(rec)
        return res, rec

    # N1: a static UNNEST into the one-hot GROUP BY, one K1 launch a run
    res, rec = run("N1 unnest into one-hot group by", N1, n_li)
    want = [1] * 3 if on_card else [0] * 3
    check(rec["onehot_reduce_launches"] == want,
          f"N1 made {rec['onehot_reduce_launches']} onehot_reduce launches "
          f"per run, expected {want}")
    got1 = {(f, s): (n, v) for f, s, n, v in result_rows(
        res, ("l_returnflag", "l_linestatus", "n", "s"))}
    check(got1 == want1, f"N1 {got1} != numpy {want1}")
    n1_whole = res
    expanded = 3 * bucket_of(n_li)
    print(f"N1: {sum(n for n, _ in got1.values())} expanded rows in a "
          f"{expanded}-row page equal numpy's [{card}]", flush=True)
    if records is not None and on_card:
        # the one-hot reduction at N1's own inputs (a run not counted)
        with onehot_calls() as seen:
            runner.execute(N1)
        check(len(seen) == 1 and seen[0][0].numel() == expanded,
              "N1 made no single one-hot call over its expanded page")
        records.append(fused_case("n1 fused", *seen[0], card))
        del seen

    # N2: array_agg and the array-column UNNEST
    res, _ = run("N2 array_agg then unnest", N2_UNNEST, n_li)
    got = result_rows(res, ("n", "s"))
    check(got == [want2["unnest"]], f"N2 {got} != {want2['unnest']}")
    res, _ = run("N2 array_agg cardinality", N2_CARDINALITY, n_li)
    got = result_rows(res, ("n", "c", "f", "m"))
    check(got == [want2["cardinality"]],
          f"N2 cardinality {got} != {want2['cardinality']}")
    want_orders = numpy_n2_orders(NESTED_SF1)
    res, rec = run("N2 materialized arrays",
                   N2_ORDERS.format(sf1=NESTED_SF1))
    got = dict(res.rows())
    check(got == want_orders,
          f"N2 materialized: {len(got)} customers, numpy "
          f"{len(want_orders)}, or an array differs")
    print(f"N2: {len(got)} customers' arrays of "
          f"{sum(map(len, got.values()))} orderkeys equal numpy's "
          f"[{card}]", flush=True)

    # N3: global order statistics
    res, _ = run("N3 global order statistics", N3, n_li)
    got = result_rows(res, ("p50", "q90", "lo", "hi"))
    check(got == [want3], f"N3 {got} != numpy {want3}")

    # N4: long decimals
    n4_filter, n4_group, n4_order = want4
    res, _ = run("N4 long-decimal filter", N4_FILTER, n_li)
    check(result_rows(res, ("n",)) == [(n4_filter,)],
          f"N4 filter {result_rows(res, ('n',))} != {n4_filter}")

    def unscaled(x):
        return int(x.scaleb(2))

    res, _ = run("N4 long-decimal group by", N4_GROUP, n_li)
    got = [(unscaled(p), n) for p, n in res.rows()]
    check(got == n4_group, "N4 group by: not numpy's top 100")
    res, _ = run("N4 long-decimal order by", N4_ORDER, n_li)
    got = [(k, ln, unscaled(v)) for k, ln, v in res.rows()]
    check(got == n4_order, "N4 order by: not numpy's top 100")
    check(all(isinstance(v, decimal.Decimal) for *_, v in res.rows()),
          "N4: long decimals must come out as decimal.Decimal")
    del runner

    # N1 streamed in the stream phase's default session
    runner = LocalQueryRunner(device=dev, session=Session(
        schema=NESTED_SF10, properties=STREAM_SF10_PROPS),
        staging_cache_bytes=cache_budget(dev))
    batch = int(runner.session.get("page_capacity"))
    calls = []
    real = PA.onehot_reduce_many

    def record(gid, requests, nseg):
        calls.append(len(requests))
        return real(gid, requests, nseg)

    runs = []
    # cold, then one warm run (a second warm run until PR 16's run 2,
    # whose smoke took 1,103 s of its 1,200)
    for label in ("cold", "warm"):
        calls.clear()
        PA.onehot_reduce_many = record
        try:
            res, rec = stream_run(runner, N1, dev,
                                  f"N1 stream {label} {NESTED_SF10}", card,
                                  n_li, -(-n_li // batch))
        finally:
            PA.onehot_reduce_many = real
        check(len(calls) == rec["batches"] + rec["buckets"],
              f"N1 stream: {len(calls)} one-hot calls, expected one per "
              f"batch and per bucket merge")
        want = sum(-(-k // PA.K_MAX) for k in calls) if on_card else 0
        check(rec["onehot_reduce_launches"] == want,
              f"N1 stream: {rec['onehot_reduce_launches']} launches, "
              f"expected {want}")
        launches += rec["onehot_reduce_launches"]
        out.append(rec)
        runs.append(res)
    for other in runs[1:] + [n1_whole]:
        diff = results_differ(runs[0], other)
        check(diff is None, f"N1 stream: runs differ ({diff})")
    print("N1 streamed: two runs bit-identical to the whole-table run",
          flush=True)
    del runner, runs

    # N5: maps, rows and arrays from the memory connector
    t0 = time.perf_counter()
    values = n5_values(N5_ROWS)
    want5 = python_n5(values)
    python_s = time.perf_counter() - t0
    types = {"id": T.BIGINT, "arr": T.array(T.BIGINT),
             "tags": T.array(T.VARCHAR), "m": T.map_(T.VARCHAR, T.BIGINT),
             "r": T.row(("x", T.BIGINT), ("y", T.DOUBLE))}

    def mem_runner(device):
        catalogs = CatalogManager()
        mem = create_connector("memory")
        catalogs.register("mem", mem)
        h = TableHandle("mem", "n5", "t")
        mem.create_table(h, types)
        mem.append_rows(h, {c: obj_array(v) for c, v in values.items()})
        return LocalQueryRunner(catalogs=catalogs, device=device)

    card_runner, cpu_runner = mem_runner(dev), mem_runner("cpu")
    print(f"N5: {N5_ROWS} rows made and evaluated in Python in "
          f"{python_s:.2f} s", flush=True)
    for name, sql in N5_QUERIES.items():
        res, rec = run_three(card_runner, name, sql, dev, card, N5_ROWS)
        launches += sum(rec["onehot_reduce_launches"])
        if name == "N5 arrays":
            staging_ms = card_runner.history.snapshot()[0].staging_ms
            rec["staging_s"] = staging_ms / 1e3
            print(f"N5 staging from object arrays: {staging_ms / 1e3:.2f} s "
                  f"[{card}]", flush=True)
        out.append(rec)
        got = res.rows()
        cpu = cpu_runner.execute(sql).rows()
        check(same_rows(got, want5[name], 1e-9),
              f"{name}: {str(got)[:300]} != Python {str(want5[name])[:300]}")
        check(same_rows(got, cpu, 1e-9), f"{name}: card and CPU runner differ")
    print(f"N5: {len(N5_QUERIES)} queries equal Python and the CPU runner "
          f"[{card}]", flush=True)
    print(f"nested phase: {time.perf_counter() - phase_t0:.2f} s [{card}]",
          flush=True)
    return launches, out


# -------------------------------------------------------------- write phase

#: W2's working table holds the lines of the prefix of ``WRITE_SCHEMA``'s
#: orders that comes to at least ``WRITE_LI_ROWS`` rows; W3 appends the
#: lines of the next prefix of at least ``WRITE_MORE_ROWS``
WRITE_SCHEMA = "sf1"
WRITE_LI_ROWS = 1 << 19
WRITE_MORE_ROWS = 1 << 17
#: W6's two ingest deltas: rows each, made with numpy from this seed
DELTA_ROWS = 1 << 16
DELTA_SEED = 20261017
#: W8's blackhole table serves this many rows
BH_ROWS = 1 << 24
#: the ten lineitem columns of the working table
WRITE_COLUMNS = [
    "l_orderkey", "l_partkey", "l_linenumber", "l_quantity",
    "l_extendedprice", "l_discount", "l_tax", "l_returnflag",
    "l_linestatus", "l_shipdate",
]
#: the columns held as scaled decimals (scale 2) and as strings
WRITE_DECIMALS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
WRITE_STRINGS = ("l_returnflag", "l_linestatus")
WRITE_VIEW = """create materialized view mem.default.li_mv as
select l_returnflag, l_linestatus, sum(l_extendedprice) as sum_price,
  count(*) as n, min(l_discount) as min_disc, max(l_discount) as max_disc,
  avg(l_quantity) as avg_qty
from mem.default.li group by l_returnflag, l_linestatus"""
WRITE_VIEW_DIRECT = """select l_returnflag, l_linestatus, sum(l_extendedprice)
  as sum_price, count(*) as n, min(l_discount) as min_disc,
  max(l_discount) as max_disc, avg(l_quantity) as avg_qty
from mem.default.li group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus"""
#: W7's aggregate over the base table, which the view maintains
WRITE_REWRITTEN = """select l_returnflag, l_linestatus,
  sum(l_extendedprice) as sum_price, count(*) as n
from mem.default.li group by l_returnflag, l_linestatus"""


def write_columns(schema: str):
    """The working table's source: the orderkey bounds of W2's and W3's
    order prefixes, their row counts, and the generator's own columns of
    both prefixes (decimals scaled by 100, flags as strings, dates as
    epoch days), all int64 but the flags."""
    import numpy as np

    from presto_tpu_torch.connectors.tpch import SCHEMAS, TpchGenerator

    gen = TpchGenerator(SCHEMAS[schema])
    head = min(gen.counts["lineitem"], WRITE_LI_ROWS + WRITE_MORE_ROWS + 16)
    ok = gen.generate("lineitem", 0, head, ["l_orderkey"])["l_orderkey"]
    ok = ok.astype(np.int64)
    check(bool((np.diff(ok) >= 0).all()), "lineitem is not in order order")
    k1 = int(ok[WRITE_LI_ROWS - 1])
    n1 = int(np.searchsorted(ok, k1, side="right"))
    k2 = int(ok[n1 + WRITE_MORE_ROWS - 1])
    n2 = int(np.searchsorted(ok, k2, side="right"))
    check(n2 < head, "W3's prefix runs past the generated rows")
    g = gen.generate("lineitem", 0, n2, WRITE_COLUMNS)
    d = {}
    for c in WRITE_COLUMNS:
        if c in WRITE_STRINGS:
            d[c] = np.asarray(g[c].values).astype(str)[g[c].ids]
        else:
            d[c] = np.asarray(g[c]).astype(np.int64)
    return (k1, n1), (k2, n2), d


def numpy_q1_of(d):
    """Q1 over the columns ``d`` (``write_columns``' form), as
    ``numpy_q1_q6`` returns it."""
    import numpy as np

    keep = d["l_shipdate"] <= Q1_DATE
    rf, ls = d["l_returnflag"], d["l_linestatus"]
    qty, price, disc, tax = (
        d[c] for c in ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
    )
    dp = price * (100 - disc)
    q1 = {}
    for f in np.unique(rf[keep]):
        for s in np.unique(ls[keep]):
            m = keep & (rf == f) & (ls == s)
            n = int(m.sum())
            if n:
                q1[(str(f), str(s))] = {
                    "count_order": n, "sum_qty": int(qty[m].sum()),
                    "sum_base_price": int(price[m].sum()),
                    "sum_disc_price": int(dp[m].sum()),
                    "sum_charge": int((dp[m] * (100 + tax[m])).sum()),
                    "avg_qty": int(qty[m].sum()) / 100 / n,
                    "avg_price": int(price[m].sum()) / 100 / n,
                    "avg_disc": int(disc[m].sum()) / 100 / n,
                }
    return q1


def numpy_view_of(d):
    """The W6 view's rows over the columns ``d``: {(flag, status):
    (sum_price scaled, n, min_disc scaled, max_disc scaled, avg_qty)}."""
    import numpy as np

    rf, ls = d["l_returnflag"], d["l_linestatus"]
    out = {}
    for f in np.unique(rf):
        for s in np.unique(ls):
            m = (rf == f) & (ls == s)
            n = int(m.sum())
            if n:
                out[(str(f), str(s))] = (
                    int(d["l_extendedprice"][m].sum()), n,
                    int(d["l_discount"][m].min()),
                    int(d["l_discount"][m].max()),
                    int(d["l_quantity"][m].sum()) / 100 / n,
                )
    return out


def check_view_rows(label, res, want):
    """A result of the view's shape against ``numpy_view_of``: integers
    and decimals exact, the average within rel 1e-12."""
    n, cols = result_columns(res)
    check(n == len(want), f"{label}: {n} groups, numpy {len(want)}")
    for i in range(n):
        key = (cols["l_returnflag"][i], cols["l_linestatus"][i])
        sp, cnt, mn, mx, aq = want[key]
        got = (int(cols["sum_price"][i]), int(cols["n"][i]),
               int(cols["min_disc"][i]), int(cols["max_disc"][i]))
        check(got == (sp, cnt, mn, mx), f"{label} {key}: {got} != numpy "
              f"{(sp, cnt, mn, mx)}")
        a = float(cols["avg_qty"][i])
        check(abs(a - aq) <= 1e-12 * abs(aq),
              f"{label} {key}: avg_qty {a} vs numpy {aq}")


def write_deltas(first_key: int):
    """W6's two ingest deltas from ``DELTA_SEED``: each as the ingest
    lane hands it to ``commit_snapshot`` (Python values per column:
    decimals as floats, dates as epoch days) and in numpy
    (``write_columns``' form). Orderkeys start at ``first_key``."""
    import numpy as np

    rng = np.random.default_rng(DELTA_SEED)
    out = []
    for j in range(2):
        n = DELTA_ROWS
        d = {
            "l_orderkey": first_key + j * n + np.arange(n, dtype=np.int64),
            "l_partkey": rng.integers(1, 200_001, n),
            "l_linenumber": rng.integers(1, 8, n),
            "l_quantity": rng.integers(1, 51, n) * 100,
            "l_extendedprice": rng.integers(90_000, 10_500_000, n),
            "l_discount": rng.integers(0, 11, n),
            "l_tax": rng.integers(0, 9, n),
            "l_returnflag": rng.choice(np.array(["A", "N", "R"]), n),
            "l_linestatus": rng.choice(np.array(["F", "O"]), n),
            "l_shipdate": rng.integers(8037, 10562, n),
        }
        rows = {
            c: (v / 100 if c in WRITE_DECIMALS else v).tolist()
            for c, v in d.items()
        }
        out.append((rows, d))
    return out


def concat_columns(*ds):
    import numpy as np

    return {c: np.concatenate([d[c] for d in ds]) for c in ds[0]}


def write_phase(card: str, want_q1_big=None, dev=None, records=None,
                big: str = JOINS_SCHEMA):
    """The ninth slice's path on ``dev`` (the card unless a CPU rehearsal
    passes another), through one runner in the joins phase's session with
    a ``memory`` catalog ``mem``, a ``blackhole`` catalog ``bh`` and a
    MemoryPool: W1 a summary table (CTAS of Q1 over ``big`` lineitem,
    then INSERT of Q1 over SF1), W2 a working table of ten SF1 lineitem
    columns and Q1 over it cold and twice warm, W3 INSERT ... SELECT,
    W4 UPDATE, W5 DELETE, W6 an aggregate materialized view with two
    ingest deltas merged incrementally, W7 the auto-rewrite, the read
    gate and ``system.runtime.materialized_views``, W8 blackhole, W9 the
    drops. Every step prints its seconds, K1 launches, split-cache misses
    and peak device memory and is exact against numpy over the
    generator's own columns. ``want_q1_big``: Q1's numpy answer over
    ``big`` (the stream phase's). Returns (the onehot_reduce launches of
    the counted steps, the records)."""
    import numpy as np
    import torch

    from presto_tpu_torch.connectors import create_connector
    from presto_tpu_torch.connectors.spi import TableHandle
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.exec.staging import CatalogManager
    from presto_tpu_torch.ops import aggregation as PA
    from presto_tpu_torch.session import Session
    from presto_tpu_torch.sql import parse_statement
    from presto_tpu_torch.utils.memory import MemoryPool

    dev = torch.device("cuda") if dev is None else dev
    on_card = dev.type == "cuda"
    phase_t0 = time.perf_counter()
    out, launches = [], 0

    t0 = time.perf_counter()
    if want_q1_big is None:
        want_q1_big = numpy_q1_stream(big)[1]
    want_q1_sf1, _ = numpy_q1_q6()
    (k1, n1), (k2, n2), d = write_columns(WRITE_SCHEMA)
    print(f"numpy columns and answers of the write phase: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    catalogs = CatalogManager()
    catalogs.register("tpch", create_connector("tpch"))
    mem = create_connector("memory")
    catalogs.register("mem", mem)
    catalogs.register("bh", create_connector("blackhole",
                                             rows_per_table=BH_ROWS))
    budget = cache_budget(dev)
    pool = MemoryPool(2 * budget)
    runner = LocalQueryRunner(
        catalogs=catalogs, device=dev, memory_pool=pool,
        staging_cache_bytes=budget,
        session=Session(schema=JOINS_SCHEMA, properties={
            "max_device_rows": JOINS_MAX_DEVICE_ROWS}),
    )

    def step(label, fn, want_launches=None, want_misses=None):
        """Run one statement (``fn()``), print and record what it cost,
        and hold its launch and miss counts and the pool."""
        nonlocal launches
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        PA.onehot_reduce.launches = 0
        misses = cache_misses(runner)
        t0 = time.perf_counter()
        res = fn()
        sync(dev)
        secs = time.perf_counter() - t0
        n_launch = PA.onehot_reduce.launches
        misses = cache_misses(runner) - misses
        launches += n_launch
        peak = (torch.cuda.max_memory_allocated(dev) / 2**30
                if on_card else None)
        rec = {"step": label, "s": secs, "onehot_reduce_launches": n_launch,
               "cache_misses": misses, "peak_gib": peak}
        out.append(rec)
        print(f"{label}: {secs:.4f} s, onehot_reduce launches {n_launch}, "
              f"split-cache misses {misses}, peak memory "
              f"{'not measured (no card)' if peak is None else f'{peak:.3f} GiB'}"
              f" [{card}]", flush=True)
        if want_launches is not None:
            want = want_launches if on_card else 0
            check(n_launch == want, f"{label}: {n_launch} onehot_reduce "
                  f"launches, expected {want}")
        if want_misses is not None:
            check(misses == want_misses, f"{label}: {misses} split-cache "
                  f"misses, expected {want_misses}")
        check_pool(label, runner, pool)
        return res, rec

    def sql_step(label, sql, **kw):
        return step(label, lambda: runner.execute(sql), **kw)

    def count_of(res):
        return int(res.rows()[0][0])

    # W1: a summary table from Q1 over the big scale, then SF1's appended
    q1_big = Q1.replace("tpch.sf1.lineitem", f"tpch.{big}.lineitem")
    res, _ = sql_step("W1 CTAS q1 " + big,
                      "create table mem.default.q1_sf10 as " + q1_big,
                      want_launches=1)
    check(count_of(res) == len(want_q1_big), "W1 CTAS: wrong row count")
    res, _ = sql_step("W1 INSERT q1 sf1",
                      "insert into mem.default.q1_sf10 " + Q1,
                      want_launches=1)
    check(count_of(res) == len(want_q1_sf1), "W1 INSERT: wrong row count")
    res, _ = sql_step("W1 read back", "select * from mem.default.q1_sf10",
                      want_launches=0)
    n, cols = result_columns(res)
    wants = [want_q1_big[k] for k in sorted(want_q1_big)]
    wants += [want_q1_sf1[k] for k in sorted(want_q1_sf1)]
    keys = sorted(want_q1_big) + sorted(want_q1_sf1)
    check(n == len(wants), f"W1: {n} rows read back, expected {len(wants)}")
    scales = {"sum_qty": 2, "sum_base_price": 2, "sum_disc_price": 4,
              "sum_charge": 6}
    for i, (key, exp) in enumerate(zip(keys, wants)):
        check((cols["l_returnflag"][i], cols["l_linestatus"][i]) == key,
              f"W1 row {i}: key {cols['l_returnflag'][i]}"
              f"{cols['l_linestatus'][i]} != {key}")
        check(int(cols["count_order"][i]) == exp["count_order"],
              f"W1 {key}: count_order")
        for name in scales:
            check(int(cols[name][i]) == exp[name],
                  f"W1 {key} {name}: {cols[name][i]} != numpy "
                  f"{exp[name]} through the write path")
        for name in ("avg_qty", "avg_price", "avg_disc"):
            got = float(cols[name][i])
            check(abs(got - exp[name]) <= 1e-12 * abs(exp[name]),
                  f"W1 {key} {name}: {got} vs {exp[name]}")
    print(f"W1: {n} rows read back exact against numpy, "
          f"{n * len(scales)} decimal sums among them [{card}]", flush=True)

    # W2: the working table, and Q1 over it cold then twice warm
    cols_sql = ", ".join(WRITE_COLUMNS)
    res, _ = sql_step(
        "W2 CTAS li",
        f"create table mem.default.li as select {cols_sql} from "
        f"tpch.{WRITE_SCHEMA}.lineitem where l_orderkey <= {k1}",
        want_launches=0)
    check(count_of(res) == n1, f"W2: {count_of(res)} rows, expected {n1}")
    print(f"W2: mem.default.li holds the {n1} lines of {WRITE_SCHEMA}'s "
          f"orders up to key {k1} [{card}]", flush=True)
    q1_li = Q1.replace("tpch.sf1.lineitem", "mem.default.li")
    cur = {c: v[:n1] for c, v in d.items()}
    runs = []
    for i, label in enumerate(("W2 Q1 li cold", "W2 Q1 li warm",
                               "W2 Q1 li warm")):
        res, rec = sql_step(label, q1_li, want_launches=1,
                            want_misses=1 if i == 0 else 0)
        runs.append(res)
        if i == 0:
            rec["staging_s"] = runner.history.snapshot()[-1].staging_ms / 1e3
            print(f"W2: staging Q1's 7 columns of {n1} rows from object "
                  f"arrays took {rec['staging_s']:.2f} s [{card}]",
                  flush=True)
    check_q1_stream("W2 Q1 li", runs[0], numpy_q1_of(cur))
    diff = results_differ(runs[1], runs[2])
    check(diff is None, f"W2: two warm runs differ ({diff})")
    if records is not None and on_card:
        # the one-hot reduction at this Q1's own inputs (a run not counted)
        with onehot_calls() as seen:
            runner.execute(q1_li)
        check(len(seen) == 1, f"W2 Q1 made {len(seen)} one-hot calls")
        records.append(fused_case("li q1 fused", *seen[0], card))

    # W3: INSERT ... SELECT of the next prefix
    res, _ = sql_step(
        "W3 INSERT SELECT",
        f"insert into mem.default.li select {cols_sql} from "
        f"tpch.{WRITE_SCHEMA}.lineitem where l_orderkey > {k1} and "
        f"l_orderkey <= {k2}", want_launches=0)
    check(count_of(res) == n2 - n1,
          f"W3: {count_of(res)} rows, expected {n2 - n1}")
    cur = dict(d)
    res, _ = sql_step("W3 Q1 li", q1_li, want_launches=1, want_misses=1)
    check_q1_stream("W3 Q1 li", res, numpy_q1_of(cur))

    # W4: UPDATE
    res, _ = sql_step(
        "W4 UPDATE",
        "update mem.default.li set l_discount = l_discount + 0.01 "
        "where l_returnflag = 'R'", want_launches=0)
    is_r = cur["l_returnflag"] == "R"
    check(count_of(res) == int(is_r.sum()),
          f"W4: {count_of(res)} rows updated, expected {int(is_r.sum())}")
    cur["l_discount"] = cur["l_discount"] + is_r
    res, _ = sql_step("W4 Q1 li", q1_li, want_launches=1, want_misses=1)
    check_q1_stream("W4 Q1 li", res, numpy_q1_of(cur))

    # W5: DELETE
    res, _ = sql_step(
        "W5 DELETE",
        "delete from mem.default.li where l_shipdate > date '1998-09-02'",
        want_launches=0)
    gone = cur["l_shipdate"] > Q1_DATE
    check(count_of(res) == int(gone.sum()),
          f"W5: {count_of(res)} rows deleted, expected {int(gone.sum())}")
    cur = {c: v[~gone] for c, v in cur.items()}
    res, _ = sql_step("W5 Q1 li", q1_li, want_launches=1, want_misses=1)
    check_q1_stream("W5 Q1 li", res, numpy_q1_of(cur))

    # W6: an aggregate view, two ingest deltas merged incrementally
    # the full refresh's and the first delta merge's one-hot calls are
    # recorded as they run (counted) and held against the plain version
    # after the step
    with onehot_calls() as refresh_calls:
        sql_step("W6 CREATE MATERIALIZED VIEW", WRITE_VIEW, want_launches=1)
    reg = runner.mview_registry
    mv = reg.lookup(("mem", "default", "li_mv"))
    check(mv is not None and mv.eligible,
          f"W6: the view is not eligible ({mv and mv.reason})")
    res, _ = sql_step("W6 direct", WRITE_VIEW_DIRECT, want_launches=1)
    check_view_rows("W6 direct", res, numpy_view_of(cur))
    res, _ = sql_step("W6 read view",
                      "select * from mem.default.li_mv order by 1, 2",
                      want_launches=0)
    check_view_rows("W6 view", res, numpy_view_of(cur))
    handle = TableHandle("mem", "default", "li")
    first_key = int(cur["l_orderkey"].max()) + 1
    for sid, (rows, delta) in enumerate(write_deltas(first_key), 1):
        def commit():
            # the ingest lane's commit (server/ingest.py): fold the
            # delta in, invalidate, read the epoch hint, maintain views
            mem.commit_snapshot(handle, rows, sid)
            runner._invalidate_table_caches(handle)
            reg.on_commit(handle, rows, sid, reg._epoch(handle))

        with onehot_calls() as merge_calls:
            step(f"W6 delta {sid} ({DELTA_ROWS} rows)", commit,
                 want_launches=1)
        cur = concat_columns(cur, delta)
        if sid == 1 and records is not None and on_card:
            check(len(refresh_calls) == 1 and len(merge_calls) == 1,
                  f"W6: {len(refresh_calls)} one-hot calls in the refresh "
                  f"and {len(merge_calls)} in the merge, expected one each")
            records.append(fused_case("mv refresh fused", *refresh_calls[0],
                                      card))
            records.append(fused_case("mv delta fused", *merge_calls[0],
                                      card))
        del merge_calls
    del refresh_calls
    check(mv.incremental_refreshes == 2 and mv.last_mode == "incremental",
          f"W6: {mv.incremental_refreshes} incremental refreshes "
          f"({mv.last_mode}), expected 2")
    check(not any("__mv_delta_" in repr(k)
                  for k in runner.split_cache._entries),
          "W6: a delta staging page stayed in the split cache")
    want_view = numpy_view_of(cur)
    view, _ = sql_step("W6 read view",
                       "select * from mem.default.li_mv order by 1, 2",
                       want_launches=0)
    check_view_rows("W6 view after deltas", view, want_view)
    res, _ = sql_step("W6 direct", WRITE_VIEW_DIRECT, want_launches=1,
                      want_misses=1)
    check_view_rows("W6 direct after deltas", res, want_view)
    sql_step("W6 REFRESH", "refresh materialized view mem.default.li_mv",
             want_launches=1)
    again, _ = sql_step("W6 read view",
                        "select * from mem.default.li_mv order by 1, 2",
                        want_launches=0)
    diff = results_differ(view, again)
    check(diff is None, f"W6: REFRESH changed the stored rows ({diff})")
    print(f"W6: the view equals numpy and the direct query after two "
          f"deltas merged incrementally, and a REFRESH stores the same "
          f"bits [{card}]", flush=True)

    # W7: the auto-rewrite, the read gate, the system table
    off, _ = sql_step("W7 base aggregate", WRITE_REWRITTEN, want_launches=1)
    runner.session.set("mview_auto_rewrite", True)
    try:
        _plan, _hit, key = runner.plan_cached_keyed(
            parse_statement(WRITE_REWRITTEN))
        check("'li_mv'" in (key or ""),
              f"W7: the plan-cache key does not name the view: {key}")
        on, _ = sql_step("W7 rewritten", WRITE_REWRITTEN, want_launches=0)
        check(runner.history.snapshot()[-1].mview_rewritten
              == "mem.default.li_mv", "W7: the read was not rewritten")
        check(sorted(on.rows()) == sorted(off.rows()),
              "W7: the rewritten rows differ")
    finally:
        runner.session.set("mview_auto_rewrite", False)
    extra = {"l_orderkey": first_key + 2 * DELTA_ROWS, "l_partkey": 1,
             "l_linenumber": 1, "l_quantity": 700, "l_extendedprice": 123456,
             "l_discount": 4, "l_tax": 2, "l_returnflag": "N",
             "l_linestatus": "O", "l_shipdate": 10000}
    values = ", ".join(
        f"'{extra[c]}'" if c in WRITE_STRINGS
        else f"{extra[c] / 100:.2f}" if c in WRITE_DECIMALS
        else str(extra[c])
        for c in WRITE_COLUMNS)
    res, _ = sql_step("W7 legacy INSERT",
                      f"insert into mem.default.li values ({values})",
                      want_launches=0)
    check(count_of(res) == 1, "W7: the legacy INSERT did not write 1 row")
    cur = concat_columns(cur, {c: np.asarray([v]) for c, v in extra.items()})
    refreshes = mv.refreshes
    reg.max_staleness_s = 1e-3
    try:
        time.sleep(0.01)
        res, _ = sql_step("W7 gated read",
                          "select * from mem.default.li_mv order by 1, 2",
                          want_launches=1)
    finally:
        reg.max_staleness_s = None
    check(mv.refreshes == refreshes + 1 and mv.last_mode == "full",
          "W7: the read gate did not refresh the view")
    check_view_rows("W7 gated read", res, numpy_view_of(cur))
    res, _ = sql_step(
        "W7 system table",
        "select view, base_table, eligible, snapshot_id, last_refresh_mode,"
        ' refreshes, incremental_refreshes, "rows" from '
        "system.runtime.materialized_views", want_launches=0)
    rows = res.rows()
    check(rows == [("mem.default.li_mv", "mem.default.li", True, 2, "full",
                    mv.refreshes, 2, len(numpy_view_of(cur)))],
          f"W7: system.runtime.materialized_views {rows}")
    print(f"W7: {rows[0]} [{card}]", flush=True)

    # W8: blackhole as a source and a sink
    sql_step("W8 CREATE TABLE", "create table bh.default.big "
             "(k bigint, x double)", want_launches=0)
    probe = "select count(*), sum(k), sum(x) from bh.default.big"
    res, _ = sql_step("W8 scan", probe, want_launches=0)
    check(res.rows() == [(BH_ROWS, 0, 0.0)], f"W8: {res.rows()}")
    res, _ = sql_step("W8 INSERT SELECT", "insert into bh.default.big select "
                      "l_orderkey, l_quantity from mem.default.li",
                      want_launches=0)
    n_li = len(cur["l_orderkey"])
    check(count_of(res) == n_li, f"W8: {count_of(res)} rows, expected {n_li}")
    res, _ = sql_step("W8 scan after", probe, want_launches=0, want_misses=1)
    check(res.rows() == [(BH_ROWS, 0, 0.0)], f"W8 after: {res.rows()}")

    # W9: the drops leave no page of a dropped table behind (blackhole
    # has no DROP TABLE, as in the reference: its page is the one W8's
    # last scan staged after the INSERT)
    sql_step("W9 DROP MATERIALIZED VIEW",
             "drop materialized view mem.default.li_mv", want_launches=0)
    for t in ("mem.default.li", "mem.default.q1_sf10"):
        sql_step(f"W9 DROP TABLE {t}", f"drop table {t}", want_launches=0)
    gone = {"li", "li_mv", "q1_sf10"}
    left = [k for k in runner.split_cache._entries
            if k[0].catalog == "mem" and (
                k[0].table in gone or k[0].table.startswith("__mv_delta_"))]
    check(not left, f"W9: pages of dropped tables remain: {left}")
    check_pool("W9", runner, pool)
    secs = time.perf_counter() - phase_t0
    print(f"write phase: {secs:.2f} s, onehot_reduce launches {launches} "
          f"[{card}]", flush=True)
    del runner
    return launches, out


# ------------------------------------------------------------ observe phase

#: Q3's cached variant for the adaptive step: both date literals move,
#: so the lineitem filter keeps about 3 % of lineitem where Q3 keeps
#: about 54 %, past the default 4x divergence factor
Q3_VARIANT_DATES = ("1998-08-01", "1998-06-01")
Q3_VARIANT = Q3.replace(
    "o_orderdate < date '1995-03-15'",
    f"o_orderdate < date '{Q3_VARIANT_DATES[0]}'",
).replace(
    "l_shipdate > date '1995-03-15'",
    f"l_shipdate > date '{Q3_VARIANT_DATES[1]}'",
)


def epoch_days(iso: str) -> int:
    import datetime

    return (datetime.date.fromisoformat(iso) - datetime.date(1970, 1, 1)).days


def q3_top10(want):
    """Q3's top 10 rows (orderkey, revenue, orderdate, shippriority) from
    numpy's groups, in the query's order."""
    ranked = sorted(want.items(), key=lambda kv: (-kv[1][0], kv[1][1], kv[0]))
    return [(k, r, dt, sp) for k, (r, dt, sp) in ranked[:10]]


def q3_rows(res):
    return [tuple(row) for row in result_rows(
        res, ("l_orderkey", "revenue", "o_orderdate", "o_shippriority"))]


def text_lines(res):
    return [row[0] for row in res.rows()]


def analyze_rows(lines):
    """EXPLAIN ANALYZE lines -> [(label, rows)] of the plan's nodes."""
    import re

    out = []
    for line in lines:
        m = re.match(r"^ *- (.*?)  \[rows: (\d+)", line)
        if m:
            out.append((m.group(1), int(m.group(2))))
    return out


def check_analyze(label, lines, want):
    """Every node whose label starts with a key of ``want`` (a scan of
    one table, a filter over one column, the aggregation) reports the
    rows numpy counted."""
    nodes = analyze_rows(lines)
    check(len(nodes) == len(lines) - 2,
          f"{label}: a node without its row count")
    for prefix, rows in want.items():
        got = [r for lbl, r in nodes if lbl.startswith(prefix[0])
               and prefix[1] in lbl]
        check(got == [rows], f"{label}: {prefix} rows {got}, numpy {rows}")


def median_run_s(runner, sql, dev, runs: int = 3):
    out = []
    for _ in range(runs):
        _, secs = run_timed(runner, sql, dev)
        out.append(secs)
    return sorted(out)[len(out) // 2]


def observe_phase(card: str, keep: dict, dev=None,
                  tpcds_schema: str = TPCDS_SF1):
    """The eighth slice's path on ``dev`` (the card unless a CPU
    rehearsal passes another), over the slice and joins phases' runners
    (``keep``) and the tables they staged: the device probe; EXPLAIN of
    Q1 and Q5 equal to the CPU runner's text; EXPLAIN ANALYZE of Q1 at
    SF1 and Q5 at the joins scale, each node's rows against numpy; warm
    Q1, Q6 and TPC-DS Q64 with operator stats on and off; the history
    store with adaptive replanning on Q3; the system tables. Returns
    (the onehot_reduce launches of its runs, the record)."""
    import json
    import shutil
    import tempfile

    import numpy as np
    import torch

    from presto_tpu_torch.connectors.tpch import SCHEMAS, TpchGenerator
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.ops import aggregation as PA
    from presto_tpu_torch.plan.history import QueryHistoryStore
    from presto_tpu_torch.plan.planner import plan_statement
    from presto_tpu_torch.session import Session
    from presto_tpu_torch.sql import parse_statement
    from presto_tpu_torch.utils import devicediag
    from presto_tpu_torch.utils.memory import MemoryPool
    from presto_tpu_torch.utils.metrics import REGISTRY

    dev = torch.device("cuda") if dev is None else dev
    on_card = dev.type == "cuda"
    s1, sj = keep["slice"], keep["joins"]
    joins_session = {"max_device_rows": JOINS_MAX_DEVICE_ROWS}
    times, rec, launches = {}, {}, 0

    def counted(fn, expect):
        """Run fn with the launch count reset; check it made ``expect``
        K1 launches on the card (0 on the CPU)."""
        nonlocal launches
        PA.onehot_reduce.launches = 0
        out = fn()
        n = PA.onehot_reduce.launches
        launches += n
        check(n == (expect if on_card else 0),
              f"{n} onehot_reduce launches, expected {expect}")
        return out

    # 1. the device probe: enumerate, build K1, one K1 launch checked
    t0 = time.perf_counter()
    diag = counted(lambda: devicediag.probe_backend(dev), 1)
    times["probe"] = time.perf_counter() - t0
    want_phases = ({"enumerate": "ok", "compile": "ok", "execute": "ok"}
                   if on_card else
                   {"enumerate": "ok", "compile": "skipped",
                    "execute": "skipped"})
    check(diag.ok and diag.phases == want_phases, f"device probe: {diag}")

    # 2. EXPLAIN on the card equals the CPU runner's text
    t0 = time.perf_counter()
    for name, runner, sql, session in (
        ("Q1", s1, Q1, Session()),
        ("Q5", sj, Q5, Session(schema=JOINS_SCHEMA,
                               properties=joins_session)),
    ):
        cpu = LocalQueryRunner(device="cpu", session=session)
        got = text_lines(runner.execute("explain " + sql))
        check(got == text_lines(cpu.execute("explain " + sql)),
              f"EXPLAIN {name}: the card's text differs from the CPU's")
    times["explain"] = time.perf_counter() - t0

    # 3. EXPLAIN ANALYZE of Q1 at SF1 and Q5 at the joins scale: every
    # node counted, the result and the counts against numpy
    li = sf1_lineitem()
    q1_filter = int((li["l_shipdate"].astype(np.int64) <= Q1_DATE).sum())
    cols = keep["joins_cols"]
    counts = TpchGenerator(SCHEMAS[JOINS_SCHEMA]).counts
    od = cols["orders"]["o_orderdate"]
    q5_orders = int(((od >= Q5_FROM) & (od < Q5_TO)).sum())
    cases = (
        ("Q1", s1, Q1, {
            ("TableScan[tpch.sf1.lineitem", ""): SF1_LINEITEM_ROWS,
            ("Filter[", "l_shipdate"): q1_filter,
            ("Aggregate[", ""): len(keep["want_q1"]),
        }),
        ("Q5", sj, Q5, {
            **{(f"TableScan[tpch.{JOINS_SCHEMA}.{t}", ""): counts[t]
               for t in ("lineitem", "orders", "customer", "supplier",
                         "nation", "region")},
            ("Filter[", "r_name"): 1,
            ("Filter[", "o_orderdate"): q5_orders,
            ("Aggregate[", ""): len(keep["want_q5"]),
        }),
    )
    for name, runner, sql, want in cases:
        t0 = time.perf_counter()
        plan = plan_statement(parse_statement(sql), runner.catalogs,
                              runner.session)
        res, stats, *_ = counted(
            lambda: runner.execute_plan_analyzed(plan, sql), 1)
        sync(dev)
        if name == "Q1":
            check_q1_stream("EXPLAIN ANALYZE Q1", res, keep["want_q1"])
        else:
            got5 = dict(result_rows(res, ("n_name", "revenue")))
            check(got5 == keep["want_q5"], f"EXPLAIN ANALYZE Q5 {got5}")
        check(all(s.output_rows >= 0 for s in stats), f"{name}: stats")
        lines = counted(
            lambda: text_lines(runner.execute("explain analyze " + sql)), 1)
        check_analyze(f"EXPLAIN ANALYZE {name}", lines, want)
        times[f"analyze_{name.lower()}"] = time.perf_counter() - t0
        rec[f"analyze_{name.lower()}_nodes"] = len(stats)

    # 4. warm latency and host waits with operator stats on and off
    t0 = time.perf_counter()
    q64 = tpcds_queries(tpcds_schema)[0]
    ds = LocalQueryRunner(device=dev, session=Session(properties=joins_session))
    PA.onehot_reduce.launches = 0
    ds.execute(q64)  # cold: stages the tables
    for flag in ("true", "false"):
        for r in (s1, ds):
            r.session.set("enable_operator_stats", flag)
        with counting_syncs(dev) as syncs:
            res = s1.execute(Q1)
            sync(dev)
        rec[f"q1_rows_stats_{flag}"] = res.rows()
        rec[f"q1_syncs_stats_{flag}"] = syncs[0]
        rec[f"q1_warm_s_stats_{flag}"] = median_run_s(s1, Q1, dev)
        rec[f"q6_warm_s_stats_{flag}"] = median_run_s(s1, Q6, dev)
        rec[f"q64_warm_s_stats_{flag}"] = median_run_s(ds, q64, dev)
        for name, r, sql in (("q1", s1, Q1), ("q64", ds, q64)):
            syncs_p, device_ms = warm_profile(r, sql, dev)
            rec[f"{name}_profiled_syncs_stats_{flag}"] = syncs_p
            rec[f"{name}_device_ms_stats_{flag}"] = device_ms
        check(bool(s1.history.snapshot()[-1].operators) == (flag == "true"),
              "operator stats did not follow enable_operator_stats")
    for r in (s1, ds):
        r.session.set("enable_operator_stats", "true")
    del ds
    check(rec.pop("q1_rows_stats_true") == rec.pop("q1_rows_stats_false"),
          "warm Q1 differs with operator stats off")
    check_q1_stream("warm Q1", s1.execute(Q1), keep["want_q1"])
    launches += PA.onehot_reduce.launches
    check(rec["q1_syncs_stats_true"] == rec["q1_syncs_stats_false"],
          f"warm Q1 host waits: {rec['q1_syncs_stats_true']} with operator "
          f"stats, {rec['q1_syncs_stats_false']} without")
    check(rec["q64_profiled_syncs_stats_true"]
          == rec["q64_profiled_syncs_stats_false"],
          "warm Q64: operator stats changed the cudaStreamSynchronize count")
    times["stats_on_off"] = time.perf_counter() - t0

    # 5. the history store and adaptive replanning on Q3 at the joins
    # scale: a fresh canonical entry planned with the plane on
    t0 = time.perf_counter()
    hist_dir = tempfile.mkdtemp(prefix="observe-history-")
    sj.history_store = QueryHistoryStore(hist_dir)
    sj.history.add_listener(sj.history_store)
    sj.session.set("adaptive_enabled", "true")
    sj.plan_cache.clear()
    replans0 = REGISTRY.counter("plan.replans").total
    flags = []
    for sql in (Q3, Q3):
        check(q3_rows(sj.execute(sql)) == q3_top10(keep["want_q3"]),
              "Q3 with the history store differs from numpy")
        flags.append(sj.history.snapshot()[-1].replanned)
    explain = "\n".join(text_lines(sj.execute("explain " + Q3)))
    check("(history)" in explain, "EXPLAIN Q3 shows no history estimate")
    want_v = q3_top10(numpy_q3(
        cols, epoch_days(Q3_VARIANT_DATES[0]), epoch_days(Q3_VARIANT_DATES[1])
    ))
    for _ in range(2):
        got_v = q3_rows(sj.execute(Q3_VARIANT))
        qs = sj.history.snapshot()[-1]
        check(qs.plan_cache_hit or qs.replanned,
              "Q3's variant missed the plan cache")
        flags.append(qs.replanned)
        check(got_v == want_v, "Q3's variant differs from numpy")
    replans = REGISTRY.counter("plan.replans").total - replans0
    check(flags[-1], "Q3's variant did not replan after its literal moved "
          "the lineitem filter's rows past the divergence factor")
    check(replans == sum(flags), f"plan.replans {replans}, flags {flags}")
    rec["q3_replanned"] = flags
    rec["q3_adaptive_note"] = qs.adaptive_notes
    rec["history"] = sj.history_store.stats()
    sj.session.set("adaptive_enabled", "false")
    shutil.rmtree(hist_dir, ignore_errors=True)
    times["history_adaptive"] = time.perf_counter() - t0

    # 6. the system tables, read by SQL on the card
    t0 = time.perf_counter()
    pool = MemoryPool(cache_budget(dev))
    obs = LocalQueryRunner(device=dev, memory_pool=pool)
    obs.execute(Q6)
    queries = obs.execute(
        "select query_id, state, plan_fingerprint from system.runtime.queries"
    ).rows()
    check([q[1] for q in queries] == ["FINISHED", "RUNNING"]
          and len(queries[0][2]) == 16, f"runtime.queries {queries}")
    metrics = dict(obs.execute(
        "select name, value from system.runtime.metrics"
    ).rows())
    check(metrics["device.dispatches.total"] >= 1
          and metrics["queries.finished.total"] >= 1, "runtime.metrics")
    caches = {r[0]: r[1:] for r in obs.execute(
        "select cache, entries, hits, misses from system.runtime.caches"
    ).rows()}
    split = obs.split_cache.stats()
    check(caches["staging.split_cache"] == (
        split["entries"], split["hits"], split["misses"]
    ) and split["entries"] >= 1, f"runtime.caches {caches}")
    check("plan.cache" in caches, "runtime.caches has no plan cache row")
    memory = obs.execute(
        "select node_id, query_id, state, reserved_bytes "
        "from system.runtime.memory"
    ).rows()
    check(memory[0][:3] == ("local", "", "OK")
          and memory[0][3] == pool.snapshot()["reserved"] > 0,
          f"runtime.memory {memory}")
    (node,) = obs.execute(
        "select state, backend_diag from system.runtime.nodes"
    ).rows()
    diag = json.loads(node[1])
    want_name = torch.cuda.get_device_name(0) if on_card else "cpu"
    check(diag["backend"] == ("gpu" if on_card else "cpu")
          and diag["device_name"] == want_name
          and diag["phases"] == want_phases,
          f"runtime.nodes backend_diag {diag}")
    times["system_tables"] = time.perf_counter() - t0
    rec["backend_diag"] = diag
    rec["times_s"] = times

    print(
        "observe: " + ", ".join(f"{k} {v:.2f} s" for k, v in times.items())
        + f"; warm Q1 {rec['q1_warm_s_stats_true']:.4f} / "
        f"{rec['q1_warm_s_stats_false']:.4f} s, Q6 "
        f"{rec['q6_warm_s_stats_true']:.4f} / "
        f"{rec['q6_warm_s_stats_false']:.4f} s, Q64 {tpcds_schema} "
        f"{rec['q64_warm_s_stats_true']:.4f} / "
        f"{rec['q64_warm_s_stats_false']:.4f} s with operator stats on / "
        f"off; warm Q1 host waits {rec['q1_syncs_stats_true']} / "
        f"{rec['q1_syncs_stats_false']}; device ms of a warm run (profiler) "
        f"Q1 {rec['q1_device_ms_stats_true']} / "
        f"{rec['q1_device_ms_stats_false']}, Q64 "
        f"{rec['q64_device_ms_stats_true']} / "
        f"{rec['q64_device_ms_stats_false']}, its cudaStreamSynchronize "
        f"{rec['q64_profiled_syncs_stats_true']} / "
        f"{rec['q64_profiled_syncs_stats_false']}; Q3 replanned {flags} "
        f"({rec['q3_adaptive_note']}); onehot_reduce launches {launches} "
        f"[{card}]",
        flush=True,
    )
    keep.clear()
    if on_card:
        torch.cuda.empty_cache()
    return launches, rec


# ------------------------------------------------------------ server phase

#: the server phase's budgets: three runners (a coordinator and two
#: workers) share the card in this process, each with its own split
#: cache and memory pool, 40 GiB in all
SERVER_CACHE_BYTES = {"coordinator": 4 << 30, "worker": 8 << 30}
SERVER_POOL_BYTES = {"coordinator": "8GB", "worker": "16GB"}
SERVER_WORKERS = 2


def server_rows(rows):
    """Result rows as the paged protocol renders them (JSON; dates as
    their ISO strings)."""
    return [tuple(r) for r in json.loads(json.dumps(rows, default=str))]


def rows_close(got, want, rel: float = 1e-9) -> Optional[str]:
    """None if the row lists agree (doubles within ``rel``, everything
    else exactly), else the first difference."""
    if len(got) != len(want):
        return f"{len(got)} rows != {len(want)} rows"
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                if abs(a - b) > rel * max(abs(a), abs(b)):
                    return f"{g} != {w}"
            elif a != b:
                return f"{g} != {w}"
    return None


def server_phase(card: str, want_q1_big=None, dev=None, records=None,
                 big: str = JOINS_SCHEMA, small: str = "sf1"):
    """The tenth slice's path on ``dev`` (the card unless a CPU
    rehearsal passes another): a ``CoordinatorServer`` and two
    ``WorkerServer``s in this process over loopback HTTP, driven through
    ``PrestoTpuClient``. S1 Q1 over ``big`` (each worker batch's partial
    GROUP BY and each merge task's final one launch K1; the rows held
    against the port's local runner), S2 Q3 and Q18 over ``small`` in the
    default session (the dynamic-filter summary stage and the shuffled
    aggregation), S3 Q3 with ``join_distribution_type=PARTITIONED`` (the
    HTTP shuffle of both join sides), S4 the distributed EXPLAIN ANALYZE
    of Q1 and ``system.runtime.nodes``, S5 a graceful worker drain.
    ``want_q1_big``: the port's local result of Q1 over ``big`` (the
    stream phase's warm run); None runs it on the coordinator's runner.
    Returns (the onehot_reduce launches of the counted steps, the
    records)."""
    import torch

    from presto_tpu_torch.connectors.tpch import SCHEMAS, TpchGenerator
    from presto_tpu_torch.ops import aggregation as PA
    from presto_tpu_torch.server import (
        CoordinatorServer,
        PrestoTpuClient,
        WorkerServer,
        rpc,
    )
    from presto_tpu_torch.server.scheduler import assign_ranges
    from presto_tpu_torch.session import NodeConfig, Session
    from presto_tpu_torch.utils.metrics import REGISTRY

    dev = torch.device("cuda") if dev is None else dev
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    phase_t0 = time.perf_counter()
    out, launches = [], 0

    def config(kind):
        return NodeConfig({
            "staging.cache-bytes": str(SERVER_CACHE_BYTES[kind]),
            "query.max-memory-per-node": SERVER_POOL_BYTES[kind],
        })

    t0 = time.perf_counter()
    coord = CoordinatorServer(config=config("coordinator"), device=dev,
                              session=Session(schema=small)).start()
    workers = [
        WorkerServer(coordinator_uri=coord.uri, config=config("worker"),
                     device=dev).start()
        for _ in range(SERVER_WORKERS)
    ]
    deadline = time.monotonic() + 60
    while (len(coord.active_workers()) < SERVER_WORKERS
           and time.monotonic() < deadline):
        time.sleep(0.05)
    check(len(coord.active_workers()) == SERVER_WORKERS,
          "the workers did not announce themselves")
    print(f"server boot: a coordinator and {SERVER_WORKERS} workers on "
          f"{dev} in {time.perf_counter() - t0:.2f} s (split caches "
          f"{SERVER_CACHE_BYTES}, pools {SERVER_POOL_BYTES}) [{card}]",
          flush=True)
    client = PrestoTpuClient(coord.uri, timeout_s=900)

    def step(label, sql, want=None):
        """Run ``sql`` over HTTP; print and record its seconds, wire
        bytes (every task's serialized output) and K1 launches."""
        nonlocal launches
        PA.onehot_reduce.launches = 0
        shuffle0 = REGISTRY.counter("exchange.http_shuffle_bytes").total
        t0 = time.perf_counter()
        res = client.execute(sql)
        secs = time.perf_counter() - t0
        n_launch = PA.onehot_reduce.launches
        launches += n_launch
        stages = coord.queries[res.query_id].stats.stages
        wire = sum(t.output_bytes for st in stages for t in st.tasks)
        shuffle = (REGISTRY.counter("exchange.http_shuffle_bytes").total
                   - shuffle0)
        shape = [(st.kind, len(st.tasks)) for st in stages]
        rec = {"step": label, "s": secs, "wire_bytes": wire,
               "http_shuffle_bytes": shuffle,
               "onehot_reduce_launches": n_launch, "stages": shape}
        out.append(rec)
        print(f"{label}: {secs:.4f} s, wire bytes {wire} (shuffle "
              f"{shuffle}), onehot_reduce launches {n_launch}, stages "
              f"{shape} [{card}]", flush=True)
        if want is not None:
            diff = rows_close(res.rows(), server_rows(want))
            check(diff is None, f"{label}: differs from the local runner "
                  f"({diff})")
        return res, rec

    try:
        # S1: Q1 over ``big``, the partial GROUP BY on every worker batch
        # and the final one on every merge task
        q1_big = Q1.replace("tpch.sf1.lineitem", f"tpch.{big}.lineitem")
        if want_q1_big is None:
            t0 = time.perf_counter()
            want_q1_big = coord.local.execute(q1_big).rows()
            print(f"Q1 {big} on the coordinator's local runner: "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
        with onehot_calls() as seen:
            res, rec = step(f"S1 Q1 {big} over HTTP", q1_big, want_q1_big)
        calls = [len(reqs) for _, reqs, _ in seen]
        session = coord.local.session
        rows = TpchGenerator(SCHEMAS[big]).counts["lineitem"]
        batch = int(session.get("page_capacity"))
        ranges = assign_ranges(
            rows, SERVER_WORKERS * int(session.get("split_queue_factor")))
        n_batches = sum(-(-(hi - lo) // batch) for lo, hi in ranges if hi > lo)
        merges = dict(rec["stages"]).get("merge", 0)
        check(len(calls) == n_batches + merges,
              f"S1: {len(calls)} one-hot calls, expected one per worker "
              f"batch and per merge task ({n_batches} + {merges})")
        want_launches = (sum(-(-k // PA.K_MAX) for k in calls)
                         if on_card else 0)
        check(rec["onehot_reduce_launches"] == want_launches,
              f"S1: {rec['onehot_reduce_launches']} onehot_reduce "
              f"launches, expected {want_launches}")
        rec["batches"], rec["merges"] = n_batches, merges
        # the first call is a worker batch's partial GROUP BY (Q1's 8
        # requests); the merge tasks' finals (22) come after every batch
        check(calls[0] == 8, f"S1: the first one-hot call has {calls[0]} "
              "requests, not a worker batch's 8")
        if records is not None and on_card:
            # one worker's partial GROUP BY, at its own batch's inputs
            records.append(fused_case("server q1 worker batch fused",
                                      *seen[0], card))
        del seen, calls, res

        # S2: Q3 and Q18 in the default session
        sqls = {"Q3": Q3, "Q18": tpch_queries()["Q18"]}
        local = {k: coord.local.execute(v).rows() for k, v in sqls.items()}
        q3 = None
        for name, sql in sqls.items():
            res, rec = step(f"S2 {name} {small}", sql, local[name])
            kinds = [k for k, _ in rec["stages"]]
            check(kinds[0] == "dynfilter" and "merge" in kinds,
                  f"S2 {name}: stages {kinds}, expected the dynamic-filter "
                  "summary first and a shuffled merge")
            if name == "Q3":
                q3 = res.rows()

        # S3: Q3 with both join sides shuffled over HTTP
        client.execute("set session join_distribution_type = 'PARTITIONED'")
        try:
            res, rec = step(f"S3 Q3 {small} partitioned", Q3, local["Q3"])
        finally:
            client.execute("set session join_distribution_type = 'AUTOMATIC'")
        kinds = [k for k, _ in rec["stages"]]
        check(kinds.count("producer") >= 2 and "join" in kinds
              and rec["http_shuffle_bytes"] > 0,
              f"S3: stages {kinds}, shuffle bytes "
              f"{rec['http_shuffle_bytes']}")
        check(res.rows() == q3, "S3: the partitioned Q3 differs from S2's")
        print(f"S3 exchange.http_shuffle_bytes {rec['http_shuffle_bytes']} "
              f"[{card}]", flush=True)

        # S4: distributed EXPLAIN ANALYZE and the server's system rows
        res, rec = step(f"S4 EXPLAIN ANALYZE Q1 {small}",
                        "explain analyze " + Q1)
        text = "\n".join(r[0] for r in res.rows())
        check("task" in text and "stage" in text.lower(),
              "S4: the distributed EXPLAIN ANALYZE has no stage or task")
        nodes = client.execute(
            "select node_id, state from system.runtime.nodes").rows()
        ids = {w.node_id for w in workers}
        check(ids <= {n for n, st in nodes if st == "ACTIVE"},
              f"S4: system.runtime.nodes {nodes}")
        rec["nodes"] = nodes
        print(f"S4 system.runtime.nodes: {nodes}", flush=True)

        # S5: a graceful drain of one worker under the running cluster
        t0 = time.perf_counter()
        gone = workers[-1]
        rpc.call_json("PUT", f"{gone.uri}/v1/state/drain", {})
        deadline = time.monotonic() + 60
        while (gone.node_id in {w.node_id for w in coord.active_workers()}
               or not gone._shutting_down) and time.monotonic() < deadline:
            time.sleep(0.05)
        check(gone._shutting_down and gone.node_id not in {
            w.node_id for w in coord.active_workers()},
            "S5: the drained worker is still scheduled")
        drain_s = time.perf_counter() - t0
        res, rec = step(f"S5 Q6 {small} after a drain",
                        Q6.replace("tpch.sf1.", f"tpch.{small}."),
                        coord.local.execute(
                            Q6.replace("tpch.sf1.", f"tpch.{small}.")
                        ).rows())
        nodes = {t.node_id for st in coord.queries[res.query_id].stats.stages
                 for t in st.tasks}
        check(gone.node_id not in nodes, f"S5: tasks ran on {nodes}")
        rec["drain_s"] = drain_s
        print(f"S5 drain: {drain_s:.2f} s until the worker left discovery "
              f"and shut down [{card}]", flush=True)
    finally:
        for w in workers:
            w.shutdown(graceful=False)
        coord.shutdown()
    secs = time.perf_counter() - phase_t0
    print(f"server phase: {secs:.2f} s, onehot_reduce launches {launches} "
          f"[{card}]", flush=True)
    out.append({"step": "phase", "s": secs})
    return launches, out


# ------------------------------------------------------------- serve phase

#: the serve phase's coordinator: the batch window and group size, the
#: result cache on, the ingest lane's explicit commits
SERVE_WAIT_MS = 300
SERVE_MAX = 16
#: Q1 weighs 17 against the default max_fragment_weight of 16 (its
#: root Sort counts 6), so a Q1-shaped plan would run fragmented and
#: skip the batch screen, in both packages; the serve session raises it
SERVE_FRAGMENT_WEIGHT = 24
SERVE_SEED = 20261018
SERVE_INGEST_BATCHES = 8
SERVE_INGEST_ROWS = 1 << 16
POINT_SHAPE = (
    "select o_orderkey, o_custkey, o_totalprice, o_orderdate "
    "from tpch.{schema}.orders where o_orderkey = ?"
)
Q1_CUT_SHAPE = Q1.replace(
    "date '1998-12-01' - interval '90' day", "?")
Q1_CUTOFFS = [
    "1992-03-01", "1993-01-15", "1993-11-30", "1994-10-10",
    "1995-08-20", "1996-07-01", "1997-05-12", "1998-12-01",
]
Q6_SERVE = [
    ("1993-01-01", "1994-01-01", "0.02", "0.04", "24"),
    ("1994-01-01", "1995-01-01", "0.05", "0.07", "24"),
    ("1995-01-01", "1996-01-01", "0.04", "0.06", "25"),
    ("1996-01-01", "1997-01-01", "0.06", "0.08", "30"),
    ("1997-01-01", "1998-01-01", "0.01", "0.03", "20"),
    ("1992-01-01", "1993-01-01", "0.07", "0.09", "35"),
    ("1994-06-01", "1995-06-01", "0.03", "0.05", "28"),
    ("1995-06-01", "1996-06-01", "0.08", "0.09", "40"),
]
INGEST_DDL = (
    "create table mem.default.li (l_returnflag varchar, "
    "l_linestatus varchar, l_quantity decimal(12,2), "
    "l_extendedprice decimal(12,2), l_discount decimal(12,2), "
    "l_tax decimal(12,2), l_shipdate date)"
)
INGEST_VIEW = (
    "create materialized view mem.default.li_mv as "
    "select l_returnflag, l_linestatus, sum(l_extendedprice) as sp, "
    "count(*) as n, min(l_discount) as mn, max(l_discount) as mx, "
    "sum(l_quantity) as sq from mem.default.li "
    "group by l_returnflag, l_linestatus"
)
INGEST_DIRECT = (
    "select l_returnflag, l_linestatus, sum(l_extendedprice) as sp, "
    "count(*) as n, min(l_discount) as mn, max(l_discount) as mx, "
    "sum(l_quantity) as sq from mem.default.li "
    "group by l_returnflag, l_linestatus order by 1, 2"
)
INGEST_READ = (
    "select count(*) as n, sum(l_extendedprice) as s, sum(l_tax) as t "
    "from mem.default.li"
)


@contextlib.contextmanager
def lane_calls():
    """Records ``(gid, requests, nseg, lanes)`` of every
    ``onehot_reduce_lanes`` call (K1's batching rule) made while the
    block runs; each call still goes to the wrapper. Yields the list."""
    from presto_tpu_torch.ops import aggregation as PA

    seen = []
    real = PA.onehot_reduce_lanes

    def record(gid, requests, nseg, lanes):
        seen.append((gid, list(requests), nseg, lanes))
        return real(gid, requests, nseg, lanes)

    PA.onehot_reduce_lanes = record
    try:
        yield seen
    finally:
        PA.onehot_reduce_lanes = real


def lanes_case(label, gid, reqs, nseg, lanes, card, single_ms=None):
    """Hold K1's batching rule (``onehot_reduce_lanes``: one launch for
    every lane, the lane a grid axis of the kernel) against its plain
    version (one plain reduction per lane) on the card: integers exact,
    float64 sums within rel 1e-12 of each segment's sum of |x|; two
    runs bit-identical; the launches of one call counted; time it beside
    its bounds and a library yardstick over the lane-folded gid
    (``index_add_``, ``scatter_reduce_``). Two bounds: ``bound_ms``
    counts each distinct input byte once (the shared x once, for the
    rows some lane keeps, and each lane's gid once), ``bound_lane_ms``
    x once per lane, as ``page.tile_lanes`` lays it out and the kernel
    reads it. ``one_by_one_ms`` times the lanes' scalar calls one at a
    time (``onehot_reduce_many`` over each lane's slice of gid, x and
    validity, held equal to the batch on the integer requests);
    ``single_ms``, the time of one scalar call at a lane's shape in the
    same run, is printed beside it as ``lanes`` times that call."""
    import torch

    from presto_tpu_torch.ops import aggregation as PA

    before = PA.onehot_reduce.launches
    out = PA.onehot_reduce_lanes(gid, reqs, nseg, lanes)
    launches = PA.onehot_reduce.launches - before
    again = PA.onehot_reduce_lanes(gid, reqs, nseg, lanes)
    want = PA.onehot_reduce_lanes_plain(gid, reqs, nseg, lanes)
    torch.cuda.synchronize()
    check(torch.equal(out, again), f"{label}: two runs differ")
    check(launches == -(-len(reqs) // PA.K_MAX),
          f"{label}: {launches} launches for {len(reqs)} requests")
    rows = gid.shape[0] // lanes
    err = 0.0
    for got, exp, (op, x, valid) in zip(
        PA.onehot_results(out, reqs), PA.onehot_results(want, reqs), reqs
    ):
        if not got.is_floating_point():
            check(torch.equal(got, exp), f"{label}: {op} kernel != plain")
            continue
        scale = PA.onehot_reduce_lanes_plain(
            gid, [("sum", x.abs(), valid)], nseg, lanes)[0].view(
                torch.float64)
        diff = (got - exp).abs()
        err = max(err, float(diff.max()))
        check(bool((diff <= 1e-12 * scale).all()),
              f"{label}: float sum off by {float(diff.max())} (rel 1e-12)")
    g2 = gid.view(lanes, rows)
    live = (g2 >= 0) & (g2 < nseg)
    folded = torch.where(
        live,
        g2.to(torch.int64)
        + (torch.arange(lanes, device=gid.device) * nseg)[:, None],
        lanes * nseg,
    ).reshape(-1)
    library = library_yardstick(
        label, folded, reqs, lanes * nseg, PA.onehot_results(out, reqs))
    per_lane = [
        (gid[i * rows:(i + 1) * rows],
         [(op, None if x is None else x[i * rows:(i + 1) * rows],
           None if v is None else v[i * rows:(i + 1) * rows])
          for op, x, v in reqs])
        for i in range(lanes)
    ]

    def one_by_one():
        return [PA.onehot_reduce_many(g, rs, nseg) for g, rs in per_lane]

    batch = PA.onehot_results(out, reqs)
    for i, lane_out in enumerate(one_by_one()):
        for k, got in enumerate(PA.onehot_results(lane_out, per_lane[i][1])):
            if not got.is_floating_point():
                check(torch.equal(got, batch[k][i * nseg:(i + 1) * nseg]),
                      f"{label}: lane {i}'s scalar call != the batch's")
    ms = time_ms(lambda: PA.onehot_reduce_lanes(gid, reqs, nseg, lanes))
    one_by_one_ms = time_ms(one_by_one)
    plain_ms = time_ms(
        lambda: PA.onehot_reduce_lanes_plain(gid, reqs, nseg, lanes))
    library_ms = time_ms(library)
    n_any = int(live.any(dim=0).sum())
    n_live = int(live.sum())
    nbytes = nbytes_lane = 4 * gid.numel() + 8 * len(reqs) * lanes * nseg
    for op, x, valid in reqs:
        if valid is not None:
            nbytes += n_live
            nbytes_lane += n_live
        if x is not None:
            nbytes += x.element_size() * n_any
            nbytes_lane += x.element_size() * n_live
    b_ms, b_by = bound_ms(nbytes, n_live * len(reqs))
    lane_ms, lane_by = bound_ms(nbytes_lane, n_live * len(reqs))
    times_single = None if single_ms is None else lanes * single_ms
    rec = {
        "label": label, "rows": gid.numel(), "lanes": lanes, "nseg": nseg,
        "op": "+".join(op for op, _, _ in reqs), "dtype": "mixed",
        "k": len(reqs), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
        "bytes": nbytes, "bound_lane_ms": lane_ms, "bound_lane_by": lane_by,
        "bytes_lane": nbytes_lane, "launches_per_batch": launches,
        "single_ms": single_ms, "one_by_one_ms": one_by_one_ms,
    }
    versus = (f"{one_by_one_ms:.4f} ms, the batch "
              f"{'within' if ms <= one_by_one_ms else 'OVER'} it")
    if times_single is not None:
        versus += (f"; {lanes} x the single call {times_single:.4f} ms "
                   f"({lanes} x {single_ms:.4f} ms), the batch "
                   f"{'within' if ms <= times_single else 'OVER'} it")
    print(
        f"{label}: ok ({lanes} lanes x {nseg} segments, K={len(reqs)}, "
        f"{launches} launch(es), two runs bit-identical), max_abs_err "
        f"{err:.3g}; kernel {ms:.4f} ms, plain (per lane) {plain_ms:.4f} "
        f"ms, library {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{nbytes} B: x once, each lane's gid once), bound per lane "
        f"{lane_ms:.4f} ms ({lane_by}, {nbytes_lane} B: x once per lane); "
        f"the lanes one at a time {versus} [{card}]",
        flush=True,
    )
    return rec


def sf1_orders(schema: str):
    """The point-lookup columns of ``schema``'s orders, from the
    connector's own generator."""
    from presto_tpu_torch.connectors.tpch import SCHEMAS, TpchGenerator

    gen = TpchGenerator(SCHEMAS[schema])
    n = gen.counts["orders"]
    return n, gen.generate(
        "orders", 0, n,
        ["o_orderkey", "o_custkey", "o_totalprice", "o_orderdate"])


def serve_lineitem(schema: str):
    """Q1's and Q6's lineitem columns of ``schema`` (sf1: the slice
    phase's columns)."""
    if schema == "sf1":
        return sf1_lineitem()
    from presto_tpu_torch.connectors.tpch import SCHEMAS, TpchGenerator

    gen = TpchGenerator(SCHEMAS[schema])
    cols = [
        "l_quantity", "l_extendedprice", "l_discount", "l_tax",
        "l_returnflag", "l_linestatus", "l_shipdate",
    ]
    return gen.generate("lineitem", 0, gen.counts["lineitem"], cols)


def numpy_q1_cut(d, cutoff: int):
    """Q1 over the columns ``d`` with ``l_shipdate <= cutoff`` (epoch
    days): the rows as the paged protocol renders them, in the query's
    order, with the averages as floats."""
    import numpy as np

    qty = d["l_quantity"].astype(np.int64)
    price = d["l_extendedprice"].astype(np.int64)
    disc = d["l_discount"].astype(np.int64)
    tax = d["l_tax"].astype(np.int64)
    keep = d["l_shipdate"].astype(np.int64) <= cutoff
    rf, ls = d["l_returnflag"], d["l_linestatus"]
    key = rf.ids.astype(np.int64) * len(ls.values) + ls.ids
    rows = []
    for k in np.unique(key[keep]):
        m = keep & (key == k)
        n = int(m.sum())
        dp = price[m] * (100 - disc[m])
        rows.append((
            str(rf.values[k // len(ls.values)]),
            str(ls.values[k % len(ls.values)]),
            int(qty[m].sum()) / 100, int(price[m].sum()) / 100,
            int(dp.sum()) / 10**4,
            int((dp * (100 + tax[m])).sum()) / 10**6,
            int(qty[m].sum()) / 100 / n, int(price[m].sum()) / 100 / n,
            int(disc[m].sum()) / 100 / n, n,
        ))
    return rows


def serve_round(coord, name, shape, args, card):
    """``len(args)`` clients over HTTP, each PREPAREs ``shape`` for
    itself, then all EXECUTE at once (a barrier start). Returns (the
    client results, their coordinator stats, the round's seconds)."""
    import threading

    from presto_tpu_torch.server import PrestoTpuClient

    clients = []
    for _ in args:
        c = PrestoTpuClient(coord.uri, timeout_s=600)
        c.execute(f"prepare {name} from {shape}")
        clients.append(c)
    out, errors = [None] * len(args), []
    bar = threading.Barrier(len(args) + 1)

    def run(i):
        try:
            bar.wait(60)
            out[i] = clients[i].execute(f"execute {name} using {args[i]}")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=(i,)) for i in
               range(len(args))]
    for t in threads:
        t.start()
    bar.wait(60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(600)
    secs = time.perf_counter() - t0
    check(not errors and all(r is not None for r in out),
          f"{name}: a statement failed: {errors}")
    return out, [coord.queries[r.query_id].stats for r in out], secs


def ingest_batches(seed: int, batches: int, rows: int):
    """Seeded Q1-column batches for the ingest lane: numpy columns
    (scaled decimals, epoch days) and their JSON columnar payloads."""
    import datetime

    import numpy as np

    rng = np.random.default_rng(seed)
    epoch = datetime.date(1970, 1, 1)
    out = []
    for _ in range(batches):
        d = {
            "l_returnflag": rng.choice(np.array(["A", "N", "R"]), rows),
            "l_linestatus": rng.choice(np.array(["F", "O"]), rows),
            "l_quantity": rng.integers(100, 5001, rows),
            "l_extendedprice": rng.integers(90_000, 10_500_000, rows),
            "l_discount": rng.integers(0, 11, rows),
            "l_tax": rng.integers(0, 9, rows),
            "l_shipdate": rng.integers(8036, 10561, rows),
        }

        def dec(a):
            return [f"{v // 100}.{v % 100:02d}" for v in a.tolist()]

        payload = {
            "l_returnflag": d["l_returnflag"].tolist(),
            "l_linestatus": d["l_linestatus"].tolist(),
            "l_quantity": dec(d["l_quantity"]),
            "l_extendedprice": dec(d["l_extendedprice"]),
            "l_discount": dec(d["l_discount"]),
            "l_tax": dec(d["l_tax"]),
            "l_shipdate": [
                (epoch + datetime.timedelta(days=v)).isoformat()
                for v in d["l_shipdate"].tolist()
            ],
        }
        out.append((d, payload))
    return out


def numpy_ingest_view(cols):
    """The serve view's rows over the ingested columns, ordered by the
    keys, as the paged protocol renders them."""
    import numpy as np

    rf, ls = cols["l_returnflag"], cols["l_linestatus"]
    rows = []
    for f in sorted(set(rf.tolist())):
        for st in sorted(set(ls.tolist())):
            m = (rf == f) & (ls == st)
            if m.any():
                rows.append((
                    f, st, int(cols["l_extendedprice"][m].sum()) / 100,
                    int(m.sum()), int(cols["l_discount"][m].min()) / 100,
                    int(cols["l_discount"][m].max()) / 100,
                    int(cols["l_quantity"][m].sum()) / 100,
                ))
    return rows


def serve_phase(card: str, dev=None, records=None, schema: str = "sf1",
                wait_ms: int = SERVE_WAIT_MS):
    """The eleventh slice's path on ``dev`` (the card unless a CPU
    rehearsal passes another): one ``CoordinatorServer`` with no
    workers, the micro-batch queue and the result cache on and the
    ingest lane over a temporary WAL, driven over loopback HTTP by
    ``PrestoTpuClient``s. V1 16 concurrent point lookups over
    ``schema``'s orders (15 keys, one repeated); V2 8 concurrent Q6
    EXECUTEs; V3 8 concurrent Q1 EXECUTEs with shipdate cutoffs from
    1992 to 1998 (one batch: one K1 launch, held against its plain
    version), then the same 8 scalar; V4 the V3 statements again, all
    result-cache hits with no launch and no dispatch, and a new literal
    that misses (each round of 8 runs with ``microbatch_max`` 8, so its
    batch closes as soon as its 8 members joined); V5 a memory table of Q1's columns with an aggregate
    view, 8 seeded batches of 65,536 rows through
    ``POST /v1/ingest/{table}``, the cache's staleness contract, then a
    restart on the same WAL. Every answer is exact against numpy over
    the generator's columns or the ingested batches (Q1's averages
    within rel 1e-12). Returns (the onehot_reduce launches of the
    counted steps, the records)."""
    import datetime
    import tempfile

    import numpy as np
    import torch

    from presto_tpu_torch.connectors import create_connector
    from presto_tpu_torch.exec.staging import CatalogManager
    from presto_tpu_torch.ops import aggregation as PA
    from presto_tpu_torch.server import CoordinatorServer, PrestoTpuClient, rpc
    from presto_tpu_torch.session import NodeConfig, Session
    from presto_tpu_torch.utils.metrics import REGISTRY
    from presto_tpu_torch.utils.telemetry import device_snapshot

    dev = torch.device("cuda") if dev is None else dev
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    phase_t0 = time.perf_counter()
    out, launches = [], 0
    wal = tempfile.mkdtemp(prefix="serve-wal-")

    def boot():
        catalogs = CatalogManager()
        catalogs.register("tpch", create_connector("tpch"))
        catalogs.register("mem", create_connector("memory"))
        cfg = NodeConfig({
            "staging.cache-bytes": str(SERVER_CACHE_BYTES["worker"]),
            "query.max-memory-per-node": SERVER_POOL_BYTES["worker"],
            "serving.microbatch-wait-ms": str(wait_ms),
            "serving.microbatch-max": str(SERVE_MAX),
            "result-cache.enabled": "true",
            "ingest.wal-path": wal,
            "ingest.commit-interval-ms": "0",
        })
        coord = CoordinatorServer(
            config=cfg, catalogs=catalogs, device=dev,
            max_concurrent_queries=64,
            session=Session(schema=schema, properties={
                "max_fragment_weight": SERVE_FRAGMENT_WEIGHT}),
        ).start()
        return coord

    def counters():
        return (REGISTRY.counter("serving.batches").total,
                REGISTRY.counter("serving.batched_statements").total,
                REGISTRY.counter("serving.batch_errors").total,
                PA.onehot_reduce.launches,
                device_snapshot()["dispatches"])

    def step_line(label, secs, c0, stats, extra=""):
        nonlocal launches
        c1 = counters()
        n_launch = c1[3] - c0[3]
        launches += n_launch
        lanes = [st.batch_size for st in stats if st.batched]
        hits = sum(st.result_cache in ("hit", "stale") for st in stats)
        rec = {"step": label, "s": secs, "statements": len(stats),
               "batches": c1[0] - c0[0], "batched": c1[1] - c0[1],
               "lanes": lanes, "hits": hits,
               "onehot_reduce_launches": n_launch,
               "dispatches": c1[4] - c0[4]}
        out.append(rec)
        print(f"{label}: {secs:.4f} s, {len(stats)} statements, batches "
              f"{rec['batches']} serving {rec['batched']} lanes {lanes}, "
              f"cache hits {hits}, onehot_reduce launches {n_launch}, "
              f"device dispatches {rec['dispatches']}{extra} [{card}]",
              flush=True)
        check(c1[2] == c0[2], f"{label}: a batch failed")
        return rec

    t0 = time.perf_counter()
    coord = boot()
    print(f"serve boot: a coordinator with no worker on {dev} in "
          f"{time.perf_counter() - t0:.2f} s (window {wait_ms} ms, "
          f"at most {SERVE_MAX} a batch, result cache on, WAL {wal}) "
          f"[{card}]", flush=True)
    try:
        warm = PrestoTpuClient(coord.uri, timeout_s=600)
        epoch = datetime.date(1970, 1, 1)

        def days(iso):
            return (datetime.date.fromisoformat(iso) - epoch).days

        # V1: point lookups over orders
        n_orders, od = sf1_orders(schema)
        rng = np.random.default_rng(SERVE_SEED)
        idx = rng.choice(n_orders, 15, replace=False).tolist()
        idx = idx + [idx[3]]
        keys = [int(od["o_orderkey"][i]) for i in idx]
        shape = POINT_SHAPE.format(schema=schema)
        warm.execute(f"prepare v1 from {shape}")
        other = int(od["o_orderkey"][(idx[0] + 1) % n_orders])
        warm.execute(f"execute v1 using {other}")
        # V1 runs with the result cache off: when the 16 arrivals form
        # two batches, the repeated key's second statement must still
        # be served by a batch, not by the entry the first one stored
        coord.local.session.set("enable_result_cache", False)
        c0 = counters()
        try:
            res, stats, secs = serve_round(coord, "v1", shape,
                                           [str(k) for k in keys], card)
        finally:
            coord.local.session.set("enable_result_cache", True)
        rec = step_line("V1 16 point lookups", secs, c0, stats)
        for r, i in zip(res, idx):
            want = (int(od["o_orderkey"][i]), int(od["o_custkey"][i]),
                    int(od["o_totalprice"][i]) / 100,
                    (epoch + datetime.timedelta(
                        days=int(od["o_orderdate"][i]))).isoformat())
            check(r.rows() == [want], f"V1: {r.rows()} != [{want}]")
        check(all(st.batched for st in stats),
              "V1: a member was not served by the batch")
        check(rec["batched"] == 16 and rec["batches"] <= 2,
              f"V1: {rec['batches']} batches serving {rec['batched']}")

        # V2: Q6; from here on a round of 8 fills its batch
        coord.local.session.set("microbatch_max", 8)
        shape = Q6_SHAPE.format("?", "?", "?", "?", "?", schema=schema)
        warm.execute(f"prepare v2 from {shape}")
        warm.execute("execute v2 using date '1993-06-01', date "
                     "'1994-06-01', 0.05, 0.07, 24")
        args = [f"date '{a}', date '{b}', {lo}, {hi}, {q}"
                for a, b, lo, hi, q in Q6_SERVE]
        c0 = counters()
        res, stats, secs = serve_round(coord, "v2", shape, args, card)
        step_line("V2 8 Q6", secs, c0, stats)
        d_li = serve_lineitem(schema)
        for r, a in zip(res, Q6_SERVE):
            want = numpy_q6_of(d_li, a) / 10**4
            check(r.rows() == [(want,)], f"V2 {a}: {r.rows()} != {want}")
        check(all(st.batched for st in stats),
              "V2: a member was not served by the batch")

        # V3: Q1 with shipdate cutoffs, batched, then the same scalar
        shape = Q1_CUT_SHAPE.replace("tpch.sf1.", f"tpch.{schema}.")
        warm.execute(f"prepare v3 from {shape}")
        warm.execute("execute v3 using date '1998-09-02'")
        args = [f"date '{c}'" for c in Q1_CUTOFFS]
        c0 = counters()
        with lane_calls() as seen, counting_syncs(dev) as waits:
            res, stats, secs = serve_round(coord, "v3", shape, args, card)
        rec = step_line("V3 8 Q1", secs, c0, stats,
                        f", host waits {waits[0]}")
        v3_rows = [r.rows() for r in res]
        for rows, c in zip(v3_rows, Q1_CUTOFFS):
            diff = rows_close(rows, numpy_q1_cut(d_li, days(c)), rel=1e-12)
            check(diff is None, f"V3 {c}: differs from numpy ({diff})")
        check(all(st.batched for st in stats),
              "V3: a member was not served by the batch")
        check(rec["batches"] == 1 and len(seen) == 1,
              f"V3: {rec['batches']} batches, {len(seen)} lane calls")
        check(rec["onehot_reduce_launches"] == (1 if on_card else 0),
              f"V3: {rec['onehot_reduce_launches']} K1 launches, not 1")
        rec["host_waits"] = waits[0]
        scalar_s, scalar_waits = [], []
        PA.onehot_reduce.launches = 0
        for c, rows in zip(Q1_CUTOFFS, v3_rows):
            with counting_syncs(dev) as w:
                t0 = time.perf_counter()
                got = coord.local.execute(f"execute v3 using date '{c}'")
                if on_card:
                    torch.cuda.synchronize()
                scalar_s.append(time.perf_counter() - t0)
            scalar_waits.append(w[0])
            diff = rows_close(server_rows(got.rows()), rows, rel=1e-12)
            check(diff is None, f"V3 scalar {c}: differs ({diff})")
        scalar_launches = PA.onehot_reduce.launches
        check(scalar_launches == (8 if on_card else 0),
              f"V3 scalar: {scalar_launches} K1 launches, not 8")
        rec.update(scalar_s=scalar_s, scalar_waits=scalar_waits,
                   scalar_launches=scalar_launches)
        print(f"V3 scalar: the same 8 one at a time {sum(scalar_s):.4f} s "
              f"(each {[round(x, 4) for x in scalar_s]}), host waits "
              f"{scalar_waits}, onehot_reduce launches {scalar_launches}; "
              f"the batch {secs:.4f} s with {waits[0]} host waits in all "
              f"(the arrivals into its window included) [{card}]",
              flush=True)
        if records is not None and on_card:
            single = next((r["ms"] for r in records
                           if r["label"] == "q1 fused"), None)
            records.append(lanes_case("q1 microbatch fused", *seen[0], card,
                                      single_ms=single))
        del seen
        check(not coord.local._no_batch, "a shape was retired from batching")

        # V4: the V3 statements again from the result cache
        c0 = counters()
        res, stats, secs = serve_round(coord, "v3", shape, args, card)
        rec = step_line("V4 8 Q1 again", secs, c0, stats)
        check(all(st.result_cache == "hit" for st in stats),
              f"V4: {[st.result_cache for st in stats]}")
        check(rec["onehot_reduce_launches"] == 0 and rec["dispatches"] == 0,
              "V4: a cache hit touched the card")
        check([r.rows() for r in res] == v3_rows, "V4: rows moved")
        t0 = time.perf_counter()
        got = warm.execute("execute v3 using date '1996-01-01'")
        secs = time.perf_counter() - t0
        st = coord.queries[got.query_id].stats
        check(st.result_cache == "miss", "V4: a new literal hit")
        diff = rows_close(got.rows(), numpy_q1_cut(d_li, days("1996-01-01")),
                          rel=1e-12)
        check(diff is None, f"V4 new literal: {diff}")
        print(f"V4 new literal: a miss, {secs:.4f} s (planning ms "
              f"{st.planning_ms:.1f}, execution ms {st.execution_ms:.1f}, "
              f"staging ms {st.staging_ms:.1f}, the {wait_ms} ms window "
              f"of a lone leader) [{card}]", flush=True)

        # V5: the ingest lane, the view, the cache's staleness contract
        t5 = time.perf_counter()
        warm.execute(INGEST_DDL)
        warm.execute(INGEST_VIEW)
        batches = ingest_batches(SERVE_SEED, SERVE_INGEST_BATCHES,
                                 SERVE_INGEST_ROWS)
        url = f"{coord.uri}/v1/ingest/mem.default.li"

        def post(i):
            got = rpc.call_json("POST", url, {"columns": batches[i][1]})
            check(got["rows"] == SERVE_INGEST_ROWS, f"V5 batch {i}: {got}")

        def flush(label):
            c0 = counters()
            t0 = time.perf_counter()
            coord.ingest.flush()
            if on_card:
                torch.cuda.synchronize()
            n_launch = counters()[3] - c0[3]
            check(n_launch == (1 if on_card else 0),
                  f"V5 {label}: {n_launch} K1 launches in the delta merge")
            return time.perf_counter() - t0, n_launch

        def cols_upto(k):
            return {c: np.concatenate([b[0][c] for b in batches[:k]])
                    for c in batches[0][0]}

        def want_read(k):
            d = cols_upto(k)
            return [(len(d["l_tax"]), int(d["l_extendedprice"].sum()) / 100,
                     int(d["l_tax"].sum()) / 100)]

        def read(label, want, status):
            got = warm.execute(INGEST_READ)
            st = coord.queries[got.query_id].stats
            check(got.rows() == want, f"V5 {label}: {got.rows()} != {want}")
            check(st.result_cache == status,
                  f"V5 {label}: cache {st.result_cache}, not {status}")

        merges = []
        t0 = time.perf_counter()
        for i in range(4):
            post(i)
        merges.append(flush("commit 1"))
        read("after commit 1", want_read(4), "miss")
        read("again", want_read(4), "hit")
        for i in range(4, 7):
            post(i)
        merges.append(flush("commit 2"))
        read("after commit 2 at staleness 0", want_read(7), "miss")
        coord.local.session.set("result_cache_max_staleness_s", 30.0)
        read("cached", want_read(7), "hit")
        post(7)
        merges.append(flush("commit 3"))
        refreshes = coord.result_cache.stats()["refreshes"]
        read("after commit 3 at staleness 30", want_read(7), "stale")
        deadline = time.monotonic() + 60
        while (coord.result_cache.stats()["refreshes"] == refreshes
               and time.monotonic() < deadline):
            time.sleep(0.02)
        check(coord.result_cache.stats()["refreshes"] == refreshes + 1,
              "V5: the stale entry was not refreshed once")
        read("refreshed", want_read(8), "hit")
        coord.local.session.set("result_cache_max_staleness_s", 0.0)
        ingest_s = time.perf_counter() - t0
        want_view = numpy_ingest_view(cols_upto(8))
        view = warm.execute(
            "select * from mem.default.li_mv order by 1, 2").rows()
        direct = warm.execute(INGEST_DIRECT).rows()
        check(view == want_view, f"V5: the view {view} != numpy")
        check(direct == want_view, "V5: the direct aggregate != numpy")
        st = coord.ingest.stats()
        frames = sum(
            1 for name in os.listdir(wal) if name.startswith("wal-")
            for _ in open(os.path.join(wal, name), encoding="utf-8"))
        rec = {"step": "V5 ingest", "s": ingest_s,
               "rows": SERVE_INGEST_BATCHES * SERVE_INGEST_ROWS,
               "batches": st["batches"], "commits": st["commits"],
               "wal_frames": frames, "wal_bytes": st["wal_bytes"],
               "merges": merges}
        launches += sum(n for _, n in merges)
        out.append(rec)
        print(f"V5 ingest: {rec['rows']} rows in {st['batches']} batches "
              f"over HTTP, {st['commits']} commits, {frames} WAL frames "
              f"({st['wal_bytes']} B), {ingest_s:.4f} s; delta merges "
              f"s / K1 launches {merges}; the view equals the direct "
              f"aggregate and numpy; staleness: miss at 0, stale then one "
              f"refresh at 30 s [{card}]", flush=True)
    finally:
        coord.shutdown()

    # the restart: a second coordinator replays the same WAL
    t0 = time.perf_counter()
    coord = boot()
    try:
        client = PrestoTpuClient(coord.uri, timeout_s=600)
        got = client.execute(INGEST_READ).rows()
        check(got == want_read(8), f"V5 restart: {got}")
        view = client.execute(
            "select * from mem.default.li_mv order by 1, 2").rows()
        check(view == want_view, f"V5 restart: the view {view}")
        secs = time.perf_counter() - t0
        out.append({"step": "V5 restart", "s": secs})
        print(f"V5 restart: a second coordinator on the same WAL in "
              f"{secs:.4f} s, rows and view exact [{card}]", flush=True)
    finally:
        coord.shutdown()
    secs = time.perf_counter() - phase_t0
    print(f"serve phase: {secs:.2f} s, onehot_reduce launches {launches} "
          f"[{card}]", flush=True)
    out.append({"step": "phase", "s": secs})
    return launches, out


# ------------------------------------------------------------ recover phase

#: the recover phase's peer lease TTL: a killed coordinator's lease
#: expires this long after its last renewal, then a survivor claims it
RECOVER_LEASE_TTL_S = 0.75
#: split caches and pools of the recover phase's nodes (its steps run at
#: SF1; one step's nodes are shut down before the next boots)
RECOVER_CACHE_BYTES = 4 << 30
RECOVER_POOL = "16GB"


def recover_phase(card: str, dev=None, schema: str = "sf1"):
    """The twelfth slice's path on ``dev`` (the card unless a CPU
    rehearsal passes another): fault-tolerant execution, every spool,
    journal and control directory under one temporary directory that
    the phase removes. R1 Q1 over ``schema`` on a coordinator and two
    workers with ``retry-policy=TASK`` and a shared spool, a
    ``kill_worker`` rule on one worker's second producer task: the lost
    range re-runs on the survivor as attempt a1, the dead worker's merge
    partition re-runs there too and re-reads its committed producer from
    the spool; K1 launches on the retried producer's batches and on the
    merges. R2 a partitioned Q3 with the worker killed as its join task
    starts: its join partition re-runs on the survivor over the dead
    worker's spooled producer partitions. R3 ``retry_policy=QUERY`` with
    no task-retry budget: a killed worker restarts the whole Q1. R4 a
    coordinator with ``coordinator.journal-path``, 4 Q1s QUEUED behind
    held admission, shut down and replaced on the same port and journal
    while 4 paginating clients ride the bounce. R5 two coordinators with
    ``coordinator.peers`` on one control directory, ``kill_coordinator``
    on coord-0 as a Q1 is admitted: the survivor claims the dead lease,
    resumes the query and resolves its statement id by alias. Every
    answer equals the port's local runner. One line per step: seconds
    and seconds from the fault to the last answer, K1 launches, tasks
    retried, spool frames and bytes written and re-served, query
    restarts, resumed queries, failover claims. Returns (the
    onehot_reduce launches of the counted steps, the records)."""
    import shutil
    import tempfile
    import threading

    import torch

    from presto_tpu_torch.ops import aggregation as PA
    from presto_tpu_torch.server import (
        CoordinatorServer,
        PrestoTpuClient,
        WorkerServer,
        task_ids,
    )
    from presto_tpu_torch.session import NodeConfig, Session
    from presto_tpu_torch.utils import faults
    from presto_tpu_torch.utils.metrics import REGISTRY

    dev = torch.device("cuda") if dev is None else dev
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    phase_t0 = time.perf_counter()
    out, launches = [], 0
    root = tempfile.mkdtemp(prefix="recover-")
    q1 = Q1.replace("tpch.sf1.lineitem", f"tpch.{schema}.lineitem")
    counters = {
        "tasks_retried": "coordinator.tasks_retried",
        "spool_frames_written": "spool.pages_written",
        "spool_bytes_written": "spool.bytes_written",
        "spool_frames_served": "spool.pages_served",
        "spool_bytes_served": "spool.bytes_served",
        "query_restarts": "coordinator.query_restarts",
        "resumed_queries": "coordinator.resumed_queries",
        "failover_claims": "coordinator.failover_claims",
    }

    def node_config(extra):
        return NodeConfig({
            "staging.cache-bytes": str(RECOVER_CACHE_BYTES),
            "query.max-memory-per-node": RECOVER_POOL,
            **extra,
        })

    def coordinator(extra, **kw):
        return CoordinatorServer(
            config=node_config(extra), device=dev,
            session=Session(schema=schema), **kw,
        )

    def cluster(extra, worker_extra):
        coord = coordinator(extra).start()
        workers = [
            WorkerServer(coordinator_uri=coord.uri,
                         config=node_config(worker_extra),
                         device=dev).start()
            for _ in range(2)
        ]
        wait_for(lambda: len(coord.active_workers()) == 2,
                 "the workers did not announce themselves")
        return coord, workers

    def free_ports(n):
        import socket

        socks = [socket.socket() for _ in range(n)]
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        ports = [sk.getsockname()[1] for sk in socks]
        for sk in socks:
            sk.close()
        return ports

    def wait_for(cond, msg, timeout=120.0):
        deadline = time.monotonic() + timeout
        while not cond() and time.monotonic() < deadline:
            time.sleep(0.01)
        check(cond(), msg)

    def timed_fault(node):
        """Record when ``node``'s fault-plane kill fires."""
        fired = {}
        kill = node._fault_kill

        def record():
            fired.setdefault("t", time.perf_counter())
            kill()

        node._fault_kill = record
        return fired

    @contextlib.contextmanager
    def k1_by_task(workers):
        """Every ``onehot_reduce_many`` call of the block, keyed by the
        worker task whose thread made it ("" on the coordinator)."""
        calls = []
        real = PA.onehot_reduce_many

        def record(gid, requests, nseg):
            tid = ""
            for w in workers:
                st = getattr(w.runner._qs_local, "value", None)
                if st is not None:
                    tid = st.task_id
            calls.append((tid, len(requests)))
            return real(gid, requests, nseg)

        PA.onehot_reduce_many = record
        try:
            yield calls
        finally:
            PA.onehot_reduce_many = real

    def k1_launches(calls):
        return sum(-(-k // PA.K_MAX) for _, k in calls) if on_card else 0

    def step(label, run, fired=None):
        """Run one step with the K1 count and the counters read around
        it; print and record its line."""
        nonlocal launches
        before = {k: REGISTRY.counter(n).total for k, n in counters.items()}
        PA.onehot_reduce.launches = 0
        t0 = time.perf_counter()
        rec = run() or {}
        t1 = time.perf_counter()
        n_launch = PA.onehot_reduce.launches
        launches += n_launch
        rec = {"step": label, "s": t1 - t0,
               "recover_s": (t1 - fired["t"]) if fired and "t" in fired
               else None,
               "onehot_reduce_launches": n_launch,
               **{k: int(REGISTRY.counter(n).total - before[k])
                  for k, n in counters.items()},
               **rec}
        out.append(rec)
        extra = {k: v for k, v in rec.items()
                 if k not in ("step", "s", "recover_s")}
        recover = ("" if rec["recover_s"] is None
                   else f", {rec['recover_s']:.4f} s from the fault to the "
                   "last answer")
        print(f"{label}: {rec['s']:.4f} s{recover}, "
              + ", ".join(f"{k} {v}" for k, v in extra.items())
              + f" [{card}]", flush=True)
        return rec

    def shut(coords=(), workers=()):
        faults.configure(None)
        for w in workers:
            w.shutdown(graceful=False)
        for c in coords:
            c.shutdown()

    want = {}
    try:
        # R1: TASK recovery of the shuffled Q1 over the spool
        spool = os.path.join(root, "spool-r1")
        coord, workers = cluster(
            {"retry-policy": "TASK", "exchange.spool-path": spool},
            {"exchange.spool-path": spool})
        try:
            t0 = time.perf_counter()
            want["q1"] = server_rows(coord.local.execute(q1).rows())
            print(f"Q1 {schema} on the coordinator's local runner: "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
            victim, survivor = workers
            fired = timed_fault(victim)
            client = PrestoTpuClient(coord.uri, timeout_s=900)

            def r1():
                faults.configure({"rules": [
                    {"action": "kill_worker", "node": victim.node_id,
                     "task": ".prod.", "skip": 1, "count": 1},
                ]})
                with k1_by_task(workers) as calls:
                    res = client.execute(q1)
                diff = rows_close(res.rows(), want["q1"])
                check(diff is None, f"R1: Q1 differs from the local runner "
                      f"({diff})")
                check("t" in fired, "R1: the kill_worker rule never fired")
                info = client.query_info(res.query_id)
                by_kind = {}
                for st in info["stages"]:
                    for t in st["tasks"]:
                        by_kind.setdefault(st["kind"], {}).setdefault(
                            task_ids.logical_key(t["task_id"]), []
                        ).append(t["task_id"])
                retried_prod = [a for a in by_kind["producer"].values()
                                if len(a) > 1]
                retried_merge = [a for a in by_kind["merge"].values()
                                 if len(a) > 1]
                check(retried_prod and retried_merge,
                      f"R1: no producer or merge re-ran: {by_kind}")
                check(info["spool_pages_served"] > 0,
                      "R1: nothing was re-served from the spool")
                retried = {tid for a in retried_prod for tid in a
                           if task_ids.attempt_of(tid) > 0}
                on_retry = [c for c in calls if c[0] in retried]
                on_merge = [c for c in calls if ".merge." in c[0]]
                check(on_retry and on_merge,
                      "R1: no one-hot call on the retried producer or the "
                      "merges")
                if on_card:
                    check(PA.onehot_reduce.launches == k1_launches(calls),
                          f"R1: {PA.onehot_reduce.launches} launches, "
                          f"expected {k1_launches(calls)}")
                return {"task_recoveries": info["task_recoveries"],
                        "retried_producer_k1": k1_launches(on_retry),
                        "merge_k1": k1_launches(on_merge),
                        "retried": sorted(retried)}

            step(f"R1 Q1 {schema} TASK, a worker killed mid-producer", r1,
                 fired)
        finally:
            shut([coord], workers)

        # R2: a partitioned Q3, the worker killed as its join task starts
        spool = os.path.join(root, "spool-r2")
        coord, workers = cluster(
            {"retry-policy": "TASK", "exchange.spool-path": spool},
            {"exchange.spool-path": spool})
        try:
            coord.local.session.set("join_distribution_type", "PARTITIONED")
            want["q3"] = server_rows(coord.local.execute(Q3).rows())
            victim = workers[0]
            fired = timed_fault(victim)
            client = PrestoTpuClient(coord.uri, timeout_s=900)

            def r2():
                faults.configure({"rules": [
                    {"action": "kill_worker", "node": victim.node_id,
                     "task": ".join.", "count": 1},
                ]})
                res = client.execute(Q3)
                diff = rows_close(res.rows(), want["q3"])
                check(diff is None, f"R2: Q3 differs from the local runner "
                      f"({diff})")
                check("t" in fired, "R2: the kill_worker rule never fired")
                info = client.query_info(res.query_id)
                kinds = [st["kind"] for st in info["stages"]]
                check(kinds.count("producer") >= 2 and "join" in kinds,
                      f"R2: stages {kinds}")
                join = next(st for st in info["stages"]
                            if st["kind"] == "join")
                check(any(task_ids.attempt_of(t["task_id"]) > 0
                          for t in join["tasks"]),
                      "R2: no join task re-ran")
                check(info["spool_pages_served"] > 0,
                      "R2: nothing was re-served from the spool")
                return {"task_recoveries": info["task_recoveries"],
                        "stages": kinds}

            step(f"R2 Q3 {schema} partitioned, a worker killed mid-join", r2,
                 fired)
        finally:
            shut([coord], workers)

        # R3: QUERY restart of Q1 after a killed worker, under the
        # default breaker cool-off: the restart schedules on no node
        # whose failure failed the attempt
        coord, workers = cluster(
            {"retry-policy": "QUERY", "failure-detector.threshold": "1"},
            {})
        try:
            coord.local.session.set("task_retry_budget", 0)
            fired = timed_fault(workers[1])
            client = PrestoTpuClient(coord.uri, timeout_s=900)

            def r3():
                faults.configure({"rules": [
                    {"action": "kill_worker", "node": workers[1].node_id,
                     "count": 1},
                ]})
                res = client.execute(q1)
                diff = rows_close(res.rows(), want["q1"])
                check(diff is None, f"R3: Q1 differs from the local runner "
                      f"({diff})")
                info = client.query_info(res.query_id)
                check(info["query_restarts"] >= 1,
                      "R3: the query did not restart")
                return {"query_info_restarts": info["query_restarts"]}

            rec = step(f"R3 Q1 {schema} QUERY, a worker killed", r3, fired)
            check(rec["query_restarts"] >= 1, "R3: no coordinator restart")
        finally:
            shut([coord], workers)

        # R4: a coordinator bounce over its journal, 4 clients riding it
        journal = os.path.join(root, "journal-r4")
        c1 = coordinator({"coordinator.journal-path": journal}).start()
        port = c1.port
        held = 0
        while c1._admit.acquire(blocking=False):
            held += 1  # every admission slot: submissions stay QUEUED
        results, errors, acked = [None] * 4, [], threading.Barrier(5)

        def ride(i):
            client = PrestoTpuClient(f"http://127.0.0.1:{port}",
                                     timeout_s=900, reconnect_attempts=200)
            get_page = client._get_with_reconnect
            first = []

            def page(url, deadline):
                if not first:
                    first.append(1)
                    acked.wait(60)  # the statement id is in hand
                return get_page(url, deadline)

            client._get_with_reconnect = page
            try:
                results[i] = client.execute(q1).rows()
            except Exception as e:  # checked below
                errors.append(e)

        riders = [threading.Thread(target=ride, args=(i,)) for i in range(4)]
        c2 = None
        try:
            def r4():
                nonlocal c2
                for t in riders:
                    t.start()
                acked.wait(60)  # every client holds its statement id
                queued = [q for q in c1.queries.values()
                          if q.state == "QUEUED"]
                check(len(queued) == 4, f"R4: {len(queued)} queries QUEUED")
                t_fault = time.perf_counter()
                reconnects = REGISTRY.counter("client.reconnects").total
                c1.shutdown()
                wait_for(lambda: REGISTRY.counter("client.reconnects").total
                         > reconnects, "R4: no client reconnected")
                c2 = CoordinatorServer(
                    port=port, config=node_config(
                        {"coordinator.journal-path": journal}),
                    device=dev, session=Session(schema=schema)).start()
                for t in riders:
                    t.join(600)
                check(not errors, f"R4: a client died across the bounce: "
                      f"{errors}")
                for rows in results:
                    diff = rows_close(rows, want["q1"])
                    check(diff is None, f"R4: Q1 differs ({diff})")
                check(c2.resumed_queries == 4,
                      f"R4: {c2.resumed_queries} queries resumed, not 4")
                for q in queued:
                    check(c2.lookup_query(q.qid) is not None,
                          f"R4: {q.qid} does not resolve after the bounce")
                return {"recover_s": time.perf_counter() - t_fault,
                        "resumed": c2.resumed_queries}

            step(f"R4 4 Q1 {schema} across a coordinator bounce", r4)
        finally:
            # the dead incarnation's queued threads end without touching
            # the journal the new one owns
            c1.journal = None
            for q in list(c1.queries.values()):
                q.fail("coordinator shut down")
                q.done.set()
            for _ in range(held):
                c1._admit.release()
            shut([c for c in (c2,) if c is not None])

        # R5: a peer failover under kill_coordinator
        ctl = os.path.join(root, "ctl-r5")
        ports = free_ports(2)  # each peer's list names the other's URI
        uris = [f"http://127.0.0.1:{p}" for p in ports]
        peers = [
            CoordinatorServer(
                port=ports[i],
                config=node_config({
                    "node.id": f"coord-{i}",
                    "coordinator.journal-path": ctl,
                    "coordinator.peers": uris[1 - i],
                    "lease.ttl-s": str(RECOVER_LEASE_TTL_S),
                }),
                device=dev, session=Session(schema=schema),
            ).start()
            for i in range(2)
        ]
        try:
            c0, c1 = peers
            fired = timed_fault(c0)

            def r5():
                faults.configure({"rules": [
                    {"action": "kill_coordinator", "node": "coord-0",
                     "count": 1},
                ]})
                client = PrestoTpuClient(uris, timeout_s=900,
                                         reconnect_attempts=200)
                res = client.execute(q1)
                diff = rows_close(res.rows(), want["q1"])
                check(diff is None, f"R5: Q1 differs ({diff})")
                check("t" in fired, "R5: kill_coordinator never fired")
                wait_for(lambda: c1.failover_resumed == 1,
                         "R5: the survivor resumed nothing")
                check(c1.failover_claims == 1,
                      f"R5: {c1.failover_claims} failover claims")
                (dead,) = [q.qid for q in c0.queries.values()]
                alias = c1.lookup_query(dead)
                check(alias is not None and alias.qid != dead,
                      f"R5: {dead} does not resolve through an alias")
                check(alias.done.wait(600) and alias.state == "FINISHED",
                      f"R5: the resumed query ended {alias.state}")
                diff = rows_close([tuple(r) for r in alias.rows], want["q1"])
                check(diff is None, f"R5: the resumed Q1 differs ({diff})")
                return {"failover_resumed": c1.failover_resumed,
                        "dead_qid": dead, "resumed_as": alias.qid}

            step(f"R5 Q1 {schema} peer failover, coord-0 killed", r5, fired)
        finally:
            shut(peers)
    finally:
        faults.configure(None)
        shutil.rmtree(root, ignore_errors=True)
        if on_card:
            torch.cuda.empty_cache()
    secs = time.perf_counter() - phase_t0
    print(f"recover phase: {secs:.2f} s, onehot_reduce launches {launches} "
          f"[{card}]", flush=True)
    out.append({"step": "phase", "s": secs})
    return launches, out


# --------------------------------------------------------------- qos phase

#: the qos phase's two lanes: interactive strictly above batch
QOS_GROUPS = {
    "rootGroups": [
        {"name": "interactive", "weight": 1, "hardConcurrencyLimit": 16,
         "priority": 10},
        {"name": "batch", "weight": 1, "hardConcurrencyLimit": 16,
         "priority": 0},
    ],
    "selectors": [{"user": "inter-.*", "group": "interactive"}],
    "defaultGroup": "batch",
}
#: the interactive burst of P1
QOS_BURST = 8
#: each of the analytic Q1's producer tasks is held this long (a fault
#: rule scoped to its query id), so that ranges are still unclaimed when
#: the burst arrives
QOS_PRODUCER_DELAY_S = 0.3
#: a preemptible worker's drain window
QOS_PREEMPT_GRACE_S = 10.0
#: the pool of P4: bounds and control cadence
QOS_POOL = {"pool.min-workers": "1", "pool.max-workers": "3",
            "pool.scale-interval-s": "0.25", "pool.scale-down-ticks": "2",
            "pool.cooldown-s": "0.5"}
QOS_CACHE_BYTES = {"coordinator": 4 << 30, "worker": 8 << 30}
QOS_POOL_BYTES = "16GB"


def qos_phase(card: str, want_q1_big=None, dev=None, big: str = JOINS_SCHEMA,
              small: str = "sf1"):
    """The thirteenth slice's path on ``dev`` (the card unless a CPU
    rehearsal passes another): the QoS plane and the elastic pool, every
    spool, journal and control directory under one temporary directory
    that the phase removes. Cluster A: a coordinator with ``qos.enabled``
    and one admission slot (lanes ``interactive``, priority 10, and
    ``batch``, priority 0), ``retry-policy=TASK`` over a shared spool and
    a journal, two stable workers, at the default RPC timeouts (a connect
    to a killed worker's port is bounded by ``rpc.CONNECT_TIMEOUT_S``).
    P0 Q1 over ``big`` and Q6 over ``small``
    unpreempted (the warm-up). P1 Q1 over ``big`` in the batch lane
    (its producers held ``QOS_PRODUCER_DELAY_S`` each), then
    ``QOS_BURST`` concurrent Q6 over ``small`` in the interactive lane:
    Q1 suspends, the burst finishes before it resumes, it finishes exact
    with no producer re-run; before it the same burst behind the same Q1
    with the plane off (the controller set aside: the semaphore path of
    ``qos.enabled=false``), and the interactive p99 must be lower with
    the plane on. P2 a ``suspend_storm`` of 3 against Q1 under a 60 s
    resume grace: exactly 1 suspension. P3 one worker killed while Q1 is
    suspended behind an interactive Q6: no query fails and Q1's merges
    re-read the dead producers' committed partitions from the spool.
    Cluster B: a coordinator with ``pool.max-workers=3``, one stable
    worker and the autoscaler over ``LocalWorkerPoolProvider`` on ``dev``.
    P4 3 concurrent clients of Q1 over ``small`` with one admission
    slot: preemptible workers spawn on ``dev``, show SCALING_UP, then
    STABLE, take batches (K1 on their tasks), and drain when idle with no
    scale-up after the load. P5 back on cluster A with a preemptible
    worker beside the survivor: ``kill_worker_preempt`` on its first
    producer task during Q1 over ``big``; it drains within
    ``QOS_PREEMPT_GRACE_S``, the ranges after the notice go to the stable
    node, the merges run there only, and no query fails.
    ``want_q1_big``: the port's local result of Q1 over ``big`` (the
    stream phase's); None runs it on the coordinator's runner. Returns
    (the onehot_reduce launches of the steps, the records)."""
    import shutil
    import tempfile
    import threading

    import torch

    from presto_tpu_torch.ops import aggregation as PA
    from presto_tpu_torch.server import (
        CoordinatorServer,
        PrestoTpuClient,
        WorkerServer,
        task_ids,
    )
    from presto_tpu_torch.server.launcher import LocalWorkerPoolProvider
    from presto_tpu_torch.session import NodeConfig, Session
    from presto_tpu_torch.utils import faults
    from presto_tpu_torch.utils.metrics import REGISTRY, DistributionStat

    dev = torch.device("cuda") if dev is None else dev
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    phase_t0 = time.perf_counter()
    out, launches = [], 0
    root = tempfile.mkdtemp(prefix="qos-")
    q1_big = Q1.replace("tpch.sf1.lineitem", f"tpch.{big}.lineitem")
    q1_small = Q1.replace("tpch.sf1.lineitem", f"tpch.{small}.lineitem")
    q6_small = Q6.replace("tpch.sf1.lineitem", f"tpch.{small}.lineitem")
    counters = {
        "suspensions": "qos.suspensions",
        "resumes": "qos.resumes",
        "preempt_triggers": "qos.preempt_triggers",
        "tasks_retried": "coordinator.tasks_retried",
        "spool_frames_served": "spool.pages_served",
        "workers_spawned": "pool.scale_up",
        "workers_drained": "pool.scale_down",
        "preemptions": "pool.preemptions",
        "drain_reroutes": "coordinator.drain_reroutes",
        "rpc_retries": "rpc.retries",
    }
    spool = os.path.join(root, "spool")

    def node_config(kind, extra=None):
        return NodeConfig({
            "staging.cache-bytes": str(QOS_CACHE_BYTES[kind]),
            "query.max-memory-per-node": QOS_POOL_BYTES,
            "exchange.spool-path": spool,
            "pool.preempt-grace-s": str(QOS_PREEMPT_GRACE_S),
            **(extra or {}),
        })

    def wait_for(cond, msg, timeout=120.0):
        deadline = time.monotonic() + timeout
        while not cond() and time.monotonic() < deadline:
            time.sleep(0.005)
        check(cond(), msg)

    def worker(coord, **kw):
        return WorkerServer(coordinator_uri=coord.uri,
                            config=node_config("worker"), device=dev,
                            **kw).start()

    def run_async(coord, sql, user):
        """``sql`` over HTTP as ``user`` on a thread; returns (the
        thread, its result holder, its errors)."""
        holder, errors = {}, []

        def run():
            try:
                client = PrestoTpuClient(coord.uri, timeout_s=900, user=user)
                holder["res"] = client.execute(sql)
            except Exception as e:  # checked by the caller
                errors.append(e)

        t = threading.Thread(target=run)
        t.start()
        return t, holder, errors

    def query_of(coord, user):
        """The coordinator's query submitted by ``user`` (one each)."""
        found = []

        def look():
            found[:] = [q for q in list(coord.queries.values())
                        if getattr(q, "user", None) == user]
            return bool(found)

        wait_for(look, f"no query from {user}", 60)
        return found[0]

    def hold_producers(q):
        faults.configure({"rules": [
            {"action": "delay", "task": f"{q.qid}.prod.",
             "delay_s": QOS_PRODUCER_DELAY_S},
        ]})

    def producer_finished(q, node_id=None):
        """Has a producer task of ``q`` finished (committed its spooled
        output) on a worker (on ``node_id``, if given)? Read off the
        workers: the coordinator folds task states at the stage's end."""
        return any(
            tid.startswith(f"{q.qid}.prod.") and t.state == "FINISHED"
            for w in workers
            if node_id is None or w.node_id == node_id
            for tid, t in list(w.tasks.items())
        )

    def producer_reruns(coord, q):
        info = coord.query_info(q)
        return sum(
            1 for st in info["stages"] if st["kind"] == "producer"
            for t in st["tasks"] if task_ids.attempt_of(t["task_id"]) > 0
        )

    def join_all(threads, errors, what):
        for t in threads:
            t.join(900)
        check(not errors, f"{what}: a query failed: {errors}")

    def step(label, run):
        """Run one step with the K1 count and the counters read around
        it; print and record its line."""
        nonlocal launches
        before = {k: REGISTRY.counter(n).total for k, n in counters.items()}
        PA.onehot_reduce.launches = 0
        t0 = time.perf_counter()
        rec = run() or {}
        secs = time.perf_counter() - t0
        n_launch = PA.onehot_reduce.launches
        launches += n_launch
        rec = {"step": label, "s": secs, "onehot_reduce_launches": n_launch,
               **{k: int(REGISTRY.counter(n).total - before[k])
                  for k, n in counters.items()},
               **rec}
        out.append(rec)
        extra = {k: v for k, v in rec.items() if k not in ("step", "s")}
        print(f"{label}: {secs:.4f} s, "
              + ", ".join(f"{k} {v}" for k, v in extra.items())
              + f" [{card}]", flush=True)
        return rec

    coord = coord_b = None
    workers, pool_prov = [], None
    try:
        coord = CoordinatorServer(
            config=node_config("coordinator", {
                "qos.enabled": "true", "qos.resume-grace-s": "0.2",
                "retry-policy": "TASK",
                "coordinator.journal-path": os.path.join(root, "journal"),
            }),
            device=dev, session=Session(schema=small),
            max_concurrent_queries=1, resource_groups=QOS_GROUPS,
        ).start()
        workers = [worker(coord) for _ in range(2)]
        wait_for(lambda: len(coord.active_workers()) == 2,
                 "the workers did not announce themselves")
        t0 = time.perf_counter()
        if want_q1_big is None:
            want_q1_big = coord.local.execute(q1_big).rows()
        want = {"q1_big": server_rows(want_q1_big),
                "q6": server_rows(coord.local.execute(q6_small).rows()),
                "q1_small": server_rows(coord.local.execute(q1_small).rows())}
        print(f"qos answers on the coordinator's local runner: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

        def warm():
            # the unpreempted run, which also stages Q1 and Q6 on both
            # workers: the bursts below compare warm against warm
            client = PrestoTpuClient(coord.uri, timeout_s=900,
                                     user="batch-warm")
            res = client.execute(q1_big)
            diff = rows_close(res.rows(), want["q1_big"])
            check(diff is None, f"P0: Q1 differs ({diff})")
            res = client.execute(q6_small)
            check(server_rows(res.rows()) == want["q6"], "P0: Q6 differs")
            return {}

        step(f"P0 Q1 {big} and Q6 {small} unpreempted (warm-up)", warm)

        def burst(tag):
            """Q1 in the batch lane, then the interactive burst once a
            producer finished; returns (Q1, its holder, the burst's
            queries, the burst's errors)."""
            t, holder, errs = run_async(coord, q1_big, f"batch-{tag}")
            qa = query_of(coord, f"batch-{tag}")
            hold_producers(qa)
            wait_for(lambda: producer_finished(qa) or qa.done.is_set(),
                     f"{tag}: no producer of Q1 finished")
            check(not qa.done.is_set(), f"{tag}: Q1 ended before the burst")
            runs = [run_async(coord, q6_small, f"inter-{tag}-{i}")
                    for i in range(QOS_BURST)]
            burst_q = [query_of(coord, f"inter-{tag}-{i}")
                       for i in range(QOS_BURST)]
            errors = errs + [e for r in runs for e in r[2]]
            return qa, t, holder, runs, burst_q, errors

        def p1():
            qos = coord.qos
            # the same burst behind the same Q1 with the plane off: the
            # admission semaphore of qos.enabled=false
            coord.qos = None
            try:
                qa, t, holder, runs, off_q, errors = burst("off")
                join_all([t] + [r[0] for r in runs], errors, "P1 off")
            finally:
                coord.qos = qos
                faults.configure(None)
            off = DistributionStat()
            for q in off_q:
                off.add(q.stats.elapsed_ms)
            resumed = {"n": 0}

            def watch(q):
                # the wall time of Q1's last resume
                while not q.done.is_set():
                    n = getattr(q, "qos_resumes", 0)
                    if n > resumed["n"]:
                        resumed.update(n=n, t=time.time())
                    time.sleep(0.001)

            qa, t, holder, runs, on_q, errors = burst("on")
            watcher = threading.Thread(target=watch, args=(qa,))
            watcher.start()
            try:
                join_all([t, watcher] + [r[0] for r in runs], errors,
                         "P1 on")
            finally:
                faults.configure(None)
            diff = rows_close(holder["res"].rows(), want["q1_big"])
            check(diff is None, f"P1: Q1 differs after its resume ({diff})")
            for _, h, _ in runs:
                check(server_rows(h["res"].rows()) == want["q6"],
                      "P1: an interactive Q6 differs")
            check(getattr(qa, "qos_suspensions", 0) >= 1
                  and getattr(qa, "qos_resumes", 0) >= 1,
                  f"P1: Q1 suspended {getattr(qa, 'qos_suspensions', 0)} "
                  f"and resumed {getattr(qa, 'qos_resumes', 0)} times")
            check("t" in resumed and all(
                q.stats.end_time <= resumed["t"] for q in on_q),
                "P1: an interactive query ended after Q1 resumed")
            reruns = producer_reruns(coord, qa)
            check(reruns == 0, f"P1: {reruns} producer re-runs")
            (lane,) = [r for r in coord.local.execute(
                'select "group", p50_ms, p99_ms, queries, suspensions, '
                "resumes from system.runtime.qos").rows()
                if r[0] == "interactive"]
            v = off.values()
            check(lane[3] == QOS_BURST,
                  f"P1: {lane[3]} interactive queries in runtime.qos")
            check(lane[2] < v["p99"],
                  f"P1: the interactive p99 with QoS {lane[2]:.2f} ms is not "
                  f"below the {v['p99']:.2f} ms without it")
            info = coord.query_info(qa)["qos"]
            return {"interactive_p50_ms": lane[1],
                    "interactive_p99_ms": lane[2],
                    "interactive_p50_ms_qos_off": v["p50"],
                    "interactive_p99_ms_qos_off": v["p99"],
                    "q1_suspended_ms": info["suspended_ms"],
                    "producer_reruns": reruns}

        step(f"P1 Q1 {big} batch lane, {QOS_BURST} Q6 {small} interactive",
             p1)

        def p2():
            grace = coord.qos.resume_grace_s
            coord.qos.resume_grace_s = 60.0
            faults.configure({"rules": [
                {"action": "suspend_storm", "owner": "q_c", "count": 3},
            ]})
            try:
                client = PrestoTpuClient(coord.uri, timeout_s=900,
                                         user="batch-storm")
                res = client.execute(q1_big)
            finally:
                faults.configure(None)
                coord.qos.resume_grace_s = grace
            diff = rows_close(res.rows(), want["q1_big"])
            check(diff is None, f"P2: Q1 differs ({diff})")
            q = coord.lookup_query(res.query_id)
            check(q.qos_suspensions == 1 and q.qos_resumes == 1,
                  f"P2: {q.qos_suspensions} suspensions and "
                  f"{q.qos_resumes} resumes, not 1 and 1")
            return {"producer_reruns": producer_reruns(coord, q)}

        rec = step(f"P2 Q1 {big}, a suspend_storm of 3", p2)
        check(rec["preempt_triggers"] == 3,
              f"P2: {rec['preempt_triggers']} triggers, not 3")

        def p3():
            victim = workers[1]
            t, holder, errs = run_async(coord, q1_big, "batch-kill")
            qa = query_of(coord, "batch-kill")
            hold_producers(qa)
            wait_for(lambda: producer_finished(qa, victim.node_id)
                     or qa.done.is_set(),
                     "P3: no producer of Q1 finished on the victim")
            check(not qa.done.is_set(), "P3: Q1 ended before the kill")
            ti, hi, erri = run_async(coord, q6_small, "inter-kill")
            wait_for(lambda: getattr(qa, "qos_suspensions", 0) >= 1,
                     "P3: Q1 was not suspended")
            victim._fault_kill()
            try:
                join_all([t, ti], errs + erri, "P3")
            finally:
                faults.configure(None)
            diff = rows_close(holder["res"].rows(), want["q1_big"])
            check(diff is None, f"P3: Q1 differs ({diff})")
            check(server_rows(hi["res"].rows()) == want["q6"],
                  "P3: the interactive Q6 differs")
            info = coord.query_info(qa)
            check(info["spool_pages_served"] > 0,
                  "P3: nothing was re-served from the spool")
            check(info["qos"]["resumes"] >= 1, "P3: Q1 did not resume")
            return {"producer_reruns": producer_reruns(coord, qa),
                    "q1_spool_frames_served": info["spool_pages_served"]}

        step(f"P3 Q1 {big}, a worker killed while Q1 is suspended", p3)
        workers[1].shutdown(graceful=False)

        # cluster B: the elastic pool from one stable worker
        coord_b = CoordinatorServer(
            config=node_config("coordinator", QOS_POOL), device=dev,
            session=Session(schema=small), max_concurrent_queries=1,
        ).start()
        stable_b = worker(coord_b)
        workers.append(stable_b)
        wait_for(lambda: len(coord_b.active_workers()) == 1,
                 "P4: the stable worker did not announce itself")
        pool_prov = LocalWorkerPoolProvider(
            coord_b.uri, config=node_config("worker"), device=dev)

        def p4():
            seen, stop = {}, threading.Event()

            def watch():
                # every pool state each spawned node shows, in order
                while not stop.is_set():
                    for w in coord_b.nodes():
                        if w.node_id in pool_prov.workers or w.node_id in seen:
                            states = seen.setdefault(w.node_id, [])
                            st = coord_b.pool_state(w)
                            if not states or states[-1] != st:
                                states.append(st)
                    time.sleep(0.002)

            watcher = threading.Thread(target=watch)
            watcher.start()
            spawned_tasks = []
            real = PA.onehot_reduce_many

            def record(gid, requests, nseg):
                for w in list(pool_prov.workers.values()):
                    st = getattr(w.runner._qs_local, "value", None)
                    if st is not None:
                        spawned_tasks.append(st.task_id)
                return real(gid, requests, nseg)

            PA.onehot_reduce_many = record
            # every task held a little, so that the queue builds while
            # the spawned workers boot
            faults.configure({"rules": [
                {"action": "delay", "task": "q_c", "delay_s": 0.2},
            ]})
            try:
                coord_b.attach_pool(pool_prov)
                runs = [run_async(coord_b, q1_small, f"batch-pool-{i}")
                        for i in range(3)]
                join_all([r[0] for r in runs], [e for r in runs
                                                for e in r[2]], "P4")
                for _, h, _ in runs:
                    diff = rows_close(h["res"].rows(), want["q1_small"])
                    check(diff is None, f"P4: Q1 differs ({diff})")
                ups = REGISTRY.counter("pool.scale_up").total
                wait_for(lambda: len(coord_b.active_workers()) == 1
                         and not pool_prov.workers,
                         "P4: the pool did not scale down when idle")
                flaps = REGISTRY.counter("pool.scale_up").total - ups
            finally:
                faults.configure(None)
                PA.onehot_reduce_many = real
                stop.set()
                watcher.join()
                coord_b.autoscaler.stop()
            check(seen, "P4: the autoscaler spawned no worker")
            for nid, states in seen.items():
                check("SCALING_UP" in states and "STABLE" in
                      states[states.index("SCALING_UP"):],
                      f"P4: {nid} went {states}")
            check(flaps == 0, f"P4: {flaps} scale-ups after the load")
            check(spawned_tasks, "P4: no batch ran on a spawned worker")
            return {"pool_states": {k: v for k, v in seen.items()},
                    "k1_calls_on_spawned": len(spawned_tasks),
                    "scale_ups_after_load": flaps}

        step(f"P4 3 clients of Q1 {small}, pool.max-workers=3", p4)
        for w in list(pool_prov.workers.values()):
            w.shutdown(graceful=False)
        coord_b.shutdown()
        coord_b = None

        def p5():
            stable = workers[0]
            # the worker killed in P3 has left discovery: nothing probes
            # it for a range or a merge
            gone = workers[1].node_id
            wait_for(lambda: gone not in {
                w.node_id for w in coord._ttl_workers()},
                "P5: the dead worker is still announced", 60)
            pre = worker(coord, preemptible=True)
            workers.append(pre)
            wait_for(lambda: pre.node_id in {
                w.node_id for w in coord.active_workers()},
                "P5: the preemptible worker did not announce itself")
            fired = {}
            notice = pre._fault_preempt

            def record():
                fired.setdefault("t", time.monotonic())
                notice()

            pre._fault_preempt = record
            faults.configure({"rules": [
                {"action": "kill_worker_preempt", "node": pre.node_id,
                 "task": ".prod.", "count": 1},
            ]})
            try:
                client = PrestoTpuClient(coord.uri, timeout_s=900,
                                         user="batch-preempt")
                res = client.execute(q1_big)
            finally:
                faults.configure(None)
            diff = rows_close(res.rows(), want["q1_big"])
            check(diff is None, f"P5: Q1 differs ({diff})")
            check("t" in fired, "P5: the preemption notice never fired")
            wait_for(lambda: pre._shutting_down,
                     "P5: the preempted worker did not exit",
                     QOS_PREEMPT_GRACE_S + 30)
            drained_s = time.monotonic() - fired["t"]
            check(drained_s <= QOS_PREEMPT_GRACE_S,
                  f"P5: drained in {drained_s:.2f} s, past the grace")
            info = client.query_info(res.query_id)
            merges = {t["node_id"] for st in info["stages"]
                      if st["kind"] == "merge" for t in st["tasks"]}
            check(merges == {stable.node_id},
                  f"P5: merges ran on {merges}")
            prod = [t["node_id"] for st in info["stages"]
                    if st["kind"] == "producer" for t in st["tasks"]]
            check(pre.node_id in prod
                  and prod.count(stable.node_id) > prod.count(pre.node_id),
                  f"P5: producers ran on {prod}")
            return {"drained_s": drained_s,
                    "producers_on_preempted": prod.count(pre.node_id),
                    "producers_on_stable": prod.count(stable.node_id)}

        rec = step(f"P5 Q1 {big}, kill_worker_preempt on a preemptible "
                   "worker", p5)
        check(rec["preemptions"] == 1,
              f"P5: {rec['preemptions']} preemptions")
    finally:
        faults.configure(None)
        if pool_prov is not None:
            for w in list(pool_prov.workers.values()):
                w.shutdown(graceful=False)
        for w in workers:
            w.shutdown(graceful=False)
        for c in (coord_b, coord):
            if c is not None:
                if c.autoscaler is not None:
                    c.autoscaler.stop()
                c.shutdown()
        shutil.rmtree(root, ignore_errors=True)
        if on_card:
            torch.cuda.empty_cache()
    secs = time.perf_counter() - phase_t0
    print(f"qos phase: {secs:.2f} s, onehot_reduce launches {launches} "
          f"[{card}]", flush=True)
    out.append({"step": "phase", "s": secs})
    return launches, out


# ----------------------------------------------------------- distrib phase

#: the distrib phase: shards of the distributed runner, all on the one
#: card (the one-card analogue of the reference's virtual CPU mesh)
DISTRIB_SHARDS = 4
#: the dryrun twin's shard count, as the reference's dryrun takes it
DRYRUN_SHARDS = 8


def qualify(sql: str, schema: str) -> str:
    """``sql`` with its unqualified TPC-H tables read from ``schema``."""
    import re

    return re.sub(
        r"\b(from|join|,)(\s+)(customer|orders|lineitem|supplier|nation|"
        r"region|part|partsupp)\b",
        lambda m: f"{m.group(1)}{m.group(2)}tpch.{schema}.{m.group(3)}",
        sql,
    )


def distrib_queries():
    """The distrib phase's statements over the session's schema."""
    return {"Q1": stream_q1(), "Q3": Q3, "Q5": Q5, "Q18": stream_q18()[0]}


def routing_profile(pages, dests, bucket_cap, dev, card):
    """The all_to_all's routing passes (hash, destination sort, bucket
    scatter, the move and the compaction) on one call's own inputs:
    device ms by kernel kind under torch.profiler, and CUDA-event ms of
    the whole call. Empty on the CPU."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_profile import kind_of
    from presto_tpu_torch.parallel import exchange as X

    if dev.type != "cuda":
        return {}
    ms = time_ms(lambda: X.partition_exchange(pages, dests, bucket_cap),
                 runs=5)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        X.partition_exchange(pages, dests, bucket_cap)
        torch.cuda.synchronize(dev)
    by_kind = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            k = kind_of(e.key)
            by_kind[k] = by_kind.get(k, 0.0) + e.self_device_time_total / 1e3
    rows = sum(int(p.num_valid) for p in pages)
    print(f"D1 routing passes of one all_to_all ({len(pages)} sources, "
          f"{rows} rows, bucket_cap {bucket_cap}): {ms:.3f} ms per call; "
          "device ms by kind " + ", ".join(
              f"{k} {v:.3f}" for k, v in sorted(by_kind.items(),
                                                 key=lambda kv: -kv[1]))
          + f" [{card}]", flush=True)
    return {"ms": ms, "rows": rows, "bucket_cap": bucket_cap,
            "device_ms_by_kind": by_kind}


def distrib_phase(card: str, dev=None, want=None, records=None,
                  schema: str = JOINS_SCHEMA, shards: int = DISTRIB_SHARDS,
                  broadcast_threshold: int = 1 << 16):
    """The fourteenth slice's multi-device path on ``dev`` (the card
    unless a CPU rehearsal passes another): D1 ``DistributedQueryRunner``
    over ``shards`` shards of the one card, TPC-H Q1, Q3, Q5 and Q18 at
    ``schema``, each cold then warm: every scan row-sharded, Q1's and
    Q5's partial GROUP BY one K1 call per shard and their finals one per
    shard over the replicated partial states, Q3's and Q5's big joins
    hash-repartitioned (all_to_all), Q18's l_orderkey GROUP BY routed by
    key hash. Each result equals ``want`` (the port's single-device
    runner on the same statement: the joins and stream phases' results;
    None computes them here), doubles within rel 1e-9, and the warm run
    equals the cold one bit for bit. ``broadcast_threshold`` is the
    runner's default (a CPU rehearsal at tiny passes a lower one, so its
    joins repartition too). D2 the dryrun twin: Q3 at tiny over 8 shards
    of the card. Returns (the onehot_reduce launches of the counted runs,
    the records)."""
    import torch

    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.ops import aggregation as PA
    from presto_tpu_torch.parallel import DistributedQueryRunner
    from presto_tpu_torch.parallel import distributed_runner as DR
    from presto_tpu_torch.session import Session

    dev = torch.device("cuda") if dev is None else dev
    on_card = dev.type == "cuda"
    # earlier phases' runners and their catalogs refer to each other:
    # collect them before this phase's SF10 shards take the card
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    phase_t0 = time.perf_counter()
    out, launches = [], 0
    queries = distrib_queries()
    if want is None:
        local = LocalQueryRunner(device=dev, session=Session(
            schema=schema,
            properties={"max_device_rows": JOINS_MAX_DEVICE_ROWS}),
            staging_cache_bytes=cache_budget(dev))
        t0 = time.perf_counter()
        want = {k: local.execute(v).rows() for k, v in queries.items()}
        print(f"D1 baselines on the single-device runner: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        # a runner and its catalogs refer to each other (the system
        # connector): only a collection frees its cached tables
        del local
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    runner = DistributedQueryRunner(
        devices=[dev] * shards, session=Session(schema=schema),
        broadcast_threshold=broadcast_threshold)
    # what each run routed: the key columns of every all_to_all, and the
    # largest one's inputs (the routing profile's case)
    routed = {"keys": [], "biggest": None}
    partition = runner._partition

    def spy(pages, key_cols, bucket_cap, flags):
        routed["keys"].append(tuple(key_cols))
        big = routed["biggest"]
        if big is None or bucket_cap > big[2]:
            dests = [DR.umod(DR.partition_hash(p, key_cols), runner.n)
                     for p in pages]
            routed["biggest"] = (list(pages), dests, bucket_cap)
        return partition(pages, key_cols, bucket_cap, flags)

    runner._partition = spy
    try:
        for name, sql in queries.items():
            runs = []
            for label in ("cold", "warm"):
                if on_card:
                    torch.cuda.reset_peak_memory_stats(dev)
                PA.onehot_reduce.launches = 0
                routed["keys"].clear()
                before = dict(runner.collective_bytes)
                reads, retries = (runner.fragment_reads,
                                  runner.balance_retries)
                with onehot_calls() as seen, counting_syncs(dev) as syncs:
                    res, secs = run_timed(runner, sql, dev)
                n_launch = PA.onehot_reduce.launches
                launches += n_launch
                calls = [len(reqs) for _, reqs, _ in seen]
                want_launches = (sum(-(-k // PA.K_MAX) for k in calls)
                                 if on_card else 0)
                check(n_launch == want_launches,
                      f"D1 {name}: {n_launch} onehot_reduce launches, "
                      f"expected {want_launches}")
                diff = rows_close(res.rows(), want[name])
                check(diff is None, f"D1 {name} {label}: differs from the "
                      f"single-device runner ({diff})")
                moved = {k: runner.collective_bytes[k] - before[k]
                         for k in before}
                rec = {
                    "step": f"D1 {name} {label}", "s": secs,
                    "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                                 if on_card else None),
                    "host_waits": syncs[0],
                    "onehot_reduce_launches": n_launch,
                    "onehot_calls": len(calls),
                    "collective_bytes": moved,
                    "fragment_reads": runner.fragment_reads - reads,
                    "balance_retries": runner.balance_retries - retries,
                    "all_to_all_keys": [list(k) for k in routed["keys"]],
                }
                out.append(rec)
                runs.append(res)
                if name == "Q18" and label == "warm":
                    for row in res.rows()[:3]:
                        print("D1 Q18 row:", row, flush=True)
                if label == "cold" and name in ("Q1", "Q5") \
                        and records is not None and on_card:
                    # one shard's partial GROUP BY at its own inputs
                    records.append(fused_case(
                        f"distrib {name.lower()} shard fused", *seen[0], card))
                del seen
                print(f"D1 {name} {schema} {label} over {shards} shards: "
                      f"{secs:.4f} s, peak memory "
                      + (f"{rec['peak_gib']:.3f} GiB" if on_card
                         else "not measured (no card)")
                      + f", host waits {rec['host_waits']}, onehot_reduce "
                      f"launches {n_launch} ({len(calls)} calls), bytes "
                      f"routed {moved}, fragment reads "
                      f"{rec['fragment_reads']}, balance retries "
                      f"{rec['balance_retries']}, all_to_all keys "
                      f"{rec['all_to_all_keys']} [{card}]", flush=True)
            check(runs[0].rows() == runs[1].rows(),
                  f"D1 {name}: cold and warm runs differ")
            # each query's sharded tables go before the next one's
            # (their column sets differ): the card holds one query's
            runner._shard_cache.clear()
            del runs
            if on_card:
                torch.cuda.empty_cache()
            keys = out[-1]["all_to_all_keys"]
            if name in ("Q1", "Q5"):
                check(out[-1]["onehot_calls"] == 2 * shards,
                      f"D1 {name}: {out[-1]['onehot_calls']} one-hot calls, "
                      f"expected a partial and a final per shard")
            if name == "Q5":
                check(["l_orderkey"] in keys or ["o_orderkey"] in keys,
                      f"D1 Q5: the orders-lineitem join was not "
                      f"repartitioned ({keys})")
            if name == "Q18":
                check(["l_orderkey"] in keys,
                      f"D1 Q18: the l_orderkey GROUP BY was not routed by "
                      f"key hash ({keys})")
        prof = routing_profile(*routed["biggest"], dev, card)
        out.append({"step": "D1 routing profile", **prof})
        print("D1: on one card no collective copies bytes between cards "
              "(.to() onto the same card moves nothing); the bytes above "
              "are what the collectives route", flush=True)
    finally:
        routed.clear()
        del runner
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    # D2: the dryrun twin, Q3 at tiny over 8 shards of the card
    t0 = time.perf_counter()
    with counting_syncs(dev) as syncs:
        twin = DR.dryrun_multichip(DRYRUN_SHARDS, devices=[dev] * DRYRUN_SHARDS)
    secs = time.perf_counter() - t0
    rec = {"step": "D2 dryrun_multichip", "s": secs, "shards": twin.n,
           "host_waits": syncs[0], "collective_bytes": twin.collective_bytes}
    out.append(rec)
    print(f"D2 dryrun_multichip({DRYRUN_SHARDS}): Q3 at tiny, 10 rows, "
          f"{secs:.2f} s, host waits {syncs[0]}, bytes routed "
          f"{twin.collective_bytes} [{card}]", flush=True)
    del twin
    secs = time.perf_counter() - phase_t0
    print(f"distrib phase: {secs:.2f} s, onehot_reduce launches {launches} "
          f"[{card}]", flush=True)
    out.append({"step": "phase", "s": secs})
    return launches, out


# --------------------------------------------------------------- ici phase

#: the ici phase's nodes: split caches and pools as the server phase's
ICI_NODE = {"staging.cache-bytes": str(4 << 30),
            "query.max-memory-per-node": "16GB"}


def ici_phase(card: str, dev=None, want_q1_big=None, records=None,
              big: str = JOINS_SCHEMA, small: str = "sf1"):
    """The fourteenth slice's in-slice (ICI) lane on ``dev`` (the card
    unless a CPU rehearsal passes another): coordinators and workers in
    this process with ``exchange.ici-enabled``, so partitioned edges
    move device pages between co-located workers and the root gather
    rides the lane. I1 Q1 (the shuffled aggregation) and Q3 with
    ``join_distribution_type=PARTITIONED`` over ``big`` on a coordinator
    and two workers, each with the lane off then on: the same rows, ICI
    edges and no fallback with it on, no HTTP shuffle byte. I2 Q1 over
    ``big`` with ``exchange.single-program`` off (the per-source gather):
    the same rows, the root gather over HTTP, device dispatches per stage
    against I1's. I3 a worker
    drained while a partitioned Q3 over ``small`` runs (retry TASK over a
    spool): every FINISHED ICI task of it materialized, no query fails.
    I4 a co-located worker killed mid-join (TASK): the query completes
    over the spool with the same rows. I5 a third worker announcing
    another slice on I1's cluster: its edges ride HTTP, the pair's ICI,
    the same rows. ``want_q1_big``: the single-device runner's Q1 over
    ``big``. Returns (the onehot_reduce launches of the counted steps,
    the records)."""
    import shutil
    import tempfile
    import threading

    import torch

    from presto_tpu_torch.ops import aggregation as PA
    from presto_tpu_torch.server import (
        CoordinatorServer,
        PrestoTpuClient,
        WorkerServer,
        exchange_spi,
        rpc,
    )
    from presto_tpu_torch.session import NodeConfig, Session
    from presto_tpu_torch.utils import faults
    from presto_tpu_torch.utils.metrics import REGISTRY

    dev = torch.device("cuda") if dev is None else dev
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    phase_t0 = time.perf_counter()
    out, launches = [], 0
    root = tempfile.mkdtemp(prefix="ici-")
    q1_big = Q1.replace("tpch.sf1.lineitem", f"tpch.{big}.lineitem")
    q3_big, q3_small = qualify(Q3, big), qualify(Q3, small)
    q1_small = Q1.replace("tpch.sf1.lineitem", f"tpch.{small}.lineitem")
    names = ("ici_edges", "ici_fallbacks", "ici_bytes_elided",
             "ici_materialized", "ici_stages", "collective_stages",
             "collective_fallbacks", "ici_merge_errors",
             "http_shuffle_bytes")

    def counters():
        return {n: REGISTRY.counter(f"exchange.{n}").total for n in names}

    def wait_for(cond, msg, timeout=120.0):
        deadline = time.monotonic() + timeout
        while not cond() and time.monotonic() < deadline:
            time.sleep(0.01)
        check(cond(), msg)

    def cluster(extra=None, n=2):
        # each node's runner and catalogs refer to each other: collect
        # the last cluster's, so this one finds the card empty
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        cfg = {**ICI_NODE, "exchange.ici-enabled": "true", **(extra or {})}
        coord = CoordinatorServer(config=NodeConfig(cfg), device=dev,
                                  session=Session(schema=small)).start()
        workers = [WorkerServer(coordinator_uri=coord.uri,
                                config=NodeConfig(cfg), device=dev).start()
                   for _ in range(n)]
        wait_for(lambda: len(coord.active_workers()) == n,
                 "the workers did not announce themselves")
        return coord, workers, PrestoTpuClient(coord.uri, timeout_s=900)

    def shut(coord, workers):
        for w in workers:
            w.shutdown(graceful=False)
        coord.shutdown()

    def step(coord, client, label, sql, ici: bool, want=None):
        """One statement with the lane on or off; its seconds, counter
        deltas, stage dispatches and K1 launches."""
        nonlocal launches
        client.execute(f"set session exchange_ici_enabled = "
                       f"{'true' if ici else 'false'}")
        PA.onehot_reduce.launches = 0
        c0 = counters()
        with onehot_calls() as seen:
            t0 = time.perf_counter()
            res = client.execute(sql)
            secs = time.perf_counter() - t0
        delta = {k: v - c0[k] for k, v in counters().items()}
        n_launch = PA.onehot_reduce.launches
        launches += n_launch
        stages = coord.queries[res.query_id].stats.stages
        info = client.query_info(res.query_id)
        rec = {"step": label, "s": secs, "ici": ici, **delta,
               "exchange": info["exchange"],
               "onehot_reduce_launches": n_launch,
               "stage_dispatches": [(st.kind, sum(t.device_dispatches
                                                  for t in st.tasks))
                                    for st in stages]}
        out.append(rec)
        print(f"{label}: {secs:.4f} s, lane {'ICI' if ici else 'HTTP'}, "
              f"edges {info['exchange']}, ici_bytes_elided "
              f"{delta['ici_bytes_elided']}, http_shuffle_bytes "
              f"{delta['http_shuffle_bytes']}, fallbacks "
              f"{delta['ici_fallbacks']}, collective stages "
              f"{delta['collective_stages']}, dispatches per stage "
              f"{rec['stage_dispatches']}, onehot_reduce launches "
              f"{n_launch} [{card}]", flush=True)
        if want is not None:
            diff = rows_close(res.rows(), server_rows(want))
            check(diff is None, f"{label}: differs ({diff})")
        return res, rec, seen

    def on_lane(rec, label):
        check(rec["ici_edges"] > 0 and rec["ici_fallbacks"] == 0
              and rec["http_shuffle_bytes"] == 0
              and rec["ici_merge_errors"] == 0,
              f"{label}: ICI edges {rec['ici_edges']}, fallbacks "
              f"{rec['ici_fallbacks']}, HTTP shuffle bytes "
              f"{rec['http_shuffle_bytes']}: the lane fell to HTTP")

    try:
        # I1 + I2 + I5 on one cluster
        coord, workers, client = cluster()
        try:
            slices = {w.slice_id for w in coord.active_workers()}
            check(len(slices) == 1 and coord.slice_id in slices,
                  f"I1: slices {slices}, coordinator {coord.slice_id}")
            if want_q1_big is None:
                want_q1_big = coord.local.execute(q1_big).rows()
            off, rec_off, _ = step(coord, client, f"I1 Q1 {big} HTTP",
                                   q1_big, False, want_q1_big)
            on, rec_on, seen = step(coord, client, f"I1 Q1 {big} ICI",
                                    q1_big, True, want_q1_big)
            on_lane(rec_on, "I1 Q1")
            check(on.rows() == off.rows(), "I1 Q1: ICI and HTTP differ")
            check(rec_off["http_shuffle_bytes"] > 0,
                  "I1 Q1: the HTTP run shuffled nothing")
            merges = [s for s in seen if len(s[1]) > 8]
            check(merges, "I1 Q1: no merge task's final GROUP BY seen")
            if records is not None and on_card:
                # a merge task's final GROUP BY over its ICI-fed page: one
                # launch, beside the floor an empty launch pays
                rec = fused_case("ici q1 merge fused", *merges[0], card)
                check(rec["launches_per_call"] == 1,
                      f"I1: the merge's K1 call made "
                      f"{rec['launches_per_call']} launches")
                rec["floor_ms"] = empty_launch_ms()
                print(f"ici q1 merge fused: kernel {rec['ms']:.4f} ms, "
                      f"library {rec['library_ms']:.4f} ms, empty launch "
                      f"{rec['floor_ms']:.4f} ms [{card}]", flush=True)
                records.append(rec)
            del seen, merges
            client.execute(
                "set session join_distribution_type = 'PARTITIONED'")
            try:
                off3, _, _ = step(coord, client,
                                  f"I1 Q3 {big} partitioned HTTP",
                                  q3_big, False)
                on3, rec3, _ = step(coord, client,
                                    f"I1 Q3 {big} partitioned ICI",
                                    q3_big, True)
            finally:
                client.execute(
                    "set session join_distribution_type = 'AUTOMATIC'")
            on_lane(rec3, "I1 Q3")
            check(on3.rows() == off3.rows(), "I1 Q3: ICI and HTTP differ")
            for row in on3.rows()[:3]:
                print("I1 Q3 row:", row, flush=True)

            # I2: the per-source gather against I1's single program (the
            # workers' exchange.single-program and the session's value,
            # as nodes booted with the key off would have them)
            client.execute("set session exchange_single_program = false")
            for w in workers:
                w.single_program = False
            try:
                sp_off, rec2, _ = step(coord, client,
                                       f"I2 Q1 {big} ICI single-program off",
                                       q1_big, True, want_q1_big)
            finally:
                client.execute("set session exchange_single_program = true")
                for w in workers:
                    w.single_program = True
            on_lane(rec2, "I2")
            check(sp_off.rows() == on.rows(), "I2: single-program on and "
                  "off differ")
            check(rec_on["collective_stages"] > 0
                  and rec2["collective_stages"] == 0,
                  f"I2: collective stages {rec_on['collective_stages']} on, "
                  f"{rec2['collective_stages']} off")

            # I5: a third worker on another slice joins the cluster
            odd = WorkerServer(coordinator_uri=coord.uri, device=dev,
                               config=NodeConfig({
                                   **ICI_NODE, "exchange.ici-enabled": "true",
                                   "exchange.slice-id": "other-slice"})
                               ).start()
            workers.append(odd)
            wait_for(lambda: len(coord.active_workers()) == 3,
                     "I5: the third worker did not announce itself")
            client.execute(
                "set session join_distribution_type = 'PARTITIONED'")
            try:
                for name, sql in (("Q1", q1_small), ("Q3", q3_small)):
                    r_off, _, _ = step(coord, client,
                                       f"I5 {name} {small} HTTP", sql, False)
                    r_on, rec5, _ = step(coord, client,
                                         f"I5 {name} {small} mixed", sql,
                                         True)
                    check(r_on.rows() == r_off.rows(),
                          f"I5 {name}: mixed and HTTP differ")
                    check(rec5["exchange"]["ici_edges"] > 0
                          and rec5["exchange"]["http_edges"] > 0,
                          f"I5 {name}: edges {rec5['exchange']}, expected "
                          "both lanes")
            finally:
                client.execute(
                    "set session join_distribution_type = 'AUTOMATIC'")
        finally:
            shut(coord, workers)
        wait_for(lambda: exchange_spi.SEGMENT.stats()["entries"] == 0,
                 "the segment kept entries after its cluster shut down",
                 timeout=30)

        spool = {"exchange.spool-path": os.path.join(root, "spool"),
                 "retry-policy": "TASK"}

        def run_bg(client, sql):
            box, errs = {}, []

            def run():
                try:
                    box["res"] = client.execute(sql)
                except Exception as e:  # surfaced by the caller's check
                    errs.append(e)

            t = threading.Thread(target=run)
            t.start()
            return t, box, errs

        # I3: a worker drained under ICI load
        coord, workers, client = cluster(spool)
        try:
            client.execute(
                "set session join_distribution_type = 'PARTITIONED'")
            base, _, _ = step(coord, client, f"I3 Q3 {small} HTTP baseline",
                              q3_small, False)
            client.execute("set session exchange_ici_enabled = true")
            faults.configure({"seed": 5, "rules": [
                {"action": "delay", "task": ".prod.", "delay_s": 0.1}]})
            c0 = counters()
            t0 = time.perf_counter()
            t, box, errs = run_bg(client, q3_small)
            victim = workers[0]

            def finished_ici():
                with victim._lock:
                    tasks = list(victim.tasks.values())
                return [x for x in tasks if x.spec.ici_slice
                        and x.state == "FINISHED"]

            wait_for(lambda: finished_ici() or not t.is_alive(),
                     "I3: no ICI task finished on the worker to drain")
            rpc.call_json("PUT", f"{victim.uri}/v1/state/drain", {})
            t.join(300)
            secs = time.perf_counter() - t0
            faults.configure(None)
            check(not t.is_alive() and not errs,
                  f"I3: the query failed under the drain: {errs}")
            check(box["res"].rows() == base.rows(),
                  "I3: the drained run differs")
            wait_for(lambda: victim._shutting_down,
                     "I3: the drained worker did not exit", timeout=60)
            done = finished_ici()
            unmat = [x.spec.task_id for x in done if not x._ici_mat_done]
            delta = {k: v - c0[k] for k, v in counters().items()}
            check(done and not unmat,
                  f"I3: {len(done)} FINISHED ICI tasks, not materialized "
                  f"{unmat}")
            rec = {"step": f"I3 Q3 {small} drain under ICI", "s": secs,
                   "finished_ici_tasks": len(done), **delta}
            out.append(rec)
            print(f"I3 drain: {secs:.2f} s, {len(done)} FINISHED ICI tasks "
                  f"on the drained worker, all materialized "
                  f"(ici_materialized {delta['ici_materialized']}), "
                  f"ici_edges {delta['ici_edges']}, fallbacks "
                  f"{delta['ici_fallbacks']} [{card}]", flush=True)
        finally:
            faults.configure(None)
            shut(coord, workers)

        # I4: a co-located worker killed mid-join
        coord, workers, client = cluster(spool)
        try:
            client.execute(
                "set session join_distribution_type = 'PARTITIONED'")
            base, _, _ = step(coord, client, f"I4 Q3 {small} HTTP baseline",
                              q3_small, False)
            client.execute("set session exchange_ici_enabled = true")
            faults.configure({"seed": 2, "rules": [
                {"action": "delay", "task": ".prod.", "delay_s": 0.05},
                {"action": "delay", "task": ".join.", "delay_s": 0.8}]})
            c0 = counters()
            served0 = REGISTRY.counter("spool.pages_served").total
            t0 = time.perf_counter()
            t, box, errs = run_bg(client, q3_small)

            def joining():
                """A worker running a join task over the sealed producer
                stage: killing it loses a partition to recover."""
                for w in workers:
                    with w._lock:
                        tasks = list(w.tasks.values())
                    if any(x.spec.partition_scan < 0 and x.sources_done
                           and x.state in ("QUEUED", "RUNNING")
                           for x in tasks):
                        return w
                return None

            wait_for(lambda: joining() or not t.is_alive(),
                     "I4: no join task ran over the sealed producers")
            victim = joining()
            check(victim is not None, "I4: the join ended before the kill")
            victim._fault_kill()
            # a crash loses the victim's device pages
            with victim._lock:
                doomed = list(victim.tasks)
            for tid in doomed:
                exchange_spi.SEGMENT.discard(tid)
            t.join(300)
            secs = time.perf_counter() - t0
            faults.configure(None)
            check(not t.is_alive() and not errs,
                  f"I4: the query failed despite TASK recovery: {errs}")
            check(box["res"].rows() == base.rows(),
                  "I4: the recovered run differs")
            info = client.query_info(box["res"].query_id)
            delta = {k: v - c0[k] for k, v in counters().items()}
            rec = {"step": f"I4 Q3 {small} worker killed mid-join", "s": secs,
                   "task_recoveries": info["task_recoveries"],
                   "spool_frames_served": (
                       REGISTRY.counter("spool.pages_served").total - served0),
                   "exchange": info["exchange"], **delta}
            out.append(rec)
            check(rec["task_recoveries"] >= 1,
                  "I4: no task was recovered")
            print(f"I4 kill: {secs:.2f} s, task recoveries "
                  f"{rec['task_recoveries']}, spool frames re-served "
                  f"{rec['spool_frames_served']}, edges {info['exchange']}, "
                  f"ici fallbacks {delta['ici_fallbacks']} [{card}]",
                  flush=True)
        finally:
            faults.configure(None)
            shut(coord, workers)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        coord = workers = client = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    secs = time.perf_counter() - phase_t0
    print(f"ici phase: {secs:.2f} s, onehot_reduce launches {launches} "
          f"[{card}]", flush=True)
    out.append({"step": "phase", "s": secs})
    return launches, out


# -------------------------------------------------------------- fuzz phase

#: the fuzz phase's seeds: the default session from seed 0, four shards
#: of the card, and the tight streaming budget from seed 450
FUZZ_LOCAL = range(0, 200)
FUZZ_DISTRIBUTED = range(0, 60)
FUZZ_STREAMED = range(450, 510)
FUZZ_STREAM_ROWS = 8192
#: seeds whose plans admit no streaming cut under FUZZ_STREAM_ROWS, in
#: both packages (lineitem joined to orders joined to customer): each
#: must fail with NO_CUT_ERROR and nothing else
FUZZ_NO_CUT = (738, 1335, 1961)
NO_CUT_ERROR = ("StreamingError: fragment exceeds max_device_rows and admits "
                "no semantics-preserving streaming cut")


def fuzz_phase(card: str, dev=None, local=FUZZ_LOCAL,
               distributed=FUZZ_DISTRIBUTED, streamed=FUZZ_STREAMED):
    """The port's own differential fuzzer on ``dev`` (the card unless a
    CPU rehearsal passes another): each seed's query
    (``presto_tpu_torch/fuzz.py::generate_query``, under its
    ``session_draw``) against the port's ``SqliteOracle("tiny")``. Z1
    ``local`` seeds on a ``LocalQueryRunner``; Z2 ``distributed`` seeds
    on a ``DistributedQueryRunner`` over four shards of the card; Z3
    ``streamed`` seeds and ``FUZZ_NO_CUT`` under ``max_device_rows``
    ``FUZZ_STREAM_ROWS``, where exactly the no-cut seeds fail, with
    ``NO_CUT_ERROR``. Any other failure fails the phase. Returns (the
    onehot_reduce launches, the records)."""
    import statistics

    import torch

    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.fuzz import run_fuzz
    from presto_tpu_torch.ops import aggregation as PA
    from presto_tpu_torch.parallel import DistributedQueryRunner
    from presto_tpu_torch.session import Session
    from presto_tpu_torch.verifier import SqliteOracle

    dev = torch.device("cuda") if dev is None else dev
    on_card = dev.type == "cuda"
    phase_t0 = time.perf_counter()
    oracle = SqliteOracle("tiny")
    out, launches = [], 0

    def run(label, runner, seeds, expect=()):
        nonlocal launches
        seeds = list(seeds)
        per_seed, fails = [], []
        PA.onehot_reduce.launches = 0
        t0 = time.perf_counter()
        for s in seeds:
            t = time.perf_counter()
            fails += run_fuzz([s], runner=runner, oracle=oracle)
            per_seed.append(time.perf_counter() - t)
        secs = time.perf_counter() - t0
        n_launch = PA.onehot_reduce.launches
        launches += n_launch
        got = {s: d for s, _, d in fails}
        unexpected = {s: d for s, d in got.items()
                      if s not in expect or d != NO_CUT_ERROR}
        missing = [s for s in expect if s not in got]
        rec = {"step": label, "seeds": len(seeds), "s": secs,
               "median_seed_s": statistics.median(per_seed),
               "max_seed_s": max(per_seed), "failures": len(fails),
               "expected_failures": sorted(got) if not unexpected else [],
               "onehot_reduce_launches": n_launch}
        out.append(rec)
        print(f"{label}: {len(seeds)} seeds in {secs:.2f} s, median "
              f"{rec['median_seed_s'] * 1000:.1f} ms per seed, max "
              f"{rec['max_seed_s']:.2f} s, {len(fails)} failures "
              f"({len(expect)} expected), onehot_reduce launches "
              f"{n_launch} [{card}]", flush=True)
        check(not unexpected, f"{label}: unexpected failures {unexpected}")
        check(not missing, f"{label}: seeds {missing} did not raise "
              f"{NO_CUT_ERROR!r}")
        check(n_launch > 0 or not on_card,
              f"{label}: no onehot_reduce launch in {len(seeds)} seeds")

    run(f"Z1 local seeds {local.start}-{local.stop - 1}",
        LocalQueryRunner(device=dev), local)
    run(f"Z2 4 shards seeds {distributed.start}-{distributed.stop - 1}",
        DistributedQueryRunner(devices=[dev] * 4), distributed)
    run(f"Z3 max_device_rows {FUZZ_STREAM_ROWS} seeds {streamed.start}-"
        f"{streamed.stop - 1} and {list(FUZZ_NO_CUT)}",
        LocalQueryRunner(device=dev, session=Session(
            properties={"max_device_rows": FUZZ_STREAM_ROWS})),
        list(streamed) + list(FUZZ_NO_CUT), expect=FUZZ_NO_CUT)
    print(f"fuzz phase: {time.perf_counter() - phase_t0:.2f} s, "
          f"onehot_reduce launches {launches} [{card}]", flush=True)
    return launches, out


# ------------------------------------------------------------- files phase

#: the files phase's scales: F1's lineitem, F2's orders and F3's
#: lineitem, and F4's ingested rows in their commits
FILES_BIG = "sf10"
FILES_SMALL = "sf1"
F4_ROWS = 1_000_000
F4_COMMITS = 40
#: the columns F1 writes: those Q1 and Q6 read
F1_COLUMNS = ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
              "l_returnflag", "l_linestatus", "l_shipdate"]
Q6_ARGS = ("1994-01-01", "1995-01-01", "0.05", "0.07", "24")


def arrow_columns(d, table: str, cols):
    """The generator's columns ``d`` of ``table`` as an arrow table of
    the port's types: decimals from their scaled int64 (16-byte
    little-endian words), dates as date32, dictionary strings decoded
    by arrow."""
    import numpy as np
    import pyarrow as pa

    from presto_tpu_torch.connectors.tpch import TABLE_SCHEMAS, DictColumn

    arrays = []
    for c in cols:
        t, v = TABLE_SCHEMAS[table][c], d[c]
        if isinstance(v, DictColumn):
            arrays.append(pa.DictionaryArray.from_arrays(
                pa.array(np.asarray(v.ids, dtype=np.int32)),
                pa.array([str(x) for x in v.values])).cast(pa.string()))
        elif t.is_decimal:
            v = np.asarray(v, dtype=np.int64)
            words = np.stack([v, v >> 63], axis=1).tobytes()
            arrays.append(pa.Array.from_buffers(
                pa.decimal128(t.precision, t.scale), len(v),
                [None, pa.py_buffer(words)]))
        elif t.name == "date":
            arrays.append(pa.array(np.asarray(v, dtype=np.int32),
                                   type=pa.date32()))
        else:
            arrays.append(pa.array(np.asarray(v)))
    return pa.table(arrays, names=list(cols))


def files_phase(card: str, dev=None, records=None, want_q1_big=None,
                big: str = FILES_BIG, small: str = FILES_SMALL,
                f4_rows: int = F4_ROWS, f4_commits: int = F4_COMMITS):
    """The file connectors and the durable lakehouse tee on ``dev`` (the
    card unless a CPU rehearsal passes another), every file under one
    temporary directory that the phase removes. F1 ``big`` lineitem's Q1
    and Q6 columns written to one parquet file (row groups of 2^20
    rows), then Q1 and Q6 over it, cold then warm, equal to numpy over
    the generator's columns (and Q1 to ``want_q1_big``, the port's Q1
    over ``tpch.<big>``; Q1's one-hot call held against its plain
    version). F2 ``small`` orders as ORC, a GROUP BY o_orderpriority
    equal to the same query over ``tpch.<small>``. F3 ``small``
    lineitem as a hive tree partitioned by ``l_shipmode``:
    ``IN ('AIR', 'MAIL')`` reads 2 of the 7 partitions and equals the
    same query over ``tpch.<small>``. F4 a coordinator and two workers
    (sharing the coordinator's catalogs) with ``ingest.wal-path`` and
    ``lakehouse.path``: ``f4_rows`` rows of ``small`` lineitem POSTed in
    ``f4_commits`` commits, a Q1-shaped GROUP BY held to numpy; a
    coordinator restart restores the rows and the snapshot lineage
    from the manifest tip; FOR VERSION AS OF the middle commit equals
    that prefix; a forced compaction leaves that pinned reader and the
    tip bit-equal; ``system.runtime.snapshots`` lists the table.
    Returns (the onehot_reduce launches, the records)."""
    import shutil
    import tempfile

    import numpy as np
    import pyarrow.orc as orc
    import pyarrow.parquet as pq
    import torch

    from presto_tpu_torch.connectors import create_connector
    from presto_tpu_torch.connectors import hive as hive_mod
    from presto_tpu_torch.connectors.tpch import (
        SCHEMAS,
        DictColumn,
        TpchGenerator,
    )
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.exec.staging import CatalogManager
    from presto_tpu_torch.ops import aggregation as PA
    from presto_tpu_torch.server import (
        CoordinatorServer,
        PrestoTpuClient,
        WorkerServer,
        rpc,
    )
    from presto_tpu_torch.session import NodeConfig, Session

    dev = torch.device("cuda") if dev is None else dev
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    phase_t0 = time.perf_counter()
    out, launches = [], 0
    root = tempfile.mkdtemp(prefix="files-")

    def step(label, runner, sql, want_launches=None):
        nonlocal launches
        PA.onehot_reduce.launches = 0
        t0 = time.perf_counter()
        res = runner.execute(sql)
        secs = time.perf_counter() - t0
        n_launch = PA.onehot_reduce.launches
        launches += n_launch
        rec = {"step": label, "s": secs, "onehot_reduce_launches": n_launch}
        out.append(rec)
        print(f"{label}: {secs:.4f} s, onehot_reduce launches {n_launch} "
              f"[{card}]", flush=True)
        if want_launches is not None and on_card:
            check(n_launch == want_launches, f"{label}: {n_launch} "
                  f"onehot_reduce launches, expected {want_launches}")
        return res, rec

    try:
        # F1: big lineitem's Q1 and Q6 columns as parquet
        gen = TpchGenerator(SCHEMAS[big])
        n_li = gen.counts["lineitem"]
        os.makedirs(os.path.join(root, "lake", "tpch"))
        path = os.path.join(root, "lake", "tpch", "lineitem.parquet")
        t0 = time.perf_counter()

        def part(lo, hi):
            d = gen.generate("lineitem", lo, hi, F1_COLUMNS)
            return numpy_q6_of(d, Q6_ARGS), arrow_columns(
                d, "lineitem", F1_COLUMNS)

        chunks = parallel_chunks(n_li, 1 << 22, part)
        want_q6 = sum(q for q, _ in chunks)
        with pq.ParquetWriter(path, chunks[0][1].schema) as w:
            for _, tbl in chunks:
                w.write_table(tbl, row_group_size=1 << 20)
        del chunks
        write_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        out.append({"step": f"F1 write {big} lineitem", "s": write_s,
                    "rows": n_li, "bytes": nbytes})
        print(f"F1 write: {n_li} rows of {big} lineitem, "
              f"{len(F1_COLUMNS)} columns, to parquet in {write_s:.2f} s "
              f"({nbytes} bytes) [{card}]", flush=True)
        catalogs = CatalogManager()
        catalogs.register("tpch", create_connector("tpch"))
        catalogs.register("lake", create_connector(
            "parquet", root=os.path.join(root, "lake")))
        runner = LocalQueryRunner(
            catalogs=catalogs, device=dev,
            session=Session(properties={
                "max_device_rows": JOINS_MAX_DEVICE_ROWS}),
            staging_cache_bytes=cache_budget(dev))
        q1 = Q1.replace("tpch.sf1.lineitem", "lake.tpch.lineitem")
        q6 = Q6.replace("tpch.sf1.lineitem", "lake.tpch.lineitem")
        if want_q1_big is None:
            want_q1_big = numpy_q1_stream(big)[1]
        q1_runs = []
        for run in ("cold", "warm"):
            with onehot_calls() as seen:
                res, rec = step(f"F1 Q1 parquet {big} {run}", runner, q1,
                                want_launches=1)
            check_q1_stream(rec["step"], res, want_q1_big)
            q1_runs.append(res)
            res, _ = step(f"F1 Q6 parquet {big} {run}", runner, q6)
            n, cols = result_columns(res)
            check(n == 1 and int(cols["revenue"][0]) == want_q6,
                  f"F1 Q6: {cols['revenue'][0]} != numpy {want_q6}")
        check(results_differ(*q1_runs) is None, "F1 Q1: cold and warm differ")
        if records is not None and on_card:
            records.append(fused_case("files q1 parquet fused", *seen[0],
                                      card))
        del runner, q1_runs
        gc.collect()

        # F2: small orders as ORC
        gen = TpchGenerator(SCHEMAS[small])
        ocols = ["o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice",
                 "o_orderdate", "o_orderpriority", "o_shippriority"]
        os.makedirs(os.path.join(root, "orc", "tpch"))
        t0 = time.perf_counter()
        orc.write_table(
            arrow_columns(gen.generate("orders", 0, gen.counts["orders"],
                                       ocols), "orders", ocols),
            os.path.join(root, "orc", "tpch", "orders.orc"))
        print(f"F2 write: {gen.counts['orders']} rows of {small} orders to "
              f"ORC in {time.perf_counter() - t0:.2f} s [{card}]", flush=True)
        catalogs.register("orc", create_connector(
            "orc", root=os.path.join(root, "orc")))
        runner = LocalQueryRunner(catalogs=catalogs, device=dev)
        f2 = ("select o_orderpriority, count(*) as n, sum(o_totalprice) as s, "
              "min(o_orderdate) as d0, max(o_custkey) as c1 from {} "
              "group by o_orderpriority order by o_orderpriority")
        got, _ = step("F2 ORC group by o_orderpriority", runner,
                      f2.format("orc.tpch.orders"))
        want = runner.execute(f2.format(f"tpch.{small}.orders"))
        diff = results_differ(got, want)
        check(diff is None and len(got.rows()) == 5, f"F2: {diff}")

        # F3: small lineitem as a hive tree partitioned by l_shipmode
        hcols = ["l_orderkey", "l_quantity", "l_extendedprice", "l_discount",
                 "l_shipdate", "l_shipmode"]
        t0 = time.perf_counter()
        d = gen.generate("lineitem", 0, gen.counts["lineitem"], hcols)
        modes = d.pop("l_shipmode")
        check(isinstance(modes, DictColumn), "F3: l_shipmode not a dictionary")
        tbl = arrow_columns(d, "lineitem", hcols[:-1])
        for i, mode in enumerate(modes.values):
            part_dir = os.path.join(root, "hive", "tpch", "lineitem",
                                    f"l_shipmode={mode}")
            os.makedirs(part_dir)
            rows = np.nonzero(np.asarray(modes.ids) == i)[0]
            pq.write_table(tbl.take(rows),
                           os.path.join(part_dir, "part-0.parquet"))
        del d, tbl
        print(f"F3 write: {gen.counts['lineitem']} rows of {small} lineitem "
              f"in {len(modes.values)} l_shipmode partitions in "
              f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)
        catalogs.register("hive", create_connector(
            "hive", root=os.path.join(root, "hive")))
        opened = set()
        real = hive_mod.HiveConnector._append_file_range

        def spy(self, f, *args):
            opened.add(f.keys.get("l_shipmode"))
            return real(self, f, *args)

        f3 = ("select l_shipmode, count(*) as n, sum(l_quantity) as q, "
              "sum(l_extendedprice * (1 - l_discount)) as r, "
              "max(l_shipdate) as d1 from {} where l_shipmode in "
              "('AIR', 'MAIL') group by l_shipmode order by l_shipmode")
        hive_mod.HiveConnector._append_file_range = spy
        try:
            got, rec = step("F3 hive IN ('AIR', 'MAIL')", runner,
                            f3.format("hive.tpch.lineitem"))
        finally:
            hive_mod.HiveConnector._append_file_range = real
        rec["partitions_read"] = sorted(opened)
        rec["partitions"] = len(modes.values)
        want = runner.execute(f3.format(f"tpch.{small}.lineitem"))
        diff = results_differ(got, want)
        check(diff is None and len(got.rows()) == 2, f"F3: {diff}")
        print(f"F3: partitions read {sorted(opened)} of {len(modes.values)} "
              f"[{card}]", flush=True)
        check(opened == {"AIR", "MAIL"} and len(modes.values) == 7,
              f"F3: read partitions {sorted(opened)} of {len(modes.values)}")
        del runner, catalogs
        gc.collect()

        # F4: the lakehouse tee under a coordinator and two workers
        lcols = ["l_orderkey", "l_returnflag", "l_linestatus", "l_quantity",
                 "l_extendedprice", "l_discount", "l_tax", "l_shipdate"]
        d = gen.generate("lineitem", 0, f4_rows, lcols)
        for c in ("l_returnflag", "l_linestatus"):
            d[c] = np.asarray([str(v) for v in d[c].values])[d[c].ids]
        d = {c: (v if c in ("l_returnflag", "l_linestatus")
                 else np.asarray(v, dtype=np.int64)) for c, v in d.items()}
        iso = (np.datetime64("1970-01-01")
               + d["l_shipdate"].astype("timedelta64[D]")).astype(str)

        def dec(v):
            return [f"{x // 100}.{x % 100:02d}" for x in v.tolist()]

        cfg = NodeConfig({"ingest.wal-path": os.path.join(root, "wal"),
                          "lakehouse.path": os.path.join(root, "lakehouse"),
                          "staging.cache-bytes": str(1 << 30)})
        tk = ("mem", "default", "li")
        q1_li = Q1.replace("tpch.sf1.lineitem", "mem.default.li")

        def cluster():
            cats = CatalogManager()
            cats.register("mem", create_connector("memory"))
            coord = CoordinatorServer(config=cfg, catalogs=cats,
                                      device=dev).start()
            workers = [WorkerServer(coordinator_uri=coord.uri, catalogs=cats,
                                    device=dev).start() for _ in range(2)]
            deadline = time.monotonic() + 60
            while (len(coord.active_workers()) < 2
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            check(len(coord.active_workers()) == 2,
                  "F4: the workers did not announce themselves")
            return coord, workers, PrestoTpuClient(coord.uri, timeout_s=900)

        def shut(coord, workers):
            for w in workers:
                w.shutdown(graceful=False)
            coord.shutdown()

        def q1_rows(client, sql, label, want):
            nonlocal launches
            PA.onehot_reduce.launches = 0
            t0 = time.perf_counter()
            res = client.execute(sql)
            secs = time.perf_counter() - t0
            n_launch = PA.onehot_reduce.launches
            launches += n_launch
            rows = res.rows()
            out.append({"step": label, "s": secs,
                        "onehot_reduce_launches": n_launch})
            print(f"{label}: {secs:.4f} s, onehot_reduce launches "
                  f"{n_launch} [{card}]", flush=True)
            check(n_launch > 0 or not on_card,
                  f"{label}: no onehot_reduce launch")
            check(len(rows) == len(want), f"{label}: {len(rows)} groups, "
                  f"numpy {len(want)}")
            names = ("sum_qty", "sum_base_price", "sum_disc_price",
                     "sum_charge")
            scales = (2, 2, 4, 6)
            for r in rows:
                exp = want[(r[0], r[1])]
                check(r[9] == exp["count_order"], f"{label} {r[:2]}: count")
                for v, name, sc in zip(r[2:6], names, scales):
                    check(abs(float(v) - exp[name] / 10 ** sc)
                          <= 1e-12 * abs(exp[name] / 10 ** sc),
                          f"{label} {r[:2]} {name}: {v} vs {exp[name]}")
            return rows

        coord, workers, client = cluster()
        try:
            client.execute(
                "create table mem.default.li (l_orderkey bigint, "
                "l_returnflag varchar, l_linestatus varchar, l_quantity "
                "decimal(15,2), l_extendedprice decimal(15,2), l_discount "
                "decimal(15,2), l_tax decimal(15,2), l_shipdate date)")
            per = f4_rows // f4_commits
            sids = []
            t0 = time.perf_counter()
            for i in range(f4_commits):
                lo, hi = i * per, (i + 1) * per if i < f4_commits - 1 else f4_rows
                body = {"columns": {
                    "l_orderkey": d["l_orderkey"][lo:hi].tolist(),
                    "l_returnflag": d["l_returnflag"][lo:hi].tolist(),
                    "l_linestatus": d["l_linestatus"][lo:hi].tolist(),
                    "l_quantity": dec(d["l_quantity"][lo:hi]),
                    "l_extendedprice": dec(d["l_extendedprice"][lo:hi]),
                    "l_discount": dec(d["l_discount"][lo:hi]),
                    "l_tax": dec(d["l_tax"][lo:hi]),
                    "l_shipdate": iso[lo:hi].tolist()}, "commit": True}
                ack = rpc.call_json("POST", f"{coord.uri}/v1/ingest/"
                                    "mem.default.li", body)
                check(ack.get("committed"), f"F4 commit {i}: {ack}")
                sids.append(coord.ingest.store.current_sid(tk))
            ingest_s = time.perf_counter() - t0
            store = coord.ingest.store
            files = len(store.manifest(tk).files)
            out.append({"step": "F4 ingest", "s": ingest_s, "rows": f4_rows,
                        "commits": f4_commits, "files": files})
            print(f"F4 ingest: {f4_rows} rows in {f4_commits} POSTed "
                  f"commits in {ingest_s:.2f} s, {files} data files, "
                  f"snapshots {sids[0]}..{sids[-1]} [{card}]", flush=True)
            check(len(set(sids)) == f4_commits and files == f4_commits,
                  f"F4: snapshots {sids}, {files} files")
            want_all = numpy_q1_of(d)
            q1_rows(client, q1_li, "F4 Q1 over the ingested rows", want_all)
        finally:
            shut(coord, workers)
        gc.collect()

        # the restart: fresh catalogs, the same WAL and lakehouse
        t0 = time.perf_counter()
        coord, workers, client = cluster()
        try:
            restart_s = time.perf_counter() - t0
            store = coord.ingest.store
            n = client.execute("select count(*) from mem.default.li").rows()
            check(n == [[f4_rows]] or n == [(f4_rows,)],
                  f"F4 restart: {n} rows")
            check(store.sids(tk)[-f4_commits:] == sids,
                  f"F4 restart: lineage {store.sids(tk)} != {sids}")
            print(f"F4 restart: coordinator and workers up in "
                  f"{restart_s:.2f} s, {f4_rows} rows and "
                  f"{len(store.sids(tk))} snapshots restored [{card}]",
                  flush=True)
            out.append({"step": "F4 restart", "s": restart_s})
            q1_rows(client, q1_li, "F4 Q1 after the restart", want_all)
            mid = f4_commits // 2
            pin = sids[mid - 1]
            prefix = {c: v[:mid * (f4_rows // f4_commits)]
                      for c, v in d.items()}
            q1_pin = q1_li.replace("mem.default.li",
                                   f"mem.default.li for version as of {pin}")
            before = q1_rows(client, q1_pin, f"F4 Q1 for version as of {pin}",
                             numpy_q1_of(prefix))
            tip = client.execute(q1_li).rows()
            t0 = time.perf_counter()
            done = coord.ingest.compaction_tick(force=True)
            compact_s = time.perf_counter() - t0
            m = store.manifest(tk)
            print(f"F4 compaction: {done} table in {compact_s:.2f} s, tip "
                  f"{m.snapshot} with {len(m.files)} files [{card}]",
                  flush=True)
            out.append({"step": "F4 compaction", "s": compact_s,
                        "files": len(m.files)})
            check(done == 1 and m.compaction and len(m.files) < f4_commits,
                  f"F4 compaction: {done}, files {len(m.files)}")
            check(client.execute(q1_pin).rows() == before,
                  "F4: the pinned reader moved through compaction")
            check(client.execute(q1_li).rows() == tip,
                  "F4: the tip moved through compaction")
            snaps = client.execute(
                'select "table", snapshot_id, "rows", compaction from '
                "system.runtime.snapshots").rows()
            print(f"F4 system.runtime.snapshots: {snaps} [{card}]",
                  flush=True)
            check([tuple(r) for r in snaps] == [
                ("mem.default.li", m.snapshot, f4_rows, "compacted")],
                f"F4: system.runtime.snapshots {snaps}")
        finally:
            shut(coord, workers)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"files phase: {time.perf_counter() - phase_t0:.2f} s, "
          f"onehot_reduce launches {launches} [{card}]", flush=True)
    return launches, out


def bucket_of(n: int) -> int:
    """The staging bucket of ``n`` rows (a power of two, at least 1024)."""
    cap = 1024
    while cap < n:
        cap <<= 1
    return cap


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
    from presto_tpu_torch import native

    t0 = time.perf_counter()
    status = native.status()
    print(f"native: {status} (host libraries loaded, compiled if stale, in "
          f"{time.perf_counter() - t0:.2f} s)", flush=True)
    check(status == "native", "the host C++ loops did not build: the "
          "generator and the string codec would run in numpy")
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"split-cache budget of the SF10 and SF100 runners: "
          f"{cache_budget(torch.device('cuda'))} bytes, half the card's "
          f"{total} [{card}]", flush=True)

    phase("kernels")
    records = kernel_phase(card)

    phase("slice")
    keep = {}
    counts = slice_phase(card, keep=keep)

    phase("joins")
    joins_launches = joins_phase(card, records=records, keep=keep)

    distrib_want = {"Q3": keep["q3_rows"], "Q5": keep["q5_rows"]}

    phase("observe")
    observe_launches, observe_record = observe_phase(card, keep)

    phase("rest")
    rest_launches, rest_records = rest_phase(card)

    phase("stream")
    stream_launches, stream_records, baseline = stream_phase(
        card, records=records)

    phase("tpcds")
    tpcds_launches, tpcds_records = tpcds_phase(card)

    phase("cache")
    cache_launches, cache_records = cache_phase(card, baseline)

    phase("nested")
    nested_launches, nested_records = nested_phase(card, records=records)

    phase("write")
    write_launches, write_records = write_phase(
        card, want_q1_big=baseline["Q1"][0], records=records)

    phase("server")
    server_launches, server_records = server_phase(
        card, want_q1_big=baseline["Q1"][1].rows(), records=records)

    phase("serve")
    serve_launches, serve_records = serve_phase(card, records=records)

    phase("recover")
    recover_launches, recover_records = recover_phase(card)

    phase("qos")
    qos_launches, qos_records = qos_phase(
        card, want_q1_big=baseline["Q1"][1].rows())

    phase("distrib")
    distrib_launches, distrib_records = distrib_phase(
        card, want={"Q1": baseline["Q1"][1].rows(),
                    "Q18": baseline["Q18"][1].rows(), **distrib_want},
        records=records)

    phase("ici")
    ici_launches, ici_records = ici_phase(
        card, want_q1_big=baseline["Q1"][1].rows(), records=records)

    phase("fuzz")
    fuzz_launches, fuzz_records = fuzz_phase(card)

    phase("files")
    files_launches, files_records = 0, []
    if importlib.util.find_spec("pyarrow") is None:
        print("files: not run: pyarrow is not installed on this machine",
              flush=True)
    else:
        files_launches, files_records = files_phase(
            card, records=records, want_q1_big=baseline["Q1"][0])

    headline = next(r for r in records if r["label"] == "q1 fused")
    lanes = next(r for r in records if r["label"] == "q1 microbatch fused")
    shard = next(r for r in records if r["label"] == "distrib q1 shard fused")
    merge = next(r for r in records if r["label"] == "ici q1 merge fused")
    v3 = next(r for r in serve_records if r["step"] == "V3 8 Q1")
    kernels_line = {
        "kernels": [
            {
                "name": "onehot_reduce",
                "route": "cuda",
                "source": "presto_tpu_torch/csrc/onehot_reduce.cu",
                "replaces": "tools/pallas_groupby.py:96",
                "launches": (counts["onehot_reduce"] + joins_launches
                             + rest_launches + stream_launches
                             + tpcds_launches + cache_launches
                             + nested_launches + observe_launches
                             + write_launches + server_launches
                             + serve_launches + recover_launches
                             + qos_launches + distrib_launches
                             + ici_launches + fuzz_launches
                             + files_launches),
                "max_abs_err": headline["max_abs_err"],
                "ms": headline["ms"],
                "plain_ms": headline["plain_ms"],
                "bound_ms": headline["bound_ms"],
                "bound_by": headline["bound_by"],
                "library_ms": headline["library_ms"],
            },
            {
                # K1's batching rule: the serve phase's Q1 batch of 8
                # lanes, one launch for all of them
                "name": "onehot_reduce_lanes",
                "case": "q1 microbatch fused",
                "route": "cuda",
                "source": "presto_tpu_torch/csrc/onehot_reduce.cu",
                "replaces": "tools/pallas_groupby.py:96",
                "launches": v3["onehot_reduce_launches"],
                "max_abs_err": lanes["max_abs_err"],
                "ms": lanes["ms"],
                "plain_ms": lanes["plain_ms"],
                "bound_ms": lanes["bound_ms"],
                "bound_by": lanes["bound_by"],
                "library_ms": lanes["library_ms"],
                # x once per lane, as the kernel reads it; the 8 lanes'
                # scalar calls one at a time, timed
                "bound_lane_ms": lanes["bound_lane_ms"],
                "one_by_one_ms": lanes["one_by_one_ms"],
            },
        ] + [
            {
                # K1 on the multi-device exchange's paths: one shard's
                # partial GROUP BY of distributed Q1 (launches: the distrib
                # phase's), one ICI merge task's final over its
                # device-merged page (launches: the ici phase's)
                "name": "onehot_reduce",
                "case": rec["label"],
                "route": "cuda",
                "source": "presto_tpu_torch/csrc/onehot_reduce.cu",
                "replaces": "tools/pallas_groupby.py:96",
                "launches": n,
                "max_abs_err": rec["max_abs_err"],
                "ms": rec["ms"],
                "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"],
                # the merge's floor: an empty launch's device time
                **({"floor_ms": rec["floor_ms"]} if "floor_ms" in rec
                   else {}),
            }
            for rec, n in ((shard, distrib_launches), (merge, ici_launches))
        ] + [
            {
                # K1 over a file connector's pages: Q1's one call over the
                # parquet lineitem (launches: the files phase's, F1-F4)
                "name": "onehot_reduce",
                "case": rec["label"],
                "route": "cuda",
                "source": "presto_tpu_torch/csrc/onehot_reduce.cu",
                "replaces": "tools/pallas_groupby.py:96",
                "launches": files_launches,
                "max_abs_err": rec["max_abs_err"],
                "ms": rec["ms"],
                "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"],
            }
            for rec in records if rec["label"] == "files q1 parquet fused"
        ]
    }
    print(json.dumps({"cases": records, "slice": counts,
                      "joins_onehot_reduce": joins_launches,
                      "rest": rest_records, "rest_onehot_reduce": rest_launches,
                      "stream": stream_records,
                      "stream_onehot_reduce": stream_launches,
                      "tpcds": tpcds_records,
                      "tpcds_onehot_reduce": tpcds_launches,
                      "cache": cache_records,
                      "cache_onehot_reduce": cache_launches,
                      "nested": nested_records,
                      "nested_onehot_reduce": nested_launches,
                      "observe": observe_record,
                      "observe_onehot_reduce": observe_launches,
                      "write": write_records,
                      "write_onehot_reduce": write_launches,
                      "server": server_records,
                      "server_onehot_reduce": server_launches,
                      "serve": serve_records,
                      "serve_onehot_reduce": serve_launches,
                      "recover": recover_records,
                      "recover_onehot_reduce": recover_launches,
                      "qos": qos_records,
                      "qos_onehot_reduce": qos_launches,
                      "distrib": distrib_records,
                      "distrib_onehot_reduce": distrib_launches,
                      "ici": ici_records,
                      "ici_onehot_reduce": ici_launches,
                      "fuzz": fuzz_records,
                      "fuzz_onehot_reduce": fuzz_launches,
                      "files": files_records,
                      "files_onehot_reduce": files_launches,
                      "native": status, "card": card}))
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

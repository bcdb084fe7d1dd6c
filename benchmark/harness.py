"""One run of a cell: set-up, the measured window, the reference and the
comparison, and the metrics. ``run.py`` is the command line around
``run_cell``; the tests call ``run_cell`` on the CPU at a tiny size.

Order of a run:

1. Generate the configuration's tables on the device from the seed,
   work out their statistics there, copy the columns to the host once
   and free the device copy; reset the device's peak memory.
2. Mount the host columns as the catalog ``bench`` of a
   ``LocalQueryRunner`` (schema: the configuration's name).
3. Draw each query's pool of parameter sets from the seed; warm up by
   running every query of every pool twice (the first run stages the
   tables). Set-up ends here.
4. The window: one client, closed loop, the mix's queries in turn,
   each ``runner.execute(sql)``, its rows read, then a synchronize; it
   ends with the first query that ends after ``seconds`` (with
   ``trace``: also after ``TRACE_QUERIES`` queries, under
   torch.profiler).
5. Read the peak, free the program's state, generate the tables again
   from the seed, work out the reference answer of every parameter set
   that the window ran, compare every answer of the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import sys
import time
from typing import Dict, List, Optional

import torch

from benchmark import compare, layout, params
from benchmark import trace as tracing

#: queries the traced window holds at most
TRACE_QUERIES = 64
#: top-level module names that no run may load
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "presto_tpu")


@dataclasses.dataclass
class QueryRun:
    query: str
    pool_index: int
    latency_s: float
    scanned_rows: int
    rows: Optional[list]
    stats: Dict[str, float]
    error: Optional[str] = None


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read."""

    setup_s: float
    window_s: float
    queries: List[QueryRun]
    warmup: List[QueryRun]
    peak_bytes: Optional[int]
    query_meta: Dict[str, dict]
    trace: Optional[tracing.Trace] = None
    answers: Dict[tuple, object] = dataclasses.field(default_factory=dict)


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN_MODULES)


def scanned_rows(meta: dict, cfg: dict) -> int:
    return sum(n * cfg["tables"][t]["rows"] for t, n in meta["scans"].items())


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stats_of(qs) -> Dict[str, float]:
    return {k: float(getattr(qs, k)) for k in
            ("planning_ms", "optimization_ms", "staging_ms")}


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def build_runner(cfg: dict, seed: int, device, log):
    """Steps 1 and 2: the runner over the generated tables."""
    from benchmark.connector import GeneratedConnector, table_stats, to_host
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.exec.staging import CatalogManager
    from presto_tpu_torch.session import Session

    t0 = time.perf_counter()
    tables = layout.generator(cfg).generate(cfg, seed, device)
    stats = table_stats(cfg, tables)
    _sync(device)
    t1 = time.perf_counter()
    host = {t: {c: to_host(v) for c, v in cols.items()}
            for t, cols in tables.items()}
    del tables
    _free(device)
    log(f"generation and statistics {t1 - t0:.3f} s, copy to the host "
        f"{time.perf_counter() - t1:.3f} s")
    budget = None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        # every table stays resident: half the card, as chip_smoke.py's
        # cache_budget
        budget = torch.cuda.get_device_properties(device).total_memory // 2
    catalogs = CatalogManager()
    catalogs.register("bench", GeneratedConnector(cfg, host, stats))
    return LocalQueryRunner(
        catalogs=catalogs,
        session=Session(catalog="bench", schema=cfg["name"],
                        properties=dict(cfg.get("session", {}))),
        device=device,
        staging_cache_bytes=budget,
    )


def run_query(runner, device, query: str, index: int, sql: str,
              scanned: int) -> QueryRun:
    t0 = time.perf_counter()
    rows, error = None, None
    span = torch.profiler.record_function
    with span(tracing.QUERY_SPAN):
        try:
            with span(tracing.EXECUTE_SPAN):
                res = runner.execute(sql)
            with span(tracing.ROWS_SPAN):
                rows = res.exact_rows()
        except Exception as e:  # a failed query is counted, not fatal
            error = f"{type(e).__name__}: {e}"
        with span(tracing.SYNC_SPAN):
            _sync(device)
    latency = time.perf_counter() - t0
    last = runner.history.snapshot()
    stats = _stats_of(last[-1]) if last and last[-1].sql == sql else {}
    return QueryRun(query, index, latency, scanned, rows, stats, error)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             t0: float, bench: Optional[dict] = None,
             cfg: Optional[dict] = None, log=None) -> dict:
    """One run; returns the result line as a dict. ``cfg`` overrides the
    cell's configuration (the tests' tiny scale)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = bench or layout.benchmark()
    cell = layout.workload(bench, workload)
    cfg = cfg or layout.config(cell["config"])
    mix = layout.mix(cell["traffic"])
    if (mix["loop"], mix["clients"], mix["order"]) != ("closed", 1, "alternate"):
        raise ValueError("only one client in a closed loop, taking the "
                         "mix's queries in turn, is supported")
    device = torch.device(device)

    runner = build_runner(cfg, seed, device, log)
    meta = {q: layout.query_meta(q) for q in mix["queries"]}
    pools = {q: params.draw_pool(seed, q, meta[q], cfg, mix["pool"])
             for q in mix["queries"]}
    sqls = {q: [params.render(layout.query_sql(q), p) for p in pools[q]]
            for q in mix["queries"]}
    scanned = {q: scanned_rows(meta[q], cfg) for q in mix["queries"]}

    def schedule():
        issued = {q: 0 for q in mix["queries"]}
        for q in itertools.cycle(mix["queries"]):
            i = issued[q] % len(sqls[q])
            issued[q] += 1
            yield q, i

    from presto_tpu_torch.ops.aggregation import onehot_reduce

    warmup = []
    order = list(itertools.islice(schedule(), sum(map(len, sqls.values()))))
    for _ in range(2):
        launches = {q: 0 for q in mix["queries"]}
        for q, i in order:
            before = onehot_reduce.launches
            warmup.append(run_query(runner, device, q, i, sqls[q][i], scanned[q]))
            launches[q] += onehot_reduce.launches - before
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s; warm-up queries {len(warmup)}, failed "
        f"{sum(w.error is not None for w in warmup)}, K1 launches in the "
        f"second pass {launches}, first pass s "
        f"{[round(w.latency_s, 4) for w in warmup[:len(order)]]}")

    prof = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    runs: List[QueryRun] = []
    with prof, torch.profiler.record_function(tracing.WINDOW_SPAN):
        start = time.perf_counter()
        for q, i in schedule():
            runs.append(run_query(runner, device, q, i, sqls[q][i], scanned[q]))
            if time.perf_counter() - start >= seconds:
                break
            if trace and len(runs) >= TRACE_QUERIES:
                break
        window_s = time.perf_counter() - start
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else None)
    for q in mix["queries"]:
        lat = sorted(r.latency_s for r in runs if r.query == q)
        if lat:
            log(f"window {q}: {len(lat)} queries, median "
                f"{lat[len(lat) // 2]:.4f} s, max {lat[-1]:.4f} s")
    record = RunRecord(setup_s, window_s, runs, warmup, peak, meta)
    if trace:
        record.trace = tracing.from_profiler(prof, len(runs))
    del prof
    del runner
    _free(device)

    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)

    # the reference, once the program's state is freed
    t_ref = time.perf_counter()
    tables = layout.generator(cfg).generate(cfg, seed, device)
    for q, i in sorted({(r.query, r.pool_index) for r in runs}):
        record.answers[(q, i)] = layout.reference(q).answer(tables, pools[q][i])
    del tables
    _free(device)
    failed = sum(r.error is not None for r in runs + warmup)
    reading = compare.readings(
        ((record.answers[(r.query, r.pool_index)], r.rows)
         for r in runs if r.error is None),
        attempted=len(runs), failed=failed)
    log(f"reference and comparison {time.perf_counter() - t_ref:.3f} s over "
        f"{len(record.answers)} parameter sets, {len(runs)} answers")
    for r in runs + warmup:
        if r.error is not None:
            log(f"{r.query}[{r.pool_index}] failed: {r.error}")
            break

    return result_line(bench, cell, record, reading, trace, device)


class ForbiddenModules(RuntimeError):
    def __init__(self, found: List[str]):
        super().__init__("modules that no run may load: " + ", ".join(found))
        self.found = found


def metrics_of(bench: dict, cell: dict, record: RunRecord, trace: bool) -> dict:
    out = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and cell["name"] not in m["workloads"]:
            continue
        value = layout.metric_reader(m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(bench, cell, record: RunRecord, reading, trace: bool,
                device) -> dict:
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": 1, "memory_peak_bytes": record.peak_bytes}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    out = {
        "correct": compare.passed(reading),
        "attempted": len(record.queries),
        "failed": int(reading["failed"]),
        "metrics": metrics_of(bench, cell, record, trace),
        "device": dev,
    }
    if trace:
        dev["busy_s"] = tracing.busy_s(record.trace)
        dev["window_s"] = record.trace.window_s
        out["breakdown"] = tracing.breakdown(record.trace)
    out["checks"] = compare.checks(reading)
    return out

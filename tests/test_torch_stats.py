"""The port's query statistics (``presto_tpu_torch/exec/stats.py``): the
per-operator row counts of every run, the query-completed listeners,
the metrics and the query trace, against the JAX reference on the CPU.

``OperatorStats`` must equal the reference's node for node (walk id,
canonical fingerprint, output and input rows, batches, capacity, depth)
for whole-table, stage-at-a-time (fragmented, with dynamic filters) and
split-streamed runs under ``max_device_rows`` 8192. Streamed Q3 and Q18
are left out: above a partitioned join the port runs the row-
distributive chain per spill bucket where the reference stages the whole
join result (ROADMAP §3), so their runs differ by design. Timings
are not compared.
"""

from __future__ import annotations

import json
import os

import pytest

from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu.exec.stats import JsonlQueryEventListener as RefJsonl
from presto_tpu.utils.metrics import REGISTRY as REF_REGISTRY
from presto_tpu_torch.exec.local_runner import LocalQueryRunner
from presto_tpu_torch.exec.stats import (
    JsonlQueryEventListener,
    OperatorStats,
    QueryStats,
    SlowQueryLog,
    StageStats,
    TaskStats,
)
from presto_tpu_torch.utils.metrics import REGISTRY
from tpch_queries import QUERIES
from torch_parity import one_torch_thread  # noqa: F401

AGG = (
    "select l_returnflag, count(*) c from tpch.tiny.lineitem "
    "group by l_returnflag"
)
STREAMED = {"max_device_rows": "8192"}
WHOLE = {"max_fragment_weight": "0"}

CASES = {
    "agg_whole": (AGG, {}),
    "q1_whole": (QUERIES[1], {}),
    "q3_whole": (QUERIES[3], WHOLE),
    "q3_fragmented": (QUERIES[3], {}),
    "q5_fragmented": (QUERIES[5], {}),
    "q10_fragmented": (QUERIES[10], {}),
    "agg_streamed": (AGG, STREAMED),
    "q1_streamed": (QUERIES[1], STREAMED),
    "q4_streamed": (QUERIES[4], STREAMED),
}


def _ops(runner, sql, props):
    for k, v in props.items():
        runner.session.set(k, v)
    runner.execute(sql)
    qs = runner.history.snapshot()[-1]
    return qs, [
        (o.node_id, o.fingerprint, o.output_rows, o.input_rows, o.batches,
         o.output_capacity, o.depth)
        for o in qs.all_operator_stats()
    ]


@pytest.mark.parametrize("name", sorted(CASES))
def test_operator_stats_equal_the_reference(name):
    sql, props = CASES[name]
    ref_qs, ref_ops = _ops(RefRunner(), sql, props)
    qs, ops = _ops(LocalQueryRunner(device="cpu"), sql, props)
    assert ops and ops == ref_ops
    assert qs.plan_fingerprint == ref_qs.plan_fingerprint
    for attr in ("dynamic_filters", "dynamic_filter_rows_pruned",
                 "device_fragments", "retries", "output_rows"):
        assert getattr(qs, attr) == getattr(ref_qs, attr), attr
    if props is STREAMED:
        assert max(o[4] for o in ops) > 1  # batches summed per node
    # the run's window is attributed to each run's root operator
    assert any(o.wall_ms > 0 for o in qs.operators)


def test_operator_stats_disabled_is_empty():
    r = LocalQueryRunner(device="cpu")
    r.session.set("enable_operator_stats", "false")
    assert r.execute("select count(*) c from tpch.tiny.region").rows() == [(5,)]
    qs = r.history.snapshot()[-1]
    assert qs.all_operator_stats() == []
    assert qs.plan_fingerprint == ""


def test_operator_stats_labels_and_sizes():
    r = LocalQueryRunner(device="cpu")
    r.execute(AGG)
    ops = r.history.snapshot()[-1].all_operator_stats()
    scan = next(o for o in ops if "TableScan" in o.label)
    agg = next(o for o in ops if "Aggregate" in o.label)
    assert (scan.output_rows, agg.output_rows) == (59997, 3)
    assert agg.input_rows == 59997
    assert all(o.output_capacity > 0 and o.peak_page_bytes > 0 for o in ops)


def test_failed_query_is_recorded_and_reported(tmp_path):
    path = str(tmp_path / "events.jsonl")
    r = LocalQueryRunner(device="cpu", history_path=str(tmp_path / "h"))
    r.history.add_listener(JsonlQueryEventListener(path))
    f0 = int(REGISTRY.counter("queries.failed").total)
    with pytest.raises(Exception, match="scalar subquery"):
        r.execute(
            "select n_name from tpch.tiny.nation where n_nationkey = "
            "(select n_nationkey from tpch.tiny.nation)"
        )
    qs = r.history.snapshot()[-1]
    assert qs.state == "FAILED" and "scalar subquery" in qs.error
    assert int(REGISTRY.counter("queries.failed").total) == f0 + 1
    with open(path) as f:
        ev = json.loads(f.readlines()[-1])
    assert ev["state"] == "FAILED" and ev["query_id"] == qs.query_id
    # a failed run teaches the history store nothing
    assert r.history_store.stats()["writes"] == 0


def test_event_record_equals_the_reference_shape(tmp_path):
    ref_path, path = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    ref, port = RefRunner(), LocalQueryRunner(device="cpu")
    ref.history.add_listener(RefJsonl(ref_path))
    port.history.add_listener(JsonlQueryEventListener(path))
    # one registration per real path: a second listener on the same file
    # is dropped
    port.history.add_listener(JsonlQueryEventListener(path))
    for r in (ref, port):
        r.execute(QUERIES[3])
    with open(ref_path) as f:
        want = json.loads(f.read().splitlines()[-1])
    with open(path) as f:
        lines = f.read().splitlines()
    got = json.loads(lines[-1])
    assert len(lines) == 1
    assert set(got) == set(want)
    for key in ("event", "state", "plan_fingerprint", "output_rows",
                "input_rows", "dynamic_filters",
                "dynamic_filter_rows_pruned", "device_fragments"):
        assert got[key] == want[key], key
    assert [
        (o["fingerprint"], o["output_rows"], o["batches"])
        for o in got["operators"]
    ] == [
        (o["fingerprint"], o["output_rows"], o["batches"])
        for o in want["operators"]
    ]
    assert [s["name"] for s in got["spans"]] == ["query"]
    assert [c["name"] for c in got["spans"][0]["children"]] == [
        "plan", "execute"
    ]
    assert got["device"]["dispatches"] >= 1
    assert got["device"]["compiles"] == 0


def test_slow_query_log_renders_the_query_analyze(tmp_path):
    path = str(tmp_path / "slow.jsonl")
    r = LocalQueryRunner(device="cpu")
    r.history.add_listener(SlowQueryLog(path, threshold_ms=0.001))
    s0 = int(REGISTRY.counter("query.slow").total)
    r.execute("select count(*) c from tpch.tiny.region")
    assert int(REGISTRY.counter("query.slow").total) == s0 + 1
    with open(path) as f:
        rec = json.loads(f.readlines()[-1])
    assert rec["event"] == "slow_query"
    assert len(rec["plan_fingerprint"]) == 16
    assert rec["elapsed_ms"] >= rec["threshold_ms"]
    text = rec["explain_analyze"]
    assert "Operators (est -> actual" in text and "Span tree:" in text
    assert "device: dispatches 1, compiles 0" in text


def test_slow_query_log_off_at_zero_threshold(tmp_path):
    path = str(tmp_path / "slow_off.jsonl")
    r = LocalQueryRunner(device="cpu")
    r.history.add_listener(SlowQueryLog(path, threshold_ms=0.0))
    r.execute("select count(*) c from tpch.tiny.region")
    assert not os.path.exists(path)


def test_env_hooks_register_the_listeners(tmp_path, monkeypatch):
    ev, slow = str(tmp_path / "ev.jsonl"), str(tmp_path / "slow.jsonl")
    monkeypatch.setenv("PRESTO_TPU_EVENT_LOG", ev)
    monkeypatch.setenv("PRESTO_TPU_HISTORY_PATH", str(tmp_path / "hist"))
    monkeypatch.setenv("PRESTO_TPU_SLOW_QUERY_LOG", slow)
    monkeypatch.setenv("PRESTO_TPU_SLOW_QUERY_MS", "0.001")
    r = LocalQueryRunner(device="cpu")
    r.execute("select count(*) c from tpch.tiny.nation")
    assert r.history_store is not None
    assert r.history_store.stats()["writes"] == 1
    assert os.path.exists(ev) and os.path.exists(slow)
    monkeypatch.setenv("PRESTO_TPU_SLOW_QUERY_MS", "0")
    with pytest.warns(UserWarning, match="slow-query log is disabled"):
        LocalQueryRunner(device="cpu")


#: counters both packages move the same way for the same query sequence
_COUNTERS = (
    "queries.submitted", "queries.finished", "queries.failed",
    "plan.cache_hit", "plan.cache_miss", "dynamic_filter.built",
    "dynamic_filter.applied", "dynamic_filter.rows_pruned",
    "history.write", "history.hit", "history.miss",
)


def test_registry_counter_deltas_equal_the_reference(tmp_path):
    sequence = [QUERIES[3], QUERIES[5], QUERIES[3], AGG]

    def deltas(registry, runner):
        before = {c: registry.counter(c).total for c in _COUNTERS}
        for sql in sequence:
            runner.execute(sql)
        return {c: registry.counter(c).total - before[c] for c in _COUNTERS}

    want = deltas(REF_REGISTRY, RefRunner(history_path=str(tmp_path / "r")))
    got = deltas(
        REGISTRY,
        LocalQueryRunner(device="cpu", history_path=str(tmp_path / "p")),
    )
    assert got == want
    assert got["history.write"] == 4 and got["dynamic_filter.applied"] > 0


def test_device_counters_fold_into_the_query():
    from presto_tpu_torch.utils.telemetry import DEVICE

    r = LocalQueryRunner(device="cpu")
    before = DEVICE.snapshot()
    r.execute(QUERIES[3])
    after = DEVICE.snapshot()
    qs = r.history.snapshot()[-1]
    d = qs.device_dict()
    # one dispatch per fragment run, the root's included
    assert d["dispatches"] == qs.device_fragments + 1
    assert d["compiles"] == 0 and d["compile_ms"] == 0.0
    assert d["h2d_bytes"] > 0 and d["d2h_bytes"] > 0
    assert after["dispatches"] - before["dispatches"] == d["dispatches"]
    assert after["h2d_bytes"] - before["h2d_bytes"] == d["h2d_bytes"]
    # a warm run copies nothing to the device
    r.execute(QUERIES[3])
    assert r.history.snapshot()[-1].device_h2d_bytes == 0


def test_trace_spans_equal_the_reference():
    ref, port = RefRunner(), LocalQueryRunner(device="cpu")

    def names(runner):
        runner.execute(AGG)
        qs = runner.history.snapshot()[-1]
        assert len(qs.trace_id) == 32 and qs.trace.trace_id == qs.trace_id
        (root,) = qs.trace.to_tree()
        return root["name"], [c["name"] for c in root["children"]]

    assert names(port) == names(ref) == ("query", ["plan", "execute"])


def test_task_stats_round_trip_and_one_attempt_per_logical_task():
    ts = TaskStats(task_id="q.t.0.a0", query_id="q", state="FINISHED")
    ts.operators.append(
        OperatorStats(node_id=0, label="Scan", fingerprint="fpX",
                      output_rows=100, batches=1)
    )
    back = TaskStats.from_dict(ts.to_dict())
    assert back.operators == ts.operators
    twin = TaskStats.from_dict(ts.to_dict())
    twin.task_id = "q.t.0.a1"  # a speculative twin of the same task
    other = TaskStats.from_dict(ts.to_dict())
    other.task_id = "q.t.1.a0"
    other.operators[0].output_rows = 40
    qs = QueryStats(query_id="q", sql="s")
    qs.stages = [StageStats(stage_id=0, tasks=[ts, twin, other])]
    assert sum(o.output_rows for o in qs.all_operator_stats()) == 140
    assert qs.to_dict()["stages"][0]["rollup"]["tasks"] == 3


def test_concurrent_folds_lose_no_update():
    """The prefetch thread and the consumer fold into one stats sink:
    every fold holds ``_qs_mu``, so no increment is lost however the
    threads interleave."""
    import sys
    import threading

    r = LocalQueryRunner(device="cpu")
    qs = QueryStats(query_id="q", sql="s")
    cells = [(0, "Scan", 1024, 8, 0, "fp", ())]
    prog = object()
    n_threads, n_folds = 8, 300

    def work():
        r._active_qs = qs
        for _ in range(n_folds):
            r._fold_device_stat(device_dispatches=1, device_h2d_bytes=3)
            r._fold_dyn_stat("dynamic_filter_rows_pruned", 2)
            r._fold_operator_stats(cells, [5], 0.0, 0.0, prog=prog)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * n_folds
    assert qs.device_dispatches == total and qs.device_h2d_bytes == 3 * total
    assert qs.dynamic_filter_rows_pruned == 2 * total
    (op,) = qs.operators
    assert (op.output_rows, op.batches) == (5 * total, total)


def test_repeated_fragmented_runs_keep_their_fingerprints():
    """A cached plan's subtree signatures are reused across runs: a warm
    stage-at-a-time run reports the fingerprints a fresh runner computes
    from scratch, and the trees its runs rebuild are not kept with the
    plan's signatures."""
    r = LocalQueryRunner(device="cpu")
    for q in (3, 5, 3, 5):
        _qs, warm = _ops(r, QUERIES[q], {})
        _qs, fresh = _ops(LocalQueryRunner(device="cpu"), QUERIES[q], {})
        assert warm == fresh, q
        assert all(len(m._roots) == 1 for _root, m in r._plan_sigs.values())
    assert len(r._plan_sigs) == 2

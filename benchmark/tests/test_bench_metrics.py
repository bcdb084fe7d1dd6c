"""Each metric reader on a recorded run: a hand-made window of queries
and a trace of known intervals (microseconds on the profiler's clock)."""

import pytest

from benchmark import harness, layout
from benchmark.reference.common import Answer
from benchmark.trace import Trace, breakdown, busy_s


def _q(query, idx, lat, rows=100, stats=None, error=None):
    return harness.QueryRun(query, idx, lat, rows, [], stats or {
        "planning_ms": 1.0, "optimization_ms": 0.5, "staging_ms": 0.0},
        error)


def _record(trace=None):
    queries = [_q("q1", 0, 0.010 * (i + 1), rows=1000) for i in range(100)]
    queries.append(_q("q6", 0, 9.0, error="boom"))
    warm = [_q("q1", 0, 1.0, stats={"planning_ms": 2, "optimization_ms": 0,
                                     "staging_ms": 1500.0})]
    rec = harness.RunRecord(12.5, 2.0, queries, warm, 3 * 2 ** 30,
                            {"q1": layout.query_meta("q1"),
                             "q6": layout.query_meta("q6")}, trace)
    rec.answers[("q1", 0)] = Answer(rows=[], groupby_rows=1_000_000)
    return rec


def _trace():
    # window 0..1000 us; K1 100..150, two operator kernels overlapping
    # 300..400 and 350..500, a span annotation that is no device work
    device = [("void onehot_many<0>(...)", 100.0, 150.0),
              ("at::native::index_kernel", 300.0, 400.0),
              ("elementwise", 350.0, 500.0),
              ("outside", 2000.0, 2100.0)]
    runtime = [("cudaStreamSynchronize", 10.0, 20.0),
               ("cudaMemcpyAsync", 30.0, 40.0),
               ("cudaDeviceSynchronize", 50.0, 60.0),
               ("cudaStreamSynchronize", 5000.0, 5001.0)]
    host = [("bench.query", 0.0, 1000.0), ("aten::sort", 600.0, 900.0)]
    return Trace(device, runtime, host, (0.0, 1000.0), queries=4)


def read(name, rec):
    return layout.metric_reader(name).read(rec)


def test_end_to_end_readers():
    rec = _record()
    assert read("rows_per_s", rec) == pytest.approx(100 * 1000 / 2.0)
    # inclusive quantiles over 0.01 .. 1.00: the failed query left out
    assert read("query_p95_s", rec) == pytest.approx(0.9505)
    assert read("query_p95_s.q95", rec) == pytest.approx(0.9505)
    assert read("peak_device_gib", rec) == 3.0
    assert read("setup_s", rec) == 12.5
    assert read("staging_s", rec) == 1.5
    assert read("plan_ms", rec) == 1.5


def test_trace_readers():
    rec = _record(_trace())
    assert busy_s(rec.trace) == pytest.approx(250e-6)
    assert read("device_idle_share", rec) == pytest.approx(75.0)
    assert read("syncs_per_query", rec) == 0.25
    assert read("operator_device_ms", rec) == pytest.approx(250e-6 / 4 * 1e3)
    # K1: 100 Q1s x (1e6 rows x 44 B + 8 outputs x 6 segments x 8 B) over
    # 50 us at 3.35 TB/s
    want = 100 * (1e6 * 44 + 8 * 6 * 8) / 3.35e12 / 50e-6 * 100
    assert read("k1_roofline", rec) == pytest.approx(want)
    b = breakdown(rec.trace)
    assert b["device_ops"][0] == ["elementwise", pytest.approx(1.5e-4)]
    # gaps 0..100, 150..300 and 500..1000, named by the innermost host
    # event under their middle
    assert b["idle_gaps"] == [
        ["aten::sort", pytest.approx(500e-6)],
        ["bench.query", pytest.approx(150e-6)],
        ["cudaDeviceSynchronize", pytest.approx(100e-6)]]


def test_readers_without_a_trace_read_nothing():
    rec = _record()
    for name in ("syncs_per_query", "operator_device_ms", "k1_roofline",
                 "device_idle_share"):
        assert read(name, rec) is None

"""The readers of the program's spans (``dispatch_ms``,
``dispatch_idle_ms``, ``result_copy_ms``, ``host_root_ms``): on a
hand-made trace of known ``presto.*`` intervals and idle gaps
(microseconds on the profiler's clock), and on a real CPU capture of a
tiny query, where each reads a positive value."""

import pytest
import torch

from benchmark import harness, layout, program_spans
from benchmark.trace import WINDOW_SPAN, Trace, from_profiler, merged

READERS = ("dispatch_ms", "dispatch_idle_ms", "result_copy_ms",
           "host_root_ms")


def read(name, trace):
    rec = harness.RunRecord(1.0, 1.0, [], [], None, {}, trace)
    return layout.metric_reader(name).read(rec)


def _trace():
    # window 0..1000 us, two queries. Dispatch: 100..300 with a nested
    # 150..250 and an overlapping 280..400, then 600..700, and one
    # outside the window; a per-node span inside the first
    host = [("bench.query", 0.0, 1000.0),
            ("presto.dispatch", 100.0, 300.0),
            ("presto.dispatch", 150.0, 250.0),
            ("presto.op.JoinNode", 120.0, 200.0),
            ("presto.dispatch", 280.0, 400.0),
            ("presto.result_copy", 420.0, 450.0),
            ("presto.host_ops", 460.0, 500.0),
            ("presto.dispatch", 600.0, 700.0),
            ("presto.dispatch", 1200.0, 1300.0)]
    # idle gaps 100..180 and 220..400 (in the first dispatch union),
    # 600..700 (in the second) and 800..900 (under no program span)
    device = [("k", 0.0, 100.0), ("k", 180.0, 220.0), ("k", 400.0, 600.0),
              ("k", 700.0, 800.0), ("k", 900.0, 1000.0)]
    return Trace(device, [], host, (0.0, 1000.0), queries=2)


def test_span_union_counts_nested_and_overlapping_spans_once():
    assert program_spans.intervals(_trace(), "dispatch") == [
        (100.0, 400.0), (600.0, 700.0)]
    # (300 + 100) us over two queries
    assert read("dispatch_ms", _trace()) == pytest.approx(0.2)
    assert read("result_copy_ms", _trace()) == pytest.approx(0.015)
    assert read("host_root_ms", _trace()) == pytest.approx(0.02)


def test_dispatch_idle_takes_the_gaps_under_dispatch_alone():
    # 80 + 180 + 100 us; the gap 800..900 lies under no program span
    assert read("dispatch_idle_ms", _trace()) == pytest.approx(0.18)
    # a gap that starts under a span but whose midpoint lies past its
    # end is not the span's
    t = Trace([("k", 0.0, 150.0), ("k", 260.0, 1000.0)], [],
              [("presto.dispatch", 100.0, 200.0)], (0.0, 1000.0), queries=1)
    assert read("dispatch_idle_ms", t) == 0.0
    t.device[1] = ("k", 240.0, 1000.0)  # gap 150..240, mid 195: in
    assert read("dispatch_idle_ms", t) == pytest.approx(0.09)


def test_without_the_programs_spans_the_readers_read_nothing():
    bare = Trace([("k", 0.0, 10.0)], [], [("bench.query", 0.0, 1000.0)],
                 (0.0, 1000.0), queries=2)
    for name in READERS:
        assert read(name, bare) is None, name
        assert read(name, None) is None, name


def _capture(runner, sql, queries):
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]
    ) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            for _ in range(queries):
                runner.execute(sql)
    return from_profiler(prof, queries)


def test_readers_on_a_real_capture_of_a_tiny_query():
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner

    sql = ("select l_returnflag, count(*) c, sum(l_quantity) q "
           "from tpch.tiny.lineitem group by l_returnflag "
           "order by l_returnflag")
    runner = LocalQueryRunner(device="cpu")
    runner.execute(sql)
    trace = _capture(runner, sql, 3)
    for name in ("dispatch_ms", "result_copy_ms", "host_root_ms"):
        assert read(name, trace) > 0, name
    # the CPU has no device events: call the card busy everywhere but
    # under dispatch, and the idle under dispatch is dispatch itself
    spans = program_spans.intervals(trace, "dispatch")
    lo, hi = trace.window
    edges = [lo] + [x for s, e in spans for x in (s, e)] + [hi]
    trace.device = [("k", s, e) for s, e in zip(edges[::2], edges[1::2])
                    if e > s]
    assert merged(trace.device)
    assert read("dispatch_idle_ms", trace) == pytest.approx(
        read("dispatch_ms", trace))
    assert read("dispatch_idle_ms", trace) > 0


def test_a_traced_tiny_run_reports_the_span_metrics(cpu_run):
    out = cpu_run("tpch_sf10.scan_agg", 2**31 + 21, trace=True)
    assert out["correct"], out["checks"]
    for name in READERS:
        assert name in out["metrics"], name
    for name in ("dispatch_ms", "result_copy_ms", "host_root_ms"):
        assert out["metrics"][name]["value"] > 0, name

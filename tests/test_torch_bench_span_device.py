"""The readers of what the sorted GROUP BY's span costs the card
(``sorted_agg_device_ms``, ``sorted_agg_idle_ms``, through
``benchmark/span_device.py``): on hand-made traces of known launches,
device activities and ``presto.sorted_agg`` intervals (microseconds on
the profiler's clock), and on a real CPU capture of a tiny query."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, layout, span_device  # noqa: E402
from benchmark.trace import Trace  # noqa: E402

#: the cells whose queries run a sorted GROUP BY: Q95's distinct count,
#: Q3's, Q18's two
CELLS = ["tpcds_sf10.q95", "tpch_sf10.join", "tpch_sf10.q18"]


def read(name, trace):
    rec = harness.RunRecord(1.0, 1.0, [], [], None, {}, trace)
    return layout.metric_reader(name).read(rec)


def _trace():
    # two queries in a 0..1000 us window. The first launches at 10 (a
    # copy), 20 and 30 (inside the span 15..35) and 40 (a cuLaunchKernel,
    # among the host events); its four activities run in that order.
    # The second holds no span; its activity is not the span's.
    host = [("bench.query", 0.0, 500.0), ("bench.query", 500.0, 1000.0),
            ("presto.sorted_agg", 15.0, 35.0),
            ("cuLaunchKernel", 40.0, 42.0)]
    runtime = [("cudaMemcpyAsync", 10.0, 12.0),
               ("cudaLaunchKernel", 20.0, 22.0),
               ("cudaStreamSynchronize", 25.0, 26.0),
               ("cudaLaunchKernel", 30.0, 32.0),
               ("cudaLaunchKernel", 600.0, 602.0)]
    device = [("Memcpy HtoD", 14.0, 18.0), ("sort", 50.0, 110.0),
              ("scan", 110.0, 130.0), ("k1", 130.0, 200.0),
              ("k", 610.0, 900.0)]
    return Trace(device, runtime, host, (0.0, 1000.0), queries=2)


def test_device_time_of_the_launches_made_inside_the_span():
    # the sort and the scan: (60 + 20) us over two queries
    assert read("sorted_agg_device_ms", _trace()) == pytest.approx(0.04)


def test_a_query_whose_launches_and_activities_differ_reads_nothing():
    # the profiler only loses records: more activities than launches,
    # in a query holding the span or in one without it, cannot be paired
    t = _trace()
    t.device.append(("extra", 300.0, 310.0))
    assert read("sorted_agg_device_ms", t) is None
    t = _trace()
    t.device.append(("extra", 950.0, 960.0))
    assert read("sorted_agg_device_ms", t) is None


def _three_queries():
    # a third query holds the span too: launches at 1030, 1032 and 1034
    # inside 1020..1040, activities back to back from 1100; the second
    # query launches twice, its activities back to back
    t = _trace()
    t.window = (0.0, 1500.0)
    t.queries = 3
    t.host += [("bench.query", 1000.0, 1500.0),
               ("presto.sorted_agg", 1020.0, 1040.0)]
    t.runtime += [("cudaLaunchKernel", 602.0, 604.0),
                  ("cudaLaunchKernel", 1030.0, 1031.0),
                  ("cudaLaunchKernel", 1032.0, 1033.0),
                  ("cudaLaunchKernel", 1034.0, 1035.0)]
    t.device[-1] = ("k", 610.0, 700.0)
    t.device += [("k", 700.0, 900.0), ("sort", 1100.0, 1150.0),
                 ("scan", 1150.0, 1160.0), ("k", 1160.0, 1170.0)]
    return t


def test_a_query_that_cannot_be_paired_is_left_out_of_the_mean():
    t = _three_queries()
    # (60 + 20) and (50 + 10 + 10) us over three queries
    assert read("sorted_agg_device_ms", t) == pytest.approx(150 / 3e3)
    # the first query loses its first record, as the profiler does when
    # it starts: the third's 70 us stand for both queries holding the span
    del t.device[0]
    assert read("sorted_agg_device_ms", t) == pytest.approx(140 / 3e3)


def test_a_block_that_does_not_start_at_an_idle_gap_reads_nothing():
    # a record lost in the third query shifts the pairing from the end:
    # the third's block would start at 700 us, where the second's two
    # activities meet with no idle gap, and the first lost its pairing
    t = _three_queries()
    del t.device[-2]
    assert read("sorted_agg_device_ms", t) is None


@pytest.mark.parametrize("offset", [-300.0, 5000.0])
def test_an_offset_of_the_cards_clock_does_not_move_the_reading(offset):
    t = _three_queries()
    t.device = [(n, s + offset, e + offset) for n, s, e in t.device]
    assert read("sorted_agg_device_ms", t) == pytest.approx(150 / 3e3)


def test_a_program_without_the_span_reads_nothing():
    t = _trace()
    t.host = [iv for iv in t.host if iv[0] != "presto.sorted_agg"]
    assert read("sorted_agg_device_ms", t) is None
    assert read("sorted_agg_idle_ms", t) is None
    assert read("sorted_agg_ms", t) is None


def test_the_idle_reading_is_dispatch_idle_ms_under_another_span():
    # the gaps 0..14, 18..50 and 200..610 and 900..1000; only 18..50
    # has its midpoint in 15..35 (as dispatch_idle_ms reads its span)
    t = _trace()
    assert read("sorted_agg_idle_ms", t) == pytest.approx(0.016)
    t.host = [("presto.dispatch" if n == "presto.sorted_agg" else n, s, e)
              for n, s, e in t.host]
    assert read("dispatch_idle_ms", t) == pytest.approx(0.016)
    assert span_device.idle_ms_in(
        harness.RunRecord(1.0, 1.0, [], [], None, {}, t), "dispatch"
    ) == pytest.approx(0.016)


def test_the_host_span_reads_the_issue_time():
    assert read("sorted_agg_ms", _trace()) == pytest.approx(0.01)


@pytest.mark.parametrize("name", ["sorted_agg_ms", "sorted_agg_idle_ms",
                                  "sorted_agg_device_ms"])
def test_the_benchmark_reads_it_in_each_cell_with_a_sorted_group_by(name):
    m = {x["name"]: x for x in layout.benchmark()["per_layer"]}[name]
    assert m["workloads"] == CELLS
    assert m["moves"] == "rows_per_s"


def test_a_real_cpu_capture_reads_no_device_time():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace as tracing
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner

    sql = ("select o_custkey, count(*) c from tpch.tiny.orders "
           "group by o_custkey order by c desc, o_custkey limit 3")
    r = LocalQueryRunner(device="cpu")
    r.execute(sql)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(tracing.WINDOW_SPAN):
            with torch.profiler.record_function(tracing.QUERY_SPAN):
                r.execute(sql)
    t = tracing.from_profiler(prof, 1)
    assert read("sorted_agg_ms", t) > 0
    # no card: nothing launched and no activity
    assert read("sorted_agg_device_ms", t) == 0.0
    assert read("sorted_agg_idle_ms", t) is not None

"""The port's program spans (``presto_tpu_torch/utils/tracing.py``) on
the CPU: the query tree that ``/v1/query``, EXPLAIN ANALYZE and the event
log serve, and its mirror on ``torch.profiler``'s clock as ``presto.*``
events at FUNCTION scope, with a ``presto.op.<NodeClass>`` span per plan
node there alone. Also the compile count that ``kernels.load`` makes
when ``nvcc`` runs, folded into the query whose run made it."""

from __future__ import annotations

import contextlib

import pytest
import torch

from presto_tpu_torch import kernels
from presto_tpu_torch.exec import local_runner
from presto_tpu_torch.exec.local_runner import LocalQueryRunner
from presto_tpu_torch.session import Session
from presto_tpu_torch.sql import parse_statement
from presto_tpu_torch.utils import tracing
from presto_tpu_torch.utils.telemetry import DEVICE
from torch_parity import one_torch_thread  # noqa: F401 (module fixture)

#: a filter, a one-hot GROUP BY and an ORDER BY peeled to the host root
#: stage
Q1_LIKE = (
    "select l_returnflag, count(*) c, sum(l_quantity) q "
    "from tpch.tiny.lineitem where l_shipdate < date '1998-09-01' "
    "group by l_returnflag order by l_returnflag"
)
JOIN = (
    "select n_name, count(*) c from tpch.tiny.customer c "
    "join tpch.tiny.nation n on c.c_nationkey = n.n_nationkey "
    "group by n_name order by c desc, n_name limit 5"
)
#: a grouped build side heavy enough to run as a fragment of its own
GROUPED_BUILD = (
    "select c_mktsegment, count(*) c from tpch.tiny.customer c join "
    "(select o_custkey, count(*) k from tpch.tiny.orders "
    "group by o_custkey) o on c.c_custkey = o.o_custkey "
    "group by c_mktsegment order by c_mktsegment"
)
TREE_SPANS = ("query", "plan", "execute", "dispatch", "control_read",
              "result_copy", "host_ops")


def _profiled(fn):
    """(fn's result, the presto.* events of torch.profiler's capture
    around it as (name, scope, start, end), by start)."""
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]
    ) as prof:
        out = fn()
    evs = sorted(
        (e.name, e.scope, e.time_range.start, e.time_range.end)
        for e in prof.events() if e.name.startswith(tracing.PROFILER_PREFIX)
    )
    return out, sorted(evs, key=lambda e: e[2])


def _inside(inner, outer) -> bool:
    return outer[2] <= inner[2] and inner[3] <= outer[3]


def _one(evs, name):
    got = [e for e in evs if e[0] == name]
    assert len(got) == 1, (name, got)
    return got[0]


def _tree(runner):
    (root,) = runner.history.snapshot()[-1].trace.to_tree()
    return root


def _children(span, name=None):
    return [c for c in span["children"] if name is None or c["name"] == name]


@pytest.fixture
def warm_runner():
    r = LocalQueryRunner(device="cpu")
    r.execute(Q1_LIKE)
    return r


def test_a_profiled_query_nests_its_spans(warm_runner):
    _, evs = _profiled(lambda: warm_runner.execute(Q1_LIKE))
    span = {n: _one(evs, "presto." + n) for n in TREE_SPANS}
    # presto.query is the whole statement: the text parses inside it,
    # before the plan
    parse = _one(evs, "presto.parse")
    assert _inside(parse, span["query"])
    assert parse[3] <= span["plan"][2]
    assert _inside(span["plan"], span["query"])
    assert _inside(span["execute"], span["query"])
    assert span["plan"][3] <= span["execute"][2]
    for n in ("dispatch", "control_read", "result_copy", "host_ops"):
        assert _inside(span[n], span["execute"]), n
    # in the order the run takes them
    order = [span[n] for n in TREE_SPANS[3:]]
    assert all(a[3] <= b[2] for a, b in zip(order, order[1:]))
    ops = [e for e in evs if e[0].startswith("presto.op.")]
    assert {e[0] for e in ops} >= {
        "presto.op.AggregationNode", "presto.op.FilterNode",
        "presto.op.TableScanNode"}
    assert all(_inside(e, span["dispatch"]) for e in ops)
    # a node's span holds its source's: the filter runs inside the
    # aggregation that reads it
    assert _inside(_one(evs, "presto.op.FilterNode"),
                   _one(evs, "presto.op.AggregationNode"))


def test_every_program_span_records_at_function_scope(warm_runner):
    # FUNCTION scope (0), as an aten operator: never a USER_SCOPE range,
    # which the profiler mirrors on a card as a device annotation
    _, evs = _profiled(lambda: warm_runner.execute(JOIN))
    assert len(evs) > 8
    assert {scope for _, scope, _, _ in evs} == {0}
    assert "presto.op.JoinNode" in {e[0] for e in evs}


def test_no_profiler_records_nothing(warm_runner, monkeypatch):
    made = []

    class Counting:
        def __init__(self, name):
            made.append(name)

        def __enter__(self):
            return None

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tracing, "_RecordFunctionFast", Counting)
    assert not tracing.recording()
    noop = tracing.profiled("dispatch")
    assert noop is tracing.profiled("op.JoinNode")
    assert isinstance(noop, contextlib.nullcontext)
    warm_runner.execute(Q1_LIKE)
    assert made == []
    # the same query under a profiler makes every span
    _profiled(lambda: warm_runner.execute(Q1_LIKE))
    assert {"presto." + n for n in TREE_SPANS + ("parse",)} <= set(made)
    assert any(n.startswith("presto.op.") for n in made)


def test_the_tree_keeps_plan_and_execute_at_its_root(warm_runner):
    warm_runner.execute(Q1_LIKE)
    root = _tree(warm_runner)
    assert root["name"] == "query"
    assert [c["name"] for c in root["children"]] == ["plan", "execute"]
    (execute,) = _children(root, "execute")
    assert [c["name"] for c in execute["children"]] == [
        "dispatch", "control_read", "result_copy", "host_ops"]
    # the per-node spans stay off the tree
    assert not any(c["children"] for c in execute["children"])


def test_a_cold_query_stages_each_table_in_a_span():
    r = LocalQueryRunner(device="cpu")
    r.execute(JOIN)
    (execute,) = _children(_tree(r), "execute")
    staging = _children(execute, "staging")
    assert sorted(s["attrs"]["table"] for s in staging) == [
        "tpch.tiny.customer", "tpch.tiny.nation"]
    rows = {s["attrs"]["table"]: s["attrs"]["rows"] for s in staging}
    assert rows == {"tpch.tiny.customer": 1500, "tpch.tiny.nation": 25}
    assert all(s["attrs"]["bytes"] > 0 for s in staging)
    assert all(s["end"] >= s["start"] > 0 for s in staging)
    # warm: the split cache serves both tables, nothing is staged
    r.execute(JOIN)
    (execute,) = _children(_tree(r), "execute")
    assert not _children(execute, "staging")


def test_the_streamed_path_dispatches_each_batch_in_a_span():
    r = LocalQueryRunner(device="cpu", session=Session(properties={
        "max_device_rows": 16_384, "page_capacity": 4_096,
        "spill_enabled": True, "staging_prefetch_depth": 2}))
    _, evs = _profiled(lambda: r.execute(Q1_LIKE))
    dispatch = [e for e in evs if e[0] == "presto.dispatch"]
    # lineitem (~60k rows) streams in batches of 4,096, each its own run
    assert len(dispatch) > 4
    execute = _one(evs, "presto.execute")
    assert all(_inside(e, execute) for e in dispatch)
    root = _tree(r)
    # the prefetch thread's staging stays on the profiler's timeline and
    # never lands beside the root's children
    assert [c["name"] for c in root["children"]] == ["plan", "execute"]
    (execute_span,) = _children(root, "execute")
    assert len(_children(execute_span, "dispatch")) == len(dispatch)


def test_the_micro_batch_path_dispatches_in_a_span():
    r = LocalQueryRunner(device="cpu")
    sqls = [
        "select count(*) n, sum(c_acctbal) s from tpch.tiny.customer "
        f"where c_custkey < {k}" for k in (100, 200, 300)
    ]
    for s in sqls:
        r.execute(s)
    plans = [r.plan_cached_keyed(parse_statement(s))[0] for s in sqls]
    res, evs = _profiled(
        lambda: r.execute_plan_microbatch(plans, [None] * len(plans)))
    assert [x.rows()[0][0] for x in res] == [99, 199, 299]
    dispatch = _one(evs, "presto.dispatch")
    read = _one(evs, "presto.control_read")
    assert dispatch[3] <= read[2]
    assert any(e[0] == "presto.op.AggregationNode" and _inside(e, dispatch)
               for e in evs)


def test_the_fragmented_path_dispatches_each_fragment_in_a_span():
    r = LocalQueryRunner(device="cpu", session=Session(properties={
        "max_fragment_weight": 10}))
    # the build side's keys pre-filter the probe side
    r.execute(GROUPED_BUILD)
    qs = r.history.snapshot()[-1]
    assert qs.device_fragments >= 1 and qs.dynamic_filters == 1
    (execute,) = _children(_tree(r), "execute")
    # every fragment and the final tree: one dispatch and one control
    # read each, and one read of the executed build side's keys
    assert len(_children(execute, "dispatch")) == qs.device_fragments + 1
    assert len(_children(execute, "control_read")) == qs.device_fragments + 1
    assert len(_children(execute, "dynamic_filter")) == 1
    # on the profiler's timeline alone: the fragment planning around the
    # fragments' runs, and each run's operator-stats fold
    _, evs = _profiled(lambda: r.execute(GROUPED_BUILD))
    fragments = _one(evs, "presto.fragments")
    assert sum(_inside(e, fragments) for e in evs
               if e[0] == "presto.dispatch") == qs.device_fragments
    assert [e[0] for e in evs].count("presto.operator_stats") == (
        qs.device_fragments + 1)


def test_a_kernel_build_counts_one_compile_on_the_query_that_made_it(
    monkeypatch,
):
    name = "tracing_probe_kernel"
    built = []

    def fake_build(src, so, compiler):
        built.append(src.name)
        return True  # the compiler ran

    monkeypatch.setattr(kernels, "build", fake_build)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: object())
    monkeypatch.delitem(kernels._loaded, name, raising=False)
    project = local_runner.project

    def project_loading_a_kernel(*args, **kwargs):
        kernels.load(name)
        return project(*args, **kwargs)

    monkeypatch.setattr(local_runner, "project", project_loading_a_kernel)
    r = LocalQueryRunner(device="cpu")
    before = DEVICE.snapshot()
    r.execute(Q1_LIKE)
    after = DEVICE.snapshot()
    qs = r.history.snapshot()[-1]
    assert built == [f"{name}.cu"]
    assert after["compiles"] - before["compiles"] == 1
    assert qs.device_compiles == 1
    assert qs.device_compile_ms == pytest.approx(
        after["compile_ms"] - before["compile_ms"])
    assert qs.device_dict()["compiles"] == 1
    # warm: the library is loaded, nothing builds
    r.execute(Q1_LIKE)
    warm = r.history.snapshot()[-1]
    assert (warm.device_compiles, warm.device_compile_ms) == (0, 0.0)
    assert DEVICE.snapshot()["compiles"] == after["compiles"]
    # a library already built (build finds it fresh) counts nothing
    monkeypatch.setattr(kernels, "build", lambda src, so, compiler: False)
    kernels._loaded.pop(name)
    r.execute(Q1_LIKE)
    assert r.history.snapshot()[-1].device_compiles == 0
    assert DEVICE.snapshot()["compiles"] == after["compiles"]
    kernels._loaded.pop(name, None)


#: a GROUP BY over an integer key with no provable domain: the sorted
#: path (one stable sort, group spans, aggregates), not K1
SORTED = (
    "select o_custkey, count(*) c from tpch.tiny.orders "
    "group by o_custkey order by c desc, o_custkey limit 3"
)


def test_the_sorted_group_by_opens_its_span_once_a_call(warm_runner):
    warm_runner.execute(SORTED)
    _, evs = _profiled(lambda: warm_runner.execute(SORTED))
    span = _one(evs, "presto.sorted_agg")
    assert span[1] == 0  # FUNCTION scope: never mirrored on a card
    assert _inside(span, _one(evs, "presto.op.AggregationNode"))
    assert _inside(span, _one(evs, "presto.dispatch"))
    # the one-hot GROUP BY (K1) never opens it
    _, evs = _profiled(lambda: warm_runner.execute(Q1_LIKE))
    assert "presto.sorted_agg" not in {e[0] for e in evs}
    # a query with two sorted GROUP BYs opens it twice
    two = (
        "select c, count(*) n from (select o_custkey, count(*) c from "
        "tpch.tiny.orders group by o_custkey) t group by c order by c"
    )
    warm_runner.execute(two)
    _, evs = _profiled(lambda: warm_runner.execute(two))
    assert [e[0] for e in evs].count("presto.sorted_agg") == 2


_NOOP_SPAN = contextlib.nullcontext()


def test_the_sorted_span_is_not_made_without_a_profiler(warm_runner,
                                                        monkeypatch):
    made = []
    monkeypatch.setattr(tracing, "_RecordFunctionFast",
                        lambda name: made.append(name) or _NOOP_SPAN)
    warm_runner.execute(SORTED)
    assert made == []
    _profiled(lambda: warm_runner.execute(SORTED))
    assert made.count("presto.sorted_agg") == 1


def test_an_order_dependent_aggregate_takes_the_sorted_span(warm_runner):
    # a key with a small provable domain, but max_by needs each group's
    # value order: the sorted path, not K1, and so the span
    sql = (
        "select o_orderstatus, max_by(o_orderkey, o_totalprice) k "
        "from tpch.tiny.orders group by o_orderstatus order by 1"
    )
    warm_runner.execute(sql)
    _, evs = _profiled(lambda: warm_runner.execute(sql))
    assert _inside(_one(evs, "presto.sorted_agg"),
                   _one(evs, "presto.op.AggregationNode"))


def test_a_forced_capacity_overflow_counts_each_re_run(monkeypatch):
    from presto_tpu_torch.plan import planner

    # every GROUP BY planned at the smallest bucket: 1,024 groups
    monkeypatch.setattr(planner._Planner, "_agg_bucket",
                        lambda self, node: 1024)
    r = LocalQueryRunner(device="cpu")
    res = r.execute(
        "select o_orderkey, count(*) c from tpch.tiny.orders "
        "group by o_orderkey"
    )
    assert len(res.rows()) == 15_000
    # 15,000 groups: the run at 1,024 and the one at 4,096 overflow,
    # the one at 16,384 holds them
    assert r.overflow_retries == 2
    assert r.history.snapshot()[-1].retries == 2
    # a plan that fits re-runs nothing
    r.execute(Q1_LIKE)
    assert r.overflow_retries == 2
    assert r.history.snapshot()[-1].retries == 0

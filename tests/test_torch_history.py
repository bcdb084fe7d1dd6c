"""The port's history-based statistics (``presto_tpu_torch/plan/history.py``)
against the JAX reference on the CPU: canonical node fingerprints equal
the reference's for every node of every TPC-H query's optimized plan
(and the cached canonical plan's, whose literals are RuntimeParam
slots); the on-disk store round-trips, evicts, skips corrupt lines and
collects old segments exactly as the reference's does; a warm run's
history-fed estimates shrink EXPLAIN ANALYZE's error; and planning with
history off, or with no store, is bit-exact.
"""

from __future__ import annotations

import os
import re

import pytest

from presto_tpu.connectors import create_connector as ref_connector
from presto_tpu.connectors.spi import TableHandle as RefHandle
from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu.plan import history as ref_history
from presto_tpu.plan import nodes as RN
from presto_tpu.plan.optimizer import prune_columns as ref_prune
from presto_tpu.plan.optimizer import push_scan_constraints as ref_push
from presto_tpu.plan.planner import plan_statement as ref_plan
from presto_tpu.sql import parse_statement as ref_parse
from presto_tpu_torch.connectors import create_connector
from presto_tpu_torch.connectors.spi import TableHandle
from presto_tpu_torch.exec.local_runner import LocalQueryRunner
from presto_tpu_torch.exec.staging import obj_array
from presto_tpu_torch.plan import history
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.plan.history import QueryHistoryStore
from presto_tpu_torch.plan.optimizer import prune_columns, push_scan_constraints
from presto_tpu_torch.plan.planner import plan_statement
from presto_tpu_torch.sql import parse_statement
from presto_tpu_torch.utils.metrics import REGISTRY
from tpch_queries import QUERIES
from torch_parity import one_torch_thread  # noqa: F401

SKEW_SQL = (
    "select count(*) c from memory.default.probe "
    "join memory.default.build on probe.k = build.k"
)


_ADDR = re.compile(r" at 0x[0-9a-f]+")
#: the closure a reference ``DictTransform`` prints beside its fn_key
_FN = re.compile(r", fn=<function \S+ at 0x[0-9a-f]+>")


def _signatures(hist, nodes_mod, root):
    """Per node in walk order: (its canonical signature, its
    fingerprint)."""
    return [
        (hist._signature(n, {}), hist.node_fingerprint(n))
        for n in nodes_mod.walk(root)
    ]


def _port_root(port, q):
    pplan = plan_statement(parse_statement(QUERIES[q]), port.catalogs, port.session)
    return push_scan_constraints(prune_columns(pplan.root))


@pytest.fixture(scope="module")
def runners():
    return RefRunner(), LocalQueryRunner(device="cpu")


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_node_fingerprints_equal_the_reference(runners, q):
    """Every node's signature equals the reference's and its
    fingerprint too, but where the reference's signature prints a
    function object (Q22's ``substring`` predicate, a
    ``DictTransform``): the reference's then changes with each planning
    (ROADMAP §3), while the port prints the transform's ``fn_key`` only.
    There the port's signature is the reference's with the closure taken
    out, and its fingerprint is the same at every planning."""
    ref, port = runners
    rplan = ref_plan(ref_parse(QUERIES[q]), ref.catalogs, ref.session)
    rroot = ref_push(ref_prune(rplan.root))
    proot = _port_root(port, q)
    want = _signatures(ref_history, RN, rroot)
    got = _signatures(history, N, proot)
    again = _signatures(history, N, _port_root(port, q))
    assert [s for s, _ in got] == [_FN.sub("", s) for s, _ in want]
    assert not any(_ADDR.search(s) for s, _ in got)
    assert got == again
    for (_, gfp), (rsig, rfp) in zip(got, want):
        if not _ADDR.search(rsig):
            assert gfp == rfp
    if q != 22:
        assert history.plan_fingerprint(proot) == ref_history.plan_fingerprint(rroot)
        # the cached canonical plan (literals as RuntimeParam slots)
        # keys the same history records: fingerprints are
        # literal-invariant
        plan, _hit = port.plan_cached(parse_statement(QUERIES[q]))
        if plan.preoptimized:
            assert history.plan_fingerprint(plan.root) == history.plan_fingerprint(proot)


def test_q22_planned_twice_hits_the_history_store(tmp_path):
    """Q22's ``DictTransform`` filter keys one history record across
    plannings in the port: the second EXPLAIN ANALYZE estimates the
    filter's ancestors from history. The reference's filter
    fingerprint changes with each planning, so its ancestors stay on
    the stats estimate."""
    sql = "explain analyze " + QUERIES[22]
    warm = {}
    for name, r in (
        ("ref", RefRunner(history_path=str(tmp_path / "r"))),
        ("port", LocalQueryRunner(device="cpu", history_path=str(tmp_path / "p"))),
    ):
        r.execute(sql)
        warm[name] = _text(r, sql)
    for name, prov in (("port", "(history, error ×1.0)"), ("ref", "(stats")):
        join = next(x for x in warm[name].splitlines() if "AntiJoin" in x)
        assert prov in join, (name, join)
    hits = REGISTRY.counter("history.hit").total
    port = LocalQueryRunner(device="cpu", history_path=str(tmp_path / "p"))
    _text(port, "explain " + QUERIES[22])
    assert REGISTRY.counter("history.hit").total > hits


def _load_skew(runners):
    """100 probe rows x 50 build rows, all on one key: 5000 join rows
    where the classic estimate is max(probe, build) = 100."""
    for r, connector, handle in zip(
        runners, (ref_connector, create_connector), (RefHandle, TableHandle)
    ):
        mem = connector("memory")
        r.catalogs.register("memory", mem)
        types = r.catalogs.get("tpch").metadata().get_table_schema(
            handle("tpch", "tiny", "nation")
        )
        big = types["n_nationkey"]
        for name, n, col in (("probe", 100, "v"), ("build", 50, "w")):
            h = handle("memory", "default", name)
            mem.create_table(h, {"k": big, col: big})
            mem.append_rows(
                h, {"k": obj_array([1] * n), col: obj_array(list(range(n)))}
            )


def _text(r, sql):
    return "\n".join(row[0] for row in r.execute(sql).rows())


def _max_error(text):
    errs = [float(m) for m in re.findall(r"error ×([0-9.]+)", text)]
    assert errs, text
    return max(errs)


def test_warm_run_shrinks_the_estimate_error(tmp_path):
    runners = (
        RefRunner(history_path=str(tmp_path / "r")),
        LocalQueryRunner(device="cpu", history_path=str(tmp_path / "p")),
    )
    _load_skew(runners)
    texts = []
    for r in runners:
        cold = _text(r, "explain analyze " + SKEW_SQL)
        explain = _text(r, "explain " + SKEW_SQL)
        warm = _text(r, "explain analyze " + SKEW_SQL)
        texts.append((cold, explain, warm))
    (rc, re_, rw), (pc, pe, pw) = texts
    assert pe == re_ and "(history)" in pe
    assert pc.splitlines()[:-1] == rc.splitlines()[:-1]
    assert pw.splitlines()[:-1] == rw.splitlines()[:-1]
    assert _max_error(pc) >= 50.0
    assert _max_error(pw) < 1.5
    join = next(x for x in pc.splitlines() if "InnerJoin" in x)
    assert "[rows: 5000, est: 100 (stats, error ×50.0)" in join


def test_history_off_plans_bit_exact(tmp_path):
    """With ``enable_history_stats=false`` a runner whose store holds
    actuals plans exactly as a runner with no store: the skewed join's
    EXPLAIN, and Q3's and Q5's plans after their runs taught the store."""
    r = LocalQueryRunner(device="cpu", history_path=str(tmp_path / "h"))
    fresh = LocalQueryRunner(device="cpu")
    _load_skew((RefRunner(), r))
    _load_skew((RefRunner(), fresh))
    r.execute("explain analyze " + SKEW_SQL)  # populate the store
    for q in (3, 5):
        r.execute(QUERIES[q])
    assert r.history_store.stats()["nodes"] > 0
    on = _text(r, "explain " + SKEW_SQL)
    assert "(history)" in on
    r.session.set("enable_history_stats", "false")
    off = _text(r, "explain " + SKEW_SQL)
    assert off == _text(fresh, "explain " + SKEW_SQL)
    assert "(history" not in off
    for q in (3, 5):
        a = r._plan_statement(parse_statement(QUERIES[q]))
        b = fresh._plan_statement(parse_statement(QUERIES[q]))
        assert repr(a.root) == repr(b.root)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_store_round_trip(tmp_path, pkg):
    store_cls = QueryHistoryStore if pkg == "port" else ref_history.QueryHistoryStore
    p = str(tmp_path / "store")
    s1 = store_cls(p, max_entries=16)
    s1.record_query("stmt1", "select 1", {"nodeA": {"rows": 42, "label": "Scan"}})
    assert s1.lookup("nodeA") == 42.0
    s2 = store_cls(p, max_entries=16)
    assert s2.lookup("nodeA") == 42.0
    assert s2.lookup("unknown") is None
    assert s1.stats()["writes"] == 1


def _same_store_sequence(tmp_path, records, max_entries, corrupt=False):
    """Feed ``records`` to both packages' stores; -> (port store, its
    reload), after checking that both agree on every lookup, the
    snapshot and the surviving segment files."""
    out = []
    for pkg, cls in (("p", QueryHistoryStore), ("r", ref_history.QueryHistoryStore)):
        path = str(tmp_path / pkg)
        s = cls(path, max_entries=max_entries)
        for fp, nodes in records:
            s.record_query(fp, "q", nodes)
        if corrupt:
            seg = sorted(f for f in os.listdir(path) if f.endswith(".jsonl"))[-1]
            with open(os.path.join(path, seg), "a") as f:
                f.write("{torn json line without a clos\n")
                f.write("not json at all\n")
        again = cls(path, max_entries=max_entries)
        keys = {k for _, nodes in records for k in nodes}
        out.append((
            s, again,
            {k: (s.lookup(k), again.lookup(k), again.epoch_of(k)) for k in keys},
            [{k: v for k, v in rec.items() if k != "updated"}
             for rec in again.snapshot()],
            sorted(f for f in os.listdir(path) if f.endswith(".jsonl")),
            {k: s.stats()[k] for k in ("entries", "nodes", "writes", "evictions")},
        ))
    (ps, pa, *pv), (_rs, _ra, *rv) = out
    assert pv == rv
    return ps, pa


def test_store_eviction_is_bounded(tmp_path):
    e0 = int(REGISTRY.counter("history.evict").total)
    s, again = _same_store_sequence(
        tmp_path,
        [(f"stmt{i}", {f"n{i}": {"rows": i, "label": "x"}}) for i in range(10)],
        max_entries=4,
    )
    assert s.stats()["entries"] <= 4 and s.evictions > 0
    assert int(REGISTRY.counter("history.evict").total) > e0
    assert s.lookup("n0") is None and s.lookup("n9") == 9.0


def test_store_tolerates_corrupt_lines(tmp_path):
    _s, again = _same_store_sequence(
        tmp_path,
        [("stmtA", {"nA": {"rows": 7, "label": "x"}}),
         ("stmtB", {"nB": {"rows": 9, "label": "x"}})],
        max_entries=16, corrupt=True,
    )
    assert again.lookup("nA") == 7.0 and again.lookup("nB") == 9.0


def test_store_segment_gc_keeps_every_live_entry(tmp_path):
    records = [
        (f"stmt{i}", {f"n{i}": {"rows": i + 1, "label": "x"}}) for i in range(8)
    ] + [("stmt7", {"n7": {"rows": 8, "label": "x"}})] * 60 + [
        (f"stmt{i}", {f"n{i}": {"rows": i, "label": "x"}}) for i in range(8, 100)
    ]
    s, again = _same_store_sequence(tmp_path, records, max_entries=8)
    assert len([f for f in os.listdir(s.path) if f.endswith(".jsonl")]) <= 3
    for i in range(92, 100):
        assert again.lookup(f"n{i}") == float(i)


def test_self_join_and_subqueries_learn_per_node_rows(tmp_path):
    r = LocalQueryRunner(device="cpu", history_path=str(tmp_path / "h"))
    r.execute(
        "select count(*) c from tpch.tiny.nation a "
        "join tpch.tiny.nation b on a.n_nationkey = b.n_nationkey"
    )
    scans = [o for o in r.history.snapshot()[-1].all_operator_stats()
             if "TableScan" in o.label]
    assert len(scans) == 2 and all(o.output_rows == 25 for o in scans)
    assert r.history_store.lookup(scans[0].fingerprint) == 25.0
    r.execute(
        "select count(*) c from tpch.tiny.nation where "
        "n_nationkey < (select count(*) from tpch.tiny.nation) and "
        "n_regionkey < (select count(*) from tpch.tiny.nation)"
    )
    scans = [o for o in r.history.snapshot()[-1].all_operator_stats()
             if "TableScan" in o.label and "nation" in o.label]
    assert scans and all(o.output_rows == 25 for o in scans)


def test_analyzed_run_updates_the_same_statement_entry(tmp_path):
    r = LocalQueryRunner(device="cpu", history_path=str(tmp_path / "h"))
    sql = "select n_name from tpch.tiny.nation order by n_name"
    r.execute(sql)
    before = {rec["fingerprint"] for rec in r.history_store.snapshot()}
    r.execute("explain analyze " + sql)
    snap = r.history_store.snapshot()
    assert {rec["fingerprint"] for rec in snap} == before
    assert all(rec["query"] for rec in snap)


def test_history_view_and_write_metric(tmp_path):
    r = LocalQueryRunner(device="cpu", history_path=str(tmp_path / "h"))
    w0 = int(REGISTRY.counter("history.write").total)
    r.execute("select count(*) c from tpch.tiny.nation")
    assert int(REGISTRY.counter("history.write").total) == w0 + 1
    rows = r.execute(
        "select fingerprint, node_count, total_rows "
        "from system.runtime.query_history"
    ).rows()
    fp, node_count, total_rows = rows[-1]
    assert fp == r.history.snapshot()[-2].plan_fingerprint
    assert node_count >= 1 and total_rows >= 25

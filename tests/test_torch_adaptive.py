"""Adaptive replanning in the port (``plan/history.py``'s epoch plane,
``plan/canonical.stale_consults`` and ``LocalQueryRunner._adaptive_replan``),
the local cases of the reference's ``tests/test_adaptive.py``, each run
through both packages on the CPU: the same query sequence must make the
same replan decisions (divergences detected, replans, their epochs and
node fingerprints) and give the same rows.

The reference's skewed table is made with CREATE TABLE AS; the port's
memory connector takes no SQL writes yet, so both packages load the same
rows through ``append_rows``.
"""

from __future__ import annotations

import pytest

from presto_tpu.connectors import create_connector as ref_connector
from presto_tpu.connectors.spi import TableHandle as RefHandle
from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu.plan import canonical as ref_canonical
from presto_tpu.plan import history as ref_history
from presto_tpu.utils.metrics import REGISTRY as REF_REGISTRY
from presto_tpu_torch.connectors import create_connector
from presto_tpu_torch.connectors.spi import TableHandle
from presto_tpu_torch.exec.local_runner import LocalQueryRunner
from presto_tpu_torch.exec.staging import obj_array
from presto_tpu_torch.plan import canonical
from presto_tpu_torch.plan.history import QueryHistoryStore, diverged
from presto_tpu_torch.sql import parse_statement
from presto_tpu_torch.utils.metrics import REGISTRY
from torch_parity import one_torch_thread  # noqa: F401

#: every row of the build table carries key 7, so the classic
#: ``k = 7 and v > -1e6`` selectivity math under-estimates the build ~30x
SKEW_SQL = (
    "select count(*) as n, sum(s.v) as sv "
    "from mem.default.adaptive_skew s "
    "join tpch.tiny.customer c on s.k = c.c_custkey "
    "where s.k = 7 and s.v > -1000000"
)

COUNTERS = ("plan.replans", "adaptive.divergence_detected",
            "plan.replan_failures")


@pytest.fixture(scope="module")
def skew_rows():
    """(k, v) of the reference's CTAS: 7 and c_acctbal of every
    customer."""
    r = LocalQueryRunner(device="cpu")
    v = [row[0] for row in r.execute(
        "select c_acctbal from tpch.tiny.customer"
    ).rows()]
    return {"k": [7] * len(v), "v": v}


def _skew_runner(pkg: str, tmp_path, adaptive: bool, rows):
    runner_cls, connector, handle = (
        (RefRunner, ref_connector, RefHandle)
        if pkg == "ref"
        else (LocalQueryRunner, create_connector, TableHandle)
    )
    kw = {} if pkg == "ref" else {"device": "cpu"}
    r = runner_cls(history_path=str(tmp_path / f"hist_{pkg}"), **kw)
    r.session.set("adaptive_enabled", "true" if adaptive else "false")
    mem = connector("memory")
    r.catalogs.register("mem", mem)
    h = handle("mem", "default", "adaptive_skew")
    types = r.catalogs.get("tpch").metadata().get_table_schema(
        handle("tpch", "tiny", "customer")
    )
    mem.create_table(h, {"k": types["c_custkey"], "v": types["c_acctbal"]})
    mem.append_rows(h, {c: obj_array(v) for c, v in rows.items()})
    return r


def _registry(pkg):
    return REF_REGISTRY if pkg == "ref" else REGISTRY


def _run_sequence(pkg, tmp_path, rows, adaptive=True, n=3, fail_second=False):
    """Run SKEW_SQL ``n`` times; -> (rows per run, replanned flag and
    adaptive notes per run, counter deltas, plan-cache replans, store
    epochs by node)."""
    r = _skew_runner(pkg, tmp_path, adaptive, rows)
    reg = _registry(pkg)
    before = {c: reg.counter(c).total for c in COUNTERS}
    results, decisions = [], []
    for i in range(n):
        if fail_second and i == 1:
            orig = r._plan_statement

            def boom(stmt):
                raise RuntimeError("injected replan failure")

            r._plan_statement = boom
            try:
                results.append(r.execute(SKEW_SQL).rows())
            finally:
                r._plan_statement = orig
        else:
            results.append(r.execute(SKEW_SQL).rows())
        qs = r.history.snapshot()[-1]
        decisions.append((qs.replanned, tuple(qs.adaptive_notes)))
    deltas = {c: reg.counter(c).total - before[c] for c in COUNTERS}
    epochs = sorted(
        (rec["fingerprint"], rec["epoch"])
        for rec in r.history_store.snapshot()
    )
    return r, results, decisions, deltas, r.plan_cache.replans, epochs


def _same_decisions(tmp_path, rows, **kw):
    ref = _run_sequence("ref", tmp_path, rows, **kw)
    port = _run_sequence("port", tmp_path, rows, **kw)
    assert port[1] == ref[1]  # rows
    assert port[2:] == ref[2:]  # decisions, counters, replans, epochs
    return port


# ------------------------------------------------------ the epoch plane


def test_diverged_is_symmetric_and_bounded():
    assert not diverged(100, 350, 4.0)
    assert diverged(100, 401, 4.0)
    assert diverged(401, 100, 4.0)
    assert not diverged(None, 100, 4.0)
    assert not diverged(100, None, 4.0)
    assert not diverged(0, 3, 4.0)
    assert not diverged(5000, -1, 4.0)
    assert not diverged(-1, 5000, 4.0)
    grid = [None, -1, 0, 1, 3, 99, 100, 350, 400, 401, 5000.5, "x"]
    for e in grid:
        for o in grid:
            for f in (0.5, 1.0, 2.0, 4.0):
                assert diverged(e, o, f) == ref_history.diverged(e, o, f)


def test_epoch_bumps_on_divergence_only(tmp_path):
    stores = (
        QueryHistoryStore(str(tmp_path / "p"), divergence_factor=4.0),
        ref_history.QueryHistoryStore(
            str(tmp_path / "r"), divergence_factor=4.0
        ),
    )
    for store in stores:
        store.record_query("s1", "q", {"n1": {"rows": 100, "label": "x"}})
        assert store.epoch_of("n1") == 1
        store.record_query("s1", "q", {"n1": {"rows": 150, "label": "x"}})
        assert store.epoch_of("n1") == 1
        store.record_query("s1", "q", {"n1": {"rows": 1000, "label": "x"}})
        assert store.epoch_of("n1") == 2
        assert store.learned_rows("n1") == 1000.0
        assert store.epoch_of("never-seen") == 0
        assert store.learned_rows("never-seen") is None


def test_query_history_view_carries_epoch(tmp_path):
    store = QueryHistoryStore(str(tmp_path))
    store.record_query("s1", "q", {"s1": {"rows": 10, "label": "x"}})
    (row,) = store.snapshot()
    assert row["epoch"] == 1
    store.record_query("s1", "q", {"s1": {"rows": 9000, "label": "x"}})
    (row,) = store.snapshot()
    assert row["epoch"] == 2
    # epochs survive a restart: records persist them
    assert QueryHistoryStore(str(tmp_path)).epoch_of("s1") == 2


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_stale_consults_judges_against_captured_estimate(tmp_path, pkg):
    store_cls, stale = (
        (QueryHistoryStore, canonical.stale_consults)
        if pkg == "port"
        else (ref_history.QueryHistoryStore, ref_canonical.stale_consults)
    )
    store = store_cls(str(tmp_path), divergence_factor=4.0)
    consulted = {"n1": {"epoch": 0, "rows": None, "est": 50.0}}
    assert stale(consulted, store, 4.0) is None
    store.record_query("s", "q", {"n1": {"rows": 60, "label": "x"}})
    assert store.epoch_of("n1") == 1
    assert stale(consulted, store, 4.0) is None
    store.record_query("s", "q", {"n1": {"rows": 5000, "label": "x"}})
    assert stale(consulted, store, 4.0) == ("n1", 0, 2)


def test_stale_consults_honors_tighter_session_factor(tmp_path):
    store = QueryHistoryStore(str(tmp_path), divergence_factor=4.0)
    store.record_query("s", "q", {"n1": {"rows": 100, "label": "x"}})
    consulted = {"n1": {"epoch": 1, "rows": 100.0, "est": None}}
    store.record_query("s", "q", {"n1": {"rows": 300, "label": "x"}})
    assert store.epoch_of("n1") == 1
    assert canonical.stale_consults(consulted, store, 4.0) is None
    got = canonical.stale_consults(consulted, store, 2.0)
    assert got is not None and got[0] == "n1"


# --------------------------------------------- statement-cache replan


def test_cache_hit_replan_serves_new_plan(tmp_path, skew_rows):
    r, results, decisions, deltas, replans, epochs = _same_decisions(
        tmp_path, skew_rows
    )
    assert results[0] == results[1] == results[2]
    # the warm run replanned once; the third served the new entry
    assert [d[0] for d in decisions] == [False, True, False]
    assert decisions[1][1][0].startswith("REPLANNED (epoch 0→1) node ")
    assert deltas == {"plan.replans": 1,
                      "adaptive.divergence_detected": 1,
                      "plan.replan_failures": 0}
    assert replans == 1 and r.plan_cache.stats()["replans"] == 1
    (key, entry) = next(
        (k, e) for k, e in r.plan_cache._od.items()
        if isinstance(e, canonical.PlanCacheEntry)
    )
    assert entry.consulted, "planning must capture its consults"


def test_small_drift_does_not_invalidate(tmp_path, skew_rows):
    r, results, decisions, deltas, _, _ = _same_decisions(
        tmp_path, skew_rows, n=5
    )
    # the one replan, then zero drift: no further replans
    assert deltas["plan.replans"] == 1
    assert [d[0] for d in decisions[2:]] == [False, False, False]


def test_replan_failure_serves_cached_plan(tmp_path, skew_rows):
    _, results, decisions, deltas, replans, _ = _same_decisions(
        tmp_path, skew_rows, n=2, fail_second=True
    )
    assert results[0] == results[1]
    assert deltas == {"plan.replans": 0,
                      "adaptive.divergence_detected": 1,
                      "plan.replan_failures": 1}
    assert replans == 0 and decisions[1] == (False, ())


def test_adaptive_off_is_bit_exact(tmp_path, skew_rows):
    r, results, decisions, deltas, replans, _ = _same_decisions(
        tmp_path, skew_rows, adaptive=False, n=2
    )
    assert results[0] == results[1]
    assert deltas == {c: 0 for c in COUNTERS}
    assert r.plan_cache.hits >= 1 and replans == 0
    assert all(not e.consulted for e in r.plan_cache._od.values()
               if isinstance(e, canonical.PlanCacheEntry))
    # and the warm plan is the cold plan, object for object
    plans = [r.plan_cached(parse_statement(SKEW_SQL))[0].root
             for _ in range(2)]
    assert plans[0] is plans[1]


def test_runtime_query_history_epoch_column(tmp_path, skew_rows):
    r = _skew_runner("port", tmp_path, True, skew_rows)
    r.execute(SKEW_SQL)
    rows = r.execute(
        "select fingerprint, epoch from system.runtime.query_history"
    ).rows()
    assert rows and all(int(e) >= 1 for _fp, e in rows)

"""Materialized views through both runners on the CPU: the view cases
of the reference's ``tests/test_ingest.py`` and the MV-aware rewrite
cases of its ``tests/test_result_cache.py``, run by the reference and by
the port over the same rows, with the same results.

The server's ingest lane is not ported, so a commit is driven here as
``presto_tpu/server/ingest.py`` makes it: ``commit_snapshot`` into the
memory connector, ``_invalidate_table_caches``, the epoch hint, then
``MViewRegistry.on_commit`` (a maintenance failure is absorbed, as the
lane absorbs it)."""

from __future__ import annotations

import time

import pytest

from presto_tpu import types as RT
from presto_tpu.connectors.spi import TableHandle as RefHandle
from presto_tpu.sql import parse_statement as ref_parse
from presto_tpu_torch import types as PT
from presto_tpu_torch.connectors.spi import TableHandle
from presto_tpu_torch.sql import parse_statement

from test_torch_arrays import assert_same_rows
from test_torch_writes import both, write_runners
from torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def runners():
    return write_runners()


def events(runners, name: str):
    """A fresh mem.default.<name> (k bigint, v bigint, w double) in both;
    -> the handles, in runner order."""
    handles = []
    for runner, T, Handle in zip(runners, (RT, PT), (RefHandle, TableHandle)):
        h = Handle("mem", "default", name)
        runner.catalogs.get("mem").create_table(
            h, {"k": T.BIGINT, "v": T.BIGINT, "w": T.DOUBLE}
        )
        handles.append(h)
    return handles


def commit(runner, handle, cols, sid: int) -> bool:
    """One ingest commit of ``cols`` ({column: Python values}) as
    snapshot ``sid``; False when view maintenance failed."""
    runner.catalogs.get(handle.catalog).commit_snapshot(handle, cols, sid)
    runner._invalidate_table_caches(handle)
    reg = runner._mview_registry
    if reg is None:
        return True
    hint = reg._epoch(handle)
    try:
        reg.on_commit(handle, cols, sid, hint)
    except Exception:
        return False
    return True


def commit_both(runners, handles, cols, sid: int) -> None:
    for runner, h in zip(runners, handles):
        assert commit(runner, h, cols, sid)


def views(runners, name: str):
    """The MViewDef of mem.default.<name> in each runner."""
    return [
        r.mview_registry.lookup(("mem", "default", name)) for r in runners
    ]


def full_view_sql(name: str, base: str) -> str:
    return (
        f"create materialized view mem.default.{name} as "
        "select k, sum(v) as sv, count(*) as c, min(v) as mn, "
        f"max(v) as mx, avg(w) as aw from mem.default.{base} group by k"
    )


# ------------------------------------ the view cases of test_ingest.py


def test_incremental_vs_full_bit_equality_each_aggregate(runners):
    """SUM/COUNT/MIN/MAX/AVG maintained incrementally over three commits
    equal a full refresh bit for bit and the defining query run
    directly, in both packages."""
    hs = events(runners, "ev_bits")
    both(runners, full_view_sql("mv_bits", "ev_bits"))
    batches = [
        {"k": [1, 1, 2], "v": [10, 20, 5], "w": [1.0, 3.0, 0.5]},
        {"k": [2, 3], "v": [7, 100], "w": [2.5, 4.0]},
        {"k": [1, 3, 3], "v": [1, 2, 3], "w": [0.0, 8.0, 4.0]},
    ]
    for sid, b in enumerate(batches, 1):
        commit_both(runners, hs, b, sid)
    for mv in views(runners, "mv_bits"):
        assert mv.eligible and mv.incremental_refreshes == 3
    incremental = both(runners, "select * from mem.default.mv_bits order by k")
    direct = both(
        runners,
        "select k, sum(v), count(*), min(v), max(v), avg(w) "
        "from mem.default.ev_bits group by k order by k",
    )
    assert incremental == direct
    both(runners, "refresh materialized view mem.default.mv_bits")
    assert all(mv.last_mode == "full" for mv in views(runners, "mv_bits"))
    full = both(runners, "select * from mem.default.mv_bits order by k")
    assert full == incremental


def test_new_groups_appear_incrementally(runners):
    hs = events(runners, "ev_new")
    both(runners, full_view_sql("mv_new", "ev_new"))
    commit_both(runners, hs, {"k": [1], "v": [10], "w": [1.0]}, 1)
    commit_both(runners, hs, {"k": [9], "v": [90], "w": [9.0]}, 2)
    assert both(
        runners, "select k, sv from mem.default.mv_new order by k"
    ) == [(1, 10), (9, 90)]


def test_where_clause_applies_to_delta(runners):
    hs = events(runners, "ev_where")
    both(
        runners,
        "create materialized view mem.default.mv_where as "
        "select k, sum(v) as sv from mem.default.ev_where "
        "where v >= 10 group by k",
    )
    commit_both(runners, hs, {"k": [1, 1], "v": [5, 50], "w": [0.0, 0.0]}, 1)
    assert both(runners, "select * from mem.default.mv_where") == [(1, 50)]
    for mv in views(runners, "mv_where"):
        assert mv.eligible and mv.incremental_refreshes == 1


def test_ineligible_view_falls_back_to_full_refresh(runners):
    """A join view still materializes, but every maintenance event is a
    full recompute, and it says why."""
    hs = events(runners, "ev_join")
    both(
        runners,
        "create materialized view mem.default.mv_join as "
        "select r_name, count(*) as c "
        "from mem.default.ev_join, tpch.tiny.region "
        "where k = r_regionkey group by r_name",
    )
    ref_mv, port_mv = views(runners, "mv_join")
    assert not port_mv.eligible and port_mv.reason == ref_mv.reason
    commit_both(
        runners, hs, {"k": [0, 0, 1], "v": [1, 2, 3], "w": [0.0] * 3}, 1
    )
    for mv in (ref_mv, port_mv):
        assert mv.incremental_refreshes == 0 and mv.refreshes == 2
    assert both(
        runners, "select r_name, c from mem.default.mv_join order by r_name"
    ) == both(
        runners,
        "select r_name, count(*) from mem.default.ev_join, tpch.tiny.region "
        "where k = r_regionkey group by r_name order by r_name",
    )


def test_full_refresh_covers_racing_delta_exactly_once(runners):
    """The double-apply guard: a straggling merge of a snapshot a merge
    or a full refresh already covers is a no-op."""
    hs = events(runners, "ev_race")
    both(
        runners,
        "create materialized view mem.default.mv_race as "
        "select k, sum(v) as sv from mem.default.ev_race group by k",
    )
    delta = {"k": [1], "v": [10], "w": [1.0]}
    commit_both(runners, hs, delta, 1)
    read = "select sv from mem.default.mv_race where k = 1"
    for runner, mv in zip(runners, views(runners, "mv_race")):
        assert mv.last_snapshot == 1
        runner.mview_registry._incremental_refresh(mv, delta, 1)
    assert both(runners, read) == [(10,)]
    both(runners, "refresh materialized view mem.default.mv_race")
    for runner, mv in zip(runners, views(runners, "mv_race")):
        assert mv.last_snapshot == 1
        runner.mview_registry._incremental_refresh(mv, delta, 1)
    assert both(runners, read) == [(10,)]


def test_incremental_disabled_forces_full(runners):
    hs = events(runners, "ev_off")
    both(runners, full_view_sql("mv_off", "ev_off"))
    try:
        for r in runners:
            r.mview_registry.incremental_enabled = False
        commit_both(runners, hs, {"k": [1], "v": [10], "w": [1.0]}, 1)
    finally:
        for r in runners:
            r.mview_registry.incremental_enabled = True
    for mv in views(runners, "mv_off"):
        assert mv.incremental_refreshes == 0 and mv.last_mode == "full"
    assert both(runners, "select k, sv from mem.default.mv_off") == [(1, 10)]


def _set_staleness(runners, seconds) -> None:
    for r in runners:
        r.mview_registry.max_staleness_s = seconds


def test_staleness_read_gate_refreshes_legacy_writes(runners):
    """A base written through the legacy path (an INSERT: no commit
    hook) leaves the view stale; the read gate refreshes it in-line
    once the staleness bound expires."""
    events(runners, "ev_gate")
    both(
        runners,
        "create materialized view mem.default.mv_gate as "
        "select k, sum(v) as sv from mem.default.ev_gate group by k",
    )
    read = "select * from mem.default.mv_gate order by k"
    try:
        both(runners, "insert into mem.default.ev_gate values (1, 10, 1.0)")
        assert both(runners, read) == []  # gate off: the view stays stale
        _set_staleness(runners, 0.01)
        time.sleep(0.05)
        assert both(runners, read) == [(1, 10)]
        mvs = views(runners, "mv_gate")
        assert [mv.refreshes for mv in mvs] == [2, 2]  # create + the gate
        # a fresh view within the bound: no refresh on re-read
        _set_staleness(runners, 3600.0)
        both(runners, "insert into mem.default.ev_gate values (2, 20, 2.0)")
        assert both(runners, read) == [(1, 10)]
        assert [mv.refreshes for mv in mvs] == [2, 2]
    finally:
        _set_staleness(runners, None)


def test_gate_repairs_view_after_legacy_write_between_commits(runners):
    """A legacy INSERT between commits rides into the next snapshot but
    not into its delta: the merge must not mark the view fresh for it
    (epoch attribution), so the gate still repairs the view."""
    hs = events(runners, "ev_mix")
    both(
        runners,
        "create materialized view mem.default.mv_mix as "
        "select k, sum(v) as sv from mem.default.ev_mix group by k",
    )
    read = "select k, sv from mem.default.mv_mix order by k"
    commit_both(runners, hs, {"k": [1], "v": [10], "w": [0.0]}, 1)
    both(runners, "insert into mem.default.ev_mix values (2, 20, 0.0)")
    commit_both(runners, hs, {"k": [3], "v": [30], "w": [0.0]}, 2)
    assert both(runners, read) == [(1, 10), (3, 30)]
    try:
        _set_staleness(runners, 0.01)
        time.sleep(0.05)
        assert both(runners, read) == [(1, 10), (2, 20), (3, 30)]
    finally:
        _set_staleness(runners, None)


def test_drop_materialized_view(runners):
    events(runners, "ev_drop")
    both(runners, full_view_sql("mv_drop", "ev_drop"))
    both(runners, "drop materialized view mem.default.mv_drop")
    assert views(runners, "mv_drop") == [None, None]
    for runner in runners:
        with pytest.raises(Exception):
            runner.execute("select * from mem.default.mv_drop")
    both(runners, "drop materialized view if exists mem.default.mv_drop")


def test_failed_merge_poisons_incremental_until_full_refresh(runners):
    """A merge that dies loses its drained deltas: the next maintenance
    event is a full refresh that heals the view (the dirty flag), then
    incremental merging resumes."""
    hs = events(runners, "ev_poison")
    both(
        runners,
        "create materialized view mem.default.mv_poison as "
        "select k, sum(v) as sv from mem.default.ev_poison group by k",
    )
    read = "select k, sv from mem.default.mv_poison order by k"
    mvs = views(runners, "mv_poison")
    for runner, h in zip(runners, hs):
        reg = runner.mview_registry

        def boom(*a, **k):
            raise RuntimeError("injected merge failure")

        reg._merge_one_delta = boom
        try:
            assert not commit(runner, h, {"k": [1], "v": [10], "w": [0.0]}, 1)
        finally:
            del reg._merge_one_delta
    assert all(mv.dirty for mv in mvs)
    commit_both(runners, hs, {"k": [2], "v": [20], "w": [0.0]}, 2)
    assert all(not mv.dirty and mv.last_mode == "full" for mv in mvs)
    assert both(runners, read) == [(1, 10), (2, 20)]
    commit_both(runners, hs, {"k": [1], "v": [5], "w": [0.0]}, 3)
    assert all(mv.last_mode == "incremental" for mv in mvs)
    assert both(runners, read) == [(1, 15), (2, 20)]


def test_restore_re_registers_a_view(runners):
    """``restore`` re-registers a view from its CREATE text (the WAL
    replay path of the server's ingest lane) and a refresh rebuilds it;
    a text that is not a view definition is skipped."""
    events(runners, "ev_restore")
    sql = full_view_sql("mv_restore", "ev_restore")
    both(runners, sql)
    both(runners, "insert into mem.default.ev_restore values "
         "(1, 10, 1.0), (2, 20, 2.0)")
    want = both(runners, "select k, sum(v), count(*), min(v), max(v), "
                "avg(w) from mem.default.ev_restore group by k order by k")
    for runner in runners:
        reg = runner.mview_registry
        reg._defs.pop(("mem", "default", "mv_restore"))
        assert reg.restore("select 1") is None
        mv = reg.restore(sql)
        assert mv is not None and mv.eligible and mv.last_mode == "none"
        reg.refresh_view(mv, mode="replay")
    assert both(
        runners, "select * from mem.default.mv_restore order by k"
    ) == want


def test_system_materialized_views_rows(runners):
    """``system.runtime.materialized_views`` lists the same views with
    the same rows in both packages, apart from the refresh age."""
    hs = events(runners, "ev_sys")
    both(runners, full_view_sql("mv_sys", "ev_sys"))
    commit_both(runners, hs, {"k": [1, 2], "v": [3, 4], "w": [0.5, 1.5]}, 1)
    sql = (
        "select view, base_table, eligible, reason, snapshot_id, "
        'last_refresh_mode, refreshes, incremental_refreshes, "rows" '
        "from system.runtime.materialized_views order by view"
    )
    rows = both(runners, sql)
    assert ("mem.default.mv_sys", "mem.default.ev_sys", True, "", 1,
            "incremental", 2, 1, 2) in rows
    ages = [
        r.execute("select refresh_age_s from system.runtime."
                  "materialized_views").rows()
        for r in runners
    ]
    assert len(ages[0]) == len(ages[1]) == len(rows)
    assert all(a >= 0.0 for (a,) in ages[1])


def test_delta_staging_leaves_the_caches(runners):
    """Each merge stages its delta into the view's ``__mv_delta_*``
    table, runs the decomposed query over it and invalidates it: no
    page of it stays in the split cache and no plan of it reaches the
    plan cache. A read of the base after a commit misses the split
    cache exactly once."""
    hs = events(runners, "ev_stage")
    both(runners, full_view_sql("mv_stage", "ev_stage"))
    port = runners[1]
    base = "select k, sum(v) as sv from mem.default.ev_stage group by k"
    for sid in (1, 2):
        commit_both(runners, hs, {"k": [sid], "v": [sid], "w": [0.0]}, sid)
        misses = port.split_cache.stats()["misses"]
        both(runners, base, ordered=False)
        assert port.split_cache.stats()["misses"] == misses + 1
        both(runners, base, ordered=False)
        assert port.split_cache.stats()["misses"] == misses + 1
    assert not any(
        "__mv_delta_" in repr(k) for k in port.split_cache._entries
    )
    assert not any(
        "__mv_delta_" in h.table
        for e in port.plan_cache._od.values()
        for h in getattr(e, "handles", ())
    )
    assert port.plan_cache.stats()["entries"] > 0


def test_maintenance_releases_what_it_reserved():
    """Maintenance queries run under a QueryStats of their own in the
    port: a base over the split cache's budget (100,000 bytes) is
    released after every refresh and merge. The reference runs them with
    none and its "adhoc" bytes grow; the views' rows are the same."""
    runners = write_runners(staging_cache_bytes=100_000)
    ref, port = runners
    both(
        runners,
        "create table mem.default.li as select l_orderkey as k, "
        "l_linenumber as v, l_discount as w from tpch.tiny.lineitem",
    )
    hs = [
        Handle("mem", "default", "li") for Handle in (RefHandle, TableHandle)
    ]
    both(runners, full_view_sql("mv_li", "li").replace("avg(w)", "avg(v)"))
    leaked = [ref.memory_pool.used_bytes("adhoc")]
    assert port.memory_pool.snapshot()["used"] == {}
    for step in range(2):
        both(runners, "refresh materialized view mem.default.mv_li")
        commit_both(runners, hs, {"k": [7], "v": [step], "w": [0.5]}, step + 1)
        assert port.memory_pool.snapshot()["used"] == {}
        leaked.append(ref.memory_pool.used_bytes("adhoc"))
    assert 0 < leaked[0] < leaked[1] < leaked[2]
    both(runners, "select * from mem.default.mv_li order by k")


# ------------------------------- the rewrite cases of test_result_cache.py


REWRITE_VIEW = (
    "create materialized view mem.default.mv_rw as "
    "select k, sum(v) as sv, count(*) as c, min(v) as mn, "
    "max(v) as mx from mem.default.ev_rw group by k"
)
ELIGIBLE_SHAPES = [
    "select k, sum(v) as sv, count(*) as c, min(v) as mn, max(v) as mx"
    " from mem.default.ev_rw group by k",
    "select k, sum(v) as sv from mem.default.ev_rw group by k",
    "select count(*) as c, k from mem.default.ev_rw group by k",  # reorder
    "select k, max(v) from mem.default.ev_rw group by k",  # unaliased
]
INELIGIBLE_SHAPES = [
    # a filter the view does not maintain
    "select k, sum(v) as sv from mem.default.ev_rw where k > 1 group by k",
    # an aggregate the view does not maintain
    "select k, avg(v) as a from mem.default.ev_rw group by k",
    # no grouping
    "select sum(v) as sv from mem.default.ev_rw",
]


@pytest.fixture(scope="module")
def rewrite_view(runners):
    events(runners, "ev_rw")
    both(runners, "insert into mem.default.ev_rw values "
         "(1, 10, 0.0), (1, 20, 0.0), (2, 5, 0.0), (3, 7, 0.0)")
    both(runners, REWRITE_VIEW)
    both(runners, "refresh materialized view mem.default.mv_rw")
    return runners


def _key(runner, parse, sql: str) -> str:
    _plan, _hit, key = runner.plan_cached_keyed(parse(sql))
    return key or ""


@pytest.mark.parametrize("sql", ELIGIBLE_SHAPES + INELIGIBLE_SHAPES)
def test_mview_rewrite_bit_equality_every_shape(rewrite_view, sql):
    """Rows with ``mview_auto_rewrite`` on equal the rows with it off,
    and the reference's; an eligible shape's plan-cache key is the
    rewritten statement over the view, an ineligible one's is not."""
    runners = rewrite_view
    off = both(runners, sql, ordered=False)
    try:
        for r in runners:
            r.session.set("mview_auto_rewrite", True)
        on = both(runners, sql, ordered=False)
        keys = [
            _key(r, parse, sql)
            for r, parse in zip(runners, (ref_parse, parse_statement))
        ]
        rewritten = runners[1].history.snapshot()[-1].mview_rewritten
    finally:
        for r in runners:
            r.session.set("mview_auto_rewrite", False)
    assert_same_rows(on, off, ordered=False)
    eligible = sql in ELIGIBLE_SHAPES
    assert [("'mv_rw'" in k) for k in keys] == [eligible, eligible], keys
    assert rewritten == ("mem.default.mv_rw" if eligible else "")


def test_mview_rewrite_staleness_gate_discipline(runners):
    """A stale view rewrites only under an explicit read gate: a reader
    of the base never opts into staleness silently."""
    events(runners, "ev_stale")
    both(runners, "insert into mem.default.ev_stale values "
         "(1, 10, 0.0), (2, 5, 0.0)")
    both(runners, REWRITE_VIEW.replace("mv_rw", "mv_stale")
         .replace("ev_rw", "ev_stale"))
    sql = "select k, sum(v) as sv from mem.default.ev_stale group by k"
    try:
        for r in runners:
            r.session.set("mview_auto_rewrite", True)
        pairs = list(zip(runners, (ref_parse, parse_statement)))
        assert all("'mv_stale'" in _key(r, p, sql) for r, p in pairs)
        both(runners, "insert into mem.default.ev_stale values (8, 1, 0.0)")
        # the base's epoch moved past the view's state and no gate is
        # set: no rewrite, and the reader sees the new row at once
        assert not any("'mv_stale'" in _key(r, p, sql) for r, p in pairs)
        assert (8, 1) in both(runners, sql, ordered=False)
    finally:
        for r in runners:
            r.session.set("mview_auto_rewrite", False)


def test_decimal_average_state_moves_by_an_ulp(runners):
    """The reference keeps an AVG's SUM state over a short decimal as a
    Python float (the maintenance query's rows decode decimals as ``int
    / 10**scale``), so an incremental merge adds two rounded floats
    where a full refresh rounds once: 0.10 then a delta of 0.20
    averages to 0.15000000000000002 incrementally and to 0.15 after
    REFRESH. The port keeps the state as exact ``decimal.Decimal``
    values, so both modes give 0.15. The stored SUM is requantized to
    the column's scale and is exact in both packages."""
    both(runners, "create table mem.default.ev_dec (k bigint, p decimal(12,2))")
    both(runners, "insert into mem.default.ev_dec values (1, 0.10)")
    both(
        runners,
        "create materialized view mem.default.mv_dec as select k, "
        "avg(p) as ap, sum(p) as sp from mem.default.ev_dec group by k",
    )
    hs = [Handle("mem", "default", "ev_dec")
          for Handle in (RefHandle, TableHandle)]
    commit_both(runners, hs, {"k": [1], "p": [0.20]}, 1)
    read = "select k, ap, sp from mem.default.mv_dec"
    ref, port = runners  # exact: ``both`` allows rel 1e-9
    assert ref.execute(read).rows() == [(1, 0.15000000000000002, 0.3)]
    assert port.execute(read).rows() == [(1, 0.15, 0.3)]
    both(runners, "refresh materialized view mem.default.mv_dec")
    for runner in runners:
        assert runner.execute(read).rows() == [(1, 0.15, 0.3)]

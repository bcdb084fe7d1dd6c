"""Micro-batched serving through both packages: the reference's
coordinator (``presto_tpu``, a vmapped XLA program per batch) and the
port's (``presto_tpu_torch`` with ``device="cpu"``, one pass of the
operators over lane-blocked pages) on the same statements over
tpch.tiny.

The cases of ``tests/test_microbatch.py``, each run through both
packages: off by default; N-way point lookups and aggregates equal to
scalar; duplicate literals demuxed; a non-hoistable shape and an
over-window output falling out; the plan cache off; 100 clients; the
admission-parked window and the solo leader; the ``runtime.queries``
column and the EXPLAIN line. Where the reference reads its compile
cache's batch-tagged keys, both packages must have served the same lanes
in the same number of batches (a window long enough for every member to
join, closed early by ``microbatch_max``). Then a Q1-shaped GROUP BY
batch (shipdate cutoffs) equal to the reference's scalar rows, and K1's
batching rule (``onehot_reduce_lanes``) against one plain reduction per
lane. Doubles within rel 1e-9, everything else exact.
"""

from __future__ import annotations

import math
import threading
import time
import types

import numpy as np
import pytest
import torch

from presto_tpu.exec.explain import render_query_analyze as ref_render
from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu.server.coordinator import CoordinatorServer as RefCoord
from presto_tpu.utils.metrics import REGISTRY as REF_REGISTRY
from presto_tpu_torch.exec.explain import render_query_analyze as port_render
from presto_tpu_torch.exec.local_runner import LocalQueryRunner as PortRunner
from presto_tpu_torch.ops import aggregation as PA
from presto_tpu_torch.server.coordinator import CoordinatorServer as PortCoord
from presto_tpu_torch.utils.metrics import REGISTRY as PORT_REGISTRY
from torch_parity import one_torch_thread  # noqa: F401 (module fixture)

REF = types.SimpleNamespace(
    name="reference", Coord=RefCoord, Runner=RefRunner, kw={},
    registry=REF_REGISTRY, render=ref_render,
)
PORT = types.SimpleNamespace(
    name="port", Coord=PortCoord, Runner=PortRunner, kw={"device": "cpu"},
    registry=PORT_REGISTRY, render=port_render,
)
BOTH = (REF, PORT)

POINT = (
    "select c_custkey, c_name, c_acctbal "
    "from tpch.tiny.customer where c_custkey = ?"
)
AGG = (
    "select count(*) as n, sum(c_acctbal) as s "
    "from tpch.tiny.customer where c_custkey < ?"
)
PREPARED = {"point": POINT, "agg": AGG}
N_KEYS = 1500

#: a window every member of a round joins; ``microbatch_max`` = the round
#: size closes it as soon as they have
LONG_WAIT_MS = 10_000.0


def _coord(pkg, wait_ms=0.0, max_size=16, concurrency=64):
    c = pkg.Coord(max_concurrent_queries=concurrency, **pkg.kw)
    if wait_ms:
        c.local.session.set("microbatch_wait_ms", wait_ms)
        c.local.session.set("microbatch_max", max_size)
    return c


def _submit_concurrent(coord, sqls, prepared=None):
    """All statements at once (a barrier start); the _Query objects in
    submission order."""
    out = [None] * len(sqls)
    barrier = threading.Barrier(len(sqls))

    def run(i):
        barrier.wait(30)
        q = coord.submit(sqls[i], prepared=dict(prepared or {}))
        q.done.wait(180)
        out[i] = q

    threads = [
        threading.Thread(target=run, args=(i,)) for i in range(len(sqls))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(240)
    return out


def _scalar_expected(pkg, sqls, prepared):
    r = pkg.Runner(**pkg.kw)
    for name, text in prepared.items():
        r.execute(f"prepare {name} from {text}")
    return [[list(row) for row in r.execute(s).rows()] for s in sqls]


def _batch_counters(pkg):
    return (
        int(pkg.registry.counter("serving.batches").total),
        int(pkg.registry.counter("serving.batched_statements").total),
    )


def _same_rows(a, b, rel=1e-9):
    """Row lists equal, doubles within ``rel``."""
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if isinstance(x, float) or isinstance(y, float):
                if not math.isclose(x, y, rel_tol=rel):
                    return False
            elif x != y:
                return False
    return True


def _warm(coord, sql, prepared=None):
    q = coord.submit(sql, prepared=dict(prepared or {}))
    assert q.done.wait(120) and q.state == "FINISHED", q.error


def _open_window(coord, n):
    """A window all ``n`` members of a round join, closed as soon as they
    have (set after the warm-up, whose solo leader would hold it)."""
    coord.local.session.set("microbatch_wait_ms", LONG_WAIT_MS)
    coord.local.session.set("microbatch_max", n)


# ------------------------------------------------------------ off = legacy


def test_off_by_default_bit_exact():
    sqls = [f"execute point using {7 + 11 * i}" for i in range(6)]
    rows = {}
    for pkg in BOTH:
        coord = _coord(pkg)
        try:
            expected = _scalar_expected(pkg, sqls, PREPARED)
            b0, s0 = _batch_counters(pkg)
            qs = _submit_concurrent(coord, sqls, PREPARED)
            b1, s1 = _batch_counters(pkg)
            assert (b1 - b0, s1 - s0) == (0, 0), pkg.name
            for q, exp in zip(qs, expected):
                assert q.state == "FINISHED", q.error
                assert q.rows == exp
                assert q.stats.batched is False
                assert q.stats.batch_size == 0
            rows[pkg.name] = [q.rows for q in qs]
            if pkg is REF:
                for key in coord.local._compiled:
                    assert len(key) == 4 and "batch" not in key
            else:
                assert coord.local.batch_entries == {}
        finally:
            coord.shutdown()
    assert all(
        _same_rows(a, b) for a, b in zip(rows["reference"], rows["port"])
    )


# ------------------------------------------------- batched == scalar


def _one_batch_round(pkg, warm_sql, sqls, prepared):
    """One round with a window every member joins: -> (queries,
    expected scalar rows, batches, batched statements)."""
    coord = _coord(pkg)
    try:
        _warm(coord, warm_sql, prepared)
        _open_window(coord, len(sqls))
        expected = _scalar_expected(pkg, sqls, prepared)
        b0, s0 = _batch_counters(pkg)
        qs = _submit_concurrent(coord, sqls, prepared)
        b1, s1 = _batch_counters(pkg)
        if pkg is REF:
            assert any("batch" in key for key in coord.local._compiled)
        else:
            assert any("batch" in key for key in coord.local.batch_entries)
        return qs, expected, b1 - b0, s1 - s0
    finally:
        coord.shutdown()


def _check_one_batch(sqls, warm, prepared):
    got = {}
    for pkg in BOTH:
        qs, expected, batches, stmts = _one_batch_round(
            pkg, warm, sqls, prepared
        )
        for q, exp in zip(qs, expected):
            assert q.state == "FINISHED", q.error
            assert q.rows == exp, pkg.name
            assert q.stats.batched and q.stats.batch_size == len(sqls)
        got[pkg.name] = ([q.rows for q in qs], batches, stmts)
    ref, port = got["reference"], got["port"]
    # both packages served the same lanes in the same number of batches
    assert ref[1:] == port[1:] == (1, len(sqls))
    assert all(_same_rows(a, b) for a, b in zip(ref[0], port[0]))
    return got


def test_nway_batch_equals_scalar_point_lookups():
    vals = [5, 118, 119, 700, 701, 42, 1499, 12]
    _check_one_batch(
        [f"execute point using {v}" for v in vals],
        "execute point using 3", PREPARED,
    )


def test_nway_batch_equals_scalar_aggregates():
    vals = [2, 55, 340, 1100, 1500, 9]
    _check_one_batch(
        [f"execute agg using {v}" for v in vals],
        "execute agg using 10", PREPARED,
    )


def test_mixed_and_duplicate_literals_demux_correctly():
    vals = [77, 77, 901, 14, 901, 77]
    got = _check_one_batch(
        [f"execute point using {v}" for v in vals],
        "execute point using 3", PREPARED,
    )
    for rows, _, _ in got.values():
        for r, v in zip(rows, vals):
            assert r[0][0] == v  # the row really is THIS member's


# ------------------------------------------------------- fallout lanes


def test_non_hoistable_shape_falls_back_scalar():
    """No hoistable literal (a string predicate): no parameter vector to
    stack, the whole group rides the scalar path with zero batches."""
    sql = (
        "select count(*) as n from tpch.tiny.customer "
        "where c_mktsegment = 'BUILDING'"
    )
    rows = {}
    for pkg in BOTH:
        coord = _coord(pkg, wait_ms=300.0)
        try:
            expected = [
                list(r) for r in pkg.Runner(**pkg.kw).execute(sql).rows()
            ]
            b0, _ = _batch_counters(pkg)
            qs = _submit_concurrent(coord, [sql] * 4)
            b1, _ = _batch_counters(pkg)
            assert b1 - b0 == 0, pkg.name
            for q in qs:
                assert q.state == "FINISHED", q.error
                assert q.rows == expected
                assert q.stats.batched is False
            rows[pkg.name] = expected
        finally:
            coord.shutdown()
    assert rows["reference"] == rows["port"]


def test_over_window_output_falls_back_scalar():
    """Lanes whose row count exceeds the speculative window fall out and
    materialize scalar: full correct results, never a truncated one."""
    sqls = [f"execute agg2_{i} using {100 + i}" for i in range(3)]
    prepared = {
        f"agg2_{i}": (
            "select c_custkey from tpch.tiny.customer where c_custkey <= ?"
        )
        for i in range(3)
    }
    rows = {}
    for pkg in BOTH:
        coord = _coord(pkg)
        try:
            _open_window(coord, 3)
            coord.local.session.set("speculative_result_rows", 4)
            expected = _scalar_expected(pkg, sqls, prepared)
            b0, s0 = _batch_counters(pkg)
            qs = _submit_concurrent(coord, sqls, prepared)
            b1, s1 = _batch_counters(pkg)
            for q, exp in zip(qs, expected):
                assert q.state == "FINISHED", q.error
                assert q.rows == exp
                assert q.stats.batched is False  # >4 rows: fell out
            # one batch ran and served no lane
            assert (b1 - b0, s1 - s0) == (1, 0), pkg.name
            rows[pkg.name] = [q.rows for q in qs]
        finally:
            coord.shutdown()
    assert rows["reference"] == rows["port"]


def test_plan_cache_off_keeps_scalar_path():
    sqls = [f"execute point using {v}" for v in (4, 9, 44)]
    rows = {}
    for pkg in BOTH:
        coord = _coord(pkg, wait_ms=300.0)
        try:
            coord.local.session.set("enable_plan_cache", False)
            expected = _scalar_expected(pkg, sqls, PREPARED)
            b0, _ = _batch_counters(pkg)
            qs = _submit_concurrent(coord, sqls, PREPARED)
            assert _batch_counters(pkg)[0] == b0, pkg.name
            for q, exp in zip(qs, expected):
                assert q.state == "FINISHED", q.error
                assert q.rows == exp
            rows[pkg.name] = [q.rows for q in qs]
        finally:
            coord.shutdown()
    assert all(
        _same_rows(a, b) for a, b in zip(rows["reference"], rows["port"])
    )


# --------------------------------------------- concurrency at fleet scale


def test_hundred_client_demux_correctness():
    """100 concurrent clients with distinct literals racing into one
    queue: every client gets ITS OWN row (no crossed lanes), and
    dispatches are strictly fewer than statements."""
    vals = [1 + ((i * 37) % (N_KEYS - 1)) for i in range(100)]
    sqls = [f"execute point using {v}" for v in vals]
    rows = {}
    for pkg in BOTH:
        coord = _coord(pkg, wait_ms=400.0, max_size=32, concurrency=128)
        try:
            _warm(coord, "execute point using 2", PREPARED)
            b0, s0 = _batch_counters(pkg)
            qs = _submit_concurrent(coord, sqls, PREPARED)
            b1, s1 = _batch_counters(pkg)
            for q, v in zip(qs, vals):
                assert q.state == "FINISHED", q.error
                assert len(q.rows) == 1
                assert q.rows[0][0] == v  # demux: my literal, my row
            batches, stmts = b1 - b0, s1 - s0
            assert batches >= 1, pkg.name
            assert stmts > batches  # mean occupancy > 1
            assert batches + (len(sqls) - stmts) < len(sqls)
            occ = pkg.registry.distribution(
                "serving.batch_occupancy"
            ).values()
            assert occ["count"] > 0
            wait = pkg.registry.distribution(
                "serving.batch_wait_ms"
            ).values()
            assert wait["count"] > 0
            rows[pkg.name] = [q.rows for q in qs]
        finally:
            coord.shutdown()
    assert all(
        _same_rows(a, b) for a, b in zip(rows["reference"], rows["port"])
    )


# ------------------------------------------- admission-hold interplay


def test_admission_parked_statement_skips_batch_window():
    """A statement parked by the admission high-water hold must not ALSO
    accrue the batch window after release."""
    for pkg in BOTH:
        coord = _coord(pkg, wait_ms=3000.0)
        try:
            _warm(coord, "execute point using 3", PREPARED)
            held = {"v": True}
            coord.arbiter.admission_held = lambda: held["v"]
            q = coord.submit("execute point using 888", prepared=PREPARED)
            time.sleep(0.5)
            assert not q.done.is_set()  # parked at admission
            held["v"] = False
            t0 = time.monotonic()
            assert q.done.wait(30)
            after_release = time.monotonic() - t0
            assert q.state == "FINISHED", q.error
            assert q._admission_parked is True
            assert q.stats.batched is False
            assert q.rows[0][0] == 888
            assert after_release < 2.0, (pkg.name, after_release)
        finally:
            coord.shutdown()


def test_unparked_solo_leader_pays_at_most_the_window():
    for pkg in BOTH:
        coord = _coord(pkg, wait_ms=700.0)
        try:
            _warm(coord, "execute point using 5", PREPARED)
            t0 = time.monotonic()
            q = coord.submit("execute point using 6", prepared=PREPARED)
            assert q.done.wait(60)
            dt = time.monotonic() - t0
            assert q.state == "FINISHED", q.error
            assert dt >= 0.6, pkg.name  # it really held the window...
            assert q.stats.batched is False  # ...and answered scalar
        finally:
            coord.shutdown()


# ------------------------------------------------------- observability


def test_runtime_queries_column_and_explain_line():
    """Plain SELECT literal variants batch on the local lane too, show
    batched=true in system.runtime.queries, and the analyze render
    prints the micro-batch line."""
    sql = "select c_acctbal from tpch.tiny.customer where c_custkey = {}"
    vals = (31, 44, 57, 68)
    rows = {}
    for pkg in BOTH:
        coord = _coord(pkg)
        try:
            _warm(coord, sql.format(2))
            _open_window(coord, len(vals))
            qs = _submit_concurrent(coord, [sql.format(v) for v in vals])
            expected = _scalar_expected(
                pkg, [sql.format(v) for v in vals], {}
            )
            for q, exp in zip(qs, expected):
                assert q.state == "FINISHED", q.error
                assert q.rows == exp
            batched = [q for q in qs if q.stats.batched]
            assert len(batched) == len(vals), pkg.name
            got = coord.local.execute(
                "select query_id, batched from system.runtime.queries "
                "where batched"
            ).rows()
            assert {q.qid for q in batched} <= {r[0] for r in got}
            text = pkg.render(batched[0].stats)
            assert "micro-batch:" in text
            assert f"{batched[0].stats.batch_size}-way" in text
            rows[pkg.name] = [q.rows for q in qs]
        finally:
            coord.shutdown()
    assert all(
        _same_rows(a, b) for a, b in zip(rows["reference"], rows["port"])
    )


# ---------------------------------------------- the Q1-shaped GROUP BY


Q1_CUT = """
select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
  sum(l_extendedprice) as sum_base_price,
  sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
  sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
  avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
  avg(l_discount) as avg_disc, count(*) as count_order
from tpch.tiny.lineitem
where l_shipdate <= ?
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""
CUTOFFS = ["1990-01-01", "1992-06-01", "1993-11-30", "1995-06-17",
           "1997-01-01", "1998-12-01"]


def test_q1_shaped_group_by_batch_equals_reference_scalar():
    """Six shipdate cutoffs (the first keeps no row) batch into one pass
    of the port's operators: one K1 call over 6 lanes x 6 groups, each
    lane equal to the reference's scalar rows. Q1 weighs 17 against the
    default max_fragment_weight of 16 in both packages, so the session
    raises it to let the shape through the batch screen."""
    ref = RefRunner()
    ref.execute(f"prepare q1 from {Q1_CUT}")
    coord = _coord(PORT)
    try:
        coord.local.session.set("max_fragment_weight", 24)
        prepared = {"q1": Q1_CUT}
        _warm(coord, "execute q1 using date '1998-09-02'", prepared)
        _open_window(coord, len(CUTOFFS))
        sqls = [f"execute q1 using date '{c}'" for c in CUTOFFS]
        calls = []
        real = PA.onehot_reduce_lanes

        def record(gid, requests, nseg, lanes):
            calls.append((nseg, lanes))
            return real(gid, requests, nseg, lanes)

        PA.onehot_reduce_lanes = record
        try:
            qs = _submit_concurrent(coord, sqls, prepared)
        finally:
            PA.onehot_reduce_lanes = real
        assert calls == [(6, len(CUTOFFS))]
        for q, sql in zip(qs, sqls):
            assert q.state == "FINISHED", q.error
            assert q.stats.batched and q.stats.batch_size == len(CUTOFFS)
            want = [list(r) for r in ref.execute(sql).rows()]
            assert _same_rows(q.rows, want), (sql, q.rows, want)
        assert qs[0].rows == []
        assert not coord.local._no_batch
    finally:
        coord.shutdown()


# ------------------------------------------------ K1's batching rule


@pytest.mark.parametrize(
    "lanes,nseg", [(4, 6), (32, 8), (50, 6)], ids=["4x6", "32x8", "50x6"]
)
def test_onehot_reduce_lanes_equals_one_plain_call_per_lane(lanes, nseg):
    """L lanes through the batched call equal L plain calls: integers
    exact, float64 sums within rel 1e-12 of each segment's sum of |x|;
    lanes with no live row included, L x nseg at 256, and 50 lanes of 6
    groups (300 segments in all). The lane is no part of the segment id
    (no ``onehot_reduce_many`` call folds it in): a CPU tensor takes the
    plain version once, and on a card every lane and request is one
    launch."""
    rows = 512
    rng = np.random.default_rng(lanes * 100 + nseg)
    g = rng.integers(0, nseg + 1, lanes * rows).astype(np.int32)
    g[rows:2 * rows] = nseg  # lane 1: no live row
    g[(lanes - 1) * rows:] = nseg  # the last lane too
    gid = torch.from_numpy(g)
    x = torch.from_numpy(
        rng.integers(-(2**40), 2**40, lanes * rows, dtype=np.int64)
    )
    f = torch.from_numpy(rng.standard_normal(lanes * rows))
    valid = torch.from_numpy(rng.random(lanes * rows) < 0.8)
    reqs = [("count", None, None), ("count", None, valid),
            ("sum", x, None), ("min", x, valid), ("max", x, None),
            ("sum", f, valid), ("min", f, None), ("max", f, valid)]
    folds, plains = [], []
    real, real_plain = PA.onehot_reduce_many, PA.onehot_reduce_lanes_plain

    def record(gid_, requests, nseg_):
        folds.append(nseg_)
        return real(gid_, requests, nseg_)

    def record_plain(gid_, requests, nseg_, lanes_):
        plains.append((nseg_, lanes_))
        return real_plain(gid_, requests, nseg_, lanes_)

    PA.onehot_reduce_many = record
    PA.onehot_reduce_lanes_plain = record_plain
    try:
        got = PA.onehot_reduce_lanes(gid, reqs, nseg, lanes)
    finally:
        PA.onehot_reduce_many = real
        PA.onehot_reduce_lanes_plain = real_plain
    assert folds == [] and plains == [(nseg, lanes)]
    # on a card: the direct form (the H100's grid: 4 blocks on each of
    # 132 SMs), all requests in one launch
    assert PA.onehot_blocks_per_lane(rows, lanes, 528) == 0
    assert len(reqs) <= PA.K_MAX
    assert got.shape == (len(reqs), lanes * nseg)
    res = PA.onehot_results(got, reqs)
    for lane in range(lanes):
        sl = slice(lane * rows, (lane + 1) * rows)
        lane_reqs = [
            (op, None if t is None else t[sl], None if v is None else v[sl])
            for op, t, v in reqs
        ]
        want = PA.onehot_results(
            PA.onehot_reduce_many_plain(gid[sl], lane_reqs, nseg), lane_reqs
        )
        seg = slice(lane * nseg, (lane + 1) * nseg)
        for k, (op, t, v) in enumerate(reqs):
            a, b = res[k][seg], want[k]
            if a.is_floating_point() and op == "sum":
                scale = PA.onehot_reduce_plain(
                    gid[sl], t[sl].abs(), None if v is None else v[sl],
                    nseg, "sum",
                )
                assert bool(((a - b).abs() <= 1e-12 * scale).all())
            else:
                assert torch.equal(a, b), (lane, op)
    assert int(res[0][nseg:2 * nseg].sum()) == 0
    # the plain version of the rule is those per-lane calls side by side
    plain = PA.onehot_results(
        PA.onehot_reduce_lanes_plain(gid, reqs, nseg, lanes), reqs
    )
    for k, (op, t, _) in enumerate(reqs):
        if t is None or not t.is_floating_point() or op != "sum":
            assert torch.equal(res[k], plain[k]), op


def test_coordinator_takes_a_burst_of_connections():
    """Concurrent clients connect at once: the reference's coordinator
    keeps socketserver's accept backlog of 5 (on the card 16 clients
    connecting together were reset), the port's queues 128, and 32
    clients over HTTP at once all get their own row."""
    from presto_tpu_torch.server import PrestoTpuClient

    ref = RefCoord()
    try:
        assert ref.httpd.request_queue_size == 5
    finally:
        ref.shutdown()
    coord = PortCoord(max_concurrent_queries=64, device="cpu").start()
    try:
        assert coord.httpd.request_queue_size == 128
        out, errors = [None] * 32, []
        barrier = threading.Barrier(32)

        def run(i):
            try:
                client = PrestoTpuClient(coord.uri, timeout_s=120)
                barrier.wait(30)
                out[i] = client.execute(
                    f"select c_custkey from tpch.tiny.customer "
                    f"where c_custkey = {i + 1}"
                ).rows()
            except Exception as e:  # noqa: BLE001 - asserted below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errors, errors[0]
        assert out == [[(i + 1,)] for i in range(32)]
    finally:
        coord.shutdown()

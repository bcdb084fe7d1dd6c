"""The port's fault-tolerant execution on the CPU, held to the JAX
reference: task-attempt ids, the durable exchange spool (SPL1 files
byte-equal across packages, each package serving the other's
directory), TASK recovery of a killed worker (the shuffled aggregation's
producer and merge stages, and the partitioned join), the QUERY restart,
the drain with spooled buffers, and the spool's row in
``system.runtime.caches``.

The clusters are the port's (a coordinator and two workers,
``device="cpu"``, one shared spool directory); their rows are held to
the reference's sqlite oracle at tpch.tiny. The spool, task-id and
journal units run the same operations through both packages.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest

from presto_tpu.server import pages_wire as ref_wire
from presto_tpu.server import task_ids as ref_task_ids
from presto_tpu.server.spool import ExchangeSpool as RefSpool
from presto_tpu.utils.metrics import REGISTRY as REF_REGISTRY
from presto_tpu.verifier import SqliteOracle, diff_results
from presto_tpu_torch.server import (
    CoordinatorServer,
    PrestoTpuClient,
    WorkerServer,
)
from presto_tpu_torch.server import pages_wire, rpc, task_ids
from presto_tpu_torch.server.spool import ExchangeSpool
from presto_tpu_torch.session import NodeConfig
from presto_tpu_torch.utils import faults
from presto_tpu_torch.utils.metrics import REGISTRY
from torch_parity import one_torch_thread  # noqa: F401

#: the shuffled aggregation over a join: a producer stage (scan, join,
#: partial aggregation, hash-partitioned output) and a merge stage
#: (the final aggregation on the workers)
JOIN_SQL = (
    "select o_orderpriority, count(*) as n "
    "from tpch.tiny.orders, tpch.tiny.lineitem "
    "where o_orderkey = l_orderkey "
    "group by o_orderpriority order by o_orderpriority"
)
#: a forced partitioned join: two producer stages and a join stage
PJOIN_SQL = (
    "select o_orderpriority, sum(l_quantity) as q "
    "from tpch.tiny.orders join tpch.tiny.lineitem "
    "on o_orderkey = l_orderkey "
    "group by o_orderpriority order by o_orderpriority"
)

SPOOLS = {"ref": RefSpool, "port": ExchangeSpool}
REGISTRIES = {"ref": REF_REGISTRY, "port": REGISTRY}


@pytest.fixture(autouse=True)
def clear_fault_plane():
    yield
    faults.configure(None)


@pytest.fixture(scope="module")
def oracle():
    return SqliteOracle("tiny")


def assert_oracle_rows(oracle, sql, rows):
    diff = diff_results(
        [tuple(r) for r in rows], oracle.execute(sql), ordered=True,
        rel_tol=1e-9,
    )
    assert diff is None, diff


def _wait(pred, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise TimeoutError(f"timed out waiting for {msg}")


def _mk_cluster(tmp_path, n=2, policy="TASK", extra=None):
    cfg = {
        "exchange.spool-path": str(tmp_path / "spool"),
        "exchange.spool-bytes": "64MB",
    }
    cfg.update(extra or {})
    coord = CoordinatorServer(
        config=NodeConfig(dict(cfg)), device="cpu"
    ).start()
    coord.local.session.set("retry_policy", policy)
    workers = [
        WorkerServer(
            coordinator_uri=coord.uri, config=NodeConfig(dict(cfg)),
            device="cpu",
        ).start()
        for _ in range(n)
    ]
    _wait(lambda: len(coord.active_workers()) >= n, msg="workers")
    return coord, workers


def _teardown(coord, workers):
    faults.configure(None)
    for w in workers:
        w.shutdown(graceful=False)
    coord.shutdown()


def _attempts_by_logical(stage: dict):
    by = {}
    for t in stage["tasks"]:
        by.setdefault(task_ids.logical_key(t["task_id"]), []).append(t)
    return by


def _run_in_thread(client, sql):
    out, errs = {}, []

    def run():
        try:
            out["res"] = client.execute(sql)
        except Exception as e:  # surfaced by the caller's assert
            errs.append(e)

    t = threading.Thread(target=run)
    t.start()
    return t, out, errs


# ------------------------------------------------------ task-attempt ids


@pytest.mark.parametrize(
    "qid,kind,seq",
    [("q_c7", task_ids.PRODUCER, 3), ("q_c1_ab12cd", task_ids.MERGE, 0),
     ("q_c12_ffffff", task_ids.JOIN, 41)],
)
def test_task_ids_round_trip_as_the_reference(qid, kind, seq):
    tid = task_ids.mint(qid, kind, seq)
    assert tid == ref_task_ids.mint(qid, kind, seq)
    t, rt = task_ids.parse(tid), ref_task_ids.parse(tid)
    assert (t.query_id, t.kind, t.seq, t.attempt) == (
        rt.query_id, rt.kind, rt.seq, rt.attempt,
    ) == (qid, kind, seq, 0)
    assert str(t) == tid
    nxt = task_ids.next_attempt(tid)
    assert nxt == ref_task_ids.next_attempt(tid)
    assert task_ids.logical_key(nxt) == task_ids.logical_key(tid) == (
        ref_task_ids.logical_key(nxt)
    )
    assert task_ids.attempt_of(nxt) == ref_task_ids.attempt_of(nxt) == 1


def test_legacy_task_ids_are_their_own_key():
    for mod in (task_ids, ref_task_ids):
        assert mod.try_parse("t") is None
        assert mod.logical_key("t") == "t"
        assert mod.attempt_of("t") == 0
        with pytest.raises(ValueError):
            mod.next_attempt("t")
        with pytest.raises(ValueError):
            mod.mint("q.1", "t", 0)


def test_query_ids_unique_across_coordinator_restarts():
    a = CoordinatorServer(device="cpu")
    b = CoordinatorServer(device="cpu")
    try:
        qa, qb = a.submit("select 1"), b.submit("select 1")
        assert qa.done.wait(30) and qb.done.wait(30)
        assert qa.qid != qb.qid
    finally:
        a.shutdown()
        b.shutdown()


# ------------------------------------------------------------ spool units


@pytest.mark.parametrize("pkg", sorted(SPOOLS))
def test_spool_round_trip_and_attempt_dedup(pkg, tmp_path):
    sp = SPOOLS[pkg](str(tmp_path))
    a0 = "q_c1.prod.0.a0"
    sp.append(a0, 0, b"page-zero")
    sp.append(a0, 0, b"page-one")
    sp.append(a0, 1, b"other-part")
    # an uncommitted attempt never serves
    assert sp.serve("q_c1.prod.0", 0) is None
    sp.commit(a0)
    assert sp.serve("q_c1.prod.0", 0) == [b"page-zero", b"page-one"]
    assert sp.serve("q_c1.prod.0", 1) == [b"other-part"]
    assert sp.serve("q_c1.prod.0", 2) == []  # committed, empty partition
    # one attempt's pages per call, the lowest committed attempt first
    a1 = "q_c1.prod.0.a1"
    sp.append(a1, 0, b"dup-zero")
    sp.commit(a1)
    assert sp.serve("q_c1.prod.0", 0) == [b"page-zero", b"page-one"]
    sp.discard(a0)
    assert sp.serve("q_c1.prod.0", 0) == [b"dup-zero"]
    # a failed commit marker leaves the attempt unserved; a retried
    # commit publishes it (the port's fault plane reaches the port's
    # spool only)
    if pkg == "port":
        a2 = "q_c1.prod.9.a0"
        sp.append(a2, 0, b"late")
        faults.configure(
            {"rules": [{"action": "io_error", "path": ".ok", "op": "write"}]}
        )
        with pytest.raises(OSError):
            sp.commit(a2)
        assert sp.serve("q_c1.prod.9", 0) is None
        faults.configure(None)
        sp.commit(a2)
        assert sp.serve("q_c1.prod.9", 0) == [b"late"]


@pytest.mark.parametrize("pkg", sorted(SPOOLS))
def test_spool_checksum_detects_on_disk_corruption(pkg, tmp_path):
    sp = SPOOLS[pkg](str(tmp_path))
    tid = "q_c1.prod.1.a0"
    sp.append(tid, 0, b"x" * 100)
    sp.commit(tid)
    fn = tmp_path / f"{tid}.0.pages"
    raw = bytearray(fn.read_bytes())
    raw[20] ^= 0xFF  # flip a payload byte
    fn.write_bytes(bytes(raw))
    corrupt = REGISTRIES[pkg].counter("spool.corrupt")
    before = corrupt.total
    assert sp.serve("q_c1.prod.1", 0) is None
    assert corrupt.total == before + 1


def test_spool_corrupt_fault_rule_falls_back_to_next_attempt(tmp_path):
    sp = ExchangeSpool(str(tmp_path))
    for a, payload in (("a0", b"first"), ("a1", b"second")):
        tid = f"q_c1.prod.2.{a}"
        sp.append(tid, 0, payload)
        sp.commit(tid)
    faults.configure(
        {"rules": [{"action": "spool_corrupt", "task": ".a0", "count": 1}]}
    )
    before = REGISTRY.counter("spool.corrupt").total
    # a0 reads corrupt (injected), recovery falls to the a1 attempt
    assert sp.serve("q_c1.prod.2", 0) == [b"second"]
    assert REGISTRY.counter("spool.corrupt").total == before + 1


@pytest.mark.parametrize("pkg", sorted(SPOOLS))
def test_spool_ttl_and_budget_gc(pkg, tmp_path):
    ttl_dir, budget_dir = tmp_path / "ttl", tmp_path / "budget"
    sp = SPOOLS[pkg](str(ttl_dir), budget_bytes=64, ttl_s=0.2)
    sp.append("q_c1.prod.3.a0", 0, b"y" * 40)
    sp.commit("q_c1.prod.3.a0")
    time.sleep(0.25)
    sp.gc(force=True)
    assert os.listdir(str(ttl_dir)) == []  # the TTL expired the attempt
    # over the byte budget, the oldest committed attempt goes first
    sp2 = SPOOLS[pkg](str(budget_dir), budget_bytes=64, ttl_s=600.0)
    sp2.append("q_c1.prod.4.a0", 0, b"a" * 48)
    sp2.commit("q_c1.prod.4.a0")
    time.sleep(0.02)
    sp2.append("q_c1.prod.5.a0", 0, b"b" * 48)
    sp2.commit("q_c1.prod.5.a0")
    sp2.gc(force=True)
    assert sp2.serve("q_c1.prod.4", 0) is None
    assert sp2.serve("q_c1.prod.5", 0) == [b"b" * 48]
    st = sp2.stats()
    assert st["entries"] == 1 and st["budget_bytes"] == 64


def _wire_pages(mod, seed):
    """Three wire frames (a BIGINT, a DOUBLE with NULLs, a dictionary
    VARCHAR) from one seed, serialized by ``mod``'s pages_wire."""
    rng = np.random.default_rng(seed)
    frames = []
    for n in (5, 1000, 0):
        k = rng.integers(-(1 << 40), 1 << 40, n)
        x = rng.standard_normal(n)
        xv = rng.random(n) > 0.2
        s = rng.integers(0, 3, n).astype(np.int32)
        dv = np.array(["AIR", "RAIL", "TRUCK"], dtype=object)
        cols = [
            ("k", k, None, "bigint", None),
            ("x", x, xv, "double", None),
            ("s", s, None, "varchar", dv),
        ]
        frames.append(mod.serialize_page(cols, n))
    return frames


def test_spl1_files_are_byte_equal_and_served_across_packages(tmp_path):
    ref_frames, port_frames = _wire_pages(ref_wire, 5), _wire_pages(
        pages_wire, 5
    )
    assert ref_frames == port_frames
    spools = {
        "ref": RefSpool(str(tmp_path / "ref")),
        "port": ExchangeSpool(str(tmp_path / "port")),
    }
    frames = {"ref": ref_frames, "port": port_frames}
    for pkg, sp in spools.items():
        for i, f in enumerate(frames[pkg]):
            sp.append("q_c3_aa11bb.prod.2.a0", i % 2, f)
        sp.commit("q_c3_aa11bb.prod.2.a0")
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        assert (tmp_path / "ref" / name).read_bytes() == (
            tmp_path / "port" / name
        ).read_bytes(), name
    # each package serves the other's directory, frame for frame
    crossed = {
        "ref": RefSpool(str(tmp_path / "port")),
        "port": ExchangeSpool(str(tmp_path / "ref")),
    }
    for sp in crossed.values():
        assert sp.serve("q_c3_aa11bb.prod.2", 0) == [
            ref_frames[0], ref_frames[2]
        ]
        assert sp.serve("q_c3_aa11bb.prod.2", 1) == [ref_frames[1]]
    for raw in crossed["port"].serve("q_c3_aa11bb.prod.2", 1):
        payload, schema, nrows = pages_wire.deserialize_page(raw)
        r_payload, r_schema, r_nrows = ref_wire.deserialize_page(raw)
        assert nrows == r_nrows == 1000
        assert list(schema) == list(r_schema)
        np.testing.assert_array_equal(payload["k"], r_payload["k"])


# ------------------------------------------------------- cluster recovery


def test_retry_policy_none_never_touches_the_spool(tmp_path, oracle):
    """NONE is the default path: the spool is configured but cold — no
    spec carries the flag, no file is written, no recovery stat moves."""
    coord, ws = _mk_cluster(tmp_path, policy="NONE")
    try:
        client = PrestoTpuClient(coord.uri, timeout_s=120)
        res = client.execute(JOIN_SQL)
        assert_oracle_rows(oracle, JOIN_SQL, res.rows())
        assert os.listdir(str(tmp_path / "spool")) == []
        info = client.query_info(res.query_id)
        assert info["retry_policy"] == "NONE"
        assert info["task_recoveries"] == 0
        assert info["spool_pages_served"] == 0
    finally:
        _teardown(coord, ws)


def _seal_observed(workers):
    """The coordinator's source-seal broadcast reached a merge task:
    every producer range completed as the coordinator saw it, so no
    producer may be re-attempted past this point."""
    for w in workers:
        with w._lock:
            tasks = list(w.tasks.values())
        for t in tasks:
            if t.spec.partition_scan < 0 and t.sources_done:
                return True
    return False


def test_kill_worker_after_the_producers_reruns_only_its_merge(
    tmp_path, oracle
):
    """A worker dies after the producer stage sealed: only its merge
    partition re-runs (a1), reading the dead worker's producer output
    from the spool; every producer keeps one attempt."""
    coord, ws = _mk_cluster(tmp_path, policy="TASK")
    try:
        client = PrestoTpuClient(coord.uri, timeout_s=120)
        # the merge stage's start is held back so the kill (armed on
        # the seal) lands before the merge gather completes
        faults.configure({"seed": 2, "rules": [
            {"action": "delay", "task": ".merge.", "delay_s": 0.8},
        ]})
        t, out, errs = _run_in_thread(client, JOIN_SQL)
        _wait(lambda: _seal_observed(ws), msg="producer stage sealed")
        served_before = REGISTRY.counter("spool.pages_served").total
        ws[0]._fault_kill()
        t.join(120)
        assert not errs, f"query failed despite TASK recovery: {errs}"
        assert_oracle_rows(oracle, JOIN_SQL, out["res"].rows())
        info = client.query_info(out["res"].query_id)
        prod = next(s for s in info["stages"] if s["kind"] == "producer")
        merge = next(s for s in info["stages"] if s["kind"] == "merge")
        for lk, attempts in _attempts_by_logical(prod).items():
            assert len(attempts) == 1, (lk, attempts)
        assert [
            a for a in _attempts_by_logical(merge).values() if len(a) > 1
        ], "no merge recovery recorded"
        assert info["spool_pages_served"] > 0
        assert REGISTRY.counter("spool.pages_served").total > served_before
        assert info["task_recoveries"] >= 1
        assert info["retry_policy"] == "TASK"
    finally:
        _teardown(coord, ws)


def test_kill_worker_mid_producer_stage_counts_nothing_twice(
    tmp_path, oracle
):
    """A worker dies after committing one producer, while the stage
    still runs: its ranges re-run as a1 attempts of the same logical
    tasks and the merges fold one attempt per logical task."""
    coord, ws = _mk_cluster(tmp_path, policy="TASK")
    try:
        client = PrestoTpuClient(coord.uri, timeout_s=120)
        coord.local.session.set("page_capacity", 4096)
        faults.configure({"seed": 3, "rules": [
            {"action": "delay", "task": ".prod.", "delay_s": 0.2},
        ]})
        victim = ws[0]

        def victim_committed():
            with victim._lock:
                tasks = list(victim.tasks.values())
            return any(
                x.state == "FINISHED" and len(x.parts) > 1 and x.spooled
                for x in tasks
            )

        t, out, errs = _run_in_thread(client, JOIN_SQL)
        _wait(victim_committed, msg="victim committed a producer")
        victim._fault_kill()
        t.join(120)
        assert not errs, f"query failed despite TASK recovery: {errs}"
        assert_oracle_rows(oracle, JOIN_SQL, out["res"].rows())
        info = client.query_info(out["res"].query_id)
        assert info["task_recoveries"] >= 1
    finally:
        coord.local.session.reset("page_capacity")
        _teardown(coord, ws)


def test_kill_worker_mid_partitioned_join_rereads_the_spool(
    tmp_path, oracle
):
    """A partitioned join: a worker dies after both producer stages
    committed and before its join task pulled them. Its join partition
    re-runs on the survivor as a1, which reads the dead worker's
    producer partitions from the spool (the reference has no join-task
    recovery; the port's follows its merge-task recovery)."""
    coord, ws = _mk_cluster(tmp_path, policy="TASK")
    try:
        coord.local.session.set("join_distribution_type", "PARTITIONED")
        client = PrestoTpuClient(coord.uri, timeout_s=120)
        faults.configure({"seed": 4, "rules": [
            {"action": "delay", "task": ".join.", "delay_s": 0.8},
        ]})

        def join_posted():
            with ws[1]._lock:
                return any(".join." in t for t in ws[1].tasks)

        t, out, errs = _run_in_thread(client, PJOIN_SQL)
        _wait(join_posted, msg="join tasks posted")
        ws[0]._fault_kill()
        t.join(120)
        assert not errs, f"query failed despite TASK recovery: {errs}"
        assert_oracle_rows(oracle, PJOIN_SQL, out["res"].rows())
        info = client.query_info(out["res"].query_id)
        kinds = [s["kind"] for s in info["stages"]]
        assert kinds == ["producer", "producer", "join"], kinds
        for st in info["stages"][:2]:
            for lk, attempts in _attempts_by_logical(st).items():
                assert len(attempts) == 1, (lk, attempts)
        assert [
            a
            for a in _attempts_by_logical(info["stages"][2]).values()
            if len(a) > 1
        ], "no join recovery recorded"
        assert info["spool_pages_served"] > 0
    finally:
        coord.local.session.reset("join_distribution_type")
        _teardown(coord, ws)


def test_query_retry_policy_restarts_the_whole_query(tmp_path, oracle):
    """retry_policy=QUERY with no task-retry budget: a killed worker
    fails the attempt and the bounded restart completes it on the
    survivor."""
    coord, ws = _mk_cluster(
        tmp_path, policy="QUERY",
        extra={"failure-detector.threshold": "1"},
    )
    try:
        coord.local.session.set("task_retry_budget", 0)
        faults.configure({"rules": [
            {"action": "kill_worker", "node": ws[1].node_id, "count": 1},
        ]})
        before = REGISTRY.counter("coordinator.query_restarts").total
        client = PrestoTpuClient(coord.uri, timeout_s=120)
        sql = "select count(*) as c from tpch.tiny.lineitem"
        res = client.execute(sql)
        assert_oracle_rows(oracle, sql, res.rows())
        assert REGISTRY.counter("coordinator.query_restarts").total > before
        info = client.query_info(res.query_id)
        assert info["query_restarts"] >= 1
        assert info["retry_policy"] == "QUERY"
    finally:
        coord.local.session.reset("task_retry_budget")
        _teardown(coord, ws)


def test_query_restart_outlasting_the_breaker_skips_the_dead_worker(
    tmp_path, oracle
):
    """The failed attempt of a QUERY restart ends only when its claimed
    ranges do: here a delay holds the survivor's range past the default
    5 s breaker cool-off, so the dead worker's breaker is half-open when
    the restart schedules. The restart still completes on the survivor:
    a node whose failure failed the attempt takes no work until it
    announces itself again, and the attempt claims no range after the
    failure."""
    coord, ws = _mk_cluster(
        tmp_path, policy="QUERY",
        extra={"failure-detector.threshold": "1"},
    )
    dead, survivor = ws[1].node_id, ws[0].node_id
    try:
        assert coord._breaker_open_s == 5.0  # the default
        coord.local.session.set("task_retry_budget", 0)
        coord.local.session.set("query_retry_count", 1)
        faults.configure({"rules": [
            {"action": "kill_worker", "node": dead, "count": 1},
            {"action": "delay", "node": survivor, "count": 1,
             "delay_s": 5.5},
        ]})
        client = PrestoTpuClient(coord.uri, timeout_s=120)
        sql = "select count(*) as c from tpch.tiny.lineitem"
        t0 = time.monotonic()
        res = client.execute(sql)
        assert time.monotonic() - t0 > 5.5
        assert_oracle_rows(oracle, sql, res.rows())
        info = client.query_info(res.query_id)
        assert info["query_restarts"] == 1
        assert dead in coord._lost_nodes
        # the breaker alone would have let the restart probe it again
        breaker = coord._breaker(dead)
        assert time.monotonic() - breaker._opened >= breaker.open_s
        # the restart's stage ran on the survivor alone
        last = info["stages"][-1]
        assert last["tasks"] and {
            t["node_id"] for t in last["tasks"]
        } == {survivor}
        # the failed attempt claimed no range after the kill: one task
        # on each worker, then the restart's
        first = info["stages"][0]
        assert len(first["tasks"]) == 2
    finally:
        coord.local.session.reset("task_retry_budget")
        coord.local.session.reset("query_retry_count")
        _teardown(coord, ws)


def test_drain_under_load_loses_no_query(tmp_path, oracle):
    """Draining a worker mid-query under TASK: the query completes, the
    worker leaves scheduling and exits; a FINISHED task whose output is
    committed to the spool does not keep a draining worker alive."""
    coord, ws = _mk_cluster(tmp_path, policy="TASK")
    try:
        client = PrestoTpuClient(coord.uri, timeout_s=120)
        faults.configure({"seed": 5, "rules": [
            {"action": "delay", "task": ".prod.", "delay_s": 0.1},
        ]})
        t, out, errs = _run_in_thread(client, JOIN_SQL)
        _wait(lambda: any(ws[0].tasks), msg="a task on the worker")
        rpc.call_json("PUT", ws[0].uri + "/v1/state/drain")
        t.join(120)
        assert not errs, f"drain lost a query: {errs}"
        assert_oracle_rows(oracle, JOIN_SQL, out["res"].rows())
        faults.configure(None)
        _wait(
            lambda: ws[0].node_id
            not in {w.node_id for w in coord.active_workers()},
            msg="drained worker left scheduling",
        )
        _wait(lambda: ws[0]._shutting_down, msg="drained worker exit")
        sql = "select count(*) as c from tpch.tiny.orders"
        assert_oracle_rows(oracle, sql, client.execute(sql).rows())
        # a committed producer's buffers no longer pin a draining worker
        w = ws[1]
        with w._lock:
            w.tasks.clear()
        from presto_tpu_torch.server.protocol import FragmentSpec
        from presto_tpu_torch.server.worker import _Task

        task = _Task(
            FragmentSpec(
                task_id="q_c1_aaaaaa.prod.0.a0", query_id="q_c1_aaaaaa",
                fragment=None, partition_scan=0, split_start=0,
                split_end=0, n_partitions=2, spool=True,
            ),
            spool=w.spool,
        )
        task.state = "FINISHED"
        with w._lock:
            w.tasks[task.spec.task_id] = task
        assert w._drain_busy()  # unserved and not durable
        task.spooled = True
        assert not w._drain_busy()
    finally:
        _teardown(coord, ws)


def test_spool_row_in_runtime_caches_and_explain(tmp_path):
    coord, ws = _mk_cluster(tmp_path, policy="TASK")
    try:
        client = PrestoTpuClient(coord.uri, timeout_s=120)
        client.execute(JOIN_SQL)
        rows = client.execute(
            "select cache, entries, bytes, budget_bytes "
            "from system.runtime.caches order by cache"
        ).rows()
        spool_rows = [r for r in rows if r[0] == "exchange.spool"]
        assert spool_rows, rows
        assert spool_rows[0][1] > 0  # committed attempts present
        assert spool_rows[0][2] > 0  # bytes on disk
        assert spool_rows[0][3] == 64 << 20
        text = "\n".join(
            r[0] for r in client.execute("explain analyze " + JOIN_SQL).rows()
        )
        assert "fault tolerance: retry_policy=TASK" in text
        assert "task_recoveries" in text
    finally:
        _teardown(coord, ws)


def test_launcher_boots_spool_and_drain_config(tmp_path):
    from presto_tpu.server.launcher import load_etc as ref_load_etc
    from presto_tpu_torch.server import launcher

    etc = tmp_path / "etc"
    (etc / "catalog").mkdir(parents=True)
    (etc / "config.properties").write_text(
        "coordinator=true\n"
        f"exchange.spool-path={tmp_path}/sp\n"
        "exchange.spool-bytes=1MB\n"
        "exchange.spool-ttl-s=60\n"
        "retry-policy=TASK\n"
        "drain.grace-s=5\n"
    )
    (etc / "catalog" / "tpch.properties").write_text("connector.name=tpch\n")
    config, _ = launcher.load_etc(str(etc))
    ref_config, _ = ref_load_etc(str(etc))
    for key in ("retry-policy", "drain.grace-s", "exchange.spool-bytes"):
        assert config.get(key) == ref_config.get(key)
    sp = ExchangeSpool.from_config(config)
    assert sp.budget_bytes == 1 << 20 and sp.ttl_s == 60.0
    coord = launcher.launch(str(etc), device="cpu")
    try:
        assert coord.spool is not None and coord.spool.budget_bytes == 1 << 20
        assert coord._retry_policy() == "TASK"
    finally:
        coord.shutdown()


def test_memory_victim_readmitted_under_query_retry(tmp_path, oracle):
    """retry_policy=QUERY with one restart: the memory killer's victim is
    re-admitted once pressure subsides, killed again on the same
    too-small pool, and then fails with MEMORY_PRESSURE; small queries
    still answer."""
    from presto_tpu_torch.server.client import QueryFailed

    coord, ws = _mk_cluster(tmp_path, n=1, policy="QUERY", extra={
        "announcement.interval-s": "0.1",
        "staging.cache-bytes": "0",
        "query.max-memory-per-node": "49152",
        "memory.governance-enabled": "true",
        "memory.blocked-timeout-s": "0.2",
        "memory.reserve-block-max-s": "10",
    })
    coord.local.session.set("query_retry_count", 1)
    readmitted = REGISTRY.counter("memory.victims_readmitted")
    before = readmitted.total
    try:
        client = PrestoTpuClient(coord.uri, timeout_s=120)
        with pytest.raises(QueryFailed, match="MEMORY_PRESSURE"):
            client.execute("select sum(l_quantity) s from tpch.tiny.lineitem")
        assert readmitted.total == before + 1
        sql = "select count(*) c from tpch.tiny.region"
        assert_oracle_rows(oracle, sql, client.execute(sql).rows())
    finally:
        _teardown(coord, ws)

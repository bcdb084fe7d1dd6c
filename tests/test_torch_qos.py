"""The port's QoS plane on the CPU, held to the JAX reference: priority
admission lanes (the same arrival sequence admits in the same order in
both packages), the resource-group ``priority`` parse, the legacy
semaphore with ``qos.enabled`` off, preempt-and-resume of a shuffled
join behind an interactive lookup (the victim parks SUSPENDED, its poll
answers at once, it resumes under the same logical task ids and its rows
equal the unpreempted run and the reference's), the ``suspend_storm``
hysteresis, a worker killed while the victim is parked, the deadline-
aware speculation scale, SLO misses, and the journal's
``qos_suspend``/``qos_resume`` frames (byte-equal across packages, each
package replaying the other's journal).

The clusters are the port's (a coordinator and two workers,
``device="cpu"``, one shared spool directory); the reference's rows come
from its ``LocalQueryRunner`` at tpch.tiny.
"""

from __future__ import annotations

import json
import os
import threading
import time
import types
import urllib.request

import pytest

from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu.exec.stats import QueryStats as RefQueryStats
from presto_tpu.server import CoordinatorServer as RefCoordinator
from presto_tpu.server import journal as ref_journal_mod
from presto_tpu.server import qos as ref_qos_mod
from presto_tpu.server.journal import CoordinatorJournal as RefJournal
from presto_tpu.server.resource_groups import (
    ResourceGroupManager as RefGroups,
)
from presto_tpu.session import NodeConfig as RefNodeConfig
from presto_tpu_torch.exec.stats import QueryStats
from presto_tpu_torch.server import CoordinatorServer, WorkerServer, task_ids
from presto_tpu_torch.server import journal as journal_mod
from presto_tpu_torch.server import qos as qos_mod
from presto_tpu_torch.server.journal import CoordinatorJournal
from presto_tpu_torch.server.resource_groups import ResourceGroupManager
from presto_tpu_torch.session import NodeConfig
from presto_tpu_torch.utils import faults
from presto_tpu_torch.utils.metrics import REGISTRY
from torch_parity import one_torch_thread  # noqa: F401

#: multi-stage TPC-H join forced onto the partitioned-producer path (the
#: spool-backed stage shape preempt-and-resume targets)
JOIN_SQL = (
    "select o_orderpriority, count(*) as n "
    "from tpch.tiny.orders, tpch.tiny.lineitem "
    "where o_orderkey = l_orderkey "
    "group by o_orderpriority order by o_orderpriority"
)

LOOKUP_SQL = "select count(*) as c from tpch.tiny.region"

#: two lanes: interactive strictly above batch
RESOURCE_GROUPS = {
    "rootGroups": [
        {"name": "interactive", "weight": 1, "hardConcurrencyLimit": 4,
         "priority": 10},
        {"name": "batch", "weight": 1, "hardConcurrencyLimit": 4,
         "priority": 0},
    ],
    "selectors": [{"user": "inter-.*", "group": "interactive"}],
    "defaultGroup": "batch",
}

PACKAGES = {
    "ref": (RefCoordinator, RefNodeConfig, {}),
    "port": (CoordinatorServer, NodeConfig, {"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def clear_fault_plane():
    yield
    faults.configure(None)


@pytest.fixture(scope="module")
def ref_rows():
    runner = RefRunner()
    return {
        sql: [tuple(r) for r in runner.execute(sql).rows()]
        for sql in (JOIN_SQL, LOOKUP_SQL)
    }


def _wait(pred, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise TimeoutError(f"timed out waiting for {msg}")


def _mk_cluster(tmp_path, n=2, policy="TASK", extra=None, slots=1):
    cfg = {
        "exchange.spool-path": str(tmp_path / "spool"),
        "exchange.spool-bytes": "64MB",
        "qos.enabled": "true",
        "qos.resume-grace-s": "0.2",
    }
    cfg.update(extra or {})
    coord = CoordinatorServer(
        config=NodeConfig(dict(cfg)), max_concurrent_queries=slots,
        resource_groups=RESOURCE_GROUPS, device="cpu",
    ).start()
    coord.local.session.set("retry_policy", policy)
    coord.local.session.set("join_distribution_type", "PARTITIONED")
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


def _producer_reruns(info):
    """(logical key, attempts) of producer tasks with more than one
    attempt: a resume must leave this empty."""
    out = []
    for st in info["stages"]:
        if st["kind"] != "producer":
            continue
        by = {}
        for t in st["tasks"]:
            by.setdefault(task_ids.logical_key(t["task_id"]), []).append(t)
        out += [(k, len(v)) for k, v in by.items() if len(v) != 1]
    return out


def _start_victim(coord):
    """Submit the analytic join in the batch lane with its producers
    (and the interactive lookup's source tasks) slowed to hold the
    suspension window open, then the lookup once producer ranges are
    claimed; returns both queries."""
    faults.configure({"rules": [
        {"action": "delay", "task": ".prod.", "delay_s": 0.25},
        {"action": "delay", "task": ".src.", "delay_s": 0.3},
    ]})
    qa = coord.submit(JOIN_SQL, user="batch-1")
    _wait(lambda: qa.state == "RUNNING", 10, "the join running")
    time.sleep(0.4)  # let producer ranges be claimed
    qi = coord.submit(LOOKUP_SQL, user="inter-1")
    _wait(lambda: getattr(qa, "qos_suspensions", 0) >= 1, 15,
          f"a suspension (state {qa.state})")
    return qa, qi


# ------------------------------------------------------- lanes and groups


def test_resource_group_priority_parsed():
    for mgr in (RefGroups(RESOURCE_GROUPS),
                ResourceGroupManager(RESOURCE_GROUPS)):
        assert mgr.groups["interactive"].priority == 10
        assert mgr.groups["batch"].priority == 0
        snap = {g["name"]: g for g in mgr.snapshot()}
        assert snap["interactive"]["priority"] == 10
        assert snap["batch"]["priority"] == 0


def _admission_order(pkg):
    """One slot, preemption off: the groups each package's coordinator
    admits a fixed arrival sequence in (its ``_run_sql`` records the
    group and waits on a gate instead of running SQL)."""
    Coord, Config, kw = PACKAGES[pkg]
    coord = Coord(
        config=Config({"qos.enabled": "true",
                       "qos.max-suspensions-per-query": "0"}),
        max_concurrent_queries=1, resource_groups=RESOURCE_GROUPS, **kw,
    )
    order, gate = [], threading.Event()

    def gated(q):
        order.append((q.resource_group, q.user))
        gate.wait(timeout=30)

    coord._run_sql = gated
    try:
        assert coord.qos is not None
        first = coord.submit(LOOKUP_SQL, user="batch-0")
        _wait(lambda: len(order) == 1, 10, "the first admission")
        qs = [first]
        for user in ("batch-1", "batch-2", "inter-1", "batch-3",
                     "inter-2"):
            qs.append(coord.submit(LOOKUP_SQL, user=user))
            time.sleep(0.05)  # a fixed arrival order
        time.sleep(0.2)
        assert len(order) == 1  # the one slot is held
        gate.set()
        for q in qs:
            assert q.done.wait(30) and q.state == "FINISHED", q.error
        assert getattr(first, "qos_suspensions", 0) == 0
        return order
    finally:
        gate.set()
        coord.shutdown()


def test_priority_lanes_admit_in_the_reference_order():
    order = _admission_order("port")
    assert order == _admission_order("ref")
    # strict priority across lanes, FIFO within one
    assert [u for _, u in order] == [
        "batch-0", "inter-1", "inter-2", "batch-1", "batch-2", "batch-3",
    ]


def test_qos_disabled_is_legacy_admission():
    """No qos.enabled: the controller is never built, admission is the
    semaphore, the runtime view is empty and QueryInfo has no block."""
    coord = CoordinatorServer(
        config=NodeConfig({"qos.enabled": "false"}),
        max_concurrent_queries=2, device="cpu",
    )
    try:
        assert coord.qos is None
        q = coord.submit(LOOKUP_SQL)
        assert q.done.wait(60) and q.state == "FINISHED", q.error
        assert q.rows == [[5]]
        assert coord.local.execute(
            "select * from system.runtime.qos"
        ).rows() == []
        assert "qos" not in coord.query_info(q)
    finally:
        coord.shutdown()


# ------------------------------------------------ preempt-and-resume


def test_preempt_and_resume_equals_the_unpreempted_run(tmp_path, ref_rows):
    coord, workers = _mk_cluster(
        tmp_path, extra={"coordinator.journal-path": str(tmp_path / "j")},
    )
    try:
        plain = coord.submit(JOIN_SQL, user="batch-0")
        assert plain.done.wait(120) and plain.state == "FINISHED"
        unpreempted = [tuple(r) for r in plain.rows]
        assert unpreempted == ref_rows[JOIN_SQL]
        qa, qi = _start_victim(coord)
        # a SUSPENDED query's poll answers at once with no data, a retry
        # hint and the same token
        t0 = time.monotonic()
        with urllib.request.urlopen(
            f"{coord.uri}/v1/statement/{qa.qid}/0", timeout=5
        ) as resp:
            body = json.loads(resp.read())
            assert resp.status == 200
            assert resp.headers.get("Retry-After") == "0.5"
        assert time.monotonic() - t0 < 0.8
        assert body["data"] == []
        assert body["stats"]["state"] == "SUSPENDED"
        assert body["nextUri"].endswith(f"/v1/statement/{qa.qid}/0")
        assert qi.done.wait(60) and qi.state == "FINISHED", qi.error
        assert [tuple(r) for r in qi.rows] == ref_rows[LOOKUP_SQL]
        assert qa.done.wait(120) and qa.state == "FINISHED", qa.error
        assert [tuple(r) for r in qa.rows] == unpreempted
        info = coord.query_info(qa)
        assert _producer_reruns(info) == []
        assert info["qos"]["group"] == "batch"
        assert info["qos"]["suspensions"] >= 1
        assert info["qos"]["resumes"] >= 1
        assert info["qos"]["suspended_ms"] > 0.0
        rows = {
            r[0]: r for r in coord.local.execute(
                'select "group", suspensions, resumes, queries '
                "from system.runtime.qos"
            ).rows()
        }
        assert rows["batch"][1] >= 1 and rows["batch"][2] >= 1
        assert rows["interactive"][3] >= 1
        frames = [
            json.loads(line.split(" ", 1)[1])["ev"]
            for f in sorted(os.listdir(tmp_path / "j"))
            for line in open(tmp_path / "j" / f).read().splitlines()
            if " " in line
        ]
        assert "qos_suspend" in frames and "qos_resume" in frames
        assert frames.index("qos_suspend") < frames.index("qos_resume")
    finally:
        _teardown(coord, workers)


def test_suspend_storm_suspends_exactly_once(tmp_path, ref_rows):
    """Three back-to-back triggers against one query: the resume grace
    refuses all but the first, and the query finishes exact."""
    coord, workers = _mk_cluster(
        tmp_path, n=1, extra={"qos.resume-grace-s": "60"}
    )
    try:
        trig0 = REGISTRY.counter("qos.preempt_triggers").total
        faults.configure({"rules": [
            {"action": "delay", "task": ".src.", "delay_s": 0.2},
            {"action": "suspend_storm", "owner": "q_c", "count": 3},
        ]})
        q = coord.submit(JOIN_SQL, user="batch-1")
        assert q.done.wait(120) and q.state == "FINISHED", q.error
        assert [tuple(r) for r in q.rows] == ref_rows[JOIN_SQL]
        assert REGISTRY.counter("qos.preempt_triggers").total - trig0 == 3
        assert q.qos_suspensions == 1
        assert q.qos_resumes == 1
    finally:
        _teardown(coord, workers)


def test_worker_killed_while_suspended_fails_nothing(tmp_path, ref_rows):
    """A worker dies while the victim is parked: on resume its committed
    producer partitions re-serve from the spool and the lost work
    reschedules (a QUERY restart as the last resort) — no query fails
    and the rows are exact. The default breaker cool-off holds: the
    restart never schedules on the dead worker."""
    coord, workers = _mk_cluster(tmp_path, policy="QUERY")
    coord.local.session.set("query_retry_count", 2)
    try:
        qa, qi = _start_victim(coord)
        workers[0]._fault_kill()
        assert qi.done.wait(60) and qi.state == "FINISHED", qi.error
        assert qa.done.wait(180) and qa.state == "FINISHED", qa.error
        assert [tuple(r) for r in qa.rows] == ref_rows[JOIN_SQL]
        assert coord.query_info(qa)["qos"]["resumes"] >= 1
    finally:
        _teardown(coord, workers)


# -------------------------------------------------- SLOs and speculation


class _Stub:
    """The coordinator surface the controller reads: resource groups, an
    optional journal, the arbiter and pool it releases a victim's memory
    from, and the shutdown flag."""

    def __init__(self, groups, journal=None):
        self.resource_groups = groups
        self.journal = journal
        self.spool = None
        self._shutting_down = False
        self.arbiter = types.SimpleNamespace(suspend_release=lambda qid: 0)
        self.memory_pool = types.SimpleNamespace(release=lambda *a: 0)


def _fake_query(Stats, qid, group, age_s):
    return types.SimpleNamespace(
        qid=qid, resource_group=group, state="RUNNING",
        done=threading.Event(), _stats_lock=threading.Lock(),
        stats=Stats(query_id=qid, sql="", create_time=time.time() - age_s),
    )


def test_speculation_scale_equals_the_reference():
    cfg = {"qos.enabled": "true", "qos.interactive.target-p99-ms": "1000"}
    ref = ref_qos_mod.QosController(
        _Stub(RefGroups(RESOURCE_GROUPS)), RefNodeConfig(cfg), 1
    )
    port = qos_mod.QosController(
        _Stub(ResourceGroupManager(RESOURCE_GROUPS)), NodeConfig(cfg), 1
    )
    for group, age_s in (("batch", 10.0), ("interactive", 0.0),
                         ("interactive", 0.25), ("interactive", 0.5),
                         ("interactive", 0.9), ("interactive", 5.0)):
        qr = _fake_query(RefQueryStats, "q_r", group, age_s)
        qp = _fake_query(QueryStats, "q_p", group, age_s)
        # the same elapsed time on both sides
        qp.stats.create_time = qr.stats.create_time
        qr.stats.end_time = qp.stats.end_time = qr.stats.create_time + age_s
        assert port.speculation_scale(qp) == ref.speculation_scale(qr)
    assert port.speculation_scale(qp) == qos_mod.SPECULATION_FLOOR
    assert [r["target_p99_ms"] for r in port.view_rows()] == [
        r["target_p99_ms"] for r in ref.view_rows()
    ]


def test_slo_miss_is_counted():
    coord = CoordinatorServer(
        config=NodeConfig({"qos.enabled": "true",
                           "qos.batch.target-p99-ms": "0.001"}),
        max_concurrent_queries=2, resource_groups=RESOURCE_GROUPS,
        device="cpu",
    )
    try:
        misses = REGISTRY.counter("qos.slo_misses").total
        q = coord.submit(LOOKUP_SQL, user="batch-1")
        assert q.done.wait(60) and q.state == "FINISHED", q.error
        (row,) = [r for r in coord.qos.view_rows() if r["group"] == "batch"]
        assert row["queries"] >= 1 and row["slo_misses"] >= 1
        assert row["p99_ms"] > 0.0
        assert REGISTRY.counter("qos.slo_misses").total > misses
    finally:
        coord.shutdown()


# ------------------------------------------------------------- journal


def _suspend_and_resume(qos, Stats, clock):
    """Drive one controller through a preemption: a batch query runs, an
    interactive one arrives and suspends it, finishes, and the batch
    query's parked thread resumes. Returns the batch query."""
    qb = _fake_query(Stats, "q_c1_aaa", "batch", 0.0)
    qi = _fake_query(Stats, "q_c2_aaa", "interactive", 0.0)
    assert qos.qos_admit(qb)
    clock.t += 1.0
    t = threading.Thread(target=qos.qos_admit, args=(qi,))
    t.start()
    _wait(lambda: qb.state == "SUSPENDED", 10, "the suspension")
    t.join(10)
    clock.t += 0.25  # suspended 250 ms
    qi.state = "FINISHED"
    qos.qos_release(qi)
    qos.qos_checkpoint(qb)  # the parked thread wakes and resumes
    assert qb.state == "RUNNING"
    qb.state = "FINISHED"
    qos.qos_release(qb)
    return qb


def test_qos_frames_are_byte_equal_and_replay_across_packages(
    tmp_path, monkeypatch
):
    clock = types.SimpleNamespace(t=1000.0)
    wall = types.SimpleNamespace(time=lambda: 1700000000.25)
    mono = types.SimpleNamespace(monotonic=lambda: clock.t)
    for mod in (ref_journal_mod, journal_mod):
        monkeypatch.setattr(mod, "time", wall)
    for mod in (ref_qos_mod, qos_mod):
        monkeypatch.setattr(mod, "time", mono)
    sides = {
        "ref": (RefJournal, ref_qos_mod.QosController, RefNodeConfig,
                RefGroups, RefQueryStats),
        "port": (CoordinatorJournal, qos_mod.QosController, NodeConfig,
                 ResourceGroupManager, QueryStats),
    }
    for pkg, (J, Qos, Config, Groups, Stats) in sides.items():
        j = J(str(tmp_path / pkg))
        j.record_submit("q_c1_aaa", JOIN_SQL, "batch-1")
        qos = Qos(_Stub(Groups(RESOURCE_GROUPS), journal=j),
                  Config({"qos.enabled": "true"}), 1)
        qb = _suspend_and_resume(qos, Stats, clock)
        assert (qb.qos_suspensions, qb.qos_resumes) == (1, 1)
        assert qb.qos_suspended_ms == 250.0
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    text = ""
    for name in names:
        ours = (tmp_path / "port" / name).read_bytes()
        assert (tmp_path / "ref" / name).read_bytes() == ours, name
        text += ours.decode()
    assert '"ev":"qos_suspend"' in text.replace(" ", "")
    assert '"ev":"qos_resume"' in text.replace(" ", "")
    # the frames are replay-inert: the parked query is still open, and
    # each package reads the other's journal to the same state
    theirs = CoordinatorJournal(str(tmp_path / "ref")).replay()
    ours = RefJournal(str(tmp_path / "port")).replay()
    assert [r["qid"] for r in theirs.open] == ["q_c1_aaa"]
    assert theirs.open == ours.open

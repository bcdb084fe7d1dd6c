"""The port's elastic worker pool on the CPU, held to the JAX reference:
the autoscaler's hysteresis and its ownership of TTL-flapped workers
(the same decisions as the reference's for the same load), live scale-up
and scale-down through ``LocalWorkerPoolProvider``, the pool states of
``system.runtime.nodes``, a preemption notice that drains a preemptible
worker and reschedules its ranges, merge stages kept on stable nodes,
the pool halved under load, and the launcher's ``pool.*`` keys.

The clusters are the port's (``device="cpu"``, one shared spool
directory); the reference's rows come from its ``LocalQueryRunner`` at
tpch.tiny.
"""

from __future__ import annotations

import threading
import time

import pytest

from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu.server.pool import Autoscaler as RefAutoscaler
from presto_tpu.server.pool import WorkerPoolProvider as RefProvider
from presto_tpu_torch.server import (
    CoordinatorServer,
    PrestoTpuClient,
    WorkerServer,
    rpc,
)
from presto_tpu_torch.server.launcher import LocalWorkerPoolProvider, load_etc
from presto_tpu_torch.server.pool import Autoscaler, WorkerPoolProvider
from presto_tpu_torch.session import NodeConfig
from presto_tpu_torch.utils import faults
from presto_tpu_torch.utils.metrics import REGISTRY
from torch_parity import one_torch_thread  # noqa: F401

#: the shuffled aggregation over a join: a producer stage and a merge
#: stage
JOIN_SQL = (
    "select o_orderpriority, count(*) as n "
    "from tpch.tiny.orders, tpch.tiny.lineitem "
    "where o_orderkey = l_orderkey "
    "group by o_orderpriority order by o_orderpriority"
)
REGION_SQL = "select count(*) as c from tpch.tiny.region"

SIDES = {
    "ref": (RefAutoscaler, RefProvider),
    "port": (Autoscaler, WorkerPoolProvider),
}


@pytest.fixture(autouse=True)
def clear_fault_plane():
    yield
    faults.configure(None)


@pytest.fixture(scope="module")
def ref_rows():
    return [tuple(r) for r in RefRunner().execute(JOIN_SQL).rows()]


def _wait(pred, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise TimeoutError(f"timed out waiting for {msg}")


def _cfg(tmp_path, extra=None):
    return NodeConfig({
        "exchange.spool-path": str(tmp_path / "spool"),
        "exchange.spool-bytes": "64MB",
        **(extra or {}),
    })


def _mk_cluster(tmp_path, n=2, policy="TASK", preemptible=()):
    coord = CoordinatorServer(config=_cfg(tmp_path), device="cpu").start()
    coord.local.session.set("retry_policy", policy)
    workers = [
        WorkerServer(
            coordinator_uri=coord.uri, config=_cfg(tmp_path),
            preemptible=(i in preemptible), device="cpu",
        ).start()
        for i in range(n)
    ]
    _wait(lambda: len(coord.active_workers()) >= n, msg="workers")
    return coord, workers


def _teardown(coord, workers):
    faults.configure(None)
    if coord.autoscaler is not None:
        coord.autoscaler.stop()
    for w in workers:
        w.shutdown(graceful=False)
    coord.shutdown()


def _view(coord):
    return {
        r[0]: r[1:] for r in coord.local.execute(
            "select node_id, preemptible, pool_state, last_decision "
            "from system.runtime.nodes"
        ).rows()
    }


# ---------------------------------------------------------- autoscaler


def _fake_provider(Base):
    class Fake(Base):
        def __init__(self):
            self.spawned, self.drained, self.dead = [], [], set()

        def spawn(self):
            nid = f"fake-{len(self.spawned)}"
            self.spawned.append(nid)
            return nid

        def drain(self, node_id):
            self.drained.append(node_id)

        def owns(self, node_id):
            return node_id not in self.dead

    return Fake()


def _decisions(pkg):
    """Each tick's decision over an oscillating then idle load."""
    Scaler, Base = SIDES[pkg]
    prov = _fake_provider(Base)
    a = Scaler(None, prov, min_workers=1, max_workers=3, interval_s=1.0,
               scale_down_ticks=3, cooldown_s=2.0)
    now, n, out = 0.0, 1, []
    for queued in [i % 2 for i in range(20)] + [0] * 30:
        now += 1.0
        out.append(a.step(queued=queued, running=0, backlog=0,
                          n_workers=n, now=now))
        n = 1 + len(prov.spawned) - len(prov.drained)
    return out, prov


def test_autoscaler_hysteresis_equals_the_reference():
    ours, prov = _decisions("port")
    theirs, _ = _decisions("ref")
    assert ours == theirs
    # oscillation ratchets up to max_workers and never flaps down
    assert len(prov.spawned) == 2
    assert not any(d.startswith("scale_down") for d in ours[:20])
    # sustained idle drains back to the floor once, then holds
    assert prov.drained == ["fake-1", "fake-0"]
    assert ours[-10:] == ["hold"] * 10


@pytest.mark.parametrize("pkg", sorted(SIDES))
def test_autoscaler_keeps_ttl_flapped_workers_owned(pkg):
    """A live worker whose announcement lapsed the discovery TTL stays
    owned; only a node its provider disowned is forgotten."""
    Scaler, Base = SIDES[pkg]

    class StubCoord:
        _pool_scaling: set = set()
        pool_decision = ""

        def load_snapshot(self):
            return {"queued": 0, "running": 0, "backlog": 0}

        def _ttl_workers(self):
            return []  # the flap: nothing announced right now

    prov = _fake_provider(Base)
    a = Scaler(StubCoord(), prov, min_workers=0, max_workers=2,
               interval_s=1.0)
    a.owned = ["fake-alive", "fake-dead"]
    prov.dead.add("fake-dead")
    a._tick()
    assert a.owned == ["fake-alive"]


def test_live_scale_up_and_down_through_the_local_provider():
    """Queue depth spawns preemptible workers through the provider;
    idle capacity drains back to the floor through the drain protocol,
    and the decision settles on hold."""
    coord = CoordinatorServer(device="cpu").start()
    prov = LocalWorkerPoolProvider(coord.uri, device="cpu")
    up0 = REGISTRY.counter("pool.scale_up").total
    down0 = REGISTRY.counter("pool.scale_down").total
    held = 0
    try:
        coord.attach_pool(prov, min_workers=1, max_workers=3,
                          interval_s=0.05, scale_down_ticks=2,
                          cooldown_s=0.1)
        _wait(lambda: len(coord.active_workers()) >= 1, msg="floor spawn")
        for _ in range(4):  # hold admission: submissions stay QUEUED
            coord._admit.acquire()
            held += 1
        qs = [coord.submit(REGION_SQL) for _ in range(4)]
        _wait(lambda: len(coord.active_workers()) >= 3, msg="scale-up")
        assert all(w.preemptible for w in coord.active_workers())
        assert REGISTRY.counter("pool.scale_up").total >= up0 + 3
        for _ in range(held):
            coord._admit.release()
        held = 0
        for q in qs:
            assert q.done.wait(60) and q.state == "FINISHED", q.error
            assert q.rows == [[5]]
        _wait(lambda: len(coord.active_workers()) <= 1, msg="scale-down")
        assert REGISTRY.counter("pool.scale_down").total >= down0 + 2
        time.sleep(0.5)
        assert coord.pool_decision == "hold"
        assert len(coord.active_workers()) == 1
    finally:
        for _ in range(held):
            coord._admit.release()
        _teardown(coord, list(prov.workers.values()))


def test_nodes_view_scaling_up_then_stable_then_draining():
    coord = CoordinatorServer(device="cpu").start()
    prov = LocalWorkerPoolProvider(coord.uri, device="cpu")
    # ticked by hand: each state is read between two ticks
    a = Autoscaler(coord, prov, min_workers=1, max_workers=1,
                   scale_down_ticks=1, cooldown_s=0.0)
    try:
        a._tick()  # below the floor: spawn
        (nid,) = prov.workers
        assert coord.pool_decision.startswith("scale_up(floor")
        _wait(lambda: nid in _view(coord), msg="the spawned node")
        view = _view(coord)
        assert view[nid][:2] == (True, "SCALING_UP")
        assert view["coordinator"][2] == coord.pool_decision
        assert view[nid][2] == ""  # the decision: coordinator row only
        a._tick()  # announced: no longer scaling up
        assert _view(coord)[nid][1] == "STABLE"
        a.min_workers = 0
        a._tick()  # idle past one tick: drain the owned worker
        assert coord.pool_decision.startswith("scale_down")
        _wait(lambda: _view(coord)[nid][1] == "DRAINING", msg="DRAINING")
        _wait(lambda: not coord.active_workers(), msg="drained out")
    finally:
        _teardown(coord, list(prov.workers.values()))


# ---------------------------------------------------- preemptible nodes


def test_preemption_notice_drains_and_reschedules(tmp_path, ref_rows):
    """kill_worker_preempt lands mid-task on the preemptible worker: it
    drains at once within its grace window, its new ranges reschedule on
    the stable node, the rows are exact and the worker exits."""
    coord, ws = _mk_cluster(tmp_path, preemptible={1})
    try:
        before = REGISTRY.counter("pool.preemptions").total
        faults.configure({"seed": 13, "rules": [
            {"action": "delay", "task": ".prod.", "delay_s": 0.05},
            {"action": "kill_worker_preempt", "node": ws[1].node_id,
             "count": 1},
        ]})
        client = PrestoTpuClient(coord.uri, timeout_s=120)
        res = client.execute(JOIN_SQL)
        assert [tuple(r) for r in res.rows()] == ref_rows
        assert REGISTRY.counter("pool.preemptions").total == before + 1
        _wait(lambda: ws[1].node_id not in {
            w.node_id for w in coord.active_workers()
        }, msg="the preempted worker left scheduling")
        _wait(lambda: ws[1]._shutting_down, msg="the preempted worker exit")
        info = client.query_info(res.query_id)
        prod = [t["node_id"] for st in info["stages"]
                if st["kind"] == "producer" for t in st["tasks"]]
        # the notice landed on a task the preempted worker finished in
        # its grace window; the ranges after it went to the stable node
        assert ws[1].node_id in prod
        assert prod.count(ws[0].node_id) > prod.count(ws[1].node_id)
        res2 = client.execute("select count(*) as c from tpch.tiny.orders")
        assert [tuple(r) for r in res2.rows()] == [(15000,)]
    finally:
        _teardown(coord, ws)


def test_merge_stage_placed_on_stable_nodes(tmp_path, ref_rows):
    coord, ws = _mk_cluster(tmp_path, preemptible={1})
    try:
        client = PrestoTpuClient(coord.uri, timeout_s=120)
        res = client.execute(JOIN_SQL)
        assert [tuple(r) for r in res.rows()] == ref_rows
        info = client.query_info(res.query_id)
        merge = [t for st in info["stages"] if st["kind"] == "merge"
                 for t in st["tasks"]]
        assert merge and {t["node_id"] for t in merge} == {ws[0].node_id}
        prod = {t["node_id"] for st in info["stages"]
                if st["kind"] == "producer" for t in st["tasks"]}
        assert ws[1].node_id in prod  # producers use the whole pool
        rows = _view(coord)
        assert rows[ws[0].node_id][0] is False
        assert rows[ws[1].node_id][0] is True
    finally:
        _teardown(coord, ws)


def test_pool_halving_under_load_fails_no_query(tmp_path, ref_rows):
    """Drain half the pool under concurrent load, then restore it: no
    query fails and every answer is exact."""
    coord, ws = _mk_cluster(tmp_path, n=4)
    spawned = []
    try:
        faults.configure({"seed": 11, "rules": [
            {"action": "delay", "task": ".prod.", "delay_s": 0.05},
        ]})
        results, errs = [], []

        def client_loop():
            client = PrestoTpuClient(coord.uri, timeout_s=120)
            for _ in range(2):
                try:
                    results.append(client.execute(JOIN_SQL).rows())
                except Exception as e:  # asserted below
                    errs.append(e)

        threads = [threading.Thread(target=client_loop) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        for w in ws[:2]:
            rpc.call_json("PUT", w.uri + "/v1/state/drain")
        time.sleep(0.5)
        spawned = [
            WorkerServer(coordinator_uri=coord.uri, config=_cfg(tmp_path),
                         device="cpu").start()
            for _ in range(2)
        ]
        for t in threads:
            t.join(180)
        assert not errs, f"halving the pool lost queries: {errs}"
        assert len(results) == 6
        assert all([tuple(r) for r in rows] == ref_rows for rows in results)
        gone = {w.node_id for w in ws[:2]}
        _wait(lambda: len(coord.active_workers()) == 4 and not gone & {
            w.node_id for w in coord.active_workers()
        }, msg="the pool recovered")
    finally:
        _teardown(coord, ws + spawned)


def test_launcher_parses_the_pool_config(tmp_path):
    etc = tmp_path / "etc"
    (etc / "catalog").mkdir(parents=True)
    (etc / "config.properties").write_text(
        "coordinator=true\n"
        "pool.min-workers=1\n"
        "pool.max-workers=8\n"
        "pool.scale-interval-s=0.5\n"
        "pool.scale-down-ticks=4\n"
        "pool.cooldown-s=2\n"
        "pool.preempt-grace-s=5\n"
        "node.preemptible=true\n"
    )
    (etc / "catalog" / "tpch.properties").write_text("connector.name=tpch\n")
    config, _ = load_etc(str(etc))
    assert config.get("pool.min-workers") == 1
    assert config.get("pool.max-workers") == 8
    assert config.get("pool.scale-interval-s") == 0.5
    assert config.get("pool.scale-down-ticks") == 4
    assert config.get("pool.preempt-grace-s") == 5.0
    assert config.get("node.preemptible") is True
    coord = CoordinatorServer(config=config, device="cpu")
    try:
        assert coord._pool_cfg == {
            "min_workers": 1, "max_workers": 8, "interval_s": 0.5,
            "scale_down_ticks": 4, "cooldown_s": 2.0,
        }
    finally:
        coord.shutdown()

"""The port's lease plane and coordinator failover on the CPU, held to
the JAX reference: lease renewal and expiry, exactly one claim winner,
stale-claim supersede and fencing, monotonic epochs, a stop that
withdraws the lease (each on both packages' ``LeasePlane``, and across
them on one directory), then coordinators sharing a control directory:
failover of a dead peer's queued queries, ``kill_coordinator`` chaos
under sprayed load with zero failed queries, a statement URI that
survives two failovers, the shared resource-group quota, peers that are
never schedulable, and no lease plane without peers. Resumed queries'
rows are held to the reference's sqlite oracle at tpch.tiny.

The lease units run on a fake clock (expiry is wall-clock); the
coordinator cases use short TTLs and wait on conditions.
"""

from __future__ import annotations

import socket
import threading
import time

import pytest

from presto_tpu.server import lease as ref_lease_mod
from presto_tpu.verifier import SqliteOracle
from presto_tpu_torch.server import (
    CoordinatorServer,
    PrestoTpuClient,
    WorkerServer,
)
from presto_tpu_torch.server import lease as lease_mod
from presto_tpu_torch.server.coordinator import _Query
from presto_tpu_torch.session import NodeConfig
from presto_tpu_torch.utils import faults
from presto_tpu_torch.utils.metrics import REGISTRY
from torch_parity import one_torch_thread  # noqa: F401

REGION_SQL = "select count(*) as c from tpch.tiny.region"
LEASES = {"ref": ref_lease_mod, "port": lease_mod}


@pytest.fixture(autouse=True)
def clear_fault_plane():
    yield
    faults.configure(None)


@pytest.fixture(scope="module")
def oracle():
    return SqliteOracle("tiny")


@pytest.fixture
def clock(monkeypatch):
    """One fake wall clock for both packages' lease modules."""

    class Clock:
        now = 1700000000.0

        def time(self):
            return self.now

        def advance(self, s):
            self.now += s

    c = Clock()
    for mod in LEASES.values():
        monkeypatch.setattr(mod, "time", c)
    return c


def _wait(pred, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise TimeoutError(f"timed out waiting for {msg}")


# ------------------------------------------------------------ lease units


@pytest.mark.parametrize("pkg", sorted(LEASES))
def test_lease_renew_peers_and_expiry(pkg, tmp_path, clock):
    P = LEASES[pkg].LeasePlane
    d = str(tmp_path / "ctl")
    a = P(d, "c-a", uri="http://a", ttl_s=0.3)
    b = P(d, "c-b", uri="http://b", ttl_s=0.3)
    a.renew({"qids": ["q_c1_aaaaaa"]})
    b.renew()
    (pa,) = b.peers()
    assert pa.owner == "c-a" and pa.uri == "http://a"
    assert pa.state == {"qids": ["q_c1_aaaaaa"]}
    assert [p.owner for p in a.peers()] == ["c-b"]
    assert not a.is_expired(b.read_lease("c-b"))
    clock.advance(0.4)  # both leases age past the TTL
    assert a.peers(live_only=True) == []
    assert a.is_expired(a.read_lease("c-b"))
    b.renew()  # a heartbeat revives the lease
    assert [p.owner for p in a.peers(live_only=True)] == ["c-b"]


@pytest.mark.parametrize("pkg", sorted(LEASES))
def test_lease_claim_has_exactly_one_winner(pkg, tmp_path, clock):
    mod = LEASES[pkg]
    d = str(tmp_path / "ctl")
    dead = mod.LeasePlane(d, "c-dead", ttl_s=0.2)
    dead.renew()
    a = mod.LeasePlane(d, "c-a", ttl_s=0.2)
    b = mod.LeasePlane(d, "c-b", ttl_s=0.2)
    a.renew()
    assert b.claim_expired("c-a") is None  # a live owner
    assert b.claim_expired("c-ghost") is None  # no lease at all
    clock.advance(0.3)
    a.renew()
    b.renew()
    # claimants race from threads: O_EXCL picks one
    claims = [None] * 8
    planes = [a, b] * 4

    def claim(i):
        claims[i] = planes[i].claim_expired("c-dead")

    threads = [threading.Thread(target=claim, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    won = [c for c in claims if c is not None]
    assert len(won) == 1
    (cw,) = won
    assert cw.epoch == dead.epoch + 1  # strictly above the dead lease
    winner = a if cw.claimant == "c-a" else b
    loser = b if winner is a else a
    winner.check_fence(cw)
    with pytest.raises(mod.FencedError):
        loser.check_fence(
            mod.Lease(owner="c-dead", claimant=loser.owner, epoch=cw.epoch)
        )
    winner.retire("c-dead")  # both files gone: nothing to claim or fence
    assert winner.read_lease("c-dead") is None
    assert loser.claim_expired("c-dead") is None
    with pytest.raises(mod.FencedError):
        winner.check_fence(cw)


@pytest.mark.parametrize("pkg", sorted(LEASES))
def test_stale_claim_is_superseded_and_fenced(pkg, tmp_path, clock):
    mod = LEASES[pkg]
    d = str(tmp_path / "ctl")
    mod.LeasePlane(d, "c-dead", ttl_s=0.2).renew()
    a = mod.LeasePlane(d, "c-a", ttl_s=0.2)
    b = mod.LeasePlane(d, "c-b", ttl_s=0.2)
    clock.advance(0.3)
    a.renew()
    ca = a.claim_expired("c-dead")
    assert ca is not None
    clock.advance(0.3)  # the claimant goes silent: its claim is stale
    b.renew()
    cb = b.claim_expired("c-dead")
    assert cb is not None and cb.claimant == "c-b"
    assert cb.epoch > ca.epoch
    with pytest.raises(mod.FencedError):
        a.check_fence(ca)  # the stalled claimant may write nothing
    b.check_fence(cb)


@pytest.mark.parametrize("pkg", sorted(LEASES))
def test_lease_epochs_are_monotonic_across_restarts(pkg, tmp_path, clock):
    P = LEASES[pkg].LeasePlane
    d = str(tmp_path / "ctl")
    p1 = P(d, "c-x", ttl_s=0.2)
    assert p1.epoch == 1
    p1.renew()
    p2 = P(d, "c-x", ttl_s=0.2)  # a restart rejoins above
    assert p2.epoch == 2
    p2.renew()
    clock.advance(0.3)
    y = P(d, "c-y", ttl_s=0.2)
    y.renew()
    cy = y.claim_expired("c-x")
    assert cy is not None and cy.epoch == 3
    assert P(d, "c-x", ttl_s=0.2).epoch == 4  # above the claim too


@pytest.mark.parametrize("pkg", sorted(LEASES))
def test_stop_withdraws_the_lease(pkg, tmp_path, clock):
    P = LEASES[pkg].LeasePlane
    d = str(tmp_path / "ctl")
    a, b = P(d, "c-a", ttl_s=0.2), P(d, "c-b", ttl_s=0.2)
    a.renew()
    b.renew()
    a.stop()  # clean shutdown: the file is gone, not expiring
    assert b.read_lease("c-a") is None
    clock.advance(0.3)
    assert b.claim_expired("c-a") is None


def test_each_package_reads_and_claims_the_others_leases(tmp_path, clock):
    d = str(tmp_path / "ctl")
    ref = ref_lease_mod.LeasePlane(d, "c-ref", uri="http://r", ttl_s=0.2)
    port = lease_mod.LeasePlane(d, "c-port", uri="http://p", ttl_s=0.2)
    ref.renew({"qids": ["q_c1_aaaaaa"]})
    port.renew({"qids": ["q_c2_bbbbbb"]})
    (rp,) = port.peers(live_only=True)
    (pp,) = ref.peers(live_only=True)
    assert (rp.owner, rp.uri, rp.state) == (
        "c-ref", "http://r", {"qids": ["q_c1_aaaaaa"]},
    )
    assert (pp.owner, pp.uri, pp.state) == (
        "c-port", "http://p", {"qids": ["q_c2_bbbbbb"]},
    )
    clock.advance(0.3)
    port.renew()
    claim = port.claim_expired("c-ref")  # the port claims a reference lease
    assert claim is not None and claim.epoch == ref.epoch + 1
    port.check_fence(claim)
    # the reference reads the port's claim file: the fence holds there
    ref_lease_mod.LeasePlane(d, "c-port", ttl_s=0.2).check_fence(claim)


# ------------------------------------------------ coordinators with peers


def _free_ports(n):
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _mk_coords(tmp_path, n=2, ttl=0.75, start=True, **coord_kwargs):
    """N coordinators sharing one control directory (lease files and
    one journal directory each), each naming the others as peers."""
    ctl = str(tmp_path / "ctl")
    ports = _free_ports(n)
    uris = [f"http://127.0.0.1:{p}" for p in ports]
    coords = []
    for i in range(n):
        cfg = NodeConfig({
            "node.id": f"coord-{i}",
            "coordinator.journal-path": ctl,
            "coordinator.peers": ",".join(
                u for j, u in enumerate(uris) if j != i
            ),
            "lease.ttl-s": str(ttl),
        })
        c = CoordinatorServer(
            port=ports[i], config=cfg, device="cpu", **coord_kwargs
        )
        if start:
            c.start()
        coords.append(c)
    return coords


def _teardown(coords, workers=()):
    faults.configure(None)
    for w in workers:
        w.shutdown(graceful=False)
    for c in coords:
        c.shutdown()


def test_failover_resumes_a_dead_peers_queued_queries(tmp_path, oracle):
    """A survivor claims an expired peer's journal and resumes its open
    queries under new ids, with the old ids aliased. It waits on the
    resumed count: the claim counter moves before the resume runs
    (``_scan_expired_peers`` counts the claim, then calls
    ``_failover_from``), so asserting the resumed count on the claim is
    the race that makes the reference's
    ``test_failover_resumes_dead_peers_queued_queries`` flaky."""
    c0, c1 = _mk_coords(tmp_path, n=2, ttl=0.6, max_concurrent_queries=1)
    try:
        c0._admit.acquire()  # c0's submissions stay QUEUED
        qs = [c0.submit(REGION_SQL) for _ in range(2)]
        assert all(q.state == "QUEUED" for q in qs)
        claims_before = REGISTRY.counter("coordinator.failover_claims").total
        # the counters as the failover starts: the claim is counted, no
        # query is resumed yet
        at_failover = []
        failover_from = c1._failover_from

        def record(owner, claim):
            at_failover.append((c1.failover_claims, c1.failover_resumed))
            return failover_from(owner, claim)

        c1._failover_from = record
        c0._fault_kill()  # abrupt: the lease EXPIRES, the journal stays open
        _wait(lambda: c1.failover_resumed == 2, msg="both queries resumed")
        assert at_failover == [(1, 0)]
        assert c1.failover_claims == 1
        assert (
            REGISTRY.counter("coordinator.failover_claims").total
            == claims_before + 1
        )
        want = [list(r) for r in oracle.execute(REGION_SQL)]
        for q in qs:
            rq = c1.lookup_query(q.qid)  # a dead-boot qid -> the resumed run
            assert rq is not None and rq.qid != q.qid
            assert rq.done.wait(60)
            assert rq.state == "FINISHED", rq.error
            assert rq.rows == want
        # fully failed over: the dead lease and claim are retired
        assert c1.lease.read_lease("coord-0") is None
        assert c1.failover_claims == 1
    finally:
        _teardown([c0, c1])


def test_kill_coordinator_chaos_fails_no_query(tmp_path, oracle):
    """Three coordinators under sprayed load; the fault plane kills one
    mid-query. Every query answers with exact rows, one survivor claims
    the dead journal and resumes the interrupted query."""
    coords = _mk_coords(tmp_path, n=3, ttl=0.75)
    try:
        uris = [c.uri for c in coords]
        faults.configure({"rules": [
            {"action": "kill_coordinator", "node": "coord-0", "count": 1},
        ]})
        results, errors = [], []

        def run_queries():
            cl = PrestoTpuClient(uris, timeout_s=90, reconnect_attempts=16)
            try:
                for _ in range(3):
                    results.append(cl.execute(REGION_SQL).rows())
            except Exception as e:  # noqa: BLE001 - the assertion
                errors.append(e)

        threads = [
            threading.Thread(target=run_queries, daemon=True)
            for _ in range(3)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "load hung"
        assert errors == [], errors
        assert results == [oracle.execute(REGION_SQL)] * 9
        assert coords[0]._shutting_down, "the kill never fired"
        survivors = coords[1:]
        _wait(
            lambda: sum(c.failover_claims for c in survivors) == 1,
            msg="a survivor claims coord-0's journal",
        )
        _wait(
            lambda: sum(c.failover_resumed for c in survivors) >= 1,
            msg="the claimant resumes the interrupted query",
        )
    finally:
        _teardown(coords)


def test_statement_uri_survives_two_failovers(tmp_path, oracle):
    """A statement URI minted by coordinator 0 still resolves after its
    query failed over twice (coord-0 dies, then its claimant)."""
    coords = _mk_coords(tmp_path, n=3, ttl=0.6, max_concurrent_queries=1)
    c0, c1, c2 = coords
    try:
        # the survivors' one admission slot is held, so each resumed
        # run stays open in its claimant's journal until released
        c1._admit.acquire()
        c2._admit.acquire()
        faults.configure({"rules": [
            {"action": "kill_coordinator", "node": "coord-0", "count": 1},
        ]})
        out, errors = [], []

        def run_query():
            cl = PrestoTpuClient(
                [c0.uri, c1.uri, c2.uri], timeout_s=120,
                reconnect_attempts=40,
            )
            try:
                out.append(cl.execute(REGION_SQL))
            except Exception as e:  # noqa: BLE001 - the assertion
                errors.append(e)

        t = threading.Thread(target=run_query, daemon=True)
        t.start()  # round robin starts at c0: the kill rule fires
        _wait(
            lambda: c1.failover_resumed + c2.failover_resumed == 1,
            msg="first failover resumed",
        )
        s1, s2 = (c1, c2) if c1.failover_resumed else (c2, c1)
        s1._fault_kill()  # the claimant dies as well
        _wait(lambda: s2.failover_resumed >= 1, msg="second failover")
        s2._admit.release()  # the twice-resumed run executes
        t.join(timeout=120)
        assert not t.is_alive(), "client never completed"
        assert errors == [], errors
        (res,) = out
        assert res.rows() == oracle.execute(REGION_SQL)
        q = s2.lookup_query(res.query_id)  # the coord-0 id, two hops on
        assert q is not None, "boot-1 qid lost after two failovers"
        assert q.state == "FINISHED", q.error
    finally:
        _teardown(coords)


def _fake_query(coord, qid, group=None):
    q = _Query(qid, "select 1")
    q.state = "RUNNING"
    q.resource_group = group
    coord.queries[qid] = q
    return q


def test_shared_group_quota_trips_across_admitters(tmp_path):
    """A worker-side hog admitted via coordinator A counts against the
    resource-group quota coordinator B enforces."""
    rg = {"rootGroups": [
        {"name": "etl", "hardConcurrencyLimit": 4, "softMemoryLimit": "1KB"},
    ]}
    ca, cb = _mk_coords(tmp_path, n=2, start=False, resource_groups=dict(rg))
    try:
        _fake_query(ca, "q_c1_abcdef", group="etl")
        rep = {
            "limit": 1 << 20, "reserved": 4096, "blocked": [],
            "queries": {"q_c1_abcdef": {"bytes": 4096, "peak": 4096}},
        }
        # the worker heartbeats every coordinator
        ca.arbiter.observe("w1", rep)
        cb.arbiter.observe("w1", rep)
        assert cb._group_memory("etl") == 0  # A has not published yet
        ca.lease.renew(ca._lease_state())
        assert cb._group_memory("etl") == 4096
        assert cb.resource_groups._over_memory(
            cb.resource_groups.groups["etl"]
        ) is True
        assert "coord:coord-0" in cb.arbiter._view()
        assert cb.locate_peer("q_c1_abcdef") == ca.uri
        assert cb.locate_peer("q_c9_zzzzzz") == ""
    finally:
        _teardown([ca, cb])


def test_peer_coordinators_are_never_schedulable(tmp_path):
    c0, c1 = _mk_coords(tmp_path, n=2, ttl=0.75)
    w = WorkerServer(coordinator_uri=[c0.uri, c1.uri], device="cpu").start()
    try:
        _wait(
            lambda: "coord-1" in c0.workers and "coord-0" in c1.workers,
            msg="peer coordinator announcements",
        )
        _wait(
            lambda: w.node_id in c0.workers and w.node_id in c1.workers,
            msg="the worker announced to both coordinators",
        )
        by_id = dict(c0.local.execute(
            "select node_id, coordinator from system.runtime.nodes"
        ).rows())
        assert by_id["coord-1"] is True
        assert by_id[w.node_id] is False
        for c in (c0, c1):
            sched = [x.node_id for x in c.active_workers()]
            assert w.node_id in sched
            assert not any(n.startswith("coord-") for n in sched)
    finally:
        _teardown([c0, c1], [w])


def test_no_peers_means_no_lease_plane(tmp_path):
    jp = str(tmp_path / "jr")
    c = CoordinatorServer(
        config=NodeConfig({"coordinator.journal-path": jp}), device="cpu"
    )
    try:
        assert c.lease is None
        assert c.journal is not None and c.journal.path == jp
        assert c.locate_peer("q_c1_aaaaaa") == ""
    finally:
        c.shutdown()
    # peers without a journal path: nothing to share through
    c2 = CoordinatorServer(
        config=NodeConfig({"coordinator.peers": "http://127.0.0.1:9"}),
        device="cpu",
    )
    try:
        assert c2.lease is None and c2.journal is None
    finally:
        c2.shutdown()

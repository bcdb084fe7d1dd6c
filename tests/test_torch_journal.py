"""The port's coordinator journal on the CPU, held to the JAX reference:
the crc-framed JSONL segments (the same frames byte for byte for the
same records, each package replaying the other's journal), torn and
corrupt lines, checkpoint compaction, and the coordinator's restart
recovery — a bounce that resumes queued queries, statement ids that
survive two bounces, the prepared registry, re-admission past the queue
cap and a paginating client that rides the bounce. Resumed queries'
rows are held to the reference's sqlite oracle at tpch.tiny.
"""

from __future__ import annotations

import threading
import time
import types

import pytest

from presto_tpu.server import journal as ref_journal_mod
from presto_tpu.server.journal import CoordinatorJournal as RefJournal
from presto_tpu.utils.metrics import REGISTRY as REF_REGISTRY
from presto_tpu.verifier import SqliteOracle
from presto_tpu_torch.server import CoordinatorServer, PrestoTpuClient
from presto_tpu_torch.server import journal as journal_mod
from presto_tpu_torch.server.journal import CoordinatorJournal
from presto_tpu_torch.session import NodeConfig
from presto_tpu_torch.utils import faults
from presto_tpu_torch.utils.metrics import REGISTRY
from torch_parity import one_torch_thread  # noqa: F401

REGION_SQL = "select count(*) as c from tpch.tiny.region"
NATION_SQL = "select count(*) as c from tpch.tiny.nation"

JOURNALS = {"ref": RefJournal, "port": CoordinatorJournal}
REGISTRIES = {"ref": REF_REGISTRY, "port": REGISTRY}


@pytest.fixture(autouse=True)
def clear_fault_plane():
    yield
    faults.configure(None)


@pytest.fixture(scope="module")
def oracle():
    return SqliteOracle("tiny")


def _oracle_rows(oracle, sql):
    return [list(r) for r in oracle.execute(sql)]


def _wait(pred, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise TimeoutError(f"timed out waiting for {msg}")


def _coord(cfg, **kw):
    return CoordinatorServer(config=cfg, device="cpu", **kw)


def _write_records(j):
    """One journal's worth of every frame kind the coordinator writes."""
    j.record_submit("q_c1_aaa", "select 1", "alice", {"p": "select ?"})
    j.record_submit("q_c2_aaa", "select 2", "bob", None, "etl")
    j.record_prepare("s1", "select c from t where x = ?")
    j.record_finish("q_c1_aaa", "FINISHED")
    j.record_finish("q_c2_aaa", "RESUMED", resumed_as="q_c1_bbb")
    j.record_submit("q_c1_bbb", "select 2", "bob")
    j.record_kill("q_c1_bbb", "total-reservation", "over", 4096)
    j.record_alias("q_c9_ddd", "q_c1_bbb")
    j.record_claim("coord-7", 5)
    j.record_deallocate("nope")  # unknown name: replays as a no-op


# ------------------------------------------------------------ journal unit


@pytest.mark.parametrize("pkg", sorted(JOURNALS))
def test_journal_round_trip_and_replay(pkg, tmp_path):
    J = JOURNALS[pkg]
    j = J(str(tmp_path / "j"))
    _write_records(j)
    state = J(str(tmp_path / "j")).replay()
    assert [r["qid"] for r in state.open] == ["q_c1_bbb"]
    assert state.open[0]["sql"] == "select 2"
    assert state.open[0]["user"] == "bob"
    assert state.prepared == {"s1": "select c from t where x = ?"}
    assert state.aliases == {
        "q_c2_aaa": "q_c1_bbb", "q_c9_ddd": "q_c1_bbb",
    }
    assert state.claim == {"claimant": "coord-7", "epoch": 5}
    j.record_finish("q_c1_bbb", "FINISHED")
    state = J(str(tmp_path / "j")).replay()
    assert state.open == [] and state.aliases == {}


def test_a_failed_append_never_fails_admission(tmp_path):
    """An injected write error loses that frame only: the journal
    degrades to best effort, and every frame that landed replays."""
    j = CoordinatorJournal(str(tmp_path / "j"))
    faults.configure(
        {"rules": [{"action": "io_error", "path": "journal-", "op": "write"}]}
    )
    j.record_submit("q_c3_aaa", "select 3")
    faults.configure(None)
    assert CoordinatorJournal(str(tmp_path / "j")).replay().open == []
    j.record_submit("q_c4_aaa", "select 4")
    assert [
        r["qid"] for r in CoordinatorJournal(str(tmp_path / "j")).replay().open
    ] == ["q_c4_aaa"]


@pytest.mark.parametrize("pkg", sorted(JOURNALS))
def test_torn_and_corrupt_lines_are_skipped(pkg, tmp_path):
    J, path = JOURNALS[pkg], tmp_path / "j"
    j = J(str(path))
    j.record_submit("q_c1_aaa", "select 1")
    j.record_submit("q_c2_aaa", "select 2")
    seg = sorted(path.glob("journal-*.jsonl"))[-1]
    raw = seg.read_text().splitlines()
    flipped = raw[1][:12] + ("X" if raw[1][12] != "X" else "Y") + raw[1][13:]
    seg.write_text(
        "\n".join([raw[0], flipped, "not a frame", raw[1][: len(raw[1]) // 2]])
        + "\n"
    )
    corrupt = REGISTRIES[pkg].counter("journal.corrupt_lines")
    before = corrupt.total
    state = J(str(path)).replay()
    assert [r["qid"] for r in state.open] == ["q_c1_aaa"]
    assert corrupt.total == before + 3


@pytest.mark.parametrize("pkg", sorted(JOURNALS))
def test_checkpoint_compaction_bounds_the_segments(pkg, tmp_path):
    J, path = JOURNALS[pkg], tmp_path / "j"
    j = J(str(path), segment_lines=4)
    j.record_submit("q_keep", "select 'keep'")
    for i in range(40):
        j.record_submit(f"q_{i}", f"select {i}")
        j.record_finish(f"q_{i}")
    segs = sorted(path.glob("journal-*.jsonl"))
    assert len(segs) <= 2, [s.name for s in segs]
    # the long-lived open query survives its submit frame's segment
    assert [r["qid"] for r in J(str(path)).replay().open] == ["q_keep"]


def test_frames_are_byte_equal_and_replay_across_packages(
    tmp_path, monkeypatch
):
    clock = types.SimpleNamespace(time=lambda: 1700000000.25)
    monkeypatch.setattr(ref_journal_mod, "time", clock)
    monkeypatch.setattr(journal_mod, "time", clock)
    dirs = {pkg: tmp_path / pkg for pkg in JOURNALS}
    for pkg, J in JOURNALS.items():
        # small segments: rotation and its checkpoint frame are covered
        _write_records(J(str(dirs[pkg]), segment_lines=4))
    names = sorted(p.name for p in dirs["ref"].iterdir())
    assert names == sorted(p.name for p in dirs["port"].iterdir())
    assert len(names) == 2
    for name in names:
        assert (dirs["ref"] / name).read_bytes() == (
            dirs["port"] / name
        ).read_bytes(), name
    # each package replays the other's directory to the same state
    theirs = CoordinatorJournal(str(dirs["ref"])).replay()
    ours = RefJournal(str(dirs["port"])).replay()
    for a, b in ((theirs, ours), (theirs, RefJournal(str(dirs["ref"])).replay())):
        assert a.open == b.open
        assert a.prepared == b.prepared
        assert a.aliases == b.aliases
        assert a.claim == b.claim


# -------------------------------------------------- coordinator restarts


def test_restart_resumes_queued_queries(tmp_path, oracle):
    """A coordinator bounces with three queries QUEUED; the restarted
    one (same journal, same port) resumes them before serving, and the
    old statement ids resolve through the restart alias."""
    cfg = NodeConfig({"coordinator.journal-path": str(tmp_path / "jr")})
    c1 = _coord(cfg).start()
    for _ in range(4):
        c1._admit.acquire()  # every admission slot held: QUEUED
    qs = [c1.submit(REGION_SQL) for _ in range(3)]
    assert all(q.state == "QUEUED" for q in qs)
    port = c1.port
    before = REGISTRY.counter("coordinator.resumed_queries").total
    c1.shutdown()
    c2 = CoordinatorServer(port=port, config=cfg, device="cpu").start()
    try:
        assert c2.resumed_queries == 3
        assert (
            REGISTRY.counter("coordinator.resumed_queries").total
            == before + 3
        )
        for q in qs:
            rq = c2.lookup_query(q.qid)
            assert rq is not None and rq.qid != q.qid
            assert rq.resumed_from == q.qid
            assert rq.done.wait(60)
            assert rq.state == "FINISHED", rq.error
            assert rq.rows == _oracle_rows(oracle, REGION_SQL)
        # every resumed query finished: a third boot resumes nothing
        c3 = _coord(cfg).start()
        assert c3.resumed_queries == 0
        c3.shutdown()
    finally:
        c2.shutdown()


def test_statement_ids_survive_a_second_bounce(tmp_path, oracle):
    cfg = NodeConfig({"coordinator.journal-path": str(tmp_path / "jr")})
    c1 = _coord(cfg).start()
    for _ in range(4):
        c1._admit.acquire()
    q = c1.submit(REGION_SQL)
    port = c1.port
    c1.shutdown()
    # boot 2 resumes the query but holds ITS admission too, so the
    # resumed run is still open when boot 2 goes down
    c2 = CoordinatorServer(port=port, config=cfg, device="cpu")
    for _ in range(4):
        c2._admit.acquire()
    c2.start()
    assert c2.resumed_queries == 1
    assert c2.lookup_query(q.qid) is not None
    c2.shutdown()
    c3 = CoordinatorServer(port=port, config=cfg, device="cpu").start()
    try:
        assert c3.resumed_queries == 1
        q3 = c3.lookup_query(q.qid)  # the boot-1 id, two bounces later
        assert q3 is not None, "boot-1 qid lost after the second bounce"
        assert q3.done.wait(60)
        assert q3.state == "FINISHED", q3.error
        assert q3.rows == _oracle_rows(oracle, REGION_SQL)
    finally:
        c3.shutdown()


@pytest.mark.parametrize("writer", sorted(JOURNALS))
def test_readmission_passes_the_queue_cap(writer, tmp_path, oracle):
    """Replayed queries were admitted once already: recovery re-admits
    all of them even past ``max_queued_queries`` — from a journal either
    package wrote."""
    jdir = tmp_path / "jr"
    j = JOURNALS[writer](str(jdir))
    for i in range(3):
        j.record_submit(f"q_c{i}_dead", REGION_SQL)
    c = _coord(
        NodeConfig({"coordinator.journal-path": str(jdir)}),
        max_queued_queries=2,
    ).start()
    try:
        assert c.resumed_queries == 3
        for i in range(3):
            rq = c.lookup_query(f"q_c{i}_dead")
            assert rq is not None
            assert rq.done.wait(60)
            assert rq.state == "FINISHED", rq.error
            assert rq.rows == _oracle_rows(oracle, REGION_SQL)
    finally:
        c.shutdown()


def test_prepared_registry_survives_a_bounce(tmp_path, oracle):
    cfg = NodeConfig({"coordinator.journal-path": str(tmp_path / "jr")})
    c1 = _coord(cfg).start()
    q = c1.submit("prepare pj from " + REGION_SQL)
    assert q.done.wait(60) and q.state == "FINISHED", q.error
    c1.shutdown()
    c2 = _coord(cfg).start()
    try:
        # no prepared headers: the coordinator's registry itself survived
        q2 = c2.submit("execute pj")
        assert q2.done.wait(60)
        assert q2.state == "FINISHED", q2.error
        assert q2.rows == _oracle_rows(oracle, REGION_SQL)
    finally:
        c2.shutdown()


def test_client_rides_a_bounce(tmp_path, oracle):
    """A paginating client rides the bounce on its reconnect path and
    gets the resumed query's rows. The bounce waits until the client
    holds its statement id (its first page request): a shutdown that
    lands between ``submit`` and the statement handler's after-submit
    check answers the POST with 503, and a one-coordinator client
    cannot re-target — the race that makes the reference's
    ``test_client_reconnects_across_coordinator_bounce`` flaky, which
    waits only for the query to be QUEUED."""
    cfg = NodeConfig({"coordinator.journal-path": str(tmp_path / "jr")})
    c1 = _coord(cfg).start()
    for _ in range(4):
        c1._admit.acquire()  # the query stays QUEUED across the bounce
    port = c1.port
    client = PrestoTpuClient(
        f"http://127.0.0.1:{port}", timeout_s=90, reconnect_attempts=40
    )
    acked = threading.Event()
    get_page = client._get_with_reconnect

    def first_get(url, deadline):
        acked.set()
        return get_page(url, deadline)

    client._get_with_reconnect = first_get
    out, errs = {}, []

    def run():
        try:
            out["res"] = client.execute(NATION_SQL)
        except Exception as e:
            errs.append(e)

    t = threading.Thread(target=run)
    t.start()
    assert acked.wait(30), "the client never got its statement id"
    reconnects = REGISTRY.counter("client.reconnects").total
    c1.shutdown()
    _wait(
        lambda: REGISTRY.counter("client.reconnects").total > reconnects,
        msg="the client entered its reconnect path",
    )
    c2 = CoordinatorServer(port=port, config=cfg, device="cpu").start()
    try:
        t.join(90)
        assert not errs, f"client died across the bounce: {errs}"
        assert [list(r) for r in out["res"].rows()] == _oracle_rows(
            oracle, NATION_SQL
        )
        assert c2.resumed_queries == 1
    finally:
        c2.shutdown()


def test_launcher_parses_the_journal_config(tmp_path):
    from presto_tpu.server.launcher import load_etc as ref_load_etc
    from presto_tpu_torch.server import launcher

    etc = tmp_path / "etc"
    (etc / "catalog").mkdir(parents=True)
    (etc / "config.properties").write_text(
        "coordinator=true\n"
        f"coordinator.journal-path={tmp_path}/journal\n"
    )
    (etc / "catalog" / "tpch.properties").write_text("connector.name=tpch\n")
    config, _ = launcher.load_etc(str(etc))
    assert config.get("coordinator.journal-path") == (
        ref_load_etc(str(etc))[0].get("coordinator.journal-path")
    ) == f"{tmp_path}/journal"
    coord = launcher.launch(str(etc), device="cpu")
    try:
        assert coord.journal is not None
        assert coord.journal.path == f"{tmp_path}/journal"
        assert coord.lease is None
    finally:
        coord.shutdown()

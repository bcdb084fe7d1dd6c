"""The lakehouse (``server/manifests.py`` and the ingest lane's durable
tee) in both packages. The cases of the reference's
``tests/test_lakehouse.py`` run once through ``presto_tpu`` (``[ref]``)
and once through ``presto_tpu_torch`` (``[port]``, on the CPU): the
``package`` fixture binds the names that file imports
(``torch_packages.bind``). Then stores across the packages: a store, and
an ingest lane's WAL and lakehouse directories, written by one package
read and restart in the other, and the same commits give byte-equal
manifests, data files and pointers.

The reference's cases: durable lakehouse snapshots (server/manifests.py + the ingest
lane's durable publish).

Covers the PR's acceptance contracts: kill-mid-commit chaos at every
publish point (data file, manifest, ``_current`` pointer, WAL commit
frame) with post-restart reads equal to the pre-kill committed state
and the acked WAL tail replayed exactly once; torn/corrupt-manifest
rollback to the parent snapshot; ``FOR VERSION AS OF`` time travel
bit-equal to what was committed — including across restart and after
compaction; compaction under concurrently pinned readers; injected
``io_error`` on all three write sites degrading to a clean commit
retry; orphan-file GC past the TTL; fsync-before-ack ordering in the
ingest WAL; and ``lakehouse.path`` unset staying bit-exact legacy
(no manifests, no new threads).
"""

import datetime
import decimal
import os
import threading
import time
from types import SimpleNamespace

import pytest

from torch_packages import (  # noqa: E402
    PACKAGES,
    assert_rows_equal,
    bind,
    module,
    split_ranges,
)


@pytest.fixture(scope="module", params=PACKAGES)
def package(request):
    """Each case once per package: the names the reference's file
    imports, bound to that package's objects."""
    bind(globals(), request.param)
    globals()["EV"] = TableHandle("mem", "default", "ev")
    return request.param


TK = ("mem", "default", "ev")


def fresh_runner():
    """A runner with a FRESH memory connector (the crash-simulation
    primitive: a new connector is an empty volatile store)."""
    catalogs = CatalogManager()
    mem = create_connector("memory")
    catalogs.register("mem", mem)
    return LocalQueryRunner(catalogs=catalogs), mem


def make_ev(mem):
    mem.create_table(EV, {"k": T.BIGINT, "v": T.DOUBLE})


def count(runner):
    return runner.execute("select count(*) from mem.default.ev").rows()[0][0]


def keys(runner, sql="select k from mem.default.ev order by k"):
    return [r[0] for r in runner.execute(sql).rows()]


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    for pkg in PACKAGES:
        module(pkg, "utils.faults").configure(None)


# --------------------------------------------------- commit + chain


def test_commit_builds_manifest_chain(package, tmp_path):
    runner, mem = fresh_runner()
    make_ev(mem)
    ing = IngestManager(
        runner, str(tmp_path / "wal"), start_thread=False,
        lakehouse_path=str(tmp_path / "lake"),
    )
    ing.append("mem.default.ev", columns={"k": [1, 2], "v": [1.0, 2.0]})
    ing.flush()
    ing.append("mem.default.ev", columns={"k": [3], "v": [3.0]})
    ing.flush()
    sids = ing.store.sids(TK)
    assert sids == sorted(sids) and len(sids) == 2
    # the chain is parent-linked back from the tip
    tip = ing.store.manifest(TK)
    assert tip.parent == sids[0]
    assert tip.row_count == 3
    # manifest contents round-trip bit-equal
    vals = ing.store.read_values(TK)
    assert vals["k"] == [1, 2, 3]
    assert vals["v"] == [1.0, 2.0, 3.0]
    ing.close(final_flush=False)


# ------------------------------------------- kill-mid-commit chaos


@pytest.mark.parametrize("site", ["data/", ".manifest", "_current"])
def test_kill_mid_publish_never_half_commits(package, tmp_path, site):
    """Killing the process at ANY of the three publish points leaves
    either the old snapshot or the new one — post-restart reads equal
    the pre-kill committed state and the acked tail commits exactly
    once on the new incarnation."""
    wal, lake = str(tmp_path / "wal"), str(tmp_path / "lake")
    runner, mem = fresh_runner()
    make_ev(mem)
    ing = IngestManager(
        runner, wal, start_thread=False, lakehouse_path=lake
    )
    ing.append("mem.default.ev", columns={"k": [1, 2], "v": [1.0, 2.0]})
    ing.flush()
    pre_kill_keys = keys(runner)
    pre_kill_sids = ing.store.sids(TK)
    # the publish dies mid-write at this site; the "process" dies with
    # it (the manager is abandoned without another flush)
    faults.configure(
        {"rules": [{"action": "io_error", "path": site, "count": 1}]}
    )
    ing.append("mem.default.ev", columns={"k": [3], "v": [3.0]})
    assert not ing.flush()
    faults.configure(None)
    ing.close(final_flush=False)

    # restart over the same WAL + lakehouse dirs, EMPTY memory store
    runner2, mem2 = fresh_runner()
    ing2 = IngestManager(
        runner2, wal, start_thread=False, lakehouse_path=lake
    )
    # pre-kill committed state is intact — never a half-commit
    assert keys(runner2) == pre_kill_keys
    assert ing2.store.sids(TK) == pre_kill_sids
    # the acked-but-uncommitted batch replayed into pending: exactly
    # one commit completes it, no duplicates
    assert ing2.stats()["pending_batches"] == 1
    ing2.flush()
    assert keys(runner2) == [1, 2, 3]
    ing2.close(final_flush=False)


def test_kill_after_publish_before_wal_frame_keeps_commit(package, tmp_path):
    """The fourth pipeline point: the manifest tip published but the
    WAL commit frame was lost. The tip carries the commit — replay
    reconciles committed = max(wal upto, manifest tip) and the batch
    is folded exactly once, never twice."""
    wal, lake = str(tmp_path / "wal"), str(tmp_path / "lake")
    runner, mem = fresh_runner()
    make_ev(mem)
    ing = IngestManager(
        runner, wal, start_thread=False, lakehouse_path=lake
    )
    ing.append("mem.default.ev", columns={"k": [1], "v": [1.0]})
    ing.flush()
    ing.append("mem.default.ev", columns={"k": [2], "v": [2.0]})
    # arm AFTER the appends so only the commit frame's write matches
    faults.configure(
        {"rules": [{"action": "io_error", "path": "wal-", "op": "write"}]}
    )
    assert ing.flush()  # publish succeeded; frame write was injected
    faults.configure(None)
    assert keys(runner) == [1, 2]
    tip = ing.store.current_sid(TK)
    ing.close(final_flush=False)

    runner2, mem2 = fresh_runner()
    ing2 = IngestManager(
        runner2, wal, start_thread=False, lakehouse_path=lake
    )
    # the manifest-carried commit survived; the WAL tail (whose frame
    # was lost) did NOT replay a second time
    assert keys(runner2) == [1, 2]
    assert ing2.stats()["pending_batches"] == 0
    assert ing2.store.current_sid(TK) == tip
    ing2.close(final_flush=False)


def test_io_error_on_each_site_degrades_to_clean_retry(package, tmp_path):
    """Disk-full / EIO on the data-file, manifest, or pointer write:
    the batches return to the pending front and the NEXT flush
    commits them — never an acked-batch loss, never a torn tip."""
    for i, site in enumerate(("data/", ".manifest", "_current")):
        wal = str(tmp_path / f"w{i}")
        lake = str(tmp_path / f"l{i}")
        runner, mem = fresh_runner()
        make_ev(mem)
        ing = IngestManager(
            runner, wal, start_thread=False, lakehouse_path=lake
        )
        ing.append("mem.default.ev", columns={"k": [1], "v": [1.0]})
        ing.flush()
        before = REGISTRY.counter("lakehouse.commit_retries").total
        faults.configure(
            {"rules": [{"action": "io_error", "path": site, "count": 1}]}
        )
        ing.append("mem.default.ev", columns={"k": [2], "v": [2.0]})
        assert not ing.flush()
        assert keys(runner) == [1]  # old tip intact
        assert REGISTRY.counter("lakehouse.commit_retries").total == (
            before + 1
        )
        # fault exhausted (count=1): the retry commits cleanly
        assert ing.flush()
        assert keys(runner) == [1, 2]
        assert ing.store.read_values(TK)["k"] == [1, 2]
        faults.configure(None)
        ing.close(final_flush=False)


# -------------------------------------------------- torn manifests


def test_torn_tip_rolls_back_to_parent_and_repairs_pointer(package, tmp_path):
    store = ManifestStore(str(tmp_path))
    store.create_table(TK, {"k": T.BIGINT})
    store.commit(TK, {"k": T.BIGINT}, {"k": [1, 2]}, 1)
    store.commit(TK, {"k": T.BIGINT}, {"k": [3]}, 2)
    # tear the tip manifest on disk (crash mid-write / bit rot)
    tip_path = tmp_path / "mem.default.ev" / "manifests" / "2.manifest"
    tip_path.write_text("garbage that fails the crc frame\n")
    before = REGISTRY.counter("lakehouse.rollbacks").total
    fresh = ManifestStore(str(tmp_path))  # no warm cache
    m = fresh.manifest(TK)
    assert m.snapshot == 1  # rolled back to the parent
    assert fresh.read_values(TK)["k"] == [1, 2]
    assert REGISTRY.counter("lakehouse.rollbacks").total == before + 1
    # the pointer was repaired: the NEXT store sees snapshot 1 as the
    # tip without another rollback
    assert ManifestStore(str(tmp_path)).current_sid(TK) == 1
    assert REGISTRY.counter("lakehouse.rollbacks").total == before + 1
    # the chain continues from the repaired parent
    fresh.commit(TK, {"k": T.BIGINT}, {"k": [4]}, 3)
    assert fresh.read_values(TK)["k"] == [1, 2, 4]


def test_missing_pointer_falls_back_to_newest_valid_manifest(package, tmp_path):
    store = ManifestStore(str(tmp_path))
    store.create_table(TK, {"k": T.BIGINT})
    store.commit(TK, {"k": T.BIGINT}, {"k": [1]}, 1)
    os.remove(tmp_path / "mem.default.ev" / "_current")
    fresh = ManifestStore(str(tmp_path))
    assert fresh.current_sid(TK) == 1
    assert fresh.read_values(TK)["k"] == [1]


# ------------------------------------------------- restart recovery


def test_restart_restores_rows_and_snapshot_lineage(package, tmp_path):
    """A restart with an EMPTY volatile store rebuilds the table from
    the manifest tip, re-registers the snapshot lineage (time travel
    survives the process), and replays the acked WAL tail exactly
    once."""
    wal, lake = str(tmp_path / "wal"), str(tmp_path / "lake")
    runner, mem = fresh_runner()
    make_ev(mem)
    ing = IngestManager(
        runner, wal, start_thread=False, lakehouse_path=lake
    )
    ing.append("mem.default.ev", columns={"k": [1, 2], "v": [1.0, 2.0]})
    ing.flush()
    ing.append("mem.default.ev", columns={"k": [3], "v": [3.0]})
    ing.flush()
    sid_v1, sid_v2 = ing.store.sids(TK)
    v1_rows = keys(
        runner,
        f"select k from mem.default.ev for version as of {sid_v1} "
        "order by k",
    )
    ing.append("mem.default.ev", columns={"k": [4], "v": [4.0]})  # acked tail
    ing.close(final_flush=False)

    before = REGISTRY.counter("lakehouse.restores").total
    runner2, mem2 = fresh_runner()
    ing2 = IngestManager(
        runner2, wal, start_thread=False, lakehouse_path=lake
    )
    assert REGISTRY.counter("lakehouse.restores").total == before + 1
    # committed state restored bit-equal from the durable tip
    assert keys(runner2) == [1, 2, 3]
    # time travel works across the restart, bit-equal
    assert keys(
        runner2,
        f"select k from mem.default.ev for version as of {sid_v1} "
        "order by k",
    ) == v1_rows == [1, 2]
    assert mem2.current_snapshot_id(EV) == sid_v2
    # the acked tail replays exactly once
    assert ing2.stats()["pending_batches"] == 1
    ing2.flush()
    assert keys(runner2) == [1, 2, 3, 4]
    ing2.close(final_flush=False)


def test_pre_lakehouse_history_bootstraps_into_first_manifest(package, tmp_path):
    """Enabling the lakehouse on a table with existing WAL-committed
    rows folds that history into the first manifest — a later restart
    serves the FULL table from the tip, not just post-enable rows."""
    wal = str(tmp_path / "wal")
    runner, mem = fresh_runner()
    make_ev(mem)
    ing = IngestManager(runner, wal, start_thread=False)  # no lakehouse
    ing.append("mem.default.ev", columns={"k": [1, 2], "v": [1.0, 2.0]})
    ing.flush()
    ing.close(final_flush=False)

    lake = str(tmp_path / "lake")
    runner2, mem2 = fresh_runner()
    ing2 = IngestManager(
        runner2, wal, start_thread=False, lakehouse_path=lake
    )
    ing2.append("mem.default.ev", columns={"k": [3], "v": [3.0]})
    ing2.flush()
    assert ing2.store.read_values(TK)["k"] == [1, 2, 3]
    ing2.close(final_flush=False)

    runner3, _ = fresh_runner()
    ing3 = IngestManager(
        runner3, wal, start_thread=False, lakehouse_path=lake
    )
    assert keys(runner3) == [1, 2, 3]
    ing3.close(final_flush=False)


# ------------------------------------------------------ time travel


def test_for_version_as_of_bit_equal_on_parquet_lakehouse(package, tmp_path):
    """Historic pins on a manifest-backed parquet table serve the
    committed value domain bit-equal — BIGINT, DOUBLE, DECIMAL, DATE,
    VARCHAR, BOOLEAN and NULLs round-trip exactly."""
    catalogs = CatalogManager()
    pconn = create_connector(
        "parquet", root=str(tmp_path / "files"),
        lakehouse=str(tmp_path / "lake"), catalog="lake",
    )
    catalogs.register("lake", pconn)
    runner = LocalQueryRunner(catalogs=catalogs)
    tk = ("lake", "default", "t")
    schema = {
        "a": T.BIGINT,
        "b": T.DOUBLE,
        "c": T.parse_type("decimal(10,2)"),
        "d": T.DATE,
        "e": T.VARCHAR,
        "f": T.BOOLEAN,
    }
    store = pconn.manifest_store
    store.create_table(tk, schema)
    row1 = (
        1, 1.5, decimal.Decimal("12.25"),
        datetime.date(2020, 1, 31), "alpha", True,
    )
    row2 = (2, None, decimal.Decimal("-0.01"), None, None, False)
    store.commit(
        tk, schema,
        {c: [v] for c, v in zip(schema, row1)}, 1,
    )
    snap1 = runner.execute(
        "select * from lake.default.t order by a"
    ).rows()
    assert len(snap1) == 1
    store.commit(
        tk, schema,
        {c: [v] for c, v in zip(schema, row2)}, 2,
    )
    tip = runner.execute(
        "select * from lake.default.t order by a"
    ).rows()
    assert len(tip) == 2
    # the historic pin reproduces the pre-commit result bit-equal
    v1 = runner.execute(
        "select * from lake.default.t for version as of 1 order by a"
    ).rows()
    assert v1 == snap1
    # pinned-tip query equals the implicit tip, bit-equal
    v2 = runner.execute(
        "select * from lake.default.t for version as of 2 order by a"
    ).rows()
    assert v2 == tip
    # the manifest round-trips the committed Python domain exactly —
    # DECIMAL stays exact, DATE is a date, NULLs stay NULL
    vals = store.read_values(tk, 1)
    assert [vals[c][0] for c in schema] == list(row1)
    vals2 = store.read_values(tk)
    assert [vals2[c][1] for c in schema] == list(row2)


def test_for_version_as_of_validation(package):
    runner, mem = fresh_runner()
    make_ev(mem)
    with pytest.raises(PlanningError, match="not available"):
        runner.execute("select * from mem.default.ev for version as of 9")
    catalogs = CatalogManager()
    catalogs.register("tpch", create_connector("tpch"))
    r2 = LocalQueryRunner(catalogs=catalogs)
    with pytest.raises(PlanningError, match="does not support"):
        r2.execute(
            "select * from tpch.tiny.nation for version as of 1"
        )


# ------------------------------------------------------- compaction


def test_compaction_preserves_pinned_readers_and_bit_equality(package, tmp_path):
    """Compaction rewrites the tip's small files as a NEW snapshot:
    the tip stays bit-equal, historic pins keep serving the OLD files,
    and nothing is deleted until the GC TTL expires them."""
    wal, lake = str(tmp_path / "wal"), str(tmp_path / "lake")
    runner, mem = fresh_runner()
    make_ev(mem)
    ing = IngestManager(
        runner, wal, start_thread=False, lakehouse_path=lake,
        lakehouse_orphan_ttl_s=0.0,  # GC off during the test
    )
    for i in range(4):
        ing.append(
            "mem.default.ev", columns={"k": [i], "v": [float(i)]}
        )
        ing.flush()
    sids = ing.store.sids(TK)
    assert len(ing.store.manifest(TK).files) == 4
    pre_tip = keys(runner)
    old_sid = sids[1]
    pinned = ing.store.manifest(TK, old_sid)  # a reader's pin
    pre_old = keys(
        runner,
        f"select k from mem.default.ev for version as of {old_sid} "
        "order by k",
    )
    before = REGISTRY.counter("lakehouse.compactions").total
    assert ing.compaction_tick(force=True) == 1
    assert REGISTRY.counter("lakehouse.compactions").total == before + 1
    tip = ing.store.manifest(TK)
    assert tip.compaction and len(tip.files) == 1
    assert tip.snapshot > sids[-1]
    # tip reads bit-equal through the compacted file
    assert keys(runner) == pre_tip
    assert ing.store.read_values(TK)["k"] == pre_tip
    # the pinned reader's OLD files still serve, bit-equal
    assert ing.store.read_values(TK, old_sid)["k"] == pre_old
    assert [
        r.as_py() if hasattr(r, "as_py") else r
        for r in ing.store.read_arrow(TK, pinned).column("k").to_pylist()
    ] == pre_old
    assert keys(
        runner,
        f"select k from mem.default.ev for version as of {old_sid} "
        "order by k",
    ) == pre_old
    # a second tick is a no-op (one big file; nothing small to merge)
    assert ing.compaction_tick(force=True) == 0
    ing.close(final_flush=False)


def test_compaction_defers_to_foreground_qos_load(package, tmp_path):
    runner, mem = fresh_runner()
    make_ev(mem)
    ing = IngestManager(
        runner, str(tmp_path / "wal"), start_thread=False,
        lakehouse_path=str(tmp_path / "lake"),
    )
    for i in range(4):
        ing.append(
            "mem.default.ev", columns={"k": [i], "v": [float(i)]}
        )
        ing.flush()
    runner.cluster = SimpleNamespace(
        qos=SimpleNamespace(background_idle=lambda: False)
    )
    before = REGISTRY.counter("lakehouse.compaction_deferred").total
    assert ing.compaction_tick() == 0  # busy lanes: the tick yields
    assert REGISTRY.counter(
        "lakehouse.compaction_deferred"
    ).total == before + 1
    runner.cluster.qos = SimpleNamespace(background_idle=lambda: True)
    assert ing.compaction_tick() == 1  # idle: housekeeping proceeds
    ing.close(final_flush=False)


def test_qos_background_idle_tracks_lane_occupancy(package):
    QosController = module(PKG, "server.qos").QosController

    coord = SimpleNamespace(resource_groups=None, _shutting_down=False)
    qos = QosController(coord, None, 2)
    assert qos.background_idle()
    q = SimpleNamespace(
        qid="q_c1_x", resource_group="adhoc", qos_suspensions=0,
        done=threading.Event(), state="FAILED",
    )
    assert qos.qos_admit(q)
    assert not qos.background_idle()
    qos.qos_release(q)
    assert qos.background_idle()


# --------------------------------------------------------------- gc


def test_gc_reclaims_orphans_and_expired_history_past_ttl(package, tmp_path):
    store = ManifestStore(str(tmp_path))
    store.create_table(TK, {"k": T.BIGINT})
    for sid in (1, 2, 3):
        store.commit(TK, {"k": T.BIGINT}, {"k": [sid]}, sid)
    # a failed commit strands a data file with no manifest (the
    # manifest write dies after the data file landed)
    faults.configure(
        {"rules": [{"action": "io_error", "path": ".manifest"}]}
    )
    with pytest.raises(OSError):
        store.commit(TK, {"k": T.BIGINT}, {"k": [99]}, 4)
    faults.configure(None)
    ddir = tmp_path / "mem.default.ev" / "data"
    assert len(list(ddir.iterdir())) == 4  # 3 live + 1 orphan
    # within the TTL nothing is reclaimed — pinned readers of recent
    # snapshots keep their files
    assert store.gc_orphans(ttl_s=3600.0) == 0
    # age everything past the TTL: the orphan and the non-tip history
    # expire; the tip keeps serving
    for sub in ("data", "manifests"):
        for p in (tmp_path / "mem.default.ev" / sub).iterdir():
            os.utime(p, (time.time() - 10, time.time() - 10))
    removed = store.gc_orphans(ttl_s=1.0)
    assert removed > 0
    fresh = ManifestStore(str(tmp_path))
    assert fresh.current_sid(TK) == 3
    assert fresh.read_values(TK)["k"] == [1, 2, 3]
    # expired history is gone from the chain (time travel truncated)
    assert fresh.manifest(TK, 1) is None
    # every surviving data file is referenced by the tip
    tip_files = {f.name for f in fresh.manifest(TK).files}
    assert {p.name for p in ddir.iterdir()} == tip_files


# ---------------------------------------------------- fsync-discipline


def test_wal_append_fsyncs_before_ack(package, tmp_path, monkeypatch):
    """The acked-durable contract: every WAL append syncs (write,
    then fsync, same file) BEFORE append() returns."""
    ops = []
    real = faults.maybe_inject_io
    monkeypatch.setattr(
        faults, "maybe_inject_io",
        lambda op, path: (ops.append((op, path)), real(op, path))[1],
    )
    runner, mem = fresh_runner()
    make_ev(mem)
    ing = IngestManager(runner, str(tmp_path), start_thread=False)
    ing.append("mem.default.ev", columns={"k": [1], "v": [1.0]})
    writes = [(o, p) for o, p in ops if "wal-" in p]
    assert [o for o, _ in writes] == ["write", "fsync"]
    assert writes[0][1] == writes[1][1]
    ing.close(final_flush=False)


def test_spool_commit_fsyncs_pages_before_marker(package, tmp_path, monkeypatch):
    ExchangeSpool = module(PKG, "server.spool").ExchangeSpool

    ops = []
    real = faults.maybe_inject_io
    monkeypatch.setattr(
        faults, "maybe_inject_io",
        lambda op, path: (ops.append((op, path)), real(op, path))[1],
    )
    sp = ExchangeSpool(str(tmp_path))
    tid = "q_c9.prod.0.a0"
    sp.append(tid, 0, b"payload")
    sp.commit(tid)
    kinds = [(o, os.path.basename(p)) for o, p in ops]
    # pages fsync strictly precedes the marker write
    assert kinds.index(("fsync", f"{tid}.0.pages")) < kinds.index(
        ("write", f"{tid}.ok")
    )


# --------------------------------------------------- legacy bit-exact


def test_lakehouse_unset_is_bit_exact_legacy(package, tmp_path):
    """No ``lakehouse.path``: no manifest store, no compaction
    thread, no manifest files anywhere — the WAL-only lane behaves
    exactly as before."""
    runner, mem = fresh_runner()
    make_ev(mem)
    threads_before = {t.name for t in threading.enumerate()}
    ing = IngestManager(runner, str(tmp_path / "wal"), start_thread=True)
    assert ing.store is None
    assert ing._compact_thread is None
    assert not any(
        t.name == "lakehouse-compaction" for t in threading.enumerate()
    )
    ing.append("mem.default.ev", columns={"k": [1, 2], "v": [1.0, 2.0]})
    ing.flush()
    assert keys(runner) == [1, 2]
    ing.close()
    # the WAL dir holds only WAL segments — zero manifest artifacts
    names = os.listdir(str(tmp_path / "wal"))
    assert names and all(n.startswith("wal-") for n in names)
    assert {t.name for t in threading.enumerate()} - threads_before <= set()
    # a parquet connector without the lakehouse config has no store
    # and serves nothing versioned
    pconn = create_connector("parquet", root=str(tmp_path / "files"))
    assert pconn.manifest_store is None


# ----------------------------------------------------- runtime view


def test_system_runtime_snapshots_view(package, tmp_path):
    runner, mem = fresh_runner()
    make_ev(mem)
    ing = IngestManager(
        runner, str(tmp_path / "wal"), start_thread=False,
        lakehouse_path=str(tmp_path / "lake"),
    )
    runner.ingest = ing
    ing.append("mem.default.ev", columns={"k": [1, 2], "v": [1.0, 2.0]})
    ing.flush()
    rows = runner.execute(
        "select * from system.runtime.snapshots"
    ).rows()
    assert len(rows) == 1
    table, sid, snaps, files, nbytes, nrows, state = rows[0]
    assert table == "mem.default.ev"
    assert sid == ing.store.current_sid(TK)
    assert (snaps, files, nrows) == (1, 1, 2)
    assert nbytes > 0
    assert state in ("none", "pending", "compacted")
    # no lakehouse mounted: the view is empty, never an error
    runner2, _ = fresh_runner()
    assert runner2.execute(
        "select count(*) from system.runtime.snapshots"
    ).rows() == [(0,)]
    ing.close(final_flush=False)


# ----------------------------------------- stores across the packages

LAKE_TK = ("lake", "default", "t")
LAKE_SCHEMA = {
    "a": "bigint", "b": "double", "c": "decimal(10,2)", "d": "date",
    "e": "varchar", "f": "boolean",
}
LAKE_ROWS = [
    (1, 1.5, decimal.Decimal("12.25"), datetime.date(2020, 1, 31),
     "alpha", True),
    (2, None, decimal.Decimal("-0.01"), None, None, False),
    (3, -2.25, decimal.Decimal("99999999.99"), datetime.date(1992, 1, 1),
     "beta", None),
]


def _commit_lake(pkg, root):
    """The three LAKE_ROWS committed as snapshots 1..3 by ``pkg``'s
    ManifestStore."""
    T_ = module(pkg, "types")
    schema = {c: T_.parse_type(t) for c, t in LAKE_SCHEMA.items()}
    store = module(pkg, "server.manifests").ManifestStore(str(root))
    store.create_table(LAKE_TK, schema)
    for sid, row in enumerate(LAKE_ROWS, 1):
        store.commit(
            LAKE_TK, schema, {c: [v] for c, v in zip(schema, row)}, sid
        )


def _lake_runner(pkg, root):
    ns = {}
    bind(ns, pkg)
    catalogs = ns["CatalogManager"]()
    catalogs.register("lake", ns["create_connector"](
        "parquet", root=str(root / "files"), lakehouse=str(root / "lake"),
        catalog="lake",
    ))
    return ns["LocalQueryRunner"](catalogs=catalogs)


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_store_written_by_one_package_reads_in_the_other(
    tmp_path, writer, reader
):
    """A manifest store one package committed reads in the other: every
    snapshot's values, and each FOR VERSION AS OF through a lakehouse
    parquet catalog, equal the writer's own reads."""
    _commit_lake(writer, tmp_path / "lake")
    store = module(reader, "server.manifests").ManifestStore(
        str(tmp_path / "lake")
    )
    assert store.sids(LAKE_TK) == [0, 1, 2, 3]  # 0: the empty table
    for sid in (1, 2, 3):
        vals = store.read_values(LAKE_TK, sid)
        assert [tuple(vals[c][i] for c in LAKE_SCHEMA) for i in range(sid)] == (
            LAKE_ROWS[:sid]
        )
    runners = {pkg: _lake_runner(pkg, tmp_path) for pkg in (writer, reader)}
    for sid in (1, 2, 3):
        sql = f"select * from lake.default.t for version as of {sid} order by a"
        want = runners[writer].execute(sql).rows()
        assert len(want) == sid
        assert_rows_equal(runners[reader].execute(sql).rows(), want)
    sql = "select count(*), sum(a), sum(c), sum(b) from lake.default.t"
    assert_rows_equal(
        runners[reader].execute(sql).rows(), runners[writer].execute(sql).rows()
    )


def test_manifest_lines_are_byte_equal_for_the_same_commits(tmp_path, monkeypatch):
    """The same commits at the same clock and data-file nonces give the
    same bytes in both packages: manifests, data files and the
    ``_current`` pointer."""
    import itertools
    import uuid

    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    trees = {}
    for pkg in PACKAGES:
        nonce = itertools.count(1)
        monkeypatch.setattr(
            uuid, "uuid4", lambda: uuid.UUID(int=next(nonce) << 96)
        )
        root = tmp_path / pkg
        _commit_lake(pkg, root)
        trees[pkg] = {
            str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()
        }
    assert sorted(trees["port"]) == sorted(trees["ref"])
    assert any(k.endswith(".manifest") for k in trees["ref"])
    for name, data in trees["ref"].items():
        assert trees["port"][name] == data, name


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_ingest_restart_across_packages(tmp_path, writer, reader):
    """An ingest lane with the lakehouse tee in one package, restarted
    over the same WAL and lakehouse directories in the other: the
    committed rows and the snapshot lineage come back from the manifest
    tip, and the acked WAL tail commits exactly once."""
    wal, lake = str(tmp_path / "wal"), str(tmp_path / "lake")

    def fresh(pkg):
        ns = {}
        bind(ns, pkg)
        catalogs = ns["CatalogManager"]()
        mem = ns["create_connector"]("memory")
        catalogs.register("mem", mem)
        return ns, ns["LocalQueryRunner"](catalogs=catalogs), mem

    ns, runner, mem = fresh(writer)
    mem.create_table(
        ns["TableHandle"]("mem", "default", "ev"),
        {"k": ns["T"].BIGINT, "v": ns["T"].DOUBLE},
    )
    ing = ns["IngestManager"](
        runner, wal, start_thread=False, lakehouse_path=lake
    )
    ing.append("mem.default.ev", columns={"k": [1, 2], "v": [1.0, 2.0]})
    ing.flush()
    ing.append("mem.default.ev", columns={"k": [3], "v": [3.0]})
    ing.flush()
    sid_v1, sid_v2 = ing.store.sids(TK)
    ing.append("mem.default.ev", columns={"k": [4], "v": [4.0]})  # acked tail
    ing.close(final_flush=False)

    ns2, runner2, mem2 = fresh(reader)
    ing2 = ns2["IngestManager"](
        runner2, wal, start_thread=False, lakehouse_path=lake
    )
    assert keys(runner2) == [1, 2, 3]
    assert keys(
        runner2,
        f"select k from mem.default.ev for version as of {sid_v1} order by k",
    ) == [1, 2]
    assert mem2.current_snapshot_id(ns2["TableHandle"]("mem", "default", "ev")) == sid_v2
    assert ing2.stats()["pending_batches"] == 1
    ing2.flush()
    assert keys(runner2) == [1, 2, 3, 4]
    assert ing2.store.read_values(TK)["k"] == [1, 2, 3, 4]
    ing2.close(final_flush=False)

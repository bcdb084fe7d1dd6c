"""The streaming ingest lane through both packages: the reference's
``presto_tpu/server/ingest.py`` and the port's
``presto_tpu_torch/server/ingest.py`` (``device="cpu"``), with the views
they maintain and the coordinator's ``POST /v1/ingest/{table}``.

The cases of ``tests/test_ingest.py``, each run once per package (the
``pkg`` parameter) against the reference's own expected rows, so the two
packages agree: the WAL round trip and torn-tail replay, snapshot
isolation under concurrent appends, kill-mid-commit replay (exactly
once), every eligible aggregate incremental vs full, the staleness gate,
the replay of view definitions and watermarks, the endpoint and the
runtime views, the commit loop. Then the state carried across the two
packages: ``_wal_frame`` lines and whole WAL files byte-equal, a WAL the
reference wrote replayed by the port with the same rows and view, and
the reverse.
"""

from __future__ import annotations

import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

import presto_tpu.server.ingest as ref_ingest
import presto_tpu_torch.server.ingest as port_ingest
from presto_tpu import types as RT
from presto_tpu.connectors import create_connector as ref_connector
from presto_tpu.connectors.spi import ConnectorSplit as RefSplit
from presto_tpu.connectors.spi import TableHandle as RefHandle
from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu.exec.staging import CatalogManager as RefCatalogs
from presto_tpu.server.coordinator import CoordinatorServer as RefCoord
from presto_tpu.session import NodeConfig as RefNodeConfig
from presto_tpu.utils.metrics import REGISTRY as REF_REGISTRY
from presto_tpu_torch import types as PT
from presto_tpu_torch.connectors import create_connector as port_connector
from presto_tpu_torch.connectors.spi import ConnectorSplit as PortSplit
from presto_tpu_torch.connectors.spi import TableHandle as PortHandle
from presto_tpu_torch.exec.local_runner import LocalQueryRunner as PortRunner
from presto_tpu_torch.exec.staging import CatalogManager as PortCatalogs
from presto_tpu_torch.server.coordinator import CoordinatorServer as PortCoord
from presto_tpu_torch.session import NodeConfig as PortNodeConfig
from presto_tpu_torch.utils.metrics import REGISTRY as PORT_REGISTRY
from torch_parity import one_torch_thread  # noqa: F401 (module fixture)

REF = types.SimpleNamespace(
    name="reference", T=RT, connector=ref_connector, Handle=RefHandle,
    Split=RefSplit, Runner=RefRunner, Catalogs=RefCatalogs, Coord=RefCoord,
    NodeConfig=RefNodeConfig, registry=REF_REGISTRY, ing=ref_ingest, kw={},
)
PORT = types.SimpleNamespace(
    name="port", T=PT, connector=port_connector, Handle=PortHandle,
    Split=PortSplit, Runner=PortRunner, Catalogs=PortCatalogs,
    Coord=PortCoord, NodeConfig=PortNodeConfig, registry=PORT_REGISTRY,
    ing=port_ingest, kw={"device": "cpu"},
)


@pytest.fixture(params=[REF, PORT], ids=["reference", "port"])
def pkg(request):
    return request.param


def fresh_runner(pkg):
    """A runner with a FRESH memory connector (the crash-simulation
    primitive: a new connector is an empty volatile store)."""
    catalogs = pkg.Catalogs()
    catalogs.register("tpch", pkg.connector("tpch"))
    mem = pkg.connector("memory")
    catalogs.register("mem", mem)
    return pkg.Runner(catalogs=catalogs, **pkg.kw), mem


def make_events(pkg, mem, name="ev"):
    h = pkg.Handle("mem", "default", name)
    mem.create_table(h, {"k": pkg.T.BIGINT, "v": pkg.T.BIGINT,
                         "w": pkg.T.DOUBLE})
    return h


@pytest.fixture()
def lane(pkg, tmp_path):
    runner, mem = fresh_runner(pkg)
    make_events(pkg, mem)
    ing = pkg.ing.IngestManager(runner, str(tmp_path), start_thread=False)
    yield runner, mem, ing, str(tmp_path)
    ing.close(final_flush=False)


def _counter(pkg, name):
    return int(pkg.registry.counter(name).total)


# ------------------------------------------------------------- the WAL


def test_wal_round_trip_and_commit_visibility(pkg, lane):
    runner, mem, ing, _ = lane
    out = ing.append(
        "mem.default.ev",
        columns={"k": [1, 1, 2], "v": [10, 20, 5], "w": [1.0, 2.0, 0.5]},
    )
    assert out["seq"] == 1 and out["rows"] == 3
    # durable but NOT visible before the commit folds it
    assert runner.execute("select count(*) from mem.default.ev").rows() == [
        (0,)
    ]
    assert ing.commit_tick() == 1
    assert runner.execute(
        "select k, v from mem.default.ev order by v"
    ).rows() == [(2, 5), (1, 10), (1, 20)]
    assert mem.current_snapshot_id(pkg.Handle("mem", "default", "ev")) == 1


def test_append_validates_schema(pkg, lane):
    _runner, _mem, ing, _ = lane
    err = pkg.ing.IngestError
    with pytest.raises(err, match="unknown column"):
        ing.append("mem.default.ev", columns={"nope": [1]})
    with pytest.raises(err, match="unknown column"):
        ing.append("mem.default.ev", rows=[{"K": 1, "v": 2, "w": 0.1}])
    with pytest.raises(err, match="missing column"):
        ing.append("mem.default.ev", rows=[{"k": 1, "v": 2}])
    with pytest.raises(err, match="missing column"):
        ing.append("mem.default.ev", columns={"k": [1]})
    with pytest.raises(err, match="ragged"):
        ing.append(
            "mem.default.ev", columns={"k": [1], "v": [1, 2], "w": [0.1]}
        )
    with pytest.raises(err, match="zero rows"):
        ing.append("mem.default.ev", columns={"k": [], "v": [], "w": []})


def test_wal_frame_round_trip_and_corruption(pkg):
    rec = {"ev": "batch", "seq": 3, "cols": {"k": [1]}}
    line = pkg.ing._wal_frame(json.dumps(rec))
    assert pkg.ing._parse_wal_line(line) == rec
    for cut in (len(line) - 1, len(line) // 2, 9):
        assert pkg.ing._parse_wal_line(line[:cut]) is None
    assert pkg.ing._parse_wal_line("zzzzzzzz {}") is None
    assert pkg.ing._parse_wal_line("") is None


def test_torn_tail_replay_readmits_exactly_once(pkg, lane):
    runner, mem, ing, wal = lane
    ing.append("mem.default.ev", columns={"k": [1], "v": [10], "w": [1.0]})
    ing.commit_tick()
    ing.append("mem.default.ev", columns={"k": [2], "v": [20], "w": [2.0]})
    path = os.path.join(wal, "wal-mem.default.ev.jsonl")
    with open(path, "a", encoding="utf-8") as f:
        f.write('deadbeef {"ev": "batch", "seq"')  # torn line
    corrupt0 = _counter(pkg, "ingest.wal_corrupt")
    runner2, _ = fresh_runner(pkg)
    ing2 = pkg.ing.IngestManager(runner2, wal, start_thread=False)
    assert runner2.execute(
        "select k, v from mem.default.ev order by k"
    ).rows() == [(1, 10)]
    assert ing2.stats()["pending_batches"] == 1
    assert _counter(pkg, "ingest.wal_corrupt") == corrupt0 + 1
    ing2.commit_tick()
    assert runner2.execute(
        "select k, v from mem.default.ev order by k"
    ).rows() == [(1, 10), (2, 20)]
    runner3, _ = fresh_runner(pkg)
    pkg.ing.IngestManager(runner3, wal, start_thread=False)
    assert runner3.execute(
        "select k, v from mem.default.ev order by k"
    ).rows() == [(1, 10), (2, 20)]


def test_legacy_write_path_untouched_without_wal(pkg):
    runner, mem = fresh_runner(pkg)
    make_events(pkg, mem)
    assert runner.ingest is None
    runner.execute(
        "insert into mem.default.ev values (1, 10, 1.0), (2, 20, 2.0)"
    )
    handle = pkg.Handle("mem", "default", "ev")
    assert mem.current_snapshot_id(handle) is None
    assert mem.pin_snapshot(handle) is handle
    assert runner.execute(
        "select k, v from mem.default.ev order by k"
    ).rows() == [(1, 10), (2, 20)]
    assert runner.execute(
        "delete from mem.default.ev where k = 1"
    ).rows() == [(1,)]
    assert runner.execute("select k from mem.default.ev").rows() == [(2,)]


# -------------------------------------------------- snapshot isolation


def test_pinned_snapshot_reader_sees_one_version(pkg, lane):
    runner, mem, ing, _ = lane
    handle = pkg.Handle("mem", "default", "ev")
    ing.append(
        "mem.default.ev", columns={"k": [1, 2], "v": [10, 20], "w": [1.0, 2.0]}
    )
    ing.commit_tick()
    pinned = mem.pin_snapshot(handle)
    assert pinned.snapshot == 1
    ing.append("mem.default.ev", columns={"k": [3], "v": [30], "w": [3.0]})
    ing.commit_tick()
    src = mem.get_splits(pinned)
    rows = 0
    while not src.exhausted:
        for sp in src.next_batch(16):
            rows += len(mem.create_page_source(sp, ["k"])["k"])
    assert rows == 2
    assert mem.metadata().get_table_stats(pinned).row_count == 2.0
    wide = mem.create_page_source(pkg.Split(pinned, 0, 99), ["k", "v"])
    assert len(wide["k"]) == 2
    assert mem.pin_snapshot(handle).snapshot == 2
    assert runner.execute("select count(*) from mem.default.ev").rows() == [
        (3,)
    ]


def test_snapshot_isolation_under_concurrent_append(pkg, lane):
    """Writers append while readers scan: every result is a consistent
    prefix (COUNT and SUM agree with some committed snapshot)."""
    runner, _mem, ing, _ = lane
    stop = threading.Event()
    errors = []
    reads = [0]

    def writer():
        i = 0
        while not stop.is_set():
            i += 1
            try:
                ing.append(
                    "mem.default.ev",
                    columns={"k": [i, i], "v": [1, 1], "w": [0.5, 0.5]},
                )
                ing.commit_tick()
            except Exception as e:  # pragma: no cover
                errors.append(e)
                return

    def reader():
        while not stop.is_set():
            try:
                (n, s), = runner.execute(
                    "select count(*) c, sum(v) s from mem.default.ev"
                ).rows()
                reads[0] += 1
                if n and (s != n or n % 2):
                    errors.append(AssertionError(f"torn read: n={n} s={s}"))
                    return
            except Exception as e:  # pragma: no cover
                errors.append(e)
                return

    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader) for _ in range(2)
    ]
    for t in threads:
        t.start()
    time.sleep(1.0)
    stop.set()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert not errors, errors[0]
    assert reads[0] > 0


# ------------------------------------------------- kill-mid-commit chaos


def test_kill_mid_commit_chaos_replay_exact_once(pkg, tmp_path):
    """A crash before the commit frame, after a full commit, and between
    the frame and the connector fold: replay exposes every batch whose
    commit frame landed exactly once, keeps the rest pending exactly
    once, and a view over the replayed table equals a cold refresh."""
    wal = str(tmp_path)
    runner, mem = fresh_runner(pkg)
    make_events(pkg, mem)
    ing = pkg.ing.IngestManager(runner, wal, start_thread=False)
    runner.execute(
        "create materialized view mem.default.mv as "
        "select k, sum(v) as sv, count(*) as c "
        "from mem.default.ev group by k"
    )
    committed_rows, tail_rows = [], []
    seq = 0
    for round_no in range(6):
        seq += 1
        rows = [(round_no % 3, 10 + seq), (round_no % 3 + 5, seq)]
        ing.append(
            "mem.default.ev",
            columns={
                "k": [r[0] for r in rows],
                "v": [r[1] for r in rows],
                "w": [0.0, 0.0],
            },
        )
        tail_rows.extend(rows)
        kill_point = round_no % 3
        if kill_point == 1:
            ing.commit_tick()
            committed_rows.extend(tail_rows)
            tail_rows = []
        elif kill_point == 2:
            # the commit frame lands, the connector never folds it
            with ing._commit_mu:
                lane_obj = ing._lane(pkg.Handle("mem", "default", "ev"))
                with lane_obj.lock:
                    batches = lane_obj.pending
                    lane_obj.pending = []
                    upto = batches[-1][0]
                    ing._write_frame(
                        lane_obj,
                        {"ev": "commit", "upto": upto, "snapshot": upto},
                    )
                    lane_obj.committed = upto
            committed_rows.extend(tail_rows)
            tail_rows = []
        runner, mem = fresh_runner(pkg)
        ing = pkg.ing.IngestManager(runner, wal, start_thread=False)
        got = runner.execute(
            "select k, v from mem.default.ev order by k, v"
        ).rows()
        assert got == sorted(committed_rows), round_no
        assert ing.stats()["pending_batches"] == len(tail_rows) // 2
        mv_rows = runner.execute(
            "select * from mem.default.mv order by k"
        ).rows()
        cold = runner.execute(
            "select k, sum(v) as sv, count(*) as c "
            "from mem.default.ev group by k order by k"
        ).rows()
        assert mv_rows == cold, round_no
    ing.commit_tick()
    committed_rows.extend(tail_rows)
    assert runner.execute(
        "select k, v from mem.default.ev order by k, v"
    ).rows() == sorted(committed_rows)


# --------------------------------------------------- materialized views


def _mv_setup(lane, mv_sql=None):
    runner, mem, ing, _ = lane
    runner.execute(
        mv_sql
        or (
            "create materialized view mem.default.mv as "
            "select k, sum(v) as sv, count(*) as c, min(v) as mn, "
            "max(v) as mx, avg(w) as aw "
            "from mem.default.ev group by k"
        )
    )
    return runner, mem, ing


def test_incremental_vs_full_bit_equality_each_aggregate(pkg, lane):
    runner, _mem, ing = _mv_setup(lane)
    for b in (
        {"k": [1, 1, 2], "v": [10, 20, 5], "w": [1.0, 3.0, 0.5]},
        {"k": [2, 3], "v": [7, 100], "w": [2.5, 4.0]},
        {"k": [1, 3, 3], "v": [1, 2, 3], "w": [0.0, 8.0, 4.0]},
    ):
        ing.append("mem.default.ev", columns=b)
        ing.commit_tick()
    mv = runner.mview_registry.lookup(("mem", "default", "mv"))
    assert mv.eligible and mv.incremental_refreshes == 3
    incremental = runner.execute(
        "select * from mem.default.mv order by k"
    ).rows()
    direct = runner.execute(
        "select k, sum(v), count(*), min(v), max(v), avg(w) "
        "from mem.default.ev group by k order by k"
    ).rows()
    assert incremental == direct
    assert incremental == [
        (1, 31, 3, 1, 20, 4.0 / 3), (2, 12, 2, 5, 7, 1.5),
        (3, 105, 3, 2, 100, 16.0 / 3),
    ]
    runner.execute("refresh materialized view mem.default.mv")
    assert mv.last_mode == "full"
    assert runner.execute(
        "select * from mem.default.mv order by k"
    ).rows() == incremental


def test_new_groups_appear_incrementally(pkg, lane):
    runner, _mem, ing = _mv_setup(lane)
    ing.append("mem.default.ev", columns={"k": [1], "v": [10], "w": [1.0]})
    ing.commit_tick()
    ing.append("mem.default.ev", columns={"k": [9], "v": [90], "w": [9.0]})
    ing.commit_tick()
    assert runner.execute(
        "select k, sv from mem.default.mv order by k"
    ).rows() == [(1, 10), (9, 90)]


def test_where_clause_applies_to_delta(pkg, lane):
    runner, _mem, ing = _mv_setup(
        lane,
        "create materialized view mem.default.mv as "
        "select k, sum(v) as sv from mem.default.ev "
        "where v >= 10 group by k",
    )
    ing.append(
        "mem.default.ev", columns={"k": [1, 1], "v": [5, 50], "w": [0.0, 0.0]}
    )
    ing.commit_tick()
    assert runner.execute("select * from mem.default.mv").rows() == [(1, 50)]
    mv = runner.mview_registry.lookup(("mem", "default", "mv"))
    assert mv.eligible and mv.incremental_refreshes == 1


def test_ineligible_view_falls_back_to_full_refresh(pkg, lane):
    runner, _mem, ing = _mv_setup(
        lane,
        "create materialized view mem.default.mvj as "
        "select r_name, count(*) as c "
        "from mem.default.ev, tpch.tiny.region "
        "where k = r_regionkey group by r_name",
    )
    mv = runner.mview_registry.lookup(("mem", "default", "mvj"))
    assert not mv.eligible and mv.reason
    ing.append(
        "mem.default.ev",
        columns={"k": [0, 0, 1], "v": [1, 2, 3], "w": [0.0] * 3},
    )
    ing.commit_tick()
    assert mv.incremental_refreshes == 0 and mv.refreshes == 2
    assert runner.execute(
        "select r_name, c from mem.default.mvj order by r_name"
    ).rows() == [("AFRICA", 2), ("AMERICA", 1)]


def test_full_refresh_covers_racing_delta_exactly_once(pkg, lane):
    runner, _mem, ing = _mv_setup(
        lane,
        "create materialized view mem.default.mv as "
        "select k, sum(v) as sv from mem.default.ev group by k",
    )
    reg = runner.mview_registry
    mv = reg.lookup(("mem", "default", "mv"))
    delta = {"k": [1], "v": [10], "w": [1.0]}
    ing.append("mem.default.ev", columns=delta)
    ing.commit_tick()
    assert mv.last_snapshot == 1
    reg._incremental_refresh(mv, delta, 1)
    assert runner.execute(
        "select sv from mem.default.mv where k = 1"
    ).rows() == [(10,)]
    runner.execute("refresh materialized view mem.default.mv")
    assert mv.last_snapshot == 1
    reg._incremental_refresh(mv, delta, 1)
    assert runner.execute(
        "select sv from mem.default.mv where k = 1"
    ).rows() == [(10,)]


def test_incremental_disabled_forces_full(pkg, lane):
    runner, _mem, ing = _mv_setup(lane)
    runner.mview_registry.incremental_enabled = False
    ing.append("mem.default.ev", columns={"k": [1], "v": [10], "w": [1.0]})
    ing.commit_tick()
    mv = runner.mview_registry.lookup(("mem", "default", "mv"))
    assert mv.incremental_refreshes == 0 and mv.last_mode == "full"
    assert runner.execute("select k, sv from mem.default.mv").rows() == [
        (1, 10)
    ]


def test_staleness_read_gate_refreshes_legacy_writes(pkg, lane):
    runner = lane[0]
    runner.execute(
        "create materialized view mem.default.mv as "
        "select k, sum(v) as sv from mem.default.ev group by k"
    )
    reg = runner.mview_registry
    runner.execute("insert into mem.default.ev values (1, 10, 1.0)")
    assert runner.execute("select * from mem.default.mv").rows() == []
    reg.max_staleness_s = 0.01
    time.sleep(0.05)
    assert runner.execute("select * from mem.default.mv").rows() == [(1, 10)]
    mv = reg.lookup(("mem", "default", "mv"))
    assert mv.refreshes == 2
    reg.max_staleness_s = 3600.0
    runner.execute("insert into mem.default.ev values (2, 20, 2.0)")
    assert runner.execute(
        "select * from mem.default.mv order by k"
    ).rows() == [(1, 10)]
    assert mv.refreshes == 2


def test_gate_repairs_view_after_legacy_write_between_commits(pkg, lane):
    runner, _mem, ing = _mv_setup(
        lane,
        "create materialized view mem.default.mv as "
        "select k, sum(v) as sv from mem.default.ev group by k",
    )
    reg = runner.mview_registry
    ing.append("mem.default.ev", columns={"k": [1], "v": [10], "w": [0.0]})
    ing.commit_tick()
    runner.execute("insert into mem.default.ev values (2, 20, 0.0)")
    ing.append("mem.default.ev", columns={"k": [3], "v": [30], "w": [0.0]})
    ing.commit_tick()
    assert runner.execute(
        "select k, sv from mem.default.mv order by k"
    ).rows() == [(1, 10), (3, 30)]
    reg.max_staleness_s = 0.01
    time.sleep(0.05)
    assert runner.execute(
        "select k, sv from mem.default.mv order by k"
    ).rows() == [(1, 10), (2, 20), (3, 30)]


def test_drop_materialized_view(pkg, lane):
    runner, _mem, _ing = _mv_setup(lane)
    runner.execute("drop materialized view mem.default.mv")
    assert runner.mview_registry.lookup(("mem", "default", "mv")) is None
    with pytest.raises(Exception):
        runner.execute("select * from mem.default.mv")
    runner.execute("drop materialized view if exists mem.default.mv")


def test_mview_definition_survives_replay(pkg, lane):
    runner, _mem, ing = _mv_setup(lane)
    ing.append(
        "mem.default.ev", columns={"k": [1, 2], "v": [10, 20], "w": [1.0, 2.0]}
    )
    ing.commit_tick()
    runner2, _ = fresh_runner(pkg)
    pkg.ing.IngestManager(runner2, lane[3], start_thread=False)
    mv = runner2.mview_registry.lookup(("mem", "default", "mv"))
    assert mv is not None and mv.last_mode == "replay"
    assert runner2.execute(
        "select k, sv from mem.default.mv order by k"
    ).rows() == [(1, 10), (2, 20)]


def test_replay_without_catalog_preserves_seq_watermarks(pkg, tmp_path):
    wal = str(tmp_path)
    runner, mem = fresh_runner(pkg)
    make_events(pkg, mem)
    ing = pkg.ing.IngestManager(runner, wal, start_thread=False)
    ing.append("mem.default.ev", columns={"k": [1], "v": [111], "w": [0.0]})
    ing.commit_tick()
    catalogs = pkg.Catalogs()
    catalogs.register("tpch", pkg.connector("tpch"))
    r2 = pkg.Runner(catalogs=catalogs, **pkg.kw)
    ing2 = pkg.ing.IngestManager(r2, wal, start_thread=False)
    lane_obj = ing2._lane(pkg.Handle("mem", "default", "ev"))
    assert lane_obj.seq == 1 and lane_obj.committed == 1
    mem2 = pkg.connector("memory")
    make_events(pkg, mem2)
    r2.catalogs.register("mem", mem2)
    out = ing2.append(
        "mem.default.ev", columns={"k": [2], "v": [222], "w": [0.0]}
    )
    assert out["seq"] == 2
    ing2.commit_tick()
    runner3, _ = fresh_runner(pkg)
    pkg.ing.IngestManager(runner3, wal, start_thread=False)
    assert runner3.execute(
        "select k, v from mem.default.ev order by k"
    ).rows() == [(1, 111), (2, 222)]


def test_replay_applies_committed_into_recreated_empty_table(pkg, tmp_path):
    wal = str(tmp_path)
    runner, mem = fresh_runner(pkg)
    make_events(pkg, mem)
    ing = pkg.ing.IngestManager(runner, wal, start_thread=False)
    ing.append("mem.default.ev", columns={"k": [1], "v": [111], "w": [0.0]})
    ing.commit_tick()
    runner2, mem2 = fresh_runner(pkg)
    make_events(pkg, mem2)  # re-created EMPTY before the manager
    pkg.ing.IngestManager(runner2, wal, start_thread=False)
    assert runner2.execute("select k, v from mem.default.ev").rows() == [
        (1, 111)
    ]


def test_failed_merge_poisons_incremental_until_full_refresh(pkg, lane):
    runner, _mem, ing = _mv_setup(
        lane,
        "create materialized view mem.default.mv as "
        "select k, sum(v) as sv from mem.default.ev group by k",
    )
    reg = runner.mview_registry
    mv = reg.lookup(("mem", "default", "mv"))
    orig = reg._merge_one_delta

    def boom(*a, **k):
        raise RuntimeError("injected merge failure")

    reg._merge_one_delta = boom
    try:
        ing.append("mem.default.ev", columns={"k": [1], "v": [10], "w": [0.0]})
        ing.commit_tick()
    finally:
        reg._merge_one_delta = orig
    assert mv.dirty
    assert _counter(pkg, "mview.maintenance_errors") >= 1
    ing.append("mem.default.ev", columns={"k": [2], "v": [20], "w": [0.0]})
    ing.commit_tick()
    assert not mv.dirty and mv.last_mode == "full"
    assert runner.execute(
        "select k, sv from mem.default.mv order by k"
    ).rows() == [(1, 10), (2, 20)]
    ing.append("mem.default.ev", columns={"k": [1], "v": [5], "w": [0.0]})
    ing.commit_tick()
    assert mv.last_mode == "incremental"
    assert runner.execute(
        "select k, sv from mem.default.mv order by k"
    ).rows() == [(1, 15), (2, 20)]


# -------------------------------------------- server + runtime surface


def test_coordinator_endpoint_and_runtime_views(pkg, tmp_path):
    cfg = pkg.NodeConfig({
        "ingest.wal-path": str(tmp_path),
        "ingest.commit-interval-ms": "0",
        "mview.max-staleness-s": "30",
        "mview.incremental-enabled": "true",
    })
    coord = pkg.Coord(config=cfg, **pkg.kw).start()
    try:
        coord.local.catalogs.register("mem", pkg.connector("memory"))
        coord.local.execute("create table mem.default.ev (k bigint, v bigint)")
        coord.local.execute(
            "create materialized view mem.default.mv as "
            "select k, sum(v) as sv from mem.default.ev group by k"
        )

        def post(body):
            req = urllib.request.Request(
                coord.uri + "/v1/ingest/mem.default.ev",
                data=json.dumps(body).encode(),
            )
            return json.load(urllib.request.urlopen(req))

        out = post({"rows": [{"k": 1, "v": 10}, {"k": 2, "v": 7}],
                    "commit": True})
        assert out["rows"] == 2 and out["committed"]
        assert coord.local.execute(
            "select * from mem.default.mv order by k"
        ).rows() == [(1, 10), (2, 7)]
        assert post({"columns": {"k": [3], "v": [1]}, "commit": True})[
            "rows"
        ] == 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            post({"columns": {"bogus": [1]}})
        assert ei.value.code == 400
        rtv = coord.local.execute(
            "select view, base_table, eligible, last_refresh_mode, "
            "incremental_refreshes from system.runtime.materialized_views"
        ).rows()
        assert rtv == [
            ("mem.default.mv", "mem.default.ev", True, "incremental", 2)
        ]
        caches = {
            r[0]: r
            for r in coord.local.execute(
                "select cache, entries, hits from system.runtime.caches"
            ).rows()
        }
        assert "ingest.wal" in caches
        assert caches["ingest.wal"][2] >= 2  # commits as hits
        names = {n for n, _k, _v in pkg.registry.snapshot()}
        for expect in (
            "ingest.batches.total", "ingest.rows.total",
            "ingest.wal_bytes.total", "ingest.commit_ms.count",
            "mview.refreshes.total", "mview.incremental_refreshes.total",
            "mview.rows_delta.total", "mview.staleness_ms.count",
        ):
            assert expect in names, expect
    finally:
        coord.shutdown()


def test_endpoint_without_lane_is_503(pkg):
    coord = pkg.Coord(**pkg.kw).start()
    try:
        req = urllib.request.Request(
            coord.uri + "/v1/ingest/mem.default.ev", data=b"{}"
        )
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req)
        assert ei.value.code == 503
    finally:
        coord.shutdown()


def test_commit_loop_drives_visibility(pkg, tmp_path):
    """The background commit loop (no explicit flush) folds pending
    batches and maintains the view."""
    runner, mem = fresh_runner(pkg)
    make_events(pkg, mem)
    ing = pkg.ing.IngestManager(runner, str(tmp_path), commit_interval_ms=20.0)
    try:
        runner.execute(
            "create materialized view mem.default.mv as "
            "select k, sum(v) as sv from mem.default.ev group by k"
        )
        ing.append("mem.default.ev", columns={"k": [1], "v": [10], "w": [1.0]})
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if runner.execute("select * from mem.default.mv").rows() == [
                (1, 10)
            ]:
                break
            time.sleep(0.05)
        else:
            raise AssertionError("the commit loop never surfaced the batch")
    finally:
        ing.close()


# ---------------------------------- the state carried across packages


BATCHES = [
    {"k": [1, 1, 2], "v": [10, 20, 5], "w": [1.0, 3.0, 0.5]},
    {"k": [2, 3], "v": [7, 100], "w": [2.5, 4.0]},
    {"k": [1, 3, 3], "v": [1, 2, 3], "w": [0.0, 8.0, 4.0]},
]
TYPED = {
    "d": ["12.34", "0.05", "-7.00"],
    "t": ["1995-03-15", "1998-12-01", "1970-01-01"],
    "s": ["A", "N", "R"],
}


def test_wal_frame_lines_are_byte_equal():
    for rec in (
        {"ev": "schema", "table": "mem.default.ev",
         "cols": {"k": "bigint", "v": "bigint", "w": "double"}},
        {"ev": "batch", "seq": 1, "cols": BATCHES[0]},
        {"ev": "commit", "upto": 1, "snapshot": 1},
        {"ev": "mview", "name": "mem.default.mv", "sql": "select 1"},
    ):
        payload = json.dumps(rec)
        line = port_ingest._wal_frame(payload)
        assert line == ref_ingest._wal_frame(payload)
        assert port_ingest._parse_wal_line(line) == rec
        assert ref_ingest._parse_wal_line(line) == rec


def _write_wal(pkg, wal):
    """Batches, commits, a tail and a view definition through ``pkg``'s
    lane into ``wal``, over a table of every column kind."""
    runner, mem = fresh_runner(pkg)
    make_events(pkg, mem)
    mem.create_table(
        pkg.Handle("mem", "default", "typed"),
        {"d": pkg.T.parse_type("decimal(12,2)"), "t": pkg.T.DATE,
         "s": pkg.T.VARCHAR},
    )
    ing = pkg.ing.IngestManager(runner, wal, start_thread=False)
    runner.execute(
        "create materialized view mem.default.mv as "
        "select k, sum(v) as sv, count(*) as c, min(v) as mn, "
        "max(v) as mx, avg(w) as aw from mem.default.ev group by k"
    )
    for b in BATCHES[:2]:
        ing.append("mem.default.ev", columns=b)
        ing.commit_tick()
    ing.append("mem.default.typed", columns=TYPED)
    ing.commit_tick()
    ing.append("mem.default.ev", columns=BATCHES[2])  # the tail
    ing.close(final_flush=False)


def _replayed(pkg, wal):
    """What ``pkg`` reads after replaying ``wal``. The date column is
    read by the port alone: the reference cannot read back a date column
    a write stored (ROADMAP section 3), through its ingest lane too."""
    runner, _ = fresh_runner(pkg)
    ing = pkg.ing.IngestManager(runner, wal, start_thread=False)
    before = (
        runner.execute("select k, v, w from mem.default.ev order by k, v")
        .rows(),
        runner.execute("select * from mem.default.mv order by k").rows(),
        runner.execute("select d, s from mem.default.typed order by s")
        .rows(),
        ing.stats()["pending_batches"],
    )
    if pkg is PORT:
        dates = runner.execute(
            "select t from mem.default.typed order by s"
        ).rows()
        assert [str(t) for (t,) in dates] == TYPED["t"]
    else:
        with pytest.raises(TypeError):
            runner.execute("select t from mem.default.typed")
    ing.commit_tick()
    after = (
        runner.execute("select k, v, w from mem.default.ev order by k, v")
        .rows(),
        runner.execute("select * from mem.default.mv order by k").rows(),
    )
    return before, after


def test_wal_files_are_byte_equal_between_packages(tmp_path):
    paths = {}
    for pkg in (REF, PORT):
        wal = str(tmp_path / pkg.name)
        _write_wal(pkg, wal)
        paths[pkg.name] = wal
    names = sorted(os.listdir(paths["reference"]))
    assert names == sorted(os.listdir(paths["port"]))
    assert names == [
        "mviews.jsonl", "wal-mem.default.ev.jsonl",
        "wal-mem.default.typed.jsonl",
    ]
    for name in names:
        with open(os.path.join(paths["reference"], name), "rb") as f:
            ref_bytes = f.read()
        with open(os.path.join(paths["port"], name), "rb") as f:
            assert f.read() == ref_bytes, name


@pytest.mark.parametrize(
    "writer,reader", [(REF, PORT), (PORT, REF)],
    ids=["reference-to-port", "port-to-reference"],
)
def test_wal_written_by_one_package_replays_in_the_other(
    tmp_path, writer, reader
):
    """A WAL one package wrote replays in the other with the same
    committed rows, the same view, the same pending tail, and the same
    rows once the tail commits, as when the writer replays it itself."""
    wal = str(tmp_path / "wal")
    _write_wal(writer, wal)
    own = _replayed(writer, wal)
    other_wal = str(tmp_path / "copy")
    _write_wal(writer, other_wal)
    other = _replayed(reader, other_wal)
    assert other == own
    (ev, mv, typed, pending), (ev2, mv2) = own
    assert ev == [(1, 10, 1.0), (1, 20, 3.0), (2, 5, 0.5), (2, 7, 2.5),
                  (3, 100, 4.0)]
    assert pending == 1
    assert len(ev2) == 8 and mv2[0] == (1, 31, 3, 1, 20, 4.0 / 3)
    assert typed == [(12.34, "A"), (0.05, "N"), (-7.0, "R")]


def test_group_by_over_an_empty_string_column():
    """A one-hot GROUP BY whose string key has an empty dictionary (a
    view created over an empty ingest table): the reference returns no
    group, and the port, which divided by the key's zero-width slot
    (``ZeroDivisionError``), now does the same; the global aggregate
    keeps its one row in both."""
    for pkg in (REF, PORT):
        runner, mem = fresh_runner(pkg)
        runner.execute(
            "create table mem.default.t (k varchar, s varchar, v bigint)"
        )
        assert runner.execute(
            "select k, count(*) from mem.default.t group by k"
        ).rows() == []
        assert runner.execute(
            "select k, s, sum(v) from mem.default.t group by k, s"
        ).rows() == []
        assert runner.execute(
            "select count(*), sum(v) from mem.default.t"
        ).rows() == [(0, None)]

"""The serving plane's snapshot-keyed result cache (tiers a and c of
``server/result_cache.py``) through both packages: the reference's
coordinator and the port's (``device="cpu"``), on the same statements.

The cases of ``tests/test_result_cache.py`` that
``tests/test_torch_mview.py`` does not already hold (the MV rewrite is
there), each run once per package (the ``pkg`` parameter) against the
reference's own expected rows: off bit-exact; a hit with zero dispatch
and distinct literal keys; system scans never stored; INSERT
invalidation; ingest-commit staleness; one stale refresh; a micro-batch
then all hits; hot-fingerprint collapse; a coordinator that dies starts
cold; LRU and the pool mirror; an oversized entry; the runtime views,
EXPLAIN and the JSONL events; the metric families; the prepared header.
"Zero dispatch" reads each package's own ``DEVICE`` counters.
"""

from __future__ import annotations

import json
import socket
import tempfile
import threading
import time
import types

import pytest

import presto_tpu.server.ingest as ref_ingest
import presto_tpu.server.result_cache as ref_rc
import presto_tpu_torch.server.ingest as port_ingest
import presto_tpu_torch.server.result_cache as port_rc
from presto_tpu import types as RT
from presto_tpu.connectors import create_connector as ref_connector
from presto_tpu.connectors.spi import TableHandle as RefHandle
from presto_tpu.exec.explain import render_query_analyze as ref_render
from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu.exec.staging import CatalogManager as RefCatalogs
from presto_tpu.exec.stats import JsonlQueryEventListener as RefJsonl
from presto_tpu.plan import canonical as ref_canonical
from presto_tpu.server import protocol as ref_protocol
from presto_tpu.server.client import PrestoTpuClient as RefClient
from presto_tpu.server.coordinator import CoordinatorServer as RefCoord
from presto_tpu.session import NodeConfig as RefNodeConfig
from presto_tpu.sql import parse_statement as ref_parse
from presto_tpu.utils import faults as ref_faults
from presto_tpu.utils.memory import MemoryPool as RefPool
from presto_tpu.utils.metrics import REGISTRY as REF_REGISTRY
from presto_tpu.utils.telemetry import device_snapshot as ref_device
from presto_tpu_torch import types as PT
from presto_tpu_torch.connectors import create_connector as port_connector
from presto_tpu_torch.connectors.spi import TableHandle as PortHandle
from presto_tpu_torch.exec.explain import render_query_analyze as port_render
from presto_tpu_torch.exec.local_runner import LocalQueryRunner as PortRunner
from presto_tpu_torch.exec.staging import CatalogManager as PortCatalogs
from presto_tpu_torch.exec.stats import JsonlQueryEventListener as PortJsonl
from presto_tpu_torch.plan import canonical as port_canonical
from presto_tpu_torch.server import protocol as port_protocol
from presto_tpu_torch.server.client import PrestoTpuClient as PortClient
from presto_tpu_torch.server.coordinator import CoordinatorServer as PortCoord
from presto_tpu_torch.session import NodeConfig as PortNodeConfig
from presto_tpu_torch.sql import parse_statement as port_parse
from presto_tpu_torch.utils.memory import MemoryPool as PortPool
from presto_tpu_torch.utils.metrics import REGISTRY as PORT_REGISTRY
from presto_tpu_torch.utils.telemetry import device_snapshot as port_device
from torch_parity import one_torch_thread  # noqa: F401 (module fixture)

REF = types.SimpleNamespace(
    name="reference", T=RT, connector=ref_connector, Handle=RefHandle,
    Runner=RefRunner, Catalogs=RefCatalogs, Coord=RefCoord,
    NodeConfig=RefNodeConfig, registry=REF_REGISTRY, device=ref_device,
    rc=ref_rc, ing=ref_ingest, canonical=ref_canonical, parse=ref_parse,
    Pool=RefPool, Jsonl=RefJsonl, render=ref_render, Client=RefClient,
    protocol=ref_protocol, kw={},
)
PORT = types.SimpleNamespace(
    name="port", T=PT, connector=port_connector, Handle=PortHandle,
    Runner=PortRunner, Catalogs=PortCatalogs, Coord=PortCoord,
    NodeConfig=PortNodeConfig, registry=PORT_REGISTRY, device=port_device,
    rc=port_rc, ing=port_ingest, canonical=port_canonical, parse=port_parse,
    Pool=PortPool, Jsonl=PortJsonl, render=port_render, Client=PortClient,
    protocol=port_protocol, kw={"device": "cpu"},
)

POINT = (
    "select c_custkey, c_name, c_acctbal "
    "from tpch.tiny.customer where c_custkey = ?"
)
PREPARED = {"point": POINT}


@pytest.fixture(params=[REF, PORT], ids=["reference", "port"])
def pkg(request):
    return request.param


def _mem_runner(pkg):
    catalogs = pkg.Catalogs()
    catalogs.register("tpch", pkg.connector("tpch"))
    mem = pkg.connector("memory")
    catalogs.register("mem", mem)
    return pkg.Runner(catalogs=catalogs, **pkg.kw), mem


def _events(pkg, runner, mem, name="ev"):
    mem.create_table(
        pkg.Handle("mem", "default", name),
        {"k": pkg.T.BIGINT, "v": pkg.T.BIGINT},
    )
    runner.execute(
        f"insert into mem.default.{name} values "
        "(1, 10), (1, 20), (2, 5), (3, 7)"
    )
    return pkg.Handle("mem", "default", name)


def _coord(pkg, enabled=True, **session):
    """An unstarted coordinator (local dispatch) with a writable memory
    catalog; room for every statement of a concurrent round at once."""
    coord = pkg.Coord(max_concurrent_queries=64, **pkg.kw)
    mem = pkg.connector("memory")
    coord.local.catalogs.register("mem", mem)
    if enabled:
        coord.local.session.set("enable_result_cache", True)
    for k, v in session.items():
        coord.local.session.set(k, v)
    return coord, mem


def _run(coord, sql, prepared=None):
    q = coord.submit(sql, prepared=dict(prepared or {}))
    assert q.done.wait(120)
    assert q.state == "FINISHED", q.error
    return q


def _submit_concurrent(coord, sqls, prepared=None):
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


def _batch_keys(pkg, coord):
    """The keys of batched shapes: the reference's compile cache, the
    port's served-batch registry."""
    if pkg is REF:
        return [k for k in coord.local._compiled if "batch" in k]
    return list(coord.local.batch_entries)


# --------------------------------------------------------- off = legacy


def test_off_by_default_bit_exact(pkg):
    coord, _ = _coord(pkg, enabled=False)
    try:
        sql = "select count(*) as c from tpch.tiny.region"
        h0 = pkg.registry.counter("result_cache.hits").total
        m0 = pkg.registry.counter("result_cache.misses").total
        for _ in range(2):
            q = _run(coord, sql)
            assert q.rows == [[5]]
            assert q.stats.result_cache == ""
            assert q.stats.to_dict()["result_cache"] == {
                "status": "", "age_ms": 0.0, "snapshot": "",
                "mview_rewritten": "",
            }
        assert pkg.registry.counter("result_cache.hits").total == h0
        assert pkg.registry.counter("result_cache.misses").total == m0
        assert coord.result_cache.stats()["entries"] == 0
        assert _batch_keys(pkg, coord) == []
    finally:
        coord.shutdown()


# -------------------------------------------------------- hit/miss flow


def test_hit_zero_dispatch_and_distinct_literal_keys(pkg):
    coord, mem = _coord(pkg)
    try:
        _events(pkg, coord.local, mem)
        sql1 = "select sum(v) as s from mem.default.ev where k = 1"
        sql2 = "select sum(v) as s from mem.default.ev where k = 2"
        q1 = _run(coord, sql1)
        assert q1.stats.result_cache == "miss"
        assert q1.rows == [[30]]
        d0 = pkg.device()["dispatches"]
        q2 = _run(coord, sql1)
        assert pkg.device()["dispatches"] == d0
        assert q2.stats.result_cache == "hit"
        assert q2.stats.result_cache_age_ms >= 0.0
        assert q2.stats.result_cache_snapshot
        assert q2.rows == q1.rows
        assert q2.stats.output_rows == 1
        q3 = _run(coord, sql2)
        assert q3.stats.result_cache == "miss"
        assert q3.rows == [[5]]
        st = coord.result_cache.stats()
        assert st["entries"] == 2
        assert st["hits"] == 1 and st["misses"] == 2
        assert st["bytes"] > 0
    finally:
        coord.shutdown()


def test_non_cacheable_system_scan_never_stored(pkg):
    coord, _ = _coord(pkg)
    try:
        for _ in range(2):
            q = _run(coord, "select node_id from system.runtime.nodes")
            assert q.stats.result_cache == "miss"
        assert coord.result_cache.stats()["entries"] == 0
    finally:
        coord.shutdown()


# --------------------------------------------------------- invalidation


def test_insert_invalidates_strict_session_never_stale(pkg):
    coord, mem = _coord(pkg)
    try:
        _events(pkg, coord.local, mem)
        sql = "select sum(v) as s from mem.default.ev"
        assert _run(coord, sql).rows == [[42]]
        assert _run(coord, sql).stats.result_cache == "hit"
        _run(coord, "insert into mem.default.ev values (9, 100)")
        q = _run(coord, sql)
        assert q.stats.result_cache == "miss"
        assert q.rows == [[142]]
    finally:
        coord.shutdown()


def test_ingest_commit_bounded_staleness_contract(pkg):
    """An ingest commit lands; a bounded-stale session may see the
    pre-commit result only within its bound, never beyond it."""
    coord, mem = _coord(pkg, result_cache_max_staleness_s=0.5)
    try:
        tmp = tempfile.mkdtemp(prefix="rc-wal-")
        _events(pkg, coord.local, mem)
        ing = pkg.ing.IngestManager(coord.local, tmp, start_thread=False)
        sql = "select sum(v) as s from mem.default.ev"
        assert _run(coord, sql).rows == [[42]]
        ing.append("mem.default.ev", columns={"k": [5], "v": [58]})
        ing.commit_tick()
        q_stale = _run(coord, sql)
        assert q_stale.stats.result_cache == "stale"
        assert q_stale.rows == [[42]]
        assert coord.result_cache.stats()["stale_served"] == 1
        time.sleep(0.6)  # past the bound
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            q = _run(coord, sql)
            assert q.rows == [[100]], "pre-commit rows beyond the bound"
            if q.stats.result_cache == "hit":
                break
            time.sleep(0.05)
        assert q.stats.result_cache == "hit"
        ing.close(final_flush=False)
    finally:
        coord.shutdown()


def test_stale_serve_spawns_one_refresh_then_hits_fresh(pkg):
    coord, mem = _coord(pkg, result_cache_max_staleness_s=30.0)
    try:
        _events(pkg, coord.local, mem)
        sql = "select sum(v) as s from mem.default.ev"
        _run(coord, sql)
        _run(coord, "insert into mem.default.ev values (4, 8)")
        q = _run(coord, sql)
        assert q.stats.result_cache == "stale"
        assert q.rows == [[42]]
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if coord.result_cache.stats()["refreshes"] == 1:
                break
            time.sleep(0.05)
        assert coord.result_cache.stats()["refreshes"] == 1
        q2 = _run(coord, sql)
        assert q2.stats.result_cache == "hit"
        assert q2.rows == [[50]]
    finally:
        coord.shutdown()


# ----------------------------------------------------- microbatch x cache


def test_microbatch_first_round_populates_second_all_hits(pkg):
    coord, _ = _coord(pkg)
    try:
        _run(coord, "execute point using 3", PREPARED)
        vals = [5, 118, 700, 42, 1499, 12]
        sqls = [f"execute point using {v}" for v in vals]
        coord.local.session.set("microbatch_wait_ms", 10_000.0)
        coord.local.session.set("microbatch_max", len(vals))
        qs1 = _submit_concurrent(coord, sqls, PREPARED)
        for q, v in zip(qs1, vals):
            assert q.state == "FINISHED", q.error
            assert q.stats.result_cache == "miss"
            assert q.stats.batched
            assert q.rows[0][0] == v
        assert coord.result_cache.stats()["entries"] == len(vals) + 1
        assert _batch_keys(pkg, coord)
        d0 = pkg.device()["dispatches"]
        b0 = pkg.registry.counter("serving.batches").total
        qs2 = _submit_concurrent(coord, sqls, PREPARED)
        assert pkg.device()["dispatches"] == d0
        assert pkg.registry.counter("serving.batches").total == b0
        for q1, q2 in zip(qs1, qs2):
            assert q2.state == "FINISHED", q2.error
            assert q2.stats.result_cache == "hit"
            assert q2.rows == q1.rows
    finally:
        coord.shutdown()


def test_hot_fingerprint_collapses_to_one_execution(pkg):
    coord, _ = _coord(pkg)
    try:
        _run(coord, "execute point using 3", PREPARED)
        coord.local.session.set("microbatch_wait_ms", 10_000.0)
        coord.local.session.set("microbatch_max", 8)
        sqls = ["execute point using 77"] * 8
        qs = _submit_concurrent(coord, sqls, PREPARED)
        for q in qs:
            assert q.state == "FINISHED", q.error
            assert q.rows == [[77, "Customer#000000077", 2949.62]]
        # one resident entry for the hot key (beside the warmup's)
        assert coord.result_cache.stats()["entries"] == 2
        d0 = pkg.device()["dispatches"]
        qs2 = _submit_concurrent(coord, sqls, PREPARED)
        assert pkg.device()["dispatches"] == d0
        assert all(q.stats.result_cache == "hit" for q in qs2)
    finally:
        coord.shutdown()


# ------------------------------------------------------- a coordinator dies


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


def test_kill_coordinator_failover_starts_cold(pkg, tmp_path):
    """Cached results never survive a coordinator's death: each package
    fails over to a peer through its lease plane, and the survivor
    starts COLD, serves the statement from a miss, and hits after."""
    from presto_tpu_torch.utils import faults as port_faults

    sql = "select count(*) as c from tpch.tiny.region"
    ctl = str(tmp_path / "ctl")
    ports = _free_ports(2)
    uris = [f"http://127.0.0.1:{p}" for p in ports]
    coords = []
    for i in range(2):
        cfg = pkg.NodeConfig({
            "node.id": f"coord-{i}",
            "coordinator.journal-path": ctl,
            "coordinator.peers": ",".join(
                u for j, u in enumerate(uris) if j != i
            ),
            "lease.ttl-s": "0.6",
            "result-cache.enabled": "true",
        })
        coords.append(pkg.Coord(port=ports[i], config=cfg, **pkg.kw).start())
    c0, c1 = coords
    try:
        assert _run(c0, sql).stats.result_cache == "miss"
        assert _run(c0, sql).stats.result_cache == "hit"
        assert c0.result_cache.stats()["entries"] == 1
        c0._fault_kill()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and c1.failover_claims < 1:
            time.sleep(0.05)
        assert c1.failover_claims >= 1
        survivor = c1
        assert survivor.result_cache.stats()["entries"] == 0
        q = _run(survivor, sql)
        assert q.stats.result_cache == "miss" and q.rows == [[5]]
        assert _run(survivor, sql).stats.result_cache == "hit"
    finally:
        ref_faults.configure(None)
        port_faults.configure(None)
        for c in coords:
            try:
                c.shutdown()
            except Exception:
                pass


# -------------------------------------------------- eviction / budget


def test_lru_eviction_byte_budget_and_pool_mirror(pkg):
    runner, mem = _mem_runner(pkg)
    _events(pkg, runner, mem)
    pool = pkg.Pool(1 << 20)
    rc = pkg.rc.ResultCache(runner, budget_bytes=3000, pool=pool)
    keys = []
    for i in range(12):
        stmt = pkg.parse(
            f"select sum(v) as s from mem.default.ev where k = {i}"
        )
        key = pkg.rc.statement_key(stmt, runner.session)
        plan, _h, _k = runner.plan_cached_keyed(stmt)
        res = runner.execute_plan(plan)
        handles = pkg.canonical.plan_handles(plan)
        assert rc.put(key, stmt, res.columns, res.rows(), handles)
        keys.append(key)
        assert rc.bytes <= rc.budget_bytes
        assert pool.used_bytes("result-cache") == rc.bytes
    st = rc.stats()
    assert st["evictions"] > 0
    assert st["entries"] < 12
    assert rc.get(keys[0]) is None
    assert rc.get(keys[-1]) is not None
    rc.clear()
    assert rc.bytes == 0
    assert pool.used_bytes("result-cache") == 0


def test_oversized_entry_skipped_never_thrashes(pkg):
    runner, mem = _mem_runner(pkg)
    _events(pkg, runner, mem)
    rc = pkg.rc.ResultCache(runner, budget_bytes=3000)
    stmt = pkg.parse("select k, v from mem.default.ev")
    key = pkg.rc.statement_key(stmt, runner.session)
    plan, _h, _k = runner.plan_cached_keyed(stmt)
    handles = pkg.canonical.plan_handles(plan)
    big = [[i, "x" * 64] for i in range(50)]  # > budget // 8
    assert not rc.put(key, stmt, ("k", "v"), big, handles)
    assert rc.stats()["entries"] == 0 and rc.bytes == 0


# ------------------------------------------------------- observability


def test_runtime_views_explain_and_jsonl_events(pkg, tmp_path):
    coord, mem = _coord(pkg)
    path = tmp_path / "events.jsonl"
    coord.local.history.add_listener(pkg.Jsonl(str(path)))
    try:
        _events(pkg, coord.local, mem)
        sql = "select sum(v) as s from mem.default.ev"
        _run(coord, sql)
        hit = _run(coord, sql)
        rows = coord.local.execute(
            "select cache, entries, hits, misses from system.runtime.caches"
        ).rows()
        by_name = {r[0]: r for r in rows}
        assert "result.cache" in by_name
        assert by_name["result.cache"][1] == 1
        assert by_name["result.cache"][2] >= 1
        qrows = coord.local.execute(
            "select query_id, cached from system.runtime.queries"
        ).rows()
        assert hit.stats.query_id in {qid for qid, c in qrows if c}
        text = pkg.render(hit.stats)
        assert "result cache: HIT (snapshot" in text
        assert "age" in text
        recs = [json.loads(line) for line in path.read_text().splitlines()]
        for rec in recs:
            for field in (
                "event", "query_id", "state", "elapsed_ms", "planning_ms",
                "execution_ms", "input_rows", "output_rows", "operators",
                "stages", "peak_memory_bytes",
            ):
                assert field in rec, field
            assert set(rec["result_cache"]) == {
                "status", "age_ms", "snapshot", "mview_rewritten",
            }
        assert any(r["result_cache"]["status"] == "hit" for r in recs)
    finally:
        coord.shutdown()


def test_metrics_families_move(pkg):
    coord, mem = _coord(pkg)
    try:
        _events(pkg, coord.local, mem)
        h0 = pkg.registry.counter("result_cache.hits").total
        m0 = pkg.registry.counter("result_cache.misses").total
        b0 = pkg.registry.counter("result_cache.bytes").total
        sql = "select count(*) as c from mem.default.ev"
        _run(coord, sql)
        _run(coord, sql)
        assert pkg.registry.counter("result_cache.hits").total == h0 + 1
        assert pkg.registry.counter("result_cache.misses").total == m0 + 1
        assert pkg.registry.counter("result_cache.bytes").total > b0
    finally:
        coord.shutdown()


def test_prepared_header_absorbed_once_and_memoized(pkg):
    coord = pkg.Coord(**pkg.kw).start()
    try:
        client = pkg.Client(coord.uri, timeout_s=120)
        encodes = []
        real_encode = pkg.protocol.encode_prepared

        def counting_encode(name, text):
            encodes.append(name)
            return real_encode(name, text)

        pkg.protocol.encode_prepared = counting_encode
        try:
            client.execute(f"prepare point from {POINT}")
            assert client.prepared == {"point": POINT}
            assert encodes.count("point") == 1
            for v in (3, 7, 11):
                rows = client.execute(f"execute point using {v}").rows()
                assert rows and rows[0][0] == v
            hdr = client._prepared_header
            assert hdr is not None
            assert encodes.count("point") == 2
            before = list(encodes)
            client.execute("execute point using 42")
            assert encodes == before
            assert client._prepared_header is hdr
        finally:
            pkg.protocol.encode_prepared = real_encode
    finally:
        coord.shutdown()

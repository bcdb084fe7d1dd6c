"""The port's fragment schedulers over the worker<->worker data plane, on
the CPU, against the JAX reference's cluster.

One module-scoped port cluster (a coordinator and two workers,
``device="cpu"``) runs beside one module-scoped reference cluster of the
same shape. Q1, Q3 (broadcast, and forced partitioned) and Q18 give the
reference cluster's rows (doubles within rel 1e-9) and the same stages
with the same task counts. The port's cluster then covers what the
reference's ``tests/test_shuffle.py``, ``test_dynfilter.py`` and
``test_adaptive.py`` cover on their default path: the shuffled keyed
aggregation with pipelined source attachment, the partitioned join
(forced, chosen from stats, and a semi join), the ordered MERGE
exchange and TopN, the dynamic-filter summary stage with split pruning,
the adaptive broadcast<->partitioned switch, the session flag that
disables the shuffle, and the refused lakehouse settings. The
micro-batch, result-cache and ingest settings, refused by the server's
first slice, the retry-policy, spool, journal and peer settings, refused
until fault-tolerant execution was ported, and the ICI settings, refused
until the in-slice lane was ported, are accepted now and act (the same
cases).
"""

from __future__ import annotations

import math
import time

import pytest

from presto_tpu.server import CoordinatorServer as RefCoordinator
from presto_tpu.server import PrestoTpuClient as RefClient
from presto_tpu.server import WorkerServer as RefWorker
from presto_tpu.verifier import SqliteOracle, verify_query
from presto_tpu_torch.connectors import create_connector
from presto_tpu_torch.connectors.spi import RangeSet, SplitSource
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec.staging import CatalogManager
from presto_tpu_torch.server import (
    CoordinatorServer,
    PrestoTpuClient,
    WorkerServer,
)
from presto_tpu_torch.server import coordinator as coord_mod
from presto_tpu_torch.server import rpc
from presto_tpu_torch.server import worker as worker_mod
from presto_tpu_torch.server.client import QueryFailed
from presto_tpu_torch.server.protocol import FragmentSpec
from presto_tpu_torch.session import NodeConfig
from presto_tpu_torch.utils.metrics import REGISTRY
from tpch_queries import QUERIES
from torch_parity import one_torch_thread  # noqa: F401

DOUBLE_RTOL = 1e-9


def _wait_workers(coord, n, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if len(coord.active_workers()) >= n:
            return
        time.sleep(0.02)
    raise TimeoutError("workers not discovered")


class PrunableTpch(TpchConnector):
    """tpch whose ``orders`` and ``lineitem`` splits prune by an order
    key constraint, as a parquet row group's min/max statistics would:
    both tables are generated in order-key order, so each split covers
    one key interval."""

    KEYS = {"orders": "o_orderkey", "lineitem": "l_orderkey"}

    def get_splits(self, handle, target_split_rows=1 << 20, constraint=()):
        splits = super().get_splits(handle, target_split_rows).next_batch(
            1 << 30
        )
        key = self.KEYS.get(handle.table)
        wanted = dict(constraint).get(key)
        if wanted is None:
            return SplitSource(splits)
        kept = []
        for s in splits:
            keys = self.create_page_source(s, [key])[key]
            if len(keys) == 0:
                continue
            lo, hi = int(keys.min()), int(keys.max())
            if isinstance(wanted, RangeSet):
                hit = wanted.lo <= hi and wanted.hi >= lo
            else:
                hit = any(lo <= int(v) <= hi for v in wanted)
            if hit:
                kept.append(s)
        return SplitSource(kept)


def _catalogs(mem):
    c = CatalogManager()
    c.register("tpch", create_connector("tpch"))
    c.register("prunable", PrunableTpch())
    c.register("mem", mem)
    return c


@pytest.fixture(scope="module")
def cluster():
    mem = create_connector("memory")
    coord = CoordinatorServer(catalogs=_catalogs(mem), device="cpu").start()
    workers = [
        WorkerServer(
            coordinator_uri=coord.uri, catalogs=_catalogs(mem), device="cpu"
        ).start()
        for _ in range(2)
    ]
    _wait_workers(coord, 2)
    yield coord, workers
    for w in workers:
        w.shutdown(graceful=False)
    coord.shutdown()


@pytest.fixture(scope="module")
def client(cluster):
    coord, _ = cluster
    return PrestoTpuClient(coord.uri, timeout_s=300)


@pytest.fixture(scope="module")
def ref_cluster():
    coord = RefCoordinator().start()
    workers = [RefWorker(coordinator_uri=coord.uri).start() for _ in range(2)]
    _wait_workers(coord, 2)
    yield coord, RefClient(coord.uri, timeout_s=300)
    for w in workers:
        w.shutdown(graceful=False)
    coord.shutdown()


@pytest.fixture(scope="module")
def oracle():
    return SqliteOracle("tiny")


def _stage_shape(coord, qid):
    """(stage kind, task count) per stage of one query, in order."""
    return [(s.kind, len(s.tasks)) for s in coord.queries[qid].stats.stages]


def assert_rows_equal(got, want, rtol: float = DOUBLE_RTOL):
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                assert math.isclose(a, b, rel_tol=rtol, abs_tol=1e-12), (g, w)
            else:
                assert a == b, (g, w)


_AGAINST_REFERENCE = {
    "q1": (None, QUERIES[1]),
    "q3": (None, QUERIES[3]),
    "q3_partitioned": ("PARTITIONED", QUERIES[3]),
    "q18": (None, QUERIES[18]),
}


@pytest.mark.parametrize("name", sorted(_AGAINST_REFERENCE))
def test_matches_the_reference_cluster(cluster, client, ref_cluster, name):
    coord, _ = cluster
    ref_coord, ref_client = ref_cluster
    jdt, sql = _AGAINST_REFERENCE[name]
    runs = []
    for c, cl in ((coord, client), (ref_coord, ref_client)):
        if jdt:
            cl.execute(f"set session join_distribution_type = '{jdt}'")
        try:
            res = cl.execute(sql)
        finally:
            if jdt:
                cl.execute("set session join_distribution_type = 'AUTOMATIC'")
        runs.append((res.rows(), _stage_shape(c, res.query_id)))
    (rows, shape), (ref_rows, ref_shape) = runs
    assert_rows_equal(rows, ref_rows)
    assert shape == ref_shape
    assert sum(n for _, n in shape) > 2


def _counter(name: str) -> int:
    return REGISTRY.counter(name).total


def test_keyed_agg_takes_shuffle_path(client, oracle):
    """String + numeric group keys: partitioning hashes VALUES (each
    producer's dictionaries differ), and the result is oracle-exact."""
    before = _counter("coordinator.shuffled_stages")
    http0 = _counter("exchange.http_shuffle_bytes")
    sql = (
        "select l_returnflag, l_linestatus, sum(l_quantity) as q, "
        "count(*) as n from tpch.tiny.lineitem "
        "group by l_returnflag, l_linestatus "
        "order by l_returnflag, l_linestatus"
    )
    assert verify_query(client, oracle, sql, rel_tol=1e-6) is None
    assert _counter("coordinator.shuffled_stages") > before
    assert _counter("exchange.http_shuffle_bytes") > http0


def test_high_cardinality_keys_shuffled(client, oracle):
    before = _counter("coordinator.shuffled_stages")
    sql = (
        "select l_orderkey, sum(l_extendedprice) as v "
        "from tpch.tiny.lineitem group by l_orderkey "
        "order by v desc, l_orderkey limit 20"
    )
    assert verify_query(client, oracle, sql, rel_tol=1e-6) is None
    assert _counter("coordinator.shuffled_stages") > before


def test_merge_tasks_ran_on_workers(client):
    before = _counter("worker.merge_tasks")
    client.execute(
        "select o_orderpriority, count(*) as n from tpch.tiny.orders "
        "group by o_orderpriority order by o_orderpriority"
    )
    assert _counter("worker.merge_tasks") - before >= 2


def test_session_flag_disables_shuffle(client, oracle):
    client.execute("set session distributed_final = false")
    try:
        before = _counter("coordinator.shuffled_stages")
        sql = (
            "select o_orderstatus, count(*) as n from tpch.tiny.orders "
            "group by o_orderstatus order by o_orderstatus"
        )
        assert verify_query(client, oracle, sql, rel_tol=1e-6) is None
        assert _counter("coordinator.shuffled_stages") == before
    finally:
        client.execute("set session distributed_final = true")


def test_pipelined_source_attachment(client, oracle, monkeypatch):
    """Merge tasks exist before the producers finish: producers are
    announced one by one and the set is sealed once."""
    events = []
    orig = worker_mod._Task.add_sources

    def spy(self, sources, done):
        sources = list(sources)
        events.append((len(sources), bool(done)))
        return orig(self, sources, done)

    monkeypatch.setattr(worker_mod._Task, "add_sources", spy)
    sql = (
        "select l_shipmode, count(*) as n from tpch.tiny.lineitem "
        "group by l_shipmode order by l_shipmode"
    )
    assert verify_query(client, oracle, sql, rel_tol=1e-6) is None
    assert [e for e in events if not e[1] and e[0] > 0]
    assert [e for e in events if e[1]]


def test_global_agg_skips_shuffle(client, oracle):
    before = _counter("coordinator.shuffled_stages")
    sql = (
        "select count(*) as n, sum(l_quantity) as q from tpch.tiny.lineitem"
    )
    assert verify_query(client, oracle, sql, rel_tol=1e-6) is None
    assert _counter("coordinator.shuffled_stages") == before


_JOIN_SQL = (
    "select o_orderpriority, count(*) as c, sum(l_quantity) as q "
    "from tpch.tiny.lineitem join tpch.tiny.orders "
    "on l_orderkey = o_orderkey "
    "where l_shipdate >= date '1995-01-01' "
    "group by o_orderpriority order by o_orderpriority"
)


def test_partitioned_join_stage(cluster, client, oracle):
    coord, _ = cluster
    before = _counter("coordinator.partitioned_join_stages")
    client.execute("set session join_distribution_type = 'PARTITIONED'")
    try:
        res = client.execute(_JOIN_SQL)
    finally:
        client.execute("set session join_distribution_type = 'AUTOMATIC'")
    assert _counter("coordinator.partitioned_join_stages") > before
    kinds = [k for k, _ in _stage_shape(coord, res.query_id)]
    assert kinds.count("producer") >= 2 and "join" in kinds
    assert_rows_equal(res.rows(), coord.local.execute(_JOIN_SQL).rows())
    assert verify_query(coord.local, oracle, _JOIN_SQL) is None


def test_partitioned_join_auto_choice(cluster, client):
    """AUTOMATIC picks the partitioned stage from stats once both sides
    exceed the broadcast bound; at the default bound it replicates."""
    coord, _ = cluster
    before = _counter("coordinator.partitioned_join_stages")
    client.execute(_JOIN_SQL)
    assert _counter("coordinator.partitioned_join_stages") == before
    client.execute("set session join_max_broadcast_rows = 1000")
    try:
        res = client.execute(_JOIN_SQL)
    finally:
        client.execute("set session join_max_broadcast_rows = 2097152")
    assert _counter("coordinator.partitioned_join_stages") > before
    assert_rows_equal(res.rows(), coord.local.execute(_JOIN_SQL).rows())


def test_partitioned_join_semi(cluster, client, oracle):
    coord, _ = cluster
    before = _counter("coordinator.partitioned_join_stages")
    sql = (
        "select count(*) as c from tpch.tiny.orders "
        "where o_orderkey in (select l_orderkey from "
        "tpch.tiny.lineitem where l_quantity > 45)"
    )
    client.execute("set session join_distribution_type = 'PARTITIONED'")
    try:
        res = client.execute(sql)
    finally:
        client.execute("set session join_distribution_type = 'AUTOMATIC'")
    assert _counter("coordinator.partitioned_join_stages") > before
    assert res.rows() == coord.local.execute(sql).rows()
    assert verify_query(coord.local, oracle, sql) is None


@pytest.mark.parametrize("limit", ["", " limit 17"], ids=["order_by", "topn"])
def test_ordered_merge_exchange(cluster, client, monkeypatch, limit):
    """A root ORDER BY over a cut-free fragment: workers emit sorted
    runs (TopN truncates each run) and the gather k-way merges them."""
    coord, _ = cluster
    calls = []
    orig = coord_mod._merge_sorted_runs

    def spy(payloads, schema, sort_node):
        calls.append(len(payloads))
        return orig(payloads, schema, sort_node)

    monkeypatch.setattr(coord_mod, "_merge_sorted_runs", spy)
    sql = (
        "select o_orderkey, o_orderdate, o_totalprice from tpch.tiny.orders "
        "where o_totalprice > 300000 "
        "order by o_totalprice desc, o_orderkey" + limit
    )
    res = client.execute(sql)
    assert calls and calls[0] >= 2
    assert [k for k, _ in _stage_shape(coord, res.query_id)] == ["source"]
    assert_rows_equal(res.rows(), _wire(coord.local.execute(sql).rows()))


def _wire(rows):
    return [
        tuple(str(v) if hasattr(v, "isoformat") else v for v in r)
        for r in rows
    ]


_DF_SQL = (
    "select count(*) as n, sum(l_extendedprice) as s "
    "from prunable.tiny.lineitem join prunable.tiny.orders "
    "on l_orderkey = o_orderkey "
    "where o_orderkey < 800 and o_totalprice > 1000"
)


def test_dynamic_filter_summary_prunes_splits(cluster, client):
    """The build side runs first as a summary stage; its merged summary
    becomes a fused probe filter and a split constraint that skips the
    probe's splits outside the build's key range."""
    coord, _ = cluster
    built0 = _counter("dynamic_filter.built")
    pruned0 = _counter("dynamic_filter.splits_pruned")
    res = client.execute(_DF_SQL)
    q = coord.queries[res.query_id]
    kinds = [k for k, _ in _stage_shape(coord, res.query_id)]
    assert kinds[0] == "dynfilter"
    assert _counter("dynamic_filter.built") > built0
    assert _counter("dynamic_filter.splits_pruned") > pruned0
    assert q.stats.dynamic_filter_splits_pruned > 0
    assert q.stats.dynamic_filters > 0
    client.execute("set session enable_dynamic_filtering = false")
    try:
        off = client.execute(_DF_SQL)
    finally:
        client.execute("set session enable_dynamic_filtering = true")
    assert "dynfilter" not in [
        k for k, _ in _stage_shape(coord, off.query_id)
    ]
    assert_rows_equal(res.rows(), off.rows())
    assert_rows_equal(res.rows(), coord.local.execute(_DF_SQL).rows())


@pytest.fixture(scope="module")
def skewed(client):
    """Memory tables whose estimates miss: ``skew`` passes every row of
    f = 7 where the classic estimate says 10%, ``big`` matches nothing
    where it says 10%."""
    client.execute(
        "create table mem.default.skew as "
        "select o_orderkey as k, 7 as f from tpch.tiny.orders"
    )
    client.execute(
        "create table mem.default.big as "
        "select l_orderkey as k, l_linenumber as v from tpch.tiny.lineitem"
    )


def _adaptive(coord, client, sql):
    """``sql`` with adaptive execution off, then on (broadcast bound
    2000, page capacity 8192, as the reference's test sets them)."""
    s = coord.local.session
    saved = {
        k: s.get(k) for k in ("join_max_broadcast_rows", "page_capacity")
    }
    s.set("join_max_broadcast_rows", "2000")
    s.set("page_capacity", "8192")
    try:
        off = client.execute(sql)
        s.set("adaptive_enabled", "true")
        on = client.execute(sql)
    finally:
        s.set("adaptive_enabled", "false")
        for k, v in saved.items():
            s.set(k, v)
    return off, on, coord.queries[on.query_id]


def test_adaptive_switch_broadcast_to_partitioned(cluster, client, skewed):
    coord, _ = cluster
    sql = (
        "select count(*) as n, sum(l.l_extendedprice) as s "
        "from tpch.tiny.lineitem l join mem.default.skew s "
        "on l.l_orderkey = s.k where s.f = 7"
    )
    sw0 = _counter("adaptive.strategy_switches")
    off, on, q = _adaptive(coord, client, sql)
    assert_rows_equal(on.rows(), off.rows())
    assert _counter("adaptive.strategy_switches") == sw0 + 1
    note = next(
        n for n in q.stats.adaptive_notes if "SWITCHED broadcast" in n
    )
    assert "parts 2" in note  # resized to the observed 15000 rows
    kinds = [s.kind for s in q.stats.stages]
    assert "dynfilter" in kinds and "join" in kinds


def test_adaptive_switch_partitioned_to_broadcast(cluster, client, skewed):
    coord, _ = cluster
    sql = (
        "select count(*) as n from tpch.tiny.lineitem l "
        "join mem.default.big b on l.l_orderkey = b.k where b.v = 999999"
    )
    pj0 = _counter("coordinator.partitioned_join_stages")
    sw0 = _counter("adaptive.strategy_switches")
    off, on, q = _adaptive(coord, client, sql)
    assert on.rows() == off.rows() == [(0,)]
    # off ran it partitioned as estimated; on went back to broadcast
    assert _counter("coordinator.partitioned_join_stages") == pj0 + 1
    assert _counter("adaptive.strategy_switches") == sw0 + 1
    assert any(
        "SWITCHED partitioned→broadcast" in n for n in q.stats.adaptive_notes
    )


# ------------------------------------------------- refused later planes


#: key -> value: every plane a later slice ported; each case
#: turns it on and checks that it acts (``_check_plane_acts``).
#: ``ingest.wal-path``, ``exchange.spool-path``,
#: ``coordinator.journal-path`` and ``lakehouse.path`` take a temporary
#: directory
_REFUSED_CONFIG = {
    "exchange.ici-enabled": "true",
    "retry-policy": "TASK",
    "exchange.spool-path": "",
    "coordinator.journal-path": "",
    "coordinator.peers": "http://127.0.0.1:1",
    "serving.microbatch-wait-ms": "5000",
    "result-cache.enabled": "true",
    "ingest.wal-path": "",
    "lakehouse.path": "",
    "lakehouse.target-file-bytes": "64MB",
    "qos.enabled": "true",
    "pool.max-workers": "2",
}

POINT = (
    "select c_custkey, c_name from tpch.tiny.customer where c_custkey = ?"
)


def _check_plane_acts(key, value, tmp_path):
    """A key of a ported plane on a worker-less coordinator: accepted,
    and its plane acts (two concurrent EXECUTEs share one batch; a
    repeated SELECT is a cache hit; a POSTed batch is committed and
    read; a query runs under the retry policy; the spool has its
    ``runtime.caches`` row; a query's submit and finish frames replay
    closed; the peer lease is published; a POSTed row is committed through
    a lakehouse manifest snapshot and read back from it; a query is
    admitted by its QoS lane; the autoscaler spawns a worker that announces itself; two
    co-located workers exchange a shuffled aggregation in the slice)."""
    import json
    import os
    import threading
    import urllib.request

    from presto_tpu_torch.server.journal import CoordinatorJournal

    if key in (
        "ingest.wal-path", "exchange.spool-path", "coordinator.journal-path"
    ):
        value = str(tmp_path)
    settings = {key: value}
    if key.startswith("lakehouse."):
        # the tee rides the ingest lane
        settings["lakehouse.path"] = str(tmp_path / "lake")
        settings["ingest.wal-path"] = str(tmp_path / "wal")
    if key == "coordinator.peers":
        # the lease plane lives beside the journals it fails over
        settings["coordinator.journal-path"] = str(tmp_path)
        settings["node.id"] = "coord-a"
    catalogs = CatalogManager()
    catalogs.register("tpch", create_connector("tpch"))
    catalogs.register("mem", create_connector("memory"))
    coord = CoordinatorServer(
        config=NodeConfig(settings), catalogs=catalogs, device="cpu"
    ).start()
    sql = "select count(*) as c from tpch.tiny.nation"
    try:
        if key == "retry-policy":
            # a distributed query carries the policy (one worker)
            w = WorkerServer(coordinator_uri=coord.uri, device="cpu").start()
            try:
                _wait_workers(coord, 1)
                q = coord.submit(sql)
                assert q.done.wait(60) and q.rows == [[25]]
                assert q.stats.retry_policy == "TASK"
            finally:
                w.shutdown(graceful=False)
        elif key == "exchange.ici-enabled":
            assert coord.local.session.get("exchange_ici_enabled") is True
            ws = [
                WorkerServer(coordinator_uri=coord.uri, device="cpu").start()
                for _ in range(2)
            ]
            try:
                _wait_workers(coord, 2)
                edges = _counter("exchange.ici_edges")
                agg = (
                    "select l_returnflag, count(*) as n "
                    "from tpch.tiny.lineitem group by l_returnflag "
                    "order by l_returnflag"
                )
                q = coord.submit(agg)
                assert q.done.wait(60)
                assert [tuple(r) for r in q.rows] == [
                    tuple(r) for r in coord.local.execute(agg).rows()
                ]
                assert q.stats.exchange_ici_edges > 0
                assert _counter("exchange.ici_edges") > edges
            finally:
                for w in ws:
                    w.shutdown(graceful=False)
        elif key == "exchange.spool-path":
            assert coord.spool is not None and coord.spool.path == value
            rows = coord.local.execute(
                "select cache from system.runtime.caches"
            ).rows()
            assert ("exchange.spool",) in rows
        elif key == "coordinator.journal-path":
            q = coord.submit(sql)
            assert q.done.wait(60) and q.rows == [[25]]
            assert coord.journal is not None
            assert os.listdir(value)
            state = CoordinatorJournal(value).replay()
            assert state.open == []  # submitted, then finished
        elif key == "qos.enabled":
            assert coord.qos is not None
            q = coord.submit(sql)
            assert q.done.wait(60) and q.rows == [[25]]
            assert coord.query_info(q)["qos"]["group"] == "default"
            rows = coord.local.execute(
                'select "group", queries from system.runtime.qos'
            ).rows()
            assert ("default", 1) in rows
        elif key == "pool.max-workers":
            from presto_tpu_torch.server.launcher import (
                LocalWorkerPoolProvider,
            )

            assert coord._pool_cfg["max_workers"] == 2
            prov = LocalWorkerPoolProvider(coord.uri, device="cpu")
            try:
                coord.attach_pool(prov, min_workers=1, interval_s=0.05)
                _wait_workers(coord, 1, timeout=30)
                (w,) = coord.active_workers()
                assert w.preemptible and w.node_id in prov.workers
                assert coord.pool_decision
                q = coord.submit(sql)
                assert q.done.wait(60) and q.rows == [[25]]
            finally:
                coord.autoscaler.stop()
                for w in list(prov.workers.values()):
                    w.shutdown(graceful=False)
        elif key == "coordinator.peers":
            assert coord.lease is not None
            assert coord.lease.read_lease("coord-a").uri == coord.uri
            assert coord.journal.path == os.path.join(
                str(tmp_path), "coord-a"
            )
        elif key == "serving.microbatch-wait-ms":
            assert coord.local.session.get("microbatch_wait_ms") == 5000.0
            coord.local.session.set("microbatch_max", 2)
            prepared = {"p": POINT}
            qs = [None, None]

            def run(i):
                q = coord.submit(f"execute p using {7 + i}", prepared=prepared)
                q.done.wait(60)
                qs[i] = q

            threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert [q.rows[0][0] for q in qs] == [7, 8]
            assert all(q.stats.batched for q in qs)
        elif key == "result-cache.enabled":
            sql = "select count(*) as c from tpch.tiny.nation"
            status = []
            for _ in range(2):
                q = coord.submit(sql)
                q.done.wait(60)
                assert q.rows == [[25]]
                status.append(q.stats.result_cache)
            assert status == ["miss", "hit"]
        elif key.startswith("lakehouse."):
            pytest.importorskip("pyarrow")
            store = coord.ingest.store
            assert store is not None
            if key == "lakehouse.target-file-bytes":
                assert store.target_file_bytes == 64 << 20
            coord.local.execute("create table mem.default.t (k bigint)")
            req = urllib.request.Request(
                coord.uri + "/v1/ingest/mem.default.t",
                data=json.dumps({"rows": [{"k": 4}], "commit": True}).encode(),
            )
            assert json.load(urllib.request.urlopen(req))["committed"]
            tk = ("mem", "default", "t")
            sid = store.current_sid(tk)
            assert sid is not None
            assert store.read_values(tk, sid) == {"k": [4]}
            rows = coord.local.execute(
                "select k from mem.default.t for version as of "
                f"{sid}"
            ).rows()
            assert rows == [(4,)]
            snaps = coord.local.execute(
                "select \"table\" from system.runtime.snapshots"
            ).rows()
            assert ("mem.default.t",) in snaps
        else:
            assert coord.ingest is not None
            coord.local.execute("create table mem.default.t (k bigint)")
            req = urllib.request.Request(
                coord.uri + "/v1/ingest/mem.default.t",
                data=json.dumps({"rows": [{"k": 4}], "commit": True}).encode(),
            )
            assert json.load(urllib.request.urlopen(req))["committed"]
            assert coord.local.execute(
                "select k from mem.default.t"
            ).rows() == [(4,)]
    finally:
        coord.shutdown()


@pytest.mark.parametrize("key", sorted(_REFUSED_CONFIG))
def test_coordinator_refuses_later_plane_config(key, tmp_path):
    value = _REFUSED_CONFIG[key]
    _check_plane_acts(key, value, tmp_path)


@pytest.mark.parametrize(
    "key,value",
    [("exchange.ici-enabled", "true"), ("exchange.spool-path", None),
     ("node.preemptible", "true")],
)
def test_worker_refuses_later_plane_config(key, value, tmp_path):
    """Every key is accepted and acts: the spool path (value None: a
    temporary directory), ported with fault-tolerant execution, builds
    the worker's spool and its tee drain; a preemptible worker reports
    the flag and drains on a preemption notice; two workers booted with
    the ICI key announce one slice and take a shuffled aggregation's
    edges in it."""
    if key == "exchange.ici-enabled":
        coord = CoordinatorServer(
            config=NodeConfig({key: value}), device="cpu"
        ).start()
        ws = [
            WorkerServer(
                coordinator_uri=coord.uri, config=NodeConfig({key: value}),
                device="cpu",
            ).start()
            for _ in range(2)
        ]
        try:
            _wait_workers(coord, 2)
            assert len({w.slice_id for w in coord.active_workers()}) == 1
            assert all(w.single_program for w in ws)
            edges = _counter("exchange.ici_edges")
            client = PrestoTpuClient(coord.uri, timeout_s=120)
            agg = (
                "select l_linestatus, count(*) as n from tpch.tiny.lineitem "
                "group by l_linestatus order by l_linestatus"
            )
            res = client.execute(agg)
            assert res.rows() == [
                tuple(r) for r in coord.local.execute(agg).rows()
            ]
            assert _counter("exchange.ici_edges") > edges
        finally:
            for w in ws:
                w.shutdown(graceful=False)
            coord.shutdown()
        return
    if key == "node.preemptible":
        w = WorkerServer(
            config=NodeConfig({key: value, "pool.preempt-grace-s": "0.5"}),
            device="cpu",
        ).start()
        try:
            assert w.preemptible and w._preempt_grace_s == 0.5
            assert w.status()["preemptible"] is True
            preemptions = REGISTRY.counter("pool.preemptions").total
            w.preempt()
            assert w._shutting_down
            assert REGISTRY.counter("pool.preemptions").total == (
                preemptions + 1
            )
        finally:
            w.shutdown(graceful=False)
        return
    if value is None:
        w = WorkerServer(
            config=NodeConfig({key: str(tmp_path)}), device="cpu"
        )
        try:
            assert w.spool is not None and w.spool.path == str(tmp_path)
            assert w.spool_drain is not None
        finally:
            w.shutdown(graceful=False)
        return
    raise AssertionError(f"no case for {key}")


def test_off_values_are_accepted_and_change_nothing(oracle):
    cfg = NodeConfig({
        "exchange.ici-enabled": "false",
        "exchange.single-program": "false",
        "retry-policy": "NONE",
        "serving.microbatch-wait-ms": "0",
        "result-cache.enabled": "false",
        "qos.enabled": "false",
    })
    coord = CoordinatorServer(config=cfg, device="cpu").start()
    w = WorkerServer(
        coordinator_uri=coord.uri, config=cfg, device="cpu"
    ).start()
    try:
        _wait_workers(coord, 1)
        client = PrestoTpuClient(coord.uri, timeout_s=120)
        sql = "select count(*) as c from tpch.tiny.orders"
        assert verify_query(client, oracle, sql) is None
    finally:
        w.shutdown(graceful=False)
        coord.shutdown()


@pytest.mark.parametrize(
    "setting,slice_word",
    [
        ("retry_policy = 'TASK'", None),
        ("retry_policy = 'QUERY'", None),
        ("microbatch_wait_ms = 5", None),
        ("enable_result_cache = true", None),
        # accepted since the in-slice lane was ported (the id kept)
        pytest.param(
            "exchange_ici_enabled = true", None,
            id="exchange_ici_enabled = true-ICI",
        ),
    ],
)
def test_set_session_refuses_later_planes(cluster, client, setting, slice_word):
    """A later plane's session value is refused and changes nothing; a
    ported plane's value (slice word None) is accepted and acts: the
    micro-batch window is set; with the result cache on a repeated
    distributed SELECT is a hit; a distributed query runs under the
    retry policy; with the ICI gate on a shuffled aggregation's edges
    stay in the slice. Each is restored afterwards."""
    coord, _ = cluster
    name = setting.split(" = ")[0]
    before = coord.local.session.get(name)
    if slice_word is not None:
        with pytest.raises(QueryFailed, match=slice_word):
            client.execute(f"set session {setting}")
        assert coord.local.session.get(name) == before
        return
    try:
        client.execute(f"set session {setting}")
        if name == "microbatch_wait_ms":
            assert coord.local.session.get(name) == 5.0
        elif name == "exchange_ici_enabled":
            assert coord.local.session.get(name) is True
            edges = _counter("exchange.ici_edges")
            http = _counter("exchange.http_shuffle_bytes")
            sql = (
                "select l_returnflag, l_linestatus, count(*) as n "
                "from tpch.tiny.lineitem group by l_returnflag, "
                "l_linestatus order by l_returnflag, l_linestatus"
            )
            res = client.execute(sql)
            assert res.rows() == [
                tuple(r) for r in coord.local.execute(sql).rows()
            ]
            assert _counter("exchange.ici_edges") > edges
            assert _counter("exchange.http_shuffle_bytes") == http
            assert client.query_info(res.query_id)["exchange"]["ici_edges"]
        elif name == "retry_policy":
            policy = setting.split("'")[1]
            assert coord.local.session.get(name) == policy
            res = client.execute(
                "select count(*) as c from tpch.tiny.orders"
            )
            assert res.rows() == [(15000,)]
            assert client.query_info(res.query_id)["retry_policy"] == policy
        else:
            assert coord.local.session.get(name) is True
            sql = "select count(*) as c from tpch.tiny.region"
            got = [client.execute(sql) for _ in range(2)]
            assert [r.rows() for r in got] == [[(5,)], [(5,)]]
            assert [
                coord.queries[r.query_id].stats.result_cache for r in got
            ] == ["miss", "hit"]
    finally:
        coord.local.session.set(name, before)


def test_worker_refuses_spooled_and_in_slice_tasks(cluster):
    """Both are accepted now: an in-slice task, ported with the ICI lane
    (planned on another slice than this worker's, so its edges would
    ride HTTP), and a spooled one, ported with fault-tolerant execution
    (this worker has no spool, so it tees nothing); each status
    answers."""
    _, workers = cluster
    policy = rpc.RpcPolicy(timeout_s=5.0, retries=0)
    spec = FragmentSpec(
        task_id="q_x.s.0.0", query_id="q_x", fragment=None,
        partition_scan=0, split_start=0, split_end=0, ici_slice="cuda-1",
    )
    rpc.call_json(
        "POST", workers[0].uri + "/v1/task", spec.to_json(), policy=policy
    )
    try:
        assert workers[0].tasks["q_x.s.0.0"].spec.ici_slice == "cuda-1"
        assert workers[0].slice_id != "cuda-1"
        st = rpc.call_json(
            "GET", workers[0].uri + "/v1/task/q_x.s.0.0/status",
            policy=policy,
        )
        assert st["task_id"] == "q_x.s.0.0"
    finally:
        rpc.call(
            "DELETE", workers[0].uri + "/v1/task/q_x.s.0.0", policy=policy
        )
    spec = FragmentSpec(
        task_id="q_x.s.1.0", query_id="q_x", fragment=None,
        partition_scan=0, split_start=0, split_end=0, spool=True,
    )
    rpc.call_json(
        "POST", workers[0].uri + "/v1/task", spec.to_json(), policy=policy
    )
    try:
        assert workers[0].tasks["q_x.s.1.0"]._spool is None
        st = rpc.call_json(
            "GET", workers[0].uri + "/v1/task/q_x.s.1.0/status",
            policy=policy,
        )
        assert st["spooled"] is False
    finally:
        rpc.call(
            "DELETE", workers[0].uri + "/v1/task/q_x.s.1.0", policy=policy
        )


def test_exchange_is_http_with_the_gate_off(cluster):
    """With the ICI gate at its default (off) the transport choice
    stays the HTTP wire: no spec carries a slice."""
    coord, workers = cluster
    from presto_tpu_torch import types as T

    assert all(w.slice_id for w in coord.active_workers())
    assert coord._select_transport(
        coord.active_workers(), schemas=({"k": T.BIGINT},)
    ) == ""

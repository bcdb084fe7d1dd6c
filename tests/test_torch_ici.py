"""The port's in-slice (ICI) exchange lane on the CPU: the cases of the
reference's ``tests/test_ici_exchange.py`` against the port's server.

The scheduler plans partitioned join, aggregation and distinct exchanges
between co-located workers (one announced slice) as device-page
transfers through the process's segment (``server/exchange_spi.py``):
no serialization and no HTTP on those edges, while cross-slice edges,
recovery and drain keep the serialized wire and the spool. Every
cluster here runs in one process on ``device="cpu"``. The answers are
held against the reference's ``LocalQueryRunner`` on the same tpch.tiny
data (doubles within rel 1e-9); the transport-selection rules, the spec
round trip and the page frames against the reference's own functions.
The bucket hash and the collective merge's pages are pinned in
``tests/test_torch_exchange.py``.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np
import pytest

from presto_tpu import types as RT
from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu.server import pages_wire as ref_wire
from presto_tpu.server import scheduler as ref_scheduler
from presto_tpu.server.protocol import FragmentSpec as RefSpec
from presto_tpu.plan import nodes as RN
from presto_tpu_torch import types as T
from presto_tpu_torch.parallel.exchange import MAX_ICI_PARTS
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.server import (
    CoordinatorServer,
    PrestoTpuClient,
    WorkerServer,
)
from presto_tpu_torch.server import exchange_spi, pages_wire, rpc, task_ids
from presto_tpu_torch.server import scheduler
from presto_tpu_torch.server.protocol import FragmentSpec
from presto_tpu_torch.session import NodeConfig
from presto_tpu_torch.utils import faults
from presto_tpu_torch.utils.metrics import REGISTRY
from torch_parity import DOUBLE_RTOL
from torch_parity import one_torch_thread  # noqa: F401

JOIN_SQL = (
    "select o_orderpriority, count(*) as n, "
    "sum(l_extendedprice) as v "
    "from tpch.tiny.orders, tpch.tiny.lineitem "
    "where o_orderkey = l_orderkey "
    "group by o_orderpriority order by o_orderpriority"
)
AGG_SQL = (
    "select l_returnflag, l_linestatus, sum(l_quantity) as q, "
    "count(*) as n from tpch.tiny.lineitem "
    "group by l_returnflag, l_linestatus "
    "order by l_returnflag, l_linestatus"
)
DISTINCT_SQL = (
    "select distinct l_suppkey from tpch.tiny.lineitem "
    "order by l_suppkey limit 50"
)
ICI_ON = {"exchange.ici-enabled": "true"}


@pytest.fixture(autouse=True)
def clear_fault_plane():
    yield
    faults.configure(None)


@pytest.fixture(scope="module")
def reference_rows():
    """The reference runner's rows of a statement, computed once."""
    runner = RefRunner()
    memo = {}

    def rows(sql):
        if sql not in memo:
            memo[sql] = [tuple(r) for r in runner.execute(sql).rows()]
        return memo[sql]

    return rows


def assert_rows_equal(got, want):
    got = [tuple(r) for r in got]
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                assert math.isclose(a, b, rel_tol=DOUBLE_RTOL, abs_tol=1e-12), (
                    g, w,
                )
            else:
                assert a == b, (g, w)


def _wait(pred, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise TimeoutError(f"timed out waiting for {msg}")


def _mk_cluster(n=3, cfg=None, slices=()):
    """A coordinator and ``n`` workers in this process; ``slices[i]``,
    when given, overrides worker i's announced slice id."""
    cfg = dict(cfg or {})
    coord = CoordinatorServer(config=NodeConfig(dict(cfg)), device="cpu").start()
    workers = []
    for i in range(n):
        wcfg = dict(cfg)
        if i < len(slices) and slices[i]:
            wcfg["exchange.slice-id"] = slices[i]
        workers.append(WorkerServer(
            coordinator_uri=coord.uri, config=NodeConfig(wcfg), device="cpu"
        ).start())
    _wait(lambda: len(coord.active_workers()) >= n, msg="workers")
    return coord, workers


def _teardown(coord, workers):
    faults.configure(None)
    for w in workers:
        w.shutdown(graceful=False)
    coord.shutdown()


def _counter(name):
    return REGISTRY.counter(name).total


@pytest.fixture(scope="module")
def ici_cluster():
    coord, workers = _mk_cluster(3, ICI_ON)
    yield coord, workers
    _teardown(coord, workers)


@pytest.fixture
def ici_client(ici_cluster):
    """A client with partitioned joins and the ICI session values of the
    cluster's defaults, restored after the test."""
    coord, _ = ici_cluster
    client = PrestoTpuClient(coord.uri, timeout_s=300)
    client.execute("set session join_distribution_type = PARTITIONED")
    yield client
    client.execute("set session join_distribution_type = AUTOMATIC")
    client.execute("set session exchange_ici_enabled = true")
    client.execute("set session exchange_single_program = true")


# ------------------------------------------------ transport selection


class W:
    def __init__(self, slice_id, state="ACTIVE"):
        self.slice_id = slice_id
        self.state = state


def _both_select(name, workers, enabled, schemas):
    """The port's and the reference's rule on the same workers (port
    and reference schemas built from the same type names)."""
    port = getattr(scheduler, name)(
        workers, enabled, tuple(
            {k: T.parse_type(v) for k, v in s.items()} for s in schemas
        )
    )
    ref = getattr(ref_scheduler, name)(
        workers, enabled, tuple(
            {k: RT.parse_type(v) for k, v in s.items()} for s in schemas
        )
    )
    assert port == ref, (name, port, ref)
    return port


def test_select_exchange_transport_rules():
    same = [W("s1"), W("s1"), W("s1")]
    schema = {"a": "bigint", "b": "varchar"}
    sel = "select_exchange_transport"
    assert _both_select(sel, same, True, (schema,)) == "s1"
    # the gate off, mixed slices, unannounced topology, a DRAINING peer,
    # or a nested-type schema all keep the HTTP wire
    assert _both_select(sel, same, False, (schema,)) == ""
    assert _both_select(sel, [W("s1"), W("s2")], True, (schema,)) == ""
    assert _both_select(sel, [W(""), W("")], True, (schema,)) == ""
    assert _both_select(
        sel, [W("s1"), W("s1", state="DRAINING")], True, (schema,)
    ) == ""
    nested = {"a": "array(bigint)"}
    assert _both_select(sel, same, True, (schema, nested)) == ""
    assert _both_select(sel, [], True, (schema,)) == ""


def test_select_exchange_edges_rules():
    """The per-edge rule: the dominant slice (largest ACTIVE group of at
    least 2) wins; outsiders and DRAINING peers no longer veto; nested
    schemas and oversized fan-outs keep the wire."""
    schema = {"a": "bigint", "b": "varchar"}
    sel = "select_exchange_edges"
    pair = [W("s1"), W("s1")]
    assert _both_select(sel, pair, True, (schema,)) == "s1"
    assert _both_select(sel, pair + [W("s2")], True, (schema,)) == "s1"
    assert _both_select(sel, pair + [W("")], True, (schema,)) == "s1"
    assert _both_select(
        sel, pair + [W("s1", state="DRAINING")], True, (schema,)
    ) == "s1"
    assert _both_select(sel, [W("s1"), W("s2")], True, (schema,)) == ""
    assert _both_select(sel, [W(""), W("")], True, (schema,)) == ""
    assert _both_select(
        sel, [W("s1"), W("s1"), W("s2"), W("s2")], True, (schema,)
    ) == "s2"
    assert _both_select(sel, pair, False, (schema,)) == ""
    assert _both_select(sel, pair, True, (schema, {"a": "array(bigint)"})) == ""
    assert MAX_ICI_PARTS == scheduler.MAX_ICI_PARTS == 64
    big = [W("s1") for _ in range(MAX_ICI_PARTS + 1)]
    assert _both_select(sel, big, True, (schema,)) == ""


def test_fragment_spec_ici_slice_wire_roundtrip():
    """``ici_slice`` rides the spec's wire form, and a frame without it
    reads as "" (HTTP), as the reference's does."""
    for spec_cls, nodes, bigint in (
        (FragmentSpec, N, T.BIGINT), (RefSpec, RN, RT.BIGINT)
    ):
        root = nodes.ValuesNode(schema=(("a", bigint),))
        spec = spec_cls(
            task_id="q.prod.0.a0", query_id="q", fragment=root,
            partition_scan=-1, split_start=0, split_end=0,
            n_partitions=4, partition_keys=("a",), ici_slice="cpu-123",
        )
        back = spec_cls.from_json(spec.to_json())
        assert back.ici_slice == "cpu-123"
        d = spec.to_json()
        del d["ici_slice"]
        assert spec_cls.from_json(d).ici_slice == ""


# ------------------------------------------------ the equality battery


@pytest.mark.parametrize("sql", [AGG_SQL, DISTINCT_SQL, JOIN_SQL],
                         ids=["agg", "distinct", "join"])
def test_ici_vs_http_battery_join_agg_distinct(
    ici_cluster, ici_client, reference_rows, sql
):
    """One cluster, the statement under both transports through the
    session value: the reference's rows either way, the ICI run moving
    no byte through the pages_wire shuffle, its in-slice edges and
    elided bytes counted; the segment drains once the tasks are
    DELETEd; slice discovery and the ``exchange.ici`` caches row."""
    coord, _ = ici_cluster
    slices = {w.slice_id for w in coord.active_workers()}
    assert len(slices) == 1 and "" not in slices
    client = ici_client
    client.execute("set session exchange_ici_enabled = false")
    h0 = _counter("exchange.http_shuffle_bytes")
    rows_http = client.execute(sql).rows()
    assert _counter("exchange.http_shuffle_bytes") > h0
    assert_rows_equal(rows_http, reference_rows(sql))

    client.execute("set session exchange_ici_enabled = true")
    h1 = _counter("exchange.http_shuffle_bytes")
    e1 = _counter("exchange.ici_edges")
    b1 = _counter("exchange.ici_bytes_elided")
    f1 = _counter("exchange.ici_fallbacks")
    rows_ici = client.execute(sql).rows()
    assert rows_ici == rows_http, "transport changed answers"
    assert _counter("exchange.http_shuffle_bytes") == h1, (
        "ICI window moved bytes through pages_wire"
    )
    assert _counter("exchange.ici_edges") > e1
    assert _counter("exchange.ici_bytes_elided") > b1
    assert _counter("exchange.ici_fallbacks") == f1
    rows = coord.local.execute(
        "select cache, hits from system.runtime.caches "
        "where cache = 'exchange.ici'"
    ).rows()
    assert len(rows) == 1 and rows[0][1] > 0
    _wait(lambda: exchange_spi.SEGMENT.stats()["entries"] == 0, 10,
          "segment drained")


def test_single_program_collective_stage_and_gather(
    ici_cluster, ici_client, reference_rows
):
    """Single-program mode end to end: one routing pass per stage
    (``exchange.collective_stages``) and the coordinator's final gather
    on the ICI lane; with it off, the same answers through the
    per-source gather."""
    client = ici_client
    c0 = _counter("exchange.collective_stages")
    res = client.execute(AGG_SQL)
    assert_rows_equal(res.rows(), reference_rows(AGG_SQL))
    assert _counter("exchange.collective_stages") > c0
    info = client.query_info(res.query_id)
    assert info["exchange"]["ici_edges"] > 0
    assert info["exchange"]["http_edges"] == 0
    client.execute("set session exchange_single_program = false")
    assert client.execute(AGG_SQL).rows() == res.rows()


def test_collective_trace_failure_falls_open_to_per_source(
    ici_cluster, ici_client, reference_rows, monkeypatch
):
    """A routing pass that fails to build must not fail the stage: the
    failure is cached once, every consumer takes the per-source gather
    (still on the ICI lane), and the answers are unchanged."""
    def boom(*a, **k):
        raise RuntimeError("synthetic collective build failure")

    monkeypatch.setattr(exchange_spi, "_build_collective", boom)
    f0 = _counter("exchange.collective_fallbacks")
    e0 = _counter("exchange.ici_edges")
    rows = ici_client.execute(JOIN_SQL).rows()
    assert_rows_equal(rows, reference_rows(JOIN_SQL))
    assert _counter("exchange.collective_fallbacks") > f0
    assert _counter("exchange.ici_edges") > e0


def test_ici_default_off_is_bit_exact_http(reference_rows):
    """No config key: no segment publish, no ICI counter moves, specs
    carry no slice; the HTTP shuffle as before."""
    coord, ws = _mk_cluster(2)
    try:
        e0 = _counter("exchange.ici_edges")
        b0 = _counter("exchange.ici_bytes_elided")
        f0 = _counter("exchange.ici_fallbacks")
        client = PrestoTpuClient(coord.uri, timeout_s=300)
        rows = client.execute(AGG_SQL).rows()
        assert rows == [tuple(r) for r in coord.local.execute(AGG_SQL).rows()]
        assert_rows_equal(rows, reference_rows(AGG_SQL))
        assert _counter("exchange.ici_edges") == e0
        assert _counter("exchange.ici_bytes_elided") == b0
        assert _counter("exchange.ici_fallbacks") == f0
    finally:
        _teardown(coord, ws)


# ----------------------------------------------------------- recovery


def _sealed_merge_worker(workers):
    """A worker running a merge task whose source set is sealed (every
    producer finished as the coordinator saw it): killing it loses a
    partition that must be recovered. None while there is none."""
    for w in workers:
        with w._lock:
            tasks = list(w.tasks.values())
        for t in tasks:
            if (t.spec.partition_scan < 0 and t.sources_done
                    and t.state in ("QUEUED", "RUNNING")):
                return w
    return None


def test_chaos_kill_colocated_worker_mid_join_falls_back(
    tmp_path, reference_rows
):
    """Kill one co-located worker mid join with ICI on under
    ``retry_policy=TASK``, the one running a merge task over the sealed
    producer stage: its device pages are gone (its segment entries
    discarded, as a crash loses them), the rescheduled merge
    recovers its partitions over the HTTP/spool ladder, no query fails
    and no upstream producer re-runs."""
    cfg = dict(ICI_ON, **{
        "exchange.spool-path": str(tmp_path / "spool"),
        "exchange.spool-bytes": "64MB",
        "retry-policy": "TASK",
    })
    coord, ws = _mk_cluster(2, cfg)
    try:
        client = PrestoTpuClient(coord.uri, timeout_s=120)
        faults.configure({"seed": 2, "rules": [
            {"action": "delay", "task": ".prod.", "delay_s": 0.05},
            {"action": "delay", "task": ".merge.", "delay_s": 0.8},
        ]})
        out, errs = {}, []

        def run():
            try:
                out["res"] = client.execute(JOIN_SQL)
            except Exception as e:  # surfaced by the assert below
                errs.append(e)

        t = threading.Thread(target=run)
        t.start()
        _wait(lambda: _sealed_merge_worker(ws), 60, "producer stage sealed")
        victim = _sealed_merge_worker(ws)
        victim._fault_kill()  # dead sockets, no drain
        with victim._lock:
            doomed = list(victim.tasks)
        for tid in doomed:
            exchange_spi.SEGMENT.discard(tid)
        t.join(120)
        assert not t.is_alive()
        assert not errs, f"query failed despite TASK recovery: {errs}"
        assert_rows_equal(out["res"].rows(), reference_rows(JOIN_SQL))
        info = client.query_info(out["res"].query_id)
        assert info["task_recoveries"] >= 1
        prod = next(s for s in info["stages"] if s["kind"] == "producer")
        by_logical = {}
        for tk in prod["tasks"]:
            by_logical.setdefault(
                task_ids.logical_key(tk["task_id"]), []
            ).append(tk)
        for lk, attempts in by_logical.items():
            assert len(attempts) == 1, f"producer {lk} re-ran"
    finally:
        _teardown(coord, ws)


def test_drain_under_load_with_ici_zero_failures(tmp_path, reference_rows):
    """A DRAINING worker's ICI edges degrade to HTTP (its segment entries
    materialize into serialized buffers): the query completes with no
    failure, the drained worker exits, the survivor keeps serving."""
    cfg = dict(ICI_ON, **{
        "exchange.spool-path": str(tmp_path / "spool"),
        "retry-policy": "TASK",
    })
    coord, ws = _mk_cluster(2, cfg)
    try:
        client = PrestoTpuClient(coord.uri, timeout_s=120)
        faults.configure({"seed": 5, "rules": [
            {"action": "delay", "task": ".prod.", "delay_s": 0.1},
        ]})
        results, errs = [], []

        def run():
            try:
                results.append(client.execute(JOIN_SQL).rows())
            except Exception as e:  # surfaced by the assert below
                errs.append(e)

        t = threading.Thread(target=run)
        t.start()
        time.sleep(0.15)
        rpc.call_json("PUT", ws[0].uri + "/v1/state/drain")
        t.join(120)
        assert not t.is_alive()
        assert not errs, f"drain lost a query: {errs}"
        assert_rows_equal(results[0], reference_rows(JOIN_SQL))
        _wait(lambda: ws[0]._shutting_down, 15, "drained worker exit")
        res = client.execute("select count(*) as c from tpch.tiny.orders")
        assert [tuple(r) for r in res.rows()] == [(15000,)]
    finally:
        _teardown(coord, ws)


def test_cross_slice_worker_keeps_http(reference_rows):
    """Two workers on different slices: no pair shares a slice, so the
    whole stage stays on the wire (the right answers, no ICI edge)."""
    coord, ws = _mk_cluster(2, ICI_ON, slices=("", "other-slice"))
    try:
        e0 = _counter("exchange.ici_edges")
        client = PrestoTpuClient(coord.uri, timeout_s=300)
        assert_rows_equal(client.execute(AGG_SQL).rows(),
                          reference_rows(AGG_SQL))
        assert _counter("exchange.ici_edges") == e0
    finally:
        _teardown(coord, ws)


@pytest.mark.parametrize("sql", [AGG_SQL, JOIN_SQL], ids=["agg", "join"])
def test_mixed_transport_stage_per_edge_ici_and_http(sql, reference_rows):
    """One cross-slice worker beside a co-located pair: the pair's edges
    ride the segment (ICI edges, elided bytes), the outsider's ride HTTP
    (HTTP edges), and the spliced answers equal the all-HTTP run's."""
    coord, ws = _mk_cluster(3, ICI_ON, slices=("", "", "other-slice"))
    try:
        client = PrestoTpuClient(coord.uri, timeout_s=300)
        client.execute("set session join_distribution_type = PARTITIONED")
        client.execute("set session exchange_ici_enabled = false")
        rows_http = client.execute(sql).rows()
        client.execute("set session exchange_ici_enabled = true")
        e0 = _counter("exchange.ici_edges")
        b0 = _counter("exchange.ici_bytes_elided")
        res = client.execute(sql)
        assert res.rows() == rows_http, "mixed transports changed answers"
        assert_rows_equal(rows_http, reference_rows(sql))
        assert _counter("exchange.ici_edges") > e0
        assert _counter("exchange.ici_bytes_elided") > b0
        info = client.query_info(res.query_id)
        assert info["exchange"]["ici_edges"] > 0
        assert info["exchange"]["http_edges"] > 0
    finally:
        _teardown(coord, ws)


# --------------------------------------- pages_wire floor satellite


def test_compress_floor_skips_probe_and_counts_both_entry_points():
    """Sub-floor buffers ship raw with no ratio probe, counted alike on
    both producer entry points, and the frames are byte-equal to the
    reference's."""
    n = 8  # 64 bytes of int64, below the 512-byte floor
    data = np.arange(n, dtype=np.int64)
    s0 = _counter("exchange.compress_skipped")
    frame_direct = pages_wire.serialize_page(
        [("a", data, None, T.BIGINT, None)], n
    )
    direct_skips = _counter("exchange.compress_skipped") - s0
    assert direct_skips == 1
    cols = pages_wire.payload_to_wire_columns({"a": data}, {"a": T.BIGINT}, n)
    s1 = _counter("exchange.compress_skipped")
    frame_reser = pages_wire.serialize_page(cols, n)
    assert _counter("exchange.compress_skipped") - s1 == direct_skips
    for frame in (frame_direct, frame_reser):
        payload, _schema, nrows = pages_wire.deserialize_page(frame)
        assert nrows == n
        assert np.array_equal(np.asarray(payload["a"]), data)
    ref_frame = ref_wire.serialize_page([("a", data, None, RT.BIGINT, None)], n)
    assert frame_direct == ref_frame
    import json as _json
    import struct

    (hlen,) = struct.unpack_from("<I", frame_direct, 4)
    header = _json.loads(frame_direct[8: 8 + hlen].decode())
    assert header["columns"][0]["enc"] == "raw"

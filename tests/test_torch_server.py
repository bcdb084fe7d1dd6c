"""The port's server on its default path, on the CPU: a coordinator and
two workers in this process (``device="cpu"``, loopback HTTP, real
discovery, the token-acked paged exchange), driven through
``PrestoTpuClient`` as the reference's ``tests/test_server.py`` drives
its own.

The 22 TPC-H queries over HTTP equal the port's ``LocalQueryRunner``
(doubles within rel 1e-9, every other type exactly; the partial/final
split only reorders float sums, which stays far inside that) and the
reference's ``SqliteOracle`` (``presto_tpu/verifier.py``, rel 1e-6 as
the reference's own test). The rest follows the reference's failure
tests: discovery, an error that surfaces, worker death and the retry
on a live worker, the all-workers-dead local fallback, graceful
shutdown and drain, output-buffer backpressure and abort. Each
cluster-killing test runs under a deadline of its own, so none can
hang the suite.
"""

from __future__ import annotations

import json
import math
import threading
import time

import pytest
import torch

from presto_tpu.verifier import SqliteOracle, diff_results
from presto_tpu_torch.exec.local_runner import LocalQueryRunner
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
from presto_tpu_torch.sql import parse_statement
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
    raise TimeoutError(
        f"only {len(coord.active_workers())}/{n} workers discovered"
    )


def _boot(n_workers: int, **worker_kw):
    coord = CoordinatorServer(device="cpu").start()
    workers = [
        WorkerServer(coordinator_uri=coord.uri, device="cpu", **worker_kw)
        .start()
        for _ in range(n_workers)
    ]
    _wait_workers(coord, n_workers)
    return coord, workers


def _stop(coord, workers):
    for w in workers:
        w.shutdown(graceful=False)
    coord.shutdown()


def _within(seconds: float, fn):
    """Run ``fn`` on a thread and fail (instead of hanging the suite)
    when it has not returned within ``seconds``."""
    out, err = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:  # noqa: BLE001 - re-raised below
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not finish within {seconds}s"
    if err:
        raise err[0]
    return out[0]


def _kill(worker):
    """Hard-kill a worker (no drain) but leave it in discovery: the
    coordinator schedules to it and hits a dead socket."""
    worker._shutting_down = True  # stop the announcer
    worker.httpd.shutdown()
    worker.httpd.server_close()


def _wire_rows(rows):
    """Rows as the paged protocol renders them (JSON; dates and other
    non-JSON values as their strings, as the coordinator sends them)."""
    return [tuple(r) for r in json.loads(json.dumps(rows, default=str))]


def assert_rows_equal(got, want, rtol: float = DOUBLE_RTOL):
    """Same rows in the same order; doubles within ``rtol``."""
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                assert math.isclose(a, b, rel_tol=rtol, abs_tol=1e-12), (g, w)
            else:
                assert a == b, (g, w)


@pytest.fixture(scope="module")
def cluster():
    coord, workers = _boot(2)
    yield coord, workers
    _stop(coord, workers)


@pytest.fixture(scope="module")
def client(cluster):
    coord, _ = cluster
    return PrestoTpuClient(coord.uri, timeout_s=300)


@pytest.fixture(scope="module")
def local():
    return LocalQueryRunner(device="cpu")


@pytest.fixture(scope="module")
def oracle():
    return SqliteOracle("tiny")


@pytest.mark.parametrize("qnum", sorted(QUERIES))
def test_tpch_over_http(qnum, client, local, oracle):
    sql = QUERIES[qnum]
    got = client.execute(sql).rows()
    assert_rows_equal(got, _wire_rows(local.execute(sql).rows()))
    ordered = bool(parse_statement(sql).order_by)
    diff = diff_results(got, oracle.execute(sql), ordered, 1e-6)
    assert diff is None, f"Q{qnum} over HTTP vs the oracle: {diff}"


def test_discovery_lists_workers(cluster):
    coord, workers = cluster
    ids = {w.node_id for w in coord.active_workers()}
    assert {w.node_id for w in workers} <= ids


def test_query_error_surfaces(client):
    with pytest.raises(QueryFailed):
        client.execute("select no_such_column from tpch.tiny.lineitem")


def test_system_runtime_lists_nodes_and_tasks(cluster, client):
    coord, workers = cluster
    client.execute(
        "select l_returnflag, count(*) from tpch.tiny.lineitem "
        "group by l_returnflag"
    )
    nodes = client.execute(
        "select node_id, coordinator, state from system.runtime.nodes"
    ).rows()
    ids = {r[0] for r in nodes}
    assert {w.node_id for w in workers} | {"coordinator"} <= ids
    assert all(r[2] == "ACTIVE" for r in nodes if r[0] != "coordinator")
    tasks = client.execute(
        "select node_id, state from system.runtime.tasks"
    ).rows()
    assert {w.node_id for w in workers} <= {r[0] for r in tasks}
    assert {r[1] for r in tasks} <= {"FINISHED", "ABORTED"}


def test_query_info_rolls_up_stages_and_tasks(cluster, client):
    coord, _ = cluster
    res = client.execute(QUERIES[1])
    info = rpc.call_json("GET", f"{coord.uri}/v1/query/{res.query_id}")
    assert info["state"] == "FINISHED"
    stages = info["stages"]
    assert stages and all(s["tasks"] for s in stages)
    assert info["output_rows"] == 4
    progress = rpc.call_json(
        "GET", f"{coord.uri}/v1/query/{res.query_id}/progress"
    )
    assert progress["done"] and progress["progress"] == 1.0
    assert progress["splits_done"] == progress["splits_total"] > 0


def test_distributed_explain_analyze(cluster, client):
    text = "\n".join(
        r[0] for r in client.execute("explain analyze " + QUERIES[1]).rows()
    )
    assert "Stage" in text or "stage" in text
    assert "task" in text


def test_cluster_metrics_federate_every_worker(cluster, client):
    coord, workers = cluster
    client.execute("select count(*) from tpch.tiny.region")
    body = rpc.call("GET", f"{coord.uri}/v1/metrics/cluster").body.decode()
    for w in workers:
        assert f'node="{w.node_id}"' in body
    assert 'node="cluster"' in body


def test_prepared_statement_over_http(client, local):
    sql = "select count(*) from tpch.tiny.orders where o_orderkey < "
    client.execute(f"prepare q from {sql}?")
    for bound in (100, 1000):
        assert client.execute(f"execute q using {bound}").rows() == (
            local.execute(f"{sql}{bound}").rows()
        )
    client.execute("deallocate prepare q")
    with pytest.raises(QueryFailed, match="not found"):
        client.execute("execute q using 1")


def test_worker_death_retries_on_live_worker():
    """A dead worker's range is reassigned to a live worker and the
    query succeeds; the TTL eventually drops the dead node."""
    coord, workers = _boot(2)
    w1, w2 = workers
    try:
        _kill(w2)
        client = PrestoTpuClient(coord.uri, timeout_s=60)
        before = REGISTRY.counter("coordinator.tasks_retried").total
        res = _within(90, lambda: client.execute(
            "select count(*) as c from tpch.tiny.lineitem"
        ))
        assert res.rows() == [(59997,)]
        assert REGISTRY.counter("coordinator.tasks_retried").total > before
        old_ttl = coord_mod.NODE_TTL_S
        coord_mod.NODE_TTL_S = 0.5
        try:
            deadline = time.time() + 10
            while time.time() < deadline and w2.node_id in {
                w.node_id for w in coord.active_workers()
            }:
                time.sleep(0.05)
            assert w2.node_id not in {
                w.node_id for w in coord.active_workers()
            }
        finally:
            coord_mod.NODE_TTL_S = old_ttl
    finally:
        _stop(coord, [w1])


def test_all_workers_dead_falls_back_local():
    """No spare worker to retry on: the fragment runs on the
    coordinator's own runner (same device) instead of failing."""
    coord, (w,) = _boot(1)
    try:
        _kill(w)
        client = PrestoTpuClient(coord.uri, timeout_s=60)
        before = REGISTRY.counter("coordinator.local_fallbacks").total
        res = _within(90, lambda: client.execute(
            "select count(*) as c from tpch.tiny.lineitem"
        ))
        assert res.rows() == [(59997,)]
        assert REGISTRY.counter("coordinator.local_fallbacks").total > before
    finally:
        coord.shutdown()


def test_graceful_shutdown_and_drain():
    """SHUTTING_DOWN refuses new tasks after the running ones finish; a
    drained worker announces DRAINING, the coordinator stops scheduling
    there, and queries keep answering on the other worker."""
    coord, (w1, w2) = _boot(2)
    try:
        client = PrestoTpuClient(coord.uri, timeout_s=60)
        res = _within(60, lambda: client.execute(
            "select count(*) as c from tpch.tiny.orders"
        ))
        assert res.rows() == [(15000,)]
        rpc.call_json("PUT", f"{w2.uri}/v1/state/drain", {})
        deadline = time.time() + 10
        while time.time() < deadline and w2.node_id in {
            w.node_id for w in coord.active_workers()
        }:
            time.sleep(0.02)
        assert w2.node_id not in {w.node_id for w in coord.active_workers()}
        res = _within(60, lambda: client.execute(
            "select count(*) as c from tpch.tiny.customer"
        ))
        assert res.rows() == [(1500,)]
        _within(30, lambda: w1.shutdown(graceful=True))
        assert w1.status()["state"] == "SHUTTING_DOWN"
        with pytest.raises(RuntimeError):
            w1.create_task(FragmentSpec(
                task_id="t", query_id="q", fragment=None,
                partition_scan=0, split_start=0, split_end=0,
            ))
    finally:
        _stop(coord, [w2])


def _task(max_pages: int):
    spec = FragmentSpec(
        task_id="t", query_id="q", fragment=None,
        partition_scan=0, split_start=0, split_end=0,
    )
    task = worker_mod._Task(spec)
    task.state = "RUNNING"
    return task


def test_output_buffer_backpressure(monkeypatch):
    """The producer blocks when the task's buffer is full and resumes
    when the consumer acks by token advance."""
    monkeypatch.setattr(worker_mod, "MAX_BUFFERED_PAGES", 2)
    task = _task(2)
    produced = []

    def produce():
        for i in range(4):
            task.offer_page(b"page%d" % i)
            produced.append(i)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    time.sleep(0.3)
    assert produced == [0, 1], "the producer must block at capacity"
    task.ack_below(2)  # the consumer pulled tokens 0 and 1
    t.join(timeout=5)
    assert produced == [0, 1, 2, 3]
    assert task.pages[0] is None and task.pages[1] is None  # freed
    assert task.pages[2] == b"page2"


def test_abort_unblocks_producer(monkeypatch):
    monkeypatch.setattr(worker_mod, "MAX_BUFFERED_PAGES", 1)
    task = _task(1)
    task.offer_page(b"p0")
    err = []

    def produce():
        try:
            task.offer_page(b"p1")
        except RuntimeError as e:
            err.append(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    time.sleep(0.2)
    task.abort()
    t.join(timeout=5)
    assert err, "a blocked producer must raise on abort"


def test_nodes_without_a_device_mean_cuda(monkeypatch):
    """``device=None`` means CUDA on both node kinds: without a card
    they raise instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WorkerServer()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CoordinatorServer()


def test_announcement_ack_names_the_coordinator(cluster):
    coord, workers = cluster
    body = workers[0]._announce_body()
    ack = rpc.call_json("PUT", f"{coord.uri}/v1/announcement", body)
    assert ack["ok"] and ack["boot"] == coord._boot
    assert json.dumps(body["backend_diag"])
    assert body["state"] == "ACTIVE" and not body["preemptible"]

"""The port's ``system`` catalog
(``presto_tpu_torch/connectors/system_catalog.py``), read by SQL on the
CPU after the same query sequence in both packages: every column that
does not depend on time, ids or the backend must equal the reference's.

Left out of the comparison: timings, query and trace ids,
``compile_cache_hit`` (the port compiles no program per query, so it is
always true) and byte sizes; ``runtime.caches`` has no
``compile.programs`` row in the port, its ``exchange.ici`` row counts the
process's in-slice segment (process-wide state, which other tests in
the process move, so only its presence is compared),
and ``runtime.nodes``' state and ``backend_diag`` name the port's own
device.
"""

from __future__ import annotations

import json

import pytest

from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu.utils.memory import MemoryPool as RefPool
from presto_tpu_torch.exec.local_runner import LocalQueryRunner
from presto_tpu_torch.utils import devicediag
from presto_tpu_torch.utils.memory import MemoryPool
from tpch_queries import QUERIES
from torch_parity import one_torch_thread  # noqa: F401

SEQUENCE = (
    QUERIES[1],
    QUERIES[3],
    QUERIES[1],
    "select count(*) c from tpch.tiny.nation where n_regionkey = 2",
)


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    d = tmp_path_factory.mktemp("system")
    ref = RefRunner(
        history_path=str(d / "r"), memory_pool=RefPool(1 << 30),
        staging_cache_bytes=1 << 20,
    )
    port = LocalQueryRunner(
        device="cpu", history_path=str(d / "p"),
        memory_pool=MemoryPool(1 << 30), staging_cache_bytes=1 << 20,
    )
    for r in (ref, port):
        for sql in SEQUENCE:
            r.execute(sql)
    return ref, port


def _select(runner, sql):
    res = runner.execute(sql)
    return [dict(zip(res.columns, row)) for row in res.rows()]


def _both(runners, sql):
    ref, port = runners
    return _select(ref, sql), _select(port, sql)


def test_runtime_queries(runners):
    """Read first: the history then holds the sequence's queries and this
    read, still running."""
    cols = ("state, query, plan_fingerprint, batched, cached, retries, "
            "input_rows, output_rows, error, trace_id")
    want, got = _both(runners, f"select {cols} from system.runtime.queries")
    for rows in (want, got):
        assert all(len(r.pop("trace_id")) == 32 for r in rows)
    assert got == want and len(got) == len(SEQUENCE) + 1
    assert [r["state"] for r in got] == ["FINISHED"] * len(SEQUENCE) + [
        "RUNNING"
    ]


def test_runtime_query_history(runners):
    want, got = _both(
        runners,
        "select fingerprint, query, node_count, total_rows, epoch "
        "from system.runtime.query_history",
    )
    assert got == want
    # Q1 twice is one statement, re-recorded last: three entries, then
    # one per system read
    assert [r["query"] for r in got[:3]] == [
        QUERIES[3][:500], QUERIES[1][:500], SEQUENCE[3]
    ]


def test_runtime_caches(runners):
    want, got = _both(
        runners,
        "select cache, entries, hits, misses, evictions "
        "from system.runtime.caches",
    )
    by_cache = {r["cache"]: r for r in want}
    assert [r["cache"] for r in got] == [
        "staging.split_cache", "plan.cache", "staging.host_spill",
        "exchange.ici",
    ]
    for r in got[:3]:
        assert r == by_cache[r["cache"]], r["cache"]
    assert "exchange.ici" in by_cache
    split = runners[1].split_cache.stats()
    assert got[0]["misses"] == split["misses"] > 0
    assert got[1]["entries"] == runners[1].plan_cache.stats()["entries"]


def test_runtime_memory(runners):
    want, got = _both(
        runners,
        "select node_id, query_id, state, blocked_bytes, limit_bytes "
        "from system.runtime.memory",
    )
    assert got == want
    assert got[0]["state"] == "OK" and got[0]["limit_bytes"] == 1 << 30


def test_runtime_metrics(runners):
    want, got = _both(runners, "select name, kind from system.runtime.metrics")
    kinds = {r["name"]: r["kind"] for r in got}
    assert kinds["queries.finished.total"] == "CounterStat"
    assert kinds["plan.planning_ms.p99"] == "DistributionStat"
    assert "history.write.total" in kinds and "device.dispatches.total" in kinds
    # every metric both packages registered has one kind in both
    ref_kinds = {r["name"]: r["kind"] for r in want}
    assert all(ref_kinds[n] == k for n, k in kinds.items() if n in ref_kinds)


def test_runtime_nodes(runners):
    devicediag.probe_backend("cpu")
    want, got = _both(
        runners,
        "select node_id, http_uri, node_version, coordinator, preemptible, "
        "pool_state, last_decision, state, backend_diag "
        "from system.runtime.nodes",
    )
    (row,) = got
    assert row.pop("state") == "ACTIVE (1 devices)"
    diag = json.loads(row.pop("backend_diag"))
    for r in want:
        r.pop("state"), r.pop("backend_diag")
    assert got == want
    assert (diag["backend"], diag["ok"], diag["phase"]) == ("cpu", True, "ok")
    assert diag["phases"] == {
        "enumerate": "ok", "compile": "skipped", "execute": "skipped"
    }


@pytest.mark.parametrize(
    "table",
    ["tasks", "qos", "snapshots", "materialized_views", "metrics_history"],
)
def test_runtime_tables_a_local_runner_serves_empty(runners, table):
    want, got = _both(runners, f"select * from system.runtime.{table}")
    assert got == want == []


def test_metadata_catalogs(runners):
    want, got = _both(
        runners,
        "select catalog_name, connector_id from system.metadata.catalogs",
    )
    assert got == want
    assert [r["catalog_name"] for r in got] == ["system", "tpcds", "tpch"]


def test_show_schemas_of_the_system_catalog(runners):
    want, got = _both(runners, "show schemas from system")
    assert got == want == [{"Schema": "metadata"}, {"Schema": "runtime"}]

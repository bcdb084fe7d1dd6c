"""Built-in ``system`` catalog.

The PyTorch port's ``presto_tpu/connectors/system_catalog.py`` (the same
tables and columns):
``presto-system``'s runtime tables and the jmx-connector pattern of
making engine metrics SQL-able, backed live by the runner's own state —
its QueryHistory, history store, split cache, plan cache, memory pool,
the process metrics registry and the device probe
(``utils/devicediag.py``). Zero stored bytes; every runner registers it.

``runtime.materialized_views`` lists the runner's materialized views
(``exec/mview.py``; empty before the first one). Under a
``CoordinatorServer`` (``runner.cluster``), ``runtime.nodes`` lists the
coordinator and every announced worker with its pool state and the
autoscaler's last decision, ``runtime.tasks`` the coordinator's per-task
stats rollups, and ``runtime.qos`` one row per QoS lane (with
``qos.enabled``). Tables served empty, as the reference's are without
the planes that feed them: ``runtime.qos`` with the plane off,
``runtime.metrics_history``, and ``runtime.tasks`` on a plain local
runner. ``runtime.snapshots`` lists the tip of every table of each
mounted manifest store (the ingest lane's lakehouse store and any
lakehouse file connector's). ``runtime.caches`` has no
``compile.programs`` row (the port compiles no program per query); its
``exchange.ici`` row is the process's in-slice exchange segment.
"""

from __future__ import annotations

import json
from typing import Dict, Sequence

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.spi import (
    Connector,
    ConnectorMetadata,
    ConnectorSplit,
    SplitSource,
    TableHandle,
)

_SCHEMAS: Dict[str, Dict[str, Dict[str, T.DataType]]] = {
    "runtime": {
        "queries": {
            "query_id": T.VARCHAR,
            "state": T.VARCHAR,
            "query": T.VARCHAR,
            "trace_id": T.VARCHAR,
            "plan_fingerprint": T.VARCHAR,
            "elapsed_ms": T.DOUBLE,
            "planning_ms": T.DOUBLE,
            "optimization_ms": T.DOUBLE,
            "staging_ms": T.DOUBLE,
            "execution_ms": T.DOUBLE,
            "compile_cache_hit": T.BOOLEAN,
            # micro-batched serving: answered by a shared vmapped
            # dispatch (QueryStats.batched)
            "batched": T.BOOLEAN,
            # serving-plane result reuse: answered from the snapshot-
            # keyed result cache (fresh or bounded-stale serve)
            "cached": T.BOOLEAN,
            "retries": T.BIGINT,
            "input_rows": T.BIGINT,
            "input_bytes": T.BIGINT,
            "output_rows": T.BIGINT,
            "error": T.VARCHAR,
        },
        "query_history": {
            "fingerprint": T.VARCHAR,
            "query": T.VARCHAR,
            "node_count": T.BIGINT,
            "total_rows": T.BIGINT,
            # adaptive execution: the statement fingerprint's history
            # epoch (bumped on material cardinality change; the signal
            # epoch-versioned plan-cache entries are judged by)
            "epoch": T.BIGINT,
            "updated": T.DOUBLE,
        },
        "nodes": {
            "node_id": T.VARCHAR,
            "http_uri": T.VARCHAR,
            "node_version": T.VARCHAR,
            "coordinator": T.BOOLEAN,
            "state": T.VARCHAR,
            # elastic pools: preemptible capacity flag, the node's pool
            # lifecycle state, and (coordinator row) the autoscaler's
            # last decision
            "preemptible": T.BOOLEAN,
            "pool_state": T.VARCHAR,
            "last_decision": T.VARCHAR,
            # the last device probe (utils/devicediag.py), JSON: the
            # device, each phase's outcome, the failing phase and its
            # error class
            "backend_diag": T.VARCHAR,
        },
        "tasks": {
            "query_id": T.VARCHAR,
            "stage_id": T.BIGINT,
            "task_id": T.VARCHAR,
            "node_id": T.VARCHAR,
            "state": T.VARCHAR,
            "wall_ms": T.DOUBLE,
            "staging_ms": T.DOUBLE,
            "execute_ms": T.DOUBLE,
            "input_rows": T.BIGINT,
            "input_bytes": T.BIGINT,
            "output_rows": T.BIGINT,
            "output_bytes": T.BIGINT,
            "retries": T.BIGINT,
        },
        "metrics": {
            "name": T.VARCHAR,
            "kind": T.VARCHAR,
            "value": T.DOUBLE,
        },
        # time-series view over the coordinator's telemetry sampler
        # (utils/telemetry.MetricsSampler; telemetry.sample-interval-s
        # enables it): one row per retained (node, metric) sample with
        # the rate against the stream's previous observation
        "metrics_history": {
            "node": T.VARCHAR,
            "ts": T.DOUBLE,
            "name": T.VARCHAR,
            "value": T.DOUBLE,
            "rate": T.DOUBLE,
        },
        # materialized views (exec/mview.py): definition, base table,
        # tip snapshot, and how/when the view was last maintained
        "materialized_views": {
            "view": T.VARCHAR,
            "base_table": T.VARCHAR,
            "eligible": T.BOOLEAN,
            "reason": T.VARCHAR,
            "snapshot_id": T.BIGINT,
            "last_refresh_mode": T.VARCHAR,
            "refresh_age_s": T.DOUBLE,
            "refreshes": T.BIGINT,
            "incremental_refreshes": T.BIGINT,
            "rows": T.BIGINT,
        },
        "caches": {
            "cache": T.VARCHAR,
            "entries": T.BIGINT,
            "bytes": T.BIGINT,
            "budget_bytes": T.BIGINT,
            "hits": T.BIGINT,
            "misses": T.BIGINT,
            "evictions": T.BIGINT,
        },
        # tail-latency QoS plane (server/qos.py): one row per
        # admission lane member — priority, SLO target, live
        # running/queued/suspended occupancy, p50/p99 latency
        # reservoir, and suspension/resume/SLO-miss counters
        "qos": {
            "group": T.VARCHAR,
            "priority": T.BIGINT,
            "target_p99_ms": T.DOUBLE,
            "queries": T.BIGINT,
            "running": T.BIGINT,
            "queued": T.BIGINT,
            "suspended": T.BIGINT,
            "p50_ms": T.DOUBLE,
            "p99_ms": T.DOUBLE,
            "slo_misses": T.BIGINT,
            "suspensions": T.BIGINT,
            "resumes": T.BIGINT,
        },
        # durable lakehouse (server/manifests.py): one row per
        # manifest-committed table — tip snapshot id, retained
        # snapshot count, live file/byte/row footprint, and whether
        # the tip is a compaction ('compacted'), compaction is due
        # ('pending'), or neither ('none')
        "snapshots": {
            "table": T.VARCHAR,
            "snapshot_id": T.BIGINT,
            "snapshots": T.BIGINT,
            "files": T.BIGINT,
            "bytes": T.BIGINT,
            "rows": T.BIGINT,
            "compaction": T.VARCHAR,
        },
        # cluster memory governance (server/memory_arbiter.py): one
        # row per node (query_id '') + one per (node, query) holder,
        # plus KILLED rows for the arbiter's victim decisions
        "memory": {
            "node_id": T.VARCHAR,
            "query_id": T.VARCHAR,
            "state": T.VARCHAR,
            "reserved_bytes": T.BIGINT,
            "peak_bytes": T.BIGINT,
            "blocked_bytes": T.BIGINT,
            "spilled_bytes": T.BIGINT,
            "limit_bytes": T.BIGINT,
        },
    },
    "metadata": {
        "catalogs": {"catalog_name": T.VARCHAR, "connector_id": T.VARCHAR},
    },
}


#: tables only a server feeds
_SERVER_TABLES = {("runtime", "metrics_history")}


class _SystemMetadata(ConnectorMetadata):
    def list_schemas(self):
        return sorted(_SCHEMAS)

    def list_tables(self, schema):
        return sorted(_SCHEMAS.get(schema, {}))

    def get_table_schema(self, handle: TableHandle):
        try:
            return dict(_SCHEMAS[handle.schema][handle.table])
        except KeyError:
            raise KeyError(
                f"table not found: system.{handle.schema}.{handle.table}"
            )


class SystemConnector(Connector):
    """Catalog ``system``: live engine introspection tables."""

    def __init__(self, runner=None, **config):
        self._runner = runner
        self._metadata = _SystemMetadata()

    def metadata(self):
        return self._metadata

    def cacheable(self):
        return False  # live data: never reuse staged pages

    def coordinator_only(self):
        return True  # workers' system tables are empty: never distribute

    def get_splits(self, handle: TableHandle, target_split_rows: int = 1 << 20, constraint=()):
        return SplitSource([ConnectorSplit(handle, 0, 0)])

    def create_page_source(self, split: ConnectorSplit, columns: Sequence[str]):
        rows = self._rows(split.table)
        return {
            c: np.array([r[c] for r in rows], dtype=object) for c in columns
        }

    # ------------------------------------------------------------- tables

    def _rows(self, handle: TableHandle):
        key = (handle.schema, handle.table)
        if key == ("runtime", "queries"):
            hist = self._runner.history.snapshot() if self._runner else []
            return [
                {
                    "query_id": q.query_id,
                    "state": q.state,
                    "query": q.sql.strip(),
                    "trace_id": q.trace_id,
                    "plan_fingerprint": q.plan_fingerprint,
                    "elapsed_ms": q.elapsed_ms,
                    "planning_ms": q.planning_ms,
                    "optimization_ms": q.optimization_ms,
                    "staging_ms": q.staging_ms,
                    "execution_ms": q.execution_ms,
                    "compile_cache_hit": q.compile_cache_hit,
                    "batched": q.batched,
                    "cached": q.result_cache in ("hit", "stale"),
                    "retries": q.retries,
                    "input_rows": q.input_rows,
                    "input_bytes": q.input_bytes,
                    "output_rows": q.output_rows,
                    "error": q.error,
                }
                for q in hist
            ]
        if key == ("runtime", "nodes"):
            return self._node_rows()
        if key == ("runtime", "tasks"):
            return self._task_rows()
        if key == ("runtime", "metrics"):
            from presto_tpu_torch.utils.metrics import REGISTRY

            return [
                {"name": n, "kind": k, "value": v}
                for n, k, v in REGISTRY.snapshot()
            ]
        if key == ("runtime", "caches"):
            return self._cache_rows()
        if key == ("runtime", "materialized_views"):
            reg = getattr(self._runner, "_mview_registry", None)
            return reg.view_rows() if reg is not None else []
        if key == ("runtime", "memory"):
            return self._memory_rows()
        if key == ("runtime", "query_history"):
            store = getattr(self._runner, "history_store", None)
            return store.snapshot() if store is not None else []
        if key == ("metadata", "catalogs"):
            names = self._runner.catalogs.names() if self._runner else []
            return [
                {
                    "catalog_name": n,
                    "connector_id": type(
                        self._runner.catalogs.get(n)
                    ).__name__,
                }
                for n in names
            ]
        if key == ("runtime", "qos"):
            cluster = getattr(self._runner, "cluster", None)
            qos = getattr(cluster, "qos", None) if cluster else None
            # plane off (or plain local runner): an empty view, not an
            # error — dashboards can always select from it
            return qos.view_rows() if qos is not None else []
        if key == ("runtime", "snapshots"):
            return self._snapshot_rows()
        if key in _SERVER_TABLES:
            # fed by the server or the telemetry sampler, which a local
            # runner has not: an empty view, as the reference's local
            # runner serves
            return []
        raise KeyError(f"system table {handle.schema}.{handle.table}")

    def _snapshot_rows(self):
        """Per-table tip state of every mounted manifest store
        (server/manifests.py): the ingest lane's store plus any
        lakehouse-configured file connector, deduplicated by root —
        the common deployment points them at the SAME directory.
        Empty when no lakehouse is configured (plain WAL ingest or
        no ingest at all): a view, never an error."""
        if self._runner is None:
            return []
        stores = {}
        ing = getattr(self._runner, "ingest", None)
        store = getattr(ing, "store", None)
        if store is not None:
            stores[store.root] = store
        for name in self._runner.catalogs.names():
            conn = self._runner.catalogs.get(name)
            cstore = getattr(conn, "manifest_store", None)
            if cstore is not None:
                stores.setdefault(cstore.root, cstore)
        out = []
        for store in stores.values():
            for tk in store.tables():
                try:
                    out.append(store.table_stats(tk))
                except OSError:
                    continue  # torn directory mid-GC: skip the row
        out.sort(key=lambda r: r["table"])
        return out

    def _cache_rows(self):
        """Live occupancy of the engine caches (reference: the jmx
        cache-stats beans): the device-resident split cache (staged
        pages, LRU byte budget), the plan cache, the coordinator's
        result cache, the host-spill pool, the ingest WAL and the
        durable exchange spool."""
        if self._runner is None:
            return []
        split = self._runner.split_cache.stats()
        s = self._runner.plan_cache.stats()
        rows = [
            {
                "cache": "staging.split_cache",
                "entries": split["entries"],
                "bytes": split["bytes"],
                "budget_bytes": split["budget_bytes"],
                "hits": split["hits"],
                "misses": split["misses"],
                "evictions": split["evictions"],
            },
            {
                "cache": "plan.cache",
                "entries": s["entries"],
                "bytes": 0,  # plans are small host objects
                "budget_bytes": 0,
                "hits": s["hits"],
                "misses": s["misses"],
                "evictions": s["evictions"],
            },
        ]
        # serving-plane result cache (server/result_cache.py): the
        # snapshot-keyed entries the coordinator serves without planning
        # or dispatch (attached by the embedding coordinator; None on
        # plain runners)
        rc = getattr(self._runner, "result_cache", None)
        if rc is not None:
            r = rc.stats()
            rows.append(
                {
                    "cache": "result.cache",
                    "entries": r["entries"],
                    "bytes": r["bytes"],
                    "budget_bytes": r["budget_bytes"],
                    "hits": r["hits"],
                    "misses": r["misses"],
                    "evictions": r["evictions"],
                }
            )
        # host-spill pool: device pages offloaded to host RAM under
        # memory pressure; hits = restages
        rows.append(
            {
                "cache": "staging.host_spill",
                "entries": split["spill_entries"],
                "bytes": split["spill_bytes"],
                "budget_bytes": split["spill_budget_bytes"],
                "hits": split["restages"],
                "misses": 0,
                "evictions": split["spills"],
            }
        )
        # streaming-ingest WAL occupancy (server/ingest.py): pending
        # (durable, not yet committed) batches, WAL bytes on disk,
        # committed folds as hits, replayed tail batches as evictions
        ingest = getattr(self._runner, "ingest", None)
        if ingest is not None:
            w = ingest.stats()
            rows.append(
                {
                    "cache": "ingest.wal",
                    "entries": w["pending_batches"],
                    "bytes": w["wal_bytes"],
                    "budget_bytes": 0,
                    "hits": w["commits"],
                    "misses": 0,
                    "evictions": w["replayed"],
                }
            )
        # in-slice exchange segment (server/exchange_spi.py): device
        # pages parked for co-located consumers. hits = ICI edges
        # served, misses = planned-ICI fetches that fell back to the
        # wire, evictions = drain or retry materializations to HTTP
        from presto_tpu_torch.server.exchange_spi import SEGMENT
        from presto_tpu_torch.utils.metrics import REGISTRY

        seg = SEGMENT.stats()
        rows.append(
            {
                "cache": "exchange.ici",
                "entries": seg["entries"],
                "bytes": seg["bytes"],
                "budget_bytes": 0,  # bounded by the MemoryPool
                "hits": seg["hits"],
                "misses": seg["misses"],
                "evictions": int(
                    REGISTRY.counter("exchange.ici_materialized").total
                ),
            }
        )
        # durable-exchange spool occupancy (fault-tolerant execution):
        # present when the embedding coordinator has exchange.spool-path
        # configured (server.spool shares the directory with workers)
        cluster = getattr(self._runner, "cluster", None)
        spool = getattr(cluster, "spool", None) if cluster else None
        if spool is not None:
            x = spool.stats()
            rows.append(
                {
                    "cache": "exchange.spool",
                    "entries": x["entries"],
                    "bytes": x["bytes"],
                    "budget_bytes": x["budget_bytes"],
                    "hits": x["hits"],
                    "misses": x["misses"],
                    "evictions": x["evictions"],
                }
            )
        return rows

    def _memory_rows(self):
        """The runner's own pool (reference: system.memory's per-node
        pool occupancy on a local runner): one node row, then one row per
        owner holding bytes."""
        pool = getattr(self._runner, "memory_pool", None)
        if pool is None:
            return []
        snap = pool.snapshot()
        spilled = self._runner.split_cache.spill_used_bytes()
        rows = [
            {
                "node_id": "local",
                "query_id": "",
                "state": "BLOCKED" if snap["blocked"] else "OK",
                "reserved_bytes": snap["reserved"],
                "peak_bytes": max(snap["peak"].values(), default=0),
                "blocked_bytes": sum(b["bytes"] for b in snap["blocked"]),
                "spilled_bytes": spilled,
                "limit_bytes": snap["limit"],
            }
        ]
        for owner, nbytes in sorted(snap["used"].items()):
            rows.append(
                {
                    "node_id": "local",
                    "query_id": owner,
                    "state": "RESERVED",
                    "reserved_bytes": nbytes,
                    "peak_bytes": snap["peak"].get(owner, nbytes),
                    "blocked_bytes": 0,
                    "spilled_bytes": 0,
                    "limit_bytes": snap["limit"],
                }
            )
        return rows

    def _task_rows(self):
        """Per-task stats of distributed queries (reference:
        system.runtime.tasks), from the embedding coordinator's stage
        rollups; empty on a plain local runner. Retention follows the
        coordinator's bounded query map (MAX_QUERY_HISTORY completed
        queries) — tasks age out with their query."""
        cluster = getattr(self._runner, "cluster", None)
        if cluster is None:
            return []
        out = []
        for q in list(cluster.queries.values()):
            for stage in q.stats.stages:
                for t in list(stage.tasks):
                    out.append(
                        {
                            "query_id": t.query_id,
                            "stage_id": stage.stage_id,
                            "task_id": t.task_id,
                            "node_id": t.node_id,
                            "state": t.state,
                            "wall_ms": t.wall_ms,
                            "staging_ms": t.staging_ms,
                            "execute_ms": t.execute_ms,
                            "input_rows": t.input_rows,
                            "input_bytes": t.input_bytes,
                            "output_rows": t.output_rows,
                            "output_bytes": t.output_bytes,
                            "retries": t.retries,
                        }
                    )
        return out


    def _node_rows(self):
        from presto_tpu_torch.utils.devicediag import last_diag_dict

        cluster = getattr(self._runner, "cluster", None)
        if cluster is not None:
            pool_state = getattr(cluster, "pool_state", None)
            decision = getattr(cluster, "pool_decision", "")
            return [
                {
                    "node_id": w.node_id,
                    "http_uri": w.uri,
                    "node_version": w.version,
                    "coordinator": w.coordinator,
                    "state": w.state,
                    "preemptible": bool(getattr(w, "preemptible", False)),
                    "pool_state": (
                        pool_state(w)
                        if pool_state is not None
                        else "STABLE"
                    ),
                    # the autoscaler is a coordinator duty: its last
                    # decision renders on the coordinator row only
                    "last_decision": (
                        decision if w.coordinator else ""
                    ),
                    "backend_diag": json.dumps(
                        getattr(w, "backend_diag", {}) or {}
                    ),
                }
                for w in cluster.nodes()
            ]

        dev = getattr(self._runner, "device", None)
        if dev is not None and dev.type == "cuda":
            import torch

            n_dev = torch.cuda.device_count()
        else:
            n_dev = 1
        return [
            {
                "node_id": "local",
                "http_uri": "local://",
                "node_version": "presto-tpu-0.1",
                "coordinator": True,
                "state": f"ACTIVE ({n_dev} devices)",
                "preemptible": False,
                "pool_state": "STABLE",
                "last_decision": "",
                "backend_diag": json.dumps(last_diag_dict()),
            }
        ]

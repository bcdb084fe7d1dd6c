"""Local query runner: SQL in, rows out, on one device.

The PyTorch counterpart of ``presto_tpu/exec/local_runner.py``'s
``LocalQueryRunner``. A SELECT is parsed, then planned through the
statement-level plan cache (``plan/canonical.py``): its comparison
literals become ``RuntimeParam`` slots, so a repeated query shape (or a
warm ``EXECUTE`` of a prepared statement) binds new values into a plan
it has already planned and optimized. Scalar subqueries run first and
bind as literals, the root Output/Sort/Limit is peeled to the host
(``exec/host_ops.py``), and the rest runs as eager torch operators over
pages staged on the runner's device. A peeled root TopN over more rows
than its limit runs on the device before the result copy, which then
copies only the limit's rows. ``SET SESSION``, ``SHOW
SESSION/SCHEMAS/TABLES/COLUMNS``, ``PREPARE``, ``EXECUTE``,
``DEALLOCATE``, ``EXPLAIN`` and ``EXPLAIN ANALYZE`` run as in the
reference.

The write statements run against any connector with
``supports_writes()`` (``memory``, ``blackhole``): INSERT ... VALUES,
INSERT ... SELECT and CREATE TABLE AS append the inner query's rows
(``_result_columns``, built column by column from the host page),
CREATE/DROP TABLE are plain DDL, and DELETE and UPDATE run one SELECT
over the table (the kept complement; each assigned column as ``CASE
WHEN pred THEN e ELSE c END``) and replace its rows. A write's inner
query is planned with ``plan_statement`` directly (never the plan
cache) and runs under a QueryStats of its own, outside the query
history, whose pins and pool bytes are released when it ends. Every
write passes ``_invalidate_table_caches``: the table's staged pages
leave the split cache, its plans leave the plan cache, and the
materialized views' write epoch moves. CREATE/REFRESH/DROP
MATERIALIZED VIEW go to the runner's ``MViewRegistry``
(``exec/mview.py``, made at first use): every SELECT plans behind its
staleness read gate, and with session ``mview_auto_rewrite`` an
eligible aggregate over a base table reads the view that maintains it
(``server/result_cache.py::mview_rewrite``).

Every query is observed as the reference observes it: a ``Trace``
(query -> plan -> execute spans; under execute, a ``staging`` span per
table staged, per run of the operators ``dispatch``, ``control_read``
and ``result_copy``, a ``dynamic_filter`` per build-side key read, a
``root_topn`` where the root TopN runs on the device, and
``host_ops``; each mirrored on the profiler's timeline as
``presto.<name>`` while a profiler records, the root as ``execute``'s
``presto.query`` around the whole statement, with ``presto.parse``,
``presto.fragments``, ``presto.operator_stats`` and a
``presto.op.<NodeClass>`` span per plan node there alone), a
``QueryStats`` in the runner's ``history``
(``system.runtime.queries``), per-operator row counts
(session ``enable_operator_stats``: each counted node's 0-d live count
rides the run's one control read), device-plane counters
(``utils/telemetry.DEVICE``) and the query-completed listeners: the
JSONL event log, the slow-query log and the history store
(``plan/history.py``), which feeds learned cardinalities back into
planning and lets a stale plan-cache entry replan (adaptive
execution). The ``system`` catalog is registered in every runner.

Staged pages live in the runner's ``SplitCache`` (``exec/staging.py``):
whole tables always, split batches of a streamed scan when
``stream_split_cache`` is on, under one LRU byte budget
(``staging_cache_bytes``) reserved in the runner's ``MemoryPool`` when
it has one. A query pins the cached pages it reads until it ends.

Static shapes are kept: an aggregation that finds more groups than its
planned ``max_groups``, or a join whose output exceeds its
``out_capacity``, raises an overflow flag, and the plan re-runs with
every capacity scaled 4x (``_scale_capacities``).

A plan heavier than ``max_fragment_weight`` runs stage-at-a-time, as
the reference's does: heavy subtrees run as fragments of their own
(build side first), their results stay on the device re-bucketed to
their live rows, and an executed join build side pre-filters its probe
side (``exec/dynfilter.py``).

A plan that scans a table larger than ``max_device_rows`` streams
(``exec/streaming.py``): split batches staged at a fixed capacity
(``stage_split``) run through the fragment below the cut, partial states
or a join side's rows spill to host-RAM buckets, and each bucket runs
alone on the device.

The serving plane's micro-batch (``execute_plan_microbatch``, fed by the
coordinator's batch queue) answers N statements of one cached plan with
one pass of the operators: the scanned pages are repeated once per lane
(``page.tile_lanes``), each RuntimeParam reads its lane's value, and an
aggregation reduces each lane on its own (a one-hot GROUP BY through
K1's batching rule, ``ops/aggregation.py::onehot_reduce_lanes``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
import warnings
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from presto_tpu_torch import expr as E
from presto_tpu_torch import kernels
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors import create_connector
from presto_tpu_torch.connectors.spi import ConnectorSplit, payload_len
from presto_tpu_torch.exec import dynfilter, streaming
from presto_tpu_torch.exec.host_ops import (
    apply_host_ops,
    host_page,
    materialize_page,
    peel_host_ops,
    root_topn,
)
from presto_tpu_torch.exec.staging import (
    DEFAULT_CACHE_BYTES,
    CatalogManager,
    SplitCache,
    bucket_capacity,
    merge_column_chunks,
    obj_array,
    page_nbytes,
    stage_page,
)
from presto_tpu_torch.exec.stats import (
    JsonlQueryEventListener,
    OperatorStats,
    QueryHistory,
    QueryStats,
    SlowQueryLog,
    collect_node_stats,
    node_label,
)
from presto_tpu_torch.ops import (
    distinct,
    filter_project,
    hash_aggregate,
    hash_join,
    limit,
    order_by,
    project,
    union_all,
    unnest,
    unnest_column,
    window,
)
from presto_tpu_torch.ops.join import cross_join
from presto_tpu_torch.page import (
    Block,
    NoLaneForm,
    Page,
    compact_page,
    decode_column,
    pad_capacity,
    resolve_device,
    tile_lanes,
    to_host,
)
from presto_tpu_torch.plan import canonical
from presto_tpu_torch.plan import history as plan_history
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.plan.optimizer import (
    prune_columns,
    push_scan_constraints,
)
from presto_tpu_torch.plan.planner import Plan, plan_statement
from presto_tpu_torch.session import SYSTEM_SESSION_PROPERTIES, Session
from presto_tpu_torch.sql import ast, parse_statement
from presto_tpu_torch.utils import tracing
from presto_tpu_torch.utils.metrics import REGISTRY
from presto_tpu_torch.utils.telemetry import DEVICE
from presto_tpu_torch.utils.tracing import Trace


class ExecutionError(RuntimeError):
    pass


def _noop() -> None:
    """No-op release handle (stage_split callers without an owner)."""


class QueryResult:
    def __init__(self, columns: Tuple[str, ...], page: Page):
        self.columns = columns
        self.page = page

    def rows(self) -> List[tuple]:
        return [
            tuple(r[c] for c in self.columns) for r in self.page.to_pylist()
        ]

    def exact_rows(self) -> List[tuple]:
        """``rows()`` with short decimals as ``decimal.Decimal``: the
        write path's values, exact where a float would round."""
        cols = _result_columns(self)
        return list(zip(*(cols[c] for c in self.columns)))

    def row_dicts(self) -> List[dict]:
        return self.page.to_pylist()


class LocalQueryRunner:
    """Parse -> plan (cached) -> optimize -> eager execution on one
    device."""

    # each retry scales capacity buckets 4x, so 6 tries = up to 1024x
    # over the initial estimate
    MAX_RETRIES = 6

    def __init__(
        self,
        catalogs: Optional[CatalogManager] = None,
        session: Optional[Session] = None,
        device: Union[None, str, torch.device] = None,
        memory_pool=None,
        staging_cache_bytes: Optional[int] = None,
        plan_cache_entries: int = 256,
        history_path: Optional[str] = None,
        history_max_entries: int = 256,
    ):
        self.device = resolve_device(device)
        if catalogs is None:
            catalogs = CatalogManager()
            catalogs.register("tpch", create_connector("tpch"))
            catalogs.register("tpcds", create_connector("tpcds"))
        self.catalogs = catalogs
        self.session = session or Session()
        self.history = QueryHistory()
        if not catalogs.has("system"):
            from presto_tpu_torch.connectors.system_catalog import (
                SystemConnector,
            )

            catalogs.register("system", SystemConnector(runner=self))
        # query-event sink: one JSONL record per finished/failed query
        event_log = os.environ.get("PRESTO_TPU_EVENT_LOG")
        if event_log:
            self.history.add_listener(JsonlQueryEventListener(event_log))
        #: history-based statistics store (plan/history.py): per-operator
        #: actuals keyed by canonical plan fingerprints, written on the
        #: SAME query-completed path as the event sink; estimate_rows
        #: consults it (session enable_history_stats). None: planning is
        #: bit-exact pre-history
        self.history_store = None
        hist_path = history_path or os.environ.get(
            "PRESTO_TPU_HISTORY_PATH"
        )
        if hist_path:
            self.history_store = plan_history.QueryHistoryStore(
                hist_path, history_max_entries
            )
            self.history.add_listener(self.history_store)
        # slow-query JSONL sidecar (exec/stats.SlowQueryLog)
        slow_path = os.environ.get("PRESTO_TPU_SLOW_QUERY_LOG")
        if slow_path:
            try:
                slow_ms = float(
                    os.environ.get("PRESTO_TPU_SLOW_QUERY_MS", "0")
                )
            except ValueError:
                slow_ms = 0.0
            if slow_ms > 0:
                self.history.add_listener(SlowQueryLog(slow_path, slow_ms))
            else:
                # a path without a positive threshold would register a
                # listener that can never fire: refuse loudly
                warnings.warn(
                    "PRESTO_TPU_SLOW_QUERY_LOG is set but "
                    "PRESTO_TPU_SLOW_QUERY_MS is missing or <= 0; "
                    "the slow-query log is disabled",
                    stacklevel=2,
                )
        #: optional utils.memory.MemoryPool: cached pages reserve under
        #: the shared "table-cache" owner, uncached ones under the query
        self.memory_pool = memory_pool
        #: statement-level parameterized plan cache (plan/canonical.py)
        self.plan_cache = canonical.PlanCache(plan_cache_entries)
        #: per-execution RuntimeParam ordinal -> E.Literal bound values
        self._bound_local = threading.local()
        self._prepared: Dict[str, object] = {}
        #: device-resident staged-page cache: whole-table entries
        #: always, split-batch entries when stream_split_cache is on,
        #: under one LRU byte budget reserved in the memory pool
        self.split_cache = SplitCache(
            DEFAULT_CACHE_BYTES
            if staging_cache_bytes is None
            else staging_cache_bytes,
            pool=memory_pool,
        )
        #: restage traffic a query pays lands on its stats
        self.split_cache.on_restage = self._note_spilled
        #: host row counts of staged pages by cache key: a cache hit
        #: counts its input rows without reading num_valid back from
        #: the device
        self._staged_rows: Dict[tuple, int] = {}
        # QueryStats while a query is in flight, per thread
        self._qs_local = threading.local()
        # guards read-modify-write on a stats sink shared with the
        # prefetch thread
        self._qs_mu = threading.Lock()
        #: stage-at-a-time counters since the runner was made: fragments
        #: run on their own, and dynamic filters applied to a probe side
        self.fragments_run = 0
        self.dynamic_filters_applied = 0
        #: plan re-runs at 4x capacities after an overflow, since the
        #: runner was made
        self.overflow_retries = 0
        #: runs of a parameterized plan that failed and re-ran in
        #: literal form (canonical.bind_literal_root), since the runner
        #: was made
        self.literal_form_reruns = 0
        #: what streamed execution did (batches, buckets, spill, host
        #: seconds); a caller may replace it to count one query
        self.stream_stats = streaming.StreamStats()
        #: (root, signature memo) of each executed plan root, LRU by
        #: id (a cached plan's root is the same object on every run, so
        #: it is signed once)
        self._plan_sigs: "OrderedDict[int, tuple]" = OrderedDict()
        self._plan_sigs_mu = threading.Lock()
        #: the running query's operator metadata, per thread: its
        #: signature memo and the counted cells by run root
        self._run_meta = threading.local()
        #: ids of the QueryStats of runs kept out of the query history
        #: (EXPLAIN ANALYZE, a write's inner queries, view maintenance):
        #: pool owners
        self._internal_ids = itertools.count(1)
        #: materialized views (exec/mview.py): the registry is made at
        #: the first view statement, so the read and write seams skip it
        #: while it is None
        self._mview_registry = None
        #: the serving plane's result cache and streaming ingest lane
        #: attach here (``server/result_cache.py``, ``server/ingest.py``);
        #: a plain local runner has neither, so the write seam skips them
        self.result_cache = None
        self.ingest = None
        #: micro-batching: canonical fingerprints retired from batching
        #: (a node or aggregate with no lane form), and the batches
        #: served under each ``canonical.batch_entry_key``
        self._no_batch: set = set()
        self.batch_entries: Dict[tuple, int] = {}

    @property
    def mview_registry(self):
        """The materialized-view registry (exec/mview.py), made on
        first use; :attr:`_mview_registry` stays None until then."""
        if self._mview_registry is None:
            from presto_tpu_torch.exec.mview import MViewRegistry

            self._mview_registry = MViewRegistry(self)
        return self._mview_registry

    @property
    def _active_qs(self):
        return getattr(self._qs_local, "value", None)

    @_active_qs.setter
    def _active_qs(self, qs) -> None:
        self._qs_local.value = qs

    def _span(self, name: str, **attrs):
        """A span of the active query's tree when this thread runs inside
        it (the span yields its ``Span``), else one on the profiler's
        timeline alone (it yields None): a prefetch thread's or a
        micro-batch's spans never land beside the tree's root spans."""
        trace = getattr(self._active_qs, "trace", None)
        if trace is not None and trace.current() is not None:
            return trace.span(name, **attrs)
        return tracing.profiled(name)

    # ------------------------------------------------------------- public

    def execute(self, sql: str) -> QueryResult:
        # the statement's whole life, its parse included, is one
        # presto.query on the profiler's timeline; the parse comes before
        # the query's trace exists, so the tree's root is not mirrored
        with tracing.profiled("query"):
            return self._execute_statement(sql)

    def _execute_statement(self, sql: str) -> QueryResult:
        with tracing.profiled("parse"):
            stmt = parse_statement(sql)
        if isinstance(stmt, ast.SetSession):
            self.session.set(stmt.name, stmt.value)
            return QueryResult(("result",), _message_page("SET SESSION"))
        if isinstance(stmt, ast.Explain):
            return self._execute_explain(stmt, sql)
        if isinstance(stmt, ast.ShowSession):
            lines = [
                f"{k}={self.session.get(k)}"
                for k in sorted(SYSTEM_SESSION_PROPERTIES)
            ]
            return QueryResult(
                ("Session",), _lines_page("\n".join(lines), "Session")
            )
        if isinstance(stmt, ast.ShowColumns):
            return self._execute_show_columns(stmt)
        if isinstance(stmt, ast.CreateTable):
            return self._execute_create_table(stmt)
        if isinstance(stmt, ast.DropTable):
            return self._execute_drop_table(stmt)
        if isinstance(stmt, ast.CreateMaterializedView):
            self.mview_registry.create(stmt, sql)
            return QueryResult(
                ("result",), _message_page("CREATE MATERIALIZED VIEW")
            )
        if isinstance(stmt, ast.RefreshMaterializedView):
            self.mview_registry.refresh(stmt.target)
            return QueryResult(
                ("result",), _message_page("REFRESH MATERIALIZED VIEW")
            )
        if isinstance(stmt, ast.DropMaterializedView):
            self.mview_registry.drop(stmt.target, stmt.if_exists)
            return QueryResult(
                ("result",), _message_page("DROP MATERIALIZED VIEW")
            )
        if isinstance(stmt, ast.Prepare):
            self._prepared[stmt.name] = stmt.statement
            return QueryResult(("result",), _message_page("PREPARE"))
        if isinstance(stmt, ast.Deallocate):
            if stmt.name not in self._prepared:
                raise ExecutionError(
                    f"prepared statement {stmt.name!r} not found"
                )
            del self._prepared[stmt.name]
            return QueryResult(("result",), _message_page("DEALLOCATE"))
        if isinstance(stmt, ast.Execute):
            return self._execute_prepared(stmt, sql)
        if isinstance(stmt, ast.ShowSchemas):
            conn = self.catalogs.get(stmt.catalog or self.session.catalog)
            return QueryResult(
                ("Schema",),
                _lines_page(
                    "\n".join(conn.metadata().list_schemas()), "Schema"
                ),
            )
        if isinstance(stmt, ast.ShowTables):
            conn = self.catalogs.get(self.session.catalog)
            return QueryResult(
                ("Table",),
                _lines_page(
                    "\n".join(
                        conn.metadata().list_tables(
                            stmt.schema or self.session.schema
                        )
                    ),
                    "Table",
                ),
            )
        return self.execute_bound(stmt, sql)

    def _run_query(self, sql: str, stmt) -> QueryResult:
        """One query's lifecycle: its QueryStats, planning (a SELECT
        through the plan cache, with the stats live so a hit is
        attributed), execution, then the query's pins and pool bytes
        released, on success and on failure. The query's Trace holds a
        ``query`` span with ``plan`` and ``execute`` children."""
        qs = self.history.begin(sql)
        trace = Trace()
        qs.trace = trace
        qs.trace_id = trace.trace_id
        REGISTRY.counter("queries.submitted").update()
        t0 = time.perf_counter()
        try:
            # on the profiler's timeline, ``execute`` (or a coordinator's
            # own query span) already holds this one
            with REGISTRY.timer("query.wall_time").time(), trace.span(
                "query", query_id=qs.query_id, mirror=False
            ):
                with trace.span("plan"):
                    if isinstance(stmt, ast.Select):
                        # the stats sink is live DURING planning, so a
                        # plan cache hit (or an adaptive replan) is
                        # attributed to this query
                        prev_qs = self._active_qs
                        self._active_qs = qs
                        try:
                            plan, qs.plan_cache_hit = self.plan_cached(
                                stmt
                            )
                        finally:
                            self._active_qs = prev_qs
                    else:
                        plan = self._plan_statement(stmt)
                qs.planning_ms = (time.perf_counter() - t0) * 1000.0
                REGISTRY.distribution("plan.planning_ms").add(
                    qs.planning_ms
                )
                qs.state = "RUNNING"
                with trace.span("execute"):
                    result = self.execute_plan(plan, qs=qs)
        except Exception as e:
            REGISTRY.counter("queries.failed").update()
            self.history.finish(qs, error=f"{type(e).__name__}: {e}")
            self.release_pins(qs)
            if self.memory_pool is not None:
                self.memory_pool.release(qs.query_id)
            raise
        self.release_pins(qs)
        if self.memory_pool is not None:
            self.memory_pool.release(qs.query_id)
        self.history.finish(qs)
        REGISTRY.counter("queries.finished").update()
        REGISTRY.distribution("query.output_rows").add(qs.output_rows)
        return result

    def _execute_explain(self, stmt, sql: str) -> QueryResult:
        """EXPLAIN [ANALYZE]. ANALYZE's run holds its pins and pool bytes
        under a QueryStats of its own (``_statement_stats``); the run's
        actuals reach the history store through ``_record_history``."""
        from presto_tpu_torch.exec.explain import explain_text

        with (
            self._statement_stats("explain", sql)
            if stmt.analyze
            else contextlib.nullcontext()
        ) as qs:
            prev, self._active_qs = self._active_qs, qs
            try:
                text = explain_text(self, stmt, sql)
            finally:
                self._active_qs = prev
        return QueryResult(("Query Plan",), _lines_page(text))

    @contextlib.contextmanager
    def _statement_stats(self, kind: str, sql: str = ""):
        """A QueryStats of its own for a run the reference keeps out of
        the query history (EXPLAIN ANALYZE, a write's inner query, view
        maintenance): its pins and pool bytes are released when it
        ends, on success and on failure. The reference runs these with
        no QueryStats, so there every page the split cache does not
        keep (a ``system`` table, a table over the budget) stays
        reserved under "adhoc" (ROADMAP §3)."""
        qs = QueryStats(
            query_id=f"{kind}_{next(self._internal_ids)}",
            sql=sql,
            state="RUNNING",
            create_time=time.time(),
        )
        try:
            yield qs
        finally:
            self.release_pins(qs)
            if self.memory_pool is not None:
                self.memory_pool.release(qs.query_id)

    def run_internal(self, stmt, kind: str) -> QueryResult:
        """Run a statement AST the engine composed (a write's inner
        query, a maintenance query of ``exec/mview.py``): planned with
        ``plan_statement`` directly, as the reference plans them, so it
        never reaches the plan cache, the view read gate or the history
        scope, and executed under ``_statement_stats``."""
        with self._statement_stats(kind) as qs:
            plan = plan_statement(stmt, self.catalogs, self.session)
            return self.execute_plan(plan, qs=qs)

    # ------------------------------------------------------------ writes

    def _invalidate_table_caches(self, handle) -> None:
        """The one write-path seam: drop a written or dropped table's
        staged pages (whole-table and split alike, releasing their
        reservations) and its cached plans, and bump the table's write
        epoch in the materialized-view registry (the staleness gate's
        input). Every write passes here, a legacy one or an ingest
        commit."""
        self.split_cache.invalidate(handle)
        self.plan_cache.invalidate(handle)
        if self._mview_registry is not None:
            self._mview_registry.note_write(handle)
        # the serving plane's result cache rides the same seam
        if self.result_cache is not None:
            self.result_cache.note_write(handle)

    def _resolve_table(self, parts):
        """A 1-, 2- or 3-part table name -> (handle, connector), the
        session's catalog and schema filling what is missing."""
        from presto_tpu_torch.connectors.spi import TableHandle

        catalog, schema_name = self.session.catalog, self.session.schema
        if len(parts) == 3:
            catalog, schema_name, table = parts
        elif len(parts) == 2:
            schema_name, table = parts
        else:
            (table,) = parts
        return TableHandle(catalog, schema_name, table), self.catalogs.get(
            catalog
        )

    def _execute_write(self, stmt) -> QueryResult:
        """INSERT INTO ... SELECT | VALUES and CREATE TABLE AS against
        any connector with ``supports_writes()``; one ``rows`` row."""
        handle, conn = self._resolve_table(stmt.target)
        if not conn.supports_writes():
            raise ExecutionError(f"catalog {handle.catalog} is read-only")
        if isinstance(stmt, ast.CreateTableAs):
            res = self.run_internal(stmt.query, "write")
            tschema = {
                name: blk.dtype
                for name, blk in zip(res.page.names, res.page.blocks)
            }
            conn.create_table(handle, tschema)
            conn.append_rows(handle, _result_columns(res))
            n = int(res.page.num_valid)
        elif stmt.query is not None:
            tschema = conn.metadata().get_table_schema(handle)
            res = self.run_internal(stmt.query, "write")
            if len(res.columns) != len(tschema):
                raise ExecutionError(
                    f"INSERT column count mismatch: query has "
                    f"{len(res.columns)}, table has {len(tschema)}"
                )
            src = _result_columns(res)
            conn.append_rows(
                handle,
                {tcol: src[qcol] for tcol, qcol in zip(tschema, res.columns)},
            )
            n = int(res.page.num_valid)
        else:
            names = list(conn.metadata().get_table_schema(handle))
            rows = []
            for row in stmt.values:
                if len(row) != len(names):
                    raise ExecutionError(
                        f"INSERT VALUES arity {len(row)} != table "
                        f"columns {len(names)}"
                    )
                rows.append([_literal_value(e) for e in row])
            conn.append_rows(
                handle,
                {
                    name: obj_array([r[i] for r in rows])
                    for i, name in enumerate(names)
                },
            )
            n = len(rows)
        # a cacheable writable connector (memory) would otherwise serve
        # the pages staged before the write
        self._invalidate_table_caches(handle)
        return QueryResult(("rows",), _rows_page(n))

    def _execute_create_table(self, stmt) -> QueryResult:
        """CREATE TABLE t (col type, ...) against a writable connector."""
        handle, conn = self._resolve_table(stmt.target)
        if not conn.supports_writes():
            raise ExecutionError(f"catalog {handle.catalog} is read-only")
        conn.create_table(
            handle, {name: T.parse_type(t) for name, t in stmt.columns}
        )
        return QueryResult(("result",), _message_page("CREATE TABLE"))

    def _execute_drop_table(self, stmt) -> QueryResult:
        handle, conn = self._resolve_table(stmt.target)
        if not hasattr(conn, "drop_table"):
            raise ExecutionError(
                f"catalog {handle.catalog} does not support DROP TABLE"
            )
        if not conn.drop_table(handle) and not stmt.if_exists:
            raise ExecutionError(
                f"table {handle.schema}.{handle.table} does not exist"
            )
        self._invalidate_table_caches(handle)
        return QueryResult(("result",), _message_page("DROP TABLE"))

    def _execute_delete(self, stmt) -> QueryResult:
        """DELETE FROM t [WHERE pred]: keep the complement (the rows
        where the predicate is FALSE or NULL: SQL deletes only TRUE
        rows) through one SELECT, then replace the table's rows. The
        count before comes from the splits, without a scan."""
        handle, conn = self._resolve_table(stmt.target)
        if not hasattr(conn, "replace_rows"):
            raise ExecutionError(
                f"catalog {handle.catalog} does not support DELETE"
            )
        tschema = conn.metadata().get_table_schema(handle)
        before = 0
        src = conn.get_splits(handle)
        while not src.exhausted:
            for sp in src.next_batch(256):
                before += sp.num_rows
        if stmt.where is None:
            kept, n_kept = {c: [] for c in tschema}, 0
        else:
            # the keep-select as an AST: a text round trip breaks on
            # keyword-named or mixed-case identifiers
            keep_sel = ast.Select(
                items=tuple(
                    ast.SelectItem(ast.Ident((c,)), None) for c in tschema
                ),
                from_=ast.TableRef(
                    (handle.catalog, handle.schema, handle.table)
                ),
                where=ast.BinaryOp(
                    "or",
                    ast.UnaryOp("not", stmt.where),
                    ast.IsNullExpr(stmt.where),
                ),
            )
            res = self.run_internal(keep_sel, "write")
            payload = _result_columns(res)
            kept = {c: payload[c] for c in tschema}
            n_kept = int(res.page.num_valid)
        conn.replace_rows(handle, kept)
        self._invalidate_table_caches(handle)
        return QueryResult(("rows",), _rows_page(before - n_kept))

    def _execute_update(self, stmt) -> QueryResult:
        """UPDATE t SET c = e [WHERE pred]: the new contents are ONE
        select over the table, each assigned column ``CASE WHEN pred
        THEN e ELSE c END`` (a NULL predicate leaves the row as it
        was), then the table's rows are replaced. The affected rows are
        counted first, over the rows before the update."""
        handle, conn = self._resolve_table(stmt.target)
        if not hasattr(conn, "replace_rows"):
            raise ExecutionError(
                f"catalog {handle.catalog} does not support UPDATE"
            )
        tschema = conn.metadata().get_table_schema(handle)
        assigns = dict(stmt.assignments)
        unknown = set(assigns) - set(tschema)
        if unknown:
            raise ExecutionError(
                f"UPDATE of unknown column(s) {sorted(unknown)}"
            )
        table = ast.TableRef((handle.catalog, handle.schema, handle.table))
        items = []
        for c in tschema:
            e = ast.Ident((c,))
            if c in assigns:
                e = assigns[c]
                if stmt.where is not None:
                    e = ast.CaseExpr(None, ((stmt.where, e),), ast.Ident((c,)))
            items.append(ast.SelectItem(e, c))
        if stmt.where is not None:
            cnt_sel = ast.Select(
                items=(ast.SelectItem(ast.FuncCall("count", ()), "c"),),
                from_=table,
                where=stmt.where,
            )
            n = int(self.run_internal(cnt_sel, "write").rows()[0][0])
        res = self.run_internal(
            ast.Select(items=tuple(items), from_=table), "write"
        )
        if stmt.where is None:
            n = int(res.page.num_valid)
        payload = _result_columns(res)
        conn.replace_rows(handle, {c: payload[c] for c in tschema})
        self._invalidate_table_caches(handle)
        return QueryResult(("rows",), _rows_page(n))

    def _execute_show_columns(self, stmt) -> QueryResult:
        """SHOW COLUMNS FROM t / DESCRIBE t."""
        handle, conn = self._resolve_table(stmt.target)
        tschema = conn.metadata().get_table_schema(handle)
        page = Page.from_pydict(
            {
                "Column": list(tschema),
                "Type": [str(t) for t in tschema.values()],
            },
            {"Column": T.VARCHAR, "Type": T.VARCHAR},
            device="cpu",
        )
        return QueryResult(("Column", "Type"), page)

    def _execute_prepared(self, stmt, sql: str = "") -> QueryResult:
        """EXECUTE name [USING v, ...]: substitute the ? markers of the
        prepared AST with the literal arguments, then run the statement
        through the plan-cached path. A warm EXECUTE (its canonical
        shape already planned) parses nothing and plans nothing."""
        inner = self._prepared.get(stmt.name)
        if inner is None:
            raise ExecutionError(
                f"prepared statement {stmt.name!r} not found"
            )
        n_markers = _count_param_markers(inner)
        if n_markers != len(stmt.params):
            raise ExecutionError(
                f"EXECUTE {stmt.name}: statement has {n_markers} "
                f"parameter(s), {len(stmt.params)} given"
            )
        bound = _bind_param_markers(inner, stmt.params)
        return self.execute_bound(bound, sql)

    def execute_bound(self, bound, sql: str = "") -> QueryResult:
        """Run a statement AST that writes rows or queries: ``execute``'s
        last step, and EXECUTE's after marker substitution. A write goes
        to its handler, a query gets the lifecycle of any query. The
        reference runs an EXECUTEd query without one, so there the pool
        bytes of a table larger than the cache budget stay reserved
        under "adhoc" after every EXECUTE (ROADMAP §3)."""
        if isinstance(bound, (ast.Insert, ast.CreateTableAs)):
            return self._execute_write(bound)
        if isinstance(bound, ast.Delete):
            return self._execute_delete(bound)
        if isinstance(bound, ast.Update):
            return self._execute_update(bound)
        return self._run_query(sql, bound)

    def _history_scope(self):
        """History-based-statistics planning scope: installs the
        runner's store as the thread-local provider estimate_rows
        consults (plan/history.py), gated on session
        ``enable_history_stats``. No store, or the flag off, is a null
        scope: planning stays bit-exact pre-history."""
        if self.history_store is None or not self.session.get(
            "enable_history_stats"
        ):
            return contextlib.nullcontext()
        return plan_history.using(self.history_store)

    def _plan_statement(self, stmt) -> Plan:
        """plan_statement under the history scope."""
        with self._history_scope():
            return plan_statement(stmt, self.catalogs, self.session)

    def plan_cached(self, stmt) -> Tuple[Plan, bool]:
        plan, hit, _key = self.plan_cached_keyed(stmt)
        return plan, hit

    def plan_cached_keyed(self, stmt) -> Tuple[Plan, bool, Optional[str]]:
        """plan_cached plus the canonical statement key (None when the
        statement bypassed the cache).

        The one SELECT-planning seam every read path funnels through,
        so the materialized views' staleness read gate sits here: a
        referenced stale view refreshes before the statement plans
        (``MViewRegistry.max_staleness_s``). With session
        ``mview_auto_rewrite`` an eligible aggregate over a base table
        is rewritten onto the view that maintains it BEFORE
        canonicalization, so the plan-cache key names what executes; a
        failed rewrite falls open to the original statement."""
        if self._mview_registry is not None:
            self._mview_registry.read_gate(stmt)
            if self.session.get("mview_auto_rewrite"):
                from presto_tpu_torch.server.result_cache import (
                    mview_rewrite,
                )

                rewritten = mview_rewrite(
                    stmt, self._mview_registry, self.session
                )
                if rewritten is not None:
                    stmt, mv = rewritten
                    qs = self._active_qs
                    if qs is not None:
                        with self._qs_mu:
                            qs.mview_rewritten = ".".join(mv.parts)
        plan, hit, key = self._plan_cached(stmt)
        if hit:
            qs = self._active_qs
            if qs is not None:
                with self._qs_mu:
                    qs.plan_cache_hit = True
        return plan, hit, key

    def _plan_cached(self, stmt) -> Tuple[Plan, bool, Optional[str]]:
        """Statement-level parameterized plan cache -> (plan, hit, key).

        The statement canonicalizes (comparison-operand literals become
        BoundParam placeholders); the canonical AST keys a bounded LRU
        of planned and optimized plans whose RuntimeParam slots the
        current literal values bind into. A shape whose canonical form
        cannot plan is marked BYPASS and planned with literals in place
        from then on, as is a statement over a connector that prunes
        splits by its scan constraints: the cache degrades to classic
        planning, never to a failed query."""
        if not self.session.get("enable_plan_cache"):
            return self._plan_statement(stmt), False, None
        t0 = time.perf_counter()
        try:
            key, canon, lits = canonical.canonicalize_statement(
                stmt, self.session
            )
        except Exception:
            # canonicalization must never fail a query
            return self._plan_statement(stmt), False, None
        finally:
            REGISTRY.distribution("plan.canonicalize_ms").add(
                (time.perf_counter() - t0) * 1000.0
            )
        bound = {i: lit for i, lit in enumerate(lits)}
        entry = self.plan_cache.get(key)
        if isinstance(entry, canonical.PlanCacheEntry):
            # adaptive execution: an epoch-stale entry replans instead
            # of serving the plan its worst early estimates built (None:
            # the entry is still fresh, or the plane is off)
            replanned = self._adaptive_replan(key, entry, canon, bound)
            if replanned is not None:
                return replanned
            return (
                Plan(
                    root=entry.root,
                    params=entry.params,
                    output_names=entry.output_names,
                    bound_values=bound,
                    preoptimized=entry.preoptimized,
                ),
                True,
                key,
            )
        if entry is canonical.BYPASS:
            return self._plan_statement(stmt), False, None
        try:
            # capture which history fingerprints (and which estimates)
            # this planning consulted: the evidence a later hit is
            # re-validated against (a null scope with adaptive off)
            with self._capture_scope() as consulted:
                plan = self._plan_statement(canon)
        except Exception:
            # parameterized planning failed (a hoisted literal in a
            # structural position): permanent literal-form lane
            self.plan_cache.put(key, canonical.BYPASS)
            return self._plan_statement(stmt), False, None
        handles = canonical.plan_handles(plan)
        if any(
            self.catalogs.get(h.catalog).prunes_splits() for h in handles
        ):
            # split-pruning connectors read equality/IN literals as scan
            # constraints; a parameterized plan would silently cost them
            # their pruning
            self.plan_cache.put(key, canonical.BYPASS)
            return self._plan_statement(stmt), False, None
        return self._store_canonical_entry(
            key, plan, consulted, bound, handles, len(lits)
        )

    def _capture_scope(self):
        """Consult capture around canonical-statement planning, active
        only when the adaptive plane could read the evidence (session
        ``adaptive_enabled``). Entries planned with the plane off carry
        no evidence and are never replanned."""
        if self.session.get("adaptive_enabled"):
            return plan_history.capture_consults()
        return contextlib.nullcontext({})

    def _store_canonical_entry(
        self, key, plan, consulted, bound, handles, n_slots
    ):
        """Build and store the cache entry of a planned canonical
        statement; -> its bound ``(plan, False, key)``. The one entry
        constructor the miss path and the adaptive replan share."""
        root, preopt = plan.root, False
        if not plan.params:
            # value-independent over a canonical root: optimize ONCE at
            # store time so hits skip it (plans with scalar-subquery
            # params keep the execute-time order: binding substitutes
            # Params first)
            root = push_scan_constraints(prune_columns(root))
            preopt = True
        self.plan_cache.put(
            key,
            canonical.PlanCacheEntry(
                root=root,
                params=plan.params,
                output_names=plan.output_names,
                preoptimized=preopt,
                handles=handles,
                n_slots=n_slots,
                consulted=dict(consulted),
            ),
        )
        return (
            Plan(
                root=root,
                params=plan.params,
                output_names=plan.output_names,
                bound_values=bound,
                preoptimized=preopt,
            ),
            False,
            key,
        )

    def _adaptive_replan(self, key, entry, canon, bound):
        """Epoch-versioned plan cache: a statement-cache HIT whose
        consulted history estimates have materially diverged
        (``canonical.stale_consults``) replans the canonical statement
        against today's learned cardinalities and REPLACES the entry.
        Fail-open: a replan that fails serves the cached plan. Returns
        the ``(plan, False, key)`` triple, or None when the entry is
        still fresh or the plane is off."""
        if not self.session.get("adaptive_enabled"):
            return None
        store = self.history_store
        if (
            store is None
            or not self.session.get("enable_history_stats")
            or not entry.consulted
        ):
            return None
        factor = float(self.session.get("adaptive_divergence_factor"))
        stale = canonical.stale_consults(entry.consulted, store, factor)
        if stale is None:
            return None
        fp, old_epoch, new_epoch = stale
        REGISTRY.counter("adaptive.divergence_detected").update()
        try:
            with plan_history.capture_consults() as consulted:
                plan = self._plan_statement(canon)
            out = self._store_canonical_entry(
                key, plan, consulted, bound,
                canonical.plan_handles(plan), entry.n_slots,
            )
        except Exception:
            # the cached plan still answers correctly (its estimates
            # were stale, not its semantics): serve it
            REGISTRY.counter("plan.replan_failures").update()
            return None
        REGISTRY.counter("plan.replans").update()
        self.plan_cache.note_replan()
        qs = self._active_qs
        if qs is not None:
            with self._qs_mu:
                qs.replanned = True
                qs.adaptive_notes.append(
                    f"REPLANNED (epoch {old_epoch}→{new_epoch}) "
                    f"node {fp}"
                )
        return out

    def execute_plan(self, plan: Plan, qs=None) -> QueryResult:
        prev, self._active_qs = self._active_qs, qs
        prev_bound = getattr(self._bound_local, "value", None)
        prev_meta = getattr(self._run_meta, "value", None)
        if plan.bound_values is not None:
            # a cached canonical plan: the execution's literal values
            # ride thread-local to _run_with_pages, which installs them
            # as the active parameter vector
            self._bound_local.value = plan.bound_values
        try:
            root = self._bind_params(plan)
            if not plan.preoptimized:
                t_opt = time.perf_counter()
                with self._history_scope():
                    root = push_scan_constraints(prune_columns(root))
                if qs is not None:
                    qs.optimization_ms += (
                        time.perf_counter() - t_opt
                    ) * 1000.0
            memo = None
            if self.session.get("enable_operator_stats"):
                try:
                    sigs = self._plan_signatures(root)
                    memo = plan_history.SignatureMemo(sigs)
                    if qs is not None and not qs.plan_fingerprint:
                        # canonical statement identity: keys the history-
                        # store record and enriches the query event
                        qs.plan_fingerprint = sigs.fingerprints(
                            root, [root]
                        )[id(root)]
                except Exception:
                    pass
            host_ops: List[N.PlanNode] = []
            if self.session.get("host_root_stage"):
                root, host_ops = peel_host_ops(root)
            t0 = time.perf_counter()
            self._run_meta.value = (memo, {})
            page = self._run(root, topn=root_topn(host_ops))
            if host_ops:
                with self._span("host_ops"):
                    page = apply_host_ops(page, host_ops)
            if qs is not None:
                qs.execution_ms += (time.perf_counter() - t0) * 1000.0
                qs.output_rows = int(page.num_valid)
        finally:
            self._active_qs = prev
            self._bound_local.value = prev_bound
            self._run_meta.value = prev_meta
        return QueryResult(plan.output_names, page)

    def execute_plan_analyzed(self, plan: Plan, sql: str = ""):
        """EXPLAIN ANALYZE: run the plan whole-table (``_run_with_pages``
        over every scan, neither streamed nor fragmented, as the
        reference's single-device instrumented run) with EVERY node's
        row count read back in the run's one control read, and the host
        root stage peeled as ``execute_plan`` peels it. Returns
        (QueryResult, List[PlanNodeStats] of the device tree, rows after
        each host op innermost-first, the bound pre-peel root, the device
        root run, the host ops peeled, id(node) -> (planning-time
        estimate, provenance)): the trees that ran, so EXPLAIN ANALYZE
        annotates the exact nodes."""
        from presto_tpu_torch.exec.explain import _estimate_map

        bound_root = push_scan_constraints(
            prune_columns(self._bind_params(plan))
        )
        root = bound_root
        host_ops: List[N.PlanNode] = []
        if self.session.get("host_root_stage"):
            root, host_ops = peel_host_ops(root)
        scans = [n for n in N.walk(root) if isinstance(n, N.TableScanNode)]
        # PLANNING-time estimates, taken BEFORE the run's actuals reach
        # the history store: a warm run's history-fed estimates shrink
        # the printed error, a cold run's show the real miss
        with self._history_scope():
            est_map = _estimate_map(root, self.catalogs)
        pages = [self._load_table(s) for s in scans]
        stats_cell: List = []
        page = self._run_with_pages(root, scans, pages, stats_out=stats_cell)
        host_rows: List[int] = []
        if host_ops:
            with self._span("host_ops"):
                page = apply_host_ops(page, host_ops, rows_out=host_rows)
        stats = collect_node_stats(stats_cell)
        self._record_history(root, stats, stmt_root=bound_root, sql=sql)
        return (
            QueryResult(plan.output_names, page),
            stats,
            host_rows,
            bound_root,
            root,
            host_ops,
            est_map,
        )

    def _record_history(
        self,
        droot: N.PlanNode,
        stats,
        stmt_root: Optional[N.PlanNode] = None,
        sql: str = "",
    ) -> None:
        """Persist an analyzed run's per-node actuals to the history
        store (EXPLAIN ANALYZE makes no QueryStats, but its run measured
        the same truth), keyed by the PRE-peel bound root's fingerprint,
        the tree ``execute_plan`` fingerprints, so the analyzed run
        updates the normal run's entry."""
        if self.history_store is None:
            return
        try:
            fps = plan_history.node_fingerprints(droot)
            by_walk = {i: n for i, n in enumerate(N.walk(droot))}
            nodes = {}
            for st in stats:
                n = by_walk.get(st.node_id)
                if n is None or st.output_rows < 0:
                    continue
                fp = fps.get(id(n), "")
                if fp:
                    nodes[fp] = {
                        "rows": int(st.output_rows),
                        "label": st.label,
                    }
            self.history_store.record_query(
                plan_history.plan_fingerprint(
                    droot if stmt_root is None else stmt_root
                ),
                sql,
                nodes,
            )
        except Exception:
            pass  # a broken store must never fail EXPLAIN ANALYZE

    def _plan_signatures(self, root: N.PlanNode):
        """The signature memo of ``root``'s whole tree, signed once per
        root object."""
        with self._plan_sigs_mu:
            got = self._plan_sigs.get(id(root))
            if got is not None and got[0] is root:
                self._plan_sigs.move_to_end(id(root))
                return got[1]
        sigs = plan_history.SignatureMemo()
        sigs.fingerprints(root, [root])
        with self._plan_sigs_mu:
            self._plan_sigs[id(root)] = (root, sigs)
            while len(self._plan_sigs) > 256:
                self._plan_sigs.popitem(last=False)
        return sigs

    # ------------------------------------------------- params (subqueries)

    def _bind_params(self, plan: Plan) -> N.PlanNode:
        """Run each scalar subquery (its own subqueries first) and
        substitute its one value into the plan as a Literal."""
        bindings: Dict[int, E.Literal] = {}
        for pid, sub in plan.params:
            sub_root = push_scan_constraints(
                prune_columns(self._bind_params(sub))
            )
            page = self._run(sub_root)
            bindings[pid] = _scalar_literal(page, sub.output_names[0])
        if not bindings:
            return plan.root
        return _substitute_params(plan.root, bindings)

    # ---------------------------------------------------------- execution

    def _run(
        self, root: N.PlanNode, topn: Optional[N.SortNode] = None
    ) -> Page:
        """Run a device plan and fetch its result. ``topn``, the
        statement's peeled root TopN (``execute_plan`` alone passes it),
        rides to the run that fetches the statement's result; a streamed
        run keeps the host sort."""
        if streaming.needs_streaming(root, self.catalogs, self.session):
            # larger-than-device input: split-streamed partial
            # aggregation with hash-bucketed host spill
            return streaming.run_streamed(self, root)
        budget = int(self.session.get("max_fragment_weight"))
        if budget > 0 and _plan_weight(root) > budget:
            return self._run_fragmented(root, budget, topn)
        scans = [n for n in N.walk(root) if isinstance(n, N.TableScanNode)]
        pages = [self._load_table(s) for s in scans]
        return self._run_with_pages(root, scans, pages, topn=topn)

    # ------------------------------------------- stage-at-a-time execution

    def _run_fragmented(
        self,
        root: N.PlanNode,
        budget: int,
        topn: Optional[N.SortNode] = None,
    ) -> Page:
        """Execute a heavy plan stage-at-a-time: heavy subtrees run as
        fragments of their own, their outputs stay on the device, and
        the remaining tree consumes them as leaves (its run alone takes
        ``topn``)."""
        pages_map: Dict[int, Page] = {}
        with tracing.profiled("fragments"):
            reduced = self._reduce_fragment(root, budget, pages_map)
        leaves, pages = self.leaf_pages(reduced, pages_map)
        return self._run_with_pages(reduced, leaves, pages, topn=topn)

    def leaf_pages(
        self, root: N.PlanNode, pages_map: Dict[int, Page]
    ) -> Tuple[List[N.PlanNode], List[Page]]:
        """A fragment's leaves (scans + remote sources) and their input
        pages: scans load (cached) tables, remote sources resolve
        through ``pages_map`` (id(node) -> already-produced page)."""
        leaves = [
            n
            for n in N.walk(root)
            if isinstance(n, (N.TableScanNode, N.RemoteSourceNode))
        ]
        pages = [
            pages_map[id(n)]
            if isinstance(n, N.RemoteSourceNode)
            else self._load_table(n)
            for n in leaves
        ]
        return leaves, pages

    def _reduce_fragment(
        self, node: N.PlanNode, budget: int, pages_map: Dict[int, Page]
    ) -> N.PlanNode:
        """Bottom-up: shrink ``node``'s subtree to at most ``budget``
        weight by executing its heaviest child subtrees as fragments of
        their own (device-resident results become RemoteSourceNode
        leaves). A node whose own weight exceeds the budget with only
        leaf children runs as one fragment anyway."""
        node = N.map_children(
            node, lambda c: self._reduce_fragment(c, budget, pages_map)
        )
        while _plan_weight(node) > budget:
            cands = [
                c
                for c in node.children()
                if not isinstance(
                    c, (N.TableScanNode, N.RemoteSourceNode, N.ValuesNode)
                )
            ]
            if not cands:
                break
            # BUILD side first when reducing a join (build before
            # probe): its executed page then feeds a dynamic filter
            # into the probe side
            if isinstance(node, N.JoinNode) and node.right in cands:
                child = node.right
            else:
                child = max(cands, key=_plan_weight)
            leaf = self._execute_to_leaf(child, pages_map)
            node = N.map_children(node, lambda c: leaf if c is child else c)
            node = self._apply_dynamic_filter(node, leaf, pages_map)
        return node

    def _apply_dynamic_filter(
        self, node: N.PlanNode, leaf: N.RemoteSourceNode, pages_map
    ) -> N.PlanNode:
        """When a join's BUILD side has just run as a fragment, fetch its
        join-key summary (one host read) and pre-filter the probe side,
        which has not run yet: probe rows outside the build's key domain
        cannot match an inner or semi join."""
        if not self.session.get("enable_dynamic_filtering"):
            return node
        if not (
            isinstance(node, N.JoinNode)
            and node.right is leaf
            and node.join_type in ("inner", "semi")
            and not isinstance(node.left, (N.RemoteSourceNode, N.ValuesNode))
        ):
            return node
        with self._span("dynamic_filter"):
            conjuncts, n_filters = dynfilter.device_conjuncts(
                pages_map[id(leaf)],
                list(zip(node.left_keys, node.right_keys)),
                node.left.output_schema(),
                ndv_limit=int(
                    self.session.get("dynamic_filtering_ndv_limit")
                ),
            )
        if not conjuncts:
            return node
        self.dynamic_filters_applied += n_filters
        REGISTRY.counter("dynamic_filter.built").update()
        REGISTRY.counter("dynamic_filter.applied").update(n_filters)
        self._fold_dyn_stat("dynamic_filters", n_filters)
        pred = conjuncts[0] if len(conjuncts) == 1 else E.And(tuple(conjuncts))
        # marked dynamic: its pruned-row count rides the probe run's
        # control read (dynamic_filter.rows_pruned)
        return dataclasses.replace(
            node,
            left=N.FilterNode(source=node.left, predicate=pred, dynamic=True),
        )

    def _execute_to_leaf(
        self, subtree: N.PlanNode, pages_map: Dict[int, Page]
    ) -> N.RemoteSourceNode:
        """Run one fragment; its result stays on the device, re-bucketed
        to its live rows, and is read through a RemoteSourceNode."""
        leaves, pages = self.leaf_pages(subtree, pages_map)
        remote = N.RemoteSourceNode(fragment_root=subtree)
        pages_map[id(remote)] = self._run_with_pages(
            subtree, leaves, pages, fetch_result=False
        )
        self.fragments_run += 1
        if self._active_qs is not None:
            with self._qs_mu:
                self._active_qs.device_fragments += 1
        return remote

    # ------------------------------------------------ micro-batched serving

    def microbatch_plan_eligible(self, plan) -> bool:
        """Cheap structural screen before a statement may join a
        micro-batch: a cached canonical plan (bound values present), no
        scalar-subquery pre-passes, already pre-optimized, small enough
        to run whole, and not a streamed scan. Everything else keeps the
        scalar path: batching can cost a wait, never a wrong answer or
        a failed query."""
        if (
            plan.bound_values is None
            or plan.params
            or not plan.preoptimized
        ):
            return False
        root = plan.root
        if streaming.needs_streaming(root, self.catalogs, self.session):
            return False
        budget = int(self.session.get("max_fragment_weight"))
        if budget > 0 and _plan_weight(root) > budget:
            return False
        return True

    def execute_plan_microbatch(self, plans, qs_list):
        """Answer N plans of one cached shape (one plan-cache entry, N
        bound-value vectors) with ONE pass of the operators: the
        members' vectors stack along a lane axis as device tensors
        (``canonical.lane_vectors``), every scanned page is repeated
        once per lane (``page.tile_lanes``), and the plan runs once
        over those lane-blocked pages, where each RuntimeParam reads
        its lane's value and an aggregation reduces each lane on its
        own (a one-hot GROUP BY is one K1 launch for every lane).
        Each lane is compacted to the speculative window on
        the device, and one host read fetches the control values and
        every lane's window.

        Returns a list aligned with ``plans``: a QueryResult for every
        lane the batch served, ``None`` for members that fall out (an
        error bit or an overflow flag in the batch, output beyond the
        window), which the caller re-runs on the scalar path. All-None
        means the shape has no lane form (it is then retired from
        batching: a node or an aggregate of it raised ``NoLaneForm``)
        or no lane axis (nothing bound). Any other error propagates: a
        failed launch is never turned into a fallout."""
        n = len(plans)
        none: List = [None] * n
        if n < 2:
            return none
        plan0 = plans[0]
        root = plan0.root
        host_ops: List[N.PlanNode] = []
        if self.session.get("host_root_stage"):
            root, host_ops = peel_host_ops(root)
        # the demux slices flat blocks; nested output shapes keep the
        # scalar path
        if any(t.is_nested for t in root.output_schema().values()):
            return none
        spec = int(self.session.get("speculative_result_rows"))
        if spec <= 0 or not plan0.bound_values:
            return none  # no window, or nothing bound: no lane axis
        counted = bool(self.session.get("enable_operator_stats"))
        offload = self.session.get("tpu_offload")
        try:
            canonical.batch_lanes(n)
            stacked = canonical.stack_param_vectors(
                [canonical.bound_vector(p.bound_values) for p in plans], n
            )
        except (KeyError, ValueError):
            return none
        cfp = root.fingerprint()
        if cfp in self._no_batch:
            return none
        scans = [s for s in N.walk(root) if isinstance(s, N.TableScanNode)]
        # stage the shared scan pages under the LEADER's sink (pins and
        # staging attribution); the leader's input fold is undone at
        # once, and every served lane attributes the scan below
        leader = qs_list[0]
        prev_qs = self._active_qs
        self._active_qs = leader
        rows0 = leader.input_rows if leader is not None else 0
        bytes0 = leader.input_bytes if leader is not None else 0
        try:
            pages = [self._load_table(s) for s in scans]
        finally:
            self._active_qs = prev_qs
        in_rows = in_bytes = 0
        if leader is not None:
            with self._qs_mu:
                in_rows = leader.input_rows - rows0
                in_bytes = leader.input_bytes - bytes0
                leader.input_rows = rows0
                leader.input_bytes = bytes0
        scan_ids = {id(s): i for i, s in enumerate(scans)}
        ctx = _ExecContext(
            None, scan_ids, self.device,
            counters=[] if counted else None, count_all=False, lanes=n,
        )
        t_disp = time.perf_counter()
        with self._span("dispatch"):
            try:
                ctx.pages = [tile_lanes(p, n) for p in pages]
                with canonical.active_params(
                    canonical.lane_vectors(stacked, self.device)
                ):
                    out = _execute_node(root, ctx)
            except NoLaneForm:
                # the shape has no lane form: scalar serving still works
                self._no_batch.add(cfp)
                REGISTRY.counter("serving.batch_retired").update()
                return none
            lane_cap = out.capacity // n
            window = min(spec, lane_cap)
            live = out.row_mask().reshape(n, lane_cap)
            # each lane's first ``window`` live rows, in order, as indices
            # into the lane-blocked page (nonzero_static along each lane)
            rank = torch.cumsum(live.to(torch.int64), dim=1) - 1
            slot = torch.where(live & (rank < window), rank, window)
            sel = torch.zeros(
                (n, window + 1), dtype=torch.int64, device=live.device
            )
            sel.scatter_(
                1,
                slot,
                torch.arange(lane_cap, dtype=torch.int64, device=live.device)
                .expand(n, lane_cap),
            )
            idx = (
                sel[:, :window]
                + torch.arange(n, dtype=torch.int64, device=live.device)[
                    :, None
                ]
                * lane_cap
            ).reshape(-1)
            counts = [c for _, c, _, _ in ctx.counters or ()]
            scalars = [f.reshape(()) for f in ctx.flags] + [
                e.reshape(()) for _, e in ctx.errors
            ]
            control = torch.cat(
                ([torch.stack(scalars).to(torch.int64)] if scalars else [])
                + [c.to(torch.int64) for c in counts]
                + [torch.sum(live, dim=1, dtype=torch.int64)]
            )
            leaves = [control]
            for blk in out.blocks:
                leaves.append(blk.data[idx])
                if blk.valid is not None:
                    leaves.append(
                        torch.broadcast_to(blk.valid, (out.capacity,))[idx]
                    )
        t_disped = time.perf_counter()
        # ONE host read for every lane: the control values and each
        # lane's window of every block
        with self._span("control_read"):
            fetched = to_host(leaves)
        t_fetched = time.perf_counter()
        control = fetched[0].tolist()
        batch_d2h = sum(int(t.nbytes) for t in fetched)
        builds = kernels.take_builds()
        if DEVICE.enabled:
            DEVICE.count_dispatch()
            DEVICE.count_d2h(batch_d2h)
            for ms in builds:
                DEVICE.count_compile(ms)
            if builds and leader is not None:
                # a kernel built in this pass is the leader's to show
                with self._qs_mu:
                    leader.device_compiles += len(builds)
                    leader.device_compile_ms += sum(builds)
        bad = any(control[: len(scalars)])
        pos = len(scalars)
        lane_counts = []
        for _ in counts:
            lane_counts.append(control[pos: pos + n])
            pos += n
        n_lane = control[pos: pos + n]
        wall_ms = (t_fetched - t_disp) * 1000.0
        device_ms = (t_fetched - t_disped) * 1000.0
        cells = (
            self._counter_cells(root, ctx.counters, False)
            if counted and ctx.counters
            else None
        )
        results: List = [None] * n
        served = 0
        for i in range(n):
            n_i = n_lane[i]
            if bad or n_i > window:
                # an error bit or an overflow flag (the scalar path
                # raises the member's real error or retries), or output
                # beyond the window (scalar materialization)
                continue
            # lane i's first n_i rows of every fetched window
            lane_page = host_page(
                out,
                [t[i * window: i * window + n_i] for t in fetched[1:]],
                n_i,
            )
            if host_ops:
                with self._span("host_ops"):
                    lane_page = apply_host_ops(lane_page, host_ops)
            results[i] = QueryResult(plan0.output_names, lane_page)
            served += 1
            qs = qs_list[i]
            if qs is None:
                continue
            with self._qs_mu:
                qs.batched = True
                qs.batch_size = n
                qs.output_rows = int(lane_page.num_valid)
                qs.execution_ms += wall_ms / n
                # every SERVED lane scanned the shared pages
                qs.input_rows += in_rows
                qs.input_bytes += in_bytes
                if DEVICE.enabled:
                    qs.device_dispatches += 1
                    qs.device_d2h_bytes += batch_d2h // n
            if cells is not None:
                self._active_qs = qs
                try:
                    self._fold_operator_stats(
                        cells,
                        [c[i] for c in lane_counts],
                        wall_ms=wall_ms / n,
                        device_ms=device_ms / n,
                        prog=root,
                    )
                finally:
                    self._active_qs = prev_qs
        key = canonical.batch_entry_key(
            cfp, counted, offload, canonical.batch_lanes(n), window
        )
        with self._qs_mu:
            self.batch_entries[key] = self.batch_entries.get(key, 0) + 1
        REGISTRY.counter("serving.batches").update()
        REGISTRY.counter("serving.batched_statements").update(served)
        REGISTRY.distribution("serving.batch_occupancy").add(served)
        return results

    def _run_with_pages(
        self,
        root: N.PlanNode,
        scans: List[N.PlanNode],
        pages: List[Page],
        fetch_result: bool = True,
        stats_out: Optional[List] = None,
        topn: Optional[N.SortNode] = None,
    ) -> Page:
        """Run the plan over its leaf pages, re-running at 4x capacities
        while an operator reports overflow. One host read per attempt
        fetches the flags, the error bits, the per-node row counts, the
        dynamic filters' pruned rows and the live count.

        Per-node row counts (exec/stats.OperatorStats) are taken on
        every run with session ``enable_operator_stats`` (the counted
        nodes of ``_COUNTED_NODES``) and folded into the active query's
        stats; with ``stats_out`` (EXPLAIN ANALYZE) every node is
        counted and ``stats_out`` receives (walk_id, label, rows,
        capacity) records. Only the attempt that did not overflow is
        folded.

        Returns the result page on the host; with ``fetch_result=False``
        (a stage-at-a-time fragment) the page stays on the device,
        compacted and re-bucketed to its live rows. With ``topn`` (the
        statement's root TopN) and more live rows than its limit, the
        card sorts the rows and only the limit's rows are copied
        (``_root_topn``); the host stage still applies the TopN."""
        scan_ids = {id(s): i for i, s in enumerate(scans)}
        bound = getattr(self._bound_local, "value", None)
        analyzed = stats_out is not None
        counted = analyzed or bool(
            self.session.get("enable_operator_stats")
        )
        # program-instance token for operator-stats folding: streamed
        # batches re-enter with the SAME root object (their folds sum),
        # while distinct runs of one query (scalar-subquery pre-passes,
        # sibling fragments) are different objects
        prog_root = root
        tries = 0
        while True:
            ctx = _ExecContext(
                pages, scan_ids, self.device,
                counters=[] if counted else None, count_all=analyzed,
            )
            t_disp = time.perf_counter()
            with self._span("dispatch"):
                try:
                    with canonical.active_params(bound):
                        out = compact_page(_execute_node(root, ctx))
                except Exception:
                    if not bound:
                        raise
                    # the parameterized form failed (a RuntimeParam fed
                    # an operator that needs its value on the host):
                    # re-run with the values bound back as Literals, as
                    # the reference's literal-form lane does. The literal
                    # form has no parameter vector, so this cannot loop;
                    # the failed attempt's counters are discarded with
                    # ctx.
                    root, scan_ids = _literal_form(root, scan_ids, bound)
                    bound = None
                    self.literal_form_reruns += 1
                    continue
                counts = [c for _, c, _, _ in ctx.counters or ()]
                control_t, order = _control_vector(
                    [f.reshape(()) for f in ctx.flags]
                    + [e.reshape(()) for _, e in ctx.errors]
                    + [c.reshape(()) for c in counts]
                    + [d.reshape(()) for d in ctx.dyn]
                    + [out.num_valid.reshape(())]
                )
            t_disped = time.perf_counter()
            with self._span("control_read"):
                control = _in_order(control_t.cpu().tolist(), order)
            t_fetched = time.perf_counter()
            # one attempt of the plan's operators (an overflowed one ran
            # too) and the bytes of its control read
            self._count_control_read(control_t)
            nf, ne, nc = len(ctx.flags), len(ctx.errors), len(counts)
            for (msg, _), bit in zip(ctx.errors, control[nf:nf + ne]):
                if bit:
                    raise ExecutionError(msg)
            if not any(control[:nf]):
                cnt = control[nf + ne: nf + ne + nc]
                dyn = control[nf + ne + nc: -1]
                n = control[-1]
                if counted and ctx.counters:
                    with tracing.profiled("operator_stats"):
                        cells = self._counter_cells(
                            root, ctx.counters, analyzed
                        )
                        if analyzed:
                            stats_out.clear()
                            stats_out.extend(
                                (walk_id, label, int(c), cap)
                                for (walk_id, label, cap, _nb, _dp, _fp,
                                     _ch), c in zip(cells, cnt)
                            )
                        # only the successful attempt counts: an
                        # overflowed one re-ran the same rows
                        self._fold_operator_stats(
                            cells,
                            cnt,
                            wall_ms=(t_fetched - t_disp) * 1000.0,
                            device_ms=(t_fetched - t_disped) * 1000.0,
                            prog=prog_root,
                        )
                pruned = sum(dyn)
                if pruned:
                    REGISTRY.counter("dynamic_filter.rows_pruned").update(
                        pruned
                    )
                    self._fold_dyn_stat("dynamic_filter_rows_pruned", pruned)
                if DEVICE.enabled:
                    # output bucket padding: the rows this run computed
                    # over vs the rows anyone will read
                    DEVICE.count_padding(n, out.capacity)
                    self._fold_device_stat(
                        device_pad_rows=out.capacity - n,
                        device_live_rows=n,
                    )
                if not fetch_result:
                    return pad_capacity(out, bucket_capacity(n))
                if topn is not None and n > topn.limit:
                    out, n = self._root_topn(out, n, topn)
                if DEVICE.enabled:
                    d2h = sum(int(t.nbytes) for t in out.prefix_leaves(n))
                    DEVICE.count_d2h(d2h)
                    self._fold_device_stat(device_d2h_bytes=d2h)
                with self._span("result_copy"):
                    page = materialize_page(out, n)
                return page
            tries += 1
            self.overflow_retries += 1
            if self._active_qs is not None:
                with self._qs_mu:
                    self._active_qs.retries += 1
            if tries >= self.MAX_RETRIES:
                raise ExecutionError(
                    "capacity overflow persisted after retries "
                    "(join fan-out or group count beyond buckets)"
                )
            # leaves carry no capacity, so they keep their identity and
            # scan_ids stays valid
            root = _scale_capacities(root, 4)

    def _root_topn(
        self, out: Page, n: int, topn: N.SortNode
    ) -> Tuple[Page, int]:
        """The root TopN on the device, before the result copy: the
        prefix-form result re-bucketed to its ``n`` live rows (a slice)
        and ``order_by``'s stable sort with the host stage's keys, null
        placement and tie order. No host read: the copy's own
        synchronize waits for it. Returns the TopN page and its rows."""
        with self._span("root_topn"):
            out = order_by(
                pad_capacity(out, bucket_capacity(n)),
                topn.keys,
                limit=topn.limit,
            )
        REGISTRY.counter("root_topn.device").update()
        REGISTRY.counter("root_topn.rows_cut").update(n - topn.limit)
        return out, topn.limit

    def _counter_cells(self, root, counters, analyzed: bool) -> List[tuple]:
        """One (walk_id, label, capacity, page bytes, depth, fingerprint,
        counted child walk ids) cell per counted node of one run, in
        counter order. The static part (walk ids, labels, depths,
        fingerprints, the counted nodes' children) is computed once per
        run root in a query (streamed batches re-enter with one root),
        and the fingerprints reuse the signatures of the cached plan's
        subtrees (``execute_plan``'s signature memo)."""
        memo, by_root = getattr(self._run_meta, "value", None) or (None, {})
        got = by_root.get((id(root), analyzed))
        if got is not None and got[0] is root:
            meta = got[1]
        else:
            meta = self._counter_meta(root, counters, memo)
            by_root[(id(root), analyzed)] = (root, meta)
        cells = []
        for node, _, cap, nbytes in counters:
            walk_id, label, depth, fp, child_ids = meta[id(node)]
            cells.append((walk_id, label, cap, nbytes, depth, fp, child_ids))
        return cells

    @staticmethod
    def _counter_meta(root, counters, memo) -> Dict[int, tuple]:
        """id(node) -> (walk id, label, depth, fingerprint, counted child
        walk ids) for each counted node of one run's tree."""
        walk_ids = {id(n): i for i, n in enumerate(N.walk(root))}
        depths = _node_depths(root)
        counted_ids = {id(node) for node, _, _, _ in counters}
        try:
            # canonical sub-fingerprints: the history keys of these
            # operators
            fps = (memo or plan_history.SignatureMemo()).fingerprints(
                root, [n for n, _, _, _ in counters]
            )
        except Exception:
            fps = {}

        def child_walks(n):
            # nearest COUNTED descendants: with cardinality-preserving
            # nodes skipped on the always-on path, a join's input_rows
            # still sums its sides' row sources
            out_ids = []
            for c in n.children():
                if id(c) in counted_ids:
                    out_ids.append(walk_ids.get(id(c), -1))
                else:
                    out_ids.extend(child_walks(c))
            return out_ids

        return {
            id(node): (
                walk_ids.get(id(node), -1),
                node_label(node),
                depths.get(id(node), 0),
                fps.get(id(node), ""),
                tuple(child_walks(node)),
            )
            for node, _, _, _ in counters
        }

    def _fold_dyn_stat(self, attr: str, n: int) -> None:
        """Add ``n`` to the active sink's dynamic-filter counter under
        ``_qs_mu`` (the prefetch thread shares the sink) and the sink's
        own ``_roll_lock``."""
        qs = self._active_qs
        if qs is None:
            return
        with self._qs_mu:
            sink_lock = getattr(qs, "_roll_lock", None)
            if sink_lock is not None:
                with sink_lock:
                    setattr(qs, attr, getattr(qs, attr) + n)
            else:
                setattr(qs, attr, getattr(qs, attr) + n)

    def _count_control_read(self, control_t: torch.Tensor) -> None:
        """Count one dispatch and the bytes of its control read on the
        device plane and the active query's sink: the seam through which
        every runner tier (the distributed runner's fragments too)
        counts its host reads. A kernel that ``kernels.load`` built
        during the dispatch is counted as a compile and folded into the
        sink here too."""
        builds = kernels.take_builds()
        if DEVICE.enabled:
            d2h = int(control_t.nbytes)
            DEVICE.count_dispatch()
            DEVICE.count_d2h(d2h)
            for ms in builds:
                DEVICE.count_compile(ms)
            self._fold_device_stat(
                device_dispatches=1,
                device_d2h_bytes=d2h,
                device_compiles=len(builds),
                device_compile_ms=sum(builds),
            )

    def _fold_device_stat(self, **fields) -> None:
        """Add device-plane quantities (utils/telemetry.py families) to
        the active sink under the ``_fold_dyn_stat`` locking. No-op when
        the telemetry plane is disabled, so per-query attribution tracks
        the process counters exactly."""
        qs = self._active_qs
        if qs is None or not DEVICE.enabled:
            return
        with self._qs_mu:
            sink_lock = getattr(qs, "_roll_lock", None)
            with sink_lock if sink_lock is not None else (
                contextlib.nullcontext()
            ):
                for attr, n in fields.items():
                    if n:
                        setattr(qs, attr, getattr(qs, attr) + n)

    def _fold_operator_stats(
        self,
        cells,
        counts,
        wall_ms: float,
        device_ms: float,
        prog=None,
    ) -> None:
        """Merge one run's per-node actuals into the active stats sink's
        ``operators`` list, keyed by node instance (run root identity +
        walk position + canonical sub-fingerprint): streamed batches of
        one fragment SUM into the same OperatorStats, while same-shape
        nodes of DIFFERENT runs of one query (scalar-subquery pre-passes
        reuse walk positions) stay separate instead of teaching the
        history store multiplied rows. ``prog`` is pinned on the sink so
        its id cannot be reused by a later run's tree within the query.
        The run's dispatch -> control-read window is attributed to its
        ROOT operator."""
        qs = self._active_qs
        if qs is None or not hasattr(qs, "operators"):
            return
        rows_by_walk = {cell[0]: int(c) for cell, c in zip(cells, counts)}
        root_walk = min(rows_by_walk)
        with self._qs_mu:
            index = qs.__dict__.get("_op_index")
            if index is None:
                index = {}
                qs.__dict__["_op_index"] = index
            if prog is not None:
                qs.__dict__.setdefault("_op_pins", {})[id(prog)] = prog
            for (
                walk_id, label, cap, nbytes, depth, fp, child_ids
            ), c in zip(cells, counts):
                key = (id(prog), walk_id, fp or label)
                op = index.get(key)
                if op is None:
                    op = OperatorStats(
                        node_id=walk_id,
                        label=label,
                        fingerprint=fp,
                        depth=depth,
                    )
                    index[key] = op
                    qs.operators.append(op)
                rows = int(c)
                op.output_rows += rows
                op.batches += 1
                op.output_capacity = max(op.output_capacity, cap)
                op.peak_page_bytes = max(op.peak_page_bytes, nbytes)
                op.input_rows += (
                    sum(rows_by_walk.get(ci, 0) for ci in child_ids)
                    if child_ids
                    else rows  # leaves read what they emit
                )
                if walk_id == root_walk:
                    op.wall_ms += wall_ms
                    op.device_ms += device_ms

    # ------------------------------------------------------------- caches

    def _note_spilled(self, nbytes: int) -> None:
        """Attribute host-spill restage bytes to the active stats sink
        (the split cache's ``on_restage`` hook)."""
        qs = self._active_qs
        if qs is None:
            return
        with self._qs_mu:
            qs.spilled_bytes += int(nbytes)

    def _note_cache_hit(self) -> None:
        """Attribute one split-cache hit to the active stats sink."""
        qs = self._active_qs
        if qs is not None:
            with self._qs_mu:
                qs.staging_cache_hits += 1

    def _note_pinned_key(self, key) -> None:
        """Record a cache key pinned on behalf of the active query, for
        :meth:`release_pins` when the query ends."""
        qs = self._active_qs
        if qs is None:
            return
        with self._qs_mu:
            pins = getattr(qs, "_pinned_keys", None)
            if pins is None:
                # a worker task's TaskStats sink starts without the list
                pins = qs._pinned_keys = []
            pins.append(key)

    def release_pins(self, qs) -> None:
        """Unpin every cache entry ``qs`` pinned (a query's or a worker
        task's stats sink). Idempotent."""
        if qs is None:
            return
        with self._qs_mu:
            keys = getattr(qs, "_pinned_keys", None) or []
            qs._pinned_keys = []
        for k in keys:
            self.split_cache.unpin(k)

    def _note_input(self, key, page: Page) -> None:
        qs = self._active_qs
        if qs is None:
            return
        with self._qs_mu:
            qs.input_rows += self._staged_rows.get(key, 0)
            qs.input_bytes += sum(int(b.data.nbytes) for b in page.blocks)

    def _load_table(self, scan: N.TableScanNode) -> Page:
        """A whole table's page, through the split cache. The constraint
        is part of the identity (a pruned page must never serve a
        differently constrained scan); the "table" tag keeps whole-table
        entries apart from split batches."""
        key = (
            scan.handle,
            scan.columns,
            scan.constraint,
            self.session.get("tpu_offload"),
            "table",
        )
        cacheable = self.catalogs.get(scan.handle.catalog).cacheable()
        # pinned for the active query's lifetime: eviction must not drop
        # the page's pool accounting while a plan runs over it
        pin = cacheable and self._active_qs is not None
        page = self.split_cache.get(key, pin=pin) if cacheable else None
        if page is not None:
            self._note_cache_hit()
            if pin:
                self._note_pinned_key(key)
        else:
            with self._span("staging", table=_table_name(scan)) as span:
                t0 = time.perf_counter()
                merged = self._load_merged_payload(scan)
                rows = _payload_rows(merged, scan.columns)
                self._staged_rows[key] = rows
                page = stage_page(merged, dict(scan.schema), device=self.device)
                nbytes = page_nbytes(page)
                if span is not None:
                    span.attrs.update(rows=rows, bytes=nbytes)
                REGISTRY.distribution("staging.bytes").add(nbytes)
                # per-query h2d attribution (the process counter lives in
                # staging.stage_page); cache hits copied nothing
                self._fold_device_stat(device_h2d_bytes=nbytes)
                cached = cacheable and self.split_cache.put(
                    key, page, nbytes, reserve_required=True, pin=pin
                )
                if cached and pin:
                    self._note_pinned_key(key)
                if not cached and self.memory_pool is not None:
                    # not cache-owned (non-cacheable connector, or bigger
                    # than the budget): accounted under the query
                    owner = (
                        self._active_qs.query_id
                        if self._active_qs is not None
                        else "adhoc"
                    )
                    self.memory_pool.reserve(owner, nbytes)
                if self._active_qs is not None:
                    self._active_qs.staging_ms += (
                        time.perf_counter() - t0
                    ) * 1000.0
        self._note_input(key, page)
        return page

    def _load_split(
        self, scan: N.TableScanNode, lo: int, hi: int, capacity: int
    ) -> Page:
        """Stage ONE split batch (see :meth:`stage_split`), without the
        per-batch release handle."""
        return self.stage_split(scan, lo, hi, capacity)[0]

    def stage_split(
        self,
        scan: N.TableScanNode,
        lo: int,
        hi: int,
        capacity: int,
        owner: Optional[str] = None,
        page_source=None,
    ) -> Tuple[Page, object]:
        """Stage ONE split batch [lo, hi) of a scan at a fixed capacity
        on the runner's device, through the split cache when
        ``stream_split_cache`` is on: a repeated pass over the same
        splits skips the connector read AND the host-to-device copy.

        Returns ``(page, release)``; the caller calls ``release()`` once
        the batch's device work is done. With an ``owner``, a cached
        page is pinned for that window and release unpins it; an
        uncached page reserves its bytes under ``owner`` and release
        returns them. Without an owner an active query still pins
        (released at query end by :meth:`release_pins`) and release is a
        no-op.

        The pushed constraint is not part of the identity: a split reads
        its raw row range, and the plan's filter runs over it.
        ``page_source()`` overrides the connector read on a miss."""
        stats = self.stream_stats
        cache_on = bool(self.session.get("stream_split_cache"))
        conn = self.catalogs.get(scan.handle.catalog)
        key = (
            scan.handle,
            scan.columns,
            lo,
            hi,
            capacity,
            self.session.get("tpu_offload"),
        )
        per_batch = owner is not None
        pin = per_batch or self._active_qs is not None
        unpin = (
            (lambda: self.split_cache.unpin(key)) if per_batch else _noop
        )
        if cache_on and conn.cacheable():
            page = self.split_cache.get(key, pin=pin)
            if page is not None:
                self._note_cache_hit()
                if pin and not per_batch:
                    self._note_pinned_key(key)
                return page, unpin
        with self._span("staging", table=_table_name(scan)) as span:
            t0 = time.perf_counter()
            payload = (
                page_source()
                if page_source is not None
                else conn.create_page_source(
                    ConnectorSplit(scan.handle, lo, hi), list(scan.columns)
                )
            )
            t1 = time.perf_counter()
            page = stage_page(
                payload, dict(scan.schema), capacity=capacity,
                device=self.device,
            )
            nbytes = page_nbytes(page)
            if span is not None:
                span.attrs.update(
                    rows=_payload_rows(payload, scan.columns), bytes=nbytes
                )
            REGISTRY.distribution("staging.bytes").add(nbytes)
            self._fold_device_stat(device_h2d_bytes=nbytes)
            # the prefetch thread adds here too; a lost update of a float
            # total only blurs a timing
            stats.generate_s += t1 - t0
            stats.stage_s += time.perf_counter() - t1
            stats.staged_bytes += nbytes
            if self._active_qs is not None:
                with self._qs_mu:
                    self._active_qs.staging_ms += (
                        time.perf_counter() - t0
                    ) * 1000.0
        if cache_on and conn.cacheable() and self.split_cache.put(
            key, page, nbytes, pin=pin
        ):
            # cache-owned: put() reserved the bytes under the shared
            # owner through try_reserve (a full pool just means the
            # split is not cached)
            if pin and not per_batch:
                self._note_pinned_key(key)
            return page, unpin
        if owner is not None and self.memory_pool is not None:
            # a live uncached batch is accounted to the query
            self.memory_pool.reserve(owner, nbytes)
            return page, (lambda: self.memory_pool.release(owner, nbytes))
        return page, _noop

    def _load_merged_payload(self, scan: N.TableScanNode) -> Dict:
        """Fetch all splits of a scan and merge their column payloads."""
        conn = self.catalogs.get(scan.handle.catalog)
        src = conn.get_splits(
            scan.handle,
            target_split_rows=1 << 22,
            constraint=scan.constraint,
        )
        datas = []
        while not src.exhausted:
            for split in src.next_batch(64):
                datas.append(
                    conn.create_page_source(split, list(scan.columns))
                )
        return _merge_split_payloads(datas, list(scan.columns))


#: plan weight per node in the reference (its compile-size proxy and the
#: cut decision for stage-at-a-time execution); kept so the port
#: fragments exactly the plans the reference fragments
_HEAVY_NODES = (
    N.JoinNode,
    N.AggregationNode,
    N.DistinctNode,
    N.SortNode,
    N.WindowNode,
    N.UnnestNode,
)


def _plan_weight(root: N.PlanNode) -> int:
    """Does not descend into executed fragments (RemoteSourceNode has no
    children)."""
    return sum(
        6 if isinstance(n, _HEAVY_NODES) else 1 for n in N.walk(root)
    )


class _ExecContext:
    """One run of a plan over its leaf pages, and what it collects: 0-d
    overflow flags (capacity retries), (message, 0-d bool) hard errors,
    the 0-d pruned-row count of every dynamic filter, and, with
    ``counters``, one (node, 0-d live count, capacity, page bytes)
    record per counted node (every node with ``count_all``, else the
    ``_COUNTED_NODES``). Capacities and bytes are host values; the
    counts stay on the device until the run's one control read."""

    def __init__(
        self, pages, scan_ids, device: torch.device,
        counters: Optional[List] = None, count_all: bool = True,
        lanes: int = 1,
    ):
        self.pages = pages
        self.scan_ids = scan_ids
        self.device = device
        self.flags: List[torch.Tensor] = []
        self.errors: List[Tuple[str, torch.Tensor]] = []
        self.dyn: List[torch.Tensor] = []
        self.counters = counters
        self.count_all = count_all
        #: > 1: a micro-batch over lane-blocked pages (page.tile_lanes);
        #: each counter is then a (lanes,) count, and capacities and
        #: bytes are one lane's
        self.lanes = lanes


#: nodes whose output rows carry cardinality signal (scan sizes, filter
#: selectivity, join fan-out, group counts), as the reference counts
#: them on its always-on path; cardinality-preserving or structurally
#: bounded nodes (Project, Output, Window, Sort, Limit) are skipped
#: there. EXPLAIN ANALYZE counts every node.
_COUNTED_NODES = (
    N.TableScanNode,
    N.RemoteSourceNode,
    N.FilterNode,
    N.JoinNode,
    N.CrossJoinNode,
    N.AggregationNode,
    N.DistinctNode,
    N.UnnestNode,
    N.UnionAllNode,
)


def _execute_node(node: N.PlanNode, ctx: _ExecContext) -> Page:
    """Execute one plan node eagerly, recording its live count when the
    run counts it. While a profiler records, the node's operators (its
    sources' nested inside) sit in a ``presto.op.<NodeClass>`` span."""
    if tracing.recording():
        with tracing.profiled("op." + type(node).__name__):
            out = _execute_node_inner(node, ctx)
    else:
        out = _execute_node_inner(node, ctx)
    if ctx.counters is not None and (
        ctx.count_all or isinstance(node, _COUNTED_NODES)
    ):
        if ctx.lanes > 1:
            ctx.counters.append((
                node,
                torch.sum(out.row_mask().reshape(ctx.lanes, -1), dim=1),
                out.capacity // ctx.lanes,
                page_nbytes(out) // ctx.lanes,
            ))
            return out
        nv = out.num_valid
        if nv._base is not None:
            # a view (a cumulative sum's last element) would keep its
            # whole buffer alive until the control read
            nv = nv.clone()
        ctx.counters.append((node, nv, out.capacity, page_nbytes(out)))
    return out


#: the nodes a micro-batch can run over lane-blocked pages: they keep
#: rows in place (scan, filter, project, output) or aggregate each lane
#: on its own; any other node makes its shape fall out of batching
_LANE_NODES = (
    N.TableScanNode,
    N.FilterNode,
    N.ProjectNode,
    N.AggregationNode,
    N.OutputNode,
)


def _execute_node_inner(node: N.PlanNode, ctx: _ExecContext) -> Page:
    def run(n):
        return _execute_node(n, ctx)

    if ctx.lanes > 1 and not isinstance(node, _LANE_NODES):
        raise NoLaneForm(f"{type(node).__name__} in a micro-batch")
    if isinstance(node, (N.TableScanNode, N.RemoteSourceNode)):
        return ctx.pages[ctx.scan_ids[id(node)]]
    if isinstance(node, N.ValuesNode):
        return Page(
            blocks=(
                Block(
                    data=torch.zeros((8,), dtype=torch.int64, device=ctx.device),
                    valid=None,
                    dtype=T.BIGINT,
                ),
            ),
            num_valid=torch.ones((), dtype=torch.int32, device=ctx.device),
            names=("$dummy",),
        )
    if isinstance(node, N.FilterNode):
        src = run(node.source)
        schema = node.source.output_schema()
        projs = [(n, E.ColumnRef(n, t)) for n, t in schema.items()]
        out = filter_project(src, node.predicate, projs)
        if node.dynamic:
            ctx.dyn.append(src.num_valid - out.num_valid)
        return out
    if isinstance(node, N.ProjectNode):
        return project(run(node.source), node.projections)
    if isinstance(node, N.AggregationNode):
        out, overflow = hash_aggregate(
            run(node.source),
            node.group_keys,
            node.aggs,
            node.max_groups,
            errors_out=ctx.errors,
            lanes=ctx.lanes,
        )
        ctx.flags.append(overflow)
        return out
    if isinstance(node, N.DistinctNode):
        out, overflow = distinct(run(node.source), node.max_groups)
        ctx.flags.append(overflow)
        return out
    if isinstance(node, N.JoinNode):
        probe = run(node.left)
        build = run(node.right)
        out, overflow = hash_join(
            probe,
            build,
            node.left_keys,
            node.right_keys,
            join_type=node.join_type,
            build_payload=node.payload,
            build_unique=node.build_unique,
            out_capacity=node.out_capacity,
            payload_rename=dict(node.payload_rename),
        )
        ctx.flags.append(overflow)
        if node.residual is not None:
            projs = [(n, E.ColumnRef(n, t)) for n, t in out.schema().items()]
            out = filter_project(out, node.residual, projs)
        return out
    if isinstance(node, N.CrossJoinNode):
        left = run(node.left)
        right = run(node.right)
        if node.out_capacity is not None:
            out, overflow = cross_join(left, right, node.out_capacity)
            ctx.flags.append(overflow)
            return out
        # single-row broadcast (the scalar-aggregate shape); more than
        # one row is a hard error, not an overflow a retry could fix
        ctx.errors.append(
            ("cross join build produced more than one row",
             right.num_valid > 1)
        )
        return cross_join_single_row(left, right)
    if isinstance(node, N.SortNode):
        return order_by(run(node.source), node.keys, limit=node.limit)
    if isinstance(node, N.LimitNode):
        return limit(run(node.source), node.count)
    if isinstance(node, N.WindowNode):
        return window(
            run(node.source), node.partition_by, node.order_by, node.calls
        )
    if isinstance(node, N.UnnestNode):
        if node.array_column is not None:
            # exact-capacity expansion of a physical array column: an
            # overflow re-runs at a bigger bucket like any capacity
            out, overflow = unnest_column(
                run(node.source),
                node.array_column,
                node.out_name,
                node.out_type,
                node.ordinality_name,
                node.out_capacity,
            )
            ctx.flags.append(overflow)
            return out
        return unnest(
            run(node.source),
            node.elements,
            node.out_name,
            node.out_type,
            node.ordinality_name,
        )
    if isinstance(node, N.UnionAllNode):
        return union_all([run(s) for s in node.sources])
    if isinstance(node, N.OutputNode):
        src = run(node.source)
        return Page(
            blocks=tuple(src.block(col) for _, col in node.columns),
            num_valid=src.num_valid,
            names=tuple(o for o, _ in node.columns),
            live=src.live,
        )
    raise ExecutionError(
        f"cannot execute {type(node).__name__}: later slice of the port"
    )


def _node_depths(root: N.PlanNode) -> Dict[int, int]:
    """id(node) -> tree depth under ``root`` (operator-stats rendering)."""
    out: Dict[int, int] = {}

    def rec(n: N.PlanNode, d: int) -> None:
        out[id(n)] = d
        for c in n.children():
            rec(c, d + 1)

    rec(root, 0)
    return out


def _control_vector(scalars: List[torch.Tensor]):
    """0-d tensors of one device -> (one int64 vector, ``order``) for
    the run's one host read: one stack and one cast per dtype, then one
    concatenation, however many scalars there are. Element k of the
    vector is ``scalars[order[k]]`` (``_in_order`` undoes it on the
    host)."""
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(scalars):
        by_dtype.setdefault(t.dtype, []).append(i)
    order: List[int] = []
    parts = []
    for idx in by_dtype.values():
        order.extend(idx)
        parts.append(torch.stack([scalars[i] for i in idx]).to(torch.int64))
    return (parts[0] if len(parts) == 1 else torch.cat(parts)), order


def _in_order(values: List[int], order: List[int]) -> List[int]:
    out = [0] * len(values)
    for v, i in zip(values, order):
        out[i] = v
    return out


def cross_join_single_row(left: Page, right: Page) -> Page:
    """Cross product against a single-row right side (the scalar-aggregate
    broadcast). The caller flags ``right.num_valid > 1``."""
    right = compact_page(right)  # row 0 must really be the single row
    blocks = list(left.blocks)
    names = list(left.names)
    for bname, blk in zip(right.names, right.blocks):
        if blk.dtype.is_nested:
            raise NotImplementedError(
                f"nested column {bname} ({blk.dtype}) cannot ride "
                "through a single-row cross join"
            )
        data = torch.broadcast_to(
            blk.data[0], (left.capacity,) + tuple(blk.data.shape[1:])
        )
        valid = None
        if blk.valid is not None:
            valid = torch.broadcast_to(blk.valid[0], (left.capacity,))
        blocks.append(dataclasses.replace(blk, data=data, valid=valid))
        names.append(bname)
    has_row = right.num_valid > 0
    return Page(
        blocks=tuple(blocks),
        num_valid=torch.where(has_row, left.num_valid, 0).to(torch.int32),
        names=tuple(names),
        live=None if left.live is None else left.live & has_row,
    )


# ----------------------------------------------------------- param binding


def _substitute_params(v, bindings):
    """Replace every Param in a plan (its nodes, expressions, and the
    tuples and dataclasses such as AggCall and SortKey that hold them)
    with its bound Literal. Parts without a Param keep their identity:
    executed fragments are looked up by ``id``."""
    if isinstance(v, E.Param):
        lit = bindings.get(v.param_id)
        if lit is None:
            raise ExecutionError(f"unbound param {v.param_id}")
        return lit
    if isinstance(v, tuple):
        new = tuple(_substitute_params(x, bindings) for x in v)
        return v if all(a is b for a, b in zip(new, v)) else new
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        changes = {}
        for f in dataclasses.fields(v):
            old = getattr(v, f.name)
            new = _substitute_params(old, bindings)
            if new is not old:
                changes[f.name] = new
        return dataclasses.replace(v, **changes) if changes else v
    return v


def _scalar_literal(page: Page, col: str) -> E.Literal:
    """A scalar subquery's result (a host page of 0 or 1 rows) as a
    Literal: no row is NULL, two rows are an error."""
    blk = page.block(col)
    n = int(page.num_valid)
    if n == 0:
        return E.Literal(None, blk.dtype)
    if n > 1:
        raise ExecutionError("scalar subquery returned more than one row")
    data, valid = blk.to_numpy(1)
    if not valid[0]:
        return E.Literal(None, blk.dtype)
    v = data[0]
    if blk.dtype.is_string:
        return E.Literal(str(blk.dictionary.values[int(v)]), blk.dtype)
    if blk.dtype.is_decimal or blk.dtype.is_integer or blk.dtype.name in (
        "date",
        "timestamp",
    ):
        return E.Literal(int(v), blk.dtype)
    if blk.dtype.name == "boolean":
        return E.Literal(bool(v), blk.dtype)
    return E.Literal(float(v), blk.dtype)


def _scale_capacities(node: N.PlanNode, factor: int) -> N.PlanNode:
    if isinstance(node, N.RemoteSourceNode):
        return node  # an executed fragment: its page is fixed
    node = N.map_children(node, lambda c: _scale_capacities(c, factor))
    changes = {}
    if isinstance(node, (N.AggregationNode, N.DistinctNode)):
        changes["max_groups"] = node.max_groups * factor
    if (
        isinstance(node, (N.JoinNode, N.CrossJoinNode, N.UnnestNode))
        and node.out_capacity is not None
    ):
        changes["out_capacity"] = node.out_capacity * factor
    return dataclasses.replace(node, **changes) if changes else node


def _merge_split_payloads(datas: List[Dict], columns: List[str]) -> Dict:
    """Merge per-split payloads column by column
    (``staging.merge_column_chunks``): dictionaries that differ across
    splits (file connectors) merge into their sorted union with the ids
    remapped; splits sharing one dictionary object (the tpch generator)
    keep it; masked chunks merge with their validity."""
    if len(datas) == 1:
        return datas[0]
    return {c: merge_column_chunks([d[c] for d in datas]) for c in columns}


def _literal_form(root: N.PlanNode, scan_ids: Dict[int, int], bound):
    """``root`` with its RuntimeParams bound back as Literals, and the
    leaf-identity index remapped onto the rebuilt tree: the rewrite keeps
    the tree's shape, so leaves correspond by walk position."""
    lroot = canonical.bind_literal_root(root, bound)
    leaf_types = (N.TableScanNode, N.RemoteSourceNode)
    remapped = dict(scan_ids)
    for old, new in zip(
        (n for n in N.walk(root) if isinstance(n, leaf_types)),
        (n for n in N.walk(lroot) if isinstance(n, leaf_types)),
    ):
        if id(old) in scan_ids:
            remapped[id(new)] = scan_ids[id(old)]
    return lroot, remapped


def _table_name(scan: N.TableScanNode) -> str:
    h = scan.handle
    return f"{h.catalog}.{h.schema}.{h.table}"


def _payload_rows(payload: Dict, columns) -> int:
    for c in columns:
        return payload_len(payload[c])
    return 0


def _count_param_markers(node) -> int:
    n = 0
    if isinstance(node, ast.ParamMarker):
        return 1
    if not isinstance(node, ast.Node):
        return 0
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, ast.Node):
            n += _count_param_markers(v)
        elif isinstance(v, tuple):
            for x in v:
                if isinstance(x, ast.Node):
                    n += _count_param_markers(x)
                elif isinstance(x, tuple):
                    for y in x:
                        if isinstance(y, ast.Node):
                            n += _count_param_markers(y)
    return n


def _bind_param_markers(node, params):
    """Replace ? markers (by index) with the EXECUTE arguments."""
    if isinstance(node, ast.ParamMarker):
        return params[node.index]
    if not isinstance(node, ast.Node):
        return node
    kwargs = {}
    changed = False
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, ast.Node):
            nv = _bind_param_markers(v, params)
        elif isinstance(v, tuple):
            nv = tuple(
                _bind_param_markers(x, params)
                if isinstance(x, ast.Node)
                else (
                    tuple(
                        _bind_param_markers(y, params)
                        if isinstance(y, ast.Node)
                        else y
                        for y in x
                    )
                    if isinstance(x, tuple)
                    else x
                )
                for x in v
            )
        else:
            nv = v
        kwargs[f.name] = nv
        changed |= nv is not v
    return dataclasses.replace(node, **kwargs) if changed else node


def _result_columns(res: QueryResult) -> Dict[str, np.ndarray]:
    """QueryResult -> {column: object ndarray of Python values}, the
    write SPI's row format (None = NULL). Built column by column from
    the host page through the decoder ``Page.to_pylist`` uses, with the
    values and types of the reference's row-wise build, except that a
    short decimal is the exact ``decimal.Decimal`` of its scaled integer
    where the reference writes a float (which loses digits above
    2^53). As there, a name the page holds twice reads its last
    block."""
    page = res.page
    if page.live is not None:
        idx = np.nonzero(page.live.cpu().numpy())[0]
    else:
        idx = np.arange(int(page.num_valid))
    blocks = dict(zip(page.names, page.blocks))
    return {
        c: obj_array(decode_column(blocks[c], idx, exact=True))
        for c in res.columns
    }


def _literal_value(e):
    """INSERT VALUES literal -> Python value (numbers, strings, bools,
    NULL, arrays; unary minus)."""
    if isinstance(e, ast.NumberLit):
        t = e.text.lower()
        if "." in t or "e" in t:  # 1.5, 1e3: float
            return float(t)
        return int(t)
    if isinstance(e, ast.StringLit):
        return e.value
    if isinstance(e, ast.NullLit):
        return None
    if isinstance(e, ast.ArrayLit):
        return [_literal_value(x) for x in e.items]
    if isinstance(e, ast.BoolLit):
        return e.value
    if isinstance(e, ast.UnaryOp) and e.op == "-":
        return -_literal_value(e.arg)
    raise ExecutionError(
        "INSERT VALUES supports literal values only "
        f"(got {type(e).__name__})"
    )


def _rows_page(n: int) -> Page:
    """A write's result: one BIGINT ``rows`` row."""
    return Page.from_pydict({"rows": [n]}, {"rows": T.BIGINT}, device="cpu")


def _message_page(msg: str) -> Page:
    return Page.from_pydict(
        {"result": [msg]}, {"result": T.VARCHAR}, capacity=1, device="cpu"
    )


def _lines_page(text: str, column: str = "Query Plan") -> Page:
    lines = text.split("\n")
    return Page.from_pydict(
        {column: lines}, {column: T.VARCHAR}, capacity=len(lines),
        device="cpu",
    )

"""Query/operator statistics tree.

The PyTorch counterpart of ``presto_tpu/exec/stats.py`` (a copy, with
the port's pinned-key bookkeeping on :class:`QueryStats`): the
OperatorStats -> TaskStats -> StageStats -> QueryStats rollup behind
``system.runtime.queries``, EXPLAIN ANALYZE and the query-completed
events.

The port runs a plan's operators eagerly, one torch call after
another, so there is no per-operator device clock either:
``OperatorStats`` carries exact per-node row counts (each counted
node's 0-d ``num_valid`` tensor rides the run's one control read, with
no extra host wait), and the whole run's dispatch -> control-read
window is attributed to the program root. Host-side phase timings (plan
/ stage / execute / gather) plus those per-node row counts form the
stats tree.

Distributed rollup (``TaskStats``, ``StageStats``) is kept for the
server, which the port does not have yet: a local runner fills
``QueryStats`` directly.

Query events: :class:`QueryHistory` fires a :class:`QueryCompletedEvent`
per finished/failed query to registered listeners;
:class:`JsonlQueryEventListener` appends one JSON line per event to a
sink file, :class:`SlowQueryLog` the queries over a wall-time
threshold, and ``plan/history.QueryHistoryStore`` records the per-node
actuals.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class PlanNodeStats:
    """Per-plan-node runtime stats (reference: OperatorStats)."""

    node_id: int
    label: str
    output_rows: int = -1  # -1: not yet measured
    output_capacity: int = -1  # static bucket the rows sat in


@dataclasses.dataclass
class OperatorStats:
    """One plan operator's runtime actuals (reference: OperatorStats),
    keyed by the node's canonical sub-fingerprint (plan/history.py —
    literal- and pruning-invariant), populated on every executor tier
    from the per-node row counts of each run (session
    ``enable_operator_stats``, default on).

    The operators run one after another without a per-operator device
    clock, so ``wall_ms``/``device_ms`` carry the whole run's
    dispatch -> control-read window, attributed to the run's ROOT
    operator (interior operators report 0). Rows/bytes are exact per
    node."""

    node_id: int  # walk index within the compiled program's root
    label: str
    fingerprint: str = ""  # canonical sub-fingerprint (history key)
    depth: int = 0  # tree depth within the program root (rendering)
    input_rows: int = 0  # sum of child operators' output rows
    output_rows: int = 0
    output_capacity: int = 0  # largest static bucket the rows sat in
    wall_ms: float = 0.0  # program dispatch -> control fetch (root only)
    device_ms: float = 0.0  # post-dispatch device wait (root only)
    peak_page_bytes: int = 0  # largest static output-page footprint
    batches: int = 0  # program executions folded in (streamed splits)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "OperatorStats":
        known = {f.name for f in dataclasses.fields(OperatorStats)}
        return OperatorStats(
            **{k: v for k, v in d.items() if k in known}
        )

    def merge(self, other: "OperatorStats") -> None:
        """Fold another observation of the SAME operator (a later
        batch, or the same canonical subtree in a sibling task)."""
        self.input_rows += other.input_rows
        self.output_rows += other.output_rows
        self.wall_ms += other.wall_ms
        self.device_ms += other.device_ms
        self.batches += other.batches
        self.output_capacity = max(
            self.output_capacity, other.output_capacity
        )
        self.peak_page_bytes = max(
            self.peak_page_bytes, other.peak_page_bytes
        )


@dataclasses.dataclass
class TaskStats:
    """One task's stats (reference: TaskStats), populated worker-side
    and shipped back in the task-status response.

    Also usable as the runner's per-query stats sink (the attribute
    subset LocalQueryRunner._active_qs touches: staging_ms, input_rows,
    input_bytes, retries, compile_cache_hit, dynamic_filters,
    device_fragments, query_id), so a worker task accumulates engine
    stats with zero extra plumbing."""

    task_id: str
    query_id: str
    node_id: str = ""
    stage_id: int = -1
    state: str = "QUEUED"
    create_time: float = 0.0
    end_time: float = 0.0
    wall_ms: float = 0.0
    staging_ms: float = 0.0
    #: host time spent staging AHEAD of device execution (the
    #: pipelined-prefetch overlap window; also in staging_ms)
    prefetch_ms: float = 0.0
    execute_ms: float = 0.0
    input_rows: int = 0
    input_bytes: int = 0
    output_rows: int = 0
    output_bytes: int = 0
    retries: int = 0
    compile_cache_hit: bool = True
    #: splits this task served straight from the device-resident
    #: split cache (no connector read, no host->device transfer)
    staging_cache_hits: int = 0
    dynamic_filters: int = 0
    #: probe rows dropped by fused dynamic filters in THIS task's
    #: programs (traced out of the compiled fragment)
    dynamic_filter_rows_pruned: int = 0
    #: upstream exchange pages this task re-served from the durable
    #: spool instead of a (dead) producer worker (server.spool)
    spool_pages_served: int = 0
    #: host-spill restage bytes this task paid (its scans hit pages
    #: that had been offloaded to the host-RAM spill pool under device
    #: memory pressure — cluster memory governance)
    spilled_bytes: int = 0
    device_fragments: int = 0
    #: device-plane accounting (utils/telemetry.py choke points; the
    #: runner folds these via _fold_device_stat). A micro-batched lane
    #: counts the shared dispatch once per SERVED member — its answer
    #: required that dispatch — with transfer bytes split evenly.
    device_dispatches: int = 0
    device_compiles: int = 0
    device_compile_ms: float = 0.0
    device_h2d_bytes: int = 0
    device_d2h_bytes: int = 0
    #: capacity-bucket padding waste: pad vs live row slots of the
    #: pages this task's programs produced/staged
    device_pad_rows: int = 0
    device_live_rows: int = 0
    #: per-EDGE exchange transport outcomes of this (merge/join) task:
    #: upstream partitions consumed over the in-slice ICI segment, the
    #: serialized HTTP wire, or re-served from the durable spool
    #: (server/exchange_spi.py — EXPLAIN ANALYZE's "exchange:" line)
    exchange_ici_edges: int = 0
    exchange_http_edges: int = 0
    exchange_spool_edges: int = 0
    #: this attempt was a speculative (backup) launch of a straggling
    #: range — winners and losers both carry the flag in the rollup
    speculative: bool = False
    #: per-operator actuals of this task's compiled programs, keyed by
    #: canonical sub-fingerprint (exec/local_runner folds them in;
    #: shipped on the status response, rolled into QueryInfo)
    operators: List[OperatorStats] = dataclasses.field(
        default_factory=list
    )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "TaskStats":
        known = {f.name for f in dataclasses.fields(TaskStats)}
        kw = {k: v for k, v in d.items() if k in known}
        ops = kw.pop("operators", None) or []
        ts = TaskStats(**kw)
        ts.operators = [
            OperatorStats.from_dict(o) if isinstance(o, dict) else o
            for o in ops
        ]
        return ts


@dataclasses.dataclass
class StageStats:
    """One stage's task group + rollup (reference: StageStats)."""

    stage_id: int
    kind: str = "source"  # source|merge|join|producer
    state: str = "RUNNING"
    tasks: List[TaskStats] = dataclasses.field(default_factory=list)

    def rollup(self) -> dict:
        """Aggregate the stage's task stats (sums; wall is max — tasks
        run concurrently, so the stage costs its slowest task)."""
        return {
            "tasks": len(self.tasks),
            "wall_ms": max((t.wall_ms for t in self.tasks), default=0.0),
            "staging_ms": sum(t.staging_ms for t in self.tasks),
            "execute_ms": sum(t.execute_ms for t in self.tasks),
            "input_rows": sum(t.input_rows for t in self.tasks),
            "input_bytes": sum(t.input_bytes for t in self.tasks),
            "output_rows": sum(t.output_rows for t in self.tasks),
            "output_bytes": sum(t.output_bytes for t in self.tasks),
            "retries": sum(t.retries for t in self.tasks),
            "staging_cache_hits": sum(
                t.staging_cache_hits for t in self.tasks
            ),
            "dynamic_filter_rows_pruned": sum(
                t.dynamic_filter_rows_pruned for t in self.tasks
            ),
            "spool_pages_served": sum(
                t.spool_pages_served for t in self.tasks
            ),
            "spilled_bytes": sum(t.spilled_bytes for t in self.tasks),
            "device_dispatches": sum(
                t.device_dispatches for t in self.tasks
            ),
            "device_compiles": sum(
                t.device_compiles for t in self.tasks
            ),
            "device_compile_ms": sum(
                t.device_compile_ms for t in self.tasks
            ),
            "device_h2d_bytes": sum(
                t.device_h2d_bytes for t in self.tasks
            ),
            "device_d2h_bytes": sum(
                t.device_d2h_bytes for t in self.tasks
            ),
            "device_pad_rows": sum(
                t.device_pad_rows for t in self.tasks
            ),
            "device_live_rows": sum(
                t.device_live_rows for t in self.tasks
            ),
            "exchange_ici_edges": sum(
                t.exchange_ici_edges for t in self.tasks
            ),
            "exchange_http_edges": sum(
                t.exchange_http_edges for t in self.tasks
            ),
            "exchange_spool_edges": sum(
                t.exchange_spool_edges for t in self.tasks
            ),
            "failed_tasks": sum(
                1 for t in self.tasks if t.state == "FAILED"
            ),
        }

    def to_dict(self) -> dict:
        return {
            "stage_id": self.stage_id,
            "kind": self.kind,
            "state": self.state,
            "rollup": self.rollup(),
            "tasks": [t.to_dict() for t in self.tasks],
        }


@dataclasses.dataclass
class QueryStats:
    """One query's stats rollup (reference: QueryStats / QueryInfo)."""

    query_id: str
    sql: str
    state: str = "QUEUED"  # QUEUED|PLANNING|RUNNING|FINISHED|FAILED
    error: Optional[str] = None
    create_time: float = 0.0
    end_time: float = 0.0
    planning_ms: float = 0.0
    #: optimize-pass share of planning (prune + constraint push) —
    #: visible separately because the plan cache exists to eliminate it
    optimization_ms: float = 0.0
    staging_ms: float = 0.0  # host -> device page staging
    execution_ms: float = 0.0  # the plan's device run and result copy
    compile_cache_hit: bool = True
    #: statement-level parameterized plan cache (plan/canonical.py):
    #: True = planning was skipped, the canonical form was already
    #: planned and this execution only bound fresh literal values
    plan_cache_hit: bool = False
    #: micro-batched serving (coordinator batch queue + the vmapped
    #: compile entry in plan/canonical.py): True = this statement was
    #: answered by a shared batched dispatch; batch_size = how many
    #: same-fingerprint members rode that one dispatch
    batched: bool = False
    batch_size: int = 0
    #: serving-plane result reuse (server/result_cache.py): "" = the
    #: cache was never consulted (lane off / non-SELECT), "hit" =
    #: answered with zero planning and zero dispatch, "stale" =
    #: bounded-stale serve (background refresh spawned), "miss" =
    #: consulted, executed normally, entry stored. age/snapshot carry
    #: the EXPLAIN ANALYZE annotation ("result cache: HIT (snapshot
    #: v12, age 340ms)"); mview_rewritten names the view an eligible
    #: aggregate scan was rewritten onto (tier b), "" = no rewrite
    result_cache: str = ""
    result_cache_age_ms: float = 0.0
    result_cache_snapshot: str = ""
    mview_rewritten: str = ""
    #: adaptive execution (ROADMAP item 2): replanned = a statement-
    #: cache hit was judged epoch-stale and re-optimized against
    #: today's learned cardinalities; adapted = the runtime decision
    #: point changed strategy mid-query (broadcast<->partitioned flip,
    #: remainder re-ordering, partition resize). adaptive_notes holds
    #: the human-readable decision lines EXPLAIN ANALYZE renders
    #: ("REPLANNED (epoch 1→2) ..." / "SWITCHED broadcast→partitioned
    #: ...").
    replanned: bool = False
    adapted: bool = False
    adaptive_notes: List[str] = dataclasses.field(default_factory=list)
    staging_cache_hits: int = 0  # pages served device-resident
    retries: int = 0  # capacity-overflow re-runs
    device_fragments: int = 0  # stage-at-a-time programs beyond the root
    dynamic_filters: int = 0  # build->probe runtime range filters applied
    dynamic_filter_rows_pruned: int = 0  # probe rows dropped pre-join
    dynamic_filter_splits_pruned: int = 0  # probe splits never read
    dynamic_filter_wait_ms: float = 0.0  # probe wait on the build summary
    #: fault-tolerant execution (session retry_policy, server.spool)
    retry_policy: str = ""  # NONE | TASK | QUERY ("" = untracked/local)
    task_recoveries: int = 0  # lost tasks rescheduled mid-stage
    query_restarts: int = 0  # bounded full restarts (retry_policy=QUERY)
    spool_pages_served: int = 0  # upstream pages re-served from the spool
    #: cluster memory governance (server/memory_arbiter.py): this
    #: query's cluster-wide reservation view (coordinator pool +
    #: worker-reported bytes) and the host-spill restage traffic it
    #: paid — rolled into QueryInfo and the EXPLAIN ANALYZE memory line
    current_memory_bytes: int = 0
    peak_memory_bytes: int = 0
    spilled_bytes: int = 0
    #: device-plane accounting (utils/telemetry.py): dispatches /
    #: compiles (the hand-written kernels' nvcc builds this query's runs
    #: made; nothing else compiles per query) /
    #: transfer bytes / padding waste of THIS query's runs — local
    #: executions accumulate directly (runner._fold_device_stat);
    #: worker-task portions fold in as deltas in roll_up
    device_dispatches: int = 0
    device_compiles: int = 0
    device_compile_ms: float = 0.0
    device_h2d_bytes: int = 0
    device_d2h_bytes: int = 0
    device_pad_rows: int = 0
    device_live_rows: int = 0
    #: per-EDGE exchange transport mix (server/exchange_spi.py):
    #: upstream partitions consumed over the in-slice ICI segment /
    #: the HTTP wire / the durable spool across the query's merge and
    #: join tasks, plus the coordinator's own ICI gather edges —
    #: EXPLAIN ANALYZE's "exchange:" line
    exchange_ici_edges: int = 0
    exchange_http_edges: int = 0
    exchange_spool_edges: int = 0
    #: task-side spill bytes already folded into spilled_bytes
    #: (roll_up delta bookkeeping, like the dynamic-filter fields)
    _spill_from_tasks: int = 0
    #: task-side portions already folded into dynamic_filter_rows_pruned
    #: / dynamic_filters (roll_up bookkeeping — keeps coordinator-local
    #: additions from gather-splice / local-fallback executions intact;
    #: not exported)
    _df_rows_from_tasks: int = 0
    _df_filters_from_tasks: int = 0
    #: task-side device_* portions already folded (field name ->
    #: last-seen task sum; same delta bookkeeping, one dict instead of
    #: seven more fields)
    _device_from_tasks: Dict[str, float] = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )
    #: guards the delta fold above: roll_up runs concurrently from the
    #: query thread and /v1/query status polls, and a racy
    #: read-modify-write would double-count the delta (every other
    #: rollup field is a from-scratch overwrite and tolerates races)
    _roll_lock: object = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )
    input_rows: int = 0
    input_bytes: int = 0
    output_rows: int = 0
    trace_id: str = ""
    #: canonical plan fingerprint (plan/history.py) — the history
    #: store's statement key, also enriching the event-sink JSONL
    plan_fingerprint: str = ""
    node_stats: List[PlanNodeStats] = dataclasses.field(default_factory=list)
    #: per-operator actuals attributed LOCALLY (coordinator splice /
    #: local-runner execution); worker-task operators live on their
    #: TaskStats and merge in via all_operator_stats()
    operators: List[OperatorStats] = dataclasses.field(
        default_factory=list
    )
    stages: List[StageStats] = dataclasses.field(default_factory=list)
    #: the query's utils.tracing.Trace (None on untraced paths)
    trace: Optional[object] = None
    #: split-cache keys pinned for this query's lifetime (released by
    #: the runner's release_pins when the query ends)
    _pinned_keys: List[object] = dataclasses.field(
        default_factory=list, repr=False, compare=False
    )

    @property
    def elapsed_ms(self) -> float:
        end = self.end_time or time.time()
        return (end - self.create_time) * 1000.0

    def roll_up(self) -> None:
        """Fold stage rollups into the query-level totals (reference:
        QueryStats summing its StageStats). Idempotent: totals are
        recomputed from scratch on top of the coordinator-local
        accumulators, so it is safe to call per status poll."""
        # fresh task stats may change the operator rollup
        self.__dict__.pop("_ops_dict_cache", None)
        if not self.stages:
            return
        # input/staging/retry attribution lives worker-side for
        # distributed queries: overwrite (not add) from the freshest
        # task stats
        self.retries = sum(
            t.retries for s in self.stages for t in s.tasks
        )
        # a query compiled fresh ANYWHERE (coordinator splice or any
        # worker task) is not a compile-cache hit; sticky AND so a
        # coordinator-local miss survives later polls
        if any(
            not t.compile_cache_hit
            for s in self.stages
            for t in s.tasks
        ):
            self.compile_cache_hit = False
        self.staging_ms = sum(
            t.staging_ms for s in self.stages for t in s.tasks
        )
        self.staging_cache_hits = sum(
            t.staging_cache_hits for s in self.stages for t in s.tasks
        )
        self.input_rows = sum(
            t.input_rows for s in self.stages for t in s.tasks
        )
        self.input_bytes = sum(
            t.input_bytes for s in self.stages for t in s.tasks
        )
        # spool re-serves happen worker-side (merge tasks reading a
        # dead producer's committed pages): overwrite-sum like staging
        self.spool_pages_served = sum(
            t.spool_pages_served for s in self.stages for t in s.tasks
        )
        # worker-side fused-filter pruning folds in as a DELTA (the
        # field also accumulates coordinator-local pruning from
        # gather-splice / local-fallback executions, which a from-
        # scratch overwrite would discard); idempotent per poll.
        # splits_pruned/wait_ms stay coordinator-local accumulators.
        task_pruned = sum(
            t.dynamic_filter_rows_pruned
            for s in self.stages
            for t in s.tasks
        )
        # worker-LOCAL dynamic filters (fragmented joins inside a
        # task) surface on TaskStats.dynamic_filters: fold them so
        # QueryInfo never reports rows_pruned > 0 with 0 filters
        task_filters = sum(
            t.dynamic_filters for s in self.stages for t in s.tasks
        )
        # worker-side host-spill restage traffic folds in as a delta
        # too (coordinator-local restages accumulate on this field
        # directly via the runner's on_restage hook)
        task_spilled = sum(
            t.spilled_bytes for s in self.stages for t in s.tasks
        )
        with self._roll_lock:
            self.dynamic_filter_rows_pruned += (
                task_pruned - self._df_rows_from_tasks
            )
            self._df_rows_from_tasks = task_pruned
            self.dynamic_filters += (
                task_filters - self._df_filters_from_tasks
            )
            self._df_filters_from_tasks = task_filters
            self.spilled_bytes += task_spilled - self._spill_from_tasks
            self._spill_from_tasks = task_spilled
            # device-plane accounting folds like spill: the fields mix
            # coordinator-local contributions (gather splice, local
            # fallback) with worker-task sums
            for attr in (
                "device_dispatches",
                "device_compiles",
                "device_compile_ms",
                "device_h2d_bytes",
                "device_d2h_bytes",
                "device_pad_rows",
                "device_live_rows",
                "exchange_ici_edges",
                "exchange_http_edges",
                "exchange_spool_edges",
            ):
                task_sum = sum(
                    getattr(t, attr, 0)
                    for s in self.stages
                    for t in s.tasks
                )
                seen = self._device_from_tasks.get(attr, 0)
                setattr(
                    self, attr, getattr(self, attr) + task_sum - seen
                )
                self._device_from_tasks[attr] = task_sum

    def all_operator_stats(self) -> List[OperatorStats]:
        """Merged per-operator actuals across the whole query: locally
        attributed operators plus every FINISHED worker task's. Fold
        key is the node INSTANCE — (stage, node ordinal, fingerprint)
        — so split tasks of one stage sum into the full scan/filter
        totals while two distinct same-shape nodes (a self-join's two
        scans) stay separate instead of doubling the rows the history
        store learns. Exactly one FINISHED attempt counts per logical
        task: failed/aborted attempts are excluded by state, and a
        speculative loser (or a retried-but-actually-completed
        attempt) also reports FINISHED but measured the same split
        ranges as the winner."""
        from presto_tpu_torch.server.task_ids import logical_key

        merged: Dict[object, OperatorStats] = {}
        order: List[OperatorStats] = []

        def fold(key: object, op: OperatorStats) -> None:
            got = merged.get(key)
            if got is None:
                got = dataclasses.replace(op)
                merged[key] = got
                order.append(got)
            else:
                got.merge(op)

        for i, op in enumerate(self.operators):
            # already instance-folded by the runner (_fold_operator_
            # stats) — never merge two local entries with one another
            fold(("local", i), op)
        # query-wide: logical task seqs are unique per query, so a
        # restarted query whose retry re-mints the same ids never
        # counts the failed attempt's FINISHED tasks a second time
        counted = set()
        for s in self.stages:
            for t in s.tasks:
                if t.state != "FINISHED":
                    continue
                lk = logical_key(t.task_id)
                if lk in counted:
                    continue
                counted.add(lk)
                for op in t.operators:
                    fold(
                        (s.stage_id, op.node_id, op.fingerprint), op
                    )
        return order

    def device_dict(self) -> dict:
        """The query's device-plane section (QueryInfo, the event
        sink, and the EXPLAIN ANALYZE "device:" line all read this
        one shape)."""
        from presto_tpu_torch.utils.telemetry import pad_waste_pct

        return {
            "dispatches": self.device_dispatches,
            "compiles": self.device_compiles,
            "compile_ms": self.device_compile_ms,
            "h2d_bytes": self.device_h2d_bytes,
            "d2h_bytes": self.device_d2h_bytes,
            "pad_rows": self.device_pad_rows,
            "live_rows": self.device_live_rows,
            "pad_waste_pct": pad_waste_pct(
                self.device_pad_rows, self.device_live_rows
            ),
        }

    def result_cache_dict(self) -> dict:
        """The query's result-reuse section (QueryInfo, the event
        sink, and the EXPLAIN ANALYZE "result cache:" line read this
        one shape)."""
        return {
            "status": self.result_cache,
            "age_ms": self.result_cache_age_ms,
            "snapshot": self.result_cache_snapshot,
            "mview_rewritten": self.mview_rewritten,
        }

    def exchange_dict(self) -> dict:
        """The query's per-edge exchange transport section (QueryInfo
        and the EXPLAIN ANALYZE "exchange:" line read this one
        shape)."""
        return {
            "ici_edges": self.exchange_ici_edges,
            "http_edges": self.exchange_http_edges,
            "spool_edges": self.exchange_spool_edges,
        }

    def _operators_dicts(self) -> List[dict]:
        """Serialized operator rollup. The merge walks every stage/
        task/operator, and ``to_dict`` runs on EVERY client status
        poll — so once the query is terminal (stats final: the
        coordinator's last ``roll_up`` happens BEFORE the terminal
        state is stamped, and ``roll_up`` invalidates this cache) the
        result is computed once and reused by drain polls."""
        ops = self.__dict__.get("_ops_dict_cache")
        if ops is None:
            ops = [op.to_dict() for op in self.all_operator_stats()]
            if self.state in ("FINISHED", "FAILED"):
                self.__dict__["_ops_dict_cache"] = ops
        return ops

    def to_dict(self, include_stages: bool = True) -> dict:
        out = {
            "query_id": self.query_id,
            "query": self.sql,
            "state": self.state,
            "error": self.error,
            "trace_id": self.trace_id,
            "plan_fingerprint": self.plan_fingerprint,
            "create_time": self.create_time,
            "end_time": self.end_time,
            "elapsed_ms": self.elapsed_ms,
            "planning_ms": self.planning_ms,
            "optimization_ms": self.optimization_ms,
            "staging_ms": self.staging_ms,
            "execution_ms": self.execution_ms,
            "compile_cache_hit": self.compile_cache_hit,
            "plan_cache_hit": self.plan_cache_hit,
            "batched": self.batched,
            "batch_size": self.batch_size,
            "replanned": self.replanned,
            "adapted": self.adapted,
            "adaptive_notes": list(self.adaptive_notes),
            "staging_cache_hits": self.staging_cache_hits,
            "retries": self.retries,
            "device_fragments": self.device_fragments,
            "dynamic_filters": self.dynamic_filters,
            "dynamic_filter_rows_pruned": self.dynamic_filter_rows_pruned,
            "dynamic_filter_splits_pruned": (
                self.dynamic_filter_splits_pruned
            ),
            "dynamic_filter_wait_ms": self.dynamic_filter_wait_ms,
            "retry_policy": self.retry_policy,
            "task_recoveries": self.task_recoveries,
            "query_restarts": self.query_restarts,
            "spool_pages_served": self.spool_pages_served,
            "current_memory_bytes": self.current_memory_bytes,
            "peak_memory_bytes": self.peak_memory_bytes,
            "spilled_bytes": self.spilled_bytes,
            "input_rows": self.input_rows,
            "input_bytes": self.input_bytes,
            "output_rows": self.output_rows,
            # device-plane section (utils/telemetry.py accounting) —
            # additive: every pre-existing field above is untouched,
            # so JSONL event-sink consumers keep parsing (asserted in
            # tests/test_telemetry.py)
            "device": self.device_dict(),
            # per-edge exchange transport mix (additive, like the
            # device section)
            "exchange": self.exchange_dict(),
            # serving-plane result reuse (additive, same discipline)
            "result_cache": self.result_cache_dict(),
            # per-operator actuals (merged local + worker tasks): the
            # history store's write path reads this same record
            "operators": self._operators_dicts(),
        }
        if include_stages:
            out["stages"] = [s.to_dict() for s in self.stages]
        return out


# --------------------------------------------------------- query events


@dataclasses.dataclass
class QueryCompletedEvent:
    """Fired once per finished/failed query (reference: the
    EventListener SPI's QueryCompletedEvent)."""

    stats: QueryStats

    def to_dict(self) -> dict:
        out = {"event": "query_completed"}
        out.update(self.stats.to_dict(include_stages=True))
        trace = self.stats.trace
        if trace is not None:
            out["spans"] = trace.to_tree()
        return out


class JsonlQueryEventListener:
    """Appends one JSON line per QueryCompletedEvent to ``path`` —
    the machine-readable trace sink for benchmark runs."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def query_completed(self, event: QueryCompletedEvent) -> None:
        line = json.dumps(event.to_dict(), default=str)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")


class SlowQueryLog:
    """Query-completed listener that appends queries exceeding
    ``threshold_ms`` wall time to a JSONL sidecar, each record carrying
    the canonical plan fingerprint and the full EXPLAIN-ANALYZE-style
    text rendered from the query's own collected stats (no re-run —
    the per-operator actuals were traced out of the real execution).
    Config: ``slow-query.threshold-ms`` / ``slow-query.path``
    (threshold <= 0 = off). Counter: ``query.slow``."""

    def __init__(self, path: str, threshold_ms: float):
        self.path = path
        self.threshold_ms = float(threshold_ms)
        self._lock = threading.Lock()

    def query_completed(self, event: QueryCompletedEvent) -> None:
        if self.threshold_ms <= 0:
            return
        qs = event.stats
        if qs.elapsed_ms < self.threshold_ms:
            return
        from presto_tpu_torch.utils.metrics import REGISTRY

        REGISTRY.counter("query.slow").update()
        try:
            from presto_tpu_torch.exec.explain import render_query_analyze

            text = render_query_analyze(qs)
        except Exception:
            text = ""  # rendering must never fail the query
        rec = {
            "event": "slow_query",
            "query_id": qs.query_id,
            "query": qs.sql,
            "state": qs.state,
            "plan_fingerprint": qs.plan_fingerprint,
            "elapsed_ms": qs.elapsed_ms,
            "threshold_ms": self.threshold_ms,
            "explain_analyze": text,
        }
        line = json.dumps(rec, default=str)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")


class QueryHistory:
    """Process-wide registry of running + finished queries; backs the
    ``system.runtime.queries`` catalog table (reference:
    presto-system's runtime.queries, SURVEY.md §5.5)."""

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._capacity = capacity
        self._queries: Dict[str, QueryStats] = {}
        self._ids = itertools.count(1)
        #: query-completed listeners; each gets the QueryCompletedEvent
        self._listeners: List[object] = []

    def add_listener(self, listener) -> None:
        """Register an event listener (needs ``query_completed(ev)``).
        JSONL sinks dedup by real path here — the ONE registration
        site — so a config path and the env var naming the same file
        still produce one record per query."""
        import os

        with self._lock:
            if isinstance(listener, JsonlQueryEventListener):
                path = os.path.realpath(listener.path)
                for ln in self._listeners:
                    if (
                        isinstance(ln, JsonlQueryEventListener)
                        and os.path.realpath(ln.path) == path
                    ):
                        return
            self._listeners.append(listener)

    def begin(self, sql: str) -> QueryStats:
        with self._lock:
            qid = f"q_{next(self._ids)}"
            qs = QueryStats(
                query_id=qid, sql=sql, state="PLANNING",
                create_time=time.time(),
            )
            self._queries[qid] = qs
            while len(self._queries) > self._capacity:
                self._queries.pop(next(iter(self._queries)))
            return qs

    def adopt(self, qs: QueryStats) -> None:
        """Register an externally-created QueryStats (the coordinator's
        distributed queries) so one history serves both tiers."""
        with self._lock:
            self._queries[qs.query_id] = qs
            while len(self._queries) > self._capacity:
                self._queries.pop(next(iter(self._queries)))

    def finish(self, qs: QueryStats, error: Optional[str] = None) -> None:
        qs.end_time = time.time()
        qs.state = "FAILED" if error else "FINISHED"
        qs.error = error
        with self._lock:
            listeners = list(self._listeners)
        if listeners:
            ev = QueryCompletedEvent(stats=qs)
            for ln in listeners:
                try:
                    ln.query_completed(ev)
                except Exception:
                    pass  # a broken sink must never fail the query

    def snapshot(self) -> List[QueryStats]:
        with self._lock:
            return list(self._queries.values())


def node_label(node) -> str:
    from presto_tpu_torch.exec.explain import _describe

    return _describe(node)


def collect_node_stats(
    records: List[Tuple[int, str, int, int]]
) -> List[PlanNodeStats]:
    """Build PlanNodeStats from (walk_id, label, rows, capacity) records.

    walk ids (not node identities) key the records: the compiled-program
    cache outlives any one plan tree's objects, so identity matching
    would break on every cache hit."""
    out = [
        PlanNodeStats(
            node_id=w, label=label, output_rows=rows, output_capacity=cap
        )
        for w, label, rows, cap in records
    ]
    out.sort(key=lambda s: s.node_id)
    return out

"""Coordinator process: SQL frontend, discovery, stage scheduling,
exchange client, paged client protocol.

The PyTorch counterpart of ``presto_tpu/server/coordinator.py`` on its
default path. Reference parity: the coordinator half of SURVEY.md
§1/§3 — ``POST /v1/statement`` with paged ``nextUri`` results (L0),
parse/plan/fragment (L1-L2), stage scheduling to workers over the task
protocol (L3), the consumer side of the paged exchange
(``ExchangeClient``), embedded discovery with TTL-expiring worker
announcements and failure detection (SURVEY.md §5.3).

The coordinator's embedded ``LocalQueryRunner`` runs on one CUDA device
(``device=None`` means CUDA and raises without a card; tests pass
``device="cpu"``): the gather's final step (a GROUP BY there is one
``onehot_reduce_many`` launch, K1, over the gathered partial states),
the final splice, the all-workers-dead local fallback and, with no
workers, every SELECT.

The serving plane: the micro-batch queue (:class:`MicrobatchQueue`,
``serving.microbatch-wait-ms`` / ``serving.microbatch-max``) answers
concurrent coordinator-local statements of one cached shape with one
pass of the operators
(``LocalQueryRunner.execute_plan_microbatch``); the snapshot-keyed
result cache (``server/result_cache.py``, ``result-cache.*``) sits in
front of dispatch and under the queue; the ingest lane
(``server/ingest.py``, ``ingest.wal-path``) takes
``POST /v1/ingest/{table}``.

Fault-tolerant execution: ``retry_policy`` TASK re-runs the lost tasks
of a stage, and a partitioned stage's consumers re-serve a dead
producer's committed pages from the durable exchange spool
(``server/spool.py``, ``exchange.spool-path``); QUERY restarts the whole
query within ``query_retry_count`` (and re-admits a memory-killed
victim once pressure subsides). The admission journal
(``server/journal.py``, ``coordinator.journal-path``) lets a restarted
coordinator resume its queued and running queries under aliases, and
the lease plane (``server/lease.py``, ``coordinator.peers``) lets a
surviving peer claim a dead coordinator's journal and resume its
queries.

The QoS plane (``server/qos.py``, ``qos.enabled``) admits queries by
priority lane, suspends a running lower-priority query at its next range
boundary when a higher-priority one waits, and resumes it under the same
logical task ids; the elastic pool (``attach_pool``,
``pool.max-workers``) grows and shrinks the workers with the backlog
through a ``server/pool.py`` provider. A QUERY restart schedules on no
node whose failure failed the attempt until that node announces itself
again.

The in-slice (ICI) exchange (``server/exchange_spi.py``,
``exchange.ici-enabled`` or ``SET SESSION exchange_ici_enabled``): a
partitioned stage whose workers share an announced slice is planned on
it, its edges move device pages between co-located workers, and the
root stage's gather is one more in-slice edge when the coordinator
shares the slice (``exchange.single-program``).

The durable lakehouse tee (``lakehouse.*`` beside
``ingest.wal-path``): each ingest commit publishes a manifest snapshot
(``server/manifests.py``) before its WAL commit frame, and compaction
and the orphan GC run in the ingest lane.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import json
import logging
import sys
import threading
import time
import traceback
import urllib.error
import uuid
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np

from presto_tpu_torch.exec.staging import stage_page
from presto_tpu_torch.exec.stats import QueryStats, StageStats, TaskStats
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.server import exchange_spi, pages_wire, rpc, task_ids
from presto_tpu_torch.server.journal import CoordinatorJournal
from presto_tpu_torch.server.protocol import FragmentSpec
from presto_tpu_torch.server.scheduler import (
    assign_ranges,
    plan_stage,
    select_exchange_edges,
    select_exchange_transport,
    stable_workers,
)
from presto_tpu_torch.server.spool import ExchangeSpool
from presto_tpu_torch.utils import faults
from presto_tpu_torch.utils.metrics import REGISTRY, DistributionStat
from presto_tpu_torch.utils.tracing import Trace

log = logging.getLogger("presto_tpu_torch.coordinator")

#: announcement TTL: a worker silent this long is dropped (reference:
#: discovery TTL expiry removing dead nodes from scheduling)
NODE_TTL_S = 10.0
RESULT_PAGE_ROWS = 4096
#: completed queries kept for /v1/query + system.runtime (reference:
#: query.max-history); running/queued queries are never evicted
MAX_QUERY_HISTORY = 100
#: a finished query whose client has NOT drained its results survives
#: eviction this long past end_time
DRAIN_GRACE_S = 900.0


class NoLiveWorkers(RuntimeError):
    """Every candidate worker is dead or circuit-open — the trigger
    for coordinator-local fallback execution."""


class MemoryPressureKilled(RuntimeError):
    """The cluster memory manager killed this query (victim + policy
    in the message) and no re-admission budget remained."""


def _prepare_text(sql: str, name: str) -> str:
    """The inner statement TEXT of ``PREPARE name FROM <statement>`` —
    what the added-prepare response header carries (the parse tree has
    already validated it; the client replays the text verbatim)."""
    import re

    m = re.match(
        r"\s*prepare\s+" + re.escape(name) + r"\s+from\s+(.*)$",
        sql,
        re.IGNORECASE | re.DOTALL,
    )
    if not m:
        raise RuntimeError(f"malformed PREPARE statement: {sql!r}")
    return m.group(1).strip().rstrip(";")


def _is_draining_503(exc) -> bool:
    """A DRAINING worker's task rejection: recoverable AND free — the
    task was never created, so re-routing it is not a recovery and
    must neither charge the retry budget nor penalize the breaker."""
    return (
        isinstance(exc, urllib.error.HTTPError) and exc.code == 503
    )


@dataclasses.dataclass
class _WorkerNode:
    node_id: str
    uri: str
    last_seen: float
    version: str = "presto-tpu-0.1"
    coordinator: bool = False
    state: str = "ACTIVE"
    #: preemptible capacity (elastic pools): gather/merge stages are
    #: placed on stable nodes when any exist (scheduler.stable_workers)
    preemptible: bool = False
    #: slice identity announced on discovery (in-slice collective
    #: shuffle): workers sharing one non-empty slice id are co-located
    #: — the scheduler plans their partitioned exchanges as device
    #: collectives (scheduler.select_exchange_transport); "" = unknown
    #: topology, HTTP only
    slice_id: str = ""
    #: device coordinates announced beside the slice id (topology
    #: observability only)
    device_coords: tuple = ()
    #: the worker's boot-time device probe (utils/devicediag.py):
    #: which phase failed (enumerate/compile/execute), the error
    #: class, and any fallback decision — surfaced verbatim on
    #: system.runtime.nodes so a silently-degraded node is visible
    #: from the coordinator
    backend_diag: dict = dataclasses.field(default_factory=dict)


class _Query:
    def __init__(self, qid: str, sql: str):
        self.qid = qid
        self.sql = sql
        self.state = "QUEUED"
        self.error: Optional[str] = None
        self.columns: List[dict] = []
        self.rows: List[list] = []
        self.done = threading.Event()
        # observability: per-query span tree + the QueryInfo stats
        # rollup served at GET /v1/query/{id}
        self.trace = Trace()
        self.stats = QueryStats(
            query_id=qid, sql=sql, create_time=time.time(),
            trace_id=self.trace.trace_id, trace=self.trace,
        )
        self._stats_lock = threading.Lock()
        self._stage_seq = itertools.count(0)
        #: logical-task sequence for deterministic attempt ids
        #: (server.task_ids — the spool recovery key space)
        self._task_seq = itertools.count(0)
        #: adaptive partitioned->broadcast handoff: build-subtree
        #: fingerprint -> (FilterSummary, summarized keys) observed by
        #: the probe stage, reused by the replicated join's
        #: dynamic-filter plane instead of a second summary stage
        self._df_probe_reuse: Dict[str, tuple] = {}
        self._task_stage: Dict[str, StageStats] = {}
        self._recorded: set = set()
        self._adopted = False  # registered in the runner's QueryHistory
        self._plan_root = None  # pruned plan root (distributed EXPLAIN)
        #: output_rows already holds the real result count (distributed
        #: EXPLAIN ANALYZE, where q.rows is plan text, not the result)
        self._output_rows_final = False
        #: the client consumed the last result page (or the error):
        #: history eviction must not drop a query mid-pagination
        self._drained = False
        #: per-query task-retry budget (None until first use: the
        #: session default is read lazily so SET SESSION applies)
        self._retry_budget: Optional[int] = None
        #: task ids of speculative (backup) attempts, for accounting
        self._speculative: set = set()
        #: cluster memory manager kill notice (the MEMORY_PRESSURE
        #: message): set by _apply_memory_kill when the victim may
        #: re-admit; consumed by the restart loop's re-admission lane
        self._mem_kill: Optional[str] = None
        #: the admission high-water hold PARKED this query before
        #: dispatch: a parked statement must not also accrue the
        #: micro-batch window after release (the window starts at
        #: dispatch-eligibility, not at submit)
        self._admission_parked = False
        #: serving-plane result reuse (server/result_cache.py): the
        #: minted fingerprint x literal key, the statement it was minted
        #: from (a background refresh re-plans it), and the plan whose
        #: pinned snapshot handles key the stored entry
        self._rc_key: Optional[tuple] = None
        self._rc_stmt = None
        self._rc_plan = None
        #: prepared statements supplied by the CLIENT on this request
        #: (X-Presto-Prepared-Statement headers — the client owns the
        #: map; see server.protocol)
        self.prepared: Dict[str, str] = {}
        #: response-header payloads: (name, sql) registered by a
        #: PREPARE in this query / name dropped by a DEALLOCATE
        self.added_prepare: Optional[Tuple[str, str]] = None
        self.deallocated_prepare: Optional[str] = None

    def fail(self, error: str) -> None:
        """Terminal rejection/kill close-out — one place for the
        state/stats/clock contract (rejected and killed queries never
        reach _finish_query_stats)."""
        self.state = "FAILED"
        self.error = error
        self.stats.state = "FAILED"
        self.stats.error = error
        self.stats.end_time = time.time()


def _truthy(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("true", "1", "yes", "on")
    return bool(v)


class _MicrobatchMember:
    """One statement parked in the batch queue: its cached canonical
    plan (bound values included), its stats sink, and the event the
    leader signals when the batch delivered (or dropped) this member's
    lane.

    ``claim()`` is the exactly-once ownership handshake: the LEADER
    claims every member before dispatching, an abandoning FOLLOWER (its
    belt-timeout fired) claims before falling back to scalar; whoever
    claims serves the member, so a late leader can never write batch
    results or stats into a query its own thread already answered."""

    __slots__ = ("plan", "qs", "result", "event", "joined_at", "_own")

    def __init__(self, plan, qs):
        self.plan = plan
        self.qs = qs
        self.result = None
        self.event = threading.Event()
        self.joined_at = time.monotonic()
        self._own = threading.Lock()

    def claim(self) -> bool:
        return self._own.acquire(blocking=False)


class _MicrobatchGroup:
    def __init__(self, key: str):
        self.key = key
        self.members: List[_MicrobatchMember] = []
        #: set when the group hits microbatch_max: wakes the leader
        #: before the window expires
        self.full = threading.Event()
        self.closed = False


class MicrobatchQueue:
    """Coordinator-side micro-batch serving plane: the batch queue in
    front of local dispatch (many point lookups, one pass of the
    operators on the card).

    The FIRST statement of a canonical shape to reach dispatch becomes
    its group's leader: it holds the window open for
    ``microbatch_wait_ms`` (or until ``microbatch_max`` members join),
    then answers the whole group with ONE batched run
    (``LocalQueryRunner.execute_plan_microbatch``; the lane-axis
    stacking lives in plan/canonical.py). Followers park on an event and
    receive their lane's result. Any member whose lane fell out of the
    batch (no lane form, an error bit or overflow flag, output beyond
    the window) re-runs the scalar path on its own thread: batching can
    cost a wait, never a wrong answer or a failed query. The leader's
    and the followers' threads all launch on the card's default stream
    through the one runner."""

    def __init__(self, runner):
        self._runner = runner
        self._lock = threading.Lock()
        self._groups: Dict[str, _MicrobatchGroup] = {}

    def execute(
        self,
        key: str,
        plan,
        qs,
        wait_ms: float,
        max_size: int,
        no_wait: bool = False,
    ):
        """-> QueryResult, or None (the caller runs the scalar path).

        ``no_wait``: the statement already waited once (the admission
        high-water hold parked it before dispatch): it must not accrue
        the batch window on top of the hold, so it neither opens nor
        joins a window (the window starts at dispatch-eligibility, not
        at submit)."""
        if no_wait:
            return None
        member = _MicrobatchMember(plan, qs)
        with self._lock:
            g = self._groups.get(key)
            if (
                g is not None
                and not g.closed
                and len(g.members) < max_size
            ):
                g.members.append(member)
                if len(g.members) >= max_size:
                    g.full.set()
                leader = False
            else:
                g = _MicrobatchGroup(key)
                g.members.append(member)
                self._groups[key] = g
                leader = True
        if not leader:
            # the leader delivers this lane's result at dispatch; the
            # timeout is a belt: a wedged leader must never wedge a
            # query. On timeout the follower CLAIMS itself: claim won ->
            # the leader will skip this lane, scalar path here; claim
            # lost -> the leader owns the lane and always delivers
            # (finally below), so wait it out
            if not member.event.wait(wait_ms / 1000.0 + 60.0):
                if member.claim():
                    self._note_wait(member)
                    return None
                member.event.wait()
            self._note_wait(member)
            return member.result
        g.full.wait(wait_ms / 1000.0)
        with self._lock:
            g.closed = True
            if self._groups.get(key) is g:
                del self._groups[key]
            members = list(g.members)
        self._note_wait(member)
        # exactly-once ownership: the leader claims every member it will
        # serve; one whose claim is lost already abandoned (it answers
        # itself scalar) and must not be touched again
        claimed = [m for m in members if m.claim()]
        if len(claimed) < 2:
            for m in claimed:
                if m is not member:
                    m.event.set()  # result stays None: scalar path
            return None  # nobody to share the pass with
        results = [None] * len(claimed)
        try:
            try:
                results = self._runner.execute_plan_microbatch(
                    [m.plan for m in claimed],
                    [m.qs for m in claimed],
                )
            except Exception:
                # every member re-runs the scalar path, which raises
                # the error itself if it is a real one (a failed
                # launch); counted so a run can show no batch failed
                REGISTRY.counter("serving.batch_errors").update()
                log.exception(
                    "micro-batch dispatch failed; members fall back"
                )
        finally:
            # delivery is unconditional: followers whose claim the
            # leader won are parked on this event
            for m, r in zip(claimed, results):
                m.result = r
            for m in claimed:
                m.event.set()
        return member.result

    @staticmethod
    def _note_wait(member: _MicrobatchMember) -> None:
        REGISTRY.distribution("serving.batch_wait_ms").add(
            (time.monotonic() - member.joined_at) * 1000.0
        )


class CoordinatorServer:
    """Coordinator: embedded discovery + dispatcher + exchange client.

    Admission control (reference: DispatchManager + resource-group
    queueing, SURVEY.md §2.1 "Dispatch/queue"): at most
    ``max_concurrent_queries`` run at once; up to ``max_queued_queries``
    wait; beyond that submissions are REJECTED immediately instead of
    accumulating unbounded threads."""

    def __init__(
        self,
        port: int = 0,
        catalogs=None,
        session=None,
        max_concurrent_queries: int = 4,
        max_queued_queries: int = 100,
        config=None,
        resource_groups=None,
        device=None,
    ):
        from presto_tpu_torch.exec.local_runner import LocalQueryRunner
        from presto_tpu_torch.utils.memory import MemoryPool, parse_bytes

        # memory accounting ALWAYS on (reference: MemoryPool +
        # ClusterMemoryManager kill-largest policy; limit from tier-1
        # config query.max-memory-per-node)
        limit = parse_bytes(
            (config.get("query.max-memory-per-node") if config else None)
            or "8GB"
        )
        self.memory_pool = MemoryPool(
            limit, kill_largest=self._kill_largest_query
        )
        self.memory_pool.node_id = "coordinator"
        # gather-side staging knobs: the coordinator's embedded runner
        # stages gathered pages and coordinator-local scans through the
        # same device-resident split cache / prefetch pipeline the
        # workers use (tier-1: staging.cache-bytes, staging.prefetch-depth)
        from presto_tpu_torch.exec.staging import DEFAULT_CACHE_BYTES

        cache_raw = (
            config.get("staging.cache-bytes") if config else None
        )
        # device=None means CUDA and raises without a card, as the
        # runner does: the gather, final splice and local fallback run
        # on this device
        self.local = LocalQueryRunner(
            catalogs=catalogs, session=session,
            device=device,
            memory_pool=self.memory_pool,
            staging_cache_bytes=(
                parse_bytes(cache_raw)
                if cache_raw is not None
                else DEFAULT_CACHE_BYTES
            ),
            # history-based statistics (plan/history.py): the
            # coordinator owns the store — queries complete here, and
            # estimate_rows reads it during planning
            history_path=(
                config.get("history.path") if config else None
            ),
            history_max_entries=int(
                config.get("history.max-entries", 256) if config else 256
            ),
        )
        prefetch = (
            config.get("staging.prefetch-depth") if config else None
        )
        if prefetch is not None:
            self.local.session.set(
                "staging_prefetch_depth", int(prefetch)
            )
        # distributed dynamic filtering (exec/dynfilter.py): tier-1
        # keys seed the session defaults, like the staging knobs
        df_wait = (
            config.get("dynamic-filtering.wait-ms") if config else None
        )
        if df_wait is not None:
            self.local.session.set(
                "dynamic_filtering_wait_ms", float(df_wait)
            )
        df_ndv = (
            config.get("dynamic-filtering.ndv-limit") if config else None
        )
        if df_ndv is not None:
            self.local.session.set(
                "dynamic_filtering_ndv_limit", int(df_ndv)
            )
        self.local.cluster = self  # system.runtime.nodes source
        # config-wired query-completed JSONL sink (the env-var hook in
        # LocalQueryRunner covers bench/embedded runs; add_listener
        # dedups same-file sinks, so both naming one path is fine)
        event_log = config.get("event-listener.path") if config else None
        if event_log:
            from presto_tpu_torch.exec.stats import JsonlQueryEventListener

            self.local.history.add_listener(
                JsonlQueryEventListener(event_log)
            )
        # slow-query JSONL sidecar: queries over the threshold append
        # their EXPLAIN ANALYZE text + canonical plan fingerprint
        # (exec/stats.SlowQueryLog; default off)
        slow_ms = (
            config.get("slow-query.threshold-ms") if config else None
        )
        if slow_ms is not None and float(slow_ms) > 0:
            from presto_tpu_torch.exec.stats import SlowQueryLog

            slow_path = (config.get("slow-query.path") if config else None) or (
                (event_log + ".slow") if event_log else None
            )
            if slow_path:
                self.local.history.add_listener(
                    SlowQueryLog(slow_path, float(slow_ms))
                )
        # per-operator observability gate (exec/stats.OperatorStats):
        # tier-1 seed for the enable_operator_stats session default
        opstats = (
            config.get("operator-stats.enabled") if config else None
        )
        if opstats is not None:
            self.local.session.set(
                "enable_operator_stats", bool(opstats)
            )
        self.workers: Dict[str, _WorkerNode] = {}
        self.queries: Dict[str, _Query] = {}
        # fault-tolerance plane: one RPC policy for every
        # coordinator->worker call, and per-worker circuit breakers
        # (consecutive-failure scoring) folded into scheduling
        self._rpc_policy = rpc.RpcPolicy.from_config(config)
        self.breakers: Dict[str, rpc.CircuitBreaker] = {}
        self._breaker_threshold = int(
            config.get("failure-detector.threshold", 3) if config else 3
        )
        self._breaker_open_s = float(
            config.get("failure-detector.open-s", 5.0) if config else 5.0
        )
        fault_spec = (
            config.get("fault-injection.spec") if config else None
        )
        if fault_spec:
            faults.configure(fault_spec)
        # fault-tolerant execution: tier-1 retry-policy seeds the
        # session default; the durable-exchange spool (shared dir with
        # the workers) backs TASK-level recovery and the occupancy row
        # in system.runtime.caches
        rp = config.get("retry-policy") if config else None
        if rp is not None:
            self.local.session.set("retry_policy", rp)
        # in-slice shuffle (server/exchange_spi.py): tier-1
        # exchange.ici-enabled seeds the session default; off (the
        # default) keeps the HTTP shuffle bit-exact
        ici_on = config.get("exchange.ici-enabled") if config else None
        if ici_on is not None:
            self.local.session.set("exchange_ici_enabled", bool(ici_on))
        # single-program collective stages: tier-1
        # exchange.single-program seeds the session default (on by
        # default; meaningful only with the ICI gate above on)
        sp_on = (
            config.get("exchange.single-program") if config else None
        )
        if sp_on is not None:
            self.local.session.set(
                "exchange_single_program", bool(sp_on)
            )
        # the coordinator's own slice: the ICI gather edge
        # (exchange_spi.ici_gather) compares it with the root stage's
        # planned slice; the config override first, so topologies can
        # be pinned
        self.slice_id = str(
            (config.get("exchange.slice-id") if config else None)
            or exchange_spi.default_slice_id(self.local.device)
        )
        # parameterized plan cache (plan/canonical.py): tier-1 keys
        # bound the statement-level LRU and seed the session default
        pce = config.get("plan.cache-entries") if config else None
        if pce is not None:
            self.local.plan_cache.resize(int(pce))
        pcen = config.get("plan.cache-enabled") if config else None
        if pcen is not None:
            self.local.session.set("enable_plan_cache", bool(pcen))
        # adaptive execution (epoch-versioned replanning + runtime
        # join-strategy switching): tier-1 keys seed the session
        # defaults, and the divergence factor also drives the history
        # store's epoch bumps (one factor, both layers)
        ad_on = config.get("adaptive.enabled") if config else None
        if ad_on is not None:
            self.local.session.set("adaptive_enabled", bool(ad_on))
        ad_factor = (
            config.get("adaptive.divergence-factor") if config else None
        )
        if ad_factor is not None:
            self.local.session.set(
                "adaptive_divergence_factor", float(ad_factor)
            )
            if self.local.history_store is not None:
                self.local.history_store.divergence_factor = max(
                    float(ad_factor), 1.0
                )
        # materialized views (exec/mview.py): tier-1 keys seed the
        # registry's read gate and maintenance mode
        mv_stale = (
            config.get("mview.max-staleness-s") if config else None
        )
        mv_inc = (
            config.get("mview.incremental-enabled") if config else None
        )
        if mv_stale is not None:
            self.local.mview_registry.max_staleness_s = float(mv_stale)
        if mv_inc is not None:
            self.local.mview_registry.incremental_enabled = bool(mv_inc)
        mv_rw = config.get("mview.auto-rewrite") if config else None
        if mv_rw is not None:
            self.local.session.set("mview_auto_rewrite", bool(mv_rw))
        # micro-batched serving: tier-1 serving.* keys seed the session
        # defaults (0 = off = the scalar dispatch), and the ONE batch
        # queue fronts this coordinator's local dispatch
        mb_wait = (
            config.get("serving.microbatch-wait-ms") if config else None
        )
        if mb_wait is not None:
            self.local.session.set("microbatch_wait_ms", float(mb_wait))
        mb_max = config.get("serving.microbatch-max") if config else None
        if mb_max is not None:
            self.local.session.set("microbatch_max", int(mb_max))
        self.microbatch = MicrobatchQueue(self.local)
        # serving-plane result reuse (server/result_cache.py): tier-1
        # result-cache.* keys seed the session gates; the ONE cache is
        # built unconditionally (idle = zero bytes, zero lookups: the
        # session gate decides whether any path consults it) so the
        # write fan-in and system.runtime.caches see a stable object
        from presto_tpu_torch.server.result_cache import ResultCache

        rc_on = config.get("result-cache.enabled") if config else None
        if rc_on is not None:
            self.local.session.set("enable_result_cache", _truthy(rc_on))
        rc_stale = (
            config.get("result-cache.max-staleness-s") if config else None
        )
        if rc_stale is not None:
            self.local.session.set(
                "result_cache_max_staleness_s", float(rc_stale)
            )
        rc_bytes = config.get("result-cache.bytes") if config else None
        self.result_cache = ResultCache(
            self.local,
            parse_bytes(rc_bytes)
            if rc_bytes is not None
            else 256 * 1024 * 1024,
            pool=self.memory_pool,
        )
        self.local.result_cache = self.result_cache
        # streaming ingest lane (server/ingest.py): built in start(),
        # AFTER the embedder registered its catalogs (WAL replay
        # resolves tables through them). Unset = none of it is built
        self.ingest = None
        ing_path = config.get("ingest.wal-path") if config else None
        lake_fb = (
            config.get("lakehouse.target-file-bytes") if config else None
        )
        self._ingest_cfg = (
            (
                ing_path,
                float(config.get("ingest.commit-interval-ms", 50.0)),
                {
                    "lakehouse_path": config.get("lakehouse.path"),
                    "lakehouse_target_file_bytes": (
                        parse_bytes(lake_fb)
                        if lake_fb is not None
                        else None
                    ),
                    "lakehouse_compaction_interval_s": float(
                        config.get("lakehouse.compaction.interval-s", 0.0)
                    ),
                    "lakehouse_compaction_min_files": int(
                        config.get("lakehouse.compaction.min-files", 4)
                    ),
                    "lakehouse_orphan_ttl_s": float(
                        config.get("lakehouse.orphan-ttl-s", 86400.0)
                    ),
                },
            )
            if ing_path
            else None
        )
        #: coordinator-global prepared statements (PREPARE over plain
        #: HTTP without a header-aware client); header-supplied maps on
        #: the request take precedence. Bounded: a serving fleet cycles
        #: thousands of ad-hoc names
        self._prepared_sql: "OrderedDict[str, str]" = OrderedDict()
        self._prepared_mu = threading.Lock()
        self.spool = ExchangeSpool.from_config(config)
        # durable coordinator state (server.journal): admitted/queued/
        # running queries + the prepared registry survive a bounce —
        # start() replays the journal and re-admits open queries
        jp = config.get("coordinator.journal-path") if config else None
        # multi-coordinator control plane: with coordinator.peers set,
        # the journal path is a SHARED directory — each coordinator
        # journals under its own subdirectory and publishes an
        # atomic-rename lease beside it (server/lease.py). Peers fold
        # each other's lease payloads into admission (memory arbiter,
        # resource-group quotas, QoS lanes) and claim+resume a dead
        # peer's journal on lease expiry. Without peers the lease
        # plane never constructs and the journal lives at the path
        # root — bit-exact single-coordinator behavior.
        self.coord_id = (
            (config.get("node.id") if config else None)
            or f"coord-{uuid.uuid4().hex[:6]}"
        )
        peers_raw = config.get("coordinator.peers") if config else None
        self._peer_uris = [
            u.strip()
            for u in str(peers_raw or "").split(",")
            if u.strip()
        ]
        self.lease = None
        self._control_dir = None
        self._lease_thread = None
        #: dead-peer journals this incarnation claimed / queries it
        #: resumed from them (nodes + failover observability)
        self.failover_claims = 0
        self.failover_resumed = 0
        if jp and self._peer_uris:
            from presto_tpu_torch.server.lease import LeasePlane

            self._control_dir = jp
            self.journal = CoordinatorJournal(
                os.path.join(jp, self.coord_id)
            )
            self.lease = LeasePlane(
                jp,
                self.coord_id,
                ttl_s=float(
                    config.get("lease.ttl-s", 10.0) if config else 10.0
                ),
            )
        else:
            self.journal = CoordinatorJournal(jp) if jp else None
        # elastic worker pool (server.pool): bounds + control cadence
        # from tier-1 config; attach_pool() supplies the provider and
        # starts the autoscaler
        self._pool_cfg = {
            "min_workers": int(
                config.get("pool.min-workers", 0) if config else 0
            ),
            "max_workers": int(
                config.get("pool.max-workers", 0) if config else 0
            ),
            "interval_s": float(
                config.get("pool.scale-interval-s", 1.0) if config else 1.0
            ),
            "scale_down_ticks": int(
                config.get("pool.scale-down-ticks", 3) if config else 3
            ),
            "cooldown_s": (
                float(config.get("pool.cooldown-s"))
                if config and config.get("pool.cooldown-s") is not None
                else None
            ),
        }
        self.autoscaler = None
        #: node ids spawned by the autoscaler that have not announced
        #: yet (the SCALING_UP pool state in system.runtime.nodes)
        self._pool_scaling: set = set()
        #: the autoscaler's last decision (nodes view)
        self.pool_decision = ""
        #: node id -> monotonic time of its last connection-level
        #: failure (the QUERY restart reads which nodes failed during
        #: the attempt it replaces)
        self._failed_at: Dict[str, float] = {}
        #: nodes whose failure failed a query attempt: nothing schedules
        #: on them until they announce themselves again (a half-open
        #: breaker alone would re-admit a dead node to the restart)
        self._lost_nodes: set = set()
        #: queries re-admitted from the journal at this boot
        self.resumed_queries = 0
        #: old-boot qid -> this boot's qid: statement/query-info URLs
        #: minted by a dead incarnation stay routable after a restart
        self._qid_alias: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._qid = itertools.count(1)
        #: per-boot nonce folded into every query id: deterministic
        #: task-attempt ids must never COLLIDE across coordinator
        #: restarts — a restarted coordinator's q_c1 minting the same
        #: attempt ids as its previous incarnation would let the shared
        #: spool serve (or interleave with) a dead run's pages inside
        #: the TTL window
        self._boot = uuid.uuid4().hex[:6]
        self._shutting_down = False
        self._admit = threading.Semaphore(max_concurrent_queries)
        self._max_queued = max_queued_queries
        self._pending = 0  # queued + running, admission-gated
        # weighted-fair resource groups (reference: resource-group
        # managers; SURVEY.md §2.1 "Dispatch/queue"). dict spec or a
        # path to an etc/resource-groups.json-style file; None = the
        # flat admission gate only.
        self.resource_groups = None
        if resource_groups is not None:
            from presto_tpu_torch.server.resource_groups import (
                ResourceGroupManager,
            )

            self.resource_groups = (
                ResourceGroupManager.from_file(resource_groups)
                if isinstance(resource_groups, str)
                else ResourceGroupManager(resource_groups)
            )
            self.resource_groups.memory_usage_fn = self._group_memory
        # governance wiring for the coordinator's OWN pool: with the
        # gate on, over-budget local reservations (gather splices,
        # local fallback) join the blocked lane — visible to the
        # arbiter, resolvable by the killer, cancellable on readmit —
        # and the local split cache gets the host-spill budget, like
        # any worker. (Enforcement rides worker heartbeats; a
        # worker-less coordinator still bounds blocked waits by
        # memory.reserve-block-max-s.)
        if config and config.get("memory.governance-enabled", False):
            self.memory_pool.block_timeout_s = float(
                config.get("memory.reserve-block-max-s", 30.0)
            )
            spill_raw = config.get("memory.host-spill-bytes")
            if spill_raw is not None:
                self.local.split_cache.set_spill_budget(
                    parse_bytes(spill_raw)
                )
        # cluster memory arbiter (server/memory_arbiter.py): folds the
        # workers' heartbeat memory reports into one cluster view.
        # Accounting is ALWAYS on (resource-group quotas and
        # system.runtime.memory read it); enforcement — admission
        # high-water, per-query quotas, the low-memory killer — only
        # under memory.governance-enabled
        from presto_tpu_torch.server.memory_arbiter import ClusterMemoryArbiter

        self.arbiter = ClusterMemoryArbiter(self, config)
        # tail-latency QoS plane (server/qos.py): priority admission
        # lanes + preempt-and-resume + per-group SLOs. Disabled
        # (default) the controller is never constructed and admission
        # stays the bit-exact legacy semaphore below
        self.qos = None
        if config and _truthy(config.get("qos.enabled", False)):
            from presto_tpu_torch.server.qos import QosController

            self.qos = QosController(
                self, config, max_concurrent_queries
            )
        # multi-coordinator shared admission: live peers' lease
        # payloads fold into the memory view and the QoS lane columns
        # (both hooks default None — single-coordinator stays bit-exact)
        if self.lease is not None:
            self.arbiter.peer_reports_fn = self._peer_memory_reports
            if self.qos is not None:
                self.qos.peer_lanes_fn = self.peer_lane_occupancy

        # device-plane telemetry (utils/telemetry.py): federation of
        # the workers' /v1/metrics expositions behind
        # /v1/metrics/cluster, plus the bounded time-series sampler
        # backing system.runtime.metrics_history. Sampling and
        # persistence are off by default; the DEVICE counter plane
        # itself follows telemetry.enabled so a disabled cluster stays
        # bit-exact pre-telemetry.
        from presto_tpu_torch.utils.telemetry import (
            DEVICE,
            MetricsFederation,
            MetricsSampler,
        )

        if config is not None:
            t_enabled = config.get("telemetry.enabled")
            if t_enabled is not None:
                DEVICE.set_enabled(bool(t_enabled))
        self.federation = MetricsFederation(
            lambda uri: rpc.call("GET", uri).body.decode(
                "utf-8", "replace"
            )
        )
        self.telemetry_sampler = None
        self._telemetry_interval_s = float(
            (config.get("telemetry.sample-interval-s", 0.0) or 0.0)
            if config
            else 0.0
        )
        if self._telemetry_interval_s > 0:
            self.telemetry_sampler = MetricsSampler(
                retention=int(
                    config.get("telemetry.retention", 4096) or 4096
                ),
                path=config.get("telemetry.path") or None,
            )
        self._telemetry_stop = threading.Event()
        self._telemetry_thread = None

        handler = _make_handler(self)
        self.httpd = _Server(("127.0.0.1", port), handler)
        self.port = self.httpd.server_address[1]
        self.uri = f"http://127.0.0.1:{self.port}"
        if self.lease is not None:
            # the serving URI exists only after the bind: peers reach
            # a claimed incarnation's clients through this lease field
            self.lease.uri = self.uri
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )

    def start(self) -> "CoordinatorServer":
        # journal recovery BEFORE the server accepts requests: a client
        # reconnecting mid-pagination must never observe the window
        # between serving and alias registration (its old statement id
        # would 404 instead of resolving to the resumed run)
        if self.journal is not None:
            self._recover_from_journal()
        # ingest-lane recovery rides the same before-serving seam (and
        # after catalog registration: WAL replay recreates tables
        # through the mounted connectors and restores the durable
        # materialized views)
        if self._ingest_cfg is not None and self.ingest is None:
            from presto_tpu_torch.server.ingest import IngestManager

            path, interval, lake_kw = self._ingest_cfg
            self.ingest = IngestManager(
                self.local, path, commit_interval_ms=interval, **lake_kw
            )
        # time-series sampler (telemetry.sample-interval-s > 0): a
        # daemon loop folding node scrapes into the metrics_history
        # ring. Started with the server, never before — an unstarted
        # coordinator must stay thread-free for in-process tests.
        if (
            self.telemetry_sampler is not None
            and self._telemetry_thread is None
        ):
            self._telemetry_thread = threading.Thread(
                target=self._telemetry_loop, daemon=True
            )
            self._telemetry_thread.start()
        # multi-coordinator lease: publish BEFORE serving (a peer must
        # never observe this incarnation's statements without a lease
        # to locate them through), then heartbeat + peer-watch loop
        if self.lease is not None and self._lease_thread is None:
            try:
                self.lease.renew(self._lease_state())
            except Exception:
                log.exception("initial lease publish failed")
            self._lease_thread = threading.Thread(
                target=self._lease_loop, daemon=True
            )
            self._lease_thread.start()
        self._serve_thread.start()
        return self

    def shutdown(self) -> None:
        self._shutting_down = True
        self._telemetry_stop.set()
        if self.autoscaler is not None:
            self.autoscaler.stop()
        if self.lease is not None:
            # clean shutdown WITHDRAWS the lease: peers see an absent
            # file, not an expiring one, and claim nothing
            self.lease.stop()
        if self.ingest is not None:
            # stop the commit loop and fold the pending tail (the WAL
            # has it either way: replay would re-admit it)
            self.ingest.close()
        # httpd.shutdown() handshakes with the serve_forever loop and
        # blocks forever if that loop never ran (server constructed but
        # not .start()ed, e.g. in-process submit()-only tests).
        if self._serve_thread.is_alive():
            self.httpd.shutdown()
        self.httpd.server_close()

    # ------------------------------------------- coordinator HA (journal)

    def _recover_from_journal(self) -> None:
        """Replay the admission journal: re-register the prepared
        registry, then re-admit every query that never reached a
        terminal state — under THIS boot's query ids (the per-boot qid
        nonce keeps the re-run's task-attempt ids collision-free
        against the dead incarnation's spooled pages), with the old id
        aliased so clients paginating across the bounce reconnect
        transparently. The replacement's submit frame is written (by
        ``submit``) BEFORE the old id's RESUMED close-out: a crash
        between the two can only duplicate a resume, never lose the
        query — at-least-once, the right failure for a query plane."""
        state = self.journal.replay()
        for name, text in state.prepared.items():
            with self._prepared_mu:
                self._prepared_sql[name] = text
                self._prepared_sql.move_to_end(name)
            try:
                from presto_tpu_torch.sql import parse_statement

                self.local._prepared[name] = parse_statement(text)
            except Exception:
                pass  # EXECUTE re-parses from the registry text
        resumed: Dict[str, str] = {}
        # recovery re-admission must not lose to the queued-queries
        # gate: every replayed query was ALREADY admitted by the dead
        # incarnation under the same cap (replay runs before serving,
        # so nothing external races the temporary headroom)
        prev_max = self._max_queued
        self._max_queued = prev_max + len(state.open)
        try:
            for rec in state.open:
                old_qid = rec.get("qid", "")
                q = self.submit(
                    rec.get("sql", ""),
                    user=rec.get("user") or "presto_tpu",
                    prepared=rec.get("prepared") or {},
                )
                if q.done.is_set() and q.state == "FAILED" and (
                    q.error or ""
                ).startswith("Query rejected"):
                    # re-admission lost after all (no submit frame was
                    # written): close the old id out HONESTLY so the
                    # journal never claims a resume that is not running
                    self.journal.record_finish(old_qid, "FAILED")
                    log.warning(
                        "journal recovery: re-admission of %s rejected",
                        old_qid,
                    )
                    continue
                self.journal.record_finish(
                    old_qid, "RESUMED", resumed_as=q.qid
                )
                resumed[old_qid] = q.qid
                with self._lock:
                    self._qid_alias[old_qid] = q.qid
                q.resumed_from = old_qid
                self.resumed_queries += 1
                REGISTRY.counter("coordinator.resumed_queries").update()
                REGISTRY.counter("pool.resumed_queries").update()
                log.info(
                    "journal recovery: resumed %s as %s", old_qid, q.qid
                )
        finally:
            self._max_queued = prev_max
        # transitive restart aliases: ids minted N bounces ago chain
        # through every intermediate resume (the journal collapses the
        # chain to its open tip; map that tip to THIS boot's run)
        with self._lock:
            for old, tip in state.aliases.items():
                if tip in resumed:
                    self._qid_alias[old] = resumed[tip]
        if state.open:
            log.info(
                "journal recovery: re-admitted %d quer%s",
                len(state.open),
                "y" if len(state.open) == 1 else "ies",
            )

    def lookup_query(self, qid: str) -> Optional[_Query]:
        """Query by id, following restart aliases (a nextUri minted by
        a dead coordinator incarnation resolves to the resumed run)."""
        q = self.queries.get(qid)
        if q is None:
            new = self._qid_alias.get(qid)
            if new:
                q = self.queries.get(new)
        return q

    # --------------------------------- multi-coordinator control plane

    def _lease_state(self) -> dict:
        """This coordinator's lease payload (server/lease.py): the
        shared-state channel peers fold into THEIR admission view —
        open statement ids (plus aliases, so any peer can redirect a
        sprayed client), admission occupancy, the local-pool memory
        report, per-resource-group usage, and QoS-lane counts."""
        with self._lock:
            open_q = [
                (qid, getattr(q, "resource_group", None))
                for qid, q in self.queries.items()
                if not q.done.is_set()
            ]
            aliases = list(self._qid_alias.keys())
            pending = self._pending
        groups: Dict[str, dict] = {}
        for qid, g in open_q:
            if not g:
                continue
            d = groups.setdefault(g, {"qids": [], "local_bytes": 0})
            d["qids"].append(qid)
            d["local_bytes"] += self.memory_pool.used_bytes(qid)
        state = {
            "uri": self.uri,
            "boot": self._boot,
            "qids": [qid for qid, _ in open_q] + aliases,
            "running": pending,
            "local": self.arbiter.local_report(),
            "groups": groups,
        }
        if self.qos is not None:
            state["lanes"] = self.qos.lane_occupancy()
        return state

    def _peer_memory_reports(self) -> Dict[str, dict]:
        """Live peers' LOCAL-pool reports for the arbiter's cluster
        view, keyed ``coord:<id>``. Worker bytes are NOT re-folded
        (workers heartbeat every coordinator directly); the blocked
        lane is cleared — kill/unblock decisions stay local-evidence
        only, a stale peer payload must never nominate victims here."""
        out: Dict[str, dict] = {}
        for pl in self.lease.peers(live_only=True):
            rep = (pl.state or {}).get("local")
            if not isinstance(rep, dict):
                continue
            rep = dict(rep)
            rep["ts"] = pl.ts
            rep["blocked"] = []
            out[f"coord:{pl.owner}"] = rep
        return out

    def peer_lane_occupancy(self) -> Dict[str, dict]:
        """Live peers' QoS-lane occupancy keyed by peer id — the
        ``system.runtime.qos`` cluster fold (server/qos.py)."""
        out: Dict[str, dict] = {}
        for pl in self.lease.peers(live_only=True):
            lanes = (pl.state or {}).get("lanes")
            if isinstance(lanes, dict):
                out[pl.owner] = lanes
        return out

    def locate_peer(self, qid: str) -> str:
        """URI of the live peer serving ``qid`` (its lease payload
        lists it as open or aliased), or "". The statement route uses
        this to redirect a sprayed/failed-over client that landed on
        the wrong coordinator."""
        if self.lease is None:
            return ""
        for pl in self.lease.peers(live_only=True):
            st = pl.state or {}
            if qid in (st.get("qids") or ()):
                return str(st.get("uri") or pl.uri)
        return ""

    def _lease_loop(self) -> None:
        """Heartbeat + peer watch, at TTL/3 cadence (two missed beats
        never expire a healthy owner): renew the lease with fresh
        shared state, announce this coordinator to every peer (they
        surface it in system.runtime.nodes), and claim + fail over any
        peer whose lease expired."""
        interval = max(self.lease.ttl_s / 3.0, 0.05)
        policy = rpc.RpcPolicy(timeout_s=2.0, retries=0)
        while not self._shutting_down:
            try:
                self.lease.renew(self._lease_state())
            except Exception:
                log.exception("lease renewal failed")
            for peer in self._peer_uris:
                if self._shutting_down:
                    break
                try:
                    rpc.call_json(
                        "PUT",
                        peer + "/v1/announcement",
                        {
                            "node_id": self.coord_id,
                            "uri": self.uri,
                            "state": "ACTIVE",
                            "role": "coordinator",
                        },
                        policy=policy,
                    )
                except Exception:
                    pass  # the lease file is the durable signal
            try:
                self._scan_expired_peers()
            except Exception:
                log.exception("peer lease scan failed")
            deadline = time.monotonic() + interval
            while (
                not self._shutting_down
                and time.monotonic() < deadline
            ):
                time.sleep(min(0.05, interval))

    def _scan_expired_peers(self) -> None:
        if self._shutting_down:
            return
        for pl in self.lease.peers(live_only=False):
            if not self.lease.is_expired(pl):
                continue
            claim = self.lease.claim_expired(pl.owner)
            if claim is None:
                continue  # still live, retired, or another claimant won
            self.failover_claims += 1
            REGISTRY.counter("coordinator.failover_claims").update()
            log.warning(
                "lease of %s expired (age %.1fs): claimed its journal "
                "at fencing epoch %d",
                pl.owner,
                pl.age(),
                claim.epoch,
            )
            self._failover_from(pl.owner, claim)

    def _failover_from(self, owner: str, claim) -> None:
        """Replay a dead peer's claimed journal: re-admit every
        non-terminal query under THIS boot's qids, close the old ids
        out as RESUMED (with ``resumed_as``) in the DEAD journal, and
        alias them locally + in OUR journal so the dead incarnation's
        statement URIs resolve here — for clients landing directly
        (reconnect spray) and via any peer's alias redirect. Every
        write into claimed state is fence-checked: a superseded
        claimant abandons the failover instead of double-resuming."""
        from presto_tpu_torch.server.lease import FencedError

        dead_dir = os.path.join(self._control_dir, owner)
        if not os.path.isdir(dead_dir):
            # peer never journaled (no queries): nothing to replay
            self.lease.retire(owner)
            return
        try:
            self.lease.check_fence(claim)
            dead = CoordinatorJournal(dead_dir)
            # stamp the claim INTO the claimed journal first: a
            # replayer (including the dead owner restarting) sees who
            # took the queries and at what epoch
            dead.record_claim(self.coord_id, claim.epoch)
            state = dead.replay()
        except FencedError:
            log.warning(
                "failover from %s abandoned: claim superseded", owner
            )
            return
        resumed: Dict[str, str] = {}
        # same temporary-headroom rule as _recover_from_journal: the
        # dead peer already admitted these under its own queue cap
        prev_max = self._max_queued
        self._max_queued = prev_max + len(state.open)
        try:
            for rec in state.open:
                old_qid = rec.get("qid", "")
                try:
                    self.lease.check_fence(claim)
                except FencedError:
                    log.warning(
                        "failover from %s fenced mid-replay "
                        "(resumed %d of %d)",
                        owner,
                        len(resumed),
                        len(state.open),
                    )
                    return
                q = self.submit(
                    rec.get("sql", ""),
                    user=rec.get("user") or "presto_tpu",
                    prepared=rec.get("prepared") or {},
                )
                if q.done.is_set() and q.state == "FAILED" and (
                    q.error or ""
                ).startswith("Query rejected"):
                    dead.record_finish(old_qid, "FAILED")
                    log.warning(
                        "failover: re-admission of %s rejected", old_qid
                    )
                    continue
                # our submit frame is on disk before the dead id's
                # RESUMED close-out — a crash between the two can only
                # duplicate a resume, never lose the query
                dead.record_finish(
                    old_qid, "RESUMED", resumed_as=q.qid
                )
                if self.journal is not None:
                    self.journal.record_alias(old_qid, q.qid)
                resumed[old_qid] = q.qid
                with self._lock:
                    self._qid_alias[old_qid] = q.qid
                q.resumed_from = old_qid
                self.failover_resumed += 1
                self.resumed_queries += 1
                REGISTRY.counter("coordinator.failover_resumed").update()
                REGISTRY.counter("coordinator.resumed_queries").update()
                log.info(
                    "failover: resumed %s (from %s) as %s",
                    old_qid,
                    owner,
                    q.qid,
                )
        finally:
            self._max_queued = prev_max
        # transitive aliases: ids the DEAD peer was itself serving by
        # alias chain land on this boot's runs too (journal writes
        # happen OUTSIDE the discovery lock)
        trans = [
            (old, resumed[tip])
            for old, tip in state.aliases.items()
            if tip in resumed
        ]
        with self._lock:
            for old, new in trans:
                self._qid_alias[old] = new
        if self.journal is not None:
            for old, new in trans:
                self.journal.record_alias(old, new)
        # adopt the dead peer's prepared registry (names a sprayed
        # client may EXECUTE against any coordinator)
        adopted = []
        for name, text in state.prepared.items():
            with self._prepared_mu:
                if name in self._prepared_sql:
                    continue
                self._prepared_sql[name] = text
                self._prepared_sql.move_to_end(name)
            adopted.append((name, text))
        if self.journal is not None:
            for name, text in adopted:
                self.journal.record_prepare(name, text)
        # fully failed over: drop the lease + claim files so restarts
        # of the dead owner rejoin fresh instead of re-claiming
        self.lease.retire(owner)
        if state.open:
            log.info(
                "failover from %s complete: resumed %d quer%s",
                owner,
                len(resumed),
                "y" if len(resumed) == 1 else "ies",
            )

    def _fault_kill(self) -> None:
        """Abrupt crash for the fault plane's ``kill_coordinator``
        action: drop the journal handle (no FAILED close-out may reach
        disk — the open frames are what a survivor resumes), leave the
        lease to EXPIRE (survivors must take the TTL path, exactly
        like a real crash), and close the socket so clients see a dead
        peer, not a clean error."""
        self._shutting_down = True
        self.journal = None
        try:
            if self._serve_thread.is_alive():
                self.httpd.shutdown()
            self.httpd.server_close()
        except Exception:
            pass
        log.warning(
            "node=%s fault plane killed this coordinator", self.coord_id
        )

    # ------------------------------------------------ elastic worker pool

    def attach_pool(self, provider, **overrides) -> "object":
        """Wire a WorkerPoolProvider and start the autoscaler
        (``pool.min/max-workers`` bounds, ``pool.scale-interval-s``
        cadence; see server.pool). Keyword overrides replace the
        config-derived knobs — the test/bench hook."""
        from presto_tpu_torch.server.pool import Autoscaler

        if self.autoscaler is not None:
            self.autoscaler.stop()
        cfg = dict(self._pool_cfg)
        cfg.update(overrides)
        self.autoscaler = Autoscaler(self, provider, **cfg).start()
        return self.autoscaler

    def load_snapshot(self) -> dict:
        """The autoscaler's control signals, read off the existing
        stats plane: admission queue depth, running-query count, and
        stage backlog (QUEUED/RUNNING tasks of live queries)."""
        with self._lock:
            qs = list(self.queries.values())
        queued = running = backlog = 0
        seen: set = set()
        for q in qs:
            if id(q) in seen:  # restart aliases map to one query
                continue
            seen.add(id(q))
            if q.done.is_set():
                continue
            if q.state == "QUEUED":
                queued += 1
            elif q.state == "RUNNING":
                running += 1
            with q._stats_lock:
                for st in q.stats.stages:
                    for t in st.tasks:
                        if t.state in ("QUEUED", "RUNNING"):
                            backlog += 1
        return {"queued": queued, "running": running, "backlog": backlog}

    def pool_state(self, w: _WorkerNode) -> str:
        """Pool lifecycle state of one node for system.runtime.nodes:
        DRAINING (scale-down/preemption in flight), SCALING_UP (spawned
        by the autoscaler, not yet announced-and-acknowledged), else
        STABLE."""
        if w.state == "DRAINING":
            return "DRAINING"
        if w.node_id in self._pool_scaling:
            return "SCALING_UP"
        return "STABLE"

    def _kill_largest_query(self, holders, requester):
        """ClusterMemoryManager policy: on pool exhaustion, abort the
        largest memory holder that is a *running query* (never the
        shared table cache, never the requester) and free its
        reservation so the requester can proceed."""
        candidates = {
            qid: b
            for qid, b in holders.items()
            if qid != requester
            and qid in self.queries
            and not self.queries[qid].done.is_set()
        }
        if not candidates:
            return None
        victim = max(candidates, key=candidates.get)
        vq = self.queries[victim]
        vq.fail(
            "Query killed by the cluster memory manager: largest "
            f"holder ({candidates[victim]}B) when the pool was exhausted"
        )
        vq.done.set()
        # cooperative cancel: the victim's thread fails at its next
        # reservation instead of silently recomputing to completion
        self.memory_pool.mark_dead(victim)
        REGISTRY.counter("coordinator.queries_killed_oom").update()
        return victim

    # -------------------------------------- cluster memory manager (kills)

    def _apply_memory_kill(
        self, victim: str, policy: str, reason: str
    ) -> None:
        """Apply one arbiter kill decision: journal it, cancel the
        victim cluster-wide through the workers' task-DELETE path with
        a MEMORY_PRESSURE error naming victim and policy, and — under
        ``retry_policy=QUERY`` with restart budget left — leave the
        query alive for its own execution thread to re-admit once
        pressure subsides."""
        q = self.queries.get(victim)
        if q is None or q.done.is_set():
            self.arbiter.forget_query(victim)
            return
        cur, _peak = self.arbiter.query_bytes(victim)
        cur += self.memory_pool.used_bytes(victim)
        msg = (
            f"Query {victim} killed by the cluster memory manager: "
            f"MEMORY_PRESSURE (victim {victim}, policy {policy}): "
            f"{reason}"
        )
        readmit = (
            self._retry_policy() == "QUERY"
            and int(self.local.session.get("query_retry_count")) > 0
        )
        log.warning(
            "memory kill: %s (readmit=%s)", msg, readmit
        )
        if self.journal is not None:
            self.journal.record_kill(victim, policy, reason, cur)
        self.arbiter.record_kill(victim, policy, reason, cur)
        # the flag gates task-retry/speculation/local-fallback in both
        # modes: a killed attempt's DELETEd tasks look like lost
        # workers, and resurrecting them would re-consume the memory
        # the kill just freed
        q._mem_kill = msg
        if readmit:
            # in-thread re-admission: _run_sql_with_restart waits out
            # the pressure and re-runs within query_retry_count
            self.memory_pool.cancel_blocked(victim)
        else:
            q.fail(msg)
            q.done.set()
            # cooperative cancel, exactly like the local kill-largest
            # policy: the victim cannot grow, its thread fails at the
            # next reservation
            self.memory_pool.mark_dead(victim)
            self.memory_pool.cancel_blocked(victim)
        self._cancel_query_on_workers(victim)

    def _cancel_query_on_workers(self, qid: str) -> None:
        """Tear the victim's tasks down on every discovered worker
        (each worker routes the abort through its task-DELETE path and
        fails the victim's blocked reservations). Best-effort and
        off-thread: a hung worker must not stall the kill."""

        def run():
            policy = rpc.RpcPolicy(timeout_s=5.0, retries=0)
            for w in self._ttl_workers():
                try:
                    rpc.call_json(
                        "PUT",
                        w.uri + "/v1/memory/abort",
                        {"query_id": qid},
                        policy=policy,
                    )
                except Exception:
                    pass

        threading.Thread(target=run, daemon=True).start()

    def _await_memory_calm(self, q: _Query) -> None:
        """Hold a killed-but-re-admittable victim until cluster
        pressure subsides (below low-water, nothing blocked), bounded
        by the query's own run-time limit."""
        deadline = time.monotonic() + float(
            self.local.session.get("query_max_run_time_s")
        )
        while (
            not q.done.is_set()
            and not self._shutting_down
            and time.monotonic() < deadline
        ):
            if self.arbiter.pressure_subsided():
                return
            time.sleep(0.05)

    def _fold_memory_stats(self, q: _Query) -> None:
        """Roll the query's cluster-wide memory view (coordinator pool
        + worker-reported bytes) into its stats — the QueryInfo /
        EXPLAIN ANALYZE "memory:" numbers."""
        cur, peak = self.arbiter.query_bytes(q.qid)
        cur += self.memory_pool.used_bytes(q.qid)
        peak += self.memory_pool.peak_bytes(q.qid)
        q.stats.current_memory_bytes = cur
        if peak > q.stats.peak_memory_bytes:
            q.stats.peak_memory_bytes = peak

    # ---------------------------------------------------------- discovery

    def announce(
        self,
        node_id: str,
        uri: str,
        state: str = "ACTIVE",
        preemptible: bool = False,
        memory: Optional[dict] = None,
        slice_id: str = "",
        device_coords=(),
        backend_diag: Optional[dict] = None,
        role: str = "",
    ) -> None:
        # peer coordinators announce like workers (role=coordinator on
        # the discovery body): visible in system.runtime.nodes, but
        # NEVER schedulable — _ttl_workers filters them out
        is_coord = role == "coordinator"
        with self._lock:
            # a node lost to a failed query attempt is schedulable again
            # once it announces itself
            self._lost_nodes.discard(node_id)
            w = self.workers.get(node_id)
            if w is None:
                self.workers[node_id] = _WorkerNode(
                    node_id=node_id, uri=uri, last_seen=time.time(),
                    state=state, preemptible=bool(preemptible),
                    slice_id=str(slice_id or ""),
                    device_coords=tuple(device_coords or ()),
                    backend_diag=dict(backend_diag or {}),
                    coordinator=is_coord,
                )
            else:
                w.last_seen = time.time()
                w.uri = uri
                w.state = state
                w.preemptible = bool(preemptible)
                w.slice_id = str(slice_id or "")
                w.device_coords = tuple(device_coords or ())
                w.coordinator = is_coord
                if backend_diag:
                    w.backend_diag = dict(backend_diag)
        # fold the heartbeat's memory report into the cluster view —
        # OUTSIDE the discovery lock (enforcement may scan queries)
        if memory is not None:
            self.arbiter.observe(node_id, memory)

    def _ttl_workers(self) -> List[_WorkerNode]:
        """Workers announced within the discovery TTL (no breaker
        filtering — callers that must not consume half-open probe
        slots use this directly). Peer coordinators announce through
        the same channel but are NOT workers: nothing schedules on
        them, probes them, or expects task routes there."""
        now = time.time()
        with self._lock:
            return [
                w
                for w in self.workers.values()
                if now - w.last_seen <= NODE_TTL_S
                and not w.coordinator
            ]

    def active_workers(self, exclude=()) -> List[_WorkerNode]:
        """Schedulable workers: announced within the discovery TTL,
        not DRAINING (the drain protocol — a draining worker finishes
        what it has but accepts nothing new), AND not circuit-open (an
        OPEN breaker excludes the worker; after its cool-off,
        ``allow()`` admits one half-open probe here). ``exclude``
        filters BEFORE the breaker check, so asking for a spare never
        consumes an excluded worker's probe slot."""
        with self._lock:
            lost = set(self._lost_nodes)
        return [
            w
            for w in self._ttl_workers()
            if w.state == "ACTIVE"
            and w.node_id not in exclude
            and w.node_id not in lost
            and self._breaker(w.node_id).allow()
        ]

    def _mark_lost(self, since: float) -> List[str]:
        """Take the nodes that failed at a connection level since
        ``since`` (a monotonic time) out of scheduling until each one
        announces itself again: the nodes whose failure failed a query
        attempt. Returns their ids."""
        with self._lock:
            lost = sorted(
                n for n, t in self._failed_at.items() if t >= since
            )
            self._lost_nodes.update(lost)
        for n in lost:
            log.warning(
                "node %s failed a query attempt: excluded until it "
                "announces itself again", n,
            )
        return lost

    # ------------------------------------------------- worker health

    def _breaker(self, node_id: str) -> "rpc.CircuitBreaker":
        with self._lock:
            b = self.breakers.get(node_id)
            if b is None:
                b = rpc.CircuitBreaker(
                    threshold=self._breaker_threshold,
                    open_s=self._breaker_open_s,
                )
                self.breakers[node_id] = b
            return b

    def _worker_ok(self, w) -> None:
        if self._breaker(w.node_id).record_success():
            REGISTRY.counter("coordinator.circuit_closed").update()
            log.info("circuit CLOSED for worker %s", w.node_id)

    def _worker_failed(self, w) -> None:
        REGISTRY.counter("coordinator.worker_failures").update()
        with self._lock:
            self._failed_at[w.node_id] = time.monotonic()
        if self._breaker(w.node_id).record_failure():
            REGISTRY.counter("coordinator.circuit_opened").update()
            log.warning("circuit OPEN for worker %s", w.node_id)

    def _any_worker_alive(self) -> bool:
        """Directly probe every TTL-fresh worker (``GET /v1/status``,
        short timeout, no retries): the graceful-degradation gate must
        distinguish 'the cluster is down' from 'one task hit a dead
        socket before its breaker opened'. Iterates _ttl_workers, not
        active_workers: a liveness sweep must not consume half-open
        probe slots it may never resolve — each worker probed here
        gets a real verdict recorded instead."""
        probe = rpc.RpcPolicy(timeout_s=2.0, retries=0)
        for w in self._ttl_workers():
            if w.state != "ACTIVE":
                # a DRAINING worker answers /v1/status but accepts no
                # work: it must not veto coordinator-local fallback
                continue
            try:
                rpc.call_json(
                    "GET", w.uri + "/v1/status", policy=probe
                )
                # the probe IS the verdict: a half-open slot consumed
                # by active_workers() above must resolve, or the
                # breaker stays wedged in HALF_OPEN
                self._worker_ok(w)
                return True
            except Exception:
                self._worker_failed(w)
        return False

    # ------------------------------------------- fault-tolerant execution

    def _retry_policy(self) -> str:
        """Session ``retry_policy``, normalized (NONE | TASK | QUERY)."""
        return str(self.local.session.get("retry_policy")).upper()

    def _spooling(self) -> bool:
        """Should task specs carry the spool flag? TASK/QUERY policy
        with a configured shared spool directory; NONE never spools
        (bit-for-bit legacy behavior)."""
        return self.spool is not None and self._retry_policy() in (
            "TASK",
            "QUERY",
        )


    def _select_transport(self, workers, schemas) -> str:
        """Stage transport decision, delegated to the scheduler: the
        per-EDGE dominant-slice rule when single-program collective
        stages are on (the default), the legacy all-or-nothing
        per-stage rule otherwise."""
        enabled = bool(self.local.session.get("exchange_ici_enabled"))
        if bool(self.local.session.get("exchange_single_program")):
            return select_exchange_edges(
                workers, enabled, schemas=schemas
            )
        return select_exchange_transport(
            workers, enabled, schemas=schemas
        )

    def _retry_spec(
        self, q: Optional[_Query], prior: FragmentSpec, **overrides
    ) -> FragmentSpec:
        """Replacement attempt of a logical task: the SAME logical id
        with attempt+1 (server.task_ids), so spool attempt-dedup and
        the per-stage attempt counters line up, registered to the same
        stage as the prior attempt."""
        spec = dataclasses.replace(
            prior,
            task_id=task_ids.next_attempt(prior.task_id),
            **overrides,
        )
        if q is not None:
            with q._stats_lock:
                st = q._task_stage.get(prior.task_id)
                if st is not None:
                    q._task_stage[spec.task_id] = st
        return spec

    def _record_recovery(self, q: Optional[_Query]) -> None:
        REGISTRY.counter("coordinator.tasks_retried").update()
        if q is not None:
            with q._stats_lock:
                q.stats.task_recoveries += 1

    def _take_retry(self, q: _Query) -> bool:
        """Consume one unit of the query's task-retry budget (the
        generalization of the old retry-once: bounded per QUERY, not
        per range)."""
        # a memory-pressure-killed query must not resurrect through
        # task-level recovery: its DELETEd tasks look like lost
        # workers, but re-running them would re-consume the memory the
        # kill just freed
        if getattr(q, "_mem_kill", None) is not None:
            return False
        with q._stats_lock:
            if q._retry_budget is None:
                q._retry_budget = int(
                    self.local.session.get("task_retry_budget")
                )
            if q._retry_budget <= 0:
                return False
            q._retry_budget -= 1
            return True

    def nodes(self) -> List[_WorkerNode]:
        """All nodes incl. self, for system.runtime.nodes."""
        from presto_tpu_torch.utils.devicediag import last_diag_dict

        me = _WorkerNode(
            node_id="coordinator",
            uri=self.uri,
            last_seen=time.time(),
            coordinator=True,
            backend_diag=last_diag_dict(),
        )
        now = time.time()
        with self._lock:
            others = [
                dataclasses.replace(
                    w,
                    state=(
                        w.state
                        if now - w.last_seen <= NODE_TTL_S
                        else "GONE"
                    ),
                )
                for w in self.workers.values()
            ]
        return [me] + others

    # ------------------------------------------------------------ queries

    def _group_memory(self, group_name: str) -> int:
        """Bytes reserved by running queries of one resource group (the
        manager's softMemoryLimit eligibility hook): coordinator-local
        reservations PLUS the worker-reported bytes the arbiter folds
        from heartbeats — a distributed memory hog trips its group
        quota even when every byte lives worker-side (the historical
        under-accounting counted only coordinator-local bytes)."""
        with self._lock:
            # live queries only: finished queries hold no reservations
            qids = [
                q.qid
                for q in self.queries.values()
                if not q.done.is_set()
                and getattr(q, "resource_group", None) == group_name
            ]
        local = sum(self.memory_pool.used_bytes(qid) for qid in qids)
        # multi-coordinator shared quotas: fold live peers' published
        # per-group usage (their coordinator-local bytes directly;
        # their qids through the arbiter, which holds every worker's
        # heartbeat once) so one group's softMemoryLimit holds across
        # N admitters
        if self.lease is not None:
            for pl in self.lease.peers(live_only=True):
                g = ((pl.state or {}).get("groups") or {}).get(
                    group_name
                )
                if not isinstance(g, dict):
                    continue
                qids.extend(g.get("qids") or [])
                try:
                    local += int(g.get("local_bytes") or 0)
                except (TypeError, ValueError):
                    pass
        return local + self.arbiter.queries_bytes(qids)

    def submit(
        self,
        sql: str,
        user: str = "presto_tpu",
        prepared: Optional[Dict[str, str]] = None,
    ) -> _Query:
        # "q_c" namespace: distributed queries join the runner's
        # QueryHistory (adopt), whose own ids are "q_N" — the two
        # counters are independent and must not collide there. The
        # boot nonce keeps ids (and the task-attempt ids minted from
        # them) unique across coordinator restarts sharing one spool
        q = _Query(f"q_c{next(self._qid)}_{self._boot}", sql)
        q.user = user
        q.prepared = dict(prepared or {})
        q.resource_group = None
        # snapshot the journal handle: a fault-plane kill racing this
        # submit nulls self.journal (no close-out may reach disk), but
        # a statement already past the handler's shutdown gate must
        # still land its submit frame — an ACKed query with no frame
        # would be unresumable by any survivor
        j = self.journal
        with self._lock:
            self.queries[q.qid] = q
            # bounded retention (reference: query.max-history): evict
            # the oldest COMPLETED queries — their stats/spans/result
            # rows must not accumulate on a long-running coordinator.
            # Un-drained queries (client still paginating) get a grace
            # window before they too age out (abandoned clients must
            # not pin memory forever).
            now = time.time()
            done = [
                qid
                for qid, old in self.queries.items()
                if old.done.is_set()
                and (
                    old._drained
                    or now - (old.stats.end_time or now) > DRAIN_GRACE_S
                )
            ]
            for qid in done[: max(0, len(done) - MAX_QUERY_HISTORY)]:
                del self.queries[qid]
            if self._qid_alias:
                # restart aliases die with their resumed target
                self._qid_alias = {
                    a: t
                    for a, t in self._qid_alias.items()
                    if t in self.queries
                }
            if self._pending >= self._max_queued:
                q.fail(
                    "Query rejected: too many queued queries "
                    f"(max {self._max_queued})"
                )
                REGISTRY.counter("coordinator.queries_rejected").update()
                q.done.set()
                return q
            self._pending += 1
        if self.resource_groups is None:
            # journal BEFORE the execution thread can start: finish
            # must never precede submit on disk
            if j is not None:
                j.record_submit(q.qid, sql, user, q.prepared, None)
            threading.Thread(
                target=self._execute_query, args=(q,), daemon=True
            ).start()
            return q

        def start(_q=q):
            threading.Thread(
                target=self._execute_query, args=(_q,), daemon=True
            ).start()

        # group assignment is deterministic: record it before the
        # thread can race to the finish hook
        q.resource_group = self.resource_groups.group_of(user).name
        if j is not None:
            # before resource_groups.submit — a run-now admission
            # starts the thread synchronously inside it
            j.record_submit(
                q.qid, sql, user, q.prepared, q.resource_group
            )
        state, info = self.resource_groups.submit(user, start)
        if state == "rejected":
            with self._lock:
                self._pending -= 1
            q.fail(info)
            REGISTRY.counter("coordinator.queries_rejected").update()
            q.done.set()
            if j is not None:
                j.record_finish(q.qid, "FAILED")
            return q
        q.resource_group = info
        return q

    def _execute_query(self, q: _Query) -> None:
        # admission gate: the QoS plane's priority lanes when enabled
        # (strict-priority dequeue, weighted-fair within a lane,
        # preempt-and-resume of lower-priority running work), else the
        # legacy bounded semaphore — qos.enabled=false is bit-exact
        # legacy admission
        if self.qos is not None:
            admitted = self.qos.qos_admit(q)
            try:
                if not admitted and not q.done.is_set():
                    # shutdown while lane-queued: never execute — fail
                    # the query so _admitted_execute's queued-death
                    # branch closes it out (pending count, group slot,
                    # journal finish)
                    q.fail(
                        "Query rejected: coordinator shut down before "
                        "admission"
                    )
                    q.done.set()
                self._admitted_execute(q)
            finally:
                self.qos.qos_release(q)
        else:
            with self._admit:
                self._admitted_execute(q)

    def _qos_checkpoint(self, q: Optional[_Query]) -> None:
        """Cooperative QoS suspension point (server/qos.py): a
        suspended query's stage threads park here between ranges.
        No-op when the plane is off."""
        if self.qos is not None and q is not None:
            self.qos.qos_checkpoint(q)

    def _admitted_execute(self, q: _Query) -> None:
        # admission high-water (cluster memory governance): while
        # the cluster's query-attributed usage is over
        # memory.admission-high-water, QUEUED queries are HELD —
        # never failed — and release on the low-water hysteresis
        while (
            not q.done.is_set()
            and not self._shutting_down
            and self.arbiter.admission_held()
        ):
            q._admission_parked = True
            time.sleep(0.05)
        if q.done.is_set():  # killed while queued (memory manager)
            with self._lock:
                self._pending -= 1
            if (
                self.resource_groups is not None
                and getattr(q, "resource_group", None) is not None
            ):
                self.resource_groups.finish(q.resource_group)
            if self.journal is not None:
                self.journal.record_finish(q.qid, q.state)
            return
        # chaos hook (utils/faults.py kill_coordinator): fires at the
        # admitted-but-not-yet-RUNNING seam — the journal holds the
        # submit frame with no close-out, exactly the state a real
        # crash strands. The "dead" coordinator returns silently: no
        # FAILED transition, no journal write, no client answer — a
        # surviving peer claims and resumes the query
        try:
            faults.maybe_inject_coordinator(
                self.coord_id, q.qid, kill=self._fault_kill
            )
        except faults.FaultInjectedError:
            return
        q.state = "RUNNING"
        q.stats.state = "RUNNING"
        log.info(
            "trace=%s query=%s state=RUNNING", q.trace.trace_id, q.qid
        )
        # the stats sink (query id = q.qid) owns this thread's pool
        # reservations (one id space for holders, kills, and clients)
        # and makes coordinator-local staging (gather splices, local
        # fallback) pin the cache entries it executes over — released
        # in the finally below
        self.local._qs_local.value = q.stats
        try:
            with REGISTRY.timer("coordinator.query_time").time():
                with q.trace.span("query", query_id=q.qid):
                    self._run_sql_with_restart(q)
            if not q.done.is_set():  # a killed query stays FAILED
                q.state = "FINISHED"
        except Exception as e:
            if not q.done.is_set():
                q.state = "FAILED"
                q.error = (
                    f"{type(e).__name__}: {e}\n"
                    f"{traceback.format_exc()[-1000:]}"
                )
            REGISTRY.counter("coordinator.queries_failed").update()
        finally:
            self._finish_query_stats(q)
            self.local._qs_local.value = None
            self.local.release_pins(q.stats)
            self.memory_pool.release(q.qid)
            with self._lock:
                self._pending -= 1
            if self.journal is not None:
                # terminal close-out BEFORE done is observable: a
                # restart must never re-admit a query whose client
                # already saw the outcome
                self.journal.record_finish(q.qid, q.state)
            q.done.set()
            if (
                self.resource_groups is not None
                and getattr(q, "resource_group", None) is not None
            ):
                # frees the group slot and admits the next queued
                # query by weighted fairness
                self.resource_groups.finish(q.resource_group)


    def _run_sql_with_restart(self, q: _Query) -> None:
        """``retry_policy=QUERY``: a bounded full-query restart is the
        LAST resort when task-level recovery could not save the query
        (reference: Tardigrade's QUERY retry policy). Only failures
        that mean "the cluster changed under us" (connection-level, a
        draining/lost worker, no live workers) are restartable —
        execution errors would fail again identically."""
        budget = (
            int(self.local.session.get("query_retry_count"))
            if self._retry_policy() == "QUERY"
            else 0
        )
        attempt = 0
        while True:
            attempt_t0 = time.monotonic()
            try:
                if attempt == 0:
                    return self._run_sql(q)
                with q.trace.span(
                    "recovery", phase="query-restart", attempt=attempt
                ):
                    return self._run_sql(q)
            except Exception as e:
                mem_kill = getattr(q, "_mem_kill", None)
                restartable = rpc.is_task_recoverable(e) or isinstance(
                    e, NoLiveWorkers
                )
                if mem_kill is not None:
                    # cluster memory manager kill: re-admit the victim
                    # after pressure subsides — within the SAME bounded
                    # query_retry_count budget as connection restarts
                    if attempt >= budget or q.done.is_set():
                        raise MemoryPressureKilled(mem_kill) from e
                    attempt += 1
                    REGISTRY.counter(
                        "memory.victims_readmitted"
                    ).update()
                    log.warning(
                        "query=%s re-admitting memory-pressure victim "
                        "(attempt %d/%d)", q.qid, attempt, budget,
                    )
                    # surrender this attempt's residency before the
                    # wait: the victim must not hold bytes while the
                    # cluster drains
                    self.local.release_pins(q.stats)
                    self.memory_pool.release(q.qid)
                    self._await_memory_calm(q)
                    q._mem_kill = None
                    self.arbiter.forget_query(q.qid)
                elif (
                    attempt >= budget
                    or not restartable
                    or q.done.is_set()
                ):
                    raise
                else:
                    attempt += 1
                    REGISTRY.counter(
                        "coordinator.query_restarts"
                    ).update()
                    # the restart schedules on no node whose failure
                    # failed this attempt: its breaker may be half-open
                    # again by now (the attempt ends only when its
                    # claimed ranges do), and a half-open probe would
                    # hand the restart's work to a dead node
                    lost = self._mark_lost(attempt_t0)
                    log.warning(
                        "query=%s restarting (attempt %d/%d) after "
                        "%s: %s (excluding %s)",
                        q.qid, attempt, budget, type(e).__name__, e,
                        lost,
                    )
                # close out the failed attempt's partial state: stages
                # left RUNNING become ABORTED, partial results dropped
                with q._stats_lock:
                    q.stats.query_restarts = attempt
                    for st in q.stats.stages:
                        if st.state == "RUNNING":
                            st.state = "ABORTED"
                        for t in st.tasks:
                            if t.state in ("QUEUED", "RUNNING"):
                                t.state = "FAILED"
                    # drop the failed attempt's coordinator-local
                    # operator folds: the retry re-executes the same
                    # local programs, and keeping both would teach the
                    # history store doubled cardinalities
                    q.stats.operators = []
                    q.stats.__dict__.pop("_op_index", None)
                    q.stats.__dict__.pop("_op_pins", None)
                q.columns, q.rows = [], []

    def _run_sql(self, q: _Query) -> None:
        from presto_tpu_torch.sql import ast, parse_statement

        stmt = parse_statement(q.sql)
        if isinstance(stmt, (ast.Prepare, ast.Execute, ast.Deallocate)):
            return self._run_prepared_stmt(q, stmt)
        workers = self.active_workers()
        if (
            isinstance(stmt, ast.Explain)
            and stmt.analyze
            and isinstance(stmt.statement, ast.Select)
            and workers
        ):
            # distributed EXPLAIN ANALYZE: run the inner SELECT through
            # the real scheduler, then render the plan with the
            # per-stage/per-task rollup and the span tree
            from presto_tpu_torch.exec.explain import render_distributed_analyze

            res = self._run_select(q, stmt.statement, workers)
            q.stats.output_rows = int(res.page.num_valid)
            q._output_rows_final = True
            self._fold_memory_stats(q)
            q.stats.roll_up()
            # provisionally close the root span for the rendering (the
            # context manager records the real end on exit), so the
            # printed tree doesn't show the query span as open
            if q.trace.root is not None and not q.trace.root.end:
                q.trace.root.end = time.time()
            text = render_distributed_analyze(
                q._plan_root, q.stats, q.trace, int(res.page.num_valid),
                runner=self.local,
            )
            q.columns = [{"name": "Query Plan"}]
            q.rows = [[line] for line in text.split("\n")]
            return
        if not isinstance(stmt, ast.Select) or not workers:
            if isinstance(stmt, ast.Select):
                # the micro-batch lane and the result cache (coordinator-
                # local dispatch); None = both off: the path below
                with q.trace.span("execute-local"):
                    res = self._microbatch_local_select(
                        q, stmt, adopt=True
                    )
                if res is not None:
                    self._store_result(q, res)
                    return
            # non-SELECT (SET SESSION / SHOW / EXPLAIN) or empty cluster:
            # run on the coordinator's local engine
            with q.trace.span("execute-local"):
                res = self.local.execute(q.sql)
            self._store_result(q, res)
            return
        res = None
        if bool(self.local.session.get("enable_result_cache")):
            # tier a in front of distributed dispatch (the EXPLAIN
            # ANALYZE branch above bypasses it: an analyze executes)
            res = self._result_cache_lookup(q, stmt, adopt=True)
            if res is None:
                res = self._run_select(q, stmt, workers)
                self._result_cache_store(q, q._rc_plan, res)
        else:
            res = self._run_select(q, stmt, workers)
        self._store_result(q, res)

    #: coordinator-global prepared registry bound (names cycle on a
    #: serving fleet; the client-header path carries its own map)
    MAX_PREPARED = 256

    def _run_prepared_stmt(self, q: _Query, stmt) -> None:
        """PREPARE / EXECUTE / DEALLOCATE over HTTP (server.protocol
        prepared-statement headers). PREPARE registers the statement
        TEXT (response header ``X-Presto-Added-Prepare`` hands it to
        the client, which replays it per request); EXECUTE parses the
        registered text through a bounded AST cache, binds the
        arguments, and runs the bound statement through the normal
        distributed/local path — whose plan cache makes a warm EXECUTE
        zero-planning, zero-compilation."""
        from presto_tpu_torch.exec.local_runner import (
            _bind_param_markers,
            _count_param_markers,
        )
        from presto_tpu_torch.sql import ast

        if isinstance(stmt, ast.Prepare):
            text = _prepare_text(q.sql, stmt.name)
            with self._prepared_mu:
                self._prepared_sql[stmt.name] = text
                self._prepared_sql.move_to_end(stmt.name)
                while len(self._prepared_sql) > self.MAX_PREPARED:
                    evicted, _ = self._prepared_sql.popitem(last=False)
                    # keep the runner-side mirror bounded too: an
                    # LRU-evicted name must not pin its parsed AST
                    self.local._prepared.pop(evicted, None)
            # the embedded runner serves the non-distributed EXECUTE
            # path: keep its per-runner registry in step
            self.local._prepared[stmt.name] = stmt.statement
            if self.journal is not None:
                # the coordinator-GLOBAL registry is coordinator state
                # and survives a bounce (client-header-owned maps are
                # the client's to replay)
                self.journal.record_prepare(stmt.name, text)
            q.added_prepare = (stmt.name, text)
            q.columns = [{"name": "result"}]
            q.rows = [["PREPARE"]]
            return
        if isinstance(stmt, ast.Deallocate):
            with self._prepared_mu:
                self._prepared_sql.pop(stmt.name, None)
            self.local._prepared.pop(stmt.name, None)
            if self.journal is not None:
                self.journal.record_deallocate(stmt.name)
            q.deallocated_prepare = stmt.name
            q.columns = [{"name": "result"}]
            q.rows = [["DEALLOCATE"]]
            return
        # EXECUTE: client-supplied statements take precedence (the
        # client owns its session's prepared map)
        text = q.prepared.get(stmt.name)
        if text is None:
            with self._prepared_mu:
                text = self._prepared_sql.get(stmt.name)
        if text is None:
            raise RuntimeError(
                f"prepared statement {stmt.name!r} not found"
            )
        inner = self._parse_prepared(text)
        n_markers = _count_param_markers(inner)
        if n_markers != len(stmt.params):
            raise RuntimeError(
                f"EXECUTE {stmt.name}: statement has {n_markers} "
                f"parameter(s), {len(stmt.params)} given"
            )
        from presto_tpu_torch.sql import ast as A

        bound = _bind_param_markers(inner, stmt.params)
        workers = self.active_workers()
        if isinstance(bound, A.Select) and workers:
            res = None
            if bool(self.local.session.get("enable_result_cache")):
                res = self._result_cache_lookup(q, bound, adopt=True)
            if res is None:
                res = self._run_select(q, bound, workers)
                self._result_cache_store(q, q._rc_plan, res)
        else:
            # plan_cached marks q.stats.plan_cache_hit through the
            # thread-local stats sink _execute_query installed
            with q.trace.span("execute-local"):
                res = None
                if isinstance(bound, A.Select):
                    # micro-batch lane: concurrent EXECUTEs of one shape
                    # share one batched pass (None when the lane and the
                    # result cache are off: the scalar path below)
                    res = self._microbatch_local_select(q, bound)
                if res is None:
                    res = self.local.execute_bound(bound)
        self._store_result(q, res)

    def _parse_prepared(self, text: str):
        """Parse a prepared statement's text through a bounded AST
        cache: a warm EXECUTE re-parses nothing."""
        from presto_tpu_torch.sql import parse_statement

        cache = getattr(self, "_ast_cache", None)
        if cache is None:
            cache = self._ast_cache = OrderedDict()
        with self._prepared_mu:
            got = cache.get(text)
            if got is not None:
                cache.move_to_end(text)
                return got
        parsed = parse_statement(text)
        with self._prepared_mu:
            cache[text] = parsed
            cache.move_to_end(text)
            while len(cache) > self.MAX_PREPARED:
                cache.popitem(last=False)
        return parsed

    def _microbatch_key(self, stmt_key: str) -> str:
        """The batch-queue grouping key, built here only: the canonical
        statement key already carries catalog/schema and the
        value-erased statement shape, so same-key statements are the
        same cached plan with different parameter vectors; the prefix
        keeps queue keys out of every other key space."""
        return f"mb|{stmt_key}"

    def _microbatch_local_select(self, q: _Query, stmt, adopt=False):
        """Coordinator-local SELECT through the micro-batch lane: ->
        QueryResult, or None when the lane and the result cache are
        both OFF (the caller keeps the scalar path). With either on, an
        eligible statement always returns here: a cached result, its
        lane of a batch when a group formed, the scalar path otherwise.

        ``adopt``: the plain-SELECT caller bypasses the runner's own
        execute() bookkeeping, so the lane adopts the coordinator stats
        into the runner history (system.runtime.queries must still see
        the query). Adoption happens AFTER the one wait-ms read below:
        a None return must leave no adopted twin behind."""
        runner = self.local
        wait_ms = float(runner.session.get("microbatch_wait_ms"))
        rc_on = bool(runner.session.get("enable_result_cache"))
        if wait_ms <= 0 and not rc_on:
            return None
        if adopt:
            runner.history.adopt(q.stats)
            q._adopted = True
        if rc_on:
            # the result cache UNDER the batch queue: a hot shape's
            # first batch executes ONCE, every later statement answers
            # here with zero planning and zero dispatch
            res = self._result_cache_lookup(q, stmt)
            if res is not None:
                return res
        plan, _hit, key = runner.plan_cached_keyed(stmt)
        res = None
        if (
            wait_ms > 0
            and key is not None
            and runner.microbatch_plan_eligible(plan)
        ):
            max_size = min(int(runner.session.get("microbatch_max")), 128)
            res = self.microbatch.execute(
                self._microbatch_key(key),
                plan,
                q.stats,
                wait_ms,
                max_size,
                no_wait=q._admission_parked,
            )
        if res is None:
            # ineligible statement, empty window, or a lane that fell
            # out of the batch: the one scalar path (capacity retries,
            # error surfacing, full materialization)
            res = runner.execute_plan(plan, qs=q.stats)
        if rc_on:
            self._result_cache_store(q, plan, res)
        return res

    def _result_cache_lookup(self, q: _Query, stmt, adopt=False):
        """Tier-a lookup in front of planning and dispatch: -> a served
        result on a usable entry (fresh, or stale within the session's
        bounded-staleness window, which also spawns the ONE background
        refresh), else None with the minted key kept on ``q`` for the
        store after execution. Every failure lane degrades to a miss."""
        rc = self.result_cache
        if rc is None:
            return None
        from presto_tpu_torch.server import result_cache as rc_mod

        key = rc_mod.statement_key(stmt, self.local.session)
        q._rc_key = key
        q._rc_stmt = stmt
        if key is None:
            return None
        max_stale = float(
            self.local.session.get("result_cache_max_staleness_s")
        )
        got = rc.get(key, max_staleness_s=max_stale)
        if got is None:
            q.stats.result_cache = "miss"
            return None
        entry, stale = got
        if adopt and not q._adopted:
            # the distributed path adopts inside _run_select, which a
            # hit never reaches: system.runtime.queries must still see
            # the query
            self.local.history.adopt(q.stats)
            q._adopted = True
        q.stats.result_cache = "stale" if stale else "hit"
        q.stats.result_cache_age_ms = (
            time.time() - entry.created_at
        ) * 1000.0
        q.stats.result_cache_snapshot = entry.snapshot_label
        q.stats.output_rows = len(entry.rows)
        if stale:
            self._spawn_result_refresh(entry)
        return rc_mod.CachedResult(entry.columns, entry.rows)

    def _result_cache_store(self, q: _Query, plan, res) -> None:
        """The put after execution: the entry keys on the statement key
        minted at lookup and the snapshot vector pinned into the
        executed plan. No-op (fail open) without a key, on any
        non-cacheable scan, or on estimation errors."""
        rc = self.result_cache
        key = q._rc_key
        if rc is None or key is None or plan is None or res is None:
            return
        from presto_tpu_torch.plan import canonical

        try:
            rc.put(
                key,
                q._rc_stmt,
                res.columns,
                res.rows(),
                canonical.plan_handles(plan),
            )
        except Exception:
            log.debug("result-cache put skipped", exc_info=True)

    def _spawn_result_refresh(self, entry) -> None:
        """Tier-c background refresh: exactly ONE re-execution per stale
        entry (a per-entry compare-and-set), off the serving path,
        through the normal plan/execute seam; the re-put replaces the
        stale entry with a fresh vector."""
        rc = self.result_cache
        if rc is None or not rc.claim_refresh(entry):
            return

        def _refresh():
            from presto_tpu_torch.plan import canonical

            try:
                runner = self.local
                plan, _hit, _key = runner.plan_cached_keyed(entry.stmt)
                res = runner.execute_plan(plan)
                rc.put(
                    entry.key,
                    entry.stmt,
                    res.columns,
                    res.rows(),
                    canonical.plan_handles(plan),
                )
            except Exception:
                log.warning("result-cache refresh failed", exc_info=True)
            finally:
                rc.finish_refresh(entry)

        threading.Thread(
            target=_refresh, name="result-cache-refresh", daemon=True
        ).start()

    def _run_select(self, q: _Query, stmt, workers):
        """Distributed SELECT: plan -> fragment -> schedule stages ->
        gather, each phase a span on the query's trace; returns the
        QueryResult. Falls back to the local engine when fragmenting
        yields no remote sources."""
        from presto_tpu_torch.exec.host_ops import apply_host_ops, peel_host_ops
        from presto_tpu_torch.parallel.fragmenter import insert_gathers
        from presto_tpu_torch.plan.optimizer import prune_columns

        # distributed queries share the runner's QueryHistory (one
        # system.runtime.queries across both tiers) and fire the
        # query-completed event through it
        self.local.history.adopt(q.stats)
        q._adopted = True
        q.stats.retry_policy = self._retry_policy()
        t0 = time.perf_counter()
        with q.trace.span("plan"):
            # statement-level plan cache: a warm shape skips planning
            # and optimization; the execution's literal values then
            # substitute back in (materialize) so fragments ship plain
            # literals — wire protocol and workers unchanged, and each
            # worker re-hoists locally, so literal-variant fragments
            # hit the WORKER compile caches too
            plan, q.stats.plan_cache_hit = self.local.plan_cached(stmt)
            # result-cache store site (the caller): the entry keys on
            # THIS plan's snapshot-pinned scan handles
            q._rc_plan = plan
            if plan.bound_values:
                from presto_tpu_torch.plan import canonical

                plan = canonical.materialize_plan(plan)
            t_opt = time.perf_counter()
            with self.local._history_scope():
                root = prune_columns(self.local._bind_params(plan))
            q.stats.optimization_ms += (
                time.perf_counter() - t_opt
            ) * 1000.0
        q.stats.planning_ms = (time.perf_counter() - t0) * 1000.0
        REGISTRY.distribution("plan.planning_ms").add(
            q.stats.planning_ms
        )
        if not q.stats.plan_fingerprint:
            # canonical statement identity for the history store and
            # the event-sink enrichment
            try:
                from presto_tpu_torch.plan import history as plan_history

                q.stats.plan_fingerprint = (
                    plan_history.plan_fingerprint(root)
                )
            except Exception:
                pass
        scans = [
            n for n in N.walk(root) if isinstance(n, N.TableScanNode)
        ]
        if any(
            self.local.catalogs.get(s.handle.catalog).coordinator_only()
            for s in scans
        ):
            # system.runtime.* data lives in THIS process; a worker's
            # copy of those tables is empty
            t1 = time.perf_counter()
            try:
                with q.trace.span("execute-local"):
                    # qs keeps the thread's stats sink live inside
                    # execute_plan (it swaps in its qs argument), so
                    # coordinator-local staging pins + attributes
                    return self.local.execute_plan(plan, qs=q.stats)
            finally:
                q.stats.execution_ms = (
                    time.perf_counter() - t1
                ) * 1000.0
        with q.trace.span("fragment"):
            host_ops: List[N.PlanNode] = []
            if self.local.session.get("host_root_stage"):
                root, host_ops = peel_host_ops(root)
            froot = insert_gathers(root)
        q._plan_root = root
        remotes = [
            n for n in N.walk(froot) if isinstance(n, N.RemoteSourceNode)
        ]
        t1 = time.perf_counter()
        try:
            return self._run_select_fragments(
                q, plan, root, froot, host_ops, remotes, workers
            )
        finally:
            q.stats.execution_ms = (time.perf_counter() - t1) * 1000.0

    def _run_select_fragments(
        self, q: _Query, plan, root, froot, host_ops, remotes, workers
    ):
        from presto_tpu_torch.exec.host_ops import apply_host_ops

        if not remotes:
            return self.local.execute_plan(plan, qs=q.stats)
        # ordered MERGE exchange (reference: MergeOperator): when the
        # peeled root sort sits directly over a single no-cut fragment,
        # push the sort into the worker fragment (per-batch sorted runs)
        # and k-way merge the runs at the gather instead of re-sorting
        merge_sort = None
        merge_stage = None
        if len(remotes) == 1 and isinstance(froot, N.RemoteSourceNode):
            sorts = [op for op in host_ops if isinstance(op, N.SortNode)]
            if len(sorts) == 1:
                merge_stage = plan_stage(
                    remotes[0].fragment_root, self.local.catalogs
                )
                # merge requires raw worker rows: a stage with an
                # aggregation cut emits PARTIAL states whose sorted
                # runs would be meaningless
                if merge_stage is not None and isinstance(
                    merge_stage.final_root, N.RemoteSourceNode
                ):
                    merge_sort = sorts[0]
        if merge_sort is not None:
            page = self._run_stage(
                remotes[0].fragment_root, workers, q,
                order_by=merge_sort, stage=merge_stage,
            )
            host_ops = [op for op in host_ops if op is not merge_sort]
            if host_ops:
                page = apply_host_ops(page, host_ops)
            from presto_tpu_torch.exec.local_runner import QueryResult

            return QueryResult(plan.output_names, page)
        if len(remotes) == 1:
            pages = [self._run_stage(remotes[0].fragment_root, workers, q)]
        else:
            # overlap independent fragments (reference: all stages of a
            # query run concurrently — inter-stage pipelining)
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(len(remotes)) as pool:
                futs = [
                    pool.submit(self._run_stage, r.fragment_root, workers, q)
                    for r in remotes
                ]
                pages = [f.result() for f in futs]
        with q.trace.span("gather", phase="final-splice"):
            page = self.local._run_with_pages(froot, remotes, pages)
            if host_ops:
                page = apply_host_ops(page, host_ops)
        from presto_tpu_torch.exec.local_runner import QueryResult

        return QueryResult(plan.output_names, page)

    # --------------------------------------------------- stats collection

    def _finish_query_stats(self, q: _Query) -> None:
        """Close out the query's stats object and, for distributed
        queries (adopted into the runner's history), fire the
        query-completed event through the history."""
        # distributed EXPLAIN ANALYZE already set the inner SELECT's
        # real output count; q.rows there holds plan-text lines
        if not q._output_rows_final:
            q.stats.output_rows = len(q.rows)
        # final memory rollup while the reservations are still live
        # (the pool releases right after this in _execute_query)
        self._fold_memory_stats(q)
        # close any stage a failed (or early-exited) path left open:
        # a finished query must not report RUNNING stages — and no
        # task may stay RUNNING either (a timed-out pull records a
        # provisional snapshot; the task was DELETEd on the worker)
        with q._stats_lock:
            for st in q.stats.stages:
                if st.state == "RUNNING":
                    st.state = q.state
                for t in st.tasks:
                    if t.state in ("QUEUED", "RUNNING"):
                        t.state = (
                            "ABORTED" if q.state == "FINISHED"
                            else "FAILED"
                        )
        q.stats.roll_up()
        if q._adopted:
            self.local.history.finish(q.stats, error=q.error)
        else:
            q.stats.end_time = time.time()
            q.stats.state = q.state
            q.stats.error = q.error
        log.info(
            "trace=%s query=%s state=%s elapsed_ms=%.1f",
            q.trace.trace_id, q.qid, q.state, q.stats.elapsed_ms,
        )

    def _new_stage(self, q: _Query, kind: str) -> StageStats:
        with q._stats_lock:
            st = StageStats(stage_id=next(q._stage_seq), kind=kind)
            q.stats.stages.append(st)
        return st

    def _register_task(
        self, q: _Query, stage: StageStats, spec: FragmentSpec
    ) -> FragmentSpec:
        """Remember which stage a task belongs to, so its final status
        rolls up into the right StageStats."""
        with q._stats_lock:
            q._task_stage[spec.task_id] = stage
        return spec

    def _record_task_status(self, q: _Query, task_id: str, st: dict):
        """Fold one task's status JSON into the query rollup and graft
        its worker-side spans into the query trace. Only a TERMINAL
        status seals the task: a non-terminal snapshot (a timed-out
        pull reading a still-RUNNING worker) is folded provisionally
        and replaced if the real final status arrives later."""
        d = st.get("stats") or {}
        ts = (
            TaskStats.from_dict(d)
            if d
            else TaskStats(task_id=task_id, query_id=q.qid)
        )
        ts.state = st.get("state", ts.state)
        terminal = ts.state in ("FINISHED", "FAILED", "ABORTED")
        # a finished query's stats are closed: a straggling teardown
        # thread (hung worker finally answering) must not fold a
        # provisional RUNNING snapshot back into them
        if not terminal and q.done.is_set():
            return
        with q._stats_lock:
            if task_id in q._recorded:
                return
            if terminal:
                q._recorded.add(task_id)
            ts.speculative = task_id in q._speculative
            stage = q._task_stage.get(task_id)
            if stage is not None:
                ts.stage_id = stage.stage_id
                # replace an earlier provisional snapshot of this task
                stage.tasks = [
                    t for t in stage.tasks if t.task_id != task_id
                ] + [ts]
        q.trace.graft(st.get("spans"))

    def _finish_task(
        self, q: _Query, w, task_id: str, traceparent: str = "",
        presumed: str = "FAILED",
    ) -> None:
        """Collect a task's final stats, then DELETE it on the worker
        (the one task-teardown path: stats must be read BEFORE the
        DELETE removes the task). ``presumed`` labels the attempt when
        the worker can no longer answer the status GET: callers on a
        success path (pages fully pulled) pass FINISHED — the rows ARE
        in the result — while failure/abort paths keep FAILED, so
        QueryInfo, system.runtime.tasks, and EXPLAIN ANALYZE account
        for every scheduled attempt (speculated losers included)
        without inventing phantom failures."""
        try:
            st = self._rpc_json(
                "GET",
                f"{w.uri}/v1/task/{task_id}/status",
                traceparent=traceparent,
            )
            self._record_task_status(q, task_id, st)
        except Exception:
            # the worker is gone: synthesize the presumed terminal
            # TaskStats for the lost attempt
            self._record_task_status(
                q,
                task_id,
                {
                    "state": presumed,
                    "stats": {
                        "task_id": task_id,
                        "query_id": q.qid,
                        "node_id": w.node_id,
                        "state": presumed,
                    },
                },
            )
        try:
            self._rpc_json(
                "DELETE",
                f"{w.uri}/v1/task/{task_id}",
                traceparent=traceparent,
            )
        except Exception:
            pass

    def _abort_task(self, q: _Query, w, spec: FragmentSpec) -> None:
        """Tear a losing/failed attempt down OFF the calling thread:
        the winner must not wait out status/DELETE timeouts against a
        worker that may be hung (any still-open task state is closed
        when the query finishes)."""
        threading.Thread(
            target=self._finish_task,
            args=(q, w, spec.task_id, spec.traceparent),
            daemon=True,
        ).start()

    def query_info(self, q: _Query) -> dict:
        """Full QueryInfo (reference: ``GET /v1/query/{id}``): the
        stats rollup, per-stage task stats, and the span tree —
        servable while the query is RUNNING."""
        if not q.done.is_set():
            self._fold_memory_stats(q)
        q.stats.roll_up()
        info = q.stats.to_dict(include_stages=True)
        info["state"] = q.state  # _Query.state is authoritative
        info["error"] = q.error
        info["user"] = getattr(q, "user", None)
        info["resource_group"] = getattr(q, "resource_group", None)
        info["trace"] = q.trace.to_tree()
        if self.qos is not None:
            # QoS plane: lane/SLO identity + suspension/resume counters
            info["qos"] = self.qos.query_info(q)
        return info

    def query_summary(self, q: _Query) -> dict:
        return {
            "query_id": q.qid,
            "state": q.state,
            "query": q.sql,
            "trace_id": q.trace.trace_id,
            "elapsed_ms": q.stats.elapsed_ms,
            "user": getattr(q, "user", None),
            "stages": len(q.stats.stages),
        }

    def query_progress(self, q: _Query) -> dict:
        """Live progress view (``GET /v1/query/{id}/progress``),
        consumable MID-query: per-stage task completion + the
        rows/bytes/dispatch counters accumulated so far, a completion
        fraction, and an ETA.

        The ETA numerator is split completion (tasks FINISHED over
        tasks scheduled — stages appear as the scheduler creates them,
        so ``splits_total`` grows while the query plans new stages and
        the fraction is a floor, never an overestimate of progress).
        When the plan shape has history (the PR-7 store), the
        history-observed root cardinality rides along as
        ``expected_rows`` and backstops the fraction before any task
        has finished. All the ``*_done``/rows/bytes/dispatch counters
        are monotone over a query's lifetime."""
        if not q.done.is_set():
            self._fold_memory_stats(q)
        q.stats.roll_up()
        stages = []
        splits_done = splits_total = 0
        rows = nbytes = dispatches = spilled = 0
        for s in q.stats.stages:
            r = s.rollup()
            s_total = len(s.tasks)
            s_done = sum(
                1 for t in s.tasks if t.state == "FINISHED"
            )
            splits_done += s_done
            splits_total += s_total
            rows += r["output_rows"]
            nbytes += r["output_bytes"]
            dispatches += r["device_dispatches"]
            spilled += r["spilled_bytes"]
            stages.append(
                {
                    "stage_id": s.stage_id,
                    "kind": s.kind,
                    "state": s.state,
                    "splits_done": s_done,
                    "splits_total": s_total,
                    "rows": r["output_rows"],
                    "bytes": r["output_bytes"],
                    "dispatches": r["device_dispatches"],
                    "spilled_bytes": r["spilled_bytes"],
                }
            )
        from presto_tpu_torch.plan.history import progress_total_rows

        expected = progress_total_rows(
            self.local.history_store, q._plan_root
        )
        frac: Optional[float] = None
        if q.done.is_set():
            frac = 1.0
        elif splits_total > 0:
            frac = splits_done / splits_total
        elif expected and rows > 0:
            # no tasks scheduled yet but history knows the shape:
            # cardinality-based floor, capped below 1 (history can
            # underestimate today's data)
            frac = min(rows / expected, 0.99)
        elapsed_ms = q.stats.elapsed_ms
        eta_ms: Optional[float] = None
        if frac is not None:
            if frac >= 1.0:
                eta_ms = 0.0
            elif frac > 0 and elapsed_ms > 0:
                eta_ms = elapsed_ms * (1.0 - frac) / frac
        return {
            "query_id": q.qid,
            "state": q.state,
            "done": q.done.is_set(),
            "elapsed_ms": elapsed_ms,
            "splits_done": splits_done,
            "splits_total": splits_total,
            "rows": rows,
            "bytes": nbytes,
            "device_dispatches": dispatches,
            "spilled_bytes": spilled,
            "expected_rows": expected,
            "progress": frac,
            "eta_ms": eta_ms,
            "stages": stages,
        }

    # ------------------------------------------------- metrics federation

    def cluster_metrics(self) -> str:
        """One federated exposition (``GET /v1/metrics/cluster``): the
        coordinator's own registry plus every TTL-live worker's scrape,
        per-node labeled, with ``node="cluster"`` sums of the additive
        families."""
        from presto_tpu_torch.utils.telemetry import parse_prometheus

        by_node = {
            "coordinator": parse_prometheus(
                REGISTRY.render_prometheus()
            )
        }
        by_node.update(
            self.federation.scrape(
                (w.node_id, w.uri + "/v1/metrics")
                for w in self._ttl_workers()
            )
        )
        return self.federation.render(by_node)

    def _telemetry_tick(self) -> None:
        """One sampler round: fold the coordinator's registry and every
        TTL-live worker's scrape into the ring buffer (monotone,
        label-free streams only — quantile samples don't rate)."""
        from presto_tpu_torch.utils.telemetry import (
            _monotone,
            parse_prometheus,
        )

        samp = self.telemetry_sampler
        if samp is None:
            return
        by_node = {
            "coordinator": parse_prometheus(
                REGISTRY.render_prometheus()
            )
        }
        by_node.update(
            self.federation.scrape(
                (w.node_id, w.uri + "/v1/metrics")
                for w in self._ttl_workers()
            )
        )
        ts = time.time()
        for node_id, samples in by_node.items():
            samp.observe(
                node_id,
                [
                    (name, value)
                    for name, labels, value in samples
                    if _monotone(name) and not labels
                ],
                ts=ts,
            )

    def _telemetry_loop(self) -> None:
        while not self._telemetry_stop.wait(
            self._telemetry_interval_s
        ):
            try:
                self._telemetry_tick()
            except Exception:
                log.debug("telemetry tick failed", exc_info=True)

    # ------------------------------------------- dynamic filtering plane

    def _stage_dynamic_filter(self, q: _Query, stage, workers):
        """Distributed dynamic filtering (reference: runtime filters
        flowing build->probe across the cluster, Sethi et al. ICDE'19
        §III-C; exec/dynfilter.py owns the summary vocabulary).

        When the stage's partitioned (probe) scan feeds the PROBE side
        of an inner/semi join, schedule a build-side SUMMARY stage
        first: workers execute the build subtree over split ranges and
        report per-key summaries (min/max + NDV-capped distinct sets)
        on the task-status plane; the coordinator merges the partials
        and applies the completed filter twice —

        1. a ``FilterNode(dynamic=True)`` fused into the probe fragment
           (pre-join row pruning, pruned counts traced), and
        2. a TupleDomain-lite constraint into ``Connector.get_splits``
           so hive partition pruning and parquet/ORC min-max stats
           skip whole splits before any byte is read.

        The wait is BOUNDED by ``dynamic_filtering_wait_ms``: build
        slowness, task failure, or worker death degrade to ``None`` —
        the caller runs the exact unfiltered plan (never blocks, never
        fails the query). Returns None or a
        ``(fragment, partition_scan, ranges, adapt_obs)`` override
        tuple — ``adapt_obs`` (adaptive execution) carries the build
        side's OBSERVED cardinality beside the estimate it was planned
        on, turning this barrier into the runtime decision point
        ``_run_stage`` consults before the probe schedules."""
        from presto_tpu_torch.exec import dynfilter
        from presto_tpu_torch.server.scheduler import _path_to, _replace_on_path

        session = self.local.session
        if not session.get("enable_dynamic_filtering"):
            return None
        frag = stage.worker_fragment
        walk = list(N.walk(frag))
        if not (0 <= stage.partition_scan < len(walk)):
            return None
        part_scan = walk[stage.partition_scan]
        if not isinstance(part_scan, N.TableScanNode):
            return None
        path = _path_to(frag, part_scan)
        if path is None:
            return None
        # nearest JoinNode ancestor decides: usable only when the probe
        # (left) side of an inner/semi join holds the partitioned scan
        J = None
        probe_steps = None
        for i in range(len(path) - 2, -1, -1):
            n = path[i]
            if isinstance(n, (N.JoinNode, N.CrossJoinNode)):
                if (
                    isinstance(n, N.JoinNode)
                    and n.join_type in ("inner", "semi")
                    and path[i + 1] is n.left
                    and n.left_keys
                ):
                    J = n
                    probe_steps = path[i + 1 : -1]  # J.left -> scan
                break
        if J is None:
            return None
        left_schema = J.left.output_schema()
        build_schema = J.right.output_schema()
        # keys a summary can act on: probe/build types must agree
        # (scales and dictionary id spaces), no long decimals/arrays
        pairs = []
        for lk, rk in zip(J.left_keys, J.right_keys):
            lt = left_schema.get(lk)
            bt = build_schema.get(rk)
            if (
                lt is None
                or bt is None
                or lt != bt
                or lt.is_long_decimal
                or lt.is_array
            ):
                continue
            pairs.append((lk, rk))
        if not pairs:
            return None
        bstage = plan_stage(J.right, self.local.catalogs)
        if bstage is None or not isinstance(
            bstage.final_root, N.RemoteSourceNode
        ):
            # the build subtree has an aggregation cut (partial states
            # would summarize aggregate VALUES, not key domains) or no
            # partitionable scan: skip, keep today's plan
            return None
        ndv = int(session.get("dynamic_filtering_ndv_limit"))
        # adaptive partitioned->broadcast handoff: the probe stage
        # already summarized THIS build subtree — reorder its observed
        # per-key columns onto the keys requested here instead of
        # paying a second summary stage (and its wait budget)
        summary = None
        want = [rk for _, rk in pairs]
        if q._df_probe_reuse:
            from presto_tpu_torch.plan import history as plan_history

            try:
                stash = q._df_probe_reuse.get(
                    plan_history.node_fingerprint(J.right)
                )
            except Exception:
                stash = None
            if stash is not None:
                s_sum, s_keys = stash
                if set(want) <= set(s_keys):
                    summary = dynfilter.subset_summary(
                        (
                            s_sum.columns[s_keys.index(rk)]
                            for rk in want
                        ),
                        rows=s_sum.rows,
                    )
                    REGISTRY.counter(
                        "dynamic_filter.summary_reused"
                    ).update()
        if summary is None:
            wait_s = (
                float(session.get("dynamic_filtering_wait_ms")) / 1000.0
            )
            if wait_s <= 0:
                # "don't wait" knob: no budget to ever read a summary,
                # so don't pay for posting + aborting a build stage
                # either
                REGISTRY.counter("dynamic_filter.wait_expired").update()
                return None
            t0 = time.monotonic()
            with q.trace.span("dynfilter"):
                summary = self._run_dynfilter_summary(
                    q, bstage, workers, want, ndv,
                    deadline=t0 + wait_s,
                )
            waited_ms = (time.monotonic() - t0) * 1000.0
            REGISTRY.distribution("dynamic_filter.wait_ms").add(
                waited_ms
            )
            with q._stats_lock:
                q.stats.dynamic_filter_wait_ms += waited_ms
            if summary is None:
                REGISTRY.counter("dynamic_filter.wait_expired").update()
                return None
        REGISTRY.counter("dynamic_filter.built").update()
        # adaptive execution: the merged summary's observed build
        # cardinality is runtime TRUTH about the estimate this join's
        # distribution was chosen on — hand it to the decision point
        # in _run_stage (returned, not stashed on q: independent
        # fragments run _run_stage concurrently on one query)
        adapt_obs = None
        if session.get("adaptive_enabled") and summary.rows >= 0:
            from presto_tpu_torch.plan import optimizer

            try:
                with self.local._history_scope():
                    est = float(
                        optimizer.estimate_rows(
                            J.right, self.local.catalogs
                        )
                    )
            except Exception:
                est = None
            adapt_obs = {
                "join": J,
                "observed": int(summary.rows),
                "estimate": est,
            }
        probe_cols = [(lk, left_schema[lk]) for lk, _ in pairs]
        pred = dynfilter.to_predicate(summary, probe_cols)
        if pred is None:
            return None, None, None, adapt_obs
        # count the conjuncts actually fused (a merged summary column
        # can lose its value set past the NDV cap and contribute none)
        n_filters = dynfilter.applicable_count(summary, probe_cols)
        REGISTRY.counter("dynamic_filter.applied").update(n_filters)
        # _roll_lock, not _stats_lock: roll_up folds task-side filter
        # counts into the same field under it (see stats.QueryStats)
        with q.stats._roll_lock:
            q.stats.dynamic_filters += n_filters
        # 1. fuse the filter into the probe fragment, directly under
        # the join (names are J.left's output schema there)
        new_J = dataclasses.replace(
            J,
            left=N.FilterNode(
                source=J.left, predicate=pred, dynamic=True
            ),
        )
        jpath = _path_to(frag, J)
        new_frag = _replace_on_path(jpath[:-1], J, new_J)
        new_idx = next(
            i
            for i, n in enumerate(N.walk(new_frag))
            if n is part_scan
        )
        # 2. connector-level split pruning: only keys that reach the
        # probe SCAN unchanged (Filter/Project pass-through of the bare
        # column) may constrain split enumeration
        scan_schema = dict(part_scan.schema)
        scan_pairs = []
        for (lk, _rk), cf in zip(pairs, summary.columns):
            if scan_schema.get(lk) != left_schema[lk]:
                continue
            if all(
                _passes_through(step, lk) for step in (probe_steps or ())
            ):
                scan_pairs.append(((lk, left_schema[lk]), cf))
        ranges = None
        if scan_pairs:
            con = dynfilter.to_constraint(
                dynfilter.subset_summary(
                    [cf for _, cf in scan_pairs]
                ),
                [pc for pc, _ in scan_pairs],
            )
            if con:
                ranges = self._pruned_ranges(
                    q, stage, part_scan, con,
                    deadline=t0 + 2.0 * wait_s,
                )
        return new_frag, new_idx, ranges, adapt_obs

    def _run_dynfilter_summary(
        self, q: _Query, bstage, workers, keys, ndv, deadline
    ):
        """Run the build-summary tasks (one range per worker) and merge
        their reported summaries, all within ``deadline`` (monotonic).
        ANY failure — POST/status errors, task failure, worker death,
        deadline expiry — returns None: the probe proceeds unfiltered.
        Posted tasks are always collected + DELETEd (off-thread)."""
        from presto_tpu_torch.exec import dynfilter

        ranges = assign_ranges(bstage.partition_rows, len(workers))
        ranges = [r for r in ranges if r[1] > r[0]] or [(0, 0)]
        dstage = self._new_stage(q, "dynfilter")
        posted: List[tuple] = []
        merged = None
        ok = False

        def df_policy() -> rpc.RpcPolicy:
            """Every summary-plane RPC is capped by the REMAINING wait
            budget (no retries): a stalled — not cleanly dead — build
            worker must not hold probe scheduling past the bound the
            session promised (rpc.request-timeout-s x retries would)."""
            return rpc.RpcPolicy(
                timeout_s=max(deadline - time.monotonic(), 0.05),
                retries=0,
            )

        try:
            for i, (lo, hi) in enumerate(ranges):
                if time.monotonic() > deadline:
                    return None
                w = workers[i % len(workers)]
                spec = self._register_task(q, dstage, FragmentSpec(
                    task_id=task_ids.mint(
                        q.qid, task_ids.DYNFILTER, next(q._task_seq)
                    ),
                    query_id=q.qid,
                    fragment=bstage.worker_fragment,
                    partition_scan=bstage.partition_scan,
                    split_start=lo,
                    split_end=hi,
                    split_batch_rows=int(
                        self.local.session.get("page_capacity")
                    ),
                    dynfilter_keys=tuple(keys),
                    dynfilter_ndv=ndv,
                    traceparent=q.trace.traceparent(),
                ))
                rpc.call_json(
                    "POST", w.uri + "/v1/task", spec.to_json(),
                    policy=df_policy(),
                    traceparent=spec.traceparent,
                )
                posted.append((w, spec))
            for w, spec in posted:
                while True:
                    if time.monotonic() > deadline:
                        return None
                    st = rpc.call_json(
                        "GET",
                        f"{w.uri}/v1/task/{spec.task_id}/status",
                        policy=df_policy(),
                        traceparent=spec.traceparent,
                    )
                    state = st.get("state")
                    if state == "FINISHED":
                        d = st.get("dynamic_filter")
                        if not d:
                            return None
                        s = dynfilter.FilterSummary.from_json(d)
                        merged = (
                            s if merged is None else merged.merge(s, ndv)
                        )
                        break
                    if state in ("FAILED", "ABORTED"):
                        return None
                    time.sleep(0.02)
            ok = merged is not None
            return merged
        except Exception:
            # injected faults / dead workers / RPC timeouts: degrade
            return None
        finally:
            dstage.state = "FINISHED" if ok else "ABORTED"
            for w, spec in posted:
                self._abort_task(q, w, spec)

    def _pruned_ranges(
        self, q: _Query, stage, part_scan, con, deadline=None
    ):
        """Enumerate the probe scan's splits WITH the dynamic-filter
        constraint and turn the survivors into worker ranges; record
        ``dynamic_filter.splits_pruned``. Returns None (nothing pruned
        — keep the legacy uniform ranges) or the range list.

        ``deadline`` (monotonic) bounds coordinator-side enumeration
        WALL TIME: a constraint-aware connector may probe statistics
        it has not cached yet (ORC decodes the join-key column once
        per stripe), and split pruning is an OPTIMIZATION — so the
        enumeration runs on a background thread and the query stops
        waiting at the deadline, scanning the legacy uniform ranges
        instead. The abandoned probe still completes and warms the
        connector's stats cache, so later queries prune for free."""
        from presto_tpu_torch.exec import dynfilter as DF

        if deadline is not None and time.monotonic() > deadline:
            return None
        conn = self.local.catalogs.get(part_scan.handle.catalog)
        over = max(1, int(self.local.session.get("split_queue_factor")))
        n_ranges = max(len(self.active_workers()) * over, 1)
        chunk = -(-max(stage.partition_rows, 1) // n_ranges)
        base = tuple(part_scan.constraint)

        def collect(c):
            src = conn.get_splits(
                part_scan.handle,
                target_split_rows=chunk,
                constraint=c,
            )
            out = []
            while not src.exhausted:
                out.extend(src.next_batch(256))
            return [s for s in out if s.row_end > s.row_start]

        def enumerate_both():
            return (
                collect(base),
                collect(DF.merge_constraints(base, con)),
            )

        if deadline is None:
            try:
                all_splits, kept = enumerate_both()
            except Exception:
                return None  # enumeration trouble: legacy ranges
        else:
            # timed: the connector's stats probe cannot be interrupted
            # mid-read, so it runs detached — the query gives up at
            # the deadline (unfiltered, correct) while the probe
            # finishes and caches for the next query
            import queue as _queue

            cell: "_queue.Queue" = _queue.Queue()

            def run():
                try:
                    cell.put(("ok", enumerate_both()))
                except Exception as e:
                    cell.put(("err", e))

            threading.Thread(target=run, daemon=True).start()
            try:
                kind, payload = cell.get(
                    timeout=max(deadline - time.monotonic(), 0.05)
                )
            except _queue.Empty:
                REGISTRY.counter(
                    "dynamic_filter.enumeration_timeouts"
                ).update()
                return None
            if kind == "err":
                return None
            all_splits, kept = payload
        # decide by COVERED ROWS, not split counts: pruning the middle
        # of a coalesced split INCREASES the count while still saving
        # reads (one [0,300) split can become [0,100)+[200,300))
        rows_pruned = sum(
            s.row_end - s.row_start for s in all_splits
        ) - sum(s.row_end - s.row_start for s in kept)
        if rows_pruned <= 0:
            return None
        # coalesce survivors into runs (also the overlap basis for the
        # pruned-split count), then chop each run to the legacy chunk
        # size so split placement stays dynamic
        runs: List[List[int]] = []
        for s in sorted(kept, key=lambda s: s.row_start):
            if runs and s.row_start <= runs[-1][1]:
                runs[-1][1] = max(runs[-1][1], s.row_end)
            else:
                runs.append([s.row_start, s.row_end])
        pruned = sum(
            1
            for s in all_splits
            if not any(
                lo < s.row_end and hi > s.row_start for lo, hi in runs
            )
        )
        REGISTRY.counter("dynamic_filter.splits_pruned").update(pruned)
        with q._stats_lock:
            q.stats.dynamic_filter_splits_pruned += pruned
        ranges = []
        for lo, hi in runs:
            while lo < hi:
                ranges.append((lo, min(lo + chunk, hi)))
                lo += chunk
        return ranges or [(0, 0)]

    # -------------------------------------------- adaptive execution
    #
    # Runtime strategy switching at the build-summary barrier (ROADMAP
    # item 2, Presto's adaptive-execution direction): the dynamic-
    # filter plane already runs a join's build subtree FIRST and
    # reports its true cardinality before the probe schedules — these
    # helpers turn that into a decision point. Strategy-switch
    # construction lives HERE and in exec/dynfilter.py only
    # (tools/analyze.py ``adaptive-plane`` rule); every lane fails
    # OPEN to the original plan, and ``adaptive.enabled=false`` never
    # reaches any of it.

    def _adaptive_note(self, q: _Query, note: str) -> None:
        """Record one adaptive decision on the query (the ``adapted``
        QueryInfo flag + the EXPLAIN ANALYZE ``adaptive:`` line)."""
        with q._stats_lock:
            q.stats.adapted = True
            q.stats.adaptive_notes.append(note)

    def _adaptive_nparts(self, observed: int, workers) -> int:
        """Resize the shuffle partition count to the OBSERVED build
        cardinality: one partition per ``page_capacity`` rows, clamped
        to the worker pool — a small-but-mispredicted build must not
        fan a near-empty hash exchange across every worker."""
        cap = max(int(self.local.session.get("page_capacity")), 1)
        return max(1, min(len(workers), -(-int(observed) // cap)))

    def _adaptive_maybe_switch(
        self, q: _Query, fragment_root, obs: dict, workers
    ):
        """Broadcast->partitioned direction: the stage was headed for
        a replicated-build join, and the build summary observed a
        cardinality that contradicts the estimate beyond the
        divergence factor AND exceeds the broadcast bound. Returns the
        fragment's result page (the switched join ran + the remainder
        spliced), or None — keep the original plan."""
        from presto_tpu_torch.plan import history as plan_history

        session = self.local.session
        est, observed = obs.get("estimate"), obs.get("observed")
        factor = float(session.get("adaptive_divergence_factor"))
        if est is None or observed is None:
            return None
        if not plan_history.diverged(est, observed, factor):
            return None
        REGISTRY.counter("adaptive.divergence_detected").update()
        jdt = str(session.get("join_distribution_type")).upper()
        if (
            observed <= int(session.get("join_max_broadcast_rows"))
            or len(workers) <= 1
            or jdt not in ("AUTOMATIC", "AUTO")
        ):
            return None
        J = obs["join"]
        # both sides must admit cut-free source-partitioned producer
        # stages — the same qualification _choose_partitioned_join
        # applies (estimates said "broadcast" so it never planned them)
        side_stages = []
        for side in (J.left, J.right):
            st = plan_stage(side, self.local.catalogs)
            if st is None or not isinstance(
                st.final_root, N.RemoteSourceNode
            ):
                return None
            side_stages.append(st)
        from presto_tpu_torch.server.scheduler import (
            _path_to,
            _replace_on_path,
        )

        path = None
        if J is not fragment_root:
            # resolve the remainder splice BEFORE running anything: a
            # join we cannot splice back must not execute twice
            path = _path_to(fragment_root, J)
            if path is None:
                return None
        nparts = self._adaptive_nparts(observed, workers)
        page = self._run_one_partitioned_join(
            J, side_stages, workers, q, nparts=nparts
        )
        if path is not None:
            # re-plan ONLY the not-yet-scheduled remainder: the
            # executed join splices in as a remote page and everything
            # above it runs over the splice
            remote = N.RemoteSourceNode(fragment_root=J)
            root = _replace_on_path(path[:-1], J, remote)
            leaves, pages = self.local.leaf_pages(
                root, {id(remote): page}
            )
            page = self.local._run_with_pages(root, leaves, pages)
        # count + note only once the switched plan ACTUALLY answered:
        # a splice failure falls back to the original plan (the
        # caller's fail-open catch), and stats must not claim a switch
        # that was rolled back
        REGISTRY.counter("adaptive.strategy_switches").update()
        self._adaptive_note(
            q,
            f"SWITCHED broadcast→partitioned (est {est:.0f} rows, "
            f"observed {observed}, parts {nparts})",
        )
        return page

    def _adaptive_probe_build(
        self, q: _Query, J, side_stages, workers, observed_fp: dict
    ):
        """Partitioned->broadcast direction's evidence gatherer: before
        committing a candidate join's two sides to producer stages, run
        the BUILD subtree as a dynamic-filter-style summary stage (the
        same machinery and the same ``dynamic_filtering_wait_ms``
        budget as PR 4's plane) and report its observed cardinality
        beside the estimate. The observation also lands in
        ``observed_fp`` so the remaining join sequence re-ranks by
        runtime truth. Returns ``{"estimate", "observed"}`` or None —
        no budget, or any failure (fail-open: the partitioned plan
        proceeds as estimated)."""
        from presto_tpu_torch.plan import history as plan_history
        from presto_tpu_torch.plan import optimizer

        wait_s = (
            float(self.local.session.get("dynamic_filtering_wait_ms"))
            / 1000.0
        )
        if wait_s <= 0:
            return None
        bstage = side_stages[1]
        build_schema = dict(bstage.worker_fragment.output_schema())
        keys = [rk for rk in J.right_keys if rk in build_schema]
        if not keys:
            return None
        try:
            with plan_history.with_overrides(observed_fp):
                with self.local._history_scope():
                    est = float(
                        optimizer.estimate_rows(
                            J.right, self.local.catalogs
                        )
                    )
            ndv = int(
                self.local.session.get("dynamic_filtering_ndv_limit")
            )
            summary = self._run_dynfilter_summary(
                q, bstage, workers, keys, ndv,
                deadline=time.monotonic() + wait_s,
            )
        except Exception:
            return None
        if summary is None or summary.rows < 0:
            return None
        try:
            observed_fp[plan_history.node_fingerprint(J.right)] = float(
                summary.rows
            )
        except Exception:
            pass
        # the summary itself rides along: a partitioned->broadcast
        # switch hands it to the replicated join's dynamic-filter
        # plane so the build subtree is not summarized twice
        return {
            "estimate": est,
            "observed": int(summary.rows),
            "summary": summary,
            "keys": tuple(keys),
        }

    # ------------------------------------------------------- stage runner

    def _run_stage(
        self, fragment_root, workers, q: _Query, order_by=None, stage=None
    ):
        """Schedule one fragment across workers; gather + finalize.

        ``order_by`` (ordered MERGE exchange): wrap the worker fragment
        in the given root SortNode so workers emit sorted runs, and
        k-way merge the runs at the gather instead of re-sorting. The
        caller guarantees the stage has no aggregation cut."""
        # QoS: stage boundaries are suspension points too — a query
        # suspended between stages parks before scheduling the next
        self._qos_checkpoint(q)
        jdt = str(
            self.local.session.get("join_distribution_type")
        ).upper()
        if (
            order_by is None
            and len(workers) > 1
            and jdt in ("PARTITIONED", "AUTOMATIC", "AUTO")
        ):
            # PARTITIONED forces the hash-partitioned stage for every
            # qualifying join; AUTOMATIC chooses it per join from stats
            # (reference: AddExchanges' cost-driven distribution choice)
            # — partitioned only when BOTH sides exceed the broadcast
            # bound, so small-table plans keep the replicated fast path
            out = self._run_join_partitioned(
                fragment_root, workers, q,
                auto=jdt != "PARTITIONED",
            )
            if out is not None:
                return out
        if stage is None:
            stage = plan_stage(fragment_root, self.local.catalogs)
        if stage is None:
            # no scan admits a semantics-preserving partitioning:
            # single-task fallback on the coordinator's local engine
            return self.local._run(fragment_root)
        # dynamic filtering: a build-summary stage may rewrite the
        # probe fragment (fused filter) and override the split ranges
        # (connector-level pruning); None = today's plan, exactly.
        # FAIL-OPEN at the boundary: the filter is an optimization and
        # must never fail a query that would succeed unfiltered
        try:
            dyn = self._stage_dynamic_filter(q, stage, workers)
        except Exception:
            REGISTRY.counter("dynamic_filter.plan_errors").update()
            log.warning(
                "query=%s dynamic-filter planning failed; running "
                "unfiltered", q.qid, exc_info=True,
            )
            dyn = None
        dyn_fragment, dyn_scan_idx, dyn_ranges, adapt_obs = (
            dyn if dyn is not None else (None, None, None, None)
        )
        # adaptive execution: the build-summary barrier just reported
        # the build side's TRUE cardinality. When it contradicts the
        # estimate this join's broadcast distribution was chosen on
        # (beyond the divergence factor) and the build is too big to
        # replicate, flip to a hash-partitioned join and run only the
        # not-yet-scheduled remainder over its output — fail-open to
        # the original (possibly dyn-filtered) plan on any error,
        # exactly like the dynamic-filter plane itself
        if adapt_obs is not None and order_by is None:
            try:
                out = self._adaptive_maybe_switch(
                    q, fragment_root, adapt_obs, workers
                )
            except Exception:
                REGISTRY.counter("adaptive.plan_errors").update()
                log.warning(
                    "query=%s adaptive strategy switch failed; keeping "
                    "the original plan", q.qid, exc_info=True,
                )
                out = None
            if out is not None:
                return out
        worker_fragment = (
            dyn_fragment
            if dyn_fragment is not None
            else stage.worker_fragment
        )
        partition_scan_idx = (
            dyn_scan_idx
            if dyn_scan_idx is not None
            else stage.partition_scan
        )
        if order_by is not None:
            worker_fragment = dataclasses.replace(
                order_by, source=worker_fragment
            )
        # worker<->worker shuffle (reference: intermediate stages read
        # their hash partition straight from upstream tasks' partitioned
        # output buffers; the coordinator only sees final-stage output).
        # Applies when the stage cuts at a keyed agg/distinct and >1
        # worker is up; single-worker / global-agg / merge-exchange
        # stages keep the direct gather (nothing to repartition).
        from presto_tpu_torch.exec import streaming as S

        key_names = S._bucket_key_names(stage.worker_fragment)
        if (
            order_by is None
            and len(workers) > 1
            and key_names
            and bool(self.local.session.get("distributed_final"))
        ):
            bucket_root, rest_root, _, _ = S._split_final(
                stage.final_root, stage.worker_fragment
            )
            if bucket_root is not None:
                try:
                    return self._run_stage_shuffled(
                        stage, workers, q, key_names, bucket_root,
                        rest_root,
                        worker_fragment=worker_fragment,
                        partition_scan_idx=partition_scan_idx,
                        ranges_override=dyn_ranges,
                    )
                except Exception as e:
                    out = self._local_fallback(q, fragment_root, None, e)
                    if out is None:
                        raise
                    return out
        # dynamic split placement (reference: SourcePartitionedScheduler
        # handing split batches to whichever task has capacity): cut the
        # scan into more ranges than workers and let each worker thread
        # pull the next unclaimed range when it finishes — a straggler
        # naturally processes fewer ranges (work stealing by queue)
        over = max(1, int(self.local.session.get("split_queue_factor")))
        ranges = (
            dyn_ranges
            if dyn_ranges is not None
            else assign_ranges(
                stage.partition_rows, max(len(workers) * over, 1)
            )
        )
        ranges = [r for r in ranges if r[1] > r[0]] or [(0, 0)]
        stage_stats = self._new_stage(q, "source")

        def make_spec(lo: int, hi: int) -> FragmentSpec:
            return self._register_task(q, stage_stats, FragmentSpec(
                task_id=task_ids.mint(
                    q.qid, task_ids.SOURCE, next(q._task_seq)
                ),
                query_id=q.qid,
                fragment=worker_fragment,
                partition_scan=partition_scan_idx,
                split_start=lo,
                split_end=hi,
                split_batch_rows=int(
                    self.local.session.get("page_capacity")
                ),
                task_concurrency=int(
                    self.local.session.get("task_concurrency")
                ),
                prefetch_depth=int(
                    self.local.session.get("staging_prefetch_depth")
                ),
                traceparent=q.trace.traceparent(),
            ))

        # pull every worker concurrently (reference: the ExchangeClient
        # keeps all upstream tasks in flight; serial draining would
        # block worker 2's bounded buffer on worker 1's drain) and
        # retry a DEAD worker's range on a live one (recoverable
        # execution: reassign, don't fail the query)
        def pull_and_delete(w, spec):
            try:
                out = self._pull_task(w, spec)
            except Exception:
                # the failed attempt's stats/spans still fold into the
                # rollup and its buffered pages get DELETEd — but OFF
                # this thread (see _abort_task)
                self._abort_task(q, w, spec)
                raise
            # success path: all pages pulled — if the worker dies
            # before answering the status GET, the attempt still
            # FINISHED (its rows are in the result)
            self._finish_task(
                q, w, spec.task_id, spec.traceparent,
                presumed="FINISHED",
            )
            return out

        try:
            with q.trace.span("schedule", stage_id=stage_stats.stage_id):
                results = self._ranged_tasks(
                    workers, ranges, make_spec, pull_and_delete,
                    q=q, speculate=True,
                )
        except Exception as e:
            out = self._local_fallback(q, fragment_root, order_by, e)
            if out is None:
                raise
            stage_stats.state = "ABORTED"
            return out
        stage_stats.state = "FINISHED"
        payloads = [p for out in results for p in out]

        schema = dict(stage.worker_fragment.output_schema())
        with q.trace.span("gather", stage_id=stage_stats.stage_id):
            if order_by is not None:
                merged = _merge_sorted_runs(payloads, schema, order_by)
                return stage_page(merged, schema, device=self.local.device)
            remote = [
                n
                for n in N.walk(stage.final_root)
                if isinstance(n, N.RemoteSourceNode)
            ]
            # bucketed gather (reference: grouped execution at the
            # merge): partial states beyond the device budget
            # hash-bucket by group key and merge one bucket at a time
            # instead of funnelling everything into one staged page
            # (exec.streaming owns the policy, shared with the local
            # streamed path)
            from presto_tpu_torch.exec import streaming as S

            bucketed = S.grouped_final_merge(
                self.local,
                payloads,
                schema,
                stage.final_root,
                stage.worker_fragment,
                int(self.local.session.get("max_device_rows")),
            )
            if bucketed is not None:
                return bucketed
            merged = pages_wire.merge_payloads(payloads, schema)
            page = stage_page(merged, schema, device=self.local.device)
            # the final plan may contain real scans above the cut (e.g.
            # a join against another table after the final aggregation)
            # — load those locally alongside the gathered remote page
            local_scans = [
                n
                for n in N.walk(stage.final_root)
                if isinstance(n, N.TableScanNode)
            ]
            leaves = remote + local_scans
            pages = [page] + [
                self.local._load_table(s) for s in local_scans
            ]
            return self.local._run_with_pages(
                stage.final_root, leaves, pages
            )

    def _local_fallback(self, q: _Query, fragment_root, order_by, exc):
        """Graceful degradation, last resort: when a distributed stage
        died of connection-level failures and NO worker remains
        alive/circuit-closed, execute the fragment on the coordinator's
        local engine instead of failing the query. Returns None when
        degradation does NOT apply — execution errors, or live workers
        remaining — so the caller re-raises."""
        degradable = rpc.is_task_recoverable(exc) or isinstance(
            exc, NoLiveWorkers
        )
        # a memory-pressure kill DELETEs the victim's tasks — that
        # must surface as the kill, not trigger a local resurrection
        if getattr(q, "_mem_kill", None) is not None:
            return None
        if not degradable or self._any_worker_alive():
            return None
        REGISTRY.counter("coordinator.local_fallbacks").update()
        log.warning(
            "query=%s: no live workers (%s: %s); falling back to "
            "coordinator-local execution",
            q.qid, type(exc).__name__, exc,
        )
        with q.trace.span("execute-local-fallback"):
            out = self.local._run(fragment_root)
            if order_by is not None:
                from presto_tpu_torch.exec.host_ops import apply_host_ops

                out = apply_host_ops(out, [order_by])
            return out

    def _run_join_partitioned(
        self, fragment_root, workers, q: _Query, auto: bool = False
    ):
        """Hash-partitioned intermediate JOIN stages (reference:
        FIXED_HASH_DISTRIBUTION intermediate stages — SURVEY.md §2.4
        "Join distribution choice"): BOTH join inputs run as
        partitioned producer stages that hash their output by the
        equi-join keys into ``len(workers)`` buffers, and a join stage
        (one task per partition) pulls matching partitions from every
        producer of both sides — neither side is replicated. Valid for
        every equi-join type: a key lands in the same partition on both
        sides (value-stable hash), so per-partition joins partition the
        full join.

        ``auto=False`` (session ``join_distribution_type=PARTITIONED``)
        takes every qualifying join — one whose two sides each admit a
        cut-free source-partitioned stage. ``auto=True`` (AUTOMATIC)
        additionally requires BOTH sides' estimated rows to exceed
        ``join_max_broadcast_rows``, the engine's form of the
        reference's stats-driven AddExchanges choice: when one side is
        small, replicating it (the caller's fallback path) ships less
        data than repartitioning both. Qualifying joins are taken
        best-first (largest min-side estimate — where broadcast would
        hurt most) and ITERATED: independent joins elsewhere in the
        plan each get their own partitioned stage, their result pages
        feeding the final local splice. Returns None when no join
        qualifies (caller falls through to the replicated-build path).
        """
        thresh = (
            int(self.local.session.get("join_max_broadcast_rows"))
            if auto
            else None
        )
        from presto_tpu_torch.plan import history as plan_history

        session = self.local.session
        adaptive = bool(session.get("adaptive_enabled"))
        factor = float(session.get("adaptive_divergence_factor"))
        #: adaptive execution: node fingerprint -> OBSERVED rows of
        #: already-executed stages this query — candidate ranking for
        #: the not-yet-scheduled remainder re-runs under these
        #: overrides, so the join sequence re-orders by runtime truth
        observed_fp: Dict[str, float] = {}
        #: candidates the runtime decision point sent back to the
        #: broadcast path (never reconsidered this query)
        skip: set = set()
        root = fragment_root
        pages_map: Dict[int, object] = {}
        ran = False
        while True:
            target = self._choose_partitioned_join(
                root, thresh, skip=skip,
                observed=observed_fp if adaptive else None,
            )
            if target is None:
                break
            J, side_stages = target
            nparts = None
            if adaptive and thresh is not None:
                # runtime decision point (fail-open inside): observe
                # the build side through a summary stage BEFORE
                # committing both sides to producer stages
                obs = self._adaptive_probe_build(
                    q, J, side_stages, workers, observed_fp
                )
                if obs is not None and plan_history.diverged(
                    obs["estimate"], obs["observed"], factor
                ):
                    REGISTRY.counter(
                        "adaptive.divergence_detected"
                    ).update()
                    if obs["observed"] <= thresh:
                        # the build is actually broadcast-small: leave
                        # this join to the replicated-build path (the
                        # caller's fallback, dynamic filter included)
                        REGISTRY.counter(
                            "adaptive.strategy_switches"
                        ).update()
                        self._adaptive_note(
                            q,
                            "SWITCHED partitioned→broadcast (est "
                            f"{obs['estimate']:.0f} rows, observed "
                            f"{obs['observed']})",
                        )
                        # hand the probe's observed summary to the
                        # replicated join's dynamic-filter plane (the
                        # build subtree was JUST summarized — running
                        # the summary stage again would pay the wait
                        # twice for the same evidence)
                        try:
                            q._df_probe_reuse[
                                plan_history.node_fingerprint(J.right)
                            ] = (obs["summary"], obs["keys"])
                        except Exception:
                            pass
                        skip.add(id(J))
                        continue
                    nparts = self._adaptive_nparts(
                        obs["observed"], workers
                    )
                    if nparts != len(workers):
                        self._adaptive_note(
                            q,
                            f"RESIZED shuffle to {nparts} partition(s) "
                            f"(observed {obs['observed']} build rows)",
                        )
            page = self._run_one_partitioned_join(
                J, side_stages, workers, q, nparts=nparts
            )
            ran = True
            if J is root and not pages_map:
                return page
            remote = N.RemoteSourceNode(fragment_root=J)
            if adaptive:
                # feed the executed join's TRUE output rows back into
                # the remainder's ranking (both identities: the join
                # subtree itself and the remote splice that now stands
                # where it stood)
                try:
                    rows = float(page.num_valid)
                    observed_fp[
                        plan_history.node_fingerprint(J)
                    ] = rows
                    observed_fp[
                        plan_history.node_fingerprint(remote)
                    ] = rows
                except Exception:
                    pass
            from presto_tpu_torch.server.scheduler import (
                _path_to,
                _replace_on_path,
            )

            path = _path_to(root, J)
            root = _replace_on_path(path[:-1], J, remote)
            pages_map[id(remote)] = page
        if not ran:
            return None
        leaves, pages = self.local.leaf_pages(root, pages_map)
        return self.local._run_with_pages(root, leaves, pages)

    def _choose_partitioned_join(
        self, root, thresh: Optional[int], skip=(), observed=None
    ):
        """Best qualifying join for a partitioned stage, or None.

        Qualifying: an equi-join whose sides BOTH admit cut-free
        source-partitioned stages. With ``thresh`` (AUTOMATIC mode) the
        min-side row estimate must exceed it, and candidates rank by
        that estimate — the join where replicating the smaller side
        would ship the most rows wins first.

        Adaptive execution: ``skip`` holds joins the runtime decision
        point sent back to the broadcast path, and ``observed`` (node
        fingerprint -> rows of already-executed stages) re-ranks the
        remainder under plan/history.with_overrides — observed
        cardinality outranks the estimate it contradicted. Both
        default empty = today's ranking, bit-exact."""
        import contextlib

        from presto_tpu_torch.plan import history as plan_history
        from presto_tpu_torch.plan import optimizer

        if observed:
            scope = contextlib.ExitStack()
            scope.enter_context(plan_history.with_overrides(observed))
            scope.enter_context(self.local._history_scope())
        else:
            scope = contextlib.nullcontext()
        with scope:
            return self._choose_partitioned_join_ranked(
                root, thresh, skip, optimizer
            )

    def _choose_partitioned_join_ranked(
        self, root, thresh: Optional[int], skip, optimizer
    ):
        cands = []
        for J in N.walk(root):
            if not isinstance(J, N.JoinNode) or not J.left_keys:
                continue
            if id(J) in skip:
                continue
            # a side spliced with a prior iteration's materialized
            # RemoteSourceNode cannot run as a producer stage (workers
            # have no way to resolve the remote page) — skip before any
            # stage planning
            if any(
                isinstance(n, N.RemoteSourceNode)
                for side in (J.left, J.right)
                for n in N.walk(side)
            ):
                continue
            if thresh is not None:
                # cheap stats gate BEFORE any stage-planning work: in
                # the default AUTOMATIC mode most joins are small and
                # exit here without paying plan_stage
                small = min(
                    optimizer.estimate_rows(
                        J.left, self.local.catalogs
                    ),
                    optimizer.estimate_rows(
                        J.right, self.local.catalogs
                    ),
                )
                if small <= thresh:
                    continue
                cands.append((float(small), J))
            else:
                cands.append((0.0, J))
        if thresh is not None:
            # best-first by min-side estimate; plan stages only for the
            # winner, falling back down the ranking when a candidate's
            # sides don't admit source-partitioned stages
            cands.sort(key=lambda t: -t[0])
        for _, J in cands:
            stages = []
            for side in (J.left, J.right):
                st = plan_stage(side, self.local.catalogs)
                if st is None or not isinstance(
                    st.final_root, N.RemoteSourceNode
                ):
                    stages = None
                    break
                stages.append(st)
            if stages:
                return (J, stages)
        return None

    def _run_one_partitioned_join(
        self, J, side_stages, workers, q, nparts=None
    ):
        """Run ONE join as producer stages + a partitioned join stage;
        returns the gathered join output page. ``nparts`` (adaptive
        execution) overrides the partition fan-out — clamped to the
        pool; None = one partition per worker, the legacy shape."""
        from concurrent.futures import ThreadPoolExecutor

        REGISTRY.counter("coordinator.partitioned_join_stages").update()
        nparts = (
            len(workers)
            if nparts is None
            else max(1, min(int(nparts), len(workers)))
        )
        over = max(1, int(self.local.session.get("split_queue_factor")))
        created: List[tuple] = []
        clock = threading.Lock()
        # transport selection (the scheduler owns it): both producer
        # stages and the join stage carry the same slice id — either
        # side's schema being ICI-ineligible keeps the whole exchange
        # on the HTTP wire, but a lone cross-slice worker settles its
        # own edges to HTTP at run time (per-edge selection)
        ici_slice = self._select_transport(
            workers,
            schemas=(
                dict(side_stages[0].worker_fragment.output_schema()),
                dict(side_stages[1].worker_fragment.output_schema()),
            ),
        )
        if ici_slice:
            REGISTRY.counter("exchange.ici_stages").update()

        def run_producers(stage, keys, group):
            ranges = assign_ranges(
                stage.partition_rows, max(len(workers) * over, 1)
            )
            ranges = [r for r in ranges if r[1] > r[0]] or [(0, 0)]
            pstage = self._new_stage(q, "producer")

            def make_spec(lo: int, hi: int) -> FragmentSpec:
                return self._register_task(q, pstage, FragmentSpec(
                    task_id=task_ids.mint(
                        q.qid, task_ids.PRODUCER, next(q._task_seq)
                    ),
                    query_id=q.qid,
                    fragment=stage.worker_fragment,
                    partition_scan=stage.partition_scan,
                    split_start=lo,
                    split_end=hi,
                    split_batch_rows=int(
                        self.local.session.get("page_capacity")
                    ),
                    task_concurrency=int(
                        self.local.session.get("task_concurrency")
                    ),
                    prefetch_depth=int(
                        self.local.session.get("staging_prefetch_depth")
                    ),
                    n_partitions=nparts,
                    partition_keys=tuple(keys),
                    spool=self._spooling(),
                    ici_slice=ici_slice,
                    traceparent=q.trace.traceparent(),
                ))

            def wait_producer(w, spec):
                with clock:
                    created.append((w, spec.task_id))
                self._wait_task(w, spec)
                return (w.uri, spec.task_id, group)

            # legacy (retry_policy=NONE): producer death fails the
            # query — partitioned exchanges are non-recoverable. Under
            # TASK (and QUERY, its superset) the stage recovers: the
            # sources list carries only winning attempts (barrier
            # mode), and join tasks pulling a later-dead producer
            # re-serve its committed partitions from the durable spool
            res = self._ranged_tasks(
                workers, ranges, make_spec, wait_producer,
                q=q, retry=self._retry_policy() in ("TASK", "QUERY"),
            )
            pstage.state = "FINISHED"
            return res

        try:
            # both producer stages are independent: run concurrently
            # (sequential would cost sum, not max, of the side walls)
            with q.trace.span("schedule", phase="join-producers"):
                with ThreadPoolExecutor(2) as side_pool:
                    side_futs = [
                        side_pool.submit(run_producers, stage, keys, group)
                        for (stage, keys, group) in (
                            (side_stages[0], J.left_keys, 0),
                            (side_stages[1], J.right_keys, 1),
                        )
                    ]
                    sources: List[tuple] = [
                        s for f in side_futs for s in f.result()
                    ]

            join_frag = dataclasses.replace(
                J,
                left=N.RemoteSourceNode(fragment_root=J.left),
                right=N.RemoteSourceNode(fragment_root=J.right),
            )
            jstage = self._new_stage(q, "join")
            # join tasks pull both sides' partitions and hold the only
            # merged copy: stable nodes first (preemptible-aware)
            jworkers = stable_workers(workers)

            def post_and_pull(w, spec):
                with clock:
                    created.append((w, spec.task_id))
                self._rpc_json(
                    "POST", w.uri + "/v1/task", spec.to_json(),
                    traceparent=spec.traceparent,
                )
                return self._pull_task(w, spec)

            def run_join_task(i: int):
                w = jworkers[i % len(jworkers)]
                spec = self._register_task(q, jstage, FragmentSpec(
                    task_id=task_ids.mint(
                        q.qid, task_ids.JOIN, next(q._task_seq)
                    ),
                    query_id=q.qid,
                    fragment=join_frag,
                    partition_scan=-1,
                    split_start=0,
                    split_end=0,
                    sources=tuple(sources),
                    partition=i,
                    spool=self._spooling(),
                    ici_slice=ici_slice,
                    traceparent=q.trace.traceparent(),
                ))
                try:
                    return post_and_pull(w, spec)
                except (urllib.error.URLError, ConnectionError, OSError):
                    # join-worker death under a spooling retry policy:
                    # re-run the partition as the SAME logical task's
                    # next attempt on a live worker; its dead producer
                    # sources re-serve from the durable spool (the
                    # reference fails the query here: its partitioned
                    # join has no task recovery)
                    if not self._spooling() or (
                        getattr(q, "_mem_kill", None) is not None
                    ):
                        raise
                    self._worker_failed(w)
                    others = stable_workers(
                        self.active_workers(exclude={w.node_id})
                    )
                    if not others or not self._take_retry(q):
                        raise
                    self._record_recovery(q)
                    with q.trace.span(
                        "recovery", phase="join-task",
                        task_id=spec.task_id,
                    ):
                        return post_and_pull(
                            others[i % len(others)],
                            self._retry_spec(q, spec),
                        )

            with ThreadPoolExecutor(nparts) as pool:
                futs = [
                    pool.submit(run_join_task, i) for i in range(nparts)
                ]
                payloads = [p for f in futs for p in f.result()]
            jstage.state = "FINISHED"
        finally:
            for w, tid in created:
                self._finish_task(q, w, tid)

        schema = dict(join_frag.output_schema())
        if payloads:
            merged = pages_wire.merge_payloads(payloads, schema)
        else:
            merged = {
                nm: np.empty(0, t.np_dtype) for nm, t in schema.items()
            }
        return stage_page(merged, schema, device=self.local.device)

    def _run_stage_shuffled(
        self, stage, workers, q: _Query, key_names, bucket_root,
        rest_root, worker_fragment=None, partition_scan_idx=None,
        ranges_override=None,
    ):
        """Two-stage execution with a worker<->worker data plane.

        Stage 1 (producers): the usual dynamic range queue, but each
        task hash-partitions its PARTIAL output by the final agg's group
        keys into ``len(workers)`` output buffers (value-stable hash —
        exec.streaming's). Stage 2 (mergers): one task per worker pulls
        its partition from EVERY producer and runs the FINAL merge; the
        coordinator gathers only the merged (small) results and
        concatenates — correct because the hash partitions the group
        space. Sources attach when stage 1 completes (no pipelined
        shuffle start yet — documented simplification vs the reference's
        incremental addExchangeLocations)."""
        REGISTRY.counter("coordinator.shuffled_stages").update()
        # dynamic-filter overrides from _run_stage (None = legacy)
        if worker_fragment is None:
            worker_fragment = stage.worker_fragment
        if partition_scan_idx is None:
            partition_scan_idx = stage.partition_scan
        over = max(1, int(self.local.session.get("split_queue_factor")))
        ranges = (
            ranges_override
            if ranges_override is not None
            else assign_ranges(
                stage.partition_rows, max(len(workers) * over, 1)
            )
        )
        ranges = [r for r in ranges if r[1] > r[0]] or [(0, 0)]
        nparts = len(workers)
        prod_stage = self._new_stage(q, "producer")
        merge_stage = self._new_stage(q, "merge")
        # transport selection (the scheduler owns it): co-located
        # producer/merge workers exchange partitions as device
        # collectives; "" keeps the serialized HTTP wire, and a lone
        # cross-slice worker settles its own edges at run time
        ici_slice = self._select_transport(
            workers,
            schemas=(dict(worker_fragment.output_schema()),),
        )
        if ici_slice:
            REGISTRY.counter("exchange.ici_stages").update()

        def make_spec(lo: int, hi: int) -> FragmentSpec:
            return self._register_task(q, prod_stage, FragmentSpec(
                task_id=task_ids.mint(
                    q.qid, task_ids.PRODUCER, next(q._task_seq)
                ),
                query_id=q.qid,
                fragment=worker_fragment,
                partition_scan=partition_scan_idx,
                split_start=lo,
                split_end=hi,
                split_batch_rows=int(
                    self.local.session.get("page_capacity")
                ),
                task_concurrency=int(
                    self.local.session.get("task_concurrency")
                ),
                prefetch_depth=int(
                    self.local.session.get("staging_prefetch_depth")
                ),
                n_partitions=nparts,
                partition_keys=tuple(key_names),
                spool=self._spooling(),
                ici_slice=ici_slice,
                traceparent=q.trace.traceparent(),
            ))

        from concurrent.futures import ThreadPoolExecutor

        # every task POSTed (incl. attempts on workers that later died)
        # is recorded so the finally below can DELETE it — buffered
        # shuffle partitions must not outlive the query on any worker
        created: List[tuple] = []
        clock = threading.Lock()

        # PIPELINED shuffle start (reference: merge stages run
        # concurrently with their producers; sources attach via
        # addExchangeLocations): merge tasks are created FIRST with no
        # sources, each producer is announced the moment its task is
        # POSTed (pulls overlap production), and the set is sealed when
        # every range completes. Limitation vs full recoverability: a
        # producer dying after announcement fails the query (classic
        # non-recoverable exchange; the gather path's range retry
        # remains the recoverable fallback).
        merge_specs: List[tuple] = []

        def broadcast(source_list, done: bool):
            # transient PUT drops are healed by the SEAL broadcast,
            # which always carries the FULL deduped source list; a
            # dead merge worker surfaces at the pull
            body = {
                "sources": [list(s) for s in source_list],
                "done": done,
            }
            for w, spec in merge_specs:
                try:
                    self._rpc_json(
                        "PUT",
                        f"{w.uri}/v1/task/{spec.task_id}/sources",
                        body,
                        traceparent=spec.traceparent,
                    )
                except Exception:
                    pass

        def wait_producer(w, spec):
            with clock:
                created.append((w, spec.task_id))
            broadcast([(w.uri, spec.task_id)], False)
            self._wait_task(w, spec)
            return (w, spec.task_id)

        try:
            # merge tasks first, placed on live workers (a worker that
            # died since discovery is skipped, not fatal). Preemptible-
            # aware placement: merge state is the only copy of its
            # partition's FINAL, so merges go to stable nodes when any
            # exist — preemptibles keep the spool-backed producer work
            candidates = stable_workers(workers)
            for i in range(nparts):
                posted = False
                for k in range(len(candidates)):
                    w = candidates[(i + k) % len(candidates)]
                    spec = self._register_task(q, merge_stage, FragmentSpec(
                        task_id=task_ids.mint(
                            q.qid, task_ids.MERGE, next(q._task_seq)
                        ),
                        query_id=q.qid,
                        fragment=bucket_root,
                        partition_scan=-1,
                        split_start=0,
                        split_end=0,
                        partition=i,
                        spool=self._spooling(),
                        ici_slice=ici_slice,
                        traceparent=q.trace.traceparent(),
                    ))
                    try:
                        self._rpc_json(
                            "POST", w.uri + "/v1/task", spec.to_json(),
                            traceparent=spec.traceparent,
                        )
                    except (
                        urllib.error.URLError, ConnectionError, OSError
                    ):
                        self._worker_failed(w)
                        continue
                    merge_specs.append((w, spec))
                    posted = True
                    break
                if not posted:
                    raise NoLiveWorkers(
                        "no live worker accepts merge tasks"
                    )

            # legacy (retry_policy=NONE): a producer dying after its
            # announcement fails the query (classic non-recoverable
            # exchange). With the spool (TASK, or QUERY before its
            # last-resort restart) producers are retryable: every
            # attempt spools under one logical key and merge tasks
            # consume exactly ONE committed attempt per key, so a
            # retried producer racing its announced original can
            # never double-count
            with q.trace.span("schedule", stage_id=prod_stage.stage_id):
                producers = self._ranged_tasks(
                    workers, ranges, make_spec, wait_producer,
                    q=q, retry=self._spooling(),
                )
            sources = tuple((w.uri, tid) for w, tid in producers)
            # seal with the FULL list: add_sources dedups, so this
            # also repairs any announcement a merge task missed
            broadcast(sources, True)

            def run_merge_fallback(i: int, w):
                # merge-worker death: re-run that partition's FINAL as
                # a barrier-mode merge task — the SAME logical task,
                # next attempt — on a live worker (full source list
                # known by now; dead producers' partitions re-serve
                # from the durable spool when retry_policy spools)
                spec = self._register_task(
                    q,
                    merge_stage,
                    self._retry_spec(q, merge_specs[i][1], sources=sources),
                )
                try:
                    self._rpc_json(
                        "POST", w.uri + "/v1/task", spec.to_json(),
                        traceparent=spec.traceparent,
                    )
                    return self._pull_task(w, spec)
                finally:
                    self._finish_task(
                        q, w, spec.task_id, spec.traceparent
                    )

            def run_merge(i: int):
                w, spec = merge_specs[i]
                try:
                    return self._pull_task(w, spec)
                except (
                    urllib.error.URLError, ConnectionError, OSError
                ):
                    if getattr(q, "_mem_kill", None) is None:
                        self._worker_failed(w)
                    others = stable_workers(
                        self.active_workers(exclude={w.node_id})
                    )
                    if not others:
                        raise
                    self._record_recovery(q)
                    with q.trace.span(
                        "recovery", phase="merge-task",
                        task_id=spec.task_id,
                    ):
                        return run_merge_fallback(
                            i, others[i % len(others)]
                        )

            with q.trace.span("gather", stage_id=merge_stage.stage_id):
                with ThreadPoolExecutor(nparts) as pool:
                    futs = [
                        pool.submit(run_merge, i) for i in range(nparts)
                    ]
                    payloads = [p for f in futs for p in f.result()]
        finally:
            for w, spec in merge_specs:
                self._finish_task(q, w, spec.task_id, spec.traceparent)
            for w, tid in created:
                self._finish_task(q, w, tid)
            # success only: a propagating failure leaves the stages
            # RUNNING for _finish_query_stats to close as FAILED
            if sys.exc_info()[0] is None:
                prod_stage.state = "FINISHED"
                merge_stage.state = "FINISHED"

        schema = dict(bucket_root.output_schema())
        merged = pages_wire.merge_payloads(payloads, schema)
        page = stage_page(merged, schema, device=self.local.device)
        if rest_root is None:
            return page
        rest_remote = [
            n
            for n in N.walk(rest_root)
            if isinstance(n, N.RemoteSourceNode)
        ]
        local_scans = [
            n
            for n in N.walk(rest_root)
            if isinstance(n, N.TableScanNode)
        ]
        pages = [page] + [
            self.local._load_table(s) for s in local_scans
        ]
        return self.local._run_with_pages(
            rest_root, rest_remote + local_scans, pages
        )

    def _ranged_tasks(
        self, workers, ranges, make_spec, consume,
        q: Optional[_Query] = None, retry=True, speculate=False,
    ):
        """Dynamic split placement shared by the gather and shuffle
        paths: over-partitioned ranges in a queue, each worker's thread
        pulls the next unclaimed range (work stealing by queue).
        ``consume(w, spec)`` runs after the task POST (pull pages, or
        await FINISH); its results are collected in arbitrary order.

        Fault tolerance (``retry=True``, the gather path): a DEAD
        worker's range is re-POSTed to a live worker, bounded by the
        query's ``task_retry_budget`` (generalizing the old
        retry-once); every failure feeds the worker's circuit breaker,
        and a range headed for a breaker-open worker re-routes without
        consuming budget. ``speculate=True`` additionally launches ONE
        backup attempt on another live worker when a range runs past
        the straggler threshold — ``max(speculation_min_s,
        speculation_multiplier x p50)`` of this stage's completed-range
        durations (reservoir quantiles) — first result wins, the loser
        is aborted and DELETEd. ``retry=False`` (shuffle producers)
        disables both: the pipelined shuffle must NOT re-produce a
        range whose first task was already announced to merge tasks,
        or its rows double-count. Execution errors inside a healthy
        worker are never retried — they would fail anywhere."""
        import queue as _queue
        from concurrent.futures import ThreadPoolExecutor

        session = self.local.session
        spec_on = (
            speculate
            and retry
            and bool(session.get("speculation_enabled"))
            and len(workers) > 1
        )
        spec_min = float(session.get("speculation_min_s"))
        spec_mult = float(session.get("speculation_multiplier"))
        # completed-range durations for THIS stage; the reservoir
        # quantiles set the straggler threshold
        durations = DistributionStat()

        def straggler_threshold() -> Optional[float]:
            v = durations.values()
            if v["count"] < 3:
                return None  # too few samples to call a straggler
            th = max(spec_min, spec_mult * v["p50"])
            if self.qos is not None and q is not None:
                # deadline-aware speculation (server/qos.py): the
                # threshold tightens as the query approaches its
                # group's SLO budget
                th *= self.qos.speculation_scale(q)
            return th

        def spare_worker(tried_ids):
            # exclude BEFORE the breaker check: asking for a spare
            # must not consume an already-tried worker's probe slot
            alive = self.active_workers(exclude=tried_ids)
            return alive[0] if alive else None

        def run_range(w, lo, hi):
            if not retry:
                # non-recoverable stage (shuffle producer under
                # retry_policy=NONE): no retry, no speculation — run
                # the single attempt inline instead of paying a
                # monitor thread per range. One exception: a DRAINING
                # worker answers the POST with 503 and creates NO task,
                # so re-routing the untouched spec to a spare is free
                # and safe even for pipelined exchanges.
                spec = make_spec(lo, hi)
                target, rerouted = w, set()
                while True:
                    try:
                        rpc.call_json(
                            "POST",
                            target.uri + "/v1/task",
                            spec.to_json(),
                            policy=self._rpc_policy,
                            traceparent=spec.traceparent,
                        )
                        break
                    except urllib.error.HTTPError as e:
                        if e.code != 503:
                            raise
                        rerouted.add(target.node_id)
                        alt = spare_worker(rerouted)
                        if alt is None:
                            raise
                        target = alt
                    except Exception as e:
                        # connection-level POST failure: the breaker
                        # must learn about the dead worker even though
                        # this stage cannot retry
                        if rpc.is_retryable(e):
                            self._worker_failed(target)
                        raise
                try:
                    out = consume(target, spec)
                    self._worker_ok(target)
                    return out
                except Exception as e:
                    if rpc.is_retryable(e):
                        self._worker_failed(target)
                    raise
            cond = threading.Condition()
            state = {
                "attempts": [], "active": 0, "winner": None,
                "result": None, "fatal": None, "conn_errors": [],
            }

            def attempt(worker, spec, backup):
                try:
                    rpc.call_json(
                        "POST", worker.uri + "/v1/task", spec.to_json(),
                        policy=self._rpc_policy,
                        traceparent=spec.traceparent,
                    )
                    out = consume(worker, spec)
                    self._worker_ok(worker)
                    with cond:
                        if state["winner"] is None:
                            state["winner"] = spec.task_id
                            state["result"] = out
                            if backup:
                                REGISTRY.counter(
                                    "coordinator.speculation_wins"
                                ).update()
                except Exception as e:
                    # a 404 on a task endpoint means the worker lost
                    # the task (crash + restart under the same URI);
                    # a 503 means it is DRAINING and created nothing:
                    # both recoverable, like a dead socket. Other HTTP
                    # errors (a FAILED task's 500) are execution
                    # failures — they would fail anywhere.
                    recoverable = rpc.is_task_recoverable(e)
                    if recoverable:
                        if not _is_draining_503(e) and (
                            q is None
                            or getattr(q, "_mem_kill", None) is None
                        ):
                            # a graceful drain is not a failure, and
                            # neither is a memory-pressure kill (the
                            # 404s on the victim's DELETEd tasks come
                            # from the kill, not worker health): no
                            # breaker penalty for either
                            self._worker_failed(worker)
                        with cond:
                            state["conn_errors"].append(e)
                    else:
                        with cond:
                            if state["fatal"] is None:
                                state["fatal"] = e
                finally:
                    with cond:
                        state["active"] -= 1
                        cond.notify_all()

            def launch(worker, backup=False):
                # register synchronously: the monitor loop must never
                # observe active == 0 for a launched-but-unstarted
                # attempt. Re-launches of this range keep the logical
                # task id and bump only the attempt (server.task_ids):
                # spool dedup and per-stage attempt counters key on it
                with cond:
                    prior = (
                        state["attempts"][-1][1]
                        if state["attempts"]
                        else None
                    )
                spec = (
                    make_spec(lo, hi)
                    if prior is None
                    else self._retry_spec(q, prior)
                )
                if backup and q is not None:
                    with q._stats_lock:
                        q._speculative.add(spec.task_id)
                with cond:
                    state["attempts"].append((worker, spec))
                    state["active"] += 1
                threading.Thread(
                    target=attempt, args=(worker, spec, backup),
                    daemon=True,
                ).start()

            # a range headed for a breaker-OPEN worker re-routes for
            # free (not a failure retry: the breaker already knows).
            # peek(), not allow(): this worker was already admitted by
            # active_workers() at scheduling — consuming a second
            # half-open probe slot here would strand its own probe.
            primary = w
            if retry and self._breaker(w.node_id).peek() == "OPEN":
                alt = spare_worker({w.node_id})
                if alt is not None:
                    primary = alt
            launch(primary)
            t0 = time.monotonic()
            speculated = False
            while True:
                with cond:
                    winner = state["winner"]
                    fatal = state["fatal"]
                    active = state["active"]
                    last_err = (
                        state["conn_errors"][-1]
                        if state["conn_errors"]
                        else None
                    )
                if winner is not None or fatal is not None:
                    break
                if active == 0:
                    # every attempt died on a connection failure:
                    # budget-bounded reassignment to a live worker
                    tried = {
                        wk.node_id for wk, _ in state["attempts"]
                    }
                    nxt = spare_worker(tried) if retry else None
                    # a drain rejection re-routes for FREE: the task
                    # was never created, nothing was lost — charging
                    # the retry budget would let task_retry_budget=0
                    # break the drain protocol's zero-failure promise
                    free = _is_draining_503(last_err)
                    if nxt is None or q is None or (
                        not free and not self._take_retry(q)
                    ):
                        raise last_err or NoLiveWorkers(
                            "no live worker for range "
                            f"[{lo}, {hi})"
                        )
                    if free:
                        REGISTRY.counter(
                            "coordinator.drain_reroutes"
                        ).update()
                        launch(nxt)
                        continue
                    self._record_recovery(q)
                    with q.trace.span(
                        "recovery", phase="task-retry",
                        range=f"[{lo}, {hi})",
                    ):
                        launch(nxt)
                    continue
                if spec_on and not speculated:
                    th = straggler_threshold()
                    if th is not None and time.monotonic() - t0 > th:
                        tried = {
                            wk.node_id for wk, _ in state["attempts"]
                        }
                        backup_w = spare_worker(tried)
                        if backup_w is not None:
                            speculated = True
                            REGISTRY.counter(
                                "coordinator.tasks_speculated"
                            ).update()
                            launch(backup_w, backup=True)
                # wait for progress — re-checking the predicate under
                # the lock first, so a completion that landed between
                # the read above and this wait is never slept through.
                # The periodic wakeup exists only for the straggler
                # timer; without speculation armed, sleep until the
                # attempt resolves (notify_all always fires).
                with cond:
                    if (
                        state["winner"] is None
                        and state["fatal"] is None
                        and state["active"] > 0
                    ):
                        cond.wait(
                            timeout=0.05
                            if spec_on and not speculated
                            else None
                        )
            if fatal is not None:
                # execution failure: tear down every attempt of this
                # range (an in-flight backup must not leak its task)
                if q is not None:
                    for wk, sp in state["attempts"]:
                        self._abort_task(q, wk, sp)
                raise fatal
            # first result won: abort + DELETE the losing attempts
            # (their stats fold in as provisional snapshots and are
            # closed out with the query)
            if q is not None:
                for wk, sp in state["attempts"]:
                    if sp.task_id != winner:
                        self._abort_task(q, wk, sp)
            dur = time.monotonic() - t0
            durations.add(dur)
            REGISTRY.distribution("coordinator.range_time_s").add(dur)
            return state["result"]

        range_q: "_queue.Queue" = _queue.Queue()
        for r in ranges:
            range_q.put(r)
        #: set when a range failed for good: the stage raises that
        #: failure once the claimed ranges end, so the other threads
        #: claim nothing more (a QUERY restart must not wait for the
        #: survivors to drain a queue whose results are dropped)
        failed = threading.Event()

        def drain_worker(w):
            out = []
            while True:
                # QoS preempt-and-resume: a suspended query's stage
                # threads park HERE, between ranges — claimed ranges
                # ran to completion (tasks exit clean, spool-backed
                # producers committed), unclaimed ones wait out the
                # suspension and re-run under fresh claims on resume
                self._qos_checkpoint(q)
                if failed.is_set():
                    return out
                try:
                    lo, hi = range_q.get_nowait()
                except _queue.Empty:
                    return out
                try:
                    out.append(run_range(w, lo, hi))
                except BaseException:
                    failed.set()
                    raise

        with ThreadPoolExecutor(max(len(workers), 1)) as pool:
            futs = [pool.submit(drain_worker, w) for w in workers]
            return [r for f in futs for r in f.result()]

    def _wait_task(self, w, spec) -> None:
        """Poll a producer task to completion (its pages stay buffered
        for the merge stage; nothing is pulled here). Monotonic-clock
        deadline: a wall-clock jump can neither fire nor suppress the
        task timeout."""
        deadline = time.monotonic() + float(
            self.local.session.get("query_max_run_time_s")
        )
        while True:
            if time.monotonic() > deadline:
                raise TimeoutError(f"task {spec.task_id} timed out")
            st = self._rpc_json(
                "GET", f"{w.uri}/v1/task/{spec.task_id}/status",
                traceparent=spec.traceparent,
            )
            state = st.get("state")
            if state == "FINISHED":
                return
            if state == "FAILED":
                raise RuntimeError(
                    f"task on {w.node_id} failed: {st.get('error')}"
                )
            time.sleep(0.03)

    def _pull_task(self, w, spec) -> List[tuple]:
        """Token-acked page pulls until X-Complete (exchange client):
        the shared rpc.pull_pages loop, with a stall hook that polls
        task status so a FAILED task surfaces its worker-side error
        text. Monotonic-clock deadline (see _wait_task).

        ICI gather edge: when the task's stage was planned on this
        coordinator's own slice (single-partition root output,
        single-program mode), its output is taken straight from the
        in-slice segment, with no serialization and no HTTP page loop.
        The HTTP pull stays the fallback (a worker whose output missed
        the lane materializes it on the first read), and the caller
        still DELETEs the task."""

        def stall():
            st = self._rpc_json(
                "GET", f"{w.uri}/v1/task/{spec.task_id}/status"
            )
            if st.get("state") == "FAILED":
                raise RuntimeError(
                    f"task on {w.node_id} failed: {st.get('error')}"
                )
            time.sleep(0.05)

        if (
            spec.ici_slice
            and spec.ici_slice == self.slice_id
            and bool(self.local.session.get("exchange_single_program"))
        ):
            def probe() -> bool:
                # liveness and terminality for the segment wait: FAILED
                # surfaces the worker's error; FINISHED answers False so
                # the gather re-checks seal-or-never at once
                try:
                    st = self._rpc_json(
                        "GET", f"{w.uri}/v1/task/{spec.task_id}/status"
                    )
                except Exception:
                    return False
                if st.get("state") == "FAILED":
                    raise RuntimeError(
                        f"task on {w.node_id} failed: {st.get('error')}"
                    )
                return st.get("state") not in ("FINISHED", "ABORTED")

            got = exchange_spi.ici_gather(
                self.slice_id,
                spec,
                time.monotonic()
                + float(self.local.session.get("query_max_run_time_s")),
                probe,
            )
            if got is not None:
                q = self.queries.get(spec.query_id)
                if q is not None:
                    # a coordinator-side consume: fold it under the
                    # delta-guard lock like the other coordinator-local
                    # stat additions
                    with q.stats._roll_lock:
                        q.stats.exchange_ici_edges += 1
                return got

        try:
            return rpc.pull_pages(
                w.uri, spec.task_id, 0,
                policy=self._rpc_policy,
                deadline_s=float(
                    self.local.session.get("query_max_run_time_s")
                ),
                traceparent=spec.traceparent,
                stall=stall,
                timeout_msg=f"task {spec.task_id} timed out",
            )
        except urllib.error.HTTPError as e:
            if e.code == 500:
                # the task FAILED: surface the worker's error text,
                # not a bare HTTP status
                st = self._rpc_json(
                    "GET", f"{w.uri}/v1/task/{spec.task_id}/status"
                )
                raise RuntimeError(
                    f"task on {w.node_id} failed: {st.get('error')}"
                ) from e
            raise

    # ------------------------------------------------------------ helpers

    def _rpc_json(
        self, method: str, url: str, body=None, traceparent: str = ""
    ) -> dict:
        """Coordinator->worker JSON RPC under the coordinator's policy
        (config-driven timeout, bounded backoff retries for idempotent
        calls, trace propagation, fault-plane hooks)."""
        return rpc.call_json(
            method, url, body,
            policy=self._rpc_policy, traceparent=traceparent,
        )

    def _store_result(self, q: _Query, res) -> None:
        q.columns = [
            {"name": c} for c in res.columns
        ]
        q.rows = [list(r) for r in res.rows()]


def _passes_through(node: N.PlanNode, col: str) -> bool:
    """Does ``col`` pass this probe-side node unchanged (so a dynamic
    filter on it may constrain the SCAN's split enumeration)? Filters
    preserve every column; a projection must map it to its own bare
    ColumnRef. Anything else (a lower join's renames, unnest, ...)
    disqualifies the column — the fused predicate still applies."""
    from presto_tpu_torch import expr as E

    if isinstance(node, N.FilterNode):
        return True
    if isinstance(node, N.ProjectNode):
        for name, expr in node.projections:
            if name == col:
                return isinstance(expr, E.ColumnRef) and expr.name == col
        return False
    return False


class _Server(ThreadingHTTPServer):
    #: listen backlog: a burst of concurrent clients (a serving fleet
    #: submitting into one batch window) must queue for accept, not be
    #: reset; socketserver's default is 5
    request_queue_size = 128


def _make_handler(coord: CoordinatorServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _json(self, code: int, obj, extra_headers=None) -> None:
            # default=str: result rows may carry dates/decimals; the
            # oracle-compatible wire form is their string rendering
            body = json.dumps(obj, default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n)

        def do_POST(self):
            parts = [p for p in self.path.split("/") if p]
            if parts == ["v1", "statement"]:
                from presto_tpu_torch.server import protocol

                # a dying coordinator must not ACK a statement it
                # cannot journal (the ack promises a resumable query):
                # 503 = "nothing admitted", which the spray client
                # re-targets at a peer duplicate-free
                if coord._shutting_down:
                    return self._json(
                        503, {"error": "coordinator shutting down"}
                    )
                sql = self._read_body().decode()
                user = self.headers.get("X-Presto-User", "presto_tpu")
                # client-owned prepared statements ride per-request
                # headers (server.protocol): EXECUTE resolves against
                # this map first
                prepared = protocol.decode_prepared(
                    self.headers.get_all(
                        protocol.PREPARED_STATEMENT_HEADER
                    )
                )
                q = coord.submit(sql, user=user, prepared=prepared)
                # re-check AFTER submit: a kill that raced past the
                # gate above may have dropped the journal before the
                # frame landed — refuse the ACK (the client resubmits
                # at a peer; a frame that DID land resumes there too,
                # which is the journal's at-least-once contract)
                if coord._shutting_down:
                    return self._json(
                        503, {"error": "coordinator shutting down"}
                    )
                return self._json(
                    200,
                    {
                        "id": q.qid,
                        "nextUri": f"{coord.uri}/v1/statement/{q.qid}/0",
                    },
                )
            if len(parts) == 3 and parts[:2] == ["v1", "ingest"]:
                # streaming ingest: POST /v1/ingest/{table} with
                # {"rows": [{col: val}, ...]} or {"columns": {col:
                # [values]}}; {"commit": true} forces a synchronous fold
                # instead of waiting for the commit loop. The batch is
                # durable (WAL-framed) once this returns, visible at
                # its commit
                raw = self._read_body()
                if coord.ingest is None:
                    return self._json(
                        503,
                        {
                            "error": "ingest lane not configured "
                            "(set ingest.wal-path)"
                        },
                    )
                try:
                    body = json.loads(raw or b"{}")
                    out = coord.ingest.append(
                        parts[2],
                        columns=body.get("columns"),
                        rows=body.get("rows"),
                    )
                    if body.get("commit"):
                        coord.ingest.flush()
                        out["committed"] = True
                    return self._json(200, out)
                except Exception as e:
                    return self._json(
                        400, {"error": f"{type(e).__name__}: {e}"}
                    )
            self._json(404, {"error": f"no route {self.path}"})

        def do_PUT(self):
            parts = [p for p in self.path.split("/") if p]
            if parts == ["v1", "announcement"]:
                d = json.loads(self._read_body().decode())
                coord.announce(
                    d["node_id"], d["uri"], d.get("state", "ACTIVE"),
                    preemptible=bool(d.get("preemptible", False)),
                    memory=d.get("memory"),
                    slice_id=d.get("slice_id", ""),
                    device_coords=d.get("device_coords", ()),
                    backend_diag=d.get("backend_diag"),
                    role=d.get("role", ""),
                )
                # the ack names this coordinator incarnation: workers
                # track the boot nonces they have heard from so the
                # orphan reaper can tell "my coordinator restarted"
                # from "my coordinator is briefly quiet"
                return self._json(
                    200,
                    {
                        "ok": True,
                        "node_id": coord.coord_id,
                        "boot": coord._boot,
                    },
                )
            self._json(404, {"error": f"no route {self.path}"})

        def do_GET(self):
            parts = [p for p in self.path.split("/") if p]
            if parts == ["v1", "cluster"]:
                return self._json(
                    200,
                    {
                        "workers": [
                            {"node_id": w.node_id, "uri": w.uri}
                            for w in coord.active_workers()
                        ]
                    },
                )
            if parts == ["v1", "metrics"]:
                body = REGISTRY.render_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if parts == ["v1", "metrics", "cluster"]:
                # cluster metrics federation: the coordinator's own
                # exposition plus every TTL-live worker's, re-emitted
                # with node="<id>" labels and a node="cluster" sum of
                # the monotone families (utils/telemetry.py)
                body = coord.cluster_metrics().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if (
                len(parts) == 4
                and parts[:2] == ["v1", "query"]
                and parts[3] == "progress"
            ):
                # live query progress, consumable MID-query: per-stage
                # splits done/total + rows/bytes/dispatches and a
                # history-derived ETA. Must be routed BEFORE the
                # len==3 QueryInfo route.
                x = coord.lookup_query(parts[2])
                if x is None:
                    return self._json(404, {"error": "no such query"})
                return self._json(200, coord.query_progress(x))
            if parts == ["v1", "query"]:
                # query listing (reference: GET /v1/query)
                with coord._lock:
                    qs = list(coord.queries.values())
                return self._json(
                    200, [coord.query_summary(x) for x in qs]
                )
            if len(parts) == 3 and parts[:2] == ["v1", "query"]:
                # full QueryInfo incl. stage/task stats + span tree
                # (reference: GET /v1/query/{id}); works mid-flight.
                # lookup_query follows restart aliases: ids minted by
                # a dead coordinator incarnation resolve to their
                # journal-resumed runs
                x = coord.lookup_query(parts[2])
                if x is None:
                    return self._json(404, {"error": "no such query"})
                return self._json(200, coord.query_info(x))
            if len(parts) == 4 and parts[:2] == ["v1", "statement"]:
                qid, token = parts[2], int(parts[3])
                q = coord.lookup_query(qid)
                if q is None:
                    # multi-coordinator alias lookup: a sprayed (or
                    # failed-over) client may land here holding a
                    # statement another live coordinator serves —
                    # redirect via its lease payload. Loop-free:
                    # coordinators only advertise qids they can
                    # resolve locally
                    peer = coord.locate_peer(qid)
                    if peer:
                        return self._json(
                            200,
                            {
                                "id": qid,
                                "nextUri": (
                                    f"{peer}/v1/statement/{qid}/{token}"
                                ),
                            },
                        )
                    return self._json(404, {"error": "no such query"})
                if q.state == "SUSPENDED" and not q.done.is_set():
                    # QoS preempt-and-resume: a parked query must not
                    # hold its client on the long-poll — answer NOW
                    # with empty data and a retry hint, keeping the
                    # poll loop alive (and cheap) until resume
                    return self._json(
                        200,
                        {
                            "id": qid,
                            "stats": {"state": "SUSPENDED"},
                            "data": [],
                            "nextUri": (
                                f"{coord.uri}/v1/statement/{qid}/"
                                f"{token}"
                            ),
                        },
                        extra_headers={"Retry-After": "0.5"},
                    )
                # long-poll up to 1s for progress (reference: long-poll)
                q.done.wait(timeout=1.0)
                # q.error decides failure delivery alongside the state
                # string: the client must get the error, never an empty
                # success page
                if q.state == "FAILED" or (
                    q.done.is_set() and q.error is not None
                ):
                    q._drained = True  # error delivered: safe to evict
                    return self._json(
                        200,
                        {
                            "id": qid,
                            "error": q.error,
                            "stats": {"state": "FAILED"},
                        },
                    )
                if not q.done.is_set():
                    return self._json(
                        200,
                        {
                            "id": qid,
                            "stats": {"state": q.state},
                            "nextUri": (
                                f"{coord.uri}/v1/statement/{qid}/{token}"
                            ),
                        },
                    )
                lo = token * RESULT_PAGE_ROWS
                hi = min(lo + RESULT_PAGE_ROWS, len(q.rows))
                out = {
                    "id": qid,
                    "columns": q.columns,
                    "data": q.rows[lo:hi],
                    "stats": {"state": "FINISHED"},
                }
                if hi < len(q.rows):
                    out["nextUri"] = (
                        f"{coord.uri}/v1/statement/{qid}/{token + 1}"
                    )
                else:
                    q._drained = True  # last page served
                # prepared-statement session updates ride the result
                # response (server.protocol): the client folds them
                # into the map it replays on future requests
                extra = {}
                if q.added_prepare is not None:
                    from presto_tpu_torch.server import protocol

                    name, text = q.added_prepare
                    # echo once: only on the FIRST result page, and
                    # only when the client's replayed map does not
                    # already carry the identical statement — a client
                    # that knows the name must not re-absorb (and
                    # re-serialize) it on every page of every request
                    if token == 0 and q.prepared.get(name) != text:
                        extra[protocol.ADDED_PREPARE_HEADER] = (
                            protocol.encode_prepared(name, text)
                        )
                if q.deallocated_prepare is not None:
                    from presto_tpu_torch.server import protocol

                    extra[protocol.DEALLOCATED_PREPARE_HEADER] = (
                        q.deallocated_prepare
                    )
                return self._json(200, out, extra_headers=extra)
            self._json(404, {"error": f"no route {self.path}"})

    return Handler


# ------------------------------------------------- ordered MERGE exchange


def _merge_sorted_runs(payloads, schema, sort_node):
    """K-way merge of per-page sorted runs into one globally ordered
    staging payload (reference: MergeOperator consuming an ordered
    exchange — SURVEY.md §2.4 "ordered MERGE").

    Each wire page is a sorted run (workers apply the pushed-down root
    sort per batch — for TopN that truncates each run to ``limit`` rows
    BEFORE it crosses the wire, which is where the exchange saves its
    bandwidth). Dictionary columns are first remapped into one id space
    (merge_payloads), whose union dictionary is sorted — ids stay
    order-preserving, so key comparison is pure int64. The run-merge is
    expressed as a stable vectorized np.lexsort over the concatenated
    runs rather than an interpreter-level k-way heap: numpy's O(n log n)
    beats a per-row Python heap by orders of magnitude at gather sizes,
    and stability keeps ties in (run, position) order like the
    reference's MergeOperator. ``sort_node.limit`` truncates the
    output."""
    from presto_tpu_torch.connectors.tpch import DictColumn
    from presto_tpu_torch.exec.host_ops import orderable_np
    from presto_tpu_torch.exec.staging import MaskedColumn

    merged = pages_wire.merge_payloads(payloads, schema)
    run_lens = [n for _, _, n in payloads]
    total = sum(run_lens)

    # least-significant-first key list for np.lexsort (mirrors
    # exec.host_ops._host_sort_perm)
    lex = []
    for k in reversed(list(sort_node.keys)):
        name = k.expr.name
        col = merged[name]
        if isinstance(col, MaskedColumn):
            data, valid = col.data, col.valid
        elif isinstance(col, DictColumn):
            data, valid = col.ids, None
        else:
            data, valid = col, None
        t = schema[name]
        img = orderable_np(np.asarray(data), t)
        if k.descending:
            img = ~img
        nf = (
            k.nulls_first if k.nulls_first is not None else k.descending
        )
        if valid is None:
            null_rank = np.zeros(total, np.int64)
        else:
            null_rank = np.where(valid, 0, -1 if nf else 1).astype(
                np.int64
            )
        lex.append(img)
        lex.append(null_rank)
    perm = np.lexsort(lex) if lex else np.arange(total)
    if sort_node.limit is not None:
        perm = perm[: sort_node.limit]

    out = {}
    for name, col in merged.items():
        if isinstance(col, MaskedColumn):
            out[name] = MaskedColumn(
                data=col.data[perm],
                valid=col.valid[perm],
                values=col.values,
            )
        elif isinstance(col, DictColumn):
            out[name] = DictColumn(ids=col.ids[perm], values=col.values)
        else:
            out[name] = col[perm]
    return out

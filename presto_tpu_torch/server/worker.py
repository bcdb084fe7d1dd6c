"""Worker process: executes plan fragments on its runner's device.

The PyTorch counterpart of ``presto_tpu/server/worker.py``. Reference
parity: the worker task runtime — ``TaskResource``
(``POST /v1/task/{id}``), ``SqlTaskManager``, task status long-poll, the
producer side of the paged exchange (``OutputBuffer`` +
``GET /v1/task/{id}/results/{buffer}/{token}``), graceful shutdown
(SURVEY.md §2.1 "Task runtime", §2.5, §5.3). The device runtime is the
worker's own ``LocalQueryRunner`` on one CUDA device (``device=None``
means CUDA and raises without a card, as the runner does; tests pass
``device="cpu"``); this module is the HTTP host agent.

Execution: a task = FragmentSpec (plan fragment + owned row range of the
partitioned scan). Replicated scans load in full; the partitioned scan
streams split batches staged through the runner's split cache, each
batch run by ``runner._run_with_pages`` (a GROUP BY there is one
``onehot_reduce_many`` launch, K1, per batch); result pages are
serialized into the task's output buffer, pulled token-acked by the
coordinator, and freed on DELETE.

Fault-tolerant execution (``exchange.spool-path``, a spec's ``spool``
flag): partitioned output pages are teed into the shared durable spool
(``server/spool.py``) off the producer thread, the attempt is sealed
(committed, or discarded) before FINISHED is visible, and a merge task
whose producer died re-serves that producer's committed partition from
the spool.

Preemptible capacity (``node.preemptible``, the elastic pool): the
worker announces the flag, so the scheduler keeps merge stages on
stable nodes, and a preemption notice (``preempt``; SIGTERM in the
launcher, or the ``kill_worker_preempt`` fault rule) drains it within
``pool.preempt-grace-s``.

The in-slice (ICI) lane (``exchange_spi``): a task planned on this
worker's slice (``FragmentSpec.ici_slice``, the announced
``exchange.slice-id``) keeps its partitioned output on the device and
publishes it, with each row's destination, to the process's segment,
sealed before FINISHED is visible; a merge task takes its partition out
of the co-located producers' pages (one routing pass per stage with
``exchange.single-program``, else a gather per source) and falls back to
the HTTP pull, then the spool, when a producer's entry is missing. A
draining worker, and an HTTP pull of a FINISHED in-slice task,
materialize the entry into the serialized buffers first.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from presto_tpu_torch.connectors.spi import ConnectorSplit
from presto_tpu_torch.exec.staging import (
    bucket_capacity,
    page_nbytes,
    stage_page,
)
from presto_tpu_torch.exec.stats import TaskStats
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.server import exchange_spi, pages_wire, rpc, task_ids
from presto_tpu_torch.server.protocol import FragmentSpec
from presto_tpu_torch.server.spool import (
    DEFAULT_DRAIN_DEPTH,
    ExchangeSpool,
    SpoolDrain,
)
from presto_tpu_torch.utils import devicediag, faults, tracing
from presto_tpu_torch.utils.metrics import REGISTRY

log = logging.getLogger("presto_tpu_torch.worker")


class WorkerDraining(RuntimeError):
    """New-task rejection while the worker drains (or shuts down):
    surfaced to the coordinator as HTTP 503, which reschedules the
    task on another worker instead of failing the query."""

#: rows per exchange page (the reference pages its exchange similarly)
PAGE_ROWS = 1 << 16

#: max unacked pages buffered per task before the producer blocks
#: (reference: bounded OutputBuffer / sink.max-buffer-size blocking the
#: producer driver, SURVEY.md §2.5 "Backpressure")
MAX_BUFFERED_PAGES = 64


def _offer_chunked(task: "_Task", cols, n: int) -> None:
    """Serialize wire columns into PAGE_ROWS-sized pages on the task's
    output buffer — the ONE chunk-and-offer loop every result-emitting
    path shares (streaming emit, single- and multi-remote merges)."""
    for lo in range(0, max(n, 1), PAGE_ROWS):
        hi = min(lo + PAGE_ROWS, n)
        chunk = [
            (name, d[lo:hi], None if v is None else v[lo:hi], t, dv)
            for name, d, v, t, dv in cols
        ]
        task.offer_page(pages_wire.serialize_page(chunk, hi - lo))
        with task.cond:
            task.stats.output_rows += hi - lo


class _Task:
    def __init__(
        self, spec: FragmentSpec, pool=None, node_id: str = "",
        spool: "ExchangeSpool" = None, drain: "SpoolDrain" = None,
    ):
        self.spec = spec
        self.state = "QUEUED"  # QUEUED|RUNNING|FINISHED|FAILED|ABORTED
        self.error: Optional[str] = None
        #: per-task stats, shipped back in /v1/task/{id}/status
        #: (reference: TaskStats on the task-status response)
        self.stats = TaskStats(
            task_id=spec.task_id,
            query_id=spec.query_id,
            node_id=node_id,
            create_time=time.time(),
        )
        #: trace context propagated by the coordinator (the handler
        #: folds the ``traceparent`` HTTP header into the spec)
        self.trace_ctx = tracing.parse_traceparent(spec.traceparent)
        #: synthesized span dicts, filled at task end (status payload)
        self.spans: List[dict] = []
        # one output buffer per partition (reference:
        # PartitionedOutputBuffer); unpartitioned tasks use buffer 0
        nparts = max(spec.n_partitions, 1)
        self.parts: List[List[Optional[bytes]]] = [
            [] for _ in range(nparts)
        ]
        #: durable-exchange spool (fault-tolerant execution): tee this
        #: task's PARTITIONED output pages so a consumer can re-serve
        #: them after this worker dies; committed at FINISH
        self._spool = spool if spec.spool and nparts > 1 else None
        #: background tee drain: when attached, EVERY spool append of
        #: this task funnels through its one thread (single-appender
        #: contract), and _run_task flushes it before the commit
        self._spool_drain = drain if self._spool is not None else None
        self.spooled = False  # committed to the spool
        self.part_acked: List[int] = [0] * nparts
        #: per-partition "consumer saw X-Complete" flags — the drain
        #: protocol waits on these (a draining worker must not exit
        #: under a consumer still pulling)
        self.complete_served: List[bool] = [False] * nparts
        self.cond = threading.Condition()
        self.created = time.time()
        # buffered output bytes are accounted against the worker's
        # MemoryPool under a task-scoped key: buffers outlive task
        # FINISH (shuffle consumers attach later), so the query-id
        # safety-net release at task end must not free them
        self.pool = pool
        self.buf_key = f"{spec.query_id}#buf#{spec.task_id}"
        # merge tasks: dynamically-attached upstream sources
        # (reference: addExchangeLocations + noMoreExchangeLocations)
        self.sources: List[tuple] = [tuple(s) for s in spec.sources]
        self.sources_done: bool = bool(spec.sources)
        #: dynamic-filter summary (JSON dict) of a dynfilter_keys task,
        #: set when the task finishes; shipped on the status response
        self.dynfilter: Optional[dict] = None
        #: the in-slice lane: its entry is degraded to the serialized
        #: buffers at most once (drain, or an HTTP pull of a FINISHED
        #: task), and a gather task seals only when its output rode the
        #: lane
        self._ici_mat_lock = threading.Lock()
        self._ici_mat_done = False
        self._ici_gather = False

    def add_sources(self, sources, done: bool) -> None:
        with self.cond:
            known = set(self.sources)
            for s in sources:
                s = tuple(s)
                if s not in known:
                    self.sources.append(s)
                    known.add(s)
            if done:
                self.sources_done = True
            self.cond.notify_all()

    def drop_buffers(self) -> None:
        """Release every remaining buffered byte (DELETE/abort path)."""
        if self.pool is not None:
            self.pool.release(self.buf_key, None)

    @property
    def pages(self) -> List[Optional[bytes]]:
        """Buffer 0 view (status reporting + unpartitioned pulls)."""
        return self.parts[0]

    def offer_page(self, page: bytes, part: int = 0) -> None:
        """Producer side: blocks while the buffer is full (backpressure);
        raises if the task was aborted while blocked.

        Partitioned (shuffle) buffers are stage-lifetime and exempt
        from the bounded-buffer wait: the merge stage attaches
        asynchronously (pipelined start) with no guarantee of pulling
        before this producer FINISHES, so blocking on a full buffer
        could deadlock the stage. They hold compressed PARTIAL states
        (small by construction) and every buffered byte is accounted
        against the MemoryPool — a too-big shuffle fails on accounting,
        not OOM. The bounded-buffer backpressure applies to the
        unpartitioned streaming path."""
        if self.pool is not None:
            # too-big shuffle output fails on ACCOUNTING
            # (MemoryLimitExceeded -> task FAILED), not on OOM. The
            # reserve runs BEFORE taking task.cond: a governance-lane
            # reserve may block waiting for headroom (and pressure
            # hooks may run spill DMA), and the condition guards the
            # result-serving handler threads, the same discipline as
            # the spool tee below. Only the producer thread appends
            # per (task, part), so nothing races the buffered bytes
            # between the reserve and the append; the abort path below
            # returns the reservation.
            self.pool.reserve(self.buf_key, len(page))
        try:
            with self.cond:
                while (
                    len(self.parts) == 1
                    and len(self.parts[part]) - self.part_acked[part]
                    >= MAX_BUFFERED_PAGES
                    and self.state == "RUNNING"
                ):
                    self.cond.wait(timeout=0.1)
                if self.state == "ABORTED":
                    raise RuntimeError("task aborted")
                self.parts[part].append(page)
                self.stats.output_bytes += len(page)
        except BaseException:
            # the page never reached the buffer: its reservation must
            # not leak into the task's release-all at teardown
            if self.pool is not None:
                self.pool.release(self.buf_key, len(page))
            raise
        # the spool tee runs OUTSIDE task.cond: disk I/O under the
        # condition would block the result-serving handler threads
        # behind every spooled page. Safe because pages are immutable
        # once buffered, the appends of one (task, part) all run on one
        # thread (the producer, or the drain when one is attached), and
        # commit (in _run_task's finally) flushes the drain first. The
        # page is a wire frame already on the host: the tee adds no
        # wait on the card
        if self._spool is not None:
            if self._spool_drain is not None:
                spool, tid = self._spool, self.spec.task_id

                def tee(page=page, part=part):
                    spool.append(tid, part, page)

                self._spool_drain.submit(tid, tee)
            else:
                self._spool.append(self.spec.task_id, part, page)

    def ack_below(self, token: int, part: int = 0) -> None:
        """Consumer side: pulling token N acks pages < N.

        Unpartitioned (streaming) buffers FREE acked pages — that is
        the backpressure contract. Partitioned (shuffle) buffers only
        advance the cursor: pages stay until DELETE, so a merge task
        retried on another worker can restart its pull at token 0
        without finding acked holes (silent data loss)."""
        with self.cond:
            pages = self.parts[part]
            if len(self.parts) == 1:
                freed = 0
                for i in range(
                    self.part_acked[part], min(token, len(pages))
                ):
                    if pages[i] is not None:
                        freed += len(pages[i])
                    pages[i] = None
                if freed and self.pool is not None:
                    self.pool.release(self.buf_key, freed)
            if token > self.part_acked[part]:
                self.part_acked[part] = token
            self.cond.notify_all()

    def abort(self) -> None:
        with self.cond:
            if self.state in ("QUEUED", "RUNNING"):
                self.state = "ABORTED"
            self.cond.notify_all()


class WorkerServer:
    """One worker process: HTTP host agent + local device execution."""

    def __init__(
        self,
        port: int = 0,
        node_id: Optional[str] = None,
        catalogs=None,
        coordinator_uri: Optional[str] = None,
        config=None,
        device=None,
        preemptible: Optional[bool] = None,
    ):
        from presto_tpu_torch.exec.local_runner import LocalQueryRunner
        from presto_tpu_torch.utils.memory import MemoryPool, parse_bytes

        from presto_tpu_torch.exec.staging import DEFAULT_CACHE_BYTES

        self.node_id = node_id or f"worker-{uuid.uuid4().hex[:8]}"
        # memory accounting is ALWAYS on (reference: MemoryPool wired
        # unconditionally in the worker; limit from tier-1 config)
        limit = parse_bytes(
            (config.get("query.max-memory-per-node") if config else None)
            or "8GB"
        )
        self.memory_pool = MemoryPool(limit)
        self.memory_pool.node_id = self.node_id
        # cluster memory governance (server/memory_arbiter.py): with
        # the gate ON, an over-budget reservation BLOCKS (visible on
        # the heartbeat report, resolvable by the coordinator's
        # low-memory killer) instead of failing outright; OFF is the
        # bit-exact fail-fast legacy path
        self._governance = bool(
            config.get("memory.governance-enabled", False)
            if config
            else False
        )
        if self._governance:
            self.memory_pool.block_timeout_s = float(
                config.get("memory.reserve-block-max-s", 30.0)
            )
        # device-resident split cache (tier-1: staging.cache-bytes,
        # 0 disables): the LRU byte budget + try_reserve discipline
        # make always-on safe on the worker hot path — repeated
        # queries over the same split ranges skip the connector read
        # and the host->device transfer entirely
        cache_raw = (
            config.get("staging.cache-bytes") if config else None
        )
        cache_bytes = (
            parse_bytes(cache_raw)
            if cache_raw is not None
            else DEFAULT_CACHE_BYTES
        )
        # device=None means CUDA and raises without a card: a worker
        # never carries on on the CPU unless asked to
        self.runner = LocalQueryRunner(
            catalogs=catalogs,
            device=device,
            memory_pool=self.memory_pool,
            staging_cache_bytes=cache_bytes,
        )
        if cache_bytes > 0:
            self.runner.session.set("stream_split_cache", True)
        # host-spill lane (degrade before you kill): under HBM
        # pressure, evicted split-cache pages offload to a host-RAM
        # pool of this budget and restage on demand — gated with the
        # governance plane so the default stays bit-exact pre-PR
        if self._governance:
            spill_raw = (
                config.get("memory.host-spill-bytes") if config else None
            )
            if spill_raw is not None:
                self.runner.split_cache.set_spill_budget(
                    parse_bytes(spill_raw)
                )
        prefetch = (
            config.get("staging.prefetch-depth") if config else None
        )
        if prefetch is not None:
            self.runner.session.set(
                "staging_prefetch_depth", int(prefetch)
            )
        # parameterized plan cache (plan/canonical.py): the worker's
        # share is fragment CANONICALIZATION — literal-variant fragments
        # of one shape hit this runner's compile cache — gated by the
        # same tier-1 keys as the coordinator
        pcen = config.get("plan.cache-enabled") if config else None
        if pcen is not None:
            self.runner.session.set("enable_plan_cache", bool(pcen))
        pce = config.get("plan.cache-entries") if config else None
        if pce is not None:
            self.runner.plan_cache.resize(int(pce))
        # per-operator observability (exec/stats.OperatorStats): worker
        # programs trace per-node row counters into TaskStats.operators,
        # shipped on the status response and rolled into QueryInfo —
        # the same tier-1 gate as the coordinator. The history STORE
        # stays coordinator-side (queries complete there); workers only
        # measure.
        opstats = (
            config.get("operator-stats.enabled") if config else None
        )
        if opstats is not None:
            self.runner.session.set(
                "enable_operator_stats", bool(opstats)
            )
        self.tasks: Dict[str, _Task] = {}
        self._lock = threading.Lock()
        self._shutting_down = False
        #: set by the fault plane's crash (``_fault_kill``): the worker's
        #: device memory counts as lost, so nothing it runs on seals
        self._killed = False
        # multi-coordinator discovery: one URI, a comma-separated
        # string, or a sequence — the worker heartbeats EVERY
        # coordinator (each runs its own arbiter/scheduler view), so
        # any survivor of a coordinator failover already knows this
        # worker. coordinator_uri keeps the first entry for existing
        # callers.
        if isinstance(coordinator_uri, str):
            self.coordinator_uris = [
                u.strip().rstrip("/")
                for u in coordinator_uri.split(",")
                if u.strip()
            ]
        else:
            self.coordinator_uris = [
                str(u).strip().rstrip("/")
                for u in (coordinator_uri or [])
                if str(u).strip()
            ]
        self.coordinator_uri = (
            self.coordinator_uris[0] if self.coordinator_uris else None
        )
        self._announcer: Optional[threading.Thread] = None
        # orphan-task reaper (task.orphan-ttl-s, 0 = off): announce
        # acks carry the answering coordinator's BOOT nonce, and every
        # qid embeds the boot of the coordinator that minted it — a
        # task whose minting boot has not been heard from in TTL is
        # orphaned (its coordinator died or was replaced; a failover
        # peer re-runs the query under ITS boot) and is deleted so a
        # dead fleet's buffers never pin worker memory
        self._orphan_ttl_s = float(
            config.get("task.orphan-ttl-s", 0.0) if config else 0.0
        )
        #: coordinator boot nonce -> last monotonic time heard from
        self._boot_seen: Dict[str, float] = {}
        # fault-tolerance plane: one RPC policy for worker->worker
        # shuffle pulls, config-driven announce cadence/timeout
        self._rpc_policy = rpc.RpcPolicy.from_config(config)
        self._announce_interval = float(
            config.get("announcement.interval-s", 1.0) if config else 1.0
        )
        self._announce_timeout = float(
            config.get("announcement.timeout-s", 5.0) if config else 5.0
        )
        fault_spec = (
            config.get("fault-injection.spec") if config else None
        )
        if fault_spec:
            faults.configure(fault_spec)
        # durable-exchange spool (fault-tolerant execution): a shared
        # directory every node mounts (exchange.spool-path); None when
        # unconfigured — retry_policy=NONE never touches it
        self.spool = ExchangeSpool.from_config(config)
        # off-hot-path spool tee: one background drain thread per
        # worker takes the retry-TASK tee's SPL1 writes off the
        # producer thread; _run_task flushes it before the commit
        # marker (commit-marker-last unchanged)
        self.spool_drain = (
            SpoolDrain(
                int(
                    config.get(
                        "exchange.spool-drain-depth",
                        DEFAULT_DRAIN_DEPTH,
                    )
                    if config
                    else DEFAULT_DRAIN_DEPTH
                )
            )
            if self.spool is not None
            else None
        )
        # single-program collective stages: the one routing pass per
        # merge stage and the ICI coordinator-gather publish (the
        # collective path always falls back to the per-source gather)
        self.single_program = bool(
            config.get("exchange.single-program", True) if config else True
        )
        # in-slice shuffle (server/exchange_spi.py): the slice identity
        # this worker announces. Workers of one slice exchange
        # partitioned output device to device through the process-local
        # segment; the default identity IS that co-location (device type
        # + process). A wrong override is safe (a segment miss pulls
        # HTTP).
        self.slice_id = str(
            (config.get("exchange.slice-id") if config else None)
            or exchange_spi.default_slice_id(self.runner.device)
        )
        self._draining = False
        self._drain_grace_s = float(
            config.get("drain.grace-s", 30.0) if config else 30.0
        )
        # preemptible capacity (elastic pools): announced to discovery
        # so the scheduler places gather/merge stages on stable nodes;
        # a preemption notice drains with this SHORT grace window
        self.preemptible = bool(
            preemptible
            if preemptible is not None
            else (config.get("node.preemptible", False) if config else False)
        )
        self._preempt_grace_s = float(
            config.get("pool.preempt-grace-s", 10.0) if config else 10.0
        )

        handler = _make_handler(self)
        self.httpd = _Server(("127.0.0.1", port), handler)
        self.port = self.httpd.server_address[1]
        self.uri = f"http://127.0.0.1:{self.port}"
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "WorkerServer":
        # boot-time device probe (utils/devicediag.py): once per
        # process — the structured diagnosis rides every announcement
        # and /v1/status from then on
        if devicediag.last_diag() is None:
            devicediag.probe_backend(self.runner.device)
        self._serve_thread.start()
        if self.coordinator_uris:
            self._announcer = threading.Thread(
                target=self._announce_loop, daemon=True
            )
            self._announcer.start()
        if self._orphan_ttl_s > 0:
            threading.Thread(
                target=self._reaper_loop, daemon=True
            ).start()
        return self

    def shutdown(self, graceful: bool = True) -> None:
        """Graceful: stop accepting work, finish running tasks, stop
        (reference: SHUTTING_DOWN protocol, SURVEY.md §5.3)."""
        self._shutting_down = True
        if graceful:
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                with self._lock:
                    busy = any(
                        t.state in ("QUEUED", "RUNNING")
                        for t in self.tasks.values()
                    )
                if not busy:
                    break
                time.sleep(0.05)
        # Only handshake with serve_forever if it actually ran (see
        # CoordinatorServer.shutdown).
        if self._serve_thread.is_alive():
            self.httpd.shutdown()
        self.httpd.server_close()
        if self.spool_drain is not None:
            self.spool_drain.close()

    # ------------------------------------------------------------- drain

    def drain(self, grace_s: Optional[float] = None) -> None:
        """Graceful drain (``PUT /v1/state/drain``; SIGTERM in the
        launcher): stop accepting tasks (503 to new POSTs — the
        coordinator reschedules them), announce ``DRAINING`` so the
        coordinator stops scheduling here, keep serving result pulls
        until every finished task's buffers are consumed or spooled,
        then exit clean — a rolling restart under live load loses zero
        queries (reference: the SHUTTING_DOWN protocol, upgraded with
        the durable-exchange spool)."""
        with self._lock:
            if self._draining or self._shutting_down:
                return
            self._draining = True
        REGISTRY.counter("worker.drains").update()
        log.info("node=%s draining", self.node_id)
        # flip discovery NOW instead of waiting out the announce cadence
        self._announce_once()
        # chaos hook: kill_worker_draining crashes us mid-drain (the
        # protocol must stay recoverable — consumers fall back to the
        # spool / task retry)
        faults.maybe_inject_drain(self.node_id, kill=self._fault_kill)
        # ICI edges degrade to HTTP: serialize every FINISHED task's
        # device-resident partitions into its output buffers, so a
        # consumer that has not taken its partition in the slice can
        # pull it over the wire (still-RUNNING tasks materialize
        # themselves at seal time: they observe _draining)
        with self._lock:
            tasks = list(self.tasks.values())
        for t in tasks:
            if t.spec.ici_slice:
                with t.cond:
                    finished = t.state == "FINISHED"
                if finished:
                    try:
                        self._materialize_ici(t)
                    except Exception:
                        log.warning(
                            "node=%s drain ICI materialize failed for %s",
                            self.node_id, t.spec.task_id, exc_info=True,
                        )
        grace = self._drain_grace_s if grace_s is None else grace_s
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline and not self._shutting_down:
            if not self._drain_busy():
                break
            time.sleep(0.05)
        log.info("node=%s drain complete, exiting", self.node_id)
        self.shutdown(graceful=False)

    def preempt(self, grace_s: Optional[float] = None) -> None:
        """Preemption notice (the cloud's SIGTERM-with-short-grace on
        preemptible capacity): an IMMEDIATE graceful drain bounded by
        ``pool.preempt-grace-s`` — announce DRAINING now (the
        coordinator reschedules everything new), finish what fits in
        the grace window, serve/spool finished buffers, exit. Running
        producers that spooled stay recoverable even when the grace
        expires mid-task (retry_policy=TASK re-runs only the lost
        work)."""
        with self._lock:
            if self._draining or self._shutting_down:
                return
        REGISTRY.counter("pool.preemptions").update()
        log.warning(
            "node=%s preemption notice: draining (grace %.1fs)",
            self.node_id,
            self._preempt_grace_s if grace_s is None else grace_s,
        )
        self.drain(
            grace_s=self._preempt_grace_s if grace_s is None else grace_s
        )

    def _fault_preempt(self) -> None:
        """Background preemption for the ``kill_worker_preempt`` fault
        rule: the notice arrives WHILE a task runs (the hook fires at
        task execute), so the drain must not block that task's
        thread."""
        threading.Thread(target=self.preempt, daemon=True).start()

    def _drain_busy(self) -> bool:
        """Anything left that exiting now would lose? Running/queued
        tasks; a FINISHED task whose buffers a consumer is still
        pulling (unless the spool holds a committed copy). FAILED and
        ABORTED buffers die with the worker by design."""
        with self._lock:
            tasks = list(self.tasks.values())
        for t in tasks:
            if t.state in ("QUEUED", "RUNNING"):
                return True
            if t.state != "FINISHED":
                continue
            if t.spooled:
                continue  # durable copy outlives this worker
            with t.cond:
                if not all(t.complete_served):
                    return True
        return False

    def _announce_state(self) -> str:
        return "DRAINING" if self._draining else "ACTIVE"

    def _memory_report(self) -> dict:
        """Per-query/per-owner memory accounting for the heartbeat
        (cluster memory governance: the coordinator's arbiter folds
        these into its cluster view) — the shared
        ``rollup_query_report`` fold over this node's pool snapshot
        plus the host-spill occupancy."""
        from presto_tpu_torch.exec.staging import SplitCache
        from presto_tpu_torch.utils.memory import rollup_query_report

        return rollup_query_report(
            self.memory_pool.snapshot(),
            SplitCache.OWNER,
            self.runner.split_cache.spill_used_bytes(),
        )

    def _announce_body(self) -> dict:
        return {
            "node_id": self.node_id,
            "uri": self.uri,
            "state": self._announce_state(),
            "preemptible": self.preemptible,
            # slice/device-coordinate identity: the scheduler groups
            # co-located workers by slice id and plans their
            # partitioned exchanges as device collectives
            "slice_id": self.slice_id,
            "device_coords": exchange_spi.device_coords(
                self.runner.device
            ),
            "memory": self._memory_report(),
            # boot-time device probe: the coordinator keeps the last
            # non-empty diagnosis per node (system.runtime.nodes)
            "backend_diag": devicediag.last_diag_dict(),
        }

    def _announce_once(self) -> None:
        """One best-effort, no-retry announcement to every coordinator
        (drain flips state immediately; failures fall back to the
        regular loop)."""
        body = self._announce_body()
        for uri in self.coordinator_uris:
            try:
                resp = rpc.call_json(
                    "PUT",
                    uri + "/v1/announcement",
                    body,
                    policy=rpc.RpcPolicy(
                        timeout_s=self._announce_timeout, retries=0
                    ),
                )
                self._saw_boot(resp)
            except Exception:
                pass

    def _saw_boot(self, resp) -> None:
        """Record the announce ack's coordinator boot nonce — the
        orphan reaper's liveness evidence per minting incarnation."""
        boot = (resp or {}).get("boot") if isinstance(resp, dict) else None
        if boot:
            self._boot_seen[str(boot)] = time.monotonic()

    #: announce backoff cap: a worker never goes quieter than this, so
    #: a recovered coordinator re-discovers it within ~2 TTLs
    ANNOUNCE_MAX_BACKOFF_S = 16.0

    def _announce_backoff(self, fails: int) -> float:
        """Delay before the next announcement: the healthy interval at
        ``fails == 0``, else jittered exponential backoff over
        [interval, min(interval * 2^fails, cap)] — never faster than
        the healthy cadence, never synchronized across peers (full
        jitter), never quieter than ANNOUNCE_MAX_BACKOFF_S."""
        if fails <= 0:
            return self._announce_interval
        cap = min(
            self._announce_interval * (2.0 ** min(fails, 6)),
            self.ANNOUNCE_MAX_BACKOFF_S,
        )
        return self._announce_interval + rpc.backoff_rng().uniform(
            0.0, max(cap - self._announce_interval, 0.0)
        )

    def _announce_loop(self):
        """Heartbeat to discovery — EVERY coordinator, each with its
        own failure count. A healthy loop announces every
        ``announcement.interval-s``; after consecutive failures to one
        coordinator its delay backs off exponentially (capped,
        resetting on success) — a fleet of workers must not hammer a
        restarting coordinator in lockstep (thundering herd). With
        peers, one dead coordinator backs ITS cadence off without
        quieting the heartbeats the live ones depend on: the loop
        wakes at the soonest per-coordinator due time."""
        fails = {u: 0 for u in self.coordinator_uris}
        due = {u: 0.0 for u in self.coordinator_uris}
        while not self._shutting_down:
            now = time.monotonic()
            body = self._announce_body()
            for uri in self.coordinator_uris:
                if now < due[uri]:
                    continue
                try:
                    # the loop IS the retry policy: no rpc-level
                    # retries, or backoff would stack on backoff
                    resp = rpc.call_json(
                        "PUT",
                        uri + "/v1/announcement",
                        body,
                        policy=rpc.RpcPolicy(
                            timeout_s=self._announce_timeout, retries=0
                        ),
                    )
                    self._saw_boot(resp)
                    fails[uri] = 0
                except Exception:
                    fails[uri] += 1
                    REGISTRY.counter("worker.announce_failures").update()
                due[uri] = time.monotonic() + self._announce_backoff(
                    fails[uri]
                )
            delay = max(min(due.values()) - time.monotonic(), 0.05)
            # sleep in short slices so shutdown is prompt even when
            # backed far off
            deadline = time.monotonic() + delay
            while (
                not self._shutting_down
                and time.monotonic() < deadline
            ):
                time.sleep(min(0.2, delay))

    def _reaper_loop(self) -> None:
        """Orphan-task reaper (``task.orphan-ttl-s``): delete tasks
        whose minting coordinator incarnation (the boot nonce embedded
        in every qid) has not been heard from — announce ack or new
        task — within the TTL. Rides the ONE task-teardown primitive
        (delete_task), so buffers and reservations free."""
        while not self._shutting_down:
            time.sleep(min(self._orphan_ttl_s / 4.0, 1.0))
            now = time.monotonic()
            with self._lock:
                snap = [
                    (tid, t.spec.query_id, t.created_ts)
                    for tid, t in self.tasks.items()
                ]
            for tid, qid, created in snap:
                boot = task_ids.boot_of_query(qid)
                if not boot:
                    continue  # not a coordinator-minted qid: never reap
                seen = max(self._boot_seen.get(boot, 0.0), created)
                if now - seen <= self._orphan_ttl_s:
                    continue
                if self.delete_task(tid):
                    REGISTRY.counter("worker.orphans_reaped").update()
                    log.warning(
                        "node=%s reaped orphan task %s (coordinator "
                        "boot %s silent %.1fs)",
                        self.node_id, tid, boot, now - seen,
                    )

    def _fault_kill(self) -> None:
        """Abrupt crash for the fault plane's ``kill_worker`` action:
        stop announcing and close the socket WITHOUT draining, so every
        in-flight coordinator RPC sees a dead peer (connection refused)
        — a real crash, not the graceful SHUTTING_DOWN protocol."""
        self._shutting_down = True
        self._killed = True
        try:
            if self._serve_thread.is_alive():
                self.httpd.shutdown()
            self.httpd.server_close()
        except Exception:
            pass
        # a crash loses the worker's device memory: its in-slice entries
        # go, and its still-running tasks seal none (_run_task)
        with self._lock:
            doomed = list(self.tasks)
        for tid in doomed:
            exchange_spi.discard_task(tid)
        log.warning("node=%s fault plane killed this worker", self.node_id)

    # ---------------------------------------------------------- task exec

    def create_task(self, spec: FragmentSpec) -> str:
        if self._draining or self._shutting_down:
            raise WorkerDraining("worker is draining")
        task = _Task(
            spec, pool=self.memory_pool, node_id=self.node_id,
            spool=self.spool, drain=self.spool_drain,
        )
        # orphan-reaper bookkeeping: the task itself is liveness
        # evidence for its minting coordinator boot (a coordinator
        # actively scheduling is not an orphan-maker even if this
        # worker's announce acks lag)
        task.created_ts = time.monotonic()
        boot = task_ids.boot_of_query(spec.query_id)
        if boot:
            self._boot_seen[boot] = task.created_ts
        with self._lock:
            self.tasks[spec.task_id] = task
        threading.Thread(
            target=self._run_task, args=(task,), daemon=True
        ).start()
        REGISTRY.counter("worker.tasks_created").update()
        return spec.task_id

    def _run_task(self, task: _Task) -> None:
        task.state = "RUNNING"
        task.stats.state = "RUNNING"
        trace_id = task.trace_ctx[0] if task.trace_ctx else ""
        log.info(
            "trace=%s task=%s node=%s state=RUNNING",
            trace_id, task.spec.task_id, self.node_id,
        )
        t0 = time.perf_counter()
        # this thread's engine-stats sink: the runner attributes
        # staging time, input rows/bytes, compile-cache hits, and
        # capacity-overflow retries to the active task
        self.runner._qs_local.value = task.stats
        outcome = "FINISHED"
        try:
            with REGISTRY.timer("worker.task_time").time():
                self._execute(task)
        except Exception as e:  # report to coordinator via status
            outcome = "FAILED"
            task.error = (
                f"{type(e).__name__}: {e}\n{traceback.format_exc()[-1000:]}"
            )
            REGISTRY.counter("worker.tasks_failed").update()
        finally:
            self.runner._qs_local.value = None
            task.stats.state = outcome
            task.stats.end_time = time.time()
            task.stats.wall_ms = (time.perf_counter() - t0) * 1000.0
            if task.trace_ctx is not None:
                task.spans = tracing.synthesize_task_spans(
                    trace_id=task.trace_ctx[0],
                    parent_span_id=task.trace_ctx[1],
                    task_id=task.spec.task_id,
                    node_id=self.node_id,
                    start=task.stats.create_time,
                    end=task.stats.end_time,
                    staging_ms=task.stats.staging_ms,
                    execute_ms=task.stats.execute_ms,
                    prefetch_ms=task.stats.prefetch_ms,
                )
            # seal the spooled attempt BEFORE the terminal state is
            # visible: FINISHED must imply the durable copy is complete
            # (consumers that see FINISHED may rely on the spool the
            # instant this worker dies); failed/aborted partial pages
            # must never serve
            if task._spool is not None:
                try:
                    if outcome == "FINISHED" and task.state != "ABORTED":
                        # drain flush BEFORE the commit marker: every
                        # teed frame must be on disk (and none failed)
                        # when the marker appears — a failed unit
                        # raises here and the attempt is discarded
                        # below instead of committed with a hole
                        if task._spool_drain is not None:
                            task._spool_drain.flush(task.spec.task_id)
                        task._spool.commit(task.spec.task_id)
                        task.spooled = True
                    else:
                        if task._spool_drain is not None:
                            task._spool_drain.forget(task.spec.task_id)
                        task._spool.discard(task.spec.task_id)
                except Exception:
                    log.warning(
                        "node=%s spool seal failed for %s",
                        self.node_id, task.spec.task_id, exc_info=True,
                    )
                    try:
                        task._spool.discard(task.spec.task_id)
                    except Exception:
                        pass
            # in-slice segment: seal BEFORE the terminal state is
            # visible (FINISHED implies the device copy is complete, the
            # spool-commit ordering). A DRAINING worker degrades its ICI
            # edges to HTTP at once. A gather task seals only when its
            # output rode the lane: an empty sealed entry beside real
            # pages in the serialized buffer would read as 'complete,
            # zero rows' to the coordinator's in-slice gather
            if (
                task.spec.ici_slice
                and task.spec.ici_slice == self.slice_id
                and (task.spec.n_partitions > 1 or task._ici_gather)
            ):
                try:
                    if (
                        outcome == "FINISHED"
                        and task.state != "ABORTED"
                        and not self._killed
                    ):
                        exchange_spi.seal_task(
                            self.slice_id, task.spec.task_id,
                            max(task.spec.n_partitions, 1),
                        )
                        if self._draining:
                            self._materialize_ici(task)
                    else:
                        freed = exchange_spi.discard_task(task.spec.task_id)
                        if freed:
                            self.memory_pool.release(task.buf_key, freed)
                except Exception:
                    log.warning(
                        "node=%s ici seal failed for %s",
                        self.node_id, task.spec.task_id, exc_info=True,
                    )
            # publish the terminal state LAST: it flips X-Complete on
            # the result stream, and the coordinator reads the final
            # status (stats + spans above) as soon as it sees it
            with task.cond:
                if task.state != "ABORTED":
                    task.state = outcome
                task.cond.notify_all()
            log.info(
                "trace=%s task=%s node=%s state=%s wall_ms=%.1f",
                trace_id, task.spec.task_id, self.node_id,
                task.state, task.stats.wall_ms,
            )
            # unpin replicated/whole-table cache entries this task
            # used, then free its batch-staging reservations
            self.runner.release_pins(task.stats)
            self.memory_pool.release(task.spec.query_id)

    def _execute(self, task: _Task) -> None:
        """Stream split batches of the partitioned scan through the
        compiled fragment (reference: split parallelism — drivers pull
        split batches through the pipeline, SURVEY.md §2.4). Per-batch
        outputs are partial states the coordinator's FINAL step merges,
        so batching is semantics-preserving; it also bounds device
        residency to one batch (the grouped-execution memory shape).
        ``task_concurrency`` drivers overlap host staging with device
        execution."""
        # chaos hook: an armed fault plane may delay this task, fail it
        # (kill_task), or crash the whole worker (kill_worker) here —
        # mid-execute from the coordinator's point of view, since the
        # task POST was already acked
        faults.maybe_inject_task(
            self.node_id, task.spec.task_id, kill=self._fault_kill,
            preempt=self._fault_preempt,
        )
        spec = task.spec
        if spec.sources or spec.partition_scan < 0:
            # merge task: static sources (barrier mode) or dynamically
            # attached ones (pipelined shuffle; partition_scan=-1)
            return self._execute_merge(task)
        root = spec.fragment
        # a pushed-down root sort (ordered MERGE exchange: coordinator
        # wraps the fragment in a SortNode so every emitted batch is a
        # sorted run) executes host-side per batch — the same
        # host-root-stage discipline that keeps XLA sort compiles out of
        # the per-query budget (exec.host_ops)
        from presto_tpu_torch.exec.host_ops import apply_host_ops, peel_host_ops

        root, pushed_ops = peel_host_ops(root)
        scans = [n for n in N.walk(root) if isinstance(n, N.TableScanNode)]
        walk_ids = {
            id(n): i for i, n in enumerate(N.walk(root))
        }
        part_scan = None
        repl_pages = {}
        for s in scans:
            if walk_ids[id(s)] == spec.partition_scan:
                part_scan = s
            else:
                repl_pages[id(s)] = self.runner._load_table(s)

        total = spec.split_end - spec.split_start
        batch = spec.split_batch_rows or max(total, 1)
        ranges = [
            (lo, min(lo + batch, spec.split_end))
            for lo in range(spec.split_start, spec.split_end, batch)
        ] or [(spec.split_start, spec.split_end)]

        def stage_batch(lo: int, hi: int):
            """Stage the partitioned scan's [lo, hi) batch through the
            device-resident split cache (LocalQueryRunner.stage_split:
            one fixed capacity bucket per batch size, so every full
            batch reuses one compiled program; uncached batches
            reserve their live residency under the query, cached ones
            are pinned against eviction until released)."""
            # staging may run on a prefetch/pool thread: point it at
            # the task's stats sink (thread-local on the runner)
            self.runner._qs_local.value = task.stats
            fetched = []

            def read_range():
                fetched.append(True)
                return self._load_range(part_scan, lo, hi)

            page, release = self.runner.stage_split(
                part_scan, lo, hi, bucket_capacity(hi - lo),
                owner=spec.query_id,
                page_source=read_range,
            )
            # one accounting unit (data + validity + offsets), same as
            # the pool reservation stage_split made
            staged_bytes = page_nbytes(page)
            # task.cond guards the stats accumulators: with
            # task_concurrency > 1 concurrent drivers race the
            # read-modify-write (+=) and would drop updates
            with task.cond:
                task.stats.input_rows += hi - lo
                task.stats.input_bytes += staged_bytes
            if fetched:
                # only REAL staging traffic counts — a cache hit moved
                # zero bytes host->device
                REGISTRY.distribution("worker.staging_bytes").add(
                    staged_bytes
                )
            return page, release

        # the in-slice lane keeps a partitioned batch's output on the
        # device (the segment holds device pages); every other emit
        # reads the result on the host
        on_device = (
            bool(spec.ici_slice)
            and spec.ici_slice == self.slice_id
            and spec.n_partitions > 1
            and not spec.dynfilter_keys
            and not pushed_ops
        )

        def exec_batch(split_page, release):
            pages = [
                split_page if s is part_scan else repl_pages[id(s)]
                for s in scans
            ]
            t_exec = time.perf_counter()
            try:
                out = self.runner._run_with_pages(
                    root, scans, pages, fetch_result=not on_device
                )
                if pushed_ops:
                    out = apply_host_ops(out, pushed_ops)
                return out
            finally:
                with task.cond:
                    task.stats.execute_ms += (
                        time.perf_counter() - t_exec
                    ) * 1000.0
                release()

        def run_batch(lo: int, hi: int):
            self.runner._qs_local.value = task.stats
            page, release = stage_batch(lo, hi)
            return exec_batch(page, release)

        # dynamic-filter SUMMARY task: batch outputs fold into one
        # per-key summary (exec/dynfilter.py — min/max + NDV-capped
        # distinct sets, string keys resolved through the page
        # dictionary) instead of crossing the wire as pages; the
        # coordinator reads the merged summary off the status response
        summary_cell: List = []

        def emit(out) -> None:
            if spec.dynfilter_keys:
                from presto_tpu_torch.exec import dynfilter

                s = dynfilter.summarize_page(
                    out,
                    list(spec.dynfilter_keys),
                    ndv_limit=spec.dynfilter_ndv
                    or dynfilter.DEFAULT_NDV_LIMIT,
                )
                with task.cond:
                    summary_cell.append(s)
                return
            if spec.n_partitions > 1:
                # partitioned output rides the exchange SPI: the
                # scheduler-chosen transport (the device-resident ICI
                # publish for in-slice stages, the serialized HTTP
                # buffers otherwise), the spool tee included
                return exchange_spi.emit_partitioned(
                    task, out,
                    slice_id=self.slice_id, pool=self.memory_pool,
                    fold=self.runner._fold_device_stat,
                )
            self._emit_result(task, out)

        def finish_summary() -> None:
            """Merge per-batch summaries into the task's one summary
            (empty range = empty build: nothing can match)."""
            if not spec.dynfilter_keys:
                return
            from presto_tpu_torch.exec import dynfilter

            ndv = spec.dynfilter_ndv or dynfilter.DEFAULT_NDV_LIMIT
            merged = None
            for s in summary_cell:
                merged = s if merged is None else merged.merge(s, ndv)
            if merged is None:
                merged = dynfilter.empty_summary(spec.dynfilter_keys)
            task.dynfilter = merged.to_json()

        if spec.task_concurrency <= 1 or len(ranges) <= 1:
            # pipelined prefetch staging (staging_prefetch_depth /
            # tier-1 staging.prefetch-depth): a background host thread
            # stages split N+1 while the jitted fragment for split N
            # runs on device — compute and transfer overlap instead of
            # alternating. Depth 0 is the exact serial path. The
            # coordinator ships the client session's value on the spec
            # (like page_capacity / task_concurrency); -1 = unset
            depth = (
                spec.prefetch_depth
                if spec.prefetch_depth >= 0
                else int(
                    self.runner.session.get("staging_prefetch_depth")
                )
            )
            from presto_tpu_torch.exec.staging import prefetch_iter

            def staged_ahead(rng):
                t0 = time.perf_counter()
                page, release = stage_batch(*rng)
                if depth > 0:
                    with task.cond:
                        task.stats.prefetch_ms += (
                            time.perf_counter() - t0
                        ) * 1000.0
                return page, release

            def drop_staged(entry):
                # a prefetched-but-never-executed batch surrenders its
                # residency (pool reservation or cache pin) — the task
                # is failing/aborting and the task-end release-all has
                # not run yet (prefetch_iter's abandonment contract)
                entry[1]()

            batches = prefetch_iter(
                ranges, staged_ahead, depth, on_drop=drop_staged
            )
            try:
                for page, release in batches:
                    emit(exec_batch(page, release))
            finally:
                # deterministic close: joins the prefetch thread and
                # drops queued batches BEFORE _run_task's release-all
                batches.close()
            finish_summary()
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(spec.task_concurrency) as pool:
            futs = [pool.submit(run_batch, lo, hi) for lo, hi in ranges]
            for f in futs:
                emit(f.result())
        finish_summary()

    def _emit_result(self, task: "_Task", out) -> None:
        """Root-stage (single-partition) result emit: when the
        coordinator's gather is co-located and the single-program gate
        is on, the page enters the in-slice segment and the final gather
        is one more ICI edge. Everything else keeps the serialized
        chunk-and-offer buffer (``page_to_wire_columns`` reads the
        runner's host result page in place); an HTTP pull of an
        ICI-published task still sees real pages through the lazy
        materialize of the results handler."""
        if (
            task.spec.ici_slice
            and self.single_program
            and exchange_spi.emit_gather(
                task, out, slice_id=self.slice_id, pool=self.memory_pool
            )
        ):
            # seal-eligibility latch: only a task whose output rode the
            # lane seals at FINISH (see _run_task)
            task._ici_gather = True
            return
        cols, n = pages_wire.page_to_wire_columns(out)
        _offer_chunked(task, cols, n)

    def _ici_probe(self, uri: str, src_task: str):
        """Liveness probe for the in-slice fetch wait: is the producer
        attempt still working toward a seal? One small status GET
        between waits; any doubt answers False and the consumer pulls
        the wire, which has its own retry discipline."""
        def probe():
            try:
                st = rpc.call_json(
                    "GET", f"{uri}/v1/task/{src_task}/status",
                    policy=rpc.RpcPolicy(timeout_s=2.0, retries=0),
                )
                return st.get("state") in ("QUEUED", "RUNNING")
            except Exception:
                return False

        return probe

    def _merge_group_page(self, task: "_Task", entries, rschema, nparts):
        """Resolve one merge group's tagged transport entries into its
        RemoteSource leaf's input. An all-ICI group merges ON the
        device: first through the stage's single routing pass
        (``exchange_spi.collective_merge``, shared by every partition of
        the stage), else the per-source ``device_merge`` gather (the
        same union dictionary, row order and capacity bucket either
        way). A mixed or oversized group becomes host payloads, the ICI
        sources' share still spliced out of the routing pass when it
        can be. ``nparts`` is the producers' partition count. Returns
        ``(page, None)`` for the device lane or ``(None, payloads)`` for
        the host lanes."""
        max_rows = int(self.runner.session.get("max_device_rows"))
        fold = self.runner._fold_device_stat
        device = self.runner.device
        ici_srcs = tuple(s for k, _, s in entries if k == "ici")
        if entries and len(ici_srcs) == len(entries):
            res = None
            if self.single_program:
                try:
                    res = exchange_spi.collective_merge(
                        self.slice_id, ici_srcs,
                        [b for _, b, _ in entries],
                        task.spec.partition, rschema, nparts, device,
                        max_rows=max_rows, fold=fold,
                    )
                except Exception:
                    REGISTRY.counter("exchange.collective_fallbacks").update()
                    log.warning(
                        "node=%s collective merge failed; degrading to "
                        "the per-source gather", self.node_id,
                        exc_info=True,
                    )
                    res = None
            if res is None:
                try:
                    res = exchange_spi.device_merge(
                        [b for _, b, _ in entries],
                        task.spec.partition, rschema, device,
                        max_rows=max_rows, fold=fold,
                    )
                except Exception:
                    REGISTRY.counter("exchange.ici_merge_errors").update()
                    log.warning(
                        "node=%s device merge failed; degrading to the "
                        "host merge", self.node_id, exc_info=True,
                    )
                    res = None
            if res is not None:
                page, total = res
                with task.cond:
                    task.stats.input_rows += total
                return page, None
        spliced = None
        if self.single_program and ici_srcs:
            try:
                spliced = exchange_spi.collective_payloads(
                    self.slice_id, ici_srcs,
                    [b for k, b, _ in entries if k == "ici"],
                    task.spec.partition, rschema, nparts, fold=fold,
                )
            except Exception:
                REGISTRY.counter("exchange.collective_fallbacks").update()
                log.warning(
                    "node=%s collective splice failed; per-source "
                    "fallback", self.node_id, exc_info=True,
                )
                spliced = None
        payloads = []
        si = 0
        for kind, val, _src in entries:
            if kind == "http":
                payloads.extend(val)
                continue
            if spliced is not None:
                conv = spliced[si]
                si += 1
            else:
                conv = exchange_spi.ici_batches_to_payloads(
                    val, task.spec.partition
                )
            with task.cond:
                task.stats.input_rows += sum(n for _, _, n in conv)
            payloads.extend(conv)
        return None, payloads

    def _materialize_ici(self, task: "_Task") -> None:
        """Degrade one task's ICI edges to HTTP, exactly once: the drain
        and the lazy results-handler path both land here, and concurrent
        pulls block until the serialized buffers are complete (a
        half-materialized buffer must never flip X-Complete under a
        puller). Serializing is the pure half: raising there leaves
        nothing torn and a later call retries."""
        with task._ici_mat_lock:
            if task._ici_mat_done:
                return
            frames = exchange_spi.serialize_ici_frames(task)
            if frames is not None:
                exchange_spi.buffer_frames(task, frames, self.memory_pool)
            task._ici_mat_done = True
        # a DELETE may have raced the materialize: its release-all can
        # run BEFORE buffer_frames' reservation, and a task no longer
        # registered gets no later DELETE, so drop everything now
        with self._lock:
            gone = task.spec.task_id not in self.tasks
        if gone:
            exchange_spi.discard_task(task.spec.task_id)
            task.drop_buffers()

    def _spool_partition(self, task: "_Task", logical_key: str):
        """Recovery read: one committed attempt's pages for this merge
        task's partition out of the durable spool (None = nothing
        recoverable). The spool serves raw wire frames; deserialization
        and stats attribution happen here, mirroring the HTTP pull."""
        if self.spool is None:
            return None
        raw = self.spool.serve(logical_key, task.spec.partition)
        if raw is None:
            return None
        pages = [pages_wire.deserialize_page(b) for b in raw]
        with task.cond:
            task.stats.spool_pages_served += len(pages)
        log.info(
            "node=%s task=%s re-served %d page(s) of %s[%d] from spool",
            self.node_id, task.spec.task_id, len(pages), logical_key,
            task.spec.partition,
        )
        return pages

    def _load_range(self, scan: N.TableScanNode, lo: int, hi: int):
        conn = self.runner.catalogs.get(scan.handle.catalog)
        split = ConnectorSplit(scan.handle, lo, hi)
        return conn.create_page_source(split, list(scan.columns))

    # ------------------------------------------- merge task (shuffle read)

    def _execute_merge(self, task: "_Task") -> None:
        """Intermediate-stage task: pull this task's output partition
        from every producer task (worker<->worker data plane — the
        reference's ExchangeClient feeding an intermediate stage), merge
        the payloads (dictionary remap included), and run the fragment
        with its RemoteSourceNode leaf bound to the merged page.

        Correctness: producers hash-partition rows by the final
        aggregation's group keys, so every group lands wholly in one
        partition and per-partition FINAL results concatenate."""
        REGISTRY.counter("worker.merge_tasks").update()
        spec = task.spec
        # dynamic source loop (reference: ExchangeClient consuming
        # addExchangeLocations until noMoreLocations): pull every known
        # source's partition — pulls OVERLAP production, since the
        # token loop polls until the producer reports complete — and
        # wait for more until the coordinator marks the set done.
        # A source is (uri, task_id[, group]): group tags map each
        # producer stage to one RemoteSourceNode leaf (a partitioned
        # JOIN stage has two producer stages — group 0 probe, group 1
        # build); untagged sources are group 0.
        #: per-group tagged transport entries, in source order:
        #: ("http", [(payload, schema, nrows), ...]) from the wire or the
        #: spool, ("ici", [(page, dest), ...]) from the in-slice segment;
        #: _merge_group_page resolves them into each leaf's input
        by_group: Dict[int, list] = {}
        pulled = set()
        # the in-slice transport applies only when the scheduler planned
        # it AND this attempt runs on that slice (a retry that landed
        # cross-slice keeps the wire)
        use_ici = bool(spec.ici_slice) and spec.ici_slice == self.slice_id
        #: per group, the producers' partition count (the fan-out of the
        #: stage's single routing pass; this task's own n_partitions is
        #: its output's)
        ici_fanout: Dict[int, int] = {}
        # attempt-id dedup (fault-tolerant execution): every attempt of
        # one logical upstream task shares a logical key, and exactly
        # ONE attempt's pages may be consumed — a retried producer and
        # its zombie original must never both contribute rows
        pulled_logical = set()
        #: logical keys whose announced attempt died unreachable with
        #: no spooled copy — a replacement announcement may still heal
        #: them; anything left at loop end is a hard loss
        abandoned: Dict[str, Exception] = {}
        deadline = time.monotonic() + float(
            self.runner.session.get("query_max_run_time_s")
        )
        while True:
            with task.cond:
                pending = [
                    s for s in task.sources if tuple(s) not in pulled
                ]
                if not pending:
                    if task.sources_done:
                        break
                    if task.state == "ABORTED":
                        raise RuntimeError("merge task aborted")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            "merge task timed out waiting for sources"
                        )
                    task.cond.wait(timeout=0.1)
                    continue
            for src in pending:
                uri, src_task = src[0], src[1]
                group = int(src[2]) if len(src) > 2 else 0
                lk = task_ids.logical_key(src_task)
                if lk in pulled_logical:
                    pulled.add(tuple(src))
                    continue
                t_pull = time.perf_counter()
                if use_ici:
                    # in-slice lane: this partition straight out of the
                    # producer's device-resident entry; a miss (the
                    # producer died, drained or fell back itself) pulls
                    # the wire below, then the spool
                    got_ici = exchange_spi.ici_fetch(
                        self.slice_id, spec, src_task, deadline,
                        probe=self._ici_probe(uri, src_task),
                    )
                    if got_ici is not None:
                        batches, fanout = got_ici
                        by_group.setdefault(group, []).append(
                            ("ici", batches, src_task)
                        )
                        ici_fanout[group] = max(
                            ici_fanout.get(group, 0), fanout
                        )
                        task.stats.staging_ms += (
                            time.perf_counter() - t_pull
                        ) * 1000.0
                        task.stats.exchange_ici_edges += 1
                        abandoned.pop(lk, None)
                        pulled.add(tuple(src))
                        pulled_logical.add(lk)
                        continue
                try:
                    got = _pull_partition(
                        uri, src_task, spec.partition,
                        self.runner.session, policy=self._rpc_policy,
                    )
                    task.stats.exchange_http_edges += 1
                except Exception as e:
                    # a dead producer: its committed attempt's pages
                    # re-serve from the durable spool
                    got = (
                        self._spool_partition(task, lk)
                        if spec.spool
                        else None
                    )
                    if got is None:
                        if spec.spool:
                            # recoverable exchange: the coordinator may
                            # announce a replacement attempt of this
                            # logical task — consume that instead
                            abandoned[lk] = e
                            pulled.add(tuple(src))
                            continue
                        raise
                    task.stats.exchange_spool_edges += 1
                abandoned.pop(lk, None)
                by_group.setdefault(group, []).append(("http", got, src_task))
                task.stats.staging_ms += (
                    time.perf_counter() - t_pull
                ) * 1000.0
                task.stats.input_rows += sum(p[2] for p in got)
                pulled.add(tuple(src))
                pulled_logical.add(lk)
        lost = [lk for lk in abandoned if lk not in pulled_logical]
        if lost:
            # every attempt of these upstream tasks is gone and nothing
            # was spooled/committed: the merge cannot be correct
            raise RuntimeError(
                f"merge task lost upstream partition(s) {lost}: "
                f"{abandoned[lost[0]]}"
            )
        root = spec.fragment
        remotes = [
            n for n in N.walk(root) if isinstance(n, N.RemoteSourceNode)
        ]
        if len(remotes) > 1:
            # multi-source fragment (partitioned join stage): group i
            # feeds the i-th RemoteSourceNode in walk order; each
            # group's entries merge + stage separately (on the device
            # when the whole group arrived in the slice), then the
            # fragment runs once over all leaves
            import numpy as np

            pages = []
            for i, r in enumerate(remotes):
                rschema = dict(r.fragment_root.output_schema())
                page, payloads = self._merge_group_page(
                    task, by_group.get(i, []), rschema,
                    ici_fanout.get(i, 0),
                )
                if page is None:
                    if payloads:
                        merged = pages_wire.merge_payloads(payloads, rschema)
                    else:  # no rows from this side in this partition
                        merged = {
                            nm: np.empty(0, t.np_dtype)
                            for nm, t in rschema.items()
                        }
                    page = stage_page(
                        merged, rschema, device=self.runner.device
                    )
                pages.append(page)
            # same accounting as the single-remote path: a too-big
            # (skewed) join partition fails on MemoryPool accounting
            # (kill-largest policy visible), not device OOM
            staged = sum(
                int(b.data.nbytes)
                for pg in pages
                for b in pg.blocks
            )
            self.memory_pool.reserve(spec.query_id, staged)
            task.stats.input_bytes += staged
            t_exec = time.perf_counter()
            try:
                out = self.runner._run_with_pages(root, remotes, pages)
            finally:
                task.stats.execute_ms += (
                    time.perf_counter() - t_exec
                ) * 1000.0
                self.memory_pool.release(spec.query_id, staged)
            self._emit_result(task, out)
            return
        if len(remotes) != 1:
            raise RuntimeError(
                f"merge fragment must have one RemoteSource leaf, "
                f"got {len(remotes)}"
            )
        schema = dict(remotes[0].fragment_root.output_schema())
        page0, payloads = self._merge_group_page(
            task, by_group.get(0, []), schema, ici_fanout.get(0, 0)
        )
        if page0 is not None:
            # all-in-slice merge: the input page was assembled on the
            # device (bit-compatible with the wire path's staged page)
            staged = sum(int(b.data.nbytes) for b in page0.blocks)
            self.memory_pool.reserve(spec.query_id, staged)
            task.stats.input_bytes += staged
            t_exec = time.perf_counter()
            try:
                out = self.runner._run_with_pages(root, remotes, [page0])
            finally:
                task.stats.execute_ms += (
                    time.perf_counter() - t_exec
                ) * 1000.0
                self.memory_pool.release(spec.query_id, staged)
            self._emit_result(task, out)
            return
        # same grouped-execution discipline as the coordinator gather:
        # a partition beyond max_device_rows sub-buckets and merges one
        # bucket at a time (or fails under spill_enabled=false) instead
        # of staging one oversized page
        from presto_tpu_torch.exec import streaming as S

        out = S.grouped_final_merge(
            self.runner,
            payloads,
            schema,
            root,
            remotes[0].fragment_root,
            int(self.runner.session.get("max_device_rows")),
        )
        if out is None:
            merged = pages_wire.merge_payloads(payloads, schema)
            page = stage_page(merged, schema, device=self.runner.device)
            staged = sum(int(b.data.nbytes) for b in page.blocks)
            self.memory_pool.reserve(spec.query_id, staged)
            task.stats.input_bytes += staged
            t_exec = time.perf_counter()
            try:
                out = self.runner._run_with_pages(root, remotes, [page])
            finally:
                task.stats.execute_ms += (
                    time.perf_counter() - t_exec
                ) * 1000.0
                self.memory_pool.release(spec.query_id, staged)
        self._emit_result(task, out)

    # ------------------------------------------------------------- status

    def status(self) -> dict:
        with self._lock:
            if self._shutting_down:
                state = "SHUTTING_DOWN"
            elif self._draining:
                state = "DRAINING"
            else:
                state = "ACTIVE"
            tasks = {tid: t.state for tid, t in self.tasks.items()}
        return {
            "node_id": self.node_id,
            "state": state,
            "uri": self.uri,
            "preemptible": self.preemptible,
            "slice_id": self.slice_id,
            "tasks": tasks,
            "memory": self._memory_report(),
            "backend_diag": devicediag.last_diag_dict(),
        }

    def delete_task(self, task_id: str) -> bool:
        """The one task-teardown primitive (the DELETE route and the
        cluster memory manager's abort both ride it): drop the task,
        abort its execution, free its buffered bytes."""
        with self._lock:
            t = self.tasks.pop(task_id, None)
        if t is None:
            return False
        t.abort()
        # in-slice entries die with the task (shuffle partitions must not
        # outlive the query); the buffer-key release below covers their
        # reservation
        exchange_spi.discard_task(task_id)
        t.drop_buffers()
        return True

    def abort_query(self, query_id: str) -> int:
        """Cluster-wide cancellation, worker side (the low-memory
        killer's ``PUT /v1/memory/abort``): tear down every task of
        the victim through the task-DELETE path and fail its blocked
        reservations — WITHOUT poisoning the query id, so a
        ``retry_policy=QUERY`` re-admission can reserve again."""
        with self._lock:
            doomed = [
                tid
                for tid, t in self.tasks.items()
                if t.spec.query_id == query_id
            ]
        n = 0
        for tid in doomed:
            if self.delete_task(tid):
                n += 1
        self.memory_pool.cancel_blocked(query_id)
        if n:
            log.warning(
                "node=%s memory manager aborted %d task(s) of %s",
                self.node_id, n, query_id,
            )
        return n


def _pull_partition(
    uri: str, src_task: str, part: int, session,
    policy: rpc.RpcPolicy = rpc.DEFAULT_POLICY,
):
    """Token-acked pull of one output partition from a peer worker:
    the shared rpc.pull_pages loop (exchange client, worker side).
    Pulls are idempotent (token-acked), so transient peer failures
    retry under the RPC policy."""
    return rpc.pull_pages(
        uri, src_task, part,
        policy=policy,
        deadline_s=float(session.get("query_max_run_time_s")),
        timeout_msg=f"shuffle pull of {src_task}[{part}] timed out",
    )


class _Server(ThreadingHTTPServer):
    #: listen backlog, the coordinator's: a burst of task POSTs and page
    #: pulls must queue for accept, not lose its SYN (socketserver's
    #: default is 5)
    request_queue_size = 128


def _make_handler(worker: WorkerServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n)

        def do_GET(self):
            parts = [p for p in self.path.split("/") if p]
            if parts == ["v1", "status"]:
                return self._json(200, worker.status())
            if parts == ["v1", "metrics"]:
                body = REGISTRY.render_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if len(parts) == 4 and parts[:2] == ["v1", "task"] and parts[3] == "status":
                t = worker.tasks.get(parts[2])
                if t is None:
                    return self._json(404, {"error": "no such task"})
                return self._json(
                    200,
                    {
                        "task_id": parts[2],
                        "state": t.state,
                        "error": t.error,
                        "num_pages": len(t.pages),
                        # durable-copy flag: a FINISHED+spooled task's
                        # output outlives this worker (drain protocol)
                        "spooled": t.spooled,
                        "stats": t.stats.to_dict(),
                        "spans": t.spans,
                        "dynamic_filter": t.dynfilter,
                    },
                )
            if (
                len(parts) == 6
                and parts[:2] == ["v1", "task"]
                and parts[3] == "results"
            ):
                # /v1/task/{id}/results/{buffer}/{token}
                t = worker.tasks.get(parts[2])
                if t is None:
                    return self._json(404, {"error": "no such task"})
                part = int(parts[4])
                token = int(parts[5])
                if t.state == "FAILED":
                    return self._json(500, {"error": t.error})
                if not (0 <= part < len(t.parts)):
                    return self._json(
                        400, {"error": f"no output buffer {part}"}
                    )
                # pulling token N acks pages < N (frees buffer slots and
                # unblocks the producer — the reference's token-advance
                # ack). A pipelined client sends an explicit X-Ack floor
                # instead: its speculative in-flight request for token
                # N+k must NOT free pages it hasn't consumed yet.
                ack_hdr = self.headers.get("X-Ack")
                t.ack_below(
                    int(ack_hdr) if ack_hdr is not None else token,
                    part,
                )
                # snapshot (page, count, state) ATOMICALLY: reading
                # len(pages) then state unlocked races the producer's
                # final append + FINISHED publish — a 204 with
                # X-Complete=true would silently drop the last page
                # (pipelined pulls keep a beyond-the-end token in
                # flight, so the race window is hit on every pull)
                # The lazy ICI degrade rides the SAME snapshot: a wire
                # pull of a FINISHED in-slice task (a merge retry that
                # landed cross-slice) must see the real pages, since its
                # serialized buffers are empty until materialized and
                # FINISHED + empty would read as a complete zero-row
                # partition. The decision is made on the locked state,
                # then the snapshot re-runs.
                while True:
                    with t.cond:
                        pages = t.parts[part]
                        body = pages[token] if token < len(pages) else None
                        n_pages = len(pages)
                        state = t.state
                        complete = state == "FINISHED" and (
                            token + (1 if body is not None else 0)
                            >= n_pages
                        )
                        need_mat = (
                            state == "FINISHED"
                            and bool(t.spec.ici_slice)
                            and not t._ici_mat_done
                        )
                        if complete and not need_mat:
                            # drain protocol: this consumer has seen the
                            # whole stream — the buffer no longer pins a
                            # draining worker alive
                            t.complete_served[part] = True
                    if not need_mat:
                        break
                    worker._materialize_ici(t)
                if body is not None:
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "application/x-presto-tpu-page"
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("X-Next-Token", str(token + 1))
                    self.send_header(
                        "X-Complete", "true" if complete else "false"
                    )
                    self.end_headers()
                    self.wfile.write(body)
                    return
                # no page at this token yet
                self.send_response(204)
                self.send_header("Content-Length", "0")
                self.send_header("X-Next-Token", str(token))
                self.send_header(
                    "X-Complete", "true" if complete else "false"
                )
                self.end_headers()
                return
            self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            parts = [p for p in self.path.split("/") if p]
            if parts == ["v1", "task"]:
                if worker._draining or worker._shutting_down:
                    # reject BEFORE parsing: 503 tells the coordinator
                    # to reschedule on another worker (no task was
                    # created here)
                    return self._json(
                        503, {"error": "worker is draining"}
                    )
                try:
                    spec = FragmentSpec.from_json(
                        json.loads(self._read_body().decode())
                    )
                    # honor the propagated trace context: a header on
                    # the POST covers specs from span-unaware clients
                    hdr = self.headers.get("traceparent", "")
                    if hdr and not spec.traceparent:
                        import dataclasses as _dc

                        spec = _dc.replace(spec, traceparent=hdr)
                    tid = worker.create_task(spec)
                    return self._json(200, {"task_id": tid})
                except WorkerDraining as e:
                    return self._json(503, {"error": str(e)})
                except Exception as e:
                    return self._json(400, {"error": str(e)})
            self._json(404, {"error": f"no route {self.path}"})

        def do_DELETE(self):
            parts = [p for p in self.path.split("/") if p]
            if len(parts) == 3 and parts[:2] == ["v1", "task"]:
                worker.delete_task(parts[2])
                return self._json(200, {"ok": True})
            self._json(404, {"error": f"no route {self.path}"})

        def do_PUT(self):
            parts = [p for p in self.path.split("/") if p]
            if parts == ["v1", "state", "shutdown"]:
                threading.Thread(
                    target=worker.shutdown, daemon=True
                ).start()
                return self._json(200, {"ok": True})
            if parts == ["v1", "memory", "abort"]:
                # cluster memory manager kill, worker side: tear down
                # the victim's tasks (task-DELETE path) and fail its
                # blocked reservations
                body = json.loads(self._read_body() or b"{}")
                qid = body.get("query_id", "")
                if not qid:
                    return self._json(400, {"error": "query_id required"})
                return self._json(
                    200, {"ok": True, "aborted": worker.abort_query(qid)}
                )
            if parts == ["v1", "state", "drain"]:
                # graceful drain: stop accepting, finish + serve/spool
                # running outputs, announce DRAINING, exit clean
                threading.Thread(
                    target=worker.drain, daemon=True
                ).start()
                return self._json(200, {"ok": True, "state": "DRAINING"})
            if (
                len(parts) == 4
                and parts[:2] == ["v1", "task"]
                and parts[3] == "sources"
            ):
                # pipelined shuffle: attach upstream sources to a merge
                # task (reference: addExchangeLocations)
                t = worker.tasks.get(parts[2])
                if t is None:
                    return self._json(404, {"error": "no such task"})
                body = json.loads(self._read_body() or b"{}")
                t.add_sources(
                    body.get("sources", ()), bool(body.get("done"))
                )
                return self._json(200, {"ok": True})
            self._json(404, {"error": f"no route {self.path}"})

    return Handler

"""Cluster memory arbiter: the distributed half of the memory manager.

Reference parity: Presto's ``ClusterMemoryManager`` + low-memory killer
(PAPER.md layer map; SURVEY.md §2.1 "Memory manager"). Every node's
``MemoryPool`` stays process-local for *enforcement of its own limit*;
this module folds the per-node accounting the workers report on their
announce/status heartbeats (current + peak + blocked reservations +
host-spill occupancy) into ONE cluster view and applies cluster-level
policy:

- ``query.max-memory`` — a query's CLUSTER-WIDE reservation cap;
- ``query.max-memory-per-node`` — the same key that sizes each node
  pool, re-checked per (query, node) so a single-node hog is caught
  even when the node total stays under its limit;
- distributed resource-group quotas — the coordinator's
  ``_group_memory`` hook sums this view, so ``softMemoryLimit``
  finally sees worker-side bytes;
- an admission high-water mark — while the cluster's query-attributed
  usage exceeds ``memory.admission-high-water`` (fraction of the
  cluster's pooled capacity), QUEUED queries are HELD, never failed,
  releasing at ``memory.admission-low-water`` (hysteresis);
- the low-memory killer — when any node reports a reservation blocked
  past ``memory.blocked-timeout-s``, a victim is chosen by the
  pluggable policy (``total-reservation`` = largest cluster-wide
  holder, ``last-admitted`` = newest running query) and killed
  cluster-wide with a ``MEMORY_PRESSURE`` error naming victim and
  policy; under ``retry_policy=QUERY`` the victim re-runs after
  pressure subsides, within the ``query_retry_count`` budget.

The arbiter is a pure accounting/policy engine: observation updates
state and COMPUTES decisions; all side effects (task cancellation,
journaling, re-admission) run through the coordinator's hooks
(`_apply_memory_kill`, `_readmit_memory_victim`). Gated end-to-end by
``memory.governance-enabled`` — disabled, it still folds reports (the
resource-group fix and ``system.runtime.memory`` stay live) but never
holds, never kills, never spills.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from presto_tpu_torch.utils.memory import parse_bytes
from presto_tpu_torch.utils.metrics import REGISTRY

log = logging.getLogger("presto_tpu_torch.memory_arbiter")

#: a node report older than this is dropped from the cluster view
#: (matches the coordinator's discovery TTL)
REPORT_TTL_S = 10.0

#: victim policies the killer understands
KILL_POLICIES = ("total-reservation", "last-admitted")

#: kill decisions retained for system.runtime.memory
MAX_DECISIONS = 100


class ClusterMemoryArbiter:
    """Folds per-node heartbeat memory reports into a cluster view and
    drives the cluster-level memory policy through coordinator hooks."""

    def __init__(self, coord, config=None):
        get = (lambda k, d=None: config.get(k, d)) if config else (
            lambda k, d=None: d
        )
        self.coord = coord
        self.enabled = bool(get("memory.governance-enabled", False))
        mm = get("query.max-memory")
        #: cluster-wide per-query cap (None = unbounded)
        self.max_query_bytes: Optional[int] = (
            parse_bytes(mm) if mm is not None else None
        )
        #: per-(query, node) cap — the same tier-1 key that sizes the
        #: node pools, re-checked against per-query node reservations
        self.max_query_node_bytes: int = parse_bytes(
            get("query.max-memory-per-node") or "8GB"
        )
        self.high_water = float(get("memory.admission-high-water", 0.85))
        lw = get("memory.admission-low-water")
        self.low_water = (
            float(lw) if lw is not None else self.high_water * 0.9
        )
        self.blocked_timeout_s = float(
            get("memory.blocked-timeout-s", 1.0)
        )
        self.kill_policy = str(
            get("memory.kill-policy", "total-reservation")
        )
        if self.kill_policy not in KILL_POLICIES:
            raise ValueError(
                f"memory.kill-policy must be one of {KILL_POLICIES}, "
                f"got {self.kill_policy!r}"
            )
        self._lock = threading.Lock()
        #: node_id -> {"ts", "limit", "reserved", "queries",
        #:             "blocked", "spilled_bytes"}
        self._reports: Dict[str, dict] = {}
        #: victims already dispatched (suppresses duplicate kills while
        #: heartbeats still show the dying query's reservations)
        self._killed: set = set()
        #: admission hold latch (hysteresis)
        self._held = False
        #: wall-clock of the last killer decision: blockage that BEGAN
        #: before it is stale evidence (the kill's cancellations may
        #: not have reached the reporting node yet) and must not pick
        #: a second victim
        self._last_kill_ts = 0.0
        #: kill decisions, newest last (system.runtime.memory rows)
        self.decisions: deque = deque(maxlen=MAX_DECISIONS)
        #: multi-coordinator hook (server/lease.py plane): returns
        #: peer coordinators' LOCAL-pool reports keyed by a synthetic
        #: node id — folded into the cluster view so admission
        #: high-water and capacity are cluster-wide across N
        #: admitters. None (the default) = single-coordinator view,
        #: bit-exact pre-HA. Worker-side bytes are NOT re-folded here:
        #: workers heartbeat every coordinator directly, so each
        #: arbiter already holds them once.
        self.peer_reports_fn = None

    # ---------------------------------------------------------- accounting

    def observe(self, node_id: str, report: Optional[dict]) -> None:
        """Fold one node's heartbeat memory report in; with governance
        enabled, run enforcement against the refreshed view."""
        if not report:
            return
        with self._lock:
            self._reports[node_id] = {
                "ts": time.time(),
                "limit": int(report.get("limit", 0)),
                "reserved": int(report.get("reserved", 0)),
                "queries": dict(report.get("queries") or {}),
                "blocked": list(report.get("blocked") or ()),
                "spilled_bytes": int(report.get("spilled_bytes", 0)),
            }
        if self.enabled:
            self._enforce()

    def forget_query(self, qid: str) -> None:
        """Clear the killed-victim latch (a re-admitted victim may be
        chosen again if it blows up twice)."""
        with self._lock:
            self._killed.discard(qid)

    def suspend_release(self, qid: str) -> None:
        """A QoS suspension (server/qos.py) released this query's
        cluster reservation: drop its entries from the cached per-node
        reports NOW — admission-hold and quota math must stop charging
        a parked query immediately, not a heartbeat later. The
        victim's still-draining tasks re-assert whatever they actually
        hold on their next heartbeats, so accounting converges on
        truth either way."""
        with self._lock:
            for rep in self._reports.values():
                rep["queries"].pop(qid, None)

    def _live_reports(self) -> Dict[str, dict]:
        now = time.time()
        with self._lock:
            return {
                n: r
                for n, r in self._reports.items()
                if now - r["ts"] <= REPORT_TTL_S
            }

    def _local_report(self) -> dict:
        """The coordinator's own pool folded as one more node — the
        same ``rollup_query_report`` fold the workers apply to their
        heartbeats, so attribution can never disagree across tiers."""
        from presto_tpu_torch.exec.staging import SplitCache
        from presto_tpu_torch.utils.memory import rollup_query_report

        cache = getattr(self.coord.local, "split_cache", None)
        rep = rollup_query_report(
            self.coord.memory_pool.snapshot(),
            SplitCache.OWNER,
            cache.spill_used_bytes() if cache is not None else 0,
        )
        rep["ts"] = time.time()
        return rep

    def _view(self) -> Dict[str, dict]:
        """Live per-node reports, coordinator included — and, with
        the multi-coordinator lease plane on, every live PEER
        coordinator's local-pool report (their lease payloads), so
        admission water marks gate against the whole cluster's
        query-attributed bytes and pooled capacity."""
        view = self._live_reports()
        view["coordinator"] = self._local_report()
        if self.peer_reports_fn is not None:
            try:
                for node, rep in (self.peer_reports_fn() or {}).items():
                    if (
                        isinstance(rep, dict)
                        and "limit" in rep
                        and isinstance(rep.get("queries"), dict)
                    ):
                        view.setdefault(node, rep)
            except Exception:
                pass  # a torn peer read must never stall admission
        return view

    def local_report(self) -> dict:
        """Public form of the coordinator-local fold — what this
        coordinator publishes in its own lease payload for PEER
        arbiters to fold (the mirror of ``peer_reports_fn``)."""
        return self._local_report()

    def query_bytes(self, qid: str) -> Tuple[int, int]:
        """(current, peak) WORKER-side bytes of one query — remote
        reports only, so callers that already see the coordinator's
        local pool can add it without double counting."""
        cur = peak = 0
        for rep in self._live_reports().values():
            q = rep["queries"].get(qid)
            if q:
                cur += int(q.get("bytes", 0))
                peak += int(q.get("peak", q.get("bytes", 0)))
        return cur, peak

    def queries_bytes(self, qids) -> int:
        """Summed WORKER-side current bytes of a set of queries (the
        resource-group quota hook adds coordinator-local bytes
        itself)."""
        want = set(qids)
        total = 0
        for rep in self._live_reports().values():
            for qid, q in rep["queries"].items():
                if qid in want:
                    total += int(q.get("bytes", 0))
        return total

    def cluster_usage(self) -> Tuple[int, int]:
        """(query-attributed bytes, pooled capacity) across live
        nodes. Query-attributed only: droppable cache bytes must not
        wedge admission shut with zero queries running."""
        used = limit = 0
        for rep in self._view().values():
            limit += rep["limit"]
            used += sum(
                int(q.get("bytes", 0))
                for q in rep["queries"].values()
            )
        return used, limit

    # ----------------------------------------------------------- admission

    def admission_held(self) -> bool:
        """Hysteresis latch: holds while usage/capacity exceeds the
        high-water mark, releases below the low-water mark. QUEUED
        queries wait — they are never failed by this gate."""
        if not self.enabled or self.high_water <= 0:
            return False
        used, limit = self.cluster_usage()
        if limit <= 0:
            return False
        frac = used / limit
        with self._lock:
            if self._held:
                if frac < self.low_water:
                    self._held = False
                    log.info(
                        "admission released: usage %.0f%% below "
                        "low-water %.0f%%",
                        frac * 100, self.low_water * 100,
                    )
            elif frac > self.high_water:
                self._held = True
                REGISTRY.counter("memory.admission_holds").update()
                log.warning(
                    "admission held: usage %.0f%% over high-water "
                    "%.0f%%", frac * 100, self.high_water * 100,
                )
            return self._held

    def pressure_subsided(self) -> bool:
        """Is the cluster calm enough to re-admit a killed victim?
        Below the low-water mark with no reservation still blocked."""
        used, limit = self.cluster_usage()
        if limit > 0 and used / limit >= self.low_water:
            return False
        return not any(
            rep["blocked"] for rep in self._view().values()
        )

    # ------------------------------------------------------------- killer

    def _enforce(self) -> None:
        """Scan the refreshed view for violations and dispatch kill
        decisions through the coordinator (off-thread — enforcement
        runs on heartbeat handler threads)."""
        try:
            decisions = self._decide()
        except Exception:
            log.warning("memory enforcement failed", exc_info=True)
            return
        for victim, policy, reason in decisions:
            threading.Thread(
                target=self.coord._apply_memory_kill,
                args=(victim, policy, reason),
                daemon=True,
            ).start()

    def _decide(self) -> List[Tuple[str, str, str]]:
        """(victim_qid, policy, reason) kill decisions for the current
        view. Pure: no side effects beyond the killed-latch."""
        view = self._view()
        out: List[Tuple[str, str, str]] = []

        def running(qid: str) -> bool:
            q = self.coord.queries.get(qid)
            return (
                q is not None
                and not q.done.is_set()
                and qid not in self._killed
            )

        def claim(qid: str, policy: str, reason: str) -> bool:
            with self._lock:
                if qid in self._killed:
                    return False
                self._killed.add(qid)
            out.append((qid, policy, reason))
            return True

        # 1. per-query quotas: cluster-wide and per-node caps
        totals: Dict[str, int] = {}
        for node, rep in view.items():
            for qid, q in rep["queries"].items():
                b = int(q.get("bytes", 0))
                totals[qid] = totals.get(qid, 0) + b
                if (
                    b > self.max_query_node_bytes
                    and running(qid)
                ):
                    claim(
                        qid,
                        "query.max-memory-per-node",
                        f"{b}B on {node} exceeds "
                        f"query.max-memory-per-node "
                        f"{self.max_query_node_bytes}B",
                    )
        if self.max_query_bytes is not None:
            for qid, b in totals.items():
                if b > self.max_query_bytes and running(qid):
                    claim(
                        qid,
                        "query.max-memory",
                        f"{b}B cluster-wide exceeds query.max-memory "
                        f"{self.max_query_bytes}B",
                    )

        # 2. low-memory killer: a reservation blocked past the timeout
        #    on any node picks a victim by policy. Evidence freshness:
        #    right after a kill, reports snapshotted before its
        #    cancellations landed still show the old blockage — those
        #    must not claim a second victim. A blocked entry counts
        #    when it BEGAN after the last kill, or when the settle
        #    window has passed and it is STILL blocked (the last kill
        #    freed nothing for it — more pressure, next victim).
        settle = max(self.blocked_timeout_s, 0.5)
        for node, rep in view.items():
            over = [
                b
                for b in rep["blocked"]
                if float(b.get("age_s", 0.0)) >= self.blocked_timeout_s
                and (
                    (rep["ts"] - float(b.get("age_s", 0.0)))
                    > self._last_kill_ts
                    or rep["ts"] - self._last_kill_ts > settle
                )
            ]
            if not over:
                continue
            victim = self._pick_victim(totals, over, running)
            if victim is None:
                continue
            blocked_owner = str(over[0].get("owner", ""))
            if claim(
                victim,
                self.kill_policy,
                f"reservation of {over[0].get('bytes', 0)}B for "
                f"{blocked_owner} blocked "
                f"{float(over[0].get('age_s', 0.0)):.1f}s on {node} "
                f"(pool limit {rep['limit']}B, reserved "
                f"{rep['reserved']}B)",
            ):
                with self._lock:
                    self._last_kill_ts = time.time()
        return out

    def _pick_victim(
        self, totals: Dict[str, int], blocked: List[dict], running
    ) -> Optional[str]:
        """Victim by policy among RUNNING queries. Falls back to the
        blocked owner itself when no running query holds enough bytes
        to matter — the over-budget requester is then its own victim
        (the legacy local-pool failure, surfaced with cluster
        vocabulary)."""
        #: a holder smaller than the blocked request cannot resolve
        #: the blockage — killing it would free nothing and the killer
        #: would just fire again (innocent-bystander protection)
        need = max(
            (int(b.get("bytes", 0)) for b in blocked), default=0
        )
        if self.kill_policy == "last-admitted":
            # RUNNING only: a QUEUED query holds nothing and the
            # admission gate's promise is that it is never failed
            cands = [
                (q.stats.create_time, qid)
                for qid, q in list(self.coord.queries.items())
                if running(qid) and q.state == "RUNNING"
            ]
            if cands:
                return max(cands)[1]
        else:  # total-reservation
            cands = [
                (b, qid)
                for qid, b in totals.items()
                if b >= max(need, 1) and running(qid)
            ]
            if cands:
                return max(cands)[1]
        for b in blocked:
            owner = str(b.get("owner", "")).split("#", 1)[0]
            if running(owner):
                return owner
        return None

    def record_kill(
        self, victim: str, policy: str, reason: str, nbytes: int
    ) -> None:
        """Retain one applied kill decision for observability (the
        coordinator calls this as it applies the kill)."""
        self.decisions.append(
            {
                "ts": time.time(),
                "query_id": victim,
                "policy": policy,
                "reason": reason,
                "bytes": int(nbytes),
            }
        )
        REGISTRY.counter("memory.queries_killed").update()

    # ------------------------------------------------------ observability

    def view_rows(self) -> List[dict]:
        """system.runtime.memory rows: per-node totals, per-(node,
        query) holders, and the retained kill decisions."""
        rows: List[dict] = []
        for node, rep in sorted(self._view().items()):
            rows.append(
                {
                    "node_id": node,
                    "query_id": "",
                    "state": "BLOCKED" if rep["blocked"] else "OK",
                    "reserved_bytes": rep["reserved"],
                    "peak_bytes": sum(
                        int(q.get("peak", 0))
                        for q in rep["queries"].values()
                    ),
                    "blocked_bytes": sum(
                        int(b.get("bytes", 0)) for b in rep["blocked"]
                    ),
                    "spilled_bytes": rep["spilled_bytes"],
                    "limit_bytes": rep["limit"],
                }
            )
            for qid, q in sorted(rep["queries"].items()):
                rows.append(
                    {
                        "node_id": node,
                        "query_id": qid,
                        "state": "RESERVED",
                        "reserved_bytes": int(q.get("bytes", 0)),
                        "peak_bytes": int(
                            q.get("peak", q.get("bytes", 0))
                        ),
                        "blocked_bytes": 0,
                        "spilled_bytes": 0,
                        "limit_bytes": rep["limit"],
                    }
                )
        for d in list(self.decisions):
            rows.append(
                {
                    "node_id": "<cluster>",
                    "query_id": d["query_id"],
                    "state": f"KILLED ({d['policy']})",
                    "reserved_bytes": d["bytes"],
                    "peak_bytes": d["bytes"],
                    "blocked_bytes": 0,
                    "spilled_bytes": 0,
                    "limit_bytes": 0,
                }
            )
        return rows

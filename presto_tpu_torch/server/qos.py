"""Tail-latency QoS plane: priority admission lanes, preempt-and-resume
of analytic queries, and per-group SLO enforcement.

The PyTorch counterpart of ``presto_tpu/server/qos.py``, the same
controller over the port's session, fault plane and metrics. The plane
is host-side: a suspended query's resumed ranges run through the
workers' runners as before (a GROUP BY there is one
``onehot_reduce_many`` launch, K1, per batch).

Reference parity: Presto's resource-group/admission machinery is the
layer that keeps interactive traffic alive under mixed load (PAPER.md;
SURVEY.md §2.1 "Dispatch/queue"). At serving scale p99 *is* the
product, and every mechanism this plane needs already exists on the
shelf — weighted-fair resource groups, the drain protocol + spooled
stage recovery, the memory killer's journaled victim policies. This
module composes them:

- **Priority lanes at admission.** Resource groups gain a ``priority``
  (group spec, or ``qos.<group>.priority`` config) and an optional
  latency SLO (``qos.<group>.target-p99-ms``). The coordinator's
  admission path dequeues STRICTLY by lane (higher priority always
  first) with the resource-group weighted-fair rule (smallest
  running/weight ratio) inside a lane.

- **Preempt-and-resume, not kill.** When a higher-priority query
  queues behind running lower-priority work, the controller picks a
  victim (lowest priority first, newest admission first — the mirror
  of the memory killer's last-admitted policy) and SUSPENDS it: the
  victim's stage threads park at the next range boundary (claimed
  ranges run to completion — tasks exit clean, spool-backed producers
  commit their partition output to the ``ExchangeSpool``), the slot
  frees immediately for the interactive lane, the query parks as
  ``SUSPENDED`` with a journal frame recording its spooled progress,
  and its cluster memory reservation releases. Resume re-admits the
  parked query at the FRONT of its own lane (it already held a slot
  once); the stage loop continues with the SAME logical task ids, so
  completed producer attempts are never re-run — a merge task whose
  producer died during the suspension re-serves the committed
  partitions from the spool.

- **Re-suspend hysteresis.** A resumed query is immune to further
  preemption for ``qos.resume-grace-s``, and no query is suspended
  more than ``qos.max-suspensions-per-query`` times — a storm of
  interactive arrivals cannot livelock an analytic query (the
  ``suspend_storm`` fault rule makes exactly this testable).

- **Deadline-aware straggler speculation.** ``speculation_scale``
  tightens the straggler threshold as a query approaches its
  group's SLO budget (linear down to a 0.25 floor) — a query about to
  blow its p99 target speculates earlier.

- **Observability.** Per-group p50/p99 reservoir latency quantiles,
  suspension/resume counters, and SLO misses serve as
  ``system.runtime.qos`` and inside ``GET /v1/query`` QueryInfo.

Gated end-to-end by ``qos.enabled=false`` (default): disabled, the
controller is never constructed and the coordinator keeps its
bit-exact legacy admission semaphore.

Confinement: victim selection, suspend, and resume live HERE; the coordinator only calls
``qos_admit`` / ``qos_release`` / ``qos_checkpoint`` /
``speculation_scale``, and the journal/arbiter/spool hooks
(``record_suspend`` / ``record_resume`` / ``suspend_release`` /
``committed_for_query``) are reached only from this module.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from presto_tpu_torch.session import NodeConfig
from presto_tpu_torch.utils import faults
from presto_tpu_torch.utils.metrics import REGISTRY, DistributionStat

log = logging.getLogger("presto_tpu_torch.qos")

#: per-group config keys (qos.<group>.priority / .target-p99-ms) —
#: the ONE pattern NodeConfig validates with, so acceptance and
#: consumption can never drift
_GROUP_KEY = NodeConfig._QOS_GROUP_KEY

#: floor of the deadline-aware speculation tightening — a query past
#: its whole SLO budget still speculates at 1/4 the normal threshold,
#: never at zero (which would speculate every range)
SPECULATION_FLOOR = 0.25


class _QosGroup:
    """One admission lane member: a resource group's QoS state."""

    __slots__ = (
        "name", "priority", "weight", "target_p99_ms", "latency",
        "queue", "running", "queries", "slo_misses", "suspensions",
        "resumes",
    )

    def __init__(self, name: str, priority: int = 0, weight: int = 1):
        self.name = name
        self.priority = int(priority)
        self.weight = max(int(weight), 1)
        self.target_p99_ms: Optional[float] = None
        #: per-group end-to-end latency reservoir (p50/p99 in the
        #: system.runtime.qos view)
        self.latency = DistributionStat()
        #: waiting admissions, FIFO; resume re-entries go to the FRONT
        self.queue: deque = deque()
        self.running = 0
        self.queries = 0
        self.slo_misses = 0
        self.suspensions = 0
        self.resumes = 0


class _QosEntry:
    """One query's admission state. ``event`` doubles as the admission
    gate (``qos_admit`` waits on it) and the resume gate (a suspended
    query's parked stage threads wait on it in ``qos_checkpoint``)."""

    __slots__ = (
        "q", "qid", "group", "state", "event", "seq", "resuming",
        "resume_pending", "effects_done", "suspensions",
        "suspended_ms", "suspend_t0", "last_resume",
    )

    def __init__(self, q, group: _QosGroup):
        self.q = q
        self.qid = q.qid
        self.group = group
        self.state = "WAITING"  # WAITING | RUNNING | SUSPENDED
        self.event = threading.Event()
        self.seq = 0  # admission order (victim pick: newest first)
        #: queued-for-resume (entry sits at its lane's front)
        self.resuming = False
        #: dispatched after a suspension; the first parked thread to
        #: wake finalizes the resume (journal/counters) exactly once
        self.resume_pending = False
        #: suspend side effects (journal frame, memory release) have
        #: been applied: a resume close-out orders itself AFTER this,
        #: so an instant re-dispatch can never journal qos_resume
        #: before qos_suspend or un-suspend a state write in flight
        self.effects_done = threading.Event()
        self.effects_done.set()  # no suspension outstanding
        self.suspensions = 0
        self.suspended_ms = 0.0
        self.suspend_t0 = 0.0
        self.last_resume = 0.0

    @property
    def priority(self) -> int:
        return self.group.priority


class QosController:
    """The coordinator's QoS plane: priority-lane admission +
    preempt-and-resume + per-group SLO accounting. One instance per
    coordinator, constructed only when ``qos.enabled=true``."""

    def __init__(self, coord, config, max_concurrent: int):
        self.coord = coord
        self.slots = max(int(max_concurrent), 1)
        get = (
            (lambda k, d=None: config.get(k, d))
            if config is not None
            else (lambda k, d=None: d)
        )
        #: a resumed query is immune to re-suspension this long
        self.resume_grace_s = float(get("qos.resume-grace-s", 5.0))
        #: lifetime suspension cap per query (0 = never preempt)
        self.max_suspensions = int(
            get("qos.max-suspensions-per-query", 2)
        )
        self._cond = threading.Condition()
        self._groups: Dict[str, _QosGroup] = {}
        #: multi-coordinator hook (server/lease.py plane): returns
        #: {peer_id: {lane: {"running", "queued"}}} from live peer
        #: lease payloads; None (default) = local-only view, bit-exact
        self.peer_lanes_fn = None
        #: qid -> entry, admission through release (suspended included)
        self._entries: Dict[str, _QosEntry] = {}
        self._running: Dict[str, _QosEntry] = {}
        self._seq = itertools.count(1)
        # seed lanes from the resource-group tree (priority may live in
        # the group spec), then apply qos.<group>.* config overrides —
        # a config-named group not in the tree still gets a lane (its
        # selectors just never route there until groups are configured)
        rg = getattr(coord, "resource_groups", None)
        if rg is not None:
            for g in rg.groups.values():
                self._groups[g.name] = _QosGroup(
                    g.name,
                    priority=int(getattr(g, "priority", 0)),
                    weight=g.weight,
                )
        for key, val in (getattr(config, "props", None) or {}).items():
            m = _GROUP_KEY.match(key)
            if m is None:
                continue
            grp = self._group(m.group(1))
            if m.group(2) == "priority":
                grp.priority = int(val)
            else:
                grp.target_p99_ms = float(val)

    # ------------------------------------------------------------ groups

    def _group(self, name: str) -> _QosGroup:
        g = self._groups.get(name)
        if g is None:
            g = self._groups[name] = _QosGroup(name)
        return g

    def group_of(self, q) -> _QosGroup:
        return self._group(
            getattr(q, "resource_group", None) or "default"
        )

    # --------------------------------------------------------- admission

    def qos_admit(self, q) -> bool:
        """Block until the query is admitted by its lane — True — or
        it died / the coordinator is shutting down — False, and the
        caller must NOT execute (un-admitted queries stampeding into
        execution at shutdown would run unbounded; the legacy
        semaphore keeps them blocked). Enqueues FIFO within the
        query's group; dispatch picks the highest-priority lane first,
        weighted-fair within a lane. While waiting, a strictly-higher-
        priority entry periodically re-evaluates preemption —
        hysteresis-refused victims become eligible again when their
        grace expires."""
        group = self.group_of(q)
        entry = _QosEntry(q, group)
        victim = None
        with self._cond:
            entry.seq = next(self._seq)
            self._entries[q.qid] = entry
            group.queue.append(entry)
            self._dispatch_locked()
            if entry.state == "WAITING":
                victim = self._preempt_locked(entry)
        if victim is not None:
            REGISTRY.counter("qos.preempt_triggers").update()
            self._apply_suspend_effects(victim)
        while not entry.event.wait(timeout=0.1):
            if q.done.is_set() or self.coord._shutting_down:
                return False
            victim = None
            with self._cond:
                if entry.state == "WAITING":
                    victim = self._preempt_locked(entry)
            if victim is not None:
                REGISTRY.counter("qos.preempt_triggers").update()
                self._apply_suspend_effects(victim)
        REGISTRY.counter("qos.admitted").update()
        return True

    def qos_release(self, q) -> None:
        """Query finished (any terminal state): free its slot — or its
        lane entry, if it died while waiting/suspended — fold its
        latency into the group reservoir, and dispatch the next
        admission."""
        pending = self._entries.get(q.qid)
        if pending is not None and pending.resume_pending:
            # resumed but never parked (the suspension landed while no
            # stage thread was at a checkpoint): close the resume out
            # here so suspension/resume accounting stays paired
            self._finish_resume(pending)
        with self._cond:
            entry = self._entries.pop(q.qid, None)
            if entry is None:
                return
            if self._running.pop(q.qid, None) is not None:
                entry.group.running -= 1
            else:
                try:
                    entry.group.queue.remove(entry)
                except ValueError:
                    pass  # dispatched-but-skipped (died waiting)
            entry.resume_pending = False
            entry.group.queries += 1
            miss = False
            if q.state == "FINISHED":
                elapsed = q.stats.elapsed_ms
                entry.group.latency.add(elapsed)
                target = entry.group.target_p99_ms
                if target and elapsed > target:
                    entry.group.slo_misses += 1
                    miss = True
            self._dispatch_locked()
        if miss:
            REGISTRY.counter("qos.slo_misses").update()

    def _dispatch_locked(self) -> None:
        """Fill free slots: strict priority across lanes, weighted-fair
        (smallest running/weight, then name) among same-priority
        groups, FIFO within a group. Resume re-entries sit at their
        lane's front, so a suspended query resumes before its group's
        queued newcomers."""
        while len(self._running) < self.slots:
            best = None
            for g in self._groups.values():
                if not g.queue:
                    continue
                key = (-g.priority, g.running / g.weight, g.name)
                if best is None or key < best[0]:
                    best = (key, g)
            if best is None:
                return
            g = best[1]
            entry = g.queue.popleft()
            if entry.q.done.is_set():
                continue  # died while waiting: never occupy a slot
            entry.state = "RUNNING"
            if entry.resuming:
                entry.resuming = False
                entry.resume_pending = True
            self._running[entry.qid] = entry
            g.running += 1
            entry.event.set()

    # -------------------------------------------------------- preemption

    def _suspendable_locked(self, e: _QosEntry) -> bool:
        """Hysteresis gate: under the lifetime cap AND outside the
        post-resume grace window. An entry whose resume is dispatched
        but not yet finalized (no stage thread reached a checkpoint)
        is inside the grace by definition — re-suspending it would
        silently cancel the pending resume close-out and leave the
        suspend/resume accounting unpaired."""
        if e.resume_pending:
            return False
        if e.suspensions >= self.max_suspensions:
            return False
        if (
            e.last_resume
            and time.monotonic() - e.last_resume < self.resume_grace_s
        ):
            return False
        return True

    def _choose_victim_locked(
        self, waiter: _QosEntry
    ) -> Optional[_QosEntry]:
        """Victim among RUNNING entries of strictly lower priority:
        lowest priority first, then newest admission (the least sunk
        work — mirroring the memory killer's last-admitted policy),
        hysteresis-filtered."""
        best = None
        for e in self._running.values():
            if e.priority >= waiter.priority or e.q.done.is_set():
                continue
            if e.q.state != "RUNNING":
                # QUEUED = parked in the arbiter admission hold (no
                # compute to free — suspending it only burns its
                # lifetime cap and desyncs the state machine);
                # FINISHED/FAILED = closing out, nothing to suspend
                continue
            if not self._suspendable_locked(e):
                continue
            key = (e.priority, -e.seq)
            if best is None or key < best[0]:
                best = (key, e)
        return best[1] if best else None

    def _preempt_locked(
        self, waiter: _QosEntry
    ) -> Optional[_QosEntry]:
        victim = self._choose_victim_locked(waiter)
        if victim is None:
            return None
        self._suspend_locked(victim)
        self._dispatch_locked()
        return victim

    def _suspend_locked(self, e: _QosEntry) -> None:
        """Slot-accounting half of a suspension (the side effects —
        journal frame, memory release, query state — run outside the
        lock in ``_apply_suspend_effects``). The entry re-enqueues at
        its lane's FRONT for resume."""
        e.state = "SUSPENDED"
        e.suspend_t0 = time.monotonic()
        e.suspensions += 1
        e.resuming = True
        e.resume_pending = False
        e.effects_done.clear()
        e.event.clear()
        self._running.pop(e.qid, None)
        e.group.running -= 1
        e.group.suspensions += 1
        e.group.queue.appendleft(e)
        # the query-visible state flips HERE, under the lock: a resume
        # close-out (_finish_resume, same lock + effects_done barrier)
        # is strictly ordered after it, so an instant re-dispatch can
        # never leave a running query stuck SUSPENDED. Terminal states
        # keep priority — the victim may be closing out concurrently
        q = e.q
        if not q.done.is_set() and q.state not in (
            "FINISHED",
            "FAILED",
        ):
            q.state = "SUSPENDED"
            q.stats.state = "SUSPENDED"

    def _apply_suspend_effects(self, e: _QosEntry) -> None:
        """Side effects of one suspension decision, OUTSIDE the
        controller lock (journal appends and spool scans block):
        journal the frame with the victim's spooled progress and
        release its cluster memory reservation (the arbiter stops
        charging a parked query immediately; its draining worker
        tasks re-assert whatever they still hold on their next
        heartbeats). The query-visible SUSPENDED flip already
        happened under the lock in ``_suspend_locked``;
        ``effects_done`` (set in the finally) is the barrier a resume
        close-out orders itself after — an instant re-dispatch can
        never journal ``qos_resume`` before ``qos_suspend``."""
        q = e.q
        try:
            q.qos_suspensions = e.suspensions
            REGISTRY.counter("qos.suspensions").update()
            spooled = 0
            spool = getattr(self.coord, "spool", None)
            if spool is not None:
                try:
                    spooled = spool.committed_for_query(q.qid)
                except Exception:
                    pass
            with q._stats_lock:
                stages = sum(
                    1 for st in q.stats.stages if st.state == "RUNNING"
                )
            journal = getattr(self.coord, "journal", None)
            if journal is not None:
                journal.record_suspend(
                    q.qid,
                    spooled_attempts=spooled,
                    running_stages=stages,
                    suspensions=e.suspensions,
                )
            log.info(
                "qos: suspended %s (group %s, suspension %d, %d spooled "
                "attempt(s), %d running stage(s))",
                q.qid, e.group.name, e.suspensions, spooled, stages,
            )
            try:
                # cluster reservation: drop the victim from the
                # arbiter's cached reports now, and surrender the
                # coordinator pool's own accounting (the parked query
                # re-reserves on resume; later paired releases clamp
                # at zero — the memory-kill re-admission lane's
                # discipline)
                self.coord.arbiter.suspend_release(q.qid)
                self.coord.memory_pool.release(q.qid)
            except Exception:
                log.warning(
                    "qos: suspend memory release failed for %s",
                    q.qid, exc_info=True,
                )
        finally:
            e.effects_done.set()

    # ------------------------------------------------------- checkpoints

    def qos_checkpoint(self, q) -> None:
        """Cooperative suspension point, called by the coordinator's
        stage machinery between ranges: a suspended query's stage
        threads PARK here until resume (claimed ranges already ran to
        completion — tasks exit clean), then the first thread to wake
        finalizes the resume. Also the ``suspend_storm`` fault hook:
        an armed rule triggers a preemption against this query even
        with no higher-priority waiter, which is how the re-suspend
        hysteresis is tested."""
        if q is None:
            return
        if faults.maybe_inject_qos(q.qid):
            self._storm_trigger(q)
        entry = self._entries.get(q.qid)
        if entry is None:
            return
        if not entry.event.is_set():
            while not entry.event.wait(timeout=0.1):
                if q.done.is_set() or self.coord._shutting_down:
                    return
        if entry.resume_pending:
            self._finish_resume(entry)

    def _storm_trigger(self, q) -> None:
        """One injected preemption trigger against ``q`` (the
        ``suspend_storm`` fault rule): counts as a trigger whether or
        not hysteresis lets it suspend."""
        REGISTRY.counter("qos.preempt_triggers").update()
        victim = None
        with self._cond:
            e = self._running.get(q.qid)
            if (
                e is not None
                and e.q.state == "RUNNING"
                and self._suspendable_locked(e)
            ):
                self._suspend_locked(e)
                self._dispatch_locked()
                victim = e
        if victim is not None:
            self._apply_suspend_effects(victim)

    def _finish_resume(self, entry: _QosEntry) -> None:
        """Exactly-once resume close-out (the winning parked thread, or
        the release path for a query that never parked again). Ordered
        AFTER the matching suspension's side effects: an instant
        re-dispatch (storm with a free slot) must not journal the
        resume before the suspend frame or un-suspend a state write in
        flight."""
        entry.effects_done.wait(timeout=10.0)
        dur = 0.0
        fire = False
        with self._cond:
            if entry.resume_pending:
                entry.resume_pending = False
                now = time.monotonic()
                dur = (now - entry.suspend_t0) * 1000.0
                entry.last_resume = now
                entry.suspended_ms += dur
                entry.group.resumes += 1
                fire = True
        if not fire:
            return
        q = entry.q
        if not q.done.is_set() and q.state == "SUSPENDED":
            # flip only a still-SUSPENDED query: a terminal state
            # written concurrently (kill, failure) keeps priority
            q.state = "RUNNING"
            q.stats.state = "RUNNING"
        q.qos_resumes = getattr(q, "qos_resumes", 0) + 1
        q.qos_suspended_ms = (
            getattr(q, "qos_suspended_ms", 0.0) + dur
        )
        REGISTRY.counter("qos.resumes").update()
        REGISTRY.distribution("qos.suspended_ms").add(dur)
        journal = getattr(self.coord, "journal", None)
        if journal is not None:
            journal.record_resume(q.qid, suspended_ms=dur)
        log.info(
            "qos: resumed %s after %.0fms suspended", q.qid, dur
        )

    # ------------------------------------------------------- speculation

    def speculation_scale(self, q) -> float:
        """Deadline-aware straggler speculation: multiply the
        straggler threshold by this factor. 1.0 with no SLO; shrinks linearly to
        ``SPECULATION_FLOOR`` as elapsed time eats the group's
        ``target-p99-ms`` budget — a query about to miss its SLO
        speculates earlier."""
        target = self.group_of(q).target_p99_ms
        if not target or target <= 0:
            return 1.0
        frac = q.stats.elapsed_ms / target
        return min(1.0, max(SPECULATION_FLOOR, 1.0 - frac))

    # ----------------------------------------------------- observability

    def query_info(self, q) -> dict:
        """The QueryInfo ``qos`` section for one query."""
        g = self.group_of(q)
        return {
            "group": g.name,
            "priority": g.priority,
            "target_p99_ms": g.target_p99_ms,
            "suspensions": getattr(q, "qos_suspensions", 0),
            "resumes": getattr(q, "qos_resumes", 0),
            "suspended_ms": getattr(q, "qos_suspended_ms", 0.0),
        }

    def background_idle(self) -> bool:
        """May low-priority background work (lakehouse compaction,
        server/ingest.py) run now? True when no query is running or
        queued in any lane — background rewrites yield to ANY live
        foreground work rather than competing for device time."""
        with self._cond:
            return not self._running and all(
                not g.queue for g in self._groups.values()
            )

    def lane_occupancy(self) -> dict:
        """Per-lane live occupancy — the QoS share of this
        coordinator's lease payload (server/lease.py): peers fold it
        into their ``system.runtime.qos`` view so lane pressure is
        visible cluster-wide across N admitters."""
        with self._cond:
            return {
                g.name: {
                    "running": g.running,
                    "queued": len(g.queue),
                }
                for g in self._groups.values()
            }

    def view_rows(self) -> List[dict]:
        """``system.runtime.qos``: one row per lane member. With the
        multi-coordinator lease plane on (``peer_lanes_fn`` set by the
        coordinator), live peers' published lane occupancy folds into
        the running/queued columns — the view reads cluster-wide;
        single-coordinator deploys are bit-exact."""
        peer_lanes: dict = {}
        if self.peer_lanes_fn is not None:
            try:
                peer_lanes = self.peer_lanes_fn() or {}
            except Exception:
                peer_lanes = {}
        with self._cond:
            snap = []
            for g in self._groups.values():
                suspended = sum(
                    1 for e in g.queue if e.state == "SUSPENDED"
                )
                # suspended entries park at the lane front — they are
                # not "queued" occupancy, so the two columns stay
                # disjoint (running + queued + suspended = live)
                snap.append(
                    (
                        g,
                        g.running,
                        len(g.queue) - suspended,
                        suspended,
                    )
                )
        rows = []
        for g, running, queued, suspended in sorted(
            snap, key=lambda t: (-t[0].priority, t[0].name)
        ):
            for lanes in peer_lanes.values():
                peer = lanes.get(g.name)
                if isinstance(peer, dict):
                    running += int(peer.get("running", 0))
                    queued += int(peer.get("queued", 0))
            v = g.latency.values()
            rows.append(
                {
                    "group": g.name,
                    "priority": g.priority,
                    "target_p99_ms": g.target_p99_ms or 0.0,
                    "queries": g.queries,
                    "running": running,
                    "queued": queued,
                    "suspended": suspended,
                    "p50_ms": v["p50"],
                    "p99_ms": v["p99"],
                    "slo_misses": g.slo_misses,
                    "suspensions": g.suspensions,
                    "resumes": g.resumes,
                }
            )
        return rows

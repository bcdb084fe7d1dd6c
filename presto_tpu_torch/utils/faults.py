"""Deterministic fault-injection plane (chaos hook for tests).

Reference parity: production Presto proves its failure detector and
recoverable execution under real node loss; this repo's tier-1 suite
cannot kill processes, so the equivalent lever is a seedable in-process
fault plane. Rules match RPCs (by method / URL substring) or worker
task executions (by node / task id substring) and inject delays,
connection-level errors, dropped connections, task kills, or whole-
worker crashes — deterministically, so a chaos regression stays a
regression test and not a flake.

Disabled by default with zero hot-path cost: the hooks
(:func:`maybe_inject_rpc`, :func:`maybe_inject_task`) read one module
global and return immediately when no plane is configured. A plane is
installed via :func:`configure` (tests, or the ``fault-injection.spec``
node-config key) or the ``PRESTO_TPU_FAULTS`` environment variable
(JSON, parsed at import).

Rule spec (all match fields optional; empty matches everything)::

    {"seed": 7,
     "rules": [
       {"action": "error",  "method": "GET", "url": ":8081", "count": 5},
       {"action": "delay",  "url": "/results/", "delay_s": 2.0},
       {"action": "drop",   "url": "/v1/task", "skip": 2, "count": 1},
       {"action": "kill_task",   "node": "worker-ab"},
       {"action": "kill_worker", "task": "q_c1_"},
       {"action": "kill_worker_preempt", "node": "worker-ab"},
       {"action": "spool_corrupt", "task": ".prod."},
       {"action": "kill_worker_draining", "node": "worker-ab"},
       {"action": "reserve_fail", "owner": "q_c1_", "skip": 2,
        "count": 1},
       {"action": "mem_pressure", "node": "worker-ab",
        "budget": 65536},
       {"action": "suspend_storm", "owner": "q_c1_", "count": 3},
       {"action": "kill_coordinator", "node": "coord-b", "owner": "q_c3_"},
     ]}

``count`` bounds how many times a rule fires (default unlimited),
``skip`` lets that many matches pass through first, and ``prob`` draws
from the plane's seeded RNG. ``kill_worker`` additionally invokes the
worker-supplied kill callback (abrupt socket close — a crash, not a
drain) before raising.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
import time
from typing import List, Optional

from presto_tpu_torch.utils.metrics import REGISTRY

#: actions injected at the RPC hook (caller side of a call)
RPC_ACTIONS = ("delay", "error", "drop")
#: actions injected at the worker task-execute hook.
#: ``kill_worker_preempt`` models a cloud preemption notice: the worker
#: starts an immediate graceful drain (short grace) while the current
#: task keeps running — new tasks 503-reschedule, finished buffers
#: serve/spool, then the worker exits
TASK_ACTIONS = ("delay", "kill_task", "kill_worker", "kill_worker_preempt")
#: actions injected at the exchange-spool read hook (server.spool):
#: flips a spooled payload byte so the checksum framing must catch it
SPOOL_ACTIONS = ("spool_corrupt",)
#: actions injected at the worker drain hook (server.worker.drain):
#: crashes a worker WHILE it is draining — the drain protocol must
#: stay recoverable mid-handshake
DRAIN_ACTIONS = ("kill_worker_draining",)
#: actions injected at the QoS checkpoint hook (server.qos):
#: ``suspend_storm`` delivers a preemption trigger against the
#: matched query at its next cooperative checkpoint — ``count: N``
#: models N back-to-back interactive arrivals targeting one analytic
#: query, which is how the controller's re-suspend hysteresis
#: (``qos.resume-grace-s`` immunity after a resume) is tested
QOS_ACTIONS = ("suspend_storm",)
#: actions injected at the coordinator query-execution hook
#: (server.coordinator): ``kill_coordinator`` crashes the WHOLE
#: coordinator — lease renewal stops, the socket closes abruptly, the
#: journal goes silent mid-query — exactly the failure the
#: multi-coordinator failover plane must absorb. Owner-matched like
#: the reserve rules (``owner`` = query-id substring) plus ``node``
#: (coordinator-id substring), so a 3-coordinator chaos test kills
#: one specific admitter on one specific query, deterministically.
COORD_ACTIONS = ("kill_coordinator",)
#: actions injected at the MemoryPool reserve hook (utils.memory):
#: ``reserve_fail`` forces a pool reservation failure at the Nth
#: matched reserve (skip/count bound it); ``mem_pressure`` shrinks the
#: pool's effective budget to ``budget`` bytes mid-query — both make
#: the low-memory killer and host-spill paths chaos-testable without
#: real HBM exhaustion
MEM_ACTIONS = ("reserve_fail", "mem_pressure")
#: actions injected at durable-write sites (manifest publishes, WAL /
#: journal / spool appends): ``io_error`` raises ``OSError`` at the
#: Nth matched write/fsync/rename whose path contains ``path`` —
#: disk-full and torn-write chaos without real disk pressure. The
#: ``op`` field narrows the stage ("write", "fsync", "rename";
#: "" = any), so a lakehouse test can fail exactly the ``_current``
#: pointer swap and nothing else
IO_ACTIONS = ("io_error",)


class FaultInjectedError(ConnectionError):
    """An injected connection-level failure. Subclasses
    ``ConnectionError`` so retry/breaker classification treats it
    exactly like a real dead socket."""


@dataclasses.dataclass
class FaultRule:
    """One match->inject rule; firing state is guarded by the plane."""

    action: str
    method: str = ""  # exact HTTP method ("" = any)
    url: str = ""  # URL substring ("" = any)
    node: str = ""  # node-id substring (task + reserve hooks)
    task: str = ""  # task-id substring (task hook)
    owner: str = ""  # pool-owner/query-id substring (reserve hook)
    path: str = ""  # file-path substring (io hook)
    op: str = ""  # io stage: "write"/"fsync"/"rename" ("" = any)
    delay_s: float = 0.0
    count: int = -1  # firings remaining (-1 = unlimited)
    skip: int = 0  # matches to pass through before firing
    prob: float = 1.0  # firing probability (plane-seeded RNG)
    budget: int = 0  # mem_pressure: shrink the pool to this many bytes

    @staticmethod
    def from_dict(d: dict) -> "FaultRule":
        known = {f.name for f in dataclasses.fields(FaultRule)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown fault-rule keys: {sorted(unknown)}")
        rule = FaultRule(**d)
        known_actions = (
            set(RPC_ACTIONS)
            | set(TASK_ACTIONS)
            | set(SPOOL_ACTIONS)
            | set(DRAIN_ACTIONS)
            | set(MEM_ACTIONS)
            | set(QOS_ACTIONS)
            | set(COORD_ACTIONS)
            | set(IO_ACTIONS)
        )
        if rule.action not in known_actions:
            raise ValueError(f"unknown fault action: {rule.action!r}")
        return rule


class FaultPlane:
    """A configured set of rules plus the seeded RNG that makes both
    probabilistic firing and retry-backoff jitter reproducible."""

    def __init__(self, spec):
        if isinstance(spec, str):
            spec = json.loads(spec)
        self.seed = int(spec.get("seed", 0))
        #: rule-probability stream. Kept SEPARATE from the backoff
        #: stream so ``prob`` draws and retry jitter cannot perturb
        #: each other's sequences. Determinism is per-stream: with
        #: concurrent threads drawing, the interleaving (and so which
        #: call gets which draw) still follows the scheduler — fully
        #: deterministic chaos wants count/skip rules, not prob.
        self.rng = random.Random(self.seed)
        #: backoff-jitter stream (server.rpc draws from this while a
        #: plane is active, making seeded single-threaded backoff
        #: schedules reproducible)
        self.backoff_rng = random.Random(self.seed ^ 0x5EEDBACC)
        self.rules: List[FaultRule] = [
            FaultRule.from_dict(dict(r)) for r in spec.get("rules", ())
        ]
        self._lock = threading.Lock()
        self.injected = 0

    def _fire(self, rule: FaultRule) -> bool:
        """Skip/count/probability bookkeeping for one matched rule."""
        with self._lock:
            if rule.skip > 0:
                rule.skip -= 1
                return False
            if rule.count == 0:
                return False
            if rule.prob < 1.0 and self.rng.random() >= rule.prob:
                return False
            if rule.count > 0:
                rule.count -= 1
            self.injected += 1
        REGISTRY.counter("faults.injected").update()
        return True

    def on_rpc(self, method: str, url: str) -> None:
        """RPC-site hook: may sleep (delay) or raise (error/drop)."""
        for rule in self.rules:
            if rule.action not in RPC_ACTIONS:
                continue
            if rule.node or rule.task:
                continue  # a task-scoped rule stays task-scoped
            if rule.method and rule.method != method:
                continue
            if rule.url and rule.url not in url:
                continue
            if not self._fire(rule):
                continue
            if rule.action == "delay":
                time.sleep(rule.delay_s)
            elif rule.action == "error":
                raise FaultInjectedError(
                    f"injected RPC error: {method} {url}"
                )
            else:  # drop
                raise FaultInjectedError(
                    f"injected connection drop: {method} {url}"
                )

    def on_task(
        self, node_id: str, task_id: str, kill=None, preempt=None
    ) -> None:
        """Worker task-execute hook: may sleep, fail the task
        (``kill_task``), crash the whole worker (``kill_worker`` —
        invokes ``kill`` to close the socket abruptly, then raises), or
        deliver a preemption notice (``kill_worker_preempt`` — invokes
        ``preempt``, which starts the worker's drain-with-short-grace
        in the background; the current task keeps running and the rule
        does NOT raise, exactly like a real SIGTERM-with-grace)."""
        for rule in self.rules:
            if rule.action not in TASK_ACTIONS:
                continue
            if rule.method or rule.url:
                continue  # an RPC-scoped delay rule stays RPC-scoped
            if rule.node and rule.node not in node_id:
                continue
            if rule.task and rule.task not in task_id:
                continue
            if not self._fire(rule):
                continue
            if rule.action == "delay":
                time.sleep(rule.delay_s)
            elif rule.action == "kill_task":
                raise FaultInjectedError(
                    f"injected task kill: {task_id} on {node_id}"
                )
            elif rule.action == "kill_worker_preempt":
                if preempt is not None:
                    preempt()
            else:  # kill_worker: crash, not drain
                if kill is not None:
                    kill()
                raise FaultInjectedError(
                    f"injected worker kill: {node_id} (task {task_id})"
                )

    def on_spool(self, task_id: str) -> bool:
        """Spool-read hook: True when a ``spool_corrupt`` rule fires —
        the reader flips a payload byte BEFORE checksum verification,
        so the corruption-detection path itself is what gets tested."""
        for rule in self.rules:
            if rule.action not in SPOOL_ACTIONS:
                continue
            if rule.task and rule.task not in task_id:
                continue
            if self._fire(rule):
                return True
        return False

    def on_qos(self, query_id: str) -> bool:
        """QoS checkpoint hook (server.qos): True when a
        ``suspend_storm`` rule fires for this query — the controller
        treats it as one preemption trigger (suspend if hysteresis
        allows, count it either way). ``owner`` matches the query id
        by substring, like the reserve-hook rules."""
        for rule in self.rules:
            if rule.action not in QOS_ACTIONS:
                continue
            if rule.method or rule.url or rule.node or rule.task:
                continue  # scoped rules stay in their own hooks
            if rule.owner and rule.owner not in query_id:
                continue
            if self._fire(rule):
                return True
        return False

    def on_reserve(self, node_id: str, owner: str):
        """MemoryPool reserve hook: returns ``("reserve_fail", None)``
        when a reserve_fail rule fires (the pool raises its own
        MemoryLimitExceeded — this module must not import utils.memory)
        or ``("mem_pressure", budget)`` when a mem_pressure rule fires
        (the pool shrinks its effective budget); None otherwise."""
        for rule in self.rules:
            if rule.action not in MEM_ACTIONS:
                continue
            if rule.method or rule.url or rule.task:
                continue  # RPC-/task-scoped rules stay out of the pool
            if rule.node and rule.node not in node_id:
                continue
            if rule.owner and rule.owner not in owner:
                continue
            if not self._fire(rule):
                continue
            if rule.action == "mem_pressure":
                return ("mem_pressure", int(rule.budget))
            return ("reserve_fail", None)
        return None

    def on_io(self, op: str, path: str) -> None:
        """Durable-write hook (manifest publishes, WAL/journal/spool
        appends): an ``io_error`` rule raises ``OSError`` at the Nth
        matched ``op`` whose path contains ``path`` — the caller must
        degrade exactly as it would on a real disk-full/EIO."""
        for rule in self.rules:
            if rule.action not in IO_ACTIONS:
                continue
            if rule.method or rule.url or rule.node or rule.task:
                continue  # scoped rules stay in their own hooks
            if rule.op and rule.op != op:
                continue
            if rule.path and rule.path not in path:
                continue
            if not self._fire(rule):
                continue
            raise OSError(
                f"injected io_error: {op} {path}"
            )

    def on_coordinator(
        self, node_id: str, query_id: str, kill=None
    ) -> None:
        """Coordinator query-execution hook: a ``kill_coordinator``
        rule crashes the coordinator (``kill`` stops lease renewal and
        closes the socket abruptly — journal writes go silent, exactly
        like a process death) and raises into the matched query's
        execution thread. The query stays OPEN in the dead journal, so
        a lease-fenced peer resumes it."""
        for rule in self.rules:
            if rule.action not in COORD_ACTIONS:
                continue
            if rule.method or rule.url or rule.task:
                continue  # scoped rules stay in their own hooks
            if rule.node and rule.node not in node_id:
                continue
            if rule.owner and rule.owner not in query_id:
                continue
            if not self._fire(rule):
                continue
            if kill is not None:
                kill()
            raise FaultInjectedError(
                f"injected coordinator kill: {node_id} "
                f"(query {query_id})"
            )

    def on_drain(self, node_id: str, kill=None) -> None:
        """Worker drain hook: a ``kill_worker_draining`` rule crashes
        the worker mid-drain (abrupt socket close via ``kill``, then
        raises) — rolling restarts must survive a node dying during
        its own drain handshake."""
        for rule in self.rules:
            if rule.action not in DRAIN_ACTIONS:
                continue
            if rule.node and rule.node not in node_id:
                continue
            if not self._fire(rule):
                continue
            if kill is not None:
                kill()
            raise FaultInjectedError(
                f"injected kill while draining: {node_id}"
            )


#: the active plane; None = disabled (the default, and the hot path)
_PLANE: Optional[FaultPlane] = None


def configure(spec) -> Optional[FaultPlane]:
    """Install a fault plane from a spec dict / JSON string, or clear
    it with a falsy spec. Returns the installed plane (or None)."""
    global _PLANE
    _PLANE = FaultPlane(spec) if spec else None
    return _PLANE


def active() -> Optional[FaultPlane]:
    return _PLANE


def maybe_inject_rpc(method: str, url: str) -> None:
    plane = _PLANE
    if plane is not None:
        plane.on_rpc(method, url)


def maybe_inject_task(
    node_id: str, task_id: str, kill=None, preempt=None
) -> None:
    plane = _PLANE
    if plane is not None:
        plane.on_task(node_id, task_id, kill=kill, preempt=preempt)


def maybe_inject_spool(task_id: str) -> bool:
    plane = _PLANE
    return plane is not None and plane.on_spool(task_id)


def maybe_inject_drain(node_id: str, kill=None) -> None:
    plane = _PLANE
    if plane is not None:
        plane.on_drain(node_id, kill=kill)


def maybe_inject_coordinator(
    node_id: str, query_id: str, kill=None
) -> None:
    """Coordinator query-execution hook (server.coordinator): a
    ``kill_coordinator`` rule crashes the coordinator and raises."""
    plane = _PLANE
    if plane is not None:
        plane.on_coordinator(node_id, query_id, kill=kill)


def maybe_inject_qos(query_id: str) -> bool:
    """QoS checkpoint hook (server.qos): True = one injected
    preemption trigger against this query (``suspend_storm``)."""
    plane = _PLANE
    return plane is not None and plane.on_qos(query_id)


def maybe_inject_io(op: str, path: str) -> None:
    """Durable-write hook (server.manifests publishes, WAL/journal/
    spool appends): an ``io_error`` rule raises ``OSError`` at the
    matched write/fsync/rename."""
    plane = _PLANE
    if plane is not None:
        plane.on_io(op, path)


def maybe_inject_reserve(node_id: str, owner: str):
    """Pool-reserve hook (utils.memory): None, or an action tuple —
    ``("reserve_fail", None)`` / ``("mem_pressure", budget_bytes)``."""
    plane = _PLANE
    if plane is None:
        return None
    return plane.on_reserve(node_id, owner)


_env_spec = os.environ.get("PRESTO_TPU_FAULTS")
if _env_spec:
    configure(_env_spec)

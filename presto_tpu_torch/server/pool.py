"""Elastic worker pools: the autoscaler and the pool-provider SPI.

Reference parity: Presto's disaggregated-coordinator / elastic-cluster
direction treats membership as fluid — capacity is added when the queue
builds and drained away when it idles, and scale-down is a graceful
drain, never a kill (PAPER.md L3; the drain protocol of PR 5 is what
makes shrinking lossless). The autoscaler here is COORDINATOR-DRIVEN:
one control loop reads the admission queue depth, running-query count,
and stage backlog off the existing stats plane and asks a pluggable
:class:`WorkerPoolProvider` to spawn or drain workers within
``pool.min-workers``/``pool.max-workers``.

Decision shape (deterministic, unit-testable via :meth:`Autoscaler.step`):

- **floor**: below ``min_workers``, spawn unconditionally;
- **scale up**: queued queries waiting and headroom below
  ``max_workers`` — responsive, one worker per tick;
- **scale down**: only after ``scale_down_ticks`` CONSECUTIVE idle
  observations AND ``cooldown_s`` since the last action (hysteresis:
  oscillating load ratchets capacity up and holds it; it never flaps
  up-down-up), one worker per tick, newest provider-owned worker first,
  always through the worker's drain protocol (zero query loss).

Providers: :class:`presto_tpu_torch.server.launcher.LocalWorkerPoolProvider`
ships the in-process shape (dev/bench/tests); real deployments
implement the same two-method SPI against their scheduler (k8s
replicas, GCE MIGs, TPU pod managers) — spawned capacity is typically
PREEMPTIBLE, which the scheduler already treats as first-class
(spool-backed producers on preemptibles, gather/merge on stable nodes;
see ``server/scheduler.stable_workers``).

Metrics: ``pool.{scale_up,scale_down,preemptions,resumed_queries,
spawn_failures}``, registered at construction so HELP/TYPE render
before the first event.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional

from presto_tpu_torch.utils.metrics import REGISTRY

log = logging.getLogger("presto_tpu_torch.pool")


class WorkerPoolProvider:
    """SPI: how the autoscaler actually adds/removes capacity.

    Implementations must be idempotent-ish under races: ``drain`` of an
    already-gone node is a no-op, and a ``spawn`` failure raises (the
    autoscaler counts it and retries next tick)."""

    def spawn(self) -> str:
        """Start one worker pointed at the coordinator; returns its
        node id (used for discovery tracking and later drain)."""
        raise NotImplementedError

    def drain(self, node_id: str) -> None:
        """Gracefully drain one worker (the drain protocol: stop
        accepting, finish + serve/spool buffers, exit clean). Must not
        block the autoscaler tick — fire and forget."""
        raise NotImplementedError

    def owns(self, node_id: str) -> bool:
        """Is this worker still the provider's to manage? The
        autoscaler forgets owned workers that are BOTH missing from
        discovery and disowned here — a discovery-TTL flap alone (slow
        announce, wedged coordinator link) must not orphan a live
        worker the provider can still drain. Default: True (never
        disown on TTL evidence only)."""
        return True


class Autoscaler:
    """The coordinator's scale control loop (one daemon thread)."""

    def __init__(
        self,
        coordinator,
        provider: WorkerPoolProvider,
        min_workers: int = 0,
        max_workers: int = 0,
        interval_s: float = 1.0,
        scale_down_ticks: int = 3,
        cooldown_s: Optional[float] = None,
    ):
        self.coordinator = coordinator
        self.provider = provider
        self.min_workers = max(int(min_workers), 0)
        self.max_workers = max(int(max_workers), self.min_workers)
        self.interval_s = max(float(interval_s), 0.01)
        self.scale_down_ticks = max(int(scale_down_ticks), 1)
        #: after any scaling action, no scale-DOWN for this long (the
        #: other hysteresis half; scale-up stays immediate)
        self.cooldown_s = (
            2.0 * self.interval_s if cooldown_s is None else float(cooldown_s)
        )
        #: node ids this autoscaler spawned (newest last — the LIFO
        #: drain order); static workers are never drained
        self.owned: List[str] = []
        self.last_decision = ""
        self._idle_ticks = 0
        self._last_action = float("-inf")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # register the pool metric families up front so HELP/TYPE
        # render before the first scaling event
        for m in (
            "pool.scale_up",
            "pool.scale_down",
            "pool.preemptions",
            "pool.resumed_queries",
            "pool.spawn_failures",
        ):
            REGISTRY.counter(m)

    # -------------------------------------------------------- lifecycle

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # ---------------------------------------------------------- control

    def step(
        self,
        queued: int,
        running: int,
        backlog: int,
        n_workers: int,
        now: Optional[float] = None,
    ) -> str:
        """One deterministic control decision over the observed load
        (queued queries, running queries, RUNNING/QUEUED task backlog)
        and the current worker count (announced + still-booting).
        Returns — and records — the decision string the nodes view
        serves."""
        now = time.monotonic() if now is None else now
        busy = queued > 0 or running > 0 or backlog > 0
        self._idle_ticks = 0 if busy else self._idle_ticks + 1
        decision = "hold"
        if n_workers < self.min_workers:
            nid = self._spawn()
            decision = (
                f"scale_up(floor {n_workers}<{self.min_workers}): {nid}"
                if nid
                else "spawn_failed"
            )
            self._last_action = now
        elif queued > 0 and n_workers < self.max_workers:
            nid = self._spawn()
            decision = (
                f"scale_up(queued={queued}): {nid}"
                if nid
                else "spawn_failed"
            )
            self._last_action = now
        elif (
            not busy
            and n_workers > self.min_workers
            and self.owned
            and self._idle_ticks >= self.scale_down_ticks
            and now - self._last_action >= self.cooldown_s
        ):
            nid = self._drain_one()
            decision = f"scale_down(idle x{self._idle_ticks}): {nid}"
            self._last_action = now
            self._idle_ticks = 0
        self.last_decision = decision
        if self.coordinator is not None:
            self.coordinator.pool_decision = decision
        return decision

    def _spawn(self) -> Optional[str]:
        try:
            nid = self.provider.spawn()
        except Exception:
            REGISTRY.counter("pool.spawn_failures").update()
            log.warning("pool spawn failed", exc_info=True)
            return None
        self.owned.append(nid)
        if self.coordinator is not None:
            self.coordinator._pool_scaling.add(nid)
        REGISTRY.counter("pool.scale_up").update()
        log.info("pool scale-up: spawned %s", nid)
        return nid

    def _drain_one(self) -> str:
        nid = self.owned.pop()
        if self.coordinator is not None:
            self.coordinator._pool_scaling.discard(nid)
        try:
            self.provider.drain(nid)
        except Exception:
            log.warning("pool drain of %s failed", nid, exc_info=True)
        REGISTRY.counter("pool.scale_down").update()
        log.info("pool scale-down: draining %s", nid)
        return nid

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._tick()
            except Exception:
                log.warning("autoscaler tick failed", exc_info=True)

    def _tick(self) -> None:
        coord = self.coordinator
        snap = coord.load_snapshot()
        # discovery-level count (TTL-fresh ACTIVE announcements), NOT
        # active_workers(): a control-loop poll must never consume a
        # circuit breaker's half-open probe slot
        ids = {
            w.node_id
            for w in coord._ttl_workers()
            if w.state == "ACTIVE"
        }
        # a spawned worker that has announced is no longer SCALING_UP
        for nid in list(coord._pool_scaling):
            if nid in ids:
                coord._pool_scaling.discard(nid)
        # forget owned workers that are gone without our drain (killed,
        # preempted — the PROVIDER disowned them): draining a ghost
        # would count as a capacity change. A node merely absent from
        # discovery (TTL flap) stays owned — see WorkerPoolProvider.owns
        self.owned = [
            nid
            for nid in self.owned
            if nid in ids
            or nid in coord._pool_scaling
            or self.provider.owns(nid)
        ]
        pending = sum(
            1 for nid in self.owned if nid in coord._pool_scaling
        )
        self.step(
            snap["queued"],
            snap["running"],
            snap["backlog"],
            len(ids) + pending,
        )

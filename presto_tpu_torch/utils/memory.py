"""Memory manager: hierarchical pools with per-query accounting.

Reference parity: ``MemoryPool`` + ``QueryContext`` local memory
contexts + ``ClusterMemoryManager``'s kill-largest policy (SURVEY.md
§2.1 "Memory manager"). TPU-first shape: what needs accounting here is
*host-visible* residency — staged device pages (HBM) and host-RAM spill
buffers — reserved against a per-node pool before staging; the
blocking/queueing tier lives in the coordinator's admission control.

No reserved-pool legacy; policy = fail the reserving query when the
pool is exhausted and no larger query can be killed (the reference
kills the largest query cluster-wide; locally we surface the same
`Query exceeded memory limit` error shape).

Cluster memory governance (server/memory_arbiter.py) extends the pool
without changing the legacy contract:

- per-owner PEAK bytes ride alongside current bytes, and
  :meth:`snapshot` exports ``{used, peak, blocked, limit}`` — the
  payload workers report on their announce/status heartbeats;
- when ``block_timeout_s > 0`` (tier-1 ``memory.governance-enabled`` +
  ``memory.reserve-block-max-s``), an over-budget :meth:`reserve`
  BLOCKS instead of failing: the waiter registers in the blocked
  registry (owner, bytes, age) so the cluster arbiter can see it,
  pick a victim, and either free headroom (the wait succeeds) or
  :meth:`cancel_blocked` the waiter (the wait raises). The default
  ``block_timeout_s = 0`` is the exact pre-governance fail-fast path;
- :meth:`shrink` lowers the effective budget mid-flight (the
  ``mem_pressure`` chaos rule — utils/faults.py — exercises the killer
  and spill paths without real HBM exhaustion).

Reservation sites are confined: ``reserve``/``try_reserve`` and pool
construction live in this module plus the audited consumers
(``tools/check_reserve_sites.py`` enforces the list).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

from presto_tpu_torch.utils import faults
from presto_tpu_torch.utils.metrics import REGISTRY


class MemoryLimitExceeded(RuntimeError):
    pass


def parse_bytes(s) -> int:
    """'8GB' / '512MB' / '64kB' / plain ints -> bytes (config tier-1
    size strings, reference: airlift DataSize)."""
    if isinstance(s, (int, float)):
        return int(s)
    t = str(s).strip()
    units = {"TB": 1 << 40, "GB": 1 << 30, "MB": 1 << 20, "KB": 1 << 10,
             "B": 1}
    for u in ("TB", "GB", "MB", "KB", "B"):
        if t.upper().endswith(u):
            return int(float(t[: -len(u)]) * units[u])
    return int(float(t))


class MemoryPool:
    """One node-level pool; queries reserve/release against it.

    ``kill_largest`` (reference: ClusterMemoryManager's pluggable
    kill policy): when a reservation would exceed the limit, the
    callback may evict the largest other holder (aborting that query
    and releasing its reservation); the reserve then retries once.
    The callback receives ({owner: bytes}, requesting_owner) and
    returns the evicted owner or None."""

    def __init__(self, limit_bytes: int, kill_largest=None):
        self.limit = int(limit_bytes)
        self._used: Dict[str, int] = {}
        #: per-owner high-water mark (cleared with the owner's release)
        self._peak: Dict[str, int] = {}
        self._lock = threading.Lock()
        #: releases/kills/shrinks notify blocked reserves through this
        self._cond = threading.Condition(self._lock)
        self.kill_largest = kill_largest
        self._dead: set = set()
        #: governance lane: how long an over-budget reserve may BLOCK
        #: waiting for headroom before failing (0 = legacy fail-fast).
        #: The cluster arbiter watches the blocked registry and is the
        #: progress guarantee inside this window.
        self.block_timeout_s: float = 0.0
        #: node identity for fault-rule matching and heartbeat reports
        self.node_id: str = ""
        #: token -> {"owner", "bytes", "since", "mono", "cancelled"}:
        #: reserves currently blocked on headroom (snapshot exports it)
        self._blocked: Dict[int, dict] = {}
        self._blocked_seq = itertools.count(1)
        #: pressure hooks: callables ``(bytes_needed) -> bytes_freed``
        #: tried BEFORE the kill-largest policy when a reservation
        #: would exceed the limit — droppable holders (the split
        #: cache) yield their bytes to running queries. Called with no
        #: pool lock held.
        self._pressure_hooks: list = []

    def add_pressure_hook(self, hook) -> None:
        self._pressure_hooks.append(hook)

    def mark_dead(self, query_id: str) -> None:
        """A killed query's next reservation fails immediately — the
        cooperative cancellation point for the kill-largest policy (its
        thread cannot be interrupted mid-kernel, but it cannot grow)."""
        with self._cond:
            self._dead.add(query_id)
            self._cond.notify_all()

    def cancel_blocked(self, owner: str) -> int:
        """Fail every reservation of ``owner`` currently blocked on
        headroom (the cluster arbiter's cancellation lane: unlike
        :meth:`mark_dead` it does NOT poison future reservations, so a
        re-admitted victim can reserve again). Returns the number of
        waiters cancelled."""
        n = 0
        prefix = owner + "#"
        with self._cond:
            for entry in self._blocked.values():
                eo = entry["owner"]
                # derived owners (task output buffers reserve under
                # "qid#buf#task") cancel with their query
                if (
                    eo == owner or eo.startswith(prefix)
                ) and not entry["cancelled"]:
                    entry["cancelled"] = True
                    n += 1
            if n:
                self._cond.notify_all()
        return n

    def shrink(self, new_limit: int) -> None:
        """Lower the effective budget mid-flight (never raises it —
        the ``mem_pressure`` chaos rule models capacity LOSS). Blocked
        reserves re-check against the new limit."""
        with self._cond:
            self.limit = min(self.limit, int(new_limit))
            self._cond.notify_all()

    def _take(self, query_id: str, nbytes: int) -> None:
        """Record a granted reservation (caller holds the lock)."""
        cur = self._used.get(query_id, 0) + int(nbytes)
        self._used[query_id] = cur
        if cur > self._peak.get(query_id, 0):
            self._peak[query_id] = cur

    def reserve(self, query_id: str, nbytes: int) -> None:
        # deterministic chaos (utils.faults): a reserve_fail rule fails
        # this reservation outright; a mem_pressure rule shrinks the
        # effective budget first (both no-ops with no plane configured)
        act = faults.maybe_inject_reserve(self.node_id, query_id)
        if act is not None:
            kind, arg = act
            if kind == "mem_pressure":
                self.shrink(int(arg))
            else:  # reserve_fail
                raise MemoryLimitExceeded(
                    f"injected reservation failure for {query_id} "
                    f"({nbytes}B)"
                )
        # escalation ladder on exhaustion: (0) ask pressure hooks —
        # droppable holders like the split cache — to free bytes,
        # (1) invoke the kill-largest policy, (2) block waiting for
        # headroom (governance lane, off by default), (3) fail the
        # reservation
        for attempt in (0, 1, 2):
            with self._lock:
                if query_id in self._dead:
                    raise MemoryLimitExceeded(
                        f"query {query_id} was killed by the memory "
                        "manager"
                    )
                total = sum(self._used.values())
                if total + nbytes <= self.limit:
                    self._take(query_id, nbytes)
                    return
                largest = max(
                    self._used, key=self._used.get, default=None
                )
                holders = dict(self._used)
            if attempt == 0:
                needed = total + nbytes - self.limit
                freed = 0
                for hook in list(self._pressure_hooks):
                    freed += int(hook(needed - freed))
                    if freed >= needed:
                        break
                continue  # re-check headroom (kill policy is next)
            if attempt == 1 and self.kill_largest is not None:
                victim = self.kill_largest(holders, query_id)
                if victim is not None:
                    self.release(victim)
                    continue
            if self.block_timeout_s > 0:
                # governance lane: register as blocked and wait for the
                # arbiter (or a release) to make room — over-capacity
                # work gets slower instead of dead
                return self._reserve_blocking(query_id, nbytes)
            raise MemoryLimitExceeded(
                f"reserving {nbytes}B for {query_id} exceeds pool "
                f"limit {self.limit}B (in use {total}B, largest "
                f"holder {largest})"
            )

    def _reserve_blocking(self, query_id: str, nbytes: int) -> None:
        """Blocked reservation: wait for headroom up to
        ``block_timeout_s``, visible in the blocked registry the whole
        time. Resolution: headroom appears (granted), the owner is
        killed/cancelled (raises), or the timeout lapses (raises)."""
        deadline = time.monotonic() + self.block_timeout_s
        token = next(self._blocked_seq)
        REGISTRY.counter("memory.reserves_blocked").update()
        with self._cond:
            self._blocked[token] = {
                "owner": query_id,
                "bytes": int(nbytes),
                "since": time.time(),
                "mono": time.monotonic(),
                "cancelled": False,
            }
            try:
                while True:
                    entry = self._blocked[token]
                    if query_id in self._dead or entry["cancelled"]:
                        raise MemoryLimitExceeded(
                            f"blocked reservation of {nbytes}B for "
                            f"{query_id} was cancelled by the memory "
                            "manager"
                        )
                    total = sum(self._used.values())
                    if total + nbytes <= self.limit:
                        self._take(query_id, nbytes)
                        return
                    now = time.monotonic()
                    if now >= deadline:
                        REGISTRY.counter(
                            "memory.reserve_block_timeouts"
                        ).update()
                        raise MemoryLimitExceeded(
                            f"reserving {nbytes}B for {query_id} "
                            f"blocked past {self.block_timeout_s}s "
                            f"(pool limit {self.limit}B, in use "
                            f"{total}B)"
                        )
                    self._cond.wait(timeout=min(0.05, deadline - now))
            finally:
                self._blocked.pop(token, None)

    def try_reserve(self, query_id: str, nbytes: int) -> bool:
        """Reserve only if headroom already exists — never invokes the
        kill-largest policy, never blocks, never raises. For
        opportunistic holders (the split cache) where failure just
        means "don't cache"; a cache fill must never kill a running
        query to make room."""
        with self._lock:
            if query_id in self._dead:
                return False
            if sum(self._used.values()) + int(nbytes) > self.limit:
                return False
            self._take(query_id, int(nbytes))
            return True

    def release(self, query_id: str, nbytes: Optional[int] = None) -> None:
        """Release ``nbytes`` of a holder's reservation (None = all)."""
        with self._cond:
            if nbytes is None:
                freed = self._used.pop(query_id, None)
                self._peak.pop(query_id, None)
            else:
                left = self._used.get(query_id, 0) - int(nbytes)
                if left > 0:
                    self._used[query_id] = left
                else:
                    self._used.pop(query_id, None)
                    self._peak.pop(query_id, None)
                freed = nbytes
            if freed and self._blocked:
                self._cond.notify_all()

    def used_bytes(self, query_id: Optional[str] = None) -> int:
        with self._lock:
            if query_id is not None:
                return self._used.get(query_id, 0)
            return sum(self._used.values())

    def peak_bytes(self, query_id: str) -> int:
        """High-water mark of one owner's live reservation window (a
        fully-released owner's peak resets with it)."""
        with self._lock:
            return self._peak.get(query_id, 0)

    def blocked(self) -> List[dict]:
        """Currently blocked reservations: [{owner, bytes, age_s}]."""
        now = time.monotonic()
        with self._lock:
            return [
                {
                    "owner": e["owner"],
                    "bytes": e["bytes"],
                    "age_s": now - e["mono"],
                }
                for e in self._blocked.values()
            ]

    def snapshot(self) -> dict:
        """Full accounting snapshot — the building block of the
        worker's heartbeat memory report (current + peak + blocked)."""
        now = time.monotonic()
        with self._lock:
            return {
                "limit": self.limit,
                "reserved": sum(self._used.values()),
                "used": dict(self._used),
                "peak": dict(self._peak),
                "blocked": [
                    {
                        "owner": e["owner"],
                        "bytes": e["bytes"],
                        "age_s": now - e["mono"],
                    }
                    for e in self._blocked.values()
                ],
            }


def rollup_query_report(
    snap: dict, cache_owner: str, spilled_bytes: int = 0
) -> dict:
    """Fold a pool :meth:`MemoryPool.snapshot` into the per-query
    heartbeat report shape the cluster arbiter consumes: derived
    owners (``qid#buf#task`` output buffers) roll into their query,
    the shared split-cache owner stays out of the query map (droppable
    bytes are not query residency) but remains in the reserved total.
    The ONE fold — worker heartbeats and the coordinator's local view
    must never disagree on attribution."""
    queries: Dict[str, dict] = {}
    for owner, nbytes in snap["used"].items():
        if owner == cache_owner:
            continue
        qid = owner.split("#", 1)[0]
        q = queries.setdefault(qid, {"bytes": 0, "peak": 0})
        q["bytes"] += nbytes
        q["peak"] += snap["peak"].get(owner, nbytes)
    return {
        "limit": snap["limit"],
        "reserved": snap["reserved"],
        "queries": queries,
        "blocked": [
            {
                "owner": str(b["owner"]).split("#", 1)[0],
                "bytes": b["bytes"],
                "age_s": b["age_s"],
            }
            for b in snap["blocked"]
        ],
        "spilled_bytes": int(spilled_bytes),
    }


class QueryMemoryContext:
    """Per-query handle: accumulates reservations, released on finish
    (reference: QueryContext -> MemoryPool accounting)."""

    def __init__(self, pool: Optional[MemoryPool], query_id: str):
        self.pool = pool
        self.query_id = query_id

    def reserve(self, nbytes: int) -> None:
        if self.pool is not None:
            self.pool.reserve(self.query_id, nbytes)

    def release_all(self) -> None:
        if self.pool is not None:
            self.pool.release(self.query_id)

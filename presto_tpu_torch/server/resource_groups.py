"""Resource groups: weighted-fair admission with per-group limits.

Reference parity: ``presto-resource-group-managers`` file-configured
``ResourceGroup`` trees (SURVEY.md §2.1 "Dispatch/queue": DB- or
file-configured groups with concurrency/memory limits, weighted/fair
queueing). This implementation keeps the reference's observable
semantics on the file-configured path:

- groups declare ``hardConcurrencyLimit``, ``maxQueued``,
  ``softMemoryLimit`` and a scheduling ``weight``;
- selectors map a query's user (regex) to a group; unmatched queries
  take the configured default group;
- a query beyond its group's queue bound is REJECTED, not queued;
- when a slot frees, the next query comes from the eligible group with
  the smallest running/weight ratio (weighted fairness), FIFO within a
  group.

The coordinator composes this with its global admission semaphore: the
manager decides WHICH query runs next and per-group bounds; the global
``max_concurrent_queries`` stays the cluster-wide cap.

Config shape (``etc/resource-groups.json``-style dict):

    {"rootGroups": [
        {"name": "etl", "weight": 3, "hardConcurrencyLimit": 4,
         "maxQueued": 50, "softMemoryLimit": "4GB"},
        {"name": "adhoc", "weight": 1, "hardConcurrencyLimit": 2,
         "maxQueued": 10}],
     "selectors": [{"user": "etl-.*", "group": "etl"}],
     "defaultGroup": "adhoc"}
"""

from __future__ import annotations

import dataclasses
import json
import re
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class ResourceGroup:
    """One leaf group's live state."""

    name: str
    weight: int = 1
    hard_concurrency_limit: int = 1 << 30
    max_queued: int = 100
    soft_memory_limit_bytes: Optional[int] = None
    #: QoS admission lane (server/qos.py): higher-priority groups
    #: dequeue strictly first at the coordinator's admission gate, and
    #: may preempt-and-resume running lower-priority queries. Inert
    #: unless qos.enabled (weighted fairness applies within a lane).
    priority: int = 0
    running: int = 0
    queue: deque = dataclasses.field(default_factory=deque)

    @property
    def queued(self) -> int:
        return len(self.queue)


class ResourceGroupManager:
    """Thread-safe weighted-fair admission over a flat group list (the
    reference nests groups; benchmark-relevant semantics — per-group
    caps + weighted fairness between peers — live at one level, so the
    tree is deliberately flat here with the root caps owned by the
    coordinator's global gate)."""

    def __init__(self, spec: Dict):
        self._lock = threading.Lock()
        #: optional hook: group name -> bytes currently reserved by the
        #: group's running queries; a group over its softMemoryLimit is
        #: ineligible for new admissions until usage drops (reference:
        #: softMemoryLimit demotes the group below its peers)
        self.memory_usage_fn: Optional[Callable[[str], int]] = None
        self.groups: Dict[str, ResourceGroup] = {}
        for g in spec.get("rootGroups", []):
            grp = ResourceGroup(
                name=g["name"],
                weight=int(g.get("weight", 1)),
                hard_concurrency_limit=int(
                    g.get("hardConcurrencyLimit", 1 << 30)
                ),
                max_queued=int(g.get("maxQueued", 100)),
                soft_memory_limit_bytes=(
                    _parse_bytes(g["softMemoryLimit"])
                    if "softMemoryLimit" in g
                    else None
                ),
                priority=int(g.get("priority", 0)),
            )
            if grp.weight <= 0:
                raise ValueError(
                    f"resource group {grp.name}: weight must be positive"
                )
            self.groups[grp.name] = grp
        if not self.groups:
            raise ValueError("resource groups config has no rootGroups")
        self._selectors: List[Tuple[re.Pattern, str]] = []
        for s in spec.get("selectors", []):
            if s["group"] not in self.groups:
                raise ValueError(
                    f"selector references unknown group {s['group']!r}"
                )
            self._selectors.append(
                (re.compile(s.get("user", ".*")), s["group"])
            )
        default = spec.get("defaultGroup")
        if default is None:
            default = next(iter(self.groups))
        if default not in self.groups:
            raise ValueError(f"unknown defaultGroup {default!r}")
        self._default = default

    @classmethod
    def from_file(cls, path: str) -> "ResourceGroupManager":
        with open(path) as f:
            return cls(json.load(f))

    def group_of(self, user: str) -> ResourceGroup:
        for rx, name in self._selectors:
            if rx.fullmatch(user or ""):
                return self.groups[name]
        return self.groups[self._default]

    # ------------------------------------------------------------ admission

    def submit(
        self, user: str, start: Callable[[], None]
    ) -> Tuple[str, Optional[str]]:
        """-> ("run"|"queued", group) after calling ``start`` when the
        group has capacity, or ("rejected", message)."""
        with self._lock:
            g = self.group_of(user)
            # fast path only when no older query waits (FIFO within a
            # group: a memory-demoted group's queue must drain first)
            if (
                not g.queue
                and g.running < g.hard_concurrency_limit
                and not self._over_memory(g)
            ):
                g.running += 1
                run_now = True
            elif g.queued >= g.max_queued:
                return (
                    "rejected",
                    f"Query rejected: resource group {g.name} queue is "
                    f"full (maxQueued {g.max_queued})",
                )
            else:
                g.queue.append(start)
                run_now = False
        if run_now:
            start()
            return "run", g.name
        return "queued", g.name

    def finish(self, group_name: str) -> None:
        """A query of ``group_name`` finished: free its slot, then admit
        the next queued query from the eligible group with the smallest
        running/weight ratio (weighted fairness)."""
        with self._lock:
            g = self.groups.get(group_name)
            if g is not None and g.running > 0:
                g.running -= 1
            nxt = self._pick_next()
            if nxt is None:
                return
            grp, start = nxt
            grp.running += 1
        start()

    def _over_memory(self, g: ResourceGroup) -> bool:
        return (
            g.soft_memory_limit_bytes is not None
            and self.memory_usage_fn is not None
            and self.memory_usage_fn(g.name) >= g.soft_memory_limit_bytes
        )

    def _pick_next(self) -> Optional[Tuple[ResourceGroup, Callable]]:
        eligible = [
            g
            for g in self.groups.values()
            if g.queue
            and g.running < g.hard_concurrency_limit
            and not self._over_memory(g)
        ]
        if not eligible:
            return None
        g = min(eligible, key=lambda g: (g.running / g.weight, g.name))
        return g, g.queue.popleft()

    # -------------------------------------------------------------- stats

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return [
                {
                    "name": g.name,
                    "weight": g.weight,
                    "priority": g.priority,
                    "running": g.running,
                    "queued": g.queued,
                    "hardConcurrencyLimit": g.hard_concurrency_limit,
                    "maxQueued": g.max_queued,
                }
                for g in self.groups.values()
            ]

    def memory_limit_of(self, user: str) -> Optional[int]:
        return self.group_of(user).soft_memory_limit_bytes


def _parse_bytes(s: str) -> int:
    from presto_tpu_torch.utils.memory import parse_bytes

    return parse_bytes(s)

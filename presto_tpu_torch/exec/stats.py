"""Query statistics: the part of ``presto_tpu/exec/stats.py`` the
runner's caches write.

:class:`QueryStats` carries one query's id, state, host phase timings
(planning, execution, staging), its split-cache hits and plan-cache hit,
its input and output sizes, the host-spill restage bytes it paid, and
the cache keys it pinned (released when the query ends).
:class:`QueryHistory` hands out query ids and keeps the most recent
queries.

Not ported yet: operator, stage and task stats, the query-completed
event listeners and the slow-query log.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional


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
    #: optimize-pass share of planning (prune + constraint push):
    #: visible separately because the plan cache exists to remove it
    optimization_ms: float = 0.0
    staging_ms: float = 0.0  # host -> device page staging
    execution_ms: float = 0.0
    #: statement-level plan cache (plan/canonical.py): True = planning
    #: was skipped, the canonical form was already planned and this
    #: execution only bound fresh literal values
    plan_cache_hit: bool = False
    staging_cache_hits: int = 0  # pages served device-resident
    #: host-spill restage traffic this query paid (the split cache's
    #: ``on_restage`` hook)
    spilled_bytes: int = 0
    input_rows: int = 0
    input_bytes: int = 0
    output_rows: int = 0
    #: split-cache keys pinned for this query's lifetime
    _pinned_keys: List[object] = dataclasses.field(
        default_factory=list, repr=False, compare=False
    )


class QueryHistory:
    """Registry of running and finished queries (reference: the one
    behind ``system.runtime.queries``), bounded to ``capacity``."""

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._capacity = capacity
        self._queries: Dict[str, QueryStats] = {}
        self._ids = itertools.count(1)

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

    def finish(self, qs: QueryStats, error: Optional[str] = None) -> None:
        qs.end_time = time.time()
        qs.state = "FAILED" if error else "FINISHED"
        qs.error = error

    def snapshot(self) -> List[QueryStats]:
        with self._lock:
            return list(self._queries.values())

"""Task/attempt identity — the ONE audited module for constructing and
parsing task ids.

Reference parity: fault-tolerant execution (Trino "Project Tardigrade")
keys spooled exchange data by *task attempt*: a logical task may run as
several attempts (retry, speculation), and recovery is only correct
when exactly one attempt's output is consumed. That property hangs on
the id scheme, so construction and parsing live here and nowhere else
(``tools/check_attempt_ids.py`` enforces it — an ad-hoc string split on
a task id elsewhere would silently break attempt dedup).

Format::

    {query_id}.{kind}.{seq}.a{attempt}

- ``query_id``  — the coordinator's query id (no dots, e.g. ``q_c7``)
- ``kind``      — the stage flavor that minted the task (constants below)
- ``seq``       — per-query monotonic sequence number: the LOGICAL task
- ``attempt``   — 0 for the first launch; retries/speculative backups of
  the same logical task bump it and change NOTHING else

``logical_key`` (the id minus the attempt suffix) keys the exchange
spool: every attempt of one logical task spools under the same key, and
consumers (merge tasks, recovery pulls) consume exactly one committed
attempt per key.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

#: stage-flavor tokens (kept substring-compatible with the historical
#: ids: chaos rules and tests match ``.df.`` / ``.merge.`` / ``.join.``)
SOURCE = "t"
PRODUCER = "prod"
MERGE = "merge"
JOIN = "join"
DYNFILTER = "df"

_TASK_ID_RE = re.compile(
    r"^(?P<query>[^.]+)\.(?P<kind>[^.]+)\.(?P<seq>\d+)\.a(?P<attempt>\d+)$"
)


@dataclasses.dataclass(frozen=True)
class TaskId:
    """Parsed form of one task-attempt id."""

    query_id: str
    kind: str
    seq: int
    attempt: int

    def __str__(self) -> str:
        return mint(self.query_id, self.kind, self.seq, self.attempt)

    @property
    def logical_key(self) -> str:
        return f"{self.query_id}.{self.kind}.{self.seq}"


def mint(query_id: str, kind: str, seq: int, attempt: int = 0) -> str:
    """Construct a deterministic task-attempt id."""
    if "." in query_id or "." in kind or not kind:
        raise ValueError(
            f"task-id components must be dot-free: {query_id!r}, {kind!r}"
        )
    if seq < 0 or attempt < 0:
        raise ValueError(f"negative seq/attempt: {seq}, {attempt}")
    return f"{query_id}.{kind}.{seq}.a{attempt}"


def parse(task_id: str) -> TaskId:
    t = try_parse(task_id)
    if t is None:
        raise ValueError(f"not a task-attempt id: {task_id!r}")
    return t


def try_parse(task_id: str) -> Optional[TaskId]:
    m = _TASK_ID_RE.match(task_id)
    if m is None:
        return None
    return TaskId(
        query_id=m.group("query"),
        kind=m.group("kind"),
        seq=int(m.group("seq")),
        attempt=int(m.group("attempt")),
    )


def logical_key(task_id: str) -> str:
    """The id minus its attempt suffix — the spool/recovery key shared
    by every attempt of one logical task. Unparseable (hand-written
    test) ids are their own key: no attempts, no dedup needed."""
    t = try_parse(task_id)
    return t.logical_key if t is not None else task_id


def attempt_of(task_id: str) -> int:
    """Attempt number (0 for first launches and unparseable ids)."""
    t = try_parse(task_id)
    return t.attempt if t is not None else 0


def next_attempt(task_id: str) -> str:
    """Id for the replacement attempt of the same logical task."""
    t = parse(task_id)
    return mint(t.query_id, t.kind, t.seq, t.attempt + 1)


#: coordinator query ids carry a per-boot nonce: ``q_c{N}_{hex6}``
#: (see CoordinatorServer._boot — attempt ids minted across restarts
#: sharing one spool must never collide)
_QID_BOOT_RE = re.compile(r"^q_c\d+_([0-9a-f]{6})$")


def boot_of_query(query_id: str) -> str:
    """The coordinator-incarnation nonce baked into a query id, or ""
    for ids without one (embedded-runner ``q_N`` ids, hand-written
    test ids). The worker's orphan reaper keys task liveness on it: a
    task whose minting incarnation stopped heartbeating is orphaned —
    its buffers are held for nobody."""
    m = _QID_BOOT_RE.match(query_id or "")
    return m.group(1) if m is not None else ""

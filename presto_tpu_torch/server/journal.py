"""Durable coordinator state: the crash-safe admission journal.

The PyTorch port's copy of ``presto_tpu/server/journal.py``: pure
Python, the same frames byte for byte, so each package replays the
other's journal.

Reference parity: Presto's disaggregated-coordinator direction treats
coordinator state as recoverable — a coordinator bounce must RESUME the
queued/running query set instead of forgetting it (PAPER.md L3; the
spooled exchange already made the data plane restartable, this journal
does the same for the control plane). The journal records, as
they happen:

- query admission (``submit``: qid, SQL, user, resource group, the
  client's prepared-statement map),
- query completion (``finish``: any terminal state — FINISHED, FAILED,
  or RESUMED when a restart re-admitted the query under a new id),
- the coordinator-global prepared-statement registry
  (``prepare`` / ``deallocate``),
- multi-coordinator failover (``claim``: a lease-fenced survivor took
  this journal's open queries over at a fencing epoch; ``alias``: a
  dead peer's qid now resolves to one of OURS — the durable half of
  the cross-coordinator alias chain).

On restart the coordinator replays the journal and re-admits every
query that never reached a terminal state, under the NEW boot's query
ids (the per-boot qid nonce guarantees the re-run's task-attempt ids
can never collide with the dead incarnation's spooled pages); the old
ids stay routable through an alias map so clients paginating across
the bounce reconnect transparently.

On-disk shape (one directory, ``coordinator.journal-path``): JSONL
segment files ``journal-NNNNNN.jsonl`` in the spool's shared-dir style.
Every line is a checksummed frame::

    {crc32-of-payload as 8 hex chars} {payload JSON}

so a torn tail line (crash mid-append) or bit rot is detected at replay
and skipped (``journal.corrupt_lines``) — the journal must always come
back up. Segments rotate after ``segment_lines`` appends; each new
segment opens with a ``checkpoint`` frame carrying the full live state
(open queries + prepared registry, mirroring ``plan/history.py``'s
checkpoint compaction), so GC keeps only the newest two segments and a
long-running coordinator's journal stays bounded by its LIVE state, not
its query count.

Construction and frame parsing are confined to this module
(``tools/check_journal_sites.py`` — an ad-hoc frame writer elsewhere
would silently break replay); the coordinator is the one audited
consumer.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional

from presto_tpu_torch.utils import faults
from presto_tpu_torch.utils.metrics import REGISTRY

log = logging.getLogger("presto_tpu_torch.journal")

#: appends per segment before rotation (each rotation writes a full
#: checkpoint, so small segments trade write amplification for faster
#: GC; 256 keeps both negligible at query rates)
DEFAULT_SEGMENT_LINES = 256

_SEG_PREFIX = "journal-"
_SEG_SUFFIX = ".jsonl"


def _frame_line(payload: str) -> str:
    """One checksummed journal frame: crc32 of the UTF-8 payload, then
    the payload itself. The crc is verified at replay — a torn write
    truncates the line and fails the check."""
    return f"{zlib.crc32(payload.encode()) & 0xFFFFFFFF:08x} {payload}"


def _parse_line(line: str) -> Optional[dict]:
    """Frame -> record dict, or None for torn/corrupt/foreign lines."""
    line = line.strip()
    if not line:
        return None
    crc_hex, sep, payload = line.partition(" ")
    if not sep or len(crc_hex) != 8:
        return None
    try:
        crc = int(crc_hex, 16)
    except ValueError:
        return None
    if zlib.crc32(payload.encode()) & 0xFFFFFFFF != crc:
        return None
    try:
        rec = json.loads(payload)
    except Exception:
        return None
    return rec if isinstance(rec, dict) and "ev" in rec else None


@dataclasses.dataclass
class JournalState:
    """Live coordinator state reconstructed by replay."""

    #: submit records of queries that never reached a terminal state,
    #: in admission order (qid, sql, user, group, prepared)
    open: List[dict] = dataclasses.field(default_factory=list)
    #: coordinator-global prepared registry: name -> statement text
    prepared: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: dead-incarnation qid -> the OPEN qid its chain of resumes leads
    #: to (collapsed): a client URI from N bounces ago must still
    #: resolve to whatever run carries its query today
    aliases: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: last ``claim`` frame, or None: a peer coordinator fenced this
    #: journal at ``claim["epoch"]`` and took its open queries over. A
    #: restarted original owner must rejoin ABOVE that epoch (the
    #: lease plane reads it at construction) and must not re-admit
    #: what the claimant already resumed — the claimant's RESUMED
    #: close-outs in this same journal guarantee that.
    claim: Optional[dict] = None


class CoordinatorJournal:
    """Append-only admission journal with checkpoint compaction."""

    def __init__(self, path: str, segment_lines: int = DEFAULT_SEGMENT_LINES):
        self.path = path
        self.segment_lines = max(int(segment_lines), 4)
        self._lock = threading.Lock()
        #: qid -> submit record (insertion order = admission order)
        self._open: "OrderedDict[str, dict]" = OrderedDict()
        self._prepared: Dict[str, str] = {}
        #: resumed old qid -> its replacement qid (one hop; collapsed
        #: to the live tip in :meth:`_live_aliases`)
        self._alias: Dict[str, str] = {}
        #: last claim frame a failover survivor fenced this journal at
        self._claim: Optional[dict] = None
        os.makedirs(path, exist_ok=True)
        self._replayed = self._load()

    # ------------------------------------------------------------ disk

    def _segments(self) -> List[str]:
        try:
            names = sorted(
                f
                for f in os.listdir(self.path)
                if f.startswith(_SEG_PREFIX) and f.endswith(_SEG_SUFFIX)
            )
        except OSError:
            return []
        return [os.path.join(self.path, f) for f in names]

    def _cur_segment(self) -> str:
        return os.path.join(
            self.path, f"{_SEG_PREFIX}{self._seg_seq:06d}{_SEG_SUFFIX}"
        )

    def _load(self) -> JournalState:
        """Rebuild live state from surviving segments, oldest first so
        later frames win. Corrupt/torn frames are counted and skipped —
        a journal must always come back up, degraded to whatever
        replayed cleanly."""
        max_seq = -1
        corrupt = 0
        for seg in self._segments():
            name = os.path.basename(seg)
            try:
                max_seq = max(
                    max_seq,
                    int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)]),
                )
            except ValueError:
                pass
            try:
                with open(seg, encoding="utf-8") as f:
                    for raw in f:
                        if not raw.strip():
                            continue
                        rec = _parse_line(raw)
                        if rec is None:
                            corrupt += 1
                            continue
                        self._apply(rec)
            except OSError:
                continue
        if corrupt:
            REGISTRY.counter("journal.corrupt_lines").update(corrupt)
            log.warning(
                "journal replay skipped %d corrupt/torn line(s) under %s",
                corrupt, self.path,
            )
        # numbering continues AFTER the max surviving name (GC leaves
        # gaps; reusing a name would invert replay recency) and a
        # restart always opens a fresh segment
        self._seg_seq = max_seq + 1
        self._cur_count = 0
        state = JournalState(
            open=list(self._open.values()),
            prepared=dict(self._prepared),
            aliases=self._live_aliases(),
            claim=dict(self._claim) if self._claim else None,
        )
        REGISTRY.counter("journal.replayed").update(len(state.open))
        return state

    def _live_aliases(self) -> Dict[str, str]:
        """Alias map collapsed to live tips: every dead-incarnation qid
        whose resume chain ends at a still-OPEN query maps straight to
        that tip; chains ending at a truly finished query are dropped
        (their clients already saw the outcome or never will — nothing
        left to route to)."""
        out: Dict[str, str] = {}
        for a in self._alias:
            tip, seen = a, set()
            while tip in self._alias and tip not in seen:
                seen.add(tip)
                tip = self._alias[tip]
            if tip in self._open:
                out[a] = tip
        return out

    def _apply(self, rec: dict) -> None:
        ev = rec.get("ev")
        if ev == "submit" and rec.get("qid"):
            self._open[rec["qid"]] = rec
        elif ev == "finish":
            self._open.pop(rec.get("qid"), None)
            # a RESUMED close-out names its replacement: the durable
            # half of the restart alias, so a statement URI minted N
            # bounces ago still resolves after bounce N+1
            if rec.get("state") == "RESUMED" and rec.get("resumed_as"):
                self._alias[rec["qid"]] = rec["resumed_as"]
            else:
                self._alias.pop(rec.get("qid"), None)
        elif ev == "alias":
            # cross-coordinator inheritance: a failover survivor folds
            # the DEAD journal's alias chains into its OWN journal, so
            # a statement URI minted two coordinators ago still
            # resolves after the survivor itself dies
            if rec.get("old") and rec.get("qid"):
                self._alias[rec["old"]] = rec["qid"]
        elif ev == "claim":
            self._claim = {
                "claimant": rec.get("claimant", ""),
                "epoch": int(rec.get("epoch", 0)),
            }
        elif ev == "prepare" and rec.get("name"):
            self._prepared[rec["name"]] = rec.get("sql", "")
        elif ev == "deallocate":
            self._prepared.pop(rec.get("name"), None)
        elif ev == "checkpoint":
            # a checkpoint frame is the full state at rotation: reset
            # and re-seed, so older segments become redundant
            self._open = OrderedDict(
                (r.get("qid"), r)
                for r in rec.get("open") or []
                if isinstance(r, dict) and r.get("qid")
            )
            self._prepared = dict(rec.get("prepared") or {})
            self._alias = dict(rec.get("aliases") or {})
            self._claim = (
                dict(rec["claim"]) if rec.get("claim") else None
            )

    # ----------------------------------------------------------- write

    def _append(self, rec: dict) -> None:
        rec.setdefault("ts", time.time())
        line = _frame_line(json.dumps(rec, default=str))
        with self._lock:
            self._apply(rec)
            rotate = self._cur_count >= self.segment_lines
            if rotate:
                self._seg_seq += 1
                self._cur_count = 0
            try:
                faults.maybe_inject_io("write", self._cur_segment())
                with open(self._cur_segment(), "a", encoding="utf-8") as f:
                    if rotate:
                        # checkpoint compaction: the fresh segment
                        # opens with the full live state, so GC can
                        # drop everything older
                        ckpt = {
                            "ev": "checkpoint",
                            "ts": time.time(),
                            "open": list(self._open.values()),
                            "prepared": dict(self._prepared),
                            # aliases pruned to live chains, so the
                            # map cannot grow past the open set
                            "aliases": self._live_aliases(),
                            "claim": (
                                dict(self._claim)
                                if self._claim
                                else None
                            ),
                        }
                        f.write(
                            _frame_line(json.dumps(ckpt, default=str))
                            + "\n"
                        )
                        REGISTRY.counter("journal.checkpoints").update()
                    f.write(line + "\n")
                    f.flush()
                    # durable-before-acknowledged: a recorded claim
                    # or admission the caller acts on must survive
                    # power loss, not just process death — flush
                    # alone leaves the frame in the page cache
                    faults.maybe_inject_io("fsync", self._cur_segment())
                    os.fsync(f.fileno())
                self._cur_count += 1
                if rotate:
                    self._gc_segments()
            except OSError:
                # a full/broken disk must never fail admission — the
                # journal degrades to best-effort (in-memory state
                # stays correct for checkpoints that do succeed)
                log.warning(
                    "journal append failed under %s", self.path,
                    exc_info=True,
                )
        REGISTRY.counter("journal.writes").update()

    def record_submit(
        self,
        qid: str,
        sql: str,
        user: str = "",
        prepared: Optional[Dict[str, str]] = None,
        resource_group: Optional[str] = None,
    ) -> None:
        """One admitted query (journaled BEFORE its execution thread
        can start, so finish can never precede submit on disk)."""
        self._append(
            {
                "ev": "submit",
                "qid": qid,
                "sql": sql,
                "user": user,
                "group": resource_group,
                "prepared": dict(prepared or {}),
            }
        )

    def record_finish(
        self, qid: str, state: str = "FINISHED", resumed_as: str = ""
    ) -> None:
        """Terminal close-out: FINISHED/FAILED, or RESUMED when a
        restarted coordinator re-admitted the query under a new id —
        ``resumed_as`` names that replacement, making the restart alias
        durable across FURTHER bounces."""
        rec = {"ev": "finish", "qid": qid, "state": state}
        if resumed_as:
            rec["resumed_as"] = resumed_as
        self._append(rec)

    def record_kill(
        self, qid: str, policy: str, reason: str, nbytes: int = 0
    ) -> None:
        """One cluster-memory-manager kill decision (server/
        memory_arbiter.py): pure audit trail — replay ignores it (the
        victim's terminal finish frame, or its re-admission's submit
        frame, carries the state the journal enforces)."""
        self._append(
            {
                "ev": "kill",
                "qid": qid,
                "policy": policy,
                "reason": reason,
                "bytes": int(nbytes),
            }
        )

    def record_suspend(
        self,
        qid: str,
        spooled_attempts: int = 0,
        running_stages: int = 0,
        suspensions: int = 1,
    ) -> None:
        """One QoS preempt-and-resume suspension (server/qos.py):
        pure audit trail, replay-inert — the parked query is still
        OPEN (its submit frame has no finish), so a coordinator bounce
        re-admits it exactly like any other non-terminal query. The
        frame records the victim's spooled progress (committed
        exchange-spool attempts + stages running at the decision), so
        an operator can see what a resume will reuse."""
        self._append(
            {
                "ev": "qos_suspend",
                "qid": qid,
                "spooled_attempts": int(spooled_attempts),
                "running_stages": int(running_stages),
                "suspensions": int(suspensions),
            }
        )

    def record_resume(self, qid: str, suspended_ms: float = 0.0) -> None:
        """The matching QoS resume close-out (audit trail, replay-
        inert)."""
        self._append(
            {
                "ev": "qos_resume",
                "qid": qid,
                "suspended_ms": float(suspended_ms),
            }
        )

    def record_claim(self, claimant: str, epoch: int) -> None:
        """One failover claim against THIS journal (written by the
        lease-fenced survivor, first, before any close-out): a
        restarted original owner replays it and learns it was claimed
        at ``epoch`` — its new lease must rejoin strictly above."""
        self._append(
            {"ev": "claim", "claimant": claimant, "epoch": int(epoch)}
        )

    def record_alias(self, old_qid: str, qid: str) -> None:
        """One inherited restart alias (written into the SURVIVOR's
        own journal at failover): ``old_qid`` — an id minted by a dead
        peer — now resolves to this coordinator's ``qid``. Makes the
        cross-coordinator alias chain durable past the survivor's own
        next bounce."""
        self._append({"ev": "alias", "old": old_qid, "qid": qid})

    def record_prepare(self, name: str, sql: str) -> None:
        self._append({"ev": "prepare", "name": name, "sql": sql})

    def record_deallocate(self, name: str) -> None:
        self._append({"ev": "deallocate", "name": name})

    # ------------------------------------------------------------- gc

    def _gc_segments(self) -> None:
        """Keep the newest two segments: the newest opens with a full
        checkpoint, the previous guards against a crash tearing that
        checkpoint mid-write (plan/history.py's discipline)."""
        for seg in self._segments()[:-2]:
            try:
                os.unlink(seg)
            except OSError:
                pass

    # ------------------------------------------------------------ read

    def replay(self) -> JournalState:
        """State reconstructed at construction time (the recovery API
        the coordinator consumes once, at start)."""
        return self._replayed

    # ----------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            return {
                "open_queries": len(self._open),
                "prepared": len(self._prepared),
                "segments": len(self._segments()),
                "writes": int(REGISTRY.counter("journal.writes").total),
            }

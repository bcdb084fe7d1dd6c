"""Durable-exchange spool: the recovery plane under fault-tolerant
execution.

The PyTorch port's copy of ``presto_tpu/server/spool.py``: pure Python
over the wire frames of ``server/pages_wire.py``, so the SPL1 files for
the same pages are byte-equal across packages and each package serves
the other's directory. The tee runs on the host, over pages the worker
already serialized for its output buffers: it adds no wait on the card.

Reference parity: Presto/Trino fault-tolerant execution ("Project
Tardigrade") spools exchange data to external storage so that losing a
worker mid multi-stage query restarts only the LOST tasks — upstream
stages re-serve their already-produced pages from the spool instead of
re-running. Here the spool is a shared directory
(``exchange.spool-path``, the filesystem exchange plugin shape): every
worker tees its partitioned output-buffer pages into it as they are
produced, commits the attempt on task FINISH, and any worker (or a
replacement attempt on another worker) can re-serve a partition from
disk when the producer's node is gone.

Keying: deterministic task-attempt ids (:mod:`server.task_ids`). All
attempts of one logical task share a ``logical_key``; consumers take
exactly ONE committed attempt per key (attempt-id dedup), so a retry
racing its zombie original can never double-count.

On-disk layout (one directory, flat)::

    {task_attempt_id}.{partition}.pages   framed page stream
    {task_attempt_id}.ok                  commit marker (written LAST)

Frame: ``b"SPL1"`` once, then per page ``[u32 len][u32 crc32][payload]``
(checksum framing: a torn write or bit flip is detected at read time,
counted in ``spool.corrupt``, and the attempt is skipped — recovery
falls back to another committed attempt or degrades to a task re-run).

GC: committed attempts expire after ``exchange.spool-ttl-s`` and the
directory is bounded by ``exchange.spool-bytes`` (oldest committed
attempts evicted first). Occupancy surfaces in
``system.runtime.caches`` and the ``spool.*`` metrics.
"""

from __future__ import annotations

import os
import re
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional

from presto_tpu_torch.utils import faults
from presto_tpu_torch.utils.metrics import REGISTRY

_MAGIC = b"SPL1"
_FRAME = struct.Struct("<II")

#: default byte budget for the spool directory (exchange.spool-bytes)
DEFAULT_SPOOL_BYTES = 1 << 30
#: default time-to-live for committed attempts (exchange.spool-ttl-s)
DEFAULT_TTL_S = 600.0
#: default queue depth for the background tee drain
#: (exchange.spool-drain-depth)
DEFAULT_DRAIN_DEPTH = 64

#: ``{task_attempt_id}.{partition}.pages`` — task ids contain dots, so
#: the partition is the LAST dot-separated field before the suffix
_PAGES_RE = re.compile(r"^(?P<task>.+)\.(?P<part>\d+)\.pages$")


class SpoolDrain:
    """Background executor for the spool tee: the retry-TASK tee's
    SPL1 serialization (device->host fetch + partition slicing + frame
    writes) runs on ONE daemon thread per worker instead of the
    producer's device loop — durability stops charging the exchange
    hot path.

    Contract with the spool:

    - **Single appender preserved.** Every append of a drained task
      funnels through the one drain thread (worker.offer_page routes
      its inline tee here too when a drain is attached), so the
      spool's one-appender-per-``(task, part)`` file discipline holds
      even when a task's batches mix ICI and HTTP lanes.
    - **Commit-marker-last preserved.** The worker calls
      :meth:`flush` BEFORE ``spool.commit`` — the marker is still
      written after every frame of the attempt is on disk, and a
      failed tee unit surfaces at flush so the worker discards the
      attempt instead of committing a hole.
    - **Bounded.** ``submit`` applies backpressure (the producer
      waits) when ``depth`` units are queued: the drain bounds memory,
      it never drops durability work. After :meth:`close` (worker
      shutdown) units run inline on the caller.
    """

    def __init__(self, depth: int = DEFAULT_DRAIN_DEPTH):
        self.depth = max(1, int(depth))
        self._cond = threading.Condition()
        self._queue: List[tuple] = []  # (task_id, unit fn)
        self._pending: Dict[str, int] = {}  # task -> queued + running
        self._failed: Dict[str, str] = {}
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="spool-drain", daemon=True
        )
        self._thread.start()

    def submit(self, task_id: str, fn) -> None:
        """Queue one tee unit (a zero-argument closure owning its page
        references); blocks while the queue is at depth."""
        with self._cond:
            while len(self._queue) >= self.depth and not self._closed:
                self._cond.wait(0.1)
            if not self._closed:
                self._queue.append((task_id, fn))
                self._pending[task_id] = (
                    self._pending.get(task_id, 0) + 1
                )
                REGISTRY.counter("spool.drain_units").update()
                self._cond.notify_all()
                return
        # closed: shutdown path — durability outlives the drain thread
        fn()

    def flush(self, task_id: str, timeout: float = 60.0) -> None:
        """Wait until every unit of ``task_id`` has run; raises when
        any unit failed (or the wait times out) so the caller discards
        the spool attempt instead of committing it."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._pending.get(task_id, 0) > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"spool drain flush timed out for {task_id}"
                    )
                self._cond.wait(min(left, 0.1))
            err = self._failed.pop(task_id, None)
        if err is not None:
            raise RuntimeError(
                f"spool drain unit failed for {task_id}: {err}"
            )

    def forget(self, task_id: str) -> None:
        """Drop queued units of a dead task (its spool attempt is
        being discarded anyway; a unit already running just finishes
        against the doomed attempt)."""
        with self._cond:
            self._queue = [
                (t, fn) for t, fn in self._queue if t != task_id
            ]
            self._pending.pop(task_id, None)
            self._failed.pop(task_id, None)
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=5.0)

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait(0.2)
                if not self._queue:
                    return  # closed and drained
                task_id, fn = self._queue.pop(0)
                self._cond.notify_all()
            err = None
            try:
                fn()
            except Exception as exc:  # surfaced at flush
                err = f"{type(exc).__name__}: {exc}"
            with self._cond:
                left = self._pending.get(task_id, 0) - 1
                if left > 0:
                    self._pending[task_id] = left
                else:
                    self._pending.pop(task_id, None)
                if err is not None:
                    self._failed[task_id] = err
                self._cond.notify_all()

    def stats(self) -> dict:
        with self._cond:
            return {
                "queued": len(self._queue),
                "tasks": len(self._pending),
                "depth": self.depth,
            }


class ExchangeSpool:
    """Tee + re-serve exchange pages through a shared spool directory."""

    def __init__(
        self,
        path: str,
        budget_bytes: int = DEFAULT_SPOOL_BYTES,
        ttl_s: float = DEFAULT_TTL_S,
    ):
        self.path = path
        self.budget_bytes = int(budget_bytes)
        self.ttl_s = float(ttl_s)
        os.makedirs(path, exist_ok=True)
        self._lock = threading.RLock()
        self._last_gc = 0.0

    @staticmethod
    def from_config(config) -> Optional["ExchangeSpool"]:
        """Spool from tier-1 ``exchange.spool-*`` keys (None when no
        spool path is configured — the zero-cost default)."""
        if config is None:
            return None
        path = config.get("exchange.spool-path")
        if not path:
            return None
        from presto_tpu_torch.utils.memory import parse_bytes

        raw = config.get("exchange.spool-bytes")
        ttl = config.get("exchange.spool-ttl-s")
        return ExchangeSpool(
            path,
            budget_bytes=(
                parse_bytes(raw) if raw is not None else DEFAULT_SPOOL_BYTES
            ),
            ttl_s=float(ttl) if ttl is not None else DEFAULT_TTL_S,
        )

    # ------------------------------------------------------------ naming

    def _pages_file(self, task_id: str, part: int) -> str:
        return os.path.join(self.path, f"{task_id}.{part}.pages")

    def _ok_file(self, task_id: str) -> str:
        return os.path.join(self.path, f"{task_id}.ok")

    # ------------------------------------------------------- produce side

    def append(self, task_id: str, part: int, page: bytes) -> None:
        """Tee one output-buffer page (called as the producer offers it;
        the attempt is not servable until :meth:`commit`).

        Lock-free by contract: exactly one producer thread appends per
        ``(task, part)`` file (worker.offer_page), readers only open
        COMMITTED attempts (commit happens after every append
        returned), and GC never removes an uncommitted attempt whose
        mtime is fresh — so concurrent tasks' tees need not serialize
        behind one instance lock on the exchange hot path."""
        fn = self._pages_file(task_id, part)
        new = not os.path.exists(fn)
        faults.maybe_inject_io("write", fn)
        with open(fn, "ab") as f:
            if new:
                f.write(_MAGIC)
            f.write(_FRAME.pack(len(page), zlib.crc32(page)))
            f.write(page)
        REGISTRY.counter("spool.pages_written").update()
        REGISTRY.counter("spool.bytes_written").update(len(page))

    def commit(self, task_id: str) -> None:
        """Mark the attempt complete — the marker is written LAST, so a
        crash mid-spool leaves an uncommitted (never served) attempt.

        Durable-before-acknowledged: every pages file is fsynced
        BEFORE the marker, and the marker before returning — a
        power loss after commit() must not leave a servable marker
        pointing at page frames still in the page cache (once per
        task, never per page: the tee stays off the hot path)."""
        prefix = task_id + "."
        for fn in self._listdir():
            if fn.startswith(prefix) and fn.endswith(".pages"):
                p = os.path.join(self.path, fn)
                faults.maybe_inject_io("fsync", p)
                try:
                    fd = os.open(p, os.O_RDONLY)
                except FileNotFoundError:
                    # vanished mid-scan (concurrent discard/GC): the
                    # marker below still only covers surviving files
                    continue
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)
        with self._lock:
            ok = self._ok_file(task_id)
            faults.maybe_inject_io("write", ok)
            with open(ok, "wb") as f:
                f.write(b"ok")
                f.flush()
                os.fsync(f.fileno())
        REGISTRY.counter("spool.commits").update()
        # GC at commit (once per task), not per appended page: the
        # tee sits on the exchange hot path and must not pay a
        # directory scan per page
        self.gc()

    def discard(self, task_id: str) -> None:
        """Drop an attempt (FAILED/ABORTED tasks: their partial pages
        must never be served)."""
        with self._lock:
            self._remove_attempt(task_id)

    def _remove_attempt(self, task_id: str) -> None:
        # the .ok marker goes FIRST: a reader that still sees the
        # marker may rely on the pages files existing ("committed but
        # no pages file" reads as an empty partition) — un-commit
        # before touching any data file, mirroring commit's marker-last
        # ordering
        try:
            os.remove(self._ok_file(task_id))
        except OSError:
            pass
        prefix = task_id + "."
        for fn in self._listdir():
            if fn.startswith(prefix) and fn.endswith(".pages"):
                try:
                    os.remove(os.path.join(self.path, fn))
                except OSError:
                    pass

    def _listdir(self) -> List[str]:
        try:
            return os.listdir(self.path)
        except OSError:
            return []

    # ------------------------------------------------------- consume side

    def committed_for_query(self, query_id: str) -> int:
        """Committed attempts belonging to one query — the "spooled
        progress" a QoS suspension records in its journal frame
        (server/qos.py): every counted attempt's partitions will serve
        from the spool on resume instead of re-running, even if its
        worker dies while the query is parked."""
        prefix = query_id + "."
        with self._lock:
            return sum(
                1
                for fn in self._listdir()
                if fn.endswith(".ok") and fn.startswith(prefix)
            )

    def committed_attempts(self, logical_key: str) -> List[str]:
        """Committed attempt ids for one logical task, lowest attempt
        first (the deterministic dedup order)."""
        from presto_tpu_torch.server import task_ids

        out = []
        with self._lock:
            for fn in self._listdir():
                if not fn.endswith(".ok"):
                    continue
                tid = fn[: -len(".ok")]
                if task_ids.logical_key(tid) == logical_key:
                    out.append(tid)
        out.sort(key=lambda t: (len(t), t))  # a2 < a10
        return out

    def serve(self, logical_key: str, part: int) -> Optional[List[bytes]]:
        """Pages of partition ``part`` from exactly ONE committed
        attempt of the logical task (``[]`` when the attempt produced
        no rows for that partition). ``None`` = nothing recoverable:
        no committed attempt, or every committed attempt corrupt."""
        for tid in self.committed_attempts(logical_key):
            fn = self._pages_file(tid, part)
            if not os.path.exists(fn):
                # committed attempt with no pages file: an empty
                # partition — UNLESS a concurrent GC un-committed the
                # attempt between our listing and this check (the
                # marker is always removed before any pages file, so a
                # still-present marker proves the files are intact)
                if not os.path.exists(self._ok_file(tid)):
                    continue
                REGISTRY.counter("spool.hits").update()
                return []
            try:
                pages = self._read_frames(fn, tid)
            except (ValueError, OSError):
                REGISTRY.counter("spool.corrupt").update()
                continue
            REGISTRY.counter("spool.hits").update()
            REGISTRY.counter("spool.pages_served").update(len(pages))
            REGISTRY.counter("spool.bytes_served").update(
                sum(len(p) for p in pages)
            )
            return pages
        REGISTRY.counter("spool.misses").update()
        return None

    def _read_frames(self, fn: str, task_id: str) -> List[bytes]:
        with self._lock:
            with open(fn, "rb") as f:
                buf = f.read()
        if buf[:4] != _MAGIC:
            raise ValueError(f"bad spool magic in {fn}")
        # chaos hook (``spool_corrupt`` rules): flip one payload byte
        # before verification, so the checksum path is the thing tested
        if faults.maybe_inject_spool(task_id) and len(buf) > _FRAME.size + 4:
            i = 4 + _FRAME.size
            buf = buf[:i] + bytes([buf[i] ^ 0xFF]) + buf[i + 1 :]
        pages: List[bytes] = []
        off = 4
        while off < len(buf):
            if off + _FRAME.size > len(buf):
                raise ValueError(f"torn spool frame header in {fn}")
            ln, crc = _FRAME.unpack_from(buf, off)
            off += _FRAME.size
            payload = buf[off : off + ln]
            off += ln
            if len(payload) != ln or zlib.crc32(payload) != crc:
                raise ValueError(f"spool frame checksum mismatch in {fn}")
            pages.append(payload)
        return pages

    # --------------------------------------------------------------- gc

    def gc(self, force: bool = False) -> None:
        """TTL expiry + byte-budget eviction (oldest committed attempts
        first). Throttled to once a second on the hot append path."""
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_gc < 1.0:
                return
            self._last_gc = now
            groups = self._scan()
            wall = time.time()
            # TTL: whole attempts whose newest file is older than ttl_s
            for tid, g in list(groups.items()):
                if wall - g["mtime"] > self.ttl_s:
                    self._remove_attempt(tid)
                    REGISTRY.counter("spool.expired").update()
                    del groups[tid]
            total = sum(g["bytes"] for g in groups.values())
            if total <= self.budget_bytes:
                return
            # budget: evict oldest COMMITTED attempts (an uncommitted
            # attempt is still being produced — never yank it mid-write)
            victims = sorted(
                (g for g in groups.values() if g["committed"]),
                key=lambda g: g["mtime"],
            )
            for g in victims:
                if total <= self.budget_bytes:
                    break
                self._remove_attempt(g["task_id"])
                REGISTRY.counter("spool.evicted").update()
                total -= g["bytes"]

    def _scan(self) -> Dict[str, dict]:
        """Attempt-id -> {bytes, mtime, committed} over the directory."""
        groups: Dict[str, dict] = {}

        def group(tid: str) -> dict:
            return groups.setdefault(
                tid,
                {
                    "task_id": tid,
                    "bytes": 0,
                    "mtime": 0.0,
                    "committed": False,
                },
            )

        for fn in self._listdir():
            path = os.path.join(self.path, fn)
            try:
                st = os.stat(path)
            except OSError:
                continue
            if fn.endswith(".ok"):
                g = group(fn[: -len(".ok")])
                g["committed"] = True
            else:
                m = _PAGES_RE.match(fn)
                if m is None:
                    continue
                g = group(m.group("task"))
                g["bytes"] += st.st_size
            g["mtime"] = max(g["mtime"], st.st_mtime)
        return groups

    # ------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Occupancy + counters for ``system.runtime.caches``."""
        with self._lock:
            groups = self._scan()
        return {
            "entries": sum(1 for g in groups.values() if g["committed"]),
            "bytes": sum(g["bytes"] for g in groups.values()),
            "budget_bytes": self.budget_bytes,
            "hits": int(REGISTRY.counter("spool.hits").total),
            "misses": int(REGISTRY.counter("spool.misses").total),
            "evictions": int(
                REGISTRY.counter("spool.evicted").total
                + REGISTRY.counter("spool.expired").total
            ),
        }

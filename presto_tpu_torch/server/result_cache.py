"""Serving-plane result reuse: the snapshot-keyed result cache and
the MV-aware scan rewrite (reference: Presto's fragment result cache
+ materialized-view rewrite, alluded to in every dashboard-shaped
deployment story).

This is the ONE audited module of the result-reuse plane
(``result-cache-plane`` lint): cache construction, the
fingerprint×snapshot key minting, and the MV rewrite seam live here;
the coordinator and the planner seam in ``exec/local_runner.py`` are
the audited consumers.

Three composable tiers, all keyed on what the engine already knows to
be true:

(a) **Snapshot-keyed result cache** (:class:`ResultCache`): entries
    key on the canonical statement fingerprint (the
    literal-hoisted form — ``x < 24`` and ``x < 30`` share a plan but
    mint DISTINCT result keys because the hoisted literal vector is
    part of the key) × the catalog/schema the statement resolved
    against × session flags that pick the execution backend. A hit is
    zero planning and zero dispatch. Freshness is a snapshot compare:
    the entry records the ``TableHandle.snapshot`` vector pinned at
    plan time plus a per-table write generation bumped through
    the one audited write seam (``_invalidate_table_caches`` fan-in —
    legacy INSERTs and ingest commits both route through it), and a
    ``get`` re-pins every table to detect commits the local seam never
    saw. Entries are byte-budgeted through ``utils/memory.MemoryPool``
    under the ``result-cache`` owner with LRU eviction.

(b) **MV-aware rewrite** (:func:`mview_rewrite`): an eligible
    single-table aggregate SELECT whose shape matches a registered
    materialized view rewrites its scan onto the maintained MV without
    the reader naming it, under the same ``mview.max-staleness-s``
    read-gate discipline named reads get. With the gate off, only a
    provably-current view (base write epoch covered by the view
    state) rewrites — a reader of the BASE table never silently gets
    unbounded staleness it did not opt into.

(c) **Stale-tolerant serving**: a write marks entries STALE instead of
    dropping them; a later read within the session's
    ``result_cache_max_staleness_s`` bound serves the stale result
    (counted, surfaced in EXPLAIN ANALYZE) while ONE background
    refresh re-executes and replaces the entry. Beyond the bound the
    entry drops and the read executes normally.

Everything fails OPEN: any error in key minting, freshness probing, or
rewriting degrades to normal planning + execution, never to a failed
query. Default off (``result-cache.enabled=false`` / session
``enable_result_cache``): no lookup and no entry.

The PyTorch port's copy of ``presto_tpu/server/result_cache.py``: host
code over the port's imports. A hit answers from host rows, so it
launches nothing on the card.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from presto_tpu_torch.utils.metrics import REGISTRY

#: a single entry may not exceed this fraction of the cache budget —
#: one huge result must not evict the whole working set
_MAX_ENTRY_FRACTION = 8


# ------------------------------------------------------------- key minting


def statement_key(stmt, session) -> Optional[tuple]:
    """Mint the result-cache key of one SELECT: canonical statement
    fingerprint × hoisted-literal value vector × session flags that
    change what executes. Returns None when the statement cannot be
    canonicalized (the caller falls open to normal execution).

    The literal vector uses ``repr`` of the hoisted Literal nodes, so
    ``x < 24`` and ``x < 30`` (same canonical form, same cached plan)
    mint distinct RESULT keys, and ``1`` vs ``1.0`` never collide.
    Catalog/schema are inside the canonical key already (name
    resolution depends on them); ``tpu_offload`` rides along because
    it selects the execution backend."""
    from presto_tpu_torch.plan import canonical

    try:
        key, _canon, lits = canonical.canonicalize_statement(
            stmt, session
        )
        flags = (bool(session.get("tpu_offload")),)
        return (key, tuple(repr(v) for v in lits), flags)
    except Exception:
        return None


def snapshot_vector(handles, catalogs) -> Optional[tuple]:
    """The freshness identity of one executed plan: a sorted tuple of
    ``(table_key, snapshot)`` over every scanned table, with the
    snapshot as pinned at plan time. None when ANY scanned
    catalog is non-cacheable (system.runtime.* and other live
    introspection sources must never serve stale) — the caller skips
    the put."""
    vec = []
    for h in handles:
        conn = catalogs.get(h.catalog)
        if conn is None or not conn.cacheable():
            return None
        vec.append((h.table_key, h.snapshot))
    return tuple(sorted(vec))


def _snapshot_label(vector: tuple) -> str:
    """Human form of the pinned snapshot vector for EXPLAIN ANALYZE
    ('v12', 'v3,v7', or 'unversioned')."""
    snaps = [s for _tk, s in vector]
    if not snaps or all(s is None for s in snaps):
        return "unversioned"
    return ",".join("v?" if s is None else f"v{s}" for s in snaps)


# ----------------------------------------------------------------- entries


class CachedResult:
    """Duck-typed stand-in for ``exec.local_runner.QueryResult`` a
    cache hit returns: the coordinator only reads ``columns`` and
    ``rows()`` when storing client-visible results."""

    __slots__ = ("columns", "_rows")

    def __init__(self, columns: Tuple[str, ...], rows: List[list]):
        self.columns = columns
        self._rows = rows

    def rows(self) -> List[list]:
        return self._rows


@dataclasses.dataclass
class ResultEntry:
    key: tuple
    #: the ORIGINAL (pre-rewrite) statement AST — what a background
    #: refresh re-plans (the rewrite seam re-applies itself there)
    stmt: Any
    columns: Tuple[str, ...]
    rows: List[list]
    #: sorted ((catalog, schema, table), snapshot) pinned at plan time
    vector: tuple
    #: per-table write generations (cache-local counters bumped by
    #: :meth:`ResultCache.note_write`) captured at put time
    gens: tuple
    nbytes: int
    created_at: float
    snapshot_label: str
    #: 0.0 = believed fresh; else the instant the entry was first
    #: observed stale (write fan-in or snapshot mismatch) — the clock
    #: the bounded-staleness serve measures against
    stale_at: float = 0.0
    #: one background refresh at a time per entry
    refreshing: bool = False
    hits: int = 0


def _estimate_nbytes(columns, rows) -> int:
    """Cheap, stable byte estimate of a materialized result (what the
    MemoryPool reservation charges): per-row/list overhead plus the
    payload of strings and bytes."""
    n = 256 + 16 * len(columns)
    for row in rows:
        n += 64
        for v in row:
            n += 16
            if isinstance(v, (str, bytes)):
                n += len(v)
    return n


# ------------------------------------------------------------- the cache


class ResultCache:
    """Coordinator-side snapshot-keyed result cache (tier a + c).

    Thread-safe; every public method fails open (returns a miss /
    skips the put) rather than raising. The MemoryPool reservation
    under the ``result-cache`` owner mirrors ``self.bytes`` exactly,
    so the memory dashboard attributes the resident set; reservation
    uses the non-blocking ``try_reserve`` only — a full pool evicts
    our own LRU tail or skips the put, it never stalls a query."""

    def __init__(self, runner, budget_bytes: int, pool=None):
        self.runner = runner
        self.budget_bytes = int(budget_bytes)
        self.pool = pool
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, ResultEntry]" = OrderedDict()
        #: version-blind table_key -> entry keys scanning it
        self._by_table: Dict[tuple, set] = {}
        #: table_key -> write generation (bumped via note_write)
        self._gen: Dict[tuple, int] = {}
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.stale_served = 0
        self.refreshes = 0
        for m in (
            "result_cache.hits",
            "result_cache.misses",
            "result_cache.evictions",
            "result_cache.bytes",
            "result_cache.stale_served",
            "result_cache.refreshes",
        ):
            REGISTRY.counter(m)

    # ------------------------------------------------------------ lookup

    def get(
        self, key: tuple, max_staleness_s: float = 0.0
    ) -> Optional[Tuple[ResultEntry, bool]]:
        """-> (entry, served_stale) on a usable entry, else None.

        Freshness = the per-table write generations captured at put
        still current (the ``_invalidate_table_caches`` fan-in bumps
        them on every write) AND a re-pin of each scanned table still
        resolves to the pinned snapshot (catches ingest commits a
        peer process minted). A stale entry within
        ``max_staleness_s`` of the instant it went stale serves
        anyway (tier c; the caller spawns the background refresh); a
        staler one drops and the read misses."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                # generation compare covers UNVERSIONED tables only:
                # a snapshot-pinned table invalidates by snapshot-id
                # compare below instead (precise, and durable across
                # processes via the manifest chain) — the process-
                # local generation counter neither survives restart
                # nor sees a peer coordinator's commits, while the
                # re-pinned snapshot id does both
                gen_ok = all(
                    g == self._gen.get(tk, 0)
                    for (tk, s), g in zip(entry.vector, entry.gens)
                    if s is None
                )
        if entry is None:
            self._miss()
            return None
        fresh = gen_ok and self._snapshots_current(entry)
        now = time.time()
        if fresh:
            with self._lock:
                entry.hits += 1
            self.hits += 1
            REGISTRY.counter("result_cache.hits").update()
            return entry, False
        if entry.stale_at == 0.0:
            # first observation of staleness (re-pin mismatch the
            # write fan-in never saw): start the bounded-stale clock
            with self._lock:
                if entry.stale_at == 0.0:
                    entry.stale_at = now
        if max_staleness_s > 0 and now - entry.stale_at <= max_staleness_s:
            with self._lock:
                entry.hits += 1
            self.stale_served += 1
            REGISTRY.counter("result_cache.stale_served").update()
            return entry, True
        self._drop(key)
        self._miss()
        return None

    def _miss(self) -> None:
        self.misses += 1
        REGISTRY.counter("result_cache.misses").update()

    def _snapshots_current(self, entry: ResultEntry) -> bool:
        """Re-pin every scanned table and compare against the vector
        pinned at plan time. Unknown catalogs / probe errors read as
        stale (fail open to re-execution, never to a stale serve)."""
        try:
            from presto_tpu_torch.connectors.spi import TableHandle

            for tk, snap in entry.vector:
                conn = self.runner.catalogs.get(tk[0])
                if conn is None:
                    return False
                cur = conn.pin_snapshot(TableHandle(*tk)).snapshot
                if cur != snap:
                    return False
            return True
        except Exception:
            return False

    # -------------------------------------------------------------- put

    def put(self, key: tuple, stmt, columns, rows, handles) -> bool:
        """Insert/replace the entry for ``key`` (idempotent: N
        microbatch members of one hot fingerprint re-putting the same
        result is a cheap replace). Skips (False) when any scanned
        catalog is non-cacheable, the result exceeds the per-entry
        cap, or the pool cannot cover the bytes even after evicting
        our own tail."""
        vector = snapshot_vector(handles, self.runner.catalogs)
        if vector is None or key is None:
            return False
        rows = [list(r) for r in rows]
        nbytes = _estimate_nbytes(columns, rows)
        if nbytes > max(self.budget_bytes // _MAX_ENTRY_FRACTION, 1):
            return False
        with self._lock:
            old = self._entries.get(key)
            if old is not None and old.stale_at == 0.0 and not old.refreshing:
                # a fresh entry is already resident (a concurrent
                # member of the same microbatch put it): keep it
                return True
            entry = ResultEntry(
                key=key,
                stmt=stmt,
                columns=tuple(columns),
                rows=rows,
                vector=vector,
                gens=tuple(self._gen.get(tk, 0) for tk, _s in vector),
                nbytes=nbytes,
                created_at=time.time(),
                snapshot_label=_snapshot_label(vector),
            )
            if old is not None:
                self._drop_locked(key)
            while (
                self.bytes + nbytes > self.budget_bytes and self._entries
            ):
                self._evict_lru_locked()
            if self.bytes + nbytes > self.budget_bytes:
                return False
            while self.pool is not None and not self.pool.try_reserve(
                "result-cache", nbytes
            ):
                if not self._entries:
                    return False
                self._evict_lru_locked()
            self._entries[key] = entry
            self.bytes += nbytes
            REGISTRY.counter("result_cache.bytes").update(nbytes)
            for tk, _s in vector:
                self._by_table.setdefault(tk, set()).add(key)
        return True

    # ----------------------------------------------------- invalidation

    def note_write(self, handle) -> None:
        """Write-path fan-in (``_invalidate_table_caches``): bump the
        table's write generation and mark every entry scanning it
        STALE — the bounded-staleness serve may still answer from it
        within the session bound; anything else re-executes."""
        tk = handle.table_key
        now = time.time()
        with self._lock:
            self._gen[tk] = self._gen.get(tk, 0) + 1
            for key in self._by_table.get(tk, ()):
                entry = self._entries.get(key)
                if entry is not None and entry.stale_at == 0.0:
                    entry.stale_at = now

    #: the coordinator's audited alias at the invalidation seam
    invalidate = note_write

    def _drop(self, key: tuple) -> None:
        with self._lock:
            self._drop_locked(key)

    def _drop_locked(self, key: tuple) -> None:
        entry = self._entries.pop(key, None)
        if entry is None:
            return
        self.bytes -= entry.nbytes
        REGISTRY.counter("result_cache.bytes").update(-entry.nbytes)
        if self.pool is not None:
            self.pool.release("result-cache", entry.nbytes)
        for tk, _s in entry.vector:
            keys = self._by_table.get(tk)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    self._by_table.pop(tk, None)

    def _evict_lru_locked(self) -> None:
        key = next(iter(self._entries))
        self._drop_locked(key)
        self.evictions += 1
        REGISTRY.counter("result_cache.evictions").update()

    def clear(self) -> None:
        with self._lock:
            for key in list(self._entries):
                self._drop_locked(key)

    # ------------------------------------------------ refresh bookkeeping

    def claim_refresh(self, entry: ResultEntry) -> bool:
        """CAS the per-entry refresh flag: True = the caller owns the
        (single) background refresh of this entry."""
        with self._lock:
            if entry.refreshing:
                return False
            entry.refreshing = True
            return True

    def finish_refresh(self, entry: ResultEntry) -> None:
        with self._lock:
            entry.refreshing = False
        self.refreshes += 1
        REGISTRY.counter("result_cache.refreshes").update()

    # ----------------------------------------------------------- surface

    def stats(self) -> dict:
        """The ``result.cache`` row of system.runtime.caches."""
        with self._lock:
            entries = len(self._entries)
        return {
            "entries": entries,
            "bytes": self.bytes,
            "budget_bytes": self.budget_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "stale_served": self.stale_served,
            "refreshes": self.refreshes,
        }


# ------------------------------------------------------ MV-aware rewrite


def _reader_output_name(item, i: int) -> str:
    """The visible column name the planner would give this item
    (plan/planner._item_name discipline) — preserved verbatim on the
    rewritten statement so the client sees identical columns."""
    from presto_tpu_torch.sql import ast

    if item.alias:
        return item.alias
    if isinstance(item.expr, ast.Ident):
        return item.expr.parts[-1]
    return f"_col{i}"


def _match_items(stmt, mv) -> Optional[List[Tuple[str, str]]]:
    """Match every reader select item against an MV query item by
    structural AST equality -> [(mv visible column, reader output
    name), ...] in reader order, or None on any unmatched item."""
    out: List[Tuple[str, str]] = []
    for i, item in enumerate(stmt.items):
        for j, mv_item in enumerate(mv.query.items):
            if item.expr == mv_item.expr:
                out.append(
                    (mv.visible_names[j], _reader_output_name(item, i))
                )
                break
        else:
            return None
    return out


def _shape_matches(stmt, mv, registry) -> bool:
    """The reader is itself an eligible single-table aggregate shape
    over the MV's base, with the SAME filter and grouping."""
    from presto_tpu_torch.sql import ast

    if stmt.ctes or stmt.distinct or stmt.having is not None:
        return False
    if stmt.order_by or stmt.limit is not None:
        return False
    if not isinstance(stmt.from_, ast.TableRef):
        return False
    if registry._resolve(stmt.from_.parts) != tuple(mv.base.table_key):
        return False
    if stmt.where != mv.query.where:
        return False
    if sorted(map(repr, stmt.group_by)) != sorted(
        map(repr, mv.query.group_by)
    ):
        return False
    # every reader item must be a grouped column or an eligible
    # aggregate (structural match against the MV items proves it, but
    # an aggregate the MV does not maintain must not half-match)
    return True


def _freshness_gate(registry, mv) -> bool:
    """The ``mview.max-staleness-s`` read-gate discipline, applied to
    a reader who never NAMED the view: a provably-current view always
    rewrites; a stale one rewrites only under an explicit gate —
    within the bound as-is (the same bounded staleness named reads
    get), beyond it after a full refresh. Gate off + stale = NO
    rewrite (the base-table reader did not opt into staleness).
    Dirty views (a failed incremental merge) never rewrite."""
    if mv.dirty or not mv.eligible:
        return False
    if registry._epoch(mv.base) <= mv.state_epoch:
        return True
    max_s = registry.max_staleness_s
    if max_s is None or max_s <= 0:
        return False
    if time.time() - mv.last_refresh_ts <= max_s:
        return True
    try:
        registry.refresh_view(mv, mode="full")
    except Exception:
        return False
    return True


def mview_rewrite(stmt, registry, session):
    """Tier (b): rewrite an eligible aggregate SELECT over a base
    table onto a registered materialized view maintaining exactly that
    shape. -> (rewritten Select, MViewDef) or None (no candidate, no
    match, or freshness gate closed). Never raises."""
    from presto_tpu_torch.sql import ast

    try:
        if registry is None or not registry:
            return None
        if not isinstance(stmt, ast.Select):
            return None
        for mv in list(registry._defs.values()):
            if not mv.eligible:
                continue
            if not _shape_matches(stmt, mv, registry):
                continue
            cols = _match_items(stmt, mv)
            if cols is None:
                continue
            if not _freshness_gate(registry, mv):
                continue
            REGISTRY.counter("result_cache.mview_rewrites").update()
            rewritten = ast.Select(
                items=tuple(
                    ast.SelectItem(ast.Ident((vis,)), alias=out)
                    for vis, out in cols
                ),
                from_=ast.TableRef(mv.parts),
            )
            return rewritten, mv
        return None
    except Exception:
        return None

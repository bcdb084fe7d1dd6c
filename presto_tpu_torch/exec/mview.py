"""Incrementally-maintained materialized views: a copy of the
reference's ``presto_tpu/exec/mview.py`` (imports rewritten; maintenance
queries run under a QueryStats of their own, see ``_run``). The
server's ingest lane (``server/ingest.py``, ``runner.ingest``) records
each definition durably (``record_mview*``), replays it through
``restore`` and drives ``on_commit`` with every committed delta.

Reference parity: Presto's materialized views over a connector-stored
table (CREATE/REFRESH MATERIALIZED VIEW, SURVEY.md §2.2's metadata
long-tail) crossed with the incremental-maintenance direction of the
streaming warehouses it feeds (PAPER.md L3): eligible aggregate views
are maintained by folding each ingest commit's DELTA batch through the
existing aggregation plane and merging the partial state into the
stored view — no full recompute on the hot path.

Eligibility (the incrementally-mergeable shape): a single-table
``SELECT <group cols>, <aggs> FROM base [WHERE pred] GROUP BY cols``
where every aggregate is SUM/COUNT/MIN/MAX/AVG (no DISTINCT, no
windows) — AVG is decomposed into SUM+COUNT state columns, and
append-only ingest makes MIN/MAX mergeable. Everything else (joins,
HAVING, DISTINCT, set ops, subqueries) still works as a materialized
view, but falls back to a FULL refresh per maintenance event.

State model: the registry keeps, per eligible view, a host-side
``group-key tuple -> accumulator list`` built by the DECOMPOSED query
(AVG split into sum/count); the user-visible stored table is finalized
from that state after every merge (avg = sum/count), so an incremental
chain and a cold full refresh produce bit-identical stored contents —
both are finalized from the same decomposed aggregates, merged with
associative/commutative operators. The state is volatile: after a
crash the ingest WAL replays base tables and re-registers view
definitions (server/ingest.py), and the first refresh rebuilds state
from the recovered base.

Freshness: commits refresh synchronously. For bases written through
the LEGACY path (plain INSERT — no commit hook), reads over a view
pass a staleness gate (``mview.max-staleness-s``): a stale view whose
base has advanced is fully refreshed in-line before the read plans.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from presto_tpu_torch.connectors.spi import TableHandle
from presto_tpu_torch.utils.metrics import REGISTRY

log = logging.getLogger("presto_tpu_torch.mview")

#: aggregate function -> number of state slots (AVG carries sum+count)
_ELIGIBLE_AGGS = {"sum": 1, "count": 1, "min": 1, "max": 1, "avg": 2}


class MViewError(RuntimeError):
    pass


def _merge_slot(kind: str, a, b):
    """Merge two partial-aggregate values (None = the aggregate over
    zero non-null inputs, the identity for sum/min/max)."""
    if a is None:
        return b
    if b is None:
        return a
    if kind in ("sum", "count"):
        return a + b
    if kind == "min":
        return a if a <= b else b
    return a if a >= b else b  # max


@dataclasses.dataclass
class MViewDef:
    """One registered materialized view."""

    parts: Tuple[str, ...]  #: resolved 3-part storage name
    handle: TableHandle  #: storage table (plain, never pinned)
    base: TableHandle  #: base table the query reads
    sql: str  #: the full CREATE statement text (the durable record)
    query: object  #: the parsed ast.Select
    eligible: bool
    reason: str  #: why ineligible ('' when eligible)
    #: per select-item classification, in item order:
    #: ('key', None) or ('agg', kind)
    shape: List[Tuple[str, Optional[str]]]
    #: state-slot kinds after the keys, in slot order (avg contributes
    #: 'sum' then 'count')
    slot_kinds: List[str]
    visible_names: Tuple[str, ...]
    visible_schema: Dict[str, object]
    #: decomposed query template (FROM is re-targeted per run)
    state_query: object
    #: group-key tuple -> accumulator list (eligible views only)
    state: Dict[tuple, list] = dataclasses.field(default_factory=dict)
    #: base-table write epoch the state covers (staleness gate input)
    state_epoch: int = -1
    last_snapshot: Optional[int] = None
    last_refresh_ts: float = 0.0
    last_mode: str = "none"
    refreshes: int = 0
    incremental_refreshes: int = 0
    #: queued (delta, sid) pairs + the single-merger flag: concurrent
    #: commits enqueue; exactly ONE thread drains, so the per-view
    #: delta staging table is never contended and no lock is held
    #: across device work
    pending_deltas: List[tuple] = dataclasses.field(
        default_factory=list
    )
    merging: bool = False
    #: a merge failed (its drained deltas are lost): the state has a
    #: hole, so the next maintenance event must be a FULL refresh —
    #: incremental merging on top would diverge forever when the
    #: staleness gate is off (the default)
    dirty: bool = False


class MViewRegistry:
    """Materialized-view catalog + maintenance engine of one runner."""

    def __init__(self, runner):
        self.runner = runner
        #: resolved 3-part name -> MViewDef
        self._defs: Dict[Tuple[str, ...], MViewDef] = {}
        # RLock: materialization invalidates caches, whose audited hook
        # (runner._invalidate_table_caches) re-enters note_write
        self._lock = threading.RLock()
        #: (catalog, schema, table) -> write epoch (bumped through the
        #: one audited write seam, _invalidate_table_caches)
        self._base_epoch: Dict[tuple, int] = {}
        #: staleness read gate in seconds; None/<=0 = gate off
        self.max_staleness_s: Optional[float] = None
        #: master switch for incremental maintenance (False = every
        #: maintenance event is a full refresh)
        self.incremental_enabled: bool = True

    # ----------------------------------------------------------- plumbing

    def __bool__(self) -> bool:
        return bool(self._defs)

    def _resolve(self, parts: Tuple[str, ...]) -> Tuple[str, ...]:
        sess = self.runner.session
        if len(parts) == 3:
            return tuple(parts)
        if len(parts) == 2:
            return (sess.catalog, parts[0], parts[1])
        return (sess.catalog, sess.schema, parts[0])

    def lookup(self, parts: Tuple[str, ...]) -> Optional[MViewDef]:
        return self._defs.get(self._resolve(parts))

    def note_write(self, handle) -> None:
        """Bump the base-table write epoch (called from the one audited
        write-path seam, ``runner._invalidate_table_caches``) — the
        staleness gate compares view state against this."""
        tk = handle.table_key
        with self._lock:
            self._base_epoch[tk] = self._base_epoch.get(tk, 0) + 1

    def _epoch(self, handle) -> int:
        with self._lock:
            return self._base_epoch.get(handle.table_key, 0)

    def _run(self, stmt):
        """Execute one maintenance query through the normal planning
        path (plan_statement pins base snapshots; execute_plan runs the
        existing aggregation plane) — deliberately NOT through
        ``execute()``/``plan_cached``, so maintenance never re-enters
        the read gate or pollutes the statement cache. The query runs
        under a QueryStats of its own (``runner.run_internal``), so the
        pages it stages outside the split cache are released when it
        ends; the reference runs it with none and leaves them reserved
        under "adhoc"."""
        return self.runner.run_internal(stmt, "mview")

    # --------------------------------------------------------- DDL entry

    def create(self, stmt, sql: str):
        """CREATE MATERIALIZED VIEW: analyze eligibility, create the
        storage table, materialize the initial state (a full refresh),
        and (when the ingest lane is configured) record the definition
        durably so a crash replay re-registers it."""
        mv = self._define(stmt, sql)
        self.refresh_view(mv, mode="full")
        ingest = getattr(self.runner, "ingest", None)
        if ingest is not None:
            ingest.record_mview(".".join(mv.parts), sql)
        return mv

    def restore(self, sql: str) -> Optional[MViewDef]:
        """Re-register a view from its durable CREATE record (WAL
        replay path). The caller refreshes after base tables are
        rebuilt; a record whose base no longer resolves is skipped —
        replay must always come up."""
        from presto_tpu_torch.sql import ast, parse_statement

        try:
            stmt = parse_statement(sql)
            if not isinstance(stmt, ast.CreateMaterializedView):
                return None
            return self._define(stmt, sql)
        except Exception:
            # a view that cannot re-register must not fail replay, but
            # it must not VANISH silently either
            REGISTRY.counter("mview.restore_errors").update()
            log.warning(
                "materialized-view restore failed for %r", sql[:200],
                exc_info=True,
            )
            return None

    def _define(self, stmt, sql: str) -> MViewDef:
        from presto_tpu_torch.sql import ast

        parts = self._resolve(stmt.target)
        with self._lock:
            if parts in self._defs:
                raise MViewError(
                    f"materialized view {'.'.join(parts)} already exists"
                )
        handle = TableHandle(*parts)
        conn = self.runner.catalogs.get(handle.catalog)
        if not conn.supports_writes() or not hasattr(conn, "replace_rows"):
            raise MViewError(
                f"catalog {handle.catalog} cannot store materialized "
                "views (needs writes + replace_rows)"
            )
        eligible, reason, base_parts, shape, slot_kinds, state_query = (
            self._analyze(stmt.query)
        )
        base = (
            TableHandle(*base_parts)
            if base_parts is not None
            else self._first_base(stmt.query)
        )
        if base is None:
            raise MViewError(
                "materialized view query references no base table"
            )
        # PLAN (don't execute) the original query once: the planner's
        # output schema fixes the visible names + engine dtypes — the
        # data comes from the initial refresh, so CREATE/restore pay
        # one aggregation over the base, not two
        from presto_tpu_torch.plan.planner import plan_statement

        plan = plan_statement(
            stmt.query, self.runner.catalogs, self.runner.session
        )
        visible_names = tuple(plan.output_names)
        # positional: output_schema keys are INTERNAL column names in
        # output order; output_names are the user-facing aliases
        out_schema = list(plan.root.output_schema().items())
        if len(out_schema) != len(visible_names):
            raise MViewError(
                "view query output arity mismatch at plan time"
            )
        visible_schema = {
            name: dtype
            for name, (_col, dtype) in zip(visible_names, out_schema)
        }
        conn.create_table(handle, visible_schema)
        mv = MViewDef(
            parts=parts,
            handle=handle,
            base=base,
            sql=sql,
            query=stmt.query,
            eligible=eligible,
            reason=reason,
            shape=shape,
            slot_kinds=slot_kinds,
            visible_names=visible_names,
            visible_schema=visible_schema,
            state_query=state_query,
        )
        with self._lock:
            self._defs[parts] = mv
        return mv

    def drop(self, target: Tuple[str, ...], if_exists: bool = False) -> bool:
        parts = self._resolve(target)
        with self._lock:
            mv = self._defs.pop(parts, None)
        if mv is None:
            if if_exists:
                return False
            raise MViewError(
                f"materialized view {'.'.join(parts)} does not exist"
            )
        conn = self.runner.catalogs.get(mv.handle.catalog)
        if hasattr(conn, "drop_table"):
            conn.drop_table(mv.handle)
        self.runner._invalidate_table_caches(mv.handle)
        ingest = getattr(self.runner, "ingest", None)
        if ingest is not None:
            ingest.record_mview_drop(".".join(parts))
        return True

    def refresh(self, target: Tuple[str, ...]) -> MViewDef:
        """REFRESH MATERIALIZED VIEW name — always a full recompute."""
        parts = self._resolve(target)
        mv = self._defs.get(parts)
        if mv is None:
            raise MViewError(
                f"materialized view {'.'.join(parts)} does not exist"
            )
        self.refresh_view(mv, mode="full")
        return mv

    # ------------------------------------------------------- eligibility

    def _first_base(self, query):
        """Best-effort base handle of an ineligible query (the first
        TableRef anywhere in it) — staleness tracking still works."""
        refs = _table_refs(query)
        if not refs:
            return None
        return TableHandle(*self._resolve(refs[0]))

    def _analyze(self, query):
        """Classify the view query. Returns (eligible, reason,
        base_parts, shape, slot_kinds, state_query)."""
        from presto_tpu_torch.sql import ast

        def no(reason):
            return (False, reason, None, [], [], None)

        if not isinstance(query, ast.Select):
            return no("not a plain SELECT")
        if query.ctes:
            return no("WITH clause")
        if query.distinct:
            return no("SELECT DISTINCT")
        if query.having is not None:
            return no("HAVING (group membership can change)")
        if query.order_by or query.limit is not None:
            return no("ORDER BY / LIMIT")
        if not isinstance(query.from_, ast.TableRef):
            return no("not a single-table FROM")
        base_parts = self._resolve(query.from_.parts)
        group_names = set()
        for g in query.group_by:
            if not isinstance(g, ast.Ident):
                return no("non-column GROUP BY expression")
            group_names.add(g.parts[-1])
        shape: List[Tuple[str, Optional[str]]] = []
        slot_kinds: List[str] = []
        # keys FIRST, then agg slots: the merge code reads decomposed
        # rows as (key tuple, accumulator list) regardless of where
        # the keys sit in the user's select list
        key_items: List[ast.SelectItem] = []
        agg_items: List[ast.SelectItem] = []
        matched_groups = set()
        for i, item in enumerate(query.items):
            e = item.expr
            if isinstance(e, ast.Ident) and (
                e.parts[-1] in group_names
                or (item.alias or "") in group_names
            ):
                shape.append(("key", None))
                key_items.append(ast.SelectItem(e, f"__k{i}"))
                matched_groups.add(
                    e.parts[-1]
                    if e.parts[-1] in group_names
                    else item.alias
                )
                continue
            if (
                isinstance(e, ast.FuncCall)
                and e.name in _ELIGIBLE_AGGS
                and not e.distinct
                and e.window is None
                and len(e.args) <= 1
            ):
                if e.name == "avg":
                    if not e.args:
                        return no("avg() without an argument")
                    shape.append(("agg", "avg"))
                    slot_kinds.extend(("sum", "count"))
                    agg_items.append(
                        ast.SelectItem(
                            ast.FuncCall("sum", e.args), f"__a{i}_s"
                        )
                    )
                    agg_items.append(
                        ast.SelectItem(
                            ast.FuncCall("count", e.args), f"__a{i}_c"
                        )
                    )
                else:
                    shape.append(("agg", e.name))
                    slot_kinds.append(e.name)
                    agg_items.append(ast.SelectItem(e, f"__a{i}"))
                continue
            return no(f"select item {i + 1} is neither a grouped "
                      "column nor an eligible aggregate")
        if len(matched_groups) != len(group_names):
            return no("GROUP BY column missing from the select list")
        if not agg_items:
            return no("no aggregates (nothing to merge)")
        state_query = ast.Select(
            items=tuple(key_items + agg_items),
            from_=query.from_,
            where=query.where,
            group_by=query.group_by,
        )
        return (True, "", base_parts, shape, slot_kinds, state_query)

    # ------------------------------------------------------- maintenance

    def on_commit(
        self, handle, delta_cols, sid: int, epoch_hint=None
    ) -> None:
        """One committed ingest delta for ``handle``: incrementally
        merge it into every eligible view over that base (the delta
        runs through the existing aggregation plane); ineligible views
        — or a base desynced by interleaved legacy writes — fall back
        to a full refresh."""
        tk = handle.table_key
        with self._lock:
            views = [
                mv for mv in self._defs.values()
                if mv.base.table_key == tk
            ]
        if not views:
            return
        conn = self.runner.catalogs.get(handle.catalog)
        pinned = conn.pin_snapshot(TableHandle(*tk))
        for mv in views:
            if (
                mv.eligible
                and self.incremental_enabled
                and pinned.snapshot == sid
                and mv.last_mode != "none"
                and not mv.dirty
            ):
                self._incremental_refresh(
                    mv, delta_cols, sid, epoch_hint
                )
            else:
                self.refresh_view(mv, mode="full", snapshot=sid)

    def _incremental_refresh(
        self, mv: MViewDef, delta_cols, sid, epoch_hint=None
    ) -> None:
        """Enqueue one committed delta and drain as the single merger.

        The single-merger discipline: every commit enqueues under the
        registry lock, but only the thread that flips ``mv.merging``
        runs the delta queries — so the view's STABLE delta-staging
        table (stable name = the compiled delta program is reused
        across commits) is never contended, merges stay seq-ordered
        per view, and no lock is held across device work. A crashed
        merge leaves the flag clear and its queue to the next commit;
        the staleness gate (or REFRESH) repairs a lost delta."""
        n_delta = (
            len(next(iter(delta_cols.values()))) if delta_cols else 0
        )
        if n_delta == 0:
            return
        with self._lock:
            mv.pending_deltas.append(
                (delta_cols, sid, n_delta, epoch_hint)
            )
            if mv.merging:
                return  # the active merger drains the queue
            mv.merging = True
        try:
            while True:
                with self._lock:
                    if not mv.pending_deltas:
                        # flag-clear and emptiness check are ONE
                        # critical section: an enqueuer holds the same
                        # lock, so its delta either landed before this
                        # check (drained below) or lands after the
                        # clear and that thread becomes the merger —
                        # no stranded-delta window
                        mv.merging = False
                        return
                    drained = mv.pending_deltas
                    mv.pending_deltas = []
                for cols, one_sid, one_n, one_hint in drained:
                    self._merge_one_delta(
                        mv, cols, one_sid, one_n, one_hint
                    )
        except BaseException:
            with self._lock:
                mv.merging = False
                # the drained deltas are lost: poison incremental
                # maintenance until a full refresh rebuilds the state
                mv.dirty = True
            raise

    def _merge_one_delta(
        self, mv: MViewDef, delta_cols, sid, n_delta, epoch_hint=None
    ):
        from presto_tpu_torch.sql import ast

        runner = self.runner
        conn = runner.catalogs.get(mv.base.catalog)
        base_schema = conn.metadata().get_table_schema(mv.base)
        # stage the delta into the view's staging table and run the
        # DECOMPOSED query over it — the existing aggregation plane
        # computes the partial state, no bespoke delta kernels. The
        # name is STABLE so every commit reuses one compiled program
        # (the single-merger discipline makes that race-free)
        # reserved namespace, qualified by the VIEW's full identity:
        # same-named views in different schemas/catalogs over one base
        # must not share a staging table (the single-merger flag is
        # per-view, so cross-view sharing would race). The dotted-name
        # digest keeps the mapping injective — an underscore join of
        # the parts is ambiguous when names contain underscores
        ident = hashlib.md5(
            ".".join(mv.parts).encode()
        ).hexdigest()[:12]
        tmp = TableHandle(
            mv.base.catalog,
            mv.base.schema,
            f"__mv_delta_{mv.handle.table}_{ident}",
        )
        conn.create_table(tmp, base_schema)
        conn.append_rows(
            tmp, {c: delta_cols[c] for c in base_schema}
        )
        try:
            delta_q = dataclasses.replace(
                mv.state_query,
                from_=ast.TableRef(
                    (tmp.catalog, tmp.schema, tmp.table)
                ),
            )
            rows = self._run(delta_q).exact_rows()
        finally:
            if hasattr(conn, "drop_table"):
                conn.drop_table(tmp)
            # staged pages of the staging table are per-delta data —
            # they must never serve the next delta's scan
            runner._invalidate_table_caches(tmp)
        n_keys = sum(1 for kind, _ in mv.shape if kind == "key")
        with self._lock:
            if (
                mv.last_snapshot is not None
                and sid <= mv.last_snapshot
            ):
                # a concurrent FULL refresh (REFRESH statement or the
                # staleness gate) read the base at/after this commit —
                # its state already covers the delta; merging it again
                # would double-count
                return
            staleness = (
                (time.time() - mv.last_refresh_ts) * 1000.0
                if mv.last_refresh_ts
                else 0.0
            )
            for row in rows:
                key = tuple(row[:n_keys])
                acc = mv.state.get(key)
                if acc is None:
                    mv.state[key] = list(row[n_keys:])
                else:
                    for j, kind in enumerate(mv.slot_kinds):
                        acc[j] = _merge_slot(
                            kind, acc[j], row[n_keys + j]
                        )
            self._materialize(mv)
            # epoch advance by ATTRIBUTION, not by sampling: the hint
            # is the base's write epoch right after this commit's own
            # invalidate bump. Contiguous (state_epoch + 1) means
            # nothing but this commit wrote since the state's
            # coverage, so the merge covers the epoch; any gap means
            # an interleaved LEGACY write whose rows this merge does
            # NOT carry — leave state_epoch behind so the staleness
            # gate still sees the view as stale and repairs it
            if (
                epoch_hint is not None
                and epoch_hint == mv.state_epoch + 1
            ):
                mv.state_epoch = epoch_hint
            mv.last_snapshot = sid
            mv.last_refresh_ts = time.time()
            mv.last_mode = "incremental"
            mv.refreshes += 1
            mv.incremental_refreshes += 1
        REGISTRY.counter("mview.refreshes").update()
        REGISTRY.counter("mview.incremental_refreshes").update()
        REGISTRY.counter("mview.rows_delta").update(n_delta)
        REGISTRY.distribution("mview.staleness_ms").add(staleness)

    def refresh_view(
        self, mv: MViewDef, mode: str = "full", snapshot=None
    ) -> None:
        """Full recompute from the (snapshot-pinned) base: rebuild the
        decomposed state for eligible views, or re-run the original
        query for ineligible ones, then materialize."""
        epoch = self._epoch(mv.base)
        # snapshot floor SAMPLED BEFORE the read: the planner pins the
        # base at/after this id, so the refreshed state covers every
        # commit <= sid0 — recorded at swap, it lets a concurrent
        # incremental merge recognize (and skip) a delta the refresh
        # already folded in
        conn = self.runner.catalogs.get(mv.base.catalog)
        sid0 = (
            conn.current_snapshot_id(mv.base)
            if hasattr(conn, "current_snapshot_id")
            else None
        )
        if mv.eligible:
            rows = self._run(mv.state_query).exact_rows()
            n_keys = sum(1 for kind, _ in mv.shape if kind == "key")
            new_state = {
                tuple(row[:n_keys]): list(row[n_keys:]) for row in rows
            }
        else:
            res = self._run(mv.query)
            new_state = None
        with self._lock:
            if mv.state_epoch > epoch:
                # a newer maintenance event landed while this full
                # refresh ran over older data — keep its state. But if
                # THIS refresh was a commit's only coverage (on_commit
                # fallback, snapshot set) and the winner was an
                # incremental merge of a LATER delta, the surviving
                # state may have a hole where this commit's rows should
                # be: poison incremental maintenance so the next event
                # rebuilds whole
                if snapshot is not None:
                    mv.dirty = True
                return
            staleness = (
                (time.time() - mv.last_refresh_ts) * 1000.0
                if mv.last_refresh_ts
                else 0.0
            )
            if mv.eligible:
                mv.state = new_state
                self._materialize(mv)
            else:
                out_rows = res.exact_rows()
                idx = [
                    list(res.columns).index(c)
                    for c in mv.visible_names
                ]
                self._store_rows(
                    mv,
                    {
                        c: [r[i] for r in out_rows]
                        for c, i in zip(mv.visible_names, idx)
                    },
                )
            mv.state_epoch = epoch
            # coverage = everything the refresh actually READ: the tip
            # at sample time (sid0) may exceed the commit that
            # triggered the fallback (snapshot) — recording only the
            # trigger would let a concurrent merge re-apply a later
            # delta the refresh already folded in
            sids = [s for s in (snapshot, sid0) if s is not None]
            covered = max(sids) if sids else None
            if covered is not None and (
                mv.last_snapshot is None
                or covered > mv.last_snapshot
            ):
                mv.last_snapshot = covered
            mv.last_refresh_ts = time.time()
            mv.last_mode = mode
            mv.refreshes += 1
            mv.dirty = False  # state rebuilt whole: merge holes healed
        REGISTRY.counter("mview.refreshes").update()
        REGISTRY.distribution("mview.staleness_ms").add(staleness)

    def _materialize(self, mv: MViewDef) -> None:
        """Finalize the decomposed state into the user-visible stored
        table: keys verbatim, sum/count/min/max verbatim, avg =
        sum/count (NULL over zero counted rows). Called under the
        registry lock; incremental and full paths both land here, which
        is what makes their stored contents bit-identical."""
        cols: Dict[str, list] = {c: [] for c in mv.visible_names}
        for key, acc in mv.state.items():
            ki = si = 0
            for c, (kind, agg) in zip(mv.visible_names, mv.shape):
                if kind == "key":
                    cols[c].append(key[ki])
                    ki += 1
                elif agg == "avg":
                    s, n = acc[si], acc[si + 1]
                    si += 2
                    cols[c].append(
                        None if not n or s is None else s / n
                    )
                else:
                    cols[c].append(acc[si])
                    si += 1
        self._store_rows(mv, cols)

    def _store_rows(self, mv: MViewDef, cols: Dict[str, list]) -> None:
        from presto_tpu_torch.exec.staging import obj_array

        conn = self.runner.catalogs.get(mv.handle.catalog)
        conn.replace_rows(
            mv.handle, {c: obj_array(v) for c, v in cols.items()}
        )
        self.runner._invalidate_table_caches(mv.handle)

    # ---------------------------------------------------------- read gate

    def read_gate(self, stmt) -> None:
        """Bound read staleness (``mview.max-staleness-s``): before a
        SELECT over a materialized view plans, fully refresh any
        referenced view whose base advanced since its state epoch and
        whose last refresh is older than the bound. Gate off (None/<=0)
        or no views = zero-cost no-op."""
        if not self._defs:
            return
        max_s = self.max_staleness_s
        if max_s is None or max_s <= 0:
            return
        now = time.time()
        for parts in _table_refs(stmt):
            mv = self._defs.get(self._resolve(parts))
            if mv is None:
                continue
            if (
                self._epoch(mv.base) > mv.state_epoch
                and now - mv.last_refresh_ts > max_s
            ):
                self.refresh_view(mv, mode="full")

    # -------------------------------------------------------------- views

    def view_rows(self) -> List[dict]:
        """system.runtime.materialized_views rows."""
        now = time.time()
        with self._lock:
            defs = list(self._defs.values())
        out = []
        for mv in defs:
            out.append(
                {
                    "view": ".".join(mv.parts),
                    "base_table": ".".join(mv.base.table_key),
                    "eligible": mv.eligible,
                    "reason": mv.reason,
                    "snapshot_id": (
                        -1
                        if mv.last_snapshot is None
                        else int(mv.last_snapshot)
                    ),
                    "last_refresh_mode": mv.last_mode,
                    "refresh_age_s": (
                        now - mv.last_refresh_ts
                        if mv.last_refresh_ts
                        else -1.0
                    ),
                    "refreshes": mv.refreshes,
                    "incremental_refreshes": mv.incremental_refreshes,
                    "rows": (
                        len(mv.state)
                        if mv.eligible
                        else _stored_rows(self.runner, mv)
                    ),
                }
            )
        return out


def _stored_rows(runner, mv: MViewDef) -> int:
    try:
        conn = runner.catalogs.get(mv.handle.catalog)
        st = conn.metadata().get_table_stats(mv.handle)
        return int(st.row_count or 0)
    except Exception:
        return -1


def _table_refs(node, out=None) -> List[Tuple[str, ...]]:
    """Every TableRef's parts anywhere under an AST node (generic
    dataclass walk — subqueries, CTEs, and joins included)."""
    from presto_tpu_torch.sql import ast

    if out is None:
        out = []
    if isinstance(node, ast.TableRef):
        out.append(node.parts)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            _table_refs(getattr(node, f.name), out)
    elif isinstance(node, (tuple, list)):
        for x in node:
            _table_refs(x, out)
    return out

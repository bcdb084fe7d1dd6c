"""History-based statistics: canonical node fingerprints + the
persistent query-history store.

The PyTorch port's copy of ``presto_tpu/plan/history.py`` (Presto's
history-based optimization, HBO — PAPER.md L2): the optimizer plans
from *learned* cardinalities recorded by prior executions of the same
plan shape, falling back to connector stats and heuristics when no
history exists. The runtime already measures the
truth (per-operator row counts of every run —
exec/stats.OperatorStats); this module gives those actuals a durable,
literal-invariant identity and feeds them back into
``plan/optimizer.estimate_rows``.

Three pieces, all owned by THIS module:

1. **Canonical sub-fingerprints** (:func:`node_fingerprint` /
   :func:`node_fingerprints`): a stable digest per plan subtree,
   invariant to literal values (hoistable literals and RuntimeParam
   slots normalize to one placeholder via ``plan/canonical.py``), to
   column pruning (scan column lists, projection lists and join
   payloads are excluded — they never change row counts), and to
   capacity buckets (``max_groups`` / ``out_capacity`` scale on
   overflow retries and must not fork the key). ``WHERE x < 24`` and
   ``< 30`` therefore record under ONE key, and a fragment shipped to
   a worker fingerprints identically to the same subtree inside the
   coordinator's full plan.

2. **QueryHistoryStore**: a bounded, crash-safe on-disk store — JSONL
   segment files under a directory (``history.path``) with an
   in-memory index bounded by ``history.max-entries``. Appends are
   single lines (a torn tail line is skipped at load: corrupt-line
   tolerance); segments rotate and the oldest are deleted once the
   on-disk entry count exceeds the bound. Registered as a
   query-completed listener, so the write path is the SAME path as the
   event sink (exec/stats.QueryHistory.finish). Metrics:
   ``history.{hit,miss,write,evict}``.

3. **The read path** (:func:`using` / :func:`lookup_rows`):
   ``optimizer.estimate_rows`` consults :func:`lookup_rows` before
   connector stats. The store is installed thread-locally around
   planning by the runner (gated on session ``enable_history_stats``;
   ``false`` — or no configured store — leaves every estimate
   bit-exact pre-PR).

4. **The adaptive-execution epoch plane** (ROADMAP item 2 — Presto's
   HBO + adaptive-execution direction): every node fingerprint
   carries a monotonic in-memory **epoch**
   (:meth:`QueryHistoryStore.epoch_of`), bumped when
   :meth:`record_query` *materially* changes the learned cardinality —
   relative change beyond the store's divergence factor
   (``adaptive.divergence-factor``), judged by :func:`diverged`, the
   ONE divergence test both adaptive layers share (the statement-cache
   replan seam in plan/canonical.py and the runtime join-strategy
   switch in the coordinator). Small drift does NOT bump the epoch, so
   cached plans survive noise. :func:`capture_consults` records which
   fingerprints (and which estimates) a planning pass consulted — the
   evidence a plan-cache entry is later re-validated against — and
   :func:`with_overrides` installs mid-query OBSERVED cardinalities so
   the coordinator can re-rank not-yet-scheduled joins by runtime
   truth. Epochs PERSIST through the store: every record (and every
   checkpoint copy at rotation) carries the current epoch beside each
   node's learned rows, and load restores the highest epoch seen — a
   restarted or failed-over coordinator keeps its epoch plane instead
   of silently serving cold-epoch cache hits against warm plans.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from presto_tpu_torch.plan import nodes as N

#: records per on-disk segment file before rotation
_SEGMENT_ENTRIES_MIN = 8

#: relative change beyond which a learned cardinality is considered to
#: CONTRADICT an estimate (tier-1 ``adaptive.divergence-factor`` /
#: session ``adaptive_divergence_factor``)
DEFAULT_DIVERGENCE_FACTOR = 4.0


def diverged(estimate, observed, factor: float) -> bool:
    """The ONE divergence test both adaptive layers share: does the
    observed cardinality contradict the estimate beyond ``factor``
    (symmetric ratio — a 4x factor flags both 4x-over and 4x-under)?
    None/negative inputs never diverge — missing evidence must keep
    plans, not invalidate them."""
    if estimate is None or observed is None:
        return False
    try:
        e = float(estimate)
        o = float(observed)
    except (TypeError, ValueError):
        return False
    if e < 0 or o < 0:
        # negative = an unknown-sentinel (FilterSummary.rows uses -1),
        # never real evidence — checked BEFORE the floor clamp, which
        # would otherwise read -1 as "1 row" and diverge spuriously
        return False
    e, o = max(e, 1.0), max(o, 1.0)
    f = max(float(factor), 1.0)
    return o > e * f or e > o * f


# ------------------------------------------------- canonical fingerprints


def _norm_expr(e) -> str:
    """Literal-invariant image of a predicate/expression (hoistable
    literals and RuntimeParam slots collapse to one placeholder —
    plan/canonical.py owns the eligibility rules)."""
    from presto_tpu_torch.plan import canonical

    try:
        return repr(canonical.normalize_expr(e))
    except Exception:
        return repr(e)


def _signature(node: N.PlanNode, memo: Dict[int, str]) -> str:
    """Structural signature of a plan subtree. Deliberately EXCLUDES
    everything optimization rewrites without changing row counts:
    scan column lists / schemas (pruning), scan constraints (advisory
    split pruning; the filter above stays in place), projection lists,
    join payloads/capacities/build_unique, and agg/unnest capacity
    buckets (overflow retries scale them). What remains is exactly the
    cardinality-determining shape."""
    got = memo.get(id(node))
    if got is not None:
        return got
    if isinstance(node, N.TableScanNode):
        h = node.handle
        sig = f"scan[{h.catalog}.{h.schema}.{h.table}]"
    elif isinstance(node, N.FilterNode):
        tag = "dynfilter" if node.dynamic else "filter"
        sig = (
            f"{tag}[{_norm_expr(node.predicate)}]"
            f"({_signature(node.source, memo)})"
        )
    elif isinstance(node, N.ProjectNode):
        # cardinality-preserving: the projection list never changes
        # row counts, and pruning rewrites it freely
        sig = f"project({_signature(node.source, memo)})"
    elif isinstance(node, N.OutputNode):
        sig = f"output({_signature(node.source, memo)})"
    elif isinstance(node, N.JoinNode):
        resid = (
            _norm_expr(node.residual)
            if node.residual is not None
            else ""
        )
        sig = (
            f"join[{node.join_type}|{list(node.left_keys)}="
            f"{list(node.right_keys)}|resid={resid}]"
            f"({_signature(node.left, memo)},"
            f"{_signature(node.right, memo)})"
        )
    elif isinstance(node, N.AggregationNode):
        keys = [_norm_expr(e) for _, e in node.group_keys]
        funcs = [a.func for a in node.aggs]
        sig = (
            f"agg[keys={keys}|funcs={funcs}]"
            f"({_signature(node.source, memo)})"
        )
    elif isinstance(node, N.DistinctNode):
        sig = f"distinct({_signature(node.source, memo)})"
    elif isinstance(node, N.SortNode):
        sig = (
            f"sort[limit={node.limit}]"
            f"({_signature(node.source, memo)})"
        )
    elif isinstance(node, N.LimitNode):
        sig = (
            f"limit[{node.count}]({_signature(node.source, memo)})"
        )
    elif isinstance(node, N.WindowNode):
        sig = f"window({_signature(node.source, memo)})"
    elif isinstance(node, N.UnnestNode):
        n_el = len(node.elements) if node.elements else 0
        arr = node.array_column or ""
        sig = (
            f"unnest[{arr}|{n_el}]({_signature(node.source, memo)})"
        )
    elif isinstance(node, N.UnionAllNode):
        sig = "union({})".format(
            ",".join(_signature(s, memo) for s in node.sources)
        )
    elif isinstance(node, N.RemoteSourceNode):
        sig = f"remote({_signature(node.fragment_root, memo)})"
    elif isinstance(node, N.ValuesNode):
        sig = "values"
    else:
        sig = "{}({})".format(
            type(node).__name__,
            ",".join(_signature(c, memo) for c in node.children()),
        )
    memo[id(node)] = sig
    return sig


def _digest(sig: str) -> str:
    return hashlib.sha1(sig.encode()).hexdigest()[:16]


def node_fingerprint(node: N.PlanNode) -> str:
    """Canonical sub-fingerprint of one plan subtree (literal- and
    optimization-invariant; see :func:`_signature`)."""
    return _digest(_signature(node, {}))


def node_fingerprints(root: N.PlanNode) -> Dict[int, str]:
    """id(node) -> canonical sub-fingerprint for every node of
    ``root``, in one shared-memo pass (the per-compile batch form)."""
    memo: Dict[int, str] = {}
    out: Dict[int, str] = {}
    for n in N.walk(root):
        out[id(n)] = _digest(_signature(n, memo))
    return out


def plan_fingerprint(root: N.PlanNode) -> str:
    """Canonical statement-level fingerprint: the root's subtree
    fingerprint (keys history records and the event-sink enrichment)."""
    return node_fingerprint(root)


class SignatureMemo:
    """Canonical subtree signatures kept with the trees they were taken
    from, so an id in the memo always names a live node. A memo made
    from ``base`` starts with its signatures and keeps its own additions
    apart: a cached plan's memo is signed once, and each query's memo
    reuses it for the trees its runs build around the plan's subtrees
    (a stage-at-a-time run's rebuilt spine, a fragment's remote source)
    without adding them to the plan's."""

    def __init__(self, base: Optional["SignatureMemo"] = None):
        self._roots: List[N.PlanNode] = list(base._roots) if base else []
        self._sigs: Dict[int, str] = dict(base._sigs) if base else {}

    def fingerprints(self, root: N.PlanNode, nodes) -> Dict[int, str]:
        """id(node) -> canonical sub-fingerprint for each of ``nodes``,
        which lie in the tree under ``root``; the memo keeps ``root``
        (and so every node it signs) alive. A root it already holds a
        signature for is alive under that id, so it is kept already."""
        if id(root) not in self._sigs:
            self._roots.append(root)
        return {id(n): _digest(_signature(n, self._sigs)) for n in nodes}


# --------------------------------------------------- the read-path scope

_SCOPE = threading.local()


@contextlib.contextmanager
def using(store: Optional["QueryHistoryStore"]):
    """Install ``store`` as the active history provider for the current
    thread (the runner wraps planning in this, gated on session
    ``enable_history_stats``). ``None`` is a no-op scope."""
    prev = getattr(_SCOPE, "store", None)
    prev_memo = getattr(_SCOPE, "memo", None)
    prev_sigs = getattr(_SCOPE, "sigs", None)
    _SCOPE.store = store
    _SCOPE.memo = {}
    _SCOPE.sigs = {}
    try:
        yield
    finally:
        _SCOPE.store = prev
        _SCOPE.memo = prev_memo
        _SCOPE.sigs = prev_sigs


def active_store() -> Optional["QueryHistoryStore"]:
    return getattr(_SCOPE, "store", None)


@contextlib.contextmanager
def capture_consults():
    """Record every fingerprint :func:`lookup_rows` is asked about
    inside this scope, mapping it to the evidence the plan was built
    on: ``{"epoch": store epoch at consult time, "rows": learned
    cardinality or None, "est": the classic estimate used on a miss}``.
    The runner wraps canonical-statement planning in this and stores
    the captured dict on the plan-cache entry — the replan seam
    (plan/canonical.stale_consults) later re-validates the entry
    against it. Nests inside :func:`using`."""
    prev = getattr(_SCOPE, "consulted", None)
    con: Dict[str, dict] = {}
    _SCOPE.consulted = con
    try:
        yield con
    finally:
        _SCOPE.consulted = prev


@contextlib.contextmanager
def with_overrides(rows_by_fp: Optional[Dict[str, float]]):
    """Install mid-query OBSERVED cardinalities (node fingerprint ->
    rows) as the highest-priority estimate source for the current
    thread — the coordinator's runtime adaptation re-ranks the
    not-yet-scheduled join remainder under this after each executed
    stage reports its true output rows. Works with or without a
    backing store (overrides are consulted before it)."""
    prev = getattr(_SCOPE, "overrides", None)
    prev_memo = getattr(_SCOPE, "memo", None)
    prev_sigs = getattr(_SCOPE, "sigs", None)
    _SCOPE.overrides = dict(rows_by_fp or {})
    # fingerprint computation inside lookup_rows rides the scope memo;
    # give overrides-only scopes (no store installed) one too
    if prev_memo is None:
        _SCOPE.memo = {}
        _SCOPE.sigs = {}
    try:
        yield
    finally:
        _SCOPE.overrides = prev
        _SCOPE.memo = prev_memo
        _SCOPE.sigs = prev_sigs


def _pinned_signature(node: N.PlanNode, sigs: dict) -> str:
    """Subtree signature memoized ACROSS lookup calls within one scope:
    planner join ordering builds fresh candidate trees around shared
    child subtrees, and recomputing every child's repr-normalized
    signature per estimate call would make history-on planning
    quadratic. ``sigs`` maps id -> (node, sig) and keeps the node
    referenced, so a dead node's id can never alias a live one — which
    makes seeding :func:`_signature`'s plain memo from it safe."""
    ent = sigs.get(id(node))
    if ent is not None and ent[0] is node:
        return ent[1]
    plain = {i: s for i, (_n, s) in sigs.items()}
    seeded = set(plain)
    sig = _signature(node, plain)
    for n in N.walk(node):
        i = id(n)
        if i not in seeded and i in plain:
            sigs[i] = (n, plain[i])
    return sig


def lookup_rows(node: N.PlanNode) -> Optional[float]:
    """Observed output rows for ``node``'s canonical sub-fingerprint,
    or None (no active store / no history). The ONE read path
    ``optimizer.estimate_rows`` consults. Mid-query runtime observations
    (:func:`with_overrides`) take precedence over the store; an
    active :func:`capture_consults` scope records the evidence every
    consult returned. Never raises — a broken store must degrade to
    classic estimation, not fail planning."""
    store = getattr(_SCOPE, "store", None)
    overrides = getattr(_SCOPE, "overrides", None)
    if store is None and not overrides:
        return None
    try:
        memo = getattr(_SCOPE, "memo", None)
        ent = memo.get(id(node)) if memo is not None else None
        if ent is not None and ent[0] is node:
            fp = ent[1]
        else:
            sigs = getattr(_SCOPE, "sigs", None)
            if sigs is None:
                fp = node_fingerprint(node)
            else:
                fp = _digest(_pinned_signature(node, sigs))
            if memo is not None:
                # keep the node referenced so its id cannot be reused
                memo[id(node)] = (node, fp)
        if overrides:
            got = overrides.get(fp)
            if got is not None:
                return float(got)
        if store is None:
            return None
        got = store.lookup(fp)
        con = getattr(_SCOPE, "consulted", None)
        if con is not None and fp not in con:
            con[fp] = {
                "epoch": store.epoch_of(fp),
                "rows": got,
                "est": None,
            }
        return got
    except Exception:
        return None


def note_estimate(node: N.PlanNode, rows: float) -> None:
    """Record the CLASSIC estimate the optimizer fell back to for a
    consulted node with no history — the base the replan divergence
    test compares the first learned cardinality against
    (``optimizer.estimate_rows`` is the one caller). No active capture
    scope = no-op; never raises."""
    con = getattr(_SCOPE, "consulted", None)
    if con is None:
        return
    try:
        memo = getattr(_SCOPE, "memo", None)
        ent = memo.get(id(node)) if memo is not None else None
        if ent is None or ent[0] is not node:
            return
        cap = con.get(ent[1])
        if (
            cap is not None
            and cap.get("rows") is None
            and cap.get("est") is None
        ):
            cap["est"] = float(rows)
    except Exception:
        pass


def progress_total_rows(
    store: Optional["QueryHistoryStore"], node
) -> Optional[float]:
    """History-observed output cardinality for a running query's plan
    root — the expected-total denominator behind the live progress
    endpoint's ETA (``coordinator.query_progress``). Lives HERE so the
    coordinator never calls :func:`lookup_rows` directly (the
    history-sites confinement rule pins that read path to this module
    and the optimizer). None = no store, no plan, or no history for
    this shape; never raises."""
    if store is None or node is None:
        return None
    try:
        with using(store):
            return lookup_rows(node)
    except Exception:
        return None


# -------------------------------------------------------------- the store


class QueryHistoryStore:
    """Bounded crash-safe on-disk history store: JSONL segments under a
    directory + an in-memory index keyed by canonical statement
    fingerprint, with a derived per-node index keyed by canonical
    sub-fingerprints. One record per completed query (latest record of
    a statement wins)."""

    def __init__(
        self,
        path: str,
        max_entries: int = 256,
        divergence_factor: float = DEFAULT_DIVERGENCE_FACTOR,
    ):
        self.path = path
        self.max_entries = max(int(max_entries), 1)
        #: relative change beyond which a re-learned cardinality bumps
        #: its fingerprint's epoch (tier-1 adaptive.divergence-factor)
        self.divergence_factor = max(float(divergence_factor), 1.0)
        self._seg_entries = max(
            _SEGMENT_ENTRIES_MIN, self.max_entries // 4
        )
        self._lock = threading.Lock()
        #: statement fingerprint -> record dict (insertion = recency)
        self._index: "OrderedDict[str, dict]" = OrderedDict()
        #: node sub-fingerprint -> latest observed output rows
        self._nodes: Dict[str, float] = {}
        #: node sub-fingerprint -> monotonic epoch, bumped when a
        #: record MATERIALLY changes the learned cardinality (first
        #: learn included — new evidence versus no evidence). Never
        #: reset by eviction (monotonicity is the staleness signal);
        #: persisted beside every record ("epochs" field) and restored
        #: at load as the max epoch seen, so a restarted coordinator's
        #: plan-cache entries compare against the SAME epochs they
        #: were validated at.
        self._epochs: Dict[str, int] = {}
        self.hits = 0
        self.misses = 0
        self.writes = 0
        self.evictions = 0
        os.makedirs(path, exist_ok=True)
        self._load()

    # ------------------------------------------------------------ disk

    def _segments(self) -> List[str]:
        try:
            names = sorted(
                f
                for f in os.listdir(self.path)
                if f.startswith("history-") and f.endswith(".jsonl")
            )
        except OSError:
            return []
        return [os.path.join(self.path, f) for f in names]

    def _load(self) -> None:
        """Rebuild the index from surviving segments, oldest first so
        later records win. Torn/corrupt lines (a crash mid-append) are
        skipped — the store must always come back up."""
        max_seq = -1
        for seg in self._segments():
            name = os.path.basename(seg)
            try:
                max_seq = max(
                    max_seq, int(name[len("history-"):-len(".jsonl")])
                )
            except ValueError:
                pass
            try:
                with open(seg, encoding="utf-8") as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                        except Exception:
                            continue  # torn write / bit rot: skip
                        if not isinstance(rec, dict) or "fp" not in rec:
                            continue
                        self._apply(rec)
            except OSError:
                continue
        # next sequence AFTER the largest surviving name (NOT the
        # segment count: GC leaves numbering gaps, and reusing a
        # surviving name would invert replay recency and mis-target
        # GC's keep-newest-names policy). A restart always starts a
        # fresh segment, so _cur_count=0 is exact.
        self._seg_seq = max_seq + 1
        self._cur_count = 0
        self._shrink_index(evict_metric=False)
        self._rebuild_nodes()

    def _apply(self, rec: dict) -> None:
        fp = rec["fp"]
        self._index[fp] = rec
        self._index.move_to_end(fp)
        # epoch restore: records persist the epoch each node carried
        # when written; max() keeps monotonicity over replay order
        # (older checkpoint copies must never roll a newer epoch back)
        for nfp, ep in (rec.get("epochs") or {}).items():
            try:
                ep = int(ep)
            except (TypeError, ValueError):
                continue
            if ep > self._epochs.get(nfp, 0):
                self._epochs[nfp] = ep

    def _shrink_index(self, evict_metric: bool = True) -> int:
        from presto_tpu_torch.utils.metrics import REGISTRY

        evicted = 0
        while len(self._index) > self.max_entries:
            self._index.popitem(last=False)
            evicted += 1
            if evict_metric:
                self.evictions += 1
                REGISTRY.counter("history.evict").update()
        return evicted

    def _rebuild_nodes(self) -> None:
        self._nodes = {}
        for rec in self._index.values():
            for nfp, nd in (rec.get("nodes") or {}).items():
                try:
                    self._nodes[nfp] = float(nd["rows"])
                except (KeyError, TypeError, ValueError):
                    pass

    def _cur_segment(self) -> str:
        return os.path.join(
            self.path, f"history-{self._seg_seq:06d}.jsonl"
        )

    def _gc_segments(self) -> None:
        """Delete all but the newest two segments. Safe because a
        rotation opens each new segment with a full checkpoint of the
        live index, so the newest segment alone replays every index
        entry (counting retained LINES instead would let a hot
        statement's duplicates crowd out the only on-disk copy of
        colder entries); the previous segment is kept in case a crash
        tore the newest checkpoint mid-write."""
        segs = self._segments()
        for seg in segs[:-2]:
            try:
                os.unlink(seg)
            except OSError:
                pass

    # ------------------------------------------------------------- write

    def record_query(
        self,
        stmt_fp: str,
        sql: str,
        nodes: Dict[str, dict],
    ) -> None:
        """Persist one completed query's per-node actuals. ``nodes``
        maps canonical sub-fingerprint -> {"rows": int, "label": str}.
        Crash-safe: one JSON line, flushed; a torn line is skipped at
        the next load."""
        from presto_tpu_torch.utils.metrics import REGISTRY

        if not stmt_fp or not nodes:
            return
        rec = {
            "fp": stmt_fp,
            "query": (sql or "")[:500],
            "ts": time.time(),
            "nodes": nodes,
        }
        with self._lock:
            # epoch plane FIRST (so the record persists the bumped
            # epochs): a record that MATERIALLY changes a learned
            # cardinality (or learns one for the first time) bumps the
            # node's epoch — the cheap staleness signal plan-cache
            # entries compare against. Small drift keeps the epoch:
            # noise must not invalidate every warm plan.
            for nfp, nd in nodes.items():
                try:
                    new_rows = float(nd["rows"])
                except (KeyError, TypeError, ValueError):
                    continue
                prev_rows = self._nodes.get(nfp)
                if prev_rows is None or diverged(
                    prev_rows, new_rows, self.divergence_factor
                ):
                    self._epochs[nfp] = self._epochs.get(nfp, 0) + 1
            # the epoch rides the record to disk: a restarted
            # coordinator restores it at load instead of serving
            # cold-epoch cache hits (epoch 0) against warm plans
            rec["epochs"] = {
                nfp: self._epochs.get(nfp, 0) for nfp in nodes
            }
            line = json.dumps(rec, default=str)
            rotate = self._cur_count >= self._seg_entries
            if rotate:
                self._seg_seq += 1
                self._cur_count = 0
            try:
                with open(self._cur_segment(), "a", encoding="utf-8") as f:
                    if rotate:
                        # compaction checkpoint: the fresh segment
                        # opens with a snapshot of the live index, so
                        # every entry stays replayable once GC drops
                        # the older segments — epochs refreshed to
                        # CURRENT (a record's stored epoch may predate
                        # later bumps; the checkpoint must not replay
                        # a rollback)
                        for old in self._index.values():
                            if old.get("fp") != stmt_fp:
                                dup = dict(old)
                                dup["epochs"] = {
                                    nfp: self._epochs.get(nfp, 0)
                                    for nfp in (old.get("nodes") or {})
                                }
                                f.write(
                                    json.dumps(dup, default=str) + "\n"
                                )
                    f.write(line + "\n")
                    f.flush()
                self._cur_count += 1
                if rotate:
                    self._gc_segments()
            except OSError:
                pass  # a full/broken disk must never fail the query
            prev = self._index.get(stmt_fp)
            self._apply(rec)
            evicted = self._shrink_index()
            if evicted or (
                prev is not None
                and set(prev.get("nodes") or {}) != set(nodes)
            ):
                # an evicted (or shape-shifted) record may own node
                # keys no surviving record covers — rebuild
                self._rebuild_nodes()
            else:
                # common warm path: fold just this record's nodes
                # instead of re-deriving the whole index under the
                # lock planner-side lookup() contends on
                for nfp, nd in nodes.items():
                    try:
                        self._nodes[nfp] = float(nd["rows"])
                    except (KeyError, TypeError, ValueError):
                        pass
            self.writes += 1
        REGISTRY.counter("history.write").update()

    def query_completed(self, event) -> None:
        """Query-completed listener hook: the store's write path is the
        SAME path as the JSONL event sink (exec/stats.QueryHistory).
        Only successful queries record — a failed run's partial row
        counts would poison the learned cardinalities."""
        qs = event.stats
        if qs.error is not None:
            return
        fp = getattr(qs, "plan_fingerprint", "")
        ops = (
            qs.all_operator_stats()
            if hasattr(qs, "all_operator_stats")
            else getattr(qs, "operators", None) or []
        )
        nodes = {
            op.fingerprint: {
                "rows": int(op.output_rows),
                "label": op.label,
            }
            for op in ops
            if op.fingerprint and op.output_rows >= 0
        }
        self.record_query(fp, qs.sql, nodes)

    # -------------------------------------------------------------- read

    def lookup(self, fp: str) -> Optional[float]:
        from presto_tpu_torch.utils.metrics import REGISTRY

        with self._lock:
            got = self._nodes.get(fp)
            if got is None:
                self.misses += 1
            else:
                self.hits += 1
        if got is None:
            REGISTRY.counter("history.miss").update()
            return None
        REGISTRY.counter("history.hit").update()
        return got

    def epoch_of(self, fp: str) -> int:
        """Current epoch of one node fingerprint (0 = never learned /
        never materially changed in this process). Metric-silent: the
        plan-cache staleness check must not skew history.hit/miss."""
        with self._lock:
            return self._epochs.get(fp, 0)

    def learned_rows(self, fp: str) -> Optional[float]:
        """Latest learned cardinality for one node fingerprint,
        metric-silent (the replan seam's read — see ``lookup`` for
        the counted estimate-time path)."""
        with self._lock:
            return self._nodes.get(fp)

    # ----------------------------------------------------- introspection

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._index),
                "capacity": self.max_entries,
                "nodes": len(self._nodes),
                "hits": self.hits,
                "misses": self.misses,
                "writes": self.writes,
                "evictions": self.evictions,
            }

    def snapshot(self) -> List[dict]:
        """Rows for the ``system.runtime.query_history`` view."""
        with self._lock:
            out = []
            for rec in self._index.values():
                nodes = rec.get("nodes") or {}
                out.append(
                    {
                        "fingerprint": rec.get("fp", ""),
                        "query": rec.get("query", ""),
                        "node_count": len(nodes),
                        "total_rows": sum(
                            int(n.get("rows", 0)) for n in nodes.values()
                        ),
                        # adaptive-execution staleness signal: the
                        # newest epoch among this statement's recorded
                        # operator fingerprints (the statement-level
                        # view of what epoch-versioned plan-cache
                        # entries are judged by)
                        "epoch": max(
                            (
                                self._epochs.get(nfp, 0)
                                for nfp in nodes
                            ),
                            default=0,
                        ),
                        "updated": float(rec.get("ts", 0.0)),
                    }
                )
            return out

"""Literal parameterization and the statement-level plan cache.

The PyTorch counterpart of ``presto_tpu/plan/canonical.py``: the same
query *shape* arriving many times with different literals must not
re-pay parse -> plan -> optimize per arrival.

1. **Statement-level plan cache** (:class:`PlanCache`): bare
   NumberLit/DateLit comparison operands in WHERE / HAVING / JOIN-ON
   are rewritten to ``ast.BoundParam`` placeholders; the canonical
   AST's repr (plus catalog/schema) keys a bounded LRU of planned and
   optimized plans. A hit skips analysis, planning and optimization and
   binds the new literal values into the cached plan's
   ``expr.RuntimeParam`` slots. PREPARE/EXECUTE rides this: a warm
   EXECUTE plans nothing.

2. **The parameter vector** (:func:`active_params`): the runner installs
   the execution's bound values (ordinal -> ``expr.Literal``) around
   the operators it runs, and ``ExprLowerer._eval_runtimeparam`` reads
   them: a RuntimeParam evaluates exactly as its bound Literal does.
   The port runs eagerly and has no compile cache, so it does not hoist
   further literals at execution time; :func:`hoist_params`,
   :func:`bind_literal_root` and :func:`normalize_expr` are the
   reference's walkers over one rule set, and the runner's literal-form
   lane (a parameterized plan that fails to run re-runs with its values
   bound back as Literals) goes through :func:`bind_literal_root`.

Eligibility (:func:`_hoistable`; everything else stays a constant,
bucketing the cache rather than breaking it):

- strings stay constants: dictionary comparisons resolve literal ids
  against the column's dictionary on the host;
- NULL literals stay constants: a NULL's validity lane is structure,
  not a value;
- long decimals (int128 limb pairs) stay constants;
- booleans stay constants (two buckets at most, often folded);
- a literal multiplying/dividing a long-decimal operand stays constant;
- structure-controlling integers are not literals at all by the time
  plans exist (LIMIT counts, capacity buckets, IN-list LENGTHS: the
  list length is the tuple arity, which stays in the key).

3. **Epoch-versioned entries** (adaptive execution): an entry keeps
   the history evidence its optimization consulted
   (``PlanCacheEntry.consulted``), and :func:`stale_consults` judges a
   later hit stale when a learned cardinality has since diverged from
   it; the runner's ``_adaptive_replan`` then replans and replaces the
   entry (``PlanCache.note_replan``).

4. **The micro-batch plane** (:func:`batch_lanes`,
   :func:`stack_param_vectors`, :func:`lane_vectors`,
   :func:`batch_entry_key`): N concurrent statements of one cached
   shape differ only in their bound values, which stack along a lane
   axis and become device tensors; the runner then runs the plan once
   over lane-blocked pages (``page.tile_lanes``), where a RuntimeParam
   evaluates to each lane's value over that lane's rows. The lane axis
   is written out by hand where the reference ``jax.vmap``s its traced
   program (``vmap_program``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from presto_tpu_torch import expr as E
from presto_tpu_torch import types as T
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.sql import ast


# ------------------------------------------------------- parameter vector
# (installed by the runner around _execute_node; read by
# ExprLowerer._eval_runtimeparam)

_ACTIVE = threading.local()


@contextlib.contextmanager
def active_params(params):
    """Install the parameter vector (a sequence, or a dict keyed by
    dense ordinals) for the operators run on this thread."""
    prev = getattr(_ACTIVE, "value", None)
    _ACTIVE.value = params
    try:
        yield
    finally:
        _ACTIVE.value = prev


def active_param(index: int):
    params = getattr(_ACTIVE, "value", None)
    if params is None or index >= len(params):
        raise RuntimeError(
            f"RuntimeParam slot {index} evaluated outside an "
            "active parameter vector (plan/canonical.py owns hoisting "
            "and binding)"
        )
    return params[index]


# ------------------------------------------------------------- eligibility


def _hoistable(lit: E.Literal) -> bool:
    """May this literal become a runtime parameter? (module docstring
    spells out each exclusion)."""
    if lit.value is None:
        return False
    t = lit.dtype
    if t.is_string or t.is_long_decimal:
        return False
    if t.name == "boolean":
        return False
    if not (t.is_numeric or t.name in ("date", "timestamp")):
        return False
    return isinstance(lit.value, (int, float)) and not isinstance(
        lit.value, bool
    )


def _param_np(value, dtype: T.DataType):
    """Host-side image of one parameter: a () ndarray in the literal's
    NATIVE dtype (dtype bucketing: int64 and float32 variants are
    different canonical forms, never a silent cast)."""
    return np.asarray(value, dtype=dtype.np_dtype)


# ------------------------------------------------- plan-level hoisting pass


class _Hoist:
    """One hoisting pass over a plan tree: collects the parameter
    vector while rewriting eligible Literal leaves to RuntimeParam
    slots and re-indexing pre-bound RuntimeParams (statement-cache
    plans) against ``bound``."""

    def __init__(self, bound, hoist_literals: bool):
        self.bound = bound or {}
        self.hoist_literals = hoist_literals
        self.values: List[np.ndarray] = []

    def _bound_lit(self, e: E.RuntimeParam) -> E.Literal:
        lit = self.bound.get(e.index)
        if lit is None:
            raise RuntimeError(
                f"RuntimeParam slot {e.index} has no bound value "
                "(a cached canonical plan executed without its "
                "parameter vector)"
            )
        return lit

    # leaf hooks — _Bind (bind_literal_root) overrides exactly these,
    # so there is ONE deep expression walker to keep in sync with the
    # Expr dataclasses, not two
    def on_runtime_param(self, e: E.RuntimeParam) -> E.Expr:
        idx = len(self.values)
        self.values.append(_param_np(self._bound_lit(e).value, e.dtype))
        return E.RuntimeParam(idx, e.dtype)

    def on_literal(self, e: E.Literal) -> E.Expr:
        if self.hoist_literals and _hoistable(e):
            idx = len(self.values)
            self.values.append(_param_np(e.value, e.dtype))
            return E.RuntimeParam(idx, e.dtype)
        return e

    def expr(self, e: E.Expr) -> E.Expr:
        if isinstance(e, E.RuntimeParam):
            return self.on_runtime_param(e)
        if isinstance(e, E.Literal):
            return self.on_literal(e)
        if isinstance(e, E.Arithmetic) and (
            e.left.dtype.is_long_decimal or e.right.dtype.is_long_decimal
        ):
            # keep the literal operand constant: long-decimal arithmetic
            # takes a compile-time small-int multiply fast path
            changes = {}
            for name in ("left", "right"):
                v = getattr(e, name)
                if not isinstance(v, E.Literal):
                    nv = self.expr(v)
                    if nv is not v:
                        changes[name] = nv
            return dataclasses.replace(e, **changes) if changes else e
        if not dataclasses.is_dataclass(e):
            return e
        changes = {}
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, E.Expr):
                nv = self.expr(v)
                if nv is not v:
                    changes[f.name] = nv
            elif isinstance(v, tuple):
                nt = tuple(
                    self.expr(x)
                    if isinstance(x, E.Expr)
                    else (
                        tuple(
                            self.expr(y) if isinstance(y, E.Expr) else y
                            for y in x
                        )
                        if isinstance(x, tuple)
                        else x
                    )
                    for x in v
                )
                if any(a is not b for a, b in zip(nt, v)):
                    changes[f.name] = nt
        return dataclasses.replace(e, **changes) if changes else e

    # expr-bearing plan-node fields the pass rewrites; everything else
    # (scan constraints, sort keys, window calls) stays constant — sort
    # and window literals can control kernel structure, and a scan
    # constraint IS the value (split pruning)
    def node(self, node: N.PlanNode) -> N.PlanNode:
        changes = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, N.PlanNode):
                nv = self.node(v)
                if nv is not v:
                    changes[f.name] = nv
            elif (
                isinstance(v, tuple) and v and isinstance(v[0], N.PlanNode)
            ):
                nt = tuple(self.node(x) for x in v)
                if any(a is not b for a, b in zip(nt, v)):
                    changes[f.name] = nt
        if isinstance(node, N.FilterNode):
            np_ = self.expr(node.predicate)
            if np_ is not node.predicate:
                changes["predicate"] = np_
        elif isinstance(node, N.ProjectNode):
            projs = tuple(
                (name, self.expr(e)) for name, e in node.projections
            )
            if any(
                a[1] is not b[1] for a, b in zip(projs, node.projections)
            ):
                changes["projections"] = projs
        elif isinstance(node, N.JoinNode):
            if node.residual is not None:
                nr = self.expr(node.residual)
                if nr is not node.residual:
                    changes["residual"] = nr
        elif isinstance(node, N.AggregationNode):
            keys = tuple(
                (name, self.expr(e)) for name, e in node.group_keys
            )
            if any(
                a[1] is not b[1] for a, b in zip(keys, node.group_keys)
            ):
                changes["group_keys"] = keys
            aggs = []
            agg_changed = False
            for a in node.aggs:
                na = a
                if a.arg is not None:
                    arg = self.expr(a.arg)
                    if arg is not a.arg:
                        na = dataclasses.replace(na, arg=arg)
                arg2 = getattr(a, "arg2", None)
                if arg2 is not None:
                    n2 = self.expr(arg2)
                    if n2 is not arg2:
                        na = dataclasses.replace(na, arg2=n2)
                agg_changed |= na is not a
                aggs.append(na)
            if agg_changed:
                changes["aggs"] = tuple(aggs)
        elif isinstance(node, N.UnnestNode):
            if node.elements:
                els = tuple(self.expr(e) for e in node.elements)
                if any(a is not b for a, b in zip(els, node.elements)):
                    changes["elements"] = els
        return (
            dataclasses.replace(node, **changes) if changes else node
        )


def hoist_params(
    root: N.PlanNode,
    bound: Optional[Dict[int, E.Literal]] = None,
    hoist_literals: bool = True,
) -> Tuple[N.PlanNode, Tuple[np.ndarray, ...]]:
    """Canonicalize ``root`` for compilation: eligible literals hoist
    into RuntimeParam slots (when ``hoist_literals``), statement-cache
    RuntimeParams re-index densely against ``bound``, and the matching
    parameter vector (host () ndarrays in native dtypes) is returned.
    Identity-preserving: an unchanged tree returns ``root`` itself with
    an empty vector — the exact pre-cache compile path."""
    h = _Hoist(bound, hoist_literals)
    croot = h.node(root)
    return croot, tuple(h.values)


class _Bind(_Hoist):
    """RuntimeParam -> plain Literal substitution over the SAME walker
    as hoisting (only the leaf hooks differ)."""

    def on_runtime_param(self, e: E.RuntimeParam) -> E.Expr:
        return E.Literal(self._bound_lit(e).value, e.dtype)

    def on_literal(self, e: E.Literal) -> E.Expr:
        return e


class _Normalize(_Hoist):
    """Literal-invariant normalization over the SAME walker as hoisting:
    every hoistable literal AND every RuntimeParam slot collapses to the
    ONE placeholder ``RuntimeParam(0, dtype)``, so a literal-form tree
    and its hoisted canonical form normalize identically. This is the
    value-erasing image history fingerprints digest (plan/history.py) —
    NOT an executable tree (slot 0 is deliberately shared)."""

    def __init__(self):
        super().__init__({}, True)

    def on_runtime_param(self, e: E.RuntimeParam) -> E.Expr:
        return E.RuntimeParam(0, e.dtype)

    def on_literal(self, e: E.Literal) -> E.Expr:
        if _hoistable(e):
            return E.RuntimeParam(0, e.dtype)
        return e


def normalize_expr(e: E.Expr) -> E.Expr:
    """Value-erased image of one expression for history fingerprinting
    (plan/history.py is the only intended consumer): hoistable literals
    and RuntimeParams become index-0 placeholders; everything the
    hoisting pass would keep constant (strings, NULLs, long decimals,
    booleans, long-decimal-arithmetic operands) stays in place — the
    SAME eligibility rules, via the same walker."""
    return _Normalize().expr(e)


def bind_literal_root(
    root: N.PlanNode, bound: Optional[Dict[int, E.Literal]]
) -> N.PlanNode:
    """Substitute bound values back as plain Literals (the no-hoist
    fallback and the distributed materialize path: a literal-form tree
    with no RuntimeParam leaves)."""
    return _Bind(bound, False).node(root)


def materialize_plan(plan):
    """A literal (RuntimeParam-free) copy of a cached plan — the
    distributed path ships fragments with plain literals so the wire
    protocol and worker-side execution are unchanged; workers then
    re-hoist locally and hit their own compile caches across literal
    variants."""
    from presto_tpu_torch.plan.planner import Plan

    if not plan.bound_values:
        return plan
    root = bind_literal_root(plan.root, plan.bound_values)
    # scalar-subquery subplans share the statement's ordinal space:
    # materialize them against the same bound map
    params = [
        (pid, materialize_plan(_with_bound(sub, plan.bound_values)))
        for pid, sub in plan.params
    ]
    return Plan(
        root=root,
        params=params,
        output_names=plan.output_names,
        bound_values=None,
        preoptimized=plan.preoptimized,
    )


def _with_bound(plan, bound):
    from presto_tpu_torch.plan.planner import Plan

    return Plan(
        root=plan.root,
        params=plan.params,
        output_names=plan.output_names,
        bound_values=bound,
        preoptimized=getattr(plan, "preoptimized", False),
    )


# ------------------------------------------------- micro-batch plane
#
# Many concurrent statements of ONE canonical shape differ only in
# their bound parameter vectors. The micro-batch serving plane answers
# N of them with ONE pass of the operators: the members' vectors stack
# along a lane axis and become device tensors, and the plan runs once
# over lane-blocked pages (exec/local_runner.py::execute_plan_microbatch).
# Everything lane-axis-shaped on the host is constructed HERE: a
# stacking built elsewhere could disagree with the dtype rules above
# and cross members' answers.

#: lane-count buckets: a batch of any size up to the bucket names the
#: bucket in its entry key. The reference pads a batch to its bucket so
#: one compiled program serves every size; the port compiles nothing,
#: so a batch runs exactly its members' lanes
_BATCH_LANE_BUCKETS = (2, 4, 8, 16, 32, 64, 128)


def batch_lanes(n: int) -> int:
    """Smallest lane bucket holding ``n`` members (n > the largest
    bucket is the caller's error: serving.microbatch-max caps groups)."""
    for b in _BATCH_LANE_BUCKETS:
        if n <= b:
            return b
    raise ValueError(
        f"micro-batch of {n} exceeds the largest lane bucket "
        f"{_BATCH_LANE_BUCKETS[-1]}"
    )


def stack_param_vectors(
    vectors: List[Tuple[np.ndarray, ...]], lanes: int
) -> Tuple[np.ndarray, ...]:
    """Stack N members' parameter vectors along a NEW leading lane
    axis, padded to ``lanes`` by repeating the last member. Every member
    must carry the same arity and per-slot dtype — guaranteed when the
    members share one canonical key (dtype bucketing is part of the
    canonical form), re-checked here because a mismatch would cross
    members' answers, not just miss a cache."""
    if not vectors or lanes < len(vectors):
        raise ValueError("stack_param_vectors: bad lane count")
    arity = len(vectors[0])
    for v in vectors:
        if len(v) != arity:
            raise ValueError(
                "micro-batch members disagree on parameter arity"
            )
        for a, b in zip(v, vectors[0]):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise ValueError(
                    "micro-batch members disagree on parameter dtype"
                )
    padded = list(vectors) + [vectors[-1]] * (lanes - len(vectors))
    return tuple(
        np.stack([v[i] for v in padded]) for i in range(arity)
    )


def bound_vector(bound: Dict[int, E.Literal]) -> Tuple[np.ndarray, ...]:
    """One member's parameter vector in ordinal order: each bound
    Literal's host image in its native dtype (``_param_np``)."""
    return tuple(
        _param_np(bound[i].value, bound[i].dtype) for i in sorted(bound)
    )


def lane_vectors(stacked: Tuple[np.ndarray, ...], device) -> Dict[int, object]:
    """The stacked vectors as the runner's active parameter vector:
    ordinal -> a (lanes,) tensor on ``device`` (the counterpart of the
    reference's ``vmap_program``: the lane axis written out).
    ``ExprLowerer._eval_runtimeparam`` spreads lane l's value over lane
    l's rows of a lane-blocked page, with no host read. A CUDA copy
    leaves from pinned memory without waiting for queued work."""
    import torch

    device = torch.device(device)
    out = {}
    for i, arr in enumerate(stacked):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[i] = t
    return out


def batch_entry_key(
    cfp: str, counted: bool, offload: bool, lanes: int, window: int
) -> tuple:
    """Key of a batched shape: the scalar canonical fingerprint plus the
    lane bucket and the demux window (each lane is compacted to the
    window), tagged so it can never collide with a scalar key. The
    runner counts served batches under it (``batch_entries``)."""
    return (cfp, False, counted, offload, "batch", lanes, window)


# ---------------------------------------------- statement canonicalization

#: comparison operators whose bare literal operands are safe to hoist at
#: the AST level: the analyzer lowers them through the one generic
#: comparison path (planner._lower BinaryOp/Between/InList)
_CMP_OPS = ("=", "<>", "!=", "<", "<=", ">", ">=")


def literal_info(node: ast.Node) -> Optional[E.Literal]:
    """ast literal -> typed E.Literal, via the SAME conversions the
    analyzer applies (planner._number_literal / _parse_date) — the
    bound values must be byte-identical to what planning the literal
    in place would have produced."""
    from presto_tpu_torch.plan.planner import _number_literal, _parse_date

    if isinstance(node, ast.NumberLit):
        return _number_literal(node.text)
    if isinstance(node, ast.DateLit):
        return E.Literal(_parse_date(node.value), T.DATE)
    return None


class _AstCanon:
    """Rewrites bare NumberLit/DateLit comparison operands in
    WHERE / HAVING / JOIN-ON predicates (including those inside
    subqueries, CTEs and set-operation terms) to BoundParam
    placeholders, collecting their typed values by ordinal."""

    def __init__(self):
        self.values: List[E.Literal] = []

    def maybe_param(self, node: ast.Node) -> ast.Node:
        lit = literal_info(node)
        if lit is None or not _hoistable(lit):
            return node
        ordinal = len(self.values)
        self.values.append(lit)
        return ast.BoundParam(
            ordinal=ordinal, dtype_name=str(lit.dtype), lit=node
        )

    def pred(self, e: ast.Node) -> ast.Node:
        if isinstance(e, ast.BinaryOp):
            if e.op in ("and", "or"):
                return dataclasses.replace(
                    e, left=self.pred(e.left), right=self.pred(e.right)
                )
            if e.op in _CMP_OPS:
                return dataclasses.replace(
                    e,
                    left=self.maybe_param(e.left),
                    right=self.maybe_param(e.right),
                )
            return e
        if isinstance(e, ast.UnaryOp) and e.op == "not":
            return dataclasses.replace(e, arg=self.pred(e.arg))
        if isinstance(e, ast.BetweenExpr):
            return dataclasses.replace(
                e,
                low=self.maybe_param(e.low),
                high=self.maybe_param(e.high),
            )
        if isinstance(e, ast.InList):
            return dataclasses.replace(
                e, values=tuple(self.maybe_param(v) for v in e.values)
            )
        if isinstance(e, ast.InSubquery):
            return dataclasses.replace(e, query=self.select(e.query))
        if isinstance(e, ast.Exists):
            return dataclasses.replace(e, query=self.select(e.query))
        if isinstance(e, ast.ScalarSubquery):
            return dataclasses.replace(e, query=self.select(e.query))
        return e

    def rel(self, r):
        if r is None:
            return r
        if isinstance(r, ast.SubqueryRef):
            return dataclasses.replace(r, query=self.select(r.query))
        if isinstance(r, ast.JoinRel):
            return dataclasses.replace(
                r,
                left=self.rel(r.left),
                right=self.rel(r.right),
                on=self.pred(r.on) if r.on is not None else None,
            )
        if isinstance(r, ast.UnionRel):
            return dataclasses.replace(
                r, terms=tuple(self.select(t) for t in r.terms)
            )
        return r

    def select(self, sel: ast.Select) -> ast.Select:
        return dataclasses.replace(
            sel,
            from_=self.rel(sel.from_),
            where=(
                self.pred(sel.where) if sel.where is not None else None
            ),
            having=(
                self.pred(sel.having)
                if sel.having is not None
                else None
            ),
            ctes=tuple(
                (name, self.select(q)) for name, q in sel.ctes
            ),
        )


def canonicalize_statement(
    stmt: ast.Select, session
) -> Tuple[str, ast.Select, List[E.Literal]]:
    """-> (cache key, canonical statement, hoisted values by ordinal).
    The key is the canonical AST's repr — BoundParam prints its ordinal
    and dtype but never its value — prefixed with the session's
    catalog/schema (name resolution depends on them). Non-hoisted
    literals keep their values in the repr, so variance there simply
    keys separate entries (correct, just less sharing)."""
    c = _AstCanon()
    canon = c.select(stmt)
    key = f"{session.catalog}|{session.schema}|{canon!r}"
    return key, canon, c.values


# ----------------------------------------------------------- the plan cache


@dataclasses.dataclass
class PlanCacheEntry:
    root: N.PlanNode
    params: list
    output_names: tuple
    preoptimized: bool
    handles: frozenset
    n_slots: int
    #: adaptive execution (epoch-versioned entries): the history
    #: evidence this plan's optimization consulted — node fingerprint
    #: -> {"epoch", "rows", "est"} captured by
    #: plan/history.capture_consults around planning. A later hit
    #: re-validates against it (:func:`stale_consults`); empty = the
    #: entry can never go stale (no history was consulted).
    consulted: dict = dataclasses.field(default_factory=dict)


def stale_consults(consulted: dict, store, factor: float):
    """The statement-cache REPLAN seam's divergence test (adaptive
    execution — the one place a cached plan is judged stale; audited
    consumer: exec/local_runner._adaptive_replan).

    -> ``(fp, captured_epoch, current_epoch)`` of the first consulted
    node whose learned cardinality has since MATERIALLY diverged from
    the estimate this plan was built on, else None. The epoch
    comparison is the cheap pre-filter (epochs bump only on material
    change — plan/history.record_query) — valid only when the
    caller's factor is at least the STORE's bump factor; a tighter
    session factor falls through to the full per-node judgement, so
    ``adaptive_divergence_factor=2`` still replans on drift the
    store's 4x epochs never flagged. The captured estimate (the
    learned rows at consult time, or the classic fallback on a miss)
    is what the fresh learned value is judged against, so an epoch
    bump that lands back NEAR the plan's own assumptions keeps the
    plan. Never raises — staleness checking must not fail a query."""
    from presto_tpu_torch.plan import history

    epoch_gated = factor >= getattr(store, "divergence_factor", 1.0)
    for fp, cap in (consulted or {}).items():
        try:
            cur_epoch = store.epoch_of(fp)
            if epoch_gated and cur_epoch == cap.get("epoch", 0):
                continue
            learned = store.learned_rows(fp)
            base = cap.get("rows")
            if base is None:
                base = cap.get("est")
            if learned is None or base is None:
                continue
            if history.diverged(base, learned, factor):
                return fp, cap.get("epoch", 0), cur_epoch
        except Exception:
            continue
    return None


#: sentinel: this canonical shape could not be planned in parameterized
#: form (a hoisted literal sat in a structural position) — plan it with
#: literals in place, forever, without re-paying the failed attempt
BYPASS = object()


class PlanCache:
    """Bounded LRU of parameterized plans keyed on canonical statement
    form (tier-1 ``plan.cache-entries``), with write-path invalidation
    by table handle — riding the same hooks as the split cache, because
    a DROP/recreate can change the schema a cached plan was resolved
    against."""

    def __init__(self, entries: int = 256):
        self._entries = max(int(entries), 0)
        self._lock = threading.Lock()
        self._od: "OrderedDict[str, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        #: adaptive execution: hits whose entry was judged stale
        #: (stale_consults) and replaced by a fresh plan
        self.replans = 0

    def resize(self, entries: int) -> None:
        with self._lock:
            self._entries = max(int(entries), 0)
            self._shrink()

    def _shrink(self) -> None:
        from presto_tpu_torch.utils.metrics import REGISTRY

        while len(self._od) > self._entries:
            self._od.popitem(last=False)
            self.evictions += 1
            REGISTRY.counter("plan.cache_evict").update()

    def get(self, key: str):
        """-> PlanCacheEntry | BYPASS | None, counting hit/miss (a
        BYPASS lookup counts as a miss: the caller plans fresh)."""
        from presto_tpu_torch.utils.metrics import REGISTRY

        with self._lock:
            e = self._od.get(key)
            if isinstance(e, PlanCacheEntry):
                self._od.move_to_end(key)
                self.hits += 1
                REGISTRY.counter("plan.cache_hit").update()
                return e
            self.misses += 1
            REGISTRY.counter("plan.cache_miss").update()
            return e

    def put(self, key: str, entry) -> None:
        with self._lock:
            self._od[key] = entry
            self._od.move_to_end(key)
            self._shrink()

    def note_replan(self) -> None:
        """Count one adaptive replan under the cache lock (like every
        other counter here — concurrent stale hits must not lose
        updates against the stats row)."""
        with self._lock:
            self.replans += 1

    def invalidate(self, handle) -> None:
        # version-blind match: a cached plan pins a SNAPSHOT of its
        # tables (planner pin_snapshot), and a write/commit must drop
        # plans planned against any version of the written table
        tk = handle.table_key
        with self._lock:
            dead = [
                k
                for k, e in self._od.items()
                if isinstance(e, PlanCacheEntry)
                and any(h.table_key == tk for h in e.handles)
            ]
            for k in dead:
                del self._od[k]

    def clear(self) -> None:
        with self._lock:
            self._od.clear()

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": sum(
                    1
                    for e in self._od.values()
                    if isinstance(e, PlanCacheEntry)
                ),
                "capacity": self._entries,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "replans": self.replans,
            }


def plan_handles(plan) -> frozenset:
    """Every TableHandle a plan (incl. scalar-subquery subplans)
    scans — the invalidation index of its cache entry."""
    out = set()

    def add_root(root):
        for n in N.walk(root):
            if isinstance(n, N.TableScanNode):
                out.add(n.handle)

    add_root(plan.root)
    for _pid, sub in plan.params:
        for h in plan_handles(sub):
            out.add(h)
    return frozenset(out)

"""Analyzer + logical planner: parse tree -> typed PlanNode tree.

Reference parity: ``StatementAnalyzer``/``ExpressionAnalyzer`` (name and
type resolution, SURVEY.md §2.1 "Analyzer") fused with ``LogicalPlanner``
/ ``RelationPlanner`` / ``QueryPlanner`` (SURVEY.md §2.1 "Logical
planner"), including the subquery rewrites the reference does in its
optimizer (ApplyNode decorrelation):

- IN (subquery)      -> semi join        (NOT IN -> NULL-AWARE anti
                        join: two bound count params + a probe-side
                        pre-filter give exact three-valued NOT IN
                        semantics — see _null_aware_prefilter)
- EXISTS             -> semi/anti join on equality correlation conjuncts
- scalar subquery    -> uncorrelated: Param bound by the executor;
                        correlated: GROUP BY correlation keys + join
                        (the classic Q2/Q17 decorrelation)
- count(DISTINCT x)  -> two-level aggregation (distinct then count)

Join planning collects relations + equi-conjuncts into a join graph and
orders greedily by connector stats (largest relation stays the probe
backbone, smallest connected relation builds next) — the round-1 stand-in
for the reference's cost-based ReorderJoins + AddExchanges distribution
choice (SURVEY.md §2.1 "Optimizer").
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, List, Optional, Sequence, Set, Tuple

from presto_tpu_torch import types as T
from presto_tpu_torch import expr as E
from presto_tpu_torch import functions
from presto_tpu_torch.connectors.spi import Connector, TableHandle
from presto_tpu_torch.exec.staging import bucket_capacity
from presto_tpu_torch.ops.aggregation import AggCall
from presto_tpu_torch.ops.sort import SortKey
from presto_tpu_torch.ops.window import WindowCall
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.session import Session
from presto_tpu_torch.sql import ast


class PlanningError(ValueError):
    pass


@dataclasses.dataclass
class Plan:
    """Root plan + scalar-subquery subplans to bind (param_id -> plan).

    A plan served from the statement-level plan cache
    (plan/canonical.py) additionally carries ``bound_values`` — the
    current execution's literal values by RuntimeParam ordinal — and
    ``preoptimized`` marks a cached root that already went through
    prune_columns + push_scan_constraints (both are value-independent
    over a canonical root, so re-running them per execution would be
    planning work the cache exists to skip)."""

    root: N.PlanNode
    params: List[Tuple[int, "Plan"]]
    output_names: Tuple[str, ...]
    bound_values: Optional[Dict[int, "E.Literal"]] = None
    preoptimized: bool = False


_AMBIGUOUS = object()


class Scope:
    """Name resolution environment (reference: analyzer Scope).

    ``columns`` maps *internal* (plan) column names to types; internal
    names are globally unique within a query (self-joined tables get
    renamed via projections). ``qualifiers`` maps relation alias ->
    {visible name -> internal name}. Unqualified lookup goes through the
    visible map, where duplicated visible names are poisoned as
    ambiguous (resolvable only via their alias, per SQL)."""

    def __init__(
        self,
        columns: Dict[str, T.DataType],
        qualifiers: Optional[Dict[str, Dict[str, str]]] = None,
        parent: Optional["Scope"] = None,
    ):
        self.columns = dict(columns)
        self.qualifiers = {
            k: dict(v) for k, v in (qualifiers or {}).items()
        }
        self.parent = parent
        self.visible: Dict[str, object] = {}
        if self.qualifiers:
            for m in self.qualifiers.values():
                for vis, internal in m.items():
                    if vis in self.visible and self.visible[vis] != internal:
                        self.visible[vis] = _AMBIGUOUS
                    else:
                        self.visible[vis] = internal
            for c in self.columns:  # columns not owned by any alias
                if not any(c in m.values() for m in self.qualifiers.values()):
                    self.visible.setdefault(c, c)
        else:
            self.visible = {c: c for c in self.columns}

    def merge(self, other: "Scope") -> "Scope":
        clash = set(self.columns) & set(other.columns)
        if clash:
            raise PlanningError(
                f"internal column clash (planner bug): {sorted(clash)}"
            )
        cols = {**self.columns, **other.columns}
        quals = {k: dict(v) for k, v in self.qualifiers.items()}
        for q, m in other.qualifiers.items():
            if q in quals:
                raise PlanningError(f"duplicate relation alias: {q}")
            quals[q] = dict(m)
        s = Scope(cols, quals, self.parent)
        return s

    def resolve(self, parts: Tuple[str, ...]):
        """-> (internal name, dtype, is_outer)."""
        if len(parts) == 1:
            name = parts[0]
            got = self.visible.get(name)
            if got is _AMBIGUOUS:
                raise PlanningError(f"ambiguous column name: {name}")
            if got is not None:
                return got, self.columns[got], False
        elif len(parts) == 2:
            qual, name = parts
            m = self.qualifiers.get(qual)
            if m is not None and name in m:
                internal = m[name]
                return internal, self.columns[internal], False
        if self.parent is not None:
            n, t, _ = self.parent.resolve(parts)
            return n, t, True
        raise PlanningError(f"column not found: {'.'.join(parts)}")


# Aggregate and window builtins resolve through the declarative
# registry (presto_tpu.functions.AGGREGATE / .WINDOW) — the reference's
# FunctionAndTypeManager seam. Adding an aggregate or window function
# touches only functions.py (and, for new KERNEL accumulators, the
# ops kernel); the planner has no builtin name lists of its own.


def plan_statement(
    stmt: ast.Node, catalogs, session: Session
) -> Plan:
    return _Planner(catalogs, session).plan(stmt)


class _Planner:
    def __init__(self, catalogs, session: Session):
        self.catalogs = catalogs
        self.session = session
        self.ctes: Dict[str, ast.Select] = {}
        self._param_counter = [0]
        self.params: List[Tuple[int, Plan]] = []
        self._name_counter = [0]

    def _fresh(self, prefix: str) -> str:
        self._name_counter[0] += 1
        return f"${prefix}_{self._name_counter[0]}"

    # ------------------------------------------------------------ top level

    def plan(self, stmt: ast.Node) -> Plan:
        if not isinstance(stmt, ast.Select):
            raise PlanningError(f"cannot plan {type(stmt).__name__}")
        node, scope, names = self.plan_select(stmt, outer=None)
        return Plan(root=node, params=self.params, output_names=names)

    # ---------------------------------------------------------- SELECT core

    def plan_select(
        self, sel: ast.Select, outer: Optional[Scope]
    ) -> Tuple[N.PlanNode, Scope, Tuple[str, ...]]:
        from presto_tpu_torch.sql.grouping_sets import (
            desugar_select,
            has_grouping_sets,
        )

        if has_grouping_sets(sel):
            try:
                sel = desugar_select(sel)
            except ValueError as e:
                raise PlanningError(str(e))
        saved_ctes = dict(self.ctes)
        for name, q in sel.ctes:
            self.ctes[name] = q
        try:
            return self._plan_select_body(sel, outer)
        finally:
            self.ctes = saved_ctes

    def _plan_select_body(self, sel: ast.Select, outer):
        # 1. FROM -> relations + equi-edge pool; LEFT joins defer so
        # the probe spine's pool sees WHERE equi-edges first
        pending_on: List[ast.Node] = []
        deferred: List[Tuple[ast.Node, Optional[ast.Node]]] = []
        node, scope = self._plan_from(
            sel.from_, outer,
            pending_out=pending_on,
            deferred_out=deferred,
        )

        # 2. WHERE + JOIN..ON conjuncts in ONE application, so the
        # join pool sees the full equi-edge set at once. With deferred
        # LEFT joins, conjuncts that resolve against the probe scope
        # push down (preserved-side pushdown); the rest — anything
        # touching a deferred build column (`p_promo_sk is null`) —
        # apply after those joins attach.
        conjs = list(pending_on)
        if sel.where is not None:
            conjs.extend(_split_conjuncts(sel.where))
        if deferred:
            probe_conjs, post_conjs = [], []
            for c in conjs:
                # subquery-bearing conjuncts go post unconditionally:
                # _resolvable_in skips nested Select bodies, so a
                # subquery correlated to a deferred build column would
                # otherwise misclassify as probe-pushable; applying
                # after the joins is always the plain WHERE semantics
                (
                    probe_conjs
                    if not _contains_select(c)
                    and self._resolvable_in(c, scope)
                    else post_conjs
                ).append(c)
        else:
            probe_conjs, post_conjs = conjs, []

        def _and_all(cs):
            combined = None
            for c in cs:
                combined = (
                    c if combined is None
                    else ast.BinaryOp("and", combined, c)
                )
            return combined

        combined = _and_all(probe_conjs)
        if combined is not None:
            node, scope = self._apply_where(node, scope, combined)
        node = self._finalize_pool(node, scope)
        for right_rel, on_ast in deferred:
            right_node, right_scope = self._plan_join_child(
                right_rel, outer
            )
            node, scope = self._outer_join_construct(
                node, scope, right_node, right_scope, "left", on_ast
            )
        post = _and_all(post_conjs)
        if post is not None:
            node, scope = self._apply_where(node, scope, post)

        # 3. aggregation / grouping
        agg_map: Dict[ast.Node, str] = {}
        has_agg = any(
            self._contains_agg(it.expr) for it in sel.items
        ) or (sel.having is not None) or bool(sel.group_by)

        if has_agg:
            node, scope, agg_map = self._plan_aggregation(node, scope, sel)

        # 4. window functions
        win_map: Dict[ast.Node, str] = {}
        if any(self._contains_window(it.expr) for it in sel.items):
            node, scope, win_map = self._plan_windows(
                node, scope, sel, agg_map
            )

        # 5. select items -> output projection
        out_names: List[str] = []
        projections: List[Tuple[str, E.Expr]] = []
        for i, item in enumerate(sel.items):
            if isinstance(item.expr, ast.Star):
                qual = item.expr.qualifier
                for name in scope.columns:
                    if name.startswith("$"):
                        continue
                    if qual is not None and name not in scope.qualifiers.get(
                        qual, ()
                    ):
                        continue
                    projections.append(
                        (name, E.ColumnRef(name, scope.columns[name]))
                    )
                    out_names.append(name)
                continue
            e = self._lower(item.expr, scope, agg_map=agg_map, win_map=win_map)
            name = item.alias or self._item_name(item.expr, i)
            projections.append((name, e))
            out_names.append(name)
        # ORDER BY may reference source columns not in the projection —
        # carry them through and slice at output
        order_extra: List[Tuple[str, E.Expr]] = []
        sort_keys: List[SortKey] = []
        if sel.order_by:
            proj_names = {n for n, _ in projections}
            alias_types = {n: e.dtype for n, e in projections}
            for si in sel.order_by:
                key_expr = self._lower_order_key(
                    si.expr, scope, projections, agg_map, win_map
                )
                if isinstance(key_expr, str):  # projection alias reference
                    k = E.ColumnRef(key_expr, alias_types[key_expr])
                else:
                    nm = self._fresh("sort")
                    order_extra.append((nm, key_expr))
                    k = E.ColumnRef(nm, key_expr.dtype)
                if k.dtype.is_nested:
                    raise PlanningError(
                        f"ORDER BY a {k.dtype.name} column is not "
                        "supported"
                    )
                sort_keys.append(
                    SortKey(k, si.descending, si.nulls_first)
                )

        node = N.ProjectNode(node, tuple(projections + order_extra))

        if sel.distinct:
            node = N.DistinctNode(node)

        if sort_keys:
            node = N.SortNode(node, tuple(sort_keys), limit=sel.limit)
        elif sel.limit is not None:
            node = N.LimitNode(node, sel.limit)

        uniq_out = []
        seen = {}
        for n in out_names:
            if n in seen:  # duplicate output names allowed in SQL
                seen[n] += 1
                uniq_out.append((f"{n}_{seen[n]}", n))
            else:
                seen[n] = 0
                uniq_out.append((n, n))
        node = N.OutputNode(node, tuple(uniq_out))
        out_scope = Scope(
            {o: node.output_schema()[o] for o, _ in uniq_out}, {}
        )
        return node, out_scope, tuple(o for o, _ in uniq_out)

    def _const_int(self, e: ast.Node, what: str) -> int:
        lowered = self._lower(e, Scope({}, {}))
        if not isinstance(lowered, E.Literal) or not isinstance(
            lowered.value, int
        ):
            raise PlanningError(f"{what} must be an integer constant")
        return int(lowered.value)

    def _item_name(self, e: ast.Node, i: int) -> str:
        if isinstance(e, ast.Ident):
            return e.parts[-1]
        return f"_col{i}"

    # -------------------------------------------------------------- FROM

    def _plan_from(self, from_, outer, pending_out=None, deferred_out=None):
        """Plan a FROM clause. With ``pending_out`` (a list), ON
        conjuncts of flattened inner joins are APPENDED to it and the
        returned node may be a _PendingJoin — the caller combines them
        with its WHERE so the join pool sees every equi-edge at once
        (one-at-a-time application resolved the pool on the FIRST
        conjunct's edges alone, degrading explicit JOIN..ON chains to
        cross joins + filters). Without it, conjuncts apply here."""
        if from_ is None:
            return N.ValuesNode(), Scope({}, {}, outer)
        rels: List[Tuple[N.PlanNode, Scope]] = []
        structured: List[Tuple[str, ast.Node]] = []  # outer joins

        def flatten(rel):
            if isinstance(rel, ast.JoinRel):
                if rel.join_type in ("cross", "inner"):
                    flatten(rel.left)
                    right_start = len(rels)
                    flatten(rel.right)
                    if rel.on is not None:
                        structured.append(("on", rel.on))
                    return
                # left/right outer joins keep structure
                structured.append(("outer", rel))
                return
            node, scope = self._plan_relation(rel, outer)
            rels.append((node, scope))

        outer_joins: List[ast.JoinRel] = []

        pending_unnests: List[ast.UnnestRef] = []

        def flatten2(rel):
            if isinstance(rel, ast.JoinRel) and rel.join_type in (
                "cross",
                "inner",
            ):
                flatten2(rel.left)
                flatten2(rel.right)
                if rel.on is not None:
                    self._pending_conjuncts.append(rel.on)
                return
            if isinstance(rel, ast.JoinRel):
                if deferred_out is not None and rel.join_type == "left":
                    # defer the LEFT join: flatten its probe spine into
                    # the pool so WHERE equi-edges join it (Q72's week
                    # link), and attach the preserved-side build AFTER
                    # pool resolution — probe-side filters before a
                    # left join are the standard safe pushdown
                    flatten2(rel.left)
                    deferred_out.append((rel.right, rel.on))
                    return
                # plan the outer join as a unit
                node, scope = self._plan_outer_join(rel, outer)
                rels.append((node, scope))
                return
            if isinstance(rel, ast.UnnestRef):
                # lateral: element exprs reference sibling relations, so
                # unnests apply after the join graph is assembled
                pending_unnests.append(rel)
                return
            node, scope = self._plan_relation(rel, outer)
            rels.append((node, scope))

        self._pending_conjuncts: List[ast.Node] = []
        flatten2(from_)

        if not rels:
            # FROM unnest(...) with no other relation
            rels = [(N.ValuesNode(), Scope({}, {}, outer))]

        rels = self._rename_clashes(rels)
        scope = rels[0][1]
        for _, s in rels[1:]:
            scope = scope.merge(s)
        scope.parent = outer

        if len(rels) == 1:
            node = rels[0][0]
        else:
            node = self._join_graph(rels, scope)
        # ON conjuncts of flattened inner joins -> WHERE-style
        # application. Applied BEFORE unnests: ON clauses cannot
        # reference unnest columns (unnest joins are CROSS), and the
        # join pool must see its edges before any unnest caps it.
        pending = self._pending_conjuncts
        self._pending_conjuncts = []
        if pending_out is not None and not pending_unnests:
            # defer: the caller merges these with its WHERE so the
            # pool resolves with the full edge set
            pending_out.extend(pending)
            return node, scope
        if pending:
            combined = pending[0]
            for c in pending[1:]:
                combined = ast.BinaryOp("and", combined, c)
            node, scope = self._apply_where(node, scope, combined)
        for u in pending_unnests:
            node, scope = self._apply_unnest(node, scope, u)
        return node, scope

    def _apply_unnest(self, node, scope: Scope, u: ast.UnnestRef):
        """CROSS JOIN UNNEST(ARRAY[...]) — static-width row expansion
        (see N.UnnestNode). Arrays exist at trace time as expression
        lists; physical array COLUMNS take the column form (per-row
        length expansion under the capacity-bucket protocol)."""
        if isinstance(node, _PendingJoin):
            node = self._finalize_pool(node, scope)
        array_column = None
        els: List[E.Expr] = []
        if isinstance(u.array, ast.ArrayLit):
            if not u.array.items:
                raise PlanningError(
                    "UNNEST of empty ARRAY[] is not supported"
                )
            els = [self._lower(it, scope) for it in u.array.items]
            ct = els[0].dtype
            for el in els[1:]:
                ct = T.common_super_type(ct, el.dtype)
            els = [
                el if el.dtype == ct else E.Cast(el, ct) for el in els
            ]
        else:
            arr = self._lower(u.array, scope)
            if not (
                isinstance(arr, E.ColumnRef) and arr.dtype.is_array
            ):
                raise PlanningError(
                    "UNNEST requires an ARRAY[...] constructor or a "
                    "physical array column"
                )
            array_column = arr.name
            ct = arr.dtype.element
        cols = dict(scope.columns)
        out_internal = (
            u.column if u.column not in cols else self._fresh(u.column)
        )
        cols[out_internal] = ct
        qual = {u.column: out_internal}
        ord_internal = None
        if u.ordinality is not None:
            ord_internal = (
                u.ordinality
                if u.ordinality not in cols
                else self._fresh(u.ordinality)
            )
            cols[ord_internal] = T.BIGINT
            qual[u.ordinality] = ord_internal
        out_cap = None
        if array_column is not None:
            # output bucket: no array-length stats exist, so start at
            # 4x the input estimate; overflow retries scale it
            est = optimizer.estimate_rows(node, self.catalogs)
            out_cap = bucket_capacity(int(est * 4) + 1024)
        node = N.UnnestNode(
            source=node,
            elements=tuple(els),
            out_name=out_internal,
            out_type=ct,
            ordinality_name=ord_internal,
            array_column=array_column,
            out_capacity=out_cap,
        )
        quals = {
            k: dict(v) for k, v in scope.qualifiers.items()
        }
        quals[u.alias] = qual
        return node, Scope(cols, quals, scope.parent)

    def _rename_clashes(self, rels):
        """Self-joined relations expose the same internal column names;
        rename the later relation's clashed columns via a projection so
        plan-level names stay globally unique (alias-qualified lookups
        keep working through the scope's visible-name maps)."""
        seen: Set[str] = set()
        out = []
        for node, s in rels:
            clash = set(s.columns) & seen
            if clash:
                rename = {c: self._fresh(c) for c in clash}
                projs = tuple(
                    (rename.get(c, c), E.ColumnRef(c, t))
                    for c, t in s.columns.items()
                )
                node = N.ProjectNode(node, projs)
                cols = {rename.get(c, c): t for c, t in s.columns.items()}
                quals = {
                    q: {vis: rename.get(i, i) for vis, i in m.items()}
                    for q, m in s.qualifiers.items()
                }
                s = Scope(cols, quals, s.parent)
            seen |= set(s.columns)
            out.append((node, s))
        return out

    def _plan_relation(self, rel, outer):
        if isinstance(rel, ast.TableRef):
            name = rel.parts[-1]
            if len(rel.parts) == 1 and name in self.ctes:
                node, scope, names = self.plan_select(self.ctes[name], outer)
                qual = rel.alias or name
                return node, Scope(
                    dict(node.output_schema()),
                    {qual: {n: n for n in names}},
                    outer,
                )
            catalog = self.session.catalog
            schema = self.session.schema
            if len(rel.parts) == 2:
                schema = rel.parts[0]
            elif len(rel.parts) == 3:
                catalog, schema = rel.parts[0], rel.parts[1]
            handle = TableHandle(catalog, schema, name)
            conn = self.catalogs.get(catalog)
            if rel.version is not None:
                # FOR VERSION AS OF: construct the handle already
                # pinned — pin_snapshot then VALIDATES the id against
                # the connector's committed history (KeyError for an
                # unknown snapshot) instead of picking the tip. A
                # connector without snapshot support inherits the
                # default pin_snapshot, which ignores the pin and
                # would silently serve live rows — reject it here.
                handle = dataclasses.replace(
                    handle, snapshot=rel.version
                )
                if type(conn).pin_snapshot is Connector.pin_snapshot:
                    raise PlanningError(
                        f"catalog {catalog!r} does not support "
                        "FOR VERSION AS OF"
                    )
                try:
                    handle = conn.pin_snapshot(handle)
                except KeyError as e:
                    raise PlanningError(str(e.args[0]) if e.args else str(e))
            else:
                # snapshot-capable connectors (streaming ingest) pin
                # the scan to the tip committed version HERE, once per
                # plan: every split, staged page, and capacity retry
                # then reads one immutable prefix — readers never see
                # a torn batch, and long scans are isolated from
                # concurrent commits. Default connectors return the
                # handle unchanged.
                handle = conn.pin_snapshot(handle)
            tschema = conn.metadata().get_table_schema(handle)
            node = N.TableScanNode(
                handle=handle,
                columns=tuple(tschema),
                schema=tuple(tschema.items()),
            )
            qual = rel.alias or name
            return node, Scope(
                tschema, {qual: {c: c for c in tschema}}, outer
            )
        if isinstance(rel, ast.SubqueryRef):
            node, scope, names = self.plan_select(rel.query, outer)
            return node, Scope(
                dict(node.output_schema()),
                {rel.alias: {n: n for n in names}},
                outer,
            )
        if isinstance(rel, ast.UnionRel):
            return self._plan_union(rel, outer)
        if isinstance(rel, ast.ValuesRel):
            return self._plan_values(rel, outer)
        raise PlanningError(f"unsupported relation {type(rel).__name__}")

    def _plan_values(self, rel: ast.ValuesRel, outer):
        """(VALUES ...) AS t(c1, ...): an inline table as a UNION ALL
        of single-row literal projections over the FROM-less relation
        (reference: Values query body) — zero new executor surface."""
        if not rel.rows:
            raise PlanningError("VALUES requires at least one row")
        arity = len(rel.rows[0])
        for row in rel.rows:
            if len(row) != arity:
                raise PlanningError(
                    "VALUES rows must have equal arity "
                    f"({arity} vs {len(row)})"
                )
        if rel.column_names and len(rel.column_names) != arity:
            raise PlanningError(
                f"VALUES alias declares {len(rel.column_names)} "
                f"columns for {arity}-column rows"
            )
        empty = Scope({}, {}, None)
        lowered = [
            [self._lower(e, empty) for e in row] for row in rel.rows
        ]
        types = []
        for i in range(arity):
            ct = lowered[0][i].dtype
            for row in lowered[1:]:
                # typed NULLs coerce toward the non-null type
                if isinstance(row[i], E.Literal) and row[i].value is None:
                    continue
                if isinstance(lowered[0][i], E.Literal) and (
                    lowered[0][i].value is None
                ):
                    ct = row[i].dtype
                    continue
                ct = T.common_super_type(ct, row[i].dtype)
            if ct.is_long_decimal:
                # the bigint/decimal lattice widens mixed integer +
                # decimal literals past p=18; VALUES literals always
                # fit the short form
                ct = T.decimal(18, ct.scale)
            types.append(ct)
        visible = tuple(rel.column_names) or tuple(
            f"_col{i}" for i in range(arity)
        )
        internal = tuple(self._fresh(v.lstrip("$")) for v in visible)
        row_nodes = []
        for row in lowered:
            projs = []
            for i, e in enumerate(row):
                if isinstance(e, E.Literal) and e.value is None:
                    e = E.Literal(None, types[i])
                elif e.dtype != types[i]:
                    e = (
                        _coerce_literal(e, types[i])
                        if isinstance(e, E.Literal)
                        and not types[i].is_string
                        else E.Cast(e, types[i])
                    )
                projs.append((internal[i], e))
            row_nodes.append(
                N.ProjectNode(source=N.ValuesNode(), projections=tuple(projs))
            )
        node = (
            row_nodes[0]
            if len(row_nodes) == 1
            else N.UnionAllNode(sources=tuple(row_nodes))
        )
        scope = Scope(
            {n: t for n, t in zip(internal, types)},
            {rel.alias: dict(zip(visible, internal))},
            outer,
        )
        return node, scope

    def _plan_union(self, rel: ast.UnionRel, outer):
        """Set operations (reference: UNION [ALL] via UnionNode +
        SetOperationNode rewrites): plan each term, align columns
        POSITIONALLY to the first term's names and the common super
        types (projection + cast per term), concatenate with
        UnionAllNode, and fold a DistinctNode after every non-ALL op
        (left-associative, standard semantics)."""
        planned = []
        for t in rel.terms:
            node, _, names = self.plan_select(t, outer=outer)
            planned.append((node, names))
        arity = len(planned[0][1])
        for node, names in planned[1:]:
            if len(names) != arity:
                raise PlanningError(
                    "UNION terms must have the same number of columns "
                    f"({arity} vs {len(names)})"
                )
        # common types per position. A term column that is a bare NULL
        # literal (reference: UNKNOWN type coercing to anything) does
        # not vote — it adopts the other terms' type; the grouping-sets
        # desugar emits exactly this shape for absent group columns
        def _null_literal_expr(node, name):
            while isinstance(node, N.OutputNode):
                name = dict(node.columns).get(name, name)
                node = node.source
            if isinstance(node, N.ProjectNode):
                e = dict(node.projections).get(name)
                if isinstance(e, E.Literal) and e.value is None:
                    return e
            return None

        types = []
        for i in range(arity):
            ct = None
            for node, names in planned:
                if _null_literal_expr(node, names[i]) is not None:
                    continue
                t_i = node.output_schema()[names[i]]
                ct = t_i if ct is None else T.common_super_type(ct, t_i)
            types.append(ct if ct is not None else T.BIGINT)
        # canonical output names: the first term's visible names
        # (de-duplicated — they become this relation's columns)
        out_names: List[str] = []
        seen: Set[str] = set()
        for n in planned[0][1]:
            nm = n if n not in seen else self._fresh(n.lstrip("$"))
            seen.add(nm)
            out_names.append(nm)
        aligned = []
        for node, names in planned:
            schema = node.output_schema()
            projs = []
            for i, out in enumerate(out_names):
                if (
                    _null_literal_expr(node, names[i]) is not None
                    and schema[names[i]] != types[i]
                ):
                    # retype the NULL in place — no runtime cast kernel
                    projs.append((out, E.Literal(None, types[i])))
                    continue
                src = E.ColumnRef(names[i], schema[names[i]])
                e = src if src.dtype == types[i] else E.Cast(
                    src, types[i]
                )
                projs.append((out, e))
            aligned.append(N.ProjectNode(node, tuple(projs)))
        cur = aligned[0]
        for node, op in zip(aligned[1:], rel.ops):
            if op in ("union_all", "union"):
                cur = N.UnionAllNode(sources=(cur, node))
                if op == "union":
                    cur = N.DistinctNode(
                        source=cur, max_groups=self._agg_bucket(cur)
                    )
            else:  # intersect | except (DISTINCT semantics)
                cur = self._set_difference(
                    cur, node, out_names, types, keep_both=(op == "intersect")
                )
        scope = Scope(
            {n: t for n, t in zip(out_names, types)}, {}, outer
        )
        return cur, scope

    def _set_difference(self, left, right, out_names, types, keep_both):
        """INTERSECT / EXCEPT (DISTINCT semantics) without a dedicated
        kernel: tag each side, UNION ALL (which re-encodes string
        columns into ONE dictionary, making all-column grouping valid),
        group by every output column tracking per-side presence, and
        keep groups present on both sides (INTERSECT) or only the left
        (EXCEPT) — the reference's SetOperationNode-to-aggregation
        rewrite, TPU-first over the existing union + sorted-agg
        kernels."""
        tag = self._fresh("setop")
        tagged = []
        for node, tag_val in ((left, 1), (right, 2)):
            schema = node.output_schema()
            tagged.append(
                N.ProjectNode(
                    source=node,
                    projections=tuple(
                        (n, E.ColumnRef(n, schema[n])) for n in out_names
                    )
                    + ((tag, E.Literal(tag_val, T.INTEGER)),),
                )
            )
        u = N.UnionAllNode(sources=tuple(tagged))
        tag_ref = E.ColumnRef(tag, T.INTEGER)
        lo, hi = self._fresh("tagmin"), self._fresh("tagmax")
        agg = N.AggregationNode(
            source=u,
            group_keys=tuple(
                (n, E.ColumnRef(n, t))
                for n, t in zip(out_names, types)
            ),
            aggs=(
                AggCall("min", tag_ref, lo),
                AggCall("max", tag_ref, hi),
            ),
            max_groups=self._agg_bucket(u),
        )
        # tags are 1 (left) / 2 (right): INTERSECT keeps groups seen on
        # both sides (min=1 AND max=2); EXCEPT keeps left-only (max=1)
        if keep_both:
            pred: E.Expr = E.And(
                (
                    E.Compare(
                        "=", E.ColumnRef(lo, T.INTEGER),
                        E.Literal(1, T.INTEGER),
                    ),
                    E.Compare(
                        "=", E.ColumnRef(hi, T.INTEGER),
                        E.Literal(2, T.INTEGER),
                    ),
                )
            )
        else:
            pred = E.Compare(
                "=", E.ColumnRef(hi, T.INTEGER), E.Literal(1, T.INTEGER)
            )
        filtered = N.FilterNode(source=agg, predicate=pred)
        return N.ProjectNode(
            source=filtered,
            projections=tuple(
                (n, E.ColumnRef(n, t))
                for n, t in zip(out_names, types)
            ),
        )

    def _plan_join_child(self, rel, outer):
        """One side of an outer join: a leaf relation, a nested outer
        join, or an INNER/CROSS JoinRel chain (the Q72 shape `a join b
        on ... left join c`) planned through the flatten machinery —
        saving the in-flight conjunct state the nested _plan_from call
        would otherwise clobber."""
        if isinstance(rel, ast.JoinRel):
            if rel.join_type in ("cross", "inner"):
                saved = self._pending_conjuncts
                try:
                    node, scope = self._plan_from(rel, outer)
                finally:
                    self._pending_conjuncts = saved
                if isinstance(node, _PendingJoin):
                    node = self._finalize_pool(node, scope)
                return node, scope
            return self._plan_outer_join(rel, outer)
        return self._plan_relation(rel, outer)

    def _plan_outer_join(self, rel: ast.JoinRel, outer):
        jt = rel.join_type
        left_node, left_scope = self._plan_join_child(rel.left, outer)
        right_node, right_scope = self._plan_join_child(
            rel.right, outer
        )
        if jt == "right":  # normalize: probe side is preserved side
            left_node, right_node = right_node, left_node
            left_scope, right_scope = right_scope, left_scope
            jt = "left"
        if jt not in ("left", "full"):
            raise PlanningError(f"unsupported join type: {rel.join_type}")
        return self._outer_join_construct(
            left_node, left_scope, right_node, right_scope, jt, rel.on
        )

    def _outer_join_construct(
        self, left_node, left_scope, right_node, right_scope, jt, on
    ):
        """Build the LEFT/FULL JoinNode given both planned sides — the
        shared tail of _plan_outer_join and the deferred-outer-join
        path (probe side resolved first so WHERE equi-edges join its
        pool)."""
        (left_node, left_scope), (right_node, right_scope) = (
            self._rename_clashes(
                [(left_node, left_scope), (right_node, right_scope)]
            )
        )
        scope = left_scope.merge(right_scope)
        conjs = _split_conjuncts(on)
        lkeys, rkeys, build_filters, residual = [], [], [], []
        for c in conjs:
            pair = self._as_equi_pair(c, left_scope, right_scope)
            if pair:
                lkeys.append(pair[0])
                rkeys.append(pair[1])
                continue
            # ON conjuncts touching only the build side restrict MATCHING
            # (not output rows): push them into the build side pre-join —
            # the Q13 `left join ... on ... and o_comment not like ...`
            # shape. Probe-side or mixed residuals on outer joins would
            # change preserved-row semantics: unsupported this round.
            try:
                build_filters.append(self._lower(c, right_scope))
                continue
            except PlanningError:
                pass
            residual.append(c)
        if residual:
            raise PlanningError(
                "LEFT JOIN ON conditions touching the probe side beyond "
                "equi keys are not supported yet"
            )
        if not lkeys:
            raise PlanningError("outer join requires at least one equi key")
        lsch = dict(left_scope.columns)
        for k in lkeys:
            if lsch[k].is_long_decimal:
                # preserved-row semantics leave no place to apply a
                # residual collision filter over the 128->64 key mix
                raise PlanningError(
                    "outer join on a long decimal (p>18) key is not "
                    "supported (documented deviation; cast to "
                    "decimal(18,s))"
                )
        if build_filters and jt == "full":
            # pushing an ON filter into the build side is only sound when
            # the build's unmatched rows are dropped (left) — a FULL join
            # preserves them, so the rewrite would change results
            raise PlanningError(
                "FULL JOIN ON conditions beyond equi keys are not "
                "supported yet"
            )
        if build_filters:
            right_node = N.FilterNode(
                right_node,
                build_filters[0]
                if len(build_filters) == 1
                else E.And(tuple(build_filters)),
            )
        payload = tuple(right_scope.columns)
        forced_unique = None
        if len(lkeys) > 2:
            # the kernel key is a 2x32-bit composite: wider outer-join
            # keys must pack bijectively (stats-allocated bit widths);
            # residual demotion is NOT available here — an outer join's
            # preserved rows leave no place to re-check demoted keys
            packed = self._pack_composite_keys(
                left_node, right_node, list(zip(lkeys, rkeys))
            )
            if packed is None:
                raise PlanningError(
                    ">2 outer-join key columns need stats-backed "
                    "bijective packing (unavailable here)"
                )
            left_node, right_node, pairs2, forced_unique = packed
            lkeys = [p[0] for p in pairs2]
            rkeys = [p[1] for p in pairs2]
        unique = (
            forced_unique
            if forced_unique is not None
            else optimizer.is_build_unique(
                right_node, tuple(rkeys), self.catalogs
            )
        )
        out_cap = None
        if not unique:
            probe_est = optimizer.estimate_rows(left_node, self.catalogs)
            build_est = optimizer.estimate_rows(right_node, self.catalogs)
            out_cap = bucket_capacity(
                int(max(probe_est, build_est) * 4) + 1024
            )
        node = N.JoinNode(
            left=left_node,
            right=right_node,
            join_type=jt,
            left_keys=tuple(lkeys),
            right_keys=tuple(rkeys),
            payload=payload,
            build_unique=unique,
            out_capacity=out_cap,
        )
        return node, scope

    def _as_equi_pair(self, c, left_scope, right_scope):
        if not (isinstance(c, ast.BinaryOp) and c.op == "="):
            return None
        if not (
            isinstance(c.left, ast.Ident) and isinstance(c.right, ast.Ident)
        ):
            return None
        try:
            ln, _, lo = left_scope.resolve(c.left.parts)
            rn, _, ro = right_scope.resolve(c.right.parts)
            if not lo and not ro:
                return (ln, rn)
        except PlanningError:
            pass
        try:
            ln, _, lo = left_scope.resolve(c.right.parts)
            rn, _, ro = right_scope.resolve(c.left.parts)
            if not lo and not ro:
                return (ln, rn)
        except PlanningError:
            return None
        return None

    # --------------------------------------------------------- join graph

    def _join_graph(self, rels, scope: Scope) -> N.PlanNode:
        """Defer: equi-edges arrive with WHERE/ON conjuncts; the pool is
        resolved in _apply_where (or finalized without edges)."""
        return _PendingJoin(tuple(r[0] for r in rels), tuple(r[1] for r in rels))

    # ----------------------------------------------------- WHERE / subquery

    def _apply_where(self, node, scope: Scope, where_ast) -> Tuple[N.PlanNode, Scope]:
        conjuncts = [
            f for c in _split_conjuncts(where_ast) for f in _factor_or(c)
        ]
        subq_ops = []
        plain = []
        marked = []
        for c in conjuncts:
            m = self._match_subquery_conjunct(c, scope)
            if m is not None:
                subq_ops.append(m)
            elif _contains_membership_subquery(c):
                marked.append(c)
            else:
                plain.append(c)
        if isinstance(node, _PendingJoin):
            node = self._resolve_join_pool(node, scope, plain)
        elif plain:
            preds = [self._lower(c, scope) for c in plain]
            node = N.FilterNode(
                node, preds[0] if len(preds) == 1 else E.And(tuple(preds))
            )
        for c in marked:
            node = self._finalize_pool(node, scope)
            node, scope = self._apply_mark_join_conjunct(node, scope, c)
        for op in subq_ops:
            node, scope = self._apply_subquery_op(node, scope, op)
        return node, scope

    def _apply_mark_join_conjunct(self, node, scope, c):
        """OR-embedded IN-subquery / EXISTS predicates via MARK joins
        (reference: SemiJoinNode's semiJoinOutput column): each
        subquery attaches as a LEFT join against the DISTINCT inner
        rows carrying a constant marker payload, and the predicate
        lowers with the subquery replaced by a `marker IS NOT NULL`
        test (the Q45 `zip-list OR item IN (subquery)` and Q10/Q35
        `exists(...) or exists(...)` shapes). Positive polarity only:
        under a WHERE filter, UNKNOWN and FALSE coincide, so the
        marker test is exact; a subquery under NOT would need
        three-valued null-awareness and raises instead."""

        def attach(sub, negated):
            nonlocal node, scope
            if isinstance(sub, ast.InSubquery):
                # the marker test collapses UNKNOWN to FALSE — exact
                # only for a non-negated IN in positive polarity
                if negated or sub.negate:
                    raise PlanningError(
                        "NOT IN (or IN under NOT) inside OR requires "
                        "null-aware three-valued semantics "
                        "(unsupported)"
                    )
                if self._is_correlated(sub.query, scope):
                    raise PlanningError(
                        "correlated IN under OR is not supported"
                    )
                sub_node, _, sub_names = self.plan_select(
                    sub.query, outer=None
                )
                if len(sub_names) != 1:
                    raise PlanningError(
                        "IN subquery must return one column"
                    )
                node, scope, key = self._probe_key(node, scope, sub.arg)
                if scope.columns[key].is_long_decimal:
                    raise PlanningError(
                        "IN on a long decimal (p>18) is not supported"
                    )
                outer_keys = (key,)
                right_keys = tuple(sub_names)
                build = sub_node
                invert = False
            elif isinstance(sub, ast.Exists):
                q = sub.query
                if q.group_by or q.having:
                    raise PlanningError(
                        "EXISTS with GROUP BY/HAVING under OR is not "
                        "supported"
                    )
                corr_pairs, residual_where = self._extract_correlation(
                    q, scope
                )
                if not corr_pairs:
                    raise PlanningError(
                        "uncorrelated or non-equality-correlated "
                        "EXISTS under OR is not supported"
                    )
                inner_cols = tuple(p[0] for p in corr_pairs)
                inner_sel = ast.Select(
                    items=tuple(
                        ast.SelectItem(ast.Ident((ic,)), None)
                        for ic in inner_cols
                    ),
                    from_=q.from_,
                    where=residual_where,
                    ctes=q.ctes,
                )
                build, _, right_keys = self.plan_select(
                    inner_sel, outer=None
                )
                right_keys = tuple(right_keys)
                outer_keys = tuple(p[1] for p in corr_pairs)
                # return THIS node's truth value (enclosing NOTs stay
                # in the tree and invert it); NOT EXISTS is 2-valued,
                # so inverting the marker is exact
                invert = sub.negate
            else:
                raise PlanningError(
                    "unsupported subquery shape under OR"
                )
            for k in outer_keys:
                if scope.columns[k].is_long_decimal:
                    raise PlanningError(
                        "mark join on a long decimal key is not "
                        "supported"
                    )
            marker = self._fresh("mark")
            bschema = dict(build.output_schema())
            build = N.DistinctNode(
                source=build, max_groups=self._agg_bucket(build)
            )
            build = N.ProjectNode(
                build,
                tuple(
                    (n, E.ColumnRef(n, bschema[n])) for n in right_keys
                )
                + ((marker, E.Literal(1, T.BIGINT)),),
            )
            node = N.JoinNode(
                left=node,
                right=build,
                join_type="left",
                left_keys=outer_keys,
                right_keys=right_keys,
                payload=(marker,),
                build_unique=True,
            )
            scope = Scope(
                {**scope.columns, marker: T.BIGINT},
                scope.qualifiers,
                scope.parent,
            )
            return ast.IsNullExpr(
                ast.Ident((marker,)), negate=not invert
            )

        def rewrite(n, negated):
            if isinstance(n, (ast.InSubquery, ast.Exists)):
                return attach(n, negated)
            if isinstance(n, ast.UnaryOp) and n.op == "not":
                return dataclasses.replace(
                    n, arg=rewrite(n.arg, not negated)
                )
            if isinstance(n, ast.Select) or not isinstance(n, ast.Node):
                return n
            kwargs = {}
            changed = False
            for f in dataclasses.fields(n):
                v = getattr(n, f.name)
                if isinstance(v, ast.Node):
                    nv = rewrite(v, negated)
                elif isinstance(v, tuple):
                    nv = tuple(
                        rewrite(x, negated)
                        if isinstance(x, ast.Node)
                        else x
                        for x in v
                    )
                else:
                    nv = v
                kwargs[f.name] = nv
                changed |= nv is not v
            return dataclasses.replace(n, **kwargs) if changed else n

        rewritten = rewrite(c, False)
        pred = self._lower(rewritten, scope)
        return N.FilterNode(node, pred), scope


    def _resolvable_in(self, c, scope: Scope) -> bool:
        """True when every column reference in ``c`` (outside nested
        Select bodies) resolves in ``scope`` — the classifier that
        decides whether a WHERE conjunct pushes below deferred LEFT
        joins."""
        ok = True

        def visit(n):
            nonlocal ok
            if not ok or not isinstance(n, ast.Node):
                return
            if isinstance(n, ast.Select):
                return
            if isinstance(n, ast.Ident):
                try:
                    scope.resolve(n.parts)
                except PlanningError:
                    ok = False
                return
            for f in dataclasses.fields(n):
                v = getattr(n, f.name)
                if isinstance(v, ast.Node):
                    visit(v)
                elif isinstance(v, tuple):
                    for x in v:
                        if isinstance(x, ast.Node):
                            visit(x)
                        elif isinstance(x, tuple):
                            for y in x:
                                if isinstance(y, ast.Node):
                                    visit(y)
        visit(c)
        return ok

    @staticmethod
    def _edge_connected(indices, edges) -> bool:
        """True when ``indices`` form one connected component under
        ``edges`` — the bushy rescue must not cross-join unrelated
        relations into its subtree."""
        indices = set(indices)
        if len(indices) <= 1:
            return True
        adj: Dict[int, Set[int]] = {i: set() for i in indices}
        for (i, j, _ci, _cj) in edges:
            if i in indices and j in indices:
                adj[i].add(j)
                adj[j].add(i)
        seen = set()
        stack = [next(iter(indices))]
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            stack.extend(adj[n] - seen)
        return seen == indices

    def _grow_join_tree(
        self, tree, joined, remaining, rels, scopes, est, edges, grow
    ):
        """The greedy left-deep join loop over a shared relation pool
        (indices into ``rels``/``est``; ``edges`` as (i, j, col_i,
        col_j)). ``grow`` re-enters this method for the bushy rescue:
        when the best edged candidate explodes (Q72's inventory x
        catalog_sales on item alone), the REMAINING relations resolve
        into their own subtree first, which then attaches as one
        pseudo-relation over every crossing edge — the composite
        (item, week) join the reference's CBO produces."""
        while remaining:
            # edges from joined set to a candidate relation
            cand: Dict[int, List[Tuple[str, str]]] = {}
            for (i, j, ci, cj) in edges:
                if i in joined and j in remaining:
                    cand.setdefault(j, []).append((ci, cj))
                elif j in joined and i in remaining:
                    cand.setdefault(i, []).append((cj, ci))
            if not cand:
                # no equi edge: cross join. Single-row builds broadcast
                # (scalar-aggregate shape, no expansion); multi-row
                # builds take the general nested-loop kernel with a
                # stats-sized output bucket (reference:
                # NestedLoopJoinOperator)
                nxt = min(remaining, key=lambda i: est[i])
                if est[nxt] > 1.5:
                    tree_est = optimizer.estimate_rows(
                        tree, self.catalogs
                    )
                    cap = bucket_capacity(
                        int(max(tree_est, 1) * max(est[nxt], 1) * 1.2)
                        + 1024
                    )
                    tree = N.CrossJoinNode(
                        tree, rels[nxt], out_capacity=cap
                    )
                else:
                    tree = N.CrossJoinNode(tree, rels[nxt])
                remaining.discard(nxt)
                joined.add(nxt)
                continue
            # cost-based greedy (reference: ReorderJoins'
            # min-intermediate-cardinality objective, greedy instead of
            # DP): pick the candidate whose join OUTPUT estimate is
            # smallest — a selective non-unique build beats a huge PK
            # build on star joins (the Q64-class bad-greedy-pick guard,
            # VERDICT r3 weak 7). Unique builds keep the probe
            # cardinality and take the kernel's static-shape fast
            # path, so they tie-break first.
            tree_est = optimizer.estimate_rows(tree, self.catalogs)

            def rank(i):
                keys = tuple(p[1] for p in cand[i])
                unique = optimizer.is_build_unique(
                    rels[i], keys, self.catalogs
                )
                if unique:
                    out_est = tree_est
                else:
                    # FK-join shape: output ~ probe * build / NDV(keys)
                    ndv = 1.0
                    for k in keys:
                        cs = optimizer._column_stats(
                            rels[i], k, self.catalogs
                        )
                        if cs and cs.distinct_count:
                            ndv *= float(cs.distinct_count)
                    ndv = max(min(ndv, est[i]), 1.0)
                    out_est = tree_est * est[i] / ndv
                return (out_est, not unique, est[i])

            nxt = min(cand, key=rank)
            out_est_nxt, nxt_nonunique, _ = rank(nxt)
            if (
                grow is not None
                and nxt_nonunique
                and len(remaining) >= 2
                and out_est_nxt > 8.0 * max(tree_est, 1024.0)
                and out_est_nxt > float(1 << 20)
                and self._edge_connected(remaining, edges)
            ):
                # bushy rescue: the best edged candidate fans out
                # (Q72: inventory x catalog_sales on item alone,
                # probe*build/NDV ~ 9M). Resolve the REMAINING
                # relations into their own subtree first, then attach
                # it as ONE pseudo-relation — every tree<->subtree
                # edge (item AND the d1/d2 week link) composites into
                # a single selective join, the shape the reference's
                # CBO produces for this plan.
                sub_set = frozenset(remaining)
                sub_seed = max(sub_set, key=lambda i: est[i])
                sub_tree = grow(
                    rels[sub_seed],
                    {sub_seed},
                    set(sub_set) - {sub_seed},
                )
                new_i = len(rels)
                rels.append(sub_tree)
                scopes.append(
                    Scope(dict(sub_tree.output_schema()), {}, None)
                )
                est.append(
                    optimizer.estimate_rows(sub_tree, self.catalogs)
                )
                remapped = []
                for (i, j, ci, cj) in edges:
                    ii = new_i if i in sub_set else i
                    jj = new_i if j in sub_set else j
                    if ii == jj:
                        continue  # consumed inside the subtree
                    remapped.append((ii, jj, ci, cj))
                edges[:] = remapped
                remaining = {new_i}
                continue
            pairs = cand[nxt]
            build = rels[nxt]
            extra_pairs: List[Tuple[str, str]] = []
            forced_unique = None
            tree_sch = dict(tree.output_schema())
            for ci, _ in pairs:
                if tree_sch[ci].is_nested:
                    raise PlanningError(
                        f"join on a {tree_sch[ci].name} column is not "
                        "supported"
                    )
            ld_pairs = [
                p for p in pairs if tree_sch[p[0]].is_long_decimal
            ]
            if ld_pairs:
                # long-decimal (int128) equi keys: the kernel key is a
                # 128->64 mix (ops.join._key_of), so EVERY long-decimal
                # pair — including one used as the kernel key — is also
                # demoted to a residual limb-equality filter; a mix
                # collision becomes a filtered row, never a wrong one.
                # Inner joins only (this pool is inner by construction).
                norm = [p for p in pairs if p not in ld_pairs]
                extra_pairs.extend(ld_pairs)
                if norm:
                    pairs = norm
                else:
                    pairs = ld_pairs[:1]
                    # the mix can collide: never trust m in {0,1}
                    forced_unique = False
            if len(pairs) > 2:
                # widen past the kernel's 2x32-bit composite: when
                # connector stats bound every key column's range, the
                # whole composite packs BIJECTIVELY into one bigint
                # via stats-allocated bit widths (no residual, no
                # out_capacity blow-out on skew)
                packed = self._pack_composite_keys(tree, build, pairs)
                if packed is not None:
                    tree, build, pairs, forced_unique = packed
                else:
                    # fallback: keep the subset that proves build
                    # uniqueness and demote the rest to a residual
                    import itertools

                    best = None
                    for combo in itertools.combinations(
                        range(len(pairs)), 2
                    ):
                        keys = tuple(pairs[k][1] for k in combo)
                        if optimizer.is_build_unique(
                            build, keys, self.catalogs
                        ):
                            best = combo
                            break
                    if best is None:
                        best = (0, 1)
                    extra_pairs.extend(
                        p for k, p in enumerate(pairs) if k not in best
                    )
                    pairs = [pairs[k] for k in best]
            lkeys = tuple(p[0] for p in pairs)
            rkeys = tuple(p[1] for p in pairs)
            unique = (
                forced_unique
                if forced_unique is not None
                else optimizer.is_build_unique(
                    build, rkeys, self.catalogs
                )
            )
            payload = tuple(
                c for c in build.output_schema() if c not in rkeys
            ) + tuple(c for c in rkeys if c not in tree.output_schema())
            # keep join keys from the build side only when names don't clash
            payload = tuple(
                c for c in build.output_schema()
                if c not in tree.output_schema()
            )
            out_cap = None
            if not unique:
                probe_est = optimizer.estimate_rows(tree, self.catalogs)
                build_est = est[nxt]
                # stats-driven OUTPUT estimate (the ranker's FK-join
                # formula over the kernel keys): a fan-out join like
                # Q72's inventory x catalog_sales on item alone
                # produces probe*build/NDV rows — sizing from inputs
                # only sent it through the 4x capacity-retry loop,
                # recompiling the whole program at each step
                ndv = 1.0
                saw_stats = False
                for k in rkeys:
                    cs_ = optimizer._column_stats(
                        build, k, self.catalogs
                    )
                    if cs_ and cs_.distinct_count:
                        ndv *= float(cs_.distinct_count)
                        saw_stats = True
                ndv = max(min(ndv, build_est), 1.0)
                # ndv=1 with NO stats means "no information", not "one
                # distinct value" — only widen the bucket beyond the
                # input-sized default when stats actually back the
                # fan-out estimate (a stats-less guess of probe*build
                # compiled a 268M-row program for a 2k-row join)
                cap_est = int(max(probe_est, build_est) * 4)
                if saw_stats:
                    out_est = probe_est * build_est / ndv
                    cap_est = max(cap_est, int(out_est * 3 / 2))
                out_cap = bucket_capacity(cap_est + 1024)
            join_residual = None
            if extra_pairs:
                tree_schema = dict(tree.output_schema())
                build_schema = dict(build.output_schema())
                eqs = []
                for ci, cj in extra_pairs:
                    if cj not in payload:
                        raise PlanningError(
                            f"demoted join key {cj} not carried in the "
                            "join payload (name clash)"
                        )
                    eqs.append(
                        E.Compare(
                            "=",
                            E.ColumnRef(ci, tree_schema[ci]),
                            E.ColumnRef(cj, build_schema[cj]),
                        )
                    )
                join_residual = (
                    eqs[0] if len(eqs) == 1 else E.And(tuple(eqs))
                )
            tree = N.JoinNode(
                left=tree,
                right=build,
                join_type="inner",
                left_keys=lkeys,
                right_keys=rkeys,
                payload=payload,
                build_unique=unique,
                out_capacity=out_cap,
                residual=join_residual,
            )
            joined.add(nxt)
            remaining.discard(nxt)
        return tree

    def _finalize_pool(self, node, scope):
        if isinstance(node, _PendingJoin):
            node = self._resolve_join_pool(node, scope, [])
        return node

    def _resolve_join_pool(
        self, pool: "_PendingJoin", scope: Scope, conjuncts
    ) -> N.PlanNode:
        rels = list(pool.rels)
        scopes = list(pool.scopes)
        # ownership map: column/qualified name -> relation index
        owner: Dict[str, int] = {}
        for i, s in enumerate(scopes):
            for c in s.columns:
                owner[c] = i

        def rels_of(c) -> Set[int]:
            found: Set[int] = set()

            def visit(n):
                if isinstance(n, ast.Ident):
                    for i, s in enumerate(scopes):
                        try:
                            _, _, is_outer = s.resolve(n.parts)
                            if not is_outer:
                                found.add(i)
                                return
                        except PlanningError:
                            continue
                    return
                for f in dataclasses.fields(n) if dataclasses.is_dataclass(n) else []:
                    v = getattr(n, f.name)
                    if isinstance(v, ast.Node):
                        visit(v)
                    elif isinstance(v, tuple):
                        for x in v:
                            if isinstance(x, ast.Node):
                                visit(x)
                            elif (
                                isinstance(x, tuple)
                                and len(x) == 2
                                and all(isinstance(y, ast.Node) for y in x)
                            ):
                                visit(x[0])
                                visit(x[1])
            visit(c)
            return found

        filters: Dict[int, List] = {}
        edges: List[Tuple[int, int, str, str]] = []  # (i, j, col_i, col_j)
        residual: List = []
        for c in conjuncts:
            rs = rels_of(c)
            if len(rs) == 1:
                filters.setdefault(next(iter(rs)), []).append(c)
            elif (
                len(rs) == 2
                and isinstance(c, ast.BinaryOp)
                and c.op == "="
                and isinstance(c.left, ast.Ident)
                and isinstance(c.right, ast.Ident)
            ):
                i = next(iter(rels_of(c.left)))
                j = next(iter(rels_of(c.right)))
                li, _, _ = scopes[i].resolve(c.left.parts)
                rj, _, _ = scopes[j].resolve(c.right.parts)
                edges.append((i, j, li, rj))
            else:
                residual.append(c)

        for i, fs in filters.items():
            preds = [self._lower(f, scopes[i]) for f in fs]
            rels[i] = N.FilterNode(
                rels[i], preds[0] if len(preds) == 1 else E.And(tuple(preds))
            )

        est = [optimizer.estimate_rows(r, self.catalogs) for r in rels]

        def grow_sub(tree, joined, remaining):
            # the subtree grower NEVER rescues: a nested rescue's
            # in-place edge remap would orphan crossing edges of the
            # outer rescue (silently dropping join predicates)
            return self._grow_join_tree(
                tree, joined, remaining, rels, scopes, est, edges,
                grow=None,
            )

        def grow(tree, joined, remaining):
            return self._grow_join_tree(
                tree, joined, remaining, rels, scopes, est, edges,
                grow=grow_sub,
            )

        joined = {max(range(len(rels)), key=lambda i: est[i])}
        tree = rels[next(iter(joined))]
        remaining = set(range(len(rels))) - joined
        tree = grow(tree, joined, remaining)

        if residual:
            preds = [self._lower(c, scope) for c in residual]
            tree = N.FilterNode(
                tree, preds[0] if len(preds) == 1 else E.And(tuple(preds))
            )
        return tree

    # ----------------------------------------------- subquery conjunct ops

    def _match_subquery_conjunct(self, c, scope):
        negate = False
        inner = c
        if isinstance(inner, ast.UnaryOp) and inner.op == "not":
            negate = True
            inner = inner.arg
        if isinstance(inner, ast.InSubquery):
            return ("in", inner, negate != inner.negate)
        if isinstance(inner, ast.Exists):
            return ("exists", inner, negate != inner.negate)
        if (
            isinstance(inner, ast.BinaryOp)
            and inner.op in ("=", "<>", "!=", "<", "<=", ">", ">=")
            and not negate
        ):
            # the subquery may sit anywhere inside the comparison
            # (q6-class: i_current_price > 1.2 * (select avg(...))) —
            # exactly one CORRELATED ScalarSubquery qualifies;
            # uncorrelated siblings keep lowering via Param
            subs = [
                s
                for s in _find_scalar_subqueries(inner)
                if self._is_correlated(s.query, scope)
            ]
            if len(subs) == 1:
                return ("scalar_cmp", inner, False)
            return None  # uncorrelated: handled by Param in _lower
        return None

    def _is_correlated(self, q: ast.Select, scope: Scope) -> bool:
        saved_params = list(self.params)
        try:
            self.plan_select(q, outer=None)
            return False
        except PlanningError:
            return True
        finally:
            self.params = saved_params

    def _apply_subquery_op(self, node, scope, op):
        kind, a, negate = op
        node = self._finalize_pool(node, scope)
        if kind == "in":
            return self._apply_in_subquery(node, scope, a, negate)
        if kind == "exists":
            return self._apply_exists(node, scope, a, negate)
        if kind == "scalar_cmp":
            return self._apply_correlated_scalar(node, scope, a)
        raise AssertionError(kind)

    def _pack_composite_keys(self, tree, build, pairs):
        """>2-column equi-join keys -> ONE synthetic bigint key on each
        side, packed bijectively with stats-allocated bit widths
        (reference: multi-channel GroupByHash/JoinProbe composite keys;
        TPU-first: the sorted-probe kernel stays single-int64).

        Requires every pair to be integer/date-typed with known
        min/max on BOTH sides and a total packed width <= 62 bits;
        returns (tree', build', [(lkey, rkey)], build_unique) with
        projections appended, or None when stats can't prove the pack
        is bijective (caller falls back to residual demotion)."""
        tree_schema = dict(tree.output_schema())
        build_schema = dict(build.output_schema())
        ranges = []
        for ci, cj in pairs:
            lt, rt = tree_schema[ci], build_schema[cj]
            if not (
                (lt.is_integer or lt.name == "date")
                and (rt.is_integer or rt.name == "date")
            ):
                return None
            cs_l = optimizer._column_stats(tree, ci, self.catalogs)
            cs_r = optimizer._column_stats(build, cj, self.catalogs)
            if (
                cs_l is None
                or cs_r is None
                or cs_l.min_value is None
                or cs_l.max_value is None
                or cs_r.min_value is None
                or cs_r.max_value is None
            ):
                return None
            lo = min(int(cs_l.min_value), int(cs_r.min_value))
            hi = max(int(cs_l.max_value), int(cs_r.max_value))
            ranges.append((lo, hi))
        widths = [max(hi - lo + 1, 1).bit_length() for lo, hi in ranges]
        if sum(widths) > 62:
            return None
        # build an equal value on equal composites: equal shifts/los on
        # both sides; NULL components null the whole key (never match)
        shifts = []
        s = 0
        for w in reversed(widths):
            shifts.append(s)
            s += w
        shifts = list(reversed(shifts))

        def packed_expr(schema, cols):
            total = None
            for (col, (lo, _hi), shift) in zip(cols, ranges, shifts):
                ref = E.Cast(
                    E.ColumnRef(col, schema[col]), T.BIGINT
                )
                term = E.Arithmetic(
                    "*",
                    E.Arithmetic(
                        "-", ref, E.Literal(lo, T.BIGINT), T.BIGINT
                    ),
                    E.Literal(1 << shift, T.BIGINT),
                    T.BIGINT,
                )
                total = (
                    term
                    if total is None
                    else E.Arithmetic("+", total, term, T.BIGINT)
                )
            return total

        unique = optimizer.is_build_unique(
            build, tuple(cj for _, cj in pairs), self.catalogs
        )
        lname, rname = self._fresh("packl"), self._fresh("packr")
        tree2 = N.ProjectNode(
            source=tree,
            projections=tuple(
                (n, E.ColumnRef(n, t)) for n, t in tree_schema.items()
            )
            + ((lname, packed_expr(tree_schema, [ci for ci, _ in pairs])),),
        )
        build2 = N.ProjectNode(
            source=build,
            projections=tuple(
                (n, E.ColumnRef(n, t)) for n, t in build_schema.items()
            )
            + ((rname, packed_expr(build_schema, [cj for _, cj in pairs])),),
        )
        return tree2, build2, [(lname, rname)], unique

    def _probe_key(self, node, scope, arg_ast):
        """Column name for a probe-side join key (project if not a bare
        column)."""
        e = self._lower(arg_ast, scope)
        if isinstance(e, E.ColumnRef):
            return node, scope, e.name
        name = self._fresh("key")
        schema = node.output_schema()
        projs = [
            (n, E.ColumnRef(n, t)) for n, t in schema.items()
        ] + [(name, e)]
        node = N.ProjectNode(node, tuple(projs))
        scope = Scope({**scope.columns, name: e.dtype}, scope.qualifiers, scope.parent)
        return node, scope, name

    def _apply_in_subquery(self, node, scope, a: ast.InSubquery, negate):
        if self._is_correlated(a.query, scope):
            # correlated IN rewrites to correlated EXISTS with the
            # membership as one more equality (reference: the
            # InPredicate -> quantified-comparison -> semi-join chain):
            #   x IN (select y from t where corr)
            #   == EXISTS (select 1 from t where corr and y = x)
            # NOT IN keeps its null-awareness requirement: a NULL x or
            # NULL y makes the anti join inexact, so reject it rather
            # than risk silent wrong rows.
            if negate:
                raise PlanningError(
                    "correlated NOT IN requires null-aware "
                    "three-valued semantics (unsupported)"
                )
            q = a.query
            if len(q.items) != 1 or q.group_by or q.having or q.distinct:
                raise PlanningError(
                    "unsupported correlated IN subquery shape"
                )
            item = q.items[0]
            inner_expr = item.expr
            # the rewrite moves a.arg INSIDE the subquery: sound only
            # when none of its column names resolve against the inner
            # relations (unqualified resolution prefers the inner
            # scope, which would silently change the comparison into
            # an inner self-equality — oracle-caught)
            _, inner_scope = self._plan_from(q.from_, None)
            shadowed = []

            def _check(n):
                if isinstance(n, ast.Ident):
                    try:
                        inner_scope.resolve(n.parts)
                        shadowed.append(n)
                    except PlanningError:
                        pass
                    return
                if not isinstance(n, ast.Node):
                    return
                for f_ in dataclasses.fields(n):
                    v = getattr(n, f_.name)
                    if isinstance(v, ast.Node):
                        _check(v)
                    elif isinstance(v, tuple):
                        for x in v:
                            if isinstance(x, ast.Node):
                                _check(x)

            _check(a.arg)
            if shadowed:
                raise PlanningError(
                    "correlated IN whose left side is shadowed by the "
                    f"subquery's relations ({shadowed[0]}) is not "
                    "supported (qualify the outer column)"
                )
            eq = ast.BinaryOp("=", inner_expr, a.arg)
            inner = ast.Select(
                items=(ast.SelectItem(ast.NumberLit("1"), None),),
                from_=q.from_,
                where=(
                    eq
                    if q.where is None
                    else ast.BinaryOp("and", q.where, eq)
                ),
                ctes=q.ctes,
            )
            return self._apply_exists(
                node, scope, ast.Exists(inner), False
            )
        sub_node, _, sub_names = self.plan_select(a.query, outer=None)
        if len(sub_names) != 1:
            raise PlanningError("IN subquery must return one column")
        node, scope, key = self._probe_key(node, scope, a.arg)
        if scope.columns[key].is_long_decimal:
            # semi/anti output has no build columns, so the kernel's
            # mixed long-decimal key cannot be residual-verified — a mix
            # collision would KEEP a wrong row. Inner joins stay exact
            # (residual limb equality); membership tests keep the gate.
            raise PlanningError(
                "IN/NOT IN on a long decimal (p>18) is not supported "
                "(documented deviation; cast to decimal(18,s))"
            )
        if negate:
            node = self._null_aware_prefilter(node, scope, a.query, key)
        node = N.JoinNode(
            left=node,
            right=sub_node,
            join_type="anti" if negate else "semi",
            left_keys=(key,),
            right_keys=(sub_names[0],),
            payload=(),
        )
        return node, scope

    def _not_in_state_param(self, query: ast.Select) -> E.Param:
        """Plan ``query`` once under a fresh param namespace and reduce
        it to ONE bound scalar classifying S for the null-aware NOT IN
        rewrite: 0 = S empty, 1 = S non-empty and null-free,
        2 = S contains a NULL (one subquery execution for both counts)."""
        saved = self.params
        self.params = []
        try:
            cnt_node, _, cnt_names = self.plan_select(query, outer=None)
            col = cnt_names[0]
            col_t = cnt_node.output_schema()[col]
            total = E.ColumnRef("$na_total", T.BIGINT)
            non_null = E.ColumnRef("$na_nonnull", T.BIGINT)
            zero = E.Literal(0, T.BIGINT)
            state = E.Case(
                whens=(
                    (E.Compare("=", total, zero), zero),
                    (
                        E.Compare("=", total, non_null),
                        E.Literal(1, T.BIGINT),
                    ),
                ),
                default=E.Literal(2, T.BIGINT),
                _dtype=T.BIGINT,
            )
            sub = Plan(
                root=N.ProjectNode(
                    source=N.AggregationNode(
                        source=cnt_node,
                        group_keys=(),
                        aggs=(
                            AggCall("count_star", None, "$na_total"),
                            AggCall(
                                "count",
                                E.ColumnRef(col, col_t),
                                "$na_nonnull",
                            ),
                        ),
                    ),
                    projections=(("$na_state", state),),
                ),
                params=self.params,
                output_names=("$na_state",),
            )
        finally:
            self.params = saved
        pid = self._param_counter[0]
        self._param_counter[0] += 1
        self.params.append((pid, sub))
        return E.Param(pid, T.BIGINT)

    def _null_aware_prefilter(self, node, scope, query: ast.Select, key):
        """Null-aware anti join (reference: the null-aware rewrite of
        NOT IN — SURVEY.md §2.1 "Logical planner" subquery rewrites; a
        plain anti join has NOT-EXISTS semantics and returns wrong
        answers on NULLs). SQL three-valued logic for ``x NOT IN (S)``:

          - S empty                  -> TRUE for every x (even NULL)
          - x NULL and S non-empty   -> UNKNOWN (row dropped)
          - S contains NULL          -> never TRUE (match -> FALSE,
                                        else UNKNOWN -> dropped)

        One bound scalar param (0 = S empty, 1 = null-free, 2 = has a
        NULL — computed from a single execution of S) turns this into a
        probe-side pre-filter: keep a probe row iff ``state = 0 OR
        (x IS NOT NULL AND state = 1)``; the anti join then decides
        membership for the surviving (non-null x, null-free S) cases,
        and an empty S makes the anti join keep everything."""
        state = self._not_in_state_param(query)
        probe_ref = E.ColumnRef(key, scope.columns[key])
        pred = E.Or(
            (
                E.Compare("=", state, E.Literal(0, T.BIGINT)),
                E.And(
                    (
                        E.IsNull(probe_ref, negate=True),
                        E.Compare("=", state, E.Literal(1, T.BIGINT)),
                    )
                ),
            )
        )
        return N.FilterNode(source=node, predicate=pred)

    def _apply_exists(self, node, scope, a: ast.Exists, negate):
        q = a.query
        corr_pairs, neq_pairs, residual_where = self._extract_correlation(
            q, scope, collect_neq=True
        )
        if not corr_pairs:
            raise PlanningError(
                "uncorrelated or non-equality-correlated EXISTS is not "
                "supported yet"
            )
        for _, outer_col in corr_pairs:
            if scope.columns[outer_col].is_long_decimal:
                # before the neq_pairs branch: BOTH decorrelation forms
                # end in a semi/anti join whose keys cannot
                # residual-verify the 128->64 key mix
                raise PlanningError(
                    "EXISTS correlated on a long decimal (p>18) is not "
                    "supported (documented deviation: semi-join keys "
                    "cannot residual-verify the 128->64 key mix)"
                )
        if neq_pairs:
            if len(neq_pairs) > 1:
                raise PlanningError(
                    "EXISTS with multiple inequality-correlated "
                    "conjuncts is not supported"
                )
            return self._apply_exists_neq(
                node, scope, q, corr_pairs, neq_pairs[0],
                residual_where, negate,
            )
        inner_cols = tuple(p[0] for p in corr_pairs)
        inner_sel = ast.Select(
            items=tuple(
                ast.SelectItem(ast.Ident((c,)), None) for c in inner_cols
            ),
            from_=q.from_,
            where=residual_where,
            ctes=q.ctes,
        )
        sub_node, _, sub_names = self.plan_select(inner_sel, outer=None)
        outer_keys = tuple(p[1] for p in corr_pairs)
        node = N.JoinNode(
            left=node,
            right=sub_node,
            join_type="anti" if negate else "semi",
            left_keys=outer_keys,
            right_keys=sub_names,
            payload=(),
        )
        return node, scope

    def _apply_exists_neq(
        self, node, scope, q, corr_pairs, neq_pair, residual_where, negate
    ):
        """Decorrelate ``EXISTS(inner.k = outer.k AND inner.c <> outer.c
        [AND pure-inner residual])`` by counting (the classic Q21
        rewrite; reference: ApplyNode correlated-EXISTS transformations):

            cnt_all(k)    = rows of inner per equality key with c NOT NULL
            cnt_self(k,c) = rows of inner per (key, c)
            EXISTS     <=> outer.c IS NOT NULL
                           AND coalesce(cnt_all,0)-coalesce(cnt_self,0) > 0
            NOT EXISTS <=> outer.c IS NULL
                           OR coalesce(cnt_all,0)-coalesce(cnt_self,0) = 0

        NULL semantics: an inner row with c NULL makes ``c <> outer.c``
        UNKNOWN (never satisfies EXISTS), so cnt_all counts ``count(c)``,
        not ``count(*)``; an outer row with c NULL makes every comparison
        UNKNOWN, so EXISTS is forced false (NOT EXISTS true) regardless
        of counts. Both lookups are left joins against grouped (hence
        unique-keyed) builds — TPU-friendly: two hash joins + a filter,
        no per-row subquery."""
        inner_eq = [p[0] for p in corr_pairs]
        outer_eq = [p[1] for p in corr_pairs]
        neq_inner, neq_outer = neq_pair

        def grouped_count(group_cols, count_col):
            aliases = [self._fresh("ckey") for _ in group_cols]
            cnt = self._fresh("cnt")
            count_args = (
                (ast.Ident((count_col,)),) if count_col is not None else ()
            )
            sel = ast.Select(
                items=tuple(
                    ast.SelectItem(ast.Ident((c,)), alias)
                    for c, alias in zip(group_cols, aliases)
                )
                + (
                    ast.SelectItem(
                        ast.FuncCall("count", count_args), cnt.lstrip("$")
                    ),
                ),
                from_=q.from_,
                where=residual_where,
                group_by=tuple(ast.Ident((c,)) for c in group_cols),
                ctes=q.ctes,
            )
            sub_node, _, sub_names = self.plan_select(sel, outer=None)
            return sub_node, sub_names[:-1], sub_names[-1]

        all_node, all_keys, cnt_all = grouped_count(inner_eq, neq_inner)
        self_node, self_keys, cnt_self = grouped_count(
            inner_eq + [neq_inner], None
        )

        node = N.JoinNode(
            left=node,
            right=all_node,
            join_type="left",
            left_keys=tuple(outer_eq),
            right_keys=tuple(all_keys),
            payload=(cnt_all,),
            build_unique=True,  # grouped by the join keys
        )
        node = N.JoinNode(
            left=node,
            right=self_node,
            join_type="left",
            left_keys=tuple(outer_eq) + (neq_outer,),
            right_keys=tuple(self_keys),
            payload=(cnt_self,),
            build_unique=True,
        )
        sch = node.output_schema()
        zero = E.Literal(0, T.BIGINT)
        diff = E.arith(
            "-",
            E.Coalesce((E.ColumnRef(cnt_all, sch[cnt_all]), zero), T.BIGINT),
            E.Coalesce(
                (E.ColumnRef(cnt_self, sch[cnt_self]), zero), T.BIGINT
            ),
        )
        outer_c = E.ColumnRef(neq_outer, sch[neq_outer])
        if negate:  # NOT EXISTS
            pred: E.Expr = E.Or(
                (E.IsNull(outer_c), E.Compare("=", diff, zero))
            )
        else:  # EXISTS
            pred = E.And(
                (
                    E.IsNull(outer_c, negate=True),
                    E.Compare(">", diff, zero),
                )
            )
        node = N.FilterNode(node, pred)
        # the helper count columns are internal: restore the outer scope
        return node, scope

    def _apply_correlated_scalar(self, node, scope, cmp: ast.BinaryOp):
        (sub,) = (
            s
            for s in _find_scalar_subqueries(cmp)
            if self._is_correlated(s.query, scope)
        )
        q = sub.query
        corr_pairs, residual_where = self._extract_correlation(q, scope)
        if not corr_pairs:
            raise PlanningError(
                "correlated scalar subquery requires equality correlation"
            )
        if len(q.items) != 1 or q.group_by or q.having:
            raise PlanningError(
                "unsupported correlated scalar subquery shape"
            )
        inner_keys = tuple(p[0] for p in corr_pairs)
        outer_keys = tuple(p[1] for p in corr_pairs)
        val_name = self._fresh("scalar")
        key_aliases = [self._fresh("ckey") for _ in inner_keys]
        inner_sel = ast.Select(
            items=tuple(
                ast.SelectItem(ast.Ident((c,)), alias)
                for c, alias in zip(inner_keys, key_aliases)
            )
            + (ast.SelectItem(q.items[0].expr, val_name.lstrip("$")),),
            from_=q.from_,
            where=residual_where,
            group_by=tuple(ast.Ident((c,)) for c in inner_keys),
            ctes=q.ctes,
        )
        sub_node, _, sub_names = self.plan_select(inner_sel, outer=None)
        val_col = sub_names[-1]
        node = N.JoinNode(
            left=node,
            right=sub_node,
            join_type="inner",
            left_keys=outer_keys,
            right_keys=tuple(sub_names[: len(inner_keys)]),
            payload=(val_col,),
            build_unique=True,  # grouped by the join keys
        )
        sch = node.output_schema()
        scope = Scope(dict(sch), scope.qualifiers, scope.parent)
        # lower the WHOLE comparison with the subquery ast mapped to
        # the joined value column (agg_map doubles as an ast->column
        # substitution), so arithmetic around the subquery just works
        pred = self._lower(cmp, scope, agg_map={sub: val_col})
        return N.FilterNode(node, pred), scope

    def _extract_correlation(
        self,
        q: ast.Select,
        outer_scope: Scope,
        collect_neq: bool = False,
    ):
        """Split the inner WHERE into (inner_col = outer_col) correlation
        pairs and the residual. Returns ([(inner_col, outer_col)], where)
        — or, with ``collect_neq``, a 3-tuple whose middle element lists
        (inner_col <> outer_col) pairs (Q21's correlation shape)."""
        inner_node_probe, inner_scope = self._plan_from(q.from_, None)
        pairs: List[Tuple[str, str]] = []
        neq_pairs: List[Tuple[str, str]] = []
        rest: List[ast.Node] = []
        for c in _split_conjuncts(q.where) if q.where is not None else []:
            pair = None
            is_eq = True
            if (
                isinstance(c, ast.BinaryOp)
                and (
                    c.op == "="
                    or (collect_neq and c.op in ("<>", "!="))
                )
                and isinstance(c.left, ast.Ident)
                and isinstance(c.right, ast.Ident)
            ):
                is_eq = c.op == "="
                for inner_ast, outer_ast in (
                    (c.left, c.right),
                    (c.right, c.left),
                ):
                    try:
                        ic, _, i_outer = inner_scope.resolve(inner_ast.parts)
                        if i_outer:
                            continue
                    except PlanningError:
                        continue
                    try:
                        inner_scope.resolve(outer_ast.parts)
                        continue  # both resolve inner: a plain conjunct
                    except PlanningError:
                        pass
                    try:
                        oc, _, _ = outer_scope.resolve(outer_ast.parts)
                    except PlanningError:
                        continue
                    pair = (ic, oc)
                    break
            if pair and is_eq:
                pairs.append(pair)
            elif pair:
                neq_pairs.append(pair)
            else:
                rest.append(c)
        where = None
        if rest:
            where = rest[0]
            for c in rest[1:]:
                where = ast.BinaryOp("and", where, c)
        if collect_neq:
            return pairs, neq_pairs, where
        return pairs, where

    # --------------------------------------------------------- aggregation

    def _contains_agg(self, e: ast.Node) -> bool:
        if isinstance(e, ast.FuncCall):
            if e.window is None and functions.is_aggregate(e.name):
                return True
        return any(
            self._contains_agg(c) for c in _ast_children(e)
        )

    def _contains_window(self, e: ast.Node) -> bool:
        if isinstance(e, ast.FuncCall) and e.window is not None:
            return True
        return any(self._contains_window(c) for c in _ast_children(e))

    def _collect_aggs(self, e: ast.Node, out: List[ast.FuncCall]):
        if (
            isinstance(e, ast.FuncCall)
            and e.window is None
            and functions.is_aggregate(e.name)
        ):
            if e not in out:
                out.append(e)
            return
        for c in _ast_children(e):
            self._collect_aggs(c, out)

    def _plan_aggregation(self, node, scope, sel: ast.Select):
        node = self._finalize_pool(node, scope)
        agg_calls: List[ast.FuncCall] = []
        for it in sel.items:
            if not isinstance(it.expr, ast.Star):
                self._collect_aggs(it.expr, agg_calls)
        if sel.having is not None:
            self._collect_aggs(sel.having, agg_calls)
        for si in sel.order_by:
            self._collect_aggs(si.expr, agg_calls)

        agg_map: Dict[ast.Node, str] = {}
        group_keys: List[Tuple[str, E.Expr]] = []
        for g in sel.group_by:
            if isinstance(g, ast.NumberLit):
                # GROUP BY ordinal (reference: GROUP BY 1 resolves to
                # the first select item)
                try:
                    idx = int(g.text) - 1
                except ValueError:
                    raise PlanningError(
                        f"GROUP BY position must be an integer, got "
                        f"{g.text}"
                    ) from None
                if not (0 <= idx < len(sel.items)) or isinstance(
                    sel.items[idx].expr, ast.Star
                ):
                    raise PlanningError(
                        f"GROUP BY position {g.text} out of range"
                    )
                g = sel.items[idx].expr
            e = self._lower(g, scope)
            if e.dtype.is_nested:
                raise PlanningError(
                    f"GROUP BY a {e.dtype.name} column is not supported"
                )
            if isinstance(e, E.ColumnRef):
                group_keys.append((e.name, e))
            else:
                # expression key: select items / HAVING / ORDER BY
                # re-lowering the same AST resolve to the key column
                name = self._fresh("key")
                group_keys.append((name, e))
                agg_map[g] = name
        distinct_aggs = [
            a
            for a in agg_calls
            if a.distinct or a.name == "approx_distinct"
        ]
        plain_aggs = [a for a in agg_calls if a not in distinct_aggs]
        if distinct_aggs:
            for a in distinct_aggs:
                if a.name not in ("count", "approx_distinct"):
                    raise PlanningError(
                        f"{a.name}(DISTINCT x) is not supported "
                        "(count/approx_distinct only)"
                    )
            needs_stitch = bool(plain_aggs) or len(distinct_aggs) > 1
            if needs_stitch and len(group_keys) > 2:
                raise PlanningError(
                    "multiple/mixed DISTINCT aggregates support at "
                    "most 2 group keys (stitch-join key width)"
                )
            if needs_stitch and len(group_keys) == 2 and any(
                e.dtype.np_dtype.itemsize > 4 for _, e in group_keys
            ):
                # the stitch join packs both keys into one int64
                # (ops.join.pack_keys) — fail at plan time, not runtime
                raise PlanningError(
                    "multiple/mixed DISTINCT aggregates require "
                    "32-bit group keys when there are two"
                )
            # each DISTINCT agg gets its own two-level tree over the
            # SAME source (reference: MarkDistinct feeding one
            # HashAggregation); multiple trees stitch per group via
            # unique-build joins (identical group sets by
            # construction), or single-row broadcasts when global
            parts: List[Tuple[N.PlanNode, str]] = []
            for a in distinct_aggs:
                arg = self._lower(a.args[0], scope)
                dcol = self._fresh("dist")
                pre = N.AggregationNode(
                    source=node,
                    group_keys=tuple(group_keys) + ((dcol, arg),),
                    aggs=(),
                    max_groups=self._agg_bucket(node),
                )
                out_name = self._fresh("agg")
                post = N.AggregationNode(
                    source=pre,
                    group_keys=tuple(
                        (n, E.ColumnRef(n, e.dtype))
                        for n, e in group_keys
                    ),
                    aggs=(
                        AggCall(
                            "count",
                            E.ColumnRef(dcol, arg.dtype),
                            out_name,
                        ),
                    ),
                    max_groups=self._agg_bucket(node),
                )
                agg_map[a] = out_name
                parts.append((post, out_name))
            if plain_aggs:
                plain_node, agg_map2 = self._plain_agg_node(
                    node, group_keys, plain_aggs, scope
                )
                agg_map.update(agg_map2)
                stitched: N.PlanNode = plain_node
                rest = parts
            else:
                stitched = parts[0][0]
                rest = parts[1:]
            for post, out_name in rest:
                if group_keys:
                    stitched = N.JoinNode(
                        left=stitched,
                        right=post,
                        join_type="inner",
                        left_keys=tuple(n for n, _ in group_keys),
                        right_keys=tuple(n for n, _ in group_keys),
                        payload=(out_name,),
                        build_unique=True,
                    )
                else:
                    stitched = N.CrossJoinNode(
                        left=stitched, right=post
                    )
            out_scope = self._post_agg_scope(stitched, scope)
            if sel.having is not None:
                pred = self._lower(
                    sel.having, out_scope, agg_map=agg_map
                )
                stitched = N.FilterNode(stitched, pred)
            return stitched, out_scope, agg_map

        agg_node, agg_map2 = self._plain_agg_node(
            node, group_keys, agg_calls, scope
        )
        agg_map.update(agg_map2)
        out_scope = self._post_agg_scope(agg_node, scope)
        if sel.having is not None:
            pred = self._lower(sel.having, out_scope, agg_map=agg_map)
            agg_node = N.FilterNode(agg_node, pred)
        return agg_node, out_scope, agg_map

    def _plain_agg_node(self, node, group_keys, agg_calls, scope):
        """Lower aggregate calls through the function registry
        (functions.AGGREGATE — the reference's FunctionAndTypeManager
        resolution seam). Kernel aggregates become AggCalls directly;
        COMPOSED aggregates (avg, variance family, corr, ... —
        functions.ComposedAgg) become their primitive mergeable state
        AggCalls plus a finisher projection stacked on the aggregation
        (the reference's accumulator/output split), so the kernel and
        the distributed partial/final rewrite only ever see
        self-mergeable primitives."""
        aggs: List[AggCall] = []
        agg_map: Dict[ast.Node, str] = {}
        #: ordered final outputs: (name, finish_expr|None, dtype|None)
        outputs: List[Tuple[str, Optional[E.Expr]]] = []
        any_composed = False
        for a in agg_calls:
            out_name = self._fresh("agg")
            if a.name == "count" and not a.args:
                aggs.append(AggCall("count_star", None, out_name))
                outputs.append((out_name, None))
                agg_map[a] = out_name
                continue
            args = [self._lower(x, scope) for x in a.args]
            for arg in args:
                # count ignores the value; checksum hashes the (hi, lo)
                # limb pair directly (expr.ValueHash long-decimal path)
                if arg.dtype.is_long_decimal and a.name not in (
                    "count", "checksum",
                ):
                    raise PlanningError(
                        f"{a.name}() over {arg.dtype} is not supported: "
                        "long-decimal accumulators are a documented "
                        "deviation (no benchmark config aggregates "
                        ">18-digit decimals) — cast to decimal(18,s) "
                        "or double to aggregate"
                    )
            try:
                low = functions.lower_aggregate(a.name, args)
            except functions.FunctionError as err:
                raise PlanningError(str(err)) from None
            if isinstance(low, functions.KernelAgg):
                aggs.append(
                    AggCall(
                        low.func, low.arg, out_name,
                        arg2=low.arg2, param=low.param,
                    )
                )
                outputs.append((out_name, None))
            else:  # ComposedAgg: primitive states + finisher expr
                any_composed = True
                refs: Dict[str, E.Expr] = {}
                for suffix, prim, sexpr in low.states:
                    sname = f"{out_name}${suffix}"
                    aggs.append(AggCall(prim, sexpr, sname))
                    refs[suffix] = E.ColumnRef(
                        sname, functions.agg_state_type(prim, sexpr)
                    )
                outputs.append((out_name, (low.finish(refs), low.dtype)))
            agg_map[a] = out_name
        agg_node: N.PlanNode = N.AggregationNode(
            source=node,
            group_keys=tuple(group_keys),
            aggs=tuple(aggs),
            max_groups=self._agg_bucket(node) if group_keys else 1,
        )
        if any_composed:
            projs: List[Tuple[str, E.Expr]] = [
                (n, E.ColumnRef(n, e.dtype)) for n, e in group_keys
            ]
            for name, fin in outputs:
                if fin is None:
                    dt = dict(agg_node.output_schema())[name]
                    projs.append((name, E.ColumnRef(name, dt)))
                else:
                    fexpr, fdtype = fin
                    # the registry's declared dtype is the contract;
                    # coerce a mismatched finisher rather than letting
                    # the drift ship silently
                    if fexpr.dtype != fdtype:
                        fexpr = E.Cast(fexpr, fdtype)
                    projs.append((name, fexpr))
            agg_node = N.ProjectNode(
                source=agg_node, projections=tuple(projs)
            )
        return agg_node, agg_map

    def _post_agg_scope(self, agg_node, scope) -> Scope:
        """Scope after aggregation: only grouped/aggregated columns
        survive, but alias qualifiers must keep resolving for the ones
        that do (SELECT ad1.ca_city ... GROUP BY ad1.ca_city)."""
        out_cols = dict(agg_node.output_schema())
        quals = {
            q: {vis: i for vis, i in m.items() if i in out_cols}
            for q, m in scope.qualifiers.items()
        }
        quals = {q: m for q, m in quals.items() if m}
        return Scope(out_cols, quals, scope.parent)

    def _agg_bucket(self, node) -> int:
        est = optimizer.estimate_rows(node, self.catalogs)
        return bucket_capacity(max(int(est * 0.5) + 1024, 1024))

    # ------------------------------------------------------------- windows

    def _plan_windows(self, node, scope, sel: ast.Select, agg_map=None):
        # runs AFTER aggregation: window args and partition/order keys
        # may reference aggregate results (reference: Q98's
        # sum(sum(x)) over (partition by ...) — a window over the
        # grouped output), resolved through agg_map like select items
        node = self._finalize_pool(node, scope)
        lower_w = lambda x: self._lower(x, scope, agg_map=agg_map)  # noqa: E731
        calls: List[ast.FuncCall] = []

        def collect(e):
            if isinstance(e, ast.FuncCall) and e.window is not None:
                if e not in calls:
                    calls.append(e)
                return
            for c in _ast_children(e):
                collect(c)

        for it in sel.items:
            if not isinstance(it.expr, ast.Star):
                collect(it.expr)
        win_map: Dict[ast.Node, str] = {}
        by_spec: Dict[ast.Over, List[ast.FuncCall]] = {}
        for c in calls:
            by_spec.setdefault(c.window, []).append(c)
        for spec, fns in by_spec.items():
            pby = tuple(lower_w(p) for p in spec.partition_by)
            oby = tuple(
                SortKey(
                    lower_w(si.expr), si.descending, si.nulls_first
                )
                for si in spec.order_by
            )
            wcalls = []
            for f in fns:
                out_name = self._fresh("win")
                wf = functions.WINDOW.get(f.name)
                if wf is None:
                    raise PlanningError(
                        f"{f.name}() is not a window function"
                    )
                if wf.kind == "rank":
                    if f.args:
                        raise PlanningError(
                            f"{f.name}() takes no arguments"
                        )
                    wcalls.append(WindowCall(f.name, None, out_name))
                elif f.name == "count" and not f.args:
                    wcalls.append(WindowCall("count", None, out_name))
                elif wf.kind == "ntile":
                    n = self._const_int(f.args[0], "ntile bucket count")
                    wcalls.append(
                        WindowCall("ntile", None, out_name, offset=n)
                    )
                elif f.name == "nth_value":
                    if len(f.args) != 2:
                        raise PlanningError(
                            "nth_value() takes two arguments"
                        )
                    arg = lower_w(f.args[0])
                    n = self._const_int(f.args[1], "nth_value offset")
                    if n < 1:
                        raise PlanningError(
                            "nth_value offset must be >= 1"
                        )
                    wcalls.append(
                        WindowCall("nth_value", arg, out_name, offset=n)
                    )
                elif wf.kind == "nav":
                    arg = lower_w(f.args[0])
                    off = (
                        self._const_int(f.args[1], f"{f.name} offset")
                        if len(f.args) > 1
                        else 1
                    )
                    default = None
                    if len(f.args) > 2:
                        de = lower_w(f.args[2])
                        if not isinstance(de, E.Literal):
                            raise PlanningError(
                                f"{f.name} default must be a constant"
                            )
                        if de.dtype.is_string or arg.dtype.is_string:
                            # a string default needs dictionary
                            # resolution against the arg column
                            raise PlanningError(
                                f"{f.name} string defaults are not "
                                "supported yet"
                            )
                        # carry the literal as an Expr (cast to the arg
                        # type) so unit/scale handling stays in expr
                        default = (
                            de
                            if de.dtype == arg.dtype
                            else E.Cast(de, arg.dtype)
                        )
                    wcalls.append(
                        WindowCall(
                            f.name, arg, out_name,
                            offset=off, default=default,
                        )
                    )
                else:
                    # "value" (first_value/last_value) and "agg" kinds:
                    # one value argument over the frame
                    if not f.args:
                        raise PlanningError(
                            f"{f.name}() requires an argument"
                        )
                    arg = lower_w(f.args[0])
                    wcalls.append(
                        WindowCall(
                            f.name, arg, out_name,
                            frame=spec.frame or "range",
                        )
                    )
                win_map[f] = out_name
            node = N.WindowNode(node, pby, oby, tuple(wcalls))
        scope = Scope(dict(node.output_schema()), scope.qualifiers, scope.parent)
        return node, scope, win_map

    # ----------------------------------------------------- expr lowering

    def _lower_order_key(self, e, scope, projections, agg_map, win_map):
        """ORDER BY resolves output aliases first, then source scope.
        Returns an alias name (str) or a lowered Expr."""
        if isinstance(e, ast.Ident) and len(e.parts) == 1:
            for n, _ in projections:
                if n == e.parts[0]:
                    return n
        if isinstance(e, ast.NumberLit):  # ORDER BY ordinal
            idx = int(e.text) - 1
            if 0 <= idx < len(projections):
                return projections[idx][0]
            raise PlanningError(f"ORDER BY position {e.text} out of range")
        # output aliases may appear INSIDE order-key expressions
        # (Q36-class `order by case when lochierarchy = 0 ...`): lower
        # with the projection exprs as an Ident fallback
        return self._lower(
            e, scope, agg_map=agg_map, win_map=win_map,
            alias_map=dict(projections),
        )

    def _lower(
        self, e: ast.Node, scope: Scope, agg_map=None, win_map=None,
        alias_map=None,
    ) -> E.Expr:
        agg_map = agg_map or {}
        win_map = win_map or {}
        lower = lambda x: self._lower(  # noqa: E731
            x, scope, agg_map, win_map, alias_map
        )

        if e in agg_map:
            name = agg_map[e]
            return E.ColumnRef(name, scope.columns[name])
        if e in win_map:
            name = win_map[e]
            return E.ColumnRef(name, scope.columns[name])

        if isinstance(e, ast.Ident):
            try:
                name, dtype, is_outer = scope.resolve(e.parts)
            except PlanningError:
                # output-alias fallback (ORDER BY keys referencing
                # select aliases inside expressions)
                if (
                    alias_map
                    and len(e.parts) == 1
                    and e.parts[0] in alias_map
                ):
                    return alias_map[e.parts[0]]
                # row field access: the trailing part may be a field of
                # a ROW column (reference: DereferenceExpression)
                if len(e.parts) < 2:
                    raise
                base, dtype, is_outer = scope.resolve(e.parts[:-1])
                if not dtype.is_row:
                    raise
                field = e.parts[-1]
                try:
                    fi = dtype.field_index(field)
                except KeyError:
                    raise PlanningError(
                        f"row type {dtype} has no field {field}"
                    ) from None
                if is_outer:
                    raise PlanningError(
                        f"correlated reference {e} outside a supported "
                        "decorrelation pattern"
                    )
                return E.RowFieldAccess(
                    E.ColumnRef(base, dtype), field, dtype.fields[fi][1]
                )
            if is_outer:
                raise PlanningError(
                    f"correlated reference {e} outside a supported "
                    "decorrelation pattern"
                )
            return E.ColumnRef(name, dtype)
        if isinstance(e, ast.BoundParam):
            # canonicalized literal (plan/canonical.py): lower the
            # carried literal for its TYPE only — the value enters the
            # compiled program as a runtime parameter, never a constant,
            # which is exactly what makes the planned form reusable
            # across literal variants
            base = lower(e.lit)
            return E.RuntimeParam(e.ordinal, base.dtype)
        if isinstance(e, ast.NumberLit):
            return _number_literal(e.text)
        if isinstance(e, ast.StringLit):
            return E.Literal(e.value, T.VARCHAR)
        if isinstance(e, ast.NullLit):
            return E.Literal(None, T.BIGINT)
        if isinstance(e, ast.BoolLit):
            return E.Literal(e.value, T.BOOLEAN)
        if isinstance(e, ast.DateLit):
            return E.Literal(_parse_date(e.value), T.DATE)
        if isinstance(e, ast.IntervalLit):
            raise PlanningError(
                "interval literal outside date +/- interval context"
            )
        if isinstance(e, ast.UnaryOp):
            if e.op == "not":
                return E.Not(lower(e.arg))
            arg = lower(e.arg)
            if isinstance(arg, E.Literal) and arg.value is not None:
                return E.Literal(-arg.value, arg.dtype)
            return E.Negate(arg)
        if isinstance(e, ast.BinaryOp):
            if e.op == "and":
                return E.And((lower(e.left), lower(e.right)))
            if e.op == "or":
                return E.Or((lower(e.left), lower(e.right)))
            if e.op in ("=", "<>", "!=", "<", "<=", ">", ">="):
                return E.Compare(e.op, lower(e.left), lower(e.right))
            if e.op in ("+", "-"):
                # date +/- interval
                for a, b, flip in ((e.left, e.right, False), (e.right, e.left, True)):
                    if isinstance(b, ast.IntervalLit):
                        return self._date_interval(
                            lower(a), b, e.op, flip
                        )
            if e.op in ("+", "-", "*", "/", "%"):
                return E.arith(e.op, lower(e.left), lower(e.right))
            raise PlanningError(f"unsupported operator {e.op}")
        if isinstance(e, ast.CaseExpr):
            whens = []
            if e.operand is not None:
                op_l = lower(e.operand)
                for c, v in e.whens:
                    whens.append(
                        (E.Compare("=", op_l, lower(c)), lower(v))
                    )
            else:
                whens = [(lower(c), lower(v)) for c, v in e.whens]
            default = lower(e.default) if e.default is not None else None

            def _is_null_lit(x):
                return isinstance(x, E.Literal) and x.value is None

            # NULL-literal branches don't vote on the result type
            # (reference UNKNOWN coercion): `then 'label' else null`
            # stays varchar
            rtypes = [
                v.dtype for _, v in whens if not _is_null_lit(v)
            ]
            if default is not None and not _is_null_lit(default):
                rtypes.append(default.dtype)
            if not rtypes:
                rtypes = [T.BIGINT]
            rt = rtypes[0]
            for t in rtypes[1:]:
                rt = T.common_super_type(rt, t)
            whens = [
                (c, E.Literal(None, rt) if _is_null_lit(v) else v)
                for c, v in whens
            ]
            if default is not None and _is_null_lit(default):
                default = E.Literal(None, rt)
            return E.Case(tuple(whens), default, rt)
        if isinstance(e, ast.CastExpr):
            return E.Cast(lower(e.arg), T.parse_type(e.type_name))
        if isinstance(e, ast.BetweenExpr):
            return E.Between(
                lower(e.arg), lower(e.low), lower(e.high), e.negate
            )
        if isinstance(e, ast.InList):
            arg = lower(e.arg)
            vals = []
            exprs = []
            for v in e.values:
                lv = lower(v)
                lv = _fold_constant(lv)
                if not isinstance(lv, E.Literal):
                    exprs.append(lv)
                    continue
                if not arg.dtype.is_string and lv.dtype != arg.dtype:
                    lv = _coerce_literal(lv, arg.dtype)
                vals.append(lv)
            if exprs:
                # non-constant members (x IN (a, col+1, ...)): the
                # list form keeps the literals, the rest become OR'd
                # equalities (reference: InPredicate rewrite)
                terms = [
                    E.Compare("=", arg, x) for x in exprs
                ]
                if vals:
                    terms.append(
                        E.InList(arg, tuple(vals), False)
                    )
                disj = (
                    terms[0] if len(terms) == 1 else E.Or(tuple(terms))
                )
                if e.negate:
                    return E.Not(disj)
                return disj
            return E.InList(arg, tuple(vals), e.negate)
        if isinstance(e, ast.LikeExpr):
            pat = lower(e.pattern)
            if not isinstance(pat, E.Literal):
                raise PlanningError("LIKE pattern must be a literal")
            return E.Like(lower(e.arg), pat.value, e.negate)
        if isinstance(e, ast.IsNullExpr):
            return E.IsNull(lower(e.arg), e.negate)
        if isinstance(e, ast.ExtractExpr):
            return E.Extract(e.field, lower(e.arg))
        if isinstance(e, ast.ScalarSubquery):
            saved = list(self.params)
            try:
                sub = self.plan(e.query)
            except PlanningError as err:
                self.params = saved
                raise PlanningError(
                    f"scalar subquery planning failed ({err}); if the "
                    "subquery is correlated, only conjunct-level "
                    "equality-correlated comparisons are supported"
                ) from err
            if len(sub.output_names) != 1:
                raise PlanningError("scalar subquery must return one column")
            dtype = sub.root.output_schema()[sub.output_names[0]]
            pid = self._param_counter[0]
            self._param_counter[0] += 1
            self.params = saved
            self.params.append((pid, sub))
            return E.Param(pid, dtype)
        if isinstance(e, ast.FuncCall):
            if e.window is not None:
                raise PlanningError(
                    "window function in an unsupported position"
                )
            if functions.is_aggregate(e.name):
                raise PlanningError(
                    f"aggregate {e.name}() in an unsupported position"
                )
            if e.name in ("cardinality", "element_at", "contains"):
                # array functions take raw ArrayLit ASTs, not lowered
                # exprs (arrays are trace-time expression lists)
                return self._lower_array_func(e, lower)
            from presto_tpu_torch import functions as F

            try:
                return F.lower_scalar(
                    e.name, [lower(a) for a in e.args]
                )
            except F.FunctionError as err:
                raise PlanningError(str(err)) from None
        if isinstance(e, ast.ArrayLit):
            raise PlanningError(
                "ARRAY[...] is supported under UNNEST, cardinality, "
                "element_at, contains, and the [] subscript (arrays are "
                "trace-time expression lists; no physical array columns)"
            )
        raise PlanningError(f"cannot lower {type(e).__name__}")

    def _map_subscript_key(self, key: E.Expr, kt) -> E.Expr:
        """Normalize a map-subscript key into the key child's VALUE
        DOMAIN so the kernel's raw device-representation compare is
        exact (unscaled decimals would otherwise compare 10 vs 1 for
        the same value; fractional doubles would truncate onto spurious
        integer matches)."""
        if kt.is_long_decimal:
            raise PlanningError(
                "long-decimal map keys are not supported"
            )
        if key.dtype == kt:
            return key
        if kt.is_integer and key.dtype.is_integer:
            return key  # widths widen exactly in the kernel
        if (
            kt.is_integer
            and key.dtype.is_decimal
            and not key.dtype.is_long_decimal
            and isinstance(key, E.Literal)
            and key.value is not None
        ):
            # integer-valued decimal literal (m[1.0]): fold to the
            # integer it equals; fractional literals match no key
            unscaled, s = int(key.value), key.dtype.scale
            if unscaled % (10 ** s) == 0:
                return E.Literal(unscaled // (10 ** s), kt)
            return E.Literal(None, kt)  # x.5 = no integer key
        if kt.name in ("double", "real") and (
            key.dtype.is_integer or key.dtype.name in ("double", "real")
        ):
            return E.Cast(key, kt)
        if kt.is_decimal and (
            key.dtype.is_integer
            or (
                key.dtype.is_decimal
                and not key.dtype.is_long_decimal
                and key.dtype.scale <= kt.scale
            )
        ):
            # exact rescale into kt's unscaled domain
            return E.Cast(key, kt)
        if kt.is_string and key.dtype.is_string:
            return key
        raise PlanningError(
            f"map key type {kt} does not admit a subscript of type "
            f"{key.dtype} (exact-equality domains only)"
        )

    def _lower_array_func(self, e: ast.FuncCall, lower):
        """Array functions over ARRAY[...] constructors. Arrays are
        trace-time expression lists (see N.UnnestNode), so these fold
        into ordinary scalar expressions:
          cardinality(ARRAY[..k..])      -> literal k
          element_at(arr, i) / arr[i]    -> the i-th element (literal i)
                                            or a CASE chain (column i);
                                            out-of-range -> NULL (Presto
                                            element_at semantics)
          contains(arr, x)               -> OR of equality comparisons
                                            (3VL OR gives Presto's
                                            true/NULL/false behavior)
        """
        if e.args and not isinstance(e.args[0], ast.ArrayLit):
            # physical array COLUMN (reference: ArrayType columns):
            # cardinality/element_at lower to offsets-based kernels
            arg0 = lower(e.args[0])
            if arg0.dtype.is_array:
                if e.name == "cardinality":
                    if len(e.args) != 1:
                        raise PlanningError(
                            "cardinality() takes one argument"
                        )
                    return E.ArrayLength(arg0)
                if e.name == "element_at":
                    if len(e.args) != 2:
                        raise PlanningError(
                            "element_at() takes two arguments"
                        )
                    return E.ArraySubscript(arg0, lower(e.args[1]))
                raise PlanningError(
                    f"{e.name}() over physical array columns is not "
                    "supported (cardinality/element_at/unnest are)"
                )
            if arg0.dtype.is_map:
                if e.name == "cardinality":
                    return E.ArrayLength(arg0)
                if e.name == "element_at":
                    if len(e.args) != 2:
                        raise PlanningError(
                            "element_at() takes two arguments"
                        )
                    key = lower(e.args[1])
                    kt = arg0.dtype.key
                    key = self._map_subscript_key(key, kt)
                    return E.MapSubscript(arg0, key)
                raise PlanningError(
                    f"{e.name}() over map columns is not supported "
                    "(cardinality/element_at/the [] subscript are)"
                )
        if not e.args or not isinstance(e.args[0], ast.ArrayLit):
            raise PlanningError(
                f"{e.name}() requires an ARRAY[...] constructor argument"
            )
        items = e.args[0].items
        if e.name == "cardinality":
            if len(e.args) != 1:
                raise PlanningError("cardinality() takes one argument")
            return E.Literal(len(items), T.BIGINT)
        if not items:
            raise PlanningError(f"{e.name}() over empty ARRAY[]")
        els = [lower(it) for it in items]
        ct = els[0].dtype
        for el in els[1:]:
            ct = T.common_super_type(ct, el.dtype)
        els = [el if el.dtype == ct else E.Cast(el, ct) for el in els]
        if len(e.args) != 2:
            raise PlanningError(f"{e.name}() takes two arguments")
        arg = lower(e.args[1])
        if e.name == "element_at":
            k = len(els)
            if isinstance(arg, E.Literal):
                i = int(arg.value) if arg.value is not None else 0
                if 1 <= i <= k:
                    return els[i - 1]
                if -k <= i <= -1:  # Presto: negative = from the end
                    return els[k + i]
                return E.Literal(None, ct)  # out of range -> NULL
            whens = tuple(
                (
                    E.Compare("=", arg, E.Literal(i + 1, T.BIGINT)),
                    el,
                )
                for i, el in enumerate(els)
            ) + tuple(
                (
                    E.Compare("=", arg, E.Literal(i - k, T.BIGINT)),
                    el,
                )
                for i, el in enumerate(els)
            )
            return E.Case(whens, E.Literal(None, ct), ct)
        # contains(arr, x): 3VL OR over equality with each element
        if not arg.dtype.is_string and arg.dtype != ct:
            arg = E.Cast(arg, ct)
        cmps = tuple(E.Compare("=", arg, el) for el in els)
        return cmps[0] if len(cmps) == 1 else E.Or(cmps)

    def _date_interval(self, date_expr, iv: ast.IntervalLit, op, flip):
        if flip and op == "-":
            raise PlanningError("interval - date is invalid")
        n = int(iv.value) * (-1 if iv.negative else 1)
        if op == "-":
            n = -n
        if iv.unit == "day":
            if isinstance(date_expr, E.Literal):
                return E.Literal(date_expr.value + n, T.DATE)
            return E.Arithmetic("+", date_expr, E.Literal(n, T.BIGINT), T.DATE)
        # month/year shifts: constant-fold only (TPC-H always does)
        if not isinstance(date_expr, E.Literal):
            raise PlanningError(
                f"interval '{iv.value}' {iv.unit} requires a literal date"
            )
        months = n * (12 if iv.unit == "year" else 1)
        d = datetime.date(1970, 1, 1) + datetime.timedelta(
            days=int(date_expr.value)
        )
        total = d.year * 12 + (d.month - 1) + months
        y, m = divmod(total, 12)
        import calendar

        day = min(d.day, calendar.monthrange(y, m + 1)[1])
        nd = datetime.date(y, m + 1, day)
        return E.Literal(
            (nd - datetime.date(1970, 1, 1)).days, T.DATE
        )


def _ast_children(e: ast.Node):
    if not dataclasses.is_dataclass(e):
        return
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, ast.Node) and not isinstance(v, ast.Select):
            yield v
        elif isinstance(v, tuple):
            for x in v:
                if isinstance(x, ast.Node) and not isinstance(x, ast.Select):
                    yield x
                elif isinstance(x, tuple):
                    for y in x:
                        if isinstance(y, ast.Node) and not isinstance(
                            y, ast.Select
                        ):
                            yield y


def _find_scalar_subqueries(e: ast.Node) -> List["ast.ScalarSubquery"]:
    """All ScalarSubquery nodes in an expression (not descending into
    them — nesting belongs to the inner query's own planning)."""
    out: List[ast.ScalarSubquery] = []

    def walk(n):
        if isinstance(n, ast.ScalarSubquery):
            out.append(n)
            return
        for c in _ast_children(n):
            walk(c)

    walk(e)
    return out


def _fold_constant(e):
    """Fold integer Literal-Literal arithmetic (the `1999 + 1` of IN
    lists and ROLLUP windows) into one Literal; anything else passes
    through unchanged."""
    if (
        isinstance(e, E.Arithmetic)
        and e.op in ("+", "-", "*")
        and isinstance(e.left, E.Literal)
        and isinstance(e.right, E.Literal)
        and e.left.value is not None
        and e.right.value is not None
        and e.left.dtype.is_integer
        and e.right.dtype.is_integer
    ):
        a, b = int(e.left.value), int(e.right.value)
        v = a + b if e.op == "+" else (a - b if e.op == "-" else a * b)
        return E.Literal(v, e.dtype)
    return e


def _contains_select(e) -> bool:
    """True when a nested Select (sub)query appears anywhere in ``e``."""
    if isinstance(e, ast.Select):
        return True
    if not isinstance(e, ast.Node):
        return False
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, ast.Node):
            if _contains_select(v):
                return True
        elif isinstance(v, tuple):
            for x in v:
                if isinstance(x, ast.Node) and _contains_select(x):
                    return True
                if isinstance(x, tuple):
                    for y in x:
                        if isinstance(y, ast.Node) and _contains_select(y):
                            return True
    return False


def _contains_membership_subquery(e: ast.Node) -> bool:
    """True when an IN-subquery or EXISTS hides inside ``e`` (not as
    the whole conjunct — those take the semi/anti fast path); such
    conjuncts lower via mark joins."""
    if isinstance(e, (ast.InSubquery, ast.Exists)):
        return True
    if isinstance(e, ast.Select) or not isinstance(e, ast.Node):
        return False
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, ast.Node):
            if _contains_membership_subquery(v):
                return True
        elif isinstance(v, tuple):
            for x in v:
                if isinstance(
                    x, ast.Node
                ) and _contains_membership_subquery(x):
                    return True
    return False


def _split_conjuncts(e: ast.Node) -> List[ast.Node]:
    if isinstance(e, ast.BinaryOp) and e.op == "and":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _split_disjuncts(e: ast.Node) -> List[ast.Node]:
    if isinstance(e, ast.BinaryOp) and e.op == "or":
        return _split_disjuncts(e.left) + _split_disjuncts(e.right)
    return [e]


def _and_join(terms: List[ast.Node]) -> ast.Node:
    out = terms[0]
    for t in terms[1:]:
        out = ast.BinaryOp("and", out, t)
    return out


def _factor_or(c: ast.Node) -> List[ast.Node]:
    """Factor conjuncts common to every OR branch up to the top level —
    `(k=j and A) or (k=j and B)` -> `k=j and (A or B)`. This is how Q19's
    join key, repeated inside each OR arm, becomes visible to the join
    graph (reference: equivalent extraction in PushdownFilters)."""
    if not (isinstance(c, ast.BinaryOp) and c.op == "or"):
        return [c]
    branch_conjs = [_split_conjuncts(b) for b in _split_disjuncts(c)]
    common = [
        x for x in branch_conjs[0] if all(x in bc for bc in branch_conjs[1:])
    ]
    if not common:
        return [c]
    remaining = []
    all_empty = True
    for bc in branch_conjs:
        rest = [x for x in bc if x not in common]
        if rest:
            all_empty = False
            remaining.append(_and_join(rest))
        else:
            remaining.append(ast.BoolLit(True))
    if all_empty:
        return common
    reduced = remaining[0]
    for r in remaining[1:]:
        reduced = ast.BinaryOp("or", reduced, r)
    return common + [reduced]


def _number_literal(text: str) -> E.Literal:
    if "e" in text:
        return E.Literal(float(text), T.DOUBLE)
    if "." in text:
        digits = text.replace(".", "").lstrip("0") or "0"
        scale = len(text.split(".")[1])
        unscaled = int(text.replace(".", ""))
        return E.Literal(unscaled, T.decimal(max(len(digits), scale + 1), scale))
    return E.Literal(int(text), T.BIGINT)


def _coerce_literal(lit: E.Literal, to: T.DataType) -> E.Literal:
    v = lit.value
    if to.is_decimal and lit.dtype.is_integer:
        return E.Literal(int(v) * 10 ** to.scale, to)
    if to.is_decimal and lit.dtype.is_decimal:
        # decimal literals store UNSCALED values: rescale, don't retype
        shift = to.scale - lit.dtype.scale
        if shift >= 0:
            return E.Literal(int(v) * 10 ** shift, to)
        return E.Literal(int(v) // 10 ** (-shift), to)
    if to.is_integer and lit.dtype.is_integer:
        return E.Literal(int(v), to)
    if to.name == "date" and lit.dtype.is_integer:
        return E.Literal(int(v), to)
    return E.Literal(v, to)


def _parse_date(s: str) -> int:
    d = datetime.date.fromisoformat(s.strip())
    return (d - datetime.date(1970, 1, 1)).days


from presto_tpu_torch.plan import optimizer  # noqa: E402


# Deferred join pool (internal to planning; resolved before execution)


@dataclasses.dataclass(frozen=True)
class _PendingJoin(N.PlanNode):
    rels: Tuple[N.PlanNode, ...]
    scopes: Tuple[object, ...]

    def output_schema(self):
        out = {}
        for r in self.rels:
            out.update(r.output_schema())
        return out

    def children(self):
        return self.rels

"""Plan optimizer: stats estimation, structural properties, rule passes.

Reference parity: ``PlanOptimizers``' rule pipeline with
``StatsCalculator``/``CostCalculator`` inputs (SURVEY.md §2.1
"Optimizer"). Round 1 carries the load-bearing subset:

- ``estimate_rows``: cardinality estimates from connector stats with
  classic selectivity constants (drives greedy join ordering and the
  static capacity buckets XLA needs)
- ``unique_key_sets``: key-uniqueness inference (drives the PK-FK
  ``build_unique`` fast path in the join kernel)
- ``prune_columns``: column pruning down to scans (the reference's
  PruneUnreferencedOutputs), which on this engine also shrinks
  host->device staging traffic
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set

from presto_tpu_torch import expr as E
from presto_tpu_torch.plan import nodes as N

#: fallback when a predicate's shape/stats give no better signal
FILTER_SELECTIVITY = 0.33


def _column_stats(node: N.PlanNode, col: str, catalogs):
    """ColumnStats for ``col`` seen through filters/projections down to
    the scan (identity renames only), or None."""
    if isinstance(node, N.TableScanNode):
        stats = (
            catalogs.get(node.handle.catalog)
            .metadata()
            .get_table_stats(node.handle)
        )
        return (stats.columns or {}).get(col)
    if isinstance(node, N.FilterNode):
        return _column_stats(node.source, col, catalogs)
    if isinstance(node, N.ProjectNode):
        for out_name, e in node.projections:
            if out_name == col and isinstance(e, E.ColumnRef):
                return _column_stats(node.source, e.name, catalogs)
        return None
    if isinstance(node, N.JoinNode):
        # a join carries probe columns plus build payload under their
        # own names — thread through to whichever side owns the column
        # (the bushy-rescue pseudo-relation is such a tree; without
        # this its NDVs vanish and output caps explode)
        if col in node.left.output_schema():
            return _column_stats(node.left, col, catalogs)
        if col in node.right.output_schema():
            return _column_stats(node.right, col, catalogs)
        return None
    if isinstance(node, N.AggregationNode):
        # group keys carry source values through (value RANGE stats
        # stay valid; NDV can only shrink, which the consumers treat
        # as an upper bound) — the q78 CTE shape packs its 3-key
        # outer join on these
        for name, e in node.group_keys:
            if name == col and isinstance(e, E.ColumnRef):
                return _column_stats(node.source, e.name, catalogs)
        return None
    if isinstance(node, N.OutputNode):
        src = dict(node.columns).get(col)
        if src is not None:
            return _column_stats(node.source, src, catalogs)
        return None
    if isinstance(node, (N.SortNode, N.LimitNode, N.DistinctNode)):
        return _column_stats(node.source, col, catalogs)
    return None


def _conjuncts_of(e: E.Expr) -> List[E.Expr]:
    if isinstance(e, E.And):
        out: List[E.Expr] = []
        for c in e.terms:
            out.extend(_conjuncts_of(c))
        return out
    return [e]


def _one_selectivity(e: E.Expr, source: N.PlanNode, catalogs) -> float:
    """Selectivity of a single conjunct (reference: StatsCalculator's
    filter estimation — equality via 1/NDV, ranges via the value span,
    IN via |list|/NDV; shape defaults otherwise)."""
    if isinstance(e, E.Compare) and isinstance(e.left, E.ColumnRef):
        cs = _column_stats(source, e.left.name, catalogs)
        if isinstance(e.right, E.Literal) and e.right.value is not None:
            if e.op == "=" and cs and cs.distinct_count:
                return 1.0 / max(cs.distinct_count, 1.0)
            if e.op in ("<", "<=", ">", ">=") and cs and (
                cs.min_value is not None
                and cs.max_value is not None
                and cs.max_value > cs.min_value
                and isinstance(e.right.value, (int, float))
            ):
                span = cs.max_value - cs.min_value
                v = float(e.right.value)
                frac = (v - cs.min_value) / span
                if e.op in (">", ">="):
                    frac = 1.0 - frac
                return min(max(frac, 0.0), 1.0)
            if e.op == "<>":
                return 0.9
        return 0.33 if e.op != "=" else 0.1
    if isinstance(e, E.Between) and isinstance(e.arg, E.ColumnRef):
        cs = _column_stats(source, e.arg.name, catalogs)
        if (
            cs
            and cs.min_value is not None
            and cs.max_value is not None
            and cs.max_value > cs.min_value
            and isinstance(getattr(e.low, "value", None), (int, float))
            and isinstance(getattr(e.high, "value", None), (int, float))
        ):
            span = cs.max_value - cs.min_value
            frac = (float(e.high.value) - float(e.low.value)) / span
            frac = min(max(frac, 0.0), 1.0)
            return (1.0 - frac) if e.negate else frac
        return 0.25
    if isinstance(e, E.InList):
        cs = (
            _column_stats(source, e.arg.name, catalogs)
            if isinstance(e.arg, E.ColumnRef)
            else None
        )
        if cs and cs.distinct_count:
            frac = min(len(e.values) / max(cs.distinct_count, 1.0), 1.0)
            return (1.0 - frac) if e.negate else frac
        return 0.2
    if isinstance(e, E.Or):
        s = 0.0
        for t in e.terms:
            s += _one_selectivity(t, source, catalogs)
        return min(s, 1.0)
    if isinstance(e, E.Not):
        return 1.0 - _one_selectivity(e.arg, source, catalogs)
    return FILTER_SELECTIVITY


def predicate_selectivity(
    pred: E.Expr, source: N.PlanNode, catalogs
) -> float:
    s = 1.0
    for c in _conjuncts_of(pred):
        s *= _one_selectivity(c, source, catalogs)
    return max(s, 1e-6)


def estimate_rows(node: N.PlanNode, catalogs) -> float:
    """Cardinality estimate for ``node`` from connector stats /
    heuristics (the port's runner keeps no history store)."""
    return _estimate_rows_classic(node, catalogs)


def estimate_rows_with_source(
    node: N.PlanNode, catalogs, stats_memo: Optional[dict] = None
):
    """-> (rows, provenance) where provenance is ``stats`` (every
    scan under the node has connector row counts) or ``heuristic``.
    EXPLAIN renders the provenance beside each estimate — render-time
    only; the hot planning path uses :func:`estimate_rows`, which
    skips the provenance walk. Callers estimating a whole tree pass
    one ``stats_memo`` dict so each table's connector stats are
    fetched once, not once per ancestor node."""
    rows = _estimate_rows_classic(node, catalogs)
    return rows, (
        "stats"
        if _subtree_has_stats(node, catalogs, stats_memo)
        else "heuristic"
    )


def _subtree_has_stats(
    node: N.PlanNode, catalogs, memo: Optional[dict] = None
) -> bool:
    """Coarse provenance check: every scan under ``node`` reports a
    connector row count (the estimate is grounded in stats, not in
    shape defaults). ``memo`` caches per-table verdicts across calls
    — a connector whose get_table_stats does real I/O must not pay
    depth-many fetches per scan when a whole tree is estimated."""
    scans = [
        n for n in N.walk(node) if isinstance(n, N.TableScanNode)
    ]
    if not scans:
        return False
    for s in scans:
        key = (s.handle.catalog, s.handle.schema, s.handle.table)
        ok = memo.get(key) if memo is not None else None
        if ok is None:
            try:
                st = (
                    catalogs.get(s.handle.catalog)
                    .metadata()
                    .get_table_stats(s.handle)
                )
                ok = bool(st.row_count)
            except Exception:
                ok = False
            if memo is not None:
                memo[key] = ok
        if not ok:
            return False
    return True


def _estimate_rows_classic(node: N.PlanNode, catalogs) -> float:
    if isinstance(node, N.TableScanNode):
        stats = catalogs.get(node.handle.catalog).metadata().get_table_stats(
            node.handle
        )
        return stats.row_count or 1000.0
    if isinstance(node, N.ValuesNode):
        return 1.0
    if isinstance(node, N.FilterNode):
        sel = predicate_selectivity(node.predicate, node.source, catalogs)
        return max(estimate_rows(node.source, catalogs) * sel, 1.0)
    if isinstance(node, (N.ProjectNode, N.WindowNode, N.OutputNode)):
        return estimate_rows(node.source, catalogs)
    if isinstance(node, N.AggregationNode):
        src = estimate_rows(node.source, catalogs)
        if not node.group_keys:
            return 1.0
        # groups = product of key NDVs when stats know them (capped by
        # the input rows), else the classic 10% guess
        ndv = 1.0
        known = True
        for _, e in node.group_keys:
            if isinstance(e, E.ColumnRef):
                cs = _column_stats(node.source, e.name, catalogs)
                if cs and cs.distinct_count:
                    ndv *= cs.distinct_count
                    continue
            known = False
            break
        groups = ndv if known else src * 0.1
        return max(min(groups, src, float(node.max_groups)), 1.0)
    if isinstance(node, N.DistinctNode):
        return max(estimate_rows(node.source, catalogs) * 0.5, 1.0)
    if isinstance(node, N.SortNode):
        src = estimate_rows(node.source, catalogs)
        return min(src, node.limit) if node.limit else src
    if isinstance(node, N.LimitNode):
        return min(estimate_rows(node.source, catalogs), node.count)
    if isinstance(node, N.UnnestNode):
        if node.array_column is not None:
            return estimate_rows(node.source, catalogs) * 4.0
        return estimate_rows(node.source, catalogs) * len(node.elements)
    if isinstance(node, N.UnionAllNode):
        return sum(estimate_rows(s, catalogs) for s in node.sources)
    if isinstance(node, N.JoinNode):
        probe = estimate_rows(node.left, catalogs)
        if node.join_type in ("semi", "anti"):
            return max(probe * 0.5, 1.0)
        if node.build_unique:
            return probe
        build = estimate_rows(node.right, catalogs)
        return max(probe, build)
    # unknown node (e.g. planner-internal): be conservative
    total = 1.0
    for c in node.children():
        total *= max(estimate_rows(c, catalogs), 1.0)
    return total


def unique_key_sets(node: N.PlanNode, catalogs) -> List[FrozenSet[str]]:
    """Column sets guaranteed unique per row of ``node`` (PK inference)."""
    if isinstance(node, N.TableScanNode):
        stats = catalogs.get(node.handle.catalog).metadata().get_table_stats(
            node.handle
        )
        out = []
        # NDV stats are ESTIMATES (FK columns report min(ref, n), which
        # equals the row count whenever the referenced table is bigger
        # — e.g. 1000 customers drawing from 5600 demographics rows
        # have ~917 DISTINCT values while stats claim 1000). Inferring
        # uniqueness from them made join kernels keep ONE match per
        # probe row and silently drop the rest; only declared primary
        # keys prove uniqueness.
        if stats.primary_key and all(
            c in node.columns for c in stats.primary_key
        ):
            pk = frozenset(stats.primary_key)
            if pk not in out:
                out.append(pk)
        return out
    if isinstance(node, N.FilterNode):
        return unique_key_sets(node.source, catalogs)
    if isinstance(node, (N.SortNode, N.LimitNode, N.WindowNode)):
        return unique_key_sets(node.source, catalogs)
    if isinstance(node, N.ProjectNode):
        # identity projections propagate uniqueness through renames
        rename: Dict[str, str] = {}
        for out_name, e in node.projections:
            if isinstance(e, E.ColumnRef):
                rename.setdefault(e.name, out_name)
        child = unique_key_sets(node.source, catalogs)
        out = []
        for ks in child:
            if all(k in rename for k in ks):
                out.append(frozenset(rename[k] for k in ks))
        return out
    if isinstance(node, N.OutputNode):
        child = unique_key_sets(node.source, catalogs)
        rename = {src: out for out, src in node.columns}
        out = []
        for ks in child:
            if all(k in rename for k in ks):
                out.append(frozenset(rename[k] for k in ks))
        return out
    if isinstance(node, N.AggregationNode):
        if node.group_keys:
            return [frozenset(n for n, _ in node.group_keys)]
        return [frozenset()]  # single row
    if isinstance(node, N.DistinctNode):
        return [frozenset(node.output_schema())]
    if isinstance(node, N.JoinNode):
        if node.join_type in ("semi", "anti"):
            return unique_key_sets(node.left, catalogs)
        if node.build_unique:
            return unique_key_sets(node.left, catalogs)
        return []
    return []


def is_build_unique(
    build: N.PlanNode, build_keys, catalogs
) -> bool:
    keys = set(build_keys)
    for ks in unique_key_sets(build, catalogs):
        if ks <= keys:
            return True
    return False


# ------------------------------------------------------------ column pruning


def _expr_columns(e: E.Expr, out: Set[str]) -> None:
    if isinstance(e, E.ColumnRef):
        out.add(e.name)
    for c in e.children():
        _expr_columns(c, out)


def normalize_interior_outputs(
    node: N.PlanNode, is_root: bool = True
) -> N.PlanNode:
    """Rewrite non-root OutputNodes (subquery relations keep one from
    plan_select) into plain projections: an interior Output is just a
    column select/rename, and leaving it blocks the fragmenter's
    distributable-subtree detection and the fragment-weight model."""
    node = N.map_children(
        node, lambda c: normalize_interior_outputs(c, is_root=False)
    )
    if not is_root and isinstance(node, N.OutputNode):
        src_schema = node.source.output_schema()
        return N.ProjectNode(
            source=node.source,
            projections=tuple(
                (out, E.ColumnRef(col, src_schema[col]))
                for out, col in node.columns
            ),
        )
    return node


def prune_columns(node: N.PlanNode, required: Optional[Set[str]] = None):
    """Drop unused columns, pushing requirements down to scans
    (reference: PruneUnreferencedOutputs / pushdown of column sets into
    ConnectorPageSource — SURVEY.md §2.2 pushdown surface)."""
    if required is None:
        node = normalize_interior_outputs(node)
    if isinstance(node, N.OutputNode):
        need = {src for _, src in node.columns}
        return dataclasses.replace(
            node, source=prune_columns(node.source, need)
        )
    if required is None:
        required = set(node.output_schema())

    if isinstance(node, N.TableScanNode):
        cols = tuple(c for c in node.columns if c in required) or node.columns[:1]
        return dataclasses.replace(
            node,
            columns=cols,
            schema=tuple((n, t) for n, t in node.schema if n in cols),
        )
    if isinstance(node, N.FilterNode):
        need = set(required)
        _expr_columns(node.predicate, need)
        return dataclasses.replace(
            node, source=prune_columns(node.source, need)
        )
    if isinstance(node, N.ProjectNode):
        # keep at least one projection (same fallback as scans): a
        # zero-column page has capacity 0 and loses its row count
        # (count(*) over a fully-pruned union/subquery)
        projs = tuple(
            (n, e) for n, e in node.projections if n in required
        ) or node.projections[:1]
        need: Set[str] = set()
        for _, e in projs:
            _expr_columns(e, need)
        return dataclasses.replace(
            node,
            projections=projs,
            source=prune_columns(node.source, need),
        )
    if isinstance(node, N.AggregationNode):
        need: Set[str] = set()
        for _, e in node.group_keys:
            _expr_columns(e, need)
        for a in node.aggs:
            if a.arg is not None:
                _expr_columns(a.arg, need)
            if a.arg2 is not None:  # min_by/max_by ordering argument
                _expr_columns(a.arg2, need)
        return dataclasses.replace(
            node, source=prune_columns(node.source, need)
        )
    if isinstance(node, N.JoinNode):
        rename = dict(node.payload_rename)
        lneed = {c for c in required if c in node.left.output_schema()}
        lneed.update(node.left_keys)
        inv = {rename.get(c, c): c for c in node.payload}
        rneed = {
            inv[c] for c in required if c in inv
        }
        rneed.update(node.right_keys)
        if node.residual is not None:
            resid_cols: Set[str] = set()
            _expr_columns(node.residual, resid_cols)
            lsch = node.left.output_schema()
            for c in resid_cols:
                if c in lsch:
                    lneed.add(c)
                elif c in inv:
                    rneed.add(inv[c])
                else:
                    rneed.add(c)
        payload = tuple(
            c for c in node.payload
            if rename.get(c, c) in required or c in rneed
        )
        return dataclasses.replace(
            node,
            left=prune_columns(node.left, lneed),
            right=prune_columns(node.right, rneed),
            payload=payload,
        )
    if isinstance(node, N.CrossJoinNode):
        # each side keeps the required columns it outputs (the
        # reference stops pruning here, so every scan under a cross
        # join, such as a global count(distinct) beside other
        # aggregates, would read all of its columns); a side left with
        # none keeps its fallback column, and with it its row count
        return dataclasses.replace(
            node,
            left=prune_columns(
                node.left, set(required) & set(node.left.output_schema())
            ),
            right=prune_columns(
                node.right, set(required) & set(node.right.output_schema())
            ),
        )
    if isinstance(node, N.SortNode):
        need = set(required)
        for k in node.keys:
            _expr_columns(k.expr, need)
        return dataclasses.replace(
            node, source=prune_columns(node.source, need)
        )
    if isinstance(node, N.LimitNode):
        return dataclasses.replace(
            node, source=prune_columns(node.source, set(required))
        )
    if isinstance(node, N.DistinctNode):
        return dataclasses.replace(
            node, source=prune_columns(node.source, set(node.source.output_schema()))
        )
    if isinstance(node, N.WindowNode):
        need = set(required) - {c.out_name for c in node.calls}
        for e in node.partition_by:
            _expr_columns(e, need)
        for k in node.order_by:
            _expr_columns(k.expr, need)
        for c in node.calls:
            if c.arg is not None:
                _expr_columns(c.arg, need)
        # window preserves all source columns; required source cols only
        return dataclasses.replace(
            node, source=prune_columns(node.source, need)
        )
    if isinstance(node, N.UnnestNode):
        need = set(required) - {node.out_name, node.ordinality_name}
        for e in node.elements:
            _expr_columns(e, need)
        if node.array_column is not None:
            need.add(node.array_column)
        return dataclasses.replace(
            node, source=prune_columns(node.source, need)
        )
    if isinstance(node, N.UnionAllNode):
        # sources share the same output names by construction
        return dataclasses.replace(
            node,
            sources=tuple(
                prune_columns(s, set(required)) for s in node.sources
            ),
        )
    if isinstance(node, N.ValuesNode):
        return node
    return node


def push_scan_constraints(node: N.PlanNode) -> N.PlanNode:
    """TupleDomain-lite pushdown (reference: PickTableLayout pushing
    TupleDomain into the split manager): collect ``col = literal`` and
    ``col IN (literals)`` conjuncts from FilterNodes sitting directly
    above a scan (through other filters) and annotate the scan's
    ``constraint``. The filter stays in place — the constraint only
    lets connectors skip splits (hive partition pruning); ignoring it
    is always correct."""
    if isinstance(node, N.FilterNode):
        chain = [node]
        src = node.source
        while isinstance(src, N.FilterNode):
            chain.append(src)
            src = src.source
        if isinstance(src, N.TableScanNode):
            domains: Dict[str, tuple] = {}
            for f in chain:
                for c in _conjuncts_of(f.predicate):
                    col_vals = _equality_domain(c)
                    if col_vals is None:
                        continue
                    col, vals = col_vals
                    if col in domains:
                        vals = tuple(
                            v for v in vals if v in set(domains[col])
                        )
                    domains[col] = vals
            if domains:
                scan = dataclasses.replace(
                    src,
                    constraint=tuple(sorted(domains.items())),
                )
                rebuilt: N.PlanNode = scan
                for f in reversed(chain):
                    rebuilt = dataclasses.replace(f, source=rebuilt)
                return rebuilt
        return dataclasses.replace(
            node, source=push_scan_constraints(node.source)
        )
    if not node.children():
        return node
    return N.map_children(node, push_scan_constraints)


def _equality_domain(e: E.Expr):
    """ColumnRef = Literal  /  ColumnRef IN (literals)  ->
    (column, values) or None. Only integer- and string-typed literals
    become domains: a decimal literal's stored value is UNSCALED (2024.0
    -> 20240), so passing it through would prune wrongly — those
    predicates simply stay unpruned filters."""
    if (
        isinstance(e, E.Compare)
        and e.op == "="
        and isinstance(e.left, E.ColumnRef)
        and _domain_value(e.right) is not None
    ):
        return e.left.name, (_domain_value(e.right),)
    if (
        isinstance(e, E.Compare)
        and e.op == "="
        and isinstance(e.right, E.ColumnRef)
        and _domain_value(e.left) is not None
    ):
        return e.right.name, (_domain_value(e.left),)
    if (
        isinstance(e, E.InList)
        and not e.negate
        and isinstance(e.arg, E.ColumnRef)
        and all(_domain_value(v) is not None for v in e.values)
    ):
        return e.arg.name, tuple(_domain_value(v) for v in e.values)
    return None


def _domain_value(lit: E.Expr):
    """Literal -> the value a connector compares partition keys
    against, or None when the literal cannot safely become a domain
    (non-literal, NULL, or a scaled-decimal whose stored value is the
    unscaled integer)."""
    if not isinstance(lit, E.Literal) or lit.value is None:
        return None
    if lit.dtype.is_string:
        return str(lit.value)
    if lit.dtype.is_integer:
        return lit.value
    return None

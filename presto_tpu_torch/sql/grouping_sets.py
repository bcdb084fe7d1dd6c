"""GROUPING SETS / ROLLUP / CUBE desugaring.

One shared rewrite consumed by BOTH the planner and the sqlite oracle
renderer: a Select whose GROUP BY carries ast.GroupingSets becomes an
outer Select over a UNION ALL of per-set aggregation branches —

  select <items with aggs/grouping() replaced by column refs>
  from (
    branch per grouping set S:
      select <group col if in S else NULL> ...,
             <each aggregate> as __aggI ...,
             <each grouping(...) call's constant value> as __grpJ ...
      from <original FROM> where <original WHERE> group by S
    union all ...
  )
  where <original HAVING, rewritten>
  order by / limit <original, rewritten>

This is the reference's GroupIdNode + repeated-source expansion
(SURVEY.md §2.1 planner) expressed as plain relational algebra: each
grouping set aggregates the source rows directly, absent group columns
are NULL, and grouping(c1..ck) is a per-branch constant bitmask (bit
k-1-i set when c_i is NOT in the set — Presto semantics). sqlite has
no native grouping sets, so the oracle renders the SAME desugared tree,
giving an independent execution of identical semantics.

Window functions in the select list survive the rewrite: they evaluate
in the outer select over the unioned relation, so frames/partitions
span grouping sets exactly as the standard requires (Q36/Q67/Q70/Q86's
rank() within parent).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from presto_tpu_torch.sql import ast


def has_grouping_sets(sel: ast.Select) -> bool:
    return any(isinstance(g, ast.GroupingSets) for g in sel.group_by)


def desugar_select(sel: ast.Select) -> ast.Select:
    """Return ``sel`` unchanged unless its GROUP BY carries grouping
    sets; otherwise the expanded plain-SQL equivalent."""
    if not has_grouping_sets(sel):
        return sel

    # cross product of per-element set lists: GROUP BY a, ROLLUP(b, c)
    # = sets {a}x{(b,c),(b),()}
    element_sets: List[List[Tuple[ast.Node, ...]]] = []
    for g in sel.group_by:
        if isinstance(g, ast.GroupingSets):
            element_sets.append([tuple(s) for s in g.sets])
        else:
            element_sets.append([(g,)])
    combos: List[Tuple[ast.Node, ...]] = [()]
    for opts in element_sets:
        combos = [c + o for c in combos for o in opts]
    # each set becomes a full aggregation branch re-reading the source
    # (no GroupIdNode row-replication yet), so bound the expansion the
    # way the reference bounds grouping-set count
    if len(combos) > 64:
        raise ValueError(
            f"{len(combos)} grouping sets exceed the supported "
            "maximum of 64 (each set is one aggregation branch)"
        )
    sets: List[Tuple[ast.Node, ...]] = []
    for c in combos:
        seen, out = set(), []
        for e in c:
            if e not in seen:
                seen.add(e)
                out.append(e)
        sets.append(tuple(out))

    # group columns in first-appearance order; plain column refs only
    group_cols: List[ast.Node] = []
    for s in sets:
        for e in s:
            if e not in group_cols:
                group_cols.append(e)
    names: Dict[ast.Node, str] = {}
    for e in group_cols:
        if not isinstance(e, ast.Ident):
            raise ValueError(
                "grouping sets elements must be plain column "
                f"references, got {e!r}"
            )
        nm = e.parts[-1]
        if nm in names.values():
            raise ValueError(
                f"ambiguous grouping-set column name {nm!r}"
            )
        names[e] = nm

    # aggregates + grouping() calls used anywhere downstream of the agg
    aggs: Dict[ast.Node, None] = {}
    grps: Dict[ast.Node, None] = {}
    for it in sel.items:
        _collect(it.expr, aggs, grps)
    if sel.having is not None:
        _collect(sel.having, aggs, grps)
    for s in sel.order_by:
        _collect(s.expr, aggs, grps)
    agg_list = list(aggs)
    grp_list = list(grps)
    for g in grp_list:
        for a in g.args:
            if a not in names:
                raise ValueError(
                    f"grouping() argument {a} is not a grouping-set "
                    "column"
                )

    branches: List[ast.Select] = []
    for s in sets:
        in_set = set(s)
        items: List[ast.SelectItem] = []
        for col in group_cols:
            items.append(
                ast.SelectItem(
                    expr=col if col in in_set else ast.NullLit(),
                    alias=names[col],
                )
            )
        for i, a in enumerate(agg_list):
            items.append(ast.SelectItem(expr=a, alias=f"__agg{i}"))
        for j, g in enumerate(grp_list):
            k = len(g.args)
            val = sum(
                1 << (k - 1 - i)
                for i, a in enumerate(g.args)
                if a not in in_set
            )
            items.append(
                ast.SelectItem(
                    expr=ast.NumberLit(str(val)), alias=f"__grp{j}"
                )
            )
        branches.append(
            ast.Select(
                items=tuple(items),
                from_=sel.from_,
                where=sel.where,
                group_by=s,
            )
        )

    mapping: Dict[ast.Node, ast.Node] = {}
    for col in group_cols:
        mapping[col] = ast.Ident((names[col],))
    for i, a in enumerate(agg_list):
        mapping[a] = ast.Ident((f"__agg{i}",))
    for j, g in enumerate(grp_list):
        mapping[g] = ast.Ident((f"__grp{j}",))

    def fn(n: ast.Node) -> ast.Node:
        return mapping.get(n, n)

    out_items = tuple(
        ast.SelectItem(_transform(it.expr, fn), it.alias)
        for it in sel.items
    )
    union = ast.UnionRel(
        terms=tuple(branches),
        ops=("union_all",) * (len(branches) - 1),
    )
    return ast.Select(
        items=out_items,
        from_=union,
        where=(
            _transform(sel.having, fn)
            if sel.having is not None
            else None
        ),
        group_by=(),
        having=None,
        order_by=tuple(
            dataclasses.replace(s, expr=_transform(s.expr, fn))
            for s in sel.order_by
        ),
        limit=sel.limit,
        distinct=sel.distinct,
        ctes=sel.ctes,
    )


def desugar_tree(node):
    """Desugar every Select reachable in a statement tree (CTE bodies,
    subqueries, union terms) — the whole-statement entry the sqlite
    renderer uses; the planner instead desugars per-Select at
    plan_select."""
    if isinstance(node, tuple):
        return tuple(desugar_tree(x) for x in node)
    if not isinstance(node, ast.Node):
        return node
    kwargs = {}
    changed = False
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        nv = desugar_tree(v)
        kwargs[f.name] = nv
        changed |= nv is not v
    if changed:
        node = dataclasses.replace(node, **kwargs)
    if isinstance(node, ast.Select):
        node = desugar_select(node)
    return node


# ------------------------------------------------------------- internals


def _agg_names() -> set:
    from presto_tpu_torch import functions as F

    return set(F.AGGREGATE)


def _collect(node, aggs: Dict, grps: Dict) -> None:
    """Find aggregate calls and grouping() calls; does not descend
    into nested Select bodies (their aggregates are their own) nor
    into a matched aggregate's arguments."""
    if isinstance(node, tuple):
        for x in node:
            _collect(x, aggs, grps)
        return
    if isinstance(node, ast.Select) or not isinstance(node, ast.Node):
        return
    if isinstance(node, ast.FuncCall) and node.window is None:
        name = node.name.lower()
        if name == "grouping":
            grps.setdefault(node)
            return
        if name in _agg_names():
            aggs.setdefault(node)
            return
    for f in dataclasses.fields(node):
        _collect(getattr(node, f.name), aggs, grps)


def _transform(node, fn):
    """Top-down rebuild applying ``fn``; a replaced node is not
    descended into, and nested Select bodies are left untouched."""
    if isinstance(node, tuple):
        return tuple(_transform(x, fn) for x in node)
    if isinstance(node, ast.Select) or not isinstance(node, ast.Node):
        return node
    out = fn(node)
    if out is not node:
        return out
    kwargs = {}
    changed = False
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        nv = _transform(v, fn)
        kwargs[f.name] = nv
        changed |= nv is not v
    return dataclasses.replace(node, **kwargs) if changed else node

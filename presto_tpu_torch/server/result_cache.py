"""The MV-aware scan rewrite of the serving plane's result reuse: a
copy of ``mview_rewrite`` and its helpers from the reference's
``presto_tpu/server/result_cache.py`` (tier (b) there). The module
keeps the reference's name so the counterpart is easy to find; its
snapshot-keyed ``ResultCache`` (tiers (a) and (c)), ``statement_key``
and ``snapshot_vector`` come with the server.

(b) **MV-aware rewrite** (:func:`mview_rewrite`): an eligible
    single-table aggregate SELECT whose shape matches a registered
    materialized view rewrites its scan onto the maintained MV without
    the reader naming it, under the same ``mview.max-staleness-s``
    read-gate discipline named reads get. With the gate off, only a
    provably-current view (base write epoch covered by the view
    state) rewrites — a reader of the BASE table never silently gets
    unbounded staleness it did not opt into.

Everything fails OPEN: any error in rewriting degrades to normal
planning + execution, never to a failed query.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

from presto_tpu_torch.utils.metrics import REGISTRY


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

"""Fused filter + project over a Page.

The PyTorch counterpart of ``presto_tpu/ops/filter_project.py``. The
filter is LAZY by default: survivors stay in place and the output page
carries the selection mask (``Page.live``), because downstream operators
read ``row_mask()`` anyway and a gather would cost a full pass per
column. ``lazy=False`` or an ``out_capacity`` compacts survivors to the
front with the sync-free ``nonzero_static``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from presto_tpu_torch.expr import ColumnRef, Expr, ExprLowerer, eval_predicate
from presto_tpu_torch.page import Block, Page, compact_page, nonzero_static


def project(
    page: Page, projections: Sequence[Tuple[str, Expr]]
) -> Page:
    """Pure projection (no selection)."""
    lowerer = ExprLowerer(page)
    names, blocks = [], []
    for name, expr in projections:
        if isinstance(expr, ColumnRef) and expr.dtype.is_nested:
            blocks.append(page.block(expr.name))
            names.append(name)
            continue
        data, valid = lowerer.eval(expr)
        data = torch.broadcast_to(data, _col_shape(page, expr))
        if valid is not None:
            valid = torch.broadcast_to(valid, (page.capacity,))
        blocks.append(
            Block(
                data=data,
                valid=valid,
                dtype=expr.dtype,
                dictionary=(
                    lowerer.dictionary_of(expr)
                    if expr.dtype.is_string
                    else None
                ),
            )
        )
        names.append(name)
    return Page(
        blocks=tuple(blocks),
        num_valid=page.num_valid,
        names=tuple(names),
        live=page.live,
    )


def _col_shape(page: Page, expr: Expr):
    """Column data shape: long decimals carry (capacity, 2) limb pairs."""
    if expr.dtype.is_long_decimal:
        return (page.capacity, 2)
    return (page.capacity,)


def filter_project(
    page: Page,
    predicate: Optional[Expr],
    projections: Sequence[Tuple[str, Expr]],
    out_capacity: Optional[int] = None,
    lazy: bool = True,
) -> Page:
    """Filter by ``predicate`` (None = keep all live rows), then project.

    ``lazy=True`` (default) returns the masked form (rows in place,
    ``Page.live`` selection mask) — no gather. ``lazy=False`` compacts
    survivors to the front. Output capacity defaults to input capacity;
    a smaller ``out_capacity`` implies eager compaction."""
    if predicate is None:
        out = project(page, projections)
        if out_capacity is not None and out_capacity != page.capacity:
            out = compact_page(out, out_capacity)
        return out

    # eval_predicate already ANDs row_mask(), which honors Page.live
    mask = eval_predicate(predicate, page)
    count = torch.sum(mask).to(torch.int32)

    if lazy and out_capacity is None:
        out = project(page, projections)
        return dataclasses.replace(out, num_valid=count, live=mask)

    cap = out_capacity if out_capacity is not None else page.capacity
    sel = nonzero_static(mask, cap, fill_value=0)

    lowerer = ExprLowerer(page)
    names, blocks = [], []
    for name, expr in projections:
        if expr.dtype.is_nested:
            raise NotImplementedError(
                f"{expr.dtype} columns: later slice of the port"
            )
        data, valid = lowerer.eval(expr)
        data = torch.broadcast_to(data, _col_shape(page, expr))[sel]
        if valid is not None:
            valid = torch.broadcast_to(valid, (page.capacity,))[sel]
        blocks.append(
            Block(
                data=data,
                valid=valid,
                dtype=expr.dtype,
                dictionary=(
                    lowerer.dictionary_of(expr)
                    if expr.dtype.is_string
                    else None
                ),
            )
        )
        names.append(name)
    return Page(
        blocks=tuple(blocks),
        num_valid=torch.clamp(count, max=cap).to(torch.int32),
        names=tuple(names),
    )

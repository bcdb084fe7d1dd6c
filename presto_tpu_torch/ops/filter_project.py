"""Fused filter + project over a Page.

The PyTorch counterpart of ``presto_tpu/ops/filter_project.py``. The
filter is LAZY by default: survivors stay in place and the output page
carries the selection mask (``Page.live``), because downstream operators
read ``row_mask()`` anyway and a gather would cost a full pass per
column. ``lazy=False`` or an ``out_capacity`` compacts survivors to the
front with the sync-free ``nonzero_static``; nested columns pass
through a projection whole and follow their rows through a compaction.
``union_all`` concatenates pages for UNION ALL (and the set operations
the planner builds on it). ``unnest`` and ``unnest_column`` are CROSS
JOIN UNNEST: a static-width expansion over ARRAY[...] expressions, and
the length expansion of a physical array column.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.expr import (
    ColumnRef,
    Expr,
    ExprLowerer,
    Literal,
    eval_predicate,
    remap_ids,
    union_dictionaries,
)
from presto_tpu_torch.page import (
    Block,
    Dictionary,
    Page,
    compact_page,
    gather_block,
    nonzero_static,
)


def project(
    page: Page, projections: Sequence[Tuple[str, Expr]]
) -> Page:
    """Pure projection (no selection)."""
    lowerer = ExprLowerer(page)
    names, blocks = [], []
    for name, expr in projections:
        if isinstance(expr, ColumnRef) and expr.dtype.is_nested:
            # array/map/row columns pass through whole; a non-identity
            # nested expression has no lane form
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
        if isinstance(expr, ColumnRef) and expr.dtype.is_nested:
            blocks.append(gather_block(page.block(expr.name), sel, count))
            names.append(name)
            continue
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


def unnest(
    page: Page,
    elements: Sequence[Expr],
    out_name: str,
    out_type,
    ordinality_name: Optional[str] = None,
) -> Page:
    """CROSS JOIN UNNEST(ARRAY[e1..ek]): a static-width row expansion.

    Every input row yields exactly k = len(elements) output rows, so the
    output capacity is ``capacity * k`` (not a power of two in general)
    and the expansion is repeat/stack/reshape: row i expands to rows
    [i*k, (i+1)*k), parent columns repeat, the unnest column interleaves
    the k element values, ordinality tiles 1..k. An output row is live
    iff its parent row is; a NULL element is a row with a NULL value.
    String elements from different dictionaries (columns, literals)
    re-encode into the sorted union of their dictionaries."""
    k = len(elements)
    cap = page.capacity
    dev = page.device
    lowerer = ExprLowerer(page)
    shape = (cap, 2) if out_type.is_long_decimal else (cap,)
    datas, valids, dicts = [], [], []
    for el in elements:
        if out_type.is_string and isinstance(el, Literal):
            # a bare string literal has no dictionary in the page: a
            # one-entry dictionary (or none for NULL)
            datas.append(torch.zeros((cap,), dtype=torch.int32, device=dev))
            if el.value is None:
                valids.append(torch.zeros((cap,), dtype=torch.bool, device=dev))
                dicts.append(None)
            else:
                valids.append(None)
                dicts.append(Dictionary(np.asarray([el.value], dtype=object)))
            continue
        d, v = lowerer.eval(el)
        datas.append(torch.broadcast_to(d, shape))
        valids.append(None if v is None else torch.broadcast_to(v, (cap,)))
        dicts.append(lowerer.dictionary_of(el) if out_type.is_string else None)

    out_dict = None
    if out_type.is_string:
        out_dict, luts = union_dictionaries(dicts)
        datas = [remap_ids(ids, lut) for ids, lut in zip(datas, luts)]

    def expand(x):
        # repeat ROWS (long decimals are (cap, 2) limb pairs)
        return x.unsqueeze(1).expand((cap, k) + x.shape[1:]).reshape(
            (cap * k,) + x.shape[1:]
        )

    # a nested column repeats by a row gather, each row k times (the
    # reference repeats the flat tensors and loses the offsets and
    # children)
    rep_rows = torch.arange(cap * k, device=dev) // k
    blocks = [
        gather_block(blk, rep_rows, cap * k, repeats=k)
        if blk.dtype.is_nested
        else dataclasses.replace(
            blk,
            data=expand(blk.data),
            valid=None if blk.valid is None else expand(blk.valid),
        )
        for blk in page.blocks
    ]
    names = list(page.names)
    # interleave the k element columns: (cap, k, ...) -> (cap*k, ...)
    el_data = torch.stack(datas, dim=1).reshape((cap * k,) + shape[1:])
    el_valid = None
    if any(v is not None for v in valids):
        el_valid = torch.stack(
            [
                torch.ones((cap,), dtype=torch.bool, device=dev)
                if v is None
                else v
                for v in valids
            ],
            dim=1,
        ).reshape(cap * k)
    blocks.append(
        Block(data=el_data, valid=el_valid, dtype=out_type, dictionary=out_dict)
    )
    names.append(out_name)
    if ordinality_name is not None:
        blocks.append(
            Block(
                data=torch.arange(1, k + 1, dtype=torch.int64, device=dev)
                .repeat(cap),
                valid=None,
                dtype=T.BIGINT,
            )
        )
        names.append(ordinality_name)
    return Page(
        blocks=tuple(blocks),
        num_valid=(page.num_valid * k).to(torch.int32),
        names=tuple(names),
        live=expand(page.row_mask()),
    )


def unnest_column(
    page: Page,
    array_column: str,
    out_name: str,
    out_type,
    ordinality_name: Optional[str],
    out_capacity: int,
) -> Tuple[Page, torch.Tensor]:
    """UNNEST of a physical array column: each live row with a non-NULL
    array yields one output row per element (the prefix-sum +
    inverse-searchsorted expansion), under the capacity-bucket protocol.
    Returns (page, overflow); the runner re-runs at a bigger bucket on
    overflow. Nested columns do not ride through (the planner's
    ``UnnestNode.output_schema`` drops them the same way)."""
    blk = page.block(array_column)
    off = blk.offsets.to(torch.int64)
    live = page.row_mask()
    if blk.valid is not None:
        live = live & blk.valid
    counts = torch.where(live, off[1:] - off[:-1], 0)
    total = torch.cumsum(counts, dim=0)
    out_count = total[-1]
    j = torch.arange(out_capacity, dtype=torch.int64, device=page.device)
    p_idx = torch.clamp(
        torch.searchsorted(total, j, right=True), max=page.capacity - 1
    )
    offset = j - torch.where(
        p_idx > 0, total[torch.clamp(p_idx - 1, min=0)], 0
    )  # position within the parent row's array
    vcap = max(blk.data.shape[0], 1)
    src = torch.clamp(off[p_idx] + offset, 0, vcap - 1)

    blocks, names = [], []
    for name, b in zip(page.names, page.blocks):
        if b.offsets is not None or b.children is not None:
            continue
        blocks.append(
            dataclasses.replace(
                b,
                data=b.data[p_idx],
                valid=None if b.valid is None else b.valid[p_idx],
            )
        )
        names.append(name)
    blocks.append(
        Block(
            data=blk.data[src], valid=None, dtype=out_type,
            dictionary=blk.dictionary,
        )
    )
    names.append(out_name)
    if ordinality_name is not None:
        blocks.append(Block(data=offset + 1, valid=None, dtype=T.BIGINT))
        names.append(ordinality_name)
    return (
        Page(
            blocks=tuple(blocks),
            num_valid=torch.clamp(out_count, max=out_capacity).to(torch.int32),
            names=tuple(names),
        ),
        out_count > out_capacity,
    )


def union_all(pages: Sequence[Page]) -> Page:
    """UNION ALL: concatenate pages (capacities add, liveness
    concatenates as masks, no compaction). The planner aligns the inputs'
    names and types; a string column re-encodes every input's ids into
    the sorted union of their dictionaries through a host LUT."""
    first = pages[0]
    dev = first.device
    blocks = []
    for ci, name in enumerate(first.names):
        blks = [p.blocks[ci] for p in pages]
        dtype = first.blocks[ci].dtype
        if dtype.is_nested:
            raise NotImplementedError(
                f"nested column {name} through UNION is not supported"
            )
        dictionary = None
        datas = [b.data for b in blks]
        if dtype.is_string:
            dictionary, luts = union_dictionaries(
                [b.dictionary for b in blks]
            )
            datas = [remap_ids(d, lut) for d, lut in zip(datas, luts)]
        valid = None
        if any(b.valid is not None for b in blks):
            valid = torch.cat([
                b.valid if b.valid is not None else torch.ones(
                    (b.capacity,), dtype=torch.bool, device=dev
                )
                for b in blks
            ])
        blocks.append(
            Block(data=torch.cat(datas), valid=valid, dtype=dtype,
                  dictionary=dictionary)
        )
    return Page(
        blocks=tuple(blocks),
        num_valid=torch.stack([p.num_valid for p in pages]).sum().to(
            torch.int32
        ),
        names=first.names,
        live=torch.cat([p.row_mask() for p in pages]),
    )

"""Ordering operators: ORDER BY, TopN, LIMIT, DISTINCT.

The PyTorch counterpart of ``presto_tpu/ops/sort.py``: every ordering
is a stable multi-key int64 sort (``ops/common.py``); TopN slices the
sorted permutation; DISTINCT is a group-by with no aggregates. The root
ORDER BY / LIMIT of a query usually runs host-side instead
(``exec/host_ops.py``); these run the ones inside a plan.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from presto_tpu_torch.exec.staging import bucket_capacity
from presto_tpu_torch.expr import ColumnRef, Expr, eval_expr
from presto_tpu_torch.ops.aggregation import hash_aggregate
from presto_tpu_torch.ops.common import sort_order
from presto_tpu_torch.page import Page, compact_page


@dataclasses.dataclass(frozen=True)
class SortKey:
    expr: Expr
    descending: bool = False
    nulls_first: Optional[bool] = None  # SQL default: last in ASC, first in DESC


def order_by(
    page: Page, keys: Sequence[SortKey], limit: Optional[int] = None
) -> Page:
    """Sort live rows; optionally keep only the first ``limit`` (TopN).

    Output capacity = input capacity unless ``limit`` is given, in which
    case the output page is cut to capacity ``limit``."""
    cap = page.capacity
    evaluated = [
        (torch.broadcast_to(d, (cap,)), v, k.expr.dtype)
        for k, (d, v) in ((k, eval_expr(k.expr, page)) for k in keys)
    ]
    order = sort_order(
        evaluated,
        page.row_mask(),
        descending=[k.descending for k in keys],
        nulls_first=[
            k.nulls_first if k.nulls_first is not None else k.descending
            for k in keys
        ],
    )
    if limit is not None:
        order = order[:limit]
    blocks = []
    for blk in page.blocks:
        if blk.dtype.is_nested:
            raise NotImplementedError(
                f"{blk.dtype} columns: later slice of the port"
            )
        blocks.append(
            dataclasses.replace(
                blk,
                data=blk.data[order],
                valid=None if blk.valid is None else blk.valid[order],
            )
        )
    num = page.num_valid
    if limit is not None:
        num = torch.clamp(num, max=limit).to(torch.int32)
    return Page(blocks=tuple(blocks), num_valid=num, names=page.names)


def limit(page: Page, n: int) -> Page:
    """LIMIT n: clamp the live-row count (no data movement for
    prefix-form pages). A masked page compacts first, into an n-sized
    bucket: LIMIT without ORDER BY may return ANY n rows, so gathering
    only the first n live rows keeps the cost O(n) per column."""
    if page.live is not None:
        page = compact_page(page, bucket_capacity(n))
    return dataclasses.replace(
        page, num_valid=torch.clamp(page.num_valid, max=n).to(torch.int32)
    )


def distinct(page: Page, max_groups: Optional[int] = None):
    """SELECT DISTINCT over all columns of ``page``.

    Returns (page, overflow) like hash_aggregate."""
    schema = page.schema()
    keys = [(n, ColumnRef(n, schema[n])) for n in page.names]
    return hash_aggregate(page, keys, [], max_groups or page.capacity)

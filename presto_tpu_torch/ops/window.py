"""Window functions over a Page.

The PyTorch counterpart of ``presto_tpu/ops/window.py``: one stable sort
by (partition keys, order keys), then every window function is index
arithmetic over the sorted layout. Partitions and peer groups are runs
of neighbouring rows, so where the reference reduces per segment
(``jax.ops.segment_min/max/sum`` over ``capacity + 1`` segments) the
port finds each run's first and last position by two binary searches of
the run ids (no scatter, no atomics), running integer sums
are cumsum differences, and running float sums and min/max take the
fixed doubling tree of the sorted GROUP BY, so two runs give the same
bits.

Default SQL frame semantics: with ORDER BY, aggregates run over RANGE
UNBOUNDED PRECEDING..CURRENT ROW (peers share the value of their last
peer row); without ORDER BY, over the whole partition. Output rows come
in (partition, order) sorted order with the live rows first, so the
result is a prefix-form page.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.expr import Expr, ExprLowerer
from presto_tpu_torch.ops.aggregation import _segmented_scan_reduce
from presto_tpu_torch.ops.common import boundaries, sort_order
from presto_tpu_torch.ops.sort import SortKey
from presto_tpu_torch.page import Block, Page


@dataclasses.dataclass(frozen=True)
class WindowCall:
    """func in {row_number, rank, dense_rank, ntile, lag, lead,
    first_value, last_value, sum, count, avg, min, max}.

    ``offset`` is lag/lead's constant distance (ntile reuses it as the
    bucket count); ``default`` is lag/lead's constant fill for
    out-of-partition positions as a Literal/Cast Expr (None = SQL
    NULL)."""

    func: str
    arg: Optional[Expr]  # None for row_number/rank/dense_rank/count(*)
    out_name: str
    offset: int = 1
    default: Optional[Expr] = None
    #: aggregate frame: "range" = default RANGE UNBOUNDED..CURRENT ROW
    #: (peers share the last peer row's value); "rows" = ROWS
    #: UNBOUNDED..CURRENT ROW (each row sees its own prefix)
    frame: str = "range"

    def result_type(self) -> T.DataType:
        if self.func in ("row_number", "rank", "dense_rank", "count",
                         "ntile"):
            return T.BIGINT
        if self.func in ("percent_rank", "cume_dist"):
            return T.DOUBLE
        t = self.arg.dtype
        if self.func in ("lag", "lead", "first_value", "last_value",
                         "nth_value"):
            return t
        if self.func == "sum":
            if t.is_decimal:
                return T.decimal(18, t.scale)
            if t.is_integer:
                return T.BIGINT
            return T.DOUBLE
        if self.func == "avg":
            return T.DOUBLE
        if self.func in ("min", "max"):
            return t
        raise NotImplementedError(f"window function {self.func}")


@dataclasses.dataclass
class _Layout:
    """Per sorted row: its position and the first and last positions of
    its partition and of its peer group (rows equal on every key). The
    dead rows after the live prefix form one more run, as the dead
    segment does in the reference."""

    pos: torch.Tensor
    live: torch.Tensor
    part_head: torch.Tensor
    part_start: torch.Tensor
    part_end: torch.Tensor
    peer_bnd: torch.Tensor
    peer_start: torch.Tensor
    peer_end: torch.Tensor


def _run_bounds(head: torch.Tensor):
    """(first, last) position of each row's run; a run starts at each
    head. The run ids, a cumsum of the heads, are sorted, so each bound
    is one binary search of them (a running max over positions, torch's
    ``cummax``, also computes indices and took ~50 ms per 2^24 rows on
    an H100)."""
    rid = torch.cumsum(head.to(torch.int64), dim=0)
    return (
        torch.searchsorted(rid, rid),
        torch.searchsorted(rid, rid, right=True) - 1,
    )


def _layout(part_s, order_s, live_s) -> _Layout:
    cap = live_s.shape[0]
    dev = live_s.device
    pos = torch.arange(cap, dtype=torch.int64, device=dev)
    if part_s:
        part_bnd = boundaries(part_s, live_s)
    else:
        part_bnd = (pos == 0) & live_s
    peer_bnd = boundaries(part_s + order_s, live_s) if order_s else part_bnd
    first_dead = ~live_s & torch.cat([torch.ones_like(live_s[:1]),
                                      live_s[:-1]])
    part_head = part_bnd | first_dead
    part_start, part_end = _run_bounds(part_head)
    peer_start, peer_end = _run_bounds(peer_bnd | first_dead)
    return _Layout(
        pos=pos,
        live=live_s,
        part_head=part_head,
        part_start=part_start,
        part_end=part_end,
        peer_bnd=peer_bnd,
        peer_start=peer_start,
        peer_end=peer_end,
    )


def window(
    page: Page,
    partition_by: Sequence[Expr],
    order_by: Sequence[SortKey],
    calls: Sequence[WindowCall],
) -> Page:
    """Append window-function columns to ``page`` (sorted order output)."""
    cap = page.capacity
    live = page.row_mask()
    lowerer = ExprLowerer(page)

    def lane(e):
        d, v = lowerer.eval(e)
        d = torch.broadcast_to(d, (cap,))
        return d, None if v is None else torch.broadcast_to(v, (cap,))

    part_eval = [(*lane(e), e.dtype) for e in partition_by]
    order_eval = [(*lane(k.expr), k.expr.dtype) for k in order_by]
    perm = sort_order(
        part_eval + order_eval,
        live,
        descending=[False] * len(part_eval)
        + [k.descending for k in order_by],
        nulls_first=[False] * len(part_eval)
        + [
            k.nulls_first if k.nulls_first is not None else k.descending
            for k in order_by
        ],
    )
    live_s = live[perm]
    part_s = [(d[perm], None if v is None else v[perm])
              for d, v, _ in part_eval]
    order_s = [(d[perm], None if v is None else v[perm])
               for d, v, _ in order_eval]
    lay = _layout(part_s, order_s, live_s)

    names = list(page.names)
    for name, blk in zip(names, page.blocks):
        if blk.dtype.is_nested:
            raise NotImplementedError(
                f"nested column {name} ({blk.dtype}) cannot ride "
                "through a window operator; select it separately"
            )
    blocks = [
        dataclasses.replace(
            blk,
            data=blk.data[perm],
            valid=None if blk.valid is None else blk.valid[perm],
        )
        for blk in page.blocks
    ]

    rn0 = lay.pos - lay.part_start  # row number within the partition - 1
    part_cnt = lay.part_end - lay.part_start + 1
    for call in calls:
        f = call.func
        if f == "row_number":
            # int32 data in a BIGINT block, as in the reference: ranks
            # are bounded by the capacity, and the result copy halves
            blocks.append(_bigint32(rn0 + 1))
        elif f == "rank":
            blocks.append(_bigint32(lay.peer_start - lay.part_start + 1))
        elif f == "dense_rank":
            peer_gid = torch.cumsum(lay.peer_bnd.to(torch.int64), dim=0)
            blocks.append(_bigint32(peer_gid - peer_gid[lay.part_start] + 1))
        elif f == "ntile":
            # sizes differ by at most 1 and the FIRST (m mod n) buckets
            # take the extra row
            n_tiles = max(int(call.offset), 1)
            m = torch.clamp(part_cnt, min=1)
            q = m // n_tiles
            r = m % n_tiles
            big = r * (q + 1)
            data = torch.where(
                rn0 < big,
                rn0 // torch.clamp(q + 1, min=1),
                r + (rn0 - big) // torch.clamp(q, min=1),
            ) + 1
            blocks.append(Block(data=data, valid=None, dtype=T.BIGINT))
        elif f == "percent_rank":
            rank0 = (lay.peer_start - lay.part_start).to(torch.float64)
            denom = (part_cnt - 1).to(torch.float64)
            data = torch.where(
                denom > 0, rank0 / torch.clamp(denom, min=1.0), 0.0
            )
            blocks.append(Block(data=data, valid=None, dtype=T.DOUBLE))
        elif f == "cume_dist":
            thru = (lay.peer_end - lay.part_start + 1).to(torch.float64)
            data = thru / torch.clamp(part_cnt.to(torch.float64), min=1.0)
            blocks.append(Block(data=data, valid=None, dtype=T.DOUBLE))
        elif f in ("lag", "lead", "first_value", "last_value", "nth_value"):
            blocks.append(_window_nav(call, perm, lay, lowerer))
        elif f in ("sum", "count", "avg", "min", "max"):
            blocks.append(
                _window_agg(call, perm, lay, bool(order_by), lowerer)
            )
        else:
            raise NotImplementedError(f)
        names.append(call.out_name)

    return Page(
        blocks=tuple(blocks), num_valid=page.num_valid, names=tuple(names)
    )


def _bigint32(data: torch.Tensor) -> Block:
    return Block(data=data.to(torch.int32), valid=None, dtype=T.BIGINT)


def _sorted_arg(call: WindowCall, perm, lowerer: ExprLowerer):
    cap = perm.shape[0]
    d, v = lowerer.eval(call.arg)
    d = torch.broadcast_to(d, (cap,))[perm]
    return d, None if v is None else torch.broadcast_to(v, (cap,))[perm]


def _window_nav(call: WindowCall, perm, lay: _Layout, lowerer) -> Block:
    """lag/lead by a row offset within the partition; first_value at the
    partition start; nth_value the n-th row of the frame; last_value at
    the frame end (default RANGE frame: the last peer row)."""
    cap = perm.shape[0]
    at = call.arg.dtype
    d, v_s = _sorted_arg(call, perm, lowerer)
    ones = torch.ones((cap,), dtype=torch.bool, device=perm.device)
    if call.func == "lag":
        src = lay.pos - call.offset
        in_part = src >= lay.part_start
    elif call.func == "lead":
        src = lay.pos + call.offset
        in_part = src <= lay.part_end
    elif call.func == "first_value":
        src, in_part = lay.part_start, ones
    elif call.func == "nth_value":
        # NULL until the frame has grown past n rows
        src = lay.part_start + (call.offset - 1)
        in_part = src <= lay.peer_end
    else:  # last_value
        src, in_part = lay.peer_end, ones
    src_c = torch.clamp(src, 0, cap - 1)
    data = d[src_c]
    src_valid = in_part if v_s is None else (in_part & v_s[src_c])
    if call.default is not None and call.func in ("lag", "lead"):
        fd, _ = lowerer.eval(call.default)
        data = torch.where(in_part, data, fd)
        src_valid = ones if v_s is None else torch.where(in_part, src_valid,
                                                         True)
    return Block(
        data=data.to(at.torch_dtype),
        valid=lay.live & src_valid,
        dtype=at,
        dictionary=(
            lowerer.dictionary_of(call.arg) if at.is_string else None
        ),
    )


def _window_agg(call: WindowCall, perm, lay: _Layout, running: bool,
                lowerer) -> Block:
    cap = perm.shape[0]
    rt = call.result_type()
    if call.arg is not None:
        d, v_s = _sorted_arg(call, perm, lowerer)
        valid = lay.live if v_s is None else (lay.live & v_s)
    else:  # count(*)
        d = torch.ones((cap,), dtype=torch.int64, device=perm.device)
        valid = lay.live
    at = call.arg.dtype if call.arg is not None else T.BIGINT
    is_float = (
        call.func == "avg" or at.name in ("double", "real")
    ) and call.func not in ("min", "max", "count")

    # ROWS frames read each row's own prefix; RANGE frames the last peer
    # row's; a whole-partition aggregate the partition's last row
    at_frame_end = (
        (lambda t: t) if running and call.frame == "rows"
        else (lambda t: t[lay.peer_end]) if running
        else (lambda t: t[lay.part_end])
    )
    before = torch.clamp(lay.part_start - 1, min=0)
    first = lay.part_start == 0

    def within(cs):
        """Prefix of a cumsum inside the row's partition."""
        return cs - torch.where(first, torch.zeros_like(cs), cs[before])

    cnt = at_frame_end(within(torch.cumsum(valid.to(torch.int64), dim=0)))
    has = cnt > 0

    if call.func in ("min", "max"):
        op = torch.minimum if call.func == "min" else torch.maximum
        if at.name in ("double", "real"):
            fill = float("inf") if call.func == "min" else float("-inf")
            xv = torch.where(valid, d.to(torch.float64), fill)
        else:
            info = torch.iinfo(torch.int64)
            fill = info.max if call.func == "min" else info.min
            xv = torch.where(valid, d.to(torch.int64), fill)
        data = at_frame_end(_segmented_scan_reduce(xv, lay.part_head, op))
        return Block(
            data=data.to(at.torch_dtype),
            valid=has,
            dtype=at,
            dictionary=(
                lowerer.dictionary_of(call.arg) if at.is_string else None
            ),
        )
    if call.func == "count":
        return Block(data=cnt, valid=None, dtype=T.BIGINT)
    if is_float:
        x = d.to(torch.float64)
        if at.is_decimal:
            x = x / (10 ** at.scale)
        x = torch.where(valid, x, 0.0)
        total = at_frame_end(_segmented_scan_reduce(x, lay.part_head,
                                                    torch.add))
        if call.func == "avg":
            total = total / torch.clamp(cnt, min=1)
        return Block(data=total, valid=has, dtype=T.DOUBLE)
    # integer and decimal sums: an int64 cumsum difference, exact (and
    # wrapping) as the reference's
    x = torch.where(valid, d.to(torch.int64), 0)
    total = at_frame_end(within(torch.cumsum(x, dim=0)))
    return Block(data=total, valid=has, dtype=rt)

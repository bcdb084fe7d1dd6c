"""Grouped aggregation, with the one-hot reduction as a CUDA kernel.

The PyTorch counterpart of ``presto_tpu/ops/aggregation.py``:

- **one-hot path**: when every group key has a statically *provable*
  small domain (dictionary ids, booleans) and the composite domain has
  at most 256 segments, each row gets a segment id and every
  accumulator is one masked per-segment reduction. All of a GROUP BY's
  reductions go to one ``onehot_reduce_many`` call. On a CUDA tensor
  that is one launch of the hand-written kernel
  ``csrc/onehot_reduce.cu`` (the port of
  ``tools/pallas_groupby.py::pallas_onehot``); on a CPU tensor it is the
  plain one-hot broadcast-reduce that the JAX engine composes
  (``onehot_reduce_plain``), once per reduction.
- **global path** (no keys): plain masked whole-array reductions.
- **sorted path** (general keys): one stable multi-key sort
  (``ops/common.py``) brings equal keys together; integer sums and
  counts are int64 cumsum differences over each group's span, float
  sums and min/max a segmented scan read at group ends.

Shapes stay static: the planner supplies ``max_groups`` (the output
capacity); the one-hot path reports overflow instead of reallocating,
and the runner re-runs at a bigger bucket.

Result types: sum(int)->bigint, sum(decimal(p,s))->decimal(18,s) exact
on int64, sum(double)->double, count->bigint, avg->double, min/max keep
the input type.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.expr import Expr, ExprLowerer
from presto_tpu_torch.ops.common import boundaries, sort_order
from presto_tpu_torch.page import Block, Page, nonzero_static


@dataclasses.dataclass(frozen=True)
class AggCall:
    """One KERNEL aggregate: func in {count, count_star, sum, min, max,
    avg, stddev_samp, stddev_pop, var_samp, var_pop, array_agg,
    approx_percentile, min_by, max_by}.

    Composed aggregates (corr, covar, skewness, checksum, ... —
    presto_tpu_torch.functions.ComposedAgg) never reach the kernel: the
    planner lowers them to primitive AggCalls plus a finisher
    projection, so the kernel surface stays the primitive set.

    ``arg2`` is min_by/max_by's ordering argument; ``param`` is
    approx_percentile's quantile in [0, 1]."""

    func: str
    arg: Optional[Expr]  # None only for count_star
    out_name: str
    arg2: Optional[Expr] = None
    param: Optional[float] = None

    def result_type(self) -> T.DataType:
        if self.func in ("count", "count_star"):
            return T.BIGINT
        if self.func in _VARIANCE_FUNCS:
            return T.DOUBLE
        if self.func == "array_agg":
            return T.array(self.arg.dtype)
        t = self.arg.dtype
        if self.func == "sum":
            if t.is_decimal:
                return T.decimal(18, t.scale)
            if t.is_integer:
                return T.BIGINT
            return T.DOUBLE
        if self.func == "avg":
            return T.DOUBLE
        if self.func in ("min", "max", "approx_percentile",
                         "min_by", "max_by"):
            return t
        raise NotImplementedError(f"aggregate {self.func}")


_VARIANCE_FUNCS = ("stddev_samp", "stddev_pop", "var_samp", "var_pop")

#: aggregates that require the sorted layout (a per-group value order)
_ORDER_FUNCS = ("array_agg", "approx_percentile", "min_by", "max_by")

#: one-hot path ceiling (the kernel's shared-memory partials are sized
#: for it)
_ONEHOT_MAX_SEGMENTS = 256


# ------------------------------------------------- the one-hot reduction

_ONEHOT_OPS = {"count": 0, "sum": 1, "min": 2, "max": 3}
_ONEHOT_XKIND = {torch.int64: 1, torch.float64: 2, torch.float32: 3}
#: requests per launch (kMaxRequests in csrc/onehot_reduce.cu)
K_MAX = 16
#: one reduction request: (op, x or None for count, validity or None)
OnehotRequest = Tuple[str, Optional[torch.Tensor], Optional[torch.Tensor]]
#: the kernel's persistent grid: up to this many blocks per SM (as many
#: as fit), and no block for fewer rows than _MIN_ROWS_PER_BLOCK
_MAX_BLOCKS_PER_SM = 4
_MIN_ROWS_PER_BLOCK = 4096


def _onehot_fill(op: str, dtype: torch.dtype):
    """Value of an empty segment: the identity of ``op``."""
    if op in ("count", "sum"):
        return 0
    if dtype == torch.int64:
        info = torch.iinfo(torch.int64)
        return info.max if op == "min" else info.min
    return float("inf") if op == "min" else float("-inf")


def _check_onehot_args(gid, x, valid, nseg: int, op: str) -> None:
    if op not in _ONEHOT_OPS:
        raise ValueError(f"onehot_reduce: unknown op {op!r}")
    if not 1 <= nseg <= _ONEHOT_MAX_SEGMENTS:
        raise ValueError(f"onehot_reduce: nseg {nseg} not in [1, 256]")
    if gid.dtype != torch.int32 or gid.dim() != 1:
        raise ValueError("onehot_reduce: gid must be a 1-D int32 tensor")
    if (x is None) != (op == "count"):
        raise ValueError("onehot_reduce: x is None exactly for op 'count'")
    for name, t in (("x", x), ("valid", valid)):
        if t is None:
            continue
        if t.shape != gid.shape or t.device != gid.device:
            raise ValueError(
                f"onehot_reduce: {name} must match gid's shape and device"
            )
    if x is not None and x.dtype not in _ONEHOT_XKIND:
        raise ValueError(f"onehot_reduce: x dtype {x.dtype} not supported")
    if valid is not None and valid.dtype != torch.bool:
        raise ValueError("onehot_reduce: valid must be a bool tensor")


def onehot_reduce_plain(
    gid: torch.Tensor,
    x: Optional[torch.Tensor],
    valid: Optional[torch.Tensor],
    nseg: int,
    op: str,
) -> torch.Tensor:
    """Plain PyTorch version of ``onehot_reduce``: the (rows, nseg)
    one-hot mask and a masked broadcast-reduce over it, as the JAX
    engine composes it (``_onehot_one_agg``)."""
    seg = torch.arange(nseg, dtype=torch.int32, device=gid.device)
    oh = gid[:, None] == seg[None, :]
    if valid is not None:
        oh = oh & valid[:, None]
    if op == "count":
        return torch.sum(oh, dim=0, dtype=torch.int64)
    fill = _onehot_fill(op, x.dtype)
    masked = torch.where(oh, x[:, None], fill)
    if op == "sum":
        return torch.sum(masked, dim=0, dtype=x.dtype)
    if gid.shape[0] == 0:
        return torch.full((nseg,), fill, dtype=x.dtype, device=gid.device)
    reduce = torch.amin if op == "min" else torch.amax
    return reduce(masked, dim=0)


def _to_slots(t: torch.Tensor) -> torch.Tensor:
    """A result as 8-byte slots: int64 as it is, a float as float64 bits
    (float32 widens exactly)."""
    if t.dtype == torch.int64:
        return t
    return t.to(torch.float64).view(torch.int64)


def onehot_results(
    out: torch.Tensor, requests: Sequence[OnehotRequest]
) -> List[torch.Tensor]:
    """Row k of ``onehot_reduce_many``'s slots in request k's type."""
    res = []
    for row, (_, x, _) in zip(out, requests):
        if x is None or x.dtype == torch.int64:
            res.append(row)
        else:
            res.append(row.view(torch.float64).to(x.dtype))
    return res


def onehot_reduce_many_plain(
    gid: torch.Tensor, requests: Sequence[OnehotRequest], nseg: int
) -> torch.Tensor:
    """Plain PyTorch version of ``onehot_reduce_many``:
    ``onehot_reduce_plain`` per request, stacked as 8-byte slots."""
    return torch.stack([
        _to_slots(onehot_reduce_plain(gid, x, valid, nseg, op))
        for op, x, valid in requests
    ])


def _onehot_lib():
    from presto_tpu_torch import kernels

    lib = kernels.load("onehot_reduce")
    fn = lib.onehot_reduce_many_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.onehot_reduce_many_blocks_per_sm.argtypes = [ctypes.c_int]
        lib.onehot_reduce_many_blocks_per_sm.restype = ctypes.c_int
        lib.onehot_reduce_error_string.argtypes = [ctypes.c_int]
        lib.onehot_reduce_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _grid_blocks(index: int, nseg: int) -> int:
    """The largest grid the kernel runs for nseg segments on device
    ``index``: blocks per SM (as many as fit, at most
    ``_MAX_BLOCKS_PER_SM``) times the SM count; read once per device."""
    lib = _onehot_lib()
    with torch.cuda.device(index):
        per_sm = lib.onehot_reduce_many_blocks_per_sm(nseg)
    if per_sm < 0:
        msg = lib.onehot_reduce_error_string(-per_sm).decode()
        raise RuntimeError(f"onehot_reduce occupancy query failed: {msg}")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return min(per_sm, _MAX_BLOCKS_PER_SM) * sms


#: per device: the zeroed scratch whose first word is the kernel's ticket
_scratch: Dict[int, torch.Tensor] = {}


def _scratch_for(device: torch.device, slots: int) -> torch.Tensor:
    buf = _scratch.get(device.index)
    if buf is None or buf.numel() < 1 + slots:
        buf = torch.zeros(1 + slots, dtype=torch.int64, device=device)
        _scratch[device.index] = buf
    return buf


def onehot_reduce_many(
    gid: torch.Tensor,
    requests: Sequence[OnehotRequest],
    nseg: int,
) -> torch.Tensor:
    """K per-segment reductions over one ``gid``: request k is
    ``(op, x, valid)`` as ``onehot_reduce`` takes them, and row k of the
    ``[K, nseg]`` int64 result holds its values as 8-byte slots (float
    results as float64 bits; ``onehot_results`` gives each row its type).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (``csrc/onehot_reduce.cu``) once per ``K_MAX`` requests, in
    order, or raises. Launches on one device must be stream-ordered: they
    share one scratch. ``onehot_reduce.launches`` counts the launches."""
    if not requests:
        raise ValueError("onehot_reduce_many: no requests")
    for op, x, valid in requests:
        _check_onehot_args(gid, x, valid, nseg, op)
    if gid.device.type == "cpu":
        return onehot_reduce_many_plain(gid, requests, nseg)
    if gid.device.type != "cuda":
        raise ValueError(f"onehot_reduce: no kernel for {gid.device}")
    dev = gid.device
    gid = gid.contiguous()
    n = gid.shape[0]
    lib = _onehot_lib()
    grid = max(1, min(_grid_blocks(dev.index, nseg),
                      -(-n // _MIN_ROWS_PER_BLOCK)))
    k_all = len(requests)
    out = torch.empty((k_all, nseg), dtype=torch.int64, device=dev)
    scratch = _scratch_for(dev, grid * min(k_all, K_MAX) * nseg)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for k0 in range(0, k_all, K_MAX):
            part = requests[k0:k0 + K_MAX]
            k = len(part)
            xs = [None if x is None else x.contiguous() for _, x, _ in part]
            vs = [None if v is None else v.contiguous() for _, _, v in part]
            rc = lib.onehot_reduce_many_launch(
                k,
                (ctypes.c_int * k)(*[_ONEHOT_OPS[op] for op, _, _ in part]),
                (ctypes.c_int * k)(
                    *[0 if x is None else _ONEHOT_XKIND[x.dtype] for x in xs]
                ),
                (ctypes.c_void_p * k)(
                    *[None if x is None else x.data_ptr() for x in xs]
                ),
                (ctypes.c_void_p * k)(
                    *[None if v is None else v.data_ptr() for v in vs]
                ),
                gid.data_ptr(), n, nseg, scratch.data_ptr(), grid,
                out[k0].data_ptr(), stream,
            )
            if rc != 0:
                msg = lib.onehot_reduce_error_string(rc).decode()
                raise RuntimeError(
                    f"onehot_reduce launch failed: {msg} ({rc})"
                )
            onehot_reduce.launches += 1
    return out


def onehot_reduce(
    gid: torch.Tensor,
    x: Optional[torch.Tensor],
    valid: Optional[torch.Tensor],
    nseg: int,
    op: str,
) -> torch.Tensor:
    """Per-segment reduction: ``out[s]`` reduces ``x[i]`` over rows with
    ``gid[i] == s`` (and ``valid[i]``), for s in [0, nseg).

    ``op`` is count | sum | min | max; ``x`` is int64, float64 or
    float32 (None for count); ``gid`` is int32, and a gid outside
    [0, nseg) (the engine uses ``nseg`` for dead rows) contributes
    nothing. Sums accumulate in x's type; counts are int64; an empty
    segment holds the op's identity (0, int64 max/min, +-inf).

    The one-request case of ``onehot_reduce_many``: a CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises."""
    req = [(op, x, valid)]
    return onehot_results(onehot_reduce_many(gid, req, nseg), req)[0]


onehot_reduce.launches = 0


# ------------------------------------------------------------ aggregation


def _variance_block(
    s1: torch.Tensor, s2: torch.Tensor, cnt: torch.Tensor, func: str
) -> Block:
    """Variance family from (Σx, Σx², n) in float64.

    var_pop = Σx²/n − (Σx/n)²; var_samp scales by n/(n−1). NULL when
    n == 0 (pop) or n < 2 (samp), like the reference."""
    n = torch.clamp(cnt, min=1).to(torch.float64)
    mean = s1 / n
    var_pop = torch.clamp(s2 / n - mean * mean, min=0.0)
    if func.endswith("_samp"):
        var = var_pop * (n / torch.clamp(n - 1.0, min=1.0))
        has = cnt > 1
    else:
        var = var_pop
        has = cnt > 0
    data = torch.sqrt(var) if func.startswith("stddev") else var
    return Block(data=data, valid=has, dtype=T.DOUBLE)


def _static_domain(e: Expr, lowerer: ExprLowerer) -> Optional[int]:
    """Provable key-domain size, or None when unbounded: dictionary ids
    are bounded by the dictionary length, booleans by 2."""
    if e.dtype.is_string:
        try:
            dic = lowerer.dictionary_of(e)
        except NotImplementedError:
            return None
        if dic is None:
            return None
        return len(dic.values)
    if e.dtype.name == "boolean":
        return 2
    return None


def hash_aggregate(
    page: Page,
    group_keys: Sequence[Tuple[str, Expr]],
    aggs: Sequence[AggCall],
    max_groups: int,
    errors_out: Optional[List] = None,
) -> Tuple[Page, torch.Tensor]:
    """Group ``page`` by key expressions, compute aggregates.

    Returns (result_page, overflow): overflow is a 0-d bool tensor, True
    when the data had more than ``max_groups`` groups (the runner
    re-runs with a larger bucket). ``errors_out``, when given, collects
    ``(message, 0-d bool)`` hard errors: the sorted path's per-group
    bigint-sum overflow trap (``_sorted_one_agg``); the runner raises
    the message when the flag is set.
    Global aggregation (no keys) is the plain-reduction case."""
    live = page.row_mask()
    lowerer = ExprLowerer(page)

    if not group_keys:
        return _global_aggregate(page, aggs, live, lowerer)

    keys = [(name, *lowerer.eval(e), e) for name, e in group_keys]
    domains = [_static_domain(e, lowerer) for _, _, _, e in keys]
    if any(a.func in _ORDER_FUNCS for a in aggs):
        # these need the sorted layout (a per-group value order)
        return _sorted_aggregate(
            page, keys, aggs, max_groups, live, lowerer, errors_out
        )
    if all(d is not None for d in domains):
        slots = [
            d + (1 if v is not None else 0)
            for d, (_, _, v, _) in zip(domains, keys)
        ]
        nseg = 1
        for s in slots:
            nseg *= max(s, 1)
        if 0 < nseg <= _ONEHOT_MAX_SEGMENTS:
            return _onehot_aggregate(
                page, keys, domains, slots, nseg, aggs, max_groups,
                live, lowerer,
            )
    return _sorted_aggregate(
        page, keys, aggs, max_groups, live, lowerer, errors_out
    )


# --------------------------------------------------------- one-hot path


def _onehot_aggregate(
    page: Page,
    keys,
    domains: List[int],
    slots: List[int],
    nseg: int,
    aggs: Sequence[AggCall],
    max_groups: int,
    live: torch.Tensor,
    lowerer: ExprLowerer,
) -> Tuple[Page, torch.Tensor]:
    """Sort-free, scatter-free aggregation over a tiny provable domain.

    Strides give the first key the most significant position, so
    ascending segment order is lexicographic in the keys (dictionary ids
    are order-preserving); a key's NULL slot is its largest id (nulls
    group last). Dead rows get segment id ``nseg``, which no reduction
    counts."""
    cap = page.capacity
    dev = page.device

    strides = []
    s = 1
    for sl in reversed(slots):
        strides.append(s)
        s *= sl
    strides = list(reversed(strides))

    gid = torch.zeros((cap,), dtype=torch.int32, device=dev)
    for (name, d, v, e), dom, stride in zip(keys, domains, strides):
        comp = d.to(torch.int32)
        if v is not None:
            comp = torch.where(v, comp, dom)  # null slot = largest id
        gid = gid + comp * stride
    gid = torch.where(live, gid, nseg).to(torch.int32).contiguous()

    # phase 1: every aggregate registers its reductions; request 0 is
    # the live-row count. Phase 2: one onehot_reduce_many call
    requests: List[OnehotRequest] = [("count", None, None)]

    def add(op, x, valid) -> int:
        requests.append((op, x, valid))
        return len(requests) - 1

    finishers = [_onehot_agg_requests(agg, page, lowerer, add) for agg in aggs]
    res = onehot_results(onehot_reduce_many(gid, requests, nseg), requests)
    counts = res[0]  # live rows per segment
    occupied = counts > 0
    num_groups = torch.sum(occupied).to(torch.int32)
    overflow = num_groups > max_groups

    # occupied segments compacted to the front, ascending (lexicographic)
    sel = nonzero_static(occupied, max_groups, fill_value=nseg)
    safe_sel = torch.clamp(sel, max=nseg - 1)

    names: List[str] = []
    blocks: List[Block] = []
    for (name, d, v, e), dom, stride, sl in zip(
        keys, domains, strides, slots
    ):
        comp = torch.remainder(
            torch.div(safe_sel, stride, rounding_mode="floor"), sl
        )
        valid = None if v is None else (comp != dom)
        data = comp.to(d.dtype)
        dictionary = None
        if e.dtype.is_string:
            dictionary = lowerer.dictionary_of(e)
        names.append(name)
        blocks.append(
            Block(data=data, valid=valid, dtype=e.dtype, dictionary=dictionary)
        )

    # phase 3: each aggregate's Block from its rows of the result
    for agg, finish in zip(aggs, finishers):
        full = finish(res)
        blocks.append(
            dataclasses.replace(
                full,
                data=full.data[safe_sel],
                valid=None if full.valid is None else full.valid[safe_sel],
            )
        )
        names.append(agg.out_name)

    out = Page(
        blocks=tuple(blocks),
        num_valid=torch.clamp(num_groups, max=max_groups).to(torch.int32),
        names=tuple(names),
    )
    return out, overflow


def _onehot_agg_requests(
    agg: AggCall,
    page: Page,
    lowerer: ExprLowerer,
    add: Callable[[str, Optional[torch.Tensor], Optional[torch.Tensor]], int],
) -> Callable[[List[torch.Tensor]], Block]:
    """Evaluate one aggregate's argument and register its per-segment
    reductions with ``add(op, x, valid) -> index``. Returns the function
    that builds the aggregate's full (nseg,) Block from the results, in
    which ``res[0]`` is the live-row count."""
    if agg.func == "count_star":
        return lambda res: Block(data=res[0], valid=None, dtype=T.BIGINT)

    cap = page.capacity
    d, v = lowerer.eval(agg.arg)
    d = torch.broadcast_to(d, (cap,))
    valid = None if v is None else torch.broadcast_to(v, (cap,))

    # a null-free argument counts exactly the live rows: reuse res[0]
    i_cnt = 0 if valid is None else add("count", None, valid)
    if agg.func == "count":
        return lambda res: Block(data=res[i_cnt], valid=None, dtype=T.BIGINT)

    at = agg.arg.dtype

    if agg.func in _VARIANCE_FUNCS:
        x = d.to(torch.float64)
        if at.is_decimal:
            x = x / (10 ** at.scale)
        i1, i2 = add("sum", x, valid), add("sum", x * x, valid)
        return lambda res: _variance_block(
            res[i1], res[i2], res[i_cnt], agg.func
        )

    if agg.func in ("sum", "avg"):
        if at.name in ("double", "real") or agg.func == "avg":
            x = d.to(torch.float64)
            if at.is_decimal:
                x = x / (10 ** at.scale)
            i_s = add("sum", x, valid)
            if agg.func == "avg":
                return lambda res: Block(
                    data=res[i_s] / torch.clamp(res[i_cnt], min=1),
                    valid=res[i_cnt] > 0,
                    dtype=T.DOUBLE,
                )
            return lambda res: Block(
                data=res[i_s], valid=res[i_cnt] > 0, dtype=T.DOUBLE
            )
        i_s = add("sum", d.to(torch.int64), valid)
        return lambda res: Block(
            data=res[i_s], valid=res[i_cnt] > 0, dtype=agg.result_type()
        )

    if agg.func in ("min", "max"):
        if at.name in ("double", "real"):
            x = d.to(torch.float64)
        else:
            x = d.to(torch.int64)
        i_m = add(agg.func, x, valid)
        dictionary = None
        if at.is_string:
            dictionary = lowerer.dictionary_of(agg.arg)
        return lambda res: Block(
            data=res[i_m].to(at.torch_dtype),
            valid=res[i_cnt] > 0,
            dtype=at,
            dictionary=dictionary,
        )

    raise NotImplementedError(f"aggregate {agg.func}")


# ---------------------------------------------------------- sorted path


def _segmented_scan_reduce(
    x: torch.Tensor, bnd: torch.Tensor, op
) -> torch.Tensor:
    """Inclusive segmented reduction scan: position p holds the
    op-reduction of its segment's values up to p; segments restart where
    ``bnd``. Read at segment END positions for per-segment totals.

    The reference's ``lax.associative_scan`` as a fixed doubling tree
    (Hillis-Steele): step s combines each position with the one s rows
    back unless a segment starts between them. The tree depends only on
    the length, so a float sum comes out the same on every run, and no
    page-wide running total is differenced (that would cancel
    catastrophically for small late groups)."""
    vals, flags = x, bnd
    n = x.shape[0]
    s = 1
    while s < n:
        cur_v, cur_f = vals[s:], flags[s:]
        vals = torch.cat(
            [vals[:s], torch.where(cur_f, cur_v, op(vals[:-s], cur_v))]
        )
        flags = torch.cat([flags[:s], cur_f | flags[:-s]])
        s *= 2
    return vals


def _group_spans(
    bnd: torch.Tensor, max_groups: int, cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(starts, ends) sorted-space positions per group (gather-safe).

    ``ends[i] = starts[i+1] - 1`` with cap-1 for the final and fill
    groups: safe because rows past the live prefix carry neutral values
    for every accumulator (0 for cumsum deltas, fills for min/max)."""
    starts = nonzero_static(bnd, max_groups, fill_value=cap)
    nxt = torch.cat([
        starts[1:],
        torch.full((1,), cap, dtype=starts.dtype, device=starts.device),
    ])
    ends = torch.clamp(nxt - 1, 0, cap - 1)
    return torch.clamp(starts, max=cap - 1), ends


def _cumsum_span(
    w: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor
) -> torch.Tensor:
    """Per-group totals of ``w`` via an inclusive cumsum differenced over
    [start, end] spans (no scatter). An int64 running total may wrap:
    the difference is still exact whenever the group's sum fits."""
    c = torch.cumsum(w, dim=0)
    return c[ends] - c[starts] + w[starts]


def _sorted_aggregate(
    page: Page,
    keys,
    aggs: Sequence[AggCall],
    max_groups: int,
    live: torch.Tensor,
    lowerer: ExprLowerer,
    errors_out: Optional[List] = None,
) -> Tuple[Page, torch.Tensor]:
    cap = page.capacity
    keys = [
        (name, torch.broadcast_to(d, (cap,)), v, e) for name, d, v, e in keys
    ]
    order = sort_order([(d, v, e.dtype) for _, d, v, e in keys], live)
    live_s = live[order]
    keys_s = [
        (name, d[order], None if v is None else v[order], e)
        for name, d, v, e in keys
    ]
    bnd = boundaries([(d, v) for _, d, v, _ in keys_s], live_s)
    num_groups = torch.sum(bnd).to(torch.int32)
    overflow = num_groups > max_groups

    starts, ends = _group_spans(bnd, max_groups, cap)

    names: List[str] = []
    blocks: List[Block] = []
    for name, d, v, e in keys_s:
        names.append(name)
        dictionary = None
        if e.dtype.is_string:
            dictionary = lowerer.dictionary_of(e)
        blocks.append(
            Block(
                data=d[starts],
                valid=None if v is None else v[starts],
                dtype=e.dtype,
                dictionary=dictionary,
            )
        )

    for agg in aggs:
        if agg.func in ("approx_percentile", "min_by", "max_by"):
            blk = _order_stat_agg(
                agg, page, keys, live, starts, ends, lowerer
            )
        else:
            blk = _sorted_one_agg(
                agg, page, order, live_s, bnd, starts, ends, lowerer,
                errors_out,
            )
        names.append(agg.out_name)
        blocks.append(blk)

    out = Page(
        blocks=tuple(blocks),
        num_valid=torch.clamp(num_groups, max=max_groups).to(torch.int32),
        names=tuple(names),
    )
    return out, overflow


def _order_stat_agg(
    agg: AggCall,
    page: Page,
    keys,  # ORIGINAL (unsorted) key evals: [(name, d, v, e), ...]
    live: torch.Tensor,
    starts: torch.Tensor,
    ends: torch.Tensor,
    lowerer: ExprLowerer,
) -> Block:
    """approx_percentile / min_by / max_by on the sorted path.

    Each takes its own sort by (group keys, ordering value): within every
    group the ordering value's non-null rows form an ascending prefix,
    and every group keeps the span it has in the primary order, so the
    primary spans are reused.

    - approx_percentile(x, p): the element at nearest rank ceil(p*n)
      among the group's n valid values (exact).
    - min_by(x, y) / max_by(x, y): x at the group's first / last y-valid
      position."""
    cap = page.capacity
    is_by = agg.func in ("min_by", "max_by")
    val = agg.arg2 if is_by else agg.arg
    vd, vv = lowerer.eval(val)
    vd = torch.broadcast_to(vd, (cap,))
    vvb = None if vv is None else torch.broadcast_to(vv, (cap,))
    order2 = sort_order(
        [(d, v, e.dtype) for _, d, v, e in keys] + [(vd, vvb, val.dtype)],
        live,
    )
    live2 = live[order2]
    valid2 = live2 if vvb is None else (live2 & vvb[order2])
    cntv = _cumsum_span(valid2.to(torch.int64), starts, ends)
    group_has = cntv > 0
    last = torch.clamp(cntv - 1, min=0)

    if agg.func == "approx_percentile":
        p = float(agg.param if agg.param is not None else 0.5)
        k = torch.ceil(p * cntv.to(torch.float64)).to(torch.int64) - 1
        k = torch.minimum(torch.clamp(k, min=0), last)
        idx = torch.clamp(starts + k, max=cap - 1)
        return Block(
            data=vd[order2][idx], valid=group_has, dtype=agg.arg.dtype
        )

    xd, xv = lowerer.eval(agg.arg)
    xd2 = torch.broadcast_to(xd, (cap,))[order2]
    if agg.func == "min_by":
        idx = starts
    else:
        idx = torch.clamp(starts + last, max=cap - 1)
    valid = group_has
    if xv is not None:
        valid = valid & torch.broadcast_to(xv, (cap,))[order2][idx]
    dictionary = None
    if agg.arg.dtype.is_string:
        dictionary = lowerer.dictionary_of(agg.arg)
    return Block(
        data=xd2[idx], valid=valid, dtype=agg.arg.dtype,
        dictionary=dictionary,
    )


def _sorted_one_agg(
    agg: AggCall,
    page: Page,
    order: torch.Tensor,
    live_s: torch.Tensor,
    bnd: torch.Tensor,
    starts: torch.Tensor,
    ends: torch.Tensor,
    lowerer: ExprLowerer,
    errors_out: Optional[List] = None,
) -> Block:
    rt = agg.result_type()

    if agg.func == "count_star":
        data = _cumsum_span(live_s.to(torch.int64), starts, ends)
        return Block(data=data, valid=None, dtype=T.BIGINT)

    if agg.func == "array_agg":
        raise NotImplementedError(
            "array_agg: array blocks are a later slice of the port"
        )

    cap = page.capacity
    d, v = lowerer.eval(agg.arg)
    d = torch.broadcast_to(d, (cap,))[order]
    valid_s = live_s if v is None else (
        live_s & torch.broadcast_to(v, (cap,))[order]
    )

    cnt = _cumsum_span(valid_s.to(torch.int64), starts, ends)
    if agg.func == "count":
        return Block(data=cnt, valid=None, dtype=T.BIGINT)
    group_has_value = cnt > 0
    at = agg.arg.dtype

    if agg.func in _VARIANCE_FUNCS:
        x = d.to(torch.float64)
        if at.is_decimal:
            x = x / (10 ** at.scale)
        x = torch.where(valid_s, x, 0.0)
        s1 = _segmented_scan_reduce(x, bnd, torch.add)[ends]
        s2 = _segmented_scan_reduce(x * x, bnd, torch.add)[ends]
        return _variance_block(s1, s2, cnt, agg.func)

    if agg.func in ("sum", "avg"):
        if at.name in ("double", "real") or agg.func == "avg":
            # decimal avg and double sums: a SEGMENTED scan, not a
            # page-wide cumsum (see _segmented_scan_reduce)
            x = d.to(torch.float64)
            if at.is_decimal:
                x = x / (10 ** at.scale)
            x = torch.where(valid_s, x, 0.0)
            s = _segmented_scan_reduce(x, bnd, torch.add)[ends]
            if agg.func == "avg":
                s = s / torch.clamp(cnt, min=1)
            return Block(data=s, valid=group_has_value, dtype=T.DOUBLE)
        x = torch.where(valid_s, d.to(torch.int64), 0)
        s = _cumsum_span(x, starts, ends)
        if errors_out is not None:
            # per-group overflow trap: the differenced int64 sums are
            # exact under two's-complement wrap whenever the TRUE group
            # sum fits int64 (even if the page-wide running total
            # wraps), so the check is per group, against a float64
            # shadow of the same span difference. A real per-group
            # overflow displaces the int result by ~2^64; float
            # cancellation error stays far below the 2^62 threshold.
            sf = _cumsum_span(x.to(torch.float64), starts, ends)
            wrapped = torch.any(
                torch.abs(s.to(torch.float64) - sf) > 2.0 ** 62
            )
            errors_out.append(
                (f"bigint sum overflow in {agg.out_name}", wrapped)
            )
        return Block(data=s, valid=group_has_value, dtype=rt)

    if agg.func in ("min", "max"):
        # torch.minimum/maximum propagate NaN, as jnp.minimum does
        op = torch.minimum if agg.func == "min" else torch.maximum
        if at.name in ("double", "real"):
            x = d.to(torch.float64)
        else:
            x = d.to(torch.int64)
        x = torch.where(valid_s, x, _onehot_fill(agg.func, x.dtype))
        data = _segmented_scan_reduce(x, bnd, op)[ends].to(at.torch_dtype)
        dictionary = None
        if at.is_string:
            dictionary = lowerer.dictionary_of(agg.arg)
        return Block(
            data=data, valid=group_has_value, dtype=at, dictionary=dictionary
        )

    raise NotImplementedError(f"aggregate {agg.func}")


# ---------------------------------------------------------- global path


def _global_aggregate(
    page: Page,
    aggs: Sequence[AggCall],
    live: torch.Tensor,
    lowerer: ExprLowerer,
) -> Tuple[Page, torch.Tensor]:
    """No GROUP BY: plain masked whole-array reductions. One output row
    always (SQL: global aggregates over zero rows emit one row; sum ->
    NULL via the empty-group validity rule, count -> 0)."""
    names, blocks = [], []
    for agg in aggs:
        blocks.append(_global_one_agg(agg, page, live, lowerer))
        names.append(agg.out_name)
    dev = page.device
    out = Page(
        blocks=tuple(blocks),
        num_valid=torch.ones((), dtype=torch.int32, device=dev),
        names=tuple(names),
    )
    return out, torch.zeros((), dtype=torch.bool, device=dev)


def _global_one_agg(
    agg: AggCall, page: Page, live: torch.Tensor, lowerer: ExprLowerer
) -> Block:
    def one(x):
        return x.reshape(1)

    if agg.func == "count_star":
        return Block(
            data=one(torch.sum(live, dtype=torch.int64)),
            valid=None,
            dtype=T.BIGINT,
        )
    if agg.func in _ORDER_FUNCS:
        raise NotImplementedError(
            f"global {agg.func} (needs a sort): later slice"
        )

    d, v = lowerer.eval(agg.arg)
    d = torch.broadcast_to(d, (page.capacity,))
    valid = live if v is None else (live & torch.broadcast_to(v, live.shape))
    cnt = torch.sum(valid, dtype=torch.int64)

    if agg.func == "count":
        return Block(data=one(cnt), valid=None, dtype=T.BIGINT)

    has = one(cnt > 0)
    at = agg.arg.dtype

    if agg.func in _VARIANCE_FUNCS:
        x = d.to(torch.float64)
        if at.is_decimal:
            x = x / (10 ** at.scale)
        x = torch.where(valid, x, 0.0)
        return _variance_block(
            one(torch.sum(x)), one(torch.sum(x * x)), one(cnt), agg.func
        )

    if agg.func in ("sum", "avg"):
        if at.name in ("double", "real") or agg.func == "avg":
            x = d.to(torch.float64)
            if at.is_decimal:
                x = x / (10 ** at.scale)
            s = torch.sum(torch.where(valid, x, 0.0))
            if agg.func == "avg":
                return Block(
                    data=one(s / torch.clamp(cnt, min=1)),
                    valid=has,
                    dtype=T.DOUBLE,
                )
            return Block(data=one(s), valid=has, dtype=T.DOUBLE)
        s = torch.sum(torch.where(valid, d.to(torch.int64), 0))
        return Block(data=one(s), valid=has, dtype=agg.result_type())

    if agg.func in ("min", "max"):
        reduce = torch.amin if agg.func == "min" else torch.amax
        x = d.to(torch.float64 if at.name in ("double", "real") else torch.int64)
        fill = _onehot_fill(agg.func, x.dtype)
        data = one(reduce(torch.where(valid, x, fill))).to(at.torch_dtype)
        dictionary = None
        if at.is_string:
            dictionary = lowerer.dictionary_of(agg.arg)
        return Block(
            data=data, valid=has, dtype=at, dictionary=dictionary
        )

    raise NotImplementedError(f"aggregate {agg.func}")

"""Grouped aggregation, with the one-hot reduction as a CUDA kernel.

The PyTorch counterpart of ``presto_tpu/ops/aggregation.py``:

- **one-hot path**: when every group key has a statically *provable*
  small domain (dictionary ids, booleans) and the composite domain has
  at most 256 segments, each row gets a segment id and every
  accumulator is one masked per-segment reduction. On a CUDA tensor
  that reduction is the hand-written kernel ``csrc/onehot_reduce.cu``
  (the port of ``tools/pallas_groupby.py::pallas_onehot``); on a CPU
  tensor it is the plain one-hot broadcast-reduce that the JAX engine
  composes (``onehot_reduce_plain``).
- **global path** (no keys): plain masked whole-array reductions.
- **sorted path** (general keys): not ported yet; it raises.

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
from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.expr import Expr, ExprLowerer
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
_THREADS = 256  # kThreads in csrc/onehot_reduce.cu
_BLOCKS_PER_SM = 8


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


def _onehot_lib():
    from presto_tpu_torch import kernels

    lib = kernels.load("onehot_reduce")
    fn = lib.onehot_reduce_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.onehot_reduce_error_string.argtypes = [ctypes.c_int]
        lib.onehot_reduce_error_string.restype = ctypes.c_char_p
    return lib


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

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (``csrc/onehot_reduce.cu``) or raises. ``launches`` counts
    the kernel launches."""
    _check_onehot_args(gid, x, valid, nseg, op)
    if gid.device.type == "cpu":
        return onehot_reduce_plain(gid, x, valid, nseg, op)
    if gid.device.type != "cuda":
        raise ValueError(f"onehot_reduce: no kernel for {gid.device}")
    gid = gid.contiguous()
    x = None if x is None else x.contiguous()
    valid = None if valid is None else valid.contiguous()
    lib = _onehot_lib()
    n = gid.shape[0]
    acc = torch.int64 if x is None else x.dtype
    sms = torch.cuda.get_device_properties(gid.device).multi_processor_count
    grid = max(1, min(-(-n // _THREADS), sms * _BLOCKS_PER_SM))
    partials = torch.empty((grid, nseg), dtype=acc, device=gid.device)
    out = torch.empty((nseg,), dtype=acc, device=gid.device)
    with torch.cuda.device(gid.device):
        stream = torch.cuda.current_stream(gid.device).cuda_stream
        rc = lib.onehot_reduce_launch(
            _ONEHOT_OPS[op],
            0 if x is None else _ONEHOT_XKIND[x.dtype],
            gid.data_ptr(),
            None if x is None else x.data_ptr(),
            None if valid is None else valid.data_ptr(),
            n,
            nseg,
            partials.data_ptr(),
            grid,
            out.data_ptr(),
            stream,
        )
    if rc != 0:
        msg = lib.onehot_reduce_error_string(rc).decode()
        raise RuntimeError(f"onehot_reduce launch failed: {msg} ({rc})")
    onehot_reduce.launches += 1
    return out


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
    re-runs with a larger bucket). ``errors_out`` is accepted for
    signature parity; the ported paths raise no traced errors.
    Global aggregation (no keys) is the plain-reduction case."""
    live = page.row_mask()
    lowerer = ExprLowerer(page)

    if not group_keys:
        return _global_aggregate(page, aggs, live, lowerer)

    keys = [(name, *lowerer.eval(e), e) for name, e in group_keys]
    domains = [_static_domain(e, lowerer) for _, _, _, e in keys]
    if any(a.func in _ORDER_FUNCS for a in aggs):
        return _sorted_aggregate()
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
    return _sorted_aggregate()


def _sorted_aggregate():
    raise NotImplementedError("sorted aggregation: later slice")


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

    counts = onehot_reduce(gid, None, None, nseg, "count")  # live rows
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

    for agg in aggs:
        full = _onehot_one_agg(agg, page, gid, nseg, counts, lowerer)
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


def _onehot_one_agg(
    agg: AggCall,
    page: Page,
    gid: torch.Tensor,  # (cap,) int32; dead rows hold nseg
    nseg: int,
    counts: torch.Tensor,  # (nseg,) live rows per group
    lowerer: ExprLowerer,
) -> Block:
    """One aggregate as full (nseg,) tensors, every per-segment
    reduction through ``onehot_reduce``."""
    if agg.func == "count_star":
        return Block(data=counts, valid=None, dtype=T.BIGINT)

    cap = page.capacity
    d, v = lowerer.eval(agg.arg)
    d = torch.broadcast_to(d, (cap,))
    valid = None if v is None else torch.broadcast_to(v, (cap,))

    def reduce(x, op):
        return onehot_reduce(gid, x, valid, nseg, op)

    # a null-free argument counts exactly the live rows: reuse ``counts``
    cnt = counts if valid is None else reduce(None, "count")
    if agg.func == "count":
        return Block(data=cnt, valid=None, dtype=T.BIGINT)

    group_has_value = cnt > 0
    at = agg.arg.dtype

    if agg.func in _VARIANCE_FUNCS:
        x = d.to(torch.float64)
        if at.is_decimal:
            x = x / (10 ** at.scale)
        s1 = reduce(x, "sum")
        s2 = reduce(x * x, "sum")
        return _variance_block(s1, s2, cnt, agg.func)

    if agg.func in ("sum", "avg"):
        if at.name in ("double", "real") or agg.func == "avg":
            x = d.to(torch.float64)
            if at.is_decimal:
                x = x / (10 ** at.scale)
            s = reduce(x, "sum")
            if agg.func == "avg":
                return Block(
                    data=s / torch.clamp(cnt, min=1),
                    valid=group_has_value,
                    dtype=T.DOUBLE,
                )
            return Block(data=s, valid=group_has_value, dtype=T.DOUBLE)
        s = reduce(d.to(torch.int64), "sum")
        return Block(data=s, valid=group_has_value, dtype=agg.result_type())

    if agg.func in ("min", "max"):
        if at.name in ("double", "real"):
            x = d.to(torch.float64)
        else:
            x = d.to(torch.int64)
        data = reduce(x, agg.func).to(at.torch_dtype)
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

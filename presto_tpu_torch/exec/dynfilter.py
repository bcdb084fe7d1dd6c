"""Dynamic filters of the stage-at-a-time executor.

The PyTorch counterpart of the device path of
``presto_tpu/exec/dynfilter.py`` (``device_conjuncts``): when a join's
BUILD side has run as its own fragment, its join-key summary turns into
a predicate on the still-unexecuted probe side, since probe rows outside
the build's key domain cannot match. Per key: min/max bounds in the
key's NATIVE dtype (a widening cast could round a float bound or wrap an
integer fill and drop real matches), or, for a dictionary string key
with a small dictionary, the set of present values. Everything is read
back in ONE batched host copy (``page.to_host``).

The host-side summaries of the reference (worker summaries, their merge
and wire form, split pruning) belong to the server and are not ported
yet.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from presto_tpu_torch import expr as E
from presto_tpu_torch import types as T
from presto_tpu_torch.page import Page, to_host

#: default NDV cap for the distinct-set (IN-list) form; above it only
#: min/max bounds are kept (session ``dynamic_filtering_ndv_limit``)
DEFAULT_NDV_LIMIT = 64

_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)


def device_conjuncts(
    build_page: Page,
    key_pairs: List[Tuple[str, str]],
    probe_schema: Dict[str, T.DataType],
    ndv_limit: int = DEFAULT_NDV_LIMIT,
) -> Tuple[List[E.Expr], int]:
    """Build-side summaries straight off a device-resident page.

    ``key_pairs`` is ``[(probe_col, build_col), ...]``; returns
    ``(conjuncts, n_filters)``, where conjuncts are probe-side Exprs
    (a single constant FALSE for an empty build)."""
    fetch: List[torch.Tensor] = []
    specs: List[tuple] = []
    for lk, rk in key_pairs:
        blk = build_page.block(rk)
        lt = probe_schema.get(lk)
        if (
            lt is None
            or lt != blk.dtype  # scales/id-spaces must agree
            or lt.is_long_decimal
            or lt.is_nested
        ):
            continue
        mask = build_page.row_mask()
        if blk.valid is not None:
            mask = mask & blk.valid
        if lt.is_string:
            if blk.dictionary is None:
                continue
            nvals = len(blk.dictionary.values)
            if nvals > ndv_limit:
                continue
            # present-id LUT over the (small) dictionary: ids of live
            # rows set True; padding rows go to a spill slot
            ids = torch.where(mask, blk.data.to(torch.int64), nvals)
            present = torch.zeros(
                (nvals + 1,), dtype=torch.bool, device=blk.data.device
            )
            present[ids] = True
            fetch.append(present[:nvals])
            fetch.append(mask.any())
            specs.append((lk, lt, "dict", blk.dictionary))
            continue
        d = blk.data  # NATIVE dtype: the bounds are exactly representable
        if d.is_floating_point():
            lo_fill, hi_fill = float("inf"), float("-inf")
            kind = "float"
            # NaN keys match nothing and must not poison the bounds
            mask = mask & ~torch.isnan(d)
        elif d.dtype in _INT_DTYPES:
            info = torch.iinfo(d.dtype)
            lo_fill, hi_fill = info.max, info.min
            kind = "int"
        else:
            continue
        fetch.append(torch.amin(torch.where(mask, d, lo_fill)))
        fetch.append(torch.amax(torch.where(mask, d, hi_fill)))
        specs.append((lk, lt, kind, None))
    if not specs:
        return [], 0
    vals = [t.numpy() for t in to_host(fetch)]
    conjuncts: List[E.Expr] = []
    for i, (lk, lt, kind, dictionary) in enumerate(specs):
        ref = E.ColumnRef(lk, lt)
        if kind == "dict":
            present, any_live = vals[2 * i], bool(vals[2 * i + 1])
            if not any_live:
                return [E.Literal(False, T.BOOLEAN)], 1
            values = [
                str(dictionary.values[j]) for j in np.nonzero(present)[0]
            ]
            conjuncts.append(
                E.InList(ref, tuple(E.Literal(v, lt) for v in values))
            )
            continue
        if kind == "float":
            lo, hi = float(vals[2 * i]), float(vals[2 * i + 1])
            if math.isnan(lo) or math.isnan(hi) or not (lo <= hi):
                # empty build (inf fills stayed) or all-NaN keys
                return [E.Literal(False, T.BOOLEAN)], 1
        else:
            lo, hi = int(vals[2 * i]), int(vals[2 * i + 1])
            if lo > hi:  # empty build: the fills survived the reduction
                return [E.Literal(False, T.BOOLEAN)], 1
        # compare in the key's native repr (decimals unscaled)
        conjuncts.append(
            E.Between(ref, E.Literal(lo, lt), E.Literal(hi, lt))
        )
    return conjuncts, len(conjuncts)

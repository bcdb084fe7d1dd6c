"""Orderable int64 keys and lexicographic sort orders.

The PyTorch counterpart of ``presto_tpu/ops/common.py``. Every SQL type
maps to an *order-preserving* int64 image (``orderable_i64``), so one
code path serves sort, group-by boundary detection and the join's key.
A multi-column order is a sequence of stable int64 sorts, least
significant lane first (torch has no ``lexsort``). A long decimal
((capacity, 2) int128 limb pairs) is two lanes (``key_lanes``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch import types as T

_I64_MIN = -(2 ** 63)


def orderable_i64(data: torch.Tensor, dtype: T.DataType) -> torch.Tensor:
    """Map a column to int64 such that int comparison == SQL comparison.

    - ints/dates/decimals/dict-ids: widen to int64 (dict ids are
      order-preserving by construction)
    - floats: the IEEE754 sign-magnitude trick (totally ordered for
      non-NaN; a positive NaN sorts last), with -0.0 equal to +0.0
    """
    if dtype.is_long_decimal:
        # a (cap, 2) limb pair does not fit ONE orderable int64: the
        # multi-lane callers go through key_lanes
        raise NotImplementedError(
            "long decimals (p>18) do not reduce to a single orderable "
            "int64 lane — use key_lanes()"
        )
    if dtype.name in ("double", "real"):
        f = data.to(torch.float64)
        f = torch.where(f == 0, 0.0, f)  # -0.0 and +0.0 are SQL-equal
        bits = f.view(torch.int64)
        # positives keep their bit pattern in [0, 2^63); negatives map to
        # ~bits with the sign bit set, in reversed-magnitude order
        return torch.where(bits >= 0, bits, (~bits) | _I64_MIN)
    return data.to(torch.int64)


def key_lanes(data: torch.Tensor, dtype: T.DataType) -> List[torch.Tensor]:
    """A key column as order-preserving int64 lanes, most significant
    first. A long decimal expands to [hi, lo with its sign bit flipped]:
    the lexicographic order of the pair is the int128 order (the flip
    makes the signed order of lo its unsigned order). Every other type
    is the single ``orderable_i64`` lane."""
    if dtype.is_long_decimal:
        return [data[..., 0], data[..., 1] ^ _I64_MIN]
    return [orderable_i64(data, dtype)]


def sort_order(
    keys: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor], T.DataType]],
    live: torch.Tensor,
    descending: Optional[Sequence[bool]] = None,
    nulls_first: Optional[Sequence[bool]] = None,
) -> torch.Tensor:
    """Permutation (int64) sorting rows by keys, a list of (data, valid,
    dtype), live rows first. SQL default: nulls last in ASC, first in
    DESC.

    The reference hands its lanes to ``jnp.lexsort``; here each lane is
    one stable ``torch.sort`` pass, from the least significant lane up,
    each pass permuting the order the previous ones left. The null rank
    of a key without a validity mask is constant and cannot change a
    stable order, so it takes no pass."""
    n = len(keys)
    descending = list(descending or [False] * n)
    nulls_first = list(nulls_first or descending)
    lanes: List[torch.Tensor] = []  # most significant first
    lanes.append((~live).to(torch.int8))  # live rows first
    for (data, valid, dtype), desc, nf in zip(keys, descending, nulls_first):
        if valid is not None:
            lanes.append(torch.where(valid, 0, -1 if nf else 1).to(torch.int8))
        for k in key_lanes(data, dtype):
            # bitwise-not reverses order without INT64_MIN overflow
            lanes.append(~k if desc else k)
    order = torch.arange(live.shape[0], dtype=torch.int64, device=live.device)
    for lane in reversed(lanes):
        _, idx = torch.sort(lane[order], stable=True)
        order = order[idx]
    return order


def boundaries(
    sorted_keys: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],
    live_sorted: torch.Tensor,
) -> torch.Tensor:
    """True where a new group starts (first live row or any key change).
    Inputs already sorted; NaN equals NaN and two NULLs are one group
    (SQL GROUP BY)."""
    first = torch.zeros(
        live_sorted.shape, dtype=torch.bool, device=live_sorted.device
    )
    first[:1] = True
    change = first
    head = torch.ones((1,), dtype=torch.bool, device=live_sorted.device)
    for data, valid in sorted_keys:
        neq = data[1:] != data[:-1]
        if data.dim() == 2:  # long-decimal limb pairs: any limb differs
            neq = torch.any(neq, dim=-1)
        if data.is_floating_point():
            neq = neq & ~(torch.isnan(data[1:]) & torch.isnan(data[:-1]))
        diff = torch.cat([head, neq])
        if valid is not None:
            diff = diff | torch.cat([head, valid[1:] != valid[:-1]])
            # two nulls are the same group regardless of payload data
            both_null = torch.cat([~head, (~valid[1:]) & (~valid[:-1])])
            diff = diff & ~both_null
        change = change | diff
    return change & live_sorted

"""Host-side root stage: final Output/Sort/Limit over gathered results.

A copy of ``presto_tpu/exec/host_ops.py``: the same peel and the same
numpy sort/limit/output, with one batched copy of the result's prefix
tensors (``page.to_host``) in place of ``jax.device_get``. Array/map/row
columns are not ported yet.


Reference parity: the single-partition ROOT STAGE — presto executes the
final ordering/limit of a query in one task over the gathered exchange
output (SURVEY.md §2.4 "GATHER", §3.5); it never distributes the root.

TPU-first rationale: a root-stage ORDER BY is tiny work (it runs over
the already-aggregated/filtered result) but XLA sort *lowerings* cost
tens of seconds to minutes of TPU compile time per shape
(multi-operand sorts are worst). Peeling root Output/Sort/Limit out of
the device program and running them in numpy on the gathered rows
removes every per-query root sort from the compile budget while leaving
in-fragment sorts (window functions, TopN inside subqueries, join
internals) on the device. Gated by session property
``host_root_stage`` (default true).

Only ``SortNode``s whose keys are plain column references peel — an
ORDER BY over a computed expression stays in the device program where
the expression engine lives.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.expr import ColumnRef
from presto_tpu_torch.page import Block, Page, to_host
from presto_tpu_torch.plan import nodes as N


def orderable_np(data: np.ndarray, dtype: T.DataType) -> np.ndarray:
    """numpy mirror of ops.common.orderable_i64 (order-preserving int64
    image of a column; floats via the IEEE754 sign-magnitude trick)."""
    if dtype.name in ("double", "real"):
        f = np.asarray(data, np.float64).copy()
        f[f == 0] = 0.0  # -0.0 == +0.0 in SQL
        bits = f.view(np.int64)
        neg = bits < 0
        out = bits.copy()
        out[neg] = ~bits[neg] | np.int64(-(2 ** 63))
        return out
    return np.asarray(data).astype(np.int64)


def key_lanes_np(data: np.ndarray, dtype: T.DataType) -> List[np.ndarray]:
    """numpy mirror of ops.common.key_lanes: long decimals expand to
    [hi, lo-as-unsigned] int64 lanes, everything else is one
    orderable_np lane."""
    if dtype.is_long_decimal:
        d = np.asarray(data)
        return [
            d[..., 0].astype(np.int64),
            d[..., 1].astype(np.int64) ^ np.int64(-(2 ** 63)),
        ]
    return [orderable_np(data, dtype)]


def peel_host_ops(
    root: N.PlanNode,
) -> Tuple[N.PlanNode, List[N.PlanNode]]:
    """Split the plan into (device_root, host_ops).

    ``host_ops`` is the chain of peeled root nodes ordered OUTermost
    first; apply_host_ops applies them innermost first.
    """
    peeled: List[N.PlanNode] = []
    node = root
    while True:
        if isinstance(node, (N.OutputNode, N.LimitNode)):
            peeled.append(node)
            node = node.source
            continue
        if isinstance(node, N.SortNode) and all(
            isinstance(k.expr, ColumnRef) for k in node.keys
        ):
            peeled.append(node)
            node = node.source
            continue
        break
    return node, peeled


def apply_host_ops(
    page: Page,
    host_ops: List[N.PlanNode],
    rows_out: Optional[List[int]] = None,
) -> Page:
    """Apply peeled root nodes (innermost first) to a gathered page,
    entirely in numpy; returns a dense result page on the CPU.
    ``rows_out``, when given, records the row count after each applied
    op (innermost first)."""
    # one read of the live count, then ONE copy of the n-row prefixes
    n = int(page.num_valid)
    fetched = [t.numpy() for t in to_host(page.prefix_leaves(n))]
    cols = {}  # name -> (np_data, np_valid, dtype, dictionary)
    i = 0
    for name, blk in zip(page.names, page.blocks):
        if blk.dtype.is_nested:
            raise NotImplementedError(
                f"{blk.dtype} columns at the root stage: later slice"
            )
        data = fetched[i]
        i += 1
        if blk.valid is not None:
            valid = fetched[i]
            i += 1
        else:
            valid = np.ones(n, dtype=bool)
        cols[name] = (data, valid, blk.dtype, blk.dictionary)

    for node in reversed(host_ops):
        if isinstance(node, N.SortNode):
            perm = _host_sort_perm(cols, node.keys, n)
            if node.limit is not None:
                perm = perm[: node.limit]
            cols = {
                name: (d[perm], v[perm], t, dic)
                for name, (d, v, t, dic) in cols.items()
            }
            n = len(perm)
        elif isinstance(node, N.LimitNode):
            n = min(n, node.count)
            cols = {
                name: (d[:n], v[:n], t, dic)
                for name, (d, v, t, dic) in cols.items()
            }
        elif isinstance(node, N.OutputNode):
            cols = {out: cols[src] for out, src in node.columns}
        else:  # pragma: no cover - peel_host_ops only emits the above
            raise AssertionError(f"unexpected host op {type(node).__name__}")
        if rows_out is not None:
            rows_out.append(n)

    cap = max(n, 1)
    blocks = []
    names = []
    for name, (d, v, t, dic) in cols.items():
        pad = cap - len(d)
        if pad:
            # long-decimal columns are (n, 2) limb pairs — pad rows only
            d = np.concatenate(
                [d, np.zeros((pad,) + d.shape[1:], dtype=d.dtype)]
            )
            v = np.concatenate([v, np.zeros(pad, dtype=bool)])
        valid = (
            None
            if bool(np.all(v[:n]))
            else torch.from_numpy(np.ascontiguousarray(v))
        )
        blocks.append(
            Block(
                data=torch.from_numpy(np.ascontiguousarray(d)),
                valid=valid,
                dtype=t,
                dictionary=dic,
            )
        )
        names.append(name)
    return Page(
        blocks=tuple(blocks),
        num_valid=torch.tensor(n, dtype=torch.int32),
        names=tuple(names),
    )


def _host_sort_perm(cols, keys, n: int) -> np.ndarray:
    """Stable lexicographic permutation; SQL null placement (nulls last
    in ASC, first in DESC, unless overridden) — numpy mirror of
    ops.common.sort_order."""
    lex = []
    for k in reversed(list(keys)):
        name = k.expr.name
        d, v, t, dic = cols[name]
        lanes = key_lanes_np(d, t)
        if k.descending:
            lanes = [~img for img in lanes]
        nf = k.nulls_first if k.nulls_first is not None else k.descending
        null_rank = np.where(v, 0, -1 if nf else 1).astype(np.int64)
        lex.extend(reversed(lanes))
        lex.append(null_rank)
    if not lex:
        return np.arange(n)
    return np.lexsort(lex)

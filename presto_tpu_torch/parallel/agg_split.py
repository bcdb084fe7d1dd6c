"""Partial/final aggregation decomposition.

The PyTorch counterpart of ``presto_tpu/parallel/agg_split.py``: the
two-step aggregation of a split stage, a PARTIAL step over each split
and a FINAL step over the partial states. The planner composes every
non-linear aggregate (avg, the variance family, ...) from primitive
mergeable states above the AggregationNode, so the table is small:
count and count_star merge by sum; sum, min and max merge with
themselves. Order-sensitive aggregates (array_agg, approx_percentile,
min_by, max_by) have no mergeable partial state: they raise, and the
stage cut falls back (``server/scheduler.py`` catches the error).
"""

from __future__ import annotations

from typing import List, Tuple

from presto_tpu_torch import expr as E
from presto_tpu_torch import types as T
from presto_tpu_torch.ops.aggregation import AggCall

#: partial-agg funcs whose merge is the same func over the partials
_SELF_MERGE = {"min": "min", "max": "max", "sum": "sum"}


def split_aggregation(
    group_keys: Tuple[Tuple[str, E.Expr], ...],
    aggs: Tuple[AggCall, ...],
):
    """Split (group_keys, aggs) into a partial and a final step.

    Returns (partial_aggs, final_group_keys, final_aggs, post_projs):
    the partial step is ``hash_aggregate(split, group_keys,
    partial_aggs)``, the final step ``hash_aggregate(partials,
    final_group_keys, final_aggs)``; ``post_projs`` is always None (the
    planner composes non-linear aggregates above the aggregation)."""
    partial_aggs: List[AggCall] = []
    final_aggs: List[AggCall] = []
    final_group_keys = tuple(
        (name, E.ColumnRef(name, e.dtype)) for name, e in group_keys
    )
    for a in aggs:
        rt = a.result_type()
        if a.func in ("count", "count_star"):
            partial_aggs.append(a)
            final_aggs.append(
                AggCall("sum", E.ColumnRef(a.out_name, T.BIGINT), a.out_name)
            )
        elif a.func in _SELF_MERGE:
            partial_aggs.append(a)
            final_aggs.append(
                AggCall(
                    _SELF_MERGE[a.func],
                    E.ColumnRef(a.out_name, rt),
                    a.out_name,
                )
            )
        else:
            raise NotImplementedError(
                f"no distributed decomposition for aggregate {a.func}"
            )
    return tuple(partial_aggs), final_group_keys, tuple(final_aggs), None

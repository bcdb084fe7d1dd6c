"""Plan fragmenter: cut the plan at the gather boundary.

The PyTorch counterpart of ``presto_tpu/parallel/fragmenter.py``. Each
maximal distributable subtree becomes a ``RemoteSourceNode``; everything
above it (final sort, limit, window, output) runs in the root fragment
over the gathered result. Split-streamed execution
(``exec/streaming.py``) streams each such fragment.
"""

from __future__ import annotations

from presto_tpu_torch.plan import nodes as N

#: node types a split fragment may hold; Sort/Limit/Window/Output/Values
#: run in the root fragment
_DISTRIBUTABLE = (
    N.TableScanNode,
    N.FilterNode,
    N.ProjectNode,
    N.AggregationNode,
    N.DistinctNode,
    N.JoinNode,
    N.CrossJoinNode,
)


def is_distributable(node: N.PlanNode) -> bool:
    """True when the whole subtree can run inside one split fragment."""
    if not isinstance(node, _DISTRIBUTABLE):
        return False
    if isinstance(node, N.JoinNode) and node.join_type == "full":
        # a broadcast-build FULL join would emit unmatched build rows
        # once per split: full joins stay in the root fragment
        return False
    return all(is_distributable(c) for c in node.children())


def insert_gathers(node: N.PlanNode) -> N.PlanNode:
    """Replace each maximal distributable subtree with RemoteSourceNode."""
    if is_distributable(node):
        return N.RemoteSourceNode(fragment_root=node)
    return N.map_children(node, insert_gathers)

"""The stage cut: one distributable fragment -> a split step and a
final step.

The PyTorch counterpart of the stage-cut part of
``presto_tpu/server/scheduler.py`` (``StagePlan``, ``plan_stage`` and
its helpers); the transport and range helpers belong to the server,
which is not ported yet.

One scan of the fragment is split by row ranges; every other scan is
replicated (each split sees it whole). The split scan must reach the
cut through row-distributive edges only: filters, projections, and the
probe side of joins (either side of an inner join), so concatenating
per-split results equals running the fragment whole. The cut is the
lowest aggregation or distinct above the split scan: each split runs the
PARTIAL step (``parallel/agg_split.py``), the final step merges the
partial states, and everything above the cut runs over the merged
result. ``plan_stage`` returns None when no scan admits such a cut.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from presto_tpu_torch.parallel.agg_split import split_aggregation
from presto_tpu_torch.plan import nodes as N


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """One distributable fragment cut into a split and a final step."""

    worker_fragment: N.PlanNode  # runs over each split of the scan
    final_root: N.PlanNode  # the final step, over a RemoteSourceNode
    partition_scan: int  # walk index (in worker_fragment) of the split scan
    partition_rows: int  # total row count of the split table


def plan_stage(
    fragment_root: N.PlanNode,
    catalogs,
    replicated_limit: Optional[int] = None,
) -> Optional[StagePlan]:
    """Cut one distributable fragment into a split and a final step,
    trying the scans largest first; None when no scan can be split
    without changing the result.

    ``replicated_limit`` (streaming): reject a cut whose split step
    would replicate another scan bigger than this. A streamed split step
    stages its replicated scans whole, so an oversized one must be the
    split scan of an earlier recursion step instead (``exec/streaming``
    runs big-over-big plans inner fragment first this way)."""
    sized: List[Tuple[int, N.TableScanNode]] = []
    for s in N.walk(fragment_root):
        if isinstance(s, N.TableScanNode):
            stats = catalogs.get(s.handle.catalog).metadata()
            sized.append(
                (int(stats.get_table_stats(s.handle).row_count or 0), s)
            )
    sized.sort(key=lambda t: -t[0])

    for rows, scan in sized:
        stage = _try_cut(fragment_root, scan, rows)
        if stage is None:
            continue
        if replicated_limit is not None:
            others = [
                r
                for r, s in sized
                if s is not scan
                and any(n is s for n in N.walk(stage.worker_fragment))
            ]
            if any(r > replicated_limit for r in others):
                continue
        return stage
    return None


def _path_to(root: N.PlanNode, target: N.PlanNode) -> Optional[list]:
    """Node path root -> ... -> target by identity, or None."""
    if root is target:
        return [root]
    for c in root.children():
        sub = _path_to(c, target)
        if sub is not None:
            return [root] + sub
    return None


def _edge_distributive(parent: N.PlanNode, child: N.PlanNode) -> bool:
    """True when splitting ``child``'s rows and concatenating
    ``parent``'s per-split outputs equals running ``parent`` whole."""
    if isinstance(parent, (N.FilterNode, N.ProjectNode)):
        return True
    if isinstance(parent, N.JoinNode):
        if parent.join_type == "inner":
            return True  # an inner join distributes over either side
        # semi/anti/left preserve the LEFT (probe) side only
        return child is parent.left
    if isinstance(parent, N.CrossJoinNode):
        # the right side is a broadcast scalar; only the left splits
        return child is parent.left
    return False


def _try_cut(
    fragment_root: N.PlanNode, scan: N.TableScanNode, rows: int
) -> Optional[StagePlan]:
    path = _path_to(fragment_root, scan)
    if path is None:
        return None

    # the lowest aggregation/distinct above the scan is the cut
    cut_i = None
    for i in range(len(path) - 2, -1, -1):
        if isinstance(path[i], (N.AggregationNode, N.DistinctNode)):
            cut_i = i
            break
    # every edge from the scan up to the cut (the root without one)
    # must be row-distributive
    lowest_parent = cut_i + 1 if cut_i is not None else 0
    for i in range(len(path) - 1, lowest_parent, -1):
        if not _edge_distributive(path[i - 1], path[i]):
            return None

    if cut_i is None:
        worker_root = fragment_root
        final_root: N.PlanNode = N.RemoteSourceNode(fragment_root=worker_root)
    else:
        cut = path[cut_i]
        if isinstance(cut, N.AggregationNode):
            try:
                partial_aggs, fkeys, faggs, post = split_aggregation(
                    cut.group_keys, cut.aggs
                )
            except NotImplementedError:
                return None  # no mergeable partial state: no cut
            worker_root = dataclasses.replace(cut, aggs=partial_aggs)
            remote = N.RemoteSourceNode(fragment_root=worker_root)
            final_sub: N.PlanNode = N.AggregationNode(
                source=remote,
                group_keys=fkeys,
                aggs=faggs,
                max_groups=cut.max_groups,
            )
            if post:
                final_sub = N.ProjectNode(source=final_sub, projections=post)
        else:  # DistinctNode: a distinct of distincts
            worker_root = cut
            remote = N.RemoteSourceNode(fragment_root=worker_root)
            final_sub = N.DistinctNode(source=remote, max_groups=cut.max_groups)
        final_root = _replace_on_path(path[:cut_i], cut, final_sub)

    scan_idx = next(
        (i for i, node in enumerate(N.walk(worker_root)) if node is scan),
        None,
    )
    if scan_idx is None:  # the scan is above the cut: nothing to split
        return None
    return StagePlan(
        worker_fragment=worker_root,
        final_root=final_root,
        partition_scan=scan_idx,
        partition_rows=rows,
    )


def _replace_on_path(
    ancestors: list, old: N.PlanNode, new: N.PlanNode
) -> N.PlanNode:
    """Rebuild the ancestor chain with ``old`` (a direct child of the
    last ancestor) swapped for ``new``."""
    for parent in reversed(ancestors):
        changes = {
            f.name: new
            for f in dataclasses.fields(parent)
            if getattr(parent, f.name) is old
        }
        assert changes, "path ancestor does not reference its child"
        new = dataclasses.replace(parent, **changes)
        old = parent
    return new

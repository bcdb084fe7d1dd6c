"""Logical plan node hierarchy.

Reference parity: presto-main's ``PlanNode`` tree — TableScanNode,
FilterNode, ProjectNode, AggregationNode, JoinNode, SortNode (TopN fused
via limit), LimitNode, WindowNode, OutputNode, ValuesNode (SURVEY.md
§2.1 "Logical planner"). SemiJoin/anti are JoinNode join_types, as in the
executor kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.spi import TableHandle
from presto_tpu_torch.expr import Expr
from presto_tpu_torch.ops.aggregation import AggCall
from presto_tpu_torch.ops.sort import SortKey
from presto_tpu_torch.ops.window import WindowCall


class PlanNode:
    def output_schema(self) -> Dict[str, T.DataType]:
        raise NotImplementedError

    def children(self) -> Sequence["PlanNode"]:
        return ()

    def fingerprint(self) -> str:
        """Stable id for the jit plan cache."""
        return repr(self)


@dataclasses.dataclass(frozen=True)
class TableScanNode(PlanNode):
    handle: TableHandle
    columns: Tuple[str, ...]
    schema: Tuple[Tuple[str, T.DataType], ...]  # ordered (name, type)
    #: TupleDomain-lite pushdown (reference: TupleDomain reaching
    #: ConnectorSplitManager): (column, allowed literal values) pairs
    #: derived from filters ABOVE the scan — advisory for split
    #: enumeration (hive partition pruning); the filter itself still
    #: applies, so ignoring the constraint is always correct.
    constraint: Tuple[Tuple[str, Tuple], ...] = ()

    def output_schema(self):
        return dict(self.schema)


@dataclasses.dataclass(frozen=True)
class ValuesNode(PlanNode):
    """Single-row relation for FROM-less SELECT (reference: ValuesNode)."""

    schema: Tuple[Tuple[str, T.DataType], ...] = ()

    def output_schema(self):
        return dict(self.schema)


@dataclasses.dataclass(frozen=True)
class FilterNode(PlanNode):
    source: PlanNode
    predicate: Expr
    #: runtime dynamic filter (build->probe, exec/dynfilter.py): the
    #: executor traces this node's pruned-row count as a program
    #: output (dynamic_filter.rows_pruned observability)
    dynamic: bool = False

    def output_schema(self):
        return self.source.output_schema()

    def children(self):
        return (self.source,)


@dataclasses.dataclass(frozen=True)
class ProjectNode(PlanNode):
    source: PlanNode
    projections: Tuple[Tuple[str, Expr], ...]

    def output_schema(self):
        return {n: e.dtype for n, e in self.projections}

    def children(self):
        return (self.source,)


@dataclasses.dataclass(frozen=True)
class AggregationNode(PlanNode):
    source: PlanNode
    group_keys: Tuple[Tuple[str, Expr], ...]
    aggs: Tuple[AggCall, ...]
    max_groups: int = 1 << 16  # capacity bucket; optimizer refines by stats

    def output_schema(self):
        out = {n: e.dtype for n, e in self.group_keys}
        for a in self.aggs:
            out[a.out_name] = a.result_type()
        return out

    def children(self):
        return (self.source,)


@dataclasses.dataclass(frozen=True)
class JoinNode(PlanNode):
    left: PlanNode  # probe
    right: PlanNode  # build
    join_type: str  # inner | left | full | semi | anti
    left_keys: Tuple[str, ...]
    right_keys: Tuple[str, ...]
    payload: Tuple[str, ...]  # build columns carried to output
    payload_rename: Tuple[Tuple[str, str], ...] = ()
    build_unique: bool = False
    out_capacity: Optional[int] = None  # None: planner fills from stats
    residual: Optional[Expr] = None  # non-equi conjuncts applied post-join

    def output_schema(self):
        out = dict(self.left.output_schema())
        rename = dict(self.payload_rename)
        if self.join_type in ("inner", "left", "full"):
            rs = self.right.output_schema()
            for c in self.payload:
                out[rename.get(c, c)] = rs[c]
        return out

    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class CrossJoinNode(PlanNode):
    """Cross product. ``out_capacity=None``: single-row right side only
    (scalar-aggregate broadcast — the common SQL shape, no expansion).
    With ``out_capacity``: general nested-loop product (reference:
    NestedLoopJoinOperator) under the capacity-bucket overflow
    protocol."""

    left: PlanNode
    right: PlanNode
    out_capacity: Optional[int] = None

    def output_schema(self):
        return {**self.left.output_schema(), **self.right.output_schema()}

    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class SortNode(PlanNode):
    source: PlanNode
    keys: Tuple[SortKey, ...]
    limit: Optional[int] = None  # fused TopN

    def output_schema(self):
        return self.source.output_schema()

    def children(self):
        return (self.source,)


@dataclasses.dataclass(frozen=True)
class LimitNode(PlanNode):
    source: PlanNode
    count: int

    def output_schema(self):
        return self.source.output_schema()

    def children(self):
        return (self.source,)


@dataclasses.dataclass(frozen=True)
class DistinctNode(PlanNode):
    source: PlanNode
    max_groups: int = 1 << 16

    def output_schema(self):
        return self.source.output_schema()

    def children(self):
        return (self.source,)


@dataclasses.dataclass(frozen=True)
class WindowNode(PlanNode):
    source: PlanNode
    partition_by: Tuple[Expr, ...]
    order_by: Tuple[SortKey, ...]
    calls: Tuple[WindowCall, ...]

    def output_schema(self):
        out = dict(self.source.output_schema())
        for c in self.calls:
            out[c.out_name] = c.result_type()
        return out

    def children(self):
        return (self.source,)


@dataclasses.dataclass(frozen=True)
class UnnestNode(PlanNode):
    """CROSS JOIN UNNEST(...) AS a(col [, ord]) — reference: UnnestNode
    (presto-main logical plan). Two forms:

    - constructor form (``elements``): ARRAY[e1..ek] is a trace-time
      expression list, so unnest is a static-width row expansion —
      every input row yields exactly k output rows (capacity x k,
      shapes static for XLA);
    - column form (``array_column``): a physical array column expands
      by per-row lengths under the engine's capacity-bucket protocol
      (``out_capacity`` + overflow retry)."""

    source: PlanNode
    elements: Tuple[Expr, ...]  # all pre-coerced to out_type
    out_name: str
    out_type: T.DataType
    ordinality_name: Optional[str] = None
    array_column: Optional[str] = None  # column form
    out_capacity: Optional[int] = None  # column form output bucket

    def output_schema(self):
        out = dict(self.source.output_schema())
        if self.array_column is not None:
            # column form drops nested columns (their repeated rows
            # could exceed the flat value capacity; see ops.unnest_column)
            out = {n: t for n, t in out.items() if not t.is_nested}
        out[self.out_name] = self.out_type
        if self.ordinality_name is not None:
            out[self.ordinality_name] = T.BIGINT
        return out

    def children(self):
        return (self.source,)


@dataclasses.dataclass(frozen=True)
class UnionAllNode(PlanNode):
    """UNION ALL: page concatenation (reference: UnionNode/ExchangeNode
    with multiple sources). The planner aligns every source to the same
    column names/types via projections; UNION DISTINCT is this node
    under a DistinctNode. TPU-first: concatenation of static-shape
    pages (capacities add), with string columns re-encoded through a
    trace-time union dictionary."""

    sources: Tuple[PlanNode, ...]

    def output_schema(self):
        return self.sources[0].output_schema()

    def children(self):
        return self.sources


@dataclasses.dataclass(frozen=True)
class RemoteSourceNode(PlanNode):
    """Fragment boundary: reads the gathered output of a distributed
    fragment (reference: RemoteSourceNode reading an upstream stage
    through the exchange, SURVEY.md §3.4). ``children()`` is empty on
    purpose — the fragment executes separately; walking the consuming
    fragment must not descend into it."""

    fragment_root: PlanNode

    def output_schema(self):
        return self.fragment_root.output_schema()


@dataclasses.dataclass(frozen=True)
class OutputNode(PlanNode):
    """Final column selection + user-visible names (reference: OutputNode)."""

    source: PlanNode
    columns: Tuple[Tuple[str, str], ...]  # (output name, source column)

    def output_schema(self):
        src = self.source.output_schema()
        return {out: src[col] for out, col in self.columns}

    def children(self):
        return (self.source,)


def walk(node: PlanNode):
    yield node
    for c in node.children():
        yield from walk(c)


def map_children(node: PlanNode, fn) -> PlanNode:
    """Rebuild ``node`` with ``fn`` applied to every direct child plan
    node — including tuple-of-PlanNode fields (UnionAllNode.sources) —
    returning ``node`` unchanged when nothing changed. The one
    child-rewrite loop every generic plan traversal should use."""
    changes = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, PlanNode):
            nv = fn(v)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, tuple) and v and isinstance(v[0], PlanNode):
            nt = tuple(fn(x) for x in v)
            if any(a is not b for a, b in zip(nt, v)):
                changes[f.name] = nt
    return dataclasses.replace(node, **changes) if changes else node

"""Untyped parse-tree AST.

Reference parity: presto-parser's ``Statement``/``Expression`` node
hierarchy (SURVEY.md §2.1). Types are resolved later by the analyzer
(presto_tpu.plan.analyzer), which lowers these into the typed
presto_tpu.expr IR.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


class Node:
    pass


# ----------------------------------------------------------- expressions


@dataclasses.dataclass(frozen=True)
class Ident(Node):
    parts: Tuple[str, ...]  # a / t.a / catalog.schema.t.a

    def __str__(self):
        return ".".join(self.parts)


@dataclasses.dataclass(frozen=True)
class NumberLit(Node):
    text: str  # kept verbatim: "1", "0.05" (decimal!), "1e9" (double)


@dataclasses.dataclass(frozen=True)
class StringLit(Node):
    value: str


@dataclasses.dataclass(frozen=True)
class DateLit(Node):
    value: str  # 'YYYY-MM-DD'


@dataclasses.dataclass(frozen=True)
class IntervalLit(Node):
    value: str
    unit: str  # day | month | year
    negative: bool = False


@dataclasses.dataclass(frozen=True)
class NullLit(Node):
    pass


@dataclasses.dataclass(frozen=True)
class BoolLit(Node):
    value: bool


@dataclasses.dataclass(frozen=True)
class Star(Node):
    qualifier: Optional[str] = None  # t.* keeps t


@dataclasses.dataclass(frozen=True)
class BinaryOp(Node):
    op: str  # + - * / % = <> != < <= > >= and or
    left: Node
    right: Node


@dataclasses.dataclass(frozen=True)
class UnaryOp(Node):
    op: str  # - not
    arg: Node


@dataclasses.dataclass(frozen=True)
class FuncCall(Node):
    name: str
    args: Tuple[Node, ...]
    distinct: bool = False
    window: Optional["Over"] = None


@dataclasses.dataclass(frozen=True)
class Over(Node):
    partition_by: Tuple[Node, ...]
    order_by: Tuple["SortItem", ...]
    #: None = default frame; "rows"/"range" = explicit
    #: BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW
    frame: "Optional[str]" = None


@dataclasses.dataclass(frozen=True)
class CaseExpr(Node):
    operand: Optional[Node]  # CASE x WHEN v ... vs searched CASE
    whens: Tuple[Tuple[Node, Node], ...]
    default: Optional[Node]


@dataclasses.dataclass(frozen=True)
class CastExpr(Node):
    arg: Node
    type_name: str


@dataclasses.dataclass(frozen=True)
class BetweenExpr(Node):
    arg: Node
    low: Node
    high: Node
    negate: bool = False


@dataclasses.dataclass(frozen=True)
class InList(Node):
    arg: Node
    values: Tuple[Node, ...]
    negate: bool = False


@dataclasses.dataclass(frozen=True)
class InSubquery(Node):
    arg: Node
    query: "Select"
    negate: bool = False


@dataclasses.dataclass(frozen=True)
class Exists(Node):
    query: "Select"
    negate: bool = False


@dataclasses.dataclass(frozen=True)
class ScalarSubquery(Node):
    query: "Select"


@dataclasses.dataclass(frozen=True)
class LikeExpr(Node):
    arg: Node
    pattern: Node
    negate: bool = False


@dataclasses.dataclass(frozen=True)
class IsNullExpr(Node):
    arg: Node
    negate: bool = False


@dataclasses.dataclass(frozen=True)
class ExtractExpr(Node):
    field: str
    arg: Node


# ------------------------------------------------------------- relations


@dataclasses.dataclass(frozen=True)
class TableRef(Node):
    parts: Tuple[str, ...]  # [catalog.][schema.]table
    alias: Optional[str] = None
    #: FOR VERSION AS OF <id> — pin a committed snapshot (time travel)
    version: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class SubqueryRef(Node):
    query: "Select"
    alias: str


@dataclasses.dataclass(frozen=True)
class JoinRel(Node):
    left: Node
    right: Node
    join_type: str  # inner | left | right | full | cross
    on: Optional[Node] = None


@dataclasses.dataclass(frozen=True)
class ArrayLit(Node):
    """ARRAY[e1, ..., ek] constructor (plan-time list; the engine keeps
    arrays as trace-time expression lists — see planner UNNEST rewrite)."""

    items: Tuple[Node, ...]


@dataclasses.dataclass(frozen=True)
class UnnestRef(Node):
    """UNNEST(arr) [WITH ORDINALITY] AS alias (col [, ord]) in FROM."""

    array: Node
    alias: str
    column: str
    ordinality: Optional[str] = None  # ordinality column name


@dataclasses.dataclass(frozen=True)
class ValuesRel(Node):
    """(VALUES (...), (...)) AS alias [(col, ...)] — an inline table
    relation (reference: Values as a query body)."""

    rows: Tuple[Tuple[Node, ...], ...]
    alias: str
    column_names: Tuple[str, ...] = ()  # defaults: _col1, _col2, ...


@dataclasses.dataclass(frozen=True)
class UnionRel(Node):
    """A set-operation chain as a relation: terms[0] (op terms[i+1])*,
    left-associative; ``ops[i]`` in {"union_all", "union",
    "intersect", "except"} is the operator between terms[i] and
    terms[i+1] (INTERSECT chains pre-bind tighter in the parser). The
    parser wraps any chain as ``SELECT * FROM UnionRel`` so ORDER
    BY/LIMIT apply to the whole statement."""

    terms: Tuple["Select", ...]
    ops: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class GroupingSets(Node):
    """One GROUP BY element carrying multiple grouping sets — the
    parsed form of ROLLUP(...) / CUBE(...) / GROUPING SETS (...).
    Desugared before planning AND before sqlite rendering into an
    outer select over a UNION ALL of per-set aggregations
    (sql/grouping_sets.py) — sqlite has no native grouping sets, and
    the engine's one-hot aggregation needs fixed key sets per program
    anyway (reference: GroupIdNode + repeated-source expansion)."""

    sets: Tuple[Tuple[Node, ...], ...]


# ------------------------------------------------------------ statements


@dataclasses.dataclass(frozen=True)
class SelectItem(Node):
    expr: Node
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SortItem(Node):
    expr: Node
    descending: bool = False
    nulls_first: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class Select(Node):
    items: Tuple[SelectItem, ...]
    from_: Optional[Node]  # TableRef | SubqueryRef | JoinRel | None
    where: Optional[Node] = None
    group_by: Tuple[Node, ...] = ()
    having: Optional[Node] = None
    order_by: Tuple[SortItem, ...] = ()
    limit: Optional[int] = None
    distinct: bool = False
    ctes: Tuple[Tuple[str, "Select"], ...] = ()


@dataclasses.dataclass(frozen=True)
class SetSession(Node):
    name: str
    value: object


@dataclasses.dataclass(frozen=True)
class Explain(Node):
    statement: Node
    analyze: bool = False


@dataclasses.dataclass(frozen=True)
class ShowTables(Node):
    schema: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ShowSchemas(Node):
    catalog: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ShowSession(Node):
    pass


@dataclasses.dataclass(frozen=True)
class ShowColumns(Node):
    """SHOW COLUMNS FROM t / DESCRIBE t (reference: ShowColumns)."""

    target: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Delete(Node):
    """DELETE FROM target [WHERE pred] (reference: Delete)."""

    target: Tuple[str, ...]
    where: Optional[Node] = None


@dataclasses.dataclass(frozen=True)
class Prepare(Node):
    """PREPARE name FROM statement (reference: Prepare)."""

    name: str
    statement: Node


@dataclasses.dataclass(frozen=True)
class Execute(Node):
    """EXECUTE name [USING expr, ...] (reference: Execute)."""

    name: str
    params: Tuple[Node, ...] = ()


@dataclasses.dataclass(frozen=True)
class Deallocate(Node):
    """DEALLOCATE PREPARE name."""

    name: str


@dataclasses.dataclass(frozen=True)
class ParamMarker(Node):
    """A ``?`` placeholder inside a prepared statement."""

    index: int


@dataclasses.dataclass(frozen=True)
class BoundParam(Node):
    """A canonicalized literal (plan/canonical.py): a comparison-operand
    NumberLit/DateLit hoisted out of the statement so structurally
    identical queries share one parse->plan->compile artifact. The
    analyzer lowers it to an ``expr.RuntimeParam`` — a device input of
    the compiled program — never to a constant.

    ``lit`` (the original literal node) is excluded from repr/compare on
    purpose: two statements differing only in hoisted literal VALUES
    must produce equal — and equally-printed — canonical ASTs, which is
    what the plan-cache key hashes. ``dtype_name`` keeps the value's
    TYPE in the key (int vs double vs decimal(p,s) literals plan
    differently, so they must not share an entry)."""

    ordinal: int
    dtype_name: str
    lit: Node = dataclasses.field(repr=False, compare=False, default=None)


@dataclasses.dataclass(frozen=True)
class Insert(Node):
    """INSERT INTO target (SELECT ... | VALUES (...), ...). ``values``
    rows hold literal expression nodes."""

    target: Tuple[str, ...]
    query: Optional[Node] = None
    values: Optional[Tuple[Tuple[Node, ...], ...]] = None


@dataclasses.dataclass(frozen=True)
class CreateTableAs(Node):
    target: Tuple[str, ...]
    query: Node = None


@dataclasses.dataclass(frozen=True)
class CreateTable(Node):
    """CREATE TABLE t (col type, ...) — plain DDL."""

    target: Tuple[str, ...]
    columns: Tuple[Tuple[str, str], ...]  # (name, type text)


@dataclasses.dataclass(frozen=True)
class DropTable(Node):
    target: Tuple[str, ...]
    if_exists: bool = False


@dataclasses.dataclass(frozen=True)
class Update(Node):
    """UPDATE t SET col = expr [, ...] [WHERE pred]."""

    target: Tuple[str, ...]
    assignments: Tuple[Tuple[str, Node], ...]
    where: Optional[Node] = None


@dataclasses.dataclass(frozen=True)
class CreateMaterializedView(Node):
    """CREATE MATERIALIZED VIEW name AS select (reference:
    CreateMaterializedView). The view materializes into a stored table
    under ``target``; eligible aggregate shapes are maintained
    incrementally on ingest commits (exec/mview.py)."""

    target: Tuple[str, ...]
    query: Node = None


@dataclasses.dataclass(frozen=True)
class RefreshMaterializedView(Node):
    """REFRESH MATERIALIZED VIEW name — a full recompute from the base
    table (reference: RefreshMaterializedView)."""

    target: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class DropMaterializedView(Node):
    """DROP MATERIALIZED VIEW [IF EXISTS] name."""

    target: Tuple[str, ...]
    if_exists: bool = False

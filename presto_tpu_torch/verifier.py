"""Cross-engine verifier: run the same SQL on this engine and on a CPU
oracle (sqlite), diff the results.

The PyTorch port's copy of ``presto_tpu/verifier.py``, over the port's
own tpch and tpcds generators. Reference parity: ``presto-verifier`` —
replay a query corpus against two engines and diff. Here the control
engine is sqlite over the SAME generated data; the test engine is the
port. SQL is parsed once by the port's parser and re-rendered into
sqlite's dialect (date arithmetic via date(), EXTRACT via strftime,
decimals as REAL with tolerance-based comparison).
"""

from __future__ import annotations

import math
import sqlite3
from typing import Dict, List, Optional

import numpy as np

from presto_tpu_torch.connectors.spi import TableHandle
from presto_tpu_torch.connectors.tpch import DictColumn, TpchConnector
from presto_tpu_torch.sql import ast, parse_statement

_EPOCH_OFFSET = 719163  # days from 0001-01-01 to 1970-01-01 per date.toordinal


def _days_to_iso(days: np.ndarray) -> List[str]:
    import datetime

    epoch = datetime.date(1970, 1, 1)
    return [
        (epoch + datetime.timedelta(days=int(d))).isoformat() for d in days
    ]


def _make_moment_agg(ddof: int, sqrt_out: bool):
    """sqlite aggregate factory for stddev/variance families."""

    class _Agg:
        def __init__(self):
            self.vals = []

        def step(self, v):
            if v is not None:
                self.vals.append(float(v))

        def finalize(self):
            n = len(self.vals)
            if n <= ddof:
                return None
            mean = sum(self.vals) / n
            var = sum((x - mean) ** 2 for x in self.vals) / (n - ddof)
            return var ** 0.5 if sqrt_out else var

    return _Agg


class SqliteOracle:
    """sqlite mirror of a generated-catalog schema (decimals as REAL,
    dates as ISO TEXT) plus the dialect renderer. ``catalog`` selects
    the fixture connector: "tpch" (default) or "tpcds"."""

    def __init__(self, schema: str = "tiny", catalog: str = "tpch"):
        self.conn = sqlite3.connect(":memory:")
        # statistics aggregates sqlite lacks (engine side:
        # functions.py registry) — Welford-free two-pass-safe sums
        for name, ddof in (
            ("stddev_samp", 1), ("stddev", 1), ("stddev_pop", 0),
            ("var_samp", 1), ("variance", 1), ("var_pop", 0),
        ):
            self.conn.create_aggregate(
                name, 1, _make_moment_agg(ddof, name.startswith("std"))
            )
        self.schema = schema
        self.catalog = catalog
        if catalog == "tpch":
            self._connector = TpchConnector()
            from presto_tpu_torch.connectors.tpch import TABLE_SCHEMAS as ts
        elif catalog == "tpcds":
            from presto_tpu_torch.connectors.tpcds import (
                TABLE_SCHEMAS as ts,
                TpcdsConnector,
            )

            self._connector = TpcdsConnector()
        else:
            raise KeyError(f"no oracle fixture for catalog {catalog}")
        self._table_schemas = ts
        self._loaded: set = set()

    def load_table(self, table: str) -> None:
        if table in self._loaded:
            return
        tschema = self._table_schemas[table]
        handle = TableHandle(self.catalog, self.schema, table)
        cols = list(tschema)
        defs = []
        for c in cols:
            t = tschema[c]
            if t.is_string or t.name == "date":
                defs.append(f"{c} TEXT")
            elif t.is_decimal or t.name in ("double", "real"):
                defs.append(f"{c} REAL")
            else:
                defs.append(f"{c} INTEGER")
        self.conn.execute(f"CREATE TABLE {table} ({', '.join(defs)})")
        src = self._connector.get_splits(handle, target_split_rows=1 << 20)
        while not src.exhausted:
            for split in src.next_batch(16):
                data = self._connector.create_page_source(split, cols)
                rows = []
                n = split.num_rows
                decoded = {}
                for c in cols:
                    t = tschema[c]
                    v = data[c]
                    if isinstance(v, DictColumn):
                        decoded[c] = v.values[v.ids]
                    elif t.name == "date":
                        decoded[c] = _days_to_iso(v)
                    elif t.is_decimal:
                        decoded[c] = (
                            np.asarray(v, dtype=np.float64) / (10 ** t.scale)
                        )
                    else:
                        decoded[c] = v
                for i in range(n):
                    rows.append(tuple(decoded[c][i] for c in cols))
                self.conn.executemany(
                    f"INSERT INTO {table} VALUES "
                    f"({', '.join('?' * len(cols))})",
                    [
                        tuple(
                            x.item() if isinstance(x, np.generic) else x
                            for x in row
                        )
                        for row in rows
                    ],
                )
        # surrogate/join-key indexes: at SF1+ sqlite's nested-loop
        # joins over multi-million-row fact tables need them to finish
        # in suite-tolerable time (tiny-scale cost is negligible)
        for c in cols:
            if c.endswith("_sk") or c.endswith("key"):
                self.conn.execute(
                    f"CREATE INDEX idx_{table}_{c} ON {table} ({c})"
                )
        self.conn.commit()
        self._loaded.add(table)

    def execute(self, sql: str) -> List[tuple]:
        from presto_tpu_torch.sql.grouping_sets import desugar_tree

        stmt = parse_statement(sql)
        assert isinstance(stmt, ast.Select)
        # sqlite has no GROUPING SETS: render the same desugared tree
        # the planner executes (an independent execution of identical
        # plain-SQL semantics)
        stmt = desugar_tree(stmt)
        for t in _tables_of(stmt):
            if t in self._table_schemas:
                self.load_table(t)
        rendered = render_sqlite(stmt)
        cur = self.conn.execute(rendered)
        return cur.fetchall()


def _tables_of(node) -> set:
    import dataclasses

    out = set()

    def visit(n):
        if isinstance(n, ast.TableRef):
            out.add(n.parts[-1])
        if dataclasses.is_dataclass(n):
            for f in dataclasses.fields(n):
                v = getattr(n, f.name)
                if isinstance(v, ast.Node):
                    visit(v)
                elif isinstance(v, tuple):
                    for x in v:
                        if isinstance(x, ast.Node):
                            visit(x)
                        elif isinstance(x, tuple):
                            for y in x:
                                if isinstance(y, ast.Node):
                                    visit(y)

    visit(node)
    return out


# ------------------------------------------------------- dialect renderer


def render_sqlite(n: ast.Node) -> str:
    return _r(n)


def _r(n: ast.Node) -> str:
    if isinstance(n, ast.Select):
        parts = []
        if n.ctes:
            parts.append(
                "WITH "
                + ", ".join(f"{name} AS ({_r(q)})" for name, q in n.ctes)
            )
        sel = "SELECT " + ("DISTINCT " if n.distinct else "")
        sel += ", ".join(
            _r(i.expr) + (f" AS {i.alias}" if i.alias else "")
            for i in n.items
        )
        parts.append(sel)
        if n.from_ is not None:
            parts.append("FROM " + _r(n.from_))
        if n.where is not None:
            parts.append("WHERE " + _r(n.where))
        if n.group_by:
            parts.append("GROUP BY " + ", ".join(_r(g) for g in n.group_by))
        if n.having is not None:
            parts.append("HAVING " + _r(n.having))
        if n.order_by:
            parts.append(
                "ORDER BY "
                + ", ".join(
                    _r(s.expr)
                    + (" DESC" if s.descending else "")
                    + (
                        # engine default (ops/sort.py): NULLS LAST in
                        # ASC, FIRST in DESC; sqlite defaults differ,
                        # so render it explicitly either way
                        " NULLS FIRST"
                        if (
                            s.nulls_first
                            if s.nulls_first is not None
                            else s.descending
                        )
                        else " NULLS LAST"
                    )
                    for s in n.order_by
                )
            )
        if n.limit is not None:
            parts.append(f"LIMIT {n.limit}")
        return " ".join(parts)
    if isinstance(n, ast.TableRef):
        t = n.parts[-1]
        return t + (f" AS {n.alias}" if n.alias else "")
    if isinstance(n, ast.SubqueryRef):
        return f"({_r(n.query)}) AS {n.alias}"
    if isinstance(n, ast.JoinRel):
        if n.join_type == "cross":
            return f"{_r(n.left)}, {_r(n.right)}"
        jt = n.join_type.upper()
        on = f" ON {_r(n.on)}" if n.on is not None else ""
        return f"{_r(n.left)} {jt} JOIN {_r(n.right)}{on}"
    if isinstance(n, ast.Ident):
        return ".".join(n.parts)
    if isinstance(n, ast.NumberLit):
        return n.text
    if isinstance(n, ast.StringLit):
        return "'" + n.value.replace("'", "''") + "'"
    if isinstance(n, ast.DateLit):
        return f"'{n.value}'"
    if isinstance(n, ast.NullLit):
        return "NULL"
    if isinstance(n, ast.BoolLit):
        return "1" if n.value else "0"
    if isinstance(n, ast.BinaryOp):
        if n.op in ("+", "-") and isinstance(n.right, ast.IntervalLit):
            sign = "+" if n.op == "+" else "-"
            iv = n.right
            amt = int(iv.value) * (-1 if iv.negative else 1)
            if sign == "-":
                amt = -amt
            return f"date({_r(n.left)}, '{amt:+d} {iv.unit}')"
        if n.op == "%":
            return f"({_r(n.left)} % {_r(n.right)})"
        op = {"and": "AND", "or": "OR"}.get(n.op, n.op)
        return f"({_r(n.left)} {op} {_r(n.right)})"
    if isinstance(n, ast.UnaryOp):
        if n.op == "not":
            return f"(NOT {_r(n.arg)})"
        return f"(-{_r(n.arg)})"
    if isinstance(n, ast.FuncCall):
        if n.window is not None:
            over = []
            if n.window.partition_by:
                over.append(
                    "PARTITION BY "
                    + ", ".join(_r(p) for p in n.window.partition_by)
                )
            if n.window.order_by:
                over.append(
                    "ORDER BY "
                    + ", ".join(
                        _r(s.expr) + (" DESC" if s.descending else "")
                        for s in n.window.order_by
                    )
                )
            if n.window.frame:
                over.append(
                    f"{n.window.frame.upper()} BETWEEN UNBOUNDED "
                    "PRECEDING AND CURRENT ROW"
                )
            args = ", ".join(_r(a) for a in n.args)
            return f"{n.name}({args}) OVER ({' '.join(over)})"
        if n.name == "count" and not n.args:
            return "count(*)"
        if n.name == "substring":
            args = ", ".join(_r(a) for a in n.args)
            return f"substr({args})"
        if n.name == "concat":
            # sqlite <3.44 has no concat(); render the || operator
            return "(" + " || ".join(_r(a) for a in n.args) + ")"
        d = "DISTINCT " if n.distinct else ""
        return f"{n.name}({d}{', '.join(_r(a) for a in n.args)})"
    if isinstance(n, ast.CaseExpr):
        s = "CASE"
        if n.operand is not None:
            s += " " + _r(n.operand)
        for c, v in n.whens:
            s += f" WHEN {_r(c)} THEN {_r(v)}"
        if n.default is not None:
            s += f" ELSE {_r(n.default)}"
        return s + " END"
    if isinstance(n, ast.CastExpr):
        t = n.type_name.lower()
        if t.startswith("decimal") or t in ("double", "real"):
            st = "REAL"
        elif t.startswith("varchar") or t.startswith("char"):
            st = "TEXT"
        else:
            st = "INTEGER"
        return f"CAST({_r(n.arg)} AS {st})"
    if isinstance(n, ast.BetweenExpr):
        neg = "NOT " if n.negate else ""
        return f"({_r(n.arg)} {neg}BETWEEN {_r(n.low)} AND {_r(n.high)})"
    if isinstance(n, ast.InList):
        neg = "NOT " if n.negate else ""
        return (
            f"({_r(n.arg)} {neg}IN "
            f"({', '.join(_r(v) for v in n.values)}))"
        )
    if isinstance(n, ast.InSubquery):
        neg = "NOT " if n.negate else ""
        return f"({_r(n.arg)} {neg}IN ({_r(n.query)}))"
    if isinstance(n, ast.Exists):
        neg = "NOT " if n.negate else ""
        return f"({neg}EXISTS ({_r(n.query)}))"
    if isinstance(n, ast.ScalarSubquery):
        return f"({_r(n.query)})"
    if isinstance(n, ast.LikeExpr):
        neg = "NOT " if n.negate else ""
        return f"({_r(n.arg)} {neg}LIKE {_r(n.pattern)})"
    if isinstance(n, ast.IsNullExpr):
        return f"({_r(n.arg)} IS {'NOT ' if n.negate else ''}NULL)"
    if isinstance(n, ast.ExtractExpr):
        fmt = {"year": "%Y", "month": "%m", "day": "%d"}[n.field.lower()]
        return f"CAST(strftime('{fmt}', {_r(n.arg)}) AS INTEGER)"
    if isinstance(n, ast.Star):
        return (n.qualifier + ".*") if n.qualifier else "*"
    if isinstance(n, ast.ValuesRel):
        # portable rendering: UNION ALL of FROM-less SELECTs (sqlite's
        # VALUES form cannot name columns)
        names = n.column_names or tuple(
            f"_col{i}" for i in range(len(n.rows[0]))
        )
        selects = []
        for ri, row in enumerate(n.rows):
            cols = ", ".join(
                _r(v) + (f" AS {names[ci]}" if ri == 0 else "")
                for ci, v in enumerate(row)
            )
            selects.append("SELECT " + cols)
        return (
            "(" + " UNION ALL ".join(selects) + f") AS {n.alias}"
        )
    if isinstance(n, ast.UnionRel):
        kw = {
            "union_all": "UNION ALL",
            "union": "UNION",
            "intersect": "INTERSECT",
            "except": "EXCEPT",
        }
        rendered = [_r(n.terms[0])]
        for t, op in zip(n.terms[1:], n.ops):
            rendered.append(kw[op])
            rendered.append(_r(t))
        return "(" + " ".join(rendered) + ")"
    if isinstance(n, ast.IntervalLit):
        raise ValueError("bare interval outside date arithmetic")
    raise ValueError(f"cannot render {type(n).__name__} for sqlite")


# ------------------------------------------------------------- comparison


def normalize_row(row, rel_tol=1e-6):
    out = []
    for v in row:
        if isinstance(v, bool):
            out.append(int(v))
        elif isinstance(v, float):
            out.append(v)
        elif hasattr(v, "isoformat"):  # date
            out.append(v.isoformat())
        else:
            out.append(v)
    return tuple(out)


def rows_equal(a, b, rel_tol=1e-6, abs_tol=1e-9) -> bool:
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x is None or y is None:
            if not (x is None and y is None):
                return False
            continue
        if isinstance(x, float) or isinstance(y, float):
            if not math.isclose(
                float(x), float(y), rel_tol=rel_tol, abs_tol=abs_tol
            ):
                return False
        else:
            if str(x) != str(y):
                return False
    return True


def diff_results(
    ours: List[tuple],
    oracle: List[tuple],
    ordered: bool,
    rel_tol: float = 1e-6,
) -> Optional[str]:
    """None if equal, else a human-readable first-difference report."""
    a = [normalize_row(r, rel_tol) for r in ours]
    b = [normalize_row(r, rel_tol) for r in oracle]
    if not ordered:
        keyf = lambda r: tuple(  # noqa: E731
            (x is None, str(x) if not isinstance(x, float) else round(x, 6))
            for x in r
        )
        a = sorted(a, key=keyf)
        b = sorted(b, key=keyf)
    if len(a) != len(b):
        return f"row count mismatch: engine={len(a)} oracle={len(b)}"
    for i, (ra, rb) in enumerate(zip(a, b)):
        if not rows_equal(ra, rb, rel_tol):
            return f"row {i} differs:\n  engine: {ra}\n  oracle: {rb}"
    return None


def verify_query(
    runner, oracle: SqliteOracle, sql: str, rel_tol: float = 1e-6
) -> Optional[str]:
    """Run on both engines; None = match, else the difference report."""
    ours = runner.execute(sql).rows()
    theirs = oracle.execute(sql)
    stmt = parse_statement(sql)
    ordered = bool(stmt.order_by)
    return diff_results(ours, theirs, ordered, rel_tol)


def verify_offload(
    sql: str, rel_tol: float = 1e-6, device=None
) -> Optional[str]:
    """Cross-device verification: run the SAME SQL on a runner on
    ``device`` (CUDA unless the caller names another) and on one on the
    CPU, and diff the results — the reference's presto-verifier
    control-vs-test replay, with the swap made at the runner's device
    instead of across clusters: the card-vs-CPU semantic sanitizer."""
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner

    on = LocalQueryRunner(device=device)
    off = LocalQueryRunner(device="cpu")
    ours = on.execute(sql).rows()
    theirs = off.execute(sql).rows()
    stmt = parse_statement(sql)
    ordered = bool(stmt.order_by)
    return diff_results(ours, theirs, ordered, rel_tol)

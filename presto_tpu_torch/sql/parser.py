"""Recursive-descent SQL parser.

Reference parity: presto-parser's ``SqlParser.createStatement`` +
``AstBuilder`` (SURVEY.md §2.1); grammar shape follows standard SQL
precedence (OR < AND < NOT < predicate < additive < multiplicative <
unary < postfix/primary).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from presto_tpu_torch.sql import ast
from presto_tpu_torch.sql.tokenizer import Token, tokenize


class ParseError(ValueError):
    pass


def parse_statement(sql: str) -> ast.Node:
    return _Parser(tokenize(sql)).parse_statement()


#: keywords that stay usable as plain identifiers (table/column
#: position AND expression position)
SOFT_IDENT_KEYWORDS = frozenset({
    "date", "year", "month", "day", "values", "tables", "schemas",
    "first", "last", "columns", "using", "execute", "prepare",
    "delete", "describe", "deallocate", "if", "drop", "update",
    "materialized", "view", "refresh",
})


class _Parser:
    def __init__(self, tokens: List[Token]):
        self.tokens = tokens
        self.pos = 0
        self._param_idx = 0

    # ------------------------------------------------------- token plumbing

    @property
    def cur(self) -> Token:
        return self.tokens[self.pos]

    def peek_kw(self, *kws: str) -> bool:
        t = self.cur
        return t.kind == "kw" and t.value in kws

    def peek_op(self, *ops: str) -> bool:
        t = self.cur
        return t.kind == "op" and t.value in ops

    def advance(self) -> Token:
        t = self.cur
        self.pos += 1
        return t

    def accept_kw(self, *kws: str) -> Optional[str]:
        if self.peek_kw(*kws):
            return self.advance().value
        return None

    def accept_op(self, *ops: str) -> Optional[str]:
        if self.peek_op(*ops):
            return self.advance().value
        return None

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            raise ParseError(
                f"expected {kw.upper()} but found "
                f"{self.cur.value!r} at position {self.cur.pos}"
            )

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise ParseError(
                f"expected {op!r} but found "
                f"{self.cur.value!r} at position {self.cur.pos}"
            )

    def expect_ident(self) -> str:
        t = self.cur
        if t.kind == "ident":
            return self.advance().value
        # soft keywords usable as identifiers in table/column position
        if t.kind == "kw" and t.value in SOFT_IDENT_KEYWORDS:
            return self.advance().value
        raise ParseError(
            f"expected identifier but found {t.value!r} at position {t.pos}"
        )

    # ---------------------------------------------------------- statements

    def parse_statement(self) -> ast.Node:
        if self.accept_kw("explain"):
            analyze = bool(self.accept_kw("analyze"))
            stmt = self.parse_statement()
            return ast.Explain(stmt, analyze)
        if self.accept_kw("set"):
            self.expect_kw("session")
            name = self.expect_ident()
            self.expect_op("=")
            t = self.advance()
            if t.kind == "string":
                value: object = t.value
            elif t.kind == "number":
                value = float(t.value) if "." in t.value else int(t.value)
            elif t.kind == "kw" and t.value in ("true", "false"):
                value = t.value == "true"
            else:
                value = t.value
            self._finish()
            return ast.SetSession(name, value)
        if self.accept_kw("show"):
            if self.accept_kw("tables"):
                schema = None
                if self.accept_kw("from"):
                    schema = self.expect_ident()
                self._finish()
                return ast.ShowTables(schema)
            if self.accept_kw("schemas"):
                catalog = None
                if self.accept_kw("from"):
                    catalog = self.expect_ident()
                self._finish()
                return ast.ShowSchemas(catalog)
            if self.accept_kw("session"):
                self._finish()
                return ast.ShowSession()
            if self.accept_kw("columns"):
                self.expect_kw("from")
                target = self._qualified_name()
                self._finish()
                return ast.ShowColumns(target)
            raise ParseError(f"unsupported SHOW at {self.cur.pos}")
        if self.accept_kw("describe"):
            target = self._qualified_name()
            self._finish()
            return ast.ShowColumns(target)
        if self.accept_kw("delete"):
            self.expect_kw("from")
            target = self._qualified_name()
            where = (
                self.parse_expr() if self.accept_kw("where") else None
            )
            self._finish()
            return ast.Delete(target, where)
        if self.accept_kw("prepare"):
            name = self.expect_ident()
            self.expect_kw("from")
            if self.peek_kw("insert"):
                self.advance()
                self.expect_kw("into")
                target = self._qualified_name()
                if self.accept_kw("values"):
                    rows = [self._values_row()]
                    while self.accept_op(","):
                        rows.append(self._values_row())
                    inner: ast.Node = ast.Insert(
                        target, values=tuple(rows)
                    )
                else:
                    inner = ast.Insert(target, query=self.parse_select())
            elif self.peek_kw("delete"):
                self.advance()
                self.expect_kw("from")
                target = self._qualified_name()
                where = (
                    self.parse_expr()
                    if self.accept_kw("where")
                    else None
                )
                inner = ast.Delete(target, where)
            elif self.peek_kw("update"):
                self.advance()
                target = self._qualified_name()
                self.expect_kw("set")
                assigns = []
                while True:
                    col = self.expect_ident()
                    self.expect_op("=")
                    assigns.append((col, self.parse_expr()))
                    if not self.accept_op(","):
                        break
                where = (
                    self.parse_expr()
                    if self.accept_kw("where")
                    else None
                )
                inner = ast.Update(target, tuple(assigns), where)
            else:
                inner = self.parse_select()
            self._finish()
            return ast.Prepare(name, inner)
        if self.accept_kw("execute"):
            name = self.expect_ident()
            params: List[ast.Node] = []
            if self.accept_kw("using"):
                params.append(self.parse_expr())
                while self.accept_op(","):
                    params.append(self.parse_expr())
            self._finish()
            return ast.Execute(name, tuple(params))
        if self.accept_kw("deallocate"):
            self.expect_kw("prepare")
            name = self.expect_ident()
            self._finish()
            return ast.Deallocate(name)
        if self.accept_kw("insert"):
            self.expect_kw("into")
            target = self._qualified_name()
            if self.accept_kw("values"):
                rows = [self._values_row()]
                while self.accept_op(","):
                    rows.append(self._values_row())
                self._finish()
                return ast.Insert(target, values=tuple(rows))
            sel = self.parse_select()
            self._finish()
            return ast.Insert(target, query=sel)
        if self.accept_kw("refresh"):
            self.expect_kw("materialized")
            self.expect_kw("view")
            target = self._qualified_name()
            self._finish()
            return ast.RefreshMaterializedView(target)
        if self.accept_kw("create"):
            if self.accept_kw("materialized"):
                self.expect_kw("view")
                target = self._qualified_name()
                self.expect_kw("as")
                sel = self.parse_select()
                self._finish()
                return ast.CreateMaterializedView(target, sel)
            self.expect_kw("table")
            target = self._qualified_name()
            if self.accept_op("("):
                cols = []
                while True:
                    name = self.expect_ident()
                    cols.append((name, self._type_text()))
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                self._finish()
                return ast.CreateTable(target, tuple(cols))
            self.expect_kw("as")
            sel = self.parse_select()
            self._finish()
            return ast.CreateTableAs(target, sel)
        if self.accept_kw("update"):
            target = self._qualified_name()
            self.expect_kw("set")
            assigns = []
            while True:
                col = self.expect_ident()
                self.expect_op("=")
                assigns.append((col, self.parse_expr()))
                if not self.accept_op(","):
                    break
            where = (
                self.parse_expr() if self.accept_kw("where") else None
            )
            self._finish()
            return ast.Update(target, tuple(assigns), where)
        if self.accept_kw("drop"):
            if self.accept_kw("materialized"):
                self.expect_kw("view")
                if_exists = False
                if self.accept_kw("if"):
                    self.expect_kw("exists")
                    if_exists = True
                target = self._qualified_name()
                self._finish()
                return ast.DropMaterializedView(target, if_exists)
            self.expect_kw("table")
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            target = self._qualified_name()
            self._finish()
            return ast.DropTable(target, if_exists)
        sel = self.parse_select()
        self._finish()
        return sel

    def _qualified_name(self):
        parts = [self.expect_ident()]
        while self.accept_op("."):
            parts.append(self.expect_ident())
        return tuple(parts)

    def _values_row(self):
        self.expect_op("(")
        exprs = [self.parse_expr()]
        while self.accept_op(","):
            exprs.append(self.parse_expr())
        self.expect_op(")")
        return tuple(exprs)

    def _finish(self):
        self.accept_op(";")
        if self.cur.kind != "eof":
            raise ParseError(
                f"unexpected trailing input {self.cur.value!r} "
                f"at position {self.cur.pos}"
            )

    # ------------------------------------------------------------- queries

    def parse_select(self) -> ast.Select:
        ctes: List[Tuple[str, ast.Select]] = []
        if self.accept_kw("with"):
            while True:
                name = self.expect_ident()
                self.expect_kw("as")
                self.expect_op("(")
                ctes.append((name, self.parse_select()))
                self.expect_op(")")
                if not self.accept_op(","):
                    break
        first = self._intersect_chain()
        terms: List[ast.Select] = []
        ops: List[str] = []
        while True:
            if self.accept_kw("union"):
                all_ = bool(self.accept_kw("all"))
                if not all_:
                    self.accept_kw("distinct")
                ops.append("union_all" if all_ else "union")
            elif self.accept_kw("except"):
                if self.peek_kw("all"):
                    raise ParseError(
                        "EXCEPT ALL is not supported (DISTINCT "
                        "semantics only)"
                    )
                self.accept_kw("distinct")
                ops.append("except")
            else:
                break
            terms.append(self._intersect_chain())
        order_by: List[ast.SortItem] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by.append(self._sort_item())
            while self.accept_op(","):
                order_by.append(self._sort_item())
        limit = None
        if self.accept_kw("limit"):
            t = self.advance()
            if t.kind != "number":
                raise ParseError(f"LIMIT expects a number at {t.pos}")
            limit = int(t.value)
        if terms:
            # a set-op chain wraps as SELECT * FROM <union-relation>
            # so ORDER BY/LIMIT and CTEs stay on the whole statement
            return ast.Select(
                items=(ast.SelectItem(ast.Star(), None),),
                from_=ast.UnionRel(
                    terms=(first,) + tuple(terms), ops=tuple(ops)
                ),
                order_by=tuple(order_by),
                limit=limit,
                ctes=tuple(ctes),
            )
        # only override clauses actually parsed HERE: a parenthesized
        # first term arrives with its own order_by/limit, which a
        # blanket replace would silently wipe
        changes = {"ctes": tuple(ctes) + first.ctes}
        if order_by:
            changes["order_by"] = tuple(order_by)
        if limit is not None:
            changes["limit"] = limit
        return dataclasses.replace(first, **changes)

    def _intersect_chain(self) -> ast.Select:
        """INTERSECT binds tighter than UNION/EXCEPT (SQL precedence):
        fold a chain of terms joined by INTERSECT into its own wrapped
        union-relation before the outer loop sees it."""
        first = self._union_term()
        terms: List[ast.Select] = []
        while self.accept_kw("intersect"):
            if self.peek_kw("all"):
                raise ParseError(
                    "INTERSECT ALL is not supported (DISTINCT "
                    "semantics only)"
                )
            self.accept_kw("distinct")
            terms.append(self._union_term())
        if not terms:
            return first
        return ast.Select(
            items=(ast.SelectItem(ast.Star(), None),),
            from_=ast.UnionRel(
                terms=(first,) + tuple(terms),
                ops=("intersect",) * len(terms),
            ),
        )

    def _union_term(self) -> ast.Select:
        """One branch of a (possible) set-operation chain: a bare
        select core, or a parenthesized full select."""
        if (
            self.peek_op("(")
            and self.tokens[self.pos + 1].kind == "kw"
            and self.tokens[self.pos + 1].value in ("select", "with")
        ):
            self.advance()
            q = self.parse_select()
            self.expect_op(")")
            return q
        return self._select_core()

    def _select_core(self) -> ast.Select:
        self.expect_kw("select")
        distinct = bool(self.accept_kw("distinct"))
        self.accept_kw("all")
        items = [self._select_item()]
        while self.accept_op(","):
            items.append(self._select_item())
        from_ = None
        if self.accept_kw("from"):
            from_ = self._relation()
        where = self.parse_expr() if self.accept_kw("where") else None
        group_by: List[ast.Node] = []
        if self.accept_kw("group"):
            self.expect_kw("by")
            group_by.append(self._group_by_element())
            while self.accept_op(","):
                group_by.append(self._group_by_element())
        having = self.parse_expr() if self.accept_kw("having") else None
        return ast.Select(
            items=tuple(items),
            from_=from_,
            where=where,
            group_by=tuple(group_by),
            having=having,
            distinct=distinct,
        )

    def _type_text(self) -> str:
        """A type name with optional (args): varchar, decimal(9,2)."""
        type_parts = [self.expect_ident()]
        if self.accept_op("("):
            inner = [self.advance().value]
            while self.accept_op(","):
                inner.append(self.advance().value)
            self.expect_op(")")
            type_parts.append("(" + ",".join(inner) + ")")
        return "".join(type_parts)

    def _group_by_element(self) -> ast.Node:
        """One GROUP BY element: a plain expression, or
        ROLLUP(...) / CUBE(...) / GROUPING SETS ((...), ...) parsed
        into ast.GroupingSets (reference: GroupingElement grammar).
        rollup/cube/grouping are soft keywords — only treated as
        grouping constructs in exactly these token shapes."""
        t = self.cur
        word = str(t.value).lower() if t.kind == "ident" else None
        nxt = self.tokens[self.pos + 1] if self.pos + 1 < len(
            self.tokens
        ) else None
        if (
            word in ("rollup", "cube")
            and nxt is not None
            and nxt.kind == "op"
            and nxt.value == "("
        ):
            self.advance()
            self.expect_op("(")
            cols = [self.parse_expr()]
            while self.accept_op(","):
                cols.append(self.parse_expr())
            self.expect_op(")")
            if word == "rollup":
                # prefixes, most detailed first: (a,b), (a), ()
                sets = tuple(
                    tuple(cols[:i]) for i in range(len(cols), -1, -1)
                )
            else:
                # cube: every subset, most detailed first
                n = len(cols)
                sets = tuple(
                    tuple(
                        c
                        for j, c in enumerate(cols)
                        if (mask >> (n - 1 - j)) & 1
                    )
                    for mask in range((1 << n) - 1, -1, -1)
                )
            return ast.GroupingSets(sets=sets)
        if (
            word == "grouping"
            and nxt is not None
            and str(nxt.value).lower() == "sets"
        ):
            self.advance()
            self.advance()
            self.expect_op("(")
            sets = [self._grouping_set()]
            while self.accept_op(","):
                sets.append(self._grouping_set())
            self.expect_op(")")
            return ast.GroupingSets(sets=tuple(sets))
        return self.parse_expr()

    def _grouping_set(self) -> tuple:
        """( col [, col]* ) | ( ) | col inside GROUPING SETS."""
        if self.accept_op("("):
            cols: List[ast.Node] = []
            if not self.accept_op(")"):
                cols.append(self.parse_expr())
                while self.accept_op(","):
                    cols.append(self.parse_expr())
                self.expect_op(")")
            return tuple(cols)
        return (self.parse_expr(),)

    def _select_item(self) -> ast.SelectItem:
        if self.peek_op("*"):
            self.advance()
            return ast.SelectItem(ast.Star(), None)
        expr = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        elif self.cur.kind == "ident":
            alias = self.advance().value
        # t.* style
        if (
            isinstance(expr, ast.Ident)
            and alias is None
            and self.peek_op(".")
        ):  # pragma: no cover - handled in primary
            pass
        return ast.SelectItem(expr, alias)

    def _sort_item(self) -> ast.SortItem:
        expr = self.parse_expr()
        descending = False
        if self.accept_kw("desc"):
            descending = True
        else:
            self.accept_kw("asc")
        nulls_first = None
        if self.accept_kw("nulls"):
            if self.accept_kw("first"):
                nulls_first = True
            else:
                self.expect_kw("last")
                nulls_first = False
        return ast.SortItem(expr, descending, nulls_first)

    # ----------------------------------------------------------- relations

    def _relation(self) -> ast.Node:
        rel = self._join_relation()
        while self.accept_op(","):
            right = self._join_relation()
            rel = ast.JoinRel(rel, right, "cross", None)
        return rel

    def _join_relation(self) -> ast.Node:
        rel = self._primary_relation()
        while True:
            if self.accept_kw("cross"):
                self.expect_kw("join")
                right = self._primary_relation()
                rel = ast.JoinRel(rel, right, "cross", None)
                continue
            jt = None
            if self.peek_kw("join"):
                jt = "inner"
            elif self.peek_kw("inner"):
                self.advance()
                jt = "inner"
            elif self.peek_kw("left"):
                self.advance()
                self.accept_kw("outer")
                jt = "left"
            elif self.peek_kw("right"):
                self.advance()
                self.accept_kw("outer")
                jt = "right"
            elif self.peek_kw("full"):
                self.advance()
                self.accept_kw("outer")
                jt = "full"
            if jt is None:
                return rel
            self.expect_kw("join")
            right = self._primary_relation()
            self.expect_kw("on")
            on = self.parse_expr()
            rel = ast.JoinRel(rel, right, jt, on)

    def _primary_relation(self) -> ast.Node:
        # UNNEST(arr) [WITH ORDINALITY] AS alias (col [, ord])
        t = self.cur
        if (
            t.kind == "ident"
            and t.value.lower() == "unnest"
            and self.tokens[self.pos + 1].kind == "op"
            and self.tokens[self.pos + 1].value == "("
        ):
            self.advance()
            self.advance()
            arr = self.parse_expr()
            self.expect_op(")")
            ordinality = False
            if self.peek_kw("with"):
                self.advance()
                w = self.expect_ident()
                if w != "ordinality":
                    raise ParseError(
                        f"expected ORDINALITY after WITH, got {w!r}"
                    )
                ordinality = True
            self.accept_kw("as")
            alias = self.expect_ident()
            self.expect_op("(")
            col = self.expect_ident()
            ordname = None
            if self.accept_op(","):
                ordname = self.expect_ident()
            self.expect_op(")")
            if ordinality and ordname is None:
                raise ParseError(
                    "WITH ORDINALITY requires two column aliases"
                )
            if not ordinality and ordname is not None:
                raise ParseError(
                    "second column alias requires WITH ORDINALITY"
                )
            return ast.UnnestRef(arr, alias, col, ordname)
        if self.accept_op("("):
            if self.peek_kw("values"):
                self.advance()
                rows: List[tuple] = []
                while True:
                    self.expect_op("(")
                    row = [self.parse_expr()]
                    while self.accept_op(","):
                        row.append(self.parse_expr())
                    self.expect_op(")")
                    rows.append(tuple(row))
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                alias = self._relation_alias()
                if alias is None:
                    raise ParseError(
                        "VALUES relation requires an alias "
                        f"at {self.cur.pos}"
                    )
                names: List[str] = []
                if self.accept_op("("):
                    names.append(self.expect_ident())
                    while self.accept_op(","):
                        names.append(self.expect_ident())
                    self.expect_op(")")
                return ast.ValuesRel(
                    rows=tuple(rows), alias=alias,
                    column_names=tuple(names),
                )
            q = self.parse_select()
            self.expect_op(")")
            alias = self._relation_alias()
            if alias is None:
                raise ParseError(
                    f"derived table requires an alias at {self.cur.pos}"
                )
            return ast.SubqueryRef(q, alias)
        parts = [self.expect_ident()]
        while self.accept_op("."):
            parts.append(self.expect_ident())
        # FOR VERSION AS OF <id> — time travel to a committed snapshot
        # (VERSION and OF are plain identifiers, FOR/AS are keywords)
        version = None
        if self.peek_kw("for"):
            self.advance()
            w = self.expect_ident()
            if w.lower() != "version":
                raise ParseError(
                    f"expected VERSION after FOR, got {w!r}"
                )
            self.expect_kw("as")
            w = self.expect_ident()
            if w.lower() != "of":
                raise ParseError(
                    f"expected OF after FOR VERSION AS, got {w!r}"
                )
            lit = self.parse_expr()
            if not isinstance(lit, ast.NumberLit) or not lit.text.isdigit():
                raise ParseError(
                    "FOR VERSION AS OF requires an integer snapshot id"
                )
            version = int(lit.text)
        alias = self._relation_alias()
        return ast.TableRef(tuple(parts), alias, version)

    def _relation_alias(self) -> Optional[str]:
        if self.accept_kw("as"):
            return self.expect_ident()
        if self.cur.kind == "ident":
            return self.advance().value
        return None

    # --------------------------------------------------------- expressions

    def parse_expr(self) -> ast.Node:
        return self._or_expr()

    def _or_expr(self) -> ast.Node:
        left = self._and_expr()
        while self.accept_kw("or"):
            left = ast.BinaryOp("or", left, self._and_expr())
        return left

    def _and_expr(self) -> ast.Node:
        left = self._not_expr()
        while self.accept_kw("and"):
            left = ast.BinaryOp("and", left, self._not_expr())
        return left

    def _not_expr(self) -> ast.Node:
        if self.accept_kw("not"):
            return ast.UnaryOp("not", self._not_expr())
        return self._predicate()

    def _predicate(self) -> ast.Node:
        left = self._concat()
        while True:
            negate = False
            save = self.pos
            if self.accept_kw("not"):
                negate = True
            if self.accept_kw("between"):
                low = self._concat()
                self.expect_kw("and")
                high = self._concat()
                left = ast.BetweenExpr(left, low, high, negate)
                continue
            if self.accept_kw("in"):
                self.expect_op("(")
                if self.peek_kw("select", "with"):
                    q = self.parse_select()
                    self.expect_op(")")
                    left = ast.InSubquery(left, q, negate)
                else:
                    values = [self.parse_expr()]
                    while self.accept_op(","):
                        values.append(self.parse_expr())
                    self.expect_op(")")
                    left = ast.InList(left, tuple(values), negate)
                continue
            if self.accept_kw("like"):
                pattern = self._concat()
                if self.accept_kw("escape"):
                    self._additive()  # escape char: accepted, default '\'
                left = ast.LikeExpr(left, pattern, negate)
                continue
            if negate:
                self.pos = save  # NOT belongs to something else
                return left
            if self.accept_kw("is"):
                neg = bool(self.accept_kw("not"))
                self.expect_kw("null")
                left = ast.IsNullExpr(left, neg)
                continue
            op = self.accept_op("=", "<>", "!=", "<", "<=", ">", ">=")
            if op:
                right = self._concat()
                left = ast.BinaryOp(op, left, right)
                continue
            return left

    def _concat(self) -> ast.Node:
        """|| at Presto's precedence: below +/- (so 'x' || a + 1 is
        'x' || (a + 1)), above comparisons; desugars to concat()."""
        left = self._additive()
        while self.accept_op("||"):
            left = ast.FuncCall("concat", (left, self._additive()))
        return left

    def _additive(self) -> ast.Node:
        left = self._multiplicative()
        while True:
            op = self.accept_op("+", "-")
            if not op:
                return left
            left = ast.BinaryOp(op, left, self._multiplicative())

    def _multiplicative(self) -> ast.Node:
        left = self._unary()
        while True:
            op = self.accept_op("*", "/", "%")
            if not op:
                return left
            left = ast.BinaryOp(op, left, self._unary())

    def _postfix(self) -> ast.Node:
        """Primary expression plus subscript chains: ``arr[i]`` is
        sugar for ``element_at(arr, i)`` (Presto's subscript operator)."""
        e = self._primary()
        while self.accept_op("["):
            idx = self.parse_expr()
            self.expect_op("]")
            e = ast.FuncCall("element_at", (e, idx))
        return e

    def _unary(self) -> ast.Node:
        if self.accept_op("-"):
            return ast.UnaryOp("-", self._unary())
        if self.accept_op("+"):
            return self._unary()
        return self._postfix()

    def _primary(self) -> ast.Node:
        t = self.cur
        if self.accept_op("?"):
            idx = self._param_idx
            self._param_idx += 1
            return ast.ParamMarker(idx)
        if t.kind == "number":
            self.advance()
            return ast.NumberLit(t.value)
        if t.kind == "string":
            self.advance()
            return ast.StringLit(t.value)
        if self.accept_kw("null"):
            return ast.NullLit()
        if self.accept_kw("true"):
            return ast.BoolLit(True)
        if self.accept_kw("false"):
            return ast.BoolLit(False)
        if self.peek_kw("date"):
            # DATE 'yyyy-mm-dd' (else treat as identifier)
            if self.tokens[self.pos + 1].kind == "string":
                self.advance()
                lit = self.advance()
                return ast.DateLit(lit.value)
        if self.accept_kw("interval"):
            neg = bool(self.accept_op("-"))
            lit = self.advance()
            if lit.kind != "string":
                raise ParseError(f"INTERVAL expects a string at {lit.pos}")
            unit_tok = self.advance()
            if unit_tok.value not in ("day", "month", "year"):
                raise ParseError(
                    f"unsupported interval unit {unit_tok.value!r}"
                )
            return ast.IntervalLit(lit.value, unit_tok.value, neg)
        if self.accept_kw("case"):
            operand = None
            if not self.peek_kw("when"):
                operand = self.parse_expr()
            whens = []
            while self.accept_kw("when"):
                cond = self.parse_expr()
                self.expect_kw("then")
                val = self.parse_expr()
                whens.append((cond, val))
            default = None
            if self.accept_kw("else"):
                default = self.parse_expr()
            self.expect_kw("end")
            return ast.CaseExpr(operand, tuple(whens), default)
        if self.accept_kw("cast"):
            self.expect_op("(")
            arg = self.parse_expr()
            self.expect_kw("as")
            tname = self._type_text()
            self.expect_op(")")
            return ast.CastExpr(arg, tname)
        if self.accept_kw("extract"):
            self.expect_op("(")
            field_tok = self.advance()
            self.expect_kw("from")
            arg = self.parse_expr()
            self.expect_op(")")
            return ast.ExtractExpr(field_tok.value, arg)
        if self.peek_kw("substring", "substr"):
            name = self.advance().value
            self.expect_op("(")
            arg = self.parse_expr()
            if not self.accept_kw("from"):
                self.expect_op(",")
            start = self.parse_expr()
            length = None
            if self.accept_kw("for") or self.accept_op(","):
                length = self.parse_expr()
            self.expect_op(")")
            args = (arg, start) + ((length,) if length is not None else ())
            return ast.FuncCall("substring", args)
        if (
            t.kind == "ident"
            and t.value.lower() == "position"
            and self.tokens[self.pos + 1].kind == "op"
            and self.tokens[self.pos + 1].value == "("
        ):
            # position(sub IN s) — standard form; the first operand
            # parses above predicate level so IN is the separator
            # (comma form accepted too)
            self.advance()
            self.advance()
            sub = self._additive()
            if not self.accept_kw("in"):
                self.expect_op(",")
            s = self.parse_expr()
            self.expect_op(")")
            return ast.FuncCall("position", (sub, s))
        if self.accept_kw("exists"):
            self.expect_op("(")
            q = self.parse_select()
            self.expect_op(")")
            return ast.Exists(q)
        if self.accept_op("("):
            if self.peek_kw("select", "with"):
                q = self.parse_select()
                self.expect_op(")")
                return ast.ScalarSubquery(q)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        # ARRAY[e1, ..., ek] constructor ("array" stays a soft keyword:
        # only the bracket form is special)
        if (
            t.kind == "ident"
            and t.value.lower() == "array"
            and self.tokens[self.pos + 1].kind == "op"
            and self.tokens[self.pos + 1].value == "["
        ):
            self.advance()
            self.advance()
            items: List[ast.Node] = []
            if not self.peek_op("]"):
                items.append(self.parse_expr())
                while self.accept_op(","):
                    items.append(self.parse_expr())
            self.expect_op("]")
            return ast.ArrayLit(tuple(items))
        # identifier / function call / qualified name
        if t.kind == "ident" or (
            t.kind == "kw" and t.value in SOFT_IDENT_KEYWORDS
        ):
            name = self.expect_ident()
            if self.accept_op("("):
                return self._func_call(name)
            parts = [name]
            while self.peek_op("."):
                if self.tokens[self.pos + 1].kind == "op" and self.tokens[
                    self.pos + 1
                ].value == "*":
                    self.advance()
                    self.advance()
                    return ast.Star(qualifier=".".join(parts))
                self.advance()
                parts.append(self.expect_ident())
            return ast.Ident(tuple(parts))
        raise ParseError(
            f"unexpected token {t.value!r} at position {t.pos}"
        )

    def _func_call(self, name: str) -> ast.Node:
        distinct = False
        args: List[ast.Node] = []
        if self.peek_op("*"):
            self.advance()
            self.expect_op(")")
        else:
            if self.accept_kw("distinct"):
                distinct = True
            if not self.peek_op(")"):
                args.append(self.parse_expr())
                while self.accept_op(","):
                    args.append(self.parse_expr())
            self.expect_op(")")
        win = None
        if self.accept_kw("over"):
            self.expect_op("(")
            pby: List[ast.Node] = []
            oby: List[ast.SortItem] = []
            if self.accept_kw("partition"):
                self.expect_kw("by")
                pby.append(self.parse_expr())
                while self.accept_op(","):
                    pby.append(self.parse_expr())
            if self.accept_kw("order"):
                self.expect_kw("by")
                oby.append(self._sort_item())
                while self.accept_op(","):
                    oby.append(self._sort_item())
            frame = None
            fkw = self.accept_kw("rows", "range")
            if fkw:
                # only the UNBOUNDED PRECEDING .. CURRENT ROW frame is
                # supported (running aggregates); reference frames
                # beyond it raise here
                self.expect_kw("between")
                if not (
                    self.accept_kw("unbounded")
                    or self.cur.value == "unbounded"
                ):
                    raise ParseError(
                        "only ROWS/RANGE BETWEEN UNBOUNDED PRECEDING "
                        "AND CURRENT ROW frames are supported"
                    )
                if self.cur.value == "unbounded":
                    self.advance()
                if str(self.advance().value).lower() != "preceding":
                    raise ParseError("expected PRECEDING in frame")
                self.expect_kw("and")
                cur = str(self.advance().value).lower()
                row = str(self.advance().value).lower()
                if (cur, row) != ("current", "row"):
                    raise ParseError(
                        "only ... AND CURRENT ROW frames are supported"
                    )
                frame = fkw
            self.expect_op(")")
            win = ast.Over(tuple(pby), tuple(oby), frame)
        return ast.FuncCall(name, tuple(args), distinct, win)

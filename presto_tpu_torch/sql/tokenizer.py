"""SQL tokenizer (reference: the lexer half of presto-parser's grammar)."""

from __future__ import annotations

import dataclasses
import re
from typing import List


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str  # kw | ident | number | string | op | eof
    value: str
    pos: int


KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "in", "exists", "between", "like", "is",
    "null", "true", "false", "case", "when", "then", "else", "end",
    "cast", "extract", "date", "interval", "year", "month", "day",
    "join", "inner", "left", "right", "full", "outer", "cross", "on",
    "asc", "desc", "nulls", "first", "last", "distinct", "all", "union",
    "intersect", "except",
    "with", "over", "partition", "rows", "range", "set", "session",
    "explain", "analyze", "show", "tables", "schemas", "substring",
    "substr", "for", "any", "some", "escape", "values",
    "insert", "into", "create", "table",
    "delete", "describe", "columns", "prepare", "execute",
    "deallocate", "using", "drop", "if", "update",
    "materialized", "view", "refresh",
}

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|--[^\n]*\n?|/\*.*?\*/)
  | (?P<number>\d+\.\d*(e[+-]?\d+)?|\.\d+(e[+-]?\d+)?|\d+(e[+-]?\d+)?)
  | (?P<ident>[a-zA-Z_][a-zA-Z0-9_]*|"[^"]*")
  | (?P<string>'(?:[^']|'')*')
  | (?P<op><>|!=|<=|>=|\|\||[-+*/%(),.;<>=\[\]?])
    """,
    re.VERBOSE | re.IGNORECASE | re.DOTALL,
)


class TokenError(ValueError):
    pass


def tokenize(sql: str) -> List[Token]:
    tokens: List[Token] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if m is None:
            raise TokenError(
                f"unexpected character {sql[pos]!r} at position {pos}"
            )
        if m.lastgroup != "ws":
            text = m.group()
            if m.lastgroup == "ident":
                if text.startswith('"'):
                    tokens.append(Token("ident", text[1:-1], pos))
                elif text.lower() in KEYWORDS:
                    tokens.append(Token("kw", text.lower(), pos))
                else:
                    tokens.append(Token("ident", text.lower(), pos))
            elif m.lastgroup == "string":
                tokens.append(
                    Token("string", text[1:-1].replace("''", "'"), pos)
                )
            elif m.lastgroup == "number":
                tokens.append(Token("number", text.lower(), pos))
            else:
                tokens.append(Token("op", text, pos))
        pos = m.end()
    tokens.append(Token("eof", "", len(sql)))
    return tokens

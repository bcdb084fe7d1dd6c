"""SQL frontend: tokenizer, parser, AST.

Reference parity: ``presto-parser`` (ANTLR ``SqlBase.g4`` -> ``SqlParser``
/ ``AstBuilder`` / Statement+Expression AST) — SURVEY.md §2.1 "SQL
parser". Rebuilt as a hand-written recursive-descent parser (no parser
generator in the image; also keeps error messages direct). Covers the
analytic subset the benchmarks demand (SURVEY.md §6): full
SELECT-FROM-WHERE-GROUP-HAVING-ORDER-LIMIT, explicit and implicit joins,
derived tables, IN/EXISTS/scalar subqueries (correlated and not), CASE,
CAST, EXTRACT, BETWEEN, LIKE, IN, date/interval literals, window
functions, WITH (CTEs), and the session/utility statements (SET SESSION,
EXPLAIN, SHOW).
"""

from presto_tpu_torch.sql.parser import parse_statement  # noqa: F401

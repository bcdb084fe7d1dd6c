"""The comparison that decides ``correct``: every answer of the window
against the plain reference's answer for its parameter set.

Numbers compared, each with its limit (PERF.md gives the readings they
were set from):

- ``wrong_answers``: answers whose rows, keys, NULLs or order differ
  from the reference's (ties under the ORDER BY in any order, and under
  a LIMIT any tied row in place of the last ones). Exact: limit 0.
- ``exact_gap``: the widest gap of an exact value (a count, a key, a
  date, a DECIMAL in units of its last digit). Exact: limit 0.
- ``float_rel_gap``: the widest relative gap of a DOUBLE (AVG).
- ``failed``: queries that raised. Limit 0.
- ``unchecked``: queries of the window without a compared answer.
  Limit 0.
"""

from __future__ import annotations

import datetime
import decimal
from typing import Dict, Iterable, List, Tuple

from benchmark.reference.common import Answer

LIMITS = {
    "wrong_answers": 0,
    "exact_gap": 0,
    "float_rel_gap": 1e-10,
    "failed": 0,
    "unchecked": 0,
}

_EPOCH = datetime.date(1970, 1, 1)
_CTX = decimal.Context(prec=80)


def _norm(v):
    if isinstance(v, datetime.date):
        return (v - _EPOCH).days
    return v


def _gap(got, want) -> Tuple[str, float]:
    """(kind, gap) of one value against the reference's: kind is
    "exact", "float" or "wrong" (a NULL, a type or a string differs)."""
    if want is None or got is None:
        return ("exact", 0.0) if want is got else ("wrong", 1.0)
    if isinstance(want, str) or isinstance(got, str):
        return ("exact", 0.0) if want == got else ("wrong", 1.0)
    if isinstance(want, float):
        rel = abs(float(got) - want) / max(abs(want), 1e-300)
        return "float", (0.0 if got == want else rel)
    if isinstance(want, decimal.Decimal):
        diff = _CTX.subtract(decimal.Decimal(got), want).copy_abs()
        return "exact", float(_CTX.scaleb(diff, -want.as_tuple().exponent))
    return "exact", float(abs(got - want))


def compare_one(want: Answer, got_rows: Iterable[tuple]) -> Dict[str, float]:
    got = [tuple(_norm(v) for v in row) for row in got_rows]
    out = {"wrong": 0, "exact_gap": 0.0, "float_rel_gap": 0.0}

    def key(row):
        return tuple(row[i] for i in want.key_cols)

    allowed = {}
    for row in list(want.rows) + list(want.ties):
        allowed.setdefault(key(row), row)
    if len(got) != len(want.rows) or len({key(r) for r in got}) != len(got):
        out["wrong"] = 1
        return out
    matched: List[tuple] = []
    for row in got:
        ref = allowed.get(key(row))
        if ref is None or len(ref) != len(row):
            out["wrong"] = 1
            return out
        matched.append(ref)
        for g, w in zip(row, ref):
            kind, gap = _gap(g, w)
            if kind == "wrong":
                out["wrong"] = 1
            elif kind == "float":
                out["float_rel_gap"] = max(out["float_rel_gap"], gap)
            else:
                out["exact_gap"] = max(out["exact_gap"], gap)
    def sort_values(rows):
        return [tuple(r[i] for i in want.sort_cols) for r in rows]

    if want.sort_cols and sort_values(matched) != sort_values(want.rows):
        out["wrong"] = 1
    return out


def readings(pairs: Iterable[Tuple[Answer, list]], attempted: int,
             failed: int) -> Dict[str, float]:
    """The numbers compared over a run's (reference answer, rows)
    pairs."""
    r = {"wrong_answers": 0, "exact_gap": 0.0, "float_rel_gap": 0.0,
         "failed": failed}
    n = 0
    for want, got in pairs:
        one = compare_one(want, got)
        n += 1
        r["wrong_answers"] += one["wrong"]
        r["exact_gap"] = max(r["exact_gap"], one["exact_gap"])
        r["float_rel_gap"] = max(r["float_rel_gap"], one["float_rel_gap"])
    r["unchecked"] = attempted - n
    return r


def checks(r: Dict[str, float]) -> Dict[str, dict]:
    return {k: {"value": r[k], "limit": LIMITS[k]} for k in LIMITS}


def passed(r: Dict[str, float]) -> bool:
    return all(r[k] <= LIMITS[k] for k in LIMITS)

"""What the references share: the answer they return, lookups by key,
and arithmetic in the reference's precision."""

from __future__ import annotations

import dataclasses
import datetime
import decimal
from typing import List, Optional, Tuple

import torch

_EPOCH = datetime.date(1970, 1, 1)


@dataclasses.dataclass
class Answer:
    """A query's expected rows in order. ``key_cols`` identify a row,
    ``sort_cols`` are what its ORDER BY sorts by: rows with equal sort
    values may come in any order. Under a LIMIT, ``ties`` holds the rows
    left out that tie with the last row kept: any of them may stand in
    its place. ``groupby_rows`` counts the rows that reach the query's
    GROUP BY (the bytes of the K1 bound)."""

    rows: List[tuple]
    key_cols: Tuple[int, ...] = ()
    sort_cols: Tuple[int, ...] = ()
    ties: List[tuple] = dataclasses.field(default_factory=list)
    groupby_rows: Optional[int] = None


def days(iso: str) -> int:
    return (datetime.date.fromisoformat(iso) - _EPOCH).days


def plus_years(iso: str, years: int) -> int:
    d = datetime.date.fromisoformat(iso)
    return days(d.replace(year=d.year + years).isoformat())


def dec(units, scale: int):
    """Exact decimal of an integer count of units (None stays None)."""
    if units is None:
        return None
    return decimal.Decimal(int(units)).scaleb(-scale)


def num(x: torch.Tensor, precision: str) -> torch.Tensor:
    """An integer column in the reference's precision."""
    if precision == "exact":
        return x.to(torch.int64)
    if precision == "float32":
        return x.to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def total(x: torch.Tensor) -> int:
    """Sum of ``x`` (from ``num``) as an integer count of units."""
    s = x.sum()
    return int(s) if not s.is_floating_point() else int(round(float(s)))


def mean(x: torch.Tensor, count: int, scale: int) -> float:
    """AVG of ``x`` (units of 10**-scale) as a double: the exact
    quotient rounded once, or worked out in float32."""
    if x.is_floating_point():
        return float(x.sum() / torch.tensor(float(count) * 10 ** scale,
                                            dtype=x.dtype, device=x.device))
    return int(x.sum()) / (count * 10 ** scale)


def sums_by(index: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    """Per-index sums of ``x`` over [0, n)."""
    out = torch.zeros(n, dtype=x.dtype, device=x.device)
    return out.index_add_(0, index, x)


def lookup(keys: torch.Tensor, values: torch.Tensor, fill) -> torch.Tensor:
    """A dense array over [0, max key] holding ``values`` at ``keys``."""
    out = torch.full((int(keys.max()) + 1,), fill, dtype=values.dtype,
                     device=keys.device)
    out[keys.long()] = values
    return out


def value_id(col, value: str) -> int:
    """The dictionary id of ``value`` in a varchar column (-1 if none)."""
    try:
        return col.values.index(value)
    except ValueError:
        return -1

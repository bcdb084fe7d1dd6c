"""Window calls.

Only the ``WindowCall`` dataclass the planner imports is ported so far;
the window operator comes in a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from presto_tpu_torch import types as T
from presto_tpu_torch.expr import Expr


@dataclasses.dataclass(frozen=True)
class WindowCall:
    """func in {row_number, rank, dense_rank, ntile, lag, lead,
    first_value, last_value, sum, count, avg, min, max}.

    ``offset`` is lag/lead's constant distance (ntile reuses it as the
    bucket count); ``default`` is lag/lead's constant fill for
    out-of-partition positions as a Literal/Cast Expr (None = SQL
    NULL)."""

    func: str
    arg: Optional[Expr]  # None for row_number/rank/dense_rank/count(*)
    out_name: str
    offset: int = 1
    default: Optional[Expr] = None
    #: aggregate frame: "range" = default RANGE UNBOUNDED..CURRENT ROW
    #: (peers share the last peer row's value); "rows" = ROWS
    #: UNBOUNDED..CURRENT ROW (each row sees its own prefix)
    frame: str = "range"

    def result_type(self) -> T.DataType:
        if self.func in ("row_number", "rank", "dense_rank", "count",
                         "ntile"):
            return T.BIGINT
        if self.func in ("percent_rank", "cume_dist"):
            return T.DOUBLE
        t = self.arg.dtype
        if self.func in ("lag", "lead", "first_value", "last_value",
                         "nth_value"):
            return t
        if self.func == "sum":
            if t.is_decimal:
                return T.decimal(18, t.scale)
            if t.is_integer:
                return T.BIGINT
            return T.DOUBLE
        if self.func == "avg":
            return T.DOUBLE
        if self.func in ("min", "max"):
            return t
        raise NotImplementedError(f"window function {self.func}")

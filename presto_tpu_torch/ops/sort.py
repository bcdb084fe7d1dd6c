"""Sort keys.

Only the ``SortKey`` dataclass the planner imports is ported so far;
``order_by`` / ``limit`` / ``distinct`` on the device come in a later
slice (the root ORDER BY of a query runs host-side, exec/host_ops.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from presto_tpu_torch.expr import Expr


@dataclasses.dataclass(frozen=True)
class SortKey:
    expr: Expr
    descending: bool = False
    nulls_first: Optional[bool] = None  # SQL default: last in ASC, first in DESC

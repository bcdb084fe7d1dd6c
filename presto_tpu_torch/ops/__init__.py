"""Device-side operators over torch Pages (plain functions on tensors)."""

from presto_tpu_torch.ops.filter_project import (  # noqa: F401
    filter_project,
    project,
)
from presto_tpu_torch.ops.aggregation import AggCall, hash_aggregate  # noqa: F401
from presto_tpu_torch.ops.sort import SortKey  # noqa: F401
from presto_tpu_torch.ops.window import WindowCall  # noqa: F401

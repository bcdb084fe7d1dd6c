"""Device-side operators over torch Pages (plain functions on tensors)."""

from presto_tpu_torch.ops.filter_project import (  # noqa: F401
    filter_project,
    project,
    union_all,
)
from presto_tpu_torch.ops.aggregation import AggCall, hash_aggregate  # noqa: F401
from presto_tpu_torch.ops.join import hash_join, pack_keys  # noqa: F401
from presto_tpu_torch.ops.sort import SortKey, distinct, limit, order_by  # noqa: F401
from presto_tpu_torch.ops.window import WindowCall, window  # noqa: F401

"""Split and multi-device execution: the fragment cut and the
partial/final aggregation split (``fragmenter``, ``agg_split``), the
collectives over per-shard page lists and the in-slice lane's device half
(``exchange``), and the runner that drives sharded fragments over a list
of devices (``distributed_runner``).

``DistributedQueryRunner`` and ``dryrun_multichip`` load on first use:
the runner imports ``exec/local_runner.py``, which imports streaming,
which imports the fragmenter from this package."""

from presto_tpu_torch.parallel.exchange import (  # noqa: F401
    partition_exchange,
    partition_hash,
    replicate,
)
from presto_tpu_torch.parallel.fragmenter import (  # noqa: F401
    insert_gathers,
    is_distributable,
)

_LAZY = ("DistributedQueryRunner", "dryrun_multichip")


def __getattr__(name):
    if name in _LAZY:
        from presto_tpu_torch.parallel import distributed_runner

        return getattr(distributed_runner, name)
    raise AttributeError(name)

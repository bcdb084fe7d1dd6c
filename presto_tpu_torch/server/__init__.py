"""Multi-host runtime: coordinator / worker processes over HTTP.

The PyTorch counterpart of ``presto_tpu/server/``, on its default path:
a ``CoordinatorServer`` and N ``WorkerServer``s, in one process or
several, on one card, answering SQL over the paged HTTP protocol through
``PrestoTpuClient`` (reference: the coordinator<->worker split of
SURVEY.md §1 and the §2.5 REST control plane + pull-based, token-acked
paged data plane). Each node's ``LocalQueryRunner`` runs on one CUDA
device (``device=None``; tests pass ``device="cpu"``).

Ported: the wire protocol (``protocol``), the RPC policy and circuit
breaker (``rpc``), the page wire format (``pages_wire``, byte-equal to
the reference's frames), the stage cut and placement (``scheduler``),
the exchange SPI's HTTP lane (``exchange_spi``), the worker task runtime
(``worker``), the coordinator's dispatcher with the fragment schedulers,
the ordered MERGE exchange, the partitioned join, the shuffled
aggregation, distributed dynamic filtering and the adaptive switch
(``coordinator``), the memory arbiter, resource groups, the client, the
pool SPI and the ``etc/`` launcher
(``python -m presto_tpu_torch.server.launcher --etc-dir DIR``), and the
split-streaming helpers streaming shares (``task_ids``, the payload
merge, the stage cut). The serving plane: the coordinator's micro-batch
queue (``serving.microbatch-wait-ms``, ``serving.microbatch-max``), the
snapshot-keyed result cache with the MV rewrite (``result_cache``,
``result-cache.*``) and the WAL'd ingest lane behind
``POST /v1/ingest/{table}`` (``ingest``, ``ingest.wal-path``).
Fault-tolerant execution: retry TASK/QUERY over the durable exchange
spool (``spool``, ``retry-policy``, ``exchange.spool-path``), the
coordinator's admission journal with restart recovery (``journal``,
``coordinator.journal-path``) and the lease plane with peer failover
(``lease``, ``coordinator.peers``). The QoS plane: priority admission
lanes with preempt-and-resume and per-group SLOs (``qos``,
``qos.enabled``), and the elastic pool with preemptible workers
(``pool``'s autoscaler, the launcher's ``LocalWorkerPoolProvider``,
``pool.max-workers``, ``node.preemptible``). The in-slice (ICI) lanes
of the exchange SPI (``exchange_spi``, ``exchange.ici-enabled``,
``exchange.slice-id``, ``exchange.single-program``): co-located workers
exchange partitioned output as device pages, and the root gather rides
the lane when the coordinator shares the slice.

The durable lakehouse tee (``manifests``, ``lakehouse.*``): ingest
commits publish manifest snapshots over immutable parquet files, with
time travel, compaction and the orphan GC.
"""

from presto_tpu_torch.server.client import PrestoTpuClient  # noqa: F401
from presto_tpu_torch.server.coordinator import CoordinatorServer  # noqa: F401
from presto_tpu_torch.server.worker import WorkerServer  # noqa: F401

"""Execution layer: staging, host root stage, local runner."""

from presto_tpu_torch.exec.staging import bucket_capacity, stage_page  # noqa: F401

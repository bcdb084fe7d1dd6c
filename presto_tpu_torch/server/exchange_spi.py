"""The exchange SPI's HTTP lane: the producer side of the paged shuffle.

The PyTorch counterpart of the HTTP half of
``presto_tpu/server/exchange_spi.py`` (reference: the
``PartitionedOutputOperator`` / ``OutputBuffer`` producer side of the
exchange, SURVEY.md §2.5). A producer task's partitioned output is
brought to the host (the runner's result page already is), hashed by
its partition keys on the host with ``exec/streaming.py::_bucket_of``
(bit-equal to the reference's, so both packages place a row in the same
partition), sliced per partition, serialized (``pages_wire``) and
offered to the task's per-partition output buffers, byte-counted in
``exchange.http_shuffle_bytes``. Consumers pull the buffers token by
token over HTTP (``rpc.pull_pages``).

The reference's in-slice lane (the device-resident ``IciSegment``, the
collective programs, ``ici_fetch``/``ici_gather``) comes with the
multi-device exchange slice. Until then the port's coordinator and
workers refuse ``exchange.ici-enabled`` and the scheduler's transport
choice is always the HTTP wire.
"""

from __future__ import annotations

import os

import numpy as np

from presto_tpu_torch.utils.metrics import REGISTRY


def default_slice_id(device=None) -> str:
    """Slice identity announced on discovery: one host process driving
    one device (device type + pid), as the reference's. The scheduler
    reads it only behind the ICI gate, which the port refuses."""
    kind = getattr(device, "type", None) or "cuda"
    return f"{kind}-{os.getpid()}"


def device_coords(device=None) -> list:
    """Device coordinates announced beside the slice id (topology
    observability only)."""
    index = getattr(device, "index", None)
    return [int(index)] if index is not None else []


def _wire_row_bytes(page) -> int:
    """Approximate serialized bytes per row (raw typed buffers + packed
    validity): what the HTTP wire moves per row of ``page``."""
    total = 0
    for blk in page.blocks:
        width = blk.data.element_size()
        if blk.data.dim() == 2:
            width *= blk.data.shape[1]
        total += width
        if blk.valid is not None:
            total += 1
    return total


def _serialize_partition_slices(payload, schema, nrows, buckets):
    """Host-side partition slicing + serialization: yields
    ``(partition, frame, n)`` per non-empty partition, in partition
    order (np.unique), rows in producer order — the wire contract the
    reference's transports and spool agree on."""
    from presto_tpu_torch.exec import streaming as S
    from presto_tpu_torch.server import pages_wire

    for b in np.unique(buckets):
        mask = buckets == b
        sliced = S._slice_payload(payload, schema, mask)
        n = int(mask.sum())
        cols = pages_wire.payload_to_wire_columns(sliced, schema, n)
        yield int(b), pages_wire.serialize_page(cols, n), n


def emit_partitioned(task, out) -> None:
    """The partitioned-output emit (reference:
    PartitionedOutputOperator): hash the batch's rows by the spec's
    partition keys, serialize each partition's slice and offer it to
    that partition's output buffer."""
    from presto_tpu_torch.exec import streaming as S

    spec = task.spec
    payload, schema, nrows = S._page_to_payload(out)
    if nrows == 0:
        return
    buckets = S._bucket_of(
        payload, list(spec.partition_keys), nrows, spec.n_partitions
    )
    for part, frame, n in _serialize_partition_slices(
        payload, schema, nrows, buckets
    ):
        task.offer_page(frame, part=part)
        REGISTRY.counter("exchange.http_shuffle_bytes").update(len(frame))
        with task.cond:
            task.stats.output_rows += n


def buffer_frames(task, frames, pool) -> int:
    """Commit already-serialized ``[(partition, frame), ...]`` to the
    task's per-partition buffers at once: one pool reservation for the
    whole set and one locked append, so pullers observe the buffers
    either without these frames or with all of them (never a torn
    prefix that could flip X-Complete early). Returns the frame
    count."""
    total = sum(len(f) for _, f in frames)
    if pool is not None and total:
        pool.reserve(task.buf_key, total)
    with task.cond:
        for part, frame in frames:
            task.parts[part].append(frame)
        task.cond.notify_all()
    for _, frame in frames:
        REGISTRY.counter("exchange.http_shuffle_bytes").update(len(frame))
    return len(frames)

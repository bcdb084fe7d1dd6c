"""Unified exchange SPI: one producer/consumer surface over the shuffle
transports.

The PyTorch counterpart of ``presto_tpu/server/exchange_spi.py``
(reference: the exchange layer, ``PartitionedOutputOperator`` /
``OutputBuffer`` on the producer side and ``ExchangeClient`` on the
consumer side, SURVEY.md §2.5). Three transports behind one
emit/fetch surface:

- **ICI** (in-slice): co-located workers, one process driving the
  card(s), exchange partitioned output as device-resident pages through
  the :class:`IciSegment`. The producer computes each row's destination
  on the device (``parallel.exchange.bucket_dest``, bit-equal to the
  host's ``_bucket_of``) and the consumer gathers its partition straight
  out of the producers' device pages (``parallel.exchange.ici_append``,
  or the single-program ``collective_gather`` over every batch of the
  stage): no host copy, no serialization, no HTTP. The bytes the wire
  would have moved are counted in ``exchange.ici_bytes_elided``.
- **HTTP** (cross-slice): the serialized page wire (``pages_wire`` and
  token-acked pulls), byte-counted in ``exchange.http_shuffle_bytes``.
- **Spool** (recovery): the durable ``ExchangeSpool`` tee under
  ``retry_policy=TASK``; ICI producers still tee serialized frames, so a
  dead in-slice peer's partitions recover as HTTP ones do.

Transport selection is not made here: the scheduler owns it per stage
and the chosen slice rides ``FragmentSpec.ici_slice`` (empty = HTTP).
This module enforces the contract: a worker whose slice differs from the
spec's, a fan-out above ``MAX_ICI_PARTS`` or a nested page falls back to
the HTTP lane and counts ``exchange.ici_fallbacks``; a consumer that
finds no sealed entry pulls HTTP, then the spool. ICI is an
optimization, never a correctness dependency.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from presto_tpu_torch.parallel import exchange as X
from presto_tpu_torch.utils.metrics import REGISTRY
from presto_tpu_torch.utils.telemetry import DEVICE

#: approximate serialized bytes per row (raw typed buffers + packed
#: validity): what the HTTP wire moves per row of a page, and what
#: ``exchange.ici_bytes_elided`` counts per row the ICI lane kept
_wire_row_bytes = X.page_row_bytes

log = logging.getLogger("presto_tpu_torch.exchange")


def _fetch_dest(dest: torch.Tensor, nr: int) -> np.ndarray:
    """The one destination-vector fetch of the ICI lane (a small
    device-to-host control copy per batch), counted on the device-plane
    telemetry."""
    arr = dest[:nr].cpu().numpy()
    DEVICE.count_d2h(int(arr.nbytes))
    return arr.astype(np.int64)


def _count_dispatch(n: int = 1, fold=None) -> None:
    """Device passes of the exchange lane, on the fragment runner's
    choke-point counters; ``fold`` is the runner's per-query stat folder
    (``_fold_device_stat``) when the caller has one."""
    DEVICE.count_dispatch(n)
    if fold is not None:
        fold(device_dispatches=n)


def default_slice_id(device=None) -> str:
    """Slice identity announced on discovery: co-location means one host
    process driving its devices (the in-slice segment is process-local),
    so the identity is the device type and the pid. ``exchange.slice-id``
    overrides it; a wrong override is safe (a cross-process fetch misses
    the segment and pulls HTTP)."""
    kind = getattr(device, "type", None) or "cuda"
    return f"{kind}-{os.getpid()}"


def device_coords(device=None) -> list:
    """Device coordinates announced beside the slice id (topology
    observability only)."""
    index = getattr(device, "index", None)
    return [int(index)] if index is not None else []


# ------------------------------------------------------------ segment


class IciSegment:
    """Process-global registry of device-resident partitioned output.

    One entry per producer task attempt: its output pages and their
    per-row destinations, sealed when the task FINISHES (the spool's
    commit-before-terminal-state ordering: a consumer that observes
    FINISHED can trust sealed-or-never). Entries die with the task:
    DELETE and abort discard them, a drain materializes them to the HTTP
    buffers first."""

    def __init__(self):
        self._cond = threading.Condition()
        self._entries: Dict[str, dict] = {}

    @staticmethod
    def _entry(slice_id: str, nparts: int, sealed: bool) -> dict:
        return {
            "slice": slice_id,
            "nparts": nparts,
            "batches": [],
            "bytes": 0,
            "sealed": sealed,
            "consumed": set(),
            "on_consumed": None,
        }

    def publish(
        self, slice_id: str, task_id: str, nparts: int, page, dest,
        nbytes: int, on_consumed=None,
    ) -> None:
        with self._cond:
            e = self._entries.get(task_id)
            if e is None:
                e = self._entries[task_id] = self._entry(
                    slice_id, nparts, False
                )
            e["batches"].append((page, dest))
            e["bytes"] += nbytes
            if on_consumed is not None:
                e["on_consumed"] = on_consumed
            self._cond.notify_all()

    def seal(self, slice_id: str, task_id: str, nparts: int) -> None:
        """Producer finished cleanly: the entry may serve consumers. A
        producer with no output never published; sealing makes an empty
        sealed entry, so its consumers learn 'complete, zero rows' in
        the slice instead of paying an HTTP round trip."""
        with self._cond:
            e = self._entries.get(task_id)
            if e is None:
                e = self._entries[task_id] = self._entry(
                    slice_id, nparts, True
                )
            e["sealed"] = True
            self._cond.notify_all()

    def discard(self, task_id: str) -> int:
        """Drop an entry; returns its accounted bytes, which the caller
        releases from its pool reservation."""
        with self._cond:
            e = self._entries.pop(task_id, None)
            self._cond.notify_all()
            return e["bytes"] if e is not None else 0

    def peek(self, slice_id: str, task_id: str) -> str:
        """'sealed' | 'open' | 'absent' | 'foreign' (published under
        another slice: a misconfigured override, never served)."""
        with self._cond:
            e = self._entries.get(task_id)
            if e is None:
                return "absent"
            if e["slice"] != slice_id:
                return "foreign"
            return "sealed" if e["sealed"] else "open"

    def take(self, slice_id: str, task_id: str, part: int):
        """Consume one partition of a sealed entry: its ``[(page,
        dest), ...]`` batches (shared, immutable) and the producer's
        partition count, or None. Marks the partition consumed, so a
        draining producer knows an in-slice consumer has these rows."""
        with self._cond:
            e = self._entries.get(task_id)
            if e is None or not e["sealed"] or e["slice"] != slice_id:
                return None
            e["consumed"].add(int(part))
            cb = e["on_consumed"]
            batches = list(e["batches"]), e["nparts"]
        if cb is not None:
            try:
                cb(int(part))
            except Exception:  # consumed-tracking must never fail a read
                log.warning("ici consumed callback failed", exc_info=True)
        return batches

    def snapshot(self, task_id: str) -> Optional[dict]:
        """Entry view for the drain-materialize path."""
        with self._cond:
            e = self._entries.get(task_id)
            if e is None:
                return None
            return {
                "batches": list(e["batches"]),
                "nparts": e["nparts"],
                "consumed": set(e["consumed"]),
                "bytes": e["bytes"],
            }

    def wait(self, timeout: float) -> None:
        with self._cond:
            self._cond.wait(timeout)

    def stats(self) -> dict:
        with self._cond:
            return {
                "entries": len(self._entries),
                "bytes": sum(e["bytes"] for e in self._entries.values()),
                "hits": int(REGISTRY.counter("exchange.ici_edges").total),
                "misses": int(
                    REGISTRY.counter("exchange.ici_fallbacks").total
                ),
                "bytes_elided": int(
                    REGISTRY.counter("exchange.ici_bytes_elided").total
                ),
            }


#: the one in-slice exchange segment of this process (= this slice)
SEGMENT = IciSegment()


# ----------------------------------------------------- producer side


def _page_eligible(page) -> bool:
    """ICI-transportable page: fixed-width scalar blocks only (array,
    map and row blocks keep the serialized wire, which handles offsets
    and child blocks)."""
    return all(
        blk.offsets is None and not blk.children for blk in page.blocks
    )


def _serialize_partition_slices(payload, schema, nrows, buckets):
    """Host-side partition slicing + serialization shared by the HTTP
    emit, the ICI spool tee and drain materialization: yields
    ``(partition, frame, n)`` per non-empty partition, in partition
    order (np.unique), rows in producer order — the wire contract both
    transports and the spool agree on."""
    from presto_tpu_torch.exec import streaming as S
    from presto_tpu_torch.server import pages_wire

    for b in np.unique(buckets):
        mask = buckets == b
        sliced = S._slice_payload(payload, schema, mask)
        n = int(mask.sum())
        cols = pages_wire.payload_to_wire_columns(sliced, schema, n)
        yield int(b), pages_wire.serialize_page(cols, n), n


def _crc_tables(out, keys) -> Dict[str, torch.Tensor]:
    """Device crc tables of the dictionary key columns."""
    return {
        c: X.wire_crc_table(out.block(c).dictionary, out.device)
        for c in keys
        if out.block(c).dictionary is not None
    }


def _owned(page):
    """The page with tensors that hold just their own rows: a result cut
    from a larger buffer (``pad_capacity`` slices the runner's output to
    its live rows' bucket) would keep the whole buffer alive in the
    segment until the stage is consumed."""
    def own(t):
        if t is None or t.untyped_storage().nbytes() == t.nbytes:
            return t
        return t.clone()

    return dataclasses.replace(
        page,
        blocks=tuple(
            dataclasses.replace(b, data=own(b.data), valid=own(b.valid))
            for b in page.blocks
        ),
    )


def _publish(task, out, dest, nparts: int, slice_id: str, pool) -> None:
    """Enter one device page into the segment under the task's buffer
    reservation (undone when a DELETE raced the publish), and count the
    wire-equivalent bytes the lane elided."""
    from presto_tpu_torch.exec.staging import page_nbytes

    spec = task.spec
    nbytes = page_nbytes(out) + int(dest.nbytes)
    if pool is not None:
        # same accounting as the HTTP shuffle buffers: stage-lifetime
        # pages reserved under the task's buffer key, freed at DELETE
        # (or at drain materialization)
        pool.reserve(task.buf_key, nbytes)

    def consumed(part: int) -> None:
        with task.cond:
            if part < len(task.complete_served):
                task.complete_served[part] = True

    SEGMENT.publish(
        slice_id, spec.task_id, nparts, out, dest, nbytes,
        on_consumed=consumed,
    )
    with task.cond:
        aborted = task.state == "ABORTED"
    if aborted:
        # a DELETE raced this batch: its discard ran before our publish,
        # so the re-published entry and its reservation would outlive
        # the task (any DELETE after this check discards it itself)
        freed = SEGMENT.discard(spec.task_id)
        if pool is not None and freed:
            pool.release(task.buf_key, freed)
        raise RuntimeError("task aborted")
    n = int(out.num_valid)
    wire_bytes = n * _wire_row_bytes(out)
    REGISTRY.counter("exchange.ici_bytes_elided").update(wire_bytes)
    with task.cond:
        task.stats.output_rows += n
        # wire-equivalent bytes, comparable to the HTTP lane's
        task.stats.output_bytes += wire_bytes


def emit_partitioned(task, out, *, slice_id: str, pool, fold=None) -> None:
    """The partitioned-output emit (reference: PartitionedOutputOperator):
    routes this batch onto the transport the scheduler chose.

    ICI lane (``spec.ici_slice`` == this worker's slice): the page stays
    device-resident, ``bucket_dest`` assigns every row its partition on
    the device, and the (page, destinations) pair enters the segment.
    The spool tee still serializes under ``retry_policy=TASK``
    (durability needs bytes on disk), on the drain thread when there is
    one.

    HTTP lane (everything else): hash on the host, serialize each
    partition's slice and offer it to that partition's buffer."""
    from presto_tpu_torch.exec import streaming as S

    spec = task.spec
    ici_wanted = bool(spec.ici_slice)
    if ici_wanted and _ici_emit_ok(spec, out, slice_id):
        if int(out.num_valid) == 0:
            return
        out = _owned(out)
        keys = tuple(spec.partition_keys)
        dest = X.bucket_dest(
            out, _crc_tables(out, keys), spec.n_partitions, keys
        )
        _count_dispatch(1, fold)
        _publish(task, out, dest, spec.n_partitions, slice_id, pool)
        if task._spool is not None:
            # durable tee, sliced by the SAME device-computed
            # destinations (the device and host hashes are pinned equal,
            # but recovery must match what live consumers gathered)
            spool = task._spool
            tid = spec.task_id

            def tee(page=out, dvec=dest):
                payload, schema, nr = S._page_to_payload(page)
                bk = _fetch_dest(dvec, nr)
                for part, frame, _ in _serialize_partition_slices(
                    payload, schema, nr, bk
                ):
                    spool.append(tid, part, frame)

            drain = getattr(task, "_spool_drain", None)
            if drain is not None:
                drain.submit(tid, tee)
            else:
                tee()
        return

    if ici_wanted:
        # planned ICI, but this attempt cannot honor it (a retry landed
        # cross-slice, or the page is nested): the HTTP lane is always
        # correct
        REGISTRY.counter("exchange.ici_fallbacks").update()

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


def _ici_emit_ok(spec, out, slice_id: str) -> bool:

    return (
        slice_id != ""
        and spec.ici_slice == slice_id
        and 1 < spec.n_partitions <= X.MAX_ICI_PARTS
        and _page_eligible(out)
        and all(k in out.names for k in spec.partition_keys)
    )


def emit_gather(task, out, *, slice_id: str, pool) -> bool:
    """Single-partition (gather) output onto the ICI lane: when the root
    stage is co-located with the coordinator, its final gather is one
    more in-slice edge (the page enters the segment under an all-zero
    destination vector and the coordinator takes partition 0).

    Returns True when the batch entered the segment (or was empty: the
    seal carries 'complete, zero rows'), False when the lane cannot
    carry this page and the caller keeps the serialized buffer."""
    spec = task.spec
    if (
        slice_id == ""
        or spec.ici_slice != slice_id
        or spec.n_partitions != 1
        or not _page_eligible(out)
    ):
        if spec.ici_slice and spec.n_partitions == 1:
            REGISTRY.counter("exchange.ici_fallbacks").update()
        return False
    if int(out.num_valid) == 0:
        return True
    out = _owned(out)
    dest = torch.zeros(out.capacity, dtype=torch.int64, device=out.device)
    _publish(task, out, dest, 1, slice_id, pool)
    return True


def seal_task(slice_id: str, task_id: str, nparts: int) -> None:
    """Producer FINISHED cleanly: seal before the terminal state is
    visible (FINISHED must imply the in-slice copy is complete)."""
    SEGMENT.seal(slice_id, task_id, nparts)


def discard_task(task_id: str) -> int:
    """Task failed, aborted or DELETEd: drop its segment entry and any
    collective stage built over it (a retried producer republishes
    other batches); returns the bytes to release."""
    COLLECTIVE.discard_task(task_id)
    return SEGMENT.discard(task_id)


# Degrading a task's ICI edges to the HTTP wire happens in two halves so
# the commit is atomic: ``serialize_ici_frames`` is a pure read (an
# exception leaves nothing torn and the degrade can retry),
# ``buffer_frames`` reserves once and appends everything under one lock
# hold (pullers see the buffers either without these frames or with
# all of them). ``WorkerServer._materialize_ici`` drives the pair for a
# DRAINING producer and for an HTTP pull of a FINISHED ICI task (a merge
# retry that landed cross-slice). Every partition materializes,
# including ones an ICI consumer took: partitioned buffers serve retried
# merge attempts from token 0, as the HTTP lane's buffers do.


def serialize_ici_frames(task):
    """First half: the task's segment batches as ``[(partition,
    frame), ...]`` wire frames, or None when it has no entry. Touches no
    buffer and makes no reservation."""
    from presto_tpu_torch.exec import streaming as S

    snap = SEGMENT.snapshot(task.spec.task_id)
    if snap is None:
        return None
    frames = []
    for page, dest in snap["batches"]:
        payload, schema, nr = S._page_to_payload(page)
        bk = _fetch_dest(dest, nr)
        for part, frame, _ in _serialize_partition_slices(
            payload, schema, nr, bk
        ):
            frames.append((part, frame))
    return frames


def buffer_frames(task, frames, pool) -> int:
    """Commit already-serialized ``[(partition, frame), ...]`` to the
    task's per-partition buffers at once: one pool reservation for the
    whole set and one locked append (direct appends, not
    ``offer_page``: the spool tee already ran at produce time). Then
    the task's segment entry, if any, drops and its device-byte
    reservation is released. Returns the frame count."""
    total = sum(len(f) for _, f in frames)
    if pool is not None and total:
        pool.reserve(task.buf_key, total)
    with task.cond:
        for part, frame in frames:
            task.parts[part].append(frame)
        task.cond.notify_all()
    for _, frame in frames:
        REGISTRY.counter("exchange.http_shuffle_bytes").update(len(frame))
    freed = SEGMENT.discard(task.spec.task_id)
    if freed and pool is not None:
        pool.release(task.buf_key, freed)
    if frames:
        REGISTRY.counter("exchange.ici_materialized").update()
    return len(frames)


# ----------------------------------------------------- consumer side


def _await_sealed(slice_id: str, task_id: str, part: int, deadline, probe):
    """Wait for a producer's entry to seal, then take ``part`` of it
    (``IciSegment.take``'s batches and partition count); None (counted
    in ``exchange.ici_fallbacks``) when the entry is
    foreign, never seals before ``deadline``, or ``probe()`` says the
    producer is gone. ``probe`` is consulted between waits only, so the
    control-plane HTTP stays off the hot path."""
    last_probe = 0.0
    while True:
        st = SEGMENT.peek(slice_id, task_id)
        if st == "sealed":
            got = SEGMENT.take(slice_id, task_id, part)
            if got is not None:
                REGISTRY.counter("exchange.ici_edges").update()
                return got
            break
        if st == "foreign":
            break
        now = time.monotonic()
        if now > deadline:
            break
        if now - last_probe > 0.5:
            last_probe = now
            if probe() is False:
                # terminal: the producer seals BEFORE publishing
                # FINISHED, so sealed-or-never is decidable now
                if SEGMENT.peek(slice_id, task_id) == "sealed":
                    continue
                break
        SEGMENT.wait(0.05)
    REGISTRY.counter("exchange.ici_fallbacks").update()
    return None


def ici_fetch(slice_id: str, spec, src_task: str, deadline: float, probe):
    """Consumer half of the ICI transport: wait for the producer's entry
    to seal, then take this merge task's partition. Returns the
    ``[(page, dest), ...]`` batches with the producer's partition count
    (the collective's fan-out), or None: the caller pulls HTTP, then the
    spool, as for a dead HTTP peer. ``probe()`` answers whether the
    producer attempt is still alive (True = keep waiting)."""
    if not spec.ici_slice or spec.ici_slice != slice_id:
        return None
    return _await_sealed(slice_id, src_task, spec.partition, deadline, probe)


def ici_batches_to_payloads(batches, part: int):
    """ICI batches as host wire payloads ``[(payload, schema, nrows),
    ...]``, the shape ``pages_wire.merge_payloads`` consumes: used when a
    merge group mixes transports or exceeds the device budget (still no
    serialization and no HTTP, one device-to-host copy per batch)."""
    from presto_tpu_torch.exec import streaming as S

    out = []
    for page, dest in batches:
        payload, pschema, nr = S._page_to_payload(page)
        mask = _fetch_dest(dest, nr) == part
        n = int(mask.sum())
        if n:
            out.append((S._slice_payload(payload, pschema, mask), pschema, n))
    return out


def _union_dictionaries(flat, names, device):
    """Per column, the union dictionary of every batch's block (None for
    columns without one) and per batch the id remaps into it on
    ``device`` — ``merge_payloads``' sorted union, with its fast path:
    batches that share one dictionary object keep it, unremapped."""
    from presto_tpu_torch.page import Dictionary

    union: Dict[str, object] = {}
    remaps: List[Dict[str, torch.Tensor]] = [{} for _ in flat]
    for name in names:
        dicts = [
            pg.block(name).dictionary
            for pg, _ in flat
            if pg.block(name).dictionary is not None
        ]
        if not dicts:
            union[name] = None
            continue
        if all(d is dicts[0] for d in dicts):
            union[name] = dicts[0]
            continue
        uarr = np.asarray(
            sorted(set().union(*[tuple(d.values) for d in dicts])), object
        )
        union[name] = Dictionary(uarr)
        for rm, (pg, _) in zip(remaps, flat):
            d = pg.block(name).dictionary
            if d is not None:
                rm[name] = torch.from_numpy(np.searchsorted(
                    uarr, np.asarray(d.values, object)
                ).astype(np.int64)).to(device)
    return union, remaps


def _merged_page(names, schema, cols, union, total: int, device):
    """Wrap merged column tensors as the merge task's input page."""
    from presto_tpu_torch.page import Block, Page

    return Page(
        blocks=tuple(
            Block(
                data=cols[n]["data"], valid=cols[n]["valid"],
                dtype=schema[n], dictionary=union[n],
            )
            for n in names
        ),
        num_valid=torch.tensor(total, dtype=torch.int32, device=device),
        names=names,
    )


def device_merge(
    batches_by_source, part: int, schema, device, max_rows=None, fold=None
):
    """Build the merge task's input page ON the device from ICI batches:
    every source's rows of ``part`` copied into one zero-padded buffer
    on ``device`` (``parallel.exchange.ici_append``), dictionary ids
    remapped into the union dictionary: the same union, row order and
    capacity bucket the HTTP path's ``merge_payloads`` + ``stage_page``
    give, so the downstream fragment computes identically.

    Returns ``(page, total_rows)``, or None when the partition exceeds
    ``max_rows`` (the caller degrades to the grouped host merge)."""
    from presto_tpu_torch.exec.staging import bucket_capacity
    from presto_tpu_torch.page import to_host

    flat = [b for src in batches_by_source for b in src]
    names = tuple(schema.keys())
    # one small device-to-host copy sizes the buffer (counts only: the
    # data plane stays on the device)
    count_vecs = to_host(
        [X.ici_partition_counts(pg, d).to(device) for pg, d in flat]
    )
    d2h = sum(int(c.nbytes) for c in count_vecs)
    DEVICE.count_d2h(d2h)
    _count_dispatch(len(flat), fold)
    if fold is not None:
        fold(device_d2h_bytes=d2h)
    counts = [int(c[part]) for c in count_vecs]
    total = int(sum(counts))
    if max_rows is not None and total > max_rows:
        return None
    cap = bucket_capacity(total)
    union, remaps = _union_dictionaries(flat, names, device)
    out = {}
    for name in names:
        t = schema[name]
        tail = tuple(flat[0][0].block(name).data.shape[1:]) if flat else ()
        out[name] = {
            "data": torch.zeros(
                (cap,) + tail, dtype=t.torch_dtype, device=device
            ),
            "valid": (
                torch.zeros(cap, dtype=torch.bool, device=device)
                if any(pg.block(name).valid is not None for pg, _ in flat)
                else None
            ),
        }
    offset = 0
    for (pg, dest), cnt, rm in zip(flat, counts, remaps):
        X.ici_append(out, pg, dest, part, offset, cnt, rm)
        _count_dispatch(1, fold)
        offset += cnt
    return _merged_page(names, schema, out, union, total, device), total


# ------------------------------------------------- collective stages


class _CollectiveCache:
    """One single-program exchange per (slice, producer set): the first
    merge task of a stage builds the routed slabs (one pass over every
    batch of every producer, ``parallel.exchange.collective_gather``);
    sibling merge tasks take their partitions from the same slabs.
    Entries die when every partition is served or when any producer
    task is discarded. Build failures and size refusals are cached too,
    so siblings fall back to the per-source path without rebuilding."""

    def __init__(self):
        self._cond = threading.Condition()
        self._entries: Dict[tuple, dict] = {}

    def lookup(self, key, builder):
        """The built stage entry for ``key`` (None when the build failed
        or was refused). The first caller builds outside the lock;
        concurrent siblings wait instead of building twice."""
        with self._cond:
            while True:
                e = self._entries.get(key)
                if e is None:
                    e = {"state": "building", "entry": None, "served": set()}
                    self._entries[key] = e
                    break
                if e["state"] == "building":
                    self._cond.wait(1.0)
                    continue
                return e["entry"]
        built = None
        try:
            built = builder()
        except Exception as exc:
            log.info(
                "collective stage build failed (%s); falling back to the "
                "per-source gather", exc,
            )
            REGISTRY.counter("exchange.collective_fallbacks").update()
        with self._cond:
            e["state"] = "ready" if built is not None else "failed"
            e["entry"] = built
            self._cond.notify_all()
        return built

    def served(self, key, part: int, nparts: int) -> None:
        with self._cond:
            e = self._entries.get(key)
            if e is None or e["state"] == "building":
                return
            e["served"].add(int(part))
            if len(e["served"]) >= int(nparts):
                self._entries.pop(key, None)

    def discard_task(self, task_id: str) -> None:
        with self._cond:
            for k in [k for k in self._entries if task_id in k[1]]:
                self._entries.pop(k, None)

    def stats(self) -> dict:
        with self._cond:
            return {"entries": len(self._entries)}


#: the one collective-stage cache of this process (= this slice)
COLLECTIVE = _CollectiveCache()


def _build_collective(flat, batch_src, schema, nparts, max_rows, fold):
    """Route ``flat`` (every batch of every ICI source, source-major) in
    one pass: one counts pass sizes the slabs, one routing pass moves
    every row — against one counts and one append pass PER BATCH on the
    per-source path. Returns the stage entry, or None when a partition
    would exceed ``max_rows``."""
    from presto_tpu_torch.exec.staging import bucket_capacity
    from presto_tpu_torch.page import to_host

    names = tuple(schema.keys())
    device = flat[0][0].device
    union, remaps = _union_dictionaries(flat, names, device)
    pages = [X.strip_dictionaries(pg) for pg, _ in flat]
    dests = [d for _, d in flat]
    (counts_t,) = to_host([X.collective_counts(pages, dests, nparts)])
    counts = counts_t.numpy()
    _count_dispatch(1, fold)
    DEVICE.count_d2h(int(counts.nbytes))
    if fold is not None:
        fold(device_d2h_bytes=int(counts.nbytes))
    totals = counts.sum(axis=0)
    peak = int(totals.max(initial=0))
    if max_rows is not None and peak > max_rows:
        return None
    out = X.collective_gather(
        pages, dests, remaps,
        {n: schema[n].torch_dtype for n in names},
        nparts, bucket_capacity(peak),
    )
    _count_dispatch(1, fold)
    REGISTRY.counter("exchange.collective_stages").update()
    return {
        "out": out,
        "counts": counts,
        "totals": totals,
        "union": union,
        "names": names,
        "batch_src": tuple(batch_src),
    }


def _collective_page(entry, part: int, schema, device, fold):
    """One partition of a built stage as a Page on ``device``: the same
    union dictionary, row order (flat batch order) and capacity bucket
    as :func:`device_merge`."""
    from presto_tpu_torch.exec.staging import bucket_capacity

    total = int(entry["totals"][part])
    taken = X.collective_take(
        entry["out"], entry["names"], part, bucket_capacity(total), device
    )
    _count_dispatch(1, fold)
    return (
        _merged_page(
            entry["names"], schema, taken, entry["union"], total, device
        ),
        total,
    )


def _collective_flat(batches_by_source):
    """Source-major flattening shared by the collective entry points:
    the flat batch order IS the output row order, so it must match the
    merge task's source order."""
    flat: List[tuple] = []
    batch_src: List[int] = []
    for i, src in enumerate(batches_by_source):
        for b in src:
            flat.append(b)
            batch_src.append(i)
    return flat, batch_src


def _stage_entry(slice_id, srcs, batches_by_source, schema, nparts,
                 max_rows, fold):
    flat, batch_src = _collective_flat(batches_by_source)
    if not flat:
        return None, None
    key = (slice_id, tuple(srcs), int(nparts))
    entry = COLLECTIVE.lookup(
        key,
        lambda: _build_collective(
            flat, batch_src, schema, nparts, max_rows, fold
        ),
    )
    return key, entry


def collective_merge(
    slice_id: str, srcs, batches_by_source, part: int, schema,
    nparts: int, device, max_rows=None, fold=None,
):
    """Single-program variant of :func:`device_merge`: one routing pass
    serves every partition of the stage, and this merge task takes
    ``part`` from the shared slabs. Bit-identical output. Returns
    ``(page, total)`` or None: the caller falls back to
    :func:`device_merge`, then the grouped host merge."""
    key, entry = _stage_entry(
        slice_id, srcs, batches_by_source, schema, nparts, max_rows, fold
    )
    if key is None:
        return None
    got = None
    if entry is not None:
        try:
            got = _collective_page(entry, part, schema, device, fold)
        except Exception as exc:
            log.info("collective take failed (%s); per-source fallback", exc)
            REGISTRY.counter("exchange.collective_fallbacks").update()
    COLLECTIVE.served(key, part, nparts)
    return got


def collective_payloads(
    slice_id: str, srcs, batches_by_source, part: int, schema,
    nparts: int, fold=None,
):
    """Mixed-transport splice: the ICI sources' share of ``part`` out of
    the same routing pass, as host wire payloads — one (possibly empty)
    ``[(payload, schema, nrows)]`` list per source, index-aligned with
    ``batches_by_source``, ready to interleave with the HTTP sources'
    payloads under ``merge_payloads``. Returns None when the collective
    is unavailable (the caller converts per source)."""
    from presto_tpu_torch.exec import streaming as S

    key, entry = _stage_entry(
        slice_id, srcs, batches_by_source, schema, nparts, None, fold
    )
    if key is None:
        return None
    got = None
    if entry is not None:
        try:
            page, _ = _collective_page(
                entry, part, schema, torch.device("cpu"), fold
            )
            payload, pschema, nr = S._page_to_payload(page)
            counts = entry["counts"][:, part]
            src_of = np.asarray(entry["batch_src"])
            out = []
            start = 0
            for i in range(len(batches_by_source)):
                n_i = int(counts[src_of == i].sum())
                if n_i:
                    mask = np.zeros(nr, bool)
                    mask[start:start + n_i] = True
                    out.append(
                        [(S._slice_payload(payload, pschema, mask), pschema, n_i)]
                    )
                else:
                    out.append([])
                start += n_i
            got = out
        except Exception as exc:
            log.info("collective splice failed (%s); per-source fallback", exc)
            REGISTRY.counter("exchange.collective_fallbacks").update()
    COLLECTIVE.served(key, part, nparts)
    return got


def ici_gather(slice_id: str, spec, deadline: float, probe):
    """Coordinator half of the ICI gather edge: when the root stage's
    single-partition output is co-located, take it straight from the
    segment, with no serialization and no HTTP. Returns host payloads
    ``[(payload, schema, nrows), ...]`` (the shape the result assembly
    consumes), or None: the caller pulls HTTP, which stays correct (the
    worker materializes the segment lazily on the first HTTP read)."""
    if not slice_id or spec.ici_slice != slice_id or spec.n_partitions != 1:
        return None
    got = _await_sealed(slice_id, spec.task_id, 0, deadline, probe)
    return None if got is None else ici_batches_to_payloads(got[0], 0)

"""The multi-device exchange: Presto's shuffle as explicit collectives.

The PyTorch counterpart of ``presto_tpu/parallel/exchange.py``
(reference: the exchange layer, ``PartitionedOutputOperator`` /
``OutputBuffer`` on the producer side and ``ExchangeClient`` on the
consumer side, with the exchange types REPARTITION / REPLICATE / GATHER;
SURVEY.md §2.1, §2.5, §3.4).

The reference runs one ``shard_map`` program over a device mesh and
does each exchange inside it as an XLA collective. The port keeps one
controller: a sharded page is a Python list with one ``Page`` per shard,
each on its shard's device (a device may repeat, so n shards can share
one card), and each collective is a function over those lists:

- REPARTITION (``partition_exchange``): every source bucket-scatters its
  rows by destination into ``n`` slabs of ``bucket_cap`` rows; the
  all_to_all hands destination d its slab from every source, in source
  order, moved with ``.to(device_d)``.
- REPLICATE (``replicate``): the all_gather, every shard's live rows
  concatenated in shard order, once per distinct destination device.
- GATHER (``gather_stacked``): the fragment boundary, the shards' live
  prefixes concatenated onto the consumer's device.

The static-shape protocol is the reference's: each source sends exactly
``bucket_cap`` rows to every peer, per-destination counts ride along,
and a count above ``bucket_cap`` raises the overflow flag (the runner
re-runs with a larger balance factor). Rows hash with splitmix64 over
the orderable int64 image of each key column, NULLs as a sentinel.

Torch's ``uint64`` lacks ``>>``, ``*`` and ``%`` on CUDA, so every hash
runs on int64 bit patterns: multiplication wraps to the same bits, a
logical right shift masks off the sign fill (``int128._lsr``) and the
unsigned modulus splits the value into 32-bit halves (``umod``).

The second half of the module is the device side of the server's
in-slice (ICI) lane (``server/exchange_spi.py``): ``bucket_dest`` places
every row in the same partition as the host wire's
``exec/streaming.py::_bucket_of``, bit for bit, so attempts of one
producer on either transport partition alike; ``ici_append`` and the
single-program ``collective_gather`` move rows between co-located
workers' device pages without serialization.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch.expr import _i64
from presto_tpu_torch.int128 import _lsr
from presto_tpu_torch.ops.common import key_lanes
from presto_tpu_torch.page import Block, Dictionary, Page, nonzero_static

_NULL_SENTINEL = _i64(0xA5A5_A5A5_DEAD_BEEF)
_SEED = _i64(0x9E3779B97F4A7C15)
_MASK32 = 0xFFFFFFFF


def _mix64(h: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 bit patterns (the reference's
    uint64 ``_mix64``, bit for bit)."""
    h = h ^ _lsr(h, 30)
    h = h * _i64(0xBF58476D1CE4E5B9)
    h = h ^ _lsr(h, 27)
    h = h * _i64(0x94D049BB133111EB)
    return h ^ _lsr(h, 31)


def umod(h: torch.Tensor, n: int) -> torch.Tensor:
    """The unsigned value of int64 bit patterns ``h`` modulo ``0 < n <
    2^31`` (``%`` on a negative int64 would take the signed value): with
    ``h = hi * 2^32 + lo``, ``h mod n = ((hi mod n) * (2^32 mod n) + lo)
    mod n``, every term non-negative and below 2^63."""
    n = int(n)
    hi = _lsr(h, 32) % n
    lo = h & _MASK32
    return (hi * ((1 << 32) % n) + lo) % n


def partition_hash(page: Page, key_cols: Sequence[str]) -> torch.Tensor:
    """The int64 bits of the reference's uint64 hash per row over the
    key columns: a function of the normalized key values only (NULLs as
    a sentinel), so equal keys hash equally on every shard and on both
    sides of a join. A long decimal contributes both limb lanes."""
    h = torch.full(
        (page.capacity,), _SEED, dtype=torch.int64, device=page.device
    )
    for c in key_cols:
        blk = page.block(c)
        for lane in key_lanes(blk.data, blk.dtype):
            x = lane.to(torch.int64)
            if blk.valid is not None:
                x = torch.where(blk.valid, x, _NULL_SENTINEL)
            h = _mix64(h ^ x)
    return h


def _flat_blocks(page: Page) -> None:
    for name, blk in zip(page.names, page.blocks):
        if blk.offsets is not None or blk.children:
            raise NotImplementedError(
                f"nested column {name} ({blk.dtype}) cannot ride a "
                "multi-device exchange"
            )


def _dictionary_of(blks: Sequence[Block]) -> Optional[Dictionary]:
    """The one dictionary that every shard's block of a column carries
    (shards of one table share it; a shard whose dictionary differs
    would make the concatenated ids meaningless)."""
    d = blks[0].dictionary
    for b in blks[1:]:
        if b.dictionary is not d and b.dictionary != d:
            raise ValueError(
                "shards of one column carry different dictionaries"
            )
    return d


def page_row_bytes(page: Page) -> int:
    """Bytes per row of a flat page (data plus a validity byte): what a
    collective moves per row it routes."""
    total = 0
    for blk in page.blocks:
        width = blk.data.element_size()
        for d in blk.data.shape[1:]:
            width *= d
        total += width + (1 if blk.valid is not None else 0)
    return total


def compact_flat(page: Page, live: torch.Tensor, num_valid) -> Page:
    """Compact the rows where ``live`` to the front (the static-shape
    nonzero), keeping the capacity."""
    sel = nonzero_static(live, page.capacity, fill_value=0)
    return Page(
        blocks=tuple(
            dataclasses.replace(
                blk,
                data=blk.data[sel],
                valid=None if blk.valid is None else blk.valid[sel],
            )
            for blk in page.blocks
        ),
        num_valid=torch.as_tensor(num_valid).to(torch.int32),
        names=page.names,
    )


def segmented_live_mask(counts: torch.Tensor, seg_cap: int) -> torch.Tensor:
    """Flat live mask over ``len(counts)`` segments of ``seg_cap`` rows:
    row j of segment i is live iff j < counts[i]."""
    j = torch.arange(seg_cap, dtype=torch.int64, device=counts.device)
    return (j[None, :] < counts[:, None].to(torch.int64)).reshape(-1)


def _count_by(D: torch.Tensor, nparts: int) -> torch.Tensor:
    """Rows per destination ``0 .. nparts - 1`` of ``D`` (values in
    ``[0, nparts]``; ``nparts`` is the trash). A scatter-add into a
    fixed-size vector: ``torch.bincount`` reads the maximum back to size
    its output, a host wait per call on the card."""
    counts = torch.zeros(nparts + 1, dtype=torch.int64, device=D.device)
    counts.scatter_add_(0, D.to(torch.int64), torch.ones_like(D, dtype=torch.int64))
    return counts[:nparts]


def _dest_slots(D: torch.Tensor, nparts: int, seg_cap: int):
    """Stable destination grouping: the order that sorts rows by
    destination, each sorted row's flat slot ``dest * seg_cap +
    offset`` (trash and overflow rows go to the one slot past the end)
    and the row count per destination. ``D`` holds ``nparts`` for dead
    rows."""
    n = D.shape[0]
    order = torch.argsort(D, stable=True)
    d_s = D[order]
    offset = torch.arange(n, dtype=torch.int64, device=D.device) - (
        torch.searchsorted(d_s, d_s, side="left")
    )
    sendable = (d_s < nparts) & (offset < seg_cap)
    slot = torch.where(
        sendable, d_s.to(torch.int64) * seg_cap + offset, nparts * seg_cap
    )
    return order, slot, _count_by(D, nparts)


def _route_flat(flat, order, slot, nslots: int) -> torch.Tensor:
    """Scatter the sorted rows into their slots of a zero slab of
    ``nslots`` rows (the slot past the end takes what is dropped)."""
    out = torch.zeros(
        (nslots + 1,) + tuple(flat.shape[1:]),
        dtype=flat.dtype,
        device=flat.device,
    )
    out.index_copy_(0, slot, flat[order])
    return out[:nslots]


def partition_exchange(
    pages: Sequence[Page],
    dests: Sequence[torch.Tensor],
    bucket_cap: int,
) -> Tuple[List[Page], List[torch.Tensor]]:
    """REPARTITION: route each live row of shard i to shard
    ``dests[i][row]``.

    Returns (pages', overflows): pages'[d] lives on shard d's device,
    has capacity ``n * bucket_cap`` and holds every row routed to d,
    compacted, in source order and within a source in row order;
    overflows[i] is True when a bucket of source i exceeded
    ``bucket_cap`` (its surplus rows are dropped and the caller re-runs
    with a larger balance factor). One column at a time: its slabs are
    freed before the next column's are built."""
    n = len(pages)
    for p in pages:
        _flat_blocks(p)
    routes, sent_counts, overflows = [], [], []
    for page, dest in zip(pages, dests):
        d = torch.where(page.row_mask(), dest.to(torch.int64), n)
        order, slot, counts = _dest_slots(d, n, bucket_cap)
        routes.append((order, slot))
        overflows.append(torch.any(counts > bucket_cap))
        sent_counts.append(torch.clamp(counts, max=bucket_cap))
    # per destination: the received counts, the compaction of its
    # received segments, and its live total
    recv = []
    for d, page_d in enumerate(pages):
        dev = page_d.device
        out_counts = torch.stack([c[d].to(dev) for c in sent_counts])
        live = segmented_live_mask(out_counts, bucket_cap)
        recv.append((
            nonzero_static(live, n * bucket_cap, fill_value=0),
            torch.sum(out_counts).to(torch.int32),
        ))
    columns: List[List[Block]] = [[] for _ in pages]
    for j in range(len(pages[0].blocks)):
        blks = [p.blocks[j] for p in pages]
        dictionary = _dictionary_of(blks)
        sent = [
            _route_flat(b.data, order, slot, n * bucket_cap)
            for b, (order, slot) in zip(blks, routes)
        ]
        any_valid = any(b.valid is not None for b in blks)
        vsent = [
            None if b.valid is None
            else _route_flat(b.valid, order, slot, n * bucket_cap)
            for b, (order, slot) in zip(blks, routes)
        ]
        for d, page_d in enumerate(pages):
            dev = page_d.device
            sel = recv[d][0]
            lo, hi = d * bucket_cap, (d + 1) * bucket_cap
            data = torch.cat([x[lo:hi].to(dev) for x in sent])[sel]
            valid = None
            if any_valid:
                valid = torch.cat([
                    torch.ones(bucket_cap, dtype=torch.bool, device=dev)
                    if v is None else v[lo:hi].to(dev)
                    for v in vsent
                ])[sel]
            columns[d].append(dataclasses.replace(
                blks[0], data=data, valid=valid, dictionary=dictionary,
            ))
        del sent, vsent
    out = [
        Page(blocks=tuple(cols), num_valid=recv[d][1], names=pages[d].names)
        for d, cols in enumerate(columns)
    ]
    return out, overflows


def _concat_live(pages: Sequence[Page], device: torch.device) -> Page:
    """Every page's rows concatenated on ``device`` (capacity the sum of
    the pages'), live rows compacted to the front in page order."""
    blocks = []
    for j in range(len(pages[0].blocks)):
        blks = [p.blocks[j] for p in pages]
        data = torch.cat([b.data.to(device) for b in blks])
        valid = None
        if any(b.valid is not None for b in blks):
            valid = torch.cat([
                torch.ones(b.capacity, dtype=torch.bool, device=device)
                if b.valid is None
                else b.valid.to(device)
                for b in blks
            ])
        blocks.append(dataclasses.replace(
            blks[0], data=data, valid=valid, dictionary=_dictionary_of(blks)
        ))
    live = torch.cat([p.row_mask().to(device) for p in pages])
    total = torch.sum(torch.stack([p.num_valid.to(device) for p in pages]))
    gathered = Page(
        blocks=tuple(blocks), num_valid=total.to(torch.int32),
        names=pages[0].names,
    )
    return compact_flat(gathered, live, total)


def replicate(pages: Sequence[Page]) -> List[Page]:
    """REPLICATE: the all_gather of every shard's live rows; shard d
    gets the concatenation in shard order on its device (capacity the
    sum of the shards'). Masked pages gather their live masks. Shards
    on one device share one gathered page (pages are immutable)."""
    for p in pages:
        _flat_blocks(p)
    by_device: Dict[torch.device, Page] = {}
    out = []
    for p in pages:
        got = by_device.get(p.device)
        if got is None:
            got = by_device[p.device] = _concat_live(pages, p.device)
        out.append(got)
    return out


def gather_stacked(
    pages: Sequence[Page],
    counts: Sequence[int],
    replicated: bool,
    device: torch.device,
) -> Page:
    """GATHER, the fragment boundary on the consumer side: the shards'
    prefix-form outputs as one page on ``device``. A replicated fragment
    contributes shard 0 only; a partitioned one concatenates every
    shard's live prefix (``counts``, read on the host with the
    fragment's flags) into the sum of the shards' capacities."""
    if replicated:
        p = pages[0]
        return Page(
            blocks=tuple(
                dataclasses.replace(
                    b,
                    data=b.data.to(device),
                    valid=None if b.valid is None else b.valid.to(device),
                )
                for b in p.blocks
            ),
            num_valid=p.num_valid.to(device),
            names=p.names,
        )
    for p in pages:
        _flat_blocks(p)
    cap = sum(p.capacity for p in pages)
    total = int(sum(counts))
    pad = cap - total
    blocks = []
    for j in range(len(pages[0].blocks)):
        blks = [p.blocks[j] for p in pages]
        parts = [b.data[:c].to(device) for b, c in zip(blks, counts)]
        tail = tuple(blks[0].data.shape[1:])
        parts.append(torch.zeros(
            (pad,) + tail, dtype=blks[0].data.dtype, device=device
        ))
        valid = None
        if any(b.valid is not None for b in blks):
            valid = torch.cat([
                torch.ones(c, dtype=torch.bool, device=device)
                if b.valid is None
                else b.valid[:c].to(device)
                for b, c in zip(blks, counts)
            ] + [torch.zeros(pad, dtype=torch.bool, device=device)])
        blocks.append(dataclasses.replace(
            blks[0], data=torch.cat(parts), valid=valid,
            dictionary=_dictionary_of(blks),
        ))
    return Page(
        blocks=tuple(blocks),
        num_valid=torch.tensor(total, dtype=torch.int32, device=device),
        names=pages[0].names,
    )


# --------------------------------------------------------------------
# The in-slice (ICI) lane's device half (server/exchange_spi.py).
#
# CORRECTNESS CONTRACT: ``bucket_dest`` assigns every row the SAME
# partition as the host wire's ``exec.streaming._bucket_of``. Attempts
# of one logical producer may run on either transport, and merge tasks
# pick attempts per partition independently: if the two hashes ever
# disagreed, a retried stage could duplicate or lose rows.
# ``_wire_hash_image`` therefore replicates ``_col_hash_input`` bit for
# bit (dictionary ids hash by VALUE through crc32, -0.0 like +0.0, long
# decimals mix the hi limb and fold in lo, NULLs as 0); tests pin it.


def wire_crc_table(dictionary, device) -> torch.Tensor:
    """Per-value crc32 of a page dictionary on ``device``: the
    dictionary-id image of the host's ``_col_hash_input`` (ids hash by
    value, so producers whose dictionaries differ partition alike),
    through the host's per-dictionary cache (a stream's batches share
    their dictionaries)."""
    from presto_tpu_torch.exec import streaming

    return torch.from_numpy(
        streaming._crc_image(dictionary.values).astype(np.int64)
    ).to(device)


def _wire_hash_image(
    blk: Block, crc_table: Optional[torch.Tensor]
) -> torch.Tensor:
    """The int64 bits of one key block's per-row hash image, equal to
    the host's ``_col_hash_input`` (see the contract above)."""
    data = blk.data
    if crc_table is not None:
        if crc_table.shape[0] == 0:  # all-NULL column: empty dictionary
            img = torch.zeros(
                data.shape[0], dtype=torch.int64, device=data.device
            )
        else:
            ids = torch.clamp(data.to(torch.int64), 0, crc_table.shape[0] - 1)
            img = crc_table[ids]
    elif data.dim() == 2 and data.shape[1] == 2:
        # long-decimal limb pairs: mix the hi limb, fold in lo
        img = _mix64(data[:, 0].to(torch.int64)) ^ data[:, 1].to(torch.int64)
    elif blk.dtype.name in ("double", "real"):
        f = data.to(torch.float64)
        f = torch.where(f == 0, 0.0, f)  # -0.0 hashes like +0.0
        img = f.view(torch.int64)
    else:
        img = data.to(torch.int64)
    if blk.valid is not None:
        img = torch.where(blk.valid, img, 0)
    return img


def bucket_dest(
    page: Page,
    crc_tables: Dict[str, torch.Tensor],
    n_buckets: int,
    key_cols: Sequence[str],
) -> torch.Tensor:
    """Per-row destination partition (int64), equal to the host's
    ``_bucket_of`` on the same rows; dictionary key columns hash
    through their entry of ``crc_tables`` (``wire_crc_table``). Dead
    rows get arbitrary destinations (callers mask them)."""
    h = torch.full(
        (page.capacity,), _SEED, dtype=torch.int64, device=page.device
    )
    for c in key_cols:
        h = _mix64(h ^ _mix64(_wire_hash_image(page.block(c), crc_tables.get(c))))
    return umod(h, n_buckets)


def strip_dictionaries(page: Page) -> Page:
    """The page without its blocks' dictionaries: what the collective
    routes are ids that the caller remaps into a union dictionary and
    re-attaches to the merged page (a producer's own dictionary no
    longer describes them)."""
    return dataclasses.replace(
        page,
        blocks=tuple(
            dataclasses.replace(b, dictionary=None) for b in page.blocks
        ),
    )


#: the partition fan-out of the in-slice lane's count pass; larger
#: fan-outs take the HTTP wire (the scheduler's transport selection)
MAX_ICI_PARTS = 64


def ici_partition_counts(page: Page, dest: torch.Tensor) -> torch.Tensor:
    """Live-row count per partition, shape (MAX_ICI_PARTS,): one fetch
    sizes every consumer's merge buffer."""
    d = torch.where(page.row_mask(), dest.to(torch.int64), MAX_ICI_PARTS)
    return _count_by(d, MAX_ICI_PARTS)


# --------------------------------------------------------------------
# Single-program collective stages: when every producer of a merge
# stage shares the slice, the per-source gathers (``ici_append`` per
# batch and partition) collapse into one routing pass over every batch
# (``collective_gather``): a counts pass, the routing pass, one take per
# partition. Row order and zero padding are the per-source path's (flat
# batch order, stable within a destination), so the output is
# bit-identical to ``device_merge`` and to the HTTP wire's payload
# concatenation.


def collective_counts(pages, dests, nparts: int) -> torch.Tensor:
    """Per-batch per-partition live-row counts, shape ``(len(pages),
    nparts)``, on the first page's device: one fetch sizes the whole
    stage."""
    dev = pages[0].device
    per = []
    for pg, dest in zip(pages, dests):
        d = torch.where(pg.row_mask(), dest.to(torch.int64), nparts)
        per.append(_count_by(d, nparts).to(dev))
    return torch.stack(per)


def _concat_routed(pages, dests, remaps, dtypes, nparts: int):
    """Every batch's columns and destinations concatenated onto the
    first page's device: dead rows carry the trash destination
    ``nparts``, dictionary ids pass through their union remap, every
    column takes its schema dtype. Returns (columns by name, validity by
    name for the columns that have any, destinations)."""
    dev = pages[0].device
    D = torch.cat([
        torch.where(pg.row_mask(), dest.to(torch.int64), nparts).to(dev)
        for pg, dest in zip(pages, dests)
    ])
    cols: Dict[str, torch.Tensor] = {}
    vals: Dict[str, torch.Tensor] = {}
    for name in pages[0].names:
        parts, vparts = [], []
        any_valid = any(pg.block(name).valid is not None for pg in pages)
        for pg, rmps in zip(pages, remaps):
            blk = pg.block(name)
            d = blk.data.to(dev)
            rmp = rmps.get(name)
            if rmp is not None:
                rmp = rmp.to(dev)
                d = rmp[torch.clamp(d.to(torch.int64), 0, rmp.shape[0] - 1)]
            parts.append(d.to(dtypes[name]))
            if any_valid:
                vparts.append(
                    torch.ones(pg.capacity, dtype=torch.bool, device=dev)
                    if blk.valid is None
                    else blk.valid.to(dev)
                )
        cols[name] = torch.cat(parts)
        if any_valid:
            vals[name] = torch.cat(vparts)
    return cols, vals, D


def collective_gather(pages, dests, remaps, dtypes, nparts: int, out_cap: int):
    """THE single-program exchange: route every batch's rows to their
    destination partitions in one pass on the first page's device.

    ``pages`` are the producers' pages in flat batch order, ``dests``
    their ``bucket_dest`` vectors, ``remaps`` one dict per batch of
    column name -> union-dictionary id remap (absent = identity),
    ``dtypes`` column name -> torch dtype. Returns ``{name: (nparts,
    out_cap, ...), name + "#valid": (nparts, out_cap)}`` slabs,
    partition p's rows on row p in flat batch order, zero-padded past
    its count. On one card this is one sort and one scatter per column;
    pages on other cards are copied to the first page's card first."""
    cols, vals, D = _concat_routed(pages, dests, remaps, dtypes, nparts)
    order, slot, _ = _dest_slots(D, nparts, out_cap)
    out = {}
    for name, col in cols.items():
        out[name] = _route_flat(col, order, slot, nparts * out_cap).reshape(
            (nparts, out_cap) + tuple(col.shape[1:])
        )
    for name, v in vals.items():
        out[name + "#valid"] = _route_flat(
            v, order, slot, nparts * out_cap
        ).reshape(nparts, out_cap)
    return out


def collective_take(out, names, part: int, pcap: int, device) -> dict:
    """One partition's rows of the collective output, cut to ``pcap``
    rows (the per-source path's capacity bucket) on ``device``."""
    res = {}
    for name in names:
        v = out.get(name + "#valid")
        res[name] = {
            "data": out[name][part][:pcap].to(device),
            "valid": None if v is None else v[part][:pcap].to(device),
        }
    return res


def ici_append(
    out: Dict[str, dict],
    page: Page,
    dest: torch.Tensor,
    part: int,
    offset: int,
    count: int,
    remaps: Dict[str, Optional[torch.Tensor]],
) -> None:
    """Copy one producer page's ``count`` rows of partition ``part``
    into the consumer's merge buffer at ``offset``, in place (the
    receive side of the all-to-all: rows move device to device, never
    through the host). ``out`` maps column name -> {"data", "valid"}
    preallocated buffers on the consumer's device; ``remaps`` carries
    per-column id remaps into the union dictionary (None = identity).
    Selected rows keep producer order, so the merged buffer is
    bit-identical to the HTTP wire's payload concatenation. ``count``
    is the host's copy of this page's ``ici_partition_counts`` entry."""
    if count == 0:
        return
    sel = nonzero_static(page.row_mask() & (dest == part), count)
    for name, blk in zip(page.names, page.blocks):
        slot = out[name]
        dev = slot["data"].device
        pos = torch.arange(offset, offset + count, device=dev)
        d = blk.data[sel].to(dev)
        rmp = remaps.get(name)
        if rmp is not None:
            d = rmp[torch.clamp(d.to(torch.int64), 0, rmp.shape[0] - 1)]
        slot["data"].index_copy_(0, pos, d.to(slot["data"].dtype))
        if slot["valid"] is not None:
            v = (
                torch.ones(count, dtype=torch.bool, device=dev)
                if blk.valid is None
                else blk.valid[sel].to(dev)
            )
            slot["valid"].index_copy_(0, pos, v)

"""Host -> device page staging.

The PyTorch counterpart of ``presto_tpu/exec/staging.py``. SPI column
payloads (see ``connectors.spi.Connector.create_page_source``):

- numeric numpy array in *native repr* (unscaled ints for decimals,
  epoch days for dates) -> one host-to-device copy
- ``MaskedColumn`` (native data + validity) -> copy with a null mask
- ``DictColumn`` (pre-encoded ids + sorted dictionary) -> ids copied,
  dictionary kept host-side
- ``ArrayColumn`` (int32 offsets over flat values) -> an array block
  whose value axis is bucketed like the row axis
- object numpy array of Python values (None = NULL; lists, dicts and
  row dicts for nested types) -> logical ingest

Capacities round up to power-of-two buckets (min 1024), so every table
of similar size presents the same shapes to the operators.

Split-streamed execution (``exec/streaming.py``) also uses
``merge_column_chunks``, ``page_nbytes`` and ``prefetch_iter`` from
here.

``SplitCache`` keeps staged pages on the device across queries under an
LRU byte budget, reserved in a ``utils.memory.MemoryPool`` when the
runner has one; an evicted page may move to a host-RAM spill store
(``page_to_host``) and come back on its next hit (``host_to_page``).
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import DictColumn
from presto_tpu_torch.page import (
    Block,
    Dictionary,
    Page,
    _bytes_of,
    resolve_device,
    to_host,
)
from presto_tpu_torch.utils.telemetry import DEVICE

MIN_BUCKET = 1 << 10

#: default device-resident split-cache budget, the reference's value
#: (its tier-1 key ``staging.cache-bytes``); a runner takes another
#: through ``staging_cache_bytes``
DEFAULT_CACHE_BYTES = 4 << 30


@dataclasses.dataclass
class ArrayColumn:
    """Array-column staging payload: int32 offsets (n+1) over flat
    values (+ optional per-ROW validity and element dictionary values):
    the host twin of ``Block.offsets``."""

    offsets: np.ndarray
    values: np.ndarray
    valid: Optional[np.ndarray] = None
    dict_values: Optional[tuple] = None

    def __len__(self) -> int:
        return max(len(self.offsets) - 1, 0)

    def __getitem__(self, sl: slice) -> "ArrayColumn":
        """Row slice: offsets rebase to the slice."""
        lo = sl.start or 0
        n = len(self)
        hi = min(sl.stop if sl.stop is not None else n, n)
        off = np.asarray(self.offsets[lo: hi + 1], np.int32)
        base = int(off[0]) if len(off) else 0
        end = int(off[-1]) if len(off) else base
        return ArrayColumn(
            offsets=off - base,
            values=np.asarray(self.values)[base:end],
            valid=None if self.valid is None else self.valid[lo:hi],
            dict_values=self.dict_values,
        )

    def take(self, idx: np.ndarray) -> "ArrayColumn":
        """Rows ``idx`` (int positions), vectorised: one gather index
        built from the rows' lengths, their cumsum and ``np.repeat``."""
        off = np.asarray(self.offsets, np.int64)
        idx = np.asarray(idx, np.int64)
        lens = off[1:][idx] - off[:-1][idx]
        new_off = np.zeros(len(idx) + 1, np.int32)
        np.cumsum(lens, out=new_off[1:])
        total = int(new_off[-1])
        src = np.repeat(off[:-1][idx] - new_off[:-1], lens) + np.arange(
            total, dtype=np.int64
        )
        return ArrayColumn(
            offsets=new_off,
            values=np.asarray(self.values)[src],
            valid=None if self.valid is None else np.asarray(self.valid)[idx],
            dict_values=self.dict_values,
        )


def obj_array(values) -> np.ndarray:
    """Element-wise object ndarray (``np.asarray`` would collapse
    equal-length list values, array columns, into a 2-D array)."""
    arr = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        arr[i] = v
    return arr


@dataclasses.dataclass
class MaskedColumn:
    """Native-representation column + validity mask (+ optional
    dictionary values when string-typed)."""

    data: np.ndarray
    valid: np.ndarray
    values: Optional[tuple] = None


def bucket_capacity(n: int) -> int:
    """Round up to the next power-of-two bucket (min 1024)."""
    cap = MIN_BUCKET
    while cap < n:
        cap <<= 1
    return cap


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


#: Dictionary objects by the identity of their values array: a payload
#: whose dictionary values ARE a staged Dictionary's (spilled batches,
#: merged bucket results) restages under that same Dictionary instead of
#: hashing millions of values again
_DICTIONARIES: "weakref.WeakValueDictionary[int, Dictionary]" = (
    weakref.WeakValueDictionary()
)


def dictionary_of(values) -> Dictionary:
    """The Dictionary over ``values`` (sorted unique strings), shared by
    every payload that carries the same values object."""
    d = _DICTIONARIES.get(id(values))
    if d is not None and d.values is values:
        return d
    d = Dictionary(values)
    if d.values is values:  # an ndarray kept as it is: safe to share
        _DICTIONARIES[id(values)] = d
    return d


def _padded(arr: np.ndarray, cap: int, np_dtype) -> np.ndarray:
    # long decimals carry (n, 2) limb pairs; pad on axis 0
    out = np.zeros((cap,) + arr.shape[1:], dtype=np_dtype)
    out[: len(arr)] = arr
    return out


def stage_page(
    data: Dict[str, object],
    schema: Dict[str, T.DataType],
    capacity: Optional[int] = None,
    device=None,
) -> Page:
    """Build a Page on ``device`` (``None``: the CUDA device, see
    ``page.resolve_device``) from SPI column payloads."""
    from presto_tpu_torch.connectors.spi import payload_len

    device = resolve_device(device)
    names = tuple(schema.keys())
    n = 0
    for v in data.values():
        n = payload_len(v)
        break
    cap = capacity if capacity is not None else bucket_capacity(n)
    blocks = []
    for name in names:
        t = schema[name]
        v = data[name]
        if isinstance(v, ArrayColumn):
            blocks.append(_stage_array(v, t, cap, device))
        elif isinstance(v, MaskedColumn):
            arr = v.data.astype(t.np_dtype, copy=False)
            blocks.append(
                Block(
                    data=_to_device(_padded(arr, cap, t.np_dtype), device),
                    valid=_to_device(_padded(v.valid, cap, bool), device),
                    dtype=t,
                    dictionary=(
                        dictionary_of(v.values)
                        if v.values is not None
                        else None
                    ),
                )
            )
        elif isinstance(v, DictColumn):
            ids = np.asarray(v.ids, dtype=np.int32)
            blocks.append(
                Block(
                    data=_to_device(_padded(ids, cap, np.int32), device),
                    valid=None,
                    dtype=t,
                    dictionary=dictionary_of(v.values),
                )
            )
        elif isinstance(v, np.ndarray) and v.dtype != object:
            arr = v.astype(t.np_dtype, copy=False)
            blocks.append(
                Block(
                    data=_to_device(_padded(arr, cap, t.np_dtype), device),
                    valid=None,
                    dtype=t,
                )
            )
        else:
            # a null-free column carries no mask (the reference keeps the
            # padding's, so a nullable one-hot GROUP BY over a written
            # table adds a NULL group per key and a valid count per sum)
            blocks.append(Block.from_pylist_padded(v, t, cap, device))
    page = Page(
        blocks=tuple(blocks),
        num_valid=torch.tensor(n, dtype=torch.int32, device=device),
        names=names,
    )
    # device-plane accounting (utils/telemetry.py): the bytes this
    # staging copied and the bucket padding the device will compute
    # over; guarded so the disabled plane skips even the nbytes walk
    if DEVICE.enabled:
        DEVICE.count_h2d(page_nbytes(page))
        DEVICE.count_padding(n, cap)
    return page


def stage_sharded(
    payloads: List[Dict[str, object]],
    schema: Dict[str, T.DataType],
    capacity: int,
    devices: List[torch.device],
) -> List[Page]:
    """Host payloads -> one page per shard, shard i on ``devices[i]``,
    every shard at the same ``capacity`` (the multi-device twin of
    :func:`stage_page`, which counts each shard's host-to-device bytes
    in ``DEVICE``; ``parallel.distributed_runner``'s scan placement)."""
    return [
        stage_page(p, schema, capacity=capacity, device=d)
        for p, d in zip(payloads, devices)
    ]


def _stage_array(
    col: ArrayColumn, t: T.DataType, cap: int, device
) -> Block:
    """An ArrayColumn -> an array block: offsets edge-padded to ``cap``
    rows (padding rows are empty), the values padded to their own
    power-of-two bucket."""
    off = np.asarray(col.offsets, np.int32)
    offsets = np.full(cap + 1, off[-1] if len(off) else 0, np.int32)
    offsets[: len(off)] = off
    valid = None
    if col.valid is not None:
        valid = _to_device(_padded(np.asarray(col.valid, bool), cap, bool), device)
    vals = np.asarray(col.values, t.element.np_dtype)
    return Block(
        data=_to_device(
            _padded(vals, bucket_capacity(len(vals)), t.element.np_dtype),
            device,
        ),
        valid=valid,
        dtype=t,
        dictionary=(
            dictionary_of(col.dict_values)
            if col.dict_values is not None
            else None
        ),
        offsets=_to_device(offsets, device),
    )


def block_tensors(blk: Block) -> List[torch.Tensor]:
    """Every tensor of a block, children included, in a fixed order:
    data, valid?, offsets?, then each child's (``rebuild_block`` reads
    them back in the same order)."""
    out = [blk.data]
    if blk.valid is not None:
        out.append(blk.valid)
    if blk.offsets is not None:
        out.append(blk.offsets)
    for ch in blk.children or ():
        out.extend(block_tensors(ch))
    return out


def rebuild_block(blk: Block, it) -> Block:
    """``blk`` with its tensors taken, in ``block_tensors`` order, from
    the iterator ``it``."""
    data = next(it)
    valid = None if blk.valid is None else next(it)
    offsets = None if blk.offsets is None else next(it)
    children = (
        None
        if blk.children is None
        else tuple(rebuild_block(ch, it) for ch in blk.children)
    )
    return dataclasses.replace(
        blk, data=data, valid=valid, offsets=offsets, children=children
    )


def merge_column_chunks(parts: List[object], dtype=None):
    """Concatenate one column's per-split payload chunks: a
    single-column view over ``server.pages_wire.merge_payloads`` (union
    dictionary, id remap, masked chunks). ``dtype`` only matters for the
    empty case."""
    from presto_tpu_torch.server.pages_wire import merge_payloads

    if len(parts) == 1:
        return parts[0]
    merged = merge_payloads(
        [({"c": p}, None, 0) for p in parts], {"c": dtype or T.BIGINT}
    )
    return merged["c"]


def page_nbytes(page: Page) -> int:
    """Bytes a staged page's tensors hold (data, validity, offsets,
    children)."""
    return sum(
        int(t.nbytes) for b in page.blocks for t in block_tensors(b)
    )


@dataclasses.dataclass
class HostPage:
    """A staged page's host copy (CPU tensors, dictionaries and names
    kept) and the device it was staged on."""

    page: Page
    device: torch.device


def _page_tensors(page: Page) -> List[torch.Tensor]:
    out = [page.num_valid]
    for blk in page.blocks:
        out.extend(block_tensors(blk))
    if page.live is not None:
        out.append(page.live)
    return out


def _rebuild(page: Page, tensors: List[torch.Tensor]) -> Page:
    it = iter(tensors)
    num_valid = next(it)
    blocks = [rebuild_block(blk, it) for blk in page.blocks]
    live = None if page.live is None else next(it)
    return Page(
        blocks=tuple(blocks), num_valid=num_valid, names=page.names,
        live=live,
    )


def page_to_host(page: Page) -> HostPage:
    """Copy a staged page to host RAM (the spill write of the split
    cache's host-spill lane) in ONE transfer (``page.to_host``):
    ``capacity``, ``num_valid``, the ``live`` mask, the validity masks
    and the dictionaries all come along."""
    if DEVICE.enabled:
        DEVICE.count_d2h(page_nbytes(page))
    return HostPage(
        page=_rebuild(page, to_host(_page_tensors(page))),
        device=page.device,
    )


def host_to_page(host: HostPage) -> Page:
    """Restage a spilled host copy onto the device it came from: the
    tensors' bytes are packed into one host buffer, copied once and cut
    apart on the device (widest element type first, so every piece
    starts aligned for its type)."""
    tensors = _page_tensors(host.page)
    order = sorted(
        range(len(tensors)), key=lambda i: -tensors[i].element_size()
    )
    flat = [_bytes_of(tensors[i]) for i in order]
    buf = torch.cat(flat).to(host.device)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    offset = 0
    for i, piece in zip(order, flat):
        t = tensors[i]
        out[i] = (
            buf[offset: offset + piece.numel()].view(t.dtype).reshape(t.shape)
        )
        offset += piece.numel()
    if DEVICE.enabled:
        DEVICE.count_h2d(int(buf.nbytes))
    return _rebuild(host.page, out)


class SplitCache:
    """Device-resident staged-``Page`` cache with an LRU byte budget
    (reference: ``presto_tpu/exec/staging.py::SplitCache``, the same
    keys, accounting and eviction order).

    Entries are staged pages keyed by ``(table handle, columns, lo, hi,
    capacity, ...)`` for a split batch, or ``(handle, columns,
    constraint, ..., "table")`` for a whole table; a hit skips both the
    connector read and the host-to-device copy.

    Budget discipline: entries charge the byte budget (LRU eviction at
    the boundary) AND reserve against the :class:`MemoryPool` under the
    shared ``table-cache`` owner, through ``try_reserve``: a cache fill
    never kills a running query to make room, and a full pool just
    means the page is not cached. ``reserve_required=True`` (whole-table
    loads) uses the raising ``reserve`` instead, so a table that cannot
    fit fails the query.

    Pins: an entry serving an executing query is pinned until
    :meth:`unpin`; eviction skips pinned entries (their pages are live
    on the device), a write invalidation still drops them.

    Host-spill lane: with a non-zero ``spill_bytes`` budget, an evicted
    entry (LRU budget pressure, or a running query's pool-pressure
    reclaim through :meth:`evict_bytes`) moves its page to a host-RAM
    spill store (``page_to_host``) instead of being dropped: its device
    bytes and reservation are released at once, and a later ``get``
    restages the host copy (``host_to_page``) and re-admits it under the
    normal budget and pool discipline. Restages are counted
    (``restages``, and the ``on_restage`` hook the runner points at the
    query's ``spilled_bytes``).

    Metrics (``utils.metrics.REGISTRY``): ``staging.cache_hit`` /
    ``staging.cache_miss`` / ``staging.cache_evict``, the
    ``staging.cache_bytes`` occupancy distribution, and ``spill.*``.
    """

    #: pool owner shared by every cached page
    OWNER = "table-cache"

    def __init__(self, budget_bytes: int = DEFAULT_CACHE_BYTES,
                 pool=None, spill_bytes: int = 0):
        self.budget = int(budget_bytes)
        self.pool = pool
        self._lock = threading.RLock()
        self._entries: "collections.OrderedDict" = collections.OrderedDict()
        #: key -> pin count
        self._pins: Dict = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        #: host-RAM spill store: key -> (HostPage, nbytes); a 0 budget
        #: turns the lane off and eviction drops pages
        self.spill_budget = int(spill_bytes)
        self._spill: "collections.OrderedDict" = collections.OrderedDict()
        self._spill_bytes = 0
        #: bumped by invalidate()/clear(): a restage that started before
        #: a write must not re-admit (or re-spill) its pre-write copy
        #: after the invalidation; the copies run outside the lock
        self._epoch = 0
        self.spills = 0
        self.restages = 0
        #: optional ``(nbytes) -> None`` hook attributing restage
        #: traffic to the active query
        self.on_restage = None
        if pool is not None and hasattr(pool, "add_pressure_hook"):
            # yield cached bytes to running queries on pool pressure:
            # a query's raising reserve evicts LRU cache entries before
            # the kill-largest policy fires
            pool.add_pressure_hook(self.evict_bytes)

    def set_spill_budget(self, nbytes: int) -> None:
        """(Re)size the host-spill budget."""
        with self._lock:
            self.spill_budget = int(nbytes)
            while self._spill_bytes > self.spill_budget:
                if not self._drop_one_spilled():
                    break

    # ------------------------------------------------------------ access

    def get(self, key, pin: bool = False) -> Optional[Page]:
        """Cached page for ``key`` (refreshes LRU order), or None.
        Counts hit/miss: call once per staging decision. ``pin=True``
        marks the entry in use until :meth:`unpin`."""
        from presto_tpu_torch.utils.metrics import REGISTRY

        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                if pin:
                    self._pins[key] = self._pins.get(key, 0) + 1
                self.hits += 1
                REGISTRY.counter("staging.cache_hit").update()
                return entry[0]
            # leave the spill store BEFORE re-admission: put() may
            # evict (and re-spill) other entries to make room, and that
            # must not pop THIS key from under the accounting below
            got = self._spill.pop(key, None)
            if got is not None:
                self._spill_bytes -= got[1]
                epoch = self._epoch
            else:
                self.misses += 1
                REGISTRY.counter("staging.cache_miss").update()
                return None
        page = self._restage_spilled(key, got, pin, epoch)
        if page is not None:
            # the host copy saved the connector read: a (slower) hit
            with self._lock:
                self.hits += 1
            REGISTRY.counter("staging.cache_hit").update()
            return page
        with self._lock:
            self.misses += 1
        REGISTRY.counter("staging.cache_miss").update()
        return None

    def _restage_spilled(self, key, got, pin: bool,
                         epoch: int) -> Optional[Page]:
        """Restage a popped spill entry and re-admit it under the budget
        and pool. Runs with no cache lock held (the copy is a whole
        page). Returns None when re-admission does not fit (the host
        copy goes back to the spill store and the caller stages afresh)
        or when a write invalidated the table meanwhile (``epoch``).
        A copy that fails raises."""
        from presto_tpu_torch.utils.metrics import REGISTRY

        host, nbytes = got
        page = host_to_page(host)
        if not self.put(key, page, nbytes, pin=pin, expect_epoch=epoch):
            with self._lock:
                if self._epoch != epoch:
                    return None
                # no device room: the host copy stays spilled, as the
                # newest entry (pop-subtract any copy that landed under
                # this key while the lock was dropped)
                prev = self._spill.pop(key, None)
                if prev is not None:
                    self._spill_bytes -= prev[1]
                self._spill[key] = (host, nbytes)
                self._spill_bytes += nbytes
                while self._spill_bytes > self.spill_budget:
                    if not self._drop_one_spilled():
                        break
            return None
        with self._lock:
            self.restages += 1
            spill_now = self._spill_bytes
        REGISTRY.counter("spill.pages_restaged").update()
        REGISTRY.counter("spill.bytes_restaged").update(nbytes)
        REGISTRY.distribution("spill.pool_bytes").add(spill_now)
        if self.on_restage is not None:
            try:
                self.on_restage(nbytes)
            except Exception:
                pass  # attribution must never fail the staging path
        return page

    def _spill_insert(self, key, host, nbytes: int) -> bool:
        """Admit an already-copied host page into the spill store,
        trimming older entries under the budget (caller holds the
        lock)."""
        from presto_tpu_torch.utils.metrics import REGISTRY

        while self._spill_bytes + nbytes > self.spill_budget:
            if not self._drop_one_spilled():
                return False
        old = self._spill.pop(key, None)
        if old is not None:
            self._spill_bytes -= old[1]
        self._spill[key] = (host, nbytes)
        self._spill_bytes += nbytes
        self.spills += 1
        REGISTRY.counter("spill.pages_spilled").update()
        REGISTRY.counter("spill.bytes_spilled").update(nbytes)
        REGISTRY.distribution("spill.pool_bytes").add(self._spill_bytes)
        return True

    def _drop_one_spilled(self) -> bool:
        """Drop the oldest spilled entry (caller holds the lock)."""
        from presto_tpu_torch.utils.metrics import REGISTRY

        if not self._spill:
            return False
        _key, (_host, nbytes) = self._spill.popitem(last=False)
        self._spill_bytes -= nbytes
        REGISTRY.counter("spill.pages_dropped").update()
        return True

    def unpin(self, key) -> None:
        """Drop one pin (no-op for unknown or invalidated keys)."""
        with self._lock:
            n = self._pins.get(key, 0) - 1
            if n > 0:
                self._pins[key] = n
            else:
                self._pins.pop(key, None)

    def put(self, key, page: Page, nbytes: Optional[int] = None,
            reserve_required: bool = False, pin: bool = False,
            expect_epoch: Optional[int] = None) -> bool:
        """Insert a staged page, evicting unpinned LRU entries past the
        budget. Returns True when the page is now cache-owned (its bytes
        reserved under :attr:`OWNER`), False when it did not fit (the
        page still serves the caller). ``pin=True`` marks the new entry
        in use until :meth:`unpin`. ``expect_epoch`` (the restage path)
        refuses the insert when an invalidation landed since the caller
        read the epoch."""
        from presto_tpu_torch.utils.metrics import REGISTRY

        nbytes = page_nbytes(page) if nbytes is None else int(nbytes)
        with self._lock:
            if nbytes > self.budget:
                return False
            if self._pins.get(key):
                # a duplicate staging of an entry that is executing:
                # replacing it would release its accounting mid-flight
                return False
        # reserve OUTSIDE the cache lock and BEFORE the budget eviction:
        # a raising reserve can run pressure hooks (this cache's own
        # evict_bytes among them), and a failed reservation must not
        # have emptied the cache for nothing
        if self.pool is not None:
            if reserve_required:
                self.pool.reserve(self.OWNER, nbytes)
            elif not self.pool.try_reserve(self.OWNER, nbytes):
                return False
        dropped: list = []
        epoch = -1
        try:
            with self._lock:
                epoch = self._epoch
                if (
                    expect_epoch is not None
                    and self._epoch != expect_epoch
                ):
                    if self.pool is not None:
                        self.pool.release(self.OWNER, nbytes)
                    return False
                if self._pins.get(key):
                    if self.pool is not None:
                        self.pool.release(self.OWNER, nbytes)
                    return False
                old = self._entries.pop(key, None)
                if old is not None:
                    self._release(old[1])
                while self._bytes + nbytes > self.budget:
                    if not self._evict_one_unpinned(dropped):
                        # every resident entry is pinned: undo the
                        # reservation and don't cache
                        if self.pool is not None:
                            self.pool.release(self.OWNER, nbytes)
                        return False
                self._entries[key] = (page, nbytes)
                if pin:
                    self._pins[key] = self._pins.get(key, 0) + 1
                self._bytes += nbytes
                REGISTRY.distribution("staging.cache_bytes").add(
                    self._bytes
                )
                return True
        finally:
            # evicted pages go to the spill store with no lock held, on
            # success and on the all-pinned failure path alike
            self._spill_dropped(dropped, epoch)

    # -------------------------------------------------------- maintenance

    def _release(self, nbytes: int) -> None:
        self._bytes -= nbytes
        if self.pool is not None:
            self.pool.release(self.OWNER, nbytes)

    def _evict_one_unpinned(self, dropped: list) -> bool:
        """Evict the least recently used UNPINNED entry (caller holds
        the lock), appending it to ``dropped`` for
        :meth:`_spill_dropped`. False when none is evictable."""
        from presto_tpu_torch.utils.metrics import REGISTRY

        key = next(
            (k for k in self._entries if not self._pins.get(k)), None
        )
        if key is None:
            return False
        page, nbytes = self._entries.pop(key)
        dropped.append((key, page, nbytes))
        self._release(nbytes)
        self.evictions += 1
        REGISTRY.counter("staging.cache_evict").update()
        return True

    def _spill_dropped(self, dropped: list, epoch: int) -> None:
        """Move evicted pages to the host spill store, with no cache
        lock held. Lane off, or a page larger than the spill budget:
        plain drop. ``epoch`` was read while the caller popped these
        entries: a write that invalidates mid-copy keeps its table's
        pre-write pages out of the spill store."""
        for key, page, nbytes in dropped:
            if self.spill_budget <= 0 or nbytes > self.spill_budget:
                continue
            host = page_to_host(page)
            with self._lock:
                if self._epoch != epoch:
                    return
                self._spill_insert(key, host, nbytes)

    def evict_bytes(self, needed: int) -> int:
        """Evict unpinned LRU entries until at least ``needed`` bytes
        are freed, or none remain evictable: the MemoryPool pressure
        hook (cached pages are droppable, so a running query's
        reservation reclaims them before any query is killed). Returns
        the bytes freed."""
        from presto_tpu_torch.utils.metrics import REGISTRY

        freed = 0
        evicted = 0
        dropped = []
        with self._lock:
            epoch = self._epoch
            while freed < needed:
                key = next(
                    (k for k in self._entries if not self._pins.get(k)),
                    None,
                )
                if key is None:
                    break
                page, nbytes = self._entries.pop(key)
                dropped.append((key, page, nbytes))
                self._release(nbytes)
                freed += nbytes
                evicted += 1
            self.evictions += evicted
        self._spill_dropped(dropped, epoch)
        if evicted:
            REGISTRY.counter("staging.cache_evict").update(evicted)
            REGISTRY.distribution("staging.cache_bytes").add(
                self._bytes
            )
        return freed

    def invalidate(self, handle) -> int:
        """Drop every entry of a written or dropped table (keys lead
        with the table handle, matched version-blind by ``table_key``),
        releasing their reservations. Returns the entries dropped."""
        tk = handle.table_key

        def _stale(k) -> bool:
            return getattr(k[0], "table_key", k[0]) == tk

        with self._lock:
            self._epoch += 1
            stale = [k for k in self._entries if _stale(k)]
            for k in stale:
                _page, nbytes = self._entries.pop(k)
                self._release(nbytes)
                self._pins.pop(k, None)
            for k in [k for k in self._spill if _stale(k)]:
                _host, nbytes = self._spill.pop(k)
                self._spill_bytes -= nbytes
            return len(stale)

    def clear(self) -> None:
        with self._lock:
            for _page, nbytes in self._entries.values():
                self._release(nbytes)
            self._entries.clear()
            self._pins.clear()
            self._spill.clear()
            self._spill_bytes = 0
            self._epoch += 1

    # ------------------------------------------------------------- stats

    def used_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def spill_used_bytes(self) -> int:
        """Host-RAM bytes the spill store holds."""
        with self._lock:
            return self._spill_bytes

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "budget_bytes": self.budget,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "spill_entries": len(self._spill),
                "spill_bytes": self._spill_bytes,
                "spill_budget_bytes": self.spill_budget,
                "spills": self.spills,
                "restages": self.restages,
            }


def prefetch_iter(items, load_fn, depth: int, on_drop=None):
    """Yield ``load_fn(item)`` for each item IN ORDER, loading up to
    ``depth`` items ahead on one background host thread, so the host
    generates and stages split N+1 while the device runs split N.

    ``depth <= 0`` is the serial loop (load, run, load, run), the same
    ``load_fn`` calls in the same order, so results are bit-identical.
    The bounded queue keeps at most ``depth`` loaded items waiting. An
    error of ``load_fn`` is re-raised at the iteration that would have
    hit it serially.

    Closing the generator (loop exit or ``.close()``) stops the
    producer, joins it, and passes every loaded but unconsumed item to
    ``on_drop``: no ``load_fn`` call outlives the iteration.

    On a CUDA device, ``load_fn``'s copies run on the legacy default
    stream from the producer thread, the stream the consumer's kernels
    run on: they stay in stream order with the consumer's work, so a
    page is never read before its copy lands. The overlap this buys is
    the host's (generating the next split); the copies themselves do not
    overlap the consumer's kernels."""
    items = list(items)
    if depth <= 0 or len(items) <= 1:
        for it in items:
            yield load_fn(it)
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def put(entry) -> bool:
        """A bounded put that gives up once the consumer has gone."""
        while not stop.is_set():
            try:
                q.put(entry, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        for it in items:
            if stop.is_set():
                return
            try:
                entry = (load_fn(it), None)
            except BaseException as e:  # re-raised by the consumer
                put((None, e))
                return
            if not put(entry):
                if on_drop is not None:
                    on_drop(entry[0])
                return
        put((end, None))

    t = threading.Thread(target=producer, name="staging-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item, err = q.get()
            if err is not None:
                raise err
            if item is end:
                return
            yield item
    finally:
        stop.set()
        t.join()
        while True:
            try:
                item, err = q.get_nowait()
            except queue.Empty:
                break
            if err is None and item is not end and on_drop is not None:
                on_drop(item)


class CatalogManager:
    """Mounted catalogs (catalog name -> connector)."""

    def __init__(self):
        self._catalogs: Dict[str, object] = {}

    def register(self, name: str, connector) -> None:
        self._catalogs[name] = connector

    def get(self, name: str):
        if name not in self._catalogs:
            raise KeyError(f"catalog not found: {name}")
        return self._catalogs[name]

    def has(self, name: str) -> bool:
        return name in self._catalogs

    def names(self):
        return sorted(self._catalogs)

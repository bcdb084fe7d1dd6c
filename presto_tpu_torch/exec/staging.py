"""Host -> device page staging.

The PyTorch counterpart of ``presto_tpu/exec/staging.py``. SPI column
payloads (see ``connectors.spi.Connector.create_page_source``):

- numeric numpy array in *native repr* (unscaled ints for decimals,
  epoch days for dates) -> one host-to-device copy
- ``MaskedColumn`` (native data + validity) -> copy with a null mask
- ``DictColumn`` (pre-encoded ids + sorted dictionary) -> ids copied,
  dictionary kept host-side
- object numpy array of Python values (None = NULL) -> logical ingest

Capacities round up to power-of-two buckets (min 1024), so every table
of similar size presents the same shapes to the operators.

Split-streamed execution (``exec/streaming.py``) also uses
``merge_column_chunks``, ``page_nbytes`` and ``prefetch_iter`` from
here. The reference's device-resident ``SplitCache`` is not ported yet.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import DictColumn
from presto_tpu_torch.page import Block, Dictionary, Page, resolve_device

MIN_BUCKET = 1 << 10


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
        if t.is_nested:
            raise NotImplementedError(
                f"staging {t} columns: later slice of the port"
            )
        if isinstance(v, MaskedColumn):
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
            vals = list(v) + [None] * (cap - len(v))
            blocks.append(Block.from_pylist(vals, t, device))
    return Page(
        blocks=tuple(blocks),
        num_valid=torch.tensor(n, dtype=torch.int32, device=device),
        names=names,
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
    """Bytes a staged page's data and validity tensors hold."""
    return sum(
        int(b.data.nbytes) + (0 if b.valid is None else int(b.valid.nbytes))
        for b in page.blocks
    )


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

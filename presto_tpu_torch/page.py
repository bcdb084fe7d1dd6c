"""Columnar Block/Page data model on torch tensors.

The PyTorch counterpart of ``presto_tpu/page.py``, with the same
static-shape protocol:

- A ``Block`` is one column: a fixed-shape ``data`` tensor plus an
  optional bool ``valid`` null mask (``None`` = known null-free).
  Strings are int32 ids into an order-preserving host ``Dictionary``;
  decimals are scaled int64; dates are int32 epoch days.
- A ``Page`` carries ``num_valid`` as a 0-d int32 tensor on the page's
  device. In prefix form (``live is None``) the first ``num_valid`` rows
  are live; in masked form ``live`` is a bool (capacity,) selection
  mask and ``num_valid`` is the live count.
- Capacity (the tensor length) is a power-of-two bucket chosen at
  staging, so the shapes an operator sees repeat across queries.

Every tensor constructor names its dtype and device. Array, map and row
blocks (offsets / children) are not ported yet.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from presto_tpu_torch import types as T


class Dictionary:
    """Host-side, order-preserving string dictionary.

    Ids are assigned in sorted order of the distinct values, so integer
    comparison of ids agrees with lexicographic comparison of the strings
    they encode (within a single dictionary). Immutable and hashable
    (content digest)."""

    __slots__ = ("values", "_str_values", "_index", "_digest", "__weakref__")

    def __init__(self, sorted_values: np.ndarray):
        self.values = np.asarray(sorted_values)
        self._str_values = self.values.astype(str)
        self._index: Optional[dict] = None
        h = hashlib.blake2b(digest_size=16)
        h.update(str(len(self.values)).encode())
        for v in self._str_values:
            h.update(v.encode())
            h.update(b"\x00")
        self._digest = h.digest()

    @classmethod
    def build(cls, values: Sequence[str]) -> "Dictionary":
        return cls(np.unique(np.asarray(values, dtype=object)))

    def __len__(self) -> int:
        return len(self.values)

    def __hash__(self):
        return hash(self._digest)

    def __eq__(self, other):
        return isinstance(other, Dictionary) and self._digest == other._digest

    def id_of(self, value: str) -> int:
        """Exact id of value, or -1 if absent."""
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.values)}
        return self._index.get(value, -1)

    def searchsorted(self, value: str, side: str = "left") -> int:
        """Insertion point of value — supports range predicates on absent
        literals (e.g. ``c < 'm'`` where 'm' is not in the dictionary)."""
        return int(np.searchsorted(self._str_values, value, side=side))

    def decode(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids)
        if len(self.values) == 0:  # all-NULL column
            return np.full(ids.shape, None, dtype=object)
        out = self.values[np.clip(ids, 0, len(self.values) - 1)]
        return np.where(ids < 0, None, out)

    def predicate_lut(self, fn) -> np.ndarray:
        """Evaluate a host predicate over every dictionary entry -> bool
        LUT (the device gathers LUT[id])."""
        return np.asarray([bool(fn(v)) for v in self.values], dtype=bool)


def encode_strings(values: Sequence) -> tuple:
    """Encode strings -> (int32 ids, valid mask, order-preserving dict).
    None values get id -1 and valid=False."""
    arr = np.asarray(values, dtype=object)
    isnull = np.array([v is None for v in arr], dtype=bool)
    present = arr[~isnull].astype(str) if (~isnull).any() else np.array([], str)
    dictionary = Dictionary(np.unique(present))
    ids = np.full(len(arr), -1, dtype=np.int32)
    if len(present):
        ids[~isnull] = np.searchsorted(
            dictionary._str_values, present
        ).astype(np.int32)
    return ids, ~isnull, dictionary


def resolve_device(device=None) -> torch.device:
    """The device a builder or runner puts its tensors on: ``None`` means
    the CUDA device, and a CUDA device without CUDA raises (the port
    never drops to the CPU on its own; pass ``"cpu"`` for that)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU"
        )
    return dev


def _nested_unsupported(dtype: T.DataType):
    return NotImplementedError(
        f"{dtype} blocks (array/map/row): later slice of the port"
    )


@dataclasses.dataclass
class Block:
    """One column: fixed-width tensor + optional bool null mask."""

    data: torch.Tensor
    valid: Optional[torch.Tensor]  # bool, True = non-null; None = all valid
    dtype: T.DataType
    dictionary: Optional[Dictionary] = None

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @classmethod
    def from_numpy(
        cls,
        values: np.ndarray,
        dtype: T.DataType,
        valid: Optional[np.ndarray] = None,
        dictionary: Optional[Dictionary] = None,
        device=None,
    ) -> "Block":
        device = resolve_device(device)
        arr = np.ascontiguousarray(np.asarray(values).astype(dtype.np_dtype))
        data = torch.from_numpy(arr).to(device)
        v = (
            None
            if valid is None
            else torch.from_numpy(
                np.ascontiguousarray(np.asarray(valid, dtype=bool))
            ).to(device)
        )
        return cls(data=data, valid=v, dtype=dtype, dictionary=dictionary)

    @classmethod
    def from_pylist(
        cls,
        values: Sequence,
        dtype: T.DataType,
        device=None,
    ) -> "Block":
        """Build from Python values (None = NULL): dictionary encoding
        for varchar, exact half-up scaling for decimals. ``device=None``
        means CUDA (``resolve_device``)."""
        if dtype.is_nested:
            raise _nested_unsupported(dtype)
        if dtype.is_string:
            ids, valid, dictionary = encode_strings(values)
            v = None if valid.all() else valid
            return cls.from_numpy(ids, dtype, v, dictionary, device)
        isnull = np.array([v is None for v in values], dtype=bool)
        if dtype.is_decimal:
            # SQL half-up rounding, exact via decimal.Decimal
            import decimal as _dec

            q = _dec.Decimal(1).scaleb(-dtype.scale)
            with _dec.localcontext() as ctx:
                ctx.prec = 50
                filled = [
                    0
                    if v is None
                    else int(
                        _dec.Decimal(str(v)).quantize(
                            q, rounding=_dec.ROUND_HALF_UP
                        ).scaleb(dtype.scale)
                    )
                    for v in values
                ]
            if dtype.is_long_decimal:
                arr = T.int128_limbs(filled)  # (n, 2) limb pairs
            else:
                arr = np.asarray(filled, dtype=np.int64)
        else:
            filled = [0 if v is None else v for v in values]
            arr = np.asarray(filled).astype(dtype.np_dtype)
        v = None if not isnull.any() else ~isnull
        return cls.from_numpy(arr, dtype, v, None, device)

    def to_numpy(self, n: Optional[int] = None):
        """First n rows host-side as a (values, valid) numpy pair; ids
        and decimal scaling are not decoded."""
        data = self.data[:n] if n is not None else self.data
        data = data.cpu().numpy()
        if self.valid is None:
            valid = np.ones(len(data), dtype=bool)
        else:
            v = self.valid[:n] if n is not None else self.valid
            valid = v.cpu().numpy()
        return data, valid


@dataclasses.dataclass
class Page:
    """An ordered set of equal-capacity Blocks + live-row count.

    ``num_valid`` is a 0-d int32 tensor on the page's device (never a
    Python int: reading it would synchronise with the device)."""

    blocks: tuple
    num_valid: torch.Tensor
    names: tuple
    live: Optional[torch.Tensor] = None  # bool (capacity,): masked form

    @property
    def capacity(self) -> int:
        return self.blocks[0].capacity if self.blocks else 0

    @property
    def device(self) -> torch.device:
        return self.num_valid.device

    @property
    def num_columns(self) -> int:
        return len(self.blocks)

    def block(self, name: str) -> Block:
        return self.blocks[self.names.index(name)]

    def __contains__(self, name: str) -> bool:
        return name in self.names

    def row_mask(self) -> torch.Tensor:
        """Boolean mask over capacity: True for live rows."""
        if self.live is not None:
            return self.live
        return (
            torch.arange(self.capacity, dtype=torch.int32, device=self.device)
            < self.num_valid
        )

    def prefix_leaves(self, k: int) -> list:
        """Flat [data[:k], valid[:k]?, ...] tensor list: the one shape
        every materialization path fetches to the host."""
        leaves = []
        for blk in self.blocks:
            leaves.append(blk.data[:k])
            if blk.valid is not None:
                leaves.append(blk.valid[:k])
        return leaves

    @classmethod
    def from_pydict(
        cls,
        data: Dict[str, Sequence],
        schema: Dict[str, T.DataType],
        capacity: Optional[int] = None,
        device=None,
    ) -> "Page":
        """Test/ingest helper: build a page from {name: python values},
        padding every column to ``capacity`` (default: exact length).
        ``device=None`` means CUDA (``resolve_device``)."""
        device = resolve_device(device)
        names = tuple(schema.keys())
        n = len(next(iter(data.values()))) if data else 0
        cap = capacity if capacity is not None else max(n, 1)
        n = min(n, cap)
        blocks = []
        for name in names:
            vals = list(data[name])
            vals = vals + [None] * (cap - n) if cap > n else vals[:cap]
            b = Block.from_pylist(vals, schema[name], device)
            if b.valid is not None and bool(b.valid[:n].all()):
                b = dataclasses.replace(b, valid=None)
            blocks.append(b)
        return cls(
            blocks=tuple(blocks),
            num_valid=torch.tensor(n, dtype=torch.int32, device=device),
            names=names,
        )

    def to_pylist(self) -> List[dict]:
        """Decode live rows to a list of {name: python value} dicts."""
        if self.live is not None:
            idx = np.nonzero(self.live.cpu().numpy())[0]
        else:
            idx = np.arange(int(self.num_valid))
        n = len(idx)
        out_cols = {}
        for name, blk in zip(self.names, self.blocks):
            data, valid = blk.to_numpy(None)
            data, valid = data[idx], valid[idx]
            out_cols[name] = [
                _decode_value(data[i], blk.dtype, blk.dictionary)
                if valid[i]
                else None
                for i in range(n)
            ]
        return [
            {name: out_cols[name][i] for name in self.names} for i in range(n)
        ]

    def schema(self) -> Dict[str, T.DataType]:
        return {n: b.dtype for n, b in zip(self.names, self.blocks)}


def _decode_value(v, t: T.DataType, dictionary: Optional[Dictionary]):
    """One stored value -> python value."""
    import datetime

    if t.is_string:
        return str(dictionary.values[int(v)])
    if t.is_long_decimal:
        import decimal as _dec

        unscaled = T.int128_value(int(v[0]), int(v[1]))
        with _dec.localcontext() as ctx:
            ctx.prec = 50
            return _dec.Decimal(unscaled).scaleb(-t.scale)
    if t.is_decimal:
        return int(v) / (10 ** t.scale)
    if t.name == "date":
        return datetime.date(1970, 1, 1) + datetime.timedelta(days=int(v))
    if t.name == "boolean":
        return bool(v)
    if t.is_integer or t.name == "timestamp":
        return int(v)
    return float(v)


def nonzero_static(
    mask: torch.Tensor, size: int, fill_value: int = 0
) -> torch.Tensor:
    """Positions of the True entries of ``mask``, ascending, padded with
    ``fill_value`` (or cut) to exactly ``size`` entries: the counterpart
    of ``jnp.nonzero(mask, size=, fill_value=)``.

    One cumsum and one scatter, so the host never waits on the device
    (a size-less ``torch.nonzero`` would). True entry k lands in slot k;
    entries past ``size`` and False entries go to a spill slot that is
    cut off."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), dim=0) - 1
    slot = torch.where(mask & (rank < size), rank, size)
    out = torch.full(
        (size + 1,), fill_value, dtype=torch.int64, device=mask.device
    )
    out.scatter_(
        0, slot, torch.arange(n, dtype=torch.int64, device=mask.device)
    )
    return out[:size]


def to_host(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Copy tensors of one device to the host in ONE transfer (the
    counterpart of ``jax.device_get`` of a list): their bytes are packed
    into one device buffer, copied once and cut apart on the host.
    Wider element types go first, so every piece starts aligned for its
    type."""
    tensors = list(tensors)
    if not tensors:
        return []
    order = sorted(
        range(len(tensors)), key=lambda i: -tensors[i].element_size()
    )
    flat = [_bytes_of(tensors[i]) for i in order]
    host = torch.cat(flat).cpu()
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    offset = 0
    for i, piece in zip(order, flat):
        t = tensors[i]
        out[i] = (
            host[offset: offset + piece.numel()].view(t.dtype).reshape(t.shape)
        )
        offset += piece.numel()
    return out


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    if t.numel() == 0:  # an empty view may carry a zero stride
        return torch.empty((0,), dtype=torch.uint8, device=t.device)
    return t.contiguous().reshape(-1).view(torch.uint8)


def _gather_block(blk: Block, sel: torch.Tensor) -> Block:
    if blk.dtype.is_nested:
        raise _nested_unsupported(blk.dtype)
    return dataclasses.replace(
        blk,
        data=blk.data[sel],
        valid=None if blk.valid is None else blk.valid[sel],
    )


def compact_page(page: Page, out_capacity: Optional[int] = None) -> Page:
    """Masked form -> prefix form: gather live rows to the front.
    Identity for prefix-form pages (re-bucketed when ``out_capacity``
    differs)."""
    if page.live is None:
        if out_capacity is not None and out_capacity != page.capacity:
            return pad_capacity(page, out_capacity)
        return page
    cap = out_capacity if out_capacity is not None else page.capacity
    sel = nonzero_static(page.live, cap, fill_value=0)
    return Page(
        blocks=tuple(_gather_block(blk, sel) for blk in page.blocks),
        num_valid=torch.clamp(page.num_valid, max=cap).to(torch.int32),
        names=page.names,
    )


def pad_capacity(page: Page, capacity: int) -> Page:
    """Re-bucket a prefix-form page to a new (>= live rows) capacity:
    zero-pad or slice the row axis. Masked pages go through
    compact_page."""
    if page.live is not None:
        return compact_page(page, capacity)
    blocks = []
    for blk in page.blocks:
        if blk.dtype.is_nested:
            raise _nested_unsupported(blk.dtype)
        cap = blk.capacity
        if capacity == cap:
            blocks.append(blk)
        elif capacity > cap:
            # row-axis pad only (long decimals are (cap, 2) limb pairs)
            pad = torch.zeros(
                (capacity - cap,) + tuple(blk.data.shape[1:]),
                dtype=blk.data.dtype,
                device=blk.data.device,
            )
            valid = None
            if blk.valid is not None:
                valid = torch.cat([
                    blk.valid,
                    torch.zeros(
                        capacity - cap, dtype=torch.bool,
                        device=blk.valid.device,
                    ),
                ])
            blocks.append(
                dataclasses.replace(
                    blk, data=torch.cat([blk.data, pad]), valid=valid
                )
            )
        else:
            blocks.append(
                dataclasses.replace(
                    blk,
                    data=blk.data[:capacity],
                    valid=None if blk.valid is None else blk.valid[:capacity],
                )
            )
    return Page(
        blocks=tuple(blocks),
        num_valid=torch.clamp(page.num_valid, max=capacity).to(torch.int32),
        names=page.names,
    )

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

Nested columns, one level deep, as in the reference:

- An array block's ``data`` is the flat VALUES tensor, with a value
  capacity of its own (a power-of-two bucket), and ``offsets`` is an
  int32 (capacity + 1,) tensor: row i holds ``data[offsets[i]:
  offsets[i+1]]``. ``valid`` stays per row; padding rows are empty
  (offsets edge-pad).
- A map block shares the offsets between two flat child blocks
  ``children = (keys, values)``; a row block has one child per field at
  row capacity and no offsets. Both keep a zero-width ``data``
  placeholder, so ``data.shape[0]`` is the row capacity.

Every tensor constructor names its dtype and device.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from presto_tpu_torch import native
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


#: columns of this many rows or more go through the C++ codec
NATIVE_ENCODE_MIN_ROWS = 4096


def encode_strings(values: Sequence) -> tuple:
    """Encode strings -> (int32 ids, valid mask, order-preserving dict).
    None values get id -1 and valid=False. Columns of
    ``NATIVE_ENCODE_MIN_ROWS`` rows or more go through the C++ codec
    (``native.encode_strings``, the same output) where it builds."""
    arr = np.asarray(values, dtype=object)
    if len(arr) >= NATIVE_ENCODE_MIN_ROWS:
        out = native.encode_strings(arr)
        if out is not None:
            ids, valid, uniq = out
            return ids, valid, Dictionary(uniq)
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


def _pad_flat_child(child: "Block", vcap: int) -> "Block":
    """Pad a flat child block (map keys or values) to the bucketed value
    capacity."""
    n = child.data.shape[0]
    if n >= vcap:
        return child
    return dataclasses.replace(
        child,
        data=_pad_rows(child.data, vcap - n),
        valid=None if child.valid is None else _pad_rows(child.valid, vcap - n),
    )


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` with ``n`` zero rows appended (trailing dims kept: long
    decimals are (rows, 2) limb pairs)."""
    return torch.cat([
        t,
        torch.zeros((n,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device),
    ])


def _edge_pad(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """Offsets with ``n`` more rows that read as empty."""
    return torch.cat([offsets, offsets[-1:].expand(n)])


@dataclasses.dataclass
class Block:
    """One column: fixed-width tensor + optional bool null mask; array
    and map blocks add ``offsets``, map and row blocks ``children`` (see
    the module docstring)."""

    data: torch.Tensor
    valid: Optional[torch.Tensor]  # bool, True = non-null; None = all valid
    dtype: T.DataType
    dictionary: Optional[Dictionary] = None
    offsets: Optional[torch.Tensor] = None  # int32 (capacity + 1,)
    children: Optional[tuple] = None  # map: (keys, values); row: fields

    @property
    def capacity(self) -> int:
        if self.offsets is not None:
            return self.offsets.shape[0] - 1
        return self.data.shape[0]

    @staticmethod
    def placeholder_data(cap: int, device) -> torch.Tensor:
        """Zero-byte per-row stand-in for blocks whose payload lives in
        ``children`` (map/row): ``data.shape[0] == capacity`` with no
        device memory."""
        return torch.zeros((cap, 0), dtype=torch.int8, device=device)

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
        for varchar, exact half-up scaling for decimals, offsets and
        flat children for arrays and maps (elements recurse through this
        builder), one child per field for rows. ``device=None`` means
        CUDA (``resolve_device``)."""
        device = resolve_device(device)
        if dtype.is_array or dtype.is_map:
            return cls._from_pylist_offsets(values, dtype, device)
        if dtype.is_row:
            # python dicts (by field name) or sequences (positional)
            if any(t.is_nested for _, t in dtype.fields):
                raise NotImplementedError(
                    "nested row field types are not supported "
                    "(one nesting level; documented deviation)"
                )
            children = tuple(
                cls.from_pylist(
                    [
                        None
                        if v is None
                        else (v[fname] if isinstance(v, dict) else v[i])
                        for v in values
                    ],
                    ftype,
                    device,
                )
                for i, (fname, ftype) in enumerate(dtype.fields)
            )
            return cls(
                data=cls.placeholder_data(len(values), device),
                valid=_row_valid(values, device),
                dtype=dtype,
                children=children,
            )
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
        elif dtype.name == "date":
            # epoch days, or datetime.date values as a query result
            # holds them (a written table's rows); the reference takes
            # only the days (ROADMAP §3)
            epoch = _dt.date(1970, 1, 1).toordinal()
            arr = np.asarray(
                [
                    0
                    if v is None
                    else v.toordinal() - epoch
                    if isinstance(v, _dt.date)
                    else v
                    for v in values
                ]
            ).astype(dtype.np_dtype)
        else:
            filled = [0 if v is None else v for v in values]
            arr = np.asarray(filled).astype(dtype.np_dtype)
        v = None if not isnull.any() else ~isnull
        return cls.from_numpy(arr, dtype, v, None, device)

    @classmethod
    def from_pylist_padded(
        cls, values: Sequence, dtype: T.DataType, capacity: int, device=None
    ) -> "Block":
        """``from_pylist`` of ``values`` padded with NULLs (or cut) to
        ``capacity`` rows. A column whose only NULLs are the padding
        carries no mask, as a numpy column does."""
        n = min(len(values), capacity)
        vals = list(values[:n]) + [None] * (capacity - n)
        b = cls.from_pylist(vals, dtype, device)
        if b.valid is not None and bool(b.valid[:n].all()):
            b = dataclasses.replace(b, valid=None)
        return b

    @classmethod
    def _from_pylist_offsets(cls, values, dtype, device) -> "Block":
        """Array (lists) or map (dicts) values -> offsets over flat
        children, the value axis padded to its power-of-two bucket."""
        from presto_tpu_torch.exec.staging import bucket_capacity

        lengths = [0 if v is None else len(v) for v in values]
        offsets = np.zeros(len(values) + 1, np.int32)
        np.cumsum(lengths, out=offsets[1:])
        offsets = torch.from_numpy(offsets).to(device)
        valid = _row_valid(values, device)
        vcap = bucket_capacity(int(sum(lengths)))
        if dtype.is_array:
            flat = [x for v in values if v is not None for x in v]
            if any(x is None for x in flat):
                raise NotImplementedError(
                    "NULL array elements are not supported (documented "
                    "deviation; NULL rows are)"
                )
            child = _pad_flat_child(
                cls.from_pylist(flat, dtype.element, device), vcap
            )
            return cls(
                data=child.data, valid=valid, dtype=dtype,
                dictionary=child.dictionary, offsets=offsets,
            )
        if dtype.key.is_nested or dtype.value.is_nested:
            raise NotImplementedError(
                "nested map key/value types are not supported "
                "(one nesting level; documented deviation)"
            )
        items = [kv for v in values if v is not None for kv in v.items()]
        if any(k is None for k, _ in items):
            raise NotImplementedError("NULL map keys are invalid")
        children = tuple(
            _pad_flat_child(
                cls.from_pylist([kv[i] for kv in items], t, device), vcap
            )
            for i, t in enumerate((dtype.key, dtype.value))
        )
        return cls(
            data=cls.placeholder_data(len(values), device),
            valid=valid, dtype=dtype, offsets=offsets, children=children,
        )

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
        """Flat tensor list of the first ``k`` rows: the one shape every
        materialization path fetches to the host. Per block: a flat
        block's data[:k]; an array block's offsets[:k+1] and its FULL
        values tensor (the live extent depends on the data); a map
        block's offsets[:k+1] and each child's full data (+ valid); a
        row block's children's data[:k] (+ valid[:k]); then the block's
        own valid[:k] when it has one."""
        leaves = []
        for blk in self.blocks:
            if blk.dtype.is_map:
                leaves.append(blk.offsets[: k + 1])
                for ch in blk.children:
                    leaves.append(ch.data)
                    if ch.valid is not None:
                        leaves.append(ch.valid)
            elif blk.dtype.is_row:
                for ch in blk.children:
                    leaves.append(ch.data[:k])
                    if ch.valid is not None:
                        leaves.append(ch.valid[:k])
            elif blk.offsets is not None:
                leaves.append(blk.offsets[: k + 1])
                leaves.append(blk.data)
            else:
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
        blocks = [
            Block.from_pylist_padded(list(data[name]), schema[name], cap, device)
            for name in names
        ]
        return cls(
            blocks=tuple(blocks),
            num_valid=torch.tensor(n, dtype=torch.int32, device=device),
            names=names,
        )

    def to_pylist(self) -> List[dict]:
        """Decode live rows to a list of {name: python value} dicts
        (arrays as lists, maps as dicts, rows as dicts by field name)."""
        if self.live is not None:
            idx = np.nonzero(self.live.cpu().numpy())[0]
        else:
            idx = np.arange(int(self.num_valid))
        out_cols = {
            name: decode_column(blk, idx)
            for name, blk in zip(self.names, self.blocks)
        }
        return [
            {name: out_cols[name][i] for name in self.names}
            for i in range(len(idx))
        ]

    def schema(self) -> Dict[str, T.DataType]:
        return {n: b.dtype for n, b in zip(self.names, self.blocks)}


def _np(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.cpu().numpy()


def decode_column(blk: Block, idx: np.ndarray, exact: bool = False) -> list:
    """Rows ``idx`` of one block as Python values (None = NULL).
    ``exact`` decodes short decimals as ``decimal.Decimal`` (the write
    path's row format) instead of floats."""
    rvalid = _np(blk.valid)
    if blk.dtype.is_row:
        fields = [
            (
                fname,
                _decode_values(
                    ch.data.cpu().numpy()[idx],
                    ftype,
                    ch.dictionary,
                    None if ch.valid is None else _np(ch.valid)[idx],
                    exact,
                ),
            )
            for (fname, ftype), ch in zip(blk.dtype.fields, blk.children)
        ]
        return [
            None
            if rvalid is not None and not rvalid[i]
            else {fname: vals[k] for fname, vals in fields}
            for k, i in enumerate(idx)
        ]
    if blk.offsets is not None:
        rows = idx if rvalid is None else idx[rvalid[idx]]
        off = blk.offsets.cpu().numpy().astype(np.int64)
        lens = off[rows + 1] - off[rows]
        # element positions of the rows kept, row after row
        pos = np.repeat(off[rows] - np.cumsum(lens) + lens, lens) + np.arange(
            int(lens.sum())
        )
        ends = np.cumsum(lens).tolist()
        starts = [0] + ends[:-1]
        if blk.dtype.is_map:
            kc, vc = blk.children
            keys = _decode_values(
                kc.data.cpu().numpy()[pos], blk.dtype.key, kc.dictionary
            )
            vals = _decode_values(
                vc.data.cpu().numpy()[pos],
                blk.dtype.value,
                vc.dictionary,
                None if vc.valid is None else _np(vc.valid)[pos],
            )
            kept = [
                dict(zip(keys[a:b], vals[a:b])) for a, b in zip(starts, ends)
            ]
        else:
            elems = _decode_values(
                blk.data.cpu().numpy()[pos], blk.dtype.element, blk.dictionary,
                exact=exact,
            )
            kept = [elems[a:b] for a, b in zip(starts, ends)]
        if rvalid is None:
            return kept
        out = [None] * len(idx)
        for k, v in zip(np.nonzero(rvalid[idx])[0].tolist(), kept):
            out[k] = v
        return out
    return _decode_values(
        blk.data.cpu().numpy()[idx],
        blk.dtype,
        blk.dictionary,
        None if rvalid is None else rvalid[idx],
        exact,
    )


def _row_valid(values: Sequence, device) -> Optional[torch.Tensor]:
    """Per-row validity of Python values: None when no value is None."""
    isnull = np.array([v is None for v in values], dtype=bool)
    if not isnull.any():
        return None
    return torch.from_numpy(~isnull).to(device)


def _decode_values(
    data: np.ndarray,
    t: T.DataType,
    dictionary: Optional[Dictionary],
    valid: Optional[np.ndarray] = None,
    exact: bool = False,
) -> list:
    """Stored values of one flat type -> Python values, None where
    ``valid`` is False; one numpy conversion per column. Short decimals
    are ``int / 10**scale`` in Python arithmetic (a float: a scaled
    value above 2^53 loses digits, as the reference's rows do), or
    with ``exact`` the ``decimal.Decimal`` of the scaled integer; long
    decimals are always ``decimal.Decimal``."""
    if valid is not None and not valid.all():
        out = [None] * len(data)
        pos = np.nonzero(valid)[0]
        vals = _decode_values(data[pos], t, dictionary, exact=exact)
        for k, v in zip(pos.tolist(), vals):
            out[k] = v
        return out
    if len(data) == 0:
        return []
    if t.is_string:
        return dictionary._str_values[data].tolist()
    if t.is_long_decimal:
        import decimal as _dec

        with _dec.localcontext() as ctx:
            ctx.prec = 50
            return [
                _dec.Decimal(T.int128_value(int(hi), int(lo))).scaleb(-t.scale)
                for hi, lo in data
            ]
    if t.is_decimal:
        if exact:
            import decimal as _dec

            return [_dec.Decimal(v).scaleb(-t.scale) for v in data.tolist()]
        scale = 10 ** t.scale
        return [v / scale for v in data.tolist()]
    if t.name == "date":
        return data.astype("datetime64[D]").tolist()
    if t.name == "boolean":
        return data.astype(bool).tolist()
    if t.is_integer or t.name == "timestamp":
        return data.astype(np.int64).tolist()
    return data.astype(np.float64).tolist()


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
    """The bytes of ``t`` as a flat uint8 tensor of a dense copy.
    ``.contiguous()`` is not enough: torch counts a one-row slice of a
    ``broadcast_to`` block (stride 0) as contiguous and keeps the zero
    stride, which ``.view(torch.uint8)`` refuses."""
    if not t.is_contiguous() or 0 in t.stride():
        t = torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)
    return t.reshape(-1).view(torch.uint8)


def gather_block(
    blk: Block, sel: torch.Tensor, num_live, repeats: Optional[int] = 1
) -> Block:
    """Rows ``sel`` of a block, nested or flat. ``num_live`` (a 0-d
    tensor or int) marks the entries of ``sel`` past it as padding: in
    an array or map block they read as empty rows.

    ``repeats`` bounds how often ``sel`` names one source row, and so
    sizes an array or map block's value axis: 1 (a compaction, a sort)
    keeps its capacity, k > 1 (a static UNNEST) takes the bucket of k
    times it, and ``None`` (a cross join, whose fan-out is data) the
    bucket of the gathered values' own total, read once on the host."""
    if blk.dtype.is_row:
        return _gather_row_block(blk, sel, num_live, repeats)
    if blk.offsets is not None:
        return _gather_array_block(blk, sel, num_live, repeats)
    return dataclasses.replace(
        blk,
        data=blk.data[sel],
        valid=None if blk.valid is None else blk.valid[sel],
    )


def _gather_array_block(
    blk: Block, sel: torch.Tensor, num_live, repeats: Optional[int]
) -> Block:
    """Row-gather an array or map block: new offsets from the selected
    rows' lengths, and the values laid out again by the prefix-sum +
    inverse-searchsorted expansion (value slot j belongs to the row p
    with new_off[p] <= j < new_off[p+1]) over the value capacity that
    ``repeats`` sets (``gather_block``). A map block applies the same
    value-axis gather to both children."""
    from presto_tpu_torch.exec.staging import bucket_capacity

    cap = sel.shape[0]
    dev = sel.device
    off = blk.offsets.to(torch.int64)
    lengths = off[1:] - off[:-1]
    sel_len = torch.where(
        torch.arange(cap, device=dev) < num_live, lengths[sel], 0
    )
    new_off = torch.cat([
        torch.zeros((1,), dtype=torch.int64, device=dev),
        torch.cumsum(sel_len, dim=0),
    ])
    flat = blk.children[0] if blk.dtype.is_map else blk
    vcap = flat.data.shape[0]
    if repeats is None:
        out_vcap = bucket_capacity(int(new_off[-1]))
    elif repeats > 1:
        out_vcap = bucket_capacity(vcap * repeats)
    else:
        out_vcap = vcap
    valid = None if blk.valid is None else blk.valid[sel]
    if vcap == 0:
        src = None  # no values to gather: every row is empty
    else:
        j = torch.arange(out_vcap, dtype=torch.int64, device=dev)
        p = torch.clamp(
            torch.searchsorted(new_off[1:], j, right=True), max=cap - 1
        )
        src = torch.clamp(off[sel[p]] + (j - new_off[p]), 0, vcap - 1)

    def values(ch: Block) -> Block:
        if src is None:
            return ch
        return dataclasses.replace(
            ch,
            data=ch.data[src],
            valid=None if ch.valid is None else ch.valid[src],
        )

    new_off = new_off.to(torch.int32)
    if blk.dtype.is_map:
        return dataclasses.replace(
            blk,
            data=Block.placeholder_data(cap, dev),
            valid=valid,
            offsets=new_off,
            children=tuple(values(ch) for ch in blk.children),
        )
    return dataclasses.replace(
        blk,
        data=blk.data if src is None else blk.data[src],
        valid=valid,
        offsets=new_off,
    )


def _gather_row_block(
    blk: Block, sel: torch.Tensor, num_live, repeats: Optional[int]
) -> Block:
    """Row-gather a row (struct) block: its children gather with it."""
    return dataclasses.replace(
        blk,
        data=Block.placeholder_data(sel.shape[0], sel.device),
        valid=None if blk.valid is None else blk.valid[sel],
        children=tuple(
            gather_block(ch, sel, num_live, repeats) for ch in blk.children
        ),
    )


def _rebucket_block(blk: Block, capacity: int) -> Block:
    """Row-axis pad or slice of one block to ``capacity`` rows: flat
    data zero-pads, offsets edge-pad (padding rows read as empty; the
    value axis keeps its own capacity), row children follow their
    parent, validity pads with NULL."""
    cap = blk.capacity
    if capacity == cap:
        return blk
    grow = capacity - cap

    def fit(t: torch.Tensor) -> torch.Tensor:
        return _pad_rows(t, grow) if grow > 0 else t[:capacity]

    valid = None if blk.valid is None else fit(blk.valid)
    if blk.offsets is not None:
        offsets = (
            _edge_pad(blk.offsets, grow)
            if grow > 0
            else blk.offsets[: capacity + 1]
        )
        data = (
            Block.placeholder_data(capacity, blk.data.device)
            if blk.dtype.is_map
            else blk.data
        )
        return dataclasses.replace(
            blk, data=data, valid=valid, offsets=offsets
        )
    if blk.dtype.is_row:
        return dataclasses.replace(
            blk,
            data=Block.placeholder_data(capacity, blk.data.device),
            valid=valid,
            children=tuple(
                _rebucket_block(ch, capacity) for ch in blk.children
            ),
        )
    return dataclasses.replace(blk, data=fit(blk.data), valid=valid)


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
        blocks=tuple(
            gather_block(blk, sel, page.num_valid) for blk in page.blocks
        ),
        num_valid=torch.clamp(page.num_valid, max=cap).to(torch.int32),
        names=page.names,
    )


def pad_capacity(page: Page, capacity: int) -> Page:
    """Re-bucket a prefix-form page to a new (>= live rows) capacity:
    zero-pad or slice the row axis. Masked pages go through
    compact_page."""
    if page.live is not None:
        return compact_page(page, capacity)
    return Page(
        blocks=tuple(_rebucket_block(blk, capacity) for blk in page.blocks),
        num_valid=torch.clamp(page.num_valid, max=capacity).to(torch.int32),
        names=page.names,
    )


# ------------------------------------------------ lane-blocked pages
#
# A micro-batch of L statements of one cached plan runs the plan once
# over LANE-BLOCKED pages: capacity L * C, lane l owning rows
# [l * C, (l + 1) * C). Filters and projections keep rows in place, so
# they keep the layout; an aggregation emits one block per lane; any
# other operator raises NoLaneForm and the shape keeps the scalar path
# (exec/local_runner.py::execute_plan_microbatch).


class NoLaneForm(NotImplementedError):
    """An operator or aggregate of a micro-batched plan has no
    lane-blocked form: the shape falls out of batching."""


def tile_lanes(page: Page, lanes: int) -> Page:
    """A scanned page repeated once per lane, in masked form: the
    layout every operator of a micro-batch reads (each lane's filter
    then masks its own rows). Nested blocks have no lane form."""
    if any(b.dtype.is_nested for b in page.blocks):
        raise NoLaneForm("nested column in a micro-batched scan")
    live = page.row_mask()

    def rep(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if t is None:
            return None
        return t.repeat((lanes,) + (1,) * (t.dim() - 1))

    return Page(
        blocks=tuple(
            dataclasses.replace(b, data=rep(b.data), valid=rep(b.valid))
            for b in page.blocks
        ),
        num_valid=(page.num_valid * lanes).to(torch.int32),
        names=page.names,
        live=rep(live),
    )

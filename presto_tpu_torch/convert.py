"""Pages to and from plain numpy column tuples.

A column is ``(data, valid, type_name, dictionary_values)``: the stored
values (scaled int64 for decimals, (n, 2) int128 limb pairs for long
decimals, epoch days for dates, dictionary ids for strings), a bool
validity array or None, the SQL type's name as ``types.parse_type``
reads it, and the sorted dictionary values of a string column (else
None). Nested columns nest the form:

- an array column's data is ``(offsets, values)``: int32 offsets of
  length n + 1 over the flat element values, whose dictionary values
  (string elements) are the column's;
- a map column's data is ``(offsets, keys, values)``, the two children
  being column tuples over the flat entries;
- a row column's data is a tuple of one column tuple per field.

The same tuples build a page of either package, which is how a test puts
one input through the reference and through the port.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.page import (
    Block,
    Dictionary,
    Page,
    compact_page,
    resolve_device,
)

Column = Tuple[object, Optional[np.ndarray], str, Optional[np.ndarray]]


def block_from_numpy(column: Column, device) -> Block:
    """One column tuple -> a Block on ``device``."""
    data, valid, type_name, dict_values = column
    t = T.parse_type(type_name)
    dictionary = (
        None
        if dict_values is None
        else Dictionary(np.asarray(dict_values, dtype=object))
    )
    v = (
        None
        if valid is None
        else torch.from_numpy(np.asarray(valid, dtype=bool).copy()).to(device)
    )
    if t.is_array:
        offsets, values = data
        elem = Block.from_numpy(values, t.element, None, dictionary, device)
        return Block(
            data=elem.data, valid=v, dtype=t, dictionary=dictionary,
            offsets=_offsets(offsets, device),
        )
    if t.is_map:
        offsets, keys, values = data
        return Block(
            data=Block.placeholder_data(len(offsets) - 1, device),
            valid=v,
            dtype=t,
            offsets=_offsets(offsets, device),
            children=(
                block_from_numpy(keys, device),
                block_from_numpy(values, device),
            ),
        )
    if t.is_row:
        children = tuple(block_from_numpy(c, device) for c in data)
        return Block(
            data=Block.placeholder_data(children[0].capacity, device),
            valid=v,
            dtype=t,
            children=children,
        )
    return Block.from_numpy(data, t, valid, dictionary, device)


def _offsets(offsets, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(offsets, dtype=np.int32).copy()).to(
        device
    )


def page_from_numpy(
    columns: Dict[str, Column],
    num_valid: int,
    device=None,
) -> Page:
    """A prefix-form Page on ``device`` (``None``: the CUDA device, see
    ``page.resolve_device``) whose first ``num_valid`` rows are live;
    every column has the same length (the capacity)."""
    device = resolve_device(device)
    return Page(
        blocks=tuple(block_from_numpy(c, device) for c in columns.values()),
        num_valid=torch.tensor(num_valid, dtype=torch.int32, device=device),
        names=tuple(columns),
    )


def block_to_numpy(blk: Block, n: int) -> Column:
    """The first ``n`` rows of a block as a column tuple (an array or
    map block's values cut to the live rows' extent)."""
    valid = None if blk.valid is None else blk.valid[:n].cpu().numpy()
    dict_values = None if blk.dictionary is None else blk.dictionary.values
    if blk.offsets is not None:
        offsets = blk.offsets[: n + 1].cpu().numpy()
        end = int(offsets[-1])
        if blk.dtype.is_map:
            data = (offsets,) + tuple(
                block_to_numpy(_head(ch, end), end) for ch in blk.children
            )
        else:
            data = (offsets, blk.data[:end].cpu().numpy())
    elif blk.dtype.is_row:
        data = tuple(block_to_numpy(ch, n) for ch in blk.children)
    else:
        data = blk.data[:n].cpu().numpy()
    return (data, valid, str(blk.dtype), dict_values)


def _head(blk: Block, n: int) -> Block:
    return Block(
        data=blk.data[:n],
        valid=None if blk.valid is None else blk.valid[:n],
        dtype=blk.dtype,
        dictionary=blk.dictionary,
    )


def page_to_numpy(page: Page) -> Dict[str, Column]:
    """The live rows of ``page``, in order, as numpy column tuples."""
    page = compact_page(page)
    n = int(page.num_valid)
    return {
        name: block_to_numpy(blk, n)
        for name, blk in zip(page.names, page.blocks)
    }

"""Pages to and from plain numpy column tuples.

A column is ``(data, valid, type_name, dictionary_values)``: the stored
values (scaled int64 for decimals, epoch days for dates, dictionary ids
for strings), a bool validity array or None, the SQL type's name as
``types.parse_type`` reads it, and the sorted dictionary values of a
string column (else None). The same tuples build a page of either
package, which is how a test puts one input through the reference and
through the port.
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

Column = Tuple[np.ndarray, Optional[np.ndarray], str, Optional[np.ndarray]]


def page_from_numpy(
    columns: Dict[str, Column],
    num_valid: int,
    device=None,
) -> Page:
    """A prefix-form Page on ``device`` (``None``: the CUDA device, see
    ``page.resolve_device``) whose first ``num_valid`` rows are live;
    every column has the same length (the capacity)."""
    device = resolve_device(device)
    blocks = []
    for data, valid, type_name, dict_values in columns.values():
        dictionary = (
            None
            if dict_values is None
            else Dictionary(np.asarray(dict_values, dtype=object))
        )
        blocks.append(
            Block.from_numpy(
                data, T.parse_type(type_name), valid, dictionary, device
            )
        )
    return Page(
        blocks=tuple(blocks),
        num_valid=torch.tensor(num_valid, dtype=torch.int32, device=device),
        names=tuple(columns),
    )


def page_to_numpy(page: Page) -> Dict[str, Column]:
    """The live rows of ``page``, in order, as numpy column tuples."""
    page = compact_page(page)
    n = int(page.num_valid)
    out = {}
    for name, blk in zip(page.names, page.blocks):
        out[name] = (
            blk.data[:n].cpu().numpy(),
            None if blk.valid is None else blk.valid[:n].cpu().numpy(),
            str(blk.dtype),
            None if blk.dictionary is None else blk.dictionary.values,
        )
    return out

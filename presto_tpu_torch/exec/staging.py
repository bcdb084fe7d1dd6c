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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import DictColumn
from presto_tpu_torch.page import Block, Dictionary, Page

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


def _padded(arr: np.ndarray, cap: int, np_dtype) -> np.ndarray:
    # long decimals carry (n, 2) limb pairs; pad on axis 0
    out = np.zeros((cap,) + arr.shape[1:], dtype=np_dtype)
    out[: len(arr)] = arr
    return out


def stage_page(
    data: Dict[str, object],
    schema: Dict[str, T.DataType],
    capacity: Optional[int] = None,
    device: torch.device = torch.device("cpu"),
) -> Page:
    """Build a Page on ``device`` from SPI column payloads."""
    from presto_tpu_torch.connectors.spi import payload_len

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
                        Dictionary(v.values) if v.values is not None else None
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
                    dictionary=Dictionary(v.values),
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

"""Host payload merge of result pages.

The PyTorch counterpart of the payload part of
``presto_tpu/server/pages_wire.py``: ``merge_payloads`` merges many
``(payload, schema, nrows)`` parts into one staging payload, and
``page_to_wire_columns`` reads a host result page's live rows as host
columns. Serialization and the array-column merge belong to later
slices; array columns raise.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import DictColumn
from presto_tpu_torch.exec.staging import MaskedColumn
from presto_tpu_torch.page import Page


def merge_payloads(
    payloads: List[tuple], schema: Dict[str, T.DataType]
) -> Dict[str, object]:
    """Merge ``(payload, schema, nrows)`` parts into ONE staging payload
    for ``stage_page``.

    Dictionary-encoded columns need id remapping: each part's dictionary
    holds the values it saw, so id spaces differ across parts.
    Dictionaries are sorted-unique by construction (order-preserving,
    see ``connectors.tpch.DictColumn``), so the union dictionary is the
    sorted union of values and remapping is a searchsorted. When every
    part carries the SAME dictionary object (one generator, or the
    spilled batches of one staged table) the union is that dictionary
    and the remap the identity: ids are only clipped into range, as the
    remap would clip them, and the dictionary is passed on as it is."""
    out: Dict[str, object] = {}
    for name in schema:
        if schema[name].is_array:
            raise NotImplementedError(
                f"merging array column {name}: later slice of the port"
            )
        parts = []  # (data, valid|None, dict_values|None) per payload
        for payload, _schema, _nrows in payloads:
            col = payload[name]
            if isinstance(col, MaskedColumn):
                parts.append((col.data, col.valid, col.values))
            elif isinstance(col, DictColumn):
                parts.append((np.asarray(col.ids, np.int32), None, col.values))
            else:
                parts.append((np.asarray(col), None, None))
        has_dict = any(v is not None for _, _, v in parts)
        has_valid = any(v is not None for _, v, _ in parts)
        if has_dict:
            union, datas = _merge_dict_ids(parts)
            data = np.concatenate(datas) if datas else np.empty(0, np.int32)
            if has_valid:
                valids = [
                    v if v is not None else np.ones(len(d), dtype=bool)
                    for d, (_, v, _) in zip(datas, parts)
                ]
                out[name] = MaskedColumn(
                    data=data, valid=np.concatenate(valids), values=union
                )
            else:
                out[name] = DictColumn(ids=data, values=union)
        else:
            datas = [np.asarray(d) for d, _, _ in parts]
            data = (
                np.concatenate(datas)
                if datas
                else np.empty(0, schema[name].np_dtype)
            )
            if has_valid:
                valids = [
                    v if v is not None else np.ones(len(d), dtype=bool)
                    for d, v, _ in parts
                ]
                out[name] = MaskedColumn(data=data, valid=np.concatenate(valids))
            else:
                out[name] = data
    return out


def _merge_dict_ids(parts):
    """(union dictionary, each part's ids in it as int32)."""
    first = parts[0][2]
    if first is not None and all(v is first for _, _, v in parts):
        hi = max(len(first) - 1, 0)
        datas = [
            np.clip(np.asarray(d, np.int64), 0, hi).astype(np.int32)
            if len(first)
            else np.asarray(d, np.int32)
            for d, _, _ in parts
        ]
        return first, datas
    union = sorted(
        set().union(*[tuple(v) if v is not None else () for _, _, v in parts])
    )
    uarr = np.asarray(union, dtype=object)
    datas = []
    for data, _valid, values in parts:
        ids = np.asarray(data, np.int64)
        if values is not None and len(values):
            vals = np.asarray(values, dtype=object)
            remap = np.searchsorted(uarr, vals).astype(np.int64)
            # clip: padded/NULL slots may carry out-of-range ids
            ids = remap[np.clip(ids, 0, len(vals) - 1)]
        datas.append(ids.astype(np.int32))
    return uarr, datas


def page_to_wire_columns(page: Page):
    """A host result page's live prefix as host columns ``[(name, data,
    valid|None, dtype, dictionary values|None)]`` and the row count,
    read in place from the page ``LocalQueryRunner._run_with_pages``
    returns (one transfer already brought it to the host). Dictionary
    values are passed on as the same object, so later merges and bucket
    hashes recognise them."""
    if page.live is not None or page.device.type != "cpu":
        raise ValueError("page_to_wire_columns takes a prefix-form host page")
    for blk in page.blocks:
        if blk.dtype.is_nested:
            raise NotImplementedError(
                f"{blk.dtype} columns on the wire: later slice of the port"
            )
    n = int(page.num_valid)
    fetched = iter(page.prefix_leaves(n))
    cols = []
    for name, blk in zip(page.names, page.blocks):
        data = next(fetched).numpy()
        valid = next(fetched).numpy() if blk.valid is not None else None
        dict_values = None if blk.dictionary is None else blk.dictionary.values
        cols.append((name, data, valid, blk.dtype, dict_values))
    return cols, n

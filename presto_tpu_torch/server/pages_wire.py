"""DCN page serialization: typed columnar buffers + compression + checksum.

The PyTorch counterpart of ``presto_tpu/server/pages_wire.py``, frame
for frame: raw little-endian typed buffers per column, adaptively
zlib-compressed (buffers below a size floor or whose sample prefix
compresses poorly ship raw, flagged by a per-buffer ``enc`` header
field defaulting to ``"zlib"``), crc32-checksummed per buffer, with a
JSON header. A page serializes to the reference's bytes, so either
package reads the other's frames.

Frame layout::

    b"PTP1" | u32 header_len | header_json | buffer_0 | buffer_1 | ...

The header lists per-column metadata (name, type, validity, dictionary
values, buffer sizes and crc32s). Dictionary columns ship ids (int32)
plus their value list in the header.

``merge_payloads`` merges many ``(payload, schema, nrows)`` parts into
one staging payload, and ``page_to_wire_columns`` reads a result page's
live rows as host columns in ONE transfer (``page.to_host``), array
columns as ``ArrayColumn`` payloads. Map and row columns do not go on
the wire (the reference's wire has no form for them either).
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import DictColumn
from presto_tpu_torch.exec.staging import ArrayColumn, MaskedColumn
from presto_tpu_torch.page import Page, to_host
from presto_tpu_torch.server.protocol import decode as _decode_type
from presto_tpu_torch.server.protocol import encode as _encode_type

_MAGIC = b"PTP1"

#: adaptive compression floor: buffers below this ship raw — zlib
#: setup costs more than it saves on tiny buffers
MIN_COMPRESS_BYTES = 512

#: sample prefix compressed to probe compressibility of large buffers
COMPRESS_SAMPLE_BYTES = 4096

#: sample compressed/raw ratio above which the whole buffer ships raw
#: (already-compressed or high-entropy data: deflate would burn CPU on
#: both ends to GROW the payload)
COMPRESS_SAMPLE_RATIO = 0.9


def _encode_buffer(raw: bytes) -> Tuple[bytes, int, str]:
    """Adaptive wire encoding: ``(payload, crc32(raw), enc)`` where
    ``enc`` is ``"zlib"`` or ``"raw"``. Small buffers and buffers whose
    sample prefix compresses poorly skip zlib (metrics:
    ``exchange.compress_skipped``); compressed buffers record the bytes
    saved (``exchange.bytes_saved``). The header's per-buffer ``enc``
    field defaults to ``"zlib"`` when absent, so old frames decode
    unchanged (wire format stays PTP1).

    This is the ONE encoder behind both producer entry points —
    ``page_to_wire_columns`` (device-page serialization) and
    ``payload_to_wire_columns`` (the partitioned-output re-serialize
    path, which slices a page into many small per-partition buffers) —
    so the skip/saved counters read consistently whichever path
    produced the frame. Buffers below the size floor return BEFORE any
    probe logic: the 4KB ratio probe would compress a sample larger
    than the buffer itself, exactly the waste the floor exists to
    avoid."""
    from presto_tpu_torch.utils.metrics import REGISTRY

    crc = zlib.crc32(raw)
    if len(raw) < MIN_COMPRESS_BYTES:
        REGISTRY.counter("exchange.compress_skipped").update()
        return raw, crc, "raw"
    if len(raw) > COMPRESS_SAMPLE_BYTES:
        sample = raw[:COMPRESS_SAMPLE_BYTES]
        ratio = len(zlib.compress(sample, 1)) / len(sample)
        if ratio > COMPRESS_SAMPLE_RATIO:
            REGISTRY.counter("exchange.compress_skipped").update()
            return raw, crc, "raw"
    comp = zlib.compress(raw, 1)
    if len(comp) < len(raw):
        REGISTRY.counter("exchange.bytes_saved").update(
            len(raw) - len(comp)
        )
        return comp, crc, "zlib"
    REGISTRY.counter("exchange.compress_skipped").update()
    return raw, crc, "raw"


def _decode_buffer(payload: bytes, enc: str) -> bytes:
    if enc == "raw":
        return bytes(payload)
    return zlib.decompress(payload)


def serialize_page(
    columns: List[Tuple[str, np.ndarray, Optional[np.ndarray], T.DataType,
                        Optional[tuple]]],
    nrows: int,
) -> bytes:
    """columns: (name, data[:n], valid[:n]|None, dtype, dict_values|None).

    Numeric data must already be in native representation (scaled ints
    for decimals, epoch days for dates, int32 ids for dictionary cols).
    """
    header: Dict = {"nrows": nrows, "columns": []}
    buffers: List[bytes] = []
    for name, data, valid, dtype, dict_values in columns:
        if isinstance(data, ArrayColumn):
            # array column: offsets buffer + flat values buffer
            off = np.ascontiguousarray(
                np.asarray(data.offsets, np.int32)
            )
            vals = np.ascontiguousarray(
                np.asarray(data.values)[: int(off[-1]) if len(off) else 0]
            )
            oraw, vraw_ = off.tobytes(), vals.tobytes()
            ocomp, ocrc, oenc = _encode_buffer(oraw)
            vcomp_, vcrc_, venc = _encode_buffer(vraw_)
            col = {
                "name": name,
                "type": _encode_type(dtype),
                "array": True,
                "off_comp_size": len(ocomp),
                "off_raw_size": len(oraw),
                "off_crc32": ocrc,
                "off_enc": oenc,
                "np_dtype": vals.dtype.str,
                "comp_size": len(vcomp_),
                "raw_size": len(vraw_),
                "crc32": vcrc_,
                "enc": venc,
            }
            buffers.append(ocomp)
            buffers.append(vcomp_)
            if valid is not None:
                vraw = np.packbits(
                    np.asarray(valid, dtype=bool)
                ).tobytes()
                vc, vcr, vvenc = _encode_buffer(vraw)
                col["valid_comp_size"] = len(vc)
                col["valid_raw_size"] = len(vraw)
                col["valid_crc32"] = vcr
                col["valid_enc"] = vvenc
                buffers.append(vc)
            if dict_values is not None:
                col["dictionary"] = list(dict_values)
            header["columns"].append(col)
            continue
        data = np.ascontiguousarray(data)
        raw = data.tobytes()
        comp, crc, enc = _encode_buffer(raw)
        col: Dict = {
            "name": name,
            "type": _encode_type(dtype),
            "np_dtype": data.dtype.str,
            "comp_size": len(comp),
            "raw_size": len(raw),
            "crc32": crc,
            "enc": enc,
        }
        buffers.append(comp)
        if valid is not None:
            vraw = np.packbits(np.asarray(valid, dtype=bool)).tobytes()
            vcomp, vcrc, venc = _encode_buffer(vraw)
            col["valid_comp_size"] = len(vcomp)
            col["valid_raw_size"] = len(vraw)
            col["valid_crc32"] = vcrc
            col["valid_enc"] = venc
            buffers.append(vcomp)
        if dict_values is not None:
            col["dictionary"] = list(dict_values)
        header["columns"].append(col)
    hj = json.dumps(header).encode()
    return b"".join(
        [_MAGIC, struct.pack("<I", len(hj)), hj] + buffers
    )


def deserialize_page(buf: bytes):
    """-> (payload {name: ndarray | DictColumn}, schema {name: DataType},
    nrows) — feeds exec.staging.stage_page directly."""
    if buf[:4] != _MAGIC:
        raise ValueError("bad page frame magic")
    (hlen,) = struct.unpack_from("<I", buf, 4)
    header = json.loads(buf[8 : 8 + hlen].decode())
    off = 8 + hlen
    payload: Dict = {}
    schema: Dict[str, T.DataType] = {}
    nrows = header["nrows"]
    for col in header["columns"]:
        if col.get("array"):
            ocomp = buf[off : off + col["off_comp_size"]]
            off += col["off_comp_size"]
            oraw = _decode_buffer(ocomp, col.get("off_enc", "zlib"))
            if zlib.crc32(oraw) != col["off_crc32"]:
                raise ValueError(
                    f"offsets checksum mismatch on {col['name']}"
                )
            offsets = np.frombuffer(oraw, np.int32).copy()
            vcomp2 = buf[off : off + col["comp_size"]]
            off += col["comp_size"]
            vraw2 = _decode_buffer(vcomp2, col.get("enc", "zlib"))
            if zlib.crc32(vraw2) != col["crc32"]:
                raise ValueError(
                    f"values checksum mismatch on {col['name']}"
                )
            values = np.frombuffer(
                vraw2, np.dtype(col["np_dtype"])
            ).copy()
            valid = None
            if "valid_comp_size" in col:
                vc = buf[off : off + col["valid_comp_size"]]
                off += col["valid_comp_size"]
                vr = _decode_buffer(vc, col.get("valid_enc", "zlib"))
                if zlib.crc32(vr) != col["valid_crc32"]:
                    raise ValueError(
                        f"validity checksum mismatch on {col['name']}"
                    )
                valid = np.unpackbits(
                    np.frombuffer(vr, np.uint8), count=nrows
                ).astype(bool)
            dtype = _decode_type(col["type"])
            schema[col["name"]] = dtype
            payload[col["name"]] = ArrayColumn(
                offsets=offsets,
                values=values,
                valid=valid,
                dict_values=(
                    tuple(col["dictionary"])
                    if "dictionary" in col
                    else None
                ),
            )
            continue
        comp = buf[off : off + col["comp_size"]]
        off += col["comp_size"]
        raw = _decode_buffer(comp, col.get("enc", "zlib"))
        if len(raw) != col["raw_size"] or zlib.crc32(raw) != col["crc32"]:
            raise ValueError(f"page checksum mismatch on {col['name']}")
        data = np.frombuffer(raw, dtype=np.dtype(col["np_dtype"])).copy()
        valid = None
        if "valid_comp_size" in col:
            vcomp = buf[off : off + col["valid_comp_size"]]
            off += col["valid_comp_size"]
            vraw = _decode_buffer(vcomp, col.get("valid_enc", "zlib"))
            if zlib.crc32(vraw) != col["valid_crc32"]:
                raise ValueError(
                    f"validity checksum mismatch on {col['name']}"
                )
            valid = np.unpackbits(
                np.frombuffer(vraw, dtype=np.uint8), count=nrows
            ).astype(bool)
        dtype = _decode_type(col["type"])
        schema[col["name"]] = dtype
        dict_values = (
            tuple(col["dictionary"]) if "dictionary" in col else None
        )
        if valid is not None:
            # native repr + mask: exact (no Python-value round trip)
            payload[col["name"]] = MaskedColumn(
                data=data, valid=valid, values=dict_values
            )
        elif dict_values is not None:
            payload[col["name"]] = DictColumn(
                ids=data.astype(np.int32), values=dict_values
            )
        else:
            payload[col["name"]] = data
    return payload, schema, nrows


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
            out[name] = _merge_array_parts([p[name] for p, _s, _n in payloads])
            continue
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


def _merge_array_parts(parts: List[ArrayColumn]) -> ArrayColumn:
    """Concatenate ArrayColumn chunks: values concatenate, offsets
    rebase. String-element dictionaries must agree across chunks (a
    cross-dictionary array remap is a gap the reference shares)."""
    dicts = {
        tuple(p.dict_values) for p in parts if p.dict_values is not None
    }
    if len(dicts) > 1:
        raise NotImplementedError(
            "merging array columns with differing element "
            "dictionaries is not supported"
        )
    offsets = [np.zeros(1, np.int32)]
    values = []
    base = 0
    for p in parts:
        off = np.asarray(p.offsets, np.int32)
        end = int(off[-1]) if len(off) else 0
        offsets.append(off[1:] + base)
        values.append(np.asarray(p.values)[:end])
        base += end
    any_valid = any(p.valid is not None for p in parts)
    return ArrayColumn(
        offsets=np.concatenate(offsets),
        values=np.concatenate(values) if values else np.zeros(0),
        valid=(
            np.concatenate([
                np.ones(len(p), bool)
                if p.valid is None
                else np.asarray(p.valid, bool)
                for p in parts
            ])
            if any_valid
            else None
        ),
        dict_values=next(
            (p.dict_values for p in parts if p.dict_values is not None),
            None,
        ),
    )


def page_to_wire_columns(page: Page, fetched_n: Optional[int] = None):
    """A result page's live prefix as host columns ``[(name, data,
    valid|None, dtype, dictionary values|None)]`` and the row count.

    A host page (what ``LocalQueryRunner._run_with_pages`` returns) is
    read in place; a device page's prefix comes over in ONE transfer
    (``page.to_host``), the count read first unless the caller passes
    ``fetched_n``. Dictionary values are passed on as the same object,
    so later merges and bucket hashes recognise them."""
    if page.live is not None:
        raise ValueError("page_to_wire_columns takes a prefix-form page")
    for blk in page.blocks:
        if blk.dtype.is_map or blk.dtype.is_row:
            raise NotImplementedError(
                f"{blk.dtype} columns have no wire form"
            )
    n = fetched_n if fetched_n is not None else int(page.num_valid)
    leaves = page.prefix_leaves(n)
    if page.device.type != "cpu":
        leaves = to_host(leaves)
    fetched = iter(leaves)
    cols = []
    for name, blk in zip(page.names, page.blocks):
        if blk.offsets is not None:
            offsets = next(fetched).numpy()
            values = next(fetched).numpy()
            valid = next(fetched).numpy() if blk.valid is not None else None
            dict_values = (
                None if blk.dictionary is None else blk.dictionary.values
            )
            cols.append((
                name,
                ArrayColumn(
                    offsets=offsets, values=values, valid=valid,
                    dict_values=dict_values,
                ),
                valid,
                blk.dtype,
                dict_values,
            ))
            continue
        data = next(fetched).numpy()
        valid = next(fetched).numpy() if blk.valid is not None else None
        dict_values = None if blk.dictionary is None else blk.dictionary.values
        cols.append((name, data, valid, blk.dtype, dict_values))
    return cols, n


def payload_to_wire_columns(payload, schema, nrows: int):
    """Staging payload (deserialize_page / streaming._page_to_payload
    form) -> serialize_page input. Used by the partitioned-output path:
    producers bucket host-side payloads and re-serialize each
    partition's slice without another device round trip."""
    cols = []
    for name, t in schema.items():
        col = payload[name]
        if isinstance(col, ArrayColumn):
            sliced = col[0:nrows]  # offsets rebase + values trim
            cols.append(
                (name, sliced, sliced.valid, t, sliced.dict_values)
            )
        elif isinstance(col, MaskedColumn):
            values = (
                tuple(col.values) if col.values is not None else None
            )
            cols.append(
                (
                    name,
                    np.asarray(col.data)[:nrows],
                    np.asarray(col.valid)[:nrows],
                    t,
                    values,
                )
            )
        elif isinstance(col, DictColumn):
            cols.append(
                (
                    name,
                    np.asarray(col.ids, np.int32)[:nrows],
                    None,
                    t,
                    tuple(col.values),
                )
            )
        else:
            cols.append((name, np.asarray(col)[:nrows], None, t, None))
    return cols

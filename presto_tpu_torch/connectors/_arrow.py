"""Shared Arrow-to-engine conversion for file-format connectors.

The PyTorch port's copy of ``presto_tpu/connectors/_arrow.py``. Both
columnar file formats the engine reads (parquet, ORC) arrive through
pyarrow, and both hand the engine the same staging payloads:
numeric numpy arrays in the engine's native representation (decimals as
scaled int64, dates as epoch days, timestamps as epoch micros) and
strings pre-encoded as dictionary ids (``DictColumn``, or
``MaskedColumn`` with the dictionary values when the column has nulls).
``exec/staging.py::stage_page`` copies a page's payloads to the device
in one transfer; strings stay on the host as dictionaries.
"""

from __future__ import annotations

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import DictColumn
from presto_tpu_torch.exec.staging import MaskedColumn


def arrow_to_engine_type(at) -> T.DataType:
    import pyarrow as pa

    if pa.types.is_boolean(at):
        return T.BOOLEAN
    if pa.types.is_integer(at):
        return T.BIGINT if at.bit_width > 32 else T.INTEGER
    if pa.types.is_floating(at):
        return T.DOUBLE
    if pa.types.is_decimal(at):
        # T.decimal routes p>18 to the int128-limbed LongDecimalType
        return T.decimal(at.precision, at.scale)
    if pa.types.is_date(at):
        return T.DATE
    if pa.types.is_timestamp(at):
        return T.TIMESTAMP
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return T.VARCHAR
    raise NotImplementedError(f"no engine mapping for arrow type {at}")


def arrow_column_to_payload(arr, t: T.DataType):
    """Arrow chunked array -> engine staging payload."""
    import pyarrow as pa

    combined = arr.combine_chunks()
    nulls = combined.null_count > 0
    if t.is_string:
        ids, valid, dictionary = _encode_arrow_strings(combined)
        if nulls:
            return MaskedColumn(
                data=ids, valid=valid, values=tuple(dictionary)
            )
        return DictColumn(
            ids=ids, values=np.asarray(dictionary, dtype=object)
        )
    if t.is_decimal:
        # arrow decimal128 -> unscaled int64 (short) or (n, 2) int128
        # limb pairs (long), read STRAIGHT from arrow's 16-byte
        # little-endian buffer (measured ~300x over per-value as_py)
        n = len(combined)
        raw = np.frombuffer(
            combined.buffers()[1],
            dtype=np.uint64,
            count=2 * n,
            offset=combined.offset * 16,
        ).reshape(-1, 2)
        lo = raw[:, 0].view(np.int64).copy()
        if t.is_long_decimal:
            hi = raw[:, 1].view(np.int64).copy()
            data = np.stack([hi, lo], axis=1)
        else:
            data = lo
        valid = (
            np.asarray(combined.is_valid(), dtype=bool) if nulls else None
        )
        if valid is not None:
            # zero null slots FIRST: they carry uninitialized bytes
            # that would poison the rescale below (and pages must stay
            # deterministic; masked rows are never observed)
            data[~valid] = 0
        # schema evolution: a file may store the column at a different
        # scale than the table schema (hive derives the schema from its
        # first file). Rounding on downscale is HALF-UP, matching
        # Block.from_pylist ingest (the replaced as_py path truncated
        # toward zero — a deliberate change, codified in
        # tests/test_hive.py::test_decimal_scale_evolution_across_files)
        file_scale = combined.type.scale
        if file_scale != t.scale:
            data = _rescale_unscaled(data, file_scale, t.scale, t)
        if valid is not None:  # reuse the mask computed above
            return MaskedColumn(data=data, valid=valid)
        return data
    elif t.name == "date":
        data = np.asarray(
            combined.cast(pa.int32()).fill_null(0), dtype=np.int64
        )
    elif t.name == "timestamp":
        data = np.asarray(
            combined.cast(pa.int64()).fill_null(0), dtype=np.int64
        )
    elif t.name == "boolean":
        # fill_null(0) would try pa.scalar(0, bool) and fail — the
        # fill value must be a python bool for boolean arrays
        data = np.asarray(combined.fill_null(False), dtype=t.np_dtype)
    else:
        data = np.asarray(
            combined.fill_null(0), dtype=t.np_dtype
        )
    if not nulls:
        return data
    valid = np.asarray(combined.is_valid(), dtype=bool)
    return MaskedColumn(data=data, valid=valid)


def _rescale_unscaled(data, from_scale: int, to_scale: int, t):
    """Exact rescale of unscaled decimal ints (half-up on downscale,
    matching Block.from_pylist's ingest rounding)."""
    if t.is_long_decimal:
        # python-int path: exactness over speed for the rare
        # schema-evolution case
        vals = [T.int128_value(h, l) for h, l in data]
        if to_scale > from_scale:
            vals = [v * 10 ** (to_scale - from_scale) for v in vals]
        else:
            f = 10 ** (from_scale - to_scale)
            vals = [
                (abs(v) + f // 2) // f * (1 if v >= 0 else -1)
                for v in vals
            ]
        return T.int128_limbs(vals)
    if to_scale > from_scale:
        factor = 10 ** (to_scale - from_scale)
        if len(data) and int(
            np.abs(data).max()
        ) > (2 ** 63 - 1) // factor:
            # loud like the old python-int path, not a silent wrap
            raise OverflowError(
                f"decimal rescale x{factor} overflows int64 "
                f"(declared {t}, file scale {from_scale})"
            )
        return data * np.int64(factor)
    f = np.int64(10 ** (from_scale - to_scale))
    q = (np.abs(data) + f // 2) // f
    return np.sign(data) * q


def _encode_arrow_strings(combined):
    """Arrow string column -> (int32 ids, valid, sorted dictionary).

    Arrow's own ``dictionary_encode`` finds the distinct values (no
    Python object per row); only the distinct values are sorted here and
    the codes remapped to their ranks. The result is the reference's,
    which ranks every row's string with ``np.unique`` and
    ``np.searchsorted``."""
    valid = np.asarray(combined.is_valid(), dtype=bool)
    enc = combined.dictionary_encode()
    distinct = enc.dictionary.to_numpy(zero_copy_only=False).astype(str)
    codes = np.asarray(enc.indices.fill_null(0), dtype=np.int64)
    ids = np.zeros(len(combined), dtype=np.int32)
    if len(distinct):
        order = np.argsort(distinct, kind="stable")
        rank = np.empty(len(distinct), dtype=np.int32)
        rank[order] = np.arange(len(distinct), dtype=np.int32)
        ids[valid] = rank[codes[valid]]
        uniq = distinct[order]
    else:
        uniq = np.empty(0, dtype=str)
    return ids, valid, uniq.astype(object)

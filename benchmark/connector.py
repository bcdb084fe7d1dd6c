"""The benchmark's own catalog: the generated columns, copied to the host
once, behind the program's connector SPI. Varchars are dictionary ids
(the program's ``DictColumn``); the table statistics (row counts,
primary keys, distinct counts, and min and max of integer and date
columns) are worked out from the generated columns on the device."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from benchmark.gen.common import Varchar, rows_of
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.spi import (
    ColumnStats,
    Connector,
    ConnectorMetadata,
    ConnectorSplit,
    SplitSource,
    TableHandle,
    TableStats,
)
from presto_tpu_torch.connectors.tpch import DictColumn


def column_stats(col, type_name: str) -> ColumnStats:
    """Distinct count, and min and max of an integer or a date column,
    of one generated column (on the device)."""
    data = col.ids if isinstance(col, Varchar) else col
    if len(data) == 0:
        return ColumnStats(distinct_count=0.0)
    ndv = float(torch.unique(data).numel())
    if type_name in ("integer", "bigint", "date"):
        return ColumnStats(distinct_count=ndv, min_value=float(data.min()),
                           max_value=float(data.max()))
    return ColumnStats(distinct_count=ndv)


def table_stats(cfg: dict, tables: Dict[str, dict]) -> Dict[str, TableStats]:
    out = {}
    for name, spec in cfg["tables"].items():
        cols = tables[name]
        first = next(iter(cols.values()))
        pk = spec.get("primary_key")
        out[name] = TableStats(
            row_count=float(rows_of(first)),
            columns={c: column_stats(cols[c], t)
                     for c, t in spec["columns"].items()},
            primary_key=tuple(pk) if pk else None,
        )
    return out


def to_host(col):
    """One generated column as the SPI payload the program stages."""
    if isinstance(col, Varchar):
        return DictColumn(ids=col.ids.cpu().numpy(),
                          values=np.asarray(col.values, dtype=object))
    return col.cpu().numpy()


class _Metadata(ConnectorMetadata):
    def __init__(self, schema: str, types, stats):
        self._schema = schema
        self._types = types
        self._stats = stats

    def list_schemas(self):
        return [self._schema]

    def list_tables(self, schema):
        return list(self._types)

    def _check(self, handle: TableHandle):
        if handle.schema != self._schema or handle.table not in self._types:
            raise KeyError(f"unknown table {handle.schema}.{handle.table}")

    def get_table_schema(self, handle: TableHandle):
        self._check(handle)
        return dict(self._types[handle.table])

    def get_table_stats(self, handle: TableHandle):
        self._check(handle)
        return self._stats[handle.table]


class GeneratedConnector(Connector):
    """Read-only tables of host columns under one schema (the
    configuration's name)."""

    def __init__(self, cfg: dict, host: Dict[str, Dict[str, object]],
                 stats: Dict[str, TableStats]):
        types = {
            t: {c: T.parse_type(ty) for c, ty in spec["columns"].items()}
            for t, spec in cfg["tables"].items()
        }
        self._host = host
        self._rows = {t: int(s.row_count) for t, s in stats.items()}
        self._metadata = _Metadata(cfg["name"], types, stats)

    def metadata(self):
        return self._metadata

    def get_splits(self, handle: TableHandle, target_split_rows: int = 1 << 20,
                   constraint=()):
        n = self._rows[handle.table]
        splits = [
            ConnectorSplit(handle, lo, min(lo + target_split_rows, n))
            for lo in range(0, n, target_split_rows)
        ] or [ConnectorSplit(handle, 0, 0)]
        return SplitSource(splits)

    def create_page_source(self, split: ConnectorSplit, columns: Sequence[str]):
        cols = self._host[split.table.table]
        lo, hi = split.row_start, split.row_end
        out = {}
        for c in columns:
            v = cols[c]
            if isinstance(v, DictColumn):
                out[c] = DictColumn(ids=v.ids[lo:hi], values=v.values)
            else:
                out[c] = v[lo:hi]
        return out

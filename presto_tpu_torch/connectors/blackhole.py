"""Null source/sink with configurable fake row counts (reference:
``presto-blackhole``, SURVEY.md §2.2 — scheduler/perf test fixture): a
copy of the reference's ``presto_tpu/connectors/blackhole.py``."""

from __future__ import annotations

import time
from typing import Dict, Sequence

import numpy as np

from presto_tpu_torch.connectors.spi import (
    Connector,
    ConnectorMetadata,
    ConnectorSplit,
    SplitSource,
    TableHandle,
    TableStats,
)
from presto_tpu_torch.connectors.tpch import DictColumn


class _BhMetadata(ConnectorMetadata):
    def __init__(self, tables):
        self._tables = tables

    def list_schemas(self):
        return ["default"]

    def list_tables(self, schema):
        return sorted(t for _, t in self._tables)

    def get_table_schema(self, handle: TableHandle):
        return dict(self._tables[(handle.schema, handle.table)]["schema"])

    def get_table_stats(self, handle: TableHandle):
        return TableStats(
            row_count=float(self._tables[(handle.schema, handle.table)]["rows"])
        )


class BlackholeConnector(Connector):
    """Tables are declared via create_table with extra config keys:
    rows_per_table and page_processing_delay_s (fault/latency injection,
    SURVEY.md §5.3)."""

    def __init__(self, rows_per_table: int = 0, delay_s: float = 0.0, **config):
        self._tables: Dict[tuple, dict] = {}
        self._default_rows = rows_per_table
        self._delay_s = delay_s
        self._metadata = _BhMetadata(self._tables)

    def metadata(self):
        return self._metadata

    def supports_writes(self):
        return True

    def create_table(self, handle: TableHandle, schema, rows: int = None):
        self._tables[(handle.schema, handle.table)] = {
            "schema": dict(schema),
            "rows": self._default_rows if rows is None else rows,
        }

    def append_rows(self, handle, data):
        pass  # the sink half: swallow everything

    def get_splits(self, handle: TableHandle, target_split_rows: int = 1 << 20, constraint=()):
        n = self._tables[(handle.schema, handle.table)]["rows"]
        splits = [
            ConnectorSplit(handle, lo, min(lo + target_split_rows, n))
            for lo in range(0, n, target_split_rows)
        ] or [ConnectorSplit(handle, 0, 0)]
        return SplitSource(splits)

    def create_page_source(self, split: ConnectorSplit, columns: Sequence[str]):
        if self._delay_s:
            time.sleep(self._delay_s)
        schema = self._tables[(split.table.schema, split.table.table)]["schema"]
        n = split.num_rows
        out = {}
        for c in columns:
            t = schema[c]
            if t.is_string:
                out[c] = DictColumn(
                    ids=np.zeros(n, dtype=np.int32),
                    values=np.asarray(["x"], dtype=object),
                )
            else:
                out[c] = np.zeros(n, dtype=t.np_dtype)
        return out

"""Parquet connector: columnar files on disk as queryable tables.

Reference parity: ``presto-parquet`` + the hive-style file connector
surface (SURVEY.md §2.2 L9 "file-format readers") — columnar reads with
column pruning, row-group splits, and statistics from file metadata
(row counts + per-column min/max feed the cost-based optimizer exactly
like the reference's TupleDomain pruning inputs).

The PyTorch port's copy of ``presto_tpu/connectors/parquet.py``: the
reader produces the engine's staging payloads directly — numeric numpy
arrays in native representation (decimals as scaled int64, dates as
epoch days) and strings pre-encoded as dictionary ids, which stay on
the host — and ``exec/staging.py`` copies a page to the device in one
transfer. Row-group pruning and split ranges are the reference's.

Layout: ``root/<schema>/<table>.parquet``. With the ``lakehouse``
config (a manifest-store root), the catalog ADDITIONALLY serves
manifest-committed snapshot tables — versioned, time-travelable, and
writable through the ingest lane — via the shared lakehouse surface
in ``server/manifests.py``; plain file tables stay bit-exact legacy.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors._arrow import (
    arrow_column_to_payload as _arrow_column_to_payload,
    arrow_to_engine_type as _arrow_to_engine_type,
)
from presto_tpu_torch.connectors.spi import (
    ColumnStats,
    Connector,
    ConnectorMetadata,
    ConnectorSplit,
    RangeSet,
    SplitSource,
    TableHandle,
    TableStats,
)
from presto_tpu_torch.server.manifests import LakehouseConnectorMixin


def rowgroup_matches(stats, domain) -> bool:
    """May a row group with ``stats`` (pyarrow column statistics, or
    None) contain rows satisfying ``domain`` (a value tuple or a
    dynamic-filter :class:`RangeSet`)? Missing/non-numeric stats keep
    the group — over-retain, never over-prune (the originating filter
    still applies to every row read)."""
    if isinstance(domain, RangeSet):
        if (
            stats is None
            or not stats.has_min_max
            or not isinstance(stats.min, (int, float))
            or isinstance(stats.min, bool)
            or not isinstance(domain.lo, (int, float))
        ):
            return True
        return not (stats.max < domain.lo or stats.min > domain.hi)
    # value set: an EMPTY set matches nothing (empty build side)
    if not domain:
        return False
    if (
        stats is None
        or not stats.has_min_max
        or not isinstance(stats.min, (int, float))
        or isinstance(stats.min, bool)
    ):
        return True
    vals = [v for v in domain if isinstance(v, (int, float))]
    if len(vals) != len(domain):
        return True  # non-numeric literals: don't prune on them
    return any(stats.min <= v <= stats.max for v in vals)


class _ParquetMetadata(ConnectorMetadata):
    def __init__(self, conn: "ParquetConnector"):
        self._conn = conn

    def list_schemas(self) -> List[str]:
        root = self._conn.root
        out = set(self._conn.lake_list_schemas())
        try:
            out.update(
                d
                for d in os.listdir(root)
                if os.path.isdir(os.path.join(root, d))
            )
        except OSError:
            pass
        return sorted(out)

    def list_tables(self, schema: str) -> List[str]:
        d = os.path.join(self._conn.root, schema)
        out = set(self._conn.lake_list_tables(schema))
        try:
            out.update(
                fn[: -len(".parquet")]
                for fn in os.listdir(d)
                if fn.endswith(".parquet")
            )
        except OSError:
            pass
        return sorted(out)

    def get_table_schema(self, handle: TableHandle) -> Dict[str, T.DataType]:
        lake = self._conn.lake_schema(handle)
        if lake is not None:
            return lake
        pf = self._conn._file(handle)
        return {
            f.name: _arrow_to_engine_type(f.type)
            for f in pf.schema_arrow
        }

    def get_table_stats(self, handle: TableHandle) -> TableStats:
        """Row count + per-column min/max straight from the parquet
        footer (zero data reads) — the optimizer's range-selectivity
        and join-sizing inputs. Manifest-backed tables answer from
        the pinned manifest instead (same inputs, zero file opens)."""
        lake = self._conn.lake_table_stats(handle)
        if lake is not None:
            return lake
        pf = self._conn._file(handle)
        md = pf.metadata
        cols: Dict[str, ColumnStats] = {}
        schema = self.get_table_schema(handle)
        mins: Dict[str, object] = {}
        maxs: Dict[str, object] = {}
        ndv: Dict[str, float] = {}
        for rg in range(md.num_row_groups):
            g = md.row_group(rg)
            for ci in range(g.num_columns):
                c = g.column(ci)
                st = c.statistics
                name = c.path_in_schema
                if st is None or not st.has_min_max:
                    continue
                if not isinstance(st.min, (int, float)):
                    continue  # numeric ranges only
                mins[name] = (
                    st.min if name not in mins else min(mins[name], st.min)
                )
                maxs[name] = (
                    st.max if name not in maxs else max(maxs[name], st.max)
                )
                if st.distinct_count:
                    ndv[name] = ndv.get(name, 0.0) + st.distinct_count
        for name in schema:
            if name in mins:
                cols[name] = ColumnStats(
                    distinct_count=ndv.get(name),
                    min_value=float(mins[name]),
                    max_value=float(maxs[name]),
                )
        return TableStats(row_count=float(md.num_rows), columns=cols)


class ParquetConnector(LakehouseConnectorMixin, Connector):
    """Catalog over ``root/<schema>/<table>.parquet`` files, plus
    manifest-backed snapshot tables when ``lakehouse`` is set."""

    def prunes_splits(self) -> bool:
        return True  # row-group footer min/max prune splits

    def __init__(
        self,
        root: str = ".",
        lakehouse: Optional[str] = None,
        catalog: Optional[str] = None,
        target_file_bytes: Optional[int] = None,
        **config,
    ):
        self.root = root
        self._metadata = _ParquetMetadata(self)
        self._files: Dict[TableHandle, object] = {}
        self._init_lakehouse(
            lakehouse, catalog=catalog,
            target_file_bytes=target_file_bytes,
        )

    def metadata(self):
        return self._metadata

    def _path(self, handle: TableHandle) -> str:
        return os.path.join(
            self.root, handle.schema, handle.table + ".parquet"
        )

    def _file(self, handle: TableHandle):
        import pyarrow.parquet as pq

        pf = self._files.get(handle)
        if pf is None:
            path = self._path(handle)
            if not os.path.exists(path):
                raise KeyError(f"no parquet table at {path}")
            pf = pq.ParquetFile(path)
            self._files[handle] = pf
        return pf

    def get_splits(
        self, handle: TableHandle, target_split_rows: int = 1 << 20,
        constraint=(),
    ) -> SplitSource:
        """Row-group-aligned splits (the reference's parquet split
        boundary); expressed as row ranges so the engine's split
        protocol stays format-agnostic. Row groups whose footer
        min/max statistics cannot satisfy the pushed ``constraint``
        (dynamic-filter RangeSets / value sets) produce no splits —
        those rows are never read. Manifest-backed tables prune at
        the FILE level from manifest min/max instead."""
        lake = self.lake_splits(handle, target_split_rows, constraint)
        if lake is not None:
            return lake
        pf = self._file(handle)
        md = pf.metadata
        # constraint column -> row-group column index (once per call)
        col_idx: Dict[str, int] = {}
        if constraint and md.num_row_groups:
            g0 = md.row_group(0)
            names = {
                g0.column(ci).path_in_schema: ci
                for ci in range(g0.num_columns)
            }
            col_idx = {
                col: names[col]
                for col, _ in constraint
                if col in names
            }

        def rg_matches(rg: int) -> bool:
            if not col_idx:
                return True
            g = md.row_group(rg)
            for col, dom in constraint:
                ci = col_idx.get(col)
                st = (
                    g.column(ci).statistics if ci is not None else None
                )
                if not rowgroup_matches(st, dom):
                    return False
            return True

        from presto_tpu_torch.connectors.spi import coalesce_kept_chunks

        chunk_rows = [
            md.row_group(rg).num_rows
            for rg in range(md.num_row_groups)
        ]
        keep = [rg_matches(rg) for rg in range(md.num_row_groups)]
        return SplitSource(
            coalesce_kept_chunks(
                handle, chunk_rows, keep, target_split_rows
            )
        )

    def create_page_source(
        self, split: ConnectorSplit, columns: Sequence[str]
    ) -> Dict[str, object]:
        import pyarrow.parquet as pq

        lake = self.lake_page_source(split, columns)
        if lake is not None:
            return lake
        pf = self._file(split.table)
        schema = self._metadata.get_table_schema(split.table)
        # map the row range back onto row groups, then TRIM the read to
        # exactly [row_start, row_end) — the split contract is a row
        # range, and the worker batches scans at arbitrary boundaries
        md = pf.metadata
        groups: List[int] = []
        lo = 0
        first_lo = 0
        for rg in range(md.num_row_groups):
            n = md.row_group(rg).num_rows
            if lo < split.row_end and lo + n > split.row_start:
                if not groups:
                    first_lo = lo
                groups.append(rg)
            lo += n
        table = pf.read_row_groups(groups, columns=list(columns))
        a = split.row_start - first_lo
        b = split.row_end - first_lo
        table = table.slice(a, b - a)
        out: Dict[str, object] = {}
        for name in columns:
            arr = table.column(name)
            out[name] = _arrow_column_to_payload(arr, schema[name])
        return out

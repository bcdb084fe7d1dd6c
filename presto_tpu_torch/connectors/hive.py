"""Hive-style connector: partitioned directories of parquet files.

Reference parity: ``presto-hive``'s core read surface (SURVEY.md §2.2
"production connectors") — a table is a DIRECTORY of files, optionally
nested in ``key=value`` partition directories whose path components are
real (virtual) columns:

    root/<schema>/<table>/[<k1>=<v1>/[<k2>=<v2>/...]]part-*.parquet

The PyTorch port's copy of ``presto_tpu/connectors/hive.py``, with an
identical engine contract to the single-file parquet
connector — splits are ranges of ONE global row space (files get
contiguous ranges in sorted-path order, so the split protocol stays
format- and layout-agnostic), payloads are device-ready columns, and
partition-key columns materialize as constant dictionary/numeric
columns per file (zero bytes read for them).

Partition-key typing: a ``metastore.json`` at the connector root
declares key types per table (the reference's Hive Metastore as a
file — SURVEY.md §2.2 "metastore-backed schemas"):

    {"schemas": {"<schema>": {"<table>":
        {"partition_keys": {"year": "integer", "d": "date"}}}}}

Without a declaration the engine INFERS: a key whose every observed
value parses as an integer is BIGINT, everything else VARCHAR (a
documented fallback, matching the pre-metastore behavior).

No predicate pushdown into partition enumeration yet: partition columns
filter like ordinary columns (correct; enumeration-time pruning is a
later optimization and this SPI's splits carry no predicates).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors._arrow import (
    arrow_column_to_payload,
    arrow_to_engine_type,
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
from presto_tpu_torch.connectors.tpch import DictColumn


class _HiveFile:
    """One data file + its partition-path key values."""

    __slots__ = ("path", "keys", "row_start", "row_end", "pf")

    def __init__(self, path: str, keys: Dict[str, str]):
        self.path = path
        self.keys = keys
        self.row_start = 0
        self.row_end = 0
        self.pf = None  # lazy pyarrow.parquet.ParquetFile


def _is_int(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False


class _HiveMetadata(ConnectorMetadata):
    def __init__(self, conn: "HiveConnector"):
        self._conn = conn

    def list_schemas(self) -> List[str]:
        root = self._conn.root
        return sorted(
            d
            for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )

    def list_tables(self, schema: str) -> List[str]:
        d = os.path.join(self._conn.root, schema)
        return sorted(
            t for t in os.listdir(d) if os.path.isdir(os.path.join(d, t))
        )

    def get_table_schema(self, handle: TableHandle) -> Dict[str, T.DataType]:
        cached = self._conn._schemas.get(handle)
        if cached is not None:
            return dict(cached)
        files, part_types = self._conn._layout(handle)
        if not files:
            raise KeyError(f"hive table {handle.table} has no files")
        pf = self._conn._file(files[0])
        schema = {
            f.name: arrow_to_engine_type(f.type)
            for f in pf.schema_arrow
        }
        schema.update(part_types)
        self._conn._schemas[handle] = schema
        return dict(schema)

    def get_table_stats(self, handle: TableHandle) -> TableStats:
        files, part_types = self._conn._layout(handle)
        total = 0.0
        mins: Dict[str, float] = {}
        maxs: Dict[str, float] = {}
        for f in files:
            md = self._conn._file(f).metadata
            total += md.num_rows
            for rg in range(md.num_row_groups):
                g = md.row_group(rg)
                for ci in range(g.num_columns):
                    c = g.column(ci)
                    st = c.statistics
                    if st is None or not st.has_min_max:
                        continue
                    if not isinstance(st.min, (int, float)):
                        continue
                    name = c.path_in_schema
                    mins[name] = min(
                        mins.get(name, st.min), st.min
                    )
                    maxs[name] = max(
                        maxs.get(name, st.max), st.max
                    )
        cols = {
            name: ColumnStats(
                min_value=float(mins[name]), max_value=float(maxs[name])
            )
            for name in mins
        }
        return TableStats(row_count=total, columns=cols)


class HiveConnector(Connector):
    """Catalog over hive-layout directories of parquet files."""

    def prunes_splits(self) -> bool:
        return True  # partition-key constraints skip directories

    def __init__(self, root: str = ".", **config):
        self.root = root
        self._metadata = _HiveMetadata(self)
        self._layouts: Dict[TableHandle, tuple] = {}
        self._schemas: Dict[TableHandle, Dict[str, T.DataType]] = {}
        self._metastore = self._load_metastore()

    def _load_metastore(self) -> dict:
        """Parse ``metastore.json`` at the root (absent = empty)."""
        import json

        path = os.path.join(self.root, "metastore.json")
        if not os.path.isfile(path):
            return {}
        with open(path) as f:
            doc = json.load(f)
        return doc.get("schemas", {})

    def _declared_keys(
        self, handle: TableHandle
    ) -> Optional[Dict[str, T.DataType]]:
        """Declared partition-key types for a table, or None."""
        tbl = self._metastore.get(handle.schema, {}).get(handle.table)
        if not tbl:
            return None
        keys = tbl.get("partition_keys")
        if not keys:
            return None
        return {k: T.parse_type(v) for k, v in keys.items()}

    def metadata(self):
        return self._metadata

    def _layout(
        self, handle: TableHandle
    ) -> Tuple[List[_HiveFile], Dict[str, T.DataType]]:
        """Enumerate the table's files (sorted-path order => one stable
        global row space) + inferred partition-key types."""
        cached = self._layouts.get(handle)
        if cached is not None:
            return cached
        base = os.path.join(self.root, handle.schema, handle.table)
        if not os.path.isdir(base):
            raise KeyError(f"no hive table directory at {base}")
        files: List[_HiveFile] = []
        key_values: Dict[str, List[str]] = {}
        for dirpath, _dirnames, filenames in sorted(os.walk(base)):
            rel = os.path.relpath(dirpath, base)
            keys: Dict[str, str] = {}
            if rel != ".":
                for comp in rel.split(os.sep):
                    if "=" not in comp:
                        raise ValueError(
                            f"non-partition directory {comp!r} under "
                            f"{base} (expected key=value)"
                        )
                    k, v = comp.split("=", 1)
                    keys[k] = v
            for fn in sorted(filenames):
                if fn.endswith(".parquet"):
                    f = _HiveFile(os.path.join(dirpath, fn), keys)
                    files.append(f)
                    for k, v in keys.items():
                        key_values.setdefault(k, []).append(v)
        lo = 0
        for f in files:
            n = self._file(f).metadata.num_rows
            f.row_start, f.row_end = lo, lo + n
            lo += n
        declared = self._declared_keys(handle)
        if declared is not None:
            # metastore wins: strict agreement between declaration and
            # the on-disk layout (like the reference failing a table
            # whose partitions don't match the metastore)
            if set(declared) != set(key_values) and key_values:
                raise ValueError(
                    f"metastore declares partition keys "
                    f"{sorted(declared)} but the layout under {base} "
                    f"has {sorted(key_values)}"
                )
            part_types = dict(declared)
        else:
            part_types = {
                k: (
                    T.BIGINT
                    if all(_is_int(v) for v in vs)
                    else T.VARCHAR
                )
                for k, vs in key_values.items()
            }
        # mixed-depth layouts (a file missing a key seen elsewhere)
        # fail HERE with a layout error, not mid-scan with a KeyError
        for f in files:
            missing = set(part_types) - set(f.keys)
            if missing:
                raise ValueError(
                    f"hive layout error: {f.path} lacks partition "
                    f"key(s) {sorted(missing)} present elsewhere "
                    f"under {base}"
                )
        self._layouts[handle] = (files, part_types)
        return files, part_types

    def _file(self, f: _HiveFile):
        import pyarrow.parquet as pq

        if f.pf is None:
            f.pf = pq.ParquetFile(f.path)
        return f.pf

    def get_splits(
        self,
        handle: TableHandle,
        target_split_rows: int = 1 << 20,
        constraint=(),
    ) -> SplitSource:
        """File-aligned splits over the global row space (big files
        split further at row-group-sized boundaries). PARTITION
        PRUNING: files whose path key values fall outside the pushed
        constraint produce no splits at all — zero bytes read for
        excluded partitions (reference: TupleDomain reaching the hive
        split manager)."""
        files, part_types = self._layout(handle)
        # a column may carry SEVERAL domains (planner value set AND a
        # dynamic-filter RangeSet): a file must satisfy all of them
        domains: List[Tuple[str, object]] = [
            (col, vals if isinstance(vals, RangeSet) else set(vals))
            for col, vals in constraint
            if col in part_types
        ]
        splits: List[ConnectorSplit] = []
        for f in files:
            if not all(
                _key_matches(f.keys[col], part_types[col], vals)
                for col, vals in domains
            ):
                continue
            lo = f.row_start
            while lo < f.row_end:
                hi = min(lo + target_split_rows, f.row_end)
                splits.append(ConnectorSplit(handle, lo, hi))
                lo = hi
        if not splits:
            splits.append(ConnectorSplit(handle, 0, 0))
        return SplitSource(splits)

    def create_page_source(
        self, split: ConnectorSplit, columns: Sequence[str]
    ) -> Dict[str, object]:
        import bisect

        files, part_types = self._layout(split.table)
        schema = self._metadata.get_table_schema(split.table)
        out: Dict[str, List] = {name: [] for name in columns}
        # files hold contiguous sorted ranges: bisect to the first
        # overlapping file instead of scanning all of them per split
        starts = [f.row_start for f in files]
        i = max(bisect.bisect_right(starts, split.row_start) - 1, 0)
        for f in files[i:]:
            if f.row_start >= split.row_end:
                break
            lo = max(split.row_start, f.row_start)
            hi = min(split.row_end, f.row_end)
            if lo >= hi:
                continue
            self._append_file_range(
                f, lo - f.row_start, hi - f.row_start, columns,
                schema, part_types, out,
            )
        return {
            name: _concat_payloads(parts, schema[name])
            for name, parts in out.items()
        }

    def _append_file_range(
        self, f, lo, hi, columns, schema, part_types, out
    ):
        pf = self._file(f)
        file_cols = [c for c in columns if c not in part_types]
        table = None
        if file_cols:
            md = pf.metadata
            groups, first_lo, acc = [], 0, 0
            for rg in range(md.num_row_groups):
                n = md.row_group(rg).num_rows
                if acc < hi and acc + n > lo:
                    if not groups:
                        first_lo = acc
                    groups.append(rg)
                acc += n
            table = pf.read_row_groups(groups, columns=file_cols)
            table = table.slice(lo - first_lo, hi - lo)
        for name in columns:
            if name in part_types:
                out[name].append(
                    _const_column(
                        f.keys[name], part_types[name], hi - lo
                    )
                )
            else:
                out[name].append(
                    arrow_column_to_payload(
                        table.column(name), schema[name]
                    )
                )

    # hive partition values come from the PATH: one constant per file


def _key_matches(raw: str, t: T.DataType, allowed) -> bool:
    """Does a path key value satisfy a pushed constraint domain —
    a value set, or a dynamic-filter :class:`RangeSet` (inclusive
    numeric bounds)? BIGINT keys compare numerically — including
    string-carried integer literals (the planner's IN-list coercion
    keeps '2024' as str); anything unparseable keeps the file
    (over-retain, never over-prune: the filter still applies)."""
    if isinstance(allowed, RangeSet):
        if t.name == "bigint":
            try:
                return allowed.lo <= int(raw) <= allowed.hi
            except (TypeError, ValueError):
                return True  # can't interpret: don't prune on it
        # string/date/decimal path keys: no safe numeric ordering of
        # the raw text — over-retain
        return True
    if t.name == "bigint":
        out = False
        for v in allowed:
            try:
                if int(str(v)) == int(raw):
                    return True
            except (TypeError, ValueError):
                return True  # can't interpret: don't prune on it
        return out
    if t.is_string:
        return str(raw) in {str(v) for v in allowed}
    # date/decimal keys: constraint values are engine-internal units
    # (epoch days, unscaled ints) while path values are text — skip
    # enumeration-time pruning (over-retain; the filter still applies)
    return True


def _const_column(value: str, t: T.DataType, n: int):
    if t.is_string:
        return DictColumn(
            ids=np.zeros(n, np.int32),
            values=np.asarray([value], dtype=object),
        )
    if t.name == "date":
        import datetime

        days = (
            datetime.date.fromisoformat(value)
            - datetime.date(1970, 1, 1)
        ).days
        return np.full(n, days, dtype=np.int64)
    if t.is_decimal:
        from decimal import Decimal

        unscaled = int(
            (Decimal(value) * (10 ** t.scale)).to_integral_value()
        )
        return np.full(n, unscaled, dtype=np.int64)
    return np.full(n, int(value), dtype=np.int64)


def _concat_payloads(parts: List, t: T.DataType):
    """Concatenate per-file payload chunks into one column payload
    (dictionary union + id remap lives in the shared staging helper)."""
    from presto_tpu_torch.exec.staging import merge_column_chunks

    return merge_column_chunks(parts, dtype=t)

"""ORC connector: stripe-organized columnar files as queryable tables.

Reference parity: ``presto-orc`` (SURVEY.md §2.2 L9 "file-format
readers") — column-pruned reads with stripe-aligned splits, the second
of the two columnar formats the reference treats as first-class. The
engine-facing contract is identical to the parquet connector's: splits
are row ranges, payloads are device-ready numpy columns
(``connectors/_arrow.py``), so everything above the SPI is
format-agnostic.

The PyTorch port's copy of ``presto_tpu/connectors/orc.py``: like
parquet, strings leave the reader already dictionary-encoded and
numerics in native representation; the device only ever sees
fixed-width tensors.

Layout: ``root/<schema>/<table>.orc``.

Implementation notes: pyarrow's ORC reader exposes stripe count but not
per-stripe row counts, so stripe row offsets are probed once per file
by reading the narrowest column of each stripe (cheap: one column,
decoded once, then cached). File-footer column statistics are not
exposed by pyarrow's ORC bindings at all, so ``get_table_stats``
returns the row count only — the optimizer falls back to its default
selectivities, exactly as it does for any stats-less connector.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors._arrow import (
    arrow_column_to_payload,
    arrow_to_engine_type,
)
from presto_tpu_torch.connectors.spi import (
    Connector,
    ConnectorMetadata,
    ConnectorSplit,
    SplitSource,
    TableHandle,
    TableStats,
)
from presto_tpu_torch.server.manifests import LakehouseConnectorMixin


class _OrcMetadata(ConnectorMetadata):
    def __init__(self, conn: "OrcConnector"):
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
                fn[: -len(".orc")]
                for fn in os.listdir(d)
                if fn.endswith(".orc")
            )
        except OSError:
            pass
        return sorted(out)

    def get_table_schema(self, handle: TableHandle) -> Dict[str, T.DataType]:
        lake = self._conn.lake_schema(handle)
        if lake is not None:
            return lake
        f = self._conn._file(handle)
        schema = f.schema
        return {
            schema.field(i).name: arrow_to_engine_type(schema.field(i).type)
            for i in range(len(schema.names))
        }

    def get_table_stats(self, handle: TableHandle) -> TableStats:
        # row count from the ORC footer; pyarrow exposes no per-column
        # min/max for ORC (see module docstring). Manifest-backed
        # tables DO get min/max — the manifest carries them
        lake = self._conn.lake_table_stats(handle)
        if lake is not None:
            return lake
        f = self._conn._file(handle)
        return TableStats(row_count=float(f.nrows), columns={})


class OrcConnector(LakehouseConnectorMixin, Connector):
    """Catalog over ``root/<schema>/<table>.orc`` files, plus
    manifest-backed snapshot tables when ``lakehouse`` is set."""

    def prunes_splits(self) -> bool:
        return True  # per-stripe min/max prune splits

    def __init__(
        self,
        root: str = ".",
        lakehouse: Optional[str] = None,
        catalog: Optional[str] = None,
        target_file_bytes: Optional[int] = None,
        **config,
    ):
        self.root = root
        self._init_lakehouse(
            lakehouse, catalog=catalog,
            target_file_bytes=target_file_bytes,
        )
        self._metadata = _OrcMetadata(self)
        self._files: Dict[TableHandle, object] = {}
        self._offsets: Dict[TableHandle, List[int]] = {}
        #: lazily-probed per-stripe (min, max) of numeric columns —
        #: pyarrow exposes NO ORC column statistics, so the first
        #: range-constrained enumeration reads the column once (the
        #: same probe-and-cache discipline as _stripe_offsets) and
        #: every later query prunes stripes for free
        self._stripe_stats: Dict[tuple, List] = {}

    def metadata(self):
        return self._metadata

    def _path(self, handle: TableHandle) -> str:
        return os.path.join(
            self.root, handle.schema, handle.table + ".orc"
        )

    def _file(self, handle: TableHandle):
        from pyarrow import orc

        f = self._files.get(handle)
        if f is None:
            path = self._path(handle)
            if not os.path.exists(path):
                raise KeyError(f"no ORC table at {path}")
            f = orc.ORCFile(path)
            self._files[handle] = f
        return f

    def _stripe_offsets(self, handle: TableHandle) -> List[int]:
        """Cumulative stripe row offsets ``[0, n0, n0+n1, ...]``, probed
        once by reading each stripe's narrowest column (pyarrow has no
        stripe-row metadata accessor; ``columns=[]`` reads zero rows)."""
        offs = self._offsets.get(handle)
        if offs is None:
            f = self._file(handle)
            probe = _narrowest_column(f.schema)
            offs = [0]
            for i in range(f.nstripes):
                offs.append(
                    offs[-1]
                    + f.read_stripe(i, columns=[probe]).num_rows
                )
            if offs[-1] != f.nrows:  # pragma: no cover - corrupt file
                raise IOError(
                    f"ORC stripe rows {offs[-1]} != footer rows {f.nrows}"
                )
            self._offsets[handle] = offs
        return offs

    def _stripe_minmax(self, handle: TableHandle, col: str):
        """Per-stripe (min, max) of one numeric column, probed once by
        reading just that column per stripe and cached (ORC footers
        carry these stats but pyarrow does not expose them). Entries
        are None when a stripe has no non-null values."""
        key = (handle, col)
        cached = self._stripe_stats.get(key)
        if cached is not None:
            return cached
        import numpy as np

        f = self._file(handle)
        out: List = []
        for i in range(f.nstripes):
            arr = f.read_stripe(i, columns=[col]).column(col)
            vals = arr.to_numpy(zero_copy_only=False)
            vals = vals[~_isnan_or_none(vals)]
            if len(vals) == 0:
                out.append(None)
            else:
                out.append((_pynum(np.min(vals)), _pynum(np.max(vals))))
        self._stripe_stats[key] = out
        return out

    def get_splits(
        self, handle: TableHandle, target_split_rows: int = 1 << 20,
        constraint=(),
    ) -> SplitSource:
        """Stripe-aligned splits (the reference's ORC split boundary),
        expressed as row ranges so the split protocol stays
        format-agnostic. Dynamic-filter :class:`RangeSet` constraints
        on numeric columns prune whole stripes against the (lazily
        probed, cached) per-stripe min/max — excluded stripes are
        never decoded again."""
        from presto_tpu_torch.connectors.spi import RangeSet

        lake = self.lake_splits(handle, target_split_rows, constraint)
        if lake is not None:
            return lake
        offs = self._stripe_offsets(handle)
        total = offs[-1]
        n_stripes = len(offs) - 1
        keep = [True] * n_stripes
        schema = self._metadata.get_table_schema(handle)
        for col, dom in constraint:
            if not isinstance(dom, RangeSet) or n_stripes == 0:
                continue
            t = schema.get(col)
            # plain numeric columns only: dates decode as datetime64
            # and decimals as Decimal objects — neither compares with
            # the RangeSet's native-repr ints (over-retain instead)
            if (
                t is None
                or t.name not in ("bigint", "integer", "double", "real")
                or not isinstance(dom.lo, (int, float))
            ):
                continue
            try:
                stats = self._stripe_minmax(handle, col)
            except Exception:
                continue  # unreadable probe: don't prune on it
            for i, mm in enumerate(stats):
                if mm is None:
                    keep[i] = False  # all-null stripe: no key matches
                elif mm[1] < dom.lo or mm[0] > dom.hi:
                    keep[i] = False
        from presto_tpu_torch.connectors.spi import coalesce_kept_chunks

        chunk_rows = [
            offs[i + 1] - offs[i] for i in range(n_stripes)
        ]
        return SplitSource(
            coalesce_kept_chunks(
                handle, chunk_rows, keep, target_split_rows
            )
        )

    def create_page_source(
        self, split: ConnectorSplit, columns: Sequence[str]
    ) -> Dict[str, object]:
        import pyarrow as pa

        lake = self.lake_page_source(split, columns)
        if lake is not None:
            return lake
        f = self._file(split.table)
        schema = self._metadata.get_table_schema(split.table)
        offs = self._stripe_offsets(split.table)
        # map the row range onto stripes, then TRIM to exactly
        # [row_start, row_end) — workers batch scans at arbitrary
        # boundaries, not just stripe edges
        batches = []
        first_lo = None
        for i in range(len(offs) - 1):
            lo, hi = offs[i], offs[i + 1]
            if lo < split.row_end and hi > split.row_start:
                if first_lo is None:
                    first_lo = lo
                batches.append(f.read_stripe(i, columns=list(columns)))
        if not batches:
            # empty table (0 stripes) or empty range: typed empty arrays
            # (null-typed ones poison arrow_column_to_payload's fill_null)
            arrow_types = {
                f.schema.field(i).name: f.schema.field(i).type
                for i in range(len(f.schema.names))
            }
            table = pa.table(
                {c: pa.array([], type=arrow_types[c]) for c in columns}
            )
            first_lo = split.row_start
        else:
            table = pa.Table.from_batches(batches)
        a = split.row_start - first_lo
        b = split.row_end - first_lo
        table = table.slice(a, b - a)
        out: Dict[str, object] = {}
        for name in columns:
            arr = table.column(name)
            out[name] = arrow_column_to_payload(arr, schema[name])
        return out


def _isnan_or_none(vals):
    """Null mask of a to_numpy'd arrow column (object None / float NaN)."""
    import numpy as np

    if vals.dtype == object:
        return np.asarray([v is None for v in vals], bool)
    if vals.dtype.kind == "f":
        return np.isnan(vals)
    return np.zeros(len(vals), bool)


def _pynum(v):
    """numpy scalar -> exact python number (stats cache entries)."""
    import numpy as np

    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, (np.integer, int)):
        return int(v)
    raise ValueError(f"non-numeric stripe stat {type(v).__name__}")


_WIDTHS = {
    "bool": 1, "int8": 1, "int16": 2, "int32": 4, "float": 4,
    "date32[day]": 4, "int64": 8, "double": 8,
}


def _narrowest_column(schema) -> str:
    """Cheapest column to decode when probing stripe row counts."""
    best, best_w = schema.names[0], 1 << 30
    for i, name in enumerate(schema.names):
        w = _WIDTHS.get(str(schema.field(i).type), 16)
        if w < best_w:
            best, best_w = name, w
    return best

"""In-memory writable connector: a copy of the reference's
``presto_tpu/connectors/memory.py``. Tables load through
``create_table``/``append_rows`` (object arrays of Python values: lists,
dicts and row dicts for nested columns, ``decimal.Decimal`` for long
decimals) or through the runner's write statements.

In-memory writable connector (reference: ``presto-memory``,
SURVEY.md §2.2 — the writable test fixture), extended with the
snapshot SPI of the streaming-ingest lane (Iceberg-style snapshot
reads, the declared SPI long-tail of COMPONENTS.md §2.2).

Snapshot model: ingest tables are APPEND-ONLY, so a committed snapshot
is just a prefix length — ``snapshot id -> row count``. Appends build
NEW concatenated column arrays (the old tuple is never mutated), so
rows ``[0, n)`` are identical in every later version and a pinned
reader slicing within its snapshot's row count always sees exactly the
committed prefix, never a torn batch. Snapshot ids are MINTED by the
ingest lane (``server/ingest.py``, where the WAL commit frame makes
them durable — the ``ingest-frames`` analysis rule confines minting
there); this connector only stores and serves them. Tables written
through the legacy INSERT/CTAS/DELETE path never gain snapshots and
behave bit-exactly as before; a destructive write (``replace_rows``,
``drop_table``) on a versioned table drops its snapshot history — the
prefix property no longer holds."""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, Optional, Sequence

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.spi import (
    Connector,
    ConnectorMetadata,
    ConnectorSplit,
    SplitSource,
    TableHandle,
    TableStats,
)


class _MemMetadata(ConnectorMetadata):
    def __init__(self, store):
        self._store = store

    def list_schemas(self):
        return sorted({s for s, _ in self._store.tables})

    def list_tables(self, schema):
        return sorted(t for s, t in self._store.tables if s == schema)

    def get_table_schema(self, handle: TableHandle):
        key = (handle.schema, handle.table)
        if key not in self._store.tables:
            raise KeyError(f"table not found: {handle.schema}.{handle.table}")
        return dict(self._store.tables[key][0])

    def get_table_stats(self, handle: TableHandle):
        key = (handle.schema, handle.table)
        schema, data = self._store.tables[key]
        n = len(next(iter(data.values()))) if data else 0
        # a pinned handle's cardinality is its snapshot's prefix, not
        # the live row count (the optimizer and the ranged scheduler
        # both size work off these stats)
        snap = self._store.snapshots.get(key)
        if handle.snapshot is not None and snap:
            n = min(n, snap.get(handle.snapshot, n))
        return TableStats(row_count=float(n))


class _Store:
    def __init__(self):
        self.tables: Dict[tuple, tuple] = {}  # (schema, table) -> (schema, cols)
        #: (schema, table) -> OrderedDict{snapshot id -> committed row
        #: count}, insertion order = commit order (the last entry is
        #: the tip). Only the ingest lane populates this.
        self.snapshots: Dict[tuple, "OrderedDict[int, int]"] = {}


class MemoryConnector(Connector):
    def __init__(self, **config):
        self._store = _Store()
        self._metadata = _MemMetadata(self._store)
        # serializes snapshot registration against pinning (appends
        # themselves are atomic tuple swaps under the GIL)
        self._snap_mu = threading.Lock()

    def metadata(self):
        return self._metadata

    def supports_writes(self):
        return True

    def create_table(self, handle: TableHandle, schema: Dict[str, T.DataType]):
        # recreation is destructive like replace_rows/drop_table: any
        # snapshot history of the old incarnation must not resolve
        # against the new table's unrelated rows
        with self._snap_mu:
            self._store.snapshots.pop((handle.schema, handle.table), None)
        # empty columns from the start: a never-inserted table must
        # still scan (zero rows), e.g. NOT IN (SELECT ... FROM empty)
        self._store.tables[(handle.schema, handle.table)] = (
            dict(schema),
            {c: np.empty(0, dtype=object) for c in schema},
        )

    def append_rows(self, handle: TableHandle, data: Dict[str, np.ndarray]):
        key = (handle.schema, handle.table)
        schema, existing = self._store.tables[key]
        from presto_tpu_torch.exec.staging import obj_array

        merged = {}
        for col in schema:
            new = obj_array(data[col])
            merged[col] = (
                np.concatenate([existing[col], new]) if existing else new
            )
        self._store.tables[key] = (schema, merged)

    def drop_table(self, handle: TableHandle) -> bool:
        with self._snap_mu:
            self._store.snapshots.pop((handle.schema, handle.table), None)
        return (
            self._store.tables.pop(
                (handle.schema, handle.table), None
            )
            is not None
        )

    def replace_rows(
        self, handle: TableHandle, data: Dict[str, np.ndarray]
    ):
        """Overwrite the table's contents (the DELETE path keeps the
        complement and replaces wholesale). Destroys the append-only
        prefix property, so any snapshot history is dropped — the
        table degrades to legacy unversioned reads."""
        key = (handle.schema, handle.table)
        schema, _ = self._store.tables[key]
        from presto_tpu_torch.exec.staging import obj_array

        with self._snap_mu:
            self._store.snapshots.pop(key, None)
        self._store.tables[key] = (
            schema,
            {c: obj_array(data[c]) for c in schema},
        )

    # ------------------------------------------------------ snapshot SPI

    def commit_snapshot(
        self,
        handle: TableHandle,
        data: Dict[str, np.ndarray],
        snapshot_id: int,
    ) -> int:
        """Fold one committed ingest delta into the table and register
        ``snapshot_id`` at the resulting row count. The id is minted by
        the ingest lane (its WAL commit frame is the durability point);
        ids must arrive in increasing order per table. Returns the
        snapshot's row count."""
        key = (handle.schema, handle.table)
        if any(len(v) for v in data.values()):
            self.append_rows(handle, data)
        _schema, cols = self._store.tables[key]
        n = len(next(iter(cols.values()))) if cols else 0
        with self._snap_mu:
            self._store.snapshots.setdefault(key, OrderedDict())[
                int(snapshot_id)
            ] = n
        return n

    def restore_snapshots(
        self, handle: TableHandle, pairs
    ) -> None:
        """Re-register historical ``(snapshot id, row count)`` pairs
        recovered from a durable manifest chain (restart restore) —
        time travel over the append-only prefix survives the process.
        Counts are clamped to the live rows; ids merge in ascending
        order with whatever the restore already committed."""
        key = (handle.schema, handle.table)
        entry = self._store.tables.get(key)
        if entry is None:
            return
        _schema, cols = entry
        live = len(next(iter(cols.values()))) if cols else 0
        with self._snap_mu:
            snaps = self._store.snapshots.setdefault(
                key, OrderedDict()
            )
            merged = dict(snaps)
            for sid, n in pairs:
                merged[int(sid)] = min(int(n), live)
            snaps.clear()
            for sid in sorted(merged):
                snaps[sid] = merged[sid]

    def current_snapshot_id(self, handle: TableHandle) -> Optional[int]:
        with self._snap_mu:
            snaps = self._store.snapshots.get(
                (handle.schema, handle.table)
            )
            if not snaps:
                return None
            return next(reversed(snaps))

    def pin_snapshot(self, handle: TableHandle) -> TableHandle:
        """Pin the tip snapshot when the table is versioned AND the tip
        still covers the live contents. A table that also took legacy
        (unversioned) appends since its last commit serves unpinned —
        legacy writes keep their read-your-writes semantics, and
        isolation resumes at the next ingest commit."""
        key = (handle.schema, handle.table)
        if handle.snapshot is not None:
            # an EXPLICIT pin (FOR VERSION AS OF) must resolve to a
            # committed snapshot — an unknown id would silently serve
            # the live table as if it were history
            with self._snap_mu:
                snaps = self._store.snapshots.get(key)
                if snaps is None or handle.snapshot not in snaps:
                    raise KeyError(
                        f"snapshot {handle.snapshot} is not available "
                        f"for {handle.schema}.{handle.table}"
                    )
            return handle
        with self._snap_mu:
            snaps = self._store.snapshots.get(key)
            if not snaps:
                return handle
            sid = next(reversed(snaps))
            tip_rows = snaps[sid]
        entry = self._store.tables.get(key)
        if entry is None:
            return handle
        _schema, cols = entry
        live = len(next(iter(cols.values()))) if cols else 0
        if live != tip_rows:
            return handle
        return dataclasses.replace(handle, snapshot=sid)

    def _visible_rows(self, handle: TableHandle, live: int) -> int:
        """Row count a handle may see: its pinned snapshot's prefix, or
        the live count when unpinned (or the pinned id is unknown — a
        destructive write cleared the history; serving live is the
        documented degradation, never an error)."""
        if handle.snapshot is None:
            return live
        with self._snap_mu:
            snaps = self._store.snapshots.get(
                (handle.schema, handle.table)
            )
            if snaps is None:
                return live
            return min(live, snaps.get(handle.snapshot, live))

    def get_splits(self, handle: TableHandle, target_split_rows: int = 1 << 20, constraint=()):
        schema, data = self._store.tables[(handle.schema, handle.table)]
        n = len(next(iter(data.values()))) if data else 0
        n = self._visible_rows(handle, n)
        # splits carry the (possibly pinned) handle, so page sources
        # and the staged-page cache key on the exact version they read
        splits = [
            ConnectorSplit(handle, lo, min(lo + target_split_rows, n))
            for lo in range(0, n, target_split_rows)
        ] or [ConnectorSplit(handle, 0, 0)]
        return SplitSource(splits)

    def create_page_source(self, split: ConnectorSplit, columns: Sequence[str]):
        schema, data = self._store.tables[
            (split.table.schema, split.table.table)
        ]
        # clamp to the pinned snapshot's prefix: a split minted before
        # a commit must not widen into rows appended after its pin
        n = len(next(iter(data.values()))) if data else 0
        hi = min(split.row_end, self._visible_rows(split.table, n))
        return {c: data[c][split.row_start : hi] for c in columns}

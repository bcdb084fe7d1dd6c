"""Connector SPI: the engine <-> data-source contract.

Reference parity: ``presto-spi`` interfaces — ``ConnectorMetadata`` (table
/schema resolution, statistics), ``ConnectorSplitManager`` (split
enumeration), ``ConnectorPageSourceProvider`` (split -> pages) — SURVEY.md
§2.2. Pushdown surface kept minimal for round 1: column pruning (the
``columns`` argument) and row-range splits; constraint/limit pushdown are
later rounds.

TPU-first note: a page source yields *host* columnar data (numpy) plus
type metadata; the execution layer stages it into device Pages at the
fragment boundary (SURVEY.md §7 step 1 "host-side encode/decode").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from presto_tpu_torch import types as T


@dataclasses.dataclass(frozen=True)
class TableHandle:
    """Opaque engine-side reference to a connector table.

    ``snapshot`` pins a committed table version for snapshot-capable
    connectors (the streaming-ingest lane, ``server/ingest.py``):
    None = the live/current contents (every pre-snapshot handle).
    The snapshot participates in equality/hash on purpose — staged
    pages of different versions must never share a cache entry — so
    cache *invalidation* matches on :attr:`table_key` instead."""

    catalog: str
    schema: str
    table: str
    snapshot: Optional[int] = None

    @property
    def table_key(self) -> tuple:
        """Version-blind identity: (catalog, schema, table). The match
        key for write-path cache invalidation, which must drop every
        snapshot's entries of a written table."""
        return (self.catalog, self.schema, self.table)


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """Per-column statistics for the cost-based optimizer (reference:
    ConnectorTableStatistics / StatsCalculator inputs)."""

    distinct_count: Optional[float] = None
    min_value: Optional[float] = None
    max_value: Optional[float] = None
    null_fraction: float = 0.0


@dataclasses.dataclass(frozen=True)
class TableStats:
    row_count: Optional[float] = None
    columns: Dict[str, ColumnStats] = dataclasses.field(default_factory=dict)
    # declared key (possibly composite) with at most one row per value
    primary_key: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class RangeSet:
    """TupleDomain-lite RANGE domain for ``get_splits`` constraints:
    the column's allowed values lie in the inclusive ``[lo, hi]``
    interval (native engine representation — unscaled ints for
    decimals, epoch days for dates). Connectors MAY use it to skip
    splits whose min/max statistics fall wholly outside the range
    (parquet row groups, ORC stripes, hive partition keys); ignoring
    it is always correct — the originating filter still applies.
    Produced by the dynamic-filter plane (``exec/dynfilter.py``)."""

    lo: object
    hi: object


@dataclasses.dataclass(frozen=True)
class ConnectorSplit:
    """One unit of scan parallelism (reference: ConnectorSplit).

    Row-range based: [row_start, row_end) of the table's row space.
    ``addresses`` is the locality hint for the scheduler."""

    table: TableHandle
    row_start: int
    row_end: int
    addresses: Sequence[str] = ()

    @property
    def num_rows(self) -> int:
        return self.row_end - self.row_start


def coalesce_kept_chunks(
    handle: TableHandle,
    chunk_rows: Sequence[int],
    keep: Sequence[bool],
    target_split_rows: int,
) -> List[ConnectorSplit]:
    """Build row-range splits from a table's physical chunks (parquet
    row groups, ORC stripes) after constraint pruning: consecutive
    KEPT chunks coalesce into one split, a pruned chunk closes the
    open split (its rows are never covered), and splits close at
    ``target_split_rows``. An all-pruned (or empty) table yields the
    canonical zero-row sentinel split. The ONE coalescing loop both
    file connectors share — its start-sentinel boundary logic is easy
    to get subtly wrong twice."""
    splits: List[ConnectorSplit] = []
    start: Optional[int] = None
    acc = 0
    for n, kept in zip(chunk_rows, keep):
        if not kept:
            if start is not None and acc > start:
                splits.append(ConnectorSplit(handle, start, acc))
            start = None
            acc += n
            continue
        if start is None:
            start = acc
        acc += n
        if acc - start >= target_split_rows:
            splits.append(ConnectorSplit(handle, start, acc))
            start = acc
    if start is not None and (acc > start or not splits):
        splits.append(ConnectorSplit(handle, start, acc))
    if not splits:
        splits.append(ConnectorSplit(handle, 0, 0))
    return splits


class SplitSource:
    """Batched split enumeration (reference: SplitSource.getNextBatch)."""

    def __init__(self, splits: List[ConnectorSplit]):
        self._splits = splits
        self._pos = 0

    def next_batch(self, max_size: int) -> List[ConnectorSplit]:
        batch = self._splits[self._pos : self._pos + max_size]
        self._pos += len(batch)
        return batch

    @property
    def exhausted(self) -> bool:
        return self._pos >= len(self._splits)


class ConnectorMetadata:
    def list_schemas(self) -> List[str]:
        raise NotImplementedError

    def list_tables(self, schema: str) -> List[str]:
        raise NotImplementedError

    def get_table_schema(self, handle: TableHandle) -> Dict[str, T.DataType]:
        raise NotImplementedError

    def get_table_stats(self, handle: TableHandle) -> TableStats:
        return TableStats()


def payload_len(col) -> int:
    """Row count of one SPI column payload (ndarray, DictColumn, or
    MaskedColumn)."""
    if hasattr(col, "ids"):
        return len(col.ids)
    if hasattr(col, "data"):
        return len(col.data)
    return len(col)


class Connector:
    """One mounted catalog (reference: Connector from ConnectorFactory)."""

    def cacheable(self) -> bool:
        """False for live introspection sources (system tables) whose
        staged pages must not be reused across queries."""
        return True

    def coordinator_only(self) -> bool:
        """True when this catalog's data lives only in the coordinator
        process (system.runtime.*): the scheduler must not ship its
        scans to workers, whose copies of the tables are empty."""
        return False

    def prunes_splits(self) -> bool:
        """True when this connector USES scan constraints to skip
        splits (hive partition pruning, parquet row-group / ORC stripe
        stats). Statements over such catalogs bypass the statement-
        level plan cache: a cached parameterized plan blocks constraint
        extraction from equality/IN literals, which would silently cost
        these connectors their pruning. Connectors that ignore
        constraints (the default) keep full plan-cache sharing."""
        return False

    def metadata(self) -> ConnectorMetadata:
        raise NotImplementedError

    def pin_snapshot(self, handle: TableHandle) -> TableHandle:
        """Resolve ``handle`` to a pinned committed version for the
        duration of one plan (Iceberg-style snapshot reads): the
        planner calls this once per table scan, so every split, staged
        page, and capacity retry of the plan reads ONE immutable
        version — long scans are isolated from concurrent ingest
        commits. The default (and any connector without versioned
        tables) returns the handle unchanged: reads keep the live
        contents, bit-exact pre-snapshot behavior."""
        return handle

    def get_splits(
        self,
        handle: TableHandle,
        target_split_rows: int = 1 << 20,
        constraint: Sequence = (),
    ) -> SplitSource:
        """Enumerate splits. ``constraint`` is TupleDomain-lite advice
        from the planner — (column, allowed-values) pairs a connector
        MAY use to skip splits (hive partition pruning); the engine
        still applies the originating filter, so ignoring it is always
        correct (and the default implementations do)."""
        raise NotImplementedError

    def create_page_source(
        self, split: ConnectorSplit, columns: Sequence[str]
    ) -> Dict[str, np.ndarray]:
        """Produce host columnar data for a split, pruned to ``columns``.

        Returns {column -> numpy array}; None entries in object arrays
        mark SQL NULLs. (Reference: ConnectorPageSource.getNextPage.)"""
        raise NotImplementedError

    # -- write path (optional; reference: ConnectorPageSink) --------------

    def supports_writes(self) -> bool:
        return False

    def create_table(self, handle: TableHandle, schema: Dict[str, T.DataType]):
        raise NotImplementedError(f"{type(self).__name__} is read-only")

    def append_rows(self, handle: TableHandle, data: Dict[str, np.ndarray]):
        raise NotImplementedError(f"{type(self).__name__} is read-only")

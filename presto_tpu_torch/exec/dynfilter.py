"""Dynamic-filter plane: build-side runtime filters for probe scans.

The PyTorch counterpart of ``presto_tpu/exec/dynfilter.py``: runtime
filters collected from a join's BUILD side flow into the PROBE side at
execution time, pruning rows — and, through the connector constraint,
whole splits — that can never find a join partner.

Host summaries (the server's distributed plane): :class:`ColumnFilter`
and :class:`FilterSummary` (per-key min/max in the key's NATIVE dtype,
plus an NDV-capped distinct set, dictionary strings as VALUES), their
merge and JSON wire form, :func:`summarize_page` over a worker's batch
output, and the conversions :func:`to_predicate` (a probe-side
``FilterNode(dynamic=True)`` predicate) and :func:`to_constraint`
(a TupleDomain-lite constraint for ``Connector.get_splits``).

Device summaries (the local stage-at-a-time executor):
:func:`device_conjuncts` reads a device-resident build page's bounds
(a widening cast could round a float bound or wrap an integer fill and
drop real matches) or, for a dictionary string key with a small
dictionary, its present values. Both producers read the device in ONE
batched host copy (``page.to_host``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from presto_tpu_torch import expr as E
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.spi import RangeSet
from presto_tpu_torch.page import Page, to_host

#: default NDV cap for the distinct-set (IN-list) form; above it only
#: min/max bounds are kept (session ``dynamic_filtering_ndv_limit``)
DEFAULT_NDV_LIMIT = 64

_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)


@dataclasses.dataclass(frozen=True)
class ColumnFilter:
    """Value-domain summary of ONE build-side join key column.

    ``lo``/``hi`` are inclusive bounds in the column's native engine
    representation (unscaled ints for decimals, epoch days for dates);
    None = unbounded/unknown. ``values`` is the small distinct set when
    build NDV was at or below the limit (strings as str, numerics in
    native repr); None = NDV too high, bounds only. ``empty`` marks a
    build side with zero (valid) rows — nothing can match."""

    column: str
    lo: Optional[object] = None
    hi: Optional[object] = None
    values: Optional[Tuple] = None
    empty: bool = True

    def merge(self, other: "ColumnFilter", ndv_limit: int) -> "ColumnFilter":
        """Union of two partial summaries of the same column: bounds
        widen, distinct sets union (dropped past the NDV limit), empty
        only when both sides were empty."""
        if self.empty:
            return other
        if other.empty:
            return self
        lo = hi = None
        if self.lo is not None and other.lo is not None:
            lo, hi = min(self.lo, other.lo), max(self.hi, other.hi)
        values = None
        if self.values is not None and other.values is not None:
            u = set(self.values) | set(other.values)
            if len(u) <= ndv_limit:
                values = tuple(sorted(u))
        return ColumnFilter(
            column=self.column, lo=lo, hi=hi, values=values, empty=False
        )

    def to_json(self) -> dict:
        return {
            "column": self.column,
            "lo": self.lo,
            "hi": self.hi,
            "values": list(self.values) if self.values is not None else None,
            "empty": self.empty,
        }

    @staticmethod
    def from_json(d: dict) -> "ColumnFilter":
        vals = d.get("values")
        return ColumnFilter(
            column=d["column"],
            lo=d.get("lo"),
            hi=d.get("hi"),
            values=tuple(vals) if vals is not None else None,
            empty=bool(d.get("empty")),
        )


@dataclasses.dataclass(frozen=True)
class FilterSummary:
    """Per-key summaries of one build side (aligned with the join's
    build-key list).

    ``rows`` is the OBSERVED build cardinality the summarized pages
    covered (-1 = unknown, e.g. a summary deserialized from an older
    wire form). Partials sum under :meth:`merge`, so the coordinator's
    merged summary reports the build side's true row count — the
    runtime signal adaptive execution judges the planner's estimate
    against at the build-summary barrier."""

    columns: Tuple[ColumnFilter, ...]
    rows: int = -1

    def merge(self, other: "FilterSummary", ndv_limit: int) -> "FilterSummary":
        assert len(self.columns) == len(other.columns)
        return FilterSummary(
            columns=tuple(
                a.merge(b, ndv_limit)
                for a, b in zip(self.columns, other.columns)
            ),
            rows=(
                self.rows + other.rows
                if self.rows >= 0 and other.rows >= 0
                else -1
            ),
        )

    @property
    def empty_build(self) -> bool:
        return all(c.empty for c in self.columns)

    def to_json(self) -> dict:
        return {
            "columns": [c.to_json() for c in self.columns],
            "rows": self.rows,
        }

    @staticmethod
    def from_json(d: dict) -> "FilterSummary":
        return FilterSummary(
            columns=tuple(
                ColumnFilter.from_json(c) for c in d["columns"]
            ),
            rows=int(d.get("rows", -1)),
        )


def empty_summary(keys) -> FilterSummary:
    """Summary of a ZERO-ROW build range (a worker task whose split
    range was empty): every key column is empty — merging with real
    partials leaves the partner untouched."""
    return FilterSummary(
        columns=tuple(ColumnFilter(column=k) for k in keys), rows=0
    )


def subset_summary(columns, rows: int = -1) -> FilterSummary:
    """Summary over a subset of an existing summary's columns (the
    coordinator's constraint-eligible projection). ``rows`` carries
    the source summary's observed build cardinality when the subset
    still describes the same build scan (the adaptive probe-build
    reuse path); the default -1 keeps it unknown."""
    return FilterSummary(columns=tuple(columns), rows=rows)


# ------------------------------------------------- host-side summarize


def _native_bound(v) -> object:
    """numpy scalar -> python value, exactly (ints stay ints; floats
    round-trip through float64, which is a superset of every narrower
    float dtype, so the bound re-stages bit-identically)."""
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    return int(v)


def summarize_page(page, keys, ndv_limit: int = DEFAULT_NDV_LIMIT) -> FilterSummary:
    """Summarize the named key columns of a prefix-form result page (a
    worker's batch output). min/max and the distinct set are computed
    in the column's native dtype; dictionary-encoded string columns
    summarize as distinct VALUES resolved through the page dictionary
    (ids never leave the process — they are meaningless under another
    page's dictionary). A device page's key columns come to the host
    in ONE transfer (``page.to_host``); a host page is read in place."""
    n = int(page.num_valid)
    flat = []
    for key in keys:
        blk = page.block(key)
        if blk.offsets is None and not blk.dtype.is_nested:
            flat.append(blk.data[:n])
            if blk.valid is not None:
                flat.append(blk.valid[:n])
    if page.device.type != "cpu":
        flat = to_host(flat)
    fetched = iter(t.numpy() for t in flat)
    cols: List[ColumnFilter] = []
    for key in keys:
        blk = page.block(key)
        if blk.offsets is not None or blk.dtype.is_nested:
            cols.append(ColumnFilter(column=key, empty=False))
            continue
        data = next(fetched)
        if blk.valid is not None:
            data = data[next(fetched)]
        if data.size == 0:
            cols.append(ColumnFilter(column=key, empty=True))
            continue
        if blk.dtype.is_string:
            ids = np.unique(data.astype(np.int64))
            if blk.dictionary is None or len(ids) > ndv_limit:
                cols.append(ColumnFilter(column=key, empty=False))
                continue
            values = tuple(
                sorted(str(blk.dictionary.values[int(i)]) for i in ids)
            )
            cols.append(
                ColumnFilter(column=key, values=values, empty=False)
            )
            continue
        if blk.dtype.is_long_decimal:
            # limb pairs: no safe scalar ordering here — pass-through
            cols.append(ColumnFilter(column=key, empty=False))
            continue
        if data.dtype.kind == "f" and np.isnan(data).any():
            data = data[~np.isnan(data)]
            if data.size == 0:
                cols.append(ColumnFilter(column=key, empty=True))
                continue
        lo = _native_bound(data.min())
        hi = _native_bound(data.max())
        values = None
        if data.dtype.kind in "iu":
            u = np.unique(data)
            if len(u) <= ndv_limit:
                values = tuple(_native_bound(v) for v in u)
        cols.append(
            ColumnFilter(
                column=key, lo=lo, hi=hi, values=values, empty=False
            )
        )
    return FilterSummary(columns=tuple(cols), rows=n)


# --------------------------------------------- apply: Expr / constraint


def _applicable(cf: ColumnFilter, probe_type: T.DataType) -> bool:
    """Can this summary column safely filter a probe column of
    ``probe_type``? Strings need a distinct set; numerics need bounds.
    (Type agreement between build and probe is the CALLER's check —
    scales and id spaces must match before the summary is even built.)
    """
    if cf.empty:
        return True
    if probe_type.is_string:
        return cf.values is not None
    if probe_type.is_long_decimal or probe_type.is_array:
        return False
    return cf.lo is not None or cf.values is not None


def applicable_count(
    summary: FilterSummary,
    probe_cols: List[Tuple[str, T.DataType]],
) -> int:
    """How many of the summary's columns actually yield a probe-side
    conjunct (the honest value for ``dynamic_filter.applied`` — a
    merged string summary whose union blew the NDV cap contributes
    nothing and must not be counted)."""
    return sum(
        1
        for cf, (_pn, pt) in zip(summary.columns, probe_cols)
        if _applicable(cf, pt)
    )


def to_predicate(
    summary: FilterSummary,
    probe_cols: List[Tuple[str, T.DataType]],
) -> Optional[E.Expr]:
    """Merged summary -> probe-side predicate Expr (None when no key
    admits a filter). ``probe_cols`` aligns with ``summary.columns``:
    the PROBE column name/type each build-key summary applies to.
    An empty build side collapses to a constant-false predicate —
    inner/semi joins can match nothing."""
    conjuncts: List[E.Expr] = []
    for cf, (pname, ptype) in zip(summary.columns, probe_cols):
        if not _applicable(cf, ptype):
            continue
        if cf.empty:
            return E.Literal(False, T.BOOLEAN)
        ref = E.ColumnRef(pname, ptype)
        if cf.values is not None:
            conjuncts.append(
                E.InList(
                    ref,
                    tuple(E.Literal(v, ptype) for v in cf.values),
                )
            )
        else:
            conjuncts.append(
                E.Between(
                    ref, E.Literal(cf.lo, ptype), E.Literal(cf.hi, ptype)
                )
            )
    if not conjuncts:
        return None
    return conjuncts[0] if len(conjuncts) == 1 else E.And(tuple(conjuncts))


def to_constraint(
    summary: FilterSummary,
    probe_cols: List[Tuple[str, T.DataType]],
) -> Tuple:
    """Merged summary -> TupleDomain-lite ``constraint`` entries for
    ``Connector.get_splits``: ``(column, values-tuple)`` for distinct
    sets (hive partition pruning) and ``(column, RangeSet(lo, hi))``
    for bounds (parquet row-group / ORC stripe min-max pruning).
    Connectors that ignore the constraint stay correct — the fused
    predicate still applies."""
    out = []
    for cf, (pname, ptype) in zip(summary.columns, probe_cols):
        if not _applicable(cf, ptype):
            continue
        if cf.empty:
            out.append((pname, ()))
        elif cf.values is not None:
            out.append((pname, tuple(cf.values)))
        else:
            out.append((pname, RangeSet(lo=cf.lo, hi=cf.hi)))
    return tuple(sorted(out, key=lambda t: t[0]))


def merge_constraints(base: Tuple, extra: Tuple) -> Tuple:
    """Combine a scan's planner-pushed constraint with the dynamic one
    (AND semantics: both must hold; entries keep their own columns —
    a connector intersects per column as it understands them)."""
    if not base:
        return tuple(extra)
    if not extra:
        return tuple(base)
    return tuple(sorted(tuple(base) + tuple(extra), key=lambda t: t[0]))


# ----------------------------------------------- device-side (local path)


def device_conjuncts(
    build_page: Page,
    key_pairs: List[Tuple[str, str]],
    probe_schema: Dict[str, T.DataType],
    ndv_limit: int = DEFAULT_NDV_LIMIT,
) -> Tuple[List[E.Expr], int]:
    """Build-side summaries straight off a device-resident page.

    ``key_pairs`` is ``[(probe_col, build_col), ...]``; returns
    ``(conjuncts, n_filters)``, where conjuncts are probe-side Exprs
    (a single constant FALSE for an empty build)."""
    fetch: List[torch.Tensor] = []
    specs: List[tuple] = []
    for lk, rk in key_pairs:
        blk = build_page.block(rk)
        lt = probe_schema.get(lk)
        if (
            lt is None
            or lt != blk.dtype  # scales/id-spaces must agree
            or lt.is_long_decimal
            or lt.is_nested
        ):
            continue
        mask = build_page.row_mask()
        if blk.valid is not None:
            mask = mask & blk.valid
        if lt.is_string:
            if blk.dictionary is None:
                continue
            nvals = len(blk.dictionary.values)
            if nvals > ndv_limit:
                continue
            # present-id LUT over the (small) dictionary: ids of live
            # rows set True; padding rows go to a spill slot
            ids = torch.where(mask, blk.data.to(torch.int64), nvals)
            present = torch.zeros(
                (nvals + 1,), dtype=torch.bool, device=blk.data.device
            )
            present[ids] = True
            fetch.append(present[:nvals])
            fetch.append(mask.any())
            specs.append((lk, lt, "dict", blk.dictionary))
            continue
        d = blk.data  # NATIVE dtype: the bounds are exactly representable
        if d.is_floating_point():
            lo_fill, hi_fill = float("inf"), float("-inf")
            kind = "float"
            # NaN keys match nothing and must not poison the bounds
            mask = mask & ~torch.isnan(d)
        elif d.dtype in _INT_DTYPES:
            info = torch.iinfo(d.dtype)
            lo_fill, hi_fill = info.max, info.min
            kind = "int"
        else:
            continue
        fetch.append(torch.amin(torch.where(mask, d, lo_fill)))
        fetch.append(torch.amax(torch.where(mask, d, hi_fill)))
        specs.append((lk, lt, kind, None))
    if not specs:
        return [], 0
    vals = [t.numpy() for t in to_host(fetch)]
    conjuncts: List[E.Expr] = []
    for i, (lk, lt, kind, dictionary) in enumerate(specs):
        ref = E.ColumnRef(lk, lt)
        if kind == "dict":
            present, any_live = vals[2 * i], bool(vals[2 * i + 1])
            if not any_live:
                return [E.Literal(False, T.BOOLEAN)], 1
            values = [
                str(dictionary.values[j]) for j in np.nonzero(present)[0]
            ]
            conjuncts.append(
                E.InList(ref, tuple(E.Literal(v, lt) for v in values))
            )
            continue
        if kind == "float":
            lo, hi = float(vals[2 * i]), float(vals[2 * i + 1])
            if math.isnan(lo) or math.isnan(hi) or not (lo <= hi):
                # empty build (inf fills stayed) or all-NaN keys
                return [E.Literal(False, T.BOOLEAN)], 1
        else:
            lo, hi = int(vals[2 * i]), int(vals[2 * i + 1])
            if lo > hi:  # empty build: the fills survived the reduction
                return [E.Literal(False, T.BOOLEAN)], 1
        # compare in the key's native repr (decimals unscaled)
        conjuncts.append(
            E.Between(ref, E.Literal(lo, lt), E.Literal(hi, lt))
        )
    return conjuncts, len(conjuncts)

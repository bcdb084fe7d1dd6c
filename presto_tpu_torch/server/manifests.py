"""Durable lakehouse snapshots: crash-safe manifest commits over
immutable parquet data files.

Reference parity: the open-table-format direction of the survey
(SURVEY.md §2.2 connector long-tail; PAPER.md's Iceberg/Hudi
ecosystem argument) — a table is a chain of immutable snapshots, each
described by a manifest listing the data files that make it up, with
enough per-file metadata (row counts, column min/max) for planners to
prune files without opening them. The snapshot SPI gives the engine
pin-once-per-scan version handles; this module gives those handles
something durable to point at. The PyTorch port's copy of
``presto_tpu/server/manifests.py``: the frames, data files and pointer
are byte-equal to the reference's, so either package reads the
other's store.

On-disk shape (one directory per table under ``lakehouse.path``)::

    <root>/<catalog>.<schema>.<table>/
        data/<sid>-<nonce>.parquet      immutable row chunks
        manifests/<sid>.manifest        one crc32-framed JSON line
        _current                        pointer to the tip snapshot

A manifest is ONE checksummed frame (the journal/spool/ingest WAL
idiom: ``{crc32:08x} {payload}``) holding the snapshot id, the parent
snapshot id, the table schema, and the FULL cumulative file list —
reads are O(1) manifest loads and rollback needs no log replay.

Commit protocol (the crash-safety contract, chaos-tested in
``tests/test_lakehouse.py``): data files are written to a temp name,
fsynced, and atomically renamed FIRST; the manifest is written to a
temp name, fsynced, and atomically renamed SECOND; the ``_current``
pointer is swapped (temp + fsync + atomic rename) LAST. A kill or an
injected ``io_error`` at ANY point leaves either the old tip or the
new tip — never a half-commit. Failed attempts leave only orphan
files (never a reachable manifest), cleaned by the TTL'd GC.

Torn or corrupt manifests are detected by checksum at read time and
rolled back: a tip whose manifest fails validation falls back to the
newest older valid manifest and the pointer is repaired in place
(``lakehouse.rollbacks`` counts it).

Frame construction/parsing, data-file publication, and the
``_current`` pointer swap are confined to this module
(``tools/analyze.py`` ``manifest-plane`` rule) — a second pointer
writer or an ad-hoc manifest parser elsewhere would silently break
the atomic-commit and rollback guarantees.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
import uuid
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors._arrow import (
    arrow_column_to_payload as _arrow_column_to_payload,
)
from presto_tpu_torch.connectors.spi import (
    ColumnStats,
    ConnectorSplit,
    SplitSource,
    TableHandle,
    TableStats,
    coalesce_kept_chunks,
)
from presto_tpu_torch.utils import faults
from presto_tpu_torch.utils.metrics import REGISTRY

log = logging.getLogger("presto_tpu_torch.lakehouse")

_CURRENT = "_current"
_MANIFEST_DIR = "manifests"
_DATA_DIR = "data"
_MANIFEST_SUFFIX = ".manifest"
_TMP_SUFFIX = ".tmp"

#: default split size over manifest-backed tables (rows per split)
DEFAULT_TARGET_FILE_BYTES = 64 * 1024 * 1024


class ManifestError(RuntimeError):
    pass


# ----------------------------------------------------------------- frames


def _manifest_frame(payload: str) -> str:
    """One checksummed manifest frame — the same crc32-prefixed idiom
    as the journal/spool/ingest WAL, so a torn write is detected by
    the same check."""
    return f"{zlib.crc32(payload.encode()) & 0xFFFFFFFF:08x} {payload}"


def _parse_manifest_line(line: str) -> Optional[dict]:
    """Frame -> record dict, or None for torn/corrupt content."""
    line = line.strip()
    if not line:
        return None
    crc_hex, sep, payload = line.partition(" ")
    if not sep or len(crc_hex) != 8:
        return None
    try:
        crc = int(crc_hex, 16)
    except ValueError:
        return None
    if zlib.crc32(payload.encode()) & 0xFFFFFFFF != crc:
        return None
    try:
        rec = json.loads(payload)
    except Exception:
        return None
    return rec if isinstance(rec, dict) else None


# ------------------------------------------------------------- model


@dataclass(frozen=True)
class DataFile:
    """One immutable parquet chunk of a snapshot."""

    name: str
    rows: int
    bytes: int
    #: per-column [lo, hi] for plain numeric columns (pruning input;
    #: missing stats over-retain, mirroring footer-stats discipline)
    minmax: Tuple[Tuple[str, Tuple[float, float]], ...] = ()

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "rows": self.rows,
            "bytes": self.bytes,
            "minmax": {c: list(mm) for c, mm in self.minmax},
        }

    @staticmethod
    def from_json(rec: dict) -> "DataFile":
        return DataFile(
            name=str(rec["name"]),
            rows=int(rec["rows"]),
            bytes=int(rec.get("bytes", 0)),
            minmax=tuple(
                sorted(
                    (str(c), (mm[0], mm[1]))
                    for c, mm in (rec.get("minmax") or {}).items()
                )
            ),
        )


@dataclass(frozen=True)
class Manifest:
    """One committed snapshot: schema + the full file list."""

    snapshot: int
    parent: Optional[int]
    table: str  #: dotted catalog.schema.table
    schema: Tuple[Tuple[str, str], ...]  #: (col, engine type text)
    files: Tuple[DataFile, ...]
    row_count: int
    compaction: bool = False
    ts: float = 0.0

    def engine_schema(self) -> Dict[str, T.DataType]:
        return {c: T.parse_type(t) for c, t in self.schema}

    def to_json(self) -> dict:
        return {
            "snapshot": self.snapshot,
            "parent": self.parent,
            "table": self.table,
            "schema": {c: t for c, t in self.schema},
            "files": [f.to_json() for f in self.files],
            "row_count": self.row_count,
            "compaction": self.compaction,
            "ts": self.ts,
        }

    @staticmethod
    def from_json(rec: dict) -> "Manifest":
        return Manifest(
            snapshot=int(rec["snapshot"]),
            parent=(
                int(rec["parent"]) if rec.get("parent") is not None
                else None
            ),
            table=str(rec.get("table", "")),
            schema=tuple(
                (str(c), str(t))
                for c, t in (rec.get("schema") or {}).items()
            ),
            files=tuple(
                DataFile.from_json(f) for f in rec.get("files") or ()
            ),
            row_count=int(rec.get("row_count", 0)),
            compaction=bool(rec.get("compaction", False)),
            ts=float(rec.get("ts", 0.0)),
        )


# ----------------------------------------------------- durable writes


def _fsync_path(path: str) -> None:
    faults.maybe_inject_io("fsync", path)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    # directory fsync makes the rename itself durable; tolerate
    # platforms/filesystems that refuse O_RDONLY on directories
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _publish_file(tmp: str, final: str) -> None:
    """fsync the temp file, atomically rename it into place, fsync
    the directory — the durable-publication step all three commit
    stages share."""
    _fsync_path(tmp)
    faults.maybe_inject_io("rename", final)
    os.replace(tmp, final)
    _fsync_dir(os.path.dirname(final))


# ------------------------------------------------------ arrow bridge


def _engine_to_arrow(t: T.DataType):
    import pyarrow as pa

    if getattr(t, "is_decimal", False):
        return pa.decimal128(t.precision, t.scale)
    name = t.name
    if name == "boolean":
        return pa.bool_()
    if name == "bigint":
        return pa.int64()
    if name in ("integer", "smallint", "tinyint"):
        return pa.int32()
    if name == "double":
        return pa.float64()
    if name == "real":
        return pa.float32()
    if name == "date":
        return pa.date32()
    if name == "timestamp":
        return pa.timestamp("us")
    return pa.string()


def _delta_to_arrow(schema: Dict[str, T.DataType], delta: Dict[str, Sequence]):
    import pyarrow as pa

    arrays, fields = [], []
    for c, t in schema.items():
        at = _engine_to_arrow(t)
        arrays.append(pa.array(list(delta.get(c, ())), type=at))
        fields.append(pa.field(c, at))
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))


def _table_minmax(tbl) -> Tuple[Tuple[str, Tuple[float, float]], ...]:
    """Per-column [lo, hi] for plain int/float columns of one arrow
    chunk — the pruning stats recorded in the manifest."""
    import pyarrow as pa
    import pyarrow.compute as pc

    out = []
    for field in tbl.schema:
        if not (
            pa.types.is_integer(field.type)
            or pa.types.is_floating(field.type)
        ):
            continue
        col = tbl.column(field.name)
        if col.null_count == len(col):
            continue
        mm = pc.min_max(col)
        lo, hi = mm["min"].as_py(), mm["max"].as_py()
        if lo is None or hi is None:
            continue
        out.append((field.name, (lo, hi)))
    return tuple(sorted(out))


class _FileStatsShim:
    """Adapts a manifest ``minmax`` entry to the pyarrow statistics
    surface ``parquet.rowgroup_matches`` consumes."""

    __slots__ = ("has_min_max", "min", "max")

    def __init__(self, lo, hi):
        self.has_min_max = True
        self.min = lo
        self.max = hi


# ------------------------------------------------------------- store


class ManifestStore:
    """One lakehouse root: durable snapshot commits, validated reads
    with rollback-to-parent, compaction, and TTL'd orphan GC.

    The store is stateless over the directory apart from an immutable
    manifest parse cache — ingest and the file connectors can hold
    independent instances over the same root and stay coherent
    (every tip read goes through the ``_current`` pointer)."""

    def __init__(
        self,
        root: str,
        target_file_bytes: int = DEFAULT_TARGET_FILE_BYTES,
    ):
        self.root = root
        self.target_file_bytes = max(int(target_file_bytes), 1)
        os.makedirs(root, exist_ok=True)
        self._mu = threading.Lock()  # guards the parse cache only
        self._cache: Dict[Tuple[str, int], Manifest] = {}

    # ------------------------------------------------------- layout

    def _tdir(self, tk: Tuple[str, str, str]) -> str:
        return os.path.join(self.root, ".".join(tk))

    def tables(self) -> List[Tuple[str, str, str]]:
        out = []
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return out
        for name in names:
            parts = tuple(name.split("."))
            if len(parts) != 3:
                continue
            if os.path.exists(os.path.join(self.root, name, _CURRENT)):
                out.append(parts)  # type: ignore[arg-type]
        return out

    def has_table(self, tk: Tuple[str, str, str]) -> bool:
        return os.path.exists(os.path.join(self._tdir(tk), _CURRENT))

    # -------------------------------------------------------- reads

    def _read_current(self, tdir: str) -> Optional[int]:
        try:
            with open(os.path.join(tdir, _CURRENT), encoding="utf-8") as f:
                rec = _parse_manifest_line(f.readline())
        except OSError:
            return None
        if rec is None or "sid" not in rec:
            return None
        try:
            return int(rec["sid"])
        except (TypeError, ValueError):
            return None

    def _load(self, tk, sid: int) -> Optional[Manifest]:
        """Checksum-validated read of one manifest file (no chain
        membership check — callers validate reachability)."""
        key = (".".join(tk), sid)
        with self._mu:
            m = self._cache.get(key)
        if m is not None:
            return m
        path = os.path.join(
            self._tdir(tk), _MANIFEST_DIR, f"{sid}{_MANIFEST_SUFFIX}"
        )
        try:
            with open(path, encoding="utf-8") as f:
                rec = _parse_manifest_line(f.readline())
        except OSError:
            return None
        if rec is None:
            return None
        try:
            m = Manifest.from_json(rec)
        except Exception:
            return None
        if m.snapshot != sid:
            return None
        with self._mu:
            self._cache[key] = m
        return m

    def _manifest_sids_on_disk(self, tk) -> List[int]:
        mdir = os.path.join(self._tdir(tk), _MANIFEST_DIR)
        out = []
        try:
            names = os.listdir(mdir)
        except OSError:
            return out
        for name in names:
            if not name.endswith(_MANIFEST_SUFFIX):
                continue
            try:
                out.append(int(name[: -len(_MANIFEST_SUFFIX)]))
            except ValueError:
                continue
        return sorted(out)

    def manifest(
        self, tk: Tuple[str, str, str], sid: Optional[int] = None
    ) -> Optional[Manifest]:
        """The tip manifest (``sid=None``) or a historic snapshot in
        the tip's parent chain. A torn/corrupt tip rolls back to the
        newest older VALID manifest and repairs the pointer; a ``sid``
        outside the chain (never committed, or expired past the GC
        TTL) returns None."""
        tdir = self._tdir(tk)
        tip_sid = self._read_current(tdir)
        tip = None
        if tip_sid is not None:
            tip = self._load(tk, tip_sid)
        if tip is None:
            # pointer missing/corrupt, or its target torn: fall back
            # to the newest valid manifest on disk below the pointer
            # (== the parent — failed commits never reach the swap,
            # so any NEWER manifest file is unreachable by design)
            candidates = [
                s
                for s in reversed(self._manifest_sids_on_disk(tk))
                if tip_sid is None or s < tip_sid
            ]
            for s in candidates:
                tip = self._load(tk, s)
                if tip is not None:
                    REGISTRY.counter("lakehouse.rollbacks").update()
                    log.warning(
                        "lakehouse %s: tip %r unreadable — rolled "
                        "back to snapshot %d",
                        ".".join(tk), tip_sid, s,
                    )
                    try:
                        self._swap_current(tdir, s)
                    except OSError:
                        pass  # serve the parent even if repair fails
                    break
            if tip is None:
                return None
        if sid is None or sid == tip.snapshot:
            return tip
        # historic read: walk the parent chain — orphan manifests of
        # failed commits are NOT reachable and never served
        m = tip
        while m is not None and m.parent is not None:
            m = self._load(tk, m.parent)
            if m is not None and m.snapshot == sid:
                return m
        return None

    def current_sid(self, tk) -> Optional[int]:
        m = self.manifest(tk)
        return m.snapshot if m is not None else None

    def sids(self, tk) -> List[int]:
        """Live snapshot ids, ascending (the tip's parent chain)."""
        out = []
        m = self.manifest(tk)
        while m is not None:
            out.append(m.snapshot)
            if m.parent is None:
                break
            m = self._load(tk, m.parent)
        return sorted(out)

    def schema(self, tk) -> Optional[Dict[str, T.DataType]]:
        m = self.manifest(tk)
        return m.engine_schema() if m is not None else None

    # ------------------------------------------------------- commit

    def _swap_current(self, tdir: str, sid: int) -> None:
        """The LAST step of a commit: atomically repoint the table at
        its new tip. This rename is the durability point."""
        final = os.path.join(tdir, _CURRENT)
        tmp = final + _TMP_SUFFIX
        faults.maybe_inject_io("write", final)
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(_manifest_frame(json.dumps({"sid": sid})) + "\n")
            f.flush()
        _publish_file(tmp, final)

    def _write_manifest(self, tk, m: Manifest) -> None:
        mdir = os.path.join(self._tdir(tk), _MANIFEST_DIR)
        os.makedirs(mdir, exist_ok=True)
        final = os.path.join(mdir, f"{m.snapshot}{_MANIFEST_SUFFIX}")
        tmp = final + _TMP_SUFFIX
        faults.maybe_inject_io("write", final)
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(
                _manifest_frame(json.dumps(m.to_json(), default=str))
                + "\n"
            )
            f.flush()
        _publish_file(tmp, final)
        # a retried commit may overwrite an orphan manifest of a
        # failed attempt at the same sid — drop any stale parse
        with self._mu:
            self._cache.pop((".".join(tk), m.snapshot), None)

    def _write_data_file(self, tk, sid: int, tbl) -> DataFile:
        """Publish one immutable parquet chunk: temp write, fsync,
        atomic rename. The nonce keeps retried commits from colliding
        with the orphan of a failed attempt."""
        import pyarrow.parquet as pq

        ddir = os.path.join(self._tdir(tk), _DATA_DIR)
        os.makedirs(ddir, exist_ok=True)
        name = f"{sid:012d}-{uuid.uuid4().hex[:8]}.parquet"
        final = os.path.join(ddir, name)
        tmp = final + _TMP_SUFFIX
        faults.maybe_inject_io("write", final)
        pq.write_table(tbl, tmp)
        _publish_file(tmp, final)
        REGISTRY.counter("lakehouse.files_written").update()
        nbytes = os.path.getsize(final)
        REGISTRY.counter("lakehouse.bytes_written").update(nbytes)
        return DataFile(
            name=name,
            rows=tbl.num_rows,
            bytes=nbytes,
            minmax=_table_minmax(tbl),
        )

    def _chunk_rows(self, tbl) -> List:
        """Split one arrow table into ~target-file-bytes chunks,
        preserving row order."""
        if tbl.num_rows == 0:
            return []
        nbytes = max(tbl.nbytes, 1)
        nchunks = max(1, -(-nbytes // self.target_file_bytes))
        if nchunks == 1:
            return [tbl]
        per = -(-tbl.num_rows // nchunks)
        return [
            tbl.slice(i, per) for i in range(0, tbl.num_rows, per)
        ]

    def _publish(
        self,
        tk: Tuple[str, str, str],
        schema: Dict[str, T.DataType],
        tbl,
        sid: int,
        *,
        keep_parent_files: bool,
        compaction: bool = False,
    ) -> Manifest:
        """The three-stage crash-safe commit: data files, manifest,
        pointer — in that order, each durably published before the
        next begins."""
        parent = self.manifest(tk)
        if parent is not None and sid <= parent.snapshot and not compaction:
            raise ManifestError(
                f"snapshot id {sid} not beyond tip {parent.snapshot} "
                f"for {'.'.join(tk)}"
            )
        new_files: List[DataFile] = []
        if tbl is not None:
            for chunk in self._chunk_rows(tbl):
                new_files.append(self._write_data_file(tk, sid, chunk))
        files: Tuple[DataFile, ...] = tuple(new_files)
        if keep_parent_files and parent is not None:
            files = parent.files + files
        m = Manifest(
            snapshot=sid,
            parent=parent.snapshot if parent is not None else None,
            table=".".join(tk),
            schema=tuple((c, str(t)) for c, t in schema.items()),
            files=files,
            row_count=sum(f.rows for f in files),
            compaction=compaction,
            ts=time.time(),
        )
        self._write_manifest(tk, m)
        self._swap_current(self._tdir(tk), sid)
        with self._mu:
            self._cache[(".".join(tk), sid)] = m
        REGISTRY.counter("lakehouse.commits").update()
        return m

    def create_table(
        self, tk: Tuple[str, str, str], schema: Dict[str, T.DataType]
    ) -> Manifest:
        """Register an empty table as snapshot 0 (schema only)."""
        existing = self.manifest(tk)
        if existing is not None:
            raise ManifestError(f"table {'.'.join(tk)} already exists")
        os.makedirs(self._tdir(tk), exist_ok=True)
        return self._publish(
            tk, schema, None, 0, keep_parent_files=False
        )

    def commit(
        self,
        tk: Tuple[str, str, str],
        schema: Dict[str, T.DataType],
        delta: Dict[str, Sequence],
        sid: int,
    ) -> Manifest:
        """Durably append one committed delta as snapshot ``sid``.
        Raises (cleanly, leaving the old tip reachable) on any I/O
        failure — the caller retries the whole commit."""
        tbl = _delta_to_arrow(schema, delta)
        return self._publish(
            tk, schema, tbl, sid, keep_parent_files=True
        )

    # -------------------------------------------------------- serve

    def read_arrow(self, tk, m: Manifest, columns=None):
        """The snapshot's rows as one arrow table, in manifest file
        order (row order is part of the snapshot contract)."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        ddir = os.path.join(self._tdir(tk), _DATA_DIR)
        parts = []
        for f in m.files:
            parts.append(
                pq.read_table(
                    os.path.join(ddir, f.name), columns=columns
                )
            )
        if not parts:
            schema = m.engine_schema()
            names = columns if columns is not None else list(schema)
            return pa.Table.from_arrays(
                [
                    pa.array([], type=_engine_to_arrow(schema[c]))
                    for c in names
                ],
                names=list(names),
            )
        return pa.concat_tables(parts)

    def read_values(self, tk, sid: Optional[int] = None) -> Optional[
        Dict[str, list]
    ]:
        """The snapshot's rows as python values (restore path: feeds
        ``commit_snapshot`` on the volatile store bit-identically to
        the original appends)."""
        m = self.manifest(tk, sid)
        if m is None:
            return None
        tbl = self.read_arrow(tk, m)
        return {
            name: tbl.column(name).to_pylist()
            for name in tbl.schema.names
        }

    def splits_for_manifest(
        self,
        m: Manifest,
        handle: TableHandle,
        target_rows: int,
        constraint=(),
    ) -> List[ConnectorSplit]:
        """File-level pruning: each data file is a chunk, kept when
        its manifest min/max may satisfy the constraint (missing
        stats over-retain); kept runs coalesce into row-range splits
        in the snapshot's global row space — the same loop the file
        connectors use for row groups/stripes, one level up."""
        from presto_tpu_torch.connectors.parquet import rowgroup_matches

        chunk_rows: List[int] = []
        keep: List[bool] = []
        for f in m.files:
            kept = True
            if constraint:
                mm = dict(f.minmax)
                for col, domain in constraint:
                    ent = mm.get(col)
                    shim = (
                        _FileStatsShim(ent[0], ent[1])
                        if ent is not None
                        else None
                    )
                    if not rowgroup_matches(shim, domain):
                        kept = False
                        break
            chunk_rows.append(f.rows)
            keep.append(kept)
        return coalesce_kept_chunks(
            handle, chunk_rows, keep, target_rows
        )

    def page_payloads(
        self,
        tk,
        m: Manifest,
        columns: Dict[str, T.DataType],
        row_start: int,
        row_end: int,
    ) -> Tuple[int, Dict[str, object]]:
        """Engine staging payloads for one row range of a snapshot —
        the split's global rows mapped onto the files that hold them,
        converted through the shared arrow bridge."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        ddir = os.path.join(self._tdir(tk), _DATA_DIR)
        names = list(columns)
        parts = []
        start = 0
        for f in m.files:
            end = start + f.rows
            lo = max(row_start, start)
            hi = min(row_end, end)
            if lo < hi:
                tbl = pq.read_table(
                    os.path.join(ddir, f.name), columns=names
                )
                parts.append(tbl.slice(lo - start, hi - lo))
            start = end
        if not parts:
            return 0, {
                c: _arrow_column_to_payload(
                    pa.chunked_array(
                        [pa.array([], type=_engine_to_arrow(t))]
                    ),
                    t,
                )
                for c, t in columns.items()
            }
        merged = pa.concat_tables(parts)
        payloads = {
            c: _arrow_column_to_payload(merged.column(c), columns[c])
            for c in names
        }
        return merged.num_rows, payloads

    # --------------------------------------------------- compaction

    def compact(
        self,
        tk: Tuple[str, str, str],
        new_sid: int,
        *,
        min_files: int = 4,
    ) -> Optional[Manifest]:
        """Rewrite the tip's small files into ~target-file-bytes
        chunks and publish the result as a NEW snapshot (same rows,
        same order). Pinned readers keep serving the old files —
        nothing is deleted here; the TTL'd GC reclaims them once the
        old snapshots expire."""
        m = self.manifest(tk)
        if m is None or len(m.files) < max(min_files, 2):
            return None
        small = sum(
            1 for f in m.files if f.bytes < self.target_file_bytes
        )
        if small < max(min_files, 2):
            return None
        tbl = self.read_arrow(tk, m)
        out = self._publish(
            tk,
            m.engine_schema(),
            tbl,
            new_sid,
            keep_parent_files=False,
            compaction=True,
        )
        REGISTRY.counter("lakehouse.compactions").update()
        return out

    # ----------------------------------------------------------- gc

    def gc_orphans(self, ttl_s: float) -> int:
        """Reclaim (a) manifests no longer reachable from any tip —
        failed commits and compacted-away history — and (b) data
        files referenced by no remaining manifest, both only once
        older than ``ttl_s`` (pinned readers of recent snapshots keep
        their files). Returns the number of paths removed."""
        removed = 0
        cutoff = time.time() - max(float(ttl_s), 0.0)
        for tk in self.tables():
            tdir = self._tdir(tk)
            live = set(self.sids(tk))
            mdir = os.path.join(tdir, _MANIFEST_DIR)
            tip = self.current_sid(tk)
            for s in self._manifest_sids_on_disk(tk):
                if s in live and (s == tip or s > (tip or 0)):
                    continue
                path = os.path.join(mdir, f"{s}{_MANIFEST_SUFFIX}")
                # expire failed-commit orphans AND old history past
                # the TTL; expiry truncates time travel from the
                # oldest end (the chain walk stops at the gap)
                if s == tip:
                    continue
                try:
                    if os.path.getmtime(path) >= cutoff:
                        continue
                    os.remove(path)
                    removed += 1
                    with self._mu:
                        self._cache.pop((".".join(tk), s), None)
                except OSError:
                    continue
            # data files referenced by NO remaining valid manifest
            referenced = set()
            for s in self._manifest_sids_on_disk(tk):
                m = self._load(tk, s)
                if m is not None:
                    referenced.update(f.name for f in m.files)
            ddir = os.path.join(tdir, _DATA_DIR)
            try:
                names = os.listdir(ddir)
            except OSError:
                continue
            for name in names:
                if name in referenced:
                    continue
                path = os.path.join(ddir, name)
                try:
                    if os.path.getmtime(path) >= cutoff:
                        continue
                    os.remove(path)
                    removed += 1
                except OSError:
                    continue
        if removed:
            REGISTRY.counter("lakehouse.orphans_gcd").update(removed)
        return removed

    # -------------------------------------------------------- stats

    def table_stats(self, tk) -> Optional[dict]:
        """Per-table lakehouse state for ``system.runtime.snapshots``."""
        m = self.manifest(tk)
        if m is None:
            return None
        small = sum(
            1 for f in m.files if f.bytes < self.target_file_bytes
        )
        if m.compaction:
            state = "compacted"
        elif small >= 2:
            state = "pending"
        else:
            state = "none"
        return {
            "table": ".".join(tk),
            "snapshot_id": m.snapshot,
            "snapshots": len(self.sids(tk)),
            "files": len(m.files),
            "bytes": sum(f.bytes for f in m.files),
            "rows": m.row_count,
            "compaction": state,
        }


# --------------------------------------------------- connector mixin


class LakehouseConnectorMixin:
    """The manifest-backed table surface the file connectors share:
    pin, serve, commit, and list tables whose storage is a manifest
    chain (connector config ``lakehouse=<root>``). Lives HERE so the
    manifest internals stay confined to the manifest plane — the
    parquet/ORC connectors only COMPOSE these entry points with their
    legacy single-file paths (legacy tables stay unversioned and
    bit-exact)."""

    manifest_store: Optional[ManifestStore] = None
    _lake_catalog: Optional[str] = None

    def _init_lakehouse(
        self,
        lakehouse: Optional[str],
        catalog: Optional[str] = None,
        target_file_bytes: Optional[int] = None,
    ) -> None:
        self.manifest_store = None
        self._lake_catalog = catalog
        if lakehouse:
            self.manifest_store = ManifestStore(
                lakehouse,
                target_file_bytes=int(
                    target_file_bytes or DEFAULT_TARGET_FILE_BYTES
                ),
            )

    def _lake_owns(self, tk) -> bool:
        # without a ``catalog`` config the store root is assumed
        # single-catalog (listing is fuzzy; handle-keyed ops are exact)
        return self._lake_catalog is None or tk[0] == self._lake_catalog

    def lake_manifest(self, handle: TableHandle) -> Optional[Manifest]:
        """The manifest a handle reads (its pinned snapshot, or the
        tip), or None for legacy non-manifest tables. An explicitly
        pinned snapshot that is not in the live chain raises — time
        travel must never silently serve other rows."""
        store = self.manifest_store
        if store is None or not store.has_table(handle.table_key):
            return None
        m = store.manifest(handle.table_key, handle.snapshot)
        if m is None and handle.snapshot is not None:
            raise KeyError(
                f"snapshot {handle.snapshot} is not available for "
                f"{'.'.join(handle.table_key)}"
            )
        return m

    def pin_snapshot(self, handle: TableHandle) -> TableHandle:
        store = self.manifest_store
        if store is None or not store.has_table(handle.table_key):
            return handle
        if handle.snapshot is not None:
            if (
                store.manifest(handle.table_key, handle.snapshot)
                is None
            ):
                raise KeyError(
                    f"snapshot {handle.snapshot} is not available "
                    f"for {'.'.join(handle.table_key)}"
                )
            return handle
        sid = store.current_sid(handle.table_key)
        if sid is None:
            return handle
        return dataclasses.replace(handle, snapshot=sid)

    def current_snapshot_id(
        self, handle: TableHandle
    ) -> Optional[int]:
        store = self.manifest_store
        if store is None or not store.has_table(handle.table_key):
            return None
        return store.current_sid(handle.table_key)

    def commit_snapshot(
        self, handle: TableHandle, delta: Dict[str, Sequence], sid: int
    ) -> int:
        """The ingest lane's durable fold: publish the delta as a new
        manifest snapshot. Data IS visibility here — there is no
        separate volatile copy to fold."""
        store = self.manifest_store
        if store is None:
            raise ManifestError(
                "catalog has no lakehouse root (pass lakehouse=<dir>)"
            )
        schema = store.schema(handle.table_key)
        if schema is None:
            raise ManifestError(
                f"unknown lakehouse table {'.'.join(handle.table_key)}"
            )
        m = store.commit(handle.table_key, schema, delta, sid)
        return m.row_count

    def restore_snapshots(self, handle: TableHandle, pairs) -> None:
        """Restart no-op: the manifest chain IS the durable history."""

    def create_table(
        self, handle: TableHandle, schema: Dict[str, T.DataType]
    ) -> None:
        store = self.manifest_store
        if store is None:
            return super().create_table(handle, schema)
        store.create_table(handle.table_key, schema)

    def lake_splits(
        self,
        handle: TableHandle,
        target_split_rows: int,
        constraint=(),
    ) -> Optional[SplitSource]:
        m = self.lake_manifest(handle)
        if m is None:
            return None
        return SplitSource(
            self.manifest_store.splits_for_manifest(
                m, handle, target_split_rows, constraint
            )
        )

    def lake_page_source(
        self, split: ConnectorSplit, columns: Sequence[str]
    ) -> Optional[Dict[str, object]]:
        m = self.lake_manifest(split.table)
        if m is None:
            return None
        schema = m.engine_schema()
        _n, payloads = self.manifest_store.page_payloads(
            split.table.table_key,
            m,
            {c: schema[c] for c in columns},
            split.row_start,
            split.row_end,
        )
        return payloads

    def lake_schema(
        self, handle: TableHandle
    ) -> Optional[Dict[str, T.DataType]]:
        m = self.lake_manifest(handle)
        return m.engine_schema() if m is not None else None

    def lake_table_stats(
        self, handle: TableHandle
    ) -> Optional[TableStats]:
        """Stats straight from the pinned manifest (zero file reads):
        row count plus per-column min/max aggregated over the file
        list — the same optimizer inputs the parquet footer provides."""
        m = self.lake_manifest(handle)
        if m is None:
            return None
        mins: Dict[str, float] = {}
        maxs: Dict[str, float] = {}
        for f in m.files:
            for c, (lo, hi) in f.minmax:
                mins[c] = lo if c not in mins else min(mins[c], lo)
                maxs[c] = hi if c not in maxs else max(maxs[c], hi)
        cols = {
            c: ColumnStats(
                min_value=float(mins[c]), max_value=float(maxs[c])
            )
            for c in mins
        }
        return TableStats(row_count=float(m.row_count), columns=cols)

    def lake_list_schemas(self) -> List[str]:
        store = self.manifest_store
        if store is None:
            return []
        return sorted(
            {tk[1] for tk in store.tables() if self._lake_owns(tk)}
        )

    def lake_list_tables(self, schema: str) -> List[str]:
        store = self.manifest_store
        if store is None:
            return []
        return sorted(
            tk[2]
            for tk in store.tables()
            if tk[1] == schema and self._lake_owns(tk)
        )

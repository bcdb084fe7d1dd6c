"""Streaming ingest lane: WAL'd micro-batch commits with snapshot
reads.

Reference parity: the append-oriented half of a streaming warehouse —
writers land row micro-batches in a durable per-table write-ahead log,
a commit loop folds them into immutable snapshot versions
(Iceberg-style snapshot-committed tables, the declared SPI long-tail
of COMPONENTS.md §2.2), and readers pin a snapshot per plan so a long
scan never sees a torn batch and is isolated from concurrent appends.
Its log is crc32-framed JSONL, the idiom of the reference's coordinator
journal and exchange spool.

On-disk shape (one directory, ``ingest.wal-path``): one WAL per table,
``wal-{catalog}.{schema}.{table}.jsonl``, plus ``mviews.jsonl`` for
durable materialized-view definitions. Every line is a checksummed
frame::

    {crc32-of-payload as 8 hex chars} {payload JSON}

Frames: ``schema`` (the table's columns+types, written once so replay
can recreate the table in the volatile memory connector), ``batch``
(one appended micro-batch under a per-table monotone ``seq``), and
``commit`` (``upto`` = the last folded seq; its value also MINTS the
snapshot id — the commit frame is the durability point, so snapshot
ids are born durable). Crash recovery replays each WAL: batches with
``seq <= upto`` of the last commit frame rebuild the committed
snapshot; the uncommitted tail past it is re-admitted as pending
EXACTLY once (its batch frames are already on disk — the next commit
only adds the commit frame); torn/corrupt lines are counted
(``ingest.wal_corrupt``) and skipped — the lane must always come up.

Frame construction/parsing and snapshot-id minting are confined to
this module: an ad-hoc frame writer or a second id minter elsewhere
would silently break replay or snapshot isolation. Frames are
byte-equal to the reference's, so either package replays the other's
WAL.

Commit pipeline (``ingest.commit-interval-ms`` loop, or an explicit
``flush()``): write the commit frame (durability point) -> fold the
delta into the connector (``commit_snapshot``) -> invalidate staged
pages + cached plans of the table -> hand the delta to the
materialized-view registry, which merges it through the existing
aggregation plane (``exec/mview.py``: one K1 launch per delta merge
of an eligible aggregate view on the card). ``ingest.wal-path`` unset
means none of this is built and the INSERT/CTAS write path is
unchanged.

The PyTorch port's copy of ``presto_tpu/server/ingest.py``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.spi import ConnectorSplit, TableHandle
from presto_tpu_torch.utils import faults
from presto_tpu_torch.utils.metrics import REGISTRY

log = logging.getLogger("presto_tpu_torch.ingest")

_WAL_PREFIX = "wal-"
_WAL_SUFFIX = ".jsonl"
_MVIEWS_FILE = "mviews.jsonl"

#: default commit-loop cadence (ingest.commit-interval-ms)
DEFAULT_COMMIT_INTERVAL_MS = 50.0


class IngestError(RuntimeError):
    pass


def _wal_frame(payload: str) -> str:
    """One checksummed WAL frame (the journal/spool idiom): crc32 of
    the UTF-8 payload, then the payload. Verified at replay — a torn
    write truncates the line and fails the check."""
    return f"{zlib.crc32(payload.encode()) & 0xFFFFFFFF:08x} {payload}"


def _parse_wal_line(line: str) -> Optional[dict]:
    """Frame -> record dict, or None for torn/corrupt/foreign lines."""
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
    return rec if isinstance(rec, dict) and "ev" in rec else None


def _coerce_value(v, dtype):
    """One JSON-decoded WAL/API value -> the engine-native python value
    for ``dtype`` (dates and decimals ride the wire as strings)."""
    if v is None:
        return None
    name = dtype.name
    if getattr(dtype, "is_decimal", False):
        from decimal import Decimal

        return v if isinstance(v, Decimal) else Decimal(str(v))
    if name == "date":
        import datetime

        if isinstance(v, datetime.date):
            return v
        return datetime.date.fromisoformat(str(v))
    if name == "timestamp":
        import datetime

        if isinstance(v, datetime.datetime):
            return v
        return datetime.datetime.fromisoformat(str(v))
    if name in ("bigint", "integer", "smallint", "tinyint"):
        return int(v)
    if name in ("double", "real"):
        return float(v)
    if name == "boolean":
        return bool(v)
    if name.startswith(("varchar", "char")):
        return str(v)
    return v


class _TableLane:
    """Per-table ingest state: the WAL file, the monotone batch seq,
    and the uncommitted pending tail."""

    def __init__(self, handle: TableHandle, path: str):
        self.handle = handle
        self.path = path
        self.lock = threading.Lock()
        self.seq = 0  #: last appended batch seq
        self.committed = 0  #: last committed seq (== tip snapshot id)
        #: uncommitted (seq, columns-dict, nrows), admission order
        self.pending: List[Tuple[int, dict, int]] = []


class IngestManager:
    """The ingest lane of one runner: durable appends, the commit
    loop, crash replay, and durable materialized-view definitions."""

    def __init__(
        self,
        runner,
        wal_path: str,
        commit_interval_ms: float = DEFAULT_COMMIT_INTERVAL_MS,
        start_thread: bool = True,
        lakehouse_path: Optional[str] = None,
        lakehouse_target_file_bytes: Optional[int] = None,
        lakehouse_compaction_interval_s: float = 0.0,
        lakehouse_compaction_min_files: int = 4,
        lakehouse_orphan_ttl_s: float = 86400.0,
    ):
        self.runner = runner
        self.path = wal_path
        self.commit_interval_ms = float(commit_interval_ms)
        os.makedirs(wal_path, exist_ok=True)
        # the durable lakehouse tee (lakehouse.path): commits publish
        # a manifest snapshot BEFORE the WAL commit frame, so restart
        # restores volatile tables from the manifest tip instead of
        # replaying batch frames. Unset = bit-exact legacy behavior
        # (no store constructed, no compaction thread)
        self.store = None
        self._compact_min_files = int(lakehouse_compaction_min_files)
        self._compact_interval = float(lakehouse_compaction_interval_s)
        self._orphan_ttl = float(lakehouse_orphan_ttl_s)
        if lakehouse_path:
            from presto_tpu_torch.server.manifests import (
                DEFAULT_TARGET_FILE_BYTES,
                ManifestStore,
            )

            self.store = ManifestStore(
                lakehouse_path,
                target_file_bytes=(
                    lakehouse_target_file_bytes
                    or DEFAULT_TARGET_FILE_BYTES
                ),
            )
        #: dotted 3-part name -> lane
        self._lanes: Dict[str, _TableLane] = {}
        self._lanes_mu = threading.Lock()
        #: serializes whole commit passes (the loop vs explicit flush):
        #: commit frames and connector folds must land in seq order
        self._commit_mu = threading.Lock()
        self._mv_mu = threading.Lock()
        self._stop = threading.Event()
        # per-MANAGER tallies (the REGISTRY counters are process-global
        # and survive restarts within one process — stats()/the caches
        # row must report THIS lane, not every lane ever constructed)
        self._n_batches = 0
        self._n_commits = 0
        self._n_replayed = 0
        runner.ingest = self
        self._replay()
        self._thread = None
        self._compact_thread = None
        if start_thread and self.commit_interval_ms > 0:
            self._thread = threading.Thread(
                target=self._commit_loop,
                name="ingest-commit",
                daemon=True,
            )
            self._thread.start()
        if (
            start_thread
            and self.store is not None
            and self._compact_interval > 0
        ):
            self._compact_thread = threading.Thread(
                target=self._compaction_loop,
                name="lakehouse-compaction",
                daemon=True,
            )
            self._compact_thread.start()

    # --------------------------------------------------------- resolve

    def _resolve(self, table) -> Tuple[str, str, str]:
        if isinstance(table, str):
            parts = tuple(p for p in table.split(".") if p)
        else:
            parts = tuple(table)
        sess = self.runner.session
        if len(parts) == 3:
            return parts  # type: ignore[return-value]
        if len(parts) == 2:
            return (sess.catalog, parts[0], parts[1])
        if len(parts) == 1:
            return (sess.catalog, sess.schema, parts[0])
        raise IngestError(f"bad table name {table!r}")

    def _lane(self, handle: TableHandle) -> _TableLane:
        dotted = ".".join(handle.table_key)
        with self._lanes_mu:
            lane = self._lanes.get(dotted)
            if lane is None:
                lane = _TableLane(
                    handle,
                    os.path.join(
                        self.path, f"{_WAL_PREFIX}{dotted}{_WAL_SUFFIX}"
                    ),
                )
                self._lanes[dotted] = lane
            return lane

    # ------------------------------------------------------------ disk

    def _write_frame(self, lane_or_path, *recs: dict) -> None:
        """Append one or more frames in ONE open (caller holds the
        owning lock — on-disk frame order must equal logical order or
        replay diverges)."""
        path = (
            lane_or_path.path
            if isinstance(lane_or_path, _TableLane)
            else lane_or_path
        )
        chunk = "".join(
            _wal_frame(json.dumps(rec, default=str)) + "\n"
            for rec in recs
        )
        faults.maybe_inject_io("write", path)
        with open(path, "a", encoding="utf-8") as f:
            f.write(chunk)
            f.flush()
            # the append is ACKED as durable, so it must BE durable
            # before the ack — flush alone leaves it in the page cache
            faults.maybe_inject_io("fsync", path)
            os.fsync(f.fileno())
        REGISTRY.counter("ingest.wal_bytes").update(len(chunk.encode()))

    # ---------------------------------------------------------- append

    def append(self, table, columns=None, rows=None) -> dict:
        """Durably append one row micro-batch to ``table``'s WAL.
        Accepts columnar ``columns={col: [values]}`` or row-dict
        ``rows=[{col: value}, ...]`` form. The batch is acknowledged
        once framed on disk; it becomes VISIBLE to readers at the next
        commit (snapshot semantics — never a torn batch)."""
        parts = self._resolve(table)
        handle = TableHandle(*parts)
        conn = self.runner.catalogs.get(handle.catalog)
        if not hasattr(conn, "commit_snapshot"):
            raise IngestError(
                f"catalog {handle.catalog} does not support snapshot "
                "commits (ingest needs the snapshot SPI)"
            )
        tschema = conn.metadata().get_table_schema(handle)
        if rows is not None:
            if columns is not None:
                raise IngestError("pass either rows or columns, not both")
            # validate row keys BEFORE projecting onto the schema —
            # r.get(c) would otherwise silently drop a typo'd column
            # (and NULL-fill the real one) with a 200 ack
            seen = set()
            for r in rows:
                seen.update(r)
            unknown = seen - set(tschema)
            if unknown:
                raise IngestError(
                    f"unknown column(s) {sorted(unknown)}"
                )
            missing = set(tschema) - seen
            if missing:
                raise IngestError(
                    f"missing column(s) {sorted(missing)}"
                )
            columns = {
                c: [r.get(c) for r in rows] for c in tschema
            }
        if not columns:
            raise IngestError("empty batch: no rows/columns payload")
        unknown = set(columns) - set(tschema)
        if unknown:
            raise IngestError(f"unknown column(s) {sorted(unknown)}")
        missing = set(tschema) - set(columns)
        if missing:
            raise IngestError(f"missing column(s) {sorted(missing)}")
        lens = {c: len(v) for c, v in columns.items()}
        n = next(iter(lens.values()))
        if any(m != n for m in lens.values()):
            raise IngestError(f"ragged batch: column lengths {lens}")
        if n == 0:
            raise IngestError("empty batch: zero rows")
        coerced = {
            c: [_coerce_value(v, tschema[c]) for v in columns[c]]
            for c in tschema
        }
        lane = self._lane(handle)
        with lane.lock:
            recs = []
            if not os.path.exists(lane.path):
                # first frame of a fresh WAL: the schema, so replay
                # can recreate the table in the volatile store
                recs.append(
                    {
                        "ev": "schema",
                        "table": ".".join(parts),
                        "cols": {
                            c: str(t) for c, t in tschema.items()
                        },
                    }
                )
            lane.seq += 1
            seq = lane.seq
            recs.append({"ev": "batch", "seq": seq, "cols": coerced})
            self._write_frame(lane, *recs)
            lane.pending.append((seq, coerced, n))
            pending = len(lane.pending)
            self._n_batches += 1
        REGISTRY.counter("ingest.batches").update()
        REGISTRY.counter("ingest.rows").update(n)
        return {
            "table": ".".join(parts),
            "seq": seq,
            "rows": n,
            "pending_batches": pending,
        }

    # ---------------------------------------------------------- commit

    def _commit_loop(self) -> None:
        interval = max(self.commit_interval_ms, 1.0) / 1000.0
        while not self._stop.wait(interval):
            try:
                self.commit_tick()
            except Exception:
                log.warning("ingest commit tick failed", exc_info=True)

    def commit_tick(self) -> int:
        """Fold every table's pending tail into a new committed
        snapshot. Returns the number of tables committed."""
        with self._lanes_mu:
            lanes = list(self._lanes.values())
        done = 0
        for lane in lanes:
            if lane.pending and self._flush_lane(lane):
                done += 1
        return done

    def flush(self) -> int:
        """Synchronous commit of everything pending (tests, the
        endpoint's ``commit`` flag, shutdown)."""
        return self.commit_tick()

    def _flush_lane(self, lane: _TableLane) -> bool:
        t0 = time.perf_counter()
        with self._commit_mu:
            with lane.lock:
                if not lane.pending:
                    return False
                batches = lane.pending
                lane.pending = []
                upto = batches[-1][0]
                # sid == the last folded seq, so ids are per-table
                # monotone. Legacy (no lakehouse): the commit frame is
                # the durability point AND the id mint. Lakehouse: the
                # manifest ``_current`` swap below is the durability
                # point — the frame just lets replay skip the tail
                sid = upto
            handle = lane.handle
            conn = self.runner.catalogs.get(handle.catalog)
            tschema = conn.metadata().get_table_schema(handle)
            delta = {
                c: [v for _seq, cols, _n in batches for v in cols[c]]
                for c in tschema
            }
            # durable publish FIRST (manifest-backed tables): a disk
            # failure at ANY stage leaves the old tip reachable — the
            # batches go back to the pending front and the whole
            # commit retries cleanly. The acked WAL frames are
            # untouched either way: never an acked-batch loss
            published = folded = False
            try:
                published, folded = self._publish_durable(
                    handle, conn, tschema, delta, sid
                )
            except (OSError, RuntimeError):
                REGISTRY.counter("lakehouse.commit_retries").update()
                log.warning(
                    "lakehouse publish of %s@%s failed — commit will "
                    "retry", ".".join(handle.table_key), sid,
                    exc_info=True,
                )
                with lane.lock:
                    lane.pending = batches + lane.pending
                return False
            try:
                with lane.lock:
                    self._write_frame(
                        lane,
                        {"ev": "commit", "upto": upto, "snapshot": sid},
                    )
                    lane.committed = upto
            except OSError:
                if not published:
                    # legacy mode: the frame WAS the durability point
                    # — nothing committed, retry the whole batch set
                    with lane.lock:
                        lane.pending = batches + lane.pending
                    return False
                # the manifest tip is durable; replay reconciles
                # ``committed = max(wal upto, manifest tip)`` without
                # the frame, so the commit stands
                with lane.lock:
                    lane.committed = upto
                log.warning(
                    "WAL commit frame for %s@%s lost (manifest tip "
                    "carries the commit)", ".".join(handle.table_key),
                    sid, exc_info=True,
                )
            if not folded:
                # fold the delta into the connector for visibility —
                # the lakehouse tee above was durability only (native
                # manifest connectors already folded inside their own
                # commit_snapshot)
                conn.commit_snapshot(handle, delta, sid)
            # drop staged pages + cached plans of every snapshot of
            # the table (and bump the MV staleness epoch through the
            # same audited seam)
            self.runner._invalidate_table_caches(handle)
            # sampled INSIDE the commit mutex, right after this
            # commit's own epoch bump: the registry uses it to
            # attribute the bump to the merged delta — a gap between
            # hint and the view's covered epoch means an interleaved
            # legacy write the delta does not carry
            reg = getattr(self.runner, "_mview_registry", None)
            epoch_hint = (
                reg._epoch(handle) if reg is not None else None
            )
        REGISTRY.counter("ingest.commits").update()
        self._n_commits += 1
        # MV maintenance OUTSIDE the commit mutex: merges are
        # associative+commutative, and holding a lock across device
        # work would stall appends. A maintenance failure must not
        # fail the commit (the data IS committed) — it logs, counts,
        # and the staleness read gate repairs the view on next read
        if reg is not None:
            try:
                reg.on_commit(handle, delta, sid, epoch_hint)
            except Exception:
                REGISTRY.counter("mview.maintenance_errors").update()
                log.warning(
                    "materialized-view maintenance failed for %s@%s",
                    ".".join(handle.table_key), sid, exc_info=True,
                )
        REGISTRY.distribution("ingest.commit_ms").add(
            (time.perf_counter() - t0) * 1000.0
        )
        return True

    # ------------------------------------------------------- lakehouse

    def _publish_durable(
        self, handle, conn, tschema, delta, sid
    ) -> Tuple[bool, bool]:
        """Durably publish one commit's delta as manifest snapshot
        ``sid`` BEFORE the WAL commit frame. Returns ``(published,
        folded)``: native manifest connectors fold visibility inside
        their own ``commit_snapshot`` (folded=True); volatile tables
        tee through the ingest-level store (folded=False); no store
        anywhere = legacy WAL-only commit (False, False). Raises on
        I/O failure — the caller restores the batches and retries."""
        if getattr(conn, "manifest_store", None) is not None:
            conn.commit_snapshot(handle, delta, sid)
            return True, True
        if self.store is None:
            return False, False
        tk = handle.table_key
        if not self.store.has_table(tk):
            # first lakehouse commit of this table: bootstrap the
            # manifest from the connector's live committed rows, so
            # pre-lakehouse history survives the first restart too
            pre = self._connector_rows(conn, handle, tschema)
            if pre is not None and any(
                len(v) for v in pre.values()
            ):
                delta = {
                    c: list(pre.get(c, ())) + list(delta.get(c, ()))
                    for c in tschema
                }
        self.store.commit(tk, tschema, delta, sid)
        return True, False

    def _connector_rows(self, conn, handle, tschema):
        """Full committed contents of a volatile table as python
        values (the manifest bootstrap input); None when unreadable."""
        try:
            nrows = int(
                conn.metadata().get_table_stats(handle).row_count or 0
            )
            if nrows == 0:
                return None
            page = conn.create_page_source(
                ConnectorSplit(handle, 0, nrows), list(tschema)
            )
            return {c: list(page[c]) for c in tschema}
        except Exception:
            log.warning(
                "lakehouse bootstrap read of %s failed",
                ".".join(handle.table_key), exc_info=True,
            )
            return None

    def _restore_from_tip(
        self, conn, handle, store, tip, batches, upto
    ) -> bool:
        """Restart recovery for a manifest-backed volatile table:
        rebuild the committed rows from the durable tip (bit-equal to
        what was committed — parquet round-trips the engine's value
        domain exactly), re-register the snapshot lineage so time
        travel survives the restart, then fold any WAL-only committed
        batches past the tip (commits from before the lakehouse was
        enabled). Returns False to fall back to pure-WAL restore."""
        tk = handle.table_key
        try:
            vals = store.read_values(tk, tip)
        except OSError:
            vals = None
        if vals is None:
            log.warning(
                "lakehouse restore of %s@%s failed — falling back to "
                "WAL replay", ".".join(tk), tip,
            )
            return False
        meta_schema = conn.metadata().get_table_schema(handle)
        conn.commit_snapshot(
            handle, {c: vals.get(c, []) for c in meta_schema}, tip
        )
        restore = getattr(conn, "restore_snapshots", None)
        if restore is not None:
            pairs = []
            for s in store.sids(tk):
                m = store.manifest(tk, s)
                if m is not None:
                    pairs.append((s, m.row_count))
            restore(handle, pairs)
        extra = [
            (s, batches[s]) for s in sorted(batches) if tip < s <= upto
        ]
        if extra:
            delta = {
                c: [
                    _coerce_value(v, meta_schema[c])
                    for _s, cols in extra
                    for v in cols.get(c, ())
                ]
                for c in meta_schema
            }
            conn.commit_snapshot(handle, delta, upto)
        REGISTRY.counter("lakehouse.restores").update()
        return True

    def _compaction_loop(self) -> None:
        interval = max(self._compact_interval, 0.05)
        while not self._stop.wait(interval):
            try:
                self.compaction_tick()
            except Exception:
                log.warning(
                    "lakehouse compaction tick failed", exc_info=True
                )

    def compaction_tick(self, force: bool = False) -> int:
        """Rewrite small commit files into ~target-file-bytes chunks,
        one new snapshot per table — background housekeeping that
        DEFERS to foreground queries (PR 13's low-priority lane:
        while any QoS lane has queued work, the tick yields). Also
        runs the TTL'd orphan GC. Returns tables compacted."""
        if self.store is None:
            return 0
        cluster = getattr(self.runner, "cluster", None)
        qos = getattr(cluster, "qos", None) if cluster else None
        if qos is not None and not force:
            idle = getattr(qos, "background_idle", None)
            if idle is not None and not idle():
                REGISTRY.counter(
                    "lakehouse.compaction_deferred"
                ).update()
                return 0
        with self._lanes_mu:
            lanes = list(self._lanes.values())
        done = 0
        for lane in lanes:
            handle = lane.handle
            try:
                conn = self.runner.catalogs.get(handle.catalog)
            except KeyError:
                continue
            store = getattr(conn, "manifest_store", None) or self.store
            tk = handle.table_key
            if not store.has_table(tk):
                continue
            with self._commit_mu:
                with lane.lock:
                    if lane.pending:
                        continue  # commit the tail first
                    # mint the compaction snapshot id from the lane's
                    # seq space (id minting stays confined here); a
                    # no-op tick just leaves a gap, which monotone
                    # per-table ids tolerate by design
                    lane.seq += 1
                    sid = lane.seq
                try:
                    m = store.compact(
                        tk, sid, min_files=self._compact_min_files
                    )
                except (OSError, RuntimeError):
                    log.warning(
                        "lakehouse compaction of %s failed",
                        ".".join(tk), exc_info=True,
                    )
                    continue
                if m is None:
                    continue
                if getattr(conn, "manifest_store", None) is None:
                    # register the compaction snapshot in the volatile
                    # store's history (empty delta: same rows, new id)
                    # so FOR VERSION AS OF the compacted snapshot pins
                    tschema = conn.metadata().get_table_schema(handle)
                    conn.commit_snapshot(
                        handle, {c: [] for c in tschema}, sid
                    )
                done += 1
            # pinned readers keep serving the old files — only the
            # TTL'd GC reclaims compacted-away snapshots
            self.runner._invalidate_table_caches(handle)
        if self._orphan_ttl > 0:
            try:
                self.store.gc_orphans(self._orphan_ttl)
            except OSError:
                pass
        return done

    # ------------------------------------------------ materialized views

    def record_mview(self, name: str, sql: str) -> None:
        """Durably record one CREATE MATERIALIZED VIEW (replay
        re-registers it before refreshing over the rebuilt base)."""
        with self._mv_mu:
            self._write_frame(
                os.path.join(self.path, _MVIEWS_FILE),
                {"ev": "mview", "name": name, "sql": sql},
            )

    def record_mview_drop(self, name: str) -> None:
        with self._mv_mu:
            self._write_frame(
                os.path.join(self.path, _MVIEWS_FILE),
                {"ev": "mview_drop", "name": name},
            )

    # ---------------------------------------------------------- replay

    def _wal_files(self) -> List[str]:
        try:
            names = sorted(
                f
                for f in os.listdir(self.path)
                if f.startswith(_WAL_PREFIX) and f.endswith(_WAL_SUFFIX)
            )
        except OSError:
            return []
        return [os.path.join(self.path, f) for f in names]

    def _replay(self) -> None:
        """Crash recovery: rebuild each table's committed snapshot from
        its WAL and re-admit the uncommitted tail exactly once, then
        re-register durable materialized views and refresh them over
        the rebuilt bases. Assumes the backing store is the volatile
        memory connector starting empty (a table that ALREADY exists is
        assumed live — its committed rows are not re-applied)."""
        corrupt = 0
        replayed_tail = 0
        for path in self._wal_files():
            tschema_txt: Dict[str, str] = {}
            dotted = os.path.basename(path)[
                len(_WAL_PREFIX):-len(_WAL_SUFFIX)
            ]
            batches: "Dict[int, dict]" = {}
            upto = 0
            sid = 0
            try:
                with open(path, encoding="utf-8") as f:
                    for raw in f:
                        if not raw.strip():
                            continue
                        rec = _parse_wal_line(raw)
                        if rec is None:
                            corrupt += 1
                            continue
                        ev = rec.get("ev")
                        if ev == "schema":
                            tschema_txt = dict(rec.get("cols") or {})
                            dotted = rec.get("table", dotted)
                        elif ev == "batch" and rec.get("seq"):
                            batches[int(rec["seq"])] = (
                                rec.get("cols") or {}
                            )
                        elif ev == "commit":
                            upto = max(upto, int(rec.get("upto", 0)))
                            sid = max(
                                sid, int(rec.get("snapshot", upto))
                            )
            except OSError:
                continue
            # heal the tail boundary: a torn final line has no
            # newline, and the NEXT append would fuse with it into one
            # unparseable frame — losing a GOOD commit/batch frame to
            # a crash that already happened
            try:
                with open(path, "rb") as f:
                    f.seek(-1, os.SEEK_END)
                    last = f.read(1)
                if last and last != b"\n":
                    with open(path, "a", encoding="utf-8") as f:
                        f.write("\n")
            except OSError:
                pass
            if not tschema_txt and not batches:
                continue
            parts = self._resolve(dotted)
            handle = TableHandle(*parts)
            # the lane's seq/committed watermarks restore BEFORE any
            # catalog-dependent work: even when the data cannot be
            # re-applied, a later append must never reuse a seq an
            # on-disk commit frame already covers (a reused seq makes
            # the NEXT replay promote the wrong batch to committed)
            lane = self._lane(handle)
            lane.seq = max([upto] + list(batches))
            lane.committed = upto
            try:
                conn = self.runner.catalogs.get(handle.catalog)
            except KeyError:
                log.warning(
                    "ingest replay: catalog %s not mounted — %s's "
                    "committed WAL rows were NOT restored (mount "
                    "catalogs before the manager constructs, e.g. "
                    "pass them to CoordinatorServer); seq watermarks "
                    "preserved",
                    handle.catalog, dotted,
                )
                continue
            tschema = {
                c: T.parse_type(t) for c, t in tschema_txt.items()
            }
            # lakehouse reconciliation: the manifest ``_current`` tip
            # may be AHEAD of the last WAL commit frame (a crash hit
            # the window between the durable publish and the frame) —
            # the tip wins, and the watermarks move up so the covered
            # batches are NOT re-admitted (exactly-once tail replay)
            cstore = getattr(conn, "manifest_store", None)
            store = cstore if cstore is not None else self.store
            tk = handle.table_key
            tip = None
            if store is not None and store.has_table(tk):
                tip = store.current_sid(tk)
            if tip is not None:
                lane.seq = max(lane.seq, tip)
                lane.committed = max(upto, tip)
            try:
                existing = handle.table in conn.metadata().list_tables(
                    handle.schema
                )
            except Exception:
                existing = False
            if not existing and tschema:
                conn.create_table(handle, tschema)
            # re-apply committed rows unless the table already exists
            # WITH data (then it is assumed live — a second manager
            # over a live runner must not double-apply). An existing
            # but EMPTY table is the idempotent re-create pattern
            # (embedder re-ran CREATE TABLE before recovery): its
            # committed rows are on disk only, so apply them
            table_rows = 0.0
            if existing:
                try:
                    table_rows = float(
                        conn.metadata()
                        .get_table_stats(handle)
                        .row_count
                        or 0.0
                    )
                except Exception:
                    table_rows = 0.0
            restored_from_tip = False
            if (
                tip is not None
                and cstore is None
                and table_rows == 0.0
            ):
                restored_from_tip = self._restore_from_tip(
                    conn, handle, store, tip, batches, upto
                )
            if (
                upto
                and table_rows == 0.0
                and not restored_from_tip
                and cstore is None
            ):
                committed = [
                    (s, batches[s]) for s in sorted(batches) if s <= upto
                ]
                if committed:
                    meta_schema = conn.metadata().get_table_schema(
                        handle
                    )
                    delta = {
                        c: [
                            _coerce_value(v, meta_schema[c])
                            for _s, cols in committed
                            for v in cols.get(c, ())
                        ]
                        for c in meta_schema
                    }
                    conn.commit_snapshot(handle, delta, sid or upto)
            # the uncommitted tail re-admits EXACTLY once: queued as
            # pending (its batch frames are already on disk — the next
            # commit only adds the commit frame), never applied here
            meta_schema = conn.metadata().get_table_schema(handle)
            for s in sorted(batches):
                if s <= lane.committed:
                    continue
                cols = {
                    c: [
                        _coerce_value(v, meta_schema[c])
                        for v in batches[s].get(c, ())
                    ]
                    for c in meta_schema
                }
                n = (
                    len(next(iter(cols.values()))) if cols else 0
                )
                lane.pending.append((s, cols, n))
                replayed_tail += 1
        if corrupt:
            REGISTRY.counter("ingest.wal_corrupt").update(corrupt)
            log.warning(
                "ingest replay skipped %d corrupt/torn line(s) under %s",
                corrupt, self.path,
            )
        if replayed_tail:
            REGISTRY.counter("ingest.replayed").update(replayed_tail)
            self._n_replayed = replayed_tail
        self._replay_mviews()

    def _replay_mviews(self) -> None:
        path = os.path.join(self.path, _MVIEWS_FILE)
        if not os.path.exists(path):
            return
        live: "Dict[str, str]" = {}
        try:
            with open(path, encoding="utf-8") as f:
                for raw in f:
                    if not raw.strip():
                        continue
                    rec = _parse_wal_line(raw)
                    if rec is None:
                        REGISTRY.counter("ingest.wal_corrupt").update()
                        continue
                    if rec.get("ev") == "mview" and rec.get("name"):
                        live[rec["name"]] = rec.get("sql", "")
                    elif rec.get("ev") == "mview_drop":
                        live.pop(rec.get("name"), None)
        except OSError:
            return
        reg = self.runner.mview_registry
        for name, sql in live.items():
            mv = reg.restore(sql)
            if mv is not None:
                # rebuild state + stored contents from the recovered
                # base — bit-identical to a cold full refresh by
                # construction (it IS one)
                try:
                    reg.refresh_view(mv, mode="replay")
                except Exception:
                    log.warning(
                        "ingest replay: refresh of %s failed", name,
                        exc_info=True,
                    )

    # ----------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lanes_mu:
            lanes = list(self._lanes.values())
        pending_b = sum(len(ln.pending) for ln in lanes)
        pending_r = sum(
            n for ln in lanes for _s, _c, n in ln.pending
        )
        # actual on-disk occupancy of THIS lane's directory — the
        # written-bytes counter is process-global and zero after a
        # restart that wrote nothing yet
        wal_bytes = 0
        for path in self._wal_files() + [
            os.path.join(self.path, _MVIEWS_FILE)
        ]:
            try:
                wal_bytes += os.path.getsize(path)
            except OSError:
                pass
        return {
            "tables": len(lanes),
            "pending_batches": pending_b,
            "pending_rows": pending_r,
            "wal_bytes": wal_bytes,
            "batches": self._n_batches,
            "commits": self._n_commits,
            "replayed": self._n_replayed,
        }

    def close(self, final_flush: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._compact_thread is not None:
            self._compact_thread.join(timeout=5.0)
        if final_flush:
            try:
                self.commit_tick()
            except Exception:
                log.warning(
                    "ingest final flush failed", exc_info=True
                )

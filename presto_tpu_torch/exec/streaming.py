"""Larger-than-device execution: split-streamed partial aggregation with
hash-bucketed host-RAM spill.

The PyTorch counterpart of ``presto_tpu/exec/streaming.py``. A query
whose scans exceed the session's ``max_device_rows`` runs like this:

- the plan is cut at the gather boundary (``parallel/fragmenter.py``);
- each fragment holding an oversized scan is cut at its lowest
  aggregation (``server/scheduler.py::plan_stage``): split batches of the
  scan, at one fixed capacity, run through the partial step;
- the partial states are hash-partitioned by group key into host-RAM
  buckets (``_spill_partial``);
- each bucket's final merge runs alone on the device
  (``merge_spilled_buckets``), and the rest of the plan runs over the
  merged result.

Plans with several big scans (TPC-H Q18) recurse: ``plan_stage``
refuses a cut that would replicate an oversized scan, so the inner
fragment streams first and its small result feeds the outer step as a
leaf. A join whose build side is oversized takes the build-side spill
(``_try_partitioned_join``): both sides are hash-partitioned by the join
keys into host buckets and joined bucket by bucket.

One addition to the reference: after a partitioned join, the
row-distributive chain above it (filters, projections, and joins the
bucket's rows probe into a side that fits) runs per bucket too
(``_bucket_chain``). The reference stages the whole join result on the
device before running that chain, which at TPC-H SF100 is Q18's
600,000,000 joined lineitem rows, far over the device budget. The result
is the same: each bucket's rows pass the same chain.

Bucket hashing (``_mix64``, ``_bucket_of``) runs on the host in numpy,
bit for bit as the reference's, so every row lands in the same bucket
and float merges add in the same order.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Dict, List, Tuple

import numpy as np

from presto_tpu_torch.connectors.tpch import DictColumn
from presto_tpu_torch.exec.staging import (
    MaskedColumn,
    bucket_capacity,
    prefetch_iter,
    stage_page,
)
from presto_tpu_torch.parallel.fragmenter import insert_gathers
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.server import pages_wire
from presto_tpu_torch.server.scheduler import (
    _edge_distributive,
    _path_to,
    _replace_on_path,
    plan_stage,
)


class StreamingError(RuntimeError):
    pass


@dataclasses.dataclass
class StreamStats:
    """What streamed execution did since the runner made it (or since
    the caller last replaced it): split batches run, the batches among
    them that produced no row, bucket runs on the device (final merges
    and bucket joins with rows in them), the bytes of staged split
    pages, the rows and bytes spilled to host buckets, and host seconds
    in connector generation, staging, bucket hashing and payload merges
    (the prefetch thread's included)."""

    batches: int = 0
    empty_batches: int = 0
    buckets: int = 0
    staged_bytes: int = 0
    spilled_rows: int = 0
    spilled_bytes: int = 0
    generate_s: float = 0.0
    stage_s: float = 0.0
    hash_s: float = 0.0
    merge_s: float = 0.0


def _prefetch_splits(runner, scan, ranges, capacity):
    """Staged split pages of ``ranges``, staged ahead on a host thread
    (``staging.prefetch_iter``; depth ``staging_prefetch_depth``, 0 is
    the serial loop)."""
    depth = int(runner.session.get("staging_prefetch_depth"))
    return prefetch_iter(
        ranges,
        lambda rng: runner._load_split(scan, rng[0], rng[1], capacity),
        depth,
    )


def _scan_rows(catalogs, scan: N.TableScanNode) -> int:
    conn = catalogs.get(scan.handle.catalog)
    return int(conn.metadata().get_table_stats(scan.handle).row_count or 0)


def needs_streaming(root: N.PlanNode, catalogs, session) -> bool:
    """True when some scan exceeds the device residency budget."""
    max_rows = int(session.get("max_device_rows"))
    return any(
        isinstance(n, N.TableScanNode) and _scan_rows(catalogs, n) > max_rows
        for n in N.walk(root)
    )


def run_streamed(runner, droot: N.PlanNode):
    """Execute a device plan whose inputs exceed ``max_device_rows``:
    cut it at the gather boundary, stream each oversized fragment, and
    run the root fragment over the gathered pages. Returns the host
    result page, as ``_run_with_pages`` does."""
    if not runner.session.get("spill_enabled"):
        raise StreamingError(
            "input exceeds max_device_rows and spill_enabled=false "
            "(the query fails on memory rather than spilling)"
        )
    froot = insert_gathers(droot)
    leaves = [
        n
        for n in N.walk(froot)
        if isinstance(n, (N.TableScanNode, N.RemoteSourceNode))
    ]
    # remote leaves RUN here (recursive fragment execution), so this
    # site cannot use runner.leaf_pages (which only resolves pages
    # already produced)
    pages = [
        _run_fragment(runner, leaf.fragment_root, {})
        if isinstance(leaf, N.RemoteSourceNode)
        else runner._load_table(leaf)
        for leaf in leaves
    ]
    return runner._run_with_pages(froot, leaves, pages)


# ------------------------------------------------------------- fragment


def _run_fragment(runner, frag_root: N.PlanNode, materialized: Dict):
    """Run one distributable fragment, streaming it if it holds an
    oversized scan; the result stays on the device. ``materialized``
    maps id(RemoteSourceNode) -> the device page an earlier step made."""
    max_rows = int(runner.session.get("max_device_rows"))
    if not _oversized_scans(runner, frag_root, max_rows):
        leaves, pages = runner.leaf_pages(frag_root, materialized)
        return runner._run_with_pages(
            frag_root, leaves, pages, fetch_result=False
        )

    stage = plan_stage(frag_root, runner.catalogs, replicated_limit=max_rows)
    if stage is None:
        out = _try_partitioned_join(runner, frag_root, materialized, max_rows)
        if out is not None:
            return out
        raise StreamingError(
            "fragment exceeds max_device_rows and admits no "
            "semantics-preserving streaming cut"
        )

    bucket_root, rest_root, frag_remote, rest_remote = _split_final(
        stage.final_root, stage.worker_fragment
    )

    # --- the single input pass: batch -> partial -> bucket spill
    batch = min(int(runner.session.get("page_capacity")), max_rows)
    batch_cap = bucket_capacity(batch)
    worker_root = _cap_cut_groups(stage.worker_fragment, batch_cap)
    part_scan = list(N.walk(worker_root))[stage.partition_scan]
    n_buckets = _n_buckets_for(stage.partition_rows, max_rows)
    key_names = _bucket_key_names(worker_root)
    schema = dict(worker_root.output_schema())

    leaves = [
        n
        for n in N.walk(worker_root)
        if isinstance(n, (N.TableScanNode, N.RemoteSourceNode))
    ]
    base_pages = {}
    for n in leaves:
        if isinstance(n, N.RemoteSourceNode):
            base_pages[id(n)] = materialized[id(n)]
        elif n is not part_scan:
            base_pages[id(n)] = runner._load_table(n)

    spill: List[List[tuple]] = [[] for _ in range(n_buckets)]
    # one fixed capacity for every batch, the tail included, so every
    # batch presents the same shapes
    ranges = [
        (lo, min(lo + batch, stage.partition_rows))
        for lo in range(0, stage.partition_rows, batch)
    ]
    for batch_page in _prefetch_splits(runner, part_scan, ranges, batch_cap):
        pages = [
            batch_page if n is part_scan else base_pages[id(n)]
            for n in leaves
        ]
        out = runner._run_with_pages(worker_root, leaves, pages)
        del batch_page, pages
        part_payload, _, nrows = _page_to_payload(out)
        runner.stream_stats.batches += 1
        if nrows == 0:
            runner.stream_stats.empty_batches += 1
            continue
        _spill_partial(
            spill, part_payload, schema, key_names, nrows, n_buckets,
            runner.stream_stats,
        )

    # --- per-bucket final merge on the device
    result = merge_spilled_buckets(
        runner, spill, schema, bucket_root, frag_remote
    )
    if rest_root is None:
        return result
    # the rest of the fragment may hold further oversized scans: recurse
    return _run_fragment(
        runner, rest_root, {**materialized, id(rest_remote): result}
    )


def _n_buckets_for(rows: int, max_rows: int) -> int:
    """Spill bucket count: 4x over-partitioned so each bucket's merge
    stays well under the residency budget despite skew."""
    return max(1, -(-rows // max_rows) * 4)


def grouped_final_merge(
    runner, payloads, schema, final_root, worker_fragment, max_rows
):
    """Gathered partial states larger than the device budget, merged
    one group-key bucket at a time. Returns the final page, or None when
    bucketing does not apply (a small gather, or no group keys).
    Disabled spill fails the query, as ``run_streamed`` does."""
    total_rows = sum(n for _, _, n in payloads)
    key_names = _bucket_key_names(worker_fragment)
    if total_rows <= max_rows or not key_names:
        return None
    if not runner.session.get("spill_enabled"):
        raise StreamingError(
            "gathered partial states exceed max_device_rows and "
            "spill_enabled=false (the query fails on memory rather than "
            "spilling)"
        )
    bucket_root, rest_root, frag_remote, rest_remote = _split_final(
        final_root, worker_fragment
    )
    n_buckets = _n_buckets_for(total_rows, max_rows)
    spill = bucketize_payloads(
        payloads, schema, key_names, n_buckets, runner.stream_stats
    )
    page = merge_spilled_buckets(runner, spill, schema, bucket_root, frag_remote)
    if rest_root is None:
        return page
    local_scans = [
        n for n in N.walk(rest_root) if isinstance(n, N.TableScanNode)
    ]
    leaves = [rest_remote] + local_scans
    pages = [page] + [runner._load_table(s) for s in local_scans]
    return runner._run_with_pages(rest_root, leaves, pages)


def _merge_timed(runner, parts, schema):
    t0 = time.perf_counter()
    merged = pages_wire.merge_payloads(parts, schema)
    runner.stream_stats.merge_s += time.perf_counter() - t0
    return merged


def _empty_payload(schema) -> Dict:
    return {name: np.empty(0, t.np_dtype) for name, t in schema.items()}


def merge_spilled_buckets(
    runner, spill: List[List[tuple]], schema, bucket_root, frag_remote
):
    """Per-bucket final merge on the device: each bucket's partial
    states stage alone, run the bucket-safe chain and are freed, so the
    live device state stays one bucket's. Returns the merged result as
    a device page."""
    outs: List[tuple] = []
    out_schema = dict((bucket_root or frag_remote).output_schema())
    for b in range(len(spill)):
        if not spill[b]:
            continue
        merged = _merge_timed(runner, spill[b], schema)
        nrows = sum(n for _, _, n in spill[b])
        spill[b] = []  # free the spilled partials as we go
        runner.stream_stats.buckets += 1
        if bucket_root is None:
            outs.append((merged, schema, nrows))
            continue
        page = stage_page(merged, schema, device=runner.device)
        broot = _cap_cut_groups(bucket_root, page.capacity)
        out = runner._run_with_pages(broot, [frag_remote], [page])
        pl = _page_to_payload(out)
        if pl[2]:
            outs.append(pl)
    merged = _merge_timed(runner, outs, out_schema) if outs else (
        _empty_payload(out_schema)
    )
    return stage_page(merged, out_schema, device=runner.device)


def bucketize_payloads(
    payloads: List[tuple],
    schema,
    key_names: List[str],
    n_buckets: int,
    stats: StreamStats,
) -> List[List[tuple]]:
    """Hash-partition payloads into group-key buckets (the spill shape
    ``merge_spilled_buckets`` consumes)."""
    spill: List[List[tuple]] = [[] for _ in range(n_buckets)]
    for payload, _pschema, nrows in payloads:
        if nrows:
            _spill_partial(
                spill, payload, schema, key_names, nrows, n_buckets, stats
            )
    return spill


def _split_final(final_root: N.PlanNode, worker_fragment: N.PlanNode = None):
    """Split the final plan into the bucket-safe chain (the final
    agg/distinct plus the filters and projections directly above it,
    safe because a group is whole within one bucket) and the rest.
    Returns (bucket_root|None, rest_root|None, remote, rest_remote|None),
    ``rest_remote`` being the leaf of rest_root the merged page binds to.

    ``worker_fragment`` names THIS stage's remote when the final plan
    holds several (recursion leaves earlier fragments' remotes in the
    tree)."""
    remote = next(
        n
        for n in N.walk(final_root)
        if isinstance(n, N.RemoteSourceNode)
        and (worker_fragment is None or n.fragment_root is worker_fragment)
    )
    path = _path_to(final_root, remote)
    j = len(path) - 2
    if j >= 0 and isinstance(path[j], (N.AggregationNode, N.DistinctNode)):
        j -= 1
        while j >= 0 and isinstance(path[j], (N.FilterNode, N.ProjectNode)):
            j -= 1
    bucket_root = path[j + 1]
    if bucket_root is remote:
        # no bucket-safe chain: the merged page binds to the stage
        # remote itself inside the (unchanged) rest plan
        return None, (None if final_root is remote else final_root), remote, remote
    if bucket_root is final_root:
        return bucket_root, None, remote, None
    rest_remote = N.RemoteSourceNode(fragment_root=bucket_root)
    rest_root = _replace_on_path(path[: j + 1], bucket_root, rest_remote)
    return bucket_root, rest_root, remote, rest_remote


def _cap_cut_groups(root: N.PlanNode, cap: int) -> N.PlanNode:
    """Rebind the cut agg/distinct's max_groups to the batch/bucket
    capacity: a batch never holds more groups than rows, so no stream
    step retries on group overflow."""
    if isinstance(root, (N.AggregationNode, N.DistinctNode)):
        return dataclasses.replace(root, max_groups=cap)
    target = next(
        (
            n
            for n in N.walk(root)
            if isinstance(n, (N.AggregationNode, N.DistinctNode))
            and isinstance(n.source, N.RemoteSourceNode)
        ),
        None,
    )
    if target is None:
        return root
    path = _path_to(root, target)
    return _replace_on_path(
        path[:-1], target, dataclasses.replace(target, max_groups=cap)
    )


def _bucket_key_names(worker_root: N.PlanNode) -> List[str]:
    """Group-key output columns of the cut node: the spill partition
    key (a DistinctNode dedups whole rows, so every column is key)."""
    if isinstance(worker_root, N.AggregationNode):
        return [n for n, _ in worker_root.group_keys]
    if isinstance(worker_root, N.DistinctNode):
        return list(worker_root.output_schema())
    return []  # no cut: a purely distributive fragment, one bucket


# ---------------------------------------------- partitioned join spill


def _oversized_scans(runner, root: N.PlanNode, max_rows: int):
    return [
        s
        for s in N.walk(root)
        if isinstance(s, N.TableScanNode)
        and _scan_rows(runner.catalogs, s) > max_rows
    ]


def _row_distributive_to_root(root: N.PlanNode, scan: N.PlanNode) -> bool:
    """True when every edge scan -> root is a Filter/Project (streaming
    batches of the scan through the subtree and concatenating equals
    running it whole)."""
    path = _path_to(root, scan)
    if path is None:
        return False
    return all(isinstance(p, (N.FilterNode, N.ProjectNode)) for p in path[:-1])


def _bucket_chain(runner, frag_root, J, max_rows):
    """The path frag_root -> ``J`` and the index in it of the topmost
    ancestor reached through row-distributive edges
    (``_edge_distributive``; FULL joins excluded) whose other inputs
    hold no oversized scan: running that ancestor's subtree over each
    bucket's join rows and concatenating equals running it over the
    whole join result. The index is ``J``'s own when no edge qualifies."""
    path = _path_to(frag_root, J)
    top = len(path) - 1
    while top > 0:
        parent, child = path[top - 1], path[top]
        if not _edge_distributive(parent, child) or (
            isinstance(parent, N.JoinNode) and parent.join_type == "full"
        ):
            break
        others = [c for c in parent.children() if c is not child]
        if any(_oversized_scans(runner, o, max_rows) for o in others):
            break
        top -= 1
    return path, top


def _try_partitioned_join(
    runner, frag_root: N.PlanNode, materialized: Dict, max_rows: int
):
    """Join build-side spill. When a join's BUILD side exceeds the
    device budget (so neither side can be replicated and no agg cut
    applies), hash-partition BOTH sides by the equi-join keys into
    host-RAM buckets, each side streamed in split batches through its
    own sub-fragment, then join bucket by bucket on the device. Valid
    for every equi-join type: a key lands in one bucket on both sides,
    so the bucket joins partition the whole join (probe-preserved rows
    included). The row-distributive chain above the join runs per
    bucket as well (``_bucket_chain``). Returns the fragment's result
    page, or None when no join admits this shape."""
    for J in N.walk(frag_root):
        if not isinstance(J, N.JoinNode):
            continue
        if not _oversized_scans(runner, J.right, max_rows):
            continue  # the build fits: not this join's problem
        sides = []
        for side_root, keys in ((J.left, J.left_keys), (J.right, J.right_keys)):
            big = _oversized_scans(runner, side_root, max_rows)
            if len(big) > 1 or (
                big and not _row_distributive_to_root(side_root, big[0])
            ):
                sides = None
                break
            sides.append((side_root, list(keys), big[0] if big else None))
        if sides is None:
            continue
        probe_rows = sum(
            _scan_rows(runner.catalogs, s)
            for s in N.walk(J.left)
            if isinstance(s, N.TableScanNode)
        )
        build_rows = sum(
            _scan_rows(runner.catalogs, s)
            for s in N.walk(J.right)
            if isinstance(s, N.TableScanNode)
        )
        n_buckets = _n_buckets_for(probe_rows + build_rows, max_rows)
        (p_spill, p_schema), (b_spill, b_schema) = [
            _stream_side_to_buckets(
                runner, side_root, keys, big_scan, n_buckets, materialized,
                max_rows,
            )
            for side_root, keys, big_scan in sides
        ]

        lremote = N.RemoteSourceNode(fragment_root=J.left)
        rremote = N.RemoteSourceNode(fragment_root=J.right)
        bucket_join = dataclasses.replace(J, left=lremote, right=rremote)
        path, top = _bucket_chain(runner, frag_root, J, max_rows)
        chain = path[top]
        bucket_root = (
            bucket_join
            if chain is J
            else _replace_on_path(path[top:-1], J, bucket_join)
        )
        out_schema = dict(bucket_root.output_schema())
        outs: List[tuple] = []
        for b in range(n_buckets):
            # probe-preserved types skip probe-empty buckets; FULL also
            # preserves build rows, so build-only buckets still run
            if not p_spill[b] and (J.join_type != "full" or not b_spill[b]):
                p_spill[b], b_spill[b] = [], []
                continue
            p_page = stage_page(
                _merge_timed(runner, p_spill[b], p_schema)
                if p_spill[b] else _empty_payload(p_schema),
                p_schema,
                device=runner.device,
            )
            b_page = stage_page(
                _merge_timed(runner, b_spill[b], b_schema)
                if b_spill[b] else _empty_payload(b_schema),
                b_schema,
                device=runner.device,
            )
            p_spill[b], b_spill[b] = [], []  # free as we go
            runner.stream_stats.buckets += 1
            leaves, pages = runner.leaf_pages(
                bucket_root,
                {**materialized, id(lremote): p_page, id(rremote): b_page},
            )
            out = runner._run_with_pages(bucket_root, leaves, pages)
            del p_page, b_page, pages
            pl = _page_to_payload(out)
            if pl[2]:
                outs.append(pl)

        merged = _merge_timed(runner, outs, out_schema) if outs else (
            _empty_payload(out_schema)
        )
        chain_page = stage_page(merged, out_schema, device=runner.device)
        if chain is frag_root:
            return chain_page
        remote = N.RemoteSourceNode(fragment_root=chain)
        rest_root = _replace_on_path(path[:top], chain, remote)
        return _run_fragment(
            runner, rest_root, {**materialized, id(remote): chain_page}
        )
    return None


def _stream_side_to_buckets(
    runner,
    side_root: N.PlanNode,
    key_cols: List[str],
    big_scan,
    n_buckets: int,
    materialized: Dict,
    max_rows: int,
):
    """Run one join side, hash-bucketing its output rows by the join
    keys into host-RAM spill buckets. A side with no oversized scan
    runs whole; a side with one streams it in split batches."""
    schema = dict(side_root.output_schema())
    spill: List[List[tuple]] = [[] for _ in range(n_buckets)]
    stats = runner.stream_stats

    def spill_page(page):
        payload, _pschema, nrows = _page_to_payload(page)
        if nrows:
            _spill_partial(
                spill, payload, schema, key_cols, nrows, n_buckets, stats
            )

    if big_scan is None:
        leaves, pages = runner.leaf_pages(side_root, materialized)
        spill_page(runner._run_with_pages(side_root, leaves, pages))
        return spill, schema

    # _row_distributive_to_root admitted only Filter/Project edges, so
    # the side is a linear chain and big_scan its ONLY leaf
    batch = min(int(runner.session.get("page_capacity")), max_rows)
    batch_cap = bucket_capacity(batch)
    total = _scan_rows(runner.catalogs, big_scan)
    ranges = [(lo, min(lo + batch, total)) for lo in range(0, total, batch)]
    for batch_page in _prefetch_splits(runner, big_scan, ranges, batch_cap):
        out = runner._run_with_pages(side_root, [big_scan], [batch_page])
        del batch_page
        stats.batches += 1
        if int(out.num_valid) == 0:
            stats.empty_batches += 1
        spill_page(out)
    return spill, schema


# ------------------------------------------------------- host-side spill


def _page_to_payload(page) -> Tuple[Dict, Dict, int]:
    """A result page -> (staging payload, schema, nrows) over host
    numpy, read in place from the runner's host result page. Dictionary
    values stay the page's own object."""
    cols, n = pages_wire.page_to_wire_columns(page)
    payload: Dict = {}
    schema: Dict = {}
    for name, data, valid, dtype, dict_values in cols:
        schema[name] = dtype
        if valid is not None:
            payload[name] = MaskedColumn(data=data, valid=valid, values=dict_values)
        elif dict_values is not None:
            payload[name] = DictColumn(
                ids=np.asarray(data, np.int32), values=dict_values
            )
        else:
            payload[name] = data
    return payload, schema, n


def _mix64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


#: the per-value crc image of recently hashed dictionaries, by the
#: identity of their values object (held, so the id stays theirs): the
#: batches of one stream share their dictionaries, and hashing 15,000,000
#: customer names once per batch would dominate the stream
_CRC_IMAGES: Dict[int, tuple] = {}
_CRC_IMAGES_MAX = 8


def _crc_image(values) -> np.ndarray:
    hit = _CRC_IMAGES.get(id(values))
    if hit is not None and hit[0] is values:
        return hit[1]
    crc = np.asarray(
        [zlib.crc32(str(v).encode()) for v in np.asarray(values, object)],
        np.uint64,
    )
    if len(_CRC_IMAGES) >= _CRC_IMAGES_MAX:
        _CRC_IMAGES.pop(next(iter(_CRC_IMAGES)))
    _CRC_IMAGES[id(values)] = (values, crc)
    return crc


def _col_hash_input(col, nrows: int) -> np.ndarray:
    """uint64 image of a column for bucket hashing. Dictionary ids map
    through a per-VALUE crc, so the hash is stable across batches whose
    dictionaries differ; NULLs hash to 0 (one bucket)."""
    if isinstance(col, MaskedColumn):
        base = _col_hash_input(
            DictColumn(ids=np.asarray(col.data, np.int64), values=col.values)
            if col.values is not None
            else col.data,
            nrows,
        )
        return np.where(col.valid[:nrows], base, np.uint64(0))
    if isinstance(col, DictColumn):
        if len(col.values) == 0:
            return np.zeros(nrows, np.uint64)
        crc = _crc_image(col.values)
        ids = np.clip(np.asarray(col.ids, np.int64), 0, len(crc) - 1)
        return crc[ids[:nrows]]
    data = np.asarray(col)[:nrows]
    if data.ndim == 2 and data.shape[1] == 2:
        # long-decimal limb pairs: mix the hi limb, fold in lo
        hi = data[:, 0].astype(np.int64).view(np.uint64)
        lo = data[:, 1].astype(np.int64).view(np.uint64)
        return _mix64(hi) ^ lo
    if data.ndim != 1:
        raise NotImplementedError(f"cannot bucket-hash a {data.ndim}-D column")
    if data.dtype.kind == "f":
        d = data.astype(np.float64, copy=True)
        d[d == 0] = 0.0  # -0.0 hashes like +0.0
        return d.view(np.uint64)
    return data.astype(np.int64).view(np.uint64)


def _bucket_of(payload, key_names, nrows, n_buckets) -> np.ndarray:
    h = np.full(nrows, 0x9E3779B97F4A7C15, np.uint64)
    for name in key_names:
        h ^= _mix64(_col_hash_input(payload[name], nrows))
        h = _mix64(h)
    return (h % np.uint64(n_buckets)).astype(np.int64)


def _take(col, idx: np.ndarray):
    """Rows ``idx`` of one payload column."""
    if isinstance(col, MaskedColumn):
        return MaskedColumn(
            data=np.asarray(col.data)[idx],
            valid=np.asarray(col.valid)[idx],
            values=col.values,
        )
    if isinstance(col, DictColumn):
        return DictColumn(ids=np.asarray(col.ids)[idx], values=col.values)
    return np.asarray(col)[idx]


def _slice_payload(payload, schema, mask) -> Dict:
    """The rows of ``mask`` (a bool array over the first len(mask)
    rows) of every column of ``schema``."""
    idx = np.flatnonzero(mask)
    return {name: _take(payload[name], idx) for name in schema}


def _payload_nbytes(payload) -> int:
    total = 0
    for col in payload.values():
        if isinstance(col, MaskedColumn):
            total += col.data.nbytes + col.valid.nbytes
        elif isinstance(col, DictColumn):
            total += col.ids.nbytes
        else:
            total += col.nbytes
    return total


def _spill_partial(
    spill, payload, schema, key_names, nrows, n_buckets, stats: StreamStats
) -> None:
    """Append the first ``nrows`` rows of ``payload`` to the spill
    buckets of their keys. Each bucket gets its rows in payload order,
    as the reference's per-bucket masks give them: one stable sort of
    the bucket ids replaces a mask pass per bucket."""
    if n_buckets == 1 or not key_names:
        part = _truncate_payload(payload, schema, nrows)
        spill[0].append((part, schema, nrows))
        stats.spilled_rows += nrows
        stats.spilled_bytes += _payload_nbytes(part)
        return
    t0 = time.perf_counter()
    buckets = _bucket_of(payload, key_names, nrows, n_buckets)
    stats.hash_s += time.perf_counter() - t0
    order = np.argsort(
        buckets.astype(np.uint16 if n_buckets <= 1 << 16 else np.int64),
        kind="stable",
    )
    counts = np.bincount(buckets, minlength=n_buckets)
    cols = {name: _take(payload[name], order) for name in schema}
    ends = np.cumsum(counts)
    for b in np.flatnonzero(counts):
        lo, hi = int(ends[b] - counts[b]), int(ends[b])
        part = {name: _take(c, slice(lo, hi)) for name, c in cols.items()}
        spill[int(b)].append((part, schema, hi - lo))
        stats.spilled_bytes += _payload_nbytes(part)
    stats.spilled_rows += nrows


def _truncate_payload(payload, schema, nrows) -> Dict:
    return _slice_payload(payload, schema, np.ones(nrows, dtype=bool))

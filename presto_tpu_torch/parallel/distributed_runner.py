"""Distributed query runner: sharded fragments over a list of devices.

The PyTorch counterpart of ``presto_tpu/parallel/distributed_runner.py``
(reference: the DistributedQueryRunner test harness and the
scheduler/worker split it exercises: a stage is N identical tasks over
hash-partitioned data, exchanges move rows between stages, the root
stage gathers; SURVEY.md §2.4, §3.2, §4.3).

One controller, as in the reference. The reference runs one host
process that drives a device mesh through ``shard_map``; the port runs
one process holding a list of torch devices, one entry per shard. A
device may repeat, so n shards can live on one card: the one-card
analogue of the reference's virtual CPU mesh. A fragment's per-shard
work runs shard by shard on the eager operators; the exchanges are the
explicit collectives of ``parallel/exchange.py`` over per-shard page
lists:

- table scans are row-sharded across the shards (split parallelism),
- a grouped aggregation runs a partial step per shard, routes the
  partial states by key hash (all_to_all) or replicates them below
  ``repl_threshold`` (all_gather), then merges (the PARTIAL/FINAL
  split),
- a join replicates its build side (broadcast) or hash-repartitions both
  sides (partitioned), AddExchanges' REPLICATED vs PARTITIONED choice,
- the root fragment (final sort, limit, window, output) runs on the
  first device over the gathered fragment outputs.

Each subtree carries a distribution: ``"part"`` (rows split across the
shards) or ``"repl"`` (every shard holds the same rows). Replicated
results are gathered from shard 0; partitioned ones concatenate shards.

``torch.distributed`` is not this layer: the reference has no
multi-process mesh, and NCCL refuses two ranks on one GPU, so no
one-card run could exercise it. On one card no collective copies bytes
between cards: ``.to(device)`` to the same card is the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch import expr as E
from presto_tpu_torch.exec.local_runner import (
    ExecutionError,
    LocalQueryRunner,
    _control_vector,
    _in_order,
    _scale_capacities,
    cross_join_single_row,
)
from presto_tpu_torch.exec.staging import (
    MaskedColumn,
    bucket_capacity,
    stage_sharded,
)
from presto_tpu_torch.ops import (
    distinct as distinct_op,
    filter_project,
    hash_aggregate,
    hash_join,
    project,
    unnest,
    unnest_column,
)
from presto_tpu_torch.ops.join import cross_join
from presto_tpu_torch.page import Page, compact_page, resolve_device
from presto_tpu_torch.parallel.agg_split import split_aggregation
from presto_tpu_torch.parallel.exchange import (
    gather_stacked,
    page_row_bytes,
    partition_exchange,
    partition_hash,
    replicate,
    umod,
)
from presto_tpu_torch.parallel.fragmenter import insert_gathers
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.session import Session


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _shard_devices(n_devices, devices) -> List[torch.device]:
    """The shard list: ``devices`` as given (a device may repeat), or
    the first ``n_devices`` visible CUDA devices (all of them without a
    count). Never repeats a device on its own, and never drops to the
    CPU: a caller that wants shards there passes ``devices``."""
    if devices is not None:
        devices = [resolve_device(d) for d in devices]
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(
                f"n_devices={n_devices} but {len(devices)} devices given"
            )
        if not devices:
            raise ValueError("a distributed runner needs at least one device")
        return devices
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass devices=['cpu'] * n to run the "
            "port's shards on the CPU"
        )
    visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is None:
        return visible
    if n_devices > len(visible):
        raise ValueError(
            f"{n_devices} shards asked of {len(visible)} visible CUDA "
            f"device(s): pass devices=[torch.device('cuda', 0)] * "
            f"{n_devices} to put several shards on one card"
        )
    return visible[:n_devices]


class DistributedQueryRunner(LocalQueryRunner):
    """A LocalQueryRunner whose distributable plan subtrees execute
    shard by shard over ``devices``, with the exchanges between shards
    as collectives. The root fragment runs on ``devices[0]``."""

    def __init__(
        self,
        n_devices: Optional[int] = None,
        devices: Optional[Sequence] = None,
        catalogs=None,
        session=None,
        broadcast_threshold: int = 1 << 16,
        repl_threshold: int = 1 << 13,
    ):
        session = session or Session()
        if n_devices is None and devices is None:
            # hash_partition_count session property (reference: the
            # fixed hash-distribution width; 0 = every device)
            hpc = int(session.get("hash_partition_count"))
            if hpc > 0:
                n_devices = hpc
        self.devices = _shard_devices(n_devices, devices)
        super().__init__(
            catalogs=catalogs, session=session, device=self.devices[0]
        )
        self.n = len(self.devices)
        self.broadcast_threshold = broadcast_threshold
        self.repl_threshold = repl_threshold
        #: sharded tables by (handle, columns, constraint, n): the shard
        #: pages and their host row counts
        self._shard_cache: Dict[tuple, Tuple[List[Page], List[int]]] = {}
        #: since the runner was made: fragments run, their host reads
        #: (one per attempt, every shard's flags, errors and counts
        #: stacked), attempts re-run at a doubled balance factor, and the
        #: bytes each kind of collective routed (static slab shapes:
        #: all_to_all sends n * bucket_cap rows per source, all_gather
        #: every shard's capacity to every shard, gather the live rows)
        self.fragment_runs = 0
        self.fragment_reads = 0
        self.balance_retries = 0
        self.collective_bytes = {"all_to_all": 0, "all_gather": 0, "gather": 0}

    # ---------------------------------------------------------------- run

    def execute_plan(self, plan, qs=None):
        # the sharded executor (_exec_dist) has no parameter-vector
        # plumbing: run statement-cache plans in literal form (the cache
        # still skips planning; _run_with_pages re-hoists the root)
        from presto_tpu_torch.plan import canonical

        return super().execute_plan(canonical.materialize_plan(plan), qs=qs)

    def _run(
        self, root: N.PlanNode, topn: Optional[N.SortNode] = None
    ) -> Page:
        if self.n == 1:
            return super()._run(root, topn)
        froot = insert_gathers(root)
        sources = [
            n
            for n in N.walk(froot)
            if isinstance(n, (N.TableScanNode, N.RemoteSourceNode))
        ]
        pages: List[Page] = []
        for s in sources:
            if isinstance(s, N.RemoteSourceNode):
                pages.append(self._run_fragment(s.fragment_root))
            else:
                pages.append(self._load_table(s))
        return self._run_with_pages(froot, sources, pages, topn=topn)

    # ----------------------------------------------------- fragment stage

    def _run_fragment(self, froot: N.PlanNode) -> Page:
        """Run one distributable fragment over the sharded tables,
        re-running at 4x capacities and a doubled balance factor while
        any shard overflows; gather its output onto ``devices[0]``."""
        scans = [n for n in N.walk(froot) if isinstance(n, N.TableScanNode)]
        tables = [self._load_table_sharded(s) for s in scans]
        balance = 2
        tries = 0
        root = froot
        self.fragment_runs += 1
        while True:
            out, dist, flags, errors = self._execute_fragment(
                root, scans, tables, balance
            )
            control = self._read_control(flags, errors, out)
            nf, ne = len(flags), len(errors)
            for (msg, _), bit in zip(errors, control[nf:nf + ne]):
                if bit:
                    raise ExecutionError(msg)
            if not any(control[:nf]):
                return self._gather(out, control[nf + ne:], dist == "repl")
            tries += 1
            self.balance_retries += 1
            if tries >= self.MAX_RETRIES:
                raise ExecutionError(
                    "capacity overflow persisted after distributed retries"
                )
            root = _scale_capacities(root, 4)
            balance *= 2

    def _read_control(self, flags, errors, out) -> List[int]:
        """THE host read of a fragment attempt: every shard's overflow
        flags, error flags and output count, stacked on ``devices[0]``
        and copied in one transfer."""
        dev = self.devices[0]
        scalars = (
            [f.reshape(()).to(dev) for f in flags]
            + [e.reshape(()).to(dev) for _, e in errors]
            + [p.num_valid.reshape(()).to(dev) for p in out]
        )
        control_t, order = _control_vector(scalars)
        control = _in_order(control_t.cpu().tolist(), order)
        self.fragment_reads += 1
        self._count_control_read(control_t)
        return control

    def _execute_fragment(self, root, scans, tables, balance):
        scan_ids = {id(s): i for i, s in enumerate(scans)}
        flags: List[torch.Tensor] = []
        errors: List[Tuple[str, torch.Tensor]] = []
        out, dist = self._exec_dist(
            root, [t[0] for t in tables], scan_ids, flags, errors, balance
        )
        # fragment boundary: the gather reads each shard's prefix, so
        # lazy masks stop here
        return [compact_page(p) for p in out], dist, flags, errors

    def _gather(self, out: List[Page], counts, replicated: bool) -> Page:
        page = gather_stacked(out, counts, replicated, self.device)
        if not replicated:
            self.collective_bytes["gather"] += sum(counts) * page_row_bytes(page)
        return page

    # -------------------------------------------------- sharded staging

    def _load_table_sharded(self, scan: N.TableScanNode):
        """A table row-sharded over the devices: contiguous chunks of
        its merged payload, every shard staged at one capacity bucket.
        Cached under the scan's constraint (a pruned table must never
        serve a differently constrained scan)."""
        from presto_tpu_torch.connectors.spi import payload_len

        key = (scan.handle, scan.columns, scan.constraint, self.n)
        table = self._shard_cache.get(key)
        if table is None:
            merged = self._load_merged_payload(scan)
            total = payload_len(next(iter(merged.values())))
            chunk = max(_ceil_div(total, self.n), 1)
            bounds = [
                (min(i * chunk, total), min((i + 1) * chunk, total))
                for i in range(self.n)
            ]
            payloads = [
                {c: _slice_col(v, lo, hi) for c, v in merged.items()}
                for lo, hi in bounds
            ]
            pages = stage_sharded(
                payloads, dict(scan.schema), bucket_capacity(chunk),
                self.devices,
            )
            table = (pages, [hi - lo for lo, hi in bounds])
            if self.catalogs.get(scan.handle.catalog).cacheable():
                self._shard_cache[key] = table
        qs = self._active_qs
        if qs is not None:
            qs.input_rows += sum(table[1])
            qs.input_bytes += sum(
                int(b.data.nbytes) for p in table[0] for b in p.blocks
            )
        return table

    # -------------------------------------- distribution-aware execution

    def _exec_dist(
        self, node, pages, scan_ids, flags, errors, balance
    ) -> Tuple[List[Page], str]:
        """Run ``node`` on every shard; returns (one page per shard, its
        distribution)."""
        def rec(c):
            return self._exec_dist(c, pages, scan_ids, flags, errors, balance)

        if isinstance(node, N.TableScanNode):
            return pages[scan_ids[id(node)]], "part"

        if isinstance(node, N.FilterNode):
            src, d = rec(node.source)
            schema = node.source.output_schema()
            projs = [(n_, E.ColumnRef(n_, t)) for n_, t in schema.items()]
            return [filter_project(p, node.predicate, projs) for p in src], d

        if isinstance(node, N.ProjectNode):
            src, d = rec(node.source)
            return [project(p, node.projections) for p in src], d

        if isinstance(node, N.AggregationNode):
            return self._exec_agg(node, rec, flags, errors, balance)

        if isinstance(node, N.DistinctNode):
            return self._exec_distinct(node, rec, flags, balance)

        if isinstance(node, N.JoinNode):
            return self._exec_join(node, rec, flags, balance)

        if isinstance(node, N.CrossJoinNode):
            left, dl = rec(node.left)
            right, dr = rec(node.right)
            if dr == "part":
                right = self._replicate(right)
            if node.out_capacity is not None:
                out = []
                for lp, rp in zip(left, right):
                    pg, ovf = cross_join(lp, rp, node.out_capacity)
                    flags.append(ovf)
                    out.append(pg)
                return out, dl
            for rp in right:
                errors.append((
                    "cross join build produced more than one row",
                    rp.num_valid > 1,
                ))
            return [
                cross_join_single_row(lp, rp) for lp, rp in zip(left, right)
            ], dl

        if isinstance(node, N.UnnestNode):
            src, d = rec(node.source)
            if node.array_column is None:
                return [
                    unnest(p, node.elements, node.out_name, node.out_type,
                           node.ordinality_name)
                    for p in src
                ], d
            out = []
            for p in src:
                pg, ovf = unnest_column(
                    p, node.array_column, node.out_name, node.out_type,
                    node.ordinality_name, node.out_capacity,
                )
                flags.append(ovf)
                out.append(pg)
            return out, d

        raise ExecutionError(
            f"cannot execute {type(node).__name__} in a sharded fragment"
        )

    def _replicate(self, pages: List[Page]) -> List[Page]:
        out = replicate(pages)
        self.collective_bytes["all_gather"] += (
            self.n * sum(p.capacity for p in pages) * page_row_bytes(pages[0])
        )
        return out

    def _partition(self, pages, key_cols, bucket_cap: int, flags):
        """Hash-repartition every shard's rows on ``key_cols`` (the
        all_to_all), appending each source's overflow flag."""
        dests = [umod(partition_hash(p, key_cols), self.n) for p in pages]
        out, ovf = partition_exchange(pages, dests, bucket_cap)
        flags.extend(ovf)
        self.collective_bytes["all_to_all"] += (
            self.n * self.n * bucket_cap * page_row_bytes(pages[0])
        )
        return out

    def _exec_agg(self, node, rec, flags, errors, balance):
        src, d = rec(node.source)

        def agg(pages, keys, aggs):
            out = []
            for p in pages:
                pg, ovf = hash_aggregate(
                    p, keys, aggs, node.max_groups, errors_out=errors
                )
                flags.append(ovf)
                out.append(pg)
            return out

        if d == "repl":
            return agg(src, node.group_keys, node.aggs), "repl"
        try:
            partial_aggs, fkeys, faggs, post = split_aggregation(
                node.group_keys, node.aggs
            )
        except NotImplementedError:
            # order-sensitive aggregates (array_agg, approx_percentile,
            # min_by, max_by) have no mergeable partial state: replicate
            # the sharded input and aggregate it whole (the HTTP
            # scheduler's fallback too)
            return agg(self._replicate(src), node.group_keys, node.aggs), "repl"
        if not node.group_keys:
            parts = []
            for p in src:
                pg, _ = hash_aggregate(p, (), partial_aggs, 1, errors_out=errors)
                parts.append(pg)
            out = []
            for p in self._replicate(parts):
                pg, _ = hash_aggregate(p, (), faggs, 1, errors_out=errors)
                out.append(pg if not post else project(pg, post))
            return out, "repl"
        parts = agg(src, node.group_keys, partial_aggs)
        routed, dist = self._route_partials(
            parts, [n_ for n_, _ in node.group_keys], node.max_groups,
            balance, flags,
        )
        out = agg(routed, fkeys, faggs)
        if post:
            out = [project(p, post) for p in out]
        return out, dist

    def _exec_distinct(self, node, rec, flags, balance):
        src, d = rec(node.source)

        def dist_op(pages):
            out = []
            for p in pages:
                pg, ovf = distinct_op(p, node.max_groups)
                flags.append(ovf)
                out.append(pg)
            return out

        if d == "repl":
            return dist_op(src), "repl"
        parts = dist_op(src)
        routed, dist = self._route_partials(
            parts, list(parts[0].names), node.max_groups, balance, flags
        )
        return dist_op(routed), dist

    def _route_partials(self, parts, key_cols, max_groups, balance, flags):
        """Route partial group or distinct states to their merge shard:
        replicate (all_gather) up to ``repl_threshold`` groups, else
        hash-repartition (all_to_all), each shard merging its key
        range."""
        if max_groups <= self.repl_threshold:
            return self._replicate(parts), "repl"
        bucket_cap = bucket_capacity(_ceil_div(balance * max_groups, self.n))
        return self._partition(parts, key_cols, bucket_cap, flags), "part"

    def _exec_join(self, node, rec, flags, balance):
        probe, dp = rec(node.left)
        build, db = rec(node.right)

        def local_join(ps, bs):
            out = []
            for p, b in zip(ps, bs):
                pg, ovf = hash_join(
                    p, b, node.left_keys, node.right_keys,
                    join_type=node.join_type,
                    build_payload=node.payload,
                    build_unique=node.build_unique,
                    out_capacity=node.out_capacity,
                    payload_rename=dict(node.payload_rename),
                )
                flags.append(ovf)
                if node.residual is not None:
                    projs = [
                        (n_, E.ColumnRef(n_, t))
                        for n_, t in pg.schema().items()
                    ]
                    pg = filter_project(pg, node.residual, projs)
                out.append(pg)
            return out

        if db == "repl":
            return local_join(probe, build), dp
        # join_distribution_type (reference: AddExchanges' cost-based
        # choice, overridable per session): AUTOMATIC = the capacity
        # threshold, BROADCAST = always replicate the build side,
        # PARTITIONED = always hash-repartition both sides
        jdt = str(self.session.get("join_distribution_type")).upper()
        broadcast = (
            build[0].capacity <= self.broadcast_threshold
            if jdt == "AUTOMATIC"
            else jdt == "BROADCAST"
        )
        if dp == "repl" or broadcast:
            return local_join(probe, self._replicate(build)), dp
        cap_p = bucket_capacity(_ceil_div(balance * probe[0].capacity, self.n))
        cap_b = bucket_capacity(_ceil_div(balance * build[0].capacity, self.n))
        p2 = self._partition(probe, list(node.left_keys), cap_p, flags)
        b2 = self._partition(build, list(node.right_keys), cap_b, flags)
        return local_join(p2, b2), "part"


# ------------------------------------------------------------------ helpers


def _slice_col(v, lo: int, hi: int):
    """Rows [lo, hi) of one staging payload column."""
    if isinstance(v, MaskedColumn):
        return dataclasses.replace(v, data=v.data[lo:hi], valid=v.valid[lo:hi])
    if hasattr(v, "ids"):  # DictColumn: the shared closed-form dictionary
        return type(v)(ids=v.ids[lo:hi], values=v.values)
    return v[lo:hi]


#: the dryrun's query: TPC-H Q3 at tiny
_Q3 = """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
  o_orderdate, o_shippriority
from tpch.tiny.customer, tpch.tiny.orders, tpch.tiny.lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
"""


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None):
    """Run TPC-H Q3 at tiny over ``n_devices`` shards (``devices``:
    the shard list, e.g. ``[torch.device('cuda', 0)] * 8`` for eight
    shards on one card; None: the first ``n_devices`` visible CUDA
    devices). The thresholds are low so that tiny data still takes the
    partitioned (all_to_all) paths rather than broadcasts. Returns the
    runner."""
    runner = DistributedQueryRunner(
        n_devices=n_devices,
        devices=devices,
        broadcast_threshold=1 << 11,
        repl_threshold=1 << 10,
    )
    if runner.n != n_devices:
        raise RuntimeError(f"{runner.n} shards, wanted {n_devices}")
    rows = runner.execute(_Q3).rows()
    if len(rows) != 10:
        raise RuntimeError(f"Q3 dryrun returned {len(rows)} rows")
    return runner

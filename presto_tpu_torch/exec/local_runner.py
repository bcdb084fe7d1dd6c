"""Local query runner: SQL in, rows out, on one device.

The PyTorch counterpart of ``presto_tpu/exec/local_runner.py``'s
``LocalQueryRunner``, for the plans this slice of the port runs: a
SELECT is parsed, planned and optimized exactly as the reference does
(``prune_columns`` + ``push_scan_constraints``), scalar subqueries run
first and bind as literals, the root Output/Sort/Limit is peeled to the
host (``exec/host_ops.py``), and the rest runs as eager torch operators
over whole-table pages staged on the runner's device. There is no jit
and no plan cache: PyTorch runs eagerly.

Static shapes are kept: an aggregation that finds more groups than its
planned ``max_groups``, or a join whose output exceeds its
``out_capacity``, raises an overflow flag, and the plan re-runs with
every capacity scaled 4x (``_scale_capacities``).

A plan heavier than ``max_fragment_weight`` runs stage-at-a-time, as
the reference's does: heavy subtrees run as fragments of their own
(build side first), their results stay on the device re-bucketed to
their live rows, and an executed join build side pre-filters its probe
side (``exec/dynfilter.py``).

A plan that scans a table larger than ``max_device_rows`` streams
(``exec/streaming.py``): split batches staged at a fixed capacity
(``stage_split``) run through the fragment below the cut, partial states
or a join side's rows spill to host-RAM buckets, and each bucket runs
alone on the device.

Not ported yet (they raise): statements other than SELECT, unnest, and
the device-resident split cache (``stream_split_cache``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple, Union

import torch

from presto_tpu_torch import expr as E
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors import create_connector
from presto_tpu_torch.connectors.spi import ConnectorSplit
from presto_tpu_torch.exec import dynfilter, streaming
from presto_tpu_torch.exec.host_ops import apply_host_ops, peel_host_ops
from presto_tpu_torch.exec.staging import (
    CatalogManager,
    bucket_capacity,
    merge_column_chunks,
    page_nbytes,
    stage_page,
)
from presto_tpu_torch.ops import (
    distinct,
    filter_project,
    hash_aggregate,
    hash_join,
    limit,
    order_by,
    project,
    union_all,
    window,
)
from presto_tpu_torch.ops.join import cross_join
from presto_tpu_torch.page import (
    Block,
    Page,
    compact_page,
    pad_capacity,
    resolve_device,
    to_host,
)
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.plan.optimizer import (
    prune_columns,
    push_scan_constraints,
)
from presto_tpu_torch.plan.planner import Plan, plan_statement
from presto_tpu_torch.session import Session
from presto_tpu_torch.sql import ast, parse_statement


class ExecutionError(RuntimeError):
    pass


class QueryResult:
    def __init__(self, columns: Tuple[str, ...], page: Page):
        self.columns = columns
        self.page = page

    def rows(self) -> List[tuple]:
        return [
            tuple(r[c] for c in self.columns) for r in self.page.to_pylist()
        ]

    def row_dicts(self) -> List[dict]:
        return self.page.to_pylist()


class LocalQueryRunner:
    """Parse -> plan -> optimize -> eager execution on one device."""

    # each retry scales capacity buckets 4x, so 6 tries = up to 1024x
    # over the initial estimate
    MAX_RETRIES = 6

    def __init__(
        self,
        catalogs: Optional[CatalogManager] = None,
        session: Optional[Session] = None,
        device: Union[None, str, torch.device] = None,
    ):
        self.device = resolve_device(device)
        if catalogs is None:
            catalogs = CatalogManager()
            catalogs.register("tpch", create_connector("tpch"))
        self.catalogs = catalogs
        self.session = session or Session()
        #: staged whole-table pages, keyed by scan identity
        self._tables: Dict[tuple, Page] = {}
        #: stage-at-a-time counters since the runner was made: fragments
        #: run on their own, and dynamic filters applied to a probe side
        self.fragments_run = 0
        self.dynamic_filters_applied = 0
        #: plan re-runs at 4x capacities after an overflow, since the
        #: runner was made
        self.overflow_retries = 0
        #: what streamed execution did (batches, buckets, spill, host
        #: seconds); a caller may replace it to count one query
        self.stream_stats = streaming.StreamStats()

    # ------------------------------------------------------------- public

    def execute(self, sql: str) -> QueryResult:
        stmt = parse_statement(sql)
        if not isinstance(stmt, ast.Select):
            raise ExecutionError(
                f"{type(stmt).__name__} statements: later slice of the port"
            )
        return self.execute_plan(
            plan_statement(stmt, self.catalogs, self.session)
        )

    def execute_plan(self, plan: Plan) -> QueryResult:
        root = push_scan_constraints(prune_columns(self._bind_params(plan)))
        host_ops: List[N.PlanNode] = []
        if self.session.get("host_root_stage"):
            root, host_ops = peel_host_ops(root)
        page = self._run(root)
        if host_ops:
            page = apply_host_ops(page, host_ops)
        return QueryResult(plan.output_names, page)

    # ------------------------------------------------- params (subqueries)

    def _bind_params(self, plan: Plan) -> N.PlanNode:
        """Run each scalar subquery (its own subqueries first) and
        substitute its one value into the plan as a Literal."""
        bindings: Dict[int, E.Literal] = {}
        for pid, sub in plan.params:
            sub_root = push_scan_constraints(
                prune_columns(self._bind_params(sub))
            )
            page = self._run(sub_root)
            bindings[pid] = _scalar_literal(page, sub.output_names[0])
        if not bindings:
            return plan.root
        return _substitute_params(plan.root, bindings)

    # ---------------------------------------------------------- execution

    def _run(self, root: N.PlanNode) -> Page:
        if streaming.needs_streaming(root, self.catalogs, self.session):
            # larger-than-device input: split-streamed partial
            # aggregation with hash-bucketed host spill
            return streaming.run_streamed(self, root)
        budget = int(self.session.get("max_fragment_weight"))
        if budget > 0 and _plan_weight(root) > budget:
            return self._run_fragmented(root, budget)
        scans = [n for n in N.walk(root) if isinstance(n, N.TableScanNode)]
        pages = [self._load_table(s) for s in scans]
        return self._run_with_pages(root, scans, pages)

    # ------------------------------------------- stage-at-a-time execution

    def _run_fragmented(self, root: N.PlanNode, budget: int) -> Page:
        """Execute a heavy plan stage-at-a-time: heavy subtrees run as
        fragments of their own, their outputs stay on the device, and
        the remaining tree consumes them as leaves."""
        pages_map: Dict[int, Page] = {}
        reduced = self._reduce_fragment(root, budget, pages_map)
        leaves, pages = self.leaf_pages(reduced, pages_map)
        return self._run_with_pages(reduced, leaves, pages)

    def leaf_pages(
        self, root: N.PlanNode, pages_map: Dict[int, Page]
    ) -> Tuple[List[N.PlanNode], List[Page]]:
        """A fragment's leaves (scans + remote sources) and their input
        pages: scans load (cached) tables, remote sources resolve
        through ``pages_map`` (id(node) -> already-produced page)."""
        leaves = [
            n
            for n in N.walk(root)
            if isinstance(n, (N.TableScanNode, N.RemoteSourceNode))
        ]
        pages = [
            pages_map[id(n)]
            if isinstance(n, N.RemoteSourceNode)
            else self._load_table(n)
            for n in leaves
        ]
        return leaves, pages

    def _reduce_fragment(
        self, node: N.PlanNode, budget: int, pages_map: Dict[int, Page]
    ) -> N.PlanNode:
        """Bottom-up: shrink ``node``'s subtree to at most ``budget``
        weight by executing its heaviest child subtrees as fragments of
        their own (device-resident results become RemoteSourceNode
        leaves). A node whose own weight exceeds the budget with only
        leaf children runs as one fragment anyway."""
        node = N.map_children(
            node, lambda c: self._reduce_fragment(c, budget, pages_map)
        )
        while _plan_weight(node) > budget:
            cands = [
                c
                for c in node.children()
                if not isinstance(
                    c, (N.TableScanNode, N.RemoteSourceNode, N.ValuesNode)
                )
            ]
            if not cands:
                break
            # BUILD side first when reducing a join (build before
            # probe): its executed page then feeds a dynamic filter
            # into the probe side
            if isinstance(node, N.JoinNode) and node.right in cands:
                child = node.right
            else:
                child = max(cands, key=_plan_weight)
            leaf = self._execute_to_leaf(child, pages_map)
            node = N.map_children(node, lambda c: leaf if c is child else c)
            node = self._apply_dynamic_filter(node, leaf, pages_map)
        return node

    def _apply_dynamic_filter(
        self, node: N.PlanNode, leaf: N.RemoteSourceNode, pages_map
    ) -> N.PlanNode:
        """When a join's BUILD side has just run as a fragment, fetch its
        join-key summary (one host read) and pre-filter the probe side,
        which has not run yet: probe rows outside the build's key domain
        cannot match an inner or semi join."""
        if not self.session.get("enable_dynamic_filtering"):
            return node
        if not (
            isinstance(node, N.JoinNode)
            and node.right is leaf
            and node.join_type in ("inner", "semi")
            and not isinstance(node.left, (N.RemoteSourceNode, N.ValuesNode))
        ):
            return node
        conjuncts, n_filters = dynfilter.device_conjuncts(
            pages_map[id(leaf)],
            list(zip(node.left_keys, node.right_keys)),
            node.left.output_schema(),
            ndv_limit=int(self.session.get("dynamic_filtering_ndv_limit")),
        )
        if not conjuncts:
            return node
        self.dynamic_filters_applied += n_filters
        pred = conjuncts[0] if len(conjuncts) == 1 else E.And(tuple(conjuncts))
        return dataclasses.replace(
            node,
            left=N.FilterNode(source=node.left, predicate=pred),
        )

    def _execute_to_leaf(
        self, subtree: N.PlanNode, pages_map: Dict[int, Page]
    ) -> N.RemoteSourceNode:
        """Run one fragment; its result stays on the device, re-bucketed
        to its live rows, and is read through a RemoteSourceNode."""
        leaves, pages = self.leaf_pages(subtree, pages_map)
        remote = N.RemoteSourceNode(fragment_root=subtree)
        pages_map[id(remote)] = self._run_with_pages(
            subtree, leaves, pages, fetch_result=False
        )
        self.fragments_run += 1
        return remote

    def _run_with_pages(
        self,
        root: N.PlanNode,
        scans: List[N.PlanNode],
        pages: List[Page],
        fetch_result: bool = True,
    ) -> Page:
        """Run the plan over its leaf pages, re-running at 4x capacities
        while an operator reports overflow. One host read per attempt
        fetches the flags, the error bits and the live count.

        Returns the result page on the host; with ``fetch_result=False``
        (a stage-at-a-time fragment) the page stays on the device,
        compacted and re-bucketed to its live rows."""
        scan_ids = {id(s): i for i, s in enumerate(scans)}
        tries = 0
        while True:
            ctx = _ExecContext(pages, scan_ids, self.device)
            out = compact_page(_execute_node(root, ctx))
            control = torch.stack(
                [f.reshape(()).to(torch.int64) for f in ctx.flags]
                + [e.reshape(()).to(torch.int64) for _, e in ctx.errors]
                + [out.num_valid.to(torch.int64)]
            ).cpu().tolist()
            nf = len(ctx.flags)
            for (msg, _), bit in zip(ctx.errors, control[nf:-1]):
                if bit:
                    raise ExecutionError(msg)
            if not any(control[:nf]):
                n = control[-1]
                if not fetch_result:
                    return pad_capacity(out, bucket_capacity(n))
                return materialize_page(out, n)
            tries += 1
            self.overflow_retries += 1
            if tries >= self.MAX_RETRIES:
                raise ExecutionError(
                    "capacity overflow persisted after retries "
                    "(join fan-out or group count beyond buckets)"
                )
            # leaves carry no capacity, so they keep their identity and
            # scan_ids stays valid
            root = _scale_capacities(root, 4)

    def _load_table(self, scan: N.TableScanNode) -> Page:
        """Stage a whole table onto the device once per scan identity
        (the constraint is part of it: a pruned page must never serve a
        differently constrained scan)."""
        key = (scan.handle, scan.columns, scan.constraint)
        page = self._tables.get(key)
        if page is None:
            merged = self._load_merged_payload(scan)
            page = stage_page(merged, dict(scan.schema), device=self.device)
            self._tables[key] = page
        return page

    def _load_split(
        self, scan: N.TableScanNode, lo: int, hi: int, capacity: int
    ) -> Page:
        """Stage ONE split batch (see :meth:`stage_split`)."""
        return self.stage_split(scan, lo, hi, capacity)

    def stage_split(
        self, scan: N.TableScanNode, lo: int, hi: int, capacity: int
    ) -> Page:
        """Stage ONE split batch [lo, hi) of a scan at a fixed capacity
        on the runner's device. The pushed constraint is not applied:
        a split reads its raw row range, and the plan's filter runs over
        it. The reference's device-resident split cache
        (``stream_split_cache``) is not ported yet and raises."""
        if self.session.get("stream_split_cache"):
            raise NotImplementedError(
                "stream_split_cache: the device-resident SplitCache is "
                "a later slice of the port"
            )
        stats = self.stream_stats
        t0 = time.perf_counter()
        payload = self.catalogs.get(scan.handle.catalog).create_page_source(
            ConnectorSplit(scan.handle, lo, hi), list(scan.columns)
        )
        t1 = time.perf_counter()
        page = stage_page(
            payload, dict(scan.schema), capacity=capacity, device=self.device
        )
        # the prefetch thread adds here too; a lost update of a float
        # total only blurs a timing
        stats.generate_s += t1 - t0
        stats.stage_s += time.perf_counter() - t1
        stats.staged_bytes += page_nbytes(page)
        return page

    def _load_merged_payload(self, scan: N.TableScanNode) -> Dict:
        """Fetch all splits of a scan and merge their column payloads."""
        conn = self.catalogs.get(scan.handle.catalog)
        src = conn.get_splits(
            scan.handle,
            target_split_rows=1 << 22,
            constraint=scan.constraint,
        )
        datas = []
        while not src.exhausted:
            for split in src.next_batch(64):
                datas.append(
                    conn.create_page_source(split, list(scan.columns))
                )
        return _merge_split_payloads(datas, list(scan.columns))


def materialize_page(page: Page, n: int) -> Page:
    """Copy the live prefix of a prefix-form page to the host in ONE
    transfer: slice every block to ``n`` rows on the device, copy them
    together (``page.to_host``), and re-pad on the host to the
    power-of-two bucket. The result page holds CPU tensors."""
    cap = bucket_capacity(n)
    fetched = iter(to_host(page.prefix_leaves(n)))
    blocks = []
    for blk in page.blocks:
        data = torch.zeros(
            (cap,) + tuple(blk.data.shape[1:]), dtype=blk.data.dtype
        )
        data[:n] = next(fetched)
        valid = None
        if blk.valid is not None:
            valid = torch.zeros((cap,), dtype=torch.bool)
            valid[:n] = next(fetched)
        blocks.append(dataclasses.replace(blk, data=data, valid=valid))
    return Page(
        blocks=tuple(blocks),
        num_valid=torch.tensor(n, dtype=torch.int32),
        names=page.names,
    )


#: plan weight per node in the reference (its compile-size proxy and the
#: cut decision for stage-at-a-time execution); kept so the port
#: fragments exactly the plans the reference fragments
_HEAVY_NODES = (
    N.JoinNode,
    N.AggregationNode,
    N.DistinctNode,
    N.SortNode,
    N.WindowNode,
    N.UnnestNode,
)


def _plan_weight(root: N.PlanNode) -> int:
    """Does not descend into executed fragments (RemoteSourceNode has no
    children)."""
    return sum(
        6 if isinstance(n, _HEAVY_NODES) else 1 for n in N.walk(root)
    )


class _ExecContext:
    """One run of a plan over its leaf pages, and what it collects: 0-d
    overflow flags (capacity retries) and (message, 0-d bool) hard
    errors."""

    def __init__(self, pages, scan_ids, device: torch.device):
        self.pages = pages
        self.scan_ids = scan_ids
        self.device = device
        self.flags: List[torch.Tensor] = []
        self.errors: List[Tuple[str, torch.Tensor]] = []


def _execute_node(node: N.PlanNode, ctx: _ExecContext) -> Page:
    """Execute one plan node eagerly."""

    def run(n):
        return _execute_node(n, ctx)

    if isinstance(node, (N.TableScanNode, N.RemoteSourceNode)):
        return ctx.pages[ctx.scan_ids[id(node)]]
    if isinstance(node, N.ValuesNode):
        return Page(
            blocks=(
                Block(
                    data=torch.zeros((8,), dtype=torch.int64, device=ctx.device),
                    valid=None,
                    dtype=T.BIGINT,
                ),
            ),
            num_valid=torch.ones((), dtype=torch.int32, device=ctx.device),
            names=("$dummy",),
        )
    if isinstance(node, N.FilterNode):
        src = run(node.source)
        schema = node.source.output_schema()
        projs = [(n, E.ColumnRef(n, t)) for n, t in schema.items()]
        return filter_project(src, node.predicate, projs)
    if isinstance(node, N.ProjectNode):
        return project(run(node.source), node.projections)
    if isinstance(node, N.AggregationNode):
        out, overflow = hash_aggregate(
            run(node.source),
            node.group_keys,
            node.aggs,
            node.max_groups,
            errors_out=ctx.errors,
        )
        ctx.flags.append(overflow)
        return out
    if isinstance(node, N.DistinctNode):
        out, overflow = distinct(run(node.source), node.max_groups)
        ctx.flags.append(overflow)
        return out
    if isinstance(node, N.JoinNode):
        probe = run(node.left)
        build = run(node.right)
        out, overflow = hash_join(
            probe,
            build,
            node.left_keys,
            node.right_keys,
            join_type=node.join_type,
            build_payload=node.payload,
            build_unique=node.build_unique,
            out_capacity=node.out_capacity,
            payload_rename=dict(node.payload_rename),
        )
        ctx.flags.append(overflow)
        if node.residual is not None:
            projs = [(n, E.ColumnRef(n, t)) for n, t in out.schema().items()]
            out = filter_project(out, node.residual, projs)
        return out
    if isinstance(node, N.CrossJoinNode):
        left = run(node.left)
        right = run(node.right)
        if node.out_capacity is not None:
            out, overflow = cross_join(left, right, node.out_capacity)
            ctx.flags.append(overflow)
            return out
        # single-row broadcast (the scalar-aggregate shape); more than
        # one row is a hard error, not an overflow a retry could fix
        ctx.errors.append(
            ("cross join build produced more than one row",
             right.num_valid > 1)
        )
        return cross_join_single_row(left, right)
    if isinstance(node, N.SortNode):
        return order_by(run(node.source), node.keys, limit=node.limit)
    if isinstance(node, N.LimitNode):
        return limit(run(node.source), node.count)
    if isinstance(node, N.WindowNode):
        return window(
            run(node.source), node.partition_by, node.order_by, node.calls
        )
    if isinstance(node, N.UnionAllNode):
        return union_all([run(s) for s in node.sources])
    if isinstance(node, N.OutputNode):
        src = run(node.source)
        return Page(
            blocks=tuple(src.block(col) for _, col in node.columns),
            num_valid=src.num_valid,
            names=tuple(o for o, _ in node.columns),
            live=src.live,
        )
    raise ExecutionError(
        f"cannot execute {type(node).__name__}: later slice of the port"
    )


def cross_join_single_row(left: Page, right: Page) -> Page:
    """Cross product against a single-row right side (the scalar-aggregate
    broadcast). The caller flags ``right.num_valid > 1``."""
    right = compact_page(right)  # row 0 must really be the single row
    blocks = list(left.blocks)
    names = list(left.names)
    for bname, blk in zip(right.names, right.blocks):
        data = torch.broadcast_to(blk.data[0], (left.capacity,))
        valid = None
        if blk.valid is not None:
            valid = torch.broadcast_to(blk.valid[0], (left.capacity,))
        blocks.append(dataclasses.replace(blk, data=data, valid=valid))
        names.append(bname)
    has_row = right.num_valid > 0
    return Page(
        blocks=tuple(blocks),
        num_valid=torch.where(has_row, left.num_valid, 0).to(torch.int32),
        names=tuple(names),
        live=None if left.live is None else left.live & has_row,
    )


# ----------------------------------------------------------- param binding


def _substitute_params(v, bindings):
    """Replace every Param in a plan (its nodes, expressions, and the
    tuples and dataclasses such as AggCall and SortKey that hold them)
    with its bound Literal. Parts without a Param keep their identity:
    executed fragments are looked up by ``id``."""
    if isinstance(v, E.Param):
        lit = bindings.get(v.param_id)
        if lit is None:
            raise ExecutionError(f"unbound param {v.param_id}")
        return lit
    if isinstance(v, tuple):
        new = tuple(_substitute_params(x, bindings) for x in v)
        return v if all(a is b for a, b in zip(new, v)) else new
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        changes = {}
        for f in dataclasses.fields(v):
            old = getattr(v, f.name)
            new = _substitute_params(old, bindings)
            if new is not old:
                changes[f.name] = new
        return dataclasses.replace(v, **changes) if changes else v
    return v


def _scalar_literal(page: Page, col: str) -> E.Literal:
    """A scalar subquery's result (a host page of 0 or 1 rows) as a
    Literal: no row is NULL, two rows are an error."""
    blk = page.block(col)
    n = int(page.num_valid)
    if n == 0:
        return E.Literal(None, blk.dtype)
    if n > 1:
        raise ExecutionError("scalar subquery returned more than one row")
    data, valid = blk.to_numpy(1)
    if not valid[0]:
        return E.Literal(None, blk.dtype)
    v = data[0]
    if blk.dtype.is_string:
        return E.Literal(str(blk.dictionary.values[int(v)]), blk.dtype)
    if blk.dtype.is_decimal or blk.dtype.is_integer or blk.dtype.name in (
        "date",
        "timestamp",
    ):
        return E.Literal(int(v), blk.dtype)
    if blk.dtype.name == "boolean":
        return E.Literal(bool(v), blk.dtype)
    return E.Literal(float(v), blk.dtype)


def _scale_capacities(node: N.PlanNode, factor: int) -> N.PlanNode:
    if isinstance(node, N.RemoteSourceNode):
        return node  # an executed fragment: its page is fixed
    node = N.map_children(node, lambda c: _scale_capacities(c, factor))
    changes = {}
    if isinstance(node, (N.AggregationNode, N.DistinctNode)):
        changes["max_groups"] = node.max_groups * factor
    if (
        isinstance(node, (N.JoinNode, N.CrossJoinNode, N.UnnestNode))
        and node.out_capacity is not None
    ):
        changes["out_capacity"] = node.out_capacity * factor
    return dataclasses.replace(node, **changes) if changes else node


def _merge_split_payloads(datas: List[Dict], columns: List[str]) -> Dict:
    """Merge per-split payloads column by column
    (``staging.merge_column_chunks``): dictionaries that differ across
    splits (file connectors) merge into their sorted union with the ids
    remapped; splits sharing one dictionary object (the tpch generator)
    keep it; masked chunks merge with their validity."""
    if len(datas) == 1:
        return datas[0]
    return {c: merge_column_chunks([d[c] for d in datas]) for c in columns}

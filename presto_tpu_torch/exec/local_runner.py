"""Local query runner: SQL in, rows out, on one device.

The PyTorch counterpart of ``presto_tpu/exec/local_runner.py``'s
``LocalQueryRunner``, for the plans this slice of the port runs: a
SELECT is parsed, planned and optimized exactly as the reference does
(``prune_columns`` + ``push_scan_constraints``), the root
Output/Sort/Limit is peeled to the host (``exec/host_ops.py``), and the
rest runs as eager torch operators over whole-table pages staged on the
runner's device. There is no jit and no plan cache: PyTorch runs
eagerly.

Static shapes are kept: an aggregation that finds more groups than its
planned ``max_groups`` raises an overflow flag, and the plan re-runs
with every capacity scaled 4x (``_scale_capacities``).

Not ported yet (they raise): statements other than SELECT, scalar
subqueries, joins, sorts and windows on the device, streaming of tables
larger than ``max_device_rows``, and stage-at-a-time execution.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from presto_tpu_torch import expr as E
from presto_tpu_torch.connectors import create_connector
from presto_tpu_torch.connectors.tpch import DictColumn
from presto_tpu_torch.exec.host_ops import apply_host_ops, peel_host_ops
from presto_tpu_torch.exec.staging import (
    CatalogManager,
    bucket_capacity,
    stage_page,
)
from presto_tpu_torch.ops import filter_project, hash_aggregate, project
from presto_tpu_torch.page import Page, compact_page, to_host
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


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` means the CUDA device; a CUDA device without CUDA raises
    (the port never drops to the CPU on its own)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU"
        )
    return dev


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
        if plan.params:
            raise ExecutionError("scalar subqueries: later slice of the port")
        root = push_scan_constraints(prune_columns(plan.root))
        host_ops: List[N.PlanNode] = []
        if self.session.get("host_root_stage"):
            root, host_ops = peel_host_ops(root)
        page = self._run(root)
        if host_ops:
            page = apply_host_ops(page, host_ops)
        return QueryResult(plan.output_names, page)

    # ---------------------------------------------------------- execution

    def _run(self, root: N.PlanNode) -> Page:
        scans = [n for n in N.walk(root) if isinstance(n, N.TableScanNode)]
        max_rows = int(self.session.get("max_device_rows"))
        for s in scans:
            stats = self.catalogs.get(s.handle.catalog).metadata()
            rows = int(stats.get_table_stats(s.handle).row_count or 0)
            if rows > max_rows:
                raise ExecutionError(
                    f"{s.handle.table} has {rows} rows > max_device_rows "
                    f"{max_rows}: streamed execution is a later slice"
                )
        budget = int(self.session.get("max_fragment_weight"))
        if budget > 0 and _plan_weight(root) > budget:
            raise ExecutionError(
                "plan exceeds max_fragment_weight: stage-at-a-time "
                "execution is a later slice"
            )
        pages = [self._load_table(s) for s in scans]
        return self._run_with_pages(root, scans, pages)

    def _run_with_pages(
        self, root: N.PlanNode, scans: List[N.PlanNode], pages: List[Page]
    ) -> Page:
        """Run the plan over staged pages, re-running at 4x capacities
        while an operator reports overflow. One host read per attempt
        fetches the flags, the error bits and the live count."""
        scan_ids = {id(s): i for i, s in enumerate(scans)}
        tries = 0
        while True:
            flags: List[torch.Tensor] = []
            errors: List[Tuple[str, torch.Tensor]] = []
            out = compact_page(
                _execute_node(root, pages, scan_ids, flags, errors)
            )
            control = torch.stack(
                [f.reshape(()).to(torch.int64) for f in flags]
                + [e.reshape(()).to(torch.int64) for _, e in errors]
                + [out.num_valid.to(torch.int64)]
            ).cpu().tolist()
            flag_vals = control[: len(flags)]
            err_vals = control[len(flags): len(flags) + len(errors)]
            for (msg, _), bit in zip(errors, err_vals):
                if bit:
                    raise ExecutionError(msg)
            if not any(flag_vals):
                return materialize_page(out, control[-1])
            tries += 1
            if tries >= self.MAX_RETRIES:
                raise ExecutionError(
                    "capacity overflow persisted after retries "
                    "(group count beyond buckets)"
                )
            # scans carry no capacity, so they keep their identity and
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


#: compile-cost weight per plan node in the reference (the cut decision
#: for stage-at-a-time execution); kept so the port refuses the same
#: plans the reference would fragment
_HEAVY_NODES = (
    N.JoinNode,
    N.AggregationNode,
    N.DistinctNode,
    N.SortNode,
    N.WindowNode,
    N.UnnestNode,
)


def _plan_weight(root: N.PlanNode) -> int:
    return sum(
        6 if isinstance(n, _HEAVY_NODES) else 1 for n in N.walk(root)
    )


def _execute_node(node, pages, scan_ids, flags, errors) -> Page:
    """Execute one plan node eagerly. ``flags`` collects 0-d overflow
    tensors (capacity retries); ``errors`` collects (message, 0-d bool)
    hard errors."""

    def run(n):
        return _execute_node(n, pages, scan_ids, flags, errors)

    if isinstance(node, N.TableScanNode):
        return pages[scan_ids[id(node)]]
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
            errors_out=errors,
        )
        flags.append(overflow)
        return out
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


def _scale_capacities(node: N.PlanNode, factor: int) -> N.PlanNode:
    if isinstance(node, N.RemoteSourceNode):
        return node
    changes = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, N.PlanNode):
            changes[f.name] = _scale_capacities(v, factor)
        elif isinstance(v, tuple) and v and isinstance(v[0], N.PlanNode):
            changes[f.name] = tuple(
                _scale_capacities(x, factor) for x in v
            )
    if isinstance(node, (N.AggregationNode, N.DistinctNode)):
        changes["max_groups"] = node.max_groups * factor
    if (
        isinstance(node, (N.JoinNode, N.CrossJoinNode, N.UnnestNode))
        and node.out_capacity is not None
    ):
        changes["out_capacity"] = node.out_capacity * factor
    return dataclasses.replace(node, **changes) if changes else node


def _merge_split_payloads(datas: List[Dict], columns: List[str]) -> Dict:
    """Concatenate per-split payloads. The tpch generator gives every
    split of a column the same dictionary; payloads that disagree
    (file connectors) need the reference's union-and-remap merge, a
    later slice."""
    if len(datas) == 1:
        return datas[0]
    merged = {}
    for c in columns:
        parts = [d[c] for d in datas]
        first = parts[0]
        if isinstance(first, DictColumn):
            if any(not np.array_equal(p.values, first.values) for p in parts):
                raise NotImplementedError(
                    f"merging differing dictionaries of {c}: later slice"
                )
            merged[c] = DictColumn(
                ids=np.concatenate([p.ids for p in parts]),
                values=first.values,
            )
        elif isinstance(first, np.ndarray):
            merged[c] = np.concatenate(parts)
        else:
            raise NotImplementedError(
                f"merging {type(first).__name__} payloads: later slice"
            )
    return merged

"""EXPLAIN / EXPLAIN ANALYZE rendering.

The PyTorch port's copy of ``presto_tpu/exec/explain.py`` (presto's EXPLAIN plan rendering and EXPLAIN ANALYZE
stats-in-plan output (SURVEY.md §5.1), extended with history-based
statistics (PAPER.md L2): every estimate prints its provenance
(``history`` — learned from a prior run of the same canonical shape,
``stats`` — connector row counts, ``heuristic``), and EXPLAIN ANALYZE
renders ``est -> actual (error ×N)`` per operator beside wall/device
time). The text is the reference's, string for string, for the same
plan.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.plan.optimizer import (
    estimate_rows_with_source,
    prune_columns,
)
from presto_tpu_torch.plan.planner import plan_statement
from presto_tpu_torch.sql import ast


def _describe(node: N.PlanNode) -> str:
    if isinstance(node, N.TableScanNode):
        return (
            f"TableScan[{node.handle.catalog}.{node.handle.schema}."
            f"{node.handle.table} columns={list(node.columns)}]"
        )
    if isinstance(node, N.FilterNode):
        tag = "DynamicFilter" if node.dynamic else "Filter"
        return f"{tag}[{node.predicate}]"
    if isinstance(node, N.ProjectNode):
        return f"Project[{[n for n, _ in node.projections]}]"
    if isinstance(node, N.AggregationNode):
        return (
            f"Aggregate[keys={[n for n, _ in node.group_keys]} "
            f"aggs={[f'{a.func}->{a.out_name}' for a in node.aggs]} "
            f"max_groups={node.max_groups}]"
        )
    if isinstance(node, N.JoinNode):
        return (
            f"{node.join_type.capitalize()}Join[{node.left_keys} = "
            f"{node.right_keys} unique={node.build_unique} "
            f"cap={node.out_capacity}]"
        )
    if isinstance(node, N.CrossJoinNode):
        return "CrossJoin[broadcast single row]"
    if isinstance(node, N.SortNode):
        return f"Sort[{len(node.keys)} keys limit={node.limit}]"
    if isinstance(node, N.LimitNode):
        return f"Limit[{node.count}]"
    if isinstance(node, N.DistinctNode):
        return f"Distinct[max_groups={node.max_groups}]"
    if isinstance(node, N.WindowNode):
        return f"Window[{[c.func for c in node.calls]}]"
    if isinstance(node, N.OutputNode):
        return f"Output[{[o for o, _ in node.columns]}]"
    if isinstance(node, N.ValuesNode):
        return "Values[1 row]"
    if isinstance(node, N.UnnestNode):
        ords = (
            f", ordinality={node.ordinality_name}"
            if node.ordinality_name
            else ""
        )
        return (
            f"Unnest[{node.out_name} x{len(node.elements)}{ords}]"
        )
    return type(node).__name__


def _error_factor(est: float, actual: float) -> float:
    """Symmetric estimate-error ratio (>= 1; 1 = exact)."""
    lo = max(min(est, actual), 1.0)
    hi = max(max(est, actual), 1.0)
    return hi / lo


def render_plan(
    node: N.PlanNode,
    indent: int = 0,
    annot=None,
    est: Optional[Dict[int, Tuple[float, str]]] = None,
) -> str:
    """Indented plan tree. ``annot`` maps id(node) -> (actual rows,
    capacity|None) from an instrumented run; ``est`` maps id(node) ->
    (estimated rows, provenance). With both, lines render
    ``rows: actual, est: N (provenance, error ×E)``; with only ``est``
    (plain EXPLAIN), ``est rows: N (provenance)``."""
    desc = _describe(node)
    e = est.get(id(node)) if est else None
    if annot is not None and id(node) in annot:
        rows, cap = annot[id(node)]
        if cap is None:
            desc += f"  [rows: {rows}, host root stage]"
        else:
            extra = ""
            if e is not None:
                er, src = e
                extra = (
                    f", est: {er:.0f} ({src}, error "
                    f"×{_error_factor(er, rows):.1f})"
                )
            desc += f"  [rows: {rows}{extra}, capacity: {cap}]"
    elif e is not None:
        er, src = e
        desc += f"  [est rows: {er:.0f} ({src})]"
    lines = ["    " * indent + "- " + desc]
    for c in node.children():
        lines.append(render_plan(c, indent + 1, annot, est))
    return "\n".join(lines)


def _estimate_map(
    root: N.PlanNode, catalogs
) -> Dict[int, Tuple[float, str]]:
    """id(node) -> (estimate, provenance) over a plan tree. Caller
    installs the history scope; a failing estimator never fails
    EXPLAIN."""
    out: Dict[int, Tuple[float, str]] = {}
    stats_memo: dict = {}
    for n in N.walk(root):
        try:
            out[id(n)] = estimate_rows_with_source(
                n, catalogs, stats_memo
            )
        except Exception:
            pass
    return out


def explain_text(runner, stmt: ast.Explain, sql: str = "") -> str:
    with runner._history_scope():
        plan = plan_statement(
            stmt.statement, runner.catalogs, runner.session
        )
    if not stmt.analyze:
        root = prune_columns(plan.root)
        with runner._history_scope():
            est = _estimate_map(root, runner.catalogs)
        return render_plan(root, est=est)
    # EXPLAIN ANALYZE: re-run with every node's row count read back in
    # the run's one control read (stats.py); render rows inline.
    # The runner returns the exact trees it executed (param binding may
    # rewrite the plan, so re-deriving them here could annotate the
    # wrong nodes).
    t0 = time.perf_counter()
    result, node_stats, host_rows, root, droot, host_ops, est = (
        runner.execute_plan_analyzed(plan, sql)
    )
    elapsed = time.perf_counter() - t0
    executed_order = {s.node_id: s for s in node_stats}
    annot = {}
    for i, n in enumerate(N.walk(droot)):
        s = executed_order.get(i)
        if s is not None:
            annot[id(n)] = (s.output_rows, s.output_capacity)
    for node, rows in zip(reversed(host_ops), host_rows):
        annot[id(node)] = (rows, None)
    # est-vs-actual: the runner captured planning-time estimates BEFORE
    # the instrumented run wrote its actuals to the history store — a
    # warm run's history-fed estimates shrink the printed error factor
    # (history-based optimization), a cold run's show the real miss
    text = render_plan(root, annot=annot, est=est)
    n_rows = len(result.rows())
    text += (
        f"\n\nEXPLAIN ANALYZE: {n_rows} rows in {elapsed * 1000:.1f} ms "
        f"(wall, single-device instrumented run)"
    )
    return text


def render_span_tree(trace, indent: int = 0) -> str:
    """Render a utils.tracing.Trace as an indented phase tree with
    durations (the text form of /v1/query/{id}'s span tree)."""

    def walk(d, depth):
        lines = [
            "    " * depth
            + f"- {d['name']} {d['duration_ms']:.1f} ms"
            + ("" if d["end"] else " (open)")
        ]
        for c in d.get("children", ()):
            lines.extend(walk(c, depth + 1))
        return lines

    out = []
    for root in trace.to_tree():
        out.extend(walk(root, indent))
    return "\n".join(out)


def _operator_lines(qstats, est_by_fp=None) -> list:
    """Per-operator rollup lines: ``est -> actual (error ×N)`` beside
    wall/device time and the peak page footprint, from the query's
    merged OperatorStats (canonical-fingerprint keyed, so split tasks
    of one stage sum into full totals)."""
    ops = (
        qstats.all_operator_stats()
        if hasattr(qstats, "all_operator_stats")
        else []
    )
    if not ops:
        return []
    lines = ["", "Operators (est -> actual, canonical rollup):"]
    for op in ops:
        e = (est_by_fp or {}).get(op.fingerprint)
        if e is not None:
            er, src = e
            est_part = (
                f"est {er:.0f} rows ({src}) -> actual "
                f"{op.output_rows} rows (error "
                f"×{_error_factor(er, op.output_rows):.1f})"
            )
        else:
            est_part = f"actual {op.output_rows} rows"
        lines.append(
            "  " + "  " * op.depth + f"{op.label}: {est_part}, "
            f"wall {op.wall_ms:.1f} ms, device {op.device_ms:.1f} ms, "
            f"peak {op.peak_page_bytes} B, batches {op.batches}"
        )
    return lines


def render_distributed_analyze(
    root, qstats, trace, n_rows: int, runner=None
) -> str:
    """Distributed EXPLAIN ANALYZE: the fragment-less plan tree plus
    the per-stage/per-task stats rollup, the per-operator est-vs-actual
    rollup, and the query's span tree — the same data
    ``GET /v1/query/{id}`` serves, rendered as text (reference: EXPLAIN
    ANALYZE's stats-in-plan output applied to the distributed tier)."""
    est_by_fp: Dict[str, Tuple[float, str]] = {}
    if root is not None and runner is not None:
        try:
            from presto_tpu_torch.plan import history as plan_history

            stats_memo: dict = {}
            with runner._history_scope():
                fps = plan_history.node_fingerprints(root)
                for n in N.walk(root):
                    fp = fps.get(id(n), "")
                    if fp and fp not in est_by_fp:
                        try:
                            est_by_fp[fp] = estimate_rows_with_source(
                                n, runner.catalogs, stats_memo
                            )
                        except Exception:
                            pass  # keep the nodes that DID estimate
        except Exception:
            pass  # fingerprinting failed wholesale: render without est
    lines = [render_plan(root)] if root is not None else []
    lines.append("")
    lines.append(
        f"Distributed EXPLAIN ANALYZE: {n_rows} rows, "
        f"trace {qstats.trace_id}"
    )
    lines.append(
        f"planning {qstats.planning_ms:.1f} ms "
        f"(optimization {qstats.optimization_ms:.1f} ms), "
        f"execution {qstats.execution_ms:.1f} ms, "
        f"{len(qstats.stages)} stage(s)"
    )
    lines.append(
        "plan cache: "
        + ("HIT" if qstats.plan_cache_hit else "MISS")
        + ", compile cache: "
        + ("HIT" if qstats.compile_cache_hit else "MISS")
        + (
            f", plan fingerprint: {qstats.plan_fingerprint}"
            if qstats.plan_fingerprint
            else ""
        )
    )
    if getattr(qstats, "batched", False):
        # micro-batched serving: this statement's answer came off a
        # shared vmapped dispatch (coordinator batch queue)
        lines.append(
            f"micro-batch: {qstats.batch_size}-way "
            "(one device dispatch served the group)"
        )
    rc_status = getattr(qstats, "result_cache", "")
    if rc_status:
        # serving-plane result reuse (server/result_cache.py): HIT /
        # STALE annotate the snapshot vector the entry was pinned on
        # and the result's age; MISS = consulted, executed normally
        if rc_status == "miss":
            lines.append("result cache: MISS")
        else:
            lines.append(
                f"result cache: {rc_status.upper()} "
                f"(snapshot {qstats.result_cache_snapshot}, "
                f"age {qstats.result_cache_age_ms:.0f}ms)"
            )
    if getattr(qstats, "mview_rewritten", ""):
        lines.append(
            f"materialized view rewrite: {qstats.mview_rewritten} "
            "(aggregate scan answered from the maintained view)"
        )
    # adaptive execution: every replan / mid-query strategy decision
    # this statement took ("REPLANNED (epoch N→M) ..." / "SWITCHED
    # broadcast→partitioned ...")
    for note in getattr(qstats, "adaptive_notes", ()) or ():
        lines.append(f"adaptive: {note}")
    if (
        qstats.dynamic_filters
        or qstats.dynamic_filter_wait_ms
        or qstats.dynamic_filter_splits_pruned
        or qstats.dynamic_filter_rows_pruned
    ):
        lines.append(
            f"dynamic filtering: {qstats.dynamic_filters} filter(s), "
            f"rows_pruned {qstats.dynamic_filter_rows_pruned}, "
            f"splits_pruned {qstats.dynamic_filter_splits_pruned}, "
            f"wait {qstats.dynamic_filter_wait_ms:.1f} ms"
        )
    if qstats.retry_policy and qstats.retry_policy != "NONE":
        lines.append(
            f"fault tolerance: retry_policy={qstats.retry_policy}, "
            f"task_recoveries {qstats.task_recoveries}, "
            f"spool_pages_served {qstats.spool_pages_served}, "
            f"query_restarts {qstats.query_restarts}"
        )
    # cluster memory governance rollup (server/memory_arbiter.py):
    # the query's cluster-wide reservation view + host-spill traffic
    lines.append(
        f"memory: peak {qstats.peak_memory_bytes}B, "
        f"current {qstats.current_memory_bytes}B, "
        f"spilled {qstats.spilled_bytes}B"
    )
    # device-plane accounting (utils/telemetry.py): the before/after
    # probe ROADMAP item 1's "dispatch counts visibly down" is judged
    # by — dispatches, compile attribution, transfer bytes, and the
    # padding share of capacity bucketing
    from presto_tpu_torch.utils.telemetry import pad_waste_pct

    lines.append(
        f"device: dispatches {qstats.device_dispatches}, "
        f"compiles {qstats.device_compiles} "
        f"({qstats.device_compile_ms:.1f} ms), "
        f"h2d {qstats.device_h2d_bytes}B, "
        f"d2h {qstats.device_d2h_bytes}B, "
        "pad waste "
        f"{pad_waste_pct(qstats.device_pad_rows, qstats.device_live_rows):.1f}%"
    )
    # per-edge exchange transport mix (server/exchange_spi.py): how
    # each upstream partition actually travelled — in-slice ICI
    # segment, serialized HTTP wire, or durable-spool re-serve —
    # including the coordinator's own ICI gather edges
    if (
        qstats.exchange_ici_edges
        or qstats.exchange_http_edges
        or qstats.exchange_spool_edges
    ):
        lines.append(
            f"exchange: ici {qstats.exchange_ici_edges}, "
            f"http {qstats.exchange_http_edges}, "
            f"spool {qstats.exchange_spool_edges}"
        )
    for st in qstats.stages:
        r = st.rollup()
        lines.append(
            f"Stage {st.stage_id} [{st.kind}] {st.state}: "
            f"{r['tasks']} task(s), wall {r['wall_ms']:.1f} ms, "
            f"rows {r['input_rows']} -> {r['output_rows']}, "
            f"retries {r['retries']}"
        )
        for t in st.tasks:
            lines.append(
                f"  Task {t.task_id} on {t.node_id}: {t.state}, "
                f"wall {t.wall_ms:.1f} ms (staging {t.staging_ms:.1f}, "
                f"execute {t.execute_ms:.1f}), rows "
                f"{t.input_rows} -> {t.output_rows}, "
                f"bytes {t.input_bytes} -> {t.output_bytes}"
            )
    lines.extend(_operator_lines(qstats, est_by_fp))
    if trace is not None:
        lines.append("")
        lines.append("Span tree:")
        lines.append(render_span_tree(trace))
    return "\n".join(lines)


def render_query_analyze(qstats) -> str:
    """EXPLAIN-ANALYZE-style text rendered purely from a completed
    query's OWN collected stats — no re-run (the slow-query log's
    record body; exec/stats.SlowQueryLog)."""
    return render_distributed_analyze(
        None, qstats, getattr(qstats, "trace", None), qstats.output_rows
    )

"""Logical planner, analyzer, optimizer, fragmenter.

Reference parity: ``presto-main`` ``…/sql/planner/`` — ``LogicalPlanner``
(AST -> PlanNode tree), ``PlanOptimizers`` (rule passes), ``PlanFragmenter``
(SURVEY.md §2.1). The analyzer (name/type resolution) is fused into the
planner here, lowering parse-tree expressions into the typed
presto_tpu.expr IR as scopes are built.

TPU-first: plan nodes carry the *static* shape metadata XLA needs
(capacity buckets, max_groups, join out_capacity) chosen from connector
stats, so a whole plan compiles to one jitted program over staged scan
pages (SURVEY.md §7 "Design stance"); overflow flags trigger host-side
re-planning at bigger buckets.
"""

from presto_tpu_torch.plan.nodes import *  # noqa: F401,F403
from presto_tpu_torch.plan.planner import plan_statement  # noqa: F401

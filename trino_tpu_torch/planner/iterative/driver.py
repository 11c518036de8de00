"""Fixpoint driver (the port of the reference ``planner/iterative/driver.py``;
Trino: sql/planner/iterative/IterativeOptimizer.java exploreGroup/
exploreNode/exploreChildren).

``IterativeOptimizer.run`` walks the memo top-down: apply rules at a
group until none fires, explore the children, and re-explore the group
if any child changed — exactly Trino's exploreGroup loop.  Rule sets run
in named phases (decorrelate -> simplify -> aggregations -> reorder ->
cleanup), each a full fixpoint pass over the memo.

``optimize_iterative`` is the planner entry point: it runs the phases,
then hands the extracted tree to the legacy final passes (column
pruning, scan-constraint attachment, limit-into-scan) that both
optimizer modes share, and publishes the firing trace for EXPLAIN.
The port has no history-based optimization: rules see ``history=None``.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ...telemetry import metrics as tm
from ..plan import CorrelatedJoin, PlanNode
from .memo import Memo
from .rule import Context, Trace

__all__ = ["IterativeOptimizer", "default_phases", "last_report",
           "optimize_iterative"]

_LAST = threading.local()


def last_report() -> Optional[Trace]:
    """Trace of the most recent iterative optimization on this thread
    (what EXPLAIN appends below the plan tree)."""
    return getattr(_LAST, "trace", None)


def default_phases():
    from .rules import aggregates, decorrelate, limits, prune, reorder, simplify
    return (
        ("decorrelate", (
            decorrelate.TransformCorrelatedScalarSubquery(),
            decorrelate.TransformCorrelatedInPredicate(),
        )),
        ("simplify", (
            simplify.RemoveTrivialFilters(),
            simplify.EvaluateZeroInput(),
            simplify.MergeAdjacentFilters(),
            simplify.MergeAdjacentProjects(),
            simplify.InlineProjections(),
            simplify.RemoveRedundantIdentityProjections(),
            limits.PushLimitThroughProject(),
            limits.PushLimitThroughSemiJoin(),
            limits.PushLimitThroughJoin(),
        )),
        ("aggregations", (
            aggregates.PushPartialAggregationThroughJoin(),
            aggregates.PushAggregationThroughOuterJoin(),
        )),
        ("reorder", (
            reorder.ReorderJoins(),
            reorder.DetermineJoinDistribution(),
        )),
        ("cleanup", (
            simplify.MergeAdjacentFilters(),
            simplify.MergeAdjacentProjects(),
            simplify.RemoveRedundantIdentityProjections(),
            prune.PruneJoinColumns(),
        )),
    )


class IterativeOptimizer:
    """``dp_limit``: join clusters of 3 to ``dp_limit`` relations are
    ordered by exhaustive DP, larger ones greedily (the reference reads it
    from TRINO_TPU_JOIN_REORDER_DP_LIMIT, default 6)."""

    def __init__(self, phases=None, max_firings: int = 20_000,
                 dp_limit: int = 6):
        self.phases = phases if phases is not None else default_phases()
        self.max_firings = max_firings
        self.dp_limit = dp_limit

    def run(self, root: PlanNode, ctx: Context) -> PlanNode:
        memo = Memo(root)
        ctx.memo = memo
        ctx.dp_limit = self.dp_limit
        for phase_name, rules in self.phases:
            ctx.phase = phase_name
            self._explore_group(memo.root_group, rules, ctx)
        return memo.extract()

    def _explore_group(self, gid: int, rules, ctx: Context) -> bool:
        progress = self._explore_node(gid, rules, ctx)
        while self._explore_children(gid, rules, ctx):
            progress = True
            if not self._explore_node(gid, rules, ctx):
                break
        return progress

    def _explore_node(self, gid: int, rules, ctx: Context) -> bool:
        memo = ctx.memo
        node = memo.node(gid)
        progress = False
        changed = True
        while changed:
            changed = False
            for rule in rules:
                captures = (rule.pattern.match(node, ctx)
                            if rule.pattern is not None else {})
                if captures is None:
                    continue
                result = rule.apply(node, captures, ctx)
                if result is None or result is node:
                    continue
                # fixpoint safety net: a rule whose output extracts to the
                # same concrete tree did not make progress
                if memo.extract(result) == memo.extract(node):
                    continue
                ctx.firings += 1
                if ctx.firings > self.max_firings:
                    raise RuntimeError(
                        f"iterative optimizer exceeded {self.max_firings} "
                        f"rule firings (last: {rule.name}) — a rule is not "
                        f"reaching fixpoint")
                ctx.trace.fire(ctx.phase, rule.name, node)
                node = memo.replace_group(gid, result)
                progress = changed = True
                break  # restart the rule list against the new node
        return progress

    def _explore_children(self, gid: int, rules, ctx: Context) -> bool:
        progress = False
        for child in ctx.memo.child_groups(gid):
            if self._explore_group(child, rules, ctx):
                progress = True
        return progress


def _assert_decorrelated(node: PlanNode) -> None:
    if isinstance(node, CorrelatedJoin):
        raise AssertionError(
            "CorrelatedJoin survived the decorrelate phase — the "
            "TransformCorrelated* rules must be total")
    for c in node.children:
        _assert_decorrelated(c)


def optimize_iterative(root: PlanNode, catalog) -> PlanNode:
    """Full iterative pipeline: rule phases over the memo, then the
    shared legacy final passes; publishes the trace for EXPLAIN."""
    from .. import optimizer as opt

    t0 = time.perf_counter()
    ctx = Context(catalog=catalog, history=None, trace=Trace())
    out = IterativeOptimizer().run(root, ctx)
    _assert_decorrelated(out)
    out = opt.final_passes(out, catalog)
    ctx.trace.planning_ms = (time.perf_counter() - t0) * 1000.0
    _LAST.trace = ctx.trace
    tm.OPTIMIZER_RUNS.inc()
    tm.OPTIMIZER_RULE_FIRINGS.inc(len(ctx.trace.fires))
    tm.OPTIMIZER_PLANNING_MS.inc(ctx.trace.planning_ms)
    return out

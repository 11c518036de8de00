"""Structural simplification rules (the port of the reference
``planner/iterative/rules/simplify.py``; Trino: iterative/rule/
MergeFilters.java, InlineProjections.java, MergeProjections (via
IterativeOptimizer's ProjectOffPushDown family),
RemoveRedundantIdentityProjections.java, RemoveTrivialFilters.java,
EvaluateEmptyIntersect / the *EmptyPlanNode family behind
EvaluateZeroInput semantics)."""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

from ....spi.types import BOOLEAN
from ....sql.ir import Call, InputRef, Literal, RowExpression
from ...optimizer import _conjoin, _split_and
from ...plan import (
    Aggregate,
    DistinctLimit,
    Filter,
    GroupId,
    Join,
    Limit,
    PlanNode,
    Project,
    Replicate,
    SemiJoin,
    Sort,
    TopN,
    Union,
    Unnest,
    Values,
    Window,
)
from ..pattern import Pattern
from ..rule import Context, Rule

__all__ = [
    "EvaluateZeroInput", "InlineProjections", "MergeAdjacentFilters",
    "MergeAdjacentProjects", "RemoveRedundantIdentityProjections",
    "RemoveTrivialFilters",
]


def _subst(e: RowExpression, inner: tuple) -> RowExpression:
    """Replace each InputRef by the inner projection's defining expr."""
    if isinstance(e, InputRef):
        return inner[e.index]
    if isinstance(e, Call):
        return Call(e.type, e.name, tuple(_subst(a, inner) for a in e.args))
    return e


def _trivial(e: RowExpression) -> bool:
    return isinstance(e, (InputRef, Literal))


def _ref_counts(exprs) -> dict[int, int]:
    counts: dict[int, int] = {}

    def go(e):
        if isinstance(e, InputRef):
            counts[e.index] = counts.get(e.index, 0) + 1
        elif isinstance(e, Call):
            for a in e.args:
                go(a)

    for e in exprs:
        go(e)
    return counts


class MergeAdjacentFilters(Rule):
    """Filter(p, Filter(q, X)) -> Filter(p AND q, X)."""

    pattern = Pattern(Filter).with_source(Pattern(Filter), "inner")

    def apply(self, node: Filter, captures: dict,
              ctx: Context) -> Optional[PlanNode]:
        inner: Filter = captures["inner"]
        pred = _conjoin(_split_and(inner.predicate)
                        + _split_and(node.predicate))
        return Filter(node.output_names, node.output_types,
                      inner.source, pred)


class MergeAdjacentProjects(Rule):
    """Project over a trivial Project (only channel renames/permutations
    and literals) composes into one Project."""

    pattern = Pattern(Project).with_source(Pattern(Project), "inner")

    def apply(self, node: Project, captures: dict,
              ctx: Context) -> Optional[PlanNode]:
        inner: Project = captures["inner"]
        if not all(_trivial(e) for e in inner.expressions):
            return None
        exprs = tuple(_subst(e, inner.expressions) for e in node.expressions)
        return Project(node.output_names, node.output_types,
                       inner.source, exprs)


class InlineProjections(Rule):
    """Project over a computing Project inlines when every computed inner
    channel is referenced at most once above (no work duplication —
    iterative/rule/InlineProjections.java's condition)."""

    pattern = Pattern(Project).with_source(Pattern(Project), "inner")

    def apply(self, node: Project, captures: dict,
              ctx: Context) -> Optional[PlanNode]:
        inner: Project = captures["inner"]
        if all(_trivial(e) for e in inner.expressions):
            return None  # MergeAdjacentProjects' case
        counts = _ref_counts(node.expressions)
        for i, e in enumerate(inner.expressions):
            if not _trivial(e) and counts.get(i, 0) > 1:
                return None
        exprs = tuple(_subst(e, inner.expressions) for e in node.expressions)
        return Project(node.output_names, node.output_types,
                       inner.source, exprs)


class RemoveRedundantIdentityProjections(Rule):
    """Identity Project (same channels, same names) collapses away."""

    pattern = Pattern(Project)

    def apply(self, node: Project, captures: dict,
              ctx: Context) -> Optional[PlanNode]:
        child = node.children[0]  # GroupRef carries the layout
        if len(node.expressions) != len(child.output_types):
            return None
        if tuple(node.output_names) != tuple(child.output_names):
            return None
        for i, e in enumerate(node.expressions):
            if not (isinstance(e, InputRef) and e.index == i):
                return None
        return child


class RemoveTrivialFilters(Rule):
    """Filter(TRUE) drops; Filter(FALSE/NULL) becomes an empty Values."""

    pattern = Pattern(Filter).matching(
        lambda n, ctx: isinstance(n.predicate, Literal))

    def apply(self, node: Filter, captures: dict,
              ctx: Context) -> Optional[PlanNode]:
        if node.predicate.value is True:
            return node.children[0]
        if node.predicate.value in (False, None):
            return Values(node.output_names, node.output_types, rows=())
        return None


def _is_empty(n: PlanNode) -> bool:
    return isinstance(n, Values) and not n.rows


def _empty_like(node: PlanNode) -> Values:
    return Values(node.output_names, node.output_types, rows=())


class EvaluateZeroInput(Rule):
    """Propagate empty relations (reference: the
    Remove/Evaluate-over-empty rule family — e.g.
    RemoveRedundantJoin / EvaluateZeroLimit semantics): an empty input
    makes row-preserving operators, grouped aggregations, and the
    affected join sides statically empty."""

    pattern = Pattern(PlanNode).matching(
        lambda n, ctx: any(_is_empty(ctx.resolve(c)) for c in n.children))

    def apply(self, node: PlanNode, captures: dict,
              ctx: Context) -> Optional[PlanNode]:
        kids = [ctx.resolve(c) for c in node.children]
        if isinstance(node, (Project, Filter, Sort, Limit, TopN,
                             DistinctLimit, Window, GroupId, Unnest,
                             Replicate)):
            return _empty_like(node)
        if isinstance(node, Aggregate):
            # a GLOBAL aggregate over zero rows still emits one row
            if node.group_keys and node.step == "SINGLE":
                return _empty_like(node)
            return None
        if isinstance(node, Join):
            left_empty, right_empty = _is_empty(kids[0]), _is_empty(kids[1])
            jt = node.join_type
            if ((jt in ("INNER", "CROSS") and (left_empty or right_empty))
                    or (jt in ("LEFT", "SINGLE") and left_empty)
                    or (jt == "RIGHT" and right_empty)
                    or (jt == "FULL" and left_empty and right_empty)):
                return _empty_like(node)
            return None
        if isinstance(node, SemiJoin):
            if _is_empty(kids[0]):
                return _empty_like(node)
            if _is_empty(kids[1]) and node.residual is None:
                # membership in the empty set is FALSE for every source
                # row (even NULL keys, null-aware or not)
                src = node.children[0]
                exprs = tuple(InputRef(t, i)
                              for i, t in enumerate(src.output_types))
                exprs = exprs + (Literal(BOOLEAN, False),)
                return Project(node.output_names, node.output_types,
                               src, exprs)
            return None
        if isinstance(node, Union):
            keep = [c for c, k in zip(node.children, kids)
                    if not _is_empty(k)]
            if len(keep) == len(kids):
                return None
            if not keep:
                return _empty_like(node)
            if len(keep) == 1:
                src = keep[0]
                exprs = tuple(InputRef(t, i)
                              for i, t in enumerate(src.output_types))
                return Project(node.output_names, node.output_types,
                               src, exprs)
            return replace(node, sources=tuple(keep))
        return None

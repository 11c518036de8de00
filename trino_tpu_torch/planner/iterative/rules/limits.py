"""Limit pushdown rules (the port of the reference
``planner/iterative/rules/limits.py``; Trino: iterative/rule/
PushLimitThroughProject.java, PushLimitThroughOuterJoin.java,
PushLimitThroughSemiJoin.java)."""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

from ...plan import Join, Limit, PlanNode, Project, SemiJoin
from ..pattern import Pattern
from ..rule import Context, Rule

__all__ = ["PushLimitThroughJoin", "PushLimitThroughProject",
           "PushLimitThroughSemiJoin"]


class PushLimitThroughProject(Rule):
    """Limit(Project(X)) -> Project(Limit(X)): projections are 1:1, so
    limiting below is identical and lets the limit keep sinking (and
    eventually fold into a TableScan)."""

    pattern = Pattern(Limit).with_source(Pattern(Project), "project")

    def apply(self, node: Limit, captures: dict,
              ctx: Context) -> Optional[PlanNode]:
        project: Project = captures["project"]
        src = project.children[0]
        inner = Limit(src.output_names, src.output_types, src, node.count)
        return replace(project, source=inner)


class PushLimitThroughSemiJoin(Rule):
    """Limit(SemiJoin(X, F)) -> SemiJoin(Limit(X), F): the semijoin emits
    exactly one output row per source row (a mark column), so the outer
    limit is subsumed by the pushed one."""

    pattern = Pattern(Limit).with_source(Pattern(SemiJoin), "semijoin")

    def apply(self, node: Limit, captures: dict,
              ctx: Context) -> Optional[PlanNode]:
        semijoin: SemiJoin = captures["semijoin"]
        src = semijoin.children[0]
        resolved = ctx.resolve(src)
        if isinstance(resolved, Limit) and resolved.count <= node.count:
            return None
        inner = Limit(src.output_names, src.output_types, src, node.count)
        return replace(semijoin, source=inner)


class PushLimitThroughJoin(Rule):
    """Limit(n, LeftJoin(A, B)) -> Limit(n, LeftJoin(Limit(n, A), B)):
    a left join emits at least one row per probe row, so n probe rows
    suffice; the outer limit stays to trim multi-match fan-out."""

    pattern = Pattern(Limit).with_source(
        Pattern(Join).matching(lambda n, ctx: n.join_type == "LEFT"),
        "join")

    def apply(self, node: Limit, captures: dict,
              ctx: Context) -> Optional[PlanNode]:
        join: Join = captures["join"]
        left = join.children[0]
        resolved = ctx.resolve(left)
        if isinstance(resolved, Limit) and resolved.count <= node.count:
            return None
        inner = Limit(left.output_names, left.output_types, left, node.count)
        return replace(node, source=replace(join, left=inner))

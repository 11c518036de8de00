"""Decorrelation rules (the port of the reference
``planner/iterative/rules/decorrelate.py``; Trino: iterative/rule/
TransformCorrelatedScalarSubquery.java,
TransformCorrelatedInPredicateToJoin.java).

The logical planner emits a :class:`CorrelatedJoin` placeholder when the
iterative optimizer is active; these rules lower it to the same join
shapes the legacy planner builds directly — but as rules, so the
subquery side participates in simplification/reordering first."""

from __future__ import annotations

from typing import Optional

from ...plan import CorrelatedJoin, Join, PlanNode, SemiJoin
from ..pattern import Pattern
from ..rule import Context, Rule

__all__ = ["TransformCorrelatedInPredicate",
           "TransformCorrelatedScalarSubquery"]


class TransformCorrelatedScalarSubquery(Rule):
    """Correlated scalar-aggregate subquery -> LEFT join on the
    correlation keys (the subquery side is already grouped by them, so
    at most one match per probe row)."""

    pattern = Pattern(CorrelatedJoin).matching(
        lambda n, ctx: n.kind == "scalar_agg")

    def apply(self, node: CorrelatedJoin, captures: dict,
              ctx: Context) -> Optional[PlanNode]:
        return Join(node.output_names, node.output_types,
                    node.children[0], node.children[1], "LEFT",
                    node.source_keys, node.subquery_keys, None)


class TransformCorrelatedInPredicate(Rule):
    """IN (subquery) -> null-aware SemiJoin producing the mark column."""

    pattern = Pattern(CorrelatedJoin).matching(
        lambda n, ctx: n.kind == "in")

    def apply(self, node: CorrelatedJoin, captures: dict,
              ctx: Context) -> Optional[PlanNode]:
        return SemiJoin(node.output_names, node.output_types,
                        node.children[0], node.children[1],
                        node.source_keys, node.subquery_keys,
                        negated=False, residual=None, null_aware=True)

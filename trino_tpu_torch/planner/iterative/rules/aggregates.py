"""Aggregation pushdown rules (the port of the reference
``planner/iterative/rules/aggregates.py``; Trino: iterative/rule/
PushPartialAggregationThroughJoin.java,
PushAggregationThroughOuterJoin.java).

Both rules are the "eager aggregation" transform: pre-aggregate one join
input grouped by (its group keys ++ its join keys), join the compacted
side, then merge the partial states above.  Exactness: the join
duplicates each pre-aggregated state once per matching row of the other
side, and the merge functions (count->sum, sum->sum, min->min, max->max)
are exactly duplication-distributive under that grouping — no
count-scaling needed because the join keys are part of the inner
grouping.  min/max are duplication-insensitive outright."""

from __future__ import annotations

from typing import Optional

from ....sql.ir import Call, InputRef, Literal
from ...optimizer import estimate_rows
from ...plan import Aggregate, AggCall, Join, PlanNode, Project
from ..pattern import Pattern
from ..rule import Context, Rule

__all__ = ["PushAggregationThroughOuterJoin",
           "PushPartialAggregationThroughJoin"]

# pre-aggregation must actually compact the side it is pushed into
_COMPACTION_GATE = 0.5

_MERGE = {"count": "sum", "count_star": "sum", "sum": "sum",
          "min": "min", "max": "max"}


def _eligible(agg: Aggregate) -> bool:
    return (agg.step == "SINGLE" and agg.aggregates
            and not any(a.distinct for a in agg.aggregates))


def _worth_pushing(inner: Aggregate, side_concrete: PlanNode,
                   ctx: Context) -> bool:
    """Gate on the cost model: the inner aggregation must shrink its
    input, else the extra pass is pure overhead."""
    groups = estimate_rows(inner, ctx.catalog, ctx.history)
    rows = estimate_rows(side_concrete, ctx.catalog, ctx.history)
    return groups < _COMPACTION_GATE * rows


class PushPartialAggregationThroughJoin(Rule):
    """Aggregate(G, aggs, InnerJoin(A, B)) with every aggregate argument
    on one side S -> merge-Aggregate over InnerJoin with S replaced by a
    pre-aggregation grouped by (G cap S) ++ S's join keys."""

    pattern = Pattern(Aggregate).matching(
        lambda n, ctx: _eligible(n)).with_source(
        Pattern(Join).matching(
            lambda n, ctx: n.join_type == "INNER" and n.residual is None),
        "join")

    def apply(self, node: Aggregate, captures: dict,
              ctx: Context) -> Optional[PlanNode]:
        join: Join = captures["join"]
        left, right = join.children
        lw = len(left.output_types)
        if any(a.fn not in _MERGE for a in node.aggregates):
            return None
        sides = {("left" if a.arg < lw else "right")
                 for a in node.aggregates if a.arg >= 0}
        if len(sides) > 1:
            return None
        side = sides.pop() if sides else "right"  # all count(*): either works
        side_ref = left if side == "left" else right
        if isinstance(ctx.resolve(side_ref), Aggregate):
            return None  # already compacted (and guards re-firing)

        G = node.group_keys
        sw = len(side_ref.output_types)
        base = 0 if side == "left" else lw
        g_side = [g - base for g in G if base <= g < base + sw]
        side_keys = join.left_keys if side == "left" else join.right_keys
        keys = sorted(set(g_side) | set(side_keys))
        key_pos = {k: i for i, k in enumerate(keys)}

        agg_names = tuple(node.output_names[len(G) + i]
                          for i in range(len(node.aggregates)))
        inner_aggs = tuple(
            AggCall(a.fn, (a.arg - base) if a.arg >= 0 else -1, a.type, False)
            for a in node.aggregates)
        inner_names = (tuple(side_ref.output_names[k] for k in keys)
                       + tuple(f"{n}$partial" for n in agg_names))
        inner_types = (tuple(side_ref.output_types[k] for k in keys)
                       + tuple(a.type for a in node.aggregates))
        inner = Aggregate(inner_names, inner_types, side_ref,
                          tuple(keys), inner_aggs, "SINGLE")
        if not _worth_pushing(
                Aggregate(inner_names, inner_types, ctx.extract(side_ref),
                          tuple(keys), inner_aggs, "SINGLE"),
                ctx.extract(side_ref), ctx):
            return None

        iw = len(inner_types)
        if side == "left":
            new_left, new_right = inner, right
            left_keys = tuple(key_pos[k] for k in join.left_keys)
            right_keys = join.right_keys
            remap = lambda g: (key_pos[g] if g < lw else iw + (g - lw))
            state_base = len(keys)
        else:
            new_left, new_right = left, inner
            left_keys = join.left_keys
            right_keys = tuple(key_pos[k] for k in join.right_keys)
            remap = lambda g: (g if g < lw else lw + key_pos[g - lw])
            state_base = lw + len(keys)
        join_names = (tuple(new_left.output_names)
                      + tuple(new_right.output_names))
        join_types = (tuple(new_left.output_types)
                      + tuple(new_right.output_types))
        new_join = Join(join_names, join_types, new_left, new_right,
                        "INNER", left_keys, right_keys, None,
                        join.distribution)

        merged = tuple(
            AggCall(_MERGE[a.fn], state_base + i, a.type, False)
            for i, a in enumerate(node.aggregates))
        return Aggregate(node.output_names, node.output_types, new_join,
                         tuple(remap(g) for g in G), merged, "SINGLE")


class PushAggregationThroughOuterJoin(Rule):
    """Aggregate(G subset-of probe, aggs over build, LeftJoin(A, B)) ->
    merge-Aggregate over LeftJoin(A, pre-aggregate(B by its join keys)),
    with COUNT columns coalesced to 0 above (an all-unmatched group
    yields a NULL merged state where the original counted 0)."""

    pattern = Pattern(Aggregate).matching(
        lambda n, ctx: _eligible(n)).with_source(
        Pattern(Join).matching(
            lambda n, ctx: n.join_type == "LEFT" and n.residual is None),
        "join")

    def apply(self, node: Aggregate, captures: dict,
              ctx: Context) -> Optional[PlanNode]:
        join: Join = captures["join"]
        left, right = join.children
        lw = len(left.output_types)
        if any(g >= lw for g in node.group_keys):
            return None
        if any(a.arg < lw or a.fn not in ("count", "sum", "min", "max")
               for a in node.aggregates):
            return None  # needs every argument on the null-extended side
        if isinstance(ctx.resolve(right), Aggregate):
            return None

        G = node.group_keys
        keys = sorted(set(join.right_keys))
        key_pos = {k: i for i, k in enumerate(keys)}
        agg_names = tuple(node.output_names[len(G) + i]
                          for i in range(len(node.aggregates)))
        inner_aggs = tuple(AggCall(a.fn, a.arg - lw, a.type, False)
                           for a in node.aggregates)
        inner_names = (tuple(right.output_names[k] for k in keys)
                       + tuple(f"{n}$partial" for n in agg_names))
        inner_types = (tuple(right.output_types[k] for k in keys)
                       + tuple(a.type for a in node.aggregates))
        inner = Aggregate(inner_names, inner_types, right,
                          tuple(keys), inner_aggs, "SINGLE")
        if not _worth_pushing(
                Aggregate(inner_names, inner_types, ctx.extract(right),
                          tuple(keys), inner_aggs, "SINGLE"),
                ctx.extract(right), ctx):
            return None

        join_names = tuple(left.output_names) + inner_names
        join_types = tuple(left.output_types) + inner_types
        new_join = Join(join_names, join_types, left, inner, "LEFT",
                        join.left_keys,
                        tuple(key_pos[k] for k in join.right_keys),
                        None, join.distribution)
        merged = tuple(
            AggCall(_MERGE[a.fn], lw + len(keys) + i, a.type, False)
            for i, a in enumerate(node.aggregates))
        agg = Aggregate(node.output_names, node.output_types, new_join,
                        G, merged, "SINGLE")
        exprs = [InputRef(t, i)
                 for i, t in enumerate(node.output_types[:len(G)])]
        for i, a in enumerate(node.aggregates):
            ref = InputRef(a.type, len(G) + i)
            if a.fn == "count":
                exprs.append(Call(a.type, "$coalesce",
                                  (ref, Literal(a.type, 0))))
            else:
                exprs.append(ref)
        return Project(node.output_names, node.output_types, agg,
                       tuple(exprs))

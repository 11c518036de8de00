"""Column-pruning rules (the port of the reference
``planner/iterative/rules/prune.py``; Trino: iterative/rule/
PruneJoinColumns.java / PruneJoinChildrenColumns.java).

The legacy ``_prune`` pass already narrows scans bottom-up; this rule
covers the shape it misses inside the memo — a Project over a Join that
carries channels no one above needs — by narrowing the join inputs with
identity sub-projections before the fragmenter materializes exchanges."""

from __future__ import annotations

from typing import Optional

from ....sql.ir import InputRef
from ...optimizer import _refs, _remap_expr
from ...plan import Join, PlanNode, Project
from ..pattern import Pattern
from ..rule import Context, Rule

__all__ = ["PruneJoinColumns"]


def _narrow(side, keep: list[int]) -> Project:
    names = tuple(side.output_names[i] for i in keep)
    types = tuple(side.output_types[i] for i in keep)
    exprs = tuple(InputRef(side.output_types[i], i) for i in keep)
    return Project(names, types, side, exprs)


class PruneJoinColumns(Rule):
    """Project(Join(A, B)) where some join output channels are dead:
    wrap the wide side(s) in identity projections over the live channels
    and remap keys/residual/projection accordingly."""

    pattern = Pattern(Project).with_source(Pattern(Join), "join")

    def apply(self, node: Project, captures: dict,
              ctx: Context) -> Optional[PlanNode]:
        join: Join = captures["join"]
        left, right = join.children
        lw = len(left.output_types)
        rw = len(right.output_types)

        needed: set[int] = set()
        for e in node.expressions:
            needed |= _refs(e)
        needed |= set(join.left_keys)
        needed |= {lw + k for k in join.right_keys}
        if join.residual is not None:
            needed |= _refs(join.residual)

        left_keep = sorted(i for i in needed if i < lw)
        right_keep = sorted(i - lw for i in needed if i >= lw)
        # zero-column relations are not representable; pin one channel
        if not left_keep:
            left_keep = [0]
        if not right_keep:
            right_keep = [0]
        if len(left_keep) == lw and len(right_keep) == rw:
            return None

        new_left = _narrow(left, left_keep) if len(left_keep) < lw else left
        new_right = (_narrow(right, right_keep)
                     if len(right_keep) < rw else right)
        lmap = {old: new for new, old in enumerate(left_keep)}
        rmap = {old: new for new, old in enumerate(right_keep)}
        nlw = len(left_keep)
        mapping = {}
        for old, new in lmap.items():
            mapping[old] = new
        for old, new in rmap.items():
            mapping[lw + old] = nlw + new

        join_names = tuple(new_left.output_names) + tuple(new_right.output_names)
        join_types = tuple(new_left.output_types) + tuple(new_right.output_types)
        residual = (_remap_expr(join.residual, mapping)
                    if join.residual is not None else None)
        new_join = Join(join_names, join_types, new_left, new_right,
                        join.join_type,
                        tuple(lmap[k] for k in join.left_keys),
                        tuple(rmap[k] for k in join.right_keys),
                        residual, join.distribution)
        exprs = tuple(_remap_expr(e, mapping) for e in node.expressions)
        return Project(node.output_names, node.output_types, new_join, exprs)

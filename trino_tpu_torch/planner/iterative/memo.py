"""Single-expression-per-group memo (the port of the reference
``planner/iterative/memo.py``; Trino: sql/planner/iterative/Memo.java,
GroupReference.java).

Trino's iterative memo is deliberately *not* a Cascades memo: each group
holds exactly one logical expression whose children are group references,
and a rule firing replaces the group's expression wholesale.  That is
what makes the fixpoint driver simple — no alternatives, no winners, just
the latest rewrite — while still giving structural sharing (identical
subtrees intern to one group) and O(1) subtree replacement.

Plan nodes are frozen dataclasses, so a group's representative is the
original node with its children swapped for :class:`GroupRef` leaves;
``extract`` materializes the concrete tree back out.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from ..plan import CorrelatedJoin, Join, PlanNode, SemiJoin, Union

__all__ = ["GroupRef", "Memo", "with_children"]


@dataclass(frozen=True)
class GroupRef(PlanNode):
    """Leaf standing in for a memo group inside a representative node.
    Carries the group's output layout so layout-dependent rewrites work
    without resolving (mirrors GroupReference.java keeping outputs)."""

    group: int = -1

    def label(self) -> str:
        return f"GroupRef[{self.group}]"


def with_children(node: PlanNode, kids: tuple) -> PlanNode:
    """Rebuild ``node`` with ``kids`` as its children (same arity)."""
    if isinstance(node, Union):
        return replace(node, sources=tuple(kids))
    if isinstance(node, Join):
        return replace(node, left=kids[0], right=kids[1])
    if isinstance(node, SemiJoin):
        return replace(node, source=kids[0], filter_source=kids[1])
    if isinstance(node, CorrelatedJoin):
        return replace(node, source=kids[0], subquery=kids[1])
    if not kids:
        return node
    return replace(node, source=kids[0])


class Memo:
    """Groups are dense ints; ``node(gid)`` is the representative whose
    children are GroupRefs.  ``insert`` interns structurally-identical
    representatives to one group (dedup is best-effort: nodes holding
    unhashable payloads — e.g. MatchRecognize AST — get fresh groups)."""

    def __init__(self, root: PlanNode):
        self._nodes: dict[int, PlanNode] = {}
        self._interned: dict[PlanNode, int] = {}
        self._next = 0
        self.root_group = self.insert(root)

    def insert(self, node: PlanNode) -> int:
        if isinstance(node, GroupRef):
            return node.group
        kids = node.children
        if kids:
            refs = tuple(
                GroupRef(self.node(g).output_names, self.node(g).output_types,
                         group=g)
                for g in (self.insert(c) for c in kids))
            node = with_children(node, refs)
        try:
            gid = self._interned.get(node)
        except TypeError:  # unhashable payload — skip dedup
            gid = None
        if gid is not None:
            return gid
        gid = self._next
        self._next += 1
        self._nodes[gid] = node
        try:
            self._interned[node] = gid
        except TypeError:
            pass
        return gid

    def node(self, gid: int) -> PlanNode:
        return self._nodes[gid]

    def resolve(self, node_or_ref) -> PlanNode:
        """GroupRef -> its group's representative; concrete nodes pass
        through (the Lookup.resolve of Rule.Context)."""
        if isinstance(node_or_ref, GroupRef):
            return self._nodes[node_or_ref.group]
        return node_or_ref

    def replace_group(self, gid: int, node: PlanNode) -> PlanNode:
        """Point ``gid`` at a new representative (a rule's output; its
        concrete children are interned into child groups) and return it."""
        if isinstance(node, GroupRef):
            node = self._nodes[node.group]
        kids = node.children
        if kids and not all(isinstance(k, GroupRef) for k in kids):
            refs = tuple(
                k if isinstance(k, GroupRef) else GroupRef(
                    k.output_names, k.output_types, group=self.insert(k))
                for k in kids)
            node = with_children(node, refs)
        self._nodes[gid] = node
        return node

    def child_groups(self, gid: int) -> tuple[int, ...]:
        return tuple(k.group for k in self._nodes[gid].children)

    def extract(self, gid_or_node=None) -> PlanNode:
        """Materialize the concrete tree under a group (default: root)."""
        if gid_or_node is None:
            gid_or_node = self.root_group
        if isinstance(gid_or_node, GroupRef):
            gid_or_node = gid_or_node.group
        node = (self._nodes[gid_or_node] if isinstance(gid_or_node, int)
                else gid_or_node)
        kids = node.children
        if not kids:
            return node
        return with_children(node, tuple(self.extract(k) for k in kids))

    def group_count(self) -> int:
        return len(self._nodes)

"""Tiny pattern DSL for rule matching (the port of the reference
``planner/iterative/pattern.py``; Trino: sql/planner/iterative/
matching/Pattern.java + the typeOf(...).with(source().matching(...))
combinators rules declare their shapes with).

A pattern is a node-type test plus optional predicates and child
patterns.  Matching happens against memo representatives, so child
nodes are GroupRefs — the matcher resolves them through the rule
context before testing, and captures resolve to representatives (whose
own children are again GroupRefs; rules call ``ctx.extract`` when they
need a concrete subtree).

Match results are dicts of named captures; ``None`` means no match.
"""

from __future__ import annotations

from typing import Callable, Optional

__all__ = ["Pattern"]


class Pattern:
    """``Pattern(Filter)`` matches any Filter; ``.matching(pred)`` adds a
    predicate on the (resolved) node; ``.with_source(p, "inner")`` adds a
    child pattern whose resolved match lands in the capture dict under
    the given name (children are matched positionally)."""

    def __init__(self, node_type, *,
                 where: Optional[Callable] = None,
                 children: tuple = ()):
        self.node_type = node_type
        self.where = where
        self.children = children  # ((position, name, Pattern), ...)

    def matching(self, pred: Callable) -> "Pattern":
        prev = self.where
        where = pred if prev is None else (
            lambda node, ctx: prev(node, ctx) and pred(node, ctx))
        return Pattern(self.node_type, where=where, children=self.children)

    def with_child(self, position: int, name: str,
                   pattern: "Pattern") -> "Pattern":
        return Pattern(self.node_type, where=self.where,
                       children=self.children + ((position, name, pattern),))

    def with_source(self, pattern: "Pattern", name: str = "source") -> "Pattern":
        return self.with_child(0, name, pattern)

    def match(self, node, ctx) -> Optional[dict]:
        """Match ``node`` (a memo representative or concrete node),
        resolving children through ``ctx``; returns captures or None."""
        if not isinstance(node, self.node_type):
            return None
        if self.where is not None and not self.where(node, ctx):
            return None
        captures: dict = {}
        for position, name, child in self.children:
            kids = node.children
            if position >= len(kids):
                return None
            resolved = ctx.resolve(kids[position])
            sub = child.match(resolved, ctx)
            if sub is None:
                return None
            captures[name] = resolved
            captures.update(sub)
        return captures

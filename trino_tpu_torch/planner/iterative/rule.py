"""Rule base class, rule context, and the firing trace (the port of the
reference ``planner/iterative/rule.py``; Trino: sql/planner/iterative/
Rule.java + Rule.Context, and the IterativeOptimizer stats that EXPLAIN
ANALYZE VERBOSE surfaces).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..plan import PlanNode

__all__ = ["Context", "Rule", "Trace"]


class Trace:
    """Append-only record of rule firings plus history-lookup counters;
    ``lines()`` renders the EXPLAIN trace block."""

    def __init__(self):
        self.fires: list[tuple[str, str, str]] = []  # (phase, rule, node)
        self.planning_ms = 0.0
        self.history_hits = 0
        self.history_lookups = 0

    def fire(self, phase: str, rule: str, node: PlanNode) -> None:
        self.fires.append((phase, rule, type(node).__name__))

    def fired(self, rule: str) -> int:
        return sum(1 for _, r, _ in self.fires if r == rule)

    def lines(self, timings: bool = True) -> list[str]:
        # plain EXPLAIN output stays timing-free (and so deterministic);
        # planning wall only renders under ANALYZE
        head = f"optimizer: iterative, {len(self.fires)} rule firings"
        if timings:
            head += f", {self.planning_ms:.1f}ms"
        out = [head]
        seen: dict[tuple[str, str], int] = {}
        order: list[tuple[str, str]] = []
        for phase, rule, _ in self.fires:
            key = (phase, rule)
            if key not in seen:
                order.append(key)
            seen[key] = seen.get(key, 0) + 1
        for phase, rule in order:
            out.append(f"  rule {rule} [{phase}] fired x{seen[(phase, rule)]}")
        if self.history_lookups:
            out.append(
                f"history: {'hit' if self.history_hits else 'miss'} "
                f"({self.history_hits}/{self.history_lookups} lookups)")
        return out


@dataclass
class Context:
    """What rules see: the catalog for stats, the optional
    HistoryProvider (planner/history.py), the trace, and memo plumbing (resolve GroupRefs,
    extract concrete subtrees).  ``reordered`` holds the reprs of join
    subtrees a ReorderJoins firing produced, so the rule skips its own
    output.  ``dp_limit`` is the largest join cluster ReorderJoins orders
    by exhaustive DP (the IterativeOptimizer sets it)."""

    catalog: object = None
    history: object = None
    trace: Trace = field(default_factory=Trace)
    memo: object = None
    phase: str = ""
    firings: int = 0
    reordered: set = field(default_factory=set)
    dp_limit: int = 6

    def resolve(self, node):
        if self.memo is not None:
            return self.memo.resolve(node)
        return node

    def extract(self, node):
        if self.memo is not None:
            return self.memo.extract(node)
        return node


class Rule:
    """One rewrite: ``pattern`` declares the shape, ``apply`` returns a
    replacement subtree or None (no change).  ``apply`` must preserve
    the matched node's output layout (names, types, channel order) —
    wrap in a restoring Project otherwise — and must reach fixpoint:
    re-applying to its own output must return None."""

    pattern = None

    @property
    def name(self) -> str:
        return type(self).__name__

    def apply(self, node: PlanNode, captures: dict,
              ctx: Context) -> Optional[PlanNode]:
        raise NotImplementedError

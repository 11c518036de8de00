"""Iterative memo/fixpoint optimizer (the port of the reference
``planner/iterative/``; Trino: sql/planner/iterative/IterativeOptimizer.java,
Memo.java, Rule.java, matching/Pattern.java).

The package miniaturizes Trino's 228-rule engine to the channel-index
plan IR: a :class:`~trino_tpu_torch.planner.iterative.memo.Memo` holds one
expression per group (Trino's Memo, not full Cascades), rules match
shapes through a small :mod:`pattern` DSL and return replacement
subtrees, and the :mod:`driver` explores groups to fixpoint in named
phases, recording every firing in a :class:`~trino_tpu_torch.planner.
iterative.rule.Trace` that EXPLAIN surfaces.

``optimize_iterative`` is what ``planner.optimizer.optimize`` runs in its
default mode, ``"iterative"``.
"""

from .driver import IterativeOptimizer, default_phases, last_report, optimize_iterative
from .memo import GroupRef, Memo
from .pattern import Pattern
from .rule import Context, Rule, Trace

__all__ = [
    "Context", "GroupRef", "IterativeOptimizer", "Memo", "Pattern",
    "Rule", "Trace", "default_phases", "last_report", "optimize_iterative",
]

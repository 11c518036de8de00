"""The tables a plan scans, the key of its version vector.

The port's copy of ``scan_tables`` of the reference
``caching/plan_cache.py``; the plan cache itself (ROADMAP queue 1 item 4)
ports the rest.
"""

from __future__ import annotations

from ..planner.plan import TableScan

__all__ = ["scan_tables"]


def scan_tables(plan) -> tuple:
    """Sorted unique (catalog, table) pairs the plan reads."""
    out = set()

    def walk(node):
        if isinstance(node, TableScan):
            out.add((node.catalog, node.table))
        for c in node.children:
            walk(c)

    walk(plan)
    return tuple(sorted(out))

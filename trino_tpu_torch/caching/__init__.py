"""The three-tier cache plane for repeated dashboard-style traffic.

The port of the reference ``caching/``:

- **Tier A**, :mod:`.plan_cache`: fingerprinted logical plans; a hit
  skips parse -> analyze -> plan -> optimize.
- **Tier B**, :mod:`.executable_cache`: the bounded, observable registry
  of the engine's module-level memos (the port compiles nothing at run
  time, so there is no compile cache).
- **Tier C**, :mod:`.result_cache`: table-version-keyed query results with
  connector invalidation.

Each tier has its switch, ``TRINO_TPU_{PLAN,EXEC,RESULT}_CACHE=0`` (the
exec tier's keeps its memos bounded and only stops counting them).
This module adds the cross-tier roll-up ``system.runtime.caches`` reads.
"""

from __future__ import annotations

__all__ = ["cache_rows", "reset_for_test"]


def cache_rows(per_exec_cache: bool = False) -> list[dict]:
    """Per-tier stats rows: plan, exec (aggregated, or one row per
    registered cache with ``per_exec_cache``), result.  The dict shape is
    the ``system.runtime.caches`` schema."""
    from . import executable_cache, plan_cache, result_cache

    rows = [plan_cache.stats()]
    if per_exec_cache:
        rows.extend(executable_cache.registry_stats())
    else:
        rows.append(executable_cache.aggregate_stats())
    rows.append(result_cache.stats())
    return rows


def reset_for_test() -> None:
    """Clear every tier's entries and stats (the registry keeps its
    registered caches and drops their contents, the expand's estimate
    seeds among them)."""
    from . import executable_cache, plan_cache, result_cache

    plan_cache.reset_for_test()
    result_cache.reset_for_test()
    executable_cache.clear_all()

"""The result cache's version vector: the data_version tokens of a set of
tables, which materialized-view staleness compares.

The port's copy of ``version_vector`` of the reference
``caching/result_cache.py``; the cache itself (ROADMAP queue 1 item 4)
ports the rest.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["version_vector"]


def version_vector(tables: tuple, catalog) -> Optional[tuple]:
    """Sorted (catalog, table, version-token) vector for the scanned table
    set, or None when any table is unversioned (-> uncacheable read)."""
    out = []
    for cat_name, table in tables:
        try:
            conn = catalog.connector(cat_name)
            v = conn.data_version(table)
        except Exception:  # noqa: BLE001 — a vanished table is a miss
            return None
        if v is None:
            return None
        out.append((cat_name, table, str(v)))
    return tuple(sorted(out))

"""Tier C: the versioned result cache.

The port of the reference ``caching/result_cache.py``.  Every connector
exposes a ``data_version(table)`` token (spi/connector.py): the memory and
file connectors change it on every INSERT / CTAS / DELETE / TRUNCATE /
DROP and on a transaction's rollback, the TPC-H generator's is constant
per scale factor, and the system connector returns ``None``: volatile
tables are never cached.  An entry is keyed by the plan cache's key prefix
(statement text ⊕ session ⊕ the runner's execution key ⊕ catalog
instance and generation) ⊕ the **sorted table-version vector** of every
table the plan scans.  A mutation of an input table changes its token, so
the old entry can never be served again; the write also drops matching
entries at once through :func:`invalidate_table`, which is what the
``invalidations`` counter measures.

The store is bounded by ``TRINO_TPU_RESULT_CACHE_BYTES`` (default 64 MiB)
with LRU eviction; a result larger than a quarter of the budget is not
admitted.  :func:`result_nbytes` counts the result's tensors and
dictionaries: a result of a CUDA run holds device memory outside every
query's memory pool, and the ``bytes`` column of ``system.runtime.caches``
shows it.  A hit hands out the stored ``QueryResult`` itself; nothing in
the engine changes a result's batch in place.

``TRINO_TPU_RESULT_CACHE=0`` (checked per lookup) turns the tier off;
:func:`disabled` does so for a scope, for harnesses that time execution.

The materialized-view staleness check (connectors/catalog.py
``Catalog.mv_is_stale``) compares the same tokens (:func:`version_vector`).
"""

from __future__ import annotations

import contextlib
import os
import threading
from collections import OrderedDict
from typing import Optional

from ..spi import knobs

__all__ = [
    "enabled", "disabled", "capacity_bytes", "version_vector", "result_key",
    "lookup", "store", "invalidate_table", "result_nbytes", "stats",
    "reset_for_test",
]

_KNOB = "TRINO_TPU_RESULT_CACHE"


def enabled() -> bool:
    return knobs.switched_on(_KNOB)


@contextlib.contextmanager
def disabled():
    """Scope with the result tier off, for harnesses that measure
    *execution* (launch counts, host syncs, revocations, timings): a served
    result would skip the very work under measurement.  It sets the
    environment variable, so the reference package's tier is off too."""
    old = os.environ.get(_KNOB)
    os.environ[_KNOB] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ[_KNOB]
        else:
            os.environ[_KNOB] = old


def capacity_bytes() -> int:
    return knobs.get_int("TRINO_TPU_RESULT_CACHE_BYTES")


_LOCK = threading.Lock()
# key -> (result, nbytes, tables)
_ENTRIES: OrderedDict = OrderedDict()
_BYTES = 0
_HITS = 0
_MISSES = 0
_EVICTIONS = 0
_INVALIDATIONS = 0


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


def result_key(entry, versions: Optional[tuple]) -> Optional[tuple]:
    """The full Tier-C key, or None when this read is uncacheable
    (unversioned input, or a plan the plan cache flagged: table functions,
    writers)."""
    if versions is None or not getattr(entry, "cacheable_result", False):
        return None
    return (entry.result_key_base, versions)


def result_nbytes(result) -> int:
    """Bytes a QueryResult holds: each column's tensors (data, or an RLE
    run's value, and its mask) and its dictionary array, plus the batch's
    live mask.  No column is materialized to count it."""
    total = 0
    for col in result.batch.columns:
        total += col.tensor_nbytes
        if col.dictionary is not None:
            total += int(col.dictionary.nbytes)
    live = result.batch.live
    if live is not None:
        total += live.numel() * live.element_size()
    return total


def lookup(key: Optional[tuple]):
    global _HITS, _MISSES
    if key is None or not enabled():
        return None
    from ..telemetry import metrics as tm

    with _LOCK:
        hit = _ENTRIES.get(key)
        if hit is not None:
            _ENTRIES.move_to_end(key)
            _HITS += 1
        else:
            _MISSES += 1
    if hit is None:
        tm.CACHE_RESULT_MISSES.inc()
        return None
    tm.CACHE_RESULT_HITS.inc()
    from ..telemetry import profiler

    if profiler.enabled():
        profiler.instant("cache", "result_hit", rows=hit[0].batch.num_rows)
    return hit[0]


def store(key: Optional[tuple], result, tables: tuple) -> bool:
    global _BYTES, _EVICTIONS
    if key is None or not enabled():
        return False
    nbytes = result_nbytes(result)
    cap = capacity_bytes()
    if nbytes > cap // 4:
        return False
    from ..telemetry import metrics as tm

    with _LOCK:
        old = _ENTRIES.pop(key, None)
        if old is not None:
            _BYTES -= old[1]
        _ENTRIES[key] = (result, nbytes, tables)
        _BYTES += nbytes
        while _BYTES > cap and _ENTRIES:
            _, (_r, nb, _t) = _ENTRIES.popitem(last=False)
            _BYTES -= nb
            _EVICTIONS += 1
            tm.CACHE_RESULT_EVICTIONS.inc()
        tm.CACHE_RESULT_ENTRIES.set(len(_ENTRIES))
        tm.CACHE_RESULT_BYTES.set(_BYTES)
    return True


def invalidate_table(catalog_name: str, table: str) -> int:
    """Drop every entry that read (catalog_name, table) now.  The version
    vector already guarantees such entries are never served; this frees
    their bytes (device memory for a CUDA result) at mutation time instead
    of waiting for LRU pressure.  Connectors call it on every write."""
    global _BYTES, _INVALIDATIONS
    if not enabled():
        return 0
    from ..telemetry import metrics as tm

    dropped = 0
    with _LOCK:
        doomed = [k for k, (_r, _nb, tables) in _ENTRIES.items()
                  if any(c == catalog_name and t == table
                         for c, t in tables)]
        for k in doomed:
            _r, nb, _t = _ENTRIES.pop(k)
            _BYTES -= nb
            dropped += 1
        if dropped:
            _INVALIDATIONS += dropped
            tm.CACHE_RESULT_INVALIDATIONS.inc(dropped)
            tm.CACHE_RESULT_ENTRIES.set(len(_ENTRIES))
            tm.CACHE_RESULT_BYTES.set(_BYTES)
    return dropped


def stats() -> dict:
    with _LOCK:
        return {
            "tier": "result", "name": "result", "entries": len(_ENTRIES),
            "bytes": _BYTES, "hits": _HITS, "misses": _MISSES,
            "evictions": _EVICTIONS, "invalidations": _INVALIDATIONS,
        }


def reset_for_test() -> None:
    global _BYTES, _HITS, _MISSES, _EVICTIONS, _INVALIDATIONS
    with _LOCK:
        _ENTRIES.clear()
        _BYTES = 0
        _HITS = _MISSES = _EVICTIONS = _INVALIDATIONS = 0

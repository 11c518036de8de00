"""Tier A: the logical plan cache.

The port of the reference ``caching/plan_cache.py``.  Dashboard traffic
re-submits the same statement text many times; a hit skips parse ->
analyze -> plan -> optimize and goes straight from SQL text to a clone of
the optimized plan tree.

Key = ``flavor`` ⊕ SQL fingerprint (telemetry/runtime.py) ⊕ the exact
statement text (fingerprints fold case, which would merge ``'BUILDING'``
with ``'building'``) ⊕ the session properties that shape planning or
execution (:data:`SESSION_KEY_PROPS`) ⊕ the runner's *execution key* ⊕
the catalog's instance id and **generation** (connectors/catalog.py; it
bumps on every DDL / ANALYZE) ⊕ the history epoch.  Two departures from
the reference's key:

- in place of the reference's engine env knobs (``planning_env_key``)
  stands the runner's execution key, the arguments that select how a plan
  executes: ``optimizer``, ``encoded_exec``, the ``IngestConfig`` and the
  ``device`` (runner.py ``StandaloneQueryRunner.execution_key``).  A plan
  or result cached by a CPU runner never reaches a CUDA runner;
- the history epoch is the constant :data:`HISTORY_EPOCH` until
  history-based optimization (the reference's planner/history.py) is
  ported: no port path records plan statistics yet, so no history can
  shape a plan.

Hits hand out clones (:func:`clone`): plan nodes are frozen dataclasses
but may carry compare-excluded payloads (TupleDomain constraints), so one
tree is never shared between executions.  A clone shares any tensor it
finds instead of copying it: a cached plan never copies device memory.

``TRINO_TPU_PLAN_CACHE=0`` (checked per lookup) turns the tier off: every
statement re-plans.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import torch

from ..planner.plan import TableFunctionScan, TableScan, TableWriter
from ..spi import knobs

__all__ = [
    "PlanEntry", "lookup", "store", "clone", "scan_tables", "session_key",
    "enabled", "stats", "invalidate_all", "reset_for_test",
    "HISTORY_EPOCH",
]

# session properties that shape the logical plan or the execution layout
# (split counts change partial-aggregation order, hence float bits)
SESSION_KEY_PROPS = (
    "default_catalog", "splits_per_node", "node_count", "dynamic_filtering",
    "task_concurrency", "hbm_limit_bytes", "spill_to_disk_bytes",
    "use_collectives", "exchange_serde", "scale_writers",
    "writer_task_limit",
)

# the key's history slot: constant until history-based optimization lands
HISTORY_EPOCH = 0


def enabled() -> bool:
    return knobs.switched_on("TRINO_TPU_PLAN_CACHE")


def _max_entries() -> int:
    return knobs.get_int("TRINO_TPU_PLAN_CACHE_ENTRIES")


def session_key(session) -> tuple:
    return tuple(session.get(p) for p in SESSION_KEY_PROPS)


@dataclass
class PlanEntry:
    """One cached optimized plan + what the execution fast path needs
    without re-walking it: the scanned (catalog, table) set feeding the
    result cache's version vector, the key prefix the result cache keys
    on, and whether the plan's result may be cached at all."""

    plan: object
    tables: tuple
    result_key_base: tuple
    fingerprint: str
    cacheable_result: bool


_LOCK = threading.Lock()
_ENTRIES: OrderedDict = OrderedDict()
_HITS = 0
_MISSES = 0
_EVICTIONS = 0
_INVALIDATIONS = 0


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


def _result_cacheable(plan) -> bool:
    """Table functions have no version token and may make volatile data;
    writers change tables: plans holding either never enter the result
    tier."""
    def walk(node):
        if isinstance(node, (TableFunctionScan, TableWriter)):
            return False
        return all(walk(c) for c in node.children)

    return walk(plan)


def _has_writer(plan) -> bool:
    """Writer plans stay out of Tier A: the hit path re-checks SELECT
    access only, so a cached INSERT / CTAS would bypass the write-privilege
    check that guards the cold path."""
    def walk(node):
        if isinstance(node, TableWriter):
            return True
        return any(walk(c) for c in node.children)

    return walk(plan)


def _key(sql: str, session, catalog, flavor: str,
         execution_key: tuple) -> tuple:
    from ..telemetry.runtime import fingerprint

    # flavor partitions plan shapes (a distributed runner's trees carry
    # exchanges); the catalog instance id keeps runners with fresh catalogs
    # apart; the generation re-keys every plan after DDL / ANALYZE
    return (flavor, fingerprint(sql), sql.strip(), session_key(session),
            execution_key, catalog.instance_id, catalog.generation,
            HISTORY_EPOCH)


def lookup(sql: str, session, catalog, execution_key: tuple = (),
           flavor: str = "local") -> Optional[PlanEntry]:
    global _HITS, _MISSES
    if not enabled():
        return None
    key = _key(sql, session, catalog, flavor, execution_key)
    from ..telemetry import metrics as tm

    with _LOCK:
        entry = _ENTRIES.get(key)
        if entry is not None:
            _ENTRIES.move_to_end(key)
            _HITS += 1
        else:
            _MISSES += 1
    if entry is None:
        tm.CACHE_PLAN_MISSES.inc()
        return None
    tm.CACHE_PLAN_HITS.inc()
    from ..telemetry import profiler

    if profiler.enabled():
        profiler.instant("cache", "plan_hit", fingerprint=entry.fingerprint)
    return entry


def store(sql: str, session, catalog, plan, execution_key: tuple = (),
          flavor: str = "local") -> PlanEntry:
    """Build the entry of a freshly planned statement and (when the tier is
    on) publish it.  Always returns the entry: the execution fast path uses
    it even when caching is off."""
    global _EVICTIONS
    from ..telemetry.runtime import fingerprint

    key = _key(sql, session, catalog, flavor, execution_key)
    publish = enabled() and not _has_writer(plan)
    # the caller executes ``plan``: the cache holds a pristine copy
    entry = PlanEntry(
        plan=clone(plan) if publish else plan,
        tables=scan_tables(plan),
        # key[:-1] drops the history epoch; the catalog generation stays
        # in, as in the reference, so DDL re-keys cached results too (the
        # version vector alone guards their freshness)
        result_key_base=key[:-1],
        fingerprint=fingerprint(sql),
        cacheable_result=_result_cacheable(plan),
    )
    if not publish:
        return entry
    from ..telemetry import metrics as tm

    with _LOCK:
        _ENTRIES[key] = entry
        while len(_ENTRIES) > _max_entries():
            _ENTRIES.popitem(last=False)
            _EVICTIONS += 1
            tm.CACHE_PLAN_EVICTIONS.inc()
        tm.CACHE_PLAN_ENTRIES.set(len(_ENTRIES))
    return entry


def _share_tensors(obj, memo: dict, seen: set) -> None:
    """Enter every tensor reachable from ``obj`` into a deepcopy memo as
    itself, so :func:`clone` shares it instead of copying device memory."""
    if id(obj) in seen or isinstance(obj, (str, bytes, int, float, bool,
                                           type(None))):
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        memo[id(obj)] = obj
        return
    if isinstance(obj, (tuple, list, set, frozenset)):
        items = obj
    elif isinstance(obj, dict):
        items = list(obj.keys()) + list(obj.values())
    elif dataclasses.is_dataclass(obj):
        items = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    else:
        items = list(getattr(obj, "__dict__", {}).values())
        items += [getattr(obj, s) for s in getattr(type(obj), "__slots__", ())
                  if isinstance(s, str) and hasattr(obj, s)]
    for item in items:
        _share_tensors(item, memo, seen)


def clone(plan):
    """A private copy of a plan tree for one execution; tensors (if any
    node holds one) are shared, not copied."""
    memo: dict = {}
    _share_tensors(plan, memo, set())
    return copy.deepcopy(plan, memo)


def invalidate_all() -> None:
    global _INVALIDATIONS
    from ..telemetry import metrics as tm

    with _LOCK:
        n = len(_ENTRIES)
        _ENTRIES.clear()
        _INVALIDATIONS += n
        if n:
            tm.CACHE_PLAN_INVALIDATIONS.inc(n)
        tm.CACHE_PLAN_ENTRIES.set(0)


def stats() -> dict:
    with _LOCK:
        return {
            "tier": "plan", "name": "plan", "entries": len(_ENTRIES),
            "bytes": 0, "hits": _HITS, "misses": _MISSES,
            "evictions": _EVICTIONS, "invalidations": _INVALIDATIONS,
        }


def reset_for_test() -> None:
    global _HITS, _MISSES, _EVICTIONS, _INVALIDATIONS
    with _LOCK:
        _ENTRIES.clear()
        _HITS = _MISSES = _EVICTIONS = _INVALIDATIONS = 0

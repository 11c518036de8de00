"""The ``TRINO_TPU_*`` environment knobs the port reads.

The port's copy of the reference ``spi/knobs.py``: the same table of
declared knobs (name, type, default in its environment string form, one
line of doc) and the same typed accessors, which raise :class:`KeyError`
on an undeclared name.  Only the rows the port reads are declared: the
switches and sizes of the cache plane (caching/), the flight recorder's
level and ring (telemetry/profiler.py), the query journal
(telemetry/journal.py), the exchange's stall watchdog
(execution/task.py), the compiled stages' switches and sizes
(execution/stage_compiler.py, execution/plan_compiler.py), history-based
optimization (planner/history.py), the adaptive plane
(execution/adaptive.py, with the planner's broadcast row limit) and
fault-tolerant execution (the spool, its retention, the query-state log,
speculation and the cluster blacklist), the control plane (resource
groups, the cluster memory cap and its killer, per-query memory) and
worker processes (the internal secret, the drain budget).  Both
packages read the same variables, so one setting reaches both (a harness that sets ``TRINO_TPU_RESULT_CACHE=0``
turns the result tier off in each).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

__all__ = ["Knob", "KNOBS", "declared", "knob", "get_str", "get_int",
           "get_float", "get_bool"]


@dataclass(frozen=True)
class Knob:
    """One declared environment knob.  ``default`` is the *string* form as
    the environment would carry it ("" = unset, code-side fallback
    applies); ``type`` is one of ``str | int | float | bool | enum | json
    | path``."""

    name: str
    type: str
    default: str
    doc: str
    choices: Optional[tuple] = None


_DECLARATIONS = (
    Knob("TRINO_TPU_ADAPTIVE", "enum", "auto",
         "Adaptive query execution (runtime join-distribution switching, "
         "skew-aware repartitioning); 0 is bit-for-bit legacy.",
         choices=("auto", "1", "0")),
    Knob("TRINO_TPU_BLACKLIST_PATH", "path", "",
         "Shared durable cluster-blacklist file (append-only JSONL).  When "
         "set, every coordinator in the fleet appends its strikes here and "
         "merges peers' entries on read (TTL-decayed) instead of keeping "
         "process-local state; unset keeps the per-coordinator journal "
         "persistence."),
    Knob("TRINO_TPU_BLACKLIST_THRESHOLD", "float", "2",
         "Failure score at or above which a worker enters the cross-query "
         "cluster blacklist."),
    Knob("TRINO_TPU_BLACKLIST_TTL_S", "float", "300",
         "Cluster-blacklist entry TTL; scores decay to zero over this "
         "window."),
    Knob("TRINO_TPU_BROADCAST_ROW_LIMIT", "int", "2000000",
         "Static planner threshold: a join build side estimated at or "
         "below this many rows is broadcast instead of repartitioned."),
    Knob("TRINO_TPU_BROADCAST_THRESHOLD_BYTES", "int", "33554432",
         "Adaptive activation-barrier threshold: observed build bytes "
         "below this flip a repartitioned join to broadcast (and above, "
         "the reverse)."),
    Knob("TRINO_TPU_CLUSTER_MEMORY_BYTES", "int", "",
         "Cluster-wide reserved-memory cap enforced by the low-memory "
         "killer; unset disables the cap."),
    Knob("TRINO_TPU_DRAIN_TIMEOUT_S", "float", "300",
         "Graceful-drain budget: a SHUTTING_DOWN worker abandons "
         "unfinished tasks and exits with code 9 past this."),
    Knob("TRINO_TPU_EXCHANGE_STALL_S", "float", "1800",
         "Exchange take() stall watchdog: a source that produces nothing "
         "for this long fails the take with PAGE_TRANSPORT_TIMEOUT."),
    Knob("TRINO_TPU_EXEC_CACHE", "bool", "1",
         "Tier B executable-registry switch; 0 keeps each memo bounded "
         "but out of the registry and its counters."),
    Knob("TRINO_TPU_EXEC_CACHE_ENTRIES", "int", "256",
         "LRU capacity (entries) of each registered executable memo."),
    Knob("TRINO_TPU_EXEC_WARM", "bool", "1",
         "Replay exec_warm.json (journaled executable memo keys) on the "
         "worker boot path."),
    Knob("TRINO_TPU_FUSED_CAP", "int", "8192",
         "Fused-stage carried-state capacity (groups per task); overflow "
         "re-runs the query on the per-operator path."),
    Knob("TRINO_TPU_FUSED_STAGE", "enum", "auto",
         "Whole-stage compilation of PARTIAL->shuffle->FINAL seams; 0 is "
         "the per-operator and collective-exchange path.",
         choices=("auto", "1", "0")),
    Knob("TRINO_TPU_HBO", "enum", "auto",
         "History-based optimization: the cost model prefers journaled "
         "per-fingerprint observed stats (rows, build bytes, partial-agg "
         "groups) over estimate_rows, and queries record plan_stats at "
         "completion; 0 disables both sides bit-for-bit.",
         choices=("auto", "1", "0")),
    Knob("TRINO_TPU_HBO_ROWS_PER_TASK", "int", "250000",
         "History-driven task fan-out: observed fragment rows divided by "
         "this sets the task count (capped at the worker count) for "
         "fragments whose fingerprint has history."),
    Knob("TRINO_TPU_INTERNAL_SECRET", "str", "",
         "Shared secret authenticating intra-cluster HTTP "
         "(coordinator<->worker); auto-generated per cluster boot when "
         "unset."),
    Knob("TRINO_TPU_JOURNAL", "bool", "1",
         "Durable query journal (JSONL EventListener); 0 disables."),
    Knob("TRINO_TPU_JOURNAL_DIR", "path", "",
         "Journal directory; unset uses a per-uid tempdir."),
    Knob("TRINO_TPU_JOURNAL_FILES", "int", "3",
         "Rotated journal generations kept."),
    Knob("TRINO_TPU_JOURNAL_MAX_BYTES", "int", "4194304",
         "Journal rotate threshold per file."),
    Knob("TRINO_TPU_MESH_SHAPE", "str", "",
         "Mesh-shape override for resident-plan programs (\"8\" or "
         "\"2x4\"); the dimension product caps the mesh width a plan may "
         "claim.  Unset sizes the mesh from the stage task count."),
    Knob("TRINO_TPU_OOM_POLICY", "enum", "largest_query",
         "Victim selection policy for the cluster low-memory killer.",
         choices=("largest_query", "lowest_priority", "youngest")),
    Knob("TRINO_TPU_PLAN_CACHE", "bool", "1",
         "Tier A fingerprinted logical-plan cache; 0 disables (checked "
         "per lookup)."),
    Knob("TRINO_TPU_PLAN_CACHE_ENTRIES", "int", "256",
         "Plan-cache LRU capacity (entries)."),
    Knob("TRINO_TPU_PROFILE", "enum", "default",
         "Flight-recorder level: default is a clock read + tuple store "
         "with zero hot syncs; full brackets operators with a stream "
         "synchronize for true device time.",
         choices=("off", "default", "full")),
    Knob("TRINO_TPU_PROFILE_RING", "int", "4096",
         "Per-thread profiler event-ring capacity."),
    Knob("TRINO_TPU_QUERY_DEFAULT_MEMORY", "int", "67108864",
         "Admission fallback peak-memory estimate for queries with no "
         "journaled plan-fingerprint history."),
    Knob("TRINO_TPU_QUERY_MAX_MEMORY", "int", "0",
         "Per-query reserved-memory ceiling; exceeding it fails the query "
         "EXCEEDED_MEMORY_LIMIT.  0 = unlimited."),
    Knob("TRINO_TPU_QUERY_STATE", "bool", "1",
         "Write-ahead query-state log for retry_policy=TASK queries "
         "(coordinator crash recovery); 0 disables logging and recovery."),
    Knob("TRINO_TPU_QUERY_STATE_DIR", "path", "",
         "Query-state WAL directory; unset uses a per-uid tempdir next to "
         "the query journal."),
    Knob("TRINO_TPU_RESIDENT_MAX_FRAGMENTS", "int", "8",
         "Largest fragment count one resident-plan program may absorb; "
         "bigger coalesced subtrees stay on the fused or per-operator "
         "path."),
    Knob("TRINO_TPU_RESIDENT_PLAN", "enum", "auto",
         "Whole-query compilation (one program per maximal device-resident "
         "plan); 0 keeps the fused or per-operator path.",
         choices=("auto", "1", "0")),
    Knob("TRINO_TPU_RESOURCE_GROUPS", "json", "",
         "Hierarchical resource-group tree (weights, concurrency and "
         "queue limits, selectors) as JSON; unset uses one flat default "
         "group."),
    Knob("TRINO_TPU_RESULT_CACHE", "bool", "1",
         "Tier C versioned result cache; 0 disables (checked per "
         "lookup)."),
    Knob("TRINO_TPU_RESULT_CACHE_BYTES", "int", "67108864",
         "Result-cache LRU byte budget."),
    Knob("TRINO_TPU_SKEW_FACTOR", "float", "2.0",
         "Adaptive skew threshold: a join key heavier than this multiple "
         "of the mean partition weight is split across probe tasks."),
    Knob("TRINO_TPU_SPECULATION", "bool", "0",
         "Leaf-stage straggler speculation for retry_policy=QUERY "
         "streaming queries."),
    Knob("TRINO_TPU_SPECULATION_NONLEAF", "bool", "0",
         "Extend streaming straggler speculation to non-leaf stages by "
         "teeing producer pages into the durable spool (requires "
         "speculation on)."),
    Knob("TRINO_TPU_SPOOL_DIR", "path", "",
         "Base directory for durable FTE spool roots; unset uses the "
         "system tempdir."),
    Knob("TRINO_TPU_SPOOL_MAX_BYTES", "int", "1073741824",
         "Spool retention byte budget: the GC reclaims expired/leaked "
         "roots oldest-first once retained spools exceed this."),
    Knob("TRINO_TPU_SPOOL_TTL_S", "float", "3600",
         "Retention TTL for unreleased spool roots (crashed or abandoned "
         "queries); the boot sweep reclaims roots idle past this."),
)

KNOBS: dict = {k.name: k for k in _DECLARATIONS}

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def declared(name: str) -> bool:
    return name in KNOBS


def knob(name: str) -> Knob:
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(
            f"undeclared TRINO_TPU knob {name!r} — declare it in "
            f"trino_tpu_torch/spi/knobs.py") from None


def get_str(name: str) -> str:
    k = knob(name)
    return os.environ.get(k.name, k.default)


def is_set(name: str) -> bool:
    """Whether the variable is set to a non-empty value (the declared
    default does not count)."""
    return bool(os.environ.get(knob(name).name, "").strip())


def get_int(name: str) -> Optional[int]:
    raw = get_str(name).strip()
    return int(raw) if raw else None


def get_float(name: str) -> Optional[float]:
    raw = get_str(name).strip()
    return float(raw) if raw else None


def get_bool(name: str) -> bool:
    raw = get_str(name).strip().lower()
    if raw in _FALSE or raw == "":
        return False
    return raw in _TRUE or raw not in _FALSE


def switched_on(name: str) -> bool:
    """A kill switch as the caching and journal modules read it: on unless
    the variable says 0 / off / false / no (an empty value is on)."""
    return get_str(name).strip().lower() not in _FALSE

"""Multi-tenant serving plane: weighted-fair resource groups + cluster
memory manager with a low-memory killer.

The port of the reference ``execution/resource_manager.py``; the
admission and killer logic is host-only and the reference's, line for
line, so the same scripted sequence gives the same orders, victims and
error codes in both packages.  Reservations are the port's device-pool
bytes: ``spi/memory.MemoryPool`` (``reserved + reserved_revocable``) for
in-process tasks, and ``memory_reserved_bytes`` from a worker's
``/v1/status`` JSON (execution/worker.py) for tasks in worker processes.

The L1 layer below everything else — what one tenant may do to the cluster:

- :class:`ResourceGroup` — hierarchical admission with per-group
  ``soft/hard_concurrency_limit``, ``max_queued``, ``weight``,
  ``scheduling_policy in {fair, weighted_fair, query_priority}``,
  ``soft_memory_limit_bytes`` and CPU quotas with periodic regeneration
  (reference: execution/resourcegroups/InternalResourceGroup.java:75 —
  canRunMore/canQueueMore, internalRefreshStats, the scheduling policy
  queues).  This class REPLACES the flat group previously defined in
  control.py behind the same acquire/release surface; control.py re-exports
  it so every existing import keeps working.
- :class:`ClusterMemoryManager` — the coordinator-side aggregation of every
  query memory pool (in-process :class:`~..spi.memory.MemoryPool` refs plus
  worker reservations shipped in the /v1/status JSON), per-query
  ``max_memory`` enforcement and a pluggable low-memory killer
  (``largest_query`` / ``lowest_priority`` / ``youngest``) that fails the
  victim with CLUSTER_OUT_OF_MEMORY through the spi/errors.py taxonomy
  (reference: memory/ClusterMemoryManager.java:90 + LowMemoryKiller).
- :func:`estimate_peak_memory` — memory-aware admission input: the peak of
  recent finished runs of the same plan fingerprint
  (telemetry/runtime.py query records), falling back to a configured
  default.

Config: ``TRINO_TPU_RESOURCE_GROUPS`` holds a JSON group tree + selector
rules (see :func:`build_group_tree`); ``TRINO_TPU_CLUSTER_MEMORY_BYTES``
caps the coordinator's cluster memory view (unset = uncapped);
``TRINO_TPU_OOM_POLICY`` picks the victim policy;
``TRINO_TPU_QUERY_MAX_MEMORY`` bounds any single query's reservation.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
import weakref
from typing import Callable, Optional

from ..spi import knobs
from ..spi.errors import (
    CLUSTER_OUT_OF_MEMORY,
    EXCEEDED_GLOBAL_MEMORY_LIMIT,
    QUERY_QUEUE_FULL,
    QUERY_QUEUED_TIMEOUT,
    TrinoError,
)

__all__ = [
    "ResourceGroup", "ClusterMemoryManager", "QueryMemoryHandle",
    "build_group_tree", "build_dispatch_manager", "find_group",
    "estimate_peak_memory", "OOM_POLICIES",
]

SCHEDULING_POLICIES = ("fair", "weighted_fair", "query_priority")
OOM_POLICIES = ("largest_query", "lowest_priority", "youngest")


class _Ticket:
    __slots__ = ("seq", "priority", "group", "event")

    def __init__(self, seq: int, priority: int, group: "ResourceGroup"):
        self.seq = seq
        self.priority = priority
        self.group = group
        self.event = threading.Event()


class ResourceGroup:
    """Hierarchical admission: a query runs when every ancestor has a free
    concurrency slot; otherwise it queues up to ``max_queued``.

    Scheduling policy decides which queued query a freed slot goes to —
    ``fair`` is global FIFO (the pre-existing behavior), ``weighted_fair``
    admits from the eligible child subtree with the lowest running/weight
    ratio, ``query_priority`` admits the highest-priority ticket.  A group
    above its ``soft_concurrency_limit`` only wins a slot when no sibling
    below its own soft limit wants it.  ``soft_memory_limit_bytes`` blocks
    NEW admissions while the group's aggregated reservation (pushed by the
    ClusterMemoryManager) sits above the limit; running queries are never
    interrupted here — that is the OOM killer's job.  CPU quotas regenerate
    at ``cpu_quota_generation_s_per_s``: usage above ``soft_cpu_limit_s``
    scales the concurrency limit down linearly, usage at
    ``hard_cpu_limit_s`` stops admissions entirely
    (reference: InternalResourceGroup updateGroupsAndProcessQueuedQueries +
    internalGenerateCpuQuota)."""

    def __init__(self, name: str, hard_concurrency_limit: int = 100,
                 max_queued: int = 1000,
                 parent: Optional["ResourceGroup"] = None,
                 soft_concurrency_limit: Optional[int] = None,
                 weight: int = 1,
                 scheduling_policy: str = "fair",
                 soft_memory_limit_bytes: Optional[int] = None,
                 soft_cpu_limit_s: Optional[float] = None,
                 hard_cpu_limit_s: Optional[float] = None,
                 cpu_quota_generation_s_per_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None):
        if scheduling_policy not in SCHEDULING_POLICIES:
            raise ValueError(
                f"scheduling_policy {scheduling_policy!r} not in "
                f"{SCHEDULING_POLICIES}")
        self.name = name
        self.hard_concurrency_limit = hard_concurrency_limit
        self.soft_concurrency_limit = soft_concurrency_limit
        self.max_queued = max_queued
        self.weight = max(1, int(weight))
        self.scheduling_policy = scheduling_policy
        self.soft_memory_limit_bytes = soft_memory_limit_bytes
        self.soft_cpu_limit_s = soft_cpu_limit_s
        self.hard_cpu_limit_s = hard_cpu_limit_s
        self.cpu_quota_generation_s_per_s = cpu_quota_generation_s_per_s
        self.parent = parent
        self.children: dict[str, ResourceGroup] = {}
        self._running = 0          # subtree total (every ancestor counts)
        self._running_direct = 0   # queries admitted AT this group
        self._queue: list[_Ticket] = []
        self._memory_usage_bytes = 0
        self._cpu_usage_s = 0.0
        self._lock = parent._lock if parent is not None else threading.Lock()
        self._clock = clock or (parent._clock if parent is not None
                                else time.monotonic)
        self._last_regen = self._clock()
        if parent is None:
            self._seq = itertools.count()
        self._gauges = None  # lazy (running, queued) gauge pair

    # ------------------------------------------------------------- structure
    def subgroup(self, name: str, **kwargs) -> "ResourceGroup":
        with self._lock:  # admission walks children under the lock
            if name not in self.children:
                self.children[name] = ResourceGroup(
                    f"{self.name}.{name}", parent=self, **kwargs)
            return self.children[name]

    @property
    def root(self) -> "ResourceGroup":
        g = self
        while g.parent is not None:
            g = g.parent
        return g

    def walk(self) -> list["ResourceGroup"]:
        out = [self]
        for c in self.children.values():
            out.extend(c.walk())
        return out

    # ------------------------------------------------------------- admission
    def _regen_cpu(self) -> None:
        rate = self.cpu_quota_generation_s_per_s
        now = self._clock()
        if rate:
            dt = now - self._last_regen
            if dt > 0:
                self._cpu_usage_s = max(0.0, self._cpu_usage_s - dt * rate)
        self._last_regen = now

    def _effective_concurrency_limit(self) -> int:
        """Hard limit, scaled down linearly while CPU usage sits between the
        soft and hard CPU quotas (the reference's penalty curve)."""
        limit = self.hard_concurrency_limit
        soft, hard = self.soft_cpu_limit_s, self.hard_cpu_limit_s
        if (soft is not None and hard is not None and hard > soft
                and self._cpu_usage_s > soft):
            over = (self._cpu_usage_s - soft) / (hard - soft)
            limit = int(limit * max(0.0, 1.0 - over))
        return limit

    def _can_admit(self) -> bool:
        """One NEW admission allowed at THIS group right now (lock held)."""
        self._regen_cpu()
        if (self.hard_cpu_limit_s is not None
                and self._cpu_usage_s >= self.hard_cpu_limit_s):
            return False
        if (self.soft_memory_limit_bytes is not None
                and self._memory_usage_bytes >= self.soft_memory_limit_bytes):
            return False
        return self._running < self._effective_concurrency_limit()

    def _can_run(self) -> bool:
        g: Optional[ResourceGroup] = self
        while g is not None:
            if not g._can_admit():
                return False
            g = g.parent
        return True

    def _acquire_now(self) -> None:
        self._running_direct += 1
        g: Optional[ResourceGroup] = self
        while g is not None:
            g._running += 1
            g = g.parent
        self._update_gauges()

    def acquire(self, timeout: float = 300.0, priority: int = 0) -> None:
        """Block until admitted.  Raises a classified USER TrinoError when
        the queue is full (QUERY_QUEUE_FULL) or the wait expires
        (QUERY_QUEUED_TIMEOUT) — admission rejections re-fail identically,
        so the retry machinery must never re-run them."""
        with self._lock:
            if self._can_run() and not self._queue:
                self._acquire_now()
                return
            if len(self._queue) >= self.max_queued:
                raise TrinoError(
                    QUERY_QUEUE_FULL,
                    f"resource group {self.name}: queue full "
                    f"({self.max_queued})")
            ticket = _Ticket(next(self.root._seq), priority, self)
            self._queue.append(ticket)
            self._update_gauges()
        if not ticket.event.wait(timeout):
            with self._lock:
                if not ticket.event.is_set():  # lost the admit race: timeout
                    if ticket in self._queue:
                        self._queue.remove(ticket)
                    self._update_gauges()
                    raise TrinoError(
                        QUERY_QUEUED_TIMEOUT,
                        f"resource group {self.name}: queued for {timeout}s")
        # admitted by release()/refresh()

    def release(self, cpu_s: float = 0.0) -> None:
        with self._lock:
            self._running_direct -= 1
            g: Optional[ResourceGroup] = self
            while g is not None:
                g._running -= 1
                if cpu_s:
                    g._cpu_usage_s += cpu_s
                g = g.parent
            self._update_gauges()
            self._dispatch_queued()

    def refresh(self) -> None:
        """Re-run queued dispatch: wakes queries a regenerated CPU quota or
        a dropped memory reservation has unblocked (release() is the usual
        trigger, but quota/memory headroom can appear without one)."""
        with self._lock:
            self._dispatch_queued()

    def set_memory_usage(self, nbytes: int) -> None:
        """Aggregated reservation of this group's member queries, pushed by
        the ClusterMemoryManager; dropping below the soft limit re-opens
        admission."""
        with self._lock:
            before = self._memory_usage_bytes
            self._memory_usage_bytes = int(nbytes)
            if nbytes < before:
                self._dispatch_queued()

    # ------------------------------------------------------------ scheduling
    def _queue_head(self) -> Optional[_Ticket]:
        if not self._queue:
            return None
        if self.scheduling_policy == "query_priority":
            return min(self._queue, key=lambda t: (-t.priority, t.seq))
        return self._queue[0]  # FIFO (fair/weighted_fair own-queue order)

    def _has_demand(self) -> bool:
        if self._queue:
            return True
        return any(c._has_demand() for c in self.children.values())

    def _next_ticket(self) -> Optional[_Ticket]:
        """The next admissible ticket in this subtree under this group's
        policy, or None (lock held).  Each level picks among its own queue
        head and its children's winners; the recursion already verified the
        winner's whole ancestor chain below this level."""
        if not self._can_admit():
            return None
        cands: list[tuple[ResourceGroup, _Ticket]] = []
        head = self._queue_head()
        if head is not None:
            cands.append((self, head))
        for c in self.children.values():
            if not c._has_demand():
                continue
            t = c._next_ticket()
            if t is not None:
                cands.append((c, t))
        if not cands:
            return None
        # soft concurrency: a group at/over its soft limit only wins when no
        # candidate below its soft limit is waiting
        def above_soft(g: ResourceGroup) -> bool:
            return (g.soft_concurrency_limit is not None
                    and g._running >= g.soft_concurrency_limit)

        soft_ok = [c for c in cands if not above_soft(c[0])]
        pool = soft_ok or cands
        if self.scheduling_policy == "weighted_fair":
            # least served relative to weight; for own-queue tickets the
            # "subtree" is the queries admitted directly at this group
            def key(c):
                g, t = c
                running = (g._running_direct if g is self else g._running)
                return (running / g.weight, t.seq)
        elif self.scheduling_policy == "query_priority":
            def key(c):
                return (-c[1].priority, c[1].seq)
        else:  # fair: global FIFO across the subtree
            def key(c):
                return c[1].seq
        return min(pool, key=key)[1]

    def _dispatch_queued(self) -> None:
        root = self.root
        while True:
            t = root._next_ticket()
            if t is None:
                return
            g = t.group
            g._queue.remove(t)
            g._acquire_now()
            t.event.set()

    # ---------------------------------------------------------- observability
    @property
    def running(self) -> int:
        with self._lock:
            return self._running

    @property
    def queued(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def queued_total(self) -> int:
        with self._lock:
            return sum(len(g._queue) for g in self.walk())

    @property
    def memory_usage_bytes(self) -> int:
        with self._lock:
            return self._memory_usage_bytes

    @property
    def cpu_usage_s(self) -> float:
        with self._lock:
            self._regen_cpu()
            return self._cpu_usage_s

    def _update_gauges(self) -> None:
        # per-group gauges (dynamic names; registered on first touch)
        if self._gauges is None:
            from ..telemetry.metrics import resource_group_gauges

            self._gauges = resource_group_gauges(self.name)
        run_g, que_g = self._gauges
        run_g.set(self._running)
        que_g.set(len(self._queue))


# ---------------------------------------------------------------------------
# config-driven group trees + dispatch manager construction

_GROUP_KWARGS = (
    "hard_concurrency_limit", "soft_concurrency_limit", "max_queued",
    "weight", "scheduling_policy", "soft_memory_limit_bytes",
    "soft_cpu_limit_s", "hard_cpu_limit_s", "cpu_quota_generation_s_per_s",
)


def _build_group(spec: dict, parent: Optional[ResourceGroup],
                 clock) -> ResourceGroup:
    kwargs = {k: spec[k] for k in _GROUP_KWARGS if k in spec}
    name = spec.get("name", "global")
    if parent is None:
        g = ResourceGroup(name, clock=clock, **kwargs)
    else:
        g = parent.subgroup(name, **kwargs)
    for sub in spec.get("subgroups", ()):
        _build_group(sub, g, clock)
    return g


def build_group_tree(spec, clock=None):
    """``spec`` is the TRINO_TPU_RESOURCE_GROUPS payload: either a bare
    group dict (the root) or ``{"root": {...}, "selectors": [...]}`` where
    selectors are spi/session.py rule dicts mapping (user, source, sql) to a
    dotted group path.  Returns (root_group, selector_callable_or_None)."""
    if isinstance(spec, str):
        spec = json.loads(spec)
    root_spec = spec.get("root", spec)
    root = _build_group(root_spec, None, clock)
    selector = None
    rules = spec.get("selectors")
    if rules:
        from ..spi.session import GroupSelector

        selector = GroupSelector.from_spec(rules).select
    return root, selector


def build_dispatch_manager(session):
    """The runner's admission plane: the TRINO_TPU_RESOURCE_GROUPS tree when
    configured, else the flat global group sized from the session knobs
    (exactly the pre-existing behavior)."""
    from .control import DispatchManager

    spec = knobs.get_str("TRINO_TPU_RESOURCE_GROUPS")
    if spec:
        root, selector = build_group_tree(spec)
        return DispatchManager(root, selector)
    return DispatchManager(ResourceGroup(
        "global",
        hard_concurrency_limit=session.get("query_concurrency"),
        max_queued=session.get("query_max_queued")))


def find_group(root: Optional[ResourceGroup],
               path: str) -> Optional[ResourceGroup]:
    """Resolve a full dotted group name (``global.etl``) in a tree."""
    if root is None or not path:
        return None
    for g in root.walk():
        if g.name == path:
            return g
    return None


# ---------------------------------------------------------------------------
# memory-aware admission: history-based peak estimation


def estimate_peak_memory(fingerprint: str, default_bytes: int,
                         history: int = 5) -> int:
    """Estimated peak for a plan fingerprint: the max peak of its most
    recent finished runs (telemetry/runtime.py records), else the default.
    The max (not mean) keeps admission conservative — letting one query in
    on an optimistic estimate is how clusters OOM."""
    from ..telemetry import runtime as rt

    peaks = [q.peak_memory_bytes for q in rt.queries()
             if q.fingerprint == fingerprint and q.state == "FINISHED"
             and q.peak_memory_bytes > 0]
    if peaks:
        return max(peaks[-history:])
    # no in-memory history (fresh coordinator): the durable query journal
    # seeds the estimate across restarts (telemetry/journal.py)
    try:
        from ..telemetry import journal as tj

        seeded = tj.seeded_peak(fingerprint, history)
        if seeded > 0:
            return seeded
    # journal trouble never blocks admission
    except Exception:  # noqa: BLE001
        pass
    return default_bytes


# ---------------------------------------------------------------------------
# cluster memory manager + low-memory killer


class QueryMemoryHandle:
    """One registered query's view of the killer: ``poll()`` runs a
    rate-limited enforcement pass and returns the kill error once this query
    was chosen as a victim (the coordinator drain loops raise it)."""

    def __init__(self, manager: "ClusterMemoryManager", query_id: str,
                 priority: int, create_seq: int,
                 group: Optional[ResourceGroup] = None,
                 max_memory: Optional[int] = None):
        self._manager = manager
        self.query_id = query_id
        self.priority = priority
        self.create_seq = create_seq
        self.group = group
        self.max_memory = max_memory
        self._error: Optional[TrinoError] = None
        self._killed = threading.Event()

    @property
    def killed(self) -> bool:
        return self._killed.is_set()

    def kill(self, error: TrinoError) -> None:
        self._error = error
        self._killed.set()

    def killed_error(self) -> Optional[TrinoError]:
        return self._error if self._killed.is_set() else None

    def poll(self) -> Optional[TrinoError]:
        self._manager.maybe_enforce()
        return self.killed_error()

    def check(self) -> None:
        err = self.poll()
        if err is not None:
            raise err


class ClusterMemoryManager:
    """Coordinator-side cluster memory view + low-memory killer.

    Reservations come from two planes: in-process MemoryPool refs registered
    per query (held weakly — a pool dropping with its finished task leaves
    the books automatically) and per-worker snapshots parsed out of the
    /v1/status JSON the failure detector already sweeps.  ``enforce()``
    refreshes the cluster gauges, pushes per-group usage into the resource
    group tree, kills any query over its ``max_memory``, and — when total
    reservation exceeds ``capacity_bytes`` — kills victims under
    ``oom_policy`` until the projection fits
    (reference: ClusterMemoryManager.process:~200 + LowMemoryKiller
    implementations TotalReservationLowMemoryKiller et al.)."""

    def __init__(self, capacity_bytes: Optional[int] = None,
                 oom_policy: Optional[str] = None,
                 enforce_interval_s: float = 0.05,
                 clock: Callable[[], float] = time.monotonic):
        if capacity_bytes is None:
            capacity_bytes = knobs.get_int("TRINO_TPU_CLUSTER_MEMORY_BYTES")
        self.capacity_bytes = capacity_bytes
        policy = oom_policy or knobs.get_str("TRINO_TPU_OOM_POLICY")
        if policy not in OOM_POLICIES:
            raise ValueError(f"oom_policy {policy!r} not in {OOM_POLICIES}")
        self.oom_policy = policy
        self.enforce_interval_s = enforce_interval_s
        self._clock = clock
        self._lock = threading.Lock()
        self._pools: dict[str, list] = {}       # qid -> [weakref to pool]
        self._workers: dict[str, dict[str, int]] = {}  # node -> qid -> bytes
        self._handles: dict[str, QueryMemoryHandle] = {}
        self._groups_seen: set = set()
        self._seq = itertools.count()
        self._last_enforce = 0.0
        self.oom_kills = 0

    # ---------------------------------------------------------- registration
    def register_query(self, query_id: str, priority: int = 0,
                       group: Optional[ResourceGroup] = None,
                       max_memory: Optional[int] = None) -> QueryMemoryHandle:
        h = QueryMemoryHandle(self, query_id, priority, next(self._seq),
                              group, max_memory)
        with self._lock:
            self._handles[query_id] = h
        return h

    def unregister_query(self, query_id: str) -> None:
        with self._lock:
            self._handles.pop(query_id, None)
            self._pools.pop(query_id, None)
            for per_node in self._workers.values():
                per_node.pop(query_id, None)

    def register_pool(self, query_id: str, pool) -> None:
        """Track an in-process MemoryPool under a query (weakly: the pool
        leaves the accounting when its task drops it)."""
        ref = weakref.ref(pool)
        with self._lock:
            self._pools.setdefault(query_id, []).append(ref)

    def update_worker(self, node_id: str, status_json: dict) -> None:
        """Fold one /v1/status payload: per-task ``query_id`` +
        ``memory_reserved_bytes`` (worker.py ships both).  The snapshot
        replaces the node's previous view wholesale, so finished tasks age
        out with the next sweep."""
        per_query: dict[str, int] = {}
        for st in (status_json or {}).get("tasks", {}).values():
            qid = st.get("query_id")
            nbytes = int(st.get("memory_reserved_bytes", 0) or 0)
            if qid and nbytes:
                per_query[qid] = per_query.get(qid, 0) + nbytes
        with self._lock:
            self._workers[node_id] = per_query

    def forget_worker(self, node_id: str) -> None:
        with self._lock:
            self._workers.pop(node_id, None)

    # ------------------------------------------------------------ accounting
    def reserved_by_query(self) -> dict[str, int]:
        with self._lock:
            out: dict[str, int] = {}
            for qid, refs in self._pools.items():
                live = [r for r in refs if r() is not None]
                self._pools[qid] = live
                total = 0
                for r in live:
                    p = r()
                    if p is not None:
                        total += int(p.reserved + p.reserved_revocable)
                if total:
                    out[qid] = out.get(qid, 0) + total
            for per_node in self._workers.values():
                for qid, nbytes in per_node.items():
                    out[qid] = out.get(qid, 0) + nbytes
            return out

    def cluster_reserved_bytes(self) -> int:
        return sum(self.reserved_by_query().values())

    def cluster_free_bytes(self) -> float:
        if self.capacity_bytes is None:
            return float("inf")
        return self.capacity_bytes - self.cluster_reserved_bytes()

    def can_admit(self, estimated_bytes: int) -> bool:
        """Memory-aware admission: room for the estimate on top of current
        reservations?  Uncapped clusters always admit."""
        if self.capacity_bytes is None:
            return True
        return self.cluster_free_bytes() >= estimated_bytes

    # ------------------------------------------------------------- the killer
    def maybe_enforce(self) -> list[str]:
        now = self._clock()
        if now - self._last_enforce < self.enforce_interval_s:
            return []
        self._last_enforce = now
        return self.enforce()

    def _victim_order(self, handles: list[QueryMemoryHandle],
                      usage: dict[str, int]) -> list[QueryMemoryHandle]:
        if self.oom_policy == "lowest_priority":
            return sorted(handles, key=lambda h: (
                h.priority, -usage.get(h.query_id, 0)))
        if self.oom_policy == "youngest":
            return sorted(handles, key=lambda h: -h.create_seq)
        return sorted(handles, key=lambda h: -usage.get(h.query_id, 0))

    def enforce(self) -> list[str]:
        """One enforcement pass; returns the query ids killed this round."""
        from ..telemetry import metrics as tm

        usage = self.reserved_by_query()
        total = sum(usage.values())
        tm.CLUSTER_MEMORY_RESERVED.set(total)
        if self.capacity_bytes is not None:
            tm.CLUSTER_MEMORY_FREE.set(max(0, self.capacity_bytes - total))
        with self._lock:
            handles = list(self._handles.values())
        # per-group roll-up into the admission tree (soft_memory_limit)
        group_usage: dict[ResourceGroup, int] = {}
        for h in handles:
            nbytes = usage.get(h.query_id, 0)
            g = h.group
            while g is not None:
                group_usage[g] = group_usage.get(g, 0) + nbytes
                g = g.parent
        for g in self._groups_seen - set(group_usage):
            g.set_memory_usage(0)
        for g, nbytes in group_usage.items():
            g.set_memory_usage(nbytes)
        self._groups_seen = set(group_usage)

        killed: list[str] = []
        # per-query max_memory (reference: query.max-memory enforcement)
        for h in handles:
            if (h.max_memory and not h.killed
                    and usage.get(h.query_id, 0) > h.max_memory):
                h.kill(TrinoError(
                    EXCEEDED_GLOBAL_MEMORY_LIMIT,
                    f"query {h.query_id} reserved "
                    f"{usage.get(h.query_id, 0)} bytes, max_memory "
                    f"{h.max_memory}"))
                killed.append(h.query_id)
        # cluster low-memory killer
        if self.capacity_bytes is not None and total > self.capacity_bytes:
            victims = self._victim_order(
                [h for h in handles if not h.killed], usage)
            for h in victims:
                if total <= self.capacity_bytes:
                    break
                nbytes = usage.get(h.query_id, 0)
                if nbytes <= 0:
                    continue  # killing a zero-reservation query frees nothing
                h.kill(TrinoError(
                    CLUSTER_OUT_OF_MEMORY,
                    f"cluster reserved {total} of {self.capacity_bytes} "
                    f"bytes; killed {h.query_id} ({nbytes} bytes, policy "
                    f"{self.oom_policy})"))
                total -= nbytes
                self.oom_kills += 1
                tm.OOM_KILLS.inc()
                killed.append(h.query_id)
        return killed

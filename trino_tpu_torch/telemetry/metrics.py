"""Process-wide metrics registry with Prometheus text exposition.

The port of the reference ``telemetry/metrics.py`` (the airlift
``CounterStat`` / ``TimeStat`` / ``DistributionStat`` role): a singleton
:data:`REGISTRY` of named metrics, rendered as Prometheus text exposition
format and read back in SQL through ``system.metrics.counters``
(connectors/system.py).  The classes, the text format and the snapshot
shape are the reference's, so one recorded sequence renders byte for byte
the same in both packages.

Hot-path contract: *recording never takes a device sync or a contended
lock*.  Counters and distributions write to per-thread cells; the only
lock is taken once per (thread, metric) pair at cell creation, and again
only at snapshot / render time to sum the cells.  Gauges are a single
attribute store.  Nothing here touches a tensor, so the host-sync
accounting of exec/syncguard.py is unaffected.

Distributions use fixed log-spaced buckets (``lo * growth**i``), merge by
bucket-count addition (across threads and, via
:meth:`Distribution.merge`, across processes), and estimate p50 / p90 /
p99 by linear interpolation inside the winning bucket.

Naming (checked at registration, and by the reference's
tools/lint_metric_names.py over this file): Prometheus-legal
``[a-zA-Z_:][a-zA-Z0-9_:]*``, mandatory ``trino_`` prefix, counters end in
``_total``, distributions carry a unit suffix (``_seconds``).

The families registered here are those a single-node run records: scan
ingest, host syncs and the padded expand, compressed execution, the query
lifecycle, the iterative optimizer, the device memory watermark, the
flight recorder (profiler and journal), the three cache tiers, the
compiled stages (fused seams and resident plans), resilience (query
retry, speculation, the cluster blacklist), fault-tolerant execution,
the adaptive plane, HBO, the control plane (admission, resource groups,
the cluster memory view and its killer), the serving path (the HTTP
dispatcher and exchange) and the HA coordinator fleet (leases,
takeovers, front-tier reroutes, autoscaler actions).
"""

from __future__ import annotations

import bisect
import copy
import re
import threading
import weakref
from typing import Optional

__all__ = [
    "Counter", "Gauge", "Distribution", "MetricsRegistry", "REGISTRY",
    "observe_scan", "observe_sync", "observe_encoding", "observe_fused",
    "observe_resident", "observe_resilience", "observe_adaptive",
    "observe_exchange", "resource_group_gauges",
    "update_device_memory_watermark", "merge_snapshot",
    "render_snapshot_prometheus", "render_cluster",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
METRIC_PREFIX = "trino_"


def _validate_name(name: str, kind: str) -> None:
    if not _NAME_RE.match(name):
        raise ValueError(f"metric name not Prometheus-legal: {name!r}")
    if not name.startswith(METRIC_PREFIX):
        raise ValueError(
            f"metric name missing the {METRIC_PREFIX!r} prefix: {name!r}")
    if kind == "counter" and not name.endswith("_total"):
        raise ValueError(f"counter name must end in '_total': {name!r}")


def _fmt(v) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.10g}"


class _Cell:
    """One thread's private accumulator; folded into a retired total once
    the owning thread dies (driver and prefetch threads are per-query, so
    cells must not accumulate over the process lifetime)."""

    __slots__ = ("value", "thread_ref")

    def __init__(self):
        self.value = 0
        self.thread_ref = weakref.ref(threading.current_thread())


class Counter:
    """Monotonic counter; ``inc`` is a thread-local add (no contended lock,
    no device sync)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._local = threading.local()
        self._cells: list[_Cell] = []
        self._retired = 0
        self._lock = threading.Lock()

    def inc(self, amount=1) -> None:
        cell = getattr(self._local, "cell", None)
        if cell is None:
            cell = _Cell()
            with self._lock:
                self._cells.append(cell)
            self._local.cell = cell
        cell.value += amount

    def value(self):
        with self._lock:
            live = []
            for c in self._cells:
                t = c.thread_ref()
                if t is None or not t.is_alive():
                    self._retired += c.value  # dead thread: fold and drop
                else:
                    live.append(c)
            self._cells = live
            return self._retired + sum(c.value for c in live)

    def snapshot(self) -> dict:
        return {"kind": "counter", "value": self.value()}

    def render(self) -> list[str]:
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} counter",
                f"{self.name} {_fmt(self.value())}"]


class Gauge:
    """Last-write-wins instantaneous value; ``set`` is one attribute store
    (atomic under the interpreter lock)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def set(self, value) -> None:
        self._value = value

    def value(self):
        return self._value

    def snapshot(self) -> dict:
        return {"kind": "gauge", "value": self._value}

    def render(self) -> list[str]:
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} gauge",
                f"{self.name} {_fmt(self._value)}"]


class _DistCell:
    __slots__ = ("buckets", "sum", "count", "min", "max", "thread_ref")

    def __init__(self, nbuckets: int):
        self.buckets = [0] * (nbuckets + 1)  # +1: the +Inf overflow bucket
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")
        self.thread_ref = weakref.ref(threading.current_thread())


class Distribution:
    """Mergeable fixed-bucket histogram with log-spaced bounds
    (``lo * growth**i`` for i in [0, buckets)) and interpolated
    p50 / p90 / p99 estimates; rendered as a Prometheus histogram.

    ``record`` increments a per-thread bucket array via ``bisect`` (no
    lock, no device sync).  ``merge`` folds a foreign ``snapshot()`` dict
    (same bounds) into this instance."""

    kind = "distribution"

    def __init__(self, name: str, help: str = "", lo: float = 1e-4,
                 growth: float = 2.0, buckets: int = 30):
        self.name = name
        self.help = help
        self.bounds = [lo * growth ** i for i in range(buckets)]
        self._local = threading.local()
        self._cells: list[_DistCell] = []
        self._merged: Optional[_DistCell] = None  # folded cells and merges
        self._lock = threading.Lock()

    def record(self, value) -> None:
        cell = getattr(self._local, "cell", None)
        if cell is None:
            cell = _DistCell(len(self.bounds))
            with self._lock:
                self._cells.append(cell)
            self._local.cell = cell
        cell.buckets[bisect.bisect_left(self.bounds, value)] += 1
        cell.sum += value
        cell.count += 1
        if value < cell.min:
            cell.min = value
        if value > cell.max:
            cell.max = value

    @staticmethod
    def _fold(into: _DistCell, cell) -> None:
        for i, n in enumerate(cell.buckets):
            into.buckets[i] += n
        into.sum += cell.sum
        into.count += cell.count
        into.min = min(into.min, cell.min)
        into.max = max(into.max, cell.max)

    def _total(self) -> _DistCell:
        total = _DistCell(len(self.bounds))
        with self._lock:
            if self._merged is not None:
                self._fold(total, self._merged)
            live = []
            for c in self._cells:
                t = c.thread_ref()
                if t is None or not t.is_alive():
                    if self._merged is None:
                        self._merged = _DistCell(len(self.bounds))
                    self._fold(self._merged, c)
                else:
                    live.append(c)
                self._fold(total, c)
            self._cells = live
        return total

    def _quantile(self, total: _DistCell, q: float) -> float:
        if total.count == 0:
            return 0.0
        target = q * total.count
        cum = 0
        for i, n in enumerate(total.buckets):
            if n == 0:
                continue
            if cum + n >= target:
                lower = self.bounds[i - 1] if i > 0 else 0.0
                upper = self.bounds[i] if i < len(self.bounds) else total.max
                upper = max(upper, lower)
                frac = (target - cum) / n
                # interpolation can overshoot the largest observed value,
                # which sits somewhere inside the bucket
                return min(lower + (upper - lower) * frac, total.max)
            cum += n
        return total.max

    def merge(self, snap: dict) -> None:
        """Fold a foreign ``snapshot()`` (same bucket bounds) into this
        distribution."""
        cell = _DistCell(len(self.bounds))
        cell.buckets = list(snap["buckets"])
        if len(cell.buckets) != len(self.bounds) + 1:
            raise ValueError("bucket layout mismatch in Distribution.merge")
        cell.sum = snap["sum"]
        cell.count = snap["count"]
        cell.min = snap.get("min", float("inf"))
        cell.max = snap.get("max", float("-inf"))
        with self._lock:
            if self._merged is None:
                self._merged = _DistCell(len(self.bounds))
            self._fold(self._merged, cell)

    def snapshot(self) -> dict:
        total = self._total()
        return {
            "kind": "distribution",
            "count": total.count,
            "sum": total.sum,
            "min": total.min if total.count else 0.0,
            "max": total.max if total.count else 0.0,
            "buckets": list(total.buckets),
            "bounds": list(self.bounds),
            "p50": self._quantile(total, 0.50),
            "p90": self._quantile(total, 0.90),
            "p99": self._quantile(total, 0.99),
        }

    def render(self) -> list[str]:
        total = self._total()
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        cum = 0
        for le, n in zip(self.bounds, total.buckets):
            cum += n
            lines.append(f'{self.name}_bucket{{le="{_fmt(le)}"}} {cum}')
        cum += total.buckets[-1]
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{self.name}_sum {_fmt(total.sum)}")
        lines.append(f"{self.name}_count {total.count}")
        return lines


class MetricsRegistry:
    """Named-metric registry with get-or-create semantics; re-registering a
    name as a different kind raises (one meaning per name, process-wide)."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, help: str, **kwargs):
        _validate_name(name, cls.kind)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"not {cls.kind}")
                return m
            m = cls(name, help, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help)

    def distribution(self, name: str, help: str = "", lo: float = 1e-4,
                     growth: float = 2.0, buckets: int = 30) -> Distribution:
        return self._get_or_create(name, Distribution, help, lo=lo,
                                   growth=growth, buckets=buckets)

    def snapshot(self) -> dict:
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.snapshot() for name, m in items}

    def render_prometheus(self) -> str:
        with self._lock:
            items = sorted(self._metrics.items())
        lines: list[str] = []
        for _name, m in items:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


REGISTRY = MetricsRegistry()

# ---------------------------------------------------------------- engine set
# Every metric is defined EAGERLY at import, so the exposition shows the
# whole vocabulary (at zero) before any traffic.  Names, kinds and help
# texts are the reference's.

# scan ingest (exec/prefetch.py counters rolled up per query)
SCAN_BYTES = REGISTRY.counter(
    "trino_scan_bytes_total", "host bytes produced by connector scans")
SCAN_ROWS = REGISTRY.counter(
    "trino_scan_rows_total", "rows produced by connector scans")
SCAN_BATCHES = REGISTRY.counter(
    "trino_scan_batches_total", "raw connector batches scanned")
SCAN_READ_SECONDS = REGISTRY.counter(
    "trino_scan_read_seconds_total", "time inside connector get_next_batch")
SCAN_WAIT_SECONDS = REGISTRY.counter(
    "trino_scan_consumer_wait_seconds_total",
    "consumer time blocked on scan prefetch")
SCAN_GBPS = REGISTRY.gauge(
    "trino_scan_gb_per_second", "scan ingest GB/s of the last observed query")

# host-sync discipline (exec/syncguard.py deltas)
SYNC_HOST = REGISTRY.counter(
    "trino_exec_host_syncs_total", "device->host scalar materializations")
SYNC_BLOCKING = REGISTRY.counter(
    "trino_exec_blocking_syncs_total", "host syncs that waited on the device")
SYNC_HOT_LOOP = REGISTRY.counter(
    "trino_exec_hot_loop_syncs_total",
    "blocking syncs inside declared hot regions (want: 0)")
EXPAND_OVERFLOWS = REGISTRY.counter(
    "trino_exec_expand_overflows_total",
    "padded-expand capacity overflows detected on device")
EXPAND_RETRIES = REGISTRY.counter(
    "trino_exec_expand_retries_total", "expand re-runs after an overflow")

# query lifecycle
QUERIES_STARTED = REGISTRY.counter(
    "trino_queries_started_total", "queries entered through a runner")
QUERIES_FINISHED = REGISTRY.counter(
    "trino_queries_finished_total", "queries that reached FINISHED")
QUERIES_FAILED = REGISTRY.counter(
    "trino_queries_failed_total", "queries that reached FAILED")
QUERY_WALL_SECONDS = REGISTRY.distribution(
    "trino_query_wall_seconds", "per-query wall time", lo=1e-3)
TASKS_CREATED = REGISTRY.counter(
    "trino_tasks_created_total", "tasks started (in-process or worker)")
TASKS_FAILED = REGISTRY.counter(
    "trino_tasks_failed_total", "tasks that reached FAILED")
TASK_WALL_SECONDS = REGISTRY.distribution(
    "trino_task_wall_seconds", "per-task wall time", lo=1e-3)
DISPATCHER_QUERIES = REGISTRY.counter(
    "trino_dispatcher_queries_total",
    "statements admitted through the HTTP dispatcher")

# exchange HTTP plane (execution/remote.py HttpExchangeClient + worker serve)
EXCHANGE_BYTES = REGISTRY.counter(
    "trino_exchange_bytes_total", "exchange page bytes moved over HTTP")
EXCHANGE_PAGES = REGISTRY.counter(
    "trino_exchange_pages_total", "exchange pages moved over HTTP")
EXCHANGE_WAIT_SECONDS = REGISTRY.counter(
    "trino_exchange_wait_seconds_total",
    "client time spent inside exchange fetches")

# multi-tenant serving plane (execution/resource_manager.py): admission
# wait, the low-memory killer, and the coordinator's cluster memory view
ADMISSION_QUEUED_SECONDS = REGISTRY.distribution(
    "trino_admission_queued_seconds",
    "time queries wait for admission (group slot or cluster memory)")
OOM_KILLS = REGISTRY.counter(
    "trino_oom_kills_total",
    "queries killed by the cluster low-memory killer")
CLUSTER_MEMORY_RESERVED = REGISTRY.gauge(
    "trino_cluster_memory_reserved_bytes",
    "bytes reserved across all tracked query memory pools")
CLUSTER_MEMORY_FREE = REGISTRY.gauge(
    "trino_cluster_memory_free_bytes",
    "cluster memory capacity minus reservations (0 when uncapped)")

# HA control plane (execution/ha.py + server/front_tier.py): coordinator
# fleet leases, lease-based failover, front-tier routing, worker autoscaling
HA_LEASES_HELD = REGISTRY.gauge(
    "trino_ha_leases_held",
    "coordinator leases this process currently holds (its own plus any "
    "claimed from dead peers)")
HA_FLEET_COORDINATORS = REGISTRY.gauge(
    "trino_ha_fleet_coordinators",
    "live coordinators visible in the cluster directory")
HA_TAKEOVERS = REGISTRY.counter(
    "trino_ha_takeovers_total",
    "dead-coordinator WAL directories claimed by this coordinator")
HA_ADOPTED_QUERIES = REGISTRY.counter(
    "trino_ha_adopted_queries_total",
    "in-flight queries adopted from a claimed WAL directory and resumed "
    "under their original ids")
HA_REROUTES = REGISTRY.counter(
    "trino_ha_reroutes_total",
    "front-tier requests rerouted off the hash owner (owner dead or "
    "mid-failover)")
HA_AUTOSCALE_EVENTS = REGISTRY.counter(
    "trino_ha_autoscale_events_total",
    "autoscaler scale-up and drain actions applied to the worker fleet")

# device memory watermark (the caching allocator of the runner's card)
DEVICE_MEMORY_IN_USE = REGISTRY.gauge(
    "trino_device_memory_bytes_in_use", "allocator bytes in use, all devices")
DEVICE_MEMORY_PEAK = REGISTRY.gauge(
    "trino_device_memory_peak_bytes",
    "allocator peak bytes in use, all devices")

# query flight recorder (telemetry/profiler.py + telemetry/journal.py)
PROFILE_EVENTS = REGISTRY.counter("trino_profile_events_total",
                                  "timeline profiler events harvested "
                                  "into query profiles")
PROFILE_DROPPED = REGISTRY.counter("trino_profile_dropped_total",
                                   "profiler ring slots overwritten before "
                                   "harvest (raise TRINO_TPU_PROFILE_RING "
                                   "if nonzero)")
JOURNAL_RECORDS = REGISTRY.counter("trino_journal_records_total",
                                   "query journal records written")
JOURNAL_BYTES = REGISTRY.counter("trino_journal_bytes_total",
                                 "query journal bytes written")
JOURNAL_ROTATIONS = REGISTRY.counter("trino_journal_rotations_total",
                                     "query journal file rotations")

# three-tier cache plane (caching/): Tier A logical plans, Tier B the
# bounded memo registry, Tier C versioned results
CACHE_PLAN_HITS = REGISTRY.counter(
    "trino_cache_plan_hits_total", "logical-plan cache hits")
CACHE_PLAN_MISSES = REGISTRY.counter(
    "trino_cache_plan_misses_total", "logical-plan cache misses")
CACHE_PLAN_EVICTIONS = REGISTRY.counter(
    "trino_cache_plan_evictions_total", "logical-plan cache LRU evictions")
CACHE_PLAN_INVALIDATIONS = REGISTRY.counter(
    "trino_cache_plan_invalidations_total",
    "logical-plan cache entries dropped by invalidation")
CACHE_PLAN_ENTRIES = REGISTRY.gauge(
    "trino_cache_plan_entries", "logical-plan cache resident entries")
CACHE_EXEC_HITS = REGISTRY.counter(
    "trino_cache_exec_hits_total", "executable-registry memo hits")
CACHE_EXEC_MISSES = REGISTRY.counter(
    "trino_cache_exec_misses_total",
    "executable-registry memo misses (new wrapper instantiated)")
CACHE_EXEC_EVICTIONS = REGISTRY.counter(
    "trino_cache_exec_evictions_total",
    "executable-registry LRU evictions")
CACHE_EXEC_ENTRIES = REGISTRY.gauge(
    "trino_cache_exec_entries",
    "executable-registry resident entries, all caches")
CACHE_RESULT_HITS = REGISTRY.counter(
    "trino_cache_result_hits_total", "versioned result cache hits")
CACHE_RESULT_MISSES = REGISTRY.counter(
    "trino_cache_result_misses_total", "versioned result cache misses")
CACHE_RESULT_EVICTIONS = REGISTRY.counter(
    "trino_cache_result_evictions_total",
    "result cache LRU evictions under the byte budget")
CACHE_RESULT_INVALIDATIONS = REGISTRY.counter(
    "trino_cache_result_invalidations_total",
    "result cache entries dropped by table mutation")
CACHE_RESULT_ENTRIES = REGISTRY.gauge(
    "trino_cache_result_entries", "result cache resident entries")
CACHE_RESULT_BYTES = REGISTRY.gauge(
    "trino_cache_result_bytes", "result cache resident bytes")

# iterative rule-engine optimizer (planner/iterative/) and history-based
# optimization (planner/history.py): the runtime-truth -> planning loop
OPTIMIZER_RUNS = REGISTRY.counter(
    "trino_optimizer_runs_total",
    "queries planned by the iterative rule-engine optimizer")
OPTIMIZER_RULE_FIRINGS = REGISTRY.counter(
    "trino_optimizer_rule_firings_total",
    "rule firings across all iterative optimizer runs")
OPTIMIZER_PLANNING_MS = REGISTRY.counter(
    "trino_optimizer_planning_ms_total",
    "wall milliseconds spent inside the iterative optimizer phases")
HBO_PLAN_LOOKUPS = REGISTRY.counter(
    "trino_hbo_plan_lookups_total",
    "plan-node fingerprint lookups against the history table at plan time")
HBO_PLAN_HITS = REGISTRY.counter(
    "trino_hbo_plan_hits_total",
    "plan-time fingerprint lookups answered by journaled observed stats")
HBO_RECORDS = REGISTRY.counter(
    "trino_hbo_records_total",
    "plan_stats journal records written at query completion")
HBO_RECORD_ERRORS = REGISTRY.counter(
    "trino_hbo_record_errors_total",
    "plan_stats recording attempts that failed (swallowed, query unaffected)")
HBO_FANOUT_ADJUSTED = REGISTRY.counter(
    "trino_hbo_fanout_adjusted_total",
    "stages whose task count was shrunk from history-observed input rows")

# adaptive execution plane (execution/adaptive.py): phased activation,
# runtime join-distribution switching, skew-aware repartitioning
ADAPTIVE_DECISIONS = REGISTRY.counter(
    "trino_adaptive_decisions_total",
    "adaptive decision points evaluated at stage activation barriers")
ADAPTIVE_BROADCAST_FLIPS = REGISTRY.counter(
    "trino_adaptive_flips_to_broadcast_total",
    "partitioned joins flipped to broadcast on observed build size")
ADAPTIVE_PARTITION_FLIPS = REGISTRY.counter(
    "trino_adaptive_flips_to_partitioned_total",
    "broadcast joins flipped to partitioned on observed build size")
ADAPTIVE_SKEW_SPLITS = REGISTRY.counter(
    "trino_adaptive_skew_splits_total",
    "heavy-hitter keys split across multiple probe tasks")
ADAPTIVE_STAGE_ACTIVATIONS = REGISTRY.counter(
    "trino_adaptive_stage_activations_total",
    "stages activated by the phased bottom-up scheduler")
ADAPTIVE_MEMO_HITS = REGISTRY.counter(
    "trino_adaptive_memo_hits_total",
    "adaptive decisions replayed from the runtime-stat-keyed memo")
ADAPTIVE_SKEW_IMBALANCE = REGISTRY.gauge(
    "trino_adaptive_skew_imbalance_ratio",
    "sketch-estimated max partition weight before the last skew split "
    "divided by after; the load-balance win a parallel host realises")


# compressed execution (spi/batch.py encodings + encoding-aware operators)
ENCODING_RLE_BATCHES = REGISTRY.counter(
    "trino_encoding_rle_batches_total",
    "batches carrying at least one run-length-encoded column")
ENCODING_LAZY_COLUMNS = REGISTRY.counter(
    "trino_encoding_lazy_columns_total",
    "lazy (deferred-materialization) columns created by staging")
ENCODING_LAZY_MATERIALIZED = REGISTRY.counter(
    "trino_encoding_lazy_materialized_total",
    "lazy columns whose thunk actually ran (first touch)")
ENCODING_BYTES_SAVED = REGISTRY.counter(
    "trino_encoding_bytes_saved_total",
    "bytes not staged or shipped because a column stayed encoded "
    "(flat-equivalent size minus encoded size)")
ENCODING_LAZY_SKIPPED_BYTES = REGISTRY.counter(
    "trino_encoding_lazy_skipped_bytes_total",
    "payload bytes whose transfer was deferred by lazy staging (subtract "
    "trino_encoding_lazy_materialized_bytes_total for bytes that truly "
    "never moved)")
ENCODING_LAZY_MATERIALIZED_BYTES = REGISTRY.counter(
    "trino_encoding_lazy_materialized_bytes_total",
    "deferred payload bytes that DID move in the end because the lazy "
    "column's thunk ran (first touch)")
ENCODING_DICT_SIDECAR_SENT = REGISTRY.counter(
    "trino_encoding_dict_sidecar_sent_total",
    "dictionary sidecars shipped on a serde v2 stream (once per "
    "(stream, column) — not per page)")
ENCODING_DICT_SIDECAR_REUSED = REGISTRY.counter(
    "trino_encoding_dict_sidecar_reused_total",
    "pages that referenced an already-shipped dictionary sidecar by id "
    "instead of re-sending values")
ENCODING_EXCHANGE_CODE_PAGES = REGISTRY.counter(
    "trino_encoding_exchange_code_pages_total",
    "exchange pages whose dictionary codes crossed the shuffle without "
    "a decode (repartition serde v2 or collective all_to_all)")
ENCODING_RLE_AGG_ROWS = REGISTRY.counter(
    "trino_encoding_rle_agg_rows_total",
    "input rows aggregated arithmetically from RLE runs (value * "
    "run_count) without expansion")

# resilience (retry_policy=QUERY loop, heartbeats, exchange backoff)
RES_QUERY_RETRIES = REGISTRY.counter(
    "trino_resilience_query_retries_total", "query-level retry attempts")
RES_BACKOFF_WAITS = REGISTRY.counter(
    "trino_resilience_backoff_waits_total", "retry backoff sleeps")
RES_BACKOFF_SECONDS = REGISTRY.counter(
    "trino_resilience_backoff_seconds_total", "total retry backoff time")
RES_BLACKLISTED = REGISTRY.counter(
    "trino_resilience_blacklisted_workers_total",
    "workers blacklisted by the query retry loop")
RES_REPLACEMENTS = REGISTRY.counter(
    "trino_resilience_worker_replacements_total",
    "GONE workers replaced by respawn")
RES_HEARTBEAT_TRANSITIONS = REGISTRY.counter(
    "trino_resilience_heartbeat_transitions_total",
    "worker heartbeat state transitions")
RES_EXCHANGE_FETCH_FAILURES = REGISTRY.counter(
    "trino_resilience_exchange_fetch_failures_total",
    "transient exchange fetch failures")
RES_EXCHANGE_BACKOFF_TRIPS = REGISTRY.counter(
    "trino_resilience_exchange_backoff_trips_total",
    "exchange sources declared failed past the failure-duration budget")

# streaming straggler speculation + graceful drain (execution/speculation.py)
SPECULATIVE_STARTS = REGISTRY.counter(
    "trino_speculative_starts_total",
    "speculative twin tasks launched for streaming stragglers")
SPECULATIVE_WINS = REGISTRY.counter(
    "trino_speculative_wins_total",
    "speculative twins that won the first-commit race")
DRAINS = REGISTRY.counter(
    "trino_drains_total", "coordinator-driven worker drains started")
BLACKLISTED_WORKERS = REGISTRY.gauge(
    "trino_blacklisted_workers",
    "workers currently blacklisted by the cluster blacklist")

# fault-tolerant execution (execution/fte.py + query_state.py + spool_gc.py)
FTE_ATTEMPT_STARTS = REGISTRY.counter(
    "trino_fte_attempt_starts_total", "FTE task attempts started")
FTE_ATTEMPT_RETRIES = REGISTRY.counter(
    "trino_fte_attempt_retries_total",
    "FTE task attempts that were retries of a failed attempt")
FTE_SPECULATIVE_STARTS = REGISTRY.counter(
    "trino_fte_speculative_starts_total",
    "speculative FTE attempt chains launched against stragglers")
FTE_SPECULATIVE_WINS = REGISTRY.counter(
    "trino_fte_speculative_wins_total",
    "speculative FTE attempts that committed first")
FTE_STAGES_RESUMED = REGISTRY.counter(
    "trino_fte_stages_resumed_total",
    "stage tasks skipped on recovery because a prior coordinator "
    "already committed them")
FTE_QUERY_RECOVERIES = REGISTRY.counter(
    "trino_fte_query_recoveries_total",
    "in-flight FTE queries rehydrated from the query-state WAL after "
    "a coordinator restart")
FTE_SPOOL_CORRUPTIONS = REGISTRY.counter(
    "trino_fte_spool_corruptions_total",
    "committed spool attempts discarded on CRC mismatch / torn frames")
FTE_SPOOL_BYTES_LIVE = REGISTRY.gauge(
    "trino_fte_spool_bytes_live",
    "bytes currently retained under leased spool roots")
FTE_SPOOL_BYTES_RECLAIMED = REGISTRY.counter(
    "trino_fte_spool_bytes_reclaimed_total",
    "spool bytes reclaimed by release/TTL/budget/boot-sweep GC")

# whole-stage compilation (execution/stage_compiler.py)
FUSED_STAGES = REGISTRY.counter(
    "trino_fused_stages_total", "fused stage seams executed")
FUSED_BATCHES = REGISTRY.counter(
    "trino_fused_batches_total", "input batches absorbed by fused stages")
FUSED_JIT_CALLS = REGISTRY.counter(
    "trino_fused_jit_calls_total", "fused accumulate-program dispatches")
FUSED_COMPILES = REGISTRY.counter(
    "trino_fused_compiles_total", "distinct (program, bucket) traces")
FUSED_CACHE_HITS = REGISTRY.counter(
    "trino_fused_cache_hits_total",
    "fused dispatches served by an existing trace")
FUSED_MERGES = REGISTRY.counter(
    "trino_fused_seam_merges_total", "fused seam merge programs executed")
FUSED_FALLBACKS = REGISTRY.counter(
    "trino_fused_fallbacks_total",
    "fused-stage overflow fallbacks to the legacy path")
FUSED_COMPILE_SECONDS = REGISTRY.distribution(
    "trino_fused_compile_seconds",
    "wall time of fused-program trace+compile dispatches", lo=1e-3)

# whole-query compilation (execution/plan_compiler.py)
RESIDENT_PLANS = REGISTRY.counter(
    "trino_resident_plans_total", "maximal TPU-resident plans executed")
RESIDENT_PROGRAMS = REGISTRY.counter(
    "trino_resident_programs_total",
    "distinct (resident program, bucket) traces compiled")
RESIDENT_SEAMS = REGISTRY.counter(
    "trino_resident_seams_total",
    "interior exchange edges fused inside resident-plan programs")
RESIDENT_BATCHES = REGISTRY.counter(
    "trino_resident_batches_total",
    "probe batches absorbed by resident-plan programs")
RESIDENT_JIT_CALLS = REGISTRY.counter(
    "trino_resident_jit_calls_total",
    "whole-plan program dispatches (one per probe batch)")
RESIDENT_CODE_SEAMS = REGISTRY.counter(
    "trino_resident_code_seam_columns_total",
    "dictionary-code lanes that crossed an interior seam unmaterialized")
RESIDENT_FALLBACKS = REGISTRY.counter(
    "trino_resident_fallbacks_total",
    "resident-plan overflow/dup-key fallbacks to the legacy path")


# ------------------------------------------------------------ observe hooks


def resource_group_gauges(path: str):
    """(running, queued) gauge pair for one resource group.  Group trees
    are operator config, so these names are the one sanctioned DYNAMIC
    registration: ``trino_resource_group_{running,queued}_<path>`` with the
    dotted path mangled to a Prometheus-legal suffix.  MetricsRegistry
    get-or-create semantics make repeated calls cheap and idempotent."""
    suffix = re.sub(r"[^a-zA-Z0-9_]", "_", path)
    prefix = "trino_resource_group_"
    return (
        REGISTRY.gauge(prefix + "running_" + suffix,
                       f"queries running in resource group {path}"),
        REGISTRY.gauge(prefix + "queued_" + suffix,
                       f"queries queued in resource group {path}"),
    )


def observe_exchange(nbytes: int, pages: int, wait_s: float) -> None:
    """One exchange fetch/serve observation (HTTP plane)."""
    EXCHANGE_BYTES.inc(nbytes)
    EXCHANGE_PAGES.inc(pages)
    EXCHANGE_WAIT_SECONDS.inc(wait_s)


def observe_scan(ingest) -> None:
    """Fold a ScanIngestStats roll-up (exec/stats.py) into the registry."""
    if ingest is None or not ingest.scan_batches:
        return
    SCAN_BYTES.inc(ingest.scan_bytes)
    SCAN_ROWS.inc(ingest.scan_rows)
    SCAN_BATCHES.inc(ingest.scan_batches)
    SCAN_READ_SECONDS.inc(ingest.source_read_s)
    SCAN_WAIT_SECONDS.inc(ingest.consumer_wait_s)
    if ingest.gbps:
        SCAN_GBPS.set(round(ingest.gbps, 3))


def observe_sync(sync) -> None:
    """Fold a SyncStats delta (exec/syncguard.py)."""
    if sync is None:
        return
    if sync.host_syncs:
        SYNC_HOST.inc(sync.host_syncs)
    if sync.blocking_syncs:
        SYNC_BLOCKING.inc(sync.blocking_syncs)
    if sync.hot_loop_syncs:
        SYNC_HOT_LOOP.inc(sync.hot_loop_syncs)
    if sync.expand_overflows:
        EXPAND_OVERFLOWS.inc(sync.expand_overflows)
    if sync.expand_retries:
        EXPAND_RETRIES.inc(sync.expand_retries)


def observe_encoding(enc) -> None:
    """Fold an EncodingStats roll-up (exec/stats.py).  ``lazy_materialized``
    is recorded where a thunk runs (exec/prefetch.py), the sidecar counters
    at the serde boundary (execution/serde.py)."""
    if enc is None or not enc.any:
        return
    ENCODING_RLE_BATCHES.inc(enc.rle_batches)
    ENCODING_LAZY_COLUMNS.inc(enc.lazy_columns)
    ENCODING_BYTES_SAVED.inc(enc.bytes_saved)
    ENCODING_LAZY_SKIPPED_BYTES.inc(enc.lazy_skipped_bytes)
    ENCODING_RLE_AGG_ROWS.inc(enc.rle_agg_rows)


def observe_fused(fs) -> None:
    """Fold a FusedStageStats roll-up.  ``compiles`` is deliberately NOT
    added here: the compile site (execution/stage_compiler.py) records it
    directly, together with the compile-wall-time histogram."""
    if fs is None or not fs.any:
        return
    FUSED_STAGES.inc(fs.stages)
    FUSED_BATCHES.inc(fs.batches)
    FUSED_JIT_CALLS.inc(fs.jit_calls)
    FUSED_CACHE_HITS.inc(fs.cache_hits)
    FUSED_MERGES.inc(fs.merges)
    FUSED_FALLBACKS.inc(fs.fallbacks)


def observe_resident(rs) -> None:
    """Fold a ResidentPlanStats roll-up.  ``programs`` and
    ``code_seam_columns`` are recorded at their event sites
    (execution/plan_compiler.py), mirroring the observe_fused contract."""
    if rs is None or not rs.any:
        return
    RESIDENT_PLANS.inc(rs.plans)
    RESIDENT_SEAMS.inc(rs.seams)
    RESIDENT_BATCHES.inc(rs.batches)
    RESIDENT_JIT_CALLS.inc(rs.jit_calls)
    RESIDENT_FALLBACKS.inc(rs.fallbacks)


def observe_resilience(res) -> None:
    """Fold a ResilienceStats delta (exec/stats.py)."""
    if res is None or not res.any:
        return
    RES_QUERY_RETRIES.inc(res.query_retries)
    RES_BACKOFF_WAITS.inc(res.backoff_waits)
    RES_BACKOFF_SECONDS.inc(res.backoff_wait_s)
    RES_BLACKLISTED.inc(res.blacklisted_workers)
    RES_REPLACEMENTS.inc(res.worker_replacements)
    RES_HEARTBEAT_TRANSITIONS.inc(res.heartbeat_transitions)
    RES_EXCHANGE_FETCH_FAILURES.inc(res.exchange_fetch_failures)
    RES_EXCHANGE_BACKOFF_TRIPS.inc(res.exchange_backoff_trips)



def observe_adaptive(st) -> None:
    """Fold an AdaptiveStats roll-up (exec/stats.py).  ``decisions`` and the
    per-kind counters are recorded at decision time by execution/adaptive.py;
    here only the per-query activation count folds in, so a re-run of the
    same query never double-counts flips."""
    if st is None or not st.any:
        return
    ADAPTIVE_STAGE_ACTIVATIONS.inc(st.activations)



def update_device_memory_watermark(device=None) -> Optional[int]:
    """Refresh the device-memory gauges from the CUDA caching allocator of
    ``device`` (a CUDA device; anything else reports nothing -> None).
    The allocator's nested statistics are a host-side query, not a device
    sync (read nested: ``torch.cuda.memory_stats`` would flatten them all
    in Python)."""
    import torch

    if device is None or torch.device(device).type != "cuda":
        return None
    try:
        stats = torch.cuda.memory_stats_as_nested_dict(device)
    except Exception:  # noqa: BLE001 — observability never fails a query
        return None
    alloc = stats.get("allocated_bytes", {}).get("all")
    if not alloc:
        return None
    in_use = int(alloc.get("current", 0))
    peak = int(alloc.get("peak", in_use))
    DEVICE_MEMORY_IN_USE.set(in_use)
    DEVICE_MEMORY_PEAK.set(peak)
    return peak


# ------------------------------------------------------- snapshot folding


def merge_snapshot(into: dict, other: dict) -> None:
    """Fold one registry ``snapshot()`` dict into another, in place.
    Unknown names are adopted; a distribution with a mismatched bucket
    layout is skipped (a version-skewed peer must not corrupt the
    roll-up)."""
    for name, s in other.items():
        m = into.get(name)
        if m is None:
            into[name] = copy.deepcopy(s)
            continue
        if m.get("kind") != s.get("kind"):
            continue
        if s["kind"] == "distribution":
            if m.get("bounds") != s.get("bounds"):
                continue
            if s["count"]:
                m["min"] = min(m["min"], s["min"]) if m["count"] else s["min"]
                m["max"] = max(m["max"], s["max"]) if m["count"] else s["max"]
            m["count"] += s["count"]
            m["sum"] += s["sum"]
            m["buckets"] = [a + b
                            for a, b in zip(m["buckets"], s["buckets"])]
        else:
            m["value"] += s["value"]


def render_snapshot_prometheus(snap: dict, helps: Optional[dict] = None
                               ) -> str:
    """Prometheus text exposition of a (possibly merged) snapshot dict, in
    the format ``MetricsRegistry.render_prometheus`` emits from live
    metric objects."""
    helps = helps or {}
    lines: list[str] = []
    for name in sorted(snap):
        s = snap[name]
        kind = s.get("kind")
        if kind == "distribution":
            lines.append(f"# HELP {name} {helps.get(name, '')}")
            lines.append(f"# TYPE {name} histogram")
            cum = 0
            for le, n in zip(s["bounds"], s["buckets"]):
                cum += n
                lines.append(f'{name}_bucket{{le="{_fmt(le)}"}} {cum}')
            cum += s["buckets"][-1]
            lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{name}_sum {_fmt(s['sum'])}")
            lines.append(f"{name}_count {s['count']}")
        elif kind in ("counter", "gauge"):
            lines.append(f"# HELP {name} {helps.get(name, '')}")
            lines.append(f"# TYPE {name} {kind}")
            lines.append(f"{name} {_fmt(s['value'])}")
    return "\n".join(lines) + "\n"


def render_cluster(remote_snapshots: list[dict]) -> str:
    """The coordinator's scope=cluster view: local registry snapshot plus
    every reachable worker's, folded and rendered as one exposition."""
    merged = REGISTRY.snapshot()
    for snap in remote_snapshots:
        if isinstance(snap, dict):
            merge_snapshot(merged, snap)
    with REGISTRY._lock:
        helps = {n: m.help for n, m in REGISTRY._metrics.items()}
    return render_snapshot_prometheus(merged, helps)

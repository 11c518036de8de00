"""System connector: the engine's own state as SQL tables.

The port of the reference ``connectors/system.py`` (the ``system.runtime``
role: SystemConnector.java + RuntimeQueriesSystemTable /
RuntimeTasksSystemTable, and the JMX connector for counters): rows come
from the process-wide registries (telemetry/runtime.py), the metrics
snapshot (telemetry/metrics.py), the query journal (telemetry/journal.py)
and the cache plane (caching/), served through the ordinary Connector SPI,
so every planner and executor layer treats them like any other table.
The eight tables and their schemas are the reference's.

A distributed runner attaches itself: ``runtime.resource_groups`` is its
dispatcher's group tree, ``runtime.workers`` its worker fleet (the
process runner's heartbeat sweep, or the in-process runner's discovery
and failure detector: a drained slot is SHUTTING_DOWN, a failed pinger
GONE), and ``runtime.queries`` adds the dispatcher's queries that no
query record covers.  A standalone runner has no dispatcher, worker fleet
or coordinator fleet, so there those tables give what the reference's
standalone runner gives: ``runtime.resource_groups`` and
``runtime.workers`` are empty.  ``runtime.tasks`` holds what the task
registry holds, and ``runtime.coordinators`` is the one local
coordinator (the HA fleet's table comes with the HA modules).
``data_version`` is None for every table, so a system read is never
result-cached.

Tables are schema-qualified (``runtime.queries`` etc.);
``Catalog.resolve_table`` resolves ``system.runtime.queries`` by trying the
schema-qualified name against this connector first.

Cookbook:
    SELECT query_id, state FROM system.runtime.queries
    SELECT * FROM system.runtime.caches
    SELECT * FROM system.metrics.counters WHERE name LIKE 'trino_scan%'
"""

from __future__ import annotations

import os
import socket
import time
import weakref
from typing import Optional, Sequence

from ..spi.batch import Column, ColumnBatch
from ..spi.connector import (
    ColumnSchema,
    Connector,
    ConnectorPageSource,
    Split,
    TableSchema,
)
from ..spi.types import BIGINT, DOUBLE, VARCHAR

__all__ = ["SystemConnector"]


def _schema(name: str, cols: list[tuple]) -> TableSchema:
    return TableSchema(name, tuple(ColumnSchema(n, t) for n, t in cols))


_TABLES = {
    "runtime.queries": _schema("runtime.queries", [
        ("query_id", VARCHAR), ("state", VARCHAR), ("user", VARCHAR),
        ("sql", VARCHAR), ("wall_ms", DOUBLE), ("cpu_ms", DOUBLE),
        ("output_rows", BIGINT), ("input_rows", BIGINT),
        ("input_bytes", BIGINT), ("retry_count", BIGINT),
        ("peak_memory_bytes", BIGINT), ("error", VARCHAR),
        ("queued_time_ms", DOUBLE), ("resource_group", VARCHAR),
        ("adaptive_decisions", VARCHAR),
    ]),
    "runtime.resource_groups": _schema("runtime.resource_groups", [
        ("path", VARCHAR), ("policy", VARCHAR), ("weight", BIGINT),
        ("soft_concurrency_limit", BIGINT),
        ("hard_concurrency_limit", BIGINT), ("max_queued", BIGINT),
        ("running", BIGINT), ("queued", BIGINT),
        ("memory_bytes", BIGINT), ("cpu_usage_s", DOUBLE),
    ]),
    # durable flight-recorder feed (telemetry/journal.py): completed queries
    # read back from the on-disk journal, surviving coordinator restarts
    "runtime.query_history": _schema("runtime.query_history", [
        ("query_id", VARCHAR), ("state", VARCHAR), ("user", VARCHAR),
        ("sql", VARCHAR), ("fingerprint", VARCHAR), ("ts", DOUBLE),
        ("wall_ms", DOUBLE), ("cpu_ms", DOUBLE),
        ("output_rows", BIGINT), ("input_rows", BIGINT),
        ("input_bytes", BIGINT), ("retry_count", BIGINT),
        ("peak_memory_bytes", BIGINT), ("queued_time_ms", DOUBLE),
        ("resource_group", VARCHAR), ("speculative_wins", BIGINT),
        ("error", VARCHAR), ("error_code", VARCHAR),
    ]),
    "runtime.tasks": _schema("runtime.tasks", [
        ("query_id", VARCHAR), ("task_id", VARCHAR), ("fragment", BIGINT),
        ("task_index", BIGINT), ("worker", VARCHAR), ("state", VARCHAR),
        ("wall_ms", DOUBLE), ("error", VARCHAR),
    ]),
    "runtime.workers": _schema("runtime.workers", [
        ("worker", VARCHAR), ("state", VARCHAR),
        ("blacklist_score", DOUBLE), ("running_tasks", BIGINT),
        ("queued_tasks", BIGINT), ("last_heartbeat_age_ms", DOUBLE),
    ]),
    # HA coordinator fleet (execution/ha.py lease directory); with HA off
    # this is the single local coordinator
    "runtime.coordinators": _schema("runtime.coordinators", [
        ("coordinator", VARCHAR), ("state", VARCHAR),
        ("lease_age_ms", DOUBLE), ("in_flight_queries", BIGINT),
        ("url", VARCHAR),
    ]),
    "metrics.counters": _schema("metrics.counters", [
        ("name", VARCHAR), ("kind", VARCHAR), ("value", DOUBLE),
    ]),
    # three-tier cache plane (caching/): one row per plan/result tier and
    # per registered executable memo
    "runtime.caches": _schema("runtime.caches", [
        ("tier", VARCHAR), ("name", VARCHAR), ("entries", BIGINT),
        ("bytes", BIGINT), ("hits", BIGINT), ("misses", BIGINT),
        ("evictions", BIGINT), ("invalidations", BIGINT),
    ]),
}


class _OneBatchSource(ConnectorPageSource):
    def __init__(self, batch: ColumnBatch):
        self._batch = batch
        self._done = False

    def get_next_batch(self) -> Optional[ColumnBatch]:
        if self._done:
            return None
        self._done = True
        return self._batch

    def is_finished(self) -> bool:
        return self._done


class SystemConnector(Connector):
    name = "system"

    def __init__(self):
        self._runner = None  # weakref to an attached runner (optional)

    def attach(self, runner) -> None:
        """Bind the runner this catalog serves (the reference's runners
        with a dispatcher or a worker fleet feed tables from it)."""
        self._runner = weakref.ref(runner)

    # --- metadata ---------------------------------------------------------
    def list_tables(self) -> list[str]:
        return sorted(_TABLES)

    def get_table_schema(self, table: str) -> TableSchema:
        if table not in _TABLES:
            raise KeyError(f"no such system table: {table!r}")
        return _TABLES[table]

    # --- reads ------------------------------------------------------------
    def get_splits(self, table: str, splits_per_node: int,
                   node_count: int) -> list[Split]:
        self.get_table_schema(table)  # KeyError on unknown tables
        return [Split("system", table, None)]

    def create_page_source(self, split: Split, columns: Sequence[str],
                           constraint=None) -> ConnectorPageSource:
        rows = self._rows(split.table)
        schema = _TABLES[split.table]
        by_name = {c.name: (i, c.type) for i, c in enumerate(schema.columns)}
        cols = []
        for name in columns:
            idx, typ = by_name[name]
            cols.append(Column.from_values(typ, [r[idx] for r in rows]))
        return _OneBatchSource(ColumnBatch(list(columns), cols))

    def _rows(self, table: str) -> list[tuple]:
        from ..telemetry import metrics, runtime

        if table == "runtime.queries":
            out = [
                (q.query_id, q.state, q.user, q.sql, q.wall_ms, q.cpu_ms,
                 q.output_rows, q.input_rows, q.input_bytes, q.retry_count,
                 q.peak_memory_bytes, q.error, q.queued_ms, q.resource_group,
                 q.adaptive_decisions)
                for q in runtime.queries()
            ]
            # dispatcher-tracked queries (control.py FSM) that predate or
            # bypass run_with_query_events show up with their FSM state
            dispatcher = getattr(self._attached(), "dispatcher", None)
            if dispatcher is not None:
                seen = {r[0] for r in out}
                for info in dispatcher.queries():
                    if info.query_id not in seen:
                        out.append((info.query_id, info.state, "", info.sql,
                                    0.0, 0.0, -1, 0, 0, 0, 0, None, 0.0,
                                    info.resource_group, ""))
            return out
        if table == "runtime.resource_groups":
            dispatcher = getattr(self._attached(), "dispatcher", None)
            if dispatcher is None:
                return []
            return [
                (g.name, g.scheduling_policy, g.weight,
                 g.soft_concurrency_limit
                 if g.soft_concurrency_limit is not None
                 else g.hard_concurrency_limit,
                 g.hard_concurrency_limit, g.max_queued,
                 g.running, g.queued, g.memory_usage_bytes, g.cpu_usage_s)
                for g in dispatcher.groups()
            ]
        if table == "runtime.workers":
            return self._worker_rows()
        if table == "runtime.query_history":
            from ..telemetry import journal as tj

            return [
                (r.get("query_id", ""), r.get("state", ""),
                 r.get("user", ""), r.get("sql", ""),
                 r.get("fingerprint", ""), float(r.get("ts", 0.0) or 0.0),
                 float(r.get("wall_ms", 0.0) or 0.0),
                 float(r.get("cpu_ms", 0.0) or 0.0),
                 int(r.get("output_rows", -1) or 0),
                 int(r.get("input_rows", 0) or 0),
                 int(r.get("input_bytes", 0) or 0),
                 int(r.get("retry_count", 0) or 0),
                 int(r.get("peak_memory_bytes", 0) or 0),
                 float(r.get("queued_time_ms", 0.0) or 0.0),
                 r.get("resource_group", ""),
                 int(r.get("speculative_wins", 0) or 0),
                 r.get("error"), r.get("error_code"))
                for r in tj.history()
            ]
        if table == "runtime.tasks":
            return [
                (t.query_id, t.task_id, t.fragment, t.task_index, t.worker,
                 t.state, t.wall_ms, t.error)
                for t in runtime.tasks()
            ]
        if table == "runtime.coordinators":
            # the one local coordinator, named as the reference names it
            # with HA off; nothing queued in front of it
            return [(f"coord-{socket.gethostname()}-{os.getpid()}",
                     "ACTIVE", 0.0, 0, "")]
        if table == "runtime.caches":
            from .. import caching

            return [
                (r["tier"], r["name"], int(r["entries"]), int(r["bytes"]),
                 int(r["hits"]), int(r["misses"]), int(r["evictions"]),
                 int(r["invalidations"]))
                for r in caching.cache_rows(per_exec_cache=True)
            ]
        if table == "metrics.counters":
            out = []
            for name, snap in metrics.REGISTRY.snapshot().items():
                kind = snap["kind"]
                if kind == "distribution":
                    # flatten: scalar summary rows per distribution
                    for suffix, v in (("count", snap["count"]),
                                      ("sum", snap["sum"]),
                                      ("p50", snap["p50"]),
                                      ("p90", snap["p90"]),
                                      ("p99", snap["p99"])):
                        out.append((f"{name}_{suffix}", kind, float(v)))
                else:
                    out.append((name, kind, float(snap["value"])))
            return out
        raise KeyError(f"no such system table: {table!r}")

    def _attached(self):
        return self._runner() if self._runner is not None else None

    def _worker_rows(self) -> list[tuple]:
        """Per-worker operational view: failure-detector state, cluster
        blacklist score, task counts, heartbeat age.  Process runners carry
        a WorkerFailureDetector (worker_rows feed); the in-process runner
        synthesizes from discovery (control.py NodeManager), where a drained
        slot reports SHUTTING_DOWN and a failed pinger reports GONE."""
        runner = self._attached()
        if runner is None:
            return []
        bl = getattr(runner, "cluster_blacklist", None)
        scores = bl.snapshot() if bl is not None else {}
        fd = getattr(runner, "failure_detector", None)
        if hasattr(fd, "worker_rows"):
            return [
                (r["worker"], r["state"], float(scores.get(r["worker"], 0.0)),
                 r["running_tasks"], r["queued_tasks"],
                 r["last_heartbeat_age_ms"])
                for r in fd.worker_rows()
            ]
        nodes = getattr(runner, "nodes", None)
        if nodes is None:
            return []
        failed = set()
        try:
            failed = set(fd.failed_nodes())
        except Exception:
            pass
        now = time.monotonic()
        out = []
        for n in nodes.all_nodes():
            if n.coordinator:
                continue
            state = ("GONE" if n.node_id in failed
                     else "SHUTTING_DOWN" if n.draining else "ACTIVE")
            out.append((n.node_id, state,
                        float(scores.get(n.node_id, 0.0)), 0, 0,
                        (now - n.last_heartbeat) * 1000.0))
        return out

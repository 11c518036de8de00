"""System connector: the engine's own state as SQL tables.

The port of the reference ``connectors/system.py`` (the ``system.runtime``
role: SystemConnector.java + RuntimeQueriesSystemTable /
RuntimeTasksSystemTable, and the JMX connector for counters): rows come
from the process-wide registries (telemetry/runtime.py), the metrics
snapshot (telemetry/metrics.py), the query journal (telemetry/journal.py)
and the cache plane (caching/), served through the ordinary Connector SPI,
so every planner and executor layer treats them like any other table.
The eight tables and their schemas are the reference's.

A standalone runner has no dispatcher, worker fleet or coordinator fleet,
so those tables give what the reference's standalone runner gives:
``runtime.resource_groups`` and ``runtime.workers`` are empty,
``runtime.tasks`` holds what the task registry holds (nothing, until a
distributed runner records tasks), and ``runtime.coordinators`` is the
one local coordinator.  ``data_version`` is None for every table, so a
system read is never result-cached.

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
            return [
                (q.query_id, q.state, q.user, q.sql, q.wall_ms, q.cpu_ms,
                 q.output_rows, q.input_rows, q.input_bytes, q.retry_count,
                 q.peak_memory_bytes, q.error, q.queued_ms, q.resource_group,
                 q.adaptive_decisions)
                for q in runtime.queries()
            ]
        if table in ("runtime.resource_groups", "runtime.workers"):
            return []  # a standalone runner has no dispatcher, no workers
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

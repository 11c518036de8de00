"""StandaloneQueryRunner: SQL string -> result batch, in process, on a device.

The port of the reference ``runner.py`` (StandaloneQueryRunner.execute):
parse -> analyze/plan -> optimize -> local plan -> run the pipelines on
``device``.  ``optimizer`` selects the optimizer: ``"iterative"`` (the
default, as in the reference) or ``"legacy"`` (the reference's
``TRINO_TPU_OPTIMIZER=legacy``).  EXPLAIN [ANALYZE] returns the plan text,
the iterative optimizer's rule firings and, under ANALYZE, the run's scan
and encoding roll-ups and per-operator times and rows.

Every statement goes through :func:`run_with_query_events`, as in the
reference: created / completed events to the runner's listeners (the
query journal, telemetry/journal.py, among them), a root tracing span, a
``system.runtime.queries`` record, the query metrics and the profiler's
context (``runner.profile(query_id)`` is the query's Chrome trace).  A
query first tries the cache plane (caching/): a plan-cache hit (Tier A)
skips parsing and planning, then a result-cache hit (Tier C) skips
execution; a miss plans, stores the plan and executes, capturing the
scanned tables' version vector before it runs.  ``execute(sql,
stats=...)`` bypasses both tiers: a caller who asks for operator stats
gets an execution.  The tiers' switches are the reference's
``TRINO_TPU_{PLAN,RESULT}_CACHE``; ``result_cache.disabled()`` turns the
result tier off for a harness that times execution.

Besides queries, CREATE TABLE AS and INSERT (a TableWriter plan), the
runner takes the statements a session sends, as the reference does:
START TRANSACTION / COMMIT / ROLLBACK (``execution/transaction.py``), SET
SESSION, SHOW TABLES / COLUMNS, CREATE / DROP TABLE, CREATE / DROP
FUNCTION, CREATE [OR REPLACE] / DROP VIEW, CREATE / REFRESH / DROP
MATERIALIZED VIEW, CALL of a connector procedure, ANALYZE and DELETE.
Access control (``spi/security.py``) checks writes before a statement runs
and the scanned columns of every plan (on a plan-cache hit too).  ANALYZE
counts distinct values on the runner's device through ``hash_insert``;
DELETE and a refresh keep a device-resident table resident.

The ``Session`` holds what the port acts on: ``default_catalog``,
``user``, ``splits_per_node``, ``node_count``, ``dynamic_filtering``,
``hbm_limit_bytes`` (the task's device memory pool: blocking operators
revoke their buffers to host memory beyond it), ``spill_to_disk_bytes``
(an operator's buffered bytes past which it spills them to disk,
exec/spill.py; 0 = never) and ``task_concurrency`` (parallel drivers
behind local exchanges), read on every statement, and the distributed
runner's ``use_collectives``, ``exchange_serde``, ``task_scheduler`` and
``executor_workers``.  SET SESSION also
accepts the reference's other properties and stores them unread.  The
port-only arguments ``ingest`` (an
``exec.prefetch.IngestConfig``: split prefetch threads, coalescing into
pinned buffers, side-stream copies to the card), ``encoded_exec`` (RLE and
LAZY columns), ``optimizer`` and ``device`` are not session properties;
together they are the runner's :attr:`execution_key`, part of every cache
key.

The runner runs on the card unless the caller asks for the CPU:
``device="cuda"`` (the default) raises when CUDA is not available.
"""

from __future__ import annotations

import dataclasses
import inspect
import itertools
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .caching import executable_cache, plan_cache, result_cache
from .caching.plan_cache import scan_tables
from .connectors.catalog import Catalog, ViewDefinition, default_catalog
from .exec import kernels as K
from .exec import syncguard as SG
from .exec.driver import (collect_encoding_stats, collect_scan_stats,
                          run_pipelines)
from .exec.local_planner import LocalPlanner
from .exec.prefetch import IngestConfig
from .exec.stats import QueryStats
from .execution.tracing import Tracer, annotate_scan_span, annotate_sync_span
from .execution.transaction import handle_transaction_stmt
from .planner.iterative import last_report
from .planner.logical import LogicalPlanner
from .planner.optimizer import OPTIMIZER_MODES, optimize
from .planner.plan import PlanNode, TableScan, plan_text
from .spi.batch import Column, ColumnBatch
from .spi.connector import (ColumnSchema, Connector, TableSchema,
                            TableStatistics)
from .spi.errors import classify
from .spi.eventlistener import (EventListenerManager, QueryCompletedEvent,
                                QueryCreatedEvent)
from .spi.security import AccessControlManager
from .spi.types import BIGINT, VARCHAR, parse_type
from .sql import ast
from .sql.analyzer import is_builtin_function
from .sql.parser import parse_statement
from .telemetry import journal, profiler
from .telemetry import metrics as tm
from .telemetry import runtime as rt

__all__ = ["QueryResult", "Session", "StandaloneQueryRunner", "execute_ddl",
           "execute_session_stmt", "run_with_query_events",
           "SETTABLE_SESSION_PROPERTIES"]


def text_result(name: str, lines: list[str]) -> "QueryResult":
    return QueryResult([name], ColumnBatch(
        [name], [Column.from_values(VARCHAR, lines)]))


def count_result(name: str, n: int) -> "QueryResult":
    return QueryResult([name], ColumnBatch(
        [name], [Column(BIGINT, np.array([n], np.int64))]))


def _split_name(name: str, default: str) -> tuple[str, str]:
    parts = name.split(".")
    if len(parts) == 1:
        return default, parts[0]
    return parts[0], parts[-1]


@dataclass
class QueryResult:
    names: list[str]
    batch: ColumnBatch
    # the row count the query lifecycle reads once (run_with_query_events):
    # a result served again from the result cache carries it
    output_rows: Optional[int] = field(default=None, compare=False,
                                       repr=False)

    def rows(self) -> list[tuple]:
        SG.count_sync("runner.result-fetch")
        return self.batch.to_pylist()


# ---------------------------------------------------------------------------
# the session


# properties of the reference's Session that the port keeps in
# ``Session.properties`` (the control plane's heartbeats, worker
# replacement and drains, the HTTP exchange's backoff, admission, scaled
# writers), with the reference's defaults: SET SESSION accepts them, as the
# reference's runners do, and the distributed and process runners read
# them through ``Session.get``
STORED_SESSION_PROPERTIES = {
    "heartbeat_interval_s": 0.5, "heartbeat_failure_threshold": 3,
    "max_worker_replacements": 2, "exchange_backoff_min_s": 0.05,
    "exchange_backoff_max_s": 2.0, "exchange_max_failure_duration_s": 120.0,
    "query_concurrency": 16, "query_max_queued": 200,
    "drain_timeout_s": None,
    "scale_writers": False, "writer_task_limit": 4,
}


@dataclass
class Session:
    """Per-query knobs (the SystemSessionProperties miniature): the fields
    the port acts on, with the reference's defaults.  The reference's other
    properties live in ``properties`` once SET SESSION sets them (see
    :data:`STORED_SESSION_PROPERTIES`); :meth:`get` reads either kind."""

    default_catalog: str = "tpch"
    user: str = "user"
    splits_per_node: int = 4
    node_count: int = 1
    dynamic_filtering: bool = True
    # the task's device memory pool (exec/revoking.py)
    hbm_limit_bytes: int = 16 << 30
    # an operator's buffered bytes before the disk spill tier engages
    # (0 = disabled; exec/spill.py)
    spill_to_disk_bytes: int = 0
    # parallel drivers per task behind local exchanges
    task_concurrency: int = 1
    # the distributed runner (execution/distributed_runner.py): REPARTITION
    # edges between equal task counts as device collectives, host-exchange
    # pages as wire bytes, tasks on threads or on the time-sharing executor
    # with ``executor_workers`` workers
    use_collectives: bool = True
    exchange_serde: bool = False
    task_scheduler: str = "THREADS"
    executor_workers: int = 4
    # NONE = streaming pipelined scheduler; TASK = fault-tolerant execution
    # (stage-by-stage durable spool + per-task retry, execution/fte.py);
    # QUERY = streaming with coordinator query-level retry: on a retryable
    # (non-USER) failure the whole subplan re-runs
    retry_policy: str = "NONE"
    task_retry_attempts: int = 2
    # retry_policy=QUERY: attempt budget and the deterministic exponential
    # backoff between re-runs (spi/errors.py Backoff)
    query_retry_attempts: int = 2
    retry_initial_delay_s: float = 0.1
    retry_max_delay_s: float = 2.0
    # multi-tenant serving (execution/resource_manager.py): the selector
    # workload tag (maps to a resource group via TRINO_TPU_RESOURCE_GROUPS
    # selectors), the ticket priority under scheduling_policy=query_priority
    # and the OOM-killer victim ordering, the admission-queue wait budget,
    # and the per-query reservation cap (0 = TRINO_TPU_QUERY_MAX_MEMORY or
    # unlimited).  SQL cannot set them, as in the reference.
    source: str = ""
    query_priority: int = 0
    query_queued_timeout_s: float = 300.0
    query_max_memory_bytes: int = 0
    # active transaction (execution/transaction.py); None = autocommit
    transaction: object = None
    _transaction_manager: object = None
    # engine-level failure injection (execution/failure_injector.py)
    failure_injector: object = None
    # base directory of the durable FTE spool (None = TRINO_TPU_SPOOL_DIR
    # or the system temp)
    fte_spool_dir: object = None
    # FTE stragglers get a speculative attempt once half the stage
    # committed and the task exceeds max(2x median, fte_speculative_delay_s);
    # a memory failure multiplies the next attempt's device memory budget by
    # fte_memory_growth
    fte_speculative: bool = True
    fte_speculative_delay_s: float = 0.25
    fte_memory_growth: float = 2.0
    # streaming straggler speculation (execution/speculation.py): None defers
    # to TRINO_TPU_SPECULATION / TRINO_TPU_SPECULATION_NONLEAF
    speculation: object = None
    speculation_lag_multiplier: float = 2.0
    speculation_min_delay_s: float = 0.25
    speculation_nonleaf: object = None
    # the cross-query cluster blacklist: None defers to
    # TRINO_TPU_BLACKLIST_TTL_S / TRINO_TPU_BLACKLIST_THRESHOLD
    blacklist_ttl_s: object = None
    blacklist_threshold: object = None
    # the adaptive plane (execution/adaptive.py): None defers to
    # TRINO_TPU_ADAPTIVE ("auto"; "0" is the static plan, "1" forces phased
    # scheduling); 0 thresholds defer to TRINO_TPU_BROADCAST_THRESHOLD_BYTES
    # / TRINO_TPU_SKEW_FACTOR
    adaptive: object = None
    broadcast_threshold_bytes: int = 0
    skew_factor: float = 0.0
    # SET SESSION values of STORED_SESSION_PROPERTIES
    properties: dict = field(default_factory=dict)

    def get(self, name: str):
        if name in _PROPERTY_DEFAULTS:
            return self.properties.get(name, _PROPERTY_DEFAULTS[name])
        return getattr(self, name)


_PROPERTY_DEFAULTS = dict(STORED_SESSION_PROPERTIES)

# knobs SET SESSION may touch; identity/transaction state is NOT settable
# through SQL (a restricted user must not setattr session.user)
SETTABLE_SESSION_PROPERTIES = {
    "default_catalog", "splits_per_node", "node_count", "dynamic_filtering",
    "hbm_limit_bytes", "spill_to_disk_bytes", "task_concurrency",
    "use_collectives", "exchange_serde", "task_scheduler",
    "executor_workers", "retry_policy", "task_retry_attempts",
    "query_retry_attempts", "retry_initial_delay_s", "retry_max_delay_s",
    "fte_speculative", "fte_speculative_delay_s", "fte_memory_growth",
    "speculation", "speculation_lag_multiplier", "speculation_min_delay_s",
    "speculation_nonleaf", "blacklist_ttl_s", "blacklist_threshold",
    "adaptive", "broadcast_threshold_bytes", "skew_factor",
    *_PROPERTY_DEFAULTS}


def _literal_value(e):
    """Constant AST node -> python value (SET SESSION / CALL arguments)."""
    if isinstance(e, (ast.IntLiteral, ast.DoubleLiteral, ast.BooleanLiteral,
                      ast.StringLiteral)):
        return e.value
    if isinstance(e, ast.DecimalLiteral):
        return float(e.text)
    if isinstance(e, ast.NullLiteral):
        return None
    raise ValueError("expected a constant")


def execute_session_stmt(stmt, session: Session) -> Optional[QueryResult]:
    """SET SESSION (reference: execution/SetSessionTask.java): mutate a
    public Session knob with loose literal typing; None for any other
    statement."""
    if not isinstance(stmt, ast.SetSession):
        return None
    name = stmt.name.lower()
    if name not in SETTABLE_SESSION_PROPERTIES:
        raise KeyError(f"unknown or protected session property: {name}")
    value = _literal_value(stmt.value)
    current = session.get(name)
    if isinstance(current, bool) and not isinstance(value, bool):
        value = str(value).lower() in ("true", "1")
    elif isinstance(current, int) and not isinstance(value, bool) \
            and value is not None:
        value = int(value)
    if name in _PROPERTY_DEFAULTS:
        session.properties[name] = value
    else:
        setattr(session, name, value)
    return text_result("result", [f"{name} = {value}"])


# ---------------------------------------------------------------------------
# access control


def check_select_access(plan, access_control, user: str) -> None:
    """Every table the plan scans needs SELECT on its projected columns
    (reference: AccessControlManager.checkCanSelectFromColumns called from
    StatementAnalyzer)."""
    def walk(node):
        if isinstance(node, TableScan):
            access_control.check_can_select(
                user, node.catalog, node.table, node.columns)
        for c in node.children:
            walk(c)

    walk(plan)


def check_ddl_access(stmt, access_control, user: str,
                     default_catalog_name: str) -> None:
    """Pre-execution privilege checks for metadata/write statements."""
    if isinstance(stmt, (ast.CreateTable, ast.CreateTableAsSelect)):
        cat, table = _split_name(stmt.table, default_catalog_name)
        access_control.check_can_create_table(user, cat, table)
    elif isinstance(stmt, ast.DropTable):
        cat, table = _split_name(stmt.table, default_catalog_name)
        access_control.check_can_drop_table(user, cat, table)
    elif isinstance(stmt, ast.InsertInto):
        cat, table = _split_name(stmt.table, default_catalog_name)
        access_control.check_can_insert(user, cat, table)
    elif isinstance(stmt, ast.Delete):
        cat, table = _split_name(stmt.table, default_catalog_name)
        access_control.check_can_delete(user, cat, table)


# ---------------------------------------------------------------------------
# metadata statements


def _refresh_materialized_view(name: str, catalog: Catalog, plan, run,
                               device) -> int:
    """(Re)materialize a view into its backing table ``__mv_<name>`` in the
    'memory' catalog, pinned on ``device`` (the refresh's batch is already
    there, so reads hand its tensors on uncopied); returns the row count
    (reference: operator/RefreshMaterializedViewOperator.java:27)."""
    view = catalog.views[name]
    conn = catalog.connector("memory")
    base_plan = plan(ast.QueryStatement(view.query))
    # capture the base tables' data_version vector BEFORE reading them:
    # Catalog.mv_is_stale compares these against current tokens, and a base
    # mutation racing the refresh must leave the MV looking stale, not fresh
    base_versions = catalog.table_versions(scan_tables(base_plan))
    result = run(base_plan)
    batch = result.batch.compact()
    backing = f"__mv_{name}"
    conn.drop_table(backing)
    conn.create_table(TableSchema(backing, tuple(
        ColumnSchema(n, c.type)
        for n, c in zip(result.names, batch.columns))))
    sink = conn.create_page_sink(backing)
    sink.append(batch.rename(list(result.names)))
    conn.finish_insert(backing, sink.finish())
    conn.pin_to_device(backing, device)
    view.backing = ("memory", backing)
    view.base_versions = base_versions
    return batch.num_rows


def _present_codes(col: Column) -> np.ndarray:
    """The dictionary codes present among a column's non-NULL rows, from a
    presence mask over the dictionary built on the column's device: only
    the present codes reach the host."""
    n_dict = len(col.dictionary)
    codes = col.data.long()
    if col.valid is not None:
        codes = torch.where(col.valid, codes, n_dict)
    presence = torch.zeros(n_dict + 1, dtype=torch.bool, device=codes.device)
    presence[codes] = True
    return SG.fetch(torch.nonzero(presence[:n_dict]).flatten(),
                    "analyze.present-codes")


def _analyze(stmt: ast.Analyze, catalog: Catalog, default_catalog_name: str,
             device) -> QueryResult:
    """ANALYZE: the row count and, per column, the number of distinct
    non-NULL values, stored through ``set_analyzed_statistics`` (reference:
    runner._execute_ddl's ANALYZE, StatisticsWriterOperator.java:35).  Each
    column is read on ``device`` and counted on its own, so no more than
    one column's batches are held there at a time."""
    cat, table, schema = catalog.resolve_table(stmt.table,
                                               default_catalog_name)
    conn = catalog.connector(cat)
    rows = 0
    ndv = {}
    for c in schema.columns:
        rows, count = _column_ndv(conn, table, c.name, device)
        ndv[c.name] = float(count)
    conn.set_analyzed_statistics(table, TableStatistics(
        row_count=float(rows), ndv=ndv))
    return count_result("rows", rows)


def _column_ndv(conn: Connector, table: str, name: str,
                device) -> tuple[int, int]:
    """(rows, distinct non-NULL values) of one column.  Batches that are
    not dictionaries are counted together by ``K.distinct_count`` (the
    ``hash_insert`` kernel on the card); a dictionary batch gives its
    present codes on the device, then their values on the host, and the
    values are unioned (codes are per-batch namespaces)."""
    rows = 0
    flat: list[Column] = []
    values: set = set()
    for split in conn.get_splits(table, 1, 1):
        src = conn.create_page_source(split, [name])
        while not src.is_finished():
            b = src.get_next_batch()
            if b is None:
                continue
            b = b.to(device).compact()
            rows += b.num_rows
            col = b.columns[0]
            if col.dictionary is not None:
                values.update(col.dictionary[_present_codes(col)])
            elif len(col):
                flat.append(col)
    count = len(values)
    if len(flat) == 1:
        count += K.distinct_count(flat[0].data, flat[0].valid)
    elif flat:
        valid = None
        if any(c.valid is not None for c in flat):
            valid = torch.cat([c.valid_mask() for c in flat])
        count += K.distinct_count(torch.cat([c.data for c in flat]), valid)
    return rows, count


def _delete(stmt: ast.Delete, catalog: Catalog, default_catalog_name: str,
            plan, run, device) -> QueryResult:
    """DELETE as a drop-and-rewrite (the simple connectors have no row-id
    deletes): the rows to keep, ``NOT coalesce(pred, false)`` (a NULL
    predicate keeps its row), are staged first, then replace the table.  A
    table that was resident is pinned again on ``device``, where the kept
    rows already are; only their count reaches the host."""
    cat, table, schema = catalog.resolve_table(stmt.table,
                                               default_catalog_name)
    conn = catalog.connector(cat)
    impl = getattr(type(conn), "create_page_sink", None)
    if impl is None or impl is Connector.create_page_sink:
        raise ValueError(f"connector {cat} does not support DELETE")
    row_count = getattr(conn, "row_count", None)
    if row_count is not None:
        before = row_count(table)
    else:
        stats = conn.get_table_statistics(table)
        before = (int(stats.row_count)
                  if stats.row_count == stats.row_count else None)
    if before is None:  # no stats: count the table first
        cq = ast.Query(ast.QuerySpec(
            (ast.SelectItem(ast.FunctionCall("count", (), is_star=True)),),
            False, ast.Table(f"{cat}.{table}"), None, (), None))
        before = int(run(plan(ast.QueryStatement(cq))).rows()[0][0])
    if stmt.where is None:
        keep_where = ast.BooleanLiteral(False)
    else:
        keep_where = ast.Not(ast.FunctionCall(
            "coalesce", (stmt.where, ast.BooleanLiteral(False))))
    q = ast.Query(ast.QuerySpec(
        (ast.SelectItem(None),), False,
        ast.Table(f"{cat}.{table}"), keep_where, (), None))
    resident = conn.is_resident(table)
    kept = run(plan(ast.QueryStatement(q))).batch.compact()
    # stage the kept rows FIRST: a failed rewrite cannot destroy data
    staging = f"__rewrite_{table}"
    conn.drop_table(staging)
    conn.create_table(TableSchema(staging, schema.columns))
    try:
        sink = conn.create_page_sink(staging)
        sink.append(kept)
        conn.finish_insert(staging, sink.finish())
    except BaseException:
        conn.drop_table(staging)
        raise
    conn.drop_table(table)
    conn.create_table(TableSchema(table, schema.columns))
    sink = conn.create_page_sink(table)
    for split in conn.get_splits(staging, 1, 1):
        src = conn.create_page_source(split, schema.column_names())
        while not src.is_finished():
            b = src.get_next_batch()
            if b is not None:
                sink.append(b)
    conn.finish_insert(table, sink.finish())
    conn.drop_table(staging)
    if resident:
        conn.pin_to_device(table, device)
    return count_result("rows", before - kept.num_rows)


def execute_ddl(stmt, catalog: Catalog, default_catalog_name: str,
                plan, run, device) -> Optional[QueryResult]:
    """Metadata statements: CREATE / DROP TABLE, FUNCTION, VIEW and
    MATERIALIZED VIEW, REFRESH, CALL, ANALYZE and DELETE; None for any
    other statement.  ``plan`` plans a query statement, ``run`` runs that
    plan into a QueryResult; ``device`` is the runner's.  Any of them may change how later statements plan, so
    each bumps the catalog's generation (reference: runner.execute_ddl)."""
    out = _execute_ddl(stmt, catalog, default_catalog_name, plan, run,
                       device)
    if out is not None:
        catalog.bump_generation()
    return out


def _execute_ddl(stmt, catalog: Catalog, default_catalog_name: str,
                 plan, run, device) -> Optional[QueryResult]:
    if isinstance(stmt, ast.CreateFunction):
        if is_builtin_function(stmt.name):
            raise ValueError(
                f"cannot create function {stmt.name!r}: shadows a builtin")
        catalog.sql_functions[stmt.name.lower()] = (
            stmt.params, stmt.return_type, stmt.body)
        return count_result("rows", 0)
    if isinstance(stmt, ast.DropFunction):
        if catalog.sql_functions.pop(stmt.name.lower(), None) is None:
            raise KeyError(f"no such function: {stmt.name}")
        return count_result("rows", 0)
    if isinstance(stmt, ast.CreateView):
        name = stmt.name.split(".")[-1]
        if name in catalog.views and not stmt.replace:
            raise ValueError(f"view already exists: {name}")
        catalog.views[name] = ViewDefinition(stmt.query, stmt.materialized)
        if stmt.materialized:
            _refresh_materialized_view(name, catalog, plan, run, device)
        return count_result("rows", 0)
    if isinstance(stmt, ast.DropView):
        name = stmt.name.split(".")[-1]
        view = catalog.views.pop(name, None)
        if view is None:
            if stmt.if_exists:
                return count_result("rows", 0)
            raise KeyError(f"no such view: {name}")
        if view.backing is not None:
            catalog.connector(view.backing[0]).drop_table(view.backing[1])
        return count_result("rows", 0)
    if isinstance(stmt, ast.RefreshMaterializedView):
        name = stmt.name.split(".")[-1]
        if name not in catalog.views or not catalog.views[name].materialized:
            raise KeyError(f"no such materialized view: {name}")
        rows = _refresh_materialized_view(name, catalog, plan, run, device)
        return count_result("rows", rows)
    if isinstance(stmt, ast.CallProcedure):
        cat, proc = _split_name(stmt.name, default_catalog_name)
        procs = catalog.connector(cat).get_procedures()
        if proc not in procs:
            raise KeyError(f"no such procedure: {cat}.{proc}")
        fn = procs[proc]
        # a procedure that places data takes the engine's device
        kwargs = ({"device": device}
                  if "device" in inspect.signature(fn).parameters else {})
        out = fn(*[_literal_value(a) for a in stmt.args], **kwargs)
        return text_result("result", [str(out)])
    if isinstance(stmt, ast.Analyze):
        return _analyze(stmt, catalog, default_catalog_name, device)
    if isinstance(stmt, ast.CreateTable):
        cat, table = _split_name(stmt.table, default_catalog_name)
        catalog.connector(cat).create_table(TableSchema(table, tuple(
            ColumnSchema(n, parse_type(t)) for n, t in stmt.columns)))
        return count_result("rows", 0)
    if isinstance(stmt, ast.DropTable):
        cat, table = _split_name(stmt.table, default_catalog_name)
        conn = catalog.connector(cat)
        try:
            conn.get_table_schema(table)
        except KeyError:
            if stmt.if_exists:
                return count_result("rows", 0)
            raise
        conn.drop_table(table)
        return count_result("rows", 0)
    if isinstance(stmt, ast.Delete):
        return _delete(stmt, catalog, default_catalog_name, plan, run,
                       device)
    return None


# ---------------------------------------------------------------------------
# the query lifecycle


def _output_rows(result: QueryResult) -> int:
    """The result's row count, kept on the result: a result with a live
    mask costs one counted device read the first time, and none when the
    result cache serves it again."""
    if result.output_rows is None:
        batch = result.batch
        if not batch.columns:
            result.output_rows = 0
        elif batch.live is None:  # a shape: no device read
            result.output_rows = batch.num_rows
        else:
            result.output_rows = int(
                SG.fetch(batch.live.sum(), "runner.output-rows"))
    return result.output_rows


def run_with_query_events(qid: str, sql: str, user: str,
                          listeners: EventListenerManager, tracer: Tracer,
                          thunk, device=None) -> QueryResult:
    """The query lifecycle around ``thunk`` (reference:
    runner.run_with_query_events, QueryMonitor's role): the created event,
    the ``system.runtime.queries`` record, the query metrics, the
    profiler's context, the root ``trino.query`` span; then, in this
    order, the wall and CPU times, the device memory watermark of
    ``device``, the finished record, the harvest of the query's profiler
    events and the completed event.  ``cpu_ms`` is process CPU over the
    query window.  The one device read is the output row count of a
    result with a live mask (:func:`_output_rows`), counted by
    exec/syncguard.py under ``runner.output-rows`` after the query's own
    sync window; a result-cache hit reuses the count and reads nothing.
    After the harvest the memo keys the query minted go to the warm-key
    journal (caching/executable_cache.py ``flush_warm_keys``; nothing is
    written when no key is new)."""
    listeners.query_created(QueryCreatedEvent(qid, sql, user))
    rec = rt.query_started(qid, sql, user)
    tm.QUERIES_STARTED.inc()
    prof_ctx = profiler.set_context(qid)
    t0 = time.perf_counter()
    cpu0 = time.process_time()

    def finish(state: str, rows: int, error, error_code=None) -> None:
        wall = (time.perf_counter() - t0) * 1e3
        cpu = (time.process_time() - cpu0) * 1e3
        tm.QUERY_WALL_SECONDS.record(wall / 1e3)
        (tm.QUERIES_FINISHED if state == "FINISHED"
         else tm.QUERIES_FAILED).inc()
        peak = tm.update_device_memory_watermark(device) or 0
        rt.query_finished(rec, state, wall, cpu, rows, error,
                          peak_memory_bytes=peak)
        # the rings' events move into the bounded per-query profile store
        # before the rings can wrap
        profiler.harvest(qid)
        # the warm-key journal: persist the memo keys this query minted so
        # a worker booted later can re-instantiate them
        executable_cache.flush_warm_keys()
        profiler.apply_context(prof_ctx)
        listeners.query_completed(QueryCompletedEvent(
            qid, sql, state, user, wall, rows, error,
            cpu_ms=cpu, peak_memory_bytes=peak,
            input_rows=rec.input_rows, input_bytes=rec.input_bytes,
            retry_count=rec.retry_count, queued_time_ms=rec.queued_ms,
            resource_group=rec.resource_group,
            speculative_wins=rec.speculative_wins, error_code=error_code))

    try:
        with tracer.span("trino.query", query_id=qid):
            result = thunk()
    except BaseException as e:
        finish("FAILED", -1, str(e), error_code=classify(e).code.name)
        raise
    finish("FINISHED", _output_rows(result), None)
    return result


# ---------------------------------------------------------------------------
# the runner


class StandaloneQueryRunner:
    """``session`` (a :class:`Session`) carries the properties; the
    arguments ``default_catalog_name``, ``splits_per_node`` and
    ``dynamic_filtering``, when given, fill it in."""

    def __init__(self, catalog: Optional[Catalog] = None,
                 device="cuda", default_catalog_name: Optional[str] = None,
                 splits_per_node: Optional[int] = None,
                 optimizer: str = "iterative",
                 dynamic_filtering: Optional[bool] = None,
                 ingest: Optional[IngestConfig] = None,
                 encoded_exec: bool = True,
                 session: Optional[Session] = None):
        if optimizer not in OPTIMIZER_MODES:
            raise ValueError(f"unknown optimizer {optimizer!r}; expected "
                             f"one of {OPTIMIZER_MODES}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "StandaloneQueryRunner(device='cuda'): CUDA is not "
                "available; pass device='cpu' to run on the CPU")
        self.catalog = catalog if catalog is not None else default_catalog()
        self.session = session if session is not None else Session()
        for name, value in (("default_catalog", default_catalog_name),
                            ("splits_per_node", splits_per_node),
                            ("dynamic_filtering", dynamic_filtering)):
            if value is not None:
                setattr(self.session, name, value)
        self.access_control = AccessControlManager()
        self.optimizer = optimizer
        self.ingest = ingest if ingest is not None else IngestConfig()
        self.encoded_exec = encoded_exec
        # what selects how a plan executes: part of every cache key, so a
        # CPU runner's plans and results never reach a CUDA runner
        self.execution_key = (optimizer, encoded_exec,
                              dataclasses.astuple(self.ingest),
                              str(self.device))
        self.tracer = Tracer()
        self.event_listeners = EventListenerManager()
        self._qids = itertools.count(1)
        sysconn = self.catalog._connectors.get("system")
        if sysconn is not None and hasattr(sysconn, "attach"):
            sysconn.attach(self)
        j = journal.get_journal()
        if j is not None:
            self.event_listeners.add(j)

    def create_plan(self, sql: str) -> PlanNode:
        return self._plan(parse_statement(sql))

    def _plan(self, stmt) -> PlanNode:
        with self.tracer.span("trino.planner"):
            plan = LogicalPlanner(self.catalog, self.session.default_catalog,
                                  self.optimizer).plan(stmt)
            plan = optimize(plan, self.catalog, self.optimizer)
        check_select_access(plan, self.access_control, self.session.user)
        return plan

    def explain(self, sql: str) -> str:
        return plan_text(self.create_plan(sql))

    def execute(self, sql: str, stats: Optional[QueryStats] = None,
                query_id: Optional[str] = None) -> QueryResult:
        """Run one statement; ``stats`` (optional) collects per-operator
        times, rows and batches of a query, and its scan and encoding
        roll-ups, and bypasses the plan and result caches.  An explicit
        ``query_id`` names the query in the registries, the journal and
        the profile."""
        return run_with_query_events(
            query_id or f"sq_{next(self._qids)}", sql, self.session.user,
            self.event_listeners, self.tracer,
            lambda: self._execute(sql, stats), device=self.device)

    def profile(self, query_id: str) -> Optional[dict]:
        """Chrome trace_event JSON of a profiled query
        (telemetry/profiler.py), or None when unknown."""
        return profiler.chrome_trace(query_id)

    def _execute(self, sql: str,
                 stats: Optional[QueryStats]) -> QueryResult:
        # Tier A: a cached plan skips parse -> plan -> optimize (only
        # statements that were planned are stored, so DDL, session and
        # transaction texts always miss)
        if stats is None:
            entry = plan_cache.lookup(sql, self.session, self.catalog,
                                      self.execution_key)
            if entry is not None:
                return self._execute_cached_plan(entry)
        stmt = parse_statement(sql)
        session = self.session
        if handle_transaction_stmt(stmt, session, self.catalog):
            return count_result("rows", 0)
        check_ddl_access(stmt, self.access_control, session.user,
                         session.default_catalog)
        out = execute_session_stmt(stmt, session)
        if out is not None:
            return out
        if isinstance(stmt, ast.Explain):
            return self._execute_explain(stmt)
        if isinstance(stmt, ast.ShowTables):
            conn = self.catalog.connector(session.default_catalog)
            return text_result("Table", sorted(
                list(conn.list_tables()) + list(self.catalog.views)))
        if isinstance(stmt, ast.ShowColumns):
            _cat, _table, schema = self.catalog.resolve_table(
                stmt.table, session.default_catalog)
            return text_result(
                "Column", [f"{c.name} {c.type}" for c in schema.columns])
        out = execute_ddl(stmt, self.catalog, session.default_catalog,
                          self._plan, lambda p: self._run(p, None),
                          self.device)
        if out is not None:
            return out
        plan = self._plan(stmt)
        if stats is not None:
            return self._run(plan, stats)
        entry = plan_cache.store(sql, session, self.catalog, plan,
                                 self.execution_key)
        # Tier C: the version vector is captured BEFORE executing, so a
        # write racing the read strands the entry under a stale key
        # instead of publishing stale data as fresh
        key = result_cache.result_key(
            entry, result_cache.version_vector(entry.tables, self.catalog))
        result = self._run(plan, None)
        result_cache.store(key, result, entry.tables)
        return result

    def _execute_cached_plan(self, entry) -> QueryResult:
        """Run from a Tier-A hit: re-check access (the key holds session
        knobs, not identity), try Tier C, else execute a private clone of
        the cached tree and publish its result."""
        check_select_access(entry.plan, self.access_control,
                            self.session.user)
        key = result_cache.result_key(
            entry, result_cache.version_vector(entry.tables, self.catalog))
        cached = result_cache.lookup(key)
        if cached is not None:
            return cached
        result = self._run(plan_cache.clone(entry.plan), None)
        result_cache.store(key, result, entry.tables)
        return result

    def _execute_explain(self, stmt: ast.Explain) -> QueryResult:
        """EXPLAIN -> the plan text and the iterative optimizer's rule
        firings (timing-free); EXPLAIN ANALYZE also gives the planning ms,
        then runs the plan and appends its wall time and per-operator
        stats (reference: runner._execute_explain)."""
        plan = self._plan(stmt.statement)
        lines = plan_text(plan).splitlines()
        if self.optimizer == "iterative":
            lines.extend(last_report().lines(timings=stmt.analyze))
        if stmt.analyze:
            stats = QueryStats()
            t0 = time.perf_counter()
            self._run(plan, stats)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            lines.append(f"total: {(time.perf_counter() - t0) * 1e3:.1f} ms")
            lines.extend(stats.text().splitlines())
        return text_result("Query Plan", lines)

    def _run(self, plan: PlanNode,
             stats: Optional[QueryStats]) -> QueryResult:
        session = self.session
        local = LocalPlanner(self.catalog, self.device,
                             splits_per_node=session.splits_per_node,
                             node_count=session.node_count,
                             dynamic_filtering=session.dynamic_filtering,
                             ingest=self.ingest,
                             encoded_exec=self.encoded_exec,
                             hbm_limit_bytes=session.hbm_limit_bytes,
                             task_concurrency=session.task_concurrency,
                             spill_to_disk_bytes=session.spill_to_disk_bytes
                             ).plan(plan)
        sync_before = SG.snapshot()
        with self.tracer.span("trino.execution") as span:
            run_pipelines(local.pipelines, stats)
            ingest = collect_scan_stats(local.pipelines)
            sync = SG.take_delta(sync_before)
            annotate_scan_span(span, ingest)
            annotate_sync_span(span, sync)
        tm.observe_scan(ingest)
        tm.observe_sync(sync)
        tm.observe_encoding(collect_encoding_stats(local.pipelines))
        if ingest is not None:
            rt.add_input(rt.current_record(), ingest.scan_rows,
                         ingest.scan_bytes)
        batches = local.collector.batches
        if batches:
            batch = ColumnBatch.concat(batches)
        else:
            batch = ColumnBatch(local.output_names, [
                Column(t, np.empty(0, t.storage_dtype))
                for t in local.output_types])
        return QueryResult(local.output_names, batch)

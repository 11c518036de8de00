"""DistributedQueryRunner: coordinator + N workers in one process.

The port of the streaming core of the reference
``execution/distributed_runner.py`` (DistributedQueryRunner.java:101 boots
a coordinator and N workers in one JVM; PipelinedQueryScheduler.java:157
activates every stage at once).  ``planner/add_exchanges`` places the
REMOTE exchanges, ``execution/fragmenter`` cuts the plan into fragments,
and every fragment runs as ``task_count`` concurrent tasks that stream
pages to each other through pull-token OutputBuffers
(``execution/exchange.py``, ``execution/task.py``); the root (OUTPUT)
fragment's buffer feeds the client.  A REPARTITION edge between equal task
counts runs as a device collective (``execution/collective_exchange.py``)
when ``Session.use_collectives`` is on; the choice is made when the query
is scheduled, never as a recovery from a failure.  Tasks run on a thread
each (``task_scheduler = "THREADS"``) or on the time-sharing executor
(``"TIME_SHARING"``, exec/executor.py).

Every task plans and runs on the runner's ``device``: on the card the
tasks share it, and the pages between them stay device batches unless
``exchange_serde`` turns them into wire bytes.  ``device="cuda"`` (the
default) raises when CUDA is not available.

Each task records the reference's lifecycle telemetry: the task counters
and wall distribution, a ``system.runtime.tasks`` record, a ``trino.task``
span under the query's span and the profiler's TASK event.

Not ported yet (ROADMAP queue 1 item 6), and refused with
NotImplementedError: fault-tolerant execution (``retry_policy`` other
than NONE, ``fte_run_attempt`` / ``resume_fte_query``), speculation, the
adaptive plane and worker drains.  The fragmenter's fused seams and
resident plans are recorded but not compiled: every edge runs as the
reference's does under ``TRINO_TPU_FUSED_STAGE=0`` and
``TRINO_TPU_RESIDENT_PLAN=0``.  History-based optimization waits for
``planner/history.py``.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..caching import plan_cache, result_cache
from ..connectors.catalog import Catalog, default_catalog
from ..exec import syncguard as SG
from ..exec.driver import (collect_encoding_stats, collect_scan_stats,
                           run_pipelines)
from ..exec.local_planner import LocalPlanner
from ..exec.stats import QueryStats
from ..parallel.distributed import Mesh
from ..planner.add_exchanges import add_exchanges
from ..planner.logical import LogicalPlanner
from ..planner.optimizer import optimize
from ..planner.plan import PlanNode
from ..runner import (QueryResult, Session, check_ddl_access,
                      check_select_access, count_result, execute_ddl,
                      execute_session_stmt, run_with_query_events,
                      text_result)
from ..spi.batch import Column, ColumnBatch
from ..spi.eventlistener import EventListenerManager
from ..spi.security import AccessControlManager
from ..sql import ast
from ..sql.parser import parse_statement
from ..telemetry import journal, profiler
from ..telemetry import metrics as tm
from ..telemetry import runtime as rt
from .collective_exchange import (CollectiveOutputSink,
                                  CollectiveRepartitionExchange,
                                  collectives_available)
from .exchange import ExchangeClient, OutputBuffer
from .fragmenter import PlanFragment, SubPlan, fragment_plan
from .task import STALL_TIMEOUT_S, PartitionedOutputSink, maybe_deserialize
from .tracing import Tracer, annotate_scan_span, annotate_sync_span
from .transaction import handle_transaction_stmt

__all__ = ["DistributedQueryRunner"]

# Byte budget of each task's output buffer (the reference's default; a
# full buffer blocks its producer, or parks it under TIME_SHARING).
SINK_MAX_BYTES = 256 << 20

_ITEM6 = ("is not ported yet (ROADMAP queue 1 item 6: the rest of the "
          "distributed runner and the control plane)")


@dataclass
class _Stage:
    fragment: PlanFragment
    task_count: int
    buffers: list  # one OutputBuffer per task


class DistributedQueryRunner:
    """``worker_count`` in-process workers on ``device``; ``session``
    defaults to ``Session(node_count=worker_count)``.  Tasks plan with the
    iterative optimizer and the default scan (IngestConfig(), encoded
    execution), as the StandaloneQueryRunner does by default; the device
    and the worker count are the runner's :attr:`execution_key`."""

    def __init__(self, catalog: Optional[Catalog] = None,
                 worker_count: int = 3,
                 session: Optional[Session] = None,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DistributedQueryRunner(device='cuda'): CUDA is not "
                "available; pass device='cpu' to run on the CPU")
        self.catalog = catalog if catalog is not None else default_catalog()
        self.worker_count = worker_count
        self.session = session if session is not None else Session(
            node_count=worker_count)
        self.execution_key = (str(self.device), worker_count)
        self.tracer = Tracer()
        self.event_listeners = EventListenerManager()
        self.access_control = AccessControlManager()
        self._qids = itertools.count(1)
        j = journal.get_journal()
        if j is not None:
            self.event_listeners.add(j)
        # the last query's edges, for observability and tests; tasks get
        # the dict as an argument so concurrent queries cannot cross-wire
        self._collective_edges: dict = {}
        sysconn = self.catalog._connectors.get("system")
        if sysconn is not None and hasattr(sysconn, "attach"):
            sysconn.attach(self)

    # ------------------------------------------------------------------ plan
    def create_plan(self, sql: str) -> PlanNode:
        return self._plan_stmt(parse_statement(sql))

    def _plan_stmt(self, stmt: ast.Statement) -> PlanNode:
        with self.tracer.span("trino.planner"):
            plan = LogicalPlanner(self.catalog,
                                  self.session.default_catalog).plan(stmt)
            plan = optimize(plan, self.catalog)
        check_select_access(plan, self.access_control, self.session.user)
        writer_tasks = 1
        if self.session.get("scale_writers"):
            writer_tasks = max(1, min(self.session.get("writer_task_limit"),
                                      self.worker_count))
        return add_exchanges(plan, writer_tasks=writer_tasks)

    def create_subplan(self, sql: str) -> SubPlan:
        return fragment_plan(self.create_plan(sql))

    def explain(self, sql: str) -> str:
        return self.create_subplan(sql).text()

    # --------------------------------------------------------------- execute
    def execute(self, sql: str,
                query_id: Optional[str] = None) -> QueryResult:
        return run_with_query_events(
            query_id or f"dq_{next(self._qids)}", sql, self.session.user,
            self.event_listeners, self.tracer, lambda: self._execute(sql),
            device=self.device)

    def profile(self, query_id: str) -> Optional[dict]:
        """Chrome trace_event JSON of a profiled query's timeline, task
        threads included, or None when unknown."""
        return profiler.chrome_trace(query_id)

    def _execute(self, sql: str) -> QueryResult:
        # Tier A: a cached fragmented plan skips parse -> plan -> optimize ->
        # add_exchanges; only planned statements were stored
        entry = plan_cache.lookup(sql, self.session, self.catalog,
                                  self.execution_key, flavor="fragmented")
        if entry is not None:
            check_select_access(entry.plan, self.access_control,
                                self.session.user)
            key = result_cache.result_key(entry, result_cache.version_vector(
                entry.tables, self.catalog))
            cached = result_cache.lookup(key)
            if cached is not None:
                return cached
            out = self._execute_subplan(
                fragment_plan(plan_cache.clone(entry.plan)), None)
            result_cache.store(key, out, entry.tables)
            return out
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
            subplan = fragment_plan(self._plan_stmt(stmt.statement))
            lines = subplan.text().splitlines()
            if stmt.analyze:
                stats: list[QueryStats] = []
                self._execute_subplan(subplan, stats)
                for s in sorted(stats, key=lambda s: s.label):
                    lines.extend(s.text().splitlines())
            return text_result("Query Plan", lines)
        if isinstance(stmt, ast.ShowTables):
            conn = self.catalog.connector(session.default_catalog)
            return text_result("Table", conn.list_tables())
        if isinstance(stmt, ast.ShowColumns):
            _cat, _table, schema = self.catalog.resolve_table(
                stmt.table, session.default_catalog)
            return text_result(
                "Column", [f"{c.name} {c.type}" for c in schema.columns])
        out = execute_ddl(
            stmt, self.catalog, session.default_catalog, self._plan_stmt,
            lambda p: self._execute_subplan(fragment_plan(p), None),
            self.device)
        if out is not None:
            return out
        plan = self._plan_stmt(stmt)
        entry = plan_cache.store(sql, session, self.catalog, plan,
                                 self.execution_key, flavor="fragmented")
        # Tier C: the version vector is read BEFORE execution, so a racing
        # write strands the entry instead of publishing stale rows
        key = result_cache.result_key(
            entry, result_cache.version_vector(entry.tables, self.catalog))
        out = self._execute_subplan(fragment_plan(plan), None)
        result_cache.store(key, out, entry.tables)
        return out

    def _check_supported(self) -> None:
        s = self.session
        if s.get("retry_policy") != "NONE":
            raise NotImplementedError(
                f"retry_policy={s.get('retry_policy')!r}: fault-tolerant "
                f"execution {_ITEM6}")
        if s.get("speculation") not in (None, False):
            raise NotImplementedError(f"speculation {_ITEM6}")
        if s.get("adaptive") not in (None, False, 0, "0"):
            raise NotImplementedError(f"the adaptive plane {_ITEM6}")
        if s.task_scheduler not in ("THREADS", "TIME_SHARING"):
            raise ValueError(f"unknown task_scheduler {s.task_scheduler!r}")

    def _execute_subplan(self, subplan: SubPlan,
                         stats_sink: Optional[list]) -> QueryResult:
        self._check_supported()
        sync_before = SG.snapshot()
        with self.tracer.span("trino.execution") as span:
            out = self._run_streaming(subplan, stats_sink)
            sync = SG.take_delta(sync_before)
            annotate_sync_span(span, sync)
        tm.observe_sync(sync)
        return out

    # ------------------------------------------------------ not ported yet
    def fte_run_attempt(self, *args, **kwargs):
        raise NotImplementedError(f"fault-tolerant execution {_ITEM6}")

    def resume_fte_query(self, *args, **kwargs):
        raise NotImplementedError(f"fault-tolerant execution {_ITEM6}")

    def drain_worker(self, node_id: str) -> dict:
        raise NotImplementedError(f"worker drains {_ITEM6}")

    def restore_worker(self, node_id: str) -> None:
        raise NotImplementedError(f"worker drains {_ITEM6}")

    # ------------------------------------------------------------ scheduling
    @property
    def active_worker_count(self) -> int:
        """Every in-process worker (the control plane's membership and
        failure detection are not ported)."""
        return self.worker_count

    def stage_task_counts(self, fragments) -> tuple[dict, dict]:
        """(fragment -> task count, fragment -> consumer task count); the
        output-buffer partition count of a fragment is its consumer's task
        count (the root's consumer is the client: 1)."""
        workers = self.active_worker_count
        writer_cap = max(1, min(self.session.get("writer_task_limit"),
                                workers))
        task_counts = {}
        for f in fragments:
            if f.partitioning == "SINGLE":
                task_counts[f.id] = 1
            elif f.partitioning == "ARBITRARY":
                # scaled-writer fragments honor the configured writer limit
                task_counts[f.id] = writer_cap
            else:
                task_counts[f.id] = workers
        consumer_tasks: dict[int, int] = {}
        for f in fragments:
            for src in f.source_fragments:
                consumer_tasks[src] = task_counts[f.id]
        return task_counts, consumer_tasks

    def _run_streaming(self, subplan: SubPlan,
                       stats_sink: Optional[list]) -> QueryResult:
        fragments = subplan.all_fragments()
        task_counts, consumer_tasks = self.stage_task_counts(fragments)
        stages = {f.id: _Stage(f, task_counts[f.id], []) for f in fragments}
        for f in fragments:
            nparts = consumer_tasks.get(f.id, 1)
            stages[f.id].buffers = [OutputBuffer(nparts,
                                                 max_bytes=SINK_MAX_BYTES)
                                    for _ in range(stages[f.id].task_count)]
        # device-collective REPARTITION edges where producer and consumer
        # task counts line up; host buffers carry every other edge.  Every
        # task plans and runs on the runner's device, so every shard of
        # the edge's mesh lies there too.
        collective: dict[int, CollectiveRepartitionExchange] = {}
        if self.session.use_collectives:
            for f in fragments:
                tc = stages[f.id].task_count
                if (f.output_kind == "REPARTITION"
                        and consumer_tasks.get(f.id) == tc
                        and collectives_available(tc)):
                    collective[f.id] = CollectiveRepartitionExchange(
                        tc, f.output_keys, f.root.output_names,
                        f.root.output_types, Mesh([self.device] * tc))
        self._collective_edges = collective

        errors: list[BaseException] = []
        if self.session.task_scheduler == "TIME_SHARING":
            hung = self._run_time_sharing(fragments, stages, errors,
                                          stats_sink, collective)
        else:
            hung = self._run_threads(fragments, stages, errors, stats_sink,
                                     collective)
        if errors or hung:
            self._abort(stages, collective)
            if errors:
                raise errors[0]
            raise TimeoutError(f"tasks did not complete: {hung}")

        # drain the root stage's buffer as the client
        root = stages[subplan.fragment.id]
        client = ExchangeClient(root.buffers, 0)
        batches = []
        while not client.is_finished():
            b = client.poll(timeout=0.2)
            if b is not None:
                batches.append(maybe_deserialize(b, self.device))
        return self._to_result(subplan, batches)

    @staticmethod
    def _abort(stages: dict, collective: dict) -> None:
        """Unblock every task of the query: producers waiting on a full
        buffer, consumers polling a dead producer, partners parked at a
        collective."""
        for s in stages.values():
            for b in s.buffers:
                b.abort()
        for ex in collective.values():
            ex.abort()

    def _run_threads(self, fragments, stages, errors, stats_sink,
                     collective) -> list[str]:
        """A thread per task; returns the names of tasks still running at
        the deadline."""
        # task spans nest under the coordinator thread's open span
        parent_span = self.tracer.current()
        qrec = rt.current_record()
        threads = []
        for f in fragments:
            stage = stages[f.id]
            for t in range(stage.task_count):
                th = threading.Thread(
                    target=self._run_task,
                    args=(stage, t, stages, errors, stats_sink, collective,
                          parent_span, qrec),
                    name=f"task-{f.id}.{t}", daemon=True)
                th.start()
                threads.append(th)
        deadline = time.monotonic() + 2 * STALL_TIMEOUT_S
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))
        return [th.name for th in threads if th.is_alive()]

    def _to_result(self, subplan: SubPlan, batches: list) -> QueryResult:
        names = list(subplan.fragment.root.output_names)
        types = list(subplan.fragment.root.output_types)
        if batches:
            return QueryResult(names, ColumnBatch.concat(batches))
        return QueryResult(names, ColumnBatch(names, [
            Column(t, np.empty(0, t.storage_dtype)) for t in types]))

    def _build_task(self, stage: _Stage, task_index: int, stages: dict,
                    stats_sink: Optional[list], collective: dict
                    ) -> tuple[list, Optional[QueryStats]]:
        f = stage.fragment
        clients: dict = {}
        for src in f.source_fragments:
            if src in collective:
                clients[src] = collective[src]
            elif stages[src].fragment.output_kind == "MERGE":
                # order-preserving gather: one client PER producer so the
                # merge operator sees each task's sorted stream separately
                clients[src] = [ExchangeClient([b], task_index)
                                for b in stages[src].buffers]
            else:
                clients[src] = ExchangeClient(stages[src].buffers,
                                              task_index)
        s = self.session
        planner = LocalPlanner(
            self.catalog, self.device, splits_per_node=s.splits_per_node,
            node_count=self.worker_count,
            dynamic_filtering=s.dynamic_filtering,
            hbm_limit_bytes=s.hbm_limit_bytes,
            task_concurrency=s.task_concurrency,
            spill_to_disk_bytes=s.spill_to_disk_bytes,
            task_index=task_index, task_count=stage.task_count,
            remote_clients=clients)
        local = planner.plan(f.root)
        ex = collective.get(f.id)
        if ex is not None:
            sink = CollectiveOutputSink(ex, task_index)
        else:
            kind = f.output_kind if f.output_kind != "OUTPUT" else "GATHER"
            sink = PartitionedOutputSink(
                stage.buffers[task_index], kind, f.output_keys,
                serde=s.exchange_serde, coalesce_rows=f.sink_coalesce_rows)
        # the task's output sink takes the collector's place
        local.pipelines[-1][-1] = sink
        stats = None
        if stats_sink is not None:
            stats = QueryStats(label=f"fragment {f.id} task {task_index}:")
            stats_sink.append(stats)  # list.append is thread-safe
        return local.pipelines, stats

    def _run_time_sharing(self, fragments, stages, errors, stats_sink,
                          collective) -> list[str]:
        """Schedule every task on a bounded MLFQ executor
        (exec/executor.py); returns the names of tasks that never
        finished."""
        from ..exec.executor import TimeSharingTaskExecutor

        executor = TimeSharingTaskExecutor(self.session.executor_workers)
        try:
            handles = []
            try:
                for f in fragments:
                    stage = stages[f.id]
                    for t in range(stage.task_count):
                        pipelines, stats = self._build_task(
                            stage, t, stages, stats_sink, collective)
                        handles.append(
                            (f, t, executor.submit(pipelines, stats)))
            except BaseException:
                # a task that failed to build must not leave its submitted
                # siblings blocked on its buffers
                self._abort(stages, collective)
                raise
            # poll every handle so the first failure aborts all buffers
            # at once (as the thread-per-task mode does)
            deadline = time.monotonic() + 2 * STALL_TIMEOUT_S
            pending = list(range(len(handles)))
            while pending and time.monotonic() < deadline:
                still = []
                for i in pending:
                    h = handles[i][2]
                    if not h.done.is_set():
                        still.append(i)
                    elif h.error is not None:
                        errors.append(h.error)
                        self._abort(stages, collective)
                if len(still) == len(pending):
                    time.sleep(0.02)
                pending = still
            return [f"task-{handles[i][0].id}.{handles[i][1]}"
                    for i in pending]
        finally:
            executor.shutdown()

    def _run_task(self, stage: _Stage, task_index: int, stages: dict,
                  errors: list, stats_sink: Optional[list],
                  collective: dict, parent_span=None,
                  query_record=None) -> None:
        """One task on its thread, with the task lifecycle's telemetry
        (reference: distributed_runner.py _run_task): the task counters and
        wall distribution, the ``system.runtime.tasks`` record, the
        ``trino.task`` span and the profiler's TASK event.  A failure
        aborts every buffer and collective of the query."""
        rt.adopt_record(query_record)
        tm.TASKS_CREATED.inc()
        trec = rt.task_started(
            query_record.query_id if query_record is not None else "",
            f"f{stage.fragment.id}.t{task_index}", stage.fragment.id,
            task_index, "local")
        # task threads are fresh per task: stamp the query / task identity
        # so every driver and exchange event of this thread attributes
        profiler.set_context(trec.query_id, trec.task_id)
        pt0 = profiler.now()
        t0 = time.perf_counter()
        pipelines = None
        state = "FINISHED"
        err = None
        with self.tracer.span(
                "trino.task", parent=parent_span,
                **{"trino.task.id": trec.task_id,
                   "trino.task.worker": "local"}) as sp:
            try:
                pipelines, stats = self._build_task(
                    stage, task_index, stages, stats_sink, collective)
                run_pipelines(pipelines, stats)
            except BaseException as e:  # noqa: BLE001 — surfaced to the
                # coordinator
                errors.append(e)
                state = "FAILED"
                err = f"{type(e).__name__}: {e}"
                sp.set("error", type(e).__name__)
                self._abort(stages, collective)
            ingest = collect_scan_stats(pipelines) if pipelines else None
            if pipelines:
                tm.observe_encoding(collect_encoding_stats(pipelines))
            if ingest is not None:
                annotate_scan_span(sp, ingest)
                tm.observe_scan(ingest)
                if query_record is not None:
                    rt.add_input(query_record, ingest.scan_rows,
                                 ingest.scan_bytes)
        tm.TASK_WALL_SECONDS.record(time.perf_counter() - t0)
        profiler.event(profiler.TASK, trec.task_id, pt0, state=state)
        if state == "FAILED":
            tm.TASKS_FAILED.inc()
        rt.task_finished(trec, state, error=err)

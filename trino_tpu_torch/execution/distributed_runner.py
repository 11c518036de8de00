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

Before the collective edges, the fragmenter's marks are compiled, as in
the reference by default: a fused seam (PARTIAL -> shuffle -> FINAL) runs
as one accumulate call per batch and one seam merge
(``execution/stage_compiler.py``), and a resident plan (a broadcast join
tree under such a seam) as one whole-plan call per probe batch
(``execution/plan_compiler.py``); ``TRINO_TPU_FUSED_STAGE=0`` /
``TRINO_TPU_RESIDENT_PLAN=0`` turn them off.  The one failure they
recover from is :class:`~.stage_compiler.FusedStageOverflow` (a task held
more groups than the state's cap, or a resident build had duplicate
keys): the query re-runs with both off, on the same device, counted in
``fused_fallbacks`` / ``resident_fallbacks``, the ``*_FALLBACKS`` metrics
and a stats line.  Any other error fails the query.

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
adaptive plane and worker drains.  History-based optimization waits for
``planner/history.py``.
"""

from __future__ import annotations

import dataclasses
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
from ..exec.prefetch import IngestConfig
from ..exec.stats import FusedStageStats, QueryStats, ResidentPlanStats
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
from .plan_compiler import (ResidentBuildHandle, ResidentBuildSinkOperator,
                            ResidentPlanExec, ResidentPlanOverflow,
                            ResidentPlanSinkOperator, plan_resident_plans)
from .stage_compiler import (FusedStageExec, FusedStageOverflow,
                             FusedStageSinkOperator, plan_fused_stages)
from .task import STALL_TIMEOUT_S, PartitionedOutputSink, maybe_deserialize
from .tracing import (Tracer, annotate_fused_span, annotate_resident_span,
                      annotate_scan_span, annotate_sync_span)
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
    iterative optimizer, encoded execution and the scan ``ingest`` (the
    port-only argument of the StandaloneQueryRunner, by default
    ``IngestConfig()``); the device, the worker count and the ingest are
    the runner's :attr:`execution_key`."""

    def __init__(self, catalog: Optional[Catalog] = None,
                 worker_count: int = 3,
                 session: Optional[Session] = None,
                 device="cuda", ingest: Optional[IngestConfig] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DistributedQueryRunner(device='cuda'): CUDA is not "
                "available; pass device='cpu' to run on the CPU")
        self.catalog = catalog if catalog is not None else default_catalog()
        self.worker_count = worker_count
        self.session = session if session is not None else Session(
            node_count=worker_count)
        self.ingest = ingest if ingest is not None else IngestConfig()
        self.execution_key = (str(self.device), worker_count,
                              dataclasses.astuple(self.ingest))
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
        self._fused_edges: dict = {}
        self._resident_edges: dict = {}
        # re-runs on the per-operator path after a compiled stage's
        # overflow, and the last query's reason for one (None: no re-run)
        self.fused_fallbacks = 0
        self.resident_fallbacks = 0
        self.last_fallback: Optional[str] = None
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

    def _run_streaming(self, subplan: SubPlan, stats_sink: Optional[list],
                       use_fused: bool = True) -> QueryResult:
        fragments = subplan.all_fragments()
        if use_fused:
            self.last_fallback = None
        task_counts, consumer_tasks = self.stage_task_counts(fragments)
        stages = {f.id: _Stage(f, task_counts[f.id], []) for f in fragments}
        for f in fragments:
            nparts = consumer_tasks.get(f.id, 1)
            stages[f.id].buffers = [OutputBuffer(nparts,
                                                 max_bytes=SINK_MAX_BYTES)
                                    for _ in range(stages[f.id].task_count)]
        # whole-stage and whole-query compilation first: a resident plan
        # takes its core fragment's fused seam
        fused: dict = {}
        resident: dict = {}
        if use_fused:
            fused = plan_fused_stages(fragments, self.session, task_counts,
                                      consumer_tasks, self.device)
            resident = plan_resident_plans(fragments, self.session,
                                           task_counts, consumer_tasks,
                                           self.device)
            for fid in resident:
                fused.pop(fid, None)
        # device-collective REPARTITION edges where producer and consumer
        # task counts line up; host buffers carry every other edge.  Every
        # task plans and runs on the runner's device, so every shard of
        # the edge's mesh lies there too.
        collective: dict[int, CollectiveRepartitionExchange] = {}
        if self.session.use_collectives:
            for f in fragments:
                tc = stages[f.id].task_count
                if (f.id not in fused and f.id not in resident
                        and f.output_kind == "REPARTITION"
                        and consumer_tasks.get(f.id) == tc
                        and collectives_available(tc)):
                    collective[f.id] = CollectiveRepartitionExchange(
                        tc, f.output_keys, f.root.output_names,
                        f.root.output_types, Mesh([self.device] * tc))
        self._collective_edges = collective
        self._fused_edges = fused
        self._resident_edges = resident
        edges = {**collective, **fused, **resident}

        errors: list[BaseException] = []
        if self.session.task_scheduler == "TIME_SHARING":
            hung = self._run_time_sharing(fragments, stages, errors,
                                          stats_sink, edges)
        else:
            hung = self._run_threads(fragments, stages, errors, stats_sink,
                                     edges)
        if errors or hung:
            self._abort(stages, edges)
            if errors:
                if use_fused and any(isinstance(e, FusedStageOverflow)
                                     for e in errors):
                    self._count_fallback(errors, stats_sink)
                    return self._run_streaming(subplan, stats_sink,
                                               use_fused=False)
                raise errors[0]
            raise TimeoutError(f"tasks did not complete: {hung}")
        self._roll_compiled_stats(fused, resident, stats_sink)

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
    def _abort(stages: dict, edges: dict) -> None:
        """Unblock every task of the query: producers waiting on a full
        buffer, consumers polling a dead producer, partners parked at a
        collective edge or a compiled stage's rendezvous."""
        for s in stages.values():
            for b in s.buffers:
                b.abort()
        for ex in edges.values():
            ex.abort()

    def _count_fallback(self, errors: list, stats_sink) -> None:
        """Count the re-run a compiled stage's overflow takes (reference:
        distributed_runner.py, the FusedStageOverflow branch)."""
        res = [e for e in errors if isinstance(e, ResidentPlanOverflow)]
        self.last_fallback = str(
            next(e for e in errors if isinstance(e, FusedStageOverflow)))
        if res:
            self.resident_fallbacks += 1
            tm.RESIDENT_FALLBACKS.inc()
            if stats_sink is not None:
                stats_sink.append(QueryStats(
                    label="resident plans:", resident=ResidentPlanStats(
                        fallbacks=1,
                        fallback_reasons=[str(res[0])[:120]])))
        else:
            self.fused_fallbacks += 1
            tm.FUSED_FALLBACKS.inc()
            if stats_sink is not None:
                stats_sink.append(QueryStats(
                    label="fused stages:",
                    fused=FusedStageStats(fallbacks=1)))

    def _roll_compiled_stats(self, fused: dict, resident: dict,
                             stats_sink) -> None:
        """The compiled stages' roll-ups into the metrics, the execution
        span and EXPLAIN ANALYZE's stats lines."""
        span = self.tracer.current()
        if fused:
            roll = FusedStageStats()
            for ex in fused.values():
                roll.merge(ex.stats)
            tm.observe_fused(roll)
            if span is not None:
                annotate_fused_span(span, roll)
            if stats_sink is not None:
                stats_sink.append(QueryStats(label="fused stages:",
                                             fused=roll))
        execs = [e for e in resident.values()
                 if isinstance(e, ResidentPlanExec)]
        if execs:
            rroll = ResidentPlanStats()
            for ex in execs:
                rroll.merge(ex.rstats)
            tm.observe_resident(rroll)
            if span is not None:
                annotate_resident_span(span, rroll)
            if stats_sink is not None:
                stats_sink.append(QueryStats(label="resident plans:",
                                             resident=rroll))

    def _run_threads(self, fragments, stages, errors, stats_sink,
                     edges) -> list[str]:
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
                    args=(stage, t, stages, errors, stats_sink, edges,
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
                    stats_sink: Optional[list], edges: dict
                    ) -> tuple[list, Optional[QueryStats]]:
        f = stage.fragment
        clients: dict = {}
        for src in f.source_fragments:
            if src in edges:
                clients[src] = edges[src]
            elif stages[src].fragment.output_kind == "MERGE":
                # order-preserving gather: one client PER producer so the
                # merge operator sees each task's sorted stream separately
                clients[src] = [ExchangeClient([b], task_index)
                                for b in stages[src].buffers]
            else:
                clients[src] = ExchangeClient(stages[src].buffers,
                                              task_index)
        s = self.session
        ex = edges.get(f.id)
        planner = LocalPlanner(
            self.catalog, self.device, splits_per_node=s.splits_per_node,
            node_count=self.worker_count,
            dynamic_filtering=s.dynamic_filtering,
            hbm_limit_bytes=s.hbm_limit_bytes,
            task_concurrency=s.task_concurrency,
            spill_to_disk_bytes=s.spill_to_disk_bytes, ingest=self.ingest,
            task_index=task_index, task_count=stage.task_count,
            remote_clients=clients)
        # a fused producer plans only its feed (the chain, the PARTIAL
        # aggregation and the shuffle run in the fused sink's programs); a
        # resident core only the scan feed below its join spine
        if isinstance(ex, ResidentPlanExec):
            local = planner.plan(ex.spec.feed)
            sink = ResidentPlanSinkOperator(ex, task_index)
        elif isinstance(ex, ResidentBuildHandle):
            local = planner.plan(f.root)
            sink = ResidentBuildSinkOperator(ex, task_index)
        elif isinstance(ex, FusedStageExec):
            local = planner.plan(ex.spec.feed)
            sink = FusedStageSinkOperator(ex, task_index)
        elif ex is not None:
            local = planner.plan(f.root)
            sink = CollectiveOutputSink(ex, task_index)
        else:
            local = planner.plan(f.root)
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
                          edges) -> list[str]:
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
                            stage, t, stages, stats_sink, edges)
                        handles.append(
                            (f, t, executor.submit(pipelines, stats)))
            except BaseException:
                # a task that failed to build must not leave its submitted
                # siblings blocked on its buffers
                self._abort(stages, edges)
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
                        self._abort(stages, edges)
                if len(still) == len(pending):
                    time.sleep(0.02)
                pending = still
            return [f"task-{handles[i][0].id}.{handles[i][1]}"
                    for i in pending]
        finally:
            executor.shutdown()

    def _run_task(self, stage: _Stage, task_index: int, stages: dict,
                  errors: list, stats_sink: Optional[list],
                  edges: dict, parent_span=None,
                  query_record=None) -> None:
        """One task on its thread, with the task lifecycle's telemetry
        (reference: distributed_runner.py _run_task): the task counters and
        wall distribution, the ``system.runtime.tasks`` record, the
        ``trino.task`` span and the profiler's TASK event.  A failure
        aborts every buffer and edge of the query."""
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
                    stage, task_index, stages, stats_sink, edges)
                run_pipelines(pipelines, stats)
            except BaseException as e:  # noqa: BLE001 — surfaced to the
                # coordinator
                errors.append(e)
                state = "FAILED"
                err = f"{type(e).__name__}: {e}"
                sp.set("error", type(e).__name__)
                self._abort(stages, edges)
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

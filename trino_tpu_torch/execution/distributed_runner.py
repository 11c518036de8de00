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
and a stats line.  Any other error fails the query (or, under
``retry_policy``, goes to its recovery below).

Every task plans and runs on the runner's ``device``: on the card the
tasks share it, and the pages between them stay device batches unless
``exchange_serde`` turns them into wire bytes.  ``device="cuda"`` (the
default) raises when CUDA is not available.

Each task records the reference's lifecycle telemetry: the task counters
and wall distribution, a ``system.runtime.tasks`` record, a ``trino.task``
span under the query's span and the profiler's TASK event.

At the end of every successful streaming query the runner records each
fragment's observed output (rows, bytes, partial-aggregation groups,
probe skew) as journal ``plan_stats`` keyed by logical fingerprints
(planner/history.py), and later plans, standalone ones too, cost joins
and aggregations from them; ``stage_task_counts`` shrinks a hash stage's
fan-out when history says its input is small.  ``TRINO_TPU_HBO=0`` turns
both sides off.

With the thread-per-task scheduler the adaptive plane
(execution/adaptive.py) runs where the plan has a join decision site
(``TRINO_TPU_ADAPTIVE=auto``, the default): phased activation, the
barrier's PARTITIONED<->BROADCAST flips from observed build bytes and
skew splits from the probe's heavy-hitter sketch.  Streaming straggler
speculation (execution/speculation.py) twins a lagging task when
``speculation`` is on.

``retry_policy`` selects the recovery: ``NONE`` streams and fails on the
first error; ``QUERY`` re-runs the whole subplan on a retryable error,
with deterministic backoff (``_run_query_retry``); ``TASK`` runs
fault-tolerant execution (execution/fte.py): stage by stage over a
durable spool with task retry, memory-aware retry and speculative twins,
logged to a write-ahead query-state log a fresh runner resumes from
(``pending_fte_recoveries`` / ``resume_fte_query``).  A retried task or
query runs again on the same device with the same kernels.

Not ported yet, and refused with NotImplementedError: worker drains
(``drain_worker`` / ``restore_worker``, the control plane, ROADMAP queue 1
item 4) and worker processes (``PROCESS_EXIT`` injection, item 5).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
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
from ..exec.stats import (FusedStageStats, QueryStats, ResidentPlanStats,
                          ResilienceStats)
from ..parallel.distributed import Mesh
from ..planner import history
from ..planner.add_exchanges import add_exchanges
from ..planner.logical import LogicalPlanner
from ..planner.optimizer import optimize
from ..planner.plan import PlanNode, TableWriter
from ..runner import (QueryResult, Session, check_ddl_access,
                      check_select_access, count_result, execute_ddl,
                      execute_session_stmt, run_with_query_events,
                      text_result)
from ..spi import knobs
from ..spi.batch import Column, ColumnBatch
from ..spi.errors import Backoff, classify
from ..spi.eventlistener import EventListenerManager
from ..spi.security import AccessControlManager
from ..sql import ast
from ..sql.parser import parse_statement
from ..telemetry import journal, profiler
from ..telemetry import metrics as tm
from ..telemetry import runtime as rt
from . import query_state, spool_gc
from .adaptive import AdaptiveExec, adaptive_mode
from .collective_exchange import (CollectiveOutputSink,
                                  CollectiveRepartitionExchange,
                                  collectives_available)
from .durable_spool import (DurableSpoolClient, DurableSpoolWriter,
                            make_spool_root)
from .exchange import ExchangeClient, OutputBuffer
from .failure_injector import GET_RESULTS_FAILURE, TASK_FAILURE
from .fragmenter import PlanFragment, SubPlan, fragment_plan
from .fte import fte_task_dir, run_fte_query
from .plan_compiler import (ResidentBuildHandle, ResidentBuildSinkOperator,
                            ResidentPlanExec, ResidentPlanOverflow,
                            ResidentPlanSinkOperator, plan_resident_plans)
from .speculation import (SPECULATIVE, STANDARD, ClusterBlacklist,
                          GatedBuffer, SpeculationLost, SpoolTeeBuffer,
                          StreamingSpeculation, StreamingSpoolTee,
                          nonleaf_speculation_enabled, speculation_enabled)
from .stage_compiler import (FusedStageExec, FusedStageOverflow,
                             FusedStageSinkOperator, plan_fused_stages)
from .task import STALL_TIMEOUT_S, PartitionedOutputSink, maybe_deserialize
from .tracing import (Tracer, annotate_fused_span, annotate_resident_span,
                      annotate_resilience_span, annotate_scan_span,
                      annotate_sync_span)
from .transaction import handle_transaction_stmt

__all__ = ["DistributedQueryRunner"]

# Byte budget of each task's output buffer (the reference's default; a
# full buffer blocks its producer, or parks it under TIME_SHARING).
SINK_MAX_BYTES = 256 << 20

_ITEM4 = ("is not ported yet (ROADMAP queue 1 item 4: the control plane, "
          "NodeManager and the failure-detector-driven membership)")


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
        # the last query's adaptive controller (None: the static plan ran)
        self.last_adaptive: Optional[AdaptiveExec] = None
        # query-level resilience (retry_policy=QUERY): cumulative counters
        # and an append-only log of retries, blacklists and speculation
        self.resilience = ResilienceStats()
        self.resilience_events: list = []
        # cross-query worker blacklist, journaled so a restart re-seeds it
        self.cluster_blacklist = ClusterBlacklist(
            ttl_s=self.session.blacklist_ttl_s,
            threshold=self.session.blacklist_threshold, persist=True)
        # cumulative streaming speculation outcomes
        self.speculative_starts = 0
        self.speculative_wins = 0
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
        if self.session.task_scheduler not in ("THREADS", "TIME_SHARING"):
            raise ValueError(
                f"unknown task_scheduler {self.session.task_scheduler!r}")

    def _execute_subplan(self, subplan: SubPlan,
                         stats_sink: Optional[list]) -> QueryResult:
        self._check_supported()
        sync_before = SG.snapshot()
        with self.tracer.span("trino.execution") as span:
            policy = self.session.retry_policy
            if policy == "TASK":
                out = self._to_result(subplan, run_fte_query(
                    self, subplan, stats_sink))
            elif policy == "QUERY":
                out = self._run_query_retry(subplan, stats_sink)
            else:
                out = self._run_streaming(subplan, stats_sink)
            sync = SG.take_delta(sync_before)
            annotate_sync_span(span, sync)
        tm.observe_sync(sync)
        return out

    def _run_query_retry(self, subplan: SubPlan,
                         stats_sink: Optional[list]) -> QueryResult:
        """retry_policy=QUERY: streaming execution with coordinator-level
        retry (the pipelined overlap is kept; the recovery unit is the
        whole query).  On a retryable failure: blacklist the implicated
        worker for this query, back off deterministically and re-run the
        subplan.  USER-classified errors fail fast, always."""
        sess = self.session
        before = ResilienceStats()
        before.merge(self.resilience)
        backoff = Backoff(min_delay_s=sess.retry_initial_delay_s,
                          max_delay_s=sess.retry_max_delay_s,
                          max_failure_duration_s=float("inf"))
        blacklist: set = set()
        attempts = 1 + max(0, int(sess.query_retry_attempts))
        try:
            for attempt in range(attempts):
                try:
                    return self._run_streaming(subplan, stats_sink,
                                               attempt=attempt)
                except BaseException as e:  # noqa: BLE001 — classified
                    te = classify(e)
                    if not te.is_retryable() or attempt == attempts - 1:
                        raise
                    if te.remote_host and te.remote_host not in blacklist:
                        blacklist.add(te.remote_host)
                        self.resilience.blacklisted_workers += 1
                        self.resilience_events.append(
                            ("blacklist", te.remote_host, te.code.name))
                    if te.remote_host:
                        # score the failure across queries too
                        rec = rt.current_record()
                        self.cluster_blacklist.record_failure(
                            te.remote_host, reason=te.code.name,
                            query_id=rec.query_id if rec else "")
                    self._prepare_retry()
                    backoff.failure()
                    delay = backoff.delay_s
                    self.resilience.query_retries += 1
                    self.resilience.backoff_waits += 1
                    self.resilience.backoff_wait_s += delay
                    self.resilience_events.append(
                        ("query_retry", attempt + 1, te.code.name, delay))
                    time.sleep(delay)
            raise AssertionError("unreachable: retry loop exhausted")
        finally:
            delta = ResilienceStats.delta(self.resilience, before)
            if delta.any:
                tm.observe_resilience(delta)
                rt.add_retries(rt.current_record(), delta.query_retries)
                span = self.tracer.current()
                if span is not None:
                    annotate_resilience_span(span, delta)
                if stats_sink is not None:
                    stats_sink.append(QueryStats(label="resilience:",
                                                 resilience=delta))

    def _prepare_retry(self) -> None:
        """Hook run between query-retry attempts (a process runner would
        sweep heartbeats and replace GONE workers here)."""

    # ------------------------------------------------- fault-tolerant tasks
    def fte_run_attempt(self, fragment, task_index: int, task_count: int,
                        nparts: int, upstream: dict, spool_root: str,
                        attempt: int, stats_sink: Optional[list],
                        memory_multiplier: float = 1.0) -> str:
        """Run ONE task attempt against the durable spool on the runner's
        device; returns the committed attempt directory.
        ``memory_multiplier`` scales the task's device memory budget: the
        FTE scheduler grows it exponentially after a memory failure
        (ExponentialGrowthPartitionMemoryEstimator.java:55)."""
        injector = self.session.failure_injector
        if injector is not None:
            injector.maybe_stall(fragment.id, task_index, attempt)
            injector.maybe_fail(TASK_FAILURE, fragment.id, task_index,
                                attempt)

        def on_read(_d, _fid=fragment.id, _t=task_index, _a=attempt):
            if injector is not None:
                injector.maybe_fail(GET_RESULTS_FAILURE, _fid, _t, _a)
                injector.maybe_corrupt_spool(_d, _fid, _t, _a)

        clients = {}
        for src, info in upstream.items():
            if info["merge"]:
                clients[src] = [
                    DurableSpoolClient([d], task_index, on_read, self.device)
                    for d in info["dirs"]]
            else:
                clients[src] = DurableSpoolClient(
                    info["dirs"], task_index, on_read, self.device)
        s = self.session
        planner = LocalPlanner(
            self.catalog, self.device, splits_per_node=s.splits_per_node,
            node_count=self.worker_count,
            dynamic_filtering=s.dynamic_filtering,
            hbm_limit_bytes=int(s.hbm_limit_bytes * memory_multiplier),
            spill_to_disk_bytes=s.spill_to_disk_bytes, ingest=self.ingest,
            task_index=task_index, task_count=task_count,
            remote_clients=clients)
        local = planner.plan(fragment.root)
        task_dir = fte_task_dir(spool_root, fragment.id, task_index)
        os.makedirs(task_dir, exist_ok=True)
        writer = DurableSpoolWriter(task_dir, attempt, nparts)
        kind = (fragment.output_kind if fragment.output_kind != "OUTPUT"
                else "GATHER")
        local.pipelines[-1][-1] = PartitionedOutputSink(
            writer, kind, fragment.output_keys, serde=True)
        stats = None
        if stats_sink is not None:
            stats = QueryStats(
                label=f"fragment {fragment.id} task {task_index}:")
        try:
            run_pipelines(local.pipelines, stats)
        except BaseException:
            writer.abort()
            raise
        writer.set_finished()
        if stats is not None:
            stats_sink.append(stats)
        return writer.committed

    # -------------------------------------------------------------- recovery
    def pending_fte_recoveries(self) -> list:
        """In-flight ``retry_policy="TASK"`` queries a dead coordinator
        left in the query-state WAL (execution/query_state.py): the
        recovery work list."""
        if not query_state.enabled():
            return []
        return query_state.pending()

    def resume_fte_query(self, pq) -> QueryResult:
        """Rehydrate one recovered query: decode the WAL's plan snapshot
        and re-enter the FTE loop with its committed-attempt map seeded;
        committed attempts are never re-executed (run_fte_query skips
        them; the WAL's attempt counters make that assertable).  Runs
        under the original query id."""
        subplan = query_state.decode_plan(pq.plan_b64)
        tm.FTE_QUERY_RECOVERIES.inc()
        profiler.instant(profiler.RECOVERY, "query-resume",
                         query_id=pq.query_id,
                         committed=len(pq.committed),
                         fingerprint=pq.fingerprint)

        def thunk():
            return self._to_result(
                subplan, run_fte_query(self, subplan, None, resume=pq))

        return run_with_query_events(
            pq.query_id, pq.sql, self.session.user, self.event_listeners,
            self.tracer, thunk, device=self.device)

    # ------------------------------------------------------ not ported yet
    def drain_worker(self, node_id: str) -> dict:
        raise NotImplementedError(f"worker drains {_ITEM4}")

    def restore_worker(self, node_id: str) -> None:
        raise NotImplementedError(f"worker drains {_ITEM4}")

    # ------------------------------------------------------------ scheduling
    @property
    def active_worker_count(self) -> int:
        """Every in-process worker (membership and failure detection are
        the control plane's, ROADMAP queue 1 item 4)."""
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
        self._history_fanout(fragments, task_counts, workers)
        consumer_tasks: dict[int, int] = {}
        for f in fragments:
            for src in f.source_fragments:
                consumer_tasks[src] = task_counts[f.id]
        return task_counts, consumer_tasks

    def _history_fanout(self, fragments, task_counts: dict,
                        workers: int) -> None:
        """Shrink a hash stage's task count when history says its input is
        small: N tasks over a trickle of rows cost more than the
        parallelism buys.  Only ever shrinks, and only intermediate
        (non-scan, non-SINGLE) stages."""
        try:
            if not history.hbo_enabled():
                return
            per_task = knobs.get_int("TRINO_TPU_HBO_ROWS_PER_TASK") or 0
            if per_task <= 0:
                return
            table, _ = history._stats_table()
            if not table:
                return
            fps = history.fragment_fingerprints(fragments)
            by_id = {f.id: f for f in fragments}
            for f in fragments:
                if task_counts.get(f.id, 1) <= 1 or f.partitioning != "HASH":
                    continue
                rows = 0
                for src in f.source_fragments:
                    st = table.get(fps.get(src, ""))
                    n = None if st is None else (
                        st.rows if st.rows is not None else st.groups)
                    if n is None or src not in by_id:
                        rows = None
                        break
                    rows += n
                if rows is None:
                    continue
                t = max(1, min(workers, -(-rows // per_task)))
                if t < task_counts[f.id]:
                    task_counts[f.id] = t
                    tm.HBO_FANOUT_ADJUSTED.inc()
                    rt.add_adaptive(rt.current_record(),
                                    f"hbo_fanout:f{f.id}:{t}")
        except Exception:
            # advisory only: a failed adjustment never fails scheduling
            tm.HBO_RECORD_ERRORS.inc()

    def _run_streaming(self, subplan: SubPlan, stats_sink: Optional[list],
                       attempt: int = 0,
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
        fused, resident, collective = self._plan_edges(
            fragments, stages, task_counts, consumer_tasks, use_fused)
        self._collective_edges = collective
        self._fused_edges = fused
        self._resident_edges = resident
        edges = {**collective, **fused, **resident}

        errors: list[BaseException] = []
        adaptive = None
        if self.session.task_scheduler == "TIME_SHARING":
            hung = self._run_time_sharing(fragments, stages, errors,
                                          stats_sink, edges, attempt)
        else:
            mode = adaptive_mode(self.session)
            if mode != "0":
                adaptive = AdaptiveExec(
                    stages, fragments, edges, SINK_MAX_BYTES, self.session,
                    errors, lambda fr, n, bufs: _Stage(fr, n, bufs),
                    self.device)
                if mode == "auto" and not adaptive.sites:
                    adaptive = None
            hung = self._run_threads(fragments, stages, errors, stats_sink,
                                     edges, attempt, adaptive)
        self.last_adaptive = adaptive
        if errors or hung:
            self._abort(stages, edges, adaptive)
            if errors:
                if use_fused and any(isinstance(e, FusedStageOverflow)
                                     for e in errors):
                    self._count_fallback(errors, stats_sink)
                    return self._run_streaming(subplan, stats_sink, attempt,
                                               use_fused=False)
                raise errors[0]
            raise TimeoutError(f"tasks did not complete: {hung}")
        self._roll_compiled_stats(fused, resident, stats_sink)
        if adaptive is not None and adaptive.stats.any:
            tm.observe_adaptive(adaptive.stats)
            if stats_sink is not None:
                stats_sink.append(QueryStats(label="adaptive:",
                                             adaptive=adaptive.stats))
        # close the runtime-truth loop: journal per-fingerprint observed
        # stats so the next plan of this (or any row-equivalent) shape
        # costs joins and aggregations from reality
        try:
            qrec = rt.current_record()
            n = history.record_query_stats(
                fragments, stages, set(edges), adaptive,
                qrec.query_id if qrec is not None else f"q@{id(subplan):x}",
                qrec.fingerprint if qrec is not None else "")
            if n:
                tm.HBO_RECORDS.inc(n)
        except Exception:
            tm.HBO_RECORD_ERRORS.inc()

        # drain the root stage's buffer as the client
        root = stages[subplan.fragment.id]
        client = ExchangeClient(root.buffers, 0)
        batches = []
        while not client.is_finished():
            b = client.poll(timeout=0.2)
            if b is not None:
                batches.append(maybe_deserialize(b, self.device))
        return self._to_result(subplan, batches)

    def _plan_edges(self, fragments, stages: dict, task_counts: dict,
                    consumer_tasks: dict, use_fused: bool) -> tuple:
        """(fused seams, resident plans, collective edges) of a query.
        Whole-stage and whole-query compilation come first (a resident
        plan takes its core fragment's fused seam); device-collective
        REPARTITION edges go where producer and consumer task counts line
        up, and host buffers carry every other edge.  Every task plans and
        runs on the runner's device, so every shard of an edge's mesh lies
        there too."""
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
        return fused, resident, collective

    def adaptive_sites(self, sql: str) -> list:
        """The join decision sites the adaptive plane would take for
        ``sql`` at this runner's task counts and edges, as (consumer
        fragment id, static distribution); nothing is executed."""
        fragments = self.create_subplan(sql).all_fragments()
        task_counts, consumer_tasks = self.stage_task_counts(fragments)
        stages = {f.id: _Stage(f, task_counts[f.id], []) for f in fragments}
        fused, resident, collective = self._plan_edges(
            fragments, stages, task_counts, consumer_tasks, True)
        plane = AdaptiveExec(stages, fragments,
                             {**collective, **fused, **resident},
                             SINK_MAX_BYTES, self.session, [],
                             lambda fr, n, bufs: _Stage(fr, n, bufs),
                             self.device)
        return [(site.consumer_fid, site.static) for site in plane.sites]

    @staticmethod
    def _abort(stages: dict, edges: dict, adaptive=None) -> None:
        """Unblock every task of the query: producers waiting on a full
        buffer, consumers polling a dead producer, partners parked at a
        collective edge or a compiled stage's rendezvous, routers of the
        adaptive plane."""
        for s in stages.values():
            for b in s.buffers:
                b.abort()
        for ex in edges.values():
            ex.abort()
        if adaptive is not None:
            adaptive.abort()

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

    def _run_threads(self, fragments, stages, errors, stats_sink, edges,
                     attempt: int = 0, adaptive=None) -> list[str]:
        """A thread per task; returns the names of tasks still running at
        the deadline (and, with the adaptive plane, of stages it never
        activated).  With ``speculation`` on, a lagging task of an
        eligible stage gets a SPECULATIVE twin under first-commit-wins."""
        # task spans nest under the coordinator thread's open span
        parent_span = self.tracer.current()
        qrec = rt.current_record()
        spec: Optional[StreamingSpeculation] = None
        spec_gates: dict = {}
        if speculation_enabled(self.session):
            spec = StreamingSpeculation(
                lag_multiplier=self.session.speculation_lag_multiplier,
                min_delay_s=self.session.speculation_min_delay_s,
                events=self.resilience_events)
            for f in fragments:
                if (f.source_fragments or f.id in edges
                        or stages[f.id].task_count < 2
                        or _writes(f.root)
                        or (adaptive is not None
                            and adaptive.is_deferred_producer(f.id))):
                    # a twin needs re-readable, side-effect-free input;
                    # deferred producers also feed barrier statistics (a
                    # twin would count the staging sketch twice)
                    continue
                spec.register_stage(f.id, stages[f.id].task_count)
                for t in range(stages[f.id].task_count):
                    spec_gates[(f.id, t)] = spec.register_task(f.id, t)
        tee: Optional[StreamingSpoolTee] = None
        if (spec is not None and adaptive is None
                and nonleaf_speculation_enabled(self.session)):
            # non-leaf twins: a stage whose sources all land in plain
            # OutputBuffers can speculate too; its producers tee winner
            # pages into a durable per-task spool, and the twin re-reads
            # the committed tee dirs once every source task committed
            nonleaf = [
                f for f in fragments
                if f.source_fragments and f.id not in edges
                and stages[f.id].task_count >= 2 and not _writes(f.root)
                and all(src not in edges for src in f.source_fragments)]
            if nonleaf:
                tee = StreamingSpoolTee(
                    make_spool_root(self.session.fte_spool_dir))
                spool_gc.acquire(tee.root, qrec.query_id if qrec is not None
                                 else "adhoc")
                for f in nonleaf:
                    srcs = tuple(f.source_fragments)
                    spec.register_stage(
                        f.id, stages[f.id].task_count,
                        eligible=lambda _s=srcs: tee.ready(_s))
                    for t in range(stages[f.id].task_count):
                        spec_gates[(f.id, t)] = spec.register_task(f.id, t)
                    for src in srcs:
                        tee.want(src, stages[src].task_count)

        def start(fid: int, t: int, attempt_no: int, ctx) -> threading.Thread:
            th = threading.Thread(
                target=self._run_task,
                args=(stages[fid], t, stages, errors, stats_sink, edges,
                      parent_span, qrec, attempt_no, ctx, adaptive, tee),
                name=(f"task-{fid}.{t}" if ctx is None
                      or ctx["kind"] == STANDARD
                      else f"task-{fid}.{t}-speculative"),
                daemon=True)
            th.start()
            return th

        def spawn_stage(fid: int) -> list[threading.Thread]:
            out = []
            for t in range(stages[fid].task_count):
                ctx = None
                if (fid, t) in spec_gates:
                    ctx = {"gate": spec_gates[(fid, t)], "kind": STANDARD,
                           "cancel": spec.cancel_event(fid, t, STANDARD)}
                out.append(start(fid, t, attempt, ctx))
            return out

        def spawn_twin(fid: int, t: int) -> threading.Thread:
            # twins use attempt + 1000 (fte.py's SPECULATIVE attempt base)
            # so attempt-scoped injector rules do not refire on the twin
            return start(fid, t, attempt + 1000, {
                "gate": spec_gates[(fid, t)], "kind": SPECULATIVE,
                "cancel": spec.cancel_event(fid, t, SPECULATIVE)})

        if adaptive is None:
            pending = []
            for f in fragments:
                pending.extend(spawn_stage(f.id))
        else:
            # phased activation: groups behind an unresolved decision site
            # hold no threads yet and their plan stays rewritable
            pending = adaptive.start(spawn_stage)
        # a polled join, so the adaptive barrier and straggler detection
        # run on the coordinator's cadence
        deadline = time.monotonic() + 2 * STALL_TIMEOUT_S
        while ((pending or (adaptive is not None and not adaptive.done()))
               and time.monotonic() < deadline):
            if pending:
                pending[0].join(timeout=0.1)
            else:
                time.sleep(0.02)
            pending = [th for th in pending if th.is_alive()]
            if adaptive is not None:
                if errors:
                    # a failed task already aborted the buffers; force the
                    # plane done so un-activated groups never spawn
                    adaptive.abort()
                else:
                    pending.extend(adaptive.advance(spawn_stage))
            if spec is not None and not errors:
                pending.extend(spec.tick(spawn_twin))
        hung = [th.name for th in pending if th.is_alive()]
        if adaptive is not None and not errors:
            hung += adaptive.unactivated()
        if tee is not None:
            spool_gc.release(tee.root)
        if spec is not None:
            self.speculative_starts += spec.starts
            self.speculative_wins += spec.wins
            if spec.wins and qrec is not None:
                qrec.speculative_wins += spec.wins
        return hung

    def _to_result(self, subplan: SubPlan, batches: list) -> QueryResult:
        names = list(subplan.fragment.root.output_names)
        types = list(subplan.fragment.root.output_types)
        if batches:
            return QueryResult(names, ColumnBatch.concat(batches))
        return QueryResult(names, ColumnBatch(names, [
            Column(t, np.empty(0, t.storage_dtype)) for t in types]))

    def _build_task(self, stage: _Stage, task_index: int, stages: dict,
                    stats_sink: Optional[list], edges: dict,
                    attempt: int = 0, spec_ctx: Optional[dict] = None,
                    adaptive=None, tee=None
                    ) -> tuple[list, Optional[QueryStats]]:
        f = stage.fragment
        # engine-level fault injection, keyed by (fragment, task, attempt)
        # as on the FTE path: what makes retry_policy=QUERY testable
        injector = self.session.failure_injector
        if injector is not None:
            cancel = spec_ctx["cancel"] if spec_ctx is not None else None
            injector.maybe_stall(
                f.id, task_index, attempt,
                # a stall must not outlive its query or a won race
                should_cancel=lambda: (
                    stage.buffers[task_index].aborted
                    or (cancel is not None and cancel.is_set())))
            if cancel is not None and cancel.is_set():
                raise SpeculationLost(spec_ctx["kind"])
            injector.maybe_fail(TASK_FAILURE, f.id, task_index, attempt)
        clients: dict = {}
        for src in f.source_fragments:
            if (tee is not None and spec_ctx is not None
                    and spec_ctx["kind"] == SPECULATIVE):
                # non-leaf twin: the streaming exchange freed the pages its
                # primary consumed; re-read the committed tee spool
                dirs = tee.committed_dirs(src)
                if dirs is None:
                    raise SpeculationLost(spec_ctx["kind"])
                if stages[src].fragment.output_kind == "MERGE":
                    clients[src] = [DurableSpoolClient([d], task_index,
                                                       device=self.device)
                                    for d in dirs]
                else:
                    clients[src] = DurableSpoolClient(dirs, task_index,
                                                      device=self.device)
                continue
            routed = (adaptive.routed_buffer(src)
                      if adaptive is not None else None)
            if routed is not None:
                # a deferred edge: the router's re-distributed pages
                clients[src] = ExchangeClient([routed], task_index)
            elif src in edges:
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
            out = stage.buffers[task_index]
            if spec_ctx is not None:
                # racing attempts write through the task's gate: the first
                # page (or empty finish) claims the stream
                out = GatedBuffer(out, spec_ctx["gate"], spec_ctx["kind"])
            if tee is not None and tee.wants(f.id):
                # this fragment feeds a speculation-eligible non-leaf
                # stage: tee winner pages into the durable spool (outside
                # the gate, so a losing attempt never reaches the tee)
                out = SpoolTeeBuffer(
                    out, tee.writer(f.id, task_index,
                                    stage.buffers[task_index].num_partitions,
                                    attempt=attempt),
                    on_commit=lambda d, _f=f.id, _t=task_index:
                        tee.mark_committed(_f, _t, d))
            kind = f.output_kind if f.output_kind != "OUTPUT" else "GATHER"
            sketch, sketch_keys = None, ()
            if adaptive is not None:
                ov = adaptive.sink_override(f.id, task_index)
                if ov is not None:
                    # a deferred producer: everything lands in its single-
                    # partition staging buffer and feeds the sketch
                    kind = "GATHER"
                    sketch, sketch_keys = ov
            sink = PartitionedOutputSink(
                out, kind, f.output_keys, serde=s.exchange_serde,
                sketch=sketch, sketch_keys=sketch_keys,
                coalesce_rows=f.sink_coalesce_rows)
        # the task's output sink takes the collector's place
        local.pipelines[-1][-1] = sink
        stats = None
        if stats_sink is not None:
            stats = QueryStats(label=f"fragment {f.id} task {task_index}:")
            stats_sink.append(stats)  # list.append is thread-safe
        return local.pipelines, stats

    def _run_time_sharing(self, fragments, stages, errors, stats_sink,
                          edges, attempt: int = 0) -> list[str]:
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
                            stage, t, stages, stats_sink, edges, attempt)
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
                  query_record=None, attempt: int = 0,
                  spec_ctx: Optional[dict] = None, adaptive=None,
                  tee=None) -> None:
        """One task on its thread, with the task lifecycle's telemetry
        (reference: distributed_runner.py _run_task): the task counters and
        wall distribution, the ``system.runtime.tasks`` record, the
        ``trino.task`` span and the profiler's TASK event.  A failure
        aborts every buffer and edge of the query; an attempt that lost a
        speculation race unwinds quietly."""
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
                    stage, task_index, stages, stats_sink, edges, attempt,
                    spec_ctx, adaptive, tee)
                run_pipelines(pipelines, stats)
            except SpeculationLost:
                # the other attempt owns the output stream
                state = "CANCELED"
                sp.set("speculation.lost", True)
            except BaseException as e:  # noqa: BLE001 — surfaced to the
                # coordinator
                gate = spec_ctx["gate"] if spec_ctx is not None else None
                if (gate is not None and gate.owner is not None
                        and gate.owner != spec_ctx["kind"]):
                    # a loser failing for real changes nothing: the other
                    # attempt owns the stream and is still healthy
                    state = "CANCELED"
                    sp.set("speculation.lost", True)
                    self.resilience_events.append(
                        ("speculative_loser_error", stage.fragment.id,
                         task_index, type(e).__name__))
                else:
                    errors.append(e)
                    state = "FAILED"
                    err = f"{type(e).__name__}: {e}"
                    sp.set("error", type(e).__name__)
                    self._abort(stages, edges, adaptive)
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


def _writes(node) -> bool:
    return isinstance(node, TableWriter) or any(_writes(c)
                                                for c in node.children)

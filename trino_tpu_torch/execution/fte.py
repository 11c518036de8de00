"""Fault-tolerant execution: DURABLE spooled exchange + task retry.

The port of the reference ``execution/fte.py``, the miniature of Trino's
FTE mode (execution/scheduler/faulttolerant/
EventDrivenFaultTolerantQueryScheduler.java:201 +
spi/exchange/ExchangeManager.java:39 spooling):

- fragments run in topological order (producers complete before consumers
  start); every task's output is spooled TO DISK per consumer partition
  with atomic attempt commit (execution/durable_spool.py — the
  FileSystemExchangeManager role), so the unit of recovery genuinely
  survives task AND worker-process death;
- a failed task attempt is retried up to ``task_retry_attempts`` times with
  a fresh attempt directory (tasks are deterministic in (fragment,
  task_index, committed inputs), so re-execution is exact);
- consumers read only committed attempts — a mid-stream producer death can
  never poison a downstream task, which is exactly the property the
  streaming pipelined scheduler gives up;
- engine-level failure injection (execution/failure_injector.py, the
  FailureInjector.java:35 hook) targets task bodies, spool reads and
  spool bytes on disk (the hosting worker process itself waits for worker
  processes, ROADMAP queue 1 item 5).

The coordinator is no longer the single point of failure:

- every FTE query appends to a write-ahead query-state log
  (execution/query_state.py): the plan snapshot at ``begin``, an
  ``attempt_start`` per attempt, and an fsync'd ``attempt_committed`` per
  first-winning commit.  ``run_fte_query(..., resume=pq)`` re-enters a
  half-finished query from that map: committed tasks are seeded as already
  resolved and are NEVER re-executed;
- the stage barrier is a ``threading.Condition`` — ``commit()`` and
  failure recording wake it immediately (the old 10 ms poll put a latency
  floor under every small stage);
- spool CRC failures (serde.SpoolCorruptionError — bit flips / torn
  frames that slipped past atomic rename) repair themselves: the corrupt
  committed attempt is discarded and its *producer* task re-runs, bounded
  by a per-query repair budget;
- the end of a query releases its spool root through ``spool_gc.release``;
  the root is leased, so a crashed coordinator's root survives for
  recovery and the boot sweep.

Every attempt runs on the runner's device with the same kernels: a retry
never moves a task to the host or takes a kernel's plain version.  Pages
are spooled from the device (serialized on the host) and read back onto
the consuming task's device (execution/durable_spool.py).

The trade (identical to Trino FTE): no cross-stage streaming overlap, in
exchange for retryability.  ``Session(retry_policy="TASK")`` selects it.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import time
from typing import Optional

from ..spi.errors import classify
from ..spi.memory import ExceededMemoryLimitError
from ..telemetry import metrics as tm
from ..telemetry import profiler
from ..telemetry import runtime as rt
from . import query_state, spool_gc
from .durable_spool import make_spool_root
from .fragmenter import SubPlan
from .durable_spool import DurableSpoolClient
from .serde import SpoolCorruptionError

__all__ = ["run_fte_query", "TaskFailure"]

_TASK_DIR = re.compile(r"^f(\d+)_t(\d+)$")
# bounded spool-corruption repairs per query: each repair re-runs exactly
# one producer task, so a disk actively eating data cannot loop forever
_MAX_REPAIRS = 3


class TaskFailure(RuntimeError):
    def __init__(self, fragment_id: int, task_index: int, attempts: int,
                 cause: BaseException):
        super().__init__(
            f"fragment {fragment_id} task {task_index} failed after "
            f"{attempts} attempts: {cause}")
        self.cause = cause


def fte_task_dir(spool_root: str, fragment_id: int, task_index: int) -> str:
    return os.path.join(spool_root, f"f{fragment_id}_t{task_index}")


def _attempt_number(attempt_dir: str) -> int:
    try:
        return int(os.path.basename(attempt_dir).rsplit("-", 1)[1])
    except (IndexError, ValueError):
        return -1


def _find_corruption(exc: BaseException) -> Optional[SpoolCorruptionError]:
    """First SpoolCorruptionError in the cause chain (TaskFailure.cause or
    the standard __cause__/__context__ links), if any."""
    seen = 0
    while exc is not None and seen < 10:
        if isinstance(exc, SpoolCorruptionError):
            return exc
        exc = (getattr(exc, "cause", None) or exc.__cause__
               or exc.__context__)
        seen += 1
    return None


def run_fte_query(runner, subplan: SubPlan,
                  stats_sink: Optional[list] = None,
                  resume: Optional["query_state.PendingQuery"] = None
                  ) -> list:
    """Execute the subplan stage-by-stage with task retry over a durable
    spool; returns the root fragment's output batches.  ``resume`` re-
    enters a recovered query from its WAL's committed-attempt map."""
    session = runner.session
    attempts_allowed = 1 + getattr(session, "task_retry_attempts", 2)
    fragments = subplan.all_fragments()  # children first = topological

    task_counts, consumer_tasks = runner.stage_task_counts(fragments)
    output_kinds = {f.id: f.output_kind for f in fragments}

    rec = rt.current_record()
    qid = resume.query_id if resume is not None else (
        rec.query_id if rec is not None else "")
    sql = resume.sql if resume is not None else (
        rec.sql if rec is not None else "")

    if (resume is not None and resume.spool_root
            and os.path.isdir(resume.spool_root)):
        spool_root = resume.spool_root
    else:
        spool_root = make_spool_root(getattr(session, "fte_spool_dir", None))
    spool_gc.acquire(spool_root, qid or "adhoc")

    wal: Optional[query_state.QueryStateLog] = None
    if qid and query_state.enabled():
        # a resumed query keeps appending to the WAL it was recovered
        # from — under HA lease takeover that directory belongs to the
        # DEAD coordinator's claimed custody, not this process's own
        # state dir, and writing anywhere else would strand the log
        wal_dir = (os.path.dirname(resume.path)
                   if resume is not None and getattr(resume, "path", None)
                   else None)
        wal = query_state.QueryStateLog(qid, dir=wal_dir)
        if resume is None:
            wal.begin(sql, subplan, spool_root, session,
                      task_counts=task_counts,
                      consumer_tasks=consumer_tasks)

    speculative = getattr(session, "fte_speculative", True)
    spec_min_delay = getattr(session, "fte_speculative_delay_s", 0.25)
    mem_growth = getattr(session, "fte_memory_growth", 2.0)
    # observability: ("commit", frag, task, kind) / ("memory_retry", frag,
    # task, multiplier) / ("speculative_start", frag, task) /
    # ("resumed", frag, task) / ("spool_corruption", frag, task)
    events = getattr(session, "fte_events", None)

    # fragment id -> {task -> committed attempt dir}; survives stage
    # failures so a corruption repair can re-run ONE producer task and a
    # resumed query can skip everything a dead coordinator already paid for
    stage_commits: dict[int, dict[int, str]] = {f.id: {} for f in fragments}
    if resume is not None:
        shape_ok = resume.shape_matches(task_counts, consumer_tasks)
        for (fid, t), d in resume.committed_dirs().items():
            if (shape_ok and fid in stage_commits and isinstance(t, int)
                    and 0 <= t < task_counts.get(fid, 0)
                    and d and os.path.isdir(d)):
                stage_commits[fid][t] = d
                tm.FTE_STAGES_RESUMED.inc()
                if events is not None:
                    events.append(("resumed", fid, t))
                profiler.instant(profiler.RECOVERY, "task-resumed",
                                 fragment=fid, task=t)

    def run_stage(f, tc: int, nparts: int, upstream: dict,
                  already: dict[int, str]) -> None:
        """One stage with retry + speculation.  A SEPARATE function scope
        per stage: a zombie thread (e.g. a stalled standard attempt whose
        speculative twin already won) closes over THIS stage's state and can
        never corrupt a later stage's bookkeeping (late-binding loop
        closures did exactly that in the first r5 cut).  ``already`` holds
        tasks committed by a previous coordinator generation (or an earlier
        pass of this one) — they are seeded resolved, never re-run."""
        frag_commits: list[Optional[str]] = [None] * tc
        for t, d in already.items():
            frag_commits[t] = d
        if all(d is not None for d in frag_commits):
            return
        failures: list[Optional[TaskFailure]] = [None] * tc
        commit_lock = threading.Lock()
        # the stage barrier: commit() and failure recording notify, so the
        # event loop below wakes the moment a task resolves instead of
        # rediscovering it on a 10ms poll
        barrier = threading.Condition(commit_lock)
        stage_t0 = time.perf_counter()
        durations: list[float] = []

        def commit(t: int, d: str, kind: str) -> None:
            """First committed attempt wins (the spool's atomic-rename
            dedup makes the loser's directory inert)."""
            with barrier:
                if frag_commits[t] is None:
                    frag_commits[t] = d
                    already[t] = d
                    durations.append(time.perf_counter() - stage_t0)
                    if events is not None:
                        events.append(("commit", f.id, t, kind))
                    if kind == "SPECULATIVE":
                        tm.FTE_SPECULATIVE_WINS.inc()
                    if wal is not None:
                        wal.attempt_committed(f.id, t, _attempt_number(d),
                                              d, kind)
                    barrier.notify_all()

        def record_failure(t: int, tf: TaskFailure) -> None:
            with barrier:
                failures[t] = tf
                barrier.notify_all()

        def run_attempts(t: int, attempt_base: int, kind: str) -> None:
            """One retry chain (STANDARD or SPECULATIVE execution class —
            TaskExecutionClass.java:19).  A memory failure grows the
            task's budget exponentially on the next attempt
            (ExponentialGrowthPartitionMemoryEstimator.java:55)."""
            last: Optional[Exception] = None
            mem_mult = 1.0
            for attempt in range(attempts_allowed):
                if frag_commits[t] is not None:
                    return  # the twin already won
                tm.FTE_ATTEMPT_STARTS.inc()
                if attempt > 0:
                    tm.FTE_ATTEMPT_RETRIES.inc()
                if wal is not None:
                    wal.attempt_start(f.id, t, attempt_base + attempt, kind)
                try:
                    d = runner.fte_run_attempt(
                        f, t, tc, nparts, upstream, spool_root,
                        attempt_base + attempt, stats_sink,
                        memory_multiplier=mem_mult)
                    commit(t, d, kind)
                    return
                except Exception as e:  # retried; interrupts propagate
                    last = e
                    if isinstance(e, SpoolCorruptionError):
                        # retrying would reread the same corrupt bytes;
                        # surface NOW so the query loop can repair the
                        # producer instead of burning the attempt budget
                        if kind == "STANDARD":
                            record_failure(t, TaskFailure(
                                f.id, t, attempt + 1, e))
                        return
                    if not classify(e).is_retryable():
                        # USER-classified failure: re-running re-runs the
                        # same bug — fail the task NOW, no retry chain
                        if kind == "STANDARD":
                            record_failure(t, TaskFailure(
                                f.id, t, attempt + 1, last))
                        return
                    if isinstance(e, ExceededMemoryLimitError):
                        mem_mult *= mem_growth
                        if events is not None:
                            events.append(
                                ("memory_retry", f.id, t, mem_mult))
                    time.sleep(0.01 * attempt)
            if kind == "STANDARD":
                record_failure(t, TaskFailure(f.id, t, attempts_allowed,
                                              last))

        # stage barrier between fragments, but a stage's tasks still run
        # concurrently (matching Trino FTE's intra-stage parallelism)
        threads = {t: threading.Thread(
            target=run_attempts, args=(t, 0, "STANDARD"),
            name=f"fte-{f.id}.{t}", daemon=True)
            for t in range(tc) if t not in already}
        for th in threads.values():
            th.start()

        # event loop: resolve tasks as they land; once half the stage
        # committed, stragglers get a SPECULATIVE attempt chain (first
        # commit wins).  A stalled standard attempt no longer holds the
        # stage barrier hostage — its thread is left to die in the
        # background (EventDrivenFaultTolerantQueryScheduler speculative
        # semantics).
        spec_threads: dict[int, threading.Thread] = {}
        with barrier:
            while True:
                resolved = [
                    t for t in range(tc)
                    if frag_commits[t] is not None
                    or (failures[t] is not None
                        and not (t in spec_threads
                                 and spec_threads[t].is_alive()))
                ]
                if len(resolved) == tc:
                    break
                all_dead = all(
                    not th.is_alive() for th in threads.values()) and all(
                    not th.is_alive() for th in spec_threads.values())
                if all_dead:
                    break
                if speculative and durations and len(
                        [t for t in range(tc)
                         if frag_commits[t] is not None]) * 2 >= tc:
                    med = sorted(durations)[len(durations) // 2]
                    cutoff = max(2.0 * med, spec_min_delay)
                    now = time.perf_counter() - stage_t0
                    for t in range(tc):
                        if (frag_commits[t] is None and t not in spec_threads
                                and now > cutoff):
                            if events is not None:
                                events.append(
                                    ("speculative_start", f.id, t))
                            tm.FTE_SPECULATIVE_STARTS.inc()
                            th = threading.Thread(
                                target=run_attempts,
                                args=(t, 1000, "SPECULATIVE"),
                                name=f"fte-spec-{f.id}.{t}", daemon=True)
                            spec_threads[t] = th
                            th.start()
                # commits/failures notify immediately; the timeout only
                # drives the speculation cutoff clock and dead-thread
                # detection
                barrier.wait(0.05 if speculative and durations else 0.25)

        for t in range(tc):
            if frag_commits[t] is None:
                raise failures[t] or TaskFailure(
                    f.id, t, attempts_allowed,
                    RuntimeError("task did not complete"))

    def upstream_for(f) -> dict:
        return {
            src: {"dirs": [stage_commits[src][t]
                           for t in sorted(stage_commits[src])],
                  "merge": output_kinds[src] == "MERGE"}
            for src in f.source_fragments
        }

    def repair_corruption(sce: SpoolCorruptionError, repairs_left: int,
                          failure: BaseException) -> int:
        """Discard the corrupt committed attempt and return the fragment
        list index to re-enter the stage loop at (the producer's).  Re-
        raises ``failure`` when the corruption cannot be mapped back to a
        committed task or the repair budget ran out."""
        if repairs_left <= 0:
            raise failure
        rel = os.path.relpath(sce.path, spool_root)
        parts = rel.split(os.sep)
        m = _TASK_DIR.match(parts[0]) if parts and ".." not in parts \
            else None
        if m is None or len(parts) < 2:
            raise failure
        fid, t = int(m.group(1)), int(m.group(2))
        if stage_commits.get(fid, {}).get(t) is None:
            raise failure
        attempt_dir = os.path.join(spool_root, parts[0], parts[1])
        stage_commits[fid].pop(t, None)
        shutil.rmtree(attempt_dir, ignore_errors=True)
        tm.FTE_SPOOL_CORRUPTIONS.inc()
        profiler.instant(profiler.RECOVERY, "spool-corruption-repair",
                         fragment=fid, task=t,
                         path=os.path.basename(sce.path))
        if events is not None:
            events.append(("spool_corruption", fid, t))
        if wal is not None:
            wal.attempt_discarded(fid, t, "crc-mismatch")
        for i, f in enumerate(fragments):
            if f.id == fid:
                return i
        raise failure

    try:
        repairs_left = _MAX_REPAIRS
        i = 0
        out: Optional[list] = None
        while out is None:
            while i < len(fragments):
                f = fragments[i]
                try:
                    run_stage(f, task_counts[f.id],
                              consumer_tasks.get(f.id, 1), upstream_for(f),
                              stage_commits[f.id])
                    i += 1
                except TaskFailure as tf:
                    sce = _find_corruption(tf.cause)
                    if sce is None:
                        raise
                    i = repair_corruption(sce, repairs_left, tf)
                    repairs_left -= 1

            root = stage_commits[subplan.fragment.id]
            client = DurableSpoolClient([root[t] for t in sorted(root)], 0,
                                        device=runner.device)
            batches = []
            try:
                while True:
                    page = client.poll()
                    if page is None:
                        break
                    batches.append(page)
                out = batches
            except SpoolCorruptionError as sce:
                i = repair_corruption(sce, repairs_left, sce)
                repairs_left -= 1
        if wal is not None:
            wal.end("FINISHED")
        return out
    except BaseException as e:
        if wal is not None:
            wal.end("FAILED", error=str(e)[:500])
        raise
    finally:
        if wal is not None:
            wal.close()
        # happy-path GC: the query is over (either outcome), reclaim now.
        # A coordinator killed before this line leaves a leased root the
        # boot-time recovery + sweep will either resume from or reclaim.
        spool_gc.release(spool_root)

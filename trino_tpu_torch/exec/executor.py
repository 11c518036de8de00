"""Time-sharing task executor: bounded workers and MLFQ quanta.

The port of the reference ``exec/executor.py``.  The reference runs every
worker's drivers on a fixed thread pool where each driver gets a time
quantum and yields back to a multilevel feedback queue prioritized by
accumulated time (execution/executor/timesharing/
TimeSharingTaskExecutor.java:85, MultilevelSplitQueue.java:39).  This is
that scheduler in miniature: N worker threads; a task requeues after each
quantum at a level chosen by its accumulated wall time, so short queries
finish ahead of long scans.  A task whose driver reports ``blocked`` (its
input, e.g. a local exchange, is empty) parks below every working level,
deeper with each consecutive block, and sleeps 1 ms before it requeues.

Drivers yield through :meth:`Driver.process` (exec/driver.py).  A task's
pipelines run in dependency order, one quantum of one driver at a time, on
whichever worker takes it; workers launch on the device's current stream,
as run_pipelines' threads do.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Optional, Sequence

from ..ops.expr import check_error_scalars
from ..telemetry import profiler
from ..telemetry import runtime as rt
from .driver import Driver
from .operators import ScanOperator
from .stats import PipelineStats, QueryStats

__all__ = ["TimeSharingTaskExecutor", "TaskHandle"]

# accumulated-seconds thresholds of the MLFQ levels (reference:
# MultilevelSplitQueue.LEVEL_THRESHOLD_SECONDS 0, 1, 10, 60, 300, scaled
# down)
_LEVELS = (0.0, 0.5, 2.0, 10.0, 60.0)
_QUANTUM_S = 0.25

# blocked tasks park BELOW every working level: a consumer waiting on its
# producer must never outrank it on the strict-priority heap
_BLOCKED_LEVEL = len(_LEVELS)


def _level_of(elapsed: float) -> int:
    lvl = 0
    for i, t in enumerate(_LEVELS):
        if elapsed >= t:
            lvl = i
    return lvl


class TaskHandle:
    """One task: its pipelines executed in dependency order, sharing an
    accumulated-time budget for MLFQ placement.  ``done`` is set when the
    task finished or failed (``error``); at the end its scans' prefetch
    threads are stopped and its deferred expression errors raised, as
    run_pipelines does.  The pipelines of a concurrent group need drivers
    of their own (run_pipelines): one task runs its drivers one after
    another."""

    def __init__(self, pipelines: Sequence[Sequence],
                 stats: Optional[QueryStats] = None):
        self.pipelines = [list(p) for p in pipelines]
        self.drivers: list[Driver] = []
        for p in pipelines:
            ps = None
            if stats is not None:
                ps = PipelineStats()
                stats.pipelines.append(ps)
            self.drivers.append(Driver(p, ps))
        self._current = 0
        self.elapsed = 0.0
        self.blocked_streak = 0
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        # the submitter's query: a worker runs each quantum in its
        # profiler context and with its query record
        self.prof_ctx = profiler.capture_context()
        self.record = rt.current_record()

    def process_quantum(self) -> str:
        """-> 'finished' | 'progressed' | 'blocked'."""
        t0 = time.perf_counter()
        try:
            deadline = t0 + _QUANTUM_S
            while self._current < len(self.drivers):
                status = self.drivers[self._current].process(deadline)
                if status == "finished":
                    self._current += 1
                    if time.perf_counter() >= deadline:
                        break
                    continue
                return status
            if self._current >= len(self.drivers):
                self._end()
                check_error_scalars([
                    e for p in self.pipelines for op in p
                    for e in getattr(op, "pending_errors", ())])
                self.done.set()
                return "finished"
            return "progressed"
        except BaseException as e:  # noqa: BLE001 — stored for the caller
            self._end()
            self.error = e
            self.done.set()
            return "finished"
        finally:
            self.elapsed += time.perf_counter() - t0

    def _end(self) -> None:
        for p in self.pipelines:
            for op in p:
                if isinstance(op, ScanOperator):
                    op.shutdown()

    def wait(self, timeout: Optional[float] = None) -> None:
        """Wait for the task; raise its error, or TimeoutError."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"task not done after {timeout} s")
        if self.error is not None:
            raise self.error


class TimeSharingTaskExecutor:
    def __init__(self, num_workers: int = 4):
        self.num_workers = num_workers
        self._heap: list = []  # (level, seq, handle)
        self._seq = itertools.count()
        self._cv = threading.Condition()
        self._shutdown = False
        self._threads = [
            threading.Thread(target=self._worker, name=f"task-executor-{i}",
                             daemon=True)
            for i in range(num_workers)
        ]
        for t in self._threads:
            t.start()

    def submit(self, pipelines: Sequence[Sequence],
               stats: Optional[QueryStats] = None) -> TaskHandle:
        # exchange sources and sinks poll instead of waiting: a parked
        # consumer or a producer facing a full buffer releases its worker
        for p in pipelines:
            for op in p:
                if hasattr(op, "blocking"):
                    op.blocking = False
        handle = TaskHandle(pipelines, stats)
        self._enqueue(handle, 0)
        return handle

    def _enqueue(self, handle: TaskHandle, level: int) -> None:
        with self._cv:
            heapq.heappush(self._heap, (level, next(self._seq), handle))
            self._cv.notify()

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._heap and not self._shutdown:
                    self._cv.wait(timeout=0.1)
                if self._shutdown:
                    return
                _, _, handle = heapq.heappop(self._heap)
            profiler.apply_context(handle.prof_ctx)
            rt.adopt_record(handle.record)
            status = handle.process_quantum()
            if status == "finished":
                continue
            if status == "blocked":
                # sink below the producer this task waits on, deeper with
                # every consecutive block, but never below other queries'
                # work for good
                handle.blocked_streak += 1
                level = min(_BLOCKED_LEVEL,
                            _level_of(handle.elapsed) + handle.blocked_streak)
                time.sleep(0.001)
                self._enqueue(handle, level)
                continue
            handle.blocked_streak = 0
            self._enqueue(handle, _level_of(handle.elapsed))

    def shutdown(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)

"""Driver: moves batches through an operator chain.

The port of the reference ``exec/driver.py`` (operator/Driver.java:372 —
``page = current.getOutput(); next.addInput(page)`` per adjacent pair,
finish propagation, early close on satisfied LIMITs).  A driver runs in
quanta (:meth:`Driver.process`), the unit the time-sharing executor
schedules (exec/executor.py).  :func:`run_pipelines` runs a task's
pipelines in dependency order, build sides first, on the calling thread,
except the pipelines of one local-exchange cluster (exec/local_exchange.py;
tagged with one ``_concurrent_group`` on their first operator), which run
at once on threads of their own with bounded buffers between them.

Threads and the card: every driver thread launches on its device's
current stream, which no thread changes, so all drivers share the legacy
default stream.  Their kernels run in launch order; none overlaps another
(the cooperative segment sum sizes its grid to be wholly resident and must
not share the card with a concurrent launch), and a tensor one driver
hands another through an exchange is complete before any later launch
reads it.  A scan's copies to the card run on its own side stream and are
ordered by events (exec/prefetch.py).  The threads overlap host work:
expression and planning code between launches, the scans' prefetch, and
the torch ops that release the interpreter lock.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import torch

from ..ops.expr import check_error_scalars
from ..spi.errors import GENERIC_INTERNAL_ERROR, TrinoError
from . import syncguard as SG
from .operators import Operator, ScanOperator
from .stats import (EncodingStats, OperatorStats, PipelineStats, QueryStats,
                    ScanIngestStats)

__all__ = ["Driver", "run_pipelines", "collect_scan_stats",
           "collect_encoding_stats", "GROUP_TIMEOUT_S"]

# seconds a concurrent group may run before its threads are abandoned and
# the query fails (a driver that never returns would hang the task)
GROUP_TIMEOUT_S = 900.0
_PARK_S = 2e-4  # a parked driver's sleep between quanta


def collect_scan_stats(pipelines: Sequence[Sequence[Operator]]
                       ) -> Optional[ScanIngestStats]:
    """Roll up the ScanOperators' ingest counters (None if no scan read a
    batch)."""
    total: Optional[ScanIngestStats] = None
    for p in pipelines:
        for op in p:
            ingest = getattr(op, "ingest_stats", None)
            if ingest is not None and ingest.scan_batches:
                if total is None:
                    total = ScanIngestStats()
                total.merge(ingest)
    return total


def collect_encoding_stats(pipelines: Sequence[Sequence[Operator]]
                           ) -> Optional[EncodingStats]:
    """Roll up the operators' compressed-execution counters (None when no
    operator saw an encoded batch)."""
    total: Optional[EncodingStats] = None
    for p in pipelines:
        for op in p:
            enc = getattr(op, "encoding_stats", None)
            if enc is not None and (enc.any or enc.lazy_materialized):
                if total is None:
                    total = EncodingStats()
                total.merge(enc)
    return total


class Driver:
    def __init__(self, operators: Sequence[Operator],
                 stats: Optional[PipelineStats] = None, sync: bool = False):
        assert operators, "empty pipeline"
        self.operators = list(operators)
        self.stats = stats
        self.sync = sync and torch.cuda.is_available()
        if stats is not None:
            stats.operators.extend(
                OperatorStats(type(op).__name__) for op in self.operators)

    def _timed(self, i: int, fn, *args):
        if self.stats is None:
            return fn(*args)
        t0 = time.perf_counter()
        out = fn(*args)
        if self.sync:
            torch.cuda.synchronize()
        self.stats.operators[i].wall_s += time.perf_counter() - t0
        return out

    def _emit(self, i: int, page) -> None:
        """Credit a page moving from operator i to i + 1 (live rows; a
        masked page's count stays a tensor until QueryStats.read_counts)."""
        src, dst = self.stats.operators[i], self.stats.operators[i + 1]
        n = page.num_rows if page.live is None else page.live.sum()
        src.output_rows += n
        src.output_batches += 1
        dst.input_rows += n
        dst.input_batches += 1

    def run(self) -> None:
        """Run to completion on the calling thread."""
        status = self.process()
        if status == "blocked":
            stuck = [type(o).__name__ for o in self.operators
                     if not o.is_finished()]
            raise TrinoError(GENERIC_INTERNAL_ERROR,
                             f"driver stalled; unfinished: {stuck}")

    def process(self, deadline: float = float("inf")) -> str:
        """One scheduling quantum: move pages until ``deadline`` (a
        time.perf_counter() timestamp), the driver finishes, or no operator
        can make progress.  Returns 'finished' | 'progressed' | 'blocked'
        (blocked = alive but waiting on an external input: an exchange or a
        join bridge) — operator/Driver.processFor's contract."""
        ops = self.operators
        n = len(ops)
        any_progress = False
        while not ops[-1].is_finished():
            progressed = False
            for i in range(n - 1):
                cur, nxt = ops[i], ops[i + 1]
                # early close: downstream done (e.g. LIMIT satisfied)
                if nxt.is_finished() and not cur.is_finished():
                    cur.close()
                    progressed = True
                    continue
                if not cur.is_finished() and nxt.needs_input():
                    page = self._timed(i, cur.get_output)
                    if page is not None:
                        if self.stats is not None:
                            self._emit(i, page)
                        self._timed(i + 1, nxt.add_input, page)
                        progressed = True
                if cur.is_finished() and not nxt.input_done:
                    if i + 2 == n:
                        # pre-finish barrier: deferred masked-lane errors
                        # surface before the sink finishes, so no consumer
                        # sees a complete result of a failing task
                        check_error_scalars([
                            e for op in ops
                            for e in getattr(op, "pending_errors", ())])
                    self._timed(i + 1, nxt.finish_input)
                    progressed = True
            if ops[-1].is_finished():
                break
            if not progressed:
                return "progressed" if any_progress else "blocked"
            any_progress = True
            if time.perf_counter() >= deadline:
                return "progressed"
        # upstream of an early-finished sink gets closed so sources release
        for op in ops[:-1]:
            if not op.is_finished():
                op.close()
        return "finished"


def _run_parked(driver: Driver, stop: threading.Event) -> None:
    """Drive to completion, sleeping briefly while parked on a bounded
    buffer (the thread-pool analogue of isBlocked() futures).  ``stop``
    ends the loop when a sibling of the group failed."""
    while not stop.is_set():
        if driver.process() == "finished":
            return
        time.sleep(_PARK_S)


def _run_group(drivers: Sequence[Driver]) -> None:
    """Run one concurrent group's drivers on threads of their own; the
    first error stops the siblings and is raised here, and a group still
    running after GROUP_TIMEOUT_S fails the query."""
    errors: list = []
    stop = threading.Event()

    def body(d: Driver) -> None:
        try:
            _run_parked(d, stop)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            stop.set()  # unpark the siblings so the group unwinds

    threads = [threading.Thread(target=body, args=(d,), daemon=True,
                                name=f"driver-{i}")
               for i, d in enumerate(drivers)]
    for t in threads:
        t.start()
    end = time.monotonic() + GROUP_TIMEOUT_S
    for t in threads:
        t.join(max(0.0, end - time.monotonic()))
    if any(t.is_alive() for t in threads):
        stop.set()
        for t in threads:
            t.join(1.0)
        raise TrinoError(GENERIC_INTERNAL_ERROR,
                         f"concurrent drivers still running after "
                         f"{GROUP_TIMEOUT_S:g} s")
    if errors:
        raise errors[0]


def run_pipelines(pipelines: Sequence[Sequence[Operator]],
                  stats: Optional[QueryStats] = None) -> None:
    """Execute pipelines in dependency order, each local-exchange cluster
    (consecutive pipelines whose first operators share a
    ``_concurrent_group``) on concurrent threads, then raise any deferred
    expression error (one batched fetch over every operator's scalars).
    With ``stats``, also the run's operator, scan, encoding and host-sync
    roll-ups."""
    sync_before = SG.snapshot()
    drivers = []
    for p in pipelines:
        ps = None
        if stats is not None:
            ps = PipelineStats()
            stats.pipelines.append(ps)
        drivers.append(Driver(p, ps, sync=stats is not None
                              and stats.per_op_sync))
    try:
        i, n = 0, len(pipelines)
        while i < n:
            gid = getattr(pipelines[i][0], "_concurrent_group", None)
            j = i + 1
            while gid is not None and j < n and getattr(
                    pipelines[j][0], "_concurrent_group", None) is gid:
                j += 1
            if j - i > 1:
                _run_group(drivers[i:j])
            else:
                drivers[i].run()
            i = j
    finally:
        for p in pipelines:
            for op in p:
                if isinstance(op, ScanOperator):
                    op.shutdown()
    if stats is not None:
        stats.read_counts()
        stats.scan = collect_scan_stats(pipelines)
        stats.encoding = collect_encoding_stats(pipelines)
        stats.collect_spills(pipelines)
    check_error_scalars([e for p in pipelines for op in p
                         for e in getattr(op, "pending_errors", ())])
    if stats is not None:
        stats.sync = SG.take_delta(sync_before)

"""Driver: moves batches through an operator chain.

The port of the reference ``exec/driver.py`` (operator/Driver.java:372 —
``page = current.getOutput(); next.addInput(page)`` per adjacent pair,
finish propagation, early close on satisfied LIMITs).  Single-threaded:
pipelines run in dependency order, build sides first (the scans' prefetch
threads are the only others, and every one has ended when
:func:`run_pipelines` returns or raises).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from ..ops.expr import check_error_scalars
from ..spi.errors import GENERIC_INTERNAL_ERROR, TrinoError
from .operators import Operator, ScanOperator
from .stats import (EncodingStats, OperatorStats, PipelineStats, QueryStats,
                    ScanIngestStats)

__all__ = ["Driver", "run_pipelines", "collect_scan_stats",
           "collect_encoding_stats"]


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
        ops = self.operators
        n = len(ops)
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
                    self._timed(i + 1, nxt.finish_input)
                    progressed = True
            if not progressed and not ops[-1].is_finished():
                stuck = [type(o).__name__ for o in ops
                         if not o.is_finished()]
                raise TrinoError(GENERIC_INTERNAL_ERROR,
                                 f"driver stalled; unfinished: {stuck}")
        for op in ops[:-1]:
            if not op.is_finished():
                op.close()


def run_pipelines(pipelines: Sequence[Sequence[Operator]],
                  stats: Optional[QueryStats] = None) -> None:
    """Execute pipelines in dependency order, then raise any deferred
    expression error (one batched fetch over every operator's scalars)."""
    try:
        for p in pipelines:
            ps = None
            if stats is not None:
                ps = PipelineStats()
                stats.pipelines.append(ps)
            Driver(p, ps, sync=stats is not None and stats.sync).run()
    finally:
        for p in pipelines:
            for op in p:
                if isinstance(op, ScanOperator):
                    op.shutdown()
    if stats is not None:
        stats.read_counts()
        stats.scan = collect_scan_stats(pipelines)
        stats.encoding = collect_encoding_stats(pipelines)
    check_error_scalars([e for p in pipelines for op in p
                         for e in getattr(op, "pending_errors", ())])

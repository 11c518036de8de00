"""The driver's yieldable quantum and the time-sharing executor of the port.

The reference's test_driver_process_quantum_contract (tests/test_executor.py)
runs against the port's Driver, and TimeSharingTaskExecutor(2) runs the
pipelines of TPC-H Q1, Q3 and Q6 at SF 0.01 at once: each task's rows must
equal run_pipelines' rows of the same plan and the pinned reference's.
Each wait is bounded, so a scheduler that never finishes a task fails its
test instead of hanging the suite.
"""

import math

import numpy as np
import pytest

from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.tpch_queries import QUERIES
from trino_tpu_torch.exec import executor as EX
from trino_tpu_torch.exec.driver import Driver, run_pipelines
from trino_tpu_torch.exec.executor import TimeSharingTaskExecutor
from trino_tpu_torch.exec.local_planner import LocalPlanner
from trino_tpu_torch.exec.operators import (JoinBridge, LookupJoinOperator,
                                            OutputCollector, ValuesOperator)
from trino_tpu_torch.ops.expr import QueryError
from trino_tpu_torch.runner import StandaloneQueryRunner
from trino_tpu_torch.spi.batch import Column, ColumnBatch
from trino_tpu_torch.spi.types import BIGINT

SF = 0.01
WAIT_S = 120.0


@pytest.fixture(autouse=True)
def _pin(monkeypatch):
    for k, v in (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
                 ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
                 ("TRINO_TPU_OPTIMIZER", "iterative")):
        monkeypatch.setenv(k, v)


def test_driver_process_quantum_contract():
    """Driver.process returns blocked (not an exception) when an input is
    not ready yet, and finished once the pipeline drains."""
    batch = ColumnBatch(["a"], [Column(BIGINT, np.arange(4, dtype=np.int64))])
    bridge = JoinBridge()  # never becomes ready: the probe stays blocked
    probe = LookupJoinOperator(bridge, [0], "INNER", None, ["a", "b"],
                               [BIGINT, BIGINT])
    d = Driver([ValuesOperator(batch), probe, OutputCollector()])
    assert d.process() == "blocked"
    sink = OutputCollector()
    d2 = Driver([ValuesOperator(batch), sink])
    assert d2.process() == "finished"
    assert sink.batches[0].to_pylist() == [(0,), (1,), (2,), (3,)]


def test_driver_yields_at_its_deadline():
    batches = [ColumnBatch(["a"], [Column(BIGINT, np.arange(3))])
               for _ in range(5)]

    class Many(ValuesOperator):
        def __init__(self):
            super().__init__(None)
            self._left = list(batches)

        def get_output(self):
            return self._left.pop() if self._left else None

        def is_finished(self):
            return not self._left

    sink = OutputCollector()
    d = Driver([Many(), sink])
    assert d.process(deadline=0.0) == "progressed"  # one move, then yield
    assert len(sink.batches) == 1
    assert d.process() == "finished" and len(sink.batches) == 5


def test_levels_and_blocked_parking():
    assert [EX._level_of(s) for s in (0, 0.4, 0.5, 3, 100)] == [0, 0, 1, 2, 4]
    assert EX._BLOCKED_LEVEL == len(EX._LEVELS)


def _plan_pipelines(runner, sql):
    s = runner.session
    local = LocalPlanner(runner.catalog, "cpu",
                         splits_per_node=s.splits_per_node).plan(
        runner.create_plan(sql))
    return local


def _rows(local) -> list:
    b = local.collector.batches
    return ColumnBatch.concat(b).to_pylist() if b else []


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert math.isclose(a, b, rel_tol=1e-9), (g, w)
            else:
                assert a == b, (g, w)


def test_time_sharing_tpch():
    """Two workers time-share the three tasks' drivers; each task's rows
    equal run_pipelines' and the reference's."""
    runner = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    ref = RefRunner(ref_catalog(scale_factor=SF))
    ex = TimeSharingTaskExecutor(2)
    try:
        locals_ = {q: _plan_pipelines(runner, QUERIES[q]) for q in (1, 3, 6)}
        handles = {q: ex.submit(lp.pipelines) for q, lp in locals_.items()}
        for q, h in handles.items():
            h.wait(WAIT_S)
            seq = _plan_pipelines(runner, QUERIES[q])
            run_pipelines(seq.pipelines)
            _close(_rows(locals_[q]), _rows(seq))
            _close(_rows(locals_[q]), ref.execute(QUERIES[q]).rows())
    finally:
        ex.shutdown()


def test_time_sharing_error_propagates():
    runner = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    ex = TimeSharingTaskExecutor(2)
    try:
        lp = _plan_pipelines(runner, "select sum(n_nationkey / (n_regionkey "
                             "- n_regionkey)) from nation")
        h = ex.submit(lp.pipelines)
        with pytest.raises(QueryError, match="DIVISION_BY_ZERO"):
            h.wait(WAIT_S)
    finally:
        ex.shutdown()

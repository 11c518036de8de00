"""Memory accounting and revocation of the port against the reference.

The single-node cases of the reference's tests/test_memory.py (all but
its four disk-tier cases): the pool and context round trip, a sort whose
buffered batches outgrow a small pool and are revoked to host memory, and
a join + sort query larger than its pool.  The same inputs go through both
packages: the pool's numbers, the error message and the operator's
revocation count must agree.  The revocation order (the largest other
holders, then the requester, then ExceededMemoryLimitError) is checked
with stand-in operators.  Host residency is explicit in the port (a
revoked batch moves to ``_revoked``), so on the CPU it revokes exactly
when the reference does; that a revocation frees device memory is
tests/test_torch_gpu.py's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.exec.operators import SortOperator as RefSort
from trino_tpu.exec.revoking import TaskMemoryContext as RefContext
from trino_tpu.planner.plan import SortKey as RefSortKey
from trino_tpu.runner import Session as RefSession
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu.spi.batch import Column as RefColumn
from trino_tpu.spi.batch import ColumnBatch as RefBatch
from trino_tpu.spi.memory import ExceededMemoryLimitError as RefExceeded
from trino_tpu.spi.memory import MemoryPool as RefPool
from trino_tpu.spi.types import BIGINT as REF_BIGINT
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.exec.operators import (HashAggregationOperator,
                                            SortOperator)
from trino_tpu_torch.exec.revoking import (TaskMemoryContext,
                                           batch_device_nbytes,
                                           batch_device_residual)
from trino_tpu_torch.planner.plan import AggCall, SortKey
from trino_tpu_torch.runner import Session, StandaloneQueryRunner
from trino_tpu_torch.spi.batch import Column, ColumnBatch
from trino_tpu_torch.spi.memory import (AggregatedMemoryContext,
                                        ExceededMemoryLimitError, MemoryPool)
from trino_tpu_torch.spi.types import BIGINT

SF = 0.01


@pytest.fixture(autouse=True)
def _pin(monkeypatch):
    for k, v in (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
                 ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
                 ("TRINO_TPU_OPTIMIZER", "iterative")):
        monkeypatch.setenv(k, v)


def test_pool_and_context_roundtrip():
    pool = MemoryPool("hbm", 1000)
    root = AggregatedMemoryContext(pool=pool)
    a = root.new_local("a")
    b = root.new_local("b")
    a.set_bytes(400)
    b.set_bytes(500)
    assert pool.reserved == 900 and pool.free_bytes == 100
    with pytest.raises(ExceededMemoryLimitError) as got:
        a.set_bytes(600)
    with pytest.raises(RefExceeded) as want:
        RefPool("hbm", 1000).reserve(1200)
    assert str(got.value).replace("200 ", "") == str(want.value).replace(
        "1200 ", "")
    a.set_bytes(0)
    b.set_bytes(0)
    assert pool.reserved == 0
    root.close()
    with pytest.raises(RuntimeError, match="after close"):
        root.new_local("c").set_bytes(1)


def test_revocable_reservations_never_raise_in_the_pool():
    pool = MemoryPool("hbm", 100)
    pool.reserve(500, revocable=True)  # the task context checks capacity
    assert pool.reserved_revocable == 500 and pool.free_bytes == -400


def test_revocation_evicts_buffered_batches_as_the_reference_does():
    limit = 64 * 1024
    mem, rmem = TaskMemoryContext(limit), RefContext(hbm_limit_bytes=limit)
    op, ref = SortOperator([SortKey(0)]), RefSort([RefSortKey(0)])
    op.attach_memory(mem)
    ref.attach_memory(rmem)
    for i in range(20):  # 8 KiB a batch: the 64 KiB pool forces revocation
        op.add_input(ColumnBatch(["k"], [Column(
            BIGINT, torch.arange(i * 1024, (i + 1) * 1024))]))
        ref.add_input(RefBatch(["k"], [RefColumn(
            REF_BIGINT, jnp.arange(i * 1024, (i + 1) * 1024,
                                   dtype=jnp.int64))]))
        assert mem.reserved_bytes() == rmem.reserved_bytes() <= limit
    assert op.spill_count == getattr(ref, "spill_count", 0) >= 1
    assert len(op._revoked) >= 1
    assert batch_device_residual(op) == mem.reserved_bytes()
    op.finish_input()
    out = op.get_output()
    assert out.live is None and out.num_rows == 20 * 1024  # nothing lost
    assert out.columns[0].data.tolist() == list(range(20 * 1024))
    assert mem.reserved_bytes() == 0  # released at finish


class _Holder:
    """A stand-in operator holding ``nbytes`` until revoked."""

    def __init__(self, name, nbytes, log):
        self.name, self.nbytes, self.log = name, nbytes, log
        self._batches = []

    def revoke_memory(self) -> int:
        self.log.append(self.name)
        freed, self.nbytes = self.nbytes, 0
        return freed


def test_revocation_order_then_the_requester_then_an_error():
    log: list = []
    mem = TaskMemoryContext(1000)
    small, big, me = (_Holder("small", 200, log), _Holder("big", 500, log),
                      _Holder("me", 0, log))
    mem.update(small, 200)
    mem.update(big, 500)
    mem.update(me, 600)  # 300 free: the largest other holder goes first
    assert log == ["big"] and mem.reserved_bytes() == 800
    mem.update(me, 1100)  # the next holder, then the requester itself
    assert log == ["big", "small", "me"]
    assert mem.reserved_bytes() == 0  # me holds no batches after revoking
    me._batches = [ColumnBatch(["k"], [Column(BIGINT, torch.arange(200))])]
    with pytest.raises(ExceededMemoryLimitError, match="1000 bytes"):
        mem.update(me, 2000)  # still 1600 bytes after its own revocation


def test_aggregation_buffer_revoked_and_restored():
    mem = TaskMemoryContext(4096)
    op = HashAggregationOperator([0], [AggCall("sum", 1, BIGINT)],
                                 ["k", "s"], [BIGINT, BIGINT])
    op.attach_memory(mem)
    rng = np.random.default_rng(1)
    keys, vals = rng.integers(0, 20, 3000), rng.integers(0, 9, 3000)
    for lo in range(0, 3000, 300):
        op.add_input(ColumnBatch(["k", "v"], [
            Column(BIGINT, keys[lo:lo + 300]),
            Column(BIGINT, vals[lo:lo + 300])]))
    assert op.spill_count >= 1 and op.revoked_bytes > 0
    op.finish_input()
    got = dict(op.get_output().to_pylist())
    want = {int(k): int(vals[keys == k].sum()) for k in np.unique(keys)}
    assert got == want


def test_batch_bytes_count_columns_masks_and_live():
    b = ColumnBatch(["a", "b"], [
        Column(BIGINT, torch.arange(10), torch.ones(10, dtype=torch.bool)),
        Column(BIGINT, torch.arange(10))], torch.ones(10, dtype=torch.bool))
    b.columns[0]._valid = torch.ones(10, dtype=torch.bool)  # keep the mask
    assert batch_device_nbytes(b) == 80 + 10 + 80 + 10


@pytest.mark.parametrize("sql", [
    "select l_orderkey, count(*) from lineitem, orders "
    "where l_orderkey = o_orderkey group by l_orderkey "
    "order by l_orderkey limit 5",
    "select o_orderpriority, sum(l_quantity) from lineitem, orders "
    "where l_orderkey = o_orderkey group by o_orderpriority order by 1",
])
def test_query_larger_than_pool_completes(sql):
    """A join + aggregation + sort whose buffers exceed a 256 KB pool
    finishes by revoking to host memory, with the reference's rows."""
    port = StandaloneQueryRunner(default_catalog(SF), device="cpu",
                                 session=Session(hbm_limit_bytes=256 << 10))
    ref = RefRunner(ref_catalog(scale_factor=SF),
                    session=RefSession(hbm_limit_bytes=256 << 10))
    got = port.execute(sql).rows()
    assert got == ref.execute(sql).rows()
    assert got == StandaloneQueryRunner(default_catalog(SF),
                                        device="cpu").execute(sql).rows()


def test_operators_are_freed_with_the_query(monkeypatch):
    """No reference cycle keeps a finished query's operators (and the
    device buffers they hold: a join's build, an aggregation's result)
    alive until the cyclic collector runs: with it off, every operator is
    gone once the result is returned, a concurrent query's too."""
    import gc
    import weakref

    import trino_tpu_torch.exec.local_planner as LP

    refs = []
    orig = LP.LocalPlanner.plan

    def plan(self, root):
        out = orig(self, root)
        refs.extend(weakref.ref(op) for p in out.pipelines for op in p)
        return out

    monkeypatch.setattr(LP.LocalPlanner, "plan", plan)
    sql = ("select o_orderpriority, count(*), sum(l_quantity) from orders, "
           "lineitem where o_orderkey = l_orderkey and exists (select * "
           "from lineitem l2 where l2.l_orderkey = o_orderkey and "
           "l2.l_suppkey <> lineitem.l_suppkey) group by 1 order by 1")
    for session in (Session(), Session(task_concurrency=4,
                                       splits_per_node=8)):
        runner = StandaloneQueryRunner(default_catalog(SF), device="cpu",
                                       session=session)
        gc.collect()
        gc.disable()
        try:
            refs.clear()
            assert runner.execute(sql).rows()
            alive = [type(r()).__name__ for r in refs if r() is not None]
        finally:
            gc.enable()
        assert refs and not alive, alive

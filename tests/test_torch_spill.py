"""The disk tier of spill (exec/spill.py) against the reference.

The four disk-tier cases of the reference's tests/test_memory.py (a join +
ORDER BY ... LIMIT under a 64 KiB disk budget, the Spiller round trip, a
Q1-style aggregation and a high-cardinality one under a 1-byte budget,
which take the partitioned state spill), each query also with
``task_concurrency = 4`` (``splits_per_node = 8``), where the spills run
while other drivers may revoke, and a DISTINCT aggregate, which spills
raw pages instead of states.  Rows must equal the pinned reference's and
the port's run without a budget (doubles within rtol 1e-9: partial sums
add up in another order), and pages must have gone to disk.
"""

import math
import os

import numpy as np
import pytest
import torch

from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.runner import Session as RefSession
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.exec import driver as D
from trino_tpu_torch.exec import operators as OPS
from trino_tpu_torch.exec.revoking import TaskMemoryContext
from trino_tpu_torch.exec.spill import Spiller
from trino_tpu_torch.exec.stats import QueryStats
from trino_tpu_torch.runner import Session, StandaloneQueryRunner
from trino_tpu_torch.spi.batch import Column, ColumnBatch
from trino_tpu_torch.spi.types import BIGINT


@pytest.fixture(autouse=True)
def _pin(monkeypatch):
    for k, v in (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
                 ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
                 ("TRINO_TPU_OPTIMIZER", "iterative")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(D, "GROUP_TIMEOUT_S", 120.0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch's intra-op threads only contend at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# name -> (scale factor, session, sql, the tier the aggregation takes)
CASES = {
    # test_memory.py:61, test_disk_spill_tier
    "join_order_by_limit": (
        0.01, {"spill_to_disk_bytes": 64 * 1024},
        "select l_orderkey, o_orderdate from lineitem, orders "
        "where l_orderkey = o_orderkey order by l_orderkey, o_orderdate "
        "limit 5", None),
    # test_memory.py:128, test_partitioned_state_spill_agg
    "state_spill_q1": (
        0.05, {"spill_to_disk_bytes": 1},
        "select l_returnflag, l_linestatus, sum(l_quantity), "
        "avg(l_extendedprice), count(*), min(l_discount), "
        "max(l_shipdate) from lineitem "
        "group by l_returnflag, l_linestatus order by 1, 2", "states"),
    # test_memory.py:163, test_partitioned_spill_high_cardinality
    "state_spill_high_cardinality": (
        0.02, {"spill_to_disk_bytes": 1, "splits_per_node": 4},
        "select l_orderkey, sum(l_quantity), count(*) from lineitem "
        "group by l_orderkey", "states"),
    # DISTINCT cannot pre-aggregate: the raw-page tier
    "distinct_raw_pages": (
        0.01, {"spill_to_disk_bytes": 1},
        "select l_returnflag, count(distinct l_suppkey), sum(l_quantity) "
        "from lineitem group by l_returnflag order by 1", "pages"),
}


def _same(got, want, sql):
    if "order by" not in sql:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert math.isclose(a, b, rel_tol=1e-9), (g, w)
            else:
                assert type(a) is type(b) and a == b, (g, w)


@pytest.mark.parametrize("concurrency", [1, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_disk_spill_matches_reference(monkeypatch, case, concurrency):
    sf, kw, sql, tier = CASES[case]
    state_spills = []
    orig = OPS.HashAggregationOperator._spill_states

    def spy(self):
        orig(self)
        state_spills.append(self)

    monkeypatch.setattr(OPS.HashAggregationOperator, "_spill_states", spy)
    session = dict(kw)
    if concurrency > 1:
        session.update(task_concurrency=concurrency, splits_per_node=8)
    port = StandaloneQueryRunner(default_catalog(sf), device="cpu",
                                 session=Session(**session))
    st = QueryStats()
    got = port.execute(sql, stats=st).rows()
    want = RefRunner(ref_catalog(scale_factor=sf),
                     session=RefSession(**kw)).execute(sql).rows()
    _same(got, want, sql)
    _same(StandaloneQueryRunner(default_catalog(sf), device="cpu")
          .execute(sql).rows(), want, sql)
    _, _, pages, nbytes = st.spills()
    assert pages > 0 and nbytes > 0
    assert ", to disk " in st.text()
    if tier == "states":
        assert state_spills
    elif tier == "pages":
        assert not state_spills


def test_spiller_roundtrip(tmp_path):
    """test_memory.py:93; the file is anonymous from the start."""
    sp = Spiller(spill_dir=str(tmp_path))
    batches = [ColumnBatch(["x"], [Column(BIGINT, np.arange(i, i + 5,
                                                           dtype=np.int64))])
               for i in range(0, 20, 5)]
    for b in batches:
        sp.spill(b)
    assert os.listdir(tmp_path) == []
    assert sp.pages_spilled == 4 and sp.bytes_spilled > 0
    back = list(sp.read_back())
    sp.close()
    assert [b.to_pylist() for b in back] == [b.to_pylist() for b in batches]
    assert all(c.device.type == "cpu" for b in back for c in b.columns)


class _Buffer(OPS.BufferedInputMixin):
    def __init__(self):
        self._batches = []


def test_buffered_batches_keep_arrival_order_across_tiers():
    """Revocations and disk spills interleaved: the whole input comes back
    in the order it arrived (spilled pages, revoked batches, the rest)."""
    mem = TaskMemoryContext(hbm_limit_bytes=3 * 800 + 100,
                            spill_to_disk_bytes=5 * 800)
    op = _Buffer()
    op.attach_memory(mem)
    for i in range(12):  # 800 bytes a batch
        op.buffer(ColumnBatch(["k"], [Column(BIGINT,
                                             torch.arange(i * 100,
                                                          (i + 1) * 100))]))
    pages, nbytes, _, _ = op.disk_stats()
    assert op.spill_count >= 1 and pages >= 1 and nbytes > 0
    assert len(op._revoked) + len(op._batches) < 12
    got = torch.cat([b.columns[0].data for b in op.buffered_batches()])
    assert got.tolist() == list(range(1200))
    assert op._spiller is None and not op._revoked

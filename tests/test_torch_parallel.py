"""The local exchange, parallel drivers and revocation of the port, query
for query against the reference.

The single-node cases of the reference's tests/test_parallel.py (parallel
source chains behind a GATHER exchange, parallel aggregation drivers
behind a HASH exchange, cloned join probes, the exchange's backpressure)
run against the port.  Then the 22 TPC-H queries plus R1 / R2 at SF 0.01
run through both packages under two sessions, ``task_concurrency = 4``
and ``hbm_limit_bytes = 256 KiB`` (both with ``splits_per_node = 8``, the
multi-split scans the first needs): rows identical, doubles within rtol
1e-9, the REAL sums of R1 / R2 within 1e-4 (float32 sums in another
order).  The reference is pinned as ROADMAP "Pinning the reference" says.
Threaded runs are bounded by the driver's group timeout, set low here, so
a deadlock fails its test instead of hanging the suite.
"""

import math

import numpy as np
import pytest
import torch

from test_torch_queries_q13_q22 import R1, R2
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.ops.expr import QueryError as RefQueryError
from trino_tpu.runner import Session as RefSession
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.tpch_queries import QUERIES
from trino_tpu_torch.exec import driver as D
from trino_tpu_torch.exec.local_exchange import (GATHER, HASH, LocalExchange,
                                                 LocalExchangeSinkOperator,
                                                 LocalExchangeSourceOperator,
                                                 hash_partitions)
from trino_tpu_torch.exec.local_planner import LocalPlanner
from trino_tpu_torch.exec.operators import (HashAggregationOperator,
                                            LookupJoinOperator,
                                            OutputCollector, ScanOperator,
                                            ValuesOperator)
from trino_tpu_torch.exec.stats import QueryStats
from trino_tpu_torch.ops.expr import QueryError
from trino_tpu_torch.runner import Session, StandaloneQueryRunner
from trino_tpu_torch.spi.batch import Column, ColumnBatch
from trino_tpu_torch.spi.errors import TrinoError
from trino_tpu_torch.spi.types import BIGINT, VARCHAR
from trino_tpu_torch.caching import result_cache

SF = 0.01
SETTINGS = {"concurrency": {"task_concurrency": 4, "splits_per_node": 8},
            "revocation": {"hbm_limit_bytes": 256 << 10,
                           "splits_per_node": 8}}
CASES = [(f"Q{q}", QUERIES[q]) for q in sorted(QUERIES)] + [("R1", R1),
                                                              ("R2", R2)]


@pytest.fixture(autouse=True)
def _execution_not_cached():
    """Every statement here executes: a result-cache hit would skip the
    launches, syncs and revocations these tests count."""
    with result_cache.disabled():
        yield


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


@pytest.fixture(scope="module")
def catalogs():
    return default_catalog(SF), ref_catalog(scale_factor=SF)


@pytest.fixture(scope="module")
def runners(catalogs):
    """setting -> (port, reference) runners, made at first use."""
    made: dict = {}

    def get(setting: str):
        if setting not in made:
            kw = SETTINGS[setting]
            made[setting] = (
                StandaloneQueryRunner(catalogs[0], device="cpu",
                                      session=Session(**kw)),
                RefRunner(catalogs[1], session=RefSession(**kw)))
        return made[setting]
    return get


def _same(got, want, sql, rtol):
    if "order by" not in sql.lower():
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert math.isclose(a, b, rel_tol=rtol), (g, w)
            else:
                assert type(a) is type(b) and a == b, (g, w)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("name,sql", CASES, ids=[n for n, _ in CASES])
def test_queries_match_reference(runners, setting, name, sql):
    port, ref = runners(setting)
    rtol = 1e-4 if name in ("R1", "R2") else 1e-9
    _same(port.execute(sql).rows(), ref.execute(sql).rows(), sql, rtol)


# ---------------------------------------------------------------------------
# the plans fork as the reference's do


def _plan(catalog, sql: str, **kw):
    runner = StandaloneQueryRunner(catalog, device="cpu")
    return LocalPlanner(catalog, "cpu", splits_per_node=8, **kw).plan(
        runner.create_plan(sql))


def test_intra_task_parallel_drivers(catalogs):
    """Multi-split scans fork into concurrent source chains merged through
    a GATHER local exchange; results as the sequential run's."""
    sql = ("select l_returnflag, count(*), sum(l_quantity) from lineitem "
           "group by l_returnflag order by 1")
    plan = _plan(catalogs[0], sql, task_concurrency=4)
    sinks = [p for p in plan.pipelines
             if isinstance(p[-1], LocalExchangeSinkOperator)]
    assert len(sinks) >= 4
    shards = [p[0] for p in sinks if isinstance(p[0], ScanOperator)]
    (scan,) = [p[0] for p in _plan(catalogs[0], sql).pipelines
               if isinstance(p[0], ScanOperator)]
    # every split once, dealt round-robin over min(4, splits) shards
    assert len(shards) == min(4, len(scan.splits)) > 1
    assert sorted(map(repr, (s for sh in shards for s in sh.splits))) == \
        sorted(map(repr, scan.splits))
    assert len({id(p[0]._concurrent_group) for p in plan.pipelines}) == 1


def test_parallel_partitioned_aggregation_drivers(catalogs):
    sql = ("select o_custkey, count(*), sum(o_totalprice) from orders "
           "group by o_custkey order by 2 desc, 1 limit 7")
    plan = _plan(catalogs[0], sql, task_concurrency=4)
    agg_drivers = [p for p in plan.pipelines
                   if isinstance(p[0], LocalExchangeSourceOperator)
                   and any(isinstance(op, HashAggregationOperator)
                           for op in p)]
    c = min(4, len(plan.pipelines[0][0].connector.get_splits(
        "orders", 8, 1)))
    assert len(agg_drivers) == c > 1  # 3 splits of orders at SF 0.01
    assert agg_drivers[0][0].exchange.mode == HASH
    par = StandaloneQueryRunner(catalogs[0], device="cpu", session=Session(
        task_concurrency=4, splits_per_node=8))
    seq = StandaloneQueryRunner(catalogs[0], device="cpu")
    assert par.execute(sql).rows() == seq.execute(sql).rows()


def test_parallel_join_probe_drivers(catalogs):
    """INNER probes clone into every chain (each probing the one build),
    and a grouped aggregation downstream still partitions."""
    sql = ("select o_orderpriority, count(*) from lineitem, orders "
           "where l_orderkey = o_orderkey and l_shipdate > date '1996-01-01' "
           "group by o_orderpriority order by 1")
    plan = _plan(catalogs[0], sql, task_concurrency=4)
    probes = [op for p in plan.pipelines for op in p
              if isinstance(op, LookupJoinOperator)]
    assert len(probes) > 1 and len({id(op.bridge) for op in probes}) == 1
    par = StandaloneQueryRunner(catalogs[0], device="cpu", session=Session(
        task_concurrency=4, splits_per_node=8))
    seq = StandaloneQueryRunner(catalogs[0], device="cpu")
    assert par.execute(sql).rows() == seq.execute(sql).rows()


def test_deferred_error_in_a_chain_fails_the_query(catalogs):
    sql = "select sum(l_quantity / (l_linenumber - l_linenumber)) " \
          "from lineitem"
    par = StandaloneQueryRunner(catalogs[0], device="cpu", session=Session(
        task_concurrency=4, splits_per_node=8))
    ref = RefRunner(catalogs[1], session=RefSession(
        task_concurrency=4, splits_per_node=8))
    with pytest.raises(QueryError, match="DIVISION_BY_ZERO"):
        par.execute(sql)
    with pytest.raises(RefQueryError, match="DIVISION_BY_ZERO"):
        ref.execute(sql)


# ---------------------------------------------------------------------------
# the exchange


def _int_batch(values, live=None):
    return ColumnBatch(["x"], [Column(BIGINT, np.asarray(values, np.int64))],
                       live)


def test_local_exchange_backpressure_bounded():
    """A producer flooding a bounded exchange parks instead of buffering
    without bound (the isBlocked() contract)."""
    ex = LocalExchange(1, 1, GATHER, buffer_batches=2)
    sink = LocalExchangeSinkOperator(ex, 0, ["x"])
    b = _int_batch(np.arange(4))
    assert sink.needs_input()
    sink.add_input(b)
    sink.add_input(b)
    assert not sink.needs_input()  # full: the producer parks
    assert ex.poll(0) is not None
    assert sink.needs_input()  # drained below the bound: resumes


def test_hash_exchange_splits_live_rows_as_views():
    rng = np.random.default_rng(2)
    n = 5000
    keys = rng.integers(-10**3, 10**3, n) * 10**9  # duplicates, both signs
    valid = rng.random(n) < 0.9
    live = torch.from_numpy(rng.random(n) < 0.8)
    batch = ColumnBatch(["k"], [Column(BIGINT, keys, valid)], live)
    ex = LocalExchange(1, 4, HASH, key_channels=[0])
    ex.deposit(0, batch)
    parts = [ex.poll(j) for j in range(4)]
    masks = torch.stack([p.live for p in parts])
    assert all(p.columns[0].data is batch.columns[0].data for p in parts)
    assert torch.equal(masks.sum(0), live.to(torch.int64))  # disjoint cover
    null = ~torch.from_numpy(valid) & live
    assert bool((masks[0] | ~null).all())  # NULL keys go to partition 0
    # one key, one partition
    part = hash_partitions(batch, [0], 4).numpy()
    for k in np.unique(keys[:300]):
        sel = (keys == k) & valid
        assert len(set(part[sel])) <= 1


def test_hash_partitions_follow_values_not_codes():
    """Dictionary codes are per-batch namespaces: one string lands in one
    partition whichever dictionary carries it."""
    d1 = np.array(["a", "b", "c"], dtype=object)
    d2 = np.array(["b", "c", "d"], dtype=object)
    b1 = ColumnBatch(["s"], [Column(VARCHAR, np.array([0, 1, 2], np.int32),
                                    None, d1)])
    b2 = ColumnBatch(["s"], [Column(VARCHAR, np.array([0, 1, 2], np.int32),
                                    None, d2)])
    p1 = hash_partitions(b1, [0], 4).tolist()
    p2 = hash_partitions(b2, [0], 4).tolist()
    assert p1[1:] == p2[:2]  # "b", "c"


def test_group_timeout_fails_a_stuck_cluster(monkeypatch):
    """A consumer that waits for a producer which never comes: the group
    times out with a TrinoError instead of hanging."""
    monkeypatch.setattr(D, "GROUP_TIMEOUT_S", 0.5)
    ex = LocalExchange(2, 1, GATHER)  # two producers, only one runs
    gid = object()
    producer = [ValuesOperator(_int_batch([1, 2])),
                LocalExchangeSinkOperator(ex, 0, ["x"])]
    consumer = [LocalExchangeSourceOperator(ex, 0), OutputCollector()]
    producer[0]._concurrent_group = consumer[0]._concurrent_group = gid
    with pytest.raises(TrinoError, match="still running"):
        D.run_pipelines([producer, consumer])


def test_sibling_error_stops_the_cluster(monkeypatch):
    ex = LocalExchange(1, 1, GATHER)
    gid = object()

    class Boom(ValuesOperator):
        def get_output(self):
            raise RuntimeError("boom")

    producer = [Boom(_int_batch([1])), LocalExchangeSinkOperator(ex, 0,
                                                                 ["x"])]
    consumer = [LocalExchangeSourceOperator(ex, 0), OutputCollector()]
    producer[0]._concurrent_group = consumer[0]._concurrent_group = gid
    with pytest.raises(RuntimeError, match="boom"):
        D.run_pipelines([producer, consumer])


# ---------------------------------------------------------------------------
# revocation under a small pool, with the stats EXPLAIN ANALYZE prints


def test_small_pool_revokes_and_reports(catalogs):
    runner = StandaloneQueryRunner(catalogs[0], device="cpu", session=Session(
        hbm_limit_bytes=256 << 10, splits_per_node=8))
    st = QueryStats()
    rows = runner.execute(QUERIES[18], stats=st).rows()
    assert rows == StandaloneQueryRunner(catalogs[0], device="cpu").execute(
        QUERIES[18]).rows()
    spilled = [o for p in st.pipelines for o in p.operators if o.spill_count]
    assert spilled, "no operator revoked its buffer under 256 KiB"
    assert f", spilled {spilled[0].spill_count}x" in st.text()


def test_concurrency_with_a_small_pool(catalogs):
    sql = QUERIES[3]
    runner = StandaloneQueryRunner(catalogs[0], device="cpu", session=Session(
        hbm_limit_bytes=64 << 10, task_concurrency=4, splits_per_node=8))
    assert runner.execute(sql).rows() == StandaloneQueryRunner(
        catalogs[0], device="cpu").execute(sql).rows()


def test_shared_lazy_column_materializes_once_across_drivers():
    """The live-mask views of a HASH exchange share their columns, so
    concurrent aggregation drivers may read one LAZY column at once: its
    thunk runs once and every reader sees the data and its mask (on the
    card the scan makes LAZY columns; a slow thunk stands in here)."""
    import threading
    import time

    calls = []

    def thunk():
        calls.append(1)
        time.sleep(0.05)
        return np.arange(1000, dtype=np.int64), np.arange(1000) % 3 > 0

    col = Column.lazy(BIGINT, 1000, thunk, device="cpu")
    batch = ColumnBatch(["k"], [col])
    ex = LocalExchange(1, 4, HASH, key_channels=[0])
    ex.deposit(0, ColumnBatch(["k"], [Column(BIGINT, np.arange(1000))]))
    views = [ColumnBatch(["k"], [col], ex.poll(j).live) for j in range(4)]
    seen, errors = [], []

    def read(view):
        try:
            c = view.columns[0]
            seen.append((int(c.data.sum()), int(c.valid.sum())))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=read, args=(v,)) for v in views]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not errors and len(calls) == 1
    assert seen == [(499500, 666)] * 4
    assert batch.columns[0].encoding == "FLAT"

"""The port's collective REPARTITION edge against the reference's.

With ``worker_count=4`` both packages choose collective edges on the same
fragments (the reference's CPU mesh has 8 devices, so both see enough
shards) and give the same rows, through the lane layout and, with
``TILED_THRESHOLD_ROWS = 0`` in both packages, the tiled sorted-bucket
layout.  String keys route by value, PARTIAL -> FINAL reads no row back
to the host, a stalled ``take`` raises the retryable
PAGE_TRANSPORT_TIMEOUT, and above 8 tasks the port keeps the collective
edge where the reference (one device per task) takes the host edge: the
one departure, stated here.  The reference is pinned as in
tests/test_torch_distributed.py.
"""

import math

import numpy as np
import pytest
import torch

from test_torch_queries_q13_q22 import R1
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.execution import collective_exchange as RCE
from trino_tpu.execution.distributed_runner import (
    DistributedQueryRunner as RefDist)
from trino_tpu.runner import Session as RefSession
from trino_tpu_torch.caching import result_cache
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.tpch_queries import QUERIES
from trino_tpu_torch.exec import syncguard as SG
from trino_tpu_torch.execution import collective_exchange as CE
from trino_tpu_torch.execution.distributed_runner import (
    DistributedQueryRunner)
from trino_tpu_torch.parallel.distributed import make_mesh
from trino_tpu_torch.runner import Session
from trino_tpu_torch.spi import batch as B
from trino_tpu_torch.spi.batch import Column, ColumnBatch
from trino_tpu_torch.spi.errors import PAGE_TRANSPORT_TIMEOUT, TrinoError
from trino_tpu_torch.spi.types import BIGINT, DOUBLE, VARCHAR

SF = 0.01
PINS = (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
        ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
        ("TRINO_TPU_OPTIMIZER", "iterative"),
        ("TRINO_TPU_FUSED_STAGE", "0"), ("TRINO_TPU_RESIDENT_PLAN", "0"))
SUBSET = {"Q1": QUERIES[1], "Q3": QUERIES[3], "Q13": QUERIES[13],
          "Q18": QUERIES[18], "R1": R1}


@pytest.fixture(autouse=True)
def _execution_not_cached():
    with result_cache.disabled():
        yield


@pytest.fixture(autouse=True)
def _pin(monkeypatch):
    for k, v in PINS:
        monkeypatch.setenv(k, v)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runners():
    return (DistributedQueryRunner(default_catalog(SF), worker_count=4,
                                   session=Session(node_count=4),
                                   device="cpu"),
            RefDist(ref_catalog(scale_factor=SF), worker_count=4,
                    session=RefSession(node_count=4)))


def _same(got, want, ordered: bool, rtol: float = 1e-9) -> None:
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert math.isclose(a, b, rel_tol=rtol), (g, w)
            else:
                assert type(a) is type(b) and a == b, (g, w)


def _both(runners, sql: str, name: str = ""):
    port, ref = runners
    got = port.execute(sql).rows()
    want = ref.execute(sql).rows()
    _same(got, want, "order by" in sql.lower(), 1e-4 if name == "R1"
          else 1e-9)
    assert port._collective_edges, "no collective edge"
    assert sorted(port._collective_edges) == sorted(ref._collective_edges)
    return port, ref


@pytest.mark.parametrize("name", sorted(SUBSET))
@pytest.mark.parametrize("tiled", [False, True], ids=["lanes", "tiled"])
def test_collective_edges_and_rows_match_reference(runners, monkeypatch,
                                                   name, tiled):
    if tiled:
        monkeypatch.setattr(CE, "TILED_THRESHOLD_ROWS", 0)
        monkeypatch.setattr(RCE, "TILED_THRESHOLD_ROWS", 0)
    port, _ = _both(runners, SUBSET[name], name)
    assert all(e.tiled == tiled for e in port._collective_edges.values())


def test_string_keys_route_by_value(runners):
    _both(runners, "select o_orderpriority, count(*) from orders "
                   "group by o_orderpriority")


@pytest.mark.parametrize("tiled", [False, True], ids=["lanes", "tiled"])
def test_partitioned_string_join_routes_consistently(runners, monkeypatch,
                                                     tiled):
    """Both REPARTITION edges of a partitioned string-key join route equal
    values to the same task though each edge unifies its own dictionary."""
    monkeypatch.setenv("TRINO_TPU_BROADCAST_ROW_LIMIT", "0")
    if tiled:
        monkeypatch.setattr(CE, "TILED_THRESHOLD_ROWS", 0)
        monkeypatch.setattr(RCE, "TILED_THRESHOLD_ROWS", 0)
    port, _ = _both(runners, "select a.n_name, b.n_regionkey from nation a "
                             "join nation b on a.n_name = b.n_name")
    assert len(port._collective_edges) == 2


def test_partial_final_reads_no_rows_back(runners, monkeypatch):
    """The deposits are the tasks' device batches (torch tensors, never
    numpy), and the lane layout reads nothing back: the query's counted
    host reads carry no exchange tag."""
    port, _ = runners
    seen = []
    orig = CE.CollectiveRepartitionExchange.deposit

    def spy(self, task_index, batches):
        for b in batches:
            seen.extend(isinstance(c.data, torch.Tensor) for c in b.columns)
        return orig(self, task_index, batches)

    monkeypatch.setattr(CE.CollectiveRepartitionExchange, "deposit", spy)
    before = SG.snapshot()
    _both(runners, "select l_returnflag, avg(l_quantity) from lineitem "
                   "group by l_returnflag")
    tags = SG.take_delta(before).by_tag
    assert seen and all(seen)
    assert not [t for t in tags if t.startswith("exchange.")], tags


def test_tiled_layout_reads_one_count_matrix(runners, monkeypatch):
    monkeypatch.setattr(CE, "TILED_THRESHOLD_ROWS", 0)
    monkeypatch.setattr(RCE, "TILED_THRESHOLD_ROWS", 0)
    before = SG.snapshot()
    port, _ = _both(runners, "select l_returnflag, count(*) from lineitem "
                             "group by l_returnflag")
    tags = SG.take_delta(before).by_tag
    assert tags.get("exchange.tile-counts") == len(port._collective_edges)


def test_collectives_off_takes_host_edges():
    port = DistributedQueryRunner(
        default_catalog(SF), worker_count=4, device="cpu",
        session=Session(node_count=4, use_collectives=False))
    ref = RefDist(ref_catalog(scale_factor=SF), worker_count=4,
                  session=RefSession(node_count=4, use_collectives=False))
    sql = "select l_returnflag, count(*) from lineitem group by l_returnflag"
    _same(port.execute(sql).rows(), ref.execute(sql).rows(), False)
    assert not port._collective_edges and not ref._collective_edges


def _exchange(n: int = 2):
    return CE.CollectiveRepartitionExchange(
        n, [0], ["k"], [BIGINT], make_mesh(n, device="cpu"))


def test_stalled_take_raises_retryable_timeout():
    ex = _exchange()
    ex.deposit(0, [ColumnBatch(["k"], [Column(BIGINT, np.arange(3))])])
    with pytest.raises(TrinoError) as info:
        ex.take(1, timeout=0.1)
    assert info.value.code == PAGE_TRANSPORT_TIMEOUT
    assert info.value.is_retryable()


def test_failed_shuffle_fails_every_take_and_is_not_rerun(monkeypatch):
    """A shuffle that raises fails its consumers with the reference's
    classification; nothing re-runs the edge on the host exchange."""
    ex = _exchange()
    calls = []

    def boom(*a):
        calls.append(1)
        raise ValueError("lane copy failed")

    monkeypatch.setattr(ex, "_lanes", boom)
    for i in range(2):
        ex.deposit(i, [ColumnBatch(["k"], [Column(BIGINT, np.arange(3))])])
    for i in range(2):
        with pytest.raises(TrinoError, match="collective exchange failed"):
            ex.take(i, timeout=1)
    assert calls == [1]


def test_empty_deposits_give_empty_shards():
    ex = _exchange(3)
    for i in range(3):
        ex.deposit(i, [])
    for i in range(3):
        b = ex.take(i, timeout=1)
        assert b.live is not None and not bool(b.live.any())


def test_more_tasks_than_reference_devices(runners):
    """Above 8 tasks the reference's mesh (one device per task) has no room
    and its edge is a host edge; the port's shards share devices, so its
    edge stays collective.  The rows agree."""
    port = DistributedQueryRunner(default_catalog(SF), worker_count=9,
                                  session=Session(node_count=9),
                                  device="cpu")
    ref = RefDist(ref_catalog(scale_factor=SF), worker_count=9,
                  session=RefSession(node_count=9))
    sql = ("select l_returnflag, l_linestatus, count(*), sum(l_quantity) "
           "from lineitem group by l_returnflag, l_linestatus")
    _same(port.execute(sql).rows(), ref.execute(sql).rows(), False)
    assert port._collective_edges and not ref._collective_edges
    assert CE.collectives_available(9) and not RCE.collectives_available(9)
    assert CE.collectives_available(4) == RCE.collectives_available(4)


def test_runner_mesh_is_the_runner_device(monkeypatch):
    """Every task of the runner plans and runs on its device, so every
    shard of a collective edge lies there too, whatever ``make_mesh``
    would place on a host with more cards (shard i on
    ``cuda:(i % device_count)``); the runner never asks it."""
    from trino_tpu_torch.parallel import distributed as PD

    def spread(*a, **kw):
        raise AssertionError("the runner asked make_mesh for its mesh")

    monkeypatch.setattr(PD, "make_mesh", spread)
    port = DistributedQueryRunner(default_catalog(SF), worker_count=4,
                                  session=Session(node_count=4),
                                  device="cpu")
    sql = "select l_returnflag, count(*) from lineitem group by l_returnflag"
    rows = port.execute(sql).rows()
    assert port._collective_edges
    for edge in port._collective_edges.values():
        assert list(edge.mesh) == [port.device] * 4
    assert sum(r[1] for r in rows) == port.execute(
        "select count(*) from lineitem").rows()[0][0]


# a filter on the partition key leaves most consumer shards with lanes but
# no live row (tests/test_shape_stress.py::test_empty_partitions_on_mesh):
# every buffering operator behind the edge must take such a shard
EMPTY_SHARDS = {
    "window_count": ("select o_custkey, count(*) over (partition by "
                     "o_custkey) from orders where o_custkey = 1", False),
    "ranking": ("select o_custkey, o_orderkey, row_number() over "
                "(partition by o_custkey order by o_orderkey), rank() over "
                "(partition by o_custkey order by o_orderdate), "
                "lag(o_totalprice) over (partition by o_custkey order by "
                "o_orderkey) from orders where o_custkey in (1, 2, 4)",
                False),
    "order_limit": ("select o_custkey, o_orderkey, count(*) over "
                    "(partition by o_custkey) from orders "
                    "where o_custkey = 1 order by o_orderkey limit 3", True),
}


@pytest.mark.parametrize("name", sorted(EMPTY_SHARDS))
def test_shards_without_live_rows_match_reference(runners, name):
    sql, ordered = EMPTY_SHARDS[name]
    port, ref = runners
    got = port.execute(sql).rows()
    want = ref.execute(sql).rows()
    assert port._collective_edges
    assert got and len(got) == len(want)
    _same(got, want, ordered)


def _dead_batch(n: int = 8) -> ColumnBatch:
    return ColumnBatch(["k", "s", "x"], [
        Column(BIGINT, torch.arange(n)),
        Column(VARCHAR, torch.zeros(n, dtype=torch.int32), None,
               np.array(["a"], dtype=object)),
        Column(DOUBLE, torch.ones(n, dtype=torch.float64))],
        torch.zeros(n, dtype=torch.bool))


def _match_recognize_operator():
    from trino_tpu_torch.connectors.window_queries import m1_text
    from trino_tpu_torch.exec.match_recognize import MatchRecognizeOperator
    from trino_tpu_torch.planner.plan import MatchRecognize
    from trino_tpu_torch.runner import StandaloneQueryRunner

    plan = StandaloneQueryRunner(default_catalog(SF), device="cpu"
                                 ).create_plan(m1_text("orders"))
    stack = [plan]
    while not isinstance(stack[-1], MatchRecognize):
        stack.extend(stack.pop().children)
    node = stack[-1]
    width = len(node.source.output_types)
    cols = [Column(t, torch.zeros(8, dtype=torch.int32), None,
                   np.array(["a"], dtype=object))
            if t.is_dictionary_encoded else
            Column(t, torch.zeros(8, dtype=B.torch_dtype(t.storage_dtype)))
            for t in node.source.output_types]
    batch = ColumnBatch(list(node.source.output_names), cols,
                        torch.zeros(8, dtype=torch.bool))
    assert batch.num_columns == width
    return MatchRecognizeOperator(
        node.partition_channels, node.order_keys, node.pattern,
        node.defines, node.measures, node.skip_past, node.output_names,
        node.output_types, node.source.output_names), batch


def _buffering_operator(kind: str):
    from trino_tpu_torch.exec import operators as O
    from trino_tpu_torch.planner.plan import AggCall, SortKey, WindowFunc

    types = [BIGINT, VARCHAR, DOUBLE, BIGINT, DOUBLE]
    aggs = [AggCall("count", -1, BIGINT), AggCall("sum", 2, DOUBLE)]
    if kind.startswith("aggregation"):
        step = kind.split("_")[1].upper()
        if step == "FINAL":
            aggs = [AggCall("count", 0, BIGINT), AggCall("sum", 2, DOUBLE)]
        return O.HashAggregationOperator(
            [1], aggs, ["s", "c", "x"], [VARCHAR, BIGINT, DOUBLE], step), \
            _dead_batch()
    if kind == "sort":
        return O.SortOperator([SortKey(0)]), _dead_batch()
    if kind == "topn":
        return O.TopNOperator(3, [SortKey(2, False)]), _dead_batch()
    if kind == "distinct_limit":
        return O.DistinctLimitOperator(3), _dead_batch()
    if kind == "window":
        return O.WindowOperator(
            [0], [SortKey(2)], [WindowFunc("row_number", (), BIGINT),
                                WindowFunc("lag", (2,), DOUBLE)],
            ["k", "s", "x", "r", "l"], types), _dead_batch()
    if kind == "join_build":
        bridge = O.JoinBridge()
        return O.JoinBuildSink(bridge, [0], types[:3], ["k", "s", "x"],
                               "cpu"), _dead_batch()
    return _match_recognize_operator()


@pytest.mark.parametrize("kind", [
    "aggregation_single", "aggregation_partial", "aggregation_final",
    "sort", "topn", "distinct_limit", "window", "join_build",
    "match_recognize"])
def test_buffering_operator_takes_a_shard_without_live_rows(kind):
    """A collective shard has lanes but may have no live row: each
    buffering operator finishes on one and emits no live row."""
    op, batch = _buffering_operator(kind)
    op.add_input(batch)
    op.finish_input()
    outs = [op.get_output() for _ in range(3)]
    rows = [r for o in outs if o is not None for r in o.to_pylist()]
    assert rows == []
    if kind == "join_build":
        assert op.bridge.batch.num_rows == 0 and op.bridge.table is not None

"""The port's distributed runner against the reference's, query for query.

The 22 TPC-H queries and R1 / R2 at SF 0.01 run through both packages'
``DistributedQueryRunner(worker_count=3)``: rows identical (in order for
the queries tests/test_distributed.py orders), doubles within rtol 1e-9,
the REAL sums of R1 / R2 within 1e-4 (the tolerance of
tests/test_torch_queries_q13_q22.py: float32 sums in another order).
``create_subplan`` gives the reference's fragments and ``explain`` its
text.  Then the cases of the reference's tests/test_distributed.py,
tests/test_merge_exchange.py and test_parallel.py's distributed one, a
DistinctLimit plan, the time-sharing scheduler, wire-format pages, the
task lifecycle's telemetry and what the slice refuses.  The reference is
pinned as ROADMAP "Pinning the reference" says, with the compiled stages
off (``TRINO_TPU_FUSED_STAGE=0``, ``TRINO_TPU_RESIDENT_PLAN=0``), which
both packages read: each runs every edge on the per-operator and
collective path (tests/test_torch_fused_stage.py and
tests/test_torch_resident_plan.py hold the compiled stages).
"""

import dataclasses
import math

import pytest
import torch

from test_torch_queries_q13_q22 import R1, R2
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.execution.distributed_runner import (
    DistributedQueryRunner as RefDist)
from trino_tpu.runner import Session as RefSession
from trino_tpu.testing.oracle import SqliteOracle, assert_same_rows
from trino_tpu_torch.caching import result_cache
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.tpch_queries import QUERIES
from trino_tpu_torch.execution import task as T
from trino_tpu_torch.execution.distributed_runner import (
    DistributedQueryRunner)
from trino_tpu_torch.execution.fragmenter import fragment_plan
from trino_tpu_torch.planner.add_exchanges import add_exchanges
from trino_tpu_torch.planner.plan import DistinctLimit, plan_text
from trino_tpu_torch.runner import Session, StandaloneQueryRunner
from trino_tpu_torch.telemetry import metrics as tm
from trino_tpu_torch.telemetry import runtime as rt

SF = 0.01
_ORDERED = {1, 2, 3, 5, 7, 8, 9, 10, 11, 12, 13, 14, 16, 18, 21, 22}
CASES = ([(f"Q{q}", QUERIES[q], q in _ORDERED) for q in sorted(QUERIES)]
         + [("R1", R1, True), ("R2", R2, True)])
PINS = (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
        ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
        ("TRINO_TPU_OPTIMIZER", "iterative"),
        ("TRINO_TPU_FUSED_STAGE", "0"), ("TRINO_TPU_RESIDENT_PLAN", "0"))


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
    """torch's intra-op threads only contend at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runners():
    port = DistributedQueryRunner(default_catalog(SF), worker_count=3,
                                  device="cpu")
    ref = RefDist(ref_catalog(scale_factor=SF), worker_count=3)
    return port, ref


def _same(got, want, ordered: bool, rtol: float = 1e-9) -> None:
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert math.isclose(a, b, rel_tol=rtol), (g, w)
            else:
                assert type(a) is type(b) and a == b, (g, w)


@pytest.mark.parametrize("name,sql,ordered", CASES,
                         ids=[n for n, _, _ in CASES])
def test_queries_match_reference(runners, name, sql, ordered):
    port, ref = runners
    got = port.execute(sql).rows()
    want = ref.execute(sql).rows()
    _same(got, want, ordered, 1e-4 if name in ("R1", "R2") else 1e-9)


def _fragments(subplan) -> list:
    return [(f.id, f.partitioning, f.output_kind, tuple(f.output_keys),
             tuple(f.source_fragments), plan_text(f.root),
             f.device_resident, f.fused_seam is not None,
             None if f.fused_seam is None else
             (f.fused_seam.producer_fid, f.fused_seam.consumer_fid,
              f.fused_seam.nk),
             f.resident_plan is not None)
            for f in subplan.all_fragments()]


@pytest.mark.parametrize("name,sql,ordered", CASES,
                         ids=[n for n, _, _ in CASES])
def test_fragments_and_explain_match_reference(runners, name, sql,
                                               ordered):
    port, ref = runners
    assert _fragments(port.create_subplan(sql)) == \
        _fragments(ref.create_subplan(sql))
    assert port.explain(sql) == ref.explain(sql)


def test_fragment_shapes(runners):
    port, _ = runners
    text = port.explain(QUERIES[3])
    assert "PARTIAL" in text and "FINAL" in text
    assert "BROADCAST" in text and "REPARTITION" in text
    assert text.count("Fragment") >= 4


def test_partial_final_global_agg(runners):
    """Empty input: every task emits a default partial row; FINAL still
    gives count 0 / sum NULL."""
    port, _ = runners
    assert port.execute("select count(*), sum(o_totalprice) from orders "
                        "where o_orderkey < 0").rows() == [(0, None)]


def test_distributed_limit_early_close(runners):
    port, _ = runners
    assert len(port.execute("select o_orderkey from orders limit 5")
               .rows()) == 5


@pytest.fixture(scope="module")
def oracle():
    o = SqliteOracle()
    conn = ref_catalog(scale_factor=SF).connector("tpch")
    for t in ("nation", "orders", "lineitem"):
        cols = conn.get_table_schema(t).column_names()
        batches = []
        for s in conn.get_splits(t, 2, 1):
            src = conn.create_page_source(s, cols)
            while not src.is_finished():
                b = src.get_next_batch()
                if b is not None:
                    batches.append(b)
        o.load_table(t, batches)
    return o


def test_plan_uses_merge_exchange(runners):
    port, _ = runners
    text = port.explain("select o_orderdate from orders order by o_orderdate")
    assert "MERGE" in text
    assert text.count("Sort") == 1  # one per-task sort, no re-sort


ORDERED_QUERIES = [
    "select o_orderdate, o_totalprice from orders "
    "order by o_orderdate, o_totalprice desc limit 50",
    "select n_regionkey, n_name from nation order by n_regionkey desc, n_name",
    "select o_totalprice, o_orderdate from orders "
    "order by o_totalprice desc limit 25",
    "select o_orderpriority, count(*) from orders group by o_orderpriority "
    "order by o_orderpriority",
    # past MergeSourceOperator.MERGE_ROW_LIMIT (set low below): the
    # gathered streams are sorted again on their device
    "select o_orderkey, o_orderdate from orders "
    "order by o_orderdate desc, o_orderkey",
]


@pytest.mark.parametrize("sql", ORDERED_QUERIES)
def test_merge_ordering_matches_oracle(runners, oracle, monkeypatch, sql):
    port, _ = runners
    monkeypatch.setattr(T.MergeSourceOperator, "MERGE_ROW_LIMIT", 1000)
    assert_same_rows(port.execute(sql).rows(), oracle.query(sql),
                     ordered=True)


def test_intra_task_parallel_distributed():
    cat = default_catalog(SF)
    dist = DistributedQueryRunner(
        cat, worker_count=2, device="cpu",
        session=Session(node_count=2, task_concurrency=2,
                        splits_per_node=4))
    seq = StandaloneQueryRunner(cat, device="cpu")
    sql = ("select o_orderpriority, count(*) from orders "
           "group by o_orderpriority order by 1")
    assert dist.execute(sql).rows() == seq.execute(sql).rows()


def _distinct_limit(runner, sql: str, count: int):
    """``sql``'s plan (before add_exchanges) under a DistinctLimit node,
    fragmented and run: no SQL text plans one, so the test builds it."""
    from trino_tpu_torch.planner.logical import LogicalPlanner
    from trino_tpu_torch.planner.optimizer import optimize
    from trino_tpu_torch.sql.parser import parse_statement

    plan = optimize(LogicalPlanner(runner.catalog).plan(
        parse_statement(sql)), runner.catalog)
    src = plan.source
    plan = dataclasses.replace(plan, source=DistinctLimit(
        src.output_names, src.output_types, src, count))
    sub = fragment_plan(add_exchanges(plan))
    return sub, runner._execute_subplan(sub, None).rows()


def _ref_distinct_limit(runner, sql: str, count: int):
    from trino_tpu.execution.fragmenter import fragment_plan as rfp
    from trino_tpu.planner.add_exchanges import add_exchanges as rae
    from trino_tpu.planner.logical import LogicalPlanner as RLP
    from trino_tpu.planner.optimizer import optimize as ropt
    from trino_tpu.planner.plan import DistinctLimit as RDL
    from trino_tpu.sql.parser import parse_statement as rparse

    plan = ropt(RLP(runner.catalog).plan(rparse(sql)), runner.catalog)
    src = plan.source
    plan = dataclasses.replace(plan, source=RDL(
        src.output_names, src.output_types, src, count))
    sub = rfp(rae(plan))
    return sub, runner._execute_subplan(sub, None).rows()


@pytest.mark.parametrize("count", [None, 4, 100])
def test_distinct_limit_matches_reference(runners, count):
    """A partial DistinctLimitOperator per task, a GATHER, the final one:
    the fragments are the reference's, and the rows are distinct rows of
    the input, all of them when the limit does not cut."""
    port, ref = runners
    sql = "select o_orderpriority, o_orderstatus from orders"
    sub, got = _distinct_limit(port, sql, count)
    rsub, want = _ref_distinct_limit(ref, sql, count)
    assert sub.text() == rsub.text()
    assert sub.text().count("DistinctLimit") == 2
    assert len(got) == len(set(got)) == len(want)
    every = set(port.execute(f"select distinct o_orderpriority, "
                             f"o_orderstatus from orders").rows())
    assert set(got) <= every
    if count is None or count >= len(every):
        assert set(got) == set(want) == every


@pytest.mark.parametrize("name", ["Q3", "Q9", "Q18", "R1"])
def test_time_sharing_scheduler(name):
    sql = dict((n, s) for n, s, _ in CASES)[name]
    port = DistributedQueryRunner(
        default_catalog(SF), worker_count=3, device="cpu",
        session=Session(node_count=3, task_scheduler="TIME_SHARING",
                        executor_workers=2))
    ref = RefDist(ref_catalog(scale_factor=SF), worker_count=3,
                  session=RefSession(node_count=3,
                                     task_scheduler="TIME_SHARING",
                                     executor_workers=2))
    _same(port.execute(sql).rows(), ref.execute(sql).rows(), True,
          1e-4 if name == "R1" else 1e-9)


@pytest.mark.parametrize("name", ["Q3", "Q13", "Q18"])
def test_exchange_serde_pages(monkeypatch, name):
    """Host-edge pages cross as the wire format's bytes (serde.py, the
    reference's byte layout) and give the same rows."""
    sql = QUERIES[int(name[1:])]
    seen = []
    orig = T.serialize_batch

    def spy(batch, *a, **kw):
        out = orig(batch, *a, **kw)
        seen.append(len(out))
        return out

    monkeypatch.setattr(T, "serialize_batch", spy)
    port = DistributedQueryRunner(
        default_catalog(SF), worker_count=3, device="cpu",
        session=Session(node_count=3, exchange_serde=True))
    ref = RefDist(ref_catalog(scale_factor=SF), worker_count=3,
                  session=RefSession(node_count=3, exchange_serde=True))
    _same(port.execute(sql).rows(), ref.execute(sql).rows(),
          int(name[1:]) in _ORDERED)
    assert seen and all(n > 0 for n in seen)


def test_task_telemetry_matches_reference():
    """After one distributed query the port's system.runtime.tasks lists
    the reference's number of tasks, FINISHED, and the task counters and
    wall distribution moved by it."""
    sql = QUERIES[3]
    port = DistributedQueryRunner(default_catalog(SF), worker_count=3,
                                  device="cpu")
    ref = RefDist(ref_catalog(scale_factor=SF), worker_count=3)
    created = tm.TASKS_CREATED.value()
    walls = tm.TASK_WALL_SECONDS.snapshot()["count"]
    port.execute(sql, query_id="dq_tasks_port")
    created = tm.TASKS_CREATED.value() - created
    walls = tm.TASK_WALL_SECONDS.snapshot()["count"] - walls
    ref.execute(sql, query_id="dq_tasks_ref")
    rows = port.execute(
        "select task_id, fragment, state from system.runtime.tasks "
        "where query_id = 'dq_tasks_port'").rows()
    want = ref.execute(
        "select task_id, fragment, state from system.runtime.tasks "
        "where query_id = 'dq_tasks_ref'").rows()
    assert sorted(rows) == sorted(want)
    assert {r[2] for r in rows} == {"FINISHED"}
    assert created == walls == len(rows)
    assert len([t for t in rt.tasks() if t.query_id == "dq_tasks_port"]) \
        == len(rows)
    tasks = []

    def walk(s):
        if s.name == "trino.task":
            tasks.append(s.attributes["trino.task.id"])
        for c in s.children:
            walk(c)

    port.execute(sql, query_id="dq_tasks_span")
    walk(port.tracer.finished[-1])
    assert sorted(tasks) == sorted(r[0] for r in rows)


@pytest.mark.parametrize("prop,value", [
    ("retry_policy", "'TASK'"), ("retry_policy", "'QUERY'"),
    ("speculation", "true"), ("adaptive", "'1'")])
def test_unported_properties_raise(prop, value):
    """Fault-tolerant execution, query retry, speculation and the adaptive
    plane are ported: each property set by SQL runs the query to the
    reference's rows (tests/test_torch_fte.py, test_torch_resilience.py
    and test_torch_adaptive.py hold them in depth)."""
    port = DistributedQueryRunner(default_catalog(SF), worker_count=2,
                                  device="cpu")
    ref = RefDist(ref_catalog(scale_factor=SF), worker_count=2)
    sql = ("select n_regionkey, count(*) from nation, region "
           "where n_regionkey = r_regionkey group by 1 order by 1")
    for r in (port, ref):
        r.execute(f"set session {prop} = {value}")
    assert port.session.get(prop) == ref.session.__dict__[prop]
    _same(port.execute(sql).rows(), ref.execute(sql).rows(), True)


def test_unported_methods_raise():
    """What stays refused names its ROADMAP queue item: worker drains (the
    control plane, item 4) and PROCESS_EXIT injection (worker processes,
    item 5)."""
    from trino_tpu_torch.execution.failure_injector import (
        PROCESS_EXIT, FailureInjector)

    port = DistributedQueryRunner(default_catalog(SF), worker_count=2,
                                  device="cpu")
    for call in (lambda: port.drain_worker("worker-0"),
                 lambda: port.restore_worker("worker-0")):
        with pytest.raises(NotImplementedError, match="item 4"):
            call()
    with pytest.raises(NotImplementedError, match="item 5"):
        FailureInjector().inject(PROCESS_EXIT, fragment_id=1)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DistributedQueryRunner(default_catalog(SF), worker_count=2)


def test_execution_key_holds_device_and_workers():
    a = DistributedQueryRunner(default_catalog(SF), worker_count=2,
                               device="cpu")
    b = DistributedQueryRunner(default_catalog(SF), worker_count=3,
                               device="cpu")
    assert "cpu" in a.execution_key and a.execution_key != b.execution_key


def test_scaled_writers_ctas_matches_reference():
    """scale_writers plans a ROUND_ROBIN exchange into parallel writer
    tasks (the ARBITRARY fragment); they race to create the CTAS target,
    and the table holds every row once, as the reference's does."""
    port = DistributedQueryRunner(default_catalog(SF), worker_count=3,
                                  device="cpu")
    ref = RefDist(ref_catalog(scale_factor=SF), worker_count=3)
    sql = ("create table memory.sw as select o_orderkey, o_orderstatus "
           "from orders where o_orderkey < 2000")
    for r in (port, ref):
        r.execute("set session scale_writers = true")
    assert "ARBITRARY" in port.explain(sql) and \
        port.explain(sql) == ref.explain(sql)
    assert port.execute(sql).rows() == ref.execute(sql).rows()
    q = "select count(*), sum(o_orderkey) from memory.sw"
    assert port.execute(q).rows() == ref.execute(q).rows()

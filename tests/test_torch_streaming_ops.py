"""PARTIAL / FINAL aggregation and bounded-memory operators of the port.

The cases of the reference's tests/test_streaming_ops.py (the PARTIAL
step's early flush, its bounded buffer, the streaming TopN) run against
the port, the flush also beside the reference's operator on the same
input.  Then the state layouts: avg as (sum, count), the variance family
as (sum, sum of squares, count), count, min / max / any_value over
strings whose batches carry different dictionaries, NULL inputs, a global
aggregate over no rows; PARTIAL -> FINAL must give SINGLE's rows.  Last,
the 22 TPC-H queries plus R1 / R2 at SF 0.01 with every aggregation that
can split run as PARTIAL -> FINAL (``split_aggregation``) with a 4,096-row
flush window: rows equal the SINGLE run's, exact but for doubles (rtol
1e-9) and the REAL sums of R1 / R2 (float32 sums in another order, rtol
1e-4).  The reference is pinned as ROADMAP "Pinning the reference" says.
"""

import math

import numpy as np
import pytest
import torch

from test_torch_queries_q13_q22 import R1, R2
from trino_tpu.exec.operators import HashAggregationOperator as RefAgg
from trino_tpu.planner.plan import AggCall as RefAggCall
from trino_tpu.spi.batch import Column as RefColumn
from trino_tpu.spi.batch import ColumnBatch as RefBatch
from trino_tpu.spi.types import BIGINT as REF_BIGINT
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.tpch_queries import QUERIES
from trino_tpu_torch.exec.driver import run_pipelines
from trino_tpu_torch.exec.local_planner import LocalPlanner
from trino_tpu_torch.exec.operators import (HashAggregationOperator,
                                            TopNOperator, split_aggregation)
from trino_tpu_torch.planner.plan import AggCall, SortKey
from trino_tpu_torch.runner import StandaloneQueryRunner
from trino_tpu_torch.spi.batch import Column, ColumnBatch
from trino_tpu_torch.spi.types import BIGINT, DOUBLE, VARCHAR
from trino_tpu_torch.caching import result_cache

SF = 0.01


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


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch's intra-op threads only contend at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(keys, vals):
    return ColumnBatch(["k", "v"], [Column(BIGINT, np.asarray(keys, np.int64)),
                                    Column(BIGINT, np.asarray(vals, np.int64))])


def _ref_batch(keys, vals):
    return RefBatch(["k", "v"],
                    [RefColumn(REF_BIGINT, np.asarray(keys, np.int64)),
                     RefColumn(REF_BIGINT, np.asarray(vals, np.int64))])


def _drain(op) -> list:
    out = []
    while (b := op.get_output()) is not None:
        out.append(b)
    return out


def _sums(batches) -> dict:
    totals: dict = {}
    for b in batches:
        for k, s in b.to_pylist():
            totals[k] = totals.get(k, 0) + s
    return totals


def test_partial_agg_flushes_early():
    flushed = {}
    for name, op, mk in (
            ("port", HashAggregationOperator(
                [0], [AggCall("sum", 1, BIGINT)], ["k", "s"],
                [BIGINT, BIGINT], step="PARTIAL"), _batch),
            ("ref", RefAgg([0], [RefAggCall("sum", 1, REF_BIGINT)],
                           ["k", "s"], [REF_BIGINT, REF_BIGINT],
                           step="PARTIAL"), _ref_batch)):
        op.FLUSH_ROWS = 100  # a tiny window for the test
        for _ in range(10):
            op.add_input(mk(np.arange(50) % 7, np.ones(50)))
        early = _drain(op)
        assert early, f"{name}: expected pre-finish partial flushes"
        op.finish_input()
        while not op.is_finished():
            early += [b] if (b := op.get_output()) is not None else []
        flushed[name] = (len(early), _sums(early))
    want = {k: sum(1 for i in range(50) if i % 7 == k) * 10
            for k in range(7)}
    assert flushed["port"] == flushed["ref"]
    assert flushed["port"][1] == want


def test_partial_agg_buffer_bounded():
    op = HashAggregationOperator(
        [0], [AggCall("sum", 1, BIGINT)], ["k", "s"], [BIGINT, BIGINT],
        step="PARTIAL")
    op.FLUSH_ROWS = 128
    for _ in range(100):
        op.add_input(_batch(np.arange(64) % 5, np.ones(64)))
        assert op._buffered_rows <= 128 + 64
        _drain(op)


def test_topn_state_bounded():
    op = TopNOperator(10, [SortKey(1, ascending=False)])
    op._shrink_at = 200
    rng = np.random.default_rng(0)
    seen = []
    for _ in range(50):
        vals = rng.integers(0, 1_000_000, 100)
        seen.append(vals)
        op.add_input(_batch(np.arange(100), vals))
        assert op._buffered_rows <= 300  # never more than shrink_at + batch
    op.finish_input()
    got = sorted((r[1] for r in op.get_output().to_pylist()), reverse=True)
    assert got == sorted(np.concatenate(seen).tolist(), reverse=True)[:10]


# ---------------------------------------------------------------------------
# state layouts: PARTIAL -> FINAL against SINGLE


def _input_batches(seed: int, n_batches: int = 4, n: int = 300):
    """(k BIGINT with NULLs, s VARCHAR whose dictionary differs per batch,
    x DOUBLE with NULLs, y BIGINT); a batch is masked by ``live``."""
    rng = np.random.default_rng(seed)
    words = np.array(sorted({f"w{i:03d}" for i in range(40)}), dtype=object)
    out = []
    for b in range(n_batches):
        d = np.array(sorted(rng.choice(words, 12, replace=False)),
                     dtype=object)
        k = rng.integers(0, 9, n)
        out.append(ColumnBatch(["k", "s", "x", "y"], [
            Column(BIGINT, k, rng.random(n) < 0.9),
            Column(VARCHAR, rng.integers(0, len(d), n).astype(np.int32),
                   rng.random(n) < 0.8, d),
            Column(DOUBLE, rng.normal(size=n) * 100, rng.random(n) < 0.85),
            Column(BIGINT, rng.integers(-50, 50, n))],
            torch.from_numpy(rng.random(n) < 0.9) if b % 2 else None))
    return out


AGGS = [AggCall("avg", 2, DOUBLE), AggCall("var_samp", 2, DOUBLE),
        AggCall("stddev_pop", 2, DOUBLE), AggCall("sum", 3, BIGINT),
        AggCall("count", 2, BIGINT), AggCall("count", -1, BIGINT),
        AggCall("min", 1, VARCHAR), AggCall("max", 1, VARCHAR),
        AggCall("min", 2, DOUBLE), AggCall("max", 3, BIGINT)]


def _run(ops, batches) -> list:
    """Feed the batches through a chain of operators; the last one's rows."""
    out = []
    for b in batches:
        pending = [b]
        for op in ops:
            nxt = []
            for p in pending:
                op.add_input(p)
                nxt += _drain(op)
            pending = nxt
        out += pending
    for i, op in enumerate(ops):
        op.finish_input()
        tail = _drain(op)
        for nxt in ops[i + 1:]:
            more = []
            for p in tail:
                nxt.add_input(p)
                more += _drain(nxt)
            tail = more
        out += tail
    rows = []
    for b in out:
        rows += b.to_pylist()
    return rows


def _close(got, want, rtol=1e-9):
    key = lambda r: repr(r[:1])  # noqa: E731 — group key order
    got, want = sorted(got, key=key), sorted(want, key=key)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert math.isclose(a, b, rel_tol=rtol, abs_tol=1e-9), (g, w)
            else:
                assert a == b, (g, w)


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("flush_rows", [1 << 20, 500])
def test_partial_final_matches_single(grouped, flush_rows):
    keys = [0] if grouped else []
    names = ["k"] * grouped + [f"a{i}" for i in range(len(AGGS))]
    types = [BIGINT] * grouped + [a.type for a in AGGS]
    single = HashAggregationOperator(keys, AGGS, names, types)
    pair = split_aggregation(HashAggregationOperator(keys, AGGS, names,
                                                     types))
    pair[0].FLUSH_ROWS = flush_rows
    batches = _input_batches(7)
    want = _run([single], batches)
    got = _run(list(pair), batches)
    _close(got, want)
    assert len(want) == (9 + 1 if grouped else 1)  # 9 keys and NULL


def test_partial_state_columns_and_empty_global_input():
    pair = split_aggregation(HashAggregationOperator(
        [], AGGS, [f"a{i}" for i in range(len(AGGS))],
        [a.type for a in AGGS]))
    partial, final = pair
    # avg -> 2 states, the variance family -> 3, the rest one each
    assert len(partial.output_types) == len(AGGS) + 1 + 2 + 2
    single = HashAggregationOperator([], AGGS, final.output_names,
                                     final.output_types)
    assert _run(list(pair), []) == _run([single], []) == [
        (None, None, None, None, 0, 0, None, None, None, None)]


@pytest.mark.parametrize("grouped", [True, False])
def test_a_result_without_input_is_built_on_the_task_device(grouped):
    """A task that got no split hands its aggregation's result over no
    input (a global one's row of defaults) to a consumer that concatenates
    it with the other tasks' device batches, so it is built on the task's
    device: the planner gives the operator its device and
    split_aggregation's pair keeps it.  "meta" stands for the card here;
    an operator given no device builds on the host."""
    keys = [0] if grouped else []
    names = ["k"] * grouped + [f"a{i}" for i in range(len(AGGS))]
    types = [BIGINT] * grouped + [a.type for a in AGGS]
    op = HashAggregationOperator(keys, AGGS, names, types, device="meta")
    for o in (op, *split_aggregation(op)):
        out = o._compute()
        assert out.num_rows == (0 if grouped else 1)
        assert {c.device.type for c in out.columns} == {"meta"}
    host = HashAggregationOperator(keys, AGGS, names, types)._compute()
    assert {c.device.type for c in host.columns} == {"cpu"}
    runner = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    local = LocalPlanner(runner.catalog, "meta").plan(runner.create_plan(
        "select count(*) from region"))
    aggs = [o for p in local.pipelines for o in p
            if isinstance(o, HashAggregationOperator)]
    assert aggs and all(o.device == torch.device("meta") for o in aggs)


def test_distinct_and_long_decimal_avg_do_not_split():
    from trino_tpu_torch.spi.types import DecimalType

    op = HashAggregationOperator([0], [AggCall("count", 1, BIGINT, True)],
                                 ["k", "c"], [BIGINT, BIGINT])
    assert split_aggregation(op) is None
    op = HashAggregationOperator([0], [AggCall("avg", 1, DecimalType(38, 2))],
                                 ["k", "a"], [BIGINT, DecimalType(38, 2)])
    assert split_aggregation(op) is None


# ---------------------------------------------------------------------------
# the 24 queries with every aggregation split


CASES = [(f"Q{q}", QUERIES[q]) for q in sorted(QUERIES)] + [("R1", R1),
                                                              ("R2", R2)]


@pytest.fixture(scope="module")
def runner():
    return StandaloneQueryRunner(default_catalog(SF), device="cpu")


def _split_rows(runner, sql: str) -> tuple:
    """Rows of ``sql`` with each SINGLE aggregation as PARTIAL -> FINAL,
    and the number of aggregations split."""
    s = runner.session
    local = LocalPlanner(runner.catalog, "cpu",
                         splits_per_node=s.splits_per_node,
                         node_count=s.node_count).plan(
        runner.create_plan(sql))
    split = 0
    for p in local.pipelines:
        for i in range(len(p) - 1, -1, -1):
            op = p[i]
            pair = (split_aggregation(op)
                    if isinstance(op, HashAggregationOperator) else None)
            if pair is not None:
                p[i:i + 1] = list(pair)
                split += 1
    run_pipelines(local.pipelines)
    batches = local.collector.batches
    rows = ColumnBatch.concat(batches).to_pylist() if batches else []
    return rows, split


@pytest.mark.parametrize("name,sql", CASES, ids=[n for n, _ in CASES])
def test_queries_partial_final_match_single(runner, monkeypatch, name, sql):
    monkeypatch.setattr(HashAggregationOperator, "FLUSH_ROWS", 4096)
    want = runner.execute(sql).rows()
    got, split = _split_rows(runner, sql)
    if "order by" not in sql.lower():
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    rtol = 1e-4 if name in ("R1", "R2") else 1e-9
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert math.isclose(a, b, rel_tol=rtol), (name, g, w)
            else:
                assert a == b, (name, g, w)
    if name in ("Q1", "Q18", "R1"):
        assert split >= 1

"""Compressed execution in the torch port: RLE and LAZY columns, against the
reference's functions on the same inputs.

The reference's batch-level and RLE-aggregation cases
(tests/test_encoded_exec.py) run through both packages; LAZY thunks are
counted (a filter that drops a whole batch never runs its thunk); the
EXPLAIN ANALYZE encoding line; encoded against flat on the 22 TPC-H queries
against the reference; and a join and a GROUP BY on a constant (RLE) key,
where a spy on the kernel wrappers' plain versions shows that every tensor
they get is contiguous.  The serde and exchange cases of the reference's
file wait for execution/serde.py.
"""

import numpy as np
import pytest
import torch

from test_torch_dynamic_filter import _pin, _rows_equal
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.exec.operators import HashAggregationOperator as RefAgg
from trino_tpu.planner.plan import AggCall as RefAggCall
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu.spi.batch import Column as RefColumn
from trino_tpu.spi.batch import ColumnBatch as RefBatch
from trino_tpu.spi.batch import maybe_rle as ref_maybe_rle
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.tpch_queries import QUERIES
from trino_tpu_torch.exec.operators import (FilterProjectOperator,
                                            HashAggregationOperator)
from trino_tpu_torch.exec.stats import QueryStats
from trino_tpu_torch.interop import batch_to_numpy
from trino_tpu_torch.ops import gpu_kernels as GK
from trino_tpu_torch.planner.plan import AggCall
from trino_tpu_torch.runner import StandaloneQueryRunner
from trino_tpu_torch.spi.batch import Column, ColumnBatch, maybe_rle
from trino_tpu_torch.spi.types import BIGINT, BOOLEAN, DOUBLE, VARCHAR
from trino_tpu_torch.sql.ir import Call, InputRef, Literal

SF = 0.01


# ---------------------------------------------------------------------------
# encodings and their propagation

def test_rle_detection_and_propagation():
    const = np.full(128, 7, np.int64)
    port, ref = maybe_rle(Column(BIGINT, const)), ref_maybe_rle(
        RefColumn(BIGINT, const))
    assert port.encoding == ref.encoding == "RLE" and len(port) == 128
    assert (port.nbytes, port.flat_nbytes) == (ref.nbytes, ref.flat_nbytes)
    assert port.flat_nbytes == Column(BIGINT, const).nbytes
    for data in (np.arange(128), np.full(8, 7, np.int64)):
        assert maybe_rle(Column(BIGINT, data)).encoding == \
            ref_maybe_rle(RefColumn(BIGINT, data)).encoding == "FLAT"
    assert port.slice_rows(10, 50).encoding == "RLE"
    assert port.take(torch.tensor([1, 5, 9])).encoding == "RLE"
    f = port.filter(torch.arange(128) % 2 == 0)
    assert f.encoding == "RLE" and len(f) == 64
    cat = ColumnBatch.concat([
        ColumnBatch(["x"], [Column.rle(BIGINT, 7, 100, device="cpu")]),
        ColumnBatch(["x"], [Column.rle(BIGINT, 7, 28, device="cpu")])])
    assert cat.columns[0].encoding == "RLE" and len(cat.columns[0]) == 128
    # the expanded view is correct and dense (kernels refuse strides)
    assert port.data[:3].tolist() == [7, 7, 7]
    assert port.data.is_contiguous() and port.encoding == "RLE"


def test_rle_mixed_concat_expands_correctly():
    parts = [(Column.rle(BIGINT, 7, 70, device="cpu"),
              RefColumn.rle(BIGINT, 7, 70)),
             (Column(BIGINT, np.arange(30, dtype=np.int64)),
              RefColumn(BIGINT, np.arange(30, dtype=np.int64)))]
    got = ColumnBatch.concat([ColumnBatch(["x"], [p]) for p, _ in parts])
    want = RefBatch.concat([RefBatch(["x"], [r]) for _, r in parts])
    np.testing.assert_array_equal(got.columns[0].data.numpy(),
                                  np.asarray(want.columns[0].data))


def test_lazy_thunk_runs_once():
    calls = []

    def thunk():
        calls.append(1)
        return np.arange(100, dtype=np.int64), None

    lz = Column.lazy(BIGINT, 100, thunk, device="cpu", nbytes_hint=800)
    assert lz.encoding == "LAZY" and not lz.is_materialized
    assert lz.nbytes == 800
    moved = ColumnBatch(["x"], [lz]).to("cpu").columns[0]
    assert moved.encoding == "LAZY" and not calls, "a move must not read it"
    assert moved.data.tolist() == list(range(100)) and calls == [1]
    _ = moved.data  # second read: cached
    assert calls == [1] and moved.encoding == "FLAT"


def test_lazy_empty_selection_skips_thunk():
    lz = Column.lazy(BIGINT, 100,
                     lambda: (np.arange(100, dtype=np.int64), None),
                     device="cpu")
    empty = lz.filter(torch.zeros(100, dtype=torch.bool))
    assert len(empty) == 0 and not lz.is_materialized
    empty2 = lz.take(torch.empty(0, dtype=torch.int64))
    assert len(empty2) == 0 and not lz.is_materialized


def test_nbytes_include_dictionary_bytes():
    d = np.array(["alpha", "beta", "gamma"], dtype=object)
    codes = np.zeros(8, np.int32)
    plain, coded = Column(BIGINT, codes), Column(VARCHAR, codes, None, d)
    assert coded.nbytes > plain.nbytes
    assert coded.nbytes == RefColumn(VARCHAR, codes, None, d).nbytes


def test_batch_to_numpy_materializes_encodings():
    lz = Column.lazy(BIGINT, 4, lambda: (np.arange(4), np.array(
        [True, False, True, True])), device="cpu")
    b = ColumnBatch(["r", "z"], [Column.rle(DOUBLE, 2.5, 4, device="cpu"),
                                 lz])
    _, _, datas, valids, _, _ = batch_to_numpy(b)
    assert datas[0].tolist() == [2.5] * 4 and valids[0] is None
    assert datas[1].tolist() == [0, 1, 2, 3]
    assert valids[1].tolist() == [True, False, True, True]


# ---------------------------------------------------------------------------
# RLE aggregation: value * run count, against the reference's operator

def _agg(cls, call_cls, aggs, types, batches):
    op = cls([], [call_cls(*a) for a in aggs], [f"a{i}" for i in
                                                  range(len(aggs))], types)
    for b in batches:
        op.add_input(b)
    op.finish_input()
    return op, op.get_output()


def _both(aggs, types, ref_batches, port_batches):
    """The port's aggregates (count(*) as count of channel -1) and the
    reference's (count_star) over the same runs."""
    ref_aggs = [("count_star" if a[1] < 0 else a[0],) + a[1:] for a in aggs]
    _, want = _agg(RefAgg, RefAggCall, ref_aggs, types, ref_batches)
    op, got = _agg(HashAggregationOperator, AggCall, aggs, types,
                   port_batches)
    assert got.to_pylist() == want.to_pylist()
    return op, got.to_pylist()


def test_rle_agg_sum_count_min_max_with_nulls_in_runs():
    v1 = np.ones(100, bool)
    v1[10:20] = False
    aggs = [("sum", 0, BIGINT), ("count", 0, BIGINT), ("min", 0, BIGINT),
            ("max", 0, BIGINT), ("count", -1, BIGINT)]
    op, rows = _both(
        aggs, [BIGINT] * 5,
        [RefBatch(["x"], [RefColumn.rle(BIGINT, 5, 100, v1)]),
         RefBatch(["x"], [RefColumn.rle(BIGINT, 3, 50)])],
        [ColumnBatch(["x"], [Column.rle(BIGINT, 5, 100, v1, device="cpu")]),
         ColumnBatch(["x"], [Column.rle(BIGINT, 3, 50, device="cpu")])])
    assert rows == [(5 * 90 + 3 * 50, 140, 3, 5, 150)]
    # folded rows per value aggregate: 4 aggregates x 140 live rows
    assert op.encoding_stats.rle_agg_rows == 4 * 140


def test_rle_agg_all_null_run_is_null():
    null = np.zeros(64, bool)
    _, rows = _both(
        [("sum", 0, BIGINT), ("count", 0, BIGINT)], [BIGINT, BIGINT],
        [RefBatch(["x"], [RefColumn.rle(BIGINT, 9, 64, null)])],
        [ColumnBatch(["x"], [Column.rle(BIGINT, 9, 64, null, device="cpu")])])
    assert rows == [(None, 0)]


def test_rle_agg_respects_live_mask():
    live = np.zeros(100, bool)
    live[:30] = True
    op, rows = _both(
        [("sum", 0, BIGINT), ("count", -1, BIGINT)], [BIGINT, BIGINT],
        [RefBatch(["x"], [RefColumn.rle(BIGINT, 4, 100)], live)],
        [ColumnBatch(["x"], [Column.rle(BIGINT, 4, 100, device="cpu")],
                     torch.from_numpy(live))])
    assert rows == [(4 * 30, 30)]
    assert op.encoding_stats.rle_agg_rows == 30


def test_rle_agg_fast_path_matches_flat():
    """The fast path and the expanded reduction agree exactly."""
    valid = np.ones(200, bool)
    valid[7::13] = False
    aggs = [("sum", 0, DOUBLE), ("count", 0, BIGINT)]
    _, fast = _agg(HashAggregationOperator, AggCall, aggs,
                   [DOUBLE, BIGINT], [ColumnBatch(["x"], [Column.rle(
                       DOUBLE, 2.5, 200, valid, device="cpu")])])
    op, slow = _agg(HashAggregationOperator, AggCall, aggs,
                    [DOUBLE, BIGINT], [ColumnBatch(["x"], [Column(
                        DOUBLE, np.full(200, 2.5), valid.copy())])])
    assert fast.to_pylist() == slow.to_pylist()
    assert op.encoding_stats.rle_agg_rows == 0  # the flat input expands


# ---------------------------------------------------------------------------
# LAZY columns behind a filter

def test_filter_dropping_a_batch_never_runs_its_thunk():
    """A predicate over channel 0 that no row passes: channel 1 rides
    through still LAZY and its thunk never runs."""
    calls = []

    def thunk():
        calls.append(1)
        return np.arange(100, dtype=np.int64), None

    batch = ColumnBatch(["k", "p"], [
        Column(BIGINT, np.arange(100, dtype=np.int64)),
        Column.lazy(BIGINT, 100, thunk, device="cpu")])
    pred = Call(BOOLEAN, "gt", (InputRef(BIGINT, 0), Literal(BIGINT, 1000)))
    fp = FilterProjectOperator(pred, [InputRef(BIGINT, 1)], ["p"], [BIGINT])
    fp.add_input(batch)
    out = fp.get_output()
    assert out.columns[0].encoding == "LAZY" and not calls
    assert out.compact().num_rows == 0 and not calls
    assert fp.encoding_stats.bytes_saved > 0


@pytest.fixture(scope="module")
def catalogs():
    return default_catalog(SF), ref_catalog(SF)


@pytest.fixture(scope="module")
def port(catalogs):
    return StandaloneQueryRunner(catalogs[0], device="cpu")


def test_lazy_filter_never_materializes_dropped_batches(port):
    st = QueryStats()
    assert port.execute("select l_comment from lineitem "
                        "where l_quantity > 1e9", stats=st).rows() == []
    assert st.encoding.lazy_columns > 0, "payload column was not lazy"
    assert st.encoding.lazy_materialized == 0


def test_low_selectivity_filter_skips_payload_bytes(port):
    st = QueryStats()
    port.execute("select l_extendedprice, l_discount from lineitem "
                 "where l_orderkey = 1", stats=st)
    assert st.encoding.lazy_skipped_bytes > 0


def test_explain_analyze_surfaces_encoding_line(port):
    text = "\n".join(r[0] for r in port.execute(
        "explain analyze select l_returnflag, count(*) from lineitem "
        "group by l_returnflag").rows())
    line = next(l for l in text.splitlines() if "encoding:" in l)
    assert line.startswith("  encoding: ") and "code group-bys" in line
    assert " 1 code group-bys" in line


def test_encoded_exec_off_uses_no_encoded_paths(catalogs):
    off = StandaloneQueryRunner(catalogs[0], device="cpu",
                                encoded_exec=False)
    st = QueryStats()
    off.execute("select l_comment from lineitem where l_quantity > 1e9",
                stats=st)
    assert st.encoding is None or (st.encoding.lazy_columns == 0
                                   and st.encoding.rle_batches == 0)


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_encoded_vs_flat_against_reference(catalogs, monkeypatch, q):
    _pin(monkeypatch)
    want = RefRunner(catalogs[1]).execute(QUERIES[q]).rows()
    for encoded in (True, False):
        got = StandaloneQueryRunner(catalogs[0], device="cpu",
                                    encoded_exec=encoded).execute(
            QUERIES[q]).rows()
        _rows_equal(got, want, QUERIES[q])


# ---------------------------------------------------------------------------
# a constant (RLE) key reaches the hash kernels dense

def _contiguity_spy(monkeypatch):
    """Record whether each key input of every insert / probe call is
    contiguous (a probe's first two arguments are the table's strided
    views of its bucket array, by design: not key inputs)."""
    seen = []
    for name, first in (("hash_insert_plain", 0), ("hash_probe_plain", 2)):
        def spy(*args, _fn=getattr(GK, name), _name=name, _first=first,
                **kw):
            seen.append((_name, [a.is_contiguous() for a in args[_first:]
                                 if isinstance(a, torch.Tensor)]))
            return _fn(*args, **kw)

        monkeypatch.setattr(GK, name, spy)
    return seen


def test_rle_join_and_group_keys_reach_kernels_contiguous(monkeypatch):
    """Memory tables written by CTAS are host batches: the scan makes their
    constant column ``k`` RLE on both join sides, and the group-by above
    the join groups on it."""
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    r.execute("create table memory.a as select 7 as k, o_orderkey as v "
              "from orders where o_orderkey < 4000")
    r.execute("create table memory.b as select 7 as k, s_suppkey as v "
              "from supplier")
    seen = _contiguity_spy(monkeypatch)
    st = QueryStats()
    # the residual keeps the optimizer from pre-aggregating the build:
    # every build row has the key 7, so the probe expands runs
    rows = r.execute("select a.k, count(*) from memory.a a join memory.b b "
                     "on a.k = b.k and a.v > b.v group by a.k",
                     stats=st).rows()
    assert rows == [(7, 3999 * 100 - 5050)]
    assert st.encoding.rle_batches > 0, "the constant key was not RLE"
    assert {n for n, _ in seen} == {"hash_insert_plain", "hash_probe_plain"}
    assert all(all(flags) for _, flags in seen), seen

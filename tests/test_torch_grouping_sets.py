"""GROUPING SETS / ROLLUP / CUBE and grouping() through the torch port
against the JAX reference: the cases of the reference's
test_grouping_sets.py over the same memory table, the surface queries
G1-G3 at SF 0.01, and the GroupIdOperator's contract.

The reference is pinned as in test_torch_iterative_queries.py.  The
``$groupid`` column is a BIGINT with no dictionary, so every grouping-sets
aggregation groups through ``hash_insert``; G3's REAL sums into 8 groups
take ``masked_segment_sum_f32`` (both spied on as their plain versions).
G3's float32 sums are summed in different orders by the two packages and
are held to rtol 1e-4, as R1 / R2 are in test_torch_queries_q13_q22.py.
"""

import numpy as np
import pytest
import torch

from test_torch_iterative_queries import _pin
from test_torch_queries import _count_plain_calls, _same_rows
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.runner import Session
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.surface_queries import SURFACE_QUERIES
from trino_tpu_torch.exec.operators import GroupIdOperator
from trino_tpu_torch.runner import StandaloneQueryRunner
from trino_tpu_torch.spi.batch import Column, ColumnBatch
from trino_tpu_torch.spi.types import BIGINT, VARCHAR
from trino_tpu_torch.caching import result_cache

SF = 0.01
GS_ROWS = ("insert into gs values ('a','x',1),('a','y',2),('b','x',3),"
           "('b','y',4),('a','x',5),('a',null,6)")


@pytest.fixture(autouse=True)
def _execution_not_cached():
    """Every statement here executes: a result-cache hit would skip the
    launches, syncs and revocations these tests count."""
    with result_cache.disabled():
        yield


@pytest.fixture(scope="module")
def catalogs():
    port_cat, ref_cat = default_catalog(SF), ref_catalog(SF)
    port = StandaloneQueryRunner(port_cat, device="cpu",
                                 default_catalog_name="memory")
    with pytest.MonkeyPatch.context() as mp:
        _pin(mp)
        ref = RefRunner(ref_cat, session=Session(default_catalog="memory"))
        for r in (port, ref):
            r.execute("create table gs (k1 varchar, k2 varchar, v bigint)")
            r.execute(GS_ROWS)
    return port_cat, ref_cat


@pytest.fixture(scope="module")
def port(catalogs):
    return StandaloneQueryRunner(catalogs[0], device="cpu",
                                 default_catalog_name="memory")


@pytest.fixture
def reference(catalogs, monkeypatch):
    _pin(monkeypatch)
    return RefRunner(catalogs[1], session=Session(default_catalog="memory"))


CASES = {
    "rollup": "select k1, k2, sum(v) from gs group by rollup(k1, k2) "
              "order by 1, 2",
    "cube_with_grouping_fn": "select k1, k2, sum(v), grouping(k1, k2) "
                             "from gs group by cube(k1, k2) order by 4, 1, 2",
    "grouping_sets_explicit": "select k1, sum(v) from gs group by "
                              "grouping sets ((k1), ()) order by 1",
    "cross_product_element": "select k1, k2, count(*) from gs "
                             "group by k1, rollup(k2) order by 1, 2",
    # v is a grouping column and an aggregate argument: its pass-through
    # copy keeps the values in the () set
    "key_also_aggregate_argument": "select v, sum(v), count(*) from gs "
                                   "group by grouping sets ((v), ()) "
                                   "order by 1",
    "union_all_equivalent": "select k1, k2, sum(v), count(*) from gs "
                            "group by k1, k2 union all select k1, null, "
                            "sum(v), count(*) from gs group by k1 union all "
                            "select null, null, sum(v), count(*) from gs "
                            "order by 1, 2, 3",
    "grouping_sets_three": "select k1, k2, sum(v), count(*) from gs group "
                           "by grouping sets ((k1, k2), (k1), ()) "
                           "order by 1, 2, 3",
    "having": "select k1, sum(v) from gs group by rollup(k1) "
              "having sum(v) > 10 order by 1",
    "grouping_fn_in_order_by_only": "select k1, sum(v) from gs group by "
                                    "rollup(k1) order by grouping(k1), k1",
    "grouping_fn_plain_group_by": "select k1, count(*) from gs group by k1 "
                                  "order by grouping(k1), k1",
    "tpch_rollup": "select n_regionkey, count(*) c from tpch.nation "
                   "group by rollup(n_regionkey) order by 1",
    "tpch_cube_stats": "select o_orderpriority, o_orderstatus, count(*), "
                       "stddev(o_totalprice), max(o_orderdate) from "
                       "tpch.orders group by cube(o_orderpriority, "
                       "o_orderstatus) order by 1, 2",
}

# the reference's expected rows of the same cases (test_grouping_sets.py)
EXPECTED = {
    "rollup": [("a", "x", 6), ("a", "y", 2), ("a", None, 6),
               ("a", None, 14), ("b", "x", 3), ("b", "y", 4),
               ("b", None, 7), (None, None, 21)],
    "cube_with_grouping_fn": [
        ("a", "x", 6, 0), ("a", "y", 2, 0), ("a", None, 6, 0),
        ("b", "x", 3, 0), ("b", "y", 4, 0), ("a", None, 14, 1),
        ("b", None, 7, 1), (None, "x", 9, 2), (None, "y", 6, 2),
        (None, None, 6, 2), (None, None, 21, 3)],
    "key_also_aggregate_argument": [
        (1, 1, 1), (2, 2, 1), (3, 3, 1), (4, 4, 1), (5, 5, 1), (6, 6, 1),
        (None, 21, 6)],
    "having": [("a", 14), (None, 21)],
    "grouping_fn_in_order_by_only": [("a", 14), ("b", 7), (None, 21)],
}


@pytest.mark.parametrize("case", list(CASES))
def test_grouping_sets_match_reference(port, reference, monkeypatch, case):
    calls = _count_plain_calls(monkeypatch)
    got = port.execute(CASES[case]).rows()
    _same_rows(got, reference.execute(CASES[case]).rows())
    if case in EXPECTED:
        assert got == EXPECTED[case]
    if "grouping sets" in CASES[case] or "rollup" in CASES[case] \
            or "cube" in CASES[case]:
        assert calls["insert"] >= 1  # $groupid: a hash group-by


def test_union_all_equivalence(port):
    assert (port.execute(CASES["grouping_sets_three"]).rows()
            == port.execute(CASES["union_all_equivalent"]).rows())


def test_grouping_fn_requires_group_column(port, reference):
    for runner in (port, reference):
        with pytest.raises(Exception, match="GROUP BY"):
            runner.execute("select grouping(v) from gs group by k1")


@pytest.mark.parametrize("name,inserts,segment_sums", [
    ("G1", 1, 0), ("G2", 1, 0), ("G3", 1, 2)])
def test_surface_grouping_sets_match_reference(port, reference, monkeypatch,
                                               name, inserts, segment_sums):
    sql = SURFACE_QUERIES[name].replace(" from ", " from tpch.")
    calls = _count_plain_calls(monkeypatch)
    got = port.execute(sql).rows()
    assert (calls["insert"], calls["segment_sum"]) == (inserts, segment_sums)
    _same_rows(got, reference.execute(sql).rows(),
               rel_tol=1e-4 if name == "G3" else 1e-9)
    # the grand total is the last row (NULL keys sort last)
    assert all(x is None for x in got[-1][:2 if name == "G2" else 1])


def test_group_id_operator_contract():
    k = Column(VARCHAR, np.array([1, 0, 1], np.int32), None,
               np.array(["a", "b"], dtype=object))
    v = Column(BIGINT, np.array([10, 20, 30], np.int64),
               np.array([True, False, True]))
    live = torch.tensor([True, True, False])
    op = GroupIdOperator([0, 1], [1], [(0, 1), (0,), ()],
                         ["k", "v", "v_arg", "$groupid"],
                         [VARCHAR, BIGINT, BIGINT, BIGINT])
    op.add_input(ColumnBatch(["k", "v"], [k, v], live))
    outs = []
    while (b := op.get_output()) is not None:
        outs.append(b)
    op.finish_input()
    assert op.is_finished() and len(outs) == 3
    for gid, (b, live_keys) in enumerate(zip(outs, [(0, 1), (0,), ()])):
        assert b.names == ["k", "v", "v_arg", "$groupid"]
        assert b.live is live  # the input's shape and live mask
        for idx, src in enumerate([k, v]):
            c = b.columns[idx]
            assert c.data is src.data and c.dictionary is src.dictionary
            if idx in live_keys:
                assert c.valid is src.valid
            else:  # an all-NULL copy
                assert not bool(c.valid.any())
        assert b.columns[2] is v  # pass-through, never nulled
        g = b.columns[3]
        assert g.data.dtype == torch.int64 and g.valid is None
        assert g.data.tolist() == [gid] * 3

"""RIGHT and FULL joins through the torch port against the JAX reference,
and the LookupJoinOperator's build-side marking against a nested-loop
model.

SQL cases (the reference's own outer-join queries, the surface queries
J1-J3 and the edge cases below) are held row for row to the reference,
pinned as in test_torch_iterative_queries.py.  The operator cases feed
hand-made batches through JoinBuildSink + LookupJoinOperator on the CPU
(where the kernel wrappers take their plain versions) for each route: a
unique build (one lookup per probe row), a build with duplicate keys
(``hash_probe`` candidate runs) and the keyless nested loop.
"""

import numpy as np
import pytest
import torch

from test_setops_joins import OUTER_JOIN_QUERIES
from test_torch_iterative_queries import _pin
from test_torch_queries import _count_plain_calls
from test_torch_setops import check, same_rows_any_order
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.surface_queries import SURFACE_QUERIES
from trino_tpu_torch.exec.operators import (JoinBridge, JoinBuildSink,
                                            LookupJoinOperator)
from trino_tpu_torch.runner import StandaloneQueryRunner
from trino_tpu_torch.spi.batch import Column, ColumnBatch
from trino_tpu_torch.spi.types import BIGINT, BOOLEAN, VARCHAR
from trino_tpu_torch.sql.ir import Call, InputRef

SF = 0.01


@pytest.fixture(scope="module")
def catalogs():
    return default_catalog(SF), ref_catalog(SF)


@pytest.fixture(scope="module")
def port(catalogs):
    return StandaloneQueryRunner(catalogs[0], device="cpu")


@pytest.fixture
def reference(catalogs, monkeypatch):
    _pin(monkeypatch)
    return RefRunner(catalogs[1])


@pytest.mark.parametrize("sql", OUTER_JOIN_QUERIES)
def test_outer_join_queries_match_reference(port, reference, sql):
    assert check(port, reference, sql)


EDGE_CASES = {
    # build rows with a NULL key never match and come from the epilogue
    "null_build_keys": (
        "select a.x, b.y from (values (1), (null), (3)) a(x) full join "
        "(values (1), (null), (4)) b(y) on a.x = b.y"),
    # NULL string columns of the epilogue go through string functions
    "null_string_probe_columns": (
        "select n.n_name, r.r_name, upper(n.n_name), "
        "coalesce(n.n_name, 'none'), length(n.n_comment) from "
        "(select * from nation where n_regionkey < 2) n right join region r "
        "on n.n_regionkey = r.r_regionkey order by 2, 1"),
    "empty_probe": (
        "select count(*), count(n.n_name), count(r.r_name) from "
        "(select * from nation where n_nationkey > 100) n right join "
        "region r on n.n_regionkey = r.r_regionkey"),
    "empty_probe_strings": (
        "select n.n_name, r.r_name from (select * from nation where "
        "n_nationkey > 100) n full join region r "
        "on n.n_regionkey = r.r_regionkey order by 2"),
    "empty_build_full": (
        "select count(*), count(n_name), count(r_name) from nation n full "
        "join (select * from region where r_regionkey > 100) r "
        "on n_regionkey = r_regionkey"),
    # a residual that rejects every candidate: every row of both sides
    # comes back unmatched
    "residual_rejects_all_unique_build": (
        "select count(*), count(n_nationkey), count(r_regionkey) from "
        "nation full join region on n_regionkey = r_regionkey "
        "and n_nationkey > 1000"),
    "residual_rejects_all_duplicate_build": (
        "select count(*), count(a.o_orderkey), count(b.o_orderkey) from "
        "orders a full join orders b on a.o_custkey = b.o_custkey "
        "and a.o_totalprice < 0"),
    # keyless (nested-loop) FULL and RIGHT joins
    "keyless_full": (
        "select a.x, b.y from (values (1), (2)) a(x) full join "
        "(values (1), (3)) b(y) on a.x < b.y"),
    "keyless_right": (
        "select a.x, b.y from (values (5), (2)) a(x) right join "
        "(values (1), (3), (4)) b(y) on a.x < b.y"),
    # CROSS joins (no join predicate) run as the keyless nested loop
    "cross": "select count(*), sum(n_nationkey * r_regionkey) "
             "from nation, region",
}


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_outer_join_edge_cases_match_reference(port, reference, case):
    rows = check(port, reference, EDGE_CASES[case])
    assert rows


def test_epilogue_rows(port):
    rows = port.execute(EDGE_CASES["null_string_probe_columns"]).rows()
    # regions 2-4 have no nation left after the filter
    unmatched = [r for r in rows if r[0] is None]
    assert [r[1] for r in unmatched] == ["ASIA", "EUROPE", "MIDDLE EAST"]
    assert all(r[2:] == (None, "none", None) for r in unmatched)
    assert port.execute(EDGE_CASES["empty_probe"]).rows() == [(5, 0, 5)]
    assert port.execute(EDGE_CASES["empty_build_full"]).rows() == [
        (25, 25, 0)]
    assert port.execute(
        EDGE_CASES["residual_rejects_all_unique_build"]).rows() == [
        (30, 25, 5)]


@pytest.mark.parametrize("name,probes", [("J1", 0), ("J2", 0), ("J3", 1)])
def test_surface_joins_match_reference(port, reference, monkeypatch, name,
                                       probes):
    calls = _count_plain_calls(monkeypatch)
    rows = check(port, reference, SURFACE_QUERIES[name])
    assert calls["insert"] > 0
    # J3's build (orders by o_custkey) has duplicate keys: hash_probe
    assert (calls["probe"] > 0) == (probes > 0)
    if name == "J1":  # customers without orders, from the epilogue
        total, orders, customers = rows[0]
        assert total == customers > orders
    if name == "J3":  # unmatched rows on both sides
        total, left, right = rows[0]
        assert total > left and total > right


# ---------------------------------------------------------------------------
# the operator against a nested-loop model

def _bigint(values):
    return Column(BIGINT, np.array([0 if v is None else v for v in values],
                                   np.int64),
                  np.array([v is not None for v in values]))


def _varchar(values, dictionary):
    codes = [0 if v is None else dictionary.index(v) for v in values]
    return Column(VARCHAR, np.array(codes, np.int32),
                  np.array([v is not None for v in values]),
                  np.array(dictionary, dtype=object))


def _batch(names, cols, live=None):
    return ColumnBatch(names, cols,
                       None if live is None else torch.tensor(live))


PROBE_NAMES = ["pk", "pv", "ps"]
BUILD_NAMES = ["bk", "bv"]
OUT_TYPES = [BIGINT, BIGINT, VARCHAR, BIGINT, BIGINT]


def _run(join_type, probes, build, keyed=True, residual=False):
    """Build + probe through the operators; returns (rows, epilogue)."""
    bridge = JoinBridge()
    sink = JoinBuildSink(bridge, [0] if keyed else [], [BIGINT, BIGINT],
                         BUILD_NAMES, "cpu")
    sink.add_input(build)
    sink.finish_input()
    # residual: probe value > build value
    res = (Call(BOOLEAN, "gt", (InputRef(BIGINT, 1), InputRef(BIGINT, 4)))
           if residual else None)
    op = LookupJoinOperator(bridge, [0] if keyed else [], join_type, res,
                            PROBE_NAMES + BUILD_NAMES, OUT_TYPES)
    out = []
    for p in probes:
        op.add_input(p)
        while (b := op.get_output()) is not None:
            out.append(b)
    op.finish_input()
    while not op.is_finished():
        b = op.get_output()
        if b is not None:
            out.append(b)
    rows = [r for b in out for r in b.to_pylist()]
    return rows, out[-1] if out else None


def _model(join_type, probe_rows, build_rows, keyed, residual):
    out, hit = [], [False] * len(build_rows)
    for p in probe_rows:
        matched = False
        for j, b in enumerate(build_rows):
            ok = (p[0] is not None and p[0] == b[0]) if keyed else True
            if ok and residual:
                ok = p[1] is not None and b[1] is not None and p[1] > b[1]
            if ok:
                out.append(p + b)
                matched = hit[j] = True
        if not matched and join_type in ("LEFT", "FULL"):
            out.append(p + (None, None))
    if join_type in ("RIGHT", "FULL"):
        out += [(None, None, None) + b
                for j, b in enumerate(build_rows) if not hit[j]]
    return out


UNIQUE_BUILD = ([1, 2, None, 4, 5], [10, 20, 30, 40, 50])
DUPLICATE_BUILD = ([1, 2, 2, None, 4, 1, None], [10, 20, 25, 30, 40, 5, 7])
DICT = ["p", "q", "r"]
PROBES = [
    ([1, 2, None, 3, 2], [15, 5, 99, 7, 30], ["p", None, "q", "r", "q"],
     [True, True, True, True, False]),
    ([4, 1, 9], [45, 1, 2], ["r", "r", None], None),
]


@pytest.mark.parametrize("join_type", ["INNER", "LEFT", "RIGHT", "FULL"])
@pytest.mark.parametrize("build", ["unique", "duplicates", "keyless"])
@pytest.mark.parametrize("residual", [False, True])
def test_operator_matches_nested_loop_model(monkeypatch, join_type, build,
                                            residual):
    calls = _count_plain_calls(monkeypatch)
    bk, bv = UNIQUE_BUILD if build == "unique" else DUPLICATE_BUILD
    build_batch = _batch(BUILD_NAMES, [_bigint(bk), _bigint(bv)])
    probes, probe_rows = [], []
    for k, v, s, live in PROBES:
        probes.append(_batch(PROBE_NAMES, [_bigint(k), _bigint(v),
                                           _varchar(s, DICT)], live))
        probe_rows += [r for i, r in enumerate(zip(k, v, s))
                       if live is None or live[i]]
    keyed = build != "keyless"
    rows, _ = _run(join_type, probes, build_batch, keyed, residual)
    want = _model(join_type, probe_rows, list(zip(bk, bv)), keyed, residual)
    same_rows_any_order(rows, want)
    # the duplicate-key build probes through hash_probe
    assert (calls["probe"] > 0) == (build == "duplicates")


@pytest.mark.parametrize("join_type", ["RIGHT", "FULL"])
def test_epilogue_dictionaries(join_type):
    build_batch = _batch(BUILD_NAMES, [_bigint([7, 8]), _bigint([1, 2])])
    # no probe batch: the NULL string column gets a one-entry dictionary
    rows, last = _run(join_type, [], build_batch)
    assert sorted(rows) == [(None, None, None, 7, 1), (None, None, None,
                                                       8, 2)]
    s = last.columns[2]
    assert list(s.dictionary) == [""] and not bool(s.valid.any())
    # with probe batches: the last probe batch's dictionary
    probe = _batch(PROBE_NAMES, [_bigint([7]), _bigint([0]),
                                 _varchar(["q"], DICT)])
    rows, last = _run(join_type, [probe], build_batch)
    assert sorted(rows, key=str) == sorted(
        [(7, 0, "q", 7, 1), (None, None, None, 8, 2)], key=str)
    assert list(last.columns[2].dictionary) == DICT
    assert last.num_rows == 1 and not bool(last.columns[0].valid.any())

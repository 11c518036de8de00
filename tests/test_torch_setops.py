"""UNION / INTERSECT / EXCEPT [ALL] through the torch port against the JAX
reference: the reference's own set-operation queries, precedence,
parenthesized terms, the column-count error, the ALL variants, and the
surface queries U1-U4 at SF 0.01.

The reference is pinned as in test_torch_iterative_queries.py (sort-path
hashing, no Pallas, no result cache, no HBO, the iterative optimizer); the
port runs on the CPU, where its kernel wrappers take their plain versions.
Rows are equal (doubles to rtol 1e-9); a query without ORDER BY is
compared as a multiset.  Set operations group by every channel, so on
keys that are not small dictionary codes they go through ``hash_insert``
(spied on as ``GK.hash_insert_plain``).
"""

import pytest

from test_setops_joins import SETOP_QUERIES
from test_torch_iterative_queries import _pin
from test_torch_queries import _count_plain_calls, _same_rows
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.surface_queries import SURFACE_QUERIES
from trino_tpu_torch.runner import StandaloneQueryRunner
from trino_tpu_torch.caching import result_cache

SF = 0.01


@pytest.fixture(autouse=True)
def _execution_not_cached():
    """Every statement here executes: a result-cache hit would skip the
    launches, syncs and revocations these tests count."""
    with result_cache.disabled():
        yield


def _row_key(row):
    return tuple((x is None, 0 if x is None else x) for x in row)


def same_rows_any_order(got, want, rel_tol=1e-9):
    """Rows equal as multisets (sorted first, NULLs last in each column)."""
    _same_rows(sorted(got, key=_row_key), sorted(want, key=_row_key),
               rel_tol)


def check(port, reference, sql, rel_tol=1e-9):
    got = port.execute(sql).rows()
    want = reference.execute(sql).rows()
    if "order by" in sql.lower():
        _same_rows(got, want, rel_tol)
    else:
        same_rows_any_order(got, want, rel_tol)
    return got


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


@pytest.mark.parametrize("sql", SETOP_QUERIES)
def test_setop_queries_match_reference(port, reference, sql):
    assert check(port, reference, sql)


SHAPES = {
    # INTERSECT binds tighter than UNION
    "precedence": (
        "select n_regionkey from nation union select r_regionkey from "
        "region intersect select r_regionkey from region "
        "where r_regionkey < 2"),
    # each side's ORDER BY / LIMIT applies inside its parentheses
    "parenthesized_terms": (
        "(select n_nationkey from nation order by n_nationkey limit 3) "
        "union all "
        "(select n_nationkey from nation order by n_nationkey desc limit 2)"),
    # min(left, right) copies of each value
    "intersect_all": (
        "select n_regionkey from nation intersect all (select r_regionkey "
        "from region union all select r_regionkey from region "
        "where r_regionkey < 2)"),
    # max(left - right, 0) copies
    "except_all": (
        "select n_regionkey from nation except all select r_regionkey "
        "from region where r_regionkey < 3"),
    "except_all_strings": (
        "select n_name from nation except all select n_name from nation "
        "where n_regionkey = 1 order by 1"),
    # a union on the build side of a join, with joins inside its branches
    "union_under_join": (
        "select n_name, k from nation join (select r_regionkey k from region "
        "where r_name like 'A%' union all select n_regionkey from nation, "
        "region where n_regionkey = r_regionkey and r_name = 'EUROPE') u "
        "on n_regionkey = k order by 1, 2"),
    # branches with different dictionaries under a LIMIT (no concatenation)
    "union_all_limit": (
        "select n_name from nation where n_regionkey = 0 union all "
        "select r_name from region order by 1 desc limit 4"),
}


@pytest.mark.parametrize("case", list(SHAPES))
def test_setop_shapes_match_reference(port, reference, case):
    assert check(port, reference, SHAPES[case])


def test_intersect_and_except_all_multiplicities(port):
    # nation holds each region key 5 times
    rows = port.execute(SHAPES["intersect_all"]).rows()
    assert sorted(rows) == [(0,), (0,), (1,), (1,), (2,), (3,), (4,)]
    rows = port.execute(SHAPES["except_all"]).rows()
    assert sorted(rows) == sorted([(k,) for k in range(5)
                                   for _ in range(4 if k < 3 else 5)])


def test_union_column_count_mismatch(port, reference):
    for runner in (port, reference):
        with pytest.raises(Exception, match="column count"):
            runner.execute("select 1, 2 union select 3")


@pytest.mark.parametrize("name,inserts", [
    ("U1", 1), ("U2", 1), ("U3", 1), ("U4", 1)])
def test_surface_setops_match_reference(port, reference, monkeypatch, name,
                                        inserts):
    calls = _count_plain_calls(monkeypatch)
    got = check(port, reference, SURFACE_QUERIES[name])
    # the set operation's group-by over BIGINT keys is the one insert
    assert calls["insert"] == inserts and calls["probe"] == 0
    assert got and got[0][-1] > 0

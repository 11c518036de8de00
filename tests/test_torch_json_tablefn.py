"""JSON functions and table functions through the torch port against the
JAX reference: the 6 tests of tests/test_json.py (the path parser and
evaluator of the port's own ops/json_fns.py against the reference's on the
same paths and documents, and the queries), the four ``sequence`` tests of
tests/test_txn_routines_tablefn.py, and N7 and N11 of
connectors/nested_queries.py.

The reference is pinned as in test_torch_iterative_queries.py; the port
runs on the CPU.  Rows are equal.
"""

import pytest

from test_torch_nested import nested, pinned  # noqa: F401 (fixtures)
from test_torch_queries import _count_plain_calls, _same_rows
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.ops import json_fns as ref_json
from trino_tpu.runner import Session
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.nested_queries import KERNELS, NESTED_QUERIES
from trino_tpu_torch.ops.json_fns import (eval_json_path, json_scalar_text,
                                          parse_json_path)
from trino_tpu_torch.runner import StandaloneQueryRunner
from trino_tpu_torch.spi.table_function import builtin_table_functions
from trino_tpu_torch.caching import result_cache

SF = 0.01

DOCS = [
    '{"a": 1, "b": {"c": "x"}, "arr": [10, 20, 30]}',
    '{"a": 2.5, "b": {"c": "y"}, "arr": []}',
    "not json",
    None,
]


@pytest.fixture(autouse=True)
def _execution_not_cached():
    """Every statement here executes: a result-cache hit would skip the
    launches, syncs and revocations these tests count."""
    with result_cache.disabled():
        yield


@pytest.fixture(scope="module")
def runners(pinned):  # noqa: F811
    port = StandaloneQueryRunner(default_catalog(SF), device="cpu",
                                 default_catalog_name="memory")
    ref = RefRunner(ref_catalog(scale_factor=SF),
                    session=Session(default_catalog="memory"))
    values = ", ".join(f"({i + 1}, " + ("null" if d is None else f"'{d}'")
                       + ")" for i, d in enumerate(DOCS))
    for sql in ("create table j (id bigint, doc varchar)",
                f"insert into j values {values}"):
        port.execute(sql)
        ref.execute(sql)
    return port, ref


def same(runners, sql):
    port, ref = runners
    got = port.execute(sql).rows()
    _same_rows(got, ref.execute(sql).rows())
    return got


PATHS = ["$", "$.a", "$.a.b", "$.arr[2].x", '$["k"]', "$.b.c", "$[0]",
         "$.arr[1]", "$.a[-1]"]
BAD_PATHS = ["a.b", "", "$.", "$..a", "$x"]


def test_path_parser():
    for p in PATHS:
        assert parse_json_path(p) == ref_json.parse_json_path(p)
    assert parse_json_path("$.arr[2].x") == ["arr", 2, "x"]
    for p in BAD_PATHS:
        with pytest.raises(ValueError):
            ref_json.parse_json_path(p)
        with pytest.raises(ValueError):
            parse_json_path(p)


def test_eval_path():
    docs = DOCS[:3] + ['{"a": {"b": [1, 2]}}', '[1, [2, 3], {"x": null}]',
                       '{"a": true, "b": 1.0}', "garbage"]
    for d in docs:
        if d is None:
            continue
        for p in PATHS + ["$.a.b[1]", "$[1][0]", "$[2].x", "$.b"]:
            steps = parse_json_path(p)
            got = eval_json_path(d, steps)
            assert got == ref_json.eval_json_path(d, steps)
            assert json_scalar_text(got) == ref_json.json_scalar_text(got)
    assert eval_json_path('{"a": {"b": [1, 2]}}', ["a", "b", 1]) == 2
    assert eval_json_path("garbage", ["a"]) is None


@pytest.mark.parametrize("sql", [
    "select id, json_extract_scalar(doc, '$.b.c') from j order by id",
    "select json_extract_scalar(doc, '$.a') from j where id <= 2 order by id",
    "select json_extract_scalar(doc, '$.b') from j where id = 1",
])
def test_json_extract_scalar(runners, sql):
    assert same(runners, sql)


@pytest.mark.parametrize("sql", [
    "select json_extract(doc, '$.b') from j where id = 1",
    "select json_extract(doc, '$.arr[1]') from j where id = 1",
])
def test_json_extract(runners, sql):
    assert same(runners, sql)


def test_json_array_length(runners):
    assert same(runners, "select id, json_array_length(json_extract(doc, "
                         "'$.arr')) from j order by id") == [
        (1, 3), (2, 0), (3, None), (4, None)]


def test_json_in_predicate(runners):
    assert same(runners, "select id from j where "
                         "json_extract_scalar(doc, '$.b.c') = 'y'") == [(2,)]


# tests/test_txn_routines_tablefn.py: table functions


def test_sequence(runners):
    assert same(runners, "select count(*), sum(sequential_number) "
                         "from table(sequence(1, 100))") == [(100, 5050)]


def test_sequence_negative_step(runners):
    assert same(runners, "select * from table(sequence(5, 1, -2)) "
                         "as t(n)") == [(5,), (3,), (1,)]


def test_sequence_joins(runners):
    assert same(runners, "select n from table(sequence(0, 4)) as t(n) "
                         "join tpch.region on n = r_regionkey order by n") \
        == [(0,), (1,), (2,), (3,), (4,)]


def test_unknown_table_function(runners):
    port, ref = runners
    for r in (ref, port):
        with pytest.raises(Exception, match="not registered"):
            r.execute("select * from table(nope(1))")


def test_sequence_batches():
    """Batches of at most 65,536 rows, stop inclusive, every step size."""
    fn = builtin_table_functions()["sequence"]
    for args, want in (((1, 200000), list(range(1, 200001))),
                       ((10, -3, -4), [10, 6, 2, -2]), ((7,), list(range(8))),
                       ((5, 1), [5, 4, 3, 2, 1])):
        batches = list(fn.bind(list(args)).batches())
        assert all(b.num_rows <= 1 << 16 for b in batches)
        assert [v for b in batches for (v,) in b.to_pylist()] == want
    with pytest.raises(ValueError):
        fn.bind([1, 5, 0])


@pytest.mark.parametrize("name", ["N7", "N11"])
def test_nested_queries_match_reference(nested, monkeypatch, name):  # noqa: F811,E501
    port, ref, _ = nested
    calls = _count_plain_calls(monkeypatch)
    got = port.execute(NESTED_QUERIES[name]).rows()
    assert (calls["insert"] > 0) == ("hash_insert" in KERNELS[name])
    assert got
    _same_rows(got, ref.execute(NESTED_QUERIES[name]).rows())

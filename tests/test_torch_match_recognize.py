"""MATCH_RECOGNIZE through the torch port against the JAX reference: the
eleven single-node tests of tests/test_match_recognize.py (the port has no
distributed runner), each held to the reference's rows and to the literal
rows that test states, the pattern and DEFINE errors, and the row-pattern
query M1 of connectors/window_queries.py at SF 0.01 over ``orders`` and
over a CTAS cut of it in the memory catalog (the route the card takes).

The reference is pinned as in test_torch_iterative_queries.py; the port
runs on the CPU.  The grouped min / max case of the reference module is a
kernel test there; here it runs the port's hash group-by and
grouped_reduce with dead rows at an exact power-of-two group count.
"""

import numpy as np
import pytest
import torch

from test_torch_iterative_queries import _pin
from test_torch_queries import _count_plain_calls, _same_rows
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.exec.row_pattern import PatternMatcher as RefMatcher
from trino_tpu.exec.row_pattern import parse_pattern as ref_parse
from trino_tpu.runner import Session
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.window_queries import M1_CUT, m1_text
from trino_tpu_torch.exec import kernels as K
from trino_tpu_torch.exec.row_pattern import (PatternMatcher,
                                              PatternSyntaxError,
                                              parse_pattern)
from trino_tpu_torch.runner import StandaloneQueryRunner
from trino_tpu_torch.caching import result_cache

SF = 0.01

TICKER = [
    "create table ticker (symbol varchar, day bigint, price bigint)",
    "insert into ticker values "
    "('a',1,10),('a',2,8),('a',3,6),('a',4,9),('a',5,12),"
    "('a',6,11),('a',7,11),"
    "('b',1,5),('b',2,6),('b',3,4),('b',4,7)",
]


@pytest.fixture(autouse=True)
def _execution_not_cached():
    """Every statement here executes: a result-cache hit would skip the
    launches, syncs and revocations these tests count."""
    with result_cache.disabled():
        yield


@pytest.fixture(scope="module")
def port():
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu",
                              default_catalog_name="memory")
    for sql in TICKER:
        r.execute(sql)
    return r


@pytest.fixture(scope="module")
def ref_catalog_with_ticker():
    cat = ref_catalog(SF)
    r = RefRunner(cat, session=Session(default_catalog="memory"))
    for sql in TICKER:
        r.execute(sql)
    return cat


@pytest.fixture
def reference(ref_catalog_with_ticker, monkeypatch):
    _pin(monkeypatch)
    return RefRunner(ref_catalog_with_ticker,
                     session=Session(default_catalog="memory"))


def check(port, reference, sql, expected=None):
    """Port rows == reference rows (== ``expected`` when given)."""
    got = port.execute(sql).rows()
    want = reference.execute(sql).rows()
    _same_rows(got, want)
    if expected is not None:
        assert got == expected
    return got


def test_v_shape(port, reference):
    check(port, reference, """
        select * from ticker match_recognize (
          partition by symbol order by day
          measures match_number() as mno, first(a.day) as sd,
                   last(down.day) as bd, last(up.day) as ed,
                   last(up.price) as ep
          one row per match after match skip past last row
          pattern (a down+ up+)
          define down as price < prev(price), up as price > prev(price)
        ) order by symbol, mno""",
          [("a", 1, 1, 3, 5, 12), ("b", 1, 2, 3, 4, 7)])


def test_classifier_and_aggregates(port, reference):
    check(port, reference, """
        select * from ticker match_recognize (
          partition by symbol order by day
          measures count(*) as n, avg(down.price) as adp,
                   classifier() as last_label
          pattern (a down+ up)
          define down as price < prev(price), up as price > prev(price)
        ) order by symbol""", [("a", 4, 7.0, "UP"), ("b", 3, 4.0, "UP")])


def test_quantifier_bounds(port, reference):
    # exactly two DOWN rows required; b has no two consecutive downs
    check(port, reference, """
        select * from ticker match_recognize (
          partition by symbol order by day
          measures first(down.day) as d1, last(down.day) as d2
          pattern (down{2})
          define down as price < prev(price)
        ) order by symbol""", [("a", 2, 3)])


def test_alternation_and_skip_to_next(port, reference):
    rows = check(port, reference, """
        select * from ticker match_recognize (
          partition by symbol order by day
          measures classifier() as c, last(day) as d
          after match skip to next row
          pattern (up | down)
          define up as price > prev(price), down as price < prev(price)
        ) order by symbol, d""")
    assert [r for r in rows if r[0] == "a"] == [
        ("a", "DOWN", 2), ("a", "DOWN", 3), ("a", "UP", 4), ("a", "UP", 5),
        ("a", "DOWN", 6)]


def test_undefined_label_matches_all(port, reference):
    sql = """
        select * from ticker match_recognize (
          partition by symbol order by day
          measures count(*) as n
          pattern (x+)
          define x as true
        )"""
    got = sorted(port.execute(sql).rows())
    assert got == sorted(reference.execute(sql).rows()) == [("a", 7),
                                                            ("b", 4)]


def _engine_matches(parse, matcher, pattern: str, seq: str):
    m = matcher(parse(pattern),
                lambda l, i, ls: seq[i] == l).find_matches(len(seq))
    return [(x.start, x.end, x.labels) for x in m]


def test_alternation_backtracks_into_branches():
    # ((A B | A) B): the first alternative consumes both rows, the trailing
    # B fails, and the matcher must retry the A-only branch
    for pattern in ("(A B | A) B", "(A B | A)+ B"):
        got = _engine_matches(parse_pattern, PatternMatcher, pattern, "AB")
        assert got == _engine_matches(ref_parse, RefMatcher, pattern, "AB")
        assert got == [(0, 2, ["A", "B"])]


def test_match_number_in_define(port, reference):
    # rejecting match 1 keeps the counter at 1, so no candidate ever lands
    check(port, reference, """
        select * from ticker match_recognize (
          partition by symbol order by day
          measures last(day) as d
          after match skip to next row
          pattern (dn)
          define dn as price < prev(price) and match_number() >= 2
        ) order by symbol, d""", [])


def test_prev_with_label_anchor(port, reference):
    # PREV(A.price) navigates from the LAST A-labeled row, not current row
    check(port, reference, """
        select * from ticker match_recognize (
          partition by symbol order by day
          measures first(a.price) as ap, last(b.price) as bp
          pattern (a b)
          define b as price < prev(a.price, 0) - 1
        ) order by symbol""", [("a", 10, 8), ("b", 6, 4)])


def test_pattern_engine_unit():
    # greedy + backtracking: B* gives back a row so the last B can match
    got = _engine_matches(parse_pattern, PatternMatcher, "A B* C", "ABBBC")
    assert got == _engine_matches(ref_parse, RefMatcher, "A B* C", "ABBBC")
    assert got == [(0, 5, ["A", "B", "B", "B", "C"])]
    seq = "ABB"

    def pred(l, i, ls):
        return seq[i] == "A" if l == "A" else seq[i] == "B"

    ends = [m.end for m in PatternMatcher(parse_pattern("A B* B"),
                                          pred).find_matches(len(seq))]
    ref_ends = [m.end for m in RefMatcher(ref_parse("A B* B"),
                                          pred).find_matches(len(seq))]
    assert ends == ref_ends == [3]


def test_min_max_at_exact_group_bucket():
    # as many groups as a power of two, with dead rows after them: the
    # last group's min / max must not read the dead rows
    groups, per, dead = 8, 4, 5
    n = groups * per
    g = np.concatenate([np.repeat(np.arange(groups, dtype=np.int64), per),
                        np.zeros(dead, np.int64)])
    v = torch.from_numpy(np.concatenate([np.arange(n, dtype=np.int64) + 100,
                                         np.zeros(dead, np.int64)]))
    live = torch.from_numpy(np.arange(n + dead) < n)
    perm, gid, num = K.hash_group_ids([(torch.from_numpy(g), None)], live)
    assert num == groups
    out = K.grouped_reduce(perm, gid, num, [
        ("min", v, live, np.int64, False), ("max", v, live, np.int64, False)])
    keys = K.group_keys_out(perm, gid, num,
                            [(torch.from_numpy(g), None)])[0][0].tolist()
    mins = dict(zip(keys, out[0][0].tolist()))
    maxs = dict(zip(keys, out[1][0].tolist()))
    assert mins == {k: 100 + k * per for k in range(groups)}
    assert maxs == {k: 100 + k * per + per - 1 for k in range(groups)}


def test_bare_day_column_parses(port, reference):
    # 'day' is a soft keyword (interval unit) AND a legal column name
    check(port, reference, "select day from ticker where symbol = 'b' and "
          "day > 2 order by day", [(3,), (4,)])


@pytest.mark.parametrize("sql,error", [
    ("select * from ticker match_recognize (partition by symbol order by "
     "day measures count(*) as n pattern (a | ) define a as price > 0)",
     PatternSyntaxError),
    ("select * from ticker match_recognize (partition by symbol order by "
     "day measures count(*) as n pattern (a b) define c as price > 0)",
     None),
])
def test_pattern_errors_match_reference(port, reference, sql, error):
    with pytest.raises(Exception) as want:
        reference.execute(sql)
    with pytest.raises(error or Exception) as got:
        port.execute(sql)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_m1_matches_reference(port, reference, monkeypatch):
    sql = m1_text("tpch.orders")
    calls = _count_plain_calls(monkeypatch)
    rows = check(port, reference, sql)
    assert calls == {"insert": 0, "probe": 0, "segment_sum": 0}
    assert rows[0][0] > 0


def test_m1_over_ctas_cut(port, reference):
    """The card's route: CTAS of the cut into memory, then M1 over it."""
    ctas = f"create table ord_m1 as {M1_CUT.replace('orders', 'tpch.orders')}"
    for r in (port, reference):
        r.execute(ctas)
    try:
        rows = check(port, reference, m1_text("ord_m1"))
        cut = check(port, reference, m1_text("tpch.orders").replace(
            "from tpch.orders", "from ord_m1"))
        assert rows == cut and rows[0][0] > 0
    finally:
        for r in (port, reference):
            r.execute("drop table ord_m1")

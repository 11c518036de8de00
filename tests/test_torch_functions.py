"""Scalar, string, date and statistical functions through the torch port
against the JAX reference: the two repaired faults (unary minus, and
min / max over BOOLEAN behind bool_and / bool_or / every), the reference's
SCALAR_QUERIES and AGG_QUERIES, its FROM-less and string-semantics cases,
one case per ported handler over a SF 0.01 column, the calendar functions
on a range of days, and the surface queries F1 / F2.

The reference is pinned as in test_torch_iterative_queries.py; rows are
equal, doubles (stddev and variance too) to rtol 1e-9.
"""

import datetime
import decimal

import numpy as np
import pytest
import torch

from test_functions import AGG_QUERIES, SCALAR_QUERIES
from test_torch_iterative_queries import _pin
from test_torch_queries import _count_plain_calls, _same_rows
from test_torch_setops import check
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.ops import datetime as ref_dt
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.surface_queries import SURFACE_QUERIES
from trino_tpu_torch.ops import datetime as dt
from trino_tpu_torch.runner import StandaloneQueryRunner
from trino_tpu_torch.caching import result_cache

SF = 0.01


@pytest.fixture(autouse=True)
def _execution_not_cached():
    """Every statement here executes: a result-cache hit would skip the
    launches, syncs and revocations these tests count."""
    with result_cache.disabled():
        yield


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


# ---------------------------------------------------------------------------
# the repaired faults

NEGATE = {
    "columns": "select -l_quantity, -l_extendedprice, -(o_totalprice), "
               "-l_linenumber, -(l_discount * 1e0), "
               "-cast(l_tax as real) from lineitem, orders "
               "where l_orderkey = o_orderkey and o_orderkey < 200 "
               "order by l_orderkey, l_linenumber",
    # the parser folds a minus into a numeric literal; over a cast or a
    # sum the minus stays a negate
    "literals": "select -1, -2.5, -(-3), -1e0, -cast(2 as double), "
                "-(1 + 2)",
    "in_predicate": "select count(*) from lineitem "
                    "where -l_quantity < -45",
}


@pytest.mark.parametrize("case", list(NEGATE))
def test_negate_matches_reference(port, reference, case):
    rows = check(port, reference, NEGATE[case])
    if case == "literals":
        assert rows == [(-1, decimal.Decimal("-2.5"), 3, -1.0, -2.0, -3)]


BOOL_AGGS = {
    "global": "select bool_and(l_quantity > 1), bool_or(l_quantity > 49), "
              "every(l_discount >= 0), bool_and(l_quantity > 100), "
              "bool_or(l_quantity < 0) from lineitem",
    "grouped_small_codes": "select l_returnflag, bool_and(l_quantity > 1), "
                           "bool_or(l_quantity > 49), every(l_tax > 0) "
                           "from lineitem group by l_returnflag order by 1",
    "grouped_hash": "select l_linenumber, bool_and(l_quantity > 1), "
                    "bool_or(l_quantity = 50), every(l_discount < 0.1) "
                    "from lineitem group by l_linenumber order by 1",
    # NULL inputs: a NULL is skipped; an all-NULL group is NULL
    "with_nulls": "select n_regionkey, bool_and(case when n_nationkey % 3 "
                  "= 0 then null else n_nationkey > 4 end), "
                  "bool_or(case when n_regionkey = 2 then null else "
                  "n_nationkey > 20 end), every(case when n_regionkey = 2 "
                  "then null else true end) from nation "
                  "group by n_regionkey order by 1",
    "with_nulls_global": "select bool_and(case when n_nationkey = 0 then "
                         "null else n_nationkey > 0 end), bool_or(case "
                         "when n_nationkey > 0 then null else false end) "
                         "from nation",
}


@pytest.mark.parametrize("case", list(BOOL_AGGS))
def test_bool_aggregates_match_reference(port, reference, case):
    rows = check(port, reference, BOOL_AGGS[case])
    assert all(type(x) in (bool, type(None)) for r in rows for x in r[-3:])
    if case == "with_nulls":
        assert rows[2][1:] == (True, None, None)  # region 2: all NULL
    if case == "with_nulls_global":
        assert rows == [(True, False)]


# ---------------------------------------------------------------------------
# the reference's function lists

@pytest.mark.parametrize("sql", SCALAR_QUERIES)
def test_scalar_queries_match_reference(port, reference, sql):
    assert check(port, reference, sql)


SINGLE_ROW_GROUPS = AGG_QUERIES[3]


@pytest.mark.parametrize("sql", [q for q in AGG_QUERIES
                                 if q != SINGLE_ROW_GROUPS])
def test_aggregate_queries_match_reference(port, reference, sql):
    assert check(port, reference, sql)


def test_single_row_groups(port, reference):
    """var_samp is NULL and var_pop 0 for a one-row group.  The port's
    per-group sums are exact for one row, so var_pop is exactly 0.0.  The
    reference's sort path takes each group's sums as differences of
    running sums over the sorted rows, so its var_pop is 0 only to within
    the rounding of those running sums: a few ulps of the running sum of
    squares Q and of 2|x| times the running sum S (up to 7e-4 here).  The
    keys and var_samp are held exactly, the reference's var_pop to that
    bound."""
    got = port.execute(SINGLE_ROW_GROUPS).rows()
    want = reference.execute(SINGLE_ROW_GROUPS).rows()
    assert len(got) == len(want) > 20
    assert got == [(k, None, 0.0) for k, _, _ in want]
    x = np.array([float(r[1]) for r in port.execute(
        "select o_orderkey, o_totalprice from orders where o_orderkey < 100 "
        "order by 1").rows()])
    bound = 8 * np.finfo(np.float64).eps * (np.cumsum(x * x)
                                            + 2 * np.abs(x) * np.cumsum(x))
    assert all(s is None and 0.0 <= p <= b
               for (_, s, p), b in zip(want, bound))


def test_approx_distinct_geometric_mean_arbitrary(port, reference):
    for sql in ("select o_orderstatus, approx_distinct(o_custkey) from "
                "orders group by o_orderstatus",
                "select geometric_mean(l_quantity) from lineitem",
                "select arbitrary(n_regionkey), every(n_regionkey >= 0) "
                "from nation",
                "select n_regionkey, arbitrary(n_name), any_value(n_comment) "
                "from nation group by n_regionkey",
                "select l_linenumber, any_value(l_shipmode), "
                "arbitrary(l_quantity) from lineitem group by l_linenumber"):
        check(port, reference, sql)


def test_fromless_scalars(port, reference):
    sql = ("select round(pi(), 4), round(e(), 4), round(degrees(pi()), 1), "
           "truncate(2.71), round(cbrt(27.0), 6), log2(8)")
    rows = check(port, reference, sql)
    assert [float(x) for x in rows[0]] == [3.1416, 2.7183, 180.0, 2.0, 3.0,
                                           3.0]


def test_string_breadth_literals(port, reference):
    """split_part / lpad / rpad / translate / codepoint / position (repeat
    returns array(T) and waits for the nested types)."""
    sql = ("select split_part('a-b-c', '-', 2), lpad('x', 4, '*'), "
           "rpad('x', 3, 'ab'), translate('hello', 'el', 'ip'), "
           "codepoint('A')")
    assert check(port, reference, sql) == [("b", "***x", "xab", "hippo", 65)]
    assert check(port, reference,
                 "select n_name from nation where split_part(n_name, ' ', 1)"
                 " = 'UNITED' order by 1") == [("UNITED KINGDOM",),
                                               ("UNITED STATES",)]
    assert check(port, reference,
                 "select lpad('abcdef', 3), position('AN', n_name) from "
                 "nation where n_name = 'CANADA'") == [("abc", 2)]


@pytest.mark.parametrize("sql,expect", [
    # split_part: NULL past the last field
    ("select split_part('a-b', '-', 3)", [(None,)]),
    # translate: the first duplicate wins
    ("select translate('a', 'aa', 'bc')", [("b",)]),
    # codepoint: NULL unless exactly one character
    ("select codepoint('AB'), codepoint('A')", [(None, 65)]),
])
def test_string_trino_semantics(port, reference, sql, expect):
    assert check(port, reference, sql) == expect


@pytest.mark.parametrize("sql", [
    "select split_part('abc', '', 1)",  # empty delimiter
    "select lpad('abc', -2, '*')",  # negative size
    "select rpad('x', 5, '')",  # empty fill
])
def test_string_errors(port, reference, sql):
    for runner in (port, reference):
        with pytest.raises(Exception):
            runner.execute(sql)


# ---------------------------------------------------------------------------
# one case per ported handler over a SF 0.01 column

_LI = ("select l_orderkey, l_linenumber, {} from lineitem "
       "where l_orderkey < 120 order by 1, 2")
_PART = "select p_partkey, {} from part where p_partkey < 80 order by 1"
_ORD = ("select o_orderkey, {} from orders where o_orderkey < 300 "
        "order by 1")

HANDLERS = {
    "abs": _LI.format("abs(l_extendedprice - 40000), abs(-l_linenumber)"),
    "sqrt": _LI.format("sqrt(l_quantity)"),
    # the rounding functions read doubles made from integers: the two
    # packages cast a DECIMAL to DOUBLE up to an ulp apart, which moves a
    # value that lands on an integer across it
    "floor": _LI.format("floor(l_partkey / 7e0), floor(l_quantity)"),
    "ceil": _LI.format("ceil(l_partkey / 7e0), ceiling(l_discount)"),
    "exp": _LI.format("exp(l_discount)"),
    "ln": _LI.format("ln(l_quantity)"),
    "log10": _LI.format("log10(l_extendedprice)"),
    "log2": _LI.format("log2(l_quantity)"),
    "power": _LI.format("power(l_discount, 2), pow(l_linenumber, 3)"),
    "sign": _LI.format("sign(l_extendedprice - 30000), sign(l_tax - 0.04)"),
    "cbrt": _LI.format("cbrt(l_extendedprice - 40000)"),
    "degrees_radians": _LI.format("degrees(l_discount), radians(l_quantity)"),
    "trig": _LI.format("sin(l_quantity), cos(l_quantity), tan(l_discount)"),
    "inverse_trig": _LI.format("asin(l_discount), acos(l_tax), "
                               "atan(l_quantity), atan2(l_quantity, "
                               "l_linenumber)"),
    "is_nan": _LI.format("is_nan(ln(l_discount - 0.05)), "
                         "is_nan(l_discount * 1e0)"),
    "round": _LI.format("round(l_extendedprice * (1 - l_discount), 1), "
                        "round(l_extendedprice), round(l_partkey / 3e0, 2), "
                        "round(l_linenumber / 2e0), round(l_suppkey / 7e0)"),
    "truncate": _LI.format("truncate(l_extendedprice), "
                           "truncate(l_partkey / 3e0), "
                           "truncate(-l_suppkey / 7e0)"),
    "pi_e": _LI.format("l_quantity * pi(), e() * l_discount"),
    "greatest_least": _LI.format("greatest(l_shipdate, l_commitdate, "
                                 "l_receiptdate), least(l_discount, l_tax), "
                                 "greatest(l_quantity, 25)"),
    "day_of_week": _ORD.format("day_of_week(o_orderdate), dow(o_orderdate)"),
    "day_of_year": _ORD.format("day_of_year(o_orderdate), doy(o_orderdate)"),
    "date_trunc": _ORD.format(
        "date_trunc('year', o_orderdate), date_trunc('quarter', "
        "o_orderdate), date_trunc('month', o_orderdate), "
        "date_trunc('week', o_orderdate), date_trunc('day', o_orderdate)"),
    "date_trunc_timestamp": _ORD.format(
        "date_trunc('month', cast(o_orderdate as timestamp))"),
    "upper_lower": _PART.format("upper(p_name), lower(p_mfgr)"),
    "trims": _PART.format("trim(p_comment), ltrim(p_comment), "
                          "rtrim(p_comment)"),
    "length_reverse": _PART.format("length(p_name), reverse(p_brand)"),
    "concat": _PART.format("concat(p_brand, '/', p_container), "
                           "p_mfgr || '-' || p_brand"),
    "replace": _PART.format("replace(p_type, 'BRASS', 'B'), "
                            "replace(p_container, ' ')"),
    "strpos": _PART.format("strpos(p_name, 'green'), position('e', "
                           "p_name)"),
    "starts_with": _PART.format("starts_with(p_type, 'STANDARD')"),
    "split_part": _PART.format("split_part(p_name, ' ', 2), "
                               "split_part(p_type, ' ', 4)"),
    "pad": _PART.format("lpad(p_brand, 12, '*'), rpad(p_brand, 4)"),
    "translate": _PART.format("translate(p_container, 'AEO', 'aeo')"),
    "codepoint": _PART.format("codepoint(substr(p_name, 1, 1))"),
}


@pytest.mark.parametrize("case", list(HANDLERS))
def test_handler_matches_reference(port, reference, case):
    rows = check(port, reference, HANDLERS[case])
    assert len(rows) > 20


def test_calendar_functions_match_reference():
    days = np.arange(-800_000, 800_000, 97, dtype=np.int64)
    for name in ("day_of_week", "day_of_year", "trunc_year",
                 "trunc_quarter", "trunc_month", "trunc_week"):
        got = getattr(dt, name)(torch.from_numpy(days)).numpy()
        want = np.asarray(getattr(ref_dt, name)(days))
        np.testing.assert_array_equal(got, want, err_msg=name)
    # 2024-02-29 (a Thursday) and 1969-12-31 (a Wednesday)
    d = torch.tensor([(datetime.date(2024, 2, 29)
                       - datetime.date(1970, 1, 1)).days, -1])
    assert dt.day_of_week(d).tolist() == [4, 3]
    assert dt.day_of_year(d).tolist() == [60, 365]


# ---------------------------------------------------------------------------
# the surface queries

@pytest.mark.parametrize("name", ["F1", "F2"])
def test_surface_functions_match_reference(port, reference, monkeypatch,
                                           name):
    calls = _count_plain_calls(monkeypatch)
    got = port.execute(SURFACE_QUERIES[name]).rows()
    assert calls["insert"] == 1  # the group-by on computed keys
    _same_rows(got, reference.execute(SURFACE_QUERIES[name]).rows())
    assert len(got) == (581 if name == "F1" else 20)

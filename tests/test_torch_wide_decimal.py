"""decimal(38) through the torch port against the JAX reference: the
long-decimal tests of tests/test_wide_types.py (single node), N5 of
connectors/nested_queries.py, the limb tables of the exact wide SUM / AVG
against the reference's, and the two comparisons the port would have
made on dictionary codes (a long-decimal and an array compare against a
literal) and the SUM it would have made over them.  Also two results the
port computed differently from the reference before: a TIMESTAMP -> DATE
cast and a DECIMAL cast to DOUBLE divided by zero.

Long decimals are dictionary columns (a sorted dictionary of python scaled
ints, int32 codes on the device); every value is compared exactly, with
python Decimal under an 80-digit context.
"""

import decimal
from decimal import Decimal

import numpy as np
import pytest

from test_torch_nested import nested, pinned  # noqa: F401 (fixtures)
from test_torch_queries import _count_plain_calls, _same_rows
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.exec.kernels import decimal_limb_tables as ref_limb_tables
from trino_tpu.runner import Session
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.nested_queries import KERNELS, NESTED_QUERIES
from trino_tpu_torch.exec.kernels import (combine_limb_sums,
                                          decimal_limb_tables)
from trino_tpu_torch.runner import StandaloneQueryRunner
from trino_tpu_torch.spi.batch import _object_array
from trino_tpu_torch.spi.types import DecimalType, MapType, RowType, parse_type
from trino_tpu_torch.caching import result_cache

SF = 0.01

BIG = [
    "12345678901234567890123456789012.345678",
    "-9999999999999999999999999999.000001",
    "0.000001",
    "777777777777777777777777.500000",
    None,
    "12345678901234567890123456789012.345678",  # duplicate on purpose
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
    rows = ", ".join(f"({i}, {v if v is not None else 'null'})"
                     for i, v in enumerate(BIG))
    for sql in ("create table wide (k bigint, v decimal(38,6))",
                f"insert into wide values {rows}"):
        port.execute(sql)
        ref.execute(sql)
    return port, ref


def same(runners, sql):
    port, ref = runners
    got = port.execute(sql).rows()
    _same_rows(got, ref.execute(sql).rows())
    return got


def test_parse_wide_types():
    t = parse_type("decimal(38,6)")
    assert isinstance(t, DecimalType) and t.is_long and t.scale == 6
    rt = parse_type("row(x bigint, y varchar)")
    assert isinstance(rt, RowType) and rt.fields[0][0] == "x"
    mt = parse_type("map(varchar, bigint)")
    assert isinstance(mt, MapType) and mt.key.name == "varchar"


def _exact(values):
    return [Decimal(v) for v in values if v is not None]


def test_long_decimal_roundtrip_and_order(runners):
    got = same(runners, "select v from wide order by v")
    assert [r[0] for r in got] == sorted(_exact(BIG)) + [None]


def test_long_decimal_compare_and_group(runners):
    assert same(runners, "select count(*) from wide where v > 0.5") == [(3,)]
    rows = same(runners, "select v, count(*) from wide group by v order by v")
    assert rows[0][1] == 1 and rows[-2][1] == 2
    assert same(runners, "select count(*) from wide where v = "
                "12345678901234567890123456789012.345678") == [(2,)]


def test_long_decimal_sum_avg_exact(runners):
    vals = _exact(BIG)
    with decimal.localcontext() as ctx:
        ctx.prec = 80
        total = sum(vals)
        avg = (total / len(vals)).quantize(Decimal("0.000001"))
    (row,) = same(runners, "select sum(v), avg(v), min(v), max(v), "
                           "count(v) from wide")
    assert row == (total, avg, min(vals), max(vals), len(vals))


def test_long_decimal_grouped_sum(runners):
    rows = same(runners, "select k % 2, sum(v) from wide group by 1 "
                         "order by 1")
    with decimal.localcontext() as ctx:
        ctx.prec = 80
        assert rows == [(0, Decimal(BIG[0]) + Decimal(BIG[2])),
                        (1, sum(Decimal(BIG[i]) for i in (1, 3, 5)))]


def test_long_decimal_arith_with_literal(runners):
    assert same(runners, "select v * 2, v + 0.5 from wide where k = 2") == [
        (Decimal("0.000002"), Decimal("0.500001"))]


def test_long_decimal_casts(runners):
    (row,) = same(runners, "select cast(v as double), cast(v as varchar) "
                           "from wide where k = 3")
    assert abs(row[0] - 7.777777777777778e23) < 1e10
    assert row[1].startswith("777777777777777777777777.5")
    assert same(runners, "select cast('123.456' as decimal(38,4))") == [
        (Decimal("123.4560"),)]


def _wide_codes(port):
    (batch,) = port.catalog.connector("memory")._data["wide"]
    col = batch.column("v")
    return col.data.tolist(), col.valid_mask().tolist(), col.dictionary


def test_long_decimal_compare_is_not_a_code_compare(runners):
    """``v > 0.5`` on the codes would compare each code with the literal's
    code 0; the rows it would give differ from the exact answer, which the
    port and the reference both give."""
    port, _ = runners
    codes, valid, dictionary = _wide_codes(port)
    by_code = sorted(k for k, (c, ok) in enumerate(zip(codes, valid))
                     if ok and c > 0)
    exact = sorted(k for k, v in enumerate(BIG)
                   if v is not None and Decimal(v) > Decimal("0.5"))
    assert by_code != exact
    got = same(runners, "select k from wide where v > 0.5 order by k")
    assert [r[0] for r in got] == exact
    got = same(runners, "select k from wide where v < "
               "12345678901234567890123456789012.345678 order by k")
    assert [r[0] for r in got] == [1, 2, 3]


def test_long_decimal_sum_is_not_a_code_sum(runners):
    """SUM / AVG over a long-decimal column add the values, not the int32
    codes a plain sum of the column's data would add."""
    port, _ = runners
    codes, valid, _ = _wide_codes(port)
    code_sum = sum(c for c, ok in zip(codes, valid) if ok)
    ((s, a),) = same(runners, "select sum(v), avg(v) from wide")
    with decimal.localcontext() as ctx:
        ctx.prec = 80
        assert s == sum(_exact(BIG)) != Decimal(code_sum).scaleb(-6)
        assert a == (s / 5).quantize(Decimal("0.000001"),
                                     rounding=decimal.ROUND_HALF_UP)


@pytest.mark.parametrize("sql, want", [
    ("select k from wide where v in (0.000001, 777777777777777777777777.5) "
     "order by k", [2, 3]),
    ("select k from wide where v not in (0.000001) order by k",
     [0, 1, 3, 5]),
])
def test_long_decimal_in_list_matches_values(runners, sql, want):
    """IN over a long-decimal column matches the scaled ints, not their
    text.  The reference compares the dictionary's ints with the items'
    strings and matches nothing (ROADMAP queue 3), so the port is held to
    the exact rows here."""
    port, _ = runners
    assert [r[0] for r in port.execute(sql).rows()] == want


@pytest.mark.parametrize("expr", ["abs(v)", "-v", "round(v, 2)", "floor(v)",
                                  "greatest(v, 1)", "truncate(v)"])
def test_arithmetic_on_codes_raises(runners, expr):
    """A function computed on a long decimal's codes would give numbers
    that mean nothing: it raises when the expression is compiled (the
    reference computes on the codes and fails or drops them later)."""
    port, _ = runners
    with pytest.raises(NotImplementedError, match="decimal"):
        port.execute(f"select k from wide where {expr} > 1")


def test_distinct_long_decimal_aggregate_raises(runners):
    port, _ = runners
    with pytest.raises(NotImplementedError, match="DISTINCT"):
        port.execute("select sum(distinct v) from wide")


def test_decimal_limb_tables_match_reference():
    rng = np.random.default_rng(38)
    top = 10 ** 38 - 1
    vals = [0, 1, -1, top, -top, 2 ** 62, -2 ** 62, 2 ** 124, -2 ** 124]
    # up to 38 digits from two 19-digit halves, both signs
    hi, lo = rng.integers(0, 10 ** 19, (2, 1000), dtype=np.uint64)
    sign = rng.choice([-1, 1], 1000)
    width = rng.integers(0, 20, 1000)
    vals += [int(s) * (int(h) // 10 ** int(w) * 10 ** 19 + int(x))
             for s, h, x, w in zip(sign, hi, lo, width)]
    d = _object_array(sorted(set(vals)))
    mine, theirs = decimal_limb_tables(d), ref_limb_tables(d)
    assert len(mine) == len(theirs) == 6
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype == np.int64
        assert np.array_equal(a, b)
    for i in range(0, len(d), 97):
        assert combine_limb_sums([t[i] for t in mine]) == d[i]


def test_n5_matches_reference(nested, monkeypatch):  # noqa: F811
    port, ref, batch = nested
    calls = _count_plain_calls(monkeypatch)
    got = port.execute(NESTED_QUERIES["N5"]).rows()
    assert (calls["insert"] > 0) == ("hash_insert" in KERNELS["N5"])
    _same_rows(got, ref.execute(NESTED_QUERIES["N5"]).rows())
    # exact: python-int sums of the orders' amounts over the literal
    cut = Decimal("100000.000000000000000001")
    status = batch.column("o_orderstatus").to_pylist()
    amount = batch.column("o_amount").to_pylist()
    with decimal.localcontext() as ctx:
        ctx.prec = 80
        for st, s, a, lo, hi, n in got:
            mine = [v for t, v in zip(status, amount) if t == st and v > cut]
            assert (s, lo, hi, n) == (sum(mine), min(mine), max(mine),
                                      len(mine))
            assert a == (s / n).quantize(Decimal(1).scaleb(-18),
                                         rounding=decimal.ROUND_HALF_UP)


# two results the port computed differently from the reference before


@pytest.mark.parametrize("sql", [
    "select cast(timestamp '2020-01-02 03:04:05' as date)",
    "select cast(timestamp '1969-12-31 23:00:00' as date)",
    "select cast(cast(o_orderdate as timestamp) as date) from tpch.orders "
    "where o_orderkey = 1",
])
def test_timestamp_to_date_cast_matches_reference(runners, sql):
    assert same(runners, sql)


@pytest.mark.parametrize("sql", [
    "select sum(l_quantity / 0e0) from tpch.lineitem",
    "select count(*) from tpch.lineitem where l_extendedprice / 0e0 > 1",
])
def test_decimal_as_double_division_by_zero_raises(runners, sql):
    """A DECIMAL operand folded to DOUBLE keeps exact division's error:
    dividing it by zero raises DIVISION_BY_ZERO (a plain double's x / 0 is
    NULL), as in the reference."""
    port, ref = runners
    with pytest.raises(Exception, match="DIVISION_BY_ZERO"):
        ref.execute(sql)
    with pytest.raises(Exception, match="DIVISION_BY_ZERO"):
        port.execute(sql)
    assert same(runners, "select n_nationkey / 0e0 from tpch.nation "
                         "where n_nationkey = 3") == [(None,)]

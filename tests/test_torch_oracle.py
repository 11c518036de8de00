"""The port's sqlite oracle (trino_tpu_torch/testing/oracle.py) against the
reference's.

``transpile`` gives the reference's text for the 22 TPC-H queries, the
chaos mix and the kill drill's statement.  Each package's oracle, loaded
from its own tpch connector at SF 0.01, gives the same rows (exact: both
sides are sqlite over the same generated data) for the TPC-H queries that
sqlite answers in well under a second here (Q19 and Q21 take 17 s and
130 s in this container's sqlite and are left out of the rows check, not
of the transpile check).  Then the reference's oracle cases of
tests/test_tpch_connector.py, on the port's connector, and the port's
column-wise load into sqlite held value for value (and type for type) to
the row loop it replaces, over every TPC-H table and a batch with NULLs.
"""

import datetime
import decimal

import pytest

from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.testing import chaos as ref_chaos
from trino_tpu.testing.oracle import SqliteOracle as RefOracle
from trino_tpu.testing.oracle import normalize_rows as ref_normalize_rows
from trino_tpu.testing.oracle import transpile as ref_transpile
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.tpch_queries import QUERIES
from trino_tpu_torch.testing import chaos
from trino_tpu_torch.testing.oracle import (SqliteOracle, assert_same_rows,
                                            load_tables, normalize_rows,
                                            transpile)

SF = 0.01
TABLES = ("region", "nation", "supplier", "customer", "part", "partsupp",
          "orders", "lineitem")
SLOW_IN_SQLITE = {19, 21}
STATEMENTS = ([f"Q{q}" for q in sorted(QUERIES)]
              + [f"mix{i}" for i in range(len(chaos.QUERY_MIX))]
              + ["user_error", "drill"])


def _text(name: str) -> str:
    if name.startswith("Q"):
        return QUERIES[int(name[1:])]
    if name.startswith("mix"):
        return chaos.QUERY_MIX[int(name[3:])]
    return chaos.USER_ERROR_SQL if name == "user_error" else chaos._DRILL_SQL


def _ref_load(oracle, conn, tables):
    for t in tables:
        cols = conn.get_table_schema(t).column_names()
        batches = []
        for s in conn.get_splits(t, 2, 1):
            src = conn.create_page_source(s, cols)
            while not src.is_finished():
                b = src.get_next_batch()
                if b is not None:
                    batches.append(b)
        oracle.load_table(t, batches)
    return oracle


@pytest.fixture(scope="module")
def oracles():
    port = load_tables(SqliteOracle(),
                       default_catalog(SF).connector("tpch"), TABLES)
    ref = _ref_load(RefOracle(), ref_catalog(scale_factor=SF)
                    .connector("tpch"), TABLES)
    return port, ref


@pytest.fixture(scope="module")
def conn():
    return default_catalog(SF).connector("tpch")


@pytest.mark.parametrize("name", STATEMENTS)
def test_transpile_equals_reference(name):
    sql = _text(name)
    assert transpile(sql) == ref_transpile(sql)


@pytest.mark.parametrize("q", [q for q in sorted(QUERIES)
                               if q not in SLOW_IN_SQLITE])
def test_rows_equal_reference_oracle(oracles, q):
    port, ref = oracles
    got, want = port.query(QUERIES[q]), ref.query(QUERIES[q])
    assert normalize_rows(got, 6) == ref_normalize_rows(want, 6)
    assert_same_rows(got, want, ordered=True)


def test_mix_rows_equal_reference_oracle(oracles):
    port, ref = oracles
    for sql in chaos.QUERY_MIX + [chaos._DRILL_SQL]:
        assert port.query(sql) == ref.query(sql), sql


def test_loaded_tables_equal_reference(oracles):
    port, ref = oracles
    for t in TABLES:
        n = port.query(f"select count(*) from {t}")
        assert n == ref.query(f"select count(*) from {t}") and n[0][0] > 0


def test_load_tables_takes_columns(conn):
    """Only the named columns reach sqlite (what the chaos harness loads
    at SF 1)."""
    o = load_tables(SqliteOracle(), conn, ["orders"],
                    {"orders": ("o_orderkey", "o_totalprice")})
    cols = [r[1] for r in o.db.execute("pragma table_info(orders)")]
    assert cols == ["o_orderkey", "o_totalprice"]
    assert o.query("select count(*) from orders") == [(15000,)]


# ---------------------------------------------------------------------------
# the reference's oracle cases (tests/test_tpch_connector.py)


def test_oracle_transpile_and_query(conn):
    oracle = load_tables(SqliteOracle(), conn, ["nation"], {
        "nation": ("n_nationkey", "n_name", "n_regionkey")})
    sql = transpile("select n_name from nation where n_regionkey = 3")
    assert "interval" not in sql
    rows = oracle.query("select count(*) from nation where n_regionkey = 1")
    assert rows == [(5,)]
    # date literal + interval arithmetic
    t = transpile("select * from x where d < date '1993-07-01' + interval "
                  "'3' month")
    assert "add_months(8582, 3)" in t
    t = transpile("select * from x where d <= date '1998-12-01' - interval "
                  "'90' day")
    assert "(10561 + -90)" in t
    rows = oracle.query("select tpch_year(9000), tpch_quarter(9000)")
    assert rows == [(1994, 3)]


def test_oracle_assert_same_rows():
    assert_same_rows(
        [(decimal.Decimal("1.50"), datetime.date(1995, 1, 1), "x")],
        [(1.5, 9131, "x")],
    )
    with pytest.raises(AssertionError):
        assert_same_rows([(1,)], [(2,)])


def test_expected_mix_rows_equal_reference():
    """The chaos harness's expected rows (the port's oracle over only the
    mix's columns) equal the reference's (its oracle over every column)."""
    got, want = chaos.build_expected(SF), ref_chaos.build_expected()
    assert sorted(got) == sorted(want)
    for sql in want:
        assert got[sql] == want[sql], sql


# ---------------------------------------------------------------------------
# the column-wise load against the row loop it replaces


def _row_loop(batch) -> list:
    from trino_tpu_torch.testing.oracle import _to_sqlite

    return [tuple(_to_sqlite(v) for v in row) for row in batch.to_pylist()]


@pytest.mark.parametrize("table", TABLES)
def test_column_load_equals_the_row_loop(conn, table):
    """Every column type of the TPC-H tables goes into sqlite as exactly
    the value ``_to_sqlite`` makes of ``to_pylist`` (the reference's
    loop)."""
    from trino_tpu_torch.testing.oracle import _sqlite_rows

    cols = conn.get_table_schema(table).column_names()
    split = conn.get_splits(table, 2, 1)[0]
    src = conn.create_page_source(split, cols)
    batch = src.get_next_batch()
    while batch is None:
        batch = src.get_next_batch()
    got = _sqlite_rows(batch)
    assert got == _row_loop(batch)
    assert [type(v) for v in got[0]] == [type(v) for v in _row_loop(batch)[0]]


def test_column_load_nulls_and_other_types():
    import numpy as np

    from trino_tpu_torch.spi.batch import Column, ColumnBatch
    from trino_tpu_torch.spi.types import (BIGINT, BOOLEAN, DATE, DOUBLE,
                                           REAL, VARCHAR, DecimalType)
    from trino_tpu_torch.testing.oracle import _sqlite_rows

    values = {
        "b": (BOOLEAN, [True, None, False]),
        "i": (BIGINT, [-(1 << 40), 7, None]),
        "d": (DOUBLE, [0.1, None, float("inf")]),
        "r": (REAL, [np.float32(0.3), 1.5, None]),
        "s": (VARCHAR, ["x", None, "yz"]),
        "dt": (DATE, [datetime.date(1995, 1, 1), None,
                      datetime.date(1970, 1, 2)]),
        "m": (DecimalType(12, 2), [decimal.Decimal("1.05"), None,
                                   decimal.Decimal("-99999999.99")]),
        "w": (DecimalType(30, 3), [decimal.Decimal("123456789012345.678"),
                                   None, decimal.Decimal("0.001")]),
    }
    batch = ColumnBatch(list(values), [Column.from_values(t, v)
                                       for t, v in values.values()])
    assert _sqlite_rows(batch) == _row_loop(batch)

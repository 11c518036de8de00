"""sqlite3-backed correctness oracle.

The port of the reference ``testing/oracle.py``.  The reference checks
every ``assertQuery(sql)`` against H2 running the same statement on the
same data (testing/trino-testing/.../H2QueryRunner.java:91,
QueryAssertions.java:51).  Here the oracle is the stdlib ``sqlite3``:
engine tables are loaded into sqlite (decimals as REAL, dates as INTEGER
epoch-days, strings decoded from their dictionaries), the SQL is
transpiled for the sqlite dialect (date/interval literals and EXTRACT
become integer math and UDFs), and results are compared as multisets with
float tolerance.

Tables come from the port's connectors as ``ColumnBatch``es, on whatever
device they live: ``ColumnBatch.to_pylist`` moves each column to the host,
and only those host values cross into sqlite.  :func:`load_tables` reads
whole tables from a connector, as every harness of the reference does by
hand.
"""

from __future__ import annotations

import datetime
import decimal
import math
import re
import sqlite3
from typing import Iterable, Optional, Sequence

import numpy as np

from ..spi.batch import ColumnBatch
from ..spi.types import (BOOLEAN, DOUBLE, ArrayType, DecimalType, MapType,
                         RowType)

__all__ = ["SqliteOracle", "normalize_rows", "assert_same_rows",
           "load_tables", "transpile"]

_EPOCH = datetime.date(1970, 1, 1)


def _to_days(text: str) -> int:
    return (datetime.date.fromisoformat(text) - _EPOCH).days


def _add_months(days: int | None, n: int) -> int | None:
    if days is None:
        return None
    d = _EPOCH + datetime.timedelta(days=days)
    total = d.year * 12 + (d.month - 1) + n
    y, m = divmod(total, 12)
    m += 1
    # clamp to end of month
    if m == 12:
        last = 31
    else:
        last = (datetime.date(y, m + 1, 1) - datetime.timedelta(days=1)).day
    return (datetime.date(y, m, min(d.day, last)) - _EPOCH).days


def _year(days):
    return None if days is None else (_EPOCH + datetime.timedelta(days=days)).year


def _month(days):
    return None if days is None else (_EPOCH + datetime.timedelta(days=days)).month


def _quarter(days):
    return None if days is None else (_month(days) + 2) // 3


def transpile(sql: str) -> str:
    """Rewrite engine SQL into sqlite dialect (dates are INTEGER days)."""
    out = sql
    # date literal +- interval  =>  computed integer / add_months()
    out = re.sub(r"(?i)\bdate\s*'(\d{4}-\d\d-\d\d)'", lambda m: str(_to_days(m.group(1))), out)

    def interval_repl(m):
        lhs, op, n, unit = m.group(1), m.group(2), int(m.group(3)), m.group(4).lower()
        if op == "-":
            n = -n
        if unit == "day":
            return f"({lhs} + {n})"
        months = n * (12 if unit == "year" else 1)
        return f"add_months({lhs}, {months})"

    prev = None
    while prev != out:
        prev = out
        out = re.sub(
            r"(?is)([\w.]+|\([^()]*\)|\d+)\s*([+-])\s*interval\s*'(\d+)'\s*(day|month|year)",
            interval_repl,
            out,
        )
    # fold decimal-literal +/- decimal-literal exactly (sqlite would do it in
    # binary float: 0.06 + 0.01 != 0.07 there, so BETWEEN endpoints miss rows
    # that SQL decimal semantics include).  Folding only fires right after a
    # comparison/BETWEEN/AND token so operator precedence and left-
    # associativity can't change the value (never inside `a - b - c` chains
    # or next to * and /).
    def fold(m):
        a, op, b = decimal.Decimal(m.group(2)), m.group(3), decimal.Decimal(m.group(4))
        return m.group(1) + str(a + b if op == "+" else a - b)

    prev = None
    while prev != out:
        prev = out
        out = re.sub(
            r"(?is)(between\s+|and\s+|[=<>]=?\s*)"
            r"(\d+\.\d+)\s*([+-])\s*(\d+\.\d+)(?!\s*[*/])(?![\w.])",
            fold,
            out,
        )
    out = re.sub(r"(?is)extract\s*\(\s*year\s+from\s+", "tpch_year(", out)
    out = re.sub(r"(?is)extract\s*\(\s*month\s+from\s+", "tpch_month(", out)
    out = re.sub(r"(?is)extract\s*\(\s*quarter\s+from\s+", "tpch_quarter(", out)
    out = re.sub(r"(?i)\bsubstring\s*\(", "substr(", out)
    out = re.sub(r"(?i)\bgreatest\s*\(", "max(", out)
    out = re.sub(r"(?i)\bleast\s*\(", "min(", out)
    out = re.sub(r"(?i)\bif\s*\(", "iif(", out)
    return out


class _VarAgg:
    """Aggregate UDF for the variance/stddev family (matches Trino's
    VarianceAccumulator semantics: *_samp NULL below 2 rows, *_pop 0 for 1)."""

    kind = "var_samp"

    def __init__(self):
        self.n = 0
        self.s = 0.0
        self.q = 0.0

    def step(self, v):
        if v is None:
            return
        v = float(v)
        self.n += 1
        self.s += v
        self.q += v * v

    def finalize(self):
        if self.n == 0:
            return None
        m2 = max(self.q - self.s * self.s / self.n, 0.0)
        if self.kind in ("var_pop", "stddev_pop"):
            var = m2 / self.n
        else:
            if self.n < 2:
                return None
            var = m2 / (self.n - 1)
        return math.sqrt(var) if self.kind.startswith("stddev") else var


def _var_agg(kind_name):
    return type(f"_Agg_{kind_name}", (_VarAgg,), {"kind": kind_name})


class _BoolAgg:
    all_mode = True

    def __init__(self):
        self.acc = None

    def step(self, v):
        if v is None:
            return
        b = bool(v)
        self.acc = b if self.acc is None else (
            (self.acc and b) if self.all_mode else (self.acc or b))

    def finalize(self):
        return None if self.acc is None else int(self.acc)


def _date_trunc(unit, days):
    if days is None:
        return None
    d = _EPOCH + datetime.timedelta(days=days)
    u = unit.lower()
    if u == "year":
        t = datetime.date(d.year, 1, 1)
    elif u == "quarter":
        t = datetime.date(d.year, ((d.month - 1) // 3) * 3 + 1, 1)
    elif u == "month":
        t = datetime.date(d.year, d.month, 1)
    elif u == "week":
        t = d - datetime.timedelta(days=d.weekday())
    else:
        t = d
    return (t - _EPOCH).days


class SqliteOracle:
    def __init__(self):
        self.db = sqlite3.connect(":memory:")
        self.db.create_function("add_months", 2, _add_months, deterministic=True)
        self.db.create_function("tpch_year", 1, _year, deterministic=True)
        self.db.create_function("tpch_month", 1, _month, deterministic=True)
        self.db.create_function("tpch_quarter", 1, _quarter, deterministic=True)
        for k in ("stddev", "stddev_samp", "stddev_pop",
                  "variance", "var_samp", "var_pop"):
            self.db.create_aggregate(k, 1, _var_agg(k))
        self.db.create_aggregate(
            "bool_and", 1, type("_BA", (_BoolAgg,), {"all_mode": True}))
        self.db.create_aggregate(
            "bool_or", 1, type("_BO", (_BoolAgg,), {"all_mode": False}))
        self.db.create_function("date_trunc", 2, _date_trunc, deterministic=True)
        self.db.create_function(
            "day_of_week", 1,
            lambda d: None if d is None else
            (_EPOCH + datetime.timedelta(days=d)).isoweekday(),
            deterministic=True)
        self.db.create_function(
            "day_of_year", 1,
            lambda d: None if d is None else
            (_EPOCH + datetime.timedelta(days=d)).timetuple().tm_yday,
            deterministic=True)
        self.db.create_function(
            "strpos", 2,
            lambda s, sub: None if s is None or sub is None else s.find(sub) + 1,
            deterministic=True)
        self.db.create_function(
            "starts_with", 2,
            lambda s, p: None if s is None or p is None else int(s.startswith(p)),
            deterministic=True)
        self.db.create_function(
            "reverse", 1, lambda s: None if s is None else s[::-1],
            deterministic=True)
        self.db.create_function(
            "concat", -1,
            lambda *a: None if any(x is None for x in a) else
            "".join(str(x) for x in a),
            deterministic=True)
        self.db.create_function(
            "sign", 1,
            lambda v: None if v is None else (v > 0) - (v < 0),
            deterministic=True)
        self.db.create_function(
            "mod", 2,
            lambda a, b: None if a is None or b is None or b == 0 else
            math.fmod(a, b) if isinstance(a, float) or isinstance(b, float)
            else int(math.fmod(a, b)),
            deterministic=True)
        self.db.create_aggregate("count_if", 1, type("_CI", (), {
            "__init__": lambda s: setattr(s, "n", 0),
            "step": lambda s, v: setattr(s, "n", s.n + bool(v)),
            "finalize": lambda s: s.n,
        }))

    def load_table(self, name: str, batches: Iterable[ColumnBatch]) -> None:
        batches = list(batches)
        first = batches[0]
        cols = ", ".join(f'"{c}"' for c in first.names)
        self.db.execute(f'create table "{name}" ({cols})')
        placeholders = ", ".join("?" * first.num_columns)
        for b in batches:
            self.db.executemany(f'insert into "{name}" values ({placeholders})',
                                _sqlite_rows(b))
        self.db.commit()

    def query(self, sql: str) -> list[tuple]:
        return list(self.db.execute(transpile(sql)))


def load_tables(oracle: SqliteOracle, connector, tables: Sequence[str],
                columns: Optional[dict] = None,
                splits: int = 2) -> SqliteOracle:
    """Load every row of ``tables`` from ``connector`` (two splits each,
    as the reference's harnesses read them) into ``oracle``.  ``columns``
    maps a table to the columns to load (default: all of them)."""
    for t in tables:
        cols = list((columns or {}).get(t) or
                    connector.get_table_schema(t).column_names())
        batches = []
        for s in connector.get_splits(t, splits, 1):
            src = connector.create_page_source(s, cols)
            while not src.is_finished():
                b = src.get_next_batch()
                if b is not None:
                    batches.append(b)
        oracle.load_table(t, batches)
    return oracle


def _to_sqlite(v):
    if isinstance(v, decimal.Decimal):
        return float(v)
    if isinstance(v, datetime.date):
        return (v - _EPOCH).days
    return v


def _sqlite_rows(batch: ColumnBatch) -> list[tuple]:
    """A batch's rows as the sqlite values ``_to_sqlite`` makes of
    ``to_pylist``, built a column at a time through numpy where the type
    allows it (a Python loop over every value made loading SF 1 the
    oracle's whole cost)."""
    dense = batch.compact()
    cols = [_sqlite_column(c) for c in dense.columns]
    return list(zip(*cols)) if cols else []


def _sqlite_column(col) -> list:
    t = col.type
    if isinstance(t, (ArrayType, MapType, RowType)) or (
            isinstance(t, DecimalType) and t.is_long):
        return [_to_sqlite(v) for v in col.to_pylist()]
    data = col.data.cpu().numpy()
    if t.is_dictionary_encoded:
        values = [str(v) for v in
                  np.asarray(col.dictionary, dtype=object)[data]]
    elif isinstance(t, DecimalType):
        if len(data) and int(np.abs(data).max()) >= 1 << 53:
            return [_to_sqlite(v) for v in col.to_pylist()]
        # int64 -> float64 is exact below 2^53 and 10^scale is exact, so
        # the quotient is float(Decimal) correctly rounded, as _to_sqlite
        values = (data.astype(np.float64) / 10.0 ** t.scale).tolist()
    elif t == BOOLEAN:
        values = data.astype(bool).tolist()
    elif t == DOUBLE or t.name == "real":
        values = data.astype(np.float64).tolist()
    else:  # integers, DATE (epoch days, as _to_sqlite makes of a date)
        values = data.astype(np.int64).tolist()
    valid = col.valid_mask().cpu().numpy()
    if not valid.all():
        values = [v if ok else None for v, ok in zip(values, valid.tolist())]
    return values


def normalize_rows(rows: Sequence[tuple], float_digits: int = 2) -> list[tuple]:
    """Normalize to comparable form: dates -> epoch days, Decimal/float ->
    rounded float, None kept."""
    out = []
    for row in rows:
        norm = []
        for v in row:
            if isinstance(v, datetime.date):
                norm.append((v - _EPOCH).days)
            elif isinstance(v, decimal.Decimal):
                norm.append(round(float(v), float_digits))
            elif isinstance(v, float):
                if math.isnan(v):
                    norm.append("NaN")
                else:
                    norm.append(round(v, float_digits))
            elif isinstance(v, bool):
                norm.append(int(v))
            else:
                norm.append(v)
        out.append(tuple(norm))
    return out


def assert_same_rows(actual: Sequence[tuple], expected: Sequence[tuple],
                     ordered: bool = False, float_digits: int = 2) -> None:
    a = normalize_rows(actual, float_digits)
    e = normalize_rows(expected, float_digits)
    if not ordered:
        # numbers sort together regardless of int/float representation
        # (sqlite keeps literal ints where the engine produces decimals)
        def key(r):
            out = []
            for x in r:
                if x is None:
                    out.append((1, "", 0.0, ""))
                elif isinstance(x, (int, float)):
                    out.append((0, "num", float(x), ""))
                else:
                    out.append((0, str(type(x)), 0.0, str(x)))
            return tuple(out)

        a = sorted(a, key=key)
        e = sorted(e, key=key)
    assert len(a) == len(e), f"row count {len(a)} != expected {len(e)}\nactual head: {a[:5]}\nexpected head: {e[:5]}"
    for i, (ra, re_) in enumerate(zip(a, e)):
        assert _row_eq(ra, re_), f"row {i} differs:\n  actual   {ra}\n  expected {re_}"


def _row_eq(a: tuple, b: tuple) -> bool:
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, int) and isinstance(y, int):
            if x != y:
                return False
        elif isinstance(x, (int, float)) and isinstance(y, (int, float)):
            # representations may differ (sqlite int vs engine decimal/float)
            if not math.isclose(x, y, rel_tol=1e-6, abs_tol=1e-2):
                return False
        elif x != y:
            return False
    return True

"""TPC-H data-generator connector (the v1 data source).

Mirrors ``plugin/trino-tpch`` (reference: TpchSplitManager.java:36 with
``splitsPerNode:40``, TpchPageSourceProvider) but generates columns with
vectorized numpy instead of row-at-a-time dbgen: every value is a pure
function of (table, column, row-key) through a splitmix64-style hash, so
generation is deterministic, order-independent, and split-parallel with no
shared RNG state.  Only projected columns are generated (the LazyBlock
equivalent — reference: spi/block/LazyBlock.java).

Fidelity: schemas, key structure (incl. the partsupp<->lineitem supplier
alignment Q9 needs, customers without orders for Q13/Q22, orderstatus and
totalprice consistent with each order's lineitems), official value
vocabularies, and the spec's date correlations are kept; textual comments are
template-generated with the predicate-relevant phrases ('special requests',
'Customer Complaints') injected at spec-like selectivities.  Numbers are NOT
bit-identical to dbgen — correctness tests diff against a sqlite oracle
loaded with the same generated data (SURVEY §4's H2-oracle pattern).

Scale: base cardinalities follow the spec (lineitem ~6M rows/SF).  Splits of
lineitem/orders are ranges of *orders* so each split carries whole orders.
"""

from __future__ import annotations

import datetime
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..spi.batch import Column, ColumnBatch
from ..spi.connector import (
    ColumnSchema,
    Connector,
    ConnectorPageSource,
    Split,
    TableSchema,
    TableStatistics,
)
from ..spi.types import BIGINT, DATE, INTEGER, VARCHAR, DecimalType, Type

# --------------------------------------------------------------------------
# deterministic hashing (splitmix64 finalizer, vectorized)

_U = np.uint64


def _h64(x: np.ndarray, stream: int) -> np.ndarray:
    # stream constant folded in python ints (explicit mod-2^64 wraparound)
    z = x.astype(np.uint64) + _U((0x9E3779B97F4A7C15 * (stream * 2 + 1)) & (2**64 - 1))
    z = (z ^ (z >> _U(30))) * _U(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> _U(27))) * _U(0x94D049BB133111EB)
    return z ^ (z >> _U(31))


def _randint(keys: np.ndarray, stream: int, lo: int, hi: int) -> np.ndarray:
    """Uniform integer in [lo, hi] keyed by row id (inclusive)."""
    return (_h64(keys, stream) % _U(hi - lo + 1)).astype(np.int64) + lo


def _uniform(keys: np.ndarray, stream: int) -> np.ndarray:
    return (_h64(keys, stream) >> _U(11)).astype(np.float64) / float(1 << 53)


def _days(y: int, m: int, d: int) -> int:
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


_START = _days(1992, 1, 1)          # first orderdate
_END_ORDER = _days(1998, 8, 2)      # last orderdate (spec: 1998-12-31 - 151d)
_CUTOFF = _days(1995, 6, 17)        # currentdate for flags/status

# official nation list: (name, regionkey)
_NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
_SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
_INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
_TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
_TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
_TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
_CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
_CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
_COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "indian", "ivory", "khaki", "lace", "lavender", "lawn", "lemon",
    "light", "lime", "linen", "magenta", "maroon", "medium", "metallic", "midnight",
    "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange", "orchid",
    "pale", "papaya", "peach", "peru", "pink", "plum", "powder", "puff",
    "purple", "red", "rose", "rosy", "royal", "saddle", "salmon", "sandy",
    "seashell", "sienna", "sky", "slate", "smoke", "snow", "spring", "steel",
    "tan", "thistle", "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]
_COMMENT_WORDS = [
    "carefully", "quickly", "furiously", "slyly", "blithely", "ironic",
    "final", "pending", "regular", "express", "bold", "even", "special",
    "silent", "unusual", "daring", "deposits", "requests", "packages",
    "instructions", "accounts", "foxes", "ideas", "theodolites", "pinto",
    "beans", "platelets", "asymptotes", "dependencies", "excuses", "sleep",
    "haggle", "nag", "wake", "cajole", "integrate", "detect", "among", "above",
]

_TABLES = ("region", "nation", "supplier", "customer", "part", "partsupp",
           "orders", "lineitem")


def _fmt_keyed(prefix: str, keys: np.ndarray, width: int = 9) -> np.ndarray:
    """'Prefix#000000001'-style vocabulary; zero-padding keeps lexical order ==
    numeric order, so these columns sort correctly as dictionary codes."""
    return np.array([f"{prefix}#{k:0{width}d}" for k in keys], dtype=object)


def _phones(nationkeys: np.ndarray, keys: np.ndarray) -> np.ndarray:
    a = _randint(keys, 101, 100, 999)
    b = _randint(keys, 102, 100, 999)
    c = _randint(keys, 103, 1000, 9999)
    codes = nationkeys + 10
    return np.array(
        [f"{cc}-{x}-{y}-{z}" for cc, x, y, z in zip(codes, a, b, c)], dtype=object
    )


def _retail_price_cents(pk):
    """Official spec formula (4.2.3): (90000 + pk/10 % 20001 + 100*(pk%1000)),
    on int64 partkeys (a numpy array or a torch tensor)."""
    return 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)


def _ps_suppkey(partkey, j, supp_count: int):
    """Supplier j (0..3) of a part — the spec's alignment formula so that
    lineitem (partkey, suppkey) pairs always exist in partsupp (Q9); int64
    numpy arrays or torch tensors."""
    pk = partkey - 1
    s = supp_count
    return 1 + (pk + j * (s // 4 + pk // s)) % s


# --------------------------------------------------------------------------
# per-order lineitem derivation (shared by orders and lineitem generators)


def _lines_per_order(orderkeys: np.ndarray) -> np.ndarray:
    return _randint(orderkeys, 11, 1, 7)


def _line_fields(okeys: np.ndarray, lineno: np.ndarray, orderdates: np.ndarray,
                 part_count: int, supp_count: int) -> dict[str, np.ndarray]:
    """Vectorized per-lineitem values keyed by (orderkey, linenumber)."""
    k = okeys.astype(np.uint64) * _U(8) + lineno.astype(np.uint64)
    return _line_values(k, orderdates, part_count, supp_count, _randint)


def _line_values(k, orderdates, part_count: int, supp_count: int,
                 randint) -> dict:
    """Per-lineitem values from the line key k = orderkey * 8 + linenumber.
    ``randint`` is the numpy version (uint64 keys) or the torch one (the
    same bits in int64, :func:`_randint_t`); both give the same values."""
    quantity = randint(k, 21, 1, 50)
    partkey = randint(k, 22, 1, part_count)
    suppkey = _ps_suppkey(partkey, randint(k, 23, 0, 3), supp_count)
    discount = randint(k, 24, 0, 10)  # cents: 0.00 - 0.10
    tax = randint(k, 25, 0, 8)
    extprice = quantity * _retail_price_cents(partkey)
    shipdate = orderdates + randint(k, 26, 1, 121)
    commitdate = orderdates + randint(k, 27, 30, 90)
    receiptdate = shipdate + randint(k, 28, 1, 30)
    return dict(
        quantity=quantity, partkey=partkey, suppkey=suppkey,
        discount=discount, tax=tax, extprice=extprice,
        shipdate=shipdate, commitdate=commitdate, receiptdate=receiptdate,
    )


# --------------------------------------------------------------------------


@dataclass(frozen=True)
class _TableDef:
    name: str
    schema: TableSchema
    base_rows: int  # rows at SF=1 (0 = fixed-size table or derived)


def _schema(name: str, cols: list[tuple[str, Type]]) -> TableSchema:
    return TableSchema(name, tuple(ColumnSchema(n, t) for n, t in cols))


_DEC = DecimalType(15, 2)

SCHEMAS: dict[str, TableSchema] = {
    "region": _schema("region", [
        ("r_regionkey", BIGINT), ("r_name", VARCHAR), ("r_comment", VARCHAR)]),
    "nation": _schema("nation", [
        ("n_nationkey", BIGINT), ("n_name", VARCHAR),
        ("n_regionkey", BIGINT), ("n_comment", VARCHAR)]),
    "supplier": _schema("supplier", [
        ("s_suppkey", BIGINT), ("s_name", VARCHAR), ("s_address", VARCHAR),
        ("s_nationkey", BIGINT), ("s_phone", VARCHAR), ("s_acctbal", _DEC),
        ("s_comment", VARCHAR)]),
    "customer": _schema("customer", [
        ("c_custkey", BIGINT), ("c_name", VARCHAR), ("c_address", VARCHAR),
        ("c_nationkey", BIGINT), ("c_phone", VARCHAR), ("c_acctbal", _DEC),
        ("c_mktsegment", VARCHAR), ("c_comment", VARCHAR)]),
    "part": _schema("part", [
        ("p_partkey", BIGINT), ("p_name", VARCHAR), ("p_mfgr", VARCHAR),
        ("p_brand", VARCHAR), ("p_type", VARCHAR), ("p_size", BIGINT),
        ("p_container", VARCHAR), ("p_retailprice", _DEC), ("p_comment", VARCHAR)]),
    "partsupp": _schema("partsupp", [
        ("ps_partkey", BIGINT), ("ps_suppkey", BIGINT),
        ("ps_availqty", BIGINT), ("ps_supplycost", _DEC), ("ps_comment", VARCHAR)]),
    "orders": _schema("orders", [
        ("o_orderkey", BIGINT), ("o_custkey", BIGINT), ("o_orderstatus", VARCHAR),
        ("o_totalprice", _DEC), ("o_orderdate", DATE), ("o_orderpriority", VARCHAR),
        ("o_clerk", VARCHAR), ("o_shippriority", BIGINT), ("o_comment", VARCHAR)]),
    "lineitem": _schema("lineitem", [
        ("l_orderkey", BIGINT), ("l_partkey", BIGINT), ("l_suppkey", BIGINT),
        ("l_linenumber", BIGINT), ("l_quantity", _DEC), ("l_extendedprice", _DEC),
        ("l_discount", _DEC), ("l_tax", _DEC), ("l_returnflag", VARCHAR),
        ("l_linestatus", VARCHAR), ("l_shipdate", DATE), ("l_commitdate", DATE),
        ("l_receiptdate", DATE), ("l_shipinstruct", VARCHAR),
        ("l_shipmode", VARCHAR), ("l_comment", VARCHAR)]),
}

_BASE_ROWS = {
    "region": 5, "nation": 25, "supplier": 10_000, "customer": 150_000,
    "part": 200_000, "partsupp": 800_000, "orders": 1_500_000,
}


class TpchConnector(Connector):
    name = "tpch"

    def __init__(self, scale_factor: float = 0.01, batch_rows: int = 262_144):
        self.sf = scale_factor
        self.batch_rows = batch_rows
        self._dict_cache: dict[tuple[str, str], np.ndarray] = {}
        # scans' prefetch threads generate concurrently: one thread builds
        # a global dictionary while the others wait for it, and only that
        # thread's own generation encodes locally (per-thread set)
        self._dict_lock = threading.RLock()
        self._local = threading.local()
        # vocab index -> sorted-dictionary code, per string column (the host
        # twin of the reference device generator): batch decode becomes ONE
        # integer gather instead of materializing python strings and binary-
        # searching an object array per row (GIL-bound, ~75% of decode time)
        self._code_tables: dict[tuple[str, str], tuple] = {}
        self._lineitem_rows: dict[float, int] = {}  # scale factor -> rows

    def data_version(self, table: str):
        """Generated data is a pure function of the scale factor: a
        constant token makes repeated TPC-H reads result-cacheable
        forever within one configuration."""
        if table not in _TABLES:
            raise KeyError(f"tpch: no such table {table!r}")
        return f"sf={self.sf}"

    # ---- sizes ----------------------------------------------------------
    def row_count(self, table: str) -> int:
        if table in ("region", "nation"):
            return _BASE_ROWS[table]
        if table == "lineitem":
            # derived: sum of per-order line counts (exact; chunked to bound
            # temporary memory at large SF).  It hashes every orderkey, and
            # every statistics call of the planner asks for it, so it is
            # computed once per scale factor
            total = self._lineitem_rows.get(self.sf)
            if total is None:
                n_orders = self.row_count("orders")
                total = 0
                for a in range(0, n_orders, 4_000_000):
                    b = min(a + 4_000_000, n_orders)
                    total += int(_lines_per_order(self._orderkeys(a, b)).sum())
                self._lineitem_rows[self.sf] = total
            return total
        return max(1, int(_BASE_ROWS[table] * self.sf))

    def _orderkeys(self, start: int, stop: int) -> np.ndarray:
        return np.arange(start + 1, stop + 1, dtype=np.uint64)

    # ---- metadata -------------------------------------------------------
    def list_tables(self) -> list[str]:
        return list(_TABLES)

    def get_table_schema(self, table: str) -> TableSchema:
        if table not in SCHEMAS:
            raise KeyError(f"tpch: no such table {table!r}")
        return SCHEMAS[table]

    def get_table_statistics(self, table: str) -> TableStatistics:
        analyzed = getattr(self, "_analyzed_stats", {}).get(table)
        if analyzed is not None:
            return analyzed
        n = self.row_count(table)
        ndv: dict[str, float] = {}
        for c in SCHEMAS[table].columns:
            if c.name.endswith("key") and c.name[2:] != "shippriority":
                ndv[c.name] = float(n)
        for col, v in {
            "l_returnflag": 3, "l_linestatus": 2, "l_shipmode": 7,
            "o_orderpriority": 5, "c_mktsegment": 5, "n_name": 25,
            "r_name": 5, "p_brand": 25, "p_type": 150, "p_container": 40,
            "p_size": 50,
        }.items():
            if any(c.name == col for c in SCHEMAS[table].columns):
                ndv[col] = float(v)
        return TableStatistics(row_count=float(n), ndv=ndv)

    # ---- splits ---------------------------------------------------------
    def get_splits(self, table: str, splits_per_node: int, node_count: int) -> list[Split]:
        # lineitem splits range over *orders* so whole orders stay together
        n = self.row_count("orders" if table == "lineitem" else table)
        want = max(1, splits_per_node * node_count)
        n_splits = min(want, max(1, n // 4096)) if n > 8192 else 1
        bounds = np.linspace(0, n, n_splits + 1, dtype=np.int64)
        return [
            Split("tpch", table, (int(bounds[i]), int(bounds[i + 1])),
                  weight=float(bounds[i + 1] - bounds[i]))
            for i in range(n_splits)
            if bounds[i + 1] > bounds[i]
        ]

    def create_page_source(self, split: Split, columns: Sequence[str],
                           constraint=None) -> "_TpchPageSource":
        return _TpchPageSource(self, split, list(columns))

    # ---- dictionaries ---------------------------------------------------
    def column_dictionary(self, table: str, column: str) -> Optional[np.ndarray]:
        """Table-global sorted dictionary for a varchar column (cached)."""
        t = SCHEMAS[table].column_type(column)
        if not t.is_dictionary_encoded:
            return None
        key = (table, column)
        if key in self._dict_cache:
            return self._dict_cache[key]
        with self._dict_lock:
            if key not in self._dict_cache:
                building = self._building
                building.add(key)
                try:
                    values = self._string_values(table, column)
                finally:
                    building.discard(key)
                self._dict_cache[key] = np.unique(values)
        return self._dict_cache[key]

    @property
    def _building(self) -> set:
        """The dictionaries this thread is building."""
        b = getattr(self._local, "building", None)
        if b is None:
            b = self._local.building = set()
        return b

    # ---- generation -----------------------------------------------------
    def _string_values(self, table: str, column: str) -> np.ndarray:
        """The distinct values of a string column (unsorted) — used to
        build the global dictionary.  Bounded vocabularies return the vocab
        directly."""
        fixed = {
            ("region", "r_name"): np.array(_REGIONS, object),
            ("nation", "n_name"): np.array([n for n, _ in _NATIONS], object),
            ("customer", "c_mktsegment"): np.array(_SEGMENTS, object),
            ("orders", "o_orderpriority"): np.array(_PRIORITIES, object),
            ("orders", "o_orderstatus"): np.array(["F", "O", "P"], object),
            ("lineitem", "l_shipmode"): np.array(_SHIPMODES, object),
            ("lineitem", "l_shipinstruct"): np.array(_INSTRUCTIONS, object),
            ("lineitem", "l_returnflag"): np.array(["A", "N", "R"], object),
            ("lineitem", "l_linestatus"): np.array(["F", "O"], object),
            ("part", "p_mfgr"): np.array(
                [f"Manufacturer#{i}" for i in range(1, 6)], object),
            ("part", "p_brand"): np.array(
                [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)], object),
            ("part", "p_type"): np.array(
                [f"{a} {b} {c}" for a in _TYPE_S1 for b in _TYPE_S2 for c in _TYPE_S3],
                object),
            ("part", "p_container"): np.array(
                [f"{a} {b}" for a in _CONTAINER_S1 for b in _CONTAINER_S2], object),
        }
        if (table, column) in fixed:
            return fixed[(table, column)]
        n = self.row_count(table)
        keys = np.arange(1, n + 1, dtype=np.uint64)
        batch = self._generate(table, [column], 0, n)
        # _generate returns dictionary-coded columns: the entries of its
        # dictionary that occur (no string per row)
        col = batch.column(column)
        return col.dictionary[np.unique(col.data.numpy())]

    def _dict_column(self, table: str, column: str, values: np.ndarray) -> Column:
        if (table, column) in self._building:
            # global dictionary under construction: local encoding suffices
            d, codes = np.unique(values, return_inverse=True)
            return Column(VARCHAR, codes.astype(np.int32), None, d)
        d = self.column_dictionary(table, column)
        codes = np.searchsorted(d, values).astype(np.int32)
        return Column(VARCHAR, codes, None, d)

    def _code_table(self, table: str, column: str, vocab) -> tuple:
        """(vocab-index -> code table, sorted dictionary), cached.  The
        dictionary is the DATA-derived one from column_dictionary — identical
        to the legacy decode, so small tables keep small dictionaries (nation
        comments: 25 entries, not the 59k vocab — dictionary-space ops like
        `||` depend on that).  Vocab entries absent from the data clip to an
        arbitrary valid code; by construction they never occur."""
        key = (table, column)
        cached = self._code_tables.get(key)
        if cached is None:
            values = np.asarray(vocab, dtype=object)
            d = self.column_dictionary(table, column)
            tab = np.searchsorted(d, values).astype(np.int32)
            np.clip(tab, 0, len(d) - 1, out=tab)
            cached = (tab, d)
            self._code_tables[key] = cached
        return cached

    def _vocab_column(self, table: str, column: str, idx: np.ndarray,
                      vocab: list[str]) -> Column:
        if (table, column) in self._building:
            values = np.array(vocab, dtype=object)[np.asarray(idx, np.int64)]
            return self._dict_column(table, column, values)
        tab, d = self._code_table(table, column, vocab)
        return Column(VARCHAR, tab[np.asarray(idx, dtype=np.int64)], None, d)

    def _comment_column(self, table: str, column: str, keys: np.ndarray,
                        stream: int, phrase=None, phrase_ppm: int = 0) -> Column:
        """Comment column without materializing strings: the same splitmix
        index arithmetic as _device_comment_codes, mapped through the cached
        code table over _comment_vocab (pure ufunc work — releases the GIL,
        so prefetch threads genuinely parallelize the decode)."""
        w = len(_COMMENT_WORDS)
        keys = keys.astype(np.uint64)
        i1 = (_h64(keys, stream * 7 + 1) % _U(w)).astype(np.int64)
        i2 = (_h64(keys, stream * 7 + 2) % _U(w)).astype(np.int64)
        i3 = (_h64(keys, stream * 7 + 3) % _U(w)).astype(np.int64)
        idx = (i1 * w + i2) * w + i3
        if phrase and phrase_ppm:
            hit = (_h64(keys, stream * 7 + 4) % _U(1_000_000)) < _U(phrase_ppm)
            idx = np.where(hit, w * w * w + i1, idx)
        if (table, column) in self._building:
            # the global dictionary under construction: a local one over
            # the vocabulary entries that occur, found on their indices
            # (no string per row)
            uniq, inv = np.unique(idx, return_inverse=True)
            d, codes = np.unique(_comment_vocab(phrase)[uniq],
                                 return_inverse=True)
            return Column(VARCHAR, codes.astype(np.int32)[inv], None, d)
        tab, d = self._code_table(table, column, _comment_vocab(phrase))
        return Column(VARCHAR, tab[idx], None, d)

    def _generate(self, table: str, columns: list[str], start: int, stop: int) -> ColumnBatch:
        gen = getattr(self, f"_gen_{table}")
        return gen(columns, start, stop)

    # region/nation -------------------------------------------------------
    def _gen_region(self, columns, start, stop):
        keys = np.arange(start, stop, dtype=np.int64)
        out = []
        for c in columns:
            if c == "r_regionkey":
                out.append(Column(BIGINT, keys))
            elif c == "r_name":
                out.append(self._vocab_column("region", "r_name", keys, _REGIONS))
            else:
                out.append(self._comment_column("region", "r_comment",
                                                 keys.astype(np.uint64), 1))
        return ColumnBatch(list(columns), out)

    def _gen_nation(self, columns, start, stop):
        keys = np.arange(start, stop, dtype=np.int64)
        out = []
        for c in columns:
            if c == "n_nationkey":
                out.append(Column(BIGINT, keys))
            elif c == "n_name":
                out.append(self._vocab_column(
                    "nation", "n_name", keys, [n for n, _ in _NATIONS]))
            elif c == "n_regionkey":
                out.append(Column(BIGINT, np.array(
                    [_NATIONS[k][1] for k in keys], dtype=np.int64)))
            else:
                out.append(self._comment_column("nation", "n_comment",
                                                 keys.astype(np.uint64), 2))
        return ColumnBatch(list(columns), out)

    # supplier ------------------------------------------------------------
    def _gen_supplier(self, columns, start, stop):
        keys = np.arange(start + 1, stop + 1, dtype=np.uint64)
        ik = keys.astype(np.int64)
        nk = _randint(keys, 31, 0, 24)
        out = []
        for c in columns:
            if c == "s_suppkey":
                out.append(Column(BIGINT, ik))
            elif c == "s_name":
                out.append(self._dict_column("supplier", "s_name",
                                             _fmt_keyed("Supplier", ik)))
            elif c == "s_address":
                out.append(self._dict_column("supplier", "s_address",
                                             _fmt_keyed("SAddr", ik)))
            elif c == "s_nationkey":
                out.append(Column(BIGINT, nk))
            elif c == "s_phone":
                out.append(self._dict_column("supplier", "s_phone", _phones(nk, keys)))
            elif c == "s_acctbal":
                out.append(Column(_DEC, _randint(keys, 32, -99999, 999999)))
            else:  # s_comment — 'Customer Complaints' at ~5 per 10k (Q16)
                out.append(self._comment_column(
                    "supplier", "s_comment", keys, 3,
                    "Customer foo Complaints", 500))
        return ColumnBatch(list(columns), out)

    # customer ------------------------------------------------------------
    def _gen_customer(self, columns, start, stop):
        keys = np.arange(start + 1, stop + 1, dtype=np.uint64)
        ik = keys.astype(np.int64)
        nk = _randint(keys, 41, 0, 24)
        out = []
        for c in columns:
            if c == "c_custkey":
                out.append(Column(BIGINT, ik))
            elif c == "c_name":
                out.append(self._dict_column("customer", "c_name",
                                             _fmt_keyed("Customer", ik)))
            elif c == "c_address":
                out.append(self._dict_column("customer", "c_address",
                                             _fmt_keyed("CAddr", ik)))
            elif c == "c_nationkey":
                out.append(Column(BIGINT, nk))
            elif c == "c_phone":
                out.append(self._dict_column("customer", "c_phone", _phones(nk, keys)))
            elif c == "c_acctbal":
                out.append(Column(_DEC, _randint(keys, 42, -99999, 999999)))
            elif c == "c_mktsegment":
                out.append(self._vocab_column("customer", "c_mktsegment",
                                              _randint(keys, 43, 0, 4), _SEGMENTS))
            else:
                out.append(self._comment_column("customer", "c_comment",
                                                 keys, 4))
        return ColumnBatch(list(columns), out)

    # part ----------------------------------------------------------------
    def _gen_part(self, columns, start, stop):
        keys = np.arange(start + 1, stop + 1, dtype=np.uint64)
        ik = keys.astype(np.int64)
        out = []
        mfgr = _randint(keys, 51, 1, 5)
        for c in columns:
            if c == "p_partkey":
                out.append(Column(BIGINT, ik))
            elif c == "p_name":
                w = len(_COLORS)
                i1 = _h64(keys, 52) % _U(w)
                i2 = _h64(keys, 53) % _U(w)
                i3 = _h64(keys, 54) % _U(w)
                names = np.array(
                    [f"{_COLORS[a]} {_COLORS[b]} {_COLORS[c2]}"
                     for a, b, c2 in zip(i1, i2, i3)], dtype=object)
                out.append(self._dict_column("part", "p_name", names))
            elif c == "p_mfgr":
                out.append(self._dict_column(
                    "part", "p_mfgr",
                    np.array([f"Manufacturer#{m}" for m in mfgr], object)))
            elif c == "p_brand":
                b2 = _randint(keys, 55, 1, 5)
                out.append(self._dict_column(
                    "part", "p_brand",
                    np.array([f"Brand#{m}{b}" for m, b in zip(mfgr, b2)], object)))
            elif c == "p_type":
                idx = _randint(keys, 56, 0, 149)
                vocab = [f"{a} {b} {c2}" for a in _TYPE_S1 for b in _TYPE_S2
                         for c2 in _TYPE_S3]
                out.append(self._vocab_column("part", "p_type", idx, vocab))
            elif c == "p_size":
                out.append(Column(BIGINT, _randint(keys, 57, 1, 50)))
            elif c == "p_container":
                idx = _randint(keys, 58, 0, 39)
                vocab = [f"{a} {b}" for a in _CONTAINER_S1 for b in _CONTAINER_S2]
                out.append(self._vocab_column("part", "p_container", idx, vocab))
            elif c == "p_retailprice":
                out.append(Column(_DEC, _retail_price_cents(ik)))
            else:
                out.append(self._comment_column("part", "p_comment", keys, 5))
        return ColumnBatch(list(columns), out)

    # partsupp ------------------------------------------------------------
    def _gen_partsupp(self, columns, start, stop):
        # row i -> (partkey = i//4 + 1, j = i%4)
        idx = np.arange(start, stop, dtype=np.int64)
        partkey = idx // 4 + 1
        j = idx % 4
        keys = idx.astype(np.uint64) + _U(1)
        supp_count = self.row_count("supplier")
        out = []
        for c in columns:
            if c == "ps_partkey":
                out.append(Column(BIGINT, partkey))
            elif c == "ps_suppkey":
                out.append(Column(BIGINT, _ps_suppkey(partkey, j, supp_count)))
            elif c == "ps_availqty":
                out.append(Column(BIGINT, _randint(keys, 61, 1, 9999)))
            elif c == "ps_supplycost":
                out.append(Column(_DEC, _randint(keys, 62, 100, 100000)))
            else:
                out.append(self._comment_column("partsupp", "ps_comment",
                                                 keys, 6))
        return ColumnBatch(list(columns), out)

    # orders --------------------------------------------------------------
    def _custkey_for_order(self, okeys: np.ndarray) -> np.ndarray:
        """Customers with custkey % 3 == 0 never order (Q13/Q22 shape)."""
        ncust = self.row_count("customer")
        eligible = ncust - ncust // 3
        r = _randint(okeys, 71, 0, max(eligible - 1, 0))
        # map 0..eligible-1 -> keys skipping multiples of 3: 1,2,4,5,7,8,...
        return (r // 2) * 3 + (r % 2) + 1

    def _order_lineitem_stats(self, okeys, orderdates):
        """(totalprice_cents, orderstatus codes) consistent with lineitems."""
        nlines = _lines_per_order(okeys)
        total = np.zeros(len(okeys), dtype=np.int64)
        all_f = np.ones(len(okeys), dtype=bool)
        all_o = np.ones(len(okeys), dtype=bool)
        for ln in range(1, 8):
            mask = nlines >= ln
            f = _line_fields(okeys, np.full(len(okeys), ln, np.uint64),
                             orderdates, self.row_count("part"),
                             self.row_count("supplier"))
            # charge = extprice * (1 - disc) * (1 + tax), rounded to cents
            charge = f["extprice"] * (100 - f["discount"]) * (100 + f["tax"])
            charge = (charge + 5000) // 10000
            total += np.where(mask, charge, 0)
            shipped = f["shipdate"] <= _CUTOFF
            all_f &= ~mask | shipped
            all_o &= ~mask | ~shipped
        status = np.where(all_f, 0, np.where(all_o, 1, 2))  # F / O / P
        return total, status

    def _gen_orders(self, columns, start, stop):
        okeys = self._orderkeys(start, stop)
        ik = okeys.astype(np.int64)
        orderdates = _randint(okeys, 72, _START, _END_ORDER)
        out = []
        total = status = None
        if "o_totalprice" in columns or "o_orderstatus" in columns:
            total, status = self._order_lineitem_stats(okeys, orderdates)
        for c in columns:
            if c == "o_orderkey":
                out.append(Column(BIGINT, ik))
            elif c == "o_custkey":
                out.append(Column(BIGINT, self._custkey_for_order(okeys)))
            elif c == "o_orderstatus":
                out.append(self._vocab_column("orders", "o_orderstatus",
                                              status, ["F", "O", "P"]))
            elif c == "o_totalprice":
                out.append(Column(_DEC, total))
            elif c == "o_orderdate":
                out.append(Column(DATE, orderdates.astype(np.int32)))
            elif c == "o_orderpriority":
                out.append(self._vocab_column("orders", "o_orderpriority",
                                              _randint(okeys, 73, 0, 4), _PRIORITIES))
            elif c == "o_clerk":
                clerks = _randint(okeys, 74, 1, max(1, int(1000 * self.sf)))
                out.append(self._dict_column("orders", "o_clerk",
                                             _fmt_keyed("Clerk", clerks)))
            elif c == "o_shippriority":
                out.append(Column(BIGINT, np.zeros(len(ik), dtype=np.int64)))
            else:  # o_comment — 'special ... requests' ~1.3% (Q13)
                out.append(self._comment_column(
                    "orders", "o_comment", okeys, 8,
                    "special foo requests", 13000))
        return ColumnBatch(list(columns), out)

    # lineitem ------------------------------------------------------------
    def _gen_lineitem(self, columns, start, stop):
        """start/stop are ORDER indices; emits all lineitems of those orders."""
        okeys1 = self._orderkeys(start, stop)
        nlines = _lines_per_order(okeys1)
        okeys = np.repeat(okeys1, nlines)
        # linenumbers 1..n per order
        lineno = (np.arange(len(okeys), dtype=np.int64)
                  - np.repeat(np.cumsum(nlines) - nlines, nlines) + 1).astype(np.uint64)
        orderdates = np.repeat(_randint(okeys1, 72, _START, _END_ORDER), nlines)
        f = _line_fields(okeys, lineno, orderdates,
                         self.row_count("part"), self.row_count("supplier"))
        k = okeys * _U(8) + lineno
        out = []
        for c in columns:
            if c == "l_orderkey":
                out.append(Column(BIGINT, okeys.astype(np.int64)))
            elif c == "l_partkey":
                out.append(Column(BIGINT, f["partkey"]))
            elif c == "l_suppkey":
                out.append(Column(BIGINT, f["suppkey"]))
            elif c == "l_linenumber":
                out.append(Column(BIGINT, lineno.astype(np.int64)))
            elif c == "l_quantity":
                out.append(Column(_DEC, f["quantity"] * 100))
            elif c == "l_extendedprice":
                out.append(Column(_DEC, f["extprice"]))
            elif c == "l_discount":
                out.append(Column(_DEC, f["discount"]))
            elif c == "l_tax":
                out.append(Column(_DEC, f["tax"]))
            elif c == "l_returnflag":
                returned = f["receiptdate"] <= _CUTOFF
                ra = _randint(k, 29, 0, 1)  # A or R when returned
                idx = np.where(returned, np.where(ra == 0, 0, 2), 1)  # A/N/R sorted
                out.append(self._vocab_column("lineitem", "l_returnflag", idx,
                                              ["A", "N", "R"]))
            elif c == "l_linestatus":
                idx = (f["shipdate"] > _CUTOFF).astype(np.int64)  # F=0, O=1
                out.append(self._vocab_column("lineitem", "l_linestatus", idx,
                                              ["F", "O"]))
            elif c == "l_shipdate":
                out.append(Column(DATE, f["shipdate"].astype(np.int32)))
            elif c == "l_commitdate":
                out.append(Column(DATE, f["commitdate"].astype(np.int32)))
            elif c == "l_receiptdate":
                out.append(Column(DATE, f["receiptdate"].astype(np.int32)))
            elif c == "l_shipinstruct":
                out.append(self._vocab_column("lineitem", "l_shipinstruct",
                                              _randint(k, 30, 0, 3), _INSTRUCTIONS))
            elif c == "l_shipmode":
                out.append(self._vocab_column("lineitem", "l_shipmode",
                                              _randint(k, 31, 0, 6), _SHIPMODES))
            else:
                out.append(self._comment_column("lineitem", "l_comment",
                                                 k, 9))
        return ColumnBatch(list(columns), out)


def _comment_vocab(phrase: Optional[str] = None) -> np.ndarray:
    """Unsorted comment vocabulary: index a*w*w + b*w + c for the normal
    3-word template, then w**3 + a for the phrase variants."""
    w = len(_COMMENT_WORDS)
    base = [f"{_COMMENT_WORDS[a]} {_COMMENT_WORDS[b]} {_COMMENT_WORDS[c]}"
            for a in range(w) for b in range(w) for c in range(w)]
    if phrase:
        base += [f"{_COMMENT_WORDS[a]} {phrase}" for a in range(w)]
    return np.array(base, dtype=object)


# --------------------------------------------------------------------------
# device-side generation (the staging path)
#
# Every value above is a pure integer function of the row key, so the two
# large tables can be generated on the card: the splitmix64 arithmetic runs
# as torch ops on an explicit device and the columns are born in device
# memory.  Only the string dictionaries (host numpy, at most ~59 k entries)
# are made on the host.  The reference does the same with one jitted
# program (its _DeviceTpchGen), to stage warmed tables for its benchmark.
#
# torch has few uint64 operations, so a uint64 value is held as the same
# 64 bits in int64: add and multiply wrap mod 2**64 alike, a logical shift
# masks off the sign bits an arithmetic shift copies in, and an unsigned
# modulo halves the value first so that every operand is non-negative.

_MASK64 = (1 << 64) - 1


def _s64(u: int) -> int:
    """The int64 holding the bits of a uint64 python int (mod 2**64)."""
    u &= _MASK64
    return u - (1 << 64) if u >= 1 << 63 else u


_SPLITMIX_M1 = _s64(0xBF58476D1CE4E5B9)
_SPLITMIX_M2 = _s64(0x94D049BB133111EB)


def _shr_t(z, s: int):
    """Logical right shift of uint64 bits held in an int64 tensor."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _h64_t(x, stream: int):
    """:func:`_h64` on an int64 tensor holding uint64 bits (same bits)."""
    z = x + _s64(0x9E3779B97F4A7C15 * (stream * 2 + 1))
    z = (z ^ _shr_t(z, 30)) * _SPLITMIX_M1
    z = (z ^ _shr_t(z, 27)) * _SPLITMIX_M2
    return z ^ _shr_t(z, 31)


def _umod_t(z, m: int):
    """Unsigned ``z % m`` of uint64 bits held in int64, for 0 < m < 2**62:
    u = 2 * (u >> 1) + (u & 1), and every intermediate stays below 2**63."""
    return ((_shr_t(z, 1) % m) * 2 + (z & 1)) % m


def _randint_t(keys, stream: int, lo: int, hi: int):
    """:func:`_randint` on an int64 tensor of keys (same values)."""
    return _umod_t(_h64_t(keys, stream), hi - lo + 1) + lo


def _comment_codes_t(keys, stream: int, phrase: Optional[str],
                     phrase_ppm: int):
    """Index into the unsorted ``_comment_vocab(phrase)`` per row (the
    arithmetic of TpchConnector._comment_column)."""
    w = len(_COMMENT_WORDS)
    i1 = _umod_t(_h64_t(keys, stream * 7 + 1), w)
    i2 = _umod_t(_h64_t(keys, stream * 7 + 2), w)
    i3 = _umod_t(_h64_t(keys, stream * 7 + 3), w)
    idx = (i1 * w + i2) * w + i3
    if phrase and phrase_ppm:
        hit = _umod_t(_h64_t(keys, stream * 7 + 4), 1_000_000) < phrase_ppm
        idx = torch.where(hit, w * w * w + i1, idx)
    return idx


def _order_stats_t(okeys, orderdates, npart: int, nsupp: int):
    """TpchConnector._order_lineitem_stats on int64 tensors."""
    nlines = _randint_t(okeys, 11, 1, 7)
    total = torch.zeros_like(okeys)
    all_f = torch.ones(okeys.shape, dtype=torch.bool, device=okeys.device)
    all_o = all_f.clone()
    for ln in range(1, 8):
        mask = nlines >= ln
        f = _line_values(okeys * 8 + ln, orderdates, npart, nsupp,
                         _randint_t)
        charge = f["extprice"] * (100 - f["discount"]) * (100 + f["tax"])
        charge = (charge + 5000) // 10000
        total += torch.where(mask, charge, 0)
        shipped = f["shipdate"] <= _CUTOFF
        all_f &= ~mask | shipped
        all_o &= ~mask | ~shipped
    status = torch.where(all_f, 0, torch.where(all_o, 1, 2))
    return total, status


class _DeviceTpchGen:
    """Generates whole orders / lineitem tables on one device.

    The columns' string dictionaries are the reference generator's: the
    full sorted vocabulary of each column, not the data-derived dictionary
    the host path builds (TpchConnector.column_dictionary).  Unlike the
    reference, the generator does not write them into the connector's
    dictionary cache: the host path keeps its own dictionaries, so a host
    scan gives the same codes before and after staging.  Both decode to the
    same strings."""

    def __init__(self, conn: "TpchConnector", device: torch.device):
        self.conn = conn
        self.device = device

    def _vocab(self, vocab, idx) -> tuple:
        """Codes in the sorted vocabulary for vocab indices ``idx``, and
        that dictionary."""
        values = np.asarray(vocab, dtype=object)
        d = np.unique(values)
        tab = torch.as_tensor(np.searchsorted(d, values).astype(np.int32),
                              device=self.device)
        return tab[idx], d

    def generate(self, table: str, columns: Sequence[str]) -> ColumnBatch:
        gen = self._gen_orders if table == "orders" else self._gen_lineitem
        out = gen(list(columns))
        # out: column -> (data, dictionary or None)
        return ColumnBatch(list(columns), [
            Column(SCHEMAS[table].column_type(c), out[c][0], None, out[c][1])
            for c in columns])

    def _gen_orders(self, columns: list[str]) -> dict:
        conn = self.conn
        n = conn.row_count("orders")
        okeys = torch.arange(1, n + 1, dtype=torch.int64, device=self.device)
        orderdates = _randint_t(okeys, 72, _START, _END_ORDER)
        total = status = None
        if "o_totalprice" in columns or "o_orderstatus" in columns:
            total, status = _order_stats_t(
                okeys, orderdates, conn.row_count("part"),
                conn.row_count("supplier"))
        out = {}
        for c in columns:
            if c == "o_orderkey":
                out[c] = (okeys, None)
            elif c == "o_custkey":
                ncust = conn.row_count("customer")
                r = _randint_t(okeys, 71, 0, max(ncust - ncust // 3 - 1, 0))
                out[c] = ((r // 2) * 3 + (r % 2) + 1, None)
            elif c == "o_orderstatus":
                out[c] = self._vocab(["F", "O", "P"], status)
            elif c == "o_totalprice":
                out[c] = (total, None)
            elif c == "o_orderdate":
                out[c] = (orderdates.to(torch.int32), None)
            elif c == "o_orderpriority":
                out[c] = self._vocab(_PRIORITIES,
                                     _randint_t(okeys, 73, 0, 4))
            elif c == "o_clerk":
                # 'Clerk#000000001'...: zero-padded, so already sorted
                max_clerk = max(1, int(1000 * conn.sf))
                codes = _randint_t(okeys, 74, 1, max_clerk) - 1
                out[c] = (codes.to(torch.int32),
                          _fmt_keyed("Clerk", np.arange(1, max_clerk + 1)))
            elif c == "o_shippriority":
                out[c] = (torch.zeros_like(okeys), None)
            else:  # o_comment
                phrase = "special foo requests"
                out[c] = self._vocab(
                    _comment_vocab(phrase),
                    _comment_codes_t(okeys, 8, phrase, 13000))
        return out

    def _gen_lineitem(self, columns: list[str]) -> dict:
        conn = self.conn
        n_orders = conn.row_count("orders")
        okeys1 = torch.arange(1, n_orders + 1, dtype=torch.int64,
                              device=self.device)
        nlines = _randint_t(okeys1, 11, 1, 7)
        ends = torch.cumsum(nlines, 0)
        total = int(ends[-1])  # == row_count("lineitem")
        okeys = torch.repeat_interleave(okeys1, nlines, output_size=total)
        lineno = (torch.arange(1, total + 1, device=self.device)
                  - torch.repeat_interleave(ends - nlines, nlines,
                                            output_size=total))
        orderdates = torch.repeat_interleave(
            _randint_t(okeys1, 72, _START, _END_ORDER), nlines,
            output_size=total)
        del okeys1, nlines, ends
        k = okeys * 8 + lineno
        f = _line_values(k, orderdates, conn.row_count("part"),
                         conn.row_count("supplier"), _randint_t)
        del orderdates
        out = {}
        for c in columns:
            if c == "l_orderkey":
                out[c] = (okeys, None)
            elif c == "l_partkey":
                out[c] = (f["partkey"], None)
            elif c == "l_suppkey":
                out[c] = (f["suppkey"], None)
            elif c == "l_linenumber":
                out[c] = (lineno, None)
            elif c == "l_quantity":
                out[c] = (f["quantity"] * 100, None)
            elif c == "l_extendedprice":
                out[c] = (f["extprice"], None)
            elif c == "l_discount":
                out[c] = (f["discount"], None)
            elif c == "l_tax":
                out[c] = (f["tax"], None)
            elif c == "l_returnflag":
                returned = f["receiptdate"] <= _CUTOFF
                ra = _randint_t(k, 29, 0, 1)  # A or R when returned
                idx = torch.where(returned, torch.where(ra == 0, 0, 2), 1)
                out[c] = self._vocab(["A", "N", "R"], idx)
            elif c == "l_linestatus":
                out[c] = self._vocab(
                    ["F", "O"], (f["shipdate"] > _CUTOFF).to(torch.int64))
            elif c in ("l_shipdate", "l_commitdate", "l_receiptdate"):
                out[c] = (f[c[2:]].to(torch.int32), None)
            elif c == "l_shipinstruct":
                out[c] = self._vocab(_INSTRUCTIONS, _randint_t(k, 30, 0, 3))
            elif c == "l_shipmode":
                out[c] = self._vocab(_SHIPMODES, _randint_t(k, 31, 0, 6))
            else:  # l_comment
                out[c] = self._vocab(_comment_vocab(),
                                     _comment_codes_t(k, 9, None, 0))
        return out


def generate_table_device(conn: "TpchConnector", table: str,
                          columns: Sequence[str],
                          device="cuda") -> Optional[ColumnBatch]:
    """The whole table generated on ``device`` (orders and lineitem; None
    for the other tables, which only the host generator makes).  Values are
    bit-identical to the host generator's, and the batch holds exactly
    ``conn.row_count(table)`` rows with no live mask.  ``device="cuda"``
    (the default) raises when CUDA is not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "generate_table_device(device='cuda'): CUDA is not available; "
            "pass device='cpu' to generate on the CPU")
    if table not in ("orders", "lineitem"):
        return None
    return _DeviceTpchGen(conn, dev).generate(table, columns)


class _TpchPageSource(ConnectorPageSource):
    def __init__(self, conn: TpchConnector, split: Split, columns: list[str]):
        self.conn = conn
        self.split = split
        self.columns = columns
        self.pos, self.stop = split.info
        # order-ranged tables produce ~4x rows per order
        divisor = 4 if split.table == "lineitem" else 1
        self.step = max(1, conn.batch_rows // max(divisor, 1))

    def get_next_batch(self) -> Optional[ColumnBatch]:
        if self.pos >= self.stop:
            return None
        stop = min(self.pos + self.step, self.stop)
        batch = self.conn._generate(self.split.table, self.columns, self.pos, stop)
        self.pos = stop
        return batch

    def is_finished(self) -> bool:
        return self.pos >= self.stop

"""Nested and wide columns over TPC-H: the table ``orders_nested`` and the
eleven queries N1-N11.

Lake tables carry arrays of tags and of foreign keys, property maps,
struct columns, JSON payloads in varchar and decimal(38) amounts; CROSS
JOIN UNNEST is how such tables meet ordinary joins and group-bys.
``orders_nested`` has one row per TPC-H order, derived from the staged
``orders``, ``lineitem`` and ``customer`` tables with no randomness:

- ``o_orderkey``, ``o_custkey``, ``o_orderstatus``: from ``orders``;
- ``o_partkeys array(bigint)``: the order's ``l_partkey`` in
  ``l_linenumber`` order (1-7 elements);
- ``o_shipmodes array(varchar)``: the order's ``l_shipmode``, same order;
- ``o_returned array(varchar)``: ``l_shipmode`` of the lines with
  ``l_returnflag = 'R'`` (empty for most orders);
- ``o_flags map(varchar, bigint)``: ``l_returnflag`` -> number of the
  order's lines with it;
- ``o_cust row(nationkey bigint, segment varchar)``: the customer's
  ``c_nationkey`` and ``c_mktsegment``;
- ``o_amount decimal(38,18)``: ``o_totalprice`` at scale 18;
- ``o_doc varchar``: ``json.dumps({"clerk": o_clerk, "priority":
  o_orderpriority, "lines": n})``.

:func:`build_orders_nested` computes it with numpy group boundaries over
``lineitem`` sorted by (``l_orderkey``, ``l_linenumber``), encodes each
nested column's dictionary in the order ``Column.from_values`` gives
(tuples by ``_canon_key``, long decimals by value), and stores it in the
memory connector as one batch pinned on the device.

``KERNELS`` names, per query, the hand-written kernels its plan must
launch on a CUDA device: ``hash_insert`` for N3's join index and the hash
group-bys of N4, N6, N9 and N10 (keys that are not small dictionary codes).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..spi.batch import Column, ColumnBatch, _canon_key, _object_array
from ..spi.connector import ColumnSchema, TableSchema
from ..spi.types import (BIGINT, VARCHAR, ArrayType, DecimalType, MapType,
                         RowType)
from .catalog import Catalog

__all__ = ["NESTED_QUERIES", "KERNELS", "ORDERS_NESTED_TYPES",
           "nested_parts", "build_orders_nested"]

AMOUNT_SCALE = 18

ORDERS_NESTED_TYPES = {
    "o_orderkey": BIGINT,
    "o_custkey": BIGINT,
    "o_orderstatus": VARCHAR,
    "o_partkeys": ArrayType(BIGINT),
    "o_shipmodes": ArrayType(VARCHAR),
    "o_returned": ArrayType(VARCHAR),
    "o_flags": MapType(VARCHAR, BIGINT),
    "o_cust": RowType((("nationkey", BIGINT), ("segment", VARCHAR))),
    "o_amount": DecimalType(38, AMOUNT_SCALE),
    "o_doc": VARCHAR,
}

NESTED_QUERIES: dict[str, str] = {
    # array scalars
    "N1": "select count(*), sum(cardinality(o_partkeys)), "
          "max(cardinality(o_shipmodes)), sum(case when contains(o_shipmodes, "
          "'AIR') then 1 else 0 end), sum(cardinality(o_returned)) from "
          "orders_nested",
    # unnest, group by the element
    "N2": "select m, count(*) from orders_nested cross join "
          "unnest(o_shipmodes) as t(m) group by m order by m",
    # an array of foreign keys joined back
    "N3": "select p_brand, count(*), sum(n) from orders_nested cross join "
          "unnest(o_partkeys) with ordinality as t(pk, n) join part on "
          "p_partkey = pk where n <= 3 group by p_brand order by 2 desc, 1 "
          "limit 10",
    # row fields, wide decimal by group
    "N4": "select o_cust.segment, o_cust[1], count(*), sum(o_amount), "
          "avg(o_amount) from orders_nested group by o_cust.segment, "
          "o_cust[1] order by 1, 2 limit 10",
    # wide decimal against a literal
    "N5": "select o_orderstatus, sum(o_amount), avg(o_amount), "
          "min(o_amount), max(o_amount), count(*) from orders_nested where "
          "o_amount > 100000.000000000000000001 group by 1 order by 1",
    # map
    "N6": "select element_at(o_flags, 'R'), count(*), "
          "sum(cardinality(map_keys(o_flags))) from orders_nested group by 1 "
          "order by 1",
    # JSON payload
    "N7": "select json_extract_scalar(o_doc, '$.priority') pr, count(*), "
          "sum(cast(json_extract_scalar(o_doc, '$.lines') as bigint)) from "
          "orders_nested where json_extract_scalar(o_doc, '$.clerk') like "
          "'Clerk#00000000%' group by 1 order by 1",
    # zip unnest
    "N8": "select o_orderkey, pk, m from orders_nested cross join "
          "unnest(o_partkeys, o_shipmodes) as t(pk, m) where o_orderkey < 40 "
          "order by o_orderkey, pk, m",
    # empty arrays dropped, ordinality
    "N9": "select m, n, count(*) from orders_nested cross join "
          "unnest(o_returned) with ordinality as t(m, n) group by m, n "
          "order by m, n",
    # position and a negative index
    "N10": "select array_position(o_shipmodes, 'MAIL'), "
           "element_at(o_partkeys, -1) % 2 = 0, count(*) from orders_nested "
           "group by 1, 2 order by 1, 2",
    # table function
    "N11": "select count(*), sum(x) from table(sequence(1, 1000000)) as t(x) "
           "where x % 7 = 0",
}

KERNELS: dict[str, tuple[str, ...]] = {
    "N1": (), "N2": (), "N3": ("hash_insert",), "N4": ("hash_insert",),
    "N5": (), "N6": ("hash_insert",), "N7": (), "N8": (),
    "N9": ("hash_insert",), "N10": ("hash_insert",), "N11": (),
}


def _read(mem, table: str, columns: list[str]) -> dict:
    """The memory table's columns as numpy arrays (dictionary columns as
    (codes, dictionary)), from all its batches."""
    batches = []
    for split in mem.get_splits(table, 1, 1):
        src = mem.create_page_source(split, columns)
        while not src.is_finished():
            b = src.get_next_batch()
            if b is not None:
                batches.append(b)
    batch = ColumnBatch.concat(batches)
    out = {}
    for name, c in zip(batch.names, batch.columns):
        data = c.data.cpu().numpy()
        out[name] = data if c.dictionary is None else (data, c.dictionary)
    return out


def nested_parts(catalog: Catalog) -> dict:
    """The numpy arrays ``orders_nested`` is built from, read from the
    memory tables ``orders``, ``lineitem`` and ``customer``: per order its
    row in ``orders`` and its lines' range in ``lineitem`` sorted by
    (``l_orderkey``, ``l_linenumber``)."""
    mem = catalog.connector("memory")
    od = _read(mem, "orders", ["o_orderkey", "o_custkey", "o_orderstatus",
                               "o_totalprice", "o_clerk", "o_orderpriority"])
    li = _read(mem, "lineitem", ["l_orderkey", "l_linenumber", "l_partkey",
                                 "l_shipmode", "l_returnflag"])
    cu = _read(mem, "customer", ["c_custkey", "c_nationkey",
                                 "c_mktsegment"])
    def take(cols: dict, order: np.ndarray) -> dict:
        return {k: (v[order] if isinstance(v, np.ndarray)
                    else (v[0][order], v[1])) for k, v in cols.items()}

    od = take(od, np.argsort(od["o_orderkey"], kind="stable"))
    li = take(li, np.lexsort((li["l_linenumber"], li["l_orderkey"])))
    cu = take(cu, np.argsort(cu["c_custkey"], kind="stable"))
    lo = np.searchsorted(li["l_orderkey"], od["o_orderkey"], side="left")
    hi = np.searchsorted(li["l_orderkey"], od["o_orderkey"], side="right")
    cidx = np.searchsorted(cu["c_custkey"], od["o_custkey"])
    return {"orders": od, "lineitem": li, "customer": cu, "lo": lo,
            "hi": hi, "cidx": cidx}


def _padded(values: np.ndarray, order_of_line: np.ndarray,
            pos_of_line: np.ndarray, n: int, width: int) -> np.ndarray:
    """[n, width] int64 matrix of per-order element codes, -1 past each
    order's last element (so a shorter prefix sorts first, as tuples do)."""
    m = np.full((n, width), -1, dtype=np.int64)
    m[order_of_line, pos_of_line] = values
    return m


def _encode_matrix(m: np.ndarray, to_value) -> tuple:
    """Rows of a padded code matrix -> (int32 codes, dictionary).  The
    element codes preserve the elements' order and no element is NULL,
    so the rows' lexicographic order is the tuples' ``_canon_key`` order."""
    order = np.lexsort(m.T[::-1])
    ms = m[order]
    new = np.ones(len(ms), dtype=bool)
    new[1:] = (ms[1:] != ms[:-1]).any(axis=1)
    codes = np.empty(len(m), dtype=np.int32)
    codes[order] = np.cumsum(new) - 1
    return codes, _object_array([to_value(r) for r in ms[new].tolist()])


def _encode_tuples(keys: np.ndarray, to_value) -> tuple:
    """Per-row int64 keys -> (codes, dictionary of the tuples
    ``to_value(key)`` sorted by ``_canon_key``): for small dictionaries."""
    uniq, inv = np.unique(keys, return_inverse=True)
    vals = [to_value(k) for k in uniq.tolist()]
    rank = sorted(range(len(vals)), key=lambda i: _canon_key(vals[i]))
    pos = np.empty(len(vals), dtype=np.int32)
    pos[rank] = np.arange(len(vals), dtype=np.int32)
    return pos[inv.reshape(-1)], _object_array([vals[i] for i in rank])


def build_columns(parts: dict) -> dict:
    """name -> (codes or values, dictionary or None) of every column."""
    od, li, cu = parts["orders"], parts["lineitem"], parts["customer"]
    lo, hi = parts["lo"], parts["hi"]
    n = len(lo)
    nlines = hi - lo
    width = max(int(nlines.max()) if n else 0, 1)
    order_of_line = np.repeat(np.arange(n), nlines)
    pos_of_line = np.arange(len(order_of_line)) - np.repeat(
        np.cumsum(nlines) - nlines, nlines)
    lines = np.repeat(lo, nlines) + pos_of_line  # rows of sorted lineitem
    cols = {"o_orderkey": (od["o_orderkey"], None),
            "o_custkey": (od["o_custkey"], None),
            "o_orderstatus": od["o_orderstatus"]}
    pk = li["l_partkey"][lines]
    cols["o_partkeys"] = _encode_matrix(
        _padded(pk, order_of_line, pos_of_line, n, width),
        lambda r: tuple(x for x in r if x >= 0))
    sm_codes, sm_dict = li["l_shipmode"]
    sm = sm_codes[lines].astype(np.int64)
    sm_str = [str(x) for x in sm_dict]
    cols["o_shipmodes"] = _encode_matrix(
        _padded(sm, order_of_line, pos_of_line, n, width),
        lambda r: tuple(sm_str[x] for x in r if x >= 0))
    rf_codes, rf_dict = li["l_returnflag"]
    rf = rf_codes[lines].astype(np.int64)
    flags = [str(x) for x in rf_dict]
    is_r = rf == flags.index("R") if "R" in flags else np.zeros(
        len(rf), dtype=bool)
    r_order = order_of_line[is_r]
    r_pos = np.arange(len(r_order)) - np.searchsorted(r_order, r_order)
    cols["o_returned"] = _encode_matrix(
        _padded(sm[is_r], r_order, r_pos, n, width),
        lambda r: tuple(sm_str[x] for x in r if x >= 0))
    nf = len(flags)
    counts = np.zeros((n, nf), dtype=np.int64)
    np.add.at(counts, (order_of_line, rf), 1)
    base = width + 1
    key = np.zeros(n, dtype=np.int64)
    for j in range(nf):
        key = key * base + counts[:, j]

    def flag_map(k: int) -> tuple:
        cs = []
        for _ in range(nf):
            k, c = divmod(k, base)
            cs.append(c)
        cs.reverse()
        return tuple((flags[j], c) for j, c in enumerate(cs) if c)

    cols["o_flags"] = _encode_tuples(key, flag_map)
    seg_codes, seg_dict = cu["c_mktsegment"]
    cidx = parts["cidx"]
    nation = cu["c_nationkey"][cidx].astype(np.int64)
    seg = seg_codes[cidx].astype(np.int64)
    nseg = max(len(seg_dict), 1)
    cols["o_cust"] = _encode_tuples(
        nation * nseg + seg,
        lambda k: (k // nseg, str(seg_dict[k % nseg])))
    price = od["o_totalprice"]
    uniq, inv = np.unique(price, return_inverse=True)
    cols["o_amount"] = (inv.reshape(-1).astype(np.int32),
                        uniq.astype(object) * 10 ** (AMOUNT_SCALE - 2))
    ck_codes, ck_dict = od["o_clerk"]
    pr_codes, pr_dict = od["o_orderpriority"]
    npr = len(pr_dict)
    doc_key = (ck_codes.astype(np.int64) * npr + pr_codes) * base + nlines
    ukeys, dinv = np.unique(doc_key, return_inverse=True)
    docs = np.array([json.dumps({
        "clerk": str(ck_dict[k // base // npr]),
        "priority": str(pr_dict[k // base % npr]),
        "lines": k % base}) for k in ukeys.tolist()], dtype=object)
    ddict, dremap = np.unique(docs, return_inverse=True)
    cols["o_doc"] = (dremap.reshape(-1)[dinv.reshape(-1)].astype(np.int32),
                     ddict)
    return cols


def build_orders_nested(catalog: Catalog, device) -> dict:
    """Create ``memory.orders_nested`` from the memory tables ``orders``,
    ``lineitem`` and ``customer`` (staged by
    ``connectors/staging.stage_memory_tables``), as one batch pinned on
    ``device``.  Returns its rows, device bytes, dictionary sizes by
    column and the build seconds (device synchronized)."""
    t0 = time.perf_counter()
    dev = torch.device(device)
    cols = build_columns(nested_parts(catalog))
    names = list(ORDERS_NESTED_TYPES)
    batch = ColumnBatch(names, [
        Column(ORDERS_NESTED_TYPES[c], cols[c][0], None, cols[c][1])
        for c in names]).to(dev)
    mem = catalog.connector("memory")
    mem.create_table(TableSchema("orders_nested", tuple(
        ColumnSchema(c, ORDERS_NESTED_TYPES[c]) for c in names)))
    mem.finish_insert("orders_nested", [[batch]])
    mem.pin_to_device("orders_nested", dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"rows": batch.num_rows,
            "bytes": sum(c.data.numel() * c.data.element_size()
                         for c in batch.columns),
            "dictionaries": {c: len(cols[c][1]) for c in names
                             if cols[c][1] is not None},
            "seconds": time.perf_counter() - t0}

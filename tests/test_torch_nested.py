"""Array, map and row columns and UNNEST through the torch port against the
JAX reference: the 14 tests of tests/test_arrays.py, the row and map
tests of tests/test_wide_types.py, the nested queries N1-N4 and N6-N10
of connectors/nested_queries.py over ``orders_nested`` (with their
hash_insert calls), and UnnestOperator alone against the reference's on
seeded batches.

The reference is pinned as in test_torch_iterative_queries.py; the port
runs on the CPU.  Rows are equal (integers, strings, arrays, maps and rows
exactly).  ``orders_nested`` is built in the port by
``build_orders_nested`` and in the reference from the same python values
through its own ``Column.from_values`` and memory connector.
"""

import numpy as np
import pytest
import torch

from test_torch_iterative_queries import _pin
from test_torch_queries import _count_plain_calls, _same_rows
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.exec.operators import UnnestOperator as RefUnnest
from trino_tpu.runner import Session
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu.spi import batch as RB
from trino_tpu.spi import connector as RC
from trino_tpu.spi.types import parse_type as ref_parse_type
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.memory import _batch_overlaps
from trino_tpu_torch.connectors.nested_queries import (
    KERNELS, NESTED_QUERIES, ORDERS_NESTED_TYPES, build_orders_nested)
from trino_tpu_torch.connectors.staging import stage_memory_tables
from trino_tpu_torch.exec.operators import UnnestOperator
from trino_tpu_torch.planner.domains import extract_tuple_domain
from trino_tpu_torch.runner import StandaloneQueryRunner
from trino_tpu_torch.spi.batch import Column, ColumnBatch, unify_dictionaries
from trino_tpu_torch.spi.types import (BIGINT, VARCHAR, ArrayType,
                                       DecimalType, RowType, parse_type)
from trino_tpu_torch.sql.ir import Call, InputRef, Literal

SF = 0.01

SETUP = [
    "create table ar (id bigint, tags array(varchar), nums array(bigint))",
    "insert into ar values (1, array['a','b'], array[10, 20]), "
    "(2, array['c'], array[30]), (3, array[], array[]), (4, null, null)",
    "create table rm (id bigint, pt row(x bigint, y varchar), "
    "tags map(varchar, bigint))",
    "insert into rm values (1, row(10, 'a'), map(array['p','q'], "
    "array[1,2])), (2, row(20, 'b'), map(array['p'], array[7])), "
    "(3, null, null)",
]


@pytest.fixture(scope="module")
def pinned():
    with pytest.MonkeyPatch.context() as mp:
        _pin(mp)
        yield


@pytest.fixture(scope="module")
def runners(pinned):
    port = StandaloneQueryRunner(default_catalog(SF), device="cpu",
                                 default_catalog_name="memory")
    ref = RefRunner(ref_catalog(scale_factor=SF),
                    session=Session(default_catalog="memory"))
    for sql in SETUP:
        port.execute(sql)
        ref.execute(sql)
    return port, ref


def same(runners, sql):
    port, ref = runners
    got = port.execute(sql).rows()
    _same_rows(got, ref.execute(sql).rows())
    return got


# tests/test_arrays.py, query for query (each with its hand-checked rows)
ARRAY_QUERIES = {
    "standalone_unnest": (
        ["select * from unnest(array[1,2,3]) as t(x)"], [(1,), (2,), (3,)]),
    "unnest_with_ordinality": (
        ["select * from unnest(array['a','b']) with ordinality as t(x, n)"],
        [("a", 1), ("b", 2)]),
    "lateral_cross_join_unnest": (
        ["select id, t.tag from ar cross join unnest(tags) as t(tag) "
         "order by id, tag"], [(1, "a"), (1, "b"), (2, "c")]),
    "unnest_zip_pads_to_longest": (
        ["select id, t.tag, t.num from ar cross join unnest(tags, nums) "
         "as t(tag, num) where id = 1 order by num"],
        [(1, "a", 10), (1, "b", 20)]),
    "array_functions": (
        ["select cardinality(array[1,2,3]), element_at(array[5,6,7], 2), "
         "array[1,2,3][3], contains(array[1,2], 2), "
         "array_position(array['x','y'], 'y')"], [(3, 6, 3, True, 2)]),
    "cardinality_of_column": (
        ["select id, cardinality(tags) from ar order by id"],
        [(1, 2), (2, 1), (3, 0), (4, None)]),
    "element_at_out_of_bounds_is_null": (
        ["select element_at(nums, 5), element_at(nums, -1) from ar "
         "where id = 1"], [(None, 20)]),
    "group_by_array_column": (
        ["select tags, count(*) from ar group by tags order by 2 desc, 1"],
        [([], 1), (["a", "b"], 1), (["c"], 1), (None, 1)]),
    "array_roundtrip_and_null": (
        ["select id, tags from ar order by id"],
        [(1, ["a", "b"]), (2, ["c"]), (3, []), (4, None)]),
    "where_contains": (
        ["select id from ar where contains(tags, 'c')"], [(2,)]),
    "unnest_aggregate": (
        ["select sum(x) from ar cross join unnest(nums) as t(x)"], [(60,)]),
    # an array literal compare stays out of the TupleDomain; the exact
    # Filter compares the literal through the dictionary, not its code 0
    # (code 0 is the empty array of row 3)
    "array_equality_predicate": (
        ["select id from ar where tags = array['a','b']",
         "select id from ar where tags = array['nope']"], [(1,)]),
}


@pytest.mark.parametrize("case", list(ARRAY_QUERIES))
def test_array_queries_match_reference(runners, case):
    sqls, first_rows = ARRAY_QUERIES[case]
    assert same(runners, sqls[0]) == first_rows
    for sql in sqls[1:]:
        same(runners, sql)


def test_parse_array_type():
    for text in ("array(bigint)", "array(varchar)", "array(array(bigint))"):
        assert parse_type(text).name == ref_parse_type(text).name
    assert parse_type("array(array(bigint))") == ArrayType(ArrayType(BIGINT))
    assert parse_type("array(varchar)") == ArrayType(VARCHAR)


def test_unify_array_dictionaries_with_null_elements():
    # tuples holding None do not sort in numpy: the object merge path
    t = ArrayType(BIGINT)
    a = Column.from_values(t, [[1, None], [2]])
    b = Column.from_values(t, [[2], [3]])
    ua, ub = unify_dictionaries([a, b])
    ra, rb = RB.unify_dictionaries([
        RB.Column.from_values(ref_parse_type("array(bigint)"), [[1, None],
                                                                [2]]),
        RB.Column.from_values(ref_parse_type("array(bigint)"), [[2], [3]])])
    assert list(ua.dictionary) == list(ub.dictionary) == list(ra.dictionary)
    assert ua.data.tolist() == list(ra.data)
    assert ub.data.tolist() == list(rb.data)
    assert ua.to_pylist() == [[1, None], [2]]
    assert ub.to_pylist() == [[2], [3]]


@pytest.mark.parametrize("sql, want", [
    ("select id from ar where tags in (array['c'], array['a','b']) "
     "order by id", [1, 2]),
    ("select id from ar where tags not in (array['c']) order by id", [1, 3]),
    ("select id from rm where pt in (row(10, 'a')) order by id", [1]),
])
def test_in_list_over_arrays_and_rows(runners, sql, want):
    """IN over an array or row column matches the tuples.  The reference
    compares the dictionary's tuples with the items' strings and matches
    nothing (ROADMAP queue 3), so the port is held to the exact rows."""
    port, _ = runners
    assert [r[0] for r in port.execute(sql).rows()] == want


# tests/test_wide_types.py: the row and map tests
@pytest.mark.parametrize("sql", [
    "select id, pt.x, pt.y from rm order by id",
    "select pt from rm where id = 1",
    "select count(*) from rm where pt = row(10, 'a')",
    "select pt[1] from rm where id = 2",
])
def test_row_type_access_and_group(runners, sql):
    assert same(runners, sql)


@pytest.mark.parametrize("sql", [
    "select id, cardinality(tags), tags['p'], element_at(tags, 'q') "
    "from rm order by id",
    "select map_keys(tags), map_values(tags) from rm where id = 1",
    "select tags from rm where id = 2",
])
def test_map_type_functions(runners, sql):
    assert same(runners, sql)


# ---------------------------------------------------------------------------
# orders_nested: N1-N4, N6-N10 (N5 is in test_torch_wide_decimal.py, N7
# and N11 in test_torch_json_tablefn.py)


def _reference_table(ref_cat, name: str, batch: ColumnBatch, types: dict):
    """Create memory.<name> in the reference from the port batch's python
    values."""
    cols = [RB.Column.from_values(ref_parse_type(types[c].name),
                                  batch.column(c).to_pylist())
            for c in batch.names]
    mem = ref_cat.connector("memory")
    mem.create_table(RC.TableSchema(name, tuple(
        RC.ColumnSchema(c, ref_parse_type(types[c].name))
        for c in batch.names)))
    mem.finish_insert(name, [[RB.ColumnBatch(list(batch.names), cols)]])


@pytest.fixture(scope="module")
def nested(pinned):
    """(port runner, reference runner, port batch) over orders_nested and
    part at SF 0.01."""
    cat = default_catalog(SF)
    stage_memory_tables(cat, ("orders", "lineitem", "customer", "part"),
                        "cpu")
    build_orders_nested(cat, "cpu")
    (batch,) = cat.connector("memory")._data["orders_nested"]
    ref_cat = ref_catalog(scale_factor=SF)
    _reference_table(ref_cat, "orders_nested", batch, ORDERS_NESTED_TYPES)
    ref = RefRunner(ref_cat, session=Session(default_catalog="memory"))
    ref.execute("create table part as select * from tpch.part")
    port = StandaloneQueryRunner(cat, device="cpu",
                                 default_catalog_name="memory",
                                 splits_per_node=1)
    return port, ref, batch


def test_orders_nested_dictionaries_are_from_values_order(nested):
    """The vectorised build gives each nested and wide column the codes and
    dictionary Column.from_values gives the same values (tuples by
    _canon_key, long decimals by value), and the reference's."""
    _, _, batch = nested
    assert batch.num_rows == 15000
    sizes = {}
    for name, c in zip(batch.names, batch.columns):
        if c.dictionary is None or name == "o_orderstatus":
            continue
        vals = c.to_pylist()
        mine = Column.from_values(c.type, vals)
        theirs = RB.Column.from_values(ref_parse_type(c.type.name), vals)
        assert list(c.dictionary) == list(mine.dictionary) \
            == list(theirs.dictionary), name
        assert c.data.tolist() == mine.data.tolist() \
            == list(np.asarray(theirs.data)), name
        sizes[name] = len(c.dictionary)
    # the reference's sizes at SF 0.01
    assert sizes == {"o_partkeys": 14111, "o_shipmodes": 8035,
                     "o_returned": 1408, "o_flags": 114, "o_cust": 125,
                     "o_amount": 14993, "o_doc": 350}


@pytest.mark.parametrize("name", ["N1", "N2", "N3", "N4", "N6", "N8", "N9",
                                  "N10"])
def test_nested_queries_match_reference(nested, monkeypatch, name):
    port, ref, _ = nested
    calls = _count_plain_calls(monkeypatch)
    got = port.execute(NESTED_QUERIES[name]).rows()
    assert (calls["insert"] > 0) == ("hash_insert" in KERNELS[name])
    assert calls["segment_sum"] == 0
    assert got
    _same_rows(got, ref.execute(NESTED_QUERIES[name]).rows())


# ---------------------------------------------------------------------------
# UnnestOperator alone

T_ARR = ArrayType(BIGINT)
T_STR = ArrayType(VARCHAR)
T_NEST = ArrayType(ArrayType(BIGINT))


def _random_arrays(rng, n, make):
    """NULL arrays, empty arrays and arrays of 1-5 elements, some NULL."""
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.15:
            out.append(None)
        elif r < 0.3:
            out.append([])
        else:
            out.append([None if rng.random() < 0.15 else make(rng)
                        for _ in range(int(rng.integers(1, 6)))])
    return out


UNNEST_CASES = {
    # one bigint array with NULL arrays, empty arrays and NULL elements
    "bigint": ([T_ARR], False, None),
    # two arrays of unequal lengths zip-pad with NULL; ordinality
    "zip_ordinality": ([T_ARR, T_STR], True, None),
    # dead rows emit nothing
    "dead_rows": ([T_STR], True, 0.4),
    # nested element type: a tuple element dictionary
    "array_of_arrays": ([T_NEST, T_ARR], True, 0.2),
}


def _make(t, rng):
    if t == T_ARR:
        return int(rng.integers(-5, 31))
    if t == T_STR:
        return str(rng.choice(["a", "bb", "c", "dd", "e"]))
    # an inner array is a tuple, as array values are in a dictionary
    return tuple(int(x) for x in rng.integers(0, 4, int(rng.integers(0, 3))))


@pytest.mark.parametrize("case", list(UNNEST_CASES))
def test_unnest_operator_matches_reference(case):
    types, ordinality, dead = UNNEST_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    n = 60
    ids = list(range(n))
    arrays = [_random_arrays(rng, n, lambda r, t=t: _make(t, r))
              for t in types]
    live = (None if dead is None else
            np.array([rng.random() >= dead for _ in range(n)]))
    names = ["id"] + [f"a{j}" for j in range(len(types))]
    out_names = ["id"] + [f"e{j}" for j in range(len(types))] + (
        ["n"] if ordinality else [])

    port_batch = ColumnBatch(names, [Column.from_values(BIGINT, ids)] + [
        Column.from_values(t, a) for t, a in zip(types, arrays)],
        None if live is None else torch.from_numpy(live))
    op = UnnestOperator([0], list(range(1, len(types) + 1)), ordinality,
                        out_names, [BIGINT] + [t.element for t in types]
                        + ([BIGINT] if ordinality else []))
    op.add_input(port_batch)
    op.finish_input()
    got = op.get_output().to_pylist()

    rtypes = [ref_parse_type(t.name) for t in types]
    ref_batch = RB.ColumnBatch(names, [
        RB.Column.from_values(ref_parse_type("bigint"), ids)] + [
        RB.Column.from_values(t, a) for t, a in zip(rtypes, arrays)], live)
    rop = RefUnnest([0], list(range(1, len(types) + 1)), ordinality,
                    out_names, [ref_parse_type("bigint")]
                    + [t.element for t in rtypes]
                    + ([ref_parse_type("bigint")] if ordinality else []))
    rop.add_input(ref_batch)
    rop.finish_input()
    want = rop.get_output().to_pylist()
    assert got == want
    assert len(got) > n // 2


def test_unnest_operator_builds_its_tables_once_per_dictionary():
    """The per-entry lengths, offsets and elements are built on the host
    once per dictionary object; a second batch over the same dictionary
    reuses them."""
    col = Column.from_values(T_ARR, [[1, 2], None, [3]])
    op = UnnestOperator([], [0], False, ["x"], [BIGINT])
    batch = ColumnBatch(["a"], [col])
    op.add_input(batch)
    first = op._tables[(0, id(col.dictionary))]
    op.get_output()
    op.add_input(batch)
    assert op._tables[(0, id(col.dictionary))] is first
    assert op.get_output().to_pylist() == [(1,), (2,), (3,)]


# ---------------------------------------------------------------------------
# memory connector zone maps


def test_zone_maps_skip_tuple_and_long_decimal_dictionaries():
    """A host batch's min / max check must not compare a tuple dictionary
    with a string, nor stringify a long decimal's scaled ints."""
    row_t = RowType((("x", BIGINT), ("y", VARCHAR)))
    dec_t = DecimalType(38, 2)
    b = ColumnBatch(["r", "d"], [
        Column.from_values(row_t, [(10, "a"), (20, "b")]),
        Column.from_values(dec_t, ["9.50", "100000000000000000000.25"])])
    eq_row = Call(parse_type("boolean"), "eq", (
        InputRef(row_t, 0), Literal(row_t, (10, "a"))))
    gt_dec = Call(parse_type("boolean"), "gt", (
        InputRef(dec_t, 1), Literal(dec_t, "10.00")))
    lt_dec = Call(parse_type("boolean"), "lt", (
        InputRef(dec_t, 1), Literal(dec_t, "9.00")))
    for pred, keep in ((eq_row, True), (gt_dec, True), (lt_dec, False)):
        dom = extract_tuple_domain(pred, {0: "r", 1: "d"})
        assert _batch_overlaps(b, dom) is keep

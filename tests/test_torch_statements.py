"""The port's statement layer held statement for statement to the reference.

The single-node cases of the reference's tests/test_statements.py,
tests/test_ddl.py, tests/test_txn_routines_tablefn.py and
tests/test_observability.py (access control) run as sequences through both
runners, each over its own package's catalog at SF 0.01: the reference
pinned (sort hash path, no Pallas, no result cache, the iterative
optimizer, no HBO), the port on ``device="cpu"``.  Every statement must
give the same rows in both, or raise an exception of the same class name.
Port-only cases cover what the reference does not hold: ANALYZE's distinct
counts against numpy (signed zeros, NaN, dictionaries split across
batches, RLE / LAZY / long-decimal / array columns) and through the
``hash_insert`` route, residency after DELETE, REFRESH and ROLLBACK, the
22 plans after ANALYZE of staged tables, and the engine's session
properties (``task_concurrency``, ``hbm_limit_bytes`` and the disk tier's
``spill_to_disk_bytes`` run as in the reference).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import trino_tpu.spi.batch as ref_batch
import trino_tpu.spi.connector as ref_schema
import trino_tpu.spi.security as ref_security
import trino_tpu.spi.types as ref_types
import trino_tpu_torch.spi.security as port_security
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.planner import plan as ref_plan
from trino_tpu.runner import Session as RefSession
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.tpch_queries import QUERIES
from trino_tpu_torch.ops import gpu_kernels as GK
from trino_tpu_torch.planner import plan as port_plan
from trino_tpu_torch.runner import Session, StandaloneQueryRunner
from trino_tpu_torch.spi.batch import Column, ColumnBatch
from trino_tpu_torch.spi.connector import ColumnSchema, TableSchema
from trino_tpu_torch.spi.types import BIGINT, DOUBLE, VARCHAR
from trino_tpu_torch.caching import result_cache

SF = 0.01
TPCH_TABLES = ("region", "nation", "supplier", "customer", "part",
               "partsupp", "orders", "lineitem")


@pytest.fixture(autouse=True)
def _execution_not_cached():
    """Every statement here executes: a result-cache hit would skip the
    launches, syncs and revocations these tests count."""
    with result_cache.disabled():
        yield


@pytest.fixture(autouse=True)
def _pin_reference(monkeypatch):
    for k, v in (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
                 ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
                 ("TRINO_TPU_OPTIMIZER", "iterative")):
        monkeypatch.setenv(k, v)


def _runners(**session) -> tuple:
    """(reference, port) runners, each over its own SF 0.01 catalog."""
    ref = RefRunner(ref_catalog(scale_factor=SF),
                    session=RefSession(**session))
    port = StandaloneQueryRunner(default_catalog(SF), device="cpu",
                                 session=Session(**session))
    return ref, port


def _outcome(runner, sql: str):
    try:
        return "rows", runner.execute(sql).rows()
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        return "raises", type(e).__name__


def _same(ref, port, sql: str, ordered: bool = True):
    """Run one statement through both runners; equal rows (sorted when
    ``ordered`` is False) or, for a ``Raises`` step, the same exception
    class name."""
    want, got = _outcome(ref, sql), _outcome(port, sql)
    assert want[0] == ("raises" if isinstance(sql, Raises) else "rows"), (
        sql, want)
    if not ordered and want[0] == got[0] == "rows":
        want, got = ("rows", sorted(want[1])), ("rows", sorted(got[1]))
    assert got == want, sql
    return got


REF = SimpleNamespace(security=ref_security)
PORT = SimpleNamespace(security=port_security)


def _deny_all(runner, m):
    runner.access_control.add(m.security.DenyAllAccessControl())


def _alice_rules(runner, m):
    runner.access_control.add(m.security.RuleBasedAccessControl([
        m.security.TableRule("alice", "tpch", "nation", {"SELECT"}),
        m.security.TableRule("alice", "memory", "*", {"ALL"}),
    ]))


class Raises(str):
    """A step that raises in the reference (and must in the port)."""


# Each case: the session, then its steps in order: a statement (that runs,
# or ``Raises``), or a callable (runner, package namespace) applied to both
# runners.  Statements whose result has no ORDER BY are compared as sorted
# rows.
CASES = {
    # tests/test_statements.py
    "create_view_and_query": ({"default_catalog": "tpch"}, [
        "create view big_nations as "
        "select n_name, n_regionkey from nation where n_nationkey > 20",
        "select count(*) from big_nations",
        "select v.n_name from big_nations v join region r "
        "on v.n_regionkey = r.r_regionkey where r.r_name = 'ASIA' "
        "order by 1",
        "show tables",
        Raises("create view big_nations as select 1"),
        "create or replace view big_nations as select n_name from nation",
        "select count(*) from big_nations",
        "drop view big_nations",
        Raises("select * from big_nations"),
        "drop view if exists big_nations",
    ]),
    "materialized_view_refresh": ({"default_catalog": "tpch"}, [
        "create table memory.mv_src (x bigint)",
        "insert into memory.mv_src values (1), (2)",
        "create materialized view mv_sum as "
        "select sum(x) as s from memory.mv_src",
        "select s from mv_sum",
        "insert into memory.mv_src values (10)",
        "select s from mv_sum",
        "refresh materialized view mv_sum",
        "select s from mv_sum",
        "drop materialized view mv_sum",
        Raises("select s from mv_sum"),
    ]),
    "set_session": ({"default_catalog": "tpch"}, [
        "set session dynamic_filtering = false",
        "set session splits_per_node = 2",
        Raises("set session no_such_knob = 1"),
        Raises("set session user = 'mallory'"),
        "select count(*) from nation",
    ]),
    "call_procedure": ({"default_catalog": "tpch"}, [
        "create table memory.pt (x bigint)",
        "insert into memory.pt values (1), (2), (3)",
        "call memory.truncate_table('pt')",
        "select count(*) from memory.pt",
        Raises("call memory.no_such_proc()"),
        Raises("call memory.truncate_table('no_such_table')"),
    ]),
    "analyze_feeds_stats": ({"default_catalog": "tpch"}, [
        "create table memory.an (k bigint, s varchar)",
        "insert into memory.an values (1, 'a'), (2, 'b'), (2, 'b'), "
        "(3, null)",
        "analyze memory.an",
    ]),
    # tests/test_ddl.py
    "create_insert_select_drop": ({"default_catalog": "memory"}, [
        "create table t (id bigint, name varchar, price decimal(10,2))",
        "show columns from t",
        "insert into t select n_nationkey, n_name, 1.50 "
        "from tpch.nation where n_regionkey = 1",
        "select count(*), sum(price) from t",
        "drop table t",
        Raises("select * from t"),
    ]),
    "drop_if_exists": ({"default_catalog": "memory"}, [
        "drop table if exists nope",
        Raises("drop table nope"),
    ]),
    "delete_where": ({"default_catalog": "memory"}, [
        "create table d as select n_nationkey, n_regionkey "
        "from tpch.nation",
        "delete from d where n_regionkey = 1",
        "select count(*) from d",
        "delete from d where cast(null as boolean)",
        "select count(*) from d",
        "delete from d",
        "select count(*) from d",
    ]),
    "delete_rejected_on_readonly_connector": ({"default_catalog": "memory"}, [
        Raises("delete from tpch.nation"),
    ]),
    # tests/test_txn_routines_tablefn.py: transactions
    "rollback_undoes_insert_and_create": ({"default_catalog": "memory"}, [
        "create table tx (v bigint)",
        "insert into tx values (1)",
        "start transaction",
        "insert into tx values (2), (3)",
        "create table tx2 (w bigint)",
        "select count(*) from tx",
        "rollback",
        "select count(*) from tx",
        Raises("select * from tx2"),
    ]),
    "commit_keeps_writes": ({"default_catalog": "memory"}, [
        "create table tc (v bigint)",
        "begin",
        "insert into tc values (9)",
        "commit",
        "select v from tc",
    ]),
    "transaction_state_errors": ({"default_catalog": "memory"}, [
        Raises("commit"),
        Raises("rollback"),
        "begin",
        Raises("begin"),
        "rollback",
    ]),
    # tests/test_txn_routines_tablefn.py: SQL routines
    "create_function_and_inline": ({"default_catalog": "memory"}, [
        "create function double_it(x bigint) returns bigint return x * 2",
        "select double_it(21)",
        "create function add5(x bigint) returns bigint "
        "return double_it(x) + 5 - x",
        "select add5(n_nationkey) from tpch.nation where n_nationkey = 7",
        Raises("create function sum(x bigint) returns bigint return x"),
    ]),
    "function_over_column_and_where": ({"default_catalog": "memory"}, [
        "create function sq(x double) returns double return x * x",
        "select n_nationkey from tpch.nation where sq(n_nationkey) = 49",
    ]),
    "drop_function": ({"default_catalog": "memory"}, [
        "create function f1(x bigint) returns bigint return x",
        "drop function f1",
        Raises("select f1(1)"),
        Raises("drop function f1"),
    ]),
    "recursive_function_rejected": ({"default_catalog": "memory"}, [
        "create function r1(x bigint) returns bigint return r1(x)",
        Raises("select r1(1)"),
    ]),
    # tests/test_observability.py: access control
    "deny_all_access_control": ({}, [
        "select count(*) from nation",
        _deny_all,
        Raises("select * from nation"),
        Raises("explain select * from nation"),
        Raises("create table memory.x (v bigint)"),
    ]),
    "rule_based_access_control": (
        {"user": "alice", "default_catalog": "memory"}, [
            "create table t (v bigint)",
            _alice_rules,
            "select count(*) from tpch.nation",
            Raises("select count(*) from tpch.region"),
            "insert into t values (1)",
            Raises("insert into tpch.nation select * from tpch.nation"),
            "delete from t",
            "drop table t",
        ]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_statements_match_reference(case):
    session, steps = CASES[case]
    ref, port = _runners(**session)
    for step in steps:
        if callable(step):
            step(ref, REF)
            step(port, PORT)
            continue
        ordered = "order by" in step or not step.startswith("select")
        _same(ref, port, step, ordered)
    if case == "set_session":
        assert port.session.dynamic_filtering is False
        assert port.session.splits_per_node == 2
        assert port.session.user == "user"
    if case == "analyze_feeds_stats":
        for r in (ref, port):
            assert _stats(r, "an") == (4.0, {"k": 3.0, "s": 2.0})
    if case == "deny_all_access_control":
        with pytest.raises(port_security.AccessDeniedError):
            port.execute("select * from nation")


def test_mv_staleness_matches_reference():
    ref, port = _runners(default_catalog="memory")
    for sql in ("create table s (x bigint)", "insert into s values (1)",
                "create materialized view m as select sum(x) t from s"):
        _same(ref, port, sql)
    states = []
    for sql in ("insert into s values (2)", "refresh materialized view m"):
        _same(ref, port, sql)
        states.append((ref.catalog.mv_is_stale("m"),
                       port.catalog.mv_is_stale("m")))
    assert states == [(True, True), (False, False)]
    with pytest.raises(KeyError):
        port.catalog.mv_is_stale("s")


# ---------------------------------------------------------------------------
# ANALYZE: distinct counts against numpy, through hash_insert


def _stats(runner, table: str) -> tuple:
    """(row count, NDV per column) of a memory table (each package has its
    own TableStatistics class)."""
    st = runner.catalog.connector("memory").get_table_statistics(table)
    return st.row_count, st.ndv


def _numpy_ndv(data: np.ndarray, valid=None) -> int:
    present = data if valid is None else data[valid]
    return len(np.unique(present))


def _memory_table(runner, table: str, types, batches) -> None:
    """A memory table of host batches, each a list of Columns."""
    mem = runner.catalog.connector("memory")
    names = [f"c{i}" for i in range(len(types))]
    mem.create_table(TableSchema(table, tuple(
        ColumnSchema(n, t) for n, t in zip(names, types))))
    mem.finish_insert(table, [[ColumnBatch(names, cols)
                               for cols in batches]])


def test_analyze_doubles_signed_zero_and_nan():
    """-0.0 == 0.0 and NaN is one value, across two batches; NULLs are not
    values.  The reference unions each batch's values in a python set,
    where the NaNs of two batches stay two values (ROADMAP queue 3)."""
    b1 = np.array([-0.0, 0.0, np.nan, 1.5, 7.0])
    v1 = np.array([True, True, True, True, False])
    b2 = np.array([np.nan, 0.0, 2.5, -0.0])
    ref, port = _runners(default_catalog="memory")
    _memory_table(port, "f", [DOUBLE], [[Column(DOUBLE, b1, v1)],
                                        [Column(DOUBLE, b2)]])
    assert port.execute("analyze f").rows() == [(9,)]
    want = _numpy_ndv(np.concatenate([b1[v1], b2]))
    assert want == 4
    assert _stats(port, "f") == (9.0, {"c0": float(want)})
    # the reference's count on the same batches: one NaN per batch
    ref_mem = ref.catalog.connector("memory")
    ref_mem.create_table(ref_schema.TableSchema("f", (
        ref_schema.ColumnSchema("c0", ref_types.DOUBLE),)))
    ref_mem.finish_insert("f", [[
        ref_batch.ColumnBatch(["c0"], [ref_batch.Column(ref_types.DOUBLE,
                                                        b1, v1)]),
        ref_batch.ColumnBatch(["c0"], [ref_batch.Column(ref_types.DOUBLE,
                                                        b2)])]])
    assert ref.execute("analyze f").rows() == [(9,)]
    assert _stats(ref, "f") == (9.0, {"c0": float(want + 1)})


def test_delete_counts_rows_inserted_after_analyze():
    """DELETE's count is the rows it removed, also when the table grew after
    its ANALYZE (the reference subtracts from the analyzed row count and
    reports -15 here: ROADMAP queue 3)."""
    ref, port = _runners(default_catalog="memory")
    for sql in ("create table d as select n_nationkey from tpch.nation",
                "analyze d",
                "insert into d select n_nationkey from tpch.nation"):
        _same(ref, port, sql)
    sql = "delete from d where n_nationkey < 5"
    assert port.execute(sql).rows() == [(10,)]
    assert ref.execute(sql).rows() == [(-15,)]
    _same(ref, port, "select count(*) from d")


def test_analyze_counts_through_hash_insert(monkeypatch):
    """One hash_insert per column that is not a dictionary, none for the
    dictionary columns; the NDVs equal numpy's and the reference's."""
    calls = []
    orig = GK.hash_insert_plain

    def spy(*args):
        calls.append(args[0].shape)
        return orig(*args)

    monkeypatch.setattr(GK, "hash_insert_plain", spy)
    ref, port = _runners(default_catalog="memory")
    sql = "create table li as select * from tpch.lineitem"
    _same(ref, port, sql)
    calls.clear()
    _same(ref, port, "analyze li")
    schema = port.catalog.connector("memory").get_table_schema("li")
    non_dict = [c.name for c in schema.columns
                if not c.type.is_dictionary_encoded]
    assert len(calls) == len(non_dict) == 11
    got = _stats(port, "li")
    assert got == _stats(ref, "li")
    tpch = port.catalog.connector("tpch")
    n = tpch.row_count("orders")
    host = tpch._generate("lineitem", schema.column_names(), 0, n)
    for name, col in zip(host.names, host.columns):
        data = col.data.numpy()
        expect = (len(np.unique(col.dictionary[np.unique(data)]))
                  if col.dictionary is not None else _numpy_ndv(data))
        assert got[1][name] == expect, name


def test_analyze_reads_one_column_at_a_time(monkeypatch):
    """ANALYZE holds no more than one column's batches on the device: each
    page source it opens reads one column.  A multi-batch column and a
    one-batch table give numpy's counts."""
    from trino_tpu_torch.connectors.memory import MemoryConnector

    opened = []
    orig = MemoryConnector.create_page_source

    def spy(self, split, columns):
        opened.append(tuple(columns))
        return orig(self, split, columns)

    monkeypatch.setattr(MemoryConnector, "create_page_source", spy)
    _, port = _runners(default_catalog="memory")
    b1 = np.array([3, 1, 3, 7], np.int64)
    b2 = np.array([7, 9], np.int64)
    _memory_table(port, "two", [BIGINT, BIGINT],
                  [[Column(BIGINT, b1), Column(BIGINT, b1 * 0)],
                   [Column(BIGINT, b2), Column(BIGINT, b2)]])
    _memory_table(port, "one", [BIGINT], [[Column(BIGINT, b1)]])
    assert port.execute("analyze two").rows() == [(6,)]
    assert port.execute("analyze one").rows() == [(4,)]
    assert sorted(opened) == [("c0",), ("c0",), ("c1",)]
    assert _stats(port, "two") == (6.0, {
        "c0": float(_numpy_ndv(np.concatenate([b1, b2]))),
        "c1": float(_numpy_ndv(np.concatenate([b1 * 0, b2])))})
    assert _stats(port, "one") == (4.0, {"c0": float(_numpy_ndv(b1))})


def test_analyze_dictionary_split_across_batches():
    """Two INSERT batches with different dictionaries: values, not codes,
    are counted."""
    ref, port = _runners(default_catalog="memory")
    for sql in ("create table s (v varchar, k bigint)",
                "insert into s values ('a', 1), ('b', 2), (null, 2)",
                "insert into s values ('c', 3), ('b', 1), ('c', null)",
                "analyze s"):
        _same(ref, port, sql)
    mem = port.catalog.connector("memory")
    dicts = [list(b.column("v").dictionary) for b in mem._data["s"]]
    assert dicts == [["", "a", "b"], ["b", "c"]]  # '' fills the NULL
    assert _stats(port, "s") == _stats(ref, "s") == (
        6.0, {"v": 3.0, "k": 3.0})


def test_analyze_rle_and_lazy_columns():
    """RLE and LAZY columns (the encoded scan's) count as their values."""
    lazy_data = np.array([4, 4, 9, 1, 9], np.int64)
    lazy_valid = np.array([True, True, True, False, True])
    runs = [
        [Column.rle(BIGINT, 7, 5, device="cpu"),
         Column.rle(VARCHAR, 1, 5, dictionary=np.array(["x", "y"], object),
                    device="cpu")],
        [Column.lazy(BIGINT, 5, lambda: (lazy_data, lazy_valid),
                     device="cpu"),
         Column.rle(VARCHAR, 0, 5, dictionary=np.array(["z"], object),
                    device="cpu")],
        [Column.rle(BIGINT, 9, 3, valid=np.array([False, True, True]),
                    device="cpu"),
         Column.rle(VARCHAR, 0, 3, valid=np.zeros(3, bool),
                    dictionary=np.array(["w"], object), device="cpu")],
    ]
    _, port = _runners(default_catalog="memory")
    _memory_table(port, "e", [BIGINT, VARCHAR], runs)
    assert port.execute("analyze e").rows() == [(13,)]
    want_k = _numpy_ndv(np.concatenate([np.full(5, 7), lazy_data[lazy_valid],
                                        np.full(2, 9)]))
    stats = port.catalog.connector("memory").get_table_statistics("e")
    assert stats.ndv == {"c0": float(want_k), "c1": 2.0}
    assert want_k == 3


@pytest.mark.parametrize("ddl,values,want", [
    ("d decimal(38,2)",
     "(12345678901234567890123.45), (1.00), (12345678901234567890123.45), "
     "(null), (-1.00)", 3),
    ("a array(bigint)",
     "(array[1, 2]), (array[2, 1]), (array[1, 2]), (array[]), (null)", 3),
])
def test_analyze_long_decimal_and_array_columns(ddl, values, want):
    ref, port = _runners(default_catalog="memory")
    for sql in (f"create table w ({ddl})", f"insert into w values {values}",
                "analyze w"):
        _same(ref, port, sql)
    assert _stats(port, "w") == _stats(ref, "w") == (
        5.0, {ddl.split()[0]: float(want)})


# ---------------------------------------------------------------------------
# residency: DELETE, REFRESH and ROLLBACK keep a pinned table pinned


def test_residency_after_delete_refresh_rollback():
    _, port = _runners(default_catalog="memory")
    mem = port.catalog.connector("memory")
    port.execute("create table r as select o_orderkey, o_orderstatus, "
                 "o_totalprice from tpch.orders")
    assert not mem.is_resident("r")
    assert port.execute("call memory.pin_table('r')").rows() == [
        ("pinned r",)]
    assert mem.is_resident("r")
    n = port.execute("select count(*) from r").rows()[0][0]
    deleted = port.execute("delete from r where o_orderstatus = 'F'").rows()
    assert mem.is_resident("r")
    assert deleted[0][0] + port.execute(
        "select count(*) from r").rows()[0][0] == n
    port.execute("create materialized view m as select o_orderstatus, "
                 "count(*) c from r group by o_orderstatus")
    assert mem.is_resident("__mv_m")
    port.execute("start transaction")
    port.execute("insert into r select o_orderkey, o_orderstatus, "
                 "o_totalprice from tpch.orders where o_orderkey < 100")
    assert not mem.is_resident("r")  # the inserted batch is not pinned
    port.execute("refresh materialized view m")
    assert mem.is_resident("__mv_m")
    port.execute("call memory.pin_table('r')")  # pins the inserted batch
    assert mem.is_resident("r")
    port.execute("rollback")
    assert mem.is_resident("r")
    assert mem._pinned_batches["r"] == len(mem._data["r"])
    assert port.execute("select count(*) from r").rows() == [
        (n - deleted[0][0],)]
    port.execute("call memory.truncate_table('r')")
    assert not mem.is_resident("r")


def test_pin_table_takes_the_runners_device(monkeypatch):
    _, port = _runners(default_catalog="memory")
    mem = port.catalog.connector("memory")
    seen = []
    monkeypatch.setattr(mem, "pin_to_device",
                        lambda table, device: seen.append((table, device)))
    port.execute("create table p (v bigint)")
    port.execute("call memory.pin_table('p')")
    assert seen == [("p", torch.device("cpu"))]
    with pytest.raises(TypeError):
        mem.get_procedures()["pin_table"]("p")  # no device, no default


def test_cpu_pinned_table_keeps_its_tensors_on_delete():
    """The kept rows of a resident table are stored as the query returned
    them: no copy to another device."""
    _, port = _runners(default_catalog="memory")
    mem = port.catalog.connector("memory")
    port.execute("create table k as select n_nationkey, n_name from "
                 "tpch.nation")
    mem.pin_to_device("k", "cpu")
    port.execute("delete from k where n_nationkey >= 20")
    (batch,) = mem._data["k"]
    assert batch.live is None and batch.num_rows == 20
    assert all(c.device.type == "cpu" for c in batch.columns)


# ---------------------------------------------------------------------------
# the plans of the 22 queries after ANALYZE of staged tables


@pytest.fixture(scope="module")
def analyzed():
    """Both packages' memory catalogs with the eight TPC-H tables copied
    by CTAS and analyzed (runs once, under the reference's pins)."""
    mp = pytest.MonkeyPatch()
    for k, v in (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
                 ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
                 ("TRINO_TPU_OPTIMIZER", "iterative")):
        mp.setenv(k, v)
    try:
        ref, port = _runners(default_catalog="memory")
        for t in TPCH_TABLES:
            for sql in (f"create table {t} as select * from tpch.{t}",
                        f"analyze {t}"):
                _same(ref, port, sql)
            assert _stats(port, t) == _stats(ref, t), t
        yield ref, port
    finally:
        mp.undo()


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_plans_after_analyze_match_reference(analyzed, q):
    ref, port = analyzed
    want = ref_plan.plan_text(ref.create_plan(QUERIES[q]))
    got = port_plan.plan_text(port.create_plan(QUERIES[q]))
    assert got == want


# ---------------------------------------------------------------------------
# the session properties of the engine

ENGINE_SQL = ("select l_orderkey, count(*), sum(l_quantity) from lineitem, "
              "orders where l_orderkey = o_orderkey and o_orderdate < "
              "date '1995-01-01' group by l_orderkey order by 3 desc, 1 "
              "limit 10")


@pytest.mark.parametrize("name,value", [
    ("task_concurrency", 4), ("hbm_limit_bytes", 1 << 20),
    ("spill_to_disk_bytes", 64 << 10)])
def test_engine_session_properties_run(name, value):
    """Each is set as in the reference and the query after it gives its
    rows (parallel drivers over eight splits; a 1 MiB pool; a 64 KiB disk
    budget, under which the buffers go to spill files)."""
    ref, port = _runners()
    for sql in ("set session splits_per_node = 8",
                f"set session {name} = {value}", ENGINE_SQL):
        _same(ref, port, sql)
    assert port.session.get(name) == getattr(Session(**{name: value}),
                                             name) == value


def test_reference_only_properties_are_stored():
    """``use_collectives`` and ``retry_policy`` are Session fields the
    distributed runner reads, set to the reference's values;
    ``max_worker_replacements`` (the control plane's) stays stored
    unread."""
    ref, port = _runners()
    for sql in ("set session use_collectives = false",
                "set session retry_policy = 'TASK'",
                "set session max_worker_replacements = 3",
                "set session node_count = 1"):
        _same(ref, port, sql)
    assert port.session.use_collectives is ref.session.use_collectives \
        is False
    assert port.session.retry_policy == ref.session.retry_policy == "TASK"
    assert (port.session.get("use_collectives"),
            port.session.get("retry_policy"),
            port.session.get("max_worker_replacements")) == (False, "TASK", 3)
    assert port.session.properties == {"max_worker_replacements": 3}


@pytest.mark.parametrize("name", [
    "source", "query_priority", "query_queued_timeout_s",
    "query_max_memory_bytes", "failure_injector", "fte_spool_dir"])
def test_unread_session_fields_are_refused(name):
    """The reference's Session fields that SQL cannot set: SET SESSION
    refuses them in both packages.  Those the port does not read are no
    fields of its Session (passing one is an error); the failure injector
    and the spool directory are, since fault-tolerant execution reads
    them."""
    if name in ("failure_injector", "fte_spool_dir"):
        assert getattr(Session(**{name: 1}), name) == 1
    else:
        with pytest.raises(TypeError):
            Session(**{name: 1})
    ref, port = _runners()
    assert _outcome(port, f"set session {name} = 1") == (
        _outcome(ref, f"set session {name} = 1")) == ("raises", "KeyError")


def test_refresh_plans_the_view_once(monkeypatch):
    """A refresh plans the view's query once: the version vector is read
    from the plan that then runs."""
    import trino_tpu_torch.runner as port_runner

    ref, port = _runners(default_catalog="memory")
    for sql in ("create table s (x bigint)", "insert into s values (1)",
                "create materialized view m as select sum(x) t from s",
                "insert into s values (2)"):
        _same(ref, port, sql)
    plans = []
    orig = port_runner.LogicalPlanner.plan

    def spy(self, stmt):
        plans.append(stmt)
        return orig(self, stmt)

    monkeypatch.setattr(port_runner.LogicalPlanner, "plan", spy)
    _same(ref, port, "refresh materialized view m")
    assert len(plans) == 1
    assert not port.catalog.mv_is_stale("m")
    _same(ref, port, "select * from m")


def test_constructor_arguments_fill_the_session():
    port = StandaloneQueryRunner(default_catalog(SF), device="cpu",
                                 default_catalog_name="memory",
                                 splits_per_node=1, dynamic_filtering=False)
    s = port.session
    assert (s.default_catalog, s.splits_per_node, s.dynamic_filtering) == (
        "memory", 1, False)
    port.execute("set session default_catalog = 'tpch'")
    assert port.execute("select count(*) from nation").rows() == [(25,)]

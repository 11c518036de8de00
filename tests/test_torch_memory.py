"""The port's memory connector, TPC-H staging and write path against the
reference.

- ``MemoryConnector`` gives the reference's split bounds, pruned-batch
  counts and statistics on the same host batches; pinned batches skip the
  zone map (here pinned on the CPU).
- TPC-H staged into ``memory`` (one pinned batch per table, orders and
  lineitem from the device generator) answers Q1, Q3, Q5, Q12, Q18, Q21, R1
  and R2 as the reference does over tables staged as its ``bench.py``
  stages them, and all 24 queries as the port's own tpch path does, through
  the same kernels.
- CREATE TABLE AS, INSERT and DROP TABLE give the reference's row counts
  and rows.

SF 0.01 on the CPU.  The reference is pinned as in test_torch_queries.py.
Rows are exact, doubles to rtol 1e-9 and REAL sums to rtol 1e-4 against
the reference (float32 sums in different orders; see
test_torch_queries_q13_q22.py) and 1e-5 against the port's tpch path (the
same plain scatter-add over batches of other sizes).
"""

import numpy as np
import pytest
import torch

from test_torch_queries import SF, _count_plain_calls, _same_rows
from trino_tpu.connectors import memory as ref_memory
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.connectors.tpch import generate_table_device as ref_generate
from trino_tpu.runner import Session
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu.spi import batch as ref_batch
from trino_tpu.spi import connector as ref_conn
from trino_tpu.spi import predicate as ref_pred
from trino_tpu.spi import types as ref_types
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.connectors.staging import stage_memory_tables
from trino_tpu_torch.connectors.tpch_queries import QUERIES
from trino_tpu_torch.exec.operators import ScanOperator
from trino_tpu_torch.runner import StandaloneQueryRunner
from trino_tpu_torch.spi import batch as port_batch
from trino_tpu_torch.spi import connector as port_conn
from trino_tpu_torch.spi import predicate as port_pred
from trino_tpu_torch.spi import types as port_types
from trino_tpu_torch.caching import result_cache

TPCH_TABLES = ("region", "nation", "supplier", "customer", "part",
               "partsupp", "orders", "lineitem")
R1 = ("select l_linenumber, sum(cast(l_quantity as real)), "
      "sum(cast(l_extendedprice as real)) from lineitem "
      "group by l_linenumber order by l_linenumber")
R2 = ("select l_quantity, sum(cast(l_extendedprice as real)) from lineitem "
      "group by l_quantity order by l_quantity")
SQLS = {**{f"Q{q}": QUERIES[q] for q in sorted(QUERIES)}, "R1": R1,
        "R2": R2}


@pytest.fixture(autouse=True)
def _execution_not_cached():
    """Every statement here executes: a result-cache hit would skip the
    launches, syncs and revocations these tests count."""
    with result_cache.disabled():
        yield


def _pin_reference(monkeypatch):
    monkeypatch.setenv("TRINO_TPU_HASH_IMPL", "sort")
    monkeypatch.setenv("TRINO_TPU_PALLAS", "0")
    monkeypatch.setenv("TRINO_TPU_RESULT_CACHE", "0")
    monkeypatch.setenv("TRINO_TPU_OPTIMIZER", "legacy")


# ---------------------------------------------------------------------------
# the connector against the reference's on the same host batches


def _batches(pkg, n_batches: int) -> list:
    """Seeded batches: column a (BIGINT) in [100 i, 100 i + 100) for batch
    i, d (DATE), s (VARCHAR over a per-batch dictionary), with NULLs in
    d."""
    B, T = (ref_batch, ref_types) if pkg == "ref" else (port_batch,
                                                        port_types)
    rng = np.random.default_rng(7)
    out = []
    for i in range(n_batches):
        n = 40 + 7 * i
        a = rng.integers(100 * i, 100 * i + 100, n).astype(np.int64)
        d = rng.integers(9000, 9400, n).astype(np.int32)
        dv = rng.random(n) > 0.2
        words = np.array(sorted({f"w{j}" for j in range(i, i + 4)}),
                         dtype=object)
        s = rng.integers(0, len(words), n).astype(np.int32)
        out.append(B.ColumnBatch(["a", "d", "s"], [
            B.Column(T.BIGINT, a), B.Column(T.DATE, d, dv),
            B.Column(T.VARCHAR, s, None, words)]))
    return out


def _constraints(P) -> list:
    rng = P.Range
    return [
        P.TupleDomain({"a": P.Domain(P.ValueSet((rng(150, True, 260, False),)),
                                     False)}),
        P.TupleDomain({"a": P.Domain(P.ValueSet.of([5, 420]), False)}),
        P.TupleDomain({"s": P.Domain(P.ValueSet.of(["w0"]), False)}),
        P.TupleDomain({"d": P.Domain(P.ValueSet((rng(9500, True, None,
                                                     False),)), False)}),
        P.TupleDomain({"d": P.Domain(P.ValueSet((rng(9500, True, None,
                                                     False),)), True)}),
        P.TupleDomain({"a": P.Domain(P.ValueSet.none(), False)}),
        P.TupleDomain.all(),
    ]


def _pruned(conn, constraint, n_batches) -> tuple:
    before = conn.batches_pruned
    kept = 0
    for split in conn.get_splits("t", 4, 1):
        src = conn.create_page_source(split, ["a", "s"], constraint=constraint)
        while not src.is_finished():
            kept += src.get_next_batch() is not None
    return conn.batches_pruned - before, kept


def _both(n_batches: int):
    ref = ref_memory.MemoryConnector()
    port = MemoryConnector()
    for conn, pkg, C in ((ref, "ref", ref_conn), (port, "port", port_conn)):
        T = ref_types if pkg == "ref" else port_types
        conn.create_table(C.TableSchema("t", (
            C.ColumnSchema("a", T.BIGINT), C.ColumnSchema("d", T.DATE),
            C.ColumnSchema("s", T.VARCHAR))))
        conn.finish_insert("t", [_batches(pkg, n_batches)])
    return ref, port


@pytest.mark.parametrize("n_batches", [0, 1, 3, 7])
def test_splits_and_statistics_match_reference(n_batches):
    ref, port = _both(n_batches)
    for spn, nodes in ((1, 1), (4, 1), (2, 3), (16, 1)):
        assert ([s.info for s in port.get_splits("t", spn, nodes)]
                == [s.info for s in ref.get_splits("t", spn, nodes)])
    assert (port.get_table_statistics("t").row_count
            == ref.get_table_statistics("t").row_count)
    assert port.data_version("t") == ref.data_version("t") == 2


def test_pruning_matches_reference_and_pinned_batches_skip_it():
    ref, port = _both(7)
    counts = []
    for rc, pc in zip(_constraints(ref_pred), _constraints(port_pred)):
        want, got = _pruned(ref, rc, 7), _pruned(port, pc, 7)
        assert got == want
        counts.append(got[0])
    assert counts == [5, 5, 6, 7, 0, 7, 0]
    # pinned tables: nothing is pruned (the filter above the scan decides)
    ref.pin_to_device("t")
    port.pin_to_device("t", "cpu")
    assert (port.get_table_statistics("t").row_count
            == ref.get_table_statistics("t").row_count)
    for rc, pc in zip(_constraints(ref_pred), _constraints(port_pred)):
        assert _pruned(port, pc, 7) == _pruned(ref, rc, 7) == (0, 7)
    # a batch inserted after pinning is a host batch again
    for conn, pkg in ((ref, "ref"), (port, "port")):
        conn.finish_insert("t", [_batches(pkg, 1)])
    rc, pc = _constraints(ref_pred)[0], _constraints(port_pred)[0]
    assert _pruned(port, pc, 8) == _pruned(ref, rc, 8) == (1, 7)
    assert (port.get_table_statistics("t").row_count
            == ref.get_table_statistics("t").row_count)


def test_scan_hands_device_batches_on_unmasked_and_uncopied():
    """A batch already in device memory skips the host TupleDomain mask and
    is not copied.  The meta device stands in for the card here."""
    port = _both(2)[1]
    constraint = _constraints(port_pred)[5]  # no row can satisfy it
    port.pin_to_device("t", "meta")
    pinned = port._data["t"]
    assert all(b.device.type == "meta" for b in pinned)
    scan = ScanOperator(port, port.get_splits("t", 1, 1), ["s", "a"], "meta",
                        constraint=constraint)
    out = [scan.get_output(), scan.get_output()]
    assert scan.get_output() is None and scan.is_finished()
    for b, p in zip(out, pinned):
        assert b.names == ["s", "a"]
        assert b.columns[1].data is p.column("a").data
    # host batches of the same table are masked on the host as before
    host = _both(2)[1]
    scan = ScanOperator(host, host.get_splits("t", 1, 1), ["a"], "cpu",
                        constraint=_constraints(port_pred)[0])
    rows = [scan.get_output()]
    assert scan.get_output() is None
    assert int(rows[0].num_rows) == int(
        ((rows[0].column("a").data >= 150)
         & (rows[0].column("a").data < 260)).sum())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            host.pin_to_device("t", "cuda")


def test_blackhole_swallows_writes():
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    assert r.execute("create table blackhole.n as select * from tpch.nation"
                     ).rows() == [(25,)]
    assert r.execute("select count(*) from blackhole.n").rows() == [(0,)]


# ---------------------------------------------------------------------------
# staged TPC-H: the port's staging against the reference's


@pytest.fixture(scope="module")
def staged():
    """(catalog, staging info, memory runner, tpch runner) on the CPU."""
    cat = default_catalog(SF)
    info = stage_memory_tables(cat, TPCH_TABLES, "cpu")
    return (cat, info,
            StandaloneQueryRunner(cat, device="cpu",
                                  default_catalog_name="memory",
                                  splits_per_node=1, optimizer="legacy"),
            StandaloneQueryRunner(cat, device="cpu", optimizer="legacy"))


@pytest.fixture(scope="module")
def ref_staged_catalog():
    """The reference catalog staged as its bench.py stages it
    (_stage_memory_tables): device generation for orders / lineitem, the
    host page source for the rest, one batch per table, pinned."""
    cat = ref_catalog(scale_factor=SF)
    tpch, mem = cat.connector("tpch"), cat.connector("memory")
    for t in TPCH_TABLES:
        schema = tpch.get_table_schema(t)
        cols = schema.column_names()
        batch = ref_generate(tpch, t, cols)
        if batch is None:
            batches = []
            for s in tpch.get_splits(t, 4, 1):
                src = tpch.create_page_source(s, cols)
                while not src.is_finished():
                    b = src.get_next_batch()
                    if b is not None:
                        batches.append(b)
            batch = ref_batch.ColumnBatch.concat(batches)
        mem.create_table(ref_conn.TableSchema(t, schema.columns))
        mem.finish_insert(t, [[batch]])
        mem.pin_to_device(t)
    return cat


def test_staging_info(staged):
    cat, info, _, _ = staged
    tpch, mem = cat.connector("tpch"), cat.connector("memory")
    assert set(info) == set(TPCH_TABLES)
    for t, v in info.items():
        assert v["route"] == ("device" if t in ("orders", "lineitem")
                              else "host + pin")
        assert v["rows"] == tpch.row_count(t)
        assert mem.get_table_statistics(t).row_count == v["rows"]
        assert len(mem.get_splits(t, 1, 1)) == 1
    # lineitem: 8 int64 + 8 int32 columns
    assert info["lineitem"]["bytes"] == info["lineitem"]["rows"] * 96


@pytest.mark.parametrize("name", ["Q1", "Q3", "Q5", "Q12", "Q18", "Q21",
                                  "R1", "R2"])
def test_staged_queries_match_reference(staged, ref_staged_catalog,
                                        monkeypatch, name):
    _pin_reference(monkeypatch)
    ref = RefRunner(ref_staged_catalog, session=Session(
        default_catalog="memory", splits_per_node=1))
    got = staged[2].execute(SQLS[name]).rows()
    _same_rows(got, ref.execute(SQLS[name]).rows(),
               rel_tol=1e-4 if name in ("R1", "R2") else 1e-9)


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_staged_plans_match_tpch_plans(staged, q):
    """Staged tables carry the generator's statistics, so each query plans
    as over the tpch connector.  With row counts alone, Q5 joined customer
    on nationkey before orders: at SF 1 a 6 M x 6 k pair expansion that
    asked the card for 54 GiB.  Held under both optimizers."""
    cat, _, mem, tp = staged
    assert (mem.explain(QUERIES[q]).replace("memory.", "tpch.")
            == tp.explain(QUERIES[q]))
    mem = StandaloneQueryRunner(cat, device="cpu",
                                default_catalog_name="memory",
                                splits_per_node=1, optimizer="iterative")
    tp = StandaloneQueryRunner(cat, device="cpu", optimizer="iterative")
    assert (mem.explain(QUERIES[q]).replace("memory.", "tpch.")
            == tp.explain(QUERIES[q]))


# kernels each query must reach on either path (plain versions on the CPU)
REQUIRED = {"Q3": ["insert"], "Q12": ["probe"], "Q18": ["insert"],
            "Q21": ["insert", "probe"], "R1": ["segment_sum"],
            "R2": ["segment_sum"]}


@pytest.mark.parametrize("name", list(SQLS))
def test_staged_path_matches_tpch_path(staged, monkeypatch, name):
    _, _, mem, tp = staged
    calls = _count_plain_calls(monkeypatch)
    want = tp.execute(SQLS[name]).rows()
    tp_calls = dict(calls)
    got = mem.execute(SQLS[name]).rows()
    staged_calls = {k: calls[k] - tp_calls[k] for k in calls}
    for k in REQUIRED.get(name, []):
        assert tp_calls[k] > 0 and staged_calls[k] > 0, (k, calls)
    _same_rows(got, want,
               rel_tol=1e-5 if name in ("R1", "R2") else 1e-9)


def test_host_scan_after_staging_is_unchanged():
    sql = ("select o_orderkey, o_orderstatus, o_clerk, o_comment, "
           "o_orderpriority from tpch.orders order by o_orderkey")
    cat = default_catalog(SF)
    r = StandaloneQueryRunner(cat, device="cpu")
    before = r.execute(sql).rows()
    stage_memory_tables(cat, ["orders"], "cpu")
    assert r.execute(sql).rows() == before
    assert r.execute(sql.replace("tpch.", "memory.")).rows() == before


# ---------------------------------------------------------------------------
# the write path against the reference


WRITES = [
    "create table memory.li as select * from tpch.lineitem",
    "select count(*), sum(l_extendedprice), min(l_shipdate), max(l_comment) "
    "from memory.li",
    "insert into memory.li select * from tpch.lineitem "
    "where l_orderkey <= 100",
    "select l_returnflag, l_linestatus, count(*), sum(l_quantity) "
    "from memory.li group by l_returnflag, l_linestatus order by 1, 2",
    "create table memory.t (k bigint, p varchar)",
    "insert into memory.t select o_orderkey, o_orderpriority from tpch.orders "
    "where o_orderkey < 40",
    "select p, count(*), max(k) from memory.t group by p order by p",
    "create table memory.j as select o_orderpriority, count(*) as n "
    "from memory.li join tpch.orders on l_orderkey = o_orderkey "
    "group by o_orderpriority",
    "select * from memory.j order by o_orderpriority",
    "drop table memory.li",
    "drop table if exists memory.li",
    "select count(*) from memory.t",
]


def test_ctas_insert_drop_match_reference(monkeypatch):
    _pin_reference(monkeypatch)
    ref = RefRunner(ref_catalog(SF))
    port = StandaloneQueryRunner(default_catalog(SF), device="cpu",
                                 optimizer="legacy")
    for sql in WRITES:
        _same_rows(port.execute(sql).rows(), ref.execute(sql).rows())
    assert port.catalog.connector("memory").list_tables() == ["j", "t"]
    with pytest.raises(KeyError):
        port.execute("select count(*) from memory.li")
    with pytest.raises(KeyError):
        port.execute("drop table memory.li")

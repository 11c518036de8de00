"""The port's fault-tolerant execution (execution/fte.py,
durable_spool.py, failure_injector.py) against the reference.

The reference's tests/test_fte.py cases run on the port
(``retry_policy="TASK"``: stage by stage over the durable spool with task
retry, injected failures, the speculative twin, memory-aware retry).
Then parity: for the same batches the spool's part files are
byte-identical to the reference's, and each package reads the other's
committed directories; FTE rows equal the streaming rows and the
reference's FTE rows, with and without injected failures (a task body, an
upstream read, a corrupted part file, an out-of-memory attempt).  Rows
are exact (the REAL sums of R1 within 1e-4, as
tests/test_torch_distributed.py holds them).  The spool and the
query-state log live in a temporary directory per module.
"""

import os
import threading

import numpy as np
import pytest
import torch

from test_torch_distributed import _same
from test_torch_queries_q13_q22 import R1
from trino_tpu.caching import result_cache as ref_result_cache
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.execution import durable_spool as RS
from trino_tpu.execution import failure_injector as RFI
from trino_tpu.execution.distributed_runner import (
    DistributedQueryRunner as RefDist)
from trino_tpu.execution.task import PartitionedOutputSink as RefSink
from trino_tpu.runner import Session as RefSession
from trino_tpu_torch.caching import result_cache
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.tpch_queries import QUERIES
from trino_tpu_torch.execution import durable_spool as PS
from trino_tpu_torch.execution import fte as fte_mod
from trino_tpu_torch.execution.distributed_runner import (
    DistributedQueryRunner)
from trino_tpu_torch.execution.failure_injector import (
    GET_RESULTS_FAILURE, SPOOL_CORRUPTION, TASK_FAILURE, TASK_OOM,
    TASK_STALL, FailureInjector)
from trino_tpu_torch.execution.fte import TaskFailure
from trino_tpu_torch.execution.task import PartitionedOutputSink
from trino_tpu_torch.runner import Session, StandaloneQueryRunner
from trino_tpu_torch.testing.oracle import (SqliteOracle, assert_same_rows,
                                            load_tables)

SF = 0.01
TABLES = ["nation", "region", "customer", "orders", "lineitem", "supplier"]
PINS = (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
        ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
        ("TRINO_TPU_OPTIMIZER", "iterative"))


@pytest.fixture(autouse=True)
def _pin(monkeypatch, tmp_path_factory):
    for k, v in PINS:
        monkeypatch.setenv(k, v)
    base = tmp_path_factory.getbasetemp()
    monkeypatch.setenv("TRINO_TPU_SPOOL_DIR", str(base / "spool"))
    monkeypatch.setenv("TRINO_TPU_QUERY_STATE_DIR", str(base / "state"))
    with result_cache.disabled(), ref_result_cache.disabled():
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FlakyConnector:
    """Delegates to a real connector but fails page-source creation the
    first ``failures`` times (simulating task crashes)."""

    name = "tpch"

    def __init__(self, inner, failures: int):
        self._inner = inner
        self._remaining = failures
        self._lock = threading.Lock()
        self.injected = 0

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def create_page_source(self, split, columns, constraint=None):
        with self._lock:
            if self._remaining > 0:
                self._remaining -= 1
                self.injected += 1
                raise RuntimeError("injected task failure")
        return self._inner.create_page_source(split, columns, constraint)


def _flaky_catalog(failures: int):
    catalog = default_catalog(SF)
    flaky = FlakyConnector(catalog.connector("tpch"), failures)
    catalog.register("tpch", flaky)
    return catalog, flaky


@pytest.fixture(scope="module")
def oracle():
    return load_tables(SqliteOracle(),
                       default_catalog(SF).connector("tpch"), TABLES)


def _fte(workers=3, catalog=None, **kw):
    return DistributedQueryRunner(
        catalog if catalog is not None else default_catalog(SF),
        worker_count=workers, device="cpu",
        session=Session(node_count=workers, retry_policy="TASK", **kw))


# ------------------------------------------------------- the reference's
def test_fte_matches_streaming(oracle):
    fte = _fte()
    for q in (1, 3, 6):
        assert_same_rows(fte.execute(QUERIES[q]).rows(),
                         oracle.query(QUERIES[q]), ordered=q in (1, 3))


def test_fte_survives_injected_failures(oracle):
    catalog, flaky = _flaky_catalog(failures=3)
    fte = _fte(catalog=catalog, task_retry_attempts=3)
    sql = ("select l_returnflag, count(*), sum(l_quantity) from lineitem "
           "group by l_returnflag")
    assert_same_rows(fte.execute(sql).rows(), oracle.query(sql))
    assert flaky.injected == 3


def test_streaming_scheduler_dies_without_retry():
    catalog, _ = _flaky_catalog(failures=1)
    streaming = DistributedQueryRunner(catalog, worker_count=3, device="cpu",
                                       session=Session(node_count=3))
    with pytest.raises(RuntimeError, match="injected"):
        streaming.execute("select count(*) from lineitem")


def test_fte_gives_up_after_attempts():
    catalog, _ = _flaky_catalog(failures=1000)
    fte = _fte(workers=2, catalog=catalog, task_retry_attempts=1)
    with pytest.raises(TaskFailure, match="failed after"):
        fte.execute("select count(*) from lineitem")


def test_fte_with_serde_and_joins(oracle):
    fte = _fte(exchange_serde=True)
    sql = ("select c_mktsegment, count(*) from customer, orders "
           "where c_custkey = o_custkey group by c_mktsegment")
    assert_same_rows(fte.execute(sql).rows(), oracle.query(sql))


def test_engine_failure_injector_task_and_reads():
    inj = FailureInjector()
    inj.inject(TASK_FAILURE, task_index=0, attempt=0, times=2)
    inj.inject(GET_RESULTS_FAILURE, task_index=1, attempt=0, times=2)
    catalog = default_catalog(SF)
    dist = _fte(catalog=catalog, failure_injector=inj)
    sql = QUERIES[3]
    with result_cache.disabled():
        expected = StandaloneQueryRunner(catalog, device="cpu").execute(
            sql).rows()
    assert_same_rows(dist.execute(sql).rows(), expected, ordered=True)
    assert any(r.fired for r in inj.rules)


def test_durable_spool_survives_on_disk(tmp_path, monkeypatch):
    seen = []
    orig = fte_mod.make_spool_root

    def spy(base=None):
        d = orig(str(tmp_path))
        seen.append(d)
        return d

    monkeypatch.setattr(fte_mod, "make_spool_root", spy)
    checks = []
    dist = _fte(workers=2)
    orig_attempt = DistributedQueryRunner.fte_run_attempt

    def spy_attempt(self, *a, **kw):
        path = orig_attempt(self, *a, **kw)
        parts = [p for p in os.listdir(path) if p.startswith("part-")]
        checks.append(sum(os.path.getsize(os.path.join(path, p))
                          for p in parts))
        return path

    monkeypatch.setattr(DistributedQueryRunner, "fte_run_attempt",
                        spy_attempt)
    dist.execute("select count(*) from lineitem")
    assert seen and checks and any(nb > 0 for nb in checks)
    assert not os.path.exists(seen[0])


def test_fte_speculative_beats_straggler():
    import time

    inj = FailureInjector()
    inj.inject(TASK_STALL, task_index=0, attempt=0, times=2, stall_s=30.0)
    catalog = default_catalog(SF)
    dist = _fte(catalog=catalog, failure_injector=inj,
                fte_speculative_delay_s=0.1)
    dist.session.fte_events = []
    sql = ("select o_orderpriority, count(*) c from orders "
           "group by o_orderpriority order by 1")
    with result_cache.disabled():
        expected = StandaloneQueryRunner(catalog, device="cpu").execute(
            sql).rows()
    t0 = time.perf_counter()
    rows = dist.execute(sql).rows()
    assert rows == expected
    assert time.perf_counter() - t0 < 25.0
    events = dist.session.fte_events
    assert "speculative_start" in [e[0] for e in events]
    assert any(e[0] == "commit" and e[3] == "SPECULATIVE" for e in events)


def test_fte_memory_aware_retry():
    inj = FailureInjector()
    inj.inject(TASK_OOM, task_index=0, attempt=0, times=1)
    catalog = default_catalog(SF)
    dist = _fte(workers=2, catalog=catalog, failure_injector=inj)
    dist.session.fte_events = []
    sql = "select count(*), sum(o_totalprice) from orders"
    with result_cache.disabled():
        expected = StandaloneQueryRunner(catalog, device="cpu").execute(
            sql).rows()
    assert dist.execute(sql).rows() == expected
    mem = [e for e in dist.session.fte_events if e[0] == "memory_retry"]
    assert mem and mem[0][3] == 2.0


def test_fte_memory_multiplier_reaches_planner(monkeypatch, tmp_path):
    import trino_tpu_torch.execution.distributed_runner as dr

    seen = []
    orig = dr.LocalPlanner

    class SpyPlanner(orig):
        def __init__(self, *a, **kw):
            seen.append(kw.get("hbm_limit_bytes"))
            super().__init__(*a, **kw)

    monkeypatch.setattr(dr, "LocalPlanner", SpyPlanner)
    runner = _fte(workers=2, hbm_limit_bytes=1 << 20)
    frag = runner.create_subplan("select count(*) from nation") \
        .all_fragments()[0]
    runner.fte_run_attempt(frag, 0, 1, 1, {}, str(tmp_path), 0, None,
                           memory_multiplier=4.0)
    assert (1 << 22) in seen


# ----------------------------------------------------- parity: the spool
def _scan_batches(pkg: str, table: str):
    """The table's batches as each package's tpch connector makes them."""
    cat = default_catalog(SF) if pkg == "port" else ref_catalog(
        scale_factor=SF)
    conn = cat.connector("tpch")
    cols = conn.get_table_schema(table).column_names()
    out = []
    for s in conn.get_splits(table, 2, 1):
        src = conn.create_page_source(s, cols)
        while not src.is_finished():
            b = src.get_next_batch()
            if b is not None and b.num_rows:
                out.append(b)
    return out


def _write(pkg: str, root: str, batches, kind: str, nparts: int,
           keys=()):
    mod, Sink = (PS, PartitionedOutputSink) if pkg == "port" else \
        (RS, RefSink)
    os.makedirs(root, exist_ok=True)
    w = mod.DurableSpoolWriter(root, 0, nparts)
    sink = Sink(w, kind, keys, serde=True)
    for b in batches:
        sink.add_input(b)
    sink.finish_input()
    w.set_finished()
    return w.committed


@pytest.mark.parametrize("table,kind,keys", [
    ("orders", "REPARTITION", (0,)), ("customer", "GATHER", ()),
    ("lineitem", "REPARTITION", (0, 3)), ("nation", "BROADCAST", ())])
def test_spool_part_files_match_reference(tmp_path, table, kind, keys):
    """The same batches spool to byte-identical part files, and each
    package reads the other's committed directory to the same rows."""
    nparts = 3
    mine = _write("port", str(tmp_path / "p"), _scan_batches("port", table),
                  kind, nparts, keys)
    theirs = _write("ref", str(tmp_path / "r"), _scan_batches("ref", table),
                    kind, nparts, keys)
    for p in range(nparts):
        a = open(os.path.join(mine, f"part-{p}.bin"), "rb").read()
        b = open(os.path.join(theirs, f"part-{p}.bin"), "rb").read()
        assert a == b and len(a) > 4 or kind == "GATHER" and p
    for p in range(nparts):
        got = [r for pg in _pages(PS.DurableSpoolClient([theirs], p))
               for r in pg.to_pylist()]
        want = [tuple(r) for pg in _pages(RS.DurableSpoolClient([mine], p))
                for r in pg.to_pylist()]
        assert got == want


def _pages(client):
    out = []
    while True:
        pg = client.poll()
        if pg is None:
            return out
        out.append(pg)


def test_spool_reads_land_on_the_client_device(tmp_path):
    """A client given a device moves every decoded page there (the
    consuming task's device); ``meta`` stands in for the card here."""
    d = _write("port", str(tmp_path / "p"), _scan_batches("port", "nation"),
               "GATHER", 1)
    pages = _pages(PS.DurableSpoolClient([d], 0, device="meta"))
    assert pages and all(c.device.type == "meta"
                         for pg in pages for c in pg.columns)


# ----------------------------------------- parity: rows under failures
def _ref_fte(inj=None):
    return RefDist(ref_catalog(scale_factor=SF), worker_count=3,
                   session=RefSession(node_count=3, retry_policy="TASK",
                                      failure_injector=inj))


FAULTS = {
    "none": [],
    "task": [(TASK_FAILURE, dict(fragment_id=1, task_index=0, attempt=0))],
    "read": [(GET_RESULTS_FAILURE, dict(task_index=1, attempt=0))],
    "corrupt": [(SPOOL_CORRUPTION, dict(task_index=0, attempt=0))],
    "oom": [(TASK_OOM, dict(task_index=1, attempt=0))],
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name,sql,ordered", [
    ("Q3", QUERIES[3], True), ("Q12", QUERIES[12], True), ("R1", R1, True)])
def test_fte_rows_match_streaming_and_reference(name, sql, ordered, fault):
    inj, rinj = FailureInjector(), RFI.FailureInjector()
    for kind, kw in FAULTS[fault]:
        inj.inject(kind, **kw)
        rinj.inject(kind, **kw)
    fte = _fte(failure_injector=inj)
    fte.session.fte_events = []
    got = fte.execute(sql).rows()
    streaming = DistributedQueryRunner(default_catalog(SF), worker_count=3,
                                       device="cpu",
                                       session=Session(node_count=3))
    tol = 1e-4 if name == "R1" else 1e-9
    _same(got, streaming.execute(sql).rows(), ordered, tol)
    want = [tuple(r) for r in _ref_fte(rinj).execute(sql).batch.to_pylist()]
    _same(got, want, ordered, tol)
    if fault != "none":
        assert any(r.fired for r in inj.rules), fault
    if fault == "oom":
        assert [e for e in fte.session.fte_events if e[0] == "memory_retry"]
    if fault == "corrupt":
        assert [e for e in fte.session.fte_events
                if e[0] == "spool_corruption"]

"""The port's system connector and query journal held to the reference:
the eight system tables have the reference's schemas and standalone
contents, ``runtime.coordinators`` is the reference's on a distributed
runner, under ``TRINO_TPU_HA_NODE_ID`` and over an HA fleet directory, a
journal written by either package is read by the other's
``system.runtime.query_history`` with equal rows, and the journal's
rotation, torn-tail handling and kill switch behave as in
tests/test_journal.py.  Every run gets fresh caches and a journal in
``tmp_path``, in both packages."""

import json
import os
import time
from collections import deque

import pytest

from trino_tpu import caching as ref_caching
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.connectors.system import SystemConnector as RefSystem
from trino_tpu.execution.distributed_runner import (
    DistributedQueryRunner as RefDistributed)
from trino_tpu.runner import Session as RefSession
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu.telemetry import journal as ref_journal
from trino_tpu.telemetry import runtime as ref_rt

from trino_tpu_torch import caching
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.system import SystemConnector
from trino_tpu_torch.execution.distributed_runner import (
    DistributedQueryRunner)
from trino_tpu_torch.runner import Session, StandaloneQueryRunner
from trino_tpu_torch.spi.eventlistener import QueryCompletedEvent
from trino_tpu_torch.telemetry import journal
from trino_tpu_torch.telemetry import runtime as rt

SF = 0.01
TABLES = ("metrics.counters", "runtime.caches", "runtime.coordinators",
          "runtime.queries", "runtime.query_history",
          "runtime.resource_groups", "runtime.tasks", "runtime.workers")


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    """tests/test_caching.py's fresh-cache fixture, for both packages."""
    monkeypatch.setenv("TRINO_TPU_JOURNAL_DIR", str(tmp_path / "journal"))
    for knob in ("TRINO_TPU_PLAN_CACHE", "TRINO_TPU_RESULT_CACHE",
                 "TRINO_TPU_JOURNAL", "TRINO_TPU_HA", "TRINO_TPU_HA_DIR"):
        monkeypatch.delenv(knob, raising=False)
    for k, v in (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
                 ("TRINO_TPU_HBO", "0"), ("TRINO_TPU_OPTIMIZER", "iterative")):
        monkeypatch.setenv(k, v)
    for pkg_caching, pkg_journal in ((caching, journal),
                                     (ref_caching, ref_journal)):
        pkg_caching.reset_for_test()
        pkg_journal.reset_for_test()
    yield
    for pkg_caching, pkg_journal in ((caching, journal),
                                     (ref_caching, ref_journal)):
        pkg_caching.reset_for_test()
        pkg_journal.reset_for_test()


# ---------------------------------------------------------------------------
# the tables


def test_the_eight_tables_are_the_references():
    assert SystemConnector().list_tables() == list(TABLES) == \
        RefSystem().list_tables()


@pytest.mark.parametrize("table", TABLES)
def test_table_schema_is_the_references(table):
    port = SystemConnector().get_table_schema(table)
    ref = RefSystem().get_table_schema(table)
    assert port.name == ref.name
    assert [(c.name, str(c.type)) for c in port.columns] == \
        [(c.name, str(c.type)) for c in ref.columns]


def test_default_catalog_registers_system():
    cat = default_catalog(SF)
    assert "system" in cat.names()
    conn = cat.connector("system")
    assert conn.data_version("runtime.queries") is None  # never cached
    r = StandaloneQueryRunner(cat, device="cpu")
    assert conn._runner() is r


@pytest.mark.parametrize("table", ["runtime.tasks", "runtime.workers",
                                   "runtime.resource_groups"])
def test_distributed_feeds_are_empty_for_a_standalone_runner(table,
                                                            monkeypatch):
    # the task registry is process-wide in both packages, and distributed
    # runners of other test files in this process record tasks into it:
    # start both empty, so the count is what the standalone runners add
    for runtime in (rt, ref_rt):
        monkeypatch.setattr(runtime, "_TASKS",
                            deque(maxlen=runtime._TASKS.maxlen))
    port = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    ref = RefRunner(ref_catalog(SF))
    got = port.execute(f"select count(*) from system.{table}").rows()
    assert got == ref.execute(
        f"select count(*) from system.{table}").rows() == [(0,)]


def test_one_local_coordinator():
    port = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    ref = RefRunner(ref_catalog(SF))
    sql = ("select state, lease_age_ms, in_flight_queries, url "
           "from system.runtime.coordinators")
    assert port.execute(sql).rows() == ref.execute(sql).rows() == \
        [("ACTIVE", 0.0, 0, "")]
    (name,), = port.execute(
        "select coordinator from system.runtime.coordinators").rows()
    assert name.startswith("coord-") and name.endswith(f"-{os.getpid()}")


COORDINATOR_SQL = ("select state, lease_age_ms, in_flight_queries, url "
                   "from system.runtime.coordinators")


def test_local_coordinator_counts_the_dispatchers_queries():
    """On a distributed runner the statement itself is a dispatcher query
    RUNNING on the one local coordinator: the reference counts it."""
    port = DistributedQueryRunner(default_catalog(SF), worker_count=2,
                                  session=Session(node_count=2),
                                  device="cpu")
    ref = RefDistributed(ref_catalog(SF), worker_count=2,
                         session=RefSession(node_count=2))
    assert port.execute(COORDINATOR_SQL).rows() == \
        ref.execute(COORDINATOR_SQL).rows() == [("ACTIVE", 0.0, 1, "")]


def test_local_coordinator_is_named_by_the_node_id(monkeypatch):
    monkeypatch.setenv("TRINO_TPU_HA_NODE_ID", "coord-x")
    port = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    ref = RefRunner(ref_catalog(SF))
    sql = "select coordinator from system.runtime.coordinators"
    assert port.execute(sql).rows() == ref.execute(sql).rows() == \
        [("coord-x",)]


def test_fleet_rows_are_the_references(tmp_path, monkeypatch):
    """With TRINO_TPU_HA=1 and a fleet directory both packages list the
    fleet's leases: the live one, the expired one, their in-flight counts
    and urls."""
    root = tmp_path / "ha" / "coordinators"
    root.mkdir(parents=True)
    now = time.time()
    for nid, age_s, in_flight in (("coord-a", 0.0, 2), ("coord-b", 60.0, 0)):
        with open(root / f"{nid}.json", "w", encoding="utf-8") as f:
            json.dump({"node_id": nid, "url": f"http://{nid}:1", "pid": 1,
                       "epoch": 1.0, "ts": now - age_s, "state": "ACTIVE",
                       "in_flight": in_flight}, f)
    monkeypatch.setenv("TRINO_TPU_HA", "1")
    monkeypatch.setenv("TRINO_TPU_HA_DIR", str(tmp_path / "ha"))
    monkeypatch.setenv("TRINO_TPU_HA_LEASE_TTL_S", "30")
    sql = ("select coordinator, state, in_flight_queries, url, lease_age_ms "
           "from system.runtime.coordinators order by coordinator")
    port = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    ref = RefRunner(ref_catalog(SF))
    got = port.execute(sql).rows()
    want = ref.execute(sql).rows()
    assert [r[:4] for r in got] == [r[:4] for r in want] == [
        ("coord-a", "ACTIVE", 2, "http://coord-a:1"),
        ("coord-b", "EXPIRED", 0, "http://coord-b:1")]
    for g, w in zip(got, want):  # ages read a few ms apart
        assert abs(g[4] - w[4]) < 5000.0


def test_queries_table_sees_itself_running():
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    r.execute("select count(*) from region", query_id="q_done")
    rows = r.execute("select query_id, state, output_rows, input_rows, "
                     "sql from system.runtime.queries",
                     query_id="q_self").rows()
    by_id = {row[0]: row for row in rows}
    assert by_id["q_done"][1:4] == ("FINISHED", 1, 5)
    assert by_id["q_self"][1:3] == ("RUNNING", -1)


def test_metrics_counters_flatten_distributions():
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    r.execute("select count(*) from nation")
    rows = r.execute("select name, kind, value from system.metrics.counters"
                     ).rows()
    by_name = {name: (kind, value) for name, kind, value in rows}
    assert by_name["trino_scan_rows_total"][0] == "counter"
    assert by_name["trino_scan_rows_total"][1] >= 25
    for suffix in ("count", "sum", "p50", "p90", "p99"):
        assert by_name[f"trino_query_wall_seconds_{suffix}"][0] == \
            "distribution"


def test_caches_table_rows_equal_the_tiers_stats():
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    for _ in range(2):
        r.execute("select count(*) from region")
    rows = r.execute("select tier, name, entries, bytes, hits, misses, "
                     "evictions, invalidations from system.runtime.caches"
                     ).rows()
    want = caching.cache_rows(per_exec_cache=True)
    assert [row[:2] for row in rows] == [(w["tier"], w["name"]) for w in want]
    plan, result = rows[0], rows[-1]
    keys = ("entries", "bytes", "hits", "misses", "evictions",
            "invalidations")
    assert plan[2:] == tuple(want[0][k] for k in keys)
    assert result[2:] == tuple(want[-1][k] for k in keys)
    assert result[4] == 1 and result[3] == 8  # one hit; one BIGINT row


def test_system_reads_are_never_result_cached():
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    sql = "select count(*) from system.runtime.queries"
    a = r.execute(sql).rows()[0][0]
    b = r.execute(sql).rows()[0][0]
    assert b == a + 1  # the second read sees the first
    assert caching.result_cache.stats()["entries"] == 0


# ---------------------------------------------------------------------------
# the journal across packages


HISTORY = ("select query_id, state, user, sql, fingerprint, output_rows, "
           "input_rows, error, error_code from system.runtime.query_history")
WORKLOAD = ("select count(*) from region",
            "select n_regionkey, count(*) from nation group by n_regionkey",
            "select 1 / 0")


def _run_workload(runner, prefix: str) -> None:
    for i, sql in enumerate(WORKLOAD):
        try:
            runner.execute(sql, query_id=f"{prefix}_{i}")
        except Exception:  # noqa: BLE001 — the failure is journaled
            pass


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_journal(writer):
    port = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    ref = RefRunner(ref_catalog(SF))
    _run_workload(port if writer == "port" else ref, writer)
    port_rows = sorted(r for r in port.execute(HISTORY).rows()
                       if r[0].startswith(writer))
    ref_rows = sorted(r for r in ref.execute(HISTORY).rows()
                      if r[0].startswith(writer))
    assert port_rows == ref_rows
    assert [r[1] for r in port_rows] == ["FINISHED", "FINISHED", "FAILED"]
    assert port_rows[0][5] == 1 and port_rows[1][5] == 5
    assert port_rows[2][8] == "DIVISION_BY_ZERO"
    assert port_rows[0][4] == rt.fingerprint(WORKLOAD[0])


def test_records_are_the_references_json(tmp_path):
    """One event through each package's journal gives the same JSON
    record, field for field (timestamps aside)."""
    ev = dict(state="FINISHED", user="u", wall_ms=1.5, output_rows=7,
              cpu_ms=0.5, peak_memory_bytes=1 << 20, input_rows=10,
              input_bytes=100, queued_time_ms=0.25, end_time=1.7e9)
    from trino_tpu.spi.eventlistener import QueryCompletedEvent as RefEvent

    pj = journal.QueryJournal(directory=str(tmp_path / "p"))
    rj = ref_journal.QueryJournal(directory=str(tmp_path / "r"))
    pj.query_completed(QueryCompletedEvent("q", "SELECT 2", **ev))
    rj.query_completed(RefEvent("q", "SELECT 2", **ev))
    assert os.path.basename(pj.path) == os.path.basename(rj.path)
    with open(pj.path) as f, open(rj.path) as g:
        assert json.loads(f.read()) == json.loads(g.read())
    assert journal.SCHEMA_VERSION == ref_journal.SCHEMA_VERSION == 2
    strip = [{k: v for k, v in r.items() if k != "ts"}
             for r in journal.sample_records()]
    assert strip == [{k: v for k, v in r.items() if k != "ts"}
                     for r in ref_journal.sample_records()]


def test_history_survives_a_restart():
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    r.execute("select count(*) from region", query_id="q_before")
    journal.reset_for_test()  # the in-process stand-in for a restart
    r2 = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    rows = r2.execute("select query_id, output_rows "
                      "from system.runtime.query_history").rows()
    assert ("q_before", 1) in rows


def _completed(qid: str, sql: str = "SELECT 1", **kw):
    return QueryCompletedEvent(qid, sql, state="FINISHED", user="test", **kw)


def test_rotation_keeps_size_and_file_count_bounded(tmp_path):
    j = journal.QueryJournal(directory=str(tmp_path / "j"),
                             max_bytes=2048, max_files=2)
    for i in range(200):
        j.query_completed(_completed(f"q_{i}"))
    files = j.files()
    assert len(files) <= 3  # current + 2 rotated generations
    for f in files:
        # one record of slack: rotation triggers when a write would overflow
        assert os.path.getsize(f) <= 2048 + 600
    ids = [r["query_id"] for r in j.read()]
    assert "q_199" in ids and "q_0" not in ids
    assert ids == sorted(ids, key=lambda s: int(s.split("_")[1]))
    # the reference reads the rotated set the same way
    rj = ref_journal.QueryJournal(directory=str(tmp_path / "j"),
                                  max_bytes=2048, max_files=2)
    assert rj.read() == j.read()


def test_a_writer_follows_a_rotation_by_another(tmp_path):
    """Two writers on one directory (two runners' processes): the one that
    did not rotate appends to the new file, not to the rotated one, and
    no record is lost or torn."""
    a = journal.QueryJournal(directory=str(tmp_path / "j"),
                             max_bytes=1500, max_files=5)
    b = journal.QueryJournal(directory=str(tmp_path / "j"),
                             max_bytes=1500, max_files=5)
    for i in range(12):
        (a if i % 3 else b).query_completed(_completed(f"q_{i}"))
    assert len(a.files()) > 1  # rotated at least once
    ids = [r["query_id"] for r in a.read()]
    assert ids == [f"q_{i}" for i in range(12)]
    a.close()
    b.close()
    rj = ref_journal.QueryJournal(directory=str(tmp_path / "j"),
                                  max_bytes=1500, max_files=5)
    assert rj.read() == a.read()


def test_torn_tail_and_garbage_lines_are_skipped(tmp_path):
    j = journal.QueryJournal(directory=str(tmp_path / "j"))
    j.query_completed(_completed("q_good"))
    with open(j.path, "a", encoding="utf-8") as f:
        f.write("not json at all\n")
        f.write('{"schema": 1, "event": "query_completed", "query_id":')
    # a crash mid-write: the next writer must not append onto the torn line
    j2 = journal.QueryJournal(directory=str(tmp_path / "j"))
    j2.query_completed(_completed("q_after"))
    assert [r["query_id"] for r in j2.read()] == ["q_good", "q_after"]
    rj = ref_journal.QueryJournal(directory=str(tmp_path / "j"))
    assert [r["query_id"] for r in rj.read()] == ["q_good", "q_after"]


def test_disabled_journal_returns_none(monkeypatch):
    monkeypatch.setenv("TRINO_TPU_JOURNAL", "0")
    journal.reset_for_test()
    assert journal.get_journal() is None
    assert journal.history() == []
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    r.execute("select count(*) from region")
    assert r.execute("select count(*) from system.runtime.query_history"
                     ).rows() == [(0,)]


def test_seeded_peak_reads_finished_runs(tmp_path):
    j = journal.get_journal()
    j.query_completed(_completed("q_a", "select * from big",
                                 peak_memory_bytes=3 << 20))
    j.query_completed(_completed("q_b", "SELECT * FROM big",
                                 peak_memory_bytes=5 << 20))
    assert journal.seeded_peak(rt.fingerprint("select * from big")) == \
        5 << 20
    assert journal.seeded_peak("unknown") == 0

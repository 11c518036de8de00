"""The port's statement server against the reference's: ``POST
/v1/statement`` with nextUri paging, ``DELETE``, the GET routes, the
client, the dispatcher's boot recovery from the query-state WAL, and the
``/v1/metrics`` endpoints of the server and a worker.

Both servers run in this process over standalone runners on the same
SF 0.01 catalog (the port's on ``device="cpu"``, the reference pinned to
its sort path); a statement's payloads, page by page, must be equal apart
from the query id each server mints.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import pytest
import torch

from trino_tpu.caching import result_cache as ref_result_cache
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.execution import query_state as ref_query_state
from trino_tpu.execution import spool_gc as ref_spool_gc
from trino_tpu.execution.distributed_runner import (
    DistributedQueryRunner as RefDist)
from trino_tpu.runner import Session as RefSession
from trino_tpu.runner import StandaloneQueryRunner as RefStandalone
from trino_tpu.server import TrinoTpuServer as RefServer
from trino_tpu.server import protocol as ref_protocol
from trino_tpu_torch.caching import result_cache
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.execution import query_state, spool_gc
from trino_tpu_torch.execution.distributed_runner import (
    DistributedQueryRunner)
from trino_tpu_torch.execution.failure_injector import (TASK_FAILURE,
                                                        FailureInjector)
from trino_tpu_torch.execution.worker import TaskServer
from trino_tpu_torch.runner import Session, StandaloneQueryRunner
from trino_tpu_torch.server import Client, QueryDispatcher, TrinoTpuServer
from trino_tpu_torch.server import protocol
from trino_tpu_torch.server.client import QueryFailed

SF = 0.01
PINS = (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
        ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
        ("TRINO_TPU_OPTIMIZER", "iterative"))

STATEMENTS = [
    "select n_regionkey, count(*) as c from nation group by n_regionkey "
    "order by n_regionkey",
    "select o_orderdate, o_totalprice from orders where o_orderkey = 1",
    "select l_orderkey, l_linenumber, l_discount, l_shipdate from lineitem "
    "order by l_orderkey, l_linenumber limit 5000",
    "select cast(null as double) / 0e0 as x, 0e0 / 0e0 as nan, "
    "cast(1.5 as decimal(10, 2)) as d, date '1998-12-01' as dt",
    "select r_name from region where r_regionkey > 10",
]


@pytest.fixture(scope="module")
def servers():
    old = {k: os.environ.get(k) for k, _ in PINS}
    os.environ.update(dict(PINS))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    port = TrinoTpuServer(StandaloneQueryRunner(default_catalog(SF),
                                                device="cpu")).start()
    ref = RefServer(RefStandalone(ref_catalog(scale_factor=SF))).start()
    try:
        yield port, ref
    finally:
        port.stop()
        ref.stop()
        torch.set_num_threads(n)
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(autouse=True)
def _no_result_cache():
    with result_cache.disabled(), ref_result_cache.disabled():
        yield


def _base(srv) -> str:
    host, port = srv.address
    return f"http://{host}:{port}"


def _get(url: str):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.load(resp)


def _pages(srv, sql: str) -> list:
    """Every payload of one statement, the query id replaced by ``Q``."""
    base = _base(srv)
    req = urllib.request.Request(f"{base}/v1/statement", data=sql.encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        payload = json.load(resp)
    qid = payload["id"]
    out = []
    while True:
        state = payload["stats"]["state"]
        if state not in ("QUEUED", "RUNNING"):  # polls vary in number
            out.append(json.loads(json.dumps(payload).replace(qid, "Q")))
        if not payload.get("nextUri"):
            return out
        payload = _get(base + payload["nextUri"])


@pytest.mark.parametrize("i", range(len(STATEMENTS)))
def test_statement_json_equals_reference(servers, i):
    """columns (names and type names), data pages (decimals and dates as
    strings, NaN as "NaN", NULL as null), state and nextUri paging, page
    for page."""
    port, ref = servers
    got, want = _pages(port, STATEMENTS[i]), _pages(ref, STATEMENTS[i])
    assert got == want
    assert want[-1]["stats"]["state"] == "FINISHED"


def test_rest_roundtrip(servers):
    port, ref = servers
    sql = ("select n_regionkey, count(*) as c from nation "
           "group by n_regionkey order by n_regionkey")
    out = []
    for srv in (port, ref):
        host, p = srv.address
        out.append(Client(host, p).execute(sql))
    assert out[0] == out[1]
    columns, rows = out[0]
    assert [c["name"] for c in columns] == ["n_regionkey", "c"]
    assert rows == [[i, 5] for i in range(5)]


def test_rest_types_encoding(servers):
    port, _ = servers
    host, p = port.address
    columns, rows = Client(host, p).execute(
        "select o_orderdate, o_totalprice from orders where o_orderkey = 1")
    assert columns[0]["type"] == "date"
    assert columns[1]["type"].startswith("decimal")
    assert isinstance(rows[0][0], str) and rows[0][0].count("-") == 2
    float(rows[0][1])  # decimal as string


def test_json_value_encoding_equals_reference():
    import datetime
    import decimal

    values = [decimal.Decimal("-12.50"), datetime.date(1995, 3, 15),
              float("nan"), float("inf"), 1.25, None, 7, "x", True]
    assert [protocol._json_value(v) for v in values] == \
        [ref_protocol._json_value(v) for v in values]


def test_rest_failure_surfaces(servers):
    port, ref = servers
    got, want = _pages(port, "selec broken"), _pages(ref, "selec broken")
    assert got == want and want[-1]["stats"]["state"] == "FAILED"
    host, p = port.address
    with pytest.raises(QueryFailed, match="(?i)parse|expected"):
        Client(host, p).execute("selec broken")


def test_rest_concurrent_queries(servers):
    port, _ = servers
    host, p = port.address
    results = []

    def go(i):
        _, rows = Client(host, p).execute(
            f"select {i} as tag, count(*) from region")
        results.append(rows[0])

    threads = [threading.Thread(target=go, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert sorted(r[0] for r in results) == list(range(6))
    assert all(r[1] == 5 for r in results)


def test_unknown_routes_and_cancel(servers):
    """404s for unknown paths, queries and profiles; DELETE of an unknown
    query is a 404 with ``cancelled: false``, as in the reference."""
    out = []
    for srv in servers:
        base = _base(srv)
        row = []
        for path in ("/v1/nothing", "/v1/statement/nope/0",
                     "/v1/query/never-ran/profile"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(base + path, timeout=10)
            row.append((ei.value.code, json.load(ei.value)))
        req = urllib.request.Request(f"{base}/v1/statement/nope",
                                     method="DELETE")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        row.append((ei.value.code, json.load(ei.value)))
        out.append(row)
    assert out[0] == out[1]
    assert out[0][-1] == (404, {"cancelled": False})


def test_caches_route_lists_the_tiers(servers):
    port, ref = servers
    tiers = [sorted({r["tier"] for r in _get(_base(s) + "/v1/caches")
                     ["caches"]}) for s in (port, ref)]
    assert tiers[0] == tiers[1]


# ------------------------------------------------------ /v1/metrics


def test_coordinator_metrics_endpoint():
    runner = StandaloneQueryRunner(default_catalog(0.001), device="cpu")
    runner.execute("select count(*) from nation")
    srv = TrinoTpuServer(runner, port=0).start()
    try:
        resp = urllib.request.urlopen(f"{_base(srv)}/v1/metrics")
        body = resp.read().decode()
        assert resp.headers["Content-Type"].startswith("text/plain")
        # scan, resilience, fused and the serving plane's counters are
        # all registered
        for name in ("trino_scan_bytes_total",
                     "trino_resilience_query_retries_total",
                     "trino_fused_compiles_total",
                     "trino_queries_started_total",
                     "trino_dispatcher_queries_total",
                     "trino_admission_queued_seconds_count"):
            assert name in body, name
        # the query above actually moved the scan counter
        line = [ln for ln in body.splitlines()
                if ln.startswith("trino_scan_bytes_total")][0]
        assert float(line.split()[-1]) > 0
        # one more statement through the server bumps the dispatcher count
        before = _metric(body, "trino_dispatcher_queries_total")
        host, p = srv.address
        Client(host, p).execute("select 1")
        after = _metric(urllib.request.urlopen(
            f"{_base(srv)}/v1/metrics").read().decode(),
            "trino_dispatcher_queries_total")
        assert after == before + 1
    finally:
        srv.stop()


def _metric(text: str, name: str) -> float:
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return 0.0


def test_worker_metrics_endpoint():
    s = TaskServer(0, "cpu")
    th = threading.Thread(target=s.serve_forever, daemon=True)
    th.start()
    try:
        resp = urllib.request.urlopen(
            f"http://127.0.0.1:{s.port}/v1/metrics")
        body = resp.read().decode()
        assert resp.headers["Content-Type"].startswith("text/plain")
        for name in ("trino_scan_bytes_total", "trino_tasks_created_total",
                     "trino_exchange_bytes_total"):
            assert name in body, name
        snap = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{s.port}/v1/metrics?format=json").read())
        assert snap["trino_tasks_created_total"]["kind"] == "counter"
        info = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{s.port}/v1/info").read())
        assert (info["state"], info["tasks"], info["device"]) == \
            ("ACTIVE", 0, "cpu")
        assert set(info["launches"]) == {"hash_insert", "hash_probe",
                                         "masked_segment_sum_f32"}
    finally:
        s.httpd.shutdown()


# ------------------------------------------------ dispatcher boot recovery


RECOVERY_SQL = ("select l_returnflag, count(*), sum(l_quantity) "
                "from lineitem group by l_returnflag order by 1")


def _crash_then_recover(dist, injector_mod, state_mod, gc_mod, dispatcher,
                        state_dir, qid) -> tuple:
    """A TASK query fails after some stages committed, with the WAL's
    terminal record and the spool release suppressed (the state a
    coordinator killed mid-query leaves); a fresh runner's dispatcher
    recovers it at boot under its original id."""
    inj = injector_mod.FailureInjector()
    r1 = dist(inj)
    nonleaf = [f.id for f in r1.create_subplan(RECOVERY_SQL).all_fragments()
               if f.source_fragments]
    inj.inject(injector_mod.TASK_FAILURE, fragment_id=nonleaf[-1],
               task_index=None, attempt=None, times=10)
    crash = pytest.MonkeyPatch()
    crash.setattr(state_mod.QueryStateLog, "end",
                  lambda self, *a, **kw: None)
    crash.setattr(gc_mod, "release", lambda root: 0)
    try:
        with pytest.raises(Exception):
            r1.execute(RECOVERY_SQL, query_id=qid)
    finally:
        crash.undo()
    disp = dispatcher(dist(None))
    q = disp.get(qid)
    assert q is not None and q.recovered
    assert q.done.wait(120)
    final = state_mod.load(os.path.join(state_dir, f"{qid}.wal"))
    return disp.recovered_query_ids, q.state, q.error, q.rows, final.ended


def test_dispatcher_boot_recovery(tmp_path, monkeypatch):
    """QueryDispatcher rehydrates in-flight WAL queries at boot under their
    original ids, so a reattaching client's polling resolves, and runs them
    to the reference's rows."""
    import trino_tpu.execution.failure_injector as RFI
    import trino_tpu_torch.execution.failure_injector as PFI

    for k, v in PINS:
        monkeypatch.setenv(k, v)
    out = []
    for name, dist, fi, st, gc, disp in (
            ("port", lambda inj: DistributedQueryRunner(
                default_catalog(SF), worker_count=2, device="cpu",
                session=Session(node_count=2, retry_policy="TASK",
                                failure_injector=inj, fte_speculative=False,
                                task_retry_attempts=1)),
             PFI, query_state, spool_gc, QueryDispatcher),
            ("reference", lambda inj: RefDist(
                ref_catalog(scale_factor=SF), worker_count=2,
                session=RefSession(node_count=2, retry_policy="TASK",
                                   failure_injector=inj,
                                   fte_speculative=False,
                                   task_retry_attempts=1)),
             RFI, ref_query_state, ref_spool_gc,
             ref_protocol.QueryDispatcher)):
        state = tmp_path / name / "query-state"
        spool = tmp_path / name / "spool"
        spool.mkdir(parents=True)
        monkeypatch.setenv("TRINO_TPU_QUERY_STATE", "1")
        monkeypatch.setenv("TRINO_TPU_QUERY_STATE_DIR", str(state))
        monkeypatch.setenv("TRINO_TPU_SPOOL_DIR", str(spool))
        out.append(_crash_then_recover(dist, fi, st, gc, disp, str(state),
                                       "deadbeef00000001"))
    assert out[0] == out[1]
    ids, state, error, rows, ended = out[0]
    assert ids == ["deadbeef00000001"]
    assert state == "FINISHED", error
    assert [r[0] for r in rows] == ["A", "N", "R"]
    assert ended == "FINISHED"

"""Worker processes of the port under faults, against the reference's
process tests (tests/test_process_runner.py, the process cases of
tests/test_resilience.py and the served cluster of tests/test_profiler.py):
a dead worker routed around, graceful shutdown and drains, PROCESS_EXIT
recovered by query retry and by fault-tolerant execution, USER errors
failing fast across the wire, the replacement cap, the internal secret,
the bounded boot, the cross-process trace tree and the merged profile.

One module-scoped cluster of two CPU worker processes serves every test;
a test that needs other session knobs swaps the runner's session, and a
test that loses a worker heals the fleet back to two before the next.
Rows are held to the reference's standalone rows (pinned to its sort
path).
"""

import json
import os
import time
import urllib.error
import urllib.request

import pytest
import torch

from test_torch_distributed import _same
from trino_tpu.caching import result_cache as ref_result_cache
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.runner import StandaloneQueryRunner as RefStandalone
from trino_tpu_torch.caching import result_cache
from trino_tpu_torch.connectors.tpch_queries import QUERIES
from trino_tpu_torch.execution.failure_injector import (PROCESS_EXIT,
                                                        FailureInjector)
from trino_tpu_torch.execution.remote import (HttpRemoteTask,
                                              ProcessDistributedQueryRunner,
                                              WorkerProcess)
from trino_tpu_torch.runner import Session
from trino_tpu_torch.server import TrinoTpuServer
from trino_tpu_torch.spi.errors import TrinoError

SF = 0.01
PINS = (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
        ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
        ("TRINO_TPU_OPTIMIZER", "iterative"))
CATALOG_SPEC = {
    "factory": "trino_tpu_torch.connectors.catalog:default_catalog",
    "kwargs": {"scale_factor": SF},
}
WORKER_ENV = {"OMP_NUM_THREADS": "1", "TRINO_TPU_HBO": "0",
              "TRINO_TPU_RESULT_CACHE": "0"}
DIV_BY_ZERO_SQL = \
    "select o_orderkey / (o_orderkey - o_orderkey) from orders"
# the reference tests' faster heartbeat
FAST = {"heartbeat_interval_s": 0.2}


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    base = tmp_path_factory.mktemp("process-faults")
    env = dict(PINS, TRINO_TPU_SPOOL_DIR=str(base / "spool"),
               TRINO_TPU_QUERY_STATE_DIR=str(base / "state"))
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    dist = ProcessDistributedQueryRunner(
        CATALOG_SPEC, worker_count=2, session=Session(node_count=2),
        env_overrides=WORKER_ENV, device="cpu")
    ref = RefStandalone(ref_catalog(scale_factor=SF))
    try:
        yield dist, ref
    finally:
        dist.close()
        torch.set_num_threads(n)
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture
def dist(cluster):
    """The shared runner with a fresh session (``runner.session = ...``
    in a test), healed back to two live workers afterwards."""
    runner, _ = cluster
    runner.session = Session(node_count=2)
    yield runner
    runner.session = Session(node_count=2)
    runner.failure_detector.heartbeat_interval_s = 0.5
    for w in [w for w in runner.workers if not w.alive()]:
        runner.failure_detector.unmonitor(w.url)
        runner.workers.remove(w)
    while len(runner.workers) < 2:
        runner.add_worker()
    runner.failure_detector.sweep_once()


@pytest.fixture(autouse=True)
def _no_result_cache():
    with result_cache.disabled(), ref_result_cache.disabled():
        yield


def _session(**kw):
    props = {k: kw.pop(k) for k in list(kw)
             if k in ("heartbeat_interval_s", "max_worker_replacements")}
    return Session(node_count=2, properties=props, **kw)


def _use(runner, session) -> None:
    runner.session = session
    runner.failure_detector.heartbeat_interval_s = \
        session.get("heartbeat_interval_s")


def test_worker_death_fails_fast(dist, cluster):
    """A dead worker is routed around by task placement, and a task
    pinned to a killed worker reports GONE, so the coordinator fails fast
    instead of hanging (recovery is FTE's and the query retry's job)."""
    assert dist.execute("select count(*) from nation").rows() == [(25,)]
    dead = dist.workers[1]
    rt = HttpRemoteTask(dead.url, "probe")
    dead.kill()
    assert rt.status()["state"] == "GONE"
    rows = dist.execute(
        "select count(*), sum(o_totalprice) from orders").rows()
    _, ref = cluster
    assert rows == ref.execute(
        "select count(*), sum(o_totalprice) from orders").rows()
    assert rows[0][0] == 15000
    assert [w.alive() for w in dist.workers].count(True) == 1


def test_graceful_shutdown(dist):
    """PUT /v1/shutdown drains and exits the worker process with code 0
    (server/GracefulShutdownHandler.java:42)."""
    assert dist.execute("select count(*) from region").rows() == [(5,)]
    w = dist.workers[1]
    w.shutdown()
    assert not w.alive() and w.proc.returncode == 0


def test_drain_worker_replaces_and_exits_zero(dist, cluster):
    """The coordinator-driven drain between two queries: the drained
    worker leaves with exit code 0, a replacement boots, and the next
    query gives the reference's rows."""
    _, ref = cluster
    sql = QUERIES[3]
    before = dist.execute(sql).rows()
    old = dist.workers[0]
    summary = dist.drain_worker(old, timeout_s=30)
    assert summary["exit_code"] == 0 and not summary["escalated"]
    assert summary["replacement"] == dist.workers[0].url != old.url
    kinds = [e[2] for e in dist.resilience_events if e[0] == "drain"]
    assert kinds[-3:] == ["started", "replaced", "drained"]
    after = dist.execute(sql).rows()
    _same(before, ref.execute(sql).rows(), True)
    _same(after, before, True)


def test_add_worker_adopts_a_booted_spare(dist, cluster):
    """A spare booted ahead of time joins the fleet in place of a dead
    worker: it is monitored, placed on, and the next query gives the
    reference's rows."""
    _, ref = cluster
    spare = WorkerProcess(env_overrides=WORKER_ENV, device="cpu")
    dead = dist.workers[1]
    dead.kill()
    dist.failure_detector.unmonitor(dead.url)
    dist.workers.remove(dead)
    assert dist.add_worker(spare) is spare
    assert dist.workers[-1] is spare and spare.alive()
    assert dist.failure_detector.state_of(spare.url) == "ACTIVE"
    assert dist.resilience_events[-1] == ("scale", spare.url, "added")
    sql = "select count(*), sum(o_totalprice) from orders"
    assert dist.execute(sql).rows() == ref.execute(sql).rows()
    assert spare.info()["tasks"] > 0


def test_fte_worker_kill_recovers(dist, cluster):
    """A worker PROCESS is killed mid-stage by an injected PROCESS_EXIT;
    the attempt's consumers retry on the surviving worker, reading the
    earlier stages' committed spools, and the query gives the reference's
    rows with one worker really dead."""
    _, ref = cluster
    inj = FailureInjector()
    _use(dist, _session(retry_policy="TASK", failure_injector=inj))
    sql = QUERIES[3]
    leaf = dist.create_subplan(sql).all_fragments()[0]
    inj.inject(PROCESS_EXIT, fragment_id=leaf.id, task_index=0, attempt=0)
    rows = dist.execute(sql).rows()
    _same(rows, ref.execute(sql).rows(), True)
    assert [w.alive() for w in dist.workers].count(True) == 1, \
        "the injected PROCESS_EXIT did not actually kill a worker"


def test_streaming_process_exit_recovers_bit_identical(dist, cluster):
    """PROCESS_EXIT kills a worker mid-stage in streaming mode;
    retry_policy=QUERY blacklists it, replaces it and re-runs: the rows
    equal the reference's, with the replacement in the event log."""
    _, ref = cluster
    sql = QUERIES[3]
    inj = FailureInjector()
    _use(dist, _session(retry_policy="QUERY", failure_injector=inj,
                        retry_initial_delay_s=0.05, **FAST))
    replaced = dist.resilience.worker_replacements
    retries = dist.resilience.query_retries
    n_events = len(dist.resilience_events)
    leaf = dist.create_subplan(sql).all_fragments()[0]
    inj.inject(PROCESS_EXIT, fragment_id=leaf.id, task_index=0, attempt=0)
    rows = dist.execute(sql).rows()
    assert rows == ref.execute(sql).rows()  # order included
    kinds = [e[0] for e in dist.resilience_events[n_events:]]
    assert {"worker_replaced", "blacklist", "query_retry"} <= set(kinds)
    assert dist.resilience.query_retries - retries >= 1
    assert dist.resilience.worker_replacements - replaced == 1
    assert dist.resilience.heartbeat_transitions >= 1
    # capacity self-healed: both slots live again
    assert [w.alive() for w in dist.workers].count(True) == 2


def test_streaming_user_error_fails_fast_across_processes(dist):
    """A USER-classified error: < 5 s and no retry; the worker's
    error_type survives the wire."""
    _use(dist, _session(retry_policy="QUERY", **FAST))
    n_events = len(dist.resilience_events)
    retries = dist.resilience.query_retries
    t0 = time.monotonic()
    with pytest.raises(Exception, match="DIVISION_BY_ZERO"):
        dist.execute(DIV_BY_ZERO_SQL)
    assert time.monotonic() - t0 < 5.0
    assert dist.resilience.query_retries == retries
    assert not [e for e in dist.resilience_events[n_events:]
                if e[0] in ("query_retry", "blacklist")]


def test_worker_replacement_cap_honored(dist):
    """max_worker_replacements=0: the dead worker is not respawned; the
    retry still succeeds on the survivor and the cap refusal is logged."""
    inj = FailureInjector()
    _use(dist, _session(retry_policy="QUERY", failure_injector=inj,
                        retry_initial_delay_s=0.05,
                        max_worker_replacements=0, **FAST))
    replaced = dist.resilience.worker_replacements
    n_events = len(dist.resilience_events)
    leaf = dist.create_subplan(
        "select count(*) from orders").all_fragments()[0]
    inj.inject(PROCESS_EXIT, fragment_id=leaf.id, task_index=0, attempt=0)
    assert dist.execute("select count(*) from orders").rows() == [(15000,)]
    kinds = [e[0] for e in dist.resilience_events[n_events:]]
    assert "worker_replaced" not in kinds and "replacement_cap" in kinds
    assert dist.resilience.worker_replacements == replaced
    assert [w.alive() for w in dist.workers].count(True) == 1


def test_internal_secret_required(dist):
    """Mutating and descriptor-decoding endpoints refuse requests without
    the per-spawn shared secret; /v1/info stays open for liveness."""
    url = dist.workers[0].url
    with urllib.request.urlopen(f"{url}/v1/info", timeout=10) as resp:
        assert json.loads(resp.read())["state"] in ("ACTIVE",
                                                    "SHUTTING_DOWN")
    for method, path, data in (("POST", "/v1/task/evil", b"\x00" * 8),
                               ("GET", "/v1/task/evil/results/0/0", None),
                               ("DELETE", "/v1/task/evil", None),
                               ("PUT", "/v1/shutdown", None)):
        req = urllib.request.Request(url + path, data=data, method=method)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 401, (method, path)
    assert dist.workers[0].alive()


def _walk(span, out):
    out.append(span)
    for c in span.children:
        _walk(c, out)
    return out


def test_cross_process_trace_tree(dist):
    """The coordinator's query trace contains the worker task spans
    shipped back over HTTP: remote-parented through the traceparent header
    on task create, serialized with task completion, re-attached as one
    tree."""
    dist.execute("select count(*) from nation")
    root = dist.tracer.finished[-1]
    assert root.name == "trino.query"
    spans = _walk(root, [])
    tasks = [s for s in spans if s.name == "trino.task"]
    assert tasks, "no remote task spans re-attached under the query span"
    by_id = {s.span_id: s for s in spans}
    for t in tasks:
        assert t.trace_id == root.trace_id
        assert t.parent_id in by_id and t in by_id[t.parent_id].children
        assert t.attributes["trino.task.worker"].startswith("127.0.0.1:")
    assert sum(t.attributes.get("trino.scan.rows", 0) for t in tasks) == 25
    # the /v1/metrics scrape on a live worker shows its own task counters
    body = urllib.request.urlopen(
        f"{dist.workers[0].url}/v1/metrics").read().decode()
    assert "trino_tasks_created_total" in body


def test_workers_system_table(dist):
    """system.runtime.workers lists the process fleet from the heartbeat
    sweep, ACTIVE, with the coordinator-side blacklist score."""
    rows = dist.execute(
        "select worker, state from system.runtime.workers").rows()
    assert sorted(rows) == sorted((w.url, "ACTIVE") for w in dist.workers)


# ----------------------------------------------------------- boot, status


def test_worker_boot_failure_raises_with_stderr():
    """A worker that dies before printing LISTENING surfaces as a bounded
    error carrying its stderr, not an eternal readline() hang.  A device
    name torch does not know makes the worker exit at boot on any host."""
    t0 = time.monotonic()
    with pytest.raises(TrinoError) as ei:
        WorkerProcess(env_overrides=WORKER_ENV, boot_timeout_s=60.0,
                      device="nodevice")
    assert time.monotonic() - t0 < 60.0
    msg = str(ei.value)
    assert ei.value.code.name == "REMOTE_HOST_GONE"
    assert "failed to boot" in msg and "worker boot failed" in msg
    assert "nodevice" in msg


def test_worker_status_endpoint_reports_all_tasks():
    """GET /v1/status returns node state and every task's classified
    state in one payload: the one-poll-per-worker sweep's data source."""
    w = WorkerProcess(env_overrides=WORKER_ENV, device="cpu")
    try:
        with urllib.request.urlopen(f"{w.url}/v1/status",
                                    timeout=10) as resp:
            st = json.loads(resp.read())
        assert st == {"state": "ACTIVE", "tasks": {}}
    finally:
        w.kill()


# --------------------------------------------- the served cluster's profile


def _run_statement(base: str, sql: str) -> tuple:
    req = urllib.request.Request(f"{base}/v1/statement",
                                 data=sql.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        payload = json.load(resp)
    qid = payload["id"]
    while payload.get("nextUri"):
        with urllib.request.urlopen(base + payload["nextUri"],
                                    timeout=60) as resp:
            payload = json.load(resp)
    return qid, payload


@pytest.fixture
def served(dist):
    server = TrinoTpuServer(dist).start()
    host, port = server.address
    yield f"http://{host}:{port}"
    server.stop()


def test_profile_endpoint_merges_worker_timelines(served):
    """A 2-worker query's profile over HTTP is Chrome trace JSON with
    events from the coordinator and both worker pids in one timeline."""
    qid, payload = _run_statement(
        served, "select l_returnflag, count(*) from lineitem "
                "group by l_returnflag order by l_returnflag")
    assert payload["stats"]["state"] == "FINISHED"
    with urllib.request.urlopen(f"{served}/v1/query/{qid}/profile") as r:
        trace = json.load(r)
    events = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert events and all(e["dur"] >= 0 for e in events)
    assert {"operator", "exchange-wait"} <= {e["cat"] for e in events}
    procs = trace["otherData"]["processes"]
    workers = [p for p in procs.values() if p.startswith("worker:")]
    assert len(workers) == 2, f"expected both worker pids, got {procs}"
    assert "coordinator" in procs.values()
    assert os.getpid() in {e["pid"] for e in trace["traceEvents"]}


def test_cluster_scope_metrics_fold_workers(served):
    """/v1/metrics?scope=cluster folds both workers' registries into the
    coordinator's: worker-side counters appear summed, and merged
    distributions stay one histogram series."""
    _run_statement(served, "select count(*) from region")
    with urllib.request.urlopen(f"{served}/v1/metrics?scope=cluster") as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        cluster = r.read().decode()
    with urllib.request.urlopen(f"{served}/v1/metrics") as r:
        local = r.read().decode()

    def val(text, name):
        for line in text.splitlines():
            if line.startswith(name + " "):
                return float(line.split()[1])
        return 0.0

    assert val(cluster, "trino_tasks_created_total") >= \
        val(local, "trino_tasks_created_total") + 2
    buckets = [ln for ln in cluster.splitlines()
               if ln.startswith("trino_task_wall_seconds_bucket")]
    assert buckets and "+Inf" in buckets[-1]
    assert val(cluster, "trino_task_wall_seconds_count") >= 2
    # pages moved over HTTP: the exchange families count them
    assert val(cluster, "trino_exchange_pages_total") > 0
    assert val(cluster, "trino_exchange_bytes_total") > 0


# ----------------------------------------------------------- exchange client


def test_unreachable_producer_trips_backoff_in_bounded_time():
    """An unreachable producer surfaces as a classified EXTERNAL failure
    once failures persist past max_failure_duration, not as a silent
    stall until the query deadline."""
    import socket

    from trino_tpu_torch.execution.remote import HttpExchangeClient

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens here now
    client = HttpExchangeClient(
        [f"http://127.0.0.1:{port}/v1/task/ghost"], 0,
        backoff={"min_delay_s": 0.01, "max_delay_s": 0.05,
                 "max_failure_duration_s": 0.3})
    t0 = time.monotonic()
    with pytest.raises(TrinoError) as ei:
        while time.monotonic() - t0 < 30.0:
            client.poll(timeout=0.0)
            time.sleep(0.005)
    assert time.monotonic() - t0 < 5.0
    assert ei.value.code.name == "PAGE_TRANSPORT_TIMEOUT"
    assert ei.value.error_type == "EXTERNAL"
    assert ei.value.remote_host == f"http://127.0.0.1:{port}"
    assert client.stats["fetch_failures"] >= 2
    assert client.stats["backoff_trips"] == 1
    assert client.stats["backoff_skips"] >= 1  # the delay gate closed


def test_fetch_honors_caller_poll_timeout_and_decodes_on_device(
        monkeypatch):
    """A non-blocking poll is not promoted to a 5 s long-poll: the wait
    travels as ?maxwait= and the socket timeout only adds grace.  A
    fetched page is decoded onto the client's ``device``."""
    import struct

    import numpy as np

    from trino_tpu_torch.execution import remote
    from trino_tpu_torch.execution.serde import serialize_batch
    from trino_tpu_torch.spi.batch import Column, ColumnBatch
    from trino_tpu_torch.spi.types import BIGINT

    page = serialize_batch(ColumnBatch(
        ["x"], [Column(BIGINT, np.arange(4, dtype=np.int64))]))
    captured = []

    class FakeResp:
        status = 200
        headers = {"X-Next-Token": "1", "X-Done": "1"}

        def read(self):
            return struct.pack("<I", len(page)) + page

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def fake_http(method, url, data=None, timeout=30.0, headers=None):
        captured.append((url, timeout))
        return FakeResp()

    monkeypatch.setattr(remote, "_http", fake_http)
    got = remote.HttpExchangeClient(["http://w/v1/task/t"], 0,
                                    device=torch.device("meta")
                                    ).poll(timeout=0.0)
    url, timeout = captured[0]
    assert "maxwait=0" in url and timeout < 5.5
    assert got.columns[0].device.type == "meta"
    host = remote.HttpExchangeClient(["http://w/v1/task/t"], 0
                                     ).poll(timeout=3.0)
    url, timeout = captured[1]
    assert "maxwait=3" in url and timeout == pytest.approx(8.0)
    assert host.to_pylist() == [(0,), (1,), (2,), (3,)]


# ------------------------------------------ where trouble is likely, held


def test_worker_binds_but_never_builds_the_library(monkeypatch, tmp_path):
    """One kernel library, several processes: a worker binds the library
    its coordinator built and never runs nvcc; a missing or stale
    library raises at the worker's boot instead."""
    from trino_tpu_torch.ops import gpu_kernels as GK

    built = []
    monkeypatch.setattr(GK, "_BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(GK, "_LIB", None)
    monkeypatch.setattr(GK, "build_library",
                        lambda verbose=False: built.append(1))
    assert not GK.library_current()
    with pytest.raises(RuntimeError, match="missing or older"):
        GK._lib(build=False)
    assert built == [] and GK._LIB is None


def test_cluster_memory_view_reads_worker_status(dist):
    """Memory on one card: each worker reports its tasks' device-pool
    reservations in /v1/status, and the coordinator's cluster memory
    manager folds one snapshot per worker from the heartbeat sweep."""
    dist.execute(QUERIES[3])
    owned = {w.url: [] for w in dist.workers}
    dist._check_workers(owned)
    assert set(dist.memory_manager._workers) >= set(owned)
    for w in dist.workers:
        st = json.loads(urllib.request.urlopen(f"{w.url}/v1/status",
                                               timeout=10).read())
        # streaming tasks carry the worker-visible query id (pqN); a
        # fault-tolerant attempt's descriptor has none, as in the reference
        ids = [t["query_id"] for t in st["tasks"].values()]
        assert any(q and q.startswith("pq") for q in ids)
        assert all(q is None or q.startswith("pq") for q in ids)
        assert all(t["memory_reserved_bytes"] >= 0
                   for t in st["tasks"].values())
    assert dist.memory_manager.cluster_reserved_bytes() >= 0


def test_worker_environment_is_one_thread(dist):
    """CPU tests in subprocesses: every worker runs with the
    ``env_overrides`` it was given (one intra-op thread each here, so the
    test workers do not oversubscribe the cores)."""
    for w in dist.workers:
        with open(f"/proc/{w.proc.pid}/environ", "rb") as f:
            env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0")
                       if b"=" in kv)
        assert env[b"OMP_NUM_THREADS"] == b"1"
        assert env[b"TRINO_TPU_INTERNAL_SECRET"]


def test_drain_budget_abandons_a_stalled_task(dist):
    """Every wait has a bound: a drain whose task stalls past the budget
    abandons it, the worker exits with code 9 in about the budget, and
    the query on it fails instead of hanging."""
    import threading

    from trino_tpu_torch.execution.failure_injector import TASK_STALL

    inj = FailureInjector()
    _use(dist, _session(failure_injector=inj, **FAST))
    sql = "select count(*) from orders"
    w = dist.workers[0]
    leaf = dist.create_subplan(sql).all_fragments()[0]
    inj.inject(TASK_STALL, fragment_id=leaf.id, task_index=None,
               attempt=None, times=4, stall_s=60.0)
    out = {}

    def tasks_on_w() -> dict:
        return json.loads(urllib.request.urlopen(
            f"{w.url}/v1/status", timeout=10).read())["tasks"]

    def run():
        try:
            out["rows"] = dist.execute(sql).rows()
        except Exception as e:  # noqa: BLE001 — the expected failure
            out["error"] = e

    # wait for a task of THIS query running on w (an earlier test's task
    # can still read RUNNING for a moment)
    earlier = set(tasks_on_w())
    th = threading.Thread(target=run, daemon=True)
    th.start()
    deadline = time.monotonic() + 60
    while not any(t["state"] == "RUNNING"
                  for tid, t in tasks_on_w().items() if tid not in earlier):
        assert time.monotonic() < deadline
        time.sleep(0.02)
    t0 = time.monotonic()
    summary = dist.drain_worker(w, timeout_s=1.0, replace=False)
    assert summary["exit_code"] == 9 and not summary["escalated"]
    assert time.monotonic() - t0 < 10.0
    th.join(60)
    assert not th.is_alive() and "error" in out

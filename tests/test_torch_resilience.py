"""The port's resilience layer against the reference: error
classification (spi/errors.py), deterministic backoff, query retry
(``retry_policy="QUERY"``), USER errors failing fast on the streaming and
the FTE path, the session knobs, the shared cluster blacklist
(execution/resilience.py, execution/speculation.py), the heartbeat
detector's state machine (execution/failure_detector.py) and streaming
speculation.

The reference's tests/test_resilience.py cases that need no worker
process run on the port; those that boot worker processes or reach them
over HTTP (the boot failure, ``/v1/status``, PROCESS_EXIT recovery, the
exchange client's backoff trip and poll timeout, worker replacement) wait
for worker processes (ROADMAP queue 1 item 5).  The repaired
classification of a memory-limit error is held here: ``classify`` gives
the reference's code and retryability, and a query that fails on its
memory limit reports the reference's ``error_code`` in its completed
event.
"""

import time

import pytest
import torch

from test_torch_distributed import _same
from trino_tpu.caching import result_cache as ref_result_cache
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.execution import failure_injector as RFI
from trino_tpu.execution.distributed_runner import (
    DistributedQueryRunner as RefDist)
from trino_tpu.runner import Session as RefSession
from trino_tpu.spi import errors as RE
from trino_tpu.spi import memory as RM
from trino_tpu_torch.caching import result_cache
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.execution.distributed_runner import (
    DistributedQueryRunner)
from trino_tpu_torch.execution.failure_detector import (
    ACTIVE, GONE, SHUTTING_DOWN, UNRESPONSIVE, NodeGoneError,
    WorkerFailureDetector)
from trino_tpu_torch.execution.failure_injector import (
    TASK_FAILURE, TASK_OOM, TASK_STALL, FailureInjector, InjectedFailure)
from trino_tpu_torch.runner import Session, StandaloneQueryRunner
from trino_tpu_torch.spi.errors import (EXTERNAL, INSUFFICIENT_RESOURCES,
                                        INTERNAL, USER, Backoff, TrinoError,
                                        classify)
from trino_tpu_torch.spi.memory import ExceededMemoryLimitError

SF = 0.01
PINS = (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
        ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
        ("TRINO_TPU_OPTIMIZER", "iterative"))
DIV_BY_ZERO_SQL = \
    "select o_orderkey / (o_orderkey - o_orderkey) from orders"


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


def _dist(workers=2, **kw):
    return DistributedQueryRunner(default_catalog(SF), worker_count=workers,
                                  device="cpu",
                                  session=Session(node_count=workers, **kw))


# ------------------------------------------------------------ unit layer
def test_backoff_is_deterministic():
    for B in (Backoff, RE.Backoff):
        now = [0.0]
        b = B(min_delay_s=0.1, max_delay_s=0.8,
              max_failure_duration_s=10.0, clock=lambda: now[0])
        assert b.delay_s == 0.0 and b.ready()
        assert b.failure() is False
        assert b.delay_s == pytest.approx(0.1)
        assert not b.ready()
        now[0] = 0.1
        assert b.ready()
        assert b.failure() is False
        assert b.delay_s == pytest.approx(0.2)
        b.failure()
        assert b.delay_s == pytest.approx(0.4)
        b.failure()
        assert b.delay_s == pytest.approx(0.8)
        b.failure()
        assert b.delay_s == pytest.approx(0.8)
        now[0] = 10.0
        assert b.failure() is True
        b.success()
        assert b.failure_count == 0 and b.delay_s == 0.0 and b.ready()


@pytest.mark.parametrize("exc,ref_exc,expected_type", [
    (ExceededMemoryLimitError("pool", 1, 1),
     RM.ExceededMemoryLimitError("pool", 1, 1), INSUFFICIENT_RESOURCES),
    (InjectedFailure("boom"), RFI.InjectedFailure("boom"), INTERNAL),
    (ConnectionError("refused"), ConnectionError("refused"), EXTERNAL),
    (TimeoutError("late"), TimeoutError("late"), EXTERNAL),
    (RuntimeError("anything else"), RuntimeError("anything else"),
     INTERNAL),
], ids=["memory", "injected", "connection", "timeout", "other"])
def test_classification_table(exc, ref_exc, expected_type):
    """The port classifies as the reference does: the same code, type and
    retryability (a memory-limit error is EXCEEDED_LOCAL_MEMORY_LIMIT,
    INSUFFICIENT_RESOURCES, retryable)."""
    te, want = classify(exc), RE.classify(ref_exc)
    assert te.error_type == expected_type == want.error_type
    assert te.code.name == want.code.name and te.code.code == want.code.code
    assert te.is_retryable() is want.is_retryable() is True


def test_classification_user_errors_never_retry():
    from trino_tpu_torch.ops.expr import QueryError
    from trino_tpu_torch.sql.analyzer import AnalysisError

    div = classify(QueryError("DIVISION_BY_ZERO: division by zero"))
    assert div.error_type == USER and not div.is_retryable()
    assert div.code.name == "DIVISION_BY_ZERO"
    bad = classify(AnalysisError("no such column"))
    assert bad.error_type == USER and not bad.is_retryable()


def test_classification_is_identity_on_trino_error():
    te = TrinoError(classify(ConnectionError("x")).code, "wrapped",
                    remote_host="http://w:1")
    assert classify(te) is te


def test_memory_limit_failure_reports_the_reference_error_code():
    """A query whose task fails on its memory limit (an injected
    out-of-memory attempt, the FTE drill's) reports the reference's
    error_code in its QueryCompletedEvent."""
    codes = []
    for pkg in ("port", "ref"):
        events = []

        class Listener:
            def query_created(self, e):
                pass

            def query_completed(self, e):
                events.append(e)

            def split_completed(self, e):
                pass

        if pkg == "port":
            inj = FailureInjector()
            inj.inject(TASK_OOM, task_index=0, attempt=0)
            r = _dist(failure_injector=inj)
        else:
            inj = RFI.FailureInjector()
            inj.inject(RFI.TASK_OOM, task_index=0, attempt=0)
            r = RefDist(ref_catalog(scale_factor=SF), worker_count=2,
                        session=RefSession(node_count=2,
                                           failure_injector=inj))
        r.event_listeners.add(Listener())
        with pytest.raises(Exception, match="injected-oom"):
            r.execute("select count(*) from orders")
        codes.append(events[-1].error_code)
    assert codes[0] == codes[1] == "EXCEEDED_LOCAL_MEMORY_LIMIT"


# ----------------------------------------------------- failure detector
def test_detector_state_machine():
    events = []
    det = WorkerFailureDetector(heartbeat_interval_s=0.0,
                                failure_threshold=2, events=events)
    mode = {"w": "ok"}

    def probe():
        m = mode["w"]
        if m == "ok":
            return {"state": "ACTIVE", "tasks": {}}
        if m == "drain":
            return {"state": "SHUTTING_DOWN", "tasks": {}}
        if m == "dead":
            raise NodeGoneError("process exited rc=17")
        raise ConnectionError("refused")

    det.monitor("w", probe)
    det.sweep_once()
    assert det.state_of("w") == ACTIVE and det.active() == ["w"]
    mode["w"] = "fail"
    det.sweep_once()
    assert det.state_of("w") == UNRESPONSIVE and det.active() == []
    mode["w"] = "ok"
    det.sweep_once()
    assert det.state_of("w") == ACTIVE
    mode["w"] = "fail"
    det.sweep_once()
    det.sweep_once()
    assert det.state_of("w") == GONE and det.gone() == ["w"]
    mode["w"] = "ok"
    det.sweep_once()
    assert det.state_of("w") == GONE
    transitions = [e for e in events if e[0] == "heartbeat"]
    assert [(e[2], e[3]) for e in transitions] == [
        (ACTIVE, UNRESPONSIVE), (UNRESPONSIVE, ACTIVE),
        (ACTIVE, UNRESPONSIVE), (UNRESPONSIVE, GONE)]
    assert det.transitions == 4
    rows = det.worker_rows()
    assert rows[0]["worker"] == "w" and rows[0]["state"] == GONE


def test_detector_drain_and_authoritative_death():
    det = WorkerFailureDetector(failure_threshold=3)
    det.monitor("draining", lambda: {"state": "SHUTTING_DOWN", "tasks": {}})

    def dead_probe():
        raise NodeGoneError("process exited rc=17")

    det.monitor("dead", dead_probe)
    det.sweep_once()
    assert det.state_of("draining") == SHUTTING_DOWN
    assert det.active() == []
    assert det.state_of("dead") == GONE
    assert "exited" in det.last_error("dead")


# -------------------------------------------------------- in-process QUERY
def test_query_retry_in_process_recovers_task_failure():
    sql = ("select o_orderstatus, count(*) from orders "
           "group by o_orderstatus order by o_orderstatus")
    expected = StandaloneQueryRunner(default_catalog(SF),
                                     device="cpu").execute(sql).rows()
    inj = FailureInjector()
    inj.inject(TASK_FAILURE, fragment_id=None, task_index=0, attempt=0,
               times=1)
    r = _dist(retry_policy="QUERY", failure_injector=inj,
              retry_initial_delay_s=0.01)
    assert r.execute(sql).rows() == expected
    assert r.resilience.query_retries == 1
    assert [e[0] for e in r.resilience_events] == ["query_retry"]


def test_query_retry_exhausts_attempt_budget():
    inj = FailureInjector()
    inj.inject(TASK_FAILURE, fragment_id=None, task_index=0, attempt=None,
               times=100)
    r = _dist(retry_policy="QUERY", query_retry_attempts=2,
              failure_injector=inj, retry_initial_delay_s=0.01)
    with pytest.raises(InjectedFailure):
        r.execute("select count(*) from nation")
    assert r.resilience.query_retries == 2


def test_query_retry_matches_reference():
    """The same injected failure under retry_policy=QUERY in both
    packages: the same rows, retries, backoff and the same
    ``resilience:`` EXPLAIN ANALYZE line."""
    sql = ("select n_regionkey, count(*) from nation group by 1 "
           "order by 1")
    outs = []
    for pkg in ("port", "ref"):
        if pkg == "port":
            inj = FailureInjector()
            inj.inject(TASK_FAILURE, fragment_id=None, task_index=0,
                       attempt=0, times=1)
            r = _dist(retry_policy="QUERY", failure_injector=inj,
                      retry_initial_delay_s=0.01)
            lines = [v[0] for v in r.execute("explain analyze " + sql)
                     .rows()]
        else:
            inj = RFI.FailureInjector()
            inj.inject(RFI.TASK_FAILURE, fragment_id=None, task_index=0,
                       attempt=0, times=1)
            r = RefDist(ref_catalog(scale_factor=SF), worker_count=2,
                        session=RefSession(node_count=2,
                                           retry_policy="QUERY",
                                           failure_injector=inj,
                                           retry_initial_delay_s=0.01))
            lines = [v[0] for v in r.execute("explain analyze " + sql)
                     .batch.to_pylist()]
        outs.append(([t.strip() for t in lines
                      if t.strip().startswith("resilience:")],
                     r.resilience.query_retries, r.resilience.backoff_waits,
                     r.resilience_events))
    assert outs[0] == outs[1]
    assert outs[0][1] == 1 and len(outs[0][0]) == 2


def test_user_error_fails_fast_in_process():
    r = _dist(retry_policy="QUERY")
    t0 = time.monotonic()
    with pytest.raises(Exception, match="DIVISION_BY_ZERO"):
        r.execute(DIV_BY_ZERO_SQL)
    assert time.monotonic() - t0 < 5.0
    assert r.resilience.query_retries == 0
    assert r.resilience_events == []


def test_fte_fails_fast_on_user_error():
    from trino_tpu_torch.execution.fte import TaskFailure

    r = _dist(retry_policy="TASK", task_retry_attempts=5)
    t0 = time.monotonic()
    with pytest.raises(TaskFailure, match="after 1 attempts"):
        r.execute(DIV_BY_ZERO_SQL)
    assert time.monotonic() - t0 < 5.0


def test_resilience_session_knobs_settable():
    r = _dist(workers=1)
    r.execute("set session query_retry_attempts = 5")
    assert r.session.query_retry_attempts == 5
    r.execute("set session retry_policy = 'QUERY'")
    assert r.session.retry_policy == "QUERY"
    with pytest.raises(KeyError):
        r.execute("set session failure_injector = 1")


# -------------------------------------------------- streaming speculation
def test_streaming_speculation_twin_wins_a_stalled_leaf(monkeypatch):
    """A stalled leaf task's SPECULATIVE twin claims the output stream;
    the query finishes long before the stall would, with the reference's
    rows, and the win is counted.  The leaf writes to plain buffers (no
    fused seam, no collective edge), as twins need."""
    monkeypatch.setenv("TRINO_TPU_FUSED_STAGE", "0")
    sql = ("select o_orderpriority, count(*) c from orders "
           "group by o_orderpriority order by 1")
    inj = FailureInjector()
    r = _dist(workers=3, speculation=True, speculation_min_delay_s=0.1,
              failure_injector=inj, adaptive="0", use_collectives=False)
    leaf = next(f.id for f in r.create_subplan(sql).all_fragments()
                if not f.source_fragments)
    inj.inject(TASK_STALL, fragment_id=leaf, task_index=0, attempt=0,
               times=1, stall_s=30.0)
    t0 = time.monotonic()
    got = r.execute(sql).rows()
    assert time.monotonic() - t0 < 20.0
    assert r.speculative_starts >= 1 and r.speculative_wins >= 1
    assert ("speculative_win" in [e[0] for e in r.resilience_events])
    ref = RefDist(ref_catalog(scale_factor=SF), worker_count=3,
                  session=RefSession(node_count=3))
    _same(got, [tuple(x) for x in ref.execute(sql).batch.to_pylist()], True)


# --------------------------------------------- the shared blacklist store
def test_shared_blacklist_two_writers_merge_and_ttl(tmp_path):
    """Two coordinators (one of each package) append to one blacklist
    file: each sees the other's strikes, nothing is counted twice, and
    TTL decay applies fleet-wide."""
    from trino_tpu.execution.speculation import (
        ClusterBlacklist as RefBlacklist)
    from trino_tpu_torch.execution.speculation import ClusterBlacklist

    shared = str(tmp_path / "blacklist.jsonl")
    a = ClusterBlacklist(ttl_s=3600.0, threshold=2.0, persist=True,
                         path=shared)
    b = RefBlacklist(ttl_s=3600.0, threshold=2.0, persist=True, path=shared)
    a.record_failure("worker-1", reason="REMOTE_HOST_GONE", query_id="qa")
    assert a.score("worker-1") == 1.0 and b.score("worker-1") == 1.0
    assert not b.is_blacklisted("worker-1")
    b.record_failure("worker-1", reason="REMOTE_TASK_ERROR", query_id="qb")
    assert b.is_blacklisted("worker-1") and a.is_blacklisted("worker-1")
    assert a.score("worker-1") == 2.0 and b.score("worker-1") == 2.0
    c = ClusterBlacklist(ttl_s=3600.0, threshold=2.0, persist=True,
                         path=shared)
    assert c.is_blacklisted("worker-1")
    tiny = ClusterBlacklist(ttl_s=1e-9, threshold=2.0, persist=True,
                            path=shared)
    time.sleep(0.01)
    assert tiny.score("worker-1") == 0.0


def test_shared_blacklist_survives_interleaved_writers(tmp_path):
    """Two writer threads interleave O_APPEND strikes into one file; a
    fresh reader of either package folds every record."""
    import threading

    from trino_tpu.execution.resilience import (
        SharedBlacklistStore as RefStore)
    from trino_tpu_torch.execution.resilience import SharedBlacklistStore

    shared = str(tmp_path / "bl.jsonl")

    def write(tag):
        s = SharedBlacklistStore(shared)
        for _ in range(50):
            s.append("worker-x", 1.0, "REMOTE_TASK_ERROR", tag)

    ths = [threading.Thread(target=write, args=(t,)) for t in ("qa", "qb")]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    for Store in (SharedBlacklistStore, RefStore):
        recs = Store(shared).poll()
        assert len(recs) == 100
        assert {r["query_id"] for r in recs} == {"qa", "qb"}

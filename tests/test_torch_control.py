"""The port's control plane against the reference: the state machines, the
dispatcher with resource-group admission, discovery and heartbeat failure
detection (execution/control.py), and the distributed runner routed
through them.

Each case of the reference's tests/test_control.py runs the same script
through both packages; the state sequences, admission orders and live-node
sets must be equal, and equal to what the reference's test asserts.
"""

import threading
import time

import pytest
import torch

import trino_tpu.execution.control as RC
import trino_tpu_torch.execution.control as PC
from trino_tpu.caching import result_cache as ref_result_cache
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.execution.distributed_runner import (
    DistributedQueryRunner as RefDist)
from trino_tpu_torch.caching import result_cache
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.execution.distributed_runner import (
    DistributedQueryRunner)

PINS = (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
        ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
        ("TRINO_TPU_OPTIMIZER", "iterative"))
BOTH = pytest.mark.parametrize("pkg", [RC, PC], ids=["reference", "port"])


@pytest.fixture(autouse=True)
def _pin(monkeypatch):
    for k, v in PINS:
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("TRINO_TPU_RESOURCE_GROUPS", raising=False)
    with result_cache.disabled(), ref_result_cache.disabled():
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fsm_script(pkg) -> tuple:
    fsm = pkg.StateMachine("t", "A", {"DONE"})
    seen = []
    fsm.add_listener(seen.append)
    fsm.set("B")
    fsm.set("DONE")
    absorbed = fsm.set("B")
    return seen, absorbed, fsm.is_terminal()


def test_state_machine_listeners_and_terminal():
    assert _fsm_script(PC) == _fsm_script(RC) == (
        ["A", "B", "DONE"], False, True)


def _query_fsm_script(pkg) -> tuple:
    fsm = pkg.QueryStateMachine("q1")
    seen = []
    fsm.add_listener(seen.append)
    moved = [fsm.set(s) for s in ("WAITING_FOR_RESOURCES", "DISPATCHING",
                                  "PLANNING", "STARTING", "RUNNING",
                                  "FINISHING")]
    backward = fsm.set("QUEUED")  # the lifecycle is monotonic
    fsm.finish()
    return seen, moved, backward, fsm.state, fsm.end_time is not None


def test_query_fsm_lifecycle():
    port, ref = _query_fsm_script(PC), _query_fsm_script(RC)
    assert port == ref
    assert ref[0] == ["QUEUED", "WAITING_FOR_RESOURCES", "DISPATCHING",
                      "PLANNING", "STARTING", "RUNNING", "FINISHING",
                      "FINISHED"]
    assert ref[3] == "FINISHED" and ref[4]


def _fifo_script(pkg) -> tuple:
    g = pkg.ResourceGroup("root", hard_concurrency_limit=1, max_queued=10)
    g.acquire()
    order = []

    def queued_worker(i):
        g.acquire(timeout=10)
        order.append(i)
        g.release()

    ts = [threading.Thread(target=queued_worker, args=(i,))
          for i in range(3)]
    for t in ts:
        t.start()
        time.sleep(0.05)  # deterministic FIFO enqueue order
    counts = (g.queued, g.running)
    g.release()
    for t in ts:
        t.join(timeout=10)
    return counts, order, g.running


def test_resource_group_concurrency_queueing():
    assert _fifo_script(PC) == _fifo_script(RC) == ((3, 1), [0, 1, 2], 0)


def _queue_full_script(pkg) -> tuple:
    g = pkg.ResourceGroup("root", hard_concurrency_limit=1, max_queued=0)
    g.acquire()
    try:
        g.acquire()
    except RuntimeError as e:
        out = (type(e).__name__, e.code.name, e.error_type)
    else:
        out = None
    g.release()
    return out


def test_resource_group_queue_full():
    assert _queue_full_script(PC) == _queue_full_script(RC) == (
        "TrinoError", "QUERY_QUEUE_FULL", "USER")


def _hierarchy_script(pkg) -> tuple:
    root = pkg.ResourceGroup("root", hard_concurrency_limit=1)
    a = root.subgroup("a", hard_concurrency_limit=5)
    a.acquire()
    counts = (root.running, a.running)
    done = []
    t = threading.Thread(target=lambda: (a.acquire(timeout=10),
                                         done.append(1), a.release()))
    t.start()
    time.sleep(0.1)
    blocked = not done  # the parent's limit binds
    a.release()
    t.join(timeout=10)
    return counts, blocked, done, a.name


def test_hierarchical_limits():
    assert _hierarchy_script(PC) == _hierarchy_script(RC) == (
        (1, 1), True, [1], "root.a")


def _dispatcher_script(pkg) -> tuple:
    d = pkg.DispatchManager()
    seen = []
    out = d.submit("select 1", None,
                   lambda fsm: (fsm.add_listener(seen.append), 42)[1])
    infos = d.queries()
    first = (out, len(infos), infos[0].state, infos[0].query_id,
             infos[0].resource_group)
    try:
        d.submit("select boom", None,
                 lambda fsm: (_ for _ in ()).throw(ValueError("x")))
    except ValueError:
        raised = True
    else:
        raised = False
    last = d.queries()[-1]
    return first, seen, raised, last.state, last.query_id, \
        type(last.state_machine.error).__name__


def test_dispatcher_tracks_queries():
    assert _dispatcher_script(PC) == _dispatcher_script(RC) == (
        (42, 1, "FINISHED", "q_1", "global"),
        ["DISPATCHING", "FINISHED"], True, "FAILED", "q_2", "ValueError")


def _node_script(pkg) -> list:
    nm = pkg.NodeManager(heartbeat_timeout=0.2)
    nm.announce("w0")
    nm.announce("w1")
    out = [nm.active_workers()]
    nm.drain("w1")
    out.append(nm.active_workers())
    time.sleep(0.3)
    out.append(nm.active_workers())  # heartbeats expired
    nm.announce("w0")
    out.append(nm.active_workers())
    nm.restore("w1")
    out.append(nm.active_workers())
    nm.remove("w1")
    nm.heartbeat("w1")  # a heartbeat does not resurrect a removed node
    out.append(nm.active_workers())
    return out


def test_node_manager_heartbeats_and_drain():
    assert _node_script(PC) == _node_script(RC) == [
        ["w0", "w1"], ["w0"], [], ["w0"], ["w0", "w1"], ["w0"]]


def _detector_script(pkg) -> list:
    nm = pkg.NodeManager(heartbeat_timeout=60)
    nm.announce("w0")
    alive = {"up": True}
    fd = pkg.HeartbeatFailureDetector(nm, interval=0.05)
    fd.monitor("w0", lambda: alive["up"])
    fd.monitor("w1", lambda: 1 / 0)  # a raising ping is a failure
    out = []
    fd.ping_once()
    out.append(sorted(fd.failed_nodes()))
    alive["up"] = False
    fd.ping_once()
    out.append(sorted(fd.failed_nodes()))
    alive["up"] = True
    fd.ping_once()
    out.append(sorted(fd.failed_nodes()))
    fd.unmonitor("w1")
    out.append(sorted(fd.failed_nodes()))
    return out


def test_failure_detector_marks_and_recovers():
    assert _detector_script(PC) == _detector_script(RC) == [
        ["w1"], ["w0", "w1"], ["w1"], []]


def _runner_script(runner) -> list:
    sql = ("select n_regionkey, count(*) from tpch.nation "
           "group by n_regionkey order by 1")
    out = [runner.execute(sql).rows(),
           runner.dispatcher.queries()[-1].state,
           runner.active_worker_count]
    # kill one worker's heartbeat: placement shrinks, results unchanged
    runner.failure_detector.monitor("worker-2", lambda: False)
    runner.nodes.remove("worker-2")
    out += [runner.active_worker_count, runner.execute(sql).rows()]
    # graceful drain of another
    runner.nodes.drain("worker-1")
    out += [runner.active_worker_count, runner.execute(sql).rows(),
            [(q.query_id, q.state, q.resource_group)
             for q in runner.dispatcher.queries()]]
    return out


def test_runner_routes_through_dispatcher_and_sheds_dead_workers():
    port = _runner_script(DistributedQueryRunner(
        default_catalog(0.01), worker_count=3, device="cpu"))
    ref = _runner_script(RefDist(ref_catalog(scale_factor=0.01),
                                 worker_count=3))
    assert port == ref
    assert ref[1:4] == ["FINISHED", 3, 2] and ref[5] == 1
    assert ref[0] == [(r, 5) for r in range(5)]
    assert [q[1] for q in ref[-1]] == ["FINISHED"] * 3

"""The port's multi-tenant serving plane against the reference:
weighted-fair resource groups, the cluster memory manager and its
low-memory killer, memory-aware admission
(execution/resource_manager.py, spi/session.py) and the
``system.runtime.resource_groups`` rows.

Each case of the reference's tests/test_resource_manager.py runs the same
script through both packages: admission orders, kill victims, error codes
and system-table rows must be equal (and equal to what the reference's
test asserts).  The weighted-fair case is a throughput ratio under
saturation, so each package is held to the reference's band instead.
"""

import json
import threading
import time
from types import SimpleNamespace

import pytest
import torch

import trino_tpu.execution.control as RC
import trino_tpu.execution.resource_manager as RRM
import trino_tpu.spi.errors as RE
import trino_tpu.spi.memory as RMEM
import trino_tpu.spi.session as RSS
import trino_tpu.telemetry.metrics as RTM
import trino_tpu.telemetry.runtime as RRT
import trino_tpu_torch.execution.control as PC
import trino_tpu_torch.execution.resource_manager as PRM
import trino_tpu_torch.spi.errors as PE
import trino_tpu_torch.spi.memory as PMEM
import trino_tpu_torch.spi.session as PSS
import trino_tpu_torch.telemetry.metrics as PTM
import trino_tpu_torch.telemetry.runtime as PRT
from trino_tpu.caching import result_cache as ref_result_cache
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.execution.distributed_runner import (
    DistributedQueryRunner as RefDist)
from trino_tpu.runner import Session as RefSession
from trino_tpu.server import protocol as RPROTO
from trino_tpu_torch.caching import result_cache
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.execution.distributed_runner import (
    DistributedQueryRunner)
from trino_tpu_torch.runner import Session
from trino_tpu_torch.server import protocol as PPROTO

PINS = (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
        ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
        ("TRINO_TPU_OPTIMIZER", "iterative"))
SF = 0.01

REF = SimpleNamespace(
    name="reference", rm=RRM, control=RC, errors=RE, mem=RMEM, sel=RSS,
    metrics=RTM, runtime=RRT, proto=RPROTO,
    session=lambda **kw: RefSession(**kw),
    dist=lambda session: RefDist(ref_catalog(scale_factor=SF),
                                 worker_count=2, session=session))


def _port_session(**kw):
    # the control plane's stored properties go into ``properties``, as SET
    # SESSION puts them there
    props = {k: kw.pop(k) for k in ("query_concurrency", "query_max_queued")
             if k in kw}
    return Session(properties=props, **kw)


PORT = SimpleNamespace(
    name="port", rm=PRM, control=PC, errors=PE, mem=PMEM, sel=PSS,
    metrics=PTM, runtime=PRT, proto=PPROTO, session=_port_session,
    dist=lambda session: DistributedQueryRunner(
        default_catalog(SF), worker_count=2, session=session, device="cpu"))

PKGS = (REF, PORT)


@pytest.fixture(autouse=True)
def _pin(monkeypatch):
    # this file measures admission/memory/kill machinery on repeated
    # statements: a served cached result registers no memory handle and
    # would starve the killer
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


def _both(fn):
    """fn(pkg) for each package; the two results must be equal."""
    ref, port = fn(REF), fn(PORT)
    assert port == ref
    return ref


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _err(e) -> tuple:
    return (type(e).__name__, e.code.name, e.error_type)


# ----------------------------------------------------------- config parsing


TREE = json.dumps({
    "root": {
        "name": "global", "hard_concurrency_limit": 10,
        "scheduling_policy": "weighted_fair",
        "subgroups": [
            {"name": "etl", "weight": 3, "max_queued": 7,
             "soft_memory_limit_bytes": 1 << 30},
            {"name": "adhoc", "weight": 1, "soft_concurrency_limit": 2},
        ],
    },
    "selectors": [
        {"user": "etl_.*", "group": "etl"},
        {"source": "dashboard", "group": "adhoc"},
        {"group": ""},
    ],
})


def _tree(pkg) -> tuple:
    root, selector = pkg.rm.build_group_tree(TREE)
    etl = root.children["etl"]

    class S:
        user = "etl_nightly"
        source = ""
    picks = [selector("select 1", S())]
    S.user, S.source = "alice", "dashboard"
    picks.append(selector("select 1", S()))
    S.source = "cli"
    picks.append(selector("select 1", S()))
    return ([(g.name, g.hard_concurrency_limit, g.soft_concurrency_limit,
              g.max_queued, g.weight, g.scheduling_policy,
              g.soft_memory_limit_bytes) for g in root.walk()],
            (etl.name, etl.weight, etl.max_queued), picks)


def test_build_group_tree_from_json():
    groups, etl, picks = _both(_tree)
    assert groups[0][1] == 10 and groups[0][5] == "weighted_fair"
    assert etl == ("global.etl", 3, 7)
    assert picks == ["etl", "adhoc", ""]  # catch-all -> root


def _selector(pkg) -> tuple:
    sel = pkg.sel.GroupSelector.from_spec(
        [{"sql": r"(?i)insert\s", "group": "writes"}, {"group": "other"}])

    class S:
        pass
    out = (sel.select("INSERT into t values (1)", S()),
           sel.select("select 1", S()))
    try:
        pkg.sel.GroupSelector.from_spec([{"user": "x"}])
    except ValueError as e:
        return out, str(e)
    return out, None


def test_selector_sql_regex_and_missing_group_rejected():
    out, err = _both(_selector)
    assert out == ("writes", "other") and "without 'group'" in err


def _find(pkg) -> tuple:
    root = pkg.rm.ResourceGroup("global")
    sub = root.subgroup("etl").subgroup("nightly")
    return (pkg.rm.find_group(root, "global.etl.nightly") is sub,
            pkg.rm.find_group(root, ""), pkg.rm.find_group(root, "nope"))


def test_find_group_dotted_path():
    assert _both(_find) == (True, None, None)


# ------------------------------------------------- scheduling policies


def _churn(group, counts, key, stop, errors, work_s=0.002):
    while not stop.is_set():
        try:
            group.acquire(timeout=5.0)
        except errors:
            continue
        try:
            time.sleep(work_s)
            counts[key] += 1
        finally:
            group.release()


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_weighted_fair_converges_to_share_without_starvation(pkg):
    """Under saturation a 3:1 weighted pair completes work 3:1 (+-25%)
    and the light tenant is never starved, in each package."""
    root = pkg.rm.ResourceGroup("global", hard_concurrency_limit=4,
                                scheduling_policy="weighted_fair")
    heavy = root.subgroup("heavy", weight=3)
    light = root.subgroup("light", weight=1)
    counts = {"heavy": 0, "light": 0}
    stop = threading.Event()
    threads = [threading.Thread(
        target=_churn,
        args=(g, counts, k, stop, pkg.errors.TrinoError), daemon=True)
        for g, k in ((heavy, "heavy"), (light, "light")) for _ in range(5)]
    for t in threads:
        t.start()
    time.sleep(2.0)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert counts["light"] > 0, "light tenant starved"
    ratio = counts["heavy"] / counts["light"]
    assert 3.0 * 0.75 <= ratio <= 3.0 * 1.25, (counts, ratio)


def _waiters(g, prios, release_each: bool) -> list:
    g.acquire()
    order = []

    def waiter(i, prio):
        g.acquire(timeout=10, priority=prio)
        order.append(i)
        if not release_each:
            g.release()

    threads = []
    for i, prio in enumerate(prios):
        t = threading.Thread(target=waiter, args=(i, prio), daemon=True)
        t.start()
        threads.append(t)
        time.sleep(0.05)  # deterministic arrival order
    if release_each:
        # release one slot at a time; each wakes exactly one waiter
        for _ in prios:
            g.release()
            time.sleep(0.1)
    else:
        g.release()
    for t in threads:
        t.join(timeout=10)
    return order


def test_fair_policy_is_fifo():
    assert _both(lambda pkg: _waiters(
        pkg.rm.ResourceGroup("global", hard_concurrency_limit=1),
        [0, 0, 0], False)) == [0, 1, 2]


def test_query_priority_policy_admits_highest_first():
    assert _both(lambda pkg: _waiters(
        pkg.rm.ResourceGroup("global", hard_concurrency_limit=1,
                             scheduling_policy="query_priority"),
        [1, 5, 3], True)) == [1, 2, 0]  # prio 5, then 3, then 1


def _cpu_quota(pkg) -> tuple:
    clock = FakeClock()
    g = pkg.rm.ResourceGroup("global", hard_concurrency_limit=4,
                             hard_cpu_limit_s=1.0,
                             cpu_quota_generation_s_per_s=0.5, clock=clock)
    g.acquire()
    g.release(cpu_s=2.0)  # blow the quota
    try:
        g.acquire(timeout=0.05)
        first = None
    except pkg.errors.TrinoError as e:
        first = _err(e)
    clock.t += 4.0  # regenerates 2.0s of quota -> usage back to 0
    g.refresh()
    g.acquire(timeout=1.0)  # admitted again
    usage = g.cpu_usage_s
    g.release()
    return first, usage, g.running


def test_cpu_quota_blocks_and_regenerates():
    assert _both(_cpu_quota) == (
        ("TrinoError", "QUERY_QUEUED_TIMEOUT", "USER"), 0.0, 0)


def _soft_cpu(pkg) -> tuple:
    clock = FakeClock()
    g = pkg.rm.ResourceGroup("global", hard_concurrency_limit=4,
                             soft_cpu_limit_s=1.0, hard_cpu_limit_s=3.0,
                             clock=clock)
    g.acquire()
    g.release(cpu_s=2.0)  # halfway between soft and hard -> limit 2
    g.acquire()
    g.acquire()
    try:
        g.acquire(timeout=0.05)
    except pkg.errors.TrinoError as e:
        return _err(e), g.running
    return None, g.running


def test_soft_cpu_limit_scales_concurrency():
    assert _both(_soft_cpu) == (
        ("TrinoError", "QUERY_QUEUED_TIMEOUT", "USER"), 2)


# ------------------------------------------- admission rejection errors


def _queue_full(pkg) -> tuple:
    g = pkg.rm.ResourceGroup("g2", hard_concurrency_limit=1, max_queued=0)
    g.acquire()
    try:
        g.acquire(timeout=0.05)
    except RuntimeError as e:  # the historical contract
        return (_err(e), isinstance(e, pkg.errors.TrinoError),
                pkg.errors.classify(e) is e, str(e))
    return None


def test_queue_full_is_user_error_and_runtimeerror():
    err, is_trino, same, msg = _both(_queue_full)
    assert err == ("TrinoError", "QUERY_QUEUE_FULL", "USER")
    assert is_trino and same and "queue full" in msg


def _queued_timeout(pkg) -> tuple:
    g = pkg.rm.ResourceGroup("global", hard_concurrency_limit=1,
                             max_queued=10)
    g.acquire()
    t0 = time.monotonic()
    try:
        g.acquire(timeout=0.1)
    except pkg.errors.TrinoError as e:
        return _err(e), time.monotonic() - t0 < 5.0, g.queued
    return None


def test_queued_timeout_is_user_error():
    # the timed-out ticket left the queue
    assert _both(_queued_timeout) == (
        ("TrinoError", "QUERY_QUEUED_TIMEOUT", "USER"), True, 0)


def _not_retried(pkg) -> tuple:
    runner = pkg.dist(pkg.session(retry_policy="QUERY", query_concurrency=1,
                                  query_max_queued=0, node_count=2))
    runner.dispatcher.root.acquire()  # occupy the only slot
    try:
        try:
            runner.execute("select count(*) from nation")
            out = None
        except pkg.errors.TrinoError as e:
            out = _err(e)
        return out, runner.resilience.query_retries
    finally:
        runner.dispatcher.root.release()


def test_queue_full_not_retried_under_query_retry_policy():
    """A USER admission rejection surfaces at once: the query retry loop
    re-running it would just re-fail (and double-bill)."""
    assert _both(_not_retried) == (
        ("TrinoError", "QUERY_QUEUE_FULL", "USER"), 0)


# --------------------------------------------------- cluster memory manager


def _mk_handles(mm, specs):
    """specs: [(qid, priority, usage_bytes)] -> handles + synthetic usage."""
    handles = {}
    tasks = {}
    for i, (qid, prio, usage) in enumerate(specs):
        handles[qid] = mm.register_query(qid, priority=prio)
        tasks[f"t{i}"] = {"query_id": qid, "memory_reserved_bytes": usage}
    mm.update_worker("w0", {"tasks": tasks})
    return handles


def _victims(pkg, policy) -> tuple:
    mm = pkg.rm.ClusterMemoryManager(capacity_bytes=100, oom_policy=policy,
                                     enforce_interval_s=0.0)
    handles = _mk_handles(mm, [
        ("big", 5, 80),     # largest reservation
        ("low", 1, 50),     # lowest priority
        ("young", 9, 40),   # registered last
    ])
    killed = mm.enforce()
    return killed, {q: _err(h.killed_error()) for q, h in handles.items()
                    if h.killed}, mm.oom_kills, str(
        handles[killed[0]].killed_error())


@pytest.mark.parametrize("policy,victim", [
    ("largest_query", "big"),
    ("lowest_priority", "low"),
    ("youngest", "young"),
])
def test_oom_victim_policy_selection(policy, victim):
    killed, errors, kills, msg = _both(lambda pkg: _victims(pkg, policy))
    assert killed[0] == victim
    assert errors[victim] == ("TrinoError", "CLUSTER_OUT_OF_MEMORY",
                              "INSUFFICIENT_RESOURCES")
    assert kills == len(killed) and policy in msg


def _skip_zero(pkg) -> tuple:
    mm = pkg.rm.ClusterMemoryManager(capacity_bytes=100,
                                     oom_policy="lowest_priority",
                                     enforce_interval_s=0.0)
    handles = _mk_handles(mm, [
        ("idle", 0, 0),    # lowest priority but reserves nothing
        ("mid", 5, 90),
        ("top", 9, 60),
    ])
    return mm.enforce(), sorted(q for q, h in handles.items() if h.killed), \
        mm.oom_kills


def test_oom_killer_skips_zero_usage_and_stops_when_fitting():
    # killing idle frees nothing -> skipped; killing mid (90) fits 60<=100
    assert _both(_skip_zero) == (["mid"], ["mid"], 1)


def _max_memory(pkg) -> tuple:
    mm = pkg.rm.ClusterMemoryManager(capacity_bytes=None,
                                     enforce_interval_s=0.0)
    h = mm.register_query("q1", max_memory=10)
    mm.update_worker("w0", {"tasks": {
        "t0": {"query_id": "q1", "memory_reserved_bytes": 50}}})
    killed = mm.enforce()
    return killed, _err(h.killed_error()), mm.cluster_free_bytes()


def test_per_query_max_memory_kill():
    assert _both(_max_memory) == (
        ["q1"], ("TrinoError", "EXCEEDED_GLOBAL_MEMORY_LIMIT",
         "INSUFFICIENT_RESOURCES"),
        float("inf"))


def _snapshots(pkg) -> list:
    mm = pkg.rm.ClusterMemoryManager(capacity_bytes=None)
    mm.register_query("q1")
    mm.update_worker("w0", {"tasks": {
        "t0": {"query_id": "q1", "memory_reserved_bytes": 70}}})
    pool = pkg.mem.MemoryPool("hbm", 1 << 30)
    pool.reserve(30)
    mm.register_pool("q1", pool)
    out = [mm.reserved_by_query()]
    # a fresh snapshot replaces the node's view wholesale
    mm.update_worker("w0", {"tasks": {}})
    out.append(mm.reserved_by_query())
    del pool  # the pool dies with its task -> accounting follows
    out.append(mm.reserved_by_query())
    return out


def test_worker_snapshot_replacement_and_pool_weakref():
    assert _both(_snapshots) == [{"q1": 100}, {"q1": 30}, {}]


def _rollup(pkg) -> tuple:
    root = pkg.rm.ResourceGroup("global", hard_concurrency_limit=8)
    etl = root.subgroup("etl", soft_memory_limit_bytes=100)
    mm = pkg.rm.ClusterMemoryManager(capacity_bytes=None,
                                     enforce_interval_s=0.0)
    mm.register_query("q1", group=etl)
    mm.update_worker("w0", {"tasks": {
        "t0": {"query_id": "q1", "memory_reserved_bytes": 150}}})
    mm.enforce()
    usage = (etl.memory_usage_bytes, root.memory_usage_bytes)
    try:  # over the soft limit -> hold new work
        etl.acquire(timeout=0.05)
        held = None
    except pkg.errors.TrinoError as e:
        held = _err(e)
    mm.update_worker("w0", {"tasks": {}})
    mm.enforce()
    etl.acquire(timeout=1.0)  # headroom returned -> admitted
    etl.release()
    return usage, held, etl.memory_usage_bytes


def test_group_memory_rollup_blocks_admission():
    assert _both(_rollup) == (
        (150, 150), ("TrinoError", "QUERY_QUEUED_TIMEOUT", "USER"), 0)


# ------------------------------------------------ killed queries end to end


def _pressure_once(mm, pressure_bytes, done):
    """Kill exactly one registered query via a synthetic worker snapshot,
    then clear the pressure."""
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        with mm._lock:
            live = list(mm._handles.values())
        if live:
            h = live[0]
            mm.update_worker("pressure", {"tasks": {
                "t0": {"query_id": h.query_id,
                       "memory_reserved_bytes": pressure_bytes}}})
            mm.enforce()
            if h.killed:
                break
        time.sleep(0.002)
    mm.forget_worker("pressure")
    done.set()


def _killed_mid_query(pkg) -> tuple:
    runner = pkg.dist(pkg.session(node_count=2))
    runner.memory_manager = pkg.rm.ClusterMemoryManager(
        capacity_bytes=64 << 20, enforce_interval_s=0.0)
    done = threading.Event()
    th = threading.Thread(target=_pressure_once,
                          args=(runner.memory_manager, 256 << 20, done),
                          daemon=True)
    th.start()
    err = None
    try:
        for _ in range(2000):
            runner.execute("select count(*) from lineitem")
    except pkg.errors.TrinoError as e:
        err = _err(e)
    ok = done.wait(30)
    th.join(timeout=10)
    # steady state returns: the cluster runs queries again
    return err, ok, runner.execute("select count(*) from nation").rows()


def test_oom_kill_surfaces_cluster_out_of_memory():
    """The killer fires mid-query, the victim fails with
    CLUSTER_OUT_OF_MEMORY (no hang), and the next query completes."""
    assert _both(_killed_mid_query) == (
        ("TrinoError", "CLUSTER_OUT_OF_MEMORY", "INSUFFICIENT_RESOURCES"),
        True, [(25,)])


def _killed_reruns(pkg) -> tuple:
    runner = pkg.dist(pkg.session(retry_policy="QUERY",
                                  query_retry_attempts=3,
                                  retry_initial_delay_s=0.01, node_count=2))
    runner.memory_manager = pkg.rm.ClusterMemoryManager(
        capacity_bytes=64 << 20, enforce_interval_s=0.0)
    done = threading.Event()
    th = threading.Thread(target=_pressure_once,
                          args=(runner.memory_manager, 256 << 20, done),
                          daemon=True)
    th.start()
    rows = runner.execute("select count(*) from nation").rows()
    ok = done.wait(30)
    th.join(timeout=10)
    return rows, ok, runner.resilience.query_retries >= 1, \
        runner.memory_manager.oom_kills


def test_oom_killed_query_reruns_under_query_retry():
    """CLUSTER_OUT_OF_MEMORY is INSUFFICIENT_RESOURCES, so retryable: with
    retry_policy=QUERY the killed attempt re-runs and succeeds once the
    memory pressure clears."""
    assert _both(_killed_reruns) == ([(25,)], True, True, 1)


# ------------------------------------------------ memory-aware admission


def _estimate(pkg) -> tuple:
    rt = pkg.runtime
    sql = f"select 'estimate-probe-{pkg.name}' as c"
    fp = rt.fingerprint(sql)
    for peak in (100, 500, 300):
        rec = rt.query_started("qh", sql, "u")
        rt.query_finished(rec, "FINISHED", 1.0, 1.0, 1,
                          peak_memory_bytes=peak)
    return (pkg.rm.estimate_peak_memory(fp, 42),
            pkg.rm.estimate_peak_memory(rt.fingerprint("select 2, 3"), 42),
            rt.fingerprint(f"SELECT   'estimate-probe-{pkg.name}' AS c  ")
            == fp, rt.fingerprint("select 2, 3"))


def test_estimate_peak_memory_from_history():
    # the max of recent runs, not the mean; the fingerprint normalizes
    # whitespace and case, and is the same in both packages
    assert _both(_estimate)[:3] == (500, 42, True)


def _memory_admission(pkg) -> tuple:
    class StubRunner:
        memory_manager = pkg.rm.ClusterMemoryManager(
            capacity_bytes=100, enforce_interval_s=1e9)
        session = pkg.session(query_queued_timeout_s=0.2)
    StubRunner.memory_manager.update_worker("w0", {"tasks": {
        "t0": {"query_id": "hog", "memory_reserved_bytes": 100}}})
    d = pkg.proto.QueryDispatcher.__new__(pkg.proto.QueryDispatcher)
    d.runner = StubRunner()
    q = pkg.proto._Query("qid1", "select 1")
    try:
        d._await_memory(q)
        err = None
    except pkg.errors.TrinoError as e:
        err = _err(e)
    # cancellation exits the wait without error
    q.cancelled = True
    d._await_memory(q)
    return err, q.state


def test_dispatcher_memory_aware_admission_times_out():
    assert _both(_memory_admission) == (
        ("TrinoError", "QUERY_QUEUED_TIMEOUT", "USER"), "QUEUED")


# ------------------------------------------------- system tables + metrics


def _system_groups(pkg) -> tuple:
    spec = json.dumps({
        "root": {"name": "global", "hard_concurrency_limit": 8,
                 "scheduling_policy": "weighted_fair",
                 "subgroups": [{"name": "etl", "weight": 3}]},
        "selectors": [{"group": "etl"}],
    })
    root, selector = pkg.rm.build_group_tree(spec)
    runner = pkg.dist(pkg.session(node_count=2))
    runner.dispatcher = pkg.control.DispatchManager(root, selector)
    runner.execute("select count(*) from nation")
    rows = runner.execute(
        "select path, policy, weight, soft_concurrency_limit, "
        "hard_concurrency_limit, max_queued, running, queued "
        "from system.runtime.resource_groups").rows()
    # memory_bytes is the killer's last roll-up of live pools, which
    # depends on when its rate-limited pass ran: held non-negative only
    mem = [r[0] for r in runner.execute(
        "select memory_bytes from system.runtime.resource_groups").rows()]
    qrows = runner.execute(
        "select state, resource_group "
        "from system.runtime.queries").rows()
    queued = [r[0] for r in runner.execute(
        "select queued_time_ms from system.runtime.queries").rows()]
    mine = [r for r in qrows if r[1] == "global.etl"]
    return (sorted(rows), sorted(mine),
            all(q >= 0.0 for q in queued) and all(m >= 0 for m in mem))


def test_system_resource_groups_and_queued_time():
    rows, fin, queued_ok = _both(_system_groups)
    by_path = {r[0]: r for r in rows}
    assert by_path["global"][1] == "weighted_fair"
    assert by_path["global.etl"][2] == 3
    assert by_path["global"][6] >= 1  # the introspection query itself
    assert ("FINISHED", "global.etl") in fin and queued_ok


def _metrics(pkg) -> tuple:
    g = pkg.rm.ResourceGroup("mtest")
    g.acquire()
    g.release()
    mm = pkg.rm.ClusterMemoryManager(capacity_bytes=100,
                                     enforce_interval_s=0.0)
    mm.enforce()
    snap = pkg.metrics.REGISTRY.snapshot()
    return (snap["trino_admission_queued_seconds"]["kind"],
            snap["trino_oom_kills_total"]["kind"],
            snap["trino_cluster_memory_reserved_bytes"]["kind"],
            snap["trino_cluster_memory_free_bytes"]["value"],
            snap["trino_resource_group_running_mtest"]["value"],
            "trino_resource_group_queued_mtest" in snap,
            snap["trino_dispatcher_queries_total"]["kind"],
            snap["trino_exchange_bytes_total"]["kind"])


def test_serving_metrics_registered():
    assert _both(_metrics) == ("distribution", "counter", "gauge", 100.0,
                               0, True, "counter", "counter")


def _env_config(pkg, monkeypatch) -> tuple:
    spec = json.dumps({
        "root": {"name": "global", "hard_concurrency_limit": 3},
        "selectors": [{"source": "etl", "group": "batch"}],
    })
    monkeypatch.setenv("TRINO_TPU_RESOURCE_GROUPS", spec)
    dm = pkg.rm.build_dispatch_manager(pkg.session())
    out = (dm.root.hard_concurrency_limit,
           dm._group_for("select 1", pkg.session(source="etl")).name)
    monkeypatch.delenv("TRINO_TPU_RESOURCE_GROUPS")
    dm = pkg.rm.build_dispatch_manager(pkg.session(query_concurrency=7))
    return out + (dm.root.hard_concurrency_limit, dm.root.max_queued)


def test_build_dispatch_manager_env_config(monkeypatch):
    assert _both(lambda pkg: _env_config(pkg, monkeypatch)) == (
        3, "global.batch", 7, 200)

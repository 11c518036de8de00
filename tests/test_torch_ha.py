"""The port's HA control plane (trino_tpu_torch/execution/ha.py and
server/front_tier.py) held to the reference's.

Every case of tests/test_ha.py runs against the port on the CPU with the
reference's assertions: rendezvous ownership, the lease's lifecycle,
expiry and deposition, atomic claim races, WAL-directory adoption, the
front tier's routing and rerouting, the autoscaler's policy and the
``system.runtime.coordinators`` table.  Then the two packages share one
fleet directory: ``owner_of`` gives the reference's owner for every key
and member order, a lease written by either package is read by the
other, and each package claims the other's dead lease, takes custody of
its WAL directory and reads the WAL written there.  With
``TRINO_TPU_HA=0`` a server leaves no lease, thread or directory.

Hygiene for the xdist worker these tests share with other files: every
variable is set through ``monkeypatch``, every lease is released and
every server, tier and controller stopped, the module's fleet has a temp
directory of its own removed at teardown, ports are 0, and metric
counters are read as deltas.
"""

import itertools
import json
import os
import shutil
import tempfile
import threading
import time

import pytest
import torch

from trino_tpu.execution import ha as ref_ha
from trino_tpu.execution import query_state as ref_query_state
from trino_tpu.telemetry import journal as ref_journal
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.execution import ha, query_state
from trino_tpu_torch.execution.distributed_runner import (
    DistributedQueryRunner)
from trino_tpu_torch.runner import Session, StandaloneQueryRunner
from trino_tpu_torch.server.protocol import TrinoTpuServer
from trino_tpu_torch.telemetry import journal
from trino_tpu_torch.telemetry import metrics as tm

HA_KNOBS = ("TRINO_TPU_HA", "TRINO_TPU_HA_DIR", "TRINO_TPU_HA_NODE_ID",
            "TRINO_TPU_HA_LEASE_TTL_S", "TRINO_TPU_HA_HEARTBEAT_S",
            "TRINO_TPU_HA_ROUTE_RETRY_S", "TRINO_TPU_AUTOSCALE",
            "TRINO_TPU_AUTOSCALE_IDLE_ROUNDS",
            "TRINO_TPU_AUTOSCALE_INTERVAL_S",
            "TRINO_TPU_AUTOSCALE_MAX_WORKERS",
            "TRINO_TPU_AUTOSCALE_MIN_WORKERS", "TRINO_TPU_AUTOSCALE_QUEUE_S")


@pytest.fixture(autouse=True)
def _no_inherited_ha(monkeypatch):
    for knob in HA_KNOBS:
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture()
def ha_env(tmp_path, monkeypatch):
    root = tmp_path / "ha"
    monkeypatch.setenv("TRINO_TPU_HA", "1")
    monkeypatch.setenv("TRINO_TPU_HA_DIR", str(root))
    monkeypatch.setenv("TRINO_TPU_HA_LEASE_TTL_S", "5")
    monkeypatch.setenv("TRINO_TPU_HA_HEARTBEAT_S", "60")  # no async renew
    return str(root)


def _write_lease(root, nid, age_s=0.0, url="", epoch=1.0):
    d = ha.coordinators_dir(root)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, nid + ".json"), "w", encoding="utf-8") as f:
        json.dump({"node_id": nid, "url": url, "pid": 1, "epoch": epoch,
                   "ts": time.time() - age_s, "state": "ACTIVE"}, f)


# ---------------------------------------------------------- rendezvous
def test_owner_of_is_deterministic_and_minimally_disruptive():
    members = ["coord-a", "coord-b", "coord-c"]
    keys = [f"q{i:04d}" for i in range(200)]
    owners = {k: ha.owner_of(k, members) for k in keys}
    assert owners == {k: ha.owner_of(k, list(reversed(members)))
                      for k in keys}, "order must not matter"
    assert set(owners.values()) == set(members), "all members get keys"
    # removing one member remaps ONLY that member's keys
    survivors = ["coord-a", "coord-c"]
    for k in keys:
        if owners[k] != "coord-b":
            assert ha.owner_of(k, survivors) == owners[k]
    assert ha.owner_of("q", []) is None


# --------------------------------------------------------------- lease
def test_lease_register_expiry_and_directory(ha_env):
    lease = ha.CoordinatorLease("coord-x", url="http://h:1", root=ha_env,
                                ttl=5.0, interval=60.0).register()
    try:
        members = ha.read_members(ha_env, ttl=5.0)
        assert [m.node_id for m in members] == ["coord-x"]
        assert members[0].state == "ACTIVE"
        assert members[0].url == "http://h:1"
        assert members[0].age_s < 2.0
        # a lease past the TTL reads as EXPIRED and leaves live_members
        _write_lease(ha_env, "coord-stale", age_s=60.0)
        by_id = {m.node_id: m for m in ha.read_members(ha_env, ttl=5.0)}
        assert by_id["coord-stale"].state == "EXPIRED"
        assert [m.node_id for m in ha.live_members(ha_env, ttl=5.0)] \
            == ["coord-x"]
    finally:
        lease.release()
    assert not os.path.exists(lease.path), "release removes the lease"
    assert not lease._thread.is_alive()


def test_lease_deposed_when_claimed_out_from_under(ha_env):
    lease = ha.CoordinatorLease("coord-z", root=ha_env, ttl=5.0,
                                interval=60.0).register()
    try:
        assert lease.renew()
        os.remove(lease.path)  # a peer's claim rename, from our view
        assert not lease.renew()
        assert lease.deposed
        # a deposed lease never rewrites its file (zombie defense)
        assert not os.path.exists(lease.path)
    finally:
        lease.release()


def test_claim_dead_is_exactly_once_and_moves_wal(ha_env):
    _write_lease(ha_env, "coord-dead", age_s=60.0, epoch=7.0)
    wal_dir = ha.node_wal_dir("coord-dead", ha_env)
    os.makedirs(wal_dir)
    with open(os.path.join(wal_dir, "q1.wal"), "w", encoding="utf-8") as f:
        f.write("{}\n")

    wins_a = ha.claim_dead("coord-a", ha_env, ttl=5.0)
    wins_b = ha.claim_dead("coord-b", ha_env, ttl=5.0)
    assert [w[0] for w in wins_a] == ["coord-dead"]
    assert wins_b == [], "second claimant must lose the rename race"
    claimed_dir = wins_a[0][1]
    assert claimed_dir and os.path.isdir(claimed_dir)
    assert not os.path.isdir(wal_dir), "WAL custody moved to the claimant"
    assert os.path.exists(os.path.join(claimed_dir, "q1.wal"))
    assert ha.claimed_wal_dirs("coord-a", ha_env) == [claimed_dir]
    # an ACTIVE peer is never claimed
    _write_lease(ha_env, "coord-live", age_s=0.0)
    assert ha.claim_dead("coord-a", ha_env, ttl=5.0) == []


def test_concurrent_claim_single_winner(ha_env):
    _write_lease(ha_env, "coord-dead", age_s=60.0)
    wins: list = []

    def claim(me):
        wins.extend(ha.claim_dead(me, ha_env, ttl=5.0))

    threads = [threading.Thread(target=claim, args=(f"coord-{i}",))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(wins) == 1, f"exactly one winner, got {wins}"


# ------------------------------------------------------------ adoption
class _StubDispatcher:
    def __init__(self):
        self.adopted: list = []

    def adopt(self, pq) -> bool:
        self.adopted.append(pq.query_id)
        return True

    def in_flight(self) -> int:
        return len(self.adopted)


class _StubServer:
    address = ("127.0.0.1", 0)

    def __init__(self):
        self.dispatcher = _StubDispatcher()


def test_ha_coordinator_step_claims_and_adopts(ha_env):
    # a dead peer with one resumable query in its WAL dir
    _write_lease(ha_env, "coord-dead", age_s=60.0)
    wal = query_state.QueryStateLog(
        "q_orphan", dir=ha.node_wal_dir("coord-dead", ha_env))
    wal.begin("select 1", {"plan": 1}, "/s", None)
    wal.close()
    # and one already-ended query that must NOT be adopted
    wal2 = query_state.QueryStateLog(
        "q_done", dir=ha.node_wal_dir("coord-dead", ha_env))
    wal2.begin("select 2", {"plan": 2}, "/s", None)
    wal2.end("FINISHED")
    wal2.close()

    srv = _StubServer()
    coord = ha.HACoordinator(srv, nid="coord-b", root=ha_env, ttl=5.0,
                             interval=60.0)
    before = tm.HA_TAKEOVERS.value(), tm.HA_ADOPTED_QUERIES.value()
    assert coord.step() == ["coord-dead"]
    assert srv.dispatcher.adopted == ["q_orphan"]
    assert coord.takeovers == ["coord-dead"]
    assert coord.step() == [], "a claimed lease cannot be claimed twice"
    assert (tm.HA_TAKEOVERS.value(), tm.HA_ADOPTED_QUERIES.value()) == \
        (before[0] + 1, before[1] + 1)


def test_ha_coordinator_reboot_readopts_claimed_custody(ha_env):
    """A claimant that crashed mid-adoption re-adopts from its claimed
    dirs at the next boot."""
    _write_lease(ha_env, "coord-dead", age_s=60.0)
    wal = query_state.QueryStateLog(
        "q_orphan2", dir=ha.node_wal_dir("coord-dead", ha_env))
    wal.begin("select 3", {"plan": 3}, "/s", None)
    wal.close()
    assert ha.claim_dead("coord-b", ha_env, ttl=5.0)

    srv = _StubServer()
    coord = ha.HACoordinator(srv, nid="coord-b", root=ha_env, ttl=5.0,
                             interval=60.0)
    coord.start()
    try:
        assert srv.dispatcher.adopted == ["q_orphan2"]
    finally:
        coord.stop()
    assert not coord._watcher.is_alive()
    assert not os.path.exists(coord.lease.path)


# ---------------------------------------------------------- front tier
@pytest.fixture(scope="module")
def fleet():
    """Two statement servers over ONE shared in-process runner on the CPU
    (the catalog builds once), each registered in a fleet directory of
    its own, removed at teardown."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tempfile.mkdtemp(prefix="trino-tpu-torch-ha-fleet-")
    runner = DistributedQueryRunner(
        default_catalog(scale_factor=0.01), worker_count=2,
        session=Session(node_count=2), device="cpu")
    servers = {}
    leases = {}
    try:
        for nid in ("coord-a", "coord-b"):
            srv = TrinoTpuServer(runner).start()
            servers[nid] = srv
            host, port = srv.address
            leases[nid] = ha.CoordinatorLease(
                nid, url=f"http://{host}:{port}", root=root, ttl=30.0,
                interval=60.0).register()
        yield root, servers
    finally:
        for lease in leases.values():
            lease.release()
        for srv in servers.values():
            srv.stop()
        shutil.rmtree(root, ignore_errors=True)
        torch.set_num_threads(threads)


def _drain(tier, first: dict, timeout_s: float = 60.0) -> tuple:
    """Follow nextUri through the tier until terminal; -> (state, rows)."""
    from urllib.request import urlopen

    host, port = tier.address
    out, rows = first, list(first.get("data", []))
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        state = out.get("stats", {}).get("state")
        nxt = out.get("nextUri")
        if state == "FAILED" or (state == "FINISHED" and not nxt):
            return state, rows
        with urlopen(f"http://{host}:{port}{nxt}", timeout=30) as resp:
            out = json.loads(resp.read())
        rows += out.get("data", [])
    return "TIMEOUT", rows


def test_front_tier_routes_post_to_hash_owner(fleet):
    from urllib.request import Request, urlopen

    from trino_tpu_torch.server.front_tier import FrontTier

    root, servers = fleet
    tier = FrontTier(root=root, ttl=30.0, retry_s=2.0).start()
    try:
        host, port = tier.address
        req = Request(f"http://{host}:{port}/v1/statement",
                      data=b"select count(*) from nation", method="POST")
        with urlopen(req, timeout=60) as resp:
            first = json.loads(resp.read())
        qid = first["id"]
        state, rows = _drain(tier, first)
        assert state == "FINISHED"
        assert rows == [[25]]
        # the query landed on (exactly) the rendezvous owner
        owner = ha.owner_of(qid, ["coord-a", "coord-b"])
        assert servers[owner].dispatcher.get(qid) is not None
        other = "coord-b" if owner == "coord-a" else "coord-a"
        assert servers[other].dispatcher.get(qid) is None
    finally:
        tier.stop()


def test_front_tier_reroutes_when_owner_disowns_query(fleet):
    """A query living on the NON-owner (post-takeover shape: the claimant
    adopted it, the hash still points at the dead node's successor) is
    found by the probe-all-members pass and served."""
    from urllib.request import urlopen

    from trino_tpu_torch.server.front_tier import FrontTier

    root, servers = fleet
    tier = FrontTier(root=root, ttl=30.0, retry_s=2.0).start()
    try:
        host, port = tier.address
        # place a finished query directly on a chosen server, under a qid
        # whose hash owner is the OTHER server
        for probe in range(1000):
            qid = f"reroute{probe:04d}"
            if ha.owner_of(qid, ["coord-a", "coord-b"]) == "coord-a":
                continue
            break
        q = servers["coord-a"].dispatcher.submit(
            "select count(*) from region", qid=qid)
        assert q.done.wait(timeout=60)
        before = tm.HA_REROUTES.value()
        with urlopen(f"http://{host}:{port}/v1/statement/{qid}/0",
                     timeout=60) as resp:
            out = json.loads(resp.read())
        state, rows = _drain(tier, out)
        assert state == "FINISHED"
        assert rows == [[5]]
        assert tm.HA_REROUTES.value() == before + 1
        # the pin is warm now: the next poll must not re-count a reroute
        with urlopen(f"http://{host}:{port}/v1/statement/{qid}/0",
                     timeout=60) as resp:
            json.loads(resp.read())
        assert tm.HA_REROUTES.value() == before + 1
    finally:
        tier.stop()


def test_front_tier_synthetic_queued_inside_retry_window(fleet):
    """While NO member knows the query (mid-takeover), polls inside the
    retry budget get a synthetic QUEUED page with an unchanged nextUri;
    past the budget the truth (404) surfaces."""
    from urllib.error import HTTPError
    from urllib.request import urlopen

    from trino_tpu_torch.server.front_tier import FrontTier

    root, _servers = fleet
    tier = FrontTier(root=root, ttl=30.0, retry_s=0.4).start()
    try:
        host, port = tier.address
        path = "/v1/statement/nosuchquery00001/0"
        with urlopen(f"http://{host}:{port}{path}", timeout=60) as resp:
            out = json.loads(resp.read())
        assert out["stats"]["state"] == "QUEUED"
        assert out["nextUri"] == path
        time.sleep(0.6)
        with pytest.raises(HTTPError) as exc:
            urlopen(f"http://{host}:{port}{path}", timeout=60)
        assert exc.value.code == 404
    finally:
        tier.stop()


# ---------------------------------------------------------- autoscaler
class _ScalableRunner:
    def __init__(self, n: int):
        self.n = n

    @property
    def active_worker_count(self) -> int:
        return self.n

    def add_worker(self):
        self.n += 1

    def remove_worker(self):
        self.n -= 1
        return f"w{self.n}"


def test_autoscaler_grows_under_queue_pressure_and_respects_ceiling():
    r = _ScalableRunner(1)
    asc = ha.WorkerAutoscaler(r, min_workers=1, max_workers=3,
                              queue_s=0.5, idle_rounds=2, interval_s=999)
    assert asc.step(queued_delta_s=1.0) == "up" and r.n == 2
    assert asc.step(queued_delta_s=1.0) == "up" and r.n == 3
    assert asc.step(queued_delta_s=1.0) is None, "ceiling reached"
    assert r.n == 3


def test_autoscaler_drains_after_idle_rounds_and_respects_floor():
    r = _ScalableRunner(3)
    asc = ha.WorkerAutoscaler(r, min_workers=1, max_workers=3,
                              queue_s=0.5, idle_rounds=2, interval_s=999)
    assert asc.step(queued_delta_s=0.0) is None, "one idle round is not enough"
    assert asc.step(queued_delta_s=0.0) == "down" and r.n == 2
    assert asc.step(queued_delta_s=0.0) is None
    assert asc.step(queued_delta_s=0.0) == "down" and r.n == 1
    for _ in range(4):
        assert asc.step(queued_delta_s=0.0) is None, "floor reached"
    assert r.n == 1
    # pressure resets the idle streak
    r2 = _ScalableRunner(2)
    asc2 = ha.WorkerAutoscaler(r2, min_workers=1, max_workers=3,
                               queue_s=0.5, idle_rounds=2, interval_s=999)
    assert asc2.step(queued_delta_s=0.0) is None
    assert asc2.step(queued_delta_s=9.9) == "up"
    assert asc2.step(queued_delta_s=0.0) is None, "streak was reset"


def test_autoscaler_reads_admission_queue_metric():
    r = _ScalableRunner(1)
    asc = ha.WorkerAutoscaler(r, min_workers=1, max_workers=2,
                              queue_s=0.5, idle_rounds=99, interval_s=999)
    assert asc.step() is None, "no queueing recorded yet"
    tm.ADMISSION_QUEUED_SECONDS.record(0.7)
    assert asc.step() == "up", "queued-seconds delta must trigger growth"
    assert asc.step() is None, "the delta was consumed"


def test_autoscaler_logical_drain_on_inprocess_runner(fleet):
    """Against the real in-process runner the scale-down path is a logical
    drain (NodeManager), and scale-up restores the drained slot."""
    _root, servers = fleet
    runner = servers["coord-a"].dispatcher.runner
    n0 = runner.active_worker_count
    asc = ha.WorkerAutoscaler(runner, min_workers=1, max_workers=n0,
                              queue_s=0.5, idle_rounds=1, interval_s=999)
    try:
        assert asc.step(queued_delta_s=0.0) == "down"
        assert runner.active_worker_count == n0 - 1
        assert asc.step(queued_delta_s=1.0) == "up"
        assert runner.active_worker_count == n0
    finally:
        for nid in list(asc._drained):
            runner.restore_worker(nid)


def test_autoscale_knob_runs_a_controller_with_the_server(monkeypatch):
    """``TRINO_TPU_AUTOSCALE=1``: a statement server over a runner with
    workers runs a WorkerAutoscaler by the ``TRINO_TPU_AUTOSCALE_*`` knobs
    while it serves, and stops it with itself; here its pressure-free
    rounds drain one of the in-process runner's two workers.  Unset, a
    server runs none."""
    runner = DistributedQueryRunner(
        default_catalog(scale_factor=0.01), worker_count=2,
        session=Session(node_count=2), device="cpu")
    srv = TrinoTpuServer(runner).start()
    srv.stop()
    assert srv.autoscaler is None
    for knob, value in (("TRINO_TPU_AUTOSCALE", "1"),
                        ("TRINO_TPU_AUTOSCALE_INTERVAL_S", "0.05"),
                        ("TRINO_TPU_AUTOSCALE_IDLE_ROUNDS", "2"),
                        ("TRINO_TPU_AUTOSCALE_QUEUE_S", "3600"),
                        ("TRINO_TPU_AUTOSCALE_MIN_WORKERS", "1")):
        monkeypatch.setenv(knob, value)
    srv = TrinoTpuServer(runner).start()
    asc = srv.autoscaler
    try:
        assert (asc.interval_s, asc.idle_rounds, asc.min_workers) == \
            (0.05, 2, 1)
        deadline = time.monotonic() + 30.0
        while runner.active_worker_count > 1 and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert runner.active_worker_count == 1
        assert asc.events[0][:2] == ("down", 1)
    finally:
        srv.stop()
    assert srv.autoscaler is None and not asc._thread.is_alive()


# ------------------------------------------- system.runtime.coordinators
def test_coordinators_table_without_ha(fleet):
    _root, servers = fleet
    runner = servers["coord-a"].dispatcher.runner
    rows = runner.execute(
        "select coordinator, state, url from system.runtime.coordinators"
    ).rows()
    assert len(rows) == 1
    assert rows[0][1] == "ACTIVE"


def test_coordinators_table_reads_fleet(fleet, monkeypatch):
    root, servers = fleet
    monkeypatch.setenv("TRINO_TPU_HA", "1")
    monkeypatch.setenv("TRINO_TPU_HA_DIR", root)
    monkeypatch.setenv("TRINO_TPU_HA_LEASE_TTL_S", "30")
    runner = servers["coord-a"].dispatcher.runner
    rows = runner.execute(
        "select coordinator, state, lease_age_ms, in_flight_queries, url "
        "from system.runtime.coordinators order by coordinator").rows()
    by_id = {r[0]: r for r in rows}
    assert set(by_id) == {"coord-a", "coord-b"}
    for r in rows:
        assert r[1] == "ACTIVE"
        assert r[2] >= 0.0
        assert r[4].startswith("http://")


# ------------------------------------------- one fleet, both packages
MEMBER_SETS = (["coord-a", "coord-b", "coord-c"],
               ["coordA", "coordB"],
               [f"coord-host-{i}" for i in range(5)])


@pytest.mark.parametrize("members", MEMBER_SETS,
                         ids=("three", "drill", "five"))
def test_owner_of_equals_the_references(members):
    keys = [f"q{i:04d}" for i in range(200)]
    for order in itertools.islice(itertools.permutations(members), 6):
        order = list(order)
        assert [ha.owner_of(k, order) for k in keys] == \
            [ref_ha.owner_of(k, members) for k in keys]
    assert ha.owner_of("q", []) is ref_ha.owner_of("q", []) is None


def _package(name: str):
    return (ha, query_state) if name == "port" else (ref_ha, ref_query_state)


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_a_lease_is_read_by_the_other_package(tmp_path, writer, reader):
    root = str(tmp_path / "ha")
    w_ha, _ = _package(writer)
    r_ha, _ = _package(reader)
    lease = w_ha.CoordinatorLease(
        "coord-w", url="http://127.0.0.1:1", root=root, ttl=5.0,
        interval=60.0, info_fn=lambda: {"in_flight": 3}).register()
    try:
        with open(lease.path, encoding="utf-8") as f:
            rec = json.load(f)
        assert sorted(rec) == ["epoch", "in_flight", "node_id", "pid",
                               "state", "ts", "url"]
        (m,) = r_ha.read_members(root, ttl=5.0)
        assert (m.node_id, m.url, m.pid, m.epoch, m.state, m.in_flight) == \
            ("coord-w", "http://127.0.0.1:1", os.getpid(), lease.epoch,
             "ACTIVE", 3)
        assert [x.node_id for x in r_ha.live_members(root, ttl=5.0)] == \
            ["coord-w"]
        # the other package reads the lease as expired past its TTL
        time.sleep(0.01)
        assert r_ha.read_members(root, ttl=0.005)[0].state == "EXPIRED"
    finally:
        lease.release()
    assert r_ha.read_members(root, ttl=5.0) == []


@pytest.mark.parametrize("writer,claimant", [("ref", "port"),
                                             ("port", "ref")])
def test_a_dead_lease_is_claimed_by_the_other_package(tmp_path, writer,
                                                      claimant):
    """The dead coordinator's lease and WAL come from one package; the
    other claims the lease, moves the WAL directory into its custody,
    reads the WAL there and adopts the query."""
    root = str(tmp_path / "ha")
    w_ha, w_qs = _package(writer)
    c_ha, c_qs = _package(claimant)
    lease = w_ha.CoordinatorLease("coord-dead", root=root, ttl=5.0,
                                  interval=60.0)
    lease._write()  # a lease that is never renewed again: a dead node
    wal = w_qs.QueryStateLog("q_orphan",
                             dir=w_ha.node_wal_dir("coord-dead", root))
    wal.begin("select 1", {"plan": 1}, "/spool/q_orphan", None,
              task_counts={0: 2}, consumer_tasks={0: 1})
    wal.attempt_start(0, 0, 0, "task")
    wal.attempt_committed(0, 0, 0, "/spool/q_orphan/f0_t0_a0", "task")
    wal.attempt_start(0, 1, 0, "task")
    wal.close()

    assert c_ha.claim_dead("coord-live", root, ttl=5.0) == [], \
        "a fresh lease is not claimed"
    wins = c_ha.claim_dead("coord-live", root, ttl=0.0)
    assert [w[0] for w in wins] == ["coord-dead"]
    claimed_dir = wins[0][1]
    assert os.path.basename(claimed_dir).startswith(
        f"coord-dead.claimed-coord-live-{lease.epoch:.6f}")
    assert os.listdir(os.path.join(root, "claims")) == \
        [f"coord-dead-{lease.epoch:.6f}.lease"]
    assert not os.path.exists(lease.path)
    assert c_ha.claimed_wal_dirs("coord-live", root) == \
        w_ha.claimed_wal_dirs("coord-live", root) == [claimed_dir]
    # a deposed writer's renewal finds its lease gone
    assert not lease.renew() and lease.deposed

    pq = c_qs.load(os.path.join(claimed_dir, "q_orphan.wal"))
    ref_pq = w_qs.load(os.path.join(claimed_dir, "q_orphan.wal"))
    assert (pq.query_id, pq.sql, pq.spool_root, pq.ended) == \
        (ref_pq.query_id, ref_pq.sql, ref_pq.spool_root, ref_pq.ended) == \
        ("q_orphan", "select 1", "/spool/q_orphan", None)
    assert pq.committed == ref_pq.committed == {
        (0, 0): {"attempt": 0, "dir": "/spool/q_orphan/f0_t0_a0",
                 "kind": "task"}}
    assert pq.attempt_counts == ref_pq.attempt_counts == \
        {(0, 0): 1, (0, 1): 1}
    assert pq.task_counts == ref_pq.task_counts == {"0": 2}
    assert [p.query_id for p in c_qs.pending(claimed_dir)] == ["q_orphan"]

    # the claimant's coordinator re-adopts the claimed custody at boot
    srv = _StubServer()
    coord = c_ha.HACoordinator(srv, nid="coord-live", root=root, ttl=5.0,
                               interval=60.0)
    coord.start()
    try:
        assert srv.dispatcher.adopted == ["q_orphan"]
    finally:
        coord.stop()


@pytest.mark.parametrize("ha_on", [True, False], ids=["ha", "single"])
def test_boot_sweep_keeps_the_spool_of_claimed_custody(tmp_path, monkeypatch,
                                                       ha_on):
    """A claimant that crashed mid-adoption boots again: its dispatcher's
    spool sweep must not reclaim the spool root of a query in a WAL
    directory it claimed (the root's lease names the dead coordinator's
    pid) before ``HACoordinator.start`` adopts the query again.  With HA
    off the sweep reclaims such a root, as before."""
    from trino_tpu_torch.execution import spool_gc
    from trino_tpu_torch.server import protocol

    root = str(tmp_path / "ha")
    spool = tmp_path / "spool"
    monkeypatch.setenv("TRINO_TPU_SPOOL_DIR", str(spool))
    monkeypatch.setenv("TRINO_TPU_QUERY_STATE_DIR", str(tmp_path / "own"))
    monkeypatch.setenv("TRINO_TPU_HA_NODE_ID", "coord-b")
    monkeypatch.setenv("TRINO_TPU_HA_DIR", root)
    if ha_on:
        monkeypatch.setenv("TRINO_TPU_HA", "1")
    sroot = spool / (spool_gc.SPOOL_PREFIX + "q_orphan")
    sroot.mkdir(parents=True)
    with open(sroot / spool_gc.LEASE_FILE, "w", encoding="utf-8") as f:
        json.dump({"query_id": "q_orphan", "pid": 2 ** 31 - 1,
                   "ts": time.time(), "ttl_s": 3600.0}, f)
    wal = query_state.QueryStateLog("q_orphan", dir=os.path.join(
        ha.wal_root(root), "coord-dead.claimed-coord-b-1.000000"))
    wal.begin("select 1", {"plan": 1}, str(sroot), None)
    wal.close()
    dispatcher = protocol.QueryDispatcher(object())  # boot recovery + sweep
    dispatcher.pool.shutdown()
    assert sroot.exists() == ha_on


# ---------------------------------------------------- TRINO_TPU_HA=0
def test_ha_off_leaves_no_lease_thread_or_directory(tmp_path, monkeypatch):
    root = tmp_path / "ha"
    monkeypatch.setenv("TRINO_TPU_HA_DIR", str(root))
    before = {n: m.value() for n, m in tm.REGISTRY._metrics.items()
              if n.startswith("trino_ha_")}
    threads = set(threading.enumerate())
    srv = TrinoTpuServer(StandaloneQueryRunner(default_catalog(0.01),
                                               device="cpu")).start()
    try:
        rows = srv.dispatcher.runner.execute(
            "select state, in_flight_queries from "
            "system.runtime.coordinators").rows()
    finally:
        srv.stop()
    assert rows == [("ACTIVE", 0)]
    assert not root.exists()
    assert not [t.name for t in set(threading.enumerate()) - threads
                if t.name.startswith("ha-")]
    assert {n: m.value() for n, m in tm.REGISTRY._metrics.items()
            if n.startswith("trino_ha_")} == before


def test_journal_stream_per_node_is_the_references(tmp_path, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_HA_NODE_ID", "coord/a b")
    port = journal.QueryJournal(directory=str(tmp_path))
    ref = ref_journal.QueryJournal(directory=str(tmp_path))
    assert port.path == ref.path == str(tmp_path /
                                        "query_journal-coord_a_b.jsonl")
    monkeypatch.delenv("TRINO_TPU_HA_NODE_ID")
    assert journal.QueryJournal(directory=str(tmp_path)).path == \
        str(tmp_path / "query_journal.jsonl")

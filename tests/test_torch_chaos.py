"""The port's chaos harness (trino_tpu_torch/testing/chaos.py) against the
reference's.

The mix, the user-error statement, the fault menus and the drill's
statement equal the reference's, and so do the seeded steps: for seeds
1009 and 1010 (and the FTE seeds 1515, 1516) the (sql, fault, task,
stall, drain victim) sequence of :func:`chaos.scenario_plan` equals what
the reference's ``run_scenario`` / ``run_fte_scenario`` drive, recorded
through a stand-in runner and injector.  Then the reference's tier-1
gates on the port, on the CPU, each in a subprocess of its own with a
timeout and its state under ``tmp_path``: the in-process chaos smoke
(seeds 1009, 1010, five queries each, tests/test_chaos.py:319), the FTE
smoke (seed 1515, :498), the coordinator kill -9 drill
(tests/test_query_state.py:216) and the HA fleet's peer takeover drill
(:267); every query accounted, zero hangs.  A
device fault (a CUDA error, a kernel library that did not build) is
unexpected and never retried.  Process-mode chaos and the two soaks are
marked slow, as the reference marks its soak.
"""

import json
import os
import subprocess
import sys
import types

import pytest

from trino_tpu.testing import chaos as ref_chaos
from trino_tpu_torch.caching import result_cache
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.execution.distributed_runner import (
    DistributedQueryRunner)
from trino_tpu_torch.ops import gpu_kernels as GK
from trino_tpu_torch.runner import Session
from trino_tpu_torch.spi.errors import (DEVICE_FAULT, GENERIC_INTERNAL_ERROR,
                                        classify, lookup_code)
from trino_tpu_torch.testing import chaos
from trino_tpu_torch.testing.oracle import SqliteOracle, load_tables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPROCESS_S = 300


def test_mix_and_menus_equal_reference():
    assert chaos.QUERY_MIX == ref_chaos.QUERY_MIX
    assert chaos.USER_ERROR_SQL == ref_chaos.USER_ERROR_SQL
    assert chaos._INPROC_FAULTS == ref_chaos._INPROC_FAULTS
    assert chaos._PROCESS_FAULTS == ref_chaos._PROCESS_FAULTS
    assert chaos._FTE_FAULTS == ref_chaos._FTE_FAULTS
    assert chaos._DRILL_SQL == ref_chaos._DRILL_SQL
    assert chaos._TABLES == ref_chaos._TABLES
    assert chaos.CATALOG_SPEC == {
        "factory": "trino_tpu_torch.connectors.catalog:default_catalog",
        "kwargs": {"scale_factor": 0.01}}
    assert chaos._env("cpu") == {"CHAOS_DEVICE": "cpu",
                                 "OMP_NUM_THREADS": "1"}
    assert chaos._env("cuda") == {"CHAOS_DEVICE": "cuda"}


def _reference_steps(monkeypatch, seed: int, mode: str, n: int) -> list:
    """What the reference's scenario drives for ``seed``: its runner and
    injector replaced by recorders (every query returns no rows)."""
    steps: list = []
    pending: list = []

    class Injector:
        def inject(self, kind, fragment_id=None, task_index=None,
                   attempt=None, times=None, stall_s=None):
            pending.append((kind, task_index, stall_s))

    class Runner:
        def __init__(self, *a, **kw):
            self.resilience = types.SimpleNamespace(query_retries=0)
            self.workers = ["w0", "w1"]

        def execute(self, sql):
            steps.append({"sql": sql, "inject": list(pending),
                          "drain": None})
            pending.clear()
            return types.SimpleNamespace(rows=lambda: [])

        def drain_worker(self, victim, **kw):
            steps[-1]["drain"] = victim

        def restore_worker(self, victim):
            pass

        def close(self):
            pass

    from trino_tpu.execution import remote as ref_remote

    monkeypatch.setattr(ref_chaos, "DistributedQueryRunner", Runner)
    monkeypatch.setattr(ref_remote, "ProcessDistributedQueryRunner", Runner)
    monkeypatch.setattr(ref_chaos, "FailureInjector", Injector)
    monkeypatch.setattr(ref_chaos, "default_catalog", lambda **kw: None)
    expected = {sql: [] for sql in ref_chaos.QUERY_MIX}
    if mode == "fte":
        ref_chaos.run_fte_scenario(seed, n_queries=n, expected=expected)
    else:
        ref_chaos.run_scenario(seed, mode=mode, n_queries=n,
                               expected=expected)
    return steps


@pytest.mark.parametrize("seed,mode", [
    (1009, "inproc"), (1010, "inproc"), (1009, "process"),
    (1010, "process"), (1515, "fte"), (1516, "fte")])
def test_scenario_steps_equal_reference(monkeypatch, seed, mode):
    n = 6 if mode == "fte" else 8
    want = _reference_steps(monkeypatch, seed, mode, n)
    plan = chaos.scenario_plan(seed, mode, n)
    assert len(plan) == len(want) == n
    for got, ref in zip(plan, want):
        assert got["sql"] == ref["sql"]
        if got["fault"] == "drain":
            victim = (f"worker-{got['victim']}" if mode == "inproc"
                      else f"w{got['victim']}")
            assert ref["drain"] == victim and ref["inject"] == []
        elif got["fault"] == "none":
            assert ref["drain"] is None and ref["inject"] == []
        else:
            assert ref["inject"] == [(got["fault"], got["task_index"],
                                      got.get("stall_s"))]


def test_scenarios_are_a_pure_function_of_the_seed():
    assert chaos.scenario_plan(1009, "inproc", 8) == \
        chaos.scenario_plan(1009, "inproc", 8)
    assert chaos.scenario_plan(1009, "inproc", 8) != \
        chaos.scenario_plan(1010, "inproc", 8)
    # a longer scenario extends a shorter one of the same seed
    assert chaos.scenario_plan(1515, "fte", 8)[:6] == \
        chaos.scenario_plan(1515, "fte", 6)


# ---------------------------------------------------------------------------
# device faults: unexpected, never a classified retry


@pytest.mark.parametrize("exc", [
    RuntimeError("hash_insert_launch: CUDA error 700"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("the kernel library build/kernels/libtrino_kernels.so is "
                 "missing or older than its sources"),
    OSError("build/kernels/libtrino_kernels.so: cannot open shared object"),
    RuntimeError("/usr/local/cuda/bin/nvcc -c csrc/hash_table.cu failed"),
    type("OutOfMemoryError", (RuntimeError,), {})("CUDA out of memory.")])
def test_device_fault_is_classified_unretryable(exc):
    te = classify(exc)
    assert te.code is DEVICE_FAULT and not te.is_retryable()
    # across the wire a worker's task status names the code
    assert lookup_code("DEVICE_FAULT", "INTERNAL") is DEVICE_FAULT
    outcome, detail = chaos._classify_outcome(
        chaos.QUERY_MIX[0], None, te, False, False, {})
    assert outcome == "unexpected" and detail.startswith("device fault")


@pytest.mark.parametrize("seam", ["fused", "collective"])
@pytest.mark.parametrize("exc,code", [
    (RuntimeError("hash_insert_launch: CUDA error 700"), "DEVICE_FAULT"),
    (RuntimeError("boom"), "GENERIC_INTERNAL_ERROR")])
def test_a_seam_keeps_a_device_fault_unretryable(seam, exc, code):
    """A fused seam's merge or a collective shuffle that fails hands every
    waiting consumer a TrinoError: a device fault keeps its code (the
    merge calls hash_insert), anything else stays a retryable internal
    error."""
    import threading

    from trino_tpu_torch.execution.collective_exchange import (
        CollectiveRepartitionExchange)
    from trino_tpu_torch.execution.stage_compiler import FusedStageExec
    from trino_tpu_torch.spi.errors import TrinoError

    cls = FusedStageExec if seam == "fused" else \
        CollectiveRepartitionExchange
    ex = cls.__new__(cls)
    ex.spec = types.SimpleNamespace(producer_fid=1, consumer_fid=0)
    ex._done = threading.Event()
    ex._done.set()
    ex._error = exc
    with pytest.raises(TrinoError) as err:
        ex.take(0, timeout=1.0)
    assert err.value.code.name == code
    assert err.value.is_retryable() == (code != "DEVICE_FAULT")
    assert err.value.__cause__ is exc


def test_other_internal_errors_stay_retryable():
    te = classify(RuntimeError("boom"))
    assert te.code is GENERIC_INTERNAL_ERROR and te.is_retryable()


def test_device_fault_fails_the_query_without_retry(monkeypatch):
    """A kernel that fails to launch under retry_policy=QUERY: the query
    fails at once (no query retry) and the harness calls it
    unexpected."""

    def failing(*a, **kw):
        raise RuntimeError("hash_insert_launch: CUDA error 700")

    monkeypatch.setattr(GK, "hash_insert_plain", failing)
    runner = DistributedQueryRunner(
        default_catalog(0.01), worker_count=2, device="cpu",
        session=Session(node_count=2, retry_policy="QUERY",
                        retry_initial_delay_s=0.01))
    sql = chaos.QUERY_MIX[4]  # the join: its build is a hash_insert
    with result_cache.disabled():
        rows, exc, hung, _wall = chaos._execute_watched(runner, sql, 60)
    assert not hung and rows is None and exc is not None
    assert runner.resilience.query_retries == 0
    outcome, detail = chaos._classify_outcome(sql, rows, exc, hung, False,
                                              {})
    assert outcome == "unexpected", detail


# ---------------------------------------------------------------------------
# worker replacement under a drain (found by the process-mode soak)


class _Worker:
    def __init__(self, url: str, alive: bool):
        self.url = url
        self._alive = alive
        self.killed = False
        self.proc = types.SimpleNamespace(wait=lambda timeout=None: 0)

    def alive(self) -> bool:
        return self._alive and not self.killed

    def kill(self) -> None:
        self.killed = True


def _fleet(workers: list, on_state=None):
    """A process runner's replacement state around stand-in workers; the
    detector reads every worker as GONE and runs ``on_state`` first (a
    drain on another thread refilling the slot meanwhile)."""
    import threading

    from trino_tpu_torch.execution import remote
    from trino_tpu_torch.execution.failure_detector import GONE
    from trino_tpu_torch.exec.stats import ResilienceStats

    runner = remote.ProcessDistributedQueryRunner.__new__(
        remote.ProcessDistributedQueryRunner)
    runner.workers = list(workers)
    runner._fleet_lock = threading.RLock()
    runner.session = Session(node_count=len(workers))
    runner.resilience = ResilienceStats()
    runner.resilience_events = []
    runner._replacements_used = 0
    runner.spawned = []

    def spawn():
        w = _Worker(f"new{len(runner.spawned)}", True)
        runner.spawned.append(w)
        return w

    def state_of(url):
        if on_state is not None:
            on_state(runner)
        return GONE

    runner._spawn = spawn
    runner._monitor_worker = lambda w: None
    runner.failure_detector = types.SimpleNamespace(
        sweep_once=lambda: None, state_of=state_of,
        unmonitor=lambda url: None)
    return runner


def test_self_heal_replaces_a_gone_worker_once():
    dead = _Worker("dead", False)
    runner = _fleet([dead])
    runner._replace_gone_workers()
    assert runner.workers == runner.spawned and len(runner.spawned) == 1
    assert runner.resilience.worker_replacements == 1


def test_self_heal_leaves_a_slot_a_drain_refilled():
    """A query retry's self-heal reads the drained worker as GONE while the
    drain puts its own replacement into the slot: the heal spawns nothing,
    so no worker process is left outside the fleet (and past close())."""
    dead, refill = _Worker("dead", False), _Worker("refill", True)

    def drain_refills(runner):
        runner.workers[0] = refill

    runner = _fleet([dead], on_state=drain_refills)
    runner._replace_gone_workers()
    assert runner.workers == [refill] and runner.spawned == []
    assert runner.resilience.worker_replacements == 0


def test_self_heal_leaves_a_worker_the_autoscaler_removes():
    """The autoscaler's scale-down drains a worker WITHOUT a replacement;
    a query retry's self-heal that reads the drained worker as GONE
    meanwhile must not respawn it (the fleet would not shrink) or take
    it out of the list under remove_worker (which then failed with
    list.remove on the card)."""
    from trino_tpu_torch.execution.failure_detector import GONE

    keep, leaving = _Worker("keep", True), _Worker("leaving", True)
    runner = _fleet([keep, leaving])
    runner.failure_detector.state_of = \
        lambda url: GONE if url == "leaving" else "ACTIVE"

    def drain(w, timeout_s=None, replace=True):
        assert not replace
        w._alive = False  # the drained worker exits ...
        runner._replace_gone_workers()  # ... while a retry heals the fleet

    runner.drain_worker = drain
    assert runner.remove_worker() == "leaving"
    assert runner.workers == [keep] and runner.spawned == []
    assert runner.resilience.worker_replacements == 0
    assert runner.resilience_events == [("scale", "leaving", "removed")]


# ---------------------------------------------------------------------------
# the reference's tier-1 gates, on the port, on the CPU


def _run(prog: str, tmp_path) -> dict:
    env = dict(os.environ)
    env.update(chaos._env("cpu"))
    env.update({
        "TRINO_TPU_SPOOL_DIR": str(tmp_path / "spool"),
        "TRINO_TPU_QUERY_STATE_DIR": str(tmp_path / "state"),
        "TRINO_TPU_JOURNAL_DIR": str(tmp_path / "journal"),
        "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
    })
    out = subprocess.run([sys.executable, "-c", prog], env=env,
                         capture_output=True, text=True,
                         timeout=SUBPROCESS_S, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.splitlines()[-1])


def test_chaos_smoke_fixed_seed(tmp_path):
    """Two in-process scenarios (10 queries) from fixed seeds on the CPU:
    every query oracle-correct, retried, or correctly classified; zero
    hangs."""
    prog = (
        "import json\n"
        "from trino_tpu_torch.testing.chaos import build_expected, "
        "run_scenario\n"
        "expected = build_expected()\n"
        "recs = [run_scenario(s, mode='inproc', n_queries=5,"
        " expected=expected, device='cpu') for s in (1009, 1010)]\n"
        "print(json.dumps([{'seed': r['seed'], 'counts': r['counts'],"
        " 'n': len(r['outcomes']), 'device': r['device']}"
        " for r in recs]))\n"
    )
    recs = _run(prog, tmp_path)
    assert [r["seed"] for r in recs] == [1009, 1010]
    assert {r["device"] for r in recs} == {"cpu"}
    assert sum(r["n"] for r in recs) == 10
    assert sum(r["counts"].get("hang", 0) for r in recs) == 0, \
        "chaos smoke produced a hang"
    assert sum(r["counts"].get("unexpected", 0) for r in recs) == 0, \
        "chaos smoke produced an unaccounted outcome"


def test_fte_chaos_smoke_fixed_seed(tmp_path):
    """One seeded scenario over the FTE fault menu (task failure / stall /
    OOM, results-fetch failure, spool corruption) on the CPU: every query
    accounted, zero hangs."""
    prog = (
        "import json\n"
        "from trino_tpu_torch.testing.chaos import build_expected, "
        "run_fte_scenario\n"
        "rec = run_fte_scenario(1515, n_queries=6,"
        " expected=build_expected(), device='cpu')\n"
        "print(json.dumps({'counts': rec['counts'],"
        " 'n': len(rec['outcomes'])}))\n"
    )
    rec = _run(prog, tmp_path)
    assert rec["n"] == 6
    assert rec["counts"].get("hang", 0) == 0, "FTE chaos smoke hung"
    assert rec["counts"].get("unexpected", 0) == 0, \
        "FTE chaos smoke produced an unaccounted outcome"


def test_coordinator_kill9_restart_resume(tmp_path):
    """SIGKILL the coordinator process mid-FTE-query, restart it, and the
    query finishes oracle-correct under its original id with zero
    re-execution of committed attempts and the spool root reclaimed."""
    rec = chaos.run_coordinator_kill_drill(
        workdir=str(tmp_path), device="cpu", boot_timeout_s=120.0,
        finish_timeout_s=120.0)
    assert rec["state"] == "FINISHED", rec.get("error")
    assert rec["committed_at_kill"] >= 1
    assert rec["committed_reexecuted"] == {}, \
        "committed attempts were re-executed after the restart"
    assert rec["resumed_attempt_starts"], \
        "the resumed coordinator did no work at all"
    assert rec["wal_ended"] == "FINISHED"
    assert rec["spool_reclaimed"]
    assert rec["pass"]
    assert rec["boot1_s"] > 0 and rec["boot2_s"] > 0
    # a CPU coordinator launches no kernel; the counts are published
    assert rec["launches_epoch2"] == {k: 0 for k in GK.LAUNCHES}

    # oracle-correct rows through the reattached client surface
    oracle = load_tables(SqliteOracle(),
                         default_catalog(0.01).connector("tpch"),
                         ["lineitem"])
    expected = oracle.query(chaos._DRILL_SQL)
    got = [tuple(row) for row in rec["rows"]]

    def norm(rows):
        out = []
        for row in rows:
            cells = []
            for v in row:
                try:  # "368805.00" (server JSON) vs 368805.0 (sqlite)
                    cells.append(round(float(v), 2))
                except (TypeError, ValueError):
                    cells.append(str(v))
            out.append(tuple(cells))
        return sorted(out, key=str)

    assert norm(got) == norm(expected)


def test_ha_peer_takeover_kill9(tmp_path):
    """Coordinator A of a two-member fleet commits >=1 attempt and dies by
    SIGKILL; peer B claims A's expired lease (an atomic rename), takes
    custody of A's WAL directory and finishes the query under its
    original id, with no committed attempt re-executed, polled the whole
    time through B's statement surface (tests/test_query_state.py:267,
    on the port's CPU path)."""
    rec = chaos.run_ha_takeover_drill(
        workdir=str(tmp_path), device="cpu", boot_timeout_s=120.0,
        finish_timeout_s=120.0)
    assert rec["state"] == "FINISHED", rec.get("error")
    assert rec["committed_at_kill"] >= 1
    assert rec["committed_reexecuted"] == {}, \
        "committed attempts were re-executed after the takeover"
    assert rec["claimed_dirs"], "B never took custody of A's WAL dir"
    assert rec["wal_ended"] == "FINISHED"
    assert rec["lease_a_gone"], "A's lease must leave the directory"
    assert rec["pass"]
    # the adopted query's rows are the drill aggregation (4 flag/status
    # groups at sf=0.01)
    assert len(rec["rows"]) == 4
    # a takeover, not a deposition: nothing was claimed while A lived
    assert rec["claimed_before_kill"] == [] and rec["lease_a_at_kill"]
    assert rec["takeovers_b"] == ["coordA"]
    assert rec["boot_a_s"] > 0 and rec["boot_b_s"] > 0
    # CPU coordinators launch no kernel; the counts are published
    assert rec["launches_b"] == {k: 0 for k in GK.LAUNCHES}


# ---------------------------------------------------------------------------
# slow: real worker processes, and the soaks


@pytest.mark.slow
def test_process_chaos_scenario(tmp_path, monkeypatch):
    """One process-mode scenario (two worker processes on the CPU, with
    PROCESS_EXIT kills and real drains): zero hangs, zero unexpected."""
    monkeypatch.setenv("TRINO_TPU_SPOOL_DIR", str(tmp_path / "spool"))
    rec = chaos.run_scenario(1013, mode="process", n_queries=5,
                             device="cpu")
    assert len(rec["outcomes"]) == 5
    assert rec["counts"].get("hang", 0) == 0
    assert rec["counts"].get("unexpected", 0) == 0, rec["outcomes"]


@pytest.mark.slow
def test_chaos_soak_full(tmp_path, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_SPOOL_DIR", str(tmp_path / "spool"))
    summary = chaos.run_chaos(n_scenarios=25, base_seed=1009,
                              verbose=False, device="cpu")
    assert summary["hangs"] == 0
    assert summary["unexpected"] == 0
    assert summary["all_accounted"]
    assert summary["n_queries"] >= 25


@pytest.mark.slow
def test_fte_chaos_soak_full(tmp_path, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_SPOOL_DIR", str(tmp_path / "spool"))
    summary = chaos.run_fte_chaos(n_scenarios=12, base_seed=1515,
                                  verbose=False, device="cpu")
    assert summary["hangs"] == 0
    assert summary["unexpected"] == 0
    assert summary["all_accounted"]
    assert summary["n_queries"] >= 12

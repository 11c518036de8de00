"""Randomized fault-injection soak harness ("chaos certification").

The port of the reference ``testing/chaos.py``, without its HA takeover
drill (the HA coordinator fleet is not in the port yet).  Seeded scenario
generator that drives the engine-level FailureInjector (TASK_FAILURE /
TASK_STALL / TASK_OOM / GET_RESULTS_FAILURE / PROCESS_EXIT /
SPOOL_CORRUPTION) plus live coordinator-driven drains under a sustained
TPC-H query mix, and checks the invariant the resilience plane promises:

    every query either returns oracle-correct rows (possibly after a
    classified retry under retry_policy=QUERY), or fails fast with a
    correctly classified USER / unretryable error.  Nothing hangs.

Scenarios are a pure function of ``(base_seed, scenario_index)`` —
``random.Random(seed)`` picks the SQL, the fault kind, the target task
and the drain victims (:func:`scenario_plan`, in the reference's order of
draws, so a seed gives the reference's sequence) — and any failing
scenario replays exactly from its seed.  Two modes:

- ``inproc``  : DistributedQueryRunner (threads), cheap; covers the
  in-process injection sites, speculation and logical drain/restore.
- ``process`` : ProcessDistributedQueryRunner (real worker processes on
  the runner's device), expensive; adds PROCESS_EXIT hard-kills and real
  PUT /v1/shutdown drains with worker replacement mid-query.

Every query runs under a watchdog thread: a query that neither returns
nor raises within the budget is recorded as outcome="hang" (the soak's
acceptance gate requires zero of those).  A fault of the card or of the
kernel library (``spi.errors.DEVICE_FAULT``: a CUDA error, a library that
did not build, bind or launch) is never retried and always comes out as
outcome="unexpected".

What differs from the reference: every entry point takes the ``device``
its runners use (``"cuda"`` unless the caller passes ``"cpu"``) and the
TPC-H ``scale_factor`` (0.01, the reference's, by default).  The oracle
loads only the columns the mix reads, so that its sqlite tables stay
affordable at SF 1.  Each scenario record carries ``launches``, the
kernel launches of its queries: counted in this process for the
in-process runners and summed over the workers' ``GET /v1/info`` for
``process`` mode; the kill drill's coordinator child publishes its own.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Optional

from ..connectors.catalog import default_catalog
from ..execution.distributed_runner import DistributedQueryRunner
from ..execution.failure_injector import (
    GET_RESULTS_FAILURE,
    PROCESS_EXIT,
    SPOOL_CORRUPTION,
    TASK_FAILURE,
    TASK_OOM,
    TASK_STALL,
    FailureInjector,
)
from ..runner import Session
from ..spi.errors import is_device_fault
from .oracle import SqliteOracle, assert_same_rows, load_tables

__all__ = ["QUERY_MIX", "USER_ERROR_SQL", "build_expected",
           "scenario_plan", "run_scenario", "run_chaos", "run_fte_scenario",
           "run_fte_chaos", "run_coordinator_kill_drill", "catalog_spec"]

SCALE_FACTOR = 0.01


def catalog_spec(scale_factor: float = SCALE_FACTOR) -> dict:
    """The catalog a worker process (or the drill's coordinator child)
    rebuilds: the port's default catalog at ``scale_factor``."""
    return {"factory": "trino_tpu_torch.connectors.catalog:default_catalog",
            "kwargs": {"scale_factor": scale_factor}}


CATALOG_SPEC = catalog_spec()

# what a child process of the harness (a worker, the drill's coordinator)
# is given: the port's device; a worker gets it from its coordinator as
# --device, the drill's coordinator child reads CHAOS_DEVICE
_ENV = {"CHAOS_DEVICE": "cuda"}


def _env(device) -> dict:
    env = dict(_ENV, CHAOS_DEVICE=str(device))
    if str(device).startswith("cpu"):
        # one intra-op thread a process: two workers and a coordinator
        # share the host's cores
        env["OMP_NUM_THREADS"] = "1"
    return env


_TABLES = ["customer", "orders", "lineitem"]
# the columns the mix reads: all the oracle loads
_MIX_COLUMNS = {
    "customer": ("c_custkey", "c_mktsegment", "c_acctbal"),
    "orders": ("o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice",
               "o_orderpriority"),
    "lineitem": ("l_returnflag", "l_linestatus", "l_quantity"),
}

# Sustained mix: scans, multi-key aggregation, filtered join — all
# checkable against the sqlite oracle with an unordered row compare.
QUERY_MIX = [
    "select count(*) from lineitem",
    "select l_returnflag, l_linestatus, count(*), sum(l_quantity) "
    "from lineitem group by l_returnflag, l_linestatus "
    "order by l_returnflag, l_linestatus",
    "select o_orderstatus, count(*), sum(o_totalprice) from orders "
    "group by o_orderstatus order by o_orderstatus",
    "select c_mktsegment, count(*), sum(c_acctbal) from customer "
    "group by c_mktsegment order by c_mktsegment",
    "select o_orderpriority, count(*) from orders, customer "
    "where o_custkey = c_custkey and c_mktsegment = 'BUILDING' "
    "group by o_orderpriority order by o_orderpriority",
    "select count(*), sum(o_totalprice) from orders "
    "where o_totalprice > 100000",
]

# USER-classified error: must fail fast with ZERO retries even while
# faults are being injected around it.
USER_ERROR_SQL = \
    "select o_orderkey / (o_orderkey - o_orderkey) from orders"

# Fault menu per mode.  "none" keeps a healthy baseline inside every
# scenario; "drain" is a live coordinator-driven drain mid-query.
_INPROC_FAULTS = ["none", "none", TASK_FAILURE, TASK_STALL, TASK_OOM,
                  GET_RESULTS_FAILURE, "drain"]
_PROCESS_FAULTS = _INPROC_FAULTS + [PROCESS_EXIT]
# FTE (retry_policy=TASK) leg: the streaming menu minus drains (FTE's
# stage-by-stage loop has no placement to drain in-process) plus
# SPOOL_CORRUPTION — a byte flipped inside a committed spool part file
# right before a consumer reads it, which must surface as a CRC-classified
# SpoolCorruptionError and re-execute only the corrupted producer
_FTE_FAULTS = ["none", "none", TASK_FAILURE, TASK_STALL, TASK_OOM,
               GET_RESULTS_FAILURE, SPOOL_CORRUPTION]


def build_expected(scale_factor: float = SCALE_FACTOR) -> dict:
    """Oracle rows for every SQL in QUERY_MIX (computed once per soak —
    expected rows are a pure function of the dataset at
    ``scale_factor``)."""
    conn = default_catalog(scale_factor=scale_factor).connector("tpch")
    oracle = load_tables(SqliteOracle(), conn, _TABLES, _MIX_COLUMNS)
    return {sql: oracle.query(sql) for sql in QUERY_MIX}


def _draw(rng: random.Random, faults: list, stall_base: float,
          stall_span: float) -> dict:
    """One query's draws, in the reference's order: the SQL, the fault,
    the target task, then the stall or the drain's delay and victim."""
    sql = USER_ERROR_SQL if rng.random() < 0.12 else rng.choice(QUERY_MIX)
    fault = rng.choice(faults)
    step = {"sql": sql, "fault": fault, "task_index": rng.randrange(2)}
    if fault == TASK_STALL:
        step["stall_s"] = round(stall_base + rng.random() * stall_span, 2)
    elif fault == "drain":
        step["drain_after_s"] = 0.02 + rng.random() * 0.15
        step["victim"] = rng.randrange(2)
    return step


def scenario_plan(seed: int, mode: str = "inproc",
                  n_queries: int = 8) -> list:
    """The seeded steps of one scenario (``mode`` inproc, process or
    fte): a pure function of the seed."""
    rng = random.Random(seed)
    if mode == "fte":
        faults, base, span = _FTE_FAULTS, 0.5, 0.8
    else:
        faults = _INPROC_FAULTS if mode == "inproc" else _PROCESS_FAULTS
        base, span = 0.3, 0.5
    return [_draw(rng, faults, base, span) for _ in range(n_queries)]


def _arm(inj: FailureInjector, step: dict) -> None:
    fault = step["fault"]
    if fault == TASK_STALL:
        inj.inject(TASK_STALL, fragment_id=None,
                   task_index=step["task_index"], attempt=0, times=1,
                   stall_s=step["stall_s"])
    elif fault not in ("none", "drain"):
        inj.inject(fault, fragment_id=None, task_index=step["task_index"],
                   attempt=0, times=1)


def _execute_watched(runner, sql: str, timeout_s: float):
    """Run ``runner.execute(sql)`` under a watchdog.  Returns
    (rows | None, exception | None, hung: bool, wall_s)."""
    holder: dict = {}

    def _work():
        try:
            holder["rows"] = runner.execute(sql).rows()
        except BaseException as e:  # noqa: BLE001 - classified by caller
            holder["exc"] = e

    t0 = time.monotonic()
    th = threading.Thread(target=_work, daemon=True, name="chaos-query")
    th.start()
    th.join(timeout_s)
    wall = time.monotonic() - t0
    if th.is_alive():
        return None, None, True, wall
    return holder.get("rows"), holder.get("exc"), False, wall


def _classify_outcome(sql, rows, exc, hung, retried, expected):
    if hung:
        return "hang", "watchdog timeout"
    if exc is not None and is_device_fault(exc):
        return "unexpected", f"device fault: {type(exc).__name__}: {exc}"
    if sql == USER_ERROR_SQL:
        if exc is not None and "DIVISION_BY_ZERO" in str(exc):
            return "classified_failure", None
        return "unexpected", f"user error not classified: {exc!r}"
    if exc is not None:
        return "unexpected", f"{type(exc).__name__}: {exc}"
    try:
        assert_same_rows(rows, expected[sql], ordered=False)
    except AssertionError as e:
        return "unexpected", f"oracle mismatch: {e}"
    return ("ok_after_retry" if retried else "ok"), None


def _local_launches() -> dict:
    from ..ops import gpu_kernels as GK

    return dict(GK.LAUNCHES)


def _worker_launches(runner) -> dict:
    """worker url -> its kernel launches since boot (``/v1/info``)."""
    out = {}
    for w in runner.workers:
        try:
            if w.alive():
                out[w.url] = w.info()["launches"]
        except Exception:  # noqa: BLE001 — a worker gone mid-read
            continue
    return out


def _add_delta(total: dict, before: dict, after: dict) -> None:
    for k, n in after.items():
        total[k] = total.get(k, 0) + n - before.get(k, 0)


def _counts(outcomes: list) -> dict:
    counts: dict = {}
    for o in outcomes:
        counts[o["outcome"]] = counts.get(o["outcome"], 0) + 1
    return counts


def run_scenario(seed: int, mode: str = "inproc", n_queries: int = 8,
                 expected: Optional[dict] = None,
                 query_timeout_s: Optional[float] = None,
                 device="cuda", scale_factor: float = SCALE_FACTOR) -> dict:
    """One seeded chaos scenario: a fresh 2-worker runner on ``device``,
    ``n_queries`` queries from the mix, each with a seeded fault (or
    none), plus live drains.  Returns {"seed", "mode", "outcomes": [...],
    counts, launches...}."""
    if expected is None:
        expected = build_expected(scale_factor)
    plan = scenario_plan(seed, mode, n_queries)
    timeout = query_timeout_s or (30.0 if mode == "inproc" else 90.0)
    inj = FailureInjector()
    session = Session(node_count=2, retry_policy="QUERY",
                      failure_injector=inj, retry_initial_delay_s=0.01,
                      speculation=True,
                      properties={"heartbeat_interval_s": 0.2,
                                  "drain_timeout_s": 5.0})
    if mode == "inproc":
        runner = DistributedQueryRunner(
            default_catalog(scale_factor=scale_factor), worker_count=2,
            session=session, device=device)
    else:
        from ..execution.remote import ProcessDistributedQueryRunner
        runner = ProcessDistributedQueryRunner(
            catalog_spec(scale_factor), worker_count=2, session=session,
            env_overrides=_env(device), device=device)

    from ..caching import result_cache

    outcomes = []
    launches: dict = {}
    try:
        # the soak certifies *execution* under faults — a cached result for
        # a repeated mix query would skip the fragment path and leave the
        # armed injection waiting for the wrong query
        with result_cache.disabled():
            for qi, step in enumerate(plan):
                sql, fault = step["sql"], step["fault"]
                _arm(inj, step)
                retries_before = runner.resilience.query_retries
                before = (_local_launches() if mode == "inproc"
                          else _worker_launches(runner))
                if fault == "drain":
                    rows, exc, hung, wall = _run_with_drain(
                        runner, sql, mode, step, timeout)
                else:
                    rows, exc, hung, wall = _execute_watched(
                        runner, sql, timeout)
                if mode == "inproc":
                    _add_delta(launches, before, _local_launches())
                else:
                    after = _worker_launches(runner)
                    for url, counts in after.items():
                        _add_delta(launches, before.get(url, {}), counts)
                retried = runner.resilience.query_retries > retries_before
                outcome, detail = _classify_outcome(
                    sql, rows, exc, hung, retried, expected)
                outcomes.append({
                    "query": qi, "sql": sql, "fault": fault,
                    "task_index": step["task_index"],
                    "outcome": outcome, "detail": detail,
                    "wall_s": round(wall, 3), "retried": retried,
                })
                if outcome == "hang":
                    break  # the runner is wedged; stop the scenario here
    finally:
        close = getattr(runner, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass

    return {"seed": seed, "mode": mode, "device": str(device),
            "outcomes": outcomes, "counts": _counts(outcomes),
            "launches": launches,
            "speculative_starts": getattr(runner, "speculative_starts", 0),
            "speculative_wins": getattr(runner, "speculative_wins", 0)}


def _run_with_drain(runner, sql, mode, step, timeout_s):
    """Run a query and drain the step's worker mid-flight.  In-proc the
    drain is logical (stop scheduling; restore afterwards); process mode
    issues a real PUT /v1/shutdown and replaces the worker."""
    holder: dict = {}

    def _work():
        try:
            holder["rows"] = runner.execute(sql).rows()
        except BaseException as e:  # noqa: BLE001
            holder["exc"] = e

    t0 = time.monotonic()
    th = threading.Thread(target=_work, daemon=True, name="chaos-query")
    th.start()
    time.sleep(step["drain_after_s"])
    if mode == "inproc":
        victim = f"worker-{step['victim']}"
        try:
            runner.drain_worker(victim)
            th.join(timeout_s)
        finally:
            runner.restore_worker(victim)
    else:
        victim = runner.workers[step["victim"]]
        runner.drain_worker(victim, replace=True)
        th.join(timeout_s)
    wall = time.monotonic() - t0
    if th.is_alive():
        return None, None, True, wall
    return holder.get("rows"), holder.get("exc"), False, wall


def run_fte_scenario(seed: int, n_queries: int = 6,
                     expected: Optional[dict] = None,
                     query_timeout_s: float = 45.0, device="cuda",
                     scale_factor: float = SCALE_FACTOR) -> dict:
    """One seeded FTE chaos scenario: a fresh 2-worker runner on
    ``device`` under ``retry_policy="TASK"``, each query with a seeded
    fault from the FTE menu (including SPOOL_CORRUPTION bit flips on
    committed spool files).  The acceptance invariant is the streaming
    soak's: every query is oracle-correct, classified, or — never —
    hung."""
    from ..caching import result_cache
    from ..telemetry import metrics as tm

    if expected is None:
        expected = build_expected(scale_factor)
    inj = FailureInjector()
    session = Session(node_count=2, retry_policy="TASK",
                      failure_injector=inj, task_retry_attempts=4,
                      fte_speculative=True, fte_speculative_delay_s=0.3)
    runner = DistributedQueryRunner(
        default_catalog(scale_factor=scale_factor), worker_count=2,
        session=session, device=device)

    outcomes = []
    launches: dict = {}
    with result_cache.disabled():
        for qi, step in enumerate(scenario_plan(seed, "fte", n_queries)):
            sql, fault = step["sql"], step["fault"]
            _arm(inj, step)
            retries_before = tm.FTE_ATTEMPT_RETRIES.value()
            corrupt_before = tm.FTE_SPOOL_CORRUPTIONS.value()
            before = _local_launches()
            rows, exc, hung, wall = _execute_watched(
                runner, sql, query_timeout_s)
            _add_delta(launches, before, _local_launches())
            retried = tm.FTE_ATTEMPT_RETRIES.value() > retries_before
            outcome, detail = _classify_outcome(
                sql, rows, exc, hung, retried, expected)
            outcomes.append({
                "query": qi, "sql": sql, "fault": fault,
                "task_index": step["task_index"],
                "outcome": outcome, "detail": detail,
                "wall_s": round(wall, 3), "retried": retried,
                "spool_corruption_repairs":
                    tm.FTE_SPOOL_CORRUPTIONS.value() - corrupt_before,
            })
            if outcome == "hang":
                break

    return {"seed": seed, "mode": "fte", "device": str(device),
            "outcomes": outcomes, "counts": _counts(outcomes),
            "launches": launches}


def _summary(scenarios: list, n_scenarios: int, base_seed: int) -> dict:
    totals: dict = {}
    for rec in scenarios:
        for k, v in rec["counts"].items():
            totals[k] = totals.get(k, 0) + v
    return {
        "n_scenarios": n_scenarios,
        "base_seed": base_seed,
        "n_queries": sum(len(r["outcomes"]) for r in scenarios),
        "totals": totals,
        "hangs": totals.get("hang", 0),
        "unexpected": totals.get("unexpected", 0),
        "all_accounted": (totals.get("hang", 0) == 0
                          and totals.get("unexpected", 0) == 0),
        "scenarios": scenarios,
    }


def run_fte_chaos(n_scenarios: int = 12, base_seed: int = 1515,
                  fte_queries: int = 6, verbose: bool = True,
                  device="cuda", scale_factor: float = SCALE_FACTOR) -> dict:
    """The FTE chaos leg: seeded scenarios over the FTE fault menu.
    Same acceptance booleans as ``run_chaos`` (100% of queries accounted,
    zero hangs)."""
    expected = build_expected(scale_factor)
    scenarios = []
    for i in range(n_scenarios):
        t0 = time.monotonic()
        rec = run_fte_scenario(base_seed + i, n_queries=fte_queries,
                               expected=expected, device=device,
                               scale_factor=scale_factor)
        rec["scenario"] = i
        rec["wall_s"] = round(time.monotonic() - t0, 2)
        scenarios.append(rec)
        if verbose:
            print(f"  fte chaos scenario {i:2d} seed={base_seed + i} "
                  f"{rec['counts']} ({rec['wall_s']:.1f}s)", flush=True)
    return _summary(scenarios, n_scenarios, base_seed)


# ---------------------------------------------------- coordinator kill -9
_DRILL_SQL = ("select l_returnflag, l_linestatus, count(*), "
              "sum(l_quantity) from lineitem group by l_returnflag, "
              "l_linestatus order by l_returnflag, l_linestatus")


def _publish_launches(path: str) -> None:
    """Rewrite ``path`` with this process's kernel launch counts every
    0.2 s (atomic rename), for the drill's parent to read."""
    while True:
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(_local_launches(), f)
        os.replace(tmp, path)
        time.sleep(0.2)


def _coordinator_child() -> None:
    """Subprocess entry for the coordinator-kill drill: boot a 2-worker
    FTE coordinator on ``CHAOS_DEVICE`` at ``CHAOS_SF`` behind the HTTP
    statement protocol, write the bound port to ``CHAOS_PORT_FILE``
    (atomic rename), publish its kernel launches to ``CHAOS_PORT_FILE``
    + ``.launches``, and serve until killed.  ``CHAOS_STALL_S`` arms a
    one-shot TASK_STALL on task 0 of the first stage scheduled — the
    deterministic 'mid-query' the parent kills into; with
    ``fte_speculative`` off nothing can rescue the stall, so the kill is
    guaranteed to land with the query in flight."""
    from ..server.protocol import TrinoTpuServer

    inj = None
    stall_s = float(os.environ.get("CHAOS_STALL_S", "0") or 0)
    if stall_s > 0:
        inj = FailureInjector()
        inj.inject(TASK_STALL, fragment_id=None, task_index=0, attempt=0,
                   times=1, stall_s=stall_s)
    session = Session(node_count=2, retry_policy="TASK",
                      fte_speculative=False, failure_injector=inj)
    runner = DistributedQueryRunner(
        default_catalog(scale_factor=float(os.environ.get(
            "CHAOS_SF", str(SCALE_FACTOR)))),
        worker_count=2, session=session,
        device=os.environ.get("CHAOS_DEVICE", _ENV["CHAOS_DEVICE"]))
    srv = TrinoTpuServer(runner).start()
    port_file = os.environ["CHAOS_PORT_FILE"]
    threading.Thread(target=_publish_launches,
                     args=(port_file + ".launches",), daemon=True).start()
    with open(port_file + ".tmp", "w", encoding="utf-8") as f:
        f.write(str(srv.address[1]))
    os.replace(port_file + ".tmp", port_file)
    while True:
        time.sleep(1.0)


def _http_json(method: str, url: str, body: Optional[bytes] = None,
               timeout: float = 10.0) -> dict:
    from urllib.request import Request, urlopen

    req = Request(url, data=body, method=method)
    with urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _read_launches(path: str) -> dict:
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def run_coordinator_kill_drill(stall_s: float = 300.0,
                               boot_timeout_s: float = 180.0,
                               finish_timeout_s: float = 180.0,
                               workdir: Optional[str] = None,
                               device="cuda",
                               scale_factor: float = SCALE_FACTOR,
                               sql: str = _DRILL_SQL) -> dict:
    """kill -9 a coordinator mid-FTE-query, restart it, and certify
    durable recovery end to end.

    Epoch 1 boots a subprocess coordinator on ``device`` with a one-shot
    un-rescuable stall, submits ``sql`` (the reference's ``_DRILL_SQL``
    by default) over POST /v1/statement,
    waits (by reading the query-state WAL) until at least one task
    attempt has committed, then SIGKILLs the process.  Epoch 2 boots a
    fresh coordinator against the same state/spool dirs; its dispatcher
    must rehydrate the query under the ORIGINAL id, resume from the
    committed-attempt map, and finish.  Asserts, from the WAL's attempt
    counters: committed attempts were NEVER re-executed.  Returns the
    full record, with each epoch's boot seconds and kernel launches and
    the walls of the kill and of the resume."""
    import shutil
    import signal
    import subprocess
    import sys
    import tempfile

    from ..execution import query_state

    work = workdir or tempfile.mkdtemp(prefix="trino-tpu-kill-drill-")
    os.makedirs(work, exist_ok=True)
    state_dir = os.path.join(work, "query-state")
    spool_dir = os.path.join(work, "spool")
    port_file = os.path.join(work, "port")
    launch_file = port_file + ".launches"
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env.update(_env(device))
    env.update({
        "CHAOS_SF": str(scale_factor),
        "TRINO_TPU_QUERY_STATE": "1",
        "TRINO_TPU_QUERY_STATE_DIR": state_dir,
        "TRINO_TPU_SPOOL_DIR": spool_dir,
        "TRINO_TPU_RESULT_CACHE": "0",
        "CHAOS_PORT_FILE": port_file,
        "PYTHONPATH": repo_root + os.pathsep + env.get("PYTHONPATH", ""),
    })
    child_cmd = [sys.executable, "-c",
                 "from trino_tpu_torch.testing.chaos import "
                 "_coordinator_child; _coordinator_child()"]

    def _boot(extra_env: dict) -> tuple:
        for p in (port_file, launch_file):
            try:
                os.remove(p)
            except OSError:
                pass
        t0 = time.monotonic()
        proc = subprocess.Popen(child_cmd, env={**env, **extra_env},
                                cwd=repo_root)
        deadline = t0 + boot_timeout_s
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"coordinator child died at boot (rc={proc.returncode})")
            if os.path.exists(port_file):
                with open(port_file, encoding="utf-8") as f:
                    return proc, int(f.read().strip()), \
                        time.monotonic() - t0
            time.sleep(0.1)
        proc.kill()
        proc.wait(timeout=30)
        raise TimeoutError("coordinator child never wrote its port")

    record: dict = {"sql": sql, "workdir": work,
                    "device": str(device), "scale_factor": scale_factor}
    proc1 = proc2 = None
    try:
        proc1, port1, record["boot1_s"] = _boot(
            {"CHAOS_STALL_S": str(stall_s)})
        # epoch 1: submit, wait for >=1 committed attempt, kill -9
        t0 = time.monotonic()
        sub = _http_json("POST", f"http://127.0.0.1:{port1}/v1/statement",
                         sql.encode("utf-8"))
        qid = sub["id"]
        record["query_id"] = qid
        wal_path = None
        pq = None
        deadline = time.monotonic() + boot_timeout_s
        while time.monotonic() < deadline:
            walls = [os.path.join(state_dir, n)
                     for n in os.listdir(state_dir)] \
                if os.path.isdir(state_dir) else []
            walls = [w for w in walls if w.endswith(".wal")]
            if walls:
                wal_path = walls[0]
                pq = query_state.load(wal_path)
                if pq is not None and len(pq.committed) >= 1:
                    break
            time.sleep(0.1)
        if pq is None or not pq.committed:
            raise TimeoutError("no committed attempt before the kill")
        committed_at_kill = dict(pq.committed)
        starts_at_kill = dict(pq.attempt_counts)
        record["committed_at_kill"] = len(committed_at_kill)
        record["first_commit_s"] = round(time.monotonic() - t0, 3)
        record["launches_epoch1"] = _read_launches(launch_file)
        os.kill(proc1.pid, signal.SIGKILL)
        proc1.wait(timeout=30)

        # epoch 2: fresh coordinator, same dirs — recovery must finish the
        # query under its original id
        proc2, port2, record["boot2_s"] = _boot({})
        t0 = time.monotonic()
        rows: list = []
        state = None
        token = 0
        deadline = time.monotonic() + finish_timeout_s
        while time.monotonic() < deadline:
            out = _http_json(
                "GET", f"http://127.0.0.1:{port2}/v1/statement/{qid}/{token}")
            state = out.get("stats", {}).get("state")
            if state == "FAILED":
                record["error"] = out.get("error")
                break
            rows += out.get("data", [])
            nxt = out.get("nextUri")
            if state == "FINISHED":
                if not nxt:
                    break
                token += 1
                continue
            time.sleep(0.2)
        record["resume_s"] = round(time.monotonic() - t0, 3)
        record["state"] = state
        record["rows"] = rows

        final = query_state.load(wal_path)
        re_executed = {
            f"f{fid}_t{t}": final.attempt_counts.get((fid, t), 0)
            - starts_at_kill.get((fid, t), 0)
            for (fid, t) in committed_at_kill
            if final.attempt_counts.get((fid, t), 0)
            > starts_at_kill.get((fid, t), 0)
        }
        record["committed_reexecuted"] = re_executed
        record["resumed_attempt_starts"] = {
            f"f{fid}_t{t}": n - starts_at_kill.get((fid, t), 0)
            for (fid, t), n in final.attempt_counts.items()
            if n > starts_at_kill.get((fid, t), 0)
        }
        record["wal_ended"] = final.ended

        # spool GC: the resumed query's root must be reclaimed at its end
        spool_root = pq.spool_root
        deadline = time.monotonic() + 30.0
        while os.path.isdir(spool_root) and time.monotonic() < deadline:
            time.sleep(0.2)
        record["spool_reclaimed"] = not os.path.isdir(spool_root)
        time.sleep(0.5)  # one more publication of epoch 2's launches
        record["launches_epoch2"] = _read_launches(launch_file)
        record["pass"] = (state == "FINISHED" and not re_executed
                          and record["spool_reclaimed"]
                          and final.ended == "FINISHED")
        return record
    finally:
        for p in (proc1, proc2):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=15)
        if workdir is None:
            shutil.rmtree(work, ignore_errors=True)


def run_chaos(n_scenarios: int = 25, base_seed: int = 1009,
              inproc_queries: int = 8, process_queries: int = 4,
              process_stride: int = 4, verbose: bool = True,
              device="cuda", scale_factor: float = SCALE_FACTOR) -> dict:
    """The full soak.  Every ``process_stride``-th scenario runs against
    real worker processes; the rest are in-process.  Returns a summary
    with per-scenario records and the acceptance booleans."""
    expected = build_expected(scale_factor)
    scenarios = []
    for i in range(n_scenarios):
        mode = ("process" if process_stride and i % process_stride
                == process_stride - 1 else "inproc")
        n_q = process_queries if mode == "process" else inproc_queries
        t0 = time.monotonic()
        rec = run_scenario(base_seed + i, mode=mode, n_queries=n_q,
                           expected=expected, device=device,
                           scale_factor=scale_factor)
        rec["scenario"] = i
        rec["wall_s"] = round(time.monotonic() - t0, 2)
        scenarios.append(rec)
        if verbose:
            print(f"  chaos scenario {i:2d} seed={base_seed + i} "
                  f"mode={mode:7s} {rec['counts']} "
                  f"({rec['wall_s']:.1f}s)", flush=True)

    out = _summary(scenarios, n_scenarios, base_seed)
    retry_walls = [o["wall_s"] for rec in scenarios
                   for o in rec["outcomes"] if o["retried"]]
    out["max_recovery_s"] = round(max(retry_walls), 3) if retry_walls \
        else 0.0
    return out

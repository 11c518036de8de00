"""The port's whole-query compilation (execution/plan_compiler.py) against
the reference's.

The cases of the reference's tests/test_resident_plan.py, each held to
the port's own fused path (``TRINO_TPU_RESIDENT_PLAN=0``), to the
reference and to sqlite (the port's oracle, trino_tpu_torch/testing); then
the build and probe through the hash kernels, the memo key's JSON round
trip, the profiler's events and an error injected into the build prep,
which must fail the query with no re-run.  The warm-key journal: the
resident program's key warms (:265 of the reference's file), the port
writes the reference's file format, and a worker process replays the
file at boot, counting the keys it skips.  ``init_distributed`` brings up
gloo (:288) and two processes gather a build across a gloo group on the
CPU (:348).  Integer, decimal,
string and count outputs are identical; float64 sums within rel 1e-12
(the state merge adds in another order).  The reference is pinned as
tests/test_torch_fused_stage.py pins it.
"""

import json
import math

import pytest
import torch

from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.execution.distributed_runner import (
    DistributedQueryRunner as RefDist)
from trino_tpu.execution.plan_compiler import (
    ResidentPlanExec as RefResidentPlanExec)
from trino_tpu.runner import Session as RefSession
from trino_tpu_torch.caching import executable_cache as ec
from trino_tpu_torch.caching import result_cache
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.tpch_queries import QUERIES
from trino_tpu_torch.execution import plan_compiler as PC
from trino_tpu_torch.execution.distributed_runner import (
    DistributedQueryRunner)
from trino_tpu_torch.ops import gpu_kernels as GK
from trino_tpu_torch.runner import Session
from trino_tpu_torch.telemetry import metrics as tm
from trino_tpu_torch.telemetry import profiler
from trino_tpu_torch.testing.oracle import (SqliteOracle, assert_same_rows,
                                            load_tables)

SF = 0.01
TABLES = ["customer", "orders", "lineitem"]
PINS = (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
        ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
        ("TRINO_TPU_OPTIMIZER", "iterative"))

BUILD_ORIGIN_SQL = ("select c_mktsegment, count(*), sum(o_totalprice) "
                    "from customer, orders where c_custkey = o_custkey "
                    "group by c_mktsegment")
# customers place many orders: the build keyed on o_custkey has
# duplicate live keys
DUP_SQL = ("select c_mktsegment, count(*) "
           "from customer, orders where c_nationkey = o_custkey "
           "group by c_mktsegment")


@pytest.fixture(autouse=True)
def _pin(monkeypatch):
    for k, v in PINS:
        monkeypatch.setenv(k, v)
    for k in ("TRINO_TPU_FUSED_STAGE", "TRINO_TPU_FUSED_CAP",
              "TRINO_TPU_RESIDENT_PLAN", "TRINO_TPU_MESH_SHAPE",
              "TRINO_TPU_RESIDENT_MAX_FRAGMENTS"):
        monkeypatch.delenv(k, raising=False)
    with result_cache.disabled():
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch's intra-op threads only contend at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def harness():
    port = DistributedQueryRunner(default_catalog(SF), worker_count=4,
                                  session=Session(node_count=4),
                                  device="cpu")
    ref = RefDist(ref_catalog(scale_factor=SF), worker_count=4,
                  session=RefSession(node_count=4))
    yield port, ref
    # the reference's compiled resident programs are heavy (see its
    # tests/test_resident_plan.py): drop them with the module
    from test_torch_fused_stage import _drop_reference_programs

    _drop_reference_programs()


@pytest.fixture(scope="module")
def oracle():
    return load_tables(SqliteOracle(),
                       default_catalog(SF).connector("tpch"), TABLES)


def _rows(result):
    return sorted(map(tuple, result.rows()), key=repr)


def _equiv(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                assert math.isclose(float(a), float(b), rel_tol=1e-12,
                                    abs_tol=1e-12), (g, w)
            else:
                assert type(a) is type(b) and a == b, (g, w)


def _resident_execs(runner, cls=PC.ResidentPlanExec):
    return [e for e in runner._resident_edges.values()
            if isinstance(e, cls)]


# ---------------------------------------------------------------------------
# the fragmenter's coalescing and its edge contracts


def test_fragmenter_coalesces_resident_plan(harness):
    port, _ = harness
    sp = port.create_subplan(QUERIES[3])
    marked = [f for f in sp.all_fragments() if f.resident_plan is not None]
    assert len(marked) == 1, "Q3 coalesces into ONE resident plan"
    f = marked[0]
    rp = f.resident_plan
    assert rp.core_fid == f.id and f.device_resident
    assert len(rp.fragment_ids) == 4 and len(rp.joins) == 2
    assert all(j.join_type == "INNER" for j in rp.joins)
    bcast = [e for e in rp.edges if e.kind == "BROADCAST"]
    seam = [e for e in rp.edges if e.kind == "REPARTITION"]
    assert len(bcast) == 2 and len(seam) == 1
    for e in bcast:
        assert e.in_spec == ("x",) and e.out_spec == ()
    assert seam[0].in_spec == seam[0].out_spec == ("x",)
    assert seam[0].consumer_fid == rp.consumer_fid
    assert "resident-plan[4f/3e]" in sp.text()


# ---------------------------------------------------------------------------
# execution: one call per batch, codes across seams, rows


def test_q3_resident_vs_legacy(harness, oracle, monkeypatch):
    """The whole Q3 join tree and aggregation run as ONE program call per
    feed batch; c_mktsegment's codes cross the customer build seam as
    codes; the rows are the fused path's, the reference's and sqlite's."""
    port, ref = harness
    resident = port.execute(QUERIES[3])
    (ex,) = _resident_execs(port)
    rs = ex.rstats
    assert rs.plans == 1 and rs.seams == 3 and rs.batches > 0
    assert rs.jit_calls == rs.batches and rs.launches_per_batch == 1.0
    assert rs.code_seam_columns >= 1
    assert rs.merges == 1 and rs.fallbacks == 0
    want = ref.execute(QUERIES[3])
    assert _resident_execs(ref, RefResidentPlanExec)
    assert sorted(port._resident_edges) == sorted(ref._resident_edges)
    _equiv(resident.rows(), want.rows())

    monkeypatch.setenv("TRINO_TPU_RESIDENT_PLAN", "0")
    legacy = port.execute(QUERIES[3])
    assert not port._resident_edges, "=0 disables resident compilation"
    assert port._fused_edges, "=0 restores the fused seam"
    _equiv(_rows(resident), _rows(legacy))
    assert_same_rows(resident.rows(), oracle.query(QUERIES[3]),
                     ordered=True)


def test_build_origin_dict_group_key(harness, oracle, monkeypatch):
    """A group key from the BUILD side of an inlined join: its dictionary
    is the merged build dictionary, pinned for the whole query."""
    port, ref = harness
    result = port.execute(BUILD_ORIGIN_SQL)
    (ex,) = _resident_execs(port)
    rs = ex.rstats
    assert rs.jit_calls == rs.batches and rs.code_seam_columns >= 1
    assert_same_rows(result.rows(), oracle.query(BUILD_ORIGIN_SQL))
    _equiv(_rows(result), _rows(ref.execute(BUILD_ORIGIN_SQL)))
    monkeypatch.setenv("TRINO_TPU_RESIDENT_PLAN", "0")
    _equiv(_rows(result), _rows(port.execute(BUILD_ORIGIN_SQL)))


def test_steady_state_hits_program_cache(harness):
    """A second identical run: every call is of a signature seen before."""
    port, _ = harness
    port.execute(QUERIES[3])
    port.execute(QUERIES[3])
    (ex,) = _resident_execs(port)
    rs = ex.rstats
    assert rs.batches > 0
    assert rs.programs == 0, "steady-state traffic never recompiles"
    assert rs.cache_hits == rs.jit_calls


def test_build_and_probe_run_through_the_hash_kernels(harness, monkeypatch):
    """Each build indexes its live keys with ``hash_insert``; each probe
    batch looks its keys up with ``hash_probe`` once per join (their plain
    versions on the CPU)."""
    port, _ = harness
    probes = []
    orig = GK.hash_probe_plain
    monkeypatch.setattr(GK, "hash_probe_plain",
                        lambda *a: probes.append(a[2].shape) or orig(*a))
    port.execute(QUERIES[3])
    (ex,) = _resident_execs(port)
    assert len(probes) == 2 * ex.rstats.batches  # two joins
    assert all(p[0] == 2 for p in probes)  # int64 keys: two planes


# ---------------------------------------------------------------------------
# fallbacks: overflow and duplicate build keys re-run the query


def test_overflow_falls_back(harness, oracle, monkeypatch):
    """More groups than TRINO_TPU_FUSED_CAP: a resident fallback, counted,
    and the per-operator path's rows."""
    port, _ = harness
    monkeypatch.setenv("TRINO_TPU_FUSED_CAP", "8")
    before = port.resident_fallbacks
    metric = tm.RESIDENT_FALLBACKS.value()
    stats: list = []
    result = port._execute_subplan(port.create_subplan(QUERIES[3]), stats)
    assert port.resident_fallbacks == before + 1
    assert tm.RESIDENT_FALLBACKS.value() == metric + 1
    (line,) = [s for s in stats if s.label == "resident plans:"]
    assert line.resident.fallbacks == 1
    assert "TRINO_TPU_FUSED_CAP" in line.resident.fallback_reasons[0]
    assert_same_rows(result.rows(), oracle.query(QUERIES[3]), ordered=True)


def test_duplicate_build_keys_fall_back(harness, oracle):
    """The resident probe is 1-match: a build with duplicate live keys
    trips the duplicate flag at prep and the query re-runs on the
    multi-match join."""
    port, ref = harness
    assert any(f.resident_plan is not None
               for f in port.create_subplan(DUP_SQL).all_fragments()), \
        "the duplicate-key query still coalesces (duplicates are data)"
    before, ref_before = port.resident_fallbacks, ref.resident_fallbacks
    result = port.execute(DUP_SQL)
    assert port.resident_fallbacks == before + 1
    assert_same_rows(result.rows(), oracle.query(DUP_SQL))
    _equiv(_rows(result), _rows(ref.execute(DUP_SQL)))
    assert ref.resident_fallbacks == ref_before + 1


def test_build_error_fails_query_without_fallback(harness, monkeypatch):
    """Only an overflow re-runs the query: an error in the build prep fails
    it, and no fallback is counted."""
    port, _ = harness

    def boom(self, build_fid):
        raise RuntimeError("injected build failure")

    monkeypatch.setattr(PC.ResidentPlanExec, "_prep_build", boom)
    before = (port.fused_fallbacks, port.resident_fallbacks)
    with pytest.raises(Exception, match="injected build failure"):
        port.execute(QUERIES[3])
    assert (port.fused_fallbacks, port.resident_fallbacks) == before


# ---------------------------------------------------------------------------
# gating knobs


def test_mesh_shape_cap_disables(harness, oracle, monkeypatch):
    """TRINO_TPU_MESH_SHAPE narrower than the task count: the plan cannot
    claim its mesh and the fused seam takes the edge back."""
    port, _ = harness
    monkeypatch.setenv("TRINO_TPU_MESH_SHAPE", "2")
    result = port.execute(QUERIES[3])
    assert not port._resident_edges and port._fused_edges
    assert_same_rows(result.rows(), oracle.query(QUERIES[3]), ordered=True)


def test_max_fragments_gate(harness, monkeypatch):
    """A 4-fragment plan under TRINO_TPU_RESIDENT_MAX_FRAGMENTS=2 stays on
    the fused path."""
    port, _ = harness
    monkeypatch.setenv("TRINO_TPU_RESIDENT_MAX_FRAGMENTS", "2")
    port.execute(QUERIES[3])
    assert not port._resident_edges and port._fused_edges


# ---------------------------------------------------------------------------
# the memo key, the profiler's events


def test_resident_program_memo_key_is_a_json_value(harness):
    """The resident program's memo key is a value (base64 of the plan
    payload, the cap and the device), unlike the identity-keyed fused
    memo: it survives a JSON round trip and rebuilds the program, which
    then is the cached one."""
    port, _ = harness
    port.execute(QUERIES[3])
    (ex,) = _resident_execs(port)
    key = (ex.spec_b64, ex.spec.cap, str(port.device))
    back = tuple(json.loads(json.dumps(list(key))))
    assert back == key
    cache = ec._REGISTRY["resident._program"]
    assert cache.cache.peek(back) is not None
    prog = PC._resident_program(*back)
    assert prog is cache.cache.peek(back)
    assert [j.build_fid for j in prog.spec.joins] == \
        [j.build_fid for j in ex.spec.joins]


def test_profiler_records_build_and_merge_events(harness):
    port, _ = harness
    level = profiler.set_level(1)
    try:
        qid = "resident_events"
        port.execute(QUERIES[3], query_id=qid)
        names = [e["name"] for e in profiler.events_for(qid)]
    finally:
        profiler.set_level(level)
    assert sum(n.startswith("resident-build[") for n in names) == 2
    assert sum(n.startswith("fused-merge[") for n in names) == 1
    assert any(n.startswith("resident-accumulate[") for n in names)


# ---------------------------------------------------------------------------
# the warm-key journal


@pytest.fixture
def warm_dir(tmp_path, monkeypatch):
    """A fresh journal directory (where exec_warm.json goes) and a fresh
    set of seen keys."""
    monkeypatch.setenv("TRINO_TPU_JOURNAL_DIR", str(tmp_path))
    ec.reset_warm_state_for_test()
    yield tmp_path
    ec.reset_warm_state_for_test()


def _resident_key(port) -> tuple:
    (ex,) = _resident_execs(port)
    return (ex.spec_b64, ex.spec.cap, str(port.device))


def test_resident_program_memo_key_warms(harness, warm_dir):
    """The resident accumulate memo keys on a value (the base64 plan
    payload), so a miss journals the key, the key survives the JSON round
    trip and ``warm`` re-instantiates the program (the reference's
    test_resident_program_memo_key_warms)."""
    port, _ = harness
    cache = ec._REGISTRY["resident._program"]
    cache.clear()
    port.execute(QUERIES[3])
    with ec._WARM_LOCK:
        keys = [list(key) for (name, key) in ec._WARM_SEEN
                if name == "resident._program"]
    assert keys == [list(_resident_key(port))]
    round_tripped = tuple(json.loads(json.dumps(keys[0])))
    cache.clear()
    assert cache.warm(round_tripped), \
        "boot replay must rebuild the resident program from the journal"
    assert cache.cache.peek(round_tripped) is not None


def test_query_end_flushes_the_reference_format(harness, warm_dir):
    """The query's completion writes exec_warm.json next to the journal,
    in the reference's format; identical keys recorded through both
    packages give identical files."""
    from trino_tpu.caching import executable_cache as ref_ec

    port, _ = harness
    ec._REGISTRY["resident._program"].clear()
    port.execute(QUERIES[3])
    path = warm_dir / "exec_warm.json"
    assert ec.warm_file_path() == str(path)
    doc = json.loads(path.read_text())
    assert doc["version"] == 1
    assert ["resident._program", list(_resident_key(port))] in doc["keys"]
    assert all(isinstance(n, str) and isinstance(k, list)
               for n, k in doc["keys"])
    # nothing new: the next query writes nothing
    path.unlink()
    assert ec.flush_warm_keys() is None and not path.exists()

    pairs = [("stage._ingest_program", (8192, (True, False), True)),
             ("x.y", ("s", 1, 2.5, None))]
    docs = []
    for mod, sub in ((ec, "port"), (ref_ec, "ref")):
        (warm_dir / sub).mkdir()
        mod.reset_warm_state_for_test()
        for name, key in pairs:
            mod._record_warm_key(name, key)
        os_env = {"TRINO_TPU_JOURNAL_DIR": str(warm_dir / sub)}
        with pytest.MonkeyPatch.context() as mp:
            for k, v in os_env.items():
                mp.setenv(k, v)
            docs.append(json.loads(open(mod.flush_warm_keys()).read()))
        mod.reset_warm_state_for_test()
    assert docs[0] == docs[1]


def _foreign_payload() -> str:
    """A plan payload of the reference's package, as a journal the
    reference wrote holds."""
    import base64
    import pickle
    import zlib

    from trino_tpu.spi.types import BIGINT as REF_BIGINT

    raw = pickle.dumps(((REF_BIGINT,), None, (), ()), protocol=4)
    return base64.b64encode(zlib.compress(raw)).decode("ascii")


def test_warm_at_boot_counts_what_it_skips(harness, warm_dir, monkeypatch):
    port, _ = harness
    port.execute(QUERIES[3])
    key = list(_resident_key(port))
    pairs = [["resident._program", key],
             ["stage._ingest_program", [64, [True], False]],
             ["kernels._group_ids_fn", [3, "int64"]],  # a reference memo
             ["resident._program", [_foreign_payload(), 8192, "cpu"]],
             ["stage._ingest_program", [1, 2, 3, 4]],  # arguments drifted
             ["broken"]]
    (warm_dir / "exec_warm.json").write_text(
        json.dumps({"version": 1, "keys": pairs}))
    cache = ec._REGISTRY["resident._program"]
    cache.clear()
    out = ec.warm_at_boot()
    assert (out["read"], out["warmed"], out["skipped"]) == (6, 2, 4)
    assert out["ms"] > 0
    assert cache.cache.peek(tuple(key)) is not None
    monkeypatch.setenv("TRINO_TPU_EXEC_WARM", "0")
    assert ec.warm_at_boot() == {"read": 0, "warmed": 0, "skipped": 0,
                                 "ms": 0.0}


def test_weak_memo_keys_are_never_journaled(warm_dir):
    """A weak memo is keyed by an object's identity: meaningless in
    another process, so never journaled, and never warmed."""
    import numpy as np

    from trino_tpu_torch.spi.batch import _object_payload_nbytes

    dictionary = np.array(["a", "bb"], dtype=object)
    assert _object_payload_nbytes(dictionary) == 3
    with ec._WARM_LOCK:
        names = {name for (name, _key) in ec._WARM_SEEN}
    assert "batch.dictionary_nbytes" not in names
    assert not _object_payload_nbytes.warm((id(dictionary),))


def test_worker_replays_the_journal_at_boot(harness, warm_dir):
    """A worker process boots, replays exec_warm.json and reports the
    replay in ``GET /v1/info``; with TRINO_TPU_EXEC_WARM=0 it reads
    nothing."""
    from trino_tpu_torch.execution.remote import WorkerProcess

    port, _ = harness
    pairs = [["resident._program", list(_resident_key(port))],
             ["stage._ingest_program", [64, [True], False]],
             ["kernels._group_ids_fn", [3, "int64"]]]
    (warm_dir / "exec_warm.json").write_text(
        json.dumps({"version": 1, "keys": pairs}))
    for env, want in (({}, (3, 2, 1)), ({"TRINO_TPU_EXEC_WARM": "0"},
                                        (0, 0, 0))):
        w = WorkerProcess(dict(env, OMP_NUM_THREADS="1"), device="cpu")
        try:
            warm = w.info()["warm"]
        finally:
            w.kill()
        assert (warm["read"], warm["warmed"], warm["skipped"]) == want


# ---------------------------------------------------------------------------
# multi-process: a build gathered across two host processes


def test_init_distributed_gloo(monkeypatch):
    """init_distributed brings up a gloo group (the reference's
    gloo-before-initialize case): NCCL takes no two ranks on one card."""
    import torch.distributed as dist

    seen = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw)))
    PC.init_distributed("127.0.0.1:9999", num_processes=2, process_id=1)
    assert seen == [
        ("gloo", {"init_method": "tcp://127.0.0.1:9999", "world_size": 2,
                  "rank": 1})]


_CHILD = """
import sys

import torch
import torch.distributed as dist

from trino_tpu_torch.execution import plan_compiler as PC

port, pid = sys.argv[1], int(sys.argv[2])
PC.init_distributed(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
assert dist.get_world_size() == 2 and dist.get_rank() == pid
# four local shards of three rows each: eight shards in all, as the
# reference's 2 x 4 device mesh; the gather replicates the whole build
per = 3
local = torch.cat([torch.arange(per, dtype=torch.int64) + (pid * 4 + i) * per
                   for i in range(4)])
parts = [torch.empty_like(local) for _ in range(2)]
dist.all_gather(parts, local)
rep = torch.cat(parts)
assert torch.equal(rep, torch.arange(8 * per)), rep
dist.destroy_process_group()
print(f"RESIDENT-MP-OK {pid}")
"""


def test_two_process_gloo_build_gather(tmp_path):
    """torch.distributed over gloo between two host processes: a
    broadcast gather gives the full build in both, in rank order (the
    reference's two-process CPU mesh case)."""
    import os
    import socket
    import subprocess
    import sys

    script = tmp_path / "resident_mp_child.py"
    script.write_text(_CHILD)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        free = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(free), str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert f"RESIDENT-MP-OK {pid}" in out

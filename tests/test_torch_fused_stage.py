"""The port's whole-stage compilation (execution/stage_compiler.py) against
the reference's.

The cases of the reference's tests/test_fused_stage.py, each held to the
port's own per-operator path (``TRINO_TPU_FUSED_STAGE=0``), to the
reference with its compiled stages on and to sqlite; then the accumulate
step and the seam merge state for state against the reference's on seeded
numpy batches, the rows of the 16 queries that carry a fused seam or a
resident plan at four tasks (both packages at their defaults, ``auto``),
the knobs, the statistics and metrics, and an error injected into the
seam merge, which must fail the query with no re-run.

Equivalence contract (the reference's): integer, decimal, string and
count outputs are identical; float64 sums and averages may differ in the
last bits, because the state merge adds in another order (rel 1e-12); the
REAL sums of R1 / R2 within 1e-4 (tests/test_torch_queries_q13_q22.py's
tolerance).  The reference is pinned as ROADMAP "Pinning the reference"
says, with the compiled stages at their default.
"""

import math

import numpy as np
import pytest
import torch

from test_torch_queries_q13_q22 import R1, R2
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.execution import stage_compiler as RSC
from trino_tpu.execution.distributed_runner import (
    DistributedQueryRunner as RefDist)
from trino_tpu.runner import Session as RefSession
from trino_tpu.spi import knobs as RK
from trino_tpu_torch.caching import result_cache
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.tpch_queries import QUERIES
from trino_tpu_torch.exec import syncguard as SG
from trino_tpu_torch.execution import stage_compiler as SC
from trino_tpu_torch.execution.distributed_runner import (
    DistributedQueryRunner)
from trino_tpu_torch.ops import gpu_kernels as GK
from trino_tpu_torch.parallel.distributed import Mesh
from trino_tpu_torch.runner import Session
from trino_tpu_torch.spi import knobs as PK
from trino_tpu_torch.spi.errors import TrinoError
from trino_tpu_torch.telemetry import metrics as tm
from trino_tpu_torch.testing.oracle import (SqliteOracle, assert_same_rows,
                                            load_tables)

SF = 0.01
TABLES = ["customer", "orders", "lineitem"]
PINS = (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
        ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
        ("TRINO_TPU_OPTIMIZER", "iterative"))

AGG_SQL = """
select l_returnflag, l_linestatus,
       sum(l_quantity), sum(l_extendedprice), min(l_quantity),
       max(l_extendedprice), avg(l_discount), avg(l_quantity),
       count(l_shipdate), count(*)
from lineitem
group by l_returnflag, l_linestatus
"""

# the queries whose plan at four tasks carries a fused seam (Q13, Q15 and
# Q18 two) or a resident plan (Q2, Q3, Q10, Q11)
SEAM_QUERIES = {f"Q{q}": QUERIES[q] for q in (1, 2, 3, 4, 5, 9, 10, 11, 13,
                                                15, 17, 18, 20, 21)}
SEAM_QUERIES.update(R1=R1, R2=R2)
_ORDERED = {"Q1", "Q2", "Q3", "Q5", "Q9", "Q10", "Q11", "Q13", "Q18",
            "Q21", "R1", "R2"}


@pytest.fixture(autouse=True)
def _pin(monkeypatch):
    for k, v in PINS:
        monkeypatch.setenv(k, v)
    for k in ("TRINO_TPU_FUSED_STAGE", "TRINO_TPU_FUSED_CAP",
              "TRINO_TPU_MESH_SHAPE", "TRINO_TPU_RESIDENT_MAX_FRAGMENTS"):
        monkeypatch.delenv(k, raising=False)
    # whole-query compilation would absorb the Q3 seam this file runs on
    # its own (tests/test_torch_resident_plan.py covers it)
    monkeypatch.setenv("TRINO_TPU_RESIDENT_PLAN", "0")
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
    _drop_reference_programs()


def _drop_reference_programs() -> None:
    """The reference's compiled stage programs are jitted executables; the
    tier-1 suite runs near the process's mmap ceiling, so a module that
    compiled many drops them (as tests/test_resident_plan.py does)."""
    import jax
    from trino_tpu.caching import executable_cache as ref_ec
    import trino_tpu.execution.plan_compiler as ref_pc

    for name in ("stage._ingest_program", "stage._merge_program",
                 "resident._program", "resident._build_prep"):
        cache = ref_ec._REGISTRY.get(name)
        if cache is not None:
            cache.clear()
    with RSC._ACCUM_LOCK:
        RSC._ACCUM_CACHE.clear()
        RSC._TRACE_SIGS.clear()
    with ref_pc._RES_LOCK:
        ref_pc._RES_TRACE_SIGS.clear()
    jax.clear_caches()


@pytest.fixture(scope="module")
def oracle():
    return load_tables(SqliteOracle(),
                       default_catalog(SF).connector("tpch"), TABLES)


def _rows(result):
    return sorted(map(tuple, result.rows()), key=repr)


def _equiv(got, want, rtol: float = 1e-12, ordered: bool = True) -> None:
    """Identical but for floats (reassociated sums, see the module
    docstring)."""
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                assert math.isclose(float(a), float(b), rel_tol=rtol,
                                    abs_tol=1e-12), (g, w)
            else:
                assert type(a) is type(b) and a == b, (g, w)


def _run_both(port, monkeypatch, sql):
    monkeypatch.setenv("TRINO_TPU_FUSED_STAGE", "auto")
    fused = port.execute(sql)
    edges = dict(port._fused_edges)
    monkeypatch.setenv("TRINO_TPU_FUSED_STAGE", "0")
    legacy = port.execute(sql)
    assert not port._fused_edges, "=0 must disable whole-stage compilation"
    monkeypatch.setenv("TRINO_TPU_FUSED_STAGE", "auto")
    return fused, legacy, edges


# ---------------------------------------------------------------------------
# the reference's cases


def test_fragmenter_marks_fused_seam(harness):
    port, _ = harness
    sp = port.create_subplan(AGG_SQL)
    seams = [f for f in sp.all_fragments() if f.fused_seam is not None]
    assert len(seams) == 1
    f = seams[0]
    assert f.device_resident and f.output_kind == "REPARTITION"
    assert f.fused_seam.nk == 2
    assert f.fused_seam.in_spec == f.fused_seam.out_spec == ("x",)
    assert "fused-seam->" in sp.text() and "device-resident" in sp.text()


def test_agg_only_stage_fused_vs_legacy(harness, oracle, monkeypatch):
    """sum / min / max / avg / count (a decimal-scale avg, a date count,
    string group keys) through one accumulate call per batch; the ragged
    last batches land in pad buckets."""
    port, ref = harness
    fused, legacy, edges = _run_both(port, monkeypatch, AGG_SQL)
    assert edges, "expected a fused stage seam"
    (ex,) = edges.values()
    assert ex.stats.merges == 1, "a fused stage runs ONE seam merge"
    assert ex.stats.jit_calls == ex.stats.batches > 0
    _equiv(_rows(fused), _rows(legacy))
    _equiv(_rows(fused), _rows(ref.execute(AGG_SQL)))
    assert ref._fused_edges
    assert_same_rows(fused.rows(), oracle.query(AGG_SQL))
    assert_same_rows(legacy.rows(), oracle.query(AGG_SQL))


def test_join_fed_stage_fused_vs_legacy(harness, oracle, monkeypatch):
    """Q3: the fused stage's feed is a join pipeline (the build and probe
    stay operators; the PARTIAL -> shuffle -> FINAL tail fuses)."""
    port, ref = harness
    fused, legacy, edges = _run_both(port, monkeypatch, QUERIES[3])
    assert edges, "expected a fused stage over the join feed"
    _equiv(_rows(fused), _rows(legacy))
    _equiv(fused.rows(), ref.execute(QUERIES[3]).rows())
    assert sorted(edges) == sorted(ref._fused_edges)
    assert_same_rows(fused.rows(), oracle.query(QUERIES[3]), ordered=True)


def test_shape_bucket_cache_bounds_retraces(harness):
    """Compiles are O(#buckets), not O(#batches): a second identical run
    counts every call as a hit of a signature seen before."""
    port, _ = harness
    port.execute(AGG_SQL)
    port.execute(AGG_SQL)
    (ex,) = port._fused_edges.values()
    assert ex.stats.batches > 0
    assert ex.stats.compiles == 0, "steady-state traffic never recompiles"
    assert ex.stats.cache_hits == ex.stats.jit_calls


def test_fused_stage_zero_hot_loop_syncs(harness):
    """SyncGuard: no blocking host read between deposit and take; the one
    data-dependent scalar (the overflow check) is read outside the hot
    region, once per task that saw input."""
    port, _ = harness
    port.execute(AGG_SQL)  # warm-up
    before = SG.snapshot()
    with SG.forbidden():
        port.execute(AGG_SQL)
    assert port._fused_edges
    delta = SG.take_delta(before)
    assert delta.hot_loop_syncs == 0
    # one read per task that saw input
    assert 1 <= delta.by_tag.get("fused.overflow", 0) <= 4


def test_disabled_mode_restores_collective_path(harness, oracle,
                                                monkeypatch):
    """TRINO_TPU_FUSED_STAGE=0: the collective exchange takes the
    REPARTITION edge back."""
    port, _ = harness
    monkeypatch.setenv("TRINO_TPU_FUSED_STAGE", "0")
    result = port.execute(AGG_SQL)
    assert not port._fused_edges
    assert port._collective_edges, "the collective edge must come back"
    assert_same_rows(result.rows(), oracle.query(AGG_SQL))


def test_overflow_falls_back_to_legacy_path(harness, oracle, monkeypatch):
    """More groups than TRINO_TPU_FUSED_CAP: the overflow scalar trips at
    finish and the query re-runs on the per-operator path (no group cap):
    correct rows, the re-run counted."""
    port, ref = harness
    monkeypatch.setenv("TRINO_TPU_FUSED_CAP", "8")
    sql = ("select l_suppkey, count(*), sum(l_quantity) from lineitem "
           "group by l_suppkey")
    before = port.fused_fallbacks
    metric = tm.FUSED_FALLBACKS.value()
    stats: list = []
    result = port._execute_subplan(port.create_subplan(sql), stats)
    assert port.fused_fallbacks == before + 1
    assert tm.FUSED_FALLBACKS.value() == metric + 1
    assert any(s.label == "fused stages:" and s.fused.fallbacks == 1
               for s in stats)
    assert_same_rows(result.rows(), oracle.query(sql))
    ref_before = ref.fused_fallbacks
    _equiv(_rows(result), _rows(ref.execute(sql)))
    assert ref.fused_fallbacks == ref_before + 1


# ---------------------------------------------------------------------------
# the accumulate step and the seam merge, state for state


def _specs(port, ref, sql: str, cap: int):
    """(port spec, reference spec) of the query's one fused seam."""
    out = []
    for runner, mod in ((port, SC), (ref, RSC)):
        frags = {f.id: f for f in runner.create_subplan(sql).all_fragments()}
        (f,) = [f for f in frags.values() if f.fused_seam is not None]
        out.append(mod.build_fused_spec(f, frags[f.fused_seam.consumer_fid],
                                        4, cap))
    return out


STATE_SQL = {
    "agg": AGG_SQL,
    "real_min_max": "select l_linenumber, sum(cast(l_quantity as real)), "
                    "min(l_shipdate), max(l_discount), count(l_tax) "
                    "from lineitem where l_quantity > 10 "
                    "group by l_linenumber",
}


def _batch(rng, types, n: int, dictionary):
    """Seeded columns of the feed's types (dictionary columns draw codes
    into ``dictionary``), some NULL, and a live mask."""
    cols = []
    for t in types:
        if t.is_dictionary_encoded:
            d = rng.randint(0, len(dictionary), n).astype(np.int32)
        elif np.dtype(t.storage_dtype).kind == "f":
            d = rng.uniform(0, 100, n).astype(t.storage_dtype)
        else:
            d = rng.randint(0, 5000, n).astype(t.storage_dtype)
        v = rng.uniform(size=n) > 0.1
        cols.append((d, v))
    return cols, rng.uniform(size=n) > 0.2


def _slots(keys, kvalids, used, values, valids) -> dict:
    """{key tuple: state tuple} over the used slots (slot order is the
    hash route's first occurrence, the reference's sort route's key
    order)."""
    out = {}
    used = np.asarray(used)
    for i in np.flatnonzero(used):
        k = tuple((bool(np.asarray(v)[i]), np.asarray(d)[i].item())
                  for d, v in zip(keys, kvalids))
        out[k] = tuple(
            (None if vv is not None and not bool(np.asarray(vv)[i])
             else np.asarray(d)[i].item())
            for d, vv in zip(values, valids))
    return out


def _same_states(got: dict, want: dict, rtol: float) -> None:
    assert got.keys() == want.keys() and got
    for k in got:
        for a, b in zip(got[k], want[k]):
            if isinstance(b, float):
                assert math.isclose(a, b, rel_tol=rtol, abs_tol=1e-9), \
                    (k, got[k], want[k])
            else:
                assert a == b, (k, got[k], want[k])


@pytest.mark.parametrize("name", sorted(STATE_SQL))
def test_accumulate_state_matches_reference(harness, name):
    """Seeded batches through both packages' accumulate programs: after
    every batch the carried states hold the same groups with the same
    states (REAL sums within 1e-5: the port adds a batch in float64, the
    reference in float32)."""
    import jax.numpy as jnp

    port, ref = harness
    spec, rspec = _specs(port, ref, STATE_SQL[name], 256)
    types = list(spec.feed.output_types)
    dictionary = np.array(["A", "F", "N", "O", "R"], dtype=object)
    dicts = [dictionary if t.is_dictionary_encoded else None for t in types]
    prog = SC._accumulate_program(spec, types, dicts, torch.device("cpu"))
    rtypes = list(rspec.feed.output_types)
    rprog = RSC._accumulate_program(rspec, rtypes, dicts)
    state, rstate = prog.initial_state(), rprog.initial_state()
    rng = np.random.RandomState(7)
    nk = spec.nk
    for n in (64, 64, 32):
        cols, live = _batch(rng, types, n, dictionary)
        state = prog(state, tuple((torch.from_numpy(d), torch.from_numpy(v))
                                  for d, v in cols),
                     torch.from_numpy(live), (None,) * nk, (None,) * nk)
        rstate = rprog(rstate, tuple((jnp.asarray(d), jnp.asarray(v))
                                     for d, v in cols),
                       jnp.asarray(live), (None,) * nk, (None,) * nk)
        _same_states(
            _slots(state["kd"], state["kv"], state["used"], state["sd"],
                   state["sv"]),
            _slots(rstate["kd"], rstate["kv"], rstate["used"], rstate["sd"],
                   rstate["sv"]), 1e-5)
    assert int(state["ovf"]) == int(rstate["ovf"])


def test_seam_merge_matches_reference(harness):
    """Four tasks' seeded states through both packages' seam merges: every
    task's shard holds the same groups with the same finalized values
    (the routing is the same value hash), dictionary keys unified across
    tasks whose dictionaries differ."""
    import jax.numpy as jnp

    port, ref = harness
    spec, rspec = _specs(port, ref, AGG_SQL, 64)
    types = list(spec.feed.output_types)
    rtypes = list(rspec.feed.output_types)
    rng = np.random.RandomState(11)
    ex = SC.FusedStageExec(spec, Mesh([torch.device("cpu")] * 4))
    rex = RSC.FusedStageExec(rspec)
    vocab = np.array(["A", "B", "F", "N", "O", "R"], dtype=object)
    for t in range(4):
        # each task sees its own dictionary (a drifting string key)
        dictionary = np.sort(rng.choice(vocab, 4, replace=False))
        dicts = [dictionary if ty.is_dictionary_encoded else None
                 for ty in types]
        prog = SC._accumulate_program(spec, types, dicts,
                                      torch.device("cpu"))
        rprog = RSC._accumulate_program(rspec, rtypes, dicts)
        cols, live = _batch(rng, types, 64, dictionary)
        state = prog(prog.initial_state(),
                     tuple((torch.from_numpy(d), torch.from_numpy(v))
                           for d, v in cols), torch.from_numpy(live),
                     (None,) * spec.nk, (None,) * spec.nk)
        rstate = rprog(rprog.initial_state(),
                       tuple((jnp.asarray(d), jnp.asarray(v))
                             for d, v in cols), jnp.asarray(live),
                       (None,) * spec.nk, (None,) * spec.nk)
        ex.deposit(t, state, prog.key_dicts, SC.FusedStageStats())
        rex.deposit(t, rstate, rprog.key_dicts, RSC.FusedStageStats())
    for t in range(4):
        got, want = ex.take(t, timeout=5), rex.take(t, timeout=5)
        _equiv(sorted(got.to_pylist(), key=repr),
               sorted(want.to_pylist(), key=repr))
        assert got.to_pylist()


# ---------------------------------------------------------------------------
# the default path: rows of the seam queries, statistics, metrics, errors


@pytest.mark.parametrize("name", sorted(SEAM_QUERIES))
def test_seam_queries_match_reference(harness, monkeypatch, name):
    """Both packages at their defaults (fused seams and resident plans on)
    compile the same edges and give the same rows."""
    monkeypatch.delenv("TRINO_TPU_RESIDENT_PLAN")
    port, ref = harness
    sql = SEAM_QUERIES[name]
    before = (port.fused_fallbacks, port.resident_fallbacks,
              ref.fused_fallbacks, ref.resident_fallbacks)
    got = port.execute(sql).rows()
    want = ref.execute(sql).rows()
    _equiv(got, want, 1e-4 if name in ("R1", "R2") else 1e-12,
           ordered=name in _ORDERED)
    assert port._fused_edges or port._resident_edges
    assert sorted(port._fused_edges) == sorted(ref._fused_edges)
    assert sorted(port._resident_edges) == sorted(ref._resident_edges)
    assert (port.fused_fallbacks, port.resident_fallbacks,
            ref.fused_fallbacks, ref.resident_fallbacks) == before


def test_seam_runs_through_hash_insert(harness, monkeypatch):
    """Every accumulate call groups its batch and merges the state through
    ``hash_insert`` (its plain version on the CPU), the seam merge once
    more per task."""
    port, _ = harness
    calls = []
    orig = GK.hash_insert_plain
    monkeypatch.setattr(GK, "hash_insert_plain",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    sql = ("select l_returnflag, sum(l_quantity) from lineitem "
           "group by l_returnflag")
    port.execute(sql)
    (ex,) = port._fused_edges.values()
    assert len(calls) == 2 * ex.stats.jit_calls + 4


def test_explain_analyze_and_metrics(harness):
    """EXPLAIN ANALYZE carries the reference's ``fused stages:`` line and
    the FUSED_* families move by the query's roll-up."""
    port, _ = harness
    before = {m: m.value() for m in (tm.FUSED_STAGES, tm.FUSED_BATCHES,
                                   tm.FUSED_JIT_CALLS, tm.FUSED_MERGES)}
    lines = [r[0] for r in port.execute("explain analyze " + AGG_SQL).rows()]
    (i,) = [i for i, line in enumerate(lines) if line == "fused stages:"]
    assert lines[i + 1].startswith("  fused: 1 stages, ")
    assert lines[i + 1].endswith(", 1 seam merges, 0 fallbacks")
    after = {m: m.value() for m in before}
    assert after[tm.FUSED_STAGES] == before[tm.FUSED_STAGES] + 1
    assert after[tm.FUSED_MERGES] == before[tm.FUSED_MERGES] + 1
    assert after[tm.FUSED_JIT_CALLS] - before[tm.FUSED_JIT_CALLS] == \
        after[tm.FUSED_BATCHES] - before[tm.FUSED_BATCHES] > 0


def test_merge_error_fails_query_without_fallback(harness, monkeypatch):
    """Only an overflow re-runs the query: an error in the seam merge fails
    it, and no fallback is counted."""
    port, _ = harness

    def boom(self):
        raise RuntimeError("injected merge failure")

    monkeypatch.setattr(SC.FusedStageExec, "_run_merge", boom)
    before = (port.fused_fallbacks, port.resident_fallbacks,
              tm.FUSED_FALLBACKS.value())
    with pytest.raises(TrinoError, match="injected merge failure"):
        port.execute(AGG_SQL)
    assert (port.fused_fallbacks, port.resident_fallbacks,
            tm.FUSED_FALLBACKS.value()) == before


@pytest.mark.parametrize("name", [
    "TRINO_TPU_FUSED_STAGE", "TRINO_TPU_FUSED_CAP",
    "TRINO_TPU_RESIDENT_PLAN", "TRINO_TPU_RESIDENT_MAX_FRAGMENTS",
    "TRINO_TPU_MESH_SHAPE"])
def test_knobs_are_declared_as_the_reference_declares_them(name):
    mine, theirs = PK.knob(name), RK.knob(name)
    assert (mine.type, mine.default, mine.choices) == \
        (theirs.type, theirs.default, theirs.choices)


def test_time_sharing_scheduler_runs_the_fused_stage(harness, oracle):
    """On the time-sharing executor with one worker the fused sources park
    until the merge ran, and the rows are the same."""
    port = DistributedQueryRunner(
        default_catalog(SF), worker_count=4, device="cpu",
        session=Session(node_count=4, task_scheduler="TIME_SHARING",
                        executor_workers=1))
    result = port.execute(AGG_SQL)
    assert port._fused_edges
    assert_same_rows(result.rows(), oracle.query(AGG_SQL))

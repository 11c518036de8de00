"""The port's cache plane held to the reference: one scripted statement
sequence (repeated text, a SET SESSION flip, DDL, an INSERT into a scanned
memory table, a file-connector INSERT, CTAS, a system-table read) runs
through both packages, with equal plan-tier and result-tier hits, misses,
evictions and invalidations after every statement and equal rows.  Also:
the runner's execution key keeps CPU and CUDA entries apart, each memo
moved into the registry shows up there and evicts at its bound, clones
share tensors, ``stats=`` bypasses both tiers, and the reference's
cache-bounds and metric-name lints pass over the port."""

import gc
import os
import sys
import uuid
import weakref

import numpy as np
import pytest
import torch

from trino_tpu import caching as ref_caching
from trino_tpu.caching import plan_cache as ref_plan_cache
from trino_tpu.caching import result_cache as ref_result_cache
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.runner import Session as RefSession
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu.telemetry import journal as ref_journal

from trino_tpu_torch import caching
from trino_tpu_torch.caching import executable_cache, plan_cache, result_cache
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.exec import join_exec as JX
from trino_tpu_torch.exec import local_exchange as LX
from trino_tpu_torch.exec import syncguard as SG
from trino_tpu_torch.exec.stats import QueryStats
from trino_tpu_torch.execution import serde
from trino_tpu_torch.ops import gpu_kernels as GK
from trino_tpu_torch.planner.plan import TableScan
from trino_tpu_torch import runner as runner_mod
from trino_tpu_torch.runner import Session, StandaloneQueryRunner
from trino_tpu_torch.spi import batch as B
from trino_tpu_torch.spi.types import BIGINT, VARCHAR
from trino_tpu_torch.telemetry import journal
from trino_tpu_torch.telemetry import runtime as rt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SF = 0.01
STAT_KEYS = ("entries", "hits", "misses", "evictions", "invalidations")


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    """tests/test_caching.py's fresh-cache fixture, for both packages."""
    monkeypatch.setenv("TRINO_TPU_JOURNAL_DIR", str(tmp_path / "journal"))
    for knob in ("TRINO_TPU_PLAN_CACHE", "TRINO_TPU_RESULT_CACHE",
                 "TRINO_TPU_PLAN_CACHE_ENTRIES",
                 "TRINO_TPU_RESULT_CACHE_BYTES"):
        monkeypatch.delenv(knob, raising=False)
    for k, v in (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
                 ("TRINO_TPU_HBO", "0"), ("TRINO_TPU_OPTIMIZER", "iterative")):
        monkeypatch.setenv(k, v)
    for pkg_caching, pkg_journal in ((caching, journal),
                                     (ref_caching, ref_journal)):
        pkg_caching.reset_for_test()
        pkg_journal.reset_for_test()
    yield
    for pkg_caching, pkg_journal in ((caching, journal),
                                     (ref_caching, ref_journal)):
        pkg_caching.reset_for_test()
        pkg_journal.reset_for_test()


# ---------------------------------------------------------------------------
# the scripted sequence

SEQUENCE = (
    "select count(*) from tpch.region",
    "select count(*) from tpch.region",
    "select n_regionkey, count(*) from tpch.nation group by n_regionkey",
    "select n_regionkey, count(*) from tpch.nation group by n_regionkey",
    "set session splits_per_node = 2",
    "select n_regionkey, count(*) from tpch.nation group by n_regionkey",
    "select count(*) from tpch.region",
    "create table t (a bigint, b varchar)",
    "insert into t values (1, 'x'), (2, 'y')",
    "select count(*), sum(a) from t",
    "select count(*), sum(a) from t",
    "select b from t order by b",
    "insert into t values (3, 'z')",
    "select count(*), sum(a) from t",
    "select b from t order by b",
    "select count(*), sum(a) from t",
    "create table file.f (a bigint)",
    "insert into file.f values (5)",
    "select sum(a) from file.f",
    "select sum(a) from file.f",
    "insert into file.f values (6), (7)",
    "select sum(a) from file.f",
    "create table t2 as select a, b from t where a > 1",
    "select count(*) from t2",
    "select count(*) from t2",
    "select count(*) from system.runtime.caches where tier = 'plan'",
    "select count(*) from system.runtime.caches where tier = 'plan'",
    "select count(*) from tpch.region",
    "select count(*), sum(a) from t",
    "drop table t2",
    "select count(*), sum(a) from t",
)

# a 32-byte budget admits results of at most 8 bytes (a quarter), and the
# sequence's fifth such result evicts the oldest
CONFIGS = {
    "defaults": {},
    "two_plans": {"TRINO_TPU_PLAN_CACHE_ENTRIES": "2"},
    "result_budget": {"TRINO_TPU_RESULT_CACHE_BYTES": "32"},
    "no_plan_tier": {"TRINO_TPU_PLAN_CACHE": "0"},
}


def _tiers(plan_mod, result_mod) -> dict:
    p, r = plan_mod.stats(), result_mod.stats()
    return {"plan": {k: p[k] for k in STAT_KEYS},
            "result": {k: r[k] for k in STAT_KEYS}}


def _rows(res, sql: str) -> list:
    rows = [tuple(round(v, 9) if isinstance(v, float) else v for v in row)
            for row in res.rows()]
    return rows if "order by" in sql else sorted(rows)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_scripted_sequence_matches_reference(config, monkeypatch, tmp_path):
    for k, v in CONFIGS[config].items():
        monkeypatch.setenv(k, v)
    port = StandaloneQueryRunner(
        default_catalog(SF, file_root=str(tmp_path / "port_files")),
        device="cpu", session=Session(default_catalog="memory"))
    ref = RefRunner(ref_catalog(SF, file_root=str(tmp_path / "ref_files")),
                    session=RefSession(default_catalog="memory"))
    for i, sql in enumerate(SEQUENCE):
        got = _rows(port.execute(sql), sql)
        want = _rows(ref.execute(sql), sql)
        assert got == want, (i, sql)
        assert _tiers(plan_cache, result_cache) == \
            _tiers(ref_plan_cache, ref_result_cache), (i, sql)
    final = _tiers(plan_cache, result_cache)
    if config == "defaults":
        assert final["plan"]["hits"] > 0 and final["result"]["hits"] > 0
        assert final["result"]["invalidations"] > 0
    if config == "two_plans":
        assert final["plan"]["evictions"] > 0
    if config == "result_budget":
        assert final["result"]["evictions"] > 0
    if config == "no_plan_tier":
        assert final["plan"]["misses"] == 0 == final["result"]["hits"]


def test_repeated_text_is_a_plan_and_result_hit():
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    q = "select n_regionkey, count(*) from nation group by n_regionkey"
    first = r.execute(q)
    second = r.execute(q)
    assert second is first  # the stored result is handed out
    assert plan_cache.stats()["hits"] == 1
    assert result_cache.stats()["hits"] == 1
    assert result_cache.stats()["bytes"] == result_cache.result_nbytes(first)


def test_a_result_hit_reads_no_row_count_from_the_device(monkeypatch):
    """The output row count is read once per result and kept with it, so
    a result-cache hit does no device read."""
    reads = []
    real = runner_mod._output_rows

    def spy(result):
        reads.append(result.output_rows is None)
        return real(result)
    monkeypatch.setattr(runner_mod, "_output_rows", spy)
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    q = "select n_name from nation where n_regionkey = 1"
    first = r.execute(q)
    assert r.execute(q) is first
    assert reads == [True, False] and first.output_rows == 5
    assert [rec.output_rows for rec in rt.queries()[-2:]] == [5, 5]
    # a result with a live mask: one counted read, then none
    masked = runner_mod.QueryResult(["x"], B.ColumnBatch(
        ["x"], [B.Column(BIGINT, torch.arange(4))],
        live=torch.tensor([True, False, True, True])))
    before = SG.snapshot()
    assert real(masked) == 3 == real(masked)
    assert SG.take_delta(before).by_tag == {"runner.output-rows": 1}


def test_stats_bypass_both_tiers():
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    q = "select count(*) from region"
    r.execute(q)
    before = _tiers(plan_cache, result_cache)
    st = QueryStats()
    assert r.execute(q, stats=st).rows() == [(5,)]
    assert _tiers(plan_cache, result_cache) == before
    assert st.pipelines and st.scan.scan_rows == 5


def test_result_nbytes_counts_tensors_and_dictionaries():
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    res = r.execute("select n_name, n_nationkey from nation")
    names, keys = res.batch.columns
    assert result_cache.result_nbytes(res) == (
        names.data.numel() * 4 + names.dictionary.nbytes
        + keys.data.numel() * keys.data.element_size())


def test_disabled_scope_restores_the_switch(monkeypatch):
    monkeypatch.setenv("TRINO_TPU_RESULT_CACHE", "1")
    with result_cache.disabled():
        assert not result_cache.enabled()
        assert not ref_result_cache.enabled()  # one variable, both packages
    assert os.environ["TRINO_TPU_RESULT_CACHE"] == "1"
    monkeypatch.delenv("TRINO_TPU_RESULT_CACHE")
    with result_cache.disabled():
        pass
    assert "TRINO_TPU_RESULT_CACHE" not in os.environ


# ---------------------------------------------------------------------------
# the execution key: CPU and CUDA entries never meet


def _cuda_key(runner) -> tuple:
    return runner.execution_key[:-1] + ("cuda",)


def test_cpu_and_cuda_runners_never_share_a_plan():
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    q = "select count(*) from region"
    r.execute(q)
    assert r.execution_key[-1] == "cpu"
    assert plan_cache.lookup(q, r.session, r.catalog, r.execution_key)
    assert plan_cache.lookup(q, r.session, r.catalog, _cuda_key(r)) is None


def test_cpu_and_cuda_runners_never_share_a_result():
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    q = "select count(*) from region"
    r.execute(q)
    plan = r.create_plan(q)
    versions = result_cache.version_vector(
        plan_cache.scan_tables(plan), r.catalog)
    cpu = plan_cache.store(q, r.session, r.catalog, plan, r.execution_key)
    cuda = plan_cache.store(q, r.session, r.catalog, plan, _cuda_key(r))
    assert result_cache.lookup(result_cache.result_key(cpu, versions))
    assert result_cache.lookup(
        result_cache.result_key(cuda, versions)) is None


@pytest.mark.parametrize("field", ["optimizer", "encoded_exec", "ingest"])
def test_execution_key_separates_runner_arguments(field):
    from trino_tpu_torch.exec.prefetch import IngestConfig

    kwargs = {"optimizer": {"optimizer": "legacy"},
              "encoded_exec": {"encoded_exec": False},
              "ingest": {"ingest": IngestConfig(enabled=False)}}[field]
    cat = default_catalog(SF)
    a = StandaloneQueryRunner(cat, device="cpu")
    b = StandaloneQueryRunner(cat, device="cpu", **kwargs)
    assert a.execution_key != b.execution_key
    q = "select count(*) from region"
    a.execute(q)
    hits = plan_cache.stats()["hits"]
    b.execute(q)
    assert plan_cache.stats()["hits"] == hits


def test_writer_plans_stay_out_of_the_plan_tier():
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu",
                              session=Session(default_catalog="memory"))
    r.execute("create table w (a bigint)")
    for _ in range(2):
        r.execute("insert into w values (1)")
    assert plan_cache.stats()["entries"] == 0
    assert r.execute("select count(*) from w").rows() == [(2,)]


def test_clone_shares_tensors_and_copies_nodes():
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    plan = r.create_plan("select n_name from nation where n_nationkey < 5")
    t = torch.arange(4)

    def scan(node):
        if isinstance(node, TableScan):
            return node
        return next(s for s in map(scan, node.children) if s is not None)

    object.__setattr__(scan(plan), "constraint", {"payload": t})
    copy = plan_cache.clone(plan)
    assert copy is not plan and copy == plan
    assert scan(copy) is not scan(plan)
    assert scan(copy).constraint["payload"] is t


# ---------------------------------------------------------------------------
# the executable registry: the migrated memos


def _stub_segment_lib(monkeypatch):
    class Lib:
        @staticmethod
        def segment_sum_setup(G, blocks):
            blocks._obj.value = 132 + G
            return 0
    monkeypatch.setattr(GK, "_lib", lambda: Lib)


def _fill(name: str, n: int, monkeypatch) -> list:
    """Make ``n`` distinct entries in the memo ``name``; returns the
    dictionaries the identity-keyed memos need kept alive."""
    keep = [np.array([f"v{i}"], dtype=object) for i in range(n)]
    if name == "batch.dictionary_nbytes":
        for d in keep:
            B._dictionary_nbytes(d)
    elif name == "local_exchange.entry_hashes":
        for d in keep:
            LX._entry_hashes(d, torch.device("cpu"))
    elif name == "serde.packed_dicts":
        for d in keep:
            serde._packed_dict(d)
    elif name == "join_exec.estimate_seeds":
        for i in range(n):
            JX.ExpandPlanner(key=("shape", i)).observe(10 + i)
    elif name == "gpu_kernels.segment_grid":
        _stub_segment_lib(monkeypatch)
        for i in range(n):
            GK._segment_grid(1000 + i, 7)
    return keep


MEMOS = {"batch.dictionary_nbytes": 4096, "local_exchange.entry_hashes": 256,
         "serde.packed_dicts": 64, "join_exec.estimate_seeds": 4096,
         "gpu_kernels.segment_grid": 256}


@pytest.mark.parametrize("name", sorted(MEMOS))
def test_migrated_memo_is_registered_and_evicts_at_its_bound(
        name, monkeypatch):
    rows = {r["name"]: r for r in executable_cache.registry_stats()}
    assert name in rows and rows[name]["tier"] == "exec"
    before = rows[name]
    bound = MEMOS[name]
    keep = _fill(name, bound + 3, monkeypatch)
    after = {r["name"]: r for r in executable_cache.registry_stats()}[name]
    assert after["entries"] == bound
    assert after["evictions"] - before["evictions"] == 3
    assert after["misses"] - before["misses"] >= bound + 3
    del keep
    caching.reset_for_test()
    assert {r["name"]: r for r in
            executable_cache.registry_stats()}[name]["entries"] == 0


def test_memo_hits_and_system_caches_rows():
    d = np.array(["a", "bb"], dtype=object)
    n0 = B._object_payload_nbytes.stats()["hits"]
    assert B._dictionary_nbytes(d) == B._dictionary_nbytes(d) == 3
    assert B._object_payload_nbytes.stats()["hits"] == n0 + 1
    r = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    rows = r.execute("select tier, name, entries, hits, misses, evictions "
                     "from system.runtime.caches").rows()
    names = [row[1] for row in rows]
    assert names[0] == "plan" and names[-1] == "result"
    assert set(MEMOS) <= set(names)
    agg = executable_cache.aggregate_stats()
    exec_rows = [row for row in rows if row[0] == "exec"]
    assert agg["evictions"] >= sum(row[5] for row in exec_rows)


WEAK_MEMOS = {
    "batch.dictionary_nbytes": lambda d: B._dictionary_nbytes(d),
    "local_exchange.entry_hashes":
        lambda d: LX._entry_hashes(d, torch.device("cpu")),
    "serde.packed_dicts": lambda d: serde._packed_dict(d),
}


@pytest.mark.parametrize("name", sorted(WEAK_MEMOS))
def test_identity_keyed_memo_keeps_no_dictionary_alive(name):
    """A dictionary is freed once its batch is dropped, and its entry goes
    with it."""
    batch = B.ColumnBatch(["s"], [B.Column(
        VARCHAR, torch.tensor([0, 1, 0], dtype=torch.int32),
        dictionary=np.array([f"x{uuid.uuid4().hex}", "y"], dtype=object))])
    d = batch.columns[0].dictionary
    ref = weakref.ref(d)
    cache = {r["name"]: r for r in executable_cache.registry_stats()}
    entries0 = cache[name]["entries"]
    WEAK_MEMOS[name](d)
    WEAK_MEMOS[name](d)
    row = {r["name"]: r for r in executable_cache.registry_stats()}[name]
    assert row["entries"] == entries0 + 1 and row["hits"] >= 1
    del batch, d
    gc.collect()
    assert ref() is None
    row = {r["name"]: r for r in executable_cache.registry_stats()}[name]
    assert row["entries"] == entries0


def test_a_finalizer_inside_the_caches_lock_does_not_deadlock():
    """The garbage collector may run a weak entry's finalizer on a thread
    that holds the cache's lock (inside ``put``'s insertion, when an
    allocation triggers a collection): the finalizer must not wait for
    that lock.  The entry goes when the lock is let go."""
    import threading

    cache = executable_cache.BoundedCache("test.finalizer", 4)
    cache.put("a", 1)
    cache.put("b", 2)
    done = threading.Event()

    def collect_inside_the_lock():
        with cache._lock:
            cache.discard("a")  # what the finalizer of "a" calls
        done.set()

    t = threading.Thread(target=collect_inside_the_lock, daemon=True)
    t.start()
    t.join(timeout=10)
    assert done.is_set(), "the finalizer waited for its own thread's lock"
    assert cache.stats()["entries"] == 1
    assert cache.get("a") is None and cache.get("b") == 2
    cache.discard("b")  # the lock is free: dropped at once
    assert len(cache) == 0


def test_exec_kill_switch_gives_bounded_unregistered_memos(monkeypatch):
    monkeypatch.setenv("TRINO_TPU_EXEC_CACHE", "0")
    name = f"test.off_{uuid.uuid4().hex[:8]}"

    @executable_cache.memo(name, maxsize=2)
    def ident(x):
        return x

    for i in range(5):
        ident(i)
    assert name not in {r["name"] for r in executable_cache.registry_stats()}
    assert len(ident.cache) == 2 and ident.cache.evictions == 3


def test_compile_cache_has_no_counterpart():
    d = executable_cache.init_compile_cache()
    assert d is None or d.endswith(os.path.join("build", "kernels"))


# ---------------------------------------------------------------------------
# the reference's lints over the port


def _port_files() -> list:
    root = os.path.join(REPO, "trino_tpu_torch")
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(root)
                  for f in fs if f.endswith(".py"))


def _tools():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tools import lint_cache_bounds, lint_metric_names

    return lint_cache_bounds, lint_metric_names


def test_cache_bounds_lint_passes_over_the_port():
    lint, _ = _tools()
    findings = [f for p in _port_files() for f in lint.lint_file(p)]
    assert findings == []


def test_metric_names_lint_passes_over_the_port():
    _, lint = _tools()
    findings = [f for p in _port_files() for f in lint.lint_file(p)]
    assert findings == []
    sites = {}
    import ast

    for p in _port_files():
        with open(p, encoding="utf-8") as f:
            text = f.read()
        for node in ast.walk(ast.parse(text)):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("counter", "gauge",
                                           "distribution")
                    and node.args and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                sites.setdefault(node.args[0].value, []).append(p)
    assert sites and all(len(v) == 1 for v in sites.values())

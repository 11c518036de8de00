"""The port's history-based optimization (planner/history.py) against the
reference.

The reference's tests/test_hbo.py cases run on the port: fingerprint
invariances, the journal round trip, the epoch, the plan-cache key,
second-run planning, the history-driven fan-out and the iterative-vs-
legacy row identity.  Then parity with the reference (pinned as ROADMAP
"Pinning the reference" says, HBO on): fingerprints equal the
reference's for every node of the 22 TPC-H plans and R1 / R2, plan-time
and fragmented at four workers; the ``plan_stats`` the port records for
Q3, Q5 and Q18 equal the reference's, bytes included; plan_stats written
by either package give both packages the same second-run plans, epochs
and fan-out adjustments; and the planner's join distribution reads
``TRINO_TPU_BROADCAST_ROW_LIMIT`` and history's observed build bytes as
the reference's does.  Every journal is a fresh directory per test.
"""

import dataclasses
import json

import pytest
import torch

from test_torch_queries_q13_q22 import R1, R2
from trino_tpu.caching import plan_cache as ref_plan_cache
from trino_tpu.caching import result_cache as ref_result_cache
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.execution.distributed_runner import (
    DistributedQueryRunner as RefDist)
from trino_tpu.planner import history as ref_history
from trino_tpu.planner import optimizer as ref_optimizer
from trino_tpu.planner.plan import plan_text as ref_text
from trino_tpu.runner import Session as RefSession
from trino_tpu.runner import StandaloneQueryRunner as RefStandalone
from trino_tpu.telemetry import journal as ref_journal
from trino_tpu_torch.caching import plan_cache, result_cache
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.tpch_queries import QUERIES
from trino_tpu_torch.execution.distributed_runner import (
    DistributedQueryRunner)
from trino_tpu_torch.planner import history
from trino_tpu_torch.planner import optimizer as port_optimizer
from trino_tpu_torch.planner.plan import (Filter, Join, Project,
                                          RemoteSource, TableScan, plan_text)
from trino_tpu_torch.runner import Session, StandaloneQueryRunner
from trino_tpu_torch.spi.types import BIGINT, BOOLEAN
from trino_tpu_torch.sql.ir import Call, InputRef, Literal
from trino_tpu_torch.telemetry import journal
from trino_tpu_torch.telemetry import runtime as rt

SF = 0.01
PINS = (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
        ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_OPTIMIZER", "iterative"))
CASES = ([(f"Q{q}", QUERIES[q]) for q in sorted(QUERIES)]
         + [("R1", R1), ("R2", R2)])


def _reset_planning_caches():
    for pc, rc, h in ((plan_cache, result_cache, history),
                      (ref_plan_cache, ref_result_cache, ref_history)):
        pc.reset_for_test()
        rc.reset_for_test()
        h.reset_for_test()


def _point_journals(path) -> None:
    """Both packages' journals at ``path`` (fresh singletons)."""
    import os

    os.environ["TRINO_TPU_JOURNAL_DIR"] = str(path)
    journal.reset_for_test()
    ref_journal.reset_for_test()
    _reset_planning_caches()


@pytest.fixture(autouse=True)
def _pin(monkeypatch):
    for k, v in PINS:
        monkeypatch.setenv(k, v)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def journal_env(tmp_path, monkeypatch):
    """An isolated journal and HBO on; every cache keyed on journal state
    is reset on the way in and out, in both packages."""
    monkeypatch.setenv("TRINO_TPU_JOURNAL_DIR", str(tmp_path / "journal"))
    monkeypatch.setenv("TRINO_TPU_HBO", "1")
    _point_journals(tmp_path / "journal")
    with result_cache.disabled():
        yield tmp_path
    journal.reset_for_test()
    ref_journal.reset_for_test()
    _reset_planning_caches()


# ----------------------------------------------------- the reference's


def _scan(table="nation", cols=("a", "b")):
    return TableScan(cols, (BIGINT,) * len(cols), catalog="tpch",
                     table=table, columns=tuple("c_" + c for c in cols))


def _gt(ch, lit):
    return Call(BOOLEAN, "gt", (InputRef(BIGINT, ch), Literal(BIGINT, lit)))


def test_fingerprint_ignores_inner_join_side_order():
    l, r = _scan("customer"), _scan("orders", cols=("x", "y"))
    ab = Join(l.output_names + r.output_names, (BIGINT,) * 4,
              l, r, "INNER", (0,), (0,), None)
    ba = Join(r.output_names + l.output_names, (BIGINT,) * 4,
              r, l, "INNER", (0,), (0,), None)
    assert history.logical_fingerprint(ab) == history.logical_fingerprint(ba)
    lab = Join(ab.output_names, ab.output_types, l, r, "LEFT",
               (0,), (0,), None)
    lba = Join(ba.output_names, ba.output_types, r, l, "LEFT",
               (0,), (0,), None)
    assert (history.logical_fingerprint(lab)
            != history.logical_fingerprint(lba))


def test_fingerprint_ignores_distribution_and_projections():
    l, r = _scan("customer"), _scan("orders", cols=("x", "y"))
    j = Join(l.output_names + r.output_names, (BIGINT,) * 4,
             l, r, "INNER", (0,), (0,), None, distribution="BROADCAST")
    assert (history.logical_fingerprint(j) == history.logical_fingerprint(
        dataclasses.replace(j, distribution="PARTITIONED")))
    ident = Project(j.output_names, j.output_types, j,
                    tuple(InputRef(BIGINT, i) for i in range(4)))
    assert (history.logical_fingerprint(ident)
            == history.logical_fingerprint(j))


def test_fingerprint_is_channel_remap_stable():
    s = _scan()
    direct = Filter(s.output_names, s.output_types, s, _gt(0, 5))
    swapped = Project(("b", "a"), (BIGINT, BIGINT), s,
                      (InputRef(BIGINT, 1), InputRef(BIGINT, 0)))
    remapped = Filter(swapped.output_names, swapped.output_types,
                      swapped, _gt(1, 5))
    assert (history.logical_fingerprint(direct)
            == history.logical_fingerprint(remapped))


def test_fingerprint_sorts_conjuncts():
    s = _scan()
    p12 = Call(BOOLEAN, "$and", (_gt(0, 1), _gt(1, 2)))
    p21 = Call(BOOLEAN, "$and", (_gt(1, 2), _gt(0, 1)))
    f12 = Filter(s.output_names, s.output_types, s, p12)
    f21 = Filter(s.output_names, s.output_types, s, p21)
    assert (history.logical_fingerprint(f12)
            == history.logical_fingerprint(f21))
    other = Filter(s.output_names, s.output_types, s, _gt(0, 99))
    assert (history.logical_fingerprint(f12)
            != history.logical_fingerprint(other))


def test_provider_round_trips_through_journal(journal_env):
    j = journal.get_journal()
    j.plan_stats("q1", "sqlfp", {"fp_a": {"rows": 1000, "bytes": 5000}},
                 ts=1.0)
    j.plan_stats("q2", "sqlfp", {"fp_a": {"rows": 2000},
                                 "fp_b": {"groups": 7}}, ts=2.0)
    history.reset_for_test()
    provider = history.provider_if_enabled()
    assert provider is not None
    st = provider.table["fp_a"]
    assert st.rows == 2000 and st.bytes == 5000
    assert provider.table["fp_b"].groups == 7
    assert history.history_epoch() != ""
    # the reference reads the port's records to the same table and epoch
    ref_table, ref_epoch = ref_history._stats_table()
    assert {k: dataclasses.astuple(v) for k, v in ref_table.items()} == \
        {k: dataclasses.astuple(v) for k, v in provider.table.items()}
    assert ref_epoch == history.history_epoch()


def test_hbo_off_disables_provider_and_epoch(journal_env, monkeypatch):
    journal.get_journal().plan_stats("q1", "f", {"fp": {"rows": 5}}, ts=1.0)
    history.reset_for_test()
    assert history.provider_if_enabled() is not None
    monkeypatch.setenv("TRINO_TPU_HBO", "0")
    assert history.provider_if_enabled() is None
    assert history.history_epoch() == ""


def test_history_epoch_tracks_recorded_stats(journal_env):
    assert history.history_epoch() == ""
    journal.get_journal().plan_stats("q1", "f", {"fp": {"rows": 5}}, ts=1.0)
    history.reset_for_test()
    e1 = history.history_epoch()
    assert e1 != ""
    journal.get_journal().plan_stats("q2", "f", {"fp": {"rows": 9}}, ts=2.0)
    history.reset_for_test()
    e2 = history.history_epoch()
    assert e2 not in ("", e1)


def _table_equals_reference() -> dict:
    """The port's table and epoch against the reference's full read of
    the same journal files."""
    table, epoch = history._stats_table()
    ref_table, ref_epoch = ref_history._stats_table()
    assert {k: dataclasses.astuple(v) for k, v in table.items()} == \
        {k: dataclasses.astuple(v) for k, v in ref_table.items()}
    assert epoch == ref_epoch
    return table


def _query_records() -> list:
    return [r for r in journal.sample_records()
            if r["event"] != "plan_stats"]


def test_stats_table_parses_only_appended_records(journal_env):
    """Without a reset, a lookup reads what the journal gained: the query
    records every query appends keep the table (no rebuild), a plan_stats
    record rebuilds it, and table and epoch stay the reference's."""
    j = journal.get_journal()
    j.plan_stats("q1", "f", {"fp_a": {"rows": 5, "bytes": 40}}, ts=1.0)
    t1 = _table_equals_reference()
    for rec in _query_records():
        j._write(rec)
    assert history._stats_table()[0] is t1
    _table_equals_reference()
    j.plan_stats("q2", "f", {"fp_a": {"rows": 9}}, ts=2.0)
    t2 = _table_equals_reference()
    assert t2 is not t1 and (t2["fp_a"].rows, t2["fp_a"].bytes) == (9, 40)


def test_stats_table_follows_rotation(journal_env, monkeypatch):
    """Rotations rename the files and drop the oldest; after every append
    the table is the reference's full read of the files left."""
    monkeypatch.setenv("TRINO_TPU_JOURNAL_MAX_BYTES", "700")
    monkeypatch.setenv("TRINO_TPU_JOURNAL_FILES", "2")
    journal.reset_for_test()
    j = journal.get_journal()
    filler = _query_records()
    for i in range(16):
        j.plan_stats(f"q{i}", "f", {f"fp{i % 5}": {"rows": i}}, ts=float(i))
        j._write(filler[i % len(filler)])
        _table_equals_reference()
    assert len(j.files()) == 3
    assert len(_table_equals_reference()) < 5  # the oldest rotated out


def test_stats_table_waits_for_a_torn_line(journal_env):
    """A line without its newline (a write in flight, or a crash) is
    skipped as the reference skips it, and read once it is whole."""
    j = journal.get_journal()
    j.plan_stats("q1", "f", {"fp_a": {"rows": 5}}, ts=1.0)
    line = json.dumps({"schema": journal.SCHEMA_VERSION,
                       "event": "plan_stats", "query_id": "q2",
                       "nodes": {"fp_t": {"rows": 3}}}) + "\n"
    with open(j.path, "ab") as f:
        f.write(line[:40].encode())
    assert "fp_t" not in _table_equals_reference()
    with open(j.path, "ab") as f:
        f.write(line[40:].encode())
    assert _table_equals_reference()["fp_t"].rows == 3


def test_plan_cache_key_includes_history_epoch(journal_env):
    from trino_tpu_torch.caching.plan_cache import _key

    catalog = default_catalog(SF)
    session = Session()
    k1 = _key("select 1", session, catalog, "plan", ())
    journal.get_journal().plan_stats("q1", "f", {"fp": {"rows": 5}}, ts=1.0)
    history.reset_for_test()
    k2 = _key("select 1", session, catalog, "plan", ())
    assert k1 != k2 and k2[-1] == history.history_epoch()


_WRONG_SQL = """
select c.c_mktsegment, count(*) n
from customer c
join (select o_custkey from orders
      where o_orderkey > -1 and o_orderkey > -2
        and o_orderkey > -3 and o_orderkey > -4) o
  on c.c_custkey = o.o_custkey
group by c.c_mktsegment order by c.c_mktsegment
"""


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def _join_plan(runner, sql):
    """(distribution, base tables feeding the build side) of the sole
    join, following remote exchanges."""
    frags = runner.create_subplan(sql).all_fragments()
    by_id = {f.id: f for f in frags}
    join = next(n for f in frags for n in _walk(f.root)
                if type(n).__name__ == "Join")

    def tables(node, seen):
        out = set()
        for n in _walk(node):
            if type(n).__name__ == "TableScan":
                out.add(n.table)
            elif (type(n).__name__ == "RemoteSource"
                  and n.fragment_id not in seen):
                seen.add(n.fragment_id)
                out |= tables(by_id[n.fragment_id].root, seen)
        return out

    return join.distribution, sorted(tables(join.right, set()))


def _fresh_distributed(workers=2, sf=0.02, **kw):
    _reset_planning_caches()
    return DistributedQueryRunner(
        default_catalog(sf), worker_count=workers, device="cpu",
        session=Session(node_count=workers, adaptive="0", **kw))


def test_second_run_plans_correct_build_side(journal_env, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_BROADCAST_ROW_LIMIT", "1000")
    r1 = _fresh_distributed()
    dist1, build1 = _join_plan(r1, _WRONG_SQL)
    assert (dist1, build1) == ("BROADCAST", ["orders"])
    rows1 = r1.execute(_WRONG_SQL).rows()
    r2 = _fresh_distributed()
    dist2, build2 = _join_plan(r2, _WRONG_SQL)
    assert not (dist2 == "BROADCAST" and "orders" in build2)
    assert r2.execute(_WRONG_SQL).rows() == rows1
    monkeypatch.setenv("TRINO_TPU_HBO", "0")
    r3 = _fresh_distributed()
    assert _join_plan(r3, _WRONG_SQL) == (dist1, build1)
    assert r3.execute(_WRONG_SQL).rows() == rows1


def test_history_shrinks_task_fanout(journal_env, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_FUSED_STAGE", "0")
    sql = ("select o_custkey, count(*) c from orders "
           "group by o_custkey order by o_custkey limit 5")
    r1 = _fresh_distributed(sf=SF, use_collectives=False)
    rows1 = r1.execute(sql).rows()
    r2 = _fresh_distributed(sf=SF, use_collectives=False)
    assert r2.execute(sql).rows() == rows1
    assert "hbo_fanout" in rt.queries()[-1].adaptive_decisions


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_iterative_matches_legacy_tpch(q, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_HBO", "0")
    cat = default_catalog(SF)
    legacy = StandaloneQueryRunner(cat, device="cpu", optimizer="legacy")
    iterative = StandaloneQueryRunner(cat, device="cpu")
    if legacy.create_plan(QUERIES[q]) == iterative.create_plan(QUERIES[q]):
        return
    with result_cache.disabled():
        a = sorted(legacy.execute(QUERIES[q]).rows(), key=repr)
        b = sorted(iterative.execute(QUERIES[q]).rows(), key=repr)
    assert a == b


# -------------------------------------------------- parity: fingerprints


def _node_fps(mod, root, resolve=None):
    out = []

    def walk(n):
        out.append((type(n).__name__, mod.logical_fingerprint(n, resolve)))
        for c in n.children:
            walk(c)

    walk(root)
    return out


def _frag_fps(mod, subplan):
    frags = subplan.all_fragments()
    fps = mod.fragment_fingerprints(frags)
    per_node = [_node_fps(mod, f.root, lambda fid: fps[fid]) for f in frags]
    return fps, per_node


@pytest.mark.parametrize("name,sql", CASES, ids=[n for n, _ in CASES])
def test_fingerprints_match_reference(name, sql, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_HBO", "0")
    port = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    ref = RefStandalone(ref_catalog(scale_factor=SF))
    got, want = port.create_plan(sql), ref.create_plan(sql)
    assert plan_text(got) == ref_text(want)
    assert _node_fps(history, got) == _node_fps(ref_history, want)
    pd = DistributedQueryRunner(default_catalog(SF), worker_count=4,
                                device="cpu",
                                session=Session(node_count=4))
    rd = RefDist(ref_catalog(scale_factor=SF), worker_count=4,
                 session=RefSession(node_count=4))
    assert _frag_fps(history, pd.create_subplan(sql)) == \
        _frag_fps(ref_history, rd.create_subplan(sql))


# ----------------------------------------------------- parity: plan_stats


def _recorded(mod_journal) -> list:
    j = mod_journal.get_journal()
    return [r["nodes"] for r in j.read(events=("plan_stats",))]


def _run_and_record(tmp, which: str, sql: str, workers: int = 4):
    _point_journals(tmp)
    if which == "port":
        r = DistributedQueryRunner(default_catalog(SF), worker_count=workers,
                                   device="cpu",
                                   session=Session(node_count=workers))
        rows = r.execute(sql).rows()
        return rows, _recorded(journal)
    r = RefDist(ref_catalog(scale_factor=SF), worker_count=workers,
                session=RefSession(node_count=workers))
    with ref_result_cache.disabled():
        rows = [tuple(x) for x in r.execute(sql).batch.to_pylist()]
    return rows, _recorded(ref_journal)


@pytest.mark.parametrize("q", [3, 5, 18])
def test_plan_stats_match_reference(journal_env, q):
    """At default knobs (adaptive at auto, the compiled stages on) the
    port records the reference's plan_stats for the same query: the same
    fingerprints with the same rows, bytes, groups and skew."""
    _, got = _run_and_record(journal_env / "p", "port", QUERIES[q])
    _, want = _run_and_record(journal_env / "r", "ref", QUERIES[q])
    assert got == want
    assert len(got) == 1 and got[0]


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_plan_stats_of_either_package_plan_both(journal_env, monkeypatch,
                                                writer):
    """Records written by one package give both packages the same
    second-run plans (the mis-estimate of test_second_run... fixed from
    history), the same epoch and the same fan-out adjustments."""
    monkeypatch.setenv("TRINO_TPU_BROADCAST_ROW_LIMIT", "1000")
    monkeypatch.setenv("TRINO_TPU_FUSED_STAGE", "0")
    sql = _WRONG_SQL
    _run_and_record(journal_env / writer, writer, sql, workers=2)
    # a fresh planner of each package reads the same journal
    journal.reset_for_test()
    ref_journal.reset_for_test()
    _reset_planning_caches()
    assert history.history_epoch() == ref_history.history_epoch() != ""
    pd = DistributedQueryRunner(default_catalog(SF), worker_count=2,
                                device="cpu",
                                session=Session(node_count=2, adaptive="0"))
    rd = RefDist(ref_catalog(scale_factor=SF), worker_count=2,
                 session=RefSession(node_count=2, adaptive="0"))
    got, want = pd.create_subplan(sql), rd.create_subplan(sql)
    assert [plan_text(f.root) for f in got.all_fragments()] == \
        [ref_text(f.root) for f in want.all_fragments()]
    assert _join_plan(pd, sql) == _join_plan(rd, sql)
    assert _join_plan(pd, sql)[0] != "BROADCAST" or \
        "orders" not in _join_plan(pd, sql)[1]
    assert pd.stage_task_counts(got.all_fragments()) == \
        rd.stage_task_counts(want.all_fragments())
    # standalone plans read the history too
    sp = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    sr = RefStandalone(ref_catalog(scale_factor=SF))
    assert plan_text(sp.create_plan(sql)) == ref_text(sr.create_plan(sql))


def test_fanout_adjustments_match_reference(journal_env, monkeypatch):
    monkeypatch.setenv("TRINO_TPU_FUSED_STAGE", "0")
    sql = ("select o_custkey, count(*) c from orders "
           "group by o_custkey order by o_custkey limit 5")
    _point_journals(journal_env / "j")
    r1 = _fresh_distributed(workers=3, sf=SF, use_collectives=False)
    r1.execute(sql)
    journal.reset_for_test()
    ref_journal.reset_for_test()
    _reset_planning_caches()
    pd = _fresh_distributed(workers=3, sf=SF, use_collectives=False)
    rd = RefDist(ref_catalog(scale_factor=SF), worker_count=3,
                 session=RefSession(node_count=3, adaptive="0",
                                    use_collectives=False))
    got = pd.stage_task_counts(pd.create_subplan(sql).all_fragments())
    want = rd.stage_task_counts(rd.create_subplan(sql).all_fragments())
    assert got == want
    assert min(got[0].values()) < 3


# ------------------------------------------- the planner's distribution


@pytest.mark.parametrize("limit", ["1", str(10 ** 9)])
@pytest.mark.parametrize("q", [3, 5, 10])
def test_broadcast_row_limit_gives_reference_distributions(monkeypatch, q,
                                                           limit):
    """``TRINO_TPU_BROADCAST_ROW_LIMIT`` reaches the port's planner: its
    fragmented plans at four workers carry the reference's join
    distributions at either extreme."""
    monkeypatch.setenv("TRINO_TPU_HBO", "0")
    monkeypatch.setenv("TRINO_TPU_BROADCAST_ROW_LIMIT", limit)
    pd = DistributedQueryRunner(default_catalog(SF), worker_count=4,
                                device="cpu", session=Session(node_count=4))
    rd = RefDist(ref_catalog(scale_factor=SF), worker_count=4,
                 session=RefSession(node_count=4))

    def dists(sub):
        return [n.distribution for f in sub.all_fragments()
                for n in _walk(f.root) if type(n).__name__ == "Join"]

    got, want = dists(pd.create_subplan(QUERIES[q])), \
        dists(rd.create_subplan(QUERIES[q]))
    assert got == want
    assert ("PARTITIONED" if limit == "1" else "BROADCAST") in got


@pytest.mark.parametrize("nbytes", [1 << 10, 1 << 30])
def test_history_bytes_branch_matches_reference(journal_env, nbytes):
    """A build side whose history records observed bytes is placed by
    those bytes against the adaptive threshold (32 MiB), whatever its
    row count says."""
    port = StandaloneQueryRunner(default_catalog(SF), device="cpu")
    ref = RefStandalone(ref_catalog(scale_factor=SF))
    build = port.create_plan("select c_custkey from customer")
    rbuild = ref.create_plan("select c_custkey from customer")
    fp = history.logical_fingerprint(build)
    assert fp == ref_history.logical_fingerprint(rbuild)
    journal.get_journal().plan_stats(
        "q", "f", {fp: {"rows": 10, "bytes": nbytes}}, ts=1.0)
    _reset_planning_caches()
    got = port_optimizer._choose_distribution(
        build, port.catalog, "INNER", history.provider_if_enabled())
    want = ref_optimizer._choose_distribution(
        rbuild, ref.catalog, "INNER", ref_history.provider_if_enabled())
    assert got == want == ("BROADCAST" if nbytes < (32 << 20)
                           else "PARTITIONED")

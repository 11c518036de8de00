"""The port's adaptive plane (execution/adaptive.py) against the reference.

The reference's tests/test_adaptive.py cases run through both packages'
``DistributedQueryRunner`` at SF 0.01 with the same session: the same
decision tags (``keep`` / ``flip_to_broadcast`` / ``flip_to_partitioned``
/ ``skew_split``), the same counters and the same rows (exact; the sums
are decimals).  Then the parts the port had to redesign for the device:
the heavy-hitter sketch fed int64-held hash bits gives the reference's
``counts`` and ``total`` on seeded streams (hashes with the top bit set,
count ties at the pruning edge); the router's lanes are the static
sink's, and with a split map they are the reference router's; flips,
keeps and splits equal the reference's over the chaos query mix; the
``adaptive:`` EXPLAIN ANALYZE line is the reference's.  The reference is
pinned as ROADMAP "Pinning the reference" says, with the fused stages off
(``plain_exchanges``, as the reference's test does).
"""

import numpy as np
import pytest
import torch

from test_torch_distributed import _same
from trino_tpu.caching import result_cache as ref_result_cache
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.execution import adaptive as RA
from trino_tpu.execution.distributed_runner import (
    DistributedQueryRunner as RefDist)
from trino_tpu.execution.exchange import OutputBuffer as RefBuffer
from trino_tpu.runner import Session as RefSession
from trino_tpu.spi.batch import Column as RefColumn
from trino_tpu.spi.batch import ColumnBatch as RefBatch
from trino_tpu.telemetry import runtime as ref_rt
from trino_tpu_torch.caching import result_cache
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.execution import adaptive as PA
from trino_tpu_torch.execution import distributed_runner as PDR
from trino_tpu_torch.execution.distributed_runner import (
    DistributedQueryRunner)
from trino_tpu_torch.execution.exchange import OutputBuffer
from trino_tpu_torch.execution.task import PartitionedOutputSink
from trino_tpu_torch.runner import Session
from trino_tpu_torch.spi.batch import Column, ColumnBatch
from trino_tpu_torch.spi.types import BIGINT, DOUBLE
from trino_tpu_torch.telemetry import metrics as tm
from trino_tpu_torch.telemetry import runtime as rt
from trino_tpu_torch.testing.chaos import QUERY_MIX

SF = 0.01
PINS = (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
        ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
        ("TRINO_TPU_OPTIMIZER", "iterative"))

JOIN_SQL = ("select c.c_mktsegment, count(*) n, sum(o.o_totalprice) s "
            "from orders o join customer c on o.o_custkey = c.c_custkey "
            "group by c.c_mktsegment order by 1")
SKEW_SQL = ("select count(*) n, sum(p.o_totalprice + b.c_acctbal) s "
            "from (select case when o_orderkey % 2 = 0 then 1 "
            "             else o_custkey end as k, o_totalprice "
            "      from orders) p "
            "join (select c_custkey, c_acctbal from customer) b "
            "on p.k = b.c_custkey")


@pytest.fixture(autouse=True)
def _pin(monkeypatch):
    for k, v in PINS:
        monkeypatch.setenv(k, v)
    PA.reset_memo_for_test()
    RA.reset_memo_for_test()
    with result_cache.disabled(), ref_result_cache.disabled():
        yield
    PA.reset_memo_for_test()
    RA.reset_memo_for_test()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def plain_exchanges(monkeypatch):
    """Decision sites need plain buffer edges (as in the reference's
    test): the fused seams are off in both packages."""
    monkeypatch.setenv("TRINO_TPU_FUSED_STAGE", "0")


def _pair(**kw):
    port = DistributedQueryRunner(default_catalog(SF), worker_count=3,
                                  device="cpu",
                                  session=Session(node_count=3, **kw))
    ref = RefDist(ref_catalog(scale_factor=SF), worker_count=3,
                  session=RefSession(node_count=3, **kw))
    return port, ref


def _run(port, ref, sql, ordered=True):
    got = port.execute(sql).rows()
    pdec = rt.queries()[-1].adaptive_decisions
    want = ref.execute(sql).batch.to_pylist()
    rdec = ref_rt.queries()[-1].adaptive_decisions
    _same(got, [tuple(r) for r in want], ordered)
    return pdec, rdec


# ------------------------------------------------------- the reference's
def test_mode_and_threshold_knobs(monkeypatch):
    for mod, S in ((PA, Session), (RA, RefSession)):
        assert mod.adaptive_mode(S(adaptive="0")) == "0"
        assert mod.adaptive_mode(S(adaptive=1)) == "1"
        assert mod.adaptive_mode(S(adaptive="AUTO")) == "auto"
        monkeypatch.setenv("TRINO_TPU_ADAPTIVE", "off")
        assert mod.adaptive_mode(S()) == "0"
        monkeypatch.delenv("TRINO_TPU_ADAPTIVE")
        assert mod.adaptive_mode(S()) == "auto"
        assert mod.broadcast_threshold_bytes(S()) == 32 << 20
        assert mod.broadcast_threshold_bytes(
            S(broadcast_threshold_bytes=7)) == 7
        monkeypatch.setenv("TRINO_TPU_SKEW_FACTOR", "3.5")
        assert mod.skew_factor(S()) == 3.5
        assert mod.skew_factor(S(skew_factor=1.1)) == 1.1
        monkeypatch.delenv("TRINO_TPU_SKEW_FACTOR")


def test_heavy_hitter_sketch_counts_merges_and_prunes():
    s = PA.HeavyHitterSketch(k=4)
    s.update(torch.tensor([1, 1, 1, 2, 3]))
    s.update(torch.tensor([1, 2]))
    assert s.total == 7
    assert s.counts[1] == 4 and s.counts[2] == 2
    t = PA.HeavyHitterSketch(k=4)
    t.update(torch.tensor([1, 9]))
    s.merge(t)
    assert s.total == 9 and s.counts[1] == 5
    assert set(s.heavy(1.0, 2).keys()) == {1}
    assert s.heavy(1.5, 2) == {}
    assert s.heavy(0.5, 1) == {}
    big = PA.HeavyHitterSketch(k=2)
    for v in range(40):
        big.update(torch.full((v + 1,), v, dtype=torch.int64))
    assert len(big.counts) <= 8
    assert big.total == sum(range(1, 41))
    assert 39 in big.counts


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def test_split_probe_fragment_plan_shape():
    from trino_tpu_torch.execution.fragmenter import split_probe_fragment
    from trino_tpu_torch.planner.plan import Join, RemoteSource, plan_text

    port, ref = _pair()
    got = port.create_subplan(JOIN_SQL)
    frags = got.all_fragments()
    consumer = next(f for f in frags
                    if any(isinstance(n, Join) for n in _walk(f.root)))
    join = next(n for n in _walk(consumer.root) if isinstance(n, Join))
    assert join.distribution == "BROADCAST"
    old_sources = list(consumer.source_fragments)
    new_fid = max(f.id for f in frags) + 1
    new_frag = split_probe_fragment(consumer, join, new_fid)
    assert new_frag.output_kind == "REPARTITION"
    assert new_frag.output_keys == tuple(join.left_keys)
    new_join = next(n for n in _walk(consumer.root) if isinstance(n, Join))
    assert new_join.distribution == "PARTITIONED"
    assert isinstance(new_join.left, RemoteSource)
    assert new_join.left.fragment_id == new_fid
    assert new_fid in consumer.source_fragments
    assert set(new_frag.source_fragments) <= set(old_sources)
    # the reference's split of the same plan gives the same text
    from trino_tpu.execution.fragmenter import (
        split_probe_fragment as ref_split)
    from trino_tpu.planner.plan import Join as RJ
    from trino_tpu.planner.plan import plan_text as ref_text

    rfr = ref.create_subplan(JOIN_SQL).all_fragments()
    rc = next(f for f in rfr if any(isinstance(n, RJ) for n in _walk(f.root)))
    rj = next(n for n in _walk(rc.root) if isinstance(n, RJ))
    rnew = ref_split(rc, rj, new_fid)
    assert plan_text(consumer.root) == ref_text(rc.root)
    assert plan_text(new_frag.root) == ref_text(rnew.root)


def test_flip_to_partitioned_when_build_exceeds_threshold(plain_exchanges):
    before = tm.ADAPTIVE_PARTITION_FLIPS.value()
    port, ref = _pair(adaptive="auto", use_collectives=False,
                      broadcast_threshold_bytes=1000)
    pdec, rdec = _run(port, ref, JOIN_SQL)
    assert "flip_to_partitioned" in pdec and pdec == rdec
    assert tm.ADAPTIVE_PARTITION_FLIPS.value() == before + 1


def test_flip_to_broadcast_when_build_is_small(monkeypatch,
                                               plain_exchanges):
    monkeypatch.setenv("TRINO_TPU_BROADCAST_ROW_LIMIT", "0")  # mis-estimate
    before = tm.ADAPTIVE_BROADCAST_FLIPS.value()
    port, ref = _pair(adaptive="auto", use_collectives=False,
                      broadcast_threshold_bytes=1 << 30)
    pdec, rdec = _run(port, ref, JOIN_SQL)
    assert "flip_to_broadcast" in pdec and pdec == rdec
    assert tm.ADAPTIVE_BROADCAST_FLIPS.value() == before + 1


def test_no_flip_when_stats_agree_with_planner(plain_exchanges):
    before = (tm.ADAPTIVE_BROADCAST_FLIPS.value(),
              tm.ADAPTIVE_PARTITION_FLIPS.value())
    port, ref = _pair(adaptive="auto", use_collectives=False)
    pdec, rdec = _run(port, ref, JOIN_SQL)
    assert pdec == rdec == "keep[f2]"
    assert (tm.ADAPTIVE_BROADCAST_FLIPS.value(),
            tm.ADAPTIVE_PARTITION_FLIPS.value()) == before


def test_skew_split_on_heavy_probe_key(monkeypatch, plain_exchanges):
    monkeypatch.setenv("TRINO_TPU_BROADCAST_ROW_LIMIT", "0")
    before = tm.ADAPTIVE_SKEW_SPLITS.value()
    port, ref = _pair(adaptive="auto", use_collectives=False,
                      broadcast_threshold_bytes=1000, skew_factor=1.2)
    pdec, rdec = _run(port, ref, SKEW_SQL)
    assert "skew_split" in pdec and pdec == rdec
    assert tm.ADAPTIVE_SKEW_SPLITS.value() == before + 1
    assert port.last_adaptive.last_imbalance > 1.0


def test_decision_memo_replays_repeated_shapes(plain_exchanges):
    before = tm.ADAPTIVE_MEMO_HITS.value()
    port, _ = _pair(adaptive="auto", use_collectives=False,
                    broadcast_threshold_bytes=1000)
    a = port.execute(JOIN_SQL).rows()
    b = port.execute(JOIN_SQL).rows()
    assert a == b
    assert tm.ADAPTIVE_MEMO_HITS.value() > before
    assert "flip_to_partitioned" in rt.queries()[-1].adaptive_decisions


def test_adaptive_oracle_identical_to_legacy_across_mix(monkeypatch,
                                                        plain_exchanges):
    """adaptive=1 against adaptive=0 over the chaos mix and the drills,
    and each decision list against the reference's (the mix's flips,
    keeps and splits)."""
    monkeypatch.setenv("TRINO_TPU_BROADCAST_ROW_LIMIT", "0")
    queries = [QUERY_MIX[0], QUERY_MIX[4], QUERY_MIX[5], JOIN_SQL, SKEW_SQL]
    on, ref = _pair(adaptive="1", use_collectives=False,
                    broadcast_threshold_bytes=64 << 10, skew_factor=1.2)
    off = DistributedQueryRunner(default_catalog(SF), worker_count=3,
                                 device="cpu",
                                 session=Session(node_count=3, adaptive="0"))
    kinds = set()
    for sql in queries:
        a = on.execute(sql).rows()
        pdec = rt.queries()[-1].adaptive_decisions
        b = off.execute(sql).rows()
        _same(a, b, False)
        want = ref.execute(sql).batch.to_pylist()
        assert pdec == ref_rt.queries()[-1].adaptive_decisions, sql
        _same(a, [tuple(r) for r in want], False)
        kinds |= {t.split("[")[0] for t in pdec.split(",") if t}
    assert "flip_to_broadcast" in kinds


def test_explain_analyze_reports_adaptive_decisions(plain_exchanges):
    port, ref = _pair(adaptive="auto", use_collectives=False,
                      broadcast_threshold_bytes=1000)

    def line(runner, rows):
        txt = [v[0] for v in rows]
        return [t.strip() for t in txt if t.strip().startswith("adaptive:")]

    got = line(port, port.execute("explain analyze " + JOIN_SQL).rows())
    want = line(ref, ref.execute("explain analyze " + JOIN_SQL)
                .batch.to_pylist())
    # the stats block's label, then the counters' line
    assert got == want and len(got) == 2
    assert "flip_to_partitioned" in got[1]


def test_adaptive_zero_never_builds_the_plane(monkeypatch):
    import trino_tpu_torch.execution.distributed_runner as dr

    def boom(*a, **k):
        raise AssertionError("AdaptiveExec constructed under adaptive=0")

    monkeypatch.setattr(dr, "AdaptiveExec", boom)
    port, _ = _pair(adaptive="0")
    assert len(port.execute(JOIN_SQL).rows()) > 0


def test_adaptive_survives_injected_task_failure_with_query_retry(
        plain_exchanges):
    from trino_tpu_torch.execution.failure_injector import (
        TASK_FAILURE, FailureInjector)

    inj = FailureInjector()
    inj.inject(TASK_FAILURE, fragment_id=None, task_index=0, attempt=0,
               times=1)
    port = DistributedQueryRunner(default_catalog(SF), worker_count=2,
                                  device="cpu", session=Session(
        node_count=2, adaptive="auto", use_collectives=False,
        broadcast_threshold_bytes=1000, retry_policy="QUERY",
        retry_initial_delay_s=0.01, failure_injector=inj))
    rows = port.execute(JOIN_SQL).rows()
    assert port.resilience.query_retries >= 1
    ref = RefDist(ref_catalog(scale_factor=SF), worker_count=3,
                  session=RefSession(node_count=3, adaptive="0"))
    _same(rows, [tuple(r) for r in ref.execute(JOIN_SQL).batch.to_pylist()],
          True)


def test_cluster_blacklist_survives_coordinator_restart(tmp_path,
                                                        monkeypatch):
    """Strikes journal through telemetry/journal.py and re-seed
    (TTL-decayed) on the next runner; the reference reads the port's
    strikes from the same journal."""
    from trino_tpu.execution.speculation import (
        ClusterBlacklist as RefBlacklist)
    from trino_tpu.telemetry import journal as ref_journal
    from trino_tpu_torch.execution.speculation import ClusterBlacklist
    from trino_tpu_torch.telemetry import journal

    monkeypatch.setenv("TRINO_TPU_JOURNAL_DIR", str(tmp_path / "journal"))
    monkeypatch.delenv("TRINO_TPU_JOURNAL", raising=False)
    journal.reset_for_test()
    bl = ClusterBlacklist(ttl_s=3600.0, threshold=2.0, persist=True)
    bl.record_failure("worker-1", reason="REMOTE_HOST_GONE", query_id="q_a")
    bl.record_failure("worker-1", reason="REMOTE_TASK_ERROR", query_id="q_b")
    bl.record_failure("worker-2", reason="REMOTE_TASK_ERROR", query_id="q_c")
    assert bl.is_blacklisted("worker-1")
    journal.reset_for_test()
    again = ClusterBlacklist(ttl_s=3600.0, threshold=2.0, persist=True)
    assert again.is_blacklisted("worker-1")
    assert again.score("worker-2") == 1.0
    assert not again.is_blacklisted("worker-2")
    ref_journal.reset_for_test()
    theirs = RefBlacklist(ttl_s=3600.0, threshold=2.0, persist=True)
    assert theirs.snapshot() == again.snapshot()
    journal.reset_for_test()
    tiny = ClusterBlacklist(ttl_s=1e-9, threshold=2.0, persist=True)
    assert tiny.score("worker-1") == 0.0
    journal.reset_for_test()
    ref_journal.reset_for_test()


def test_nonblocking_sink_refuses_input_instead_of_blocking():
    import time

    buf = OutputBuffer(1, max_bytes=64)
    sink = PartitionedOutputSink(buf, "GATHER")
    sink.blocking = False
    batch = ColumnBatch(["x"], [Column(BIGINT, torch.arange(64))])
    assert sink.needs_input()
    t0 = time.monotonic()
    sink.add_input(batch)
    sink.add_input(batch)
    assert time.monotonic() - t0 < 1.0
    assert not buf.has_capacity()
    assert not sink.needs_input()
    pages, token, _ = buf.get(0, 0, timeout=0.1)
    buf.get(0, token, timeout=0.1)
    assert sink.needs_input()


def test_time_sharing_query_with_tiny_sink_cap(monkeypatch):
    monkeypatch.setattr(PDR, "SINK_MAX_BYTES", 1 << 20)
    monkeypatch.setenv("TRINO_TPU_SINK_MAX_BYTES", str(1 << 20))  # reference
    port, ref = _pair(task_scheduler="TIME_SHARING", executor_workers=2)
    got = port.execute(JOIN_SQL).rows()
    _same(got, [tuple(r) for r in ref.execute(JOIN_SQL).batch.to_pylist()],
          True)


# ------------------------------------------------- the device redesigns
def _streams(seed: int):
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, 2**64, size=40, dtype=np.uint64)
    hot[:20] |= np.uint64(1 << 63)  # the top bit set: negative as int64
    out = []
    for _ in range(6):
        n = int(rng.integers(50, 400))
        # many keys of equal count, so the pruning's ties decide
        out.append(rng.choice(hot, size=n))
    out.append(np.repeat(hot[:16], 3))  # exact ties at the pruning edge
    return out


@pytest.mark.parametrize("seed,k", [(0, 4), (1, 4), (2, 8), (3, 2)])
def test_sketch_counts_and_total_match_reference(seed, k):
    mine, theirs = PA.HeavyHitterSketch(k), RA.HeavyHitterSketch(k)
    for h in _streams(seed):
        mine.update(torch.from_numpy(h.view(np.int64)))
        theirs.update(h)
        assert mine.total == theirs.total
        assert list(mine.counts.items()) == list(theirs.counts.items())
    # merge order and its pruning too
    a, b = PA.HeavyHitterSketch(k), RA.HeavyHitterSketch(k)
    a.merge(mine)
    b.merge(theirs)
    a.merge(mine)
    b.merge(theirs)
    assert list(a.counts.items()) == list(b.counts.items())
    assert a.heavy(1.2, 3) == b.heavy(1.2, 3)
    split_p = PA.AdaptiveExec._split_map(
        type("S", (), {"skew": 1.2})(), a, 3)
    split_r = RA.AdaptiveExec._split_map(
        type("S", (), {"skew": 1.2})(), b, 3)
    assert {h: v.tolist() for h, v in split_p.items()} == \
        {h: v.tolist() for h, v in split_r.items()}
    if split_p:
        assert PA._imbalance_ratio(a, split_p, 3) == \
            RA._imbalance_ratio(b, split_r, 3)


def _batches(seed: int, n: int = 3000):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 50, size=n).astype(np.int64)
    k[: n // 3] = 7  # a heavy key
    v = rng.standard_normal(n)
    port = ColumnBatch(["k", "v"], [Column(BIGINT, torch.from_numpy(k)),
                                    Column(DOUBLE, torch.from_numpy(v))])
    from trino_tpu.spi.types import BIGINT as RB
    from trino_tpu.spi.types import DOUBLE as RD

    ref = RefBatch(["k", "v"], [RefColumn(RB, k), RefColumn(RD, v)])
    return port, ref


def _drain(buf, n):
    out = []
    for p in range(n):
        rows, token = [], 0
        while True:
            pages, token, done = buf.get(p, token, timeout=0.1)
            for pg in pages:
                rows.extend(tuple(r) for r in pg.to_pylist())
            if done and not pages:
                break
        out.append(rows)
    return out


def test_router_lanes_equal_the_static_sink():
    """A kept decision routes each row to the lane the static REPARTITION
    sink gives it, in the same order."""
    n = 3
    batch, _ = _batches(5)
    static = OutputBuffer(n)
    sink = PartitionedOutputSink(static, "REPARTITION", [0])
    sink.add_input(batch)
    sink.finish_input()
    staging = OutputBuffer(1)
    staging.enqueue(0, batch)
    staging.set_finished()
    routed = OutputBuffer(n)
    r = PA._Router("t", [staging], routed, n, "hash", keys=(0,))
    r.run()
    assert _drain(routed, n) == _drain(static, n)


@pytest.mark.parametrize("replicate", [False, True])
def test_router_split_equals_reference(replicate):
    """With a heavy-key split map the port's router sends each row (probe
    scatter) or each replica (build) to the reference router's target,
    in the reference's order."""
    from trino_tpu.exec import kernels as RK
    from trino_tpu.execution.task import _partition_key_tuple

    n = 3
    port_b, ref_b = _batches(9)
    hv = int(RK.partition_key_hashes(
        [_partition_key_tuple(ref_b.columns[0])])[0])
    split = {hv: np.array([hv % n, (hv + 1) % n], dtype=np.int32)}
    outs = []
    for mod, B, batch in ((PA, OutputBuffer, port_b), (RA, RefBuffer, ref_b)):
        staging = B(1)
        staging.enqueue(0, batch)
        staging.enqueue(0, batch)  # the scatter cursor carries over
        staging.set_finished()
        routed = B(n)
        mod._Router("t", [staging], routed, n, "hash", keys=(0,),
                    split=split, replicate=replicate).run()
        outs.append(_drain(routed, n))
    assert outs[0] == outs[1]

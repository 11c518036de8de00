"""Host-sync accounting and the sync-free probe of the port, against the
reference.

The single-node cases of tests/test_sync_free.py run against the port:
SyncGuard's counters, forbidden mode and text line (held to the
reference's own module on the same calls), the padded expand of
exec/join_exec.py (provable and estimated buckets, the overflow flag and
its retry, pair sets against a numpy nested loop; the reference's
``kernels.probe_join_table`` cases become pair-set checks of the port's
expand, which has no such legacy entry), the bucket planners and the
OverflowQueue, a steady-state probe loop that makes no blocking sync in a
hot region, query equivalence with the pinned reference at SF 0.01 and the
EXPLAIN ANALYZE sync line.  A lint over ``trino_tpu_torch/exec/`` finds no
raw host read outside syncguard.py.  The port runs on the CPU, where an
AsyncScalar is always ready; the card's readiness is tests/test_torch_gpu.py's.
"""

import numpy as np
import pytest
import torch

import trino_tpu.exec.syncguard as RSG
from test_torch_queries import _same_rows
from trino_tpu.connectors.catalog import default_catalog as ref_catalog
from trino_tpu.runner import StandaloneQueryRunner as RefRunner
from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.exec import join_exec as JX
from trino_tpu_torch.exec import kernels as K
from trino_tpu_torch.exec import syncguard as SG
from trino_tpu_torch.exec.operators import (JoinBridge, JoinBuildSink,
                                            LookupJoinOperator,
                                            SemiJoinOperator)
from trino_tpu_torch.runner import StandaloneQueryRunner
from trino_tpu_torch.spi.batch import Column, ColumnBatch
from trino_tpu_torch.spi.types import BIGINT, BOOLEAN
from trino_tpu_torch.tools import lint_host_sync

SF = 0.01


@pytest.fixture(autouse=True)
def _pin(monkeypatch):
    for k, v in (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0"),
                 ("TRINO_TPU_RESULT_CACHE", "0"), ("TRINO_TPU_HBO", "0"),
                 ("TRINO_TPU_OPTIMIZER", "iterative")):
        monkeypatch.setenv(k, v)


# ---------------------------------------------------------------------------
# SyncGuard itself, call for call against the reference's module


def _drive(mod, hot_blocking: bool):
    """The same sequence of calls through either package's SyncGuard."""
    before = mod.snapshot()
    mod.count_sync("a.tag")
    mod.count_sync("b.tag", blocking=False)
    with mod.hot_region():
        if hot_blocking:
            mod.count_sync("c.hot")
    mod.count_overflow()
    mod.count_overflow(retried=False)
    return mod.take_delta(before)


@pytest.mark.parametrize("hot", [False, True])
def test_counters_and_text_match_reference(hot):
    got, want = _drive(SG, hot), _drive(RSG, hot)
    assert got.text() == want.text()
    assert got.by_tag == want.by_tag
    assert (got.host_syncs, got.blocking_syncs, got.hot_loop_syncs,
            got.expand_overflows, got.expand_retries) == (
        want.host_syncs, want.blocking_syncs, want.hot_loop_syncs,
        want.expand_overflows, want.expand_retries)


def test_stats_merge_and_text_line():
    a = SG.SyncStats(host_syncs=3, blocking_syncs=2, by_tag={"x": 2})
    a.merge(SG.SyncStats(host_syncs=1, async_polls=4, poll_hits=3,
                         by_tag={"x": 1, "y": 1}))
    assert a.text() == ("exec: 4 host syncs (2 blocking, 0 in hot loops), "
                        "3/4 async polls ready, expand overflow 0/retry 0 "
                        "[x=3 y=1]")


def test_forbidden_raises_inside_hot_region():
    with SG.forbidden():
        with SG.hot_region():
            with pytest.raises(SG.SyncViolation):
                SG.count_sync("test.tag", blocking=True)
            with pytest.raises(SG.SyncViolation):
                SG.fetch(torch.arange(3).sum(), "test.fetch")
        # outside the hot region the same sync is fine
        SG.count_sync("test.tag", blocking=True)
    # non-blocking polls never violate
    with SG.forbidden(), SG.hot_region():
        h = SG.async_scalar(torch.tensor(1), "test.poll")
        assert h.ready() and int(h.get_if_ready()) == 1
        assert int(h.get()) == 1


def test_fetch_and_async_scalar_on_the_cpu():
    before = SG.snapshot()
    v = SG.fetch([torch.tensor([1, 2]), None, torch.tensor(True)], "t.f")
    assert v[0].tolist() == [1, 2] and v[1] is None and bool(v[2])
    SG.fetch(np.int64(3), "t.host")  # a host value never blocks
    h = SG.async_scalar(torch.tensor(7), "t.a")
    assert h.get() == 7
    d = SG.take_delta(before)
    assert (d.host_syncs, d.blocking_syncs, d.async_polls,
            d.poll_hits) == (2, 1, 1, 1)
    assert d.by_tag == {"t.f": 1, "t.host": 1}


# ---------------------------------------------------------------------------
# the padded expand


def _keys(arr, valid=None):
    return [(torch.as_tensor(arr),
             None if valid is None else torch.as_tensor(valid))]


def _expected_pairs(build, probe, bvalid=None, pvalid=None):
    out = set()
    for p, pv in enumerate(probe):
        if pvalid is not None and not pvalid[p]:
            continue
        for b, bv in enumerate(build):
            if bvalid is not None and not bvalid[b]:
                continue
            if pv == bv:
                out.add((p, b))
    return out


def _pairs_at(table, keys, cap, total=None):
    """(probe row, build row) pairs of the expand at ``cap``, its ok mask
    and overflow flag.  The probe column carries row numbers."""
    lo, counts, total_a = JX.probe_ranges_device(table, keys, [None])
    rows = torch.arange(keys[0][0].shape[0])
    pairs, ok, _, _, bid, overflow = JX.run_pairs(
        table, lo, counts, total_a if total is None else total, keys,
        [None], [(rows, None)], [(table.key_datas[0], None)], cap=cap)
    got = set(zip(pairs[0][0][ok].tolist(), bid[ok].tolist()))
    return got, ok, overflow


def test_expand_heavy_duplicates_and_nulls():
    rng = np.random.default_rng(3)
    build = rng.integers(0, 50, size=300).astype(np.int64)  # heavy dups
    bvalid = rng.random(300) > 0.1
    probe = rng.integers(0, 60, size=257).astype(np.int64)  # some miss
    pvalid = rng.random(257) > 0.1
    table = JX.build_table(_keys(build, bvalid))
    keys = _keys(probe, pvalid)
    want = _expected_pairs(build, probe, bvalid, pvalid)
    cap, provable = JX.ExpandPlanner().plan(len(probe), table.max_run)
    got, _, overflow = _pairs_at(table, keys, cap)
    if provable:
        assert not bool(overflow)
    if not bool(overflow):
        assert got == want
    exact = int(JX.probe_ranges_device(table, keys, [None])[2].get())
    assert exact == len(want)
    got, _, overflow = _pairs_at(table, keys, None, total=exact)
    assert got == want and not bool(overflow)


def test_expand_zero_match_and_empty_probe():
    table = JX.build_table(_keys(np.arange(10, dtype=np.int64)))
    got, ok, overflow = _pairs_at(table, _keys(np.array([100, 200])), 8)
    assert got == set() and not bool(ok.any()) and not bool(overflow)
    lo, counts, total = JX.probe_ranges_device(
        table, _keys(np.empty(0, np.int64)), [None])
    assert int(total.get()) == 0 and lo.shape == (0,)


@pytest.mark.parametrize("cap_factor", [0.5, 1.0, 3.0])
def test_lane_rows_equal_a_binary_search(cap_factor):
    """Each lane's probe row from scans and scatters equals the binary
    search of the lane in the runs' ends, for lanes under the total (a
    truncating cap included)."""
    counts = torch.from_numpy(
        np.random.default_rng(4).integers(0, 4, 500) *
        (np.random.default_rng(5).random(500) < 0.6))
    total = int(counts.sum())
    cap = K.bucket(max(int(total * cap_factor), 1))
    ends = torch.cumsum(counts, 0)
    got = JX._lane_rows(counts, ends - counts, cap)
    want = torch.searchsorted(ends, torch.arange(cap), right=True)
    real = torch.arange(cap) < total
    assert torch.equal(got[real], want[real])
    assert bool((got >= 0).all() and (got < 500).all())


def test_run_pairs_provable_cap_matches_exact_total():
    rng = np.random.default_rng(11)
    # dup runs of 2 keep bucket(n_probe * max_run) within PROVABLE_SLACK of
    # the probe width: the planner proves the cap, the flag stays down
    build = np.repeat(np.arange(50, dtype=np.int64), 2)
    probe = rng.integers(0, 60, size=128).astype(np.int64)
    table = JX.build_table(_keys(build))
    keys = _keys(probe)
    exact = int(JX.probe_ranges_device(table, keys, [None])[2].get())
    legacy, _, _ = _pairs_at(table, keys, None, total=exact)
    cap, provable = JX.ExpandPlanner().plan(len(probe), table.max_run)
    assert provable and table.max_run == 2
    got, _, overflow = _pairs_at(table, keys, cap)
    assert not bool(overflow)
    assert got == legacy == _expected_pairs(build, probe)


def test_run_pairs_overflow_flag_and_retry():
    build = np.repeat(np.arange(4, dtype=np.int64), 32)  # runs of 32
    probe = np.arange(4, dtype=np.int64)  # total = 4 * 32 = 128
    table = JX.build_table(_keys(build))
    keys = _keys(probe)
    truncated, ok, overflow = _pairs_at(table, keys, 16)
    assert bool(overflow)  # 128 candidates > 16 lanes: flagged
    assert len(truncated) == int(ok.sum()) == 16
    total = int(JX.probe_ranges_device(table, keys, [None])[2].get())
    assert total == 128
    got, ok, overflow = _pairs_at(table, keys, K.bucket(total))
    assert not bool(overflow) and int(ok.sum()) == 128
    assert {b for _, b in got} == set(range(len(build)))


# ---------------------------------------------------------------------------
# capacity planning and the deferred commits


def test_planner_provable_for_unique_build():
    cap, provable = JX.ExpandPlanner().plan(1024, max_run=1)
    assert provable and cap == 1024


def test_planner_estimates_then_crosses_bound():
    p = JX.ExpandPlanner()
    # bound = 16 * 1000 lanes >> PROVABLE_SLACK * bucket(16): not provable,
    # the first estimate falls back to the probe width
    cap, provable = p.plan(16, max_run=1000)
    assert not provable and cap == K.bucket(16)
    # a landed total pushes the estimate past the provable bound: the
    # planner snaps to the bound
    p.observe(16000)
    cap, provable = p.plan(16, max_run=1000)
    assert provable and cap == K.bucket(16 * 1000)


def test_planner_prefers_a_tighter_landed_estimate():
    """Padded lanes are device work: once a total has landed, an estimate
    below the provable bound wins (the overflow flag guards it)."""
    p = JX.ExpandPlanner()
    assert p.plan(1024, max_run=2) == (2048, True)  # nothing landed yet
    p.observe(500)
    assert p.plan(1024, max_run=2) == (K.bucket(500 * JX.EST_HEADROOM),
                                       False)
    p.observe(1500)  # the estimate reaches the bound: provable again
    assert p.plan(1024, max_run=2) == (2048, True)
    # with nothing landed, a loose bound gives way to the probe width
    assert JX.ExpandPlanner().plan(1024, max_run=7) == (1024, False)


def test_planner_unknown_max_run_never_provable():
    cap, provable = JX.ExpandPlanner().plan(64, max_run=None)
    assert not provable and cap == K.bucket(64)


def test_planner_reads_landed_totals_and_seeds():
    JX.reset_estimate_seeds()
    p = JX.ExpandPlanner(key=("t",))
    p.observe_async(SG.async_scalar(torch.tensor(300), "t"))
    assert p.recent_max() == 300  # a CPU value has always landed
    cap, provable = p.plan(16, max_run=1000)
    assert cap == K.bucket(300 * JX.EST_HEADROOM) and not provable
    # a fresh planner of the same shape starts from the seed
    assert JX.ExpandPlanner(key=("t",)).recent_max() == 300


def test_single_batch_probe_seeds_the_next_run():
    """A probe of one batch never plans a second: its total lands in the
    seed store at the probe's end, so the next run of the plan sizes its
    bucket from it instead of the loose provable cap."""
    JX.reset_estimate_seeds()
    build_keys = np.repeat(np.arange(300, dtype=np.int64), 7)
    pk, _, b = _probe_batch(1, 500, n=1 << 12)  # 60 % of the keys match
    want = int(np.isin(pk, build_keys).sum()) * 7
    overflows = []
    for _ in range(2):
        op = LookupJoinOperator(_build(build_keys, build_keys), [0],
                                "INNER", None, ["pk", "pv", "bk", "bv"],
                                [BIGINT] * 4)
        before = SG.snapshot()
        op.add_input(b)
        op.finish_input()
        out = _drain(op)
        overflows.append(SG.take_delta(before).expand_overflows)
        assert _live_rows(out) == want and out[0].num_rows == K.bucket(want)
    # cold: the probe width (4,096 lanes) overflows and re-runs at the
    # exact total; warm: the seed sizes the bucket, no overflow
    assert want > 4096 and overflows == [1, 0]


def test_plan_unique_cap():
    assert JX.plan_unique_cap(1024, 10) == K.bucket(10)  # sparse: compact
    assert JX.plan_unique_cap(1024, 800) is None  # dense: stay wide
    assert JX.plan_unique_cap(1024, None) is None  # unknown: stay wide


def _flag(v: bool):
    return SG.async_scalar(torch.tensor(v), "t")


def test_overflow_queue_commits_in_order_and_retries():
    q = JX.OverflowQueue()
    committed, retried = [], []

    def entry(i, overflow):
        def retry():
            retried.append(i)
            return f"retry-{i}"

        q.push(_flag(overflow), f"spec-{i}", retry, committed.append)

    before = SG.snapshot()
    entry(0, False)
    entry(1, True)  # truncated: re-run, never commit the speculation
    entry(2, False)
    q.drain(block=True)
    assert committed == ["spec-0", "retry-1", "spec-2"]
    assert retried == [1]
    assert SG.take_delta(before).expand_retries == 1
    assert len(q) == 0


def test_overflow_queue_blocks_past_max_inflight():
    q = JX.OverflowQueue()
    committed = []

    class Pending:  # a flag whose copy never lands until waited for
        def get_if_ready(self):
            return None

        def get(self):
            return False

    for i in range(JX.MAX_INFLIGHT + 2):
        q.push(Pending(), i, lambda: None, committed.append)
        q.drain()
        assert len(q) <= JX.MAX_INFLIGHT  # backpressure bound
    q.drain(block=True)
    assert committed == list(range(JX.MAX_INFLIGHT + 2))


def test_overflow_queue_submit_keeps_order():
    q = JX.OverflowQueue()
    committed = []

    class Pending:
        landed = False

        def get_if_ready(self):
            return False if self.landed else None

        def get(self):
            return False

    h = Pending()
    q.submit(h, "est", None, committed.append)
    q.submit(None, "sure", None, committed.append)  # queued behind "est"
    assert committed == [] and len(q) == 2
    h.landed = True
    q.drain()
    assert committed == ["est", "sure"]
    q.submit(None, "now", None, committed.append)  # nothing waits: at once
    assert committed[-1] == "now" and len(q) == 0


# ---------------------------------------------------------------------------
# steady-state probe loops: no blocking sync in a hot region


def _build(keys, vals):
    bridge = JoinBridge()
    sink = JoinBuildSink(bridge, [0], [BIGINT, BIGINT], ["bk", "bv"], "cpu")
    sink.add_input(ColumnBatch(["bk", "bv"], [Column(BIGINT, keys),
                                              Column(BIGINT, vals)]))
    sink.finish_input()
    return bridge


def _probe_batch(seed, hi, n=1024, live=False):
    r = np.random.default_rng(seed)
    pk = r.integers(0, hi, size=n).astype(np.int64)
    lv = torch.from_numpy(r.random(n) < 0.7) if live else None
    return pk, lv, ColumnBatch(["pk", "pv"], [Column(BIGINT, pk),
                                              Column(BIGINT, pk)], lv)


def _drain(op) -> list:
    out = []
    while (b := op.get_output()) is not None:
        out.append(b)
    return out


def _live_rows(batches) -> int:
    return sum(b.num_rows if b.live is None else int(b.live.sum())
               for b in batches)


@pytest.mark.parametrize("dups", [32, 1])
def test_lookup_join_steady_state_zero_hot_syncs(dups):
    """After warm-up, probe batches flow through LookupJoinOperator with
    no blocking sync in a hot region: forbidden mode raises on any, and
    the tally stays 0.  ``dups`` 32 takes the padded expand (a provable
    bucket), 1 the unique probe of a selective join (about 5 % of the rows
    match), compacted once the first batches' counts landed."""
    rng = np.random.default_rng(5)
    build_keys = np.repeat(np.arange(100 * 32 // dups, dtype=np.int64),
                           dups)
    nb = len(build_keys)
    bridge = _build(build_keys, rng.integers(0, 1000, size=nb))
    op = LookupJoinOperator(bridge, [0], "INNER", None,
                            ["pk", "pv", "bk", "bv"], [BIGINT] * 4)
    hi = (build_keys.max() + 10) * (20 if dups == 1 else 1)
    hits = np.bincount(build_keys, minlength=hi)
    expected = total = 0
    widths = set()
    for seed in range(8):
        pk, lv, b = _probe_batch(seed, hi, live=seed % 2 == 1)
        keep = np.ones(len(pk), bool) if lv is None else lv.numpy()
        expected += int(hits[pk[keep]].sum())
        if seed < 3:  # warm-up: planners converge
            op.add_input(b)
            total += _live_rows(_drain(op))
            continue
        before = SG.snapshot()
        with SG.forbidden():
            op.add_input(b)
            out = _drain(op)
        assert SG.take_delta(before).hot_loop_syncs == 0
        total += _live_rows(out)
        widths |= {o.num_rows for o in out}
    op.finish_input()
    while not op.is_finished():
        total += _live_rows([b] if (b := op.get_output()) is not None
                            else [])
    assert total == expected
    if dups > 1:
        assert op.expand_batches == 8
    else:  # compacted: narrower than the probe batches
        assert max(widths) < 1024


def test_semi_join_steady_state_zero_hot_syncs():
    rng = np.random.default_rng(6)
    build_keys = np.repeat(np.arange(0, 200, 2, dtype=np.int64), 8)
    bridge = _build(build_keys, rng.integers(0, 9, size=len(build_keys)))
    op = SemiJoinOperator(bridge, [0], False, None, ["pk", "pv", "m"],
                          [BIGINT, BIGINT, BOOLEAN])
    for seed in range(6):
        pk, _, b = _probe_batch(seed, 220)
        ctx = SG.forbidden() if seed >= 2 else _nothing()
        before = SG.snapshot()
        with ctx:
            op.add_input(b)
            (out,) = _drain(op)
        assert SG.take_delta(before).hot_loop_syncs == 0
        want = np.isin(pk, build_keys)
        np.testing.assert_array_equal(out.columns[2].data.numpy(), want)


def test_compacting_probe_keeps_lazy_payload_lazy():
    """A selective unique probe compacts its batches; a LAZY payload
    column of the probe stays LAZY through the compaction and reads the
    matched rows when something reads it."""
    bridge = _build(np.arange(100, dtype=np.int64) * 40,
                    np.arange(100, dtype=np.int64))
    op = LookupJoinOperator(bridge, [0], "INNER", None,
                            ["pk", "pv", "bk", "bv"], [BIGINT] * 4)
    reads = []
    for seed in range(4):
        pk = np.random.default_rng(seed).integers(0, 4000, 1024)

        def thunk(pk=pk):
            reads.append(1)
            return pk * 10, None

        op.add_input(ColumnBatch(["pk", "pv"], [
            Column(BIGINT, pk),
            Column.lazy(BIGINT, len(pk), thunk, device="cpu")]))
        (out,) = _drain(op)
    assert out.num_rows < 1024 and out.columns[1].encoding == "LAZY"
    assert len(reads) == 0
    live = out.live.numpy()
    keys = out.columns[0].data.numpy()[live]
    np.testing.assert_array_equal(out.columns[1].data.numpy()[live],
                                  keys * 10)
    assert len(reads) == 1 and sorted(keys % 40) == [0] * len(keys)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_hot_fetch_is_counted_and_raises_under_forbidden():
    before = SG.snapshot()
    with SG.hot_region():
        SG.fetch(torch.tensor(1), "t.hot")
    assert SG.take_delta(before).hot_loop_syncs == 1
    with SG.forbidden(), SG.hot_region(), pytest.raises(SG.SyncViolation):
        SG.fetch(torch.tensor(1), "t.hot")


# ---------------------------------------------------------------------------
# query level


@pytest.fixture(scope="module")
def runners():
    return (StandaloneQueryRunner(default_catalog(SF), device="cpu"),
            RefRunner(ref_catalog(scale_factor=SF)))


@pytest.mark.parametrize("sql", [
    "select count(*) from orders o join lineitem l "
    "on o.o_orderkey = l.l_orderkey",
    "select count(*) from nation a join nation b "
    "on a.n_regionkey = b.n_regionkey",
    "select o_orderpriority, count(*) from orders where exists (select * "
    "from lineitem where l_orderkey = o_orderkey and l_commitdate < "
    "l_receiptdate) group by o_orderpriority order by o_orderpriority",
])
def test_query_equivalence_with_reference(runners, sql):
    port, ref = runners
    before = SG.snapshot()
    got = port.execute(sql).rows()
    assert SG.take_delta(before).hot_loop_syncs == 0
    _same_rows(got, ref.execute(sql).rows())


def test_explain_analyze_reports_sync_stats(runners):
    port, ref = runners
    sql = ("explain analyze select count(*) from nation a join nation b "
           "on a.n_regionkey = b.n_regionkey")
    lines = [r[0] for r in port.execute(sql).rows()]
    ref_lines = [str(r[0]) for r in ref.execute(sql).rows()]
    line = next(l for l in lines if "host syncs" in l)
    assert any("host syncs" in l for l in ref_lines)
    assert line.startswith("  exec: ") and " in hot loops), " in line
    assert "join.build=" in line


def test_no_raw_host_reads_in_exec():
    assert lint_host_sync.run() == []
    # the lint sees each spelling it names
    for src in ("n = t.item()", "a = x.cpu()", "v = t.tolist()",
                "n = int(live.sum())", "b = bool((a == b).all())"):
        assert any(p.search(src) for p, _ in lint_host_sync.PATTERNS), src

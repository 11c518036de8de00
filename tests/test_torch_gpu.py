"""CUDA kernels of the torch port against their plain versions, on the card.

These tests need an NVIDIA GPU (the CUDA kernels have no CPU mode) and skip
elsewhere.  The module imports neither JAX nor the reference package, so it
also runs on a machine without them:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from trino_tpu_torch.connectors.catalog import default_catalog
from trino_tpu_torch.connectors.tpch_queries import QUERIES
from trino_tpu_torch.exec import kernels as K
from trino_tpu_torch.ops import gpu_kernels as GK
from trino_tpu_torch.planner import history
from trino_tpu_torch.runner import StandaloneQueryRunner
from trino_tpu_torch.caching import result_cache
from trino_tpu_torch.telemetry import journal


@pytest.fixture(autouse=True)
def _execution_not_cached():
    """Every statement here executes: a result-cache hit would skip the
    launches, syncs and revocations these tests count."""
    with result_cache.disabled():
        yield


def _fresh_journal(monkeypatch, path):
    """Point the query journal, and history's table of it, at ``path``.
    A test that runs one query on two devices gives each leg a journal of
    its own: at the default knobs the first leg's plan_stats would plan
    the second leg's query (a shrunk fan-out, a flipped join)."""
    monkeypatch.setenv("TRINO_TPU_JOURNAL_DIR", str(path))
    journal.reset_for_test()
    history.reset_for_test()


@pytest.fixture(autouse=True)
def _own_journal(monkeypatch, tmp_path):
    """Every test starts from an empty journal of its own, at the default
    knobs (history-based optimization and the adaptive plane on: this
    module runs with ``--noconftest`` on the card)."""
    _fresh_journal(monkeypatch, tmp_path / "journal")
    yield
    journal.reset_for_test()
    history.reset_for_test()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")


def _planes(rng, P, distinct, n):
    vocab = rng.integers(0, 2**32, (P, distinct), dtype=np.uint64).astype(
        np.uint32)
    return torch.from_numpy(np.ascontiguousarray(
        vocab[:, rng.integers(0, distinct, n)]).view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("P,distinct,collide", [
    (2, 50_000, False), (8, 3_000, False), (3, 500, True)])
def test_cuda_kernels_equal_plain_versions(cuda, P, distinct, collide):
    rng = np.random.default_rng(P)
    n = 200_000
    planes = _planes(rng, P, distinct, n)
    h32 = K.slot_hash32(K.hash_combine(list(planes.long())))
    if collide:  # every key starts in one of four slots
        h32 = h32 & 3
    live = torch.from_numpy(rng.random(n) < 0.9)
    S = K.bucket(2 * n)
    want = GK.hash_insert(planes, h32, live, S)
    before = dict(GK.LAUNCHES)
    got = GK.hash_insert(planes.cuda(), h32.cuda(), live.cuda(), S)
    torch.cuda.synchronize()
    assert GK.LAUNCHES["hash_insert"] == before["hash_insert"] + 1
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
    probe = torch.cat([planes[:, :5000], _planes(rng, P, 100, 1000)], 1)
    ph = torch.cat([h32[:5000], K.slot_hash32(
        K.hash_combine(list(probe[:, 5000:].long())))])
    plive = torch.from_numpy(rng.random(6000) < 0.9)
    pg = GK.hash_probe(got[2], got[3], probe.cuda(), ph.cuda(), plive.cuda())
    np.testing.assert_array_equal(
        pg.cpu().numpy(),
        GK.hash_probe(want[2], want[3], probe, ph, plive).numpy())
    assert GK.LAUNCHES["hash_probe"] == before["hash_probe"] + 1


def _by_gid(table, sgid, count):
    """[P, count] planes of the occupied buckets in id order (each id
    0..count-1 in exactly one bucket): layout-free table contents."""
    occ = sgid >= 0
    assert torch.equal(torch.sort(sgid[occ]).values,
                       torch.arange(count, dtype=torch.int32,
                                    device=sgid.device))
    out = torch.zeros((table.shape[0], count), dtype=torch.int32,
                      device=table.device)
    out[:, sgid[occ].long()] = table[:, occ]
    return out


def _hold_insert_to_plain(planes, h32, live, S, probe_rows=4000):
    """CUDA insert vs the plain version on the same card tensors: ids,
    count and each id's planes exact; each table answers both probes."""
    rng = np.random.default_rng(planes.shape[1])
    P, n = planes.shape
    before = dict(GK.LAUNCHES)
    got = GK.hash_insert(planes, h32, live, S)
    torch.cuda.synchronize()
    assert GK.LAUNCHES["hash_insert"] == before["hash_insert"] + 1
    want = GK.hash_insert_plain(planes, h32, live, S)
    assert got[1] == want[1]
    assert torch.equal(got[0], want[0])
    assert torch.equal(_by_gid(got[2], got[3], got[1]),
                       _by_gid(want[2], want[3], want[1]))
    assert torch.equal(got[2][:, got[3] < 0],
                       torch.zeros_like(got[2][:, got[3] < 0]))
    # probe rows: present keys (live or dead) and absent ones
    k = min(n, probe_rows // 2)
    absent = _planes(rng, P, 100, probe_rows - k).cuda()
    pp = torch.cat([planes[:, :k], absent], 1).contiguous()
    ph = torch.cat([h32[:k], K.slot_hash32(
        K.hash_combine(list(absent.long())))]).contiguous()
    for plive in (None, torch.from_numpy(
            rng.random(pp.shape[1]) < 0.8).cuda()):
        expect = GK.hash_probe_plain(want[2], want[3], pp, ph, plive)
        for tp, sg in ((got[2], got[3]), (want[2], want[3])):
            n_probe = GK.LAUNCHES["hash_probe"]
            pg = GK.hash_probe(tp, sg, pp, ph, plive)
            assert GK.LAUNCHES["hash_probe"] == n_probe + 1
            assert torch.equal(pg, expect)
            assert torch.equal(GK.hash_probe_plain(tp, sg, pp, ph, plive),
                               expect)
    torch.cuda.synchronize()
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 255, 257, 100_003, 1_000_000])
@pytest.mark.parametrize("P", [1, 2, 3, 8])
def test_cuda_hash_equals_plain(cuda, n, P):
    rng = np.random.default_rng(n * 10 + P)
    planes = _planes(rng, P, max(1, n // 4), n).cuda()
    h32 = K.slot_hash32(K.hash_combine(list(planes.long()))).contiguous()
    live = torch.from_numpy(rng.random(n) < 0.9).cuda()
    got = _hold_insert_to_plain(planes, h32, live, K.bucket(2 * max(n, 8)))
    if n == 0:
        assert got[1] == 0 and bool((got[3] == -1).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["one_slot", "all_dead", "live_none"])
def test_cuda_hash_edges(cuda, case):
    rng = np.random.default_rng(5)
    n, S = 3000, 8192
    planes = _planes(rng, 3, 700, n).cuda()
    h32 = K.slot_hash32(K.hash_combine(list(planes.long()))).contiguous()
    live = torch.from_numpy(rng.random(n) < 0.9).cuda()
    if case == "one_slot":  # every key starts at the last slot and wraps
        h32 = torch.full((n,), S - 1, dtype=torch.int32, device="cuda")
    elif case == "all_dead":
        live = torch.zeros(n, dtype=torch.bool, device="cuda")
    else:
        live = None
    got = _hold_insert_to_plain(planes, h32, live, S)
    if case == "all_dead":
        assert got[1] == 0 and bool((got[0] == S).all())
        assert bool((got[3] == -1).all())


@pytest.mark.gpu
def test_cuda_hash_q18_shape(cuda):
    # Q18's group-by: 6.0 M lineitem rows by l_orderkey, 1.5 M keys
    rng = np.random.default_rng(18)
    n, keys = 6_000_000, 1_500_000
    k = torch.from_numpy(rng.integers(1, 4 * keys, keys)[
        rng.integers(0, keys, n)]).cuda()
    planes = torch.stack(K.key_planes([(k, None)])).contiguous()
    h32 = K.slot_hash32(K.hash_combine(list(planes.long()))).contiguous()
    got = _hold_insert_to_plain(planes, h32, None, 1 << 24)
    assert got[1] == int(torch.unique(k).numel())


@pytest.mark.gpu
def test_cuda_probe_takes_only_bucket_storage(cuda):
    planes = _planes(np.random.default_rng(1), 2, 100, 1000).cuda()
    h32 = K.slot_hash32(K.hash_combine(list(planes.long()))).contiguous()
    _, _, tp, sg = GK.hash_insert(planes, h32, None, 2048)
    with pytest.raises(ValueError, match="bucket storage"):
        GK.hash_probe(tp.contiguous(), sg.contiguous(), planes, h32)
    with pytest.raises(ValueError, match="contiguous"):
        GK.hash_probe(tp, sg, planes, torch.cat([h32, h32])[::2])
    torch.cuda.synchronize()


def _f64_sums(vals, gid, live, G):
    """float64 sums of the rows that count (live, id in [0, G))."""
    ok = (gid >= 0) & (gid < G)
    if live is not None:
        ok &= live
    return np.bincount(gid[ok], weights=vals[ok].astype(np.float64),
                       minlength=G)[:G]


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _segment_inputs(n, G, seed, sort=True):
    """Positive values (so relative errors mean something), ids over the
    groups plus out-of-range ids (-1, G .. G + 3) that must add nothing,
    sorted by id as on the path, and an 80 % live mask."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0, 100, n).astype(np.float32)
    gid = rng.integers(-1, G + 4, n).astype(np.int32)
    return vals, np.sort(gid) if sort else gid, rng.random(n) < 0.8


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 255, 257, 4097, 1_000_003,
                               5_998_321])
@pytest.mark.parametrize("G", [1, 7, 8, 33, 64])
def test_cuda_segment_sum_equals_plain(cuda, n, G):
    vals, sorted_gid, live = _segment_inputs(n, G, n * 100 + G)
    rng = np.random.default_rng(n + G)
    for gid in (sorted_gid, rng.permutation(sorted_gid)):
        for lv in (live, None):
            v, g = torch.from_numpy(vals).cuda(), torch.from_numpy(gid).cuda()
            lt = None if lv is None else torch.from_numpy(lv).cuda()
            before = GK.LAUNCHES["masked_segment_sum_f32"]
            got = GK.masked_segment_sum_f32(v, g, lt, G)
            again = GK.masked_segment_sum_f32(v, g, lt, G)
            torch.cuda.synchronize()
            assert GK.LAUNCHES["masked_segment_sum_f32"] == before + 2
            # a fixed summation order: the same bits on every run
            assert _same_bits(got, again)
            exact = _f64_sums(vals, gid, lv, G)
            # the kernel's per-thread + tree order: ~1e-7 relative here
            np.testing.assert_allclose(got.cpu().numpy(), exact, rtol=1e-5,
                                       atol=1e-3)
            # the plain version's atomic scatter-add drifts more
            plain = GK.masked_segment_sum_f32_plain(v, g, lt, G)
            np.testing.assert_allclose(plain.cpu().numpy(), exact,
                                       rtol=1e-4, atol=1e-3)
            np.testing.assert_allclose(got.cpu().numpy(),
                                       plain.cpu().numpy(), rtol=1e-3,
                                       atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("ov,og,ol", [
    (1, 0, 0), (2, 0, 0), (3, 0, 0), (0, 1, 0), (0, 2, 0), (0, 3, 0),
    (0, 0, 1), (0, 0, 2), (0, 0, 3), (1, 1, 1), (2, 2, 2), (3, 3, 3),
    (1, 2, 3), (3, 1, 0)])
def test_cuda_segment_sum_offsets(cuda, ov, og, ol):
    # views that start 0-3 elements into their storage: a shared offset
    # takes the 16-byte path with a peeled head, any other the 4-byte path
    n, G = 100_003, 33
    vals, gid, live = _segment_inputs(n + 3, G, ov * 16 + og * 4 + ol)
    v = torch.from_numpy(vals).cuda()[ov:ov + n]
    g = torch.from_numpy(gid).cuda()[og:og + n]
    lt = torch.from_numpy(live).cuda()[ol:ol + n]
    assert v.is_contiguous() and g.is_contiguous() and lt.is_contiguous()
    for mask, lv in ((lt, live[ol:ol + n]), (None, None)):
        got = GK.masked_segment_sum_f32(v, g, mask, G)
        again = GK.masked_segment_sum_f32(v, g, mask, G)
        torch.cuda.synchronize()
        assert _same_bits(got, again)
        np.testing.assert_allclose(
            got.cpu().numpy(),
            _f64_sums(vals[ov:ov + n], gid[og:og + n], lv, G), rtol=1e-5,
            atol=1e-3)


@pytest.mark.gpu
def test_cuda_segment_sum_same_bits_on_other_streams(cuda):
    # calls on two streams at once give the bits of the calls on the
    # current stream (no state is shared between calls)
    n, G = 1_000_003, 64
    inputs = [tuple(torch.from_numpy(x).cuda() for x in
                    _segment_inputs(n, G, seed)) for seed in (1, 2)]
    want = [GK.masked_segment_sum_f32(v, g, lv, G) for v, g, lv in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = [[], []]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(5):
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[k].append(GK.masked_segment_sum_f32(*inputs[k], G))
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    for k in range(2):
        assert all(_same_bits(r, want[k]) for r in got[k])


@pytest.mark.gpu
def test_cuda_segment_sum_after_empty_and_all_dead(cuda):
    # no grid state outlives a call, whatever its grid
    n, G = 1_000_003, 8
    v, g, lv = (torch.from_numpy(x).cuda()
                for x in _segment_inputs(n, G, 3))
    want = GK.masked_segment_sum_f32(v, g, lv, G)
    empty_v = torch.zeros(0, device="cuda")
    empty_g = torch.zeros(0, dtype=torch.int32, device="cuda")
    dead = torch.zeros(n, dtype=torch.bool, device="cuda")
    for other in ((empty_v, empty_g, None), (v, g, dead)):
        zeros = GK.masked_segment_sum_f32(*other, G)
        after = GK.masked_segment_sum_f32(v, g, lv, G)
        torch.cuda.synchronize()
        assert zeros.tolist() == [0.0] * G
        assert _same_bits(after, want)


@pytest.mark.gpu
def test_cuda_segment_sum_graph_replay(cuda):
    n, G = 1_000_003, 64
    v, g, lv = (torch.from_numpy(x).cuda()
                for x in _segment_inputs(n, G, 4))
    eager = GK.masked_segment_sum_f32(v, g, lv, G)  # sets up the launch
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = GK.masked_segment_sum_f32(v, g, lv, G)
    graph.replay()
    torch.cuda.synchronize()
    assert _same_bits(out, eager)
    v.mul_(2)  # a replay reads the inputs anew
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert _same_bits(out, GK.masked_segment_sum_f32(v, g, lv, G))


@pytest.mark.gpu
def test_cuda_segment_sum_first_call_captured(cuda):
    # the first call for a G (its setup) inside a capture
    n, G = 100_003, 5
    v, g, lv = (torch.from_numpy(x).cuda()
                for x in _segment_inputs(n, G, 6))
    assert GK._segment_grid.cache.peek((v.get_device(), G)) is None
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = GK.masked_segment_sum_f32(v, g, lv, G)
    graph.replay()
    torch.cuda.synchronize()
    assert _same_bits(out, GK.masked_segment_sum_f32(v, g, lv, G))


@pytest.mark.gpu
def test_cuda_segment_sum_graphs_replayed_at_once(cuda):
    # two graphs (captured on the same capture stream) replayed on two
    # streams at once, then an eager call: each gives its eager bits
    n, G = 1_000_003, 64
    inputs = [tuple(torch.from_numpy(x).cuda() for x in
                    _segment_inputs(n, G, seed)) for seed in (7, 8)]
    want = [GK.masked_segment_sum_f32(*x, G) for x in inputs]
    graphs, outs = [], []
    for x in inputs:
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1]):
            outs.append(GK.masked_segment_sum_f32(*x, G))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(5):
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                graphs[k].replay()
                got[k].append(outs[k].clone())
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
    after = GK.masked_segment_sum_f32(*inputs[0], G)
    torch.cuda.synchronize()
    for k in range(2):
        assert all(_same_bits(r, want[k]) for r in got[k])
    assert _same_bits(after, want[0])


@pytest.mark.gpu
def test_cuda_segment_sum_edges(cuda):
    v = torch.ones(5000, device="cuda")
    g = torch.zeros(5000, dtype=torch.int32, device="cuda")
    dead = torch.zeros(5000, dtype=torch.bool, device="cuda")
    assert GK.masked_segment_sum_f32(v, g, dead, 7).tolist() == [0.0] * 7
    empty = GK.masked_segment_sum_f32(
        torch.zeros(0, device="cuda"),
        torch.zeros(0, dtype=torch.int32, device="cuda"), None, 64)
    assert empty.tolist() == [0.0] * 64
    with pytest.raises(ValueError, match="contiguous"):
        GK.masked_segment_sum_f32(torch.ones(10000, device="cuda")[::2], g,
                                  None, 4)
    with pytest.raises(TypeError):
        GK.masked_segment_sum_f32(v.double(), g, None, 4)
    with pytest.raises(TypeError):
        GK.masked_segment_sum_f32(v, g.long(), None, 4)
    with pytest.raises(TypeError):
        GK.masked_segment_sum_f32(v, g, dead.int(), 4)
    with pytest.raises(ValueError):
        GK.masked_segment_sum_f32(v, g, None, 65)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_queries_equal_on_cuda_and_cpu(cuda):
    cat = default_catalog(0.01)
    gpu = StandaloneQueryRunner(cat, device="cuda")
    cpu = StandaloneQueryRunner(cat, device="cpu")
    for q in sorted(QUERIES):
        g, c = gpu.execute(QUERIES[q]).rows(), cpu.execute(QUERIES[q]).rows()
        assert len(g) == len(c)
        for a, b in zip(g, c):
            assert all(x == pytest.approx(y, rel=1e-9)
                       if isinstance(y, float) else x == y
                       for x, y in zip(a, b)), (q, a, b)


# ---------------------------------------------------------------------------
# scan ingest on the card: pinned buffers, the side stream, the device domain

def _staged_batches(rng, n_batches: int):
    """Seeded host batches of varied sizes: int64, float64 with NULLs and
    a constant (RLE) column."""
    from trino_tpu_torch.spi.batch import Column, ColumnBatch
    from trino_tpu_torch.spi.types import BIGINT, DOUBLE

    out = []
    for _ in range(n_batches):
        n = int(rng.integers(1000, 40_000))
        out.append(ColumnBatch(["a", "b", "c"], [
            Column(BIGINT, rng.integers(-10**9, 10**9, n)),
            Column(DOUBLE, rng.normal(size=n), rng.random(n) < 0.9),
            Column(BIGINT, np.full(n, int(rng.integers(0, 5)), np.int64))]))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("lazy", [(), (1,)])
def test_staged_batches_equal_host_values(cuda, lazy):
    """200 seeded batches through the coalescer's pinned buffers and the
    side-stream copies, each consumed by a device op on the default stream
    while later copies are in flight: every value equals the host's (a
    missing event wait or record_stream shows as torn values)."""
    from trino_tpu_torch.exec.prefetch import BatchCoalescer, DeviceStager

    rng = np.random.default_rng(10)
    host = _staged_batches(rng, 200)
    stager = DeviceStager("cuda", lazy_channels=lazy)
    coal = BatchCoalescer(1, alloc=stager.alloc)  # one batch per flush
    sums, pending = [], None
    for b in host:
        coal.add(b)
        staged, event = stager.stage(*coal.flush())
        if pending is not None:  # consume the previous batch now
            pb, pe = pending
            stager.ready(pe)
            sums.append(torch.stack([
                (pb.columns[0].data * 3 + 1).sum().double(),
                torch.where(pb.columns[1].valid, pb.columns[1].data,
                            0.0).sum(),
                pb.columns[2].data.double().sum()]))
        pending = (staged, event)
    stager.ready(pending[1])
    pb = pending[0]
    sums.append(torch.stack([
        (pb.columns[0].data * 3 + 1).sum().double(),
        torch.where(pb.columns[1].valid, pb.columns[1].data, 0.0).sum(),
        pb.columns[2].data.double().sum()]))
    got = torch.stack(sums).cpu().numpy()
    for row, b in zip(got, host):
        a = b.columns[0].data.numpy()
        assert row[0] == float((a * 3 + 1).sum())
        v = b.columns[1].valid.numpy()
        assert row[1] == pytest.approx(b.columns[1].data.numpy()[v].sum(),
                                       rel=1e-12)
        assert row[2] == float(b.columns[2].data.numpy().sum())
    assert stager.pool.reused > 0


@pytest.mark.gpu
def test_pinned_buffers_reused_only_after_their_event(cuda):
    from trino_tpu_torch.exec.prefetch import PinnedBufferPool

    pool = PinnedBufferPool()
    buf = pool.acquire(torch.int64, 1000)
    assert buf.is_pinned()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)  # keep the stream busy
        event = torch.cuda.Event()
        event.record(side)
    pool.release(buf, event)
    assert not event.query()
    other = pool.acquire(torch.int64, 1000)
    assert other.data_ptr() != buf.data_ptr()  # still in flight: a new one
    event.synchronize()
    again = pool.acquire(torch.int64, 1000)
    assert again.data_ptr() == buf.data_ptr() and pool.reused == 1


@pytest.mark.gpu
def test_device_domain_on_card_equals_cpu(cuda):
    from trino_tpu_torch.exec.kernels import _device_domain

    rng = np.random.default_rng(3)
    n = 300_000
    for data, valid, live, dict_len in (
            (rng.integers(-10**12, 10**12, n), rng.random(n) < 0.9,
             rng.random(n) < 0.7, 0),
            (np.where(rng.random(n) < 0.01, np.nan, rng.normal(size=n)),
             None, rng.random(n) < 0.7, 0),
            (rng.integers(0, 900, n).astype(np.int32), None,
             rng.random(n) < 0.5, 1000)):
        t = [None if x is None else torch.from_numpy(x)
             for x in (data, valid, live)]
        cpu = _device_domain(*t, dict_len).result()
        gpu = _device_domain(*[None if x is None else x.cuda() for x in t],
                             dict_len).result()
        assert cpu[:2] == gpu[:2] and cpu[2] == gpu[2] and cpu[3] == gpu[3]
        np.testing.assert_array_equal(cpu[4], gpu[4])


# ---------------------------------------------------------------------------
# statements on the card: ANALYZE, DELETE, REFRESH, CALL pin_table

def _refuse_plain(monkeypatch):
    """A statement on the card must launch the kernels: a plain version
    called with a CUDA tensor fails the test (the CPU runner keeps
    them)."""
    def refusing(orig):
        def call(*args):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                raise AssertionError("plain version on the card's path")
            return orig(*args)
        return call

    for name in ("hash_insert_plain", "hash_probe_plain",
                 "masked_segment_sum_f32_plain"):
        monkeypatch.setattr(GK, name, refusing(getattr(GK, name)))


def _statement_runners():
    from trino_tpu_torch.runner import Session

    gpu = StandaloneQueryRunner(default_catalog(0.01), device="cuda",
                                session=Session(default_catalog="memory"))
    cpu = StandaloneQueryRunner(default_catalog(0.01), device="cpu",
                                session=Session(default_catalog="memory"))
    return gpu, cpu


@pytest.mark.gpu
def test_analyze_on_card_equals_cpu(cuda, monkeypatch):
    gpu, cpu = _statement_runners()
    for r in (gpu, cpu):
        r.execute("create table li as select * from tpch.lineitem")
        r.execute("insert into li select * from tpch.lineitem "
                  "where l_orderkey < 1000")  # a second batch
    assert gpu.execute("call memory.pin_table('li')").rows() == [
        ("pinned li",)]
    mem = gpu.catalog.connector("memory")
    assert mem.is_resident("li")
    schema = mem.get_table_schema("li")
    non_dict = sum(not c.type.is_dictionary_encoded for c in schema.columns)
    _refuse_plain(monkeypatch)
    before = GK.LAUNCHES["hash_insert"]
    assert gpu.execute("analyze li").rows() == cpu.execute(
        "analyze li").rows()
    assert GK.LAUNCHES["hash_insert"] - before == non_dict
    got = mem.get_table_statistics("li")
    want = cpu.catalog.connector("memory").get_table_statistics("li")
    assert (got.row_count, got.ndv) == (want.row_count, want.ndv)


@pytest.mark.gpu
def test_delete_and_refresh_keep_cuda_tables_resident(cuda, monkeypatch):
    gpu, cpu = _statement_runners()
    for r in (gpu, cpu):
        r.execute("create table o as select o_orderkey, o_orderstatus, "
                  "o_totalprice from tpch.orders")
    gpu.execute("call memory.pin_table('o')")
    mem = gpu.catalog.connector("memory")
    _refuse_plain(monkeypatch)
    sql = "delete from o where o_orderstatus = 'F'"
    assert gpu.execute(sql).rows() == cpu.execute(sql).rows()
    assert mem.is_resident("o")
    for sql in ("create materialized view m as select o_orderstatus, "
                "count(*) c, sum(o_totalprice) s from o group by "
                "o_orderstatus",
                "insert into o select o_orderkey, o_orderstatus, "
                "o_totalprice from tpch.orders where o_orderkey < 100",
                "refresh materialized view m"):
        gpu.execute(sql)
        cpu.execute(sql)
    assert mem.is_resident("__mv_m")
    for table in ("o", "__mv_m"):
        for b in mem._data[table]:
            assert all(c.device.type == "cuda" for c in b.columns), table
    q = "select * from m order by o_orderstatus"
    assert gpu.execute(q).rows() == cpu.execute(q).rows()


@pytest.mark.gpu
def test_call_pin_table_pins_to_the_runners_device(cuda):
    from trino_tpu_torch.spi.batch import Column, ColumnBatch
    from trino_tpu_torch.spi.types import BIGINT

    gpu, _ = _statement_runners()
    gpu.execute("create table p (v bigint)")
    mem = gpu.catalog.connector("memory")
    mem.finish_insert("p", [[ColumnBatch(["v"], [
        Column(BIGINT, np.arange(1000, dtype=np.int64))])]])  # a host batch
    assert not mem.is_resident("p")
    gpu.execute("call memory.pin_table('p')")
    assert mem.is_resident("p")
    assert all(c.device == torch.device("cuda", torch.cuda.current_device())
               for b in mem._data["p"] for c in b.columns)
    assert gpu.execute("select sum(v) from p").rows() == [(499500,)]


# ---------------------------------------------------------------------------
# the engine's host-sync accounting, revocation and parallel drivers


@pytest.mark.gpu
def test_async_scalar_ready_only_after_its_event(cuda):
    from trino_tpu_torch.exec import syncguard as SG

    x = torch.ones(1000, device="cuda")
    torch.cuda._sleep(int(2e8))  # keep the stream busy for ~0.1 s
    h = SG.async_scalar(x.sum(), "test.gpu")
    assert not h.ready() and h.get_if_ready() is None
    before = SG.snapshot()
    assert float(h.get()) == 1000.0  # waits: one counted blocking sync
    d = SG.take_delta(before)
    assert (d.blocking_syncs, d.by_tag) == (1, {"test.gpu": 1})
    assert h.ready() and float(h.get_if_ready()) == 1000.0


@pytest.mark.gpu
def test_revoking_partition_buffers_lowers_memory_allocated(cuda):
    from trino_tpu_torch.exec.local_exchange import HASH, LocalExchange
    from trino_tpu_torch.exec.operators import HashAggregationOperator
    from trino_tpu_torch.exec.revoking import TaskMemoryContext
    from trino_tpu_torch.planner.plan import AggCall
    from trino_tpu_torch.spi.batch import Column, ColumnBatch
    from trino_tpu_torch.spi.types import BIGINT

    n = 1 << 22
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 5000, n)
    vals = rng.integers(0, 100, n)
    ex = LocalExchange(1, 4, HASH, key_channels=[0])
    ex.deposit(0, ColumnBatch(["k", "v"], [
        Column(BIGINT, torch.from_numpy(keys).cuda()),
        Column(BIGINT, torch.from_numpy(vals).cuda())]))
    mem = TaskMemoryContext(16 << 30)
    aggs = []
    for j in range(4):
        op = HashAggregationOperator([0], [AggCall("sum", 1, BIGINT)],
                                     ["k", "s"], [BIGINT, BIGINT])
        op.attach_memory(mem)
        op.add_input(ex.poll(j))
        aggs.append(op)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    freed = sum(op.revoke_memory() for op in aggs)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    # the four live-mask views share the key and value columns: each
    # counts them, and they leave the card with the last view
    assert freed >= 4 * 16 * n and before - after >= 16 * n
    got = {}
    for op in aggs:
        op.finish_input()
        got.update(dict(op.get_output().to_pylist()))
    want = np.bincount(keys, weights=vals, minlength=5000)
    assert got == {k: int(want[k]) for k in np.unique(keys)}


@pytest.mark.gpu
def test_concurrent_partition_drivers_give_one_drivers_rows(cuda):
    from trino_tpu_torch.runner import Session

    cat = default_catalog(0.1)
    one = StandaloneQueryRunner(cat, device="cuda",
                                session=Session(splits_per_node=8))
    four = StandaloneQueryRunner(cat, device="cuda", session=Session(
        splits_per_node=8, task_concurrency=4))
    r1 = ("select l_linenumber, sum(cast(l_quantity as real)) from "
          "lineitem group by l_linenumber order by l_linenumber")
    for sql in (QUERIES[1], QUERIES[18], QUERIES[21], r1):
        a, b = one.execute(sql).rows(), four.execute(sql).rows()
        assert len(a) == len(b)
        for x, y in zip(a, b):
            for u, v in zip(x, y):
                if isinstance(u, float):
                    assert abs(u - v) <= 1e-4 * abs(u), (x, y)
                else:
                    assert u == v, (x, y)


@pytest.mark.gpu
def test_probe_steady_state_makes_no_sync_on_card(cuda):
    from trino_tpu_torch.exec import syncguard as SG
    from trino_tpu_torch.exec.operators import (JoinBridge, JoinBuildSink,
                                                LookupJoinOperator)
    from trino_tpu_torch.spi.batch import Column, ColumnBatch
    from trino_tpu_torch.spi.types import BIGINT

    rng = np.random.default_rng(8)
    bk = np.repeat(np.arange(20000, dtype=np.int64), 4)
    bridge = JoinBridge()
    sink = JoinBuildSink(bridge, [0], [BIGINT, BIGINT], ["bk", "bv"], "cuda")
    sink.add_input(ColumnBatch(["bk", "bv"], [
        Column(BIGINT, torch.from_numpy(bk).cuda()),
        Column(BIGINT, torch.from_numpy(bk).cuda())]))
    sink.finish_input()
    op = LookupJoinOperator(bridge, [0], "INNER", None,
                            ["pk", "bk", "bv"], [BIGINT] * 3)
    out = []
    for i in range(8):
        pk = torch.from_numpy(rng.integers(0, 25000, 1 << 16)).cuda()
        b = ColumnBatch(["pk"], [Column(BIGINT, pk)])
        if i < 2:
            op.add_input(b)
        else:
            with SG.forbidden(cuda_sync_debug=True):
                op.add_input(b)
        while (o := op.get_output()) is not None:
            out.append(o)
    op.finish_input()
    while not op.is_finished():
        if (o := op.get_output()) is not None:
            out.append(o)
    assert sum(int(o.live.sum()) for o in out) > 0


@pytest.mark.gpu
def test_serde_of_a_cuda_batch_equals_its_cpu_copy(cuda):
    """Compacted on the card, copied column by column: the same bytes as
    the batch's CPU copy, v1 and v2, with masks, RLE and LAZY columns."""
    from trino_tpu_torch.execution import serde as S
    from trino_tpu_torch.spi.batch import Column, ColumnBatch
    from trino_tpu_torch.spi.types import BIGINT, DOUBLE, VARCHAR

    rng = np.random.default_rng(9)
    n = 5000
    d = np.array(["a", "bb", "ccc"], dtype=object)
    host_lazy = rng.integers(0, 99, n)

    def batch(device):
        return ColumnBatch(["k", "x", "s", "run", "lazy"], [
            Column(BIGINT, torch.from_numpy(rng.integers(0, 9, n)).to(device),
                   torch.from_numpy(rng.random(n) < 0.8).to(device)),
            Column(DOUBLE, torch.from_numpy(rng.normal(0, 1, n)).to(device),
                   torch.ones(n, dtype=torch.bool, device=device)),
            Column(VARCHAR, torch.from_numpy(rng.integers(0, 3, n).astype(
                np.int32)).to(device), None, d),
            Column.rle(BIGINT, 7, n, device=device),
            Column.lazy(BIGINT, n, lambda: (host_lazy, None),
                        device=device)],
            torch.from_numpy(rng.random(n) < 0.5).to(device))

    state = rng.bit_generator.state
    on_card = batch("cuda")
    rng.bit_generator.state = state
    on_cpu = batch("cpu")
    assert S.serialize_batch(on_card) == S.serialize_batch(on_cpu)
    a, b = S.PageStreamEncoder(), S.PageStreamEncoder()
    b.token = a.token
    assert S.serialize_batch(on_card, ctx=a) == S.serialize_batch(on_cpu,
                                                                  ctx=b)


@pytest.mark.gpu
def test_file_table_scan_on_card_equals_cpu(cuda, tmp_path):
    from trino_tpu_torch.runner import Session

    cat = default_catalog(0.1, file_root=str(tmp_path))
    session = Session(default_catalog="file")
    gpu = StandaloneQueryRunner(cat, device="cuda", session=session)
    cpu = StandaloneQueryRunner(cat, device="cpu",
                                session=Session(default_catalog="file"))
    for t in ("customer", "orders", "lineitem"):
        gpu.execute(f"create table {t} as select * from tpch.{t}")
    for q in (1, 3, 12, 18):
        a, b = gpu.execute(QUERIES[q]).rows(), cpu.execute(QUERIES[q]).rows()
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            for u, v in zip(x, y):
                if isinstance(u, float):
                    assert abs(u - v) <= 1e-9 * abs(u), (x, y)
                else:
                    assert u == v, (x, y)


@pytest.mark.gpu
def test_q18_under_a_disk_budget_on_card(cuda):
    from trino_tpu_torch.exec.stats import QueryStats
    from trino_tpu_torch.runner import Session

    cat = default_catalog(0.1)
    want = StandaloneQueryRunner(cat, device="cuda").execute(
        QUERIES[18]).rows()
    st = QueryStats()
    got = StandaloneQueryRunner(cat, device="cuda", session=Session(
        spill_to_disk_bytes=1 << 20)).execute(QUERIES[18], stats=st).rows()
    assert got == want and len(got) > 0
    assert st.spills()[2] > 0  # pages went to disk


# ---------------------------------------------------------------------------
# the cache plane and the profiler on the card (chip_smoke phase 18 at SF 0.1)

DASHBOARD = {3: "no nation", 5: "nation", 12: "no nation", 21: "nation"}
# the tags of exec/'s AsyncScalar reads (counted only when not yet landed)
ASYNC_WAIT_TAGS = ("join.expand-overflow", "join.pair-total",
                   "join.unique-count", "join.unique-overflow")


def _launched(fn):
    before = dict(GK.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: GK.LAUNCHES[k] - before[k] for k in GK.LAUNCHES}


@pytest.mark.gpu
def test_dashboard_passes_hit_both_tiers_on_card(cuda, monkeypatch,
                                                 tmp_path):
    from trino_tpu_torch import caching
    from trino_tpu_torch.connectors.staging import stage_memory_tables

    monkeypatch.setenv("TRINO_TPU_RESULT_CACHE", "1")
    monkeypatch.setenv("TRINO_TPU_JOURNAL_DIR", str(tmp_path))
    caching.reset_for_test()
    cat = default_catalog(0.1)
    stage_memory_tables(cat, ("region", "nation", "supplier", "customer",
                              "part", "partsupp", "orders", "lineitem"),
                        "cuda")
    r = StandaloneQueryRunner(cat, device="cuda",
                              default_catalog_name="memory",
                              splits_per_node=1)
    first = {q: _launched(lambda: r.execute(QUERIES[q]).rows())
             for q in DASHBOARD}
    assert all(sum(lq.values()) for _rows, lq in first.values())
    for q in DASHBOARD:  # pass 2: hits, no launch
        rows, lq = _launched(lambda: r.execute(QUERIES[q]).rows())
        assert rows == first[q][0] and not any(lq.values())
    stats = caching.result_cache.stats()
    assert stats["hits"] == len(DASHBOARD) and stats["bytes"] > 0
    r.execute("insert into nation values (99, 'ATLANTIS', 0, 'x')")
    for q, scans in DASHBOARD.items():  # only nation's readers re-execute
        rows, lq = _launched(lambda: r.execute(QUERIES[q]).rows())
        assert rows == first[q][0]
        assert lq == (first[q][1] if scans == "nation"
                      else {k: 0 for k in GK.LAUNCHES})
    r.execute("delete from nation where n_nationkey = 99")
    caching.reset_for_test()


@pytest.mark.gpu
def test_default_profile_level_adds_no_sync_on_card(cuda):
    from trino_tpu_torch.exec import syncguard as SG
    from trino_tpu_torch.exec.prefetch import IngestConfig
    from trino_tpu_torch.exec.stats import QueryStats
    from trino_tpu_torch.telemetry import profiler

    r = StandaloneQueryRunner(default_catalog(0.1), device="cuda",
                              ingest=IngestConfig(enabled=False))
    r.execute(QUERIES[21])
    syncs = {0: [], 1: [], 2: []}
    prev = profiler.level()
    try:
        # in turns: an async copy's read counts a sync only when the copy
        # has not landed, so those waits are set apart
        for level in (0, 1, 1, 0, 0, 1, 1, 0, 2):
            profiler.set_level(level)
            st = QueryStats()
            with SG.forbidden(cuda_sync_debug=level < 2):
                r.execute(QUERIES[21], stats=st)
            syncs[level].append(st.sync)
    finally:
        profiler.set_level(prev)

    def steady(s):
        return s.host_syncs - sum(n for t, n in s.by_tag.items()
                                  if t in ASYNC_WAIT_TAGS)

    assert len({steady(s) for s in syncs[0] + syncs[1]}) == 1
    assert not ({t for s in syncs[1] for t in s.by_tag}
                - {t for s in syncs[0] for t in s.by_tag}
                - set(ASYNC_WAIT_TAGS))
    full = syncs[2][0]
    added = full.by_tag["profiler.full"]
    assert added > 0 and steady(full) - added == steady(syncs[0][0])
    assert full.hot_loop_syncs == 0


@pytest.mark.gpu
def test_device_memory_watermark_reads_the_allocator(cuda):
    from trino_tpu_torch.telemetry import metrics

    dev = torch.device("cuda")
    x = torch.empty(1 << 20, dtype=torch.uint8, device=dev)
    peak = metrics.update_device_memory_watermark(dev)
    assert peak >= x.numel()
    assert metrics.DEVICE_MEMORY_PEAK.value() == peak
    assert metrics.DEVICE_MEMORY_IN_USE.value() >= x.numel()


def _static_inputs(device, n=100_000):
    rng = np.random.default_rng(11)
    keys = [torch.from_numpy(rng.integers(0, 500, n)).to(device),
            torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
            .to(device)]
    vals = torch.from_numpy(rng.standard_normal(n)).to(device)
    mask = torch.from_numpy(rng.random(n) < 0.8).to(device)
    return keys, vals, mask


def _slot_map(keys, values, used) -> dict:
    used = used.cpu()
    k = [x.cpu() for x in keys]
    v = [x.cpu() for x in values]
    return {tuple(x[i].item() for x in k): tuple(x[i].item() for x in v)
            for i in torch.nonzero(used).flatten().tolist()}


def _close_maps(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for key in a:
        for x, y in zip(a[key], b[key]):
            assert x == pytest.approx(y, rel=1e-9), key


@pytest.mark.gpu
def test_static_grouped_agg_on_card_equals_cpu(cuda):
    """One hash_insert launch, no host read, the CPU run's groups."""
    from trino_tpu_torch.exec import syncguard as SG
    from trino_tpu_torch.parallel.static_agg import (AggSpec,
                                                     static_grouped_agg)

    specs = [AggSpec("sum", torch.float64), AggSpec("count_star",
                                                    torch.int64),
             AggSpec("min", torch.float64), AggSpec("max", torch.float64)]
    out = {}
    for dev in ("cpu", "cuda"):
        keys, vals, mask = _static_inputs(dev)
        before = dict(GK.LAUNCHES)
        s0 = SG.snapshot()
        r = static_grouped_agg(keys, [None, None],
                               [(s, vals, None) for s in specs], 2048, mask)
        if dev == "cuda":
            assert isinstance(r.num_groups, torch.Tensor) and \
                r.num_groups.is_cuda
            assert GK.LAUNCHES["hash_insert"] == before["hash_insert"] + 1
            assert SG.take_delta(s0).host_syncs == 0
        out[dev] = (_slot_map(r.keys, r.values, r.slot_used),
                    int(r.num_groups))
    assert out["cuda"][1] == out["cpu"][1] == 1500
    _close_maps(out["cuda"][0], out["cpu"][0])


@pytest.mark.gpu
def test_distributed_grouped_agg_four_shards_on_card(cuda):
    from trino_tpu_torch.parallel.distributed import (
        distributed_grouped_agg, make_mesh)
    from trino_tpu_torch.parallel.static_agg import AggSpec

    specs = [AggSpec("sum", torch.float64), AggSpec("count_star",
                                                    torch.int64)]
    out = {}
    for dev in ("cpu", "cuda"):
        keys, vals, mask = _static_inputs(dev)
        mesh = make_mesh(4, device=dev)
        fn = distributed_grouped_agg(mesh, "x", [torch.int64, torch.int32],
                                     specs, cap=2048)
        k, v, used, overflow = fn(*keys, vals, vals, mask)
        assert int(overflow.max()) <= 2048
        out[dev] = _slot_map(k, v, used)
    _close_maps(out["cuda"], out["cpu"])


@pytest.mark.gpu
@pytest.mark.parametrize("tiled", [False, True], ids=["lanes", "tiled"])
def test_collective_exchange_on_card_equals_cpu(cuda, monkeypatch, tmp_path,
                                                tiled):
    from trino_tpu_torch.execution import collective_exchange as CE
    from trino_tpu_torch.execution.distributed_runner import (
        DistributedQueryRunner)
    from trino_tpu_torch.runner import Session

    if tiled:
        monkeypatch.setattr(CE, "TILED_THRESHOLD_ROWS", 0)
    # the compiled stages would take these queries' seams off the edge
    monkeypatch.setenv("TRINO_TPU_FUSED_STAGE", "0")
    cat = default_catalog(0.01)
    rows = {}
    for dev in ("cpu", "cuda"):
        _fresh_journal(monkeypatch, tmp_path / dev)
        dist = DistributedQueryRunner(cat, worker_count=4, device=dev,
                                      session=Session(node_count=4))
        rows[dev] = [dist.execute(QUERIES[q]).rows() for q in (1, 3, 18)]
        assert dist._collective_edges
        assert all(e.tiled == tiled
                   for e in dist._collective_edges.values())
    for g, c in zip(rows["cuda"], rows["cpu"]):
        assert len(g) == len(c)
        for a, b in zip(g, c):
            for x, y in zip(a, b):
                assert (x == pytest.approx(y, rel=1e-9)
                        if isinstance(y, float) else x == y), (a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("q", [1, 3])
def test_compiled_stages_on_card_equal_cpu(cuda, monkeypatch, tmp_path, q):
    """Q1's fused seam and Q3's resident plan at their defaults on the
    card: the rows of the CPU run, the same compiled edges, no fallback,
    and the accumulate, build and probe launching the hash kernels."""
    from trino_tpu_torch.execution.distributed_runner import (
        DistributedQueryRunner)
    from trino_tpu_torch.runner import Session

    for k in ("TRINO_TPU_FUSED_STAGE", "TRINO_TPU_RESIDENT_PLAN",
              "TRINO_TPU_FUSED_CAP"):
        monkeypatch.delenv(k, raising=False)
    cat = default_catalog(0.01)
    rows, edges = {}, {}
    for dev in ("cpu", "cuda"):
        _fresh_journal(monkeypatch, tmp_path / dev)
        dist = DistributedQueryRunner(cat, worker_count=4, device=dev,
                                      session=Session(node_count=4))
        before = dict(GK.LAUNCHES)
        rows[dev] = dist.execute(QUERIES[q]).rows()
        edges[dev] = (sorted(dist._fused_edges),
                      sorted(dist._resident_edges))
        assert dist._fused_edges or dist._resident_edges
        assert dist.fused_fallbacks == dist.resident_fallbacks == 0
        if dev == "cuda":
            assert GK.LAUNCHES["hash_insert"] > before["hash_insert"]
            if q == 3:
                assert GK.LAUNCHES["hash_probe"] > before["hash_probe"]
    assert edges["cuda"] == edges["cpu"]
    assert len(rows["cuda"]) == len(rows["cpu"]) > 0
    for a, b in zip(rows["cuda"], rows["cpu"]):
        for x, y in zip(a, b):
            assert (x == pytest.approx(y, rel=1e-9)
                    if isinstance(y, float) else x == y), (a, b)


@pytest.mark.gpu
def test_fte_and_adaptive_on_card_equal_cpu(cuda, monkeypatch, tmp_path):
    """Q3 under retry_policy=TASK with an injected task failure, and the
    adaptive flip drill (a forced broadcast-row limit the barrier
    corrects), give the CPU run's rows on the card; the FTE tasks launch
    the hash kernels on the card (no retry takes a plain version)."""
    from trino_tpu_torch.execution.distributed_runner import (
        DistributedQueryRunner)
    from trino_tpu_torch.execution.failure_injector import (
        TASK_FAILURE, FailureInjector)
    from trino_tpu_torch.runner import Session

    monkeypatch.setenv("TRINO_TPU_SPOOL_DIR", str(tmp_path))
    monkeypatch.setenv("TRINO_TPU_QUERY_STATE_DIR", str(tmp_path / "st"))
    join = ("select c.c_mktsegment, count(*) n, sum(o.o_totalprice) s "
            "from orders o join customer c on o.o_custkey = c.c_custkey "
            "group by c.c_mktsegment order by 1")
    cat = default_catalog(0.01)
    rows, decisions = {}, {}
    for dev in ("cpu", "cuda"):
        _fresh_journal(monkeypatch, tmp_path / dev)
        inj = FailureInjector()
        inj.inject(TASK_FAILURE, task_index=0, attempt=0)
        fte = DistributedQueryRunner(cat, worker_count=4, device=dev,
                                     session=Session(
                                         node_count=4, retry_policy="TASK",
                                         failure_injector=inj))
        before = dict(GK.LAUNCHES)
        rows[("fte", dev)] = fte.execute(QUERIES[3]).rows()
        assert any(r.fired for r in inj.rules)
        if dev == "cuda":
            assert GK.LAUNCHES["hash_insert"] > before["hash_insert"]
        monkeypatch.setenv("TRINO_TPU_FUSED_STAGE", "0")
        monkeypatch.setenv("TRINO_TPU_BROADCAST_ROW_LIMIT", "0")
        ada = DistributedQueryRunner(cat, worker_count=3, device=dev,
                                     session=Session(
                                         node_count=3, adaptive="auto",
                                         use_collectives=False,
                                         broadcast_threshold_bytes=1 << 30))
        rows[("ada", dev)] = ada.execute(join).rows()
        decisions[dev] = ada.last_adaptive.stats.decisions
        monkeypatch.delenv("TRINO_TPU_FUSED_STAGE")
        monkeypatch.delenv("TRINO_TPU_BROADCAST_ROW_LIMIT")
    assert decisions["cuda"] == decisions["cpu"]
    assert "flip_to_broadcast" in decisions["cpu"][0]
    for kind in ("fte", "ada"):
        a, b = rows[(kind, "cuda")], rows[(kind, "cpu")]
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x == y, (kind, x, y)


@pytest.mark.gpu
def test_spool_reads_land_on_card(cuda, tmp_path):
    """A spooled page is decoded on the host and read back onto the card;
    a WAL plan snapshot of a plan holding a card tensor unpickles to a
    host tensor."""
    from trino_tpu_torch.execution import query_state
    from trino_tpu_torch.execution.durable_spool import (DurableSpoolClient,
                                                         DurableSpoolWriter)
    from trino_tpu_torch.execution.task import PartitionedOutputSink
    from trino_tpu_torch.spi.batch import Column, ColumnBatch
    from trino_tpu_torch.spi.types import BIGINT

    batch = ColumnBatch(["x"], [Column(BIGINT, torch.arange(1000,
                                                            device="cuda"))])
    w = DurableSpoolWriter(str(tmp_path / "f0_t0"), 0, 2)
    sink = PartitionedOutputSink(w, "REPARTITION", [0], serde=True)
    sink.add_input(batch)
    sink.finish_input()
    w.set_finished()
    got = []
    for p in range(2):
        c = DurableSpoolClient([w.committed], p, device=torch.device("cuda"))
        while (pg := c.poll()) is not None:
            assert pg.columns[0].data.is_cuda
            got.extend(pg.columns[0].data.tolist())
    assert sorted(got) == list(range(1000))
    snap = query_state.decode_plan(query_state.encode_plan(
        {"t": torch.arange(3, device="cuda")})[0])
    assert snap["t"].device.type == "cpu" and snap["t"].tolist() == [0, 1, 2]


SERVED_REAL = ("select l_linenumber, sum(cast(l_quantity as real)), "
               "sum(cast(l_extendedprice as real)) from lineitem "
               "group by l_linenumber order by l_linenumber")


@pytest.mark.gpu
def test_worker_processes_launch_kernels_on_card(cuda, monkeypatch,
                                                 tmp_path):
    """Q3, Q12 and R1 at SF 0.1 through two worker processes on the card
    equal the same runner on the CPU, and the workers' own launch counts
    (``/v1/info``, summed over the fleet) show the kernel each query
    reaches: hash_insert for Q3, hash_probe for Q12, the segment sum for
    R1.  The coordinator's counts cannot see them: they are another
    process's."""
    import math

    from trino_tpu_torch.execution.remote import (
        ProcessDistributedQueryRunner)
    from trino_tpu_torch.runner import Session

    spec = {"factory": "trino_tpu_torch.connectors.catalog:default_catalog",
            "kwargs": {"scale_factor": 0.1}}
    cases = [("Q3", QUERIES[3], "hash_insert"),
             ("Q12", QUERIES[12], "hash_probe"),
             ("R1", SERVED_REAL, "masked_segment_sum_f32")]
    rows = {}
    for dev in ("cpu", "cuda"):
        _fresh_journal(monkeypatch, tmp_path / dev)
        dist = ProcessDistributedQueryRunner(
            spec, worker_count=2, session=Session(node_count=2),
            env_overrides={"TRINO_TPU_JOURNAL_DIR": str(tmp_path / dev)},
            device=dev)
        try:
            for name, sql, kernel in cases:
                before = [w.info()["launches"] for w in dist.workers]
                rows[(dev, name)] = dist.execute(sql).rows()
                after = [w.info()["launches"] for w in dist.workers]
                n = sum(a[kernel] - b[kernel]
                        for a, b in zip(after, before))
                if dev == "cuda":
                    assert n > 0, f"{name}: workers launched no {kernel}"
                    assert all(w.info()["device"] == "cuda"
                               for w in dist.workers)
                else:
                    assert n == 0
        finally:
            dist.close()
    for name, _, _ in cases:
        got, want = rows[("cuda", name)], rows[("cpu", name)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                if isinstance(b, float):
                    assert math.isclose(a, b, rel_tol=1e-4), (name, g, w)
                else:
                    assert a == b, (name, g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("sql", [
    "select count(*) from region",
    "select count(*), sum(n_nationkey) from nation where n_regionkey = 1"],
    ids=["region", "nation"])
def test_global_aggregation_over_a_task_without_split_on_card(
        cuda, monkeypatch, sql):
    """A small table gives one of two tasks no split: that task's PARTIAL
    global aggregation emits its row of defaults, and the FINAL task on
    the card takes it beside the other task's device batch (a host batch
    there raised a device mismatch in torch.cat).  Rows equal the port's
    CPU run of the same SQL at the same scale factor and worker count."""
    from trino_tpu_torch.execution.distributed_runner import (
        DistributedQueryRunner)
    from trino_tpu_torch.runner import Session

    monkeypatch.setenv("TRINO_TPU_FUSED_STAGE", "0")
    monkeypatch.setenv("TRINO_TPU_RESIDENT_PLAN", "0")
    rows = {dev: DistributedQueryRunner(
        default_catalog(1.0), worker_count=2, session=Session(node_count=2),
        device=dev).execute(sql).rows() for dev in ("cpu", "cuda")}
    assert len(rows["cpu"]) == 1
    assert rows["cuda"] == rows["cpu"]

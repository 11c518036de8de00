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
from trino_tpu_torch.runner import StandaloneQueryRunner


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


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 255, 257, 100_003, 1_000_000])
@pytest.mark.parametrize("G", [1, 7, 64])
def test_cuda_segment_sum_equals_plain(cuda, n, G):
    # positive values so relative errors mean something; ids cover the
    # groups plus out-of-range ids (G, G + 3, -1) that must add nothing
    rng = np.random.default_rng(n * 100 + G)
    vals = rng.uniform(0, 100, n).astype(np.float32)
    gid = rng.integers(-1, G + 4, n).astype(np.int32)
    live = rng.random(n) < 0.8
    v, g, lv = (torch.from_numpy(x).cuda() for x in (vals, gid, live))
    before = GK.LAUNCHES["masked_segment_sum_f32"]
    got = GK.masked_segment_sum_f32(v, g, lv, G)
    again = GK.masked_segment_sum_f32(v, g, lv, G)
    torch.cuda.synchronize()
    assert GK.LAUNCHES["masked_segment_sum_f32"] == before + 2
    # a fixed summation order: the same bits on every run
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    ok = live & (gid >= 0) & (gid < G)
    exact = np.array([vals[ok & (gid == k)].astype(np.float64).sum()
                      for k in range(G)])
    # the kernel's per-thread + tree order: ~1e-7 relative at these sizes
    np.testing.assert_allclose(got.cpu().numpy(), exact, rtol=1e-5,
                               atol=1e-3)
    # the plain version's atomic scatter-add drifts more (rtol 1e-4)
    np.testing.assert_allclose(
        GK.masked_segment_sum_f32_plain(v, g, lv, G).cpu().numpy(), exact,
        rtol=1e-4, atol=1e-3)
    no_live = GK.masked_segment_sum_f32(v, g, None, G).cpu().numpy()
    ok = (gid >= 0) & (gid < G)
    np.testing.assert_allclose(
        no_live, [vals[ok & (gid == k)].astype(np.float64).sum()
                  for k in range(G)], rtol=1e-5, atol=1e-3)


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

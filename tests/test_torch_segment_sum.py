"""The masked per-group float32 sum of the torch port on the CPU.

``masked_segment_sum_f32_plain`` (the plain version the wrapper takes for a
CPU tensor) is held to a numpy model of the reference's Pallas kernel
``_segment_sum_kernel``: 1024-row blocks, one [G, 128] float32 accumulator
tile revisited in order, a select per group, the 128 lanes summed at the
end.  The Pallas kernel itself cannot be imported on this CPU test mesh
(``trino_tpu/ops/pallas_kernels.py`` fails at import), so the model stands
in for it.  Both sum float32 values in float32, in different orders: they
agree to rtol 1e-4, the tolerance of the reference's own kernel test.

``grouped_reduce`` (the module that routes REAL sums to the kernel) is held
to the reference's ``grouped_reduce`` on the same seeded inputs.
"""

import numpy as np
import pytest
import torch

from trino_tpu.exec import kernels as RK
from trino_tpu_torch.exec import kernels as K
from trino_tpu_torch.ops import gpu_kernels as GK

_BLOCK, _LANES = 1024, 128


def pallas_model(values, gid, live, G):
    """numpy model of ``_segment_sum_kernel`` + ``masked_segment_sum_f32``."""
    values = np.asarray(values, np.float32)
    n = len(values)
    live = np.ones(n, bool) if live is None else np.asarray(live, bool)
    pad = (-n) % _BLOCK
    v = np.concatenate([values, np.zeros(pad, np.float32)])
    g = np.concatenate([np.asarray(gid, np.int32), np.zeros(pad, np.int32)])
    lv = np.concatenate([live, np.zeros(pad, bool)])
    rows = _BLOCK // _LANES
    tile = np.zeros((G, _LANES), np.float32)
    for b in range(len(v) // _BLOCK):
        sl = slice(b * _BLOCK, (b + 1) * _BLOCK)
        contrib = np.where(lv[sl], v[sl], np.float32(0)).reshape(rows, _LANES)
        gb = g[sl].reshape(rows, _LANES)
        for k in range(G):
            tile[k] += np.where(gb == k, contrib, np.float32(0)).sum(
                axis=0, dtype=np.float32)
    return tile.sum(axis=1, dtype=np.float32)


def _plain(values, gid, live, G):
    return GK.masked_segment_sum_f32(
        torch.from_numpy(np.ascontiguousarray(values, np.float32)),
        torch.from_numpy(np.ascontiguousarray(gid, np.int32)),
        None if live is None else torch.from_numpy(np.asarray(live, bool)),
        G).numpy()


@pytest.mark.parametrize("n,G", [(5000, 7), (4096, 1), (3 * 1024 + 17, 64),
                                 (250_003, 8), (3, 8), (4, 1), (5, 64)])
def test_plain_matches_pallas_model(n, G):
    # N = 3089 and 250003 are not multiples of any block size (1024 rows
    # in the Pallas kernel, 256 threads in the CUDA kernel)
    rng = np.random.default_rng(n + G)
    vals = rng.standard_normal(n).astype(np.float32) * 100
    gid = rng.integers(0, G, n).astype(np.int32)
    live = rng.random(n) > 0.3
    got = _plain(vals, gid, live, G)
    np.testing.assert_allclose(got, pallas_model(vals, gid, live, G),
                               rtol=1e-4, atol=1e-3)
    exact = np.array([vals[(gid == k) & live].astype(np.float64).sum()
                      for k in range(G)])
    np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("G", [4, 64])
def test_dead_rows_beyond_groups_add_nothing(G):
    # dead rows carry gid >= num_groups (the grouping kernel's contract);
    # at G = 64, the REAL-sum route's upper edge, id 64 is the trash slot
    vals = np.ones(2048, np.float32)
    gid = np.full(2048, G, np.int32)
    gid[:100] = 0
    gid[100:110] = G + 5
    gid[110:120] = -1
    got = _plain(vals, gid, None, G)
    want = pallas_model(vals, gid, None, G)
    assert got[0] == want[0] == 100.0
    assert got[1:].sum() == want[1:].sum() == 0.0


def test_empty_input_and_all_dead():
    assert _plain(np.zeros(0, np.float32), np.zeros(0, np.int32), None,
                  8).tolist() == [0.0] * 8
    n = 3000
    got = _plain(np.ones(n, np.float32), np.zeros(n, np.int32),
                 np.zeros(n, bool), 3)
    assert got.tolist() == [0.0, 0.0, 0.0]


def test_wrapper_rejects_bad_inputs():
    v = torch.ones(10)
    g = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError):
        GK.masked_segment_sum_f32(v, g, None, 65)
    with pytest.raises(TypeError):
        GK.masked_segment_sum_f32(v.double(), g, None, 4)
    with pytest.raises(TypeError):
        GK.masked_segment_sum_f32(v, g.long(), None, 4)
    with pytest.raises(ValueError):
        GK.masked_segment_sum_f32(torch.ones(20)[::2], g, None, 4)


@pytest.mark.parametrize("what,exc", [
    ("G=0", ValueError), ("G=65", ValueError),
    ("values float64", TypeError), ("values int32", TypeError),
    ("values 2-D", TypeError), ("gid int64", TypeError),
    ("gid short", TypeError), ("live uint8", TypeError),
    ("live short", TypeError), ("gid strided", ValueError),
    ("live strided", ValueError)])
def test_wrapper_host_checks(what, exc):
    n = 12
    args = {"values": torch.ones(n), "gid": torch.zeros(n, dtype=torch.int32),
            "live": torch.ones(n, dtype=torch.bool), "num_groups": 4}
    bad = {
        "G=0": ("num_groups", 0), "G=65": ("num_groups", 65),
        "values float64": ("values", torch.ones(n, dtype=torch.float64)),
        "values int32": ("values", torch.ones(n, dtype=torch.int32)),
        "values 2-D": ("values", torch.ones(n, 1)),
        "gid int64": ("gid", torch.zeros(n, dtype=torch.int64)),
        "gid short": ("gid", torch.zeros(n - 1, dtype=torch.int32)),
        "live uint8": ("live", torch.ones(n, dtype=torch.uint8)),
        "live short": ("live", torch.ones(n - 1, dtype=torch.bool)),
        "gid strided": ("gid", torch.zeros(2 * n, dtype=torch.int32)[::2]),
        "live strided": ("live", torch.ones(2 * n, dtype=torch.bool)[::2]),
    }
    key, value = bad[what]
    args[key] = value
    with pytest.raises(exc):
        GK.masked_segment_sum_f32(**args)


@pytest.mark.parametrize("ov,og,ol", [(1, 0, 0), (0, 2, 0), (0, 0, 3),
                                      (3, 3, 3), (1, 2, 3)])
def test_wrapper_accepts_offset_views(ov, og, ol):
    # a contiguous view may start at any element (the CUDA kernel peels an
    # unaligned head or takes its 4-byte path); no copy, no error
    n, G = 5003, 33
    rng = np.random.default_rng(ov * 16 + og * 4 + ol)
    vals = rng.standard_normal(n + 3).astype(np.float32) * 100
    gid = np.sort(rng.integers(-1, G + 4, n + 3)).astype(np.int32)
    live = rng.random(n + 3) > 0.3
    v = torch.from_numpy(vals)[ov:ov + n]
    g = torch.from_numpy(gid)[og:og + n]
    lv = torch.from_numpy(live)[ol:ol + n]
    got = GK.masked_segment_sum_f32(v, g, lv, G).numpy()
    np.testing.assert_allclose(
        got, pallas_model(vals[ov:ov + n], gid[og:og + n], live[ol:ol + n],
                          G), rtol=1e-4, atol=1e-3)


def _grouped_inputs(rng, n, G):
    """(perm, sorted gid with dead rows last at ids >= G, values, valid)."""
    row_gid = rng.integers(0, G, n)
    dead = rng.random(n) < 0.1
    row_gid = np.where(dead, G + 3, row_gid)
    perm = np.argsort(row_gid, kind="stable")
    gid = row_gid[perm].astype(np.int32)
    vals = (rng.standard_normal(n) * 1000).astype(np.float32)
    valid = rng.random(n) > 0.2
    ints = rng.integers(0, 40, n).astype(np.int64)
    return perm, gid, vals, valid, ints


@pytest.mark.parametrize("G", [7, 50, 64, 65])
def test_grouped_reduce_matches_reference(monkeypatch, G):
    # G <= 64 takes the masked_segment_sum_f32 route, G = 65 the plain
    # scatter; DISTINCT aggregates ride along in the same call
    rng = np.random.default_rng(G)
    n = 20_000
    perm, gid, vals, valid, ints = _grouped_inputs(rng, n, G)
    aggs_np = [("sum", vals, valid, np.float32, False),
               ("sum", vals, None, np.float32, False),
               ("count", ints, valid, np.int64, True),
               ("sum", ints, None, np.int64, True),
               ("count_star", None, None, np.int64, False)]
    calls = []
    orig = GK.masked_segment_sum_f32_plain

    def spy(*a):
        calls.append(a[-1])
        return orig(*a)

    monkeypatch.setattr(GK, "masked_segment_sum_f32_plain", spy)
    t = torch.from_numpy
    aggs_t = [(fn, None if d is None else t(d), None if v is None else t(v),
               dt, dist) for fn, d, v, dt, dist in aggs_np]
    got = K.grouped_reduce(t(perm), t(gid), G, aggs_t)
    assert calls == ([K.bucket(G)] * 2 if G <= 64 else [])
    monkeypatch.setenv("TRINO_TPU_PALLAS", "0")
    monkeypatch.setitem(RK._PALLAS_STATE, "enabled", None)
    want = RK.grouped_reduce(perm, gid, G, aggs_np)
    for (gd, gv), (wd, wv), (fn, _, _, dt, _) in zip(got, want, aggs_np):
        wd = np.asarray(wd)
        if dt == np.float32:
            np.testing.assert_allclose(gd.numpy(), wd, rtol=1e-4, atol=1e-2)
        else:
            np.testing.assert_array_equal(gd.numpy(), wd)
        if wv is None:
            assert gv is None or bool(gv.all())
        else:
            np.testing.assert_array_equal(
                np.ones(G, bool) if gv is None else gv.numpy(),
                np.asarray(wv))

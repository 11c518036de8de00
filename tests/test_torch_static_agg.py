"""The port's static and distributed aggregation and fused Q1 program
against the reference's.

``parallel/static_agg.static_grouped_agg`` runs seeded keys and values
through both packages for every aggregate function, with and without a
validity mask and a row mask; slots come in first-occurrence order in the
port (``hash_insert``) and in key order in the pinned reference (its sort
route), so the results compare as key -> values maps over the used slots.
Then the overflow signal, ``combine_partials``,
``parallel/distributed.distributed_grouped_agg`` over an 8-shard CPU mesh
against the reference's over its 8 CPU devices, ``broadcast_gather``, and
``bench_kernels.q1_step`` / ``q1_spmd`` against the reference's
``q1_step`` and ``q1_numpy`` on ``__graft_entry__.entry()``'s shapes.
Sums of doubles compare at rtol 1e-12 (another summation order).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trino_tpu import bench_kernels as RQ
from trino_tpu.parallel import distributed as RD
from trino_tpu.parallel import static_agg as RS
from trino_tpu_torch import bench_kernels as PQ
from trino_tpu_torch.exec import syncguard as SG
from trino_tpu_torch.ops import gpu_kernels as GK
from trino_tpu_torch.parallel import distributed as PD
from trino_tpu_torch.parallel import static_agg as PS

RTOL = 1e-12
FNS = ["sum", "count", "count_star", "min", "max", "any_value"]
_TORCH = {np.int64: torch.int64, np.float64: torch.float64,
          np.int32: torch.int32}
_JAX = {np.int64: jnp.int64, np.float64: jnp.float64, np.int32: jnp.int32}


@pytest.fixture(autouse=True)
def _pin(monkeypatch):
    for k, v in (("TRINO_TPU_HASH_IMPL", "sort"), ("TRINO_TPU_PALLAS", "0")):
        monkeypatch.setenv(k, v)


def _as(pkg: str, x):
    if x is None:
        return None
    return torch.from_numpy(x) if pkg == "port" else jnp.asarray(x)


def _slots(r, n_keys: int) -> dict:
    """key tuple (None for a NULL key) -> tuple of (value, valid) over the
    used slots of a StaticAggResult of either package."""
    used = np.asarray(r.slot_used)
    keys = [np.asarray(k) for k in r.keys]
    kvs = [None if v is None else np.asarray(v) for v in r.key_valids]
    vals = [np.asarray(v) for v in r.values]
    vvs = [None if v is None else np.asarray(v) for v in r.value_valids]
    out = {}
    for i in np.nonzero(used)[0]:
        key = tuple(None if kv is not None and not kv[i] else k[i].item()
                    for k, kv in zip(keys, kvs))
        out[key] = tuple(
            (v[i].item(), True if vv is None else bool(vv[i]))
            for v, vv in zip(vals, vvs))
    return out


def _inputs(seed: int, n: int, key_valid: bool, value_valid: bool):
    rng = np.random.RandomState(seed)
    keys = [rng.randint(0, 5, n).astype(np.int64),
            rng.randint(-3, 3, n).astype(np.int32)]
    kv = [(rng.rand(n) > 0.15) if key_valid else None, None]
    vals = {np.float64: rng.randn(n) * 100, np.int64:
            rng.randint(-10**6, 10**6, n).astype(np.int64)}
    vv = (rng.rand(n) > 0.3) if value_valid else None
    mask = rng.rand(n) > 0.25
    return keys, kv, vals, vv, mask


def _run(pkg, fn, dtype, keys, kv, vals, vv, mask, cap):
    S, A = (PS, _TORCH) if pkg == "port" else (RS, _JAX)
    spec = S.AggSpec(fn, A[dtype])
    data = None if fn == "count_star" else _as(pkg, vals[dtype])
    return S.static_grouped_agg(
        [_as(pkg, k) for k in keys], [_as(pkg, v) for v in kv],
        [(spec, data, None if fn == "count_star" else _as(pkg, vv))],
        cap, None if mask is None else _as(pkg, mask))


def _close(a, b) -> bool:
    if isinstance(b, float):
        return math.isclose(a, b, rel_tol=RTOL, abs_tol=1e-9)
    return a == b


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("dtype", [np.float64, np.int64],
                         ids=["f64", "i64"])
@pytest.mark.parametrize("valid", [False, True], ids=["dense", "nullable"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "mask"])
def test_static_grouped_agg_matches_reference(fn, dtype, valid, masked):
    keys, kv, vals, vv, mask = _inputs(1, 400, valid, valid)
    mask = mask if masked else None
    got = _slots(_run("port", fn, dtype, keys, kv, vals, vv, mask, 64), 2)
    want = _slots(_run("ref", fn, dtype, keys, kv, vals, vv, mask, 64), 2)
    assert set(got) == set(want)
    for key, ((g, gv),) in got.items():
        ((w, wv),) = want[key]
        assert gv == wv, key
        if not wv:
            continue
        if fn == "any_value":
            # any row's value of the group, with a value
            sel = np.ones(400, bool) if mask is None else mask.copy()
            for k, kvv, kk in zip(keys, kv, key):
                sel &= (k == kk) if kk is not None else ~kvv
                if kvv is not None and kk is not None:
                    sel &= kvv
            if vv is not None:
                sel &= vv
            assert g in set(vals[dtype][sel].tolist())
        else:
            assert _close(g, w), (key, g, w)


def test_num_groups_signals_overflow_like_reference():
    keys = np.arange(32, dtype=np.int64)
    x = np.ones(32)
    for cap in (8, 32, 64):
        got = PS.static_grouped_agg(
            [torch.from_numpy(keys)], [None],
            [(PS.AggSpec("sum", torch.float64), torch.from_numpy(x), None)],
            cap)
        want = RS.static_grouped_agg(
            [jnp.asarray(keys)], [None],
            [(RS.AggSpec("sum", jnp.float64), jnp.asarray(x), None)], cap)
        assert isinstance(got.num_groups, torch.Tensor)
        assert got.num_groups.dim() == 0
        assert int(got.num_groups) == int(want.num_groups) == 32
        assert int(got.slot_used.sum()) == min(cap, 32)


def test_static_agg_reads_nothing_back(monkeypatch):
    """No counted host read, and the insert's count stays on the device."""
    calls = []
    orig = GK.hash_insert_plain

    def spy(*args):
        out = orig(*args)
        calls.append(isinstance(out[1], torch.Tensor))
        return out

    monkeypatch.setattr(GK, "hash_insert_plain", spy)
    keys, kv, vals, vv, mask = _inputs(2, 300, True, True)
    before = SG.snapshot()
    _run("port", "sum", np.float64, keys, kv, vals, vv, mask, 16)
    assert SG.take_delta(before).host_syncs == 0
    assert calls == [True]


def test_nan_keys_form_one_group():
    keys = torch.tensor([float("nan"), 1.0, float("nan"), -0.0, 0.0])
    r = PS.static_grouped_agg(
        [keys], [None], [(PS.AggSpec("count_star", torch.int64), None,
                          None)], 8)
    assert int(r.num_groups) == 3
    assert sorted(r.values[0][r.slot_used].tolist()) == [1, 2, 2]


def test_combine_partials_matches_reference():
    rng = np.random.RandomState(4)
    n = 128
    keys = rng.randint(0, 9, n).astype(np.int64)
    s = rng.randn(n)
    c = rng.randint(0, 50, n).astype(np.int64)
    used = rng.rand(n) > 0.2
    specs = [("sum", np.float64, s), ("count", np.int64, c),
             ("min", np.float64, s), ("max", np.int64, c)]
    got = PS.combine_partials(
        [torch.from_numpy(keys)], [None],
        [(PS.AggSpec(f, _TORCH[t]), torch.from_numpy(x), None)
         for f, t, x in specs], torch.from_numpy(used), 16)
    want = RS.combine_partials(
        [jnp.asarray(keys)], [None],
        [(RS.AggSpec(f, _JAX[t]), jnp.asarray(x), None)
         for f, t, x in specs], jnp.asarray(used), 16)
    g, w = _slots(got, 1), _slots(want, 1)
    assert set(g) == set(w)
    for k in g:
        assert all(_close(a[0], b[0]) and a[1] == b[1]
                   for a, b in zip(g[k], w[k]))


def _dist_slots(out, nk: int) -> dict:
    keys, values, used, _ = out
    used = np.asarray(used)
    ks = [np.asarray(k) for k in keys]
    vs = [np.asarray(v) for v in values]
    got = {}
    for i in np.nonzero(used)[0]:
        key = tuple(k[i].item() for k in ks)
        assert key not in got  # each group owned by one shard
        got[key] = tuple(v[i].item() for v in vs)
    return got


@pytest.mark.parametrize("n_dev", [8, 3])
def test_distributed_grouped_agg_matches_reference(n_dev):
    """PARTIAL per shard, slots routed by ``_route_hash``, all_to_all of
    [n_dev, cap] lanes, FINAL through combine_partials."""
    rng = np.random.RandomState(2)
    n = 240
    keys = rng.randint(0, 6, n).astype(np.int64)
    k2 = rng.randint(0, 3, n).astype(np.int32)
    x = np.arange(n, dtype=np.float64)
    mask = rng.rand(n) > 0.1
    specs = [("sum", np.float64), ("count_star", np.int64),
             ("min", np.float64), ("max", np.float64)]
    mesh = PD.make_mesh(n_dev, device="cpu")
    fn = PD.distributed_grouped_agg(
        mesh, "x", [torch.int64, torch.int32],
        [PS.AggSpec(f, _TORCH[t]) for f, t in specs], cap=32)
    out = fn(torch.from_numpy(keys), torch.from_numpy(k2),
             *[torch.from_numpy(x)] * 4, torch.from_numpy(mask))
    rmesh = RD.make_mesh(n_dev)
    rfn = RD.distributed_grouped_agg(
        rmesh, "x", [jnp.int64, jnp.int32],
        [RS.AggSpec(f, _JAX[t]) for f, t in specs], cap=32)
    rout = rfn(jnp.asarray(keys), jnp.asarray(k2),
               *[jnp.asarray(x)] * 4, jnp.asarray(mask))
    assert out[3].shape == (n_dev,)
    assert int(out[3].max()) == int(np.asarray(rout[3]).max()) <= 32
    got, want = _dist_slots(out, 2), _dist_slots(rout, 2)
    assert set(got) == set(want)
    for k in got:
        assert all(_close(a, b) for a, b in zip(got[k], want[k])), k
    # slots live on the shard the reference's route hash names
    dest = PD._route_hash([torch.tensor([k[0] for k in got]),
                           torch.tensor([k[1] for k in got],
                                        dtype=torch.int32)], n_dev)
    rdest = RD._route_hash([jnp.asarray([k[0] for k in got]),
                            jnp.asarray([k[1] for k in got],
                                        dtype=jnp.int32)], n_dev)
    assert dest.tolist() == np.asarray(rdest).tolist()


def test_all_to_all_delivers_block_d_of_every_source():
    mesh = PD.make_mesh(3, device="cpu")
    blocks = [[torch.full((2,), 10 * s + d) for d in range(3)]
              for s in range(3)]
    got = PD.all_to_all(blocks, mesh)
    assert [g.tolist() for g in got] == [
        [d, d, 10 + d, 10 + d, 20 + d, 20 + d] for d in range(3)]


def test_broadcast_gather():
    mesh = PD.make_mesh(8, device="cpu")
    x = torch.arange(64, dtype=torch.int64)
    out = PD.broadcast_gather(mesh, "x")(x)
    want = np.asarray(RD.broadcast_gather(RD.make_mesh(8), "x")(
        jnp.arange(64, dtype=jnp.int64)))
    assert len(out) == 8
    for replica in out:
        assert replica.tolist() == want.tolist() == list(range(64))


def test_make_mesh_places_shards():
    mesh = PD.make_mesh(4, device="cpu")
    assert len(mesh) == 4 and mesh.shape == {"x": 4}
    assert all(d == torch.device("cpu") for d in mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PD.make_mesh(4)


def _graft_batch():
    """__graft_entry__.entry()'s seeded Q1 shapes, as numpy."""
    n = 1024
    rng = np.random.RandomState(0)
    return [rng.randint(0, 3, n).astype(np.int32),
            rng.randint(0, 2, n).astype(np.int32),
            rng.randint(100, 5000, n).astype(np.int64),
            rng.randint(100000, 9000000, n).astype(np.int64),
            rng.randint(0, 10, n).astype(np.int64),
            rng.randint(0, 8, n).astype(np.int64),
            rng.randint(10000, 10700, n).astype(np.int32)]


def _q1_map(keys, values, used) -> dict:
    used = np.asarray(used)
    k = [np.asarray(x) for x in keys]
    v = [np.asarray(x) for x in values]
    return {(k[0][i].item(), k[1][i].item()): tuple(x[i].item() for x in v)
            for i in np.nonzero(used)[0]}


def _same_q1(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key in got:
        assert all(_close(a, b) for a, b in zip(got[key], want[key])), key


def test_q1_step_and_spmd_match_reference():
    cols = _graft_batch()
    pb = PQ.Q1Batch(*[torch.from_numpy(c) for c in cols])
    rb = RQ.Q1Batch(*[jnp.asarray(c) for c in cols])
    want = _q1_map(*RQ.q1_step(rb))
    _same_q1(_q1_map(*PQ.q1_step(pb)), want)
    out = PQ.q1_spmd(PD.make_mesh(4, device="cpu"))(pb)
    assert int(out[3].max()) <= 8
    _same_q1(_q1_map(*out[:3]), want)
    # and q1_numpy of both packages
    uniq, cols_p = PQ.q1_numpy(pb)
    runiq, cols_r = RQ.q1_numpy(RQ.Q1Batch(*cols))
    assert uniq.tolist() == runiq.tolist()
    for name in cols_r:
        assert np.allclose(cols_p[name], cols_r[name], rtol=RTOL)
    counts = {(k // 1000, k % 1000): c
              for k, c in zip(uniq.tolist(), cols_p["count"].tolist())}
    assert {k: v[-1] for k, v in want.items()} == counts


def test_make_q1_inputs_on_the_cpu():
    b = PQ.make_q1_inputs(0.01, device="cpu")
    assert b.shipdate.shape[0] == 59791
    assert {x.device.type for x in b} == {"cpu"}
    keys, values, used = PQ.q1_step(b)
    uniq, cols = PQ.q1_numpy(b)
    got = _q1_map(keys, values, used)
    assert sorted(k[0] * 1000 + k[1] for k in got) == uniq.tolist()
    assert sum(v[-1] for v in got.values()) == int(cols["count"].sum())

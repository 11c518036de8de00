"""Hash primitives and the hash_insert / hash_probe kernels of the torch port.

- ``key_planes`` and ``hash_combine`` equal the reference's
  ``trino_tpu.exec.kernels`` bit for bit (int, bool, float with NaN / -0.0,
  NULL keys);
- the plain versions of ``hash_insert`` / ``hash_probe`` equal a numpy model
  of the serial Pallas kernel (row ids and group count exact, probe ids
  exact);
- the join ranges (lo, counts, total) of the port's hash path equal the
  reference's searchsorted path on the same build;
- the port's hash group-by partitions rows like the reference's lexsort
  ``group_ids`` (up to relabeling).

The Pallas kernels themselves cannot run here (the reference module does not
import on this JAX), so the reference side is pinned to its sort path.  The
CUDA kernels are held to the same plain versions on the card
(tests/test_torch_gpu.py and ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu.exec import join_exec as RJX
from trino_tpu.exec import kernels as RK
from trino_tpu_torch.exec import join_exec as JX
from trino_tpu_torch.exec import kernels as K
from trino_tpu_torch.ops import gpu_kernels as GK


@pytest.fixture(autouse=True)
def _pin_reference(monkeypatch):
    monkeypatch.setenv("TRINO_TPU_HASH_IMPL", "sort")
    monkeypatch.setenv("TRINO_TPU_PALLAS", "0")


_SPECIALS = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1.5,
                      -1.5, 1e300, 1e-300, 3.0, 2.0 ** 70])


def _key_cases():
    rng = np.random.default_rng(11)
    n = 1500
    ints = rng.integers(-(1 << 62), 1 << 62, n)
    ints[:4] = [0, -1, np.iinfo(np.int64).min, np.iinfo(np.int64).max]
    return {
        "int64": [(ints, None)],
        "int32_nullable": [(rng.integers(-50, 50, n).astype(np.int32),
                            rng.random(n) < 0.8)],
        "bool": [(rng.random(n) < 0.5, None)],
        "float_specials": [(_SPECIALS[rng.integers(0, len(_SPECIALS), n)],
                            rng.random(n) < 0.9)],
        "multi": [(rng.integers(0, 9, n), None),
                  (rng.random(n) * 100, rng.random(n) < 0.7),
                  (rng.random(n) < 0.3, None)],
    }


@pytest.mark.parametrize("case", sorted(_key_cases()))
def test_key_planes_and_hash_match_reference(case):
    keys = _key_cases()[case]
    ref_keys = [(jnp.asarray(d), None if v is None else jnp.asarray(v))
                for d, v in keys]
    port_keys = [(torch.from_numpy(d), None if v is None
                  else torch.from_numpy(v)) for d, v in keys]
    ref_planes = [np.asarray(p).view(np.int32)
                  for p in RK.key_planes(ref_keys)]
    port_planes = [p.numpy() for p in K.key_planes(port_keys)]
    assert len(ref_planes) == len(port_planes)
    for a, b in zip(ref_planes, port_planes):
        np.testing.assert_array_equal(a, b)
    ref_h = np.asarray(RK.hash_combine([d for d, _ in ref_keys]))
    port_h = K.hash_combine([d for d, _ in port_keys]).numpy().view(np.uint64)
    np.testing.assert_array_equal(ref_h, port_h)


# ---------------------------------------------------------------------------
# plain kernels vs a numpy model of the serial Pallas kernels


def _serial_insert(planes, h32, live, S):
    """numpy model of _hash_insert_kernel: rows walked in order."""
    P, n = planes.shape
    table = np.zeros((P, S), np.uint32)
    sgid = np.full(S, -1, np.int64)
    gid = np.empty(n, np.int64)
    count = 0
    for i in range(n):
        if not live[i]:
            gid[i] = S
            continue
        slot = int(h32[i]) & (S - 1)
        while True:
            if sgid[slot] < 0:
                sgid[slot] = count
                table[:, slot] = planes[:, i]
                count += 1
                break
            if (table[:, slot] == planes[:, i]).all():
                break
            slot = (slot + 1) & (S - 1)
        gid[i] = sgid[slot]
    return gid, count, table, sgid


def _serial_probe(table, sgid, planes, h32, live):
    S = len(sgid)
    out = np.full(planes.shape[1], -1, np.int64)
    for i in range(planes.shape[1]):
        if not live[i]:
            continue
        slot = int(h32[i]) & (S - 1)
        while sgid[slot] >= 0:
            if (table[:, slot] == planes[:, i]).all():
                out[i] = sgid[slot]
                break
            slot = (slot + 1) & (S - 1)
    return out


def _t32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("P,distinct,slot_mod", [
    (1, 300, None), (2, 1000, None), (6, 40, 4), (3, 2500, None)])
def test_plain_insert_probe_match_serial_model(P, distinct, slot_mod):
    rng = np.random.default_rng(P * 1000 + distinct)
    n = 2000
    S = K.bucket(2 * n)
    vocab = rng.integers(0, 2**32, (P, distinct), dtype=np.uint64).astype(
        np.uint32)
    pick = rng.integers(0, distinct, n)
    planes = vocab[:, pick]
    h32 = (pick.astype(np.uint64) * 2654435761 % 2**32).astype(np.uint32)
    if slot_mod:  # adversarial: every key in one of a few slots
        h32 = (pick % slot_mod).astype(np.uint32)
    live = rng.random(n) < 0.9
    gid_m, count_m, table_m, sgid_m = _serial_insert(planes, h32, live, S)
    before = dict(GK.LAUNCHES)
    gid, count, table, sgid = GK.hash_insert(
        _t32(planes), _t32(h32), torch.from_numpy(live), S)
    assert count == count_m
    np.testing.assert_array_equal(gid.numpy(), gid_m)
    assert GK.LAUNCHES == before  # CPU tensors take the plain version
    # probe: present keys, absent keys, dead rows — through both tables
    pp = np.concatenate([planes[:, :300], rng.integers(
        0, 2**32, (P, 200), dtype=np.uint64).astype(np.uint32)], axis=1)
    ph = np.concatenate([h32[:300], rng.integers(
        0, 2**32, 200, dtype=np.uint64).astype(np.uint32)])
    plive = rng.random(500) < 0.9
    want = _serial_probe(table_m, sgid_m, pp, ph, plive)
    got = GK.hash_probe(table, sgid, _t32(pp), _t32(ph),
                        torch.from_numpy(plive))
    np.testing.assert_array_equal(got.numpy(), want)


def _table_by_gid(table, sgid, count):
    """[P, count] planes of the occupied buckets in id order; each id
    0..count-1 must sit in exactly one bucket."""
    table, sgid = np.asarray(table), np.asarray(sgid)
    occ = sgid >= 0
    ids = np.sort(sgid[occ])
    np.testing.assert_array_equal(ids, np.arange(count))
    out = np.zeros((table.shape[0], count), table.dtype)
    out[:, sgid[occ]] = table[:, occ]
    return out


def _bucket_case(case):
    """(planes, h32, live, S) numpy inputs for the bucket-storage cases."""
    rng = np.random.default_rng(len(case) * 7 + 1)
    P, n, distinct = {"p8": (8, 1500, 200), "live_none": (2, 1500, 300),
                      "all_dead": (2, 600, 50), "empty": (3, 0, 1),
                      "one_slot_wrap": (3, 400, 120),
                      "p1": (1, 1000, 900)}[case]
    S = K.bucket(2 * max(n, 1))
    vocab = rng.integers(0, 2**32, (P, distinct), dtype=np.uint64).astype(
        np.uint32)
    pick = rng.integers(0, distinct, n)
    planes = vocab[:, pick]
    h32 = (pick.astype(np.uint64) * 2654435761 % 2**32).astype(np.uint32)
    live = rng.random(n) < 0.9
    if case == "live_none":
        live = None
    elif case == "all_dead":
        live = np.zeros(n, bool)
    elif case == "one_slot_wrap":  # every key starts at the last slot
        h32 = np.full(n, S - 1, np.uint32)
    return planes, h32, live, S


@pytest.mark.parametrize("case", ["p8", "live_none", "all_dead", "empty",
                                  "one_slot_wrap", "p1"])
def test_plain_insert_builds_bucket_storage(case):
    planes, h32, live, S = _bucket_case(case)
    P, n = planes.shape
    lv = np.ones(n, bool) if live is None else live
    gid_m, count_m, table_m, sgid_m = _serial_insert(planes, h32, lv, S)
    gid, count, table, sgid = GK.hash_insert(
        _t32(planes), _t32(h32), None if live is None
        else torch.from_numpy(live), S)
    assert count == count_m
    np.testing.assert_array_equal(gid.numpy(), gid_m)
    # the reference's shapes and values: [P, S] planes and [S] ids, -1 and
    # zero planes in empty slots, each id once with its key's planes
    assert table.shape == (P, S) and sgid.shape == (S,)
    assert table.dtype == sgid.dtype == torch.int32
    t, g = table.numpy().view(np.uint32), sgid.numpy()
    assert (g >= 0).sum() == count and (t[:, g < 0] == 0).all()
    np.testing.assert_array_equal(_table_by_gid(t, g, count),
                                  _table_by_gid(table_m, sgid_m, count_m))
    # every occupied bucket holds the planes of the first row with its id
    for k in range(count):
        first = int(np.argmax(gid_m == k))
        np.testing.assert_array_equal(t[:, g == k][:, 0], planes[:, first])
    # both are views of one [S, W] bucket storage, W = 4 * ceil((P + 1) / 4)
    W = GK.bucket_width(P)
    assert W % 4 == 0 and W >= P + 1 > W - 4
    assert sgid.stride() == (W,) and table.stride() == (1, W)
    assert table.data_ptr() == sgid.data_ptr() + 4
    assert sgid.data_ptr() % 16 == 0
    # probes: through the plain table, live=None and a mask
    pl = torch.from_numpy(live) if live is not None else None
    got = GK.hash_probe(table, sgid, _t32(planes), _t32(h32), pl)
    want = _serial_probe(table_m, sgid_m, planes, h32, lv)
    np.testing.assert_array_equal(got.numpy(), want)
    if live is None:
        got_all = GK.hash_probe(table, sgid, _t32(planes), _t32(h32))
        np.testing.assert_array_equal(got_all.numpy(), gid_m)


def test_probe_raises_on_other_tables():
    planes, h32, live, S = _bucket_case("p1")
    gid, count, table, sgid = GK.hash_insert(
        _t32(planes), _t32(h32), torch.from_numpy(live), S)
    p, h = _t32(planes[:, :50]), _t32(h32[:50])
    GK.hash_probe(table, sgid, p, h)  # the views hash_insert returned
    with pytest.raises(ValueError, match="bucket storage"):  # repacked
        GK.hash_probe(table.contiguous(), sgid.contiguous(), p, h)
    with pytest.raises(ValueError, match="bucket storage"):
        GK.hash_probe(table.clone(), sgid, p, h)
    with pytest.raises(ValueError, match="bucket storage"):  # wrong width
        GK.hash_probe(table, sgid, torch.cat([p, p]), h)
    with pytest.raises(TypeError):
        GK.hash_probe(table.long(), sgid, p, h)
    with pytest.raises(ValueError, match="contiguous"):
        GK.hash_probe(table, sgid, _t32(planes)[:, ::20], h)


def test_insert_checks_its_inputs():
    planes = torch.zeros((1, 8), dtype=torch.int32)
    h = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        GK.hash_insert(planes, h, None, 12)  # not a power of two
    with pytest.raises(ValueError):
        GK.hash_insert(planes, h, None, 8)  # fewer than 2 x rows
    with pytest.raises(TypeError):
        GK.hash_insert(planes.long(), h, None, 16)
    with pytest.raises(ValueError, match="contiguous"):
        GK.hash_insert(torch.zeros((1, 16), dtype=torch.int32)[:, ::2], h,
                       None, 16)


# ---------------------------------------------------------------------------
# operator-level contracts against the reference's sort path


def test_join_ranges_match_reference_sort_path():
    rng = np.random.default_rng(7)
    nb, npr = 4000, 6000
    bk = rng.integers(0, 500, nb).astype(np.int64)
    bv = rng.random(nb) < 0.9
    blive = rng.random(nb) < 0.95
    pk = rng.integers(0, 700, npr).astype(np.int64)  # some keys miss
    pv = rng.random(npr) < 0.9
    plive = rng.random(npr) < 0.95
    rt = RJX.build_table([(jnp.asarray(bk), jnp.asarray(bv))],
                         live=jnp.asarray(blive), num_rows=nb)
    assert rt.hash_idx is None  # the reference runs its searchsorted path
    rlo, rc, rtot = RJX.probe_ranges_device(
        rt, [(jnp.asarray(pk), jnp.asarray(pv))], [None],
        jnp.asarray(plive))
    rlo, rc, rtot = np.asarray(rlo), np.asarray(rc), int(rtot.get())
    t = JX.build_table([(torch.from_numpy(bk), torch.from_numpy(bv))],
                       live=torch.from_numpy(blive))
    assert t.hash_idx is not None and not t.unique
    np.testing.assert_array_equal(
        t.sorted_hash.numpy().view(np.uint64), np.asarray(rt.sorted_hash))
    lo, c, tot = JX.probe_ranges_device(
        t, [(torch.from_numpy(pk), torch.from_numpy(pv))], [None],
        torch.from_numpy(plive))
    assert int(tot.get()) == rtot > 0
    np.testing.assert_array_equal(c.numpy(), rc)
    m = rc > 0
    np.testing.assert_array_equal(lo.numpy()[m], rlo[m])


def _partition(perm, gid, num_groups, n):
    out = [None] * n
    for p, g in zip(np.asarray(perm), np.asarray(gid)):
        out[int(p)] = int(g) if g < num_groups else None
    return out


@pytest.mark.parametrize("case", ["nullable_int", "three_keys", "floats"])
def test_hash_group_partition_matches_reference(case):
    rng = np.random.default_rng(3)
    n = 3000
    if case == "nullable_int":
        keys = [(rng.integers(-40, 40, n), rng.random(n) < 0.85)]
    elif case == "three_keys":  # the Q3 shape: bigint, date, bigint
        keys = [(rng.integers(1, 600, n), None),
                (rng.integers(8000, 8100, n).astype(np.int32), None),
                (np.zeros(n, np.int64), None)]
    else:
        keys = [(_SPECIALS[rng.integers(0, len(_SPECIALS), n)], None),
                (rng.integers(0, 3, n), None)]
    live = rng.random(n) < 0.9
    rp, rg, rn = RK.group_ids(
        [(jnp.asarray(d), None if v is None else jnp.asarray(v))
         for d, v in keys], jnp.asarray(live))
    pp, pg, pn = K.hash_group_ids(
        [(torch.from_numpy(d), None if v is None else torch.from_numpy(v))
         for d, v in keys], torch.from_numpy(live))
    assert pn == rn
    assert (np.diff(pg.numpy()) >= 0).all()
    a, b = _partition(rp, rg, rn, n), _partition(pp, pg, pn, n)
    fwd = {}
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert fwd.setdefault(x, y) == y
    assert len(set(fwd.values())) == rn


"""The port's window evaluation (trino_tpu_torch.exec.window_kernels)
against the reference's (trino_tpu.exec.window_kernels) on the same seeded
numpy inputs.

Each case is one key shape (NULL and NaN keys, DESC and NULLS FIRST, ties,
one-row partitions, no partition or no order, an empty OVER ()) times one
group of functions: the ranking functions (ntile with more tiles than
rows too), navigation (lag / lead with and without a default column,
first / last / nth_value over every frame kind), the framed count / sum /
avg, and min / max over the frames the reference supports.  The frames
include the edges where a gather index runs past the partition:
FOLLOWING-only and PRECEDING-only frames at a partition's first and last
rows, and frames that are empty.  Both packages raise on the frames the
reference does not support.

Validity must be equal, and data equal where valid: integers exactly,
doubles to rtol 1e-9.  A framed sum or avg of doubles is a difference of
two prefix sums, and the two packages accumulate the prefixes in different
orders (torch.cumsum sequentially, XLA's CPU cumsum as an associative
scan), so its error scales with the prefix, not with the window's value:
those compare within n * 2^-53 * max |prefix| absolute, where the largest
prefix is bounded by the sum of |x| over the input.
"""

import math

import numpy as np
import pytest

from trino_tpu.exec import window_kernels as ref_wk
from trino_tpu_torch.exec import window_kernels as wk

N = 48
RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _map_headroom():
    """The reference compiles one XLA program per window spec; drop the
    executables other modules left in this process first (as
    tests/test_window.py does)."""
    import gc

    import jax

    jax.clear_caches()
    gc.collect()


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(100.0, 50.0, N), 2)
    x_valid = rng.random(N) > 0.2
    x_nan = x.copy()
    x_nan[rng.choice(N, 3, replace=False)] = np.nan
    return {
        "x": (x, x_valid),
        "x_nan": (x_nan, x_valid),
        "i": (rng.integers(-1000, 1000, N).astype(np.int64), x_valid),
        "b": (rng.random(N) > 0.5, rng.random(N) > 0.1),
        "default": (rng.integers(-5, 5, N).astype(np.int64),
                    rng.random(N) > 0.3),
    }


def _key_cases():
    rng = np.random.default_rng(7)
    part = rng.integers(0, 6, N).astype(np.int64)
    part[:3] = [90, 91, 92]  # one-row partitions
    order = rng.integers(0, 5, N).astype(np.int64)  # many ties
    pvalid = rng.random(N) > 0.15
    # garbage under NULL: the reference does not zero it before sorting
    fkey = rng.integers(0, 4, N).astype(np.float64) - 1.5
    fkey[rng.choice(N, 4, replace=False)] = np.nan
    fkey[rng.choice(N, 3, replace=False)] = -0.0
    fkey[rng.choice(N, 3, replace=False)] = 0.0
    fvalid = rng.random(N) > 0.2
    codes = rng.integers(0, 7, N).astype(np.int32)
    cvalid = rng.random(N) > 0.2
    flag = rng.random(N) > 0.5
    return {
        "int_ties": ([(part, None)], [(order, None, True, False)]),
        "null_nan_desc_nulls_first": (
            [(part % 3, pvalid)], [(fkey, fvalid, False, True)]),
        "nan_asc_nulls_last": (
            [(part, None)], [(fkey, fvalid, True, False)]),
        "codes_nulls_first_then_bool_desc": (
            [(part % 2, None)],
            [(codes, cvalid, True, True), (flag, None, False, True)]),
        "desc_nulls_last_no_partition": (
            [], [(order, pvalid, False, False)]),
        "partition_only": ([(part, pvalid)], []),
        "one_row_partitions": ([(np.arange(N, dtype=np.int64), None)],
                               [(order, None, True, False)]),
        "empty_over": ([], []),
    }


KEY_CASES = _key_cases()

DEFAULT = ("RANGE", "UNBOUNDED_PRECEDING", None, "CURRENT", None)
FRAMES = [
    DEFAULT,
    ("ROWS", "UNBOUNDED_PRECEDING", None, "CURRENT", None),
    ("ROWS", "UNBOUNDED_PRECEDING", None, "UNBOUNDED_FOLLOWING", None),
    ("RANGE", "UNBOUNDED_PRECEDING", None, "UNBOUNDED_FOLLOWING", None),
    ("ROWS", "PRECEDING", 2, "FOLLOWING", 1),
    ("ROWS", "FOLLOWING", 1, "FOLLOWING", 3),     # past a partition's end
    ("ROWS", "PRECEDING", 3, "PRECEDING", 1),     # before its start
    ("ROWS", "FOLLOWING", 3, "FOLLOWING", 1),     # empty everywhere
    ("ROWS", "CURRENT", None, "UNBOUNDED_FOLLOWING", None),
    ("RANGE", "CURRENT", None, "UNBOUNDED_FOLLOWING", None),
    ("ROWS", "UNBOUNDED_PRECEDING", None, "FOLLOWING", 2),
    ("ROWS", "PRECEDING", 2, "UNBOUNDED_FOLLOWING", None),
]
# min / max: frames from the partition's head, to its tail, or all of it
MINMAX_FRAMES = [f for f in FRAMES
                 if f[1] == "UNBOUNDED_PRECEDING"
                 or f[3] == "UNBOUNDED_FOLLOWING"]


def _fn(fn, args=(), dtype=np.float64, offset=1, frame=DEFAULT):
    return {"fn": fn, "args": list(args), "dtype": dtype, "offset": offset,
            "frame": frame}


def _functions(group: str, cols: dict) -> list:
    x, i, b, dflt = cols["x"], cols["i"], cols["b"], cols["default"]
    if group == "ranking":
        return [_fn("row_number", dtype=np.int64),
                _fn("rank", dtype=np.int64),
                _fn("dense_rank", dtype=np.int64),
                _fn("percent_rank"), _fn("cume_dist"),
                _fn("ntile", dtype=np.int64, offset=3),
                _fn("ntile", dtype=np.int64, offset=N + 5)]
    if group == "navigation":
        out = [_fn("lag", [x]), _fn("lag", [i], np.int64, offset=3),
               _fn("lead", [x], offset=2),
               _fn("lead", [i], np.int64, offset=N + 1),
               # an explicit default, evaluated at the current row
               _fn("lag", [x, (dflt[0].astype(np.float64), dflt[1])],
                   offset=2),
               _fn("lead", [i, dflt], np.int64, offset=1),
               _fn("lag", [b, (np.zeros(N, bool), None)], np.bool_)]
        for fr in FRAMES:
            out += [_fn("first_value", [x], frame=fr),
                    _fn("last_value", [i], np.int64, frame=fr),
                    _fn("nth_value", [x], offset=2, frame=fr)]
        return out
    if group == "aggregates":
        out = []
        for fr in FRAMES:
            out += [_fn("count", [x], np.int64, frame=fr),
                    _fn("count_star", [], np.int64, frame=fr),
                    _fn("sum", [i], np.int64, frame=fr),
                    _fn("sum", [x], frame=fr), _fn("avg", [x], frame=fr)]
        return out + [_fn("avg", [i], frame=FRAMES[4])]
    if group == "min_max":
        # doubles (with NaN) over every supported frame; integers and
        # booleans over one frame of each of the three scan routes
        out = []
        for fr in MINMAX_FRAMES:
            for fn in ("min", "max"):
                out.append(_fn(fn, [cols["x_nan"]], frame=fr))
                if fr == DEFAULT or fr[1] == "CURRENT":  # running, reverse
                    out.append(_fn(fn, [i], np.int64, frame=fr))
                if fr == FRAMES[2]:  # the whole partition
                    out.append(_fn(fn, [b], np.bool_, frame=fr))
        return out
    raise ValueError(group)


def _prefix_bound(f: dict) -> float:
    """n * 2^-53 * max |prefix| for a framed sum / avg of doubles."""
    (x, v), = f["args"]
    if not np.issubdtype(x.dtype, np.floating):
        return 0.0
    return N * 2.0 ** -53 * float(np.abs(np.where(v, x, 0.0)).sum())


def _assert_same(functions, got, want):
    assert len(got) == len(want) == len(functions)
    for f, (gd, gv), (rd, rv) in zip(functions, got, want):
        what = (f["fn"], f["offset"], f["frame"])
        gd, gv = gd.numpy(), gv.numpy()
        rd, rv = np.asarray(rd), np.asarray(rv)
        assert gd.dtype == rd.dtype, what
        np.testing.assert_array_equal(gv, rv, err_msg=str(what))
        if gd.dtype.kind != "f":
            np.testing.assert_array_equal(gd[rv], rd[rv], err_msg=str(what))
            continue
        atol = _prefix_bound(f) if f["fn"] in ("sum", "avg") else 0.0
        for a, b in zip(gd[rv], rd[rv]):
            assert (math.isnan(a) and math.isnan(b)) or math.isclose(
                a, b, rel_tol=RTOL, abs_tol=atol), (what, a, b)


@pytest.mark.parametrize("group", ["ranking", "navigation", "aggregates",
                                   "min_max"])
@pytest.mark.parametrize("keys", list(KEY_CASES))
def test_compute_windows_matches_reference(keys, group):
    part, order = KEY_CASES[keys]
    functions = _functions(group, _inputs(len(keys) * 31 + len(group)))
    got = wk.compute_windows(part, order, functions, N)
    want = ref_wk.compute_windows(part, order, functions, N)
    _assert_same(functions, got, want)


def test_ntile_more_tiles_than_rows_and_edges_by_hand():
    """Two partitions of 3 and 1 rows: ntile(5) numbers each row, lead
    past the end is NULL, a FOLLOWING-only frame is empty on the last
    rows."""
    part = (np.array([0, 0, 0, 1], np.int64), None)
    order = (np.array([3, 1, 2, 9], np.int64), None, True, False)
    x = (np.array([10, 20, 30, 40], np.int64), None)
    fns = [_fn("ntile", dtype=np.int64, offset=5),
           _fn("lead", [x], np.int64),
           _fn("sum", [x], np.int64,
               frame=("ROWS", "FOLLOWING", 1, "FOLLOWING", 3))]
    (nt, _), (ld, ldv), (s, sv) = wk.compute_windows([part], [order], fns, 4)
    # sorted per partition: rows 1, 2, 0 | 3
    assert nt.tolist() == [3, 1, 2, 1]
    assert ldv.tolist() == [False, True, True, False]
    assert ld.tolist()[1:3] == [30, 10]
    assert sv.tolist() == [False, True, True, False]
    assert s.tolist()[1:3] == [40, 10]


UNSUPPORTED = {
    "sliding_min": _fn("min", [(np.arange(N, dtype=np.int64), None)],
                       np.int64,
                       frame=("ROWS", "PRECEDING", 1, "FOLLOWING", 1)),
    "sliding_max": _fn("max", [(np.arange(N, dtype=np.float64), None)],
                       frame=("ROWS", "PRECEDING", 2, "CURRENT", None)),
    "range_offset_start": _fn("sum", [(np.arange(N, dtype=np.int64), None)],
                              np.int64,
                              frame=("RANGE", "PRECEDING", 1, "CURRENT",
                                     None)),
    "range_offset_end": _fn("first_value",
                            [(np.arange(N, dtype=np.int64), None)],
                            np.int64,
                            frame=("RANGE", "CURRENT", None, "FOLLOWING",
                                   2)),
}


@pytest.mark.parametrize("case", list(UNSUPPORTED))
def test_unsupported_frames_raise_in_both(case):
    part, order = KEY_CASES["int_ties"]
    fns = [UNSUPPORTED[case]]
    with pytest.raises(NotImplementedError) as want:
        ref_wk.compute_windows(part, order, fns, N)
    with pytest.raises(NotImplementedError) as got:
        wk.compute_windows(part, order, fns, N)
    assert str(got.value) == str(want.value)


def test_results_stay_on_the_inputs_device():
    """Without a device argument the evaluation runs where the input
    tensors lie (the meta device stands in for the card here): nothing is
    moved to the CPU unasked.  Numpy inputs run on the CPU, and tensors on
    two devices raise."""
    import torch

    part = (torch.tensor([0, 0, 0, 1], device="meta"), None)
    order = (torch.tensor([3, 1, 2, 9], device="meta"), None, True, False)
    x = (torch.tensor([10, 20, 30, 40], device="meta"), None)
    fns = [_fn("row_number", dtype=np.int64), _fn("sum", [x], np.int64)]
    for data, valid in wk.compute_windows([part], [order], fns, 4):
        assert data.device.type == valid.device.type == "meta"
    host = [(np.array([0, 0, 0, 1], np.int64), None)]
    for data, valid in wk.compute_windows(host, [], fns[:1], 4):
        assert data.device.type == valid.device.type == "cpu"
    with pytest.raises(ValueError, match="several devices"):
        wk.compute_windows([(torch.zeros(4, dtype=torch.int64), None)],
                           [order], fns, 4)

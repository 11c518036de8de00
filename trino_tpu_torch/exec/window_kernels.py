"""Window-function evaluation on tensors.

The port of the reference ``exec/window_kernels.py`` (WindowOperator's
per-function frame machinery: operator/WindowOperator.java:69,
operator/window/FramedWindowFunction.java).  The reference lowers the
whole computation into one jitted XLA program per window spec; here the
same steps are plain torch ops on the batch's device, with no host sync:

- a lexsort of the partition keys (major) then the order keys, with the
  reference's key transform (desc flip, NaN rank, NULL rank; the data under
  a NULL is not zeroed, so tied NULL rows keep the reference's order);
- partition / peer boundaries from neighbour compares on the sorted keys
  (NaN-aware, validity-aware);
- each row's partition and peer-group bounds from a scatter of the run
  starts by run number and a gather back: the same integers as the
  reference's ``cummax`` / reversed ``cummin``, whose torch CUDA versions
  took ~17 ms each over 6 M rows on an H100 (tools/window_profile.py);
- ranking functions as index arithmetic over those bounds;
- framed count / sum / avg as differences of prefix sums, and min / max as
  a segmented scan (a log-step doubling scan: min and max are exact under
  any association);
- lag / lead / first_value / last_value / nth_value as clamped gathers;
- one gather back to input row order.

XLA clamps an out-of-range gather index and the reference relies on it (a
frame such as ``rows between 1 following and 3 following`` reads past the
last row, and the result is masked afterwards); torch raises, so every
such index is clamped here explicitly.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch

from ..spi.batch import as_tensor, torch_dtype
from .kernels import _canon_float, _neq, lexsort

__all__ = ["compute_windows", "WINDOW_RANK_FNS", "WINDOW_VALUE_FNS",
           "WINDOW_AGG_FNS"]

WINDOW_RANK_FNS = {"row_number", "rank", "dense_rank", "percent_rank",
                   "cume_dist", "ntile"}
WINDOW_VALUE_FNS = {"lag", "lead", "first_value", "last_value", "nth_value"}
WINDOW_AGG_FNS = {"count", "count_star", "sum", "avg", "min", "max"}


def _sort_transform(d, ascending: bool, valid, nulls_first: bool):
    """Lexsort columns for one key (minor-to-major fragments: value, then
    the NaN rank, then the NULL rank), the reference's rules."""
    cols = []
    is_float = d.is_floating_point()
    if not ascending:
        if d.dtype == torch.bool:
            d = ~d
        elif is_float:
            d = -d.to(torch.float64)
        else:
            d = ~d.to(torch.int64)
    if is_float:
        nan = torch.isnan(d)
        nan_rank = torch.where(nan, 1 if ascending else 0,
                               0 if ascending else 1)
        d = torch.where(nan, torch.zeros((), dtype=d.dtype, device=d.device),
                        d)
        cols.append(d)
        cols.append(nan_rank)
    else:
        cols.append(d)
    if valid is not None:
        null_rank = (torch.where(valid, 1, 0) if nulls_first
                     else torch.where(valid, 0, 1))
        cols.append(null_rank)
    return cols


def _starts(diff):
    """Row 0 always starts a run."""
    return torch.cat([torch.ones(1, dtype=torch.bool, device=diff.device),
                      diff])


def _boundary(datas, valids, n: int, device):
    """True where sorted row i starts a new run of the given key columns."""
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=device)
    new = None
    for d, v in zip(datas, valids):
        if d.is_floating_point():
            d = _canon_float(d)
        if v is not None:
            d = torch.where(v, d, torch.zeros((), dtype=d.dtype,
                                              device=d.device))
        diff = _starts(_neq(d[1:], d[:-1]))
        if v is not None:
            diff = diff | _starts(v[1:] != v[:-1])
        new = diff if new is None else (new | diff)
    if new is None:
        new = torch.zeros(n, dtype=torch.bool, device=device)
        new[0] = True
    return new


def _seg_scan(op, x, starts):
    """Segmented inclusive scan: ``op`` accumulates within runs delimited by
    ``starts`` (True = first row of a segment).  A Hillis-Steele doubling
    scan with the reference's combine ``(where(fb, vb, op(va, vb)),
    fa | fb)``: ceil(log2 n) elementwise steps."""
    v, f = x, starts
    n = int(x.shape[0])
    d = 1
    while d < n:
        nv = torch.where(f[d:], v[d:], op(v[:-d], v[d:]))
        nf = f[d:] | f[:-d]
        v = torch.cat([v[:d], nv])
        f = torch.cat([f[:d], nf])
        d <<= 1
    return v


def _run_bounds(starts, arange):
    """(first, last) sorted index of the run each row is in, from the
    run-start flags (row 0 always starts a run).  The reference takes the
    first from a running max of the start indices and the last from a
    reversed running min (``_suffix_min_index``); here each run's start is
    scattered into a table at its run number and gathered back, with the
    table's slot after the last run holding n."""
    n = int(arange.shape[0])
    run = torch.cumsum(starts, 0)  # 1-based run number
    table = torch.full((n + 2,), n, dtype=torch.int64, device=arange.device)
    # rows that start no run all write slot 0, which nothing reads
    table[torch.where(starts, run, 0)] = arange
    return table[run], table[run + 1] - 1


def _prefix_upto(x):
    """Partition-relative inclusive prefix sum at any sorted index j:
    ``upto(j, start)`` = sum of x[start..j], 0 when j < start.  ``j + 1``
    is clamped into the prefix array as XLA clamps a gather index (the
    reference's FOLLOWING frames ask past the last row; the caller masks
    those rows)."""
    cs0 = torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device),
                     torch.cumsum(x, 0)])  # cs0[j+1] = sum x[0..j]
    last = int(cs0.shape[0]) - 1

    def upto(j, start):
        j = torch.maximum(j, start - 1)
        return cs0[torch.clamp(j + 1, 0, last)] - cs0[start]

    return upto


def _frame_indices(frame, arange, part_start_idx, part_end_idx,
                   peer_start_idx, peer_end_idx):
    """(frame_start, frame_end) sorted indices per row (unclamped)."""
    unit, sk, sv, ek, ev = frame
    if unit == "RANGE":
        if sk in ("PRECEDING", "FOLLOWING") or ek in ("PRECEDING", "FOLLOWING"):
            raise NotImplementedError("RANGE frames with numeric offsets")
        cur_s, cur_e = peer_start_idx, peer_end_idx
    else:
        cur_s, cur_e = arange, arange
    if sk == "UNBOUNDED_PRECEDING":
        fs = part_start_idx
    elif sk == "CURRENT":
        fs = cur_s
    elif sk == "PRECEDING":
        fs = arange - sv
    elif sk == "FOLLOWING":
        fs = arange + sv
    else:
        raise NotImplementedError(f"frame start {sk}")
    if ek == "UNBOUNDED_FOLLOWING":
        fe = part_end_idx
    elif ek == "CURRENT":
        fe = cur_e
    elif ek == "FOLLOWING":
        fe = arange + ev
    elif ek == "PRECEDING":
        fe = arange - ev
    else:
        raise NotImplementedError(f"frame end {ek}")
    return fs, fe


class _Sorted:
    """The sorted input's boundaries, shared by every function of a spec."""

    def __init__(self, n: int, perm, arange, part_start, peer_start):
        self.n = n
        self.perm = perm
        self.arange = arange
        self.part_start = part_start
        self.peer_start = peer_start
        self.part_start_idx, self.part_end_idx = _run_bounds(part_start,
                                                             arange)
        self.peer_start_idx, self.peer_end_idx = _run_bounds(peer_start,
                                                             arange)
        self.part_last = torch.cat([
            part_start[1:],
            torch.ones(1, dtype=torch.bool, device=arange.device)])
        self.part_rows = self.part_end_idx - self.part_start_idx + 1

    def frame(self, frame):
        """Frame bounds clamped to the partition."""
        fs, fe = _frame_indices(frame, self.arange, self.part_start_idx,
                                self.part_end_idx, self.peer_start_idx,
                                self.peer_end_idx)
        return (torch.maximum(fs, self.part_start_idx),
                torch.minimum(fe, self.part_end_idx))


def _zero(t):
    return torch.zeros((), dtype=t.dtype, device=t.device)


def _evaluate(s: _Sorted, fn: str, args: list, offset: int, frame,
              dtype: torch.dtype):
    """One window function over the sorted rows: (data, valid) in sorted
    order (the reference's ``_window_program`` body)."""
    n, arange = s.n, s.arange
    ones = torch.ones(n, dtype=torch.bool, device=arange.device)
    x, xv = args[0] if args else (None, None)
    xs = None if x is None else x[s.perm]
    xvs = ones if (x is None or xv is None) else xv[s.perm]

    if fn == "row_number":
        return (arange - s.part_start_idx + 1).to(dtype), ones
    if fn == "rank":
        return (s.peer_start_idx - s.part_start_idx + 1).to(dtype), ones
    if fn == "dense_rank":
        cs = torch.cumsum(s.peer_start.to(torch.int64), 0)
        return (cs - cs[s.part_start_idx] + 1).to(dtype), ones
    if fn == "percent_rank":
        rank = s.peer_start_idx - s.part_start_idx + 1
        denom = torch.clamp(s.part_rows - 1, min=1)
        res = torch.where(s.part_rows == 1, 0.0,
                          (rank - 1).to(torch.float64)
                          / denom.to(torch.float64))
        return res, ones
    if fn == "cume_dist":
        res = ((s.peer_end_idx - s.part_start_idx + 1).to(torch.float64)
               / s.part_rows.to(torch.float64))
        return res, ones
    if fn == "ntile":
        tiles = offset
        rn0 = arange - s.part_start_idx  # 0-based row number
        size = s.part_rows // tiles
        rem = s.part_rows % tiles
        big = rem * (size + 1)
        res = torch.where(rn0 < big,
                          rn0 // torch.clamp(size + 1, min=1),
                          rem + (rn0 - big) // torch.clamp(size, min=1)) + 1
        # more tiles than rows: every row its own tile
        return torch.where(size == 0, rn0 + 1, res).to(dtype), ones
    if fn in ("lag", "lead"):
        j = arange - offset if fn == "lag" else arange + offset
        in_part = (j >= s.part_start_idx) & (j <= s.part_end_idx)
        jc = torch.clamp(j, 0, n - 1)
        got, gotv = xs[jc], xvs[jc]
        if len(args) > 1:  # explicit default (evaluated at the current row)
            dd, dv = args[1]
            dds = dd[s.perm]
            ddv = ones if dv is None else dv[s.perm]
            res = torch.where(in_part, got, dds.to(got.dtype))
            val = torch.where(in_part, gotv, ddv)
        else:
            res = torch.where(in_part, got, _zero(got))
            val = in_part & gotv
        return res.to(dtype), val
    if fn in ("first_value", "last_value", "nth_value"):
        fs, fe = s.frame(frame)
        nonempty = fs <= fe
        if fn == "first_value":
            j = fs
        elif fn == "last_value":
            j = fe
        else:
            j = fs + (offset - 1)
            nonempty = nonempty & (j <= fe)
        jc = torch.clamp(j, 0, n - 1)
        res = torch.where(nonempty, xs[jc], _zero(xs))
        return res.to(dtype), nonempty & xvs[jc]
    if fn not in WINDOW_AGG_FNS:
        raise NotImplementedError(f"window function {fn}")
    # framed aggregate
    fs, fe = s.frame(frame)
    if fn == "count_star":
        return torch.clamp(fe - fs + 1, min=0).to(dtype), ones
    cnt_upto = _prefix_upto(xvs.to(torch.int64))
    cnt = torch.clamp(cnt_upto(fe, s.part_start_idx)
                      - cnt_upto(fs - 1, s.part_start_idx), min=0)
    if fn == "count":
        return cnt.to(dtype), ones
    if fn in ("sum", "avg"):
        acc = torch.where(xvs, xs, _zero(xs)).to(
            dtype if fn == "sum" else torch.float64)
        upto = _prefix_upto(acc)
        total = (upto(fe, s.part_start_idx)
                 - upto(fs - 1, s.part_start_idx))
        if fn == "sum":
            res = total.to(dtype)
        else:
            res = (total / torch.clamp(cnt, min=1)).to(dtype)
        return res, cnt > 0
    # min / max: frames that start at the partition head (running), end at
    # its tail (reverse running), or span it whole
    op = torch.minimum if fn == "min" else torch.maximum
    if xs.is_floating_point():
        sent = float("inf") if fn == "min" else float("-inf")
    elif xs.dtype == torch.bool:
        sent = fn == "min"
    else:
        info = torch.iinfo(xs.dtype)
        sent = info.max if fn == "min" else info.min
    acc = torch.where(xvs, xs, torch.full((), sent, dtype=xs.dtype,
                                          device=xs.device))
    _unit, sk, _sv, ek, _ev = frame
    if sk == "UNBOUNDED_PRECEDING" and ek != "UNBOUNDED_FOLLOWING":
        res = _seg_scan(op, acc, s.part_start)[torch.clamp(fe, 0, n - 1)]
    elif ek == "UNBOUNDED_FOLLOWING" and sk != "UNBOUNDED_PRECEDING":
        rev_run = torch.flip(_seg_scan(op, torch.flip(acc, [0]),
                                       torch.flip(s.part_last, [0])), [0])
        res = rev_run[torch.clamp(fs, 0, n - 1)]
    elif sk == "UNBOUNDED_PRECEDING":
        res = _seg_scan(op, acc, s.part_start)[s.part_end_idx]
    else:
        raise NotImplementedError(f"window {fn} over sliding frame {frame}")
    val = cnt > 0
    return torch.where(val, res, _zero(res)).to(dtype), val


def _input_device(partition_keys, order_keys, functions, device):
    """``device`` if given, else the one device of the tensor inputs (the
    CPU when there are none); a tensor is never moved unasked."""
    if device is not None:
        return torch.device(device)
    found = {x.device for x in itertools.chain(
        (x for key in partition_keys for x in key[:2]),
        (x for key in order_keys for x in key[:2]),
        (x for f in functions for arg in f.get("args", []) for x in arg))
        if isinstance(x, torch.Tensor)}
    if len(found) > 1:
        raise ValueError(f"window inputs on several devices: {found}")
    return found.pop() if found else torch.device("cpu")


def compute_windows(
    partition_keys: Sequence[tuple],  # [(data, valid|None), ...]
    order_keys: Sequence[tuple],  # [(data, valid|None, asc, nulls_first), ...]
    functions: Sequence[dict],
    num_rows: int,
    device=None,
) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Evaluate window functions over one materialized input.

    ``functions``: per call a dict with keys ``fn``, ``args``
    ([(data, valid|None), ...]), ``offset`` (int; lag/lead/ntile/nth_value
    constant), ``frame`` ((unit, start_kind, start_val, end_kind, end_val)),
    ``dtype`` (output numpy dtype).  Inputs are numpy arrays or tensors;
    returns per call (data, valid) in the ORIGINAL row order, as tensors on
    ``device``: by default the device of the input tensors (the CPU when
    every input is a numpy array).  Tensors on two devices raise.
    """
    device = _input_device(partition_keys, order_keys, functions, device)

    def dev(x):
        return None if x is None else as_tensor(x, device)

    n = int(num_rows)
    arange = torch.arange(n, device=device)
    part = [(dev(d), dev(v)) for d, v in partition_keys]
    order = [(dev(d), dev(v), bool(asc), bool(nf))
             for d, v, asc, nf in order_keys]

    # ---- sort: partition keys (major) then order keys ---------------------
    lex = []  # minor-to-major
    for d, v, asc, nf in reversed(order):
        lex.extend(_sort_transform(d, asc, v, nf))
    for d, v in reversed(part):
        lex.extend(_sort_transform(d, True, v, False))
    perm = lexsort(lex) if lex else arange

    # ---- boundaries -------------------------------------------------------
    part_start = _boundary([d[perm] for d, _ in part],
                           [None if v is None else v[perm] for _, v in part],
                           n, device)
    peer_start = part_start
    if order:
        peer_start = part_start | _boundary(
            [d[perm] for d, _, _, _ in order],
            [None if v is None else v[perm] for _, v, _, _ in order],
            n, device)
    s = _Sorted(n, perm, arange, part_start, peer_start)

    # ---- functions, then one gather back to input row order ---------------
    inverse = torch.empty_like(perm)
    inverse[perm] = arange
    outs = []
    for f in functions:
        args = [(dev(d), dev(v)) for d, v in f.get("args", [])]
        res, val = _evaluate(s, f["fn"], args, int(f.get("offset", 1)),
                             tuple(f["frame"]),
                             torch_dtype(np.dtype(f["dtype"])))
        outs.append((res[inverse], val[inverse]))
    return outs

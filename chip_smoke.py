#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (trino_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the final line; they run in
the order 1-5, 7, 8, 6, 9, so the kernel phase holds the staged path's
calls too):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from trino_tpu_torch/csrc/*.cu (nvcc, sm_90a);
  3. path: the 22 TPC-H queries and the two REAL-sum queries R1, R2 at SF 1
     through StandaloneQueryRunner on cuda over the tpch connector (host
     generation) -- cold and warm wall time, peak device memory and kernel
     launches per query; Q1, Q3, Q12, R1 and R2 rows checked against a
     plain numpy evaluation on the same generated data;
  4. parity: all 24 queries at SF 0.1 on cuda and on cpu (and numpy for
     the five above);
  5. per-operator time of one synchronized run of a subset of the queries;
  6. kernels: each kernel on the inputs the paths give it (recorded in one
     more run of that subset on each path, apart from the path runs), held
     against its plain torch version (exact for group ids, counts and probe
     ids; the float32 segment sums to the tolerances stated below), timed
     beside the plain version and one PyTorch library call (in turns:
     kernel, library, library, kernel), with its bound, the raw launch
     alone, the raw launch replayed from a CUDA graph (device time) and the
     host time per wrapper call (and, for the probe and the segment sum,
     per piece of its launch path).  The segment sum is also run on R2's
     rows with a seeded 50 % live mask and under a seeded permutation, and
     torch.sum over R2's values gives the read rate of a library reduction
     on the card.  Each kernel also gets the largest call of the staged
     path (phase 8), labelled "staged";
  7. staging: the eight TPC-H tables at SF 1 into the memory connector on
     cuda (connectors/staging.py: orders and lineitem generated on the
     card, the others from the host generator and pinned), each table's
     rows, bytes, seconds and route and the staging's peak device memory;
     the staged orders and lineitem checked column by column against the
     host generator (bit-identical);
  8. the staged path: the 24 queries over the memory tables with one split
     per table (default_catalog_name="memory", splits_per_node=1), cold
     and warm, peak memory and launches as in phase 3; rows equal phase
     3's (the REAL sums against the numpy evaluation), then per-operator
     times as in phase 5 for the subset and the three slowest other
     queries;
  9. SF 10: Q1 and Q3 (the texts of bench.py's QUERIES) over lineitem,
     orders and customer staged on cuda, cold and warm, with input rows/s
     and scanned GB/s from the plans' table scans (held below the HBM
     rate), rows checked against the numpy evaluation of the staged
     columns.
It prints the card line and one JSON line of kernels, and ends with
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import datetime
import decimal
import json
import math
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
SECTOR = 32  # bytes of the smallest device-memory access
ENQUEUE_CALLS = 200  # wrapper calls per host-enqueue measurement
GRAPH_REPS = 20  # raw launches per CUDA graph (device-only time)

PATH_SF = 1.0
PARITY_SF = 0.1
# REAL sums per small integer category (GROUP BY keys that are not
# dictionary codes, at most 64 groups): the masked_segment_sum_f32 route
REAL_QUERIES = {
    "R1": ("select l_linenumber, sum(cast(l_quantity as real)), "
           "sum(cast(l_extendedprice as real)) from lineitem "
           "group by l_linenumber order by l_linenumber"),
    "R2": ("select l_quantity, sum(cast(l_extendedprice as real)) "
           "from lineitem group by l_quantity order by l_quantity"),
}
ORACLE_QUERIES = ("Q1", "Q3", "Q12", "R1", "R2")
# the per-operator and kernel-capture phases run on this subset only
CAPTURE_QUERIES = ("Q1", "Q3", "Q12", "Q18", "Q21", "R1", "R2")
# float tolerances: doubles (averages, ratios) differ only by summation
# order; a REAL sum is a float32 sum.  The kernel adds in a fixed per-thread
# then tree order (a numpy model of it is ~2e-7 from the float64 sum at
# SF 1), while the plain version is a scatter-add into one float32 slot per
# group, which drifts up to ~3e-4 at SF 1 (860 k rows per group) and ~8e-6
# at SF 0.1 (same model, sequential order).
DOUBLE_RTOL = 1e-9
KERNEL_VS_F64_RTOL = 1e-5  # the kernel route against float64 numpy sums
PLAIN_VS_F64_RTOL = 1e-3  # the plain version (scatter-add) at SF 1, and
                          # the kernel against the plain version
REAL_PARITY_RTOL = 1e-4  # cuda (kernel) vs cpu (plain) at SF 0.1


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# plain numpy evaluation of the queries (independent of the engine)


def _days(y: int, m: int, d: int) -> int:
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


class Strings:
    """A dictionary-coded string column of the numpy evaluation, compared
    and grouped in code space (decoding SF 10's 60 M rows into python
    strings would take minutes)."""

    def __init__(self, codes: np.ndarray, dictionary):
        self.codes = codes
        self.dictionary = np.asarray(dictionary, dtype=object)

    def __getitem__(self, idx) -> "Strings":
        return Strings(self.codes[idx], self.dictionary)

    def isin(self, values) -> np.ndarray:
        hit = np.isin(self.dictionary, np.array(list(values), dtype=object))
        return hit[self.codes]

    def values(self) -> list:
        """The distinct strings present, sorted."""
        return sorted(str(v) for v in self.dictionary[np.unique(self.codes)])


def _numpy_columns(batch) -> dict:
    out = {}
    for name, c in zip(batch.names, batch.columns):
        data = c.data.cpu().numpy()
        out[name] = (Strings(data, c.dictionary)
                     if c.dictionary is not None else data)
    return out


def host_reader(conn):
    """(table, columns) -> numpy columns from the host TPC-H generator."""
    def read(table: str, cols: list[str]) -> dict:
        n = conn.row_count("orders" if table == "lineitem" else table)
        return _numpy_columns(conn._generate(table, cols, 0, n))
    return read


def staged_reader(mem):
    """(table, columns) -> numpy columns of a staged memory table, copied
    from the device."""
    def read(table: str, cols: list[str]) -> dict:
        (split,) = mem.get_splits(table, 1, 1)
        return _numpy_columns(
            mem.create_page_source(split, cols).get_next_batch())
    return read


def _dec(v: int, scale: int) -> decimal.Decimal:
    return decimal.Decimal(int(v)).scaleb(-scale)


def oracle(read, q: int) -> list[tuple]:
    if q == 1:
        li = read("lineitem", [
            "l_quantity", "l_extendedprice", "l_discount", "l_tax",
            "l_returnflag", "l_linestatus", "l_shipdate"])
        m = li["l_shipdate"] <= _days(1998, 12, 1) - 90
        rf_col, ls_col = li["l_returnflag"], li["l_linestatus"]
        rows = []
        for rf in rf_col[m].values():
            for ls in ls_col[m].values():
                g = m & rf_col.isin([rf]) & ls_col.isin([ls])
                n = int(g.sum())
                if not n:
                    continue
                qty, ext = li["l_quantity"][g], li["l_extendedprice"][g]
                disc, tax = li["l_discount"][g], li["l_tax"][g]
                rows.append((
                    rf, ls, _dec(qty.sum(), 2), _dec(ext.sum(), 2),
                    _dec((ext * (100 - disc)).sum(), 4),
                    _dec((ext * (100 - disc) * (100 + tax)).sum(), 6),
                    float((qty / 100.0).sum() / n),
                    float((ext / 100.0).sum() / n),
                    float((disc / 100.0).sum() / n), n))
        return rows
    if q == 3:
        cu = read("customer", ["c_custkey", "c_mktsegment"])
        od = read("orders", ["o_orderkey", "o_custkey", "o_orderdate",
                             "o_shippriority"])
        li = read("lineitem", ["l_orderkey", "l_extendedprice",
                               "l_discount", "l_shipdate"])
        cut = _days(1995, 3, 15)
        building = np.zeros(int(cu["c_custkey"].max()) + 1, bool)
        building[cu["c_custkey"][cu["c_mktsegment"].isin(["BUILDING"])]] = (
            True)
        om = (od["o_orderdate"] < cut) & building[od["o_custkey"]]
        okeys = od["o_orderkey"]
        order = np.argsort(okeys)
        lm = li["l_shipdate"] > cut
        lk = li["l_orderkey"][lm]
        pos = np.clip(np.searchsorted(okeys[order], lk), 0, len(okeys) - 1)
        oi = order[pos]
        hit = (okeys[oi] == lk) & om[oi]
        rev = (li["l_extendedprice"][lm] * (100 - li["l_discount"][lm]))[hit]
        uo, inv = np.unique(oi[hit], return_inverse=True)
        sums = np.zeros(len(uo), np.int64)
        np.add.at(sums, inv, rev)
        dates = od["o_orderdate"][uo]
        top = np.lexsort((dates, -sums))[:10]
        return [(int(okeys[uo[i]]), _dec(sums[i], 4),
                 datetime.date(1970, 1, 1) + datetime.timedelta(
                     days=int(dates[i])),
                 int(od["o_shippriority"][uo[i]])) for i in top]
    if q == 12:
        od = read("orders", ["o_orderkey", "o_orderpriority"])
        li = read("lineitem", [
            "l_orderkey", "l_shipdate", "l_commitdate", "l_receiptdate",
            "l_shipmode"])
        m = (li["l_shipmode"].isin(["MAIL", "SHIP"])
             & (li["l_commitdate"] < li["l_receiptdate"])
             & (li["l_shipdate"] < li["l_commitdate"])
             & (li["l_receiptdate"] >= _days(1994, 1, 1))
             & (li["l_receiptdate"] < _days(1995, 1, 1)))
        okeys = od["o_orderkey"]
        order = np.argsort(okeys)
        pos = order[np.searchsorted(okeys[order], li["l_orderkey"][m])]
        high = od["o_orderpriority"][pos].isin(["1-URGENT", "2-HIGH"])
        modes = li["l_shipmode"][m]
        return [(mode, int((high & modes.isin([mode])).sum()),
                 int((~high & modes.isin([mode])).sum()))
                for mode in modes.values()]
    raise ValueError(q)


def real_oracle(read, name: str) -> list[tuple]:
    """R1 / R2: float64 sums of the float32-cast values per key."""
    li = read("lineitem", ["l_linenumber", "l_quantity", "l_extendedprice"])
    key = li["l_linenumber"] if name == "R1" else li["l_quantity"]
    sums = ["l_quantity", "l_extendedprice"] if name == "R1" else [
        "l_extendedprice"]
    uk, inv = np.unique(key, return_inverse=True)
    cols = [np.bincount(inv, weights=(li[c] / 100.0).astype(
        np.float32).astype(np.float64), minlength=len(uk)) for c in sums]
    keys = [int(k) if name == "R1" else _dec(k, 2) for k in uk]
    return [(k, *(float(c[i]) for c in cols)) for i, k in enumerate(keys)]


def evaluate(read, name: str) -> list[tuple]:
    return (real_oracle(read, name) if name in REAL_QUERIES
            else oracle(read, int(name[1:])))


def same_rows(got: list, want: list, what: str,
              rel_tol: float = DOUBLE_RTOL) -> float:
    """Rows equal: exact, floats to ``rel_tol``.  Returns the largest
    relative float difference seen."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} rows, expected "
                             f"{len(want)}")
    worst = 0.0
    for g, w in zip(got, want):
        if len(g) != len(w):
            raise AssertionError(f"{what}: row {g} != {w}")
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                ok = math.isclose(a, b, rel_tol=rel_tol)
                if b:
                    worst = max(worst, abs(a - b) / abs(b))
            else:
                ok = a == b
            if not ok:
                raise AssertionError(f"{what}: row {g} != {w}")
    return worst


# ---------------------------------------------------------------------------
# timing


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def enqueue_us(torch, fn, calls: int = ENQUEUE_CALLS) -> float:
    """Host time per call: a host clock around ``calls`` back-to-back calls
    with no synchronize in between (one after the last)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def graph_ms(torch, fn, reps: int = GRAPH_REPS) -> float:
    """Device time per call of ``fn`` (launches only: no allocation, no
    sync): ``reps`` calls captured in one CUDA graph, the graph replayed
    under CUDA events, so the host's launch rate does not bound the time
    as it does for back-to-back calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    ms = cuda_ms(torch, graph.replay, 5, warmup=1) / reps
    del graph
    return ms


def in_turns(torch, kernel, library, iters: int) -> tuple:
    """Kernel and library call timed in turns (kernel, library, library,
    kernel); returns the mean of each pair and the four times in order."""
    k1 = cuda_ms(torch, kernel, iters)
    l1 = cuda_ms(torch, library, iters)
    l2 = cuda_ms(torch, library, iters)
    k2 = cuda_ms(torch, kernel, iters)
    return (k1 + k2) / 2, (l1 + l2) / 2, [k1, l1, l2, k2]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _insert_case(torch, GK, orig_insert, orig_probe, args):
    planes, h32, live, S = args
    live_t = live if live is not None else torch.ones(
        planes.shape[1], dtype=torch.bool, device=planes.device)
    got = orig_insert(planes, h32, live, S)
    want = GK.hash_insert_plain(planes, h32, live_t, S)
    torch.cuda.synchronize()
    if got[1] != want[1] or not torch.equal(got[0], want[0]):
        raise AssertionError("cuda hash_insert != plain")
    err = int((got[0].long() - want[0].long()).abs().max())
    # cross-probe: each table read by the other version's probe
    a = GK.hash_probe_plain(got[2], got[3], planes, h32, live_t)
    b = orig_probe(want[2], want[3], planes, h32, live_t)
    expect = torch.where(live_t, got[0], -1)
    if not (torch.equal(a, expect) and torch.equal(b, expect)):
        raise AssertionError("hash_insert cross-probe mismatch")
    ms, lib_ms, turns = in_turns(
        torch, lambda: orig_insert(planes, h32, live, S),
        lambda: torch.unique(planes, dim=1, return_inverse=True), 10)
    # the kernels alone: the raw launch (all six kernels), without the
    # wrapper's allocations, checks and host sync
    P, n = planes.shape
    lib = GK._lib()  # loaded, so the launch geometry is known
    dev = planes.get_device()
    buckets = torch.empty((S, GK.bucket_width(P)), dtype=torch.int32,
                          device=planes.device)
    row_gid = torch.empty_like(h32)
    nb = -(-n // GK._INSERT_ROWS_PER_BLOCK)
    scratch = torch.empty(S + n + nb + 1, dtype=torch.int32,
                          device=planes.device)
    base = scratch.data_ptr()

    def raw():
        lib.hash_insert_launch(
            planes.data_ptr(), P, n, h32.data_ptr(), _ptr(live), S,
            buckets.data_ptr(), buckets.shape[1], base, base + 4 * S,
            row_gid.data_ptr(), base + 4 * (S + n), GK._stream(dev))

    alone_ms = cuda_ms(torch, raw, 10)
    device_ms = graph_ms(torch, raw)
    enq = enqueue_us(torch, lambda: orig_insert(planes, h32, live, S))
    plain_ms = cuda_ms(
        torch, lambda: GK.hash_insert_plain(planes, h32, live_t, S), 3,
        warmup=1)
    L = int(live_t.sum())
    nbytes = (P * n * 4 + n * 4 + (0 if live is None else n)  # planes, h32,
              + n * 4 + P * S * 4 + S * 4  # live; row_gid, table, ids
              + SECTOR * L)  # one random slot sector per live row
    shape = f"P={P} N={n} S={S} live={L} groups={got[1]}"
    return dict(err=err, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                nbytes=nbytes, shape=shape, alone_ms=alone_ms, enq_us=enq,
                turns=turns, extra="", device_ms=device_ms)


def _probe_case(torch, GK, orig_probe, args):
    tp, sg, planes, h32, live = args
    live_t = live if live is not None else torch.ones(
        planes.shape[1], dtype=torch.bool, device=planes.device)
    got = orig_probe(tp, sg, planes, h32, live)
    want = GK.hash_probe_plain(tp, sg, planes, h32, live_t)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("cuda hash_probe != plain")
    err = int((got.long() - want.long()).abs().max())
    # library yardstick: searchsorted of the probe hashes in the sorted
    # build hashes (the reference's sort path)
    occ = sg >= 0
    bh = ((tp[1][occ].long() << 32) | (tp[0][occ].long() & 0xFFFFFFFF))
    ph = (planes[1].long() << 32) | (planes[0].long() & 0xFFFFFFFF)
    sorted_bh = torch.sort(bh).values
    ms, lib_ms, turns = in_turns(
        torch, lambda: orig_probe(tp, sg, planes, h32, live),
        lambda: torch.searchsorted(sorted_bh, ph), 10)
    P, n = planes.shape
    S = int(sg.shape[0])
    dev = planes.get_device()
    gid = torch.empty(n, dtype=torch.int32, device=planes.device)

    def raw():
        GK._lib().hash_probe_launch(
            sg.data_ptr(), GK.bucket_width(P), S, planes.data_ptr(), P, n,
            h32.data_ptr(), _ptr(live), gid.data_ptr(), GK._stream(dev))

    alone_ms = cuda_ms(torch, raw, 20)
    device_ms = graph_ms(torch, raw)
    enq = enqueue_us(torch, lambda: orig_probe(tp, sg, planes, h32, live))
    # the wrapper's host time piece by piece (us per call)
    parts = {
        "checks": enqueue_us(torch, lambda: (
            GK._check_rows(planes, h32, live),
            GK._bucket_layout(tp, sg, P))),
        "empty_like": enqueue_us(torch, lambda: torch.empty_like(h32)),
        "current_stream().cuda_stream": enqueue_us(
            torch, lambda: torch.cuda.current_stream().cuda_stream),
        "raw stream": enqueue_us(torch, lambda: GK._stream(dev)),
        "ctypes launch": enqueue_us(torch, raw),
    }
    plain_ms = cuda_ms(
        torch, lambda: GK.hash_probe_plain(tp, sg, planes, h32, live_t), 3,
        warmup=1)
    L = int(live_t.sum())
    nbytes = (P * n * 4 + n * 4 + (0 if live is None else n) + n * 4
              + SECTOR * L)
    shape = f"P={P} N={n} S={S} live={L} hits={int((got >= 0).sum())}"
    extra = ", launch path us/call: " + ", ".join(
        f"{k} {v:.2f}" for k, v in parts.items())
    return dict(err=err, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                nbytes=nbytes, shape=shape, alone_ms=alone_ms, enq_us=enq,
                turns=turns, extra=extra, parts=parts, device_ms=device_ms)


def _segment_case(torch, GK, orig_seg, args):
    vals, gid, live, G = args
    got = orig_seg(vals, gid, live, G)
    again = orig_seg(vals, gid, live, G)
    want = GK.masked_segment_sum_f32_plain(vals, gid, live, G)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError("masked_segment_sum_f32: two runs differ")
    v, g = vals.cpu().numpy(), gid.cpu().numpy().astype(np.int64)
    ok = (g >= 0) & (g < G)
    if live is not None:
        ok &= live.cpu().numpy()
    exact = np.bincount(g[ok], weights=v[ok].astype(np.float64),
                        minlength=G)[:G]
    denom = np.maximum(np.abs(exact), 1e-30)
    k_rel = float(np.max(np.abs(got.cpu().numpy() - exact) / denom))
    p_rel = float(np.max(np.abs(want.cpu().numpy() - exact) / denom))
    if k_rel > KERNEL_VS_F64_RTOL or p_rel > PLAIN_VS_F64_RTOL:
        raise AssertionError(
            f"masked_segment_sum_f32 vs float64: kernel {k_rel:.3g} "
            f"(limit {KERNEL_VS_F64_RTOL}), plain {p_rel:.3g} "
            f"(limit {PLAIN_VS_F64_RTOL})")
    # kernel vs plain on the same inputs: within the plain version's drift
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=PLAIN_VS_F64_RTOL, atol=0.0):
        raise AssertionError(f"masked_segment_sum_f32 != plain (max abs "
                             f"diff {err}, rtol {PLAIN_VS_F64_RTOL})")
    if live is None:
        # library yardstick: one scatter-add; the ids of these inputs lie
        # in [0, G], so a G + 1 slot output takes the same rows
        if int(gid.max()) > G or int(gid.min()) < 0:
            raise AssertionError("segment-sum inputs outside the library "
                                 "call's contract")
        out = torch.zeros(G + 1, dtype=torch.float32, device=vals.device)
        ms, lib_ms, turns = in_turns(
            torch, lambda: orig_seg(vals, gid, live, G),
            lambda: out.zero_().index_add_(0, gid, vals), 20)
    else:  # no single library call takes the mask
        turns = [cuda_ms(torch, lambda: orig_seg(vals, gid, live, G), 20)
                 for _ in range(2)]
        ms, lib_ms = sum(turns) / 2, None
    n = int(vals.shape[0])
    # the raw launch: the wrapper's one kernel launch into scratch made once
    dev = vals.get_device()
    grid = GK._segment_grid(dev, G)
    buf = torch.empty((grid + 1) * G, dtype=torch.float32,
                      device=vals.device)
    base = buf.data_ptr()

    def raw():
        GK._lib().segment_sum_launch(
            vals.data_ptr(), gid.data_ptr(), _ptr(live), n, G, grid,
            base + 4 * G, base, GK._stream(dev))

    alone_ms = cuda_ms(torch, raw, 20)
    device_ms = graph_ms(torch, raw)
    enq = enqueue_us(torch, lambda: orig_seg(vals, gid, live, G))
    # the wrapper's host time piece by piece (us per call)
    parts = {
        "checks": enqueue_us(
            torch, lambda: GK._check_segment_args(vals, gid, live, G)),
        "device, stream and grid": enqueue_us(
            torch, lambda: (torch.cuda.current_device(), GK._stream(dev),
                            GK._segment_grid(dev, G))),
        "new_empty and slice": enqueue_us(
            torch, lambda: vals.new_empty(((grid + 1) * G,))[:G]),
        "raw launch": enqueue_us(torch, raw),
    }
    plain_ms = cuda_ms(
        torch, lambda: GK.masked_segment_sum_f32_plain(vals, gid, live, G),
        10)
    nbytes = n * 4 + n * 4 + (n if live is not None else 0) + G * 4
    shape = (f"N={n} G={G} live="
             + ("all" if live is None else str(int(live.sum()))))
    extra = (f", rel err vs float64: kernel {k_rel:.3g}, plain "
             f"{p_rel:.3g}, launch path us/call: "
             + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    return dict(err=err, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                nbytes=nbytes, shape=shape, alone_ms=alone_ms, enq_us=enq,
                turns=turns, extra=extra, parts=parts, device_ms=device_ms)


def _segment_variants(torch, args) -> list:
    """R2's captured call with a seeded 50 % live mask, and under one
    seeded permutation of its rows (the path's ids arrive sorted)."""
    vals, gid, live, G = args
    n = int(vals.shape[0])
    rng = np.random.default_rng(4)
    mask = torch.from_numpy(rng.random(n) < 0.5).to(vals.device)
    perm = torch.from_numpy(rng.permutation(n)).to(vals.device)
    return [("R2 masked (seeded 50 % live)", (vals, gid, mask, G)),
            ("R2 shuffled (one seeded permutation)",
             (vals[perm].contiguous(), gid[perm].contiguous(), live, G))]


def library_read_rate(torch, vals) -> str:
    """torch.sum over a float32 column: the read rate a library reduction
    reaches on this card, beside the segment sum's bound."""
    ms = cuda_ms(torch, lambda: torch.sum(vals), 20)
    out = torch.empty((), dtype=torch.float32, device=vals.device)
    dev_ms = graph_ms(torch, lambda: torch.sum(vals, 0, out=out))
    nbytes = vals.numel() * 4
    return (f"library reduction: torch.sum over {vals.numel()} float32 "
            f"({nbytes} bytes): {ms:.4f} ms = {nbytes / ms / 1e9:.3f} TB/s "
            f"back to back, {dev_ms:.4f} ms = {nbytes / dev_ms / 1e9:.3f} "
            f"TB/s on the device (CUDA graph of {GRAPH_REPS}); bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s")


SOURCES = {
    "hash_insert": ("trino_tpu_torch/csrc/hash_table.cu",
                    "trino_tpu/ops/pallas_kernels.py:139"),
    "hash_probe": ("trino_tpu_torch/csrc/hash_table.cu",
                   "trino_tpu/ops/pallas_kernels.py:199"),
    "masked_segment_sum_f32": ("trino_tpu_torch/csrc/segment_sum.cu",
                               "trino_tpu/ops/pallas_kernels.py:50"),
}


TPCH_TABLES = ("region", "nation", "supplier", "customer", "part",
               "partsupp", "orders", "lineitem")
REQUIRED = {"Q3": ["hash_insert"], "Q12": ["hash_probe"],
            "Q18": ["hash_insert"], "Q21": ["hash_insert", "hash_probe"],
            "R1": ["masked_segment_sum_f32"],
            "R2": ["masked_segment_sum_f32"]}
SF10 = 10.0
SF10_QUERIES = ("Q1", "Q3")  # bench.py's QUERIES (the same texts)
SF10_TABLES = ("customer", "orders", "lineitem")


def run_path(torch, GK, runner, sqls: dict, label: str) -> tuple:
    """Every query cold then warm: rows, (cold ms, warm ms, peak MiB) and
    kernel launches per query; fails if a query misses a REQUIRED kernel
    or a kernel never launched."""
    rows, timings, per_query = {}, {}, {}
    t_path = time.perf_counter()
    GK.reset_launch_counts()
    for name, sql in sqls.items():
        before = dict(GK.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner.execute(sql)
        torch.cuda.synchronize()
        cold = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        res = runner.execute(sql)
        torch.cuda.synchronize()
        warm = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**20
        rows[name] = res.rows()
        timings[name] = (cold, warm, peak)
        per_query[name] = {k: GK.LAUNCHES[k] - before[k]
                           for k in GK.LAUNCHES}
        log(f"{label} {name}: {len(rows[name])} rows, cold {cold:.1f} ms, "
            f"warm {warm:.1f} ms, peak device memory {peak:.1f} MiB, "
            f"launches {per_query[name]}")
    launches = dict(GK.LAUNCHES)
    log(f"{label} launches: {launches} "
        f"({time.perf_counter() - t_path:.1f} s for {len(sqls)} queries)")
    for name, kernels in REQUIRED.items():
        for k in kernels:
            if per_query[name][k] <= 0:
                raise AssertionError(f"{label} {name} launched no {k}")
    if any(v <= 0 for v in launches.values()):
        raise AssertionError(f"{label}: a kernel never launched: {launches}")
    return rows, timings, launches


def per_operator(QueryStats, runner, sqls: dict, label: str,
                 names=CAPTURE_QUERIES) -> None:
    """One run of each query of ``names`` with the device synchronized
    after every operator call."""
    for name in names:
        st = QueryStats(sync=True)
        t0 = time.perf_counter()
        runner.execute(sqls[name], stats=st)
        total = (time.perf_counter() - t0) * 1e3
        ops = ", ".join(f"{k} {v * 1e3:.1f}"
                        for k, v in sorted(st.by_operator().items(),
                                           key=lambda kv: -kv[1]))
        log(f"operators {label} {name} (sync, {total:.1f} ms): {ops}")


def capture_calls(GK, runs) -> dict:
    """(query label, kernel) -> the arguments of every wrapper call, from
    one more run of each (label, runner, sql) in ``runs``."""
    captured: dict = {}
    current = {"q": None}
    orig = {k: getattr(GK, k) for k in SOURCES}

    def spy(kernel):
        def call(*args):
            captured.setdefault((current["q"], kernel), []).append(args)
            return orig[kernel](*args)
        return call

    for k in SOURCES:
        setattr(GK, k, spy(k))
    try:
        for label, runner, sql in runs:
            current["q"] = label
            runner.execute(sql)
    finally:
        for k, fn in orig.items():
            setattr(GK, k, fn)
    return captured


def _same_generated(torch, dev_col, host_col, what: str) -> None:
    """Bit-identical columns: same dtype, same values, strings compared
    through the two dictionaries in code space."""
    d = dev_col.data.cpu().numpy()
    h = host_col.data.numpy()
    if d.dtype != h.dtype or dev_col.valid is not None:
        raise AssertionError(f"{what}: dtype {d.dtype} vs {h.dtype}")
    if dev_col.dictionary is not None:
        hd, dd = host_col.dictionary, dev_col.dictionary
        pos = np.clip(np.searchsorted(hd, dd), 0, len(hd) - 1)
        d = np.where(hd[pos] == dd, pos, -1)[d]
    if not np.array_equal(d, h):
        raise AssertionError(f"{what}: staged column != host generator")


def stage_sf1(torch, default_catalog, stage_memory_tables):
    """Phase 7: all eight tables into memory on cuda, orders and lineitem
    checked column by column against the host generator."""
    from trino_tpu_torch.connectors.tpch import TpchConnector

    cat = default_catalog(PATH_SF)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    info = stage_memory_tables(cat, TPCH_TABLES, "cuda")
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    resident = (torch.cuda.memory_allocated() - base) / 2**20
    for t, v in info.items():
        log(f"staging SF{PATH_SF:g} {t}: {v['rows']} rows, {v['bytes']} "
            f"bytes, {v['seconds'] * 1e3:.1f} ms, route {v['route']}")
    log(f"staging SF{PATH_SF:g}: {sum(v['seconds'] for v in info.values()):.2f}"
        f" s, peak device memory {peak:.1f} MiB above the start, "
        f"{resident:.1f} MiB resident after")
    mem = cat.connector("memory")
    t0 = time.perf_counter()
    for t in ("orders", "lineitem"):
        (split,) = mem.get_splits(t, 1, 1)
        cols = mem.get_table_schema(t).column_names()
        staged = mem.create_page_source(split, cols).get_next_batch()
        # a fresh host generator whose dictionary cache holds the staged
        # vocabularies: it then maps each row's vocabulary index through
        # them instead of first building its data-derived dictionaries
        # (python strings for 6 M comments: minutes at SF 1), and equal
        # codes mean equal strings
        tpch = TpchConnector(PATH_SF)
        for name in cols:
            if staged.column(name).dictionary is not None:
                tpch._dict_cache[(t, name)] = staged.column(name).dictionary
        host = tpch._generate(t, cols, 0, tpch.row_count("orders"))
        if staged.num_rows != host.num_rows or staged.live is not None:
            raise AssertionError(f"staged {t}: {staged.num_rows} rows")
        for name in cols:
            _same_generated(torch, staged.column(name), host.column(name),
                            f"staged {t}.{name}")
        log(f"staging SF{PATH_SF:g} {t}: {len(cols)} columns x "
            f"{host.num_rows} rows bit-identical to the host generator")
    log(f"bit-identity check: {time.perf_counter() - t0:.1f} s")
    return cat


def scan_stats(runner, sql: str) -> tuple:
    """(rows, bytes) the plan's table scans read after column pruning (as
    bench.py's _scan_stats counts them)."""
    from trino_tpu_torch.planner.plan import TableScan

    rows = nbytes = 0.0
    stack = [runner.create_plan(sql)]
    while stack:
        node = stack.pop()
        if isinstance(node, TableScan):
            r = runner.catalog.connector(node.catalog).get_table_statistics(
                node.table).row_count
            rows += r
            nbytes += r * sum(np.dtype(t.storage_dtype).itemsize
                              for t in node.output_types)
        stack.extend(node.children)
    return rows, nbytes


def sf10(torch, sqls, default_catalog, stage_memory_tables,
         StandaloneQueryRunner) -> None:
    """Phase 9: Q1 and Q3 at SF 10 over the tables they read, staged."""
    cat = default_catalog(SF10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    info = stage_memory_tables(cat, SF10_TABLES, "cuda")
    for t, v in info.items():
        log(f"staging SF{SF10:g} {t}: {v['rows']} rows, {v['bytes']} bytes, "
            f"{v['seconds'] * 1e3:.1f} ms, route {v['route']}")
    log(f"staging SF{SF10:g}: peak device memory "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.1f} MiB above "
        f"the start")
    runner = StandaloneQueryRunner(cat, device="cuda",
                                   default_catalog_name="memory",
                                   splits_per_node=1)
    read = staged_reader(cat.connector("memory"))
    for name in SF10_QUERIES:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner.execute(sqls[name])
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = runner.execute(sqls[name])
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20
        rows, nbytes = scan_stats(runner, sqls[name])
        rate = nbytes / warm
        log(f"SF{SF10:g} {name}: cold {cold * 1e3:.1f} ms, warm "
            f"{warm * 1e3:.1f} ms, peak device memory {peak:.1f} MiB, input "
            f"{rows:.0f} rows = {rows / warm:.0f} rows/s, scanned "
            f"{nbytes / 1e9:.3f} GB = {rate / 1e9:.2f} GB/s (HBM "
            f"{HBM_BYTES_PER_S / 1e9:.0f} GB/s)")
        if rate > HBM_BYTES_PER_S:
            raise AssertionError(f"SF{SF10:g} {name}: {rate / 1e9:.1f} GB/s "
                                 "exceeds the HBM rate")
        t0 = time.perf_counter()
        worst = same_rows(res.rows(), evaluate(read, name),
                          f"SF{SF10:g} {name}")
        log(f"SF{SF10:g} {name}: rows equal the numpy evaluation of the "
            f"staged columns (largest float rel diff {worst:.3g}; "
            f"{time.perf_counter() - t0:.1f} s)")


def kernel_cases(torch, GK, captured) -> list:
    """(kernel, label, args): the path's shapes, then per kernel the
    largest call of the staged path."""
    def pick(q, kernel, pred):
        calls = [c for c in captured.get((q, kernel), []) if pred(c)]
        if not calls:
            raise AssertionError(f"no captured {kernel} call of {q}")
        return max(calls, key=lambda c: _rows_of(kernel, c))

    cases = [
        ("hash_insert", "Q3 orders join index",
         pick("Q3", "hash_insert", lambda c: c[0].shape[0] == 2)),
        ("hash_insert", "Q3 group-by (3 keys)",
         pick("Q3", "hash_insert", lambda c: c[0].shape[0] > 2)),
        ("hash_insert", "Q12 lineitem join index",
         pick("Q12", "hash_insert", lambda c: True)),
        ("hash_insert", "Q18 largest insert (lineitem by l_orderkey)",
         pick("Q18", "hash_insert", lambda c: True)),
        ("hash_probe", "Q12 orders probe",
         pick("Q12", "hash_probe", lambda c: True)),
        ("hash_probe", "Q21 largest probe (EXISTS over lineitem)",
         pick("Q21", "hash_probe", lambda c: True)),
        ("masked_segment_sum_f32", "R1 (7 groups, cap 8)",
         pick("R1", "masked_segment_sum_f32", lambda c: True)),
        ("masked_segment_sum_f32", "R2 (50 groups, cap 64)",
         pick("R2", "masked_segment_sum_f32", lambda c: True)),
    ]
    r2 = cases[-1][2]
    cases += [("masked_segment_sum_f32", label, args)
              for label, args in _segment_variants(torch, r2)]
    for kernel in SOURCES:
        calls = [(q, c) for (q, k), cs in captured.items()
                 if k == kernel and q.startswith("staged ") for c in cs]
        if not calls:
            raise AssertionError(f"the staged path made no {kernel} call")
        q, args = max(calls, key=lambda qc: _rows_of(kernel, qc[1]))
        cases.append((kernel, f"staged: largest call ({q[7:]})", args))
    return cases


def _rows_of(kernel: str, args) -> int:
    if kernel == "hash_probe":
        return args[2].shape[-1]
    if kernel == "hash_insert":
        return args[0].shape[1]
    return args[0].shape[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from trino_tpu_torch.connectors.catalog import default_catalog
    from trino_tpu_torch.connectors.staging import stage_memory_tables
    from trino_tpu_torch.connectors.tpch_queries import QUERIES
    from trino_tpu_torch.exec.stats import QueryStats
    from trino_tpu_torch.ops import gpu_kernels as GK
    from trino_tpu_torch.runner import StandaloneQueryRunner

    sqls = {f"Q{q}": QUERIES[q] for q in sorted(QUERIES)}
    sqls.update(REAL_QUERIES)
    t_start = time.perf_counter()
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    GK.build_library(verbose=True)
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc trino_tpu_torch/csrc/*.cu, one process per source)")

    # -- 3. path: SF 1 on cuda ---------------------------------------------
    runner = StandaloneQueryRunner(default_catalog(PATH_SF), device="cuda")
    path_rows, _, launches = run_path(torch, GK, runner, sqls,
                                      f"path SF{PATH_SF:g}")
    t0 = time.perf_counter()
    read1 = host_reader(runner.catalog.connector("tpch"))
    numpy_rows = {}
    for name in ORACLE_QUERIES:
        rtol = KERNEL_VS_F64_RTOL if name in REAL_QUERIES else DOUBLE_RTOL
        numpy_rows[name] = evaluate(read1, name)
        worst = same_rows(path_rows[name], numpy_rows[name],
                          f"SF{PATH_SF:g} {name}", rtol)
        log(f"path SF{PATH_SF:g} {name}: rows equal the numpy evaluation "
            f"(largest float rel diff {worst:.3g}, limit {rtol:g})")
    log(f"numpy evaluations: {time.perf_counter() - t0:.1f} s")

    # -- 4. parity: SF 0.1, cuda vs cpu (vs numpy) ---------------------------
    t0 = time.perf_counter()
    cat = default_catalog(PARITY_SF)
    r_gpu = StandaloneQueryRunner(cat, device="cuda")
    r_cpu = StandaloneQueryRunner(cat, device="cpu")
    read01 = host_reader(cat.connector("tpch"))
    for name, sql in sqls.items():
        g = r_gpu.execute(sql).rows()
        c = r_cpu.execute(sql).rows()
        real = name in REAL_QUERIES
        worst = same_rows(g, c, f"SF{PARITY_SF:g} {name} cuda vs cpu",
                          REAL_PARITY_RTOL if real else DOUBLE_RTOL)
        msg = ""
        if name in ORACLE_QUERIES:
            same_rows(g, evaluate(read01, name),
                      f"SF{PARITY_SF:g} {name} cuda vs numpy",
                      KERNEL_VS_F64_RTOL if real else DOUBLE_RTOL)
            msg = " and numpy"
        log(f"parity SF{PARITY_SF:g} {name}: {len(g)} rows equal on cuda "
            f"and cpu{msg} (largest float rel diff {worst:.3g})")
    log(f"parity: {time.perf_counter() - t0:.1f} s")
    del cat, r_gpu, r_cpu

    # -- 5. per-operator time (synchronized after every operator call) -----
    per_operator(QueryStats, runner, sqls, f"SF{PATH_SF:g}")

    # -- 7. staging: SF 1 into memory on cuda ------------------------------
    staged_cat = stage_sf1(torch, default_catalog, stage_memory_tables)

    # -- 8. the staged path: memory tables, one split ----------------------
    staged = StandaloneQueryRunner(staged_cat, device="cuda",
                                   default_catalog_name="memory",
                                   splits_per_node=1)
    staged_rows, staged_times, _ = run_path(torch, GK, staged, sqls,
                                            f"staged SF{PATH_SF:g}")
    for name in sqls:
        if name in REAL_QUERIES:  # float32 sums over one whole-table batch
            want, rtol, what = (numpy_rows[name], KERNEL_VS_F64_RTOL,
                                "the numpy evaluation")
        else:
            want, rtol, what = path_rows[name], DOUBLE_RTOL, "the tpch path"
        worst = same_rows(staged_rows[name], want,
                          f"staged SF{PATH_SF:g} {name}", rtol)
        log(f"staged SF{PATH_SF:g} {name}: rows equal {what} (largest float "
            f"rel diff {worst:.3g}, limit {rtol:g})")
    # the subset, then the three slowest staged queries outside it
    slowest = sorted((n for n in sqls if n not in CAPTURE_QUERIES),
                     key=lambda n: -staged_times[n][1])[:3]
    per_operator(QueryStats, staged, sqls, f"staged SF{PATH_SF:g}",
                 CAPTURE_QUERIES + tuple(slowest))

    # -- 6. kernels vs plain versions at the paths' shapes ------------------
    # One more run per query records every wrapper call's arguments; it is
    # kept apart from the path runs so the held tensors do not inflate
    # their peak memory, and its launches are not the paths'.
    captured = capture_calls(GK, [
        (f"{prefix}{name}", r, sqls[name]) for prefix, r in
        (("", runner), ("staged ", staged)) for name in CAPTURE_QUERIES])
    cases = kernel_cases(torch, GK, captured)
    log(library_read_rate(torch, cases[7][2][0]))
    entries = {}
    for kernel, label, args in cases:
        if kernel == "hash_insert":
            res = _insert_case(torch, GK, GK.hash_insert, GK.hash_probe,
                               args)
        elif kernel == "hash_probe":
            res = _probe_case(torch, GK, GK.hash_probe, args)
        else:
            res = _segment_case(torch, GK, GK.masked_segment_sum_f32, args)
        bound_ms = res["nbytes"] / HBM_BYTES_PER_S * 1e3
        on_device = (f" (on the device, CUDA graph of {GRAPH_REPS}: "
                     f"{res['device_ms']:.4f} ms)")
        turns = ', '.join(f'{t:.4f}' for t in res['turns'])
        library = ("library — (no single call takes the mask; kernel "
                   f"timed twice: {turns} ms)" if res["lib_ms"] is None
                   else f"library {res['lib_ms']:.4f} ms (in turns: kernel, "
                   f"library, library, kernel = {turns} ms)")
        log(f"kernel {kernel} [{label}] {res['shape']}: {res['ms']:.4f} ms"
            f"{res['extra']}, kernels alone {res['alone_ms']:.4f} ms"
            f"{on_device}, host enqueue {res['enq_us']:.1f} us/call, plain "
            f"{res['plain_ms']:.4f} ms, {library}, bound "
            f"{bound_ms:.4f} ms ({res['nbytes']} bytes / 3.35 TB/s), "
            f"max_abs_err {res['err']}")
        case = {"label": label, "shape": res["shape"], "ms": res["ms"],
                "kernels_alone_ms": res["alone_ms"],
                "device_ms": res["device_ms"],
                "host_enqueue_us": res["enq_us"],
                "host_parts_us": res.get("parts"),
                "plain_ms": res["plain_ms"], "library_ms": res["lib_ms"],
                "turns_ms": res["turns"], "bound_ms": bound_ms,
                "max_abs_err": res["err"]}
        src, replaces = SOURCES[kernel]
        entry = entries.setdefault(kernel, {
            "name": kernel, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kernel],
            "max_abs_err": res["err"], "ms": res["ms"],
            "kernels_alone_ms": res["alone_ms"],
            "device_ms": res["device_ms"],
            "host_enqueue_us": res["enq_us"], "plain_ms": res["plain_ms"],
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": res["lib_ms"], "shape": res["shape"], "cases": []})
        entry["max_abs_err"] = max(entry["max_abs_err"], res["err"])
        entry["cases"].append(case)
    del captured, cases, args, res, staged, staged_cat, runner
    torch.cuda.empty_cache()

    # -- 9. SF 10: Q1 and Q3 over staged tables -----------------------------
    sf10(torch, sqls, default_catalog, stage_memory_tables,
         StandaloneQueryRunner)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception as e:  # noqa: BLE001 — any failed phase fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        rc = 1
    sys.exit(rc)

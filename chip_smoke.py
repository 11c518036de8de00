#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (trino_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from trino_tpu_torch/csrc/*.cu (nvcc, sm_90a);
  3. path: the 22 TPC-H queries and the two REAL-sum queries R1, R2 at SF 1
     through StandaloneQueryRunner on cuda -- cold and warm wall time, peak
     device memory and kernel launches per query; Q1, Q3, Q12, R1 and R2
     rows checked against a plain numpy evaluation on the same generated
     data;
  4. parity: all 24 queries at SF 0.1 on cuda and on cpu (and numpy for
     the five above);
  5. per-operator time of one synchronized run of a subset of the queries;
  6. kernels: each kernel on the inputs the path gives it (recorded in one
     more run of that subset, apart from the path run), held against its
     plain torch version (exact for group ids, counts and probe ids; the
     float32 segment sums to the tolerances stated below), timed beside the
     plain version and one PyTorch library call, with its bound.
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
# plain numpy evaluation of the three queries (independent of the engine)


def _days(y: int, m: int, d: int) -> int:
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def _table(conn, table: str, cols: list[str]) -> dict:
    n = conn.row_count("orders" if table == "lineitem" else table)
    b = conn._generate(table, cols, 0, n)
    out = {}
    for name, c in zip(b.names, b.columns):
        data = c.data.numpy()
        out[name] = c.dictionary[data] if c.dictionary is not None else data
    return out


def _dec(v: int, scale: int) -> decimal.Decimal:
    return decimal.Decimal(int(v)).scaleb(-scale)


def oracle(conn, q: int) -> list[tuple]:
    if q == 1:
        li = _table(conn, "lineitem", [
            "l_quantity", "l_extendedprice", "l_discount", "l_tax",
            "l_returnflag", "l_linestatus", "l_shipdate"])
        m = li["l_shipdate"] <= _days(1998, 12, 1) - 90
        rows = []
        for rf, ls in sorted(set(zip(li["l_returnflag"][m],
                                     li["l_linestatus"][m]))):
            g = m & (li["l_returnflag"] == rf) & (li["l_linestatus"] == ls)
            qty, ext = li["l_quantity"][g], li["l_extendedprice"][g]
            disc, tax = li["l_discount"][g], li["l_tax"][g]
            n = int(g.sum())
            rows.append((
                rf, ls, _dec(qty.sum(), 2), _dec(ext.sum(), 2),
                _dec((ext * (100 - disc)).sum(), 4),
                _dec((ext * (100 - disc) * (100 + tax)).sum(), 6),
                float((qty / 100.0).sum() / n),
                float((ext / 100.0).sum() / n),
                float((disc / 100.0).sum() / n), n))
        return rows
    if q == 3:
        cu = _table(conn, "customer", ["c_custkey", "c_mktsegment"])
        od = _table(conn, "orders", ["o_orderkey", "o_custkey",
                                     "o_orderdate", "o_shippriority"])
        li = _table(conn, "lineitem", ["l_orderkey", "l_extendedprice",
                                       "l_discount", "l_shipdate"])
        cut = _days(1995, 3, 15)
        building = np.zeros(int(cu["c_custkey"].max()) + 1, bool)
        building[cu["c_custkey"][cu["c_mktsegment"] == "BUILDING"]] = True
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
        od = _table(conn, "orders", ["o_orderkey", "o_orderpriority"])
        li = _table(conn, "lineitem", [
            "l_orderkey", "l_shipdate", "l_commitdate", "l_receiptdate",
            "l_shipmode"])
        m = (np.isin(li["l_shipmode"], ["MAIL", "SHIP"])
             & (li["l_commitdate"] < li["l_receiptdate"])
             & (li["l_shipdate"] < li["l_commitdate"])
             & (li["l_receiptdate"] >= _days(1994, 1, 1))
             & (li["l_receiptdate"] < _days(1995, 1, 1)))
        okeys = od["o_orderkey"]
        order = np.argsort(okeys)
        pos = order[np.searchsorted(okeys[order], li["l_orderkey"][m])]
        high = np.isin(od["o_orderpriority"][pos], ["1-URGENT", "2-HIGH"])
        modes = li["l_shipmode"][m]
        return [(mode, int((high & (modes == mode)).sum()),
                 int((~high & (modes == mode)).sum()))
                for mode in sorted(set(modes))]
    raise ValueError(q)


def real_oracle(conn, name: str) -> list[tuple]:
    """R1 / R2: float64 sums of the float32-cast values per key."""
    li = _table(conn, "lineitem", [
        "l_linenumber", "l_quantity", "l_extendedprice"])
    key = li["l_linenumber"] if name == "R1" else li["l_quantity"]
    sums = ["l_quantity", "l_extendedprice"] if name == "R1" else [
        "l_extendedprice"]
    uk, inv = np.unique(key, return_inverse=True)
    cols = [np.bincount(inv, weights=(li[c] / 100.0).astype(
        np.float32).astype(np.float64), minlength=len(uk)) for c in sums]
    keys = [int(k) if name == "R1" else _dec(k, 2) for k in uk]
    return [(k, *(float(c[i]) for c in cols)) for i, k in enumerate(keys)]


def evaluate(conn, name: str) -> list[tuple]:
    return (real_oracle(conn, name) if name in REAL_QUERIES
            else oracle(conn, int(name[1:])))


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


def _insert_case(torch, GK, orig_insert, orig_probe, args):
    planes, h32, live, S = args
    if live is None:  # a compacted input: every row live
        live = torch.ones(planes.shape[1], dtype=torch.bool,
                          device=planes.device)
    got = orig_insert(planes, h32, live, S)
    want = GK.hash_insert_plain(planes, h32, live, S)
    torch.cuda.synchronize()
    if got[1] != want[1] or not torch.equal(got[0], want[0]):
        raise AssertionError("cuda hash_insert != plain")
    err = int((got[0].long() - want[0].long()).abs().max())
    # cross-probe: each table read by the other version's probe
    a = GK.hash_probe_plain(got[2], got[3], planes, h32, live)
    b = orig_probe(want[2], want[3], planes, h32, live)
    expect = torch.where(live, got[0], -1)
    if not (torch.equal(a, expect) and torch.equal(b, expect)):
        raise AssertionError("hash_insert cross-probe mismatch")
    ms = cuda_ms(torch, lambda: orig_insert(planes, h32, live, S), 10)
    # the two kernels alone, without the wrapper's finish and syncs
    owner = torch.empty(S, dtype=torch.int32, device=planes.device)
    first = torch.empty_like(owner)
    slot = torch.empty(planes.shape[1], dtype=torch.int32,
                       device=planes.device)
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        owner.fill_(-1)
        first.fill_(2**31 - 1)
        GK._lib().hash_insert_launch(
            planes.data_ptr(), planes.shape[0], planes.shape[1],
            h32.data_ptr(), live.data_ptr(), S, owner.data_ptr(),
            slot.data_ptr(), first.data_ptr(), stream)

    extra = f", kernels alone {cuda_ms(torch, raw, 10):.3f} ms"
    plain_ms = cuda_ms(
        torch, lambda: GK.hash_insert_plain(planes, h32, live, S), 3,
        warmup=1)
    lib_ms = cuda_ms(torch, lambda: torch.unique(
        planes, dim=1, return_inverse=True), 10)
    P, n = planes.shape
    L = int(live.sum())
    nbytes = (P * n * 4 + n * 4 + n  # planes, h32, live
              + n * 4 + P * S * 4 + S * 4  # row_gid, table, ids
              + SECTOR * L)  # one random slot sector per live row
    shape = f"P={P} N={n} S={S} live={L} groups={got[1]}"
    return err, ms, plain_ms, lib_ms, nbytes, shape, extra


def _probe_case(torch, GK, orig_probe, args):
    tp, sg, planes, h32, live = args
    if live is None:
        live = torch.ones(planes.shape[1], dtype=torch.bool,
                          device=planes.device)
    got = orig_probe(tp, sg, planes, h32, live)
    want = GK.hash_probe_plain(tp, sg, planes, h32, live)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("cuda hash_probe != plain")
    err = int((got.long() - want.long()).abs().max())
    ms = cuda_ms(torch, lambda: orig_probe(tp, sg, planes, h32, live), 10)
    plain_ms = cuda_ms(
        torch, lambda: GK.hash_probe_plain(tp, sg, planes, h32, live), 3,
        warmup=1)
    # library yardstick: searchsorted of the probe hashes in the sorted
    # build hashes (the reference's sort path)
    occ = sg >= 0
    bh = ((tp[1][occ].long() << 32) | (tp[0][occ].long() & 0xFFFFFFFF))
    ph = (planes[1].long() << 32) | (planes[0].long() & 0xFFFFFFFF)
    sorted_bh = torch.sort(bh).values
    lib_ms = cuda_ms(torch, lambda: torch.searchsorted(sorted_bh, ph), 10)
    P, n = planes.shape
    S = int(sg.shape[0])
    L = int(live.sum())
    nbytes = P * n * 4 + n * 4 + n + n * 4 + SECTOR * L
    shape = f"P={P} N={n} S={S} live={L} hits={int((got >= 0).sum())}"
    return err, ms, plain_ms, lib_ms, nbytes, shape, ""


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
    ms = cuda_ms(torch, lambda: orig_seg(vals, gid, live, G), 20)
    plain_ms = cuda_ms(
        torch, lambda: GK.masked_segment_sum_f32_plain(vals, gid, live, G),
        10)
    # library yardstick: one scatter-add; the ids of these inputs lie in
    # [0, G], so a G + 1 slot output takes the same rows
    if live is not None or int(gid.max()) > G or int(gid.min()) < 0:
        raise AssertionError("segment-sum inputs outside the library "
                             "call's contract")
    out = torch.zeros(G + 1, dtype=torch.float32, device=vals.device)
    lib_ms = cuda_ms(torch, lambda: out.zero_().index_add_(0, gid, vals),
                     20)
    n = int(vals.shape[0])
    nbytes = n * 4 + n * 4 + (n if live is not None else 0) + G * 4
    shape = f"N={n} G={G} live={'all' if live is None else 'mask'}"
    extra = (f", rel err vs float64: kernel {k_rel:.3g}, plain "
             f"{p_rel:.3g}")
    return err, ms, plain_ms, lib_ms, nbytes, shape, extra


SOURCES = {
    "hash_insert": ("trino_tpu_torch/csrc/hash_table.cu",
                    "trino_tpu/ops/pallas_kernels.py:139"),
    "hash_probe": ("trino_tpu_torch/csrc/hash_table.cu",
                   "trino_tpu/ops/pallas_kernels.py:199"),
    "masked_segment_sum_f32": ("trino_tpu_torch/csrc/segment_sum.cu",
                               "trino_tpu/ops/pallas_kernels.py:50"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from trino_tpu_torch.connectors.catalog import default_catalog
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

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    GK.build_library(verbose=True)
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc trino_tpu_torch/csrc/*.cu, one process per source)")

    # -- path: SF 1 on cuda ------------------------------------------------
    runner = StandaloneQueryRunner(default_catalog(PATH_SF), device="cuda")
    path_rows, timings, per_query = {}, {}, {}
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
        path_rows[name] = res.rows()
        timings[name] = (cold, warm, peak)
        per_query[name] = {k: GK.LAUNCHES[k] - before[k]
                           for k in GK.LAUNCHES}
        log(f"path SF{PATH_SF:g} {name}: {len(path_rows[name])} rows, cold "
            f"{cold:.1f} ms, warm {warm:.1f} ms, peak device memory "
            f"{peak:.1f} MiB, launches {per_query[name]}")
    launches = dict(GK.LAUNCHES)
    log(f"path launches: {launches} "
        f"({time.perf_counter() - t_path:.1f} s for {len(sqls)} queries)")
    required = {"Q3": ["hash_insert"], "Q12": ["hash_probe"],
                "Q18": ["hash_insert"], "Q21": ["hash_insert", "hash_probe"],
                "R1": ["masked_segment_sum_f32"],
                "R2": ["masked_segment_sum_f32"]}
    for name, kernels in required.items():
        for k in kernels:
            if per_query[name][k] <= 0:
                raise AssertionError(f"{name} launched no {k}")
    if any(v <= 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    t0 = time.perf_counter()
    conn1 = runner.catalog.connector("tpch")
    for name in ORACLE_QUERIES:
        rtol = KERNEL_VS_F64_RTOL if name in REAL_QUERIES else DOUBLE_RTOL
        worst = same_rows(path_rows[name], evaluate(conn1, name),
                          f"SF{PATH_SF:g} {name}", rtol)
        log(f"path SF{PATH_SF:g} {name}: rows equal the numpy evaluation "
            f"(largest float rel diff {worst:.3g}, limit {rtol:g})")
    log(f"numpy evaluations: {time.perf_counter() - t0:.1f} s")

    # -- parity: SF 0.1, cuda vs cpu (vs numpy) ------------------------------
    t0 = time.perf_counter()
    cat = default_catalog(PARITY_SF)
    r_gpu = StandaloneQueryRunner(cat, device="cuda")
    r_cpu = StandaloneQueryRunner(cat, device="cpu")
    for name, sql in sqls.items():
        g = r_gpu.execute(sql).rows()
        c = r_cpu.execute(sql).rows()
        real = name in REAL_QUERIES
        worst = same_rows(g, c, f"SF{PARITY_SF:g} {name} cuda vs cpu",
                          REAL_PARITY_RTOL if real else DOUBLE_RTOL)
        msg = ""
        if name in ORACLE_QUERIES:
            same_rows(g, evaluate(cat.connector("tpch"), name),
                      f"SF{PARITY_SF:g} {name} cuda vs numpy",
                      KERNEL_VS_F64_RTOL if real else DOUBLE_RTOL)
            msg = " and numpy"
        log(f"parity SF{PARITY_SF:g} {name}: {len(g)} rows equal on cuda "
            f"and cpu{msg} (largest float rel diff {worst:.3g})")
    log(f"parity: {time.perf_counter() - t0:.1f} s")

    # -- per-operator time (synchronized after every operator call) --------
    for name in CAPTURE_QUERIES:
        st = QueryStats(sync=True)
        t0 = time.perf_counter()
        runner.execute(sqls[name], stats=st)
        total = (time.perf_counter() - t0) * 1e3
        ops = ", ".join(f"{k} {v * 1e3:.1f}"
                        for k, v in sorted(st.by_operator().items(),
                                           key=lambda kv: -kv[1]))
        log(f"operators SF{PATH_SF:g} {name} (sync, {total:.1f} ms): {ops}")

    # -- kernels vs plain versions at the path's shapes ---------------------
    # One more run per query records every wrapper call's arguments; it is
    # kept apart from the path run so the held tensors do not inflate that
    # run's peak memory, and its launches are not the path's.
    captured: dict = {}  # (query, kernel) -> list of wrapper args
    current = {"q": None}
    orig_insert, orig_probe = GK.hash_insert, GK.hash_probe
    orig_seg = GK.masked_segment_sum_f32

    def cap_insert(planes, hash32, live, num_slots):
        captured.setdefault((current["q"], "hash_insert"), []).append(
            (planes, hash32, live, num_slots))
        return orig_insert(planes, hash32, live, num_slots)

    def cap_probe(table_planes, slot_gid, planes, hash32, live=None):
        captured.setdefault((current["q"], "hash_probe"), []).append(
            (table_planes, slot_gid, planes, hash32, live))
        return orig_probe(table_planes, slot_gid, planes, hash32, live)

    def cap_seg(values, gid, live, num_groups):
        captured.setdefault((current["q"], "masked_segment_sum_f32"),
                            []).append((values, gid, live, num_groups))
        return orig_seg(values, gid, live, num_groups)

    GK.hash_insert, GK.hash_probe = cap_insert, cap_probe
    GK.masked_segment_sum_f32 = cap_seg
    try:
        for name in CAPTURE_QUERIES:
            current["q"] = name
            runner.execute(sqls[name])
    finally:
        GK.hash_insert, GK.hash_probe = orig_insert, orig_probe
        GK.masked_segment_sum_f32 = orig_seg

    def pick(q, kernel, pred):
        calls = [c for c in captured.get((q, kernel), []) if pred(c)]
        if not calls:
            raise AssertionError(f"no captured {kernel} call of {q}")
        if kernel == "hash_probe":
            return max(calls, key=lambda c: c[-3].shape[-1])
        if kernel == "hash_insert":
            return max(calls, key=lambda c: c[0].shape[1])
        return max(calls, key=lambda c: c[0].shape[0])

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
    entries = {}
    for kernel, label, args in cases:
        if kernel == "hash_insert":
            res = _insert_case(torch, GK, orig_insert, orig_probe, args)
        elif kernel == "hash_probe":
            res = _probe_case(torch, GK, orig_probe, args)
        else:
            res = _segment_case(torch, GK, orig_seg, args)
        err, ms, plain_ms, lib_ms, nbytes, shape, extra = res
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"kernel {kernel} [{label}] {shape}: {ms:.4f} ms{extra}, plain "
            f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({nbytes} bytes / 3.35 TB/s), max_abs_err "
            f"{err}")
        case = {"label": label, "shape": shape, "ms": ms,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bound_ms, "max_abs_err": err}
        src, replaces = SOURCES[kernel]
        entry = entries.setdefault(kernel, {
            "name": kernel, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kernel],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
            "shape": shape, "cases": []})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["cases"].append(case)
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

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (trino_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the final line; they run in
the order 1-5, 7, 8, 10-24, 6, 9, so the kernel phase holds the staged,
surface, window, nested, parallel, distributed, compiled,
fault-tolerant and serving paths' calls too; every phase but 21 runs with
TRINO_TPU_HBO=0 and TRINO_TPU_ADAPTIVE=0).  The
tpch path
runs the runner's default scan: dynamic filters, split prefetch threads,
coalescing into pinned buffers with side-stream copies, RLE / LAZY
columns.  Every runner but phase 10's legacy one plans with the port's
default optimizer, the iterative one:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from trino_tpu_torch/csrc/*.cu (nvcc, sm_90a);
  3. path: the 22 TPC-H queries and the two REAL-sum queries R1, R2 at SF 1
     through StandaloneQueryRunner on cuda over the tpch connector (host
     generation) -- cold wall time (and warm for Q1, Q3, Q12, Q18, Q21, R1,
     R2), peak device memory and kernel launches per query; Q1, Q3, Q12, R1 and R2 rows checked against a
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
     path (phase 8), labelled "staged", and one call of the surface path
     (phase 11), labelled "surface": G1's insert, J3's probe, G3's segment
     sum; the largest insert of W3, W5 and W7 (phase 12), labelled
     "windows" (few keys, many rows each); and the nested path's largest
     insert (phase 13), labelled "nested"; and ANALYZE's insert over a
     one-column copy of l_extendedprice (the shape phase 15's ANALYZE
     gives each column that is not a dictionary: two planes, no live
     mask, 5,998,321 rows), labelled "statements"; and the largest
     insert of one of Q18's four partition drivers behind the HASH local
     exchange (phase 16), labelled "local exchange"; and phase 20's
     compiled stages, labelled "compiled": Q1's accumulate insert (one
     batch into its 8192 slots), its seam merge's insert (4 x 8192
     lanes a task), Q3's resident build insert (orders) and its probe of
     that build with one lineitem batch.  The bound's random table
     traffic is one 32-byte sector per distinct home slot of the live
     rows (rows of one key share theirs);
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
  9. SF 10: Q1 (the text of bench.py's QUERIES) over lineitem staged on
     cuda, cold and warm, with input rows/s
     and scanned GB/s from the plans' table scans (held below the HBM
     rate), rows checked against the numpy evaluation of the staged
     columns;
 10. optimizers: the 24 queries over the staged SF 1 tables under
     optimizer="legacy" and optimizer="iterative": whether the plans are
     identical, rows equal (phase 8's tolerances), planning ms (median of
     5 create_plan calls) and warm ms per mode; the tpch path's planning
     ms of the subset per mode and with the lineitem row count recomputed
     per call; and
     EXPLAIN ANALYZE of Q3 and Q21 on the card;
 11. surface: the twelve queries of connectors/surface_queries.py (set
     operations, grouping sets, RIGHT / FULL joins, scalar and statistical
     functions) over the staged SF 1 tables on cuda, cold and warm, with
     peak memory and launches per query (each must launch the kernels
     KERNELS names); the twelve at SF 0.1 on cuda and on cpu, rows equal
     to phase 4's tolerances; U1, U4, G1, G3, J1 and J3 at SF 1 against
     numpy over the staged columns; per-operator times of G1, U1 and J3;
     and the calls phase 6 holds as its "surface" cases (G1's insert,
     J3's probe, G3's segment sum);
 12. windows: the window queries W1-W8 of connectors/window_queries.py
     over the staged SF 1 tables on cuda, cold and warm, with peak memory
     and launches per query (each must launch the kernels KERNELS names);
     W1, W2, W4 and W7 against numpy over the staged columns (exact);
     per-operator times of W2, W6 and W7 with the Window operator's share;
     M1 (MATCH_RECOGNIZE) over a CTAS cut of the staged orders (customers
     up to 1500), cold and warm, against a plain scan of the same rows;
     W1-W8 and M1 over its cut at SF 0.1 on cuda and on cpu, rows equal;
 13. nested: ``orders_nested`` (connectors/nested_queries.py: arrays, a
     map, a row, decimal(38,18) and JSON text per order) built from the
     staged SF 1 tables (rows, device bytes, dictionary sizes, seconds);
     N1-N11 over it on cuda, cold and warm, with peak memory and launches
     per query (each launches exactly the kernels KERNELS names); N1, N2,
     N5 and N9 against a plain numpy / python-int evaluation of the
     arrays the table is built from (exact); per-operator times of N2, N3 and N5 (the
     Unnest and HashAggregation shares); device busy time of one traced
     run of N2 (torch.profiler) against its unprofiled warm
     wall: the idle, host share; and N1-N11 at SF 0.1 on cuda and on cpu,
     rows equal;
 14. ingest: the rows dynamic filters pruned and the bytes copied to the
     card by each of the 24 tpch-path queries (phase 3's cold runs); warm
     ms of Q1 and Q3 under the default,
     dynamic_filtering=False, IngestConfig(enabled=False) and
     encoded_exec=False in one process, rows equal; one traced warm run of
     Q1 with ingest on and off (torch.profiler): device busy ms,
     the idle share of the unprofiled warm wall, and host-to-device bytes
     by copy kind, pinned against pageable; it fails if more than 1 % of
     Q1's scan bytes cross from pageable memory with ingest on; and a
     build of more than 65,536 keys whose domain the tpch path derives on
     the card, against the host domain of the same keys; then the staged
     path's 24 queries with ingest on and off, in turns (its batches skip
     the new path).  It prints os.cpu_count() and the prefetch thread
     count;
 15. statements: over ``li15``, a CTAS copy of the staged SF 1 lineitem,
     CALL memory.pin_table, ANALYZE (row count and the 16 NDVs against
     numpy over the host generator, a hash_insert per column that is not
     a dictionary, device-to-host bytes traced), DELETE (count and a
     grouped aggregate of the kept rows against numpy, the table still
     resident), Q21 and Q12 read through views (rows equal, hash_probe
     launched), a materialized view of R1 refreshed after an INSERT
     (rows against numpy, staleness, masked_segment_sum_f32 launched,
     backing table resident), a rolled-back INSERT, SET SESSION
     dynamic_filtering on the tpch path (Q12 prunes nothing, then again)
     and SHOW TABLES; each step's ms beside the card's name and power
     limit.  Its launches are the kernels line's ``launches_statements``;
 16. engine: the local exchange (Q1, R1 on the tpch path
     with task_concurrency = 4 against 1, splits_per_node = 8: rows equal,
     numpy checks, warm ms in turns, hash_insert launches), revocation
     (Q18 under a 256 MiB pool against unlimited: rows, revocations,
     bytes revoked, peak memory), PARTIAL -> FINAL (Q18's lineitem
     group-by over the staged batch against SINGLE, exact), host syncs
     (EXPLAIN ANALYZE's sync line of Q3 and Q12, syncs now and before the
     sync-free probe, a run under SG.forbidden(cuda_sync_debug=True)) and
     the time-sharing executor (Q1, Q3, Q6 at once on two workers against
     run_pipelines).  Its launches are ``launches_engine``;
 17. storage: the wire format, the disk tier of spill and the file
     connector at SF 1.  (a) CTAS of file.customer, file.orders and
     file.lineitem (all columns) from the tpch catalog: seconds, pages,
     bytes on disk against the flat column bytes, the sink's host syncs;
     Q1, Q3, Q12 and R1 over the file tables cold and warm: rows
     equal phase 3's and the numpy evaluations (Q1, Q3, Q12, R1), bytes
     read and inflated, read / inflate / decode ms per query, the host ms
     of dictionary unification on both paths, the device idle share of
     Q1's warm run, and hash_insert / hash_probe / masked_segment_sum_f32
     each launched.  (b) on the tpch path, Q18 and a join + ORDER BY ...
     LIMIT under spill_to_disk_bytes = 64 MiB with a 256 MiB pool, and Q1
     under spill_to_disk_bytes = 1 (the aggregation's state spill): rows
     equal the runs without a budget, pages and bytes spilled (more than
     none), write and read-back ms, the merges' hash_insert launches, the
     peak above the start and the ms of both runs.  The
     file root is removed at the end.  Its launches are
     ``launches_storage``;
 18. telemetry: the staged queries three times with both cache tiers on,
     an INSERT into nation between passes, the system tables, profiles
     and the journal (``telemetry()``).  Its launches are
     ``launches_telemetry``;
 19. distributed: the distributed runner at SF 1 over the tpch
     connector, four tasks per stage sharing the one card
     (``distributed()``): the 24 queries but DIST_CUT, one cold run
     each, with rows equal phase 3's, per query the stages, collective
     and host edges, launches, host syncs by tag and device-to-host
     bytes; Q1 with collectives on / off in turns; wire-format pages, the MERGE
     exchange, a DistinctLimit plan; the fused Q1 program (q1_step,
     q1_spmd over a 4-shard mesh) against q1_numpy.  Phase 6 adds a
     task's largest insert and q1_step's insert as "distributed" cases.
     It runs with the compiled stages off (TRINO_TPU_FUSED_STAGE=0,
     TRINO_TPU_RESIDENT_PLAN=0), the per-operator path PR 15 measured.
     Its launches are ``launches_distributed``;
 20. compiled: the distributed runner at its defaults, fused seams and
     resident plans on (``compiled()``): nine of the 16 queries that
     carry one (COMPILED_QUERIES),
     cold and warm, rows equal phase 3's, per query the seams, plans,
     fallbacks with their reasons, batches, program calls, first calls
     of a signature, merges, warm ms and device-to-host bytes of the
     cold run; kernel launches per accumulate call (a batch of a warm
     run of Q1 and of Q3 through its sink again under torch.profiler);
     Q3 under SG.forbidden(cuda_sync_debug=True) with no hot-loop sync;
     Q1 default / =0 / =0 / default.
     Its launches are ``launches_compiled``;
 21. resilient: HBO, the adaptive plane and fault-tolerant execution
     (``resilient()``); its launches are ``launches_fault_tolerant`` and
     ``launches_adaptive``;
 22. serving: the statement server over a ProcessDistributedQueryRunner
     with two worker processes on the card, SF 1 (``serving()``): Q1,
     Q3, Q12, R1 through the client (rows equal phase 3's, walls beside
     phase 19's, HTTP exchange pages and bytes, the workers' kernel
     launches from their /v1/info), three concurrent Q6 under a
     one-slot resource-group tree, kill -9 of a worker under QUERY
     retry, PROCESS_EXIT under TASK retry, a graceful drain, and a
     server restart that resumes a TASK query from the WAL.  Its
     launches, summed over the workers, are ``launches_serving``.  Phase
     6 captures Q3's, Q12's and R1's calls from the same runner with its
     two workers' TaskServers in this process (a worker process's calls
     are out of reach) and labels them "serving";
 23. chaos: the port's chaos harness (trino_tpu_torch/testing/chaos.py)
     at SF 1 on the tpch path (``chaos()``): the mix's expected rows from
     the port's sqlite oracle (its load timed); one in-process and one
     process scenario (two workers, five seeded queries with seeded
     faults and drains), one FTE scenario (six queries, spool
     corruption), the coordinator kill -9 drill over the mix's join (a
     fresh coordinator resumes the query from the WAL, no committed
     attempt re-executed), a CTAS into and a group-by over a
     plugin-loaded catalog, and the warm-key journal replayed by a fresh
     two-worker fleet (the first statement's wall with the replay off,
     then on).  Zero hangs, zero unexpected outcomes, hash_insert
     launched in every chaos run.  Its launches ((a)-(c): in this
     process, the workers' /v1/info, the drill's coordinators) are
     ``launches_chaos``;
 24. ha: the HA coordinator fleet at SF 1 (``ha()``): (a) the takeover
     drill over the mix's join, two coordinator processes on the card
     with leases and watchers, A killed -9 with a committed attempt and
     B claiming its lease and WAL directory and finishing the query (no
     committed attempt re-executed, nothing claimed before the kill, rows
     equal the oracle's, hash_insert launched by B after the kill); (b)
     Q3, Q12 and R1 through a front tier over two statement servers of
     one distributed runner (the per-operator path of phase 19), each on
     its rendezvous owner with phase 3's rows, launching the three
     kernels, a disowned query rerouted and system.runtime.coordinators
     listing both; (c) the worker autoscaler growing a one-process fleet
     to two under queue pressure (Q3 launches hash_insert in the new
     worker) and draining it back to one while a Q3 is in flight.  Its
     launches are ``launches_ha``.
It prints the card line and one JSON line of kernels, and ends with
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import decimal
import faulthandler
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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
# the tpch path's queries run warm as well as cold in phase 3 (the others
# were cut to one run to keep the script within its time limit; Q18, Q21
# and R2 for phase 23)
PATH_WARM = ("Q1", "Q3", "Q12", "R1")
# phase 5's subset on the tpch path (Q18 and Q21 cut to keep the run within
# its time limit; phase 8 still times all of CAPTURE_QUERIES staged)
TPCH_OPERATORS = ("Q1", "Q3", "Q12", "R1", "R2")
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
# G3's ROLLUP puts all 5,998,321 rows of lineitem into one group (the grand
# total), and one float32 slot of the plain scatter-add drifts further: up
# to 1.66e-3 from the float64 sums on the H100 (the kernel: 9.15e-8).  The
# surface case states this tolerance for the plain version; every other
# case keeps PLAIN_VS_F64_RTOL.
PLAIN_VS_F64_RTOL_ROLLUP = 4e-3
REAL_PARITY_RTOL = 1e-4  # cuda (kernel) vs cpu (plain) at SF 0.1


T_START = time.perf_counter()
# the run must end within 1200 s, the kernels' build included; a run still
# going at this point prints every thread's stack to stderr and exits 1
WATCHDOG_S = 1140
# processes the script starts in the background (stopped at its end)
BACKGROUND: list = []


def log(msg: str) -> None:
    """One line of the report, prefixed with the seconds since start."""
    print(f"[{time.perf_counter() - T_START:7.1f}] {msg}", flush=True)


def progress(phase: str) -> None:
    """The end of a phase, on stderr, so a run cut short shows how far it
    came."""
    print(f"chip_smoke: phase {phase} done at "
          f"{time.perf_counter() - T_START:.1f} s", file=sys.stderr,
          flush=True)


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


def _home_slots(torch, h32, live, S: int) -> int:
    """Distinct home slots (h32 & (S - 1)) of the live rows: the random
    table sectors this run's keys touch at least once (rows of one key
    share theirs)."""
    slots = h32 if live is None else h32[live]
    return int(torch.unique(slots & (S - 1)).numel())


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
    homes = _home_slots(torch, h32, live, S)
    nbytes = (P * n * 4 + n * 4 + (0 if live is None else n)  # planes, h32,
              + n * 4 + P * S * 4 + S * 4  # live; row_gid, table, ids
              + SECTOR * homes)  # one random sector per home slot touched
    shape = (f"P={P} N={n} S={S} live={L} groups={got[1]} "
             f"home slots={homes}")
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
    homes = _home_slots(torch, h32, live, S)
    nbytes = (P * n * 4 + n * 4 + (0 if live is None else n) + n * 4
              + SECTOR * homes)
    shape = (f"P={P} N={n} S={S} live={L} hits={int((got >= 0).sum())} "
             f"home slots={homes}")
    extra = ", launch path us/call: " + ", ".join(
        f"{k} {v:.2f}" for k, v in parts.items())
    return dict(err=err, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                nbytes=nbytes, shape=shape, alone_ms=alone_ms, enq_us=enq,
                turns=turns, extra=extra, parts=parts, device_ms=device_ms)


def _segment_case(torch, GK, orig_seg, args,
                  plain_rtol: float = PLAIN_VS_F64_RTOL):
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
    if k_rel > KERNEL_VS_F64_RTOL or p_rel > plain_rtol:
        raise AssertionError(
            f"masked_segment_sum_f32 vs float64: kernel {k_rel:.3g} "
            f"(limit {KERNEL_VS_F64_RTOL}), plain {p_rel:.3g} "
            f"(limit {plain_rtol})")
    # kernel vs plain on the same inputs: within the plain version's drift
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=plain_rtol, atol=0.0):
        raise AssertionError(f"masked_segment_sum_f32 != plain (max abs "
                             f"diff {err}, rtol {plain_rtol})")
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
# Q1 of bench.py's QUERIES (the same text); Q3, and the customer and
# orders staging it needs (30 s of host generation for customer), were cut
# to keep the run within its time limit
SF10_QUERIES = ("Q1",)
SF10_TABLES = ("lineitem",)


def run_path(torch, GK, runner, sqls: dict, label: str,
             required: dict = REQUIRED, exact: bool = False,
             scans: dict = None, warm_launches: dict = None,
             warm_names=None) -> tuple:
    """Every query cold then warm (with ``warm_names``, only those warm;
    the others report their cold run's rows and None for warm ms): rows,
    (cold ms, warm ms, peak MiB) and
    kernel launches per query; fails if a query misses a kernel that
    ``required`` names for it (on the main path, REQUIRED names every
    kernel), and with ``exact`` also if it launches one not named.  With
    ``scans`` (a dict) the cold run collects QueryStats and ``scans[name]``
    gets its scan roll-up (rows pruned, bytes copied to the card); with
    ``warm_launches`` (a dict) ``warm_launches[name]`` gets the warm run's
    launches."""
    from trino_tpu_torch.exec.stats import QueryStats

    rows, timings, per_query = {}, {}, {}
    t_path = time.perf_counter()
    GK.reset_launch_counts()
    for name, sql in sqls.items():
        before = dict(GK.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        st = QueryStats() if scans is not None else None
        t0 = time.perf_counter()
        res = runner.execute(sql, stats=st)
        torch.cuda.synchronize()
        if st is not None:
            scans[name] = st.scan
        cold = (time.perf_counter() - t0) * 1e3
        mid = dict(GK.LAUNCHES)
        warm = None
        if warm_names is None or name in warm_names:
            t0 = time.perf_counter()
            res = runner.execute(sql)
            torch.cuda.synchronize()
            warm = (time.perf_counter() - t0) * 1e3
        if warm_launches is not None:
            warm_launches[name] = {k: GK.LAUNCHES[k] - mid[k]
                                   for k in GK.LAUNCHES}
        peak = torch.cuda.max_memory_allocated() / 2**20
        rows[name] = res.rows()
        timings[name] = (cold, warm, peak)
        per_query[name] = {k: GK.LAUNCHES[k] - before[k]
                           for k in GK.LAUNCHES}
        warm_text = "no warm run" if warm is None else f"warm {warm:.1f} ms"
        log(f"{label} {name}: {len(rows[name])} rows, cold {cold:.1f} ms, "
            f"{warm_text}, peak device memory {peak:.1f} MiB, "
            f"launches {per_query[name]}")
    launches = dict(GK.LAUNCHES)
    log(f"{label} launches: {launches} "
        f"({time.perf_counter() - t_path:.1f} s for {len(sqls)} queries)")
    for name, kernels in required.items():
        for k in kernels:
            if per_query[name][k] <= 0:
                raise AssertionError(f"{label} {name} launched no {k}")
        for k, n in per_query[name].items():
            if exact and n and k not in kernels:
                raise AssertionError(f"{label} {name} launched {k} {n} "
                                     f"times; it names only {kernels}")
    return rows, timings, launches


def per_operator(QueryStats, runner, sqls: dict, label: str,
                 names=CAPTURE_QUERIES) -> dict:
    """One run of each query of ``names`` with the device synchronized
    after every operator call; returns name -> (total ms, operator class ->
    seconds)."""
    out = {}
    for name in names:
        st = QueryStats(per_op_sync=True)
        t0 = time.perf_counter()
        runner.execute(sqls[name], stats=st)
        total = (time.perf_counter() - t0) * 1e3
        ops = ", ".join(f"{k} {v * 1e3:.1f}"
                        for k, v in sorted(st.by_operator().items(),
                                           key=lambda kv: -kv[1]))
        log(f"operators {label} {name} (sync, {total:.1f} ms): {ops}")
        out[name] = (total, st.by_operator())
    return out


def capture_calls(GK, runs) -> dict:
    """(query label, kernel) -> the arguments of every wrapper call, from
    one more run of each (label, runner, sql) in ``runs``."""
    captured: dict = {}
    current = {"q": None}
    orig = {k: getattr(GK, k) for k in SOURCES}

    def spy(kernel):
        def call(*args, **kw):  # keywords (count_on_device) not recorded
            captured.setdefault((current["q"], kernel), []).append(args)
            return orig[kernel](*args, **kw)
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


class _Program:
    """A callable in capture_calls' runner slot: ``execute`` calls it."""

    def __init__(self, fn):
        self.fn = fn

    def execute(self, _sql):
        return self.fn()


class _Off:
    """A distributed runner in capture_calls' runner slot, run with the
    compiled stages off (phase 19's path)."""

    def __init__(self, runner):
        self.runner = runner

    def execute(self, sql):
        with _compiled_off():
            return self.runner.execute(sql)


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


def host_generated(mem, table: str) -> tuple:
    """(staged batch, the host generator's batch) of the staged TPC-H
    ``table`` (orders or lineitem) at PATH_SF.  The fresh host generator's
    dictionary cache holds the staged vocabularies: it then maps each
    row's vocabulary index through them instead of first building its
    data-derived dictionaries (python strings for 6 M comments: minutes at
    SF 1), and equal codes mean equal strings."""
    from trino_tpu_torch.connectors.tpch import TpchConnector

    (split,) = mem.get_splits(table, 1, 1)
    cols = mem.get_table_schema(table).column_names()
    staged = mem.create_page_source(split, cols).get_next_batch()
    tpch = TpchConnector(PATH_SF)
    for name in cols:
        if staged.column(name).dictionary is not None:
            tpch._dict_cache[(table, name)] = staged.column(name).dictionary
    return staged, tpch._generate(table, cols, 0, tpch.row_count("orders"))


def stage_sf1(torch, default_catalog, stage_memory_tables):
    """Phase 7: all eight tables into memory on cuda, orders and lineitem
    checked column by column against the host generator."""
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
        staged, host = host_generated(mem, t)
        if staged.num_rows != host.num_rows or staged.live is not None:
            raise AssertionError(f"staged {t}: {staged.num_rows} rows")
        for name in staged.names:
            _same_generated(torch, staged.column(name), host.column(name),
                            f"staged {t}.{name}")
        log(f"staging SF{PATH_SF:g} {t}: {len(staged.names)} columns x "
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
    """Phase 9: Q1 at SF 10 over lineitem, staged."""
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


def optimizers(torch, StandaloneQueryRunner, staged_cat, tpch_catalog,
               sqls: dict) -> None:
    """Phase 10: every query over the staged tables under the legacy and
    the iterative optimizer: plans compared, rows equal, planning ms (the
    median of 5 create_plan calls) and warm ms per mode; then the tpch
    path's planning ms of CAPTURE_QUERIES per mode, with the lineitem row
    count memoized and
    recomputed on every statistics call as it was before
    (tools/planning_ms.py); then EXPLAIN ANALYZE of Q3 and Q21 on the
    card."""
    from trino_tpu_torch.tools.planning_ms import median_ms, planning_ms

    runners = {mode: StandaloneQueryRunner(
        staged_cat, device="cuda", default_catalog_name="memory",
        splits_per_node=1, optimizer=mode) for mode in ("legacy",
                                                        "iterative")}
    same_plans = 0
    for name, sql in sqls.items():
        out = {}
        for mode, r in runners.items():
            plan_ms = median_ms(lambda: r.create_plan(sql))
            rows = r.execute(sql).rows()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.execute(sql)
            torch.cuda.synchronize()
            out[mode] = (r.explain(sql), rows, plan_ms,
                         (time.perf_counter() - t0) * 1e3)
        same = out["legacy"][0] == out["iterative"][0]
        same_plans += same
        rtol = KERNEL_VS_F64_RTOL if name in REAL_QUERIES else DOUBLE_RTOL
        worst = same_rows(out["iterative"][1], out["legacy"][1],
                          f"optimizers {name} iterative vs legacy", rtol)
        log(f"optimizers {name}: plans {'identical' if same else 'differ'}, "
            f"{len(out['legacy'][1])} rows equal (largest float rel diff "
            f"{worst:.3g}, limit {rtol:g}); planning ms legacy "
            f"{out['legacy'][2]:.2f}, iterative {out['iterative'][2]:.2f}; "
            f"warm ms legacy {out['legacy'][3]:.1f}, iterative "
            f"{out['iterative'][3]:.1f}")
    log(f"optimizers: {same_plans} of {len(sqls)} plans identical")
    for name in CAPTURE_QUERIES:  # the 24 cut to the subset for phase 24
        ms = planning_ms(tpch_catalog, sqls[name])
        log(f"planning tpch SF{PATH_SF:g} {name}: legacy {ms['legacy']:.2f}"
            f" ms ({ms['legacy_recomputed']:.2f} recomputing the lineitem "
            f"row count per statistics call), iterative "
            f"{ms['iterative']:.2f} ms ({ms['iterative_recomputed']:.2f})")
    for name in ("Q3", "Q21"):
        res = runners["iterative"].execute("EXPLAIN ANALYZE " + sqls[name])
        log(f"EXPLAIN ANALYZE {name} (staged SF{PATH_SF:g}, cuda):")
        for (line,) in res.rows():
            log("  | " + line)


# ---------------------------------------------------------------------------
# phase 11: the surface queries


def _rows_sorted(rows: list) -> list:
    """ORDER BY every column ascending, NULLs last (Trino's default)."""
    return sorted(rows, key=lambda r: tuple((x is None, 0 if x is None
                                             else x) for x in r))


def _grouped_sums(inv, n_groups, cols) -> list:
    """Exact per-group sums of int64 columns (sort + reduceat)."""
    order = np.argsort(inv, kind="stable")
    starts = np.searchsorted(inv[order], np.arange(n_groups))
    return [np.add.reduceat(c[order], starts) for c in cols]


def surface_numpy(read, name: str) -> list:
    """U1, U4, G1, G3, J1, J3 by numpy over staged columns."""
    if name == "U1":
        li = read("lineitem", ["l_orderkey"])
        od = read("orders", ["o_orderkey"])
        return [(int(np.union1d(li["l_orderkey"], od["o_orderkey"]).size),)]
    if name == "U4":
        li = read("lineitem", ["l_partkey"])
        ps = read("partsupp", ["ps_partkey"])
        n = int(max(li["l_partkey"].max(), ps["ps_partkey"].max())) + 1
        return [(int(np.minimum(np.bincount(li["l_partkey"], minlength=n),
                                np.bincount(ps["ps_partkey"],
                                            minlength=n)).sum()),)]
    if name == "G1":
        li = read("lineitem", ["l_returnflag", "l_linestatus", "l_shipmode",
                               "l_quantity", "l_extendedprice",
                               "l_discount"])
        keys = [li["l_returnflag"], li["l_linestatus"], li["l_shipmode"]]
        rows = []
        for width, mask in ((3, 0), (2, 1), (1, 3), (0, 7)):
            fused = np.zeros(len(keys[0].codes), np.int64)
            for k in keys[:width]:  # one mixed-radix code per key tuple
                fused = fused * len(k.dictionary) + k.codes
            uk, inv = np.unique(fused, return_inverse=True)
            g = len(uk)
            sq, se, sd = _grouped_sums(inv, g, [
                li["l_quantity"], li["l_extendedprice"], li["l_discount"]])
            cnt = np.bincount(inv, minlength=g)
            for j in range(g):
                ks, code = [], int(uk[j])
                for k in reversed(keys[:width]):
                    code, c = divmod(code, len(k.dictionary))
                    ks.insert(0, str(k.dictionary[c]))
                rows.append(tuple(ks + [None] * (3 - width)) + (
                    mask, _dec(sq[j], 2), _dec(se[j], 2),
                    float(sd[j] / 100.0 / cnt[j]), int(cnt[j])))
        return _rows_sorted(rows)
    if name == "G3":
        rows = real_oracle(read, "R1")
        li = read("lineitem", ["l_quantity", "l_extendedprice"])
        total = [float(np.sum((li[c] / 100.0).astype(np.float32).astype(
            np.float64))) for c in ("l_quantity", "l_extendedprice")]
        return rows + [(None, *total)]
    if name == "J1":
        od = read("orders", ["o_custkey"])
        cu = read("customer", ["c_custkey"])
        pairs = int(np.isin(od["o_custkey"], cu["c_custkey"]).sum())
        un_o = len(od["o_custkey"]) - pairs
        un_c = int((~np.isin(cu["c_custkey"], od["o_custkey"])).sum())
        return [(pairs + un_o + un_c, pairs + un_o, pairs + un_c)]
    if name == "J3":
        # pairs (a, b) of one customer with a.price > 2 * b.price, in
        # cents: b's keys sorted as custkey * 2^30 + 2 * price
        od = read("orders", ["o_custkey", "o_totalprice"])
        ck, pc = od["o_custkey"].astype(np.int64), od["o_totalprice"]
        bkeys = np.sort(ck * (1 << 30) + 2 * pc)
        lo = np.searchsorted(bkeys, ck * (1 << 30))
        hi = np.searchsorted(bkeys, ck * (1 << 30) + pc)
        per_a = hi - lo
        pairs = int(per_a.sum())
        un_a = int((per_a == 0).sum())
        top = np.zeros(int(ck.max()) + 1, np.int64)
        np.maximum.at(top, ck, pc)
        un_b = int((top[ck] <= 2 * pc).sum())
        return [(pairs + un_a + un_b, pairs + un_a, pairs + un_b)]
    raise ValueError(name)


SURFACE_NUMPY = ("U1", "U4", "G1", "G3", "J1", "J3")
SURFACE_OPERATORS = ("G1", "U1", "J3")
SURFACE_CAPTURE = ("G1", "J3", "G3")  # the calls of phase 6's cases
WINDOW_CAPTURE = ("W3", "W5", "W7")  # the hash_insert calls of phase 6


def surface(torch, GK, QueryStats, StandaloneQueryRunner, default_catalog,
            staged_cat) -> dict:
    """Phase 11: the surface queries over the staged SF 1 tables (timing
    and launches, numpy checks, per-operator times) and at SF 0.1 on cuda
    and cpu.  Returns their launches on the staged path."""
    from trino_tpu_torch.connectors.surface_queries import (KERNELS,
                                                            SURFACE_QUERIES)

    t_phase = time.perf_counter()
    staged = StandaloneQueryRunner(staged_cat, device="cuda",
                                   default_catalog_name="memory",
                                   splits_per_node=1)
    rows, _, launches = run_path(torch, GK, staged, SURFACE_QUERIES,
                                 f"surface SF{PATH_SF:g}", KERNELS)
    read = staged_reader(staged_cat.connector("memory"))
    for name in SURFACE_NUMPY:
        t0 = time.perf_counter()
        rtol = KERNEL_VS_F64_RTOL if name == "G3" else DOUBLE_RTOL
        worst = same_rows(rows[name], surface_numpy(read, name),
                          f"surface SF{PATH_SF:g} {name} vs numpy", rtol)
        log(f"surface SF{PATH_SF:g} {name}: {len(rows[name])} rows equal "
            f"the numpy evaluation of the staged columns (largest float rel "
            f"diff {worst:.3g}, limit {rtol:g}; "
            f"{time.perf_counter() - t0:.1f} s)")
    per_operator(QueryStats, staged, SURFACE_QUERIES,
                 f"surface SF{PATH_SF:g}", SURFACE_OPERATORS)
    t0 = time.perf_counter()
    cat = default_catalog(PARITY_SF)
    r_gpu = StandaloneQueryRunner(cat, device="cuda")
    r_cpu = StandaloneQueryRunner(cat, device="cpu")
    for name, sql in SURFACE_QUERIES.items():
        g = r_gpu.execute(sql).rows()
        c = r_cpu.execute(sql).rows()
        worst = same_rows(g, c, f"surface SF{PARITY_SF:g} {name} cuda vs cpu",
                          REAL_PARITY_RTOL if name == "G3" else DOUBLE_RTOL)
        log(f"surface parity SF{PARITY_SF:g} {name}: {len(g)} rows equal on "
            f"cuda and cpu (largest float rel diff {worst:.3g})")
    log(f"surface parity: {time.perf_counter() - t0:.1f} s")
    log(f"surface: {time.perf_counter() - t_phase:.1f} s for phase 11 "
        f"(12 queries at SF{PATH_SF:g} cold and warm, numpy checks of "
        f"{len(SURFACE_NUMPY)}, per-operator runs of "
        f"{len(SURFACE_OPERATORS)}, parity at SF{PARITY_SF:g})")
    return launches


# ---------------------------------------------------------------------------
# phase 12: window functions and MATCH_RECOGNIZE


def _partition_starts(keys: np.ndarray) -> np.ndarray:
    """Index of each sorted row's partition start."""
    start = np.r_[True, keys[1:] != keys[:-1]]
    return np.maximum.accumulate(np.where(start, np.arange(len(keys)), 0))


def window_numpy(read, name: str) -> list:
    """W1, W2, W4, W7 by numpy over staged columns (exact: DECIMAL and
    integer results)."""
    if name == "W1":
        od = read("orders", ["o_orderkey", "o_custkey", "o_totalprice"])
        pr = od["o_totalprice"]
        order = np.lexsort((od["o_orderkey"], -pr, od["o_custkey"]))
        rn = np.arange(len(order)) - _partition_starts(
            od["o_custkey"][order]) + 1
        keep = order[rn <= 3]
        return [(int(keep.size), _dec(pr[keep].sum(), 2))]
    if name == "W2":
        li = read("lineitem", ["l_orderkey", "l_linenumber",
                               "l_extendedprice", "l_discount"])
        order = np.lexsort((li["l_linenumber"], li["l_orderkey"]))
        v = (li["l_extendedprice"] * (100 - li["l_discount"]))[order]
        cs = np.cumsum(v)
        st = _partition_starts(li["l_orderkey"][order])
        rs = cs - cs[st] + v[st]
        return [(int(rs.size), _dec(rs.sum(), 4), _dec(rs.max(), 4))]
    if name == "W4":
        od = read("orders", ["o_orderkey", "o_custkey", "o_orderdate",
                             "o_totalprice"])
        order = np.lexsort((od["o_orderkey"], od["o_orderdate"],
                            od["o_custkey"]))
        c, p = od["o_custkey"][order], od["o_totalprice"][order]
        prev = c[1:] == c[:-1]  # row i + 1 has a row before it
        next2 = np.r_[c[2:] == c[:-2], False, False]
        nxt = np.where(next2, np.r_[p[2:], 0, 0], 0)
        return [(int(p.size), int(p.size - prev.sum()),
                 _dec((p[1:] - p[:-1])[prev].sum(), 2), _dec(nxt.sum(), 2))]
    if name == "W7":
        od = read("orders", ["o_orderkey", "o_totalprice"])
        order = np.lexsort((od["o_orderkey"], od["o_totalprice"]))
        p = od["o_totalprice"][order]
        n, tiles = len(p), 100
        size, rem = n // tiles, n % tiles
        rn0 = np.arange(n)
        big = rem * (size + 1)
        t = np.where(rn0 < big, rn0 // (size + 1),
                     rem + (rn0 - big) // max(size, 1)) + 1
        ut, first, cnt = np.unique(t, return_index=True, return_counts=True)
        return [(int(k), int(c), _dec(p[f], 2), _dec(p[f + c - 1], 2))
                for k, f, c in zip(ut, first, cnt)]
    raise ValueError(name)


def m1_plain(read, max_custkey: int) -> list:
    """M1 (a V: one row, then falling prices, then rising ones; greedy,
    skip past the match) by a plain scan over the staged orders of
    customers up to ``max_custkey``."""
    od = read("orders", ["o_orderkey", "o_custkey", "o_orderdate",
                         "o_totalprice"])
    cut = od["o_custkey"] <= max_custkey
    order = np.lexsort((od["o_orderkey"][cut], od["o_orderdate"][cut],
                        od["o_custkey"][cut]))
    c = od["o_custkey"][cut][order].tolist()
    p = od["o_totalprice"][cut][order].tolist()
    matches = rows = top = 0
    i, n = 0, len(c)
    while i < n:
        j = i
        while j < n and c[j] == c[i]:
            j += 1
        mno, s = 0, i
        while s < j:
            k = s + 1
            while k < j and p[k] < p[k - 1]:
                k += 1
            u = k
            while k > s + 1 and u < j and p[u] > p[u - 1]:
                u += 1
            if u == k:  # no fall, or no rise after it
                s += 1
                continue
            mno += 1
            rows += u - s
            s = u
        matches += mno
        top = max(top, mno)
        i = j
    return [(matches, rows, top)]


WINDOW_NUMPY = ("W1", "W2", "W4", "W7")
WINDOW_OPERATORS = ("W2", "W6", "W7")


def windows(torch, GK, QueryStats, StandaloneQueryRunner, default_catalog,
            staged_cat) -> dict:
    """Phase 12: W1-W8 over the staged SF 1 tables (timing and launches,
    numpy checks, per-operator times and the Window operator's share), at
    SF 0.1 on cuda and cpu, and M1 over a CTAS cut of the staged orders.
    Returns the W queries' launches on the staged path."""
    from trino_tpu_torch.connectors.window_queries import (
        KERNELS, M1_CUT, M1_MAX_CUSTKEY, WINDOW_QUERIES, m1_text)

    t_phase = time.perf_counter()
    staged = StandaloneQueryRunner(staged_cat, device="cuda",
                                   default_catalog_name="memory",
                                   splits_per_node=1)
    label = f"windows SF{PATH_SF:g}"
    rows, _, launches = run_path(
        torch, GK, staged, WINDOW_QUERIES, label,
        {k: v for k, v in KERNELS.items() if k in WINDOW_QUERIES})
    read = staged_reader(staged_cat.connector("memory"))
    for name in WINDOW_NUMPY:
        t0 = time.perf_counter()
        same_rows(rows[name], window_numpy(read, name),
                  f"{label} {name} vs numpy", 0.0)
        log(f"{label} {name}: {len(rows[name])} rows equal the numpy "
            f"evaluation of the staged columns exactly "
            f"({time.perf_counter() - t0:.1f} s)")
    for name, (total, ops) in per_operator(
            QueryStats, staged, WINDOW_QUERIES, label,
            WINDOW_OPERATORS).items():
        win = ops.get("WindowOperator", 0.0) * 1e3
        log(f"{label} {name}: WindowOperator {win:.1f} ms of {total:.1f} ms "
            f"synchronized ({win / total:.1%})")

    # M1 over a CTAS cut of the staged orders (matching is host Python)
    t0 = time.perf_counter()
    staged.execute(f"create table ord_m1 as {M1_CUT}")
    torch.cuda.synchronize()
    log(f"{label} M1 cut: ord_m1 = {M1_CUT!r} by CTAS on cuda in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    m1 = {"M1": m1_text("ord_m1")}
    m1_rows, _, _ = run_path(torch, GK, staged, m1, label,
                             {"M1": KERNELS["M1"]})
    same_rows(m1_rows["M1"], m1_plain(read, M1_MAX_CUSTKEY),
              f"{label} M1 vs the plain scan")
    log(f"{label} M1: {m1_rows['M1']} equals the plain scan of the staged "
        f"orders")
    staged.execute("drop table ord_m1")

    t0 = time.perf_counter()
    cat = default_catalog(PARITY_SF)
    r_gpu = StandaloneQueryRunner(cat, device="cuda")
    r_cpu = StandaloneQueryRunner(cat, device="cpu")
    for name, sql in WINDOW_QUERIES.items():
        g = r_gpu.execute(sql).rows()
        c = r_cpu.execute(sql).rows()
        worst = same_rows(g, c, f"windows SF{PARITY_SF:g} {name} cuda vs cpu")
        log(f"windows parity SF{PARITY_SF:g} {name}: {len(g)} rows equal on "
            f"cuda and cpu (largest float rel diff {worst:.3g})")
    m1_out = []
    for device in ("cuda", "cpu"):
        r = StandaloneQueryRunner(default_catalog(PARITY_SF), device=device,
                                  default_catalog_name="memory")
        r.execute(f"create table ord_m1 as "
                  f"{M1_CUT.replace('orders', 'tpch.orders')}")
        m1_out.append(r.execute(m1_text("ord_m1")).rows())
    same_rows(m1_out[0], m1_out[1], f"windows SF{PARITY_SF:g} M1 cuda vs cpu")
    log(f"windows parity SF{PARITY_SF:g} M1: {m1_out[0]} on cuda and cpu")
    log(f"windows parity: {time.perf_counter() - t0:.1f} s")
    log(f"windows: {time.perf_counter() - t_phase:.1f} s for phase 12 "
        f"({len(WINDOW_QUERIES)} queries at SF{PATH_SF:g} cold and warm, "
        f"numpy checks of {len(WINDOW_NUMPY)}, per-operator runs of "
        f"{len(WINDOW_OPERATORS)}, M1 over its cut, parity at "
        f"SF{PARITY_SF:g})")
    return launches


# ---------------------------------------------------------------------------
# phase 13: nested types, long decimals, JSON and table functions


def nested_plain(parts: dict, name: str) -> list:
    """N1, N2, N5 and N9 by numpy and python ints over the arrays
    ``orders_nested`` is built from (exact)."""
    od, li = parts["orders"], parts["lineitem"]
    nlines = parts["hi"] - parts["lo"]
    sm_codes, sm_dict = li["l_shipmode"]
    rf_codes, rf_dict = li["l_returnflag"]
    order_of_line = np.repeat(np.arange(len(nlines)), nlines)
    returned = rf_codes == list(map(str, rf_dict)).index("R")
    if name == "N1":
        air = sm_codes == list(map(str, sm_dict)).index("AIR")
        return [(len(nlines), int(nlines.sum()), int(nlines.max()),
                 int(np.unique(order_of_line[air]).size),
                 int(returned.sum()))]
    if name == "N2":
        codes, counts = np.unique(sm_codes, return_counts=True)
        return sorted((str(sm_dict[c]), int(n))
                      for c, n in zip(codes, counts))
    if name == "N5":
        st_codes, st_dict = od["o_orderstatus"]
        price = od["o_totalprice"]  # scale 2
        keep = price > 10_000_000  # > 100000.000000000000000001 at scale 18
        out = []
        for c in np.unique(st_codes[keep]):
            p = [int(v) * 10 ** 16 for v in price[keep & (st_codes == c)]]
            total, n = sum(p), len(p)
            avg = (2 * total + n) // (2 * n)  # HALF_UP, positive values
            out.append((str(st_dict[c]), _dec(total, 18), _dec(avg, 18),
                        _dec(min(p), 18), _dec(max(p), 18), n))
        return sorted(out)
    if name == "N9":
        r_order = order_of_line[returned]
        n = np.arange(r_order.size) - np.searchsorted(r_order, r_order) + 1
        keys, counts = np.unique(
            np.stack([sm_codes[returned].astype(np.int64), n]), axis=1,
            return_counts=True)
        return sorted((str(sm_dict[m]), int(k), int(c))
                      for (m, k), c in zip(keys.T, counts))
    raise ValueError(name)


NESTED_NUMPY = ("N1", "N2", "N5", "N9")
NESTED_OPERATORS = ("N2", "N3", "N5")
# traced, with the top device operations (a subset, so the whole script
# stays in its time limit)
# N4 and N5 were cut to make room for phase 20
NESTED_PROFILE = ("N2",)  # N3 cut to fit the time limit
NESTED_CAPTURE = ("N3", "N4", "N6", "N9", "N10")  # phase 6's nested insert
NESTED_TABLES = ("orders", "lineitem", "customer", "part")


def nested(torch, GK, QueryStats, StandaloneQueryRunner, default_catalog,
           staged_cat) -> dict:
    """Phase 13: orders_nested built from the staged SF 1 tables, N1-N11
    on cuda (timing, launches against KERNELS both ways, device busy time
    and host share), numpy checks of N1, N2, N5 and N9, per-operator times
    of N2, N3 and N5, and all eleven at SF 0.1 on cuda and on cpu.
    Returns the N queries' launches."""
    from trino_tpu_torch.connectors.nested_queries import (
        KERNELS, NESTED_QUERIES, build_orders_nested, nested_parts)
    from trino_tpu_torch.connectors.staging import stage_memory_tables
    from trino_tpu_torch.tools.window_profile import WALL_RUNS, profile

    t_phase = time.perf_counter()
    label = f"nested SF{PATH_SF:g}"
    info = build_orders_nested(staged_cat, "cuda")
    log(f"{label} orders_nested: {info['rows']} rows, {info['bytes']} device "
        f"bytes, dictionary entries {info['dictionaries']}, built in "
        f"{info['seconds']:.2f} s from the staged orders, lineitem and "
        f"customer")
    staged = StandaloneQueryRunner(staged_cat, device="cuda",
                                   default_catalog_name="memory",
                                   splits_per_node=1)
    rows, _, launches = run_path(torch, GK, staged, NESTED_QUERIES,
                                       label, KERNELS, exact=True)

    t0 = time.perf_counter()
    parts = nested_parts(staged_cat)
    for name in NESTED_NUMPY:
        same_rows(rows[name], nested_plain(parts, name),
                  f"{label} {name} vs the plain evaluation", 0.0)
        log(f"{label} {name}: {len(rows[name])} rows equal the plain "
            f"evaluation of the table's source arrays exactly")
    del parts
    log(f"{label} plain evaluations: {time.perf_counter() - t0:.1f} s")

    for name, (total, ops) in per_operator(
            QueryStats, staged, NESTED_QUERIES, label,
            NESTED_OPERATORS).items():
        shares = ", ".join(
            f"{op} {ops.get(op, 0.0) * 1e3:.1f} ms "
            f"({ops.get(op, 0.0) * 1e3 / total:.1%})"
            for op in ("UnnestOperator", "HashAggregationOperator"))
        log(f"{label} {name}: {shares} of {total:.1f} ms synchronized")

    t0 = time.perf_counter()
    for name in NESTED_PROFILE:
        wall, traced, busy, ops = profile(staged, NESTED_QUERIES[name])
        log(f"{label} {name}: device busy {busy:.2f} ms of {wall:.2f} ms "
            f"warm wall (median of {WALL_RUNS} unprofiled runs; traced "
            f"{traced:.2f} ms): idle, the host's share, {1 - busy / wall:.1%}")
        log(f"{label} {name} most device time: " + "; ".join(
            f"{key} {ms:.3f} ms x{calls}" for key, ms, calls in ops[:6]))
    log(f"{label} device profiles: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    out = {}
    for device in ("cuda", "cpu"):
        cat = default_catalog(PARITY_SF)
        stage_memory_tables(cat, NESTED_TABLES, device)
        build_orders_nested(cat, device)
        r = StandaloneQueryRunner(cat, device=device,
                                  default_catalog_name="memory",
                                  splits_per_node=1)
        out[device] = {n: r.execute(q).rows()
                       for n, q in NESTED_QUERIES.items()}
    for name in NESTED_QUERIES:
        same_rows(out["cuda"][name], out["cpu"][name],
                  f"nested SF{PARITY_SF:g} {name} cuda vs cpu", 0.0)
        log(f"nested parity SF{PARITY_SF:g} {name}: "
            f"{len(out['cuda'][name])} rows equal on cuda and cpu")
    log(f"nested parity: {time.perf_counter() - t0:.1f} s")
    log(f"nested: {time.perf_counter() - t_phase:.1f} s for phase 13 "
        f"(orders_nested at SF{PATH_SF:g}, {len(NESTED_QUERIES)} queries "
        f"cold and warm, plain checks of {len(NESTED_NUMPY)}, per-operator "
        f"runs of {len(NESTED_OPERATORS)}, device profiles, parity at "
        f"SF{PARITY_SF:g})")
    return launches


# ---------------------------------------------------------------------------
# phase 14: the scan ingest path on the tpch path


# Q5, Q17 and Q18 were cut from the turns to make room for phase 20, Q12
# and Q21 (turns and profile) to keep the run within its time limit; Q3's
# orders build is the large build whose domain the phase checks
INGEST_QUERIES = ("Q1", "Q3")
INGEST_PROFILE = ("Q1",)
PAGEABLE_LIMIT = 0.01  # pageable share of Q1's scan bytes, ingest on
PINNED = "Memcpy HtoD (Pinned -> Device)"
PAGEABLE = "Memcpy HtoD (Pageable -> Device)"


def _host_domain(data, valid, live, dict_len: int) -> tuple:
    """The plain numpy domain of build keys: (count, non-NaN count, min,
    max, presence per dictionary code)."""
    ok = np.ones(data.shape[0], bool)
    for m in (valid, live):
        if m is not None:
            ok &= m
    keys = data[ok]
    cnt = int(keys.size)
    if keys.dtype.kind == "f":
        keys = keys[~np.isnan(keys)]
    presence = np.zeros(dict_len, bool)
    if dict_len:
        presence[np.unique(keys)] = True
    lo, hi = (keys.min(), keys.max()) if keys.size else (None, None)
    return cnt, int(keys.size), lo, hi, presence


def ingest(torch, StandaloneQueryRunner, catalog, sqls: dict,
           scans: dict, staged_cat) -> None:
    """Phase 14: the tpch path's scan ingest at SF 1.  The rows pruned and
    the bytes copied to the card per query (phase 3's cold runs); warm ms
    of INGEST_QUERIES under four settings in one process, rows equal; one
    traced warm run of Q1 with ingest on and off (device busy ms,
    idle share of the unprofiled warm wall, host-to-device bytes by copy
    kind); fails if more than PAGEABLE_LIMIT of Q1's scan bytes cross from
    pageable memory with ingest on; and the first build of more than
    65,536 keys whose domain fill_device derives on the card, against the
    host domain of the same keys.  Last, the staged path (device-resident
    batches, which skip the new path) with the default ingest against
    IngestConfig(enabled=False), in turns (on, off, off, on), rows equal."""
    import os

    from trino_tpu_torch.exec import dynamic_filter as DF
    from trino_tpu_torch.exec.kernels import _device_domain
    from trino_tpu_torch.exec.prefetch import IngestConfig
    from trino_tpu_torch.exec.stats import QueryStats
    from trino_tpu_torch.tools.window_profile import trace

    t_phase = time.perf_counter()
    label = f"ingest SF{PATH_SF:g}"
    log(f"{label}: os.cpu_count() {os.cpu_count()}, prefetch threads "
        f"{IngestConfig().threads}")
    for name in sqls:
        sc = scans[name]
        log(f"{label} {name}: rows pruned by dynamic filters "
            f"{sc.rows_pruned}, host-to-device bytes {sc.h2d_bytes} (scan "
            f"{sc.scan_rows} rows, {sc.scan_bytes} bytes, "
            f"{sc.scan_batches} batches -> {sc.coalesced_batches} "
            f"coalesced, {sc.splits_opened} splits)")
    log(f"{label}: {sum(s.rows_pruned for s in scans.values())} rows pruned"
        f", {sum(s.h2d_bytes for s in scans.values())} bytes to the card "
        f"for the {len(scans)} queries")

    settings = {"default": {},
                "dynamic_filtering=False": {"dynamic_filtering": False},
                "IngestConfig(enabled=False)": {
                    "ingest": IngestConfig(enabled=False)},
                "encoded_exec=False": {"encoded_exec": False}}
    runners = {k: StandaloneQueryRunner(catalog, device="cuda", **kw)
               for k, kw in settings.items()}
    walls, big = {}, {}
    fill_device = DF.DynamicFilterHolder.fill_device

    def spy(holder, data, valid, live, dictionary):
        if not big and data.shape[0] > DF.MAX_DISTINCT_SET:
            big.update(data=data.clone(), valid=valid, live=live,
                       dict_len=0 if dictionary is None else len(dictionary))
        return fill_device(holder, data, valid, live, dictionary)

    DF.DynamicFilterHolder.fill_device = spy
    try:
        for name in INGEST_QUERIES:
            want, cells = None, []
            for setting, r in runners.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = r.execute(sqls[name])
                torch.cuda.synchronize()
                walls[(name, setting)] = (time.perf_counter() - t0) * 1e3
                rows = res.rows()
                if want is None:
                    want = rows
                else:
                    same_rows(rows, want, f"{label} {name} {setting} vs "
                              "default", DOUBLE_RTOL)
                cells.append(f"{setting} {walls[(name, setting)]:.1f}")
            log(f"{label} {name} warm ms: {', '.join(cells)}; "
                f"{len(want)} rows equal under all four (doubles rtol "
                f"{DOUBLE_RTOL:g})")
    finally:
        DF.DynamicFilterHolder.fill_device = fill_device

    for name in INGEST_PROFILE:
        for setting in ("default", "IngestConfig(enabled=False)"):
            st = QueryStats()
            traced, busy, ops, htod = trace(runners[setting], sqls[name],
                                            stats=st)
            wall = walls[(name, setting)]
            pinned, pageable = htod.get(PINNED, 0), htod.get(PAGEABLE, 0)
            log(f"{label} {name} [{setting}]: device busy {busy:.2f} ms of "
                f"{wall:.2f} ms warm wall (traced {traced:.2f} ms): idle "
                f"{1 - busy / wall:.1%}; host-to-device {pinned} bytes "
                f"pinned, {pageable} pageable, other kinds "
                f"{ {k: v for k, v in htod.items() if k not in (PINNED, PAGEABLE)} }"
                f"; scan bytes to the card {st.scan.h2d_bytes}")
            log(f"{label} {name} [{setting}] most device time: " + "; ".join(
                f"{key} {ms:.3f} ms x{calls}" for key, ms, calls in ops[:5]))
            if busy <= 0:
                raise AssertionError(f"{label} {name}: no device time traced")
            if name == "Q1" and setting == "default":
                if not st.scan.h2d_bytes:
                    raise AssertionError(f"{label} Q1: the scan copied "
                                         "nothing to the card")
                share = pageable / st.scan.h2d_bytes
                log(f"{label} Q1: pageable copies {share:.3%} of the scan's "
                    f"{st.scan.h2d_bytes} bytes (limit {PAGEABLE_LIMIT:.0%})")
                if share > PAGEABLE_LIMIT:
                    raise AssertionError(
                        f"{label} Q1: {share:.2%} of the scan bytes crossed "
                        "from pageable memory: staging missed the pinned "
                        "side-stream route")

    if not big:
        raise AssertionError(f"{label}: no build of more than "
                             f"{DF.MAX_DISTINCT_SET} keys reached fill_device")
    got = _device_domain(big["data"], big["valid"], big["live"],
                         big["dict_len"]).result()
    host = [None if big[k] is None else big[k].cpu().numpy()
            for k in ("data", "valid", "live")]
    want = _host_domain(*host, big["dict_len"])
    same = (got[:2] == want[:2] and np.array_equal(got[4], want[4])
            and (want[1] == 0 or (got[2] == want[2] and got[3] == want[3])))
    log(f"{label}: device domain of a {big['data'].shape[0]}-key build "
        f"(dictionary of {big['dict_len']}): count {got[0]}, non-NaN "
        f"{got[1]}, min {got[2]}, max {got[3]}; host domain {want[:4]}")
    if not same:
        raise AssertionError(f"{label}: device domain {got[:4]} != host "
                             f"domain {want[:4]}")

    staged = {on: StandaloneQueryRunner(
        staged_cat, device="cuda", default_catalog_name="memory",
        splits_per_node=1, ingest=IngestConfig(enabled=on))
        for on in (True, False)}
    total = {True: 0.0, False: 0.0}
    for name, sql in sqls.items():
        ms = {True: [], False: []}
        rows = {}
        for on in (True, False, False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows[on] = staged[on].execute(sql).rows()
            torch.cuda.synchronize()
            ms[on].append((time.perf_counter() - t0) * 1e3)
        rtol = KERNEL_VS_F64_RTOL if name in REAL_QUERIES else DOUBLE_RTOL
        same_rows(rows[True], rows[False], f"staged {name} ingest on vs off",
                  rtol)
        mean = {on: sum(v) / 2 for on, v in ms.items()}
        total[True] += mean[True]
        total[False] += mean[False]
        log(f"{label} staged {name}: ingest on {mean[True]:.1f} ms, off "
            f"{mean[False]:.1f} ms (means of two warm runs in turns)")
    log(f"{label} staged path: {total[True]:.1f} ms with ingest on, "
        f"{total[False]:.1f} ms off, for the {len(sqls)} queries")
    log(f"ingest: {time.perf_counter() - t_phase:.1f} s for phase 14")


# ---------------------------------------------------------------------------
# phase 15: the statements a session sends besides queries


LI15 = "li15"  # the copy of the staged lineitem the statements rewrite
# phase 6's one-column copy of the staged lineitem, for ANALYZE's insert
ANALYZE_CASE = "memory.px6"
DELETE_SQL = "delete from li15 where l_shipdate > date '1998-09-02'"
DELETE_CUT = (1998, 9, 2)
R15_SQL = ("create materialized view r15 as select l_linenumber, "
           "sum(cast(l_quantity as real)) as q, "
           "sum(cast(l_extendedprice as real)) as p "
           "from li15 group by l_linenumber")
DTOH_SLACK = 64  # device-to-host bytes per column for counts and sizes


def _host_ndv(col) -> int:
    """Distinct values of a host generator column (no NULLs in TPC-H)."""
    if isinstance(col, Strings):
        return len(set(col.dictionary[np.unique(col.codes)]))
    return len(np.unique(col))


def _dtoh(copies: dict) -> int:
    return sum(v for k, v in copies.items() if "DtoH" in k)


def statements(torch, GK, StandaloneQueryRunner, staged_cat, tpch_runner,
               smi: str, q12_rows: list) -> dict:
    """Phase 15: the statements a session sends besides queries, over a
    copy of the staged SF 1 lineitem (``li15``, so the other phases read
    the staged tables unchanged): CALL memory.pin_table; ANALYZE (row count
    and 16 NDVs against numpy over the host generator's columns, made as
    phase 7 makes them, a hash_insert per column that is not a dictionary,
    device-to-host bytes no more than the dictionaries' present codes);
    DELETE (count and a grouped aggregate of the kept rows against numpy,
    residency kept, no column through the host); Q21 and Q12 read through
    views (rows equal the direct queries, hash_probe launched); a
    materialized view of R1 over li15 refreshed after an INSERT (rows
    against numpy, staleness true then false, masked_segment_sum_f32
    launched, backing table resident); START TRANSACTION, INSERT, ROLLBACK
    (count back, residency kept); SET SESSION dynamic_filtering = false on
    the tpch path (Q12's rows equal, nothing pruned) and back; SHOW
    TABLES.  Each step's ms is printed beside the card's name and power
    limit.  Returns the phase's launches, which must include every
    kernel."""
    from trino_tpu_torch.connectors.tpch_queries import QUERIES
    from trino_tpu_torch.exec.stats import QueryStats
    from trino_tpu_torch.tools.window_profile import copy_bytes

    t_phase = time.perf_counter()
    label = f"statements SF{PATH_SF:g}"
    runner = StandaloneQueryRunner(staged_cat, device="cuda",
                                   default_catalog_name="memory",
                                   splits_per_node=1)
    mem = staged_cat.connector("memory")
    t0 = time.perf_counter()
    li = _numpy_columns(host_generated(mem, "lineitem")[1])
    cols = list(li)
    n = len(li["l_orderkey"])
    log(f"{label}: host generator's lineitem for numpy, {n} rows, "
        f"{time.perf_counter() - t0:.1f} s")
    GK.reset_launch_counts()

    def run(sql: str, step: str, r=None, stats=None) -> list:
        t0 = time.perf_counter()
        rows = (r or runner).execute(sql, stats=stats).rows()
        torch.cuda.synchronize()
        log(f"{label} {step}: {(time.perf_counter() - t0) * 1e3:.1f} ms "
            f"[{smi}]")
        return rows

    def resident(table: str, when: str) -> None:
        if not mem.is_resident(table):
            raise AssertionError(f"{label}: {table} not resident {when}")
        for split in mem.get_splits(table, 1, 1):
            src = mem.create_page_source(split,
                                         mem.get_table_schema(table)
                                         .column_names())
            while (b := src.get_next_batch()) is not None:
                for name, c in zip(b.names, b.columns):
                    if c.device.type != runner.device.type:
                        raise AssertionError(
                            f"{label}: {table}.{name} on {c.device} "
                            f"{when}")

    def launched(before: dict, kernel: str) -> int:
        return GK.LAUNCHES[kernel] - before[kernel]

    # 1. a copy of the staged lineitem, pinned through CALL
    if run(f"create table memory.{LI15} as select * from lineitem",
           "1 create table li15 as select * from lineitem") != [(n,)]:
        raise AssertionError(f"{label}: li15 does not hold {n} rows")
    if run(f"call memory.pin_table('{LI15}')", "1 call memory.pin_table") \
            != [(f"pinned {LI15}",)]:
        raise AssertionError(f"{label}: pin_table did not answer")
    resident(LI15, "after CALL memory.pin_table")

    # 2. ANALYZE on the card
    before = dict(GK.LAUNCHES)
    if run(f"analyze memory.{LI15}", "2 analyze memory.li15") != [(n,)]:
        raise AssertionError(f"{label}: ANALYZE counted other than {n}")
    stats = mem.get_table_statistics(LI15)
    schema = mem.get_table_schema(LI15)
    dict_ndv = 0
    for c in schema.columns:
        want = _host_ndv(li[c.name])
        if stats.ndv[c.name] != want:
            raise AssertionError(f"{label}: NDV of {c.name} "
                                 f"{stats.ndv[c.name]}, numpy {want}")
        if c.type.is_dictionary_encoded:
            dict_ndv += want
    non_dict = sum(not c.type.is_dictionary_encoded for c in schema.columns)
    inserts = launched(before, "hash_insert")
    if inserts < non_dict:
        raise AssertionError(f"{label}: ANALYZE launched hash_insert "
                             f"{inserts} times for {non_dict} columns")
    copies = copy_bytes(lambda: runner.execute(f"analyze memory.{LI15}"))
    limit = 8 * dict_ndv + DTOH_SLACK * len(cols)
    if _dtoh(copies) > limit:
        raise AssertionError(f"{label}: ANALYZE copied {_dtoh(copies)} "
                             f"bytes to the host, limit {limit}")
    log(f"{label}: ANALYZE rows {n}, 16 NDVs equal numpy "
        f"({dict(stats.ndv)}); hash_insert {inserts} launches for "
        f"{non_dict} columns that are not dictionaries; device-to-host "
        f"{_dtoh(copies)} bytes (limit {limit}: the present codes of the "
        f"dictionaries); copies by kind {copies}")

    # 3. DELETE: rewritten on the card, still resident
    gone = li["l_shipdate"] > _days(*DELETE_CUT)
    keep = ~gone
    if run(DELETE_SQL, "3 delete from li15 where l_shipdate > "
           "date '1998-09-02'") != [(int(gone.sum()),)]:
        raise AssertionError(f"{label}: DELETE count is not numpy's "
                             f"{int(gone.sum())}")
    resident(LI15, "after DELETE")
    got = run("select l_linenumber, count(*), sum(l_quantity) from li15 "
              "group by l_linenumber order by l_linenumber",
              "3 grouped aggregate over the kept rows")
    uk, inv = np.unique(li["l_linenumber"][keep], return_inverse=True)
    sums = np.bincount(inv, weights=li["l_quantity"][keep])
    same_rows(got, [(int(k), int(c), _dec(int(round(s)), 2)) for k, c, s in
                    zip(uk, np.bincount(inv), sums)],
              f"{label} kept rows vs numpy")
    copies = copy_bytes(lambda: runner.execute(DELETE_SQL))
    if _dtoh(copies) > DTOH_SLACK * len(cols):
        raise AssertionError(f"{label}: a DELETE copied {_dtoh(copies)} "
                             "bytes to the host")
    resident(LI15, "after a second DELETE")
    log(f"{label}: DELETE removed {int(gone.sum())} rows as numpy, kept "
        f"{int(keep.sum())}; a second DELETE (no rows) copied "
        f"{_dtoh(copies)} bytes to the host")

    # 4. views over the staged tables
    run(f"create view v15_q21 as {QUERIES[21]}", "4 create view v15_q21")
    run("create view v15_li as select * from lineitem",
        "4 create view v15_li")
    before = dict(GK.LAUNCHES)
    got = run("select * from v15_q21", "4 Q21 through view v15_q21")
    probes = launched(before, "hash_probe")
    same_rows(sorted(got), sorted(runner.execute(QUERIES[21]).rows()),
              f"{label} Q21 through a view vs direct")
    if probes <= 0:
        raise AssertionError(f"{label}: Q21 through a view launched no "
                             "hash_probe")
    q12_view = QUERIES[12].replace("    lineitem\n", "    v15_li\n")
    if q12_view == QUERIES[12]:
        raise AssertionError(f"{label}: Q12's text has no lineitem line")
    same_rows(run(q12_view, "4 Q12 over view v15_li"), q12_rows,
              f"{label} Q12 over a view vs direct")
    log(f"{label}: Q21 through a view equals the direct query "
        f"({len(got)} rows, hash_probe {probes} launches); Q12 over a "
        "view of lineitem equals Q12")

    # 5. a materialized view of R1 over li15, refreshed after an INSERT
    def oracle(mask):
        return real_oracle(lambda t, cs: {c: li[c][mask] for c in cs}, "R1")

    before = dict(GK.LAUNCHES)
    run(R15_SQL, "5 create materialized view r15 (R1 over li15)")
    read_mv = "select * from r15 order by l_linenumber"
    same_rows(run(read_mv, "5 select from r15"), oracle(keep),
              f"{label} r15 vs numpy", KERNEL_VS_F64_RTOL)
    if runner.catalog.mv_is_stale("r15"):
        raise AssertionError(f"{label}: r15 stale after its creation")
    run("insert into li15 select * from lineitem "
        "where l_shipdate > date '1998-09-02'",
        "5 insert the deleted rows back into li15")
    if not runner.catalog.mv_is_stale("r15"):
        raise AssertionError(f"{label}: r15 not stale after an INSERT")
    seg = GK.LAUNCHES["masked_segment_sum_f32"]
    run("refresh materialized view r15", "5 refresh materialized view r15")
    seg = GK.LAUNCHES["masked_segment_sum_f32"] - seg
    if seg <= 0 or runner.catalog.mv_is_stale("r15"):
        raise AssertionError(f"{label}: REFRESH launched {seg} segment "
                             "sums and left r15 stale")
    same_rows(run(read_mv, "5 select from r15"), oracle(slice(None)),
              f"{label} refreshed r15 vs numpy", KERNEL_VS_F64_RTOL)
    resident("__mv_r15", "after REFRESH")
    run(f"call memory.pin_table('{LI15}')",
        "5 call memory.pin_table (the inserted batch)")
    resident(LI15, "after the second pin")
    log(f"{label}: r15 equals numpy's R1 over the kept rows, then over "
        f"all rows after INSERT + REFRESH ({seg} segment-sum launches); "
        "stale after the INSERT, fresh after the REFRESH; backing table "
        f"resident; phase launches so far {dict(GK.LAUNCHES)}")

    # 6. a rolled-back INSERT
    start = run("select count(*) from li15", "6 count")[0][0]
    run("start transaction", "6 start transaction")
    added = run("insert into li15 select * from lineitem "
                "where l_orderkey < 100000", "6 insert")[0][0]
    mid = run("select count(*) from li15", "6 count")[0][0]
    run("rollback", "6 rollback")
    end = run("select count(*) from li15", "6 count")[0][0]
    if (start, mid, end) != (n, n + added, n) or added <= 0:
        raise AssertionError(f"{label}: counts {start}, {mid}, {end} "
                             f"around a rolled-back insert of {added}")
    resident(LI15, "after ROLLBACK")
    log(f"{label}: ROLLBACK of a {added}-row INSERT: count {start} -> "
        f"{mid} -> {end}, li15 resident")

    # 7. SET SESSION on the tpch path: no dynamic filtering, then back
    pruned = {}
    for value in ("false", "true"):
        run(f"set session dynamic_filtering = {value}",
            f"7 set session dynamic_filtering = {value}", tpch_runner)
        st = QueryStats()
        same_rows(run(QUERIES[12], f"7 Q12 (dynamic_filtering = {value})",
                      tpch_runner, st), q12_rows,
                  f"{label} Q12 dynamic_filtering = {value}")
        pruned[value] = st.scan.rows_pruned
    if pruned["false"] != 0 or pruned["true"] <= 0:
        raise AssertionError(f"{label}: rows pruned {pruned}")
    log(f"{label}: Q12 on the tpch path pruned {pruned['false']} rows with "
        f"dynamic_filtering = false, {pruned['true']} with true")

    # 8. SHOW TABLES
    tables = {r[0] for r in run("show tables", "8 show tables")}
    want = {LI15, "v15_q21", "v15_li", "r15", "__mv_r15", "lineitem"}
    if not want <= tables:
        raise AssertionError(f"{label}: SHOW TABLES lacks {want - tables}")
    for sql in ("drop view v15_q21", "drop view v15_li",
                "drop materialized view r15", f"drop table {LI15}"):
        runner.execute(sql)
    launches = dict(GK.LAUNCHES)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"{label}: no launch of {missing}")
    torch.cuda.empty_cache()
    log(f"{label} launches: {launches}")
    log(f"statements: {time.perf_counter() - t_phase:.1f} s for phase 15")
    return launches


# ---------------------------------------------------------------------------
# phase 16: the rest of the single-node engine


# Q18 and Q21 were cut from (a) to make room for phase 20 ((b), (c), (d)
# keep them)
# Q3 (local exchange) and Q21 (revocation, host syncs) cut to keep the run
# within its time limit; R1 launches the phase's segment sums and Q12 in
# (d) its probes
ENGINE_QUERIES = ("Q1", "R1")
REVOKE_QUERIES = ("Q18",)
REVOKE_LIMIT = 256 << 20  # below Q18's 843 and Q21's 1517 MiB peaks
SYNC_QUERIES = ("Q3", "Q12")
EXECUTOR_QUERIES = ("Q1", "Q3", "Q6")
ENGINE_WAIT_S = 300.0


def _count_calls(module, name: str):
    """Wrap module.name to count its calls; returns (counter, restore)."""
    orig = getattr(module, name)
    n = [0]

    def spy(*a, **kw):
        n[0] += 1
        return orig(*a, **kw)

    setattr(module, name, spy)
    return n, lambda: setattr(module, name, orig)


def engine(torch, GK, StandaloneQueryRunner, staged_cat, tpch_runner,
           sqls: dict, numpy_rows: dict, smi: str) -> tuple:
    """Phase 16: the local exchange, revocation, PARTIAL / FINAL
    aggregation, host-sync accounting and the time-sharing executor at SF 1.
    (a) Q1 and R1 on the tpch path with task_concurrency = 4 and
    1 (splits_per_node = 8), and 4 with one prefetch thread per scan
    shard: rows equal, Q1 / R1 also the numpy checks; warm ms of the
    settings in turns (1, 4, 4/1t, 4/1t, 4, 1) and the hash_insert
    launches per query.  (b) Q18 with a 256 MiB pool:
    rows equal the unlimited run; revocations (at least one),
    bytes revoked and the peak device memory of both, absolute and above
    the memory allocated before the run.  (c) Q18's lineitem group-by (sum(l_quantity) by
    l_orderkey) over the staged batch, fed in 65,536-row slices, as
    PARTIAL -> FINAL (early flushes of FLUSH_ROWS included) against SINGLE:
    equal on the card.  (d) EXPLAIN ANALYZE's sync line of Q3 and Q12, each
    query's host syncs now and before the sync-free probe (now + the probe
    batches that went through the padded expand, each of which cost one
    blocking sync before), and a warm run of each under
    SG.forbidden(cuda_sync_debug=True) with a synchronous scan (no other
    thread touches the card while a hot region runs): no blocking sync in a
    hot region.  (e) TimeSharingTaskExecutor(2) runs Q1, Q3 and Q6 at once:
    rows equal run_pipelines'.  Returns (the phase's launches, the
    task_concurrency = 4 runner, for phase 6's capture)."""
    from trino_tpu_torch.exec import join_exec as JX
    from trino_tpu_torch.exec import syncguard as SG
    from trino_tpu_torch.exec.driver import run_pipelines
    from trino_tpu_torch.exec.executor import TimeSharingTaskExecutor
    from trino_tpu_torch.exec.local_planner import LocalPlanner
    from trino_tpu_torch.exec.operators import (HashAggregationOperator,
                                                split_aggregation)
    from trino_tpu_torch.exec.prefetch import IngestConfig
    from trino_tpu_torch.exec.stats import QueryStats
    from trino_tpu_torch.planner.plan import AggCall
    from trino_tpu_torch.runner import Session
    from trino_tpu_torch.spi.batch import ColumnBatch
    from trino_tpu_torch.spi.types import BIGINT
    from trino_tpu_torch.sql.analyzer import agg_result_type

    t_phase = time.perf_counter()
    label = f"engine SF{PATH_SF:g}"
    cat = tpch_runner.catalog
    GK.reset_launch_counts()

    def run(r, sql, stats=None):
        t0 = time.perf_counter()
        rows = r.execute(sql, stats=stats).rows()
        torch.cuda.synchronize()
        return rows, (time.perf_counter() - t0) * 1e3

    def rtol_of(name):
        return REAL_PARITY_RTOL if name in REAL_QUERIES else DOUBLE_RTOL

    # (a) the local exchange: 4 parallel drivers against 1, and 4 with one
    # prefetch thread per scan shard (4 threads in all, as 1 driver has)
    settings = {"1": (1, None), "4": (4, None),
                "4/1t": (4, IngestConfig(threads=1))}
    runners = {k: StandaloneQueryRunner(cat, device="cuda", ingest=ing,
                                        session=Session(splits_per_node=8,
                                                        task_concurrency=c))
               for k, (c, ing) in settings.items()}
    for name in ENGINE_QUERIES:
        rows, ms, inserts = {}, {k: [] for k in settings}, {}
        for k in settings:
            before = GK.LAUNCHES["hash_insert"]
            rows[k] = run(runners[k], sqls[name])[0]
            inserts[k] = GK.LAUNCHES["hash_insert"] - before
        for k in ("1", "4", "4/1t", "4/1t", "4", "1"):
            ms[k].append(run(runners[k], sqls[name])[1])
        worst = 0.0
        for k in ("4", "4/1t"):
            worst = max(worst, same_rows(rows[k], rows["1"],
                                         f"{label} {name} {k} vs 1",
                                         rtol_of(name)))
        msg = ""
        if name in numpy_rows:
            same_rows(rows["4"], numpy_rows[name], f"{label} {name} vs numpy",
                      KERNEL_VS_F64_RTOL if name in REAL_QUERIES
                      else DOUBLE_RTOL)
            msg = ", and numpy's"
        warm = "; ".join(f"{k}: {sum(v) / 2:.1f} ({v[0]:.1f}, {v[1]:.1f})"
                         for k, v in ms.items())
        log(f"{label} (a) {name}: {len(rows['1'])} rows equal with 4 drivers "
            f"and 1{msg} (largest float rel diff {worst:.3g}); warm ms by "
            f"task_concurrency (/1t: one prefetch thread per shard), in "
            f"turns 1, 4, 4/1t, 4/1t, 4, 1: {warm}; hash_insert launches "
            f"{inserts} [{smi}]")

    # (b) revocation under a pool below the queries' peaks
    unlimited = runners["1"]
    limited = StandaloneQueryRunner(cat, device="cuda", session=Session(
        splits_per_node=8, hbm_limit_bytes=REVOKE_LIMIT))
    revocations = 0
    for name in REVOKE_QUERIES:
        peaks = {}
        for key, r, st in (("unlimited", unlimited, None),
                           ("limited", limited, QueryStats())):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            rows_ms = run(r, sqls[name], st)
            peaks[key] = (rows_ms, torch.cuda.max_memory_allocated() / 2**20,
                          (torch.cuda.max_memory_allocated() - base) / 2**20)
        (want, ms_u), peak_u, above_u = peaks["unlimited"]
        (got, ms_l), peak_l, above_l = peaks["limited"]
        same_rows(got, want, f"{label} {name} at {REVOKE_LIMIT >> 20} MiB")
        spills, moved, _, _ = st.spills()
        revocations += spills
        log(f"{label} (b) {name}: rows equal the unlimited run; "
            f"hbm_limit_bytes={REVOKE_LIMIT >> 20} MiB: {spills} "
            f"revocations, {moved} bytes revoked, peak {peak_l:.1f} MiB "
            f"({above_l:.1f} above the start), {ms_l:.1f} ms; unlimited: "
            f"peak {peak_u:.1f} MiB ({above_u:.1f} above the start), "
            f"{ms_u:.1f} ms [{smi}]")
    if revocations <= 0:
        raise AssertionError(f"{label} (b): nothing revoked under "
                             f"{REVOKE_LIMIT >> 20} MiB")

    # (c) PARTIAL -> FINAL over the staged lineitem
    mem = staged_cat.connector("memory")
    (split,) = mem.get_splits("lineitem", 1, 1)
    src = mem.create_page_source(split, ["l_orderkey", "l_quantity"])
    batch = None
    while batch is None:
        batch = src.get_next_batch()
    qty_t = batch.columns[1].type
    aggs = [AggCall("sum", 1, agg_result_type("sum", qty_t)),
            AggCall("count", -1, BIGINT)]
    names, types = ["k", "s", "c"], [batch.columns[0].type, aggs[0].type,
                                      BIGINT]
    slices = [batch.slice(i, min(i + (1 << 16), batch.num_rows))
              for i in range(0, batch.num_rows, 1 << 16)]

    def agg_run(ops):
        outs, t0 = [], time.perf_counter()
        for b in slices:
            pending = [b]
            for op in ops:
                nxt = []
                for p in pending:
                    op.add_input(p)
                    while (o := op.get_output()) is not None:
                        nxt.append(o)
                pending = nxt
            outs += pending
        for i, op in enumerate(ops):
            op.finish_input()
            tail = []
            while (o := op.get_output()) is not None:
                tail.append(o)
            for nxt_op in ops[i + 1:]:
                more = []
                for p in tail:
                    nxt_op.add_input(p)
                    while (o := nxt_op.get_output()) is not None:
                        more.append(o)
                tail = more
            outs += tail
        out = ColumnBatch.concat(outs)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    single, ms_s = agg_run([HashAggregationOperator([0], aggs, names,
                                                    types)])
    partial, final = split_aggregation(HashAggregationOperator(
        [0], aggs, names, types))
    flushes = [0]
    orig_flush = partial._compute

    def counted_compute():
        flushes[0] += 1
        return orig_flush()

    partial._compute = counted_compute
    split_out, ms_p = agg_run([partial, final])

    def by_key(b):
        order = torch.argsort(b.columns[0].data)
        return [c.data[order] for c in b.columns]

    a, b2 = by_key(single), by_key(split_out)
    if not all(torch.equal(x, y) for x, y in zip(a, b2)):
        raise AssertionError(f"{label} (c): PARTIAL -> FINAL != SINGLE")
    log(f"{label} (c) lineitem sum(l_quantity), count(*) by l_orderkey over "
        f"{len(slices)} slices of {batch.num_rows} staged rows: "
        f"{single.num_rows} groups, PARTIAL -> FINAL equals SINGLE exactly "
        f"({flushes[0]} PARTIAL computes, "
        f"FLUSH_ROWS={HashAggregationOperator.FLUSH_ROWS}); SINGLE "
        f"{ms_s:.1f} ms, PARTIAL -> FINAL {ms_p:.1f} ms [{smi}]")
    del a, b2, single, split_out, slices, batch

    # (d) host syncs: EXPLAIN ANALYZE, now against before, forbidden mode
    sync_runner = StandaloneQueryRunner(cat, device="cuda",
                                        ingest=IngestConfig(enabled=False))
    for name in SYNC_QUERIES:
        lines = [r[0] for r in tpch_runner.execute(
            "explain analyze " + sqls[name]).rows()]
        line = next(x for x in lines if x.startswith("  exec: "))
        calls, restore = _count_calls(JX, "probe_ranges_device")
        st = QueryStats()
        try:
            run(tpch_runner, sqls[name], st)
        finally:
            restore()
        now = st.sync.host_syncs
        log(f"{label} (d) {name}: EXPLAIN ANALYZE{line}")
        log(f"{label} (d) {name}: {now} host syncs "
            f"({st.sync.blocking_syncs} blocking, "
            f"{st.sync.hot_loop_syncs} in hot loops); before the sync-free "
            f"probe {now + calls[0]} ({calls[0]} padded-expand probe "
            f"batches, one blocking int(counts.sum()) each)")
        run(sync_runner, sqls[name])  # warm: kernels, seeds, caches
        st = QueryStats()
        with SG.forbidden(cuda_sync_debug=True):
            run(sync_runner, sqls[name], st)
        if st.sync.hot_loop_syncs:
            raise AssertionError(f"{label} (d) {name}: "
                                 f"{st.sync.hot_loop_syncs} hot-loop syncs")
        log(f"{label} (d) {name}: a run under SG.forbidden("
            "cuda_sync_debug=True) (synchronous scan) made no blocking sync "
            f"in a hot region: {st.sync.text()}")

    # (e) the time-sharing executor
    ex = TimeSharingTaskExecutor(2)
    try:
        plans = {}
        for name in EXECUTOR_QUERIES:
            plans[name] = LocalPlanner(cat, "cuda").plan(
                tpch_runner.create_plan(sqls[name]))
        t0 = time.perf_counter()
        handles = {n: ex.submit(lp.pipelines) for n, lp in plans.items()}
        for h in handles.values():
            h.wait(ENGINE_WAIT_S)
        torch.cuda.synchronize()
        ms_ex = (time.perf_counter() - t0) * 1e3
    finally:
        ex.shutdown()
    t0 = time.perf_counter()
    for name, lp in plans.items():
        seq = LocalPlanner(cat, "cuda").plan(
            tpch_runner.create_plan(sqls[name]))
        run_pipelines(seq.pipelines)
        same_rows(ColumnBatch.concat(lp.collector.batches).to_pylist(),
                  ColumnBatch.concat(seq.collector.batches).to_pylist(),
                  f"{label} (e) {name} executor vs run_pipelines")
    torch.cuda.synchronize()
    ms_seq = (time.perf_counter() - t0) * 1e3
    log(f"{label} (e) TimeSharingTaskExecutor(2) ran "
        f"{', '.join(EXECUTOR_QUERIES)} at once in {ms_ex:.1f} ms; rows "
        f"equal run_pipelines' (one after another: {ms_seq:.1f} ms) "
        f"[{smi}]")
    launches = dict(GK.LAUNCHES)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"{label}: no launch of {missing}")
    torch.cuda.empty_cache()
    log(f"{label} launches: {launches}")
    log(f"engine: {time.perf_counter() - t_phase:.1f} s for phase 16")
    return launches, runners["4"]


# ---------------------------------------------------------------------------
# phase 17: the wire format, the disk tier of spill and the file connector


STORAGE_TABLES = ("customer", "orders", "lineitem")
# Q18 over the file tables was cut to make room for phase 20
STORAGE_QUERIES = ("Q1", "Q3", "Q12", "R1")
# Q12, R1 cold only (cut for phase 22), Q3 too (for phase 23)
STORAGE_WARM = ("Q1",)
STORAGE_REQUIRED = {"Q3": ["hash_insert"], "Q12": ["hash_probe"],
                    "R1": ["masked_segment_sum_f32"]}
DISK_LIMIT = 64 << 20  # spill_to_disk_bytes of (b)'s first two queries
DISK_POOL = 256 << 20  # their hbm_limit_bytes
# a join whose build (every column of orders: ~100 MB at SF 1) buffers
# more than DISK_LIMIT, under a TopN; the sort keys make the order total
JOIN_LIMIT_SQL = (
    "select o_orderkey, o_custkey, o_orderstatus, o_totalprice, "
    "o_orderdate, o_orderpriority, o_clerk, o_shippriority, o_comment, "
    "l_linenumber, l_extendedprice from orders, lineitem "
    "where o_orderkey = l_orderkey "
    "order by l_extendedprice desc, o_orderkey, l_linenumber limit 10")


def _unify_timer(modules):
    """Wrap ``unify_dictionaries`` where the port calls it: returns
    (stats: calls, merges (dictionaries that differed), seconds; restore)."""
    from trino_tpu_torch.spi import batch as B

    orig = B.unify_dictionaries
    stats = {"calls": 0, "merges": 0, "s": 0.0}

    def timed(columns):
        t0 = time.perf_counter()
        out = orig(columns)
        stats["s"] += time.perf_counter() - t0
        stats["calls"] += 1
        stats["merges"] += any(o is not c for o, c in zip(out, columns))
        return out

    for m in modules:
        m.unify_dictionaries = timed
    return stats, lambda: [setattr(m, "unify_dictionaries", orig)
                           for m in modules]


def storage(torch, GK, StandaloneQueryRunner, default_catalog, tpch_runner,
            sqls: dict, path_rows: dict, numpy_rows: dict, smi: str) -> dict:
    """Phase 17 (see the module docstring) over a file root under build/,
    removed at the end whatever happens; returns the phase's launches."""
    t_phase = time.perf_counter()
    GK.reset_launch_counts()
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip-smoke-files-", dir="build")
    try:
        launches = _storage(torch, GK, StandaloneQueryRunner,
                            default_catalog, tpch_runner, sqls, path_rows,
                            numpy_rows, smi, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"storage: file root {root} removed; "
        f"{time.perf_counter() - t_phase:.1f} s for phase 17")
    return launches


def _storage(torch, GK, StandaloneQueryRunner, default_catalog, tpch_runner,
             sqls, path_rows, numpy_rows, smi, root) -> dict:
    from trino_tpu_torch import native
    from trino_tpu_torch.connectors.file import page_frames
    from trino_tpu_torch.exec import operators as OPS
    from trino_tpu_torch.exec import prefetch as PF
    from trino_tpu_torch.exec import syncguard as SG
    from trino_tpu_torch.exec.stats import QueryStats
    from trino_tpu_torch.runner import Session
    from trino_tpu_torch.spi import batch as B
    from trino_tpu_torch.tools.window_profile import trace

    label = f"storage SF{PATH_SF:g}"
    tpch = tpch_runner.catalog.connector("tpch")
    cat = default_catalog(PATH_SF, file_root=root)
    cat.register("tpch", tpch)  # phase 3's generator, dictionaries built
    files = cat.connector("file")
    runner = StandaloneQueryRunner(cat, device="cuda",
                                   default_catalog_name="file")

    def run(r, sql, stats=None):
        t0 = time.perf_counter()
        rows = r.execute(sql, stats=stats).rows()
        torch.cuda.synchronize()
        return rows, (time.perf_counter() - t0) * 1e3

    # (a) file tables: CTAS, then the queries over them
    t0 = time.perf_counter()
    native.load()
    log(f"{label} (a) native library {native.lib_path()} ready in "
        f"{time.perf_counter() - t0:.2f} s (c++ -O3 -lz)")
    for t in STORAGE_TABLES:
        sync0 = SG.snapshot()
        _, ms = run(runner, f"create table {t} as select * from tpch.{t}")
        sync = SG.take_delta(sync0)
        schema = files.get_table_schema(t)
        rows = files.row_count(t)
        flat = rows * sum(
            np.dtype(np.int32 if c.type.is_dictionary_encoded
                     else c.type.storage_dtype).itemsize
            for c in schema.columns)
        paths = [s.info for s in files.get_splits(t, 1, 1)]
        pages = sum(len(page_frames(p)) for p in paths)
        on_disk = sum(os.path.getsize(p) for p in paths)
        if rows != tpch.row_count(t) or not pages:
            raise AssertionError(f"{label} (a) CTAS {t}: {rows} rows in "
                                 f"{pages} pages")
        log(f"{label} (a) CTAS file.{t}: {rows} rows in {ms / 1e3:.2f} s, "
            f"{len(paths)} page files, {pages} pages, {on_disk} bytes on "
            f"disk against {flat} flat column bytes "
            f"({on_disk / flat:.3f}x; dictionaries are stored per page); "
            f"sink host syncs {sync.host_syncs} (serde.column "
            f"{sync.by_tag.get('serde.column', 0)}, serde.compact "
            f"{sync.by_tag.get('serde.compact', 0)}) [{smi}]")

    unify, restore = _unify_timer((B, PF, OPS))
    per_query, rows_of, walls = {}, {}, {}
    try:
        for name in STORAGE_QUERIES:
            before = dict(GK.LAUNCHES)
            st0 = dataclasses.replace(files.read_stats)
            cold_rows, cold = run(runner, sqls[name])
            st = files.read_stats
            read = {k: getattr(st, k) - getattr(st0, k)
                    for k in ("frames", "bytes_read", "bytes_inflated",
                              "read_s", "inflate_s", "decode_s")}
            u0 = dict(unify)
            if name in STORAGE_WARM:
                rows_of[name], warm = run(runner, sqls[name])
                u_file = {k: unify[k] - u0[k] for k in unify}
                u0 = dict(unify)
                run(tpch_runner, sqls[name])
                u_tpch = {k: unify[k] - u0[k] for k in unify}
                walls[name] = warm
            else:
                rows_of[name] = cold_rows
                warm, u_file, u_tpch = None, None, None
            per_query[name] = {k: GK.LAUNCHES[k] - before[k]
                               for k in GK.LAUNCHES}
            real = name in REAL_QUERIES
            worst = same_rows(rows_of[name], path_rows[name],
                              f"{label} (a) {name} vs the tpch path",
                              REAL_PARITY_RTOL if real else DOUBLE_RTOL)
            msg = ""
            if name in numpy_rows:
                same_rows(rows_of[name], numpy_rows[name],
                          f"{label} (a) {name} vs numpy",
                          KERNEL_VS_F64_RTOL if real else DOUBLE_RTOL)
                msg = " and the numpy evaluation"
            unified = ("no warm run" if u_file is None else
                       f"warm dictionary unification: file path "
                       f"{u_file['calls']} calls, {u_file['merges']} merges, "
                       f"{u_file['s'] * 1e3:.1f} ms, tpch path "
                       f"{u_tpch['calls']} calls, {u_tpch['merges']} merges, "
                       f"{u_tpch['s'] * 1e3:.1f} ms")
            warm_ms = "not run" if warm is None else f"{warm:.1f} ms"
            log(f"{label} (a) {name} over file tables: {len(rows_of[name])} "
                f"rows equal the tpch path's{msg} (largest float rel diff "
                f"{worst:.3g}); cold {cold:.1f} ms, warm {warm_ms}; cold "
                f"run read {read['frames']} pages, {read['bytes_read']} "
                f"bytes, inflated to {read['bytes_inflated']}; read "
                f"{read['read_s'] * 1e3:.1f} ms, inflate "
                f"{read['inflate_s'] * 1e3:.1f} ms, decode "
                f"{read['decode_s'] * 1e3:.1f} ms (summed over the prefetch "
                f"threads); {unified}; launches {per_query[name]} [{smi}]")
    finally:
        restore()
    for name, kernels in STORAGE_REQUIRED.items():
        for k in kernels:
            if per_query[name][k] <= 0:
                raise AssertionError(f"{label} (a) {name} launched no {k}")
    traced, busy, ops, _ = trace(runner, sqls["Q1"])
    if busy <= 0:
        raise AssertionError(f"{label} (a) Q1: no device time traced")
    log(f"{label} (a) Q1 over file tables: device busy {busy:.2f} ms of "
        f"{walls['Q1']:.2f} ms warm wall (traced {traced:.2f} ms): idle "
        f"{1 - busy / walls['Q1']:.1%}; most device time: " + "; ".join(
            f"{key} {ms:.3f} ms x{calls}" for key, ms, calls in ops[:5]))
    for t in STORAGE_TABLES:
        runner.execute(f"drop table {t}")
    del runner, cat, files

    # (b) the disk tier on the tpch path
    tcat = tpch_runner.catalog
    budgets = {
        "Q18": Session(spill_to_disk_bytes=DISK_LIMIT,
                       hbm_limit_bytes=DISK_POOL),
        "J1": Session(spill_to_disk_bytes=DISK_LIMIT,
                      hbm_limit_bytes=DISK_POOL),
        "Q1": Session(spill_to_disk_bytes=1)}
    texts = {"Q18": sqls["Q18"], "J1": JOIN_LIMIT_SQL, "Q1": sqls["Q1"]}
    merges = {"insert": 0}
    orig_merge = OPS.HashAggregationOperator._merge_spilled

    def counted_merge(self):
        before = GK.LAUNCHES["hash_insert"]
        out = orig_merge(self)
        merges["insert"] += GK.LAUNCHES["hash_insert"] - before
        return out

    OPS.HashAggregationOperator._merge_spilled = counted_merge
    try:
        for name, session in budgets.items():
            spill = StandaloneQueryRunner(tcat, device="cuda",
                                          session=session)
            peaks = {}
            for key, r in (("none", tpch_runner), ("budget", spill)):
                st = QueryStats()
                merges["insert"] = 0
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                rows, ms = run(r, texts[name], st)
                peaks[key] = (rows, ms, st, merges["insert"],
                              (torch.cuda.max_memory_allocated() - base)
                              / 2**20)
            want, ms_none, _, _, above_none = peaks["none"]
            got, cold, st, merge_inserts, above = peaks["budget"]
            worst = same_rows(got, want, f"{label} (b) {name} vs no budget")
            revocations, revoked, pages, nbytes = st.spills()
            if pages <= 0 or nbytes <= 0:
                raise AssertionError(f"{label} (b) {name}: nothing spilled "
                                     "to disk")
            ops_ = [o for p in st.pipelines for o in p.operators
                    if o.disk_pages]
            write_ms = sum(o.disk_write_s for o in ops_) * 1e3
            read_ms = sum(o.disk_read_s for o in ops_) * 1e3
            spill_syncs = {k: v for k, v in st.sync.by_tag.items()
                           if k.startswith(("serde.", "agg.spill"))}
            log(f"{label} (b) {name} (spill_to_disk_bytes="
                f"{session.spill_to_disk_bytes}, hbm_limit_bytes="
                f"{session.hbm_limit_bytes}): {len(got)} rows equal the run "
                f"with no budget (largest float rel diff {worst:.3g}); "
                f"{pages} pages, {nbytes} bytes to disk by "
                f"{', '.join(sorted({o.name for o in ops_}))}; write "
                f"{write_ms:.1f} ms, read back {read_ms:.1f} ms (pinned "
                f"copies back); host syncs {st.sync.host_syncs}, of them "
                f"spilling {spill_syncs}; "
                f"{revocations} revocations ({revoked} bytes); merge "
                f"hash_insert launches {merge_inserts}; peak above the "
                f"start {above:.1f} MiB against {above_none:.1f}; ms with "
                f"the budget {cold:.1f}, without {ms_none:.1f} (warm runs "
                f"cut to keep the script within its time limit) [{smi}]")
    finally:
        OPS.HashAggregationOperator._merge_spilled = orig_merge
    launches = dict(GK.LAUNCHES)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"{label}: no launch of {missing}")
    torch.cuda.empty_cache()
    log(f"{label} launches: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 18: the telemetry plane, the plan and result caches, the system
# connector


# the staged queries that scan nation: an INSERT into it must re-execute
# exactly these
NATION_QUERIES = ("Q2", "Q5", "Q7", "Q8", "Q9", "Q10", "Q11", "Q20", "Q21")
# a nation no supplier or customer references: no query's rows change
NATION_ROW = (99, "ATLANTIS", 0, "unreferenced")
TELEMETRY_PROFILED = ("Q3", "Q21")
TELEMETRY_TURNS = 2  # A B B A rounds of the warm-ms comparisons
CLONE_REPS = 21
SYNC_ROUNDS = 2  # rounds of off default default off for the sync counts
# the tpch-path query under the sync debug mode: Q3 for one round (Q21 for
# two until cut to keep the run within its time limit)
TPCH_SYNC_QUERY = "Q3"
TPCH_SYNC_ROUNDS = 1
# the tags of exec/'s AsyncScalar reads: each counts a sync only when its
# copy has not landed by the time the value is needed
ASYNC_WAIT_TAGS = ("join.expand-overflow", "join.pair-total",
                   "join.unique-count", "join.unique-overflow")


def _tier(rows: list, tier: str) -> dict:
    return next(r for r in rows if r["tier"] == tier)


def _timed_run(torch, runner, sql: str, query_id: str):
    t0 = time.perf_counter()
    res = runner.execute(sql, query_id=query_id)
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def _in_turns(torch, runner, sql: str, a, b, rounds: int) -> tuple:
    """Warm ms of ``sql`` under the settings ``a`` and ``b`` (context
    factories), in turns a b b a per round; (mean a, mean b)."""
    ms = {"a": [], "b": []}
    for _ in range(rounds):
        for k in ("a", "b", "b", "a"):
            with (a if k == "a" else b)():
                ms[k].append(_timed_run(torch, runner, sql, "")[1])
    return sum(ms["a"]) / len(ms["a"]), sum(ms["b"]) / len(ms["b"])


def telemetry(torch, GK, StandaloneQueryRunner, staged_cat, tpch_cat,
              sqls: dict, staged_rows: dict, staged_launches: dict,
              smi: str) -> dict:
    """Phase 18 (see the module docstring), with the caches on and the
    profiler at its default level, over phase 8's staged tables (left as
    found: the row it inserts is deleted and nation pinned again) and the
    tpch catalog; the phase's journal lives in a directory under build/,
    removed at the end.  Returns the phase's launches."""
    from trino_tpu_torch.telemetry import journal

    t_phase = time.perf_counter()
    GK.reset_launch_counts()
    os.makedirs("build", exist_ok=True)
    jdir = tempfile.mkdtemp(prefix="chip-smoke-journal-", dir="build")
    old_dir = os.environ.get("TRINO_TPU_JOURNAL_DIR")
    os.environ["TRINO_TPU_JOURNAL_DIR"] = jdir
    journal.reset_for_test()
    try:
        _telemetry(torch, GK, StandaloneQueryRunner, staged_cat, tpch_cat,
                   sqls, staged_rows, staged_launches, smi, jdir)
    finally:
        if old_dir is None:
            del os.environ["TRINO_TPU_JOURNAL_DIR"]
        else:
            os.environ["TRINO_TPU_JOURNAL_DIR"] = old_dir
        journal.reset_for_test()
        shutil.rmtree(jdir, ignore_errors=True)
    launches = dict(GK.LAUNCHES)
    log(f"telemetry: journal directory {jdir} removed; launches {launches}; "
        f"{time.perf_counter() - t_phase:.1f} s for phase 18")
    return launches


def _telemetry(torch, GK, StandaloneQueryRunner, staged_cat, tpch_cat,
               sqls, staged_rows, staged_launches, smi, jdir) -> None:
    import contextlib

    from trino_tpu_torch.caching import cache_rows, plan_cache, result_cache
    from trino_tpu_torch.exec import syncguard as SG
    from trino_tpu_torch.exec.prefetch import IngestConfig
    from trino_tpu_torch.exec.stats import QueryStats
    from trino_tpu_torch.telemetry import journal, profiler
    from trino_tpu_torch.telemetry.runtime import fingerprint

    label = f"telemetry SF{PATH_SF:g}"
    if not result_cache.enabled() or not plan_cache.enabled():
        raise AssertionError(f"{label}: the caches must be on")
    prev_level = profiler.set_level(1)
    plan_cache.invalidate_all()  # phases 1-17 planned these texts too
    runner = StandaloneQueryRunner(staged_cat, device="cuda",
                                   default_catalog_name="memory",
                                   splits_per_node=1)

    def tiers() -> tuple:
        rows = cache_rows()
        return _tier(rows, "plan"), _tier(rows, "result")

    def counted(q: str) -> tuple:
        """(rows, ms, launches) of one run of staged query q."""
        before = dict(GK.LAUNCHES)
        res, ms = _timed_run(torch, runner, sqls[q], f"p18a_{q}_{tag[0]}")
        expected.append((res.rows(), sqls[q], f"p18a_{q}_{tag[0]}"))
        return (expected[-1][0], ms,
                {k: GK.LAUNCHES[k] - before[k] for k in GK.LAUNCHES})

    def rtol(q: str) -> float:
        return KERNEL_VS_F64_RTOL if q in REAL_QUERIES else DOUBLE_RTOL

    # (a) dashboard traffic: the 24 queries three times on one runner
    scans_nation = {q for q in sqls if ("memory", "nation") in
                    plan_cache.scan_tables(runner.create_plan(sqls[q]))}
    if scans_nation != set(NATION_QUERIES):
        raise AssertionError(f"{label}: the queries that scan nation are "
                             f"{sorted(scans_nation)}")
    counters_before = _counters(runner)
    expected: list = []  # (rows, sql, query id) of every phase-(a) statement
    p0, r0 = tiers()
    tag = ["1"]
    first_launches = {}
    for q in sqls:
        rows, ms, lq = counted(q)
        same_rows(rows, staged_rows[q], f"{label} (a) pass 1 {q}", rtol(q))
        want = staged_launches[q]
        if lq != want:
            raise AssertionError(f"{label} (a) pass 1 {q}: launches {lq}, "
                                 f"phase 8's warm run {want}")
        first_launches[q] = lq
    p1, r1 = tiers()
    if (p1["misses"] - p0["misses"], p1["hits"] - p0["hits"],
            r1["hits"] - r0["hits"]) != (len(sqls), 0, 0) or \
            r1["entries"] != len(sqls):
        raise AssertionError(f"{label} (a) pass 1: plan {p1}, result {r1}")
    log(f"{label} (a) pass 1: {len(sqls)} plan misses, {r1['entries']} "
        f"results stored ({r1['bytes']} bytes on the card), rows and "
        f"launches equal phase 8's")
    tag[0] = "2"
    hit_ms = {}
    for q in sqls:
        rows, ms, lq = counted(q)
        same_rows(rows, staged_rows[q], f"{label} (a) pass 2 {q}", rtol(q))
        if any(lq.values()):
            raise AssertionError(f"{label} (a) pass 2 {q}: launches {lq}")
        hit_ms[q] = ms
    p2, r2 = tiers()
    if (p2["hits"] - p1["hits"], r2["hits"] - r1["hits"],
            r2["misses"] - r1["misses"]) != (len(sqls), len(sqls), 0):
        raise AssertionError(f"{label} (a) pass 2: plan {p2}, result {r2}")
    log(f"{label} (a) pass 2: {len(sqls)} plan hits and {len(sqls)} result "
        f"hits, no launch; hit ms " + ", ".join(
            f"{q} {hit_ms[q]:.3f}" for q in sqls)
        + f" (median {sorted(hit_ms.values())[len(hit_ms) // 2]:.3f}) "
        f"[{smi}]")
    ins = "insert into nation values (%d, '%s', %d, '%s')" % NATION_ROW
    res, _ = _timed_run(torch, runner, ins, "p18a_insert")
    expected.append((res.rows(), ins, "p18a_insert"))
    p3, r3 = tiers()
    if r3["invalidations"] - r2["invalidations"] != len(NATION_QUERIES):
        raise AssertionError(f"{label} (a) INSERT: result {r3}")
    tag[0] = "3"
    for q in sqls:
        rows, ms, lq = counted(q)
        same_rows(rows, staged_rows[q], f"{label} (a) pass 3 {q}", rtol(q))
        want = first_launches[q] if q in NATION_QUERIES else \
            {k: 0 for k in GK.LAUNCHES}
        if lq != want:
            raise AssertionError(f"{label} (a) pass 3 {q}: launches {lq}, "
                                 f"expected {want}")
    p4, r4 = tiers()
    n_other = len(sqls) - len(NATION_QUERIES)
    if (r4["misses"] - r3["misses"], r4["hits"] - r3["hits"],
            p4["hits"] - p3["hits"]) != (len(NATION_QUERIES), n_other,
                                         len(sqls)):
        raise AssertionError(f"{label} (a) pass 3: plan {p4}, result {r4}")
    log(f"{label} (a) INSERT into nation: {len(NATION_QUERIES)} results "
        f"invalidated; {' '.join(NATION_QUERIES)} re-executed with pass 1's "
        f"rows and launches, the other {n_other} hit")
    counters_after = _counters(runner)
    _hit_profile(runner, sqls["Q1"], label)

    # (b) the system tables over (a)
    n_stmt = len(expected)
    out_rows = sum(len(rows) for rows, _s, _q in expected)
    (count, outs, ins_rows, min_peak), = runner.execute(
        "select count(*), sum(output_rows), sum(input_rows), "
        "min(peak_memory_bytes) from system.runtime.queries "
        "where state = 'FINISHED' and query_id like 'p18a_%'").rows()
    if (count, outs) != (n_stmt, out_rows):
        raise AssertionError(f"{label} (b) runtime.queries: {count} rows, "
                             f"{outs} output rows; (a) ran {n_stmt}, "
                             f"{out_rows}")
    # the allocator's peak, read at each query's end (the staged tables
    # alone hold device memory)
    if not min_peak or min_peak <= 0:
        raise AssertionError(f"{label} (b) runtime.queries: peak memory "
                             f"{min_peak}")
    delta = {k: counters_after[0][k] - counters_before[0][k]
             for k in counters_after[0]}
    scanned = delta["trino_scan_rows_total"] - counters_before[1]
    want = {"trino_queries_started_total": n_stmt + 1,
            "trino_queries_finished_total": n_stmt + 1,
            "trino_queries_failed_total": 0}
    if any(delta[k] != v for k, v in want.items()) or scanned != ins_rows:
        raise AssertionError(f"{label} (b) metrics.counters deltas {delta} "
                             f"(before-read scanned {counters_before[1]}); "
                             f"expected {want}, scan rows {ins_rows}")
    hit_inputs = runner.execute(
        "select count(*) from system.runtime.queries where query_id like "
        "'p18a_%_2' and input_rows > 0").rows()[0][0]
    if hit_inputs:
        raise AssertionError(f"{label} (b) {hit_inputs} pass-2 hits scanned")
    log(f"{label} (b) runtime.queries: {count} FINISHED rows for (a), "
        f"{outs} output rows, {ins_rows} input rows, least peak memory "
        f"{min_peak} bytes; metrics.counters "
        f"deltas over (a): {delta} (each read counts itself once: one "
        f"start, one finish, the before-read's {counters_before[1]} scanned "
        f"rows)")
    sql_rows = runner.execute(
        "select tier, name, entries, bytes, hits, misses, evictions, "
        "invalidations from system.runtime.caches").rows()
    now = cache_rows(per_exec_cache=True)
    keys = ("entries", "bytes", "hits", "misses", "evictions",
            "invalidations")
    for tier in ("plan", "result"):
        got = next(r for r in sql_rows if r[0] == tier)[2:]
        if got != tuple(_tier(now, tier)[k] for k in keys):
            raise AssertionError(f"{label} (b) runtime.caches {tier}: {got},"
                                 f" the tier's stats {_tier(now, tier)}")
    exec_rows = {r[1]: r for r in sql_rows if r[0] == "exec"}
    if set(exec_rows) != {r["name"] for r in now if r["tier"] == "exec"}:
        raise AssertionError(f"{label} (b) runtime.caches exec rows "
                             f"{sorted(exec_rows)}")
    log(f"{label} (b) runtime.caches: " + "; ".join(
        f"{r[0]}/{r[1]} entries {r[2]} bytes {r[3]} hits {r[4]} misses "
        f"{r[5]} evictions {r[6]} invalidations {r[7]}" for r in sql_rows))
    before = GK.LAUNCHES["hash_insert"]
    grouped = runner.execute(
        "select output_rows, count(*) from system.runtime.queries "
        "where query_id like 'p18a_%' group by output_rows").rows()
    n_insert = GK.LAUNCHES["hash_insert"] - before
    if n_insert < 1 or sum(c for _o, c in grouped) != n_stmt:
        raise AssertionError(f"{label} (b) GROUP BY output_rows: "
                             f"{n_insert} hash_insert launches, {grouped}")
    log(f"{label} (b) GROUP BY output_rows over runtime.queries: "
        f"{len(grouped)} groups, hash_insert launched {n_insert} time(s) on "
        f"the card")

    # (a, cont.) undo the INSERT; nation is pinned again, as phase 7 left it
    runner.execute(f"delete from nation where n_nationkey = {NATION_ROW[0]}")
    runner.execute("call memory.pin_table('nation')")
    mem = staged_cat.connector("memory")
    if mem.row_count("nation") != 25 or not mem.is_resident("nation"):
        raise AssertionError(f"{label}: nation not restored")
    # the planning a plan hit saves: warm ms with the result tier off, plan
    # tier on against both off, in turns
    plan_off = _env_scope("TRINO_TPU_PLAN_CACHE", "0")
    saved = {}
    with result_cache.disabled():
        for q in sqls:
            runner.execute(sqls[q])  # the plan tier re-learns the text
            on, off = _in_turns(torch, runner, sqls[q], contextlib.nullcontext,
                                plan_off, TELEMETRY_TURNS)
            saved[q] = (on, off)
    log(f"{label} (a) warm ms, result tier off, plan tier on / both off "
        f"({TELEMETRY_TURNS} rounds a b b a): " + ", ".join(
            f"{q} {on:.2f}/{off:.2f}" for q, (on, off) in saved.items())
        + "; planning saved per plan hit: " + ", ".join(
            f"{q} {off - on:.2f}" for q, (on, off) in saved.items())
        + f" ms [{smi}]")

    # the cost of a plan hit's private copy (host only)
    clones = {}
    for q in TELEMETRY_PROFILED:
        plan = runner.create_plan(sqls[q])
        times = []
        for _ in range(CLONE_REPS):
            t0 = time.perf_counter()
            plan_cache.clone(plan)
            times.append((time.perf_counter() - t0) * 1e6)
        clones[q] = sorted(times)[len(times) // 2]
    log(f"{label} (a) one plan clone (median of {CLONE_REPS}): " + ", ".join(
        f"{q} {us:.1f} us" for q, us in clones.items()))

    # (c) the profiler: staged Q3 and Q21 at default and full, the host
    # syncs of off and default compared over runs in turns after a warm-up
    # (_same_syncs)
    with result_cache.disabled():
        for q in TELEMETRY_PROFILED:
            runner.execute(sqls[q], stats=QueryStats())  # warm-up
            syncs = _syncs_in_turns(runner, sqls[q], profiler, QueryStats,
                                    f"p18c_{q}", contextlib.nullcontext)
            off, dflt = syncs["off"], syncs["default"]
            steady = _same_syncs(off, dflt, f"{label} (c) {q}")
            profiler.set_level(2)
            st = QueryStats()
            runner.execute(sqls[q], stats=st, query_id=f"p18c_{q}_full")
            torch.cuda.synchronize()
            profiler.set_level(1)
            full = st.sync
            added = full.by_tag.get("profiler.full", 0)
            counts = [s.host_syncs for s in off]
            # every sync full adds is tagged profiler.full
            if _steady_syncs(full) - added != steady or not added \
                    or full.hot_loop_syncs:
                raise AssertionError(f"{label} (c) {q}: full "
                                     f"{full.text()}; off {counts}")
            if runner.profile(f"p18c_{q}_off_0") is not None:
                raise AssertionError(f"{label} (c) {q}: a trace with the "
                                     "profiler off")
            for name, qid in (("default", f"p18c_{q}_default_0"),
                              ("full", f"p18c_{q}_full")):
                evs = [e for e in runner.profile(qid)["traceEvents"]
                       if e["ph"] == "X"]
                kinds: dict = {}
                for e in evs:
                    kinds[e["cat"]] = kinds.get(e["cat"], 0) + 1
                ops = sorted({e["name"] for e in evs
                              if e["cat"] == "operator"
                              and not e["name"].endswith(".finish")})
                log(f"{label} (c) {q} at {name}: {len(evs)} events by kind "
                    f"{kinds}; operators {', '.join(ops)}")
            log(f"{label} (c) {q}: host syncs a run, off "
                f"{counts}, default {[s.host_syncs for s in dflt]} (in "
                f"turns; {steady} a run apart from async waits), full "
                f"{full.host_syncs} ({added} tagged profiler.full; hot-loop "
                f"syncs {full.hot_loop_syncs})")
            rec_off, rec_on = _in_turns(
                torch, runner, sqls[q], _level_scope(profiler, 0),
                _level_scope(profiler, 1), TELEMETRY_TURNS)
            log(f"{label} (c) {q}: warm ms profile off {rec_off:.2f}, "
                f"default {rec_on:.2f} ({TELEMETRY_TURNS} rounds a b b a; "
                f"the cost of recording {rec_on - rec_off:+.2f} ms) [{smi}]")
        # a query under forbidden(cuda_sync_debug=True), synchronous scan,
        # on the tpch path as phase 16 (d): the default level adds no sync
        q = TPCH_SYNC_QUERY
        sync_runner = StandaloneQueryRunner(tpch_cat, device="cuda",
                                            ingest=IngestConfig(enabled=False))
        sync_runner.execute(sqls[q], stats=QueryStats())  # warm-up
        syncs = _syncs_in_turns(
            sync_runner, sqls[q], profiler, QueryStats, f"p18c_sync_{q}",
            lambda: SG.forbidden(cuda_sync_debug=True), TPCH_SYNC_ROUNDS)
        steady = _same_syncs(syncs["off"], syncs["default"],
                             f"{label} (c) {q} forbidden")
        log(f"{label} (c) {q} under SG.forbidden(cuda_sync_debug=True), "
            f"synchronous scan: host syncs a run with the profile off "
            f"{[s.host_syncs for s in syncs['off']]}, at default "
            f"{[s.host_syncs for s in syncs['default']]} (in turns; "
            f"{steady} a run apart from async waits), none in a hot loop")

    # (d) the journal, read back by a new runner after a simulated restart
    journal.reset_for_test()
    reader = StandaloneQueryRunner(staged_cat, device="cuda",
                                   default_catalog_name="memory",
                                   splits_per_node=1)
    history = {r[0]: r[1:] for r in reader.execute(
        "select query_id, fingerprint, output_rows, state "
        "from system.runtime.query_history").rows()}
    for rows, sql, qid in expected:
        got = history.get(qid)
        if got != (fingerprint(sql), len(rows), "FINISHED"):
            raise AssertionError(f"{label} (d) query_history {qid}: {got}")
    files = [os.path.join(jdir, f) for f in sorted(os.listdir(jdir))]
    nbytes = sum(os.path.getsize(f) for f in files)
    log(f"{label} (d) query_history after a restart: {len(history)} "
        f"queries, the phase's {len(expected)} (a) statements with their "
        f"fingerprints and output rows; journal {nbytes} bytes in "
        f"{len(files)} files ({', '.join(os.path.basename(f) for f in files)})")
    profiler.set_level(prev_level)


def _hit_profile(runner, sql: str, label: str, reps: int = 20) -> None:
    """Where a result-cache hit's host time goes: ``reps`` hits of ``sql``
    under cProfile, the functions with the most own time (cProfile's own
    cost inflates the total; the shares are what it shows)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(reps):
        runner.execute(sql)
    prof.disable()
    st = pstats.Stats(prof)
    total = st.total_tt
    top = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:8]
    log(f"{label} (a) {reps} hits under cProfile, {total * 1e3 / reps:.3f} "
        f"ms a hit; most own time: " + "; ".join(
            f"{fn[2]} ({os.path.basename(fn[0])}:{fn[1]}) "
            f"{tt * 1e3 / reps:.3f} ms" for fn, (_cc, _nc, tt, _ct, _c)
            in top))


def _syncs_in_turns(runner, sql: str, profiler, QueryStats, prefix: str,
                    scope, rounds: int = SYNC_ROUNDS) -> dict:
    """Each run's SyncStats with the profiler off and at default, in turns
    off default default off, ``rounds`` times, each run inside
    ``scope()``; the runs are named ``<prefix>_<level>_<n>``."""
    out: dict = {"off": [], "default": []}
    for _ in range(rounds):
        for name in ("off", "default", "default", "off"):
            profiler.set_level(0 if name == "off" else 1)
            st = QueryStats()
            with scope():
                runner.execute(sql, stats=st,
                               query_id=f"{prefix}_{name}_{len(out[name])}")
            out[name].append(st.sync)
    profiler.set_level(1)
    return out


def _steady_syncs(st) -> int:
    """A run's host syncs less its waits on async copies: an AsyncScalar
    read counts a sync only when its copy has not landed yet, so those
    vary with timing from run to run; the rest are the same every run."""
    return st.host_syncs - sum(st.by_tag.get(t, 0) for t in ASYNC_WAIT_TAGS)


def _same_syncs(off: list, dflt: list, what: str) -> int:
    """The default level adds no host sync: every run, off and at default,
    makes the same syncs apart from async waits, none carries a tag the
    runs off lack (async waits aside) or a profiler tag, and none is in a
    hot loop.  Returns the steady count."""
    steady = {_steady_syncs(s) for s in off + dflt}
    known = {t for s in off for t in s.by_tag} | set(ASYNC_WAIT_TAGS)
    tags = {t for s in dflt for t in s.by_tag}
    if len(steady) != 1 or tags - known or \
            any(t.startswith("profiler") for t in tags) or \
            any(s.hot_loop_syncs for s in off + dflt):
        raise AssertionError(
            f"{what}: off {[s.text() for s in off]}; default "
            f"{[s.text() for s in dflt]}")
    return steady.pop()


def _counters(runner) -> tuple:
    """(the trino_queries_* and trino_scan_rows_total values, the rows the
    read itself scanned) from system.metrics.counters."""
    rows = runner.execute(
        "select name, value from system.metrics.counters").rows()
    names = ("trino_queries_started_total", "trino_queries_finished_total",
             "trino_queries_failed_total", "trino_scan_rows_total")
    by = dict(rows)
    return {n: int(by[n]) for n in names}, len(rows)


def _env_scope(name: str, value: str):
    import contextlib

    @contextlib.contextmanager
    def scope():
        old = os.environ.get(name)
        os.environ[name] = value
        try:
            yield
        finally:
            if old is None:
                del os.environ[name]
            else:
                os.environ[name] = old
    return scope


def _level_scope(profiler, level: int):
    import contextlib

    @contextlib.contextmanager
    def scope():
        prev = profiler.set_level(level)
        try:
            yield
        finally:
            profiler.set_level(prev)
    return scope


# ---------------------------------------------------------------------------
# phase 19: the distributed runner, the collective exchange and the fused
# Q1 program


DIST_WORKERS = 4
# collectives on / off in turns (Q18 and Q21 were cut to make room for
# phase 20)
DIST_TURNS = ("Q1",)  # Q3 cut for phase 23
# the four slowest of (a) apart from Q21 (phase 6's capture), cut for
# phase 23; Q18 and Q21 (phase 6 still captures Q21) cut for phase 24
DIST_CUT = ("Q9", "Q10", "Q20", "Q22", "Q18", "Q21")
DIST_SERDE = ("Q3",)  # Q18 cut to keep the run within its time limit
# through the MERGE exchange: a small result (the producers' streams merged
# on the host) and one past MergeSourceOperator.MERGE_ROW_LIMIT (sorted
# again on the card)
DIST_MERGE = {
    "merge nation": ("select n_regionkey, n_name from nation "
                     "order by n_regionkey desc, n_name"),
    "merge orders": ("select o_orderkey, o_orderdate, o_totalprice "
                     "from orders where o_orderdate < date '1993-01-01' "
                     "order by o_orderdate, o_totalprice desc, o_orderkey"),
}
DIST_DISTINCT = ("select o_orderpriority, o_orderstatus from orders", 4)
Q1_MESH = 4
# phase 6's largest insert of a task (Q9 and Q18 cut to keep the run
# within its time limit)
DIST_CAPTURE = ("Q21",)


def _ordered(sql: str) -> bool:
    return "order by" in sql.lower()


def _same_dist(got: list, want: list, sql: str, what: str,
               rel_tol: float) -> float:
    """Rows equal in order where the query orders, as sets otherwise."""
    if not _ordered(sql):
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    return same_rows(got, want, what, rel_tol)


def _stages_line(runner, frags: list) -> str:
    counts, _ = runner.stage_task_counts(frags)
    return ", ".join(f"f{f.id} {f.partitioning} x{counts[f.id]} -> "
                     f"{f.output_kind}" for f in frags)


def _edges(runner, frags: list) -> tuple:
    """(collective fragment ids, host edges as "fN KIND") of the runner's
    last query, whose fragments are ``frags``."""
    coll = sorted(runner._collective_edges)
    host = [f"f{f.id} {f.output_kind}" for f in frags
            if f.output_kind != "OUTPUT" and f.id not in coll]
    return coll, host


def _timed(torch, runner, sql: str) -> tuple:
    t0 = time.perf_counter()
    res = runner.execute(sql)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, res


def _distinct_limit(runner, sql: str, count: int):
    """``sql``'s plan under a DistinctLimit node (no SQL text plans one:
    only planner/add_exchanges places it, over a DistinctLimit it is
    given), run through the distributed runner: a partial
    DistinctLimitOperator per task, a GATHER, the final one."""
    from trino_tpu_torch.execution.fragmenter import fragment_plan
    from trino_tpu_torch.planner.add_exchanges import add_exchanges
    from trino_tpu_torch.planner.logical import LogicalPlanner
    from trino_tpu_torch.planner.optimizer import optimize
    from trino_tpu_torch.planner.plan import DistinctLimit, Output
    from trino_tpu_torch.sql.parser import parse_statement

    plan = optimize(LogicalPlanner(runner.catalog, "tpch").plan(
        parse_statement(sql)), runner.catalog)
    src = plan.source
    plan = dataclasses.replace(plan, source=DistinctLimit(
        src.output_names, src.output_types, src, count))
    sub = fragment_plan(add_exchanges(plan))
    return sub, runner._execute_subplan(sub, None)


def _q1_rows(keys, values, used) -> dict:
    """fused key rf * 1000 + ls -> (5 sums, count) of the used slots."""
    used = used.cpu().numpy()
    k = [x.cpu().numpy() for x in keys]
    v = [x.cpu().numpy() for x in values]
    out = {}
    for i in np.nonzero(used)[0]:
        out[int(k[0][i]) * 1000 + int(k[1][i])] = (
            tuple(float(x[i]) for x in v[:5]), int(v[5][i]))
    return out


def _same_q1(got: dict, want, what: str) -> float:
    uniq, cols = want
    if sorted(got) != [int(u) for u in uniq]:
        raise AssertionError(f"{what}: groups {sorted(got)} != {uniq}")
    worst = 0.0
    names = ("qty", "price", "disc_price", "charge", "disc")
    for i, u in enumerate(uniq):
        sums, count = got[int(u)]
        if count != int(cols["count"][i]):
            raise AssertionError(f"{what}: count of {u} {count} != "
                                 f"{cols['count'][i]}")
        for name, s in zip(names, sums):
            w = float(cols[name][i])
            if not math.isclose(s, w, rel_tol=DOUBLE_RTOL):
                raise AssertionError(f"{what}: {name} of {u} {s} != {w}")
            worst = max(worst, abs(s - w) / abs(w) if w else 0.0)
    return worst


def distributed(torch, GK, default_catalog, tpch_runner, sqls: dict,
                path_rows: dict, smi: str) -> tuple:
    """Phase 19: the distributed runner on the card, SF 1, four tasks per
    stage sharing the one card (the mesh puts four shards on it, so no
    interconnect is measured).  (a) the 24 queries but DIST_CUT, one cold
    run each (the warm runs and DIST_CUT were cut to keep the script
    within its time limit),
    through DistributedQueryRunner(worker_count=4): rows equal phase 3's
    standalone rows; per query the stages and task counts, the collective
    and host edges, launches by kernel, host syncs by tag and the
    device-to-host bytes (traced); DIST_TURNS warm with collectives on,
    off, off, on (rows equal).  (b) Q3 with exchange_serde (rows equal, pages and bytes serialized), ORDER BY
    through the MERGE exchange (nation: the heap merge; orders of 1992:
    sorted again on the card) against the standalone runner, and a
    DistinctLimit plan.  (c) the fused Q1 program on make_q1_inputs(1):
    q1_step and q1_spmd over a 4-shard mesh against q1_numpy (counts
    exact, sums rtol 1e-9), warm ms, input rows/s, launches.  Returns the
    phase's launches, the runner, the Q1 batch for phase 6's cases and
    the cold walls by query (phase 22 prints its walls beside them)."""
    t_phase = time.perf_counter()
    from trino_tpu_torch.bench_kernels import (make_q1_inputs, q1_numpy,
                                               q1_spmd, q1_step)
    from trino_tpu_torch.exec import syncguard as SG
    from trino_tpu_torch.execution import task as T
    from trino_tpu_torch.execution.distributed_runner import (
        DistributedQueryRunner)
    from trino_tpu_torch.parallel.distributed import make_mesh
    from trino_tpu_torch.runner import Session
    from trino_tpu_torch.tools.window_profile import copy_bytes

    cat = default_catalog(PATH_SF)
    dist = DistributedQueryRunner(
        cat, worker_count=DIST_WORKERS,
        session=Session(node_count=DIST_WORKERS), device="cuda")
    log(f"distributed: {DIST_WORKERS} tasks per stage share one card "
        f"({smi}); the mesh's all_to_all is a copy within its memory, so "
        f"no interconnect is measured")
    GK.reset_launch_counts()
    # -- (a) the queries ----------------------------------------------------
    cold_ms: dict = {}
    for name, sql in sqls.items():
        if name in DIST_CUT:
            continue
        before = dict(GK.LAUNCHES)
        out = []
        s0 = SG.snapshot()
        # the run is traced for its device-to-host copies
        copies = copy_bytes(lambda: out.append(_timed(torch, dist, sql)))
        cold, res = out[0]
        sync = SG.take_delta(s0)
        cold_ms[name] = cold
        cold_rows = res.rows()
        rtol = REAL_PARITY_RTOL if name in REAL_QUERIES else DOUBLE_RTOL
        worst = _same_dist(cold_rows, path_rows[name], sql,
                           f"distributed {name}", rtol)
        launched = {k: GK.LAUNCHES[k] - before[k] for k in GK.LAUNCHES}
        for k in REQUIRED.get(name, ()):
            if launched[k] <= 0:
                raise AssertionError(f"distributed {name} launched no {k}")
        frags = dist.create_subplan(sql).all_fragments()
        coll, host = _edges(dist, frags)
        log(f"distributed SF{PATH_SF:g} {name}: {len(cold_rows)} rows equal "
            f"phase 3's (largest float rel diff {worst:.3g}), cold "
            f"{cold:.1f} ms (traced); stages [{_stages_line(dist, frags)}]; "
            f"collective edges {['f%d' % f for f in coll]}, host edges "
            f"{host}; launches {launched}; host syncs {sync.host_syncs} "
            f"{dict(sorted(sync.by_tag.items()))}; device-to-host bytes "
            f"{_dtoh(copies)}")
    log(f"distributed cold sum {sum(cold_ms.values()):.1f} ms "
        f"({len(cold_ms)} queries, one run each; four tasks share the "
        f"card)")
    off = DistributedQueryRunner(
        cat, worker_count=DIST_WORKERS,
        session=Session(node_count=DIST_WORKERS, use_collectives=False),
        device="cuda")
    for name in DIST_TURNS:
        sql = sqls[name]
        times, outs = [], []
        for r in (dist, off, off, dist):
            ms, res = _timed(torch, r, sql)
            times.append(ms)
            outs.append(res.rows())
        if off._collective_edges or not dist._collective_edges:
            raise AssertionError(f"distributed {name}: collectives on "
                                 f"{list(dist._collective_edges)}, off "
                                 f"{list(off._collective_edges)}")
        for o in outs[1:]:
            _same_dist(o, outs[0], sql, f"distributed {name} on vs off",
                       DOUBLE_RTOL)
        on, off_ = sorted(times[0::3]), sorted(times[1:3])
        apart = on[1] < off_[0] or off_[1] < on[0]
        log(f"distributed {name} warm ms, collectives on / off / off / on "
            f"({smi}): {' / '.join(f'{t:.1f}' for t in times)}; on "
            f"{on[0]:.1f}-{on[1]:.1f}, off {off_[0]:.1f}-{off_[1]:.1f}: "
            f"the ranges {'are apart' if apart else 'overlap'}; rows equal")
    # -- (b) wire format, MERGE, DistinctLimit -------------------------------
    serde = DistributedQueryRunner(
        cat, worker_count=DIST_WORKERS,
        session=Session(node_count=DIST_WORKERS, exchange_serde=True),
        device="cuda")
    orig_ser = T.serialize_batch
    pages = [0, 0]

    def counted(batch, *a, **kw):
        out = orig_ser(batch, *a, **kw)
        pages[0] += 1
        pages[1] += len(out)
        return out

    T.serialize_batch = counted
    try:
        for name in DIST_SERDE:
            pages[:] = [0, 0]
            ms, res = _timed(torch, serde, sqls[name])
            _same_dist(res.rows(), path_rows[name], sqls[name],
                       f"distributed serde {name}", DOUBLE_RTOL)
            if not pages[0]:
                raise AssertionError(f"serde {name} serialized no page")
            log(f"distributed exchange_serde {name}: rows equal, "
                f"{pages[0]} pages / {pages[1]} bytes serialized, "
                f"{ms:.1f} ms")
    finally:
        T.serialize_batch = orig_ser
    for label, sql in DIST_MERGE.items():
        if "MERGE" not in dist.explain(sql):
            raise AssertionError(f"{label}: no MERGE exchange")
        ms, res = _timed(torch, dist, sql)
        got = res.rows()
        same_rows(got, tpch_runner.execute(sql).rows(),
                  f"distributed {label}")
        log(f"distributed {label}: {len(got)} rows in the standalone "
            f"runner's order, {ms:.1f} ms")
    sql, count = DIST_DISTINCT
    sub, res = _distinct_limit(dist, sql, count)
    got = res.rows()
    want = set(tpch_runner.execute(sql).rows())
    text = sub.text()
    if (len(got) != count or len(set(got)) != count
            or not set(got) <= want or text.count("DistinctLimit") != 2):
        raise AssertionError(f"distinct limit: {got} of {len(want)}")
    log(f"distributed DistinctLimit[{count}] over {len(want)} distinct "
        f"rows: {count} distinct rows, a partial DistinctLimit per task "
        f"and the final one")
    # -- (c) the fused Q1 program ------------------------------------------
    t0 = time.perf_counter()
    b = make_q1_inputs(PATH_SF, "cuda")
    torch.cuda.synchronize()
    n = int(b.shipdate.shape[0])
    log(f"q1 inputs: make_q1_inputs({PATH_SF:g}) {n} rows on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    want = q1_numpy(b)
    mesh = make_mesh(Q1_MESH)
    spmd = q1_spmd(mesh)
    for label, fn in (("q1_step", lambda: q1_step(b)),
                      (f"q1_spmd over {mesh}", lambda: spmd(b))):
        before = dict(GK.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        launched = {k: GK.LAUNCHES[k] - before[k] for k in GK.LAUNCHES}
        if label.startswith("q1_spmd"):
            overflow = int(out[3].max())
            if overflow > 8:
                raise AssertionError(f"q1_spmd overflow {overflow} > 8")
            keys, values, used = out[0], out[1], out[2]
        else:
            keys, values, used = out
        worst = _same_q1(_q1_rows(keys, values, used), want, label)
        ms = cuda_ms(torch, fn, 5)
        log(f"{label}: equals q1_numpy (counts exact, largest sum rel diff "
            f"{worst:.3g}), warm {ms:.3f} ms ({smi}), {n / ms * 1e3:.0f} "
            f"input rows/s, launches a call {launched}")
    launches = dict(GK.LAUNCHES)
    log(f"distributed launches: {launches}")
    log(f"distributed: {time.perf_counter() - t_phase:.1f} s for phase 19")
    return launches, dist, b, cold_ms


# ---------------------------------------------------------------------------
# phase 20: the compiled stages (fused seams, resident plans) on the
# distributed path


# the queries whose plan at four tasks carries a fused seam or a resident
# plan (Q2, Q3, Q10, Q11)
# Q10, Q15, Q17 and Q20 (four of the seven that fall back) cut for phase
# 23; Q9, Q18 (a fallback) and Q21 cut for phase 24
COMPILED_QUERIES = ("Q1", "Q2", "Q3", "Q4", "Q5", "Q11", "Q13", "R1", "R2")
COMPILED_PROFILED = ("Q1", "Q3")  # launches per accumulate call
COMPILED_SYNC = ("Q3",)  # under SG.forbidden(cuda_sync_debug=True)
# default / =0 / =0 / default (Q10 cut to make room for phase 22)
COMPILED_TURNS = ("Q1",)  # Q3 cut for phase 23
# the queries that fall back run cold only (cut to make room for phase 22)
COMPILED_COLD_ONLY = ("Q2", "Q13",
                      # cut for phase 23: warm only Q1 and Q3
                      "Q4", "Q5", "Q11", "R1", "R2")
COMPILED_CAPTURE = ("Q1", "Q3")  # phase 6's "compiled" cases
COMPILED_REQUIRED = ("hash_insert", "hash_probe")
COMPILED_OFF = (("TRINO_TPU_FUSED_STAGE", "0"),
                ("TRINO_TPU_RESIDENT_PLAN", "0"))
COMPILED_KNOBS = ("TRINO_TPU_FUSED_STAGE", "TRINO_TPU_RESIDENT_PLAN",
                  "TRINO_TPU_FUSED_CAP", "TRINO_TPU_MESH_SHAPE",
                  "TRINO_TPU_RESIDENT_MAX_FRAGMENTS")


@contextlib.contextmanager
def _compiled_off():
    """The per-operator path of phase 19: both compiled stages off."""
    with contextlib.ExitStack() as stack:
        for name, value in COMPILED_OFF:
            stack.enter_context(_env_scope(name, value)())
        yield


def _compiled_execs(runner) -> tuple:
    """(fused seam execs, resident plan execs) of the runner's last query."""
    from trino_tpu_torch.execution.plan_compiler import ResidentPlanExec

    return (list(runner._fused_edges.values()),
            [e for e in runner._resident_edges.values()
             if isinstance(e, ResidentPlanExec)])


def _compiled_stats(runner) -> dict:
    fused, resident = _compiled_execs(runner)
    st = [e.stats for e in fused] + [e.stats for e in resident]
    return {"seams": len(fused), "plans": len(resident),
            "batches": sum(s.batches for s in st),
            "calls": sum(s.jit_calls for s in st),
            "first": sum(s.compiles for s in st),
            "hits": sum(s.cache_hits for s in st),
            "merges": sum(s.merges for s in st),
            "code_seams": sum(e.rstats.code_seam_columns for e in resident)}


def _launches_per_batch(torch, SG, runner, sql: str,
                        reps: int = 10) -> tuple:
    """Device work of one accumulate call: the first batch a sink absorbs
    in one warm run of ``sql`` is kept, and ``reps`` more calls of that
    sink on that batch (after the run, on this thread, in a hot region)
    are traced under torch.profiler.  Returns (rows of the batch, kernels,
    copies, memsets, device ms, each per call, and the three kernels with
    the most device time as (name, ms per call))."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from trino_tpu_torch.execution import stage_compiler as SC

    kept: list = []
    orig = SC._CarriedStateSink.add_input

    def keep(self, batch):
        if not kept and batch.num_rows:
            kept.append((self, batch))
        return orig(self, batch)

    SC._CarriedStateSink.add_input = keep
    try:
        runner.execute(sql)
    finally:
        SC._CarriedStateSink.add_input = orig
    torch.cuda.synchronize()
    if not kept:
        raise AssertionError("no accumulate call")
    sink, batch = kept[0]
    with SG.hot_region():
        sink._accumulate(batch)  # warm
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        with SG.hot_region():
            for _ in range(reps):
                sink._accumulate(batch)
        torch.cuda.synchronize()
    out = os.path.join("build", "profiles")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"compiled-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    count = {c: sum(1 for e in dev if e["cat"] == c)
             for c in ("kernel", "gpu_memcpy", "gpu_memset")}
    by_name: dict = {}
    for e in dev:
        if e["cat"] == "kernel":
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return (batch.num_rows, count["kernel"] / reps,
            count["gpu_memcpy"] / reps, count["gpu_memset"] / reps,
            sum(float(e["dur"]) for e in dev) / reps / 1e3,
            [(name[:60], us / reps / 1e3) for name, us in top])


def compiled(torch, GK, default_catalog, sqls: dict, path_rows: dict,
             smi: str) -> tuple:
    """Phase 20: the compiled stages on the card, SF 1 over the tpch
    connector, DistributedQueryRunner(worker_count=4) at the default knobs
    (fused seams and resident plans on, TRINO_TPU_FUSED_CAP 8192).  (a)
    The queries of COMPILED_QUERIES, nine of the 16 whose plan carries
    a fused seam or a resident plan,
    cold and warm (COMPILED_COLD_ONLY cold only): rows equal phase 3's;
    per query the fused seams,
    resident plans, fallbacks (with the reason), batches, program calls,
    first calls of a signature, merges, warm ms and the device-to-host
    bytes of the cold run (traced); hash_insert and hash_probe must
    launch.  (b) Kernel launches per accumulate call: the first batch of
    one warm run of Q1 and of Q3 through its sink again (torch.profiler).  (c) Q1 and Q3 once more under
    SG.forbidden(cuda_sync_debug=True) on a runner whose tasks share one
    time-sharing worker and scan synchronously (no other thread touches
    the card while a hot region runs): no hot-loop sync.  (d) Q1 and Q3
    warm in turns, default / =0 / =0 / default.  Returns the phase's
    launches and the runner for phase 6's "compiled" cases."""
    t_phase = time.perf_counter()
    from trino_tpu_torch.exec import syncguard as SG
    from trino_tpu_torch.exec.prefetch import IngestConfig
    from trino_tpu_torch.execution.distributed_runner import (
        DistributedQueryRunner)
    from trino_tpu_torch.runner import Session
    from trino_tpu_torch.tools.window_profile import copy_bytes

    set_knobs = {k: os.environ[k] for k in COMPILED_KNOBS if k in os.environ}
    if set_knobs:
        raise AssertionError(f"phase 20 runs the default knobs: {set_knobs}")
    cat = default_catalog(PATH_SF)
    dist = DistributedQueryRunner(
        cat, worker_count=DIST_WORKERS,
        session=Session(node_count=DIST_WORKERS), device="cuda")
    log(f"compiled: {DIST_WORKERS} tasks per stage share one card ({smi}); "
        "fused seams and resident plans at their defaults")
    # -- (a) the queries ----------------------------------------------------
    GK.reset_launch_counts()
    warm_ms: dict = {}
    fallbacks: dict = {}
    for name in COMPILED_QUERIES:
        sql = sqls[name]
        before = dict(GK.LAUNCHES)
        out = []
        copies = copy_bytes(lambda: out.append(_timed(torch, dist, sql)))
        cold, res = out[0]
        cold_rows = res.rows()
        cold_st, cold_fb = _compiled_stats(dist), dist.last_fallback
        s0 = SG.snapshot()
        if name in COMPILED_COLD_ONLY:
            warm, st, fb, rows = None, cold_st, cold_fb, cold_rows
        else:
            warm, res = _timed(torch, dist, sql)
            st, fb = _compiled_stats(dist), dist.last_fallback
            rows = res.rows()
            warm_ms[name] = warm
        sync = SG.take_delta(s0)
        launched = {k: GK.LAUNCHES[k] - before[k] for k in GK.LAUNCHES}
        rtol = REAL_PARITY_RTOL if name in REAL_QUERIES else DOUBLE_RTOL
        _same_dist(cold_rows, path_rows[name], sql,
                   f"compiled {name} cold", rtol)
        worst = _same_dist(rows, path_rows[name], sql,
                           f"compiled {name} warm", rtol)
        if fb is not None:
            fallbacks[name] = fb
        if not (st["seams"] or st["plans"] or fb is not None):
            raise AssertionError(f"compiled {name}: no fused seam, no "
                                 "resident plan, no fallback")
        log(f"compiled SF{PATH_SF:g} {name}: {len(rows)} rows equal phase "
            f"3's (largest float rel diff {worst:.3g}); fused seams "
            f"{st['seams']}, resident plans {st['plans']} "
            f"({st['code_seams']} code-seam columns); fallback "
            f"{'none' if fb is None else repr(fb)}"
            f"{'' if cold_fb == fb else f' (cold: {cold_fb!r})'}; "
            f"{'cold' if warm is None else 'warm'}: "
            f"{st['batches']} batches in {st['calls']} program calls, "
            f"{st['first']} first calls of a signature / {st['hits']} "
            f"repeats, {st['merges']} merges; cold: {cold_st['first']} "
            f"first calls of {cold_st['calls']}; cold {cold:.1f} ms "
            f"(traced), warm "
            f"{'not run' if warm is None else f'{warm:.1f} ms'} ({smi}); "
            f"launches (cold + warm) {launched}; warm host syncs "
            f"{sync.host_syncs} "
            f"{dict(sorted(sync.by_tag.items()))}; device-to-host bytes of "
            f"the cold run {_dtoh(copies)}")
    launches = dict(GK.LAUNCHES)
    for k in COMPILED_REQUIRED:
        if launches[k] <= 0:
            raise AssertionError(f"the compiled path launched no {k}")
    log(f"compiled warm sum {sum(warm_ms.values()):.1f} ms "
        f"({len(warm_ms)} queries); fallbacks {len(fallbacks)}: "
        f"{sorted(fallbacks)}; launches {launches}; (a) took "
        f"{time.perf_counter() - t_phase:.1f} s")
    # -- (b) launches per accumulate call -----------------------------------
    for name in COMPILED_PROFILED:
        rows, kernels, copies, sets, dev_ms, top = _launches_per_batch(
            torch, SG, dist, sqls[name])
        if kernels <= 0 and torch.cuda.is_available():
            raise AssertionError(f"compiled {name}: no kernel in the trace "
                                 "of an accumulate call")
        log(f"compiled {name}: one accumulate call (the first batch of a "
            f"warm run, {rows} rows, traced 10 times with torch.profiler) "
            f"launches {kernels:.1f} kernels, {copies:.1f} copies and "
            f"{sets:.1f} memsets on the device, {dev_ms:.3f} device ms "
            f"(summed); most device time: "
            + "; ".join(f"{n} {ms:.3f} ms" for n, ms in top))
    t_part = time.perf_counter()
    # -- (c) no hot-loop sync under the sync debug mode ---------------------
    sync_runner = DistributedQueryRunner(
        cat, worker_count=DIST_WORKERS, device="cuda",
        ingest=IngestConfig(enabled=False),
        session=Session(node_count=DIST_WORKERS,
                        task_scheduler="TIME_SHARING", executor_workers=1))
    for name in COMPILED_SYNC:
        sql = sqls[name]
        sync_runner.execute(sql)  # warm: first calls, caches
        torch.cuda.synchronize()
        s0 = SG.snapshot()
        with SG.forbidden(cuda_sync_debug=True):
            res = sync_runner.execute(sql)
            torch.cuda.synchronize()
        sync = SG.take_delta(s0)
        st = _compiled_stats(sync_runner)
        if sync.hot_loop_syncs or not (st["seams"] or st["plans"]):
            raise AssertionError(f"compiled {name} (c): {sync.text()}, {st}")
        _same_dist(res.rows(), path_rows[name], sql,
                   f"compiled {name} (c)", DOUBLE_RTOL)
        log(f"compiled {name} (c): a run under SG.forbidden(cuda_sync_debug"
            f"=True) (one time-sharing worker, synchronous scan) made no "
            f"blocking sync in a hot region: {sync.text()}")
    del sync_runner
    log(f"compiled (c): {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()
    # -- (d) default against =0 in turns -------------------------------------
    for name in COMPILED_TURNS:
        sql = sqls[name]
        times, outs, execs = [], [], []
        for on in (True, False, False, True):
            with contextlib.ExitStack() as stack:
                if not on:
                    stack.enter_context(_compiled_off())
                ms, res = _timed(torch, dist, sql)
            times.append(ms)
            outs.append(res.rows())
            execs.append(any(_compiled_execs(dist)))
        if execs[1] or execs[2]:
            raise AssertionError(f"compiled {name}: =0 compiled a stage")
        for o in outs[1:]:
            _same_dist(o, outs[0], sql, f"compiled {name} default vs =0",
                       DOUBLE_RTOL)
        log(f"compiled {name} warm ms, default / =0 / =0 / default "
            f"({smi}): {' / '.join(f'{t:.1f}' for t in times)}; "
            f"fallback {dist.last_fallback!r} on the last default run")
    log(f"compiled (d): {time.perf_counter() - t_part:.1f} s")
    log(f"compiled: {time.perf_counter() - t_phase:.1f} s for phase 20")
    return launches, dist


# ---------------------------------------------------------------------------
# phase 21: history-based optimization, the adaptive plane and fault-
# tolerant execution on the distributed path

P21_PINS = ("TRINO_TPU_HBO", "TRINO_TPU_ADAPTIVE")  # "0" before phase 21
# twice each: record, plan from it (Q3 and Q18 cut for phase 23)
P21_HBO = ("Q1", "Q5")
P21_ADAPTIVE_RUNS = 2  # decision-site queries run at auto
P21_FTE = ("Q3", "Q12", "R1")  # retry_policy=TASK (Q1 cut for phase 23)
P21_CAPTURE = ("Q3", "Q12", "R1")  # phase 6's "fault-tolerant" cases
P21_JOIN = ("select c.c_mktsegment, count(*) n, sum(o.o_totalprice) s "
            "from orders o join customer c on o.o_custkey = c.c_custkey "
            "group by c.c_mktsegment order by 1")
P21_SKEW = ("select count(*) n, sum(p.v + b.w) s from skew21 p "
            "join dim21 b on p.k = b.k")
SKEW_ROWS = 6_000_000
SKEW_SHARE = 0.3  # of the probe rows on one join key
SKEW_KEYS = 100_000
SKEW_SEED = 21
SKEW_FACTOR = 1.1  # 30 % against 1.1 x the 25 % mean of four tasks
P21_STALL_S = 60.0  # the stalled leaf's stall; its twin must win first
P21_JOURNAL_FILL = 12 << 20  # bytes appended before (a2)'s lookups
P21_JOURNAL_ROUNDS = 5


def _walk_plan(node):
    yield node
    for c in node.children:
        yield from _walk_plan(c)


def _join_distributions(runner, sql: str) -> list:
    from trino_tpu_torch.planner.plan import Join

    return [f"f{f.id}:{n.distribution}"
            for f in runner.create_subplan(sql).all_fragments()
            for n in _walk_plan(f.root) if isinstance(n, Join)]


def _plan_stats_records() -> list:
    from trino_tpu_torch.telemetry import journal

    return journal.get_journal().read(events=("plan_stats",))


def _compiled_edges(runner) -> str:
    """The fused seams' and resident plans' fragment ids of the runner's
    last query (a history-driven fan-out can take a seam away)."""
    return (f"fused seams {sorted(runner._fused_edges)}, resident plans "
            f"{sorted(runner._resident_edges)}")


def _journal_cost(torch, cat, sqls: dict, smi: str) -> None:
    """(a2) What history costs a plan-cache hit and a plan at the default
    knobs once the journal is full: P21_JOURNAL_FILL bytes of query
    triples (created, completed, an 8-node plan_stats) are appended, then
    a standalone runner executes Q6 (appending its own records) and looks
    its plan up, and plans Q3, P21_JOURNAL_ROUNDS times.  Printed beside
    them: one full parse of the journal's plan_stats, the cost a lookup
    would pay if the table were re-read after every append."""
    from trino_tpu_torch.caching import plan_cache
    from trino_tpu_torch.planner import history
    from trino_tpu_torch.runner import StandaloneQueryRunner
    from trino_tpu_torch.telemetry import journal

    t_part = time.perf_counter()
    j = journal.get_journal()
    created, completed = [r for r in journal.sample_records()
                          if r["event"] in ("query_created",
                                            "query_completed")][:2]

    def size() -> int:
        return sum(os.path.getsize(f) for f in j.fleet_files())

    start, i = size(), 0
    while size() - start < P21_JOURNAL_FILL:
        for _ in range(256):
            j._write(created)
            j._write(completed)
            j.plan_stats(f"fill_{i}", "fill", {
                f"fill{i:07d}n{n}": {"rows": 1000 * n + i, "bytes": 8 * i}
                for n in range(8)}, 1.7e9 + i)
            i += 1
    written = size() - start
    t0 = time.perf_counter()
    n_stats = len(j.read(events=("plan_stats",)))
    full_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    table, _ = history._stats_table()
    first_ms = (time.perf_counter() - t0) * 1e3
    sa = StandaloneQueryRunner(cat, device="cuda")
    hit_ms, plan_ms = [], []
    for _ in range(P21_JOURNAL_ROUNDS):
        sa.execute(sqls["Q6"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hit = plan_cache.lookup(sqls["Q6"], sa.session, cat,
                                sa.execution_key)
        hit_ms.append((time.perf_counter() - t0) * 1e3)
        if hit is None:
            raise AssertionError("resilient journal: Q6's plan missed")
        t0 = time.perf_counter()
        sa.create_plan(sqls["Q3"])
        plan_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"resilient journal ({smi}): {written} bytes of {3 * i} records "
        f"appended ({n_stats} plan_stats, {len(table)} fingerprints in "
        f"the table, {len(j.fleet_files())} files); a full parse of its "
        f"plan_stats {full_ms:.2f} ms; the first table lookup "
        f"{first_ms:.2f} ms; after each executed Q6, its plan-cache hit "
        f"ms {[round(x, 3) for x in hit_ms]}, a plan of Q3 ms "
        f"{[round(x, 2) for x in plan_ms]}; (a2) took "
        f"{time.perf_counter() - t_part:.1f} s")


def _skew_tables(torch, cat, device) -> tuple:
    """``memory.skew21`` (k, v: SKEW_ROWS rows, SKEW_SHARE of them on key
    7) and ``memory.dim21`` (k, w: SKEW_KEYS rows) generated on the card
    from SKEW_SEED, pinned there; returns the expected (count, sum)."""
    from trino_tpu_torch.spi.batch import Column, ColumnBatch
    from trino_tpu_torch.spi.connector import ColumnSchema, TableSchema
    from trino_tpu_torch.spi.types import BIGINT

    g = torch.Generator(device=device)
    g.manual_seed(SKEW_SEED)
    k = torch.randint(0, SKEW_KEYS, (SKEW_ROWS,), generator=g,
                      device=device)
    hot = torch.rand(SKEW_ROWS, generator=g, device=device) < SKEW_SHARE
    k = torch.where(hot, torch.full_like(k, 7), k)
    v = torch.randint(0, 100, (SKEW_ROWS,), generator=g, device=device)
    dk = torch.arange(SKEW_KEYS, device=device)
    w = dk % 13
    mem = cat.connector("memory")
    for name, cols in (("skew21", (("k", k), ("v", v))),
                       ("dim21", (("k", dk), ("w", w)))):
        mem.create_table(TableSchema(name, tuple(
            ColumnSchema(c, BIGINT) for c, _ in cols)))
        mem.finish_insert(name, [[ColumnBatch(
            [c for c, _ in cols], [Column(BIGINT, t) for _, t in cols])]])
        mem.pin_to_device(name, device)
    want = (SKEW_ROWS, int((v.sum() + w[k].sum()).item()))
    return want, float(hot.float().mean().item())


def resilient(torch, GK, default_catalog, sqls: dict, path_rows: dict,
              smi: str) -> tuple:
    """Phase 21: history-based optimization, the adaptive plane and
    fault-tolerant execution, DistributedQueryRunner(worker_count=4) on the
    card over the tpch connector at SF 1, at the default knobs (the
    earlier phases pin TRINO_TPU_HBO=0 and TRINO_TPU_ADAPTIVE=0), with the
    script's fresh journal and the result tier off.  (a) HBO: Q1, Q3, Q5
    and Q18 twice each (the fingerprints the first run records; the
    second's lookups, hits, join distributions, fan-out adjustments and
    compiled edges; whether its plan changed), then one standalone plan
    and its hits; (a2) a plan-cache hit and a plan after a 12 MiB journal
    fill (``_journal_cost``).  (b) Adaptive:
    the queries whose plan has a decision site, two of them at auto; a
    mis-estimate drill (TRINO_TPU_BROADCAST_ROW_LIMIT=0: the barrier flips
    the join from observed bytes); a skew drill over a 6,000,000-row
    memory table generated on the card (30 % of its rows on one key: the
    split and its imbalance ratio).  (c) FTE: Q1, Q3, Q12 and R1 under
    retry_policy=TASK (spool bytes written and read, attempts, every
    spooled page read back onto the card), then Q3 once with a task
    failure on a join-stage task, an upstream read failure, a corrupted
    part file and an out-of-memory attempt (the memory multiplier).
    (d) Q3 under retry_policy=QUERY with one injected failure; an FTE Q3
    interrupted after its first commits and resumed by a fresh runner
    from the write-ahead log (no committed attempt re-executed); a
    stalled leaf task whose speculative twin wins.  Rows equal phase 3's
    (the drills: a static run of the same query, or the card's own
    evaluation of the generated tables).  Returns the launches of (b) and
    (c) and the FTE runner for phase 6's "fault-tolerant" cases."""
    t_phase = time.perf_counter()
    from trino_tpu_torch.execution import durable_spool, query_state, spool_gc
    from trino_tpu_torch.execution.distributed_runner import (
        DistributedQueryRunner)
    from trino_tpu_torch.execution.failure_injector import (
        GET_RESULTS_FAILURE, SPOOL_CORRUPTION, TASK_FAILURE, TASK_OOM,
        TASK_STALL, FailureInjector)
    from trino_tpu_torch.planner.plan import Join
    from trino_tpu_torch.runner import Session, StandaloneQueryRunner
    from trino_tpu_torch.telemetry import metrics as tm
    from trino_tpu_torch.telemetry import runtime as rt

    base = tempfile.mkdtemp(prefix="chip-smoke-p21-", dir="build")
    with contextlib.ExitStack() as stack:
        for name in P21_PINS:  # the defaults, for this phase only
            old = os.environ.pop(name, None)
            stack.callback(
                lambda n=name, o=old: os.environ.__setitem__(n, o)
                if o is not None else None)
        stack.enter_context(_env_scope("TRINO_TPU_SPOOL_DIR",
                                       os.path.join(base, "spool"))())
        stack.enter_context(_env_scope("TRINO_TPU_QUERY_STATE_DIR",
                                       os.path.join(base, "state"))())
        stack.callback(shutil.rmtree, base, True)
        cat = default_catalog(PATH_SF)
        dist = DistributedQueryRunner(
            cat, worker_count=DIST_WORKERS, device="cuda",
            session=Session(node_count=DIST_WORKERS))
        log(f"resilient: {DIST_WORKERS} tasks per stage share one card "
            f"({smi}); default knobs (HBO auto, adaptive auto, fused seams "
            "and resident plans on); a fresh journal")

        # -- (a) HBO ----------------------------------------------------
        t_part = time.perf_counter()
        if _plan_stats_records():
            raise AssertionError("phase 21 starts from a journal with "
                                 "plan_stats: phases 3-20 pin HBO off")
        for name in P21_HBO:
            sql = sqls[name]
            plan1 = dist.explain(sql)
            dists1 = _join_distributions(dist, sql)
            n0 = len(_plan_stats_records())
            ms1, res = _timed(torch, dist, sql)
            _same_dist(res.rows(), path_rows[name], sql,
                       f"resilient {name} run 1", DOUBLE_RTOL)
            edges1 = _compiled_edges(dist)
            recs = _plan_stats_records()[n0:]
            if len(recs) != 1 or not recs[0]["nodes"]:
                raise AssertionError(f"resilient {name}: run 1 recorded "
                                     f"{len(recs)} plan_stats records")
            log(f"resilient HBO {name} run 1: {ms1:.1f} ms ({smi}); join "
                f"distributions {dists1}; {edges1}; recorded fingerprints "
                + json.dumps(recs[0]["nodes"], sort_keys=True))
            look0 = tm.HBO_PLAN_LOOKUPS.value()
            hits0 = tm.HBO_PLAN_HITS.value()
            fan0 = tm.HBO_FANOUT_ADJUSTED.value()
            ms2, res = _timed(torch, dist, sql)
            _same_dist(res.rows(), path_rows[name], sql,
                       f"resilient {name} run 2", DOUBLE_RTOL)
            fanout = [t for t in rt.queries()[-1].adaptive_decisions
                      .split(",") if t.startswith("hbo_fanout")]
            look = tm.HBO_PLAN_LOOKUPS.value() - look0
            hits = tm.HBO_PLAN_HITS.value() - hits0
            fan = tm.HBO_FANOUT_ADJUSTED.value() - fan0
            if not look and not fan:  # Q1 has no join: only the fan-out
                raise AssertionError(f"resilient {name}: run 2 planned "
                                     "without the history table")
            edges2 = _compiled_edges(dist)
            plan2 = dist.explain(sql)
            log(f"resilient HBO {name} run 2: {ms2:.1f} ms ({smi}); "
                f"{look} history lookups, {hits} hits; join distributions "
                f"{_join_distributions(dist, sql)}; fan-out adjustments "
                f"{fan} {fanout}; plan "
                f"{'differs from' if plan2 != plan1 else 'equals'} run 1's; "
                f"{edges2} ({'same as' if edges2 == edges1 else 'not'} "
                "run 1's)")
        look0 = tm.HBO_PLAN_LOOKUPS.value()
        hits0 = tm.HBO_PLAN_HITS.value()
        StandaloneQueryRunner(cat, device="cuda").create_plan(sqls["Q3"])
        log(f"resilient HBO: a standalone plan of Q3 after the records: "
            f"{tm.HBO_PLAN_LOOKUPS.value() - look0} lookups, "
            f"{tm.HBO_PLAN_HITS.value() - hits0} hits; (a) took "
            f"{time.perf_counter() - t_part:.1f} s")
        _journal_cost(torch, cat, sqls, smi)

        # -- (b) adaptive -------------------------------------------------
        t_part = time.perf_counter()
        GK.reset_launch_counts()
        sites = {n: dist.adaptive_sites(sqls[n]) for n in sqls}
        with_sites = [n for n in sqls if sites[n]]
        log(f"resilient adaptive: decision sites at {DIST_WORKERS} tasks: "
            + "; ".join(f"{n} {sites[n]}" for n in with_sites)
            + f" ({len(with_sites)} of {len(sqls)} queries)")
        for name in with_sites[:P21_ADAPTIVE_RUNS]:
            sql = sqls[name]
            ms, res = _timed(torch, dist, sql)
            rtol = REAL_PARITY_RTOL if name in REAL_QUERIES else DOUBLE_RTOL
            _same_dist(res.rows(), path_rows[name], sql,
                       f"resilient adaptive {name}", rtol)
            st = dist.last_adaptive.stats
            log(f"resilient adaptive {name}: {ms:.1f} ms ({smi}); "
                f"{st.activations} phased activations, decisions "
                f"{st.decisions}; rows equal phase 3's")
        with contextlib.ExitStack() as drill:
            # the drills hold the planner's static choice: no history, no
            # fused seam, host edges (decision sites need plain buffers)
            for k, v in (("TRINO_TPU_HBO", "0"),
                         ("TRINO_TPU_FUSED_STAGE", "0"),
                         ("TRINO_TPU_BROADCAST_ROW_LIMIT", "0")):
                drill.enter_context(_env_scope(k, v)())
            plain = DistributedQueryRunner(
                cat, worker_count=DIST_WORKERS, device="cuda",
                session=Session(node_count=DIST_WORKERS,
                                use_collectives=False))
            static = DistributedQueryRunner(
                cat, worker_count=DIST_WORKERS, device="cuda",
                session=Session(node_count=DIST_WORKERS, adaptive="0",
                                use_collectives=False))
            want = static.execute(P21_JOIN).rows()
            ms, res = _timed(torch, plain, P21_JOIN)
            _same_dist(res.rows(), want, P21_JOIN, "resilient mis-estimate",
                       DOUBLE_RTOL)
            plane = plain.last_adaptive
            if plane is None or not any(
                    t.startswith("flip_to_broadcast")
                    for t in plane.stats.decisions):
                raise AssertionError("resilient mis-estimate: no flip to "
                                     "broadcast")
            site = plane.sites[0]
            log(f"resilient adaptive mis-estimate (row limit 0: the plan "
                f"partitions orders x customer): decisions "
                f"{plane.stats.decisions}; observed build bytes "
                f"{site.build.bytes_observed()} against the threshold "
                f"{plane.threshold}; {ms:.1f} ms ({smi}); rows equal the "
                "static plan's")
            skew_cat = default_catalog(PATH_SF)
            want, share = _skew_tables(torch, skew_cat, dist.device)
            skew = DistributedQueryRunner(
                skew_cat, worker_count=DIST_WORKERS, device="cuda",
                session=Session(node_count=DIST_WORKERS,
                                default_catalog="memory",
                                use_collectives=False,
                                broadcast_threshold_bytes=1000,
                                skew_factor=SKEW_FACTOR))
            ms, res = _timed(torch, skew, P21_SKEW)
            got = res.rows()
            if got != [want]:
                raise AssertionError(f"resilient skew: {got} != {[want]}")
            plane = skew.last_adaptive
            if not plane.last_split:
                raise AssertionError(f"resilient skew: no split "
                                     f"{plane.stats.decisions}")
            log(f"resilient adaptive skew ({SKEW_ROWS} probe rows generated "
                f"on the card, seed {SKEW_SEED}, {share:.4f} of them on "
                f"key 7; {SKEW_KEYS} build keys): decisions "
                f"{plane.stats.decisions}; split "
                f"{ {h: t.tolist() for h, t in plane.last_split.items()} }; "
                f"imbalance ratio {plane.last_imbalance:.4f}; {ms:.1f} ms "
                f"({smi}); count and sum equal the card's evaluation "
                f"{want}")
            del skew, skew_cat, plain, static
        adaptive_launches = dict(GK.LAUNCHES)
        log(f"resilient adaptive launches {adaptive_launches}; (b) took "
            f"{time.perf_counter() - t_part:.1f} s")

        # -- (c) fault-tolerant execution ----------------------------------
        t_part = time.perf_counter()
        GK.reset_launch_counts()
        spool = {"written": 0, "read": 0, "pages": 0, "off_card": 0}
        orig_write = durable_spool.write_frame_crc
        orig_iter = durable_spool._iter_partition

        def write_frame(f, page):
            spool["written"] += len(page)
            return orig_write(f, page)

        def iter_partition(d, p, device=None):
            path = os.path.join(d, f"part-{p}.bin")
            if os.path.exists(path):
                spool["read"] += os.path.getsize(path)
            for b in orig_iter(d, p, device):
                spool["pages"] += 1
                spool["off_card"] += b.device.type != dist.device.type
                yield b

        durable_spool.write_frame_crc = write_frame
        durable_spool._iter_partition = iter_partition
        stack.callback(setattr, durable_spool, "write_frame_crc", orig_write)
        stack.callback(setattr, durable_spool, "_iter_partition", orig_iter)
        fte = DistributedQueryRunner(
            cat, worker_count=DIST_WORKERS, device="cuda",
            session=Session(node_count=DIST_WORKERS, retry_policy="TASK"))
        for name in P21_FTE:
            sql = sqls[name]
            before = dict(spool)
            a0 = tm.FTE_ATTEMPT_STARTS.value()
            ms, res = _timed(torch, fte, sql)
            rtol = REAL_PARITY_RTOL if name in REAL_QUERIES else DOUBLE_RTOL
            _same_dist(res.rows(), path_rows[name], sql,
                       f"resilient FTE {name}", rtol)
            log(f"resilient FTE {name}: {ms:.1f} ms ({smi}); "
                f"{tm.FTE_ATTEMPT_STARTS.value() - a0:.0f} attempts; spool "
                f"bytes written {spool['written'] - before['written']}, "
                f"read {spool['read'] - before['read']} "
                f"({spool['pages'] - before['pages']} pages read onto the "
                "card); rows equal phase 3's")
        join_fid = next(
            f.id for f in fte.create_subplan(sqls["Q3"]).all_fragments()
            if any(isinstance(n, Join) for n in _walk_plan(f.root)))
        inj = FailureInjector()
        inj.inject(TASK_FAILURE, fragment_id=join_fid, task_index=0,
                   attempt=0)
        inj.inject(GET_RESULTS_FAILURE, task_index=1, attempt=0)
        inj.inject(SPOOL_CORRUPTION, task_index=2, attempt=0)
        inj.inject(TASK_OOM, task_index=3, attempt=0)
        drills = DistributedQueryRunner(
            cat, worker_count=DIST_WORKERS, device="cuda",
            session=Session(node_count=DIST_WORKERS, retry_policy="TASK",
                            failure_injector=inj))
        drills.session.fte_events = []
        a0 = tm.FTE_ATTEMPT_STARTS.value()
        r0 = tm.FTE_ATTEMPT_RETRIES.value()
        ms, res = _timed(torch, drills, sqls["Q3"])
        _same_dist(res.rows(), path_rows["Q3"], sqls["Q3"],
                   "resilient FTE drills", DOUBLE_RTOL)
        fired = [(r.kind, r.fired) for r in inj.rules]
        events = [e for e in drills.session.fte_events if e[0] != "commit"]
        mem = [e for e in events if e[0] == "memory_retry"]
        if any(not n for _, n in fired) or not mem or not [
                e for e in events if e[0] == "spool_corruption"]:
            raise AssertionError(f"resilient FTE drills: fired {fired}, "
                                 f"events {events}")
        log(f"resilient FTE Q3 with four injected faults: {ms:.1f} ms "
            f"({smi}); fired {fired} (the task failure on join stage "
            f"f{join_fid}); {tm.FTE_ATTEMPT_STARTS.value() - a0:.0f} "
            f"attempts, {tm.FTE_ATTEMPT_RETRIES.value() - r0:.0f} retries; "
            f"events {events}; memory multiplier {mem[0][3]}; rows equal "
            "phase 3's")
        if spool["off_card"] or not spool["pages"]:
            raise AssertionError(f"resilient FTE: spool reads {spool}")
        del drills
        ft_launches = dict(GK.LAUNCHES)
        for k in SOURCES:
            if ft_launches[k] <= 0:
                raise AssertionError(f"the fault-tolerant path launched no "
                                     f"{k} on the card")
        log(f"resilient FTE launches {ft_launches}; spool {spool}; (c) took "
            f"{time.perf_counter() - t_part:.1f} s")

        # -- (d) query retry, resume, speculation -------------------------
        t_part = time.perf_counter()
        inj = FailureInjector()
        inj.inject(TASK_FAILURE, task_index=0, attempt=0)
        retry = DistributedQueryRunner(
            cat, worker_count=DIST_WORKERS, device="cuda",
            session=Session(node_count=DIST_WORKERS, retry_policy="QUERY",
                            query_retry_attempts=1, failure_injector=inj))
        ms, res = _timed(torch, retry, sqls["Q3"])
        _same_dist(res.rows(), path_rows["Q3"], sqls["Q3"],
                   "resilient QUERY retry", DOUBLE_RTOL)
        if retry.resilience.query_retries != 1:
            raise AssertionError(f"resilient QUERY: {retry.resilience}")
        log(f"resilient QUERY Q3, one injected task failure: {ms:.1f} ms "
            f"({smi}); {retry.resilience.text()}; events "
            f"{retry.resilience_events}; rows equal phase 3's")
        del retry
        inj = FailureInjector()
        crashed = DistributedQueryRunner(
            cat, worker_count=DIST_WORKERS, device="cuda",
            session=Session(node_count=DIST_WORKERS, retry_policy="TASK",
                            failure_injector=inj, fte_speculative=False,
                            task_retry_attempts=1))
        frags = crashed.create_subplan(sqls["Q3"]).all_fragments()
        last = [f.id for f in frags if f.source_fragments][-1]
        inj.inject(TASK_FAILURE, fragment_id=last, task_index=None,
                   attempt=None, times=10)
        with contextlib.ExitStack() as crash:
            # what a coordinator killed mid-query leaves: no terminal WAL
            # record, the spool root not released
            crash.callback(setattr, query_state.QueryStateLog, "end",
                           query_state.QueryStateLog.end)
            crash.callback(setattr, spool_gc, "release", spool_gc.release)
            query_state.QueryStateLog.end = lambda self, *a, **kw: None
            spool_gc.release = lambda root: 0
            try:
                # a query id of its own: the write-ahead log is per query
                # id, and every runner numbers its queries from dq_1
                crashed.execute(sqls["Q3"], query_id="p21_interrupted")
                raise AssertionError("resilient resume: the query did not "
                                     "fail")
            except AssertionError:
                raise
            except Exception as e:  # the injected interruption
                cause = f"{type(e).__name__}: {e}"
        pending = crashed.pending_fte_recoveries()
        if len(pending) != 1 or not pending[0].committed:
            raise AssertionError(f"resilient resume: pending {pending}")
        pq = pending[0]
        starts = dict(pq.attempt_counts)
        fresh = DistributedQueryRunner(
            cat, worker_count=DIST_WORKERS, device="cuda",
            session=Session(node_count=DIST_WORKERS, retry_policy="TASK"))
        t0 = time.perf_counter()
        rows = fresh.resume_fte_query(pq).rows()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        _same_dist(rows, path_rows["Q3"], sqls["Q3"], "resilient resume",
                   DOUBLE_RTOL)
        final = query_state.load(pq.path)
        rerun = [k for k in pq.committed
                 if final.attempt_counts.get(k, 0) != starts.get(k, 0)]
        if final.ended != "FINISHED" or rerun:
            raise AssertionError(f"resilient resume: {final.ended}, "
                                 f"re-executed {rerun}")
        log(f"resilient resume: Q3 interrupted ({cause[:80]}) after "
            f"{len(pq.committed)} committed attempts; a fresh runner "
            f"resumed it from the write-ahead log in {ms:.1f} ms ({smi}); "
            f"attempt starts per (fragment, task) before "
            f"{dict(sorted(starts.items()))}, after "
            f"{dict(sorted(final.attempt_counts.items()))}: no committed "
            "attempt re-executed; rows equal phase 3's")
        del crashed, fresh
        with _env_scope("TRINO_TPU_FUSED_STAGE", "0")():
            inj = FailureInjector()
            spec = DistributedQueryRunner(
                cat, worker_count=DIST_WORKERS, device="cuda",
                session=Session(node_count=DIST_WORKERS, speculation=True,
                                speculation_min_delay_s=0.5, adaptive="0",
                                use_collectives=False,
                                failure_injector=inj))
            leaf = next(f.id for f in
                        spec.create_subplan(sqls["Q1"]).all_fragments()
                        if not f.source_fragments)
            inj.inject(TASK_STALL, fragment_id=leaf, task_index=0,
                       attempt=0, stall_s=P21_STALL_S)
            ms, res = _timed(torch, spec, sqls["Q1"])
        _same_dist(res.rows(), path_rows["Q1"], sqls["Q1"],
                   "resilient speculation", DOUBLE_RTOL)
        if not spec.speculative_wins or ms >= P21_STALL_S * 1e3:
            raise AssertionError(f"resilient speculation: "
                                 f"{spec.resilience_events}")
        log(f"resilient speculation: Q1 with leaf task f{leaf}.t0 stalled "
            f"{P21_STALL_S:g} s finished in {ms:.1f} ms ({smi}); "
            f"{spec.speculative_starts} twins started, "
            f"{spec.speculative_wins} won; events {spec.resilience_events}; "
            f"rows equal phase 3's; (d) took "
            f"{time.perf_counter() - t_part:.1f} s")
        del spec, dist
    log(f"resilient: {time.perf_counter() - t_phase:.1f} s for phase 21")
    return ft_launches, adaptive_launches, fte


# ---------------------------------------------------------------------------
# phase 22: the control plane and the serving path: the statement server
# over a ProcessDistributedQueryRunner whose tasks run in worker processes
# on the card


SERVE_WORKERS = 2  # the reference's own test shape; keeps boots in budget
SERVE_QUERIES = ("Q1", "Q3", "Q12", "R1")
SERVE_REQUIRED = {"Q3": ("hash_insert",), "Q12": ("hash_probe",),
                  "R1": ("masked_segment_sum_f32",)}
# one slot at the root, two subgroups weighted 3:1; the selector routes a
# statement by the alias of its sum
SERVE_GROUPS = {
    "root": {"name": "global", "hard_concurrency_limit": 1,
             "scheduling_policy": "weighted_fair",
             "subgroups": [{"name": "heavy", "weight": 3},
                           {"name": "light", "weight": 1}]},
    "selectors": [{"sql": "revenue_light", "group": "light"},
                  {"group": "heavy"}]}
SERVE_ADMISSION = ("revenue_heavy_1", "revenue_heavy_2", "revenue_light")
SERVE_CLIENT_S = 300.0  # the client's bound per statement
SERVE_WAIT_S = 120.0  # every other wait of the phase
SERVE_RESTART_ID = "p22_restart"
SERVE_CAPTURE = ("Q3", "Q12", "R1")  # phase 6's "serving" cases


def _fleet_launches(runner) -> dict:
    """worker url -> its kernel launches since boot (``/v1/info``): the
    coordinator's own counts cannot see another process's launches."""
    return {w.url: w.info()["launches"] for w in runner.workers
            if w.alive()}


def _launch_delta(before: dict, after: dict) -> dict:
    out = {k: 0 for k in SOURCES}
    for url, counts in after.items():
        for k, n in counts.items():
            out[k] += n - before.get(url, {}).get(k, 0)
    return out


def _exchange_totals(runner) -> tuple:
    """(pages, bytes) moved over HTTP: the coordinator's fetches of the
    root fragment plus every worker's fetches from its producers."""
    from trino_tpu_torch.execution.remote import _http
    from trino_tpu_torch.telemetry import metrics as tm

    pages, nbytes = tm.EXCHANGE_PAGES.value(), tm.EXCHANGE_BYTES.value()
    for w in runner.workers:
        if not w.alive():
            continue
        with _http("GET", f"{w.url}/v1/metrics?format=json",
                   timeout=10.0) as resp:
            snap = json.loads(resp.read())
        pages += snap["trino_exchange_pages_total"]["value"]
        nbytes += snap["trino_exchange_bytes_total"]["value"]
    return int(pages), int(nbytes)


def _json_rows(rows: list) -> list:
    """Rows as the statement protocol sends them (decimals and dates as
    strings, NaN as "NaN")."""
    from trino_tpu_torch.server.protocol import _json_value

    return [[_json_value(v) for v in r] for r in rows]


def _compute_apps() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({type(e).__name__})"


def _post(base: str, sql: str, qid: str) -> dict:
    import urllib.request

    req = urllib.request.Request(f"{base}/v1/statement", data=sql.encode(),
                                 method="POST",
                                 headers={"X-Trino-Tpu-Query-Id": qid})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.load(resp)


def _reattach(base: str, qid: str) -> tuple:
    """A client that survived the server's restart polls the query's
    first page again and follows nextUri: (state, rows)."""
    import urllib.request

    rows: list = []
    url = f"{base}/v1/statement/{qid}/0"
    deadline = time.monotonic() + SERVE_CLIENT_S
    while True:
        with urllib.request.urlopen(url, timeout=60) as resp:
            payload = json.load(resp)
        rows.extend(payload.get("data", []))
        state = payload["stats"]["state"]
        if not payload.get("nextUri"):
            if state == "FAILED":
                raise AssertionError(f"serving restart: {payload}")
            return state, rows
        if time.monotonic() > deadline:
            raise AssertionError(f"serving restart: still {state}")
        url = base + payload["nextUri"]


def _heal(runner, n: int, spare=None) -> None:
    """Drop dead workers from the fleet and bring it back to ``n``:
    ``spare`` (a worker booted ahead of time) first, then new ones."""
    for w in [w for w in runner.workers if not w.alive()]:
        runner.failure_detector.unmonitor(w.url)
        runner.workers.remove(w)
    while len(runner.workers) < n:
        runner.add_worker(spare)
        spare = None


class _LocalWorker:
    """A worker's TaskServer served on a thread of this process, in the
    slot of a worker process: its tasks run the serving path's code at
    its split, and capture_calls sees their wrapper calls, which it
    cannot see in another process."""

    def __init__(self, device: str):
        import threading

        from trino_tpu_torch.execution.worker import TaskServer

        self.server = TaskServer(0, device)
        self.url = f"http://127.0.0.1:{self.server.port}"
        self.boot_s = 0.0
        self.proc = self  # poll / wait / kill, as the runner calls them
        self.pid = os.getpid()
        self.returncode = None
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def poll(self):
        return self.returncode

    def wait(self, timeout=None):
        return self.returncode

    def alive(self) -> bool:
        return self.returncode is None

    def info(self) -> dict:
        from trino_tpu_torch.execution.remote import _http

        with _http("GET", f"{self.url}/v1/info", timeout=10.0) as resp:
            return json.loads(resp.read())

    def shutdown(self) -> None:
        if self.returncode is None:
            self.returncode = 0
            self.server.httpd.shutdown()
            self.server.httpd.server_close()

    kill = shutdown


def serving_fleet(device: str = "cuda"):
    """Phase 22's runner (two workers, the session of its queries) with
    each worker's TaskServer in this process: phase 6 captures the
    serving path's kernel calls from it."""
    from trino_tpu_torch.execution.remote import ProcessDistributedQueryRunner
    from trino_tpu_torch.runner import Session

    class LocalFleet(ProcessDistributedQueryRunner):
        def _spawn(self):
            return _LocalWorker(str(self.device))

    spec = {"factory": "trino_tpu_torch.connectors.catalog:default_catalog",
            "kwargs": {"scale_factor": PATH_SF}}
    return LocalFleet(spec, worker_count=SERVE_WORKERS, device=device,
                      session=Session(node_count=SERVE_WORKERS))


def same_split(captured: dict, by_query: dict) -> None:
    """Log, per serving query, the wrapper calls captured in the
    in-process fleet beside the worker processes' launches in phase 22
    (a): equal counts mean the same split."""
    for name in SERVE_CAPTURE:
        calls = {k: len(captured.get((f"serving {name}", k), []))
                 for k in SOURCES}
        log(f"serving {name}: wrapper calls in the in-process fleet "
            f"{calls}, launches in the worker processes {by_query[name]} "
            f"({'equal' if calls == by_query[name] else 'differ'})")


def serving(torch, GK, sqls: dict, path_rows: dict, dist_cold: dict,
            smi: str, device: str = "cuda",
            required: dict = SERVE_REQUIRED) -> dict:
    """Phase 22: the control plane and the serving path at SF 1 on the
    tpch connector: a ProcessDistributedQueryRunner with two worker
    processes on ``device`` (the coordinator's; the kernel library is
    built before they boot and only bound by them) behind the statement
    server, driven by the protocol's client.  (a) Q1, Q3, Q12 and R1
    through the client: rows equal phase 3's, each wall beside phase 19's
    cold wall, exchange pages and bytes over HTTP, and the kernel
    launches summed over the workers (``/v1/info``): Q3 must launch
    hash_insert, Q12 hash_probe, R1 the segment sum.  (b) admission: a
    resource-group tree with one slot at the root and two subgroups
    weighted 3:1; three concurrent Q6 statements each pass QUEUED, then
    RUNNING, then FINISHED in the dispatcher's state machine, at least
    two with queued_time_ms above 0; the resource_groups rows.  (c)
    faults: kill -9 of a worker during Q3 under retry_policy=QUERY (the
    worker is replaced, rows equal), PROCESS_EXIT injected into one Q3
    task under retry_policy=TASK (recovered from the spool, rows equal),
    a graceful drain between two queries (exit code 0), and the server
    stopped and restarted while a TASK query is in flight (the restart
    resumes it from the write-ahead log under its original id and the
    client reattaches and gets the rows).  Returns the launches of (a)
    and (b), summed over the workers, (a)'s launches by query, and the
    fresh fleet's first statement (its query, wall, the fleet's boot
    seconds and each worker's warm-key replay), which phase 23 (e)
    compares with a fleet booted without the replay."""
    t_phase = time.perf_counter()
    import signal
    import threading

    from trino_tpu_torch.execution import control, query_state, spool_gc
    from trino_tpu_torch.execution.failure_injector import (
        PROCESS_EXIT, TASK_FAILURE, FailureInjector)
    from trino_tpu_torch.execution.remote import (
        ProcessDistributedQueryRunner, WorkerProcess)
    from trino_tpu_torch.execution.resource_manager import (
        build_dispatch_manager)
    from trino_tpu_torch.runner import Session
    from trino_tpu_torch.server import Client, TrinoTpuServer

    spec = {"factory": "trino_tpu_torch.connectors.catalog:default_catalog",
            "kwargs": {"scale_factor": PATH_SF}}
    base_dir = tempfile.mkdtemp(prefix="chip-smoke-p22-", dir="build")
    launches = {k: 0 for k in SOURCES}
    by_query: dict = {}
    with contextlib.ExitStack() as stack:
        stack.enter_context(_env_scope("TRINO_TPU_SPOOL_DIR",
                                       os.path.join(base_dir, "spool"))())
        stack.enter_context(_env_scope("TRINO_TPU_QUERY_STATE_DIR",
                                       os.path.join(base_dir, "state"))())
        stack.callback(shutil.rmtree, base_dir, True)
        t0 = time.perf_counter()
        runner = ProcessDistributedQueryRunner(
            spec, worker_count=SERVE_WORKERS, device=device,
            session=Session(node_count=SERVE_WORKERS))
        stack.callback(runner.close)
        server = TrinoTpuServer(runner).start()
        stack.callback(server.stop)
        host, port = server.address
        base = f"http://{host}:{port}"
        client = Client(host, port, timeout=SERVE_CLIENT_S)
        infos = [w.info() for w in runner.workers]
        fresh = {"boot_s": time.perf_counter() - t0,
                 "warm": [i["warm"] for i in infos]}
        log(f"serving: {SERVE_WORKERS} worker processes on {device} "
            f"({smi}), up in {fresh['boot_s']:.1f} s; boot s "
            f"{[round(w.boot_s, 2) for w in runner.workers]}; devices "
            f"{[(i['device'], i['device_name']) for i in infos]}; the "
            f"warm-key journal replayed at boot {fresh['warm']}; compute "
            f"apps (pid, memory): {_compute_apps()}")

        # -- (a) the queries through the server ---------------------------
        for name in SERVE_QUERIES:
            sql = sqls[name]
            before = _fleet_launches(runner)
            ex0 = _exchange_totals(runner)
            t0 = time.perf_counter()
            columns, rows = client.execute(sql)
            ms = (time.perf_counter() - t0) * 1e3
            launched = _launch_delta(before, _fleet_launches(runner))
            ex1 = _exchange_totals(runner)
            rtol = REAL_PARITY_RTOL if name in REAL_QUERIES else DOUBLE_RTOL
            worst = _same_dist(rows, _json_rows(path_rows[name]), sql,
                               f"serving {name}", rtol)
            for k in required.get(name, ()):
                if launched[k] <= 0:
                    raise AssertionError(f"serving {name}: the workers "
                                         f"launched no {k}: {launched}")
            for k, n in launched.items():
                launches[k] += n
            by_query[name] = launched
            fresh.setdefault("ms", ms)
            fresh.setdefault("query", name)
            log(f"serving {name}: {len(rows)} rows equal phase 3's "
                f"(largest float rel diff {worst:.3g}); wall {ms:.1f} ms "
                f"through the server and two worker processes, phase 19 "
                f"(in-process, {DIST_WORKERS} tasks, cold) "
                f"{dist_cold.get(name, float('nan')):.1f} ms ({smi}); "
                f"exchange over HTTP {ex1[0] - ex0[0]} pages, "
                f"{ex1[1] - ex0[1]} bytes; worker launches {launched}; "
                f"columns {[c['type'] for c in columns]}")
        log(f"serving: compute apps after (a) (pid, memory): "
            f"{_compute_apps()}; cluster memory view "
            f"{runner.memory_manager.cluster_reserved_bytes()} bytes "
            "reserved")

        # -- (b) admission ------------------------------------------------
        t_part = time.perf_counter()
        states: dict = {}

        class Recording(control.QueryStateMachine):
            def __init__(self, query_id):
                super().__init__(query_id)
                states[query_id] = ["QUEUED"]

            def set(self, new_state):
                ok = super().set(new_state)
                if ok and states[self.query_id][-1] != new_state:
                    states[self.query_id].append(new_state)
                return ok

        with _env_scope("TRINO_TPU_RESOURCE_GROUPS",
                        json.dumps(SERVE_GROUPS))():
            runner.dispatcher = build_dispatch_manager(runner.session)
        orig_fsm = control.QueryStateMachine
        control.QueryStateMachine = Recording
        results: dict = {}
        before = _fleet_launches(runner)
        try:
            def go(alias):
                c = Client(host, port, timeout=SERVE_CLIENT_S)
                results[alias] = c.execute(
                    sqls["Q6"].replace("as revenue", f"as {alias}"))

            threads = [threading.Thread(target=go, args=(a,), daemon=True)
                       for a in SERVE_ADMISSION]
            for th in threads:
                th.start()
            for th in threads:
                th.join(SERVE_CLIENT_S)
        finally:
            control.QueryStateMachine = orig_fsm
        for k, n in _launch_delta(before, _fleet_launches(runner)).items():
            launches[k] += n
        if sorted(results) != sorted(SERVE_ADMISSION):
            raise AssertionError(f"serving admission: {sorted(results)}")
        for alias, (_cols, rows) in results.items():
            _same_dist(rows, _json_rows(path_rows["Q6"]), sqls["Q6"],
                       f"serving admission {alias}", DOUBLE_RTOL)
        infos = {i.sql: i for i in runner.dispatcher.queries()}
        order = ("QUEUED", "RUNNING", "FINISHED")
        seqs = {}
        for alias in SERVE_ADMISSION:
            info = next(i for s, i in infos.items() if alias in s)
            seq = states[info.query_id]
            if [s for s in seq if s in order] != list(order):
                raise AssertionError(f"serving admission {alias}: {seq}")
            seqs[alias] = (info.resource_group, seq)
        _cols, qrows = client.execute(
            "select query_id, queued_time_ms, resource_group, sql "
            "from system.runtime.queries")
        # the statements' own records (the dispatcher's state machines
        # show up there too, under their q_N ids, with no queue time)
        fsm_ids = {i.query_id for i in infos.values()}
        queued = {a: r[1] for r in qrows for a in SERVE_ADMISSION
                  if a in r[3] and r[0] not in fsm_ids}
        if len(queued) != len(SERVE_ADMISSION) or \
                sum(1 for v in queued.values() if v > 0) < 2:
            raise AssertionError(f"serving admission: queued ms {queued}")
        _cols, grows = client.execute(
            "select * from system.runtime.resource_groups")
        runner.dispatcher = build_dispatch_manager(runner.session)
        log(f"serving admission: three concurrent Q6 under one slot, "
            f"weighted 3:1 ({smi}): rows equal phase 3's; groups and "
            f"state sequences {seqs}; queued_time_ms {queued}; "
            f"resource_groups {grows}; (b) took "
            f"{time.perf_counter() - t_part:.1f} s")

        # -- (c) faults ---------------------------------------------------
        t_part = time.perf_counter()
        # the drain needs two workers after PROCESS_EXIT took one: a spare
        # boots meanwhile, so the drill waits for no boot
        spare: dict = {}
        booting = threading.Thread(
            target=lambda: spare.setdefault("w", WorkerProcess(device=device)),
            daemon=True)
        booting.start()

        def kill_spare():
            booting.join(SERVE_WAIT_S)
            if "w" in spare:
                spare.pop("w").kill()

        stack.callback(kill_spare)
        sql = sqls["Q3"]
        want = _json_rows(path_rows["Q3"])
        # kill -9 of a worker mid-query under retry_policy=QUERY
        runner.session = Session(node_count=SERVE_WORKERS,
                                 retry_policy="QUERY",
                                 retry_initial_delay_s=0.05,
                                 properties={"heartbeat_interval_s": 0.2})
        victim = runner.workers[-1]
        tasks0 = victim.info()["tasks"]
        retries0 = runner.resilience.query_retries
        replaced0 = runner.resilience.worker_replacements
        out: dict = {}
        th = threading.Thread(
            target=lambda: out.setdefault("rows", client.execute(sql)[1]),
            daemon=True)
        t0 = time.perf_counter()
        th.start()
        deadline = time.monotonic() + SERVE_WAIT_S
        while victim.info()["tasks"] == tasks0:
            if time.monotonic() > deadline or not th.is_alive():
                raise AssertionError("serving kill -9: Q3 placed no task "
                                     "on the victim")
            time.sleep(0.02)
        os.kill(victim.proc.pid, signal.SIGKILL)
        th.join(SERVE_CLIENT_S)
        ms = (time.perf_counter() - t0) * 1e3
        if "rows" not in out:
            raise AssertionError("serving kill -9: Q3 did not finish")
        _same_dist(out["rows"], want, sql, "serving kill -9", DOUBLE_RTOL)
        if runner.resilience.query_retries <= retries0 or \
                runner.resilience.worker_replacements != replaced0 + 1 \
                or victim.alive():
            raise AssertionError(f"serving kill -9: {runner.resilience}; "
                                 f"{runner.resilience_events[-6:]}")
        log(f"serving kill -9: worker {victim.url} (pid {victim.proc.pid}) "
            f"killed during Q3 under retry_policy=QUERY; replaced and "
            f"re-run in {ms:.1f} ms ({smi}); rows equal phase 3's; events "
            f"{runner.resilience_events[-4:]}")
        # PROCESS_EXIT into one Q3 task under retry_policy=TASK
        inj = FailureInjector()
        runner.session = Session(node_count=SERVE_WORKERS,
                                 retry_policy="TASK", failure_injector=inj)
        leaf = runner.create_subplan(sql).all_fragments()[0]
        inj.inject(PROCESS_EXIT, fragment_id=leaf.id, task_index=0,
                   attempt=0)
        t0 = time.perf_counter()
        _cols, rows = client.execute(sql)
        ms = (time.perf_counter() - t0) * 1e3
        _same_dist(rows, want, sql, "serving PROCESS_EXIT", DOUBLE_RTOL)
        alive = sum(w.alive() for w in runner.workers)
        if alive != SERVE_WORKERS - 1:
            raise AssertionError(f"serving PROCESS_EXIT: {alive} workers "
                                 "alive; the injected exit killed none")
        log(f"serving PROCESS_EXIT: leaf task f{leaf.id}.t0's worker "
            f"exited (17) under retry_policy=TASK; fault-tolerant "
            f"execution recovered from the spool in {ms:.1f} ms ({smi}); "
            "rows equal phase 3's")
        booting.join(SERVE_WAIT_S)
        if "w" not in spare:
            raise AssertionError("serving: the spare worker did not boot")
        _heal(runner, SERVE_WORKERS, spare.pop("w"))
        # a graceful drain between two queries
        runner.session = Session(node_count=SERVE_WORKERS)
        _cols, first = client.execute(sqls["Q6"])
        drained = runner.workers[-1]
        summary = runner.drain_worker(drained, timeout_s=60, replace=False)
        _cols, second = client.execute(sqls["Q6"])
        for rows in (first, second):
            _same_dist(rows, _json_rows(path_rows["Q6"]), sqls["Q6"],
                       "serving drain", DOUBLE_RTOL)
        if summary["exit_code"] != 0 or summary["escalated"]:
            raise AssertionError(f"serving drain: {summary}")
        log(f"serving drain: {summary['worker']} drained between two Q6, "
            f"exit code {summary['exit_code']}; the second ran on the "
            "remaining worker; rows equal phase 3's")
        # the server stopped and restarted while a TASK query is in flight
        inj = FailureInjector()
        runner.session = Session(node_count=SERVE_WORKERS,
                                 retry_policy="TASK", failure_injector=inj,
                                 fte_speculative=False,
                                 task_retry_attempts=1)
        last = [f.id for f in runner.create_subplan(sql).all_fragments()
                if f.source_fragments][-1]
        inj.inject(TASK_FAILURE, fragment_id=last, task_index=None,
                   attempt=None, times=10)
        with contextlib.ExitStack() as crash:
            # what a stopped coordinator leaves: no terminal WAL record,
            # the spool root not released
            crash.callback(setattr, query_state.QueryStateLog, "end",
                           query_state.QueryStateLog.end)
            crash.callback(setattr, spool_gc, "release", spool_gc.release)
            query_state.QueryStateLog.end = lambda self, *a, **kw: None
            spool_gc.release = lambda root: 0
            payload = _post(base, sql, SERVE_RESTART_ID)
            deadline = time.monotonic() + SERVE_WAIT_S
            while not any(pq.query_id == SERVE_RESTART_ID and pq.committed
                          for pq in query_state.pending()):
                if time.monotonic() > deadline:
                    raise AssertionError("serving restart: no commit")
                time.sleep(0.02)
            server.stop()
            q = server.dispatcher.get(SERVE_RESTART_ID)
            if not q.done.wait(SERVE_CLIENT_S):
                raise AssertionError("serving restart: the first run hung")
        pending = [pq for pq in query_state.pending()
                   if pq.query_id == SERVE_RESTART_ID]
        if len(pending) != 1:
            raise AssertionError(f"serving restart: pending {pending}")
        starts = dict(pending[0].attempt_counts)
        committed = dict(pending[0].committed)
        runner.session = Session(node_count=SERVE_WORKERS,
                                 retry_policy="TASK")
        t0 = time.perf_counter()
        server = TrinoTpuServer(runner, port=port).start()
        stack.callback(server.stop)
        if server.dispatcher.recovered_query_ids != [SERVE_RESTART_ID]:
            raise AssertionError(f"serving restart: recovered "
                                 f"{server.dispatcher.recovered_query_ids}")
        state, rows = _reattach(base, SERVE_RESTART_ID)
        ms = (time.perf_counter() - t0) * 1e3
        _same_dist(rows, want, sql, "serving restart", DOUBLE_RTOL)
        final = query_state.load(pending[0].path)
        rerun = [k for k in committed
                 if final.attempt_counts.get(k, 0) != starts.get(k, 0)]
        if state != "FINISHED" or final.ended != "FINISHED" or rerun:
            raise AssertionError(f"serving restart: {state}, "
                                 f"{final.ended}, re-executed {rerun}")
        log(f"serving restart: server stopped with Q3 in flight "
            f"({payload['stats']['state']} at post; the first run ended "
            f"{q.state} with {len(committed)} committed attempts); the "
            f"restarted server resumed {SERVE_RESTART_ID} from the "
            f"write-ahead log and the client reattached and got the rows "
            f"in {ms:.1f} ms ({smi}); no committed attempt re-executed; "
            f"(c) took {time.perf_counter() - t_part:.1f} s")
    log(f"serving launches (workers, (a) and (b)): {launches}")
    log(f"serving: {time.perf_counter() - t_phase:.1f} s for phase 22")
    return launches, by_query, fresh


CHAOS_SF = PATH_SF
CHAOS_ORACLE_WAIT_S = 300.0  # phase 23's wait for the background oracle
_ORACLE_CHILD = """
import json, sys, time
import torch
torch.set_num_threads(1)
from trino_tpu_torch.testing.chaos import build_expected
t0 = time.perf_counter()
expected = build_expected(float(sys.argv[1]))
with open(sys.argv[2] + ".tmp", "w", encoding="utf-8") as f:
    json.dump({"seconds": time.perf_counter() - t0,
               "expected": [[sql, rows] for sql, rows in expected.items()]},
              f)
import os
os.replace(sys.argv[2] + ".tmp", sys.argv[2])
"""


class BackgroundOracle:
    """Phase 23's expected rows: the port's sqlite oracle of the chaos mix
    at CHAOS_SF, computed in a subprocess on the host while the earlier
    phases run (its load took 73.3 s of host time at SF 1 in one chip
    run, too dear to wait for inside phase 23).  The subprocess touches
    no card."""

    def __init__(self, sf: float):
        os.makedirs("build", exist_ok=True)
        fd, self.path = tempfile.mkstemp(prefix="chip-smoke-oracle-",
                                         suffix=".json", dir="build")
        os.close(fd)
        os.remove(self.path)
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _ORACLE_CHILD, str(sf), self.path],
            env=dict(os.environ, OMP_NUM_THREADS="1"))

    def result(self) -> tuple:
        """(expected rows by SQL, the oracle's seconds, the seconds phase
        23 waited for it)."""
        t0 = time.perf_counter()
        rc = self.proc.wait(timeout=CHAOS_ORACLE_WAIT_S)
        waited = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"the background oracle failed (rc={rc})")
        with open(self.path, encoding="utf-8") as f:
            doc = json.load(f)
        return ({sql: [tuple(r) for r in rows]
                 for sql, rows in doc["expected"]}, doc["seconds"], waited)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        for p in (self.path, self.path + ".tmp"):
            if os.path.exists(p):
                os.remove(p)


CHAOS_SEEDS = (("inproc", 1010), ("process", 1009))  # both run the join
CHAOS_QUERIES = 5
CHAOS_FTE_SEED = 1516  # its six queries run the join three times
CHAOS_FTE_QUERIES = 6
CHAOS_DRILL = 4  # QUERY_MIX[4], the join: its build is a hash_insert
CHAOS_REQUIRED = ("hash_insert",)
CHAOS_PLUGIN_SQL = ("select l_orderkey, count(*) n, sum(l_quantity) q "
                    "from {t} group by l_orderkey order by q desc, "
                    "l_orderkey limit 10")
CHAOS_PLUGIN_SRC = """
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.plugin import Plugin


class ChipPlugin(Plugin):
    def get_connector_factories(self):
        return {"chip_memory": lambda config: MemoryConnector()}


def plugin():
    return ChipPlugin()
"""
CHAOS_WARM_QUERY = "Q1"


def _chaos_rows(rows: list) -> list:
    """Rows as comparable cells: numbers rounded to cents (the server's
    JSON sends decimals as text, sqlite gives floats), the rest as text."""
    out = []
    for row in rows:
        cells = []
        for v in row:
            try:
                cells.append(round(float(v), 2))
            except (TypeError, ValueError):
                cells.append(str(v))
        out.append(tuple(cells))
    return sorted(out, key=str)


def _chaos_record(rec: dict, what: str, n: int, required) -> str:
    """Fail unless every query is accounted (no hang, nothing unexpected)
    and the required kernels launched; returns the outcomes as a line."""
    counts = rec["counts"]
    if len(rec["outcomes"]) != n or counts.get("hang", 0) or \
            counts.get("unexpected", 0):
        raise AssertionError(f"{what}: {counts}: {rec['outcomes']}")
    for k in required:
        if rec["launches"].get(k, 0) <= 0:
            raise AssertionError(f"{what}: no {k} launched: "
                                 f"{rec['launches']}")
    return "; ".join(
        f"q{o['query']} mix{_mix_index(o['sql'])} {o['fault']}"
        f"(t{o['task_index']}) -> {o['outcome']} {o['wall_s'] * 1e3:.1f} ms"
        for o in rec["outcomes"])


def _mix_index(sql: str) -> str:
    from trino_tpu_torch.testing.chaos import QUERY_MIX

    return str(QUERY_MIX.index(sql)) if sql in QUERY_MIX else "-user-error"


def chaos(torch, GK, sqls: dict, path_rows: dict, smi: str, served: dict,
          expected=None, device: str = "cuda",
          required=CHAOS_REQUIRED) -> dict:
    """Phase 23: the chaos harness (trino_tpu_torch/testing/chaos.py), a
    plugin-loaded catalog and the warm-key journal at SF 1 on the tpch
    path.  The expected rows of the mix come from the port's sqlite oracle
    over the mix's columns (``expected``: a BackgroundOracle's result,
    else computed here; its load is timed).  (a) one in-process and
    one process scenario (two workers each, five seeded queries with
    seeded faults and drains); (b) one FTE scenario (six queries, task
    retries and spool corruption); (c) the coordinator kill -9 drill over
    the mix's join: a coordinator subprocess killed with a committed
    attempt, a fresh one booted against the same state and spool
    directories resumes the query under its id, and no committed attempt
    re-executes; (d) CTAS into a table of a plugin-loaded memory catalog
    (its pages on the card) and a group-by over it, rows equal the same
    query over the tpch table; (e) a fresh two-worker fleet booted with
    TRINO_TPU_EXEC_WARM=0: its first statement's wall through the
    statement server beside ``served``, phase 22's fresh fleet, which
    replayed the journal at boot (keys read, warmed, skipped, ms a
    worker).  Zero hangs and zero unexpected
    outcomes; hash_insert launched in (a) in-process, (a) process (the
    workers' /v1/info), (b) and (c) (the drill's coordinator processes).
    Returns the launches of (a)-(c)."""
    t_phase = time.perf_counter()
    from trino_tpu_torch.caching import executable_cache
    from trino_tpu_torch.connectors.catalog import default_catalog
    from trino_tpu_torch.execution.remote import ProcessDistributedQueryRunner
    from trino_tpu_torch.plugin import PluginManager
    from trino_tpu_torch.runner import Session, StandaloneQueryRunner
    from trino_tpu_torch.server import Client, TrinoTpuServer
    from trino_tpu_torch.testing import chaos as C

    base_dir = tempfile.mkdtemp(prefix="chip-smoke-p23-", dir="build")
    launches = {k: 0 for k in SOURCES}

    def add(counts: dict) -> None:
        for k, n in counts.items():
            launches[k] += n

    with contextlib.ExitStack() as stack:
        stack.enter_context(_env_scope("TRINO_TPU_SPOOL_DIR",
                                       os.path.join(base_dir, "spool"))())
        stack.enter_context(_env_scope("TRINO_TPU_QUERY_STATE_DIR",
                                       os.path.join(base_dir, "state"))())
        stack.callback(shutil.rmtree, base_dir, True)
        if expected is None:
            t0 = time.perf_counter()
            expected = (C.build_expected(CHAOS_SF),
                        time.perf_counter() - t0, 0.0)
        expected, oracle_s, waited = expected
        log(f"chaos: the sqlite oracle of the mix at SF {CHAOS_SF:g} "
            f"(customer, orders, lineitem; the mix's columns): "
            f"{oracle_s:.1f} s on the host, in a subprocess beside the "
            f"earlier phases; phase 23 waited {waited:.1f} s for it")

        # -- (a) one in-process and one process scenario ------------------
        for mode, seed in CHAOS_SEEDS:
            t0 = time.perf_counter()
            rec = C.run_scenario(seed, mode=mode, n_queries=CHAOS_QUERIES,
                                 expected=expected, device=device,
                                 scale_factor=CHAOS_SF)
            line = _chaos_record(rec, f"chaos {mode}", CHAOS_QUERIES,
                                 required)
            add(rec["launches"])
            log(f"chaos {mode} seed {seed} ({smi}): {rec['counts']}, "
                f"launches {rec['launches']}"
                f"{' (workers /v1/info)' if mode == 'process' else ''}, "
                f"speculative wins {rec['speculative_wins']}; {line}; "
                f"{time.perf_counter() - t0:.1f} s with the runner's "
                "set-up")

        # -- (b) fault-tolerant execution under the FTE menu --------------
        t0 = time.perf_counter()
        rec = C.run_fte_scenario(CHAOS_FTE_SEED, CHAOS_FTE_QUERIES,
                                 expected=expected, device=device,
                                 scale_factor=CHAOS_SF)
        line = _chaos_record(rec, "chaos fte", CHAOS_FTE_QUERIES, required)
        add(rec["launches"])
        repairs = sum(o["spool_corruption_repairs"] for o in rec["outcomes"])
        log(f"chaos fte seed {CHAOS_FTE_SEED} ({smi}): {rec['counts']}, "
            f"launches {rec['launches']}, spool corruptions repaired "
            f"{repairs}; {line}; {time.perf_counter() - t0:.1f} s")

        # -- (c) kill -9 of a coordinator mid-query, and its restart ------
        t0 = time.perf_counter()
        sql = C.QUERY_MIX[CHAOS_DRILL]
        rec = C.run_coordinator_kill_drill(
            workdir=os.path.join(base_dir, "drill"), device=device,
            scale_factor=CHAOS_SF, sql=sql)
        drill = {k: rec["launches_epoch1"].get(k, 0)
                 + rec["launches_epoch2"].get(k, 0) for k in SOURCES}
        if not rec["pass"] or rec["committed_reexecuted"] or \
                rec["state"] != "FINISHED":
            raise AssertionError(f"chaos drill: {rec}")
        if _chaos_rows(rec["rows"]) != _chaos_rows(expected[sql]):
            raise AssertionError(f"chaos drill rows {rec['rows']} != "
                                 f"{expected[sql]}")
        for k in required:
            if drill[k] <= 0:
                raise AssertionError(f"chaos drill: no {k} launched in "
                                     f"the coordinators: {drill}")
        add(drill)
        log(f"chaos drill ({smi}): coordinator booted in "
            f"{rec['boot1_s']:.1f} s, first commit {rec['first_commit_s']} s "
            f"after the POST, {rec['committed_at_kill']} committed "
            f"attempt(s) at the kill -9; fresh coordinator booted in "
            f"{rec['boot2_s']:.1f} s, resumed {rec['query_id']} and "
            f"finished in {rec['resume_s']} s; resumed attempt starts "
            f"{rec['resumed_attempt_starts']}; committed re-executed "
            f"{rec['committed_reexecuted']}; spool reclaimed "
            f"{rec['spool_reclaimed']}; rows equal the oracle's; "
            f"launches epoch 1 {rec['launches_epoch1']}, epoch 2 "
            f"{rec['launches_epoch2']}; {time.perf_counter() - t0:.1f} s")

        # -- (d) a plugin-loaded catalog ---------------------------------
        t0 = time.perf_counter()
        path = os.path.join(base_dir, "chip_plugin.py")
        with open(path, "w", encoding="utf-8") as f:
            f.write(CHAOS_PLUGIN_SRC)
        cat = default_catalog(CHAOS_SF)
        pm = PluginManager(cat)
        pm.load(path)
        conn = pm.create_catalog("plugged", "chip_memory")
        runner = StandaloneQueryRunner(cat, device=device, session=Session(
            default_catalog="plugged"))
        runner.execute("create table li23 as select l_orderkey, l_quantity "
                       "from tpch.lineitem")
        ctas_ms = (time.perf_counter() - t0) * 1e3
        devices = {c.device.type for b in conn._data["li23"]
                   for c in b.columns}
        if devices != {torch.device(device).type}:
            raise AssertionError(f"chaos plugin: pages on {devices}")
        before = dict(GK.LAUNCHES)
        ms, res = _timed(torch, runner, CHAOS_PLUGIN_SQL.format(t="li23"))
        plugged = {k: GK.LAUNCHES[k] - before[k] for k in SOURCES}
        want = runner.execute(CHAOS_PLUGIN_SQL.format(t="tpch.lineitem"))
        same_rows(res.rows(), want.rows(), "chaos plugin", DOUBLE_RTOL)
        for k in required:
            if plugged[k] <= 0:
                raise AssertionError(f"chaos plugin: no {k}: {plugged}")
        log(f"chaos plugin ({smi}): {pm.loaded} loaded, catalog 'plugged' "
            f"from its factory; CTAS of lineitem's l_orderkey, l_quantity "
            f"({sum(b.num_rows for b in conn._data['li23'])} rows, pages on "
            f"{sorted(devices)}) {ctas_ms:.1f} ms; the group-by over it "
            f"{ms:.1f} ms, launches {plugged}; rows equal the same query "
            "over tpch.lineitem")
        runner.execute("drop table li23")
        del runner, cat, pm, conn, res, want

        # -- (e) the warm-key journal: a fresh fleet without its replay -----
        with open(executable_cache.warm_file_path(), encoding="utf-8") as f:
            journal = json.load(f)["keys"]
        names: dict = {}
        for name, _key in journal:
            names[name] = names.get(name, 0) + 1
        log(f"chaos warm journal: {executable_cache.warm_file_path()} holds "
            f"{len(journal)} keys by memo {names}")
        query = served["query"]
        t0 = time.perf_counter()
        fleet = ProcessDistributedQueryRunner(
            C.catalog_spec(CHAOS_SF), worker_count=SERVE_WORKERS,
            device=device, session=Session(node_count=SERVE_WORKERS),
            env_overrides={"TRINO_TPU_EXEC_WARM": "0"})
        try:
            boot_s = time.perf_counter() - t0
            server = TrinoTpuServer(fleet).start()
            try:
                host, port = server.address
                warm = [w.info()["warm"] for w in fleet.workers]
                t1 = time.perf_counter()
                _cols, rows = Client(host, port, timeout=SERVE_CLIENT_S
                                     ).execute(sqls[query])
                ms = (time.perf_counter() - t1) * 1e3
            finally:
                server.stop()
        finally:
            fleet.close()
        _same_dist(rows, _json_rows(path_rows[query]), sqls[query],
                   "chaos warm off", DOUBLE_RTOL)
        if any(w["read"] for w in warm) or not all(
                w["read"] and w["warmed"] + w["skipped"] == w["read"]
                for w in served["warm"]):
            raise AssertionError(f"chaos warm: replay off {warm}, phase "
                                 f"22's {served['warm']}")
        log(f"chaos warm ({smi}): a fresh two-worker fleet with "
            f"TRINO_TPU_EXEC_WARM=0, up in {boot_s:.1f} s (replay {warm}): "
            f"first statement ({query}) through the server {ms:.1f} ms, "
            f"rows equal phase 3's; phase 22's fresh fleet, which replayed "
            f"the journal at boot ({served['warm']}), up in "
            f"{served['boot_s']:.1f} s: first statement {served['ms']:.1f} "
            "ms")
    log(f"chaos launches ((a)-(c)): {launches}")
    log(f"chaos: {time.perf_counter() - t_phase:.1f} s for phase 23")
    return launches


HA_FLEET = ("coord-a", "coord-b")  # tests/test_ha.py's fleet fixture
HA_TIER_QUERIES = ("Q3", "Q12", "R1")
HA_REQUIRED = {"drill": ("hash_insert",), "Q3": ("hash_insert",),
               "Q12": ("hash_probe",), "R1": ("masked_segment_sum_f32",),
               "autoscaled": ("hash_insert",)}
HA_AUTOSCALE_QUERY = "Q3"
HA_IDLE_ROUNDS = 2  # pressure-free rounds before the autoscaler drains
HA_WAIT_S = 120.0  # every wait of the phase


def _tier_statement(tier, sql: str) -> tuple:
    """POST ``sql`` through the front tier and follow nextUri through it:
    (query id, final state, rows)."""
    import urllib.request

    host, port = tier.address
    req = urllib.request.Request(f"http://{host}:{port}/v1/statement",
                                 data=sql.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=SERVE_CLIENT_S) as resp:
        out = json.load(resp)
    qid, rows = out["id"], list(out.get("data", []))
    deadline = time.monotonic() + SERVE_CLIENT_S
    while True:
        state, nxt = out["stats"]["state"], out.get("nextUri")
        if state == "FAILED" or (state == "FINISHED" and not nxt):
            return qid, state, rows
        if time.monotonic() > deadline:
            raise AssertionError(f"ha tier {qid}: still {state}")
        if state != "FINISHED":
            time.sleep(0.05)
        with urllib.request.urlopen(f"http://{host}:{port}{nxt}",
                                    timeout=SERVE_CLIENT_S) as resp:
            out = json.load(resp)
        rows += out.get("data", [])


def ha(torch, GK, sqls: dict, path_rows: dict, smi: str, expected: dict,
       device: str = "cuda", required: dict = HA_REQUIRED) -> dict:
    """Phase 24: the HA coordinator fleet at SF 1 (execution/ha.py,
    server/front_tier.py).  (a) the takeover drill
    (``chaos.run_ha_takeover_drill``) over the mix's join: coordinators A
    and B, each a process with its own CUDA context, lease and watcher;
    A is killed -9 with a committed attempt, B claims A's expired lease,
    takes custody of its WAL directory and finishes the query under its
    id: no committed attempt re-executed, nothing claimed before the
    kill, rows equal the sqlite oracle's (``expected``, phase 23's), and B
    launches hash_insert after the kill.  (b) the front tier: two
    statement servers over one DistributedQueryRunner on ``device``, each
    with a lease in a fleet directory (tests/test_ha.py's fleet), on the
    per-operator path of phase 19; Q3, Q12 and R1 POSTed through a
    FrontTier land on their rendezvous owners with phase 3's rows (as
    phase 19's) and launch hash_insert, hash_probe and the segment sum; a
    query one owner disowns is rerouted (``trino_ha_reroutes_total``
    moves); ``system.runtime.coordinators`` lists both.  (c) the worker
    autoscaler over a ProcessDistributedQueryRunner of one worker
    process: one round of queue pressure grows it to two, Q3 launches
    hash_insert in the new worker (``/v1/info``), and after
    HA_IDLE_ROUNDS rounds without pressure it drains back to one while a
    Q3 is in flight, which still returns phase 3's rows.  Returns the
    launches of (a)-(c): the drill's coordinators, this process, the
    workers."""
    t_phase = time.perf_counter()
    import threading
    import urllib.request

    from trino_tpu_torch.connectors.catalog import default_catalog
    from trino_tpu_torch.execution import ha as HA
    from trino_tpu_torch.execution.distributed_runner import (
        DistributedQueryRunner)
    from trino_tpu_torch.execution.remote import ProcessDistributedQueryRunner
    from trino_tpu_torch.runner import Session
    from trino_tpu_torch.server import Client, TrinoTpuServer
    from trino_tpu_torch.server.front_tier import FrontTier
    from trino_tpu_torch.telemetry import metrics as tm
    from trino_tpu_torch.testing import chaos as C

    base_dir = tempfile.mkdtemp(prefix="chip-smoke-p24-", dir="build")
    launches = {k: 0 for k in SOURCES}

    def add(counts: dict) -> None:
        for k, n in counts.items():
            launches[k] += n

    def need(what: str, counts: dict, kernels) -> None:
        for k in kernels:
            if counts.get(k, 0) <= 0:
                raise AssertionError(f"ha {what}: no {k} launched: {counts}")

    with contextlib.ExitStack() as stack:
        stack.enter_context(_env_scope("TRINO_TPU_SPOOL_DIR",
                                       os.path.join(base_dir, "spool"))())
        stack.enter_context(_env_scope("TRINO_TPU_QUERY_STATE_DIR",
                                       os.path.join(base_dir, "state"))())
        stack.callback(shutil.rmtree, base_dir, True)

        # -- (a) kill -9 of one fleet member, a peer's takeover ------------
        t0 = time.perf_counter()
        sql = C.QUERY_MIX[CHAOS_DRILL]
        rec = C.run_ha_takeover_drill(
            workdir=os.path.join(base_dir, "drill"), device=device,
            scale_factor=CHAOS_SF, sql=sql, boot_timeout_s=HA_WAIT_S * 2,
            finish_timeout_s=HA_WAIT_S * 2)
        if not (rec["pass"] and rec["committed_at_kill"] >= 1
                and rec["committed_reexecuted"] == {}
                and rec["claimed_dirs"] and rec["wal_ended"] == "FINISHED"
                and rec["lease_a_gone"] and not rec["claimed_before_kill"]):
            raise AssertionError(f"ha drill: {rec}")
        if _chaos_rows(rec["rows"]) != _chaos_rows(expected[sql]):
            raise AssertionError(f"ha drill rows {rec['rows']} != "
                                 f"{expected[sql]}")
        need("drill (coordinator B after the kill)",
             rec["launches_b_after_kill"], required.get("drill", ()))
        add(rec["launches_a"])
        add(rec["launches_b"])
        log(f"ha drill ({smi}): coordinators A and B booted at once, up in "
            f"{rec['boot_a_s']:.1f} s and {rec['boot_b_s']:.1f} s; first "
            f"commit on A {rec['first_commit_s']} s after the POST, "
            f"{rec['committed_at_kill']} committed attempt(s) at the kill "
            f"-9; nothing claimed before it ({rec['claimed_before_kill']}); "
            f"A's longest gap between lease writes "
            f"{rec['lease_a_max_gap_s']:.3f} s, its lease "
            f"{rec['lease_a_age_at_kill_s']:.3f} s old at the kill (TTL "
            f"{rec['lease_ttl_s']} s, heartbeat {rec['heartbeat_s']} s); "
            f"B took over "
            f"{rec['takeovers_b']} and finished {rec['query_id']} "
            f"{rec['takeover_s']} s after the kill; claimed "
            f"{rec['claimed_dirs']}; committed re-executed "
            f"{rec['committed_reexecuted']}; rows equal the oracle's; "
            f"launches A {rec['launches_a']}, B {rec['launches_b']} (after "
            f"the kill {rec['launches_b_after_kill']}); "
            f"{time.perf_counter() - t0:.1f} s")

        # -- (b) the front tier over a two-coordinator fleet ---------------
        t0 = time.perf_counter()
        root = os.path.join(base_dir, "fleet")
        with _compiled_off(), contextlib.ExitStack() as members:
            runner = DistributedQueryRunner(
                default_catalog(PATH_SF), worker_count=SERVE_WORKERS,
                session=Session(node_count=SERVE_WORKERS), device=device)
            servers = {}
            for nid in HA_FLEET:
                srv = TrinoTpuServer(runner).start()
                members.callback(srv.stop)
                host, port = srv.address
                lease = HA.CoordinatorLease(
                    nid, url=f"http://{host}:{port}", root=root, ttl=30.0,
                    interval=60.0).register()
                members.callback(lease.release)
                servers[nid] = srv
            tier = FrontTier(root=root, ttl=30.0, retry_s=2.0).start()
            members.callback(tier.stop)
            for name in HA_TIER_QUERIES:
                before = dict(GK.LAUNCHES)
                t1 = time.perf_counter()
                qid, state, rows = _tier_statement(tier, sqls[name])
                ms = (time.perf_counter() - t1) * 1e3
                counts = {k: GK.LAUNCHES[k] - before[k] for k in SOURCES}
                owner = HA.owner_of(qid, list(HA_FLEET))
                landed = [n for n, s in servers.items()
                          if s.dispatcher.get(qid) is not None]
                if state != "FINISHED" or landed != [owner]:
                    raise AssertionError(f"ha tier {name}: {state}, owner "
                                         f"{owner}, landed on {landed}")
                rtol = (REAL_PARITY_RTOL if name in REAL_QUERIES
                        else DOUBLE_RTOL)
                worst = _same_dist(rows, _json_rows(path_rows[name]),
                                   sqls[name], f"ha tier {name}", rtol)
                need(f"tier {name}", counts, required.get(name, ()))
                add(counts)
                log(f"ha tier {name} ({smi}): query {qid} landed on its "
                    f"owner {owner}; {len(rows)} rows equal phase 3's "
                    f"(largest float rel diff {worst:.3g}); {ms:.1f} ms "
                    f"through the tier; launches {counts}")
            for probe in range(1000):  # a qid whose hash owner is coord-b
                qid = f"p24reroute{probe:04d}"
                if HA.owner_of(qid, list(HA_FLEET)) == HA_FLEET[1]:
                    break
            q = servers[HA_FLEET[0]].dispatcher.submit(
                "select count(*) from region", qid=qid)
            if not q.done.wait(HA_WAIT_S):
                raise AssertionError("ha reroute: the query never finished")
            reroutes = tm.HA_REROUTES.value()
            host, port = tier.address
            with urllib.request.urlopen(
                    f"http://{host}:{port}/v1/statement/{qid}/0",
                    timeout=SERVE_CLIENT_S) as resp:
                out = json.load(resp)
            moved = tm.HA_REROUTES.value() - reroutes
            if out["stats"]["state"] != "FINISHED" or \
                    out.get("data") != [[5]] or moved != 1:
                raise AssertionError(f"ha reroute: {out}, reroutes {moved}")
            with _env_scope("TRINO_TPU_HA", "1")(), \
                    _env_scope("TRINO_TPU_HA_DIR", root)(), \
                    _env_scope("TRINO_TPU_HA_LEASE_TTL_S", "30")():
                coords = runner.execute(
                    "select coordinator, state, url from "
                    "system.runtime.coordinators order by coordinator"
                ).rows()
            urls = {n: "http://%s:%d" % s.address for n, s in servers.items()}
            if coords != [(n, "ACTIVE", urls[n]) for n in HA_FLEET]:
                raise AssertionError(f"ha coordinators table: {coords}")
        log(f"ha tier: a query on {HA_FLEET[0]} whose hash owner is "
            f"{HA_FLEET[1]} rerouted ({moved} reroute); "
            f"system.runtime.coordinators {coords}; "
            f"{time.perf_counter() - t0:.1f} s for (b)")
        del runner, servers

        # -- (c) the worker autoscaler over worker processes ---------------
        t0 = time.perf_counter()
        name = HA_AUTOSCALE_QUERY
        fleet = ProcessDistributedQueryRunner(
            C.catalog_spec(CHAOS_SF), worker_count=1, device=device,
            session=Session(node_count=1, retry_policy="QUERY"))
        stack.callback(fleet.close)
        boot_s = [round(w.boot_s, 2) for w in fleet.workers]
        server = TrinoTpuServer(fleet).start()
        stack.callback(server.stop)
        host, port = server.address
        scaler = HA.WorkerAutoscaler(fleet, min_workers=1, max_workers=2,
                                     idle_rounds=HA_IDLE_ROUNDS,
                                     interval_s=3600.0)
        pressure = scaler.queue_s + 1.0
        t1 = time.perf_counter()
        if scaler.step(queued_delta_s=pressure) != "up" or \
                scaler.worker_count() != 2:
            raise AssertionError(f"ha autoscale up: {scaler.events}")
        up_s = time.perf_counter() - t1
        new = fleet.workers[-1]
        boot_s.append(round(new.boot_s, 2))
        before = _fleet_launches(fleet)
        t1 = time.perf_counter()
        _cols, rows = Client(host, port, timeout=SERVE_CLIENT_S).execute(
            sqls[name])
        ms = (time.perf_counter() - t1) * 1e3
        after = _fleet_launches(fleet)
        in_new = _launch_delta({new.url: before.get(new.url, {})},
                               {new.url: after[new.url]})
        need(f"autoscaled {name} (the new worker)", in_new,
             required.get("autoscaled", ()))
        add(_launch_delta(before, after))
        _same_dist(rows, _json_rows(path_rows[name]), sqls[name],
                   f"ha autoscaled {name}", DOUBLE_RTOL)
        # the drain: pressure-free rounds while a query is in flight
        retries = fleet.resilience.query_retries
        before = _fleet_launches(fleet)
        result: dict = {}

        def run():
            try:
                result["rows"] = Client(host, port, timeout=SERVE_CLIENT_S
                                        ).execute(sqls[name])[1]
            except Exception as e:  # noqa: BLE001 — reported below
                result["error"] = e

        th = threading.Thread(target=run, daemon=True)
        th.start()
        t1 = time.perf_counter()
        steps = [scaler.step(queued_delta_s=0.0)
                 for _ in range(HA_IDLE_ROUNDS)]
        down_s = time.perf_counter() - t1
        th.join(SERVE_CLIENT_S)
        if steps[-1] != "down" or scaler.worker_count() != 1 or \
                len(fleet.workers) != 1:
            raise AssertionError(f"ha autoscale down: {steps}, "
                                 f"{scaler.events}")
        if "rows" not in result:
            raise AssertionError(f"ha autoscale: the query in flight "
                                 f"during the drain was lost: {result}")
        _same_dist(result["rows"], _json_rows(path_rows[name]), sqls[name],
                   f"ha drained {name}", DOUBLE_RTOL)
        add(_launch_delta(before, _fleet_launches(fleet)))
        log(f"ha autoscale ({smi}): one worker process up in "
            f"{boot_s[0]} s; one round of queue pressure ({pressure:g} s "
            f"queued) grew the fleet to two in {up_s:.1f} s (the new "
            f"worker booted in {boot_s[1]} s); {name} through the server "
            f"{ms:.1f} ms, rows equal phase 3's, launches in the new "
            f"worker {in_new}; {HA_IDLE_ROUNDS} pressure-free rounds "
            f"{steps} drained it back to one in {down_s:.1f} s while a "
            f"{name} was in flight, which returned phase 3's rows "
            f"({fleet.resilience.query_retries - retries} query retries); "
            f"events {scaler.events}; {time.perf_counter() - t0:.1f} s "
            "for (c)")
    log(f"ha launches ((a)-(c)): {launches}")
    log(f"ha: {time.perf_counter() - t_phase:.1f} s for phase 24")
    return launches


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
    cases += [
        ("hash_insert", "surface: G1 ROLLUP group-by",
         pick("surface G1", "hash_insert", lambda c: True)),
        ("hash_probe", "surface: J3 FULL self-join probe",
         pick("surface J3", "hash_probe", lambda c: True)),
        ("masked_segment_sum_f32", "surface: G3 ROLLUP REAL sum",
         pick("surface G3", "masked_segment_sum_f32", lambda c: True)),
        # few keys, many rows each: the layout that serializes the claims
        ("hash_insert", "windows: W3 largest insert (the group-by)",
         pick("windows W3", "hash_insert", lambda c: True)),
        ("hash_insert", "windows: W5 group-by (l_shipdate)",
         pick("windows W5", "hash_insert", lambda c: True)),
        ("hash_insert", "windows: W7 group-by (ntile bands)",
         pick("windows W7", "hash_insert", lambda c: True)),
    ]
    calls = [(q, c) for (q, k), cs in captured.items()
             if k == "hash_insert" and q.startswith("nested ") for c in cs]
    if not calls:
        raise AssertionError("the nested path made no hash_insert call")
    q, args = max(calls, key=lambda qc: _rows_of("hash_insert", qc[1]))
    cases.append(("hash_insert", f"nested: largest insert ({q[7:]})", args))
    cases.append(("hash_insert", "statements: ANALYZE of l_extendedprice",
                  pick("statements ANALYZE", "hash_insert",
                       lambda c: True)))
    # one partition driver's insert behind the HASH local exchange: the
    # largest, a live-masked view when its driver did not compact it
    cases.append(("hash_insert", "local exchange: Q18 largest insert of one "
                  "partition driver (task_concurrency=4)",
                  pick("engine Q18", "hash_insert", lambda c: True)))
    calls = [(q, c) for (q, k), cs in captured.items()
             if k == "hash_insert" and q.startswith("distributed Q")
             for c in cs]
    if not calls:
        raise AssertionError("the distributed path made no hash_insert call")
    q, args = max(calls, key=lambda qc: _rows_of("hash_insert", qc[1]))
    cases.append(("hash_insert", f"distributed: largest insert of a task "
                  f"({q[12:]}, {DIST_WORKERS} tasks)", args))
    cases.append(("hash_insert", "distributed: q1_step insert (fused Q1, "
                  "8 slots)", pick("distributed q1_step", "hash_insert",
                                   lambda c: True)))
    # the compiled stages (phase 20): Q1's accumulate groups a batch into
    # its 8192 slots and merges 2 x 8192 state rows; the seam merge
    # combines 4 x 8192 lanes a task; Q3's resident builds index int64
    # keys (two planes) and its lineitem batches probe the orders build
    cap = 8192
    cases += [
        ("hash_insert", "compiled: Q1 accumulate insert (one batch, cap "
         f"{cap})", pick("compiled Q1", "hash_insert",
                         lambda c: c[0].shape[1] not in (2 * cap,
                                                         DIST_WORKERS * cap))),
        ("hash_insert", f"compiled: Q1 seam merge insert ({DIST_WORKERS} x "
         f"{cap} lanes)", pick("compiled Q1", "hash_insert",
                               lambda c: c[0].shape[1] == DIST_WORKERS * cap)),
        ("hash_insert", "compiled: Q3 resident build insert (orders)",
         pick("compiled Q3", "hash_insert", lambda c: c[0].shape[0] == 2)),
        ("hash_probe", "compiled: Q3 resident probe of the orders build "
         "(one lineitem batch)",
         max(captured.get(("compiled Q3", "hash_probe"), [None]),
             key=lambda c: (c[1].shape[0], c[2].shape[1]) if c else (0, 0))),
    ]
    if cases[-1][2] is None:
        raise AssertionError("no captured hash_probe call of compiled Q3")
    # the fault-tolerant path (phase 21): a task attempt's largest insert
    # of Q3, its probe of Q12's non-unique build, R1's segment sum
    cases += [
        ("hash_insert", "fault-tolerant: Q3 largest insert of a task "
         "attempt", pick("fault-tolerant Q3", "hash_insert",
                         lambda c: True)),
        ("hash_probe", "fault-tolerant: Q12 largest probe of a task "
         "attempt", pick("fault-tolerant Q12", "hash_probe",
                         lambda c: True)),
        ("masked_segment_sum_f32", "fault-tolerant: R1 REAL sum of a task "
         "attempt", pick("fault-tolerant R1", "masked_segment_sum_f32",
                         lambda c: True)),
    ]
    # the serving path (phase 22): a worker task's largest insert of Q3,
    # probe of Q12 and REAL sum of R1, at its two-task split
    cases += [
        ("hash_insert", f"serving: Q3 largest insert of a worker task "
         f"({SERVE_WORKERS} tasks)", pick("serving Q3", "hash_insert",
                                          lambda c: True)),
        ("hash_probe", "serving: Q12 largest probe of a worker task",
         pick("serving Q12", "hash_probe", lambda c: True)),
        ("masked_segment_sum_f32", "serving: R1 REAL sum of a worker task",
         pick("serving R1", "masked_segment_sum_f32", lambda c: True)),
    ]
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
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    from trino_tpu_torch.caching import result_cache
    from trino_tpu_torch.connectors.tpch_queries import QUERIES
    from trino_tpu_torch.ops import gpu_kernels as GK

    sqls = {f"Q{q}": QUERIES[q] for q in sorted(QUERIES)}
    sqls.update(REAL_QUERIES)
    t_start = T_START
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # every statement's journal records go to a directory under build/,
    # removed at the end; phases 1-17, 6 and 9 time execution, so the
    # result tier is off for them (phase 18 turns it on)
    os.makedirs("build", exist_ok=True)
    journal_dir = tempfile.mkdtemp(prefix="chip-smoke-journal-", dir="build")
    os.environ["TRINO_TPU_JOURNAL_DIR"] = journal_dir
    # history-based optimization and the adaptive plane stay off in every
    # phase but 21, so the earlier phases' plans and times compare with
    # the runs before them (phase 21 runs the defaults)
    for name in P21_PINS:
        os.environ[name] = "0"
    executing = contextlib.ExitStack()
    executing.enter_context(result_cache.disabled())
    try:
        return _main(torch, GK, result_cache, executing, smi, kind, sqls,
                     t_start)
    finally:
        faulthandler.cancel_dump_traceback_later()
        executing.close()
        for proc in BACKGROUND:
            proc.stop()
        shutil.rmtree(journal_dir, ignore_errors=True)


def _main(torch, GK, result_cache, executing, smi, kind, sqls,
          t_start) -> int:
    from trino_tpu_torch.connectors.catalog import default_catalog
    from trino_tpu_torch.connectors.staging import stage_memory_tables
    from trino_tpu_torch.connectors.surface_queries import SURFACE_QUERIES
    from trino_tpu_torch.connectors.nested_queries import NESTED_QUERIES
    from trino_tpu_torch.connectors.window_queries import WINDOW_QUERIES
    from trino_tpu_torch.bench_kernels import q1_step as bench_q1_step
    from trino_tpu_torch.exec.stats import QueryStats
    from trino_tpu_torch.runner import StandaloneQueryRunner

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    GK.build_library(verbose=True)
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc trino_tpu_torch/csrc/*.cu, one process per source)")
    progress("2 (build)")

    # -- 3. path: SF 1 on cuda ---------------------------------------------
    runner = StandaloneQueryRunner(default_catalog(PATH_SF), device="cuda")
    scans: dict = {}
    path_rows, _, launches = run_path(torch, GK, runner, sqls,
                                      f"path SF{PATH_SF:g}", scans=scans,
                                      warm_names=PATH_WARM)
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
    progress("3 (path)")

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
    progress("4 (parity)")

    # -- 5. per-operator time (synchronized after every operator call) -----
    per_operator(QueryStats, runner, sqls, f"SF{PATH_SF:g}", TPCH_OPERATORS)
    progress("5 (operators)")

    # phase 23's expected rows: the sqlite oracle of the chaos mix at SF 1,
    # in a subprocess on the host while phases 7-22 run
    oracle = BackgroundOracle(CHAOS_SF)
    BACKGROUND.append(oracle)

    # -- 7. staging: SF 1 into memory on cuda ------------------------------
    staged_cat = stage_sf1(torch, default_catalog, stage_memory_tables)
    progress("7 (staging)")

    # -- 8. the staged path: memory tables, one split ----------------------
    staged = StandaloneQueryRunner(staged_cat, device="cuda",
                                   default_catalog_name="memory",
                                   splits_per_node=1)
    staged_warm: dict = {}
    staged_rows, staged_times, _ = run_path(torch, GK, staged, sqls,
                                            f"staged SF{PATH_SF:g}",
                                            warm_launches=staged_warm)
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
    progress("8 (staged)")

    # -- 10. optimizers: legacy vs iterative over the staged tables --------
    t0 = time.perf_counter()
    optimizers(torch, StandaloneQueryRunner, staged_cat, runner.catalog,
               sqls)
    log(f"optimizers: {time.perf_counter() - t0:.1f} s")
    progress("10 (optimizers)")

    # -- 11. surface: set operations, grouping sets, outer joins, functions
    surface_launches = surface(torch, GK, QueryStats, StandaloneQueryRunner,
                               default_catalog, staged_cat)
    progress("11 (surface)")

    # -- 12. windows: window functions and MATCH_RECOGNIZE ------------------
    window_launches = windows(torch, GK, QueryStats, StandaloneQueryRunner,
                              default_catalog, staged_cat)
    progress("12 (windows)")

    # -- 13. nested types, long decimals, JSON, table functions ------------
    nested_launches = nested(torch, GK, QueryStats, StandaloneQueryRunner,
                             default_catalog, staged_cat)
    progress("13 (nested)")

    # -- 14. the scan ingest path on the tpch path --------------------------
    ingest(torch, StandaloneQueryRunner, runner.catalog, sqls, scans,
           staged_cat)
    progress("14 (ingest)")

    # -- 15. the statements a session sends besides queries ----------------
    statement_launches = statements(torch, GK, StandaloneQueryRunner,
                                    staged_cat, runner, smi,
                                    path_rows["Q12"])
    progress("15 (statements)")

    # -- 16. the rest of the single-node engine ----------------------------
    engine_launches, parallel = engine(torch, GK, StandaloneQueryRunner,
                                       staged_cat, runner, sqls, numpy_rows,
                                       smi)
    progress("16 (engine)")

    # -- 17. the wire format, the disk tier of spill, the file connector ---
    storage_launches = storage(torch, GK, StandaloneQueryRunner,
                               default_catalog, runner, sqls, path_rows,
                               numpy_rows, smi)
    progress("17 (storage)")

    # -- 18. the telemetry plane, the plan and result caches, the system
    # connector: the caches on
    executing.close()
    served = result_cache.stats()
    if not result_cache.enabled() or served["hits"] or served["entries"]:
        raise AssertionError(f"phases 1-17 must execute every statement "
                             f"and phase 18 needs the result tier: {served}")
    log(f"result tier over phases 1-17: {served}")
    telemetry_launches = telemetry(torch, GK, StandaloneQueryRunner,
                                   staged_cat, runner.catalog, sqls,
                                   staged_rows, staged_warm, smi)
    executing.enter_context(result_cache.disabled())
    progress("18 (telemetry)")

    # -- 19. the distributed runner, the collective exchange, fused Q1 ------
    # on the per-operator path, as PR 15 measured it (phase 20 takes the
    # compiled stages, the default)
    with _compiled_off():
        distributed_launches, dist, q1_batch, dist_cold = distributed(
            torch, GK, default_catalog, runner, sqls, path_rows, smi)
    progress("19 (distributed)")

    # -- 20. the compiled stages: fused seams and resident plans ------------
    compiled_launches, compiled_dist = compiled(
        torch, GK, default_catalog, sqls, path_rows, smi)
    progress("20 (compiled)")

    # -- 21. HBO, the adaptive plane, fault-tolerant execution --------------
    ft_launches, adaptive_launches, fte_dist = resilient(
        torch, GK, default_catalog, sqls, path_rows, smi)
    progress("21 (resilient)")

    # -- 22. the control plane and the serving path: the statement server,
    # worker processes over HTTP
    serving_launches, serving_by_query, served = serving(
        torch, GK, sqls, path_rows, dist_cold, smi)
    progress("22 (serving)")

    # -- 23. the chaos harness, plugins, the warm-key journal --------------
    expected = oracle.result()
    chaos_launches = chaos(torch, GK, sqls, path_rows, smi,
                           expected=expected, served=served)
    progress("23 (chaos)")

    # -- 24. the HA coordinator fleet: takeover, front tier, autoscaler ----
    ha_launches = ha(torch, GK, sqls, path_rows, smi, expected[0])
    progress("24 (ha)")

    # -- 6. kernels vs plain versions at the paths' shapes ------------------
    # One more run per query records every wrapper call's arguments; it is
    # kept apart from the path runs so the held tensors do not inflate
    # their peak memory, and its launches are not the paths'.
    staged.execute(f"create table {ANALYZE_CASE} as "
                   "select l_extendedprice from lineitem")
    fleet = serving_fleet()
    captured = capture_calls(GK, [
        (f"{prefix}{name}", r, sqls[name]) for prefix, r in
        (("", runner), ("staged ", staged)) for name in CAPTURE_QUERIES]
        + [(f"surface {name}", staged, SURFACE_QUERIES[name])
           for name in SURFACE_CAPTURE]
        + [(f"windows {name}", staged, WINDOW_QUERIES[name])
           for name in WINDOW_CAPTURE]
        + [(f"nested {name}", staged, NESTED_QUERIES[name])
           for name in NESTED_CAPTURE]
        + [("statements ANALYZE", staged, f"analyze {ANALYZE_CASE}"),
           ("engine Q18", parallel, sqls["Q18"])]
        + [(f"distributed {name}", _Off(dist), sqls[name])
           for name in DIST_CAPTURE]
        + [(f"compiled {name}", compiled_dist, sqls[name])
           for name in COMPILED_CAPTURE]
        + [(f"fault-tolerant {name}", fte_dist, sqls[name])
           for name in P21_CAPTURE]
        + [(f"serving {name}", fleet, sqls[name]) for name in SERVE_CAPTURE]
        + [("distributed q1_step",
            _Program(lambda: bench_q1_step(q1_batch)), None)])
    fleet.close()
    same_split(captured, serving_by_query)
    staged.execute(f"drop table {ANALYZE_CASE}")
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
            res = _segment_case(
                torch, GK, GK.masked_segment_sum_f32, args,
                PLAIN_VS_F64_RTOL_ROLLUP if label.startswith("surface")
                else PLAIN_VS_F64_RTOL)
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
            "launches_surface": surface_launches[kernel],
            "launches_windows": window_launches[kernel],
            "launches_nested": nested_launches[kernel],
            "launches_statements": statement_launches[kernel],
            "launches_engine": engine_launches[kernel],
            "launches_storage": storage_launches[kernel],
            "launches_telemetry": telemetry_launches[kernel],
            "launches_distributed": distributed_launches[kernel],
            "launches_compiled": compiled_launches[kernel],
            "launches_fault_tolerant": ft_launches[kernel],
            "launches_adaptive": adaptive_launches[kernel],
            "launches_serving": serving_launches[kernel],
            "launches_chaos": chaos_launches[kernel],
            "launches_ha": ha_launches[kernel],
            "max_abs_err": res["err"], "ms": res["ms"],
            "kernels_alone_ms": res["alone_ms"],
            "device_ms": res["device_ms"],
            "host_enqueue_us": res["enq_us"], "plain_ms": res["plain_ms"],
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": res["lib_ms"], "shape": res["shape"], "cases": []})
        entry["max_abs_err"] = max(entry["max_abs_err"], res["err"])
        entry["cases"].append(case)
    del captured, cases, args, res, staged, staged_cat, runner, parallel
    del dist, q1_batch, compiled_dist, fte_dist, fleet
    torch.cuda.empty_cache()
    progress("6 (kernels)")

    # -- 9. SF 10: Q1 and Q3 over staged tables -----------------------------
    sf10(torch, sqls, default_catalog, stage_memory_tables,
         StandaloneQueryRunner)
    progress("9 (SF 10)")
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

"""Hash-join execution on tensors: build, probe ranges, pair expansion.

The port of the reference ``exec/join_exec.py`` (INNER, LEFT, RIGHT, FULL
and SINGLE joins and the semi-join mark):

- :func:`build_table` hashes and sorts the build keys (``hash_combine`` +
  argsort), then indexes the sorted hashes with an open-addressing table
  built by the ``hash_insert`` kernel (:func:`_hash_index_fn`), and, for a
  unique dense integer key, a direct-address table (:func:`maybe_build_dense`);
- :func:`probe_ranges_device` maps probe rows to (lo, counts) runs of the
  sorted build through the ``hash_probe`` kernel; the candidate total
  stays on the device, its copy to the host started (an AsyncScalar);
- :func:`run_pairs` expands candidates into a padded bucket of ``cap``
  lanes, verifies keys exactly, applies the residual and gathers the output
  columns, with per-probe match counts for LEFT/SINGLE/FULL joins or the
  three-valued semi-join mark, each pair's build row for RIGHT/FULL, and a
  device overflow flag (total > cap);
  :func:`unique_lookup` + :func:`unique_output` are the one-match-per-row
  probe of a unique build (dense or sorted-hash branch) with the same
  options, and :func:`unique_compact` its compacted variant for selective
  INNER / RIGHT probes.

The probe is sync-free (the reference's padded expand): the expand bucket
comes from :class:`ExpandPlanner` (a cap provable from the build's longest
duplicate run, else an estimate fed by earlier batches' totals read only
once their copies landed), and an estimated cap's result waits in an
:class:`OverflowQueue` until its overflow flag lands, then commits or is
re-run at the exact total.  Host reads go through ``exec/syncguard.py``.

A residual is a callable over the pair layout (probe columns ++ build
columns) returning a bool mask, with a ``refs`` attribute naming the
channels it reads: only those are gathered to evaluate it.

Hashes are int64 tensors holding uint64 bits (exec/kernels.py).  Sorted
order is the UNSIGNED order of the reference: sorting and searching use the
sign-flipped key ``h ^ INT64_MIN``, so the sentinels below still sort last.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from ..caching.executable_cache import bounded
from . import kernels as K
from . import syncguard as SG
from ..ops import gpu_kernels as GK

__all__ = ["DeviceJoinTable", "JoinHashTable", "build_table",
           "probe_ranges_device", "run_pairs", "unique_lookup",
           "unique_output", "unique_compact", "semi_mark",
           "probe_key_remap", "key_input", "ExpandPlanner", "OverflowQueue",
           "plan_unique_cap", "PROVABLE_SLACK", "EST_HEADROOM",
           "MAX_INFLIGHT"]

_SENT_BUILD = -1  # 0xFFFFFFFFFFFFFFFF: build rows with NULL keys / dead rows
_SENT_PROBE = -2  # 0xFFFFFFFFFFFFFFFE: probe rows with NULL keys
_FLIP = -(1 << 63)


def key_input(col) -> torch.Tensor:
    """A key column's data for hashing: an RLE run expands on its device
    from its one value into a contiguous tensor (kernels.rle_fill), since
    the kernel wrappers refuse strided inputs; any other column hands on
    ``data`` (a LAZY one materializes)."""
    if col.encoding == "RLE":
        return K.rle_fill(col.rle_value, len(col), col.device)
    return col.data


def _order_key(h):
    """uint64 bits in int64 -> int64 whose signed order is the unsigned one."""
    return h ^ _FLIP


def _is_sentinel(h):
    """Unsigned h >= _SENT_PROBE (the sentinel region)."""
    return (h == _SENT_PROBE) | (h == _SENT_BUILD)


class JoinHashTable:
    """Open-addressing index over the build side's 64-bit key hashes:
    maps a probe hash to its contiguous run of rows in sorted-hash order, so
    (lo, counts) equal the searchsorted implementation value for value."""

    __slots__ = ("table_planes", "slot_gid", "group_lo", "group_counts",
                 "num_slots")

    def __init__(self, table_planes, slot_gid, group_lo, group_counts,
                 num_slots: int):
        self.table_planes = table_planes
        self.slot_gid = slot_gid
        self.group_lo = group_lo  # [S] first sorted position per hash group
        self.group_counts = group_counts  # [S] live run length per group
        self.num_slots = num_slots


class DeviceJoinTable:
    """Sorted-hash build side with its hash index (and dense table)."""

    __slots__ = ("sorted_hash", "perm", "key_datas", "num_rows",
                 "has_null_key", "live_rows", "max_run", "dense", "dense_lo",
                 "hash_idx")

    def __init__(self, sorted_hash, perm, key_datas, num_rows: int,
                 has_null_key: bool, live_rows: int, max_run: int):
        self.sorted_hash = sorted_hash
        self.perm = perm
        self.key_datas = key_datas  # unsorted, for exact verify
        self.num_rows = num_rows
        self.has_null_key = has_null_key
        self.live_rows = live_rows
        self.max_run = max_run  # longest duplicate-hash run of live rows
        self.dense = None  # dense[key - dense_lo] = build row, or -1
        self.dense_lo = 0
        self.hash_idx: Optional[JoinHashTable] = None

    @property
    def unique(self) -> bool:
        return self.max_run <= 1


def _hash_planes(h):
    """64-bit hash -> the kernels' [2, N] planes (lo, hi words) + slot hash.
    Plane equality is exactly 64-bit hash equality."""
    planes = torch.stack([K._i32_bits(h), K._i32_bits(K._shr(h, 32))])
    return planes, K.slot_hash32(h)


def _hash_index_fn(sorted_hash, S: int) -> JoinHashTable:
    """Insert the SORTED build hashes: each distinct hash is one contiguous
    run, so per-group lo/count are one min- and one sum-scatter over
    positions (dead rows carry gid S -> trash slot)."""
    n = int(sorted_hash.shape[0])
    dev = sorted_hash.device
    live = ~_is_sentinel(sorted_hash)
    planes, h32 = _hash_planes(sorted_hash)
    row_gid, _count, table, sgid = GK.hash_insert(planes, h32, live, S)
    g = row_gid.to(torch.int64)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    glo = torch.full((S + 1,), n, dtype=torch.int64, device=dev)
    glo.scatter_reduce_(0, g, pos, "amin")
    gcnt = torch.zeros(S + 1, dtype=torch.int64, device=dev).index_add_(
        0, g, live.to(torch.int64))
    return JoinHashTable(table, sgid, glo[:S], gcnt[:S], S)


DENSE_MAX_SLOTS = 1 << 27
DENSE_SLACK = 4  # key range may exceed live rows by this factor


def maybe_build_dense(table: DeviceJoinTable, keys, live, kmin: int,
                      kmax: int) -> None:
    """Attach a direct-address table when the single integer build key is
    unique and densely ranged (every TPC-H PK/FK edge qualifies)."""
    if len(keys) != 1 or table.num_rows == 0 or table.max_run != 1 \
            or kmax < kmin:
        return
    size = kmax - kmin + 1
    if size > DENSE_MAX_SLOTS or size > max(DENSE_SLACK * table.live_rows,
                                            1 << 16):
        return
    d, v = keys[0]
    idx = d.to(torch.int64) - kmin
    elig = (idx >= 0) & (idx < size)
    if v is not None:
        elig = elig & v
    if live is not None:
        elig = elig & live
    slot = torch.where(elig, idx, size)  # trash slot for ineligible rows
    dense = torch.full((size + 1,), -1, dtype=torch.int32, device=d.device)
    dense[slot] = torch.arange(d.shape[0], dtype=torch.int32,
                               device=d.device)
    table.dense = dense[:size]
    table.dense_lo = kmin


def build_table(keys: Sequence[tuple], live=None) -> DeviceJoinTable:
    """keys: [(data, valid|None), ...]; ``live`` masks dead build rows —
    they never match and don't count toward live_rows/has_null.  The
    build's scalars (live rows, a NULL key, the longest duplicate run, a
    single integer key's range) reach the host in one fetch, once per
    build: every probe batch plans its expand bucket from them."""
    datas = [d for d, _ in keys]
    n = int(datas[0].shape[0])
    dev = datas[0].device
    h = K.hash_combine(datas)
    null_mask = None
    for _, v in keys:
        if v is not None:
            null_mask = ~v if null_mask is None else (null_mask | ~v)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    scalars = [torch.full((), n, dtype=torch.int64, device=dev)
               if live is None else live.sum(), zero]
    if null_mask is not None:
        scalars[1] = (null_mask if live is None
                      else null_mask & live).any().to(torch.int64)
        h = torch.where(null_mask, _SENT_BUILD, h)
    if live is not None:
        h = torch.where(live, h, _SENT_BUILD)
    perm = torch.argsort(_order_key(h), stable=True)
    sh = h[perm]
    scalars.append(zero)
    if n:
        ok = _order_key(sh).contiguous()
        run = (torch.searchsorted(ok, ok, right=True)
               - torch.searchsorted(ok, ok))
        scalars[2] = torch.where(_is_sentinel(sh), 0, run).max()
    ranged = (len(keys) == 1 and n and not datas[0].is_floating_point()
              and datas[0].dtype != torch.bool)
    if ranged:
        k0 = datas[0].to(torch.int64)
        elig = torch.ones(n, dtype=torch.bool, device=dev)
        if keys[0][1] is not None:
            elig = elig & keys[0][1]
        if live is not None:
            elig = elig & live
        scalars += [elig.any().to(torch.int64),
                    torch.where(elig, k0, 1 << 62).min(),
                    torch.where(elig, k0, -(1 << 62)).max()]
    got = [int(v) for v in SG.fetch(torch.stack(scalars), "join.build")]
    table = DeviceJoinTable(sh, perm, datas, n, bool(got[1]), got[0], got[2])
    if n:
        table.hash_idx = _hash_index_fn(sh, K.bucket(2 * n))
    if ranged and got[3]:
        maybe_build_dense(table, keys, live, got[4], got[5])
    return table


def _probe_hash(probe_keys, remaps):
    """Probe-side key hash with NULL / dictionary-miss rows folded to the
    probe sentinel.  Returns (h, remapped key datas)."""
    datas = []
    pnull = None
    for (d, v), r in zip(probe_keys, remaps):
        nm = None if v is None else ~v
        if r is not None:
            d = r[d.long()]
            miss = d < 0  # value absent from the build dictionary
            nm = miss if nm is None else (nm | miss)
        datas.append(d)
        if nm is not None:
            pnull = nm if pnull is None else (pnull | nm)
    h = K.hash_combine(datas)
    if pnull is not None:
        h = torch.where(pnull, _SENT_PROBE, h)
    return h, datas


def probe_ranges_device(table: DeviceJoinTable, probe_keys: Sequence[tuple],
                        remaps: Sequence, live=None):
    """(lo, counts, total) of each probe row's candidate run in the sorted
    build, through the ``hash_probe`` kernel.  ``remaps[k]`` optionally
    translates probe dictionary codes into the build's code space (-1 =
    absent).  ``total`` is an :class:`AsyncScalar` over the device total,
    its copy to the host started: nothing here waits on the device."""
    h, _ = _probe_hash(probe_keys, remaps)
    idx = table.hash_idx
    if idx is None:  # empty build: nothing can match
        zeros = torch.zeros(h.shape, dtype=torch.int64, device=h.device)
        return zeros, zeros, SG.async_scalar(zeros.sum(), "join.pair-total")
    ok = ~_is_sentinel(h)
    if live is not None:
        ok = ok & live
    planes, h32 = _hash_planes(h)
    pgid = GK.hash_probe(idx.table_planes, idx.slot_gid, planes, h32, ok)
    hit = pgid >= 0  # dead/null/miss probe rows come back -1
    safe = torch.where(hit, pgid, 0).long()
    lo = idx.group_lo[safe]
    counts = torch.where(hit, idx.group_counts[safe], 0)
    return lo, counts, SG.async_scalar(counts.sum(), "join.pair-total")


# ---------------------------------------------------------------------------
# padded-expand capacity planning

# the provable cap (n_probe * max_run lanes can NEVER overflow, because each
# probe row yields at most max_run candidates) is used whenever it costs at
# most this many times the minimal bucket; beyond that the adaptive estimate
# takes over and the overflow flag guards correctness.  The reference allows
# 8x; on the card each padded lane is device work, and an overflow's re-run
# costs less than a 4-8x bucket (staged Q21's first run: 64 M lanes for
# about 15 M candidates)
PROVABLE_SLACK = 2
EST_HEADROOM = 2          # estimated cap = headroom * max recent total
EST_WINDOW = 8            # totals remembered for the estimate

# Cross-execution feedback: the largest observed candidate total per plan
# shape, so a fresh operator of the same shape starts from the last run's
# total instead of the probe width.  Correctness never depends on a seed:
# the overflow flag guards every estimated cap.
_EST_SEEDS = bounded("join_exec.estimate_seeds", 4096)
_EST_SEEDS_LOCK = threading.Lock()  # serializes the seeds' max-update


def reset_estimate_seeds() -> None:
    _EST_SEEDS.clear()


class ExpandPlanner:
    """Per-probe-operator planner of the padded-expand bucket.

    Sync-free contract: ``plan`` never waits on the device.  With no landed
    total it takes a cap PROVABLY >= the candidate total (from the build's
    longest duplicate run, fetched once per build) when that costs at most
    PROVABLE_SLACK times the probe width, else an estimate.  Once totals of
    earlier batches (or of an earlier run of the plan, through the seed
    store) have landed, an estimate smaller than the provable cap wins:
    every lane of the padded expand is device work, and on the card that
    work costs more than the one overflow re-run an estimate risks.  On
    the estimated path the caller must check the expand's overflow flag
    before emitting; ``observe`` feeds the planner so the steady state
    converges to no overflow.  With a ``key`` the planner also reads and
    writes the process-global seed store."""

    __slots__ = ("_totals", "_pending", "_key", "_seed")

    def __init__(self, key=None):
        self._key = key
        self._seed = 0
        if key is not None:
            self._seed = _EST_SEEDS.get(key, 0)
        self._totals: list[int] = []
        self._pending: list[SG.AsyncScalar] = []

    def plan(self, n_probe: int, max_run: Optional[int]) -> tuple[int, bool]:
        """(cap, provable).  ``max_run`` None = unknown."""
        self._drain()
        floor = K.bucket(max(n_probe, 1))
        # a landed total sizes the bucket by itself (a selective probe's
        # candidates are far fewer than its lanes): this run's totals with
        # headroom for the batches to come, the seed (the largest total an
        # earlier run of the plan saw) as it is
        landed = bool(self._totals or self._seed)
        est = (max(self._seed, max(self._totals, default=0) * EST_HEADROOM)
               if landed else n_probe)
        cap = K.bucket(max(est, 1))
        if max_run is not None and max_run >= 0:
            # the provable candidate-total upper bound
            bound = K.bucket(max(n_probe * max(max_run, 1), 1))
            if cap >= bound or (not landed
                                and bound <= PROVABLE_SLACK * floor):
                return bound, True
        return cap, False

    def observe_async(self, total: SG.AsyncScalar) -> None:
        """Feed a batch's device total; it is read only once its copy
        landed (non-blocking polls on later ``plan`` calls)."""
        self._pending.append(total)

    def recent_max(self) -> Optional[int]:
        """The largest landed total of the recent window (None until the
        first lands): the unique path's density estimate."""
        self._drain()
        return max(self._totals) if self._totals else (self._seed or None)

    def settle(self) -> None:
        """Read the totals that have landed (non-blocking): called at the
        probe's end, so that a probe of one batch, which never plans a
        second, still leaves its total in the seed store for the next run
        of its plan."""
        self._drain()

    def observe(self, total: int) -> None:
        total = int(total)
        self._totals.append(total)
        del self._totals[:-EST_WINDOW]
        if self._key is not None:
            with _EST_SEEDS_LOCK:
                if total > _EST_SEEDS.peek(self._key, 0):
                    _EST_SEEDS.put(self._key, total)

    def _drain(self) -> None:
        still = []
        for h in self._pending:
            v = h.get_if_ready()
            if v is None:
                still.append(h)
            else:
                self.observe(int(v))
        self._pending = still[-EST_WINDOW:]


MAX_INFLIGHT = 4  # deferred estimated-cap batches before the host waits


class OverflowQueue:
    """Deferred commits of estimated-cap expands.

    An estimated cap can truncate candidates, and only the expand's device
    overflow flag proves it did not; waiting on that flag per batch would
    bring back the sync the padded expand removed.  So the speculative
    result waits here with the flag's copy in flight; the flag of batch N
    lands while the host enqueues batch N+1, and ``drain`` commits it after
    a non-blocking poll.  A flag that landed True re-runs its ``retry``
    thunk (at the exact total, by then on the host) before committing:
    results are never silently truncated, and the retry is counted in
    SyncStats.  Entries commit in push order; only ``drain(block=True)``
    (input end) or more than MAX_INFLIGHT waiting entries ever block;
    results that cannot overflow queue behind waiting ones (``submit``), so
    the output keeps the input's batch order."""

    __slots__ = ("_q",)

    def __init__(self):
        self._q = deque()

    def __len__(self) -> int:
        return len(self._q)

    def push(self, overflow: Optional[SG.AsyncScalar], result, retry,
             commit) -> None:
        """Queue a result behind its overflow flag (None: a result that
        cannot overflow, queued only to keep the commit order)."""
        self._q.append((overflow, result, retry, commit))

    def submit(self, overflow: Optional[SG.AsyncScalar], result, retry,
               commit) -> None:
        """Commit at once what cannot overflow when nothing waits before
        it; queue anything else, then commit what has landed."""
        if overflow is None and not self._q:
            commit(result)
            return
        self.push(overflow, result, retry, commit)
        self.drain()

    def drain(self, block: bool = False) -> None:
        while self._q:
            h, res, retry, commit = self._q[0]
            if h is None:
                v = False
            elif block or len(self._q) > MAX_INFLIGHT:
                v = h.get()
            else:
                v = h.get_if_ready()
                if v is None:
                    return
            self._q.popleft()
            if bool(v):
                SG.count_overflow()
                res = retry()
            commit(res)


def plan_unique_cap(n_lanes: int, count: Optional[int]) -> Optional[int]:
    """Compact-or-wide choice of the unique probe: compact to
    bucket(count) lanes when matches fill at most a quarter of the lanes,
    else stay wide (None).  ``count`` is an estimate from earlier batches'
    landed match counts (the overflow flag guards it), or None."""
    if count is None:
        return None
    return K.bucket(max(count, 1)) if count * 4 <= n_lanes else None


def _gather(cols, idx, only=None, offset: int = 0):
    """Columns gathered at ``idx``; with ``only`` (a set of pair-layout
    channels), the others are left as None."""
    return [(d[idx], None if v is None else v[idx])
            if only is None or i + offset in only else None
            for i, (d, v) in enumerate(cols)]


def _apply_residual(residual, ok, cols):
    mask = residual(cols)
    return ok & (mask.expand(ok.shape) if mask.dim() == 0 else mask)


def semi_mark(matched, probe_keys, semi: tuple):
    """Three-valued IN / EXISTS mark (data, valid): a non-match is UNKNOWN
    when the join is null-aware (NOT IN) and the probe key is NULL or the
    build holds a NULL key; IN over an empty build is FALSE even for a NULL
    probe.  ``semi`` = (null_aware, has_null_build, build_nonempty)."""
    null_aware, has_null_build, build_nonempty = semi
    if not (null_aware and build_nonempty):
        return matched, None
    if has_null_build:
        return matched, matched
    null_probe = None
    for _, v in probe_keys:
        if v is not None:
            null_probe = ~v if null_probe is None else (null_probe | ~v)
    if null_probe is None:
        return matched, None
    return matched, matched | ~null_probe


def _lane_rows(counts, starts, cap: int):
    """The probe row of each of ``cap`` expand lanes (lanes past the total
    get the last row with candidates), by scans and scatters: each row with
    candidates marks its first lane, a running sum of the marks is the
    lane's rank among those rows, and a scattered table maps the rank to
    the row.  Linear in rows and lanes, where a binary search per lane
    costs log(rows) random reads each.  Rows without candidates write to
    slots of their own past the used ones: many writes to one trash slot
    serialize on the card."""
    n = int(counts.shape[0])
    dev = counts.device
    has = counts > 0
    rank = torch.cumsum(has.to(torch.int64), 0) - 1
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    row_of_rank = torch.zeros(2 * n, dtype=torch.int64, device=dev)
    row_of_rank.scatter_(0, torch.where(has, rank, n + rows), rows)
    marks = torch.zeros(cap + n, dtype=torch.int8, device=dev)
    marks.scatter_(0, torch.where(has & (starts < cap), starts, cap + rows),
                   torch.ones(n, dtype=torch.int8, device=dev))
    lane_rank = torch.cumsum(marks[:cap], 0, dtype=torch.int64) - 1
    return row_of_rank[torch.clamp(lane_rank, 0, max(n - 1, 0))]


def run_pairs(table: DeviceJoinTable, lo, counts, total, probe_keys,
              remaps, probe_cols, build_cols, residual=None,
              need_matched: bool = False, semi: Optional[tuple] = None,
              cap: Optional[int] = None):
    """Expand the candidate runs into (probe, build) pairs over a padded
    bucket of ``cap`` lanes, verify key equality exactly, apply
    ``residual``, and gather every output column at the pairs.  ``total``
    is the AsyncScalar of :func:`probe_ranges_device` (then ``cap`` must be
    given: nothing waits on the device) or a host int (``cap`` defaults to
    its bucket).  Returns (pair_cols, ok, matches, mark, build_id,
    overflow): ``pair_cols`` [(data, valid)] over probe then build columns
    (None for a semi-join, which gathers only what its residual reads),
    ``ok`` the per-lane match mask (the output batch's live mask; lanes
    past the total are dead), ``matches`` the per-probe match count when
    ``need_matched``, ``mark`` the semi-join mark (data, valid) when
    ``semi`` is set, ``build_id`` each lane's build row (RIGHT / FULL mark
    the build rows that matched), ``overflow`` a device bool: True when
    the total exceeded ``cap`` and the lanes are a truncated subset."""
    dev = lo.device
    if isinstance(total, SG.AsyncScalar):
        total_dev = total.value
    else:
        total_dev = torch.full((), int(total), dtype=torch.int64,
                               device=dev)
        if cap is None:
            cap = K.bucket(max(int(total), 1))
    n_probe = int(counts.shape[0])
    nb = int(table.perm.shape[0])
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(cap, dtype=torch.int64, device=dev)
    probe_id = _lane_rows(counts, starts, cap)
    within = slot - starts[probe_id]
    # lanes past the total run on past their row's candidates: wrapping
    # spreads them over the build (they are dead; a scatter of RIGHT /
    # FULL's hits then meets no one hot row)
    build_id = table.perm[torch.remainder(lo[probe_id] + within,
                                          max(nb, 1))]
    _, pkeys = _probe_hash(probe_keys, remaps)
    ok = slot < total_dev
    for pk, bk in zip(pkeys, table.key_datas):
        ok = ok & ~K._neq(pk[probe_id], bk[build_id])
    pairs = None
    if semi is None or residual is not None:
        only = residual.refs if semi is not None else None
        np_cols = len(probe_cols)
        pairs = (_gather(probe_cols, probe_id, only)
                 + _gather(build_cols, build_id, only, np_cols))
    if residual is not None:
        ok = _apply_residual(residual, ok, pairs)
    matches = mark = None
    if need_matched or semi is not None:
        # per-row match counts as prefix-sum differences over each row's
        # lanes (no atomics: the dead lanes past the total all belong to
        # one row)
        ends = torch.clamp(starts + counts, max=cap)
        cs = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
        cs[1:] = torch.cumsum(ok.to(torch.int64), 0)
        matches = cs[ends] - cs[torch.clamp(starts, max=cap)]
    if semi is not None:
        mark = semi_mark(matches > 0, probe_keys, semi)
        pairs = None
    return pairs, ok, matches, mark, build_id, total_dev > cap


def unique_lookup(table: DeviceJoinTable, probe_keys, remaps):
    """Probe a unique build: (ok, bid), the per-row match mask (NULL and
    missing keys never match; ``live`` not folded) and the build row each
    probe row looked up (meaningful where ``ok``).  Dense builds take the
    direct-address branch, others a binary search in the sorted hashes;
    both verify the keys exactly."""
    nb = table.num_rows
    if table.dense is not None and len(probe_keys) == 1:
        # direct-address branch: one gather, exact by construction
        (d, v), r = probe_keys[0], remaps[0]
        if r is not None:
            d = r[d.long()]
        size = int(table.dense.shape[0])
        idx = d.to(torch.int64) - table.dense_lo
        in_range = (idx >= 0) & (idx < size)
        if r is not None:
            in_range = in_range & (d >= 0)
        slot = table.dense[torch.clamp(idx, 0, size - 1)]
        ok = in_range & (slot >= 0)
        bid = torch.clamp(slot.to(torch.int64), 0, max(nb - 1, 0))
        if v is not None:
            ok = ok & v
        return ok, bid
    # sorted-hash branch: binary search in the sorted build hashes
    h, pkeys = _probe_hash(probe_keys, remaps)
    skey = _order_key(table.sorted_hash).contiguous()
    pos = torch.clamp(torch.searchsorted(skey, _order_key(h)), 0, nb - 1)
    ok = (table.sorted_hash[pos] == h) & ~_is_sentinel(h)
    bid = table.perm[pos]
    for pk, bk in zip(pkeys, table.key_datas):
        ok = ok & ~K._neq(pk, bk[bid])
    return ok, bid


def unique_output(ok, bid, probe_keys, build_cols, live=None, residual=None,
                  probe_cols=(), semi: Optional[tuple] = None):
    """The wide unique probe's output over the probe batch's lanes from
    :func:`unique_lookup`'s (ok, bid).  ``residual`` reads ``probe_cols``
    ++ the gathered build columns.  Returns (build_out, ok_live, mark):
    build columns gathered per probe row (valid folds the match mask), the
    per-probe match mask & live, and the semi-join mark when ``semi`` is
    set (then ``build_out`` is None)."""
    if residual is not None:
        np_cols = len(probe_cols)
        cols = (list(probe_cols)
                + _gather(build_cols, bid, residual.refs, np_cols))
        ok = _apply_residual(residual, ok, cols)
    ok_live = ok if live is None else (ok & live)
    if semi is not None:
        return None, ok_live, semi_mark(ok, probe_keys, semi)
    out = [(d[bid], ok_live if v is None else (v[bid] & ok_live))
           for d, v in build_cols]
    return out, ok_live, None


def unique_compact(ok_live, bid, cap: int, build_cols, residual=None,
                   probe_cols=()):
    """The unique probe compacted to ``cap`` lanes with no host sync: the
    first ``cap`` matching probe rows, in order, with their build rows, so
    a selective join's output is narrow.  ``residual`` reads
    ``probe_cols`` (None where it reads nothing) gathered at the lanes ++
    the gathered build columns.  Returns (lanes, build_out, live, bid,
    overflow): ``lanes`` the probe row of each lane (the caller gathers
    the probe columns), ``live`` the lanes that hold a match (after the
    residual), ``bid`` each lane's build row, ``overflow`` a device bool
    (more than ``cap`` matches: the caller re-runs wide)."""
    n = int(ok_live.shape[0])
    dev = ok_live.device
    pos = torch.cumsum(ok_live.to(torch.int64), 0)
    count = pos[-1] if n else torch.zeros((), dtype=torch.int64, device=dev)
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    # rows that do not match write to slots of their own past the lanes;
    # the dead lanes past the count read spread rows, not one hot row
    dest = torch.where(ok_live & (pos <= cap), pos - 1, cap + rows)
    lanes = torch.remainder(torch.arange(cap + n, device=dev), max(n, 1))
    lanes.scatter_(0, dest, rows)
    lanes = lanes[:cap]
    live = torch.arange(cap, device=dev) < count
    bid = bid[lanes]
    if residual is not None:
        p_sel = [None if pc is None else
                 (pc[0][lanes], None if pc[1] is None else pc[1][lanes])
                 for pc in probe_cols]
        cols = p_sel + _gather(build_cols, bid, residual.refs, len(p_sel))
        live = _apply_residual(residual, live, cols)
    b_out = [(d[bid], live if v is None else (v[bid] & live))
             for d, v in build_cols]
    return lanes, b_out, live, bid, count > cap


def probe_key_remap(pdict: Optional[np.ndarray],
                    build_dict: Optional[np.ndarray], device):
    """Remap table translating probe dictionary codes into the build side's
    code space (-1 = value absent), or None when the spaces agree."""
    if pdict is None and build_dict is None:
        return None
    if build_dict is None or len(build_dict) == 0:
        return torch.full((max(len(pdict), 1),), -1, dtype=torch.int32,
                          device=device)
    if pdict is None or pdict is build_dict:
        return None
    if pdict.shape == build_dict.shape and (pdict == build_dict).all():
        return None
    pos = np.searchsorted(build_dict, pdict)
    clipped = np.clip(pos, 0, len(build_dict) - 1)
    ok = build_dict[clipped] == pdict
    return torch.as_tensor(np.where(ok, clipped, -1).astype(np.int32),
                           device=device)

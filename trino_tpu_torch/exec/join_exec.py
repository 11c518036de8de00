"""Hash-join execution on tensors: build, probe ranges, pair expansion.

The port of the reference ``exec/join_exec.py`` (INNER, LEFT, RIGHT, FULL
and SINGLE joins and the semi-join mark):

- :func:`build_table` hashes and sorts the build keys (``hash_combine`` +
  argsort), then indexes the sorted hashes with an open-addressing table
  built by the ``hash_insert`` kernel (:func:`_hash_index_fn`), and, for a
  unique dense integer key, a direct-address table (:func:`maybe_build_dense`);
- :func:`probe_ranges_device` maps probe rows to (lo, counts) runs of the
  sorted build through the ``hash_probe`` kernel;
- :func:`run_pairs` expands candidates, verifies keys exactly, applies the
  residual and gathers the output columns, with per-probe match flags for
  LEFT/SINGLE/FULL joins or the three-valued semi-join mark, and each
  pair's build row for RIGHT/FULL;
  :func:`run_unique` is the one-match-per-row probe of a unique build (dense
  or sorted-hash branch) with the same options.

A residual is a callable over the pair layout (probe columns ++ build
columns) returning a bool mask, with a ``refs`` attribute naming the
channels it reads: only those are gathered to evaluate it.

Hashes are int64 tensors holding uint64 bits (exec/kernels.py).  Sorted
order is the UNSIGNED order of the reference: sorting and searching use the
sign-flipped key ``h ^ INT64_MIN``, so the sentinels below still sort last.
Eager torch needs no sync-free machinery: data-dependent sizes are read on
the host where they are needed.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import kernels as K
from ..ops import gpu_kernels as GK

__all__ = ["DeviceJoinTable", "JoinHashTable", "build_table",
           "probe_ranges_device", "run_pairs", "run_unique", "semi_mark",
           "probe_key_remap", "key_input"]

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
    they never match and don't count toward live_rows/has_null."""
    datas = [d for d, _ in keys]
    n = int(datas[0].shape[0])
    dev = datas[0].device
    h = K.hash_combine(datas)
    null_mask = None
    for _, v in keys:
        if v is not None:
            null_mask = ~v if null_mask is None else (null_mask | ~v)
    live_rows = n if live is None else int(live.sum())
    has_null = False
    if null_mask is not None:
        has_null = bool((null_mask if live is None
                         else null_mask & live).any())
        h = torch.where(null_mask, _SENT_BUILD, h)
    if live is not None:
        h = torch.where(live, h, _SENT_BUILD)
    perm = torch.argsort(_order_key(h), stable=True)
    sh = h[perm]
    max_run = 0
    if n:
        ok = _order_key(sh).contiguous()
        run = (torch.searchsorted(ok, ok, right=True)
               - torch.searchsorted(ok, ok))
        max_run = int(torch.where(_is_sentinel(sh), 0, run).max())
    table = DeviceJoinTable(sh, perm, datas, n, has_null, live_rows, max_run)
    if n:
        table.hash_idx = _hash_index_fn(sh, K.bucket(2 * n))
    if len(keys) == 1 and n and not datas[0].is_floating_point() \
            and datas[0].dtype != torch.bool:
        k0 = datas[0].to(torch.int64)
        elig = torch.ones(n, dtype=torch.bool, device=dev)
        if keys[0][1] is not None:
            elig = elig & keys[0][1]
        if live is not None:
            elig = elig & live
        if bool(elig.any()):
            kmin = int(torch.where(elig, k0, 1 << 62).min())
            kmax = int(torch.where(elig, k0, -(1 << 62)).max())
            maybe_build_dense(table, keys, live, kmin, kmax)
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
    absent).  ``total`` is a host int."""
    h, _ = _probe_hash(probe_keys, remaps)
    idx = table.hash_idx
    if idx is None:  # empty build: nothing can match
        zeros = torch.zeros(h.shape, dtype=torch.int64, device=h.device)
        return zeros, zeros, 0
    ok = ~_is_sentinel(h)
    if live is not None:
        ok = ok & live
    planes, h32 = _hash_planes(h)
    pgid = GK.hash_probe(idx.table_planes, idx.slot_gid, planes, h32, ok)
    hit = pgid >= 0  # dead/null/miss probe rows come back -1
    safe = torch.where(hit, pgid, 0).long()
    lo = idx.group_lo[safe]
    counts = torch.where(hit, idx.group_counts[safe], 0)
    return lo, counts, int(counts.sum())


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


def run_pairs(table: DeviceJoinTable, lo, counts, total: int, probe_keys,
              remaps, probe_cols, build_cols, residual=None,
              need_matched: bool = False, semi: Optional[tuple] = None):
    """Expand the candidate runs into (probe, build) pairs, verify key
    equality exactly, apply ``residual``, and gather every output column at
    the pairs.  Returns (pair_cols, ok, matches, mark, build_id):
    ``pair_cols`` [(data, valid)] over probe then build columns (None for a
    semi-join, which gathers only what its residual reads), ``ok`` the
    per-pair match mask (the output batch's live mask), ``matches`` the
    per-probe match count when ``need_matched``, ``mark`` the semi-join
    mark (data, valid) when ``semi`` is set, ``build_id`` each pair's build
    row (RIGHT / FULL mark the build rows that matched)."""
    dev = lo.device
    n_probe = int(counts.shape[0])
    probe_id = torch.repeat_interleave(
        torch.arange(n_probe, device=dev), counts, output_size=total)
    starts = torch.cumsum(counts, 0) - counts
    within = torch.arange(total, device=dev) - starts[probe_id]
    build_id = table.perm[lo[probe_id] + within]
    _, pkeys = _probe_hash(probe_keys, remaps)
    ok = torch.ones(total, dtype=torch.bool, device=dev)
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
        matches = torch.zeros(n_probe, dtype=torch.int64,
                              device=dev).index_add_(0, probe_id,
                                                     ok.to(torch.int64))
    if semi is not None:
        mark = semi_mark(matches > 0, probe_keys, semi)
        pairs = None
    return pairs, ok, matches, mark, build_id


def run_unique(table: DeviceJoinTable, probe_keys, remaps, build_cols,
               live=None, residual=None, probe_cols=(),
               semi: Optional[tuple] = None):
    """Probe a unique build: at most one match per probe row, so the output
    keeps the probe batch's shape.  ``residual`` reads ``probe_cols`` ++ the
    gathered build columns.  Returns (build_out, ok_live, mark, bid):
    build columns gathered per probe row (valid folds the match mask), the
    per-probe match mask & live, the semi-join mark when ``semi`` is set
    (then ``build_out`` is None), and the build row each probe row looked
    up (meaningful where ``ok_live``)."""
    dev = probe_keys[0][0].device
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
    else:
        # sorted-hash branch: binary search in the sorted build hashes
        h, pkeys = _probe_hash(probe_keys, remaps)
        skey = _order_key(table.sorted_hash).contiguous()
        pos = torch.clamp(torch.searchsorted(skey, _order_key(h)), 0,
                          nb - 1)
        ok = (table.sorted_hash[pos] == h) & ~_is_sentinel(h)
        bid = table.perm[pos]
        for pk, bk in zip(pkeys, table.key_datas):
            ok = ok & ~K._neq(pk, bk[bid])
    if residual is not None:
        np_cols = len(probe_cols)
        cols = (list(probe_cols)
                + _gather(build_cols, bid, residual.refs, np_cols))
        ok = _apply_residual(residual, ok, cols)
    ok_live = ok if live is None else (ok & live)
    if semi is not None:
        return None, ok_live, semi_mark(ok, probe_keys, semi), bid
    out = [(d[bid], ok_live if v is None else (v[bid] & ok_live))
           for d, v in build_cols]
    return out, ok_live, None, bid


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

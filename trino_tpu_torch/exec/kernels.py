"""Relational tensor kernels: hashing, grouping, grouped reduction, sort.

The port of the reference ``exec/kernels.py`` (the subset the ported
operators use).  Conventions:

- key/value columns travel as ``(data, valid)`` pairs (valid None = all
  valid), exactly as in the reference;
- 64-bit hashes are carried as int64 tensors holding the uint64 bit
  patterns: two's-complement multiply wraps like uint64, and right shifts
  are masked (:func:`_shr`) so they are logical.  torch has no uint64 shift
  or searchsorted, hence the convention;
- key planes are int32 tensors holding the reference's uint32 bit patterns.

Grouping on keys that are not small dictionary codes goes through the
open-addressing :func:`hash_group_ids` (the ``hash_insert`` kernel); there
is no sort-path alternative in the port.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops import gpu_kernels as GK

__all__ = [
    "bucket", "key_planes", "hash_combine", "hash_row_gids",
    "hash_group_ids", "small_codes_group_space", "small_grouped_aggregate",
    "grouped_reduce", "finalize_groups", "group_keys_out", "device_sort",
    "lexsort",
]


def bucket(n: int, minimum: int = 8) -> int:
    """Round up to a power of two."""
    c = minimum
    while c < n:
        c <<= 1
    return c


def _canon_float(x):
    """-0.0 -> +0.0 and every NaN -> the one canonical NaN, so hashing and
    grouping agree with SQL equality (NaN is one GROUP BY value)."""
    x = torch.where(x == 0, torch.zeros((), dtype=x.dtype, device=x.device),
                    x)
    return torch.where(torch.isnan(x),
                       torch.full((), float("nan"), dtype=x.dtype,
                                  device=x.device), x)


def _neq(a, b):
    """Elementwise 'different key' compare: IEEE != except NaN == NaN."""
    r = a != b
    if a.is_floating_point():
        r = r & ~(torch.isnan(a) & torch.isnan(b))
    return r


# ---------------------------------------------------------------------------
# 64-bit hashing on int64 bit patterns (reference: kernels.py:1297-1353)

def _s64(u: int) -> int:
    """uint64 constant -> the int64 with the same bits."""
    return u - (1 << 64) if u >= (1 << 63) else u


_M1 = _s64(0xBF58476D1CE4E5B9)
_M2 = _s64(0x94D049BB133111EB)
_GOLDEN = _s64(0x9E3779B97F4A7C15)
_U32 = 0xFFFFFFFF


def _shr(h, k: int):
    """Logical right shift of uint64 bits held in int64."""
    return (h >> k) & ((1 << (64 - k)) - 1)


def _mix64(h):
    h = (h ^ _shr(h, 30)) * _M1
    h = (h ^ _shr(h, 27)) * _M2
    return h ^ _shr(h, 31)


def _f32_bits(w):
    """float32 tensor -> its bit pattern as a non-negative int64."""
    return w.view(torch.int32).to(torch.int64) & _U32


def _f64_words(c):
    """Range-reduced three-float32 cascade + class/tag meta word of a
    canonical float64 column (reference: _f64_key_planes / _f64_hash_word):
    equal doubles give equal words, distinct doubles distinct words."""
    fin = torch.isfinite(c)
    mag = torch.abs(c)
    safe_mag = torch.where(mag > 0, mag, torch.ones_like(mag))
    cls = torch.clamp(torch.floor(torch.log2(safe_mag) / 120.0), -9.0, 9.0)
    s = torch.pow(2.0, -60.0 * cls)  # applied twice; 2**(-120*cls) overflows
    scaled = torch.where(fin, c * s * s, torch.zeros_like(c))
    w1 = scaled.to(torch.float32)
    r1 = scaled - w1.to(torch.float64)
    w2 = r1.to(torch.float32)
    r2 = r1 - w2.to(torch.float64)
    w3 = r2.to(torch.float32)
    tag = torch.where(torch.isnan(c), 3, torch.where(
        c == float("inf"), 1, torch.where(c == float("-inf"), 2, 0)))
    meta = (cls.to(torch.int64) + 16) | (tag.to(torch.int64) << 8)
    return w1, w2, w3, meta & _U32


def _f64_hash_word(a):
    w1, w2, w3, meta = _f64_words(a)
    lo = _f32_bits(w1) | (_f32_bits(w2) << 32)
    hi = _f32_bits(w3) | (meta << 32)
    return _mix64(lo) ^ hi


def hash_combine(datas: Sequence) -> torch.Tensor:
    """Combine key columns into one 64-bit hash lane (splitmix64 mix),
    bit-identical to the reference's uint64 result."""
    h = torch.zeros(datas[0].shape, dtype=torch.int64,
                    device=datas[0].device)
    for x in datas:
        if x.dtype == torch.bool:
            x = x.to(torch.int64)
        elif x.is_floating_point():
            x = _f64_hash_word(_canon_float(x.to(torch.float64)))
        else:
            x = x.to(torch.int64)
        h = _mix64(h ^ (x + _GOLDEN))
    return h


def _i32_bits(x):
    """Low 32 bits of an int64 tensor as an int32 tensor (same bits)."""
    x = x & _U32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def key_planes(keys: Sequence[tuple]) -> list:
    """Key columns -> 32-bit planes (int32 bit patterns) whose elementwise
    equality is exactly SQL group-key equality: ints/bools split into lo/hi
    words, floats canonicalized then split into the injective w1/w2/w3/meta
    cascade, nullable keys zero their data planes and append a validity
    plane (NULL is its own group)."""
    out: list = []
    for d, v in keys:
        if d.is_floating_point():
            w1, w2, w3, meta = _f64_words(_canon_float(d.to(torch.float64)))
            kp = [w1.view(torch.int32), w2.view(torch.int32),
                  w3.view(torch.int32), _i32_bits(meta)]
        elif d.dtype == torch.bool:
            kp = [d.to(torch.int32)]
        else:
            x = d.to(torch.int64)
            kp = [_i32_bits(x), _i32_bits(_shr(x, 32))]
        if v is not None:
            kp = [torch.where(v, p, torch.zeros((), dtype=p.dtype,
                                                device=p.device))
                  for p in kp]
            kp.append(v.to(torch.int32))
        out.extend(kp)
    return out


def slot_hash32(h):
    """uint64 hash (int64 bits) -> the 32-bit slot hash h ^ (h >> 32)."""
    return _i32_bits(h ^ _shr(h, 32))


def hash_row_gids(keys: Sequence[tuple], live=None):
    """Per-row dense group ids in first-occurrence order via the
    ``hash_insert`` kernel.  Returns (row_gid, count): dead rows get the
    table size (>= any real id)."""
    n = int(keys[0][0].shape[0])
    S = bucket(2 * max(n, 1))
    planes = key_planes(keys)
    h32 = slot_hash32(hash_combine(planes))
    row_gid, count, _table, _sgid = GK.hash_insert(
        torch.stack(planes), h32, live, S)
    return row_gid, count


def hash_group_ids(keys: Sequence[tuple], live=None) -> tuple:
    """(perm, gid, num_groups): ``perm`` orders rows so equal keys are
    adjacent (stable, dead rows last), ``gid`` is the nondecreasing group id
    per sorted row, dead rows have gid >= num_groups."""
    n = int(keys[0][0].shape[0])
    dev = keys[0][0].device
    if n == 0:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev), 0)
    row_gid, count = hash_row_gids(keys, live)
    perm = torch.argsort(row_gid, stable=True)
    return perm, row_gid[perm], count


# ---------------------------------------------------------------------------
# small dictionary-code group spaces (reference: kernels.py:366-625)

SMALL_CODES_LIMIT = 4096  # max fused-code group space for the code path


def small_codes_group_space(key_cols, limit: int = SMALL_CODES_LIMIT):
    """The static group-space size when every key is a dictionary code of
    a small dictionary, else None."""
    total = 1
    for c in key_cols:
        d = c.dictionary
        if d is None or len(d) == 0:
            return None
        total *= len(d) + (1 if c.valid is not None else 0)
        if total > limit:
            return None
    return total


def _code_layout(sizes: tuple, has_valid: tuple):
    slots = tuple(s + 1 if hv else s for s, hv in zip(sizes, has_valid))
    total = 1
    for s in slots:
        total *= s
    strides = []
    acc = 1
    for s in reversed(slots):
        strides.append(acc)
        acc *= s
    return slots, tuple(reversed(strides)), total


def _reduce_into(fn: str, gid, data, valid, n_out: int, dtype):
    """One aggregate over rows with group id ``gid`` into ``n_out`` slots
    (the last slot takes dead rows).  Returns (values, any-valid|None)."""
    dev = gid.device
    if fn == "count_star":
        return torch.zeros(n_out, dtype=torch.int64, device=dev).index_add_(
            0, gid, torch.ones_like(gid)), None
    m = valid
    if fn == "count":
        ones = (torch.ones_like(gid) if m is None else m.to(torch.int64))
        return torch.zeros(n_out, dtype=torch.int64, device=dev).index_add_(
            0, gid, ones), None
    anyv = None
    if m is not None:
        anyv = torch.zeros(n_out, dtype=torch.int64, device=dev).index_add_(
            0, gid, m.to(torch.int64)) > 0
    if fn == "sum":
        x = data.to(dtype)
        if m is not None:
            x = torch.where(m, x, torch.zeros((), dtype=dtype, device=dev))
        return torch.zeros(n_out, dtype=dtype, device=dev).index_add_(
            0, gid, x), anyv
    if fn in ("min", "max"):
        x = data
        big = (torch.finfo(x.dtype) if x.is_floating_point()
               else torch.iinfo(x.dtype))
        init = big.max if fn == "min" else big.min
        if m is not None:
            x = torch.where(m, x, torch.full((), init, dtype=x.dtype,
                                             device=dev))
        out = torch.full((n_out,), init, dtype=x.dtype, device=dev)
        out.scatter_reduce_(0, gid, x, "amin" if fn == "min" else "amax")
        if anyv is None:
            anyv = torch.zeros(n_out, dtype=torch.int64,
                               device=dev).index_add_(
                0, gid, torch.ones_like(gid)) > 0
        return out, anyv
    raise NotImplementedError(f"aggregate {fn}")


def _prep(data, pre):
    if pre is None:
        return data
    if pre[0] == "scale":
        return data.to(torch.float64) / (10.0 ** pre[1])
    raise NotImplementedError(f"aggregate prep {pre}")


def small_grouped_aggregate(key_cols, live, aggs: Sequence[tuple], n: int,
                            dev):
    """Group-by over ``n`` rows on small dictionary-code keys (or none: a
    global aggregate) with no sort: the group id is code arithmetic, every
    aggregate a scatter-add into the static group space.
    aggs: [(fn, data|None, valid|None, dtype, distinct[, pre])].
    Returns (results, presence|None, keys_out, num_groups)."""
    num_keys = len(key_cols)
    has_valid = tuple(c.valid is not None for c in key_cols)
    sizes = tuple(len(c.dictionary) for c in key_cols)
    slots, strides, total = _code_layout(sizes, has_valid)
    fused = torch.zeros(n, dtype=torch.int64, device=dev)
    for c, s, st in zip(key_cols, sizes, strides):
        code = torch.clamp(c.data.to(torch.int64), 0, s - 1)
        if c.valid is not None:
            code = torch.where(c.valid, code, s)
        fused = fused + code * st
    if live is not None:
        fused = torch.where(live, fused, total)  # dead rows -> trash slot
    results = []
    for entry in aggs:
        fn, data, valid, dtype, distinct = entry[:5]
        pre = entry[5] if len(entry) > 5 else None
        if distinct and data is not None:
            d, v = _distinct_reduce(fn, fused, _prep(data, pre), valid,
                                    total + 1, _torch_dtype(dtype))
        else:
            if fn == "count_star" or data is None:
                fn = "count_star" if valid is None else "count"
            d, v = _reduce_into(fn, fused, None if data is None
                                else _prep(data, pre), valid, total + 1,
                                _torch_dtype(dtype))
        if fn in ("sum", "min", "max") and v is None:
            # an empty group's sum/min/max is NULL, not the fill value
            v = torch.zeros(total + 1, dtype=torch.int64,
                            device=dev).index_add_(
                0, fused, torch.ones_like(fused)) > 0
        results.append((d[:total], None if v is None else v[:total]))
    rows = torch.zeros(total + 1, dtype=torch.int64, device=dev).index_add_(
        0, fused, torch.ones_like(fused))[:total]
    presence = rows > 0 if num_keys else None
    r = torch.arange(total, dtype=torch.int64, device=dev)
    keys_out = []
    for s, sl, st, hv in zip(sizes, slots, strides, has_valid):
        ck = torch.remainder(torch.div(r, st, rounding_mode="floor"), sl)
        if hv:
            keys_out.append((torch.clamp(ck, max=s - 1).to(torch.int32),
                             ck < s))
        else:
            keys_out.append((ck.to(torch.int32), None))
    return results, presence, keys_out, total


def _torch_dtype(dtype):
    from ..spi.batch import torch_dtype

    return dtype if isinstance(dtype, torch.dtype) else torch_dtype(dtype)


# ---------------------------------------------------------------------------
# grouped reduction over (perm, gid) (reference: kernels.py:1000)


def _distinct_reduce(fn: str, g, data, valid, n_out: int, dtype):
    """count/sum DISTINCT into ``n_out`` slots (reference: the ``distinct``
    branch of _reduce_fn): sort rows by (group, validity, value), keep the
    first row of each run, and reduce only the kept valid rows."""
    if data.is_floating_point():
        data = _canon_float(data)  # NaN is ONE distinct value
    order = lexsort([data] + ([valid] if valid is not None else []) + [g])
    d2, g2 = data[order], g[order]
    first = torch.ones(d2.shape, dtype=torch.bool, device=d2.device)
    first[1:] = _neq(d2[1:], d2[:-1]) | (g2[1:] != g2[:-1])
    keep = first
    if valid is not None:
        v2 = valid[order]
        first[1:] |= v2[1:] != v2[:-1]
        keep = first & v2
    if fn == "count":
        return torch.zeros(n_out, dtype=torch.int64,
                           device=g.device).index_add_(
            0, g2, keep.to(torch.int64)), None
    if fn == "sum":
        return _reduce_into("sum", g2, d2, keep, n_out, dtype)
    raise NotImplementedError(f"distinct {fn}")


def _real_sum(g, cap: int, data, valid):
    """The REAL-sum route: the ``masked_segment_sum_f32`` kernel over the
    sorted rows (``g`` carries dead rows at an id >= the group count, which
    the kernel skips) and the any-valid bit as a scatter-add."""
    vals = data.to(torch.float32).contiguous()
    g32 = g.to(torch.int32)
    s = GK.masked_segment_sum_f32(vals, g32, valid, cap)
    anyv = None
    if valid is not None:
        anyv = torch.zeros(cap + 1, dtype=torch.int64,
                           device=g.device).index_add_(
            0, g, valid.to(torch.int64)) > 0
    return s, anyv


def grouped_reduce(perm, gid, num_groups: int, aggs: Sequence[tuple]):
    """aggs: [(fn, data|None, valid|None, dtype, distinct[, pre]), ...] over
    ORIGINAL row order; ``perm``/``gid`` from :func:`hash_group_ids`.
    Returns per-agg (values, valid|None) of length ``num_groups``.

    A non-distinct REAL sum over at most 64 groups (``bucket(num_groups)``)
    goes through the ``masked_segment_sum_f32`` kernel, as in the
    reference."""
    cap = bucket(num_groups)
    g = torch.clamp(gid.to(torch.int64), max=num_groups)  # dead -> trash
    out = []
    for entry in aggs:
        fn, data, valid, dtype, distinct = entry[:5]
        pre = entry[5] if len(entry) > 5 else None
        tdtype = _torch_dtype(dtype)
        v = None if valid is None else valid[perm].contiguous()
        if (fn == "sum" and data is not None and not distinct and pre is None
                and tdtype == torch.float32
                and cap <= GK.SEGMENT_SUM_MAX_GROUPS):
            vals, anyv = _real_sum(g, cap, data[perm], v)
        elif distinct and data is not None:
            vals, anyv = _distinct_reduce(fn, g, _prep(data[perm], pre), v,
                                          num_groups + 1, tdtype)
        else:
            if fn == "count_star" or data is None:
                fn = "count_star" if valid is None else "count"
            d = None if data is None else _prep(data[perm], pre)
            vals, anyv = _reduce_into(fn, g, d, v, num_groups + 1, tdtype)
        out.append((vals[:num_groups],
                    None if anyv is None else anyv[:num_groups]))
    return out


def group_keys_out(perm, gid, num_groups: int, keys: Sequence[tuple]):
    """One representative key row per group: the first sorted row."""
    n = int(perm.shape[0])
    r = torch.arange(num_groups, dtype=gid.dtype, device=gid.device)
    starts = torch.clamp(torch.searchsorted(gid.contiguous(), r), max=n - 1)
    rows = perm[starts]
    return [(d[rows], None if v is None else v[rows]) for d, v in keys]


def finalize_groups(plan: Sequence[tuple], arrays: Sequence):
    """Aggregation finalization over the per-group arrays: ("copy", dtype,
    has_valid), ("avg_final", dtype, has_valid), ("count", None,
    has_valid), as in the reference's ``_finalize_fn``."""
    outs = []
    it = iter(arrays)
    for entry in plan:
        kind = entry[0]
        if kind == "copy":
            _, dtype, has_valid = entry
            d = next(it)
            v = next(it) if has_valid else None
            if dtype is not None:
                d = d.to(_torch_dtype(dtype))
            outs.append((d, v))
        elif kind == "count":
            _, _, has_valid = entry
            d = next(it)
            if has_valid:
                next(it)  # counts are never NULL
            outs.append((d.to(torch.int64), None))
        elif kind == "avg_final":
            _, dtype, has_valid = entry
            s = next(it)
            sv = next(it) if has_valid else None
            c = next(it)
            vals = s / torch.clamp(c, min=1)
            valid = c > 0
            if sv is not None:
                valid = valid & sv
            outs.append((vals.to(_torch_dtype(dtype)), valid))
        else:
            raise NotImplementedError(kind)
    return outs


# ---------------------------------------------------------------------------
# sort (reference: kernels.py:1165-1291)


def lexsort(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """np.lexsort semantics (the LAST column is the primary key) as chained
    stable sorts."""
    n = int(cols[0].shape[0])
    perm = torch.arange(n, device=cols[0].device)
    for c in cols:
        if c.dtype == torch.bool:
            c = c.to(torch.int8)
        perm = perm[torch.sort(c[perm], stable=True).indices]
    return perm


def _sort_columns(keys: Sequence[tuple]):
    """Lexsort columns for [(data, valid, ascending, nulls_first)] keys in
    major-to-minor order (reference: _sort_columns)."""
    sort_cols = []
    for data, valid, ascending, nulls_first in reversed(list(keys)):
        d = data
        if not ascending:
            if d.dtype == torch.bool:
                d = ~d
            elif d.is_floating_point():
                d = -d.to(torch.float64)
            else:
                d = ~d.to(torch.int64)  # bijective order reversal
        if valid is not None:
            d = torch.where(valid, d, torch.zeros((), dtype=d.dtype,
                                                  device=d.device))
        nan_rank = None
        if d.is_floating_point():
            nan = torch.isnan(d)
            nan_rank = torch.where(nan, 1 if ascending else 0,
                                   0 if ascending else 1)
            d = torch.where(nan, torch.zeros((), dtype=d.dtype,
                                             device=d.device), d)
        sort_cols.append(d)
        if nan_rank is not None:
            sort_cols.append(nan_rank)
        if valid is not None:
            null_rank = (torch.where(valid, 1, 0) if nulls_first
                         else torch.where(valid, 0, 1))
            sort_cols.append(null_rank)
    return sort_cols


def device_sort(keys: Sequence[tuple], cols: Sequence[tuple], live,
                out_n: Optional[int] = None):
    """Sort payload ``cols`` by ``keys``; dead rows sort last, ``out_n``
    keeps the first rows (top-N).  Returns (sorted cols, sorted live)."""
    sort_cols = _sort_columns(keys)
    if live is not None:
        sort_cols.append(~live)  # most significant: dead rows last
    perm = lexsort(sort_cols)
    if out_n is not None:
        perm = perm[:out_n]
    outs = [(d[perm], None if v is None else v[perm]) for d, v in cols]
    return outs, (None if live is None else live[perm])


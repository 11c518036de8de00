"""Hand-written Hopper kernels: the open-addressing hash table and the
masked per-group float32 sum.

Ports the Pallas kernels of the reference ``trino_tpu/ops/pallas_kernels.py``:

- :func:`hash_insert` replaces ``_hash_insert_kernel`` (``hash_insert``):
  build a linear-probing table over [P, N] 32-bit key planes and give every
  row a dense group id in first-occurrence order;
- :func:`hash_probe` replaces ``_hash_probe_kernel`` (``hash_probe``):
  look rows up in a built table (group id, or -1 for a miss / dead row);
- :func:`masked_segment_sum_f32` replaces ``_segment_sum_kernel``
  (``masked_segment_sum_f32``): per-group float32 sums under a live mask,
  at most 64 groups.

The CUDA sources are ``csrc/*.cu`` (each header comment states the design
and what bounds it); :func:`build_library` compiles them with ``nvcc`` for
``sm_90a`` into one library under ``build/kernels/`` at first use, and it is
bound with ctypes.  Planes and slot hashes are int32 tensors holding the
reference's uint32 bit patterns.

Each wrapper launches its kernel for a CUDA tensor and takes the plain torch
version for a CPU tensor; there is no fallback between the two.  ``LAUNCHES``
counts kernel launches per wrapper (plain calls are not counted).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

__all__ = ["hash_insert", "hash_probe", "hash_insert_plain",
           "hash_probe_plain", "masked_segment_sum_f32",
           "masked_segment_sum_f32_plain", "build_library", "LAUNCHES",
           "reset_launch_counts", "SEGMENT_SUM_MAX_GROUPS"]

LAUNCHES = {"hash_insert": 0, "hash_probe": 0, "masked_segment_sum_f32": 0}

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = (Path(__file__).resolve().parent.parent.parent / "build"
              / "kernels")
_LIB_NAME = "libtrino_kernels.so"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC"]
_INT32_MAX = 2**31 - 1
SEGMENT_SUM_MAX_GROUPS = 64

_LIB = None
_LIB_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cand = Path("/usr/local/cuda/bin/nvcc")
    return str(cand) if cand.exists() else "nvcc"


def _run_all(cmds: list) -> list:
    """Start every command at once; wait for all; raise on any failure.
    Returns each command's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errs = [p.communicate()[1] for p in procs]  # every process ends here
    for cmd, p, err in zip(cmds, procs, errs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({p.returncode}):"
                               f"\n{err}")
    return errs


def build_library(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` into one library under ``build/kernels/``
    (one ``nvcc`` per source, all started together, then one link).  The
    build is skipped when the library is newer than every source.  Returns
    the library path."""
    out = _BUILD_DIR / _LIB_NAME
    srcs = sorted(_CSRC.glob("*.cu"))
    if out.exists() and all(out.stat().st_mtime >= s.stat().st_mtime
                            for s in srcs):
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [_BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    ptxas = ["-Xptxas", "-v"] if verbose else []
    errs = _run_all([[_nvcc(), *_NVCC_FLAGS, *ptxas, "-c", "-o", str(o),
                      str(s)] for s, o in zip(srcs, objs)])
    tmp = out.with_suffix(f".{tag}.tmp")
    _run_all([[_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]])
    for o in objs:
        o.unlink()
    if verbose:
        for s, e in zip(srcs, errs):
            if e.strip():
                print(f"{s.name}:\n{e.strip()}")
    os.replace(tmp, out)
    return out


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.hash_insert_launch.argtypes = [p, i, i64, p, p, i64, p, p, p,
                                               p]
            lib.hash_insert_launch.restype = i
            lib.hash_probe_launch.argtypes = [p, p, i64, p, i, i64, p, p, p,
                                              p]
            lib.hash_probe_launch.restype = i
            lib.segment_sum_launch.argtypes = [p, p, p, i64, i, i, p, p, p]
            lib.segment_sum_launch.restype = i
            _LIB = lib
    return _LIB


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _check_inputs(planes, hash32, live) -> int:
    if planes.dim() != 2 or planes.dtype != torch.int32:
        raise TypeError("planes must be a [P, N] int32 tensor")
    n = int(planes.shape[1])
    if hash32.shape != (n,) or hash32.dtype != torch.int32:
        raise TypeError("hash32 must be an [N] int32 tensor")
    if live.shape != (n,) or live.dtype != torch.bool:
        raise TypeError("live must be an [N] bool tensor")
    devs = {planes.device, hash32.device, live.device}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if n > _INT32_MAX:
        raise ValueError("more than 2^31 - 1 rows")
    return n


def _assemble(planes, owner, row_slot, first_row, S: int):
    """Shared finish of both insert versions (outside the kernels): rank
    the occupied slots by their first row, so ids follow first-occurrence
    order (the serial TPU kernel's numbering); map every row to its slot's
    id; gather the owners' planes into the table."""
    dev = planes.device
    occ_slots = torch.nonzero(owner >= 0).flatten()
    count = int(occ_slots.numel())
    slot_gid = torch.full((S,), -1, dtype=torch.int32, device=dev)
    order = torch.argsort(first_row[occ_slots])
    slot_gid[occ_slots[order]] = torch.arange(count, dtype=torch.int32,
                                              device=dev)
    live_rows = row_slot >= 0
    safe = torch.where(live_rows, row_slot, 0).long()
    row_gid = torch.where(live_rows, slot_gid[safe],
                          torch.tensor(S, dtype=torch.int32, device=dev))
    table = torch.zeros((planes.shape[0], S), dtype=torch.int32, device=dev)
    if count:
        table[:, occ_slots] = planes[:, owner[occ_slots].long()]
    return row_gid, count, table, slot_gid


# ---------------------------------------------------------------------------
# plain torch versions (the same algorithm, vectorized in rounds)


def hash_insert_plain(planes, hash32, live, num_slots: int):
    """Linear-probing insert in rounds: every unfinished row proposes its
    current slot; an empty slot goes to its lowest proposing row; rows that
    meet an owner with equal planes stop, the rest step to the next slot."""
    S = int(num_slots)
    dev = planes.device
    n = int(planes.shape[1])
    mask = S - 1
    owner = torch.full((S,), -1, dtype=torch.int32, device=dev)
    row_slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    active = torch.nonzero(live).flatten()
    slot = (hash32[active].long() & mask)
    while active.numel():
        # claim: empty proposed slots go to the smallest proposing row
        empty = owner[slot] < 0
        if bool(empty.any()):
            cand = torch.full((S,), _INT32_MAX, dtype=torch.int64,
                              device=dev)
            cand.scatter_reduce_(0, slot[empty], active[empty], "amin")
            won = cand < _INT32_MAX
            owner[won] = cand[won].to(torch.int32)
        own = owner[slot].long()
        eq = (planes[:, active] == planes[:, own]).all(dim=0)
        row_slot[active[eq]] = slot[eq].to(torch.int32)
        active, slot = active[~eq], (slot[~eq] + 1) & mask
    first_row = torch.full((S,), _INT32_MAX, dtype=torch.int64, device=dev)
    done = row_slot >= 0
    first_row.scatter_reduce_(0, row_slot[done].long(),
                              torch.nonzero(done).flatten(), "amin")
    return _assemble(planes, owner, row_slot, first_row, S)


def hash_probe_plain(table_planes, slot_gid, planes, hash32, live):
    """Read-only lookup in rounds (gid, or -1 for a miss or a dead row)."""
    S = int(slot_gid.shape[0])
    mask = S - 1
    n = int(planes.shape[1])
    gid = torch.full((n,), -1, dtype=torch.int32, device=planes.device)
    active = torch.nonzero(live).flatten()
    slot = hash32[active].long() & mask
    while active.numel():
        g = slot_gid[slot]
        empty = g < 0
        eq = (table_planes[:, slot] == planes[:, active]).all(dim=0) & ~empty
        gid[active[eq]] = g[eq]
        keep = ~(eq | empty)
        active, slot = active[keep], (slot[keep] + 1) & mask
    return gid


# ---------------------------------------------------------------------------
# wrappers


def hash_insert(planes, hash32, live: Optional[torch.Tensor], num_slots: int):
    """Build an open-addressing table over ``planes`` [P, N] int32 key
    planes (plane equality == key equality), ``hash32`` [N] int32 slot
    hashes, ``live`` [N] bool (None = all live).  ``num_slots`` must be a
    power of two >= 2 * N (all rows, dead ones included, so the check needs
    no device-to-host sync).

    Returns (row_gid, count, table_planes, slot_gid): ``row_gid`` [N] int32
    dense ids in first-occurrence order (dead rows get ``num_slots``);
    ``count`` the number of groups (host int); the last two are the table
    state for :func:`hash_probe`."""
    S = int(num_slots)
    if S <= 0 or S & (S - 1):
        raise ValueError(f"num_slots must be a power of two, got {S}")
    if live is None:
        live = torch.ones(planes.shape[1], dtype=torch.bool,
                          device=planes.device)
    n = _check_inputs(planes, hash32, live)
    if S < 2 * n:
        raise ValueError(f"num_slots {S} < 2 x {n} rows")
    if planes.device.type == "cpu":
        return hash_insert_plain(planes, hash32, live, S)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    planes = planes.contiguous()
    hash32 = hash32.contiguous()
    live = live.contiguous()
    dev = planes.device
    owner = torch.full((S,), -1, dtype=torch.int32, device=dev)
    row_slot = torch.empty((n,), dtype=torch.int32, device=dev)
    first_row = torch.full((S,), _INT32_MAX, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check(_lib().hash_insert_launch(
        planes.data_ptr(), int(planes.shape[0]), n, hash32.data_ptr(),
        live.data_ptr(), S, owner.data_ptr(), row_slot.data_ptr(),
        first_row.data_ptr(), stream), "hash_insert")
    LAUNCHES["hash_insert"] += 1
    return _assemble(planes, owner, row_slot, first_row, S)


def hash_probe(table_planes, slot_gid, planes, hash32,
               live: Optional[torch.Tensor] = None):
    """Look up [P, N] ``planes`` rows in a table built by
    :func:`hash_insert`.  Returns [N] int32 group ids; -1 = miss or dead."""
    if live is None:
        live = torch.ones(planes.shape[1], dtype=torch.bool,
                          device=planes.device)
    n = _check_inputs(planes, hash32, live)
    S = int(slot_gid.shape[0])
    if S <= 0 or S & (S - 1):
        raise ValueError(f"table size must be a power of two, got {S}")
    if (table_planes.dtype != torch.int32 or slot_gid.dtype != torch.int32
            or table_planes.shape != (planes.shape[0], S)):
        raise TypeError("table must be [P, S] int32 planes + [S] int32 ids")
    if table_planes.device != planes.device or \
            slot_gid.device != planes.device:
        raise ValueError("table and probe rows on different devices")
    if planes.device.type == "cpu":
        return hash_probe_plain(table_planes, slot_gid, planes, hash32, live)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    table_planes = table_planes.contiguous()
    slot_gid = slot_gid.contiguous()
    planes = planes.contiguous()
    hash32 = hash32.contiguous()
    live = live.contiguous()
    gid = torch.empty((n,), dtype=torch.int32, device=planes.device)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    _check(_lib().hash_probe_launch(
        table_planes.data_ptr(), slot_gid.data_ptr(), S, planes.data_ptr(),
        int(planes.shape[0]), n, hash32.data_ptr(), live.data_ptr(),
        gid.data_ptr(), stream), "hash_probe")
    LAUNCHES["hash_probe"] += 1
    return gid


# ---------------------------------------------------------------------------
# masked per-group float32 sum


def masked_segment_sum_f32_plain(values, gid, live, num_groups: int):
    """Per-group sums of [N] float32 ``values`` by [N] int32 ``gid``: rows
    that are dead (``live`` False) or whose id lies outside [0, G) add
    nothing.  One scatter-add into G slots plus a trash slot."""
    G = int(num_groups)
    g = gid.long()
    ok = (g >= 0) & (g < G)
    if live is not None:
        ok = ok & live
    x = torch.where(ok, values, torch.zeros((), dtype=values.dtype,
                                            device=values.device))
    out = torch.zeros(G + 1, dtype=torch.float32, device=values.device)
    return out.index_add_(0, torch.where(ok, g, G), x)[:G]


# pass-1 blocks the scratch buffer holds: above the resident blocks of an
# H100 at any G (132 SMs x at most 8 blocks of 256 threads)
_SEGMENT_MAX_BLOCKS = 2048


def masked_segment_sum_f32(values, gid, live: Optional[torch.Tensor],
                           num_groups: int):
    """Per-group sums of an f32 column: [N] float32 ``values``, [N] int32
    group ids, [N] bool ``live`` (None = all live), ``num_groups`` G in
    [1, 64] -> [G] float32.  Dead rows and ids outside [0, G) add nothing.
    Inputs must be contiguous 1-D tensors of exactly these types; the CUDA
    kernel adds in a fixed order, so one input gives the same bits on every
    run."""
    G = int(num_groups)
    if not 1 <= G <= SEGMENT_SUM_MAX_GROUPS:
        raise ValueError(f"num_groups must be in [1, "
                         f"{SEGMENT_SUM_MAX_GROUPS}], got {G}")
    if values.dim() != 1 or values.dtype != torch.float32:
        raise TypeError("values must be an [N] float32 tensor")
    n = int(values.shape[0])
    if gid.shape != (n,) or gid.dtype != torch.int32:
        raise TypeError("gid must be an [N] int32 tensor")
    if live is not None and (live.shape != (n,) or live.dtype != torch.bool):
        raise TypeError("live must be an [N] bool tensor or None")
    ins = [values, gid] + ([] if live is None else [live])
    if len({t.device for t in ins}) != 1:
        raise ValueError("inputs on several devices")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("inputs must be contiguous")
    if values.device.type == "cpu":
        return masked_segment_sum_f32_plain(values, gid, live, G)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    dev = values.device
    partial = torch.empty(_SEGMENT_MAX_BLOCKS * G, dtype=torch.float32,
                          device=dev)
    out = torch.empty(G, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(_lib().segment_sum_launch(
            values.data_ptr(), gid.data_ptr(),
            None if live is None else live.data_ptr(), n, G,
            _SEGMENT_MAX_BLOCKS, partial.data_ptr(), out.data_ptr(), stream),
            "masked_segment_sum_f32")
    LAUNCHES["masked_segment_sum_f32"] += 1
    return out

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

A hash table is one [S, W] int32 bucket array (:func:`bucket_width`): word 0
the group id (-1 = empty slot), words 1..P the key planes, zeros after.  The
public table keeps the reference's layout, ``table_planes`` [P, S] and
``slot_gid`` [S], as two views of the buckets; :func:`hash_probe` takes only
such views.

Each wrapper launches its kernel for a CUDA tensor and takes the plain torch
version for a CPU tensor; there is no fallback between the two.  Inputs must
be contiguous: the wrappers raise rather than copy.  ``LAUNCHES`` counts
kernel launches per wrapper (plain calls are not counted), under a lock:
concurrent drivers launch from several threads.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

from ..caching.executable_cache import memo

__all__ = ["hash_insert", "hash_probe", "hash_insert_plain",
           "hash_probe_plain", "masked_segment_sum_f32",
           "masked_segment_sum_f32_plain", "build_library", "LAUNCHES",
           "reset_launch_counts", "SEGMENT_SUM_MAX_GROUPS", "bucket_width"]

LAUNCHES = {"hash_insert": 0, "hash_probe": 0, "masked_segment_sum_f32": 0}

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = (Path(__file__).resolve().parent.parent.parent / "build"
              / "kernels")
_LIB_NAME = "libtrino_kernels.so"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC"]
_INT32_MAX = 2**31 - 1
_MAX_SLOTS = 1 << 30  # the dead-row id S must fit an int32
SEGMENT_SUM_MAX_GROUPS = 64

_LIB = None
_LIB_LOCK = threading.Lock()
_INSERT_ROWS_PER_BLOCK = 0  # read from the library when it is loaded


_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _launched(kernel: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[kernel] += 1


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


def library_current() -> bool:
    """Whether ``build/kernels/`` holds a library newer than every
    source."""
    out = _BUILD_DIR / _LIB_NAME
    return out.exists() and all(out.stat().st_mtime >= s.stat().st_mtime
                                for s in _CSRC.glob("*.cu"))


def build_library(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` into one library under ``build/kernels/``
    (one ``nvcc`` per source, all started together, then one link).  The
    build is skipped when the library is newer than every source.  Returns
    the library path."""
    out = _BUILD_DIR / _LIB_NAME
    if library_current():
        return out
    srcs = sorted(_CSRC.glob("*.cu"))
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


def _lib(build: bool = True):
    """The kernel library, built and bound at first use.  The lock is taken
    only until then; ctypes keeps each bound function as an attribute, so a
    launch afterwards is two attribute reads.  ``build=False`` only binds:
    a worker process (execution/worker.py) never runs nvcc, since its
    coordinator builds the library before it spawns workers, and a missing
    or stale library raises instead."""
    global _LIB, _INSERT_ROWS_PER_BLOCK
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                if not build and not library_current():
                    raise RuntimeError(
                        f"the kernel library {_BUILD_DIR / _LIB_NAME} is "
                        "missing or older than its sources; the "
                        "coordinator builds it (build_library()) before it "
                        "spawns workers")
                lib = ctypes.CDLL(str(build_library()))
                p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
                lib.hash_insert_launch.argtypes = [p, i, i64, p, p, i64, p, i,
                                                   p, p, p, p, p]
                lib.hash_insert_launch.restype = i
                lib.hash_insert_rows_per_block.argtypes = []
                lib.hash_insert_rows_per_block.restype = i
                lib.hash_probe_launch.argtypes = [p, i, i64, p, i, i64, p, p,
                                                  p, p]
                lib.hash_probe_launch.restype = i
                lib.segment_sum_setup.argtypes = [i, ctypes.POINTER(i)]
                lib.segment_sum_setup.restype = i
                lib.segment_sum_launch.argtypes = [p, p, p, i64, i, i, p, p,
                                                   p]
                lib.segment_sum_launch.restype = i
                _INSERT_ROWS_PER_BLOCK = lib.hash_insert_rows_per_block()
                _LIB = lib
    return _LIB


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _stream(device_index: int) -> int:
    """The raw handle of the current stream on a CUDA device: the same
    handle as ``torch.cuda.current_stream().cuda_stream`` without building
    a Stream object, which costs several microseconds a call (chip_smoke.py
    prints both beside the probe)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def _check_rows(planes, hash32, live) -> int:
    """[P, N] int32 planes, [N] int32 hash32, [N] bool live (or None), all
    contiguous and on one device.  Returns N."""
    if planes.dtype is not torch.int32 or planes.ndim != 2:
        raise TypeError("planes must be a [P, N] int32 tensor")
    n = planes.shape[1]
    if hash32.dtype is not torch.int32 or hash32.shape != (n,):
        raise TypeError("hash32 must be an [N] int32 tensor")
    if live is not None and (live.dtype is not torch.bool
                             or live.shape != (n,)):
        raise TypeError("live must be an [N] bool tensor or None")
    dev = planes.get_device()
    if hash32.get_device() != dev or (live is not None
                                      and live.get_device() != dev):
        raise ValueError("inputs on several devices")
    if not (planes.is_contiguous() and hash32.is_contiguous()
            and (live is None or live.is_contiguous())):
        raise ValueError("inputs must be contiguous")
    return n


def bucket_width(P: int) -> int:
    """Words per bucket for P key planes: the id plus the planes, rounded
    up to a whole number of 16-byte loads."""
    return 4 * ((P + 4) // 4)


def _new_buckets(S: int, P: int, device) -> torch.Tensor:
    """Empty [S, W] bucket storage: ids -1, planes 0 (the plain version's
    fill; the CUDA insert fills its own)."""
    buckets = torch.zeros((S, bucket_width(P)), dtype=torch.int32,
                          device=device)
    buckets[:, 0] = -1
    return buckets


def _views(buckets, P: int):
    """hash_insert's public table: [P, S] planes and [S] ids, as views of
    the bucket storage (the reference's layout and values)."""
    return buckets[:, 1:P + 1].t(), buckets[:, 0]


def _bucket_layout(table_planes, slot_gid, P: int) -> tuple:
    """(S, W) of the bucket storage behind hash_insert's two views; raises
    on any other table (a probe never repacks one).  The views share one
    storage exactly when the planes start one word after the ids, with the
    bucket stride, inside the ids' storage."""
    if (table_planes.dtype is not torch.int32
            or slot_gid.dtype is not torch.int32
            or table_planes.ndim != 2 or slot_gid.ndim != 1):
        raise TypeError("table must be hash_insert's [P, S] int32 planes "
                        "and [S] int32 ids")
    S = slot_gid.shape[0]
    W = bucket_width(P)
    base = slot_gid.data_ptr()
    if (table_planes.shape != (P, S) or S <= 0 or S & (S - 1)
            or slot_gid.stride() != (W,) or table_planes.stride() != (1, W)
            or table_planes.data_ptr() != base + 4 or base % 16
            or slot_gid.untyped_storage().nbytes()
            < (slot_gid.storage_offset() + S * W) * 4):
        raise ValueError("table is not the bucket storage hash_insert "
                         f"returns for {P} planes ([S, {W}] int32 buckets, "
                         "16-byte aligned)")
    return S, W


# ---------------------------------------------------------------------------
# plain torch versions (the same algorithm, vectorized in rounds)


def hash_insert_plain(planes, hash32, live, num_slots: int,
                      count_on_device: bool = False):
    """Linear-probing insert in rounds: every unfinished row proposes its
    current slot; an empty slot goes to its lowest proposing row; rows that
    meet an owner with equal planes stop, the rest step to the next slot.
    Then the kernels' numbering: a row is the first of its key when it is
    the smallest row in its slot, and a first row's id is the count of first
    rows before it (a cumulative sum over the flags)."""
    S = int(num_slots)
    dev = planes.device
    P, n = planes.shape
    mask = S - 1
    owner = torch.full((S,), -1, dtype=torch.int32, device=dev)
    row_slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    active = (torch.arange(n, device=dev) if live is None
              else torch.nonzero(live).flatten())
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
        row_slot[active[eq]] = slot[eq]
        active, slot = active[~eq], (slot[~eq] + 1) & mask
    done = row_slot >= 0
    safe = torch.where(done, row_slot, 0)
    rows = torch.arange(n, device=dev)
    first_row = torch.full((S,), _INT32_MAX, dtype=torch.int64, device=dev)
    first_row.scatter_reduce_(0, safe[done], rows[done], "amin")
    flag = done & (first_row[safe] == rows)
    rank = torch.cumsum(flag, 0) - 1
    buckets = _new_buckets(S, P, dev)
    first = row_slot[flag]
    buckets[first, 0] = rank[flag].to(torch.int32)
    buckets[first, 1:P + 1] = planes[:, flag].t()
    row_gid = torch.where(done, buckets[safe, 0],
                          torch.tensor(S, dtype=torch.int32, device=dev))
    count = flag.sum().to(torch.int32)
    return (row_gid, count if count_on_device else int(count),
            *_views(buckets, P))


def hash_probe_plain(table_planes, slot_gid, planes, hash32, live):
    """Read-only lookup in rounds (gid, or -1 for a miss or a dead row)."""
    P, n = planes.shape
    S, W = _bucket_layout(table_planes, slot_gid, P)
    buckets = slot_gid.as_strided((S, W), (W, 1))
    mask = S - 1
    gid = torch.full((n,), -1, dtype=torch.int32, device=planes.device)
    active = (torch.arange(n, device=planes.device) if live is None
              else torch.nonzero(live).flatten())
    slot = hash32[active].long() & mask
    while active.numel():
        b = buckets[slot]
        g = b[:, 0]
        empty = g < 0
        eq = (b[:, 1:P + 1] == planes[:, active].t()).all(dim=1) & ~empty
        gid[active[eq]] = g[eq]
        keep = ~(eq | empty)
        active, slot = active[keep], (slot[keep] + 1) & mask
    return gid


# ---------------------------------------------------------------------------
# wrappers


def hash_insert(planes, hash32, live: Optional[torch.Tensor], num_slots: int,
                count_on_device: bool = False):
    """Build an open-addressing table over ``planes`` [P, N] int32 key
    planes (plane equality == key equality), ``hash32`` [N] int32 slot
    hashes, ``live`` [N] bool (None = all live), all contiguous.
    ``num_slots`` must be a power of two in [2 * N, 2^30] (N counts all
    rows, dead ones included, so the check needs no device-to-host sync).

    Returns (row_gid, count, table_planes, slot_gid): ``row_gid`` [N] int32
    dense ids in first-occurrence order (dead rows get ``num_slots``);
    ``count`` the number of groups (host int); ``table_planes`` [P, S] and
    ``slot_gid`` [S] (-1 = empty slot) are the table for :func:`hash_probe`,
    views of one [S, W] bucket storage (:func:`bucket_width`).  On the card
    the count is the call's one device-to-host copy; with
    ``count_on_device`` it stays a 0-d int32 tensor on the planes' device
    and the call reads nothing back."""
    S = int(num_slots)
    if S <= 0 or S & (S - 1) or S > _MAX_SLOTS:
        raise ValueError(f"num_slots must be a power of two <= 2^30, got {S}")
    n = _check_rows(planes, hash32, live)
    if S < 2 * n:
        raise ValueError(f"num_slots {S} < 2 x {n} rows")
    P = planes.shape[0]
    if P < 1:
        raise ValueError("no key planes")
    if not planes.is_cuda:
        if planes.device.type != "cpu":
            raise ValueError(f"unsupported device {planes.device}")
        return hash_insert_plain(planes, hash32, live, S, count_on_device)
    dev = planes.get_device()
    if dev != torch.cuda.current_device():
        raise ValueError("inputs must be on the current CUDA device")
    lib = _lib()
    buckets = torch.empty((S, bucket_width(P)), dtype=torch.int32,
                          device=planes.device)
    if buckets.data_ptr() % 16:
        raise RuntimeError("bucket storage is not 16-byte aligned")
    row_gid = torch.empty_like(hash32)
    nb = -(-n // _INSERT_ROWS_PER_BLOCK)
    # owner [S], row_slot [N], then the per-block offsets and the count
    scratch = torch.empty(S + n + nb + 1, dtype=torch.int32,
                          device=planes.device)
    base = scratch.data_ptr()
    _check(lib.hash_insert_launch(
        planes.data_ptr(), P, n, hash32.data_ptr(),
        None if live is None else live.data_ptr(), S, buckets.data_ptr(),
        buckets.shape[1], base, base + 4 * S, row_gid.data_ptr(),
        base + 4 * (S + n), _stream(dev)), "hash_insert")
    _launched("hash_insert")
    if count_on_device:
        count = (scratch[S + n + nb].clone() if n else
                 torch.zeros((), dtype=torch.int32, device=planes.device))
    else:
        count = int(scratch[S + n + nb].item()) if n else 0
    return (row_gid, count, *_views(buckets, P))


def hash_probe(table_planes, slot_gid, planes, hash32,
               live: Optional[torch.Tensor] = None):
    """Look up [P, N] ``planes`` rows (``hash32`` [N] int32, ``live`` [N]
    bool or None = all live, all contiguous) in the table
    (``table_planes``, ``slot_gid``) that :func:`hash_insert` returned.
    Returns [N] int32 group ids; -1 = miss or dead.  Any other table
    raises."""
    n = _check_rows(planes, hash32, live)
    P = planes.shape[0]
    S, W = _bucket_layout(table_planes, slot_gid, P)
    dev = planes.get_device()
    if slot_gid.get_device() != dev:
        raise ValueError("table and probe rows on different devices")
    if not planes.is_cuda:
        if planes.device.type != "cpu":
            raise ValueError(f"unsupported device {planes.device}")
        return hash_probe_plain(table_planes, slot_gid, planes, hash32, live)
    if dev != torch.cuda.current_device():
        raise ValueError("inputs must be on the current CUDA device")
    gid = torch.empty_like(hash32)
    if n:
        _check(_lib().hash_probe_launch(
            slot_gid.data_ptr(), W, S, planes.data_ptr(), P, n,
            hash32.data_ptr(), None if live is None else live.data_ptr(),
            gid.data_ptr(), _stream(dev)), "hash_probe")
        _launched("hash_probe")
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


@memo("gpu_kernels.segment_grid", maxsize=256)
def _segment_grid(dev: int, G: int) -> int:
    """The segment sum's grid (resident blocks) for G on the current CUDA
    device ``dev``, set up at the first call for the pair and then only
    read from the registry.  The setup raises the kernel's shared-memory
    limit and reads its occupancy (no work on any stream, so it may run
    inside a CUDA graph capture)."""
    blocks = ctypes.c_int(0)
    _check(_lib().segment_sum_setup(G, ctypes.byref(blocks)),
           "masked_segment_sum_f32 setup")
    return blocks.value


def _check_segment_args(values, gid, live, G: int) -> int:
    """[N] float32 values, [N] int32 gid, [N] bool live (or None), all
    contiguous and on one device, 1 <= G <= 64.  Returns N."""
    if not 1 <= G <= SEGMENT_SUM_MAX_GROUPS:
        raise ValueError(f"num_groups must be in [1, "
                         f"{SEGMENT_SUM_MAX_GROUPS}], got {G}")
    if values.dtype is not torch.float32 or values.dim() != 1:
        raise TypeError("values must be an [N] float32 tensor")
    n = values.shape[0]
    if gid.dtype is not torch.int32 or gid.shape != (n,):
        raise TypeError("gid must be an [N] int32 tensor")
    if live is not None and (live.dtype is not torch.bool
                             or live.shape != (n,)):
        raise TypeError("live must be an [N] bool tensor or None")
    dev = values.get_device()
    if gid.get_device() != dev or (live is not None
                                   and live.get_device() != dev):
        raise ValueError("inputs on several devices")
    if not (values.is_contiguous() and gid.is_contiguous()
            and (live is None or live.is_contiguous())):
        raise ValueError("inputs must be contiguous")
    return n


def masked_segment_sum_f32(values, gid, live: Optional[torch.Tensor],
                           num_groups: int):
    """Per-group sums of an f32 column: [N] float32 ``values``, [N] int32
    group ids, [N] bool ``live`` (None = all live), ``num_groups`` G in
    [1, 64] -> [G] float32.  Dead rows and ids outside [0, G) add nothing.
    Inputs must be contiguous 1-D tensors of exactly these types (a view may
    start at any element); the CUDA kernel adds in a fixed order, so one
    input gives the same bits on every run."""
    G = int(num_groups)
    n = _check_segment_args(values, gid, live, G)
    if not values.is_cuda:
        if values.device.type != "cpu":
            raise ValueError(f"unsupported device {values.device}")
        return masked_segment_sum_f32_plain(values, gid, live, G)
    dev = values.get_device()
    if dev != torch.cuda.current_device():
        raise ValueError("inputs must be on the current CUDA device")
    grid = _segment_grid(dev, G)
    # one allocation: the G sums, then the blocks' [grid, G] partial rows
    buf = values.new_empty(((grid + 1) * G,))
    base = buf.data_ptr()
    _check(_lib().segment_sum_launch(
        values.data_ptr(), gid.data_ptr(),
        None if live is None else live.data_ptr(), n, G, grid, base + 4 * G,
        base, _stream(dev)), "masked_segment_sum_f32")
    _launched("masked_segment_sum_f32")
    return buf[:G]

"""Device time of each launch of the CUDA ``hash_insert`` on one NVIDIA GPU.

Run from the repository root:  python -m trino_tpu_torch.tools.insert_passes

Compiles a diagnostic library from ``csrc/hash_table.cu`` (included whole)
that records a CUDA event between the six launches of
``hash_insert_launch`` -- init, claim, first, scan, rank, fill -- and prints
each pass's device time (mean of 5 runs after one warm-up) at six shapes:
a Q18-like group-by (1.5 M keys, 1 to 7 rows a key, about 6.0 M rows
sorted by key like lineitem by l_orderkey, S = 2^24), the same rows
shuffled, a Q3-orders-like unique index (729,338 keys, S = 2^21), a
Q12-like index (30,922 keys, S = 2^16), and at a G1-like size (23,993,284
rows, S = 2^26: a ROLLUP of lineitem) with 36 keys in random order, with
36 keys laid out as GroupId lays out G1's sets (four runs of 5,998,321
rows over 28, 4, 3 and 1 keys), and with every key distinct.  Keys are
made on the card from seed 0.  The launch sequence below must follow
``hash_insert_launch``.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import torch

_ROOT = Path(__file__).resolve().parent.parent.parent
_OUT = _ROOT / "build" / "diagnostics"
_PASSES = ("init", "claim", "first", "scan", "rank", "fill")

_SOURCE = r'''
#include "%s"
extern "C" int insert_passes(const int32_t* planes, int P, int64_t n,
                             const int32_t* h32, int64_t S, int32_t* buckets,
                             int W, int32_t* owner, int32_t* row_slot,
                             int32_t* row_gid, int32_t* block_scratch,
                             float* ms) {
  cudaEvent_t ev[7];
  for (int k = 0; k < 7; ++k) cudaEventCreate(&ev[k]);
  cudaStream_t s = 0;
  const int nb = (int)blocks_for(n, kRowsPerBlock);
  cudaEventRecord(ev[0], s);
  hash_init_kernel<<<blocks_for((S + 3) / 4, kThreads), kThreads, 0, s>>>(
      owner, S);
  cudaEventRecord(ev[1], s);
  hash_claim_kernel<<<blocks_for(n, kThreads), kThreads, 0, s>>>(
      planes, P, n, h32, nullptr, owner, (uint32_t)(S - 1), row_slot);
  cudaEventRecord(ev[2], s);
  hash_first_kernel<<<nb, kThreads, 0, s>>>(owner, row_slot, n, row_gid,
                                            block_scratch);
  cudaEventRecord(ev[3], s);
  hash_scan_blocks_kernel<<<1, kScanThreads, 0, s>>>(block_scratch, nb,
                                                     block_scratch + nb);
  cudaEventRecord(ev[4], s);
  hash_rank_kernel<<<nb, kThreads, 0, s>>>(n, block_scratch, row_gid);
  cudaEventRecord(ev[5], s);
  hash_fill_kernel<<<blocks_for(S, kThreads), kThreads, 0, s>>>(
      owner, S, W, planes, P, n, row_slot, (int32_t)S, row_gid,
      (int4*)buckets);
  cudaEventRecord(ev[6], s);
  cudaEventSynchronize(ev[6]);
  for (int k = 0; k < 6; ++k) cudaEventElapsedTime(&ms[k], ev[k], ev[k + 1]);
  for (int k = 0; k < 7; ++k) cudaEventDestroy(ev[k]);
  return (int)cudaGetLastError();
}
'''


def _build():
    from ..ops.gpu_kernels import _NVCC_FLAGS, _nvcc

    _OUT.mkdir(parents=True, exist_ok=True)
    src = _OUT / "insert_passes.cu"
    lib = _OUT / "insert_passes.so"
    header = _ROOT / "trino_tpu_torch" / "csrc" / "hash_table.cu"
    src.write_text(_SOURCE % header)
    subprocess.run([_nvcc(), *_NVCC_FLAGS, "-shared", "-o", str(lib),
                    str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).insert_passes
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [p, i, i64, p, i64, p, i, p, p, p, p, p]
    fn.restype = i
    return fn


def _time(fn, keys, S: int, runs: int = 5) -> list:
    from ..exec import kernels as K
    from ..ops import gpu_kernels as GK

    planes = torch.stack(K.key_planes([(keys, None)])).contiguous()
    h32 = K.slot_hash32(K.hash_combine(list(planes.long()))).contiguous()
    P, n = planes.shape
    W = GK.bucket_width(P)
    buckets = torch.empty((S, W), dtype=torch.int32, device=keys.device)
    row_gid = torch.empty_like(h32)
    nb = -(-n // GK._INSERT_ROWS_PER_BLOCK)
    scratch = torch.empty(S + n + nb + 1, dtype=torch.int32,
                          device=keys.device)
    base = scratch.data_ptr()
    ms = (ctypes.c_float * len(_PASSES))()
    total = [0.0] * len(_PASSES)
    for run in range(runs + 1):  # the first run warms up
        rc = fn(planes.data_ptr(), P, n, h32.data_ptr(), S,
                buckets.data_ptr(), W, base, base + 4 * S,
                row_gid.data_ptr(), base + 4 * (S + n), ms)
        if rc:
            raise RuntimeError(f"insert_passes: CUDA error {rc}")
        if run:
            total = [t + m / runs for t, m in zip(total, ms)]
    return total


def main() -> int:
    from ..ops import gpu_kernels as GK

    if not torch.cuda.is_available():
        print("insert_passes: CUDA is not available")
        return 2
    GK._lib()  # builds the kernels and reads the launch geometry
    fn = _build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    keys = torch.randperm(6_000_000, device=dev,
                          generator=gen)[:1_500_000].sort().values + 1
    reps = torch.randint(1, 8, (keys.numel(),), device=dev, generator=gen)
    q18 = torch.repeat_interleave(keys, reps)
    cases = [
        ("Q18-like, sorted", q18, 1 << 24),
        ("Q18-like, shuffled",
         q18[torch.randperm(q18.numel(), device=dev, generator=gen)],
         1 << 24),
        ("Q3-orders-like", torch.randperm(6_000_000, device=dev,
                                          generator=gen)[:729_338] + 1,
         1 << 21),
        ("Q12-like", torch.randint(1, 6_000_000, (30_922,), device=dev,
                                   generator=gen), 1 << 16),
    ]
    g1_rows = 4 * 5_998_321
    g1_keys = torch.randperm(1 << 20, device=dev, generator=gen)[:36] + 1
    per_set = g1_rows // 4
    sets = torch.cat([torch.randint(lo, lo + k, (per_set,), device=dev,
                                    generator=gen)
                      for lo, k in ((0, 28), (28, 4), (32, 3), (35, 1))])
    cases += [
        ("G1-like, 36 keys", g1_keys[torch.randint(
            0, 36, (g1_rows,), device=dev, generator=gen)], 1 << 26),
        ("G1-like, 36 keys in G1's four sets", g1_keys[sets], 1 << 26),
        ("G1-like size, distinct keys",
         torch.randperm(g1_rows, device=dev, generator=gen) + 1, 1 << 26),
    ]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip() or torch.cuda.get_device_name(0)}")
    for label, k, S in cases:
        t = _time(fn, k, S)
        print(f"{label} (N={k.numel()}, S={S}): "
              + ", ".join(f"{p} {v:.4f}" for p, v in zip(_PASSES, t))
              + f"; sum {sum(t):.4f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

// Open-addressing hash table kernels for Hopper (sm_90a): linear-probing
// insert and read-only probe over [P, N] 32-bit key planes.
//
// Replaces the Pallas kernels _hash_insert_kernel / _hash_probe_kernel of
// trino_tpu/ops/pallas_kernels.py.  The TPU kernels walk the rows one by
// one inside a sequential grid, with the whole table resident in VMEM.  Here
// one thread owns one row and all 132 SMs work at once, so the design is
// redone around atomics and a prefix sum.
//
// Storage: one [S, W] int32 bucket array, W = 4 * ceil((P + 1) / 4).  Word 0
// is the group id (-1 = empty slot), words 1..P the key planes, the rest 0.
// Every bucket is 16-byte aligned (W is a multiple of 4 words and the caller
// hands a 16-byte aligned base), so a probe step reads its bucket as W / 4
// aligned int4 loads: one load for P <= 3, which covers every join index
// (P = 2), and two neighbouring buckets share one 32-byte sector.
//
//   init (hash_init_kernel): an [S] int32 owner word per slot <- -1
//     (scratch, 4 bytes a slot: the claim's atomics and the later random
//     reads work on a table a quarter of the buckets' size, which keeps far
//     more of it in the 50 MB L2).
//   claim (hash_claim_kernel): a row starts at slot h32 & (S-1) and tries
//     atomicCAS(owner[slot], -1, row).  A row that finds the slot taken
//     compares its planes with those of the row it found there, read from
//     the immutable input planes -- never from a half-written table -- and
//     on a match lowers the owner to its own index with atomicMin (only
//     when its index is smaller), else steps to the next slot.  An owner
//     only ever holds rows of one key, so when the claim ends it holds the
//     key's first row.  Each row records the slot it ended in.
//   first (hash_first_kernel): row i is the first of its key exactly when
//     owner[row_slot[i]] == i; each row stores that 0/1 flag (in row_gid,
//     as scratch) and each block of 2048 rows counts its flags.  A warp
//     takes runs of 32 neighbouring rows, here and in the rank pass, so
//     every access of the [N] arrays is coalesced.
//   scan (hash_scan_blocks_kernel): one block turns the block counts into
//     exclusive offsets; their total is the group count.
//   rank (hash_rank_kernel): a prefix sum of the flags in row order
//     (ballots within a warp, one exchange between the warps of a block,
//     the block offsets between blocks) gives each first row its rank, its
//     group id: ids are numbered in first-occurrence order exactly as the
//     serial TPU kernel numbers them (only the slot layout may differ).
//   fill (hash_fill_kernel), a separate launch so every first row's id is
//     written before it is read: thread t writes bucket t whole, in slot
//     order -- {-1, 0, ...} or its owner's id and planes -- so the buckets
//     cost one streaming write and no scattered store; threads t < N also
//     give row t its id (a first row's, copied; S for a dead row).
//   probe (hash_probe_kernel): one thread per probe row holds its P planes
//     in registers and walks the buckets, one packed bucket per step.
//
// What bounds them: memory.  The probe must read each row's P planes, h32
// and live flag once, write its id, and touch at least one bucket sector per
// live row; it reads nothing else, so a step costs one sector, where the
// [P, S] + [S] layout cost P + 1 sectors in P + 1 arrays.  The insert must
// read the same inputs, write the ids and the S buckets (the buckets are
// most of its bytes at a large S: 268 MB at S = 2^24, W = 4, written once,
// in order); its other passes stream [N] arrays and [S] owner words and
// touch one random owner word per row.
// Nothing here is compute-bound: a bucket compare is a handful of integer
// ops.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError() so the host wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // rows per thread in the first/rank passes
constexpr int kRowsPerBlock = kThreads * kItems;
constexpr int kScanThreads = 1024;

inline unsigned blocks_for(int64_t n, int64_t per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}

// Exclusive prefix sum of x over the block (all threads must call it, in
// the same order); *total receives the block's sum.
template <int kBlock>
__device__ int block_exclusive_scan(int x, int* total) {
  __shared__ int warp_sums[kBlock / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kBlock / 32; ++w) {
    int s = warp_sums[w];
    before += (w < warp) ? s : 0;
    all += s;
  }
  __syncthreads();  // warp_sums is reused by the next call
  *total = all;
  return before + incl - x;
}

// Thread j sets owner[4j, 4j + 4) with one 16-byte store (owner is 16-byte
// aligned); a table of fewer than 4 slots is set word by word.
__global__ void hash_init_kernel(int32_t* __restrict__ owner, int64_t S) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (4 * j + 3 < S)
    reinterpret_cast<int4*>(owner)[j] = make_int4(-1, -1, -1, -1);
  else
    for (int64_t s = 4 * j; s < S; ++s) owner[s] = -1;
}

__global__ void hash_claim_kernel(const int32_t* __restrict__ planes, int P,
                                  int64_t n, const int32_t* __restrict__ h32,
                                  const bool* __restrict__ live,
                                  int32_t* owner, uint32_t mask,
                                  int32_t* __restrict__ row_slot) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (live != nullptr && !live[i]) {
    row_slot[i] = -1;
    return;
  }
  const int32_t row = (int32_t)i;
  uint32_t slot = (uint32_t)h32[i] & mask;
  while (true) {
    int32_t prev = atomicCAS(&owner[slot], -1, row);
    if (prev == -1) break;  // claimed an empty slot
    bool eq = true;
    for (int p = 0; p < P; ++p) {
      if (planes[(int64_t)p * n + i] != planes[(int64_t)p * n + prev]) {
        eq = false;
        break;
      }
    }
    if (eq) {  // the slot holds this key: keep its smallest row
      if (row < prev) atomicMin(&owner[slot], row);
      break;
    }
    slot = (slot + 1) & mask;
  }
  row_slot[i] = (int32_t)slot;
}

// Rows of the first/rank passes: block b takes rows [b * kRowsPerBlock,
// +kRowsPerBlock), warp w of it the 32 * kItems rows from w * 32 * kItems,
// as kItems runs of 32 neighbouring rows (lane l: row + l), so every load
// and store of a warp is one coalesced 128-byte access.
__device__ __forceinline__ int64_t warp_rows_base() {
  return (int64_t)blockIdx.x * kRowsPerBlock +
         (int64_t)(threadIdx.x >> 5) * (32 * kItems) + (threadIdx.x & 31);
}

__global__ void hash_first_kernel(const int32_t* __restrict__ owner,
                                  const int32_t* __restrict__ row_slot,
                                  int64_t n, int32_t* __restrict__ flag,
                                  int32_t* __restrict__ block_count) {
  const int64_t base = warp_rows_base();
  int c = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    int64_t row = base + 32 * k;
    if (row < n) {
      int32_t s = row_slot[row];
      int f = (s >= 0 && owner[s] == (int32_t)row) ? 1 : 0;
      flag[row] = f;
      c += f;
    }
  }
  int total;
  block_exclusive_scan<kThreads>(c, &total);
  if (threadIdx.x == 0) block_count[blockIdx.x] = total;
}

// One block: counts[0, nb) -> exclusive offsets in place; *total = the sum.
__global__ void hash_scan_blocks_kernel(int32_t* __restrict__ counts, int nb,
                                        int32_t* __restrict__ total) {
  const int per = (nb + kScanThreads - 1) / kScanThreads;
  const int lo = min((int)threadIdx.x * per, nb);
  const int hi = min(lo + per, nb);
  int s = 0;
  for (int j = lo; j < hi; ++j) s += counts[j];
  int all;
  int run = block_exclusive_scan<kScanThreads>(s, &all);
  for (int j = lo; j < hi; ++j) {
    int c = counts[j];
    counts[j] = run;
    run += c;
  }
  if (threadIdx.x == 0) *total = all;
}

// Word w of row i's padded key (word 0 is the id slot; words past P are 0,
// as in the buckets).
__device__ __forceinline__ int32_t key_word(const int32_t* __restrict__ planes,
                                            int P, int64_t n, int64_t i,
                                            int w) {
  return (w >= 1 && w <= P) ? __ldg(planes + (int64_t)(w - 1) * n + i) : 0;
}

// The same rows as hash_first_kernel; row_gid holds the flags on entry and,
// on return, the id of every first row.  A warp ranks each run of 32 rows
// with a ballot; one shared-memory exchange gives each warp the flags of the
// warps before it.
__global__ void hash_rank_kernel(int64_t n,
                                 const int32_t* __restrict__ block_offset,
                                 int32_t* __restrict__ row_gid) {
  __shared__ int warp_count[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = warp_rows_base();
  unsigned ballot[kItems];
  int c = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    int64_t row = base + 32 * k;
    ballot[k] = __ballot_sync(0xffffffffu, row < n && row_gid[row] != 0);
    c += __popc(ballot[k]);
  }
  if (lane == 0) warp_count[warp] = c;
  __syncthreads();
  int rank = block_offset[blockIdx.x];
  for (int w = 0; w < warp; ++w) rank += warp_count[w];
  const unsigned before = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if ((ballot[k] >> lane) & 1u)
      row_gid[base + 32 * k] = rank + __popc(ballot[k] & before);
    rank += __popc(ballot[k]);
  }
}

// Thread t writes bucket t whole, in slot order (coalesced 16-byte stores):
// {-1, 0, ...} when empty, else its owner's id and planes.  Threads t < n
// also finish row t: a dead row takes `dead`, any other row that is not the
// first of its key copies its first row's id.  Only first rows' ids are read
// here and none of them is written, so the reads see final values.
__global__ void hash_fill_kernel(const int32_t* __restrict__ owner, int64_t S,
                                 int W, const int32_t* __restrict__ planes,
                                 int P, int64_t n,
                                 const int32_t* __restrict__ row_slot,
                                 int32_t dead, int32_t* row_gid,
                                 int4* __restrict__ buckets) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < S) {
    const int32_t f = owner[t];
    int4* b = buckets + t * (W / 4);
    if (f < 0) {
      b[0] = make_int4(-1, 0, 0, 0);
      for (int v = 1; v < W / 4; ++v) b[v] = make_int4(0, 0, 0, 0);
    } else {
      b[0] = make_int4(row_gid[f], key_word(planes, P, n, f, 1),
                       key_word(planes, P, n, f, 2),
                       key_word(planes, P, n, f, 3));
      for (int v = 1; v < W / 4; ++v)
        b[v] = make_int4(key_word(planes, P, n, f, 4 * v),
                         key_word(planes, P, n, f, 4 * v + 1),
                         key_word(planes, P, n, f, 4 * v + 2),
                         key_word(planes, P, n, f, 4 * v + 3));
    }
  }
  if (t < n) {
    const int32_t s = row_slot[t];
    if (s < 0) {
      row_gid[t] = dead;
    } else {
      const int32_t f = owner[s];
      if (f != (int32_t)t) row_gid[t] = row_gid[f];
    }
  }
}

__device__ __forceinline__ bool same4(int4 b, int32_t k0, int32_t k1,
                                      int32_t k2, int32_t k3) {
  return b.x == k0 && b.y == k1 && b.z == k2 && b.w == k3;
}

// NV int4 words per bucket, the key in registers; NV == 0: any width (nv at
// run time), the key re-read from the input planes (L1-resident after the
// first step).
template <int NV>
__global__ void hash_probe_kernel(const int4* __restrict__ buckets, int nv,
                                  uint32_t mask,
                                  const int32_t* __restrict__ planes, int P,
                                  int64_t n, const int32_t* __restrict__ h32,
                                  const bool* __restrict__ live,
                                  int32_t* __restrict__ gid) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t out = -1;
  // the live flag, the hash and the key are independent loads: all in
  // flight at once, before the walk (dead rows read them too; the bound
  // counts every input once)
  const bool alive = live == nullptr || live[i];
  uint32_t slot = (uint32_t)__ldg(h32 + i) & mask;
  if constexpr (NV > 0) {
    int32_t key[4 * NV];
#pragma unroll
    for (int w = 0; w < 4 * NV; ++w) key[w] = key_word(planes, P, n, i, w);
    if (alive) {
      while (true) {
        const int4* b = buckets + (int64_t)slot * NV;
        int4 q[NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) q[v] = __ldg(b + v);
        if (q[0].x < 0) break;  // empty slot: miss
        bool eq = q[0].y == key[1] && q[0].z == key[2] && q[0].w == key[3];
#pragma unroll
        for (int v = 1; v < NV; ++v)
          eq = eq && same4(q[v], key[4 * v], key[4 * v + 1], key[4 * v + 2],
                           key[4 * v + 3]);
        if (eq) {
          out = q[0].x;
          break;
        }
        slot = (slot + 1) & mask;
      }
    }
  } else if (alive) {
    while (true) {
      const int4* b = buckets + (int64_t)slot * nv;
      int4 q = __ldg(b);
      if (q.x < 0) break;
      bool eq = q.y == key_word(planes, P, n, i, 1) &&
                q.z == key_word(planes, P, n, i, 2) &&
                q.w == key_word(planes, P, n, i, 3);
      for (int v = 1; v < nv && eq; ++v)
        eq = same4(__ldg(b + v), key_word(planes, P, n, i, 4 * v),
                   key_word(planes, P, n, i, 4 * v + 1),
                   key_word(planes, P, n, i, 4 * v + 2),
                   key_word(planes, P, n, i, 4 * v + 3));
      if (eq) {
        out = q.x;
        break;
      }
      slot = (slot + 1) & mask;
    }
  }
  gid[i] = out;
}

}  // namespace

extern "C" {

// Rows per block of the first/rank passes: block_scratch below holds
// ceil(n / this) + 1 int32.
int hash_insert_rows_per_block() { return kRowsPerBlock; }

// buckets: [S, W] int32, 16-byte aligned, W = 4 * ceil((P + 1) / 4); all of
// it is written here.  owner: [S] int32 scratch, 16-byte aligned.  row_slot, row_gid: [n]
// int32.  block_scratch: ceil(n / hash_insert_rows_per_block()) + 1 int32
// (block offsets, then the group count).  live may be null (every row
// live).  With n == 0 the count is not written.
int hash_insert_launch(const int32_t* planes, int P, int64_t n,
                       const int32_t* h32, const bool* live, int64_t S,
                       int32_t* buckets, int W, int32_t* owner,
                       int32_t* row_slot, int32_t* row_gid,
                       int32_t* block_scratch, void* stream) {
  if (P < 1 || W < P + 1 || W % 4 != 0 || S < 1 || S > (1 << 30) ||
      (S & (S - 1)) != 0 || n > S / 2 || ((uintptr_t)buckets & 15) != 0 ||
      ((uintptr_t)owner & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  hash_init_kernel<<<blocks_for((S + 3) / 4, kThreads), kThreads, 0, s>>>(
      owner, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    hash_claim_kernel<<<blocks_for(n, kThreads), kThreads, 0, s>>>(
        planes, P, n, h32, live, owner, (uint32_t)(S - 1), row_slot);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int nb = (int)blocks_for(n, kRowsPerBlock);
    hash_first_kernel<<<nb, kThreads, 0, s>>>(owner, row_slot, n, row_gid,
                                              block_scratch);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    hash_scan_blocks_kernel<<<1, kScanThreads, 0, s>>>(block_scratch, nb,
                                                       block_scratch + nb);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    hash_rank_kernel<<<nb, kThreads, 0, s>>>(n, block_scratch, row_gid);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  hash_fill_kernel<<<blocks_for(S, kThreads), kThreads, 0, s>>>(
      owner, S, W, planes, P, n, row_slot, (int32_t)S, row_gid,
      (int4*)buckets);
  return (int)cudaGetLastError();
}

// buckets: [S, W] int32 as hash_insert_launch leaves it.  live may be null.
int hash_probe_launch(const int32_t* buckets, int W, int64_t S,
                      const int32_t* planes, int P, int64_t n,
                      const int32_t* h32, const bool* live, int32_t* gid,
                      void* stream) {
  if (P < 1 || W < P + 1 || W % 4 != 0 || S < 1 || (S & (S - 1)) != 0 ||
      ((uintptr_t)buckets & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int4* b = (const int4*)buckets;
  const int nv = W / 4;
  const uint32_t mask = (uint32_t)(S - 1);
  const unsigned grid = blocks_for(n, kThreads);
  switch (nv) {
    case 1:
      hash_probe_kernel<1><<<grid, kThreads, 0, s>>>(b, nv, mask, planes, P,
                                                     n, h32, live, gid);
      break;
    case 2:
      hash_probe_kernel<2><<<grid, kThreads, 0, s>>>(b, nv, mask, planes, P,
                                                     n, h32, live, gid);
      break;
    case 3:
      hash_probe_kernel<3><<<grid, kThreads, 0, s>>>(b, nv, mask, planes, P,
                                                     n, h32, live, gid);
      break;
    default:
      hash_probe_kernel<0><<<grid, kThreads, 0, s>>>(b, nv, mask, planes, P,
                                                     n, h32, live, gid);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

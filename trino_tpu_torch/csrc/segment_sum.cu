// Masked per-group float32 sum for Hopper (sm_90a): [N] values, [N] int32
// group ids, optional [N] bool live mask -> [G] sums, G <= 64.  Rows whose
// group id lies outside [0, G), and dead rows, add nothing.
//
// Replaces the Pallas kernel _segment_sum_kernel of
// trino_tpu/ops/pallas_kernels.py (wrapper masked_segment_sum_f32).  The TPU
// kernel walks 1024-row blocks on a sequential grid and keeps one [G, 128]
// accumulator tile in VMEM from step to step, selecting each group with a
// vector compare.  Blocks on Hopper run in parallel and in no order, so the
// design is one launch of resident blocks that each sum a contiguous range
// of rows, and a last block that combines their partial sums.
//
// What bounds it: bytes.  Each row is read once (4 + 4 bytes, + 1 with a
// mask) and the work per row is a compare and an add, so at N = 6.0 M the
// bound is the 48 MB over 3.35 TB/s, 0.0143 ms.  Reaching it needs about
// 3.35 TB/s x ~0.7 us of latency / 132 SMs ~ 18 KB of loads in flight on
// every SM.  A thread therefore starts kUnroll 16-byte loads of values and
// of ids (and kUnroll 4-byte words of 4 live flags) before it uses any of
// them, and starts the next step's loads before it adds this step's rows:
// 128 bytes a thread in flight at kUnroll = 4, about 64 KB on an SM of 512
// threads, whatever G is.  (The two-pass kernel this replaced had one
// 4-byte load of each array in flight per thread and 768 threads an SM at
// G = 64, about 6 KB, and took 2.9x its bound on the device there.)
//
// Accumulators: thread t owns column t of a [G][kThreads] float array in
// shared memory (acc[g * kThreads + t]: the 32 lanes of a warp hit 32
// banks).  A thread keeps the running sum of its current group in a
// register and moves it into its column only when the group changes, so on
// the path's sorted ids (hash_group_ids sorts rows by group) a thread
// touches shared memory a few times per range; shuffled ids cost one
// shared read-modify-write per row, which is still far below the loads.
//
// Rows: block b of the grid takes one contiguous range of the 16-byte words
// (each of 4 rows); in a step its threads read kUnroll words each, thread t
// the words t, t + kThreads, ..., so every warp load is 512 contiguous
// bytes.  A start that is not 16-byte aligned is peeled: the up to 3 rows
// before the first aligned word go to block 0 and the up to 3 after the
// last to the last block.  When values and ids do not share their offset
// mod 16 (or the mask is not aligned with them), the same kernel walks the
// rows one 4-byte load at a time, 4 * kUnroll loads in flight per thread.
//
// One launch, in a fixed order: each block reduces its columns (a
// sequential sum over kThreads / 32 columns per lane, then a warp xor
// tree) and writes one partial row of G floats into the call's scratch;
// a grid sync (the launch is cooperative, so every block is resident)
// makes the rows visible, and block 0 sums the partial rows of each group
// over block index in a fixed order.  The grid depends only on N, G and
// the card, so one input on one card adds in the same order on every run
// and gives the same bits.  There are no float atomics, and no state
// outlives a call: the grid sync's barrier belongs to the launch, so calls
// on any streams and replays of any CUDA graphs may overlap.
//
// Grid: at most kBlocksPerSm resident blocks an SM (set up once per device
// and G by segment_sum_setup), fewer when the rows need less; the partials
// are at most 132 x G floats, so block 0's combine is a few loads per
// thread.
//
// Each entry point returns a cudaError_t (0 = success); the launch returns
// the launch's error or cudaGetLastError() so the host wrapper can raise on
// a refused launch.
//
// The geometry was chosen by measurement: device ms per launch from one
// run of a timing script that built this file once per variant, each with
// one change (CUDA graph replay; 5,998,321 sorted rows, G = 8 / G = 64;
// an H100 80GB HBM3 at 700 W).  In that run the blocks combined through a
// last-block ticket (a counter word per stream, kept between calls) where
// they now meet at a grid sync:
//   this design (with the ticket)            0.0213 / 0.0230
//   the same, rows cold in L2                     - / 0.0231
//   2 words a step                           0.0214 / 0.0230
//   8 words a step                           0.0291 / 0.0315
//   no prefetch of the next step's words     0.0220 / 0.0234
//   every warp reduces 4 groups (clamped)    0.0217 / 0.0230
//   a fence per warp, before the barrier     0.0215 / 0.0232
//   512-thread blocks, 2 an SM               0.0217 / 0.0231
//   256-thread blocks, 1 / 2 / 3 an SM       0.0225 / 0.0240, 0.0216 /
//                                            0.0238, 0.0215 / 0.0239
//   1024-thread blocks                       0.0354 / refused (256 KB)
//   __ldg instead of streaming loads         0.0216 / 0.0233
//   a shared update per row, no running sum  0.0217 / 0.0235
// Two words a step tie with four within the spread between runs (~3 %).
// The two-pass kernel this replaced took 0.0211 / 0.0408 ms in
// chip_smoke.py on the same day.  The 4-byte path takes 0.0280 ms at
// G = 64 (256-thread blocks, 2 an SM, would take it to 0.0250).  torch.sum
// reads 48 MB in 0.0237 ms (2.02 TB/s) on that card, while a block here
// sums its rows in ~17 us (2.8 TB/s for the 48 MB), so a TMA ring
// (cp.async.bulk into shared memory, one producer warp) was not built.
// What is left beside the streaming is latency: 1.2 / 1.7 us for a block's
// reduce, fence and ticket, and 1.7 / 2.3 us for the last block's combine,
// at G = 8 / 64.
// On the device the grid sync ties with the ticket: in chip_smoke.py runs
// of both in turns on that card (ticket, grid sync, grid sync, ticket),
// 0.0205, 0.0208 / 0.0221, 0.0223 ms against 0.0209, 0.0209 / 0.0225,
// 0.0224 ms at R1 / R2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;       // 16-byte words per array a thread loads a step
constexpr int kBlocksPerSm = 1;  // the grid: one resident block an SM
constexpr int kMaxGroups = 64;
constexpr int kGroupsPerWarp = (kMaxGroups + kWarps - 1) / kWarps;
constexpr int kSlices = 16;  // threads per group in the last block's combine
constexpr int kChunk = 32;   // partials a combine thread loads at once

static_assert(kThreads % 32 == 0 && kThreads >= kMaxGroups, "block size");

inline size_t smem_bytes(int G) {
  return (size_t)G * kThreads * sizeof(float);
}

// Adds row (g, v) to the thread's running sum; when the group changes, the
// running sum of the previous group moves into the thread's column first.
__device__ __forceinline__ void add_row(float* col, int G, int32_t g, float v,
                                        bool alive, int32_t& cur,
                                        float& run) {
  if (alive && (uint32_t)g < (uint32_t)G) {
    if (g == cur) {
      run += v;
    } else {
      col[cur * kThreads] += run;
      cur = g;
      run = v;
    }
  }
}

// kUnroll 16-byte words (4 rows each) of values, ids and live flags: the
// thread's words base, base + kThreads, ...; a word at or past hi reads as
// 4 rows that add nothing.  Every load starts before any row is used.
struct Words {
  float4 v[kUnroll];
  int4 g[kUnroll];
  uint32_t m[kUnroll];
};

__device__ __forceinline__ void load_words(Words& w, const float4* v4,
                                           const int4* g4,
                                           const uint32_t* l4, int64_t base,
                                           int64_t hi) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i = base + (int64_t)u * kThreads;
    if (i < hi) {
      w.v[u] = __ldcs(v4 + i);
      w.g[u] = __ldcs(g4 + i);
      w.m[u] = l4 ? __ldcs(l4 + i) : 0x01010101u;
    } else {
      w.v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      w.g[u] = make_int4(-1, -1, -1, -1);
      w.m[u] = 0u;
    }
  }
}

__device__ __forceinline__ void add_words(const Words& w, float* col, int G,
                                          int32_t& cur, float& run) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    add_row(col, G, w.g[u].x, w.v[u].x, (w.m[u] & 0xffu) != 0u, cur, run);
    add_row(col, G, w.g[u].y, w.v[u].y, (w.m[u] & 0xff00u) != 0u, cur, run);
    add_row(col, G, w.g[u].z, w.v[u].z, (w.m[u] & 0xff0000u) != 0u, cur,
            run);
    add_row(col, G, w.g[u].w, w.v[u].w, (w.m[u] >> 24) != 0u, cur, run);
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// head: rows before the first 16-byte aligned word (vec only).  partial
// holds gridDim.x x G floats.  Launched cooperatively (a grid sync).
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ vals,
                   const int32_t* __restrict__ gid,
                   const uint8_t* __restrict__ live, int64_t n, int G,
                   int head, bool vec, float* __restrict__ partial,
                   float* __restrict__ out) {
  extern __shared__ float acc[];  // [G][kThreads]
  const int t = threadIdx.x;
  for (int g = 0; g < G; ++g) acc[g * kThreads + t] = 0.f;
  float* col = acc + t;  // only this thread touches it until the reduction
  int32_t cur = 0;
  float run = 0.f;
  const int64_t b = blockIdx.x, nb = gridDim.x;
  if (vec) {
    const int64_t nvec = (n - head) >> 2;
    const float4* v4 = reinterpret_cast<const float4*>(vals + head);
    const int4* g4 = reinterpret_cast<const int4*>(gid + head);
    const uint32_t* l4 =
        live ? reinterpret_cast<const uint32_t*>(live + head) : nullptr;
    if (b == 0 && t < head)
      add_row(col, G, gid[t], vals[t], live == nullptr || live[t], cur, run);
    const int64_t per = (nvec + nb - 1) / nb;
    const int64_t lo = b * per, hi = lo + per < nvec ? lo + per : nvec;
    constexpr int64_t kStep = (int64_t)kThreads * kUnroll;
    // the next step's words are in flight while this step's are added
    Words w;
    load_words(w, v4, g4, l4, lo + t, hi);
    for (int64_t base = lo + t; base < hi; base += kStep) {
      Words next;
      load_words(next, v4, g4, l4, base + kStep, hi);
      add_words(w, col, G, cur, run);
      w = next;
    }
    const int64_t tail = head + 4 * nvec;
    if (b == nb - 1 && tail + t < n)
      add_row(col, G, gid[tail + t], vals[tail + t],
              live == nullptr || live[tail + t], cur, run);
  } else {
    constexpr int kRows = 4 * kUnroll;
    const int64_t per = (n + nb - 1) / nb;
    const int64_t lo = b * per, hi = lo + per < n ? lo + per : n;
    for (int64_t base = lo + t; base < hi;
         base += (int64_t)kThreads * kRows) {
      float v[kRows];
      int32_t g[kRows];
      bool m[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int64_t i = base + (int64_t)u * kThreads;
        const bool in = i < hi;
        v[u] = in ? __ldcs(vals + i) : 0.f;
        g[u] = in ? __ldcs(gid + i) : -1;
        m[u] = in && (live == nullptr || live[i] != 0);
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        add_row(col, G, g[u], v[u], m[u], cur, run);
    }
  }
  col[cur * kThreads] += run;
  __syncthreads();

  // Warp w reduces groups w, w + kWarps, ... below G (a warp with none
  // reads nothing, so a small G reads little shared memory); lane 0 writes
  // the partials.
  const int warp = t / 32, lane = t % 32;
  float s[kGroupsPerWarp];
#pragma unroll
  for (int i = 0; i < kGroupsPerWarp; ++i) {
    const int g = warp + i * kWarps;
    s[i] = 0.f;
    if (g < G) {
#pragma unroll
      for (int k = lane; k < kThreads; k += 32) s[i] += acc[g * kThreads + k];
    }
  }
#pragma unroll
  for (int i = 0; i < kGroupsPerWarp; ++i) s[i] = warp_sum(s[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kGroupsPerWarp; ++i)
      if (warp + i * kWarps < G) partial[b * G + warp + i * kWarps] = s[i];
  }
  // every block's partial row is written and visible after the grid sync
  cg::this_grid().sync();
  if (b != 0) return;

  // Block 0: thread (q, g) sums the partials of group g from blocks
  // q, q + per, ... in block order, kChunk loads in flight at a time; then
  // thread g adds the per slices in order.
  const int per = min(kThreads / G, kSlices);
  const int g = t % G, q = t / G;
  if (q < per) {
    float sum = 0.f;
    for (int64_t j0 = q; j0 < nb; j0 += (int64_t)kChunk * per) {
      float x[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int64_t j = j0 + (int64_t)k * per;
        x[k] = j < nb ? __ldcg(partial + j * G + g) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) sum += x[k];
    }
    acc[q * G + g] = sum;
  }
  __syncthreads();
  if (t < G) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kSlices; ++k)
      if (k < per) sum += acc[k * G + t];
    out[t] = sum;
  }
}

}  // namespace

extern "C" {

// Once per device and G, on the current device: raises the kernel's
// dynamic shared-memory limit and writes the grid limit for G (resident
// blocks, at most kBlocksPerSm an SM) to *blocks.
int segment_sum_setup(int G, int* blocks) {
  if (G < 1 || G > kMaxGroups || blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, smem_max = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess)
    return (int)err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, segment_sum_kernel)) !=
      cudaSuccess)
    return (int)err;
  // the limit covers every G the card can take, so setting it for one G
  // never lowers it for another
  smem_max -= (int)attr.sharedSizeBytes;
  const int limit = (int)smem_bytes(kMaxGroups) < smem_max
                        ? (int)smem_bytes(kMaxGroups)
                        : smem_max;
  if ((err = cudaFuncSetAttribute(
           segment_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           limit)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, segment_sum_kernel, kThreads, smem_bytes(G))) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = sms * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
  return (int)cudaSuccess;
}

// One cooperative launch.  partial: blocks x G floats of scratch (blocks
// from segment_sum_setup for this G); out receives G floats.  live may be
// null (every row live).  n == 0 writes zeros.
int segment_sum_launch(const float* vals, const int32_t* gid,
                       const uint8_t* live, int64_t n, int G, int blocks,
                       float* partial, float* out, void* stream) {
  const uintptr_t va = (uintptr_t)vals, ga = (uintptr_t)gid;
  if (G < 1 || G > kMaxGroups || blocks < 1 || n < 0 || (va & 3) ||
      (ga & 3))
    return (int)cudaErrorInvalidValue;
  int64_t head = (int64_t)(((16 - (va & 15)) & 15) / 4);
  if (head > n) head = n;
  bool vec = ((va ^ ga) & 15) == 0 &&
             (live == nullptr || (((uintptr_t)live + head) & 3) == 0);
  int head_rows = vec ? (int)head : 0;
  const int64_t rows_per_step = (int64_t)kThreads * 4 * kUnroll;
  int64_t grid = (n + rows_per_step - 1) / rows_per_step;
  if (grid > blocks) grid = blocks;
  if (grid < 1) grid = 1;
  void* args[] = {&vals, &gid, &live, &n, &G, &head_rows, &vec, &partial,
                  &out};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)segment_sum_kernel, dim3((unsigned)grid), dim3(kThreads),
      args, smem_bytes(G), (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"

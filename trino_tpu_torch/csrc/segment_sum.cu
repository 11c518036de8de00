// Masked per-group float32 sum for Hopper (sm_90a): [N] values, [N] int32
// group ids, optional [N] bool live mask -> [G] sums, G <= 64.  Rows whose
// group id lies outside [0, G), and dead rows, add nothing.
//
// Replaces the Pallas kernel _segment_sum_kernel of
// trino_tpu/ops/pallas_kernels.py (wrapper masked_segment_sum_f32).  The TPU
// kernel walks 1024-row blocks on a sequential grid and keeps one [G, 128]
// accumulator tile in VMEM from step to step, selecting each group with a
// vector compare.  Blocks on Hopper run in parallel and in no order, so
// nothing carries over between them; the design is two passes instead:
//
//   pass 1 (segment_sum_partial_kernel): a grid of resident blocks strides
//     over the rows.  Each thread adds its rows into a private column of a
//     [G][256] float array in shared memory (thread t's slot for group g is
//     acc[g * 256 + t], so the 32 lanes of a warp always hit 32 different
//     banks).  The block then reduces each group in a fixed order -- a
//     sequential sum over 8 columns per lane, then a warp-shuffle tree -- and
//     writes one [blocks, G] partial row.
//   pass 2 (segment_sum_final_kernel): one block sums the partials of each
//     group in a fixed order.
//
// No float atomics: for one input on one card the grid is fixed, so every
// run adds in the same order and returns the same bits (a SQL result that
// changes from run to run is worse than a slower kernel).
//
// What bounds it: memory.  Each row is read once (4 + 4 + 1 bytes); the
// shared-memory update and the compare are a few instructions per row.  At
// G = 64 a block needs 64 KB of dynamic shared memory, which limits
// residency to 3 blocks per SM; the grid is sized to exactly the resident
// blocks (for one card and one G always the same grid, hence the same
// order), so the partials stay small.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError() so the host wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 64;

__global__ void __launch_bounds__(kThreads)
segment_sum_partial_kernel(const float* __restrict__ vals,
                           const int32_t* __restrict__ gid,
                           const bool* __restrict__ live, int64_t n, int G,
                           float* __restrict__ partial) {
  extern __shared__ float acc[];  // [G][kThreads]
  const int t = threadIdx.x;
  for (int g = 0; g < G; ++g) acc[g * kThreads + t] = 0.f;
  // each thread touches only its own column until the reduction below
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + t; i < n; i += stride) {
    const int32_t g = gid[i];
    const float v = vals[i];
    if ((uint32_t)g < (uint32_t)G && (live == nullptr || live[i]))
      acc[g * kThreads + t] += v;
  }
  __syncthreads();
  const int warp = t / 32, lane = t % 32;
  for (int g = warp; g < G; g += kWarps) {
    float s = 0.f;
    for (int k = lane; k < kThreads; k += 32) s += acc[g * kThreads + k];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) partial[(int64_t)blockIdx.x * G + g] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
segment_sum_final_kernel(const float* __restrict__ partial, int blocks, int G,
                         float* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < G; g += kWarps) {
    float s = 0.f;
    for (int b = lane; b < blocks; b += 32) s += partial[(int64_t)b * G + g];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) out[g] = s;
  }
}

inline size_t smem_bytes(int G) {
  return (size_t)G * kThreads * sizeof(float);
}

}  // namespace

extern "C" {

// partial holds max_blocks x G floats of scratch; out receives G floats.
// live may be null (every row live).  The pass-1 grid is as many blocks as
// are resident at once on the current device, no more than the rows need
// and at most max_blocks; n == 0 launches pass 2 alone, which writes zeros.
int segment_sum_launch(const float* vals, const int32_t* gid, const bool* live,
                       int64_t n, int G, int max_blocks, float* partial,
                       float* out, void* stream) {
  if (G < 1 || G > kMaxGroups || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int blocks = 0;
  if (n > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        segment_sum_partial_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxGroups));
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, segment_sum_partial_kernel, kThreads,
             smem_bytes(G))) != cudaSuccess)
      return (int)err;
    int64_t grid = (n + kThreads - 1) / kThreads;
    int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    if (grid > resident) grid = resident;
    if (grid > max_blocks) grid = max_blocks;
    blocks = (int)grid;
    segment_sum_partial_kernel<<<blocks, kThreads, smem_bytes(G), s>>>(
        vals, gid, live, n, G, partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  segment_sum_final_kernel<<<1, kThreads, 0, s>>>(partial, blocks, G, out);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Memory-bank min cosine distance (K3): family B's anomaly score against
// its ring buffer of normal sequence features, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cvad_tpu/ops/pallas_kernels.py::
// _memory_kernel (:41-55, pl.pallas_call at :102 inside
// _memory_pallas_impl :89-113), reached through memory_min_cosine_distance
// (:58).  That kernel holds the whole (padded) query and memory in VMEM,
// normalises both, runs one (B, M) matmul on the MXU, masks columns
// >= fill and takes the row minimum, so the (B, M) similarity matrix never
// reaches HBM.  Its backward is jax.vjp of the XLA expression _memory_xla
// (:138-144); there is no backward kernel here either.
//
// What it computes, for query q (B, D), memory m (M, D), float32, and the
// fill count f (one int32 in device memory):
//   q^_b   = q_b * rsqrt(sum_k q_bk^2 + 1e-8)   (the same for m^_j)
//   s_bj   = clip(q^_b . m^_j, -1, 1)
//   out[b] = clamp(min(3, min_{j < f} (1 - s_bj)), 0, 2) / 2
// so f = 0 gives 1.0.  NaN propagates as in jnp.min / jnp.clip: a NaN
// query row, or a NaN memory row below the fill, gives NaN (every min and
// clamp here is written with comparisons that keep NaN; fminf would drop
// it).  Memory rows at or beyond the fill are never read.
//
// Bound at the main path's shape (B = 256, M = f = 500, D = 64; H100 SXM
// peaks): the function reads (B + M) D 4 bytes and writes B 4 bytes,
// 195 KB -> 0.058 us at 3.35 TB/s; it does 2 B f D = 16.4 M float32
// operations -> 0.24 us at 67 TFLOP/s: operations bound, far under the
// launch latency of a few us.  At B = 1024, M = 4096, D = 128 (the large
// bank the Pallas docstring names) the operations bound is 16 us.
//
// Design (simple and exact first; no tensor cores, no TMA):
// - one block of 256 threads per tile of kRows = 8 query rows; each warp
//   normalises one query row (lanes stride over D, a butterfly sum) into
//   shared memory, stored d-major ([d][row]) so one thread reads the 8
//   rows' k-th entries as two float4 loads that every thread of the warp
//   shares (a broadcast, no bank conflicts);
// - each thread walks memory rows j = tid, tid + 256, ... < f, reading its
//   row once from global memory (L1/L2 keep the row's lines for the
//   thread's next d), and keeps 8 dot products and the row's own sum of
//   squares in registers, in a fixed order over d;
// - per thread, a running min of 1 - s over its rows for each query row;
//   then a warp butterfly and a pass over the 8 warps' partial minima.
//   min is exact, so the result does not depend on the order, and a
//   second call is bit-identical.
// - the fill is read on the device: the caller never syncs on it.
// Every block reads every memory row below the fill (B / 8 times in all,
// from L2): at the large shape that is 256 MB of L2 traffic, the first
// thing to fix when the kernel is made fast.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;       // query rows per block; one warp normalises each
constexpr int kMaxD = 1024;    // kRows * kMaxD floats = 32 KB of shared memory
constexpr float kEps = 1e-8f;

static_assert(kRows == kWarps, "one warp normalises one query row");

// min that keeps NaN from either side (jnp.min, torch.amin)
__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a) return a;
  return (b >= a) ? a : b;  // b < a, or b NaN, takes b
}

// clamp to [lo, hi] that keeps NaN (jnp.clip, torch.clamp)
__device__ __forceinline__ float nan_clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float warp_sum_all(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_min_all(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
memory_min_cosine_kernel(const float* __restrict__ query,
                         const float* __restrict__ memory,
                         const int* __restrict__ fill_ptr,
                         float* __restrict__ out, int batch, int m_rows,
                         int dim) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [dim][kRows]
  __shared__ float part[kWarps][kRows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;

  // normalise this block's query rows; rows past the batch are zeros
  {
    const int b = row0 + warp;
    const float* q = query + (long long)b * dim;
    float ss = 0.f;
    if (b < batch)
      for (int k = lane; k < dim; k += 32) ss = fmaf(q[k], q[k], ss);
    ss = warp_sum_all(ss);
    const float inv = 1.0f / sqrtf(ss + kEps);
    for (int k = lane; k < dim; k += 32)
      qs[k * kRows + warp] = b < batch ? q[k] * inv : 0.f;
  }
  __syncthreads();

  int fill = *fill_ptr;
  fill = fill < 0 ? 0 : (fill > m_rows ? m_rows : fill);

  float best[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) best[r] = 3.0f;

  for (int j = threadIdx.x; j < fill; j += kThreads) {
    const float* mj = memory + (long long)j * dim;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    float ss = 0.f;
#pragma unroll 4
    for (int k = 0; k < dim; ++k) {
      const float v = __ldg(mj + k);
      ss = fmaf(v, v, ss);
      const float4 lo = smem4[2 * k];
      const float4 hi = smem4[2 * k + 1];
      acc[0] = fmaf(lo.x, v, acc[0]);
      acc[1] = fmaf(lo.y, v, acc[1]);
      acc[2] = fmaf(lo.z, v, acc[2]);
      acc[3] = fmaf(lo.w, v, acc[3]);
      acc[4] = fmaf(hi.x, v, acc[4]);
      acc[5] = fmaf(hi.y, v, acc[5]);
      acc[6] = fmaf(hi.z, v, acc[6]);
      acc[7] = fmaf(hi.w, v, acc[7]);
    }
    const float inv = 1.0f / sqrtf(ss + kEps);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      best[r] = nan_min(best[r], 1.0f - nan_clamp(acc[r] * inv, -1.f, 1.f));
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float v = warp_min_all(best[r]);
    if (lane == 0) part[warp][r] = v;
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    float v = part[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = nan_min(v, part[w][r]);
    if (row0 + r < batch) out[row0 + r] = nan_clamp(v, 0.f, 2.f) * 0.5f;
  }
}

}  // namespace

// query (B, D) and memory (M, D) float32, contiguous, on the device; fill
// is one int32 on the device; out is (B,) float32.  Launches one kernel on
// `stream` and returns cudaGetLastError() (0 on success); shapes the kernel
// does not take return cudaErrorInvalidValue without launching.
extern "C" int memory_min_cosine_forward(const void* query, const void* memory,
                                         const void* fill, void* out,
                                         int batch, int m_rows, int dim,
                                         void* stream) {
  if (batch <= 0 || m_rows <= 0 || dim <= 0 || dim > kMaxD)
    return (int)cudaErrorInvalidValue;
  const int blocks = (batch + kRows - 1) / kRows;
  const size_t smem = (size_t)kRows * dim * sizeof(float);
  memory_min_cosine_kernel<<<blocks, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(memory),
      static_cast<const int*>(fill), static_cast<float*>(out), batch, m_rows,
      dim);
  return (int)cudaGetLastError();
}

extern "C" const char* memory_min_cosine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Masked mean pairwise L1 (K2): family D's consistency-loss core, forward
// and backward, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cvad_tpu/ops/pallas_kernels.py::
// _pairwise_kernel (:152-171, pl.pallas_call at :214 inside
// _pairwise_pallas_impl :202-230), reached through pairwise_l1_mean (:174).
// That kernel streams one row at a time through a serial fori_loop and
// accumulates sum_{i,j} m_i m_j mean_k |f_ik - f_jk| over all ordered pairs;
// its backward is jax.vjp of the XLA expression _pairwise_xla (:254-262),
// which builds the whole (B, B, N) broadcast (64 MB in float32 at
// B = N = 256).  Here the backward is a kernel of its own.
//
// What it computes, for flat f (B, N) float32 and mask m (B,):
//   n_pairs = sum_{i<j} m_i m_j = ((sum m)^2 - sum m^2) / 2
//   avg     = sum_{i<j} m_i m_j mean_k |f_ik - f_jk| / n_pairs  (0 if none)
//   g_ik    = c m_i / (n_pairs N) sum_j m_j sign(f_ik - f_jk)   (0 if none)
// with c the cotangent of avg and sign(0) = 0, as torch.abs differentiates
// |x| at 0.  (jnp.abs takes +1 there, so at exact ties f_ik == f_jk the
// gradient of cvad_tpu's version differs; on the family-D path the only
// ties are on the adjacency's zero diagonal, whose gradient the model's
// (1 - eye) mask zeroes.)
//
// Bound at the main path's shape (B = N = 256, ~95% of rows in the mask,
// H100 SXM peaks): the forward reads 0.26 MB (1 KB of mask) -> 0.08 us at
// 3.35 TB/s; it does ~3 simple operations (sub, abs, add) per masked pair
// and column, ~25 M -> 0.37 us at 67 TFLOP/s float32: operations bound,
// under 1 us.  The backward reads f and writes g (0.52 MB, 0.16 us) and does
// ~3 operations per masked (i, j, k), ~45 M -> 0.7 us: operations bound.
// Launch latency (a few us) dominates both; the design aims at being exact,
// deterministic and free of the (B, B, N) intermediate, not at the bound.
//
// Design:
// - forward, pass 1: one block per row i.  Row i is staged in shared
//   memory; the block's threads stride over k for every j > i with
//   m_j != 0, each thread keeping its own running sum; a fixed-order block
//   reduction writes partial[i] = sum_{j>i} m_j sum_k |f_ik - f_jk| into a
//   (B,) scratch that the wrapper allocates.
// - forward, pass 2: one block sums m_i partial[i], sum m and sum m^2 in a
//   fixed order and writes avg and n_pairs.
// - backward: one thread per (i, k), a loop over j; neighbouring threads
//   read neighbouring k of row j, so the loads coalesce.  It reads n_pairs
//   and the cotangent from device memory: no host round trip.
// No float atomics anywhere: repeated runs are bit-identical.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// row i in dynamic shared memory stays under the 48 KB a block may take
// without opting in
constexpr int kMaxN = 8192;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum of `v` over the block in a fixed order; the result is valid in
// thread 0.  `scratch` holds kWarps floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = threadIdx.x < kWarps ? scratch[threadIdx.x] : 0.f;
  if (warp == 0) v = warp_sum(v);
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kThreads)
pairwise_rows_kernel(const float* __restrict__ f, const float* __restrict__ m,
                     float* __restrict__ partial, int batch, int n) {
  extern __shared__ float row[];  // row i, n floats
  __shared__ float scratch[kWarps];
  const int i = blockIdx.x;
  if (m[i] == 0.f) {  // uniform over the block
    if (threadIdx.x == 0) partial[i] = 0.f;
    return;
  }
  const float* fi = f + (long long)i * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) row[k] = fi[k];
  __syncthreads();
  float acc = 0.f;
  for (int j = i + 1; j < batch; ++j) {
    const float mj = m[j];
    if (mj == 0.f) continue;  // uniform over the block
    const float* fj = f + (long long)j * n;
    float s = 0.f;
    for (int k = threadIdx.x; k < n; k += blockDim.x)
      s += fabsf(row[k] - fj[k]);
    acc = fmaf(mj, s, acc);
  }
  acc = block_sum(acc, scratch);
  if (threadIdx.x == 0) partial[i] = acc;
}

__global__ void __launch_bounds__(kThreads)
pairwise_finalize_kernel(const float* __restrict__ partial,
                         const float* __restrict__ m, float* __restrict__ avg,
                         float* __restrict__ n_pairs, int batch, int n) {
  __shared__ float scratch[kWarps];
  float total = 0.f, s = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < batch; i += blockDim.x) {
    const float mi = m[i];
    total = fmaf(mi, partial[i], total);
    s += mi;
    s2 = fmaf(mi, mi, s2);
  }
  total = block_sum(total, scratch);
  s = block_sum(s, scratch);
  s2 = block_sum(s2, scratch);
  if (threadIdx.x == 0) {
    const float pairs = 0.5f * (s * s - s2);
    *n_pairs = pairs;
    *avg = pairs > 0.f ? total / (float)n / pairs : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
pairwise_backward_kernel(const float* __restrict__ f,
                         const float* __restrict__ m,
                         const float* __restrict__ n_pairs,
                         const float* __restrict__ cotangent,
                         float* __restrict__ g, int batch, int n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)batch * n) return;
  const int i = (int)(idx / n);
  const int k = (int)(idx - (long long)i * n);
  const float pairs = *n_pairs;
  const float mi = m[i];
  if (!(pairs > 0.f) || mi == 0.f) {
    g[idx] = 0.f;
    return;
  }
  const float x = f[idx];
  float acc = 0.f;
  for (int j = 0; j < batch; ++j) {
    const float mj = m[j];
    if (mj == 0.f) continue;  // uniform over the warp
    const float d = x - f[(long long)j * n + k];
    acc = fmaf(mj, (float)((d > 0.f) - (d < 0.f)), acc);
  }
  g[idx] = acc * (*cotangent * mi / (pairs * (float)n));
}

}  // namespace

// Forward: flat (B, N) and mask (B,) float32, contiguous, on the device;
// partial is a (B,) scratch; avg and n_pairs are one float each.  Launches
// both passes on `stream` and returns cudaGetLastError() (0 on success);
// shapes the kernel does not take return cudaErrorInvalidValue without
// launching.
extern "C" int pairwise_l1_forward(const void* flat, const void* mask,
                                   void* partial, void* avg, void* n_pairs,
                                   int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0 || n > kMaxN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(flat);
  const float* m = static_cast<const float*>(mask);
  pairwise_rows_kernel<<<batch, kThreads, n * sizeof(float), s>>>(
      f, m, static_cast<float*>(partial), batch, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pairwise_finalize_kernel<<<1, kThreads, 0, s>>>(
      static_cast<const float*>(partial), m, static_cast<float*>(avg),
      static_cast<float*>(n_pairs), batch, n);
  return (int)cudaGetLastError();
}

// Backward: grad (B, N) = d avg / d flat times the cotangent, which is read
// from device memory like n_pairs (the forward's output).
extern "C" int pairwise_l1_backward(const void* flat, const void* mask,
                                    const void* n_pairs,
                                    const void* cotangent, void* grad,
                                    int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)batch * n;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pairwise_backward_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const float*>(flat), static_cast<const float*>(mask),
      static_cast<const float*>(n_pairs),
      static_cast<const float*>(cotangent), static_cast<float*>(grad), batch,
      n);
  return (int)cudaGetLastError();
}

extern "C" const char* pairwise_l1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

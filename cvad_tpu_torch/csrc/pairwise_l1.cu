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
// - forward, pass 1: the rows are cut into tiles of 16 and N into chunks
//   of kChunk = 512 columns; block (tile pair I <= J, chunk) stages both
//   tiles' columns of its chunk in shared memory, kPiece = 256 at a time,
//   and thread (i, j) of its 16 x 16 sums |f_ik - f_jk| over the chunk's
//   columns in order and writes m_i m_j times that sum (0 unless i < j and
//   both rows are in the mask, so a masked-out row's values never reach
//   the sum) to a scratch indexed [tile pair][chunk][i][j] (the wrapper
//   sizes it).  Every block does the same work: at B = 64, N = 16384 that
//   is 10 tile pairs x 32 chunks = 320 blocks, at the main path's 256 x 256
//   136 x 1; rows past B are zeros.
// - forward, pass 2: one block of 1,024 threads adds the scratch in a fixed
//   order (thread t every 1,024th entry from t, then a fixed tree), sums m
//   and m^2, and writes avg and n_pairs to the device: no host round trip.
// - backward: one thread per (i, k), a loop over j; neighbouring threads
//   read neighbouring k of row j, so the loads coalesce.  It stages nothing,
//   so it takes any N as it is: the chunks of N are its blocks, in no
//   order, each output summed by one thread over j in order.  It reads
//   n_pairs and the cotangent from device memory: no host round trip.
// No float atomics anywhere: repeated runs are bit-identical.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 16;  // rows a tile; a block's 16 x 16 pairs
constexpr int kChunk = 512;    // columns a forward block sums over
constexpr int kPiece = 256;    // columns staged at a time
constexpr int kPad = kPiece + 1;  // a staged row: thread (i, j) reads row
                                  // j at stride kPad, on 16 banks
static_assert(kThreads == kTileRows * kTileRows, "a thread a pair");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum of `v` over the block in a fixed order; the result is valid in
// thread 0.  `scratch` holds a float for each warp.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = threadIdx.x < (blockDim.x >> 5) ? scratch[threadIdx.x] : 0.f;
  if (warp == 0) v = warp_sum(v);
  __syncthreads();
  return v;
}

// tile pair p (I <= J, row-major over the upper triangle of T tiles)
__device__ __forceinline__ void tile_pair(int p, int tiles, int& ti,
                                          int& tj) {
  ti = 0;
  while (p >= tiles - ti) {
    p -= tiles - ti;
    ++ti;
  }
  tj = ti + p;
}

// pass 1: block (tile pair, chunk); thread (i, j) = (tid / 16, tid % 16)
__global__ void __launch_bounds__(kThreads)
pairwise_tiles_kernel(const float* __restrict__ f, const float* __restrict__ m,
                      float* __restrict__ partial, int batch, int n,
                      int tiles) {
  __shared__ float rows_i[kTileRows][kPad], rows_j[kTileRows][kPad];
  int ti, tj;
  tile_pair(blockIdx.x, tiles, ti, tj);
  const int k0 = blockIdx.y * kChunk;
  const int k1 = min(k0 + kChunk, n);
  const int i = threadIdx.x / kTileRows, j = threadIdx.x % kTileRows;
  float acc = 0.f;
  for (int p0 = k0; p0 < k1; p0 += kPiece) {
    const int kn = min(kPiece, k1 - p0);
    if (p0 > k0) __syncthreads();  // the previous piece is read
    for (int e = threadIdx.x; e < kTileRows * kPiece; e += kThreads) {
      const int r = e / kPiece, k = e % kPiece;
      const int ri = ti * kTileRows + r, rj = tj * kTileRows + r;
      const bool in = k < kn;
      rows_i[r][k] = in && ri < batch ? f[(long long)ri * n + p0 + k] : 0.f;
      rows_j[r][k] = in && rj < batch ? f[(long long)rj * n + p0 + k] : 0.f;
    }
    __syncthreads();
    const float* a = rows_i[i];
    const float* b = rows_j[j];
#pragma unroll 8
    for (int k = 0; k < kn; ++k) acc += fabsf(a[k] - b[k]);
  }
  const int ri = ti * kTileRows + i, rj = tj * kTileRows + j;
  const float w = ri < rj && rj < batch ? m[ri] * m[rj] : 0.f;
  partial[((long long)blockIdx.x * gridDim.y + blockIdx.y) * kThreads
          + threadIdx.x] = w != 0.f ? w * acc : 0.f;
}

// pass 2: thread t adds entries t, t + kFinal, ... of the scratch in order,
// then the block adds the threads' sums in a fixed tree
constexpr int kFinal = 1024;

__global__ void __launch_bounds__(kFinal)
pairwise_finalize_kernel(const float* __restrict__ partial,
                         const float* __restrict__ m, float* __restrict__ avg,
                         float* __restrict__ n_pairs, int batch, int n,
                         long long entries) {
  __shared__ float scratch[kFinal / 32];
  float total = 0.f;
#pragma unroll 8
  for (long long e = threadIdx.x; e < entries; e += kFinal) total += partial[e];
  float s = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < batch; i += kFinal) {
    const float mi = m[i];
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

// Scratch of the forward: the float32 partials of pass 1 for (B, N).
extern "C" long long pairwise_l1_forward_scratch(int batch, int n) {
  if (batch <= 0 || n <= 0) return -1;
  const long long tiles = (batch + kTileRows - 1) / kTileRows;
  const long long chunks = (n + kChunk - 1) / kChunk;
  return tiles * (tiles + 1) / 2 * chunks * kThreads;
}

// Forward: flat (B, N) and mask (B,) float32, contiguous, on the device;
// partial is a scratch of pairwise_l1_forward_scratch() floats; avg and
// n_pairs are one float each.  Launches both passes on `stream` and returns
// cudaGetLastError() (0 on success); shapes the kernel does not take
// return cudaErrorInvalidValue without launching.
extern "C" int pairwise_l1_forward(const void* flat, const void* mask,
                                   void* partial, void* avg, void* n_pairs,
                                   int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (batch + kTileRows - 1) / kTileRows;
  const int chunks = (n + kChunk - 1) / kChunk;
  const long long pairs_t = (long long)tiles * (tiles + 1) / 2;
  if (pairs_t > INT_MAX || chunks > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(flat);
  const float* m = static_cast<const float*>(mask);
  pairwise_tiles_kernel<<<dim3((unsigned)pairs_t, chunks), kThreads, 0, s>>>(
      f, m, static_cast<float*>(partial), batch, n, tiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pairwise_finalize_kernel<<<1, kFinal, 0, s>>>(
      static_cast<const float*>(partial), m, static_cast<float*>(avg),
      static_cast<float*>(n_pairs), batch, n, pairs_t * chunks * kThreads);
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

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
// Launch latency (a few us) dominates both at that shape; the designs aim
// at filling the card with blocks that reuse what they load, at being
// exact and deterministic, and at never forming the (B, B, N) intermediate.
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
// - backward: block (column chunk, row tile, j split) of 256 threads.  The
//   plan (ops/pallas_kernels.py::pairwise_backward_plan, from B, N and the
//   SM count) sets the chunk (cols = 32, 64, 128 or 256 columns: the
//   narrowest whose row tile, 256 / cols x kBwdRows rows, B fills), the
//   number S <= 8 of j splits (enough blocks for two a SM where 8 splits
//   of whole 8-row pieces allow it) and the rows staged at a time.
//   Thread t owns column t % cols of the chunk and kBwdRows = 8 rows i of
//   the tile, their x = f_ik and sums in registers, so each staged f_jk
//   serves 8 compare-and-add steps, not one.  The split's j rows are
//   staged with their mask by cp.async (16-byte pieces where N % 4 == 0
//   and f is 16-byte aligned, 4-byte ones otherwise; columns past N
//   zero-filled) into one of two buffers, the next tile's copies in flight
//   while this one is summed; a tile whose rows all lie out of the mask is
//   not summed (a uniform branch on the staged mask).  sign(x - y) is
//   set.gt - set.lt, which is 0 at ties and for NaN.  With S = 1 the block
//   applies the scale and writes g.  With S > 1 the S blocks of a (chunk,
//   tile) form one thread-block cluster (Hopper): each leaves its sums in
//   its shared memory, and after a cluster barrier block z adds, for every
//   S-th group of 256 outputs from the z-th on, the S blocks' sums in rank
//   order through distributed shared memory and applies the scale: one
//   launch, no scratch in device memory.  With m in {0, 1} every sum is an
//   integer below 2^24, so g is exact and does not depend on S, and so not
//   on the card's SM count.  The scale is c m_i / (n_pairs N) as the plain
//   version rounds it; n_pairs and the cotangent are read from device
//   memory: no host round trip.
// No float atomics anywhere: repeated runs are bit-identical.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper_mma.cuh"

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

// ---------------------------------------------------------------------------
// backward

constexpr int kBwdThreads = 256;
constexpr int kBwdRows = 8;      // rows i a thread holds in registers (R)
constexpr int kBwdStage = 4096;  // floats of one staged tile of j rows
constexpr int kBwdMaxStageRows = kBwdStage / 32;  // at the narrowest chunk
constexpr int kBwdMaxSplits = 8;  // a portable cluster's blocks
constexpr int kBwdOutputs = kBwdThreads * kBwdRows;  // a block's outputs
static_assert(kBwdOutputs <= kBwdStage, "a block's sums fit a stage buffer");

// 4 bytes global -> shared, asynchronously; zero where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// 1.0f where a > b, else 0.0f (also for NaN): one FSET
__device__ __forceinline__ float set_gt(float a, float b) {
  float r;
  asm("set.gt.f32.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// c m_i / (n_pairs N) as the plain version rounds it; 0 without pairs or
// out of the mask
__device__ __forceinline__ float bwd_scale(float pairs, float c, float mi,
                                           int n) {
  return pairs > 0.f && mi != 0.f ? c * mi / (pairs * (float)n) : 0.f;
}

// rows [jt, jt + rows) of f, columns [k0, k0 + cols), into fs (row-major,
// cols a row; columns past n zero-filled), and their mask into ms
template <bool kVec>
__device__ __forceinline__ void stage_tile(float* fs, float* ms,
                                           const float* f, const float* m,
                                           int jt, int rows, int k0,
                                           int cols, int n) {
  const int tid = threadIdx.x;
  if (tid < rows) cp_async4(ms + tid, m + jt + tid, true);
  if (kVec) {  // 16-byte pieces, cols / 4 a row
    const int per_row = cols >> 2;
    for (int p = tid; p < rows * per_row; p += kBwdThreads) {
      const int r = p / per_row, c = (p - r * per_row) * 4;
      const bool ok = k0 + c < n;
      cp_async16(fs + r * cols + c,
                 ok ? f + (long long)(jt + r) * n + k0 + c : f, ok);
    }
  } else {
    for (int p = tid; p < rows * cols; p += kBwdThreads) {
      const int r = p / cols, c = p - r * cols;
      const bool ok = k0 + c < n;
      cp_async4(fs + r * cols + c,
                ok ? f + (long long)(jt + r) * n + k0 + c : f, ok);
    }
  }
}

// block (column chunk, row tile, j split), the splits of a (chunk, tile)
// one cluster; see the header
template <bool kVec>
__global__ void __launch_bounds__(kBwdThreads)
pairwise_backward_tiles_kernel(const float* __restrict__ f,
                               const float* __restrict__ m,
                               const float* __restrict__ n_pairs,
                               const float* __restrict__ cotangent,
                               float* __restrict__ out, int batch, int n,
                               int cols, int span, int stage_rows) {
  __shared__ __align__(16) float fs[2][kBwdStage];
  __shared__ float ms[2][kBwdMaxStageRows];
  const int tid = threadIdx.x;
  const int col = tid & (cols - 1);
  const int k0 = blockIdx.x * cols;
  const int k = k0 + col;
  const int i0 = blockIdx.y * (kBwdThreads / cols * kBwdRows)
                 + tid / cols * kBwdRows;
  const int j0 = blockIdx.z * span;
  const int j1 = min(batch, j0 + span);
  const int tiles = (j1 - j0 + stage_rows - 1) / stage_rows;

  // what the epilogue scales by, read while the first tile is staged
  const float pairs = __ldg(n_pairs), c = __ldg(cotangent);
  float x[kBwdRows], acc[kBwdRows], mi[kBwdRows];
#pragma unroll
  for (int r = 0; r < kBwdRows; ++r) {
    const int i = i0 + r;
    x[r] = i < batch && k < n ? __ldg(f + (long long)i * n + k) : 0.f;
    mi[r] = i < batch ? __ldg(m + i) : 0.f;
    acc[r] = 0.f;
  }

  stage_tile<kVec>(fs[0], ms[0], f, m, j0, min(stage_rows, j1 - j0), k0,
                   cols, n);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      const int jt = j0 + (t + 1) * stage_rows;
      stage_tile<kVec>(fs[(t + 1) & 1], ms[(t + 1) & 1], f, m, jt,
                       min(stage_rows, j1 - jt), k0, cols, n);
    }
    cp_async_commit();  // possibly empty: the wait below stays uniform
    cp_async_wait<1>();
    // thread r staged the mask of row r: after its wait it reads its own
    // copy, and the barrier makes the whole tile visible to every thread
    const int rows = min(stage_rows, j1 - (j0 + t * stage_rows));
    if (__syncthreads_or(tid < rows && ms[t & 1][tid] != 0.f)) {
      const float* fb = fs[t & 1] + col;
      const float* mb = ms[t & 1];
#pragma unroll 4
      for (int jj = 0; jj < rows; ++jj) {
        const float y = fb[jj * cols];
        const float w = mb[jj];
#pragma unroll
        for (int r = 0; r < kBwdRows; ++r)
          acc[r] = fmaf(w, set_gt(x[r], y) - set_gt(y, x[r]), acc[r]);
      }
    }
    __syncthreads();  // the buffer is read before it is staged again
  }

  if (gridDim.z == 1) {  // the only split: scale and write g
    if (k >= n) return;
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      const int i = i0 + r;
      if (i < batch)
        out[(long long)i * n + k] = acc[r] * bwd_scale(pairs, c, mi[r], n);
    }
    return;
  }
  // S > 1: this block's sums into its (now idle) stage buffer, output e of
  // the tile at e = row * cols + column; the cluster's blocks then add the
  // S sums of each output in rank order
  float* part = fs[0];
#pragma unroll
  for (int r = 0; r < kBwdRows; ++r)
    part[(tid / cols * kBwdRows + r) * cols + col] = acc[r];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = blockIdx.y * (kBwdOutputs / cols);
  for (int e = rank * kBwdThreads + tid; e < kBwdOutputs;
       e += splits * kBwdThreads) {
    const int i = row0 + e / cols, kk = k0 + (e & (cols - 1));
    const float scale = i < batch ? bwd_scale(pairs, c, __ldg(m + i), n)
                                  : 0.f;
    float v[kBwdMaxSplits];  // every block's sum in flight at once
#pragma unroll
    for (int s = 0; s < kBwdMaxSplits; ++s)
      v[s] = s < splits ? cluster.map_shared_rank(part, s)[e] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kBwdMaxSplits; ++s)
      if (s < splits) sum += v[s];
    if (i < batch && kk < n) out[(long long)i * n + kk] = sum * scale;
  }
  cluster.sync();  // no block leaves while another still reads its sums
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
// from device memory like n_pairs (the forward's output).  The plan comes
// from ops/pallas_kernels.py::pairwise_backward_plan: `cols` columns a
// block (32, 64, 128 or 256), `span` j rows a split (S = ceil(B / span)
// splits, at most 8: one cluster), `stage_rows` j rows staged at a time.
// Launches on `stream` and returns cudaGetLastError() (0 on success); a
// plan or shape the kernel does not take returns cudaErrorInvalidValue
// without launching.
extern "C" int pairwise_l1_backward(const void* flat, const void* mask,
                                    const void* n_pairs,
                                    const void* cotangent, void* grad,
                                    int batch, int n, int cols, int span,
                                    int stage_rows, void* stream) {
  if (batch <= 0 || n <= 0 || span <= 0 || stage_rows <= 0 ||
      stage_rows > span)
    return (int)cudaErrorInvalidValue;
  if (cols != 32 && cols != 64 && cols != 128 && cols != 256)
    return (int)cudaErrorInvalidValue;
  if (stage_rows * cols > kBwdStage) return (int)cudaErrorInvalidValue;
  const long long chunks = ((long long)n + cols - 1) / cols;
  const int tiles = (batch + kBwdOutputs / cols - 1) / (kBwdOutputs / cols);
  const int splits = (batch + span - 1) / span;
  if (chunks > INT_MAX || tiles > 65535 || splits > kBwdMaxSplits)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)chunks, tiles, splits);
  cfg.blockDim = dim3(kBwdThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const float* f = static_cast<const float*>(flat);
  const float* m = static_cast<const float*>(mask);
  const float* np = static_cast<const float*>(n_pairs);
  const float* ct = static_cast<const float*>(cotangent);
  float* g = static_cast<float*>(grad);
  const cudaError_t err =
      n % 4 == 0 && reinterpret_cast<uintptr_t>(flat) % 16 == 0
          ? cudaLaunchKernelEx(&cfg, pairwise_backward_tiles_kernel<true>, f,
                               m, np, ct, g, batch, n, cols, span,
                               stage_rows)
          : cudaLaunchKernelEx(&cfg, pairwise_backward_tiles_kernel<false>,
                               f, m, np, ct, g, batch, n, cols, span,
                               stage_rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* pairwise_l1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

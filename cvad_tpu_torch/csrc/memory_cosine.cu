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
//   iq_b   = 1 / sqrt(sum_k q_bk^2 + 1e-8)     (im_j the same for m_j)
//   s_bj   = clip((q_b . m_j) iq_b im_j, -1, 1)
//   out[b] = clamp(min(3, min_{j < f} (1 - s_bj)), 0, 2) / 2
// so f = 0 gives 1.0.  NaN propagates as in jnp.min / jnp.clip: a NaN
// query row, or a NaN memory row below the fill, gives NaN (every min and
// clamp here is written with comparisons that keep NaN; fminf would drop
// it).  Memory rows at or beyond the fill are never read.
//
// Bound on the H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside the tensor
// cores): the function reads (B + M) D 4 bytes once and writes B 4 bytes,
// and does 2 B f D float32 operations.  At the main path's (B, M, D) =
// (256, 500, 64): 0.24 us of operations; at (1024, 4096, 128) 16 us; at
// (16, 500, 2048) 1.3 us of bytes.  Everything but the large bank is far
// under the launch latency, so the design fills the card and reads each
// byte once, coalesced.
//
// Design: three kernels on the caller's stream; the wrapper
// (ops/pallas_kernels.py::memory_plan) picks the tile and the split of D
// from (B, M, D) and the card's SM count, and sizes the scratch.
// 1. memory_min_cosine_norms: one warp per query row and per bank row
//    below the fill computes 1 / norm (coalesced 16-byte loads, lanes
//    strided over D, a butterfly sum) into the scratch: each bank row's
//    norm once per call.
// 2. memory_min_cosine_tiles: a block per (bank tile, query tile, D
//    chunk).  Tiles are 64 query x 64 bank rows (256 threads, a 4 x 4
//    register micro-tile each) where those alone give a block per SM, else
//    16 x 32 (128 threads, 2 x 2).  32-wide slices of D of both tiles go
//    to shared memory by cp.async (16-byte pieces, 8 threads a 128-byte
//    row segment; 4-byte pieces where D % 4 != 0), double-buffered, rows
//    padded to 36 floats so each thread's float4 reads along D hit
//    distinct banks.  One loaded value feeds TQ or TM FMAs.  Where the
//    tiles alone leave SMs idle, D is split into chunks (a multiple of 16
//    wide) and each block writes its partial dot products to the scratch;
//    otherwise the epilogue scales, applies 1 - clip, masks j >= fill and
//    takes the row minimum over its bank columns (a half-warp butterfly),
//    one partial minimum per (bank tile, query row).  Bank tiles that
//    start at or beyond the fill exit at once; the fill is read on the
//    device, so the host never syncs on it.
// 3. memory_min_cosine_combine: the partial minima in tile order, or, with
//    a split of D, per (b, j < fill) the partial dot products summed in
//    split order, then the epilogue and a block minimum.
// No float atomics anywhere: every sum runs in a fixed order and min is
// exact, so a second call is bit-identical.  Float32 FMAs on the CUDA
// cores (the 1e-6 bound against the plain version leaves no room for one
// TF32 product).

#include <cuda_runtime.h>

#include <math.h>

#include "hopper_mma.cuh"

namespace {

constexpr float kEps = 1e-8f;
constexpr int kKc = 32;          // columns of D staged per step
constexpr int kRow = kKc + 4;    // a staged row: 144 bytes, 16-byte aligned
constexpr int kChunkAlign = 16;  // a chunk of split D is a multiple of this
constexpr int kNormWarps = 8;    // rows per block of the norms kernel

// min that keeps NaN from either side (jnp.min, torch.amin)
__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a) return a;
  return (b >= a) ? a : b;  // b < a, or b NaN, takes b
}

// clamp to [lo, hi] that keeps NaN (jnp.clip, torch.clamp)
__device__ __forceinline__ float nan_clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float distance(float dot, float iq, float im) {
  return 1.0f - nan_clamp(dot * iq * im, -1.f, 1.f);
}

__device__ __forceinline__ int read_fill(const int* fill_ptr, int m_rows) {
  const int f = *fill_ptr;
  return f < 0 ? 0 : (f > m_rows ? m_rows : f);
}

// 4 bytes global -> shared, asynchronously; zero where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// 1 / sqrt(sum x^2 + eps) of every query row and of the bank rows below
// the fill, one warp a row: inv[0, B) for the query, inv[B, B + M) for
// the bank
template <bool kVec>
__global__ void __launch_bounds__(kNormWarps * 32)
memory_min_cosine_norms(const float* __restrict__ query,
                        const float* __restrict__ memory,
                        const int* __restrict__ fill_ptr,
                        float* __restrict__ inv, int batch, int m_rows,
                        int dim) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kNormWarps + (threadIdx.x >> 5);
  const int fill = read_fill(fill_ptr, m_rows);
  if (row >= batch + fill) return;  // the whole warp
  const float* src = row < batch ? query + (long long)row * dim
                                 : memory + (long long)(row - batch) * dim;
  float ss = 0.f;
  if (kVec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int k = lane; k < dim / 4; k += 32) {
      const float4 v = __ldg(s4 + k);
      ss = fmaf(v.x, v.x, ss);
      ss = fmaf(v.y, v.y, ss);
      ss = fmaf(v.z, v.z, ss);
      ss = fmaf(v.w, v.w, ss);
    }
  } else {
    for (int k = lane; k < dim; k += 32) {
      const float v = __ldg(src + k);
      ss = fmaf(v, v, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (lane == 0) inv[row] = 1.0f / sqrtf(ss + kEps);
}

// One (bank tile, query tile, D chunk) per block; see the header.  Thread
// (tx, ty) = (tid % 16, tid / 16) owns query rows ty + i BQ/TQ and bank
// rows tx + jj 16 of the tile, so the 16 threads of a half-warp share
// their query rows (broadcast reads) and read 16 consecutive bank rows.
template <int BQ, int BM, int TQ, int TM, bool kVec>
__global__ void __launch_bounds__((BQ / TQ) * (BM / TM))
memory_min_cosine_tiles(const float* __restrict__ query,
                        const float* __restrict__ memory,
                        const int* __restrict__ fill_ptr,
                        const float* __restrict__ inv,
                        float* __restrict__ part, int batch, int m_rows,
                        int dim, int chunk, int split_mode) {
  constexpr int kThreads = (BQ / TQ) * (BM / TM);
  constexpr int kTy = BQ / TQ;
  static_assert(BM / TM == 16, "16 threads across a bank tile");
  __shared__ __align__(16) float qs[2][BQ][kRow];
  __shared__ __align__(16) float ms[2][BM][kRow];

  const int fill = read_fill(fill_ptr, m_rows);
  const int j0 = blockIdx.x * BM;
  if (j0 >= fill) return;  // the whole block: this bank tile is past the fill
  const int b0 = blockIdx.y * BQ;
  const int d0 = blockIdx.z * chunk;
  const int d1 = min(dim, d0 + chunk);
  const int steps = (d1 - d0 + kKc - 1) / kKc;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  auto stage = [&](int buf, int step) {
    const int ds = d0 + step * kKc;
    if (kVec) {  // 16-byte pieces: 8 a row segment
      for (int i = tid; i < (BQ + BM) * (kKc / 4); i += kThreads) {
        const int r = i >> 3, d = ds + (i & 7) * 4;
        if (r < BQ) {
          const int b = b0 + r;
          const bool ok = b < batch && d < d1;
          cp_async16(&qs[buf][r][(i & 7) * 4],
                     ok ? query + (long long)b * dim + d : query, ok);
        } else {
          const int j = j0 + r - BQ;
          const bool ok = j < fill && d < d1;
          cp_async16(&ms[buf][r - BQ][(i & 7) * 4],
                     ok ? memory + (long long)j * dim + d : memory, ok);
        }
      }
    } else {  // 4-byte pieces: a warp a row segment
      for (int i = tid; i < (BQ + BM) * kKc; i += kThreads) {
        const int r = i / kKc, c = i % kKc, d = ds + c;
        if (r < BQ) {
          const int b = b0 + r;
          const bool ok = b < batch && d < d1;
          cp_async4(&qs[buf][r][c], ok ? query + (long long)b * dim + d
                                       : query, ok);
        } else {
          const int j = j0 + r - BQ;
          const bool ok = j < fill && d < d1;
          cp_async4(&ms[buf][r - BQ][c], ok ? memory + (long long)j * dim + d
                                           : memory, ok);
        }
      }
    }
  };

  float acc[TQ][TM];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int jj = 0; jj < TM; ++jj) acc[i][jj] = 0.f;

  stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) stage((s + 1) & 1, s + 1);
    cp_async_commit();  // possibly empty: the wait below stays uniform
    cp_async_wait<1>();
    __syncthreads();
    const int buf = s & 1;
#pragma unroll
    for (int k = 0; k < kKc; k += 4) {
      float4 a[TQ], m[TM];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
        a[i] = *reinterpret_cast<const float4*>(&qs[buf][ty + i * kTy][k]);
#pragma unroll
      for (int jj = 0; jj < TM; ++jj)
        m[jj] = *reinterpret_cast<const float4*>(&ms[buf][tx + jj * 16][k]);
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int jj = 0; jj < TM; ++jj) {
          float v = acc[i][jj];
          v = fmaf(a[i].x, m[jj].x, v);
          v = fmaf(a[i].y, m[jj].y, v);
          v = fmaf(a[i].z, m[jj].z, v);
          v = fmaf(a[i].w, m[jj].w, v);
          acc[i][jj] = v;
        }
    }
    __syncthreads();  // the buffer is read before it is staged again
  }

  if (split_mode) {  // partial dot products, part[(z, b, j)]
    float* dst = part + (long long)blockIdx.z * batch * m_rows;
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int b = b0 + ty + i * kTy;
      if (b >= batch) continue;
#pragma unroll
      for (int jj = 0; jj < TM; ++jj) {
        const int j = j0 + tx + jj * 16;
        if (j < fill) dst[(long long)b * m_rows + j] = acc[i][jj];
      }
    }
    return;
  }
  // partial minima over this bank tile, part[(bank tile, b)]
  const float* inv_m = inv + batch;
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int b = b0 + ty + i * kTy;
    const float iq = b < batch ? inv[b] : 0.f;
    float best = 3.0f;
#pragma unroll
    for (int jj = 0; jj < TM; ++jj) {
      const int j = j0 + tx + jj * 16;
      if (j < fill) best = nan_min(best, distance(acc[i][jj], iq, inv_m[j]));
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)  // the 16 threads of a half-warp
      best = nan_min(best, __shfl_xor_sync(0xffffffffu, best, off));
    if (tx == 0 && b < batch) part[(long long)blockIdx.x * batch + b] = best;
  }
}

// out[b] from the partial minima of the bank tiles below the fill, in
// tile order
__global__ void __launch_bounds__(256)
memory_min_cosine_combine_min(const float* __restrict__ part,
                              const int* __restrict__ fill_ptr,
                              float* __restrict__ out, int batch, int m_rows,
                              int bank_tile) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int tiles = (read_fill(fill_ptr, m_rows) + bank_tile - 1) / bank_tile;
  float v = 3.0f;
  for (int t = 0; t < tiles; ++t)
    v = nan_min(v, part[(long long)t * batch + b]);
  out[b] = nan_clamp(v, 0.f, 2.f) * 0.5f;
}

// out[b], one block a query row, from the partial dot products of a split
// D: for each j < fill the splits summed in order, then the epilogue
__global__ void __launch_bounds__(256)
memory_min_cosine_combine_split(const float* __restrict__ part,
                                const float* __restrict__ inv,
                                const int* __restrict__ fill_ptr,
                                float* __restrict__ out, int batch,
                                int m_rows, int splits) {
  __shared__ float warp_best[8];
  const int b = blockIdx.x;
  const int fill = read_fill(fill_ptr, m_rows);
  const float iq = inv[b];
  const float* inv_m = inv + batch;
  const long long stride = (long long)batch * m_rows;
  const float* p = part + (long long)b * m_rows;
  float best = 3.0f;
  for (int j = threadIdx.x; j < fill; j += blockDim.x) {
    float dot = 0.f;
    for (int z = 0; z < splits; ++z) dot += p[z * stride + j];
    best = nan_min(best, distance(dot, iq, inv_m[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = nan_min(best, __shfl_xor_sync(0xffffffffu, best, off));
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = warp_best[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      v = nan_min(v, warp_best[w]);
    out[b] = nan_clamp(v, 0.f, 2.f) * 0.5f;
  }
}

// the tiles by config: {query rows, bank rows} (ops/pallas_kernels.py's
// MEM_TILES)
constexpr int kTileQ[2] = {64, 16};
constexpr int kTileM[2] = {64, 32};

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// scratch floats the plan needs: the inverse norms, then the partial
// minima (one a bank tile and query row) or, with a split D, the partial
// dot products (one a split, query row and bank row)
long long scratch_floats(int batch, int m_rows, int tile, int splits) {
  const long long parts = splits > 1
      ? (long long)splits * batch * m_rows
      : ceil_div(m_rows, kTileM[tile]) * batch;
  return (long long)batch + m_rows + parts;
}

template <bool kVec>
cudaError_t launch(const float* q, const float* m, const int* fill,
                   float* scratch, float* out, int batch, int m_rows, int dim,
                   int tile, int splits, int chunk, cudaStream_t s) {
  float* inv = scratch;
  float* part = scratch + batch + m_rows;
  memory_min_cosine_norms<kVec>
      <<<(unsigned)ceil_div((long long)batch + m_rows, kNormWarps),
         kNormWarps * 32, 0, s>>>(q, m, fill, inv, batch, m_rows, dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)ceil_div(m_rows, kTileM[tile]),
                  (unsigned)ceil_div(batch, kTileQ[tile]), (unsigned)splits);
  const int split_mode = splits > 1;
  if (tile == 0)
    memory_min_cosine_tiles<64, 64, 4, 4, kVec><<<grid, 256, 0, s>>>(
        q, m, fill, inv, part, batch, m_rows, dim, chunk, split_mode);
  else
    memory_min_cosine_tiles<16, 32, 2, 2, kVec><<<grid, 128, 0, s>>>(
        q, m, fill, inv, part, batch, m_rows, dim, chunk, split_mode);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (split_mode)
    memory_min_cosine_combine_split<<<batch, 256, 0, s>>>(
        part, inv, fill, out, batch, m_rows, splits);
  else
    memory_min_cosine_combine_min<<<(unsigned)ceil_div(batch, 256), 256, 0,
                                    s>>>(part, fill, out, batch, m_rows,
                                         kTileM[tile]);
  return cudaGetLastError();
}

}  // namespace

// query (B, D) and memory (M, D) float32, contiguous, on the device; fill
// is one int32 on the device; out is (B,) float32; scratch holds
// `scratch_len` floats.  tile (0: 64 x 64, 1: 16 x 32), splits and chunk
// are the wrapper's plan: D is cut into `splits` chunks of `chunk`
// columns (a multiple of 16; the last may be shorter).  Launches three
// kernels on `stream` and returns cudaGetLastError() (0 on success); a
// plan or shape the kernels do not take returns cudaErrorInvalidValue
// without launching.
extern "C" int memory_min_cosine_forward(const void* query, const void* memory,
                                         const void* fill, void* scratch,
                                         long long scratch_len, void* out,
                                         int batch, int m_rows, int dim,
                                         int tile, int splits, int chunk,
                                         void* stream) {
  if (batch <= 0 || m_rows <= 0 || dim <= 0 || (tile != 0 && tile != 1)
      || splits < 1 || splits > 65535 || chunk <= 0
      || chunk % kChunkAlign != 0
      || (long long)(splits - 1) * chunk >= dim
      || (long long)splits * chunk < dim
      || ceil_div(batch, kTileQ[tile]) > 65535
      || ceil_div((long long)batch + m_rows, kNormWarps) > 0x7fffffffLL
      || scratch_len < scratch_floats(batch, m_rows, tile, splits))
    return (int)cudaErrorInvalidValue;
  const bool vec = dim % 4 == 0
      && reinterpret_cast<uintptr_t>(query) % 16 == 0
      && reinterpret_cast<uintptr_t>(memory) % 16 == 0;
  const auto* q = static_cast<const float*>(query);
  const auto* m = static_cast<const float*>(memory);
  const auto* f = static_cast<const int*>(fill);
  auto* sc = static_cast<float*>(scratch);
  auto* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch<true>(q, m, f, sc, o, batch, m_rows, dim, tile,
                                  splits, chunk, s)
                   : launch<false>(q, m, f, sc, o, batch, m_rows, dim, tile,
                                   splits, chunk, s));
}

extern "C" const char* memory_min_cosine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Flash attention (K6), forward and backward, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU flash attention of jax 0.9.0
// (jax/experimental/pallas/ops/tpu/flash_attention.py), which
// cvad_tpu/ops/attention.py::multi_head_attention calls (:47-50) when T and
// the head dim are multiples of 128: the forward kernel
// (_flash_attention_kernel, pl.pallas_call at :758), and the two kernels of
// its custom VJP (_flash_attention_bwd, :254-315): dK/dV
// (_flash_attention_dkv_kernel, pl.pallas_call at :1121) and dQ
// (_flash_attention_dq_kernel, pl.pallas_call at :1456).
//
// What it computes, for q, k, v (BH, T, D) with D any positive multiple of
// 128, float32 or bfloat16, row-major, and a scale c (D^-1/2 in the model):
//   s_ij = c * (q_i . k_j)          (f32 sums; c applied after the product)
//   s_ij = -inf where j > i          (causal only)
//   o_i  = sum_j softmax_j(s_i)_j v_j, with P cast to v's type before PV
//   lse_i = m_i + log(l_i)           (row max m, row sum l of exp(s - m))
// and the backward, as the library's VJP:
//   D_i  = sum_d o_id do_id                       (in f32, :273-275)
//   P_ij = exp(s_ij - lse_i)                      (recomputed, never stored)
//   dV_j = sum_i P_ij do_i      (P cast to do's type)
//   dS_ij = P_ij (do_i . v_j - D_i) c
//   dK_j = sum_i dS_ij q_i      dQ_i = sum_j dS_ij k_j   (dS cast to the type)
// Every sum is float32; outputs are cast to the input type once.
//
// Bound (H100 SXM, dense peaks): the forward does 4 BH T^2 D operations
// (two products); the backward needs at least 10 BH T^2 D (five products,
// QK^T recomputed), and this design's dQ kernel does 6 and its dK/dV
// kernel 8 (each recomputes QK^T and dO V^T); all halved when causal.  At
// the main path's (BH, T) = (16, 128), float32: 134 MFLOP forward -> 2.0 us
// at 67 TFLOP/s on the CUDA cores, and q, k, v read once and o written
// once, 4.2 MB -> 1.3 us at 3.35 TB/s; both sit under the launch latency
// (a few us), and 2 query tiles x 16 heads fill 32 of the 132 SMs.  At a
// long window, (8, 2048), the forward is 17.2 GFLOP -> 0.26 ms in float32:
// operations bound.
//
// Design (simple and exact first: CUDA-core f32 FMAs, no tensor cores, no
// TMA; a later PR's work):
// - the head dim is cut into 128-wide chunks (nc = D / 128).  A third grid
//   dimension runs over the chunks of the output (O in the forward, dQ in
//   the dQ kernel, dK and dV in the dK/dV kernel), so a block's tiles keep
//   the size they have at D = 128.  The products over the head dim (QK^T,
//   dO V^T, and D = rowsum(dO O)) loop over the chunks in order, so every
//   chunk's block computes the same scores and row statistics bit for bit;
//   only chunk 0 writes lse and D.  At D = 128 (nc = 1) Q (forward, dQ) and
//   K, V (dK/dV) are staged once, as before the chunks existed; for nc > 1
//   each chunk is staged as the loop reaches it, and each of the nc blocks
//   of a tile recomputes the scores (at D = 256 the forward does 1.5x the
//   operations of one pass);
// - tiles of 64 query rows and 64 key rows; 256 threads as a 16 x 16 grid,
//   thread (ty, tx) owning rows ty + 16 i (i < 4) and columns tx + 16 j of
//   each 64 x 64 score tile, and columns tx + 16 c (c < 8) of each 64 x 128
//   output chunk;
// - tiles staged in dynamic shared memory as float32 with a padded row
//   stride (129 and 65 floats) so that the 16 column-owning threads of a
//   row read 16 banks; 113-162 KB a block, above the 48 KB default, so the
//   launcher raises the limit with cudaFuncSetAttribute (once per kernel
//   and device);
// - forward: one block per (bh, query tile), K/V tiles streamed through
//   shared memory with an online softmax (running max and sum in
//   registers, reduced over the 16 threads of a row with xor shuffles,
//   which give every lane the same bits); causal blocks stop at the
//   diagonal tile;
// - backward: the dQ kernel (one block per (bh, query tile), a loop over
//   key tiles) also computes D for its rows and writes it; the dK/dV kernel
//   (one block per (bh, key tile), a loop over query tiles) runs after it on
//   the same stream and reads D.  Each output element is summed by one
//   thread in a fixed order: no float atomics, so a second call is
//   bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <math.h>

namespace {

constexpr int kD = 128;        // head-dim chunk: a tile's width
constexpr int kBQ = 64;        // query rows a tile
constexpr int kBK = 64;        // key rows a tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLd = kD + 1;    // padded row stride of a (rows, D) tile
constexpr int kLp = kBK + 1;   // padded row stride of a (BQ, BK) tile
constexpr int kTile = kBQ * kLd;   // floats of a (64, D) tile
constexpr int kPTile = kBQ * kLp;  // floats of a (64, 64) tile

static_assert(kBQ == kBK, "causal tile bounds assume square tiles");
static_assert(kBQ == 64 && kBK == 64 && kD == 128 && kThreads == 256,
              "the 16 x 16 thread grid owns 4 rows and 4 or 8 columns");

constexpr size_t kFwdSmem = (3 * kTile + kPTile) * sizeof(float);
constexpr size_t kDqSmem = (4 * kTile + kPTile) * sizeof(float);
constexpr size_t kDkvSmem = (4 * kTile + 2 * kPTile + 2 * kBQ) * sizeof(float);

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
  // the value a cast to bfloat16 (round to nearest even) leaves
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

// a (64, 128) tile of global memory (rows `ld` elements apart) into shared
// memory as float32 (row stride kLd); consecutive threads read consecutive
// elements
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int ld) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < kBQ * kD; idx += kThreads) {
    const int r = idx / kD, c = idx % kD;
    dst[r * kLd + c] = Io<T>::load(src + (long long)r * ld + c);
  }
}

// max and sum over the 16 threads of a row (lanes of one half-warp); every
// lane ends with the same bits, as float max and + are commutative
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// forward: one block per (query tile, bh, output chunk)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int seq, int dim, float scale,
                 int causal) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile;
  float* vs = ks + kTile;
  float* ps = vs + kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int qt = blockIdx.x;
  const long long bh = blockIdx.y;
  const int oc = blockIdx.z, nc = dim / kD;
  const long long base = bh * seq * dim;
  const int q0 = qt * kBQ;
  const T* qrow = q + base + (long long)q0 * dim;

  if (nc == 1) load_tile<T>(qs, qrow, dim);

  float acc[4][8], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = causal ? qt + 1 : seq / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const long long krow = base + (long long)k0 * dim;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int dc = 0; dc < nc; ++dc) {
      __syncthreads();  // the previous chunk's (or tile's) tiles are read
      if (nc > 1) load_tile<T>(qs, qrow + dc * kD, dim);
      load_tile<T>(ks, k + krow + dc * kD, dim);
      if (dc == nc - 1) load_tile<T>(vs, v + krow + oc * kD, dim);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < kD; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * kLd + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * kLd + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= scale;
        if (causal && k0 + tx + 16 * j > row) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);  // 0 where masked
        psum += p;
        ps[(ty + 16 * i) * kLp + tx + 16 * j] = Io<T>::round(p);
      }
      l[i] = alpha * l[i] + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ps[(ty + 16 * i) * kLp + kk];
#pragma unroll
      for (int c = 0; c < 8; ++c) b[c] = vs[kk * kLd + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const float inv = 1.0f / l[i];
    T* orow = o + base + (long long)row * dim + oc * kD;
#pragma unroll
    for (int c = 0; c < 8; ++c) Io<T>::store(orow + tx + 16 * c, acc[i][c] * inv);
    if (tx == 0 && oc == 0) lse[bh * seq + row] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// backward, dQ (and D): one block per (query tile, bh, output chunk)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ dvec, T* __restrict__ dq, int seq,
                    int dim, float scale, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile;
  float* ks = dos + kTile;
  float* vs = ks + kTile;
  float* dss = vs + kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int qt = blockIdx.x;
  const long long bh = blockIdx.y;
  const int oc = blockIdx.z, nc = dim / kD;
  const long long base = bh * seq * dim;
  const int q0 = qt * kBQ;
  const long long qrow = base + (long long)q0 * dim;

  // D = rowsum(dO * O) over the whole head dim, chunk by chunk in order
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  for (int dc = 0; dc < nc; ++dc) {
    if (dc > 0) __syncthreads();  // the previous chunk's dos and O are read
    if (nc == 1) load_tile<T>(qs, q + qrow, dim);
    load_tile<T>(dos, dout + qrow + dc * kD, dim);
    load_tile<T>(ks, o + qrow + dc * kD, dim);  // O, for D only
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        part[i] = fmaf(dos[r * kLd + tx + 16 * c], ks[r * kLd + tx + 16 * c],
                       part[i]);
    }
  }
  float di[4], li[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    di[i] = row_sum(part[i]);
    li[i] = lse[bh * seq + q0 + r];
    if (tx == 0 && oc == 0) dvec[bh * seq + q0 + r] = di[i];
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  const int n_kt = causal ? qt + 1 : seq / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const long long krow = base + (long long)k0 * dim;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int dc = 0; dc < nc; ++dc) {
      __syncthreads();  // O or the previous chunk's (or tile's) tiles are read
      if (nc > 1) {
        load_tile<T>(qs, q + qrow + dc * kD, dim);
        load_tile<T>(dos, dout + qrow + dc * kD, dim);
      }
      load_tile<T>(ks, k + krow + dc * kD, dim);
      load_tile<T>(vs, v + krow + dc * kD, dim);
      __syncthreads();
#pragma unroll 2
      for (int d = 0; d < kD; ++d) {
        float aq[4], ad[4], bk[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          aq[i] = qs[(ty + 16 * i) * kLd + d];
          ad[i] = dos[(ty + 16 * i) * kLd + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bk[j] = ks[(tx + 16 * j) * kLd + d];
          bv[j] = vs[(tx + 16 * j) * kLd + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(aq[i], bk[j], s[i][j]);
            dp[i][j] = fmaf(ad[i], bv[j], dp[i][j]);
          }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool masked = causal && k0 + tx + 16 * j > row;
        const float p = masked ? 0.f : expf(s[i][j] * scale - li[i]);
        dss[(ty + 16 * i) * kLp + tx + 16 * j] =
            Io<T>::round((dp[i][j] - di[i]) * p * scale);
      }
    }
    __syncthreads();
    if (oc != nc - 1) {  // K's chunk oc for dS K; ks holds chunk nc - 1
      load_tile<T>(ks, k + krow + oc * kD, dim);
      __syncthreads();
    }

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dss[(ty + 16 * i) * kLp + kk];
#pragma unroll
      for (int c = 0; c < 8; ++c) b[c] = ks[kk * kLd + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* row = dq + base + (long long)(q0 + ty + 16 * i) * dim + oc * kD;
#pragma unroll
    for (int c = 0; c < 8; ++c) Io<T>::store(row + tx + 16 * c, acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// backward, dK and dV: one block per (key tile, bh, output chunk), after the
// dQ kernel
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec, T* __restrict__ dk,
                     T* __restrict__ dv, int seq, int dim, float scale,
                     int causal) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile;
  float* qs = vs + kTile;
  float* dos = qs + kTile;
  float* pss = dos + kTile;
  float* dss = pss + kPTile;
  float* lse_s = dss + kPTile;
  float* d_s = lse_s + kBQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int kt = blockIdx.x;
  const long long bh = blockIdx.y;
  const int oc = blockIdx.z, nc = dim / kD;
  const long long base = bh * seq * dim;
  const int k0 = kt * kBK;
  const long long krow = base + (long long)k0 * dim;

  if (nc == 1) {
    load_tile<T>(ks, k + krow, dim);
    load_tile<T>(vs, v + krow, dim);
  }

  float ak[4][8], av[4][8];  // rows: keys ty + 16 i; columns tx + 16 c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) ak[i][c] = av[i][c] = 0.f;

  const int n_qt = seq / kBQ;
  for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ;
    const long long qrow = base + (long long)q0 * dim;
    // scores with rows = queries ty + 16 i, columns = keys tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int dc = 0; dc < nc; ++dc) {
      __syncthreads();  // the previous chunk's (or tile's) tiles are read
      if (nc > 1) {
        load_tile<T>(ks, k + krow + dc * kD, dim);
        load_tile<T>(vs, v + krow + dc * kD, dim);
      }
      load_tile<T>(qs, q + qrow + dc * kD, dim);
      load_tile<T>(dos, dout + qrow + dc * kD, dim);
      if (dc == 0 && threadIdx.x < kBQ) {
        lse_s[threadIdx.x] = lse[bh * seq + q0 + threadIdx.x];
        d_s[threadIdx.x] = dvec[bh * seq + q0 + threadIdx.x];
      }
      __syncthreads();
#pragma unroll 2
      for (int d = 0; d < kD; ++d) {
        float aq[4], ad[4], bk[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          aq[i] = qs[(ty + 16 * i) * kLd + d];
          ad[i] = dos[(ty + 16 * i) * kLd + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bk[j] = ks[(tx + 16 * j) * kLd + d];
          bv[j] = vs[(tx + 16 * j) * kLd + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(aq[i], bk[j], s[i][j]);
            dp[i][j] = fmaf(ad[i], bv[j], dp[i][j]);
          }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool masked = causal && k0 + tx + 16 * j > q0 + r;
        const float p = masked ? 0.f : expf(s[i][j] * scale - lse_s[r]);
        pss[r * kLp + tx + 16 * j] = Io<T>::round(p);
        dss[r * kLp + tx + 16 * j] =
            Io<T>::round((dp[i][j] - d_s[r]) * p * scale);
      }
    }
    __syncthreads();
    if (oc != nc - 1) {  // Q's and dO's chunk oc; qs, dos hold chunk nc - 1
      load_tile<T>(qs, q + qrow + oc * kD, dim);
      load_tile<T>(dos, dout + qrow + oc * kD, dim);
      __syncthreads();
    }

    // dV_j += sum_i P_ij dO_i, dK_j += sum_i dS_ij Q_i
#pragma unroll 2
    for (int qq = 0; qq < kBQ; ++qq) {
      float ap[4], as[4], bo[8], bq[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ap[i] = pss[qq * kLp + ty + 16 * i];
        as[i] = dss[qq * kLp + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        bo[c] = dos[qq * kLd + tx + 16 * c];
        bq[c] = qs[qq * kLd + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          av[i][c] = fmaf(ap[i], bo[c], av[i][c]);
          ak[i][c] = fmaf(as[i], bq[c], ak[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long off =
        base + (long long)(k0 + ty + 16 * i) * dim + oc * kD;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      Io<T>::store(dk + off + tx + 16 * c, ak[i][c]);
      Io<T>::store(dv + off + tx + 16 * c, av[i][c]);
    }
  }
}

// the launch geometry every entry point shares; cudaErrorInvalidValue for
// shapes the kernels do not take
cudaError_t check_shape(int bh, int seq, int dim) {
  if (bh <= 0 || bh > 65535 || dim <= 0 || dim % kD != 0
      || dim / kD > 65535 || seq <= 0 || seq % kBQ != 0)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The dynamic shared-memory limit is raised once per kernel and device, not
// at every launch: each launcher keeps its own `done` flags, one per device
// (threads racing on a first launch all set the same value, harmlessly).
constexpr int kMaxDevices = 64;
using SmemFlags = std::atomic<bool>[kMaxDevices];

template <typename Kernel>
cudaError_t allow_smem(SmemFlags& done, Kernel kernel, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

template <typename T>
int forward(const void* q, const void* k, const void* v, void* o, void* lse,
            int bh, int seq, int dim, float scale, int causal,
            cudaStream_t stream) {
  static SmemFlags done;
  cudaError_t err = allow_smem(done, flash_fwd_kernel<T>, kFwdSmem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<T>
      <<<dim3(seq / kBQ, bh, dim / kD), kThreads, kFwdSmem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o),
          static_cast<float*>(lse), seq, dim, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int backward_dq(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* dvec, void* dq,
                int bh, int seq, int dim, float scale, int causal,
                cudaStream_t stream) {
  static SmemFlags done;
  cudaError_t err = allow_smem(done, flash_bwd_dq_kernel<T>, kDqSmem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T>
      <<<dim3(seq / kBQ, bh, dim / kD), kThreads, kDqSmem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(o),
          static_cast<const T*>(dout), static_cast<const float*>(lse),
          static_cast<float*>(dvec), static_cast<T*>(dq), seq, dim, scale,
          causal);
  return (int)cudaGetLastError();
}

template <typename T>
int backward_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* dvec,
                 void* dk, void* dv, int bh, int seq, int dim, float scale,
                 int causal, cudaStream_t stream) {
  static SmemFlags done;
  cudaError_t err = allow_smem(done, flash_bwd_dkv_kernel<T>, kDkvSmem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<T>
      <<<dim3(seq / kBK, bh, dim / kD), kThreads, kDkvSmem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(dvec),
          static_cast<T*>(dk), static_cast<T*>(dv), seq, dim, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o (BH, T, D) contiguous on the device, float32 (bf16 = 0) or
// bfloat16 (bf16 = 1); lse (BH, T) float32.  Each entry point launches one
// kernel on `stream` and returns cudaGetLastError() (0 on success), or the
// error of cudaGetDevice or cudaFuncSetAttribute; shapes the kernels do not
// take (D not a positive multiple of 128, T not a positive multiple of 64,
// BH outside 1..65535) return cudaErrorInvalidValue without launching.
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int bh, int seq, int dim, float scale,
                                       int causal, int bf16, void* stream) {
  cudaError_t err = check_shape(bh, seq, dim);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? forward<__nv_bfloat16>(q, k, v, o, lse, bh, seq, dim, scale,
                                       causal, s)
              : forward<float>(q, k, v, o, lse, bh, seq, dim, scale, causal,
                               s);
}

// dQ and D = rowsum(dO * O) (dvec, (BH, T) float32); run before the dK/dV
// entry point, which reads D.
extern "C" int flash_attention_backward_dq(const void* q, const void* k,
                                           const void* v, const void* o,
                                           const void* dout, const void* lse,
                                           void* dvec, void* dq, int bh,
                                           int seq, int dim, float scale,
                                           int causal, int bf16,
                                           void* stream) {
  cudaError_t err = check_shape(bh, seq, dim);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? backward_dq<__nv_bfloat16>(q, k, v, o, dout, lse, dvec, dq,
                                           bh, seq, dim, scale, causal, s)
              : backward_dq<float>(q, k, v, o, dout, lse, dvec, dq, bh, seq,
                                   dim, scale, causal, s);
}

extern "C" int flash_attention_backward_dkv(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const void* lse, const void* dvec,
                                            void* dk, void* dv, int bh,
                                            int seq, int dim, float scale,
                                            int causal, int bf16,
                                            void* stream) {
  cudaError_t err = check_shape(bh, seq, dim);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? backward_dkv<__nv_bfloat16>(q, k, v, dout, lse, dvec, dk, dv,
                                            bh, seq, dim, scale, causal, s)
              : backward_dkv<float>(q, k, v, dout, lse, dvec, dk, dv, bh,
                                    seq, dim, scale, causal, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// (two products), the dQ kernel 6 (QK^T and dO V^T recomputed, dS K), the
// dK/dV kernel 8 (QK^T and dO V^T recomputed, P^T dO, dS^T Q); the
// backward as a whole needs at least 10 (five products); all about halved
// when causal.  Products run at 164.9 TFLOP/s in float32 (3xTF32: three
// TF32 products at 494.7 / 3) and 989 TFLOP/s in bf16; bytes (each input
// read once, each output written once) at 3.35 TB/s.
//   (BH, T, D) = (16, 128, 128), the main path's, float32: forward 134
//   MFLOP -> 0.81 us, 4.2 MB -> 1.25 us: bytes; bf16 0.14 / 0.63 us.
//   (8, 2048, 128) float32: forward 17.2 GFLOP -> 0.104 ms, dQ 0.156, dK/dV
//   0.208, 33.6 MB -> 0.010 ms: operations; bf16 0.017 / 0.026 / 0.035 ms.
// At T = 128 every kernel sits under its launch and its first loads; what
// counts there is blocks enough to fill the card.
//
// Design:
// - every product on the tensor cores with mma.sync (hopper_mma.cuh):
//   bf16 m16n8k16; float32 as 3xTF32 on m16n8k8 (each operand split as
//   big = x rounded to TF32 + small = x - big; big.big + big.small +
//   small.big summed in f32), float32's accuracy at 3 TF32 products.  The
//   tensor cores' f32 sums lose up to an ulp of the running sum an mma, so
//   no long chain goes through one accumulator: each 128-wide chunk of a
//   score product and each streamed tile of P V, dS K, P^T dO and dS^T Q
//   takes fresh accumulators (in float32 the large and the small products
//   apart for the scores), added to the running sums on the CUDA cores;
// - P and dS reach their products from the score accumulators' registers
//   (float32: the depth order permuted to (2t, 2t + 1), the B operand read
//   in the same order; bf16: the cast to bf16 is the library's cast);
// - a block is 4 warps.  Where D = 128 and (T / 64) BH fills the SMs, a
//   block takes 64 rows (a warp on each 16; (8, 2048, 128): 256 blocks, 2
//   resident an SM); elsewhere 16 rows, the 4 warps splitting each streamed
//   tile and their partial sums (forward: m, l, O) combined in warp order
//   at the end ((16, 128, 128): 128 blocks of each kernel, where 64-row
//   blocks made 32);
// - streamed tiles (K, V in the forward and dQ; Q, dO in dK/dV) are 32 rows
//   in float32 and 64 in bf16 (16 and 64 in the 64-row backward, for 2
//   blocks an SM), double-buffered and more by cp.async: a ring of slots, 4
//   items in flight in 16-row blocks and 2 in 64-row ones;
// - head dims over 128 in 128-wide chunks.  The forward and dQ compute the
//   scores once for up to 2 output chunks (a grid dimension over pairs of
//   chunks: one at D = 256, two at D = 512, where the scores are computed
//   twice); dK/dV keeps a grid dimension over single output chunks, whose
//   blocks each recompute the scores (its dK and dV accumulators fill the
//   registers at one chunk).  Up to 4 chunks of the block's own rows are
//   staged once; beyond, they stream through the ring with the rest;
// - the backward is two kernels, dQ (which also writes D) and then dK/dV,
//   7 products against the 5 a fused backward does, for no float atomics:
//   each output element is summed in a fixed order, so a second call is
//   bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kD = 128;        // head-dim chunk: a staged tile's width
constexpr int kThreads = 128;  // 4 warps
constexpr int kLdF = kD + 4;   // float32 row stride of a combine buffer

// Streamed tiles pass through a ring of shared-memory slots: item i goes to
// slot i % R, `prefetch` items ahead of the one the warps work on, and
// `reuse` slots behind it stay readable (an operand staged as an earlier
// item).  16-row blocks have little work an item, so they keep more items
// in flight.
__host__ __device__ constexpr int prefetch(int qw, bool multi) {
  return qw == 1 && !multi ? 4 : 2;
}
__host__ __device__ constexpr int slots(int qw, bool multi, int reuse) {
  return prefetch(qw, multi) + 1 + reuse;
}
// head-dim chunks whose rows a block stages once; beyond, they stream
constexpr int kMaxStaged = 4;
// the backward kernels' modes: one head-dim chunk staged, up to
// kMaxStaged chunks staged, or every chunk streamed
enum { kOne = 0, kStaged = 1, kStreamed = 2 };

// ---------------------------------------------------------------------------
// tensor-core operands by input type.  A warp computes 16 x 8 tiles; g =
// lane / 4, t = lane % 4.  Three kinds of operand:
//   load_a   A from a row-major tile (rows = the product's rows)
//   load_bt  B = X^T from a row-major tile X whose rows are the product's
//            columns (Q K^T: X = K)
//   load_b2  B = X from a row-major tile X whose rows are the depth (P V:
//            X = V), two 8-column tiles at once
//   from_acc A from a warp's accumulators (P or dS of a score tile)
// float32 runs each product as 3xTF32 (split_tf32); the depth order of an
// A made from accumulators is permuted to (2t, 2t+1) so that it needs no
// shuffle, and load_b2 reads X's rows in the same order.
// ---------------------------------------------------------------------------

template <typename T>
struct Tc;

template <>
struct Tc<float> {
  static constexpr int kK = 8;       // depth of one mma
  static constexpr int kBK = 32;     // rows of a streamed tile
  static constexpr int kBtN = 1;     // 8-column tiles a load_btn gives
  static constexpr bool kSplit = true;
  static constexpr int kLd = kD + 4; // row stride: 8 rows x 4 columns hit
                                     // 32 banks, rows 2t, 2t+1 too
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };

  static __device__ __forceinline__ void load_a(A& a, const float* x,
                                                int lane) {
    const int g = lane >> 2, t = lane & 3;
    split_tf32(x[g * kLd + t], a.hi[0], a.lo[0]);
    split_tf32(x[(g + 8) * kLd + t], a.hi[1], a.lo[1]);
    split_tf32(x[g * kLd + t + 4], a.hi[2], a.lo[2]);
    split_tf32(x[(g + 8) * kLd + t + 4], a.hi[3], a.lo[3]);
  }
  static __device__ __forceinline__ void load_btn(B* b, const float* x,
                                                  int lane) {
    const int g = lane >> 2, t = lane & 3;
    split_tf32(x[g * kLd + t], b->hi[0], b->lo[0]);
    split_tf32(x[g * kLd + t + 4], b->hi[1], b->lo[1]);
  }
  static __device__ __forceinline__ void load_b2(B b[2], const float* x,
                                                 int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      split_tf32(x[2 * t * kLd + 8 * n + g], b[n].hi[0], b[n].lo[0]);
      split_tf32(x[(2 * t + 1) * kLd + 8 * n + g], b[n].hi[1], b[n].lo[1]);
    }
  }
  // depth step s = the accumulators' 8-column tile s
  static __device__ __forceinline__ void from_acc(A& a, float (*c)[4],
                                                  int s) {
    split_tf32(c[s][0], a.hi[0], a.lo[0]);
    split_tf32(c[s][2], a.hi[1], a.lo[1]);
    split_tf32(c[s][1], a.hi[2], a.lo[2]);
    split_tf32(c[s][3], a.hi[3], a.lo[3]);
  }
  // the two small products first, the large one last
  static __device__ __forceinline__ void mma(float c[4], const A& a,
                                             const B& b) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
  // the same into two accumulators, so that the long chain of the large
  // products loses no bits to the small ones
  static __device__ __forceinline__ void mma2(float big[4], float small[4],
                                              const A& a, const B& b) {
    mma_tf32(small, a.lo, b.hi);
    mma_tf32(small, a.hi, b.lo);
    mma_tf32(big, a.hi, b.hi);
  }
  static __device__ __forceinline__ void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

template <>
struct Tc<bf16> {
  static constexpr int kK = 16;
  static constexpr int kBK = 64;
  static constexpr int kBtN = 2;
  static constexpr bool kSplit = false;
  static constexpr int kLd = tc_row(kD);  // 136: an odd count of 16 bytes
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };

  // matrix j of ldmatrix: rows 8 (j & 1), columns 8 (j >> 1)
  static __device__ __forceinline__ void load_a(A& a, const bf16* x,
                                                int lane) {
    const int j = lane >> 3, i = lane & 7;
    ldsm_x4(a.r, x + (8 * (j & 1) + i) * kLd + 8 * (j >> 1));
  }
  // two 8-column tiles: matrix j is rows 8 (j >> 1), columns 8 (j & 1)
  static __device__ __forceinline__ void load_btn(B* b, const bf16* x,
                                                  int lane) {
    const int j = lane >> 3, i = lane & 7;
    uint32_t r[4];
    ldsm_x4(r, x + (8 * (j >> 1) + i) * kLd + 8 * (j & 1));
    b[0].r[0] = r[0];
    b[0].r[1] = r[1];
    b[1].r[0] = r[2];
    b[1].r[1] = r[3];
  }
  static __device__ __forceinline__ void load_b2(B b[2], const bf16* x,
                                                 int lane) {
    const int j = lane >> 3, i = lane & 7;
    uint32_t r[4];
    ldsm_x4_trans(r, x + (8 * (j & 1) + i) * kLd + 8 * (j >> 1));
    b[0].r[0] = r[0];
    b[0].r[1] = r[1];
    b[1].r[0] = r[2];
    b[1].r[1] = r[3];
  }
  static __device__ __forceinline__ uint32_t pack(float x, float y) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  // depth step s = the accumulators' tiles 2s and 2s + 1; the cast to
  // bf16 is the library's cast of P (and dS) before their products
  static __device__ __forceinline__ void from_acc(A& a, float (*c)[4],
                                                  int s) {
    a.r[0] = pack(c[2 * s][0], c[2 * s][1]);
    a.r[1] = pack(c[2 * s][2], c[2 * s][3]);
    a.r[2] = pack(c[2 * s + 1][0], c[2 * s + 1][1]);
    a.r[3] = pack(c[2 * s + 1][2], c[2 * s + 1][3]);
  }
  static __device__ __forceinline__ void mma(float c[4], const A& a,
                                             const B& b) {
    mma_bf16(c, a.r, b.r);
  }
  static __device__ __forceinline__ void mma2(float big[4], float*,
                                              const A& a, const B& b) {
    mma_bf16(big, a.r, b.r);
  }
  static __device__ __forceinline__ void store2(bf16* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
  static __device__ __forceinline__ float load(const bf16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(bf16* p, float x) {
    *p = __float2bfloat16(x);
  }
};

// rows of a streamed tile in the backward: 64-row float32 blocks take 16,
// so that two blocks fit an SM's shared memory
template <typename T>
__host__ __device__ constexpr int bwd_tile(int qw) {
  return sizeof(T) == 4 && qw == 4 ? 16 : Tc<T>::kBK;
}

// `rows` rows of a 128-wide chunk of global memory (rows `ld` elements
// apart) into shared memory (row stride Tc<T>::kLd), by 16-byte cp.async
// copies; the caller commits the group
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long ld,
                                      int rows) {
  constexpr int per_row = kD * sizeof(T) / 16;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
    const int r = idx / per_row, c = idx % per_row;
    cp_async16(dst + r * Tc<T>::kLd + c * (16 / sizeof(T)),
               src + r * ld + c * (16 / sizeof(T)), true);
  }
}

// max and sum over the 4 lanes of a quad (a row of an accumulator tile);
// every lane ends with the same bits
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// o[16][4] (a warp's 16 x 128 accumulators) += a x b over `steps` depth
// steps, b read by load_b2 from x (its first depth row); each pair of
// 8-column tiles takes fresh accumulators, added to o on the CUDA cores
template <typename T, int STEPS>
__device__ __forceinline__ void product_add(float (*o)[4],
                                            const typename Tc<T>::A* a,
                                            const T* x, int lane) {
  using M = Tc<T>;
#pragma unroll
  for (int pr = 0; pr < 8; ++pr) {
    float f[2][4] = {};
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      typename M::B b[2];
      M::load_b2(b, x + s * M::kK * M::kLd + 16 * pr, lane);
      M::mma(f[0], a[s], b[0]);
      M::mma(f[1], a[s], b[1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[2 * pr][e] += f[0][e];
      o[2 * pr + 1][e] += f[1][e];
    }
  }
}

// acc[NT][4] += a x b^T over one 128-wide chunk: a from the row-major tile
// xa (the warp's 16 rows), b from the row-major tile xb (NT x 8 rows).
// In float32 the chunk's products take fresh accumulators (the large and
// the small TF32 products apart), added to acc on the CUDA cores.  With
// few 8-column tiles (16-row blocks) the k-steps go round-robin to KP
// accumulator sets, so that KP x NT chains of dependent mma run at once
// (and each is shorter).  bf16 with one set sums into acc directly.
template <typename T, int NT, int KP>
__device__ __forceinline__ void scores_add(float (*acc)[4], const T* xa,
                                           const T* xb, int lane) {
  using M = Tc<T>;
  if (!M::kSplit && KP == 1) {
#pragma unroll 2
    for (int kk = 0; kk < kD; kk += M::kK) {
      typename M::A a;
      M::load_a(a, xa + kk, lane);
#pragma unroll
      for (int j = 0; j < NT; j += M::kBtN) {
        typename M::B b[M::kBtN];
        M::load_btn(b, xb + 8 * j * M::kLd + kk, lane);
#pragma unroll
        for (int n = 0; n < M::kBtN; ++n) M::mma(acc[j + n], a, b[n]);
      }
    }
    return;
  }
  constexpr int NS = M::kSplit ? NT : 1;
  float big[KP][NT][4] = {}, small[KP][NS][4] = {};
#pragma unroll 2
  for (int k0 = 0; k0 < kD; k0 += KP * M::kK) {
#pragma unroll
    for (int u = 0; u < KP; ++u) {
      const int kk = k0 + u * M::kK;
      typename M::A a;
      M::load_a(a, xa + kk, lane);
#pragma unroll
      for (int j = 0; j < NT; j += M::kBtN) {
        typename M::B b[M::kBtN];
        M::load_btn(b, xb + 8 * j * M::kLd + kk, lane);
#pragma unroll
        for (int n = 0; n < M::kBtN; ++n)
          M::mma2(big[u][j + n], small[u][M::kSplit ? j + n : 0], a, b[n]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float vb = big[0][j][e], vs = M::kSplit ? small[0][j][e] : 0.f;
#pragma unroll
      for (int u = 1; u < KP; ++u) {
        vb += big[u][j][e];
        if (M::kSplit) vs += small[u][j][e];
      }
      acc[j][e] += M::kSplit ? vb + vs : vb;
    }
}

// a warp's 16 x 128 accumulators into a float32 buffer (row stride kLdF)
__device__ __forceinline__ void acc_to_smem(float* buf, float (*o)[4],
                                            int g, int t) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    buf[g * kLdF + 8 * n + 2 * t] = o[n][0];
    buf[g * kLdF + 8 * n + 2 * t + 1] = o[n][1];
    buf[(g + 8) * kLdF + 8 * n + 2 * t] = o[n][2];
    buf[(g + 8) * kLdF + 8 * n + 2 * t + 1] = o[n][3];
  }
}

// a warp's 16 x 128 accumulators (times `mul` by row) to global memory,
// rows `ld` apart
template <typename T>
__device__ __forceinline__ void acc_store(T* dst, long long ld,
                                          float (*o)[4], float mul0,
                                          float mul1, int g, int t) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    Tc<T>::store2(dst + g * ld + 8 * n + 2 * t, o[n][0] * mul0,
                  o[n][1] * mul0);
    Tc<T>::store2(dst + (g + 8) * ld + 8 * n + 2 * t, o[n][2] * mul1,
                  o[n][3] * mul1);
  }
}

// the sum, in warp order, of the 4 warps' 16 x 128 float32 buffers (each
// 16 x kLdF), to global memory (rows `ld` apart); all 128 threads
template <typename T>
__device__ __forceinline__ void sum4_store(T* dst, long long ld,
                                           const float* buf) {
  for (int idx = threadIdx.x; idx < 16 * kD; idx += kThreads) {
    const int r = idx / kD, c = idx % kD;
    float v = buf[r * kLdF + c];
#pragma unroll
    for (int w = 1; w < 4; ++w) v += buf[(w * 16 + r) * kLdF + c];
    Tc<T>::store(dst + r * ld + c, v);
  }
}

// ---------------------------------------------------------------------------
// forward: one block per (16 QW query rows, bh, group of NCH output chunks)
// ---------------------------------------------------------------------------
//
// QW warps own 16 query rows each; the other 4 / QW warps split each
// streamed key tile (KW parts of KWID keys) for the same rows, and their
// (m, l, O) are combined at the end in warp order.  MODE kOne (D = 128):
// Q staged once, items K, V per key tile.  At D > 128 the block computes
// the scores once for up to NCH = 2 output chunks.  MODE kStaged: Q
// staged once (every chunk), items K_c for each chunk c, then V of the
// block's output chunks.  kStreamed (more than kMaxStaged chunks): items
// Q_c, K_c for each chunk c, then V (Q_c is read while K_c is the current
// item: one slot of reuse).

template <typename T, int QW, int MODE>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int seq, int dim, float scale,
                 int causal) {
  using M = Tc<T>;
  constexpr bool STREAM = MODE == kStreamed;
  constexpr int NCH = MODE == kOne ? 1 : 2;  // output chunks a block
  constexpr int KW = 4 / QW, BQ = 16 * QW, BK = M::kBK, KWID = BK / KW;
  constexpr int NT = KWID / 8, KS = KWID / M::kK, LD = M::kLd;
  constexpr int KP = QW == 1 ? 4 / NT : 1;  // score accumulator sets
  constexpr int PF = prefetch(QW, false);
  constexpr int R = slots(QW, false, STREAM ? 1 : 0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);        // nc x (BQ, LD) staged
  const int nc = dim / kD;
  T* ring = qs + (STREAM ? 0 : nc * BQ * LD);    // R x (BK, LD)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw = warp % QW, kw = warp / QW;
  const int q0 = blockIdx.x * BQ;
  const long long bh = blockIdx.y;
  const int c0 = blockIdx.z * NCH;
  const int ngc = min(NCH, nc - c0);
  const long long base = bh * seq * dim;
  const T* qblk = q + base + (long long)q0 * dim;

  if (!STREAM)
    for (int c = 0; c < nc; ++c)
      stage<T>(qs + c * BQ * LD, qblk + c * kD, dim, BQ);
  const int n_kt = causal ? (q0 + BQ + BK - 1) / BK : seq / BK;
  const int n_score = STREAM ? 2 * nc : nc;  // items that make scores
  const int per = n_score + ngc;
  const int total = n_kt * per;
  // item i of the stream into slot i % R
  auto fetch = [&](int i) {
    const int kt = i / per, p = i % per;
    const long long krow = base + (long long)kt * BK * dim;
    T* dst = ring + (i % R) * BK * LD;
    if (p >= n_score)
      stage<T>(dst, v + krow + (c0 + p - n_score) * kD, dim, BK);
    else if (!STREAM)
      stage<T>(dst, k + krow + p * kD, dim, BK);
    else if (p & 1)
      stage<T>(dst, k + krow + (p >> 1) * kD, dim, BK);
    else
      stage<T>(dst, qblk + (p >> 1) * kD, dim, BQ);
  };
  for (int i = 0; i < PF; ++i) {
    if (i < total) fetch(i);
    cp_async_commit();
  }

  float acc[NCH][16][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[NT][4];
  typename M::A ap[KS];
  const int row0 = q0 + qw * 16 + g;  // and row0 + 8

  for (int i = 0; i < total; ++i) {
    cp_async_wait<PF - 1>();
    __syncthreads();  // item i landed; every warp is done with item i - 1
    if (i + PF < total) fetch(i + PF);
    cp_async_commit();
    const T* slot = ring + (i % R) * BK * LD;
    const int kt = i / per, p = i % per;
    const int k0 = kt * BK + kw * KWID;  // the warp's first key
    bool score_item, last_score;
    const T* xa;
    if (!STREAM) {
      score_item = p < nc;
      last_score = p == nc - 1;
      xa = qs + (p * BQ + qw * 16) * LD;
    } else {
      score_item = p < 2 * nc && (p & 1);
      last_score = p == 2 * nc - 1;
      xa = ring + ((i + R - 1) % R) * BK * LD + qw * 16 * LD;
    }
    if (score_item) {
      if (p == (STREAM ? 1 : 0)) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      }
      scores_add<T, NT, KP>(s, xa, slot + kw * KWID * LD, lane);
      if (last_score) {  // online softmax over the warp's keys
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x = s[j][2 * r + e] * scale;
              if (causal && k0 + 8 * j + 2 * t + e > row) x = -INFINITY;
              s[j][2 * r + e] = x;
              mx = fmaxf(mx, x);
            }
          const float m_new = fmaxf(m[r], quad_max(mx));
          // a row with every key so far masked keeps m = -inf, l = 0
          const float m_use = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = expf(m[r] - m_use);
          float psum = 0.f;
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pv = expf(s[j][2 * r + e] - m_use);
              psum += pv;
              s[j][2 * r + e] = pv;
            }
          l[r] = alpha * l[r] + quad_sum(psum);
          m[r] = m_new;
#pragma unroll
          for (int c = 0; c < NCH; ++c)
#pragma unroll
            for (int n = 0; n < 16; ++n) {
              acc[c][n][2 * r] *= alpha;
              acc[c][n][2 * r + 1] *= alpha;
            }
        }
#pragma unroll
        for (int st = 0; st < KS; ++st) M::from_acc(ap[st], s, st);
      }
    } else if (p >= n_score) {  // V of output chunk c0 + c
      const int c = p - n_score;
      const T* vb = slot + kw * KWID * LD;
#pragma unroll
      for (int cc = 0; cc < NCH; ++cc)
        if (cc == c) product_add<T, KS>(acc[cc], ap, vb, lane);
    }
  }

  T* oblk = o + base + (long long)(q0 + qw * 16) * dim + c0 * kD;
  if (KW == 1) {
    const float inv0 = 1.0f / l[0], inv1 = 1.0f / l[1];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      if (c < ngc) acc_store<T>(oblk + c * kD, dim, acc[c], inv0, inv1, g, t);
    if (t == 0 && blockIdx.z == 0) {
      lse[bh * seq + row0] = m[0] + logf(l[0]);
      lse[bh * seq + row0 + 8] = m[1] + logf(l[1]);
    }
    return;
  }
  // KW = 4 warps hold partial (m, l, O) of the same 16 rows
  __syncthreads();  // every warp is done with the ring
  float* buf = reinterpret_cast<float*>(smem_raw);   // 4 x (16, kLdF)
  float* ml = buf + 4 * 16 * kLdF;                   // (4, 16, 2)
  float* wt = ml + 4 * 16 * 2;                       // (16, 4) weights
  float* rl = wt + 16 * 4;                           // (16) 1 / l
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ml[(warp * 16 + g + 8 * r) * 2] = m[r];
      ml[(warp * 16 + g + 8 * r) * 2 + 1] = l[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < 16) {
    const int r = threadIdx.x;
    float mx = -INFINITY;
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, ml[(w * 16 + r) * 2]);
    float lsum = 0.f;
    for (int w = 0; w < 4; ++w) {
      const float mw = ml[(w * 16 + r) * 2];
      const float a = mw == -INFINITY ? 0.f : expf(mw - mx);
      wt[r * 4 + w] = a;
      lsum += a * ml[(w * 16 + r) * 2 + 1];
    }
    rl[r] = 1.0f / lsum;
    if (blockIdx.z == 0) lse[bh * seq + q0 + r] = mx + logf(lsum);
  }
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (c >= ngc) break;
    acc_to_smem(buf + warp * 16 * kLdF, acc[c], g, t);
    __syncthreads();
    for (int idx = threadIdx.x; idx < 16 * kD; idx += kThreads) {
      const int r = idx / kD, col = idx % kD;
      float val = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w)
        val += buf[(w * 16 + r) * kLdF + col] * wt[r * 4 + w];
      M::store(o + base + (long long)(q0 + r) * dim + (c0 + c) * kD + col,
               val * rl[r]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// backward, dQ (and D): one block per (16 QW query rows, bh, group of
// output chunks)
// ---------------------------------------------------------------------------
//
// Warps as the forward's; at D > 128 a block computes dS once for up to 2
// output chunks.  MODE kOne (D = 128) and kStaged (up to kMaxStaged
// chunks): Q and dO staged once, items K_c, V_c for each chunk c and, if
// D > 128, K of the block's output chunks; at D = 128 dS K reads K from
// the slot before V's (one slot of reuse).  kStreamed: items Q_c, dO_c,
// K_c, V_c for each chunk c, then K of the output chunks (two slots of
// reuse: Q_c and dO_c are read while K_c and V_c are the current items).

template <typename T, int QW, int MODE>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ dvec, T* __restrict__ dq, int seq,
                    int dim, float scale, int causal) {
  using M = Tc<T>;
  constexpr bool STREAM = MODE == kStreamed;
  constexpr int KW = 4 / QW, BQ = 16 * QW, BK = bwd_tile<T>(QW);
  constexpr int KWID = BK / KW;
  constexpr int NT = KWID / 8, KS = KWID / M::kK, LD = M::kLd;
  constexpr int KP = QW == 1 ? 4 / NT : 1;  // score accumulator sets
  constexpr int NCH = MODE == kOne ? 1 : 2;  // output chunks a block
  constexpr int PF = prefetch(QW, MODE != kOne);
  constexpr int R = slots(QW, MODE != kOne, STREAM ? 2 : 1);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = dim / kD, c0 = blockIdx.z * NCH;
  const int ngc = min(NCH, nc - c0);
  T* qs = reinterpret_cast<T*>(smem_raw);            // nc x (BQ, LD) staged
  T* dos = qs + (STREAM ? 0 : nc * BQ * LD);         // nc x (BQ, LD) staged
  T* ring = dos + (STREAM ? 0 : nc * BQ * LD);       // R x (BK, LD)
  float* dsh = reinterpret_cast<float*>(ring + R * BK * LD);  // (BQ) D
  float* lsh = dsh + BQ;                                       // (BQ) lse
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw = warp % QW, kw = warp / QW;
  const int q0 = blockIdx.x * BQ;
  const long long bh = blockIdx.y;
  const long long base = bh * seq * dim;
  const T* qblk = q + base + (long long)q0 * dim;
  const T* dblk = dout + base + (long long)q0 * dim;

  if (!STREAM)
    for (int c = 0; c < nc; ++c) {
      stage<T>(qs + c * BQ * LD, qblk + c * kD, dim, BQ);
      stage<T>(dos + c * BQ * LD, dblk + c * kD, dim, BQ);
    }
  const int n_kt = causal ? (q0 + BQ + BK - 1) / BK : seq / BK;
  const int n_score = STREAM ? 4 * nc : 2 * nc;  // items that make dS
  const int per = n_score + (nc > 1 ? ngc : 0);
  const int total = n_kt * per;
  auto fetch = [&](int i) {
    const int kt = i / per, p = i % per;
    const long long krow = base + (long long)kt * BK * dim;
    T* dst = ring + (i % R) * BK * LD;
    if (p >= n_score) {
      stage<T>(dst, k + krow + (c0 + p - n_score) * kD, dim, BK);
      return;
    }
    if (!STREAM) {
      stage<T>(dst, (p & 1 ? v : k) + krow + (p >> 1) * kD, dim, BK);
      return;
    }
    const int c = p >> 2;
    switch (p & 3) {
      case 0: stage<T>(dst, qblk + c * kD, dim, BQ); break;
      case 1: stage<T>(dst, dblk + c * kD, dim, BQ); break;
      case 2: stage<T>(dst, k + krow + c * kD, dim, BK); break;
      default: stage<T>(dst, v + krow + c * kD, dim, BK); break;
    }
  };
  for (int i = 0; i < PF; ++i) {
    if (i < total) fetch(i);
    cp_async_commit();
  }

  // D = rowsum(dO o) and lse of the block's rows: warp w takes rows w,
  // w + 4, ...; lanes stride the head dim, then a butterfly sum
  for (int r = warp; r < BQ; r += 4) {
    const long long off = base + (long long)(q0 + r) * dim;
    float part = 0.f;
    for (int d = lane; d < dim; d += 32)
      part = fmaf(M::load(o + off + d), M::load(dout + off + d), part);
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, sh);
    if (lane == 0) {
      dsh[r] = part;
      lsh[r] = lse[bh * seq + q0 + r];
      if (c0 == 0) dvec[bh * seq + q0 + r] = part;
    }
  }

  float acc[NCH][16][4] = {};
  float s[NT][4], dp[NT][4];
  typename M::A ad[KS];
  const int row0 = q0 + qw * 16 + g;
  const int lr0 = qw * 16 + g;  // the block's row index of row0

  for (int i = 0; i < total; ++i) {
    cp_async_wait<PF - 1>();
    __syncthreads();
    if (i + PF < total) fetch(i + PF);
    cp_async_commit();
    const T* slot = ring + (i % R) * BK * LD;
    const int kt = i / per, p = i % per;
    const int k0 = kt * BK + kw * KWID;
    int kind;           // 0: none, 1: K (scores), 2: V (dP), 3: dS K
    const T* xa = qs;   // the warp's 16 rows of Q (kind 1) or dO (kind 2)
    if (p >= n_score) {
      kind = 3;
    } else if (!STREAM) {
      kind = (p & 1) + 1;
      xa = (p & 1 ? dos : qs) + ((p >> 1) * BQ + qw * 16) * LD;
    } else {
      kind = (p & 3) == 2 ? 1 : (p & 3) == 3 ? 2 : 0;
      xa = ring + ((i + R - 2) % R) * BK * LD + qw * 16 * LD;
    }
    if (kind == 1) {
      if (p == (STREAM ? 2 : 0)) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
      scores_add<T, NT, KP>(s, xa, slot + kw * KWID * LD, lane);
    } else if (kind == 2) {
      scores_add<T, NT, KP>(dp, xa, slot + kw * KWID * LD, lane);
      if (p == n_score - 1) {  // dS = P (dP - D) c
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          const float di = dsh[lr0 + 8 * r], li = lsh[lr0 + 8 * r];
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool masked = causal && k0 + 8 * j + 2 * t + e > row;
              const float pv =
                  masked ? 0.f : expf(s[j][2 * r + e] * scale - li);
              s[j][2 * r + e] = (dp[j][2 * r + e] - di) * pv * scale;
            }
        }
#pragma unroll
        for (int st = 0; st < KS; ++st) M::from_acc(ad[st], s, st);
        if (nc == 1)  // K is the item before V
          product_add<T, KS>(acc[0], ad,
                             ring + ((i + R - 1) % R) * BK * LD + kw * KWID * LD,
                             lane);
      }
    } else if (kind == 3) {  // K of output chunk c0 + c
      const int c = p - n_score;
#pragma unroll
      for (int cc = 0; cc < NCH; ++cc)
        if (cc == c)
          product_add<T, KS>(acc[cc], ad, slot + kw * KWID * LD, lane);
    }
  }

  T* dst = dq + base + (long long)(q0 + qw * 16) * dim + c0 * kD;
  if (KW == 1) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      if (c < ngc) acc_store<T>(dst + c * kD, dim, acc[c], 1.f, 1.f, g, t);
    return;
  }
  float* buf = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (c >= ngc) break;
    __syncthreads();  // every warp is done with the ring (or the last sum)
    acc_to_smem(buf + warp * 16 * kLdF, acc[c], g, t);
    __syncthreads();
    sum4_store<T>(dst + c * kD, dim, buf);
  }
}

// ---------------------------------------------------------------------------
// backward, dK and dV: one block per (16 QW key rows, bh, output chunk),
// after the dQ kernel
// ---------------------------------------------------------------------------
//
// QW warps own 16 key rows each; the other 4 / QW warps split each streamed
// query tile.  The scores are computed transposed (keys x queries), so P^T
// and dS^T are the A operands of dV += P^T dO and dK += dS^T Q.  MODE kOne
// and kStaged: K and V staged once, items Q_c, dO_c for each chunk c and,
// if D > 128, Q and dO of the output chunk (one slot of reuse: Q is read
// while dO is the current item).  kStreamed: items K_c, V_c, Q_c, dO_c for
// each chunk c, then Q and dO of the output chunk (two slots of reuse).

template <typename T, int QW, int MODE>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec, T* __restrict__ dk,
                     T* __restrict__ dv, int seq, int dim, float scale,
                     int causal) {
  using M = Tc<T>;
  constexpr bool STREAM = MODE == kStreamed;
  constexpr int KW = 4 / QW, BKR = 16 * QW, BQT = bwd_tile<T>(QW);
  constexpr int QWID = BQT / KW;
  constexpr int NT = QWID / 8, KS = QWID / M::kK, LD = M::kLd;
  constexpr int KP = QW == 1 ? 4 / NT : 1;  // score accumulator sets
  constexpr int PF = prefetch(QW, MODE != kOne);
  constexpr int R = slots(QW, MODE != kOne, STREAM ? 2 : 1);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = dim / kD, oc = blockIdx.z;
  T* ks = reinterpret_cast<T*>(smem_raw);            // nc x (BKR, LD) staged
  T* vs = ks + (STREAM ? 0 : nc * BKR * LD);
  T* ring = vs + (STREAM ? 0 : nc * BKR * LD);       // R x (BQT, LD)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw = warp % QW, kw = warp / QW;
  const int k0 = blockIdx.x * BKR;
  const long long bh = blockIdx.y;
  const long long base = bh * seq * dim;
  const T* kblk = k + base + (long long)k0 * dim;
  const T* vblk = v + base + (long long)k0 * dim;

  if (!STREAM)
    for (int c = 0; c < nc; ++c) {
      stage<T>(ks + c * BKR * LD, kblk + c * kD, dim, BKR);
      stage<T>(vs + c * BKR * LD, vblk + c * kD, dim, BKR);
    }
  const int qt0 = causal ? k0 / BQT : 0;
  const int per = STREAM ? 4 * nc + 2 : 2 * nc + 2 * (nc > 1);
  const int total = (seq / BQT - qt0) * per;
  auto fetch = [&](int i) {
    const int qt = qt0 + i / per, p = i % per;
    const long long qrow = base + (long long)qt * BQT * dim;
    T* dst = ring + (i % R) * BQT * LD;
    if (!STREAM) {
      const int c = p < 2 * nc ? p >> 1 : oc;
      stage<T>(dst, (p & 1 ? dout : q) + qrow + c * kD, dim, BQT);
      return;
    }
    const int c = p >> 2;
    switch (p >= 4 * nc ? 4 + (p - 4 * nc) : p & 3) {
      case 0: stage<T>(dst, kblk + c * kD, dim, BKR); break;
      case 1: stage<T>(dst, vblk + c * kD, dim, BKR); break;
      case 2: stage<T>(dst, q + qrow + c * kD, dim, BQT); break;
      case 3: stage<T>(dst, dout + qrow + c * kD, dim, BQT); break;
      case 4: stage<T>(dst, q + qrow + oc * kD, dim, BQT); break;
      default: stage<T>(dst, dout + qrow + oc * kD, dim, BQT); break;
    }
  };
  for (int i = 0; i < PF; ++i) {
    if (i < total) fetch(i);
    cp_async_commit();
  }

  float ak[16][4] = {}, av[16][4] = {};
  float s[NT][4], dp[NT][4];  // rows: keys; columns: queries
  typename M::A ap[KS], as[KS];
  const int key0 = k0 + qw * 16 + g;  // and key0 + 8

  for (int i = 0; i < total; ++i) {
    cp_async_wait<PF - 1>();
    __syncthreads();
    if (i + PF < total) fetch(i + PF);
    cp_async_commit();
    const T* slot = ring + (i % R) * BQT * LD;
    const int qt = qt0 + i / per, p = i % per;
    const int qb = qt * BQT + kw * QWID;  // the warp's first query
    int kind;     // 0: none, 1: Q (scores), 2: dO (dP), 3: dV, dK
    const T* xa;  // the warp's 16 rows of K (kind 1) or V (kind 2)
    if (!STREAM) {
      kind = p == 2 * nc + 1 ? 3 : p >= 2 * nc ? 0 : (p & 1) + 1;
      xa = (p & 1 ? vs : ks) + ((p >> 1) * BKR + qw * 16) * LD;
    } else {
      kind = p == 4 * nc + 1 ? 3
             : p >= 4 * nc   ? 0
             : (p & 3) == 2  ? 1
             : (p & 3) == 3  ? 2
                             : 0;
      xa = ring + ((i + R - 2) % R) * BQT * LD + qw * 16 * LD;
    }
    if (kind == 1) {
      if (p == (STREAM ? 2 : 0)) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
      scores_add<T, NT, KP>(s, xa, slot + kw * QWID * LD, lane);
    } else if (kind == 2) {
      scores_add<T, NT, KP>(dp, xa, slot + kw * QWID * LD, lane);
      if (p == (STREAM ? 4 * nc : 2 * nc) - 1) {  // P^T and dS^T
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = qb + 8 * j + 2 * t + e;
            const float li = lse[bh * seq + qi], di = dvec[bh * seq + qi];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const bool masked = causal && key0 + 8 * r > qi;
              const float pv =
                  masked ? 0.f : expf(s[j][2 * r + e] * scale - li);
              s[j][2 * r + e] = pv;
              dp[j][2 * r + e] = (dp[j][2 * r + e] - di) * pv * scale;
            }
          }
#pragma unroll
        for (int st = 0; st < KS; ++st) {
          M::from_acc(ap[st], s, st);
          M::from_acc(as[st], dp, st);
        }
        if (nc == 1) {  // Q is the item before dO
          const T* qsl = ring + ((i + R - 1) % R) * BQT * LD + kw * QWID * LD;
          product_add<T, KS>(av, ap, slot + kw * QWID * LD, lane);
          product_add<T, KS>(ak, as, qsl, lane);
        }
      }
    } else if (kind == 3) {  // Q_oc is the item before dO_oc
      const T* qsl = ring + ((i + R - 1) % R) * BQT * LD + kw * QWID * LD;
      product_add<T, KS>(av, ap, slot + kw * QWID * LD, lane);
      product_add<T, KS>(ak, as, qsl, lane);
    }
  }

  const long long off = base + (long long)(k0 + qw * 16) * dim + oc * kD;
  if (KW == 1) {
    acc_store<T>(dk + off, dim, ak, 1.f, 1.f, g, t);
    acc_store<T>(dv + off, dim, av, 1.f, 1.f, g, t);
    return;
  }
  __syncthreads();
  float* buf = reinterpret_cast<float*>(smem_raw);
  acc_to_smem(buf + warp * 16 * kLdF, ak, g, t);
  __syncthreads();
  sum4_store<T>(dk + off, dim, buf);
  __syncthreads();
  acc_to_smem(buf + warp * 16 * kLdF, av, g, t);
  __syncthreads();
  sum4_store<T>(dv + off, dim, buf);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// the launch geometry every entry point shares; cudaErrorInvalidValue for
// shapes the kernels do not take
cudaError_t check_shape(int bh, int seq, int dim) {
  if (bh <= 0 || bh > 65535 || dim <= 0 || dim % kD != 0
      || dim / kD > 65535 || seq <= 0 || seq % 64 != 0)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// 64-row blocks (4 warps on 16 rows each) where D = 128 and they fill the
// card by themselves; 16-row blocks (4 warps splitting the keys, or the
// queries in dK/dV) everywhere else, 4x the blocks
cudaError_t wide_rows(int bh, int seq, int dim, bool& wide) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  wide = dim == kD && (long long)(seq / 64) * bh >= sms;
  return err;
}

// dynamic shared memory of each kernel: row tiles staged once (D = 128),
// the ring of streamed tiles, and the warp-combine buffer where 4 warps
// share rows
constexpr size_t kCombine = 4 * 16 * kLdF * sizeof(float);

template <typename T>
size_t fwd_smem(int qw, bool stream, int nc) {
  const size_t tile = Tc<T>::kLd * sizeof(T);
  const int ring = slots(qw, false, stream ? 1 : 0) * Tc<T>::kBK;
  const size_t bytes = (stream ? ring : 16 * qw * nc + ring) * tile;
  const size_t combine = kCombine + (4 * 16 * 2 + 16 * 4 + 16) * sizeof(float);
  return qw == 4 || bytes > combine ? bytes : combine;
}

template <typename T>
size_t bwd_smem(int qw, int mode, int nc, bool dq) {
  const size_t tile = Tc<T>::kLd * sizeof(T);
  const int ring = slots(qw, mode != kOne, mode == kStreamed ? 2 : 1)
                   * bwd_tile<T>(qw);
  const size_t bytes =
      (mode == kStreamed ? ring : 32 * qw * nc + ring) * tile;
  const size_t extra = dq ? 2 * 16 * qw * sizeof(float) : 0;
  return (bytes > kCombine ? bytes : kCombine) + extra;
}

int mode_of(int dim) {
  const int nc = dim / kD;
  return nc == 1 ? kOne : nc <= kMaxStaged ? kStaged : kStreamed;
}

template <typename T, int QW, int MODE>
int forward_as(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int seq, int dim, float scale, int causal,
               cudaStream_t stream) {
  static SmemSet set;
  const int nc = dim / kD;
  const size_t smem = fwd_smem<T>(QW, MODE == kStreamed, nc);
  cudaError_t err = allow_smem(set, flash_fwd_kernel<T, QW, MODE>, smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = MODE == kOne ? 1 : (nc + 1) / 2;
  flash_fwd_kernel<T, QW, MODE>
      <<<dim3(seq / (16 * QW), bh, groups), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o),
          static_cast<float*>(lse), seq, dim, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int forward(const void* q, const void* k, const void* v, void* o, void* lse,
            int bh, int seq, int dim, float scale, int causal,
            cudaStream_t stream) {
  bool wide = false;
  cudaError_t err = wide_rows(bh, seq, dim, wide);
  if (err != cudaSuccess) return (int)err;
  switch (wide ? -1 : mode_of(dim)) {
    case -1:
      return forward_as<T, 4, kOne>(q, k, v, o, lse, bh, seq, dim, scale,
                                    causal, stream);
    case kOne:
      return forward_as<T, 1, kOne>(q, k, v, o, lse, bh, seq, dim, scale,
                                    causal, stream);
    case kStaged:
      return forward_as<T, 1, kStaged>(q, k, v, o, lse, bh, seq, dim, scale,
                                       causal, stream);
    default:
      return forward_as<T, 1, kStreamed>(q, k, v, o, lse, bh, seq, dim,
                                         scale, causal, stream);
  }
}

template <typename T, int QW, int MODE>
int backward_dq_as(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* dvec, void* dq, int bh, int seq, int dim,
                   float scale, int causal, cudaStream_t stream) {
  static SmemSet set;
  const size_t smem = bwd_smem<T>(QW, MODE, dim / kD, true);
  cudaError_t err = allow_smem(set, flash_bwd_dq_kernel<T, QW, MODE>, smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = MODE == kOne ? 1 : (dim / kD + 1) / 2;
  flash_bwd_dq_kernel<T, QW, MODE>
      <<<dim3(seq / (16 * QW), bh, groups), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(o),
          static_cast<const T*>(dout), static_cast<const float*>(lse),
          static_cast<float*>(dvec), static_cast<T*>(dq), seq, dim, scale,
          causal);
  return (int)cudaGetLastError();
}

template <typename T>
int backward_dq(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* dvec, void* dq,
                int bh, int seq, int dim, float scale, int causal,
                cudaStream_t stream) {
  bool wide = false;
  cudaError_t err = wide_rows(bh, seq, dim, wide);
  if (err != cudaSuccess) return (int)err;
  switch (wide ? -1 : mode_of(dim)) {
    case -1:
      return backward_dq_as<T, 4, kOne>(q, k, v, o, dout, lse, dvec, dq, bh,
                                        seq, dim, scale, causal, stream);
    case kOne:
      return backward_dq_as<T, 1, kOne>(q, k, v, o, dout, lse, dvec, dq, bh,
                                        seq, dim, scale, causal, stream);
    case kStaged:
      return backward_dq_as<T, 1, kStaged>(q, k, v, o, dout, lse, dvec, dq,
                                           bh, seq, dim, scale, causal,
                                           stream);
    default:
      return backward_dq_as<T, 1, kStreamed>(q, k, v, o, dout, lse, dvec, dq,
                                             bh, seq, dim, scale, causal,
                                             stream);
  }
}

template <typename T, int QW, int MODE>
int backward_dkv_as(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* dvec,
                    void* dk, void* dv, int bh, int seq, int dim, float scale,
                    int causal, cudaStream_t stream) {
  static SmemSet set;
  const size_t smem = bwd_smem<T>(QW, MODE, dim / kD, false);
  cudaError_t err = allow_smem(set, flash_bwd_dkv_kernel<T, QW, MODE>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<T, QW, MODE>
      <<<dim3(seq / (16 * QW), bh, dim / kD), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(dvec),
          static_cast<T*>(dk), static_cast<T*>(dv), seq, dim, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int backward_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* dvec,
                 void* dk, void* dv, int bh, int seq, int dim, float scale,
                 int causal, cudaStream_t stream) {
  bool wide = false;
  cudaError_t err = wide_rows(bh, seq, dim, wide);
  if (err != cudaSuccess) return (int)err;
  switch (wide ? -1 : mode_of(dim)) {
    case -1:
      return backward_dkv_as<T, 4, kOne>(q, k, v, dout, lse, dvec, dk, dv, bh,
                                         seq, dim, scale, causal, stream);
    case kOne:
      return backward_dkv_as<T, 1, kOne>(q, k, v, dout, lse, dvec, dk, dv, bh,
                                         seq, dim, scale, causal, stream);
    case kStaged:
      return backward_dkv_as<T, 1, kStaged>(q, k, v, dout, lse, dvec, dk, dv,
                                            bh, seq, dim, scale, causal,
                                            stream);
    default:
      return backward_dkv_as<T, 1, kStreamed>(q, k, v, dout, lse, dvec, dk,
                                              dv, bh, seq, dim, scale, causal,
                                              stream);
  }
}

}  // namespace

// q, k, v, o (BH, T, D) contiguous on the device, float32 (bf16 = 0) or
// bfloat16 (bf16 = 1); lse (BH, T) float32.  Each entry point launches one
// kernel on `stream` and returns cudaGetLastError() (0 on success), or the
// error of cudaGetDevice, cudaDeviceGetAttribute or cudaFuncSetAttribute;
// shapes the kernels do not take (D not a positive multiple of 128, T not a
// positive multiple of 64, BH outside 1..65535) return
// cudaErrorInvalidValue without launching.
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

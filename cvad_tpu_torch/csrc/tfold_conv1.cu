// T-folded conv1 of family D (K1), written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cvad_tpu/ops/pallas_conv.py::_make_fwd
// (kernel body :162-176, pl.pallas_call at :178), reached through
// tfold_conv1_matmul (:220).  That kernel folds T into channels and runs, per
// batch block, a stride-2 im2col gather of the padded input
// (B, H+2, W+2, (T+2)*C) and ONE matmul against the block-banded weights
// (3, 3, (T+2)*C, T*O) with f32 accumulation.  Its result is the first
// Conv3d of the clip encoder without its bias: C=3 -> O=16, kernel 3,
// stride (1, 2, 2), padding 1.
//
// These kernels compute the same function directly, in torch's layout:
//   x (B, C, T, H, W) and weight (O, C, 3, 3, 3), both contiguous, in
//   float32 or bfloat16  ->  y (B, O, T, Ho, Wo), Ho = (H-1)/2+1, in the
//   input's dtype, with float32 accumulation.
// The banded zeros of the fold exist only to fill the TPU's 128x128 tiles
// (10/3 of the MACs); here nothing is folded and every output takes
// exactly its 81 MACs.
//
// Bound at the main path's bulk shape (B=256, T=8, 64x64; H100 SXM peaks):
//   float32: max(5.44 GFLOP / 67 TFLOP/s = 81 us,
//                234.9 MB / 3.35 TB/s = 70 us)  -> 81 us, operations;
//   bfloat16: 117.4 MB / 3.35 TB/s = 35 us (the bf16 tensor-core rate
//             makes the operations 5.5 us)    -> 35 us, bytes.
//
// Design: the work is cut into units of one clip, 8 output frames (one
// warp each), R output rows (R = 4, or 1 where fewer units would leave
// SMs idle: the wrapper's pallas_conv.k1_rows) and 32 output columns.
// The kernels are persistent: as many blocks of 8 warps as the card holds
// at once, each walking units i, i + grid, ...  A unit's input slab, 3
// channels x 10 frames x (2R+1) rows x 66 columns (2 ow0 - 2 .. 2 ow0 +
// 63), goes to shared memory by cp.async (16-byte pieces of each row, 8 or
// 4 threads a 128-byte segment, and one 8- or 4-byte piece for the left
// halo; widths that are no multiple of 16 bytes take 4-byte pieces, and
// bf16 at odd widths plain loads), zero-filled past every edge, so the
// inner loops have no bounds checks
// and each input frame is loaded once for the three output frames that
// read it.  Two slab buffers: the next unit's loads are in flight while
// this one is computed.  Staged column p holds input column 2 ow0 - 2 + p,
// so output column ow' of the unit reads p = 2 ow' + kw + 1.
// - float32, on the CUDA cores (one block an SM at R = 4): lane = output
//   column; each thread holds R positions x 16 channels in registers.
//   Per (c, kt, kh) and row it reads two float2 (p = 2 ow' .. 2 ow' + 3:
//   the kw = 0, 1, 2 taps; consecutive lanes on consecutive 8 bytes), and
//   each weight float4 is a broadcast read of the [tap][o] copy in shared
//   memory: at R = 4 one weight read feeds 16 FMAs and one input read 16.
// - bfloat16, on the tensor cores (two blocks an SM): the conv as an
//   implicit GEMM, M = 16 output columns of one row, N = 16 channels (two
//   n8 tiles), K = the 81 taps padded to 96 (six k-steps of
//   mma.sync.m16n8k16, f32 accumulators).  The K order is chosen so that
//   a lane's A pair (k, k+1) is either the (kw = 1, kw = 2) taps of one
//   (c, kt, kh), which sit side by side in the staged row (one 32-bit
//   load), or two kw = 0 taps (two 16-bit loads).  The slab's row, frame
//   and channel strides are padded so that (c, kt, kh) falls in bank
//   quarter (c + 3 kt + kh) % 4, and lane class t = lane % 4 reads only
//   quarter t's taps: every A load of a warp hits 32 distinct banks
//   (tests/test_torch_port_conv1.py writes the order out and checks both).
//   Each
//   lane's B fragments are set up once a block in registers.  Output tiles go
//   through a per-warp buffer in shared memory, so each row's (16 channels
//   x 32 columns) leaves as 64-byte runs of 16-byte stores.
// No atomics: a second call is bit-identical.  Bias and ReLU stay with the
// caller, as in cvad_tpu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper_mma.cuh"

namespace {

constexpr int kCin = 3;
constexpr int kCout = 16;
constexpr int kTaps = 27 * kCin;   // 81: (c, kt, kh, kw)
constexpr int kCombos = 27;        // (c, kt, kh)
constexpr int kFrames = 8;         // output frames a block owns, one a warp
constexpr int kCols = 32;          // output columns a block owns
constexpr int kThreads = 32 * kFrames;
constexpr int kInFrames = kFrames + 2;
constexpr int kSpan = 2 * kCols + 2;  // staged input columns a row
constexpr int kWsH = 1304;            // bf16 weights [o][tap], 16-byte padded
constexpr int kOst = 40;              // bf16 output buffer row: 80 bytes
constexpr int kWIters = (kCout * kTaps + kThreads - 1) / kThreads;

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}
// the least n' >= n with n' = r (mod 64)
__host__ __device__ constexpr int congruent(int n, int r) {
  return n + ((r - n) % 64 + 64) % 64;
}

// Slab geometry in elements.  float32: rows of 68 (66 used), p = 2 at a
// 16-byte boundary.  bfloat16: rows of 80, frames and channels padded so
// that the word offset of (c, kt, kh) is 8 (c + 3 kt + kh) mod 32.
template <typename T, int R>
struct Slab;
template <int R>
struct Slab<float, R> {
  static constexpr int kRs = 68;
  static constexpr int kFs = (2 * R + 1) * kRs;
  static constexpr int kCs = kInFrames * kFs;
  static constexpr int kBase = 2;
  static constexpr int kElems = round_up(kBase + kCin * kCs, 4);
};
template <int R>
struct Slab<uint16_t, R> {
  static constexpr int kRs = 80;
  static constexpr int kFs = congruent((2 * R + 1) * kRs, 48);
  static constexpr int kCs = congruent(kInFrames * kFs, 16);
  static constexpr int kBase = 6;
  static constexpr int kElems = round_up(kBase + kCin * kCs, 8);
  static_assert(kRs / 2 % 32 == 8 && kFs / 2 % 32 == 24
                    && kCs / 2 % 32 == 8 && kRs % 8 == 0 && kFs % 8 == 0
                    && kCs % 8 == 0,
                "bank quarters (c + 3 kt + kh) % 4 and 16-byte rows");
};

// two slab buffers, the weights and (bf16) the output buffers
template <typename T, int R>
constexpr size_t smem_bytes() {
  return sizeof(float) == sizeof(T)
             ? (2 * Slab<T, R>::kElems + kTaps * kCout) * sizeof(float)
             : (2 * Slab<T, R>::kElems + kWsH + kFrames * kCout * kOst) * 2;
}

// 4 bytes global -> shared, asynchronously; zero where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// Where input row `rid` of the slab (channel, frame, row) lies: its staged
// row (column p = 0) and, if it is inside the clip, its global row.
template <typename T, int R>
__device__ __forceinline__ bool slab_row(int rid, T* slab,
                                         const T* __restrict__ xb,
                                         int frames, int h, int wd, int t0,
                                         int oh0, T*& srow, const T*& grow) {
  using S = Slab<T, R>;
  constexpr int kRowsIn = 2 * R + 1;
  const int c = rid / (kInFrames * kRowsIn);
  const int rem = rid - c * (kInFrames * kRowsIn);
  const int fi = rem / kRowsIn;
  const int ri = rem - fi * kRowsIn;
  const int ti = t0 - 1 + fi, hi = 2 * oh0 - 1 + ri;
  srow = slab + S::kBase + c * S::kCs + fi * S::kFs + ri * S::kRs;
  const bool ok = ti >= 0 && ti < frames && hi >= 0 && hi < h;
  grow = ok ? xb + ((long long)c * frames + ti) * h * wd + (long long)hi * wd
            : xb;
  return ok;
}

// How a slab row is staged: 16-byte pieces (the width a multiple of 16
// bytes), 4-byte pieces (float32 at any width, bf16 at even widths), or
// one element at a time with plain loads (bf16 at odd widths).
enum Pieces { kScalar = 0, kWord = 1, kQuad = 2 };

// Stage the unit's input slab (see the header): T is float or uint16_t
// (bf16 bits).
template <typename T, int R>
__device__ __forceinline__ void stage_slab(T* slab, const T* __restrict__ xb,
                                           int frames, int h, int wd, int t0,
                                           int oh0, int ow0, int pieces) {
  constexpr int kRowsAll = kCin * kInFrames * (2 * R + 1);
  T* srow;
  const T* grow;
  if (pieces != kQuad) {  // column 2 ow0 - 2 + k, one piece at a time
    for (int i = threadIdx.x; i < kRowsAll * kSpan; i += kThreads) {
      const int rid = i / kSpan, k = i - rid * kSpan;
      const bool ok = slab_row<T, R>(rid, slab, xb, frames, h, wd, t0, oh0,
                                     srow, grow);
      const int col = 2 * ow0 - 2 + k;
      const bool in = ok && col >= 0 && col < wd;
      if (pieces == kScalar)
        srow[k] = in ? grow[col] : T(0);
      else if (k % (4 / sizeof(T)) == 0)  // 4-byte pieces lie wholly in or out
        cp_async4(srow + k, in ? grow + col : xb, in);
    }
    return;
  }
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPieces = 2 * kCols / kVec;  // a power of two
  for (int i = threadIdx.x; i < kRowsAll * kPieces; i += kThreads) {
    const int rid = i / kPieces, k = i % kPieces;
    const bool ok = slab_row<T, R>(rid, slab, xb, frames, h, wd, t0, oh0,
                                   srow, grow);
    const int col = 2 * ow0 + k * kVec;  // pieces lie wholly in or out
    const bool in = ok && col < wd;
    cp_async16(srow + 2 + k * kVec, in ? grow + col : xb, in);
  }
  for (int rid = threadIdx.x; rid < kRowsAll; rid += kThreads) {
    // the left halo, columns 2 ow0 - 2 and 2 ow0 - 1
    const bool in = slab_row<T, R>(rid, slab, xb, frames, h, wd, t0, oh0,
                                   srow, grow) && ow0 > 0;
    const T* src = in ? grow + 2 * ow0 - 2 : xb;
    if (sizeof(T) == 4)
      cp_async8(srow, src, in);
    else
      cp_async4(srow, src, in);
  }
}

// A unit of work: 32 output columns x R output rows x 8 output frames of
// one clip.  Units are numbered column band fastest, then row band, frame
// run and clip.
struct Unit {
  int ow0, oh0, t0, b;
};

template <int R>
__device__ __forceinline__ Unit unit_at(int u, int bands, int runs,
                                        int col_bands) {
  const int band = u % bands, rest = u / bands;
  return {band % col_bands * kCols, band / col_bands * R,
          rest % runs * kFrames, rest / runs};
}

// Stage unit u's slab into `slab` (nothing past the last unit) and commit
// one cp.async group either way, so that the waits below count groups
// uniformly.
template <typename T, int R>
__device__ __forceinline__ void stage_unit(T* slab, const T* __restrict__ x,
                                           int u, int units, int bands,
                                           int runs, int col_bands,
                                           int frames, int h, int wd,
                                           int pieces) {
  if (u < units) {
    const Unit n = unit_at<R>(u, bands, runs, col_bands);
    stage_slab<T, R>(slab, x + (long long)n.b * kCin * frames * h * wd,
                     frames, h, wd, n.t0, n.oh0, n.ow0, pieces);
  }
  cp_async_commit();
}

// float32 for one unit: the warp's frame tt, lane = output column, R rows
template <int R>
__device__ __forceinline__ void compute_f32(const float* slab,
                                            const float* ws,
                                            float* __restrict__ y,
                                            const Unit& n, int tt, int lane,
                                            int frames, int ho, int wo) {
  using S = Slab<float, R>;
  float acc[R][kCout];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int o = 0; o < kCout; ++o) acc[r][o] = 0.f;

  const float* s0 = slab + S::kBase + (tt - n.t0) * S::kFs + 2 * lane;
  const float4* ws4 = reinterpret_cast<const float4*>(ws);
#pragma unroll 1
  for (int ck = 0; ck < kCombos / 3; ++ck) {  // (c, kt); kh unrolled
    const float* sck = s0 + ck / 3 * S::kCs + ck % 3 * S::kFs;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      float v[R][3];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* sp = sck + (2 * r + kh) * S::kRs;
        const float2 lo = *reinterpret_cast<const float2*>(sp);
        const float2 hi = *reinterpret_cast<const float2*>(sp + 2);
        v[r][0] = lo.y;
        v[r][1] = hi.x;
        v[r][2] = hi.y;
      }
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const float4* wt = ws4 + ((ck * 3 + kh) * 3 + kw) * (kCout / 4);
#pragma unroll
        for (int q = 0; q < kCout / 4; ++q) {
          const float4 k4 = wt[q];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r][4 * q + 0] = fmaf(v[r][kw], k4.x, acc[r][4 * q + 0]);
            acc[r][4 * q + 1] = fmaf(v[r][kw], k4.y, acc[r][4 * q + 1]);
            acc[r][4 * q + 2] = fmaf(v[r][kw], k4.z, acc[r][4 * q + 2]);
            acc[r][4 * q + 3] = fmaf(v[r][kw], k4.w, acc[r][4 * q + 3]);
          }
        }
      }
    }
  }

  if (n.ow0 + lane >= wo) return;
  const long long oplane = (long long)frames * ho * wo;  // (T, Ho, Wo)
  float* yb = y + (long long)n.b * kCout * oplane + (long long)tt * ho * wo
              + n.ow0 + lane;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (n.oh0 + r >= ho) break;
#pragma unroll
    for (int o = 0; o < kCout; ++o)
      yb[o * oplane + (long long)(n.oh0 + r) * wo] = acc[r][o];
  }
}

// Persistent: block i takes units i, i + gridDim.x, ...; the next unit's
// slab is staged (cp.async) into the other buffer while this one's is
// computed.  One block an SM at R = 4 (two 73 KB slabs).
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
tfold_conv1_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ y,
                       int frames, int h, int wd, int ho, int wo,
                       int col_bands, int bands, int runs, int units,
                       int pieces) {
  using S = Slab<float, R>;
  extern __shared__ float4 smem4[];
  float* slabs = reinterpret_cast<float*>(smem4);  // two buffers
  float* ws = slabs + 2 * S::kElems;               // [tap][o]
  int u = blockIdx.x;
  stage_unit<float, R>(slabs, x, u, units, bands, runs, col_bands, frames,
                       h, wd, pieces);
  {  // every load in flight before the first store
    float wv[kWIters];
#pragma unroll
    for (int k = 0; k < kWIters; ++k) {
      const int i = threadIdx.x + k * kThreads;
      wv[k] = i < kCout * kTaps ? __ldg(w + i) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kWIters; ++k) {
      const int i = threadIdx.x + k * kThreads, o = i / kTaps;
      if (i < kCout * kTaps) ws[(i - o * kTaps) * kCout + o] = wv[k];
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int buf = 0; u < units; u += gridDim.x, buf ^= 1) {
    stage_unit<float, R>(slabs + (buf ^ 1) * S::kElems, x, u + gridDim.x,
                         units, bands, runs, col_bands, frames, h, wd,
                         pieces);
    cp_async_wait<1>();
    __syncthreads();  // this unit's slab (and the weights) are in
    const Unit n = unit_at<R>(u, bands, runs, col_bands);
    const int tt = n.t0 + warp;
    if (tt < frames)
      compute_f32<R>(slabs + buf * S::kElems, ws, y, n, tt, lane, frames, ho,
                     wo);
    __syncthreads();  // read before it is staged again
  }
}

// A lane's share of the implicit GEMM, fixed for the whole launch.  The K
// order: lane class t reads bank quarter t, the combos e = t + 4 i (i =
// 0..6, e < 27; quarter (c + 3 kt + kh) % 4 = e % 4).  Group G < 7 holds
// combo i = G's (kw = 1, kw = 2) pair, groups G = 7..10 the kw = 0 taps of
// combos i = 2 (G - 7) and 2 (G - 7) + 1 (low, high); group G is k-step
// G / 2, pair (k, k+1) = (2t, 2t+1) + 8 (G % 2); G = 11 is empty.  A combo
// past 26 is a zero tap: its weights are 0, its A half is masked, and it
// reads combo t's place, in its own quarter.
struct Lane {
  int off[7];             // slab offsets of combos t + 4 i
  uint32_t bfr[6][2][2];  // [k-step][n tile][b0, b1]
  uint32_t keep_pair, keep_single;
};

template <int R>
__device__ __forceinline__ void lane_setup(Lane& ln, const uint16_t* ws,
                                           int g, int t) {
  using S = Slab<uint16_t, R>;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const int e = t + 4 * i < kCombos ? t + 4 * i : t;
    ln.off[i] = e / 9 * S::kCs + e / 3 % 3 * S::kFs + e % 3 * S::kRs;
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const uint16_t* wn = ws + (g + 8 * nt) * kTaps;
#pragma unroll
    for (int grp = 0; grp < 12; ++grp) {
      uint32_t lo = 0, hi = 0;
      if (grp < 7) {
        const int e = t + 4 * grp;
        if (e < kCombos) {
          lo = wn[3 * e + 1];
          hi = wn[3 * e + 2];
        }
      } else if (grp < 11) {
        const int el = t + 8 * (grp - 7), eh = el + 4;
        if (el < kCombos) lo = wn[3 * el];
        if (eh < kCombos) hi = wn[3 * eh];
      }
      ln.bfr[grp / 2][nt][grp % 2] = lo | (hi << 16);
    }
  }
  ln.keep_pair = t + 24 < kCombos ? 0xffffffffu : 0u;  // group 6, combo 6
  ln.keep_single = t + 24 < kCombos ? 0x0000ffffu : 0u;  // group 10
}

__device__ __forceinline__ uint32_t lds32u(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// bf16 for one unit: the warp's frame tt, R rows of two m16 tiles each
template <int R>
__device__ __forceinline__ void compute_bf16(const uint16_t* slab,
                                             const Lane& ln, uint16_t* ob,
                                             uint16_t* __restrict__ y,
                                             const Unit& n, int tt, int lane,
                                             int frames, int ho, int wo,
                                             int vec_out) {
  using S = Slab<uint16_t, R>;
  const int g = lane >> 2, t = lane & 3;
  // rows g and g + 8 of an m16 tile are output columns 16 hh + g and
  // 16 hh + g + 8, staged at p = 2 ow' + kw + 1
  const uint16_t* sw = slab + S::kBase + (tt - n.t0) * S::kFs + 2 * g;
  for (int r = 0; r < R; ++r) {
    if (n.oh0 + r >= ho) break;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint16_t* sp = sw + 2 * r * S::kRs + 32 * hh;
      uint32_t a[6][4];
#pragma unroll
      for (int grp = 0; grp < 7; ++grp) {  // kw = 1, 2 at p = 2 ow' + 2
        const uint16_t* q = sp + 2 + ln.off[grp];
        a[grp / 2][2 * (grp % 2)] = lds32u(q);
        a[grp / 2][2 * (grp % 2) + 1] = lds32u(q + 16);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {  // kw = 0 at p = 2 ow' + 1
        const int grp = 7 + s;
        const uint16_t* ql = sp + 1 + ln.off[2 * s];
        const uint16_t* qh = sp + 1 + ln.off[2 * s < 6 ? 2 * s + 1 : 0];
        a[grp / 2][2 * (grp % 2)] = (uint32_t)ql[0] | ((uint32_t)qh[0] << 16);
        a[grp / 2][2 * (grp % 2) + 1] =
            (uint32_t)ql[16] | ((uint32_t)qh[16] << 16);
      }
      a[3][0] &= ln.keep_pair;  // group 6
      a[3][1] &= ln.keep_pair;
      a[5][0] &= ln.keep_single;  // group 10
      a[5][1] &= ln.keep_single;
      a[5][2] = a[5][3] = 0u;  // group 11
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < 6; ++ks) mma_bf16(acc, a[ks], ln.bfr[ks][nt]);
        // c0, c1: column g, channels 2t, 2t+1; c2, c3: column g + 8
        const int ch = 8 * nt + 2 * t, col = 16 * hh + g;
        ob[ch * kOst + col] = __bfloat16_as_ushort(__float2bfloat16(acc[0]));
        ob[(ch + 1) * kOst + col] =
            __bfloat16_as_ushort(__float2bfloat16(acc[1]));
        ob[ch * kOst + col + 8] =
            __bfloat16_as_ushort(__float2bfloat16(acc[2]));
        ob[(ch + 1) * kOst + col + 8] =
            __bfloat16_as_ushort(__float2bfloat16(acc[3]));
      }
    }
    // the row's 16 channels x 32 columns leave through the warp's buffer
    __syncwarp();
    const int oh = n.oh0 + r;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int ch = 8 * q + (lane >> 2), ow = n.ow0 + 8 * (lane & 3);
      uint16_t* dst = y + (((long long)n.b * kCout + ch) * frames + tt)
                              * ho * wo + (long long)oh * wo + ow;
      const uint16_t* src = ob + ch * kOst + 8 * (lane & 3);
      if (vec_out && ow + 8 <= wo) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8; ++e)
          if (ow + e < wo) dst[e] = src[e];
      }
    }
    __syncwarp();  // the buffer is read before the next row fills it
  }
}

// Persistent, as the float32 kernel; the lanes' taps and B fragments are
// set up once a block.
template <int R>
__global__ void __launch_bounds__(kThreads, 2)
tfold_conv1_bf16_kernel(const uint16_t* __restrict__ x,
                        const uint16_t* __restrict__ w,
                        uint16_t* __restrict__ y, int frames, int h, int wd,
                        int ho, int wo, int col_bands, int bands, int runs,
                        int units, int pieces, int vec_out) {
  using S = Slab<uint16_t, R>;
  extern __shared__ float4 smem4[];
  uint16_t* slabs = reinterpret_cast<uint16_t*>(smem4);  // two buffers
  uint16_t* ws = slabs + 2 * S::kElems;                   // [o][tap]
  uint16_t* obuf = ws + kWsH;                              // [warp][o][kOst]
  int u = blockIdx.x;
  stage_unit<uint16_t, R>(slabs, x, u, units, bands, runs, col_bands, frames,
                          h, wd, pieces);
  {  // every load in flight before the first store
    uint16_t wv[kWIters];
#pragma unroll
    for (int k = 0; k < kWIters; ++k) {
      const int i = threadIdx.x + k * kThreads;
      wv[k] = i < kCout * kTaps ? w[i] : 0;
    }
#pragma unroll
    for (int k = 0; k < kWIters; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < kCout * kTaps) ws[i] = wv[k];
    }
  }
  __syncthreads();  // the weights are in
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Lane ln;
  lane_setup<R>(ln, ws, lane >> 2, lane & 3);
  uint16_t* ob = obuf + warp * (kCout * kOst);
  for (int buf = 0; u < units; u += gridDim.x, buf ^= 1) {
    stage_unit<uint16_t, R>(slabs + (buf ^ 1) * S::kElems, x, u + gridDim.x,
                            units, bands, runs, col_bands, frames, h, wd,
                            pieces);
    cp_async_wait<1>();
    __syncthreads();  // this unit's slab is in
    const Unit n = unit_at<R>(u, bands, runs, col_bands);
    const int tt = n.t0 + warp;
    if (tt < frames)
      compute_bf16<R>(slabs + buf * S::kElems, ln, ob, y, n, tt, lane,
                      frames, ho, wo, vec_out);
    __syncthreads();  // read before it is staged again
  }
}

// Opt in to the kernel's shared memory and launch as many blocks as the
// card holds at once (no more than there are units).
template <typename Kernel, typename... Args>
cudaError_t launch_persistent(SmemSet& set, Kernel kernel, size_t smem,
                              int units, cudaStream_t s, Args... args) {
  cudaError_t err = allow_smem(set, kernel, smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = resident_blocks(kernel, kThreads, smem, blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks < units ? blocks : units, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch(int dtype, const void* x, const void* w, void* y,
                   int frames, int h, int wd, int ho, int wo, int col_bands,
                   int bands, int runs, int units, cudaStream_t s) {
  static SmemSet set32, set16;  // one a kernel
  const uintptr_t xp = reinterpret_cast<uintptr_t>(x);
  if (dtype == 0) {
    const int pieces = wd % 4 == 0 && xp % 16 == 0 ? kQuad : kWord;
    return launch_persistent(
        set32, tfold_conv1_f32_kernel<R>, smem_bytes<float, R>(), units, s,
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), frames, h, wd, ho, wo, col_bands, bands,
        runs, units, pieces);
  }
  const int pieces = wd % 8 == 0 && xp % 16 == 0
                         ? kQuad
                         : (wd % 2 == 0 && xp % 4 == 0 ? kWord : kScalar);
  const int vec_out = wo % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  return launch_persistent(
      set16, tfold_conv1_bf16_kernel<R>, smem_bytes<uint16_t, R>(), units, s,
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
      static_cast<uint16_t*>(y), frames, h, wd, ho, wo, col_bands, bands,
      runs, units, pieces, vec_out);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  rows: output rows a unit of work
// covers (1 or 4; the wrapper's k1_rows).  Launches one kernel on `stream`
// and returns cudaGetLastError() (0 on success); shapes or plans the
// kernels do not take return cudaErrorInvalidValue without launching.
extern "C" int tfold_conv1_forward(const void* x, const void* w, void* y,
                                   int batch, int cin, int frames, int h,
                                   int wd, int cout, int dtype, int rows,
                                   void* stream) {
  if (cin != kCin || cout != kCout || batch <= 0 || frames <= 0 || h <= 0
      || wd <= 0 || (rows != 1 && rows != 4) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int ho = (h - 1) / 2 + 1;
  const int wo = (wd - 1) / 2 + 1;
  const int col_bands = (wo + kCols - 1) / kCols;
  const long long bands = (long long)col_bands * ((ho + rows - 1) / rows);
  const long long runs = (frames + kFrames - 1) / kFrames;
  if (bands * runs * batch > INT_MAX) return (int)cudaErrorInvalidValue;
  const int units = (int)(bands * runs * batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(rows == 4
                   ? launch<4>(dtype, x, w, y, frames, h, wd, ho, wo,
                               col_bands, (int)bands, (int)runs, units, s)
                   : launch<1>(dtype, x, w, y, frames, h, wd, ho, wo,
                               col_bands, (int)bands, (int)runs, units, s));
}

extern "C" const char* tfold_conv1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K4: the space-to-depth, T-group-folded conv core of family D over one
// slab a row (s2d_fold_matmul), written for Hopper (sm_90a): forward,
// input gradient and weight gradient.
//
// Replaces the Pallas TPU kernels of cvad_tpu/ops/pallas_s2d.py reached
// through s2d_fold_matmul (:319): _make_fwd (pl.pallas_call at :177),
// _make_dgrad (:223), _make_wgrad (:271).  (K5, the same fold over slabs,
// runs its own band kernels in s2d_group_conv.cu.)
//
// What it computes, for x (R, Hc, Wc, K) channels-last and w (4, K, N) of
// any values (the four stride-1 (2, 2) taps (dh, dw), tap 2*dh + dw), with
// float32 sums:
//   forward         y[r, h, w, n] = sum_{tap, k} x[r, h+dh, w+dw, k]
//                   * w[tap, k, n], over (R, Hc-1, Wc-1, N);
//   input gradient  dx[r, h, w, k] = sum_{tap, n} ct[r, h-dh, w-dw, n]
//                   * w[tap, k, n], zero outside ct, over (R, Hc, Wc, K);
//   weight gradient dw[tap, k, n] = sum_{r, h, w} x[r, h+dh, w+dw, k]
//                   * ct[r, h, w, n], (4, K, N) float32.
// The input gradient is the forward over the cotangent padded by one zero
// cell on each side, with the taps flipped and w transposed: the wrapper
// passes w'[tap] = w[3 - tap]^T (4, N, K), and the kernels read the padded
// grid P(h, w) = A(h - lead, w - lead), lead = 1 (lead = 0 and P = x: the
// forward).  Unlike K5's, K4's contract (s2d_fold_matmul, :319-337) is a
// conv over any w, so every entry of the dense fold is computed.
//
// Bound at the main shape, x (1024, 33, 33, 120) and w (4, 120, 128) (B=128,
// T=64, g=8, C=3, O=16; H100 SXM peaks): 4 x 120 MACs an output, 128.8
// GFLOP a kernel;
//   float32:  max(128.8 GFLOP / 67 TFLOP/s = 1.92 ms, 1.07 GB / 3.35 TB/s
//             = 0.32 ms) -> 1.92 ms, operations;
//   bfloat16: max(0.536 GB / 3.35 TB/s = 0.160 ms, 128.8 GFLOP / 989
//             TFLOP/s = 0.130 ms) -> 0.160 ms, bytes.
//
// Tiles.  Pixels are walked in the padded grid's row-major order over all
// rows: position Q = r * (ph * pw) + h * pw + w of P (ph x pw, one row and
// one column past the output), so a tile of consecutive Q reads P at
// Q + dh * pw + dw for tap (dh, dw): one contiguous halo of tile + pw + 1
// cells serves the four taps as shifts and is copied from device memory
// once a tile.  The positions past the output (its last row and column)
// are computed and dropped: 6% of the work at the main shape, where 2-D
// tiles of the input gradient's 33 x 33 output would drop half.
//
// Routes, chosen by the wrapper from the shapes before any launch
// (ops/pallas_s2d.py::k4_route, the one place that chooses; a launch
// refuses a route it cannot run):
// - tensor cores (bfloat16; K and N multiples of 8, at most 128, and the
//   shared memory below within 227 KB, which the wrapper's rule meets by
//   a cap on Wc): mma.sync m16n8k16, bf16 operands, f32 sums.
//   Forward and input gradient: a block stages the whole w (4K x N, 123 KB
//   at the main shape) once, then walks 128-pixel tiles in a grid-stride
//   loop with cp.async copies of the next tile's halo in flight behind the
//   current one's products; M = the tile's pixels, N = the output
//   channels, K = (tap, channel) flattened, 4K/16 k-steps (each 8-wide
//   half of a k-step lies in one tap, as K % 8 == 0); ldmatrix reads the
//   halo as A, ldmatrix.trans reads w [(tap, k)][n] as B; a warp owns 32
//   pixels x 64 channels.  Weight gradient: M = K (m-tiles of 16; rows
//   past K are computed and dropped), N = a 64-wide slab of the output
//   channels, the reduction over a tile's 128 pixels; ldmatrix.trans reads
//   both operands from their channels-last copies (x as a tap's shift of
//   the halo); a warp owns one tap and half the m-tiles.
// - CUDA cores (float32, and bfloat16 at other shapes): f32 FMAs, bf16
//   staged as bf16 and widened in registers.  Forward and input gradient:
//   a block owns a 128-pixel tile and 128 output channels and loops over
//   the reduction in chunks of 16 channels, each chunk's halo and w slice
//   double-buffered by cp.async; a thread owns 8 consecutive pixels x 8
//   channels and, for each reduction channel, reads 18 halo cells (its
//   pixels and their shifts) and 4 taps x 8 weights for 256 FMAs.  Weight
//   gradient: a block owns 4 taps x 32 rows of K x 128 columns of N and
//   walks 64-pixel tiles, double-buffered; a thread owns 8 rows x 8
//   columns, 64 FMAs for 4 vector loads.
// The weight gradients write one float32 partial a block, over a grid
// fixed by the shapes (not by the card), and a second pass adds them in a
// fixed order: no float atomics, so a second call is bit-identical on
// every card.  All offsets into x, y and the cotangent are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#include "hopper_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;      // pixels a forward tile, and a tc wgrad item
constexpr int kBK = 16;         // cc forward: reduction channels a chunk
constexpr int kBN = 128;        // cc forward: output channels a block
constexpr int kWK = 32;         // cc wgrad: rows of K a block
constexpr int kWN = 128;        // cc wgrad: columns of N a block
constexpr int kWT = 64;         // cc wgrad: pixels an item
constexpr int kCcParts = 264;   // cc wgrad: blocks aimed at (2 an SM)
constexpr int kSlab = 64;       // tc wgrad: columns of N a block
// tc wgrad: blocks aimed at, 8 waves of one an SM: a partial sums ~18
// items at the main shape, not ~140, since the tensor cores' f32 sums lose
// up to an ulp of the running sum an mma (~1e-7 relative), which a chain of
// 1,100 mma a partial grew to 2e-5 of the largest entry
constexpr int kTcParts = 1056;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// 4 consecutive elements of shared memory (16-byte aligned for f32, 8-byte
// for bf16) widened to f32
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const bf16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// channels [c, c+4) of an output row of `out` channels, those below `out`
__device__ __forceinline__ void store4(float* row, int c, const float* v,
                                       int out) {
  if ((out & 3) == 0 && c + 4 <= out) {
    *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  for (int e = 0; e < 4; ++e)
    if (c + e < out) row[c + e] = v[e];
}
__device__ __forceinline__ void store4(bf16* row, int c, const float* v,
                                       int out) {
  if ((out & 3) == 0 && c + 4 <= out) {
    uint2 u;
    *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(row + c) = u;
    return;
  }
  for (int e = 0; e < 4; ++e)
    if (c + e < out) row[c + e] = __float2bfloat16(v[e]);
}

// The padded grid P (ph x pw a row) over `rows` images, read from A (rows,
// ah, aw, .) as P(h, w) = A(h - lead, w - lead), zero outside A; outputs
// are the positions with h < oh and w < ow.
struct Grid {
  int rows, ph, pw, oh, ow, ah, aw, lead, img;  // img = ph * pw
  long long total;                              // rows * img
};

bool make_grid(Grid& g, int rows, int ph, int pw, int oh, int ow, int ah,
               int aw, int lead) {
  if (rows <= 0 || ph <= 0 || pw <= 0 || oh <= 0 || ow <= 0 || ah <= 0
      || aw <= 0)
    return false;
  const long long img = (long long)ph * pw;
  // Div's exactness: a position within an image and its halo, times pw
  if ((img + 2 * kTile + pw + 1) * pw >= (1LL << 32)) return false;
  g = Grid{rows, ph, pw, oh, ow, ah, aw, lead, (int)img, rows * img};
  return g.total / kWT < INT_MAX;
}

long long tiles_of(const Grid& g, int tile) {
  return (g.total + tile - 1) / tile;
}

// image r0 and position q0 in it of a tile's first pixel
__device__ __forceinline__ void tile_start(const Grid& g, long long tile,
                                           int tilepix, int& r0, int& q0) {
  const long long first = tile * tilepix;
  r0 = (int)(first / g.img);
  q0 = (int)(first - (long long)r0 * g.img);
}

// P cell q of image r0 (q may run past the image into the next ones): its
// image r and (h, w); false past the last image
__device__ __forceinline__ bool cell_at(const Grid& g, const Div& by_pw,
                                        int r0, int q, int& r, int& h,
                                        int& w) {
  r = r0;
  while (q >= g.img) {
    q -= g.img;
    ++r;
  }
  if (r >= g.rows) return false;
  h = by_pw.div(q);
  w = by_pw.mod(q, h);
  return true;
}

// the element offset of A's row at P cell q of image r0 (times the channel
// count), or -1 outside A
__device__ __forceinline__ long long a_row(const Grid& g, const Div& by_pw,
                                           int r0, int q) {
  int r, h, w;
  if (!cell_at(g, by_pw, r0, q, r, h, w)) return -1;
  const int ha = h - g.lead, wa = w - g.lead;
  if (ha < 0 || ha >= g.ah || wa < 0 || wa >= g.aw) return -1;
  return ((long long)r * g.ah + ha) * g.aw + wa;
}

// the output row of P cell q of image r0, or -1 if it is not an output
__device__ __forceinline__ long long out_row(const Grid& g, const Div& by_pw,
                                             int r0, int q) {
  int r, h, w;
  if (!cell_at(g, by_pw, r0, q, r, h, w) || h >= g.oh || w >= g.ow)
    return -1;
  return ((long long)r * g.oh + h) * g.ow + w;
}

// ---------------------------------------------------------------------------
// CUDA cores, forward and input gradient: block = (tile, 128 output
// channels); the reduction in chunks of kBK channels, double-buffered
// ---------------------------------------------------------------------------

// halo row of a chunk: kBK channels and an 8-byte pad, so that the halo
// cells 8 apart that a warp reads fall on banks 16 words apart
template <typename T>
__host__ __device__ constexpr int cc_xp() { return kBK + 8 / (int)sizeof(T); }

template <typename T>
__host__ __device__ constexpr int cc_xelems(int cells) {
  return (cells * cc_xp<T>() + 7) / 8 * 8;  // 16-byte aligned w after it
}

// Copy chunk k0 of the tile's halo, xs[cell][cc_xp] (crow[cell]: the row of
// A at each cell, -1 outside), and of w, ws[tap][kBK][kBN] (output channels
// c0..c0+kBN), zeros outside.  `vec`: 8-byte copies of the halo and
// 16-byte copies of w (red % (8/size) == 0, out % (16/size) == 0 and
// aligned operands); else element by element.
template <typename T>
__device__ __forceinline__ void cc_stage(T* xs, T* ws, const T* __restrict__ a,
                                         const T* __restrict__ w,
                                         const long long* crow, int cells,
                                         int red, int out, int k0, int c0,
                                         bool vec) {
  constexpr int E8 = 8 / sizeof(T), E16 = 16 / sizeof(T);
  constexpr int XP = cc_xp<T>(), XPARTS = kBK / E8, WPARTS = kBN / E16;
  for (int i = threadIdx.x; i < cells * XPARTS; i += kThreads) {
    const int cell = i / XPARTS, part = i % XPARTS;
    const int q = k0 + part * E8;
    const long long row = crow[cell];
    T* dst = xs + cell * XP + part * E8;
    if (vec) {
      const bool ok = row >= 0 && q < red;
      cp_async8(dst, ok ? a + row * red + q : a, ok);
    } else {
#pragma unroll
      for (int e = 0; e < E8; ++e)
        dst[e] = (row >= 0 && q + e < red) ? a[row * red + q + e] : T(0.f);
    }
  }
  for (int i = threadIdx.x; i < 4 * kBK * WPARTS; i += kThreads) {
    const int row = i / WPARTS, part = i % WPARTS;  // row = tap * kBK + kk
    const int q = k0 + row % kBK, c = c0 + part * E16;
    const T* src = w + ((long long)(row / kBK) * red + q) * out + c;
    T* dst = ws + row * kBN + part * E16;
    if (vec) {
      const bool ok = q < red && c < out;
      cp_async16(dst, ok ? src : w, ok);
    } else {
#pragma unroll
      for (int e = 0; e < E16; ++e)
        dst[e] = (q < red && c + e < out) ? src[e] : T(0.f);
    }
  }
}

// warp w: pixels 8 * (2w + lane / 16) .. + 8 of the tile; lane % 16 = j:
// output channels c0 + 4j .. + 4 and c0 + 64 + 4j .. + 4
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
s2d_conv_cc_kernel(const T* __restrict__ a, const T* __restrict__ w,
                   T* __restrict__ y, Grid g, int red, int out, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int XP = cc_xp<T>();
  const int cells = kTile + g.pw + 1;
  const int xelems = cc_xelems<T>(cells);
  const int selems = xelems + 4 * kBK * kBN;
  T* sm = reinterpret_cast<T*>(smem_raw);
  long long* crow = reinterpret_cast<long long*>(sm + 2 * selems);
  int r0, q0;
  tile_start(g, blockIdx.x, kTile, r0, q0);
  const int c0 = blockIdx.y * kBN;
  const Div by_pw(g.pw);
  const int chunks = (red + kBK - 1) / kBK;

  for (int cell = threadIdx.x; cell < cells; cell += kThreads)
    crow[cell] = a_row(g, by_pw, r0, q0 + cell);
  __syncthreads();
  cc_stage(sm, sm + xelems, a, w, crow, cells, red, out, 0, c0, vec);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = 2 * warp + (lane >> 4), j = lane & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      T* nxt = sm + ((ch + 1) & 1) * selems;
      cc_stage(nxt, nxt + xelems, a, w, crow, cells, red, out,
               (ch + 1) * kBK, c0, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk ch is in place
    const T* xs = sm + (ch & 1) * selems;
    const T* ws = xs + xelems + 4 * j;
    const T* x0 = xs + 8 * grp * XP;   // cells of taps dh = 0
    const T* x1 = x0 + g.pw * XP;      // and dh = 1
#pragma unroll 2
    for (int kk = 0; kk < kBK; ++kk) {
      float xa[9], xb[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        xa[i] = to_f32(x0[i * XP + kk]);
        xb[i] = to_f32(x1[i * XP + kk]);
      }
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        float wv[8];
        const T* wr = ws + (tap * kBK + kk) * kBN;
        load4(wr, wv);
        load4(wr + 64, wv + 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xv = (tap >> 1) ? xb[i + (tap & 1)] : xa[i + (tap & 1)];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(xv, wv[e], acc[i][e]);
        }
      }
    }
    __syncthreads();  // chunk ch is read before chunk ch+2 lands on it
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = out_row(g, by_pw, r0, q0 + 8 * grp + i);
    if (row < 0) continue;
    T* yr = y + row * out;
    store4(yr, c0 + 4 * j, acc[i], out);
    store4(yr, c0 + 64 + 4 * j, acc[i] + 4, out);
  }
}

// ---------------------------------------------------------------------------
// CUDA cores, weight gradient, pass 1: block (chunk, 32 rows of K, 128
// columns of N) sums over the 64-pixel items chunk, chunk + chunks, ...
// into partial[chunk][tap][k][n]
// ---------------------------------------------------------------------------

// Copy item `item`: x's halo, xs[cell][kWK] (rows k0..k0+kWK of K), and the
// cotangent, cs[pixel][kWN] (columns n0..n0+kWN), zeros outside.  `vec`:
// 16-byte copies (k % (16/size) == 0, n % (16/size) == 0).
// (crow: the cells' rows of x and then the pixels' rows of ct, found
// first, a barrier before the copies; every thread calls this or none)
template <typename T>
__device__ __forceinline__ void ccw_stage(T* xs, T* cs, long long* crow,
                                          const T* __restrict__ x,
                                          const T* __restrict__ ct,
                                          const Grid& g, const Div& by_pw,
                                          int k, int n, long long item, int k0,
                                          int n0, bool vec) {
  constexpr int E16 = 16 / sizeof(T);
  constexpr int XPARTS = kWK / E16, CPARTS = kWN / E16;
  int r0, q0;
  tile_start(g, item, kWT, r0, q0);
  const int cells = kWT + g.pw + 1;
  for (int i = threadIdx.x; i < cells + kWT; i += kThreads)
    crow[i] = i < cells ? a_row(g, by_pw, r0, q0 + i)
                        : out_row(g, by_pw, r0, q0 + i - cells);
  __syncthreads();
  for (int i = threadIdx.x; i < cells * XPARTS; i += kThreads) {
    const int cell = i / XPARTS, part = i % XPARTS;
    const int q = k0 + part * E16;
    const long long row = crow[cell];
    T* dst = xs + cell * kWK + part * E16;
    if (vec) {
      const bool ok = row >= 0 && q < k;
      cp_async16(dst, ok ? x + row * k + q : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < E16; ++e)
        dst[e] = (row >= 0 && q + e < k) ? x[row * k + q + e] : T(0.f);
    }
  }
  for (int i = threadIdx.x; i < kWT * CPARTS; i += kThreads) {
    const int pix = i / CPARTS, part = i % CPARTS;
    const int c = n0 + part * E16;
    const long long row = crow[cells + pix];
    T* dst = cs + pix * kWN + part * E16;
    if (vec) {
      const bool ok = row >= 0 && c < n;
      cp_async16(dst, ok ? ct + row * n + c : ct, ok);
    } else {
#pragma unroll
      for (int e = 0; e < E16; ++e)
        dst[e] = (row >= 0 && c + e < n) ? ct[row * n + c + e] : T(0.f);
    }
  }
}

// warp w: tap w / 2, rows k0 + 8 * (2 (w % 2) + lane / 16) .. + 8; lane %
// 16 = j: columns n0 + 4j .. + 4 and n0 + 64 + 4j .. + 4
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
s2d_wgrad_cc_kernel(const T* __restrict__ x, const T* __restrict__ ct,
                    float* __restrict__ partial, Grid g, int k, int n,
                    long long items, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int xelems = (kWT + g.pw + 1) * kWK;  // a multiple of 16 bytes
  const int selems = xelems + kWT * kWN;
  T* sm = reinterpret_cast<T*>(smem_raw);
  long long* crow = reinterpret_cast<long long*>(sm + 2 * selems);
  const int chunk = blockIdx.x, chunks = gridDim.x;
  const int k0 = blockIdx.y * kWK, n0 = blockIdx.z * kWN;
  const Div by_pw(g.pw);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tap = warp >> 1, j = lane & 15;
  const int koff = 8 * (2 * (warp & 1) + (lane >> 4));
  const int shift = (tap >> 1) * g.pw + (tap & 1);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  if (chunk < items)
    ccw_stage(sm, sm + xelems, crow, x, ct, g, by_pw, k, n, chunk, k0, n0,
              vec);
  cp_async_commit();
  int it = 0;
  for (long long item = chunk; item < items; item += chunks, ++it) {
    if (item + chunks < items) {
      T* nxt = sm + ((it + 1) & 1) * selems;
      ccw_stage(nxt, nxt + xelems, crow, x, ct, g, by_pw, k, n, item + chunks,
                k0, n0, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this item is in place
    const T* xs = sm + (it & 1) * selems + shift * kWK + koff;
    const T* cs = sm + (it & 1) * selems + xelems + 4 * j;
#pragma unroll 4
    for (int p = 0; p < kWT; ++p) {
      float av[8], bv[8];
      load4(xs + p * kWK, av);
      load4(xs + p * kWK + 4, av + 4);
      load4(cs + p * kWN, bv);
      load4(cs + p * kWN + 64, bv + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(av[i], bv[e], acc[i][e]);
    }
    __syncthreads();  // read before the item after next lands on it
  }

  float* part = partial + ((long long)chunk * 4 + tap) * k * n;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kk = k0 + koff + i;
    if (kk >= k) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = n0 + 4 * j + (e & 3) + 64 * (e >> 2);
      if (c < n) part[(long long)kk * n + c] = acc[i][e];
    }
  }
}

// weight gradient, pass 2: out[i] = the sum over parts of partial[part][i],
// part by part in order
__global__ void __launch_bounds__(256)
s2d_wgrad_reduce_kernel(const float* __restrict__ partial,
                        float* __restrict__ out, long long total, int parts) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int c = 0; c < parts; ++c) s += partial[(long long)c * total + i];
  out[i] = s;
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

// shared memory of the forward / input-gradient kernel: w [(tap, q)][out]
// once, two halo stages [cell][red], 8 elements of slack for the fragment
// loads that run past the last row (their columns are dropped), the A
// offsets of the red / 2 8-channel chunks of (tap, channel) (int32), and
// the rows of a halo's cells (int64)
size_t tc_conv_smem(int red, int out, int pw) {
  const size_t cells = kTile + pw + 1;
  return ((size_t)4 * red * tc_row(out) + 2 * cells * tc_row(red) + 8 + red
          + 4 * cells) * sizeof(bf16);
}

// of the weight gradient: two stages of the halo [cell][k] and of the
// cotangent's slab [pixel][kSlab], slack, and the rows of a halo's cells
size_t tc_wgrad_smem(int k, int pw) {
  const size_t cells = kTile + pw + 1;
  return (2 * cells * tc_row(k) + 2 * (size_t)kTile * tc_row(kSlab) + 8
          + 4 * cells) * sizeof(bf16);
}

// The halo of the tile at (r0, q0) in two steps, a barrier between them:
// crow[cell] = the row of A at each cell (-1 outside), one computation a
// cell; then xs[cell][redp] by 16-byte copies, consecutive threads on
// consecutive chunks, zeros outside.
__device__ __forceinline__ void tc_halo_rows(long long* crow, const Grid& g,
                                             const Div& by_pw, int r0, int q0,
                                             int cells) {
  for (int cell = threadIdx.x; cell < cells; cell += blockDim.x)
    crow[cell] = a_row(g, by_pw, r0, q0 + cell);
}

__device__ __forceinline__ void tc_halo_copy(bf16* xs,
                                             const bf16* __restrict__ a,
                                             const long long* crow,
                                             const Div& by_ck, int red,
                                             int redp, int cells) {
  const int nck = (int)by_ck.d;
  for (int i = threadIdx.x; i < cells * nck; i += blockDim.x) {
    const int cell = by_ck.div(i), part = by_ck.mod(i, cell);
    const long long row = crow[cell];
    cp_async16(xs + cell * redp + 8 * part,
               row >= 0 ? a + row * red + 8 * part : a, row >= 0);
  }
}

// four 32-bit words of a quad (lanes 4g .. 4g+3), transposed: lane t's
// v[s] becomes lane s's v[t]
__device__ __forceinline__ void quad_transpose(uint32_t v[4], int t) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint32_t send = (t & 2) ? v[j] : v[j + 2];
    const uint32_t recv = __shfl_xor_sync(0xffffffffu, send, 2);
    if (t & 2) v[j] = recv; else v[j + 2] = recv;
  }
#pragma unroll
  for (int j = 0; j < 4; j += 2) {
    const uint32_t send = (t & 1) ? v[j] : v[j + 1];
    const uint32_t recv = __shfl_xor_sync(0xffffffffu, send, 1);
    if (t & 1) v[j] = recv; else v[j + 1] = recv;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Forward and input gradient: warp w owns pixels 32 (w % 4) .. + 32 (MI = 2
// m-tiles) and output channels 64 (w / 4) .. + 64 (8 n-tiles) of a tile.
// (Warps of 64 x 64 took as long: the per-tile copies and stores, not the
// fragment loads, set the time.)
__global__ void __launch_bounds__(kThreads, 1)
s2d_conv_tc_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                   bf16* __restrict__ y, Grid g, int red, int out,
                   long long tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int redp = tc_row(red), outp = tc_row(out);
  const int cells = kTile + g.pw + 1;
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);  // [(tap, q)][outp]
  bf16* xs = ws + 4 * red * outp;                // 2 x [cell][redp]
  const int xstage = cells * redp;
  // chunk c of (tap, channel): tap 8c / red at channel 8c % red, read at
  // the halo offset koff[c] from a pixel's cell
  int* koff = reinterpret_cast<int*>(xs + 2 * xstage + 8);
  long long* crow = reinterpret_cast<long long*>(xs + 2 * xstage + 8 + red);
  const Div by_pw(g.pw), by_ck(red / 8), by_wck(out / 8);
  if (blockIdx.x >= tiles) return;
  for (int c = threadIdx.x; c < red / 2; c += blockDim.x) {
    const int tap = by_ck.div(c), q = 8 * by_ck.mod(c, tap);
    koff[c] = ((tap >> 1) * g.pw + (tap & 1)) * redp + q;
  }

  for (int i = threadIdx.x; i < 4 * red * (out / 8); i += blockDim.x) {
    const int row = by_wck.div(i), part = by_wck.mod(i, row);
    cp_async16(ws + row * outp + 8 * part, w + (long long)row * out + 8 * part,
               true);
  }
  {
    int r0, q0;
    tile_start(g, blockIdx.x, kTile, r0, q0);
    tc_halo_rows(crow, g, by_pw, r0, q0, cells);
    __syncthreads();
    tc_halo_copy(xs, a, crow, by_ck, red, redp, cells);
  }
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int MI = 2;
  const int wm = warp & 3, nt0 = (warp >> 2) * 8;
  const int ntt = out / 8;
  const int lj = lane >> 3, li = lane & 7;
  const int gq = lane >> 2, tq = lane & 3;
  // ldmatrix rows of the lane: A, pixel (MI wm + mi) * 16 + (lj & 1) * 8
  // + li at the k-step's chunk lj >> 1; B, row 16 ks + (lj & 1) * 8 + li
  // of w at n-tile nt0 + 2 np + (lj >> 1)
  const int arow = 16 * MI * wm + (lj & 1) * 8 + li;
  const bf16* wlane = ws + ((lj & 1) * 8 + li) * outp + (nt0 + (lj >> 1)) * 8;
  const int ksteps = red / 4;

  int it = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const long long next = tile + gridDim.x;
    if (next < tiles) {
      int r1, q1;
      tile_start(g, next, kTile, r1, q1);
      tc_halo_rows(crow, g, by_pw, r1, q1, cells);
    }
    __syncthreads();  // crow is in place
    if (next < tiles)
      tc_halo_copy(xs + ((it + 1) & 1) * xstage, a, crow, by_ck, red, redp,
                   cells);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile's halo (and, first, w) are in place
    const bf16* cur = xs + (it & 1) * xstage;

    float acc[MI][8][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
    // fragments of k-step ks + 1 are loaded while the products of ks run
    // (ksteps = red / 4 is even, as red % 8 == 0)
    uint32_t fa[2][MI][4], fb[2][4][4];
    const int* kl = koff + (lj >> 1);
    const auto load = [&](int ks, uint32_t (&a)[MI][4], uint32_t (&b)[4][4]) {
      const bf16* ap = cur + arow * redp + kl[2 * ks];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) ldsm_x4(a[mi], ap + 16 * mi * redp);
      const bf16* wk = wlane + 16 * ks * outp;
#pragma unroll
      for (int np = 0; np < 4; ++np)
        if (nt0 + 2 * np < ntt) ldsm_x4_trans(b[np], wk + 16 * np);
    };
    const auto product = [&](const uint32_t (&a)[MI][4],
                             const uint32_t (&b)[4][4]) {
#pragma unroll
      for (int np = 0; np < 4; ++np)
        if (nt0 + 2 * np < ntt) {
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_bf16(acc[mi][2 * np], a[mi], b[np]);
            mma_bf16(acc[mi][2 * np + 1], a[mi], b[np] + 2);
          }
        }
    };
    load(0, fa[0], fb[0]);
    for (int ks = 0; ks < ksteps; ks += 2) {
      load(ks + 1, fa[1], fb[1]);
      product(fa[0], fb[0]);
      if (ks + 2 < ksteps) load(ks + 2, fa[0], fb[0]);
      product(fa[1], fb[1]);
    }

    int r0, q0;
    tile_start(g, tile, kTile, r0, q0);
    // a pixel's 8 n-tiles lie across its quad, 4 bytes of each a lane:
    // transposed in groups of 4 n-tiles, lane t stores n-tile 4 h + t of
    // group h as one 16-byte store
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = out_row(
            g, by_pw, r0, q0 + 16 * (MI * wm + mi) + gq + 8 * half);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v[4];
#pragma unroll
          for (int s = 0; s < 4; ++s)
            v[s] = pack_bf16(acc[mi][4 * h + s][2 * half],
                             acc[mi][4 * h + s][2 * half + 1]);
          quad_transpose(v, tq);
          const int nt = nt0 + 4 * h + tq;
          if (row >= 0 && nt < ntt)
            *reinterpret_cast<uint4*>(y + row * out + nt * 8) =
                make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    __syncthreads();  // `cur` is read before the tile after next lands on it
  }
}

// Copy item `item` of the weight gradient: x's halo xs[cell][kp] and the
// cotangent's columns n0..n0+kSlab, cs[pixel][cp], zeros outside.
__device__ __forceinline__ void tcw_stage(bf16* xs, bf16* cs, long long* crow,
                                          const bf16* __restrict__ x,
                                          const bf16* __restrict__ ct,
                                          const Grid& g, const Div& by_pw,
                                          const Div& by_ck, int k, int n,
                                          int kp, int cp, long long item,
                                          int n0) {
  int r0, q0;
  tile_start(g, item, kTile, r0, q0);
  const int cells = kTile + g.pw + 1;
  tc_halo_rows(crow, g, by_pw, r0, q0, cells);
  __syncthreads();  // crow is in place
  tc_halo_copy(xs, x, crow, by_ck, k, kp, cells);
  // the cotangent: two threads a pixel, half the slab each
  static_assert(kThreads == 2 * kTile, "two threads a pixel");
  const int pix = threadIdx.x >> 1, half = (threadIdx.x & 1) * (kSlab / 2);
  const long long row = out_row(g, by_pw, r0, q0 + pix);
#pragma unroll
  for (int c = half; c < half + kSlab / 2; c += 8) {
    const bool ok = row >= 0 && n0 + c < n;
    cp_async16(cs + pix * cp + c, ok ? ct + row * n + n0 + c : ct, ok);
  }
}

// Weight gradient, pass 1: block (chunk, slab of kSlab columns) sums over
// items chunk, chunk + chunks, ...; warp w owns tap w / 2 and m-tiles
// 4 (w % 2) .. + 4 (rows of K), every n-tile of the slab.
__global__ void __launch_bounds__(kThreads, 1)
s2d_wgrad_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ct,
                    float* __restrict__ partial, Grid g, int k, int n,
                    long long items) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kp = tc_row(k), cp = tc_row(kSlab);
  const int cells = kTile + g.pw + 1;
  const int xstage = cells * kp, cstage = kTile * cp;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // 2 x [cell][kp]
  bf16* cs = xs + 2 * xstage;                    // 2 x [pixel][cp]
  long long* crow = reinterpret_cast<long long*>(cs + 2 * cstage + 8);
  const int chunk = blockIdx.x, chunks = gridDim.x;
  const int n0 = blockIdx.y * kSlab;
  const Div by_pw(g.pw), by_ck(k / 8);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tap = warp >> 1, mt0 = 4 * (warp & 1);
  const int mtt = (k + 15) / 16;
  const int ntt = min(kSlab, n - n0) / 8;
  const int lj = lane >> 3, li = lane & 7;
  const int gq = lane >> 2, tq = lane & 3;
  const int shift = (tap >> 1) * g.pw + (tap & 1);
  // ldmatrix.trans rows of the lane: A (x), pixel (lj >> 1) * 8 + li and
  // channels mt * 16 + (lj & 1) * 8; B (ct), pixel (lj & 1) * 8 + li and
  // n-tile 2 np + (lj >> 1)
  const int a_off = ((lj >> 1) * 8 + li + shift) * kp + mt0 * 16 + (lj & 1) * 8;
  const int b_off = ((lj & 1) * 8 + li) * cp + (lj >> 1) * 8;

  float acc[4][8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;

  if (chunk < items)
    tcw_stage(xs, cs, crow, x, ct, g, by_pw, by_ck, k, n, kp, cp, chunk, n0);
  cp_async_commit();
  int it = 0;
  for (long long item = chunk; item < items; item += chunks, ++it) {
    if (item + chunks < items)  // uniform: every thread stages or none
      tcw_stage(xs + ((it + 1) & 1) * xstage, cs + ((it + 1) & 1) * cstage,
                crow, x, ct, g, by_pw, by_ck, k, n, kp, cp, item + chunks,
                n0);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this item is in place
    const bf16* xc = xs + (it & 1) * xstage + a_off;
    const bf16* cc = cs + (it & 1) * cstage + b_off;
    // fragments of k-step ks + 1 are loaded while the products of ks run
    uint32_t fa[2][4][4], fb[2][4][4];
    const auto load = [&](int ks, uint32_t (&a)[4][4], uint32_t (&b)[4][4]) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        if (mt0 + mi < mtt) ldsm_x4_trans(a[mi], xc + 16 * ks * kp + 16 * mi);
#pragma unroll
      for (int np = 0; np < 4; ++np)
        if (2 * np < ntt) ldsm_x4_trans(b[np], cc + 16 * ks * cp + 16 * np);
    };
    const auto product = [&](const uint32_t (&a)[4][4],
                             const uint32_t (&b)[4][4]) {
#pragma unroll
      for (int np = 0; np < 4; ++np)
        if (2 * np < ntt) {
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
            if (mt0 + mi < mtt) {
              mma_bf16(acc[mi][2 * np], a[mi], b[np]);
              mma_bf16(acc[mi][2 * np + 1], a[mi], b[np] + 2);
            }
        }
    };
    load(0, fa[0], fb[0]);
#pragma unroll 1
    for (int ks = 0; ks < kTile / 16; ks += 2) {
      load(ks + 1, fa[1], fb[1]);
      product(fa[0], fb[0]);
      if (ks + 2 < kTile / 16) load(ks + 2, fa[0], fb[0]);
      product(fa[1], fb[1]);
    }
    __syncthreads();  // read before the item after next lands on it
  }

  float* part = partial + ((long long)chunk * 4 + tap) * k * n;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = (mt0 + mi) * 16 + gq + 8 * (e >> 1);
        const int c = n0 + nt * 8 + 2 * tq + (e & 1);
        if (kk < k && nt < ntt) part[(long long)kk * n + c] = acc[mi][nt][e];
      }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// the partials of the weight gradient: a count fixed by the shapes, so that
// their sum has one order on every card
struct WgradPlan {
  int chunks, kranges, nslabs;
};

WgradPlan wgrad_plan(int k, int n, int route) {
  WgradPlan w;
  if (route == 1) {
    w.kranges = 1;
    w.nslabs = (n + kSlab - 1) / kSlab;
    w.chunks = kTcParts / w.nslabs;
  } else {
    w.kranges = (k + kWK - 1) / kWK;
    w.nslabs = (n + kWN - 1) / kWN;
    w.chunks = kCcParts / (w.kranges * w.nslabs);
  }
  if (w.chunks < 1) w.chunks = 1;
  return w;
}

template <typename T>
int conv(const void* a, const void* w, void* y, const Grid& g, int red,
         int out, int route, cudaStream_t stream) {
  cudaError_t err;
  if (route == 1) {
    static SmemSet set;
    const auto kernel = s2d_conv_tc_kernel;
    const size_t smem = tc_conv_smem(red, out, g.pw);
    const long long tiles = tiles_of(g, kTile);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    err = allow_smem(set, kernel, smem);
    int blocks = 0;
    if (err == cudaSuccess)
      err = resident_blocks(kernel, kThreads, smem, blocks);
    if (err != cudaSuccess) return (int)err;
    if (blocks > tiles) blocks = (int)tiles;
    kernel<<<blocks, kThreads, smem, stream>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(w),
        static_cast<bf16*>(y), g, red, out, tiles);
    return (int)cudaGetLastError();
  }
  static SmemSet set;
  const size_t cells = kTile + g.pw + 1;
  const size_t smem =
      2 * ((size_t)cc_xelems<T>(cells) + 4 * kBK * kBN) * sizeof(T)
      + cells * sizeof(long long);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  err = allow_smem(set, s2d_conv_cc_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = red % (8 / sizeof(T)) == 0 && out % (16 / sizeof(T)) == 0;
  const dim3 grid((unsigned)tiles_of(g, kTile), (out + kBN - 1) / kBN);
  s2d_conv_cc_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(w), static_cast<T*>(y),
      g, red, out, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int wgrad(const void* x, const void* ct, void* partial, void* out,
          const Grid& g, int k, int n, int route, cudaStream_t stream) {
  const WgradPlan plan = wgrad_plan(k, n, route);
  cudaError_t err;
  if (route == 1) {
    static SmemSet set;
    const size_t smem = tc_wgrad_smem(k, g.pw);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    err = allow_smem(set, s2d_wgrad_tc_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    s2d_wgrad_tc_kernel<<<dim3(plan.chunks, plan.nslabs), kThreads, smem,
                          stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(ct),
        static_cast<float*>(partial), g, k, n, tiles_of(g, kTile));
  } else {
    static SmemSet set;
    const size_t cells = kWT + g.pw + 1;
    const size_t smem =
        2 * (cells * kWK + kWT * kWN) * sizeof(T)
        + (cells + kWT) * sizeof(long long);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    err = allow_smem(set, s2d_wgrad_cc_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    const int vec = k % (16 / sizeof(T)) == 0 && n % (16 / sizeof(T)) == 0;
    s2d_wgrad_cc_kernel<T><<<dim3(plan.chunks, plan.kranges, plan.nslabs),
                             kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(ct),
        static_cast<float*>(partial), g, k, n, tiles_of(g, kWT), vec);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = 4LL * k * n;
  s2d_wgrad_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                            stream>>>(static_cast<const float*>(partial),
                                      static_cast<float*>(out), total,
                                      plan.chunks);
  return (int)cudaGetLastError();
}

// a call's route and type, or false for what the kernels cannot run:
// route 0 = CUDA cores (float32 or bfloat16), 1 = tensor cores (bfloat16:
// whole 16-byte rows and 8-wide n-tiles, at most 8 m- or n-tiles of 16 a
// warp half; conv and wgrad refuse the shared memory past kMaxSmem)
bool valid_call(int route, int dtype, int k, int n) {
  if (dtype != 0 && dtype != 1) return false;
  if (route == 0) return true;
  return route == 1 && dtype == 1 && k % 8 == 0 && n % 8 == 0 && k <= 128
         && n <= 128;
}

}  // namespace

// Forward: x (rows, hc, wc, k) and w (4, k, n) -> y (rows, hc-1, wc-1, n).
// dtype: 0 = float32, 1 = bfloat16 (x, w and y alike); route as
// valid_call.  Launches on `stream` and returns cudaGetLastError() (0 on
// success), or the error of cudaGetDevice or cudaFuncSetAttribute; what
// the kernels do not take returns cudaErrorInvalidValue without launching.
extern "C" int s2d_conv_forward(const void* x, const void* w, void* y,
                                int rows, int hc, int wc, int k, int n,
                                int route, int dtype, void* stream) {
  Grid g;
  if (k <= 0 || n <= 0 || !valid_call(route, dtype, k, n)
      || !make_grid(g, rows, hc, wc, hc - 1, wc - 1, hc, wc, 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? conv<float>(x, w, y, g, k, n, route, s)
                    : conv<bf16>(x, w, y, g, k, n, route, s);
}

// Input gradient: ct (rows, ho, wo, n) and wflip (4, n, k), wflip[t] =
// w[3 - t]^T, -> dx (rows, ho+1, wo+1, k), on the forward's route.
extern "C" int s2d_conv_dgrad(const void* ct, const void* wflip, void* dx,
                              int rows, int ho, int wo, int k, int n,
                              int route, int dtype, void* stream) {
  Grid g;
  if (k <= 0 || n <= 0 || !valid_call(route, dtype, k, n)
      || !make_grid(g, rows, ho + 2, wo + 2, ho + 1, wo + 1, ho, wo, 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? conv<float>(ct, wflip, dx, g, n, k, route, s)
                    : conv<bf16>(ct, wflip, dx, g, n, k, route, s);
}

// Scratch of the weight gradient: the float32 partials it needs (the same
// arguments as s2d_conv_wgrad), or -1 for what it does not take.
extern "C" long long s2d_conv_wgrad_scratch(int rows, int hc, int wc, int k,
                                            int n, int route, int dtype) {
  Grid g;
  if (k <= 0 || n <= 0 || !valid_call(route, dtype, k, n)
      || !make_grid(g, rows, hc, wc, hc - 1, wc - 1, hc, wc, 0))
    return -1;
  return (long long)wgrad_plan(k, n, route).chunks * 4LL * k * n;
}

// Weight gradient: x (rows, hc, wc, k) and ct (rows, hc-1, wc-1, n) -> out
// (4, k, n) float32, summed over rows and pixels.  `partial` is a float32
// scratch of s2d_conv_wgrad_scratch() elements.
extern "C" int s2d_conv_wgrad(const void* x, const void* ct, void* partial,
                              void* out, int rows, int hc, int wc, int k,
                              int n, int route, int dtype, void* stream) {
  Grid g;
  if (k <= 0 || n <= 0 || !valid_call(route, dtype, k, n)
      || !make_grid(g, rows, hc, wc, hc - 1, wc - 1, hc, wc, 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? wgrad<float>(x, ct, partial, out, g, k, n, route, s)
                    : wgrad<bf16>(x, ct, partial, out, g, k, n, route, s);
}

extern "C" const char* s2d_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

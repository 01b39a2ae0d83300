// K5, the long-window conv1 of family D as a space-to-depth, T-group-folded
// conv over slabs, written for Hopper (sm_90a): forward and weight gradient,
// computing only the band of the folded kernel that can be nonzero.
//
// Replaces the Pallas TPU kernels of cvad_tpu/ops/pallas_s2d.py reached
// through s2d_group_conv (:519): _make_group_fwd (pl.pallas_call at :418)
// and _make_group_wgrad (:468).  (K4, the one-slab core of the same fold,
// stays in s2d_conv.cu.)
//
// What it computes.  x (B, Hc, Wc, S*Kp) channels-last holds S slabs of
// Kp channels (s2d_fold_groups: Kp = pad128(Kc), Kc = (g+2)*4C, the T-group
// of g frames plus its two halo frames, each frame 4C space-to-depth
// channels); w (4, Kp, N) holds the four stride-1 (2, 2) taps of the
// folded kernel (s2d_fold_kernel, padded), N = g*O; the output is
//   y[b, h, w, s*N + n] = sum_{tap=(dh,dw)} sum_k x[b, h+dh, w+dw, s*Kp + k]
//                                                 * w[tap, k, n]
// over (B, Hc-1, Wc-1, S*N).  s2d_fold_kernel makes w block-banded:
// output frame ti = n / O (columns [ti*O, (ti+1)*O)) reads input frames
// ti..ti+2 only, rows [ti*4C, (ti+3)*4C), 12C of Kp; every other entry is
// an exact zero (cvad_tpu documents w as this group-invariant banded
// kernel, pallas_s2d.py:522-523).  So:
//   forward: the sum over k runs over the band of n's frame only; exact for
//     every w that contract admits;
//   weight gradient: dw[tap, k, n] = sum_{b,h,w,s} x[b, h+dh, w+dw, s*Kp+k]
//     * ct[b, h, w, s*N + n] for the band entries; exact zeros elsewhere
//     (s2d_fold_kernel's backward never reads them).
//
// Bound at the main path's shape (B=128, T=64, 64x64 clips, C=3, O=16, g=8:
// x (128, 33, 33, 1024), w (4, 128, 128), y (128, 32, 32, 1024); H100 SXM
// peaks 67 TFLOP/s f32 on the CUDA cores, 989 bf16 on the tensor cores,
// 3.35 TB/s): the band is 4 taps x 36 rows = 144 MACs an output, 38.7 GFLOP
// (the dense fold did 137.4, the conv's own 81 MACs are 21.7);
//   float32:  max(38.7 GFLOP / 67 TFLOP/s = 0.58 ms, 1.11 GB / 3.35 TB/s =
//             0.33 ms) -> 0.58 ms, operations;
//   bfloat16: max(0.55 GB / 3.35 TB/s = 0.165 ms, 38.7 / 989 = 0.039 ms)
//             -> 0.165 ms, bytes.
// The weight gradient does the same work over the same bytes.
//
// Design.  float32 runs on the CUDA cores (f32 FMAs: TF32 would break the
// port's 1e-4 card-against-CPU parity); bfloat16 runs on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 sums) where the shapes allow it,
// and on the CUDA cores otherwise (staged as bf16, half the bytes, widened
// in registers).  The CUDA-core kernels stage every tile in shared memory
// with several loads in flight a thread (`stage`):
// - forward: a block owns one tile of 4 x 32 output pixels of one image, one
//   slab, and F = 2 output frames (a frame group; the groups and slabs of
//   one tile are neighbouring blocks, so the x they share comes from L2).
//   It stages the tile's halo of x (5 x 33 cells) for the (F+2)*4C
//   channels its frames' bands read, and the band of w for its frames (4
//   taps x F x 12C x O), in shared memory, so the 4 taps reuse one staged
//   halo.  A warp owns 8 output channels of one frame for all 128 pixels:
//   lane l the pixel column l of the 4 rows.  For each band row it reads x at 5 rows x 2 columns
//   (the taps' shifts share them) and the taps' 8 weights (a broadcast),
//   and does 4 x 4 x 8 FMAs into 32 accumulators;
// - weight gradient: a block owns a chunk of pixel tiles (the same 4 x 32
//   tiles) of one slab and F frames, and sums over them; a thread owns 4
//   band rows x 8 output channels of one tap and frame, so its partial is
//   band-sized (4 taps x g frames x 12C x O floats a chunk and slab, 18,432
//   at the main shape, not the dense 4 x 128 x 128).  Each tile's halo of x
//   and its (128, F*O) patch of the cotangent are staged in shared memory;
//   pixels outside the image are skipped.  A second pass adds the partials
//   in a fixed order (slab-major, chunk-minor) and writes the whole
//   (4, Kp, N) float32 gradient: the band sums, zeros elsewhere.
// The tensor-core kernels (bf16, O in {16, 32}, C <= 3, g*O <= 128) give a
// block every frame of a tile, so each tile's x is read once, and walk
// (slab, tile) items in a grid-stride loop with cp.async copies of the
// next item's tiles in flight behind the current one's products:
// - forward: M = the tile's 128 pixels, N = O, K = a frame's band as (tap,
//   row), 48C = 3C k-steps of 16; x is copied [cell][channel] and w staged
//   [frame][o][(tap, row)] once a block, both with row strides that put a
//   fragment load's 32 words on 32 banks; a warp owns one frame's 16
//   (m, n) tiles;
// - weight gradient: M = O, N = the slab's channels in 8-aligned n-tiles
//   covering each frame's band (5 a tap at C=3: its 36 rows and 4 past
//   them, whose sums are dropped), K = the tile's pixels; ldmatrix.trans
//   reads both operands from the untransposed copies (the cotangent
//   [pixel][channel], x [cell][channel], a tap a shift of the cells); a
//   warp owns one frame and m-tile, every tap; each of a fixed 132 blocks
//   writes one band-sized partial, which the second pass adds in order.
// No float atomics anywhere: a second call is bit-identical, and so is a
// resumed training run.  All offsets into x, y and the cotangent are
// 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#include "hopper_mma.cuh"

namespace {

constexpr int kTH = 4, kTW = 32;            // a tile: 4 x 32 output pixels
constexpr int kXR = kTH + 1, kXC = kTW + 1;  // its halo of x cells
constexpr int kCells = 169;  // >= kXR * kXC; 4 * 169 = 4 (mod 32) banks
constexpr int kTilePix = kTH * kTW;
constexpr int kMaxThreads = 512;
constexpr int kWgradBlocks = 512;  // blocks the weight gradient aims at

static_assert(kCells >= kXR * kXC, "a channel's halo fits its stride");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 8 consecutive elements of shared memory (16-byte aligned for bf16,
// 32-byte for f32) widened to f32
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 8 f32 values stored as 8 consecutive elements of y (aligned as above)
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// The fold's geometry, as the wrapper gives it.
struct Geo {
  int rows, hc, wc, kp, nslab, g, c4, o;
  int ho, wo, n, kc, r12, og, op;  // derived: Hc-1, Wc-1, g*O, (g+2)*4C,
                                   // 12C, ceil(O/8), 8*og
  int frames, fgroups, tiles_h, tiles_w;  // F, ceil(g/F), tiles of a image
  long long tiles;                        // B * tiles_h * tiles_w
};

// (b, tile row, tile column) of a linear tile index
__device__ __forceinline__ void tile_coords(const Geo& p, long long tile,
                                            int& b, int& h0, int& w0) {
  const int tw = (int)(tile % p.tiles_w);
  const long long rest = tile / p.tiles_w;
  h0 = (int)(rest % p.tiles_h) * kTH;
  b = (int)(rest / p.tiles_h);
  w0 = tw * kTW;
}

// The slab and tile of a work item: the slabs of one tile are neighbouring
// items, so the blocks at work together read and write whole pixels (every
// slab's channels of them).
__device__ __forceinline__ void item_coords(const Geo& p, long long item,
                                            int& s, int& b, int& h0,
                                            int& w0) {
  s = (int)(item % p.nslab);
  tile_coords(p, item / p.nslab, b, h0, w0);
}

// Fill dst for i < total, the block's threads striding over i: item(i, at,
// v) gives the element's place in dst and its value.  Each thread issues
// kStage loads before it stores them, so that that many are in flight.
constexpr int kStage = 8;

template <typename T, typename Item>
__device__ __forceinline__ void stage(T* dst, int total, Item item) {
  for (int base = threadIdx.x; base < total; base += kStage * blockDim.x) {
    T v[kStage];
    int at[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = base + u * blockDim.x;
      at[u] = -1;
      if (i < total) item(i, at[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u)
      if (at[u] >= 0) dst[at[u]] = v[u];
  }
}

// Stage the halo of x for one tile: channels [ch0, ch0 + nch) of slab s
// (zero past the slab's Kc real channels and outside the image), as
// xs[c * kCells + r * kXC + col].  Consecutive threads read consecutive
// channels of one cell.
template <typename T>
__device__ __forceinline__ void stage_x(T* xs, const T* __restrict__ x,
                                        const Geo& p, int b, int h0, int w0,
                                        int s, int ch0, int nch) {
  const long long ctot = (long long)p.nslab * p.kp;
  const long long coff = (long long)s * p.kp + ch0;
  const long long img = (long long)b * p.hc;
  const Div by_ch(nch);
  stage(xs, nch * kXR * kXC, [&](int i, int& at, T& v) {
    const int cell = by_ch.div(i), c = by_ch.mod(i, cell);
    const int hh = h0 + cell / kXC, ww = w0 + cell % kXC;
    v = (hh < p.hc && ww < p.wc && ch0 + c < p.kc)
            ? x[((img + hh) * p.wc + ww) * ctot + coff + c]
            : T(0.f);
    at = c * kCells + cell;  // cell = r * kXC + col
  });
}

// ---------------------------------------------------------------------------
// forward: block = frame group + fgroups * item (item_coords: the slab and
// tile); warp = (frame, 8 output channels); lane = pixel column
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
s2d_group_forward_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         T* __restrict__ y, Geo p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int F = p.frames;
  const int nch = (F + 2) * p.c4;
  T* ws = reinterpret_cast<T*>(smem_raw);  // [tap][f][r][op], 16-B aligned
  T* xs = ws + 4 * F * p.r12 * p.op;       // [c][kCells]

  const int fg = (int)(blockIdx.x % p.fgroups);
  const int f0 = fg * F;
  int s, b, h0, w0;
  item_coords(p, blockIdx.x / p.fgroups, s, b, h0, w0);

  // the band of w for this block's frames, zero past O and past g
  {
    const Div by_op(p.op), by_r(p.r12), by_f(F);
    stage(ws, 4 * F * p.r12 * p.op, [&](int i, int& at, T& v) {
      const int rest = by_op.div(i), oo = by_op.mod(i, rest);
      const int rest2 = by_r.div(rest), r = by_r.mod(rest, rest2);
      const int tap = by_f.div(rest2), ti = f0 + by_f.mod(rest2, tap);
      v = (oo < p.o && ti < p.g)
              ? w[((long long)tap * p.kp + ti * p.c4 + r) * p.n + ti * p.o
                  + oo]
              : T(0.f);
      at = i;
    });
  }
  stage_x(xs, x, p, b, h0, w0, s, f0 * p.c4, nch);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = warp / p.og, cg = warp % p.og;
  const int ti = f0 + f;
  if (ti >= p.g) return;  // a last frame group with fewer frames

  float acc[kTH][8];
#pragma unroll
  for (int i = 0; i < kTH; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const T* xf = xs + f * p.c4 * kCells + lane;
  const T* wf = ws + f * p.r12 * p.op + cg * 8;
  const int wtap = F * p.r12 * p.op;  // stride of one tap in ws
#pragma unroll 2
  for (int r = 0; r < p.r12; ++r) {
    const T* xr = xf + r * kCells;
    float xv[kXR][2];
#pragma unroll
    for (int rr = 0; rr < kXR; ++rr) {
      xv[rr][0] = to_f32(xr[rr * kXC]);
      xv[rr][1] = to_f32(xr[rr * kXC + 1]);
    }
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int dh = tap >> 1, dw = tap & 1;
      float wv[8];
      load8(wf + tap * wtap + r * p.op, wv);
#pragma unroll
      for (int i = 0; i < kTH; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(xv[i + dh][dw], wv[j], acc[i][j]);
    }
  }

  const int ww = w0 + lane;
  if (ww >= p.wo) return;
  const long long ytot = (long long)p.nslab * p.n;
  const int c0 = cg * 8;
  const long long coff = (long long)s * p.n + ti * p.o + c0;
  const bool vec = (p.o & 7) == 0;  // 8 channels, aligned: one vector store
#pragma unroll
  for (int i = 0; i < kTH; ++i) {
    const int hh = h0 + i;
    if (hh >= p.ho) break;
    T* out = y + (((long long)b * p.ho + hh) * p.wo + ww) * ytot + coff;
    if (vec) {
      store8(out, acc[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c0 + j < p.o) store_f32(out + j, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// weight gradient, pass 1: block (frame group + fgroups * chunk, slab) sums
// its chunk of tiles into partial[s][chunk][tap][ti][r][o]
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
s2d_group_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ ct,
                       float* __restrict__ partial, Geo p, int chunks,
                       long long chunk_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int F = p.frames;
  const int nch = (F + 2) * p.c4;
  const int cw = F * p.op;                  // staged cotangent columns
  T* cs = reinterpret_cast<T*>(smem_raw);  // [pixel][f][op], 16-B aligned
  T* xs = cs + kTilePix * cw;              // [c][kCells]

  const int fg = (int)(blockIdx.x % p.fgroups);
  const int chunk = (int)(blockIdx.x / p.fgroups);
  const int s = blockIdx.y;
  const int f0 = fg * F;
  const long long t0 = chunk * chunk_tiles;
  const long long t1 =
      t0 + chunk_tiles < p.tiles ? t0 + chunk_tiles : p.tiles;
  const long long ctot = (long long)p.nslab * p.n;
  const Div by_cw(cw), by_op(p.op);

  // items: (f, cg, tap, rg) with rg a group of 4 band rows, fastest
  const int rgs = p.r12 / 4;
  const int items = F * p.og * 4 * rgs;
  const int passes = (items + blockDim.x - 1) / blockDim.x;
  for (int pass = 0; pass < passes; ++pass) {
    const int item = pass * blockDim.x + threadIdx.x;
    const bool mine = item < items;
    const int rg = item % rgs, rest = item / rgs;
    const int tap = rest % 4, rest2 = rest / 4;
    const int cg = rest2 % p.og, f = rest2 / p.og;
    const int ti = f0 + f;
    const bool live = mine && ti < p.g;
    const int dh = tap >> 1, dw = tap & 1;

    float acc[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[q][j] = 0.f;

    for (long long tile = t0; tile < t1; ++tile) {
      int b, h0, w0;
      tile_coords(p, tile, b, h0, w0);
      __syncthreads();  // the previous tile's xs and cs are read
      stage_x(xs, x, p, b, h0, w0, s, f0 * p.c4, nch);
      stage(cs, kTilePix * cw, [&](int i, int& at, T& v) {
        const int pix = by_cw.div(i), col = by_cw.mod(i, pix);
        const int ff = by_op.div(col), oo = by_op.mod(col, ff);
        const int hh = h0 + pix / kTW, ww = w0 + pix % kTW;
        v = (oo < p.o && f0 + ff < p.g && hh < p.ho && ww < p.wo)
                ? ct[(((long long)b * p.ho + hh) * p.wo + ww) * ctot
                     + (long long)s * p.n + (f0 + ff) * p.o + oo]
                : T(0.f);
        at = i;
      });
      __syncthreads();
      if (!live) continue;
      const int rows = p.ho - h0 < kTH ? p.ho - h0 : kTH;
      const int cols = p.wo - w0 < kTW ? p.wo - w0 : kTW;
      const T* xq = xs + (f * p.c4 + rg * 4) * kCells + dh * kXC + dw;
      const T* cq = cs + f * p.op + cg * 8;
      for (int i = 0; i < rows; ++i) {
#pragma unroll 4
        for (int l = 0; l < cols; ++l) {
          const int cell = i * kXC + l;
          float xv[4], cv[8];
#pragma unroll
          for (int q = 0; q < 4; ++q) xv[q] = to_f32(xq[q * kCells + cell]);
          load8(cq + (i * kTW + l) * cw, cv);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[q][j] = fmaf(xv[q], cv[j], acc[q][j]);
        }
      }
    }

    if (live) {
      const long long band = 4LL * p.g * p.r12 * p.o;
      float* out = partial + ((long long)s * chunks + chunk) * band
                   + (((long long)tap * p.g + ti) * p.r12 + rg * 4) * p.o;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (cg * 8 + j < p.o) out[q * p.o + cg * 8 + j] = acc[q][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores (mma.sync m16n8k16, bf16 in, f32 sums), for
// O in {16, 32} and C <= 3.  A block takes every frame of a tile, so each
// tile's x is read once; blocks walk (slab, tile) items in a grid-stride
// loop, and cp.async copies the next item's tiles (kStages stages)
// behind the current one's products.
// ---------------------------------------------------------------------------

constexpr int kTcMaxKs = 9;      // forward k-steps: 3C for C <= 3
constexpr int kTcMaxNtt = 5;     // wgrad n-tiles a tap and frame: C <= 3
// the weight gradient's blocks: a constant, so that the partials' sum has
// one order on every card; an H100 SXM's SM count, one block an SM (its
// shared memory allows no second), one wave
constexpr int kTcWgradBlocks = 132;
constexpr int kStages = 2;  // items whose tiles a block holds: 1 in flight

// a row stride in bf16 elements for shared tiles read as fragments: even,
// and half of it 4 (mod 8) words, so that a fragment load's 8 rows x 4
// column pairs fall on 32 distinct banks
__host__ __device__ constexpr int tc_stride(int n) {
  int s = (n + 1) / 2 * 2;
  while ((s / 2) % 8 != 4) s += 2;
  return s;
}

// wait until at most kStages - 1 groups are pending: with a group
// committed an item, ahead by kStages - 1, the current item's has landed
__device__ __forceinline__ void cp_async_wait_current() {
  cp_async_wait<kStages - 1>();
}

// Copy the halo of x of item (slab, tile) -- the first ceil(Kc/8) 16-byte
// chunks of each cell's slab channels, zeros outside the image -- into
// xs[cell][chp].
__device__ __forceinline__ void copy_halo(bf16* xs, const bf16* __restrict__ x,
                                          const Geo& p, long long item,
                                          int chp, const Div& by_nck) {
  int s, b, h0, w0;
  item_coords(p, item, s, b, h0, w0);
  const long long ctot = (long long)p.nslab * p.kp;
  const long long img = (long long)b * p.hc;
  const int nck = (int)by_nck.d;
  for (int i = threadIdx.x; i < kXR * kXC * nck; i += blockDim.x) {
    const int cell = by_nck.div(i), j = by_nck.mod(i, cell);
    const int hh = h0 + cell / kXC, ww = w0 + cell % kXC;
    const bool ok = hh < p.hc && ww < p.wc;
    const bf16* src =
        ok ? x + ((img + hh) * p.wc + ww) * ctot + (long long)s * p.kp + 8 * j
           : x;
    cp_async16(xs + cell * chp + 8 * j, src, ok);
  }
}

// Forward: M = a tile's 128 pixels (8 m-tiles of 16: half a tile row each),
// N = O output channels, K = a frame's band as (tap, row), 48C = 3C k-steps
// of 16 (a k pair never straddles a tap: 12C is even).  x is staged
// [cell][channel], so a pair of band rows is one 32-bit load; w
// [frame][o][(tap, row)].  g*O/16 <= 8 warps: warp w owns frame w / (O/16)
// and 16 of its (m, n) tiles (O=16: 8 m-tiles x 2 n-tiles; O=32: 4 x 4).
template <int NT>
__global__ void __launch_bounds__(256)
s2d_group_forward_tc_kernel(const bf16* __restrict__ x,
                            const bf16* __restrict__ w, bf16* __restrict__ y,
                            Geo p, long long items) {
  constexpr int kMw = 16 / NT;  // m-tiles a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kf = 4 * p.r12, kfp = tc_stride(kf);
  const int chp = tc_row(p.kc);
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);  // [g][o][kfp]
  bf16* xs = ws + p.g * p.o * kfp;               // kStages x [cell][chp]
  const int xstage = kXR * kXC * chp;
  const Div by_nck((p.kc + 7) / 8);

  if (blockIdx.x >= items) return;
  for (int st = 0; st < kStages - 1; ++st) {  // the first items' halos
    const long long item = blockIdx.x + (long long)st * gridDim.x;
    if (item < items) copy_halo(xs + st * xstage, x, p, item, chp, by_nck);
    cp_async_commit();
  }
  {
    const Div by_o(p.o), by_kf(kf), by_r(p.r12);
    stage(ws, p.g * p.o * kf, [&](int i, int& at, bf16& v) {
      const int rest = by_o.div(i), oo = by_o.mod(i, rest);
      const int ti = by_kf.div(rest), k = by_kf.mod(rest, ti);
      const int tap = by_r.div(k), r = by_r.mod(k, tap);
      v = w[((long long)tap * p.kp + ti * p.c4 + r) * p.n + ti * p.o + oo];
      at = (ti * p.o + oo) * kfp + k;
    });
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int mh = p.o / 16;
  const int f = warp / mh, mt0 = (warp % mh) * kMw;
  const bf16* wf = ws + (f * p.o + gq) * kfp;
  const int ksteps = kf / 16;
  int olo[kTcMaxKs], ohi[kTcMaxKs];  // (tap shift) * chp + row, by k-step
#pragma unroll
  for (int ks = 0; ks < kTcMaxKs; ++ks) {
    const int klo = ks * 16 + 2 * tq, khi = klo + 8;
    const int tlo = klo / p.r12, thi = khi / p.r12;
    olo[ks] = ((tlo >> 1) * kXC + (tlo & 1)) * chp + f * p.c4
              + klo % p.r12;
    ohi[ks] = ((thi >> 1) * kXC + (thi & 1)) * chp + f * p.c4
              + khi % p.r12;
  }
  int cell[kMw];  // the lane's pixel (row gq) of each m-tile; row gq+8 is +8
#pragma unroll
  for (int mi = 0; mi < kMw; ++mi) {
    const int pm = (mt0 + mi) * 16 + gq;
    cell[mi] = ((pm / kTW) * kXC + pm % kTW) * chp;
  }
  const long long ytot = (long long)p.nslab * p.n;

  int it = 0;
  for (long long item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const bf16* cur = xs + (it % kStages) * xstage;
    const long long ahead = item + (long long)(kStages - 1) * gridDim.x;
    if (ahead < items)  // into the stage the previous item read
      copy_halo(xs + ((it + kStages - 1) % kStages) * xstage, x, p, ahead,
                chp, by_nck);
    cp_async_commit();
    cp_async_wait_current();
    __syncthreads();  // this item's halo (and, first, w) are in place

    float acc[kMw][NT][4];
#pragma unroll
    for (int mi = 0; mi < kMw; ++mi)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kTcMaxKs; ++ks) {
      if (ks < ksteps) {
        const int klo = ks * 16 + 2 * tq;
        uint32_t bfr[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          bfr[nt][0] = lds32(wf + nt * 8 * kfp + klo);
          bfr[nt][1] = lds32(wf + nt * 8 * kfp + klo + 8);
        }
#pragma unroll
        for (int mi = 0; mi < kMw; ++mi) {
          uint32_t a[4];
          a[0] = lds32(cur + cell[mi] + olo[ks]);
          a[1] = lds32(cur + cell[mi] + 8 * chp + olo[ks]);
          a[2] = lds32(cur + cell[mi] + ohi[ks]);
          a[3] = lds32(cur + cell[mi] + 8 * chp + ohi[ks]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mi][nt], a, bfr[nt]);
        }
      }
    }

    int s, b, h0, w0;
    item_coords(p, item, s, b, h0, w0);
    const long long coff = (long long)s * p.n + f * p.o + 2 * tq;
#pragma unroll
    for (int mi = 0; mi < kMw; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pm = (mt0 + mi) * 16 + gq + 8 * half;
        const int hh = h0 + pm / kTW, ww = w0 + pm % kTW;
        if (hh >= p.ho || ww >= p.wo) continue;
        bf16* out =
            y + (((long long)b * p.ho + hh) * p.wo + ww) * ytot + coff;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          *reinterpret_cast<__nv_bfloat162*>(out + nt * 8) =
              __floats2bfloat162_rn(acc[mi][nt][2 * half],
                                    acc[mi][nt][2 * half + 1]);
      }
    }
    __syncthreads();  // `cur` is read before the next item's copy lands
  }
}

// Copy the cotangent of item (slab, tile): each pixel's N = g*O channels of
// the slab, zeros outside the image, into cs[pixel][cwp].
__device__ __forceinline__ void copy_ct(bf16* cs, const bf16* __restrict__ ct,
                                        const Geo& p, long long item, int cwp,
                                        const Div& by_nck) {
  int s, b, h0, w0;
  item_coords(p, item, s, b, h0, w0);
  const long long ctot = (long long)p.nslab * p.n;
  const int nck = (int)by_nck.d;
  for (int i = threadIdx.x; i < kTilePix * nck; i += blockDim.x) {
    const int pix = by_nck.div(i), j = by_nck.mod(i, pix);
    const int hh = h0 + pix / kTW, ww = w0 + pix % kTW;
    const bool ok = hh < p.ho && ww < p.wo;
    const bf16* src =
        ok ? ct + (((long long)b * p.ho + hh) * p.wo + ww) * ctot
                 + (long long)s * p.n + 8 * j
           : ct;
    cp_async16(cs + pix * cwp + 8 * j, src, ok);
  }
}

// Weight gradient: M = O output channels (MT m-tiles of 16), N = slab
// channels in 8-aligned n-tiles covering each frame's band (ceil((12C+4)/8)
// a tap: 5 at C=3, the 36 rows and 4 past them), K = the tile's 128 pixels
// (8 k-steps).  Both operands come from the untransposed copies by
// ldmatrix.trans: the cotangent [pixel][frame, o], x [cell][channel], a tap
// being a shift of the cells.  g*MT <= 8 warps: warp w owns frame w / MT and
// m-tile w % MT, every tap and n-tile of that frame's band; it sums over
// the block's items, then writes its band rows into the block's partial.
template <int MT>
__global__ void __launch_bounds__(256)
s2d_group_wgrad_tc_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ ct,
                          float* __restrict__ partial, Geo p,
                          long long items) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chp = tc_row(p.kc), cwp = tc_row(p.n);
  const int xstage = kXR * kXC * chp, cstage = kTilePix * cwp;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // kStages x [cell][chp]
  bf16* cs = xs + kStages * xstage;              // kStages x [pixel][cwp]
  const Div by_xck((p.kc + 7) / 8), by_cck(p.n / 8);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int f = warp / MT, mt = warp % MT;
  const int k_lo = (f * p.c4) / 8 * 8;
  const int ntt = ((f * p.c4 + p.r12 + 7) / 8 * 8 - k_lo) / 8;
  // ldmatrix rows: lane 8j + i; the A matrices j: pixels (j >> 1) * 8 + i,
  // channels f*O + mt*16 + (j & 1) * 8; the B matrices j: pixels
  // (j & 1) * 8 + i, n-tile (j >> 1) of a pair
  const int lj = lane >> 3, li = lane & 7;
  const int a_off = ((lj >> 1) * 8 + li) * cwp + f * p.o + mt * 16
                    + (lj & 1) * 8;
  const int b_pix = (lj & 1) * 8 + li;  // + 16 ks: a pixel of the tile
  const int b_col = k_lo + (lj >> 1) * 8;

  float acc[4][kTcMaxNtt][4];
#pragma unroll
  for (int tap = 0; tap < 4; ++tap)
#pragma unroll
    for (int j = 0; j < kTcMaxNtt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tap][j][e] = 0.f;

  for (int st = 0; st < kStages - 1; ++st) {  // the first items' tiles
    const long long item = blockIdx.x + (long long)st * gridDim.x;
    if (item < items) {
      copy_halo(xs + st * xstage, x, p, item, chp, by_xck);
      copy_ct(cs + st * cstage, ct, p, item, cwp, by_cck);
    }
    cp_async_commit();
  }
  int it = 0;
  for (long long item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const bf16* xc = xs + (it % kStages) * xstage;
    const bf16* cc = cs + (it % kStages) * cstage;
    const long long ahead = item + (long long)(kStages - 1) * gridDim.x;
    if (ahead < items) {  // into the stage the previous item read
      const int st = (it + kStages - 1) % kStages;
      copy_halo(xs + st * xstage, x, p, ahead, chp, by_xck);
      copy_ct(cs + st * cstage, ct, p, ahead, cwp, by_cck);
    }
    cp_async_commit();
    cp_async_wait_current();
    __syncthreads();  // this item's tiles are in place

#pragma unroll 2
    for (int ks = 0; ks < kTilePix / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4_trans(a, cc + ks * 16 * cwp + a_off);
      const int pix = ks * 16 + b_pix;
      const int cell = (pix / kTW) * kXC + pix % kTW;
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        const bf16* bp = xc + (cell + (tap >> 1) * kXC + (tap & 1)) * chp
                         + b_col;
#pragma unroll
        for (int j = 0; j < kTcMaxNtt; j += 2) {
          if (j < ntt) {
            // n-tiles j and j+1 by one x4 load; a last odd n-tile loads
            // the pair (j-1, j) and keeps the second (ntt >= 2)
            uint32_t bq[4];
            const bool pair = j + 1 < ntt;
            ldsm_x4_trans(bq, bp + (pair ? j : j - 1) * 8);
            if (pair) {
              mma_bf16(acc[tap][j], a, bq);
              if (j + 1 < kTcMaxNtt) mma_bf16(acc[tap][j + 1], a, bq + 2);
            } else {
              mma_bf16(acc[tap][j], a, bq + 2);
            }
          }
        }
      }
    }
    __syncthreads();  // the tiles are read before the next copies land
  }

  const long long band = 4LL * p.g * p.r12 * p.o;
  float* part = partial + (long long)blockIdx.x * band;
#pragma unroll
  for (int tap = 0; tap < 4; ++tap)
#pragma unroll
    for (int j = 0; j < kTcMaxNtt; ++j) {
      if (j >= ntt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int oo = mt * 16 + gq + 8 * (e >> 1);
        const int r = k_lo + 8 * j + 2 * tq + (e & 1) - f * p.c4;
        if (r >= 0 && r < p.r12)
          part[(((long long)tap * p.g + f) * p.r12 + r) * p.o + oo] =
              acc[tap][j][e];
      }
    }
}

// weight gradient, pass 2: out[tap][k][n] = the sum over slabs and chunks,
// in that order, of the band entry, or 0 off the band
__global__ void __launch_bounds__(256)
s2d_group_wgrad_reduce_kernel(const float* __restrict__ partial,
                              float* __restrict__ out, Geo p, int parts) {
  const long long total = 4LL * p.kp * p.n;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int n = (int)(i % p.n);
  const int k = (int)((i / p.n) % p.kp);
  const int tap = (int)(i / ((long long)p.kp * p.n));
  const int ti = n / p.o, oo = n % p.o;
  const int r = k - ti * p.c4;
  float sum = 0.f;
  if (r >= 0 && r < p.r12) {
    const long long band = 4LL * p.g * p.r12 * p.o;
    const long long e = (((long long)tap * p.g + ti) * p.r12 + r) * p.o + oo;
    for (int c = 0; c < parts; ++c) sum += partial[c * band + e];
  }
  out[i] = sum;
}

// The geometry of a call, or false for shapes the kernels do not take.
bool make_geo(Geo& p, int rows, int hc, int wc, int kp, int nslab, int g,
              int cin, int cout, int elem) {
  if (rows <= 0 || hc < 2 || wc < 2 || kp <= 0 || nslab <= 0 || g <= 0
      || cin <= 0 || cout <= 0 || nslab > 65535)
    return false;
  p.rows = rows; p.hc = hc; p.wc = wc; p.kp = kp; p.nslab = nslab; p.g = g;
  p.c4 = 4 * cin; p.o = cout;
  p.ho = hc - 1; p.wo = wc - 1; p.n = g * cout; p.kc = (g + 2) * p.c4;
  p.r12 = 3 * p.c4; p.og = (cout + 7) / 8; p.op = 8 * p.og;
  if (p.kc > kp || (long long)g * cout > INT_MAX / 4) return false;
  // two frames a block where the threads and shared memory allow
  const auto smem = [&](int f) {
    const long long fwd = (4LL * f * p.r12 * p.op
                           + (long long)(f + 2) * p.c4 * kCells) * elem;
    const long long wg = ((long long)kTilePix * f * p.op
                          + (long long)(f + 2) * p.c4 * kCells) * elem;
    return fwd > wg ? fwd : wg;
  };
  p.frames = (g >= 2 && 2 * p.og * 32 <= kMaxThreads && smem(2) <= kMaxSmem)
                 ? 2 : 1;
  if (p.og * 32 > kMaxThreads || smem(p.frames) > kMaxSmem) return false;
  p.fgroups = (g + p.frames - 1) / p.frames;
  p.tiles_h = (p.ho + kTH - 1) / kTH;
  p.tiles_w = (p.wo + kTW - 1) / kTW;
  p.tiles = (long long)rows * p.tiles_h * p.tiles_w;
  return p.tiles * p.nslab * p.fgroups <= INT_MAX;
}

size_t forward_smem(const Geo& p, int elem) {
  return ((size_t)4 * p.frames * p.r12 * p.op
          + (size_t)(p.frames + 2) * p.c4 * kCells) * elem;
}

size_t wgrad_smem(const Geo& p, int elem) {
  return ((size_t)kTilePix * p.frames * p.op
          + (size_t)(p.frames + 2) * p.c4 * kCells) * elem;
}

// chunks of tiles a slab: aim at kWgradBlocks blocks in all, no chunk empty
void wgrad_chunks(const Geo& p, int& chunks, long long& chunk_tiles) {
  long long want = kWgradBlocks / ((long long)p.nslab * p.fgroups);
  if (want < 1) want = 1;
  if (want > p.tiles) want = p.tiles;
  chunk_tiles = (p.tiles + want - 1) / want;
  chunks = (int)((p.tiles + chunk_tiles - 1) / chunk_tiles);
}

// whether bf16 runs on the tensor cores: O in {16, 32} (whole m- and
// n-tiles), C <= 3 (the kernels' register tiles), g*O <= 128 (the fold's
// own rule, fold_group_size: at most 8 warps, 255 registers a thread)
size_t forward_tc_smem(const Geo& p) {
  return ((size_t)p.g * p.o * tc_stride(4 * p.r12)
          + kStages * (size_t)kXR * kXC * tc_row(p.kc)) * sizeof(bf16);
}

size_t wgrad_tc_smem(const Geo& p) {
  return (kStages * (size_t)kXR * kXC * tc_row(p.kc)
          + kStages * (size_t)kTilePix * tc_row(p.n)) * sizeof(bf16);
}

bool tensor_cores(const Geo& p) {
  return (p.o == 16 || p.o == 32) && p.c4 <= 12 && p.g * p.o <= 128
         && forward_tc_smem(p) <= kMaxSmem && wgrad_tc_smem(p) <= kMaxSmem;
}

template <int NT>
int forward_tc(const void* x, const void* w, void* y, const Geo& p,
               cudaStream_t stream) {
  static SmemSet set;
  const size_t smem = forward_tc_smem(p);
  const int threads = 32 * p.g * p.o / 16;
  cudaError_t err = allow_smem(set, s2d_group_forward_tc_kernel<NT>, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = resident_blocks(s2d_group_forward_tc_kernel<NT>, threads, smem,
                          blocks);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)p.nslab * p.tiles;
  if (blocks > items) blocks = (int)items;
  s2d_group_forward_tc_kernel<NT><<<blocks, threads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(y), p, items);
  return (int)cudaGetLastError();
}

template <int MT>
cudaError_t wgrad_tc(const void* x, const void* ct, void* partial,
                     const Geo& p, cudaStream_t stream) {
  static SmemSet set;
  const size_t smem = wgrad_tc_smem(p);
  cudaError_t err = allow_smem(set, s2d_group_wgrad_tc_kernel<MT>, smem);
  if (err != cudaSuccess) return err;
  s2d_group_wgrad_tc_kernel<MT>
      <<<kTcWgradBlocks, 32 * p.g * MT, smem, stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(ct),
          static_cast<float*>(partial), p, (long long)p.nslab * p.tiles);
  return cudaGetLastError();
}

template <typename T>
int forward(const void* x, const void* w, void* y, const Geo& p,
            cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (tensor_cores(p))
      return p.o == 16 ? forward_tc<2>(x, w, y, p, stream)
                       : forward_tc<4>(x, w, y, p, stream);
  }
  static SmemSet set;
  const size_t smem = forward_smem(p, sizeof(T));
  cudaError_t err = allow_smem(set, s2d_group_forward_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)(p.tiles * p.nslab * p.fgroups);
  s2d_group_forward_kernel<T><<<grid, 32 * p.frames * p.og, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      p);
  return (int)cudaGetLastError();
}

// the partials of the weight gradient: how many, each band-sized
int wgrad_parts(const Geo& p, int dtype) {
  if (dtype == 1 && tensor_cores(p)) return kTcWgradBlocks;
  int chunks;
  long long chunk_tiles;
  wgrad_chunks(p, chunks, chunk_tiles);
  return p.nslab * chunks;
}

template <typename T>
int wgrad(const void* x, const void* ct, void* partial, void* out,
          const Geo& p, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  bool done = false;
  if constexpr (sizeof(T) == 2) {
    if (tensor_cores(p)) {
      err = p.o == 16 ? wgrad_tc<1>(x, ct, partial, p, stream)
                      : wgrad_tc<2>(x, ct, partial, p, stream);
      done = true;
    }
  }
  if (!done) {
    static SmemSet set;
    const size_t smem = wgrad_smem(p, sizeof(T));
    err = allow_smem(set, s2d_group_wgrad_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    int chunks;
    long long chunk_tiles;
    wgrad_chunks(p, chunks, chunk_tiles);
    const int items = p.frames * p.og * 4 * (p.r12 / 4);
    int threads = (items + 31) / 32 * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    const dim3 grid((unsigned)(chunks * p.fgroups), p.nslab);
    s2d_group_wgrad_kernel<T><<<grid, threads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(ct),
        static_cast<float*>(partial), p, chunks, chunk_tiles);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  const long long total = 4LL * p.kp * p.n;
  s2d_group_wgrad_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                                  stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), p,
      wgrad_parts(p, sizeof(T) == 2 ? 1 : 0));
  return (int)cudaGetLastError();
}

}  // namespace

// Forward: x (rows, hc, wc, nslab*kp) and w (4, kp, g*cout) -> y (rows,
// hc-1, wc-1, nslab*g*cout), reading w only inside its band.  dtype: 0 =
// float32, 1 = bfloat16 (x, w and y alike).  Launches on `stream` and
// returns cudaGetLastError() (0 on success), or the error of cudaGetDevice
// or cudaFuncSetAttribute; shapes the kernels do not take return
// cudaErrorInvalidValue without launching.
extern "C" int s2d_group_conv_forward(const void* x, const void* w, void* y,
                                      int rows, int hc, int wc, int kp,
                                      int nslab, int g, int cin, int cout,
                                      int dtype, void* stream) {
  Geo p;
  const int elem = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1)
      || !make_geo(p, rows, hc, wc, kp, nslab, g, cin, cout, elem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? forward<float>(x, w, y, p, s)
                    : forward<__nv_bfloat16>(x, w, y, p, s);
}

// Scratch of the weight gradient: the float32 partials it needs (call with
// the same shapes as s2d_group_conv_wgrad), or -1 for shapes it does not
// take.
extern "C" long long s2d_group_conv_wgrad_scratch(int rows, int hc, int wc,
                                                  int kp, int nslab, int g,
                                                  int cin, int cout,
                                                  int dtype) {
  Geo p;
  if (!make_geo(p, rows, hc, wc, kp, nslab, g, cin, cout,
                dtype == 1 ? 2 : 4))
    return -1;
  return (long long)wgrad_parts(p, dtype) * 4LL * g * p.r12 * cout;
}

// Weight gradient: x (rows, hc, wc, nslab*kp) and ct (rows, hc-1, wc-1,
// nslab*g*cout) -> out (4, kp, g*cout) float32: the band entries summed over
// rows, pixels and slabs, exact zeros elsewhere.  `partial` is a float32
// scratch of s2d_group_conv_wgrad_scratch() elements.
extern "C" int s2d_group_conv_wgrad(const void* x, const void* ct,
                                    void* partial, void* out, int rows,
                                    int hc, int wc, int kp, int nslab, int g,
                                    int cin, int cout, int dtype,
                                    void* stream) {
  Geo p;
  const int elem = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1)
      || !make_geo(p, rows, hc, wc, kp, nslab, g, cin, cout, elem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? wgrad<float>(x, ct, partial, out, p, s)
                    : wgrad<__nv_bfloat16>(x, ct, partial, out, p, s);
}

extern "C" const char* s2d_group_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

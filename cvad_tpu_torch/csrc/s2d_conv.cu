// Space-to-depth, T-group-folded conv1 of family D for long windows (K4),
// written for Hopper (sm_90a): forward, input gradient, weight gradient.
//
// Replaces the Pallas TPU kernels of cvad_tpu/ops/pallas_s2d.py reached
// through s2d_fold_matmul (:319): _make_fwd (pl.pallas_call at :177),
// _make_dgrad (:223), _make_wgrad (:271).  K5 (s2d_group_conv, :519) runs
// its own band kernels (s2d_group_conv.cu); the dense kernels here still
// take its slabs (the case S > 1 below), which K5 computed with before.
// Both compute four stride-1 (2, 2) taps over 2x2 pixel cells, each an
// (M, K) x (K, N) product with f32 accumulation:
//   y[r, h, w, s*N + j] = sum_{dh, dw, k} x[r, h+dh, w+dw, s*Ks + k]
//                                         * wt[2*dh+dw, k, j]
// over channels-last x (R, Hc, Wc, S*Ks) -> y (R, Hc-1, Wc-1, S*N).  K4 is
// the case of one slab (S = 1) over R = B*n group rows; K5 the case of
// S = n slabs, each zero-padded to Ks = K = 128 channels, over R = B rows,
// whose t-major output is conv1's (B, H/2, W/2, T*16).  The pad channels
// are zero in x and in wt, so computing over them gives the same numbers.
// The input gradient (K4 only) is the full correlation of the cotangent
// with the flipped taps: dx[r, h, w, k] = sum_{dh, dw, j}
// ct[r, h-dh, w-dw, j] * wt[2*dh+dw, k, j], zero outside ct.  The weight
// gradient sums x's tap window times ct over rows, pixels and slabs.
//
// Bound at the main path's K5 shape (B=128, T=64, 64x64 clips: x (128, 33,
// 33, 1024), wt (4, 128, 128), y (128, 32, 32, 1024); H100 SXM peaks):
//   float32:  max(137.4 GFLOP / 67 TFLOP/s = 2.05 ms,
//                 1.11 GB / 3.35 TB/s = 0.33 ms)  -> 2.05 ms, operations;
//   bfloat16: max(0.55 GB / 3.35 TB/s = 0.165 ms,
//                 137.4 GFLOP / 989 TFLOP/s = 0.139 ms) -> 0.165 ms, bytes.
// The weight gradient does the same work over the same bytes.  The fold
// makes these (g+2)/3 * 16/9 * 128/120 ~ 6.3x the unfolded conv's useful
// MACs (21.7 GFLOP): the banded zeros fill the TPU's 128-wide tiles.
//
// Design: a simple tiled GEMM on the CUDA cores, in float32 for both dtypes
// (bf16 values are widened when staged).  Forward and input gradient share
// one kernel: a block of 128 threads owns 64 output pixels x 128 output
// channels of one slab and loops over the 4 taps and the reduction in steps
// of 32; the tiles are staged in shared memory, loads coalesced along the
// channels (the contiguous axis of both operands), and each thread keeps an
// 8x8 register tile (pixels ty + 8i, channels tx + 16j, so that its shared
// reads are broadcast or conflict-free).  The weight gradient runs the same
// register tiling over a (64 k) x (128 j) tile of one tap, reducing over a
// chunk of 4,096 pixels of one slab into its own slot of a float32 partial
// buffer; a second pass adds the partials in a fixed order.  No float
// atomics anywhere: a second call gives bit-identical results, and so does
// a resumed training run.  All offsets are 64-bit.  What this leaves on the
// table (the tensor cores through wgmma, TMA loads, double buffering,
// skipping the zero pad and the banded zeros) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 128;           // 16 (tx) x 8 (ty)
constexpr int kBM = 64, kBN = 128, kBK = 32;   // forward / dgrad tile
constexpr int kWK = 64, kWN = 128, kWR = 32;   // weight-gradient tile
constexpr int kTile = 8;                // 8 x 8 outputs per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// One tap-accumulated product.  Output pixels (rows, oh, ow), output
// channels `cols` per slab; operand A is channels-last (rows, ah, aw,
// a_ctot), slab s reading its channels from s * a_slab; tap (dh, dw) reads A
// at (h + shift*dh, w + shift*dw), zero outside; the weight element of
// (tap, reduction index q, output channel c) is at tap*w_tap + q*w_rs +
// c*w_cs.
struct GemmArgs {
  int rows, oh, ow, ah, aw, a_ctot, a_slab, shift, red, cols, w_rs, w_cs,
      y_ctot;
  long long w_tap;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
s2d_gemm_kernel(const T* __restrict__ a, const T* __restrict__ w,
                T* __restrict__ y, GemmArgs p) {
  __shared__ float as[kBK][kBM + 1];  // +1: the loaders' column writes
  __shared__ float bs[kBK][kBN];
  __shared__ long long pix_base[kBM];  // r*ah*aw, or -1 past the end
  __shared__ int pix_h[kBM], pix_w[kBM];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long m_total = (long long)p.rows * p.oh * p.ow;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int s = blockIdx.z;
  const long long a_coff = (long long)s * p.a_slab;

  if (tid < kBM) {
    const long long m = m0 + tid;
    long long base = -1;
    int hh = 0, ww = 0;
    if (m < m_total) {
      ww = (int)(m % p.ow);
      const long long rest = m / p.ow;
      hh = (int)(rest % p.oh);
      base = (rest / p.oh) * p.ah * p.aw;
    }
    pix_base[tid] = base;
    pix_h[tid] = hh;
    pix_w[tid] = ww;
  }
  __syncthreads();

  float acc[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = 0.f;

  const int lane = tid & 31, warp = tid >> 5;
  for (int tap = 0; tap < 4; ++tap) {
    const int dh = (tap >> 1) * p.shift, dw = (tap & 1) * p.shift;
    const T* wt = w + tap * p.w_tap;
    for (int k0 = 0; k0 < p.red; k0 += kBK) {
      // A: a warp reads 32 consecutive channels of one pixel
      const int q = k0 + lane;
#pragma unroll 4
      for (int i = 0; i < kBM / 4; ++i) {
        const int mm = warp + 4 * i;
        const long long base = pix_base[mm];
        const int hh = pix_h[mm] + dh, ww = pix_w[mm] + dw;
        float v = 0.f;
        if (base >= 0 && q < p.red && hh >= 0 && hh < p.ah && ww >= 0
            && ww < p.aw)
          v = to_f32(a[(base + (long long)hh * p.aw + ww) * p.a_ctot + a_coff
                       + q]);
        as[lane][mm] = v;
      }
      // B: thread tid reads output channel n0 + tid of each reduction row
      const int c = n0 + tid;
#pragma unroll 4
      for (int i = 0; i < kBK; ++i) {
        const int qr = k0 + i;
        bs[i][tid] = (c < p.cols && qr < p.red)
                         ? to_f32(wt[(long long)qr * p.w_rs
                                     + (long long)c * p.w_cs])
                         : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float av[kTile], bv[kTile];
#pragma unroll
        for (int i = 0; i < kTile; ++i) av[i] = as[kk][ty + 8 * i];
#pragma unroll
        for (int j = 0; j < kTile; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kTile; ++i)
#pragma unroll
          for (int j = 0; j < kTile; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const long long y_coff = (long long)s * p.cols;
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const long long m = m0 + ty + 8 * i;
    if (m >= m_total) continue;
    T* yrow = y + m * p.y_ctot + y_coff;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < p.cols) store_from_f32(yrow + c, acc[i][j]);
    }
  }
}

// Weight gradient, pass 1: block (chunk, tap*ktiles + ktile, ntile) sums
// x's tap window times ct over the chunk's pixels of one slab into
// partial[chunk][tap][k][j].
struct WgradArgs {
  int rows, ho, wo, hc, wc, ktot, kslab, k, n, nslab, chunks_per_slab;
  long long chunk;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
s2d_wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ ct,
                         float* __restrict__ partial, WgradArgs p) {
  __shared__ float xs[kWR][kWK];
  __shared__ float cs[kWR][kWN];
  __shared__ long long pix_x[kWR], pix_c[kWR];  // -1 past the chunk's end

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int chunk_id = blockIdx.x;
  const int s = chunk_id / p.chunks_per_slab;
  const long long m_total = (long long)p.rows * p.ho * p.wo;
  const long long c0 = (long long)(chunk_id % p.chunks_per_slab) * p.chunk;
  const long long c1 = c0 + p.chunk < m_total ? c0 + p.chunk : m_total;
  const int ktiles = (p.k + kWK - 1) / kWK;
  const int tap = blockIdx.y / ktiles;
  const int k0 = (blockIdx.y % ktiles) * kWK;
  const int n0 = blockIdx.z * kWN;
  const int dh = tap >> 1, dw = tap & 1;
  const long long x_coff = (long long)s * p.kslab;
  const long long ct_ctot = (long long)p.nslab * p.n;
  const long long ct_coff = (long long)s * p.n;

  float acc[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = 0.f;

  for (long long mb = c0; mb < c1; mb += kWR) {
    if (tid < kWR) {
      const long long m = mb + tid;
      long long ox = -1, oc = -1;
      if (m < c1) {
        const int ww = (int)(m % p.wo);
        const long long rest = m / p.wo;
        const int hh = (int)(rest % p.ho);
        const long long r = rest / p.ho;
        ox = ((r * p.hc + hh + dh) * p.wc + ww + dw) * p.ktot + x_coff;
        oc = m * ct_ctot + ct_coff;
      }
      pix_x[tid] = ox;
      pix_c[tid] = oc;
    }
    __syncthreads();
    {  // x: 64 consecutive channels of a pixel per two warps
      const int kk = tid & (kWK - 1);
      const int q = k0 + kk;
#pragma unroll 4
      for (int i = 0; i < kWR / 2; ++i) {
        const int rr = (tid >> 6) + 2 * i;
        const long long ox = pix_x[rr];
        xs[rr][kk] = (ox >= 0 && q < p.k) ? to_f32(x[ox + q]) : 0.f;
      }
      const int c = n0 + tid;
#pragma unroll 4
      for (int rr = 0; rr < kWR; ++rr) {
        const long long oc = pix_c[rr];
        cs[rr][tid] = (oc >= 0 && c < p.n) ? to_f32(ct[oc + c]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kWR; ++rr) {
      float av[kTile], bv[kTile];
#pragma unroll
      for (int i = 0; i < kTile; ++i) av[i] = xs[rr][ty + 8 * i];
#pragma unroll
      for (int j = 0; j < kTile; ++j) bv[j] = cs[rr][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int j = 0; j < kTile; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = partial + ((long long)chunk_id * 4 + tap) * p.k * p.n;
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const int q = k0 + ty + 8 * i;
    if (q >= p.k) continue;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < p.n) out[(long long)q * p.n + c] = acc[i][j];
    }
  }
}

// Weight gradient, pass 2: out[i] = sum over chunks of partial[chunk][i],
// chunk by chunk in order.
__global__ void __launch_bounds__(256)
s2d_wgrad_reduce_kernel(const float* __restrict__ partial,
                        float* __restrict__ out, long long total,
                        int chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[(long long)c * total + i];
  out[i] = s;
}

template <typename T>
int launch_gemm(const void* a, const void* w, void* y, const GemmArgs& p,
                int slabs, cudaStream_t stream) {
  const long long m_total = (long long)p.rows * p.oh * p.ow;
  const long long blocks = (m_total + kBM - 1) / kBM;
  if (blocks > INT_MAX || slabs > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (p.cols + kBN - 1) / kBN, slabs);
  s2d_gemm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(w), static_cast<T*>(y),
      p);
  return (int)cudaGetLastError();
}

bool bad_dims(int a, int b, int c, int d) {
  return a <= 0 || b <= 0 || c <= 0 || d <= 0;
}

}  // namespace

// Forward: x (rows, hc, wc, ktot) and wt (4, k, n) -> y (rows, hc-1, wc-1,
// nslab*n); slab s contracts x's channels [s*kslab, s*kslab + k).  dtype:
// 0 = float32, 1 = bfloat16 (x, wt and y alike).  Launches on `stream` and
// returns cudaGetLastError() (0 on success); shapes the kernel does not take
// return cudaErrorInvalidValue without launching.
extern "C" int s2d_conv_forward(const void* x, const void* wt, void* y,
                                int rows, int hc, int wc, int ktot, int kslab,
                                int k, int n, int nslab, int dtype,
                                void* stream) {
  if (bad_dims(rows, hc - 1, wc - 1, k) || bad_dims(n, nslab, kslab, ktot)
      || (long long)(nslab - 1) * kslab + k > ktot)
    return (int)cudaErrorInvalidValue;
  GemmArgs p{rows, hc - 1, wc - 1, hc, wc, ktot, kslab, 1, k, n, n, 1,
             nslab * n, (long long)k * n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_gemm<float>(x, wt, y, p, nslab, s);
  if (dtype == 1) return launch_gemm<__nv_bfloat16>(x, wt, y, p, nslab, s);
  return (int)cudaErrorInvalidValue;
}

// Input gradient: ct (rows, ho, wo, n) and wt (4, k, n) -> dx (rows, ho+1,
// wo+1, k).
extern "C" int s2d_conv_dgrad(const void* ct, const void* wt, void* dx,
                              int rows, int ho, int wo, int k, int n,
                              int dtype, void* stream) {
  if (bad_dims(rows, ho, wo, k) || n <= 0) return (int)cudaErrorInvalidValue;
  GemmArgs p{rows, ho + 1, wo + 1, ho, wo, n, 0, -1, n, k, 1, n, k,
             (long long)k * n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_gemm<float>(ct, wt, dx, p, 1, s);
  if (dtype == 1) return launch_gemm<__nv_bfloat16>(ct, wt, dx, p, 1, s);
  return (int)cudaErrorInvalidValue;
}

// Weight gradient: x (rows, hc, wc, ktot) and ct (rows, hc-1, wc-1,
// nslab*n) -> out (4, k, n) float32, summed over rows, pixels and slabs.
// `partial` is a float32 scratch of chunks x 4 x k x n with chunks = nslab *
// ceil(rows*(hc-1)*(wc-1) / chunk).
extern "C" int s2d_conv_wgrad(const void* x, const void* ct, void* partial,
                              void* out, int rows, int hc, int wc, int ktot,
                              int kslab, int k, int n, int nslab, int dtype,
                              long long chunk, int chunks, void* stream) {
  if (bad_dims(rows, hc - 1, wc - 1, k) || bad_dims(n, nslab, kslab, ktot)
      || chunk <= 0 || (long long)(nslab - 1) * kslab + k > ktot)
    return (int)cudaErrorInvalidValue;
  const long long m_total = (long long)rows * (hc - 1) * (wc - 1);
  const long long per_slab = (m_total + chunk - 1) / chunk;
  if (per_slab * nslab != chunks || chunks > INT_MAX / 4)
    return (int)cudaErrorInvalidValue;
  WgradArgs p{rows, hc - 1, wc - 1, hc, wc, ktot, kslab, k, n, nslab,
              (int)per_slab, chunk};
  const int ktiles = (k + kWK - 1) / kWK;
  const dim3 grid(chunks, 4 * ktiles, (n + kWN - 1) / kWN);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    s2d_wgrad_partial_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(ct),
        static_cast<float*>(partial), p);
  } else if (dtype == 1) {
    s2d_wgrad_partial_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(ct), static_cast<float*>(partial),
        p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = 4LL * k * n;
  s2d_wgrad_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), total,
      chunks);
  return (int)cudaGetLastError();
}

extern "C" const char* s2d_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Helpers shared by the space-to-depth conv kernels (s2d_conv.cu, K4, and
// s2d_group_conv.cu, K5) and flash attention (flash_attention.cu, K6) on
// Hopper (sm_90a): bf16 and TF32 tensor-core products through mma.sync,
// the 3xTF32 split of a float32 operand, ldmatrix fragment loads, cp.async
// copies into shared memory, division by a runtime constant, and the
// host's opt-in to more than 48 KB of dynamic shared memory.  ops/_build.py hashes every
// csrc/*.cuh into each library's name, so an edit here rebuilds both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

// a row of n bf16 staged by 16-byte copies: an odd number of 16-byte
// chunks, so that 8 rows of an ldmatrix (and a fragment load's 8 rows x 4
// words) fall on distinct banks
__host__ __device__ constexpr int tc_row(int n) {
  const int chunks = (n + 7) / 8;
  return 8 * (chunks % 2 ? chunks : chunks + 1);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a b for one 16 x 8 tile, k = 16 (the PTX fragment layouts: a0..a3
// rows g, g+8 and columns 2t, 2t+8; b0, b1 rows 2t, 2t+8 and column g;
// c0, c1 row g and c2, c3 row g+8, columns 2t, 2t+1; g = lane / 4,
// t = lane % 4)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b for one 16 x 8 tile, k = 8, TF32 operands in f32 registers
// (a0..a3 rows g, g+8, g, g+8 and columns t, t, t+4, t+4; b0, b1 rows t,
// t+4 and column g; c as in mma_bf16)
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = big + small: big = x rounded to TF32 (10 mantissa bits, to nearest,
// ties away from zero: cvt.rna.tf32.f32's rounding, by integer ops), small
// = x - big (exact), of which the tensor core reads the top 10 mantissa
// bits (truncation).  A 3xTF32 product big.big + big.small + small.big
// keeps about 21 bits of each operand, about float32's accuracy; one TF32
// product keeps 10.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// four 8 x 8 bf16 matrices: lane 8j + i gives the address of row i of
// matrix j; r[j] holds, for lane (g, t), matrix j's elements (g, 2t) and
// (g, 2t+1)
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// the same, transposed: r[j] holds matrix j's elements (2t, g) and
// (2t+1, g)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16 (or 8) bytes global -> shared, asynchronously; zeros where !valid
// (the source is then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most `pending` committed groups are still in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// i / d and i % d by a multiply (exact for i * d < 2^32): the staging loops
// split a flat index by runtime extents, which a hardware division would
// make cost more than the loads
struct Div {
  unsigned d;
  unsigned long long m;
  __device__ explicit Div(int dd)
      : d((unsigned)dd), m((0x100000000ull + dd - 1) / (unsigned)dd) {}
  __device__ __forceinline__ int div(int i) const {
    return (int)(((unsigned long long)(unsigned)i * m) >> 32);
  }
  __device__ __forceinline__ int mod(int i, int q) const {
    return i - q * (int)d;
  }
};

// The dynamic shared-memory limit is raised once per kernel, device and
// size (a size above every earlier one raises it again): each launcher
// keeps the largest size it set, one per device.
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 227 * 1024;  // what a block may opt in to
using SmemSet = std::atomic<int>[kMaxDevices];

template <typename Kernel>
cudaError_t allow_smem(SmemSet& set, Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (set[dev].load(std::memory_order_acquire) >= (int)bytes)
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) set[dev].store((int)bytes, std::memory_order_release);
  return err;
}

// blocks of `kernel` the card runs at once, for a grid-stride loop
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem,
                            int& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  blocks = sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

}  // namespace

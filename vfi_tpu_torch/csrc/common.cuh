// Device helpers shared by the port's kernels: asynchronous 16-byte (and,
// for the float32 conv, 4-byte) copies from device memory into shared
// memory (cp.async, Ampere and later), the
// channel / byte rounding of the shared-memory layouts, and the tensor-core
// core of the implicit GEMMs (csrc/conv2d.cu, csrc/dcn_bounded.cu):
// ldmatrix loads, mma.sync m16n8k16 bf16 with float32 accumulators, and
// the quad-lane transpose of the epilogue.

#pragma once

#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__host__ __device__ inline int pad16(int c) { return (c + 15) / 16 * 16; }

// Make `device` current for the launch, setting it only where another is.
__host__ inline cudaError_t use_device(int device) {
  int cur = -1;
  const cudaError_t err = cudaGetDevice(&cur);
  return err != cudaSuccess || cur == device ? err : cudaSetDevice(device);
}
__host__ __device__ inline int round128(int b) { return (b + 127) / 128 * 128; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
// As cp_async16, but writes 16 zero bytes (and reads nothing) unless `valid`;
// `src` must still be a device address.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
// One 4-byte element (a float32 channel), or 4 zero bytes unless `valid`.
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of the most recent groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// n / d for n * d < 2^32 and d >= 2, with m = fast_div_magic(d).
__device__ __forceinline__ uint32_t fast_div_magic(uint32_t d) { return 0xFFFFFFFFu / d + 1; }
__device__ __forceinline__ int fast_div(int n, uint32_t m) { return (int)__umulhi((uint32_t)n, m); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&b0)[2], uint32_t (&b1)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&b)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1]) : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Within each quad of lanes (q = lane & 3), u[j] holds channels 2q, 2q + 1
// of n8 fragment j of one pixel. Afterwards lane q holds all 8 channels of
// fragment q, in order.
__device__ __forceinline__ void quad_transpose(uint32_t (&u)[4], int q) {
  const bool hi2 = q & 2, hi1 = q & 1;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, hi2 ? u[0] : u[2], 2);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, hi2 ? u[1] : u[3], 2);
  const uint32_t v0 = hi2 ? r0 : u[0], v1 = hi2 ? r1 : u[1];
  const uint32_t v2 = hi2 ? u[2] : r0, v3 = hi2 ? u[3] : r1;
  r0 = __shfl_xor_sync(0xffffffffu, hi1 ? v0 : v1, 1);
  r1 = __shfl_xor_sync(0xffffffffu, hi1 ? v2 : v3, 1);
  u[0] = hi1 ? r0 : v0;
  u[1] = hi1 ? v1 : r0;
  u[2] = hi1 ? r1 : v2;
  u[3] = hi1 ? v3 : r1;
}

}  // namespace

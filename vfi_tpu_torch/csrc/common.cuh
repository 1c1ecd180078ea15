// Device helpers shared by the port's kernels: asynchronous 16-byte copies
// from device memory into shared memory (cp.async, Ampere and later) and
// the channel / byte rounding of the shared-memory layouts.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__host__ __device__ inline int pad16(int c) { return (c + 15) / 16 * 16; }
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of the most recent groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace

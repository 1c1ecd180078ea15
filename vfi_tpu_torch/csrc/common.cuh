// Device helpers shared by the port's kernels: asynchronous 16-byte copies
// from device memory into shared memory (cp.async, Ampere and later), the
// channel / byte rounding of the shared-memory layouts, and the tensor-core
// cores of the implicit GEMMs (csrc/conv2d.cu, csrc/dcn_bounded.cu):
// ldmatrix loads, mma.sync m16n8k16 bf16 with float32 accumulators and the
// quad-lane transpose of its epilogue, and the float32 instances' 3xTF32
// product on mma.sync m16n8k8 (below).

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

// A persistent launch of `kernel`: as many blocks of `threads` threads as
// the card holds at once (the occupancy API), at most one a tile, each
// walking the `tiles` tiles with a stride of the grid, with `smem` bytes of
// dynamic shared memory each. Returns the cudaError_t of the launch.
template <typename Params>
__host__ int launch_persistent(void (*kernel)(Params), const Params& p, int tiles,
                               int threads, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0, dev = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

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
// As cp_async16, but reads only the first `bytes` (0..16) of `src` and
// writes zeros to the rest of the 16 bytes; `src` must still be a 16-byte
// aligned device address. `l1`: through the L1 cache (.ca) instead of past
// it (.cg), for a source that every pixel reads (a broadcast): from L2
// alone, the requests of every SM for the same line queue at its one L2
// slice (a 720p 128 -> 64 conv whose half input was one broadcast vector
// took 2x the time of its contiguous input on an H100).
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int bytes,
                                             bool l1 = false) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (l1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
}

// An input read in place (a channels-contiguous NHWC view) in up to two
// parts split along channels: part 0 holds channels [0, c0), part 1
// [c0, c0 + c1) (c1 = 0: no part 1; c0 a multiple of 8 where c1 > 0).
// Each part has its own image, row and pixel strides in elements (each a
// multiple of 8, i.e. 16 bytes; 0 allowed: a broadcast); an element's
// offset within an image fits 32 bits. A tile loader takes an image's base
// pointers once (`image`), then copies each 16-byte unit of channels
// (`load`): the bytes of it that lie in the input, zeros for the rest (the
// channels past c0 + c1, up to the kernel's padded width) and for a pixel
// outside the image. `load<false>` reads part 0 alone, the whole input of
// a kernel instance for one part: the arithmetic of a contiguous tensor's
// loader with the part's strides. `load<true>` picks the part from the
// channel, and reads a part that is a broadcast along rows (a pixel stride
// of 0) through L1.
template <typename T>
struct InputParts {
  const T* x0;
  const T* x1;
  long long sb0, sb1;
  int sy0, sx0, sy1, sx1;
  int c0, c1;

  struct Image {
    const T* b0;
    const T* b1;
  };
  __device__ __forceinline__ Image image(int b) const { return {x0 + b * sb0, x1 + b * sb1}; }

  // Channels ch .. ch + 16 / sizeof(T) of pixel (gy, gx) of `img` into
  // `dst`; `inimg`: the pixel lies in the image.
  template <bool TWO>
  __device__ __forceinline__ void load(void* dst, const Image& img, int gy, int gx, int ch,
                                       bool inimg) const {
    constexpr int PER = 16 / sizeof(T);
    const bool hi = TWO && ch >= c0;
    const int cc = hi ? ch - c0 : ch, left = (hi ? c1 : c0) - cc;
    const bool ok = inimg && left > 0;
    const T* src = (hi ? img.b1 : img.b0) + ((hi ? sy1 : sy0) * gy + (hi ? sx1 : sx0) * gx + cc);
    cp_async16_n(dst, ok ? src : x0, ok ? (left < PER ? left : PER) * (int)sizeof(T) : 0,
                 TWO && (hi ? sx1 : sx0) == 0);
  }
};

// The InputParts of (x0, strides, c0, x1, strides, c1) as the C entries take
// them for H x W images, or false where the loader cannot read them: a
// stride off 16 bytes or negative, a part off 16-byte alignment, part 0
// not a multiple of 16 bytes wide where there are two, no channels, or an
// offset within an image past 32 bits.
template <typename T>
__host__ inline bool make_parts(InputParts<T>& in, int H, int W, const void* x0, long long sb0,
                                long long sy0, long long sx0, int c0, const void* x1,
                                long long sb1, long long sy1, long long sx1, int c1) {
  constexpr int PER = 16 / sizeof(T);
  auto ok = [&](const void* p, long long sb, long long sy, long long sx, int c) {
    return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % PER == 0 &&
           sy % PER == 0 && sx % PER == 0 && sb >= 0 && sy >= 0 && sx >= 0 &&
           (H > 0 ? H - 1 : 0) * sy + (W > 0 ? W - 1 : 0) * sx + c + PER < (1LL << 31);
  };
  if (c0 < 1 || c1 < 0 || !ok(x0, sb0, sy0, sx0, c0) ||
      (c1 > 0 && (c0 % PER != 0 || !ok(x1, sb1, sy1, sx1, c1))))
    return false;
  const bool two = c1 > 0;
  in.x0 = static_cast<const T*>(x0);
  in.x1 = static_cast<const T*>(two ? x1 : x0);
  in.sb0 = sb0; in.sy0 = (int)sy0; in.sx0 = (int)sx0;
  in.sb1 = two ? sb1 : 0; in.sy1 = two ? (int)sy1 : 0; in.sx1 = two ? (int)sx1 : 0;
  in.c0 = c0; in.c1 = c1;
  return true;
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

// Non-transposed loads of 32-bit elements (ldmatrix .b16 moves each 4-byte
// element whole): thread t gets element (row t / 4, column t % 4) of each
// 8 x 4 matrix, which is an m16n8k8 TF32 fragment's layout where K runs
// along a row. x4 into two B fragments ([n][k] rows: b0 = n 0-7 at k 0-3,
// then k 4-7; b1 = n 8-15), x2 into one.
__device__ __forceinline__ void ldsm_x4_b(uint32_t (&b0)[2], uint32_t (&b1)[2], uint32_t addr) {
  uint32_t r[4];
  ldsm_x4(r, addr);
  b0[0] = r[0]; b0[1] = r[1]; b1[0] = r[2]; b1[1] = r[3];
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&b)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1]) : "r"(addr));
}

// 3xTF32: float32 products on the TF32 tensor cores. Each float32 operand x
// splits into hi = tf32(x), rounded to nearest with ties away from zero
// (cvt.rna's value), and lo = x - hi (exact in float32); a * b is then
// lo_a hi_b + hi_a lo_b + hi_a hi_b, each product of two TF32 values exact
// in float32, summed into float32 accumulators, the two small terms first.
// - hi adds half a TF32 ulp to the bits and masks the 13 low ones: two
//   integer instructions, where ptxas expands cvt.rna.tf32.f32 to four (an
//   infinity test beside the add and mask); the same value for every
//   finite x, an overflow carried to infinity as cvt.rna does.
// - lo stays unrounded: the tensor cores read the 19 high bits of a TF32
//   operand, so it enters truncated, an error under 2^-21 of |x|.
// Dropping lo_a lo_b costs about 2^-22 of |a b|; one TF32 pass (hi_a hi_b
// alone) keeps 11 bits of each operand, about 2^-11 of |a b|
// (tests/test_torch_tf32x3.py emulates both).
template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = (x[i] + 0x1000u) & 0xffffe000u;
    lo[i] = __float_as_uint(__fsub_rn(__uint_as_float(x[i]), __uint_as_float(hi[i])));
  }
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d = a * b (a zero C operand): a sum's first MMA, where d holds nothing
// to keep.
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f));
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

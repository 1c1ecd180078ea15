// Bounded backward warp, bf16 NHWC: out(y, x) = image(y + dy, x + dx) with
// the flow (dx, dy) clipped to [-R, R]; bilinear, zeros padding,
// align_corners=True semantics (pixel-space sampling).
//
// Two instances, one entry point that picks by the channel count:
//
// C <= 4, the RGB frame. Replaces vfi_tpu/ops/pallas/sampling.py::
// _warp_kernel_v2 (bounded_warp_pallas_v2), the TPU kernel that warps
// EMAVFI's RGB frame. The TPU version packed the 3-channel image into 128
// column strips to fill its vector lanes; a GPU thread per pixel needs
// none of that. One thread per output pixel, all channels. Coordinates
// are float32; the fractional weights, their products, each corner term
// and each partial sum are rounded to bf16 in the order ops/warp.py
// applies them to a bf16 image, so the kernel computes the plain
// version's values.
//
// C > 4, feature maps. Replaces ::_warp_kernel (bounded_warp_pallas, v1),
// which padded the channels to 128 lanes and blended in a float32 tile:
// one thread per (pixel, 8 channels), the corner reads 16-byte vectors
// where C % 8 == 0, the blend in float32 in ops/warp.py's order and one
// rounding of the output, as v1 does.
//
// What bounds both on this card: bytes. Per pixel the RGB warp reads 3
// channels and 2 flow values and writes 3 channels (~16 bytes) for ~40
// operations, far below the ridge, and a wide warp moves 4 bytes a channel
// for 8 operations; the four corner reads hit L1/L2, since neighbouring
// threads sample neighbouring pixels (|flow| <= R).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTHREADS = 256;
constexpr int MAXC = 4;          // the RGB instance's channels
constexpr int VEC = 8;           // the wide instance's channels a thread

__device__ __forceinline__ float rb(float v) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(NTHREADS)
warp_bounded_kernel(const bf16* __restrict__ image, const bf16* __restrict__ flow,
                    bf16* __restrict__ out, int B, int H, int W, int C, float R) {
  const long long n = (long long)B * H * W;
  const long long pix = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (pix >= n) return;
  const int x = (int)(pix % W);
  const int y = (int)((pix / W) % H);
  const long long base = pix - ((long long)y * W + x);   // flat index of (b, 0, 0)

  const float fx = fminf(fmaxf(__bfloat162float(flow[2 * pix]), -R), R);
  const float fy = fminf(fmaxf(__bfloat162float(flow[2 * pix + 1]), -R), R);
  const float xs = (float)x + fx, ys = (float)y + fy;
  const float x0f = floorf(xs), y0f = floorf(ys);
  const int x0 = (int)x0f, y0 = (int)y0f, x1 = x0 + 1, y1 = y0 + 1;
  const float wx1 = rb(xs - x0f), wy1 = rb(ys - y0f);
  const float wx0 = rb(1.0f - wx1), wy0 = rb(1.0f - wy1);
  const float w00 = rb(wy0 * wx0), w01 = rb(wy0 * wx1);
  const float w10 = rb(wy1 * wx0), w11 = rb(wy1 * wx1);

  const bool in00 = y0 >= 0 && y0 < H && x0 >= 0 && x0 < W;
  const bool in01 = y0 >= 0 && y0 < H && x1 >= 0 && x1 < W;
  const bool in10 = y1 >= 0 && y1 < H && x0 >= 0 && x0 < W;
  const bool in11 = y1 >= 0 && y1 < H && x1 >= 0 && x1 < W;
  const bf16* p00 = image + (base + (long long)y0 * W + x0) * C;
  const bf16* p01 = image + (base + (long long)y0 * W + x1) * C;
  const bf16* p10 = image + (base + (long long)y1 * W + x0) * C;
  const bf16* p11 = image + (base + (long long)y1 * W + x1) * C;

  for (int c = 0; c < C && c < MAXC; ++c) {
    const float v00 = in00 ? __bfloat162float(p00[c]) : 0.0f;
    const float v01 = in01 ? __bfloat162float(p01[c]) : 0.0f;
    const float v10 = in10 ? __bfloat162float(p10[c]) : 0.0f;
    const float v11 = in11 ? __bfloat162float(p11[c]) : 0.0f;
    float s = rb(rb(v00 * w00) + rb(v01 * w01));
    s = rb(s + rb(v10 * w10));
    s = rb(s + rb(v11 * w11));
    out[pix * C + c] = __float2bfloat16_rn(s);
  }
}

// One thread per (pixel, group of VEC channels), float32 blend.
__global__ void __launch_bounds__(NTHREADS)
warp_bounded_wide_kernel(const bf16* __restrict__ image, const bf16* __restrict__ flow,
                         bf16* __restrict__ out, int B, int H, int W, int C, float R) {
  const int groups = (C + VEC - 1) / VEC;
  const long long n = (long long)B * H * W * groups;
  const long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= n) return;
  const long long pix = i / groups;
  const int c0 = (int)(i - pix * groups) * VEC;
  const int x = (int)(pix % W);
  const int y = (int)((pix / W) % H);
  const long long base = pix - ((long long)y * W + x);   // flat index of (b, 0, 0)

  const float fx = fminf(fmaxf(__bfloat162float(flow[2 * pix]), -R), R);
  const float fy = fminf(fmaxf(__bfloat162float(flow[2 * pix + 1]), -R), R);
  const float xs = (float)x + fx, ys = (float)y + fy;
  const float x0f = floorf(xs), y0f = floorf(ys);
  const int x0 = (int)x0f, y0 = (int)y0f, x1 = x0 + 1, y1 = y0 + 1;
  const float wx1 = xs - x0f, wy1 = ys - y0f;
  const float wx0 = 1.0f - wx1, wy0 = 1.0f - wy1;
  const float w[4] = {__fmul_rn(wy0, wx0), __fmul_rn(wy0, wx1),
                      __fmul_rn(wy1, wx0), __fmul_rn(wy1, wx1)};
  const int cy[4] = {y0, y0, y1, y1}, cx[4] = {x0, x1, x0, x1};
  const bf16* src[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    src[k] = (cy[k] >= 0 && cy[k] < H && cx[k] >= 0 && cx[k] < W)
                 ? image + (base + (long long)cy[k] * W + cx[k]) * C + c0
                 : nullptr;

  // sum = ((v00 w00 + v01 w01) + v10 w10) + v11 w11, no fused multiply-add.
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
  bf16* dst = out + pix * C + c0;
  if (C % VEC == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!src[k]) continue;
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src[k]));
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC / 2; ++e) {
        const float2 f = __bfloat1622float2(v2[e]);
        acc[2 * e] = __fadd_rn(acc[2 * e], __fmul_rn(f.x, w[k]));
        acc[2 * e + 1] = __fadd_rn(acc[2 * e + 1], __fmul_rn(f.y, w[k]));
      }
    }
    __align__(16) bf16 o[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = __float2bfloat16_rn(acc[e]);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
  } else {
    const int nc = min(VEC, C - c0);
    for (int k = 0; k < 4; ++k) {
      if (!src[k]) continue;
      for (int e = 0; e < nc; ++e)
        acc[e] = __fadd_rn(acc[e], __fmul_rn(__bfloat162float(src[k][e]), w[k]));
    }
    for (int e = 0; e < nc; ++e) dst[e] = __float2bfloat16_rn(acc[e]);
  }
}

}  // namespace

// Launch one bounded warp (any C >= 1: C <= 4 the bf16-rounded RGB
// instance, else the float32-blend wide one). Returns the cudaError_t of
// the launch.
extern "C" int vfi_warp_bounded_bf16(const void* image, const void* flow, void* out,
                                     int B, int H, int W, int C, float R,
                                     int device, void* stream) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* im = static_cast<const bf16*>(image);
  const bf16* fl = static_cast<const bf16*>(flow);
  bf16* o = static_cast<bf16*>(out);
  const long long n = (long long)B * H * W;
  if (C <= MAXC) {
    const unsigned blocks = (unsigned)((n + NTHREADS - 1) / NTHREADS);
    warp_bounded_kernel<<<blocks, NTHREADS, 0, st>>>(im, fl, o, B, H, W, C, R);
  } else {
    const long long items = n * ((C + VEC - 1) / VEC);
    const unsigned blocks = (unsigned)((items + NTHREADS - 1) / NTHREADS);
    warp_bounded_wide_kernel<<<blocks, NTHREADS, 0, st>>>(im, fl, o, B, H, W, C, R);
  }
  return (int)cudaGetLastError();
}

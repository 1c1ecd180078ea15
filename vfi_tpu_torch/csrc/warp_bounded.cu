// Bounded backward warp, bf16 NHWC: out(y, x) = image(y + dy, x + dx) with
// the flow (dx, dy) clipped to [-R, R]; bilinear, zeros padding,
// align_corners=True semantics (pixel-space sampling).
//
// Replaces: vfi_tpu/ops/pallas/sampling.py::_warp_kernel_v2
// (bounded_warp_pallas_v2), the TPU kernel that warps EMAVFI's RGB frame.
// The TPU version packed the 3-channel image into 128 column strips to fill
// its vector lanes; a GPU thread per pixel needs none of that.
//
// What bounds it on this card: bytes. Per pixel it reads 3 channels and 2
// flow values and writes 3 channels (~16 bytes) for ~40 operations, far
// below the ridge; the four corner reads hit L1/L2, since neighbouring
// threads sample neighbouring pixels (|flow| <= R).
//
// Design: one thread per output pixel, all channels. Coordinates are
// float32; the fractional weights, their products, each corner term and
// each partial sum are rounded to bf16 in the order ops/warp.py applies
// them to a bf16 image, so the kernel computes the plain version's values.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTHREADS = 256;
constexpr int MAXC = 4;

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

}  // namespace

// Launch one bounded warp (C <= 4). Returns the cudaError_t of the launch.
extern "C" int vfi_warp_bounded_bf16(const void* image, const void* flow, void* out,
                                     int B, int H, int W, int C, float R,
                                     int device, void* stream) {
  if (C < 1 || C > MAXC) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * H * W;
  const unsigned blocks = (unsigned)((n + NTHREADS - 1) / NTHREADS);
  warp_bounded_kernel<<<blocks, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(image), static_cast<const bf16*>(flow),
      static_cast<bf16*>(out), B, H, W, C, R);
  return (int)cudaGetLastError();
}

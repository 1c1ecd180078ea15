// Bounded backward warp, bf16 or float32 NHWC: out(y, x) = image(y + dy,
// x + dx) with the flow (dx, dy) clipped to [-R, R]; bilinear, zeros
// padding, align_corners=True semantics (pixel-space sampling).
//
// Two instances, one entry point a type (`vfi_warp_bounded_bf16`,
// `vfi_warp_bounded_f32`) that picks by the channel count; the kernels
// are templates on the element type. The float32 instances compute in
// float32 what the bf16 ones compute rounded: ops/warp.py's order with no
// rounding but float32's, no fused multiply-add (bit-exact against the
// plain version, as the bf16 instances are).
//
// C <= 4, the RGB frame. Replaces vfi_tpu/ops/pallas/sampling.py::
// _warp_kernel_v2 (bounded_warp_pallas_v2), the TPU kernel that warps
// EMAVFI's RGB frame. The TPU version packed the 3-channel image into 128
// column strips to fill its vector lanes; a GPU needs none of that. A
// thread owns PPT = 2 horizontally adjacent output pixels: it reads their
// flows as one 8-byte vector, the four corners of each pixel with 2-byte
// loads, and writes the pair's 2 x C channels as C aligned 4-byte words.
// A block owns a 2-D tile of 16 rows x 32 columns, so that the corners its
// threads read, within R rows and columns of the tile, stay in L1 (a
// block of consecutive pixels of one row reaches over 2R + 2 full rows).
// Coordinates are float32; the fractional weights, their products, each
// corner term and each partial sum are rounded to bf16 in the order
// ops/warp.py applies them to a bf16 image, so the kernel computes the
// plain version's values. Odd W, a flow or output pointer off its vector
// alignment, and a row's ragged last pixel take 2-byte loads and stores
// instead. Index arithmetic is 32-bit where every element index fits, and
// a thread issues the corner loads of both its pixels before it blends.
// The bf16 instance can also write each pixel 8 channels wide, its C
// values and zeros (`oc` = 8): the buffer whose
// [..., :C] view the conv and DCN kernels read in place as one part of
// their input, where a 3-channel tensor (6-byte pixels) would need a
// padded copy.
// On an H100 at R = 16 with random flows (tools/conv_turns.py, in turns):
// 2-D tiles took 0.0191 ms at 720p where blocks of 1,024 consecutive pixels
// took 0.0255;
// among tiles of four pixels a thread, 32 x 32 beat 16 x 64 and 8 x 128 by
// 3% and 7%; two pixels a thread beat four by 6-18% at every path shape.
//
// C > 4, feature maps. Replaces ::_warp_kernel (bounded_warp_pallas, v1),
// which padded the channels to 128 lanes and blended in a float32 tile.
// Where C is a multiple of a 16-byte group (8 bf16 or 4 float32 channels)
// and the image and output are 16-byte aligned (the 16-byte instance,
// "wide16" in chip_smoke.py's rows), a block owns a 2-D tile of 4 x 8
// output pixels and a few threads a pixel: a thread takes WIDE_IPT = 2 of
// its pixel's 16-byte groups and starts all eight corner reads before it
// blends. Each thread computes its pixel's clamped position, corners and
// weights itself. Short-lived threads in small blocks keep
// the work in flight to a band of rows in image order, so that an image
// line can stay in L2 while the rows that sample it run (inferred, not
// measured: it is where this design gains most, at C = 128, whose image,
// 79 MB at 480x640, outgrows the 50 MB L2). The output goes out as
// streaming stores (evict first); the flow is read once (__ldcs).
// The blend is float32 in ops/warp.py's order, ((v00 w00 + v01 w01) +
// v10 w10) + v11 w11, no fused multiply-add, one rounding of the output,
// as v1 does. Index arithmetic is 32-bit where every element index fits.
// Any other C (e.g. 67) or alignment takes the one-element instance
// ("wide2b": 2-byte reads in bf16, 4-byte in float32), one thread per
// (pixel, 8-channel group) in image order.
// On an H100 at 480x640 with random flows (tools/conv_turns.py, in
// turns): two groups a thread took 0.0370 ms at C=64 R=16, one 0.0421
// and four 0.0675; long-lived warps of 8 x 32-pixel tiles that compute a
// pixel once and share it by __shfl_sync took 0.0480 (0.1143 at C=128,
// whose image they keep in flight whole, against 0.0692). At C=67 the
// 2-byte instance took 0.0953 ms where the 4 x 8 tiles with 2-byte reads
// took 0.1049 (one group a thread) and 0.1582 (two; 0.0988 for the 2-byte
// instance in those turns), so C % 8 != 0 keeps its own kernel.
//
// What bounds both on this card: bytes. Per pixel the RGB warp reads 3
// channels and 2 flow values and writes 3 channels (~16 bytes) for ~40
// operations, far below the ridge, and a wide warp moves 4 bytes a channel
// for 8 operations; the four corner reads hit L1/L2, since neighbouring
// threads sample neighbouring pixels (|flow| <= R). At the main path's
// sizes (5-20 MB, a few microseconds) the host's launch path outweighs the
// device work: the entry sets the device only when it differs.

#include <type_traits>

#include "common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTHREADS = 256;
constexpr int MAXC = 4;          // the RGB instance's channels
constexpr int PPT = 2;           // the RGB instance's pixels a thread
constexpr int TX = 16;           // its threads along a tile row (32 columns)
constexpr int ROWS = NTHREADS / TX;   // its tile rows (16)
constexpr int WIDE_TH = 4;       // the wide instance's tile: 4 x 8 pixels,
constexpr int WIDE_TW = 8;
constexpr int WIDE_IPT = 2;      // 16-byte channel groups a thread
constexpr int GROUP = 8;         // the 2-byte instance's channels a thread

// The 16-byte instance's threads a pixel for G channel groups: WIDE_IPT
// groups a thread, at most 32 threads.
__host__ __device__ inline int wide_lanes(int G) {
  const int n = (G + WIDE_IPT - 1) / WIDE_IPT;
  return n < 32 ? n : 32;
}

template <typename T>
__host__ __device__ constexpr bool is_bf16() { return std::is_same<T, bf16>::value; }

// One element as float32, and a float32 value as an element (rounded to
// nearest for bf16).
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (is_bf16<T>()) return __float2bfloat16_rn(v);
  else return v;
}
// The RGB instance's rounding of each weight, product and partial sum to
// the image's type (ops/warp.py computes in it): bf16 and back, or none.
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (is_bf16<T>()) return __bfloat162float(__float2bfloat16_rn(v));
  else return v;
}

// A block owns a 2-D output tile of ROWS x (TX * PPT) pixels of one image;
// thread (r, t) the PPT pixels at columns t * PPT ... of row r. It runs in
// three phases so that the loads of both its pixels are in flight
// together: positions and weights, the 4 x C corner loads of each pixel,
// the blends. T: bf16 or float; I: the index type, 32-bit where every
// element index fits. `oc`: the output's pixel stride, C, or 8 in bf16
// (a pixel's C channels and 8 - C zeros, one 16-byte store: the 8-wide
// buffer whose [..., :C] view a kernel that reads 16-byte units of
// channels takes in place). `vec`: W % PPT == 0, the flow aligned to its
// PPT pixels' 2 * PPT elements and the output to PPT elements (16 bytes
// where oc = 8).
template <typename T, int C, typename I>
__global__ void __launch_bounds__(NTHREADS)
warp_bounded_kernel(const T* __restrict__ image, const T* __restrict__ flow,
                    T* __restrict__ out, int H, int W, float R, bool vec, int oc) {
  const int y = blockIdx.y * ROWS + threadIdx.x / TX;
  const int x0 = (blockIdx.x * TX + threadIdx.x % TX) * PPT;
  if (y >= H || x0 >= W) return;
  const int cnt = min(PPT, W - x0);
  const bool full = vec && cnt == PPT;
  const I base = (I)blockIdx.z * H * W;      // flat index of (b, 0, 0)
  const I p0 = base + (I)y * W + x0;

  float fx[PPT], fy[PPT];
  if (full) {
    if constexpr (is_bf16<T>()) {
      const uint2 raw = __ldg(reinterpret_cast<const uint2*>(flow + 2 * p0));
      const uint32_t words[PPT] = {raw.x, raw.y};
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[k]));
        fx[k] = f.x;
        fy[k] = f.y;
      }
    } else {
      const float4 raw = __ldg(reinterpret_cast<const float4*>(flow + 2 * p0));
      fx[0] = raw.x; fy[0] = raw.y; fx[1] = raw.z; fy[1] = raw.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      fx[k] = k < cnt ? to_f(flow[2 * (p0 + k)]) : 0.0f;
      fy[k] = k < cnt ? to_f(flow[2 * (p0 + k) + 1]) : 0.0f;
    }
  }

  // Positions and bilinear weights, rounded as ops/warp.py rounds them.
  float w[PPT][4];
  I src[PPT][4];
  bool in[PPT][4];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const float ux = fminf(fmaxf(fx[k], -R), R), uy = fminf(fmaxf(fy[k], -R), R);
    const float xs = (float)(x0 + k) + ux, ys = (float)y + uy;
    const float x0f = floorf(xs), y0f = floorf(ys);
    const int cx = (int)x0f, cy = (int)y0f;
    const float wx1 = rnd<T>(xs - x0f), wy1 = rnd<T>(ys - y0f);
    const float wx0 = rnd<T>(1.0f - wx1), wy0 = rnd<T>(1.0f - wy1);
    w[k][0] = rnd<T>(__fmul_rn(wy0, wx0));
    w[k][1] = rnd<T>(__fmul_rn(wy0, wx1));
    w[k][2] = rnd<T>(__fmul_rn(wy1, wx0));
    w[k][3] = rnd<T>(__fmul_rn(wy1, wx1));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int yy = cy + (q >> 1), xx = cx + (q & 1);
      in[k][q] = k < cnt && yy >= 0 && yy < H && xx >= 0 && xx < W;
      src[k][q] = in[k][q] ? (base + (I)yy * W + xx) * C : 0;
    }
  }
  // The corners, C channels each, one element a load.
  float v[PPT][4][C];
#pragma unroll
  for (int k = 0; k < PPT; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c)
        v[k][q][c] = in[k][q] ? to_f(__ldg(image + src[k][q] + c)) : 0.0f;
  // The blends: ((v00 w00 + v01 w01) + v10 w10) + v11 w11, each product
  // and partial sum rounded to T, no fused multiply-add. A full group's
  // PPT x C values go out as C aligned stores of PPT elements.
  T o[PPT * C];
#pragma unroll
  for (int k = 0; k < PPT; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float s = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(v[k][0][c], w[k][0])),
                                 rnd<T>(__fmul_rn(v[k][1][c], w[k][1]))));
      s = rnd<T>(__fadd_rn(s, rnd<T>(__fmul_rn(v[k][2][c], w[k][2]))));
      s = rnd<T>(__fadd_rn(s, rnd<T>(__fmul_rn(v[k][3][c], w[k][3]))));
      o[k * C + c] = from_f<T>(s);
      if (!full && k < cnt) out[(p0 + k) * oc + c] = o[k * C + c];
    }
  if (!full && oc != C) {
    for (int k = 0; k < cnt; ++k)
      for (int c = C; c < oc; ++c) out[(p0 + k) * oc + c] = from_f<T>(0.0f);
  }
  if (full) {
    if constexpr (is_bf16<T>()) {
      if (oc != C) {   // 8 channels a pixel: C values, then zeros
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          uint32_t u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int c = 0; c < C; ++c)
            u[c >> 1] |= (uint32_t)__bfloat16_as_ushort(o[k * C + c]) << (16 * (c & 1));
          reinterpret_cast<uint4*>(out + (p0 + k) * oc)[0] = make_uint4(u[0], u[1], u[2], u[3]);
        }
        return;
      }
      uint32_t* dst = reinterpret_cast<uint32_t*>(out + p0 * C);
#pragma unroll
      for (int k = 0; k < C; ++k)
        dst[k] = (uint32_t)__bfloat16_as_ushort(o[2 * k]) |
                 (uint32_t)__bfloat16_as_ushort(o[2 * k + 1]) << 16;
    } else {
      float2* dst = reinterpret_cast<float2*>(out + p0 * C);
#pragma unroll
      for (int k = 0; k < C; ++k) dst[k] = make_float2(o[2 * k], o[2 * k + 1]);
    }
  }
}

template <typename T, typename I>
void launch_rgb(const T* im, const T* fl, T* o, int B, int H, int W, int C, int oc, float R,
                bool vec, cudaStream_t st) {
  const dim3 grid((W + TX * PPT - 1) / (TX * PPT), (H + ROWS - 1) / ROWS, B);
  switch (C) {
    case 1: warp_bounded_kernel<T, 1, I><<<grid, NTHREADS, 0, st>>>(im, fl, o, H, W, R, vec, oc); break;
    case 2: warp_bounded_kernel<T, 2, I><<<grid, NTHREADS, 0, st>>>(im, fl, o, H, W, R, vec, oc); break;
    case 3: warp_bounded_kernel<T, 3, I><<<grid, NTHREADS, 0, st>>>(im, fl, o, H, W, R, vec, oc); break;
    default: warp_bounded_kernel<T, 4, I><<<grid, NTHREADS, 0, st>>>(im, fl, o, H, W, R, vec, oc); break;
  }
}

// The wide instance with 16-byte reads (above): groups of VEC = 16 /
// sizeof(T) channels (8 bf16, 4 float32). I: the index type.
template <typename T, typename I>
__global__ void __launch_bounds__(1024)
warp_bounded_wide_kernel(const T* __restrict__ image, const T* __restrict__ flow,
                         T* __restrict__ out, int H, int W, int C, float R) {
  constexpr int VEC = 16 / sizeof(T);
  const int G = C / VEC;                            // channel groups of a pixel
  const int GL = wide_lanes(G);                     // threads a pixel
  const int q = GL > 1 ? fast_div(threadIdx.x, fast_div_magic(GL)) : threadIdx.x;
  const int y = blockIdx.y * WIDE_TH + q / WIDE_TW, x = blockIdx.x * WIDE_TW + q % WIDE_TW;
  if (y >= H || x >= W) return;
  const I base = (I)blockIdx.z * H * W;             // flat index of (b, 0, 0)
  const I p = base + (I)y * W + x;

  const float fx = fminf(fmaxf(to_f(__ldcs(flow + 2 * p)), -R), R);
  const float fy = fminf(fmaxf(to_f(__ldcs(flow + 2 * p + 1)), -R), R);
  const float xs = (float)x + fx, ys = (float)y + fy;
  const float x0f = floorf(xs), y0f = floorf(ys);
  const int x0 = (int)x0f, y0 = (int)y0f;
  const float wx1 = xs - x0f, wy1 = ys - y0f;
  const float wx0 = 1.0f - wx1, wy0 = 1.0f - wy1;
  const float w[4] = {__fmul_rn(wy0, wx0), __fmul_rn(wy0, wx1), __fmul_rn(wy1, wx0),
                      __fmul_rn(wy1, wx1)};
  bool in[4];
  I src[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int yy = y0 + (k >> 1), xx = x0 + (k & 1);
    in[k] = yy >= 0 && yy < H && xx >= 0 && xx < W;
    src[k] = in[k] ? (base + (I)yy * W + xx) * C : 0;
  }

  for (int g0 = threadIdx.x - q * GL; g0 < G; g0 += GL * WIDE_IPT) {
    // Groups g0, g0 + GL, ...: every corner read in flight first.
    uint4 raw[WIDE_IPT][4];
#pragma unroll
    for (int i = 0; i < WIDE_IPT; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        raw[i][k] = in[k] && g0 + i * GL < G
                        ? __ldg(reinterpret_cast<const uint4*>(image + src[k] + (g0 + i * GL) * VEC))
                        : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < WIDE_IPT; ++i) {
      if (g0 + i * GL >= G) break;
      // sum = ((v00 w00 + v01 w01) + v10 w10) + v11 w11, no fused multiply-add.
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const T* v = reinterpret_cast<const T*>(&raw[i][k]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(to_f(v[e]), w[k]));
      }
      __align__(16) T o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = from_f<T>(acc[e]);
      __stcs(reinterpret_cast<uint4*>(out + p * C + (g0 + i * GL) * VEC),
             *reinterpret_cast<const uint4*>(o));
    }
  }
}

template <typename T, typename I>
void launch_wide(const T* im, const T* fl, T* o, int B, int H, int W, int C, float R,
                 cudaStream_t st) {
  const dim3 grid((W + WIDE_TW - 1) / WIDE_TW, (H + WIDE_TH - 1) / WIDE_TH, B);
  warp_bounded_wide_kernel<T, I>
      <<<grid, WIDE_TW * WIDE_TH * wide_lanes(C / (16 / (int)sizeof(T))), 0, st>>>(
          im, fl, o, H, W, C, R);
}

// The wide instance with one-element reads ("wide2b", 2-byte for bf16,
// 4-byte for float32): one thread per (pixel, group of GROUP channels),
// float32 blend in the order above.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
warp_bounded_wide_2b_kernel(const T* __restrict__ image, const T* __restrict__ flow,
                            T* __restrict__ out, int B, int H, int W, int C, float R) {
  const int groups = (C + GROUP - 1) / GROUP;
  const long long n = (long long)B * H * W * groups;
  const long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= n) return;
  const long long pix = i / groups;
  const int c0 = (int)(i - pix * groups) * GROUP;
  const int x = (int)(pix % W);
  const int y = (int)((pix / W) % H);
  const long long base = pix - ((long long)y * W + x);   // flat index of (b, 0, 0)

  const float fx = fminf(fmaxf(to_f(flow[2 * pix]), -R), R);
  const float fy = fminf(fmaxf(to_f(flow[2 * pix + 1]), -R), R);
  const float xs = (float)x + fx, ys = (float)y + fy;
  const float x0f = floorf(xs), y0f = floorf(ys);
  const int x0 = (int)x0f, y0 = (int)y0f, x1 = x0 + 1, y1 = y0 + 1;
  const float wx1 = xs - x0f, wy1 = ys - y0f;
  const float wx0 = 1.0f - wx1, wy0 = 1.0f - wy1;
  const float w[4] = {__fmul_rn(wy0, wx0), __fmul_rn(wy0, wx1),
                      __fmul_rn(wy1, wx0), __fmul_rn(wy1, wx1)};
  const int cy[4] = {y0, y0, y1, y1}, cx[4] = {x0, x1, x0, x1};
  const T* src[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    src[k] = (cy[k] >= 0 && cy[k] < H && cx[k] >= 0 && cx[k] < W)
                 ? image + (base + (long long)cy[k] * W + cx[k]) * C + c0
                 : nullptr;

  float acc[GROUP];
#pragma unroll
  for (int e = 0; e < GROUP; ++e) acc[e] = 0.0f;
  T* dst = out + pix * C + c0;
  const int nc = min(GROUP, C - c0);
  for (int k = 0; k < 4; ++k) {
    if (!src[k]) continue;
    for (int e = 0; e < nc; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(to_f(src[k][e]), w[k]));
  }
  for (int e = 0; e < nc; ++e) dst[e] = from_f<T>(acc[e]);
}

// One bounded warp of T elements: the RGB instance for C <= 4, else the
// wide one, 16-byte where C is a multiple of its group and the image and
// output are 16-byte aligned, else one element a read. `oc`: the output's
// pixel stride, C, or 8 for the bf16 RGB instance.
template <typename T>
int warp_launch(const void* image, const void* flow, void* out, int B, int H, int W, int C,
                int oc, float R, int device, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (C < 1 || B < 0 || H < 0 || W < 0 ||
      (oc != C && !(is_bf16<T>() && C <= MAXC && oc == 8)))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * H * W;
  if (n == 0) return (int)cudaSuccess;
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* im = static_cast<const T*>(image);
  const T* fl = static_cast<const T*>(flow);
  T* o = static_cast<T*>(out);
  if (C <= MAXC) {
    const bool vec = W % PPT == 0 &&
                     reinterpret_cast<uintptr_t>(flow) % (2 * PPT * sizeof(T)) == 0 &&
                     reinterpret_cast<uintptr_t>(out) % (oc == C ? PPT * sizeof(T) : 16) == 0;
    if (n * (oc > MAXC ? oc : MAXC) < (1LL << 31))   // every element index fits 32 bits
      launch_rgb<T, int>(im, fl, o, B, H, W, C, oc, R, vec, st);
    else
      launch_rgb<T, long long>(im, fl, o, B, H, W, C, oc, R, vec, st);
  } else if (C % VEC == 0 && reinterpret_cast<uintptr_t>(image) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    if (n * C < (1LL << 31))   // every element index fits 32 bits
      launch_wide<T, int>(im, fl, o, B, H, W, C, R, st);
    else
      launch_wide<T, long long>(im, fl, o, B, H, W, C, R, st);
  } else {
    const long long items = n * ((C + GROUP - 1) / GROUP);
    const unsigned blocks = (unsigned)((items + NTHREADS - 1) / NTHREADS);
    warp_bounded_wide_2b_kernel<T><<<blocks, NTHREADS, 0, st>>>(im, fl, o, B, H, W, C, R);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launch one bounded warp (any C >= 1: C <= 4 the bf16-rounded RGB
// instance, else the float32-blend wide one) into `out` of pixel stride
// `oc`: C, or 8 for C <= 4 (each pixel's channels past C written as
// zeros). Returns the cudaError_t of the launch.
extern "C" int vfi_warp_bounded_bf16(const void* image, const void* flow, void* out,
                                     int B, int H, int W, int C, int oc, float R,
                                     int device, void* stream) {
  return warp_launch<bf16>(image, flow, out, B, H, W, C, oc, R, device, stream);
}

// The float32 instances: the same function and instances on float32
// tensors, every product and sum IEEE float32 in ops/warp.py's order (the
// plain version's arithmetic: bit-exact). The wide 16-byte instance reads
// groups of 4 channels, so it takes C % 4 == 0; any other C > 4 takes the
// one-element instance. `oc` must be C.
extern "C" int vfi_warp_bounded_f32(const void* image, const void* flow, void* out,
                                    int B, int H, int W, int C, int oc, float R,
                                    int device, void* stream) {
  return warp_launch<float>(image, flow, out, B, H, W, C, oc, R, device, stream);
}

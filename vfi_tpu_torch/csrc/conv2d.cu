// One stride-1 square odd-k convolution + bias (+ ReLU), bf16 NHWC, zeros
// padding k / 2, float32 accumulation, one rounding of the output.
//
// Replaces: vfi_tpu/ops/pallas/conv.py::_conv_kernel (conv2d_pallas, the
// "im2col" and "direct" variants) and ::_conv_kernel_v2 (conv2d_pallas_v2,
// the packed-lane layout): the TPU kernels of the ConvBlock trunk outside
// fused mode and of tools/bench_conv.py. They compute one function; the
// variants are TPU layouts (a VMEM im2col buffer, one dot per tap, two
// pixels packed per 128-lane row) and none carries over: here each tap's
// A operand is read straight from the input tile in shared memory.
//
// What bounds it on this card: operations for the trunk's 3x3 layers (a
// 720p 64->64 layer does 68 GFLOP against ~0.24 GB of input and output,
// near the ~295 FLOP/byte ridge, and 128->64 twice the work), bytes for
// k = 1 and for narrow layers.
//
// Design: an implicit GEMM on the tensor cores (WMMA bf16 16x16x16, float32
// accumulators kept in registers over all taps and channels). A block owns
// PX = 64 output pixels of one row and every output channel (Cout16 <= 128:
// 4 x Cout16/16 fragments over 8 warps, at most 4 a warp). It walks the
// input channels in chunks of at most CK = 64 (Cin padded to a multiple of
// 16, the WMMA depth, with zero channels): per chunk it copies the input
// rows py - m .. py + m, columns px0 - m .. px0 + 63 + m of those channels
// into shared memory once (cp.async; zeros outside the image), then for
// each of the k*k taps (i, j) multiplies the tile by the tap's weight
// slice W[t][chunk][Cout16]. The 16 pixels of an output m-tile read 16
// consecutive tile columns starting at column j of tile row i, so the A
// operand is the tile itself at an offset, with the channel pitch as its
// leading dimension: no im2col buffer. Weight slices stream into shared
// memory double-buffered (cp.async) while the previous tap multiplies.
// Epilogue: the bias (float32 of its bf16 value), the ReLU, one rounding
// to bf16. Cin must be a multiple of 8 (16-byte copies); the wrapper pads
// another input with zero channels. Making it fast (wgmma, TMA, several
// rows a block) is later work.

#include <mma.h>
#include <stdint.h>

#include "common.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int PX = 64;            // output pixels per block (one row segment)
constexpr int CK = 64;            // input channels per staged chunk
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int XPAD = 16;          // tile channel-pitch padding (bank spread, 32 B rows)
constexpr int WPAD = 8;           // weight-row padding (bank spread)
constexpr int MAX_COUT = 128;
constexpr int MAX_K = 9;
constexpr int MAXJ = (PX / 16) * (MAX_COUT / 16) / NWARPS;  // accumulators per warp
constexpr int SCRATCH_BYTES = NWARPS * 256 * 4;             // epilogue, 16x16 f32 a warp

struct ConvParams {
  const bf16* x;        // (B, H, W, Cin)
  const bf16* w;        // (K * K * Cin16, Cout16), row t * Cin16 + c, zero padded
  const float* bias;    // (Cout16,), zero padded
  bf16* out;            // (B, H, W, Cout)
  int B, H, W, Cin, Cout, K, Cin16, Cout16, ck, act;
  int x_bytes;          // the tile region; the weight slices follow it
};

struct ConvSmem {
  int ck, x_bytes, w_bytes, total;
};

__host__ inline ConvSmem conv_smem(int Cin, int Cout, int K) {
  ConvSmem m;
  const int cin16 = pad16(Cin), cout16 = pad16(Cout);
  m.ck = cin16 < CK ? cin16 : CK;
  m.x_bytes = round128(K * (PX + K - 1) * (m.ck + XPAD) * 2);
  const int wb = round128(2 * m.ck * (cout16 + WPAD) * 2);
  m.w_bytes = wb > SCRATCH_BYTES ? wb : SCRATCH_BYTES;
  m.total = m.x_bytes + m.w_bytes;
  return m;
}

__global__ void __launch_bounds__(NTHREADS)
conv2d_kernel(const ConvParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = p.K, m = K / 2, taps = K * K;
  const int tcols = PX + K - 1;
  const int ck = p.ck, xp = ck + XPAD;
  const int Cin = p.Cin, Cin16 = p.Cin16, Cout16 = p.Cout16, wp = Cout16 + WPAD;
  bf16* X = reinterpret_cast<bf16*>(smem);                  // [K * tcols][xp]
  bf16* Wt = reinterpret_cast<bf16*>(smem + p.x_bytes);     // [2][ck][wp]

  const int px0 = blockIdx.x * PX, py = blockIdx.y, b = blockIdx.z;
  const int H = p.H, W = p.W;
  const int nsteps = (Cin16 + ck - 1) / ck * taps;          // (chunk, tap) pairs

  auto chunk_width = [&](int c) { return min(ck, Cin16 - c * ck); };

  // Chunk c of the input tile: rows py-m .. py+m, columns px0-m ..
  // px0+PX-1+m; zeros outside the image and past Cin.
  auto stage_x = [&](int c) {
    const int pieces = chunk_width(c) / 8;
    const bf16* xb = p.x + (size_t)b * H * W * Cin;
    for (int it = threadIdx.x; it < K * tcols * pieces; it += NTHREADS) {
      const int pix = it / pieces, pc = it - (it / pieces) * pieces;
      const int gy = py - m + pix / tcols, gx = px0 - m + pix % tcols;
      const int ch = c * ck + pc * 8;
      bf16* dst = X + (size_t)pix * xp + pc * 8;
      if (ch < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
        cp_async16(dst, xb + ((size_t)gy * W + gx) * Cin + ch);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
  };
  // The weight slice of step s = (chunk, tap): rows t * Cin16 + c * ck ...
  auto stage_w = [&](int s, int buf) {
    const int c = s / taps, t = s - (s / taps) * taps;
    const bf16* src = p.w + ((size_t)t * Cin16 + c * ck) * Cout16;
    bf16* dst = Wt + buf * ck * wp;
    const int rc = Cout16 / 8;
    for (int i = threadIdx.x; i < chunk_width(c) * rc; i += NTHREADS) {
      const int k = i / rc, j = i - (i / rc) * rc;
      cp_async16(dst + k * wp + j * 8, src + (size_t)k * Cout16 + j * 8);
    }
    cp_async_commit();
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntn = Cout16 / 16, items = (PX / 16) * ntn;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXJ];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) wmma::fill_fragment(acc[j], 0.0f);

  stage_w(0, 0);
  for (int s = 0; s < nsteps; ++s) {
    const int c = s / taps, t = s - (s / taps) * taps;
    // The previous step ended at a barrier: the tile and the other weight
    // buffer are free.
    if (t == 0) stage_x(c);
    if (s + 1 < nsteps) {
      stage_w(s + 1, (s + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int ti = t / K, tj = t - (t / K) * K, ckw = chunk_width(c);
    const bf16* wb = Wt + (s & 1) * ck * wp;
    const bf16* xa = X + (size_t)(ti * tcols + tj) * xp;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int item = warp + j * NWARPS;
      if (item < items) {
        const int mt = item / ntn, nt = item - (item / ntn) * ntn;
        for (int k0 = 0; k0 < ckw; k0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afr;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(afr, xa + (size_t)mt * 16 * xp + k0, xp);
          wmma::load_matrix_sync(bfr, wb + k0 * wp + nt * 16, wp);
          wmma::mma_sync(acc[j], afr, bfr, acc[j]);
        }
      }
    }
    __syncthreads();
  }

  // Epilogue: bias, ReLU, one rounding, bf16 out at Cout channels. The
  // weight buffers are free: scratch.
  float* scr = reinterpret_cast<float*>(Wt) + warp * 256;
  const int r = lane >> 1, c8 = (lane & 1) * 8;
  const bool vec_out = (p.Cout % 8) == 0;
  const size_t row0 = ((size_t)b * H + py) * W;
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int item = warp + j * NWARPS;
    if (item >= items) continue;
    const int mt = item / ntn, nt = item - (item / ntn) * ntn;
    wmma::store_matrix_sync(scr, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    const int px = px0 + mt * 16 + r;
    const int ch0 = nt * 16 + c8;
    if (px < W && ch0 < p.Cout) {
      __align__(16) bf16 o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float v = scr[r * 16 + c8 + e] + p.bias[ch0 + e];
        o[e] = __float2bfloat16_rn(p.act ? fmaxf(v, 0.0f) : v);
      }
      bf16* dst = p.out + (row0 + px) * p.Cout + ch0;
      if (vec_out) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (ch0 + e < p.Cout) dst[e] = o[e];
      }
    }
    __syncwarp();
  }
}

}  // namespace

// Launch one conv (odd K <= 9, Cin % 8 == 0, 1 <= Cout <= 128; act != 0
// fuses the ReLU). Returns the cudaError_t of the launch; the kernel runs
// on `stream`.
extern "C" int vfi_conv2d_bf16(const void* x, const void* w, const void* bias, void* out,
                               int B, int H, int W, int Cin, int Cout, int K, int act,
                               int device, void* stream) {
  if (Cin < 8 || Cin % 8 != 0 || Cout < 1 || Cout > MAX_COUT || K < 1 || K % 2 == 0 ||
      K > MAX_K)
    return (int)cudaErrorInvalidValue;
  ConvParams p{};
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<bf16*>(out);
  p.B = B; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout; p.K = K;
  p.Cin16 = pad16(Cin); p.Cout16 = pad16(Cout); p.act = act ? 1 : 0;
  const ConvSmem m = conv_smem(Cin, Cout, K);
  p.ck = m.ck;
  p.x_bytes = m.x_bytes;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(conv2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             m.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + PX - 1) / PX, H, B);
  conv2d_kernel<<<grid, NTHREADS, m.total, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

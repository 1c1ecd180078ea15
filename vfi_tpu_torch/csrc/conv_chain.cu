// Fused stride-1 3x3 conv chain, bf16 NHWC, float32 accumulation.
//
// Replaces: vfi_tpu/ops/pallas/conv.py::_chain_kernel (conv_chain_pallas),
// the TPU kernel behind every trunk chain of EMAVFI (feature blocks,
// motion estimation, reconstruction, each DCN's offset conv as L = 1).
//
// What bounds it on this card: arithmetic. The 720p chains do 34-136
// GFLOP per layer against 0.1-0.3 GB of traffic, far above the card's
// ~295 FLOP/byte ridge, so the tensor cores are the limit; a layer-by-layer
// version would add an HBM round trip of every intermediate.
//
// Design: one launch per chain. A block owns a TH x TW output tile and
// keeps the tile's input with its 2L-pixel halo in shared memory, then
// each layer's output (halo shrinking by one pixel per layer) in a second
// buffer, ping-ponging; only the last layer writes to device memory.
// Every layer is an implicit GEMM on the tensor cores (WMMA bf16 16x16x16,
// float32 accumulators): rows are tile pixels, K runs over 9 taps x Cin,
// N over Cout. All layers use one pixel pitch Wp = TW + 2L, so a run of 16
// consecutive output rows reads 16 consecutive input pixels for every tap
// (the flat-shift trick); the few junk columns this computes are never
// read back. Intermediates at positions outside the image are stored as
// 0, not relu(bias): each layer of the unfused chain zero-pads its own
// input, and the TPU kernel re-zeroes those rows for the same reason.
// Each warp keeps the accumulators of up to three 16-row tiles across the
// whole K loop; all warps walk the 9 taps in step while the next tap's
// weight slice streams into shared memory (cp.async, double-buffered), so
// both WMMA operands come from shared memory. Making this kernel fast for
// real (wgmma, TMA, warp specialisation) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 8;            // output tile rows
constexpr int TW = 16;           // output tile columns
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAXL = 4;
constexpr int SLACK_PX = 32;     // reads of the last 16-row tile run past the region
constexpr int CPAD = 16;         // channel-pitch padding (bank spread, 32 B aligned)
constexpr int WPAD = 8;          // weight-row padding in shared memory (bank spread)
constexpr int MT_MAX = 3;        // m-tiles per warp: (TH + 2L - 2) * Wp <= 16 * NWARPS * MT_MAX

struct ChainParams {
  const bf16* x;                 // (B, H, W, c[0])
  const bf16* w;                 // per layer [9][cinp][coutp]
  const float* bias;             // per layer [coutp]
  bf16* out;                     // (B, H, W, c[L])
  int B, H, W, L, Wp;
  int cin[MAXL], cinp[MAXL], cout[MAXL], coutp[MAXL];
  int cpitch[MAXL];              // smem channel pitch of layer l's input
  long long w_off[MAXL];
  int b_off[MAXL];
  int act_mask;
  int bufA_bytes, bufB_bytes;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One layer. Every warp owns the m-tiles warp, warp + NWARPS, ... (at most
// MT_MAX) and keeps their accumulators across the whole K loop; all warps
// walk the 9 taps in step while the next tap's weight slice [cinp][coutp]
// streams into the other half of `wbuf` (cp.async, double-buffered).
template <int NT>
__device__ void chain_layer(const ChainParams& p, int l, const bf16* __restrict__ in,
                            bf16* __restrict__ obuf, bf16* wbuf,
                            int ty0, int tx0, int b) {
  const int L = p.L, Wp = p.Wp;
  const int halo = L - 1 - l;
  const int rows_out = TH + 2 * halo;
  const int wout = TW + 2 * halo;
  const int mvalid = rows_out * Wp;
  const int mtiles = (mvalid + 15) / 16;
  const int cinp = p.cinp[l], coutp = p.coutp[l];
  const int wpitch = coutp + WPAD;
  const int slice = cinp * wpitch;
  const int cp_in = p.cpitch[l];
  const bool last = (l == L - 1);
  const int cp_out = last ? 0 : p.cpitch[l + 1];
  const bool act = (p.act_mask >> l) & 1;
  const bf16* __restrict__ w = p.w + p.w_off[l];
  const float* __restrict__ bias = p.bias + p.b_off[l];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nmine = warp < mtiles ? min(MT_MAX, (mtiles - warp + NWARPS - 1) / NWARPS) : 0;

  const int row_chunks = coutp / 8;
  const int nchunks = cinp * row_chunks;
  auto stage = [&](int t, int buf) {
    const bf16* src = w + (size_t)t * cinp * coutp;
    bf16* dst = wbuf + buf * slice;
    for (int c = threadIdx.x; c < nchunks; c += NTHREADS) {
      const int k = c / row_chunks, j = c - (c / row_chunks) * row_chunks;
      cp_async16(dst + k * wpitch + j * 8, src + (size_t)k * coutp + j * 8);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT_MAX][NT];
#pragma unroll
  for (int m = 0; m < MT_MAX; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) wmma::fill_fragment(acc[m][n], 0.0f);

  stage(0, 0);
  for (int t = 0; t < 9; ++t) {
    if (t + 1 < 9) {
      stage(t + 1, (t + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* wt = wbuf + (t & 1) * slice;
    const int di = t / 3, dj = t - 3 * (t / 3);
    const bf16* abase = in + (size_t)(warp * 16 + di * Wp + dj) * cp_in;
    for (int k0 = 0; k0 < cinp; k0 += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        wmma::load_matrix_sync(bfr[n], wt + k0 * wpitch + n * 16, wpitch);
#pragma unroll
      for (int m = 0; m < MT_MAX; ++m) {
        if (m < nmine) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afr;
          wmma::load_matrix_sync(
              afr, abase + (size_t)m * NWARPS * 16 * cp_in + k0, cp_in);
#pragma unroll
          for (int n = 0; n < NT; ++n) wmma::mma_sync(acc[m][n], afr, bfr[n], acc[m][n]);
        }
      }
    }
    __syncthreads();  // all warps are done with this tap's slice
  }

  // Epilogue: bias, ReLU, zero outside the image, round to bf16. The weight
  // buffer is free now and serves as each warp's 16x16 f32 scratch.
  float* scratch = reinterpret_cast<float*>(wbuf) + warp * 256;
  const int r = lane >> 1, c8 = (lane & 1) * 8;
#pragma unroll
  for (int m = 0; m < MT_MAX; ++m) {
    if (m >= nmine) continue;
    const int q = (warp + m * NWARPS) * 16 + r;
    const int py = q / Wp, px = q - (q / Wp) * Wp;
    const int gy = ty0 - halo + py, gx = tx0 - halo + px;
    const bool inimg = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      wmma::store_matrix_sync(scratch, acc[m][n], 16, wmma::mem_row_major);
      __syncwarp();
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float f = scratch[r * 16 + c8 + e] + bias[n * 16 + c8 + e];
        v[e] = act ? fmaxf(f, 0.0f) : f;
      }
      if (!last) {
        if (q < mvalid) {
          const bool keep = inimg && px < wout;
          __align__(16) bf16 o[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16_rn(keep ? v[e] : 0.0f);
          *reinterpret_cast<uint4*>(obuf + (size_t)q * cp_out + n * 16 + c8) =
              *reinterpret_cast<const uint4*>(o);
        }
      } else if (q < mvalid && px < wout && inimg) {
        const int cl = p.cout[l];
        bf16* dst = p.out + (((size_t)b * p.H + gy) * p.W + gx) * cl;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ch = n * 16 + c8 + e;
          if (ch < cl) dst[ch] = __float2bfloat16_rn(v[e]);
        }
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(NTHREADS)
conv_chain_kernel(const ChainParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* bufA = reinterpret_cast<bf16*>(smem);
  bf16* bufB = reinterpret_cast<bf16*>(smem + p.bufA_bytes);
  bf16* wbuf = reinterpret_cast<bf16*>(smem + p.bufA_bytes + p.bufB_bytes);
  const int tx0 = blockIdx.x * TW, ty0 = blockIdx.y * TH, b = blockIdx.z;
  const int L = p.L, Wp = p.Wp;

  // Stage the input tile with its L-pixel halo (zeros outside the image).
  {
    const int cin = p.cin[0], cp = p.cpitch[0];
    const int chunks = cin / 8;
    const int npx = (TH + 2 * L) * Wp;
    const int total = (npx + SLACK_PX) * chunks;
    for (int idx = threadIdx.x; idx < total; idx += NTHREADS) {
      const int pix = idx / chunks, ch = idx - (idx / chunks) * chunks;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (pix < npx) {
        const int rr = pix / Wp, cc = pix - (pix / Wp) * Wp;
        const int gy = ty0 - L + rr, gx = tx0 - L + cc;
        if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W)
          v = __ldg(reinterpret_cast<const uint4*>(
              p.x + (((size_t)b * p.H + gy) * p.W + gx) * cin + ch * 8));
      }
      *reinterpret_cast<uint4*>(bufA + (size_t)pix * cp + ch * 8) = v;
    }
  }
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const bf16* in = (l & 1) ? bufB : bufA;
    bf16* ob = (l & 1) ? bufA : bufB;
    switch (p.coutp[l] / 16) {
      case 1: chain_layer<1>(p, l, in, ob, wbuf, ty0, tx0, b); break;
      case 2: chain_layer<2>(p, l, in, ob, wbuf, ty0, tx0, b); break;
      case 3: chain_layer<3>(p, l, in, ob, wbuf, ty0, tx0, b); break;
      default: chain_layer<4>(p, l, in, ob, wbuf, ty0, tx0, b); break;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" const char* vfi_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch one chain. c0..c4 are the channel counts (c0 = input, c[l+1] =
// layer l's output); entries past L are ignored. Returns the cudaError_t of
// the launch (0 = launched); the kernel runs on `stream`.
extern "C" int vfi_conv_chain_bf16(const void* x, const void* w, const void* bias,
                                   void* out, int B, int H, int W, int L,
                                   int c0, int c1, int c2, int c3, int c4,
                                   int act_mask, int device, void* stream) {
  if (L < 1 || L > MAXL) return (int)cudaErrorInvalidValue;
  const int c[MAXL + 1] = {c0, c1, c2, c3, c4};
  if (c0 % 16 != 0) return (int)cudaErrorInvalidValue;
  ChainParams p{};
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<bf16*>(out);
  p.B = B; p.H = H; p.W = W; p.L = L; p.Wp = TW + 2 * L;
  p.act_mask = act_mask;
  long long woff = 0;
  int boff = 0;
  for (int l = 0; l < L; ++l) {
    p.cin[l] = c[l];
    p.cinp[l] = l == 0 ? c[0] : p.coutp[l - 1];
    p.cout[l] = c[l + 1];
    p.coutp[l] = (c[l + 1] + 15) / 16 * 16;
    if (p.coutp[l] > 64 || c[l + 1] < 1) return (int)cudaErrorInvalidValue;
    p.cpitch[l] = p.cinp[l] + CPAD;
    p.w_off[l] = woff;
    p.b_off[l] = boff;
    woff += 9LL * p.cinp[l] * p.coutp[l];
    boff += p.coutp[l];
  }
  if ((TH + 2 * (L - 1)) * p.Wp > 16 * NWARPS * MT_MAX) return (int)cudaErrorInvalidValue;
  int bytesA = 0, bytesB = 0, bytesW = NWARPS * 256 * 4;  // W doubles as epilogue scratch
  for (int l = 0; l < L; ++l) {
    const int wbytes = 2 * p.cinp[l] * (p.coutp[l] + WPAD) * 2;
    bytesW = bytesW > wbytes ? bytesW : wbytes;
    const int rows_in = TH + 2 * (L - l);
    const int bytes = ((rows_in * p.Wp + SLACK_PX) * p.cpitch[l] * 2 + 127) / 128 * 128;
    if (l & 1) bytesB = bytesB > bytes ? bytesB : bytes;
    else bytesA = bytesA > bytes ? bytesA : bytes;
  }
  p.bufA_bytes = bytesA;
  p.bufB_bytes = bytesB;
  const int smem = bytesA + bytesB + bytesW;

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(conv_chain_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  conv_chain_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

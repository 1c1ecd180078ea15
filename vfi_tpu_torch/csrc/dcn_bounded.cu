// Bounded modulated deformable conv (DCNv2), bf16 NHWC, stride 1, 3x3,
// padding 1, one offset group, offsets clamped to [-R, R], optional mask
// (none means weight 1), Cin a multiple of 8 (the wrapper pads any other),
// Cout up to 128, any R whose smallest tile plan fits (below).
//
// Replaces: vfi_tpu/ops/pallas/sampling.py::_sampling_kernel_v4
// (deform_conv2d_pallas_v4, the route of dcn_kernel="v4", the JAX
// package's default), ::_sampling_kernel_v5 (deform_conv2d_pallas_v5,
// dcn_kernel="v5") and ::_sampling_kernel (deform_conv2d_pallas, v3, the
// kernel of tools/bench_kernels.py): the TPU kernels of EMAVFI's three
// fusion DCNs, which compute one function. The TPU had no fast gather, so its kernels
// decomposed each bounded sample into (2R+1)^2 statically shifted reads
// and padded the channels to 128 lanes; a GPU gathers from shared memory
// cheaply, so this kernel samples directly and pads the channels to 16.
//
// What bounds it on this card: at 720p one 64-channel layer moves ~0.29 GB
// (input, offsets, mask, output) against 68 GFLOP of contraction, just
// below the ~295 FLOP/byte ridge: bytes bound it, the tensor cores close
// behind. The bilinear gather (4 corners x 9 taps per pixel, each
// a row of channels) would read ~4 GB per layer through L2 if it went to
// global memory; this design reads each input pixel into shared memory
// once per block instead, and keeps the weights there too.
//
// Channels: Cin and Cout are padded to Cin16, Cout16 (multiples of 16, the
// WMMA depth and width) with zero channels in shared memory and zero rows
// and columns in the packed weight [9 * Cin16][Cout16]; the output is
// written at Cout channels. The input tile is copied in 16-byte rows of 8
// channels (cp.async), so the kernel takes Cin % 8 == 0. The reference
// topology's 67-channel fusion stack (64 features + RGB) makes a pixel row
// 134 bytes, not 16-byte aligned: the wrapper pads such an x to 72
// channels (one pass over x, counted in the kernel's time). Gathering
// the tile with 2-byte loads inside the kernel instead took 9.2 ms
// against 6.9 ms with the pad (C=67, R=2, 4 x 480 x 640, H100): at one
// block per SM the serial loads' latency was exposed. Cout % 8 != 0 is
// written with 2-byte stores.
//
// Design: a block owns PX output pixels of one row. It
//   1. computes per (pixel, tap) the clamped float32 sample position, its
//      four corners in the block's input tile -- rows py-1-R .. py+1+R,
//      columns px0-1-R .. px0+PX+R -- (none outside the image) and the
//      four bilinear weights times the tap's mask;
//   2. copies that tile into shared memory (cp.async, zeros outside the
//      image), all of Cin16 at once or, where that does not fit, in
//      channel chunks of CK, one after the other;
//   3. walks the steps (chunk, tap): for each it builds the modulated
//      sample slab S[PX][CK] -- each entry the float32 blend of four
//      corners read from the tile, rounded once to bf16, the working dtype
//      the TPU kernel's sample buffer holds -- and multiplies it by the
//      tap's weight slice W[CK][Cout16] on the tensor cores (WMMA bf16,
//      float32 accumulators kept in registers across all steps; warp w
//      owns fragments w, w + 8, ... of the PX/16 x Cout16/16 grid, so at
//      PX = 64 Cout16 = 80 splits 3/2 over the 8 warps). S and W are
//      double-buffered: the next step's slab is built and its weight slice
//      streams in (cp.async) while this step multiplies; the next chunk of
//      the tile is copied while the last tap of this one multiplies;
//   4. adds the bias and writes bf16 -- one rounding of the output.
// Shared memory grows with (3 + 2R)(PX + 2 + 2R) CK. The launch picks the
// plan (dcn_plan; vfi_dcn_bounded_smem_bytes reports it): PX = 64 with the
// whole Cin16 where that fits the card's per-block limit (227 KB on
// Hopper), else PX = 32, then 16; where even 16 pixels do not fit, PX = 16
// with the tile in n chunks of CK = pad16(Cin16 / n) channels, for the
// least n that fits. On an H100 (232,448 bytes a block), with Cout = Cin:
// C = 64 takes PX = 64 up to R = 7; C = 67 PX = 64 up to R = 5 and 32 up
// to R = 8; C = 128 PX = 64 at R = 1, 32 at R = 2..4, 16 at R = 5..7 and
// two 64-channel chunks at R = 8. Every C up to 128 runs up to R = 35.

#include <mma.h>
#include <stdint.h>

#include "common.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTAPS = 9;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int SPAD = 16;          // S row padding (bank spread, 32 B aligned rows)
constexpr int WPAD = 8;           // W row padding (bank spread)
constexpr int MAX_COUT = 128;
constexpr int SCRATCH_BYTES = NWARPS * 256 * 4;   // epilogue, 16x16 f32 a warp

struct DcnParams {
  const bf16* x;        // (B, H, W, Cin)
  const bf16* offset;   // (B, H, W, 18): (dy, dx) of tap t at 2t, 2t + 1
  const bf16* mask;     // (B, H, W, 9), or null: weight 1
  const bf16* w;        // (9 * Cin16, Cout16), row t * Cin16 + c, zero padded
  const float* bias;    // (Cout16,), zero padded
  bf16* out;            // (B, H, W, Cout)
  int B, H, W, Cin, Cout, R, Cin16, Cout16;
  int ck;                          // tile channels per chunk
  int x_bytes, s_bytes, w_bytes;   // shared-memory regions
};

// One launch's tile plan: PX output pixels a block, the input tile in
// chunks of ck channels, and its shared-memory regions: the tile, the two
// sample slabs, the two weight slices, the taps' corner indices and
// weights. total == 0: no plan fits.
struct DcnPlan {
  int px, ck, x_bytes, s_bytes, w_bytes, total;
};

__host__ inline DcnPlan dcn_plan_at(int px, int ck, int cout16, int R) {
  DcnPlan m;
  m.px = px;
  m.ck = ck;
  m.x_bytes = round128((3 + 2 * R) * (px + 2 + 2 * R) * ck * 2);
  const int sb = 2 * px * (ck + SPAD) * 2;
  m.s_bytes = round128(sb > SCRATCH_BYTES ? sb : SCRATCH_BYTES);
  m.w_bytes = round128(2 * ck * (cout16 + WPAD) * 2);
  m.total = m.x_bytes + m.s_bytes + m.w_bytes + px * NTAPS * 4 * 8;
  return m;
}

__host__ inline DcnPlan dcn_plan(int Cin, int Cout, int R, int limit) {
  const int cin16 = pad16(Cin), cout16 = pad16(Cout);
  const int pxs[3] = {64, 32, 16};
  for (int px : pxs) {
    const DcnPlan m = dcn_plan_at(px, cin16, cout16, R);
    if (m.total <= limit) return m;
  }
  int last = cin16;
  for (int n = 2; n <= cin16 / 16; ++n) {
    const int ck = pad16((cin16 + n - 1) / n);
    if (ck == last) continue;
    last = ck;
    const DcnPlan m = dcn_plan_at(16, ck, cout16, R);
    if (m.total <= limit) return m;
  }
  return DcnPlan{0, 0, 0, 0, 0, 0};
}

// CHUNKED: the tile in several channel chunks (ck < Cin16); else one chunk
// of all Cin16 channels and a loop of exactly the 9 taps.
template <int PX, bool CHUNKED>
__global__ void __launch_bounds__(NTHREADS)
dcn_bounded_kernel(const DcnParams p) {
  constexpr int MAXJ = (PX / 16) * (MAX_COUT / 16) / NWARPS;  // accumulators per warp
  extern __shared__ __align__(128) unsigned char smem[];
  const int Cin = p.Cin, Cout = p.Cout, R = p.R;
  const int Cin16 = p.Cin16, Cout16 = p.Cout16, ck = CHUNKED ? p.ck : p.Cin16;
  const int trows = 3 + 2 * R, tcols = PX + 2 + 2 * R;
  const int kp = ck + SPAD, wp = Cout16 + WPAD;
  const int nsteps = CHUNKED ? (Cin16 + ck - 1) / ck * NTAPS : NTAPS;  // (chunk, tap) pairs
  bf16* X = reinterpret_cast<bf16*>(smem);                               // [trows*tcols][ck]
  bf16* S = reinterpret_cast<bf16*>(smem + p.x_bytes);                   // [2][PX][kp]
  bf16* Wt = reinterpret_cast<bf16*>(smem + p.x_bytes + p.s_bytes);      // [2][ck][wp]
  int* cidx = reinterpret_cast<int*>(smem + p.x_bytes + p.s_bytes + p.w_bytes);  // [PX*9][4]
  float* cwt = reinterpret_cast<float*>(cidx + PX * NTAPS * 4);                  // [PX*9][4]

  const int px0 = blockIdx.x * PX, py = blockIdx.y, b = blockIdx.z;
  const int H = p.H, W = p.W;
  const int ty0 = py - 1 - R, tx0 = px0 - 1 - R;   // image position of tile (0, 0)
  const size_t row0 = ((size_t)b * H + py) * W;    // flat pixel index of (b, py, 0)

  auto chunk_width = [&](int c) { return CHUNKED ? min(ck, Cin16 - c * ck) : Cin16; };

  // Chunk c of the reachable input tile (channels past Cin zero).
  auto stage_x = [&](int c) {
    const int pieces = chunk_width(c) / 8;
    const bf16* xb = p.x + (size_t)b * H * W * Cin;
    for (int it = threadIdx.x; it < trows * tcols * pieces; it += NTHREADS) {
      const int pix = it / pieces, pc = it - (it / pieces) * pieces;
      const int gy = ty0 + pix / tcols, gx = tx0 + pix % tcols;
      const int ch = c * ck + pc * 8;
      bf16* dst = X + (size_t)pix * ck + pc * 8;
      if (ch < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
        cp_async16(dst, xb + ((size_t)gy * W + gx) * Cin + ch);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
  };
  // The weight slice of step s = (chunk, tap): rows t * Cin16 + c * ck ...
  auto stage_w = [&](int s, int buf) {
    const int c = CHUNKED ? s / NTAPS : 0, t = CHUNKED ? s - c * NTAPS : s;
    const bf16* src = p.w + ((size_t)t * Cin16 + c * ck) * Cout16;
    bf16* dst = Wt + buf * ck * wp;
    const int rc = Cout16 / 8;
    for (int i = threadIdx.x; i < chunk_width(c) * rc; i += NTHREADS) {
      const int k = i / rc, j = i - (i / rc) * rc;
      cp_async16(dst + k * wp + j * 8, src + (size_t)k * Cout16 + j * 8);
    }
    cp_async_commit();
  };

  // 1-2. The first chunk of the tile and weight slice in flight, the
  //      taps' corners and weights meanwhile.
  stage_x(0);
  stage_w(0, 0);
  for (int it = threadIdx.x; it < PX * NTAPS; it += NTHREADS) {
    const int pl = it / NTAPS, t = it - (it / NTAPS) * NTAPS;
    const int px = px0 + pl;
    int ci[4] = {-1, -1, -1, -1};
    float cw[4] = {0.f, 0.f, 0.f, 0.f};
    if (px < W) {
      const size_t pix = row0 + px;
      const float r = (float)R;
      float dy = __bfloat162float(p.offset[pix * 18 + 2 * t]);
      float dx = __bfloat162float(p.offset[pix * 18 + 2 * t + 1]);
      const float m = p.mask ? __bfloat162float(p.mask[pix * 9 + t]) : 1.0f;
      dy = fminf(fmaxf(dy, -r), r);
      dx = fminf(fmaxf(dx, -r), r);
      const float ty = (float)(py + t / 3 - 1) + dy;
      const float tx = (float)(px + t % 3 - 1) + dx;
      const float y0f = floorf(ty), x0f = floorf(tx);
      const float fy = ty - y0f, fx = tx - x0f;
      const int y0 = (int)y0f, x0 = (int)x0f;
      const float wy[2] = {1.0f - fy, fy};
      const float wx[2] = {1.0f - fx, fx};
#pragma unroll
      for (int cy = 0; cy < 2; ++cy)
#pragma unroll
        for (int cx = 0; cx < 2; ++cx) {
          const int yy = y0 + cy, xx = x0 + cx;
          const int ry = yy - ty0, rx = xx - tx0;
          // A corner past the tile has weight exactly 0 (offsets are
          // clamped to [-R, R]); one outside the image reads 0.
          if (yy >= 0 && yy < H && xx >= 0 && xx < W && ry >= 0 && ry < trows &&
              rx >= 0 && rx < tcols) {
            ci[cy * 2 + cx] = ry * tcols + rx;
            cw[cy * 2 + cx] = __fmul_rn(__fmul_rn(wy[cy], wx[cx]), m);
          }
        }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      cidx[it * 4 + c] = ci[c];
      cwt[it * 4 + c] = cw[c];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // S[pixel][c] of step s = bf16(sum over corners of weight * x), float32
  // blend, from the tile chunk in shared memory.
  auto build_s = [&](int s, int buf) {
    const int c = CHUNKED ? s / NTAPS : 0, t = CHUNKED ? s - c * NTAPS : s;
    const int pieces = chunk_width(c) / 8;
    bf16* sb = S + buf * PX * kp;
    for (int it = threadIdx.x; it < PX * pieces; it += NTHREADS) {
      const int pl = it / pieces, pc = it - (it / pieces) * pieces;
      const int pt = pl * NTAPS + t;
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int idx = cidx[pt * 4 + q];
        if (idx >= 0) {
          const float wgt = cwt[pt * 4 + q];
          const uint4 raw = *reinterpret_cast<const uint4*>(X + (size_t)idx * ck + pc * 8);
          const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(v2[e]);
            acc[2 * e] = __fadd_rn(acc[2 * e], __fmul_rn(wgt, f.x));
            acc[2 * e + 1] = __fadd_rn(acc[2 * e + 1], __fmul_rn(wgt, f.y));
          }
        }
      }
      __align__(16) bf16 o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16_rn(acc[e]);
      *reinterpret_cast<uint4*>(sb + pl * kp + pc * 8) = *reinterpret_cast<const uint4*>(o);
    }
  };

  // 3. Steps: out[PX][Cout16] += S_s @ W_s. Warp w owns output fragments
  //    w, w + NWARPS, ... of the (PX/16) x (Cout16/16) grid.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntn = Cout16 / 16, items = (PX / 16) * ntn;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXJ];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) wmma::fill_fragment(acc[j], 0.0f);
  build_s(0, 0);
  stage_w(1, 1);
  __syncthreads();
  for (int s = 0; s < nsteps; ++s) {
    // The last tap of a chunk: every slab of this chunk is built, so the
    // tile is free for the next chunk, copied while this step multiplies.
    const bool next_chunk = CHUNKED && s % NTAPS == NTAPS - 1 && s + 1 < nsteps;
    if (next_chunk) stage_x(s / NTAPS + 1);
    const bf16* sb = S + (s & 1) * PX * kp;
    const bf16* wb = Wt + (s & 1) * ck * wp;
    const int ckw = chunk_width(CHUNKED ? s / NTAPS : 0);
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int item = warp + j * NWARPS;
      if (item < items) {
        const int mt = item / ntn, nt = item - (item / ntn) * ntn;
        for (int k0 = 0; k0 < ckw; k0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afr;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(afr, sb + mt * 16 * kp + k0, kp);
          wmma::load_matrix_sync(bfr, wb + k0 * wp + nt * 16, wp);
          wmma::mma_sync(acc[j], afr, bfr, acc[j]);
        }
      }
    }
    if (s + 1 < nsteps) {
      if (next_chunk) {
        cp_async_wait<0>();
        __syncthreads();   // the next chunk of the tile is in
      }
      build_s(s + 1, (s + 1) & 1);
    }
    cp_async_wait<0>();
    __syncthreads();   // S_{s+1}, W_{s+1} ready; S_s, W_s free
    if (s + 2 < nsteps) stage_w(s + 2, s & 1);
  }

  // 4. Bias, one rounding, bf16 out at Cout channels. The S buffers are
  //    free: scratch.
  float* scr = reinterpret_cast<float*>(S) + warp * 256;
  const int r = lane >> 1, c8 = (lane & 1) * 8;
  const bool vec_out = (Cout % 8) == 0;
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int item = warp + j * NWARPS;
    if (item >= items) continue;
    const int mt = item / ntn, nt = item - (item / ntn) * ntn;
    wmma::store_matrix_sync(scr, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    const int px = px0 + mt * 16 + r;
    const int ch0 = nt * 16 + c8;
    if (px < W && ch0 < Cout) {
      __align__(16) bf16 o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = __float2bfloat16_rn(scr[r * 16 + c8 + e] + p.bias[ch0 + e]);
      bf16* dst = p.out + (row0 + px) * Cout + ch0;
      if (vec_out) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (ch0 + e < Cout) dst[e] = o[e];
      }
    }
    __syncwarp();
  }
}

template <int PX, bool CHUNKED>
cudaError_t launch_dcn(const DcnParams& p, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(dcn_bounded_kernel<PX, CHUNKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.W + PX - 1) / PX, p.H, p.B);
  dcn_bounded_kernel<PX, CHUNKED><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The plan a launch picks for (Cin, Cout, R) under a per-block limit of
// `limit` bytes: returns its dynamic shared memory in bytes (0: no plan
// fits) and, where `px_ck` is not null, writes its pixels per block and
// tile channels per chunk there.
extern "C" int vfi_dcn_bounded_smem_bytes(int Cin, int Cout, int R, int limit, int* px_ck) {
  const DcnPlan m = dcn_plan(Cin, Cout, R, limit);
  if (px_ck) {
    px_ck[0] = m.px;
    px_ck[1] = m.ck;
  }
  return m.total;
}

// Launch one bounded DCN layer (integer radius R >= 0, Cin % 8 == 0,
// 1 <= Cout <= 128). `mask` may be null (weight 1). Returns the
// cudaError_t of the launch; cudaErrorInvalidValue for arguments out of
// range, including an R for which no tile plan fits the card.
extern "C" int vfi_dcn_bounded_bf16(const void* x, const void* offset, const void* mask,
                                    const void* w, const void* bias, void* out,
                                    int B, int H, int W, int Cin, int Cout, int R,
                                    int device, void* stream) {
  if (Cin < 8 || Cin % 8 != 0 || Cout < 1 || Cout > MAX_COUT || R < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const DcnPlan m = dcn_plan(Cin, Cout, R, limit);
  if (m.total == 0) return (int)cudaErrorInvalidValue;
  DcnParams p{};
  p.x = static_cast<const bf16*>(x);
  p.offset = static_cast<const bf16*>(offset);
  p.mask = static_cast<const bf16*>(mask);
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<bf16*>(out);
  p.B = B; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout; p.R = R;
  p.Cin16 = pad16(Cin); p.Cout16 = pad16(Cout); p.ck = m.ck;
  p.x_bytes = m.x_bytes; p.s_bytes = m.s_bytes; p.w_bytes = m.w_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m.ck < p.Cin16) err = launch_dcn<16, true>(p, m.total, st);   // chunks: PX = 16
  else if (m.px == 64) err = launch_dcn<64, false>(p, m.total, st);
  else if (m.px == 32) err = launch_dcn<32, false>(p, m.total, st);
  else err = launch_dcn<16, false>(p, m.total, st);
  return (int)err;
}

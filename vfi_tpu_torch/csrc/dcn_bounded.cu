// Bounded modulated deformable conv (DCNv2), bf16 NHWC, stride 1, 3x3,
// padding 1, one offset group, offsets clamped to [-R, R], optional mask
// (none means weight 1), Cin a multiple of 8 (the wrapper pads any other),
// Cout up to 128, any R whose tile plan fits (below).
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
// below the ~295 FLOP/byte ridge. Beside that sits work the roofline does
// not count: the bilinear gather reads 4 corners x 9 taps of a pixel's
// channels (~4.2 GB of shared memory a layer) and blends them in float32
// without fused multiply-adds (~4 G instructions), which bound the kernel
// well before the tensor cores or the bytes do. So the design keeps every
// byte that is read more than once in shared memory, and the blend free
// of block barriers.
//
// Numerics (both designs): the clamped sample position in float32; each
// sample-slab entry the float32 blend of its four corners in the order
// (y0, x0), (y0, x1), (y1, x0), (y1, x1), each weight (wy * wx) * mask,
// __fmul_rn / __fadd_rn, no fused multiply-add, rounded once to bf16 (the
// working dtype the TPU kernel's sample buffer holds); float32
// accumulators; the bias added and the output rounded once.
//
// Design "tile" (dcn_tile_kernel): a weight-stationary, persistent
// implicit GEMM on the conv kernel's core (csrc/conv2d.cu, common.cuh).
// - The grid is (SMs x resident blocks); a block copies the packed
//   weights [9 * Cin16][Cout16] (rows padded by 8 channels) into shared
//   memory once and walks output tiles of TH x 16 pixels (TH = 16 or 8),
//   all Cout, with a stride of the grid.
// - A tile's input with its halo, (TH + 2 + 2R) x (18 + 2R) pixels, is
//   copied (cp.async, zeros outside the image) into one of two buffers
//   while the other tile is computed (one block barrier per tile), or,
//   where two do not fit, into one buffer after the tile's last gather.
//   A pixel's row holds Cin channels and is an odd number of 16-byte units
//   long, so 16-byte corner reads of neighbouring pixels fall in distinct
//   banks.
// - TH warps; warp w owns tile row w (one m16 fragment of 16 pixels) and
//   all of Cout. For each tap, each lane computes its pixel's
//   clamped position, four corners and weights in registers (offsets and
//   mask read once a tile, 4- and 2-byte loads, the next tile's during
//   this one's taps); the warp builds its own sample slab [pixels][sk]
//   (sk channels a pass, rows padded by 8) from 16-byte corner reads, then
//   multiplies it on the tensor cores: A fragments from the slab
//   (ldmatrix), B from the resident weights (ldmatrix.trans), mma.sync
//   m16n8k16 bf16 into float32 registers. Between a slab's build and its
//   multiply only the warp synchronises.
// - Epilogue from registers: the bias, one rounding, a quad-lane
//   transpose, 16-byte stores (2-byte where Cout % 8 != 0).
// The plan (`dcn_plan` in ops/cuda/sampling.py, passed in) takes the
// first of 16 x 16 tiles with two buffers (16 warps of one m16 fragment),
// 16 x 16 with one, and 8 x 16 with one (8 warps) whose weights, buffers
// and slabs fit the card's shared memory, with the widest slab that fits.
// On an H100 (tools/conv_turns.py, in turns): 16 warps beat 8 of two
// fragments by 6% at C=64 R=1 720p, and one 16 x 16 buffer beat two of
// 8 x 16 by 7% at C=67 R=2 4x480x640.
//
// Design "strip" (dcn_strip_kernel), for what no tile plan holds (resident
// weights past the shared memory: Cin16 * Cout16 above ~11,000, e.g.
// C = 128; or a large R): a block owns PX output pixels of one row. It
//   1. computes per (pixel, tap) the clamped float32 sample position, its
//      four corners in the block's input tile -- rows py-1-R .. py+1+R,
//      columns px0-1-R .. px0+PX+R -- (none outside the image) and the
//      four bilinear weights times the tap's mask;
//   2. copies that tile into shared memory (cp.async, zeros outside the
//      image), all of Cin16 at once or, where that does not fit, in
//      channel chunks of CK, one after the other;
//   3. walks the steps (chunk, tap): for each it builds the modulated
//      sample slab S[PX][CK] and multiplies it by the tap's weight slice
//      W[CK][Cout16] on the tensor cores (WMMA bf16, float32 accumulators
//      kept in registers across all steps). S and W are double-buffered:
//      the next step's slab is built and its weight slice streams in
//      (cp.async) while this step multiplies;
//   4. adds the bias and writes bf16 -- one rounding of the output.
// Its plan takes PX = 64 with the whole Cin16 where that fits, else 32,
// then 16, then 16 pixels with the tile in channel chunks (R <= 35 at any
// C <= 128 on an H100).

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTAPS = 9;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_COUT = 128;

// ---------------------------------------------------------------------------
// Design "tile".

constexpr int TILE_W = 16;        // output tile columns: one m16 fragment
constexpr int ROW_PAD = 8;        // slab and weight row padding (bf16)

struct TileParams {
  const bf16* x;        // (B, H, W, Cin)
  const bf16* offset;   // (B, H, W, 18): (dy, dx) of tap t at 2t, 2t + 1
  const bf16* mask;     // (B, H, W, 9), or null: weight 1
  const bf16* w;        // (9 * Cin16, Cout16), row t * Cin16 + c, zero padded
  const float* bias;    // (Cout16,), zero padded
  bf16* out;            // (B, H, W, Cout)
  int B, H, W, Cin, Cout, R, Cin16;
  int xu;               // input-tile pixel stride in 16-byte units (odd)
  int sk;               // slab channels a pass (multiple of 16)
  int nbuf;             // input-tile buffers
  int w_bytes, x_bytes; // resident weights; one input-tile buffer
  int tiles_x, tiles_y, tiles;
};

// Input-tile pixel stride in 16-byte units: the Cin / 8 pieces of a pixel,
// plus one where that count is even (ops/cuda/sampling.py `_dcn_xu`).
__host__ __device__ inline int dcn_xu(int cin) { return cin / 8 + ((cin / 8) % 2 == 0); }

// TH output tile rows, one warp a row (an m16 fragment of 16 pixels);
// NF n8 fragments: Cout16 = 8 * NF.
template <int TH, int NF>
__global__ void __launch_bounds__(TH * 32, 1)
dcn_tile_kernel(const TileParams p) {
  constexpr int NT = TH * 32;       // threads
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = p.R, H = p.H, W = p.W, Cin = p.Cin, Cin16 = p.Cin16;
  const int tcols = TILE_W + 2 + 2 * R, tpx = (TH + 2 + 2 * R) * tcols;
  const int trows_1 = TH + 1 + 2 * R, tcols_1 = tcols - 1;
  const int cin8 = Cin / 8, xu = p.xu, sk = p.sk, sp = sk + ROW_PAD;
  constexpr int WP = 8 * NF + ROW_PAD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* const ws = reinterpret_cast<bf16*>(smem);
  unsigned char* const xs = smem + p.w_bytes;
  bf16* const ss = reinterpret_cast<bf16*>(smem + p.w_bytes + p.nbuf * p.x_bytes) +
                   warp * TILE_W * sp;
  const uint32_t mag_cin8 = fast_div_magic(cin8 > 1 ? cin8 : 2);
  const uint32_t mag_tcols = fast_div_magic(tcols);

  // The lane's pixel in the slab build (and whose offsets it holds): column
  // pcol of tile row `warp`; it builds the pixel's 8-channel pieces sub,
  // sub + 2, ... and lane pcol + 16 the others.
  const int pcol = lane & 15, sub = lane >> 4, prow = warp;
  const int g8 = lane >> 2, q4 = lane & 3;

  auto tile_origin = [&](int tile, int& b, int& ty, int& tx) {
    const int per_img = p.tiles_x * p.tiles_y;
    b = tile / per_img;
    const int r = tile - b * per_img;
    ty = r / p.tiles_x;
    tx = r - ty * p.tiles_x;
  };
  // Tile `tile`'s input and halo into buffer `buf`.
  auto stage_x = [&](int tile, int buf) {
    int b, ty, tx;
    tile_origin(tile, b, ty, tx);
    const int y0 = ty * TH - 1 - R, x0 = tx * TILE_W - 1 - R;
    const bf16* xb = p.x + (size_t)b * H * W * Cin;
    unsigned char* dst0 = xs + buf * p.x_bytes;
    for (int it = threadIdx.x; it < tpx * cin8; it += NT) {
      const int pix = cin8 > 1 ? fast_div(it, mag_cin8) : it;
      const int pc = it - pix * cin8;
      const int row = fast_div(pix, mag_tcols), col = pix - row * tcols;
      const int gy = y0 + row, gx = x0 + col;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16_zfill(dst0 + (pix * xu + pc) * 16,
                       ok ? xb + ((size_t)gy * W + gx) * Cin + pc * 8 : p.x, ok);
    }
  };
  // The lane's pixel's offsets (dy, dx as one bf16 pair a tap) and mask
  // bits of tile `tile`; zeros past the image.
  auto load_meta = [&](int tile, uint32_t (&off)[NTAPS], uint32_t (&msk)[NTAPS]) {
    int b, ty, tx;
    tile_origin(tile, b, ty, tx);
    const int gy = ty * TH + prow, gx = tx * TILE_W + pcol;
    const bool in = gy < H && gx < W;
    const size_t pix = ((size_t)b * H + (in ? gy : 0)) * W + (in ? gx : 0);
    const uint32_t* op = reinterpret_cast<const uint32_t*>(p.offset + pix * 18);
    const unsigned short* mp = reinterpret_cast<const unsigned short*>(p.mask + pix * 9);
#pragma unroll
    for (int t = 0; t < NTAPS; ++t) {
      off[t] = in ? __ldg(op + t) : 0u;
      msk[t] = p.mask ? (in ? (uint32_t)__ldg(mp + t) : 0u) : 0x3F80u;  // bf16 1.0
    }
  };

  int tile = blockIdx.x;
  if (tile >= p.tiles) return;
  {  // the whole packed weight set, once per block
    for (int it = threadIdx.x; it < NTAPS * Cin16 * NF; it += NT) {
      const int row = it / NF, pc = it - row * NF;
      cp_async16(ws + row * WP + pc * 8, p.w + (size_t)row * (8 * NF) + pc * 8);
    }
  }
  stage_x(tile, 0);
  cp_async_commit();
  uint32_t off[NTAPS], msk[NTAPS];
  load_meta(tile, off, msk);

  float acc[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  const uint32_t ws_u32 = smem_u32(ws), ss_u32 = smem_u32(ss);
  // ldmatrix lane addresses: A rows are the fragment's 16 pixels of the
  // slab (8 channels on for the upper lanes), B rows 16 weight rows.
  const uint32_t a_lane = ss_u32 + ((lane & 15) * sp + (lane >> 4) * 8) * 2;
  const uint32_t b_lane = ws_u32 + ((lane & 15) * WP + (lane >> 4) * 8) * 2;
  int buf = 0;
  while (true) {
    cp_async_wait<0>();
    __syncthreads();  // this tile's input is in; every warp is done with the last one's
    const int next = tile + gridDim.x;
    const bool more = next < p.tiles;
    if (more && p.nbuf == 2) {
      stage_x(next, buf ^ 1);
      cp_async_commit();
    }
    uint32_t noff[NTAPS], nmsk[NTAPS];
    if (more) load_meta(next, noff, nmsk);

    int b, ty, tx;
    tile_origin(tile, b, ty, tx);
    const int gy = ty * TH + prow, gx = tx * TILE_W + pcol;
    const unsigned char* xbuf = xs + buf * p.x_bytes;
    const float r = (float)R;
    for (int t = 0; t < NTAPS; ++t) {
      uint32_t ot = off[0], mt = msk[0];
#pragma unroll
      for (int k = 1; k < NTAPS; ++k)
        if (t == k) { ot = off[k]; mt = msk[k]; }
      // The lane's pixel at tap t: four corners in the input tile and
      // their weights. Offsets are clamped to [-R, R], so every corner lies
      // in the tile but the far row or column of a sample exactly on the
      // tile's last row or column, whose weight is exactly 0: clamped onto
      // the tile. A corner outside the image reads the tile's zeros.
      const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ot));
      const float m = __bfloat162float(__ushort_as_bfloat16((unsigned short)mt));
      const float dy = fminf(fmaxf(d.x, -r), r), dx = fminf(fmaxf(d.y, -r), r);
      const float fyp = (float)(gy + t / 3 - 1) + dy;
      const float fxp = (float)(gx + t % 3 - 1) + dx;
      const float y0f = floorf(fyp), x0f = floorf(fxp);
      const float fy = fyp - y0f, fx = fxp - x0f;
      const int ry = (int)y0f - (ty * TH - 1 - R), rx = (int)x0f - (tx * TILE_W - 1 - R);
      const int ry1 = min(ry + 1, trows_1), rx1 = min(rx + 1, tcols_1);
      const float wy0 = 1.0f - fy, wx0 = 1.0f - fx;
      const float cw0 = __fmul_rn(__fmul_rn(wy0, wx0), m), cw1 = __fmul_rn(__fmul_rn(wy0, fx), m);
      const float cw2 = __fmul_rn(__fmul_rn(fy, wx0), m), cw3 = __fmul_rn(__fmul_rn(fy, fx), m);
      const unsigned char* c0 = xbuf + (ry * tcols + rx) * xu * 16;
      const unsigned char* c1 = xbuf + (ry * tcols + rx1) * xu * 16;
      const unsigned char* c2 = xbuf + (ry1 * tcols + rx) * xu * 16;
      const unsigned char* c3 = xbuf + (ry1 * tcols + rx1) * xu * 16;

      for (int k0 = 0; k0 < Cin16; k0 += sk) {
        const int skw = min(sk, Cin16 - k0);
        // The slab: pieces sub, sub + 2, ... of the lane's pixel.
        for (int j = sub; j < skw / 8; j += 2) {
          const int pc = k0 / 8 + j;
          uint4 res = make_uint4(0u, 0u, 0u, 0u);
          if (pc < cin8) {
            const uint4 v0 = *reinterpret_cast<const uint4*>(c0 + pc * 16);
            const uint4 v1 = *reinterpret_cast<const uint4*>(c1 + pc * 16);
            const uint4 v2 = *reinterpret_cast<const uint4*>(c2 + pc * 16);
            const uint4 v3 = *reinterpret_cast<const uint4*>(c3 + pc * 16);
            const uint32_t a0[4] = {v0.x, v0.y, v0.z, v0.w}, a1[4] = {v1.x, v1.y, v1.z, v1.w};
            const uint32_t a2[4] = {v2.x, v2.y, v2.z, v2.w}, a3[4] = {v3.x, v3.y, v3.z, v3.w};
            uint32_t o[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a0[e]));
              const float2 f1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a1[e]));
              const float2 f2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a2[e]));
              const float2 f3 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a3[e]));
              float lo = __fmul_rn(cw0, f0.x), hi = __fmul_rn(cw0, f0.y);
              lo = __fadd_rn(lo, __fmul_rn(cw1, f1.x));
              hi = __fadd_rn(hi, __fmul_rn(cw1, f1.y));
              lo = __fadd_rn(lo, __fmul_rn(cw2, f2.x));
              hi = __fadd_rn(hi, __fmul_rn(cw2, f2.y));
              lo = __fadd_rn(lo, __fmul_rn(cw3, f3.x));
              hi = __fadd_rn(hi, __fmul_rn(cw3, f3.y));
              o[e] = pack_bf16x2(lo, hi);
            }
            res = make_uint4(o[0], o[1], o[2], o[3]);
          }
          *reinterpret_cast<uint4*>(ss + pcol * sp + j * 8) = res;
        }
        __syncwarp();
        // out[pixels][Cout16] += slab @ W[t * Cin16 + k0 ..][:]
        const uint32_t bt = b_lane + (t * Cin16 + k0) * WP * 2;
        for (int kk = 0; kk < skw / 16; ++kk) {
          uint32_t fa[4], fb[NF][2];
          ldsm_x4(fa, a_lane + kk * 16 * 2);
#pragma unroll
          for (int j = 0; j < NF; j += 2)
            ldsm_x4_t(fb[j], fb[j + 1], bt + kk * 16 * WP * 2 + j * 16);
#pragma unroll
          for (int j = 0; j < NF; ++j) mma_bf16(acc[j], fa, fb[j]);
        }
        __syncwarp();
      }
    }

    if (p.nbuf == 1 && more) {  // every gather from the one buffer is done
      __syncthreads();
      stage_x(next, 0);
      cp_async_commit();
    }

    // Epilogue of this tile: bias, one rounding, bf16 out.
    const bool vec = (p.Cout % 8) == 0;
    const int oy = ty * TH + warp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ox = tx * TILE_W + g8 + 8 * h;
      const bool inimg = oy < H && ox < W;
      bf16* orow = p.out + (((size_t)b * H + oy) * W + ox) * p.Cout;
#pragma unroll
      for (int j0 = 0; j0 < NF; j0 += 4) {
        uint32_t u[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j0 + jj < NF ? j0 + jj : NF - 1;
          const float2 bj = *reinterpret_cast<const float2*>(p.bias + j * 8 + q4 * 2);
          u[jj] = pack_bf16x2(acc[j][2 * h] + bj.x, acc[j][2 * h + 1] + bj.y);
        }
        quad_transpose(u, q4);
        const int ch0 = (j0 + q4) * 8;
        if (inimg && j0 + q4 < NF && ch0 < p.Cout) {
          if (vec) {
            *reinterpret_cast<uint4*>(orow + ch0) = make_uint4(u[0], u[1], u[2], u[3]);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (ch0 + e < p.Cout)
                orow[ch0 + e] = __ushort_as_bfloat16(
                    static_cast<unsigned short>(u[e >> 1] >> (16 * (e & 1))));
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    if (!more) break;
#pragma unroll
    for (int k = 0; k < NTAPS; ++k) {
      off[k] = noff[k];
      msk[k] = nmsk[k];
    }
    tile = next;
    if (p.nbuf == 2) buf ^= 1;
  }
}

template <int TH, int NF>
int launch_tile(const TileParams& p, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(dcn_tile_kernel<TH, NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0, dev = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dcn_tile_kernel<TH, NF>,
                                                      TH * 32, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = min(p.tiles, per_sm * sms);
  dcn_tile_kernel<TH, NF><<<grid, TH * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int TH>
int launch_tile_nf(const TileParams& p, int nf, int smem, cudaStream_t s) {
  switch (nf) {
    case 2: return launch_tile<TH, 2>(p, smem, s);
    case 4: return launch_tile<TH, 4>(p, smem, s);
    case 6: return launch_tile<TH, 6>(p, smem, s);
    case 8: return launch_tile<TH, 8>(p, smem, s);
    case 10: return launch_tile<TH, 10>(p, smem, s);
    case 12: return launch_tile<TH, 12>(p, smem, s);
    case 14: return launch_tile<TH, 14>(p, smem, s);
    default: return launch_tile<TH, 16>(p, smem, s);
  }
}

// ---------------------------------------------------------------------------
// Design "strip".


constexpr int SPAD = 16;          // S row padding (bank spread, 32 B aligned rows)
constexpr int WPAD = 8;           // W row padding (bank spread)
constexpr int SCRATCH_BYTES = NWARPS * 256 * 4;   // epilogue, 16x16 f32 a warp

struct StripParams {
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

// A strip plan's shared-memory regions for PX output pixels a block and
// the input tile in chunks of ck channels: the tile, the two sample slabs,
// the two weight slices, the taps' corner indices and weights (the same
// sum as `_strip_plan_at` in ops/cuda/sampling.py).
struct StripPlan {
  int px, ck, x_bytes, s_bytes, w_bytes, total;
};

__host__ inline StripPlan strip_plan_at(int px, int ck, int cout16, int R) {
  StripPlan m;
  m.px = px;
  m.ck = ck;
  m.x_bytes = round128((3 + 2 * R) * (px + 2 + 2 * R) * ck * 2);
  const int sb = 2 * px * (ck + SPAD) * 2;
  m.s_bytes = round128(sb > SCRATCH_BYTES ? sb : SCRATCH_BYTES);
  m.w_bytes = round128(2 * ck * (cout16 + WPAD) * 2);
  m.total = m.x_bytes + m.s_bytes + m.w_bytes + px * NTAPS * 4 * 8;
  return m;
}

// CHUNKED: the tile in several channel chunks (ck < Cin16); else one chunk
// of all Cin16 channels and a loop of exactly the 9 taps.
template <int PX, bool CHUNKED>
__global__ void __launch_bounds__(NTHREADS)
dcn_strip_kernel(const StripParams p) {
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
cudaError_t launch_strip(const StripParams& p, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(dcn_strip_kernel<PX, CHUNKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.W + PX - 1) / PX, p.H, p.B);
  dcn_strip_kernel<PX, CHUNKED><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Launch one bounded DCN layer (integer radius R >= 0, Cin % 8 == 0,
// 1 <= Cout <= 128, `mask` null for weight 1) on the plan of `dcn_plan`
// (ops/cuda/sampling.py). design 0, "tile": `rows` output tile rows (16
// or 8), `chans` slab channels a pass, `nbuf` input-tile buffers of
// `x_bytes` each; design 1, "strip": `rows` pixels a block (64, 32 or
// 16), `chans` tile channels a chunk (nbuf and x_bytes unused). `smem`:
// the plan's dynamic shared memory in bytes. Returns the cudaError_t of
// the launch; cudaErrorInvalidValue for arguments out of range, a plan
// whose regions overrun `smem`, or (tile) offsets off 4-byte alignment.
extern "C" int vfi_dcn_bounded_bf16(const void* x, const void* offset, const void* mask,
                                    const void* w, const void* bias, void* out,
                                    int B, int H, int W, int Cin, int Cout, int R,
                                    int design, int rows, int chans, int nbuf, int x_bytes,
                                    int smem, int device, void* stream) {
  if (Cin < 8 || Cin % 8 != 0 || Cout < 1 || Cout > MAX_COUT || R < 0 || B < 0 || H < 0 ||
      W < 0 || smem < 0)
    return (int)cudaErrorInvalidValue;
  const int cin16 = pad16(Cin), cout16 = pad16(Cout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == 0) {
    const long long tpx = (long long)(rows + 2 + 2 * R) * (TILE_W + 2 + 2 * R);
    const long long w_bytes = 2LL * NTAPS * cin16 * (cout16 + ROW_PAD);
    const long long s_bytes = 2LL * rows * TILE_W * (chans + ROW_PAD);
    if ((rows != 8 && rows != 16) || chans < 16 || chans % 16 != 0 || chans > cin16 ||
        (nbuf != 1 && nbuf != 2) || x_bytes % 128 != 0 || x_bytes < 16 * tpx * dcn_xu(Cin) ||
        smem < w_bytes + (long long)nbuf * x_bytes + s_bytes ||
        reinterpret_cast<uintptr_t>(offset) % 4 != 0)
      return (int)cudaErrorInvalidValue;
    TileParams p{};
    p.x = static_cast<const bf16*>(x);
    p.offset = static_cast<const bf16*>(offset);
    p.mask = static_cast<const bf16*>(mask);
    p.w = static_cast<const bf16*>(w);
    p.bias = static_cast<const float*>(bias);
    p.out = static_cast<bf16*>(out);
    p.B = B; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout; p.R = R; p.Cin16 = cin16;
    p.xu = dcn_xu(Cin); p.sk = chans; p.nbuf = nbuf;
    p.w_bytes = (int)w_bytes; p.x_bytes = x_bytes;
    p.tiles_x = (W + TILE_W - 1) / TILE_W;
    p.tiles_y = (H + rows - 1) / rows;
    p.tiles = B * p.tiles_x * p.tiles_y;
    if (p.tiles == 0) return (int)cudaSuccess;
    const cudaError_t err = use_device(device);
    if (err != cudaSuccess) return (int)err;
    return rows == 16 ? launch_tile_nf<16>(p, cout16 / 8, smem, st)
                      : launch_tile_nf<8>(p, cout16 / 8, smem, st);
  }
  if (design != 1 || (rows != 64 && rows != 32 && rows != 16) || chans < 16 ||
      chans % 16 != 0 || chans > cin16 || (chans < cin16 && rows != 16))
    return (int)cudaErrorInvalidValue;
  const StripPlan m = strip_plan_at(rows, chans, cout16, R);
  if (smem < m.total) return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W == 0) return (int)cudaSuccess;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  StripParams p{};
  p.x = static_cast<const bf16*>(x);
  p.offset = static_cast<const bf16*>(offset);
  p.mask = static_cast<const bf16*>(mask);
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<bf16*>(out);
  p.B = B; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout; p.R = R;
  p.Cin16 = cin16; p.Cout16 = cout16; p.ck = chans;
  p.x_bytes = m.x_bytes; p.s_bytes = m.s_bytes; p.w_bytes = m.w_bytes;
  if (chans < cin16) err = launch_strip<16, true>(p, smem, st);   // chunks: PX = 16
  else if (rows == 64) err = launch_strip<64, false>(p, smem, st);
  else if (rows == 32) err = launch_strip<32, false>(p, smem, st);
  else err = launch_strip<16, false>(p, smem, st);
  return (int)err;
}

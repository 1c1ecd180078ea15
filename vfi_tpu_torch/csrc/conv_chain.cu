// Fused stride-1 3x3 conv chain, bf16 NHWC, float32 accumulation; and its
// float32 instance (conv_chain_f32_kernel, below: the same function on
// float32 tensors, FFMA on the CUDA cores).
//
// Replaces: vfi_tpu/ops/pallas/conv.py::_chain_kernel (conv_chain_pallas),
// the TPU kernel behind EMAVFI's fused trunk chains of 2..4 layers (feature
// blocks, motion estimation, reconstruction). A chain of one layer is one
// conv: `conv_chain` launches csrc/conv2d.cu for it, and this entry refuses
// L = 1. `chain_plan` (ops/cuda/conv.py) routes each chain shape either
// here or through one conv2d.cu launch a layer, whichever ran faster on
// the card; this kernel computes the same function either way.
//
// What bounds it on this card: arithmetic. A 720p 64->64 layer is 68 GFLOP
// (0.069 ms at the bf16 peak) against 0.24 GB of its own input and output;
// the TPU kernel keeps the intermediates out of device memory with full-
// width row slabs in megabytes of VMEM. 227 KB of shared memory holds only
// a small tile with its halo, so fusion here pays in recomputed halo
// (1.56x the work for three layers on a 16 x 16 output tile) and in weights
// re-read from L2 for every tile, what the unfused layers do not pay.
//
// Design: the conv kernel's GEMM core (csrc/conv2d.cu), one layer at a time
// over a tile that stays in shared memory.
// - Persistent blocks (as many as fit, by the occupancy API) walk output
//   tiles of TH x TW pixels (the plan's) with a stride of the grid. A
//   block's work is a sequence of steps (tile, layer, tap group), with one
//   block barrier a step: one a layer where its weights fit in one group.
// - Flat pixel pitch: every layer of a tile uses one row pitch P = TW + 2L.
//   Layer l computes the (TH + 2(L-1-l)) x P positions of its output region
//   (its halo shrinking by one pixel a layer) as m16 fragments of 16
//   consecutive positions; tap (di, dj) of position q reads input position
//   q + di * P + dj, so an A fragment is the activation buffer itself at a
//   flat offset (ldmatrix, one row address a position): no im2col. The
//   columns past TW + 2(L-1-l) compute junk that no valid position reads.
// - Two activation buffers hold a layer's input and output in turn (rows
//   of the widest layer input + 8 bf16 channels, an odd multiple of 16
//   bytes, so ldmatrix's eight rows fall in distinct banks). The next
//   tile's input (with its L-pixel halo, zeros outside the image, cp.async
//   with zero fill) copies into the buffer the last layer does not read,
//   while the last layer multiplies.
// - Weights: two slots of one tap group of one layer ([taps][Cin16] rows of
//   Cout16 + 8); the next step's group (the rest of this layer, the next
//   layer's first, or the next tile's first layer) copies with cp.async
//   into the other slot while this one multiplies.
// - 8 warps; warp w owns the layer's m16 fragments w, w + 8, ... (at most
//   MF) and all of Cout: per k-step it loads its A fragments (ldsm_x4) and
//   Cout16 / 16 pairs of B fragments (ldsm_x4_t), and issues MF x NF
//   mma_bf16 (m16n8k16, float32 accumulators in registers), each A reused
//   across the n-fragments and each B across the m-fragments.
// - Epilogue from registers: the bias (float32 of its bf16 value), the
//   ReLU, one rounding to bf16. An intermediate goes straight into the
//   other activation buffer, stored as 0 at positions outside the image
//   (each layer of the unfused chain zero-pads its own input; the TPU
//   kernel re-zeroes those rows for the same reason) and in the junk
//   columns. The last layer goes to device memory, 8 channels a lane after
//   a transpose within each quad of lanes, 16-byte stores where
//   Cout % 8 == 0.
// The input takes C0 % 8 == 0 (16-byte copies): the wrapper zero-pads
// another width (the reference topology's 67 channels to 72); the tile
// zero-fills the channels up to Cin16, and the packed weights carry zero
// rows for them. Later work: wgmma, TMA, clusters.
//
// The two instances share the tile walk, the staging of a tile's input
// (`stage_tile`, a template on the element type: 16-byte pieces of 8 bf16
// or 4 float32 channels) and the persistent launch (common.cuh);
// their cores differ (tensor-core fragments against FFMA on registers),
// and so do their shared-memory layouts (below).

#include <algorithm>

#include "common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NWARPS = 8;           // ops/cuda/conv.py CHAIN_WARPS
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAXL = 4;
constexpr int MF = 4;               // m16 fragments a warp at most (CHAIN_MF)
constexpr int NFMAX = 8;            // n8 fragments: Cout16 <= 64
constexpr int PAD = 8;              // row padding, bf16 elements (ROW_PAD)

// Output tile `tile` of a tiles_y x tiles_x grid an image: its image b
// and its tile row and column.
__device__ __forceinline__ void tile_origin(int tile, int tiles_x, int tiles_y, int& b,
                                            int& ty, int& tx) {
  const int per_img = tiles_x * tiles_y;
  b = tile / per_img;
  const int r = tile - b * per_img;
  ty = r / tiles_x;
  tx = r - ty * tiles_x;
}

// A tile's input region (`rows` rows from image row y0, P columns from
// image column x0) of image `xb` (H x W x C0) into `dst`: `npos`
// positions of row pitch P, `pitch` elements a position, cinp channels in
// 16-byte pieces (8 bf16 or 4 float32 channels), cp.async with zero fill:
// zeros outside the image, past C0 and at positions past the region.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* xb, const T* any, int H, int W,
                                           int C0, int cinp, int pitch, int y0, int x0,
                                           int rows, int P, uint32_t magP, int npos) {
  constexpr int PER = 16 / sizeof(T);
  const int pieces = cinp / PER;
  const uint32_t mag_pc = fast_div_magic(pieces);
  for (int it = threadIdx.x; it < npos * pieces; it += NTHREADS) {
    const int pix = fast_div(it, mag_pc), pc = it - pix * pieces;
    const int row = fast_div(pix, magP), col = pix - row * P;
    const int gy = y0 + row, gx = x0 + col, ch = pc * PER;
    const bool ok = row < rows && ch < C0 && gy >= 0 && gy < H && gx >= 0 && gx < W;
    cp_async16_zfill(dst + pix * pitch + ch, ok ? xb + ((size_t)gy * W + gx) * C0 + ch : any,
                     ok);
  }
}

struct ChainParams {
  const bf16* x;                    // (B, H, W, C0)
  const bf16* w;                    // per layer [9][cinp][coutp]
  const float* bias;                // per layer [coutp]
  bf16* out;                        // (B, H, W, cout[L - 1])
  int B, H, W, L, C0, TH, TW, P;    // P = TW + 2L, the flat pixel pitch
  int cinp[MAXL], coutp[MAXL], cout[MAXL], tg[MAXL], groups[MAXL], frags[MAXL];
  long long w_off[MAXL];
  int b_off[MAXL];
  int act_mask;
  int pitch;                        // activation row, elements
  int buf_px, buf_bytes, slot_bytes;
  int tiles_x, tiles_y, tiles;
};

// Taps t0 .. t0 + tn - 1 of one layer: k-steps of 16 channels, each over
// the warp's nmine m-fragments and NF n-fragments.
template <int NF>
__device__ __forceinline__ void layer_mma(float (&acc)[MF][NFMAX][4], uint32_t a_base,
                                          uint32_t b_base, int t0, int tn, int ksteps,
                                          int P, int pitch, int wp, int nmine) {
  const uint32_t a_frag = NWARPS * 16 * pitch * 2;  // bytes between a warp's fragments
  for (int t = 0; t < tn; ++t) {
    const int tap = t0 + t, di = tap / 3, dj = tap - 3 * di;
    const uint32_t ao = a_base + (di * P + dj) * pitch * 2;
    const uint32_t bo = b_base + t * ksteps * 16 * wp * 2;
    for (int kk = 0; kk < ksteps; ++kk) {
      uint32_t fa[MF][4], fb[NF][2];
#pragma unroll
      for (int i = 0; i < MF; ++i)
        if (i < nmine) ldsm_x4(fa[i], ao + i * a_frag + kk * 32);
#pragma unroll
      for (int j = 0; j < NF; j += 2) ldsm_x4_t(fb[j], fb[j + 1], bo + kk * 16 * wp * 2 + j * 16);
#pragma unroll
      for (int i = 0; i < MF; ++i)
        if (i < nmine) {
#pragma unroll
          for (int j = 0; j < NF; ++j) mma_bf16(acc[i][j], fa[i], fb[j]);
        }
    }
  }
}

// Layer l < L - 1: bias, ReLU, one rounding, into the next activation
// buffer; 0 outside the image and in the junk columns and rows.
template <int NF>
__device__ __forceinline__ void store_intermediate(const ChainParams& p, const float (&acc)[MF][NFMAX][4],
                                                   int l, bf16* obuf, int oy, int ox,
                                                   int wout, int nmine, uint32_t magP) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, q4 = lane & 3;
  const int M = (p.TH + 2 * (p.L - 1 - l)) * p.P;
  const bool act = (p.act_mask >> l) & 1;
  float2 bv[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j)
    bv[j] = *reinterpret_cast<const float2*>(p.bias + p.b_off[l] + j * 8 + q4 * 2);
#pragma unroll
  for (int i = 0; i < MF; ++i) {
    if (i >= nmine) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = (warp + i * NWARPS) * 16 + g8 + 8 * h;
      const int r = fast_div(q, magP), c = q - r * p.P;
      const int gy = oy + r, gx = ox + c;
      const bool keep = q < M && c < wout && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      bf16* dst = obuf + q * p.pitch + q4 * 2;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        float v0 = acc[i][j][2 * h] + bv[j].x, v1 = acc[i][j][2 * h + 1] + bv[j].y;
        if (act) { v0 = fmaxf(v0, 0.0f); v1 = fmaxf(v1, 0.0f); }
        *reinterpret_cast<uint32_t*>(dst + j * 8) = keep ? pack_bf16x2(v0, v1) : 0u;
      }
    }
  }
}

// The last layer: bias, ReLU, one rounding, into (B, H, W, Cout).
template <int NF>
__device__ __forceinline__ void store_output(const ChainParams& p, const float (&acc)[MF][NFMAX][4],
                                             int b, int ty0, int tx0, int nmine, uint32_t magP) {
  const int l = p.L - 1, Cout = p.cout[l];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, q4 = lane & 3;
  const int M = p.TH * p.P;
  const bool act = (p.act_mask >> l) & 1, vec = Cout % 8 == 0;
  float2 bv[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j)
    bv[j] = *reinterpret_cast<const float2*>(p.bias + p.b_off[l] + j * 8 + q4 * 2);
#pragma unroll
  for (int i = 0; i < MF; ++i) {
    if (i >= nmine) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = (warp + i * NWARPS) * 16 + g8 + 8 * h;
      const int r = fast_div(q, magP), c = q - r * p.P;
      const int gy = ty0 + r, gx = tx0 + c;
      const bool inimg = q < M && c < p.TW && gy < p.H && gx < p.W;
      bf16* orow = p.out + (((size_t)b * p.H + gy) * p.W + gx) * Cout;
#pragma unroll
      for (int j0 = 0; j0 < NF; j0 += 4) {
        uint32_t u[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j0 + jj < NF ? j0 + jj : NF - 1;
          float v0 = acc[i][j][2 * h] + bv[j].x, v1 = acc[i][j][2 * h + 1] + bv[j].y;
          if (act) { v0 = fmaxf(v0, 0.0f); v1 = fmaxf(v1, 0.0f); }
          u[jj] = pack_bf16x2(v0, v1);
        }
        quad_transpose(u, q4);
        const int ch0 = (j0 + q4) * 8;
        if (inimg && j0 + q4 < NF && ch0 < Cout) {
          if (vec) {
            *reinterpret_cast<uint4*>(orow + ch0) = make_uint4(u[0], u[1], u[2], u[3]);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (ch0 + e < Cout)
                orow[ch0 + e] = __ushort_as_bfloat16(
                    static_cast<unsigned short>(u[e >> 1] >> (16 * (e & 1))));
          }
        }
      }
    }
  }
}

// One step: this warp's MMAs over a tap group of layer l, then, after the
// layer's last group, its epilogue.
template <int NF>
__device__ __forceinline__ void chain_step(const ChainParams& p, float (&acc)[MF][NFMAX][4],
                                           int l, int g, const bf16* in, const bf16* wslot,
                                           bf16* obuf, int b, int ty, int tx, uint32_t magP) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int frags = p.frags[l];
  const int nmine = frags > warp ? min(MF, (frags - warp + NWARPS - 1) / NWARPS) : 0;
  const int wp = p.coutp[l] + PAD, t0 = g * p.tg[l], tn = min(p.tg[l], 9 - t0);
  const uint32_t a_base =
      smem_u32(in + (warp * 16 + (lane & 15)) * p.pitch + (lane >> 4) * 8);
  const uint32_t b_base = smem_u32(wslot + (lane & 15) * wp + (lane >> 4) * 8);
  layer_mma<NF>(acc, a_base, b_base, t0, tn, p.cinp[l] / 16, p.P, p.pitch, wp, nmine);
  if (g != p.groups[l] - 1) return;
  if (l == p.L - 1) {
    store_output<NF>(p, acc, b, ty * p.TH, tx * p.TW, nmine, magP);
  } else {
    const int halo = p.L - 1 - l;
    store_intermediate<NF>(p, acc, l, obuf, ty * p.TH - halo, tx * p.TW - halo,
                           p.TW + 2 * halo, nmine, magP);
  }
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NFMAX; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

__global__ void __launch_bounds__(NTHREADS, 1)
conv_chain_kernel(const ChainParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = p.L, P = p.P;
  const uint32_t magP = fast_div_magic(P);
  auto buf = [&](int i) { return reinterpret_cast<bf16*>(smem + i * p.buf_bytes); };
  auto slot = [&](int i) {
    return reinterpret_cast<bf16*>(smem + 2 * p.buf_bytes + i * p.slot_bytes);
  };
  // Tile `tile`'s input with its L-pixel halo into buffer `s`: buf_px
  // positions of Cin16 channels, zeros outside the image, past C0 and in
  // the slack past the region.
  auto stage_x = [&](int tile, int s) {
    int b, ty, tx;
    tile_origin(tile, p.tiles_x, p.tiles_y, b, ty, tx);
    stage_tile(buf(s), p.x + (size_t)b * p.H * p.W * p.C0, p.x, p.H, p.W, p.C0, p.cinp[0],
               p.pitch, ty * p.TH - L, tx * p.TW - L, p.TH + 2 * L, P, magP, p.buf_px);
  };
  // Group g of layer l's weights into slot `s`, as [taps][cinp][coutp + PAD].
  auto stage_w = [&](int l, int g, int s) {
    const int t0 = g * p.tg[l], tn = min(p.tg[l], 9 - t0);
    const int pieces = p.coutp[l] / 8, wp = p.coutp[l] + PAD;
    const uint32_t mag_pc = fast_div_magic(pieces);
    const bf16* src = p.w + p.w_off[l] + (size_t)t0 * p.cinp[l] * p.coutp[l];
    bf16* dst = slot(s);
    for (int it = threadIdx.x; it < tn * p.cinp[l] * pieces; it += NTHREADS) {
      const int row = fast_div(it, mag_pc), pc = it - row * pieces;
      cp_async16(dst + row * wp + pc * 8, src + (size_t)row * p.coutp[l] + pc * 8);
    }
  };

  int tile = blockIdx.x, l = 0, g = 0, s = 0, ws = 0;
  if (tile >= p.tiles) return;
  stage_w(0, 0, 0);
  stage_x(tile, 0);
  cp_async_commit();

  float acc[MF][NFMAX][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NFMAX; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  while (true) {
    cp_async_wait<0>();
    __syncthreads();  // this step's input and weights are in; the last step's slot is free
    int nt = tile, nl = l, ng = g + 1;
    if (ng == p.groups[l]) {
      ng = 0;
      if (++nl == L) { nl = 0; nt += gridDim.x; }
    }
    const bool more = nt < p.tiles;
    if (more) {
      stage_w(nl, ng, ws ^ 1);
      // The last layer reads buffer (s + L - 1) & 1: the other is free.
      if (nl == 0 && ng == 0) stage_x(nt, (s + L) & 1);
      cp_async_commit();
    }

    int b, ty, tx;
    tile_origin(tile, p.tiles_x, p.tiles_y, b, ty, tx);
    const bf16* in = buf((s + l) & 1);
    bf16* obuf = buf((s + l + 1) & 1);
    switch (p.coutp[l] / 16) {
      case 1: chain_step<2>(p, acc, l, g, in, slot(ws), obuf, b, ty, tx, magP); break;
      case 2: chain_step<4>(p, acc, l, g, in, slot(ws), obuf, b, ty, tx, magP); break;
      case 3: chain_step<6>(p, acc, l, g, in, slot(ws), obuf, b, ty, tx, magP); break;
      default: chain_step<8>(p, acc, l, g, in, slot(ws), obuf, b, ty, tx, magP); break;
    }
    if (!more) break;
    ws ^= 1;
    if (nl == 0 && ng == 0) s = (s + L) & 1;
    tile = nt;
    l = nl;
    g = ng;
  }
}

// ---------------------------------------------------------------------------
// The float32 instance (`vfi_conv_chain_f32`): the same chain on float32
// inputs, weights, bias, intermediates and output, with IEEE float32
// products and sums (FFMA on the CUDA cores, as the float32 conv of
// csrc/conv2d.cu: a single TF32 tensor-core pass keeps 10 bits of each
// operand, past the 2^-14 the float32 rows are held to).
//
// What bounds it on this card: the FFMA rate. A 720p 64->64 layer is 68
// GFLOP, 1.01 ms at the 67 TFLOP/s float32 peak, against 0.47 GB of its
// input and output; fusing saves the intermediates' round trips (0.24 ms a
// layer at the memory rate) and pays in recomputed halo, so it can win
// only where the core runs close to the FFMA rate.
//
// Design (conv_chain_f32_kernel): the bf16 kernel's walk (persistent
// blocks over TH x TW output tiles, one layer at a time over the tile in
// shared memory, the halo shrinking a pixel a layer, intermediates stored
// as 0 outside the image, one flat pixel pitch P = TW + 2L), with a float32
// geometry, the plan of `chain_fused_plan(..., itemsize=4)`:
// - Two activation buffers with fixed roles: buffer 0 holds the even
//   layers' inputs, buffer 1 the odd layers', each position a row of
//   cinp + 4 floats (an odd multiple of 16 bytes, so the 16-byte reads of
//   a quarter-warp's 8 consecutive positions fall in distinct banks). The
//   input of a 128-wide layer fills most of 227 KB, so a second input-
//   sized buffer (the bf16 kernel's swap) does not fit: the next tile's
//   input copies into buffer 0 during the last layer where L is even, and
//   after it where L is odd.
// - The weights stream in chunks of `ck` input channels, all 9 taps
//   ([coutp][9][ck] floats: rows of the float32 pack the conv kernel reads,
//   [coutp][9 * cin8], cut to the chunk), through two slots: the next
//   step's chunk (the next one of this layer, the next layer's first, or
//   the next tile's first) copies while this one multiplies; a block's
//   steps are (tile, layer, chunk), one barrier each.
// - Warp w owns output channels 8g .. 8g + 7, g = w mod (coutp / 8), and
//   shares a layer's output positions with the warps of the same g (4, 2
//   or 1 of them): lane `lane` of share s takes the positions s * 32 +
//   lane + i * 32 * shares, i < np (at most F_MP = 8, which bounds the
//   tile), counted over the layer's output region without its junk
//   columns, and holds np x 8 float32 accumulators across the layer's
//   chunks. Per (tap, 4 channels) a lane reads np float4s of input and the
//   warp 8 float4s of weights (4 channels of each of its output channels;
//   one address for every lane: a broadcast), for 32 np FFMAs.
// - Epilogue from registers: the bias, the ReLU; an intermediate (0
//   outside the image) into the other buffer as two float4s a position,
//   the last layer to device memory (16-byte stores where Cout % 4 == 0).
// Summation order: over chunks, taps, channels; the plain version's cuDNN
// convs sum in their own order, so the two differ by float32 rounding only.

constexpr int F_MP = 8;     // output positions a lane at most (ops/cuda/conv.py CHAIN_F32_MP)
constexpr int F_PAD = 4;    // row padding of the activation buffers, floats (CHAIN_F32_PAD)

struct ChainF32Params {
  const float* x;                   // (B, H, W, C0)
  const float* w;                   // per layer [coutp][9 * cin8]
  const float* bias;                // per layer [coutp]
  float* out;                       // (B, H, W, cout[L - 1])
  int B, H, W, L, C0, TH, TW, P, ck;
  int cinp[MAXL], coutp[MAXL], cout[MAXL], chunks[MAXL], np[MAXL];
  int pitch[MAXL];                  // layer l's input row, floats (cinp + F_PAD)
  int cin8[MAXL];                   // layer l's input channels rounded up to 8
  long long w_off[MAXL];
  int b_off[MAXL];
  int act_mask;
  int buf0_bytes, buf1_bytes, slot_bytes;
  int tiles_x, tiles_y, tiles;
};

// Taps 0..8 over `ckw` channels of a chunk: the lane's NP positions
// (element offsets qa in `in`) against the warp's 8 output channels of the
// chunk's weights `wg` ([coutp][9][ckw], at the warp's first row).
template <int NP>
__device__ __forceinline__ void f32_mac(float (&acc)[F_MP][8], const float* in, const float* wg,
                                        const int (&qa)[F_MP], int ckw, int P, int pin,
                                        int cbase) {
#pragma unroll 1
  for (int t = 0; t < 9; ++t) {
    const int di = t / 3, dj = t - 3 * di;
    const float* src = in + (di * P + dj) * pin + cbase;
    const float* wt = wg + t * ckw;
#pragma unroll 1
    for (int ch = 0; ch < ckw; ch += 4) {
      float4 xv[NP], wo[8];
#pragma unroll
      for (int i = 0; i < NP; ++i) xv[i] = *reinterpret_cast<const float4*>(src + qa[i] + ch);
#pragma unroll
      for (int o = 0; o < 8; ++o) wo[o] = *reinterpret_cast<const float4*>(wt + o * 9 * ckw + ch);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float wv[8];
#pragma unroll
        for (int o = 0; o < 8; ++o)
          wv[o] = k == 0 ? wo[o].x : k == 1 ? wo[o].y : k == 2 ? wo[o].z : wo[o].w;
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const float xs = k == 0 ? xv[i].x : k == 1 ? xv[i].y : k == 2 ? xv[i].z : xv[i].w;
#pragma unroll
          for (int o = 0; o < 8; ++o) acc[i][o] = fmaf(xs, wv[o], acc[i][o]);
        }
      }
    }
  }
}

// One step: this warp's FFMAs over chunk c of layer l, then, after the
// layer's last chunk, its epilogue.
__device__ __forceinline__ void f32_step(const ChainF32Params& p, float (&acc)[F_MP][8], int l,
                                         int c, const float* in, const float* wslot, float* obuf,
                                         int b, int ty, int tx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ngrp = p.coutp[l] / 8, shares = NWARPS / ngrp;
  const int g = warp % ngrp, s = warp / ngrp;
  if (s >= shares) return;          // Cout16 = 48: six groups, two warps idle
  const int halo = p.L - 1 - l, wid = p.TW + 2 * halo, n = (p.TH + 2 * halo) * wid;
  const int pin = p.pitch[l], np = p.np[l], k0 = s * 32 + lane, stride = 32 * shares;
  int qa[F_MP];
#pragma unroll
  for (int i = 0; i < F_MP; ++i) {
    const int k = min(k0 + i * stride, n - 1);   // past n: a valid position, not stored
    const int r = k / wid;
    qa[i] = (r * p.P + k - r * wid) * pin;
  }
  const int ckw = min(p.ck, p.cinp[l] - c * p.ck);
  const float* wg = wslot + g * 8 * 9 * ckw;
  switch (np) {
    case 1: f32_mac<1>(acc, in, wg, qa, ckw, p.P, pin, c * p.ck); break;
    case 2: f32_mac<2>(acc, in, wg, qa, ckw, p.P, pin, c * p.ck); break;
    case 3: f32_mac<3>(acc, in, wg, qa, ckw, p.P, pin, c * p.ck); break;
    case 4: f32_mac<4>(acc, in, wg, qa, ckw, p.P, pin, c * p.ck); break;
    case 5: f32_mac<5>(acc, in, wg, qa, ckw, p.P, pin, c * p.ck); break;
    case 6: f32_mac<6>(acc, in, wg, qa, ckw, p.P, pin, c * p.ck); break;
    case 7: f32_mac<7>(acc, in, wg, qa, ckw, p.P, pin, c * p.ck); break;
    default: f32_mac<8>(acc, in, wg, qa, ckw, p.P, pin, c * p.ck); break;
  }
  if (c != p.chunks[l] - 1) return;

  const bool act = (p.act_mask >> l) & 1, last = l == p.L - 1;
  const int oy = ty * p.TH - halo, ox = tx * p.TW - halo, cout = p.cout[l];
  float bv[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) bv[o] = p.bias[p.b_off[l] + g * 8 + o];
#pragma unroll
  for (int i = 0; i < F_MP; ++i) {
    const int k = k0 + i * stride;
    if (i < np && k < n) {
      const int r = k / wid, cc = k - r * wid, gy = oy + r, gx = ox + cc;
      const bool inimg = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      float v[8];
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        v[o] = acc[i][o] + bv[o];
        if (act) v[o] = fmaxf(v[o], 0.0f);
        if (!inimg) v[o] = 0.0f;
      }
      if (!last) {
        float4* dst = reinterpret_cast<float4*>(obuf + (r * p.P + cc) * p.pitch[l + 1] + g * 8);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else if (inimg) {
        float* orow = p.out + (((size_t)b * p.H + gy) * p.W + gx) * cout;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ch = g * 8 + 4 * h;
          if (ch >= cout) break;
          if (cout % 4 == 0) {
            *reinterpret_cast<float4*>(orow + ch) =
                make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (ch + e < cout) orow[ch + e] = v[4 * h + e];
          }
        }
      }
    }
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[i][o] = 0.0f;
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
conv_chain_f32_kernel(const ChainF32Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = p.L, P = p.P;
  const uint32_t magP = fast_div_magic(P);
  auto buf = [&](int i) { return reinterpret_cast<float*>(smem + (i ? p.buf0_bytes : 0)); };
  auto slot = [&](int i) {
    return reinterpret_cast<float*>(smem + p.buf0_bytes + p.buf1_bytes + i * p.slot_bytes);
  };
  // Tile `tile`'s input with its L-pixel halo into buffer 0.
  auto stage_x = [&](int tile) {
    int b, ty, tx;
    tile_origin(tile, p.tiles_x, p.tiles_y, b, ty, tx);
    const int rows = p.TH + 2 * L;
    stage_tile(buf(0), p.x + (size_t)b * p.H * p.W * p.C0, p.x, p.H, p.W, p.C0, p.cinp[0],
               p.pitch[0], ty * p.TH - L, tx * p.TW - L, rows, P, magP, rows * P);
  };
  // Chunk c of layer l's weights into slot `s`, as [coutp][9][ckw], from
  // the float32 pack [coutp][9 * cin8] (column t * cin8 + channel);
  // channels cin8 .. cinp - 1 are zeros.
  auto stage_w = [&](int l, int c, int s) {
    const int ckw = min(p.ck, p.cinp[l] - c * p.ck), coutp = p.coutp[l], cin8 = p.cin8[l];
    const int pieces = ckw / 4;
    const float* src = p.w + p.w_off[l] + c * p.ck;
    float* dst = slot(s);
    for (int it = threadIdx.x; it < coutp * 9 * pieces; it += NTHREADS) {
      const int row = it / pieces, pc = it - row * pieces;   // row = o * 9 + t
      const int o = row / 9, t = row - o * 9;
      const bool ok = c * p.ck + pc * 4 < cin8;
      cp_async16_zfill(dst + row * ckw + pc * 4,
                       ok ? src + (size_t)o * 9 * cin8 + t * cin8 + pc * 4 : p.w, ok);
    }
  };

  int tile = blockIdx.x, l = 0, c = 0, ws = 0;
  if (tile >= p.tiles) return;
  stage_w(0, 0, 0);
  stage_x(tile);
  cp_async_commit();

  float acc[F_MP][8];
#pragma unroll
  for (int i = 0; i < F_MP; ++i)
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[i][o] = 0.0f;

  while (true) {
    cp_async_wait<0>();
    __syncthreads();  // this step's input and weights are in; the last step's slot is free
    int nt = tile, nl = l, nc = c + 1;
    if (nc == p.chunks[l]) {
      nc = 0;
      if (++nl == L) { nl = 0; nt += gridDim.x; }
    }
    const bool more = nt < p.tiles, next_tile = nl == 0 && nc == 0;
    if (more) {
      stage_w(nl, nc, ws ^ 1);
      // An even L's last layer reads buffer 1: buffer 0 is free.
      if (next_tile && L % 2 == 0) stage_x(nt);
      cp_async_commit();
    }

    int b, ty, tx;
    tile_origin(tile, p.tiles_x, p.tiles_y, b, ty, tx);
    f32_step(p, acc, l, c, buf(l & 1), slot(ws), buf((l + 1) & 1), b, ty, tx);
    if (!more) break;
    if (next_tile && L % 2 == 1) {
      __syncthreads();  // an odd L's last layer has read buffer 0
      stage_x(nt);
      cp_async_commit();
    }
    ws ^= 1;
    tile = nt;
    l = nl;
    c = nc;
  }
}

}  // namespace

extern "C" const char* vfi_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch one chain of 2..4 layers on the plan of `chain_fused_plan`
// (ops/cuda/conv.py): c0..c4 the widths (c0 the input's, a multiple of 8;
// c[l + 1] layer l's output, 1..64; entries past L ignored), act_mask bit l
// layer l's ReLU, a th x tw output tile, tg0..tg3 taps per weight group of
// each layer, buf_bytes per activation buffer, slot_bytes per weight slot,
// smem bytes in all. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape or plan outside the contract); the
// kernel runs on `stream`.
extern "C" int vfi_conv_chain_bf16(const void* x, const void* w, const void* bias, void* out,
                                   int B, int H, int W, int L, int c0, int c1, int c2, int c3,
                                   int c4, int act_mask, int th, int tw, int tg0, int tg1,
                                   int tg2, int tg3, int buf_bytes, int slot_bytes, int smem,
                                   int device, void* stream) {
  if (L < 2 || L > MAXL || c0 < 8 || c0 % 8 != 0 || th < 1 || tw < 1 || B < 0 || H < 0 ||
      W < 0)
    return (int)cudaErrorInvalidValue;
  const int c[MAXL + 1] = {c0, c1, c2, c3, c4};
  const int tgs[MAXL] = {tg0, tg1, tg2, tg3};
  ChainParams p{};
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<bf16*>(out);
  p.B = B; p.H = H; p.W = W; p.L = L; p.C0 = c0;
  p.TH = th; p.TW = tw; p.P = tw + 2 * L;
  p.act_mask = act_mask;
  long long woff = 0;
  int boff = 0, widest = 0, slot_need = 0;
  for (int l = 0; l < L; ++l) {
    if (c[l + 1] < 1 || c[l + 1] > NFMAX * 8 || tgs[l] < 1 || tgs[l] > 9)
      return (int)cudaErrorInvalidValue;
    p.cinp[l] = pad16(c[l]);
    p.coutp[l] = pad16(c[l + 1]);
    p.cout[l] = c[l + 1];
    p.tg[l] = tgs[l];
    p.groups[l] = (9 + tgs[l] - 1) / tgs[l];
    p.frags[l] = ((th + 2 * (L - 1 - l)) * p.P + 15) / 16;
    if (p.frags[l] > NWARPS * MF) return (int)cudaErrorInvalidValue;
    p.w_off[l] = woff;
    p.b_off[l] = boff;
    woff += 9LL * p.cinp[l] * p.coutp[l];
    boff += p.coutp[l];
    widest = std::max(widest, p.cinp[l]);
    slot_need = std::max(slot_need, tgs[l] * p.cinp[l] * (p.coutp[l] + PAD) * 2);
  }
  p.pitch = widest + PAD;
  p.buf_px = p.frags[0] * 16 + 2 * p.P + 2;
  if (buf_bytes % 128 != 0 || slot_bytes % 128 != 0 ||
      (long long)buf_bytes < 2LL * p.buf_px * p.pitch || slot_bytes < slot_need ||
      (long long)smem < 2LL * buf_bytes + 2LL * slot_bytes)
    return (int)cudaErrorInvalidValue;
  p.buf_bytes = buf_bytes;
  p.slot_bytes = slot_bytes;
  p.tiles_x = (W + tw - 1) / tw;
  p.tiles_y = (H + th - 1) / th;
  p.tiles = B * p.tiles_x * p.tiles_y;
  if (p.tiles == 0) return (int)cudaSuccess;

  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  return launch_persistent(conv_chain_kernel, p, p.tiles, NTHREADS, smem,
                           static_cast<cudaStream_t>(stream));
}

// Launch one float32 chain of 2..4 layers on the plan of
// `chain_fused_plan(..., itemsize=4)`: c0..c4 as for the bf16 entry (c0 a
// multiple of 4), act_mask, a th x tw output tile, ck input channels a
// weight chunk (a multiple of 4), buf0_bytes and buf1_bytes for the two
// activation buffers, slot_bytes per weight slot, smem bytes in all.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a shape
// or plan outside the contract); the kernel runs on `stream`.
extern "C" int vfi_conv_chain_f32(const void* x, const void* w, const void* bias, void* out,
                                  int B, int H, int W, int L, int c0, int c1, int c2, int c3,
                                  int c4, int act_mask, int th, int tw, int ck, int buf0_bytes,
                                  int buf1_bytes, int slot_bytes, int smem, int device,
                                  void* stream) {
  if (L < 2 || L > MAXL || c0 < 4 || c0 % 4 != 0 || th < 1 || tw < 1 || ck < 4 ||
      ck % 4 != 0 || B < 0 || H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  const int c[MAXL + 1] = {c0, c1, c2, c3, c4};
  ChainF32Params p{};
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.B = B; p.H = H; p.W = W; p.L = L; p.C0 = c0;
  p.TH = th; p.TW = tw; p.P = tw + 2 * L; p.ck = ck;
  p.act_mask = act_mask;
  long long woff = 0, need[2] = {0, 0};
  int boff = 0, slot_need = 0;
  for (int l = 0; l < L; ++l) {
    if (c[l + 1] < 1 || c[l + 1] > NFMAX * 8) return (int)cudaErrorInvalidValue;
    p.cinp[l] = pad16(c[l]);
    p.cin8[l] = (c[l] + 7) / 8 * 8;
    p.coutp[l] = pad16(c[l + 1]);
    p.cout[l] = c[l + 1];
    p.chunks[l] = (p.cinp[l] + ck - 1) / ck;
    p.pitch[l] = p.cinp[l] + F_PAD;
    const int halo = L - 1 - l, shares = NWARPS / (p.coutp[l] / 8);
    const int n = (th + 2 * halo) * (tw + 2 * halo);
    p.np[l] = (n + 32 * shares - 1) / (32 * shares);
    if (p.np[l] > F_MP) return (int)cudaErrorInvalidValue;
    p.w_off[l] = woff;
    p.b_off[l] = boff;
    woff += 9LL * p.cin8[l] * p.coutp[l];
    boff += p.coutp[l];
    need[l & 1] = std::max(need[l & 1], 4LL * (th + 2 * (L - l)) * p.P * p.pitch[l]);
    slot_need = std::max(slot_need, 4 * 9 * std::min(ck, p.cinp[l]) * p.coutp[l]);
  }
  if (buf0_bytes % 128 != 0 || buf1_bytes % 128 != 0 || slot_bytes % 128 != 0 ||
      buf0_bytes < need[0] || buf1_bytes < need[1] || slot_bytes < slot_need ||
      (long long)smem < (long long)buf0_bytes + buf1_bytes + 2LL * slot_bytes)
    return (int)cudaErrorInvalidValue;
  p.buf0_bytes = buf0_bytes;
  p.buf1_bytes = buf1_bytes;
  p.slot_bytes = slot_bytes;
  p.tiles_x = (W + tw - 1) / tw;
  p.tiles_y = (H + th - 1) / th;
  p.tiles = B * p.tiles_x * p.tiles_y;
  if (p.tiles == 0) return (int)cudaSuccess;
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  return launch_persistent(conv_chain_f32_kernel, p, p.tiles, NTHREADS, smem,
                           static_cast<cudaStream_t>(stream));
}

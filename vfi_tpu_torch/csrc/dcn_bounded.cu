// Bounded modulated deformable conv (DCNv2), bf16 NHWC, stride 1, 3x3,
// padding 1, one offset group, offsets clamped to [-R, R], optional mask
// (none means weight 1), any Cin read in place (a view, or two parts split
// along channels: below), Cout up to 128, any R whose plan fits (below);
// and its float32 instances
// of both designs (below the bf16 kernels: float32 throughout, 3xTF32 on
// the tensor cores).
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
// Input and output in place (the bf16 instances of both designs): the input
// is a channels-contiguous NHWC view, its image, row and pixel strides
// multiples of 8 elements, in one part or two split along channels
// (common.cuh InputParts, part 0 a multiple of 8 channels); the tile
// loader takes each 16-byte unit's source from its channel and loads the
// channels past a part's end, up to the padded width, as zeros, so the
// tile holds what the zero-padded concatenation would. An input in one
// part runs the instances whose loader reads part 0 alone (TWO false), as
// the float32 instances do. The output's pixel
// stride `oc` is Cout or Cout padded to 8; the channels past Cout are
// written as zeros (not as the products of the packed weights' zero
// columns), so a consumer reads the padded buffer, or its [..., :Cout]
// view, without a copy.
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
// 8 x 16 by 7% at C=67 R=2 4x480x640. At its own shapes it beats the
// stream design (token `dcnCrR:stream`) at 480x640: 0.249 ms against
// 0.342 at C=64 R=1, 0.501 against 0.554 at C=67 R=2.
//
// Design "stream" (dcn_stream_kernel), for what no tile plan holds (the
// resident weights and an input buffer past the shared memory: Cin16 *
// Cout16 above ~11,000, e.g. C = 128 at any R; C = 67 at R >= 7; C = 64 at
// R >= 9): the tile design's GEMM core, its tiles and its numerics, with
// the weights streamed instead of resident.
// - Persistent blocks walk output tiles of TH x 16 pixels (TH = 8 or 4),
//   one warp a tile row, with a stride of the grid.
// - A tile's input with its halo, (TH + 2 + 2R) x (18 + 2R) pixels, is
//   staged in channel chunks of `ck` (all of Cin16 where it fits), into
//   one buffer after the chunk's last gather.
// - A step is (tile, chunk, tap): one block barrier, after which the next
//   step's weight slice [ck][Cout16] (rows padded by 8 channels) is copied
//   (cp.async) into the other of two slots while each warp builds its slab
//   from the chunk (positions, corners and weights in registers) and
//   multiplies it by this step's slice. A block reads each weight once a
//   tile: at C = 128, ~0.3 MB for 128 output pixels.
// - Epilogue from registers, as the tile design's.
// The plan takes the larger tile, then the widest chunk (Cin16 split into
// the fewest equal multiples of 16) whose slices, buffer and slabs fit,
// first with the tile design's odd pixel stride and, past that, with the
// chunk's pieces unpadded. It holds every Cin <= 128, Cout <= 128 at
// R <= 35 (tests/test_torch_dcn_plan.py): no narrower design is needed.
// On an H100 (tools/conv_turns.py, in turns) 8 x 16 tiles beat 16 x 16
// ones (16 warps: 128 registers a thread, which spills at C = 128) by 3-9%
// at C=67 R=8, C=128 R=4 and R=8, 480x640, so no 16-row tile is tried.
//
// Both designs share their sampling, blend, epilogue and launcher (the
// helpers below); they differ in where the weights live and how the
// input is staged.

#include "common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTAPS = 9;
constexpr int MAX_COUT = 128;
constexpr int TILE_W = 16;        // output tile columns: one m16 fragment
constexpr int ROW_PAD = 8;        // slab and weight row padding (bf16)

// T: the element type, bf16 or float (the float32 instances, below).
template <typename T>
struct DcnParamsT {
  InputParts<T> x;      // (B, H, W, c0 + c1) in one or two parts, read in place
  const T* offset;      // (B, H, W, 18): (dy, dx) of tap t at 2t, 2t + 1
  const T* mask;        // (B, H, W, 9), or null: weight 1
  const T* w;           // bf16: (9 * Cin16, Cout16), row t * Cin16 + c, zero padded;
                        // float32: (Cout16, 9 * Cin), column t * Cin + c
  const float* bias;    // (Cout16,), zero padded
  T* out;               // (B, H, W, oc): channels past Cout written as zeros
  int B, H, W, Cin, Cout, R, Cin16;   // Cin: c0 + c1 padded to 8
  int oc;               // the output's pixel stride: Cout, or Cout padded to 8 (bf16)
  int xu;               // input-tile pixel stride in 16-byte units
  int chans;            // tile: slab channels a pass; stream: a chunk's
  int nchunks;          // stream: chunks of Cin16
  int nbuf;             // tile: input-tile buffers (stream: one)
  int w_bytes;          // tile: the resident weights; stream: one slice
  int x_bytes;          // one input-tile buffer
  int tiles_x, tiles_y, tiles;
};
using DcnParams = DcnParamsT<bf16>;

// Input-tile pixel stride in 16-byte units: the Cin / 8 pieces of a pixel,
// plus one where that count is even (ops/cuda/sampling.py `_dcn_xu`).
__host__ __device__ inline int dcn_xu(int cin) { return cin / 8 + ((cin / 8) % 2 == 0); }

// Tile `tile`'s image b and tile row / column.
template <typename T>
__device__ __forceinline__ void tile_origin(const DcnParamsT<T>& p, int tile, int& b, int& ty,
                                            int& tx) {
  const int per_img = p.tiles_x * p.tiles_y;
  b = tile / per_img;
  const int r = tile - b * per_img;
  ty = r / p.tiles_x;
  tx = r - ty * p.tiles_x;
}

// Output pixel (gy, gx) of image b: its offsets (dy, dx as one bf16 pair a
// tap) and mask bits; zeros past the image.
__device__ __forceinline__ void load_meta(const DcnParams& p, int b, int gy, int gx,
                                          uint32_t (&off)[NTAPS], uint32_t (&msk)[NTAPS]) {
  const bool in = gy < p.H && gx < p.W;
  const size_t pix = ((size_t)b * p.H + (in ? gy : 0)) * p.W + (in ? gx : 0);
  const uint32_t* op = reinterpret_cast<const uint32_t*>(p.offset + pix * 18);
  const unsigned short* mp = reinterpret_cast<const unsigned short*>(p.mask + pix * 9);
#pragma unroll
  for (int t = 0; t < NTAPS; ++t) {
    off[t] = in ? __ldg(op + t) : 0u;
    msk[t] = p.mask ? (in ? (uint32_t)__ldg(mp + t) : 0u) : 0x3F80u;  // bf16 1.0
  }
}

// Copy rows x tcols input pixels from image origin (y0, x0), `np` 16-byte
// pieces a pixel (8 bf16 or 4 float32 channels) from channel ch0 on, into
// `dst` at `xu` pieces a pixel (cp.async, zeros outside the image and past
// the input's channels); threads `NT` apart. TWO: the input in two parts
// (else part 0 alone: common.cuh InputParts::load).
template <int NT, bool TWO, typename T>
__device__ __forceinline__ void stage_input(const DcnParamsT<T>& p, unsigned char* dst, int b,
                                            int y0, int x0, int tpx, int tcols, int ch0,
                                            int np) {
  constexpr int PER = 16 / sizeof(T);   // channels a piece
  const uint32_t mag_np = fast_div_magic(np > 1 ? np : 2);
  const uint32_t mag_tcols = fast_div_magic(tcols);
  const auto img = p.x.image(b);
  for (int it = threadIdx.x; it < tpx * np; it += NT) {
    const int pix = np > 1 ? fast_div(it, mag_np) : it;
    const int pc = it - pix * np;
    const int row = fast_div(pix, mag_tcols), col = pix - row * tcols;
    const int gy = y0 + row, gx = x0 + col;
    p.x.template load<TWO>(dst + (pix * p.xu + pc) * 16, img, gy, gx, ch0 + pc * PER,
                           gy >= 0 && gy < p.H && gx >= 0 && gx < p.W);
  }
}

// One sample: its four corners in the input tile and their weights.
struct Sample {
  const unsigned char* c[4];
  float w[4];
};

// Output pixel (gy, gx) at tap t, from its offset (oy, ox) and mask m, in
// the input tile at `xbuf` (`xu` 16-byte units a pixel) whose pixel (0, 0)
// is image pixel (y0, x0). Offsets are clamped to [-R, R], so every corner
// lies in the tile but the far row or column of a sample exactly on the
// tile's last row or column, whose weight is exactly 0: clamped onto the
// tile. A corner outside the image reads the tile's zeros.
__device__ __forceinline__ Sample tap_sample_at(const unsigned char* xbuf, float oy, float ox,
                                                float m, int t, int gy, int gx, int y0, int x0,
                                                int R, int trows_1, int tcols, int xu) {
  const float r = (float)R;
  const float dy = fminf(fmaxf(oy, -r), r), dx = fminf(fmaxf(ox, -r), r);
  const float fyp = (float)(gy + t / 3 - 1) + dy;
  const float fxp = (float)(gx + t % 3 - 1) + dx;
  const float y0f = floorf(fyp), x0f = floorf(fxp);
  const float fy = fyp - y0f, fx = fxp - x0f;
  const int ry = (int)y0f - y0, rx = (int)x0f - x0;
  const int ry1 = min(ry + 1, trows_1), rx1 = min(rx + 1, tcols - 1);
  const float wy0 = 1.0f - fy, wx0 = 1.0f - fx;
  Sample s;
  s.w[0] = __fmul_rn(__fmul_rn(wy0, wx0), m);
  s.w[1] = __fmul_rn(__fmul_rn(wy0, fx), m);
  s.w[2] = __fmul_rn(__fmul_rn(fy, wx0), m);
  s.w[3] = __fmul_rn(__fmul_rn(fy, fx), m);
  s.c[0] = xbuf + (ry * tcols + rx) * xu * 16;
  s.c[1] = xbuf + (ry * tcols + rx1) * xu * 16;
  s.c[2] = xbuf + (ry1 * tcols + rx) * xu * 16;
  s.c[3] = xbuf + (ry1 * tcols + rx1) * xu * 16;
  return s;
}

// As tap_sample_at, from the tap's bf16 offset word ot and mask bits mt.
__device__ __forceinline__ Sample tap_sample(const unsigned char* xbuf, uint32_t ot, uint32_t mt,
                                             int t, int gy, int gx, int y0, int x0, int R,
                                             int trows_1, int tcols, int xu) {
  const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ot));
  const float m = __bfloat162float(__ushort_as_bfloat16((unsigned short)mt));
  return tap_sample_at(xbuf, d.x, d.y, m, t, gy, gx, y0, x0, R, trows_1, tcols, xu);
}

// The sample's 8 channels at byte `o` of each corner: the float32 blend in
// the order (y0, x0), (y0, x1), (y1, x0), (y1, x1), no fused multiply-add,
// rounded once to bf16.
__device__ __forceinline__ uint4 blend_piece(const Sample& s, int o) {
  const uint4 v0 = *reinterpret_cast<const uint4*>(s.c[0] + o);
  const uint4 v1 = *reinterpret_cast<const uint4*>(s.c[1] + o);
  const uint4 v2 = *reinterpret_cast<const uint4*>(s.c[2] + o);
  const uint4 v3 = *reinterpret_cast<const uint4*>(s.c[3] + o);
  const uint32_t a0[4] = {v0.x, v0.y, v0.z, v0.w}, a1[4] = {v1.x, v1.y, v1.z, v1.w};
  const uint32_t a2[4] = {v2.x, v2.y, v2.z, v2.w}, a3[4] = {v3.x, v3.y, v3.z, v3.w};
  uint32_t out[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a0[e]));
    const float2 f1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a1[e]));
    const float2 f2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a2[e]));
    const float2 f3 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a3[e]));
    float lo = __fmul_rn(s.w[0], f0.x), hi = __fmul_rn(s.w[0], f0.y);
    lo = __fadd_rn(lo, __fmul_rn(s.w[1], f1.x));
    hi = __fadd_rn(hi, __fmul_rn(s.w[1], f1.y));
    lo = __fadd_rn(lo, __fmul_rn(s.w[2], f2.x));
    hi = __fadd_rn(hi, __fmul_rn(s.w[2], f2.y));
    lo = __fadd_rn(lo, __fmul_rn(s.w[3], f3.x));
    hi = __fadd_rn(hi, __fmul_rn(s.w[3], f3.y));
    out[e] = pack_bf16x2(lo, hi);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// Tap t's words of the per-tap registers, without local-memory indexing.
__device__ __forceinline__ void tap_words(const uint32_t (&off)[NTAPS],
                                          const uint32_t (&msk)[NTAPS], int t, uint32_t& ot,
                                          uint32_t& mt) {
  ot = off[0];
  mt = msk[0];
#pragma unroll
  for (int k = 1; k < NTAPS; ++k)
    if (t == k) { ot = off[k]; mt = msk[k]; }
}

// The warp's m16 fragment of output row oy, columns ox0 .. ox0 + 15, of
// image b: the bias added, one rounding, a quad-lane transpose, 16-byte
// stores where the output's pixel stride `oc` is a multiple of 8 (the
// channels past Cout zeroed first), 2-byte ones else; the accumulators are
// zeroed after.
template <int NF>
__device__ __forceinline__ void store_epilogue(const DcnParams& p, float (&acc)[NF][4], int b,
                                               int oy, int ox0, int lane) {
  const int g8 = lane >> 2, q4 = lane & 3;
  const bool vec = (p.oc % 8) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ox = ox0 + g8 + 8 * h;
    const bool inimg = oy < p.H && ox < p.W;
    bf16* orow = p.out + (((size_t)b * p.H + oy) * p.W + ox) * p.oc;
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
      if (inimg && j0 + q4 < NF && ch0 < p.oc) {
        if (vec) {
#pragma unroll
          for (int e = 0; e < 8; ++e)   // the padding channels: zeros
            if (ch0 + e >= p.Cout) u[e >> 1] &= (e & 1) ? 0x0000FFFFu : 0xFFFF0000u;
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
}

// The warp's slab times weight rows at `b_lane` (`WP` bf16 a row): kw / 16
// k16 steps of mma.sync m16n8k16 into acc. A fragments from the slab
// (ldmatrix), B from the weights (ldmatrix.trans).
template <int NF, int WP>
__device__ __forceinline__ void slab_mma(float (&acc)[NF][4], uint32_t a_lane, uint32_t b_lane,
                                         int kw) {
  for (int kk = 0; kk < kw / 16; ++kk) {
    uint32_t fa[4];
    ldsm_x4(fa, a_lane + kk * 16 * 2);
#pragma unroll
    for (int j = 0; j < NF; j += 2) {
      uint32_t fb0[2], fb1[2];
      ldsm_x4_t(fb0, fb1, b_lane + kk * 16 * WP * 2 + j * 16);
      mma_bf16(acc[j], fa, fb0);
      mma_bf16(acc[j + 1], fa, fb1);
    }
  }
}

// ---------------------------------------------------------------------------
// Design "tile": TH output tile rows, one warp a row (an m16 fragment of 16
// pixels); NF n8 fragments: Cout16 = 8 * NF; TWO: the input in two parts
// (stage_input).
template <int TH, int NF, bool TWO>
__global__ void __launch_bounds__(TH * 32, 1)
dcn_tile_kernel(const DcnParams p) {
  constexpr int NT = TH * 32;       // threads
  constexpr int WP = 8 * NF + ROW_PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = p.R, Cin16 = p.Cin16;
  const int tcols = TILE_W + 2 + 2 * R, tpx = (TH + 2 + 2 * R) * tcols;
  const int trows_1 = TH + 1 + 2 * R;
  const int cin8 = p.Cin / 8, xu = p.xu, sk = p.chans, sp = sk + ROW_PAD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* const ws = reinterpret_cast<bf16*>(smem);
  unsigned char* const xs = smem + p.w_bytes;
  bf16* const ss = reinterpret_cast<bf16*>(smem + p.w_bytes + p.nbuf * p.x_bytes) +
                   warp * TILE_W * sp;

  // The lane's pixel in the slab build (and whose offsets it holds): column
  // pcol of tile row `warp`; it builds the pixel's 8-channel pieces sub,
  // sub + 2, ... and lane pcol + 16 the others.
  const int pcol = lane & 15, sub = lane >> 4;
  auto stage_x = [&](int tile, int buf) {   // the tile's input and halo
    int b, ty, tx;
    tile_origin(p, tile, b, ty, tx);
    stage_input<NT, TWO>(p, xs + buf * p.x_bytes, b, ty * TH - 1 - R, tx * TILE_W - 1 - R, tpx,
                    tcols, 0, cin8);
  };
  auto meta = [&](int tile, uint32_t (&off)[NTAPS], uint32_t (&msk)[NTAPS]) {
    int b, ty, tx;
    tile_origin(p, tile, b, ty, tx);
    load_meta(p, b, ty * TH + warp, tx * TILE_W + pcol, off, msk);
  };

  int tile = blockIdx.x;
  if (tile >= p.tiles) return;
  for (int it = threadIdx.x; it < NTAPS * Cin16 * NF; it += NT) {   // all weights, once
    const int row = it / NF, pc = it - row * NF;
    cp_async16(ws + row * WP + pc * 8, p.w + (size_t)row * (8 * NF) + pc * 8);
  }
  stage_x(tile, 0);
  cp_async_commit();
  uint32_t off[NTAPS], msk[NTAPS];
  meta(tile, off, msk);

  float acc[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  // ldmatrix lane addresses: A rows are the fragment's 16 pixels of the
  // slab (8 channels on for the upper lanes), B rows 16 weight rows.
  const uint32_t a_lane = smem_u32(ss) + ((lane & 15) * sp + (lane >> 4) * 8) * 2;
  const uint32_t b_lane = smem_u32(ws) + ((lane & 15) * WP + (lane >> 4) * 8) * 2;
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
    if (more) meta(next, noff, nmsk);

    int b, ty, tx;
    tile_origin(p, tile, b, ty, tx);
    const int gy = ty * TH + warp, gx = tx * TILE_W + pcol;
    const unsigned char* xbuf = xs + buf * p.x_bytes;
    for (int t = 0; t < NTAPS; ++t) {
      uint32_t ot, mt;
      tap_words(off, msk, t, ot, mt);
      const Sample s = tap_sample(xbuf, ot, mt, t, gy, gx, ty * TH - 1 - R,
                                  tx * TILE_W - 1 - R, R, trows_1, tcols, xu);
      for (int k0 = 0; k0 < Cin16; k0 += sk) {
        const int skw = min(sk, Cin16 - k0);
        // The slab: pieces sub, sub + 2, ... of the lane's pixel.
        for (int j = sub; j < skw / 8; j += 2) {
          const int pc = k0 / 8 + j;
          *reinterpret_cast<uint4*>(ss + pcol * sp + j * 8) =
              pc < cin8 ? blend_piece(s, pc * 16) : make_uint4(0u, 0u, 0u, 0u);
        }
        __syncwarp();
        // out[pixels][Cout16] += slab @ W[t * Cin16 + k0 ..][:]
        slab_mma<NF, WP>(acc, a_lane, b_lane + (t * Cin16 + k0) * WP * 2, skw);
        __syncwarp();
      }
    }

    if (p.nbuf == 1 && more) {  // every gather from the one buffer is done
      __syncthreads();
      stage_x(next, 0);
      cp_async_commit();
    }
    store_epilogue<NF>(p, acc, b, ty * TH + warp, tx * TILE_W, lane);
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

// ---------------------------------------------------------------------------
// Design "stream": TH output tile rows, one warp a row; NF n8 fragments. A
// step is (tile, chunk, tap); TWO as in the tile design.
template <int TH, int NF, bool TWO>
__global__ void __launch_bounds__(TH * 32, 1)
dcn_stream_kernel(const DcnParams p) {
  constexpr int NT = TH * 32;       // threads
  constexpr int WP = 8 * NF + ROW_PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = p.R, Cin16 = p.Cin16;
  const int tcols = TILE_W + 2 + 2 * R, tpx = (TH + 2 + 2 * R) * tcols;
  const int trows_1 = TH + 1 + 2 * R;
  const int cin8 = p.Cin / 8, xu = p.xu, ck = p.chans, sp = ck + ROW_PAD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* const wsm = smem;                       // two weight slices
  unsigned char* const xs = smem + 2 * p.w_bytes;        // the input buffer
  bf16* const ss = reinterpret_cast<bf16*>(xs + p.x_bytes) + warp * TILE_W * sp;

  const int pcol = lane & 15, sub = lane >> 4;   // as in the tile design
  // Chunk c of tile `tile`'s input and halo.
  auto stage_x = [&](int tile, int c) {
    int b, ty, tx;
    tile_origin(p, tile, b, ty, tx);
    stage_input<NT, TWO>(p, xs, b, ty * TH - 1 - R, tx * TILE_W - 1 - R, tpx, tcols, c * ck,
                         min(ck, p.Cin - c * ck) / 8);
  };
  // The weight slice of (chunk c, tap t): packed rows t * Cin16 + c * ck ...
  // into slot `slot`.
  auto stage_w = [&](int c, int t, int slot) {
    const int rows = min(ck, Cin16 - c * ck);
    const bf16* src = p.w + ((size_t)t * Cin16 + c * ck) * (8 * NF);
    bf16* dst = reinterpret_cast<bf16*>(wsm + slot * p.w_bytes);
    for (int it = threadIdx.x; it < rows * NF; it += NT) {
      const int row = it / NF, pc = it - row * NF;
      cp_async16(dst + row * WP + pc * 8, src + row * (8 * NF) + pc * 8);
    }
  };
  auto meta = [&](int tile, uint32_t (&off)[NTAPS], uint32_t (&msk)[NTAPS]) {
    int b, ty, tx;
    tile_origin(p, tile, b, ty, tx);
    load_meta(p, b, ty * TH + warp, tx * TILE_W + pcol, off, msk);
  };

  int tile = blockIdx.x;
  if (tile >= p.tiles) return;
  stage_x(tile, 0);
  stage_w(0, 0, 0);
  cp_async_commit();
  uint32_t off[NTAPS], msk[NTAPS];
  meta(tile, off, msk);

  float acc[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  // ldmatrix lane addresses: A rows are the fragment's 16 pixels of the
  // slab (8 channels on for the upper lanes), B rows 16 weight-slice rows.
  const uint32_t a_lane = smem_u32(ss) + ((lane & 15) * sp + (lane >> 4) * 8) * 2;
  const uint32_t w_lane = smem_u32(wsm) + ((lane & 15) * WP + (lane >> 4) * 8) * 2;
  int slot = 0;
  while (true) {
    const int next = tile + gridDim.x;
    const bool more = next < p.tiles;
    int b, ty, tx;
    tile_origin(p, tile, b, ty, tx);
    const int gy = ty * TH + warp, gx = tx * TILE_W + pcol;
    for (int c = 0; c < p.nchunks; ++c) {
      const int k0 = c * ck, ckw = min(ck, Cin16 - k0);
      // The input stage after this one: the next chunk, or the next tile's
      // first.
      const bool staged = c + 1 < p.nchunks || more;
      const int s_tile = c + 1 < p.nchunks ? tile : next, s_c = c + 1 < p.nchunks ? c + 1 : 0;
      for (int t = 0; t < NTAPS; ++t) {
        cp_async_wait<0>();
        __syncthreads();  // this step's slice (and input chunk) is in; every warp is done with the last step
        if (t + 1 < NTAPS) stage_w(c, t + 1, slot ^ 1);
        else if (staged) stage_w(s_c, 0, slot ^ 1);
        cp_async_commit();

        uint32_t ot, mt;
        tap_words(off, msk, t, ot, mt);
        const Sample s = tap_sample(xs, ot, mt, t, gy, gx, ty * TH - 1 - R,
                                    tx * TILE_W - 1 - R, R, trows_1, tcols, xu);
        // The slab: pieces sub, sub + 2, ... of the lane's pixel's chunk.
        for (int j = sub; j < ckw / 8; j += 2)
          *reinterpret_cast<uint4*>(ss + pcol * sp + j * 8) =
              k0 / 8 + j < cin8 ? blend_piece(s, j * 16) : make_uint4(0u, 0u, 0u, 0u);
        __syncwarp();
        if (t == NTAPS - 1 && staged) {
          __syncthreads();  // every warp's last gather from the buffer is done
          stage_x(s_tile, s_c);
          cp_async_commit();
        }
        // out[pixels][Cout16] += slab @ slice
        slab_mma<NF, WP>(acc, a_lane, w_lane + slot * p.w_bytes, ckw);
        __syncwarp();
        slot ^= 1;
      }
    }
    store_epilogue<NF>(p, acc, b, ty * TH + warp, tx * TILE_W, lane);
    if (!more) break;
    meta(next, off, msk);   // read while the next step's barrier waits
    tile = next;
  }
}

// ---------------------------------------------------------------------------
// The float32 instances (`vfi_dcn_bounded_f32`): input, offsets, mask,
// weights, samples, slab and output in float32. The sampling and blend are
// the bf16 designs' without the slab's rounding, which is the plain
// version's float32 arithmetic; the GEMM's products are float32-accurate:
// 3xTF32 on the tensor cores (common.cuh; one TF32 pass would keep only 11
// bits of each operand), summed in float32.
// What bounds them: at 720p a 64-channel layer's 68 GFLOP are 204 GFLOP in
// three TF32 passes, 0.41 ms at the 495 TFLOP/s TF32 peak, against 0.47 GB
// (0.14 ms); beside them the gather and the blend, 4-byte corners now, on
// the CUDA cores, and the hi / lo split of every fragment.
// Both designs keep the bf16 designs' blocks, tiles, staging and barriers
// (a warp builds the slab of one tile row of 16 pixels), with 32-bit
// operands:
// - The slab is the A operand, [16 pixels][chans + 4] floats, K (channels)
//   contiguous, rows an odd multiple of 16 bytes; a lane writes its
//   pixel's blended 4-channel pieces as 16-byte stores. A fragments load
//   by ldmatrix .b16 without .trans (4-byte elements move whole).
// - The weights are B, packed [Cout16][9 * Cin] (column t * Cin + c, K
//   contiguous; Cin a multiple of 8), loaded by ldmatrix without .trans.
//   "tile" keeps them resident ([Cout16][9 Cin + 4] floats: 148,480 bytes
//   at C = 64, beside one input buffer of an 8 x 16 tile at R = 1: one
//   block of 8 warps an SM); "stream" copies a (chunk, tap) slice
//   [Cout16][chans + 4] at a time into two slots.
// - Each k-step splits the A and B fragments into hi and lo in registers
//   (three ALU instructions a register). In "tile" the warps work in
//   pairs: each multiplies both slabs of its pair (two m-fragments) by
//   half of Cout, so that a split B fragment serves two MMA triples (a
//   pair barrier after the slabs are built, one after the MMAs). In
//   "stream" a warp multiplies its own slab by all of Cout.
// - The MMAs go in three passes over the accumulators (lo hi, hi lo, hi
//   hi), so that neighbours write different accumulators.
// - Numerics: the MMAs' float32 accumulation truncates each sum (the
//   tensor cores' adder), a drift that grows with the k-steps it runs
//   over. So each tap's (tile) or step's (stream) sums go into a second
//   set of float32 registers, rounded to nearest (`flush_sums`; the next
//   tap's first MMA writes its accumulator from a zero C operand instead
//   of zeroing it), and no accumulator runs over more than F32_FLUSH_K
//   columns at any Cin.
// - Epilogue from registers: the bias, float32 stores of two channels a
//   lane.
// Measured in turns on an H100 (tools/conv_turns.py, C = 64, R = 1, 720p,
// device ms; PERF.md section 6), against 1.814 for a warp of one
// m-fragment without a flush: the pairs alone 1.772; a flush every tap
// alone 1.960; the two together 1.817, and the error against the plain
// version 5.7e-7 of max|plain| (4.9e-6 without the flush); pre-split hi /
// lo weights (twice the bytes, so streamed) 2.014.
// The plan (`dcn_plan(..., itemsize=4)`) takes the tile design on 8 x 16
// tiles (16 x 16 ones, 16 warps of at most 128 registers, would spill past
// Cout16 = 16 with the flushed sums) where the weights and one buffer fit
// and Cin8 <= F32_FLUSH_K, else the stream design (8 x 16, then 4 x 16
// tiles; chunks down to 8 channels, at most F32_FLUSH_K): on an H100 every
// Cin, Cout <= 128 at R <= 35 has one (at R = 35, 8-channel chunks of a 4
// x 16 tile: its input is 214 KB). The FFMA designs they replace were
// slower at every float32 shape a path runs (in turns on an H100,
// tools/conv_turns.py; PERF.md section 6).

constexpr int F_PAD = 4;   // slab and weight row padding, floats
// The most columns of K the MMAs sum before a flush (flush_sums;
// ops/cuda/conv.py F32_FLUSH_K).
constexpr int F32_FLUSH_K = 1152;

using DcnF32Params = DcnParamsT<float>;

// Output pixel (gy, gx) of image b: its offsets (dy, dx a tap) and mask;
// zeros past the image.
__device__ __forceinline__ void load_meta_f32(const DcnF32Params& p, int b, int gy, int gx,
                                              float2 (&off)[NTAPS], float (&msk)[NTAPS]) {
  const bool in = gy < p.H && gx < p.W;
  const size_t pix = ((size_t)b * p.H + (in ? gy : 0)) * p.W + (in ? gx : 0);
  const float2* op = reinterpret_cast<const float2*>(p.offset + pix * 18);
#pragma unroll
  for (int t = 0; t < NTAPS; ++t) {
    off[t] = in ? __ldg(op + t) : make_float2(0.0f, 0.0f);
    msk[t] = p.mask ? (in ? __ldg(p.mask + pix * 9 + t) : 0.0f) : 1.0f;
  }
}

// Tap t's offset and mask, without local-memory indexing.
__device__ __forceinline__ void tap_meta_f32(const float2 (&off)[NTAPS],
                                             const float (&msk)[NTAPS], int t, float2& o,
                                             float& m) {
  o = off[0];
  m = msk[0];
#pragma unroll
  for (int k = 1; k < NTAPS; ++k)
    if (t == k) { o = off[k]; m = msk[k]; }
}

// The sample's 4 channels at byte `o` of each corner: the float32 blend in
// the order (y0, x0), (y0, x1), (y1, x0), (y1, x1), no fused multiply-add.
__device__ __forceinline__ float4 blend_piece_f32(const Sample& s, int o) {
  const float4 v0 = *reinterpret_cast<const float4*>(s.c[0] + o);
  const float4 v1 = *reinterpret_cast<const float4*>(s.c[1] + o);
  const float4 v2 = *reinterpret_cast<const float4*>(s.c[2] + o);
  const float4 v3 = *reinterpret_cast<const float4*>(s.c[3] + o);
  auto mix = [&](float a, float b, float c, float d) {
    float r = __fmul_rn(s.w[0], a);
    r = __fadd_rn(r, __fmul_rn(s.w[1], b));
    r = __fadd_rn(r, __fmul_rn(s.w[2], c));
    return __fadd_rn(r, __fmul_rn(s.w[3], d));
  };
  return make_float4(mix(v0.x, v1.x, v2.x, v3.x), mix(v0.y, v1.y, v2.y, v3.y),
                     mix(v0.z, v1.z, v2.z, v3.z), mix(v0.w, v1.w, v2.w, v3.w));
}

// The n-fragments J0 .. J0 + G - 1 of a k-step (G = min(GM, N - J0)): B
// fragments from `b_addr` (`wp` floats a weight row) loaded (ldmatrix, no
// .trans) and split into hi and lo once for all MF m-fragments (ah, al),
// then three MMA passes into acc[.][J0 .. J0 + G - 1], each over all of
// the group's accumulators (lo_a hi_b, hi_a lo_b, hi_a hi_b: the small
// terms first), so that consecutive MMAs write different accumulators (an
// MMA on the accumulator of the one before it waits out its latency); then
// the next group. FIRST: the first pass writes acc (a zero C operand)
// instead of adding to it.
template <int MF, int N, int GM, bool FIRST, int J0>
__device__ __forceinline__ void mma_group_tf32(float (&acc)[MF][N][4],
                                               const uint32_t (&ah)[MF][4],
                                               const uint32_t (&al)[MF][4], uint32_t b_addr,
                                               int wp) {
  constexpr int G = N - J0 < GM ? N - J0 : GM;
  uint32_t fb[G][2], bh[G][2], bl[G][2];
#pragma unroll
  for (int j = 0; j + 1 < G; j += 2) ldsm_x4_b(fb[j], fb[j + 1], b_addr + (J0 + j) * 32 * wp);
  if constexpr (G % 2 == 1) ldsm_x2(fb[G - 1], b_addr + (J0 + G - 1) * 32 * wp);
#pragma unroll
  for (int j = 0; j < G; ++j) split_tf32(fb[j], bh[j], bl[j]);
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if constexpr (FIRST) mma_tf32_first(acc[i][J0 + j], al[i], bh[j]);
      else mma_tf32(acc[i][J0 + j], al[i], bh[j]);
    }
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < G; ++j) mma_tf32(acc[i][J0 + j], ah[i], bl[j]);
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < G; ++j) mma_tf32(acc[i][J0 + j], ah[i], bh[j]);
  if constexpr (J0 + G < N)
    mma_group_tf32<MF, N, GM, FIRST, J0 + G>(acc, ah, al, b_addr, wp);
}

// One k-step: MF slab rows of 16 pixels (m-fragments, `a_stride` bytes
// apart from `a_addr`) times the weight rows at `b_addr`, A split in
// registers, B in groups of up to GM n-fragments.
template <int MF, int N, int GM, bool FIRST>
__device__ __forceinline__ void kstep_tf32(float (&acc)[MF][N][4], uint32_t a_addr,
                                           int a_stride, uint32_t b_addr, int wp) {
  uint32_t fa[MF][4], ah[MF][4], al[MF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i) {
    ldsm_x4(fa[i], a_addr + i * a_stride);
    split_tf32(fa[i], ah[i], al[i]);
  }
  mma_group_tf32<MF, N, GM, FIRST, 0>(acc, ah, al, b_addr, wp);
}

// MF slabs times the weight rows at `b_lane` (`wp` floats a row): kw / 8
// k-steps of m16n8k8 in 3xTF32 into acc, A from the slab, B from the
// weights (ldmatrix, both without .trans; registers for the hi and lo of
// GM B fragments at a time). `fresh`: acc starts from these products (the
// first k-step's first pass writes it), where a flush has just taken its
// sums.
template <int MF, int N, int GM>
__device__ __forceinline__ void slab_mma_tf32(float (&acc)[MF][N][4], uint32_t a_lane,
                                              int a_stride, uint32_t b_lane, int kw, int wp,
                                              bool fresh) {
  int kk = 0;
  if (fresh) {
    kstep_tf32<MF, N, GM, true>(acc, a_lane, a_stride, b_lane, wp);
    kk = 1;
  }
  for (; kk < kw / 8; ++kk)
    kstep_tf32<MF, N, GM, false>(acc, a_lane + kk * 32, a_stride, b_lane + kk * 32, wp);
}

// tot += acc in float32, rounded to nearest: a flush. The tensor cores'
// float32 accumulation truncates each sum, a drift that grows with the
// k-steps an accumulator runs over; flushed every tap (tile) or step
// (stream), it runs over at most F32_FLUSH_K columns (the plan's bound on
// Cin8 and on the stream design's chunk). acc is left as it is: the next
// slab_mma_tf32(..., fresh) overwrites it.
template <int MF, int N>
__device__ __forceinline__ void flush_sums(float (&tot)[MF][N][4], const float (&acc)[MF][N][4]) {
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[i][j][e] = __fadd_rn(tot[i][j][e], acc[i][j][e]);
}

// An m16 fragment of output row oy, columns ox0 .. ox0 + 15, channels n0
// .. n0 + 8 N - 1, of image b, from its sums `acc`: the bias added,
// float32 out (two channels a lane); the sums are zeroed after.
template <int N>
__device__ __forceinline__ void store_epilogue_tf32(const DcnF32Params& p, float (&acc)[N][4],
                                                    int b, int oy, int ox0, int n0, int lane) {
  const int g8 = lane >> 2, q4 = lane & 3;
  const bool vec = (p.Cout % 2) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ox = ox0 + g8 + 8 * h;
    const bool inimg = oy < p.H && ox < p.W;
    float* orow = p.out + (((size_t)b * p.H + oy) * p.W + ox) * p.Cout;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int ch = n0 + j * 8 + q4 * 2;
      if (inimg && ch < p.Cout) {
        const float v0 = acc[j][2 * h] + p.bias[ch], v1 = acc[j][2 * h + 1] + p.bias[ch + 1];
        if (vec) {
          *reinterpret_cast<float2*>(orow + ch) = make_float2(v0, v1);
        } else {
          orow[ch] = v0;
          if (ch + 1 < p.Cout) orow[ch + 1] = v1;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
}

// The two warps of pair `pair` (ids 1 .. 8; 0 is __syncthreads).
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(pair + 1));
}

// Design "tile" in float32: TH warps, warp w builds the slab of tile row
// w; warps 2q and 2q + 1 (pair q) multiply both their rows (two
// m-fragments), each by half of Cout (NF / 2 n8 fragments; Cout16 = 8 NF),
// so that each split B fragment serves two m-fragments. The sums flush
// every tap.
template <int TH, int NF>
__global__ void __launch_bounds__(TH * 32, 1)
dcn_tile_tf32_kernel(const DcnF32Params p) {
  constexpr int NT = TH * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = p.R, Cin = p.Cin;
  const int tcols = TILE_W + 2 + 2 * R, tpx = (TH + 2 + 2 * R) * tcols;
  const int trows_1 = TH + 1 + 2 * R;
  const int pieces = Cin / 4, xu = p.xu, sk = p.chans, sp = sk + F_PAD;
  const int wp = NTAPS * Cin + F_PAD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const ws = reinterpret_cast<float*>(smem);
  unsigned char* const xs = smem + p.w_bytes;
  float* const ss = reinterpret_cast<float*>(xs + p.x_bytes) + warp * TILE_W * sp;
  // Slab build: the lane's pixel column pcol of tile row `warp`, pieces
  // sub, sub + 2, ...
  const int pcol = lane & 15, sub = lane >> 4;
  auto stage_x = [&](int tile) {
    int b, ty, tx;
    tile_origin(p, tile, b, ty, tx);
    stage_input<NT, false>(p, xs, b, ty * TH - 1 - R, tx * TILE_W - 1 - R, tpx, tcols, 0,
                           pieces);
  };
  auto meta = [&](int tile, float2 (&off)[NTAPS], float (&msk)[NTAPS]) {
    int b, ty, tx;
    tile_origin(p, tile, b, ty, tx);
    load_meta_f32(p, b, ty * TH + warp, tx * TILE_W + pcol, off, msk);
  };

  int tile = blockIdx.x;
  if (tile >= p.tiles) return;
  const int wq = NTAPS * Cin / 4;   // 16-byte pieces of a weight row
  for (int it = threadIdx.x; it < 8 * NF * wq; it += NT) {   // all weights, once
    const int o = it / wq, pc = it - o * wq;
    cp_async16(ws + o * wp + pc * 4, p.w + (size_t)o * NTAPS * Cin + pc * 4);
  }
  stage_x(tile);
  cp_async_commit();
  float2 off[NTAPS];
  float msk[NTAPS];
  meta(tile, off, msk);
  constexpr int NH = NF / 2;
  const int pair = warp >> 1, half = warp & 1;
  float acc[2][NH][4], tot[2][NH][4];   // the MMAs' sums of a tap; the tile's
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e] = 0.0f;

  // ldmatrix lane addresses: A rows are the 16 pixels of the pair's first
  // slab (4 channels on for the upper lanes; the second slab follows it),
  // B rows the warp's half of the output channels.
  const uint32_t a_lane = smem_u32(ss - half * TILE_W * sp) +
                          ((lane & 15) * sp + (lane >> 4) * 4) * 4;
  const uint32_t b_lane = smem_u32(ws) + half * NH * 32 * wp +
      (((lane & 7) + ((lane >> 4) << 3)) * wp + ((lane >> 3) & 1) * 4) * 4;
  while (true) {
    cp_async_wait<0>();
    __syncthreads();  // this tile's input is in
    const int next = tile + gridDim.x;
    const bool more = next < p.tiles;
    int b, ty, tx;
    tile_origin(p, tile, b, ty, tx);
    const int gy = ty * TH + warp, gx = tx * TILE_W + pcol;
    for (int t = 0; t < NTAPS; ++t) {
      float2 o;
      float m;
      tap_meta_f32(off, msk, t, o, m);
      const Sample s = tap_sample_at(xs, o.x, o.y, m, t, gy, gx, ty * TH - 1 - R,
                                     tx * TILE_W - 1 - R, R, trows_1, tcols, xu);
      for (int k0 = 0; k0 < Cin; k0 += sk) {
        const int skw = min(sk, Cin - k0);
        for (int j = sub; j < skw / 4; j += 2)
          *reinterpret_cast<float4*>(ss + pcol * sp + j * 4) =
              blend_piece_f32(s, (k0 / 4 + j) * 16);
        pair_sync(pair);  // both slabs of the pair are in
        // out[2 rows][half of Cout16] (+)= slabs @ W[half, t * Cin + k0 ..]^T
        slab_mma_tf32<2, NH, 4>(acc, a_lane, TILE_W * sp * 4, b_lane + (t * Cin + k0) * 4,
                                skw, wp, k0 == 0);
        pair_sync(pair);  // both warps are done with both slabs
      }
      flush_sums(tot, acc);
    }
    if (more) {  // every gather from the buffer is done
      __syncthreads();
      stage_x(next);
      cp_async_commit();
      meta(next, off, msk);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      store_epilogue_tf32<NH>(p, tot[i], b, ty * TH + 2 * pair + i, tx * TILE_W,
                              half * NH * 8, lane);
    if (!more) break;
    tile = next;
  }
}

// Design "stream" in float32 on the tensor cores: TH warps, warp w tile row
// w; a step is (tile, chunk, tap), as the bf16 stream design's.
template <int TH, int NF>
__global__ void __launch_bounds__(TH * 32, 1)
dcn_stream_tf32_kernel(const DcnF32Params p) {
  constexpr int NT = TH * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = p.R, Cin = p.Cin;
  const int tcols = TILE_W + 2 + 2 * R, tpx = (TH + 2 + 2 * R) * tcols;
  const int trows_1 = TH + 1 + 2 * R;
  const int xu = p.xu, ck = p.chans, sp = ck + F_PAD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* const wsm = smem;                       // two weight slices
  unsigned char* const xs = smem + 2 * p.w_bytes;        // the input buffer
  float* const ss = reinterpret_cast<float*>(xs + p.x_bytes) + warp * TILE_W * sp;
  const int pcol = lane & 15, sub = lane >> 4;   // as in the tile design
  // Chunk c of tile `tile`'s input and halo.
  auto stage_x = [&](int tile, int c) {
    int b, ty, tx;
    tile_origin(p, tile, b, ty, tx);
    stage_input<NT, false>(p, xs, b, ty * TH - 1 - R, tx * TILE_W - 1 - R, tpx, tcols,
                           c * ck, min(ck, Cin - c * ck) / 4);
  };
  // The weight slice of (chunk c, tap t): packed columns t * Cin + c * ck ..
  // of every row, as [Cout16][sp] in slot `slot`.
  auto stage_w = [&](int c, int t, int slot) {
    const int q = min(ck, Cin - c * ck) / 4;
    const float* src = p.w + (size_t)t * Cin + c * ck;
    float* dst = reinterpret_cast<float*>(wsm + slot * p.w_bytes);
    for (int it = threadIdx.x; it < 8 * NF * q; it += NT) {
      const int o = it / q, pc = it - o * q;
      cp_async16(dst + o * sp + pc * 4, src + (size_t)o * NTAPS * Cin + pc * 4);
    }
  };
  auto meta = [&](int tile, float2 (&off)[NTAPS], float (&msk)[NTAPS]) {
    int b, ty, tx;
    tile_origin(p, tile, b, ty, tx);
    load_meta_f32(p, b, ty * TH + warp, tx * TILE_W + pcol, off, msk);
  };

  int tile = blockIdx.x;
  if (tile >= p.tiles) return;
  stage_x(tile, 0);
  stage_w(0, 0, 0);
  cp_async_commit();
  float2 off[NTAPS];
  float msk[NTAPS];
  meta(tile, off, msk);
  float acc[1][NF][4], tot[1][NF][4];   // the MMAs' sums of a step; the tile's
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] = tot[0][j][e] = 0.0f;

  const uint32_t a_lane = smem_u32(ss) + ((lane & 15) * sp + (lane >> 4) * 4) * 4;
  const uint32_t w_lane =
      smem_u32(wsm) + (((lane & 7) + ((lane >> 4) << 3)) * sp + ((lane >> 3) & 1) * 4) * 4;
  int slot = 0;
  while (true) {
    const int next = tile + gridDim.x;
    const bool more = next < p.tiles;
    int b, ty, tx;
    tile_origin(p, tile, b, ty, tx);
    const int gy = ty * TH + warp, gx = tx * TILE_W + pcol;
    for (int c = 0; c < p.nchunks; ++c) {
      const int ckw = min(ck, Cin - c * ck);
      const bool staged = c + 1 < p.nchunks || more;
      const int s_tile = c + 1 < p.nchunks ? tile : next, s_c = c + 1 < p.nchunks ? c + 1 : 0;
      for (int t = 0; t < NTAPS; ++t) {
        cp_async_wait<0>();
        __syncthreads();  // this step's slice (and input chunk) is in; the last step is done
        if (t + 1 < NTAPS) stage_w(c, t + 1, slot ^ 1);
        else if (staged) stage_w(s_c, 0, slot ^ 1);
        cp_async_commit();

        float2 o;
        float m;
        tap_meta_f32(off, msk, t, o, m);
        const Sample s = tap_sample_at(xs, o.x, o.y, m, t, gy, gx, ty * TH - 1 - R,
                                       tx * TILE_W - 1 - R, R, trows_1, tcols, xu);
        for (int j = sub; j < ckw / 4; j += 2)
          *reinterpret_cast<float4*>(ss + pcol * sp + j * 4) = blend_piece_f32(s, j * 16);
        __syncwarp();
        if (t == NTAPS - 1 && staged) {
          __syncthreads();  // every warp's last gather from the buffer is done
          stage_x(s_tile, s_c);
          cp_async_commit();
        }
        // Groups of 4 past NF = 8: tot holds 4 NF registers more.
        slab_mma_tf32<1, NF, (NF <= 8 ? 8 : 4)>(acc, a_lane, 0, w_lane + slot * p.w_bytes, ckw,
                                                sp, true);
        flush_sums(tot, acc);
        __syncwarp();
        slot ^= 1;
      }
    }
    store_epilogue_tf32<NF>(p, tot[0], b, ty * TH + warp, tx * TILE_W, 0, lane);
    if (!more) break;
    meta(next, off, msk);
    tile = next;
  }
}

// The instance of design `design` (0 tile, 1 stream) for `rows` tile rows,
// Cout16 = 8 * nf and an input in two parts (TWO) or one.
template <int NF, bool TWO>
void (*pick_nf(int design, int rows))(DcnParams) {
  if (design == 0)
    return rows == 16 ? &dcn_tile_kernel<16, NF, TWO> : &dcn_tile_kernel<8, NF, TWO>;
  return rows == 8 ? &dcn_stream_kernel<8, NF, TWO> : &dcn_stream_kernel<4, NF, TWO>;
}

// The float32 instance of design `design` (0 tile: 8 rows; 1 stream: 8 or
// 4 rows) for Cout16 = 8 * NF. (16-row tiles, 16 warps of at most 128
// registers, would spill past Cout16 = 16 with the tile's flushed sums.)
template <int NF>
void (*pick_nf_f32(int design, int rows))(DcnF32Params) {
  if (design == 0) return &dcn_tile_tf32_kernel<8, NF>;
  return rows == 8 ? &dcn_stream_tf32_kernel<8, NF> : &dcn_stream_tf32_kernel<4, NF>;
}

void (*pick_kernel_f32(int design, int rows, int nf))(DcnF32Params) {
  switch (nf) {
    case 2: return pick_nf_f32<2>(design, rows);
    case 4: return pick_nf_f32<4>(design, rows);
    case 6: return pick_nf_f32<6>(design, rows);
    case 8: return pick_nf_f32<8>(design, rows);
    case 10: return pick_nf_f32<10>(design, rows);
    case 12: return pick_nf_f32<12>(design, rows);
    case 14: return pick_nf_f32<14>(design, rows);
    default: return pick_nf_f32<16>(design, rows);
  }
}

template <bool TWO>
void (*pick_kernel(int design, int rows, int nf))(DcnParams) {
  switch (nf) {
    case 2: return pick_nf<2, TWO>(design, rows);
    case 4: return pick_nf<4, TWO>(design, rows);
    case 6: return pick_nf<6, TWO>(design, rows);
    case 8: return pick_nf<8, TWO>(design, rows);
    case 10: return pick_nf<10, TWO>(design, rows);
    case 12: return pick_nf<12, TWO>(design, rows);
    case 14: return pick_nf<14, TWO>(design, rows);
    default: return pick_nf<16, TWO>(design, rows);
  }
}

}  // namespace

// Launch one bounded DCN layer (integer radius R >= 0, 1 <= Cout <= 128,
// `mask` null for weight 1) of the input in parts (x0, its image, row and
// pixel strides in elements, c0 channels; x1 likewise, c1 = 0 for none:
// common.cuh InputParts) into `out` of pixel stride `oc` (Cout, or Cout
// padded to 8 with the padding channels written as zeros), on the plan of
// `dcn_plan` (ops/cuda/sampling.py) for Cin = c0 + c1 padded to 8. `rows`
// output tile rows, `chans` channels a slab
// pass (design 0, "tile": 16 or 8 rows, weights resident) or a chunk
// (design 1, "stream": 8 or 4 rows, weights streamed a tap at a time),
// `nbuf` input-tile buffers (1 or 2; the stream design takes 1) of
// `x_bytes` each with a pixel stride of `xu` 16-byte units. `smem`: the
// plan's dynamic shared memory in bytes. Returns the cudaError_t of the
// launch; cudaErrorInvalidValue for arguments out of range, an input
// layout the loader cannot read, a plan whose regions overrun `smem`, or
// offsets off 4-byte alignment.
extern "C" int vfi_dcn_bounded_bf16(const void* x0, long long sb0, long long sy0,
                                    long long sx0, int c0, const void* x1, long long sb1,
                                    long long sy1, long long sx1, int c1, const void* offset,
                                    const void* mask, const void* w, const void* bias,
                                    void* out, int oc, int B, int H, int W, int Cout, int R,
                                    int design, int rows, int chans, int nbuf, int xu,
                                    int x_bytes, int smem, int device, void* stream) {
  DcnParams p{};
  if (!make_parts(p.x, H, W, x0, sb0, sy0, sx0, c0, x1, sb1, sy1, sx1, c1))
    return (int)cudaErrorInvalidValue;
  const int Cin = (c0 + c1 + 7) / 8 * 8;
  if (Cout < 1 || Cout > MAX_COUT || R < 0 || B < 0 || H < 0 || W < 0 || smem < 0 ||
      chans < 16 || chans % 16 != 0 || (nbuf != 1 && nbuf != 2) || x_bytes % 128 != 0 ||
      reinterpret_cast<uintptr_t>(offset) % 4 != 0 ||
      (oc != Cout && oc != (Cout + 7) / 8 * 8) || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int cin16 = pad16(Cin), cout16 = pad16(Cout);
  if (chans > cin16 || (design != 0 && design != 1) ||
      (design == 0 && rows != 16 && rows != 8) ||
      (design == 1 && ((rows != 8 && rows != 4) || nbuf != 1)))
    return (int)cudaErrorInvalidValue;
  const long long tpx = (long long)(rows + 2 + 2 * R) * (TILE_W + 2 + 2 * R);
  const long long s_bytes = 2LL * rows * TILE_W * (chans + ROW_PAD);
  // The resident weights (tile) or one of two weight slices (stream).
  const long long w_bytes = design == 0 ? 2LL * NTAPS * cin16 * (cout16 + ROW_PAD)
                                        : 2LL * chans * (cout16 + ROW_PAD);
  const int pieces = (chans < Cin ? chans : Cin) / 8;
  if ((design == 0 ? xu != dcn_xu(Cin) : xu < pieces) || x_bytes < 16 * tpx * xu ||
      smem < (design == 0 ? 1 : 2) * w_bytes + (long long)nbuf * x_bytes + s_bytes)
    return (int)cudaErrorInvalidValue;
  p.offset = static_cast<const bf16*>(offset);
  p.mask = static_cast<const bf16*>(mask);
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<bf16*>(out);
  p.B = B; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout; p.R = R; p.Cin16 = cin16;
  p.oc = oc; p.xu = xu; p.chans = chans; p.nchunks = (cin16 + chans - 1) / chans; p.nbuf = nbuf;
  p.w_bytes = (int)w_bytes; p.x_bytes = x_bytes;
  p.tiles_x = (W + TILE_W - 1) / TILE_W; p.tiles_y = (H + rows - 1) / rows;
  p.tiles = B * p.tiles_x * p.tiles_y;
  if (p.tiles == 0) return (int)cudaSuccess;
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int nf = cout16 / 8;
  return launch_persistent(c1 > 0 ? pick_kernel<true>(design, rows, nf)
                                  : pick_kernel<false>(design, rows, nf),
                           p, p.tiles, rows * 32, smem, static_cast<cudaStream_t>(stream));
}

// Launch one float32 bounded DCN layer (integer radius R >= 0, Cin % 8 == 0,
// 1 <= Cout <= 128, `mask` null for weight 1; the weights packed [Cout16][9
// * Cin]) on the plan of `dcn_plan(..., itemsize=4)`: design 0 ("tile": 16
// or 8 rows, weights resident, `chans` slab channels a pass) or 1
// ("stream": 8 or 4 rows, `chans` channels a chunk), `chans` a multiple of
// 8. One input buffer of `x_bytes` with a pixel stride of `xu` 16-byte
// units, `smem` bytes of dynamic shared memory. Returns the cudaError_t of the launch;
// cudaErrorInvalidValue for arguments out of range, a plan whose regions
// overrun `smem`, or offsets off 8-byte alignment.
extern "C" int vfi_dcn_bounded_f32(const void* x, const void* offset, const void* mask,
                                   const void* w, const void* bias, void* out,
                                   int B, int H, int W, int Cin, int Cout, int R,
                                   int design, int rows, int chans, int xu,
                                   int x_bytes, int smem, int device, void* stream) {
  if (Cin < 8 || Cin % 8 != 0 || Cout < 1 || Cout > MAX_COUT || R < 0 || B < 0 || H < 0 ||
      W < 0 || smem < 0 || chans < 8 || chans % 8 != 0 || chans > Cin || x_bytes % 128 != 0 ||
      reinterpret_cast<uintptr_t>(offset) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int cout16 = pad16(Cout);
  if ((design != 0 && design != 1) ||
      (design == 0 && (rows != 8 || Cin > F32_FLUSH_K)) ||
      (design == 1 && rows != 8 && rows != 4) || chans > F32_FLUSH_K)
    return (int)cudaErrorInvalidValue;
  const long long tpx = (long long)(rows + 2 + 2 * R) * (TILE_W + 2 + 2 * R);
  const long long s_bytes = 4LL * rows * TILE_W * (chans + F_PAD);
  // The resident weights (tile) or one of two weight slices (stream).
  const long long w_bytes = 4LL * cout16 * (design == 0 ? NTAPS * Cin + F_PAD : chans + F_PAD);
  const int pieces = chans / 4;
  const int xu_tile = Cin / 4 + ((Cin / 4) % 2 == 0);
  if ((design == 0 ? xu != xu_tile : xu < pieces) || x_bytes < 16 * tpx * xu ||
      smem < (design == 0 ? 1 : 2) * w_bytes + x_bytes + s_bytes)
    return (int)cudaErrorInvalidValue;
  DcnF32Params p{};
  const long long px = Cin, row = (long long)W * Cin;
  if (!make_parts(p.x, H, W, x, (long long)H * row, row, px, Cin, nullptr, 0, 0, 0, 0))
    return (int)cudaErrorInvalidValue;
  p.offset = static_cast<const float*>(offset);
  p.mask = static_cast<const float*>(mask);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.B = B; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout; p.R = R; p.Cin16 = pad16(Cin);
  p.oc = Cout; p.xu = xu; p.chans = chans; p.nchunks = (Cin + chans - 1) / chans; p.nbuf = 1;
  p.w_bytes = (int)w_bytes; p.x_bytes = x_bytes;
  p.tiles_x = (W + TILE_W - 1) / TILE_W; p.tiles_y = (H + rows - 1) / rows;
  p.tiles = B * p.tiles_x * p.tiles_y;
  if (p.tiles == 0) return (int)cudaSuccess;
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  return launch_persistent(pick_kernel_f32(design, rows, cout16 / 8), p, p.tiles, rows * 32,
                           smem, static_cast<cudaStream_t>(stream));
}

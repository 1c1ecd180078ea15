// One stride-1 square odd-k convolution + bias (+ ReLU), bf16 NHWC, zeros
// padding k / 2, float32 accumulation, one rounding of the output; and its
// float32 instance (conv2d_f32_kernel, below: the same function on
// float32 tensors, 3xTF32 on the tensor cores).
//
// Replaces: vfi_tpu/ops/pallas/conv.py::_conv_kernel (conv2d_pallas, the
// "im2col" and "direct" variants) and ::_conv_kernel_v2 (conv2d_pallas_v2,
// the packed-lane layout), and through `conv_chain`'s one-layer route the
// one-layer instances of ::_chain_kernel (conv_chain_pallas at L = 1: the
// DCN blocks' offset convs). They compute one function; the TPU variants
// are VMEM layouts (an im2col buffer, one dot per tap, two pixels packed
// per 128-lane row) and none carries over.
//
// What bounds it on this card: a 720p 64->64 3x3 layer does 68 GFLOP
// against ~0.24 GB of input and output, near the ~295 FLOP/byte ridge
// (128->64 twice the work; narrow outputs such as the 27-channel offset
// conv and k = 1 lean to bytes). So the kernel must keep the tensor cores
// fed without moving more than the layer's own bytes: no weight traffic
// per output tile, no barrier per tap, few shared-memory loads per MMA.
//
// Design: an implicit GEMM on the tensor cores (mma.sync m16n8k16 bf16,
// float32 accumulators in registers), weight-stationary and persistent.
// - The grid is (SMs x resident blocks per SM); each block walks output
//   tiles of TH x TW = 16 x 16 pixels (all Cout) with a stride of the
//   grid.
// - The plan (`conv2d_plan` in ops/cuda/conv.py, passed in) keeps the
//   whole packed weight set [K*K*Cin16][Cout16] in shared memory, copied
//   once per block (every k = 3 layer of the model fits), or, where it
//   does not fit, streams groups of taps of one channel chunk, double-
//   buffered with the input.
// - A block's work is a sequence of steps (tile, channel chunk, tap group).
//   Step s + 1's input tile (rows and columns of the halo, zeros outside
//   the image, cp.async with zero fill) and, when streamed, its weight
//   group are copied into the other of two buffers while step s
//   multiplies: one barrier per step, so one per tile for the model's
//   layers.
// - 16 consecutive output pixels of a tile row read 16 consecutive tile
//   columns for every tap, so the A operand of each m16 fragment is the
//   tile itself at an offset (ldmatrix with one row address per pixel): no
//   im2col buffer. Rows of the tile and of the weights are padded by 8
//   channels (an odd multiple of 16 bytes), so ldmatrix's eight rows fall
//   in distinct banks.
// - 8 warps as 4 (pixels) x 2 (Cout): a warp owns four tile rows (64
//   pixels) and Cout16 / 2 channels (NF n8 fragments). Per k-step it loads
//   4 A fragments and NF B fragments (ldmatrix.trans) and issues 4 * NF
//   MMAs, each A reused across the warp's n-fragments and each B across
//   its four m-fragments; the next k-step's fragments load while this one
//   multiplies (two register sets). Of three tilings timed in turns on an
//   H100 (8 x 16 pixels with two m-fragments a warp, this one, and 16 x 16
//   over 16 warps of two), this was fastest at every 720p layer but 6->64.
// - Epilogue from registers: the bias (float32 of its bf16 value), the
//   ReLU, one rounding to bf16; a 4x4 transpose within each quad of lanes
//   (shuffles) gives each lane 8 consecutive channels, stored as 16 bytes
//   where Cout % 8 == 0.
// - The input is read where it lies: a channels-contiguous NHWC view with
//   any image, row and pixel strides that are multiples of 8 elements (0
//   too: a per-image vector broadcast over the pixels), in one part or in
//   two split along channels (common.cuh InputParts: part 0 a multiple of 8
//   channels). The tile loader takes each 16-byte unit's source from its
//   channel and loads the channels past a part's end, up to Cin16, as
//   zeros. So a caller hands over a concatenation's parts, or a view of a
//   wider buffer, without copying them into one tensor: the tile holds what
//   the zero-padded concatenation would hold, and the output is the same
//   bit for bit. The packed weights carry zero rows up to Cin16. An input
//   in one part runs the instances whose loader reads part 0 alone (TWO
//   false: a contiguous tensor's address arithmetic, no per-unit choice of
//   part or cache path); only two parts run the instances that choose.

#include "common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 16;            // output tile rows (ops/cuda/conv.py TILE_H)
constexpr int TW = 16;            // output tile columns (TILE_W): one m16 fragment
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int WM = 4;             // warps along the tile's rows
constexpr int WN = 2;             // warps along Cout
constexpr int MF = TH / WM;       // m16 fragments (tile rows) per warp
constexpr int PAD = 8;            // row padding of the tile and weights (bf16; ROW_PAD)
constexpr int MAX_COUT = 128;
constexpr int MAX_K = 9;

struct ConvParams {
  InputParts<bf16> x;   // (B, H, W, c0 + c1) in one or two parts, read in place
  const bf16* w;        // (K * K * Cin16, Cout16), row t * Cin16 + c, zero padded
  const float* bias;    // (Cout16,), zero padded
  bf16* out;            // (B, H, W, Cout)
  int B, H, W, Cin, Cout, K, Cin16, Cout16, act;   // Cin: c0 + c1 padded to 8
  int ck;               // tile channels per chunk (multiple of 16)
  int tg;               // taps per streamed weight group; 0: weights resident
  int x_bytes;          // one input-tile buffer; the weights follow both
  int tiles_x, tiles_y, tiles;
};

// NF: n8 fragments per warp, Cout16 = WN * NF * 8; TWO: the input in two
// parts (else part 0 alone: InputParts::load).
template <int NF, bool TWO>
__global__ void __launch_bounds__(NTHREADS, NF <= 4 ? 2 : 1)
conv2d_kernel(const ConvParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = p.K, taps = K * K, m = K / 2;
  const int tcols = TW + K - 1, tpx = (TH + K - 1) * tcols;
  const int ck = p.ck, xp = ck + PAD, Cin16 = p.Cin16, Cout16 = p.Cout16, wp = Cout16 + PAD;
  const int nchunks = (Cin16 + ck - 1) / ck;
  const bool resident = p.tg == 0;
  const int tg = resident ? taps : p.tg;
  const int ngroups = (taps + tg - 1) / tg;
  const int wslot = tg * ck * wp;                     // one streamed group, elements
  bf16* const xs = reinterpret_cast<bf16*>(smem);     // 2 x [tpx][xp]
  bf16* const ws = reinterpret_cast<bf16*>(smem + 2 * p.x_bytes);
  const int xslot_elems = p.x_bytes / 2;
  const uint32_t mag_tcols = fast_div_magic(tcols);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = wn * NF * 8;
  const int g8 = lane >> 2, q4 = lane & 3;
  // Lane offsets of the ldmatrix row addresses (elements): A rows are the
  // 16 pixels of an m16 fragment, 8 channels apart for the upper lanes; B
  // rows are 16 k-rows of the weights at the warp's columns.
  const int a_lane = (wm * MF * tcols + (lane & 15)) * xp + (lane >> 4) * 8;
  const int b_lane = (lane & 15) * wp + n0 + (lane >> 4) * 8;

  auto tile_origin = [&](int tile, int& b, int& ty, int& tx) {
    const int per_img = p.tiles_x * p.tiles_y;
    b = tile / per_img;
    const int r = tile - b * per_img;
    ty = r / p.tiles_x;
    tx = r - ty * p.tiles_x;
  };
  auto chunk_width = [&](int c) { return min(ck, Cin16 - c * ck); };

  // Chunk c of tile `tile`'s input with its halo into buffer `slot`.
  auto stage_x = [&](int tile, int c, int slot) {
    int b, ty, tx;
    tile_origin(tile, b, ty, tx);
    const int y0 = ty * TH - m, x0 = tx * TW - m;
    const int pieces = chunk_width(c) / 8;
    const uint32_t mag_p = fast_div_magic(pieces);
    bf16* dst0 = xs + slot * xslot_elems;
    const auto img = p.x.image(b);
    for (int it = threadIdx.x; it < tpx * pieces; it += NTHREADS) {
      const int pix = fast_div(it, mag_p);
      const int pc = it - pix * pieces;
      const int row = fast_div(pix, mag_tcols), col = pix - row * tcols;
      const int gy = y0 + row, gx = x0 + col;
      p.x.template load<TWO>(dst0 + pix * xp + pc * 8, img, gy, gx, c * ck + pc * 8,
                             gy >= 0 && gy < p.H && gx >= 0 && gx < p.W);
    }
  };
  // Streamed weights: taps g*tg .. of chunk c, as [tap][ck][wp] in `slot`.
  auto stage_w = [&](int c, int g, int slot) {
    const int t0 = g * tg, tn = min(tg, taps - t0), ckw = chunk_width(c);
    const int pieces = Cout16 / 8;
    bf16* dst0 = ws + slot * wslot;
    for (int it = threadIdx.x; it < tn * ckw * pieces; it += NTHREADS) {
      const int row = it / pieces, pc = it - row * pieces;
      const int tr = row / ckw, kk = row - tr * ckw;
      cp_async16(dst0 + (tr * ck + kk) * wp + pc * 8,
                 p.w + ((size_t)(t0 + tr) * Cin16 + c * ck + kk) * Cout16 + pc * 8);
    }
  };

  int tile = blockIdx.x, c = 0, g = 0, xslot = 0, wbuf = 0;
  if (tile >= p.tiles) return;
  if (resident) {  // the whole weight set, once per block
    const int pieces = Cout16 / 8;
    for (int it = threadIdx.x; it < taps * Cin16 * pieces; it += NTHREADS) {
      const int row = it / pieces, pc = it - row * pieces;
      cp_async16(ws + row * wp + pc * 8, p.w + (size_t)row * Cout16 + pc * 8);
    }
  } else {
    stage_w(0, 0, 0);
  }
  stage_x(tile, 0, 0);
  cp_async_commit();

  float2 bias[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j)
    bias[j] = *reinterpret_cast<const float2*>(p.bias + n0 + j * 8 + q4 * 2);

  float acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  while (true) {
    cp_async_wait<0>();
    __syncthreads();  // this step's buffers are in; the last step's are free
    int nt = tile, nc = c, ng = g + 1;
    if (ng == ngroups) {
      ng = 0;
      if (++nc == nchunks) { nc = 0; nt += gridDim.x; }
    }
    const bool more = nt < p.tiles;
    if (more) {
      if (ng == 0) stage_x(nt, nc, xslot ^ 1);
      if (!resident) stage_w(nc, ng, wbuf ^ 1);
      cp_async_commit();
    }

    // This step: taps t0 .. t1 - 1 of chunk c, kst k-steps of 16 channels
    // per tap, as one flat loop of nq k-steps.
    const int t0 = g * tg, t1 = min(taps, t0 + tg), kst = chunk_width(c) / 16;
    const int nq = (t1 - t0) * kst;
    const int wt_stride = resident ? Cin16 : ck;     // weight rows per tap
    const bf16* wsrc = resident ? ws + c * ck * wp : ws + wbuf * wslot;
    const uint32_t a_base = smem_u32(xs + xslot * xslot_elems + a_lane);
    const uint32_t b_base = smem_u32(wsrc + b_lane);
    int lt = 0, lk = 0, lti = t0 / K, ltj = t0 - (t0 / K) * K;

    uint32_t fa0[MF][4], fb0[NF][2], fa1[MF][4], fb1[NF][2];
    auto load = [&](uint32_t (&fa)[MF][4], uint32_t (&fb)[NF][2]) {
      const uint32_t ao = a_base + ((lti * tcols + ltj) * xp + lk * 16) * 2;
#pragma unroll
      for (int i = 0; i < MF; ++i) ldsm_x4(fa[i], ao + i * tcols * xp * 2);
      const uint32_t bo = b_base + (lt * wt_stride + lk * 16) * wp * 2;
#pragma unroll
      for (int j = 0; j + 1 < NF; j += 2) ldsm_x4_t(fb[j], fb[j + 1], bo + j * 16);
      if (NF & 1) ldsm_x2_t(fb[NF - 1], bo + (NF - 1) * 16);
      if (++lk == kst) {
        lk = 0;
        ++lt;
        if (++ltj == K) { ltj = 0; ++lti; }
      }
    };
    auto mma_all = [&](const uint32_t (&fa)[MF][4], const uint32_t (&fb)[NF][2]) {
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_bf16(acc[i][j], fa[i], fb[j]);
    };
    load(fa0, fb0);
    for (int q = 0; q < nq; q += 2) {
      if (q + 1 < nq) load(fa1, fb1);
      mma_all(fa0, fb0);
      if (q + 1 < nq) {
        if (q + 2 < nq) load(fa0, fb0);
        mma_all(fa1, fb1);
      }
    }

    if (g == ngroups - 1 && c == nchunks - 1) {
      // Epilogue of this tile: bias, ReLU, one rounding, bf16 out.
      int b, ty, tx;
      tile_origin(tile, b, ty, tx);
      const bool vec = (p.Cout % 8) == 0;
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        const int gy = ty * TH + wm * MF + i;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gx = tx * TW + g8 + 8 * h;
          const bool inimg = gy < p.H && gx < p.W;
          bf16* orow = p.out + (((size_t)b * p.H + gy) * p.W + gx) * p.Cout;
#pragma unroll
          for (int j0 = 0; j0 < NF; j0 += 4) {
            uint32_t u[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int j = j0 + jj < NF ? j0 + jj : NF - 1;
              float v0 = acc[i][j][2 * h] + bias[j].x, v1 = acc[i][j][2 * h + 1] + bias[j].y;
              if (p.act) { v0 = fmaxf(v0, 0.0f); v1 = fmaxf(v1, 0.0f); }
              u[jj] = pack_bf16x2(v0, v1);
            }
            quad_transpose(u, q4);
            const int ch0 = n0 + (j0 + q4) * 8;
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
      }
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    }
    if (!more) break;
    if (ng == 0) xslot ^= 1;
    if (!resident) wbuf ^= 1;
    tile = nt;
    c = nc;
    g = ng;
  }
}

// ---------------------------------------------------------------------------
// The float32 instance (`vfi_conv2d_f32`): the same function on float32
// inputs, weights, bias and output, float32-accurate products (3xTF32 on
// the tensor cores, common.cuh: one TF32 pass would keep only 11 bits of
// each operand) summed in float32.
//
// What bounds it on this card: a 720p 64->64 3x3 layer does 68 GFLOP, three
// TF32 passes of it 204 GFLOP: 0.41 ms at the 495 TFLOP/s TF32 peak,
// against 0.47 GB of input and output (0.14 ms). So, as in bf16, the
// tensor cores must be kept fed; on top, each operand fragment splits into
// hi and lo in registers (three ALU instructions a register), which
// competes with the MMAs for issue slots.
//
// Design (conv2d_f32_kernel): the bf16 kernel's, with 32-bit operands.
// - Persistent blocks over output tiles of FTH x 16 pixels (FTH = 4 * MF:
//   16 up to Cout16 = 64, else 8; half that where the plan flushes, below),
//   all Cout; 8 warps as 4 (pixels) x 2 (Cout): a warp owns MF tile rows
//   (m16 fragments) and NF n8 fragments.
// - The input tile of a channel chunk (ck channels, a multiple of 8) is
//   stored pixel-major, [tpx][ck + 4] floats: K (channels) contiguous, rows
//   an odd multiple of 16 bytes. An m16n8k8 A fragment is 16 consecutive
//   tile pixels x 8 channels at a tap's offset, loaded by ldmatrix .b16
//   without .trans (each 4-byte element moves whole: an 8 x 4 matrix of
//   floats per 8 x 8 of halves): no im2col.
// - The weights are packed [Cout16][k * k * Cin] (Cin a multiple of 8, K
//   contiguous: column t * Cin + c), which is the B operand's "col" layout:
//   ldmatrix without .trans again. They stay resident ([Cout16][k k Cin +
//   4] floats) where they fit beside two input buffers, else stream in
//   groups of `tg` taps of one chunk ([Cout16][tg * ck + 4]), double-
//   buffered with the input: the plan (`conv2d_plan(..., itemsize=4)`).
// - One barrier a step (tile, chunk, tap group); a k-step's fragments load
//   while the last one multiplies (two register sets). Per k-step a warp
//   splits its MF A fragments (each then reused NF times) and NF B
//   fragments (each reused MF times) and issues 3 * MF * NF MMAs in three
//   passes over the accumulators (all lo_a hi_b, all hi_a lo_b, all hi_a
//   hi_b): an MMA that writes the accumulator of the one before it waits
//   out that one's latency, and three chained MMAs a pair ran the 720p
//   64->64 layer 1.37x slower on an H100 (tools/conv_turns.py, in turns).
//   Splitting each input chunk once into hi / lo planes in shared memory (a
//   third buffer, a second barrier a chunk) instead of in registers
//   measured no faster, and splitting the weights at pack time (hi and lo
//   columns side by side: twice the weights' bytes, which no longer stay
//   resident at 64->64) slower: 720p 1.292 against 1.067 device ms,
//   128->64 2.446 against 2.230, in turns. The split stays in registers.
// - Epilogue from registers: the bias, the ReLU, float32 stores of two
//   channels a lane (a quad writes 32 contiguous bytes a pixel).
// - The MMAs accumulate in float32 but truncate each sum (the tensor cores'
//   adder), a bias that grows with the k-steps a sum runs over. Past
//   `F32_FLUSH_K` columns of K (ops/cuda/conv.py) the plan flushes: each
//   step's sums (a step then spans at most F32_FLUSH_K columns) go into the
//   tile's by a float32 add, rounded to nearest, on half-height tiles (the
//   tile's sums take the registers). Flushing at every plan on full-height
//   tiles cost 4-6% on an H100 (720p 64->64 1.132 against 1.067 device ms,
//   128->64 2.324 against 2.230; tools/conv_turns.py, in turns), so only
//   the plans past F32_FLUSH_K take the flushing instances.
// Cin must be a multiple of 8 (the wrapper pads with zero channels).

constexpr int F_PAD = 4;          // row padding of the f32 tile and weights, floats

struct ConvF32Params {
  const float* x;       // (B, H, W, Cin)
  const float* w;       // (Cout16, K * K * Cin), column t * Cin + c, zero padded rows
  const float* bias;    // (Cout16,), zero padded
  float* out;           // (B, H, W, Cout)
  int B, H, W, Cin, Cout, K, Cout16, act;
  int ck;               // tile channels per chunk (multiple of 8)
  int tg;               // taps per streamed weight group; 0: weights resident
  int x_bytes;          // one input-tile buffer; the weights follow both
  int wp;               // a weight row in shared memory, floats
  int tiles_x, tiles_y, tiles;
};

// A tile's float32 sums beside the MMAs' accumulators, where a kernel
// flushes them (ON); nothing otherwise.
template <int MF, int NF, bool ON>
struct TileSums {
  float v[MF][NF][4];
};
template <int MF, int NF>
struct TileSums<MF, NF, false> {};

template <int NF, int MF, bool FLUSH>  // Cout16 = WN * NF * 8; tile rows 4 * MF
__global__ void __launch_bounds__(NTHREADS, 1)
conv2d_f32_kernel(const ConvF32Params p) {
  constexpr int FTH = WM * MF;
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = p.K, taps = K * K, m = K / 2;
  const int tcols = TW + K - 1, tpx = (FTH + K - 1) * tcols;
  const int ck = p.ck, xp = ck + F_PAD, Cin = p.Cin, Cout16 = p.Cout16, wp = p.wp;
  const int nchunks = (Cin + ck - 1) / ck;
  const bool resident = p.tg == 0;
  const int tg = resident ? taps : p.tg;
  const int ngroups = (taps + tg - 1) / tg;
  const int wslot = Cout16 * wp;                        // one streamed group, floats
  float* const xs = reinterpret_cast<float*>(smem);    // 2 x [tpx][xp]
  float* const ws = reinterpret_cast<float*>(smem + 2 * p.x_bytes);
  const int xslot_floats = p.x_bytes / 4;
  const uint32_t mag_tcols = fast_div_magic(tcols);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = wn * NF * 8;
  const int g8 = lane >> 2, q4 = lane & 3;
  // ldmatrix row addresses (floats): A rows are the 16 pixels of an m16
  // fragment, channels 4 on for the upper lanes; B rows are output channels
  // (8 a matrix), K 4 on for lanes 8-15 and 24-31.
  const int a_lane = (wm * MF * tcols + (lane & 15)) * xp + (lane >> 4) * 4;
  const int b_lane = (n0 + (lane & 7) + ((lane >> 4) << 3)) * wp + ((lane >> 3) & 1) * 4;

  auto tile_origin = [&](int tile, int& b, int& ty, int& tx) {
    const int per_img = p.tiles_x * p.tiles_y;
    b = tile / per_img;
    const int r = tile - b * per_img;
    ty = r / p.tiles_x;
    tx = r - ty * p.tiles_x;
  };
  auto chunk_width = [&](int c) { return min(ck, Cin - c * ck); };

  // Chunk c of tile `tile`'s input with its halo into buffer `slot`.
  auto stage_x = [&](int tile, int c, int slot) {
    int b, ty, tx;
    tile_origin(tile, b, ty, tx);
    const int y0 = ty * FTH - m, x0 = tx * TW - m;
    const int pieces = chunk_width(c) / 4;
    const uint32_t mag_p = fast_div_magic(pieces);
    const float* xb = p.x + (size_t)b * p.H * p.W * Cin;
    float* dst0 = xs + slot * xslot_floats;
    for (int it = threadIdx.x; it < tpx * pieces; it += NTHREADS) {
      const int pix = fast_div(it, mag_p);
      const int pc = it - pix * pieces;
      const int row = fast_div(pix, mag_tcols), col = pix - row * tcols;
      const int gy = y0 + row, gx = x0 + col;
      const bool ok = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      cp_async16_zfill(dst0 + pix * xp + pc * 4,
                       ok ? xb + ((size_t)gy * p.W + gx) * Cin + c * ck + pc * 4 : p.x, ok);
    }
  };
  // Streamed weights: taps g*tg .. of chunk c, as [Cout16][tap][ck] in `slot`.
  auto stage_w = [&](int c, int g, int slot) {
    const int t0 = g * tg, tn = min(tg, taps - t0), pieces = chunk_width(c) / 4;
    const int per_row = tn * pieces;
    float* dst0 = ws + slot * wslot;
    for (int it = threadIdx.x; it < Cout16 * per_row; it += NTHREADS) {
      const int o = it / per_row, r = it - o * per_row;
      const int tr = r / pieces, pc = r - tr * pieces;
      cp_async16(dst0 + o * wp + tr * ck + pc * 4,
                 p.w + ((size_t)o * taps + t0 + tr) * Cin + c * ck + pc * 4);
    }
  };

  int tile = blockIdx.x, c = 0, g = 0, xslot = 0, wbuf = 0;
  if (tile >= p.tiles) return;
  if (resident) {  // the whole weight set, once per block
    const int pieces = taps * Cin / 4;
    for (int it = threadIdx.x; it < Cout16 * pieces; it += NTHREADS) {
      const int o = it / pieces, pc = it - o * pieces;
      cp_async16(ws + o * wp + pc * 4, p.w + (size_t)o * taps * Cin + pc * 4);
    }
  } else {
    stage_w(0, 0, 0);
  }
  stage_x(tile, 0, 0);
  cp_async_commit();

  float2 bias[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j)
    bias[j] = *reinterpret_cast<const float2*>(p.bias + n0 + j * 8 + q4 * 2);

  // acc: the MMAs' accumulators. Where FLUSH, they hold one step's sums,
  // added into the tile's (tot) by float32 adds (round to nearest) after
  // each step: the tensor cores' own float32 accumulation truncates, which
  // over the thousands of k-steps of a wide, large-k layer drifts past
  // 2^-14 of the output.
  float acc[MF][NF][4];
  TileSums<MF, NF, FLUSH> tot;
  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][j][e] = 0.0f;
          if constexpr (FLUSH) tot.v[i][j][e] = 0.0f;
        }
  };
  zero();

  while (true) {
    cp_async_wait<0>();
    __syncthreads();  // this step's buffers are in; the last step's are free
    int nt = tile, nc = c, ng = g + 1;
    if (ng == ngroups) {
      ng = 0;
      if (++nc == nchunks) { nc = 0; nt += gridDim.x; }
    }
    const bool more = nt < p.tiles;
    if (more) {
      if (ng == 0) stage_x(nt, nc, xslot ^ 1);
      if (!resident) stage_w(nc, ng, wbuf ^ 1);
      cp_async_commit();
    }

    // This step: taps t0 .. t1 - 1 of chunk c, kst k-steps of 8 channels
    // per tap, as one flat loop of nq k-steps.
    const int t0 = g * tg, t1 = min(taps, t0 + tg), kst = chunk_width(c) / 8;
    const int nq = (t1 - t0) * kst;
    const int wt_stride = resident ? Cin : ck;       // weight columns per tap
    const int wcol0 = resident ? c * ck : 0;
    const float* wsrc = resident ? ws : ws + wbuf * wslot;
    const uint32_t a_base = smem_u32(xs + xslot * xslot_floats + a_lane);
    const uint32_t b_base = smem_u32(wsrc + b_lane + wcol0);
    int lt = resident ? t0 : 0, lk = 0, lti = t0 / K, ltj = t0 - (t0 / K) * K;

    uint32_t fa0[MF][4], fb0[NF][2], fa1[MF][4], fb1[NF][2];
    auto load = [&](uint32_t (&fa)[MF][4], uint32_t (&fb)[NF][2]) {
      const uint32_t ao = a_base + ((lti * tcols + ltj) * xp + lk * 8) * 4;
#pragma unroll
      for (int i = 0; i < MF; ++i) ldsm_x4(fa[i], ao + i * tcols * xp * 4);
      const uint32_t bo = b_base + (lt * wt_stride + lk * 8) * 4;
#pragma unroll
      for (int j = 0; j + 1 < NF; j += 2) ldsm_x4_b(fb[j], fb[j + 1], bo + j * 8 * wp * 4);
      if (NF & 1) ldsm_x2(fb[NF - 1], bo + (NF - 1) * 8 * wp * 4);
      if (++lk == kst) {
        lk = 0;
        ++lt;
        if (++ltj == K) { ltj = 0; ++lti; }
      }
    };
    // Three passes over the MF x NF accumulators (lo_a hi_b, hi_a lo_b,
    // hi_a hi_b): consecutive MMAs write different accumulators.
    auto mma_all = [&](const uint32_t (&fa)[MF][4], const uint32_t (&fb)[NF][2]) {
      uint32_t ah[MF][4], al[MF][4], bh[NF][2], bl[NF][2];
#pragma unroll
      for (int i = 0; i < MF; ++i) split_tf32(fa[i], ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < NF; ++j) split_tf32(fb[j], bh[j], bl[j]);
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
    };
    load(fa0, fb0);
    for (int q = 0; q < nq; q += 2) {
      if (q + 1 < nq) load(fa1, fb1);
      mma_all(fa0, fb0);
      if (q + 1 < nq) {
        if (q + 2 < nq) load(fa0, fb0);
        mma_all(fa1, fb1);
      }
    }
    if constexpr (FLUSH) {
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot.v[i][j][e] = __fadd_rn(tot.v[i][j][e], acc[i][j][e]);
            acc[i][j][e] = 0.0f;
          }
    }

    if (g == ngroups - 1 && c == nchunks - 1) {
      // Epilogue of this tile: bias, ReLU, float32 out.
      int b, ty, tx;
      tile_origin(tile, b, ty, tx);
      const bool vec = (p.Cout % 2) == 0;
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        const int gy = ty * FTH + wm * MF + i;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gx = tx * TW + g8 + 8 * h;
          const bool inimg = gy < p.H && gx < p.W;
          float* orow = p.out + (((size_t)b * p.H + gy) * p.W + gx) * p.Cout;
#pragma unroll
          for (int j = 0; j < NF; ++j) {
            float s0 = acc[i][j][2 * h], s1 = acc[i][j][2 * h + 1];
            if constexpr (FLUSH) { s0 = tot.v[i][j][2 * h]; s1 = tot.v[i][j][2 * h + 1]; }
            float v0 = s0 + bias[j].x, v1 = s1 + bias[j].y;
            if (p.act) { v0 = fmaxf(v0, 0.0f); v1 = fmaxf(v1, 0.0f); }
            const int ch = n0 + j * 8 + q4 * 2;
            if (inimg && ch < p.Cout) {
              if (vec) {
                *reinterpret_cast<float2*>(orow + ch) = make_float2(v0, v1);
              } else {
                orow[ch] = v0;
                if (ch + 1 < p.Cout) orow[ch + 1] = v1;
              }
            }
          }
        }
      }
      zero();
    }
    if (!more) break;
    if (ng == 0) xslot ^= 1;
    if (!resident) wbuf ^= 1;
    tile = nt;
    c = nc;
    g = ng;
  }
}

// The float32 instance for Cout16 = 16 * nf.
// Its m16 fragments (tile rows) a warp: 4 up to Cout16 = 64, else 2; half
// that where it flushes, whose sums take the registers. A tile is WM warps'
// rows of them.
__host__ __device__ constexpr int f32_mf(int nf, bool flush) {
  return (nf <= 4 ? 4 : 2) / (flush ? 2 : 1);
}
template <bool TWO>
int launch_bf16(int nf, const ConvParams& p, int smem, cudaStream_t s) {
  auto go = [&](auto kernel) { return launch_persistent(kernel, p, p.tiles, NTHREADS, smem, s); };
  switch (nf) {
    case 1: return go(conv2d_kernel<1, TWO>);
    case 2: return go(conv2d_kernel<2, TWO>);
    case 3: return go(conv2d_kernel<3, TWO>);
    case 4: return go(conv2d_kernel<4, TWO>);
    case 5: return go(conv2d_kernel<5, TWO>);
    case 6: return go(conv2d_kernel<6, TWO>);
    case 7: return go(conv2d_kernel<7, TWO>);
    default: return go(conv2d_kernel<8, TWO>);
  }
}

template <bool FLUSH>
int launch_f32(int nf, const ConvF32Params& p, int smem, cudaStream_t s) {
  auto go = [&](auto kernel) { return launch_persistent(kernel, p, p.tiles, NTHREADS, smem, s); };
  switch (nf) {
    case 1: return go(conv2d_f32_kernel<1, f32_mf(1, FLUSH), FLUSH>);
    case 2: return go(conv2d_f32_kernel<2, f32_mf(2, FLUSH), FLUSH>);
    case 3: return go(conv2d_f32_kernel<3, f32_mf(3, FLUSH), FLUSH>);
    case 4: return go(conv2d_f32_kernel<4, f32_mf(4, FLUSH), FLUSH>);
    case 5: return go(conv2d_f32_kernel<5, f32_mf(5, FLUSH), FLUSH>);
    case 6: return go(conv2d_f32_kernel<6, f32_mf(6, FLUSH), FLUSH>);
    case 7: return go(conv2d_f32_kernel<7, f32_mf(7, FLUSH), FLUSH>);
    default: return go(conv2d_f32_kernel<8, f32_mf(8, FLUSH), FLUSH>);
  }
}

}  // namespace

// Launch one conv (odd K <= 9, 1 <= Cout <= 128; act != 0 fuses the ReLU)
// of the input in parts (x0, its image, row and pixel strides in elements,
// c0 channels; x1 likewise, c1 = 0 for none: common.cuh InputParts) on the
// plan of `conv2d_plan` (ops/cuda/conv.py) for Cin = c0 + c1 padded to 8: ck
// channels per input chunk, tg taps per streamed weight group (0: the
// whole weight set resident), x_bytes per input-tile buffer, smem bytes in
// all. Returns the cudaError_t of the launch (cudaErrorInvalidValue for a
// shape, layout or plan outside the contract); the kernel runs on `stream`.
extern "C" int vfi_conv2d_bf16(const void* x0, long long sb0, long long sy0, long long sx0,
                               int c0, const void* x1, long long sb1, long long sy1,
                               long long sx1, int c1, const void* w, const void* bias,
                               void* out, int B, int H, int W, int Cout, int K, int act,
                               int ck, int tg, int x_bytes, int smem,
                               int device, void* stream) {
  ConvParams p{};
  if (!make_parts(p.x, H, W, x0, sb0, sy0, sx0, c0, x1, sb1, sy1, sx1, c1))
    return (int)cudaErrorInvalidValue;
  const int Cin = (c0 + c1 + 7) / 8 * 8;
  if (Cout < 1 || Cout > MAX_COUT || K < 1 || K % 2 == 0 || K > MAX_K || B < 0 || H < 0 ||
      W < 0)
    return (int)cudaErrorInvalidValue;
  const int cin16 = pad16(Cin), cout16 = pad16(Cout), wp = cout16 + PAD;
  const int tpx = (TH + K - 1) * (TW + K - 1);
  const long long wbytes = tg == 0 ? 2LL * K * K * cin16 * wp : 2LL * 2 * tg * ck * wp;
  if (ck < 16 || ck % 16 != 0 || ck > cin16 || tg < 0 || tg > K * K || x_bytes % 128 != 0 ||
      x_bytes < tpx * (ck + PAD) * 2 || smem < 2LL * x_bytes + wbytes)
    return (int)cudaErrorInvalidValue;
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<bf16*>(out);
  p.B = B; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout; p.K = K;
  p.Cin16 = cin16; p.Cout16 = cout16; p.act = act ? 1 : 0;
  p.ck = ck; p.tg = tg; p.x_bytes = x_bytes;
  p.tiles_x = (W + TW - 1) / TW;
  p.tiles_y = (H + TH - 1) / TH;
  p.tiles = B * p.tiles_x * p.tiles_y;
  if (p.tiles == 0) return (int)cudaSuccess;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c1 > 0) return launch_bf16<true>(cout16 / 16, p, smem, s);
  return launch_bf16<false>(cout16 / 16, p, smem, s);
}

// Launch one float32 conv (Cin % 8 == 0, odd K <= 9, 1 <= Cout <= 128;
// act != 0 fuses the ReLU) on the plan of `conv2d_plan(..., itemsize=4)`:
// ck channels per input chunk (a multiple of 8), tg taps per streamed
// weight group (0: the whole weight set resident), x_bytes per input-tile
// buffer, flush != 0 to add each step's sums into the tile's in float32
// (rounding to nearest) instead of accumulating the whole K in the MMAs,
// smem bytes in all; the weights packed [Cout16][K * K * Cin].
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a shape
// or plan outside the contract); the kernel runs on `stream`.
extern "C" int vfi_conv2d_f32(const void* x, const void* w, const void* bias, void* out,
                              int B, int H, int W, int Cin, int Cout, int K, int act,
                              int ck, int tg, int x_bytes, int flush, int smem,
                              int device, void* stream) {
  if (Cin < 8 || Cin % 8 != 0 || Cout < 1 || Cout > MAX_COUT || K < 1 || K % 2 == 0 ||
      K > MAX_K || B < 0 || H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  const int cout16 = pad16(Cout), rows = WM * f32_mf(cout16 / 16, flush != 0);
  const int tpx = (rows + K - 1) * (TW + K - 1);
  const int wp = (tg == 0 ? K * K * Cin : tg * ck) + F_PAD;
  const long long wbytes = (tg == 0 ? 1LL : 2LL) * 4 * cout16 * wp;
  if (ck < 8 || ck % 8 != 0 || ck > Cin || tg < 0 || tg > K * K || x_bytes % 128 != 0 ||
      x_bytes < 4LL * tpx * (ck + F_PAD) || smem < 2LL * x_bytes + wbytes)
    return (int)cudaErrorInvalidValue;
  ConvF32Params p{};
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.B = B; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout; p.K = K;
  p.Cout16 = cout16; p.act = act ? 1 : 0;
  p.ck = ck; p.tg = tg; p.x_bytes = x_bytes; p.wp = wp;
  p.tiles_x = (W + TW - 1) / TW;
  p.tiles_y = (H + rows - 1) / rows;
  p.tiles = B * p.tiles_x * p.tiles_y;
  if (p.tiles == 0) return (int)cudaSuccess;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (flush) return launch_f32<true>(cout16 / 16, p, smem, s);
  return launch_f32<false>(cout16 / 16, p, smem, s);
}

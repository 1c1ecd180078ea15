// One stride-1 square odd-k convolution + bias (+ ReLU), bf16 NHWC, zeros
// padding k / 2, float32 accumulation, one rounding of the output; and its
// float32 instance (conv2d_f32_kernel, below: the same function on
// float32 tensors, FFMA on the CUDA cores).
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
// Cin must be a multiple of 8 (16-byte copies); the wrapper pads another
// input with zero channels, and the packed weights carry zero rows up to
// Cin16.

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
  const bf16* x;        // (B, H, W, Cin)
  const bf16* w;        // (K * K * Cin16, Cout16), row t * Cin16 + c, zero padded
  const float* bias;    // (Cout16,), zero padded
  bf16* out;            // (B, H, W, Cout)
  int B, H, W, Cin, Cout, K, Cin16, Cout16, act;
  int ck;               // tile channels per chunk (multiple of 16)
  int tg;               // taps per streamed weight group; 0: weights resident
  int x_bytes;          // one input-tile buffer; the weights follow both
  int tiles_x, tiles_y, tiles;
};

template <int NF>  // n8 fragments per warp: Cout16 = WN * NF * 8
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
    const bf16* xb = p.x + (size_t)b * p.H * p.W * p.Cin;
    bf16* dst0 = xs + slot * xslot_elems;
    for (int it = threadIdx.x; it < tpx * pieces; it += NTHREADS) {
      const int pix = fast_div(it, mag_p);
      const int pc = it - pix * pieces;
      const int row = fast_div(pix, mag_tcols), col = pix - row * tcols;
      const int gy = y0 + row, gx = x0 + col, ch = c * ck + pc * 8;
      const bool ok = ch < p.Cin && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      cp_async16_zfill(dst0 + pix * xp + pc * 8,
                       ok ? xb + ((size_t)gy * p.W + gx) * p.Cin + ch : p.x, ok);
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
// inputs, weights, bias and output, with IEEE float32 products and sums
// (FFMA on the CUDA cores: a single TF32 tensor-core pass would keep only
// 10 bits of each operand).
//
// What bounds it on this card: a 720p 64->64 3x3 layer does 68 GFLOP,
// 1.01 ms at the 67 TFLOP/s float32 peak, against 0.47 GB of input and
// output (0.14 ms): the FFMA rate. So the design keeps the FFMA units fed
// from registers and makes few shared-memory loads per FFMA.
//
// Design (conv2d_f32_kernel): one block an output tile of 16 x 16 pixels
// and all Cout16 channels; warp w owns output channels 8w .. 8w + 7 (so
// Cout16 / 8 warps), lane l the 8 consecutive pixels of tile row l & 15
// starting at column 8 (l >> 4): 64 float32 accumulators a lane.
// - The input streams in chunks of `ck` channels (`conv2d_plan`), stored
//   channel-major, [ck][16 + K - 1][FS] floats with FS = 20 or 28 (a
//   multiple of 4 whose quarter, 5 or 7, is odd, so that the 16-byte row
//   reads of the 8 lanes of a quarter-warp fall in distinct banks), copied
//   element by element (cp.async, zeros outside the image), beside the
//   chunk's weights [K * K][ck][Cout16]. Two stages: chunk c + 1's copies
//   are in flight while chunk c multiplies; one barrier a chunk.
// - Per (channel, tap row) a lane loads its row's 8 + K - 1 inputs as
//   float4s into registers; per tap column the warp loads its 8 weights
//   (two float4s, the same address for every lane: a broadcast) and each
//   lane does 64 FFMAs. For K = 3 that is 9 shared loads per 192 FFMAs.
// - Epilogue from registers: the bias, the ReLU, float32 stores (16-byte
//   where Cout % 4 == 0).
// Summation order: over chunks, channels, tap rows, tap columns; the plain
// version's cuDNN conv sums in its own order, so the two differ by float32
// rounding only.

constexpr int F_TH = 16;          // the f32 output tile: 16 x 16 pixels
constexpr int F_TW = 16;
constexpr int F_PX = 8;           // pixels a lane, along its tile row
constexpr int F_MAX_THREADS = 4 * MAX_COUT;   // Cout16 / 8 warps of 32

// The input stage's row pitch in floats for a K x K conv.
__host__ __device__ constexpr int f32_pitch(int K) { return K <= 5 ? 20 : 28; }

struct ConvF32Params {
  const float* x;       // (B, H, W, Cin)
  const float* w;       // (K * K * Cin16, Cout16), row t * Cin16 + c, zero padded
  const float* bias;    // (Cout16,), zero padded
  float* out;           // (B, H, W, Cout)
  int B, H, W, Cin, Cout, K, Cin16, Cout16, act;
  int ck, nchunks;      // channels a chunk, chunks
  int x_floats, w_floats;   // one stage's input tile and weights
  int tiles_x, tiles_y;
};

template <int K>
__global__ void __launch_bounds__(F_MAX_THREADS)
conv2d_f32_kernel(const ConvF32Params p) {
  constexpr int FS = f32_pitch(K);
  constexpr int TR = F_TH + K - 1, TC = F_TW + K - 1;   // the tile with its halo
  constexpr int NV = (F_PX + K - 1 + 3) / 4;            // float4s of a lane's input row
  extern __shared__ __align__(128) float fsm[];
  const int nt = blockDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane & 15, c0 = (lane >> 4) * F_PX, n0 = warp * 8;
  const int per_img = p.tiles_x * p.tiles_y;
  const int b = blockIdx.x / per_img, rem = blockIdx.x - b * per_img;
  const int ty = rem / p.tiles_x, tx = rem - ty * p.tiles_x;
  const int y0 = ty * F_TH - K / 2, x0 = tx * F_TW - K / 2;
  const float* xb = p.x + (size_t)b * p.H * p.W * p.Cin;
  const int stage_floats = p.x_floats + p.w_floats;

  // Chunk c's input tile and weights into stage s.
  auto stage = [&](int c, int s) {
    float* xs = fsm + s * stage_floats;
    float* ws = xs + p.x_floats;
    const int ch0 = c * p.ck, cw = min(p.ck, p.Cin - ch0);
    for (int it = threadIdx.x; it < cw * TR * TC; it += nt) {
      const int pix = it / cw, ch = it - pix * cw;   // neighbouring threads: one pixel's channels
      const int row = pix / TC, col = pix - row * TC;
      const int gy = y0 + row, gx = x0 + col;
      const bool ok = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      cp_async4_zfill(xs + (ch * TR + row) * FS + col,
                      ok ? xb + ((size_t)gy * p.W + gx) * p.Cin + ch0 + ch : p.x, ok);
    }
    const int pieces = p.Cout16 / 4;
    for (int it = threadIdx.x; it < K * K * cw * pieces; it += nt) {
      const int row = it / pieces, pc = it - row * pieces;
      const int t = row / cw, kk = row - t * cw;
      cp_async16(ws + (t * p.ck + kk) * p.Cout16 + pc * 4,
                 p.w + ((size_t)t * p.Cin16 + ch0 + kk) * p.Cout16 + pc * 4);
    }
  };

  float acc[F_PX][8];
#pragma unroll
  for (int i = 0; i < F_PX; ++i)
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[i][o] = 0.0f;

  stage(0, 0);
  cp_async_commit();
  for (int c = 0; c < p.nchunks; ++c) {
    if (c + 1 < p.nchunks) stage(c + 1, (c + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk c is in
    const float* xs = fsm + (c & 1) * stage_floats;
    const float* ws = xs + p.x_floats;
    const int cw = min(p.ck, p.Cin - c * p.ck);
    for (int ch = 0; ch < cw; ++ch) {
#pragma unroll 1
      for (int i = 0; i < K; ++i) {
        float xr[NV * 4];
        const float4* src = reinterpret_cast<const float4*>(xs + (ch * TR + r + i) * FS + c0);
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float4 q = src[v];
          xr[4 * v] = q.x; xr[4 * v + 1] = q.y; xr[4 * v + 2] = q.z; xr[4 * v + 3] = q.w;
        }
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float4* wq =
              reinterpret_cast<const float4*>(ws + ((i * K + j) * p.ck + ch) * p.Cout16 + n0);
          const float4 wa = wq[0], wb = wq[1];
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int px = 0; px < F_PX; ++px)
#pragma unroll
            for (int o = 0; o < 8; ++o) acc[px][o] = fmaf(xr[px + j], wv[o], acc[px][o]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage c & 1 before chunk c + 2 lands there
  }

  // Epilogue: bias, ReLU, float32 out.
  const int gy = ty * F_TH + r;
  if (gy >= p.H || n0 >= p.Cout) return;
  const bool vec = (p.Cout % 4) == 0;
  float bv[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) bv[o] = p.bias[n0 + o];
#pragma unroll
  for (int px = 0; px < F_PX; ++px) {
    const int gx = tx * F_TW + c0 + px;
    if (gx >= p.W) break;
    float v[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      v[o] = acc[px][o] + bv[o];
      if (p.act) v[o] = fmaxf(v[o], 0.0f);
    }
    float* orow = p.out + (((size_t)b * p.H + gy) * p.W + gx) * p.Cout + n0;
    if (vec && n0 + 8 <= p.Cout) {
      reinterpret_cast<float4*>(orow)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(orow)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int o = 0; o < 8; ++o)
        if (n0 + o < p.Cout) orow[o] = v[o];
    }
  }
}

template <int K>
int launch_f32(const ConvF32Params& p, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv2d_f32_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)p.B * p.tiles_x * p.tiles_y;
  conv2d_f32_kernel<K><<<(unsigned)tiles, 4 * p.Cout16, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int NF>
int launch(const ConvParams& p, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv2d_kernel<NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0, dev = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv2d_kernel<NF>, NTHREADS,
                                                      smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = min(p.tiles, per_sm * sms);
  conv2d_kernel<NF><<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch one conv (odd K <= 9, Cin % 8 == 0, 1 <= Cout <= 128; act != 0
// fuses the ReLU) on the plan of `conv2d_plan` (ops/cuda/conv.py): ck
// channels per input chunk, tg taps per streamed weight group (0: the
// whole weight set resident), x_bytes per input-tile buffer, smem bytes in
// all. Returns the cudaError_t of the launch (cudaErrorInvalidValue for a
// shape or plan outside the contract); the kernel runs on `stream`.
extern "C" int vfi_conv2d_bf16(const void* x, const void* w, const void* bias, void* out,
                               int B, int H, int W, int Cin, int Cout, int K, int act,
                               int ck, int tg, int x_bytes, int smem,
                               int device, void* stream) {
  if (Cin < 8 || Cin % 8 != 0 || Cout < 1 || Cout > MAX_COUT || K < 1 || K % 2 == 0 ||
      K > MAX_K || B < 0 || H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  const int cin16 = pad16(Cin), cout16 = pad16(Cout), wp = cout16 + PAD;
  const int tpx = (TH + K - 1) * (TW + K - 1);
  const long long wbytes = tg == 0 ? 2LL * K * K * cin16 * wp : 2LL * 2 * tg * ck * wp;
  if (ck < 16 || ck % 16 != 0 || ck > cin16 || tg < 0 || tg > K * K || x_bytes % 128 != 0 ||
      x_bytes < tpx * (ck + PAD) * 2 || smem < 2LL * x_bytes + wbytes)
    return (int)cudaErrorInvalidValue;
  ConvParams p{};
  p.x = static_cast<const bf16*>(x);
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
  switch (cout16 / 16) {
    case 1: return launch<1>(p, smem, s);
    case 2: return launch<2>(p, smem, s);
    case 3: return launch<3>(p, smem, s);
    case 4: return launch<4>(p, smem, s);
    case 5: return launch<5>(p, smem, s);
    case 6: return launch<6>(p, smem, s);
    case 7: return launch<7>(p, smem, s);
    default: return launch<8>(p, smem, s);
  }
}

// Launch one float32 conv (Cin >= 1, odd K <= 9, 1 <= Cout <= 128; act != 0
// fuses the ReLU) on the plan of `conv2d_plan(..., itemsize=4)`: ck
// channels a chunk, smem bytes of dynamic shared memory (at least the two
// stages the entry recomputes). Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape or plan outside the contract); the
// kernel runs on `stream`.
extern "C" int vfi_conv2d_f32(const void* x, const void* w, const void* bias, void* out,
                              int B, int H, int W, int Cin, int Cout, int K, int act, int ck,
                              int smem, int device, void* stream) {
  if (Cin < 1 || Cout < 1 || Cout > MAX_COUT || K < 1 || K % 2 == 0 || K > MAX_K || B < 0 ||
      H < 0 || W < 0 || ck < 1)
    return (int)cudaErrorInvalidValue;
  ConvF32Params p{};
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.B = B; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout; p.K = K;
  p.Cin16 = pad16(Cin); p.Cout16 = pad16(Cout); p.act = act ? 1 : 0;
  p.ck = ck; p.nchunks = (Cin + ck - 1) / ck;
  p.x_floats = ck * (F_TH + K - 1) * f32_pitch(K);
  p.w_floats = K * K * ck * p.Cout16;
  if (smem < 2LL * 4 * (p.x_floats + p.w_floats)) return (int)cudaErrorInvalidValue;
  p.tiles_x = (W + F_TW - 1) / F_TW;
  p.tiles_y = (H + F_TH - 1) / F_TH;
  if ((long long)B * p.tiles_x * p.tiles_y == 0) return (int)cudaSuccess;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch_f32<1>(p, smem, s);
    case 3: return launch_f32<3>(p, smem, s);
    case 5: return launch_f32<5>(p, smem, s);
    case 7: return launch_f32<7>(p, smem, s);
    default: return launch_f32<9>(p, smem, s);
  }
}

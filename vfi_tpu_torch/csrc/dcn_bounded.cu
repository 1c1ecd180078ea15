// Bounded modulated deformable conv (DCNv2), bf16 NHWC, stride 1, 3x3,
// one offset group, offsets clamped to [-R, R], optional mask (none means
// weight 1), Cin a multiple of 8 (the wrapper pads any other) and Cout up
// to 128.
//
// Replaces: vfi_tpu/ops/pallas/sampling.py::_sampling_kernel_v4
// (deform_conv2d_pallas_v4, the route of dcn_kernel="v4", the JAX
// package's default) and ::_sampling_kernel_v5 (deform_conv2d_pallas_v5,
// dcn_kernel="v5"): the TPU kernels of EMAVFI's three fusion DCNs, which
// compute one function. The TPU had no fast gather, so its kernels
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
// Design: a block owns PX = 64 output pixels of one row. It
//   1. copies the input it can reach -- rows py-1-R .. py+1+R, columns
//      px0-1-R .. px0+64+R, zeros outside the image -- into shared memory
//      once (cp.async), and computes per (pixel, tap) the clamped float32
//      sample position, its four corners in that tile (none outside the
//      image) and the four bilinear weights times the tap's mask;
//   2. walks the 9 taps: for tap t it builds the modulated sample slab
//      S_t[PX][Cin16] -- each entry the float32 blend of four corners read
//      from the tile, rounded once to bf16, the working dtype the TPU
//      kernel's sample buffer holds -- and multiplies it by the tap's
//      weight slice W_t[Cin16][Cout16] on the tensor cores (WMMA bf16,
//      float32 accumulators kept in registers across all taps; warp w owns
//      fragments w, w + 8, ... of the 4 x Cout16/16 grid, at most MAXJ = 4,
//      so Cout16 = 80 splits 3/2 over the 8 warps). S and W are
//      double-buffered: the next tap's slab is built and its weight slice
//      streams in (cp.async) while this tap multiplies;
//   3. adds the bias and writes bf16 -- one rounding of the output.
// Shared memory grows with (3 + 2R)(66 + 2R) Cin16; the launch computes
// it (vfi_dcn_bounded_smem_bytes) and refuses a (C, R) pair above the
// card's per-block limit (227 KB on Hopper): C <= 80 runs every R <= 4.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int PX = 64;            // output pixels per block (one row segment)
constexpr int NTAPS = 9;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int SPAD = 16;          // S row padding (bank spread, 32 B aligned rows)
constexpr int WPAD = 8;           // W row padding (bank spread)
constexpr int MAX_COUT = 128;
constexpr int MAXJ = (PX / 16) * (MAX_COUT / 16) / NWARPS;  // accumulators per warp

__host__ __device__ inline int pad16(int c) { return (c + 15) / 16 * 16; }
__host__ __device__ inline int round128(int b) { return (b + 127) / 128 * 128; }

struct DcnParams {
  const bf16* x;        // (B, H, W, Cin)
  const bf16* offset;   // (B, H, W, 18): (dy, dx) of tap t at 2t, 2t + 1
  const bf16* mask;     // (B, H, W, 9), or null: weight 1
  const bf16* w;        // (9 * Cin16, Cout16), row t * Cin16 + c, zero padded
  const float* bias;    // (Cout16,), zero padded
  bf16* out;            // (B, H, W, Cout)
  int B, H, W, Cin, Cout, R, Cin16, Cout16;
  int x_bytes, s_bytes, w_bytes;   // shared-memory regions
};

// Shared-memory regions of one block: the input tile, the two sample
// slabs, the two weight slices, the taps' corner indices and weights.
struct DcnSmem {
  int x_bytes, s_bytes, w_bytes, total;
};

__host__ inline DcnSmem dcn_smem(int Cin, int Cout, int R) {
  const int cin16 = pad16(Cin), cout16 = pad16(Cout);
  DcnSmem m;
  m.x_bytes = round128((3 + 2 * R) * (PX + 2 + 2 * R) * cin16 * 2);
  m.s_bytes = 2 * PX * (cin16 + SPAD) * 2;
  m.w_bytes = round128(2 * cin16 * (cout16 + WPAD) * 2);
  m.total = m.x_bytes + m.s_bytes + m.w_bytes + PX * NTAPS * 4 * 8;
  return m;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__global__ void __launch_bounds__(NTHREADS)
dcn_bounded_kernel(const DcnParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Cin = p.Cin, Cout = p.Cout, R = p.R;
  const int Cin16 = p.Cin16, Cout16 = p.Cout16;
  const int trows = 3 + 2 * R, tcols = PX + 2 + 2 * R;
  const int kp = Cin16 + SPAD, wp = Cout16 + WPAD;
  bf16* X = reinterpret_cast<bf16*>(smem);                               // [trows*tcols][Cin16]
  bf16* S = reinterpret_cast<bf16*>(smem + p.x_bytes);                   // [2][PX][kp]
  bf16* Wt = reinterpret_cast<bf16*>(smem + p.x_bytes + p.s_bytes);      // [2][Cin16][wp]
  int* cidx = reinterpret_cast<int*>(smem + p.x_bytes + p.s_bytes + p.w_bytes);  // [PX*9][4]
  float* cwt = reinterpret_cast<float*>(cidx + PX * NTAPS * 4);                  // [PX*9][4]

  const int px0 = blockIdx.x * PX, py = blockIdx.y, b = blockIdx.z;
  const int H = p.H, W = p.W;
  const int ty0 = py - 1 - R, tx0 = px0 - 1 - R;   // image position of tile (0, 0)
  const size_t row0 = ((size_t)b * H + py) * W;    // flat pixel index of (b, py, 0)
  const int chunks = Cin16 / 8;

  auto stage_w = [&](int t, int buf) {
    const bf16* src = p.w + (size_t)t * Cin16 * Cout16;
    bf16* dst = Wt + buf * Cin16 * wp;
    const int rc = Cout16 / 8;
    for (int c = threadIdx.x; c < Cin16 * rc; c += NTHREADS) {
      const int k = c / rc, j = c - (c / rc) * rc;
      cp_async16(dst + k * wp + j * 8, src + (size_t)k * Cout16 + j * 8);
    }
    cp_async_commit();
  };

  // 1. The reachable input tile (channels past Cin zero), and the taps'
  //    corners and weights.
  {
    const bf16* xb = p.x + (size_t)b * H * W * Cin;
    for (int it = threadIdx.x; it < trows * tcols * chunks; it += NTHREADS) {
      const int pix = it / chunks, ch = it - (it / chunks) * chunks;
      const int gy = ty0 + pix / tcols, gx = tx0 + pix % tcols;
      bf16* dst = X + (size_t)pix * Cin16 + ch * 8;
      if (ch * 8 < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
        cp_async16(dst, xb + ((size_t)gy * W + gx) * Cin + ch * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
  }
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
  cp_async_wait_all();
  __syncthreads();

  // S_t[pixel][c] = bf16(sum over corners of weight * x), float32 blend.
  auto build_s = [&](int t, int buf) {
    bf16* sb = S + buf * PX * kp;
    for (int it = threadIdx.x; it < PX * chunks; it += NTHREADS) {
      const int pl = it / chunks, ch = it - (it / chunks) * chunks;
      const int pt = pl * NTAPS + t;
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int idx = cidx[pt * 4 + c];
        if (idx >= 0) {
          const float wgt = cwt[pt * 4 + c];
          const uint4 raw = *reinterpret_cast<const uint4*>(X + (size_t)idx * Cin16 + ch * 8);
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
      *reinterpret_cast<uint4*>(sb + pl * kp + ch * 8) = *reinterpret_cast<const uint4*>(o);
    }
  };

  // 2. Taps: out[PX][Cout16] += S_t @ W_t. Warp w owns output fragments
  //    w, w + NWARPS, ... of the (PX/16) x (Cout16/16) grid.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntn = Cout16 / 16, items = (PX / 16) * ntn;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXJ];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) wmma::fill_fragment(acc[j], 0.0f);
  build_s(0, 0);
  stage_w(1, 1);
  __syncthreads();
  for (int t = 0; t < NTAPS; ++t) {
    const bf16* sb = S + (t & 1) * PX * kp;
    const bf16* wb = Wt + (t & 1) * Cin16 * wp;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int item = warp + j * NWARPS;
      if (item < items) {
        const int mt = item / ntn, nt = item - (item / ntn) * ntn;
        for (int k0 = 0; k0 < Cin16; k0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afr;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(afr, sb + mt * 16 * kp + k0, kp);
          wmma::load_matrix_sync(bfr, wb + k0 * wp + nt * 16, wp);
          wmma::mma_sync(acc[j], afr, bfr, acc[j]);
        }
      }
    }
    if (t + 1 < NTAPS) build_s(t + 1, (t + 1) & 1);
    cp_async_wait_all();
    __syncthreads();   // S_{t+1}, W_{t+1} ready; S_t, W_t free
    if (t + 2 < NTAPS) stage_w(t + 2, t & 1);
  }

  // 3. Bias, one rounding, bf16 out at Cout channels. The S buffers are
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

}  // namespace

// Dynamic shared memory one launch needs for (Cin, Cout, R), in bytes.
extern "C" int vfi_dcn_bounded_smem_bytes(int Cin, int Cout, int R) {
  return dcn_smem(Cin, Cout, R).total;
}

// Launch one bounded DCN layer (integer radius R >= 0, Cin % 8 == 0,
// 1 <= Cout <= 128).
// `mask` may be null (weight 1). Returns the cudaError_t of the launch;
// cudaErrorInvalidValue for arguments out of range, including a shared
// memory need above the card's per-block limit.
extern "C" int vfi_dcn_bounded_bf16(const void* x, const void* offset, const void* mask,
                                    const void* w, const void* bias, void* out,
                                    int B, int H, int W, int Cin, int Cout, int R,
                                    int device, void* stream) {
  if (Cin < 8 || Cin % 8 != 0 || Cout < 1 || Cout > MAX_COUT || R < 0)
    return (int)cudaErrorInvalidValue;
  DcnParams p{};
  p.x = static_cast<const bf16*>(x);
  p.offset = static_cast<const bf16*>(offset);
  p.mask = static_cast<const bf16*>(mask);
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<bf16*>(out);
  p.B = B; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout; p.R = R;
  p.Cin16 = pad16(Cin); p.Cout16 = pad16(Cout);
  const DcnSmem m = dcn_smem(Cin, Cout, R);
  p.x_bytes = m.x_bytes; p.s_bytes = m.s_bytes; p.w_bytes = m.w_bytes;
  if (p.s_bytes < NWARPS * 256 * 4) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (m.total > limit) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(dcn_bounded_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, m.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + PX - 1) / PX, H, B);
  dcn_bounded_kernel<<<grid, NTHREADS, m.total, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

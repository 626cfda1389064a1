// K9: d(kernel) of the reflect-padded 3x3 conv of the trainable music
// encoder, on tensor cores.
//
// Replaces conductor_tpu/ops/conv_train.py::_dkernel_pallas (kernel
// `_dkernel_kernel`, pallas_call at :122):
//
//   dW[dt, df, ci, co] = sum over (b, t, f) of xe[b, t+dt-1, f+df-1, ci] * dy[b, t, f, co]
//
// with xe the input reflect-extended by one row and column on each side.
// The TPU kernel computes it in the lane-blocked halo layout
// ((G+2)*Cin x G*Cout per time shift) and folds that back with offset-eye
// contractions; here the result is (3, 3, Cin, Cout) directly.
//
// Layout: x (B, T, F, Cin) and dy (B, T, F, Cout) bf16 NHWC; dW float32
// (3, 3, Cin, Cout), float32 accumulation.
//
// What bounds it on an H100: bytes.  The call reads x and dy once and
// writes at most 9 * 32 * 32 floats; the products are 2 * 9 * Cin * Cout
// flops a pixel.  Over one stage-1 forward's seven calls (B = 10) that is
// ~340 MB, 0.10 ms at 3.35 TB/s, against 30 GFLOP, 0.03 ms on the bf16
// tensor cores but at least 0.45 ms as float32 FMAs on the CUDA cores.  So
// the products run on tensor cores and the operands stay bf16 from device
// memory to the MMA.
//
// Design:
// - A tile is `tile_t` rows of one clip.  Shared memory holds its x rows
//   with the reflected halo (tile_t + 2 rows of F + 2 pixels) and its dy
//   rows (tile_t rows, also F + 2 pixels a row, the two extra ones zero),
//   both [pixel][channel], so one flat pixel index p walks both: tap
//   (dt, df) pairs dy's pixel p with x's pixel p + dt (F + 2) + df.  Each
//   tap is then one GEMM over the tile's pixels, dW_tap (Cin x Cout) +=
//   X_shift^T (Cin x P) . dY (P x Cout): mma.sync m16n8k16, bf16 operands,
//   float32 sums, both fragments loaded by ldmatrix.trans from the
//   pixel-major tiles.  A pixel is 2 or 4 16-byte chunks; chunk c of pixel
//   p sits at c ^ (a few bits of p), so the 8 consecutive pixels of one
//   8x8 ldmatrix hit 8 distinct bank groups at any tap's shift.
// - Cin = 1: each tile's (P x 16) im2col (the 9 taps, 7 zeros) is built in
//   shared memory from the x tile, and the same MMA runs with the taps as
//   its 16 rows.
// - Tiles arrive by 16-byte cp.async into a ring of 3 stages (fewer where
//   the rows are too wide), so the copies of the next tiles overlap this
//   one's MMAs; the reflected halo comes by index, rows past the clip's
//   end are zero-filled.  x at Cin = 1 (2-byte pixels, 6 % of that call's
//   bytes) comes by plain loads.
// - Each warp keeps the 9 taps of one (16 Cin x 16 Cout) block of dW in
//   registers (72 floats) and walks every n-th 16-pixel step of the tile,
//   n the number of warps sharing that block.  At the end the warps' sums
//   are added in shared memory in warp order, each block writes its
//   partial to a workspace and a second launch adds the partials in block
//   order (runs of blocks, then the runs).  No atomics: the result is
//   deterministic, as K6's weight gradients are.
// - The grid is sized per shape: up to two blocks on each SM, and fewer
//   where the tiles are few (at least kMinTiles a block), so that the
//   partials (36 KB a block at 32 x 32) stay small against the operands.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "conv_tile.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 2 * 132;     // two blocks on each of the H100's SMs
constexpr int kSmemBudget = 110 * 1024;  // two blocks an SM
constexpr int kMaxSmem = 227 * 1024;     // one block an SM
constexpr int kMaxTileRows = 16;
constexpr int kMinTiles = 4;      // tiles a block pipelines at least
constexpr int kReduceRuns = 8;    // runs of blocks the second launch sums apart

using convt::cp_async16;
using convt::reflect;
using convt::swz;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ldmatrix_x4_trans;
using tc::mma_bf16;
using tc::smem_addr;

// A fragment (16 channels c0 .. c0 + 15 x pixels p .. p + 15) of a
// pixel-major swizzled tile of CH chunks a pixel, as mma's row-major A:
// matrices (channels 0-7 | 8-15) x (pixels 0-7 | 8-15), channel block first.
template <int CH>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t tile, int p, int c0, int lane) {
  const int j = lane >> 3;
  ldmatrix_x4_trans(a, tile + 16 * swz<CH>(p + (j >> 1) * 8 + (lane & 7), c0 / 8 + (j & 1)));
}

// B fragments of two n8 tiles (pixels p .. p + 15 x channels c0 .. c0 + 15)
// of a pixel-major swizzled tile: b[0], b[1] for channels c0 .. c0 + 7,
// b[2], b[3] for c0 + 8 .. c0 + 15; pixel block first.
template <int CH>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], uint32_t tile, int p, int c0, int lane) {
  const int j = lane >> 3;
  ldmatrix_x4_trans(b, tile + 16 * swz<CH>(p + (j & 1) * 8 + (lane & 7), c0 / 8 + (j >> 1)));
}

struct Plan {
  int tile_t;          // rows of a tile
  int x_bytes, stage;  // bytes of a stage's x tile, and of the whole stage (x, then dy)
  int stages;          // ring depth
  int smem;            // dynamic shared memory of the partial kernel; -1: does not fit
  int tiles_per_clip, ntiles, nblocks;
};

// The first (stages, shared-memory limit) under which a tile of at least
// one row fits, with the most rows that fit.
Plan plan(int B, int T, int F, int cin, int cout) {
  Plan p;
  const int w = F + 2;
  // the warps' sums staged for the in-block reduction, in the ring's place
  const int red = cin == 1 ? kWarps * 16 * cout * 4
                           : kWarps / ((cin / 16) * (cout / 16)) * 9 * cin * cout * 4;
  const int options[4][2] = {{3, kSmemBudget}, {3, kMaxSmem}, {2, kMaxSmem}, {1, kMaxSmem}};
  p.smem = -1;
  for (const auto& opt : options) {
    for (int rows = T < kMaxTileRows ? T : kMaxTileRows; rows >= 1 && p.smem < 0; --rows) {
      const long long ppad = ceil_div(rows * w, 16) * 16;  // dy pixels of a tile
      const long long xpix = ppad + 2 * w + 2;  // the last tap's reach past the dy tile
      const long long x_bytes = (xpix * cin * 2 + 127) / 128 * 128;
      const long long stage = x_bytes + ppad * cout * 2;
      const long long ring = opt[0] * stage + (cin == 1 ? ppad * 32 : 0);
      const long long smem = ring > red ? ring : red;
      if (smem <= opt[1]) {
        p.tile_t = rows;
        p.x_bytes = (int)x_bytes;
        p.stage = (int)stage;
        p.stages = opt[0];
        p.smem = (int)smem;
      }
    }
    if (p.smem > 0) break;
  }
  if (p.smem < 0) return p;
  p.tiles_per_clip = ceil_div(T, p.tile_t);
  p.ntiles = B * p.tiles_per_clip;
  const int want = p.ntiles / kMinTiles;
  p.nblocks = want < 1 ? 1 : (want > kMaxBlocks ? kMaxBlocks : want);
  return p;
}

template <int CIN, int COUT>
__global__ void __launch_bounds__(kThreads, 2)
dkernel_partial(const bf16* __restrict__ x, const bf16* __restrict__ dy, float* __restrict__ ws,
                int T, int F, Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kCoBlocks = COUT / 16;
  // blocks of 16 x 16 of dW a warp owns 9 taps of, and the warps sharing one
  constexpr int kGroups = CIN == 1 ? 1 : (CIN / 16) * kCoBlocks;
  constexpr int kSlices = kWarps / kGroups;
  constexpr int kAcc = CIN == 1 ? kCoBlocks : 9;  // 16 x 16 sums a warp keeps
  constexpr int kChX = CIN == 1 ? 2 : CIN / 8, kChD = COUT / 8;
  constexpr int kN = 9 * CIN * COUT;
  const int w = F + 2, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = warp % kGroups, slice = warp / kGroups;
  const int ci0 = CIN == 1 ? 0 : (group / kCoBlocks) * 16;
  const int co0 = (group % kCoBlocks) * 16;

  // zero once: dy's two extra pixels a row and its tail, x's tail
  for (int i = threadIdx.x; i < p.smem / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int first = (int)((long long)blockIdx.x * p.ntiles / gridDim.x);
  const int count = (int)((long long)(blockIdx.x + 1) * p.ntiles / gridDim.x) - first;
  bf16* col = reinterpret_cast<bf16*>(smem + (size_t)p.stages * p.stage);  // Cin = 1: im2col

  auto load = [&](int tile, int s) {
    const int b = tile / p.tiles_per_clip, t0 = (tile % p.tiles_per_clip) * p.tile_t;
    const int rows = min(p.tile_t, T - t0);
    bf16* xs = reinterpret_cast<bf16*>(smem + (size_t)s * p.stage);
    bf16* ds = reinterpret_cast<bf16*>(smem + (size_t)s * p.stage + p.x_bytes);
    const bf16* xb = x + (size_t)b * T * F * CIN;
    if constexpr (CIN == 1) {
      const int n = (p.tile_t + 2) * w;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int r = i / w, j = i - r * w;
        xs[i] = r < rows + 2 ? xb[(size_t)reflect(t0 - 1 + r, T) * F + reflect(j - 1, F)]
                             : __float2bfloat16(0.f);
      }
    } else {
      const int n = (p.tile_t + 2) * w * kChX;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int c = i % kChX, px = i / kChX, r = px / w, j = px - r * w;
        const bool valid = r < rows + 2;
        const int t = valid ? reflect(t0 - 1 + r, T) : 0;
        cp_async16(xs + 8 * swz<kChX>(px, c),
                   xb + ((size_t)t * F + reflect(j - 1, F)) * CIN + c * 8, valid);
      }
    }
    const int per_row = F * kChD;
    const int n = p.tile_t * per_row;
    const bf16* db = dy + ((size_t)b * T + t0) * F * COUT;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = i / per_row, rem = i - r * per_row;
      const bool valid = r < rows;
      cp_async16(ds + 8 * swz<kChD>(r * w + rem / kChD, rem % kChD), valid ? db + (size_t)i * 8 : dy,
                 valid);
    }
  };

  float acc[kAcc][2][4];
#pragma unroll
  for (int i = 0; i < kAcc; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < count) load(first + s, s);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    const int ahead = i + p.stages - 1;
    if (ahead < count) load(first + ahead, ahead % p.stages);
    cp_async_commit();
    // tile i's group is complete once at most stages - 1 are pending
    if (p.stages == 3)
      cp_async_wait<2>();
    else if (p.stages == 2)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const int tile = first + i;
    const int rows = min(p.tile_t, T - (tile % p.tiles_per_clip) * p.tile_t);
    const int ksteps = (rows * w + 15) / 16;
    const int s = i % p.stages;
    const uint32_t ds = smem_addr(smem + (size_t)s * p.stage + p.x_bytes);
    if constexpr (CIN == 1) {
      // im2col: pixel q's 16 values are x at q + dt (F + 2) + df for the
      // 9 taps, then zeros; chunk c holds values 8c .. 8c + 7
      const unsigned short* xs = reinterpret_cast<const unsigned short*>(smem + (size_t)s * p.stage);
      for (int q = threadIdx.x; q < ksteps * 16; q += kThreads) {
        uint32_t v[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int m0 = 2 * m, m1 = 2 * m + 1;
          const uint32_t lo = m0 < 9 ? xs[q + (m0 / 3) * w + m0 % 3] : 0u;
          const uint32_t hi = m1 < 9 ? xs[q + (m1 / 3) * w + m1 % 3] : 0u;
          v[m] = lo | (hi << 16);
        }
        uint4* dst = reinterpret_cast<uint4*>(col);
        dst[swz<2>(q, 0)] = make_uint4(v[0], v[1], v[2], v[3]);
        dst[swz<2>(q, 1)] = make_uint4(v[4], v[5], v[6], v[7]);
      }
      __syncthreads();
      const uint32_t cs = smem_addr(col);
      for (int k = warp; k < ksteps; k += kWarps) {
        uint32_t a[4];
        load_a<2>(a, cs, k * 16, 0, lane);
#pragma unroll
        for (int nb = 0; nb < kCoBlocks; ++nb) {
          uint32_t b[4];
          load_b<kChD>(b, ds, k * 16, nb * 16, lane);
          mma_bf16(acc[nb][0], a, b[0], b[1]);
          mma_bf16(acc[nb][1], a, b[2], b[3]);
        }
      }
    } else {
      const uint32_t xs = smem_addr(smem + (size_t)s * p.stage);
      for (int k = slice; k < ksteps; k += kSlices) {
        uint32_t b[4];
        load_b<kChD>(b, ds, k * 16, co0, lane);
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          uint32_t a[4];
          load_a<kChX>(a, xs, k * 16 + (tap / 3) * w + tap % 3, ci0, lane);
          mma_bf16(acc[tap][0], a, b[0], b[1]);
          mma_bf16(acc[tap][1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // stage s (and the im2col) consumed
  }
  cp_async_wait<0>();

  // the warps' sums, in the ring's place: Cin = 1 (warp, 16 tap rows,
  // Cout), else (slice, 9, Cin, Cout); C fragment element e of n8 tile n
  // is row lane / 4 + 8 (e / 2), column n * 8 + 2 (lane % 4) + e % 2
  float* red = reinterpret_cast<float*>(smem);
  const int r = lane >> 2, cc = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    float* base = CIN == 1 ? red + (size_t)warp * 16 * COUT + i * 16
                           : red + ((size_t)(slice * 9 + i) * CIN + ci0) * COUT + co0;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      *reinterpret_cast<float2*>(base + r * COUT + n * 8 + cc) = make_float2(acc[i][n][0], acc[i][n][1]);
      *reinterpret_cast<float2*>(base + (r + 8) * COUT + n * 8 + cc) =
          make_float2(acc[i][n][2], acc[i][n][3]);
    }
  }
  __syncthreads();
  constexpr int kCopies = CIN == 1 ? kWarps : kSlices;
  constexpr int kStride = CIN == 1 ? 16 * COUT : kN;  // floats between two copies
  float* out = ws + (size_t)blockIdx.x * kN;
  for (int o = threadIdx.x; o < kN; o += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < kCopies; ++k) v += red[k * kStride + o];
    out[o] = v;
  }
}

// dW[o] = the sum of the blocks' partials: kReduceRuns runs of consecutive
// blocks, each summed in block order, then the runs in order.
__global__ void __launch_bounds__(32 * kReduceRuns)
dkernel_reduce(const float* __restrict__ ws, float* __restrict__ dw, int nblocks, int n) {
  __shared__ float runs[kReduceRuns][32];
  const int lane = threadIdx.x & 31, run = threadIdx.x >> 5;
  const int o = blockIdx.x * 32 + lane;
  const int per = (nblocks + kReduceRuns - 1) / kReduceRuns;
  const int k1 = min(nblocks, (run + 1) * per);
  float v = 0.f;
  if (o < n) {
#pragma unroll 4
    for (int k = run * per; k < k1; ++k) v += ws[(size_t)k * n + o];
  }
  runs[run][lane] = v;
  __syncthreads();
  if (run == 0 && o < n) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kReduceRuns; ++i) t += runs[i][lane];
    dw[o] = t;
  }
}

template <int CIN, int COUT>
cudaError_t launch(const bf16* x, const bf16* dy, float* ws, float* dw, int B, int T, int F,
                   cudaStream_t s) {
  const Plan p = plan(B, T, F, CIN, COUT);
  cudaError_t err = cudaFuncSetAttribute(dkernel_partial<CIN, COUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  dkernel_partial<CIN, COUT><<<p.nblocks, kThreads, p.smem, s>>>(x, dy, ws, T, F, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = 9 * CIN * COUT;
  dkernel_reduce<<<ceil_div(n, 32), 32 * kReduceRuns, 0, s>>>(ws, dw, p.nblocks, n);
  return cudaGetLastError();
}

template <int CIN>
cudaError_t launch_cin(const bf16* x, const bf16* dy, float* ws, float* dw, int B, int T, int F,
                       int cout, cudaStream_t s) {
  return cout == 16 ? launch<CIN, 16>(x, dy, ws, dw, B, T, F, s)
                    : launch<CIN, 32>(x, dy, ws, dw, B, T, F, s);
}

bool supported(int B, int T, int F, int cin, int cout) {
  return B >= 1 && T >= 2 && F >= 2 && (cin == 1 || cin == 16 || cin == 32) &&
         (cout == 16 || cout == 32) && plan(B, T, F, cin, cout).smem > 0;
}

// ---- float32 mode -----------------------------------------------------------
//
// The same d(kernel) on float32 x and dy with float32 products, the JAX
// kernel's mxu_dtype=x.dtype (conv_train.py:125).  Float32 MMAs would be
// TF32, so the products are FFMAs on the CUDA cores, and operations bound
// it: the seven stage-1 calls' 31 GFLOP take 0.46 ms at 67 TFLOP/s against
// 0.2 ms for their float32 bytes.
//
// Design: register-tiled FFMA over a sliding window.  Tiles of `tile_t`
// rows of one clip arrive by 16-byte cp.async in a ring of 2 stages (1
// where the rows are too wide): x with its reflected halo, (tile_t + 2)
// rows of F + 2 pixels, and dy, tile_t rows of F pixels, both
// [pixel][channel].  A group of 3 (Cin / 4) (Cout / 8) threads holds one
// copy of dW: each thread the three column taps of one row tap dt, 4
// input x 8 output channels (96 sums; 3 x 8 at Cin = 1).  The block's
// copies (slices) share the tile's work, runs of kSeg columns of one row:
// a thread walks its run column by column, loading one new x pixel (the
// window of three column taps slides) and two float4s of dy a column for
// 96 FFMAs.  At the end the slices' sums are added in shared memory in
// slice order, each block writes its partial and dkernel_reduce adds the
// partials in block order: deterministic, as the bf16 mode.
namespace f32 {

constexpr int kCO = 8;            // output channels a thread
constexpr int kSeg = 16;          // columns a unit of work
constexpr int kTileRows = 16;     // rows a tile at most

template <int CIN, int COUT>
struct Geo {
  static constexpr int kCI = CIN == 1 ? 1 : 4;                // input channels a thread
  static constexpr int kNci = CIN / kCI, kNco = COUT / kCO;
  static constexpr int kGroup = 3 * kNci * kNco;              // threads of one copy of dW
  static constexpr int kSlices = kThreads / kGroup;           // copies a block
  static constexpr int kBlock = kGroup * kSlices;             // threads a block
};

struct Plan {
  int tile_t;          // rows of a tile
  int x_bytes, stage;  // bytes of a stage's x tile, and of the whole stage (x, then dy)
  int stages;          // ring depth
  int smem;            // dynamic shared memory; -1: does not fit
  int tiles_per_clip, ntiles, nblocks;
};

// The most rows (up to kTileRows) whose ring fits one block an SM: two
// stages, else one.  One block an SM: the sums and the sliding window
// take ~130 registers a thread.
template <int CIN, int COUT>
Plan plan(int B, int T, int F) {
  using G = Geo<CIN, COUT>;
  Plan p;
  const int w = F + 2;
  const long long red = (long long)G::kSlices * 9 * CIN * COUT * 4;
  p.smem = -1;
  for (int stages = 2; stages >= 1 && p.smem < 0; --stages)
    for (int rows = T < kTileRows ? T : kTileRows; rows >= 1 && p.smem < 0; --rows) {
      const long long x_bytes = ((long long)(rows + 2) * w * CIN * 4 + 127) / 128 * 128;
      const long long stage = x_bytes + (long long)rows * F * COUT * 4;
      const long long smem = stages * stage > red ? stages * stage : red;
      if (smem <= kMaxSmem) {
        p.tile_t = rows;
        p.x_bytes = (int)x_bytes;
        p.stage = (int)stage;
        p.stages = stages;
        p.smem = (int)smem;
      }
    }
  if (p.smem < 0) return p;
  p.tiles_per_clip = ceil_div(T, p.tile_t);
  p.ntiles = B * p.tiles_per_clip;
  const int want = p.ntiles / kMinTiles, most = sm_count();
  p.nblocks = want < 1 ? 1 : (want > most ? most : want);
  return p;
}

template <int CIN, int COUT>
__global__ void __launch_bounds__(kThreads, 1)
dkernel_partial(const float* __restrict__ x, const float* __restrict__ dy, float* __restrict__ ws,
                int T, int F, Plan p) {
  using G = Geo<CIN, COUT>;
  constexpr int kCI = G::kCI, kSlices = G::kSlices;
  constexpr int kChX = CIN == 1 ? 1 : CIN / 4;  // 16-byte chunks of an x pixel (Cin >= 16)
  constexpr int kN = 9 * CIN * COUT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int w = F + 2, nseg = (F + kSeg - 1) / kSeg;
  const int g = threadIdx.x % G::kGroup, slice = threadIdx.x / G::kGroup;
  const int co0 = (g % G::kNco) * kCO, ci0 = (g / G::kNco) % G::kNci * kCI;
  const int dt = g / (G::kNco * G::kNci);

  const int first = (int)((long long)blockIdx.x * p.ntiles / gridDim.x);
  const int count = (int)((long long)(blockIdx.x + 1) * p.ntiles / gridDim.x) - first;

  auto load = [&](int tile, int s) {
    const int b = tile / p.tiles_per_clip, t0 = (tile % p.tiles_per_clip) * p.tile_t;
    const int rows = min(p.tile_t, T - t0);
    float* xs = reinterpret_cast<float*>(smem + (size_t)s * p.stage);
    float* ds = reinterpret_cast<float*>(smem + (size_t)s * p.stage + p.x_bytes);
    const float* xb = x + (size_t)b * T * F * CIN;
    if constexpr (CIN == 1) {
      const int n = (p.tile_t + 2) * w;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int r = i / w, j = i - r * w;
        xs[i] = r < rows + 2 ? xb[(size_t)reflect(t0 - 1 + r, T) * F + reflect(j - 1, F)] : 0.f;
      }
    } else {
      const int n = (p.tile_t + 2) * w * kChX;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int c = i % kChX, px = i / kChX, r = px / w, j = px - r * w;
        const bool valid = r < rows + 2;
        const int t = valid ? reflect(t0 - 1 + r, T) : 0;
        cp_async16(xs + px * CIN + c * 4, xb + ((size_t)t * F + reflect(j - 1, F)) * CIN + c * 4,
                   valid);
      }
    }
    const int n4 = p.tile_t * F * COUT / 4, valid4 = rows * F * COUT / 4;
    const float* db = dy + ((size_t)b * T + t0) * F * COUT;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      cp_async16(ds + 4 * i, i < valid4 ? db + 4 * i : dy, i < valid4);
  };
  auto pixel = [&](const float* px, float (&v)[kCI]) {
    if constexpr (CIN == 1) {
      v[0] = *px;
    } else {
      const float4 q = *reinterpret_cast<const float4*>(px);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    }
  };

  float acc[3][kCI][kCO];  // [column tap][input channel][output channel]
#pragma unroll
  for (int df = 0; df < 3; ++df)
#pragma unroll
    for (int k = 0; k < kCI; ++k)
#pragma unroll
      for (int c = 0; c < kCO; ++c) acc[df][k][c] = 0.f;

  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < count) load(first + s, s);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    const int ahead = i + p.stages - 1;
    if (ahead < count) load(first + ahead, ahead % p.stages);
    cp_async_commit();
    if (p.stages == 2)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const int tile = first + i;
    const int rows = min(p.tile_t, T - (tile % p.tiles_per_clip) * p.tile_t);
    const int s = i % p.stages;
    const float* xs = reinterpret_cast<const float*>(smem + (size_t)s * p.stage);
    const float* ds = reinterpret_cast<const float*>(smem + (size_t)s * p.stage + p.x_bytes);
    for (int u = slice; u < rows * nseg; u += kSlices) {
      const int r = u / nseg, f0 = (u - r * nseg) * kSeg, f1 = min(F, f0 + kSeg);
      // x pixels (r + dt, f + df) of the window, from staged column f0
      const float* xr = xs + ((size_t)(r + dt) * w + f0) * CIN + ci0;
      const float* dr = ds + ((size_t)r * F + f0) * COUT + co0;
      float xw[3][kCI];
      pixel(xr, xw[0]);
      pixel(xr + CIN, xw[1]);
      for (int f = f0; f < f1; ++f) {
        xr += CIN;
        pixel(xr + CIN, xw[2]);
        const float4 d0 = *reinterpret_cast<const float4*>(dr);
        const float4 d1 = *reinterpret_cast<const float4*>(dr + 4);
        dr += COUT;
        const float d[kCO] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int df = 0; df < 3; ++df)
#pragma unroll
          for (int k = 0; k < kCI; ++k)
#pragma unroll
            for (int c = 0; c < kCO; ++c) acc[df][k][c] = fmaf(xw[df][k], d[c], acc[df][k][c]);
#pragma unroll
        for (int k = 0; k < kCI; ++k) {
          xw[0][k] = xw[1][k];
          xw[1][k] = xw[2][k];
        }
      }
    }
    __syncthreads();  // stage s consumed
  }
  cp_async_wait<0>();
  __syncthreads();

  // the slices' sums, in the ring's place, (slice, 9, Cin, Cout); then
  // this block's partial, the slices added in order
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int df = 0; df < 3; ++df)
#pragma unroll
    for (int k = 0; k < kCI; ++k) {
      float* o = red + ((size_t)(slice * 9 + dt * 3 + df) * CIN + ci0 + k) * COUT + co0;
      *reinterpret_cast<float4*>(o) = make_float4(acc[df][k][0], acc[df][k][1], acc[df][k][2],
                                                  acc[df][k][3]);
      *reinterpret_cast<float4*>(o + 4) = make_float4(acc[df][k][4], acc[df][k][5],
                                                      acc[df][k][6], acc[df][k][7]);
    }
  __syncthreads();
  float* out = ws + (size_t)blockIdx.x * kN;
  for (int o = threadIdx.x; o < kN; o += blockDim.x) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < kSlices; ++k) v += red[k * kN + o];
    out[o] = v;
  }
}

template <int CIN, int COUT>
cudaError_t launch(const float* x, const float* dy, float* ws, float* dw, int B, int T, int F,
                   cudaStream_t s) {
  const Plan p = plan<CIN, COUT>(B, T, F);
  cudaError_t err = cudaFuncSetAttribute(dkernel_partial<CIN, COUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  dkernel_partial<CIN, COUT><<<p.nblocks, Geo<CIN, COUT>::kBlock, p.smem, s>>>(x, dy, ws, T, F, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = 9 * CIN * COUT;
  dkernel_reduce<<<ceil_div(n, 32), 32 * kReduceRuns, 0, s>>>(ws, dw, p.nblocks, n);
  return cudaGetLastError();
}

// fn(Cin, Cout) with both as compile-time constants.
template <class Fn>
auto dispatch(int cin, int cout, Fn&& fn) {
  using std::integral_constant;
  auto by_cout = [&](auto ci) {
    return cout == 16 ? fn(ci, integral_constant<int, 16>{}) : fn(ci, integral_constant<int, 32>{});
  };
  return cin == 1    ? by_cout(integral_constant<int, 1>{})
         : cin == 16 ? by_cout(integral_constant<int, 16>{})
                     : by_cout(integral_constant<int, 32>{});
}

bool supported(int B, int T, int F, int cin, int cout) {
  return B >= 1 && T >= 2 && F >= 2 && (cin == 1 || cin == 16 || cin == 32) &&
         (cout == 16 || cout == 32) && dispatch(cin, cout, [&](auto ci, auto co) {
           return plan<decltype(ci)::value, decltype(co)::value>(B, T, F).smem > 0;
         });
}

}  // namespace f32

}  // namespace

// Bytes of float32 workspace `conv3x3_dkernel` needs; -1 for a shape it does
// not take.
CT_EXPORT long long conv3x3_dkernel_workspace(int B, int T, int F, int cin, int cout) {
  if (!supported(B, T, F, cin, cout)) return -1;
  return (long long)plan(B, T, F, cin, cout).nblocks * 9 * cin * cout * 4;
}

CT_EXPORT int conv3x3_dkernel(const void* x, const void* dy, void* workspace, void* dw, int B,
                              int T, int F, int cin, int cout, void* stream) {
  if (!supported(B, T, F, cin, cout)) return (int)cudaErrorInvalidValue;
  // the 16-byte copies: dy's pixels, and x's at Cin >= 16, start on 16 bytes
  if ((reinterpret_cast<uintptr_t>(dy) | (cin > 1 ? reinterpret_cast<uintptr_t>(x) : 0)) & 15)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const bf16*>(x);
  auto db = static_cast<const bf16*>(dy);
  auto ws = static_cast<float*>(workspace);
  auto out = static_cast<float*>(dw);
  const cudaError_t err = cin == 1    ? launch_cin<1>(xb, db, ws, out, B, T, F, cout, s)
                          : cin == 16 ? launch_cin<16>(xb, db, ws, out, B, T, F, cout, s)
                                      : launch_cin<32>(xb, db, ws, out, B, T, F, cout, s);
  return (int)err;
}

// Bytes of float32 workspace `conv3x3_dkernel_f32` needs; -1 for a shape it
// does not take.
CT_EXPORT long long conv3x3_dkernel_f32_workspace(int B, int T, int F, int cin, int cout) {
  if (!f32::supported(B, T, F, cin, cout)) return -1;
  return f32::dispatch(cin, cout, [&](auto ci, auto co) {
    return (long long)f32::plan<decltype(ci)::value, decltype(co)::value>(B, T, F).nblocks * 9 *
           cin * cout * 4;
  });
}

// The float32 mode of conv3x3_dkernel: x (B, T, F, Cin) and dy (B, T, F,
// Cout) float32, the same refusals.
CT_EXPORT int conv3x3_dkernel_f32(const void* x, const void* dy, void* workspace, void* dw, int B,
                                  int T, int F, int cin, int cout, void* stream) {
  if (!f32::supported(B, T, F, cin, cout)) return (int)cudaErrorInvalidValue;
  // the 16-byte copies: dy's, and x's at Cin >= 16, start on 16 bytes
  if ((reinterpret_cast<uintptr_t>(dy) | (cin > 1 ? reinterpret_cast<uintptr_t>(x) : 0)) & 15)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)f32::dispatch(cin, cout, [&](auto ci, auto co) {
    return f32::launch<decltype(ci)::value, decltype(co)::value>(
        static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<float*>(workspace),
        static_cast<float*>(dw), B, T, F, s);
  });
}

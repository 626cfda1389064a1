// K4: one music-encoder Conv2dResBlock, fused, on tensor cores.
//
// Replaces conductor_tpu/ops/pallas_conv.py::fused_conv_block (kernel
// `_conv_kernel`, pallas_call at :325): 3x3 reflect-padded conv -> folded BN
// affine -> ReLU -> residual (none / identity / 1x1 conv + folded BN), then
// the optional max-pool epilogue (time stride 1 or 3, freq stride 2, -inf
// padding) of the last block of each encoder stage.
//
// Two modes of the JAX kernel's signature (`relu`, `edge`, :212-213) serve
// the trainable conv (`ops/conv_train.py`, K9's forward and d(input)): with
// scale 1, bias 0, no residual and relu off it is the bare reflect-padded
// conv, and with edge "zero" (0 loaded outside the clip) the interior of the
// transposed conv.
//
// Layout: NHWC (B, T, F, C) bf16 activations; weights (3, 3, Cin, Cout) and
// (Cin, Cout) float32, rounded to bf16 once a block (bf16 operands, float32
// sums, as the JAX kernel).
//
// What bounds it on an H100.  A call moves its input and output once (44 MB
// each way at B = 2 for a 16-channel block at T = 5400, F = 128) and does
// 2 * 9 * Cin * Cout flops a pixel: at most 18 K a pixel for ~128 bytes, so
// the ~0.10 ms the serving call's bytes need at 3.35 TB/s is the bound, and
// its 37 GFLOP take 0.04 ms on the bf16 tensor cores but over 0.5 ms as
// float32 FMAs on the CUDA cores.  So the products run on tensor cores,
// the operands stay bf16 from device memory to the MMA, and the pooled
// blocks write only the pooled tensor.  What limits the kernel as built
// (on an H100, PERF.md §6): neither bytes nor MMAs but the instructions
// around them, with 16 warps an SM: the copies' index math and the
// epilogue's affine, residual and staging of 16 pixels x Cout a warp; the
// unpooled blocks take 2.3-2.6x their byte bound.  A pooled block also
// recomputes its pool's halo rows and pools in two more passes over
// shared memory, whose staged conv rows cap its tile: 2-2.4x the time of
// the same conv without the pool.
//
// Design:
// - A tile is `crows` conv rows of one clip.  Shared memory holds its input
//   rows with the +-1 row halo, F + 2 pixels a row (the column halo),
//   pixel-major in XOR-swizzled 16-byte chunks (`conv_tile.cuh`), so tap
//   (dt, df) of output pixel p is staged pixel p + dt (F + 2) + df.  The
//   conv is one GEMM a tap over the tile's flat pixels, out (P x Cout) +=
//   X_shift (P x Cin) . W_tap (Cin x Cout): mma.sync m16n8k16, A fragments
//   by ldmatrix at the tap's pixel offset, B fragments by ldmatrix from the
//   weights staged [tap][Cout][Cin].  Cin = 16 / 32 is one / two k-steps a
//   tap, Cout = 16 / 32 two / four n8 tiles; each warp takes two 16-pixel
//   m-tiles at a time, so a B fragment serves two MMAs.  The two pad pixels
//   of each flat row are computed and dropped.
// - Cin = 1 (the first block, on the mel): the 9 taps are the k of one
//   k-step (7 zeros), each thread gathering its A fragment from the staged
//   row (a 16-wide im2col in registers).
// - Edges: the reflected halo comes by index; the zero edge, and rows past
//   the clip, by cp.async's zero fill.  The input rows arrive by 16-byte
//   cp.async into a ring of 2 stages (1 where a larger tile pays more), so
//   the next tile's copy overlaps this one's MMAs; at Cin = 1 (2-byte
//   pixels) by plain loads, eight in flight a thread.  The weights are
//   staged while the first tile copies.
// - Epilogue in registers: folded BN scale and bias, ReLU, then the
//   identity residual (the staged centre pixel) or the 1x1-conv residual
//   (one more MMA k-step on the centre tap with its own weights, then its
//   own affine).  The bf16 results go through shared memory so that each
//   warp writes whole 16-byte chunks: a warp's own 16-pixel buffer, or, on
//   a pooled block, the tile's conv rows.
// - Pool: a pooled tile computes the conv rows of `n_to` pooled rows plus
//   the pool's halo ((n_to - 1) * st + wt rows, recomputed where two tiles
//   meet); conv rows outside the clip count as -inf.  It pools the staged
//   bf16 rows over time, in place, a thread down each (column, chunk),
//   then over freq, and writes only the pooled tensor.  Pooling the
//   bf16-rounded rows gives the bits of JAX's pooling of the float32 rows
//   then rounding: rounding is monotone, so the max of the rounded values
//   is the rounded max.
// - Grid: two blocks an SM (one only where a row is too wide for two), a
//   block walking a run of consecutive tiles (the next tile's halo rows
//   are still in L2).  `plan` picks the tile's rows and the ring's depth
//   per shape, to the least estimated time: larger tiles re-read fewer
//   halo rows ((crows + 2) / crows; (crows + 2) / (n_to st) on a pooled
//   block) but fill 264 block slots less evenly at B = 1, 2, 8 or 10, and
//   end in a barrier that waits for the busiest warp; a second stage hides
//   the copies but halves the room for the tile.
// - No atomics; every sum runs in a fixed order, so a repeat is
//   bit-identical.

#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "conv_tile.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTwoBlockSmem = 112 * 1024;  // two blocks an SM
constexpr int kMaxSmem = 227 * 1024;       // one block an SM
constexpr int kMaxRows = 64;               // rows of a tile (pooled rows for a pooled block)

using convt::cp_async16;
using convt::reflect;
using convt::swz;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ldmatrix_x4;
using tc::mma_bf16;
using tc::smem_addr;

struct Pool {
  int wt, wf, st, sf, pt, pf, to, fo;  // window, stride, padding, pooled sizes
};

struct Plan {
  int crows;           // conv rows a tile computes
  int step, front;     // conv rows between two tiles; tile 0 starts at conv row -front
  int n_to;            // pooled rows a tile writes (pooled blocks)
  int x_bytes;         // a ring stage
  int w_off, v_off, y_off, x_off;  // byte offsets: weights (+ residual), vectors, out buffer, ring
  int stages, smem;    // ring depth, dynamic shared memory; smem < 0: does not fit
  int tiles_per_clip, ntiles, nblocks, per_sm;
};

__host__ __device__ constexpr int round_up(int a, int m) { return (a + m - 1) / m * m; }

template <int CIN, int COUT>
Plan make_plan(int rows, int stages, int B, int T, int F, bool pool, bool res2, const Pool& pl) {
  Plan p;
  const int w = F + 2;
  constexpr int kK = CIN == 1 ? 16 : CIN;  // k of a tap's GEMM (Cin = 1: the 9 taps)
  if (pool) {
    p.n_to = rows;
    p.crows = (rows - 1) * pl.st + pl.wt;
    p.step = rows * pl.st;
    p.front = pl.pt;
    p.tiles_per_clip = ceil_div(pl.to, rows);
  } else {
    p.n_to = 0;
    p.crows = p.step = rows;
    p.front = 0;
    p.tiles_per_clip = ceil_div(T, rows);
  }
  // output pixels of a tile (crows (F + 2) rounded up to whole m-tile
  // pairs), then the last tap's reach past them
  const int xpix = round_up(p.crows * w, 32) + 2 * w + 2;
  p.x_bytes = round_up(xpix * (CIN == 1 ? 2 : CIN * 2), 128);
  const int w_bytes = (CIN == 1 ? 1 : 9) * COUT * kK * 2 + (res2 ? COUT * kK * 2 : 0);
  p.w_off = 0;
  p.v_off = round_up(w_bytes, 128);
  p.y_off = p.v_off + 4 * COUT * 4;
  const int y_bytes = pool ? p.crows * F * COUT * 2 : kWarps * 16 * COUT * 2;
  p.x_off = round_up(p.y_off + y_bytes, 128);
  p.stages = stages;
  p.smem = p.x_off + stages * p.x_bytes;
  p.ntiles = B * p.tiles_per_clip;
  return p;
}

// The plan of least estimated time over the tile's rows and the ring's
// depth, with two blocks an SM where they fit (the warps wait on their
// ldmatrix and epilogue, so one block's 8 warps take about twice as long),
// else one; {smem = -1} if not even one row fits.  A tile's time on its
// SM: its bytes (input rows with their halo, output) at 3.35 TB/s and its
// flops at ~320 TFLOP/s, both shared by 132 SMs, the larger hiding the
// smaller where a second stage or block overlaps them, plus 300 ns (its
// barriers and pipeline fill).  Its flops are its busiest warp's m-tile
// pairs times the warps: the tile ends at a barrier.
template <int CIN, int COUT>
Plan plan(int B, int T, int F, bool pool, bool res2, const Pool& pl) {
  constexpr double kBytesPerNs = 3.35e12 / 132 / 1e9, kFlopsPerNs = 320e12 / 132 / 1e9;
  constexpr double kTileNs = 300;
  Plan best;
  best.smem = -1;
  double best_ns = 0;
  const int w = F + 2, max_rows = std::min(kMaxRows, pool ? pl.to : T);
  for (int per_sm = 2; per_sm >= 1 && best.smem < 0; --per_sm)
    for (int stages = 2; stages >= 1; --stages)
      for (int rows = 1; rows <= max_rows; ++rows) {
        Plan p = make_plan<CIN, COUT>(rows, stages, B, T, F, pool, res2, pl);
        if (p.smem > (per_sm == 2 ? kTwoBlockSmem : kMaxSmem)) break;
        p.nblocks = std::min(p.ntiles, per_sm * sm_count());
        p.per_sm = per_sm;
        const double out_px = pool ? (double)rows * pl.fo : (double)rows * F;
        const double bytes = (double)(p.crows + 2) * w * CIN * 2 + out_px * COUT * 2;
        const int pairs = ceil_div(ceil_div(p.crows * w, 32), kWarps) * kWarps;
        const double flops = 32.0 * pairs * 2 * COUT * (CIN == 1 ? 16 : 9 * CIN);
        const double l = bytes / kBytesPerNs, c = flops / kFlopsPerNs;
        const double tiles = (double)ceil_div(p.ntiles, p.nblocks) * per_sm;
        const double ns = (per_sm == 2 || stages == 2 ? tiles * fmax(l, c) + fmin(l, c)
                                                      : tiles * (l + c)) +
                          tiles * kTileNs / per_sm;
        if (best.smem < 0 || ns < best_ns) {
          best = p;
          best_ns = ns;
        }
      }
  return best;
}

// put(e, v) for the float4 v holding elements e .. e + 3 of src (n4
// float4s), four loads in flight a thread.
template <class Put>
__device__ __forceinline__ void load_f4(const float* src, int n4, Put&& put) {
  for (int i0 = threadIdx.x; i0 < n4; i0 += 4 * kThreads) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + u * kThreads < n4) v[u] = reinterpret_cast<const float4*>(src)[i0 + u * kThreads];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + u * kThreads < n4) put(4 * (i0 + u * kThreads), v[u]);
  }
}

// The kernel's arguments, apart from the plan.
struct Args {
  const bf16* x;
  const float *w, *scale, *bias, *resw, *rscale, *rbias;
  bf16* out;
  int T, F, res_mode, relu, zero_edge;
};

template <int CIN, int COUT, bool POOL>
__global__ void __launch_bounds__(kThreads, 2)
conv_block_kernel(const Args a, const Plan p, const Pool pl) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kK = CIN == 1 ? 16 : CIN;  // k of a tap's GEMM
  constexpr int kCh = kK / 8;              // 16-byte chunks of a weight row
  constexpr int kChX = CIN / 8;            // ... of a staged pixel (Cin >= 16)
  constexpr int kNt = COUT / 8;            // n8 tiles
  constexpr int kKs = kK / 16;             // k-steps a tap
  constexpr int kTaps = CIN == 1 ? 1 : 9;  // GEMMs a tile (Cin = 1: the taps are its k)
  const int T = a.T, F = a.F, w = F + 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  bf16* ws = reinterpret_cast<bf16*>(smem + p.w_off);
  bf16* rws = ws + kTaps * COUT * kK;
  // zero what no copy writes: each stage's tail pixels (read by the last
  // m-tiles' taps) and, at Cin = 1, the weights' unused k
  const int pix_bytes = CIN == 1 ? 2 : CIN * 2;
  for (int st = 0; st < p.stages; ++st) {
    uint4* tail = reinterpret_cast<uint4*>(smem + p.x_off + (size_t)st * p.x_bytes);
    const int first_tail = (p.crows + 2) * w * pix_bytes / 16;
    for (int i = first_tail + threadIdx.x; i < p.x_bytes / 16; i += kThreads)
      tail[i] = make_uint4(0, 0, 0, 0);
  }
  if constexpr (CIN == 1)
    for (int i = threadIdx.x; i < p.v_off / 16; i += kThreads)
      reinterpret_cast<uint4*>(smem + p.w_off)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int first = (int)((long long)blockIdx.x * p.ntiles / gridDim.x);
  const int count = (int)((long long)(blockIdx.x + 1) * p.ntiles / gridDim.x) - first;
  const int rows_in = p.crows + 2;  // staged input rows

  // tile -> its clip and the conv row of its first row
  auto origin = [&](int tile, int& b, int& c0) {
    b = tile / p.tiles_per_clip;
    c0 = (tile % p.tiles_per_clip) * p.step - p.front;
  };
  // input row of a staged row: itself inside the clip, the reflected (or
  // zero) halo at -1 and T, zero elsewhere (conv rows the pool drops)
  auto in_row = [&](int i, bool& valid) {
    valid = (i >= 0 && i < T) || ((i == -1 || i == T) && !a.zero_edge);
    return valid ? reflect(i, T) : 0;
  };
  auto load = [&](int tile, int s) {
    int b, c0;
    origin(tile, b, c0);
    unsigned char* xs = smem + p.x_off + (size_t)s * p.x_bytes;
    const bf16* xb = a.x + (size_t)b * T * F * CIN;
    if constexpr (CIN == 1) {  // 2-byte pixels: plain loads, eight in flight a thread
      bf16* xv = reinterpret_cast<bf16*>(xs);
      const int n = rows_in * w;
      for (int i0 = threadIdx.x; i0 < n; i0 += 8 * kThreads) {
        bf16 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u * kThreads, r = i / w, j = i - r * w;
          bool rv;
          const int t = in_row(c0 - 1 + r, rv);
          const bool valid = i < n && rv && ((j >= 1 && j <= F) || !a.zero_edge);
          v[u] = valid ? xb[(size_t)t * F + reflect(j - 1, F)] : __float2bfloat16(0.f);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (i0 + u * kThreads < n) xv[i0 + u * kThreads] = v[u];
      }
    } else {
      // thread i copies chunk i % kChX of pixels i / kChX + k kThreads / kChX
      constexpr int kStep = kThreads / kChX;
      const int c = threadIdx.x % kChX, n = rows_in * w;
      int px = threadIdx.x / kChX, r = px / w, j = px - r * w;
      for (; px < n; px += kStep) {
        bool rv;
        const int t = in_row(c0 - 1 + r, rv);
        const bool valid = rv && ((j >= 1 && j <= F) || !a.zero_edge);
        cp_async16(xs + 16 * swz<kChX>(px, c),
                   valid ? xb + ((size_t)t * F + reflect(j - 1, F)) * CIN + c * 8 : a.x, valid);
        for (j += kStep; j >= w; j -= w) ++r;
      }
    }
  };

  // per-thread k offsets of the Cin = 1 gather: taps 2 t4 and 2 t4 + 1
  const int k0 = 2 * t4, k1 = 2 * t4 + 1;
  const int off0 = (k0 / 3) * w + k0 % 3, off1 = (k1 / 3) * w + k1 % 3;
  const int jm = lane >> 3;  // the 8x8 matrix this lane addresses in an ldmatrix.x4
  // B fragments of n8-tile pair nb, k-step ks: rows nb * 16 + (jm / 2) * 8 +
  // lane % 8 of [co][k]; a tap adds tap * COUT rows, whose swizzle is the same
  uint32_t b_addr[kNt / 2][kKs];
#pragma unroll
  for (int nb = 0; nb < kNt / 2; ++nb)
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks)
      b_addr[nb][ks] = 16 * swz<kCh>(nb * 16 + (jm >> 1) * 8 + (lane & 7), 2 * ks + (jm & 1));
  const uint32_t wsa = smem_addr(ws), rwsa = smem_addr(rws);

  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < count) load(first + s, s);
    cp_async_commit();
  }

  // while the first tiles copy: the weights as bf16 [tap][co][k] (Cin = 1:
  // [co][tap], taps 9 .. 15 zero), then the residual's [co][k] (Cin = 1:
  // its one weight at k = 4, the centre tap), and the epilogue's vectors
  if constexpr (CIN == 1) {
    load_f4(a.w, 9 * COUT / 4, [&](int e, const float4& v) {
      const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        ws[8 * swz<kCh>(e % COUT + u, e / COUT / 8) + e / COUT % 8] = __float2bfloat16(f[u]);
    });
    if (a.res_mode == 2)
      for (int co = threadIdx.x; co < COUT; co += kThreads)
        rws[8 * swz<kCh>(co, 0) + 4] = __float2bfloat16(a.resw[co]);
  } else {
    auto put = [&](bf16* dst, int row0, int e, const float4& v) {
      const int ci = e / COUT % CIN, co = e % COUT;
      const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        dst[8 * swz<kCh>(row0 + co + u, ci / 8) + ci % 8] = __float2bfloat16(f[u]);
    };
    load_f4(a.w, 9 * CIN * COUT / 4,
            [&](int e, const float4& v) { put(ws, e / (CIN * COUT) * COUT, e, v); });
    if (a.res_mode == 2)
      load_f4(a.resw, CIN * COUT / 4, [&](int e, const float4& v) { put(rws, 0, e, v); });
  }
  float* vec = reinterpret_cast<float*>(smem + p.v_off);  // scale, bias, rscale, rbias
  for (int i = threadIdx.x; i < COUT; i += kThreads) {
    vec[i] = a.scale[i];
    vec[COUT + i] = a.bias[i];
    vec[2 * COUT + i] = a.res_mode == 2 ? a.rscale[i] : 0.f;
    vec[3 * COUT + i] = a.res_mode == 2 ? a.rbias[i] : 0.f;
  }
  for (int it = 0; it < count; ++it) {
    const int ahead = it + p.stages - 1;
    if (ahead < count) load(first + ahead, ahead % p.stages);
    cp_async_commit();
    if (p.stages == 2)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const int tile = first + it;
    int b, c0;
    origin(tile, b, c0);
    const int rows = POOL ? p.crows : min(p.crows, T - c0);  // conv rows kept
    const int m_tiles = (rows * w + 15) / 16;
    unsigned char* xs = smem + p.x_off + (size_t)(it % p.stages) * p.x_bytes;
    const uint32_t xsa = smem_addr(xs);

    for (int m = 2 * warp; m < m_tiles; m += 2 * kWarps) {
      const int p0 = 16 * m;
      float acc[2][kNt][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < kNt; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
      uint32_t a1[2][4];  // Cin = 1: the gathered A fragments, kept for the residual
      if constexpr (CIN == 1) {
        const unsigned short* xv = reinterpret_cast<const unsigned short*>(xs);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int pa = p0 + 16 * mt + g, pb = pa + 8;
          a1[mt][0] = xv[pa + off0] | (uint32_t)xv[pa + off1] << 16;
          a1[mt][1] = xv[pb + off0] | (uint32_t)xv[pb + off1] << 16;
          a1[mt][2] = t4 == 0 ? xv[pa + 2 * w + 2] : 0u;  // tap 8; 9 .. 15 are zero
          a1[mt][3] = t4 == 0 ? xv[pb + 2 * w + 2] : 0u;
        }
#pragma unroll
        for (int nb = 0; nb < kNt / 2; ++nb) {
          uint32_t bq[4];
          ldmatrix_x4(bq, wsa + b_addr[nb][0]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * nb], a1[mt], bq[0], bq[1]);
            mma_bf16(acc[mt][2 * nb + 1], a1[mt], bq[2], bq[3]);
          }
        }
      } else {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int off = (tap / 3) * w + tap % 3;
#pragma unroll
          for (int ks = 0; ks < kKs; ++ks) {
            uint32_t af[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              ldmatrix_x4(af[mt], xsa + 16 * swz<kChX>(p0 + 16 * mt + off + (jm & 1) * 8 +
                                                           (lane & 7), 2 * ks + (jm >> 1)));
#pragma unroll
            for (int nb = 0; nb < kNt / 2; ++nb) {
              uint32_t bq[4];
              ldmatrix_x4(bq, wsa + tap * COUT * kCh * 16 + b_addr[nb][ks]);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_bf16(acc[mt][2 * nb], af[mt], bq[0], bq[1]);
                mma_bf16(acc[mt][2 * nb + 1], af[mt], bq[2], bq[3]);
              }
            }
          }
        }
      }

      // the 1x1-conv residual: one more GEMM on the centre tap
      float racc[2][kNt][4];
      if (a.res_mode == 2) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int n = 0; n < kNt; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) racc[mt][n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < kKs; ++ks) {
          uint32_t af[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if constexpr (CIN == 1) {
#pragma unroll
              for (int e = 0; e < 4; ++e) af[mt][e] = a1[mt][e];
            } else {
              ldmatrix_x4(af[mt], xsa + 16 * swz<kChX>(p0 + 16 * mt + w + 1 + (jm & 1) * 8 +
                                                           (lane & 7), 2 * ks + (jm >> 1)));
            }
          }
#pragma unroll
          for (int nb = 0; nb < kNt / 2; ++nb) {
            uint32_t bq[4];
            ldmatrix_x4(bq, rwsa + b_addr[nb][ks]);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(racc[mt][2 * nb], af[mt], bq[0], bq[1]);
              mma_bf16(racc[mt][2 * nb + 1], af[mt], bq[2], bq[3]);
            }
          }
        }
      }

      // epilogue: C fragment element e of n8 tile n is pixel g + 8 (e / 2),
      // channel 8 n + 2 t4 + e % 2
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int pm = p0 + 16 * mt;  // the m-tile's first flat pixel, row rb, column jb
        const int rb = pm / w, jb = pm - rb * w;
        unsigned char* ybuf = smem + p.y_off + (POOL ? 0 : warp * 16 * COUT * 2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int r = rb, j = jb + g + 8 * h;  // the lane's pixel
          if constexpr (POOL)
            for (; j >= w; j -= w) ++r;
          // pooled: the tile's conv rows [r][f]; else the warp's 16 pixels
          const int yp = POOL ? r * F + j : g + 8 * h;
          const bool keep = !POOL || (r < p.crows && j < F);
          const int qc = pm + g + 8 * h + w + 1;  // its staged centre pixel
#pragma unroll
          for (int n = 0; n < kNt; ++n) {
            const int c = 8 * n + 2 * t4;
            const float2 sc = *reinterpret_cast<const float2*>(vec + c);
            const float2 bi = *reinterpret_cast<const float2*>(vec + COUT + c);
            float v0 = fmaf(acc[mt][n][2 * h], sc.x, bi.x);
            float v1 = fmaf(acc[mt][n][2 * h + 1], sc.y, bi.y);
            if (a.relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            if constexpr (CIN == COUT) {
              if (a.res_mode == 1) {  // chunk n of the centre pixel
                const __nv_bfloat162 xc = *reinterpret_cast<const __nv_bfloat162*>(
                    xs + 16 * swz<kChX>(qc, n) + 4 * t4);
                v0 += __bfloat162float(xc.x);
                v1 += __bfloat162float(xc.y);
              }
            }
            if (a.res_mode == 2) {
              const float2 rs = *reinterpret_cast<const float2*>(vec + 2 * COUT + c);
              const float2 rbias = *reinterpret_cast<const float2*>(vec + 3 * COUT + c);
              v0 += fmaf(racc[mt][n][2 * h], rs.x, rbias.x);
              v1 += fmaf(racc[mt][n][2 * h + 1], rs.y, rbias.y);
            }
            if (keep)
              *reinterpret_cast<__nv_bfloat162*>(ybuf + 16 * swz<kNt>(yp, n) + 4 * t4) =
                  __floats2bfloat162_rn(v0, v1);
          }
        }
        if constexpr (!POOL) {
          // the warp's 16 pixels, 16 bytes a lane, to the output rows
          __syncwarp();
#pragma unroll
          for (int u = lane; u < 16 * kNt; u += 32) {
            int r = rb, j = jb + u / kNt;
            for (; j >= w; j -= w) ++r;
            if (r < rows && j < F)
              *reinterpret_cast<uint4*>(a.out + (((size_t)b * T + c0 + r) * F + j) * COUT +
                                        8 * (u % kNt)) =
                  *reinterpret_cast<const uint4*>(ybuf + 16 * swz<kNt>(u / kNt, u % kNt));
          }
          __syncwarp();
        }
      }
    }

    if constexpr (POOL) {
      // pool the staged conv rows, rows outside the clip -inf: first over
      // time, each thread down its own (column, chunk), pooled row tr
      // over conv row tr (<= tr st, whose own window it no longer reads),
      // then over freq from those rows
      __syncthreads();
      const int to0 = (tile % p.tiles_per_clip) * p.n_to;
      const int n_to = min(p.n_to, pl.to - to0);
      unsigned char* ybuf = smem + p.y_off;
      const __nv_bfloat162 ninf = __floats2bfloat162_rn(-CUDART_INF_F, -CUDART_INF_F);
      auto unit = [&](int r, int f, int c) {
        return reinterpret_cast<uint4*>(ybuf + 16 * swz<kNt>(r * F + f, c));
      };
      auto vmax = [](__nv_bfloat162 (&mx)[4], const uint4& v) {
        const __nv_bfloat162* vv = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e] = __hmax2(mx[e], vv[e]);
      };
      for (int i = threadIdx.x; i < F * kNt; i += kThreads) {
        const int c = i % kNt, f = i / kNt;
        for (int tr = 0; tr < n_to; ++tr) {
          __nv_bfloat162 mx[4] = {ninf, ninf, ninf, ninf};
          for (int dt = 0; dt < pl.wt; ++dt) {
            const int r = tr * pl.st + dt;
            if (c0 + r >= 0 && c0 + r < T) vmax(mx, *unit(r, f, c));
          }
          *unit(tr, f, c) = *reinterpret_cast<const uint4*>(mx);
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < n_to * pl.fo * kNt; i += kThreads) {
        const int c = i % kNt, fo = (i / kNt) % pl.fo, tr = i / (kNt * pl.fo);
        __nv_bfloat162 mx[4] = {ninf, ninf, ninf, ninf};
        for (int df = 0; df < pl.wf; ++df) {
          const int f = fo * pl.sf - pl.pf + df;
          if (f >= 0 && f < F) vmax(mx, *unit(tr, f, c));
        }
        *reinterpret_cast<uint4*>(a.out + (((size_t)b * pl.to + to0 + tr) * pl.fo + fo) * COUT +
                                  8 * c) = *reinterpret_cast<const uint4*>(mx);
      }
    }
    __syncthreads();  // the stage (and the pooled block's conv rows) consumed
  }
  cp_async_wait<0>();
}

template <int CIN, int COUT, bool POOL>
cudaError_t launch(const Args& a, int B, const Pool& pl, cudaStream_t s) {
  const Plan p = plan<CIN, COUT>(B, a.T, a.F, POOL, a.res_mode == 2, pl);
  if (p.smem < 0) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      conv_block_kernel<CIN, COUT, POOL>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  conv_block_kernel<CIN, COUT, POOL><<<p.nblocks, kThreads, p.smem, s>>>(a, p, pl);
  return cudaGetLastError();
}

// fn(Cin, Cout, pool) with each as a compile-time constant.
template <class Fn>
cudaError_t dispatch(int cin, int cout, bool pool, Fn&& fn) {
  using std::integral_constant;
  auto by_pool = [&](auto ci, auto co) {
    return pool ? fn(ci, co, std::true_type{}) : fn(ci, co, std::false_type{});
  };
  auto by_cout = [&](auto ci) {
    return cout == 16 ? by_pool(ci, integral_constant<int, 16>{})
                      : by_pool(ci, integral_constant<int, 32>{});
  };
  return cin == 1    ? by_cout(integral_constant<int, 1>{})
         : cin == 16 ? by_cout(integral_constant<int, 16>{})
                     : by_cout(integral_constant<int, 32>{});
}

bool supported(int B, int T, int F, int cin, int cout, int res_mode) {
  return B >= 1 && T >= 2 && F >= 2 && (cin == 1 || cin == 16 || cin == 32) &&
         (cout == 16 || cout == 32) && res_mode >= 0 && res_mode <= 2 &&
         (res_mode != 1 || cin == cout);
}

// ---- float32 mode -----------------------------------------------------------
//
// The same block on float32 operands with float32 products, the JAX
// kernel's mxu_dtype=float32 (pallas_conv.py:198, conv_train.py:31-33):
// float32 x in, float32 out, the weights unrounded.  Float32 MMAs on the
// tensor cores would be TF32, so the products are FFMAs on the CUDA cores,
// and operations bound it: the serving call's 37 GFLOP take 0.55 ms at the
// card's 67 TFLOP/s against 0.2 ms for its (now float32) bytes.
//
// Design: register-tiled FFMA.  A tile is `crows` conv rows of one clip,
// staged as in the bf16 mode (F + 2 pixels a row, the reflected or zero
// halo by index and cp.async's zero fill, XOR-swizzled 16-byte chunks of 4
// channels, so that the 32 consecutive pixels a warp reads hit distinct
// bank groups), in a ring of 1 or 2 stages; the weights [tap][Cin][Cout]
// and the epilogue's vectors are staged once a block.  A thread owns kPR
// conv rows x kCO output channels at one column, the warp's lanes on 32
// consecutive columns of the same channels: for each chunk of 4 input
// channels and each column tap it loads the kPR + 2 staged pixels of its
// column (the three row taps share them), then for each channel and row
// tap two float4s of weights (one address across the warp: a broadcast)
// and kPR x kCO FFMAs.  The epilogue is the bf16 mode's in registers (the
// 1x1 residual a row at a time); the output leaves as float4s, or on a
// pooled block goes to shared memory and is pooled over time in place,
// then over freq, -inf outside the clip.  Fixed summation order: a repeat
// is bit-identical.
namespace f32 {

constexpr int kPR = 4;  // conv rows a thread
constexpr int kCO = 8;  // output channels a thread

struct Plan {
  int crows;           // conv rows a tile computes
  int step, front;     // conv rows between two tiles; tile 0 starts at conv row -front
  int n_to;            // pooled rows a tile writes (pooled blocks)
  int xrows;           // staged input rows: crows in whole kPR, and the row halo
  int x_bytes;         // a ring stage
  int w_off, v_off, y_off, x_off;  // byte offsets: weights (+ residual), vectors, conv rows, ring
  int stages, smem;    // ring depth, dynamic shared memory; smem < 0: does not fit
  int tiles_per_clip, ntiles, nblocks, per_sm;
};

template <int CIN, int COUT>
Plan make_plan(int rows, int stages, int B, int T, int F, bool pool, bool res2, const Pool& pl) {
  Plan p;
  if (pool) {
    p.n_to = rows;
    p.crows = (rows - 1) * pl.st + pl.wt;
    p.step = rows * pl.st;
    p.front = pl.pt;
    p.tiles_per_clip = ceil_div(pl.to, rows);
  } else {
    p.n_to = 0;
    p.crows = p.step = rows;
    p.front = 0;
    p.tiles_per_clip = ceil_div(T, rows);
  }
  p.xrows = round_up(p.crows, kPR) + 2;
  p.x_bytes = round_up(p.xrows * (F + 2) * CIN * 4, 128);
  p.w_off = 0;
  p.v_off = round_up((9 + (res2 ? 1 : 0)) * CIN * COUT * 4, 128);
  p.y_off = p.v_off + 4 * COUT * 4;
  p.x_off = round_up(p.y_off + (pool ? p.crows * F * COUT * 4 : 0), 128);
  p.stages = stages;
  p.smem = p.x_off + stages * p.x_bytes;
  p.ntiles = B * p.tiles_per_clip;
  return p;
}

// The plan of least estimated time, as the bf16 mode's `plan` weighs it,
// with a tile's operations at the card's float32 rate: its threads' passes
// over the tile's (row group, column, channel group) items.
template <int CIN, int COUT>
Plan plan(int B, int T, int F, bool pool, bool res2, const Pool& pl) {
  constexpr double kBytesPerNs = 3.35e12 / 132 / 1e9, kFlopsPerNs = 67e12 / 132 / 1e9;
  constexpr double kTileNs = 300;
  Plan best;
  best.smem = -1;
  double best_ns = 0;
  const int w = F + 2;
  const int max_rows = pool ? std::min(kMaxRows, pl.to) : std::min(kMaxRows, round_up(T, kPR));
  const int row_step = pool ? 1 : kPR;
  for (int per_sm = 2; per_sm >= 1 && best.smem < 0; --per_sm)
    for (int stages = 2; stages >= 1; --stages)
      for (int rows = row_step; rows <= max_rows; rows += row_step) {
        Plan p = f32::make_plan<CIN, COUT>(rows, stages, B, T, F, pool, res2, pl);
        if (p.smem > (per_sm == 2 ? kTwoBlockSmem : kMaxSmem)) break;
        p.nblocks = std::min(p.ntiles, per_sm * sm_count());
        p.per_sm = per_sm;
        const int items = (p.xrows - 2) / kPR * F * (COUT / kCO);
        const double out_px = pool ? (double)rows * pl.fo : (double)rows * F;
        const double bytes = (double)p.xrows * w * CIN * 4 + out_px * COUT * 4;
        const double flops = (double)ceil_div(items, kThreads) * kThreads * kPR * kCO * 2 * 9 * CIN;
        const double l = bytes / kBytesPerNs, c = flops / kFlopsPerNs;
        const double tiles = (double)ceil_div(p.ntiles, p.nblocks) * per_sm;
        const double ns = (per_sm == 2 || stages == 2 ? tiles * fmax(l, c) + fmin(l, c)
                                                      : tiles * (l + c)) +
                          tiles * kTileNs / per_sm;
        if (best.smem < 0 || ns < best_ns) {
          best = p;
          best_ns = ns;
        }
      }
  return best;
}

struct Args {
  const float* x;
  const float *w, *scale, *bias, *resw, *rscale, *rbias;
  float* out;
  int T, F, res_mode, relu, zero_edge;
};

__device__ __forceinline__ float4 max4(const float4& a, const float4& b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
}

template <int CIN, int COUT, bool POOL>
__global__ void __launch_bounds__(kThreads, 2)
conv_block_kernel(const Args a, const Plan p, const Pool pl) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kCI = CIN == 1 ? 1 : 4;  // input channels a staged load
  constexpr int kChX = CIN / 4;          // 16-byte chunks of a staged pixel (Cin >= 16)
  constexpr int kChY = COUT / 4;         // ... of a conv output pixel
  constexpr int kNcg = COUT / kCO;       // channel groups
  const int T = a.T, F = a.F, w = F + 2;

  float* ws = reinterpret_cast<float*>(smem + p.w_off);  // [tap][ci][co]
  const float* rws = ws + 9 * CIN * COUT;                // [ci][co]
  float* vec = reinterpret_cast<float*>(smem + p.v_off);  // scale, bias, rscale, rbias

  const int first = (int)((long long)blockIdx.x * p.ntiles / gridDim.x);
  const int count = (int)((long long)(blockIdx.x + 1) * p.ntiles / gridDim.x) - first;

  auto origin = [&](int tile, int& b, int& c0) {
    b = tile / p.tiles_per_clip;
    c0 = (tile % p.tiles_per_clip) * p.step - p.front;
  };
  auto in_row = [&](int i, bool& valid) {
    valid = (i >= 0 && i < T) || ((i == -1 || i == T) && !a.zero_edge);
    return valid ? reflect(i, T) : 0;
  };
  auto load = [&](int tile, int s) {
    int b, c0;
    origin(tile, b, c0);
    unsigned char* xs = smem + p.x_off + (size_t)s * p.x_bytes;
    const float* xb = a.x + (size_t)b * T * F * CIN;
    const int n = p.xrows * w;
    if constexpr (CIN == 1) {  // 4-byte pixels: plain loads, eight in flight a thread
      float* xv = reinterpret_cast<float*>(xs);
      for (int i0 = threadIdx.x; i0 < n; i0 += 8 * kThreads) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u * kThreads, r = i / w, j = i - r * w;
          bool rv;
          const int t = in_row(c0 - 1 + r, rv);
          const bool valid = i < n && rv && ((j >= 1 && j <= F) || !a.zero_edge);
          v[u] = valid ? xb[(size_t)t * F + reflect(j - 1, F)] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (i0 + u * kThreads < n) xv[i0 + u * kThreads] = v[u];
      }
    } else {
      // thread i copies chunk i % kChX of pixels i / kChX + k kThreads / kChX
      constexpr int kStep = kThreads / kChX;
      const int c = threadIdx.x % kChX;
      int px = threadIdx.x / kChX, r = px / w, j = px - r * w;
      for (; px < n; px += kStep) {
        bool rv;
        const int t = in_row(c0 - 1 + r, rv);
        const bool valid = rv && ((j >= 1 && j <= F) || !a.zero_edge);
        cp_async16(xs + 16 * swz<kChX>(px, c),
                   valid ? xb + ((size_t)t * F + reflect(j - 1, F)) * CIN + c * 4 : a.x, valid);
        for (j += kStep; j >= w; j -= w) ++r;
      }
    }
  };
  // a staged pixel's channels ci0 .. ci0 + kCI - 1
  auto pixel = [&](const unsigned char* xs, int px, int ci0, float (&v)[kCI]) {
    if constexpr (CIN == 1) {
      v[0] = reinterpret_cast<const float*>(xs)[px];
    } else {
      const float4 q = *reinterpret_cast<const float4*>(xs + 16 * swz<kChX>(px, ci0 / 4));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    }
  };

  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < count) load(first + s, s);
    cp_async_commit();
  }
  // while the first tiles copy: the weights as they are in device memory
  // ([tap][ci][co], then the residual's [ci][co]) and the epilogue's vectors
  const int n_w4 = (9 + (a.res_mode == 2 ? 1 : 0)) * CIN * COUT / 4;
  for (int i = threadIdx.x; i < n_w4; i += kThreads)
    reinterpret_cast<float4*>(ws)[i] =
        i < 9 * CIN * COUT / 4 ? reinterpret_cast<const float4*>(a.w)[i]
                               : reinterpret_cast<const float4*>(a.resw)[i - 9 * CIN * COUT / 4];
  for (int i = threadIdx.x; i < COUT; i += kThreads) {
    vec[i] = a.scale[i];
    vec[COUT + i] = a.bias[i];
    vec[2 * COUT + i] = a.res_mode == 2 ? a.rscale[i] : 0.f;
    vec[3 * COUT + i] = a.res_mode == 2 ? a.rbias[i] : 0.f;
  }
  const int items = (p.xrows - 2) / kPR * F * kNcg;
  for (int it = 0; it < count; ++it) {
    const int ahead = it + p.stages - 1;
    if (ahead < count) load(first + ahead, ahead % p.stages);
    cp_async_commit();
    if (p.stages == 2)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const int tile = first + it;
    int b, c0;
    origin(tile, b, c0);
    const int rows = POOL ? p.crows : min(p.crows, T - c0);  // conv rows kept
    const unsigned char* xs = smem + p.x_off + (size_t)(it % p.stages) * p.x_bytes;

    for (int item = threadIdx.x; item < items; item += kThreads) {
      const int col = item % F, rest = item / F;
      const int co0 = rest % kNcg * kCO, r0 = rest / kNcg * kPR;
      if (r0 >= rows) continue;
      float acc[kPR][kCO];
#pragma unroll
      for (int i = 0; i < kPR; ++i)
#pragma unroll
        for (int c = 0; c < kCO; ++c) acc[i][c] = 0.f;
#pragma unroll 1
      for (int ci0 = 0; ci0 < CIN; ci0 += kCI) {
#pragma unroll
        for (int df = 0; df < 3; ++df) {
          float xv[kPR + 2][kCI];  // staged rows r0 .. r0 + kPR + 1 at column col + df
#pragma unroll
          for (int s = 0; s < kPR + 2; ++s) pixel(xs, (r0 + s) * w + col + df, ci0, xv[s]);
#pragma unroll
          for (int k = 0; k < kCI; ++k)
#pragma unroll
            for (int dt = 0; dt < 3; ++dt) {
              const float* wr = ws + ((dt * 3 + df) * CIN + ci0 + k) * COUT + co0;
              const float4 w0 = *reinterpret_cast<const float4*>(wr);
              const float4 w1 = *reinterpret_cast<const float4*>(wr + 4);
              const float wv[kCO] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
              for (int i = 0; i < kPR; ++i)
#pragma unroll
                for (int c = 0; c < kCO; ++c) acc[i][c] = fmaf(xv[i + dt][k], wv[c], acc[i][c]);
            }
        }
      }

      // epilogue: affine, ReLU, residual, a row at a time
#pragma unroll
      for (int i = 0; i < kPR; ++i) {
        const int r = r0 + i;
        if (r >= rows) break;
        const int qc = (r + 1) * w + col + 1;  // its staged centre pixel
        float v[kCO];
#pragma unroll
        for (int c = 0; c < kCO; ++c) {
          v[c] = fmaf(acc[i][c], vec[co0 + c], vec[COUT + co0 + c]);
          if (a.relu) v[c] = fmaxf(v[c], 0.f);
        }
        if constexpr (CIN == COUT) {
          if (a.res_mode == 1) {
            float xc[2][4];
            pixel(xs, qc, co0, xc[0]);
            pixel(xs, qc, co0 + 4, xc[1]);
#pragma unroll
            for (int c = 0; c < kCO; ++c) v[c] += xc[c / 4][c % 4];
          }
        }
        if (a.res_mode == 2) {  // the 1x1-conv residual on the centre pixel
          float racc[kCO];
#pragma unroll
          for (int c = 0; c < kCO; ++c) racc[c] = 0.f;
#pragma unroll 4
          for (int ci0 = 0; ci0 < CIN; ci0 += kCI) {
            float xc[kCI];
            pixel(xs, qc, ci0, xc);
#pragma unroll
            for (int k = 0; k < kCI; ++k)
#pragma unroll
              for (int c = 0; c < kCO; ++c)
                racc[c] = fmaf(xc[k], rws[(ci0 + k) * COUT + co0 + c], racc[c]);
          }
#pragma unroll
          for (int c = 0; c < kCO; ++c)
            v[c] += fmaf(racc[c], vec[2 * COUT + co0 + c], vec[3 * COUT + co0 + c]);
        }
        const float4 v0 = make_float4(v[0], v[1], v[2], v[3]);
        const float4 v1 = make_float4(v[4], v[5], v[6], v[7]);
        if constexpr (POOL) {  // the tile's conv rows [r][f]
          float4* yb = reinterpret_cast<float4*>(smem + p.y_off);
          yb[swz<kChY>(r * F + col, co0 / 4)] = v0;
          yb[swz<kChY>(r * F + col, co0 / 4 + 1)] = v1;
        } else {
          float4* o = reinterpret_cast<float4*>(
              a.out + (((size_t)b * T + c0 + r) * F + col) * COUT + co0);
          o[0] = v0;
          o[1] = v1;
        }
      }
    }

    if constexpr (POOL) {
      // as the bf16 mode: over time in place, a thread down each (column,
      // chunk), then over freq from those rows; conv rows outside the clip
      // are -inf
      __syncthreads();
      const int to0 = (tile % p.tiles_per_clip) * p.n_to;
      const int n_to = min(p.n_to, pl.to - to0);
      float4* yb = reinterpret_cast<float4*>(smem + p.y_off);
      const float4 ninf = make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F);
      for (int i = threadIdx.x; i < F * kChY; i += kThreads) {
        const int c = i % kChY, f = i / kChY;
        for (int tr = 0; tr < n_to; ++tr) {
          float4 mx = ninf;
          for (int dt = 0; dt < pl.wt; ++dt) {
            const int r = tr * pl.st + dt;
            if (c0 + r >= 0 && c0 + r < T) mx = max4(mx, yb[swz<kChY>(r * F + f, c)]);
          }
          yb[swz<kChY>(tr * F + f, c)] = mx;
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < n_to * pl.fo * kChY; i += kThreads) {
        const int c = i % kChY, fo = (i / kChY) % pl.fo, tr = i / (kChY * pl.fo);
        float4 mx = ninf;
        for (int df = 0; df < pl.wf; ++df) {
          const int f = fo * pl.sf - pl.pf + df;
          if (f >= 0 && f < F) mx = max4(mx, yb[swz<kChY>(tr * F + f, c)]);
        }
        *reinterpret_cast<float4*>(a.out + (((size_t)b * pl.to + to0 + tr) * pl.fo + fo) * COUT +
                                   4 * c) = mx;
      }
    }
    __syncthreads();  // the stage (and the pooled block's conv rows) consumed
  }
  cp_async_wait<0>();
}

template <int CIN, int COUT, bool POOL>
cudaError_t launch(const Args& a, int B, const Pool& pl, cudaStream_t s) {
  const Plan p = f32::plan<CIN, COUT>(B, a.T, a.F, POOL, a.res_mode == 2, pl);
  if (p.smem < 0) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      conv_block_kernel<CIN, COUT, POOL>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  conv_block_kernel<CIN, COUT, POOL><<<p.nblocks, kThreads, p.smem, s>>>(a, p, pl);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

// One block: out is (B, T, F, Cout), or with a pool (wt > 0) the pooled
// (B, To, Fo, Cout).  Returns cudaErrorInvalidValue for a shape the kernel
// does not take (Cin not 1, 16 or 32, Cout not 16 or 32, T or F below 2,
// an identity residual with Cin != Cout, a row too wide for shared memory).
CT_EXPORT int conv_block_forward(const void* x, const void* w, const void* scale,
                                 const void* bias, const void* resw, const void* rscale,
                                 const void* rbias, void* out, int B, int T, int F, int cin,
                                 int cout, int res_mode, int relu, int zero_edge, int wt, int wf,
                                 int st, int sf, int pt, int pf, int To, int Fo, void* stream) {
  if (!supported(B, T, F, cin, cout, res_mode)) return (int)cudaErrorInvalidValue;
  // 16-byte copies, loads and stores: x's pixels at Cin >= 16, the weights, out
  if (((cin > 1 ? reinterpret_cast<uintptr_t>(x) : 0) | reinterpret_cast<uintptr_t>(w) |
       (res_mode == 2 && cin > 1 ? reinterpret_cast<uintptr_t>(resw) : 0) |
       reinterpret_cast<uintptr_t>(out)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const Args a{static_cast<const bf16*>(x), static_cast<const float*>(w),
               static_cast<const float*>(scale), static_cast<const float*>(bias),
               static_cast<const float*>(resw), static_cast<const float*>(rscale),
               static_cast<const float*>(rbias), static_cast<bf16*>(out), T, F, res_mode,
               relu, zero_edge};
  const Pool pl{wt, wf, st, sf, pt, pf, To, Fo};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch(cin, cout, wt > 0, [&](auto ci, auto co, auto po) {
    return launch<decltype(ci)::value, decltype(co)::value, decltype(po)::value>(a, B, pl, s);
  });
}

// The plan conv_block_forward launches for a shape, for reports: out[0..6]
// = conv rows a tile, pooled rows a tile (0 without a pool), ring stages,
// blocks an SM, blocks, tiles, dynamic shared memory bytes.  Returns 0, or
// cudaErrorInvalidValue where conv_block_forward would.
CT_EXPORT int conv_block_plan(int B, int T, int F, int cin, int cout, int res_mode, int wt,
                              int wf, int st, int sf, int pt, int pf, int To, int Fo,
                              int* out) {
  if (!supported(B, T, F, cin, cout, res_mode)) return (int)cudaErrorInvalidValue;
  const Pool pl{wt, wf, st, sf, pt, pf, To, Fo};
  return (int)dispatch(cin, cout, wt > 0, [&](auto ci, auto co, auto po) {
    const Plan p = plan<decltype(ci)::value, decltype(co)::value>(B, T, F, po, res_mode == 2, pl);
    const int v[7] = {p.crows, p.n_to, p.stages, p.per_sm, p.nblocks, p.ntiles, p.smem};
    std::copy(v, v + 7, out);
    return p.smem < 0 ? cudaErrorInvalidValue : cudaSuccess;
  });
}

// The float32 mode of conv_block_forward: x, w, resw and out float32, the
// same arguments and refusals (f32::conv_block_kernel).
CT_EXPORT int conv_block_forward_f32(const void* x, const void* w, const void* scale,
                                     const void* bias, const void* resw, const void* rscale,
                                     const void* rbias, void* out, int B, int T, int F, int cin,
                                     int cout, int res_mode, int relu, int zero_edge, int wt,
                                     int wf, int st, int sf, int pt, int pf, int To, int Fo,
                                     void* stream) {
  if (!supported(B, T, F, cin, cout, res_mode)) return (int)cudaErrorInvalidValue;
  // 16-byte copies, loads and stores: x's pixels at Cin >= 16, the weights, out
  if (((cin > 1 ? reinterpret_cast<uintptr_t>(x) : 0) | reinterpret_cast<uintptr_t>(w) |
       (res_mode == 2 ? reinterpret_cast<uintptr_t>(resw) : 0) |
       reinterpret_cast<uintptr_t>(out)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const f32::Args a{static_cast<const float*>(x), static_cast<const float*>(w),
                    static_cast<const float*>(scale), static_cast<const float*>(bias),
                    static_cast<const float*>(resw), static_cast<const float*>(rscale),
                    static_cast<const float*>(rbias), static_cast<float*>(out), T, F, res_mode,
                    relu, zero_edge};
  const Pool pl{wt, wf, st, sf, pt, pf, To, Fo};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch(cin, cout, wt > 0, [&](auto ci, auto co, auto po) {
    return f32::launch<decltype(ci)::value, decltype(co)::value, decltype(po)::value>(a, B, pl,
                                                                                     s);
  });
}

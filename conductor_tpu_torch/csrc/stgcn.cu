// K7: the frozen ST-GCN of the perceptual loss, forward and d(input)
// backward.
//
// Replaces conductor_tpu/ops/pallas_stgcn.py::fused_frozen_stgcn (forward
// `_stgcn_fwd_kernel`, pallas_call at :252; backward `_stgcn_bwd_kernel`,
// pallas_call at :280).  Weights as ops/stgcn.py::pack_frozen_stgcn packs
// them (bf16 matrices, float32 biases); activations are rows of one frame,
// 13 joints x 32 channels = 416 values, joint-major.  Per block i:
//   g = relu(bf16(h) M_i + b1_i)                           (graph conv + BN)
//   h' = relu(sum_k bf16(g[t + k - 1]) W_ik + b2_i (+ h))   (3-tap conv + BN,
//        per joint, zero rows past the clip's edges; residual after block 0)
// then out = bf16(h_10) FC + fcb.  The backward walks the blocks in reverse:
//   dy = dh' * [h' > 0];  da = (sum_k bf16(dy[t + 1 - k]) W_ik^T) * [g > 0];
//   dh = bf16(da) M_i^T (+ dy after block 0);  dx = bf16(da_0) M_0^T.
// The roundings are the JAX kernel's `_md`: bf16 operands, float32
// accumulation, float32 bias / ReLU / residual.  The clip's edges are the
// module's zero padding: the JAX kernel, which pads T to a multiple of 8,
// lets its pad rows' relu(b1) into the last frame; here no pad row exists.
//
// What bounds it on an H100.  Per frame the forward is ~4 MFLOP (nine dense
// 416 x 416 graph-conv products, 0.35 MFLOP each, ten temporal convs, 0.08
// each), the backward about the same: at B = 32, T = 900 ~115 GFLOP each
// way, 0.12 ms at the bf16 tensor rate.  Between launches a frame is 416
// float32 values, read once and written once a block: ~96 MB a block at
// that batch, ~0.29 ms a direction at 3.35 TB/s.  On mma.sync, whose
// fragments pass through shared memory, neither rate is near: what a block
// spends is split in scripts/k7_variants.py.
//
// Design: one launch a st_gcn block and direction.  A thread block has 13
// warps, one a joint, and takes an SM (13 warps put 4 on one SM
// sub-partition: 128 registers a thread).  Forward: a block owns 62 frames
// of one clip and reads h_{i-1} once from device memory on the 64 rows
// t0 - 1 .. t0 + 62: into a bf16 operand tile (zero outside the clip) and,
// for the owned rows, a float32 residual tile, both in shared memory.  Warp
// v computes joint v's 32 graph-conv columns on the 64 rows with mma.sync
// m16n8k16: A by ldmatrix from the operand tile, and the joint's 32-column
// slab of M_i streamed from L2 through the warp's own cp.async ring of
// 32 x 32 sub-tiles, so no fragment comes from global memory and each
// block reads M_i once.  It writes g (zero outside the clip) as bf16 into
// its own g tile, which reuses the ring's space, and runs the joint's
// temporal conv from it (the conv mixes no joints: no block barrier), the
// accumulator starting at b2 plus the residual.  Block 9's launch keeps
// h_10 in the residual tile, turns it into the operand tile and projects
// it with FC, so h_10 never reaches device memory.  With `save` the
// forward writes the ReLU masks [g > 0] and [h' > 0] of its owned rows as
// bits, one 32-bit word a joint (13 a row), gathered from the accumulator's
// layout across the 4 lanes that hold a row; the backward reads only those
// (30 MB a call at B = 32, T = 900, in place of 0.72 GB of saved
// activations).  Backward: a block owns 80 frames.  Warp v gates joint v's
// dh rows t0 - 1 .. t0 + 80 by [h' > 0] into a bf16 dy tile in its ring's
// space (block 9 first computes them, bf16(dy_out) FC^T, in the same
// launch, and keeps dy_9 of its owned rows in the dh buffer for the
// residual), runs the transposed temporal conv and gates it by [g > 0]
// into the block's bf16 da tile; after one barrier it computes joint v's
// columns of bf16(da) M_i^T (M_i's rows 32 v .. 32 v + 31, streamed as
// above), the accumulator starting at the gated residual.  Epilogues load
// what they need before their products, so that no load waits behind a
// store.  Every sum runs in a fixed order: a repeat gives the same bits.
// No wgmma / TMA.

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int V = 13, C = 32, W = V * C;  // joints, channels, values a frame
constexpr int kBlocks = 10, kOut = 64, kIn = V * 2, kInPad = 32;
constexpr int kWarps = V, kThreads = 32 * kWarps;  // a warp a joint (ops/stgcn.py WARPS)
constexpr int kLdA = W + 8;     // bf16 row stride of the 416-wide tiles (848 B)
constexpr int kLdR = W + 8;     // float32 row stride of the forward's residual tile
constexpr int kSub = 32 * 32;   // bf16 of a 32 x 32 sub-tile (2 KB)
// forward: a block owns 62 frames, its products run on 64 rows (a row of
// halo each side); a 2-stage ring.  ops/stgcn.py::plan reads kFTile,
// kFDepth, kBTile and kBDepth from here.
constexpr int kFTile = 64, kFMT = kFTile / 16, kFwdRows = kFTile - 2, kFDepth = 2;
// backward: a block owns 80 frames, its dy tiles hold 82 rows; a 3-stage
// ring
constexpr int kBTile = 80, kBMT = kBTile / 16, kBwdRows = kBTile, kBDepth = 3;
constexpr int kDyMT = (kBTile + 2 + 15) / 16;  // block 9's dy_out tile: m16 fragments over 82 rows
constexpr int kDyRows = 16 * kDyMT, kLdDy = kOut + 8;
// a warp's region (bf16): its ring, or its g / dy tile of T + 2 rows
constexpr int kFRegion = kFDepth * kSub > (kFTile + 2) * C ? kFDepth * kSub : (kFTile + 2) * C;
constexpr int kBRegion = kBDepth * kSub > (kBTile + 2) * C ? kBDepth * kSub : (kBTile + 2) * C;

// shared memory, bytes.  Forward: the operand tile, the owned rows' float32
// residual, the taps, the regions.  Backward: the da tile, the taps, the
// regions (block 9: and the dy_out tile).
constexpr int kFResOff = kFTile * kLdA * 2, kFTapOff = kFResOff + kFwdRows * kLdR * 4;
constexpr int kFRegionOff = kFTapOff + 3 * kSub * 2;
constexpr size_t kFwdSmem = kFRegionOff + kWarps * kFRegion * 2;
constexpr int kBTapOff = kBTile * kLdA * 2, kBRegionOff = kBTapOff + 3 * kSub * 2;
constexpr size_t kBwdSmem = kBRegionOff + kWarps * kBRegion * 2;
constexpr size_t kBwdSmemFirst = kBwdSmem + kDyRows * kLdDy * 2;

// Byte offset of 16-byte chunk c (< 4) of row r of a 32-wide bf16 sub-tile:
// 64-byte rows, the chunk XORed with (r / 2) % 4, so that 8 consecutive
// rows at one chunk fall on 8 distinct bank groups.
__device__ __forceinline__ uint32_t sub(int r, int c) {
  return (uint32_t)(r * 64 + ((c ^ ((r >> 1) & 3)) << 4));
}

// Eight consecutive values (16-byte aligned) as float, and back as bf16.
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store_bf2(unsigned char* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// acc (16 x 32: four 16 x 8 fragments) += a (16 x 16) . [lo | hi] (16 x 32).
__device__ __forceinline__ void mma4(float (&acc)[4][4], const uint32_t (&a)[4],
                                     const uint32_t (&lo)[4], const uint32_t (&hi)[4]) {
  tc::mma_bf16(acc[0], a, lo[0], lo[1]);
  tc::mma_bf16(acc[1], a, lo[2], lo[3]);
  tc::mma_bf16(acc[2], a, hi[0], hi[1]);
  tc::mma_bf16(acc[3], a, hi[2], hi[3]);
}

// acc[m] (16 x 32) += A (rows 16 m .. 16 m + 15 at a_addr, row stride lda
// bf16, K columns; shared) @ a K x 32 slab of B, streamed from global
// memory through the warp's DEPTH-stage cp.async ring at `ring`, 32 k a
// stage.  kTransB: the slab is given as 32 rows of B^T (K values each at b,
// row stride ldb), else as K rows of B (32 values each).  K a multiple of
// 32; the slab's rows 16-byte aligned.
template <int MT, bool kTransB, int DEPTH>
__device__ __forceinline__ void warp_gemm(uint32_t a_addr, int lda, const bf16* b, int ldb, int K,
                                          uint32_t ring, float (&acc)[MT][4][4]) {
  const int lane = threadIdx.x & 31, n_st = K / 32;
  auto issue = [&](int s) {  // stage s into slot s % DEPTH (an empty group past the end)
    if (s < n_st) {
      const bf16* src = kTransB ? b + 32 * s : b + (size_t)32 * s * ldb;
      const uint32_t dst = ring + (uint32_t)(s % DEPTH) * (kSub * 2);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 8 * q + (lane >> 2), c = lane & 3;
        tc::cp_async16(dst + sub(r, c), src + (size_t)r * ldb + 8 * c);
      }
    }
    tc::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < DEPTH - 1; ++s) issue(s);
  for (int s = 0; s < n_st; ++s) {
    issue(s + DEPTH - 1);
    tc::cp_async_wait<DEPTH - 1>();
    __syncwarp();
    const uint32_t st = ring + (uint32_t)(s % DEPTH) * (kSub * 2);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t lo[4], hi[4];  // b0, b1 of the n8 fragments 0, 1 (lo) and 2, 3 (hi)
      if (kTransB) {
        const int r = ((lane >> 4) << 3) + (lane & 7), c = 2 * ks + ((lane >> 3) & 1);
        tc::ldmatrix_x4(lo, st + sub(r, c));
        tc::ldmatrix_x4(hi, st + sub(16 + r, c));
      } else {
        const int r = 16 * ks + (lane & 15);
        tc::ldmatrix_x4_trans(lo, st + sub(r, lane >> 4));
        tc::ldmatrix_x4_trans(hi, st + sub(r, 2 + (lane >> 4)));
      }
      const int k = 32 * s + 16 * ks;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t a[4];
        tc::ldmatrix_x4(a, a_addr + (uint32_t)(((16 * m + (lane & 15)) * lda + k + (lane >> 4) * 8) * 2));
        mma4(acc[m], a, lo, hi);
      }
    }
    __syncwarp();  // every lane is done with the slot before it is refilled
  }
}

// The block's taps (3, 32, 32), (tap, in, out), into 3 sub-tiles (rows: in
// channels) by cp.async; the caller commits.
__device__ __forceinline__ void stage_taps(uint32_t taps, const bf16* wt) {
  for (int i = threadIdx.x; i < 3 * 128; i += kThreads) {
    const int tap = i >> 7, r = (i >> 2) & 31, c = i & 3;
    tc::cp_async16(taps + tap * kSub * 2 + sub(r, c), wt + tap * kSub + r * C + 8 * c);
  }
}

// acc[m] (16 x 32) += the temporal conv of the warp's 32-wide sub-tile
// layout tile at `tile` against the taps: output row 16 m + r reads tile row
// 16 m + r + k with W_k (forward) or 16 m + r + 2 - k with W_k^T (backward).
template <bool kBwd, int MT>
__device__ __forceinline__ void tile_tconv(uint32_t tile, uint32_t taps, float (&acc)[MT][4][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t tp = taps + k * kSub * 2;
      uint32_t lo[4], hi[4];
      if (kBwd) {  // W_k^T: the staged rows (in channels) are its columns
        const int r = ((lane >> 4) << 3) + (lane & 7), c = 2 * kk + ((lane >> 3) & 1);
        tc::ldmatrix_x4(lo, tp + sub(r, c));
        tc::ldmatrix_x4(hi, tp + sub(16 + r, c));
      } else {
        tc::ldmatrix_x4_trans(lo, tp + sub(16 * kk + (lane & 15), lane >> 4));
        tc::ldmatrix_x4_trans(hi, tp + sub(16 * kk + (lane & 15), 2 + (lane >> 4)));
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t a[4];
        tc::ldmatrix_x4(a, tile + sub(16 * m + (kBwd ? 2 - k : k) + (lane & 15), 2 * kk + (lane >> 4)));
        mma4(acc[m], a, lo, hi);
      }
    }
}

// A row's 32-bit mask word from this lane's bits (columns 8 n + 2 (lane %
// 4) + e), ORed over the row's 4 lanes.
__device__ __forceinline__ uint32_t quad_or(uint32_t bits) {
  bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
  return bits | __shfl_xor_sync(0xffffffffu, bits, 2);
}

struct FwdArgs {
  const float* in;   // block 0: the motion (rows, 26); else h_{i-1} (rows, 416)
  const bf16* m;     // the graph conv: m0 (32, 416) or M_i (416, 416)
  const bf16* wt;    // the block's taps (3, 32, 32)
  const float* b1;   // (416,)
  const float* b2;   // (32,)
  float* h;          // h_i (rows, 416); block 9 writes none
  uint32_t* gmask;   // [g > 0], [h_i > 0] of each row: (rows, 13) words, or nullptr
  uint32_t* hmask;
  const bf16* fc;    // block 9: the projection (416, 64), its bias, out (rows, 64)
  const float* fcb;
  float* out;
  int T;
};

// kFirst: block 0 (the motion in, no residual); kLast: block 9 (the
// projection out).
template <bool kFirst, bool kLast>
__global__ void __launch_bounds__(kThreads, 1) stgcn_fwd_kernel(FwdArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a = reinterpret_cast<bf16*>(smem);                 // row j: frame t0 - 1 + j
  float* res = reinterpret_cast<float*>(smem + kFResOff);  // row r: frame t0 + r, float32
  const int v = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const uint32_t a_addr = tc::smem_addr(a), taps = a_addr + kFTapOff;
  const uint32_t region = a_addr + kFRegionOff + v * kFRegion * 2;
  unsigned char* tile = smem + kFRegionOff + v * kFRegion * 2;  // g, at `region`
  const int t0 = blockIdx.x * kFwdRows;
  const size_t base = (size_t)blockIdx.y * p.T;  // the clip's first row
  stage_taps(taps, p.wt);
  tc::cp_async_commit();
  if (kFirst) {
    for (int i = threadIdx.x; i < kFTile * kInPad; i += kThreads) {
      const int j = i / kInPad, c = i % kInPad, t = t0 - 1 + j;
      a[j * kLdA + c] = __float2bfloat16(c < kIn && t >= 0 && t < p.T ? p.in[(base + t) * kIn + c] : 0.f);
    }
  } else {  // h_{i-1}: bf16 into the operand tile, the owned rows also as float32 for the residual
#pragma unroll 4
    for (int i = threadIdx.x; i < kFTile * W / 8; i += kThreads) {
      const int j = i / (W / 8), c = i % (W / 8) * 8, t = t0 - 1 + j;
      float v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (t >= 0 && t < p.T) load8(p.in + (base + t) * W + c, v8);
      store8(a + j * kLdA + c, v8);
      if (j >= 1 && j <= kFwdRows) {
        float4* r4 = reinterpret_cast<float4*>(res + (j - 1) * kLdR + c);
        r4[0] = make_float4(v8[0], v8[1], v8[2], v8[3]);
        r4[1] = make_float4(v8[4], v8[5], v8[6], v8[7]);
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // joint v's 32 graph-conv columns on the tile's rows
  float acc[kFMT][4][4] = {};
  warp_gemm<kFMT, false, kFDepth>(a_addr, kLdA, p.m + C * v, W, kFirst ? kInPad : W, region, acc);
  // g = relu(acc + b1), zero outside the clip, into the g tile (row j:
  // frame t0 - 1 + j); the owned rows' bits
  float2 b1[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) b1[n] = *reinterpret_cast<const float2*>(p.b1 + C * v + 8 * n + 2 * tq);
#pragma unroll
  for (int m = 0; m < kFMT; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = 16 * m + g + 8 * hh, t = t0 - 1 + j;
      const bool in_clip = t >= 0 && t < p.T;
      uint32_t bits = 0;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float x0 = in_clip ? fmaxf(acc[m][n][2 * hh] + b1[n].x, 0.f) : 0.f;
        const float x1 = in_clip ? fmaxf(acc[m][n][2 * hh + 1] + b1[n].y, 0.f) : 0.f;
        bits |= (uint32_t)(x0 > 0.f) << (8 * n + 2 * tq) | (uint32_t)(x1 > 0.f) << (8 * n + 2 * tq + 1);
        store_bf2(tile + sub(j, n) + 4 * tq, x0, x1);
      }
      bits = quad_or(bits);
      if (p.gmask && tq == 0 && j >= 1 && j <= kFwdRows && in_clip) p.gmask[(base + t) * V + v] = bits;
    }
  __syncwarp();
  // y = b2 (+ h_{i-1}) + the temporal conv on the owned rows (row r: frame
  // t0 + r): the accumulator starts at the bias and the residual
#pragma unroll
  for (int m = 0; m < kFMT; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * m + g + 8 * hh;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = 8 * n + 2 * tq;
        float2 y = *reinterpret_cast<const float2*>(p.b2 + c);
        if (!kFirst && r < kFwdRows) {
          const float2 h0 = *reinterpret_cast<const float2*>(res + r * kLdR + C * v + c);
          y.x += h0.x;
          y.y += h0.y;
        }
        acc[m][n][2 * hh] = y.x;
        acc[m][n][2 * hh + 1] = y.y;
      }
    }
  tile_tconv<false>(region, taps, acc);
  // h_i = relu(y), and its bits; block 9 keeps h_10 in the residual tile
#pragma unroll
  for (int m = 0; m < kFMT; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * m + g + 8 * hh, t = t0 + r;
      const bool own = r < kFwdRows && t < p.T;
      uint32_t bits = 0;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = C * v + 8 * n + 2 * tq;
        const float2 y = make_float2(fmaxf(acc[m][n][2 * hh], 0.f), fmaxf(acc[m][n][2 * hh + 1], 0.f));
        if (kLast && r < kFwdRows)  // the residual tile's own columns: read by this warp only
          *reinterpret_cast<float2*>(res + r * kLdR + c) = own ? y : make_float2(0.f, 0.f);
        else if (!kLast && own)
          *reinterpret_cast<float2*>(p.h + (base + t) * W + c) = y;
        bits |= (uint32_t)(y.x > 0.f) << (8 * n + 2 * tq) | (uint32_t)(y.y > 0.f) << (8 * n + 2 * tq + 1);
      }
      bits = quad_or(bits);
      if (p.hmask && tq == 0 && own) p.hmask[(base + t) * V + v] = bits;
    }
  if (!kLast) return;

  // out = fcb + bf16(h_10) FC: h_10 into the operand tile (row r: frame
  // t0 + r), then 16-row x 32-column jobs
  __syncthreads();
  for (int i = threadIdx.x; i < kFTile * W / 8; i += kThreads) {
    const int r = i / (W / 8), c = i % (W / 8) * 8;
    float v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < kFwdRows) {
      const float4* r4 = reinterpret_cast<const float4*>(res + r * kLdR + c);
      const float4 x = r4[0], y = r4[1];
      v8[0] = x.x, v8[1] = x.y, v8[2] = x.z, v8[3] = x.w, v8[4] = y.x, v8[5] = y.y, v8[6] = y.z, v8[7] = y.w;
    }
    store8(a + r * kLdA + c, v8);
  }
  __syncthreads();
  for (int job = v; job < 2 * kFMT; job += kWarps) {
    const int m0 = job >> 1, nh = job & 1;
    float o[1][4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float2 bias = *reinterpret_cast<const float2*>(p.fcb + 32 * nh + 8 * n + 2 * tq);
      o[0][n][0] = o[0][n][2] = bias.x;
      o[0][n][1] = o[0][n][3] = bias.y;
    }
    warp_gemm<1, false, kFDepth>(a_addr + m0 * 16 * kLdA * 2, kLdA, p.fc + 32 * nh, kOut, W, region, o);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * m0 + g + 8 * hh, t = t0 + r;
      if (r >= kFwdRows || t >= p.T) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n)
        *reinterpret_cast<float2*>(p.out + (base + t) * kOut + 32 * nh + 8 * n + 2 * tq) =
            make_float2(o[0][n][2 * hh], o[0][n][2 * hh + 1]);
    }
  }
}

struct BwdArgs {
  float* dh;               // dh_i (rows, 416); block 9 first writes dy_9 of its owned rows there
  const float* dy;         // block 9: the output cotangent (rows, 64) and the projection (416, 64)
  const bf16* fc;
  const uint32_t* gmask;   // the block's masks (rows, 13)
  const uint32_t* hmask;
  const bf16* wt;          // the block's taps
  const bf16* m;           // M_i (416, 416), or block 0's m0 (32, 416)
  float* out;              // dh_{i-1} (rows, 416), or block 0's dx (rows, 26)
  int T;
};

// kFirst: block 9 (dh_9 = bf16(dy_out) FC^T first); kLast: block 0 (dx).
template <bool kFirst, bool kLast>
__global__ void __launch_bounds__(kThreads, 1) stgcn_bwd_kernel(BwdArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int v = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const uint32_t da_addr = tc::smem_addr(smem), taps = da_addr + kBTapOff;  // da row r: frame t0 + r
  const uint32_t region = da_addr + kBRegionOff + v * kBRegion * 2;
  unsigned char* tile = smem + kBRegionOff + v * kBRegion * 2;  // dy, at `region`
  bf16* dyo = reinterpret_cast<bf16*>(smem + kBwdSmem);        // block 9: row j: frame t0 - 1 + j
  const int t0 = blockIdx.x * kBwdRows;
  const size_t base = (size_t)blockIdx.y * p.T;
  stage_taps(taps, p.wt);
  tc::cp_async_commit();
  if (kFirst) {
    for (int i = threadIdx.x; i < kDyRows * kOut / 8; i += kThreads) {
      const int j = i / (kOut / 8), c = i % (kOut / 8) * 8, t = t0 - 1 + j;
      float v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (j < kBTile + 2 && t >= 0 && t < p.T) load8(p.dy + (base + t) * kOut + c, v8);
      store8(dyo + j * kLdDy + c, v8);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // joint v: dy_i = dh_i [h_i > 0] on rows t0 - 1 + j, j < kBTile + 2, zero
  // outside the clip, as bf16 into the warp's dy tile
  if (kFirst) {
    float d[kDyMT][4][4] = {};
    warp_gemm<kDyMT, true, kBDepth>(tc::smem_addr(dyo), kLdDy, p.fc + (size_t)C * v * kOut, kOut, kOut,
                                    region, d);
    uint32_t words[kDyMT][2];
#pragma unroll
    for (int m = 0; m < kDyMT; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = 16 * m + g + 8 * hh, t = t0 - 1 + j;
        words[m][hh] = j < kBTile + 2 && t >= 0 && t < p.T ? p.hmask[(base + t) * V + v] : 0u;
      }
#pragma unroll
    for (int m = 0; m < kDyMT; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = 16 * m + g + 8 * hh, t = t0 - 1 + j;
        if (j >= kBTile + 2) continue;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = 8 * n + 2 * tq;
          const float x0 = (words[m][hh] >> c) & 1u ? d[m][n][2 * hh] : 0.f;
          const float x1 = (words[m][hh] >> (c + 1)) & 1u ? d[m][n][2 * hh + 1] : 0.f;
          store_bf2(tile + sub(j, n) + 4 * tq, x0, x1);
          if (j >= 1 && j <= kBwdRows && t < p.T)  // dy_9 of the owned rows, for the residual
            *reinterpret_cast<float2*>(p.dh + (base + t) * W + C * v + c) = make_float2(x0, x1);
        }
      }
  } else {
    constexpr int kLoads = ((kBTile + 2) * 8 + 31) / 32;  // 16-byte pieces a lane
    float4 x[kLoads];
    uint32_t w[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {  // every load issued before the first store
      const int i = lane + 32 * q, j = i >> 3, f = i & 7, t = t0 - 1 + j;
      x[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      w[q] = 0u;
      if (j < kBTile + 2 && t >= 0 && t < p.T) {
        w[q] = p.hmask[(base + t) * V + v] >> (4 * f);
        x[q] = *reinterpret_cast<const float4*>(p.dh + (base + t) * W + C * v + 4 * f);
      }
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int i = lane + 32 * q, j = i >> 3, f = i & 7;
      if (j >= kBTile + 2) continue;
      unsigned char* d = tile + sub(j, f >> 1) + 8 * (f & 1);
      store_bf2(d, w[q] & 1u ? x[q].x : 0.f, w[q] & 2u ? x[q].y : 0.f);
      store_bf2(d + 4, w[q] & 4u ? x[q].z : 0.f, w[q] & 8u ? x[q].w : 0.f);
    }
  }
  __syncwarp();
  {
    // da = sum_k bf16(dy[t + 1 - k]) W_k^T, gated by [g > 0], into the da tile
    uint32_t words[kBMT][2];
#pragma unroll
    for (int m = 0; m < kBMT; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + 16 * m + g + 8 * hh;
        words[m][hh] = t < p.T ? p.gmask[(base + t) * V + v] : 0u;
      }
    float acc[kBMT][4][4] = {};
    tile_tconv<true>(region, taps, acc);
#pragma unroll
    for (int m = 0; m < kBMT; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * m + g + 8 * hh;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = 8 * n + 2 * tq;
          store_bf2(smem + (r * kLdA + C * v + c) * 2, (words[m][hh] >> c) & 1u ? acc[m][n][2 * hh] : 0.f,
                    (words[m][hh] >> (c + 1)) & 1u ? acc[m][n][2 * hh + 1] : 0.f);
        }
      }
  }
  __syncwarp();  // the dy tile is read before the ring refills it
  __syncthreads();

  if (!kLast) {
    // dh_{i-1} = dy_i + bf16(da) M_i^T: joint v's columns are M_i's rows
    // 32 v .., the gated residual loaded into the accumulator first
    float acc[kBMT][4][4];
#pragma unroll
    for (int m = 0; m < kBMT; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + 16 * m + g + 8 * hh;
        const bool in_clip = t < p.T;
        const uint32_t word = in_clip ? p.hmask[(base + t) * V + v] : 0u;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = 8 * n + 2 * tq;
          const float2 res = in_clip ? *reinterpret_cast<const float2*>(p.dh + (base + t) * W + C * v + c)
                                     : make_float2(0.f, 0.f);
          acc[m][n][2 * hh] = (word >> c) & 1u ? res.x : 0.f;
          acc[m][n][2 * hh + 1] = (word >> (c + 1)) & 1u ? res.y : 0.f;
        }
      }
    warp_gemm<kBMT, true, kBDepth>(da_addr, kLdA, p.m + (size_t)C * v * W, W, W, region, acc);
#pragma unroll
    for (int m = 0; m < kBMT; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + 16 * m + g + 8 * hh;
        if (t >= p.T) continue;
#pragma unroll
        for (int n = 0; n < 4; ++n)
          *reinterpret_cast<float2*>(p.out + (base + t) * W + C * v + 8 * n + 2 * tq) =
              make_float2(acc[m][n][2 * hh], acc[m][n][2 * hh + 1]);
      }
  } else {
    // dx = bf16(da_0) M_0^T: 26 columns, one 16-row job a warp
    for (int job = v; job < kBMT; job += kWarps) {
      float acc[1][4][4] = {};
      warp_gemm<1, true, kBDepth>(da_addr + job * 16 * kLdA * 2, kLdA, p.m, W, W, region, acc);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + 16 * job + g + 8 * hh;
        if (t >= p.T) continue;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = 8 * n + 2 * tq;
          if (c < kIn) p.out[(base + t) * kIn + c] = acc[0][n][2 * hh];
          if (c + 1 < kIn) p.out[(base + t) * kIn + c + 1] = acc[0][n][2 * hh + 1];
        }
      }
    }
  }
}

template <bool kFirst, bool kLast>
cudaError_t launch_fwd(const FwdArgs& p, int B, cudaStream_t stream) {
  static const cudaError_t set = cudaFuncSetAttribute(
      stgcn_fwd_kernel<kFirst, kLast>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdSmem);
  if (set != cudaSuccess) return set;
  stgcn_fwd_kernel<kFirst, kLast><<<dim3(ceil_div(p.T, kFwdRows), B), kThreads, kFwdSmem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kFirst, bool kLast>
cudaError_t launch_bwd(const BwdArgs& p, int B, cudaStream_t stream) {
  constexpr size_t smem = kFirst ? kBwdSmemFirst : kBwdSmem;
  static const cudaError_t set = cudaFuncSetAttribute(
      stgcn_bwd_kernel<kFirst, kLast>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) return set;
  stgcn_bwd_kernel<kFirst, kLast><<<dim3(ceil_div(p.T, kBwdRows), B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

#define CT_TRY(expr)                          \
  do {                                        \
    const cudaError_t err_ = (expr);          \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

}  // namespace

// x (B*T, 26) float32 -> out (B*T, 64) float32, one launch a block.  hbuf:
// two float32 (B*T, 416) slabs, each block's output h in turn.  gmask /
// hmask: (10, B*T, 13) words of each block's [g > 0] / [h > 0] bits (bit c
// of word v: channel c of joint v), or both null (no `save`).
CT_EXPORT int stgcn_forward(const void* x, const void* m0, const void* m, const void* wt,
                            const void* b1, const void* b2, const void* fc, const void* fcb,
                            void* hbuf, void* gmask, void* hmask, void* out, int B, int T,
                            void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t rows = (size_t)B * T, slab = rows * W;
  if (rows == 0) return 0;
  auto h = [&](int i) { return static_cast<float*>(hbuf) + (i % 2) * slab; };
  auto mask = [&](void* p, int i) { return p ? static_cast<uint32_t*>(p) + i * rows * V : nullptr; };
  for (int i = 0; i < kBlocks; ++i) {
    const FwdArgs a{i == 0 ? static_cast<const float*>(x) : h(i - 1),
                    i == 0 ? static_cast<const bf16*>(m0)
                           : static_cast<const bf16*>(m) + (size_t)(i - 1) * W * W,
                    static_cast<const bf16*>(wt) + i * 3 * C * C, static_cast<const float*>(b1) + i * W,
                    static_cast<const float*>(b2) + i * C, h(i), mask(gmask, i), mask(hmask, i),
                    static_cast<const bf16*>(fc), static_cast<const float*>(fcb),
                    static_cast<float*>(out), T};
    CT_TRY((i == 0 ? launch_fwd<true, false>(a, B, s)
                   : i < kBlocks - 1 ? launch_fwd<false, false>(a, B, s) : launch_fwd<false, true>(a, B, s)));
  }
  return 0;
}

// dy (B*T, 64) float32 and the forward's masks -> dx (B*T, 26) float32, one
// launch a block.  dh: two float32 (B*T, 416) slabs used in turn.
CT_EXPORT int stgcn_backward(const void* dy, const void* m0, const void* m, const void* wt,
                             const void* fc, const void* gmask, const void* hmask, void* dh,
                             void* dx, int B, int T, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t rows = (size_t)B * T, slab = rows * W;
  if (rows == 0) return 0;
  auto d = [&](int j) { return static_cast<float*>(dh) + j * slab; };
  int cur = 0;
  for (int i = kBlocks - 1; i >= 0; --i, cur ^= 1) {
    const BwdArgs a{d(cur), static_cast<const float*>(dy), static_cast<const bf16*>(fc),
                    static_cast<const uint32_t*>(gmask) + i * rows * V,
                    static_cast<const uint32_t*>(hmask) + i * rows * V,
                    static_cast<const bf16*>(wt) + i * 3 * C * C,
                    i == 0 ? static_cast<const bf16*>(m0)
                           : static_cast<const bf16*>(m) + (size_t)(i - 1) * W * W,
                    i == 0 ? static_cast<float*>(dx) : d(1 - cur), T};
    CT_TRY((i == kBlocks - 1 ? launch_bwd<true, false>(a, B, s)
                             : i > 0 ? launch_bwd<false, false>(a, B, s) : launch_bwd<false, true>(a, B, s)));
  }
  return 0;
}

// The tiling stgcn_forward (backward = 0) or stgcn_backward (1) launches
// for B clips of T frames, which ops/stgcn.py::plan reports from this
// file's constants: out[0..4] = frames a block owns, rows its products run
// on, blocks a launch, threads a block, dynamic shared memory bytes (the
// most of its launches).
CT_EXPORT int stgcn_plan(int B, int T, int backward, int* out) {
  const int rows = backward ? kBwdRows : kFwdRows;
  const int v[5] = {rows, backward ? kBTile : kFTile, B * ceil_div(T, rows), kThreads,
                    (int)(backward ? kBwdSmemFirst : kFwdSmem)};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

// Device code shared by the decoder-layer kernels: K1 / K5
// (decoder_stack.cu) and K6 (decoder_layer_bwd.cu).  Everything here works
// on one tile of one clip (64 rows in the KV pass, 32 in the row passes),
// D wide, in a block's shared memory; see decoder_stack.cu for the design.
// The row-wise helpers write the matmul operand in its type: bf16 (rows of
// kLdA) or, in K1's float32 mode, float32 (rows of kLdF).
//
// D, the model width, is a compile-time constant: the build compiles each
// of the two sources that include this header once per width it takes
// (LAYER_D = 32, 64, 128; ops/_build.py WIDTHS), each into its own inline
// namespace (layer::d32, ...), and their C entry points carry the width in
// their names (`LAYER_EXPORT`: decoder_stack_forward_d64, ...).  So every
// register tile and shared-memory layout stays compile-time at each width,
// the D = 128 code is the one the flagship ran before the other widths
// came, and the widths build in parallel.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"
#include "tensor_core.cuh"

#ifndef LAYER_D
#define LAYER_D 128
#endif
#define LAYER_CAT2(a, b) a##b
#define LAYER_CAT(a, b) LAYER_CAT2(a, b)
// The width's inline namespace, and a C entry point's name at this width.
#define LAYER_WIDTH_NS LAYER_CAT(d, LAYER_D)
#define LAYER_EXPORT(name) LAYER_CAT(name, LAYER_CAT(_d, LAYER_D))

namespace layer {
inline namespace LAYER_WIDTH_NS {

using namespace nvcuda;

constexpr int D = LAYER_D;      // latent width of this instantiation
static_assert(D == 32 || D == 64 || D == 128, "the widths the kernels are built for");
constexpr int kC = D / 32;      // columns a lane owns in the row-wise helpers
constexpr int kTileRows = 64;   // rows per block (ops/decoder_stack.py ROWS_PER_TILE)
constexpr int kThreadsA = D;    // kv_partials: a thread a column (4 warps at D = 128, 1 at 32)
constexpr int kThreadsC = 256;  // row passes: 8 warps
constexpr int kRowsA = kTileRows * 32 / kThreadsA;  // rows per warp in the row-wise phases
constexpr int kRowsC = kTileRows * 32 / kThreadsC;
static_assert(kThreadsA == D, "kv_partials_kernel gives each thread one column");
constexpr int kLdF = D + 4;       // row stride of the (64, D) float32 tiles
constexpr int kLdA = D + 8;       // row stride of the (64, D) bf16 operand
constexpr int kPrefetch = 4;      // k-steps of weight fragments in flight
constexpr int kChunks = D / 8;    // 16-byte chunks of a bf16 row of D

// vector rows of the (24, D) bank (train/fused_denoiser.pack_layer_weights)
enum Vec {
  kLnSelfG = 0, kLnSelfB, kBq, kBk, kBv, kStylSelfG, kStylSelfB, kStylSelfOut,
  kLnCrossG, kLnCrossB, kBqCross, kStylCrossG, kStylCrossB, kStylCrossOut,
  kB1, kB2, kStylFfnG, kStylFfnB, kStylFfnOut,
};
// matrices of the (9, D, D) bank
enum Mat { kWq = 0, kWk, kWv, kWStylSelf, kWqCross, kWStylCross, kW1, kW2, kWStylFfn };

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum within each aligned group of dh lanes (a head's columns lane + 32 i).
__device__ __forceinline__ float head_sum(float v, int dh) {
  for (int o = dh >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Four consecutive values of a float32 or bf16 row, as float4.
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const bf16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]), b = __bfloat1622float2(q[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// One matmul operand value, rounded to the operand type: bf16, or float32 as is.
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
// Row stride of an operand tile of type OT in shared memory.
template <typename OT>
constexpr int kLdOp = std::is_same<OT, float>::value ? kLdF : kLdA;
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

// C (64 x N) = A (64 x K) @ op(B) (K x N) for the whole block, float32
// accumulation; with `accumulate`, C += instead.  A in shared or global
// memory, row-major; B in global memory (L2), row-major (K x N) or, with
// kTransB, the transpose of a row-major (N x K) matrix; N a multiple of 32,
// K of 16.  The warps share C out as jobs of 32 columns by 16 * MI rows, so
// one B fragment feeds MI MMAs, and the B fragments of the next kPrefetch
// k-steps are in flight while this one's MMAs issue.  Callers put a
// __syncthreads() before (A written) and after (C read by other warps).
template <int MI, bool kTransB>
__device__ void block_gemm_jobs(const bf16* A, int lda, const bf16* B, int ldb, int K, int N,
                                float* C, int ldc, bool accumulate) {
  using LayoutB = typename std::conditional<kTransB, wmma::col_major, wmma::row_major>::type;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> FragB;
  auto bp = [&](int k, int n) {
    return kTransB ? B + (size_t)n * ldb + k : B + (size_t)k * ldb + n;
  };
  constexpr int kGroups = kTileRows / (16 * MI);
  const int n_warps = blockDim.x >> 5;
  for (int job = threadIdx.x >> 5; job < kGroups * (N / 32); job += n_warps) {
    const int r0 = (job % kGroups) * 16 * MI, n0 = (job / kGroups) * 32;
    FragC acc[MI][2];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      if (accumulate) {
        float* c = C + (r0 + i * 16) * ldc + n0;
        wmma::load_matrix_sync(acc[i][0], c, ldc, wmma::mem_row_major);
        wmma::load_matrix_sync(acc[i][1], c + 16, ldc, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(acc[i][0], 0.f);
        wmma::fill_fragment(acc[i][1], 0.f);
      }
    }
    FragB b[kPrefetch][2];
#pragma unroll
    for (int s = 0; s < kPrefetch; ++s)
      if (s * 16 < K) {
        wmma::load_matrix_sync(b[s][0], bp(s * 16, n0), ldb);
        wmma::load_matrix_sync(b[s][1], bp(s * 16, n0 + 16), ldb);
      }
    for (int k0 = 0; k0 < K; k0 += 16 * kPrefetch) {
#pragma unroll
      for (int s = 0; s < kPrefetch; ++s) {
        const int k = k0 + 16 * s;
        if (k < K) {
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            FragA a;
            wmma::load_matrix_sync(a, A + (size_t)(r0 + i * 16) * lda + k, lda);
            wmma::mma_sync(acc[i][0], a, b[s][0], acc[i][0]);
            wmma::mma_sync(acc[i][1], a, b[s][1], acc[i][1]);
          }
          const int kn = k + 16 * kPrefetch;
          if (kn < K) {
            wmma::load_matrix_sync(b[s][0], bp(kn, n0), ldb);
            wmma::load_matrix_sync(b[s][1], bp(kn, n0 + 16), ldb);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      float* c = C + (r0 + i * 16) * ldc + n0;
      wmma::store_matrix_sync(c, acc[i][0], ldc, wmma::mem_row_major);
      wmma::store_matrix_sync(c + 16, acc[i][1], ldc, wmma::mem_row_major);
    }
  }
}

// Whole 64-row column slices while there is one for every warp, else halves.
template <bool kTransB = false>
__device__ void block_gemm(const bf16* A, int lda, const bf16* B, int ldb, int K, int N,
                           float* C, int ldc, bool accumulate = false) {
  if (N / 32 >= (int)(blockDim.x >> 5))
    block_gemm_jobs<4, kTransB>(A, lda, B, ldb, K, N, C, ldc, accumulate);
  else
    block_gemm_jobs<2, kTransB>(A, lda, B, ldb, K, N, C, ldc, accumulate);
}

// Row-wise helpers, one warp over its ROWS rows (float32 rows at stride
// kLdF, bf16 rows at kLdA): lane owns columns lane + 32 * i, i < kC.

// LayerNorm statistics of one row held as v[kC] per lane: (mean, rstd).
__device__ __forceinline__ float2 ln_stats(const float v[kC]) {
  float s = v[0];
#pragma unroll
  for (int i = 1; i < kC; ++i) s += v[i];
  const float mu = warp_sum(s) * (1.f / D);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kC; ++i) q += (v[i] - mu) * (v[i] - mu);
  return make_float2(mu, rsqrtf(warp_sum(q) * (1.f / D) + 1e-5f));
}

// dst = LN(src) * g + b, in dst's operand type.
template <int ROWS, typename OT>
__device__ void warp_ln(const float* src, const float* g, const float* b, OT* dst) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < ROWS; ++r) {
    float v[kC];
#pragma unroll
    for (int i = 0; i < kC; ++i) v[i] = src[r * kLdF + lane + 32 * i];
    const float2 st = ln_stats(v);
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int c = lane + 32 * i;
      put(dst + r * kLdOp<OT> + c, (v[i] - st.x) * st.y * g[c] + b[c]);
    }
  }
}

// softmax within each head of (q + bias): exp(q - rowmax) over the
// denominators sum_head bf16(exp(..)), as the JAX kernel's seg matmul
// rounds its operand (kMxuBf16; in the float32 mode the sum is of the
// float32 values).  In the bf16-VPU mode (kVpuBf16) JAX's exp takes
// bf16(q - rowmax) and returns bf16, which the float32 division then reads.
template <bool kVpuBf16 = false, bool kMxuBf16 = true>
__device__ __forceinline__ void head_softmax_row(float v[kC], int dh) {
  float m = v[0];
  if constexpr (kC == 4) {  // D = 128: a tree, two steps deep
    m = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
  } else {
#pragma unroll
    for (int i = 1; i < kC; ++i) m = fmaxf(m, v[i]);
  }
  m = warp_max(m);
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    if (kVpuBf16) {
      v[i] = round_bf16(expf(round_bf16(v[i] - m)));
      v[i] /= head_sum(v[i], dh);
    } else {
      v[i] = expf(v[i] - m);
      v[i] /= head_sum(kMxuBf16 ? round_bf16(v[i]) : v[i], dh);
    }
  }
}

// dst = softmax within each head of (src + bias), in dst's operand type;
// with kVpuBf16 in the bf16-VPU mode's rounding.
template <int ROWS, bool kVpuBf16 = false, typename OT>
__device__ void warp_head_softmax(const float* src, const float* bias, int dh, OT* dst) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < ROWS; ++r) {
    float v[kC];
#pragma unroll
    for (int i = 0; i < kC; ++i) v[i] = src[r * kLdF + lane + 32 * i] + bias[lane + 32 * i];
    head_softmax_row<kVpuBf16, std::is_same<OT, bf16>::value>(v, dh);
#pragma unroll
    for (int i = 0; i < kC; ++i) put(dst + r * kLdOp<OT> + lane + 32 * i, v[i]);
  }
}

// silu(h) = h / (1 + exp(-h)) with h and each op's result rounded to bf16,
// the quotient too (a float32 operand keeps it so), as the JAX kernel's
// `styl` computes it in the bf16-VPU mode.
__device__ __forceinline__ float silu_vpu_bf16(float h) {
  const float hb = round_bf16(h);
  return round_bf16(hb / round_bf16(1.f + round_bf16(expf(-hb))));
}

// ---- helpers of K1 / K5's row pass since its redesign: the B operands of
// its (ROWS x D) @ (D x D) products staged in shared memory, and the AdaLN
// modulation read from the rows that the AdaLN GEMM (adaln_gemm.cu) wrote.

constexpr int kWeightTile = D * D * 2;  // bytes of one staged (D x D) bf16 matrix
constexpr int kRowsTile = 32;           // rows of a row-pass tile (K1 / K5, K6), 4 a warp

// Start the copy of the row-major (D x D) bf16 matrix W into the shared
// tile at `stage` (kChunks chunks a row, swizzled), by all the block's
// threads; the caller commits the group.
__device__ __forceinline__ void stage_weights(uint32_t stage, const bf16* W) {
  for (int i = threadIdx.x; i < D * D / 8; i += blockDim.x)
    tc::cp_async16(stage + tc::swz<kChunks>((unsigned)i / kChunks, (unsigned)i % kChunks), W + 8 * i);
}

// `tile_gemm_smem`'s warp grid over the (kRowsTile x D) output: kGemmNJ n8
// tiles a warp (16 columns at D = 128, 8 below), kGemmWN warps across the
// columns and kGemmWR down the rows, kGemmMI m16 tiles a warp.
constexpr int kGemmNJ = D >= 128 ? 2 : 1;
constexpr int kGemmWN = D / (8 * kGemmNJ);
constexpr int kGemmWR = (kThreadsC / 32) / kGemmWN;
constexpr int kGemmMI = kRowsTile / 16 / kGemmWR;
static_assert(kGemmWR * kGemmWN == kThreadsC / 32 && kGemmMI >= 1, "tile_gemm_smem's warp grid");

// C (kRowsTile x D, float32, row stride kLdF) = A (kRowsTile x D bf16,
// row stride kLdA, shared) @ op(B), B the (D x D) bf16 matrix staged by
// `stage_weights` at Bs: B itself, or with kTransB its transpose (K6's
// backward products); with `accumulate`, C += instead.  mma.sync
// m16n8k16, A fragments by ldmatrix, B by ldmatrix.trans (B) or ldmatrix
// (B^T: the staged rows are its columns).  Each of the block's 8 warps
// computes 8 kGemmNJ columns of 16 kGemmMI rows of C (at D = 128, 16
// columns of all 32 rows).
template <bool kTransB = false>
__device__ __forceinline__ void tile_gemm_smem(const bf16* A, uint32_t Bs, float* C,
                                               bool accumulate = false) {
  constexpr int MI = kGemmMI, NJ = kGemmNJ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // (one warp row at D = 128: the warp index alone places it)
  const int n0 = (kGemmWR == 1 ? warp : warp % kGemmWN) * 8 * NJ;
  const int m0 = kGemmWR == 1 ? 0 : (warp / kGemmWN) * 16 * MI;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t a_base = tc::smem_addr(A);
  C += m0 * kLdF;
  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* c = C + (16 * i + g) * kLdF + n0 + 8 * j + 2 * t;
      const float2 lo = accumulate ? *reinterpret_cast<const float2*>(c) : make_float2(0.f, 0.f);
      const float2 hi = accumulate ? *reinterpret_cast<const float2*>(c + 8 * kLdF) : make_float2(0.f, 0.f);
      acc[i][j][0] = lo.x;
      acc[i][j][1] = lo.y;
      acc[i][j][2] = hi.x;
      acc[i][j][3] = hi.y;
    }
#pragma unroll 4
  for (int k = 0; k < D; k += 16) {
    uint32_t a[MI][4], b[4];  // b: b0, b1 of n8 tile 0, then of tile 1
#pragma unroll
    for (int i = 0; i < MI; ++i)
      tc::ldmatrix_x4(a[i], a_base + ((m0 + 16 * i + (lane & 15)) * kLdA + k + (lane >> 4) * 8) * 2);
    if constexpr (NJ == 2) {
      if (kTransB)
        tc::ldmatrix_x4(b, Bs + tc::swz<kChunks>(n0 + ((lane >> 4) << 3) + (lane & 7), k / 8 + ((lane >> 3) & 1)));
      else
        tc::ldmatrix_x4_trans(b, Bs + tc::swz<kChunks>(k + (lane & 15), n0 / 8 + (lane >> 4)));
    } else {  // one n8 tile: lanes 0-15 give the addresses (the others' are not read)
      const int l = lane & 15;
      uint32_t (&b2)[2] = *reinterpret_cast<uint32_t(*)[2]>(b);
      if (kTransB)
        tc::ldmatrix_x2(b2, Bs + tc::swz<kChunks>(n0 + (l & 7), k / 8 + (l >> 3)));
      else
        tc::ldmatrix_x2_trans(b2, Bs + tc::swz<kChunks>(k + l, n0 / 8));
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      tc::mma_bf16(acc[i][0], a[i], b[0], b[1]);
      if constexpr (NJ == 2) tc::mma_bf16(acc[i][NJ - 1], a[i], b[2], b[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float* c = C + (16 * i + g) * kLdF + n0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(c) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(c + 8 * kLdF) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

// dst = silu(LN(y + ybias) * (1 + scale) + shift) over the warp's ROWS
// rows, in dst's operand type, (scale, shift) = mod[r, 0:D], mod[r, D:2D]
// (global memory, row stride ldmod, the AdaLN bias already added); rows at
// or past n_valid read no mod (0).  kVpuBf16: the SiLU in bf16
// (`silu_vpu_bf16`).
template <int ROWS, bool kVpuBf16 = false, typename OT>
__device__ void warp_adaln_mod(const float* y, const float* ybias, const float* mod, int ldmod,
                               int n_valid, const float* g, const float* gb, OT* dst) {
  const int lane = threadIdx.x & 31;
  float scale[ROWS][kC], shift[ROWS][kC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const bool ok = r < n_valid;
      scale[r][i] = ok ? mod[(size_t)r * ldmod + lane + 32 * i] : 0.f;
      shift[r][i] = ok ? mod[(size_t)r * ldmod + D + lane + 32 * i] : 0.f;
    }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float v[kC];
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int c = lane + 32 * i;
      v[i] = y[r * kLdF + c] + (ybias ? ybias[c] : 0.f);
    }
    const float2 st = ln_stats(v);
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int c = lane + 32 * i;
      const float h = ((v[i] - st.x) * st.y * g[c] + gb[c]) * (1.f + scale[r][i]) + shift[r][i];
      put(dst + r * kLdOp<OT> + c, kVpuBf16 ? silu_vpu_bf16(h) : silu(h));
    }
  }
}

// ---- K1's float32 mode (`mxu_dtype=float32`): the same products on the
// CUDA cores, FFMA in float32, each output one chain over k in ascending
// order (the tensor cores have no float32 product, and TF32 keeps about
// three digits).  A thread holds a register tile of outputs and reads A
// and B from shared memory as 16-byte vectors, 4 k-steps at a time.

// C (kTileRows x D, row stride kLdF) = A (kTileRows x D float32, row stride
// kLdF, shared) @ B (D x D float32, row-major, shared), by kThreadsA (= D)
// threads: thread t owns rows t % 8 + 8 i (i < 8) and columns 4 (t / 8) +
// j, D / 2 + 4 (t / 8) + j (j < 4).  The 8 lanes of one k-step's A load
// read 8 rows 4 banks apart (kLdF = D + 4), so no two share a bank; a
// warp's B loads are 4 vectors of one row, broadcast.  Pass A's k and v
// products.
__device__ inline void block_gemm_f32(const float* A, const float* B, float* C) {
  const int rg = threadIdx.x & 7, n0 = 4 * (threadIdx.x >> 3);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 1
  for (int k = 0; k < D; k += 4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = load4(A + (rg + 8 * i) * kLdF + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = load4(B + (k + kk) * D + n0);
      const float4 b1 = load4(B + (k + kk) * D + D / 2 + n0);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* c = C + (rg + 8 * i) * kLdF + n0;
    store4(c, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    store4(c + D / 2, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
  }
}

// Start the copy of the row-major (D x D) float32 matrix W into shared
// memory at `dst` (row-major, unpadded), by all the block's threads; the
// caller commits the group.
__device__ __forceinline__ void stage_matrix_f32(uint32_t dst, const float* W) {
  for (int i = threadIdx.x; i < D * D / 4; i += blockDim.x) tc::cp_async16(dst + 16 * i, W + 4 * i);
}

// The row pass's float32 B operands stream through shared memory in k-slabs
// of kSlabRows rows (16 KB), a ring of kSlabStages of them: a whole float32
// (D x D) matrix is 64 KB, and a ring of two would leave one block an SM.
constexpr int kSlabRows = 32;
constexpr int kSlabBytes = kSlabRows * D * 4;
constexpr int kSlabStages = 3;
static_assert(kRowsTile == 32 && kThreadsC == 256,
              "slab_fma: 8 warps of 16 columns, kC rows a lane");
// slab_fma's warp grid: kSlabWN warps of 16 columns across D, kSlabWR down
// the rows (1 at D = 128: each warp all 32 rows), each D / 4 rows, kC a lane.
constexpr int kSlabWN = D / 16;
constexpr int kSlabWR = (kThreadsC / 32) / kSlabWN;
static_assert(kSlabWR * kSlabWN == kThreadsC / 32, "slab_fma's warp grid");

// The thread's first output row and column in slab_fma's grid.
__device__ __forceinline__ int slab_row0() {
  const int warp = threadIdx.x >> 5;
  return (kSlabWR == 1 ? 0 : (warp / kSlabWN) * (D / 4)) + (threadIdx.x & 7);
}
__device__ __forceinline__ int slab_col0() {
  const int warp = threadIdx.x >> 5;
  return (kSlabWR == 1 ? warp : warp % kSlabWN) * 16 + 4 * ((threadIdx.x & 31) >> 3);
}

// Start the copy of kSlabRows rows of a row-major float32 matrix (W at its
// first row) into the slab at `stage`, by all the block's threads; the
// caller commits the group.
__device__ __forceinline__ void stage_slab(uint32_t stage, const float* W) {
  for (int i = threadIdx.x; i < kSlabRows * D / 4; i += blockDim.x)
    tc::cp_async16(stage + 16 * i, W + 4 * i);
}

// acc += A[:, k0 : k0 + kSlabRows] @ S for the thread's kC x 4 outputs of
// a (kRowsTile x D) product: A (kRowsTile x D float32, row stride kLdF,
// shared), S a staged slab (kSlabRows x D).  Warp w owns columns 16 (w %
// kSlabWN) .. + 15 (at D = 128 as `tile_gemm_smem`'s warps do) of rows
// (w / kSlabWN) D / 4 .. + D / 4 - 1, lane l rows l % 8 + 8 i of those and
// columns 4 (l / 8) + j of the warp's.
__device__ __forceinline__ void slab_fma(const float* A, int k0, const float* S,
                                         float (&acc)[kC][4]) {
  const int r0 = slab_row0(), n0 = slab_col0();
#pragma unroll 2
  for (int k = 0; k < kSlabRows; k += 4) {
    float4 a[kC];
#pragma unroll
    for (int i = 0; i < kC; ++i) a[i] = load4(A + (r0 + 8 * i) * kLdF + k0 + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b = load4(S + (k + kk) * D + n0);
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
        acc[i][0] = fmaf(av, b.x, acc[i][0]);
        acc[i][1] = fmaf(av, b.y, acc[i][1]);
        acc[i][2] = fmaf(av, b.z, acc[i][2]);
        acc[i][3] = fmaf(av, b.w, acc[i][3]);
      }
    }
  }
}

// C (kRowsTile x D, row stride kLdF) = the thread's `slab_fma` outputs.
__device__ __forceinline__ void slab_store(const float (&acc)[kC][4], float* C) {
  const int r0 = slab_row0(), n0 = slab_col0();
#pragma unroll
  for (int i = 0; i < kC; ++i)
    store4(C + (r0 + 8 * i) * kLdF + n0, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
}

// The thread's `slab_fma` outputs read from C (a product that adds to C).
__device__ __forceinline__ void slab_load(float (&acc)[kC][4], const float* C) {
  const int r0 = slab_row0(), n0 = slab_col0();
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const float4 v = load4(C + (r0 + 8 * i) * kLdF + n0);
    acc[i][0] = v.x;
    acc[i][1] = v.y;
    acc[i][2] = v.z;
    acc[i][3] = v.w;
  }
}

__device__ __forceinline__ float gelu_tanh(float u) {
  return 0.5f * u * (1.f + tanhf(0.7978845608028654f * (u + 0.044715f * u * u * u)));
}

// jax.nn.gelu(approximate=True) on a bf16 value in bf16 arithmetic, as the
// JAX kernel's FFN runs it in the bf16-VPU mode: its two constants and the
// result of every op rounded to bf16, in jax's order of operations.
__device__ __forceinline__ float gelu_tanh_vpu_bf16(float x) {
  const float c1 = round_bf16(0.7978845608028654f), c2 = round_bf16(0.044715f);
  const float x3 = round_bf16(x * round_bf16(x * x));
  const float s = round_bf16(x + round_bf16(c2 * x3));
  const float cdf = round_bf16(0.5f * round_bf16(1.f + round_bf16(tanhf(round_bf16(c1 * s)))));
  return round_bf16(x * cdf);
}

// The KV pass of one layer (decoder_stack.cu): per-tile partials over the
// first t_valid rows of x (float32 or, with x_bf16, bf16; rows of stride D,
// T rows a clip), then the combine into the bf16 block-diagonal KV.  With
// `stats` and `kvr` (K6), it also writes each column's softmax max and sum
// of exp (B, 2, D), and KVr = k_sm^T bf16(v) in float32 (B, D, dh).
cudaError_t launch_kv_pass(const void* x, bool x_bf16, const bf16* mats, const float* vecs,
                           float* partials, bf16* kv, float* stats, float* kvr, int B, int T,
                           int t_valid, int dh, cudaStream_t stream);

// K6's float32 mode: the same pass on float32 x and mats into the float32
// KV, unrounded, and the column statistics (no KVr: it is KV itself).
cudaError_t launch_kv_pass_f32(const float* x, const float* mats, const float* vecs,
                               float* partials, float* kv, float* stats, int B, int T,
                               int t_valid, int dh, cudaStream_t stream);

// Bytes of the `partials` scratch that the KV pass needs: bf16, with or
// without KVr, or float32 (f32, with the statistics).
size_t kv_pass_partials_bytes(int B, int t_valid, int dh, bool with_kvr, bool f32);

}  // namespace LAYER_WIDTH_NS
}  // namespace layer

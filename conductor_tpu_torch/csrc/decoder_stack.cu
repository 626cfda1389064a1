// K1: all decoder layers of one denoiser step, and K5: one decoder layer.
//
// K1 replaces conductor_tpu/ops/pallas_layer.py::fused_decoder_stack (layer
// body `_layer_body` :60-160, `_stack_kernel` :177-207, pallas_call at
// :317); K5 replaces ::fused_decoder_layer (`_layer_kernel` :163-174,
// pallas_call at :233), the forward of the training layer.  Per layer: AdaLN
// modulation mod = emb_act @ W_adaln + b -> LN -> q, k, v -> q feature-softmax
// per head, k softmax over the whole clip, KV = k_sm^T v (float32,
// block-diagonal) -> q_sm @ KV -> StylizationBlock + residual ->
// cross-attention q_sm @ KV_cross -> StylizationBlock + residual -> tanh-GELU
// FFN -> StylizationBlock + residual.
//
// What bounds it on an H100: per step and clip it is ~2*T*(E*6D + 11*D^2)*L
// = 16.5 GFLOP of small-K matrix products (the AdaLN product is ~69 %), so
// tensor cores are the unit to use; the data (residual 0.9 MB, emb_act
// 1.8 MB bf16 per clip, 1.0 MB of weights a layer) fits in the 50 MB L2.
// The TPU kernel holds a whole (T = 1800, D) clip in VMEM per grid step; a
// Hopper block has 227 KB of shared memory, and k's time softmax and KV are
// reductions over all T rows.  Design: one GEMM launch a step (G), then
// three launches a layer (A, B, C):
//   A  kv_partials (4 warps, 64-row tiles): LN -> k, v (bf16 WMMA, float32
//      accumulation) and, per tile, k's column max m, sum of exp(k - m) and
//      the block-diagonal partial exp(k - m)^T v, online-softmax style, in
//      float32.  Rows >= T are left out (the TPU kernel masks its pad rows
//      with k = -1e6, v = 0, which gives them exactly zero weight).
//   B  kv_combine: rescales and sums the tile partials into KV, then rounds
//      it to bf16 as the JAX kernel does before its q_sm @ KV product.
//   G  the AdaLN GEMM (adaln_gemm.cu): mod for all B T rows and all L
//      layers in one launch before layer 0, float32 (B T, 6D L), bias
//      added; each layer's pass C reads its 6D columns.  One launch a layer,
//      right before its pass C so that its 11 MB (B = 2) or 44 MB (B = 8)
//      stay in L2, was measured against it while this design was made: no
//      faster at B = 1 and 2 and slower at B = 8, as eight launches of 2-3
//      waves each lose more to their ramps and tails than pass C loses
//      reading mod from device memory (88 MB at B = 2, 354 MB at B = 8).
//   C  layer_rows (8 warps): the rest of the layer on a tile of 32 rows.
//      Its nine (32 x D) @ (D x D) products (`tile_gemm_smem`: mma.sync
//      m16n8k16, A and B fragments by ldmatrix) take their B operand from
//      shared memory: each weight matrix (and KV_self, KV_cross) is staged
//      by 16-byte cp.async into a 2-stage ring (2 x 32 KB, swizzled) two
//      products ahead, so the next matrices arrive while this one
//      multiplies.  The AdaLN step reads its rows of mod from global memory,
//      coalesced.  Shared memory: the ring, the tile's residual rows
//      and matmul output (float32) and the bf16 operand, 105.5 KB at 32
//      rows: two blocks an SM, and twice the blocks of 64-row tiles (57 a
//      clip at T = 1800 against 29, on 132 SMs).  64-row tiles (147 KB, one
//      block an SM) were slower at B = 1, 2 and 8 while this design was
//      made, though each block stages the same 288 KB of weights for half
//      the rows.
// Shared-memory rows of the float32 and bf16 tiles are padded (+4, +8
// elements), so the 8 rows of an ldmatrix or the 16 of a WMMA tile fall on
// different banks.  The first design computed mod inside pass C per tile,
// each warp reading its weight fragments from L2 (a chain of dependent
// loads bounded it), and held the AdaLN operands in 133 KB of pass C's
// shared memory.  Row-wise work (LayerNorm, softmax, AdaLN, GELU, residual)
// runs one warp per 16 (pass A) or 4 (pass C) rows.  The residual
// stream lives in device memory between launches (in place after layer 0).
//
// K1's two opt-in serving modes:
//   int8 AdaLN (`_stack_kernel` :182-201, `_layer_body` :113-118): emb_act
//      arrives as int8 rows with float32 row scales (K2 quantizes it once a
//      step) and adaln_w as int8 with float32 column scales.  Only the GEMM
//      changes: s8 mma.sync m16n8k32 into int32, dequantized in JAX's order,
//      acc * (srow * scol) + ab; pass C gets the same float32 mod.
//   bf16 VPU (`_layer_body` :98, 102-105, 154): a template flag of pass C.
//      The q feature-softmax exp, the StylizationBlock SiLU and the FFN GELU
//      round their argument and every op's result to bf16, where JAX casts
//      to bf16 (jax.nn.gelu's constants too); LN statistics, the time
//      softmax, KV and the residual stay float32.
//
// K1's float32 mode (`mxu_dtype=float32`, `_layer_body`'s `md` casting to
// float32): every product takes float32 operands, as JAX's does, so the
// operand type OT is a template parameter of the passes.  The tensor cores
// have no float32 product (TF32 keeps about three digits), so the products
// run as FFMA on the CUDA cores, each output one chain over k in ascending
// order, and the operations bound it: 33 GFLOP a step at B = 2, 0.49 ms at
// the card's 67 TFLOP/s, 69 % of it the AdaLN GEMM.  Pass A by
// `block_gemm_f32` (a thread 8 x 8 outputs, Wk then Wv staged whole in
// shared memory, 163 KB a block; at T = 1800 a clip has 29 blocks, so one
// block an SM costs no occupancy), pass C by `slab_fma` (a thread 4 x 4
// outputs; each (D x D) float32 matrix, 64 KB, streams through a ring of
// three 32-row k-slabs, 48 KB, two slabs ahead, so that pass C keeps 97.5
// KB and two blocks an SM), and the AdaLN GEMM by its float32 kernel
// (adaln_gemm.cu).  KV leaves pass B
// unrounded, the q softmax's head sums are of float32 values, and the
// bf16-VPU mode rounds its three chains as in the bf16 mode; with int8
// AdaLN the GEMM is the int8 one and the passes float32.
//
// Widths (layer_common.cuh): D = 32, 64 or 128, each its own compile-time
// instantiation; a head width dh dividing 32 (8, 16 or 32), since the
// head sums are shuffles inside a warp.  Pass A gives each of its D threads
// a column (one warp at D = 32); pass C's 8 warps tile each product by
// `tile_gemm_smem`'s warp grid (16 columns of 32 rows a warp at D = 128, 8
// columns of 32 or 16 rows below) and its row-wise work gives a lane D / 32
// columns.  The AdaLN GEMM's N = 6D is 192 at D = 32, which its 64-column
// tiles take (adaln_gemm.cu).  Wider models (D = 256) do not fit this
// design's shared memory: pass A's float32 mode stages Wk and Wv whole.
//
// K5 is one layer of the same four launches (`decoder_layer_forward`), with
// the residual read and written in the compute dtype (the training path
// carries it so between layers, JAX `train/fused_denoiser.py:304-323`) and
// float32 inside: bf16, or in K5's float32 mode (`mxu_f32`) float32, with
// K1's float32 passes and GEMM.  Its input is padded to whole 64-row tiles;
// rows at or past t_valid are left out of the KV pass, as the TPU kernel
// masks them (a -1e6 key and a zero value, which give them exactly zero
// weight), and still computed by the row pass.

#include <type_traits>

#include "adaln_gemm.cuh"
#include "layer_common.cuh"

using namespace layer;

namespace {

// ---------------------------------------------------------------- pass A
// A tile's partials: the column max and sum, the partial KV and, with
// kKvrRounded, the partial KVr.
template <typename OT, bool kKvr>
constexpr bool kKvrRounded = kKvr && !std::is_same<OT, float>::value;
template <typename OT, bool kKvr>
__host__ __device__ constexpr int partial_stride(int dh) {
  return 2 * D + (kKvrRounded<OT, kKvr> ? 2 : 1) * D * dh;
}

// XT: the residual's storage type (float for K1, bf16 or float for K5 /
// K6); OT: the products' operand type (bf16, or float in the float32
// modes).  With kKvr (K6) pass B also writes each column's softmax
// statistics, and in bf16 each tile also gives exp(k - m)^T bf16(v),
// block-diagonal (in float32 that is KV itself).
template <typename XT, typename OT, bool kKvr>
__global__ void __launch_bounds__(kThreadsA)
kv_partials_kernel(const XT* x, const OT* __restrict__ mats, const float* __restrict__ vecs,
                   float* __restrict__ partials, int T, int t_valid, int dh, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  OT* a_s = reinterpret_cast<OT*>(smem);                                          // (64, kLdOp)
  float* k_s = reinterpret_cast<float*>(smem + kTileRows * kLdOp<OT> * sizeof(OT));  // (64, kLdF)
  float* v_s = k_s + kTileRows * kLdF;                                            // (64, kLdF)
  constexpr bool kF32 = std::is_same<OT, float>::value;
  // float32: Wk, then Wv, staged whole (64 KB) after v_s
  const uint32_t w_s = tc::smem_addr(v_s + kTileRows * kLdF);
  const int b = blockIdx.y, tile = blockIdx.x;
  const int wid = threadIdx.x >> 5;
  const int row0 = tile * kTileRows;
  const int n_rows = min(kTileRows, t_valid - row0);
  const float* vec = vecs;
  if constexpr (kF32) {
    stage_matrix_f32(w_s, mats + kWk * D * D);  // lands while the rows load and LN runs
    tc::cp_async_commit();
  }

  // the tile's rows (zeros past t_valid), staged in k_s, then LN into a_s
  for (int i = threadIdx.x; i < kTileRows * D / 4; i += kThreadsA) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i / (D / 4) < n_rows) v = load4(x + ((size_t)b * T + row0) * D + 4 * i);
    store4(k_s + (i / (D / 4)) * kLdF + (i % (D / 4)) * 4, v);
  }
  __syncthreads();
  warp_ln<kRowsA>(k_s + wid * kRowsA * kLdF, vec + kLnSelfG * D, vec + kLnSelfB * D,
                  a_s + wid * kRowsA * kLdOp<OT>);
  __syncthreads();
  if constexpr (kF32) {
    const float* w = v_s + kTileRows * kLdF;
    tc::cp_async_wait<0>();
    __syncthreads();
    block_gemm_f32(a_s, w, k_s);
    __syncthreads();
    stage_matrix_f32(w_s, mats + kWv * D * D);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    block_gemm_f32(a_s, w, v_s);
  } else {
    block_gemm(a_s, kLdA, mats + kWk * D * D, D, D, D, k_s, kLdF);
    block_gemm(a_s, kLdA, mats + kWv * D * D, D, D, D, v_s, kLdF);
  }
  __syncthreads();

  constexpr bool kRounded = kKvrRounded<OT, kKvr>;
  const int stride = partial_stride<OT, kKvr>(dh);
  float* part = partials + ((size_t)b * n_tiles + tile) * stride;
  {
    const int c = threadIdx.x;  // one column per thread (kThreadsA == D)
    const float bk = vec[kBk * D + c], bv = vec[kBv * D + c];
    float m = -CUDART_INF_F;
    for (int r = 0; r < n_rows; ++r) m = fmaxf(m, k_s[r * kLdF + c] + bk);
    float s = 0.f;
    for (int r = 0; r < kTileRows; ++r) {
      const bool valid = r < n_rows;
      const float e = valid ? expf(k_s[r * kLdF + c] + bk - m) : 0.f;
      k_s[r * kLdF + c] = e;
      v_s[r * kLdF + c] = valid ? v_s[r * kLdF + c] + bv : 0.f;
      s += e;
    }
    part[c] = m;
    part[D + c] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D * dh; i += blockDim.x) {
    const int d = i / dh, l = (d / dh) * dh + i % dh;
    float acc = 0.f, acc_r = 0.f;
    for (int r = 0; r < n_rows; ++r) {
      acc = fmaf(k_s[r * kLdF + d], v_s[r * kLdF + l], acc);
      if (kRounded) acc_r = fmaf(k_s[r * kLdF + d], round_bf16(v_s[r * kLdF + l]), acc_r);
    }
    part[2 * D + i] = acc;
    if (kRounded) part[2 * D + D * dh + i] = acc_r;
  }
}

// ---------------------------------------------------------------- pass B
// KV in the operand type OT: rounded to bf16, or in the float32 mode as is;
// with kKvr the column statistics and, in bf16, KVr.
template <typename OT, bool kKvr>
__global__ void kv_combine_kernel(const float* __restrict__ partials, OT* __restrict__ kv,
                                  float* __restrict__ stats, float* __restrict__ kvr,
                                  int n_tiles, int dh) {
  const int b = blockIdx.y, d = blockIdx.x, l = threadIdx.x;
  OT* out = kv + ((size_t)b * D + d) * D + l;
  if (d / dh != l / dh) {
    put(out, 0.f);
    return;
  }
  constexpr bool kRounded = kKvrRounded<OT, kKvr>;
  const int stride = partial_stride<OT, kKvr>(dh);
  const float* p = partials + (size_t)b * n_tiles * stride;
  float m = -CUDART_INF_F;
  for (int t = 0; t < n_tiles; ++t) m = fmaxf(m, p[t * stride + d]);
  float s = 0.f, acc = 0.f, acc_r = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const float w = expf(p[t * stride + d] - m);
    s = fmaf(p[t * stride + D + d], w, s);
    acc = fmaf(p[t * stride + 2 * D + d * dh + l % dh], w, acc);
    if (kRounded) acc_r = fmaf(p[t * stride + 2 * D + D * dh + d * dh + l % dh], w, acc_r);
  }
  put(out, acc / s);
  if (kRounded) kvr[((size_t)b * D + d) * dh + l % dh] = acc_r / s;
  if (kKvr) {
    if (l == d) {
      stats[(size_t)b * 2 * D + d] = m;
      stats[(size_t)b * 2 * D + D + d] = s;
    }
  }
}

// ---------------------------------------------------------------- pass C
// Shared bytes of pass C's ring of B operands: two whole bf16 matrices, or
// kSlabStages float32 k-slabs.
template <typename OT>
constexpr size_t kRingBytes =
    std::is_same<OT, float>::value ? (size_t)kSlabStages * kSlabBytes : 2 * (size_t)kWeightTile;

// mod: the layer's AdaLN modulation (adaln_gemm.cu), row stride ldmod.
// OT: the products' operand type (bf16; float in K1's float32 mode).
// kVpuBf16: the three elementwise chains of JAX's bf16-VPU mode (head
// softmax exp, StylizationBlock SiLU, FFN GELU) round where JAX's
// `_layer_body` casts to bf16.  K5 runs <bf16, bf16, false>.
template <typename XT, typename OT, bool kVpuBf16>
__global__ void __launch_bounds__(kThreadsC, 2)
layer_rows_kernel(const XT* x_in, XT* x_out, const float* __restrict__ mod, int ldmod,
                  const OT* __restrict__ kv_self, const OT* __restrict__ kv_cross,
                  const OT* __restrict__ mats, const float* __restrict__ vecs, int T, int dh) {
  constexpr bool kF32 = std::is_same<OT, float>::value;
  constexpr int ROWS = kRowsTile;
  constexpr int kRows = ROWS * 32 / kThreadsC;  // rows a warp in the row-wise phases
  constexpr int kLdO = kLdOp<OT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = tc::smem_addr(smem);                          // the B operands' ring
  float* xs = reinterpret_cast<float*>(smem + kRingBytes<OT>);        // (ROWS, kLdF) residual rows
  float* ys = xs + ROWS * kLdF;                                        // (ROWS, kLdF) matmul output
  OT* as = reinterpret_cast<OT*>(ys + ROWS * kLdF);                    // (ROWS, kLdO) operand
  const int b = blockIdx.y;
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * ROWS;
  const int n_rows = min(ROWS, T - row0);
  // this warp's slices
  const int wo = wid * kRows;
  float *xw = xs + wo * kLdF, *yw = ys + wo * kLdF;
  OT* aw = as + wo * kLdO;
  const float* mw = mod + ((size_t)b * T + row0 + wo) * ldmod;
  const float* vec = vecs;
  auto W = [&](int i) { return mats + (size_t)i * D * D; };

  // the B operands of the nine products, in order; bf16: each staged whole
  // into the ring two products ahead of its use; float32: stage s is k-slab
  // s % 4 of product s / 4, staged two slabs ahead
  const OT* const operand[9] = {W(kWq), kv_self + (size_t)b * D * D, W(kWStylSelf),
                                W(kWqCross), kv_cross + (size_t)b * D * D, W(kWStylCross),
                                W(kW1), W(kW2), W(kWStylFfn)};
  constexpr int kSlabs = D / kSlabRows;  // float32: slabs a product
  auto stage = [&](int i) {
    if constexpr (kF32) {
      if (i < 9 * kSlabs)
        stage_slab(ring + (i % kSlabStages) * kSlabBytes,
                   operand[i / kSlabs] + (size_t)(i % kSlabs) * kSlabRows * D);
    } else {
      if (i < 9) stage_weights(ring + (i & 1) * kWeightTile, operand[i]);
    }
    tc::cp_async_commit();  // one group a stage, empty past the last
  };
  stage(0);
  stage(1);
  for (int i = threadIdx.x; i < ROWS * D / 4; i += kThreadsC) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i / (D / 4) < n_rows) v = load4(x_in + ((size_t)b * T + row0) * D + 4 * i);
    store4(xs + (i / (D / 4)) * kLdF + (i % (D / 4)) * 4, v);
  }
  __syncthreads();

  // ys = as @ (the next product's matrix).  bf16: then stage product next +
  // 2 into the slot it frees.  Both syncs are the block's: as and the slot
  // written before, ys read after.  float32: a slab at a time, each sync
  // also freeing the slot of the slab before, which takes slab next + 2.
  int next = 0;
  auto gemm = [&]() {
    if constexpr (kF32) {
      float acc[kC][4] = {};
      for (int j = 0; j < kSlabs; ++j) {
        tc::cp_async_wait<1>();  // all groups but the newest (slab next + 1)
        __syncthreads();
        stage(next + 2);
        slab_fma(as, j * kSlabRows,
                 reinterpret_cast<const float*>(smem + (next % kSlabStages) * kSlabBytes), acc);
        ++next;
      }
      slab_store(acc, ys);
      __syncthreads();
    } else {
      tc::cp_async_wait<1>();  // all groups but the newest (product next + 1)
      __syncthreads();
      tile_gemm_smem(as, ring + (next & 1) * kWeightTile, ys);
      __syncthreads();
      stage(next + 2);
      ++next;
    }
  };
  // One StylizationBlock + residual on y (in ys): x += silu(AdaLN(y)) @ W + b.
  auto stylize = [&](int j, const float* ybias, int g, int b_out) {
    warp_adaln_mod<kRows, kVpuBf16>(yw, ybias, mw + j * 2 * D, ldmod, n_rows - wo, vec + g * D,
                                    vec + (g + 1) * D, aw);
    gemm();
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const int c = lane + 32 * i;
        xw[r * kLdF + c] += yw[r * kLdF + c] + vec[b_out * D + c];
      }
    __syncwarp();
  };
  // q_sm (into as) for the attention sublayers: LN -> q -> head softmax.
  auto query = [&](int g, int bq) {
    warp_ln<kRows>(xw, vec + g * D, vec + (g + 1) * D, aw);
    gemm();
    warp_head_softmax<kRows, kVpuBf16>(yw, vec + bq * D, dh, aw);
  };

  // self attention
  query(kLnSelfG, kBq);
  gemm();  // q_sm @ KV_self
  stylize(0, nullptr, kStylSelfG, kStylSelfOut);
  // cross attention
  query(kLnCrossG, kBqCross);
  gemm();  // q_sm @ KV_cross
  stylize(1, nullptr, kStylCrossG, kStylCrossOut);
  // FFN (W1 / W2 are zero-padded to D x D)
  for (int i = lane; i < kRows * D; i += 32)
    put(aw + (i / D) * kLdO + i % D, xw[(i / D) * kLdF + i % D]);
  gemm();  // W1
  for (int i = lane; i < kRows * D; i += 32) {
    const float u = yw[(i / D) * kLdF + i % D] + vec[kB1 * D + i % D];
    put(aw + (i / D) * kLdO + i % D, kVpuBf16 ? gelu_tanh_vpu_bf16(round_bf16(u)) : gelu_tanh(u));
  }
  gemm();  // W2
  stylize(2, vec + kB2 * D, kStylFfnG, kStylFfnOut);
  tc::cp_async_wait<0>();
  __syncthreads();

  for (int i = threadIdx.x; i < n_rows * D / 4; i += kThreadsC)
    store4(x_out + ((size_t)b * T + row0) * D + 4 * i,
           load4(xs + (i / (D / 4)) * kLdF + (i % (D / 4)) * 4));
}

// pass A's shared bytes: the operand, k and v tiles (and in the float32
// mode the staged weight matrix)
template <typename OT>
constexpr size_t kSmemA = (size_t)kTileRows * (kLdOp<OT> * sizeof(OT) + 2 * kLdF * 4) +
                          (std::is_same<OT, float>::value ? (size_t)D * D * 4 : 0);

template <typename XT, typename OT, bool kKvr>
cudaError_t kv_pass(const XT* x, const OT* mats, const float* vecs, float* partials, OT* kv,
                    float* stats, float* kvr, int B, int T, int t_valid, int dh,
                    cudaStream_t s) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(kv_partials_kernel<XT, OT, kKvr>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemA<OT>);
  if (attr != cudaSuccess) return attr;
  const int n_tiles = ceil_div(t_valid, kTileRows);
  kv_partials_kernel<XT, OT, kKvr><<<dim3(n_tiles, B), kThreadsA, kSmemA<OT>, s>>>(
      x, mats, vecs, partials, T, t_valid, dh, n_tiles);
  kv_combine_kernel<OT, kKvr><<<dim3(D, B), D, 0, s>>>(partials, kv, stats, kvr, n_tiles, dh);
  return cudaGetLastError();
}

bool bad_shape(int d, int E, int H) {
  const int dh = d / H;
  return d != D || E % 16 != 0 || dh * H != d || 32 % dh != 0;
}

}  // namespace

namespace layer {
inline namespace LAYER_WIDTH_NS {

cudaError_t launch_kv_pass_f32(const float* x, const float* mats, const float* vecs,
                               float* partials, float* kv, float* stats, int B, int T,
                               int t_valid, int dh, cudaStream_t stream) {
  return kv_pass<float, float, true>(x, mats, vecs, partials, kv, stats, nullptr, B, T, t_valid,
                                     dh, stream);
}

cudaError_t launch_kv_pass(const void* x, bool x_bf16, const bf16* mats, const float* vecs,
                           float* partials, bf16* kv, float* stats, float* kvr, int B, int T,
                           int t_valid, int dh, cudaStream_t stream) {
  if (kvr != nullptr)
    return x_bf16 ? kv_pass<bf16, bf16, true>(static_cast<const bf16*>(x), mats, vecs, partials,
                                              kv, stats, kvr, B, T, t_valid, dh, stream)
                  : kv_pass<float, bf16, true>(static_cast<const float*>(x), mats, vecs, partials,
                                               kv, stats, kvr, B, T, t_valid, dh, stream);
  return x_bf16 ? kv_pass<bf16, bf16, false>(static_cast<const bf16*>(x), mats, vecs, partials,
                                             kv, stats, kvr, B, T, t_valid, dh, stream)
                : kv_pass<float, bf16, false>(static_cast<const float*>(x), mats, vecs, partials,
                                              kv, stats, kvr, B, T, t_valid, dh, stream);
}

size_t kv_pass_partials_bytes(int B, int t_valid, int dh, bool with_kvr, bool f32) {
  const int stride = f32 ? partial_stride<float, true>(dh)
                         : with_kvr ? partial_stride<bf16, true>(dh) : partial_stride<bf16, false>(dh);
  return (size_t)B * ceil_div(t_valid, kTileRows) * stride * 4;
}

}  // namespace LAYER_WIDTH_NS
}  // namespace layer


namespace {

template <typename OT>
constexpr size_t kSmemC =
    kRingBytes<OT> + (size_t)kRowsTile * (2 * kLdF * 4 + kLdOp<OT> * sizeof(OT));

template <typename XT, typename OT, bool kVpuBf16>
cudaError_t rows_pass(const XT* x, XT* out, const float* mod, int ldmod, const OT* kv_self,
                      const OT* kv_cross, const OT* mats, const float* vecs, int B, int T,
                      int dh, cudaStream_t s) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(layer_rows_kernel<XT, OT, kVpuBf16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemC<OT>);
  if (attr != cudaSuccess) return attr;
  layer_rows_kernel<XT, OT, kVpuBf16>
      <<<dim3(ceil_div(T, kRowsTile), B), kThreadsC, kSmemC<OT>, s>>>(
          x, out, mod, ldmod, kv_self, kv_cross, mats, vecs, T, dh);
  return cudaGetLastError();
}

// One layer after its AdaLN GEMM: passes A and B, then C.
template <typename XT, typename OT, bool kVpuBf16>
cudaError_t layer_passes(const XT* x, XT* out, const float* mod, int ldmod, const OT* kv_cross,
                         const OT* mats, const float* vecs, float* partials, OT* kv_self, int B,
                         int T, int t_valid, int dh, cudaStream_t s) {
  cudaError_t err = kv_pass<XT, OT, false>(x, mats, vecs, partials, kv_self, nullptr, nullptr, B,
                                           T, t_valid, dh, s);
  if (err != cudaSuccess) return err;
  return rows_pass<XT, OT, kVpuBf16>(x, out, mod, ldmod, kv_self, kv_cross, mats, vecs, B, T, dh,
                                     s);
}

// adaln_w: (L, E, 6D) in the GEMM's operand type `operands` (AdalnOperands);
// mod: (B T, 6D L) float32 scratch; *gemm_launches counts the AdaLN GEMM's
// launches.  OT: the passes' operand type (mats, kv_cross, kv_self).
template <typename OT, bool kVpuBf16>
cudaError_t stack_forward(const void* x, const void* emb, const void* emb_scale,
                          const void* kv_cross, const void* mats, const void* vecs,
                          const void* adaln_w, const void* aw_scale, const void* adaln_b,
                          void* out, void* partials, void* kv_self, void* mod, int B, int T,
                          int E, int dh, int L, int operands, int* gemm_launches,
                          cudaStream_t s) {
  constexpr int N = 6 * D;
  float* o = static_cast<float*>(out);
  float* m = static_cast<float*>(mod);
  cudaError_t err = launch_adaln_gemm(emb, adaln_w, static_cast<const float*>(emb_scale),
                                      static_cast<const float*>(aw_scale),
                                      static_cast<const float*>(adaln_b), m, L * N, B * T, E, N,
                                      L, operands, gemm_launches, s);
  for (int l = 0; l < L && err == cudaSuccess; ++l)
    err = layer_passes<float, OT, kVpuBf16>(
        l == 0 ? static_cast<const float*>(x) : o, o, m + l * N, L * N,
        static_cast<const OT*>(kv_cross) + (size_t)l * B * D * D,
        static_cast<const OT*>(mats) + (size_t)l * 9 * D * D,
        static_cast<const float*>(vecs) + (size_t)l * 24 * D, static_cast<float*>(partials),
        static_cast<OT*>(kv_self), B, T, T, dh, s);
  return err;
}

}  // namespace

// emb_scale / aw_scale are null unless int8: the int8-AdaLN mode (emb and
// adaln_w int8); vpu_bf16: the bf16-VPU mode; mxu_f32: the float32 mode
// (mats, kv_cross and kv_self float32; emb and adaln_w float32 unless
// int8), else bf16.  mod: (B T, 6D L) float32 scratch.  gemm_launches
// (int, host): raised by one for each launch of the AdaLN GEMM.
CT_EXPORT int LAYER_EXPORT(decoder_stack_forward)(const void* x, const void* emb, const void* emb_scale,
                                    const void* kv_cross, const void* mats, const void* vecs,
                                    const void* adaln_w, const void* aw_scale,
                                    const void* adaln_b, void* out, void* partials,
                                    void* kv_self, void* mod, void* gemm_launches, int B, int T,
                                    int d, int E, int H, int L, int int8, int vpu_bf16,
                                    int mxu_f32, void* stream) {
  const int operands = int8 ? kAdalnInt8 : mxu_f32 ? kAdalnF32 : kAdalnBf16;
  if (bad_shape(d, E, H) || !adaln_gemm_takes(E, 6 * d, operands) ||
      (int8 && (emb_scale == nullptr || aw_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto launch) {
    return (int)launch(x, emb, emb_scale, kv_cross, mats, vecs, adaln_w, aw_scale, adaln_b, out,
                       partials, kv_self, mod, B, T, E, d / H, L, operands,
                       static_cast<int*>(gemm_launches), static_cast<cudaStream_t>(stream));
  };
  if (mxu_f32) return vpu_bf16 ? run(stack_forward<float, true>) : run(stack_forward<float, false>);
  return vpu_bf16 ? run(stack_forward<bf16, true>) : run(stack_forward<bf16, false>);
}

// mod: (B T, 6D) float32 scratch; gemm_launches as decoder_stack_forward's.
// mxu_f32: K5's float32 mode (x, out, emb, kv_cross, mats, adaln_w and
// kv_self float32), else bf16.
CT_EXPORT int LAYER_EXPORT(decoder_layer_forward)(const void* x, const void* emb, const void* kv_cross,
                                    const void* mats, const void* vecs, const void* adaln_w,
                                    const void* adaln_b, void* out, void* partials,
                                    void* kv_self, void* mod, void* gemm_launches, int B, int T,
                                    int t_valid, int d, int E, int H, int mxu_f32,
                                    void* stream) {
  const int operands = mxu_f32 ? kAdalnF32 : kAdalnBf16;
  if (bad_shape(d, E, H) || !adaln_gemm_takes(E, 6 * d, operands) || t_valid < 1 ||
      t_valid > T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mod);
  cudaError_t err = launch_adaln_gemm(emb, adaln_w, nullptr, nullptr,
                                      static_cast<const float*>(adaln_b), m, 6 * D, B * T, E,
                                      6 * D, 1, operands, static_cast<int*>(gemm_launches), s);
  if (err != cudaSuccess) return (int)err;
  auto run = [&](auto* typed) {
    using T_ = std::remove_pointer_t<decltype(typed)>;
    return (int)layer_passes<T_, T_, false>(
        static_cast<const T_*>(x), static_cast<T_*>(out), m, 6 * D,
        static_cast<const T_*>(kv_cross), static_cast<const T_*>(mats),
        static_cast<const float*>(vecs), static_cast<float*>(partials),
        static_cast<T_*>(kv_self), B, T, t_valid, d / H, s);
  };
  return mxu_f32 ? run(static_cast<float*>(nullptr)) : run(static_cast<bf16*>(nullptr));
}

// The launches of one layer at this width for clips of T rows (t_valid of
// them in the KV pass), as kv_pass and rows_pass make them, in the float32
// mode (f32) or bf16: {pass A's threads, tiles a clip, shared bytes; pass
// B's threads, blocks a clip; pass C's threads, tiles a clip, shared bytes}
// (ops/decoder_stack.py `plan` computes the same).
CT_EXPORT int LAYER_EXPORT(decoder_stack_plan)(int T, int t_valid, int f32, int* out) {
  const int v[8] = {kThreadsA, ceil_div(t_valid, kTileRows),
                    (int)(f32 ? kSmemA<float> : kSmemA<bf16>), D, D, kThreadsC,
                    ceil_div(T, kRowsTile), (int)(f32 ? kSmemC<float> : kSmemC<bf16>)};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// K6: the backward of one decoder layer.
//
// Replaces conductor_tpu/ops/pallas_layer_bwd.py::fused_decoder_layer_train's
// backward (`_layer_bwd_kernel` :74-296, pallas_call at :321).  Given the
// layer's inputs (x bf16 (B, T, D), emb_act bf16 (B, T, E), kv_cross bf16
// (B, D, D), the weight banks) and dy (B, T, D), it emits dx, d_emb_act,
// d_kv_cross (in the inputs' dtypes) and d_mats (9, D, D), d_vecs (24, D),
// d_adaln_w (E, 6D), d_adaln_b (6D) in float32, with the JAX kernel's
// numerics: bf16 matmul operands with float32 accumulation, float32
// elementwise work, the AdaLN modulation `mod` in float32, d_emb rounded to
// bf16 per sublayer and summed in bf16 (FFN, then cross, then self), rows
// at or past t_valid carrying a -1e6 key, zero value and no gradient.
//
// What bounds it on an H100.  At the stage-2 step's shape (B = 32, T = 900
// padded to 960: 30,720 rows) a layer's backward is ~110 GFLOP of bf16
// products: the AdaLN product, d_adaln_w = emb^T dMod and d_emb = dMod aw^T
// are ~24 GFLOP each (2 * 30,720 * 512 * 768), the ~37 D x D products and
// their weight gradients the rest; that is 0.11 ms at the bf16 tensor-core
// rate.  The per-row intermediates that the launches hand each other (19
// bf16 and 8 float32 (B T, D) arrays, dMod, `mod`; ~0.5 GB written and read
// once) take ~0.3 ms at 3.35 TB/s, so bytes bound it, with the products
// close behind, and neither is reached unless every product runs on tensor
// cores from staged tiles.  The TPU kernel holds a whole clip in VMEM and
// accumulates the weight gradients over a sequential batch grid; Hopper
// blocks run in parallel and hold 64 rows.
//
// Design, per layer, one C call:
//   1. the AdaLN GEMM (adaln_gemm.cu, as K1 / K5 launch it): mod = emb_act
//      @ adaln_w + adaln_b, float32 (B T, 6D), bias added once, here.
//   2. KV pass (decoder_stack.cu, bf16 x): KV_self as in K5, plus each
//      column's softmax max and sum (so rows can rebuild k_sm) and KVr =
//      k_sm^T bf16(v), float32.
//   3. rows1 (32-row tiles, 8 warps, two blocks an SM): recompute the
//      forward (q_sm, y1, x1, qc_sm, y2, x2, z, h1, y3), then the backward
//      of the FFN, the cross attention and the self-attention's
//      StylizationBlock and query, down to dq and dx1.  Its AdaLN steps read
//      their rows of mod, coalesced, as K1's row pass does; no AdaLN product
//      is left in it.  Writes the bf16 operands of every weight gradient,
//      dMod (B T, 6D) and per-warp column sums (bias, LN and d_adaln_b
//      gradients).
//   4. dKV = q_sm^T dy1 and dKV_cross = qc_sm^T dy2 per clip (atb), summed
//      over row chunks (sum).
//   5. combine: dKV * seg to bf16, and the softmax backward's column sums
//      c = sum_l bf16(dKV)[d, l] * KVr[d, l] (= sum_t k_sm * dk_sm, using
//      sum_t k_sm v = KVr, exact in the JAX kernel's roundings), dKV_cross
//      to bf16.
//   6. rows2 (as rows1): rebuild k_sm and v, dk = k_sm (v dKV^T - c), dv =
//      k_sm dKV, dxn = dq Wq^T + dk Wk^T + dv Wv^T, the first LayerNorm's
//      backward, dx = dx1 + dLN.
//   7. the nine d_mats and d_adaln_w = emb^T dMod: one A^T B launch (atb)
//      over 128 x 128 output tiles, each block reducing one chunk of the
//      B T rows, so that the grid gives every SM two blocks whatever B is;
//      then a sum of the chunks in chunk order.
//   8. the column sums, in slot order, in two passes.
//   9. d_emb = dMod_k aw_k^T for the three sublayers (demb), each rounded
//      to bf16 and added in bf16 in the JAX kernel's order.
// The row passes' D x D products (16 in rows1, 7 in rows2) take their B
// operand from shared memory: each weight, KV_self, KV_cross or dKV is
// staged by 16-byte cp.async into a 2-stage ring (2 x 32 KB, swizzled) two
// products ahead, and multiplied by mma.sync m16n8k16 (`tile_gemm_smem`,
// the backward's products A @ W^T by plain ldmatrix on the staged rows of
// W).  64-row tiles (149 KB, one block an SM) were slower than these
// 32-row ones at B = 4 and 32 while this design was made.  The A^T B and
// d_emb GEMMs are mma.sync on tiles that 16-byte cp.async brings into a
// 3-stage XOR-swizzled ring (96 KB, two blocks an SM): A^T fragments by
// ldmatrix.trans from the row-major tiles (as K9's conv_train.cu), B by
// ldmatrix(.trans).  Every sum runs in a fixed order and no atomics are
// used: a repeat is bit-identical.  The chunk count depends on B only
// through the rows there are, so B = 4 and B = 32 sum in different orders
// (within float32 rounding).
//
// K6's float32 mode (`mxu_dtype=float32`: the JAX kernel's `md` and dots on
// float32 operands).  x, emb_act, kv_cross, the weight banks and dy arrive
// in float32 and every product takes them unrounded, as FFMA on the CUDA
// cores (TF32 keeps about three digits), each output one chain over k in
// ascending order; the per-row intermediates are float32; the softmax
// backward's column sums read the unrounded dKV and KV (KVr is KV itself
// there); d_emb is one float32 chain over the sublayers' slices of dMod,
// FFN, then cross, then self (the JAX kernel adds the three in that order
// in emb_act's dtype).  At B = 32 that is ~113 GFLOP, 1.7 ms at the card's
// 67 TFLOP/s outside the tensor cores: the operations bound it.  The
// launches are the bf16 mode's: the float32 AdaLN GEMM (adaln_gemm.cu); K1's
// float32 KV pass; the row passes' products on 32-row float32 k-slabs (16
// KB) streamed through a 3-slot cp.async ring (`slab_fma`, as K1's float32
// row pass: 98.7 KB, two blocks an SM), their A @ B^T products reading
// transposed copies of the matrices, KV_self, KV_cross and dKV that
// `transpose_kernel` writes into the workspace (ldmatrix has no float32
// form); the A^T B reductions (`atb_f32_kernel`) as outer products of the
// staged rows of A and B, which need no transpose: a thread 8 x 8 sums of
// a 128 x 128 tile, 32 rows a stage through the same 3-stage ring (96 KB);
// and d_emb (`demb_f32_kernel`) in the float32 AdaLN GEMM's register
// tiling, dMod's and aw's rows stored transposed into shared memory from
// registers.  The sums keep their fixed orders: a repeat is bit-identical.

// Widths (layer_common.cuh): D = 32, 64 or 128, each its own compile-time
// instantiation, head widths dividing 32.  The row passes' products and
// row-wise work tile as K1's pass C does at each width; the A^T B launches
// keep their 128 x 128 output tiles, partial where a D-wide result is
// narrower (staged zeros, sums not stored); d_emb's 128-column tiles cover
// E = 4D (128 at D = 32) whole, and its k-stages of 64 columns a
// sublayer's 2D columns.  D = 256 does not fit: the row passes' two
// float32 tiles and the operand tile beside the ring outgrow a block's
// shared memory.

#include <type_traits>

#include "adaln_gemm.cuh"
#include "layer_common.cuh"

using namespace layer;

namespace {

#define RETURN_IF_ERROR(call)                           \
  do {                                                  \
    const cudaError_t err_ = (call);                    \
    if (err_ != cudaSuccess) return (int)err_;          \
  } while (0)

template <typename OT>
constexpr bool kIsF32 = std::is_same<OT, float>::value;

// Rows of the per-warp column sums: d_vecs rows 0-18 (19-23 stay zero),
// then d_adaln_b as 6 rows of D.
constexpr int kVecUsed = kStylFfnOut + 1;
constexpr int kDabRow = kVecUsed;
constexpr int kVecRows = kVecUsed + 6;
constexpr int kSumGroups = 32;  // first-pass groups of the column sums' slots

// Per-row intermediates kept between the launches, and the reductions'
// scratch; carved out of one workspace.  OT: the products' operand type,
// bf16 or, in the float32 mode, float.
template <typename OT>
struct Work {
  // (B*T, D) in OT: the operands of the weight and KV gradients
  OT *xn, *qs, *xn2, *qcs, *x2b, *h1, *hs1, *hs2, *hs3, *dy3, *dz, *dx2b, *dqc, *dy2, *dx1b,
      *dy1, *dq, *dk, *dv;
  OT* dmod;  // (B*T, 6D)
  // float32 (B*T, D)
  float *qs32, *qcs32, *y1, *y2, *y3, *z, *x1, *dx1;
  float* mod;  // (B*T, 6D): the AdaLN modulation, bias added
  // the KV pass and the combine; dkv32 (2, B, D, D): dKV, then dKV_cross;
  // kvr (bf16 only) KVr
  float *partials, *stats, *kvr, *dkv32, *cvec;
  OT *kv, *dkvb;
  // per-warp column sums (B * T / kRowsTile * 8, kVecRows, D), their first-pass
  // group sums (kSumGroups, kVecRows, D), and the A^T B chunks' partials
  float *vp, *vg, *part;
  // the B operands of the row passes' A @ B^T products: in bf16 the matrices
  // themselves (the MMAs read them transposed); in float32 transposed
  // copies in `tr` (`transpose_kernel`): mats (9, D, D), KV_self, KV_cross
  // and dKV (B, D, D) each
  const OT *mats_t, *kv_t, *kvc_t, *dkv_t;
  float* tr;
};

// Chunks each segment's rows are cut into, so that `tiles` output tiles
// give about two blocks for each SM; at most one a 64-row step.
int atb_chunks(int tiles, int ksteps) {
  const int c = (2 * sm_count() + tiles / 2) / tiles;
  return c < 1 ? 1 : (c > ksteps ? ksteps : c);
}

// Output tiles (128 x 128, the last ones in a row or column partial) of
// an m x n A^T B result.
__host__ __device__ inline int atb_tiles(int m, int n) {
  return ((m + 127) / 128) * ((n + 127) / 128);
}

int weight_tiles(int E) { return 9 * atb_tiles(D, D) + atb_tiles(E, 6 * D); }

template <typename OT>
size_t carve(Work<OT>* w, unsigned char* base, int B, int T, int E, int dh) {
  constexpr bool kF32 = kIsF32<OT>;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    void* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  const size_t n = (size_t)B * T;
  OT** rows_o[] = {&w->xn, &w->qs, &w->xn2, &w->qcs, &w->x2b, &w->h1, &w->hs1, &w->hs2,
                   &w->hs3, &w->dy3, &w->dz, &w->dx2b, &w->dqc, &w->dy2, &w->dx1b, &w->dy1,
                   &w->dq, &w->dk, &w->dv};
  for (OT** p : rows_o) *p = static_cast<OT*>(take(n * D * sizeof(OT)));
  w->dmod = static_cast<OT*>(take(n * 6 * D * sizeof(OT)));
  float** rows_f[] = {&w->qs32, &w->qcs32, &w->y1, &w->y2, &w->y3, &w->z, &w->x1, &w->dx1};
  for (float** p : rows_f) *p = static_cast<float*>(take(n * D * 4));
  w->mod = static_cast<float*>(take(n * 6 * D * 4));
  w->partials = static_cast<float*>(take(kv_pass_partials_bytes(B, T, dh, true, kF32)));
  w->stats = static_cast<float*>(take((size_t)B * 2 * D * 4));
  w->kvr = kF32 ? nullptr : static_cast<float*>(take((size_t)B * D * dh * 4));
  w->dkv32 = static_cast<float*>(take((size_t)2 * B * D * D * 4));
  w->cvec = static_cast<float*>(take((size_t)B * D * 4));
  w->kv = static_cast<OT*>(take((size_t)B * D * D * sizeof(OT)));
  w->dkvb = static_cast<OT*>(take((size_t)B * D * D * sizeof(OT)));
  w->vp = static_cast<float*>(take(n / kRowsTile * 8 * kVecRows * D * 4));
  w->vg = static_cast<float*>(take((size_t)kSumGroups * kVecRows * D * 4));
  const size_t kv_part = (size_t)atb_chunks(2 * B, T / 64) * 2 * B * D * D;
  const size_t w_part = (size_t)atb_chunks(weight_tiles(E), (int)(n / 64)) * (9 * D * D + (size_t)E * 6 * D);
  w->part = static_cast<float*>(take((kv_part > w_part ? kv_part : w_part) * 4));
  w->tr = kF32 ? static_cast<float*>(take((size_t)(9 + 3 * B) * D * D * 4)) : nullptr;
  return off;
}

template <typename OT>
struct Inputs {
  const OT *x, *kvc, *mats, *dy;
  const float* vecs;
  int T, t_valid, dh;
};

// The row passes' tiles: kRowsTile (32) rows, kRowsW (4) a warp in the
// row-wise phases.  Shared memory: the ring of staged operands (bf16: 2
// whole (D x D) matrices; float32: kSlabStages k-slabs), two float32 (32,
// D) tiles and the operand tile, 105.5 KB (bf16) or 98.7 KB (float32):
// two blocks an SM.
constexpr int kRowsW = kRowsTile * 32 / kThreadsC;
template <typename OT>
constexpr size_t kRingRows = kIsF32<OT> ? (size_t)kSlabStages * kSlabBytes : 2 * (size_t)kWeightTile;
template <typename OT>
constexpr size_t kSmemRows =
    kRingRows<OT> + (size_t)kRowsTile * (2 * kLdF * 4 + kLdOp<OT> * sizeof(OT));

template <typename OT>
struct Tiles {
  const unsigned char* base;
  uint32_t ring;
  float *xs, *ys;
  OT* as;
  __device__ Tiles(unsigned char* smem) {
    base = smem;
    ring = tc::smem_addr(smem);
    xs = reinterpret_cast<float*>(smem + kRingRows<OT>);
    ys = xs + kRowsTile * kLdF;
    as = reinterpret_cast<OT*>(ys + kRowsTile * kLdF);
  }
};

// The row passes' products in order, each operand staged ahead of its use
// (as K1's row pass does).  gemm(C): C (kRowsTile x D) = as @ the next
// operand; gemm_t(C, accumulate): C (+)= as @ its transpose.  Both include
// the block syncs (as and the slot written before, C read after).
template <typename OT, int N>
struct Products;

// bf16: each operand staged whole into a ring of two, two products ahead.
template <int N>
struct Products<bf16, N> {
  const Tiles<bf16>& t;
  const bf16* const (&operand)[N];
  int next = 0;
  __device__ Products(const Tiles<bf16>& tiles, const bf16* const (&ops)[N]) : t(tiles), operand(ops) {
    stage(0);
    stage(1);
  }
  __device__ void stage(int i) {
    if (i < N) stage_weights(t.ring + (i & 1) * kWeightTile, operand[i]);
    tc::cp_async_commit();  // one group a product, empty past the last
  }
  template <bool kTransB>
  __device__ void product(float* C, bool accumulate) {
    tc::cp_async_wait<1>();  // all groups but the newest (product next + 1)
    __syncthreads();
    tile_gemm_smem<kTransB>(t.as, t.ring + (next & 1) * kWeightTile, C, accumulate);
    __syncthreads();
    stage(next + 2);
    ++next;
  }
  __device__ void gemm(float* C) { product<false>(C, false); }
  __device__ void gemm_t(float* C, bool accumulate = false) { product<true>(C, accumulate); }
};

// float32: stage s is k-slab s % 4 of product s / 4, staged two slabs ahead
// into a ring of kSlabStages; the operand of gemm_t is already transposed.
template <int N>
struct Products<float, N> {
  static constexpr int kSlabs = D / kSlabRows;  // slabs a product
  const Tiles<float>& t;
  const float* const (&operand)[N];
  int next = 0;  // slabs consumed
  __device__ Products(const Tiles<float>& tiles, const float* const (&ops)[N]) : t(tiles), operand(ops) {
    stage(0);
    stage(1);
  }
  __device__ void stage(int i) {
    if (i < N * kSlabs)
      stage_slab(t.ring + (i % kSlabStages) * kSlabBytes,
                 operand[i / kSlabs] + (size_t)(i % kSlabs) * kSlabRows * D);
    tc::cp_async_commit();  // one group a slab, empty past the last
  }
  // Each slab's sync also frees the slot of the slab before, which takes
  // slab next + 2; the first also orders as (and C, when accumulating).
  __device__ void product(float* C, bool accumulate) {
    float acc[kC][4] = {};
#pragma unroll 1
    for (int j = 0; j < kSlabs; ++j) {
      tc::cp_async_wait<1>();  // all groups but the newest (slab next + 1)
      __syncthreads();
      if (j == 0 && accumulate) slab_load(acc, C);
      stage(next + 2);
      slab_fma(t.as, j * kSlabRows,
               reinterpret_cast<const float*>(t.base + (next % kSlabStages) * kSlabBytes), acc);
      ++next;
    }
    slab_store(acc, C);
    __syncthreads();
  }
  __device__ void gemm(float* C) { product(C, false); }
  __device__ void gemm_t(float* C, bool accumulate = false) { product(C, accumulate); }
};

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(bf16 v) { return __bfloat162float(v); }

// The warp's per-column sums (lane owns columns lane + 32 i) into its slot
// of the column-sum partials.
__device__ __forceinline__ void put_sums(float* vp_slot, int row, const float s[kC]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kC; ++i) vp_slot[row * D + lane + 32 * i] = s[i];
}

// Copy the warp's kRowsW rows of a float32 tile (stride kLdF) to an operand
// tile of type OT (stride kLdOp) and, if `dst` is given, to global rows.
template <typename OT>
__device__ __forceinline__ void rows_to_op(const float* src, OT* op, OT* dst) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < kRowsW * D; i += 32) {
    const float v = src[(i / D) * kLdF + i % D];
    put(op + (i / D) * kLdOp<OT> + i % D, v);
    if (dst) put(dst + i, v);
  }
}

// The backward of one StylizationBlock out = silu(LN(y) * (1 + scale) +
// shift) @ W + b, for the warp's kRowsW rows (`_layer_bwd_kernel.styl_bwd`):
// y from global float32 rows, (scale, shift) from the rows of `mod` (row
// stride ldm, the AdaLN bias already in), the upstream gradient `dout`
// (float32 tile rows) and dhs = dout @ W^T in yw.  Writes hs = h *
// sigmoid(h) and dMod (2D columns at dmod_col) to global in the operand
// type, dy into yw, and the column sums of dout, dg, db, dscale, dshift.
template <typename OT>
__device__ void styl_bwd_rows(const float* y, const float* dout, float* yw, const float* mod,
                              int ldm, const float* g, const float* gb, OT* hs_out, OT* dmod,
                              int dmod_col, float* vp_slot, int gi, int bi, int boi, int dab_row) {
  const int lane = threadIdx.x & 31;
  float s_do[kC] = {}, s_dg[kC] = {}, s_db[kC] = {}, s_sc[kC] = {}, s_sh[kC] = {};
  for (int r = 0; r < kRowsW; ++r) {
    float v[kC], xhat[kC], dln[kC];
#pragma unroll
    for (int i = 0; i < kC; ++i) v[i] = y[(size_t)r * D + lane + 32 * i];
    const float2 st = ln_stats(v);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int c = lane + 32 * i;
      xhat[i] = (v[i] - st.x) * st.y;
      const float ln_y = xhat[i] * g[c] + gb[c];
      const float scale = mod[(size_t)r * ldm + c];
      const float shift = mod[(size_t)r * ldm + D + c];
      const float h = ln_y * (1.f + scale) + shift;
      const float sg = 1.f / (1.f + expf(-h));
      put(hs_out + (size_t)r * D + c, h * sg);
      const float dh = yw[r * kLdF + c] * sg * (1.f + h * (1.f - sg));
      put(dmod + (size_t)r * 6 * D + dmod_col + c, dh * ln_y);
      put(dmod + (size_t)r * 6 * D + dmod_col + D + c, dh);
      dln[i] = dh * (1.f + scale);
      s_do[i] += dout[r * kLdF + c];
      s_sc[i] += dh * ln_y;
      s_sh[i] += dh;
      s_dg[i] += dln[i] * xhat[i];
      s_db[i] += dln[i];
      const float dxh = dln[i] * g[c];
      m1 += dxh;
      m2 += dxh * xhat[i];
    }
    m1 = warp_sum(m1) * (1.f / D);
    m2 = warp_sum(m2) * (1.f / D);
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int c = lane + 32 * i;
      yw[r * kLdF + c] = st.y * (dln[i] * g[c] - m1 - xhat[i] * m2);
    }
  }
  put_sums(vp_slot, boi, s_do);
  put_sums(vp_slot, gi, s_dg);
  put_sums(vp_slot, bi, s_db);
  put_sums(vp_slot, kDabRow + dab_row, s_sc);
  put_sums(vp_slot, kDabRow + dab_row + 1, s_sh);
}

// Softmax-within-heads backward for the warp's kRowsW rows: ds in yw, s
// (float32) from global; dq = s * ds - s * sum_head (ds * s) (the JAX
// kernel's seg matmul, its operand bf16(ds * s) in the bf16 mode).  Writes
// dq in the operand type to `op` and `dst`, sums into vp row `row`.
template <typename OT>
__device__ void head_softmax_bwd_rows(const float* yw, const float* s32, OT* op, OT* dst,
                                      float* vp_slot, int row, int dh) {
  const int lane = threadIdx.x & 31;
  float sum[kC] = {};
  for (int r = 0; r < kRowsW; ++r)
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int c = lane + 32 * i;
      const float s = s32[(size_t)r * D + c], ds = yw[r * kLdF + c];
      const float dot = head_sum(kIsF32<OT> ? ds * s : round_bf16(ds * s), dh);
      const float dq = s * ds - s * dot;
      sum[i] += dq;
      put(op + r * kLdOp<OT> + c, dq);
      put(dst + (size_t)r * D + c, dq);
    }
  put_sums(vp_slot, row, sum);
}

// LayerNorm backward for the warp's kRowsW rows: input rows x (global, float32
// or bf16, row stride D), upstream dxn in yw, gain g; acc += dLN; column
// sums into vp rows gi (dg) and gi + 1 (db).
template <typename XT>
__device__ void ln_bwd_rows(const XT* x, const float* yw, const float* g, float* acc,
                            float* vp_slot, int gi) {
  const int lane = threadIdx.x & 31;
  float s_dg[kC] = {}, s_db[kC] = {};
  for (int r = 0; r < kRowsW; ++r) {
    float v[kC], xhat[kC];
#pragma unroll
    for (int i = 0; i < kC; ++i) v[i] = as_float(x[(size_t)r * D + lane + 32 * i]);
    const float2 st = ln_stats(v);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int c = lane + 32 * i;
      xhat[i] = (v[i] - st.x) * st.y;
      const float dxn = yw[r * kLdF + c];
      s_dg[i] += dxn * xhat[i];
      s_db[i] += dxn;
      m1 += dxn * g[c];
      m2 += dxn * g[c] * xhat[i];
    }
    m1 = warp_sum(m1) * (1.f / D);
    m2 = warp_sum(m2) * (1.f / D);
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int c = lane + 32 * i;
      acc[r * kLdF + c] += st.y * (yw[r * kLdF + c] * g[c] - m1 - xhat[i] * m2);
    }
  }
  put_sums(vp_slot, gi, s_dg);
  put_sums(vp_slot, gi + 1, s_db);
}

// ------------------------------------------------------------- rows1
// xs holds the residual rows in the forward and the gradient rows in the
// backward; ys the products; as the operand.  Its 16 products take their
// B operands from the ring, in this order.
template <typename OT>
__global__ void __launch_bounds__(kThreadsC, 2) rows1_kernel(Inputs<OT> in, Work<OT> w) {
  constexpr int kLdO = kLdOp<OT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles<OT> t(smem);
  const int b = blockIdx.y, wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T = in.T, dh = in.dh;
  const size_t tile_row = (size_t)b * T + blockIdx.x * kRowsTile;
  const int wo = wid * kRowsW;
  const size_t wrow = tile_row + wo;  // the warp's first global row
  float *xw = t.xs + wo * kLdF, *yw = t.ys + wo * kLdF;
  float* gw = xw;  // the backward's gradient rows, in the residual's place
  OT* aw = t.as + wo * kLdO;
  float* vp = w.vp + ((tile_row / kRowsTile) * 8 + wid) * kVecRows * D;
  const float* mrow = w.mod + wrow * 6 * D;  // the warp's rows of mod
  const float* vec = in.vecs;
  auto W = [&](int i) { return in.mats + (size_t)i * D * D; };
  auto Wt = [&](int i) { return w.mats_t + (size_t)i * D * D; };  // for gemm_t
  auto R = [&](auto* p) { return p + wrow * D; };  // the warp's rows of a (B*T, D) array
  const OT* kv = w.kv + (size_t)b * D * D;
  const OT* kvc = in.kvc + (size_t)b * D * D;
  const OT* const operand[16] = {
      W(kWq), kv, W(kWStylSelf), W(kWqCross), kvc, W(kWStylCross), W(kW1), W(kW2),  // forward
      Wt(kWStylFfn), Wt(kW2), Wt(kW1), Wt(kWStylCross), w.kvc_t + (size_t)b * D * D,
      Wt(kWqCross), Wt(kWStylSelf), w.kv_t + (size_t)b * D * D};
  Products<OT, 16> p(t, operand);
  // float32 rows of the warp's tile: y (= yw) + bias -> global
  auto store_rows = [&](float* dst, const float* src, const float* bias) {
    for (int i = lane; i < kRowsW * D; i += 32) {
      const float v = src[(i / D) * kLdF + i % D] + (bias ? bias[i % D] : 0.f);
      if (bias) yw[(i / D) * kLdF + i % D] = v;
      dst[i] = v;
    }
  };
  // LN -> q -> head softmax for an attention sublayer: q_sm into as and
  // global (the operand type and float32)
  auto query = [&](int g, int bq, OT* xn, OT* s16, float* s32) {
    warp_ln<kRowsW>(xw, vec + g * D, vec + (g + 1) * D, aw);
    for (int i = lane; i < kRowsW * D; i += 32) R(xn)[i] = aw[(i / D) * kLdO + i % D];
    p.gemm(t.ys);
    for (int r = 0; r < kRowsW; ++r) {
      float v[kC];
#pragma unroll
      for (int i = 0; i < kC; ++i) v[i] = yw[r * kLdF + lane + 32 * i] + vec[bq * D + lane + 32 * i];
      head_softmax_row<false, (!kIsF32<OT>)>(v, dh);
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const int c = lane + 32 * i;
        R(s32)[r * D + c] = v[i];
        put(aw + r * kLdO + c, v[i]);
        put(R(s16) + r * D + c, v[i]);
      }
    }
  };
  // forward StylizationBlock + residual: x += silu(AdaLN(y)) @ W + b, the
  // AdaLN slice j read from mod
  auto stylize = [&](int j, int g, int b_out) {
    warp_adaln_mod<kRowsW>(yw, nullptr, mrow + j * 2 * D, 6 * D, kRowsW, vec + g * D,
                           vec + (g + 1) * D, aw);
    p.gemm(t.ys);
    for (int i = lane; i < kRowsW * D; i += 32)
      xw[(i / D) * kLdF + i % D] += yw[(i / D) * kLdF + i % D] + vec[b_out * D + i % D];
    __syncwarp();
  };

  for (int i = threadIdx.x; i < kRowsTile * D / 4; i += kThreadsC)
    store4(t.xs + (i / (D / 4)) * kLdF + (i % (D / 4)) * 4, load4(in.x + tile_row * D + 4 * i));
  __syncthreads();

  // ---- forward, keeping what the backward reads
  query(kLnSelfG, kBq, w.xn, w.qs, w.qs32);
  p.gemm(t.ys);  // q_sm KV_self
  store_rows(R(w.y1), yw, nullptr);
  stylize(0, kStylSelfG, kStylSelfOut);
  store_rows(R(w.x1), xw, nullptr);
  query(kLnCrossG, kBqCross, w.xn2, w.qcs, w.qcs32);
  p.gemm(t.ys);  // qc_sm KV_cross
  store_rows(R(w.y2), yw, nullptr);
  stylize(1, kStylCrossG, kStylCrossOut);
  rows_to_op(xw, aw, R(w.x2b));  // x2
  p.gemm(t.ys);                        // W1
  store_rows(R(w.z), yw, vec + kB1 * D);  // z = x2 W1 + b1, kept in yw
  for (int i = lane; i < kRowsW * D; i += 32) {
    const float h1 = gelu_tanh(yw[(i / D) * kLdF + i % D]);
    put(aw + (i / D) * kLdO + i % D, h1);
    put(R(w.h1) + i, h1);
  }
  p.gemm(t.ys);  // W2
  store_rows(R(w.y3), yw, vec + kB2 * D);

  // ---- FFN backward: dy into xs (float32, the residual no longer needed)
  // and as (the operand type)
  for (int i = threadIdx.x; i < kRowsTile * D / 4; i += kThreadsC) {
    const float4 v = load4(in.dy + tile_row * D + 4 * i);
    store4(t.xs + (i / (D / 4)) * kLdF + (i % (D / 4)) * 4, v);
    store4(t.as + (i / (D / 4)) * kLdO + (i % (D / 4)) * 4, v);
  }
  p.gemm_t(t.ys);  // dy W_styl_ffn^T
  styl_bwd_rows(R(w.y3), gw, yw, mrow + 4 * D, 6 * D, vec + kStylFfnG * D,
                    vec + kStylFfnB * D, R(w.hs3), w.dmod + wrow * 6 * D, 4 * D, vp, kStylFfnG,
                    kStylFfnB, kStylFfnOut, 4);
  {  // dy3: column sums (d b2), operand
    float s[kC] = {};
    for (int r = 0; r < kRowsW; ++r)
#pragma unroll
      for (int i = 0; i < kC; ++i) s[i] += yw[r * kLdF + lane + 32 * i];
    put_sums(vp, kB2, s);
  }
  rows_to_op(yw, aw, R(w.dy3));
  p.gemm_t(t.ys);  // dh1 = dy3 W2^T
  {  // dz = gelu'(z) dh1
    float s[kC] = {};
    for (int r = 0; r < kRowsW; ++r)
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const int c = lane + 32 * i;
        const float z = R(w.z)[r * D + c];
        const float u = 0.7978845608028654f * (z + 0.044715f * z * z * z);
        const float th = tanhf(u);
        const float du = 0.7978845608028654f * (1.f + 3.f * 0.044715f * z * z);
        const float dz = yw[r * kLdF + c] * (0.5f * (1.f + th) + 0.5f * z * (1.f - th * th) * du);
        s[i] += dz;
        put(aw + r * kLdO + c, dz);
        put(R(w.dz) + r * D + c, dz);
      }
    put_sums(vp, kB1, s);
  }
  p.gemm_t(t.xs, true);  // dx2 = dy + dz W1^T

  // ---- cross attention backward
  rows_to_op(gw, aw, R(w.dx2b));
  p.gemm_t(t.ys);  // dx2 W_styl_cross^T
  styl_bwd_rows(R(w.y2), gw, yw, mrow + 2 * D, 6 * D, vec + kStylCrossG * D,
                    vec + kStylCrossB * D, R(w.hs2), w.dmod + wrow * 6 * D, 2 * D, vp,
                    kStylCrossG, kStylCrossB, kStylCrossOut, 2);
  rows_to_op(yw, aw, R(w.dy2));
  p.gemm_t(t.ys);  // dqc_sm = dy2 KV_cross^T
  head_softmax_bwd_rows(yw, R(w.qcs32), aw, R(w.dqc), vp, kBqCross, dh);
  p.gemm_t(t.ys);  // dxn2 = dqc Wq_cross^T
  ln_bwd_rows(R(w.x1), yw, vec + kLnCrossG * D, gw, vp, kLnCrossG);  // xs: dx1
  __syncwarp();

  // ---- self attention: StylizationBlock and query backward
  rows_to_op(gw, aw, R(w.dx1b));
  for (int i = lane; i < kRowsW * D; i += 32) R(w.dx1)[i] = gw[(i / D) * kLdF + i % D];
  p.gemm_t(t.ys);  // dx1 W_styl_self^T
  styl_bwd_rows(R(w.y1), gw, yw, mrow, 6 * D, vec + kStylSelfG * D, vec + kStylSelfB * D,
                    R(w.hs1), w.dmod + wrow * 6 * D, 0, vp, kStylSelfG, kStylSelfB, kStylSelfOut,
                    0);
  rows_to_op(yw, aw, R(w.dy1));
  p.gemm_t(t.ys);  // dq_sm = dy1 KV_self^T
  head_softmax_bwd_rows(yw, R(w.qs32), aw, R(w.dq), vp, kBq, dh);
}

// ------------------------------------------------------------- rows2
// ys and xs take k and v, then k_sm and dk_sm, then dv, then dxn and dx.
template <typename OT>
__global__ void __launch_bounds__(kThreadsC, 2) rows2_kernel(Inputs<OT> in, Work<OT> w, OT* dx) {
  constexpr int kLdO = kLdOp<OT>;
  constexpr int kPer = 16 / sizeof(OT);  // elements a 16-byte chunk
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles<OT> t(smem);
  const int b = blockIdx.y, wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T = in.T;
  const size_t tile_row = (size_t)b * T + blockIdx.x * kRowsTile;
  const int wo = wid * kRowsW;
  const size_t wrow = tile_row + wo;
  float *xw = t.xs + wo * kLdF, *yw = t.ys + wo * kLdF;
  OT* aw = t.as + wo * kLdO;
  float* vp = w.vp + ((tile_row / kRowsTile) * 8 + wid) * kVecRows * D;
  const float* vec = in.vecs;
  const float* stats = w.stats + (size_t)b * 2 * D;
  const float* cvec = w.cvec + (size_t)b * D;
  const OT* dkv = w.dkvb + (size_t)b * D * D;
  auto W = [&](int i) { return in.mats + (size_t)i * D * D; };
  auto Wt = [&](int i) { return w.mats_t + (size_t)i * D * D; };  // for gemm_t
  const OT* const operand[7] = {W(kWk), W(kWv), w.dkv_t + (size_t)b * D * D, dkv, Wt(kWq),
                                Wt(kWk), Wt(kWv)};
  Products<OT, 7> p(t, operand);
  auto load_op = [&](const OT* src) {  // a (kRowsTile, D) operand tile from global into as
    for (int i = threadIdx.x; i < kRowsTile * D / kPer; i += kThreadsC)
      *reinterpret_cast<uint4*>(t.as + (i / (D / kPer)) * kLdO + (i % (D / kPer)) * kPer) =
          reinterpret_cast<const uint4*>(src + tile_row * D)[i];
  };
  auto valid = [&](int r) { return (int)blockIdx.x * kRowsTile + wo + r < in.t_valid; };

  load_op(w.xn);
  p.gemm(t.ys);  // k
  p.gemm(t.xs);  // v
  // k_sm (ys) and v (as), masked past t_valid
  for (int r = 0; r < kRowsW; ++r)
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int c = lane + 32 * i;
      const float k = yw[r * kLdF + c] + vec[kBk * D + c];
      yw[r * kLdF + c] = valid(r) ? expf(k - stats[c]) / stats[D + c] : 0.f;
      put(aw + r * kLdO + c, valid(r) ? xw[r * kLdF + c] + vec[kBv * D + c] : 0.f);
    }
  p.gemm_t(t.xs);  // dk_sm = v dKV^T
  {  // time-softmax backward: dk = k_sm (dk_sm - c), masked rows give 0; k_sm into as
    float sk[kC] = {};
    for (int r = 0; r < kRowsW; ++r)
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const int c = lane + 32 * i;
        const float dk = valid(r) ? yw[r * kLdF + c] * (xw[r * kLdF + c] - cvec[c]) : 0.f;
        sk[i] += dk;
        put(w.dk + (wrow + r) * D + c, dk);
        put(aw + r * kLdO + c, yw[r * kLdF + c]);
      }
    put_sums(vp, kBk, sk);
  }
  p.gemm(t.ys);  // dv = k_sm dKV
  {
    float sv[kC] = {};
    for (int r = 0; r < kRowsW; ++r)
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const int c = lane + 32 * i;
        const float dv = valid(r) ? yw[r * kLdF + c] : 0.f;
        sv[i] += dv;
        put(w.dv + (wrow + r) * D + c, dv);
      }
    put_sums(vp, kBv, sv);
  }
  __syncthreads();  // the block's rows of dk and dv written, as free
  // dxn = dq Wq^T + dk Wk^T + dv Wv^T, into ys
  load_op(w.dq);
  p.gemm_t(t.ys);
  load_op(w.dk);
  p.gemm_t(t.ys, true);
  load_op(w.dv);
  p.gemm_t(t.ys, true);
  // first LayerNorm backward; dx = dx1 + dLN
  for (int i = lane; i < kRowsW * D; i += 32) xw[(i / D) * kLdF + i % D] = w.dx1[wrow * D + i];
  __syncwarp();
  ln_bwd_rows(in.x + wrow * D, yw, vec + kLnSelfG * D, xw, vp, kLnSelfG);
  __syncwarp();
  for (int i = lane; i < kRowsW * D; i += 32) put(dx + wrow * D + i, xw[(i / D) * kLdF + i % D]);
}

// ------------------------------------------------- staged GEMM tiles
// 128 x 128 output tiles, 8 warps, a ring of 3 stages of two 16-KB operand
// tiles by 16-byte cp.async: bf16 (mma.sync, a warp 64 x 32 of the sums)
// or float32 (FFMA, a thread 8 x 8).
constexpr int kGemmThreads = 256;
constexpr int kGemmStages = 3;
constexpr int kGemmStage = 32768;  // two 16-KB operand tiles
constexpr int kGemmSmem = kGemmStages * kGemmStage;

// The ring's pipeline over nk stages of work: load(k, slot) starts stage
// k's copies, compute(slot) consumes a stage.
template <typename Load, typename Compute>
__device__ __forceinline__ void run_ring(int nk, Load load, Compute compute) {
#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < nk) load(s, s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + kGemmStages - 1 < nk) load(kt + kGemmStages - 1, (kt + kGemmStages - 1) % kGemmStages);
    tc::cp_async_commit();
    tc::cp_async_wait<kGemmStages - 1>();  // stage kt's group is complete
    __syncthreads();
    compute(kt);
    __syncthreads();  // stage kt consumed before it is refilled
  }
  tc::cp_async_wait<0>();
}

// ------------------------------------------------------------- A^T B
// C[s] (m x n) = sum over rows r of segment s of A[r, :m]^T B[r, :n] (bf16
// or float32 operands, float32 sums); a segment's rows are cut into
// `chunks` runs of 64-row steps, each block summing one run of one 128 x
// 128 tile (m and n multiples of 8: at D < 128 the tiles of a D-wide
// result are partial, their missing columns staged as zeros and their sums
// not stored).  With chunks > 1 the run's sums go to part + chunk *
// part_stride, laid out as out (S, m, n), and a sum in chunk order follows.
template <typename T>
struct AtbJob {
  const T *a, *b;
  float *out, *part;
  long long part_stride;
  int m, n, lda, ldb, segs, seg_rows;
};
template <typename T>
struct AtbJobs {
  AtbJob<T> job[10];
  int count, chunks;
};

template <typename T>
int atb_blocks(const AtbJobs<T>& jobs) {
  int n = 0;
  for (int j = 0; j < jobs.count; ++j)
    n += atb_tiles(jobs.job[j].m, jobs.job[j].n) * jobs.job[j].segs * jobs.chunks;
  return n;
}

// This block's share of the A^T B work: its job, 128 x 128 tile, chunk and
// segment, and its run of 64-row steps [k0, k0 + nk).
struct AtbTile {
  int j, m0, n0, chunk, seg, k0, nk;
};
template <typename T>
__device__ AtbTile atb_tile(const AtbJobs<T>& jobs) {
  AtbTile a;
  int blk = blockIdx.x;
  for (a.j = 0; a.j < jobs.count - 1; ++a.j) {
    const AtbJob<T>& jb = jobs.job[a.j];
    const int nb = atb_tiles(jb.m, jb.n) * jb.segs * jobs.chunks;
    if (blk < nb) break;
    blk -= nb;
  }
  const AtbJob<T>& jb = jobs.job[a.j];
  const int tiles_m = (jb.m + 127) / 128, tiles = atb_tiles(jb.m, jb.n);
  // tiles fastest: the blocks that run together share rows (L2)
  const int tile = blk % tiles;
  a.chunk = (blk / tiles) % jobs.chunks;
  a.seg = blk / tiles / jobs.chunks;
  a.m0 = (tile % tiles_m) * 128;
  a.n0 = (tile / tiles_m) * 128;
  const int ks = jb.seg_rows / 64;
  a.k0 = a.chunk * ks / jobs.chunks;
  a.nk = (a.chunk + 1) * ks / jobs.chunks - a.k0;
  return a;
}

// kPartial: some tile of the launch is partial (D < 128); without it the
// loads and stores carry no bounds checks.
template <bool kPartial>
__global__ void __launch_bounds__(kGemmThreads, 2) atb_kernel(AtbJobs<bf16> jobs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const AtbTile at = atb_tile(jobs);
  const AtbJob<bf16>& jb = jobs.job[at.j];
  const bf16* a = jb.a + ((size_t)at.seg * jb.seg_rows + (size_t)at.k0 * 64) * jb.lda + at.m0;
  const bf16* bsrc = jb.b + ((size_t)at.seg * jb.seg_rows + (size_t)at.k0 * 64) * jb.ldb + at.n0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const uint32_t base = tc::smem_addr(smem);

  // stage: 64 rows of A's 128 columns, then of B's, 16 chunks a row; a
  // partial tile (D < 128) stages zeros past its columns
  const bool partial = kPartial && (at.m0 + 128 > jb.m || at.n0 + 128 > jb.n);
  auto load = [&](int kt, int s) {
    for (int i = threadIdx.x; i < 2 * 64 * 16; i += kGemmThreads) {
      const int half = i >> 10, r = (i >> 4) & 63, c = i & 15;
      const bf16* src = half ? bsrc + ((size_t)kt * 64 + r) * jb.ldb : a + ((size_t)kt * 64 + r) * jb.lda;
      const uint32_t dst = base + s * kGemmStage + half * 16384 + tc::swz<16>(r, c);
      if (!partial) {
        tc::cp_async16(dst, src + 8 * c);
      } else {
        const bool valid = (half ? at.n0 : at.m0) + 8 * c < (half ? jb.n : jb.m);
        tc::cp_async16(dst, valid ? src + 8 * c : src, valid);
      }
    }
  };
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.f;
  auto compute = [&](int kt) {
    const uint32_t as = base + (kt % kGemmStages) * kGemmStage, bs = as + 16384;
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      uint32_t bq[2][4];  // b0, b1 of n8 tiles 2 q and 2 q + 1
#pragma unroll
      for (int q = 0; q < 2; ++q)
        tc::ldmatrix_x4_trans(bq[q], bs + tc::swz<16>(kk + (lane & 15), (wn + 16 * q) / 8 + (lane >> 4)));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t af[4];  // A^T: matrices (m 0-7 | 8-15) x (rows 0-7 | 8-15), m block first
        tc::ldmatrix_x4_trans(af, as + tc::swz<16>(kk + ((lane >> 4) << 3) + (lane & 7),
                                                   (wm + 16 * i) / 8 + ((lane >> 3) & 1)));
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          tc::mma_bf16(acc[i][2 * q], af, bq[q][0], bq[q][1]);
          tc::mma_bf16(acc[i][2 * q + 1], af, bq[q][2], bq[q][3]);
        }
      }
    }
  };
  run_ring(at.nk, load, compute);

  // C fragment element e of n8 tile q: row lane / 4 + 8 (e / 2), column
  // 8 q + 2 (lane % 4) + e % 2
  float* c = (jobs.chunks > 1 ? jb.part + at.chunk * jb.part_stride : jb.out) +
             (size_t)at.seg * jb.m * jb.n + (size_t)(at.m0 + wm) * jb.n + at.n0 + wn;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  // in range: rows < rows, columns < cols (all of a whole tile)
  const int rows = partial ? jb.m - at.m0 - wm : 128, cols = partial ? jb.n - at.n0 - wn : 128;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (8 * q + t2 >= cols) continue;
      float* p = c + (size_t)(16 * i + g) * jb.n + 8 * q + t2;
      if (16 * i + g < rows) *reinterpret_cast<float2*>(p) = make_float2(acc[i][q][0], acc[i][q][1]);
      if (16 * i + g + 8 < rows)
        *reinterpret_cast<float2*>(p + 8 * (size_t)jb.n) = make_float2(acc[i][q][2], acc[i][q][3]);
    }
}

// The float32 mode's A^T B: a stage holds 32 rows of A's 128 columns and of
// B's (unpadded float32 rows), and thread (ty, tx) = (t / 16, t % 16) keeps
// the sums of columns 4 ty + i, 64 + 4 ty + i of A against 4 tx + j, 64 + 4
// tx + j of B (i, j < 4), each an FFMA chain over the rows in order: per row
// four 16-byte loads (A's two broadcast within a warp, B's 16 distinct
// vectors of one row) feed 64 FFMAs.
template <bool kPartial>
__global__ void __launch_bounds__(kGemmThreads, 2) atb_f32_kernel(AtbJobs<float> jobs) {
  constexpr int kRows = 32;  // rows a stage
  extern __shared__ __align__(128) unsigned char smem[];
  const AtbTile at = atb_tile(jobs);
  const AtbJob<float>& jb = jobs.job[at.j];
  const float* a = jb.a + ((size_t)at.seg * jb.seg_rows + (size_t)at.k0 * 64) * jb.lda + at.m0;
  const float* bsrc = jb.b + ((size_t)at.seg * jb.seg_rows + (size_t)at.k0 * 64) * jb.ldb + at.n0;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const uint32_t base = tc::smem_addr(smem);
  const float* fbase = reinterpret_cast<const float*>(smem);

  // stage: kRows rows of A's 128 columns, then of B's, 32 chunks a row; a
  // partial tile stages zeros past its columns
  const bool partial = kPartial && (at.m0 + 128 > jb.m || at.n0 + 128 > jb.n);
  auto load = [&](int kt, int s) {
    for (int i = threadIdx.x; i < 2 * kRows * 32; i += kGemmThreads) {
      const int half = i >> 10, r = (i >> 5) & (kRows - 1), c = i & 31;
      const float* src = half ? bsrc + ((size_t)kt * kRows + r) * jb.ldb
                              : a + ((size_t)kt * kRows + r) * jb.lda;
      const uint32_t dst = base + s * kGemmStage + half * 16384 + (r * 128 + 4 * c) * 4;
      if (!partial) {
        tc::cp_async16(dst, src + 4 * c);
      } else {
        const bool valid = (half ? at.n0 : at.m0) + 4 * c < (half ? jb.n : jb.m);
        tc::cp_async16(dst, valid ? src + 4 * c : src, valid);
      }
    }
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  auto compute = [&](int kt) {
    const float* as = fbase + (kt % kGemmStages) * (kGemmStage / 4);
    const float* bs = as + 4096;
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      const float4 a0 = load4(as + r * 128 + 4 * ty), a1 = load4(as + r * 128 + 64 + 4 * ty);
      const float4 b0 = load4(bs + r * 128 + 4 * tx), b1 = load4(bs + r * 128 + 64 + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  };
  run_ring(2 * at.nk, load, compute);  // two stages a 64-row step

  float* c = (jobs.chunks > 1 ? jb.part + at.chunk * jb.part_stride : jb.out) +
             (size_t)at.seg * jb.m * jb.n + (size_t)at.m0 * jb.n + at.n0;
  // in range: rows < rows, columns < cols (all of a whole tile)
  const int rows = partial ? jb.m - at.m0 : 128, cols = partial ? jb.n - at.n0 : 128;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4;
    if (r >= rows) continue;
    float* p = c + (size_t)r * jb.n + 4 * tx;
    if (4 * tx < cols) store4(p, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    if (64 + 4 * tx < cols) store4(p + 64, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
  }
}

// out[i] = sum over g of in[g * stride + i] for i < n (n a multiple of 4),
// g in [G * y / groups, G * (y + 1) / groups) for blockIdx.y = y, written
// to out + y * n: threads (x, y) of a 32 x 8 block take float4 x of the
// block's 128 values and every 8th g in order, then the block adds its 8
// partial sums in order.  Deterministic.
__global__ void __launch_bounds__(256) sum_kernel(const float* __restrict__ in, long long stride,
                                                  int G, float* __restrict__ out, int n) {
  __shared__ float4 part[8][32];
  const int i = (blockIdx.x * 32 + threadIdx.x) * 4;
  const int g0 = (int)((long long)G * blockIdx.y / gridDim.y);
  const int g1 = (int)((long long)G * (blockIdx.y + 1) / gridDim.y);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < n)
    for (int g = g0 + threadIdx.y; g < g1; g += 8) {
      const float4 v = *reinterpret_cast<const float4*>(in + g * stride + i);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < n) {
    float4 total = part[0][threadIdx.x];
    for (int y = 1; y < 8; ++y) {
      total.x += part[y][threadIdx.x].x;
      total.y += part[y][threadIdx.x].y;
      total.z += part[y][threadIdx.x].z;
      total.w += part[y][threadIdx.x].w;
    }
    *reinterpret_cast<float4*>(out + (size_t)blockIdx.y * n + i) = total;
  }
}

cudaError_t launch_sum(const float* in, long long stride, int G, float* out, int n, int groups,
                       cudaStream_t s) {
  sum_kernel<<<dim3(ceil_div(n, 128), groups), dim3(32, 8), 0, s>>>(in, stride, G, out, n);
  return cudaGetLastError();
}

template <typename T, bool kPartial>
cudaError_t launch_atb_kernel(const AtbJobs<T>& jobs, cudaStream_t s) {
  void (*kernel)(AtbJobs<T>);
  if constexpr (kIsF32<T>)
    kernel = atb_f32_kernel<kPartial>;
  else
    kernel = atb_kernel<kPartial>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (attr != cudaSuccess) return attr;
  kernel<<<atb_blocks(jobs), kGemmThreads, kGemmSmem, s>>>(jobs);
  return cudaGetLastError();
}

// The A^T B launch, its bounds checks compiled in only where a job's
// result is no whole number of 128 x 128 tiles (D < 128).
template <typename T>
cudaError_t launch_atb(const AtbJobs<T>& jobs, cudaStream_t s) {
  bool partial = false;
  for (int j = 0; j < jobs.count; ++j)
    partial |= jobs.job[j].m % 128 != 0 || jobs.job[j].n % 128 != 0;
  return partial ? launch_atb_kernel<T, true>(jobs, s) : launch_atb_kernel<T, false>(jobs, s);
}

// out[i] = in[i]^T for the n (D x D) float32 matrices of `in`, through a
// padded 32 x 33 tile: the float32 mode's B operands of A @ B^T products.
__global__ void __launch_bounds__(256) transpose_kernel(const float* __restrict__ in,
                                                        float* __restrict__ out) {
  __shared__ float tile[32][33];
  const size_t mat = (size_t)blockIdx.z * D * D;
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  for (int r = threadIdx.y; r < 32; r += 8)
    tile[r][threadIdx.x] = in[mat + (size_t)(r0 + r) * D + c0 + threadIdx.x];
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8)
    out[mat + (size_t)(c0 + r) * D + r0 + threadIdx.x] = tile[threadIdx.x][r];
}

cudaError_t launch_transpose(const float* in, float* out, int n, cudaStream_t s) {
  transpose_kernel<<<dim3(D / 32, D / 32, n), dim3(32, 8), 0, s>>>(in, out);
  return cudaGetLastError();
}

// dKV -> dKV * seg in the operand type (bf16-rounded, or float32 as is) and
// the softmax backward's column sums c[d] = sum_l dKV[d, l] KVr[d, l],
// summed in l order (bf16: the rounded dKV against KVr = k_sm^T bf16(v);
// float32: dKV against KV itself); dKV_cross -> the operand type.  One
// block per row d of a clip, one thread per column l.
template <typename OT>
__global__ void __launch_bounds__(D) combine_kernel(Work<OT> w, OT* dkvc, int B, int dh) {
  __shared__ float prod[D];
  const int b = blockIdx.y, d = blockIdx.x, l = threadIdx.x;
  const size_t i = ((size_t)b * D + d) * D + l;
  const bool same = d / dh == l / dh;
  put(w.dkvb + i, same ? w.dkv32[i] : 0.f);
  put(dkvc + i, w.dkv32[(size_t)B * D * D + i]);
  const float kvr = kIsF32<OT> ? as_float(w.kv[i]) : w.kvr[((size_t)b * D + d) * dh + l % dh];
  prod[l] = same ? as_float(w.dkvb[i]) * kvr : 0.f;
  __syncthreads();
  if (l == 0) {
    float c = 0.f;
    for (int k = 0; k < D; ++k) c += prod[k];
    w.cvec[(size_t)b * D + d] = c;
  }
}

// ------------------------------------------------------------- d_emb
// d_emb[r, e] = bf16(bf16(bf16(A_2) + bf16(A_1)) + bf16(A_0)), A_j = dMod[r,
// j-th 2D slice] @ aw[e, same slice]^T: the JAX kernel's bf16 accumulation
// across the sublayers (FFN, cross, self).  A 128 x 128 tile of d_emb a
// block; a stage holds 64 columns of dMod's 128 rows and of aw's 128 rows
// (8 chunks a row), both k-contiguous, so both fragments come by plain
// ldmatrix.  The running bf16 sum stays packed in registers.
__global__ void __launch_bounds__(kGemmThreads, 2)
demb_kernel(const bf16* __restrict__ dmod, const bf16* __restrict__ aw, bf16* __restrict__ demb,
            int M, int E) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int row0 = blockIdx.y * 128, col0 = blockIdx.x * 128;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const uint32_t base = tc::smem_addr(smem);
  constexpr int kSteps = 2 * D / 64;  // stages of one sublayer's slice

  // stage kt: slice 2 - kt / kSteps (FFN first), its 64 columns kt % kSteps
  auto load = [&](int kt, int s) {
    const int k = (2 - kt / kSteps) * 2 * D + (kt % kSteps) * 64;
    for (int i = threadIdx.x; i < 2 * 128 * 8; i += kGemmThreads) {
      const int half = i >> 10, r = (i >> 3) & 127, c = i & 7;
      const bool valid = half || row0 + r < M;
      const bf16* src = half ? aw + (size_t)(col0 + r) * 6 * D : dmod + (size_t)(valid ? row0 + r : 0) * 6 * D;
      tc::cp_async16(base + s * kGemmStage + half * 16384 + tc::swz<8>(r, c), src + k + 8 * c, valid);
    }
  };
  float acc[4][4][4];
  __nv_bfloat162 res[4][4][2];  // the running d_emb, rows g and g + 8
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.f;
  auto compute = [&](int kt) {
    const uint32_t as = base + (kt % kGemmStages) * kGemmStage, bs = as + 16384;
#pragma unroll
    for (int kc = 0; kc < 8; kc += 2) {  // 16 columns: chunks kc, kc + 1
      uint32_t bq[2][4];  // b0, b1 of n8 tile 2 q, then of 2 q + 1
#pragma unroll
      for (int q = 0; q < 2; ++q)
        tc::ldmatrix_x4(bq[q], bs + tc::swz<8>(wn + 16 * q + ((lane >> 4) << 3) + (lane & 7),
                                               kc + ((lane >> 3) & 1)));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t af[4];
        tc::ldmatrix_x4(af, as + tc::swz<8>(wm + 16 * i + (lane & 15), kc + (lane >> 4)));
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          tc::mma_bf16(acc[i][2 * q], af, bq[q][0], bq[q][1]);
          tc::mma_bf16(acc[i][2 * q + 1], af, bq[q][2], bq[q][3]);
        }
      }
    }
    if (kt % kSteps == kSteps - 1) {  // a sublayer done: round, add in bf16
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float a0 = round_bf16(acc[i][q][2 * h]), a1 = round_bf16(acc[i][q][2 * h + 1]);
            if (kt < kSteps) {
              res[i][q][h] = __floats2bfloat162_rn(a0, a1);
            } else {
              const float2 r = __bfloat1622float2(res[i][q][h]);
              res[i][q][h] = __floats2bfloat162_rn(r.x + a0, r.y + a1);
            }
            acc[i][q][2 * h] = acc[i][q][2 * h + 1] = 0.f;
          }
    }
  };
  run_ring(3 * kSteps, load, compute);
  __syncthreads();

  // the tile through shared memory (the ring is free): whole 256-byte rows
  constexpr int kLdO = 128 + 8;
  bf16* os = reinterpret_cast<bf16*>(smem);
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(os + (wm + 16 * i + g + 8 * h) * kLdO + wn + 8 * q + t2) =
            res[i][q][h];
  __syncthreads();
  for (int i = threadIdx.x; i < 128 * 16; i += kGemmThreads) {
    const int r = i >> 4, c = i & 15;
    if (row0 + r < M)
      *reinterpret_cast<uint4*>(demb + (size_t)(row0 + r) * E + col0 + 8 * c) =
          *reinterpret_cast<const uint4*>(os + r * kLdO + 8 * c);
  }
}

// The float32 mode's d_emb[r, e] = sum over k of dMod[r, k] aw[e, k], one
// FFMA chain a sum, k over the FFN's slice of dMod (4D .. 6D), then the
// cross attention's (2D .. 4D), then the self attention's (0 .. 2D).  The
// float32 AdaLN GEMM's tiling (adaln_gemm.cu): a 128 x 128 tile of d_emb
// a block, a thread 8 x 8 sums; k-slices of 8 double-buffered through
// registers, both dMod's and aw's rows stored transposed (k-major) into
// shared memory so that a thread's 4 rows or columns are one vector.
constexpr int kDembBK = 8;
constexpr int kDembLd = 128 + 4;  // rows (k) padded: the transposing stores hit distinct banks

__global__ void __launch_bounds__(kGemmThreads)
demb_f32_kernel(const float* __restrict__ dmod, const float* __restrict__ aw,
                float* __restrict__ demb, int M, int E) {
  __shared__ __align__(16) float As[2][kDembBK][kDembLd];
  __shared__ __align__(16) float Bs[2][kDembBK][kDembLd];
  constexpr int kSlice = 2 * D / kDembBK;  // k-slices of one sublayer's slice
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int row0 = blockIdx.y * 128, col0 = blockIdx.x * 128;
  // the loads: row t / 2 of dMod and of aw, k 4 (t % 2) .. + 3 of the slice
  const int lr = t >> 1, lk = (t & 1) * 4;
  const bool a_ok = row0 + lr < M;  // rows past M are zeros and never stored
  const float* a_src = dmod + (size_t)(a_ok ? row0 + lr : 0) * 6 * D + lk;
  const float* b_src = aw + (size_t)(col0 + lr) * 6 * D + lk;
  float4 ra, rb;
  auto fetch = [&](int kt) {
    const int k = (2 - kt / kSlice) * 2 * D + (kt % kSlice) * kDembBK;
    ra = a_ok ? __ldg(reinterpret_cast<const float4*>(a_src + k)) : make_float4(0.f, 0.f, 0.f, 0.f);
    rb = __ldg(reinterpret_cast<const float4*>(b_src + k));
  };
  auto put_tile = [&](int s) {
    As[s][lk][lr] = ra.x;
    As[s][lk + 1][lr] = ra.y;
    As[s][lk + 2][lr] = ra.z;
    As[s][lk + 3][lr] = ra.w;
    Bs[s][lk][lr] = rb.x;
    Bs[s][lk + 1][lr] = rb.y;
    Bs[s][lk + 2][lr] = rb.z;
    Bs[s][lk + 3][lr] = rb.w;
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  fetch(0);
  put_tile(0);
  __syncthreads();
  constexpr int nk = 3 * kSlice;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) fetch(kt + 1);  // in flight while this slice multiplies
#pragma unroll
    for (int k = 0; k < kDembBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[s][k][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[s][k][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[s][k][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[s][k][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was read in the slice before, which the last sync closed
    if (kt + 1 < nk) put_tile(s ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= M) continue;
    float* o = demb + (size_t)r * E + col0 + 4 * tx;
    store4(o, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    store4(o + 64, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
  }
}

// The backward of one layer in the operand type OT (bf16, or float in the
// float32 mode), the launches in the order of the design note.
template <typename OT>
int layer_backward(const void* x, const void* emb, const void* kv_cross, const void* mats,
                   const void* vecs, const void* adaln_w, const void* adaln_b, const void* dy,
                   void* dx, void* demb, void* dkv_cross, void* dmats, void* dvecs,
                   void* dadaln_w, void* dadaln_b, void* workspace, int* gemm_launches, int B,
                   int T, int t_valid, int E, int dh, cudaStream_t s) {
  constexpr bool kF32 = kIsF32<OT>;
  Work<OT> w;
  carve(&w, static_cast<unsigned char*>(workspace), B, T, E, dh);
  const OT *xo = static_cast<const OT*>(x), *eo = static_cast<const OT*>(emb);
  const OT *awo = static_cast<const OT*>(adaln_w), *dyo = static_cast<const OT*>(dy);
  const OT *kvco = static_cast<const OT*>(kv_cross), *mo = static_cast<const OT*>(mats);
  const float* vo = static_cast<const float*>(vecs);
  Inputs<OT> in{xo, kvco, mo, dyo, vo, T, t_valid, dh};
  const int rows = B * T;
  const long long dd = (long long)D * D;
  if constexpr (kF32) {
    w.mats_t = w.tr;
    w.kv_t = w.tr + 9 * dd;
    w.kvc_t = w.tr + (9 + B) * dd;
    w.dkv_t = w.tr + (9 + 2 * B) * dd;
  } else {
    w.mats_t = mo;
    w.kv_t = w.kv;
    w.kvc_t = kvco;
    w.dkv_t = w.dkvb;
  }

  static const cudaError_t attr[] = {
      cudaFuncSetAttribute(rows1_kernel<OT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmemRows<OT>),
      cudaFuncSetAttribute(rows2_kernel<OT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmemRows<OT>),
      cudaFuncSetAttribute(demb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem)};
  for (cudaError_t e : attr) RETURN_IF_ERROR(e);

  // 1. the AdaLN modulation, bias added
  RETURN_IF_ERROR(launch_adaln_gemm(emb, adaln_w, nullptr, nullptr,
                                    static_cast<const float*>(adaln_b), w.mod, 6 * D, rows, E,
                                    6 * D, 1, kF32 ? kAdalnF32 : kAdalnBf16, gemm_launches, s));
  // 2. the forward's KV, column statistics (and in bf16 KVr); in float32
  // the transposed operands of the row passes' A @ B^T products
  if constexpr (kF32) {
    RETURN_IF_ERROR(launch_kv_pass_f32(xo, mo, vo, w.partials, w.kv, w.stats, B, T, t_valid, dh, s));
    RETURN_IF_ERROR(launch_transpose(mo, w.tr, 9, s));
    RETURN_IF_ERROR(launch_transpose(w.kv, w.tr + 9 * dd, B, s));
    RETURN_IF_ERROR(launch_transpose(kvco, w.tr + (9 + B) * dd, B, s));
  } else {
    RETURN_IF_ERROR(launch_kv_pass(x, true, mo, vo, w.partials, w.kv, w.stats, w.kvr, B, T,
                                   t_valid, dh, s));
  }
  // 3. rows1
  const dim3 tiles(T / kRowsTile, B);
  rows1_kernel<OT><<<tiles, kThreadsC, kSmemRows<OT>, s>>>(in, w);
  RETURN_IF_ERROR(cudaGetLastError());
  // 4. dKV = q_sm^T dy1 and dKV_cross = qc_sm^T dy2, per clip
  AtbJobs<OT> kv_jobs{};
  kv_jobs.count = 2;
  kv_jobs.chunks = atb_chunks(2 * B, T / 64);
  kv_jobs.job[0] = {w.qs, w.dy1, w.dkv32, w.part, 2 * B * dd, D, D, D, D, B, T};
  kv_jobs.job[1] = {w.qcs, w.dy2, w.dkv32 + B * dd, w.part + B * dd, 2 * B * dd, D, D, D, D, B, T};
  RETURN_IF_ERROR(launch_atb(kv_jobs, s));
  if (kv_jobs.chunks > 1)
    RETURN_IF_ERROR(launch_sum(w.part, 2 * B * dd, kv_jobs.chunks, w.dkv32, 2 * B * dd, 1, s));
  // 5. combine (in float32, then dKV transposed)
  combine_kernel<OT><<<dim3(D, B), D, 0, s>>>(w, static_cast<OT*>(dkv_cross), B, dh);
  RETURN_IF_ERROR(cudaGetLastError());
  if constexpr (kF32) RETURN_IF_ERROR(launch_transpose(w.dkvb, w.tr + (9 + 2 * B) * dd, B, s));
  // 6. rows2
  rows2_kernel<OT><<<tiles, kThreadsC, kSmemRows<OT>, s>>>(in, w, static_cast<OT*>(dx));
  RETURN_IF_ERROR(cudaGetLastError());
  // 7. weight gradients over all B T rows, in row chunks, then summed
  const long long w_stride = 9 * dd + (long long)E * 6 * D;
  const OT* ops[9][2] = {{w.xn, w.dq},   {w.xn, w.dk},    {w.xn, w.dv},
                         {w.hs1, w.dx1b}, {w.xn2, w.dqc},  {w.hs2, w.dx2b},
                         {w.x2b, w.dz},  {w.h1, w.dy3},   {w.hs3, dyo}};
  AtbJobs<OT> w_jobs{};
  w_jobs.count = 10;
  w_jobs.chunks = atb_chunks(weight_tiles(E), rows / 64);
  float* dm = static_cast<float*>(dmats);
  for (int i = 0; i < 9; ++i)
    w_jobs.job[i] = {ops[i][0], ops[i][1], dm + i * dd, w.part + i * dd, w_stride, D, D, D, D, 1, rows};
  w_jobs.job[9] = {eo, w.dmod, static_cast<float*>(dadaln_w), w.part + 9 * dd, w_stride, E, 6 * D,
                   E, 6 * D, 1, rows};
  RETURN_IF_ERROR(launch_atb(w_jobs, s));
  if (w_jobs.chunks > 1) {
    RETURN_IF_ERROR(launch_sum(w.part, w_stride, w_jobs.chunks, dm, 9 * dd, 1, s));
    RETURN_IF_ERROR(launch_sum(w.part + 9 * dd, w_stride, w_jobs.chunks,
                               static_cast<float*>(dadaln_w), E * 6 * D, 1, s));
  }
  // 8. the column sums: slots into kSumGroups groups, then the groups
  const int n_slots = rows / kRowsTile * 8;
  RETURN_IF_ERROR(launch_sum(w.vp, kVecRows * D, n_slots, w.vg, kVecRows * D, kSumGroups, s));
  RETURN_IF_ERROR(launch_sum(w.vg, kVecRows * D, kSumGroups, static_cast<float*>(dvecs),
                             kVecUsed * D, 1, s));
  RETURN_IF_ERROR(launch_sum(w.vg + kDabRow * D, kVecRows * D, kSumGroups,
                             static_cast<float*>(dadaln_b), 6 * D, 1, s));
  RETURN_IF_ERROR(cudaMemsetAsync(static_cast<float*>(dvecs) + kVecUsed * D, 0,
                                  (24 - kVecUsed) * D * 4, s));
  // 9. d_emb
  const dim3 emb_tiles(E / 128, ceil_div(rows, 128));
  if constexpr (kF32)
    demb_f32_kernel<<<emb_tiles, kGemmThreads, 0, s>>>(w.dmod, awo, static_cast<float*>(demb),
                                                       rows, E);
  else
    demb_kernel<<<emb_tiles, kGemmThreads, kGemmSmem, s>>>(w.dmod, awo, static_cast<bf16*>(demb),
                                                          rows, E);
  return (int)cudaGetLastError();
}

bool bad_backward_shape(int T, int t_valid, int d, int E, int H, int mxu_f32) {
  return d != D || H < 1 || H > d || (d / H) * H != d || 32 % (d / H) != 0 || E % 128 != 0 ||
         !adaln_gemm_takes(E, 6 * D, mxu_f32 ? kAdalnF32 : kAdalnBf16) || T % kTileRows != 0 ||
         t_valid < 1 || t_valid > T;
}

}  // namespace

// The launches of one layer's backward at this width for clips of T rows,
// in the float32 mode (f32) or bf16: {the row passes' threads, tiles a
// clip, shared bytes; the A^T B and d_emb launches' threads, dynamic
// shared bytes (d_emb's float32 kernel: static)} (ops/decoder_layer_bwd.py
// `plan` computes the same).
CT_EXPORT int LAYER_EXPORT(decoder_layer_backward_plan)(int T, int f32, int* out) {
  const int v[5] = {kThreadsC, T / kRowsTile, (int)(f32 ? kSmemRows<float> : kSmemRows<bf16>),
                    kGemmThreads, kGemmSmem};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

// Workspace bytes of decoder_layer_backward in its mode (mxu_f32: float32);
// -1 for widths it does not take.
CT_EXPORT long long LAYER_EXPORT(decoder_layer_backward_workspace)(int B, int T, int d, int E, int H,
                                                     int mxu_f32) {
  if (d != D || H < 1 || H > d || E % 128 != 0) return -1;
  if (mxu_f32) {
    Work<float> w;
    return (long long)carve(&w, nullptr, B, T, E, d / H);
  }
  Work<bf16> w;
  return (long long)carve(&w, nullptr, B, T, E, d / H);
}

// mxu_f32: the float32 mode (x, emb, kv_cross, mats, adaln_w, dy and dx,
// demb, dkv_cross float32), else bf16; the weight gradients are float32 in
// both.  gemm_launches (int, host): raised by one for each launch of the
// AdaLN GEMM.
CT_EXPORT int LAYER_EXPORT(decoder_layer_backward)(const void* x, const void* emb, const void* kv_cross,
                                     const void* mats, const void* vecs, const void* adaln_w,
                                     const void* adaln_b, const void* dy, void* dx, void* demb,
                                     void* dkv_cross, void* dmats, void* dvecs, void* dadaln_w,
                                     void* dadaln_b, void* workspace, void* gemm_launches, int B,
                                     int T, int t_valid, int d, int E, int H, int mxu_f32,
                                     void* stream) {
  if (bad_backward_shape(T, t_valid, d, E, H, mxu_f32)) return (int)cudaErrorInvalidValue;
  auto run = [&](auto typed) {
    return layer_backward<decltype(typed)>(
        x, emb, kv_cross, mats, vecs, adaln_w, adaln_b, dy, dx, demb, dkv_cross, dmats, dvecs,
        dadaln_w, dadaln_b, workspace, static_cast<int*>(gemm_launches), B, T, t_valid, E, d / H,
        static_cast<cudaStream_t>(stream));
  };
  return mxu_f32 ? run(0.f) : run(bf16{});
}

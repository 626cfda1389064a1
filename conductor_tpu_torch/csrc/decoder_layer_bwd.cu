// K6: the backward of one decoder layer.
//
// Replaces conductor_tpu/ops/pallas_layer_bwd.py::fused_decoder_layer_train's
// backward (`_layer_bwd_kernel` :74-296, pallas_call at :321).  Given the
// layer's inputs (x bf16 (B, T, D), emb_act bf16 (B, T, E), kv_cross bf16
// (B, D, D), the weight banks) and dy (B, T, D), it emits dx, d_emb_act,
// d_kv_cross (in the inputs' dtypes) and d_mats (9, D, D), d_vecs (24, D),
// d_adaln_w (E, 6D), d_adaln_b (6D) in float32, with the JAX kernel's
// numerics: bf16 matmul operands with float32 accumulation, float32
// elementwise work, d_emb accumulated in bf16 across the three sublayers
// (FFN, then cross, then self), rows at or past t_valid carrying a -1e6
// key, zero value and no gradient.
//
// What bounds it on an H100.  Per clip and layer the backward is ~3x the
// forward's matrix work (~2 * T * (2 * E * 6D + 28 D^2) flops: the AdaLN
// product recomputed and its two gradients, d_emb and d_adaln_w, dominate),
// so tensor cores again; but it also has four reductions over all T rows of
// a clip (the forward's time softmax and KV, dKV = q_sm^T dy1, dKV_cross =
// qc_sm^T dy2, and the time-softmax backward's column sums) and weight
// gradients that reduce over every row of the batch.  The TPU kernel holds
// a whole clip in VMEM and accumulates the weight gradients over a
// sequential batch grid; Hopper blocks hold 64 rows and run in parallel.
//
// Design: the work is split at the reductions into launches, and every
// per-row intermediate that a later launch needs is kept in device memory
// (19 bf16 and 8 float32 (B*T, D) arrays, dMod and two AdaLN slices, ~0.5
// GB at B = 32, T = 960)
// instead of being recomputed: the card has 80 GB, a TPU core's VMEM a few
// tens of MB.  Per layer:
//   1. KV pass (decoder_stack.cu, bf16 x): KV_self as in K5, plus each
//      column's softmax max and sum (so rows can rebuild k_sm) and KVr =
//      k_sm^T bf16(v), float32.
//   2. rows1 (64-row tiles, 8 warps): recompute the forward (q_sm, y1, x1,
//      qc_sm, y2, x2, z, h1, y3), then the backward of the FFN, the cross
//      attention and the self-attention's StylizationBlock and query, down
//      to dq and dx1.  The three AdaLN slices are recomputed from emb_act
//      read straight from L2, each once: the forward keeps its two as
//      float32 rows for the backward.  Writes the bf16 operands of every weight
//      gradient, dMod (B*T, 6D) and per-warp column sums (bias, LN and
//      d_adaln_b gradients).
//   3. dKV and dKV_cross: per-clip A^T B products over the T rows (atb).
//   4. combine: dKV * seg to bf16, and the softmax backward's column sums
//      c = sum_l bf16(dKV)[d, l] * KVr[d, l] (= sum_t k_sm * dk_sm, using
//      sum_t k_sm v = KVr, exact in the JAX kernel's roundings), dKV_cross
//      to bf16.
//   5. rows2: rebuild k_sm and v, dk = k_sm (v dKV^T - c), dv = k_sm dKV,
//      dxn = dq Wq^T + dk Wk^T + dv Wv^T, the first LayerNorm's backward,
//      dx = dx1 + dLN.
//   6. weight gradients: per clip A^T B over its rows (atb: 9 (D, D)
//      products and emb^T dMod), then a sum over the clips in fixed order;
//      the column sums likewise.  No atomics: the result is deterministic.
//   7. d_emb = dMod_k aw_k^T for the three sublayers, each rounded to bf16
//      and added in bf16 in the JAX kernel's order.
// Plain WMMA (16x16x16 bf16, float32 accumulation), as in K1; no wgmma/TMA.

#include "layer_common.cuh"

using namespace layer;

namespace {

constexpr int kVecRows = 30;  // d_vecs rows 0-23, then d_adaln_b as 6 rows of D

// Per-row intermediates kept between the launches, and the reductions'
// scratch; carved out of one workspace.
struct Work {
  // bf16 (B*T, D): the operands of the weight and KV gradients
  bf16 *xn, *qs, *xn2, *qcs, *x2b, *h1, *hs1, *hs2, *hs3, *dy3, *dz, *dx2b, *dqc, *dy2, *dx1b,
      *dy1, *dq, *dk, *dv;
  bf16* dmod;  // (B*T, 6D)
  // float32 (B*T, D)
  float *qs32, *qcs32, *y1, *y2, *y3, *z, *x1, *dx1;
  float* mod;  // (B*T, 4D): the forward's AdaLN slices 0 and 1, reused by the backward
  // the KV pass and the combine
  float *partials, *stats, *kvr, *dkv32, *dkvc32, *cvec;
  bf16 *kv, *dkvb;
  // per-clip weight-gradient partials (B, 9 D^2 + E 6D) and per-warp column
  // sums (B * T / 64 * 8, kVecRows, D)
  float *wp, *vp;
};

size_t carve(Work* w, unsigned char* base, int B, int T, int E, int dh) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    void* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  const size_t n = (size_t)B * T;
  bf16** rows_b[] = {&w->xn, &w->qs, &w->xn2, &w->qcs, &w->x2b, &w->h1, &w->hs1, &w->hs2,
                     &w->hs3, &w->dy3, &w->dz, &w->dx2b, &w->dqc, &w->dy2, &w->dx1b, &w->dy1,
                     &w->dq, &w->dk, &w->dv};
  for (bf16** p : rows_b) *p = static_cast<bf16*>(take(n * D * 2));
  w->dmod = static_cast<bf16*>(take(n * 6 * D * 2));
  float** rows_f[] = {&w->qs32, &w->qcs32, &w->y1, &w->y2, &w->y3, &w->z, &w->x1, &w->dx1};
  for (float** p : rows_f) *p = static_cast<float*>(take(n * D * 4));
  w->mod = static_cast<float*>(take(n * 4 * D * 4));
  w->partials = static_cast<float*>(take(kv_pass_partials_bytes(B, T, dh, true)));
  w->stats = static_cast<float*>(take((size_t)B * 2 * D * 4));
  w->kvr = static_cast<float*>(take((size_t)B * D * dh * 4));
  w->dkv32 = static_cast<float*>(take((size_t)B * D * D * 4));
  w->dkvc32 = static_cast<float*>(take((size_t)B * D * D * 4));
  w->cvec = static_cast<float*>(take((size_t)B * D * 4));
  w->kv = static_cast<bf16*>(take((size_t)B * D * D * 2));
  w->dkvb = static_cast<bf16*>(take((size_t)B * D * D * 2));
  w->wp = static_cast<float*>(take((size_t)B * (9 * D * D + (size_t)E * 6 * D) * 4));
  w->vp = static_cast<float*>(take((size_t)n / kTileRows * 8 * kVecRows * D * 4));
  return off;
}

struct Inputs {
  const bf16 *x, *emb, *kvc, *mats, *aw, *dy;
  const float *vecs, *ab;
  int T, t_valid, E, dh;
};

constexpr size_t kSmemRows =
    (size_t)kTileRows * (3 * kLdF * 4 + kLdM * 4 + kLdA * 2);  // xs, ys, gs, ms, as

// Shared-memory tiles of the two row passes.
struct Tiles {
  float *xs, *ys, *gs, *ms;
  bf16* as;
  __device__ Tiles(unsigned char* smem) {
    xs = reinterpret_cast<float*>(smem);
    ys = xs + kTileRows * kLdF;
    gs = ys + kTileRows * kLdF;
    ms = gs + kTileRows * kLdF;
    as = reinterpret_cast<bf16*>(ms + kTileRows * kLdM);
  }
};

// The warp's per-column sums (lane owns columns lane + 32 i) into its slot
// of the column-sum partials.
__device__ __forceinline__ void put_sums(float* vp_slot, int row, const float s[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) vp_slot[row * D + lane + 32 * i] = s[i];
}

// Copy the warp's kRowsC rows of a float32 tile (stride kLdF) to a bf16
// operand tile (stride kLdA) and, if `dst` is given, to global rows.
__device__ __forceinline__ void rows_to_bf16(const float* src, bf16* op, bf16* dst) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < kRowsC * D; i += 32) {
    const bf16 v = __float2bfloat16(src[(i / D) * kLdF + i % D]);
    op[(i / D) * kLdA + i % D] = v;
    if (dst) dst[i] = v;
  }
}

// The backward of one StylizationBlock out = silu(LN(y) * (1 + scale) +
// shift) @ W + b, for the warp's rows (`_layer_bwd_kernel.styl_bwd`):
// y from global float32 rows, the AdaLN slice in `mod` (row stride ldm; +
// ab), the upstream
// gradient `dout` (float32 tile rows) and dhs = dout @ W^T in yw.  Writes
// hs = bf16(h * sigmoid(h)) and dMod (2D columns at dmod_col) to global,
// dy into yw, and the column sums of dout, dg, db, dscale, dshift.
__device__ void styl_bwd_rows(const float* y, const float* dout, float* yw, const float* mod,
                              int ldm, const float* ab, const float* g, const float* gb, bf16* hs_out,
                              bf16* dmod, int dmod_col, float* vp_slot, int gi, int bi, int boi,
                              int dab_row) {
  const int lane = threadIdx.x & 31;
  float s_do[4] = {}, s_dg[4] = {}, s_db[4] = {}, s_sc[4] = {}, s_sh[4] = {};
  for (int r = 0; r < kRowsC; ++r) {
    float v[4], xhat[4], dln[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = y[(size_t)r * D + lane + 32 * i];
    const float2 st = ln_stats(v);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i;
      xhat[i] = (v[i] - st.x) * st.y;
      const float ln_y = xhat[i] * g[c] + gb[c];
      const float scale = mod[(size_t)r * ldm + c] + ab[c];
      const float shift = mod[(size_t)r * ldm + D + c] + ab[D + c];
      const float h = ln_y * (1.f + scale) + shift;
      const float sg = 1.f / (1.f + expf(-h));
      hs_out[(size_t)r * D + c] = __float2bfloat16(h * sg);
      const float dh = yw[r * kLdF + c] * sg * (1.f + h * (1.f - sg));
      dmod[(size_t)r * 6 * D + dmod_col + c] = __float2bfloat16(dh * ln_y);
      dmod[(size_t)r * 6 * D + dmod_col + D + c] = __float2bfloat16(dh);
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
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i;
      yw[r * kLdF + c] = st.y * (dln[i] * g[c] - m1 - xhat[i] * m2);
    }
  }
  put_sums(vp_slot, boi, s_do);
  put_sums(vp_slot, gi, s_dg);
  put_sums(vp_slot, bi, s_db);
  put_sums(vp_slot, 24 + dab_row, s_sc);
  put_sums(vp_slot, 24 + dab_row + 1, s_sh);
}

// Softmax-within-heads backward for the warp's rows: ds in yw, s (float32)
// from global; dq = s * ds - s * sum_head bf16(ds * s) (the JAX kernel's
// seg matmul).  Writes bf16(dq) to `op` and `dst`, sums into vp row `row`.
__device__ void head_softmax_bwd_rows(const float* yw, const float* s32, bf16* op, bf16* dst,
                                      float* vp_slot, int row, int dh) {
  const int lane = threadIdx.x & 31;
  float sum[4] = {};
  for (int r = 0; r < kRowsC; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i;
      const float s = s32[(size_t)r * D + c], ds = yw[r * kLdF + c];
      const float dot = head_sum(round_bf16(ds * s), dh);
      const float dq = s * ds - s * dot;
      sum[i] += dq;
      const bf16 q = __float2bfloat16(dq);
      op[r * kLdA + c] = q;
      dst[(size_t)r * D + c] = q;
    }
  put_sums(vp_slot, row, sum);
}

// LayerNorm backward for the warp's rows: input rows x (float32, stride
// ldx), upstream dxn in yw, gain g; acc += dLN; column sums into vp rows
// gi (dg) and gi + 1 (db).
__device__ void ln_bwd_rows(const float* x, int ldx, const float* yw, const float* g,
                            float* acc, float* vp_slot, int gi) {
  const int lane = threadIdx.x & 31;
  float s_dg[4] = {}, s_db[4] = {};
  for (int r = 0; r < kRowsC; ++r) {
    float v[4], xhat[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = x[(size_t)r * ldx + lane + 32 * i];
    const float2 st = ln_stats(v);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
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
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i;
      acc[r * kLdF + c] += st.y * (yw[r * kLdF + c] * g[c] - m1 - xhat[i] * m2);
    }
  }
  put_sums(vp_slot, gi, s_dg);
  put_sums(vp_slot, gi + 1, s_db);
}

// ------------------------------------------------------------- rows1
__global__ void __launch_bounds__(kThreadsC) rows1_kernel(Inputs in, Work w) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tiles t(smem);
  const int b = blockIdx.y, wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T = in.T, E = in.E, dh = in.dh;
  const size_t tile_row = (size_t)b * T + blockIdx.x * kTileRows;
  const int wo = wid * kRowsC;
  const size_t wrow = tile_row + wo;  // the warp's first global row
  float *xw = t.xs + wo * kLdF, *yw = t.ys + wo * kLdF, *gw = t.gs + wo * kLdF;
  float* mw = t.ms + wo * kLdM;
  bf16* aw = t.as + wo * kLdA;
  float* vp = w.vp + ((tile_row / kTileRows) * 8 + wid) * kVecRows * D;
  const float* vec = in.vecs;
  auto W = [&](int i) { return in.mats + (size_t)i * D * D; };
  auto R = [&](auto* p) { return p + wrow * D; };  // the warp's rows of a (B*T, D) array
  const bf16* emb_tile = in.emb + tile_row * E;
  auto mod = [&](int j) { block_gemm(emb_tile, E, in.aw + j * 2 * D, 6 * D, E, 2 * D, t.ms, kLdM); };
  // float32 rows of the warp's tile: y (= yw) + bias -> global
  auto store_rows = [&](float* dst, const float* src, const float* bias) {
    for (int i = lane; i < kRowsC * D; i += 32) {
      const float v = src[(i / D) * kLdF + i % D] + (bias ? bias[i % D] : 0.f);
      if (bias) yw[(i / D) * kLdF + i % D] = v;
      dst[i] = v;
    }
  };
  // LN -> q -> head softmax for an attention sublayer: q_sm into as and
  // global (bf16 and float32)
  auto query = [&](int g, const bf16* wq, int bq, bf16* xn, bf16* s16, float* s32) {
    warp_ln_bf16<kRowsC>(xw, vec + g * D, vec + (g + 1) * D, aw);
    for (int i = lane; i < kRowsC * D; i += 32) R(xn)[i] = aw[(i / D) * kLdA + i % D];
    __syncthreads();
    block_gemm(t.as, kLdA, wq, D, D, D, t.ys, kLdF);
    __syncthreads();
    for (int r = 0; r < kRowsC; ++r) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = yw[r * kLdF + lane + 32 * i] + vec[bq * D + lane + 32 * i];
      head_softmax_row(v, dh);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane + 32 * i;
        R(s32)[r * D + c] = v[i];
        aw[r * kLdA + c] = R(s16)[r * D + c] = __float2bfloat16(v[i]);
      }
    }
    __syncthreads();
  };
  // forward StylizationBlock + residual: x += silu(AdaLN(y)) @ W + b
  auto stylize = [&](int j, int g, int wi, int b_out) {
    mod(j);
    __syncthreads();
    for (int i = lane; i < kRowsC * 2 * D; i += 32)
      w.mod[(wrow + i / (2 * D)) * 4 * D + j * 2 * D + i % (2 * D)] = mw[(i / (2 * D)) * kLdM + i % (2 * D)];
    warp_adaln_bf16<kRowsC>(yw, nullptr, mw, in.ab + j * 2 * D, vec + g * D, vec + (g + 1) * D, aw);
    __syncthreads();
    block_gemm(t.as, kLdA, W(wi), D, D, D, t.ys, kLdF);
    __syncthreads();
    for (int i = lane; i < kRowsC * D; i += 32)
      xw[(i / D) * kLdF + i % D] += yw[(i / D) * kLdF + i % D] + vec[b_out * D + i % D];
    __syncwarp();
  };

  for (int i = threadIdx.x; i < kTileRows * D / 4; i += kThreadsC)
    store4(t.xs + (i / (D / 4)) * kLdF + (i % (D / 4)) * 4, load4(in.x + tile_row * D + 4 * i));
  __syncthreads();

  // ---- forward, keeping what the backward reads
  query(kLnSelfG, W(kWq), kBq, w.xn, w.qs, w.qs32);
  block_gemm(t.as, kLdA, w.kv + (size_t)b * D * D, D, D, D, t.ys, kLdF);
  __syncthreads();
  store_rows(R(w.y1), yw, nullptr);
  stylize(0, kStylSelfG, kWStylSelf, kStylSelfOut);
  store_rows(R(w.x1), xw, nullptr);
  query(kLnCrossG, W(kWqCross), kBqCross, w.xn2, w.qcs, w.qcs32);
  block_gemm(t.as, kLdA, in.kvc + (size_t)b * D * D, D, D, D, t.ys, kLdF);
  __syncthreads();
  store_rows(R(w.y2), yw, nullptr);
  stylize(1, kStylCrossG, kWStylCross, kStylCrossOut);
  rows_to_bf16(xw, aw, R(w.x2b));  // x2
  __syncthreads();
  block_gemm(t.as, kLdA, W(kW1), D, D, D, t.ys, kLdF);
  __syncthreads();
  store_rows(R(w.z), yw, vec + kB1 * D);  // z = x2 W1 + b1, kept in yw
  for (int i = lane; i < kRowsC * D; i += 32)
    aw[(i / D) * kLdA + i % D] = R(w.h1)[i] = __float2bfloat16(gelu_tanh(yw[(i / D) * kLdF + i % D]));
  __syncthreads();
  block_gemm(t.as, kLdA, W(kW2), D, D, D, t.ys, kLdF);
  __syncthreads();
  store_rows(R(w.y3), yw, vec + kB2 * D);

  // ---- FFN backward: dy into gs (float32) and as (bf16)
  for (int i = threadIdx.x; i < kTileRows * D / 4; i += kThreadsC) {
    const float4 v = load4(in.dy + tile_row * D + 4 * i);
    store4(t.gs + (i / (D / 4)) * kLdF + (i % (D / 4)) * 4, v);
    store4(t.as + (i / (D / 4)) * kLdA + (i % (D / 4)) * 4, v);
  }
  __syncthreads();
  mod(2);
  block_gemm<true>(t.as, kLdA, W(kWStylFfn), D, D, D, t.ys, kLdF);
  __syncthreads();
  styl_bwd_rows(R(w.y3), gw, yw, mw, kLdM, in.ab + 4 * D, vec + kStylFfnG * D, vec + kStylFfnB * D,
                R(w.hs3), w.dmod + wrow * 6 * D, 4 * D, vp, kStylFfnG, kStylFfnB, kStylFfnOut, 4);
  {  // dy3: column sums (d b2), bf16 operand
    float s[4] = {};
    for (int r = 0; r < kRowsC; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] += yw[r * kLdF + lane + 32 * i];
    put_sums(vp, kB2, s);
  }
  rows_to_bf16(yw, aw, R(w.dy3));
  __syncthreads();
  block_gemm<true>(t.as, kLdA, W(kW2), D, D, D, t.ys, kLdF);  // dh1
  __syncthreads();
  {  // dz = gelu'(z) dh1
    float s[4] = {};
    for (int r = 0; r < kRowsC; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane + 32 * i;
        const float z = R(w.z)[r * D + c];
        const float u = 0.7978845608028654f * (z + 0.044715f * z * z * z);
        const float th = tanhf(u);
        const float du = 0.7978845608028654f * (1.f + 3.f * 0.044715f * z * z);
        const float dz = yw[r * kLdF + c] * (0.5f * (1.f + th) + 0.5f * z * (1.f - th * th) * du);
        s[i] += dz;
        aw[r * kLdA + c] = R(w.dz)[r * D + c] = __float2bfloat16(dz);
      }
    put_sums(vp, kB1, s);
  }
  __syncthreads();
  block_gemm<true>(t.as, kLdA, W(kW1), D, D, D, t.gs, kLdF, true);  // dx2 = dy + dz W1^T
  __syncthreads();

  // ---- cross attention backward
  rows_to_bf16(gw, aw, R(w.dx2b));
  __syncthreads();
  block_gemm<true>(t.as, kLdA, W(kWStylCross), D, D, D, t.ys, kLdF);
  __syncthreads();
  styl_bwd_rows(R(w.y2), gw, yw, w.mod + wrow * 4 * D + 2 * D, 4 * D, in.ab + 2 * D, vec + kStylCrossG * D, vec + kStylCrossB * D,
                R(w.hs2), w.dmod + wrow * 6 * D, 2 * D, vp, kStylCrossG, kStylCrossB,
                kStylCrossOut, 2);
  rows_to_bf16(yw, aw, R(w.dy2));
  __syncthreads();
  block_gemm<true>(t.as, kLdA, in.kvc + (size_t)b * D * D, D, D, D, t.ys, kLdF);  // dqc_sm
  __syncthreads();
  head_softmax_bwd_rows(yw, R(w.qcs32), aw, R(w.dqc), vp, kBqCross, dh);
  __syncthreads();
  block_gemm<true>(t.as, kLdA, W(kWqCross), D, D, D, t.ys, kLdF);  // dxn2
  __syncthreads();
  ln_bwd_rows(R(w.x1), D, yw, vec + kLnCrossG * D, gw, vp, kLnCrossG);  // gs: dx1
  __syncwarp();

  // ---- self attention: StylizationBlock and query backward
  rows_to_bf16(gw, aw, R(w.dx1b));
  for (int i = lane; i < kRowsC * D; i += 32) R(w.dx1)[i] = gw[(i / D) * kLdF + i % D];
  __syncthreads();
  block_gemm<true>(t.as, kLdA, W(kWStylSelf), D, D, D, t.ys, kLdF);
  __syncthreads();
  styl_bwd_rows(R(w.y1), gw, yw, w.mod + wrow * 4 * D, 4 * D, in.ab, vec + kStylSelfG * D, vec + kStylSelfB * D,
                R(w.hs1), w.dmod + wrow * 6 * D, 0, vp, kStylSelfG, kStylSelfB, kStylSelfOut, 0);
  rows_to_bf16(yw, aw, R(w.dy1));
  __syncthreads();
  block_gemm<true>(t.as, kLdA, w.kv + (size_t)b * D * D, D, D, D, t.ys, kLdF);  // dq_sm
  __syncthreads();
  head_softmax_bwd_rows(yw, R(w.qs32), aw, R(w.dq), vp, kBq, dh);
}

// ------------------------------------------------------------- rows2
__global__ void __launch_bounds__(kThreadsC) rows2_kernel(Inputs in, Work w, bf16* dx) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tiles t(smem);
  const int b = blockIdx.y, wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T = in.T;
  const size_t tile_row = (size_t)b * T + blockIdx.x * kTileRows;
  const int wo = wid * kRowsC;
  const size_t wrow = tile_row + wo;
  float *xw = t.xs + wo * kLdF, *yw = t.ys + wo * kLdF, *gw = t.gs + wo * kLdF;
  float* mw = t.ms + wo * kLdM;
  bf16* aw = t.as + wo * kLdA;
  float* vp = w.vp + ((tile_row / kTileRows) * 8 + wid) * kVecRows * D;
  const float* vec = in.vecs;
  const float* stats = w.stats + (size_t)b * 2 * D;
  const float* cvec = w.cvec + (size_t)b * D;
  const bf16* dkv = w.dkvb + (size_t)b * D * D;
  auto W = [&](int i) { return in.mats + (size_t)i * D * D; };
  auto load_op = [&](const bf16* src) {  // a (64, D) bf16 tile from global into as
    for (int i = threadIdx.x; i < kTileRows * D / 8; i += kThreadsC)
      *reinterpret_cast<uint4*>(t.as + (i / (D / 8)) * kLdA + (i % (D / 8)) * 8) =
          reinterpret_cast<const uint4*>(src + tile_row * D)[i];
  };

  for (int i = threadIdx.x; i < kTileRows * D / 4; i += kThreadsC)
    store4(t.xs + (i / (D / 4)) * kLdF + (i % (D / 4)) * 4, load4(in.x + tile_row * D + 4 * i));
  load_op(w.xn);
  __syncthreads();
  block_gemm(t.as, kLdA, W(kWk), D, D, D, t.ys, kLdF);
  block_gemm(t.as, kLdA, W(kWv), D, D, D, t.gs, kLdF);
  __syncthreads();
  // k_sm (ys) and v (gs), masked past t_valid; bf16(v) into as
  for (int r = 0; r < kRowsC; ++r) {
    const bool valid = blockIdx.x * kTileRows + wo + r < in.t_valid;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i;
      const float k = yw[r * kLdF + c] + vec[kBk * D + c];
      yw[r * kLdF + c] = valid ? expf(k - stats[c]) / stats[D + c] : 0.f;
      const float v = valid ? gw[r * kLdF + c] + vec[kBv * D + c] : 0.f;
      aw[r * kLdA + c] = __float2bfloat16(v);
    }
  }
  __syncthreads();
  block_gemm<true>(t.as, kLdA, dkv, D, D, D, t.ms, kLdM);  // dk_sm = v dKV^T
  __syncthreads();
  rows_to_bf16(yw, aw, nullptr);  // bf16(k_sm)
  __syncthreads();
  block_gemm(t.as, kLdA, dkv, D, D, D, t.ms + D, kLdM);  // dv = k_sm dKV
  __syncthreads();
  {  // time-softmax backward: dk = k_sm (dk_sm - c); masked rows give 0
    float sk[4] = {}, sv[4] = {};
    for (int r = 0; r < kRowsC; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane + 32 * i;
        const bool valid = blockIdx.x * kTileRows + wo + r < in.t_valid;
        const float dk = valid ? yw[r * kLdF + c] * (mw[r * kLdM + c] - cvec[c]) : 0.f;
        const float dv = valid ? mw[r * kLdM + D + c] : 0.f;
        mw[r * kLdM + c] = dk;
        mw[r * kLdM + D + c] = dv;
        sk[i] += dk;
        sv[i] += dv;
        w.dk[(wrow + r) * D + c] = __float2bfloat16(dk);
        w.dv[(wrow + r) * D + c] = __float2bfloat16(dv);
      }
    put_sums(vp, kBk, sk);
    put_sums(vp, kBv, sv);
  }
  __syncthreads();
  // dxn = dq Wq^T + dk Wk^T + dv Wv^T, into gs
  load_op(w.dq);
  __syncthreads();
  block_gemm<true>(t.as, kLdA, W(kWq), D, D, D, t.gs, kLdF);
  __syncthreads();
  for (int i = lane; i < kRowsC * D; i += 32)
    aw[(i / D) * kLdA + i % D] = __float2bfloat16(mw[(i / D) * kLdM + i % D]);
  __syncthreads();
  block_gemm<true>(t.as, kLdA, W(kWk), D, D, D, t.gs, kLdF, true);
  __syncthreads();
  for (int i = lane; i < kRowsC * D; i += 32)
    aw[(i / D) * kLdA + i % D] = __float2bfloat16(mw[(i / D) * kLdM + D + i % D]);
  __syncthreads();
  block_gemm<true>(t.as, kLdA, W(kWv), D, D, D, t.gs, kLdF, true);
  __syncthreads();
  // first LayerNorm backward; dx = dx1 + dLN
  for (int i = lane; i < kRowsC * D; i += 32)
    yw[(i / D) * kLdF + i % D] = gw[(i / D) * kLdF + i % D];
  for (int i = lane; i < kRowsC * D; i += 32)
    gw[(i / D) * kLdF + i % D] = w.dx1[wrow * D + i];
  __syncwarp();
  ln_bwd_rows(xw, kLdF, yw, vec + kLnSelfG * D, gw, vp, kLnSelfG);
  __syncwarp();
  for (int i = lane; i < kRowsC * D; i += 32)
    dx[wrow * D + i] = __float2bfloat16(gw[(i / D) * kLdF + i % D]);
}

// ------------------------------------------------------------- A^T B
// C[b] (M x N) = sum over the T rows of clip b of A[row, :M]^T B[row, :N]
// (bf16, float32 accumulation), one 64 x 64 tile of one job per block of 4
// warps, each warp 32 x 32.  blockIdx = (tile, clip, job).
struct AtbJob {
  const bf16* a;
  const bf16* b;
  float* c;
  int m, n, lda, ldb;
  long long c_stride;  // between clips
};
struct AtbJobs {
  AtbJob job[10];
};

__global__ void __launch_bounds__(128) atb_kernel(AtbJobs jobs, int T) {
  const AtbJob& j = jobs.job[blockIdx.z];
  const int tiles_m = j.m / 64;
  if ((int)blockIdx.x >= tiles_m * (j.n / 64)) return;
  const int wid = threadIdx.x >> 5;
  const int m0 = (blockIdx.x % tiles_m) * 64 + (wid & 1) * 32;
  const int n0 = (blockIdx.x / tiles_m) * 64 + (wid >> 1) * 32;
  const bf16* a = j.a + (size_t)blockIdx.y * T * j.lda;
  const bf16* bb = j.b + (size_t)blockIdx.y * T * j.ldb;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
  FragC acc[2][2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q) wmma::fill_fragment(acc[p][q], 0.f);
  for (int k = 0; k < T; k += 16) {
    FragAT fa[2];
    FragB fb[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      wmma::load_matrix_sync(fa[p], a + (size_t)k * j.lda + m0 + 16 * p, j.lda);
      wmma::load_matrix_sync(fb[p], bb + (size_t)k * j.ldb + n0 + 16 * p, j.ldb);
    }
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < 2; ++q) wmma::mma_sync(acc[p][q], fa[p], fb[q], acc[p][q]);
  }
  float* c = j.c + blockIdx.y * j.c_stride;
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      wmma::store_matrix_sync(c + (size_t)(m0 + 16 * p) * j.n + n0 + 16 * q, acc[p][q], j.n,
                              wmma::mem_row_major);
}

// out[i] = sum_{g < G} in[g * stride + i], g in order: deterministic.
__global__ void sum_kernel(const float* __restrict__ in, long long stride, int G,
                           float* __restrict__ out, int n) {
  __shared__ float part[32][33];
  const int i = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (i < n)
    for (int g = threadIdx.y; g < G; g += blockDim.y) s += in[(size_t)g * stride + i];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < n) {
    float total = 0.f;
    for (int y = 0; y < (int)blockDim.y; ++y) total += part[y][threadIdx.x];
    out[i] = total;
  }
}

// dKV -> bf16(dKV * seg) and the softmax backward's column sums
// c[d] = sum_l bf16(dKV)[d, l] KVr[d, l]; dKV_cross -> bf16.  One block
// per clip, one thread per row d.
__global__ void combine_kernel(Work w, bf16* dkvc, int dh) {
  const int b = blockIdx.x, d = threadIdx.x;
  const size_t base = ((size_t)b * D + d) * D;
  float c = 0.f;
  for (int l = 0; l < D; ++l) {
    const bool same = d / dh == l / dh;
    const bf16 v = __float2bfloat16(same ? w.dkv32[base + l] : 0.f);
    w.dkvb[base + l] = v;
    if (same) c += __bfloat162float(v) * w.kvr[((size_t)b * D + d) * dh + l % dh];
    dkvc[base + l] = __float2bfloat16(w.dkvc32[base + l]);
  }
  w.cvec[(size_t)b * D + d] = c;
}

// d_emb[r, e] = bf16(bf16(bf16(A_2) + bf16(A_1)) + bf16(A_0)), A_j = dMod[r,
// j-th 2D slice] @ aw[e, same slice]^T: the JAX kernel's bf16 accumulation
// across the sublayers (FFN, cross, self).  64 x 64 tiles, 4 warps of 32 x 32.
__global__ void __launch_bounds__(128) demb_kernel(const bf16* __restrict__ dmod,
                                                   const bf16* __restrict__ aw,
                                                   bf16* __restrict__ demb, int E) {
  __shared__ __align__(32) float out[4][32 * 32];
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t r0 = (size_t)blockIdx.x * 64 + (wid & 1) * 32;
  const int e0 = blockIdx.y * 64 + (wid >> 1) * 32;
  FragC res[2][2];
  for (int j = 2; j >= 0; --j) {
    FragC acc[2][2];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < 2; ++q) wmma::fill_fragment(acc[p][q], 0.f);
    for (int k = j * 2 * D; k < (j + 1) * 2 * D; k += 16) {
      FragA fa[2];
      FragBT fb[2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        wmma::load_matrix_sync(fa[p], dmod + (r0 + 16 * p) * 6 * D + k, 6 * D);
        wmma::load_matrix_sync(fb[p], aw + (size_t)(e0 + 16 * p) * 6 * D + k, 6 * D);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int q = 0; q < 2; ++q) wmma::mma_sync(acc[p][q], fa[p], fb[q], acc[p][q]);
    }
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        for (int i = 0; i < acc[p][q].num_elements; ++i) {
          const float a = round_bf16(acc[p][q].x[i]);
          res[p][q].x[i] = j == 2 ? a : round_bf16(res[p][q].x[i] + a);
        }
  }
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      wmma::store_matrix_sync(out[wid] + 16 * p * 32 + 16 * q, res[p][q], 32, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 32 * 32; i += 32)
    demb[(r0 + i / 32) * E + e0 + i % 32] = __float2bfloat16(out[wid][i]);
}

}  // namespace

CT_EXPORT long long decoder_layer_backward_workspace(int B, int T, int d, int E, int H) {
  Work w;
  return d == D && H > 0 ? (long long)carve(&w, nullptr, B, T, E, d / H) : -1;
}

CT_EXPORT int decoder_layer_backward(const void* x, const void* emb, const void* kv_cross,
                                     const void* mats, const void* vecs, const void* adaln_w,
                                     const void* adaln_b, const void* dy, void* dx, void* demb,
                                     void* dkv_cross, void* dmats, void* dvecs, void* dadaln_w,
                                     void* dadaln_b, void* workspace, int B, int T, int t_valid,
                                     int d, int E, int H, void* stream) {
  const int dh = d / H;
  if (d != D || dh * H != d || 32 % dh != 0 || E % 64 != 0 || T % kTileRows != 0 || t_valid < 1 ||
      t_valid > T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Work w;
  carve(&w, static_cast<unsigned char*>(workspace), B, T, E, dh);
  Inputs in{static_cast<const bf16*>(x), static_cast<const bf16*>(emb),
            static_cast<const bf16*>(kv_cross), static_cast<const bf16*>(mats),
            static_cast<const bf16*>(adaln_w), static_cast<const bf16*>(dy),
            static_cast<const float*>(vecs), static_cast<const float*>(adaln_b), T, t_valid, E, dh};
  const int n_tiles = T / kTileRows;
  const size_t n_slots = (size_t)B * n_tiles * 8;

  static const cudaError_t attr1 = cudaFuncSetAttribute(
      rows1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemRows);
  static const cudaError_t attr2 = cudaFuncSetAttribute(
      rows2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemRows);
  if (attr1 != cudaSuccess) return (int)attr1;
  if (attr2 != cudaSuccess) return (int)attr2;
  cudaError_t err = cudaMemsetAsync(w.vp, 0, n_slots * kVecRows * D * 4, s);
  if (err != cudaSuccess) return (int)err;

  // 1. the forward's KV, column statistics and KVr
  err = launch_kv_pass(x, true, in.mats, in.vecs, w.partials, w.kv, w.stats, w.kvr, B, T, t_valid,
                       dh, s);
  if (err != cudaSuccess) return (int)err;
  // 2. rows1
  const dim3 tiles(n_tiles, B);
  rows1_kernel<<<tiles, kThreadsC, kSmemRows, s>>>(in, w);
  // 3. dKV = q_sm^T dy1 and dKV_cross = qc_sm^T dy2, per clip
  const long long dd = (long long)D * D;
  AtbJobs kv_jobs{};
  kv_jobs.job[0] = {w.qs, w.dy1, w.dkv32, D, D, D, D, dd};
  kv_jobs.job[1] = {w.qcs, w.dy2, w.dkvc32, D, D, D, D, dd};
  atb_kernel<<<dim3(4, B, 2), 128, 0, s>>>(kv_jobs, T);
  // 4. combine
  combine_kernel<<<B, D, 0, s>>>(w, static_cast<bf16*>(dkv_cross), dh);
  // 5. rows2
  rows2_kernel<<<tiles, kThreadsC, kSmemRows, s>>>(in, w, static_cast<bf16*>(dx));
  // 6. weight gradients, per clip, then summed over the clips
  const long long wp_stride = 9 * dd + (long long)E * 6 * D;
  const bf16* ops[9][2] = {{w.xn, w.dq},   {w.xn, w.dk},    {w.xn, w.dv},
                           {w.hs1, w.dx1b}, {w.xn2, w.dqc},  {w.hs2, w.dx2b},
                           {w.x2b, w.dz},  {w.h1, w.dy3},   {w.hs3, in.dy}};
  AtbJobs mat_jobs{};
  for (int i = 0; i < 9; ++i) mat_jobs.job[i] = {ops[i][0], ops[i][1], w.wp + i * dd, D, D, D, D, wp_stride};
  atb_kernel<<<dim3(4, B, 9), 128, 0, s>>>(mat_jobs, T);
  AtbJobs aw_jobs{};
  aw_jobs.job[0] = {in.emb, w.dmod, w.wp + 9 * dd, E, 6 * D, E, 6 * D, wp_stride};
  atb_kernel<<<dim3((E / 64) * (6 * D / 64), B, 1), 128, 0, s>>>(aw_jobs, T);
  const dim3 sum_block(32, 32);
  sum_kernel<<<ceil_div(9 * D * D, 32), sum_block, 0, s>>>(w.wp, wp_stride, B,
                                                           static_cast<float*>(dmats), 9 * D * D);
  sum_kernel<<<ceil_div(E * 6 * D, 32), sum_block, 0, s>>>(w.wp + 9 * dd, wp_stride, B,
                                                           static_cast<float*>(dadaln_w), E * 6 * D);
  sum_kernel<<<ceil_div(24 * D, 32), sum_block, 0, s>>>(w.vp, kVecRows * D, (int)n_slots,
                                                        static_cast<float*>(dvecs), 24 * D);
  sum_kernel<<<ceil_div(6 * D, 32), sum_block, 0, s>>>(w.vp + 24 * D, kVecRows * D, (int)n_slots,
                                                       static_cast<float*>(dadaln_b), 6 * D);
  // 7. d_emb
  demb_kernel<<<dim3(B * T / 64, E / 64), 128, 0, s>>>(w.dmod, in.aw, static_cast<bf16*>(demb), E);
  return (int)cudaGetLastError();
}

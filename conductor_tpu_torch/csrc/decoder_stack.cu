// K1: all decoder layers of one denoiser step, and K5: one decoder layer.
//
// K1 replaces conductor_tpu/ops/pallas_layer.py::fused_decoder_stack (layer
// body `_layer_body` :60-160, `_stack_kernel` :177-207, pallas_call at
// :317); K5 replaces ::fused_decoder_layer (`_layer_kernel` :163-174,
// pallas_call at :233), the forward of the training layer.  Per layer: AdaLN modulation mod = emb_act @ W_adaln + b -> LN ->
// q, k, v -> q feature-softmax per head, k softmax over the whole clip,
// KV = k_sm^T v (float32, block-diagonal) -> q_sm @ KV -> StylizationBlock +
// residual -> cross-attention q_sm @ KV_cross -> StylizationBlock + residual
// -> tanh-GELU FFN -> StylizationBlock + residual.
//
// What bounds it on an H100: per step and clip it is ~2*T*(E*6D + 11*D^2)*L
// = 16.5 GFLOP of small-K matrix products (the AdaLN product is ~68 %), so
// tensor cores are the unit to use; the data (residual 0.9 MB, emb_act
// 1.8 MB bf16 per clip, 1.0 MB of weights a layer) fits in the 50 MB L2.
// The TPU kernel holds a whole (T = 1800, D) clip in VMEM per grid step; a
// Hopper block has 227 KB of shared memory, and k's time softmax and KV are
// reductions over all T rows.  Design, per layer, three launches over 64-row
// tiles:
//   A  kv_partials (4 warps): LN -> k, v (bf16 WMMA, float32 accumulation) and, per
//      tile, k's column max m, sum of exp(k - m) and the block-diagonal
//      partial exp(k - m)^T v, online-softmax style, in float32.  Rows >= T
//      are left out (the TPU kernel masks its pad rows with k = -1e6, v = 0,
//      which gives them exactly zero weight).
//   B  kv_combine: rescales and sums the tile partials into KV, then rounds
//      it to bf16 as the JAX kernel does before its q_sm @ KV product.
//   C  layer_rows (8 warps): the rest of the layer.  The tile's residual rows, emb_act
//      rows, matmul operand and output and a 256-wide slice of the AdaLN
//      output live in shared memory (213 KB at E = 512).
// Shared-memory rows are padded (float32 +4, bf16 +8 elements), so the 16
// rows of a WMMA tile fall on different banks instead of all on one.
// Matrix products (`block_gemm`): each warp computes 32 output columns of
// all 64 rows (or of 32 rows when there are fewer 32-column slices than
// warps), so one weight fragment, read from global memory (L2), feeds four
// (two) MMAs, and the weight fragments of the next kPrefetch k-steps are in
// flight while this one's MMAs issue.  A warp-serial design (16 rows a warp,
// every fragment loaded by every warp) measured 4-8x slower: its chain of
// dependent L2 loads bounded it.  Pass C's 213 KB of shared memory leaves
// one block per SM, so it runs 8 warps to give each SM sub-partition two
// warps to issue from.  Row-wise work (LayerNorm, softmax, AdaLN, GELU,
// residual) runs one warp per 16 (pass A) or 8 (pass C) rows.  The residual
// stream lives in device memory between launches (in place after layer 0).
// Plain WMMA, no wgmma/TMA yet.  The tile helpers live in layer_common.cuh,
// shared with K6.
//
// K5 is one layer of the same three launches (`decoder_layer_forward`),
// with the residual read and written in bf16 (the training path carries it
// in the compute dtype between layers, JAX `train/fused_denoiser.py:
// 304-323`) and float32 inside.  Its input is padded to whole 64-row tiles;
// rows at or past t_valid are left out of the KV pass, as the TPU kernel
// masks them, and still computed by the row pass.

#include "layer_common.cuh"

using namespace layer;

namespace {

// ---------------------------------------------------------------- pass A
// XT: the residual's storage type (float for K1, bf16 for K5 / K6).  With
// kKvr (K6) each tile also gives exp(k - m)^T bf16(v), block-diagonal.
template <typename XT, bool kKvr>
__global__ void __launch_bounds__(kThreadsA)
kv_partials_kernel(const XT* x, const bf16* __restrict__ mats, const float* __restrict__ vecs,
                   float* __restrict__ partials, int T, int t_valid, int dh, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);                          // (64, kLdA)
  float* k_s = reinterpret_cast<float*>(smem + kTileRows * kLdA * 2); // (64, kLdF)
  float* v_s = k_s + kTileRows * kLdF;                                // (64, kLdF)
  const int b = blockIdx.y, tile = blockIdx.x;
  const int wid = threadIdx.x >> 5;
  const int row0 = tile * kTileRows;
  const int n_rows = min(kTileRows, t_valid - row0);
  const float* vec = vecs;

  // the tile's rows (zeros past t_valid), staged in k_s, then LN into a_s
  for (int i = threadIdx.x; i < kTileRows * D / 4; i += kThreadsA) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i / (D / 4) < n_rows) v = load4(x + ((size_t)b * T + row0) * D + 4 * i);
    store4(k_s + (i / (D / 4)) * kLdF + (i % (D / 4)) * 4, v);
  }
  __syncthreads();
  warp_ln_bf16<kRowsA>(k_s + wid * kRowsA * kLdF, vec + kLnSelfG * D, vec + kLnSelfB * D,
                       a_s + wid * kRowsA * kLdA);
  __syncthreads();
  block_gemm(a_s, kLdA, mats + kWk * D * D, D, D, D, k_s, kLdF);
  block_gemm(a_s, kLdA, mats + kWv * D * D, D, D, D, v_s, kLdF);
  __syncthreads();

  const int stride = 2 * D + (kKvr ? 2 : 1) * D * dh;
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
      if (kKvr) acc_r = fmaf(k_s[r * kLdF + d], round_bf16(v_s[r * kLdF + l]), acc_r);
    }
    part[2 * D + i] = acc;
    if (kKvr) part[2 * D + D * dh + i] = acc_r;
  }
}

// ---------------------------------------------------------------- pass B
template <bool kKvr>
__global__ void kv_combine_kernel(const float* __restrict__ partials, bf16* __restrict__ kv,
                                  float* __restrict__ stats, float* __restrict__ kvr,
                                  int n_tiles, int dh) {
  const int b = blockIdx.y, d = blockIdx.x, l = threadIdx.x;
  bf16* out = kv + ((size_t)b * D + d) * D + l;
  if (d / dh != l / dh) {
    *out = __float2bfloat16(0.f);
    return;
  }
  const int stride = 2 * D + (kKvr ? 2 : 1) * D * dh;
  const float* p = partials + (size_t)b * n_tiles * stride;
  float m = -CUDART_INF_F;
  for (int t = 0; t < n_tiles; ++t) m = fmaxf(m, p[t * stride + d]);
  float s = 0.f, acc = 0.f, acc_r = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const float w = expf(p[t * stride + d] - m);
    s = fmaf(p[t * stride + D + d], w, s);
    acc = fmaf(p[t * stride + 2 * D + d * dh + l % dh], w, acc);
    if (kKvr) acc_r = fmaf(p[t * stride + 2 * D + D * dh + d * dh + l % dh], w, acc_r);
  }
  *out = __float2bfloat16(acc / s);
  if (kKvr) {
    kvr[((size_t)b * D + d) * dh + l % dh] = acc_r / s;
    if (l == d) {
      stats[(size_t)b * 2 * D + d] = m;
      stats[(size_t)b * 2 * D + D + d] = s;
    }
  }
}

// ---------------------------------------------------------------- pass C
template <typename XT>
__global__ void __launch_bounds__(kThreadsC)
layer_rows_kernel(const XT* x_in, XT* x_out, const bf16* __restrict__ emb,
                  const bf16* __restrict__ kv_self, const bf16* __restrict__ kv_cross,
                  const bf16* __restrict__ mats, const float* __restrict__ vecs,
                  const bf16* __restrict__ adaln_w, const float* __restrict__ adaln_b,
                  int T, int E, int dh) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lde = E + kPadE;
  float* xs = reinterpret_cast<float*>(smem);            // (64, kLdF) residual rows
  float* ys = xs + kTileRows * kLdF;                      // (64, kLdF) matmul output
  float* ms = ys + kTileRows * kLdF;                      // (64, kLdM) AdaLN slice
  bf16* as = reinterpret_cast<bf16*>(ms + kTileRows * kLdM);  // (64, kLdA) operand
  bf16* es = as + kTileRows * kLdA;                       // (64, lde) emb_act rows
  const int b = blockIdx.y;
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kTileRows;
  const int n_rows = min(kTileRows, T - row0);
  // this warp's 8-row slices
  const int wo = wid * kRowsC;
  float *xw = xs + wo * kLdF, *yw = ys + wo * kLdF, *mw = ms + wo * kLdM;
  bf16* aw = as + wo * kLdA;

  for (int i = threadIdx.x; i < kTileRows * D / 4; i += kThreadsC) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i / (D / 4) < n_rows) v = load4(x_in + ((size_t)b * T + row0) * D + 4 * i);
    store4(xs + (i / (D / 4)) * kLdF + (i % (D / 4)) * 4, v);
  }
  for (int i = threadIdx.x; i < kTileRows * E / 8; i += kThreadsC) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (i / (E / 8) < n_rows) v = reinterpret_cast<const uint4*>(emb + ((size_t)b * T + row0) * E)[i];
    *reinterpret_cast<uint4*>(es + (i / (E / 8)) * lde + (i % (E / 8)) * 8) = v;
  }
  __syncthreads();
  const float* vec = vecs;
  auto W = [&](int i) { return mats + (size_t)i * D * D; };

  // One StylizationBlock + residual on y (in ys): x += silu(AdaLN(y)) @ W + b.
  auto stylize = [&](int j, const float* ybias, int g, const bf16* w_out, int b_out) {
    block_gemm(es, lde, adaln_w + j * 2 * D, 6 * D, E, 2 * D, ms, kLdM);
    __syncthreads();
    warp_adaln_bf16<kRowsC>(yw, ybias, mw, adaln_b + j * 2 * D, vec + g * D, vec + (g + 1) * D, aw);
    __syncthreads();
    block_gemm(as, kLdA, w_out, D, D, D, ys, kLdF);
    __syncthreads();
    for (int r = 0; r < kRowsC; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane + 32 * i;
        xw[r * kLdF + c] += yw[r * kLdF + c] + vec[b_out * D + c];
      }
    __syncwarp();
  };
  // q_sm (into as) for the attention sublayers: LN -> q -> head softmax.
  auto query = [&](int g, const bf16* wq, int bq) {
    warp_ln_bf16<kRowsC>(xw, vec + g * D, vec + (g + 1) * D, aw);
    __syncthreads();
    block_gemm(as, kLdA, wq, D, D, D, ys, kLdF);
    __syncthreads();
    warp_head_softmax_bf16<kRowsC>(yw, vec + bq * D, dh, aw);
    __syncthreads();
  };

  // self attention
  query(kLnSelfG, W(kWq), kBq);
  block_gemm(as, kLdA, kv_self + (size_t)b * D * D, D, D, D, ys, kLdF);
  stylize(0, nullptr, kStylSelfG, W(kWStylSelf), kStylSelfOut);
  // cross attention
  query(kLnCrossG, W(kWqCross), kBqCross);
  block_gemm(as, kLdA, kv_cross + (size_t)b * D * D, D, D, D, ys, kLdF);
  stylize(1, nullptr, kStylCrossG, W(kWStylCross), kStylCrossOut);
  // FFN (W1 / W2 are zero-padded to D x D)
  for (int i = lane; i < kRowsC * D; i += 32)
    aw[(i / D) * kLdA + i % D] = __float2bfloat16(xw[(i / D) * kLdF + i % D]);
  __syncthreads();
  block_gemm(as, kLdA, W(kW1), D, D, D, ys, kLdF);
  __syncthreads();
  for (int i = lane; i < kRowsC * D; i += 32) {
    const float u = yw[(i / D) * kLdF + i % D] + vec[kB1 * D + i % D];
    aw[(i / D) * kLdA + i % D] = __float2bfloat16(gelu_tanh(u));
  }
  __syncthreads();
  block_gemm(as, kLdA, W(kW2), D, D, D, ys, kLdF);
  stylize(2, vec + kB2 * D, kStylFfnG, W(kWStylFfn), kStylFfnOut);
  __syncthreads();

  for (int i = threadIdx.x; i < n_rows * D / 4; i += kThreadsC)
    store4(x_out + ((size_t)b * T + row0) * D + 4 * i,
           load4(xs + (i / (D / 4)) * kLdF + (i % (D / 4)) * 4));
}

constexpr size_t kSmemA = (size_t)kTileRows * (kLdA * 2 + 2 * kLdF * 4);
size_t smem_rows(int E) {
  return (size_t)kTileRows * (2 * kLdF * 4 + kLdM * 4 + kLdA * 2 + (E + kPadE) * 2);
}

template <typename XT, bool kKvr>
cudaError_t kv_pass(const XT* x, const bf16* mats, const float* vecs, float* partials, bf16* kv,
                    float* stats, float* kvr, int B, int T, int t_valid, int dh,
                    cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      kv_partials_kernel<XT, kKvr>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemA);
  if (attr != cudaSuccess) return attr;
  const int n_tiles = ceil_div(t_valid, kTileRows);
  kv_partials_kernel<XT, kKvr><<<dim3(n_tiles, B), kThreadsA, kSmemA, s>>>(
      x, mats, vecs, partials, T, t_valid, dh, n_tiles);
  kv_combine_kernel<kKvr><<<dim3(D, B), D, 0, s>>>(partials, kv, stats, kvr, n_tiles, dh);
  return cudaGetLastError();
}

bool bad_shape(int d, int E, int H) {
  const int dh = d / H;
  return d != D || E % 16 != 0 || dh * H != d || 32 % dh != 0;
}

}  // namespace

cudaError_t launch_kv_pass(const void* x, bool x_bf16, const bf16* mats, const float* vecs,
                           float* partials, bf16* kv, float* stats, float* kvr, int B, int T,
                           int t_valid, int dh, cudaStream_t stream) {
  if (kvr != nullptr)
    return x_bf16 ? kv_pass<bf16, true>(static_cast<const bf16*>(x), mats, vecs, partials, kv,
                                        stats, kvr, B, T, t_valid, dh, stream)
                  : kv_pass<float, true>(static_cast<const float*>(x), mats, vecs, partials, kv,
                                         stats, kvr, B, T, t_valid, dh, stream);
  return x_bf16 ? kv_pass<bf16, false>(static_cast<const bf16*>(x), mats, vecs, partials, kv,
                                       stats, kvr, B, T, t_valid, dh, stream)
                : kv_pass<float, false>(static_cast<const float*>(x), mats, vecs, partials, kv,
                                        stats, kvr, B, T, t_valid, dh, stream);
}

size_t kv_pass_partials_bytes(int B, int t_valid, int dh, bool with_kvr) {
  return (size_t)B * ceil_div(t_valid, kTileRows) * (2 * D + (with_kvr ? 2 : 1) * D * dh) * 4;
}

CT_EXPORT int decoder_stack_forward(const void* x, const void* emb, const void* kv_cross,
                                    const void* mats, const void* vecs, const void* adaln_w,
                                    const void* adaln_b, void* out, void* partials,
                                    void* kv_self, int B, int T, int d, int E, int H, int L,
                                    void* stream) {
  if (bad_shape(d, E, H)) return (int)cudaErrorInvalidValue;
  const int dh = d / H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem_c = smem_rows(E);
  cudaError_t err = cudaFuncSetAttribute(layer_rows_kernel<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
  if (err != cudaSuccess) return (int)err;
  const dim3 tiles(ceil_div(T, kTileRows), B);
  for (int l = 0; l < L; ++l) {
    const float* x_l = l == 0 ? static_cast<const float*>(x) : static_cast<const float*>(out);
    const bf16* mats_l = static_cast<const bf16*>(mats) + (size_t)l * 9 * D * D;
    const float* vecs_l = static_cast<const float*>(vecs) + (size_t)l * 24 * D;
    err = kv_pass<float, false>(x_l, mats_l, vecs_l, static_cast<float*>(partials),
                                static_cast<bf16*>(kv_self), nullptr, nullptr, B, T, T, dh, s);
    if (err != cudaSuccess) return (int)err;
    layer_rows_kernel<float><<<tiles, kThreadsC, smem_c, s>>>(
        x_l, static_cast<float*>(out), static_cast<const bf16*>(emb),
        static_cast<const bf16*>(kv_self),
        static_cast<const bf16*>(kv_cross) + (size_t)l * B * D * D, mats_l, vecs_l,
        static_cast<const bf16*>(adaln_w) + (size_t)l * E * 6 * D,
        static_cast<const float*>(adaln_b) + (size_t)l * 6 * D, T, E, dh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

CT_EXPORT int decoder_layer_forward(const void* x, const void* emb, const void* kv_cross,
                                    const void* mats, const void* vecs, const void* adaln_w,
                                    const void* adaln_b, void* out, void* partials,
                                    void* kv_self, int B, int T, int t_valid, int d, int E, int H,
                                    void* stream) {
  if (bad_shape(d, E, H) || t_valid < 1 || t_valid > T) return (int)cudaErrorInvalidValue;
  const int dh = d / H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem_c = smem_rows(E);
  cudaError_t err = cudaFuncSetAttribute(layer_rows_kernel<bf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
  if (err != cudaSuccess) return (int)err;
  const bf16* xb = static_cast<const bf16*>(x);
  err = kv_pass<bf16, false>(xb, static_cast<const bf16*>(mats), static_cast<const float*>(vecs),
                             static_cast<float*>(partials), static_cast<bf16*>(kv_self), nullptr,
                             nullptr, B, T, t_valid, dh, s);
  if (err != cudaSuccess) return (int)err;
  layer_rows_kernel<bf16><<<dim3(ceil_div(T, kTileRows), B), kThreadsC, smem_c, s>>>(
      xb, static_cast<bf16*>(out), static_cast<const bf16*>(emb),
      static_cast<const bf16*>(kv_self), static_cast<const bf16*>(kv_cross),
      static_cast<const bf16*>(mats), static_cast<const float*>(vecs),
      static_cast<const bf16*>(adaln_w), static_cast<const float*>(adaln_b), T, E, dh);
  return (int)cudaGetLastError();
}

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
//      output live in shared memory (213 KB at E = 512; 180 KB with int8
//      emb rows).
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
// K1's two opt-in serving modes are template flags of pass C (passes A and
// B do not change):
//   int8 AdaLN (`_stack_kernel` :182-201, `_layer_body` :113-118): emb_act
//      arrives as int8 rows with float32 row scales (K2 quantizes it once a
//      step) and adaln_w as int8 with float32 column scales.  The tile's
//      emb rows sit in shared memory as int8, E bytes a row, k-chunk-major
//      (each 16-code k-step of all 64 rows together, so that every WMMA
//      fragment pointer is 32-byte aligned), half of the bf16 rows, with
//      their 64 row scales.  The AdaLN product runs on the integer tensor
//      cores (`block_gemm_s8`: m8n32k16 signed-char WMMA fragments -> int32,
//      the same 32-column jobs and weight prefetch as `block_gemm`), and the
//      AdaLN step dequantizes in float32, acc * (srow * scol) + ab, in JAX's
//      order.
//      The int8 AdaLN product is 22.6 GOP a step at B = 2, T = 1800: 0.011
//      ms at the card's 1,979 int8 TOP/s, against 0.023 ms in bf16.
//   bf16 VPU (`_layer_body` :98, 102-105, 154): the q feature-softmax exp,
//      the StylizationBlock SiLU and the FFN GELU round their argument and
//      every op's result to bf16, where JAX casts to bf16 (jax.nn.gelu's
//      constants too); LN statistics, the time softmax, KV and the residual
//      stay float32.
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
// kInt8: emb holds int8 rows with float32 row scales (emb_scale, B * T),
// adaln_w is int8 with float32 column scales (aw_scale, 6D), and the AdaLN
// product runs on the integer tensor cores (int32 accumulation), dequantized
// in the AdaLN step.  kVpuBf16: the three elementwise chains of JAX's
// bf16-VPU mode (head softmax exp, StylizationBlock SiLU, FFN GELU) round
// where JAX's `_layer_body` casts to bf16.  K5 runs <bf16, false, false>.
template <typename XT, bool kInt8, bool kVpuBf16>
__global__ void __launch_bounds__(kThreadsC)
layer_rows_kernel(const XT* x_in, XT* x_out, const void* __restrict__ emb_v,
                  const float* __restrict__ emb_scale,
                  const bf16* __restrict__ kv_self, const bf16* __restrict__ kv_cross,
                  const bf16* __restrict__ mats, const float* __restrict__ vecs,
                  const void* __restrict__ adaln_w_v, const float* __restrict__ aw_scale,
                  const float* __restrict__ adaln_b, int T, int E, int dh) {
  typedef typename std::conditional<kInt8, signed char, bf16>::type ET;
  typedef typename std::conditional<kInt8, int, float>::type MT;  // the AdaLN product's type
  constexpr int kVec = 16 / sizeof(ET);  // elements of one 16-byte load
  const ET* emb = static_cast<const ET*>(emb_v);
  const ET* adaln_w = static_cast<const ET*>(adaln_w_v);
  extern __shared__ __align__(128) unsigned char smem[];
  const int lde = kInt8 ? E : E + kPadE;
  float* xs = reinterpret_cast<float*>(smem);            // (64, kLdF) residual rows
  float* ys = xs + kTileRows * kLdF;                      // (64, kLdF) matmul output
  float* ms = ys + kTileRows * kLdF;                      // (64, kLdM) AdaLN slice
  bf16* as = reinterpret_cast<bf16*>(ms + kTileRows * kLdM);  // (64, kLdA) operand
  // emb rows: bf16 (64, lde); int8 k-chunk-major (E / 16, 64, 16), as
  // block_gemm_s8 reads them
  ET* es = reinterpret_cast<ET*>(as + kTileRows * kLdA);
  float* srow = reinterpret_cast<float*>(es + kTileRows * lde);  // (64,) int8 row scales
  const int b = blockIdx.y;
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kTileRows;
  const int n_rows = min(kTileRows, T - row0);
  // this warp's 8-row slices
  const int wo = wid * kRowsC;
  float *xw = xs + wo * kLdF, *yw = ys + wo * kLdF;
  MT* mw = reinterpret_cast<MT*>(ms) + wo * kLdM;
  bf16* aw = as + wo * kLdA;

  for (int i = threadIdx.x; i < kTileRows * D / 4; i += kThreadsC) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i / (D / 4) < n_rows) v = load4(x_in + ((size_t)b * T + row0) * D + 4 * i);
    store4(xs + (i / (D / 4)) * kLdF + (i % (D / 4)) * 4, v);
  }
  for (int i = threadIdx.x; i < kTileRows * E / kVec; i += kThreadsC) {
    const int r = i / (E / kVec), c = i % (E / kVec);  // row, 16-byte chunk
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows) v = reinterpret_cast<const uint4*>(emb + ((size_t)b * T + row0) * E)[i];
    ET* dst = kInt8 ? es + (c * kTileRows + r) * kVec : es + r * lde + c * kVec;
    *reinterpret_cast<uint4*>(dst) = v;
  }
  if (kInt8 && threadIdx.x < kTileRows)
    srow[threadIdx.x] = threadIdx.x < n_rows ? emb_scale[(size_t)b * T + row0 + threadIdx.x] : 0.f;
  __syncthreads();
  const float* vec = vecs;
  auto W = [&](int i) { return mats + (size_t)i * D * D; };

  // One StylizationBlock + residual on y (in ys): x += silu(AdaLN(y)) @ W + b.
  auto stylize = [&](int j, const float* ybias, int g, const bf16* w_out, int b_out) {
    if constexpr (kInt8)
      block_gemm_s8(es, adaln_w + j * 2 * D, 6 * D, E, 2 * D, reinterpret_cast<int*>(ms), kLdM);
    else
      block_gemm(es, lde, adaln_w + j * 2 * D, 6 * D, E, 2 * D, ms, kLdM);
    __syncthreads();
    warp_adaln_bf16<kRowsC, kVpuBf16>(yw, ybias, mw, adaln_b + j * 2 * D, vec + g * D,
                                      vec + (g + 1) * D, aw, srow + wo,
                                      kInt8 ? aw_scale + j * 2 * D : nullptr);
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
    warp_head_softmax_bf16<kRowsC, kVpuBf16>(yw, vec + bq * D, dh, aw);
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
    aw[(i / D) * kLdA + i % D] =
        __float2bfloat16(kVpuBf16 ? gelu_tanh_vpu_bf16(round_bf16(u)) : gelu_tanh(u));
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
// pass C's shared memory: the float32 and bf16 tiles, the emb rows and, in
// the int8 mode, their row scales
size_t smem_rows(int E, bool int8) {
  const size_t emb_row = int8 ? (size_t)E : (size_t)(E + kPadE) * 2;
  return (size_t)kTileRows * (2 * kLdF * 4 + kLdM * 4 + kLdA * 2 + emb_row + (int8 ? 4 : 0));
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

namespace {

template <bool kInt8, bool kVpuBf16>
cudaError_t stack_forward(const float* x, const void* emb, const float* emb_scale,
                          const bf16* kv_cross, const bf16* mats, const float* vecs,
                          const void* adaln_w, const float* aw_scale, const float* adaln_b,
                          float* out, float* partials, bf16* kv_self, int B, int T, int E, int dh,
                          int L, cudaStream_t s) {
  const size_t smem_c = smem_rows(E, kInt8);
  cudaError_t err = cudaFuncSetAttribute(layer_rows_kernel<float, kInt8, kVpuBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
  if (err != cudaSuccess) return err;
  const size_t aw_bytes = kInt8 ? 1 : 2;
  const dim3 tiles(ceil_div(T, kTileRows), B);
  for (int l = 0; l < L; ++l) {
    const float* x_l = l == 0 ? x : out;
    const bf16* mats_l = mats + (size_t)l * 9 * D * D;
    const float* vecs_l = vecs + (size_t)l * 24 * D;
    err = kv_pass<float, false>(x_l, mats_l, vecs_l, partials, kv_self, nullptr, nullptr, B, T, T,
                                dh, s);
    if (err != cudaSuccess) return err;
    layer_rows_kernel<float, kInt8, kVpuBf16><<<tiles, kThreadsC, smem_c, s>>>(
        x_l, out, emb, emb_scale, kv_self, kv_cross + (size_t)l * B * D * D, mats_l, vecs_l,
        static_cast<const unsigned char*>(adaln_w) + (size_t)l * E * 6 * D * aw_bytes,
        kInt8 ? aw_scale + (size_t)l * 6 * D : nullptr, adaln_b + (size_t)l * 6 * D, T, E, dh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace

// emb_scale / aw_scale are null unless int8: the int8-AdaLN mode (emb and
// adaln_w int8); vpu_bf16: the bf16-VPU mode.
CT_EXPORT int decoder_stack_forward(const void* x, const void* emb, const void* emb_scale,
                                    const void* kv_cross, const void* mats, const void* vecs,
                                    const void* adaln_w, const void* aw_scale,
                                    const void* adaln_b, void* out, void* partials,
                                    void* kv_self, int B, int T, int d, int E, int H, int L,
                                    int int8, int vpu_bf16, void* stream) {
  if (bad_shape(d, E, H) || (int8 && (emb_scale == nullptr || aw_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int dh = d / H;
  auto run = [&](auto launch) {
    return (int)launch(static_cast<const float*>(x), emb, static_cast<const float*>(emb_scale),
                       static_cast<const bf16*>(kv_cross), static_cast<const bf16*>(mats),
                       static_cast<const float*>(vecs), adaln_w,
                       static_cast<const float*>(aw_scale), static_cast<const float*>(adaln_b),
                       static_cast<float*>(out), static_cast<float*>(partials),
                       static_cast<bf16*>(kv_self), B, T, E, dh, L,
                       static_cast<cudaStream_t>(stream));
  };
  if (int8) return vpu_bf16 ? run(stack_forward<true, true>) : run(stack_forward<true, false>);
  return vpu_bf16 ? run(stack_forward<false, true>) : run(stack_forward<false, false>);
}

CT_EXPORT int decoder_layer_forward(const void* x, const void* emb, const void* kv_cross,
                                    const void* mats, const void* vecs, const void* adaln_w,
                                    const void* adaln_b, void* out, void* partials,
                                    void* kv_self, int B, int T, int t_valid, int d, int E, int H,
                                    void* stream) {
  if (bad_shape(d, E, H) || t_valid < 1 || t_valid > T) return (int)cudaErrorInvalidValue;
  const int dh = d / H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem_c = smem_rows(E, false);
  cudaError_t err = cudaFuncSetAttribute(layer_rows_kernel<bf16, false, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
  if (err != cudaSuccess) return (int)err;
  const bf16* xb = static_cast<const bf16*>(x);
  err = kv_pass<bf16, false>(xb, static_cast<const bf16*>(mats), static_cast<const float*>(vecs),
                             static_cast<float*>(partials), static_cast<bf16*>(kv_self), nullptr,
                             nullptr, B, T, t_valid, dh, s);
  if (err != cudaSuccess) return (int)err;
  layer_rows_kernel<bf16, false, false><<<dim3(ceil_div(T, kTileRows), B), kThreadsC, smem_c, s>>>(
      xb, static_cast<bf16*>(out), emb, nullptr, static_cast<const bf16*>(kv_self),
      static_cast<const bf16*>(kv_cross), static_cast<const bf16*>(mats),
      static_cast<const float*>(vecs), adaln_w, nullptr, static_cast<const float*>(adaln_b), T,
      E, dh);
  return (int)cudaGetLastError();
}

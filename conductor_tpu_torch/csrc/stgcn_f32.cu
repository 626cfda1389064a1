// K7's float32 mode: the frozen ST-GCN of the perceptual loss, forward and
// d(input) backward, on float32 operands with float32 products.
//
// Replaces conductor_tpu/ops/pallas_stgcn.py::fused_frozen_stgcn with
// mxu_dtype float32 (forward pallas_call at :252, backward at :280), whose
// `_md` keeps both operands of every product in float32.  The weights are
// ops/stgcn.py::pack_frozen_stgcn's pack at float32 (matrices and biases);
// the activations are rows of one frame, 13 joints x 32 channels = 416
// values, joint-major, as in stgcn.cu, whose header sets out the algebra:
//   g = relu(h M_i + b1_i);  h' = relu(sum_k g[t + k - 1] W_ik + b2_i (+ h))
//   out = h_10 FC + fcb
//   dy = dh' [h' > 0];  da = (sum_k dy[t + 1 - k] W_ik^T) [g > 0];
//   dh = da M_i^T (+ dy after block 0);  dx = da_0 M_0^T
// with the clip's edges zero-padded and the ReLU masks kept as bits (bit c
// of word v: channel c of joint v) between the two directions.
//
// Design: two launches a st_gcn block and direction, and one for the
// projection; every product is an FFMA chain (no TF32, no library call).
//   `stgcn_f32_gemm` is the dense product, register-tiled as the float32 AdaLN
//   GEMM (adaln_gemm.cu `f32::`): 128 x 128 tiles of 256 threads, a thread
//   8 x 8, k-slices of 8 double-buffered through registers; A (M, K) row
//   major, B as (K, N) or, for the backward's M_i^T and FC^T, as its
//   transpose (N, K), both staged k-major in shared memory; rows, columns
//   and k past the ends load zeros and store nothing, so the 26-wide
//   motion and dx and the 64-wide projection share it.  Its epilogue, in
//   16-byte accesses where the row stride allows, adds
//   the bias and the ReLU (the graph conv), the bias (the projection) or
//   the residual dy = dh [h' > 0] in place (the backward's dh).
//   `stgcn_f32_tconv` is the 3-tap temporal conv of one block and direction:
//   a thread block owns 24 frames of a clip and stages its input rows t0 -
//   1 .. t0 + 24 (zero outside the clip; the backward gates dh by [h' > 0]
//   as it stages) in shared memory; warp v is joint v, lane c its channel
//   c, holding the 96 taps it needs in registers (the backward's staged
//   through shared memory first, to read them coalesced), and reads each input
//   value as a shared-memory broadcast; two frames at a time, two
//   independent chains.  The forward adds b2 and the residual, writes h'
//   in place and, with `save`, the masks [g > 0] and [h' > 0] as one
//   ballot a joint; the backward gates da by [g > 0].
// Every sum runs in a fixed order, with no atomics: a repeat gives the
// same bits.

#include "common.cuh"

#include <cstdint>

namespace {

constexpr int V = 13, C = 32, W = V * C;  // joints, channels, values a frame
constexpr int kBlocks = 10, kOut = 64, kIn = V * 2;

// ---- the dense product ------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 8, kGemmThreads = 256;
// k-major tile rows, padded: the transposing stores hit distinct banks
constexpr int kLd = kBM + 4;

enum Epilogue { kPlain = 0, kBias = 1, kBiasRelu = 2, kMaskedResidual = 3 };

struct GemmArgs {
  const float* A;        // (M, K), row stride K
  const float* B;        // (K, N), or kTransB: (N, K); row stride ldb
  const float* bias;     // (N,): kBias, kBiasRelu
  const uint32_t* mask;  // (M, 13) words of [h' > 0]: kMaskedResidual
  float* out;            // (M, N), row stride ldo; kMaskedResidual: also the residual dh
  int M, K, N, ldb, ldo;
};

// A kBM x kBN tile of out: thread (ty, tx) = (t / 16, t % 16) owns rows
// 4 ty + i and 64 + 4 ty + i, columns 4 tx + j and 64 + 4 tx + j (i, j < 4).
template <bool kTransB, int kEpi>
__global__ void __launch_bounds__(kGemmThreads) stgcn_f32_gemm(GemmArgs p) {
  __shared__ __align__(16) float As[2][kBK][kLd];
  __shared__ __align__(16) float Bs[2][kBK][kLd];
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int col0 = blockIdx.x * kBN, row0 = blockIdx.y * kBM;
  // the loads: A row t / 2, k 4 (t % 2) .. + 3; B (K, N): k row t / 32,
  // columns 4 (t % 32) .. + 3; B (N, K): column t / 2, k 4 (t % 2) .. + 3
  const int ar = t >> 1, ak = (t & 1) * 4;
  const int bk = kTransB ? (t & 1) * 4 : t >> 5, bn = kTransB ? t >> 1 : (t & 31) * 4;
  float ra[4], rb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + ak + j;
      ra[j] = row0 + ar < p.M && k < p.K ? __ldg(p.A + (size_t)(row0 + ar) * p.K + k) : 0.f;
      if (kTransB) {
        const int kb = k0 + bk + j;
        rb[j] = col0 + bn < p.N && kb < p.K ? __ldg(p.B + (size_t)(col0 + bn) * p.ldb + kb) : 0.f;
      } else {
        const int n = col0 + bn + j;
        rb[j] = k0 + bk < p.K && n < p.N ? __ldg(p.B + (size_t)(k0 + bk) * p.ldb + n) : 0.f;
      }
    }
  };
  auto put_tile = [&](int s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      As[s][ak + j][ar] = ra[j];
      if (kTransB) Bs[s][bk + j][bn] = rb[j];
    }
    if (!kTransB)
      *reinterpret_cast<float4*>(&Bs[s][bk][bn]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  fetch(0);
  put_tile(0);
  __syncthreads();
  const int nk = (p.K + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * kBK);  // in flight while this slice multiplies
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
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
  // the epilogue: each thread's 4 consecutive columns as one 16-byte
  // access where the row stride allows (the 416- and 64-wide outputs),
  // else one value at a time (dx, 26 wide)
  const bool vec = (p.ldo & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= p.M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = col0 + 64 * h + 4 * tx;
      if (c0 >= p.N) continue;
      float* o = p.out + (size_t)r * p.ldo + c0;
      // the 4 columns share one mask word (c0 % 4 == 0)
      const uint32_t bits =
          kEpi == kMaskedResidual ? p.mask[(size_t)r * V + c0 / C] >> (c0 % C) : 0u;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = acc[i][4 * h + j];
      if (vec && c0 + 3 < p.N) {
        if (kEpi == kBias || kEpi == kBiasRelu) {
          const float4 b = __ldg(reinterpret_cast<const float4*>(p.bias + c0));
          v[0] += b.x, v[1] += b.y, v[2] += b.z, v[3] += b.w;
        }
        if (kEpi == kMaskedResidual) {
          const float4 d = *reinterpret_cast<const float4*>(o);
          v[0] += bits & 1u ? d.x : 0.f;
          v[1] += bits & 2u ? d.y : 0.f;
          v[2] += bits & 4u ? d.z : 0.f;
          v[3] += bits & 8u ? d.w : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = kEpi == kBiasRelu ? fmaxf(v[j], 0.f) : v[j];
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c0 + j >= p.N) continue;
          if (kEpi == kBias || kEpi == kBiasRelu) v[j] += __ldg(p.bias + c0 + j);
          if (kEpi == kBiasRelu) v[j] = fmaxf(v[j], 0.f);
          if (kEpi == kMaskedResidual && (bits >> j & 1u)) v[j] += o[j];
          o[j] = v[j];
        }
      }
    }
  }
}

template <bool kTransB, int kEpi>
cudaError_t gemm(const GemmArgs& p, cudaStream_t s) {
  const dim3 grid(ceil_div(p.N, kBN), ceil_div(p.M, kBM));
  stgcn_f32_gemm<kTransB, kEpi><<<grid, kGemmThreads, 0, s>>>(p);
  return cudaGetLastError();
}

// ---- the temporal conv ------------------------------------------------------

constexpr int kTR = 24;  // frames a block owns; its tile holds kTR + 2 rows
constexpr int kTconvThreads = 32 * V;

struct TconvArgs {
  const float* src;        // forward: g; backward: dh (B*T, 416)
  const uint32_t* hmask;   // backward: [h' > 0] of src's rows (gates dh into dy)
  const uint32_t* gmask;   // backward: [g > 0] (gates da)
  const float* wt;         // (3, 32, 32) taps (tap, in, out) of the block
  const float* b2;         // forward: (32,)
  const float* res;        // forward: the block's input h, or null (block 0)
  float* out;              // forward: h' (may be res); backward: da
  uint32_t* gmask_out;     // forward with save: [g > 0], else null
  uint32_t* hmask_out;     // forward with save: [h' > 0]
  int T;
};

// Forward: out[t, v, c] = relu(b2[c] (+ res) + sum_k sum_i g[t + k - 1, v, i]
// wt[k, i, c]).  Backward: out[t, v, c] = [g > 0] sum_k sum_o dy[t + 1 - k,
// v, o] wt[k, c, o], i.e. the forward's sum with tap k' = 2 - k read from
// tile row t + k' - 1.
template <bool kBwd>
__global__ void __launch_bounds__(kTconvThreads) stgcn_f32_tconv(TconvArgs p) {
  __shared__ __align__(16) float tile[kTR + 2][W];
  const int t0 = blockIdx.x * kTR, clip = blockIdx.y, tid = threadIdx.x;
  const size_t base = (size_t)clip * p.T;
  const int v = tid >> 5, c = tid & 31;
  float w[3][C];  // w[k][i]: the tap multiplying tile row t + k (frame t + k - 1), input i
  if (kBwd) {
    // lane c needs row c of each tap (wt[k, c, :]): stage the taps through
    // the tile's space with rows padded to 33 values, so that the 32 lanes'
    // reads of one column hit 32 banks
    float* taps = &tile[0][0];
    for (int i = tid; i < 3 * C * C; i += kTconvThreads) taps[i + i / C] = __ldg(p.wt + i);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int i = 0; i < C; ++i) w[k][i] = taps[((2 - k) * C + c) * (C + 1) + i];
    __syncthreads();
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int i = 0; i < C; ++i) w[k][i] = __ldg(p.wt + (k * C + i) * C + c);
  }
  for (int i = tid; i < (kTR + 2) * (W / 4); i += kTconvThreads) {
    const int row = i / (W / 4), q = i - row * (W / 4), t = t0 - 1 + row;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < p.T) {
      v = __ldg(reinterpret_cast<const float4*>(p.src + (base + t) * W) + q);
      if (kBwd) {
        const uint32_t bits = __ldg(p.hmask + (base + t) * V + q / 8) >> (4 * q % C);
        v.x = bits & 1u ? v.x : 0.f;
        v.y = bits & 2u ? v.y : 0.f;
        v.z = bits & 4u ? v.z : 0.f;
        v.w = bits & 8u ? v.w : 0.f;
      }
    }
    reinterpret_cast<float4*>(&tile[row][0])[q] = v;
  }
  const float b2 = kBwd ? 0.f : __ldg(p.b2 + c);
  __syncthreads();
  const int rows = min(kTR, p.T - t0);
  for (int tt = 0; tt < rows; tt += 2) {
    const bool two = tt + 1 < rows;
    const size_t r0 = base + t0 + tt, r1 = r0 + 1;
    float acc0 = b2, acc1 = b2;
    if (!kBwd && p.res) {
      acc0 += p.res[r0 * W + v * C + c];
      if (two) acc1 += p.res[r1 * W + v * C + c];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float4* x0 = reinterpret_cast<const float4*>(&tile[tt + k][v * C]);
      const float4* x1 = reinterpret_cast<const float4*>(&tile[tt + 1 + k][v * C]);
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        const float4 a = x0[q], b = x1[q];
        acc0 = fmaf(a.x, w[k][4 * q], acc0);
        acc1 = fmaf(b.x, w[k][4 * q], acc1);
        acc0 = fmaf(a.y, w[k][4 * q + 1], acc0);
        acc1 = fmaf(b.y, w[k][4 * q + 1], acc1);
        acc0 = fmaf(a.z, w[k][4 * q + 2], acc0);
        acc1 = fmaf(b.z, w[k][4 * q + 2], acc1);
        acc0 = fmaf(a.w, w[k][4 * q + 3], acc0);
        acc1 = fmaf(b.w, w[k][4 * q + 3], acc1);
      }
    }
    if (kBwd) {
      const uint32_t g0 = __ldg(p.gmask + r0 * V + v);
      p.out[r0 * W + v * C + c] = g0 >> c & 1u ? acc0 : 0.f;
      if (two) {
        const uint32_t g1 = __ldg(p.gmask + r1 * V + v);
        p.out[r1 * W + v * C + c] = g1 >> c & 1u ? acc1 : 0.f;
      }
    } else {
      const float h0 = fmaxf(acc0, 0.f), h1 = fmaxf(acc1, 0.f);
      p.out[r0 * W + v * C + c] = h0;
      if (two) p.out[r1 * W + v * C + c] = h1;
      if (p.gmask_out) {  // uniform across the block
        const uint32_t gw0 = __ballot_sync(0xffffffffu, tile[tt + 1][v * C + c] > 0.f);
        const uint32_t hw0 = __ballot_sync(0xffffffffu, h0 > 0.f);
        const uint32_t gw1 = __ballot_sync(0xffffffffu, tile[tt + 2][v * C + c] > 0.f);
        const uint32_t hw1 = __ballot_sync(0xffffffffu, h1 > 0.f);
        if (c == 0) {
          p.gmask_out[r0 * V + v] = gw0;
          p.hmask_out[r0 * V + v] = hw0;
          if (two) {
            p.gmask_out[r1 * V + v] = gw1;
            p.hmask_out[r1 * V + v] = hw1;
          }
        }
      }
    }
  }
}

template <bool kBwd>
cudaError_t tconv(const TconvArgs& p, int B, cudaStream_t s) {
  stgcn_f32_tconv<kBwd><<<dim3(ceil_div(p.T, kTR), B), kTconvThreads, 0, s>>>(p);
  return cudaGetLastError();
}

#define CT_TRY(expr)                          \
  do {                                        \
    const cudaError_t err_ = (expr);          \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

}  // namespace

// x (B*T, 26) float32 -> out (B*T, 64) float32; 21 launches.  h, g: float32
// (B*T, 416) slabs (each block's output h, written in place, and its graph
// conv's g).  gmask / hmask: (10, B*T, 13) words of each block's [g > 0] /
// [h > 0] bits, or both null (no `save`).
CT_EXPORT int stgcn_forward_f32(const void* x, const void* m0, const void* m, const void* wt,
                                const void* b1, const void* b2, const void* fc, const void* fcb,
                                void* h, void* g, void* gmask, void* hmask, void* out, int B,
                                int T, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int rows = B * T;
  if (rows == 0) return 0;
  float* hf = static_cast<float*>(h);
  float* gf = static_cast<float*>(g);
  auto mask = [&](void* p, int i) {
    return p ? static_cast<uint32_t*>(p) + (size_t)i * rows * V : nullptr;
  };
  for (int i = 0; i < kBlocks; ++i) {
    const GemmArgs gc{i == 0 ? static_cast<const float*>(x) : hf,
                      i == 0 ? static_cast<const float*>(m0)
                             : static_cast<const float*>(m) + (size_t)(i - 1) * W * W,
                      static_cast<const float*>(b1) + i * W, nullptr, gf, rows, i == 0 ? kIn : W,
                      W, W, W};
    CT_TRY((gemm<false, kBiasRelu>(gc, s)));
    const TconvArgs tc{gf, nullptr, nullptr, static_cast<const float*>(wt) + i * 3 * C * C,
                       static_cast<const float*>(b2) + i * C, i == 0 ? nullptr : hf, hf,
                       mask(gmask, i), mask(hmask, i), T};
    CT_TRY(tconv<false>(tc, B, s));
  }
  const GemmArgs proj{hf, static_cast<const float*>(fc), static_cast<const float*>(fcb), nullptr,
                      static_cast<float*>(out), rows, W, kOut, kOut, kOut};
  CT_TRY((gemm<false, kBias>(proj, s)));
  return 0;
}

// dy (B*T, 64) float32 and the forward's masks -> dx (B*T, 26) float32; 21
// launches.  dh, da: float32 (B*T, 416) slabs (the running cotangent,
// updated in place, and each block's da).
CT_EXPORT int stgcn_backward_f32(const void* dy, const void* m0, const void* m, const void* wt,
                                 const void* fc, const void* gmask, const void* hmask, void* dh,
                                 void* da, void* dx, int B, int T, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int rows = B * T;
  if (rows == 0) return 0;
  float* dhf = static_cast<float*>(dh);
  float* daf = static_cast<float*>(da);
  const GemmArgs start{static_cast<const float*>(dy), static_cast<const float*>(fc), nullptr,
                       nullptr, dhf, rows, kOut, W, kOut, W};
  CT_TRY((gemm<true, kPlain>(start, s)));
  for (int i = kBlocks - 1; i >= 0; --i) {
    const uint32_t* hm = static_cast<const uint32_t*>(hmask) + (size_t)i * rows * V;
    const TconvArgs tc{dhf, hm, static_cast<const uint32_t*>(gmask) + (size_t)i * rows * V,
                       static_cast<const float*>(wt) + i * 3 * C * C, nullptr, nullptr, daf,
                       nullptr, nullptr, T};
    CT_TRY(tconv<true>(tc, B, s));
    if (i > 0) {
      const GemmArgs back{daf, static_cast<const float*>(m) + (size_t)(i - 1) * W * W, nullptr,
                          hm, dhf, rows, W, W, W, W};
      CT_TRY((gemm<true, kMaskedResidual>(back, s)));
    } else {
      const GemmArgs back{daf, static_cast<const float*>(m0), nullptr, nullptr,
                          static_cast<float*>(dx), rows, W, kIn, W, kIn};
      CT_TRY((gemm<true, kPlain>(back, s)));
    }
  }
  return 0;
}

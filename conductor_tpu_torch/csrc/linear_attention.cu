// K8: the standalone linear self-attention, forward.
//
// Replaces conductor_tpu/ops/pallas_attention.py::fused_linear_attention
// (`_attention_kernel` :45-76, pallas_call at :99).  Per clip and head h,
// over the head's Dh = 16 columns of D = 16 * H: q_sm = softmax of q over
// the head's 16 features, k_sm = softmax of k over time, KV = k_sm^T v
// (16 x 16), y = q_sm KV; float32 inside, y in q's dtype.  The JAX
// wrapper's key mask arrives folded into k (-1e6 on masked rows) and v
// (zeroed), so a masked row gets the weight exp(-1e6 - max) = 0, as there.
//
// k and v are read in the dtype the wrapper hands over (ops/attention.py):
// bf16, or float32 where a float32 key mask promoted them.  The wrapper
// does not cast them back to bf16.
//
// The TPU kernel multiplies the dense (D, D) k^T v and masks it to the head
// blocks, 8x the work, shaped for the MXU's 128 lanes, and pads T to a
// multiple of 8 with -1e6 rows.  Here each head's 16 x 16 block is computed
// alone and rows past T are never read.
//
// What bounds it on an H100: bytes.  A row of one head costs 2 * 2 * 16 *
// 16 = 1024 FLOPs of float32 FMAs (its KV partial and its y) against 4 * 16
// values read or written, 8-12 FLOPs a byte, below the float32 CUDA cores'
// ~20 (67 TFLOP/s over 3.35 TB/s).  So the design reads each input once,
// keeps the per-head reductions in shared memory and registers, and
// spreads one clip over many blocks: two launches over a grid of (T-chunk
// of 128 rows, head, clip), so one clip at T = 1800 is 15 * 8 blocks and
// not the 8 of a (clip, head) grid, for 132 SMs.
//   1 attention_partials_kernel: the chunk's k and v columns of the head
//     in shared memory; per column its max m over the chunk and the sum s
//     of exp(k - m), and the partial exp(k - m)^T v (16 x 16), float32,
//     into a workspace.
//   2 attention_rows_kernel: the clip's chunk partials of the head,
//     combined in chunk order, each rescaled by exp(m_c - max m) (no
//     atomics: the result does not depend on the order in which blocks
//     run), KV = sum / s; then each row of the block's chunk: q's softmax
//     within the head across 16 lanes, y = q_sm KV, rounded to q's dtype.
// A half-warp owns a row or a column of the head: the max and sum of a
// softmax are four shuffles.

#include "common.cuh"

namespace {

constexpr int kDh = 16;                 // head width (ops/attention.py HEAD_DIM)
constexpr int kChunk = 128;             // rows of one block (ops/attention.py CHUNK)
constexpr int kThreads = kDh * kDh;     // thread (i, j) = (threadIdx.x / 16, threadIdx.x % 16)
constexpr int kLd = kDh + 1;            // shared row stride: a column's rows on distinct banks
constexpr int kPart = (2 + kDh) * kDh;  // floats of one chunk's partial: m, s, KV

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16(v); }

// max / sum over the 16 lanes of a half-warp
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = kDh / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kDh / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename KT>
__global__ void __launch_bounds__(kThreads)
attention_partials_kernel(const KT* __restrict__ k, const KT* __restrict__ v,
                          float* __restrict__ part, int T, int H) {
  __shared__ float k_s[kChunk * kLd];
  __shared__ float v_s[kChunk * kLd];
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int D = H * kDh;
  const int row0 = chunk * kChunk;
  const int n_rows = min(kChunk, T - row0);
  const size_t base = ((size_t)b * T + row0) * D + h * kDh;
  for (int e = threadIdx.x; e < n_rows * kDh; e += kThreads) {
    const int r = e / kDh, c = e % kDh;
    k_s[r * kLd + c] = ld(k + base + (size_t)r * D + c);
    v_s[r * kLd + c] = ld(v + base + (size_t)r * D + c);
  }
  __syncthreads();
  // column i of k, over the rows j, j + 16, ... of this thread
  const int i = threadIdx.x / kDh, j = threadIdx.x % kDh;
  float m = -CUDART_INF_F;
  for (int r = j; r < n_rows; r += kDh) m = fmaxf(m, k_s[r * kLd + i]);
  m = group_max(m);
  float s = 0.f;
  for (int r = j; r < n_rows; r += kDh) {
    const float e = expf(k_s[r * kLd + i] - m);
    k_s[r * kLd + i] = e;
    s += e;
  }
  s = group_sum(s);
  __syncthreads();
  float acc = 0.f;  // (i, j) of sum_r exp(k[r][i] - m_i) v[r][j]
  for (int r = 0; r < n_rows; ++r) acc = fmaf(k_s[r * kLd + i], v_s[r * kLd + j], acc);
  float* p = part + (((size_t)b * H + h) * gridDim.x + chunk) * kPart;
  if (j == 0) {
    p[i] = m;
    p[kDh + i] = s;
  }
  p[2 * kDh + i * kDh + j] = acc;
}

template <typename QT>
__global__ void __launch_bounds__(kThreads)
attention_rows_kernel(const QT* __restrict__ q, const float* __restrict__ part,
                      QT* __restrict__ out, int T, int H, int n_chunks) {
  __shared__ float kv_s[kDh * kDh];
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int D = H * kDh;
  const int i = threadIdx.x / kDh, j = threadIdx.x % kDh;
  const float* p = part + ((size_t)b * H + h) * n_chunks * kPart;
  float m = -CUDART_INF_F;
  for (int c = 0; c < n_chunks; ++c) m = fmaxf(m, p[c * kPart + i]);
  float s = 0.f, acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const float w = expf(p[c * kPart + i] - m);
    s = fmaf(p[c * kPart + kDh + i], w, s);
    acc = fmaf(p[c * kPart + 2 * kDh + i * kDh + j], w, acc);
  }
  kv_s[i * kDh + j] = acc / s;
  __syncthreads();
  const int row0 = chunk * kChunk;
  const int n_rows = min(kChunk, T - row0);
  // half-warp i takes rows i, i + 16, ...; lane j holds feature j.  Every
  // lane runs every round (the shuffles need the whole warp).
  for (int r0 = 0; r0 < n_rows; r0 += kThreads / kDh) {
    const int r = r0 + i;
    const bool valid = r < n_rows;
    const size_t at = ((size_t)b * T + row0 + r) * D + h * kDh + j;
    const float x = valid ? ld(q + at) : 0.f;
    const float e = expf(x - group_max(x));
    const float qs = e / group_sum(e);
    float y = 0.f;
#pragma unroll
    for (int d = 0; d < kDh; ++d)
      y = fmaf(__shfl_sync(0xffffffffu, qs, d, kDh), kv_s[d * kDh + j], y);
    if (valid) st(out + at, y);
  }
}

template <typename KT>
void launch_partials(const void* k, const void* v, float* part, int B, int T, int H,
                     cudaStream_t s) {
  attention_partials_kernel<KT><<<dim3(ceil_div(T, kChunk), H, B), kThreads, 0, s>>>(
      static_cast<const KT*>(k), static_cast<const KT*>(v), part, T, H);
}

template <typename QT>
void launch_rows(const void* q, const float* part, void* out, int B, int T, int H, int n_chunks,
                 cudaStream_t s) {
  attention_rows_kernel<QT><<<dim3(ceil_div(T, kChunk), H, B), kThreads, 0, s>>>(
      static_cast<const QT*>(q), part, static_cast<QT*>(out), T, H, n_chunks);
}

}  // namespace

// q (B, Tq, 16 H), k and v (B, Tk, 16 H), row-major; out like q; workspace
// (B, H, ceil(Tk / 128), 288) float32.
CT_EXPORT int linear_attention_forward(const void* q, const void* k, const void* v, void* out,
                                       void* workspace, int B, int Tq, int Tk, int H, int q_bf16,
                                       int kv_bf16, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(workspace);
  if (kv_bf16)
    launch_partials<bf16>(k, v, part, B, Tk, H, s);
  else
    launch_partials<float>(k, v, part, B, Tk, H, s);
  const int n_chunks = ceil_div(Tk, kChunk);
  if (q_bf16)
    launch_rows<bf16>(q, part, out, B, Tq, H, n_chunks, s);
  else
    launch_rows<float>(q, part, out, B, Tq, H, n_chunks, s);
  return (int)cudaGetLastError();
}

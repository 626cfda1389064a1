// K2 / K3: the per-step sampler glue around the decoder stack.
//
// K2 replaces conductor_tpu/ops/pallas_sampler.py::sampler_prologue (kernel
// `_prologue_kernel`, pallas_call at :111):
//   emb_act = silu(temb[t] + emb_base)   (the temb add the JAX path does
//                                         outside its kernel is fused here)
//   h0      = x @ W_joint + seq_bias     (seq_bias = seq_emb[:T] + b_joint)
// emb_act leaves as bf16 or, in the int8-AdaLN mode (`quantize_emb`,
// :58-72), as int8 codes with one float32 scale a row: symmetric per-row
// quantization, scale = max(max|row|, 1e-8) / 127, code = round-half-even
// (emb_act / scale), JAX `quantize_rows` (pallas_layer.py:345-354).  The
// SiLU is then v * sigmoid(v), the formula of the plain version and of
// JAX: one ulp of emb_act can move a code across a half-boundary, or the
// row's maximum and so its scale.
// K3 replaces sampler_epilogue (kernel `_epilogue_kernel`, pallas_call at
// :158):
//   x_{t-1} = alpha * (h @ W_out + b_out) + beta * x_t
// with (alpha, beta) from the host's ddim_affine_tables, passed by value.
//
// What bounds them on an H100: both are memory-bound.  K2 streams emb_base
// (B*T*512 float32 = 29.5 MB at B = 8) and writes emb_act in bf16 (int8 and
// a scale a row in the int8 mode); its matmul has depth 26.  K3 reads h
// (7.4 MB) for a (128 x 26) product.
// Design: plain FMA loops, no tensor cores (depths 26 and 128, widths 128
// and 26 would waste most of an MMA tile); K2 runs one 128-thread block per
// row with the pose row in shared memory (and, in the int8 mode, the row's
// SiLU, reduced to its max |.| by warp shuffles and a 4-warp step), K3 one
// thread per output element.  The pose stays 26 wide: the TPU's zero
// padding to 128 lanes is not carried over.  Matmul operands are rounded to
// bf16 when round_bf16 is set (float32 accumulation), as the JAX kernels'
// mxu_dtype casts.

#include "common.cuh"

namespace {

constexpr int kPrologueThreads = 128;

// emb_act's row in the int8 mode: codes and a scale (one block per row)
__device__ void quantize_row(const float* a, int E, signed char* q, float* scale) {
  __shared__ float warp_max[kPrologueThreads / 32];
  float m = 0.f;
  for (int e = threadIdx.x; e < E; e += blockDim.x) m = fmaxf(m, fabsf(a[e]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = fmaxf(fmaxf(warp_max[0], warp_max[1]), fmaxf(warp_max[2], warp_max[3]));
  const float s = fmaxf(m, 1e-8f) / 127.f;
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    q[e] = (signed char)__float2int_rn(__fdiv_rn(a[e], s));  // half to even, as jnp.round
  if (threadIdx.x == 0) *scale = s;
}

__global__ void __launch_bounds__(kPrologueThreads)
prologue_kernel(const float* __restrict__ x, const float* __restrict__ temb,
                const float* __restrict__ emb_base, const float* __restrict__ w_joint,
                const float* __restrict__ seq_bias, float* __restrict__ h,
                void* __restrict__ emb_out, float* __restrict__ emb_scale, int T, int C, int D,
                int E, int rnd) {
  extern __shared__ float xs[];  // (C,) pose row, then (E,) SiLU row in the int8 mode
  const size_t row = blockIdx.x;  // b * T + t
  const int t = row % T;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float v = x[row * C + c];
    xs[c] = rnd ? round_bf16(v) : v;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < C; ++c) {
      const float wv = w_joint[c * D + d];
      acc = fmaf(xs[c], rnd ? round_bf16(wv) : wv, acc);
    }
    h[row * D + d] = acc + seq_bias[(size_t)t * D + d];
  }
  if (emb_scale == nullptr) {
    bf16* emb_act = static_cast<bf16*>(emb_out);
    for (int e = threadIdx.x; e < E; e += blockDim.x)
      emb_act[row * E + e] = __float2bfloat16(silu(temb[e] + emb_base[row * E + e]));
    return;
  }
  float* a = xs + C;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const float v = temb[e] + emb_base[row * E + e];
    a[e] = __fmul_rn(v, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v))));  // v * sigmoid(v)
  }
  __syncthreads();
  quantize_row(a, E, static_cast<signed char*>(emb_out) + row * E, emb_scale + row);
}

__global__ void epilogue_kernel(const float* __restrict__ h, const float* __restrict__ x_t,
                                const float* __restrict__ w_out,
                                const float* __restrict__ b_out, float* __restrict__ out,
                                float alpha, float beta, size_t n, int D, int C, int rnd) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / C;
    const int c = i % C;
    const float* hr = h + row * D;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) {
      const float hv = hr[d], wv = w_out[d * C + c];
      acc = rnd ? fmaf(round_bf16(hv), round_bf16(wv), acc) : fmaf(hv, wv, acc);
    }
    out[i] = alpha * (acc + b_out[c]) + beta * x_t[i];
  }
}

}  // namespace

// emb_scale null: emb_act bf16; else int8 codes and their row scales.
CT_EXPORT int sampler_prologue_forward(const void* x, const void* temb, const void* emb_base,
                                       const void* w_joint, const void* seq_bias, void* h,
                                       void* emb_act, void* emb_scale, int B, int T, int C,
                                       int D, int E, int rnd, void* stream) {
  const size_t smem = (C + (emb_scale ? E : 0)) * sizeof(float);
  prologue_kernel<<<B * T, kPrologueThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(temb),
      static_cast<const float*>(emb_base), static_cast<const float*>(w_joint),
      static_cast<const float*>(seq_bias), static_cast<float*>(h), emb_act,
      static_cast<float*>(emb_scale), T, C, D, E, rnd);
  return (int)cudaGetLastError();
}

CT_EXPORT int sampler_epilogue_forward(const void* h, const void* x_t, const void* w_out,
                                       const void* b_out, void* out, float alpha, float beta,
                                       int B, int T, int D, int C, int rnd, void* stream) {
  const size_t n = (size_t)B * T * C;
  const int blocks = (int)((n + 255) / 256);
  epilogue_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(x_t),
      static_cast<const float*>(w_out), static_cast<const float*>(b_out),
      static_cast<float*>(out), alpha, beta, n, D, C, rnd);
  return (int)cudaGetLastError();
}

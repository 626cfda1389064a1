// K4: one music-encoder Conv2dResBlock, fused.
//
// Replaces conductor_tpu/ops/pallas_conv.py::fused_conv_block (kernel
// `_conv_kernel`, pallas_call at :325): 3x3 reflect-padded conv -> folded BN
// affine -> ReLU -> residual (none / identity / 1x1 conv + folded BN), then
// the optional max-pool epilogue (time stride 1 or 3, freq stride 2, -inf
// padding) as a second launch over the block's bf16 output.
//
// Two modes of the JAX kernel's signature (`relu`, `edge`, :212-213) serve
// the trainable conv (`ops/conv_train.py`, K9's forward and d(input)): with
// scale 1, bias 0, no residual and relu off it is the bare reflect-padded
// conv, and with edge "zero" (0 loaded outside the clip) the interior of the
// transposed conv.  `max_pool_forward` runs the pool pass on its own (K10,
// `ops/max_pool.py`), for the trainable path's pool after the residual add.
//
// Layout: NHWC (B, T, F, C) bf16 activations; weights (3, 3, Cin, Cout) and
// (Cin, Cout) float32, rounded to bf16 on load (bf16 operands, float32
// accumulation, as the JAX kernel).
//
// What bounds it on an H100: the encoder's full-resolution stages (T = 5400,
// F = 128 and 64) are memory-bound at 1-32 channels (at most 9*32*32 = 9.2K
// MACs per output pixel for ~64 B moved), and the pool pass re-reads the
// block's output once.  Design: one block per (time tile, clip) stages the
// tile plus its reflected +-1 halo once in shared memory (pixel stride
// Cin | 1 words, so neighbouring threads hit different banks) together with
// all the weights; each thread then computes whole output pixels with Cout
// float32 accumulators in registers, reading each weight as a broadcast.
// The TPU's 128-lane freq blocking (build_wbig, _halo_assemble,
// stack_time_tiles) is not carried over.  Later work: tensor-core MMA for the
// 16/32-channel stages and the pool fused into the conv epilogue.

#include "common.cuh"

namespace {

__device__ __forceinline__ int reflect_index(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

constexpr int kThreads = 256;
constexpr int kMaxTileBytes = 96 * 1024;

template <int COUT>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               const float* __restrict__ resw, const float* __restrict__ rscale,
               const float* __restrict__ rbias, bf16* __restrict__ out,
               int T, int F, int cin, int res_mode, int relu, int zero_edge, int tile_t) {
  extern __shared__ float smem[];
  const int cs = cin | 1;  // padded pixel stride (odd: no bank conflicts)
  const int cols = F + 2;
  float* ws = smem;                     // (3, 3, cin, COUT)
  float* rws = ws + 9 * cin * COUT;     // (cin, COUT)
  float* xs = rws + cin * COUT;         // (tile_t + 2, F + 2, cs)
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile_t;

  for (int i = threadIdx.x; i < 9 * cin * COUT; i += blockDim.x) ws[i] = round_bf16(w[i]);
  if (res_mode == 2)
    for (int i = threadIdx.x; i < cin * COUT; i += blockDim.x) rws[i] = round_bf16(resw[i]);
  const int n_in = (tile_t + 2) * cols * cin;
  for (int i = threadIdx.x; i < n_in; i += blockDim.x) {
    const int ci = i % cin;
    const int j = (i / cin) % cols;
    const int r = i / (cin * cols);
    const int tr = t0 - 1 + r, fr = j - 1;
    float v = 0.f;
    if (!zero_edge || (tr >= 0 && tr < T && fr >= 0 && fr < F)) {
      const int t = reflect_index(tr, T), f = reflect_index(fr, F);
      v = __bfloat162float(x[(((size_t)b * T + t) * F + f) * cin + ci]);
    }
    xs[(r * cols + j) * cs + ci] = v;
  }
  __syncthreads();

  const int rows = min(tile_t, T - t0);
  for (int p = threadIdx.x; p < rows * F; p += blockDim.x) {
    const int tt = p / F, f = p % F;
    float acc[COUT];
#pragma unroll
    for (int co = 0; co < COUT; ++co) acc[co] = 0.f;
    for (int dt = 0; dt < 3; ++dt)
      for (int df = 0; df < 3; ++df) {
        const float* xp = xs + ((tt + dt) * cols + f + df) * cs;
        const float* wp = ws + (dt * 3 + df) * cin * COUT;
        for (int ci = 0; ci < cin; ++ci) {
          const float xv = xp[ci];
#pragma unroll
          for (int co = 0; co < COUT; ++co) acc[co] = fmaf(xv, wp[ci * COUT + co], acc[co]);
        }
      }
    const float* xc = xs + ((tt + 1) * cols + f + 1) * cs;  // the centre pixel
    bf16* op = out + (((size_t)b * T + t0 + tt) * F + f) * COUT;
    if (res_mode == 2) {
      float r[COUT];
#pragma unroll
      for (int co = 0; co < COUT; ++co) r[co] = 0.f;
      for (int ci = 0; ci < cin; ++ci) {
        const float xv = xc[ci];
#pragma unroll
        for (int co = 0; co < COUT; ++co) r[co] = fmaf(xv, rws[ci * COUT + co], r[co]);
      }
#pragma unroll
      for (int co = 0; co < COUT; ++co) {
        float y = fmaf(acc[co], scale[co], bias[co]);
        if (relu) y = fmaxf(y, 0.f);
        op[co] = __float2bfloat16(y + fmaf(r[co], rscale[co], rbias[co]));
      }
    } else {
#pragma unroll
      for (int co = 0; co < COUT; ++co) {
        float y = fmaf(acc[co], scale[co], bias[co]);
        if (relu) y = fmaxf(y, 0.f);
        if (res_mode == 1) y += xc[co];
        op[co] = __float2bfloat16(y);
      }
    }
  }
}

// Max-pool with -inf padding: every window holds at least one real element.
__global__ void max_pool_kernel(const bf16* __restrict__ y, bf16* __restrict__ out,
                                int B, int T, int F, int C, int To, int Fo,
                                int wt, int wf, int st, int sf, int pt, int pf) {
  const size_t n = (size_t)B * To * Fo * C;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = i % C;
    const int fo = (i / C) % Fo;
    const int to = (i / ((size_t)C * Fo)) % To;
    const int b = i / ((size_t)C * Fo * To);
    float m = -CUDART_INF_F;
    for (int dt = 0; dt < wt; ++dt) {
      const int t = to * st - pt + dt;
      if (t < 0 || t >= T) continue;
      for (int df = 0; df < wf; ++df) {
        const int f = fo * sf - pf + df;
        if (f < 0 || f >= F) continue;
        m = fmaxf(m, __bfloat162float(y[(((size_t)b * T + t) * F + f) * C + c]));
      }
    }
    out[i] = __float2bfloat16(m);
  }
}

template <int COUT>
cudaError_t launch_conv(const bf16* x, const float* w, const float* scale, const float* bias,
                        const float* resw, const float* rscale, const float* rbias,
                        bf16* out, int B, int T, int F, int cin, int res_mode, int relu,
                        int zero_edge, cudaStream_t stream) {
  const int row_bytes = (F + 2) * (cin | 1) * 4;
  int tile_t = kMaxTileBytes / row_bytes - 2;
  tile_t = tile_t < 1 ? 1 : (tile_t > 64 ? 64 : tile_t);
  const size_t smem = (size_t)(10 * cin * COUT) * 4 + (size_t)(tile_t + 2) * row_bytes;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<COUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(T, tile_t), B);
  conv3x3_kernel<COUT><<<grid, kThreads, smem, stream>>>(
      x, w, scale, bias, resw, rscale, rbias, out, T, F, cin, res_mode, relu, zero_edge, tile_t);
  return cudaGetLastError();
}

void launch_pool(const bf16* y, bf16* out, int B, int T, int F, int C, int To, int Fo, int wt,
                 int wf, int st, int sf, int pt, int pf, cudaStream_t s) {
  const size_t n = (size_t)B * To * Fo * C;
  const int blocks = (int)((n + 255) / 256 < 65535 * 8 ? (n + 255) / 256 : 65535 * 8);
  max_pool_kernel<<<blocks, 256, 0, s>>>(y, out, B, T, F, C, To, Fo, wt, wf, st, sf, pt, pf);
}

}  // namespace

CT_EXPORT int conv_block_forward(const void* x, const void* w, const void* scale,
                                 const void* bias, const void* resw, const void* rscale,
                                 const void* rbias, void* conv_out, void* pool_out,
                                 int B, int T, int F, int cin, int cout, int res_mode,
                                 int relu, int zero_edge, int wt, int wf, int st, int sf, int pt,
                                 int pf, int To, int Fo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const bf16*>(x);
  auto yb = static_cast<bf16*>(conv_out);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaError_t err;
  if (cout == 16)
    err = launch_conv<16>(xb, f(w), f(scale), f(bias), f(resw), f(rscale), f(rbias), yb,
                          B, T, F, cin, res_mode, relu, zero_edge, s);
  else if (cout == 32)
    err = launch_conv<32>(xb, f(w), f(scale), f(bias), f(resw), f(rscale), f(rbias), yb,
                          B, T, F, cin, res_mode, relu, zero_edge, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  if (pool_out != nullptr)
    launch_pool(yb, static_cast<bf16*>(pool_out), B, T, F, cout, To, Fo, wt, wf, st, sf, pt, pf, s);
  return (int)cudaGetLastError();
}

// K10: the pool pass alone, on a bf16 NHWC input.
CT_EXPORT int max_pool_forward(const void* y, void* out, int B, int T, int F, int C, int To,
                               int Fo, int wt, int wf, int st, int sf, int pt, int pf,
                               void* stream) {
  launch_pool(static_cast<const bf16*>(y), static_cast<bf16*>(out), B, T, F, C, To, Fo, wt, wf,
              st, sf, pt, pf, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// K10 and K11: the music encoder's trainable max-pool, forward and its
// first-max backward.
//
// K10 replaces conductor_tpu/ops/pallas_pool.py::fused_max_pool (pallas_call
// at :191): the window maxima with -inf padding, one thread an output
// element, on the bf16 input (the training path's pool after BatchNorm;
// the serving blocks pool in K4's epilogue, conv_block.cu).  Bytes bound it:
// it reads x (within a window from L1 / L2 again) and writes the output once.
//
// K11 replaces conductor_tpu/ops/pallas_pool.py::_make_pool_op's backward
// (kernel `_pool_bwd_kernel`, pallas_call at :386).  The whole cotangent of
// each output window goes to ONE input position, chosen by the JAX kernel's
// tie rule (`pallas_pool.py:219-232, 277-343`): the first freq tap, in
// ascending order, whose time-pooled column maximum equals the window
// maximum; in that column, the first time tap, in ascending order, that
// attains it.  Padding is -inf: a tap outside the input never wins.
// PyTorch's max_pool2d backward breaks ties its own way, and post-ReLU zero
// plateaus are common, so the routing is written out here.
//
// Layout: x (B, T, F, C) and dx bf16 NHWC, dy (B, To, Fo, C) bf16; window,
// stride and padding as `max_pool_forward` takes them.
//
// What bounds it on an H100: bytes.  It reads x once (and, within a window,
// from L1/L2 again), dy once, and writes dx once; no arithmetic to speak of.
// Design: two passes, deterministic and without atomics.  Pass 1, one
// thread per output element, recomputes the window's maximum and stores its
// winner's flat (t, f) as one int32.  Pass 2, one thread per input element,
// sums in a fixed order the float32 cotangents of the covering windows
// (at most 5 x 3) whose winner it is, and writes bf16.  Equality is tested
// on the bf16 values widened exactly to float32, as the TPU kernel does.

#include "common.cuh"

namespace {

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

__global__ void pool_winner_kernel(const bf16* __restrict__ x, int* __restrict__ win, int B,
                                   int T, int F, int C, int To, int Fo, int wt, int wf, int st,
                                   int sf, int pt, int pf) {
  const size_t n = (size_t)B * To * Fo * C;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = i % C;
    const int fo = (i / C) % Fo;
    const int to = (i / ((size_t)C * Fo)) % To;
    const int b = i / ((size_t)C * Fo * To);
    const bf16* xb = x + (size_t)b * T * F * C + c;
    float best = -CUDART_INF_F;
    int best_f = -1;
    for (int df = 0; df < wf; ++df) {
      const int f = fo * sf - pf + df;
      if (f < 0 || f >= F) continue;
      float m = -CUDART_INF_F;
      for (int dt = 0; dt < wt; ++dt) {
        const int t = to * st - pt + dt;
        if (t >= 0 && t < T) m = fmaxf(m, __bfloat162float(xb[((size_t)t * F + f) * C]));
      }
      if (best_f < 0 || m > best) {  // strict: the first column attaining the maximum
        best = m;
        best_f = f;
      }
    }
    int w = -1;
    for (int dt = 0; dt < wt && w < 0; ++dt) {
      const int t = to * st - pt + dt;
      if (t >= 0 && t < T && __bfloat162float(xb[((size_t)t * F + best_f) * C]) == best)
        w = t * F + best_f;
    }
    win[i] = w;
  }
}

// First index o >= 0 with o * s - p + w - 1 >= i, i.e. the first window
// covering position i.
__device__ __forceinline__ int first_window(int i, int w, int s, int p) {
  const int num = i + p - w + 1;
  return num <= 0 ? 0 : (num + s - 1) / s;
}

__global__ void pool_route_kernel(const bf16* __restrict__ dy, const int* __restrict__ win,
                                  bf16* __restrict__ dx, int B, int T, int F, int C, int To,
                                  int Fo, int wt, int wf, int st, int sf, int pt, int pf) {
  const size_t n = (size_t)B * T * F * C;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = i % C;
    const int f = (i / C) % F;
    const int t = (i / ((size_t)C * F)) % T;
    const int b = i / ((size_t)C * F * T);
    const int to_hi = min(To - 1, (t + pt) / st), fo_hi = min(Fo - 1, (f + pf) / sf);
    const int me = t * F + f;
    float acc = 0.f;
    for (int to = first_window(t, wt, st, pt); to <= to_hi; ++to)
      for (int fo = first_window(f, wf, sf, pf); fo <= fo_hi; ++fo) {
        const size_t j = (((size_t)b * To + to) * Fo + fo) * C + c;
        if (win[j] == me) acc += __bfloat162float(dy[j]);
      }
    dx[i] = __float2bfloat16(acc);
  }
}

int grid_for(size_t n) {
  return (int)((n + 255) / 256 < 65535 * 8 ? (n + 255) / 256 : 65535 * 8);
}

}  // namespace

// K10: y (B, T, F, C) -> out (B, To, Fo, C).
CT_EXPORT int max_pool_forward(const void* y, void* out, int B, int T, int F, int C, int To,
                               int Fo, int wt, int wf, int st, int sf, int pt, int pf,
                               void* stream) {
  max_pool_kernel<<<grid_for((size_t)B * To * Fo * C), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y), static_cast<bf16*>(out), B, T, F, C, To, Fo, wt, wf, st, sf,
      pt, pf);
  return (int)cudaGetLastError();
}

// K11.  winner: int32 scratch of dy's shape.
CT_EXPORT int max_pool_backward(const void* x, const void* dy, void* winner, void* dx, int B,
                                int T, int F, int C, int To, int Fo, int wt, int wf, int st,
                                int sf, int pt, int pf, void* stream) {
  if (pt >= wt || pf >= wf || st < 1 || sf < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const bf16*>(x);
  auto dyb = static_cast<const bf16*>(dy);
  auto win = static_cast<int*>(winner);
  pool_winner_kernel<<<grid_for((size_t)B * To * Fo * C), 256, 0, s>>>(
      xb, win, B, T, F, C, To, Fo, wt, wf, st, sf, pt, pf);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pool_route_kernel<<<grid_for((size_t)B * T * F * C), 256, 0, s>>>(
      dyb, win, static_cast<bf16*>(dx), B, T, F, C, To, Fo, wt, wf, st, sf, pt, pf);
  return (int)cudaGetLastError();
}

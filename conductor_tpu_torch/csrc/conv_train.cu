// K9: d(kernel) of the reflect-padded 3x3 conv of the trainable music
// encoder.
//
// Replaces conductor_tpu/ops/conv_train.py::_dkernel_pallas (kernel
// `_dkernel_kernel`, pallas_call at :122):
//
//   dW[dt, df, ci, co] = sum over (b, t, f) of xe[b, t+dt-1, f+df-1, ci] * dy[b, t, f, co]
//
// with xe the input reflect-extended by one row and column on each side.
// The TPU kernel computes it in the lane-blocked halo layout
// ((G+2)*Cin x G*Cout per time shift) and folds that back with offset-eye
// contractions; here the result is (3, 3, Cin, Cout) directly.
//
// Layout: x (B, T, F, Cin) and dy (B, T, F, Cout) bf16 NHWC; dW float32
// (3, 3, Cin, Cout), float32 accumulation.
//
// What bounds it on an H100: a skinny reduction, at most 9*32*32 = 9216
// outputs over B*T*F <= 1.15 M rows at the stage-1 shapes.  It moves the two
// inputs once (~37 MB each at the full-resolution stage) and does at most
// 2 * 9216 flops per row: bound by bytes at the bf16 tensor-core rate, by
// float32 FMAs on the CUDA cores as written.  Design: one block per
// (clip, chunk of rows) stages each time tile of x with its reflected +-1
// halo and the tile of dy in shared memory (odd pixel strides: no bank
// conflicts), every thread owns one (tap, ci) and Cout float32 accumulators
// over a slice of the tile's pixels, the slices are summed in shared memory,
// and each block writes its partial to a workspace; a second launch sums the
// partials in block order.  No atomics: the result is deterministic, as K6's
// weight gradients are.  Later work: tensor-core MMA over the pixel axis.

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kTileBytes = 96 * 1024;
constexpr int kTargetBlocks = 2 * 132;  // two blocks on each of the H100's SMs

__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

struct Plan {
  int tile_t, chunks, rows_per_block, nslices, threads;
  size_t smem;
};

Plan plan(int B, int T, int F, int cin, int cout) {
  Plan p;
  const int xrow = (F + 2) * (cin | 1) * 4, drow = F * (cout + 1) * 4;
  p.tile_t = (kTileBytes - 2 * xrow) / (xrow + drow);
  p.tile_t = p.tile_t < 1 ? 1 : (p.tile_t > 64 ? 64 : p.tile_t);
  const int tiles = ceil_div(T, p.tile_t);
  const int want = ceil_div(kTargetBlocks, B);
  p.chunks = tiles < want ? tiles : want;
  p.rows_per_block = ceil_div(ceil_div(T, p.chunks), p.tile_t) * p.tile_t;
  p.chunks = ceil_div(T, p.rows_per_block);
  const int groups = 9 * cin;
  p.nslices = groups >= kMaxThreads ? 1 : kMaxThreads / groups;
  p.threads = groups * p.nslices;
  const size_t tile = (size_t)(p.tile_t + 2) * xrow + (size_t)p.tile_t * drow;
  const size_t red = (size_t)p.nslices * groups * cout * 4;
  p.smem = tile > red ? tile : red;
  return p;
}

template <int COUT>
__global__ void __launch_bounds__(kMaxThreads)
dkernel_partial(const bf16* __restrict__ x, const bf16* __restrict__ dy, float* __restrict__ ws,
                int T, int F, int cin, int tile_t, int rows_per_block, int nslices) {
  extern __shared__ float smem[];
  const int xs_stride = cin | 1, ds = COUT + 1, cols = F + 2;
  float* xs = smem;                                  // (tile_t + 2, F + 2, xs_stride)
  float* dys = xs + (size_t)(tile_t + 2) * cols * xs_stride;  // (tile_t, F, ds)
  const int groups = 9 * cin;
  const int b = blockIdx.y;
  const int g = threadIdx.x % groups, s = threadIdx.x / groups;
  const int tap = g / cin, ci = g % cin, dt = tap / 3, df = tap % 3;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(T, r0 + rows_per_block);

  float acc[COUT];
#pragma unroll
  for (int co = 0; co < COUT; ++co) acc[co] = 0.f;
  for (int t0 = r0; t0 < r1; t0 += tile_t) {
    const int rows = min(tile_t, r1 - t0);
    __syncthreads();  // the previous tile is consumed
    const int n_x = (rows + 2) * cols * cin;
    for (int i = threadIdx.x; i < n_x; i += blockDim.x) {
      const int c = i % cin, j = (i / cin) % cols, r = i / (cin * cols);
      const int t = reflect(t0 - 1 + r, T), f = reflect(j - 1, F);
      xs[(r * cols + j) * xs_stride + c] =
          __bfloat162float(x[(((size_t)b * T + t) * F + f) * cin + c]);
    }
    const int n_d = rows * F * COUT;
    const bf16* dyp = dy + ((size_t)b * T + t0) * F * COUT;
    for (int i = threadIdx.x; i < n_d; i += blockDim.x)
      dys[(i / COUT) * ds + i % COUT] = __bfloat162float(dyp[i]);
    __syncthreads();
    for (int p = s; p < rows * F; p += nslices) {
      const int tt = p / F, f = p % F;
      const float xv = xs[((tt + dt) * cols + f + df) * xs_stride + ci];
      const float* d = dys + p * ds;
#pragma unroll
      for (int co = 0; co < COUT; ++co) acc[co] = fmaf(xv, d[co], acc[co]);
    }
  }
  __syncthreads();
  float* red = smem;  // (nslices, groups, COUT)
#pragma unroll
  for (int co = 0; co < COUT; ++co) red[((size_t)s * groups + g) * COUT + co] = acc[co];
  __syncthreads();
  const int n = groups * COUT;
  float* out = ws + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * n;
  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    float v = 0.f;
    for (int k = 0; k < nslices; ++k) v += red[(size_t)k * n + o];
    out[o] = v;
  }
}

// dW[o] = sum of the blocks' partials, in block order.
__global__ void dkernel_reduce(const float* __restrict__ ws, float* __restrict__ dw, int nblocks,
                               int n) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  float v = 0.f;
  for (int k = 0; k < nblocks; ++k) v += ws[(size_t)k * n + o];
  dw[o] = v;
}

template <int COUT>
cudaError_t launch(const bf16* x, const bf16* dy, float* ws, float* dw, int B, int T, int F,
                   int cin, cudaStream_t s) {
  const Plan p = plan(B, T, F, cin, COUT);
  cudaError_t err = cudaFuncSetAttribute(dkernel_partial<COUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  dkernel_partial<COUT><<<dim3(p.chunks, B), p.threads, p.smem, s>>>(
      x, dy, ws, T, F, cin, p.tile_t, p.rows_per_block, p.nslices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = 9 * cin * COUT;
  dkernel_reduce<<<ceil_div(n, 256), 256, 0, s>>>(ws, dw, p.chunks * B, n);
  return cudaGetLastError();
}

bool supported(int T, int F, int cin, int cout) {
  return T >= 2 && F >= 2 && (cin == 1 || cin == 16 || cin == 32) && (cout == 16 || cout == 32);
}

}  // namespace

// Bytes of float32 workspace `conv3x3_dkernel` needs; -1 for a shape it does
// not take.
CT_EXPORT long long conv3x3_dkernel_workspace(int B, int T, int F, int cin, int cout) {
  if (!supported(T, F, cin, cout)) return -1;
  const Plan p = plan(B, T, F, cin, cout);
  return (long long)p.chunks * B * 9 * cin * cout * 4;
}

CT_EXPORT int conv3x3_dkernel(const void* x, const void* dy, void* workspace, void* dw, int B,
                              int T, int F, int cin, int cout, void* stream) {
  if (!supported(T, F, cin, cout)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const bf16*>(x);
  auto db = static_cast<const bf16*>(dy);
  auto ws = static_cast<float*>(workspace);
  auto out = static_cast<float*>(dw);
  const cudaError_t err = cout == 16 ? launch<16>(xb, db, ws, out, B, T, F, cin, s)
                                     : launch<32>(xb, db, ws, out, B, T, F, cin, s);
  return (int)err;
}

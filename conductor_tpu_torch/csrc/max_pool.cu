// K10 and K11: the music encoder's trainable max-pool, forward and its
// first-max backward.
//
// K10 replaces conductor_tpu/ops/pallas_pool.py::fused_max_pool (pallas_call
// at :191): the window maxima with -inf padding, on the bf16 or float32
// input (the training path's pool after BatchNorm; the serving blocks pool
// in K4's epilogue, conv_block.cu).
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
// Layout: x (B, T, F, C), out (B, To, Fo, C), dy like out and dx like x,
// all bf16 NHWC, or all float32 (the float32 mode of the JAX kernels, which
// pool x in its own dtype, pallas_pool.py:186, 209, 378, 415-436); window,
// stride and padding as the entry points take them.
//
// What bounds both on an H100: bytes.  K10 must read x once and write the
// output once, K11 read x and dy once and write dx once; their compares and
// adds are a few dozen a value.  Both are one launch a call, separable like
// the TPU kernel, with nothing in global memory but their operands, and
// share one staging design.  One thread owns one 8-channel column vector
// (16 bytes) of a block's staged input row: it brings its column's x rows
// into a shared-memory ring with 16-byte cp.async, one window ahead (rows
// outside [0, T) become -inf there, with no global read), and takes each
// window's time maximum of its column with bf16x2 max (exact), staged in
// shared memory between PF -inf columns each side; a window thread then
// takes the maximum over its WF staged columns.
//
// K10: a block owns a tile of OUTPUT rows of one clip (and, for wide rows,
// a chunk of output columns, staging their input columns with the halo),
// so each window is computed once; it walks its windows, double-buffering
// the time maxima so that one barrier a window does, and writes each
// output vector with one 16-byte store.
//
// K11: a block owns a tile of INPUT rows of one clip (and, for wide rows,
// a range of columns) and walks the output rows (windows) that cover it,
// recomputing the few that reach past its edge:
//   1. time: the window maximum of its column and the first tap attaining
//      it (bf16x2 compare, exact), the tap kept in registers;
//   2. freq: per window, a thread takes the maximum of its WF staged column
//      maxima and the first column attaining it, a one-hot code in shared
//      memory, beside the window's dy (cp.async, one window ahead);
//   3. routing, by gather in a fixed order: a column's thread sums, in
//      float32, the dy of each window of the row whose code names its
//      column (freq windows ascending), then adds that sum to the one of
//      the window's WT dx rows its tap names, kept in registers (time
//      windows ascending); a row no later window covers is written in the
//      input's type with one 16-byte store, and the rest move up by the
//      time stride.
// No atomics and no cross-block sums: a repeat is bit-identical and
// sum dx == sum dy.
//
// The channels, window, strides and padding are template parameters (the
// encoder's three pools, C 16 or 32: POOL_INSTANCES), so no inner loop
// divides by a runtime value; index math is 32-bit but for the clip's base
// offset.  So is the element type (`Bf16Elems`, `F32Elems`): a thread's
// 16-byte vector holds 8 bf16 or 4 float32 values, compared exactly in
// either (bf16x2 or float max and equality), the float32 mode thus having
// twice the vectors a row, which `fwd_plan` / `bwd_plan` tile for; a
// 32-bit word holds 2 or 1 of its values' time taps and freq codes.  `ops.max_pool.fwd_plan` / `bwd_plan` choose the rows a tile and
// the columns a block and say what each block stages; `max_pool_fwd_plan`
// reports K10's ranges from the kernel's own formulas.

#include <stdint.h>

#include "common.cuh"

// The encoder's pools (models/music_encoder.py POOLS: conv1, conv2, conv3)
// at C = 16 and 32, as X(C, WT, WF, ST, SF, PT, PF): the kernels' instances.
#define POOL_INSTANCES(X)   \
  X(16, 5, 5, 1, 2, 2, 2)   \
  X(32, 5, 5, 1, 2, 2, 2)   \
  X(16, 5, 5, 3, 2, 2, 2)   \
  X(32, 5, 5, 3, 2, 2, 2)   \
  X(16, 3, 3, 1, 2, 1, 1)   \
  X(32, 3, 3, 1, 2, 1, 1)

namespace {

constexpr int kPoolMaxThreads = 256;  // one thread a staged 8-channel column vector
constexpr int kFwdBlocksPerSm = 4;    // K10's launch bounds (ops/max_pool.py FWD_BLOCKS_PER_SM)

// ---- shared by K10 and K11 --------------------------------------------------

// cp.async with the compiler barred from moving shared-memory accesses
// across it: a thread reads back its own copies after `wait` without a
// block barrier in between.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ __nv_bfloat162 as_b2(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}
// bf16x2 maximum and equality mask (0xffff a half where equal), both exact
__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmax2(as_b2(a), as_b2(b));
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t eq2(uint32_t a, uint32_t b) {
  return __heq2_mask(as_b2(a), as_b2(b));
}
// 0xffff in each 16-bit half whose bit 15 is set (prmt replicates the sign
// bits of bytes 1 and 3)
__device__ __forceinline__ uint32_t sign_halves(uint32_t v) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, 0xBB99;" : "=r"(r) : "r"(v), "r"(0u));
  return r;
}

// The element types, as the kernels see a 32-bit word: kLanes values, each
// a lane of kLaneBits bits; a time tap is a lane-wide integer, a freq code
// a one-hot bit counted down from the lane's top bit (kTop).
struct Bf16Elems {
  typedef bf16 T;
  static constexpr int kPerVec = 8, kLanes = 2;
  static constexpr uint32_t kNegInf = 0xFF80FF80u;  // two bf16 -inf
  static constexpr uint32_t kOnes = 0x00010001u;    // 1 in each lane
  static constexpr uint32_t kTop = 0x8000u;
  __device__ static uint32_t max(uint32_t a, uint32_t b) { return max2(a, b); }
  __device__ static uint32_t eq(uint32_t a, uint32_t b) { return eq2(a, b); }
  __device__ static uint32_t sign(uint32_t v) { return sign_halves(v); }
  // lane h of d as a float, lane h of a tap word
  __device__ static float value(uint32_t d, int h) {
    return __uint_as_float(h == 0 ? d << 16 : d & 0xFFFF0000u);
  }
  __device__ static int tap(uint32_t t, int h) { return h == 0 ? t & 0xFFFF : t >> 16; }
  __device__ static uint32_t pack(const float* v) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
};
struct F32Elems {
  typedef float T;
  static constexpr int kPerVec = 4, kLanes = 1;
  static constexpr uint32_t kNegInf = 0xFF800000u;
  static constexpr uint32_t kOnes = 1u;
  static constexpr uint32_t kTop = 0x80000000u;
  __device__ static uint32_t max(uint32_t a, uint32_t b) {
    return __float_as_uint(fmaxf(__uint_as_float(a), __uint_as_float(b)));
  }
  __device__ static uint32_t eq(uint32_t a, uint32_t b) {
    return __uint_as_float(a) == __uint_as_float(b) ? 0xFFFFFFFFu : 0u;
  }
  __device__ static uint32_t sign(uint32_t v) { return (uint32_t)((int)v >> 31); }
  __device__ static float value(uint32_t d, int) { return __uint_as_float(d); }
  __device__ static int tap(uint32_t t, int) { return (int)t; }
  __device__ static uint32_t pack(const float* v) { return __float_as_uint(v[0]); }
};

template <class E>
__device__ __forceinline__ uint4 neg_inf4() {
  return make_uint4(E::kNegInf, E::kNegInf, E::kNegInf, E::kNegInf);
}

// The first window (output index) covering input index i, for window W,
// stride S, padding P: the first o >= 0 with o * S - P + W - 1 >= i.
template <int W, int S, int P>
__device__ __forceinline__ int first_cover(int i) {
  const int n = i + P - W + 1;
  return n <= 0 ? 0 : (n + S - 1) / S;
}

// The x ring's rows: a window's WT rows and the next window's ST new ones,
// in whole strides.
template <int WT, int ST>
__host__ __device__ constexpr int ring_rows() {
  return (WT + 2 * ST - 1) / ST * ST;
}

// x row r of a thread's column (`col`, rows `row_stride` apart), ring
// position rel, into the thread's slot of the ring (n threads a row):
// 16-byte cp.async, or -inf outside [0, T) with no global read.
template <class E, int RX>
__device__ __forceinline__ void stage_row(uint4* ring, int n, int tid, int rel, int r, int T,
                                          const typename E::T* col, int row_stride) {
  uint4* dst = ring + (rel % RX) * n + tid;
  if (r >= 0 && r < T) cp_async16(dst, col + r * row_stride);
  else *dst = neg_inf4<E>();
}

// The WT staged rows of window w (ring position w * ST on) of a thread's column.
template <int WT, int ST, int RX>
__device__ __forceinline__ void window_rows(const uint4* ring, int n, int tid, int w,
                                            uint4 (&v)[WT]) {
#pragma unroll
  for (int dt = 0; dt < WT; ++dt) v[dt] = ring[((w * ST + dt) % RX) * n + tid];
}

// A window's WF time maxima from its first column's (`t`), V vectors a column.
template <int WF, int V>
__device__ __forceinline__ void window_cols(const uint4* t, uint4 (&v)[WF]) {
#pragma unroll
  for (int df = 0; df < WF; ++df) v[df] = t[df * V];
}

// The maximum of W vectors, value by value (exact)
template <class E, int W>
__device__ __forceinline__ uint4 max_of(const uint4 (&v)[W]) {
  uint4 m = v[0];
#pragma unroll
  for (int i = 1; i < W; ++i) {
    m.x = E::max(m.x, v[i].x);
    m.y = E::max(m.y, v[i].y);
    m.z = E::max(m.z, v[i].z);
    m.w = E::max(m.w, v[i].w);
  }
  return m;
}

// The PF -inf columns each side of a row of ncol staged time maxima.
template <class E, int PF, int V>
__device__ __forceinline__ void pad_columns(uint4* tmv, int ncol, int tid) {
  if (tid < PF * V) {
    tmv[tid] = neg_inf4<E>();
    tmv[PF * V + ncol + tid] = neg_inf4<E>();
  }
}

// ---- K10 --------------------------------------------------------------------

// Tile i of `per` outputs along one axis of n_in inputs and n_out outputs
// (window W, stride S, padding P): outputs [lo, hi), and the inputs their
// windows read within [0, n_in), [x0, x1).  The kernel and
// `max_pool_fwd_plan` (and `ops.max_pool.fwd_plan`) share it.
struct Span {
  int lo, hi, x0, x1;
};
__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ Span fwd_span(int i, int per, int n_in, int n_out, int W, int S,
                                                  int P) {
  const int lo = i * per, hi = imin(n_out, lo + per);
  return {lo, hi, imax(0, lo * S - P), imin(n_in, (hi - 1) * S - P + W)};
}

// One block: clip blockIdx.z, output rows (windows) tile blockIdx.x of
// `rows`, output columns chunk blockIdx.y of `cols`.  Shared memory (16-byte
// units, blockDim.x = N threads): the x ring [RX][N] and the time maxima
// of two windows over the staged columns with PF -inf columns each side,
// [2][N + 2 PF V].
template <class E, int C, int WT, int WF, int ST, int SF, int PT, int PF>
__global__ void __launch_bounds__(kPoolMaxThreads, kFwdBlocksPerSm)
pool_fwd_kernel(const typename E::T* __restrict__ x, typename E::T* __restrict__ out, int T, int F,
                int To, int Fo, int rows, int cols) {
  constexpr int K = E::kPerVec;
  constexpr int V = C / K;  // 16-byte vectors a (t, f)
  constexpr int RX = ring_rows<WT, ST>();
  static_assert(C % K == 0 && ST <= WT && SF <= WF && PT < WT && PF < WF, "pool geometry");
  static_assert(2 * PF <= WF - 1, "pool geometry");

  extern __shared__ uint4 smem[];
  const int n = blockDim.x, tid = threadIdx.x;
  const int tw = n + 2 * PF * V;  // one window's time maxima
  uint4* xs = smem;               // [RX][n]
  uint4* tmv = xs + RX * n;       // [2][tw]

  const Span rs = fwd_span(blockIdx.x, rows, T, To, WT, ST, PT);
  const Span cs = fwd_span(blockIdx.y, cols, F, Fo, WF, SF, PF);
  const int nw = rs.hi - rs.lo, xr0 = rs.lo * ST - PT;  // x rows from xr0 (-inf before 0)
  const int ncol = (cs.x1 - cs.x0) * V, nwin = (cs.hi - cs.lo) * V;
  const int c8 = tid % V;
  const bool col_thread = tid < ncol, win_thread = tid < nwin;
  const int q = cs.x0 + tid / V;   // a column thread's column
  const int fo = cs.lo + tid / V;  // a window thread's window

  const int xrow = F * C, orow = Fo * C;
  const size_t clip = blockIdx.z;
  const typename E::T* xq = x + clip * T * xrow + q * C + c8 * K;
  typename E::T* oq = out + (clip * To + rs.lo) * orow + fo * C + c8 * K;

  pad_columns<E, PF, V>(tmv, ncol, tid);
  pad_columns<E, PF, V>(tmv + tw, ncol, tid);
  if (col_thread) {
#pragma unroll
    for (int i = 0; i < WT; ++i) stage_row<E, RX>(xs, n, tid, i, xr0 + i, T, xq, xrow);
  }
  cp_async_commit();

  for (int w = 0; w < nw; ++w) {  // window rs.lo + w
    if (col_thread && w + 1 < nw) {
#pragma unroll
      for (int i = 0; i < ST; ++i) {  // the next window's new rows
        const int rel = w * ST + WT + i;
        stage_row<E, RX>(xs, n, tid, rel, xr0 + rel, T, xq, xrow);
      }
    }
    cp_async_commit();
    cp_async_wait<1>();  // this window's x rows are in
    uint4* tm = tmv + (w & 1) * tw;
    if (col_thread) {
      uint4 v[WT];
      window_rows<WT, ST, RX>(xs, n, tid, w, v);
      tm[PF * V + tid] = max_of<E>(v);
    }
    // the time maxima in; the window before the last is done with the other buffer
    __syncthreads();
    if (win_thread) {
      uint4 v[WF];
      window_cols<WF, V>(tm + (fo * SF - cs.x0) * V + c8, v);
      *reinterpret_cast<uint4*>(oq + w * orow) = max_of<E>(v);
    }
  }
}

// The shared bytes of a K10 block of `threads` threads (as fwd_plan counts
// them), V 16-byte vectors a (t, f).
template <int V, int WT, int WF, int ST, int SF, int PT, int PF>
int fwd_smem(int threads) {
  return (ring_rows<WT, ST>() * threads + 2 * (threads + 2 * PF * V)) * 16;
}

// Whether a K10 launch of `threads` threads a block holds each block's
// staged column vectors: a full chunk of `cols` windows stages at most
// (cols - 1) SF + WF columns.
template <int V, int WT, int WF, int ST, int SF, int PT, int PF>
bool fwd_threads_ok(int F, int cols, int threads) {
  return imin(F, (cols - 1) * SF + WF) * V <= threads && cols * V <= threads;
}

template <class E, int C, int WT, int WF, int ST, int SF, int PT, int PF>
int launch_fwd(const void* x, void* out, int B, int T, int F, int To, int Fo, int rows, int cols,
               int threads, cudaStream_t s) {
  constexpr int V = C / E::kPerVec;
  if (!fwd_threads_ok<V, WT, WF, ST, SF, PT, PF>(F, cols, threads))
    return (int)cudaErrorInvalidValue;
  auto kernel = pool_fwd_kernel<E, C, WT, WF, ST, SF, PT, PF>;
  const int smem = fwd_smem<V, WT, WF, ST, SF, PT, PF>(threads);
  static int smem_set = 48 * 1024;  // the default limit; raised once per instantiation
  if (smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const dim3 grid(ceil_div(To, rows), ceil_div(Fo, cols), B);
  kernel<<<grid, threads, smem, s>>>(static_cast<const typename E::T*>(x),
                                     static_cast<typename E::T*>(out), T, F, To, Fo, rows, cols);
  return (int)cudaGetLastError();
}

// ---- K11 --------------------------------------------------------------------

// One block: clip blockIdx.z, input rows [t0, t0 + rows), owned columns
// [q0, q0 + cols).  Shared memory (16-byte units, blockDim.x = N threads):
// the x ring [RX][N], the time maxima of one window row over the staged
// columns and PF -inf columns each side [N + 2 PF V], the window codes
// [N] and dy of two window rows [2][N].
template <class E, int C, int WT, int WF, int ST, int SF, int PT, int PF>
__global__ void __launch_bounds__(kPoolMaxThreads, 2)
pool_bwd_kernel(const typename E::T* __restrict__ x, const typename E::T* __restrict__ dy,
                typename E::T* __restrict__ dx, int T, int F, int To, int Fo, int rows, int cols) {
  constexpr int K = E::kPerVec, L = E::kLanes;     // values a vector, a 32-bit word
  constexpr int V = C / K;                         // 16-byte vectors a (t, f)
  constexpr int RX = ring_rows<WT, ST>();          // x ring: a window's rows and the next's new
  constexpr int NC = (WF + SF - 1) / SF;           // windows covering a column, at most
  static_assert(C % K == 0 && ST <= WT && SF <= WF && PT < WT && PF < WF, "pool geometry");
  // every input row and column lies in a window, and a block's windows are
  // no more than its staged columns
  static_assert(PT >= ST - 1 && PF >= SF - 1 && 2 * PF <= WF - 1, "pool geometry");

  extern __shared__ uint4 smem[];
  const int n = blockDim.x, tid = threadIdx.x;
  uint4* xs = smem;                        // [RX][n]
  uint4* tmv = xs + RX * n;                // [n + 2 PF V]
  uint4* codes = tmv + n + 2 * PF * V;     // [n]
  uint4* dyv = codes + n;                  // [2][n]

  // rows: owned [t0, t1), windows [o0, o1], x rows from xr0
  const int t0 = blockIdx.x * rows, t1 = min(T, t0 + rows);
  const int o0 = first_cover<WT, ST, PT>(t0), o1 = min(To - 1, (t1 - 1 + PT) / ST);
  const int nw = o1 - o0 + 1, xr0 = o0 * ST - PT;
  // columns: owned [q0, q1), windows [f0, f1], staged [qa, qb)
  const int q0 = blockIdx.y * cols, q1 = min(F, q0 + cols);
  const int f0 = first_cover<WF, SF, PF>(q0), f1 = min(Fo - 1, (q1 - 1 + PF) / SF);
  const int qa = max(0, f0 * SF - PF), qb = min(F, f1 * SF - PF + WF);
  const int ncol = (qb - qa) * V, nwin = (f1 - f0 + 1) * V;

  const int c8 = tid % V;
  const bool col_thread = tid < ncol, win_thread = tid < nwin;
  const int q = qa + tid / V;             // a column thread's column
  const bool owned = col_thread && q >= q0 && q < q1;
  const int fo = f0 + tid / V;            // a window thread's window
  // the windows covering column q
  const int fa = first_cover<WF, SF, PF>(q), fb = min(Fo - 1, (q + PF) / SF);

  const int xrow = F * C, dyrow = Fo * C;
  const size_t clip = blockIdx.z;
  const typename E::T* xq = x + clip * T * xrow + q * C + c8 * K;
  const typename E::T* dyq = dy + clip * To * dyrow + fo * C + c8 * K;
  typename E::T* dxq = dx + clip * T * xrow + q * C + c8 * K;

  pad_columns<E, PF, V>(tmv, ncol, tid);
  if (col_thread) {
#pragma unroll
    for (int i = 0; i < WT; ++i) stage_row<E, RX>(xs, n, tid, i, xr0 + i, T, xq, xrow);
  }
  if (win_thread) cp_async16(dyv + tid, dyq + o0 * dyrow);
  cp_async_commit();

  float acc[WT][K];  // dx rows ts .. ts + WT - 1 of the current window
#pragma unroll
  for (int s = 0; s < WT; ++s)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[s][k] = 0.f;

  for (int w = 0; w < nw; ++w) {  // window o0 + w
    if (col_thread && w + 1 < nw) {
#pragma unroll
      for (int i = 0; i < ST; ++i) {  // the next window's new rows
        const int rel = w * ST + WT + i;
        stage_row<E, RX>(xs, n, tid, rel, xr0 + rel, T, xq, xrow);
      }
    }
    cp_async_commit();
    cp_async_wait<1>();  // this window's x rows and dy are in

    // 1. time: the column's maximum over the window's rows, the first tap attaining it
    uint32_t tap[4] = {0u, 0u, 0u, 0u};
    if (col_thread) {
      uint4 v[WT];
      window_rows<WT, ST, RX>(xs, n, tid, w, v);
      const uint4 mv = max_of<E>(v);
      const uint32_t m[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
      for (int dt = WT - 1; dt >= 0; --dt) {  // descending: the first tap is set last
        const uint32_t d2 = dt * E::kOnes;
        const uint32_t e[4] = {E::eq(v[dt].x, m[0]), E::eq(v[dt].y, m[1]), E::eq(v[dt].z, m[2]),
                               E::eq(v[dt].w, m[3])};
#pragma unroll
        for (int j = 0; j < 4; ++j) tap[j] = (d2 & e[j]) | (tap[j] & ~e[j]);
      }
      tmv[PF * V + tid] = mv;
    }
    __syncthreads();

    // 2. freq: the window's maximum over its columns' maxima and the first
    // column attaining it, as a one-hot code (bit 15 - df of each bf16
    // half, bit 31 - df of a float32 word)
    if (win_thread) {
      uint4 v[WF];
      window_cols<WF, V>(tmv + (fo * SF - qa) * V + c8, v);  // from the window's first column
      const uint4 mv = max_of<E>(v);
      const uint32_t m[4] = {mv.x, mv.y, mv.z, mv.w};
      uint32_t code[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int df = WF - 1; df >= 0; --df) {
        const uint32_t h2 = (E::kTop >> df) * E::kOnes;
        const uint32_t e[4] = {E::eq(v[df].x, m[0]), E::eq(v[df].y, m[1]), E::eq(v[df].z, m[2]),
                               E::eq(v[df].w, m[3])};
#pragma unroll
        for (int j = 0; j < 4; ++j) code[j] = (h2 & e[j]) | (code[j] & ~e[j]);
      }
      codes[tid] = make_uint4(code[0], code[1], code[2], code[3]);
      if (w + 1 < nw) cp_async16(dyv + ((w + 1) & 1) * n + tid, dyq + (o0 + w + 1) * dyrow);
    }
    cp_async_commit();
    __syncthreads();

    // 3. routing: the dy of the row's windows whose code names this column
    // (freq windows ascending), then into the dx row its tap names
    if (owned) {
      float g[K];
#pragma unroll
      for (int k = 0; k < K; ++k) g[k] = 0.f;
      const uint4* dyw = dyv + (w & 1) * n;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int f = fa + i;
        if (f <= fb) {
          const int df = q + PF - f * SF, at = (f - f0) * V + c8;
          const uint4 cv = codes[at], dv = dyw[at];
          const uint32_t cw[4] = {cv.x, cv.y, cv.z, cv.w}, dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t d = dw[j] & E::sign(cw[j] << df);
#pragma unroll
            for (int h = 0; h < L; ++h) g[L * j + h] += E::value(d, h);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < L; ++h) {
          const int th = E::tap(tap[j], h);
#pragma unroll
          for (int dt = 0; dt < WT; ++dt)
            if (th == dt) acc[dt][L * j + h] += g[L * j + h];
        }
      // dx rows no later window covers: this window's first ST, and after
      // the last window the rest of the tile; then the rows move up by ST
      const int ts = (o0 + w) * ST - PT;
#pragma unroll
      for (int i = 0; i < WT; ++i) {
        const int r = ts + i;
        if ((i < ST || w + 1 == nw) && r >= t0 && r < t1) {
          uint4 out;
          uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
          for (int j = 0; j < 4; ++j) o[j] = E::pack(acc[i] + L * j);
          *reinterpret_cast<uint4*>(dxq + r * xrow) = out;
        }
      }
#pragma unroll
      for (int i = 0; i < WT; ++i)
#pragma unroll
        for (int k = 0; k < K; ++k) acc[i][k] = i + ST < WT ? acc[i + ST][k] : 0.f;
    }
  }
}

// The shared bytes of a K11 block of `threads` threads (as bwd_plan counts
// them), V 16-byte vectors a (t, f).
template <int V, int WT, int WF, int ST, int SF, int PT, int PF>
int bwd_smem(int threads) {
  return ((ring_rows<WT, ST>() + 4) * threads + 2 * PF * V) * 16;
}

template <class E, int C, int WT, int WF, int ST, int SF, int PT, int PF>
int launch_bwd(const void* x, const void* dy, void* dx, int B, int T, int F, int To, int Fo,
               int rows, int cols, int threads, cudaStream_t s) {
  auto kernel = pool_bwd_kernel<E, C, WT, WF, ST, SF, PT, PF>;
  const int smem = bwd_smem<C / E::kPerVec, WT, WF, ST, SF, PT, PF>(threads);
  static int smem_set = 48 * 1024;  // the default limit; raised once per instantiation
  if (smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const dim3 grid(ceil_div(T, rows), ceil_div(F, cols), B);
  kernel<<<grid, threads, smem, s>>>(static_cast<const typename E::T*>(x),
                                     static_cast<const typename E::T*>(dy),
                                     static_cast<typename E::T*>(dx), T, F, To, Fo, rows, cols);
  return (int)cudaGetLastError();
}

// The tiling arguments both entry points check: blocks a grid can hold,
// threads within the launch bounds.
bool tiling_ok(int B, int T, int F, int rows, int cols, int threads) {
  return rows >= 1 && cols >= 1 && threads >= 1 && threads <= kPoolMaxThreads && B >= 1 &&
         T >= 1 && F >= 1 && B <= 65535 && ceil_div(F, cols) <= 65535;
}

}  // namespace

#define POOL_MATCH(CC, WT, WF, ST, SF, PT, PF) \
  (C == CC && wt == WT && wf == WF && st == ST && sf == SF && pt == PT && pf == PF)

// K10: out (B, To, Fo, C) of x (B, T, F, C), one launch, bf16 or (f32 != 0)
// float32.  rows / cols / threads: the tiling of `ops.max_pool.fwd_plan`
// (output rows a tile, output columns a block, threads a block: at least
// the block's staged column vectors, at most 256).  The encoder's three
// pools at C = 16 or 32; any other geometry returns cudaErrorInvalidValue.
CT_EXPORT int max_pool_forward(const void* x, void* out, int B, int T, int F, int C, int To,
                               int Fo, int wt, int wf, int st, int sf, int pt, int pf, int rows,
                               int cols, int threads, int f32, void* stream) {
  if (!tiling_ok(B, T, F, rows, cols, threads)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K10_POOL(CC, WT, WF, ST, SF, PT, PF)                                                  \
  if (POOL_MATCH(CC, WT, WF, ST, SF, PT, PF))                                                \
    return f32 ? launch_fwd<F32Elems, CC, WT, WF, ST, SF, PT, PF>(x, out, B, T, F, To, Fo,    \
                                                                  rows, cols, threads, s)     \
               : launch_fwd<Bf16Elems, CC, WT, WF, ST, SF, PT, PF>(x, out, B, T, F, To, Fo,   \
                                                                   rows, cols, threads, s);
  POOL_INSTANCES(K10_POOL)
#undef K10_POOL
  return (int)cudaErrorInvalidValue;
}

// K10's tiling as its launch with these arguments (f32: the float32 mode)
// runs it, from the kernel's own span formula: out[0..3] = blocks, dynamic shared bytes a
// block, row tiles R, column chunks Q; then (lo, hi, x0, x1) of each row
// tile and of each column chunk (`fwd_span`).  `cap` ints at most;
// cudaErrorInvalidValue where max_pool_forward would refuse the launch.
CT_EXPORT int max_pool_fwd_plan(int B, int T, int F, int C, int To, int Fo, int wt, int wf, int st,
                                int sf, int pt, int pf, int rows, int cols, int threads, int f32,
                                int* out, int cap) {
  if (!tiling_ok(B, T, F, rows, cols, threads)) return (int)cudaErrorInvalidValue;
  int smem = -1;
#define K10_PLAN(CC, WT, WF, ST, SF, PT, PF)                                      \
  if (POOL_MATCH(CC, WT, WF, ST, SF, PT, PF) &&                                   \
      (f32 ? fwd_threads_ok<CC / 4, WT, WF, ST, SF, PT, PF>(F, cols, threads)     \
           : fwd_threads_ok<CC / 8, WT, WF, ST, SF, PT, PF>(F, cols, threads)))   \
    smem = f32 ? fwd_smem<CC / 4, WT, WF, ST, SF, PT, PF>(threads)                \
               : fwd_smem<CC / 8, WT, WF, ST, SF, PT, PF>(threads);
  POOL_INSTANCES(K10_PLAN)
#undef K10_PLAN
  const int R = ceil_div(To, rows), Q = ceil_div(Fo, cols);
  if (smem < 0 || cap < 4 + 4 * (R + Q)) return (int)cudaErrorInvalidValue;
  out[0] = B * R * Q;
  out[1] = smem;
  out[2] = R;
  out[3] = Q;
  int* o = out + 4;
  for (int i = 0; i < R + Q; ++i, o += 4) {
    const Span sp = i < R ? fwd_span(i, rows, T, To, wt, st, pt)
                          : fwd_span(i - R, cols, F, Fo, wf, sf, pf);
    o[0] = sp.lo;
    o[1] = sp.hi;
    o[2] = sp.x0;
    o[3] = sp.x1;
  }
  return 0;
}

// K11: dx (B, T, F, C) of the pool for dy (B, To, Fo, C), one launch, bf16
// or (f32 != 0) float32.  rows / cols / threads: the tiling of
// `ops.max_pool.bwd_plan` (input rows a tile, owned columns a block, threads
// a block: at least the block's staged column vectors and windows, at most
// 256).  The encoder's three pools at C = 16 or 32; any other geometry
// returns cudaErrorInvalidValue.
CT_EXPORT int max_pool_backward(const void* x, const void* dy, void* dx, int B, int T, int F,
                                int C, int To, int Fo, int wt, int wf, int st, int sf, int pt,
                                int pf, int rows, int cols, int threads, int f32, void* stream) {
  if (!tiling_ok(B, T, F, rows, cols, threads)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K11_POOL(CC, WT, WF, ST, SF, PT, PF)                                                  \
  if (POOL_MATCH(CC, WT, WF, ST, SF, PT, PF))                                                \
    return f32 ? launch_bwd<F32Elems, CC, WT, WF, ST, SF, PT, PF>(x, dy, dx, B, T, F, To, Fo, \
                                                                  rows, cols, threads, s)     \
               : launch_bwd<Bf16Elems, CC, WT, WF, ST, SF, PT, PF>(x, dy, dx, B, T, F, To,    \
                                                                   Fo, rows, cols, threads, s);
  POOL_INSTANCES(K11_POOL)
#undef K11_POOL
  return (int)cudaErrorInvalidValue;
}

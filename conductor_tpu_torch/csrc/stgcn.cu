// K7: the frozen ST-GCN of the perceptual loss, forward and d(input)
// backward.
//
// Replaces conductor_tpu/ops/pallas_stgcn.py::fused_frozen_stgcn (forward
// `_stgcn_fwd_kernel`, pallas_call at :252; backward `_stgcn_bwd_kernel`,
// pallas_call at :280).  Weights as ops/stgcn.py::pack_frozen_stgcn packs
// them (bf16 matrices, float32 biases); activations are rows of one frame,
// 13 joints x 32 channels = 416 values, joint-major.  Per block i:
//   g = relu(bf16(h) M_i + b1_i)                           (graph conv + BN)
//   h' = relu(sum_k bf16(g[t + k - 1]) W_ik + b2_i (+ h))   (3-tap conv + BN,
//        per joint, zero rows past the clip's edges; residual after block 0)
// then out = bf16(h_10) FC + fcb.  The backward walks the blocks in reverse:
//   dy = dh' * [h' > 0];  da = (sum_k bf16(dy[t + 1 - k]) W_ik^T) * [g > 0];
//   dh = bf16(da) M_i^T (+ dy after block 0);  dx = bf16(da_0) M_0^T.
// The roundings are the JAX kernel's `_md`: bf16 operands, float32
// accumulation, float32 bias / ReLU / residual.  The clip's edges are the
// module's zero padding: the JAX kernel, which pads T to a multiple of 8,
// lets its pad rows' relu(b1) into the last frame; here no pad row exists.
//
// What bounds it on an H100.  Per frame the forward is ~3.9 MFLOP (nine
// dense 416 x 416 graph-conv products, 0.35 MFLOP each, ten temporal convs,
// 0.08 each), the backward about the same; at B = 32, T = 900 that is ~110
// GFLOP each way, 0.1 ms at the bf16 tensor rate.  Each block moves ~4.2 KB
// a frame through device memory each way (h in float32, g in bf16, the
// residual), ~120 MB a block at that batch, ~40 us at 3.35 TB/s.  So memory
// and latency bound it, not the tensor cores.
//
// Design: two launches a block and direction, through device memory.  A row
// pass (64-row tiles over all B*T frames: the graph conv, the projection and
// their transposes; the bf16 operand tile in shared memory, B fragments from
// L2, WMMA as layer::block_gemm does) and a temporal pass (64 rows of one
// clip and a row of halo on each side in shared memory, zero past the clip's
// edges, so no pad row can leak into a real one; the 3 x 32 x 32 taps in
// shared memory; per joint, three shifted 16-row fragments against the
// taps).  Both move rows 16 bytes a thread and run their epilogue from each
// warp's own 16 x 16 staging patch, with no float32 tile, so two row passes
// or three temporal passes share an SM.  The TPU kernel keeps the whole clip
// in VMEM and recomputes the forward in the backward; here the forward, when
// asked (`save`), keeps every block's h (float32) and g (bf16) in device
// memory (~0.7 GB at B = 32, T = 900) and the backward reads their signs for
// the ReLU masks.  The TPU's layout devices (joints padded 13 -> 16, the
// temporal conv as kron(eye(4), W) 128-lane blocks) are not carried over.
// Plain WMMA (16x16x16 bf16, float32 accumulation); no wgmma / TMA.

#include "layer_common.cuh"

namespace {

using namespace nvcuda;

constexpr int V = 13, C = 32, W = V * C;  // joints, channels, values a frame
constexpr int kBlocks = 10, kOut = 64, kIn = V * 2, kInPad = 32;
constexpr int kRows = layer::kTileRows;   // 64 frames a block
constexpr int kThreads = 256;             // 8 warps
constexpr int kHalo = kRows + 2;
constexpr int kLdHalo = W + 16;  // bf16; a tap's fragments start on any row: 32-byte rows
constexpr int kPatch = 16 * 16;  // floats of a warp's staging patch

// Eight consecutive values (16-byte aligned) as float, and back.
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(q[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// One accumulator fragment through the warp's patch: lane l gets row l / 2,
// columns 8 (l % 2) .. +8 of it.
__device__ __forceinline__ void unstage(const layer::FragC& acc, float* patch, float v[8]) {
  const int lane = threadIdx.x & 31;
  wmma::store_matrix_sync(patch, acc, 16, wmma::mem_row_major);
  __syncwarp();
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = patch[(lane >> 1) * 16 + (lane & 1) * 8 + e];
  __syncwarp();
}

// out[r, :ldo] = epilogue(bf16(a[r, :K]) @ op(b)) over rows [0, rows).
struct RowsArgs {
  const void* a;
  int lda, a_bf16;              // lda values a row (zero-padded to K), float32 or bf16
  const bf16* b;
  int ldb;
  const float* bias;            // per output column, or nullptr
  int relu;
  const float* res;             // out += res where res_gate > 0 (rows of W), or nullptr
  const float* res_gate;
  void* out;
  int ldo, out_bf16;            // the first ldo columns, float32 or bf16
  int rows;
};

template <int K>
constexpr size_t rows_smem() {
  return (size_t)kRows * (K + 8) * sizeof(bf16) + (size_t)(kThreads / 32) * kPatch * sizeof(float);
}

// The warps share the 64 x N output as jobs of 32 columns by 16 * MI rows
// (layer::block_gemm_jobs), each job's fragments leaving through the
// warp's patch.
template <int K, int N, bool kTransB>
__global__ void __launch_bounds__(kThreads, 2) rows_kernel(RowsArgs p) {
  constexpr int kLdA = K + 8, MI = N >= 256 ? 4 : 2, kGroups = kRows / (16 * MI);
  using LayoutB = typename std::conditional<kTransB, wmma::col_major, wmma::row_major>::type;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> FragB;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);
  float* patch = reinterpret_cast<float*>(smem + (size_t)kRows * kLdA * sizeof(bf16)) +
                 (threadIdx.x >> 5) * kPatch;
  const int r0 = blockIdx.x * kRows, lane = threadIdx.x & 31;
  if (p.lda == K) {  // whole rows, eight values a thread at a time
    for (int i = threadIdx.x; i < kRows * K / 8; i += kThreads) {
      const int r = i / (K / 8), c = i % (K / 8) * 8, row = r0 + r;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (row < p.rows) {
        const size_t at = (size_t)row * K + c;
        if (p.a_bf16)
          load8(static_cast<const bf16*>(p.a) + at, v);
        else
          load8(static_cast<const float*>(p.a) + at, v);
      }
      store8(as + r * kLdA + c, v);
    }
  } else {  // block 0's 26 motion values a frame
    for (int i = threadIdx.x; i < kRows * K; i += kThreads) {
      const int r = i / K, c = i % K, row = r0 + r;
      const float v = row < p.rows && c < p.lda
                          ? static_cast<const float*>(p.a)[(size_t)row * p.lda + c] : 0.f;
      as[r * kLdA + c] = __float2bfloat16(v);
    }
  }
  __syncthreads();

  auto bp = [&](int k, int n) {
    return kTransB ? p.b + (size_t)n * p.ldb + k : p.b + (size_t)k * p.ldb + n;
  };
  for (int job = threadIdx.x >> 5; job < kGroups * (N / 32); job += kThreads / 32) {
    const int rj = (job % kGroups) * 16 * MI, n0 = (job / kGroups) * 32;
    layer::FragC acc[MI][2];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      wmma::fill_fragment(acc[i][0], 0.f);
      wmma::fill_fragment(acc[i][1], 0.f);
    }
    FragB b[layer::kPrefetch][2];
#pragma unroll
    for (int s = 0; s < layer::kPrefetch; ++s)
      if (s * 16 < K) {
        wmma::load_matrix_sync(b[s][0], bp(s * 16, n0), p.ldb);
        wmma::load_matrix_sync(b[s][1], bp(s * 16, n0 + 16), p.ldb);
      }
    for (int k0 = 0; k0 < K; k0 += 16 * layer::kPrefetch) {
#pragma unroll
      for (int s = 0; s < layer::kPrefetch; ++s) {
        const int k = k0 + 16 * s;
        if (k < K) {
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            layer::FragA a;
            wmma::load_matrix_sync(a, as + (rj + i * 16) * kLdA + k, kLdA);
            wmma::mma_sync(acc[i][0], a, b[s][0], acc[i][0]);
            wmma::mma_sync(acc[i][1], a, b[s][1], acc[i][1]);
          }
          const int kn = k + 16 * layer::kPrefetch;
          if (kn < K) {
            wmma::load_matrix_sync(b[s][0], bp(kn, n0), p.ldb);
            wmma::load_matrix_sync(b[s][1], bp(kn, n0 + 16), p.ldb);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v[8];
        unstage(acc[i][j], patch, v);
        const int row = r0 + rj + 16 * i + (lane >> 1), c = n0 + 16 * j + (lane & 1) * 8;
        if (row >= p.rows || c >= p.ldo) continue;
        if (p.bias) {
          float bias[8];
          load8(p.bias + c, bias);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += bias[e];
        }
        if (p.relu)
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], 0.f);
        if (p.res) {
          const size_t at = (size_t)row * W + c;
          float res[8], gate[8];
          load8(p.res + at, res);
          load8(p.res_gate + at, gate);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += gate[e] > 0.f ? res[e] : 0.f;
        }
        const size_t o = (size_t)row * p.ldo + c;
        if (p.ldo % 8) {  // dx: 26 values a frame
          for (int e = 0; e < 8 && c + e < p.ldo; ++e) static_cast<float*>(p.out)[o + e] = v[e];
        } else if (p.out_bf16) {
          store8(static_cast<bf16*>(p.out) + o, v);
        } else {
          store8(static_cast<float*>(p.out) + o, v);
        }
      }
  }
}

// The temporal pass over rows [t0, t0 + 64) of one clip.
struct TconvArgs {
  const void* in;        // forward: g (bf16); backward: dh (float32), zero where in_gate <= 0
  const float* in_gate;
  const bf16* w;         // this block's taps (3, C, C): (tap, in, out)
  const float* bias;     // forward: (C,)
  const float* res;      // forward: the block's input, added before the ReLU, or nullptr
  const bf16* out_gate;  // backward: g; da is zero where g <= 0
  void* out;             // forward: h (float32); backward: da (bf16)
  int T;
};

constexpr size_t kTconvSmem = (size_t)kHalo * kLdHalo * sizeof(bf16) + 3 * C * C * sizeof(bf16) +
                              (size_t)(kThreads / 32) * kPatch * sizeof(float);

template <bool kBwd>
__global__ void __launch_bounds__(kThreads, 3) tconv_kernel(TconvArgs p) {
  using LayoutB = typename std::conditional<kBwd, wmma::col_major, wmma::row_major>::type;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> FragB;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);  // row j holds clip row t0 - 1 + j
  bf16* ws = hs + kHalo * kLdHalo;
  float* patch = reinterpret_cast<float*>(ws + 3 * C * C) + (threadIdx.x >> 5) * kPatch;
  const int t0 = blockIdx.x * kRows, lane = threadIdx.x & 31;
  const size_t base = (size_t)blockIdx.y * p.T;  // this clip's first row
  for (int i = threadIdx.x; i < kHalo * W / 8; i += kThreads) {
    const int j = i / (W / 8), c = i % (W / 8) * 8, t = t0 - 1 + j;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (t >= 0 && t < p.T) {
      const size_t at = (base + t) * W + c;
      if (kBwd) {
        float gate[8];
        load8(static_cast<const float*>(p.in) + at, v);
        load8(p.in_gate + at, gate);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = gate[e] > 0.f ? v[e] : 0.f;
      } else {
        load8(static_cast<const bf16*>(p.in) + at, v);
      }
    }
    store8(hs + j * kLdHalo + c, v);
  }
  for (int i = threadIdx.x; i < 3 * C * C / 8; i += kThreads)
    reinterpret_cast<uint4*>(ws)[i] = reinterpret_cast<const uint4*>(p.w)[i];
  __syncthreads();

  // 4 row blocks x 26 column fragments (joint n / 2, half n % 2); each warp
  // one row block and every other fragment.  Forward: out row t reads
  // tap k at t + k - 1 (tile row 16 rb + k for the fragment's first row) with
  // W_k; backward: t + 1 - k (tile row 16 rb + 2 - k) with W_k^T, which is
  // the (in, out) taps read column-major.
  const int warp = threadIdx.x >> 5, rb = warp & 3;
  for (int n = warp >> 2; n < 2 * V; n += kThreads / 32 / 4) {
    const int v = n >> 1, half = n & 1;
    layer::FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const bf16* arow = hs + (16 * rb + (kBwd ? 2 - k : k)) * kLdHalo + v * C;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        layer::FragA a;
        FragB b;
        wmma::load_matrix_sync(a, arow + kk * 16, kLdHalo);
        wmma::load_matrix_sync(
            b, ws + k * C * C + (kBwd ? half * 16 * C + kk * 16 : kk * 16 * C + half * 16), C);
        wmma::mma_sync(acc, a, b, acc);
      }
    }
    float y[8];
    unstage(acc, patch, y);
    const int t = t0 + 16 * rb + (lane >> 1), c = n * 16 + (lane & 1) * 8;
    if (t >= p.T) continue;
    const size_t at = (base + t) * W + c;
    if (kBwd) {
      float gate[8];
      load8(p.out_gate + at, gate);
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = gate[e] > 0.f ? y[e] : 0.f;
      store8(static_cast<bf16*>(p.out) + at, y);
    } else {
      float bias[8], res[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      load8(p.bias + c % C, bias);
      if (p.res) load8(p.res + at, res);
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = fmaxf(y[e] + bias[e] + res[e], 0.f);
      store8(static_cast<float*>(p.out) + at, y);
    }
  }
}

template <int K, int N, bool kTransB>
cudaError_t launch_rows(const RowsArgs& p, cudaStream_t stream) {
  constexpr size_t smem = rows_smem<K>();
  static const cudaError_t set = cudaFuncSetAttribute(
      rows_kernel<K, N, kTransB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) return set;
  rows_kernel<K, N, kTransB><<<ceil_div(p.rows, kRows), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kBwd>
cudaError_t launch_tconv(const TconvArgs& p, int B, cudaStream_t stream) {
  static const cudaError_t set = cudaFuncSetAttribute(
      tconv_kernel<kBwd>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTconvSmem);
  if (set != cudaSuccess) return set;
  tconv_kernel<kBwd><<<dim3(ceil_div(p.T, kRows), B), kThreads, kTconvSmem, stream>>>(p);
  return cudaGetLastError();
}

#define CT_TRY(expr)                          \
  do {                                        \
    const cudaError_t err_ = (expr);          \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

}  // namespace

// x (B*T, 26) float32 -> out (B*T, 64) float32.  hbuf holds each block's
// output h (float32, B*T x 416 a slab), gbuf its g (bf16): all ten of each
// with `save`, else two h slabs used in turn and one g slab.
CT_EXPORT int stgcn_forward(const void* x, const void* m0, const void* m, const void* wt,
                            const void* b1, const void* b2, const void* fc, const void* fcb,
                            void* hbuf, void* gbuf, void* out, int B, int T, int save,
                            void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int rows = B * T;
  const size_t slab = (size_t)rows * W;
  auto h = [&](int i) { return static_cast<float*>(hbuf) + (save ? i : i % 2) * slab; };
  auto g = [&](int i) { return static_cast<bf16*>(gbuf) + (save ? i : 0) * slab; };
  const bf16* mats = static_cast<const bf16*>(m);
  for (int i = 0; i < kBlocks; ++i) {
    RowsArgs gcn{i == 0 ? x : h(i - 1), i == 0 ? kIn : W, 0,
                 i == 0 ? static_cast<const bf16*>(m0) : mats + (size_t)(i - 1) * W * W, W,
                 static_cast<const float*>(b1) + i * W, 1, nullptr, nullptr,
                 g(i), W, 1, rows};
    CT_TRY((i == 0 ? launch_rows<kInPad, W, false>(gcn, s) : launch_rows<W, W, false>(gcn, s)));
    TconvArgs tc{g(i), nullptr, static_cast<const bf16*>(wt) + i * 3 * C * C,
                 static_cast<const float*>(b2) + i * C, i == 0 ? nullptr : h(i - 1), nullptr,
                 h(i), T};
    CT_TRY(launch_tconv<false>(tc, B, s));
  }
  RowsArgs proj{h(kBlocks - 1), W, 0, static_cast<const bf16*>(fc), kOut,
                static_cast<const float*>(fcb), 0, nullptr, nullptr, out, kOut, 0, rows};
  CT_TRY((launch_rows<W, kOut, false>(proj, s)));
  return 0;
}

// dy (B*T, 64) float32 and the forward's saved hbuf / gbuf (ten slabs each)
// -> dx (B*T, 26) float32.  dh: two float32 slabs used in turn; da: one
// bf16 slab.
CT_EXPORT int stgcn_backward(const void* dy, const void* m0, const void* m, const void* wt,
                             const void* fc, const void* hbuf, const void* gbuf, void* dh,
                             void* da, void* dx, int B, int T, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int rows = B * T;
  const size_t slab = (size_t)rows * W;
  auto h = [&](int i) { return static_cast<const float*>(hbuf) + i * slab; };
  auto g = [&](int i) { return static_cast<const bf16*>(gbuf) + i * slab; };
  auto d = [&](int j) { return static_cast<float*>(dh) + j * slab; };
  const bf16* mats = static_cast<const bf16*>(m);
  RowsArgs proj{dy, kOut, 0, static_cast<const bf16*>(fc), kOut, nullptr, 0, nullptr, nullptr,
                d(0), W, 0, rows};
  CT_TRY((launch_rows<kOut, W, true>(proj, s)));
  int cur = 0;
  for (int i = kBlocks - 1; i >= 0; --i) {
    TconvArgs tc{d(cur), h(i), static_cast<const bf16*>(wt) + i * 3 * C * C, nullptr, nullptr,
                 g(i), da, T};
    CT_TRY(launch_tconv<true>(tc, B, s));
    if (i > 0) {
      RowsArgs gcn{da, W, 1, mats + (size_t)(i - 1) * W * W, W, nullptr, 0, d(cur), h(i),
                   d(1 - cur), W, 0, rows};
      CT_TRY((launch_rows<W, W, true>(gcn, s)));
      cur ^= 1;
    } else {
      RowsArgs gcn{da, W, 1, static_cast<const bf16*>(m0), W, nullptr, 0, nullptr, nullptr,
                   dx, kIn, 0, rows};
      CT_TRY((launch_rows<W, kInPad, true>(gcn, s)));
    }
  }
  return 0;
}

// K8: the standalone linear self-attention, forward.
//
// Replaces conductor_tpu/ops/pallas_attention.py::fused_linear_attention
// (`_attention_kernel` :45-76, pallas_call at :99).  Per clip and head h,
// over the head's Dh columns of D = Dh * H (Dh = 8, 16, 32 or 64, a
// template parameter; 16 at the flagship's D = 128 with 8 heads): q_sm =
// softmax of q over the head's Dh features, k_sm = softmax of k over time,
// KV = k_sm^T v (Dh x Dh), y = q_sm KV; float32 inside, y in q's dtype.  The JAX
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
// What bounds it on an H100, by its function: bytes.  A row of one head
// costs 2 * 2 * 16 * 16 = 1024 FLOPs of float32 FMAs (its KV partial and
// its y) against 4 * 16 values read or written, 8-12 FLOPs a byte, below
// the float32 CUDA cores' ~20 (67 TFLOP/s over 3.35 TB/s).  At the serving shape a call moves only
// 3.7-5.5 MB, so latency rules: the design is ONE launch, with nothing in
// global memory but q, k, v and y.  A thread-block cluster of S blocks
// owns one (clip, head), over a grid of (S, H, B); rank s owns k / v rows
// [s ceil(Tk / S), ...) and, apart, q rows [s ceil(Tq / S), ...).  The
// caller picks S in {2, 8} (`ops.attention.cluster_size`: 8 where that
// grid fits one wave of resident blocks, else 2): at the serving shape
// (B H = 16) S = 8 spreads a clip over 128 SMs, while at the mask step's
// (B H = 256) S = 2 fills the card and the combine stays small.
// A block first stages its first kThreads q rows of the head with 16-byte
// cp.async, to be read after the combine, then:
//   1 partials: the block stages its k and v rows of the head with 16-byte
//     cp.async, kChunk rows at a time, in the dtype handed over.  Thread
//     (p, i) owns column i over the rows p, p + kStrips, ... of each chunk
//     (a strip): its running maximum m, the sum s of exp(k - m) and the row
//     exp(k - m) v (16 values), rescaled by exp(m_old - m_new) when a
//     chunk raises m.  Then the strips are combined in strip order into
//     the block's partial (per column m, s, and the 16 x 16 exp(k - m)^T v)
//     in shared memory.  float32 throughout, no tensor-core rounding.
//   2 combine: cluster barrier; every block reads the cluster's partials
//     from distributed shared memory in rank order, rescales each by
//     exp(m_s - max m) (a rank without rows has m = -inf and weight 0) and
//     forms KV = sum / s, so every block holds bit-identical KV.
//   3 rows: one thread a q row of the block's range (the staged ones from
//     shared memory, any further by 16-byte loads), the per-head softmax in
//     registers, y = q_sm KV with KV read from shared memory as
//     broadcasts, y stored in q's dtype with 16-byte stores.  A last
//     cluster barrier keeps each block's partial alive while its peers
//     read it.
// Every sum runs in a fixed order and there are no atomics: a repeat is
// bit-identical.  The launch bounds hold a thread to 64 registers, so that
// kMinBlocks blocks share an SM and hide each other's latency; the KV rows
// of phase 3 are read by loads the compiler may not hoist out of the row
// loop (it would keep all 256 values live and spill).  On the card the
// serving shape is bound by the latency of that chain and the mask step's
// by instruction throughput, so the exponentials run on the SFU and a q
// row's softmax takes one reciprocal, not 16 divisions.  `__expf(x)` is
// within 2 + floor(|1.173 x|) ulp of exp(x) (CUDA's programming guide), so
// its relative error grows with |x|: ~1.7e-6 at x = -10, where the weight
// is already e^-10 of the largest; every argument here is x - max <= 0.
// The output, in q's dtype, rounds far coarser for bf16 q
// (scripts/k8_variants.py measures the tuning constants, and the accurate
// `expf` with divisions beside this version's error).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // thread (p, i) = (tid / Dh, tid % Dh) in phase 1
// Blocks an SM the launch bounds ask for at head width Dh (ops/attention.py
// BLOCKS_PER_SM): 4 up to Dh = 16 (64 registers a thread), 2 at 32, 1 at
// 64, where a thread keeps a Dh-wide row of sums and one of q.
template <int kDh>
constexpr int kMinBlocks = kDh <= 16 ? 4 : kDh == 32 ? 2 : 1;
template <int kDh>
constexpr int kStrips = kThreads / kDh;  // row strips of a chunk
template <int kDh>
constexpr int kChunk = 4096 / kDh;       // k / v rows staged at once (256 at Dh = 16)

// Dynamic shared bytes: a chunk's k and v rows (after the last chunk, the
// strips' partials), then the staged q rows.
template <int kDh, typename KT>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * kChunk<kDh> * kDh * (int)sizeof(KT) > kStrips<kDh> * kDh * (2 + kDh) * (int)sizeof(float)
             ? 2 * kChunk<kDh> * kDh * (int)sizeof(KT)
             : kStrips<kDh> * kDh * (2 + kDh) * (int)sizeof(float);
}
template <int kDh, typename QT, typename KT>
__host__ __device__ constexpr int smem_bytes() {
  return stage_bytes<kDh, KT>() + kThreads * kDh * (int)sizeof(QT);
}

// A block's partial over its k / v rows: per column its max m and sum s of
// exp(k - m), and the Dh x Dh sum of exp(k - m)^T v.
template <int kDh>
struct Partial {
  float m[kDh];
  float s[kDh];
  float kv[kDh * kDh];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ float scalar(const float* p) { return *p; }
__device__ __forceinline__ float scalar(const bf16* p) { return __bfloat162float(*p); }

// Dh consecutive values (16-byte aligned) as float32, by 16-byte loads
template <int kDh>
__device__ __forceinline__ void load_row(const float* p, float (&o)[kDh]) {
#pragma unroll
  for (int i = 0; i < kDh / 4; ++i) {
    const float4 f = reinterpret_cast<const float4*>(p)[i];
    o[4 * i] = f.x;
    o[4 * i + 1] = f.y;
    o[4 * i + 2] = f.z;
    o[4 * i + 3] = f.w;
  }
}
template <int kDh>
__device__ __forceinline__ void load_row(const bf16* p, float (&o)[kDh]) {
#pragma unroll
  for (int i = 0; i < kDh / 8; ++i) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[i];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      o[8 * i + 2 * j] = f.x;
      o[8 * i + 2 * j + 1] = f.y;
    }
  }
}

// Dh values to Dh consecutive outputs (16-byte aligned), by 16-byte stores
template <int kDh>
__device__ __forceinline__ void store_row(float* p, const float (&y)[kDh]) {
#pragma unroll
  for (int i = 0; i < kDh / 4; ++i)
    reinterpret_cast<float4*>(p)[i] = make_float4(y[4 * i], y[4 * i + 1], y[4 * i + 2], y[4 * i + 3]);
}
template <int kDh>
__device__ __forceinline__ void store_row(bf16* p, const float (&y)[kDh]) {
#pragma unroll
  for (int i = 0; i < kDh / 8; ++i) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(y[8 * i + 2 * j], y[8 * i + 2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    reinterpret_cast<uint4*>(p)[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// A KV row from shared memory, by 16-byte loads the compiler may not hoist:
// the row loop would otherwise keep all Dh^2 KV values live and spill.
template <int kDh>
__device__ __forceinline__ void kv_row(const float* p, float (&o)[kDh]) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
#pragma unroll
  for (int i = 0; i < kDh / 4; ++i)
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(o[4 * i]), "=f"(o[4 * i + 1]), "=f"(o[4 * i + 2]), "=f"(o[4 * i + 3])
                 : "r"(a + 16 * i)
                 : "memory");
}

// exp(m - M), or 0 for a partial without rows (m = -inf)
__device__ __forceinline__ float weight(float m, float M) {
  return m == -CUDART_INF_F ? 0.f : __expf(m - M);
}

// q (B, Tq, D), k and v (B, Tk, D), out like q; grid (S, H, B) in
// clusters of (S, 1, 1).
template <int kDh, typename QT, typename KT, int S>
__global__ void __launch_bounds__(kThreads, kMinBlocks<kDh>)
attention_kernel(const QT* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
                 QT* __restrict__ out, int Tq, int Tk, int H) {
  constexpr int kStrips = ::kStrips<kDh>;
  constexpr int kChunk = ::kChunk<kDh>;
  constexpr int kVec = 16 / sizeof(KT);   // values a 16-byte piece
  constexpr int kPieces = kDh / kVec;     // pieces a row of the head
  constexpr int kQVec = 16 / sizeof(QT);  // and of q
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage = smem;  // the chunk's k and v rows, then the strips' partials
  QT* q_s = reinterpret_cast<QT*>(smem + stage_bytes<kDh, KT>());  // [kThreads][kDh]
  __shared__ Partial<kDh> part;  // this block's, read by the whole cluster
  __shared__ __align__(16) float kv_s[kDh * kDh];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x, h = blockIdx.y, D = H * kDh;
  const size_t b = blockIdx.z;
  const int tid = threadIdx.x, p = tid / kDh, i = tid % kDh;

  // this rank's q rows [q0, q1); the first kThreads staged now, one a thread
  const int qper = (Tq + S - 1) / S;
  const int q0 = min(Tq, rank * qper), q1 = min(Tq, q0 + qper);
  const QT* qb = q + b * Tq * D + h * kDh;
  if (q0 + tid < q1) {
#pragma unroll
    for (int c = 0; c < kDh; c += kQVec) cp_async16(q_s + tid * kDh + c, qb + (q0 + tid) * D + c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // 1. partials over this rank's k / v rows [r0, r1)
  const int kper = (Tk + S - 1) / S;
  const int r0 = min(Tk, rank * kper), r1 = min(Tk, r0 + kper);
  const KT* kb = k + b * Tk * D + h * kDh;
  const KT* vb = v + b * Tk * D + h * kDh;
  KT* ks = reinterpret_cast<KT*>(stage);  // [kChunk][kDh]
  KT* vs = ks + kChunk * kDh;
  float m = -CUDART_INF_F, s = 0.f, acc[kDh];
#pragma unroll
  for (int j = 0; j < kDh; ++j) acc[j] = 0.f;
  for (int c0 = r0; c0 < r1; c0 += kChunk) {
    const int n = min(kChunk, r1 - c0);
    for (int e = tid; e < n * kPieces; e += kThreads) {
      const int r = e / kPieces, at = r * kDh + e % kPieces * kVec, g = (c0 + r) * D + at % kDh;
      cp_async16(ks + at, kb + g);
      cp_async16(vs + at, vb + g);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    float cm = -CUDART_INF_F;  // column i's maximum over the strip's rows of the chunk
    for (int r = p; r < n; r += kStrips) cm = fmaxf(cm, scalar(ks + r * kDh + i));
    if (cm > m) {
      const float sc = __expf(m - cm);
      s *= sc;
#pragma unroll
      for (int j = 0; j < kDh; ++j) acc[j] *= sc;
      m = cm;
    }
    for (int r = p; r < n; r += kStrips) {
      const float e = __expf(scalar(ks + r * kDh + i) - m);
      float vr[kDh];
      load_row(vs + r * kDh, vr);
      s += e;
#pragma unroll
      for (int j = 0; j < kDh; ++j) acc[j] = fmaf(e, vr[j], acc[j]);
    }
    __syncthreads();  // the chunk is read before the next one (or the scratch) lands
  }
  float* sm = reinterpret_cast<float*>(stage);  // [kStrips][kDh]
  float* ss = sm + kStrips * kDh;               // [kStrips][kDh]
  float* sa = ss + kStrips * kDh;               // [kStrips][kDh][kDh]
  sm[tid] = m;
  ss[tid] = s;
#pragma unroll
  for (int j = 0; j < kDh; j += 4)
    *reinterpret_cast<float4*>(sa + tid * kDh + j) = make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
  __syncthreads();
  // the strips in strip order, a thread an entry (ci, cj) of KV
  for (int e = tid; e < kDh * kDh; e += kThreads) {
    const int ci = e / kDh, cj = e % kDh;
    float M = -CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < kStrips; ++r) M = fmaxf(M, sm[r * kDh + ci]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int r = 0; r < kStrips; ++r) {
      const float w = weight(sm[r * kDh + ci], M);
      den = fmaf(ss[r * kDh + ci], w, den);
      num = fmaf(sa[(r * kDh + ci) * kDh + cj], w, num);
    }
    part.kv[e] = num;
    if (cj == 0) {
      part.m[ci] = M;
      part.s[ci] = den;
    }
  }

  // 2. combine the cluster's partials in rank order
  cluster.sync();
  for (int e = tid; e < kDh * kDh; e += kThreads) {
    const int ci = e / kDh;
    float mr[S], sr[S], ar[S];
#pragma unroll
    for (int r = 0; r < S; ++r) {
      const Partial<kDh>* peer = cluster.map_shared_rank(&part, r);
      mr[r] = peer->m[ci];
      sr[r] = peer->s[ci];
      ar[r] = peer->kv[e];
    }
    float M = -CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < S; ++r) M = fmaxf(M, mr[r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int r = 0; r < S; ++r) {
      const float w = weight(mr[r], M);
      den = fmaf(sr[r], w, den);
      num = fmaf(ar[r], w, num);
    }
    kv_s[e] = num / den;
  }
  __syncthreads();

  // 3. this rank's q rows: softmax within the head, y = q_sm KV
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // the staged q rows
  QT* ob = out + b * Tq * D + h * kDh;
  for (int r = q0 + tid; r < q1; r += kThreads) {
    float x[kDh];
    if (r < q0 + kThreads) load_row(q_s + tid * kDh, x);
    else load_row(qb + r * D, x);
    float mx = x[0];
#pragma unroll
    for (int d = 1; d < kDh; ++d) mx = fmaxf(mx, x[d]);
    float sum = 0.f;
#pragma unroll
    for (int d = 0; d < kDh; ++d) {
      x[d] = __expf(x[d] - mx);
      sum += x[d];
    }
    const float inv = 1.f / sum;
    float y[kDh];
#pragma unroll
    for (int j = 0; j < kDh; ++j) y[j] = 0.f;
#pragma unroll
    for (int d = 0; d < kDh; ++d) {
      float kvr[kDh];
      kv_row(kv_s + d * kDh, kvr);
      const float qs = x[d] * inv;
#pragma unroll
      for (int j = 0; j < kDh; ++j) y[j] = fmaf(qs, kvr[j], y[j]);
    }
    store_row(ob + r * D, y);
  }
  cluster.sync();  // the peers are done reading this block's partial
}

template <int kDh, typename QT, typename KT, int S>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Tq, int Tk, int H,
           cudaStream_t s) {
  auto kernel = attention_kernel<kDh, QT, KT, S>;
  constexpr int smem = smem_bytes<kDh, QT, KT>();
  static bool attribute_set = false;  // once per instantiation
  if (!attribute_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = S;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<const QT*>(q), static_cast<const KT*>(k),
                         static_cast<const KT*>(v), static_cast<QT*>(out), Tq, Tk, H);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int kDh, int S>
int launch_dtypes(const void* q, const void* k, const void* v, void* out, int B, int Tq, int Tk,
                  int H, int q_bf16, int kv_bf16, cudaStream_t s) {
  if (q_bf16)
    return kv_bf16 ? launch<kDh, bf16, bf16, S>(q, k, v, out, B, Tq, Tk, H, s)
                   : launch<kDh, bf16, float, S>(q, k, v, out, B, Tq, Tk, H, s);
  return kv_bf16 ? launch<kDh, float, bf16, S>(q, k, v, out, B, Tq, Tk, H, s)
                 : launch<kDh, float, float, S>(q, k, v, out, B, Tq, Tk, H, s);
}

template <int kDh>
int launch_cluster(const void* q, const void* k, const void* v, void* out, int B, int Tq, int Tk,
                   int H, int cluster, int q_bf16, int kv_bf16, cudaStream_t s) {
  switch (cluster) {
    case 2: return launch_dtypes<kDh, 2>(q, k, v, out, B, Tq, Tk, H, q_bf16, kv_bf16, s);
    case 8: return launch_dtypes<kDh, 8>(q, k, v, out, B, Tq, Tk, H, q_bf16, kv_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// {threads, dynamic shared bytes, static shared bytes, k / v rows a chunk,
// blocks an SM the launch bounds ask for} at head width Dh.
template <int kDh>
void plan_dh(int q_bf16, int kv_bf16, int* out) {
  out[0] = kThreads;
  out[1] = q_bf16 ? (kv_bf16 ? smem_bytes<kDh, bf16, bf16>() : smem_bytes<kDh, bf16, float>())
                  : (kv_bf16 ? smem_bytes<kDh, float, bf16>() : smem_bytes<kDh, float, float>());
  out[2] = (int)(sizeof(Partial<kDh>) + kDh * kDh * sizeof(float));
  out[3] = kChunk<kDh>;
  out[4] = kMinBlocks<kDh>;
}

}  // namespace

// The launch's shape at head width dh for its operand types: {threads,
// dynamic shared bytes, static shared bytes, k / v rows a chunk, blocks an
// SM}; -1 for a head width the kernel does not take (ops/attention.py
// `plan` computes the same).
CT_EXPORT int linear_attention_plan(int dh, int q_bf16, int kv_bf16, int* out) {
  switch (dh) {
    case 8: plan_dh<8>(q_bf16, kv_bf16, out); return 0;
    case 16: plan_dh<16>(q_bf16, kv_bf16, out); return 0;
    case 32: plan_dh<32>(q_bf16, kv_bf16, out); return 0;
    case 64: plan_dh<64>(q_bf16, kv_bf16, out); return 0;
    default: return -1;
  }
}

// q (B, Tq, dh H), k and v (B, Tk, dh H), row-major, each 16-byte aligned;
// out like q; dh 8, 16, 32 or 64; `cluster` blocks a (clip, head), 2 or 8.
// One launch.
CT_EXPORT int linear_attention_forward(const void* q, const void* k, const void* v, void* out,
                                       int B, int Tq, int Tk, int H, int dh, int cluster,
                                       int q_bf16, int kv_bf16, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 8: return launch_cluster<8>(q, k, v, out, B, Tq, Tk, H, cluster, q_bf16, kv_bf16, s);
    case 16: return launch_cluster<16>(q, k, v, out, B, Tq, Tk, H, cluster, q_bf16, kv_bf16, s);
    case 32: return launch_cluster<32>(q, k, v, out, B, Tq, Tk, H, cluster, q_bf16, kv_bf16, s);
    case 64: return launch_cluster<64>(q, k, v, out, B, Tq, Tk, H, cluster, q_bf16, kv_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

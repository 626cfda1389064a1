// The AdaLN modulation of K1 (and K5) as its own tensor-core GEMM.
//
// Each decoder layer modulates its three StylizationBlocks with
//   mod = emb_act (B T, E) @ W_adaln (E, 6D) + b_adaln          (float32 out)
// (JAX conductor_tpu/ops/pallas_layer.py:112-120, inside `_layer_body`).
// The TPU kernel computes it for a whole clip in one dot from VMEM; the
// port's first design recomputed it per 64-row tile inside the row pass,
// from weight fragments each warp read from L2.  `mod` does not depend on
// the residual stream, and emb_act is the same for all layers of a step,
// so here it is one GEMM for all layers before K1's first layer (one layer
// for K5), and the row passes read their rows.
//
// What bounds it on an H100: at B = 2, T = 1800 a layer is 2.8 GFLOP (2.9 us
// at the bf16 rate, 1.4 us at the int8 rate) and 15.5 MB (4.6 us at 3.35
// TB/s), most of it the float32 output (11 MB a layer at B = 2, 44 MB at
// B = 8).  So the output's bytes bound it, and the operands should not add
// a second stream: they stay bf16 or int8 from device memory to the MMA.
//
// Design: tiles of BM x BN outputs (BN = 128, or 64 where a layer's N is
// not a multiple of 128: N = 6D = 192 at D = 32), 4 warps (2 x 2), each a
// (BM / 2) x (BN / 2) block of float32 (int32) sums in registers; mma.sync m16n8k16 (bf16) or
// m16n8k32 (s8) on tiles that 16-byte cp.async brings into a 3-stage ring
// (128 bytes of K a row a stage, 64 bf16 or 128 int8), XOR-swizzled so that
// the fragment loads are conflict-free.  A fragments come by ldmatrix from
// emb's rows.  B tiles are W's own rows (k-major): bf16 fragments come by
// ldmatrix.trans; s8 has no transposing ldmatrix, so each thread loads
// 4 x 4 byte blocks (4 k rows x 4 columns) as words and transposes them in
// registers (byte permutes), and the n8 tiles take their columns strided
// by 4 (tile j of a 32-column group holds columns 4 g + j), which the
// epilogue undoes.  The epilogue stages the tile in shared memory, so that
// each warp stores whole 512-byte rows of the float32 output.  BM
// is 128 while 128-row tiles give every SM one, else 64 (a layer at B = 1,
// T = 1800 is 90 tiles of 128 rows against 132 SMs, 174 of 64).  Two
// designs that read emb or W from L2 fewer times, 128 x 256 tiles of 8
// warps and persistent blocks that keep a column tile's W in shared memory
// (one block of 8 warps an SM in bf16), were both slower on the card than
// this one, which runs two blocks of 4 warps an SM.  Rows past M arrive as
// zeros (cp.async with source size 0) and are never stored.  Sums run in a
// fixed order: a repeat is bit-identical.  `wgmma` is not used yet (see
// ROADMAP).
//
// K1's float32 mode (`md(emb, aw)` with mxu_dtype float32) takes float32
// emb and W: (B T, 512) @ (512, 6144) at B = 2 is 22.6 GFLOP, 0.34 ms at
// the card's 67 TFLOP/s outside the tensor cores, so there it is the
// operations that bound it, and TF32 would keep about three digits.  So
// `f32::adaln_gemm_f32_kernel` is a register-tiled FFMA GEMM: 128 x 128 tiles of 16
// warps, a thread 8 x 8 sums (two 4-row by two 4-column blocks, so that
// its operands are 16-byte vectors of shared memory), k-slices of 8 staged
// in shared memory (A transposed, so that a thread's 4 rows are one
// vector) and double-buffered through registers, each sum one FFMA chain
// over k in ascending order, the bias added at the end.

#include <type_traits>

#include "adaln_gemm.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps, 2 x 2 over the tile
constexpr int kKBytes = 128;   // bytes of K a row a stage: 64 bf16 or 128 int8
constexpr int kStages = 3;

// A stage's B tile: 64 (bf16) or 128 (int8) k rows of BN columns.
template <int BN>
constexpr int kBTile = 128 * BN;

// Byte offset of 16-byte chunk c of row r of the int8 B tile (CH = BN / 16
// chunks a row).  CH = 8: the chunk XORed with 2 ((r / 4) % 4), so that the
// words a warp reads at one k step (rows 4 t + i, t < 4, of 8 consecutive
// words) fall on 32 distinct banks.  CH = 4 (64-byte rows, whose rows 4 t
// + i all start on one half of the banks): XORed with 2 ((r / 4) % 2),
// two-way conflicts at most.
template <int CH>
__device__ __forceinline__ uint32_t swz_kn(int r, int c) {
  if constexpr (CH == 4) return (uint32_t)(r * 4 + (c ^ (((r >> 2) & 1) << 1))) * 16u;
  return (uint32_t)(r * 8 + (c ^ (((r >> 2) & 3) << 1))) * 16u;
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// w[i] holds bytes (i, 0 .. 3) of a 4 x 4 byte block; r[j] = bytes (0 .. 3, j).
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4], uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

// A BM x BN tile of out, by 2 x 2 warps, each (BM / 2) x (BN / 2).
template <bool kInt8, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
adaln_gemm_kernel(const unsigned char* __restrict__ A, const unsigned char* __restrict__ Bw,
                  const float* __restrict__ a_scale, const float* __restrict__ b_scale,
                  const float* __restrict__ bias, float* __restrict__ out, int ldo, int M, int K,
                  int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  typedef typename std::conditional<kInt8, int, float>::type Acc;
  constexpr int kEl = kInt8 ? 1 : 2;
  constexpr int kStage = BM * kKBytes + kBTile<BN>;
  constexpr int MI = BM / 32;   // m16 tiles of a warp's BM / 2 rows
  constexpr int NT = BN / 16;   // n8 tiles of a warp's BN / 2 columns
  constexpr int kLdC = BN + 4;  // row stride of the output tile staged in shared memory
  static_assert(BM * kLdC * 4 <= kStages * kStage, "the output tile fits in the ring");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int layer = col0 / N, n_in = col0 - layer * N;
  const size_t row_bytes = (size_t)K * kEl;
  // this tile's B: rows k of the layer's W, columns n_in .. n_in + BN - 1
  const unsigned char* b_src = Bw + ((size_t)layer * K * N + n_in) * kEl;
  const int nk = (int)(row_bytes / kKBytes);
  const uint32_t base = tc::smem_addr(smem);

  auto load = [&](int kt, int s) {
    const uint32_t as = base + s * kStage, bs = as + BM * kKBytes;
    for (int i = threadIdx.x; i < BM * 8; i += kThreads) {
      const int r = i >> 3, c = i & 7;
      const bool valid = row0 + r < M;
      tc::cp_async16(as + tc::swz<8>(r, c),
                     A + (valid ? (size_t)(row0 + r) * row_bytes + kt * kKBytes + c * 16 : 0),
                     valid);
    }
    if constexpr (kInt8) {  // 128 k rows of BN columns
      constexpr int CH = BN / 16;
      for (int i = threadIdx.x; i < 128 * CH; i += kThreads) {
        const int r = (unsigned)i / CH, c = (unsigned)i % CH;
        tc::cp_async16(bs + swz_kn<CH>(r, c), b_src + (size_t)(kt * 128 + r) * N + c * 16);
      }
    } else {  // 64 k rows of BN columns
      constexpr int CH = BN / 8;
      for (int i = threadIdx.x; i < 64 * CH; i += kThreads) {
        const int r = (unsigned)i / CH, c = (unsigned)i % CH;
        tc::cp_async16(bs + tc::swz<CH>(r, c), b_src + (size_t)(kt * 64 + r) * N * 2 + c * 16);
      }
    }
  };

  const int m0 = (warp & 1) * (BM / 2), n0 = (warp >> 1) * (BN / 2);
  Acc acc[MI][NT][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + kStages - 1 < nk) load(kt + kStages - 1, (kt + kStages - 1) % kStages);
    tc::cp_async_commit();
    tc::cp_async_wait<kStages - 1>();  // stage kt's group is complete
    __syncthreads();
    const uint32_t as = base + (kt % kStages) * kStage, bs = as + BM * kKBytes;
#pragma unroll
    for (int s = 0; s < 4; ++s) {  // 4 MMA k-steps of 32 bytes
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        tc::ldmatrix_x4(a[i], as + tc::swz<8>(m0 + 16 * i + (lane & 15), 2 * s + (lane >> 4)));
      if constexpr (kInt8) {
        // per 32-column group q: this thread's 4 x 4 byte blocks at k rows
        // 32 s + 4 t (b0) and + 16 (b1), columns 4 g .. 4 g + 3 of the group
        const int t = lane & 3, g = lane >> 2;
#pragma unroll
        for (int q = 0; q < BN / 64; ++q) {
          uint32_t b[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t w[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              w[i] = ld_shared_u32(bs + 4 * (g % 4) +
                                   swz_kn<BN / 16>(32 * s + 16 * h + 4 * t + i, (n0 + 32 * q) / 16 + g / 4));
            transpose4x4(w, b[h]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < MI; ++i) tc::mma_s8(acc[i][4 * q + j], a[i], b[0][j], b[1][j]);
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          uint32_t b[4];  // b0, b1 of n8 tile 2 jj, then of tile 2 jj + 1
          tc::ldmatrix_x4_trans(b, bs + tc::swz<BN / 8>(16 * s + (lane & 15),
                                                        (n0 + 16 * jj) / 8 + (lane >> 4)));
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            tc::mma_bf16(acc[i][2 * jj], a[i], b[0], b[1]);
            tc::mma_bf16(acc[i][2 * jj + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // stage kt consumed before it is refilled
  }
  tc::cp_async_wait<0>();

  // The tile, bias added (int8: dequantized), through shared memory (the
  // ring is free), so that each warp stores whole 512-byte rows.  C fragment
  // element e of n8 tile j: row lane / 4 + 8 (e / 2), column 8 j + 2 (lane %
  // 4) + e % 2; in int8, tile 4 q + j holds the columns 4 c + j of group q,
  // so element e of tiles 4 q .. 4 q + 3 are columns 32 q + 8 (lane % 4) +
  // 4 e .. + 3.
  float* cs = reinterpret_cast<float*>(smem);  // (BM, kLdC)
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + 16 * i + g + 8 * h;
      float* crow = cs + r * kLdC;
      if constexpr (kInt8) {
        const float sr = row0 + r < M ? a_scale[row0 + r] : 0.f;
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n0 + 32 * q + 8 * t + 4 * e;
            float v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              v[j] = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][4 * q + j][2 * h + e]),
                                         __fmul_rn(sr, b_scale[col0 + c + j])),
                               bias[col0 + c + j]);
            *reinterpret_cast<float4*>(crow + c) = make_float4(v[0], v[1], v[2], v[3]);
          }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = n0 + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(crow + c) = make_float2(
              acc[i][j][2 * h] + bias[col0 + c], acc[i][j][2 * h + 1] + bias[col0 + c + 1]);
        }
      }
    }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * (BN / 4); i += kThreads) {
    const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
    if (row0 + r < M)
      *reinterpret_cast<float4*>(out + (size_t)(row0 + r) * ldo + col0 + c) =
          *reinterpret_cast<const float4*>(cs + r * kLdC + c);
  }
}

namespace f32 {

constexpr int kBM = 128, kBK = 8, kThreads = 256;
constexpr int kLdA = kBM + 4;  // A tile rows (k) padded: the transposing stores hit distinct banks

// A kBM x BN tile of out (BN = 128, or 64 where N is not a multiple of 128):
// thread (ty, tx) = (t / 16, t % 16) owns rows 4 ty + i and 64 + 4 ty + i,
// columns 4 tx + j and, at BN = 128, 64 + 4 tx + j (i, j < 4).
template <int BN>
__global__ void __launch_bounds__(kThreads)
adaln_gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ Bw,
            const float* __restrict__ bias, float* __restrict__ out, int ldo, int M, int K,
            int N) {
  constexpr int NH = BN / 64;  // column halves a thread owns
  __shared__ __align__(16) float As[2][kBK][kLdA];
  __shared__ __align__(16) float Bs[2][kBK][BN];
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * kBM;
  const int layer = col0 / N, n_in = col0 - layer * N;
  // the loads: A row t / 2, k 4 (t % 2) .. + 3; B k row t / (BN / 4),
  // columns 4 (t % (BN / 4)) .. + 3, by the first kBK BN / 4 threads
  const int ar = t >> 1, ak = (t & 1) * 4, bk = t / (BN / 4), bn = (t % (BN / 4)) * 4;
  const bool b_ld = t < kBK * BN / 4;
  const bool a_ok = row0 + ar < M;  // rows past M are zeros and never stored
  const float* a_src = A + (size_t)(a_ok ? row0 + ar : 0) * K + ak;
  const float* b_src = Bw + (size_t)layer * K * N + n_in + (size_t)bk * N + bn;
  float4 ra, rb;
  auto fetch = [&](int k0) {
    ra = a_ok ? __ldg(reinterpret_cast<const float4*>(a_src + k0))
              : make_float4(0.f, 0.f, 0.f, 0.f);
    if (b_ld) rb = __ldg(reinterpret_cast<const float4*>(b_src + (size_t)k0 * N));
  };
  auto put_tile = [&](int s) {
    As[s][ak][ar] = ra.x;
    As[s][ak + 1][ar] = ra.y;
    As[s][ak + 2][ar] = ra.z;
    As[s][ak + 3][ar] = ra.w;
    if (b_ld) *reinterpret_cast<float4*>(&Bs[s][bk][bn]) = rb;
  };
  float acc[8][4 * NH];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NH; ++j) acc[i][j] = 0.f;
  fetch(0);
  put_tile(0);
  __syncthreads();
  const int nk = K / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * kBK);  // in flight while this slice multiplies
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[s][k][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[s][k][64 + 4 * ty]);
      float b[4 * NH];
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[s][k][64 * h + 4 * tx]);
        b[4 * h] = bv.x;
        b[4 * h + 1] = bv.y;
        b[4 * h + 2] = bv.z;
        b[4 * h + 3] = bv.w;
      }
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4 * NH; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was read in the slice before, which the last sync closed
    if (kt + 1 < nk) put_tile(s ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= M) continue;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int c = col0 + 64 * h + 4 * tx;
      const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + c));
      *reinterpret_cast<float4*>(out + (size_t)r * ldo + c) =
          make_float4(acc[i][4 * h] + bv.x, acc[i][4 * h + 1] + bv.y, acc[i][4 * h + 2] + bv.z,
                      acc[i][4 * h + 3] + bv.w);
    }
  }
}

cudaError_t launch(const float* emb, const float* w, const float* bias, float* out, int ldo,
                   int M, int E, int N, int L, int* launches, cudaStream_t s) {
  if (N % 128 == 0)
    adaln_gemm_f32_kernel<128><<<dim3(L * N / 128, ceil_div(M, kBM)), kThreads, 0, s>>>(
        emb, w, bias, out, ldo, M, E, N);
  else
    adaln_gemm_f32_kernel<64><<<dim3(L * N / 64, ceil_div(M, kBM)), kThreads, 0, s>>>(
        emb, w, bias, out, ldo, M, E, N);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return err;
}

}  // namespace f32

template <int BM, int BN>
constexpr int kSmem = kStages * (BM * kKBytes + kBTile<BN>);

template <bool kInt8, int BM, int BN>
cudaError_t launch(const void* emb, const void* w, const float* emb_scale, const float* w_scale,
                   const float* bias, float* out, int ldo, int M, int E, int N, int L,
                   int* launches, cudaStream_t s) {
  constexpr int smem = kSmem<BM, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      adaln_gemm_kernel<kInt8, BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  adaln_gemm_kernel<kInt8, BM, BN><<<dim3(L * N / BN, ceil_div(M, BM)), kThreads, smem, s>>>(
      static_cast<const unsigned char*>(emb), static_cast<const unsigned char*>(w), emb_scale,
      w_scale, bias, out, ldo, M, E, N);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return err;
}

// The tiling a launch picks: {BM, BN, threads, grid.x, grid.y, dynamic
// shared bytes (the float32 kernel's are static)}: 128-row tiles while they
// give every SM one (else 64; float32 always 128), 128-column tiles where N
// is a multiple of 128, else 64.
void plan_of(int M, int N, int L, int operands, int sms, int* out) {
  const int bn = N % 128 == 0 ? 128 : 64;
  int bm = 128;
  if (operands != kAdalnF32 && (long long)ceil_div(M, 128) * (L * N / bn) < sms) bm = 64;
  out[0] = bm;
  out[1] = bn;
  out[2] = operands == kAdalnF32 ? f32::kThreads : kThreads;
  out[3] = L * N / bn;
  out[4] = ceil_div(M, bm);
  out[5] = operands == kAdalnF32 ? 0 : kStages * (bm * kKBytes + 128 * bn);
}

}  // namespace

bool adaln_gemm_takes(int E, int N, int operands) {
  if (operands == kAdalnF32) return E > 0 && E % f32::kBK == 0 && N > 0 && N % 64 == 0;
  return E > 0 && E * (operands == kAdalnInt8 ? 1 : 2) % kKBytes == 0 && N > 0 && N % 64 == 0;
}

cudaError_t launch_adaln_gemm(const void* emb, const void* w, const float* emb_scale,
                              const float* w_scale, const float* bias, float* out, int ldo, int M,
                              int E, int N, int L, int operands, int* launches,
                              cudaStream_t stream) {
  if (operands == kAdalnF32)
    return f32::launch(static_cast<const float*>(emb), static_cast<const float*>(w), bias, out,
                       ldo, M, E, N, L, launches, stream);
  int p[6];
  plan_of(M, N, L, operands, sm_count(), p);
  auto run = [&](auto kernel_launch) {
    return kernel_launch(emb, w, emb_scale, w_scale, bias, out, ldo, M, E, N, L, launches, stream);
  };
  const bool tall = p[0] == 128, wide = p[1] == 128;
  if (operands == kAdalnInt8)
    return wide ? (tall ? run(launch<true, 128, 128>) : run(launch<true, 64, 128>))
                : (tall ? run(launch<true, 128, 64>) : run(launch<true, 64, 64>));
  return wide ? (tall ? run(launch<false, 128, 128>) : run(launch<false, 64, 128>))
              : (tall ? run(launch<false, 128, 64>) : run(launch<false, 64, 64>));
}

// The tiling of the GEMM's launch for M rows, L layers of N columns in the
// operand types `operands` on the current card (6 int32, see `plan_of`;
// ops/decoder_stack.py `adaln_plan` computes the same).
CT_EXPORT int adaln_gemm_plan(int M, int N, int L, int operands, int* out) {
  plan_of(M, N, L, operands, sm_count(), out);
  return 0;
}

// out (M, L N) float32 = the AdaLN modulation of the L layers in one launch
// (emb (M, E), adaln_w (L, E, N), adaln_b (L, N)) in the operand types
// `operands` (AdalnOperands: 0 bf16, 1 int8 with emb_scale (M,) and aw_scale
// (L, N), 2 float32).  launches (int, host): raised by one for each kernel
// launched.
CT_EXPORT int adaln_modulation_forward(const void* emb, const void* adaln_w, const void* emb_scale,
                                       const void* aw_scale, const void* adaln_b, void* out,
                                       void* launches, int M, int E, int N, int L, int operands,
                                       void* stream) {
  if (M < 1 || L < 1 || operands < kAdalnBf16 || operands > kAdalnF32 ||
      !adaln_gemm_takes(E, N, operands) ||
      (operands == kAdalnInt8 && (emb_scale == nullptr || aw_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  return (int)launch_adaln_gemm(emb, adaln_w, static_cast<const float*>(emb_scale),
                                static_cast<const float*>(aw_scale),
                                static_cast<const float*>(adaln_b), static_cast<float*>(out),
                                L * N, M, E, N, L, operands, static_cast<int*>(launches),
                                static_cast<cudaStream_t>(stream));
}

// K2 / K3: the per-step sampler glue around the decoder stack.
//
// K2 replaces conductor_tpu/ops/pallas_sampler.py::sampler_prologue (kernel
// `_prologue_kernel`, pallas_call at :111):
//   emb_act = silu(temb[t] + emb_base)   (the temb add the JAX path does
//                                         outside its kernel is fused here)
//   h0      = x @ W_joint + seq_bias     (seq_bias = seq_emb[:T] + b_joint)
// emb_act leaves as bf16, as float32 (the float32 mode, `emb_dtype`
// float32) or, in the int8-AdaLN mode (`quantize_emb`,
// :58-72), as int8 codes with one float32 scale a row: symmetric per-row
// quantization, scale = max(max|row|, 1e-8) / 127, code = round-half-even
// (emb_act / scale), JAX `quantize_rows` (pallas_layer.py:345-354).  The
// SiLU is then v * sigmoid(v), the formula of the plain version and of
// JAX: one ulp of emb_act can move a code across a half-boundary, or the
// row's maximum and so its scale.  So every step of it is IEEE: `expf`, not
// `__expf`, and divisions, not products by a reciprocal.
// K3 replaces sampler_epilogue (kernel `_epilogue_kernel`, pallas_call at
// :158):
//   x_{t-1} = alpha * (h @ W_out + b_out) + beta * x_t
// with (alpha, beta) from the host's ddim_affine_tables, passed by value.
//
// What bounds them on an H100: bytes.  At B = 8, T = 1800 K2 moves 54.0 MB
// (46.7 in the int8 mode, 68.7 with float32 emb_act), emb_base's 29.5 MB
// read and emb_act written,
// 0.016 ms at 3.35 TB/s; K3 10.4 MB, mostly h, 0.003 ms.  Their products
// (26 x 128 a row, 96 and 48 MFLOP at B = 8) stay on the CUDA cores, about a
// microsecond there: an MMA tile would sit mostly idle at depth 26 or width
// 26, and the float32 mode (rnd = 0) must keep true float32 products, which
// the tensor cores do not give.  Matmul operands are rounded to bf16 where
// rnd is set (float32 accumulation), as the JAX kernels' mxu_dtype casts.
//
// K2's design: a warp a row, many rows in flight.  A block stages W_joint
// in shared memory once by cp.async (rounded once where rnd), then walks a
// contiguous range of rows, warp w taking rows lo + w, lo + w + kProWarps,
// ...  Each warp keeps a ring of kProStages row slots in shared memory: it
// issues the emb_base row (2 KB, lane l copying the 16-byte pieces l,
// l + 32, ...), the pose row (lanes 0..C-1, 4 bytes each) and seq_bias[t]
// (lane l its 16 bytes) of the row kProStages - 1 ahead by cp.async before
// it works on the current one.  A lane reads back only what it copied
// itself, so the ring needs no barrier.  The pose values go to the other
// lanes by __shfl_sync; lane l owns h columns 4l..4l+3 (a 16-byte store)
// and runs their 26-deep chain in ascending c from shared memory; it owns
// emb_base's 16 values at the copies it made, writes them back as 8-byte
// bf16, 16-byte float32 or 4-byte int8 stores, and keeps temb's matching 16
// values in registers for all its rows.  The int8 row maximum is 5 __shfl_xor_sync
// steps.  2 stages at 3 blocks an SM (24 warps, ~64 KB of loads in flight
// an SM) measured faster than 3 or 4 stages at 2 blocks
// (scripts/k2_variants.py); a 1-D bulk copy into the ring was not tried.
//
// K3's design: a block owns a tile of rows, each of its warps a contiguous
// run of them (`sampler_plan` sizes it so that the card's warp slots share
// the rows about evenly).  The block stages W_out (D, C) by cp.async once,
// and lane c < C keeps column c of it in 128 registers (rounded once where
// rnd), so that the chains read only h from shared memory: a warp streams
// its rows, 4 at a time, through a ring of kEpiStages slots by 16-byte
// cp.async, and every lane reads the same 16 bytes of a row at a time (a
// broadcast).  Lane c runs the 4 rows' 128-deep chains for column c in
// ascending d and writes x_{t-1}; the C lanes write a row's outputs, one
// contiguous run, and read its x_t the same way.  A lane's 16-byte load
// feeds 4 FMAs; 26 of the 32 lanes work.  At B = 8 the products take most
// of its time (scripts/k2_variants.py), on the shared loads as much as on
// the FMAs: a lane cannot hold more of W_out than one column.
//
// Widths: h's width D (W in the kernels, a template parameter) is 32, 64
// or 128, the model widths of K1 (ops/_build.py WIDTHS).  K2's lane owns W
// / 32 columns of h (4 at D = 128, one 16-byte store; 2 or 1 below, 8- or
// 4-byte copies and stores), and copies exactly its own columns of the
// sequence bias; emb_act's E = 4D is 128-512, 1-4 pieces a lane.  K3's lane
// keeps W values of its W_out column.
//
// Both: fixed summation orders, no atomics (a repeat gives the same bits),
// 32-bit index math but for a row's offset, any B and T.  Every output is
// one chain in ascending order with the per-element formulas above, so its
// bits do not depend on the tiling.  `sampler_plan` reports the tiling each
// launch picks (ops/sampler_glue.py `plan` computes the same).

#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxWidth = 128;       // the widest h (D) the kernels are built for
constexpr int kProWarps = 8;         // K2: warps a block
constexpr int kProBlocksPerSm = 3;   // K2's launch bounds (ops/sampler_glue.py PRO_BLOCKS_PER_SM)
constexpr int kProStages = 2;        // K2: a warp's ring of row slots
constexpr int kPoseSlot = 32;        // K2: floats a slot keeps for the pose row (C <= 32)
constexpr int kMaxEv = 4;            // K2: emb_base's 16-byte pieces a lane, E <= 512
constexpr int kEpiWarps = 4;         // K3: warps a block
constexpr int kEpiBlocksPerSm = 2;   // K3's launch bounds (a lane keeps a W_out column)
constexpr int kEpiGroup = 4;         // K3: rows whose chains a lane runs at once
constexpr int kEpiMaxGroups = 8;     // K3: row groups a warp at most
constexpr int kEpiStages = 2;        // K3: a warp's ring of row groups
constexpr int kPose = 26;            // K3's column count, the pose width (the one instance)
constexpr unsigned kFull = 0xffffffffu;

// cp.async with the compiler barred from moving shared-memory accesses
// across it: a thread reads back its own copies after `wait`.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
// N (1, 2 or 4) consecutive floats, N-aligned, by one copy.
template <int N>
__device__ __forceinline__ void cp_async_n(float* dst, const float* src) {
  if constexpr (N == 4) cp_async16(dst, src);
  else if constexpr (N == 2) cp_async8(dst, src);
  else cp_async4(dst, src);
}
// N (1, 2 or 4) consecutive floats, N-aligned, by one load or store.
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x, v[1] = f.y;
  } else {
    v[0] = *p;
  }
}
template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&v)[N]) {
  if constexpr (N == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (N == 2) *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else *p = v[0];
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 round4(float4 v) {
  return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w));
}

// One element of emb_act in the int8 mode: v * sigmoid(v), every step IEEE
// (`__frcp_rn(d)` is the correctly rounded 1 / d, `__fdiv_rn(1, d)`'s bits).
__device__ __forceinline__ float silu_int8(float v) {
  return __fmul_rn(v, __frcp_rn(__fadd_rn(1.f, expf(-v))));
}

__device__ __forceinline__ uint32_t code(float a, float s) {  // half to even, as jnp.round
  return static_cast<uint8_t>(static_cast<signed char>(__float2int_rn(__fdiv_rn(a, s))));
}

// Shared memory (floats): W_joint (C, W), then each warp's ring of
// kProStages slots of E + kPoseSlot + W floats (emb_base's row, the pose's
// and seq_bias[t]).  Lane l owns h's columns kCols l .. kCols l + kCols - 1.
template <int W>
__global__ void __launch_bounds__(kProWarps * 32, kProBlocksPerSm)
prologue_rows(const float* __restrict__ x, const float* __restrict__ temb,
              const float* __restrict__ emb_base, const float* __restrict__ w_joint,
              const float* __restrict__ seq_bias, float* __restrict__ h,
              void* __restrict__ emb_out, float* __restrict__ emb_scale, int n_rows, int T,
              int C, int E, int rows_per_block, int rnd, int emb_f32) {
  constexpr int kCols = W / 32;  // h's columns a lane
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ev = E >> 7;  // 16-byte pieces of emb_base a lane
  const int slot = E + kPoseSlot + W;
  float* ring = smem + C * W + warp * kProStages * slot;
  const int lo = blockIdx.x * rows_per_block, hi = min(n_rows, lo + rows_per_block);

  // the row's emb_base, pose and sequence bias into ring slot `stage`; an
  // empty group past the range keeps the count of groups
  auto issue = [&](int row, int stage) {
    if (row < hi) {
      float* dst = ring + stage * slot;
      const float* src = emb_base + (size_t)row * E;
#pragma unroll
      for (int j = 0; j < kMaxEv; ++j)
        if (j < ev) cp_async16(dst + 4 * (j * 32 + lane), src + 4 * (j * 32 + lane));
      if (lane < C) cp_async4(dst + E + lane, x + (size_t)row * C + lane);
      cp_async_n<kCols>(dst + E + kPoseSlot + kCols * lane,
                        seq_bias + (size_t)(row % T) * W + kCols * lane);
    }
    cp_async_commit();
  };

  // W_joint: a group of its own, ahead of the ring's first rows
  for (int i = threadIdx.x; i < C * W / 4; i += blockDim.x)
    cp_async16(smem + 4 * i, w_joint + 4 * i);
  cp_async_commit();
  int row = lo + warp;
#pragma unroll
  for (int s = 0; s < kProStages - 1; ++s) issue(row + s * kProWarps, s);
  float4 tv[kMaxEv];
#pragma unroll
  for (int j = 0; j < kMaxEv; ++j)
    if (j < ev) tv[j] = __ldg(reinterpret_cast<const float4*>(temb) + j * 32 + lane);
  cp_async_wait<kProStages - 1>();  // the W_joint pieces this thread copied
  if (rnd)  // rounded to bf16 once, each thread its own pieces
    for (int i = threadIdx.x; i < C * W / 4; i += blockDim.x)
      reinterpret_cast<float4*>(smem)[i] = round4(reinterpret_cast<float4*>(smem)[i]);
  __syncthreads();  // W_joint staged

  const float* ws = smem;
  for (int k = 0; row < hi; ++k, row += kProWarps) {
    issue(row + (kProStages - 1) * kProWarps, (k + kProStages - 1) % kProStages);
    cp_async_wait<kProStages - 1>();  // this row's copies (the lane's own) have landed
    const float* st = ring + (k % kProStages) * slot;

    // h = x @ W_joint + seq_bias[t]
    float sb[kCols];
    load_n<kCols>(st + E + kPoseSlot + kCols * lane, sb);
    float xv = lane < C ? st[E + lane] : 0.f;
    if (rnd) xv = round_bf16(xv);
    float acc[kCols] = {};
    for (int c = 0; c < C; ++c) {
      const float xc = __shfl_sync(kFull, xv, c);
      float w[kCols];
      load_n<kCols>(ws + c * W + kCols * lane, w);
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j] = fmaf(xc, w[j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] += sb[j];
    store_n<kCols>(h + (size_t)row * W + kCols * lane, acc);

    // emb_act = silu(temb + emb_base)
    float4 v[kMaxEv];
#pragma unroll
    for (int j = 0; j < kMaxEv; ++j) {
      if (j < ev) {
        const float4 e = reinterpret_cast<const float4*>(st)[j * 32 + lane];
        v[j] = make_float4(tv[j].x + e.x, tv[j].y + e.y, tv[j].z + e.z, tv[j].w + e.w);
      }
    }
    const size_t out0 = (size_t)row * E;
    if (emb_f32) {
      float4* out = reinterpret_cast<float4*>(static_cast<float*>(emb_out) + out0);
#pragma unroll
      for (int j = 0; j < kMaxEv; ++j)
        if (j < ev)
          out[j * 32 + lane] =
              make_float4(silu(v[j].x), silu(v[j].y), silu(v[j].z), silu(v[j].w));
      continue;
    }
    if (emb_scale == nullptr) {
      bf16* out = static_cast<bf16*>(emb_out) + out0;
#pragma unroll
      for (int j = 0; j < kMaxEv; ++j) {
        if (j < ev) {
          const __nv_bfloat162 a = __floats2bfloat162_rn(silu(v[j].x), silu(v[j].y));
          const __nv_bfloat162 b = __floats2bfloat162_rn(silu(v[j].z), silu(v[j].w));
          uint2 packed;
          packed.x = *reinterpret_cast<const uint32_t*>(&a);
          packed.y = *reinterpret_cast<const uint32_t*>(&b);
          reinterpret_cast<uint2*>(out)[j * 32 + lane] = packed;
        }
      }
      continue;
    }
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxEv; ++j) {
      if (j < ev) {
        v[j] = make_float4(silu_int8(v[j].x), silu_int8(v[j].y), silu_int8(v[j].z),
                           silu_int8(v[j].w));
        m = fmaxf(fmaxf(m, fmaxf(fabsf(v[j].x), fabsf(v[j].y))),
                  fmaxf(fabsf(v[j].z), fabsf(v[j].w)));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    const float s = fmaxf(m, 1e-8f) / 127.f;
    uint32_t* out = reinterpret_cast<uint32_t*>(static_cast<signed char*>(emb_out) + out0);
#pragma unroll
    for (int j = 0; j < kMaxEv; ++j)
      if (j < ev)
        out[j * 32 + lane] = code(v[j].x, s) | code(v[j].y, s) << 8 | code(v[j].z, s) << 16 |
                             code(v[j].w, s) << 24;
    if (lane == 0) emb_scale[row] = s;
  }
  cp_async_wait<0>();
}

// Shared memory (floats): W_out (W, C) as it lies in device memory, then
// each warp's ring of kEpiStages groups of kEpiGroup h rows (W each).
template <int W, int C>
__global__ void __launch_bounds__(kEpiWarps * 32, kEpiBlocksPerSm)
epilogue_tiles(const float* __restrict__ h, const float* __restrict__ x_t,
               const float* __restrict__ w_out, const float* __restrict__ b_out,
               float* __restrict__ out, float alpha, float beta, int n_rows, int warp_rows,
               int rnd) {
  static_assert(W * C % 4 == 0 && C <= 32, "K3 shape");
  constexpr int kSlot = kEpiGroup * W;  // floats a ring slot
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ring = smem + W * C + warp * kEpiStages * kSlot;
  const int lo = (blockIdx.x * kEpiWarps + warp) * warp_rows;  // the warp's rows [lo, hi)
  const int hi = min(n_rows, lo + warp_rows);

  // group k's h rows into its ring slot (an empty group past the warp's
  // rows); lane l copies the 16-byte pieces l, l + 32, ...
  auto issue = [&](int k) {
    const int r0 = lo + k * kEpiGroup, nr = min(kEpiGroup, hi - r0);
    const float* src = h + (size_t)r0 * W;
    for (int i = lane; i < nr * (W / 4); i += 32)
      cp_async16(ring + (k % kEpiStages) * kSlot + 4 * i, src + 4 * i);
    cp_async_commit();
  };

  for (int i = threadIdx.x; i < W * C / 4; i += blockDim.x)
    cp_async16(smem + 4 * i, w_out + 4 * i);
  cp_async_commit();
#pragma unroll
  for (int k = 0; k < kEpiStages - 1; ++k) issue(k);
  cp_async_wait<kEpiStages - 1>();
  __syncthreads();  // W_out staged
  // lane c keeps column c of W_out (rounded once where rnd), and b_out[c]
  const int c = lane < C ? lane : C - 1;
  float w[W];
#pragma unroll
  for (int d = 0; d < W; ++d) w[d] = rnd ? round_bf16(smem[d * C + c]) : smem[d * C + c];
  const float bias = __ldg(b_out + c);

  const int groups = (hi - lo + kEpiGroup - 1) / kEpiGroup;
  for (int k = 0; k < groups; ++k) {
    const int r0 = lo + k * kEpiGroup, nr = min(kEpiGroup, hi - r0);
    float xv[kEpiGroup];
#pragma unroll
    for (int j = 0; j < kEpiGroup; ++j)
      if (j < nr && lane < C) xv[j] = __ldg(x_t + (size_t)(r0 + j) * C + lane);
    __syncwarp();  // the slot the next issue overwrites has been read
    issue(k + kEpiStages - 1);
    cp_async_wait<kEpiStages - 1>();  // this group's pieces, the lane's own
    float* st = ring + (k % kEpiStages) * kSlot;
    if (rnd)
      for (int i = lane; i < nr * (W / 4); i += 32)
        reinterpret_cast<float4*>(st)[i] = round4(reinterpret_cast<float4*>(st)[i]);
    __syncwarp();  // every lane's pieces landed and rounded

    // each row's W-deep chain, ascending d; the rows' h read by every lane
    float acc[kEpiGroup] = {};
#pragma unroll
    for (int d4 = 0; d4 < W / 4; ++d4) {
#pragma unroll
      for (int j = 0; j < kEpiGroup; ++j) {
        const float4 hv = reinterpret_cast<const float4*>(st + j * W)[d4];
        acc[j] = fmaf(hv.x, w[4 * d4], acc[j]);
        acc[j] = fmaf(hv.y, w[4 * d4 + 1], acc[j]);
        acc[j] = fmaf(hv.z, w[4 * d4 + 2], acc[j]);
        acc[j] = fmaf(hv.w, w[4 * d4 + 3], acc[j]);
      }
    }
    // the DDIM affine: lanes 0..C-1 write a row's C outputs, one contiguous run
#pragma unroll
    for (int j = 0; j < kEpiGroup; ++j)
      if (j < nr && lane < C)
        out[(size_t)(r0 + j) * C + lane] = alpha * (acc[j] + bias) + beta * xv[j];
  }
  cp_async_wait<0>();
}

// The tiling a launch picks: {rows a block, blocks, threads, ring stages,
// shared bytes}.  which: 0 = K2, 1 = K3; W: h's width.
void plan_of(int n_rows, int C, int W, int E, int which, int sms, int* out) {
  if (which == 0) {
    const int blocks = std::min(ceil_div(n_rows, kProWarps), sms * kProBlocksPerSm);
    const int rows = ceil_div(n_rows, blocks);
    out[0] = rows;
    out[1] = ceil_div(n_rows, rows);
    out[2] = kProWarps * 32;
    out[3] = kProStages;
    out[4] = (C * W + kProWarps * kProStages * (E + kPoseSlot + W)) * (int)sizeof(float);
  } else {
    // rows a warp: groups enough to give each of the SMs' warp slots one
    // share of the rows, up to kEpiMaxGroups
    const int slots = sms * kEpiBlocksPerSm * kEpiWarps;
    const int groups = std::min(ceil_div(n_rows, kEpiGroup * slots), kEpiMaxGroups);
    out[0] = kEpiWarps * kEpiGroup * groups;
    out[1] = ceil_div(n_rows, out[0]);
    out[2] = kEpiWarps * 32;
    out[3] = kEpiStages;
    out[4] = (W * C + kEpiWarps * kEpiStages * kEpiGroup * W) * (int)sizeof(float);
  }
}

bool width_ok(int D) { return D == 32 || D == 64 || D == kMaxWidth; }

template <int W>
cudaError_t prologue(const void* x, const void* temb, const void* emb_base, const void* w_joint,
                     const void* seq_bias, void* h, void* emb_act, void* emb_scale, int B, int T,
                     int C, int E, int rnd, int emb_f32, cudaStream_t s) {
  int p[5];
  plan_of(B * T, C, W, E, 0, sm_count(), p);
  static const cudaError_t attr = cudaFuncSetAttribute(
      prologue_rows<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (kPoseSlot * W + kProWarps * kProStages * (128 * kMaxEv + kPoseSlot + W)) *
          (int)sizeof(float));
  if (attr != cudaSuccess) return attr;
  prologue_rows<W><<<p[1], p[2], p[4], s>>>(
      static_cast<const float*>(x), static_cast<const float*>(temb),
      static_cast<const float*>(emb_base), static_cast<const float*>(w_joint),
      static_cast<const float*>(seq_bias), static_cast<float*>(h), emb_act,
      static_cast<float*>(emb_scale), B * T, T, C, E, p[0], rnd, emb_f32);
  return cudaGetLastError();
}

template <int W>
cudaError_t epilogue(const void* h, const void* x_t, const void* w_out, const void* b_out,
                     void* out, float alpha, float beta, int B, int T, int rnd, cudaStream_t s) {
  int p[5];
  plan_of(B * T, kPose, W, 0, 1, sm_count(), p);
  epilogue_tiles<W, kPose><<<p[1], p[2], p[4], s>>>(
      static_cast<const float*>(h), static_cast<const float*>(x_t),
      static_cast<const float*>(w_out), static_cast<const float*>(b_out),
      static_cast<float*>(out), alpha, beta, B * T, p[0] / kEpiWarps, rnd);
  return cudaGetLastError();
}

}  // namespace

// {rows a block, blocks, threads, ring stages, shared bytes} of K2 (which 0)
// or K3 (which 1) for B x T rows of width D on the current card.
CT_EXPORT int sampler_plan(int B, int T, int C, int D, int E, int which, int* out) {
  plan_of(B * T, C, D, E, which, sm_count(), out);
  return 0;
}

// emb_f32: emb_act float32; else emb_scale null: emb_act bf16; else int8
// codes and their row scales.
CT_EXPORT int sampler_prologue_forward(const void* x, const void* temb, const void* emb_base,
                                       const void* w_joint, const void* seq_bias, void* h,
                                       void* emb_act, void* emb_scale, int B, int T, int C,
                                       int D, int E, int rnd, int emb_f32, void* stream) {
  if (!width_ok(D) || C < 1 || C > kPoseSlot || E < 128 || E > 128 * kMaxEv || E % 128 ||
      B * T < 1 || (emb_f32 && emb_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto launch) {
    return (int)launch(x, temb, emb_base, w_joint, seq_bias, h, emb_act, emb_scale, B, T, C, E,
                       rnd, emb_f32, static_cast<cudaStream_t>(stream));
  };
  return D == 32 ? run(prologue<32>) : D == 64 ? run(prologue<64>) : run(prologue<128>);
}

CT_EXPORT int sampler_epilogue_forward(const void* h, const void* x_t, const void* w_out,
                                       const void* b_out, void* out, float alpha, float beta,
                                       int B, int T, int D, int C, int rnd, void* stream) {
  if (!width_ok(D) || C != kPose || B * T < 1) return (int)cudaErrorInvalidValue;
  auto run = [&](auto launch) {
    return (int)launch(h, x_t, w_out, b_out, out, alpha, beta, B, T, rnd,
                       static_cast<cudaStream_t>(stream));
  };
  return D == 32 ? run(epilogue<32>) : D == 64 ? run(epilogue<64>) : run(epilogue<128>);
}

// Shared helpers of the port's CUDA kernels (conductor_tpu_torch/csrc).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

typedef __nv_bfloat16 bf16;

// Round a float to the nearest bf16 and back: the "bf16 matmul operand,
// float32 accumulation" numerics of the JAX kernels' `md` helper.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

static inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The current card's number of SMs (read once a process).
inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

#define CT_EXPORT extern "C" __attribute__((visibility("default")))

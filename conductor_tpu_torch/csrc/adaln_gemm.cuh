// The AdaLN modulation GEMM of K1 / K5 (adaln_gemm.cu), as the row passes'
// launchers call it.
#pragma once

#include "common.cuh"

// The GEMM's operand types: bf16 (tensor cores), int8 codes with float32
// scales (tensor cores), or float32 (FFMA on the CUDA cores, K1's float32
// mode).
enum AdalnOperands { kAdalnBf16 = 0, kAdalnInt8 = 1, kAdalnF32 = 2 };

// out[r, c] (float32, row stride ldo) = emb[r, :] @ w[:, c] + bias[c] for the
// M rows of emb (M, E) and the L * N columns of L layer matrices, each (E, N)
// row-major, in the operand types `operands`; int8 dequantizes in JAX's
// order, acc * (emb_scale[r] * w_scale[c]) + bias[c], each op rounded on its
// own.  *launches (host) is raised by one for each kernel launched.
cudaError_t launch_adaln_gemm(const void* emb, const void* w, const float* emb_scale,
                              const float* w_scale, const float* bias, float* out, int ldo, int M,
                              int E, int N, int L, int operands, int* launches,
                              cudaStream_t stream);

// Whether the GEMM takes this width of emb and of a layer's columns.
bool adaln_gemm_takes(int E, int N, int operands);

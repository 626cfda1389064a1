// The AdaLN modulation GEMM of K1 / K5 (adaln_gemm.cu), as the row passes'
// launchers call it.
#pragma once

#include "common.cuh"

// out[r, c] (float32, row stride ldo) = emb[r, :] @ w[:, c] + bias[c] for the
// M rows of emb (M, E) and the L * N columns of L layer matrices, each (E, N)
// row-major, bf16 or int8; int8 dequantizes in JAX's order,
// acc * (emb_scale[r] * w_scale[c]) + bias[c], each op rounded on its own.
// *launches (host) is raised by one for each kernel launched.
cudaError_t launch_adaln_gemm(const void* emb, const void* w, const float* emb_scale,
                              const float* w_scale, const float* bias, float* out, int ldo, int M,
                              int E, int N, int L, bool int8, int* launches,
                              cudaStream_t stream);

// Whether the GEMM takes this width of emb and of a layer's columns.
bool adaln_gemm_takes(int E, int N, bool int8);

// PTX building blocks of the tensor-core kernels that stage their operands
// in shared memory (adaln_gemm.cu, the row pass of decoder_stack.cu,
// conv_train.cu): 16-byte cp.async, ldmatrix and mma.sync in bf16 and s8.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes if !valid (src is
// then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lanes 8j .. 8j + 7 give the row addresses of matrix j.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// Two 8x8 b16 matrices; lanes 8j .. 8j + 7 (j < 2) give the row addresses.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c (16 x 8, float32) += a (16 x 16) . b (16 x 8), bf16 operands
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8, int32) += a (16 x 32) . b (32 x 8), s8 operands
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk c of row r in a tile of CH chunks a row (CH a
// multiple of 8): the low three bits of the chunk are XORed with the row's,
// so the 8 rows that one 8x8 ldmatrix reads at one chunk fall on 8
// distinct bank groups.  Rows of 4 chunks (64 bytes, two rows a 128-byte
// line) XOR the chunk with bits 1-2 of the row instead, to the same end.
template <int CH>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  static_assert(CH % 8 == 0 || CH == 4, "rows of whole 128-byte lines, or of half lines");
  if constexpr (CH == 4) return (uint32_t)(r * 4 + (c ^ ((r >> 1) & 3))) * 16u;
  return (uint32_t)(r * CH + (c ^ (r & 7))) * 16u;
}

}  // namespace tc

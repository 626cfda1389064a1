// Tiles of the music encoder's 3x3 convs (conv_block.cu, K4, and
// conv_train.cu, K9): NHWC bf16 rows staged in shared memory pixel-major,
// F + 2 pixels a row (the conv's column halo), so that tap (dt, df) of
// output pixel p is staged pixel p + dt (F + 2) + df.
#pragma once

#include "common.cuh"
#include "tensor_core.cuh"

namespace convt {

// The reflection of index i into [0, n), for i in [-1, n] (edge excluded).
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

// 16-byte unit of chunk c of pixel p in a tile of CH (2 or 4) chunks a
// pixel: the chunks of any 8 consecutive pixels land in 8 distinct units
// mod 8 (bank groups), so an 8x8 ldmatrix at any pixel offset is
// conflict-free.
template <int CH>
__device__ __forceinline__ int swz(int p, int c) {
  return p * CH + (c ^ ((p / (8 / CH)) & (CH - 1)));
}

// 16 bytes from global to shared memory, or 16 zero bytes if !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  tc::cp_async16(tc::smem_addr(dst), src, valid);
}

}  // namespace convt

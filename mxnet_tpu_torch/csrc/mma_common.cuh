// The tensor-core product shared by the flash-attention kernels
// (flash_common.cuh) and the tile route of the weight-only GEMVs
// (gemv_mma.cuh): one warp-wide mma.sync m16n8k16, bf16 in, f32 accumulate.
//
// In a warp, lane = 4 g + t (g = lane / 4, t = lane % 4). PTX's fragment
// layouts for m16n8k16 with 16-bit inputs:
//   A (16 x 16): a0 = A[g][2t..2t+1],     a1 = A[g+8][2t..2t+1],
//                a2 = A[g][2t+8..2t+9],   a3 = A[g+8][2t+8..2t+9];
//   B (16 x 8):  b0 = B[2t..2t+1][g],     b1 = B[2t+8..2t+9][g];
//   C (16 x 8):  c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
// (each 32-bit register holds two bf16, the lower index in the low half).
#pragma once

#include <cstdint>

namespace mx {

// Not volatile: a pure function of its registers, so the compiler may
// schedule it around the (volatile) shared-memory loads.
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace mx

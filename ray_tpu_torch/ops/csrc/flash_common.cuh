// Pieces shared by the flash attention kernels (flash_fwd.cu: K1,
// flash_bwd.cu: K2 and K3): the mask fill, bf16 packing, and K2's mma.sync
// product and shared-memory row pitch of its bf16 tiles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;  // the JAX package's mask fill
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b for one m16n8k16 tile: a is 16x16 (row-major fragments), b is
// 16x8 (column-major fragments), d is 16x8 fp32. Fragment rows are
// g = lane / 4 and g + 8, fragment columns 2 * (lane % 4) + {0, 1}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory pitch of a bf16 tile row of D elements. D + 8 puts the 8
// rows a warp's fragment load touches 4 banks apart (12 for D = 16, 80),
// so its 32 lanes hit 32 banks.
template <int D>
__host__ __device__ constexpr int mma_pitch() { return D + 8; }

}  // namespace flash

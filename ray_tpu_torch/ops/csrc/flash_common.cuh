// Pieces shared by the flash attention kernels (flash_fwd.cu: K1,
// flash_bwd.cu: K2 and K3): the mask fill, log2(e) and bf16 packing.

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

}  // namespace flash

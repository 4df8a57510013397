// bfloat16 held as raw uint16_t, converted with bit operations (no
// cuda_bf16.h, so tools/cuda_emu/ compiles the same code under g++):
// widening is exact, narrowing rounds to nearest even exactly as torch's
// float -> bfloat16 cast does (NaN -> 0x7FC0).
#pragma once
#include <cuda_runtime.h>

namespace cg {

__device__ __forceinline__ float bf16_to_f32(unsigned short h) {
  return __uint_as_float((unsigned)h << 16);
}

__device__ __forceinline__ unsigned short f32_to_bf16(float f) {
  const unsigned u = __float_as_uint(f);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return 0x7FC0;  // NaN
  return (unsigned short)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

// f rounded to the nearest bfloat16, kept as a float
__device__ __forceinline__ float round_bf16(float f) {
  return bf16_to_f32(f32_to_bf16(f));
}

}  // namespace cg

// float16 held as raw bits, converted without cuda_fp16.h (so
// tools/cuda_emu/ compiles the same code under g++), beside bf16.cuh's
// bfloat16.  The storage type is a struct of its own, so that a kernel
// templated on its storage type tells float16 from bf16's unsigned short.
// Widening is exact; narrowing rounds to nearest even, subnormals rounded
// at 2^-24, values from 65520 up (and inf) to inf.  On the card both
// directions are one cvt instruction each, the instructions torch's own
// casts on the card use (a NaN stays a NaN, its payload not kept).  Elsewhere
// (the g++ emulator) they are bit operations that equal torch's CPU casts
// bit for bit, NaN quieted with the top of its payload kept
// (sign | 0x7E00 | mantissa >> 13).
#pragma once
#include <cuda_runtime.h>

namespace cg {

struct f16 {
  unsigned short bits;
};

__device__ __forceinline__ float f16_to_f32(unsigned short h) {
#if defined(__CUDA_ARCH__)
  float f;
  asm("cvt.f32.f16 %0, %1;" : "=f"(f) : "h"(h));
  return f;
#else
  const unsigned s = (unsigned)(h & 0x8000u) << 16;
  const unsigned e = (h >> 10) & 0x1Fu, m = h & 0x3FFu;
  if (e == 0x1Fu) return __uint_as_float(s | 0x7F800000u | (m << 13));
  if (e != 0) return __uint_as_float(s | ((e + 112u) << 23) | (m << 13));
  // zero or subnormal: m * 2^-24, exact in fp32
  return __uint_as_float(s | __float_as_uint((float)m * 5.9604644775390625e-8f));
#endif
}

__device__ __forceinline__ unsigned short f32_to_f16(float f) {
#if defined(__CUDA_ARCH__)
  unsigned short h;
  asm("cvt.rn.f16.f32 %0, %1;" : "=h"(h) : "f"(f));
  return h;
#else
  const unsigned u = __float_as_uint(f);
  const unsigned s = (u >> 16) & 0x8000u;
  const unsigned a = u & 0x7FFFFFFFu;
  if (a > 0x7F800000u)  // NaN
    return (unsigned short)(s | 0x7E00u | ((a >> 13) & 0x3FFu));
  if (a >= 0x477FF000u) return (unsigned short)(s | 0x7C00u);  // >= 65520
  if (a >= 0x38800000u) {  // a normal float16: rebias, round the 13 low bits
    const unsigned r = a - 0x38000000u;
    return (unsigned short)(s | ((r + 0xFFFu + ((r >> 13) & 1u)) >> 13));
  }
  const unsigned e = a >> 23;  // a subnormal float16 (or zero): |f| / 2^-24
  if (e < 102u) return (unsigned short)s;  // under 2^-25: rounds to zero
  const unsigned mant = (a & 0x7FFFFFu) | 0x800000u, sh = 126u - e;
  const unsigned rem = mant & ((1u << sh) - 1u), half = 1u << (sh - 1u);
  unsigned m = mant >> sh;
  if (rem > half || (rem == half && (m & 1u))) ++m;
  return (unsigned short)(s | m);
#endif
}

__device__ __forceinline__ float widen_f16(f16 v) { return f16_to_f32(v.bits); }

__device__ __forceinline__ f16 narrow_f16(float v) { return f16{f32_to_f16(v)}; }

}  // namespace cg

// The warp-level instructions the tensor-core kernels share (decode
// attention's mma route, the plain-variant DFT steps of dft_mma.cuh):
// cp.async copies, ldmatrix and mma.sync m16n8k16 with fp32 accumulators.
// tools/cuda_emu/cuda_runtime.h stands in for them under g++.
#pragma once
#include <cuda_runtime.h>

namespace cg {

// 16 bytes from device to shared memory, of which the first `have` are read
// and the rest zero-filled
__device__ __forceinline__ void cp16(void* dst, const void* src, int have) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(have));
#elif defined(CUDA_EMU)
  emu_cp_async(dst, src, 16, have);
#endif
}

__device__ __forceinline__ void cp_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// four 8x8 b16 matrices; lane i gives row i % 8 of matrix i / 8; register j
// gets matrix j, (row lane/4, columns 2*(lane%4) and +1), or with TRANS its
// transpose (rows 2*(lane%4) and +1, column lane/4)
template <bool TRANS>
__device__ __forceinline__ void ldsm4(unsigned* r, const unsigned short* p) {
#if defined(__CUDA_ARCH__)
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  if (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
#elif defined(CUDA_EMU)
  emu_ldmatrix_x4(r, p, TRANS);
#endif
}

// d += A (16x16, row) * B (16x8, col), bf16 (F16: float16) in, fp32
// accumulate
template <bool F16>
__device__ __forceinline__ void mma(float* d, const unsigned* a, unsigned b0,
                                    unsigned b1) {
#if defined(__CUDA_ARCH__)
  if (F16)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#elif defined(CUDA_EMU)
  if (F16)
    emu_mma_f16_16816(d, a, b0, b1);
  else
    emu_mma_bf16_16816(d, a, b0, b1);
#endif
}

}  // namespace cg

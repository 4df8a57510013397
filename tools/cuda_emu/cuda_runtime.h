// CPU stand-in for the parts of the CUDA runtime that csrc/*.cu use, so a
// kernel source compiles with g++ (see emulate.py).  Launches run every
// block and thread one after another; __syncthreads is not emulated, so
// only kernels whose threads never share memory run here (cgemm.cuh is
// replaced by a naive twin for that reason).
#pragma once
#include <cmath>
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
static dim3 blockIdx, threadIdx, gridDim, blockDim;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__ __restrict
template <class F> struct Launcher {
  F f; dim3 g, b;
  template <class... A> void operator()(A... a) {
    gridDim = g; blockDim = b;
    for (unsigned by = 0; by < g.y; ++by)
      for (unsigned bx = 0; bx < g.x; ++bx)
        for (unsigned tx = 0; tx < b.x; ++tx) {
          blockIdx = dim3(bx, by); threadIdx = dim3(tx); f(a...);
        }
  }
};
#define EMU_LAUNCH(k, g, b) Launcher<decltype(&k)>{&k, dim3(g), dim3(b)}

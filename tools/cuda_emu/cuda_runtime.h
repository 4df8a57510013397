// CPU stand-in for the parts of the CUDA runtime that csrc/*.cu use, so a
// kernel source compiles with g++ -std=c++20 (see emulate.py).  A launch
// starts one std::thread per CUDA thread of a block; the threads run the
// blocks one after another and meet at a std::barrier after each block,
// and __syncthreads() is that barrier, so kernels whose threads share
// memory run here.  Static __shared__ arrays become function statics;
// `extern __shared__` dynamic shared memory (rewritten by emulate.py)
// points at a buffer of the launch's third <<<>>> argument, reused by
// every block.  __shfl_xor_sync exchanges 32-bit values through a buffer
// between two barriers of the calling thread's warp, so every lane of a
// warp must reach it.  Only blockIdx.x/y and threadIdx.x are emulated, and
// cgemm.cuh is still replaced by a naive twin.
#pragma once
#define CUDA_EMU 1  // axis_fft.cuh's cp.async becomes a plain copy
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return float2{a, b}; }
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return float4{a, b, c, d}; }
struct alignas(8) uint2 { unsigned x, y; };
static thread_local dim3 blockIdx, threadIdx;
static dim3 gridDim, blockDim;
static std::barrier<>* emu_barrier = nullptr;
static unsigned char* emu_shared = nullptr;  // the launch's dynamic shared memory
static std::vector<std::unique_ptr<std::barrier<>>>* emu_warps = nullptr;
static unsigned emu_lanes[1024];             // __shfl_xor_sync's exchange
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  const unsigned t = threadIdx.x;
  auto& warp = *(*emu_warps)[t / 32];
  std::memcpy(&emu_lanes[t], &v, 4);
  warp.arrive_and_wait();
  T r;
  std::memcpy(&r, &emu_lanes[(t & ~31u) | ((t & 31u) ^ (unsigned)lane_mask)], 4);
  warp.arrive_and_wait();
  return r;
}
#define __global__
#define __grid_constant__
#define __device__
#define __host__
#define __shared__ static
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
template <class F> struct Launcher {
  F f; dim3 g, b; std::size_t shmem;
  template <class... A> void operator()(A... a) {
    gridDim = g; blockDim = b;
    std::vector<unsigned char> dyn(shmem > 0 ? shmem : 1);
    emu_shared = dyn.data();
    std::barrier<> bar(b.x);
    emu_barrier = &bar;
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    for (unsigned w = 0; w * 32 < b.x; ++w)
      warps.emplace_back(new std::barrier<>(b.x - w * 32 < 32 ? b.x - w * 32 : 32));
    emu_warps = &warps;
    std::vector<std::thread> threads;
    for (unsigned tx = 0; tx < b.x; ++tx)
      threads.emplace_back([&, tx] {
        threadIdx = dim3(tx);
        for (unsigned by = 0; by < g.y; ++by)
          for (unsigned bx = 0; bx < g.x; ++bx) {
            blockIdx = dim3(bx, by);
            f(a...);
            bar.arrive_and_wait();
          }
      });
    for (auto& t : threads) t.join();
    emu_barrier = nullptr;
    emu_warps = nullptr;
    emu_shared = nullptr;
  }
};
// the kernel comes last so that a template-id's commas pass through
#define EMU_LAUNCH(g, b, s, ...) Launcher<decltype(&__VA_ARGS__)>{&__VA_ARGS__, dim3(g), dim3(b), (std::size_t)(s)}

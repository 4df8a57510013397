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
// warp must reach it; __ballot_sync and the stand-ins of ldmatrix (x4,
// plain and .trans) and mma.sync m16n8k16 bf16 (emu_ldmatrix_x4,
// emu_mma_bf16_16816, with the PTX ISA's fragment layouts) exchange
// through per-warp buffers the same way, and __syncwarp is the warp's
// barrier.  cp.async is a plain copy (emu_cp_async); its commit and wait
// do nothing; atomicAdd is a std::atomic_ref's.  Only blockIdx.x/y and threadIdx.x are emulated.
#pragma once
#define CUDA_EMU 1  // axis_fft.cuh's cp.async becomes a plain copy
#include <atomic>
#include <barrier>
#include <bit>
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
struct alignas(4) ushort2 { unsigned short x, y; };
struct alignas(8) ushort4 { unsigned short x, y, z, w; };
inline ushort2 make_ushort2(unsigned short a, unsigned short b) { return ushort2{a, b}; }
inline ushort4 make_ushort4(unsigned short a, unsigned short b, unsigned short c,
                            unsigned short d) { return ushort4{a, b, c, d}; }
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
static thread_local dim3 blockIdx, threadIdx;
static dim3 gridDim, blockDim;
static std::barrier<>* emu_barrier = nullptr;
static unsigned char* emu_shared = nullptr;  // the launch's dynamic shared memory
static std::vector<std::unique_ptr<std::barrier<>>>* emu_warps = nullptr;
static unsigned emu_lanes[1024];             // __shfl_xor_sync's exchange
static const void* emu_rows[1024];           // ldmatrix's row addresses
static unsigned emu_frags[1024][6];          // mma's A and B registers
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
template <class T>
inline T atomicAdd(T* p, T v) { return std::atomic_ref<T>(*p).fetch_add(v); }
inline int __popc(unsigned x) { return std::popcount(x); }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline std::barrier<>& emu_warp() { return *(*emu_warps)[threadIdx.x / 32]; }
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { emu_warp().arrive_and_wait(); }
inline unsigned __ballot_sync(unsigned, bool p) {
  const unsigned t = threadIdx.x, w = t & ~31u;
  emu_lanes[t] = p ? 1u : 0u;
  emu_warp().arrive_and_wait();
  unsigned m = 0;
  for (unsigned i = 0; i < 32; ++i) m |= emu_lanes[w + i] << i;
  emu_warp().arrive_and_wait();
  return m;
}
// cp.async of `bytes`, the first `have` read and the rest zero-filled
inline void emu_cp_async(void* dst, const void* src, int bytes, int have) {
  std::memcpy(dst, src, have);
  std::memset(static_cast<char*>(dst) + have, 0, bytes - have);
}
inline float emu_bf16(unsigned reg, int half) {
  return __uint_as_float(((reg >> (16 * half)) & 0xFFFFu) << 16);
}
// ldmatrix.sync.aligned.m8n8.x4[.trans].shared.b16: lane i gives row i % 8
// of matrix i / 8; register j of lane L gets matrix j's (row L/4, columns
// 2*(L%4), +1), or with trans (rows 2*(L%4), +1, column L/4)
inline void emu_ldmatrix_x4(unsigned* r, const void* p, bool trans) {
  const unsigned t = threadIdx.x, w = t & ~31u, L = t & 31u;
  emu_rows[t] = p;
  emu_warp().arrive_and_wait();
  for (unsigned j = 0; j < 4; ++j) {
    unsigned short lo, hi;
    if (trans) {
      const auto* r0 = static_cast<const unsigned short*>(emu_rows[w + j * 8 + 2 * (L & 3)]);
      const auto* r1 = static_cast<const unsigned short*>(emu_rows[w + j * 8 + 2 * (L & 3) + 1]);
      lo = r0[L >> 2];
      hi = r1[L >> 2];
    } else {
      const auto* row = static_cast<const unsigned short*>(emu_rows[w + j * 8 + (L >> 2)]);
      lo = row[2 * (L & 3)];
      hi = row[2 * (L & 3) + 1];
    }
    r[j] = (unsigned)lo | ((unsigned)hi << 16);
  }
  emu_warp().arrive_and_wait();
}
// the float16 half (hi: the top one) of a 32-bit register, widened
inline float emu_f16(unsigned r, unsigned hi) {
  const unsigned h = hi ? r >> 16 : r & 0xFFFFu;
  const unsigned sgn = (h & 0x8000u) << 16, e = (h >> 10) & 0x1Fu, m = h & 0x3FFu;
  unsigned u;
  if (e == 0x1Fu) u = sgn | 0x7F800000u | (m << 13);
  else if (e != 0) u = sgn | ((e + 112u) << 23) | (m << 13);
  else {
    const float f = (float)m * 5.9604644775390625e-8f;
    std::memcpy(&u, &f, 4);
    u |= sgn;
  }
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (F16: .f16.f16), d +=
// A B: lane L = 4g + t holds A (g, 2t..) (g+8, 2t..) (g, 2t+8..) (g+8,
// 2t+8..), B (k 2t.., n g) (k 2t+8.., n g), D (g, 2t) (g, 2t+1) (g+8, 2t)
// (g+8, 2t+1)
template <bool F16>
inline void emu_mma_16816(float* d, const unsigned* a, unsigned b0,
                          unsigned b1) {
  const unsigned t = threadIdx.x, w = t & ~31u, L = t & 31u;
  for (int i = 0; i < 4; ++i) emu_frags[t][i] = a[i];
  emu_frags[t][4] = b0;
  emu_frags[t][5] = b1;
  emu_warp().arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    const unsigned row = (L >> 2) + (i >> 1) * 8, col = 2 * (L & 3) + (i & 1);
    float s = d[i];
    for (unsigned k = 0; k < 16; ++k) {
      const unsigned la = w + (row & 7) * 4 + ((k & 7) >> 1);
      const unsigned ra = emu_frags[la][(row >> 3) + 2 * (k >> 3)];
      const unsigned lb = w + col * 4 + ((k & 7) >> 1);
      const unsigned rb = emu_frags[lb][4 + (k >> 3)];
      const float x = F16 ? emu_f16(ra, k & 1) : emu_bf16(ra, k & 1);
      const float y = F16 ? emu_f16(rb, k & 1) : emu_bf16(rb, k & 1);
      s += x * y;
    }
    d[i] = s;
  }
  emu_warp().arrive_and_wait();
}
inline void emu_mma_bf16_16816(float* d, const unsigned* a, unsigned b0,
                               unsigned b1) {
  emu_mma_16816<false>(d, a, b0, b1);
}
inline void emu_mma_f16_16816(float* d, const unsigned* a, unsigned b0,
                              unsigned b1) {
  emu_mma_16816<true>(d, a, b0, b1);
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

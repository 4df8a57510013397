// Tiled split-complex fp32 GEMM shared by fft2d_gemm.cu and fft3d_fused.cu
// (their plain-bf16 chains).
//
//   C_z[m, n] = scale * T[m, n] * sum_k A_z[m, k] * B_z[k, n]
//
// with re/im planes kept apart, optional pointwise twiddle T in the
// epilogue, and every operand addressed through two-level index maps
// (Idx), so one kernel serves the four-step's left contraction with the
// batch folded into the columns, its right contraction with the reordered
// X[k2*n1 + k1] store, and the 2-D column pass's left contractions along
// axis -2.  All index splits are by powers of two (shift + mask).
//
// Full fp32 FMA on the CUDA cores: no TF32, no tensor cores.  A 64x64
// output tile per 256-thread block, 16-deep k tiles staged through shared
// memory, a 4x4 register micro-tile per thread.
//
// bf16 and float16 transforms (fft2d_gemm.cu, fft3d_fused.cu) use
// template instances of the same kernel: the A or the B operand may be raw
// bf16 or float16 (widened on load), and the epilogue stores fp32
// (EPI_F32), fp32 rounded through bf16 (EPI_ROUND) or float16
// (EPI_ROUND_F16), or raw bf16 (EPI_BF16) or float16 (EPI_F16); the sums
// stay fp32.  The half code sits behind `if constexpr`, so the fp32
// instance <IN_F32, IN_F32, EPI_F32> carries none of it: the core's speed
// follows its register count (ROADMAP 2c).
#pragma once
#include <cuda_runtime.h>
#include "bf16.cuh"
#include "f16.cuh"

namespace cg {

// i -> (i >> shift) * hi + (i & (2^shift - 1)) * lo
struct Idx {
  int shift;
  long long hi, lo;
};

inline Idx lin(long long stride) { return Idx{62, 0, stride}; }
inline Idx two(int shift, long long hi, long long lo) { return Idx{shift, hi, lo}; }

__device__ __forceinline__ long long at(const Idx& d, long long i) {
  return (i >> d.shift) * d.hi + (i & ((1LL << d.shift) - 1)) * d.lo;
}

struct Params {
  const float *ar, *ai, *br, *bi;
  float *cr, *ci;
  const float *tr, *ti;  // epilogue twiddle; nullptr for none
  long long M, N, batch;
  int K;
  Idx a_m, a_k, b_k, b_n, c_m, c_n, t_m, t_n;
  Idx a_z, b_z, c_z;  // per-batch base offsets
  float scale;
};

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4, NT = 256;

enum In { IN_F32 = 0, IN_BF16 = 1, IN_F16 = 2 };
enum Epi {
  EPI_F32 = 0, EPI_ROUND = 1, EPI_BF16 = 2, EPI_ROUND_F16 = 3, EPI_F16 = 4
};

// What one launch reads and stores: an operand's In, the epilogue's Epi.
struct Io {
  int a_in = IN_F32, b_in = IN_F32;
  int epi = EPI_F32;
};

template <int IN>
__device__ __forceinline__ float load(const float* base, long long off) {
  if constexpr (IN == IN_BF16)
    return bf16_to_f32(reinterpret_cast<const unsigned short*>(base)[off]);
  else if constexpr (IN == IN_F16)
    return f16_to_f32(reinterpret_cast<const unsigned short*>(base)[off]);
  else
    return base[off];
}

template <int A_IN, int B_IN, int EPI>
__global__ void __launch_bounds__(NT) cgemm_kernel(const Params p) {
  __shared__ float asr[BK][BM + 1], asi[BK][BM + 1];
  __shared__ float bsr[BK][BN], bsi[BK][BN];
  const long long tiles_n = (p.N + BN - 1) / BN;
  const long long m0 = (blockIdx.x / tiles_n) * BM;
  const long long n0 = (blockIdx.x % tiles_n) * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (long long z = blockIdx.y; z < p.batch; z += gridDim.y) {
    const long long oa = at(p.a_z, z), ob = at(p.b_z, z), oc = at(p.c_z, z);
    float accr[TM][TN], acci[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) accr[i][j] = acci[i][j] = 0.f;

    for (int k0 = 0; k0 < p.K; k0 += BK) {
      for (int e = tid; e < BM * BK; e += NT) {
        const int mm = e / BK, kk = e % BK;
        const long long m = m0 + mm;
        const int k = k0 + kk;
        float vr = 0.f, vi = 0.f;
        if (m < p.M && k < p.K) {
          const long long off = oa + at(p.a_m, m) + at(p.a_k, k);
          vr = load<A_IN>(p.ar, off);
          vi = load<A_IN>(p.ai, off);
        }
        asr[kk][mm] = vr;
        asi[kk][mm] = vi;
      }
      for (int e = tid; e < BK * BN; e += NT) {
        const int kk = e / BN, nn = e % BN;
        const long long n = n0 + nn;
        const int k = k0 + kk;
        float vr = 0.f, vi = 0.f;
        if (n < p.N && k < p.K) {
          const long long off = ob + at(p.b_k, k) + at(p.b_n, n);
          vr = load<B_IN>(p.br, off);
          vi = load<B_IN>(p.bi, off);
        }
        bsr[kk][nn] = vr;
        bsi[kk][nn] = vi;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a_r[TM], a_i[TM], b_r[TN], b_i[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          a_r[i] = asr[kk][ty + 16 * i];
          a_i[i] = asi[kk][ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          b_r[j] = bsr[kk][tx + 16 * j];
          b_i[j] = bsi[kk][tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            accr[i][j] = fmaf(a_r[i], b_r[j], accr[i][j]);
            accr[i][j] = fmaf(-a_i[i], b_i[j], accr[i][j]);
            acci[i][j] = fmaf(a_r[i], b_i[j], acci[i][j]);
            acci[i][j] = fmaf(a_i[i], b_r[j], acci[i][j]);
          }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const long long m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
        if (m >= p.M || n >= p.N) continue;
        float r = accr[i][j], im = acci[i][j];
        if (p.tr != nullptr) {
          const long long to = at(p.t_m, m) + at(p.t_n, n);
          const float wr = p.tr[to], wi = p.ti[to];
          const float nr = r * wr - im * wi;
          im = r * wi + im * wr;
          r = nr;
        }
        const long long off = oc + at(p.c_m, m) + at(p.c_n, n);
        if constexpr (EPI == EPI_BF16) {
          reinterpret_cast<unsigned short*>(p.cr)[off] = f32_to_bf16(r * p.scale);
          reinterpret_cast<unsigned short*>(p.ci)[off] = f32_to_bf16(im * p.scale);
        } else if constexpr (EPI == EPI_ROUND) {
          p.cr[off] = round_bf16(r * p.scale);
          p.ci[off] = round_bf16(im * p.scale);
        } else if constexpr (EPI == EPI_F16) {
          reinterpret_cast<unsigned short*>(p.cr)[off] = f32_to_f16(r * p.scale);
          reinterpret_cast<unsigned short*>(p.ci)[off] = f32_to_f16(im * p.scale);
        } else if constexpr (EPI == EPI_ROUND_F16) {
          p.cr[off] = f16_to_f32(f32_to_f16(r * p.scale));
          p.ci[off] = f16_to_f32(f32_to_f16(im * p.scale));
        } else {
          p.cr[off] = r * p.scale;
          p.ci[off] = im * p.scale;
        }
      }
  }
}

// The epilogues an operand kind pairs with: fp32 operands with every one
// (a later GEMM of a chain), bf16 with the bf16 ones, float16 with the
// float16 ones.
template <int A_IN, int B_IN>
inline cudaError_t run(const Params& p, int epi, dim3 grid,
                       cudaStream_t stream) {
  constexpr int half = A_IN != IN_F32 ? A_IN : B_IN;
  switch (epi) {
    case EPI_F32:
      cgemm_kernel<A_IN, B_IN, EPI_F32><<<grid, NT, 0, stream>>>(p);
      break;
    case EPI_ROUND:
    case EPI_BF16:
      if constexpr (half == IN_F16) return cudaErrorInvalidValue;
      if (epi == EPI_ROUND)
        cgemm_kernel<A_IN, B_IN, EPI_ROUND><<<grid, NT, 0, stream>>>(p);
      else
        cgemm_kernel<A_IN, B_IN, EPI_BF16><<<grid, NT, 0, stream>>>(p);
      break;
    case EPI_ROUND_F16:
    case EPI_F16:
      if constexpr (half == IN_BF16) return cudaErrorInvalidValue;
      if (epi == EPI_ROUND_F16)
        cgemm_kernel<A_IN, B_IN, EPI_ROUND_F16><<<grid, NT, 0, stream>>>(p);
      else
        cgemm_kernel<A_IN, B_IN, EPI_F16><<<grid, NT, 0, stream>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Launch on `stream`; returns cudaGetLastError() of the launch.
inline cudaError_t launch(const Params& p, cudaStream_t stream,
                          const Io& io = Io{}) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.batch <= 0) return cudaErrorInvalidValue;
  const long long tiles = ((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN);
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  const unsigned gy = (unsigned)(p.batch < 65535 ? p.batch : 65535);
  const dim3 grid((unsigned)tiles, gy);
  if (io.a_in != IN_F32 && io.b_in != IN_F32) return cudaErrorInvalidValue;
  switch (io.a_in * 3 + io.b_in) {
    case IN_F32 * 3 + IN_F32: return run<IN_F32, IN_F32>(p, io.epi, grid, stream);
    case IN_BF16 * 3 + IN_F32: return run<IN_BF16, IN_F32>(p, io.epi, grid, stream);
    case IN_F16 * 3 + IN_F32: return run<IN_F16, IN_F32>(p, io.epi, grid, stream);
    case IN_F32 * 3 + IN_BF16: return run<IN_F32, IN_BF16>(p, io.epi, grid, stream);
    case IN_F32 * 3 + IN_F16: return run<IN_F32, IN_F16>(p, io.epi, grid, stream);
  }
  return cudaErrorInvalidValue;
}

inline int log2i(long long v) {
  int s = 0;
  while ((1LL << s) < v) ++s;
  return s;
}

// A params record with no epilogue twiddle, unit scale, no batch.
inline Params base() {
  Params p{};
  p.tr = p.ti = nullptr;
  p.batch = 1;
  p.a_z = p.b_z = p.c_z = lin(0);
  p.t_m = p.t_n = lin(0);
  p.scale = 1.f;
  return p;
}

}  // namespace cg

// Naive CPU twin of src/repro_torch/kernels/csrc/cgemm.cuh for emulate.py:
// the same Idx/Params/Io layout and semantics (bf16 and float16 operands
// widened and epilogues rounded with the real bf16.cuh and f16.cuh), one
// plain triple loop in
// place of the tiled kernel, summing in the tiled kernel's order.  Keep it
// in step with cgemm.cuh's host interface.
#pragma once
#include <cuda_runtime.h>
#include "bf16.cuh"
#include "f16.cuh"
namespace cg {
struct Idx { int shift; long long hi, lo; };
inline Idx lin(long long stride) { return Idx{62, 0, stride}; }
inline Idx two(int shift, long long hi, long long lo) { return Idx{shift, hi, lo}; }
inline long long at(const Idx& d, long long i) {
  return (i >> d.shift) * d.hi + (i & ((1LL << d.shift) - 1)) * d.lo;
}
struct Params {
  const float *ar, *ai, *br, *bi;
  float *cr, *ci;
  const float *tr, *ti;
  long long M, N, batch;
  int K;
  Idx a_m, a_k, b_k, b_n, c_m, c_n, t_m, t_n;
  Idx a_z, b_z, c_z;
  float scale;
};
enum In { IN_F32 = 0, IN_BF16 = 1, IN_F16 = 2 };
enum Epi { EPI_F32 = 0, EPI_ROUND = 1, EPI_BF16 = 2, EPI_ROUND_F16 = 3, EPI_F16 = 4 };
struct Io { int a_in = IN_F32, b_in = IN_F32; int epi = EPI_F32; };
inline float load(const float* base, long long off, int in) {
  const unsigned short h = reinterpret_cast<const unsigned short*>(base)[off];
  return in == IN_BF16 ? bf16_to_f32(h) : in == IN_F16 ? f16_to_f32(h) : base[off];
}
inline cudaError_t launch(const Params& p, cudaStream_t, const Io& io = Io{}) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.batch <= 0) return cudaErrorInvalidValue;
  if ((io.a_in != IN_F32 && io.b_in != IN_F32) || io.epi < EPI_F32 || io.epi > EPI_F16) return cudaErrorInvalidValue;
  for (long long z = 0; z < p.batch; ++z) {
    const long long oa = at(p.a_z, z), ob = at(p.b_z, z), oc = at(p.c_z, z);
    for (long long m = 0; m < p.M; ++m)
      for (long long n = 0; n < p.N; ++n) {
        float r = 0.f, im = 0.f;
        for (int k = 0; k < p.K; ++k) {
          const long long a = oa + at(p.a_m, m) + at(p.a_k, k);
          const long long b = ob + at(p.b_k, k) + at(p.b_n, n);
          const float ar = load(p.ar, a, io.a_in), ai = load(p.ai, a, io.a_in);
          const float br = load(p.br, b, io.b_in), bi = load(p.bi, b, io.b_in);
          r = fmaf(ar, br, r); r = fmaf(-ai, bi, r);
          im = fmaf(ar, bi, im); im = fmaf(ai, br, im);
        }
        if (p.tr != nullptr) {
          const long long to = at(p.t_m, m) + at(p.t_n, n);
          const float wr = p.tr[to], wi = p.ti[to];
          const float nr = r * wr - im * wi;
          im = r * wi + im * wr; r = nr;
        }
        const long long off = oc + at(p.c_m, m) + at(p.c_n, n);
        if (io.epi == EPI_BF16) {
          reinterpret_cast<unsigned short*>(p.cr)[off] = f32_to_bf16(r * p.scale);
          reinterpret_cast<unsigned short*>(p.ci)[off] = f32_to_bf16(im * p.scale);
        } else if (io.epi == EPI_ROUND) {
          p.cr[off] = round_bf16(r * p.scale); p.ci[off] = round_bf16(im * p.scale);
        } else if (io.epi == EPI_F16) {
          reinterpret_cast<unsigned short*>(p.cr)[off] = f32_to_f16(r * p.scale);
          reinterpret_cast<unsigned short*>(p.ci)[off] = f32_to_f16(im * p.scale);
        } else if (io.epi == EPI_ROUND_F16) {
          p.cr[off] = f16_to_f32(f32_to_f16(r * p.scale));
          p.ci[off] = f16_to_f32(f32_to_f16(im * p.scale));
        } else {
          p.cr[off] = r * p.scale; p.ci[off] = im * p.scale;
        }
      }
  }
  return cudaSuccess;
}
inline int log2i(long long v) { int s = 0; while ((1LL << s) < v) ++s; return s; }
inline Params base() {
  Params p{}; p.tr = p.ti = nullptr; p.batch = 1;
  p.a_z = p.b_z = p.c_z = lin(0); p.t_m = p.t_n = lin(0); p.scale = 1.f;
  return p;
}
}  // namespace cg

// Naive CPU twin of src/repro_torch/kernels/csrc/cgemm.cuh for emulate.py:
// the same Idx/Params layout and semantics, one plain triple loop in place
// of the tiled kernel.  Keep it in step with cgemm.cuh's host interface.
#pragma once
#include <cuda_runtime.h>
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
inline cudaError_t launch(const Params& p, cudaStream_t) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.batch <= 0) return cudaErrorInvalidValue;
  for (long long z = 0; z < p.batch; ++z) {
    const long long oa = at(p.a_z, z), ob = at(p.b_z, z), oc = at(p.c_z, z);
    for (long long m = 0; m < p.M; ++m)
      for (long long n = 0; n < p.N; ++n) {
        float r = 0.f, im = 0.f;
        for (int k = 0; k < p.K; ++k) {
          const long long a = oa + at(p.a_m, m) + at(p.a_k, k);
          const long long b = ob + at(p.b_k, k) + at(p.b_n, n);
          r = fmaf(p.ar[a], p.br[b], r); r = fmaf(-p.ai[a], p.bi[b], r);
          im = fmaf(p.ar[a], p.bi[b], im); im = fmaf(p.ai[a], p.br[b], im);
        }
        if (p.tr != nullptr) {
          const long long to = at(p.t_m, m) + at(p.t_n, n);
          const float wr = p.tr[to], wi = p.ti[to];
          const float nr = r * wr - im * wi;
          im = r * wi + im * wr; r = nr;
        }
        const long long off = oc + at(p.c_m, m) + at(p.c_n, n);
        p.cr[off] = r * p.scale; p.ci[off] = im * p.scale;
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

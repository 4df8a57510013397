// 1-D Bailey four-step FFT, n = n1 * n2, on (batch, n) split fp32 planes.
//
// Replaces the Pallas kernel repro/kernels/fft_fourstep.py::_fourstep_kernel.
// Two launches of the tiled complex GEMM (cgemm.cuh) on the current stream:
//   (1) B = W1 @ A with the batch folded into the columns
//       (A[a, (b, j2)] = x[b*n + a*n2 + j2]), the twiddle T[k1, j2] applied
//       in the epilogue, written to scratch in the input's layout;
//   (2) D = C @ W2 over the (b, k1) rows, written straight into the output
//       order X[b*n + k2*n1 + k1], scaled by 1/n for the inverse.
// Bound on the card: fp32 operations (8*n*(n1+n2) per row), since at
// n = 2^20 each DFT table is 1024x1024 and must be streamed through shared
// memory tiles.  The scratch round trip between the two GEMMs is the cost
// of this simple design.
#include "cgemm.cuh"

extern "C" int fft_fourstep_f32(const float* xr, const float* xi,
                                float* outr, float* outi,
                                float* sr, float* si,
                                const float* w1r, const float* w1i,
                                const float* w2r, const float* w2i,
                                const float* tr, const float* ti,
                                long long batch, int n1, int n2, int inverse,
                                void* stream) {
  using namespace cg;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)n1 * n2;
  const int l1 = log2i(n1), l2 = log2i(n2);
  if ((1LL << l1) != n1 || (1LL << l2) != n2 || batch <= 0) return (int)cudaErrorInvalidValue;

  Params p = base();  // (1) left contraction over a, twiddle epilogue
  p.ar = w1r; p.ai = w1i; p.a_m = lin(n1); p.a_k = lin(1);
  p.br = xr;  p.bi = xi;  p.b_k = lin(n2); p.b_n = two(l2, n, 1);
  p.cr = sr;  p.ci = si;  p.c_m = lin(n2); p.c_n = two(l2, n, 1);
  p.tr = tr;  p.ti = ti;  p.t_m = lin(n2); p.t_n = two(l2, 0, 1);
  p.M = n1; p.K = n1; p.N = batch * n2;
  cudaError_t e = launch(p, s);
  if (e != cudaSuccess) return (int)e;

  Params q = base();  // (2) right contraction over j2, reordered store
  q.ar = sr;  q.ai = si;  q.a_m = lin(n2); q.a_k = lin(1);
  q.br = w2r; q.bi = w2i; q.b_k = lin(n2); q.b_n = lin(1);
  q.cr = outr; q.ci = outi; q.c_m = two(l1, n, 1); q.c_n = lin(n1);
  q.M = batch * n1; q.K = n2; q.N = n2;
  q.scale = inverse ? (float)(1.0 / (double)n) : 1.f;
  e = launch(q, s);
  return (int)e;
}

// The four-step row pass shared by fft2d_gemm.cu and rfft2d_fused.cu: a
// length-n complex FFT of every row as launches of the tiled GEMM
// (cgemm.cuh), with source and destination row strides as parameters.
//   n1 > 1:  U = W1 @ X with the rows folded into the columns and the
//            twiddle T[k1, j2] in the epilogue, then Z = U @ W2 stored as
//            X[k2*n1 + k1];
//   n1 == 1: Z = X @ W, one dense DFT per row.
// Host code only: the GEMM kernel itself is unchanged.
#pragma once
#include "cgemm.cuh"

namespace cg {

// One axis' four-step tables: W1 (n1, n1), W2 (n2, n2) (the dense DFT when
// n1 == 1), the twiddle T (n1, n2), and, for rfft2d_fused's column pass,
// n2 copies of W1 with the twiddle folded in (nullptr elsewhere).
struct Axis {
  int n, n1, n2;
  const float *w1r, *w1i, *w2r, *w2i, *tr, *ti;
  const float *vr = nullptr, *vi = nullptr;
};

// Length-n FFT of `rows` rows: source row r at (sr, si) + r*ss, destination
// row r at (dr, di) + r*ds, through the scratch pair (tr, ti) of rows*n
// points in natural layout (unused when n1 == 1); the last GEMM is scaled
// by `scale`.  Returns the first failing launch's error.
inline cudaError_t row_pass(const float* sr, const float* si, long long ss,
                            float* dr, float* di, long long ds, float* tr,
                            float* ti, long long rows, const Axis& a,
                            float scale, cudaStream_t stream) {
  const int w = a.n;
  if (a.n1 > 1) {
    const int l1 = log2i(a.n1), l2 = log2i(a.n2);
    Params p = base();  // U = W1 @ X, the rows folded into the columns
    p.ar = a.w1r; p.ai = a.w1i; p.a_m = lin(a.n1); p.a_k = lin(1);
    p.br = sr; p.bi = si; p.b_k = lin(a.n2); p.b_n = two(l2, ss, 1);
    p.cr = tr; p.ci = ti; p.c_m = lin(a.n2); p.c_n = two(l2, w, 1);
    p.tr = a.tr; p.ti = a.ti; p.t_m = lin(a.n2); p.t_n = two(l2, 0, 1);
    p.M = a.n1; p.K = a.n1; p.N = rows * a.n2;
    const cudaError_t e = launch(p, stream);
    if (e != cudaSuccess) return e;
    Params q = base();  // Z = U @ W2, stored as X[k2*n1 + k1]
    q.ar = tr; q.ai = ti; q.a_m = lin(a.n2); q.a_k = lin(1);
    q.br = a.w2r; q.bi = a.w2i; q.b_k = lin(a.n2); q.b_n = lin(1);
    q.cr = dr; q.ci = di; q.c_m = two(l1, ds, 1); q.c_n = lin(a.n1);
    q.M = rows * a.n1; q.K = a.n2; q.N = a.n2;
    q.scale = scale;
    return launch(q, stream);
  }
  Params p = base();  // one dense DFT per row: Z = X @ W
  p.ar = sr; p.ai = si; p.a_m = lin(ss); p.a_k = lin(1);
  p.br = a.w2r; p.bi = a.w2i; p.b_k = lin(w); p.b_n = lin(1);
  p.cr = dr; p.ci = di; p.c_m = lin(ds); p.c_n = lin(1);
  p.M = rows; p.K = w; p.N = w;
  p.scale = scale;
  return launch(p, stream);
}

}  // namespace cg

// The four-step passes shared by fft2d_gemm.cu and fft3d_fused.cu, as
// launches of the tiled GEMM (cgemm.cuh):
//   row_pass  a length-n complex FFT of every row, source and destination
//             row strides as parameters:
//               n1 > 1:  U = W1 @ X with the rows folded into the columns
//                        and the twiddle T[k1, j2] in the epilogue, then
//                        Z = U @ W2 stored as X[k2*n1 + k1];
//               n1 == 1: Z = X @ W, one dense DFT per row;
//   col_pass  a length-n FFT along axis -2 of images of (n, c) points, as
//             left-side contractions, so no transpose is materialised:
//               n1 > 1:  U = W1 @ Y along the axis (twiddle T[k1, j2]
//                        broadcast over the c columns), then Z = W2 @ U
//                        per (image, k1) stored at rows k2*n1 + k1;
//               n1 == 1: Z = W @ Y per image.
// Host code only.  The bf16 and float16 storage modes of the GEMM
// transforms pick the GEMM's operand types and epilogues pass by pass
// (pass_io).
#pragma once
#include "cgemm.cuh"

namespace cg {

// One axis' four-step tables: W1 (n1, n1), W2 (n2, n2) (the dense DFT when
// n1 == 1) and the twiddle T (n1, n2).
struct Axis {
  int n, n1, n2;
  const float *w1r, *w1i, *w2r, *w2i, *tr, *ti;
};

// How a pass reads and stores: `in` its source's kind (In), `mid` the
// epilogue of its first GEMM when it has two, `out` that of its last.
struct PassIo {
  int in = IN_F32;
  int mid = EPI_F32, out = EPI_F32;
};

// The storage modes of the GEMM transforms (fft2d_gemm.cu, fft3d_fused.cu):
//   MODE_F32          fp32 in, between the steps and out;
//   MODE_COMPENSATED  bf16 in; fp32 within a pass; the tile rounded through
//                     bf16 between passes; bf16 out;
//   MODE_PLAIN_BF16   bf16 in; every GEMM's output rounded through bf16;
//                     bf16 out;
//   MODE_PLAIN_F16    the same in float16.
enum Mode {
  MODE_F32 = 0, MODE_COMPENSATED = 1, MODE_PLAIN_BF16 = 2, MODE_PLAIN_F16 = 3
};

// The PassIo of pass i of n in `mode`.
inline PassIo pass_io(int mode, int i, int n) {
  PassIo io;
  if (mode == MODE_F32) return io;
  const bool f16 = mode == MODE_PLAIN_F16;
  const int round = f16 ? EPI_ROUND_F16 : EPI_ROUND;
  io.in = i == 0 ? (f16 ? IN_F16 : IN_BF16) : IN_F32;
  io.mid = mode == MODE_COMPENSATED ? EPI_F32 : round;
  io.out = i == n - 1 ? (f16 ? EPI_F16 : EPI_BF16) : round;
  return io;
}

inline int steps(const Axis& a) { return a.n1 > 1 ? 2 : 1; }

// The destinations of a chain of k GEMM launches: launch i (from 0) writes
// out when it is the last, else f1 when k - 1 - i is odd and f0 when it is
// even, so consecutive launches never share a buffer.  An fp32 transform
// passes out as f0; a bf16 one (whose out holds bf16) two fp32 scratch
// buffers.
struct Chain {
  float *outr, *outi, *f0r, *f0i, *f1r, *f1i;
  int k, i = 0;
  void next(float*& r, float*& im) {
    const int left = k - 1 - i++;
    if (left == 0) {
      r = outr; im = outi;
    } else if (left & 1) {
      r = f1r; im = f1i;
    } else {
      r = f0r; im = f0i;
    }
  }
};

// Length-n FFT of `rows` rows: source row r at (sr, si) + r*ss, destination
// row r at (dr, di) + r*ds, through the scratch pair (tr, ti) of rows*n
// points in natural layout (unused when n1 == 1); the last GEMM is scaled
// by `scale`.  Returns the first failing launch's error.
inline cudaError_t row_pass(const float* sr, const float* si, long long ss,
                            float* dr, float* di, long long ds, float* tr,
                            float* ti, long long rows, const Axis& a,
                            float scale, cudaStream_t stream,
                            const PassIo& io = PassIo{}) {
  const int w = a.n;
  if (a.n1 > 1) {
    const int l1 = log2i(a.n1), l2 = log2i(a.n2);
    Params p = base();  // U = W1 @ X, the rows folded into the columns
    p.ar = a.w1r; p.ai = a.w1i; p.a_m = lin(a.n1); p.a_k = lin(1);
    p.br = sr; p.bi = si; p.b_k = lin(a.n2); p.b_n = two(l2, ss, 1);
    p.cr = tr; p.ci = ti; p.c_m = lin(a.n2); p.c_n = two(l2, w, 1);
    p.tr = a.tr; p.ti = a.ti; p.t_m = lin(a.n2); p.t_n = two(l2, 0, 1);
    p.M = a.n1; p.K = a.n1; p.N = rows * a.n2;
    const cudaError_t e = launch(p, stream, Io{IN_F32, io.in, io.mid});
    if (e != cudaSuccess) return e;
    Params q = base();  // Z = U @ W2, stored as X[k2*n1 + k1]
    q.ar = tr; q.ai = ti; q.a_m = lin(a.n2); q.a_k = lin(1);
    q.br = a.w2r; q.bi = a.w2i; q.b_k = lin(a.n2); q.b_n = lin(1);
    q.cr = dr; q.ci = di; q.c_m = two(l1, ds, 1); q.c_n = lin(a.n1);
    q.M = rows * a.n1; q.K = a.n2; q.N = a.n2;
    q.scale = scale;
    return launch(q, stream, Io{IN_F32, IN_F32, io.out});
  }
  Params p = base();  // one dense DFT per row: Z = X @ W
  p.ar = sr; p.ai = si; p.a_m = lin(ss); p.a_k = lin(1);
  p.br = a.w2r; p.bi = a.w2i; p.b_k = lin(w); p.b_n = lin(1);
  p.cr = dr; p.ci = di; p.c_m = lin(ds); p.c_n = lin(1);
  p.M = rows; p.K = w; p.N = w;
  p.scale = scale;
  return launch(p, stream, Io{io.in, IN_F32, io.out});
}

// Length-n FFT along axis -2 of `images` images of (n, c) points, image z
// at (sr, si) + z*n*c, into (dr, di) in the same layout, through the
// scratch pair (tr, ti) (unused when n1 == 1); the last GEMM is scaled by
// `scale`.  c is a power of two.  Returns the first failing launch's error.
inline cudaError_t col_pass(const float* sr, const float* si, float* dr,
                            float* di, float* tr, float* ti,
                            long long images, long long c, const Axis& a,
                            float scale, cudaStream_t stream,
                            const PassIo& io = PassIo{}) {
  const long long img = (long long)a.n * c;
  if (a.n1 > 1) {
    const long long cols = (long long)a.n2 * c;  // the (j2, c) free dim
    const int l1 = log2i(a.n1), lc = log2i(c);
    Params p = base();  // U = W1 @ Y along the axis, twiddle T[k1, j2]
    p.ar = a.w1r; p.ai = a.w1i; p.a_m = lin(a.n1); p.a_k = lin(1);
    p.br = sr; p.bi = si; p.b_k = lin(cols); p.b_n = lin(1); p.b_z = lin(img);
    p.cr = tr; p.ci = ti; p.c_m = lin(cols); p.c_n = lin(1); p.c_z = lin(img);
    p.tr = a.tr; p.ti = a.ti; p.t_m = lin(a.n2); p.t_n = two(lc, 1, 0);
    p.M = a.n1; p.K = a.n1; p.N = cols; p.batch = images;
    const cudaError_t e = launch(p, stream, Io{IN_F32, io.in, io.mid});
    if (e != cudaSuccess) return e;
    Params q = base();  // Z = W2 @ U per (image, k1), rows k2*n1 + k1
    q.ar = a.w2r; q.ai = a.w2i; q.a_m = lin(a.n2); q.a_k = lin(1);
    q.br = tr; q.bi = ti; q.b_k = lin(c); q.b_n = lin(1);
    q.b_z = two(l1, img, cols);
    q.cr = dr; q.ci = di; q.c_m = lin((long long)a.n1 * c);
    q.c_n = lin(1); q.c_z = two(l1, img, c);
    q.M = a.n2; q.K = a.n2; q.N = c; q.batch = images * a.n1;
    q.scale = scale;
    return launch(q, stream, Io{IN_F32, IN_F32, io.out});
  }
  Params p = base();  // one dense DFT per image: Z = W @ Y
  p.ar = a.w2r; p.ai = a.w2i; p.a_m = lin(a.n); p.a_k = lin(1);
  p.br = sr; p.bi = si; p.b_k = lin(c); p.b_n = lin(1); p.b_z = lin(img);
  p.cr = dr; p.ci = di; p.c_m = lin(c); p.c_n = lin(1); p.c_z = lin(img);
  p.M = a.n; p.K = a.n; p.N = c; p.batch = images;
  p.scale = scale;
  return launch(p, stream, Io{IN_F32, io.in, io.out});
}

}  // namespace cg

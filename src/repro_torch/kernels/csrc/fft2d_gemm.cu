// Batched complex 2-D FFT over (batch, h, w) split fp32 planes as four-step
// GEMM passes: a row pass along w, then a column pass along h done as
// left-side contractions, so no transpose is ever materialised.
//
// Replaces the Pallas kernel repro/kernels/fft2d_gemm.py::_fft2d_gemm_kernel
// (variant="plain").  The TPU kernel holds a whole image in VMEM; a 1024^2
// fp32 image is 8 MB against 227 KB of shared memory per block, and the
// dense-leaf table (n <= 256, one 256x256 DFT) is itself 512 KB, so here
// each four-step step is one launch of the tiled complex GEMM (cgemm.cuh),
// chained through one scratch buffer and the output (ping-pong):
//   row pass    n1 > 1: U = W1 @ X (batch folded into columns, twiddle
//               epilogue), then Z = U @ W2 stored as X[k2*n1 + k1];
//               n1 == 1: Z = X @ W (one dense DFT per row);
//   column pass n1 > 1: U = W1 @ Y along axis -2 (twiddle T[k1, j2]
//               broadcast over columns), then Z = W2 @ U per (image, k1)
//               stored at rows k2*n1 + k1;  n1 == 1: Z = W @ Y per image.
// The unscaled tables take one 1/(h*w) in the last step's epilogue.
// Bound on the card: fp32 operations (8*n*(n1+n2) per row and column);
// the HBM round trips between steps (up to three) are the known cost of
// this design, and fusing them is later work.
#include "cgemm.cuh"

namespace {

struct Buf {
  const float* r;
  const float* i;
};

struct Axis {
  int n, n1, n2;
  const float *w1r, *w1i, *w2r, *w2i, *tr, *ti;
};

}  // namespace

extern "C" int fft2d_gemm_f32(const float* xr, const float* xi,
                              float* outr, float* outi,
                              float* sr, float* si,
                              const float* w1wr, const float* w1wi,
                              const float* w2wr, const float* w2wi,
                              const float* twr, const float* twi,
                              const float* w1hr, const float* w1hi,
                              const float* w2hr, const float* w2hi,
                              const float* thr, const float* thi,
                              long long batch, int h, int w,
                              int n1w, int n1h, int inverse, void* stream) {
  using namespace cg;
  cudaStream_t s = (cudaStream_t)stream;
  if (batch <= 0 || h < 2 || w < 2 || (h & (h - 1)) || (w & (w - 1)) ||
      n1w < 1 || n1h < 1 || w % n1w || h % n1h)
    return (int)cudaErrorInvalidValue;
  const Axis aw{w, n1w, w / n1w, w1wr, w1wi, w2wr, w2wi, twr, twi};
  const Axis ah{h, n1h, h / n1h, w1hr, w1hi, w2hr, w2hi, thr, thi};
  const long long hw = (long long)h * w;
  const long long rows = batch * h;
  const int lw = log2i(w), l1w = log2i(aw.n1), l2w = log2i(aw.n2);
  const int l1h = log2i(ah.n1);

  // the GEMM steps in order; the last one carries the 1/(h*w) scale
  Params steps[4];
  int ns = 0;
  if (aw.n1 > 1) {
    Params p = base();
    p.ar = aw.w1r; p.ai = aw.w1i; p.a_m = lin(aw.n1); p.a_k = lin(1);
    p.b_k = lin(aw.n2); p.b_n = two(l2w, w, 1);
    p.c_m = lin(aw.n2); p.c_n = two(l2w, w, 1);
    p.tr = aw.tr; p.ti = aw.ti; p.t_m = lin(aw.n2); p.t_n = two(l2w, 0, 1);
    p.M = aw.n1; p.K = aw.n1; p.N = rows * aw.n2;
    steps[ns++] = p;
    Params q = base();
    q.a_m = lin(aw.n2); q.a_k = lin(1);
    q.br = aw.w2r; q.bi = aw.w2i; q.b_k = lin(aw.n2); q.b_n = lin(1);
    q.c_m = two(l1w, w, 1); q.c_n = lin(aw.n1);
    q.M = rows * aw.n1; q.K = aw.n2; q.N = aw.n2;
    steps[ns++] = q;
  } else {
    Params p = base();
    p.a_m = lin(w); p.a_k = lin(1);
    p.br = aw.w2r; p.bi = aw.w2i; p.b_k = lin(w); p.b_n = lin(1);
    p.c_m = lin(w); p.c_n = lin(1);
    p.M = rows; p.K = w; p.N = w;
    steps[ns++] = p;
  }
  if (ah.n1 > 1) {
    const long long cols = (long long)ah.n2 * w;  // the (j2, c) free dim
    Params p = base();
    p.ar = ah.w1r; p.ai = ah.w1i; p.a_m = lin(ah.n1); p.a_k = lin(1);
    p.b_k = lin(cols); p.b_n = lin(1); p.b_z = lin(hw);
    p.c_m = lin(cols); p.c_n = lin(1); p.c_z = lin(hw);
    p.tr = ah.tr; p.ti = ah.ti; p.t_m = lin(ah.n2); p.t_n = two(lw, 1, 0);
    p.M = ah.n1; p.K = ah.n1; p.N = cols; p.batch = batch;
    steps[ns++] = p;
    Params q = base();
    q.ar = ah.w2r; q.ai = ah.w2i; q.a_m = lin(ah.n2); q.a_k = lin(1);
    q.b_k = lin(w); q.b_n = lin(1); q.b_z = two(l1h, hw, cols);
    q.c_m = lin((long long)ah.n1 * w); q.c_n = lin(1); q.c_z = two(l1h, hw, w);
    q.M = ah.n2; q.K = ah.n2; q.N = w; q.batch = batch * ah.n1;
    steps[ns++] = q;
  } else {
    Params p = base();
    p.ar = ah.w2r; p.ai = ah.w2i; p.a_m = lin(h); p.a_k = lin(1);
    p.b_k = lin(w); p.b_n = lin(1); p.b_z = lin(hw);
    p.c_m = lin(w); p.c_n = lin(1); p.c_z = lin(hw);
    p.M = h; p.K = h; p.N = w; p.batch = batch;
    steps[ns++] = p;
  }
  steps[ns - 1].scale = inverse ? (float)(1.0 / (double)hw) : 1.f;

  // data operands: step 0 reads x; step i writes the buffer that makes the
  // last step land in out, alternating out <-> scratch
  float* dst_r[2] = {outr, sr};
  float* dst_i[2] = {outi, si};
  Buf src{xr, xi};
  for (int i = 0; i < ns; ++i) {
    Params& p = steps[i];
    const int d = (ns - 1 - i) % 2;
    // the data operand is A on the row pass' right contraction and dense
    // leaf (a table sits in B there), and B everywhere else
    if (p.ar == nullptr) { p.ar = src.r; p.ai = src.i; }
    else { p.br = src.r; p.bi = src.i; }
    p.cr = dst_r[d];
    p.ci = dst_i[d];
    const cudaError_t e = launch(p, s);
    if (e != cudaSuccess) return (int)e;
    src = Buf{dst_r[d], dst_i[d]};
  }
  return (int)cudaSuccess;
}

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
//   row pass    the four-step row pass of row_pass.cuh, shared with
//               rfft2d_fused.cu;
//   column pass n1 > 1: U = W1 @ Y along axis -2 (twiddle T[k1, j2]
//               broadcast over columns), then Z = W2 @ U per (image, k1)
//               stored at rows k2*n1 + k1;  n1 == 1: Z = W @ Y per image.
// The unscaled tables take one 1/(h*w) in the last step's epilogue.
// Bound on the card: fp32 operations (8*n*(n1+n2) per row and column);
// the HBM round trips between steps (up to three) are the known cost of
// this design, and fusing them is later work.
#include "row_pass.cuh"

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
  const int lw = log2i(w), l1h = log2i(ah.n1);
  const float scale = inverse ? (float)(1.0 / (double)hw) : 1.f;

  // buffers: the column pass must end in out, so with two column steps
  // (Y -> scratch -> out) the row pass lands in out, with one (Y -> out)
  // it lands in scratch; its own intermediate takes the other buffer
  const bool col2 = ah.n1 > 1;
  float* yr = col2 ? outr : sr;
  float* yi = col2 ? outi : si;
  cudaError_t e = row_pass(xr, xi, w, yr, yi, w, col2 ? sr : outr,
                           col2 ? si : outi, batch * h, aw, 1.f, s);
  if (e != cudaSuccess) return (int)e;
  if (col2) {
    const long long cols = (long long)ah.n2 * w;  // the (j2, c) free dim
    Params p = base();  // U = W1 @ Y along axis -2, twiddle T[k1, j2]
    p.ar = ah.w1r; p.ai = ah.w1i; p.a_m = lin(ah.n1); p.a_k = lin(1);
    p.br = yr; p.bi = yi; p.b_k = lin(cols); p.b_n = lin(1); p.b_z = lin(hw);
    p.cr = sr; p.ci = si; p.c_m = lin(cols); p.c_n = lin(1); p.c_z = lin(hw);
    p.tr = ah.tr; p.ti = ah.ti; p.t_m = lin(ah.n2); p.t_n = two(lw, 1, 0);
    p.M = ah.n1; p.K = ah.n1; p.N = cols; p.batch = batch;
    e = launch(p, s);
    if (e != cudaSuccess) return (int)e;
    Params q = base();  // Z = W2 @ U per (image, k1), rows k2*n1 + k1
    q.ar = ah.w2r; q.ai = ah.w2i; q.a_m = lin(ah.n2); q.a_k = lin(1);
    q.br = sr; q.bi = si; q.b_k = lin(w); q.b_n = lin(1);
    q.b_z = two(l1h, hw, cols);
    q.cr = outr; q.ci = outi; q.c_m = lin((long long)ah.n1 * w);
    q.c_n = lin(1); q.c_z = two(l1h, hw, w);
    q.M = ah.n2; q.K = ah.n2; q.N = w; q.batch = batch * ah.n1;
    q.scale = scale;
    return (int)launch(q, s);
  }
  Params p = base();  // one dense DFT per image: Z = W @ Y
  p.ar = ah.w2r; p.ai = ah.w2i; p.a_m = lin(h); p.a_k = lin(1);
  p.br = yr; p.bi = yi; p.b_k = lin(w); p.b_n = lin(1); p.b_z = lin(hw);
  p.cr = outr; p.ci = outi; p.c_m = lin(w); p.c_n = lin(1); p.c_z = lin(hw);
  p.M = h; p.K = h; p.N = w; p.batch = batch;
  p.scale = scale;
  return (int)launch(p, s);
}

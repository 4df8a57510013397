// Batched complex 3-D FFT over (batch, d, h, w) split planes as three
// four-step GEMM passes, no relayout materialised:
//   W pass  row_pass over the batch*d*h rows of w points;
//   H pass  col_pass along axis -2 of the batch*d images of (h, w);
//   D pass  col_pass along axis -3, i.e. along axis -2 of the batch images
//           viewed as (d, h*w): the TPU kernel's (bb, d, h*w) reshape.
// Each axis splits by fourstep_factors3 (a dense DFT at n <= 128).
//
// Replaces the Pallas kernel repro/kernels/fft3d_fused.py::_fft3d_kernel
// (both variants).  The TPU kernel keeps a (bb, d, h, w) brick in VMEM; a
// 256^3 fp32 brick is 128 MB against 227 KB of shared memory per block, so
// here, as in fft2d_gemm.cu, each four-step step is one launch of the tiled
// complex GEMM (cgemm.cuh) chained through fp32 buffers (row_pass.cuh's
// Chain), up to six launches with the last one landing in out and carrying
// the inverse's 1/(d*h*w).  Storage modes as in fft2d_gemm.cu: in bf16 the
// tile is rounded through bf16 at the W->H and H->D boundaries
// (compensated) or after every GEMM (plain).
// Bound on the card: the transform is bound by bytes (16 per complex fp32
// point in and out), but the method does 8*(n1+n2) flops a point an axis
// on the CUDA cores, and the 16-wide factors at 256 fill a quarter of each
// 64x64 GEMM tile, so this design is bound by those fp32 operations and
// the HBM round trips between its launches.
#include "row_pass.cuh"

// x (batch, d, h, w) -> out, fp32 planes or raw bf16 ones (mode); the fp32
// buffer pairs f0 and f1 hold batch*d*h*w floats a plane (fp32: f0 is
// out).  The 18 tables are the W, H and D axes' four-step tables.
extern "C" int fft3d_fused(const void* xr, const void* xi, void* outr,
                           void* outi, float* f0r, float* f0i, float* f1r,
                           float* f1i,
                           const float* w1wr, const float* w1wi,
                           const float* w2wr, const float* w2wi,
                           const float* twr, const float* twi,
                           const float* w1hr, const float* w1hi,
                           const float* w2hr, const float* w2hi,
                           const float* thr, const float* thi,
                           const float* w1dr, const float* w1di,
                           const float* w2dr, const float* w2di,
                           const float* tdr, const float* tdi,
                           long long batch, int d, int h, int w, int n1w,
                           int n1h, int n1d, int inverse, int mode,
                           void* stream) {
  using namespace cg;
  cudaStream_t s = (cudaStream_t)stream;
  if (batch <= 0 || d < 2 || h < 2 || w < 2 || (d & (d - 1)) ||
      (h & (h - 1)) || (w & (w - 1)) || n1w < 1 || n1h < 1 || n1d < 1 ||
      w % n1w || h % n1h || d % n1d || mode < MODE_F32 ||
      mode > MODE_PLAIN_BF16)
    return (int)cudaErrorInvalidValue;
  const Axis aw{w, n1w, w / n1w, w1wr, w1wi, w2wr, w2wi, twr, twi};
  const Axis ah{h, n1h, h / n1h, w1hr, w1hi, w2hr, w2hi, thr, thi};
  const Axis ad{d, n1d, d / n1d, w1dr, w1di, w2dr, w2di, tdr, tdi};
  const long long hw = (long long)h * w;
  const float scale = inverse ? (float)(1.0 / ((double)d * hw)) : 1.f;
  Chain ch{(float*)outr, (float*)outi, f0r, f0i, f1r, f1i,
           steps(aw) + steps(ah) + steps(ad)};
  float *tr = nullptr, *ti = nullptr, *ar, *ai;
  if (aw.n1 > 1) ch.next(tr, ti);
  ch.next(ar, ai);
  cudaError_t e = row_pass((const float*)xr, (const float*)xi, w, ar, ai, w,
                           tr, ti, batch * d * h, aw, 1.f, s,
                           pass_io(mode, 0, 3));
  if (e != cudaSuccess) return (int)e;
  float *br, *bi;
  if (ah.n1 > 1) ch.next(tr, ti);
  ch.next(br, bi);
  e = col_pass(ar, ai, br, bi, tr, ti, batch * d, w, ah, 1.f, s,
               pass_io(mode, 1, 3));
  if (e != cudaSuccess) return (int)e;
  float *cr, *ci;
  if (ad.n1 > 1) ch.next(tr, ti);
  ch.next(cr, ci);
  return (int)col_pass(br, bi, cr, ci, tr, ti, batch, hw, ad, scale, s,
                       pass_io(mode, 2, 3));
}

// Batched complex 3-D FFT over (batch, d, h, w) split planes.
//
// Replaces the Pallas kernel repro/kernels/fft3d_fused.py::_fft3d_kernel
// (both variants).  The TPU kernel keeps a (bb, d, h, w) brick in VMEM and
// runs Bailey four-step DFT matmuls along W, H and D (D through the
// (bb, d, h*w) reshape).  On the card that method costs 8*(n1 + n2) flops a
// point an axis (25.8 GFLOP at 2 x 256^3) on the CUDA cores, while the
// function is bound by bytes.  So the fp32 and bf16-compensated modes run
// radix-16 Stockham FFTs in shared memory (axis_fft.cuh), in the fewest
// passes over device memory the tiles allow (kernels/axis_fft.py::plan3d),
// each in place on out after the first:
//   - h*w <= 16384: TWO launches, a plane launch (W and H on whole (h, w)
//     images) over the batch*d images, then D on tiles of C adjacent
//     columns of the (batch, d, h*w) view;
//   - above: THREE launches, W on rows, H on columns of the (batch*d, h, w)
//     view, D on columns of the (batch, d, h*w) view.
// The inverse's 1/(d*h*w) is applied at the last store.  Tiles of up to
// 8192 points overlap the next tile's copy (cp.async) with their passes;
// the 16384-point tiles (128^2 planes, columns of n >= 2048) do not.
// bf16 and float16 compensated store each pass boundary in the planes'
// dtype (the reference's rounding after W and after H, half the bytes).
//
// bf16 and float16 plain are defined by the GEMM steps' rounding points and
// stay on the four-step GEMM chain (row_pass.cuh, cgemm.cuh), as in fft2d_gemm.cu.
#include "axis_fft.cuh"
#include "row_pass.cuh"

// One launch of the planned route (see axis_fft_launch in axis_fft.cuh;
// store 0 fp32, 1 bf16, 2 float16).
extern "C" int fft3d_fused_pass(const void* xr, const void* xi, void* outr,
                                void* outi, const float* tab,
                                const float* tab2, long long outer, int ln,
                                int linner, int lc, int lg, int plane,
                                int blocks, int inverse, float scale,
                                int store, int mode, const float* tw, int tls,
                                int ljr, int lr1, int lr2, long long img_in,
                                long long img_out, void* stream) {
  return (int)axis_fft_launch(xr, xi, outr, outi, tab, tab2, outer, ln,
                              linner, lc, lg, plane, blocks, inverse, scale,
                              store, mode, tw, tls, ljr, lr1, lr2, img_in,
                              img_out, (cudaStream_t)stream);
}

// bf16 (f16: float16) plain: x (batch, d, h, w) raw bf16 -> out raw bf16
// through the GEMM chain (W row_pass, H col_pass, D col_pass over (d,
// h*w)); the fp32
// buffer pairs f0 and f1 hold batch*d*h*w floats a plane.  The 18 tables
// are the W, H and D axes' four-step tables.
extern "C" int fft3d_fused_chain(
    const void* xr, const void* xi, void* outr, void* outi, float* f0r,
    float* f0i, float* f1r, float* f1i, const float* w1wr, const float* w1wi,
    const float* w2wr, const float* w2wi, const float* twr, const float* twi,
    const float* w1hr, const float* w1hi, const float* w2hr,
    const float* w2hi, const float* thr, const float* thi, const float* w1dr,
    const float* w1di, const float* w2dr, const float* w2di, const float* tdr,
    const float* tdi, long long batch, int d, int h, int w, int n1w, int n1h,
    int n1d, int inverse, int f16, void* stream) {
  using namespace cg;
  cudaStream_t s = (cudaStream_t)stream;
  if (batch <= 0 || d < 2 || h < 2 || w < 2 || (d & (d - 1)) ||
      (h & (h - 1)) || (w & (w - 1)) || n1w < 1 || n1h < 1 || n1d < 1 ||
      w % n1w || h % n1h || d % n1d)
    return (int)cudaErrorInvalidValue;
  const Axis aw{w, n1w, w / n1w, w1wr, w1wi, w2wr, w2wi, twr, twi};
  const Axis ah{h, n1h, h / n1h, w1hr, w1hi, w2hr, w2hi, thr, thi};
  const Axis ad{d, n1d, d / n1d, w1dr, w1di, w2dr, w2di, tdr, tdi};
  const long long hw = (long long)h * w;
  const float scale = inverse ? (float)(1.0 / ((double)d * hw)) : 1.f;
  const int mode = f16 ? MODE_PLAIN_F16 : MODE_PLAIN_BF16;
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

// Batched complex 2-D FFT over (batch, h, w) split planes as four-step
// GEMM passes: a row pass along w, then a column pass along h done as
// left-side contractions, so no transpose is ever materialised.
//
// Replaces the Pallas kernel repro/kernels/fft2d_gemm.py::_fft2d_gemm_kernel
// (both variants).  The TPU kernel holds a whole image in VMEM; a 1024^2
// fp32 image is 8 MB against 227 KB of shared memory per block, and the
// dense-leaf table (n <= 256, one 256x256 DFT) is itself 512 KB, so here
// each four-step step is one launch of the tiled complex GEMM (cgemm.cuh),
// chained through fp32 buffers (row_pass.cuh's Chain):
//   row pass    row_pass, shared with rfft2d_fused.cu and fft3d_fused.cu;
//   column pass col_pass over the batch of (h, w) images.
// The unscaled tables take one 1/(h*w) in the last step's epilogue.
// Storage modes (row_pass.cuh): fp32; bf16 compensated (the tables are
// hi + lo summed in fp32 by the wrapper, fp32 within a pass, the tile
// rounded through bf16 after the row pass, bf16 out); bf16 plain (the
// tables' bf16 hi half, every GEMM's output rounded through bf16).  A bf16
// transform reads bf16 in its first GEMM and stores bf16 from its last;
// between them two fp32 buffers, since out holds bf16.
// Bound on the card: fp32 operations (8*n*(n1+n2) per row and column);
// the HBM round trips between steps (up to three) are the known cost of
// this design, and fusing them is later work.
#include "row_pass.cuh"

// x (batch, h, w) -> out, fp32 planes or raw bf16 ones (mode); the fp32
// buffer pairs f0 and f1 hold batch*h*w floats a plane (fp32: f0 is out).
extern "C" int fft2d_gemm(const void* xr, const void* xi, void* outr,
                          void* outi, float* f0r, float* f0i, float* f1r,
                          float* f1i,
                          const float* w1wr, const float* w1wi,
                          const float* w2wr, const float* w2wi,
                          const float* twr, const float* twi,
                          const float* w1hr, const float* w1hi,
                          const float* w2hr, const float* w2hi,
                          const float* thr, const float* thi,
                          long long batch, int h, int w, int n1w, int n1h,
                          int inverse, int mode, void* stream) {
  using namespace cg;
  cudaStream_t s = (cudaStream_t)stream;
  if (batch <= 0 || h < 2 || w < 2 || (h & (h - 1)) || (w & (w - 1)) ||
      n1w < 1 || n1h < 1 || w % n1w || h % n1h || mode < MODE_F32 ||
      mode > MODE_PLAIN_BF16)
    return (int)cudaErrorInvalidValue;
  const Axis aw{w, n1w, w / n1w, w1wr, w1wi, w2wr, w2wi, twr, twi};
  const Axis ah{h, n1h, h / n1h, w1hr, w1hi, w2hr, w2hi, thr, thi};
  const float scale = inverse ? (float)(1.0 / ((double)h * w)) : 1.f;
  Chain ch{(float*)outr, (float*)outi, f0r, f0i, f1r, f1i,
           steps(aw) + steps(ah)};
  float *tr = nullptr, *ti = nullptr, *yr, *yi;
  if (aw.n1 > 1) ch.next(tr, ti);
  ch.next(yr, yi);
  cudaError_t e = row_pass((const float*)xr, (const float*)xi, w, yr, yi, w,
                           tr, ti, batch * h, aw, 1.f, s,
                           pass_io(mode, 0, 2));
  if (e != cudaSuccess) return (int)e;
  float *zr, *zi;
  if (ah.n1 > 1) ch.next(tr, ti);
  ch.next(zr, zi);
  return (int)col_pass(yr, yi, zr, zi, tr, ti, batch, w, ah, scale, s,
                       pass_io(mode, 1, 2));
}

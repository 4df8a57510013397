// Batched complex 2-D FFT over (batch, h, w) split planes.
//
// Replaces the Pallas kernel repro/kernels/fft2d_gemm.py::_fft2d_gemm_kernel
// (both variants).  The TPU kernel holds a whole image in VMEM and runs one
// level of Bailey four-step DFT matmuls on each axis on its matrix unit.
// On the card that method costs 8*(n1 + n2) flops a point an axis on the
// CUDA cores (17.2 GFLOP at 16 x 1024^2, 10x the FFT's 5*log2(n)), and the
// function is bound by bytes (16 a complex fp32 point in and out, ~3 flops
// a byte against the card's 20).  So the fp32 and bf16-compensated modes
// run radix-16 Stockham FFTs in shared memory (axis_fft.cuh), in the fewest
// passes over device memory (kernels/axis_fft.py::plan2d):
//   - h*w <= 16384: ONE launch, the TPU kernel's design: a tile holds whole
//     images, the W FFT runs on its rows and the H FFT on its columns;
//   - above: TWO launches, the W FFT on the rows (x -> out), then the H FFT
//     on tiles of C adjacent columns of all h rows (out -> out, in place).
// The inverse's 1/(h*w) is applied at the last store.  Tiles of up to 8192
// points overlap the next tile's copy (cp.async) with their passes; the
// 16384-point tiles (h >= 2048 columns, 128^2 images) do not.
// bf16 and float16 compensated: bf16 (float16) in, fp32 within a pass, the
// W pass's output stored as bf16 (float16: the reference's round at the
// pass boundary, half the bytes), bf16 (float16) out.
//
// bf16 and float16 plain are defined by the GEMM steps' rounding points
// (tables in the storage dtype, every GEMM output rounded), which an FFT
// cannot reproduce; they stay on the four-step GEMM chain (row_pass.cuh,
// cgemm.cuh): W1 @ X with the twiddle in the epilogue, then @ W2, per
// axis, through fp32 buffers.
#include "axis_fft.cuh"
#include "row_pass.cuh"

// One launch of the planned route (see axis_fft_launch in axis_fft.cuh;
// store 0 fp32, 1 bf16, 2 float16).
extern "C" int fft2d_gemm_pass(const void* xr, const void* xi, void* outr,
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

// bf16 (f16: float16) plain: x (batch, h, w) raw bf16 -> out raw bf16
// through the GEMM chain; the fp32 buffer pairs f0 and f1 hold batch*h*w
// floats a plane.
extern "C" int fft2d_gemm_chain(const void* xr, const void* xi,
                                     void* outr, void* outi, float* f0r,
                                     float* f0i, float* f1r, float* f1i,
                                     const float* w1wr, const float* w1wi,
                                     const float* w2wr, const float* w2wi,
                                     const float* twr, const float* twi,
                                     const float* w1hr, const float* w1hi,
                                     const float* w2hr, const float* w2hi,
                                     const float* thr, const float* thi,
                                     long long batch, int h, int w, int n1w,
                                     int n1h, int inverse, int f16,
                                     void* stream) {
  using namespace cg;
  cudaStream_t s = (cudaStream_t)stream;
  if (batch <= 0 || h < 2 || w < 2 || (h & (h - 1)) || (w & (w - 1)) ||
      n1w < 1 || n1h < 1 || w % n1w || h % n1h)
    return (int)cudaErrorInvalidValue;
  const Axis aw{w, n1w, w / n1w, w1wr, w1wi, w2wr, w2wi, twr, twi};
  const Axis ah{h, n1h, h / n1h, w1hr, w1hi, w2hr, w2hi, thr, thi};
  const float scale = inverse ? (float)(1.0 / ((double)h * w)) : 1.f;
  const int mode = f16 ? MODE_PLAIN_F16 : MODE_PLAIN_BF16;
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

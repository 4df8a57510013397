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
// bf16 and float16 plain are defined by the four-step GEMM steps'
// rounding points (tables in the storage dtype, every product's output
// rounded), which an FFT cannot reproduce: they run the same products on
// the tensor cores (dft_mma.cuh), one launch an axis (the rows, then
// tiles of columns in place), each pass through device memory in the
// storage dtype.
#include "axis_fft.cuh"
#include "dft_mma.cuh"

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

// bf16 (f16: float16) plain: one launch of the host plan
// (kernels/dft_mma.py; see dft_launch in dft_mma.cuh), raw bf16 or
// float16 planes in and out.
extern "C" int fft2d_gemm_plain_pass(const void* xr, const void* xi,
                                     void* yr, void* yi, const void* a1,
                                     const void* tr, const void* ti,
                                     const void* a2, int route,
                                     long long outer, int n,
                                     long long inner, int n1, int lines,
                                     int sms, float scale, int f16,
                                     void* stream) {
  return (int)dm::dft_launch(xr, xi, yr, yi, a1, tr, ti, a2, route, outer, n,
                             inner, n1, lines, sms, scale, f16,
                             (cudaStream_t)stream);
}

// What that launch takes (see dft_geometry in dft_mma.cuh): out holds
// five values.
extern "C" int fft2d_gemm_plain_geometry(int route, long long outer, int n,
                                         long long inner, int n1, int lines,
                                         int sms, long long* out) {
  return (int)dm::dft_geometry(route, outer, n, inner, n1, lines, sms, out);
}

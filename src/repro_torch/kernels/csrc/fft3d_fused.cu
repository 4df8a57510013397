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
// bf16 and float16 plain are defined by the four-step GEMM steps'
// rounding points and run those products on the tensor cores
// (dft_mma.cuh), one launch an axis (W on rows, H and D on tiles of
// columns, in place), as in fft2d_gemm.cu.
#include "axis_fft.cuh"
#include "dft_mma.cuh"

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

// bf16 (f16: float16) plain: one launch of the host plan
// (kernels/dft_mma.py; see dft_launch in dft_mma.cuh).
extern "C" int fft3d_fused_plain_pass(const void* xr, const void* xi,
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
extern "C" int fft3d_fused_plain_geometry(int route, long long outer, int n,
                                          long long inner, int n1, int lines,
                                          int sms, long long* out) {
  return (int)dm::dft_geometry(route, outer, n, inner, n1, lines, sms, out);
}

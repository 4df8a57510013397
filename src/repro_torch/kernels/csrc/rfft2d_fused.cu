// Real-input 2-D FFT over (batch, h, w) fp32 images, h and w powers of two
// >= 2, and its inverse: real (batch, h, w) <-> split half spectra
// (batch, h, c), c = w/2 + 1.
//
// Replaces the Pallas kernels repro/kernels/rfft2d_fused.py::_rfft2d_kernel
// and ::_irfft2d_kernel.  The TPU kernel holds a whole image in VMEM; a
// 1024^2 real plane is 4 MB against 227 KB of shared memory per block, so
// here each step is a launch over the whole batch:
//   forward  row pass    rows 2j and 2j+1 of the real image are the re and
//                        im planes of one complex row (base x and x + w,
//                        row stride 2w: the packing costs no copy), then
//                        the four-step row pass shared with fft2d_gemm.cu
//                        (row_pass.cuh);
//            untangle    A = (Z[k] + conj(Z[-k]))/2 and
//                        B = -i(Z[k] - conj(Z[-k]))/2 for k = 0..w/2, which
//                        reads bin (w - k) mod w, written as rows 2j, 2j+1
//                        of the (h, c) half spectrum;
//            column pass four-step GEMMs along axis -2 of the half-width
//                        tile; c is not a power of two, so the j2 axis of
//                        the first contraction is folded into the batch
//                        index, and its left operand is the j2-th of n2
//                        host-built copies of W1 with the twiddle folded
//                        in, V[j2][k1, a] = T[k1, j2] * W1[k1, a] (the
//                        GEMM's own epilogue twiddle cannot index by j2;
//                        giving it a batch index cost the other kernels
//                        12-14 % of their time, PERF.md).
//   inverse  column pass (inverse tables), repack Z = A_ext + i B_ext (the
//            Hermitian extension of each row pair, with the imaginary
//            parts of the DC and Nyquist bins dropped), inverse row pass
//            whose last GEMM stores re to row 2j and im to row 2j+1 of the
//            real output, scaled by 1/(h*w).
// Bound on the card: the transform is bound by bytes (4 a real point, 8 a
// half-spectrum bin), but the four-step method does 8*n*(n1+n2) flops per
// row and column on the CUDA cores, so this design is bound by those fp32
// operations; the HBM round trips between the five launches are its known
// extra traffic.
#include "row_pass.cuh"

namespace {

using cg::Axis;
using cg::Params;
using cg::lin;
using cg::row_pass;
using cg::two;

constexpr int NT = 256;

unsigned blocks_for(long long total) {
  const long long b = (total + NT - 1) / NT;
  return (unsigned)(b < (1LL << 20) ? b : (1LL << 20));
}

// Length-h complex FFT along axis -2 of (batch, h, c) split planes, c any
// width, through the scratch pair (tr, ti) of the same size.
cudaError_t half_col_pass(const float* sr, const float* si, float* dr,
                          float* di, float* tr, float* ti, long long batch,
                          long long c, const Axis& a, cudaStream_t stream) {
  const long long h = a.n, hc = h * c;
  if (a.n1 > 1) {
    const int l1 = cg::log2i(a.n1), l2 = cg::log2i(a.n2);
    Params p = cg::base();  // U[k1, j2, :] = sum_a V[j2][k1, a] Y[a, j2, :]
    p.ar = a.vr; p.ai = a.vi; p.a_m = lin(a.n1); p.a_k = lin(1);
    p.a_z = two(l2, 0, (long long)a.n1 * a.n1);  // z = (image, j2)
    p.br = sr; p.bi = si; p.b_k = lin(a.n2 * c); p.b_n = lin(1);
    p.b_z = two(l2, hc, c);
    p.cr = tr; p.ci = ti; p.c_m = lin(a.n2 * c); p.c_n = lin(1);
    p.c_z = two(l2, hc, c);
    p.M = a.n1; p.K = a.n1; p.N = c; p.batch = batch * a.n2;
    cudaError_t e = cg::launch(p, stream);
    if (e != cudaSuccess) return e;
    Params q = cg::base();  // Z[k2*n1 + k1] = sum_j2 W2[k2, j2] U[k1, j2]
    q.ar = a.w2r; q.ai = a.w2i; q.a_m = lin(a.n2); q.a_k = lin(1);
    q.br = tr; q.bi = ti; q.b_k = lin(c); q.b_n = lin(1);
    q.b_z = two(l1, hc, a.n2 * c);  // z = (image, k1)
    q.cr = dr; q.ci = di; q.c_m = lin(a.n1 * c); q.c_n = lin(1);
    q.c_z = two(l1, hc, c);
    q.M = a.n2; q.K = a.n2; q.N = c; q.batch = batch * a.n1;
    return cg::launch(q, stream);
  }
  Params p = cg::base();  // one dense DFT per image: Z = W @ Y
  p.ar = a.w2r; p.ai = a.w2i; p.a_m = lin(h); p.a_k = lin(1);
  p.br = sr; p.bi = si; p.b_k = lin(c); p.b_n = lin(1); p.b_z = lin(hc);
  p.cr = dr; p.ci = di; p.c_m = lin(c); p.c_n = lin(1); p.c_z = lin(hc);
  p.M = h; p.K = h; p.N = c; p.batch = batch;
  return cg::launch(p, stream);
}

// packed spectra (rows, w) -> half spectra rows 2r (A) and 2r+1 (B) of c bins
__global__ void __launch_bounds__(NT)
untangle(const float* __restrict__ zr, const float* __restrict__ zi,
         float* __restrict__ yr, float* __restrict__ yi, long long total,
         int lw, long long c) {
  const long long w = 1LL << lw;
  for (long long t = blockIdx.x * (long long)NT + threadIdx.x; t < total;
       t += (long long)gridDim.x * NT) {
    const long long r = t / c, k = t - r * c;
    const long long kc = (w - k) & (w - 1);
    const float rk = zr[r * w + k], ik = zi[r * w + k];
    const float cr = zr[r * w + kc], ci = zi[r * w + kc];
    const long long oa = 2 * r * c + k, ob = oa + c;
    yr[oa] = (rk + cr) * 0.5f;
    yi[oa] = (ik - ci) * 0.5f;
    yr[ob] = (ik + ci) * 0.5f;
    yi[ob] = (cr - rk) * 0.5f;
  }
}

// half spectra rows 2r (A) and 2r+1 (B) -> packed row r of w bins,
// Z = A_ext + i B_ext, DC and Nyquist imaginary parts dropped
__global__ void __launch_bounds__(NT)
repack(const float* __restrict__ yr, const float* __restrict__ yi,
       float* __restrict__ zr, float* __restrict__ zi, long long total,
       int lw, long long c) {
  const long long w = 1LL << lw, hw = w >> 1;
  for (long long t = blockIdx.x * (long long)NT + threadIdx.x; t < total;
       t += (long long)gridDim.x * NT) {
    const long long r = t >> lw, k = t & (w - 1);
    const bool mirror = k > hw;
    const long long kk = mirror ? w - k : k;
    const long long oa = 2 * r * c + kk, ob = oa + c;
    const bool ends = kk == 0 || kk == hw;
    const float ar = yr[oa], br = yr[ob];
    float ai = ends ? 0.f : yi[oa];
    float bi = ends ? 0.f : yi[ob];
    if (mirror) { ai = -ai; bi = -bi; }
    zr[t] = ar - bi;
    zi[t] = ai + br;
  }
}

bool bad_dims(long long batch, int h, int w, int n1w, int n1h) {
  return batch <= 0 || h < 2 || w < 2 || (h & (h - 1)) || (w & (w - 1)) ||
         n1w < 1 || n1h < 1 || w % n1w || h % n1h;
}

}  // namespace

// x (batch, h, w) real -> (outr, outi) (batch, h, w/2+1).  Scratch pairs
// (s0r, s0i) and (s1r, s1i) hold batch*h*(w/2+1) floats a plane.  The 12
// four-step tables (W axis, then H axis) are followed by the H axis'
// twiddled W1 copies (vhr, vhi).
extern "C" int rfft2d_fused_f32(const float* x, float* outr, float* outi,
                                float* s0r, float* s0i, float* s1r,
                                float* s1i,
                                const float* w1wr, const float* w1wi,
                                const float* w2wr, const float* w2wi,
                                const float* twr, const float* twi,
                                const float* w1hr, const float* w1hi,
                                const float* w2hr, const float* w2hi,
                                const float* thr, const float* thi,
                                const float* vhr, const float* vhi,
                                long long batch, int h, int w, int n1w,
                                int n1h, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bad_dims(batch, h, w, n1w, n1h)) return (int)cudaErrorInvalidValue;
  const Axis aw{w, n1w, w / n1w, w1wr, w1wi, w2wr, w2wi, twr, twi};
  const Axis ah{h, n1h, h / n1h, w1hr, w1hi, w2hr, w2hi, thr, thi, vhr, vhi};
  const long long rows = batch * (h / 2), c = w / 2 + 1;
  cudaError_t e = row_pass(x, x + w, 2LL * w, s1r, s1i, w, s0r, s0i, rows,
                           aw, 1.f, s);
  if (e != cudaSuccess) return (int)e;
  const long long total = rows * c;
  untangle<<<blocks_for(total), NT, 0, s>>>(s1r, s1i, s0r, s0i, total,
                                            cg::log2i(w), c);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)half_col_pass(s0r, s0i, outr, outi, s1r, s1i, batch, c, ah,
                            s);
}

// (xr, xi) (batch, h, w/2+1) -> out (batch, h, w) real, scaled by 1/(h*w).
// Scratch pairs as for the forward.
extern "C" int irfft2d_fused_f32(const float* xr, const float* xi, float* out,
                                 float* s0r, float* s0i, float* s1r,
                                 float* s1i,
                                 const float* w1wr, const float* w1wi,
                                 const float* w2wr, const float* w2wi,
                                 const float* twr, const float* twi,
                                 const float* w1hr, const float* w1hi,
                                 const float* w2hr, const float* w2hi,
                                 const float* thr, const float* thi,
                                 const float* vhr, const float* vhi,
                                 long long batch, int h, int w, int n1w,
                                 int n1h, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bad_dims(batch, h, w, n1w, n1h)) return (int)cudaErrorInvalidValue;
  const Axis aw{w, n1w, w / n1w, w1wr, w1wi, w2wr, w2wi, twr, twi};
  const Axis ah{h, n1h, h / n1h, w1hr, w1hi, w2hr, w2hi, thr, thi, vhr, vhi};
  const long long rows = batch * (h / 2), c = w / 2 + 1;
  cudaError_t e = half_col_pass(xr, xi, s1r, s1i, s0r, s0i, batch, c, ah, s);
  if (e != cudaSuccess) return (int)e;
  const long long total = rows * w;
  repack<<<blocks_for(total), NT, 0, s>>>(s1r, s1i, s0r, s0i, total,
                                          cg::log2i(w), c);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)row_pass(s0r, s0i, w, out, out + w, 2LL * w, s1r, s1i, rows,
                       aw, (float)(1.0 / ((double)h * w)), s);
}

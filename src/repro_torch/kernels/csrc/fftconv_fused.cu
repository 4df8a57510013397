// Fused spectral convolution over (batch, r, m) real fp32 rows, m a power
// of two >= 4: rfft -> pointwise multiply -> irfft with the spectrum kept
// on chip.
//
// Replaces the Pallas kernel repro/kernels/fftconv_fused.py::_fftconv_kernel
// (plain version: repro_torch/kernels/fftconv_fused.py::fftconv_fused_plain).
// Per row: the even/odd samples are the re/im planes of m/2 complex points
// Z, a forward FFT of length m/2, the packed-domain multiply
//   Z'[k] = E[k] Z[k] + F[k] conj(Z[(m/2 - k) mod m/2])
// (E and F fold untangle, filter and pre-tangle; host-built), an inverse
// FFT of length m/2 without 1/n, and the re/im interleave scaled by 2/m.
// E/F are (r, m/2) for a bank shared across the batch or (batch, r, m/2).
//
// Bound on the card: bytes.  At the SSM conv shape (8, 576, 8192) the
// function moves 151 MB of x in, 151 MB of y out and 37.7 MB of E/F,
// 0.101 ms at 3.35 TB/s, against 2.26 GFLOP of FFT work, 0.034 ms at
// 67 TFLOP/s.  The TPU kernel's four-step DFT matmuls suit its matrix unit;
// here the design keeps each row on chip so x, E/F and y cross HBM once:
//   m <= 16384  fftconv_fused_f32: one launch.  A block holds one row (or
//               1024 / (m/2) rows for small m) as split fp32 ping-pong
//               buffers in dynamic shared memory (16 * m/2 bytes, 128 KB
//               at m = 16384).  The even/odd pack is the load (x as
//               interleaved complex), both FFTs are radix-2 Stockham
//               stages in shared memory with a barrier between stages,
//               the conjugate-reverse read is a shared-memory index, and
//               the interleave and the 2/m scale ride the store.  Stage
//               twiddles come from host-built float64 tables cast to fp32,
//               W[k] = exp(-+2 pi i k / (m/2)), k < m/4, stage s reading
//               W[(j >> s) << s].  E/F are read once per row (a shared bank
//               stays in L2 across the batch).
//   m > 16384   spectral_section_f32: the multiply alone, one thread per
//               bin over global memory, between the port's 1-D kernels at
//               length m/2 (four-step up to 2^20, Stockham beyond), which
//               the Python wrapper launches; the even/odd split and the
//               interleave are strided torch copies there.
// Later work: radix-4 stages, wgmma, TMA, thread-block clusters for long
// rows.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 512;           // threads a block (one-pass kernel)
constexpr int MIN_POINTS = 1024;  // complex points a block holds at least
constexpr int MAX_ONE_PASS = 16384;
constexpr int NT_SECTION = 256;

// One radix-2 Stockham stage over the block's rows of n = 2^ln points held
// in shared memory, s -> d: butterfly j of a row reads a = s[j] and
// b = s[j + n/2], writes a + b to position o and (a - b) * W[(j>>st)<<st]
// to o + 2^st, o = ((j >> st) << (st + 1)) + (j mod 2^st).
__device__ __forceinline__ void stage(const float* sr, const float* si,
                                      float* dr, float* di,
                                      const float* __restrict__ wr,
                                      const float* __restrict__ wi, int ln,
                                      int st, int pts) {
  const int h = 1 << (ln - 1);
  const int stride = 1 << st;
  for (int t = threadIdx.x; t < (pts >> 1); t += NT) {
    const int base = (t >> (ln - 1)) << ln, j = t & (h - 1);
    const float ar = sr[base + j], ai = si[base + j];
    const float br = sr[base + j + h], bi = si[base + j + h];
    const int k = (j >> st) << st;
    const float w_r = wr[k], w_i = wi[k];
    const float xr = ar - br, xi = ai - bi;
    const int o = base + ((j >> st) << (st + 1)) + (j & (stride - 1));
    dr[o] = ar + br;
    di[o] = ai + bi;
    dr[o + stride] = xr * w_r - xi * w_i;
    di[o + stride] = xr * w_i + xi * w_r;
  }
}

// all ln stages, ping-ponging between (ar, ai) and (br, bi), starting in
// (ar, ai); returns with the result in (ar, ai) (the pointers are swapped)
__device__ __forceinline__ void fft_rows(float*& ar, float*& ai, float*& br,
                                         float*& bi,
                                         const float* __restrict__ wr,
                                         const float* __restrict__ wi, int ln,
                                         int pts) {
  for (int st = 0; st < ln; ++st) {
    stage(ar, ai, br, bi, wr, wi, ln, st, pts);
    __syncthreads();
    float* t = ar; ar = br; br = t;
    t = ai; ai = bi; bi = t;
  }
}

__global__ void __launch_bounds__(NT)
conv_rows(const float* __restrict__ x, const float* __restrict__ er,
          const float* __restrict__ ei, const float* __restrict__ fr,
          const float* __restrict__ fi, const float* __restrict__ wfr,
          const float* __restrict__ wfi, const float* __restrict__ wbr,
          const float* __restrict__ wbi, float* __restrict__ out,
          long long rows, int r, int lh, int lrpb, int shared, float scale) {
  extern __shared__ float smem[];
  const int hm = 1 << lh, pts = hm << lrpb;
  float* ar = smem;
  float* ai = smem + pts;
  float* br = smem + 2 * pts;
  float* bi = smem + 3 * pts;
  const long long row0 = (long long)blockIdx.x << lrpb;
  // load: x's even/odd floats are the re/im of interleaved complex
  for (int t = threadIdx.x; t < pts; t += NT) {
    const long long g = row0 + (t >> lh);
    float2 v = make_float2(0.f, 0.f);
    if (g < rows)
      v = reinterpret_cast<const float2*>(x)[(g << lh) + (t & (hm - 1))];
    ar[t] = v.x;
    ai[t] = v.y;
  }
  __syncthreads();
  fft_rows(ar, ai, br, bi, wfr, wfi, lh, pts);
  // Z' = E Z + F conj(Z[(hm - k) mod hm]): the conjugate-reverse read is an
  // index into shared memory
  for (int t = threadIdx.x; t < pts; t += NT) {
    const long long g = row0 + (t >> lh);
    const int k = t & (hm - 1), base = t - k;
    float yr = 0.f, yi = 0.f;
    if (g < rows) {
      const long long e = ((shared ? g % r : g) << lh) + k;
      const float zr = ar[t], zi = ai[t];
      const int c = base + ((hm - k) & (hm - 1));
      const float zcr = ar[c], zci = ai[c];
      const float e_r = er[e], e_i = ei[e], f_r = fr[e], f_i = fi[e];
      yr = e_r * zr - e_i * zi + f_r * zcr + f_i * zci;
      yi = e_r * zi + e_i * zr + f_i * zcr - f_r * zci;
    }
    br[t] = yr;
    bi[t] = yi;
  }
  __syncthreads();
  fft_rows(br, bi, ar, ai, wbr, wbi, lh, pts);
  // store: re/im interleave into the real row, scaled by 2/m
  for (int t = threadIdx.x; t < pts; t += NT) {
    const long long g = row0 + (t >> lh);
    if (g < rows)
      reinterpret_cast<float2*>(out)[(g << lh) + (t & (hm - 1))] =
          make_float2(br[t] * scale, bi[t] * scale);
  }
}

// Z' = E Z + F conj(Z[(hm - k) mod hm]) over (batch, r, hm) split planes
// in global memory, one thread per bin
__global__ void __launch_bounds__(NT_SECTION)
section(const float* __restrict__ zr, const float* __restrict__ zi,
        const float* __restrict__ er, const float* __restrict__ ei,
        const float* __restrict__ fr, const float* __restrict__ fi,
        float* __restrict__ yr, float* __restrict__ yi, long long total,
        long long bank, int lh, int shared) {
  const long long hm = 1LL << lh;
  for (long long t = blockIdx.x * (long long)NT_SECTION + threadIdx.x;
       t < total; t += (long long)gridDim.x * NT_SECTION) {
    const long long k = t & (hm - 1);
    const long long c = t - k + ((hm - k) & (hm - 1));
    const long long e = shared ? t % bank : t;
    const float z_r = zr[t], z_i = zi[t], zcr = zr[c], zci = zi[c];
    const float e_r = er[e], e_i = ei[e], f_r = fr[e], f_i = fi[e];
    yr[t] = e_r * z_r - e_i * z_i + f_r * zcr + f_i * zci;
    yi[t] = e_r * z_i + e_i * z_r + f_i * zcr - f_r * zci;
  }
}

int log2i(long long n) {
  int l = 0;
  while ((1LL << l) < n) ++l;
  return l;
}

}  // namespace

// x (batch, r, m) real -> out (batch, r, m): the one-pass kernel, m <= 16384.
// (er, ei), (fr, fi): the packed filter pair, (r, m/2) when shared != 0,
// else (batch, r, m/2).  (wfr, wfi), (wbr, wbi): forward and inverse stage
// twiddles of length m/2 (only the first m/4 are read).
extern "C" int fftconv_fused_f32(const float* x, const float* er,
                                 const float* ei, const float* fr,
                                 const float* fi, const float* wfr,
                                 const float* wfi, const float* wbr,
                                 const float* wbi, float* out,
                                 long long batch, int r, int m, int shared,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (batch <= 0 || r <= 0 || m < 4 || (m & (m - 1)) || m > MAX_ONE_PASS)
    return (int)cudaErrorInvalidValue;
  const int hm = m / 2, lh = log2i(hm);
  const int lrpb = hm >= MIN_POINTS ? 0 : log2i(MIN_POINTS / hm);
  const int pts = hm << lrpb;
  const int smem = 4 * pts * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      conv_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long rows = batch * r;
  const long long blocks = (rows + (1LL << lrpb) - 1) >> lrpb;
  conv_rows<<<(unsigned)blocks, NT, smem, s>>>(
      x, er, ei, fr, fi, wfr, wfi, wbr, wbi, out, rows, r, lh, lrpb, shared,
      (float)(2.0 / (double)m));
  return (int)cudaGetLastError();
}

// The spectral section of the multi-launch schedule: (zr, zi) the forward
// spectra (batch, r, hm) -> (yr, yi), same shape; E/F as above at hm bins.
extern "C" int spectral_section_f32(const float* zr, const float* zi,
                                    const float* er, const float* ei,
                                    const float* fr, const float* fi,
                                    float* yr, float* yi, long long batch,
                                    int r, int hm, int shared,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (batch <= 0 || r <= 0 || hm < 2 || (hm & (hm - 1)))
    return (int)cudaErrorInvalidValue;
  const long long total = batch * r * (long long)hm;
  long long blocks = (total + NT_SECTION - 1) / NT_SECTION;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  section<<<(unsigned)blocks, NT_SECTION, 0, s>>>(
      zr, zi, er, ei, fr, fi, yr, yi, total, (long long)r * hm, log2i(hm),
      shared);
  return (int)cudaGetLastError();
}

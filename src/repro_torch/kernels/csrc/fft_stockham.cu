// Mixed radix-4 / radix-2 Stockham autosort FFT on (batch, n) split fp32
// planes, n a power of two >= 2, and its pure radix-2 twin.
//
// Replaces the Pallas kernels repro/kernels/fft_stockham.py::_stockham_kernel
// (radix=4; stage arithmetic repro_torch/core/fft1d.py::stockham_stages)
// and ::_stockham_kernel_r2 (radix=2; fft1d.py::stockham_radix2_stages).
// The TPU kernel keeps a whole row in VMEM for all stages; for n > 2^20 no
// row fits in shared memory, so here every radix-4 stage is
// one launch over global ping-pong buffers: one thread per butterfly reads
// the four quarter slices x[j + r*q], twiddles by row s of the packed
// (s4, 3, n/4) table and writes the interleaved (m, 4, stride) positions.
// The radix-2 tail (m == 1, twiddle 1) runs last.  The inverse folds its
// 1/n into the last stage's store.
// The radix-2 twin runs log2(n) stage launches over the same ping-pong
// buffers, stage s reading row s of the packed (stages, n/2) table.
// Bound on the card: bytes.  A radix-4 stage does 34 flops per 4 points
// against 32 bytes of data plus 24 bytes of table (radix 2: 10 flops per 2
// points against 16 + 8 bytes); every stage streams the whole array
// through HBM, which a shared-memory multi-stage variant would avoid.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
r4_stage(const float* __restrict__ xr, const float* __restrict__ xi,
         float* __restrict__ yr, float* __restrict__ yi,
         const float* __restrict__ wr, const float* __restrict__ wi,
         long long total, int lq, int ls, int inverse, float scale) {
  const long long q = 1LL << lq;
  const long long n = q << 2;
  const long long stride = 1LL << ls;
  for (long long t = blockIdx.x * (long long)NT + threadIdx.x; t < total;
       t += (long long)gridDim.x * NT) {
    const long long b = t >> lq, j = t & (q - 1);
    const float* pr = xr + b * n;
    const float* pi = xi + b * n;
    const float a0r = pr[j], a1r = pr[j + q], a2r = pr[j + 2 * q], a3r = pr[j + 3 * q];
    const float a0i = pi[j], a1i = pi[j + q], a2i = pi[j + 2 * q], a3i = pi[j + 3 * q];
    const float e0r = a0r + a2r, e0i = a0i + a2i;
    const float d0r = a0r - a2r, d0i = a0i - a2i;
    const float e1r = a1r + a3r, e1i = a1i + a3i;
    const float d1r = a1r - a3r, d1i = a1i - a3i;
    const float y0r = e0r + e1r, y0i = e0i + e1i;
    const float y2r = e0r - e1r, y2i = e0i - e1i;
    float y1r, y1i, y3r, y3i;
    if (inverse) {  // +i (a1 - a3)
      y1r = d0r - d1i; y1i = d0i + d1r;
      y3r = d0r + d1i; y3i = d0i - d1r;
    } else {        // -i (a1 - a3)
      y1r = d0r + d1i; y1i = d0i - d1r;
      y3r = d0r - d1i; y3i = d0i + d1r;
    }
    const float w1r = wr[j], w2r = wr[q + j], w3r = wr[2 * q + j];
    const float w1i = wi[j], w2i = wi[q + j], w3i = wi[2 * q + j];
    const float b1r = y1r * w1r - y1i * w1i, b1i = y1r * w1i + y1i * w1r;
    const float b2r = y2r * w2r - y2i * w2i, b2i = y2r * w2i + y2i * w2r;
    const float b3r = y3r * w3r - y3i * w3i, b3i = y3r * w3i + y3i * w3r;
    // autosort store: j = p*stride + k  ->  p*4*stride + r*stride + k
    const long long o = b * n + ((j >> ls) << (ls + 2)) + (j & (stride - 1));
    yr[o] = y0r * scale;              yi[o] = y0i * scale;
    yr[o + stride] = b1r * scale;     yi[o + stride] = b1i * scale;
    yr[o + 2 * stride] = b2r * scale; yi[o + 2 * stride] = b2i * scale;
    yr[o + 3 * stride] = b3r * scale; yi[o + 3 * stride] = b3i * scale;
  }
}

__global__ void __launch_bounds__(NT)
r2_tail(const float* __restrict__ xr, const float* __restrict__ xi,
        float* __restrict__ yr, float* __restrict__ yi,
        long long total, int lh, float scale) {
  const long long h = 1LL << lh;
  for (long long t = blockIdx.x * (long long)NT + threadIdx.x; t < total;
       t += (long long)gridDim.x * NT) {
    const long long b = t >> lh, j = t & (h - 1);
    const long long o = b * 2 * h + j;
    const float ar = xr[o], ai = xi[o], br = xr[o + h], bi = xi[o + h];
    yr[o] = (ar + br) * scale;     yi[o] = (ai + bi) * scale;
    yr[o + h] = (ar - br) * scale; yi[o + h] = (ai - bi) * scale;
  }
}

// one radix-2 stage: the contiguous halves a = x[j], b = x[j + n/2] give
// (a + b) and (a - b) * w[j], stored at the autosort positions
// j = p*stride + k  ->  p*2*stride + k and that + stride
__global__ void __launch_bounds__(NT)
r2_stage(const float* __restrict__ xr, const float* __restrict__ xi,
         float* __restrict__ yr, float* __restrict__ yi,
         const float* __restrict__ wr, const float* __restrict__ wi,
         long long total, int lh, int ls, float scale) {
  const long long h = 1LL << lh;
  const long long stride = 1LL << ls;
  for (long long t = blockIdx.x * (long long)NT + threadIdx.x; t < total;
       t += (long long)gridDim.x * NT) {
    const long long b = t >> lh, j = t & (h - 1);
    const long long i = b * 2 * h + j;
    const float ar = xr[i], ai = xi[i], br = xr[i + h], bi = xi[i + h];
    const float sr = ar - br, si = ai - bi;
    const float w_r = wr[j], w_i = wi[j];
    const long long o =
        b * 2 * h + ((j >> ls) << (ls + 1)) + (j & (stride - 1));
    yr[o] = (ar + br) * scale;
    yi[o] = (ai + bi) * scale;
    yr[o + stride] = (sr * w_r - si * w_i) * scale;
    yi[o + stride] = (sr * w_i + si * w_r) * scale;
  }
}

unsigned blocks_for(long long total) {
  const long long b = (total + NT - 1) / NT;
  return (unsigned)(b < (1LL << 20) ? b : (1LL << 20));
}

}  // namespace

extern "C" int fft_stockham_f32(const float* xr, const float* xi,
                                float* outr, float* outi,
                                float* sr, float* si,
                                const float* wr, const float* wi,
                                long long batch, int n, int inverse,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (batch <= 0 || n < 2 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  int ln = 0;
  while ((1 << ln) < n) ++ln;
  const int s4 = ln / 2, stages = s4 + (ln & 1);
  const long long q = n / 4;
  const float last_scale = inverse ? (float)(1.0 / (double)n) : 1.f;
  // stage i writes the buffer that makes the last stage land in out
  float* dst_r[2] = {outr, sr};
  float* dst_i[2] = {outi, si};
  const float* src_r = xr;
  const float* src_i = xi;
  for (int st = 0; st < stages; ++st) {
    const int d = (stages - 1 - st) % 2;
    const float scale = st == stages - 1 ? last_scale : 1.f;
    if (st < s4) {
      const long long total = batch * q;
      r4_stage<<<blocks_for(total), NT, 0, s>>>(
          src_r, src_i, dst_r[d], dst_i[d], wr + st * 3 * q, wi + st * 3 * q,
          total, ln - 2, 2 * st, inverse, scale);
    } else {
      const long long total = batch * (n / 2);
      r2_tail<<<blocks_for(total), NT, 0, s>>>(src_r, src_i, dst_r[d], dst_i[d],
                                               total, ln - 1, scale);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    src_r = dst_r[d];
    src_i = dst_i[d];
  }
  return (int)cudaSuccess;
}

// Pure radix-2 Stockham (the oracle kernel): log2(n) stage launches, the
// last one landing in out with the inverse's 1/n folded into its store.
extern "C" int fft_stockham_r2_f32(const float* xr, const float* xi,
                                   float* outr, float* outi,
                                   float* sr, float* si,
                                   const float* wr, const float* wi,
                                   long long batch, int n, int inverse,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (batch <= 0 || n < 2 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  int ln = 0;
  while ((1 << ln) < n) ++ln;
  const long long h = n / 2;
  const float last_scale = inverse ? (float)(1.0 / (double)n) : 1.f;
  float* dst_r[2] = {outr, sr};
  float* dst_i[2] = {outi, si};
  const float* src_r = xr;
  const float* src_i = xi;
  for (int st = 0; st < ln; ++st) {
    const int d = (ln - 1 - st) % 2;
    const long long total = batch * h;
    r2_stage<<<blocks_for(total), NT, 0, s>>>(
        src_r, src_i, dst_r[d], dst_i[d], wr + st * h, wi + st * h, total,
        ln - 1, st, st == ln - 1 ? last_scale : 1.f);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    src_r = dst_r[d];
    src_i = dst_i[d];
  }
  return (int)cudaSuccess;
}

// The paper's "Initial" FFT: radix-2 decimation in time on (batch, n) split
// fp32 planes, n a power of two, one launch per butterfly stage.
//
// Replaces the Pallas kernel repro/kernels/fft_stage.py::_stage_kernel and
// its caller fft_staged_pallas: a bit-reverse, then log2(n) single-stage
// launches, each streaming the whole array through device memory.  That
// per-stage round trip is what makes this the baseline of the paper's
// Table 1 ladder, so the stages stay separate launches here too.
//
// Stage s pairs the elements idx0 = (p >> s) * 2^(s+1) + (p mod 2^s) and
// idx1 = idx0 + 2^s (repro_torch/core/fft1d.py::_ct_stage_indices, computed
// here from p instead of read from the tables).  One thread takes a pair,
// twiddles z[idx1] by W[(p mod 2^s) * n / 2^(s+1)] of the fp32 cast of the
// float64 table (core/twiddle.py::_twiddle_np) and writes the sum and the
// difference back to idx0 and idx1.  That is the reference's write reorder
// out[j] = concat(o0, o1)[inv_perm[j]] in scatter form: inv_perm inverts
// concat(idx0, idx1), so o0[p] lands at idx0[p] and o1[p] at idx1[p].  A
// pair's two slots are its own, so the stages run in place on the output.
// The bit-reverse is a gather kernel of its own; the inverse's 1/n (exact,
// n a power of two) is folded into the last stage's store.
//
// Bound on the card: bytes.  A stage does 10 flops a pair against 32 bytes
// of data moved, and the log2(n) stages move the array log2(n) times.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

unsigned blocks_for(long long total) {
  const long long b = (total + NT - 1) / NT;
  return (unsigned)(b < (1LL << 20) ? b : (1LL << 20));
}

// y[b, j] = x[b, bitrev(j)] over rows of 2^ln points
__global__ void __launch_bounds__(NT)
bit_reverse(const float* __restrict__ xr, const float* __restrict__ xi,
            float* __restrict__ yr, float* __restrict__ yi, long long total,
            int ln) {
  const long long mask = (1LL << ln) - 1;
  for (long long t = blockIdx.x * (long long)NT + threadIdx.x; t < total;
       t += (long long)gridDim.x * NT) {
    const long long j = t & mask;
    const long long r = ln ? (long long)(__brev((unsigned)j) >> (32 - ln)) : 0;
    const long long src = (t - j) + r;
    yr[t] = xr[src];
    yi[t] = xi[src];
  }
}

// butterfly stage s in place: rows of 2^ln points, 2^(ln-1) pairs a row
__global__ void __launch_bounds__(NT)
stage(float* __restrict__ zr, float* __restrict__ zi,
      const float* __restrict__ wr, const float* __restrict__ wi,
      long long total, int ln, int s, float scale) {
  const long long pairs = 1LL << (ln - 1);
  const long long half = 1LL << s;
  for (long long t = blockIdx.x * (long long)NT + threadIdx.x; t < total;
       t += (long long)gridDim.x * NT) {
    const long long b = t >> (ln - 1), p = t & (pairs - 1);
    const long long k = p & (half - 1);
    const long long i0 = (b << ln) + ((p >> s) << (s + 1)) + k;
    const long long i1 = i0 + half;
    const long long tw = k << (ln - 1 - s);
    const float w_r = wr[tw], w_i = wi[tw];
    const float ar = zr[i0], ai = zi[i0], br = zr[i1], bi = zi[i1];
    const float fr = br * w_r - bi * w_i;
    const float fi = br * w_i + bi * w_r;
    zr[i0] = (ar + fr) * scale;
    zi[i0] = (ai + fi) * scale;
    zr[i1] = (ar - fr) * scale;
    zi[i1] = (ai - fi) * scale;
  }
}

}  // namespace

// out = FFT(x) (inverse: with the 1/n) along rows of n points; w is the
// fp32 (n,) twiddle table exp(-+2*pi*i*k/n).  One bit-reverse launch and
// log2(n) stage launches on the current stream.
extern "C" int fft_staged_f32(const float* xr, const float* xi,
                              float* outr, float* outi,
                              const float* wr, const float* wi,
                              long long batch, int n, int inverse,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (batch <= 0 || n < 1 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  int ln = 0;
  while ((1 << ln) < n) ++ln;
  const long long total = batch * n;
  bit_reverse<<<blocks_for(total), NT, 0, s>>>(xr, xi, outr, outi, total, ln);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float last_scale = inverse ? (float)(1.0 / (double)n) : 1.f;
  for (int st = 0; st < ln; ++st) {
    const long long pairs = batch * (n / 2);
    stage<<<blocks_for(pairs), NT, 0, s>>>(
        outr, outi, wr, wi, pairs, ln, st, st == ln - 1 ? last_scale : 1.f);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

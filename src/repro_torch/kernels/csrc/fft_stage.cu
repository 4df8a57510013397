// The paper's "Initial" FFT: radix-2 decimation in time on (batch, n) split
// fp32, bf16 or float16 planes, n a power of two, one launch per butterfly
// stage.  bf16 and float16 planes are widened at every load and rounded at
// every store, so each stage's output is rounded to the planes' dtype as
// the reference's bf16 and float16 arrays are; the arithmetic and the
// tables stay fp32.
//
// Replaces the Pallas kernel repro/kernels/fft_stage.py::_stage_kernel and
// its caller fft_staged_pallas: a bit-reverse, then log2(n) single-stage
// launches, each streaming the whole array through device memory.  That
// per-stage round trip is what makes this the baseline of the paper's
// Table 1 ladder, so the stages stay separate launches here too.
//
// Stage s pairs the elements idx0 = (p >> s) * 2^(s+1) + (p mod 2^s) and
// idx1 = idx0 + 2^s (repro_torch/core/fft1d.py::_ct_stage_indices, computed
// here from p instead of read from the tables).  A pair twiddles z[idx1] by
// W[(p mod 2^s) * n / 2^(s+1)] of the fp32 cast of the float64 table
// (core/twiddle.py::_twiddle_np) and writes the sum and the difference back
// to idx0 and idx1.  That is the reference's write reorder
// out[j] = concat(o0, o1)[inv_perm[j]] in scatter form: inv_perm inverts
// concat(idx0, idx1), so o0[p] lands at idx0[p] and o1[p] at idx1[p].  A
// pair's two slots are its own, so stages 1.. run in place on the output.
// The inverse's 1/n (exact, n a power of two) is folded into the last
// stage's store.
//
// Bound on the card: bytes.  A stage does 10 flops a pair against 32 bytes
// of data moved, so the design moves each byte of the rung once a stage
// and no more, with whole sectors:
//   - the bit-reverse is folded into stage 0's launch, whose pairs
//     (2p, 2p+1) read x[bitrev(2p)] and x[bitrev(2p + 1)].  For n < 2^10 a
//     block permutes whole rows in shared memory.  For n >= 2^10 the index
//     splits as j = (hi, mid, lo) with 5-bit hi and lo, and
//     bitrev(j) = (rev(lo), rev(mid), rev(hi)): the 32x32 tile of outputs
//     (hi, lo) at one mid reads the 32x32 tile of inputs (rev(lo), rev(hi))
//     at rev(mid), contiguous along its rows on both sides, transposed
//     through shared memory (pitch 33: no bank conflicts).  So log2(n)
//     launches in all, not log2(n) + 1;
//   - every stage moves 16-byte float4s: at s = 1 a thread takes the two
//     pairs of one aligned quad, at s >= 2 four consecutive pairs, whose
//     idx0 and idx1 are each four consecutive floats.
#include <cuda_runtime.h>
#include <type_traits>
#include "bf16.cuh"
#include "f16.cuh"

namespace {

__device__ __forceinline__ float wide(float v) { return v; }
__device__ __forceinline__ float wide(unsigned short v) {
  return cg::bf16_to_f32(v);
}
__device__ __forceinline__ float wide(cg::f16 v) { return cg::widen_f16(v); }

template <class T>
__device__ __forceinline__ T thin(float v) {
  if constexpr (std::is_same_v<T, cg::f16>)
    return cg::narrow_f16(v);
  else if constexpr (sizeof(T) == 2)
    return cg::f32_to_bf16(v);
  else
    return v;
}

// the raw 16 bits of a bf16 (T = unsigned short) or float16 value
template <class T>
__device__ __forceinline__ unsigned short bits(float v) {
  if constexpr (std::is_same_v<T, cg::f16>)
    return cg::f32_to_f16(v);
  else
    return cg::f32_to_bf16(v);
}
__device__ __forceinline__ float widen_bits(unsigned short b, unsigned short) {
  return cg::bf16_to_f32(b);
}
__device__ __forceinline__ float widen_bits(unsigned short b, cg::f16) {
  return cg::f16_to_f32(b);
}

// four consecutive elements (16 bytes of fp32, 8 of bf16 or float16) as a
// float4
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <class T, class = std::enable_if_t<sizeof(T) == 2>>
__device__ __forceinline__ float4 load4(const T* p) {
  const ushort4 v = *reinterpret_cast<const ushort4*>(p);
  return make_float4(widen_bits(v.x, T{}), widen_bits(v.y, T{}),
                     widen_bits(v.z, T{}), widen_bits(v.w, T{}));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <class T, class = std::enable_if_t<sizeof(T) == 2>>
__device__ __forceinline__ void store4(T* p, float4 v) {
  *reinterpret_cast<ushort4*>(p) = make_ushort4(
      bits<T>(v.x), bits<T>(v.y), bits<T>(v.z), bits<T>(v.w));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <class T, class = std::enable_if_t<sizeof(T) == 2>>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  *reinterpret_cast<ushort2*>(p) = make_ushort2(bits<T>(a), bits<T>(b));
}

constexpr int NT = 256;

unsigned blocks_for(long long total) {
  const long long b = (total + NT - 1) / NT;
  return (unsigned)(b < (1LL << 20) ? b : (1LL << 20));
}

__device__ __forceinline__ unsigned rev_bits(unsigned j, int bits) {
  return bits ? __brev(j) >> (32 - bits) : 0u;
}

// the butterfly of one pair: (a + b*w, a - b*w) * scale, into
// (o0r, o0i) and (o1r, o1i)
__device__ __forceinline__ void butterfly(float ar, float ai, float br,
                                          float bi, float w_r, float w_i,
                                          float scale, float& o0r,
                                          float& o0i, float& o1r,
                                          float& o1i) {
  const float fr = br * w_r - bi * w_i;
  const float fi = br * w_i + bi * w_r;
  o0r = (ar + fr) * scale;
  o0i = (ai + fi) * scale;
  o1r = (ar - fr) * scale;
  o1i = (ai - fi) * scale;
}

// stage 0 with the bit-reverse, n = 2^ln < 2^10: a block holds 1024
// points (1024 / n rows) in shared memory and writes each pair (2p, 2p+1)
// as one float2; n = 1 (ln = 0) is a copy
template <class T>
__global__ void __launch_bounds__(NT)
first_stage_rows(const T* __restrict__ xr, const T* __restrict__ xi,
                 T* __restrict__ outr, T* __restrict__ outi,
                 const float* __restrict__ wr, const float* __restrict__ wi,
                 long long total, int ln, float scale) {
  __shared__ float sr[1024], si[1024];
  const long long base = (long long)blockIdx.x * 1024;
  for (int e = threadIdx.x; e < 1024; e += NT) {
    const bool in = base + e < total;
    sr[e] = in ? wide(xr[base + e]) : 0.f;
    si[e] = in ? wide(xi[base + e]) : 0.f;
  }
  __syncthreads();
  if (ln == 0) {
    for (int e = threadIdx.x; e < 1024; e += NT)
      if (base + e < total) {
        outr[base + e] = thin<T>(sr[e]);
        outi[base + e] = thin<T>(si[e]);
      }
    return;
  }
  const int mask = (1 << ln) - 1;
  const float w_r = wr[0], w_i = wi[0];
  for (int p = threadIdx.x; p < 512; p += NT) {
    const int e0 = 2 * p;
    if (base + e0 >= total) break;
    const int row = e0 & ~mask, j = e0 & mask;
    const int s0 = row + (int)rev_bits(j, ln);
    const int s1 = row + (int)rev_bits(j + 1, ln);
    float2 o0, o1;
    butterfly(sr[s0], si[s0], sr[s1], si[s1], w_r, w_i, scale, o0.x, o0.y,
              o1.x, o1.y);
    store2(outr + base + e0, o0.x, o1.x);
    store2(outi + base + e0, o0.y, o1.y);
  }
}

// stage 0 with the bit-reverse, n = 2^ln >= 2^10: one 32x32 tile a block.
// Tile (b, mid) holds the outputs j = hi*2^(ln-5) + mid*32 + lo, which read
// the inputs rev(lo)*2^(ln-5) + rev(mid)*32 + rev(hi).
template <class T>
__global__ void __launch_bounds__(NT)
first_stage_tiled(const T* __restrict__ xr, const T* __restrict__ xi,
                  T* __restrict__ outr, T* __restrict__ outi,
                  const float* __restrict__ wr, const float* __restrict__ wi,
                  int ln, float scale) {
  __shared__ float tr[32 * 33], ti[32 * 33];
  const int lm = ln - 10;
  const long long b = blockIdx.x >> lm;
  const unsigned mid = blockIdx.x & ((1u << lm) - 1);
  const long long row = b << ln;
  const long long src = row + ((long long)rev_bits(mid, lm) << 5);
  for (int e = threadIdx.x; e < 1024; e += NT) {
    const long long a = src + ((long long)(e >> 5) << (ln - 5)) + (e & 31);
    tr[(e >> 5) * 33 + (e & 31)] = wide(xr[a]);
    ti[(e >> 5) * 33 + (e & 31)] = wide(xi[a]);
  }
  __syncthreads();
  const float w_r = wr[0], w_i = wi[0];
  const long long dst = row + ((long long)mid << 5);
  for (int p = threadIdx.x; p < 512; p += NT) {
    const int hi = p >> 4, lo = (p & 15) << 1;
    const int c = (int)rev_bits(hi, 5);
    const int s0 = (int)rev_bits(lo, 5) * 33 + c;
    const int s1 = (int)rev_bits(lo + 1, 5) * 33 + c;
    float2 o0, o1;
    butterfly(tr[s0], ti[s0], tr[s1], ti[s1], w_r, w_i, scale, o0.x, o0.y,
              o1.x, o1.y);
    const long long a = dst + ((long long)hi << (ln - 5)) + lo;
    store2(outr + a, o0.x, o1.x);
    store2(outi + a, o0.y, o1.y);
  }
}

// stage 1 in place: quad u holds the pairs (4u, 4u+2), k = 0, and
// (4u+1, 4u+3), k = 1
template <class T>
__global__ void __launch_bounds__(NT)
stage_one(T* __restrict__ zr, T* __restrict__ zi,
          const float* __restrict__ wr, const float* __restrict__ wi,
          long long quads, int ln, float scale) {
  const float w0r = wr[0], w0i = wi[0];
  const float w1r = wr[1 << (ln - 2)], w1i = wi[1 << (ln - 2)];
  for (long long u = blockIdx.x * (long long)NT + threadIdx.x; u < quads;
       u += (long long)gridDim.x * NT) {
    const float4 r = load4(zr + 4 * u), i = load4(zi + 4 * u);
    float4 o, q;
    butterfly(r.x, i.x, r.z, i.z, w0r, w0i, scale, o.x, q.x, o.z, q.z);
    butterfly(r.y, i.y, r.w, i.w, w1r, w1i, scale, o.y, q.y, o.w, q.w);
    store4(zr + 4 * u, o);
    store4(zi + 4 * u, q);
  }
}

// stage s >= 2 in place: unit u takes the four pairs p = 4u .. 4u+3, whose
// idx0 (and idx1) are four consecutive, 16-byte aligned floats
template <class T>
__global__ void __launch_bounds__(NT)
stage_quad(T* __restrict__ zr, T* __restrict__ zi,
           const float* __restrict__ wr, const float* __restrict__ wi,
           long long units, int ln, int s, float scale) {
  const long long half = 1LL << s;
  for (long long u = blockIdx.x * (long long)NT + threadIdx.x; u < units;
       u += (long long)gridDim.x * NT) {
    const long long p = u << 2;
    const long long k = p & (half - 1);
    const long long i0 = ((p >> s) << (s + 1)) + k;
    const long long i1 = i0 + half;
    const float4 ar = load4(zr + i0), ai = load4(zi + i0);
    const float4 br = load4(zr + i1), bi = load4(zi + i1);
    const int sh = ln - 1 - s;
    const long long t = k << sh;
    float4 o0r, o0i, o1r, o1i;
    butterfly(ar.x, ai.x, br.x, bi.x, wr[t], wi[t], scale, o0r.x, o0i.x,
              o1r.x, o1i.x);
    butterfly(ar.y, ai.y, br.y, bi.y, wr[t + (1LL << sh)],
              wi[t + (1LL << sh)], scale, o0r.y, o0i.y, o1r.y, o1i.y);
    butterfly(ar.z, ai.z, br.z, bi.z, wr[t + (2LL << sh)],
              wi[t + (2LL << sh)], scale, o0r.z, o0i.z, o1r.z, o1i.z);
    butterfly(ar.w, ai.w, br.w, bi.w, wr[t + (3LL << sh)],
              wi[t + (3LL << sh)], scale, o0r.w, o0i.w, o1r.w, o1i.w);
    store4(zr + i0, o0r);
    store4(zi + i0, o0i);
    store4(zr + i1, o1r);
    store4(zi + i1, o1i);
  }
}

template <class T>
int staged(const T* xr, const T* xi, T* outr, T* outi, const float* wr,
           const float* wi, long long batch, int n, int inverse,
           cudaStream_t s) {
  int ln = 0;
  while ((1 << ln) < n) ++ln;
  const long long total = batch * n;
  const float last_scale = inverse ? (float)(1.0 / (double)n) : 1.f;
  const float scale0 = ln == 1 ? last_scale : 1.f;
  if (ln < 10) {
    const unsigned blocks = (unsigned)((total + 1023) / 1024);
    first_stage_rows<T><<<blocks, NT, 0, s>>>(xr, xi, outr, outi, wr, wi,
                                              total, ln, scale0);
  } else {
    const unsigned blocks = (unsigned)(batch << (ln - 10));
    first_stage_tiled<T><<<blocks, NT, 0, s>>>(xr, xi, outr, outi, wr, wi,
                                               ln, scale0);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  for (int st = 1; st < ln; ++st) {
    const float scale = st == ln - 1 ? last_scale : 1.f;
    if (st == 1) {
      stage_one<T><<<blocks_for(total / 4), NT, 0, s>>>(outr, outi, wr, wi,
                                                        total / 4, ln, scale);
    } else {
      stage_quad<T><<<blocks_for(total / 8), NT, 0, s>>>(
          outr, outi, wr, wi, total / 8, ln, st, scale);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // namespace

// out = FFT(x) (inverse: with the 1/n) along rows of n points; w is the
// fp32 (n,) twiddle table exp(-+2*pi*i*k/n).  log2(n) launches on the
// current stream (stage 0 with the bit-reverse, then stages 1..), one copy
// launch for n = 1; raw bf16 planes for store = 1, raw float16 for store =
// 2.  out must be 16-byte aligned (a fresh allocation).
extern "C" int fft_staged_pass(const void* xr, const void* xi, void* outr,
                               void* outi, const float* wr, const float* wi,
                               long long batch, int n, int inverse, int store,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (batch <= 0 || n < 1 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  if (store == 2)
    return staged<cg::f16>((const cg::f16*)xr, (const cg::f16*)xi,
                           (cg::f16*)outr, (cg::f16*)outi, wr, wi, batch, n,
                           inverse, s);
  using B = unsigned short;
  if (store == 1)
    return staged<B>((const B*)xr, (const B*)xi, (B*)outr, (B*)outi, wr, wi,
                     batch, n, inverse, s);
  return staged<float>((const float*)xr, (const float*)xi, (float*)outr,
                       (float*)outi, wr, wi, batch, n, inverse, s);
}

// Fused spectral convolution over (batch, r, m) real rows, fp32, bf16 or
// float16, m a power of two >= 4: rfft -> pointwise multiply -> irfft with the
// spectrum kept on chip.
//
// Replaces the Pallas kernel repro/kernels/fftconv_fused.py::_fftconv_kernel
// (plain version: repro_torch/kernels/fftconv_fused.py::fftconv_fused_plain).
// Per row: the even/odd samples are the re/im planes of m/2 complex points
// Z, a forward FFT of length m/2, the packed-domain multiply
//   Z'[k] = E[k] Z[k] + F[k] conj(Z[(m/2 - k) mod m/2])
// (E and F fold untangle, filter and pre-tangle; host-built), an inverse
// FFT of length m/2 without 1/n, and the re/im interleave scaled by 2/m.
// E/F are (r, m/2) for a bank shared across the batch or (batch, r, m/2),
// of x's dtype.
//
// Bound on the card: bytes.  At the SSM conv shape (8, 576, 8192) the
// function moves 151 MB of x in, 151 MB of y out and 37.7 MB of E/F,
// 0.101 ms at 3.35 TB/s, against 2.26 GFLOP of FFT work, 0.034 ms at
// 67 TFLOP/s.  The TPU kernel's four-step DFT matmuls suit its matrix unit;
// here each row stays on chip so that x, E/F and y cross HBM once, and the
// FFTs run on fft_stockham's fused radix-4 machinery (stockham.cuh):
//   m <= 16384  fftconv_fused_pass: one launch, a persistent grid walking
//               tiles of G rows (G*m/2 <= 8192 complex points; G chosen by
//               the host so that small banks still fill the SMs) with
//               axis_fft.cuh's tile walk: the next tile is copied in with
//               cp.async, as interleaved complex (the even/odd pack costs
//               nothing), into a second buffer while this one is
//               transformed.  Both FFTs are radix-4 Stockham stages, two a
//               pass in registers (16 points a thread) between
//               shared-memory barriers, off the one (3, m/8) table a
//               direction, the radix-2 tail last for odd log2(m/2).  The
//               multiply is one shared-memory exchange: a thread owns the
//               pair k, m/2 - k, reading both Z and both E/F bins once.
//               The inverse's last pass goes back to shared memory and the
//               rows leave interleaved, scaled by 2/m, 8 contiguous bytes a
//               thread (4 for bf16, float16).  bf16 and float16 x, E/F
//               and y are widened at the load and rounded at the store;
//               the FFTs run in fp32.
//   m > 16384   spectral_section_pass: the multiply alone, one thread per
//               bin over global memory, between the port's 1-D kernels at
//               length m/2 (four-step up to 2^20, Stockham beyond), which
//               the Python wrapper launches; the even/odd split and the
//               interleave are strided torch copies there.
#include "stockham.cuh"

namespace {

constexpr int CONV_NT = 512;      // threads of the largest tile (8192 points)
constexpr int MAX_ONE_PASS = 16384;
constexpr int NT_SECTION = 256;

// Copy tile k: G = 2^lg consecutive rows of m = 2^(ln+1) reals of x (T), as
// one contiguous run of interleaved complex, into the stage; chunks past
// the last row zero-filled
template <class T>
struct ConvCopy {
  const Geo& g;
  float* smem;
  __device__ __forceinline__ void operator()(long long k, int b) const {
    T* st = reinterpret_cast<T*>(smem + b * 2 * g.wf);
    const T* x = static_cast<const T*>(g.xr);
    constexpr int lv = sizeof(T) == 2 ? 3 : 2;    // 16-byte chunks
    const long long run = 2LL << (g.ln + g.lg);
    const long long base = k * run, end = g.outer << (g.ln + 1);
    const int chunks = (int)(run >> lv);
    for (int q = threadIdx.x; q < chunks; q += blockDim.x) {
      const long long src = base + ((long long)q << lv);
      const long long left = end - src;
      const int have = left <= 0 ? 0
                       : left < (1 << lv) ? (int)left * (int)sizeof(T)
                                          : 16;
      copy_async(st + ((long long)q << lv), x + (have ? src : 0), 16, have);
    }
  }
};

// the interleaved (re, im) of one output point: 8 bytes (fp32) or 4 (bf16,
// float16)
__device__ __forceinline__ void store_pair(float* y, float re, float im) {
  *reinterpret_cast<float2*>(y) = make_float2(re, im);
}
__device__ __forceinline__ void store_pair(unsigned short* y, float re,
                                           float im) {
  *reinterpret_cast<unsigned*>(y) =
      (unsigned)cg::f32_to_bf16(re) | ((unsigned)cg::f32_to_bf16(im) << 16);
}
__device__ __forceinline__ void store_pair(cg::f16* y, float re, float im) {
  *reinterpret_cast<unsigned*>(y) =
      (unsigned)cg::f32_to_f16(re) | ((unsigned)cg::f32_to_f16(im) << 16);
}

// the forward's first pass reads element i of row t from the stage: the
// interleaved (re, im) of point t * 2^LN + i
template <class T, int LN>
struct FromInterleaved {
  const T* st;
  __device__ __forceinline__ float2 operator()(int t, int i) const {
    const int a = ((t << LN) + i) << 1;
    return make_float2(widen(st[a]), widen(st[a + 1]));
  }
};

// One tile: forward FFT, the packed-domain multiply, inverse FFT, store
template <int LN, class T>
struct ConvRun {
  const Geo& g;
  float* smem;
  const T* er;
  const T* ei;
  const T* fr;
  const T* fi;
  const float2* tabb;
  T* out;
  int r, shared;
  __device__ __forceinline__ void operator()(long long k, int b) const {
    constexpr int HM = 1 << LN, ROW = HM >= 4 ? HM / 4 : 1;
    float* wr = smem + b * 2 * g.wf;
    float* wi = wr + g.wf;
    const RowsSw rows{g.p};
    const int nt = blockDim.x;
    st_passes<4, LN, 0, 0>(
        FromInterleaved<T, LN>{reinterpret_cast<const T*>(wr)}, wr, wi, rows,
        g.lg, nt, Twiddle{g.tab, 0, 0, 0, ROW, -1.f, 0},
        ToShared<RowsSw>{wr, wi, rows});
    // Z'[k] = E Z[k] + F conj(Z[-k]) and Z'[-k] = E Z[-k] + F conj(Z[k]):
    // thread e owns the pair (k, HM - k) of row t (k = 0 also owns HM/2)
    const long long r0 = k << g.lg;
    const int pairs = HM >> 1;
    const int rmod = shared ? (int)(r0 % r) : 0;   // the bank row of row r0
    for (int e = threadIdx.x; e < (pairs << g.lg); e += nt) {
      const int t = e >> (LN - 1), kk = e & (pairs - 1);
      const long long row = r0 + t;
      if (row >= g.outer) break;
      int br = rmod + t;
      if (br >= r) br %= r;
      const long long bank = ((shared ? (long long)br : row) << LN);
      const int ka = kk == 0 ? 0 : kk, kb = kk == 0 ? pairs : HM - kk;
      const int aa = rows.at(t, ka), ab = rows.at(t, kb);
      const float2 za = make_float2(wr[aa], wi[aa]);
      const float2 zb = make_float2(wr[ab], wi[ab]);
      const long long ea = bank + ka, eb = bank + kb;
      const float2 Ea = make_float2(widen(er[ea]), widen(ei[ea]));
      const float2 Fa = make_float2(widen(fr[ea]), widen(fi[ea]));
      const float2 Eb = make_float2(widen(er[eb]), widen(ei[eb]));
      const float2 Fb = make_float2(widen(fr[eb]), widen(fi[eb]));
      // k = 0 and k = HM/2 pair with themselves
      const float2 ca = kk == 0 ? za : zb, cb = kk == 0 ? zb : za;
      wr[aa] = Ea.x * za.x - Ea.y * za.y + Fa.x * ca.x + Fa.y * ca.y;
      wi[aa] = Ea.x * za.y + Ea.y * za.x + Fa.y * ca.x - Fa.x * ca.y;
      if (HM > 1) {
        wr[ab] = Eb.x * zb.x - Eb.y * zb.y + Fb.x * cb.x + Fb.y * cb.y;
        wi[ab] = Eb.x * zb.y + Eb.y * zb.x + Fb.y * cb.x - Fb.x * cb.y;
      }
    }
    __syncthreads();
    st_passes<4, LN, 0, 0>(FromShared<RowsSw>{wr, wi, rows}, wr, wi, rows,
                           g.lg, nt, Twiddle{tabb, 0, 0, 0, ROW, 1.f, 0},
                           ToShared<RowsSw>{wr, wi, rows});
    // the interleaved store, scaled by 2/m
    const int pts = HM << g.lg;
    for (int e = threadIdx.x; e < pts; e += nt) {
      const long long row = r0 + (e >> LN);
      if (row >= g.outer) break;
      const int a = rows.at(e >> LN, e & (HM - 1));
      store_pair(out + ((row << LN) + (e & (HM - 1))) * 2, wr[a] * g.scale,
                 wi[a] * g.scale);
    }
    __syncthreads();
  }
};

template <int LN, class T>
__global__ void __launch_bounds__(CONV_NT)
conv_tiles(const __grid_constant__ Geo g, const T* __restrict__ er,
           const T* __restrict__ ei, const T* __restrict__ fr,
           const T* __restrict__ fi, const float2* __restrict__ tabb,
           int r, int shared) {
  extern __shared__ float smem[];
  walk_tiles(g, ConvCopy<T>{g, smem},
             ConvRun<LN, T>{g, smem, er, ei, fr, fi, tabb,
                            static_cast<T*>(g.outr), r, shared});
}

using ConvLaunch = cudaError_t (*)(const Geo&, const void*, const void*,
                                   const void*, const void*, const float2*,
                                   int, int, unsigned, int, size_t,
                                   cudaStream_t);

template <int LN, class T>
cudaError_t launch_conv(const Geo& g, const void* er, const void* ei,
                        const void* fr, const void* fi, const float2* tabb,
                        int r, int shared, unsigned blocks, int threads,
                        size_t smem, cudaStream_t st) {
  static int done[16];
  const cudaError_t e = allow_smem(conv_tiles<LN, T>, smem, done);
  if (e != cudaSuccess) return e;
  conv_tiles<LN, T><<<blocks, threads, smem, st>>>(
      g, (const T*)er, (const T*)ei, (const T*)fr, (const T*)fi, tabb, r,
      shared);
  return cudaGetLastError();
}

template <class T, int... L>
ConvLaunch conv_for(int ln, std::integer_sequence<int, L...>) {
  static const ConvLaunch fns[] = {launch_conv<L + 1, T>...};
  return fns[ln - 1];
}

// Z' = E Z + F conj(Z[(hm - k) mod hm]) over (batch, r, hm) split planes
// in global memory, one thread per bin
template <class T>
__global__ void __launch_bounds__(NT_SECTION)
section(const T* __restrict__ zr, const T* __restrict__ zi,
        const T* __restrict__ er, const T* __restrict__ ei,
        const T* __restrict__ fr, const T* __restrict__ fi,
        T* __restrict__ yr, T* __restrict__ yi, long long total,
        long long bank, int lh, int shared) {
  const long long hm = 1LL << lh;
  for (long long t = blockIdx.x * (long long)NT_SECTION + threadIdx.x;
       t < total; t += (long long)gridDim.x * NT_SECTION) {
    const long long k = t & (hm - 1);
    const long long c = t - k + ((hm - k) & (hm - 1));
    const long long e = shared ? t % bank : t;
    const float z_r = widen(zr[t]), z_i = widen(zi[t]);
    const float zcr = widen(zr[c]), zci = widen(zi[c]);
    const float e_r = widen(er[e]), e_i = widen(ei[e]);
    const float f_r = widen(fr[e]), f_i = widen(fi[e]);
    yr[t] = narrow<T>(e_r * z_r - e_i * z_i + f_r * zcr + f_i * zci);
    yi[t] = narrow<T>(e_r * z_i + e_i * z_r + f_i * zcr - f_r * zci);
  }
}

int log2i(long long n) {
  int l = 0;
  while ((1LL << l) < n) ++l;
  return l;
}

}  // namespace

// x (batch, r, m) real -> out (batch, r, m): the one-pass kernel, m <= 16384,
// over tiles of G = 2^lg rows (G*m/2 points, 512 .. 8192) on a persistent
// grid of `blocks`.  (er, ei), (fr, fi): the packed filter pair, (r, m/2)
// when shared != 0, else (batch, r, m/2).  tabf, tabb: the fp32 (3, m/8)
// radix-4 tables of the forward and inverse sign (one entry for m <= 8).
// Raw bf16 x, E/F and out for store = 1, raw float16 for store = 2.
extern "C" int fftconv_fused_pass(const void* x, const void* er,
                                  const void* ei, const void* fr,
                                  const void* fi, const float* tabf,
                                  const float* tabb, void* out,
                                  long long batch, int r, int m, int lg,
                                  int blocks, int shared, int store,
                                  void* stream) {
  if (batch <= 0 || r <= 0 || m < 4 || (m & (m - 1)) || m > MAX_ONE_PASS ||
      lg < 0 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const int ln = log2i(m / 2), lp = ln + lg;
  if (lp > 13 || (1 << lp) < AXIS_TILE_MIN) return (int)cudaErrorInvalidValue;
  const int p = pitch(1 << ln, lg < 3 ? lg : 3);
  const long long wf = (((long long)p << lg) + 31) / 32 * 32;
  const size_t smem = 2 * 2 * sizeof(float) * wf;
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  const long long rows = batch * r;
  const long long tiles = (rows + (1LL << lg) - 1) >> lg;
  const Geo g{x, nullptr, out, nullptr, (const float2*)tabf, nullptr, rows,
              tiles, ln, 0, 0, lg, 2, (int)wf, p, -1.f,
              (float)(2.0 / (double)m)};
  const auto lns = std::make_integer_sequence<int, 13>{};
  const ConvLaunch fn = by_store(store, [&](auto t) {
    return conv_for<typename decltype(t)::type>(ln, lns);
  });
  const unsigned grid = (unsigned)(tiles < blocks ? tiles : blocks);
  return (int)fn(g, er, ei, fr, fi, (const float2*)tabb, r, shared, grid,
                 1 << (lp - 4), smem, (cudaStream_t)stream);
}

// The spectral section of the multi-launch schedule: (zr, zi) the forward
// spectra (batch, r, hm) -> (yr, yi), same shape; E/F as above at hm bins;
// raw bf16 planes for store = 1, raw float16 for store = 2.
extern "C" int spectral_section_pass(const void* zr, const void* zi,
                                     const void* er, const void* ei,
                                     const void* fr, const void* fi,
                                     void* yr, void* yi, long long batch,
                                     int r, int hm, int shared, int store,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (batch <= 0 || r <= 0 || hm < 2 || (hm & (hm - 1)))
    return (int)cudaErrorInvalidValue;
  const long long total = batch * r * (long long)hm;
  long long blocks = (total + NT_SECTION - 1) / NT_SECTION;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  by_store(store, [&](auto t) {
    using B = typename decltype(t)::type;
    section<B><<<(unsigned)blocks, NT_SECTION, 0, s>>>(
        (const B*)zr, (const B*)zi, (const B*)er, (const B*)ei,
        (const B*)fr, (const B*)fi, (B*)yr, (B*)yi, total, (long long)r * hm,
        log2i(hm), shared);
    return 0;
  });
  return (int)cudaGetLastError();
}

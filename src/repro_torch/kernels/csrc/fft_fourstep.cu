// 1-D Bailey four-step FFT, n = n1 * n2, on (batch, n) split fp32 planes.
//
// Replaces the Pallas kernel repro/kernels/fft_fourstep.py::_fourstep_kernel:
// column DFTs of length n1 over x[b, j1*n2 + j2], the twiddle
// T[k1, j2] = W_n^(k1*j2), row DFTs of length n2, the output order
// X[b, k2*n1 + k1], and 1/n on the inverse.  The TPU kernel runs the two
// DFTs as dense matmuls on its matrix unit; here each is a radix-16
// Stockham FFT in shared memory and registers (a radix-2/4/8 pass first
// when log2 of the length is no multiple of 4).
//
// Bound on the card: bytes.  The FFT needs ~5*n*log2(n) flops a row, about
// 3 flops a byte moved, far below the CUDA cores' 20, so the design keeps
// the passes over device memory to the fewest it can:
//   - n <= 2^14: ONE launch, no scratch.  A block holds G whole rows
//     (G*n <= 16384 points, 128 KB of split fp32): its first column pass
//     reads them straight from device memory, then the column FFTs, the
//     twiddle and the row FFTs run in shared memory, and the last pass
//     stores the transposed order;
//   - n > 2^14 (both factors <= 1024): TWO launches, one round trip
//     through scratch.  Pass A: a block loads C = 8192/n1 contiguous j2
//     columns of all n1 rows (C >= 8: every row segment fills whole
//     32-byte sectors), FFTs the columns, applies T and stores its tile
//     as one contiguous 64 KB run of scratch.  Pass B: the first pass of a
//     block gathers R = 8192/n2 consecutive k1 rows from those runs
//     (R*C contiguous floats from each), the FFTs run, and the last pass
//     stores X[b, k2*n1 + k1] with the R consecutive k1 of each k2
//     together (R >= 8), 1/n on the inverse.
// Each thread holds 16 complex points in registers across a pass, in
// blocks of 512 threads, two an SM (64 registers a thread: fewer threads
// with more points each ran slower on the H100); a
// radix-R pass reads its R inputs at stride N/R, twiddles them, runs an
// unrolled radix-2 network and writes them back Stockham-ordered, with a
// barrier on either side.  The two-pass kernels are instantiated for each
// factor 2^5..2^10, so every pass, stride and tile offset is a constant;
// the one-launch kernel picks its passes by the factors' log2.  Threads
// take transforms fastest (up to 32 of them a warp) and row pitches are
// padded so that the reads and most writes hit 32 distinct banks.  No
// tensor cores and no __sincosf:
//   - a pass's twiddles W_N^(e*r) are entries e*r of the N-entry table of
//     its factor (w1 for n1, w2 for n2);
//   - T[k1, j2] = W_n^(k1*j2) is lo[m & (2^s - 1)] * hi[m >> s] of two
//     tables of about sqrt(n) entries (m = k1*j2), looked up twice a
//     butterfly of the last column pass and spread by powers (products of
//     the 1st, 2nd, 4th and 8th, at most six deep).
// The wrapper's table is one float2 array [w1 | w2 | lo | hi]
// (kernels/fft_fourstep.py::kernel_table_np).  The passes, layouts and
// twiddle helpers live in axis_fft.cuh, shared with the 2-D and 3-D kernels.
#include "axis_fft.cuh"

namespace {

constexpr int LTILE = 13;        // log2 of the points a two-pass block holds
constexpr int TILE = 1 << LTILE;
constexpr int NT2 = TILE / E;    // threads a two-pass block
constexpr int ONE_MAX = 16384;   // largest n of the one-launch path
constexpr int MIN_BLOCKS = 264;  // two blocks for each of the H100's SMs

// rows (g, j1) of n points: transform t = (g, j2) at g*n + j2 + i*n2, rows
// g >= rows read as zeros (the one launch's ragged last block)
struct FromRows {
  const float* xr;
  const float* xi;
  int ln2, ln, rows;
  __device__ __forceinline__ float2 operator()(int t, int i) const {
    const int g = t >> ln2;
    const int a = (g << ln) + (t & ((1 << ln2) - 1)) + (i << ln2);
    return g < rows ? make_float2(xr[a], xi[a]) : make_float2(0.f, 0.f);
  }
};

// pass B's gather from pass A's runs: row t, element j2 = (run, c) at
// run * 2^lrun + t*C + c
struct FromRuns {
  const float* yr;
  const float* yi;
  int lc, lrun;
  __device__ __forceinline__ float2 operator()(int t, int i) const {
    const int a = ((i >> lc) << lrun) + (t << lc) + (i & ((1 << lc) - 1));
    return make_float2(yr[a], yi[a]);
  }
};

// the one launch's last column pass: T, then back to shared
struct ColumnsInShared {
  ToShared<Columns> sh;
  Levels tw;
  template <int R>
  __device__ __forceinline__ void put(int t, int k0, int ns, float2* v) const {
    twiddle_t<R>(tw, k0, ns, t & ((1 << sh.lay.ln2) - 1), v);
    sh.template put<R>(t, k0, ns, v);
  }
};

// pass A's last pass: T, then the tile [k1][c] as one contiguous run
template <int C>
struct ColumnsToScratch {
  float* yr;
  float* yi;
  Levels tw;
  int c0;
  template <int R>
  __device__ __forceinline__ void put(int t, int k0, int ns, float2* v) const {
    twiddle_t<R>(tw, k0, ns, c0 + t, v);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = (k0 + r * ns) * C + t;
      yr[a] = v[r].x;
      yi[a] = v[r].y;
    }
  }
};

// the row passes' last pass: X[g, k2*n1 + k1] for row t = (g, k1 - r0),
// rows of g >= rows skipped (the one-launch path's ragged last block)
struct RowsToOutput {
  float* outr;
  float* outi;
  int ln1, ln, lrows, rows, r0;
  float scale;
  template <int R>
  __device__ __forceinline__ void put(int t, int k0, int ns, float2* v) const {
    const int g = t >> lrows;
    if (g >= rows) return;
    const long long base = ((long long)g << ln) + r0 +
                           (t & ((1 << lrows) - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long a = base + ((long long)(k0 + r * ns) << ln1);
      outr[a] = v[r].x * scale;
      outi[a] = v[r].y * scale;
    }
  }
};

struct Tables {
  const float2* w1;
  const float2* w2;
  Levels tw;
};

__device__ __forceinline__ Tables tables(const float2* tab, int ln1, int ln2,
                                         int s) {
  const float2* lo = tab + (1 << ln1) + (1 << ln2);
  return Tables{tab, tab + (1 << ln1), Levels{lo, lo + (1 << s), s}};
}

// n <= 2^14: 2^lg rows a block, both FFTs in shared memory, one launch.
// Rows in shared memory are (g, j1) with pitch p >= n2.
__global__ void __launch_bounds__(1024)
fourstep_one(const float* __restrict__ xr, const float* __restrict__ xi,
             float* __restrict__ outr, float* __restrict__ outi,
             const float2* __restrict__ tab, long long batch, int ln1,
             int ln2, int lg, int p, int s, float sg, float scale) {
  extern __shared__ float smem[];
  const int ln = ln1 + ln2, n1 = 1 << ln1;
  const int nt = blockDim.x;
  float* sr = smem;
  float* si = smem + (n1 << lg) * p;
  const long long g0 = (long long)blockIdx.x << lg;
  const long long left = batch - g0;
  const int rows = left < (1LL << lg) ? (int)left : 1 << lg;
  const Tables tb = tables(tab, ln1, ln2, s);
  // columns: transform t = (g, j2), element j1, read from the input
  const Columns cols{ln2, n1 * p, p};
  fft_any(ln1, FromRows{xr + (g0 << ln), xi + (g0 << ln), ln2, ln, rows}, sr,
          si, cols, lg + ln2, nt, tb.w1, sg,
          ColumnsInShared{ToShared<Columns>{sr, si, cols}, tb.tw});
  // rows: transform t = (g, k1), element j2
  const Rows rws{p};
  fft_any(ln2, FromShared<Rows>{sr, si, rws}, sr, si, rws, lg + ln1, nt,
          tb.w2, sg,
          RowsToOutput{outr + (g0 << ln), outi + (g0 << ln), ln1, ln, ln1,
                       rows, 0, scale});
}

// pass A: C = 2^(13 - LN1) columns j2 = c0.. of every row j1 of batch row
// b; the tile goes to scratch as one run at b*n + c0*n1
template <int LN1>
__global__ void __launch_bounds__(NT2, 2)
fourstep_cols(const float* __restrict__ xr, const float* __restrict__ xi,
              float* __restrict__ yr, float* __restrict__ yi,
              const float2* __restrict__ tab, int ln2, int s, float sg) {
  constexpr int LC = LTILE - LN1, C = 1 << LC;
  extern __shared__ float smem[];
  const int ln = LN1 + ln2;
  float* sr = smem;
  float* si = smem + TILE;
  const long long b = blockIdx.x >> (ln2 - LC);
  const int c0 = (blockIdx.x & ((1 << (ln2 - LC)) - 1)) << LC;
  const long long base = b << ln;
  const Tables tb = tables(tab, LN1, ln2, s);
  const float* xrb = xr + base + c0;
  const float* xib = xi + base + c0;
#pragma unroll 4
  for (int e = threadIdx.x; e < TILE; e += NT2) {
    const int src = ((e >> LC) << ln2) + (e & (C - 1));
    sr[e] = xrb[src];
    si[e] = xib[src];
  }
  __syncthreads();
  const long long run = base + ((long long)c0 << LN1);
  const Columns tile{LC, 0, C};
  passes<LN1, 0>(FromShared<Columns>{sr, si, tile}, sr, si, tile, LC, NT2,
                 tb.w1, sg,
                 ColumnsToScratch<C>{yr + run, yi + run, tb.tw, c0});
}

// pass B: R = 2^(13 - LN2) rows k1 = r0.. of batch row b, pitch P, gathered
// from pass A's runs (R*C contiguous floats from each)
template <int LN2>
__global__ void __launch_bounds__(NT2, 2)
fourstep_rows(const float* __restrict__ yr, const float* __restrict__ yi,
              float* __restrict__ outr, float* __restrict__ outi,
              const float2* __restrict__ tab, int ln1, int s, float sg,
              float scale) {
  constexpr int LR = LTILE - LN2, P = pitch(1 << LN2, LR);
  extern __shared__ float smem[];
  const int ln = ln1 + LN2, lc = LTILE - ln1;
  float* sr = smem;
  float* si = smem + (P << LR);
  const long long b = blockIdx.x >> (ln1 - LR);
  const int r0 = (blockIdx.x & ((1 << (ln1 - LR)) - 1)) << LR;
  const long long base = b << ln;
  const Tables tb = tables(tab, ln1, LN2, s);
  // row kk's element j2 = (run g, column c): scratch[g*n1*C + (r0 + kk)*C + c]
  const long long from = base + ((long long)r0 << lc);
  passes<LN2, 0>(FromRuns{yr + from, yi + from, lc, ln1 + lc}, sr, si,
                 Rows{P}, LR, NT2, tb.w2, sg,
                 RowsToOutput{outr + base, outi + base, ln1, ln, LR, 1, r0,
                              scale});
}

template <int LN1>
cudaError_t launch_cols(unsigned blocks, const float* xr, const float* xi,
                        float* yr, float* yi, const float2* tw, int ln2,
                        int s, float sg, cudaStream_t st) {
  static int done[16];
  const size_t smem = 2 * sizeof(float) * TILE;
  cudaError_t e = allow_smem(fourstep_cols<LN1>, smem, done);
  if (e != cudaSuccess) return e;
  fourstep_cols<LN1><<<blocks, NT2, smem, st>>>(xr, xi, yr, yi, tw, ln2, s,
                                                sg);
  return cudaGetLastError();
}

template <int LN2>
cudaError_t launch_rows(unsigned blocks, const float* yr, const float* yi,
                        float* outr, float* outi, const float2* tw, int ln1,
                        int s, float sg, float scale, cudaStream_t st) {
  static int done[16];
  constexpr int LR = LTILE - LN2, P = pitch(1 << LN2, LR);
  const size_t smem = 2 * sizeof(float) * (P << LR);
  cudaError_t e = allow_smem(fourstep_rows<LN2>, smem, done);
  if (e != cudaSuccess) return e;
  fourstep_rows<LN2><<<blocks, NT2, smem, st>>>(yr, yi, outr, outi, tw, ln1,
                                                s, sg, scale);
  return cudaGetLastError();
}

}  // namespace

// out = FFT(x) (inverse: with 1/n) along rows of n = n1*n2 points, both
// factors powers of two in [2, 1024].  `tab` is the float2 table
// [w1 (n1) | w2 (n2) | lo (2^s) | hi (n / 2^s)], s = ceil(log2(n) / 2).
// One launch for n <= 2^14 (sr/si unused); else two, through the scratch
// planes sr/si, on the current stream.
extern "C" int fft_fourstep_f32(const float* xr, const float* xi,
                                float* outr, float* outi,
                                float* sr, float* si, const float* tab,
                                long long batch, int n1, int n2, int inverse,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ln1 = log2_exact(n1), ln2 = log2_exact(n2);
  if (ln1 < 1 || ln2 < 1 || ln1 > 10 || ln2 > 10 || batch <= 0)
    return (int)cudaErrorInvalidValue;
  const int ln = ln1 + ln2, s = (ln + 1) / 2;
  const long long n = 1LL << ln;
  const float sg = inverse ? 1.f : -1.f;
  const float scale = inverse ? (float)(1.0 / (double)n) : 1.f;
  const float2* tw = (const float2*)tab;
  cudaError_t e;
  if (n <= ONE_MAX) {
    // rows a block: up to 8192 points (16384 for n = 2^14), at least 512
    // (a warp), fewer while that leaves the card short of blocks
    int lg = ln < 13 ? 13 - ln : 0;
    const int lg_min = ln < 9 ? 9 - ln : 0;
    while (lg > lg_min && ((batch + (1LL << lg) - 1) >> lg) < MIN_BLOCKS)
      --lg;
    const int p = pitch(n2, lg + ln1);
    const int threads = 1 << (ln + lg - 4);
    const size_t smem = 2 * sizeof(float) * ((size_t)n1 << lg) * p;
    static int done[16];
    e = allow_smem(fourstep_one, smem, done);
    if (e != cudaSuccess) return (int)e;
    const unsigned blocks = (unsigned)((batch + (1LL << lg) - 1) >> lg);
    fourstep_one<<<blocks, threads, smem, st>>>(xr, xi, outr, outi, tw, batch,
                                                ln1, ln2, lg, p, s, sg, scale);
    return (int)cudaGetLastError();
  }
  // n > 2^14 with both factors <= 1024: n1, n2 >= 32, C = 8192/n1 divides
  // n2 and R = 8192/n2 divides n1
  using Cols = decltype(&launch_cols<10>);
  using Rws = decltype(&launch_rows<10>);
  static const Cols cols[] = {launch_cols<5>, launch_cols<6>, launch_cols<7>,
                              launch_cols<8>, launch_cols<9>, launch_cols<10>};
  static const Rws rows[] = {launch_rows<5>, launch_rows<6>, launch_rows<7>,
                             launch_rows<8>, launch_rows<9>, launch_rows<10>};
  const unsigned blocks = (unsigned)(batch << (ln - LTILE));
  e = cols[ln1 - 5](blocks, xr, xi, sr, si, tw, ln2, s, sg, st);
  if (e != cudaSuccess) return (int)e;
  e = rows[ln2 - 5](blocks, sr, si, outr, outi, tw, ln1, s, sg, scale, st);
  return (int)e;
}

// The axis route (factors past 1024, bf16 or float16 planes; see
// axis_fft_launch in axis_fft.cuh): one launch of kernels/fft_fourstep.py::axis_plan.
extern "C" int fft_fourstep_axis(const void* xr, const void* xi, void* outr,
                                 void* outi, const float* tab,
                                 const float* tab2, long long outer, int ln,
                                 int linner, int lc, int lg, int plane,
                                 int blocks, int inverse, float scale,
                                 int store, int mode, const float* tw,
                                 int tls, int ljr, int lr1, int lr2,
                                 long long img_in, long long img_out,
                                 void* stream) {
  return (int)axis_fft_launch(xr, xi, outr, outi, tab, tab2, outer, ln,
                              linner, lc, lg, plane, blocks, inverse, scale,
                              store, mode, tw, tls, ljr, lr1, lr2, img_in,
                              img_out, (cudaStream_t)stream);
}

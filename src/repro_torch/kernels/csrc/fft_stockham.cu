// Mixed radix-4 / radix-2 Stockham autosort FFT on (batch, n) split fp32
// planes, n a power of two >= 2, and its pure radix-2 twin.
//
// Replaces the Pallas kernels repro/kernels/fft_stockham.py::_stockham_kernel
// (radix=4; stage arithmetic repro_torch/core/fft1d.py::stockham_stages)
// and ::_stockham_kernel_r2 (radix=2; fft1d.py::stockham_radix2_stages).
// The TPU kernel keeps a whole row in VMEM for all stages.
//
// Both radices run the reference's butterflies in its stage order (radix
// 4: radix-4 stages, then a radix-2 tail of twiddle 1 for odd log2 n;
// radix 2: a + b and (a - b) * w), up to four bits of stages a pass in
// registers (16 points a thread) between shared-memory barriers, over
// tiles copied in with cp.async (axis_fft.cuh's tile walk), so a launch is
// one pass over HBM:
//   n <= 2^14  ONE launch: a tile holds G whole rows and runs every stage;
//   above      TWO launches (n <= 2^24).  With n = M * Q, M = 2^l1: stages
//              of bits 0..l1-1 act on the M points {q + r*Q} of each
//              column q of the (M, Q) view, and launch A runs them on tiles
//              of C adjacent columns, writing each point back where its
//              column lies (x -> scratch); the other stages act on each
//              stride-M subset {k + t*M} of their output, and are exactly
//              the length-Q Stockham there, so launch B runs them on rows k
//              of the scratch (G rows a tile) and stores row k's point t at
//              t*M + k of out, C-wide segments.  Radix 2 splits at
//              l1 = ceil(log2 n / 2); radix 4 at an even l1, so that launch
//              A holds whole radix-4 stages (the tail runs in launch B):
//              2 * floor((log2 n + 1) / 4), 12 from 2^22
//              (kernels/fft_stockham.py::split).
// Passes start at bit 0 and take four bits each, so a pass boundary is a
// radix-4 stage boundary and a pass is two radix-4 stages (or one, and the
// tail, at its end).  The stages, passes, layouts and twiddles live in
// stockham.cuh, which fft2d_fused.cu shares.
// One table a radix.  Radix 2: W_n^m for m < n/2; stage s's twiddle at
// butterfly j is row s of the packed (stages, n/2) table, which is entry
// (j >> s) << s of row 0 bit for bit (the float64 angles are equal).
// Radix 4: row 0 of the packed (s4, 3, n/4) table, w, w^2 and w^3 as three
// rows of n/4; radix-4 stage s reads entry (j >> 2s) << 2s of each, bit for
// bit row s of the packed table: 25 MB a direction at 2^22 against 277.
// Bound by bytes: 16 a point in and out a launch, ~4.25 flops a point a
// radix-2 bit.  The inverse's 1/n is applied at the last store.
//
// n > 2^24 (radix 4 only): one launch a radix-4 stage over global
// ping-pong buffers (one thread a butterfly, the four quarter slices
// x[j + r*q] in, the interleaved (m, 4, stride) positions out), off the
// same one table, then the radix-2 tail: log2(n)/2 + 1 passes over HBM.
#include "stockham.cuh"

namespace {

constexpr int NT = 256;

// radix-4 stage `ls / 2` of the per-stage route: twiddles w^r at entry
// (j >> ls) << ls of row r - 1 of the one (3, n/4) table
__global__ void __launch_bounds__(NT)
r4_stage(const float* __restrict__ xr, const float* __restrict__ xi,
         float* __restrict__ yr, float* __restrict__ yi,
         const float2* __restrict__ w, long long total, int lq, int ls,
         int inverse, float scale) {
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
    const long long m = (j >> ls) << ls;
    const float2 w1 = w[m], w2 = w[q + m], w3 = w[2 * q + m];
    const float b1r = y1r * w1.x - y1i * w1.y, b1i = y1r * w1.y + y1i * w1.x;
    const float b2r = y2r * w2.x - y2i * w2.y, b2i = y2r * w2.y + y2i * w2.x;
    const float b3r = y3r * w3.x - y3i * w3.y, b3i = y3r * w3.y + y3i * w3.x;
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

unsigned blocks_for(long long total) {
  const long long b = (total + NT - 1) / NT;
  return (unsigned)(b < (1LL << 20) ? b : (1LL << 20));
}

}  // namespace

// The per-stage route of the radix-4 kernel (n > 2^24): x -> out through
// the scratch pair (sr, si); `tab` the one (3, n/4) table of float2.
extern "C" int fft_stockham_f32(const float* xr, const float* xi,
                                float* outr, float* outi,
                                float* sr, float* si, const float* tab,
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
          src_r, src_i, dst_r[d], dst_i[d], (const float2*)tab, total,
          ln - 2, 2 * st, inverse, scale);
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


// -- the fused kernels (both radices) -----------------------------------

namespace {

enum { ST_ROWS = 0, ST_COLS = 1, ST_TRANSPOSED = 2 };

// One tile's stages: rows (ST_ROWS: every stage, stored as rows;
// ST_TRANSPOSED: launch B, stored as columns) or columns (ST_COLS: launch
// A); `row` the radix-4 table's row length
template <int RX, int LN, int ROUTE>
struct StRun {
  const Geo& g;
  float* smem;
  int lv, mask, l1, row;
  __device__ __forceinline__ void operator()(long long k, int b) const {
    float* wr = smem + b * 2 * g.wf;
    float* wi = wr + g.wf;
    const float* sr = wr;
    const float* si = sr + (1 << (LN + g.lc + g.lg));
    const int nt = blockDim.x;
    if constexpr (ROUTE == ST_COLS) {
      const int cpi = g.linner - g.lc;
      const int q0 = (int)((k & ((1LL << cpi) - 1)) << g.lc);
      const Columns stage{g.lc, 1 << (LN + g.lc), 1 << g.lc};
      st_passes<RX, LN, 0, 5>(FromStage<float, Columns>{sr, si, stage}, wr,
                              wi, ColsSw{g.lc}, g.lc, nt,
                              Twiddle{g.tab, q0, g.linner, 0, row, g.sg},
                              to_global<float>(g, k));
    } else {
      const RowsSw rows{g.p};
      const FromStage<float, Swizzled> in{sr, si, Swizzled{LN, lv, mask}};
      if constexpr (ROUTE == ST_TRANSPOSED) {
        st_passes<RX, LN, 0, 3>(in, wr, wi, rows, g.lg, nt,
                                Twiddle{g.tab, 0, 0, l1, row, g.sg},
                                ToColumns{static_cast<float*>(g.outr),
                                          static_cast<float*>(g.outi),
                                          k << g.lg, g.outer, l1, LN,
                                          g.scale});
      } else {
        st_passes<RX, LN, 0, 3>(in, wr, wi, rows, g.lg, nt,
                                Twiddle{g.tab, 0, 0, 0, row, g.sg},
                                ToShared<RowsSw>{wr, wi, rows});
        st_store_rows<LN>(g, k, wr, wi, rows);
      }
    }
  }
};

template <int RX, int LN, int ROUTE, int NT>
__global__ void __launch_bounds__(NT, 1)
st_fft(const __grid_constant__ Geo g, int l1, int row) {
  extern __shared__ float smem[];
  const int lv = chunk_log<float>(g);
  const int mask = ROUTE != ST_COLS && LN - lv >= 3 ? 7 : 0;
  walk_tiles(g, TileCopy<float>{g, smem, lv, LN, mask},
             StRun<RX, LN, ROUTE>{g, smem, lv, mask, l1, row});
}

using StLaunch = cudaError_t (*)(const Geo&, int, int, unsigned, int, size_t,
                                 cudaStream_t);

template <int RX, int LN, int ROUTE, int NT>
cudaError_t launch_st(const Geo& g, int l1, int row, unsigned blocks,
                      int threads, size_t smem, cudaStream_t st) {
  static int done[16];
  const cudaError_t e = allow_smem(st_fft<RX, LN, ROUTE, NT>, smem, done);
  if (e != cudaSuccess) return e;
  st_fft<RX, LN, ROUTE, NT><<<blocks, threads, smem, st>>>(g, l1, row);
  return cudaGetLastError();
}

template <int RX, int ROUTE, int FIRST, int NT, int... L>
StLaunch st_for(int ln, std::integer_sequence<int, L...>) {
  static const StLaunch fns[] = {launch_st<RX, L + FIRST, ROUTE, NT>...};
  return fns[ln - FIRST];
}

// The kernel of a launch: rows up to 2^13 points a row with 512 threads,
// 2^14 with 1024; launch A's columns of 2^8 .. 2^10 points (8192-point
// tiles, 512 threads) or 2^11, 2^12 (16384, 1024), radix 4 the even ones;
// launch B's rows of 2^7 .. 2^12.  Null for any other.
template <int RX>
StLaunch st_pick(int route, int ln, int threads) {
  if (route == ST_ROWS) {
    if (ln == 14)
      return threads == 1024 ? launch_st<RX, 14, ST_ROWS, 1024> : nullptr;
    return ln >= 1 && ln <= 13 && threads <= 512
               ? st_for<RX, ST_ROWS, 1, 512>(
                     ln, std::make_integer_sequence<int, 13>{})
               : nullptr;
  }
  if (route == ST_COLS) {
    if constexpr (RX == 4) {
      if (ln == 8 && threads <= 512) return launch_st<4, 8, ST_COLS, 512>;
      if (ln == 10 && threads <= 512) return launch_st<4, 10, ST_COLS, 512>;
      if (ln == 12) return launch_st<4, 12, ST_COLS, 1024>;
      return nullptr;
    } else {
      if (ln >= 8 && ln <= 10 && threads <= 512)
        return st_for<2, ST_COLS, 8, 512>(
            ln, std::make_integer_sequence<int, 3>{});
      if (ln >= 11 && ln <= 12)
        return st_for<2, ST_COLS, 11, 1024>(
            ln, std::make_integer_sequence<int, 2>{});
      return nullptr;
    }
  }
  if (route == ST_TRANSPOSED && ln >= 7 && ln <= 12 && threads <= 512)
    return st_for<RX, ST_TRANSPOSED, 7, 512>(
        ln, std::make_integer_sequence<int, 6>{});
  return nullptr;
}

// One launch of the fused kernel of radix RX; the arguments of
// fft_stockham_r2_pass and fft_stockham_r4_pass.
template <int RX>
int stockham_pass(const float* xr, const float* xi, float* outr, float* outi,
                  const float* tab, long long outer, int ln, int linner,
                  int lc, int lg, int route, int l1, int blocks, float scale,
                  float sg, cudaStream_t stream) {
  const int lp = ln + lc + lg;
  const bool rows = route == ST_ROWS || route == ST_TRANSPOSED;
  if (outer <= 0 || blocks <= 0 || ln < 1 || lc < 0 || lg < 0 || lp > 14 ||
      (1 << lp) < AXIS_TILE_MIN || (lp == 14 && lg != 0) ||
      (rows && (linner != 0 || lc != 0)) ||
      (route == ST_COLS && (lg != 0 || lc >= linner || ln + linner > 24)) ||
      (route == ST_TRANSPOSED && (l1 < 1 || l1 + ln > 24)) ||
      (RX == 4 && ((route == ST_COLS && (ln & 1)) ||
                   (route == ST_TRANSPOSED && (l1 & 1)))))
    return (int)cudaErrorInvalidValue;
  const int threads = 1 << (lp - 4);
  const StLaunch fn = st_pick<RX>(route, ln, threads);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int p = 0;
  long long wf = 1LL << lp;
  if (rows) {
    p = pitch(1 << ln, lg < 3 ? lg : 3);
    wf = (long long)p << lg;
  }
  wf = (wf + 31) / 32 * 32;
  const int nbuf = (1 << lp) <= AXIS_TILE ? 2 : 1;
  const size_t smem = (size_t)nbuf * 2 * sizeof(float) * wf;
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  const long long per = (outer + (1LL << lg) - 1) >> lg;
  // the whole transform's log2 length, for the radix-4 table's rows
  const int lnf = route == ST_COLS ? ln + linner
                  : route == ST_TRANSPOSED ? l1 + ln : ln;
  const int row = lnf >= 2 ? 1 << (lnf - 2) : 0;
  const Geo g{xr, xi, outr, outi, (const float2*)tab, nullptr, outer,
              per << (linner - lc), ln, linner, lc, lg, nbuf, (int)wf, p,
              sg, scale};
  const unsigned grid = (unsigned)(g.tiles < blocks ? g.tiles : blocks);
  return (int)fn(g, l1, row, grid, threads, smem, stream);
}

}  // namespace

// One launch of the fused kernel x -> out over (outer, 2^ln, 2^linner)
// with the tiling the host planned (kernels/fft_stockham.py::plan):
// ST_ROWS (linner = 0; G = 2^lg rows a tile; every stage), ST_COLS (launch
// A: tiles of 2^lc of the 2^linner columns, stages of bits 0..ln-1 of
// length n = 2^(ln + linner)) or ST_TRANSPOSED (launch B: rows of 2^ln,
// stages of bits l1.. of n = 2^(l1 + ln), out[image][m][row mod 2^l1]);
// `scale` at the store; `blocks` the persistent grid.  Returns
// cudaErrorInvalidValue for a tiling it does not take.
// Radix 2: `tab` the fp32 W_n^m, m < n/2, of the transform's sign as
// (cos, sin) pairs.
extern "C" int fft_stockham_r2_pass(const float* xr, const float* xi,
                                    float* outr, float* outi,
                                    const float* tab, long long outer, int ln,
                                    int linner, int lc, int lg, int route,
                                    int l1, int blocks, float scale,
                                    void* stream) {
  return stockham_pass<2>(xr, xi, outr, outi, tab, outer, ln, linner, lc, lg,
                          route, l1, blocks, scale, -1.f,
                          (cudaStream_t)stream);
}

// Radix 4 (l1 even, so launch A holds whole radix-4 stages): `tab` the fp32
// (3, n/4) table w, w^2, w^3 of the transform's sign (`inverse`) as
// (cos, sin) pairs.
extern "C" int fft_stockham_r4_pass(const float* xr, const float* xi,
                                    float* outr, float* outi,
                                    const float* tab, long long outer, int ln,
                                    int linner, int lc, int lg, int route,
                                    int l1, int blocks, float scale,
                                    int inverse, void* stream) {
  return stockham_pass<4>(xr, xi, outr, outi, tab, outer, ln, linner, lc, lg,
                          route, l1, blocks, scale, inverse ? 1.f : -1.f,
                          (cudaStream_t)stream);
}

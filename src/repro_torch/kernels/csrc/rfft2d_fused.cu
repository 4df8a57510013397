// Real-input 2-D FFT over (batch, h, w) fp32 images, h and w powers of two
// >= 2, and its inverse: real (batch, h, w) <-> split half spectra
// (batch, h, c), c = w/2 + 1.
//
// Replaces the Pallas kernels repro/kernels/rfft2d_fused.py::_rfft2d_kernel
// and ::_irfft2d_kernel.  The TPU kernel holds a whole image in VMEM; a
// 1024^2 real plane is 4 MB against 227 KB of shared memory per block.  The
// function is bound by bytes (4 a real point, 8 a half-spectrum bin; ~2.5
// log2(N) flops a point), so the forward is two launches, each one pass
// over HBM, on the shared-memory FFT passes of axis_fft.cuh (persistent
// grids, tiles copied in with cp.async while the last one is transformed):
//   row pass     rows 2j and 2j+1 of the real image are the re and im
//                planes of one complex row (base x and x + w, row pitch 2w:
//                the packing costs no copy); a tile holds G packed rows
//                and runs the rows route's radix-16 passes; the untangle
//                happens at the store, from shared memory:
//                A = (Z[k] + conj(Z[-k]))/2, B = -i(Z[k] - conj(Z[-k]))/2
//                for k = 0..w/2, written as rows 2j and 2j+1 of a scratch
//                pair of row pitch P (c rounded up to min(C, 8), so that
//                no C-column row segment straddles a 32-byte sector);
//   column pass  the length-h FFT along axis -2 of the scratch: tiles of C
//                adjacent columns of all h rows (the last one ragged: its
//                chunks past P are zero-filled, its columns >= c never
//                stored), or G whole images where h * 2^ceil(log2 c) points
//                fit a tile (P = C then); stored from registers to the
//                (batch, h, c) output.  kernels/axis_fft.py::plan_half_cols
//                plans it.
// The inverse stays on the five-launch four-step GEMM chain:
//   column pass  four-step GEMMs along axis -2 of the half-width tile; c is
//                not a power of two, so the j2 axis of the first
//                contraction is folded into the batch index, and its left
//                operand is the j2-th of n2 host-built copies of W1 with
//                the twiddle folded in, V[j2][k1, a] = T[k1, j2] * W1[k1, a]
//                (the GEMM's own epilogue twiddle cannot index by j2;
//                giving it a batch index cost the other kernels 12-14 % of
//                their time, PERF.md);
//   repack       Z = A_ext + i B_ext (the Hermitian extension of each row
//                pair, the imaginary parts of the DC and Nyquist bins
//                dropped);
//   row pass     the inverse four-step row pass (row_pass.cuh, two GEMMs)
//                whose last GEMM stores re to row 2j and im to row 2j+1 of
//                the real output, scaled by 1/(h*w).
// The GEMM chain does 8*n*(n1+n2) flops per row and column on the CUDA
// cores, so it is bound by those fp32 operations plus its HBM round trips.
#include "axis_fft.cuh"
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

// -- the forward: two launches on axis_fft.cuh's passes --------------------

// Copy packed row tile k: G rows of 2^ln points, row R's re plane at
// x + R * 2^(ln+1), its im plane 2^ln further, swizzled by row as the rows
// route's tiles are (Swizzled); rows past `outer` zero-filled.
struct PackedCopy {
  const Geo& g;
  float* smem;
  int lv, mask;
  __device__ __forceinline__ void operator()(long long k, int b) const {
    float* sr = smem + b * 2 * g.wf;
    float* si = sr + (1 << (g.ln + g.lg));
    const float* x = static_cast<const float*>(g.xr);
    const int bytes = 4 << lv;
    const int chunks = 1 << (g.ln + g.lg - lv);
    for (int q = threadIdx.x; q < chunks; q += blockDim.x) {
      const int e = q << lv;
      const long long row = (k << g.lg) + (e >> g.ln);
      long long src = (row << (g.ln + 1)) + (e & ((1 << g.ln) - 1));
      long long im = 1LL << g.ln;
      int have = bytes;
      if (row >= g.outer) {
        have = 0;
        src = im = 0;
      }
      const int s = e ^ (((e >> g.ln) & mask) << lv);
      copy_async(sr + s, x + src, bytes, have);
      copy_async(si + s, x + src + im, bytes, have);
    }
  }
};

// The untangle of a rows tile's spectra Z (rows of pitch g.p in shared
// memory) at the store: bins k = 0..2^(LN-1) of packed row R to rows 2R
// (A) and 2R+1 (B) of the (pitch P) scratch, the arithmetic of
// rfft2d_fused_plain's untangle
template <int LN>
__device__ __forceinline__ void store_untangled(const Geo& g, long long k,
                                                const float* zr,
                                                const float* zi, int P) {
  constexpr int W = 1 << LN, CW = W / 2 + 1;
  float* yr = static_cast<float*>(g.outr);
  float* yi = static_cast<float*>(g.outi);
  const long long r0 = k << g.lg;
  const int n = CW << g.lg;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int t = e / CW, kk = e - t * CW;
    const long long row = r0 + t;
    if (row >= g.outer) break;
    const int a = t * g.p + kk, ac = t * g.p + ((W - kk) & (W - 1));
    const float rk = zr[a], ik = zi[a], cr = zr[ac], ci = zi[ac];
    const long long oa = 2 * row * P + kk, ob = oa + P;
    yr[oa] = (rk + cr) * 0.5f;
    yi[oa] = (ik - ci) * 0.5f;
    yr[ob] = (ik + ci) * 0.5f;
    yi[ob] = (cr - rk) * 0.5f;
  }
  __syncthreads();
}

template <int LN>
struct PackedRun {
  const Geo& g;
  float* smem;
  int lv, mask, P;
  __device__ __forceinline__ void operator()(long long k, int b) const {
    float* wr = smem + b * 2 * g.wf;
    float* wi = wr + g.wf;
    const float* sr = wr;
    const float* si = sr + (1 << (LN + g.lg));
    const Rows rows{g.p};
    passes<LN, 0, 3, true>(
        FromStage<float, Swizzled>{sr, si, Swizzled{LN, lv, mask}}, wr, wi,
        rows, g.lg, blockDim.x, g.tab, g.sg, ToShared<Rows>{wr, wi, rows});
    store_untangled<LN>(g, k, wr, wi, P);
  }
};

// The row pass: packed rows of 2^LN points -> untangled half spectra.
template <int LN>
__global__ void __launch_bounds__(512, 1)
rfft_rows(const __grid_constant__ Geo g, int P) {
  extern __shared__ float smem[];
  constexpr int lv = LN < 2 ? LN : 2;
  const int mask = LN - lv >= 3 ? 7 : 0;
  walk_tiles(g, PackedCopy{g, smem, lv, mask},
             PackedRun<LN>{g, smem, lv, mask, P});
}

// Where tile k of the column pass lies: tpi tiles an image of C columns
// (the image's first column c0), or (tpi = 1) G whole images of pitch C
struct HalfTile {
  long long o0;
  int c0;
  __device__ __forceinline__ HalfTile(const Geo& g, long long k, int tpi) {
    if (tpi == 1) {
      o0 = k << g.lg;
      c0 = 0;
    } else {
      o0 = k / tpi;
      c0 = (int)(k - o0 * tpi) << g.lc;
    }
  }
};

// Copy column tile k of the (outer, 2^ln, P) scratch as it lies (Columns):
// C-column row segments, the chunks at or past column P zero-filled; or a
// run of whole images, those past `outer` zero-filled
struct HalfCopy {
  const Geo& g;
  float* smem;
  int lv, P, tpi;
  __device__ __forceinline__ void operator()(long long k, int b) const {
    float* sr = smem + b * 2 * g.wf;
    float* si = sr + (1 << (g.ln + g.lc + g.lg));
    const float* xr = static_cast<const float*>(g.xr);
    const float* xi = static_cast<const float*>(g.xi);
    const HalfTile at(g, k, tpi);
    const long long img = (long long)P << g.ln;
    const int bytes = 4 << lv;
    const int chunks = 1 << (g.ln + g.lc + g.lg - lv);
    for (int q = threadIdx.x; q < chunks; q += blockDim.x) {
      const int e = q << lv;
      long long src;
      int have = bytes;
      if (tpi == 1) {
        src = at.o0 * img + e;
        if (src >= g.outer * img) have = 0;
      } else {
        const int col = at.c0 + (e & ((1 << g.lc) - 1));
        src = at.o0 * img + (long long)(e >> g.lc) * P + col;
        if (col >= P) have = 0;
      }
      if (have == 0) src = 0;
      copy_async(sr + e, xr + src, bytes, have);
      copy_async(si + e, xi + src, bytes, have);
    }
  }
};

// the column pass's last pass: element m of transform t = (image o0 +
// (t >> lc), column c0 + (t mod 2^lc)) to (image * h + m) * width + column,
// columns >= width and images >= outer skipped
struct ToHalf {
  float* outr;
  float* outi;
  long long o0, outer;
  int c0, lc, lh, width;
  template <int R>
  __device__ __forceinline__ void put(int t, int k0, int ns, float2* v) const {
    const long long o = o0 + (t >> lc);
    const int col = c0 + (t & ((1 << lc) - 1));
    if (o >= outer || col >= width) return;
    const long long base = (o << lh) * width + col;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long a = base + (long long)(k0 + r * ns) * width;
      outr[a] = v[r].x;
      outi[a] = v[r].y;
    }
  }
};

template <int LN>
struct HalfRun {
  const Geo& g;
  float* smem;
  int tpi, width;
  __device__ __forceinline__ void operator()(long long k, int b) const {
    float* wr = smem + b * 2 * g.wf;
    float* wi = wr + g.wf;
    const float* sr = wr;
    const float* si = sr + (1 << (LN + g.lc + g.lg));
    const HalfTile at(g, k, tpi);
    const Columns cols{g.lc, 1 << (LN + g.lc), 1 << g.lc};
    passes<LN, 0, -1, true>(
        FromStage<float, Columns>{sr, si, cols}, wr, wi, cols, g.lc + g.lg,
        blockDim.x, g.tab, g.sg,
        ToHalf{static_cast<float*>(g.outr), static_cast<float*>(g.outi),
               at.o0, g.outer, at.c0, g.lc, LN, width});
  }
};

// The column pass: length 2^LN along axis -2 of the scratch.
template <int LN, int NT>
__global__ void __launch_bounds__(NT, 1)
rfft_cols(const __grid_constant__ Geo g, int P, int width, int tpi) {
  extern __shared__ float smem[];
  const int run = tpi == 1 ? g.ln + g.lc + g.lg : g.lc;
  const int lv = run < 2 ? run : 2;
  walk_tiles(g, HalfCopy{g, smem, lv, P, tpi},
             HalfRun<LN>{g, smem, tpi, width});
}

template <int LN>
cudaError_t launch_rows(const Geo& g, unsigned blocks, int threads,
                        size_t smem, int P, cudaStream_t st) {
  static int done[16];
  const cudaError_t e = allow_smem(rfft_rows<LN>, smem, done);
  if (e != cudaSuccess) return e;
  rfft_rows<LN><<<blocks, threads, smem, st>>>(g, P);
  return cudaGetLastError();
}

template <int LN, int NT>
cudaError_t launch_cols(const Geo& g, unsigned blocks, int threads,
                        size_t smem, int P, int width, int tpi,
                        cudaStream_t st) {
  static int done[16];
  const cudaError_t e = allow_smem(rfft_cols<LN, NT>, smem, done);
  if (e != cudaSuccess) return e;
  rfft_cols<LN, NT><<<blocks, threads, smem, st>>>(g, P, width, tpi);
  return cudaGetLastError();
}

using RowsLaunch = cudaError_t (*)(const Geo&, unsigned, int, size_t, int,
                                   cudaStream_t);
using ColsLaunch = cudaError_t (*)(const Geo&, unsigned, int, size_t, int,
                                   int, int, cudaStream_t);

template <int... L>
RowsLaunch rows_for(int ln, std::integer_sequence<int, L...>) {
  static const RowsLaunch fns[] = {launch_rows<L + 1>...};
  return fns[ln - 1];
}

// columns of up to 1024 points in 8192-point tiles (512 threads), of 2048
// and 4096 in up to 16384 (1024)
template <int... L>
ColsLaunch cols_for(int ln, std::integer_sequence<int, L...>) {
  static const ColsLaunch fns[] = {
      launch_cols<L + 1, (L + 1 > 10 ? 1024 : 512)>...};
  return fns[ln - 1];
}

}  // namespace

// x (batch, 2^lh, 2^lw) real -> (outr, outi) (batch, 2^lh, w/2+1) in two
// launches with the tiling kernels/rfft2d_fused.py planned: the row pass
// (G = 2^row_lg packed rows a tile) into the scratch pair (sr, si), row
// pitch `pitch`, then the column pass (2^col_lc columns and 2^col_lg
// images a tile); tabw and tabh the fp32 W_n^k, k < n, of the forward
// sign for n = w and h; the blocks of each persistent grid.  Returns
// cudaErrorInvalidValue for a tiling it does not take.
extern "C" int rfft2d_fused_f32(const float* x, float* outr, float* outi,
                                float* sr, float* si, const float* tabw,
                                const float* tabh, long long batch, int lh,
                                int lw, int pitch_, int row_lg,
                                int row_blocks, int col_lc, int col_lg,
                                int col_blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int width = (1 << lw) / 2 + 1, C = 1 << col_lc;
  const int rp = lw + row_lg, cp = lh + col_lc + col_lg;
  const bool whole = C == pitch_;
  if (batch <= 0 || lh < 1 || lh > 12 || lw < 1 || lw > 12 || row_lg < 0 ||
      col_lc < 0 || col_lg < 0 || row_blocks <= 0 || col_blocks <= 0 ||
      rp > 13 || (1 << rp) < AXIS_TILE_MIN || cp > 14 ||
      (1 << cp) < AXIS_TILE_MIN || (cp == 14 && lh < 11) ||
      pitch_ < width ||
      (whole ? C >= 2 * width : (col_lg != 0 || C < 4 || pitch_ % 4 != 0 ||
                                 C >= width)))
    return (int)cudaErrorInvalidValue;
  const int tpi = whole ? 1 : (pitch_ + C - 1) / C;
  // the row pass: rows route tiles of the batch * h/2 packed rows
  int p;
  const long long wf_r = work_floats(lw, 0, 0, row_lg, false, &p);
  const long long rows = batch << (lh - 1);
  const int nb_r = (1 << rp) <= AXIS_TILE ? 2 : 1;
  const Geo gr{x, nullptr, sr, si, (const float2*)tabw, nullptr, rows,
               (rows + (1LL << row_lg) - 1) >> row_lg, lw, 0, 0, row_lg,
               nb_r, (int)wf_r, p, -1.f, 1.f};
  const size_t smem_r = (size_t)nb_r * 2 * sizeof(float) * wf_r;
  cudaError_t e = rows_for(lw, std::make_integer_sequence<int, 12>{})(
      gr, (unsigned)(gr.tiles < row_blocks ? gr.tiles : row_blocks),
      1 << (rp - 4), smem_r, pitch_, s);
  if (e != cudaSuccess) return (int)e;
  // the column pass over the scratch
  const long long wf_c = ((1LL << cp) + 31) / 32 * 32;
  const int nb_c = (1 << cp) <= AXIS_TILE ? 2 : 1;
  const Geo gc{sr, si, outr, outi, (const float2*)tabh, nullptr, batch,
               ((batch + (1LL << col_lg) - 1) >> col_lg) * tpi, lh, 0,
               col_lc, col_lg, nb_c, (int)wf_c, 0, -1.f, 1.f};
  const size_t smem_c = (size_t)nb_c * 2 * sizeof(float) * wf_c;
  return (int)cols_for(lh, std::make_integer_sequence<int, 12>{})(
      gc, (unsigned)(gc.tiles < col_blocks ? gc.tiles : col_blocks),
      1 << (cp - 4), smem_c, pitch_, width, tpi, s);
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

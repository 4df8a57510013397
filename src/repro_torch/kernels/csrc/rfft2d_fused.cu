// Real-input 2-D FFT over (batch, h, w) fp32, bf16 or float16 images, h and
// w powers of two >= 2, and its inverse: real (batch, h, w) <-> split half
// spectra (batch, h, c), c = w/2 + 1 (bf16 and float16 widened at the load
// and rounded at the store; the scratch between the launches is fp32).
//
// Replaces the Pallas kernels repro/kernels/rfft2d_fused.py::_rfft2d_kernel
// and ::_irfft2d_kernel.  The TPU kernel holds a whole image in VMEM; a
// 1024^2 real plane is 4 MB against 227 KB of shared memory per block.  The
// function is bound by bytes (4 a real point, 8 a half-spectrum bin; ~2.5
// log2(N) flops a point), so each direction is two launches, each one pass
// over HBM, on the shared-memory FFT passes of axis_fft.cuh (persistent
// grids, tiles copied in with cp.async while the last one is transformed).
// The forward:
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
// The inverse mirrors it, two launches on the same passes:
//   column pass  the inverse length-h FFT along axis -2 of the (batch, h, c)
//                half spectra, on the forward's column tiles, read at the
//                input's own pitch c (odd: 4-byte chunks) and stored into a
//                scratch pair of pitch P (the forward's, or c rounded up to
//                4 where whole images fill a tile).  Columns come first: a
//                row of the half spectrum is no real row's spectrum yet;
//   row pass     a tile copies scratch rows 2j (A) and 2j+1 (B) in as one
//                run and builds Z = A_ext + i B_ext at the first pass's
//                load (the Hermitian extension, the imaginary parts of the
//                DC and Nyquist bins dropped: a complex Nyquist bin would
//                leak row 2j+1's residue into row 2j), runs the rows
//                route's inverse radix-16 passes and stores re to row 2j
//                and im to row 2j+1 of the real output, scaled by
//                1/(h*w), 128 contiguous bytes a warp.
#include "axis_fft.cuh"

namespace {

// -- the forward: two launches on axis_fft.cuh's passes --------------------

// Copy packed row tile k: G rows of 2^ln points, row R's re plane at
// x + R * 2^(ln+1), its im plane 2^ln further, swizzled by row as the rows
// route's tiles are (Swizzled); rows past `outer` zero-filled.
template <class T>
struct PackedCopy {
  const Geo& g;
  float* smem;
  int lv, mask;
  __device__ __forceinline__ void operator()(long long k, int b) const {
    T* sr = reinterpret_cast<T*>(smem + b * 2 * g.wf);
    T* si = sr + (1 << (g.ln + g.lg));
    const T* x = static_cast<const T*>(g.xr);
    const int bytes = (int)sizeof(T) << lv;
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

template <int LN, class T>
struct PackedRun {
  const Geo& g;
  float* smem;
  int lv, mask, P;
  __device__ __forceinline__ void operator()(long long k, int b) const {
    float* wr = smem + b * 2 * g.wf;
    float* wi = wr + g.wf;
    const T* sr = reinterpret_cast<const T*>(wr);
    const T* si = sr + (1 << (LN + g.lg));
    const Rows rows{g.p};
    passes<LN, 0, 3, true>(
        FromStage<T, Swizzled>{sr, si, Swizzled{LN, lv, mask}}, wr, wi,
        rows, g.lg, blockDim.x, g.tab, g.sg, ToShared<Rows>{wr, wi, rows});
    store_untangled<LN>(g, k, wr, wi, P);
  }
};

// The row pass: packed rows of 2^LN points -> untangled half spectra.
template <int LN, class T>
__global__ void __launch_bounds__(512, 1)
rfft_rows(const __grid_constant__ Geo g, int P) {
  extern __shared__ float smem[];
  constexpr int most = sizeof(T) == 2 ? 3 : 2;   // 16-byte chunks
  constexpr int lv = LN < most ? LN : most;
  const int mask = LN - lv >= 3 ? 7 : 0;
  walk_tiles(g, PackedCopy<T>{g, smem, lv, mask},
             PackedRun<LN, T>{g, smem, lv, mask, P});
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

// `bytes` (2, 4, 8 or 16) copied from device to shared memory, of which the
// first `have` are read and the rest zero-filled: cp.async, or for 2 bytes
// (bf16 or float16 rows at an odd pitch) a plain load
__device__ __forceinline__ void copy_chunk(void* dst, const void* src,
                                           int bytes, int have) {
  if (bytes == 2)
    *static_cast<unsigned short*>(dst) =
        have ? *static_cast<const unsigned short*>(src) : 0;
  else
    copy_async(dst, src, bytes, have);
}

// Copy column tile k of (outer, 2^ln, sp) planes (the forward's scratch,
// the inverse's input) as it lies (Columns): C-column row segments, the
// chunks at or past column sp zero-filled; whole images a tile read as one
// run where sp == C; chunks past `outer` zero-filled
template <class T>
struct HalfCopy {
  const Geo& g;
  float* smem;
  int lv, sp, tpi;
  __device__ __forceinline__ void operator()(long long k, int b) const {
    T* sr = reinterpret_cast<T*>(smem + b * 2 * g.wf);
    T* si = sr + (1 << (g.ln + g.lc + g.lg));
    const T* xr = static_cast<const T*>(g.xr);
    const T* xi = static_cast<const T*>(g.xi);
    const HalfTile at(g, k, tpi);
    const long long img = (long long)sp << g.ln;
    const int bytes = (int)sizeof(T) << lv;
    const int chunks = 1 << (g.ln + g.lc + g.lg - lv);
    for (int q = threadIdx.x; q < chunks; q += blockDim.x) {
      const int e = q << lv;
      long long src;
      int have = bytes;
      if (tpi == 1 && sp == 1 << g.lc) {
        src = at.o0 * img + e;
        if (src >= g.outer * img) have = 0;
      } else {
        const int col = at.c0 + (e & ((1 << g.lc) - 1));
        const long long o = at.o0 + (e >> (g.ln + g.lc));
        src = o * img + (long long)((e >> g.lc) & ((1 << g.ln) - 1)) * sp +
              col;
        if (col >= sp || o >= g.outer) have = 0;
      }
      if (have == 0) src = 0;
      copy_chunk(sr + e, xr + src, bytes, have);
      copy_chunk(si + e, xi + src, bytes, have);
    }
  }
};

// the column pass's last pass: element m of transform t = (image o0 +
// (t >> lc), column c0 + (t mod 2^lc)) to (image * h + m) * dp + column,
// columns >= width and images >= outer skipped
template <class T>
struct ToHalf {
  T* outr;
  T* outi;
  long long o0, outer;
  int c0, lc, lh, width, dp;
  template <int R>
  __device__ __forceinline__ void put(int t, int k0, int ns, float2* v) const {
    const long long o = o0 + (t >> lc);
    const int col = c0 + (t & ((1 << lc) - 1));
    if (o >= outer || col >= width) return;
    const long long base = (o << lh) * dp + col;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long a = base + (long long)(k0 + r * ns) * dp;
      outr[a] = narrow<T>(v[r].x);
      outi[a] = narrow<T>(v[r].y);
    }
  }
};

template <int LN, class TI, class TO>
struct HalfRun {
  const Geo& g;
  float* smem;
  int tpi, width, dp;
  __device__ __forceinline__ void operator()(long long k, int b) const {
    float* wr = smem + b * 2 * g.wf;
    float* wi = wr + g.wf;
    const TI* sr = reinterpret_cast<const TI*>(wr);
    const TI* si = sr + (1 << (LN + g.lc + g.lg));
    const HalfTile at(g, k, tpi);
    const Columns cols{g.lc, 1 << (LN + g.lc), 1 << g.lc};
    passes<LN, 0, -1, true>(
        FromStage<TI, Columns>{sr, si, cols}, wr, wi, cols, g.lc + g.lg,
        blockDim.x, g.tab, g.sg,
        ToHalf<TO>{static_cast<TO*>(g.outr), static_cast<TO*>(g.outi),
                   at.o0, g.outer, at.c0, g.lc, LN, width, dp});
  }
};

// The column pass: length 2^LN along axis -2 of the first `width` columns
// of (outer, 2^LN, sp) planes of TI into (outer, 2^LN, dp) ones of TO.
// Chunks of up to 16 bytes that sp divides (a row of the inverse's input
// starts at any element), or of a whole image's run.
template <int LN, int NT, class TI, class TO>
__global__ void __launch_bounds__(NT, 1)
half_cols(const __grid_constant__ Geo g, int sp, int dp, int width,
          int tpi) {
  extern __shared__ float smem[];
  const bool run = tpi == 1 && sp == 1 << g.lc;
  const int most = run ? g.ln + g.lc + g.lg : g.lc;
  const int cap = sizeof(TI) == 2 ? 3 : 2;
  int lv = most < cap ? most : cap;
  while (!run && (sp & ((1 << lv) - 1))) --lv;
  walk_tiles(g, HalfCopy<TI>{g, smem, lv, sp, tpi},
             HalfRun<LN, TI, TO>{g, smem, tpi, width, dp});
}

// -- the inverse's row pass -------------------------------------------------

// Copy row tile k: scratch rows 2R and 2R+1 of the G packed rows R = kG ..
// (pitch P), one run of 2GP floats a plane; rows past `outer` zero-filled
struct HalvesCopy {
  const Geo& g;
  float* smem;
  int P;
  __device__ __forceinline__ void operator()(long long k, int b) const {
    float* sr = smem + b * 2 * g.wf;
    float* si = sr + g.wf;
    const float* xr = static_cast<const float*>(g.xr);
    const float* xi = static_cast<const float*>(g.xi);
    const long long base = (k << g.lg) * 2 * P, end = g.outer * 2 * P;
    const int chunks = (P << g.lg) >> 1;       // 16 bytes each
    for (int q = threadIdx.x; q < chunks; q += blockDim.x) {
      const int e = q << 2;
      long long src = base + e;
      int have = 16;
      if (src >= end) {
        have = 0;
        src = 0;
      }
      copy_async(sr + e, xr + src, 16, have);
      copy_async(si + e, xi + src, 16, have);
    }
  }
};

// The first pass's read of packed row t's element i: Z = A_ext + i B_ext
// from the copied rows 2t (A) and 2t+1 (B) at pitch P, the Hermitian
// extension with the DC and Nyquist bins' imaginary parts dropped, the
// arithmetic of irfft2d_fused_plain's repack
template <int LN>
struct FromHalves {
  const float* sr;
  const float* si;
  int P;
  __device__ __forceinline__ float2 operator()(int t, int i) const {
    constexpr int W = 1 << LN, HW = W / 2;
    const bool mirror = i > HW;
    const int kk = mirror ? W - i : i;
    const int oa = 2 * t * P + kk, ob = oa + P;
    const bool ends = kk == 0 || kk == HW;
    const float ar = sr[oa], br = sr[ob];
    float ai = ends ? 0.f : si[oa];
    float bi = ends ? 0.f : si[ob];
    if (mirror) {
      ai = -ai;
      bi = -bi;
    }
    return make_float2(ar - bi, ai + br);
  }
};

// A rows tile's transforms Z (rows of pitch p in shared memory) to the
// real output: re to row 2R, im to row 2R+1, scaled; element e of the run
// of 2G rows is packed row e >> (LN+1), plane (e >> LN) & 1, point
// e mod 2^LN, so each warp stores 128 contiguous bytes
template <int LN, class T>
__device__ __forceinline__ void store_pairs(const Geo& g, long long k,
                                            const float* wr,
                                            const float* wi) {
  T* out = static_cast<T*>(g.outr);
  const long long base = (k << g.lg) << (LN + 1);
  const long long left = (g.outer << (LN + 1)) - base;
  const int points = 2 << (LN + g.lg);
  const int n = points < left ? points : (int)left;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int a = (e >> (LN + 1)) * g.p + (e & ((1 << LN) - 1));
    out[base + e] = narrow<T>(((e >> LN) & 1 ? wi[a] : wr[a]) * g.scale);
  }
  __syncthreads();
}

template <int LN, class T>
struct HalvesRun {
  const Geo& g;
  float* smem;
  int P;
  __device__ __forceinline__ void operator()(long long k, int b) const {
    float* wr = smem + b * 2 * g.wf;
    float* wi = wr + g.wf;
    const Rows rows{g.p};
    passes<LN, 0, 3, true>(FromHalves<LN>{wr, wi, P}, wr, wi, rows, g.lg,
                           blockDim.x, g.tab, g.sg,
                           ToShared<Rows>{wr, wi, rows});
    store_pairs<LN, T>(g, k, wr, wi);
  }
};

// The inverse's row pass: packed row pairs of the scratch -> real rows.
template <int LN, class T>
__global__ void __launch_bounds__(512, 1)
irfft_rows(const __grid_constant__ Geo g, int P) {
  extern __shared__ float smem[];
  walk_tiles(g, HalvesCopy{g, smem, P}, HalvesRun<LN, T>{g, smem, P});
}

template <int LN, bool INV, class T>
cudaError_t launch_rows(const Geo& g, unsigned blocks, int threads,
                        size_t smem, int P, cudaStream_t st) {
  static int done[16];
  if constexpr (INV) {
    const cudaError_t e = allow_smem(irfft_rows<LN, T>, smem, done);
    if (e != cudaSuccess) return e;
    irfft_rows<LN, T><<<blocks, threads, smem, st>>>(g, P);
  } else {
    const cudaError_t e = allow_smem(rfft_rows<LN, T>, smem, done);
    if (e != cudaSuccess) return e;
    rfft_rows<LN, T><<<blocks, threads, smem, st>>>(g, P);
  }
  return cudaGetLastError();
}

template <int LN, int NT, class TI, class TO>
cudaError_t launch_cols(const Geo& g, unsigned blocks, int threads,
                        size_t smem, int sp, int dp, int width, int tpi,
                        cudaStream_t st) {
  static int done[16];
  const cudaError_t e = allow_smem(half_cols<LN, NT, TI, TO>, smem, done);
  if (e != cudaSuccess) return e;
  half_cols<LN, NT, TI, TO><<<blocks, threads, smem, st>>>(g, sp, dp, width,
                                                           tpi);
  return cudaGetLastError();
}

using RowsLaunch = cudaError_t (*)(const Geo&, unsigned, int, size_t, int,
                                   cudaStream_t);
using ColsLaunch = cudaError_t (*)(const Geo&, unsigned, int, size_t, int,
                                   int, int, int, cudaStream_t);

template <bool INV, class T, int... L>
RowsLaunch rows_for(int ln, std::integer_sequence<int, L...>) {
  static const RowsLaunch fns[] = {launch_rows<L + 1, INV, T>...};
  return fns[ln - 1];
}

// columns of up to 1024 points in 8192-point tiles (512 threads), of 2048
// and 4096 in up to 16384 (1024)
template <class TI, class TO, int... L>
ColsLaunch cols_for(int ln, std::integer_sequence<int, L...>) {
  static const ColsLaunch fns[] = {
      launch_cols<L + 1, (L + 1 > 10 ? 1024 : 512), TI, TO>...};
  return fns[ln - 1];
}

// the column pass's instance: fp32 scratch on the other side of bf16 or
// float16 planes (store codes as in axis_fft_launch)
inline ColsLaunch pick_cols(int ln, int in_store, int out_store) {
  const auto lns = std::make_integer_sequence<int, 12>{};
  if (in_store)
    return by_store(in_store, [&](auto t) {
      return cols_for<typename decltype(t)::type, float>(ln, lns);
    });
  return by_store(out_store, [&](auto t) {
    return cols_for<float, typename decltype(t)::type>(ln, lns);
  });
}

// The two launches' geometry, checked: the column pass's tiles of C =
// 2^col_lc columns of the (batch, h, width) half spectra (whole images a
// tile where C >= width, else one image's C-column segments, the last one
// ragged) and the row pass's tiles of G = 2^row_lg packed rows, `pitch`
// the scratch's row pitch.  False for a tiling the kernels do not take.
struct Plan2 {
  long long batch;
  int lh, lw, pitch, row_lg, row_blocks, col_lc, col_lg, col_blocks;
  int width() const { return (1 << lw) / 2 + 1; }
  bool whole() const { return (1 << col_lc) >= width(); }
  bool ok_rows() const {
    const int rp = lw + row_lg;
    return batch > 0 && lh >= 1 && lh <= 30 && lw >= 1 && lw <= 12 &&
           row_lg >= 0 && row_blocks > 0 && rp <= 13 &&
           (1 << rp) >= AXIS_TILE_MIN && pitch >= width();
  }
  bool ok_cols(bool forward) const {
    const int C = 1 << col_lc, cp = lh + col_lc + col_lg;
    return batch > 0 && lh >= 1 && lh <= 12 && lw >= 1 && lw <= 30 &&
           col_lc >= 0 && col_lg >= 0 && col_blocks > 0 && cp <= 14 &&
           (1 << cp) >= AXIS_TILE_MIN && (cp < 14 || lh >= 11) &&
           pitch >= width() &&
           (whole() ? C < 2 * width() && (forward ? pitch == C
                                                  : pitch % 4 == 0)
                    : col_lg == 0 && C >= 4 && pitch % 4 == 0);
  }
  bool ok(bool forward) const { return ok_rows() && ok_cols(forward); }
  int tpi() const {
    return whole() ? 1 : (width() + (1 << col_lc) - 1) >> col_lc;
  }
  // the column pass over (batch, h, *) planes x -> out, sign sg
  cudaError_t cols(const void* xr, const void* xi, void* outr, void* outi,
                   const float* tab, int sp, int dp, float sg, int in_store,
                   int out_store, cudaStream_t s) const {
    const int cp = lh + col_lc + col_lg;
    const long long wf = ((1LL << cp) + 31) / 32 * 32;
    const int nb = (1 << cp) <= AXIS_TILE ? 2 : 1;
    const Geo g{xr, xi, outr, outi, (const float2*)tab, nullptr, batch,
                ((batch + (1LL << col_lg) - 1) >> col_lg) * tpi(), lh, 0,
                col_lc, col_lg, nb, (int)wf, 0, sg, 1.f};
    const size_t smem = (size_t)nb * 2 * sizeof(float) * wf;
    return pick_cols(lh, in_store, out_store)(
        g, (unsigned)(g.tiles < col_blocks ? g.tiles : col_blocks),
        1 << (cp - 4), smem, sp, dp, width(), tpi(), s);
  }
  // the row pass over the batch * h/2 packed rows; `staged` the floats a
  // plane the inverse's copy stages (0 for the forward)
  template <bool INV>
  cudaError_t rows(const void* xr, const void* xi, void* outr, void* outi,
                   const float* tab, float sg, float scale, int store,
                   cudaStream_t s) const {
    int p;
    long long wf = work_floats(lw, 0, 0, row_lg, false, &p);
    const long long staged = INV ? (2LL * pitch) << row_lg : 0;
    if (staged > wf) wf = (staged + 31) / 32 * 32;
    const int rp = lw + row_lg;
    const long long n = batch << (lh - 1);
    const int nb = (1 << rp) <= AXIS_TILE ? 2 : 1;
    const size_t smem = (size_t)nb * 2 * sizeof(float) * wf;
    if (smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
    const Geo g{xr, xi, outr, outi, (const float2*)tab, nullptr, n,
                (n + (1LL << row_lg) - 1) >> row_lg, lw, 0, 0, row_lg, nb,
                (int)wf, p, sg, scale};
    const auto lns = std::make_integer_sequence<int, 12>{};
    const RowsLaunch fn = by_store(store, [&](auto t) {
      return rows_for<INV, typename decltype(t)::type>(lw, lns);
    });
    return fn(g, (unsigned)(g.tiles < row_blocks ? g.tiles : row_blocks),
              1 << (rp - 4), smem, pitch, s);
  }
};

// -- the pieces of the long-axis routes (kernels/rfft2d_fused.py::steps) ----

constexpr int EW_NT = 256;

__host__ __device__ inline unsigned ew_blocks(long long total) {
  const long long b = (total + EW_NT - 1) / EW_NT;
  return (unsigned)(b < (1LL << 20) ? b : (1LL << 20));
}

// the packed spectra Z (rows of w, TI) of row pairs -> untangled half
// spectra A, B as rows 2j, 2j+1 of the fp32 (pitch P) scratch: bins k =
// 0..w/2, the arithmetic of store_untangled
template <class TI>
__global__ void __launch_bounds__(EW_NT)
untangle(const TI* __restrict__ zr, const TI* __restrict__ zi,
         float* __restrict__ yr, float* __restrict__ yi, long long pairs,
         int lw, int P) {
  const long long w = 1LL << lw, cw = w / 2 + 1, total = pairs * cw;
  for (long long t = blockIdx.x * (long long)EW_NT + threadIdx.x; t < total;
       t += (long long)gridDim.x * EW_NT) {
    const long long row = t / cw, kk = t - row * cw;
    const long long a = row * w + kk, ac = row * w + ((w - kk) & (w - 1));
    const float rk = widen(zr[a]), ik = widen(zi[a]);
    const float cr = widen(zr[ac]), ci = widen(zi[ac]);
    const long long oa = 2 * row * P + kk, ob = oa + P;
    yr[oa] = (rk + cr) * 0.5f;
    yi[oa] = (ik - ci) * 0.5f;
    yr[ob] = (ik + ci) * 0.5f;
    yi[ob] = (cr - rk) * 0.5f;
  }
}

// the fp32 (pitch P) half spectra rows 2j, 2j+1 -> packed rows Z = A_ext +
// i B_ext of w points (TO), the arithmetic of FromHalves
template <class TO>
__global__ void __launch_bounds__(EW_NT)
repack(const float* __restrict__ sr, const float* __restrict__ si,
       TO* __restrict__ zr, TO* __restrict__ zi, long long pairs, int lw,
       int P) {
  const long long w = 1LL << lw, hw = w / 2, total = pairs << lw;
  for (long long t = blockIdx.x * (long long)EW_NT + threadIdx.x; t < total;
       t += (long long)gridDim.x * EW_NT) {
    const long long row = t >> lw, i = t & (w - 1);
    const bool mirror = i > hw;
    const long long kk = mirror ? w - i : i;
    const long long oa = 2 * row * P + kk, ob = oa + P;
    const bool ends = kk == 0 || kk == hw;
    const float ar = sr[oa], br = sr[ob];
    float ai = ends ? 0.f : si[oa];
    float bi = ends ? 0.f : si[ob];
    if (mirror) {
      ai = -ai;
      bi = -bi;
    }
    zr[t] = narrow<TO>(ar - bi);
    zi[t] = narrow<TO>(ai + br);
  }
}

// rows of `width` elements at pitch sp (TI) -> pitch dp (TO), the columns
// width .. dp - 1 zero-filled
template <class TI, class TO>
__global__ void __launch_bounds__(EW_NT)
repitch(const TI* __restrict__ xr, const TI* __restrict__ xi,
        TO* __restrict__ yr, TO* __restrict__ yi, long long rows, int width,
        int sp, int dp) {
  const long long total = rows * dp;
  for (long long t = blockIdx.x * (long long)EW_NT + threadIdx.x; t < total;
       t += (long long)gridDim.x * EW_NT) {
    const long long row = t / dp, c = t - row * dp;
    const long long a = row * sp + c;
    yr[t] = narrow<TO>(c < width ? widen(xr[a]) : 0.f);
    yi[t] = narrow<TO>(c < width ? widen(xi[a]) : 0.f);
  }
}

}  // namespace

// x (batch, 2^lh, 2^lw) real -> (outr, outi) (batch, 2^lh, w/2+1) in two
// launches with the tiling kernels/rfft2d_fused.py planned: the row pass
// (G = 2^row_lg packed rows a tile) into the fp32 scratch pair (sr, si),
// row pitch `pitch`, then the column pass (2^col_lc columns and 2^col_lg
// images a tile); tabw and tabh the fp32 W_n^k, k < n, of the forward
// sign for n = w and h; the blocks of each persistent grid; raw bf16 x and
// out for store = 1, raw float16 for store = 2.  Returns
// cudaErrorInvalidValue for a tiling it does not take.
extern "C" int rfft2d_fused_pass(const void* x, void* outr, void* outi,
                                 float* sr, float* si, const float* tabw,
                                 const float* tabh, long long batch, int lh,
                                 int lw, int pitch_, int row_lg,
                                 int row_blocks, int col_lc, int col_lg,
                                 int col_blocks, int store, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Plan2 pl{batch, lh, lw, pitch_, row_lg, row_blocks, col_lc, col_lg,
                 col_blocks};
  if (!pl.ok(true)) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      pl.rows<false>(x, nullptr, sr, si, tabw, -1.f, 1.f, store, s);
  if (e != cudaSuccess) return (int)e;
  return (int)pl.cols(sr, si, outr, outi, tabh, pitch_, pl.width(), -1.f, 0,
                      store, s);
}

// (xr, xi) (batch, 2^lh, w/2+1) half spectra -> out (batch, 2^lh, 2^lw)
// real, scaled by 1/(h*w), in two launches with the tiling
// kernels/rfft2d_fused.py planned: the column pass (read at the input's
// pitch w/2+1) into the fp32 scratch pair (sr, si) of row pitch `pitch`,
// then the row pass; tabw and tabh of the inverse sign; raw bf16 input
// and output for store = 1, raw float16 for store = 2.  Returns
// cudaErrorInvalidValue for a tiling it does not take.
extern "C" int irfft2d_fused_pass(const void* xr, const void* xi, void* out,
                                  float* sr, float* si, const float* tabw,
                                  const float* tabh, long long batch, int lh,
                                  int lw, int pitch_, int row_lg,
                                  int row_blocks, int col_lc, int col_lg,
                                  int col_blocks, int store, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Plan2 pl{batch, lh, lw, pitch_, row_lg, row_blocks, col_lc, col_lg,
                 col_blocks};
  if (!pl.ok(false)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = pl.cols(xr, xi, sr, si, tabh, pl.width(), pitch_,
                                1.f, store, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)pl.rows<true>(sr, si, out, nullptr, tabw, 1.f,
                            (float)(1.0 / ((double)(1 << lh) * (1 << lw))),
                            store, s);
}

// -- the long-axis routes' launches, one an entry (kernels/rfft2d_fused.py
// ::steps): an axis of h or w past 4096 runs on axis_fft.cuh's split
// launches, with the pieces below between them.

// The forward's row pass alone (w <= 4096): x -> the fp32 scratch (sr, si)
// of pitch `pitch`, untangled.
extern "C" int rfft2d_rows_pass(const void* x, float* sr, float* si,
                                const float* tabw, long long batch, int lh,
                                int lw, int pitch_, int row_lg,
                                int row_blocks, int store, void* stream) {
  const Plan2 pl{batch, lh, lw, pitch_, row_lg, row_blocks, 0, 0, 1};
  if (!pl.ok_rows()) return (int)cudaErrorInvalidValue;
  return (int)pl.rows<false>(x, nullptr, sr, si, tabw, -1.f, 1.f, store,
                             (cudaStream_t)stream);
}

// The inverse's row pass alone (w <= 4096): the fp32 scratch (sr, si) of
// pitch `pitch` -> out real, scaled.
extern "C" int irfft2d_rows_pass(const float* sr, const float* si, void* out,
                                 const float* tabw, long long batch, int lh,
                                 int lw, int pitch_, int row_lg,
                                 int row_blocks, float scale, int store,
                                 void* stream) {
  const Plan2 pl{batch, lh, lw, pitch_, row_lg, row_blocks, 0, 0, 1};
  if (!pl.ok_rows() || pitch_ % 4) return (int)cudaErrorInvalidValue;
  return (int)pl.rows<true>(sr, si, out, nullptr, tabw, 1.f, scale, store,
                            (cudaStream_t)stream);
}

// Either direction's column pass alone (h <= 4096): (xr, xi) of pitch sp
// -> (outr, outi) of pitch dp, the fp32 scratch on the side that is not
// bf16 or float16 (the store codes in_store / out_store), sign of
// `inverse`.
extern "C" int rfft2d_cols_pass(const void* xr, const void* xi, void* outr,
                                void* outi, const float* tabh,
                                long long batch, int lh, int lw, int pitch_,
                                int col_lc, int col_lg, int col_blocks,
                                int inverse, int in_store, int out_store,
                                void* stream) {
  const Plan2 pl{batch, lh, lw, pitch_, 0, 1, col_lc, col_lg, col_blocks};
  if (!pl.ok_cols(!inverse) || (in_store && out_store))
    return (int)cudaErrorInvalidValue;
  const int sp = inverse ? pl.width() : pitch_;
  const int dp = inverse ? pitch_ : pl.width();
  return (int)pl.cols(xr, xi, outr, outi, tabh, sp, dp,
                      inverse ? 1.f : -1.f, in_store, out_store,
                      (cudaStream_t)stream);
}

// One launch of axis_fft.cuh's axis FFT (see axis_fft_launch): the split
// launches of a long axis (the packed rows read at img_in = 2w, or the
// inverse's stored at img_out = 2w).
extern "C" int rfft2d_axis_pass(const void* xr, const void* xi, void* outr,
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

// The packed spectra (batch*h/2 rows of 2^lw; raw bf16 for store = 1, raw
// float16 for store = 2) -> the untangled fp32 scratch of pitch P.
extern "C" int rfft2d_untangle(const void* zr, const void* zi, float* yr,
                               float* yi, long long pairs, int lw, int P,
                               int store, void* stream) {
  if (pairs <= 0 || lw < 1 || lw > 30 || P < (1 << lw) / 2 + 1)
    return (int)cudaErrorInvalidValue;
  const long long total = pairs * ((1LL << lw) / 2 + 1);
  cudaStream_t s = (cudaStream_t)stream;
  by_store(store, [&](auto t) {
    using T = typename decltype(t)::type;
    untangle<T><<<ew_blocks(total), EW_NT, 0, s>>>(
        (const T*)zr, (const T*)zi, yr, yi, pairs, lw, P);
    return 0;
  });
  return (int)cudaGetLastError();
}

// The fp32 half spectra of pitch P -> packed rows of 2^lw (raw bf16 for
// store = 1, raw float16 for store = 2).
extern "C" int rfft2d_repack(const float* sr, const float* si, void* zr,
                             void* zi, long long pairs, int lw, int P,
                             int store, void* stream) {
  if (pairs <= 0 || lw < 1 || lw > 30 || P < (1 << lw) / 2 + 1)
    return (int)cudaErrorInvalidValue;
  const long long total = pairs << lw;
  cudaStream_t s = (cudaStream_t)stream;
  by_store(store, [&](auto t) {
    using T = typename decltype(t)::type;
    repack<T><<<ew_blocks(total), EW_NT, 0, s>>>(sr, si, (T*)zr, (T*)zi,
                                                  pairs, lw, P);
    return 0;
  });
  return (int)cudaGetLastError();
}

// Rows of `width` at pitch sp -> pitch dp (zero-filled past width); the
// side with a non-zero store code (in_store, out_store) raw bf16 or
// float16, the other fp32.
extern "C" int rfft2d_repitch(const void* xr, const void* xi, void* yr,
                              void* yi, long long rows, int width, int sp,
                              int dp, int in_store, int out_store,
                              void* stream) {
  if (rows <= 0 || width < 1 || sp < width || dp < width ||
      (in_store && out_store))
    return (int)cudaErrorInvalidValue;
  const long long total = rows * dp;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_store)
    by_store(in_store, [&](auto t) {
      using T = typename decltype(t)::type;
      repitch<T, float><<<ew_blocks(total), EW_NT, 0, s>>>(
          (const T*)xr, (const T*)xi, (float*)yr, (float*)yi, rows, width,
          sp, dp);
      return 0;
    });
  else
    by_store(out_store, [&](auto t) {
      using T = typename decltype(t)::type;
      repitch<float, T><<<ew_blocks(total), EW_NT, 0, s>>>(
          (const float*)xr, (const float*)xi, (T*)yr, (T*)yi, rows, width,
          sp, dp);
      return 0;
    });
  return (int)cudaGetLastError();
}

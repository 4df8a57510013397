// The fused Stockham machinery of fft_stockham.cu and fft2d_fused.cu: up to
// four bits of radix-2 or mixed radix-4/2 Stockham stages a pass in
// registers (16 points a thread, the stage loops template recursions so
// that the points stay in registers), passes between shared-memory
// barriers in bank-spreading layouts, twiddles off one table a radix (the
// radix-4 one (3, n/4): w, w^2, w^3, read at (j >> 2s) << 2s for stage s,
// bit for bit row s of the packed (s4, 3, n/4) table), and the fused
// launches of both kernels (StRun, st_pick, stockham_pass: rows, launches
// A and B of the two-launch split, and the middle launch of the
// three-launch split past 2^24, each on rows or on the columns of
// images), each on fp32, raw bf16 or raw float16 planes (`store` 0, 1, 2).
// The tile walk, the copies, FromShared / ToShared / FromStage and the
// stores (ToGlobal, ToSplit) are axis_fft.cuh's.
#pragma once
#include "axis_fft.cuh"

namespace {

// i with its bits 4..8 folded into bits 0..4: a permutation of every aligned
// 32 under which the strides of a pass's writes (16 apart at its first
// stage) land on distinct banks
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 4) & 31); }

// The work layout of a rows tile: transform t's element i at t*p + swz(i),
// p padded so that 8 rows x 4 points hit 32 banks (pitch())
struct RowsSw {
  int p;
  __device__ __forceinline__ int at(int t, int i) const {
    return t * p + swz(i);
  }
};

// ... of a columns tile: element i of column t at swz(i*C + t)
struct ColsSw {
  int lc;
  __device__ __forceinline__ int at(int t, int i) const {
    return swz((i << lc) + t);
  }
};

// Twiddle W_n^m, m = (q + (p << qb)) << s: p the butterfly's p at stage
// bit s of its length, q the column of a launch A tile (((q0 + t) & qm) >>
// lin; qb = log2 Q, the column's stages fold the four-step twiddle in; qm
// keeps the column bits of a tile of whole images; lin = log2 of the inner
// extent when launch A runs over columns of images), s shifted by s0 (the
// bits of stages that earlier launches ran: its bit s is bit s + s0 of the
// whole).  Radix 4 reads w^r at m of row r - 1 (rows of `row` = n/4
// entries); `sg` is the transform's sign (-1 forward).  I is the index
// type: the 1-D kernel's launches take long long (tables past 2^31
// entries), the conv's fixed lengths int.
template <class I>
struct TwiddleOf {
  const float2* w;
  int q0, qb, s0;
  I row;
  float sg;
  int lin, qm = -1;
  __device__ __forceinline__ I at(int t, int p, int s) const {
    return ((I)(((q0 + (qb ? t : 0)) & qm) >> lin) + ((I)p << qb)) << (s + s0);
  }
  __device__ __forceinline__ float2 operator()(int t, int p, int s) const {
    return w[at(t, p, s)];
  }
};
using Twiddle = TwiddleOf<int>;

// Stages S+K .. S+LR-1 of a length-2^LN radix-2 Stockham on the 2^LR
// points u[r] = element base + r * 2^(LN-LR) of transform t, in registers,
// one template instance a stage (so that every index of u is a constant
// and u stays in registers).  Stage S+K pairs register bit LR-1-K (the
// current top bit of the index), so the pair's p (its index >> (S+K)) is
// bits S .. LN-2-K of the first point's index: one twiddle for the 2^K
// pairs that share them.
template <int LR, int LN, int S, int K = 0, class Tw>
__device__ __forceinline__ void r2_in_regs(float2* u, int base, int t,
                                            const Tw& tw) {
  if constexpr (K < LR) {
    constexpr int HB = LR - 1 - K;
    const int mask = (1 << (LN - 1 - S - K)) - 1;
#pragma unroll
    for (int lo = 0; lo < (1 << HB); ++lo) {
      const int p = ((base + (lo << (LN - LR))) >> S) & mask;
      const float2 w = tw(t, p, S + K);
#pragma unroll
      for (int hi = 0; hi < (1 << K); ++hi) {
        const int a = lo | (hi << (HB + 1)), b = a | (1 << HB);
        const float2 x = u[a], y = u[b];
        u[a] = cadd(x, y);
        u[b] = cmul(csub(x, y), w);
      }
    }
    r2_in_regs<LR, LN, S, K + 1>(u, base, t, tw);
  }
}

// The same for the mixed radix-4/2 Stockham: a radix-4 stage a step of two
// bits, which takes register bits HB and HB-1 (HB = LR-1-K) as its digit
// r (the quarter x[j + r*n/4]) and computes stockham_stages' butterfly
// (y_r * w^r, the +-i of the transform's sign); the radix-2 tail (stage
// LN-1, twiddle 1) when one bit is left.
template <int LR, int LN, int S, int K = 0, class Tw>
__device__ __forceinline__ void r4_in_regs(float2* u, int base, int t,
                                            const Tw& tw) {
  if constexpr (K + 1 == LR) {
    static_assert(S + K == LN - 1, "the radix-2 tail is the last stage");
#pragma unroll
    for (int hi = 0; hi < (1 << K); ++hi) {
      const float2 x = u[2 * hi], y = u[2 * hi + 1];
      u[2 * hi] = cadd(x, y);
      u[2 * hi + 1] = csub(x, y);
    }
  } else if constexpr (K < LR) {
    constexpr int HB = LR - 1 - K;
    const int mask = (1 << (LN - 2 - S - K)) - 1;
    const float sg = tw.sg;
#pragma unroll
    for (int lo = 0; lo < (1 << (HB - 1)); ++lo) {
      const int p = ((base + (lo << (LN - LR))) >> S) & mask;
      const float2* wm = tw.w + tw.at(t, p, S + K);
      const float2 w1 = wm[0], w2 = wm[tw.row], w3 = wm[2 * tw.row];
#pragma unroll
      for (int hi = 0; hi < (1 << K); ++hi) {
        const int i0 = lo | (hi << (HB + 1)), st = 1 << (HB - 1);
        const float2 a0 = u[i0], a1 = u[i0 + st], a2 = u[i0 + 2 * st],
                     a3 = u[i0 + 3 * st];
        const float2 e0 = cadd(a0, a2), d0 = csub(a0, a2);
        const float2 e1 = cadd(a1, a3), d1 = csub(a1, a3);
        u[i0] = cadd(e0, e1);
        u[i0 + st] = cmul(make_float2(d0.x - sg * d1.y, d0.y + sg * d1.x), w1);
        u[i0 + 2 * st] = cmul(csub(e0, e1), w2);
        u[i0 + 3 * st] =
            cmul(make_float2(d0.x + sg * d1.y, d0.y - sg * d1.x), w3);
      }
    }
    r4_in_regs<LR, LN, S, K + 2>(u, base, t, tw);
  }
}

// The register holding output r (element k0 + r * 2^S) after a pass of LR
// bits: a radix-2 stage moves the top register bit to the next bit of r
// (bit reversal); a radix-4 stage the top digit, its two bits in order,
// and the tail the last bit to the top of r.  Plain shifts, so an unrolled
// r folds to a constant.
template <int RX>
__device__ __forceinline__ constexpr int pass_reg(int r, int lr) {
  if (RX == 2) return rev4(r, lr);
  int x = 0;
#pragma unroll
  for (int k = 0; k + 1 < lr; k += 2)
    x |= (((r >> (k + 1)) & 1) << (lr - 1 - k)) | (((r >> k) & 1) << (lr - 2 - k));
  return (lr & 1) ? x | ((r >> (lr - 1)) & 1) : x;
}

// One pass: stages of bits S .. S+LR-1 of the 2^lT transforms of length
// 2^LN read through `in`, radix RX.  Each of the nt threads takes E / 2^LR
// groups q = tid + b*nt; q's low bits pick up to 2^LF transforms, the next
// ones the group's base (its first point, < 2^(LN-LR)), the rest the other
// transforms.  After the stages register pass_reg(r) is element
// (base mod 2^S) + r * 2^S + (base >> S) * 2^(S+LR), which `out` is handed
// in order.
template <int RX, int LR, int LN, int S, int LF, class In, class Tw,
          class Out>
__device__ __forceinline__ void st_pass(const In& in, int lT, int nt,
                                        const Tw& tw, const Out& out) {
  constexpr int R = 1 << LR, B = E / R, LB = LN - LR;
  const int lf = lT < LF ? lT : LF;
  const int tid = threadIdx.x;
  float2 v[E];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = tid + b * nt;
    const int rest = q >> lf;
    const int base = rest & ((1 << LB) - 1);
    const int t = ((rest >> LB) << lf) | (q & ((1 << lf) - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) v[b * R + r] = in(t, base + (r << LB));
    if constexpr (RX == 2)
      r2_in_regs<LR, LN, S>(v + b * R, base, t, tw);
    else
      r4_in_regs<LR, LN, S>(v + b * R, base, t, tw);
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = tid + b * nt;
    const int rest = q >> lf;
    const int base = rest & ((1 << LB) - 1);
    const int t = ((rest >> LB) << lf) | (q & ((1 << lf) - 1));
    float2 o[R];
#pragma unroll
    for (int r = 0; r < R; ++r) o[r] = v[b * R + pass_reg<RX>(r, LR)];
    out.template put<R>(t, (base & ((1 << S) - 1)) | ((base >> S) << (S + LR)),
                        1 << S, o);
  }
  __syncthreads();
}

// Every stage from bit S on: passes of four bits, the last of LN - S mod 4;
// the first reads through `in`, the others from shared memory laid out by
// `lay`; the last hands its outputs to `last`, the others write to `lay`.
template <int RX, int LN, int S, int LF, class In, class Lay, class Tw,
          class Last>
__device__ __forceinline__ void st_passes(const In& in, float* sr, float* si,
                                          const Lay& lay, int lT, int nt,
                                          const Tw& tw, const Last& last) {
  constexpr int LR = LN - S < 4 ? LN - S : 4;
  if constexpr (S + LR == LN) {
    st_pass<RX, LR, LN, S, LF>(in, lT, nt, tw, last);
  } else {
    st_pass<RX, LR, LN, S, LF>(in, lT, nt, tw, ToShared<Lay>{sr, si, lay});
    st_passes<RX, LN, S + LR, LF>(FromShared<Lay>{sr, si, lay}, sr, si, lay,
                                  lT, nt, tw, last);
  }
}

// a rows tile, back in the work layout, to rows of out: 32 lanes store 128
// contiguous bytes
template <int LN, class T, class Lay>
__device__ __forceinline__ void st_store_rows(const Geo& g, long long k,
                                              const float* wr,
                                              const float* wi,
                                              const Lay& lay) {
  T* outr = static_cast<T*>(g.outr);
  T* outi = static_cast<T*>(g.outi);
  const long long base = (k << g.lg) << LN;
  const long long left = (g.outer << LN) - base;
  const int points = 1 << (LN + g.lg);
  const int n = points < left ? points : (int)left;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int a = lay.at(e >> LN, e & ((1 << LN) - 1));
    outr[base + e] = narrow<T>(wr[a] * g.scale);
    outi[base + e] = narrow<T>(wi[a] * g.scale);
  }
  __syncthreads();
}

// the work layout of a columns tile of G images: element i of transform t
// = (image t >> lc, column t mod 2^lc) at swz((image * 2^ln + i) * 2^lc +
// column)
struct ImageColsSw {
  int lc, ln;
  __device__ __forceinline__ int at(int t, int i) const {
    return swz(((((t >> lc) << ln) + i) << lc) + (t & ((1 << lc) - 1)));
  }
};

// -- the fused launches of the 1-D kernel's routes -------------------------
//   ST_ROWS        tiles of G whole rows, every stage, stored as rows;
//   ST_COLS        launch A: stages of bits 0..ln-1 of a length-2^(ln+lq)
//                  transform on tiles of C columns of the (outer, 2^ln,
//                  2^lq * 2^lin) view (q = column >> lin), in place;
//   ST_TRANSPOSED  launch B on rows (lin = 0): stages of bits l1.. of the
//                  rows of the (outer * 2^l1, 2^ln) view, row k's point t
//                  stored at t * 2^l1 + k (axis_fft.cuh's REVERSED store);
//   ST_TCOLS       launch B on columns: the same over tiles of C columns
//                  (or G whole images) of the (outer * 2^l1, 2^ln, 2^lin)
//                  view, point t of (o, k, i) stored at (o, t * 2^l1 + k, i);
//   ST_MID         the middle launch of three (an axis past 2^24):
//                  stages of bits l1..l1+ln-1 of a length-2^(l1+ln+linner-
//                  lin) transform, each image (o, k) of the (outer * 2^l1,
//                  2^ln, 2^linner) view a launch A of its own (q = column
//                  >> lin, its four-step twiddle folded in; lin = log2 of
//                  the inner extent when the axis runs over columns of
//                  images, 0 on rows), over tiles of C columns (or G whole
//                  images), point t of (o, k, c) stored at
//                  (o, t * 2^l1 + k, c) as ST_TCOLS stores.
enum { ST_ROWS = 0, ST_COLS = 1, ST_TRANSPOSED = 2, ST_TCOLS = 3,
       ST_MID = 4 };
constexpr int ST_LN_MAX = 36;   // log2 of the longest transform of a launch

// One tile's stages; `row` the radix-4 table's row length
template <int RX, int LN, int ROUTE, class T>
struct StRun {
  const Geo& g;
  float* smem;
  int lv, mask, l1;
  long long row;
  int lin;
  __device__ __forceinline__ void operator()(long long k, int b) const {
    using Tw = TwiddleOf<long long>;
    float* wr = smem + b * 2 * g.wf;
    float* wi = wr + g.wf;
    const T* sr = reinterpret_cast<const T*>(wr);
    const T* si = sr + (1 << (LN + g.lc + g.lg));
    const int nt = blockDim.x;
    if constexpr (ROUTE == ST_COLS) {
      const int cpi = g.linner - g.lc;
      const int q0 = (int)((k & ((1LL << cpi) - 1)) << g.lc);
      const Columns stage{g.lc, 1 << (LN + g.lc), 1 << g.lc};
      st_passes<RX, LN, 0, 5>(FromStage<T, Columns>{sr, si, stage}, wr, wi,
                              ColsSw{g.lc}, g.lc, nt,
                              Tw{g.tab, q0, g.linner - lin, 0, row, g.sg,
                                 lin},
                              to_global<T>(g, k));
    } else if constexpr (ROUTE == ST_TCOLS || ROUTE == ST_MID) {
      const Columns stage{g.lc, 1 << (LN + g.lc), 1 << g.lc};
      // ST_MID: q = (the tile's first column + t) >> lin, or t's column
      // bits >> lin in a tile of whole images (q0 = 0)
      const int cpi = g.linner - g.lc;
      const int q0 = (int)((k & ((1LL << cpi) - 1)) << g.lc);
      const Tw tw = ROUTE == ST_MID
                        ? Tw{g.tab, q0, g.linner - lin, l1, row, g.sg, lin,
                             (1 << g.linner) - 1}
                        : Tw{g.tab, 0, 0, l1, row, g.sg, 0};
      st_passes<RX, LN, 0, 5>(FromStage<T, Columns>{sr, si, stage}, wr, wi,
                              ImageColsSw{g.lc, LN}, g.lc + g.lg, nt, tw,
                              to_split<T, REVERSED>(g, k));
    } else {
      const RowsSw rows{g.p};
      const FromStage<T, Swizzled> in{sr, si, Swizzled{LN, lv, mask}};
      if constexpr (ROUTE == ST_TRANSPOSED) {
        st_passes<RX, LN, 0, 3>(in, wr, wi, rows, g.lg, nt,
                                Tw{g.tab, 0, 0, l1, row, g.sg, 0},
                                to_split<T, REVERSED>(g, k));
      } else {
        st_passes<RX, LN, 0, 3>(in, wr, wi, rows, g.lg, nt,
                                Tw{g.tab, 0, 0, 0, row, g.sg, 0},
                                ToShared<RowsSw>{wr, wi, rows});
        st_store_rows<LN, T>(g, k, wr, wi, rows);
      }
    }
  }
};

template <int RX, int LN, int ROUTE, int NT, class T>
__global__ void __launch_bounds__(NT, 1)
st_fft(const __grid_constant__ Geo g, int l1, long long row, int lin) {
  extern __shared__ float smem[];
  const int lv = chunk_log<T>(g);
  const int mask =
      (ROUTE == ST_ROWS || ROUTE == ST_TRANSPOSED) && LN - lv >= 3 ? 7 : 0;
  walk_tiles(g, TileCopy<T>{g, smem, lv, LN, mask},
             StRun<RX, LN, ROUTE, T>{g, smem, lv, mask, l1, row, lin});
}

using StLaunch = cudaError_t (*)(const Geo&, int, long long, int, unsigned,
                                 int, size_t, cudaStream_t);

template <int RX, int LN, int ROUTE, int NT, class T>
cudaError_t launch_st(const Geo& g, int l1, long long row, int lin,
                      unsigned blocks, int threads, size_t smem,
                      cudaStream_t st) {
  static int done[16];
  const cudaError_t e = allow_smem(st_fft<RX, LN, ROUTE, NT, T>, smem, done);
  if (e != cudaSuccess) return e;
  st_fft<RX, LN, ROUTE, NT, T><<<blocks, threads, smem, st>>>(g, l1, row,
                                                              lin);
  return cudaGetLastError();
}

template <int RX, int ROUTE, int FIRST, int NT, class T, int... L>
StLaunch st_for(int ln, std::integer_sequence<int, L...>) {
  static const StLaunch fns[] = {launch_st<RX, L + FIRST, ROUTE, NT, T>...};
  return fns[ln - FIRST];
}

// The kernel of a launch: rows up to 2^13 points a row with 512 threads,
// 2^14 with 1024; launch A's columns of 2^8 .. 2^10 points (8192-point
// tiles, 512 threads) or 2^11, 2^12 (16384, 1024), radix 4 the even ones;
// launch B's rows and columns of 2^7 .. 2^12 (columns 2^11, 2^12 at 1024
// threads); past 2^24 also launch 3's rows of 2^13 (512 threads) and 2^14
// (1024) and ST_MID's columns of 2^2 .. 2^10 (512 threads; radix 4 the
// even ones) and, radix 2, 2^11 (1024).  Null for any other.
template <int RX, class T>
StLaunch st_pick(int route, int ln, int threads) {
  if (route == ST_ROWS) {
    if (ln == 14)
      return threads == 1024 ? launch_st<RX, 14, ST_ROWS, 1024, T> : nullptr;
    return ln >= 1 && ln <= 13 && threads <= 512
               ? st_for<RX, ST_ROWS, 1, 512, T>(
                     ln, std::make_integer_sequence<int, 13>{})
               : nullptr;
  }
  if (route == ST_COLS) {
    if constexpr (RX == 4) {
      if (ln == 8 && threads <= 512) return launch_st<4, 8, ST_COLS, 512, T>;
      if (ln == 10 && threads <= 512)
        return launch_st<4, 10, ST_COLS, 512, T>;
      if (ln == 12) return launch_st<4, 12, ST_COLS, 1024, T>;
      return nullptr;
    } else {
      if (ln >= 8 && ln <= 10 && threads <= 512)
        return st_for<2, ST_COLS, 8, 512, T>(
            ln, std::make_integer_sequence<int, 3>{});
      if (ln >= 11 && ln <= 12)
        return st_for<2, ST_COLS, 11, 1024, T>(
            ln, std::make_integer_sequence<int, 2>{});
      return nullptr;
    }
  }
  if (route == ST_TRANSPOSED && ln >= 7 && ln <= 12 && threads <= 512)
    return st_for<RX, ST_TRANSPOSED, 7, 512, T>(
        ln, std::make_integer_sequence<int, 6>{});
  if (route == ST_TCOLS && ln >= 7 && ln <= 12) {
    if (threads <= 512)
      return ln <= 10 ? st_for<RX, ST_TCOLS, 7, 512, T>(
                            ln, std::make_integer_sequence<int, 4>{})
                      : nullptr;
    return ln == 11 ? launch_st<RX, 11, ST_TCOLS, 1024, T>
                    : launch_st<RX, 12, ST_TCOLS, 1024, T>;
  }
  if (route == ST_TRANSPOSED) {
    if (ln == 13 && threads <= 512)
      return launch_st<RX, 13, ST_TRANSPOSED, 512, T>;
    if (ln == 14 && threads == 1024)
      return launch_st<RX, 14, ST_TRANSPOSED, 1024, T>;
  }
  if (route == ST_MID) {
    if constexpr (RX == 4) {
      static const StLaunch even[] = {
          launch_st<4, 2, ST_MID, 512, T>, launch_st<4, 4, ST_MID, 512, T>,
          launch_st<4, 6, ST_MID, 512, T>, launch_st<4, 8, ST_MID, 512, T>,
          launch_st<4, 10, ST_MID, 512, T>};
      return ln >= 2 && ln <= 10 && !(ln & 1) && threads <= 512
                 ? even[ln / 2 - 1]
                 : nullptr;
    } else {
      if (ln >= 2 && ln <= 10 && threads <= 512)
        return st_for<2, ST_MID, 2, 512, T>(
            ln, std::make_integer_sequence<int, 9>{});
      return ln == 11 && threads == 1024
                 ? launch_st<2, 11, ST_MID, 1024, T>
                 : nullptr;
    }
  }
  return nullptr;
}

// One fused launch of radix RX x -> out over (outer, 2^ln, 2^linner) with
// the tiling the host planned (kernels/fft_stockham.py::plan,
// kernels/fft2d_fused.py::plan), fp32 or raw bf16 / float16 planes (store
// 0, 1, 2): the route, l1 (launch B, ST_MID: the bits of the launches
// before), lin (ST_COLS, ST_MID: log2 of the images' inner extent, 0 on
// rows; ST_TCOLS: linner), `scale` at the store, `blocks` the persistent
// grid; `tab` the radix's one table of the transform's sign `sg`.  A tile
// of 16384 points holds whole images only on columns.  Returns
// cudaErrorInvalidValue for a tiling it does not take.
template <int RX>
int stockham_pass(const void* xr, const void* xi, void* outr, void* outi,
                  const float* tab, long long outer, int ln, int linner,
                  int lc, int lg, int route, int l1, int lin, int blocks,
                  float scale, float sg, int store, cudaStream_t stream) {
  const int lp = ln + lc + lg;
  const bool rows = route == ST_ROWS || route == ST_TRANSPOSED;
  const bool after = route == ST_TRANSPOSED || route == ST_TCOLS ||
                     route == ST_MID;   // stages after launch A's
  // the whole transform's log2 length, for the radix-4 table's rows
  const int lnf = route == ST_COLS  ? ln + linner - lin
                  : route == ST_ROWS ? ln
                  : route == ST_MID  ? l1 + ln + linner - lin
                                     : l1 + ln;
  if (outer <= 0 || blocks <= 0 || ln < 1 || lc < 0 || lg < 0 || lp > 14 ||
      (1 << lp) < AXIS_TILE_MIN || (rows && lp == 14 && lg != 0) ||
      lin < 0 || lc > linner || (lc < linner && lg != 0) || route < ST_ROWS ||
      route > ST_MID || lnf > ST_LN_MAX ||
      (rows && (linner != 0 || lc != 0 || lin != 0)) ||
      (route == ST_COLS && (lg != 0 || lc >= linner || lin > linner)) ||
      (route == ST_TCOLS && (linner < 1 || lin != linner)) ||
      (route == ST_MID && (linner < 1 || lin > linner)) ||
      (after && (l1 < 1 || xr == outr || xi == outi)) ||
      (RX == 4 && (((route == ST_COLS || route == ST_MID) && (ln & 1)) ||
                   (after && (l1 & 1)))))
    return (int)cudaErrorInvalidValue;
  const int threads = 1 << (lp - 4);
  const StLaunch fn = by_store(store, [&](auto t) {
    return st_pick<RX, typename decltype(t)::type>(route, ln, threads);
  });
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
  const long long row = lnf >= 2 ? 1LL << (lnf - 2) : 0;
  Geo g{xr, xi, outr, outi, (const float2*)tab, nullptr, outer,
        per << (linner - lc), ln, linner, lc, lg, nbuf, (int)wf, p,
        sg, scale};
  g.lr1 = after ? l1 : 0;
  const unsigned grid = (unsigned)(g.tiles < blocks ? g.tiles : blocks);
  return (int)fn(g, l1, row, lin, grid, threads, smem, stream);
}

}  // namespace

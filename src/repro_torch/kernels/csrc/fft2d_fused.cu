// Batched complex 2-D FFT over (batch, h, w) split fp32, bf16 or float16
// planes, h and w powers of two >= 2, as two passes of fused radix-4
// Stockham stages over HBM: rows, then columns in place.
//
// Replaces the Pallas kernel repro/kernels/fft2d_fused.py::_fft2d_kernel,
// the algo="fused_stockham" oracle (plain version:
// repro_torch/kernels/fft2d_fused.py::fft2d_fused_plain).  The TPU kernel
// runs the mixed radix-4/radix-2 Stockham stages of
// repro_torch/core/fft1d.py::stockham_stages on the rows of a VMEM-resident
// (bb, h, w) tile, transposes the tile in VMEM, runs the same stages on
// the columns and transposes back.  A 1024^2 fp32 image is 8 MB against
// 227 KB of shared memory a block, so here the two passes are two
// launches (kernels/fft2d_fused.py::plan), each one pass over the planes.
//
// Bound on the card: bytes, 16 a complex point in and out (0.080 ms at
// 16x1024^2 on 3.35 TB/s); this design moves the planes twice (0.160 ms).
// What held the earlier design back was not the bytes but a barrier and
// a shared-memory round trip for every radix-4 stage, 4-way bank conflicts
// on the stage stores, 4096-point tiles copied synchronously, and 16-byte
// column segments.  So both launches run on fft_stockham's machinery
// (stockham.cuh) over axis_fft.cuh's tile walk:
//   rows     fft_stockham's rows route (stockham.cuh: ST_ROWS): tiles of
//            G whole rows (G*w <= 8192 points), double-buffered:
//            the next tile is copied in with cp.async while this one is
//            transformed; every stage of length w, two radix-4 stages a
//            pass in registers (16 points a thread) between barriers, the
//            radix-2 tail last for odd log2 w; stored as whole rows, 128
//            contiguous bytes a warp;
//   columns  tiles of C adjacent whole columns of h points (C = 8192/h, at
//            least 8, so 32-byte row segments, up to h = 2048 with one
//            16384-point buffer; C = 4 at h = 4096), or G whole images
//            where w < C; every stage of length h, the radix-2 tail
//            included; stored in place from registers, scaled by the
//            inverse's 1/(h*w).
// Longer axes take the 1-D kernel's routes (stockham.cuh), planned by
// kernels/fft2d_fused.py::plan: rows of w <= 2^14 one rows tile a row, of
// up to 2^24 its two launches (launch A on columns of the (rows, M, Q)
// view, launch B on rows stored transposed), columns of h <= 2^14 in
// 2- or 1-column tiles, of up to 2^24 the same two launches over the
// columns of the images (ST_COLS with q = column / w, ST_TCOLS storing
// (o, t*M + k, i)), and past 2^24 its three launches along either axis
// (n = M1 * M2 * Q: ST_COLS on the (., M1, M2*Q*w) view, ST_MID on the
// (.*M1, M2, Q*w) view with q = column / w, then ST_TRANSPOSED on rows or
// ST_TCOLS on columns of the (.*M1*M2, Q, w) view after l1 + l2 bits),
// x -> out -> scratch -> out, each one pass over the planes.
// bf16 and float16 planes are widened at the load and rounded to their
// dtype at each store.
// The butterflies are stockham_stages': radix-4 stage s of a length-n
// transform twiddles by w^r at entry (j >> 2s) << 2s of row r - 1 of the
// one (3, n/4) table (bit for bit row s of the reference's packed table;
// no four-step twiddle: it is a plain length-h transform), the tail has
// twiddle 1.  The rounding is stockham_stages' but for the order of a
// complex product's two fp32 products, as in fft_stockham.
#include "stockham.cuh"

namespace {

// One columns tile's stages, the table's rows `row` = n/4 entries long:
// C adjacent whole columns of one image, or G whole images, in the work
// layout ImageColsSw, stored from registers
template <int LN, class T>
struct S2Run {
  const Geo& g;
  float* smem;
  int row;
  __device__ __forceinline__ void operator()(long long k, int b) const {
    float* wr = smem + b * 2 * g.wf;
    float* wi = wr + g.wf;
    const T* sr = reinterpret_cast<const T*>(wr);
    const T* si = sr + (1 << (LN + g.lc + g.lg));
    const Columns stage{g.lc, 1 << (LN + g.lc), 1 << g.lc};
    st_passes<4, LN, 0, 5>(FromStage<T, Columns>{sr, si, stage}, wr, wi,
                           ImageColsSw{g.lc, LN}, g.lc + g.lg, blockDim.x,
                           Twiddle{g.tab, 0, 0, 0, row, g.sg, 0},
                           to_global<T>(g, k));
  }
};

template <int LN, int NT, class T>
__global__ void __launch_bounds__(NT, 1)
s2_fft(const __grid_constant__ Geo g, int row) {
  extern __shared__ float smem[];
  walk_tiles(g, TileCopy<T>{g, smem, chunk_log<T>(g), LN, 0},
             S2Run<LN, T>{g, smem, row});
}

using S2Launch = cudaError_t (*)(const Geo&, int, unsigned, int, size_t,
                                 cudaStream_t);

template <int LN, int NT, class T>
cudaError_t launch_s2(const Geo& g, int row, unsigned blocks, int threads,
                      size_t smem, cudaStream_t st) {
  static int done[16];
  const cudaError_t e = allow_smem(s2_fft<LN, NT, T>, smem, done);
  if (e != cudaSuccess) return e;
  s2_fft<LN, NT, T><<<blocks, threads, smem, st>>>(g, row);
  return cudaGetLastError();
}

template <int NT, class T, int... L>
S2Launch s2_for(int ln, std::integer_sequence<int, L...>) {
  static const S2Launch fns[] = {launch_s2<L + 1, NT, T>...};
  return fns[ln - 1];
}

// The kernel of a columns launch: columns of 2^1 .. 2^13 points (8192-
// point tiles, 512 threads: of 2^11 and more, whole images where w is
// narrow) or 2^11 .. 2^14 (16384-point tiles, 1024 threads).  Null for any
// other.
template <class T>
S2Launch s2_pick(int ln, int threads) {
  if (ln < 1 || ln > 14) return nullptr;
  if (threads <= 512)
    return ln <= 13 ? s2_for<512, T>(ln,
                                     std::make_integer_sequence<int, 13>{})
                    : nullptr;
  switch (ln) {
    case 11: return launch_s2<11, 1024, T>;
    case 12: return launch_s2<12, 1024, T>;
    case 13: return launch_s2<13, 1024, T>;
    case 14: return launch_s2<14, 1024, T>;
    default: return nullptr;
  }
}

}  // namespace

// One column launch x -> out of the view (outer, 2^ln, 2^linner) with the
// tiling the host planned (kernels/fft2d_fused.py::plan,
// axis_fft.plan_axis): tiles of 2^lc of the 2^linner columns, or, lc ==
// linner, 2^lg whole images, every stage of length 2^ln off `tab`, the
// fp32 (3, 2^ln / 4) table w, w^2, w^3 of the transform's sign
// (`inverse`) as (cos, sin) pairs; `scale` at the store; `blocks` the
// persistent grid; raw bf16 planes for store = 1, raw float16 for store =
// 2.  x and out may be the same planes; rows of up to 2^32 (THREE_MAX).
// Returns cudaErrorInvalidValue for a tiling it does not take.
extern "C" int fft2d_fused_pass(const void* xr, const void* xi, void* outr,
                                void* outi, const float* tab,
                                long long outer, int ln, int linner, int lc,
                                int lg, int blocks, float scale, int inverse,
                                int store, void* stream) {
  const int lp = ln + lc + lg;
  if (outer <= 0 || blocks <= 0 || ln < 1 || ln > 14 || lc < 0 || lg < 0 ||
      lc > linner || linner < 1 || linner > 32 || lp > 14 ||
      (1 << lp) < AXIS_TILE_MIN || (lc < linner && lg != 0))
    return (int)cudaErrorInvalidValue;
  const int threads = 1 << (lp - 4);
  const S2Launch fn = by_store(store, [&](auto t) {
    return s2_pick<typename decltype(t)::type>(ln, threads);
  });
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const long long wf = ((1LL << lp) + 31) / 32 * 32;
  const int nbuf = (1 << lp) <= AXIS_TILE ? 2 : 1;
  const size_t smem = (size_t)nbuf * 2 * sizeof(float) * wf;
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  const long long per = (outer + (1LL << lg) - 1) >> lg;
  const int row = ln >= 2 ? 1 << (ln - 2) : 0;
  const Geo g{xr, xi, outr, outi, (const float2*)tab, nullptr, outer,
              per << (linner - lc), ln, linner, lc, lg, nbuf, (int)wf, 0,
              inverse ? 1.f : -1.f, scale};
  const unsigned grid = (unsigned)(g.tiles < blocks ? g.tiles : blocks);
  return (int)fn(g, row, grid, threads, smem, (cudaStream_t)stream);
}

// One launch on the 1-D kernel's routes (stockham.cuh's
// stockham_pass<4>): the row pass (ST_ROWS, rows of up to 2^14), an axis past 2^14 as
// launches A (ST_COLS) and B (ST_TRANSPOSED on rows, ST_TCOLS on
// columns), or past 2^24 as launches 1 (ST_COLS), 2 (ST_MID) and 3
// (ST_TRANSPOSED, ST_TCOLS); l1 the bits of the launches before, lin log2
// of the images' inner extent (ST_COLS, ST_MID over columns; ST_TCOLS:
// linner), `tab` the axis' (3, n/4) table.
extern "C" int fft2d_fused_1d(const void* xr, const void* xi, void* outr,
                              void* outi, const float* tab, long long outer,
                              int ln, int linner, int lc, int lg, int route,
                              int l1, int lin, int blocks, float scale,
                              int inverse, int store, void* stream) {
  return stockham_pass<4>(xr, xi, outr, outi, tab, outer, ln, linner,
                                lc, lg, route, l1, lin, blocks, scale,
                                inverse ? 1.f : -1.f, store,
                                (cudaStream_t)stream);
}

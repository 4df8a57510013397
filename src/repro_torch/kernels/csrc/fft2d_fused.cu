// Batched complex 2-D FFT over (batch, h, w) split fp32 planes, h and w
// powers of two in [2, 4096], as two passes of fused radix-4 Stockham
// stages over HBM: rows, then columns in place.
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
//   rows     tiles of G whole rows (G*w <= 8192 points), double-buffered:
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
// The butterflies are stockham_stages': radix-4 stage s of a length-n
// transform twiddles by w^r at entry (j >> 2s) << 2s of row r - 1 of the
// one (3, n/4) table (bit for bit row s of the reference's packed table;
// no four-step twiddle: it is a plain length-h transform), the tail has
// twiddle 1.  The rounding is stockham_stages' but for the order of a
// complex product's two fp32 products, as in fft_stockham.
#include "stockham.cuh"

namespace {

enum { S2_ROWS = 0, S2_COLS = 1 };

// the work layout of a columns tile: element i of transform t = (image
// t >> lc, column t mod 2^lc) at swz((image * 2^ln + i) * 2^lc + column)
struct ImageColsSw {
  int lc, ln;
  __device__ __forceinline__ int at(int t, int i) const {
    return swz(((((t >> lc) << ln) + i) << lc) + (t & ((1 << lc) - 1)));
  }
};

// One tile's stages, the table's rows `row` = n/4 entries long
template <int LN, int ROUTE>
struct S2Run {
  const Geo& g;
  float* smem;
  int lv, mask, row;
  __device__ __forceinline__ void operator()(long long k, int b) const {
    float* wr = smem + b * 2 * g.wf;
    float* wi = wr + g.wf;
    const float* sr = wr;
    const float* si = sr + (1 << (LN + g.lc + g.lg));
    const int nt = blockDim.x;
    const Twiddle tw{g.tab, 0, 0, 0, row, g.sg};
    if constexpr (ROUTE == S2_COLS) {
      const Columns stage{g.lc, 1 << (LN + g.lc), 1 << g.lc};
      st_passes<4, LN, 0, 5>(FromStage<float, Columns>{sr, si, stage}, wr, wi,
                             ImageColsSw{g.lc, LN}, g.lc + g.lg, nt, tw,
                             to_global<float>(g, k));
    } else {
      const RowsSw rows{g.p};
      st_passes<4, LN, 0, 3>(
          FromStage<float, Swizzled>{sr, si, Swizzled{LN, lv, mask}}, wr, wi,
          rows, g.lg, nt, tw, ToShared<RowsSw>{wr, wi, rows});
      st_store_rows<LN>(g, k, wr, wi, rows);
    }
  }
};

template <int LN, int ROUTE, int NT>
__global__ void __launch_bounds__(NT, 1)
s2_fft(const __grid_constant__ Geo g, int row) {
  extern __shared__ float smem[];
  const int lv = chunk_log<float>(g);
  const int mask = ROUTE == S2_ROWS && LN - lv >= 3 ? 7 : 0;
  walk_tiles(g, TileCopy<float>{g, smem, lv, LN, mask},
             S2Run<LN, ROUTE>{g, smem, lv, mask, row});
}

using S2Launch = cudaError_t (*)(const Geo&, int, unsigned, int, size_t,
                                 cudaStream_t);

template <int LN, int ROUTE, int NT>
cudaError_t launch_s2(const Geo& g, int row, unsigned blocks, int threads,
                      size_t smem, cudaStream_t st) {
  static int done[16];
  const cudaError_t e = allow_smem(s2_fft<LN, ROUTE, NT>, smem, done);
  if (e != cudaSuccess) return e;
  s2_fft<LN, ROUTE, NT><<<blocks, threads, smem, st>>>(g, row);
  return cudaGetLastError();
}

template <int ROUTE, int NT, int... L>
S2Launch s2_for(int ln, std::integer_sequence<int, L...>) {
  static const S2Launch fns[] = {launch_s2<L + 1, ROUTE, NT>...};
  return fns[ln - 1];
}

// The kernel of a launch: rows of 2^1 .. 2^12 points (tiles of up to 8192
// points, 512 threads); columns of 2^1 .. 2^10 (8192, 512) or 2^11, 2^12
// (16384-point tiles, 1024 threads).  Null for any other.
S2Launch s2_pick(int route, int ln, int threads) {
  if (ln < 1 || ln > 12) return nullptr;
  if (route == S2_ROWS)
    return threads <= 512 ? s2_for<S2_ROWS, 512>(
                                ln, std::make_integer_sequence<int, 12>{})
                          : nullptr;
  if (route != S2_COLS) return nullptr;
  if (ln <= 10)
    return threads <= 512 ? s2_for<S2_COLS, 512>(
                                ln, std::make_integer_sequence<int, 10>{})
                          : nullptr;
  return threads == 1024 ? (ln == 11 ? launch_s2<11, S2_COLS, 1024>
                                     : launch_s2<12, S2_COLS, 1024>)
                         : nullptr;
}

}  // namespace

// One launch x -> out of the view (outer, 2^ln, 2^linner) with the tiling
// the host planned (kernels/fft2d_fused.py::plan, axis_fft.plan_axis):
// S2_ROWS (linner = 0: G = 2^lg rows a tile) or S2_COLS (tiles of 2^lc of
// the 2^linner columns, or, lc == linner, 2^lg whole images), every stage
// of length 2^ln off `tab`, the fp32 (3, 2^ln / 4) table w, w^2, w^3 of
// the transform's sign (`inverse`) as (cos, sin) pairs; `scale` at the
// store; `blocks` the persistent grid.  x and out may be the same planes.
// Returns cudaErrorInvalidValue for a tiling it does not take.
extern "C" int fft2d_fused_pass(const float* xr, const float* xi,
                                float* outr, float* outi, const float* tab,
                                long long outer, int ln, int linner, int lc,
                                int lg, int route, int blocks, float scale,
                                int inverse, void* stream) {
  const int lp = ln + lc + lg;
  const bool rows = route == S2_ROWS;
  if (outer <= 0 || blocks <= 0 || ln < 1 || ln > 12 || lc < 0 || lg < 0 ||
      lc > linner || linner > 12 || lp > 14 || (1 << lp) < AXIS_TILE_MIN ||
      (rows && (linner != 0 || lp > 13)) || (lc < linner && lg != 0))
    return (int)cudaErrorInvalidValue;
  const int threads = 1 << (lp - 4);
  const S2Launch fn = s2_pick(route, ln, threads);
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
  const int row = ln >= 2 ? 1 << (ln - 2) : 0;
  const Geo g{xr, xi, outr, outi, (const float2*)tab, nullptr, outer,
              per << (linner - lc), ln, linner, lc, lg, nbuf, (int)wf, p,
              inverse ? 1.f : -1.f, scale};
  const unsigned grid = (unsigned)(g.tiles < blocks ? g.tiles : blocks);
  return (int)fn(g, row, grid, threads, smem, (cudaStream_t)stream);
}

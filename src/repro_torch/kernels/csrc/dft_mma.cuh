// The plain-variant bfloat16 and float16 route of the 2-D and 3-D GEMM
// transforms (fft2d_gemm.cu, fft3d_fused.cu): every DFT product on the
// tensor cores, one pass over device memory an axis.
//
// Replaces, for variant="plain" in bf16 and float16, the Pallas kernels
// repro/kernels/fft2d_gemm.py::_fft2d_gemm_kernel and
// repro/kernels/fft3d_fused.py::_fft3d_kernel, whose arithmetic the plain
// versions (kernels/fft2d_gemm.py::fft2d_gemm_plain,
// kernels/fft3d_fused.py::fft3d_fused_plain) define: a one-level four-step
// split n = n1 * n2 of each axis (one dense DFT where n1 == 1), the tables
// rounded to the storage dtype, each complex DFT product (twiddle
// included) accumulated in fp32, and every product's output rounded to
// the storage dtype.  So every operand of every product is a bf16 (or
// float16) value, and mma.sync m16n8k16 with fp32 accumulators forms the
// same products; only the order of the fp32 sums differs.
//
// A DFT step is one real product: for the left contraction Z = W X of a
// length-f factor,
//     [Zr; Zi] = [[Wr, -Wi], [Wi, Wr]] [Xr; Xi]
// (negating a bf16 value is exact; the three-product form is not used,
// since Wr + Wi is no storage value).  The host builds the 2p x 2p table
// (p = f padded to a multiple of 8, rows padded to 16) in the storage dtype
// and in the A fragments' register order (kernels/dft_mma.py::frag_np), so
// a lane loads each 16x16 A fragment as one 16-byte load.  The data are
// the B operand, read from shared memory with ldmatrix.  Epilogues
// (finish), the plain versions' rounding points:
//   - the first step of a four-step axis: the twiddle T[k1, j2] applied
//     in fp32 to the accumulators, then rounded to the storage dtype;
//   - the last step: the inverse's 1/N in fp32 (last axis only), then
//     rounded, stored in the four-step order X[k2*n1 + k1].
//
// Bound on the card: bytes.  A pass moves 8 bytes a complex point (bf16 or
// float16 planes, read once and written once); the products are 8*(n1+n2)
// flops a point (a dense DFT 8n), 32-64 flops a byte at the main shapes
// against the tensor cores' ~295.  So an axis is one launch and one pass
// over device memory (dft_tile): a block copies its tile in with
// cp.async, runs both steps on it in shared memory (the rounded U of the
// first step never leaves it) and copies the tile out through shared
// memory in 16-byte stores; the second and third axes run in place in the
// output.  Blocks are persistent (two of 256 threads an SM where shared
// memory allows, else one of 512) and copy their next tile in while they
// transform one; a four-step axis' twiddle of up to 8192 points is copied
// to shared memory once a block.  The routes (kernels/dft_mma.py, the host
// plan, picks one an axis by shape; this file sizes its tiles):
//   ROUTE_ROWS  tiles of G whole rows of the contiguous last axis;
//   ROUTE_COLS  tiles of C adjacent columns of all n rows of an (n, inner)
//               image, every step a left contraction along the axis, so
//               no transpose is ever materialised;
//   ROUTE_LONG1, ROUTE_LONG2  an axis too long for a tile (the plan's
//               threshold: rows past 16384 points, columns past 2048):
//               each step its own launch (dft_gemm) through a scratch pair
//               in the storage dtype: the n1-point DFT with the twiddle
//               along the (outer, n1, n2*inner) view, then the n2-point DFT
//               of the (outer*n1, n2, inner) view stored at X[k2*n1 + k1].
//               A factor's table outgrows the L2 cache (128 MB at 4096
//               points), so these steps are tiled products with a loop
//               over the contraction: a block owns 64 output rows by 64
//               columns, its 8 warps 16 x 32 each, and walks the factor in
//               chunks of 32 data rows (cp.async, two buffers); every
//               factor of 16 points or more takes them.
// Shared-memory layouts swizzle their 16-byte chunks so that the eight
// rows of every ldmatrix phase fall on distinct banks.
#pragma once
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "f16.cuh"
#include "mma.cuh"

// Internal linkage: a library's template statics (allow's records) must
// not be merged with another library's by the dynamic linker.
namespace dm {
namespace {

typedef unsigned short half_t;  // the raw bits of a bf16 or float16 value

constexpr int NT = 512;         // most threads a tile block: 256 where two
                                // blocks share an SM, else 512
constexpr int NB = 4;           // n-tiles of 8 columns a warp's item
constexpr int SMEM_MAX = 232448;
constexpr int SM_SHARED = 233472;  // an SM's shared memory, 1 KB a block's
constexpr int TWIDDLE_SMEM = 8192;  // longest axis whose twiddle a block holds
constexpr int NONE = 30;        // a shift past every index
constexpr int GBM = 64, GBN = 64, GBK = 32;  // dft_gemm's rows, columns and
                                             // chunk depth a block
constexpr int GT = 256;         // dft_gemm's threads: 4 x 2 warps of 16 x 32

enum Route { ROUTE_ROWS = 0, ROUTE_COLS = 1, ROUTE_LONG1 = 2, ROUTE_LONG2 = 3 };

template <bool F16>
__device__ __forceinline__ float widen(half_t h) {
  return F16 ? cg::f16_to_f32(h) : cg::bf16_to_f32(h);
}
// lo and hi rounded to nearest even into one register (lo in the low
// half): one cvt on the card (a NaN comes out as the canonical NaN), the
// bit operations of bf16.cuh / f16.cuh elsewhere
template <bool F16>
__device__ __forceinline__ unsigned narrow2(float lo, float hi) {
#if defined(__CUDA_ARCH__)
  unsigned r;
  if (F16)
    asm("cvt.rn.f16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  else
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
#else
  const unsigned l = F16 ? cg::f32_to_f16(lo) : cg::f32_to_bf16(lo);
  const unsigned h = F16 ? cg::f32_to_f16(hi) : cg::f32_to_bf16(hi);
  return l | h << 16;
#endif
}

// The epilogue of an output pair (columns col and col + 1 of a row) from
// their fp32 sums re[e], im[e]: times the twiddle at (tr, ti) + o (its
// entries o and o + 1 where `adjacent`, else entry o for both; tr null:
// none), times scale, rounded.  {real pair, imaginary pair}, col's value
// in the low half.
template <bool F16>
__device__ __forceinline__ uint2 finish(const float* re, const float* im,
                                        const half_t* tr, const half_t* ti,
                                        int o, bool adjacent, float scale) {
  half_t twr[2], twi[2];
  if (tr != nullptr) {
    if (adjacent) {
      const unsigned ur = *reinterpret_cast<const unsigned*>(tr + o);
      const unsigned ui = *reinterpret_cast<const unsigned*>(ti + o);
      twr[0] = (half_t)ur, twr[1] = (half_t)(ur >> 16);
      twi[0] = (half_t)ui, twi[1] = (half_t)(ui >> 16);
    } else {
      twr[0] = twr[1] = tr[o];
      twi[0] = twi[1] = ti[o];
    }
  }
  float vr[2], vi[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float r = re[e], i = im[e];
    if (tr != nullptr) {
      const float wr = widen<F16>(twr[e]), wi = widen<F16>(twi[e]);
      const float nr = r * wr - i * wi;
      i = r * wi + i * wr;
      r = nr;
    }
    vr[e] = scale != 1.f ? r * scale : r;
    vi[e] = scale != 1.f ? i * scale : i;
  }
  return uint2{narrow2<F16>(vr[0], vr[1]), narrow2<F16>(vi[0], vi[1])};
}

// A tile's layout in one shared-memory plane, in elements.  Column
// layouts (COLS): row r of the axis holds 2^wc chunks of 8 columns; chunk
// q = r*2^wc + x/8 of element (r, x) is stored at q ^ (((q >> 3) ^
// (r >> lb)) & 7).  Line layouts: line g at g*pitch, its chunk q = p/8 of
// position p stored at q ^ ((q >> lw) & 7).
struct Lay {
  int pitch, lw;
  int wc, lb;
};

template <bool COLS>
__device__ __forceinline__ int at(const Lay& l, int a, int b) {
  if (COLS) {
    int q = (a << l.wc) + (b >> 3);
    q ^= ((q >> 3) ^ (a >> l.lb)) & 7;
    return (q << 3) + (b & 7);
  }
  int q = b >> 3;
  q ^= (q >> l.lw) & 7;
  return a * l.pitch + (q << 3) + (b & 7);
}

// An operand's element (j, col) in a layout's coordinates: COLS layouts
// row (col >> sh)*m + j*js, column col & (2^sh - 1); line layouts line
// col >> sh, position (col & (2^sh - 1))*m + j*js.
struct Opd {
  int sh, m, js;
};

template <bool COLS>
__device__ __forceinline__ int place(const Lay& l, const Opd& o, int j,
                                     int col) {
  const int hi = col >> o.sh, lo = col & ((1 << o.sh) - 1);
  return COLS ? at<true>(l, hi * o.m + j * o.js, lo)
              : at<false>(l, hi, lo * o.m + j * o.js);
}

// One DFT step of a tile: out(k, col) = sum_j W[k, j] in(j, col), f-point W.
struct Step {
  const uint4* a;          // the real table, fragment order
  const half_t *tr, *ti;   // the twiddle T (f, tn) or null
  int f, p;                // the length and its padding to a multiple of 8
  int ncol;                // columns held in shared memory
  Opd in, out;
  int tsh, tn;             // twiddle column (col >> tsh) & (tn - 1)
  float scale;
};

// One step from the plane pair `in` (im at +pin) into `out` (+pout), the
// twiddle read at (tr, ti) (the step's table or its copy in shared memory;
// null: none).  Warp items are 16 rows (a real and an imaginary A
// fragment) by NB n-tiles; each 16-deep chunk of the real 2p takes one
// ldmatrix x4 for two n-tiles and four mma.sync.
template <bool F16, bool TRANS, bool C>
__device__ void run_step(const Step& s, const Lay& li, const Lay& lo,
                         const half_t* in, int pin, half_t* out, int pout,
                         const half_t* tr, const half_t* ti,
                         const half_t* zero) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kcs = s.p >> 3;  // 16-deep chunks of the 2p real columns
  const int ntiles = (s.ncol + 7) >> 3;
  const int groups = (ntiles + NB - 1) / NB;
  const int items = ((s.f + 15) >> 4) * groups;
  const int q = lane >> 3, r = lane & 7;
  const bool pair = s.out.sh >= 1 && (C || s.out.m == 1);
  for (int item = warp; item < items; item += blockDim.x >> 5) {
    const int mb = item / groups, nt0 = (item % groups) * NB;
    float acc[NB][2][4];
#pragma unroll
    for (int t = 0; t < NB; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][0][i] = acc[t][1][i] = 0.f;
    const uint4* fa = s.a + (long long)(2 * mb) * kcs * 32 + lane;
    for (int kc = 0; kc < kcs; ++kc) {
      const uint4 fr = fa[kc * 32], fi = fa[(kcs + kc) * 32];
      const unsigned ar[4] = {fr.x, fr.y, fr.z, fr.w};
      const unsigned ai[4] = {fi.x, fi.y, fi.z, fi.w};
#pragma unroll
      for (int h = 0; h < NB / 2; ++h) {
        // this lane's row of the x4 load: matrices (k 0-7 | 8-15) x
        // (n-tile nt | nt + 1)
        const int nt = nt0 + 2 * h + (q >> 1);
        const int kk = kc * 16 + (q & 1) * 8 + (TRANS ? r : 0);
        const int im = kk >= s.p;
        const int j = kk - (im ? s.p : 0);
        const int col = nt * 8 + (TRANS ? 0 : r);
        const half_t* src = zero;
        if (nt < ntiles && j < s.f && col < s.ncol)
          src = in + (im ? pin : 0) + place<C>(li, s.in, j, col);
        unsigned b[4];
        cg::ldsm4<TRANS>(b, src);
        cg::mma<F16>(acc[2 * h][0], ar, b[0], b[1]);
        cg::mma<F16>(acc[2 * h][1], ai, b[0], b[1]);
        cg::mma<F16>(acc[2 * h + 1][0], ar, b[2], b[3]);
        cg::mma<F16>(acc[2 * h + 1][1], ai, b[2], b[3]);
      }
    }
    // accumulator (row g | g + 8, columns 2t, 2t + 1) of lane 4g + t
#pragma unroll
    for (int t = 0; t < NB; ++t) {
      const int col = (nt0 + t) * 8 + 2 * (lane & 3);
      if (col >= s.ncol) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int k = mb * 16 + (lane >> 2) + hh * 8;
        if (k >= s.f) continue;
        // the twiddle T[k, (col >> tsh) & (tn - 1)]; with tsh == 0 two
        // adjacent entries (col even)
        const uint2 v = finish<F16>(
            &acc[t][0][2 * hh], &acc[t][1][2 * hh], tr, ti,
            k * s.tn + ((col >> s.tsh) & (s.tn - 1)), s.tsh == 0, s.scale);
        const int d = place<C>(lo, s.out, k, col);
        if (pair) {
          *reinterpret_cast<unsigned*>(out + d) = v.x;
          *reinterpret_cast<unsigned*>(out + pout + d) = v.y;
        } else {
          out[d] = (half_t)v.x;
          out[pout + d] = (half_t)v.y;
          if (col + 1 < s.ncol) {
            const int d1 = place<C>(lo, s.out, k, col + 1);
            out[d1] = (half_t)(v.x >> 16);
            out[pout + d1] = (half_t)(v.y >> 16);
          }
        }
      }
    }
  }
}

// One launch of dft_tile.  Tile t's element (j, line) is at ib(t) + j*ijs
// + line*ils in x (read) and in y (written), ib(t) = (t >> is)*iha +
// (t & (2^is - 1))*ihc.
struct Args {
  const half_t *xr, *xi;
  half_t *yr, *yi;
  long long iha, ihc;
  int is;
  long long ijs, ils;
  int n;          // points a line
  int lines;      // lines a tile: G rows, or C columns (C >= 8)
  long long lmax; // row tiles: all rows; column tiles: an image's columns
  Lay lx, lu, ly; // the tile read, the first step's U, the output
  int plane0, plane1;  // elements a plane of an input buffer, of buffer 1
  int nbuf;       // input buffers: 2 overlap the next tile's copy
  int tws;        // elements of a twiddle plane in shared memory (or 0)
  long long tiles;
  int two;        // two steps (s1 then s2), else s2 alone
  Step s1, s2;
};

// Tile t's first element and its lines that hold data.
struct Tile {
  long long ib;
  int valid;
};

template <bool C>
__device__ __forceinline__ Tile tile(const Args& g, long long t) {
  Tile r;
  r.ib = (t >> g.is) * g.iha + (t & ((1LL << g.is) - 1)) * g.ihc;
  const long long left = C ? g.lmax : g.lmax - t * g.lines;
  r.valid = (int)(left < g.lines ? left : g.lines);
  return r;
}

// Copy the tile out of the plane pair at sr (im at + plane): 16-byte
// stores, or element by element for lines of 2 or 4 points and images of
// fewer than 8 columns.
template <bool C>
__device__ void copy_out(const Args& g, const half_t* sr, int plane,
                         const Tile& tl) {
  const int n = g.n;
  if (C) {  // n rows of g.lines columns
    const int wc = g.ly.wc, ch = 1 << wc;
    if (tl.valid >= 8) {
      for (int e = threadIdx.x; e < n * ch; e += blockDim.x) {
        const int r = e >> wc, c8 = (e & (ch - 1)) * 8;
        const int d = at<true>(g.ly, r, c8);
        const long long o = tl.ib + r * g.ijs + c8;
        *reinterpret_cast<uint4*>(g.yr + o) =
            *reinterpret_cast<const uint4*>(sr + d);
        *reinterpret_cast<uint4*>(g.yi + o) =
            *reinterpret_cast<const uint4*>(sr + plane + d);
      }
    } else {
      for (int e = threadIdx.x; e < n * 8; e += blockDim.x) {
        const int r = e >> 3, c = e & 7;
        if (c >= tl.valid) continue;
        const int d = at<true>(g.ly, r, c);
        const long long o = tl.ib + r * g.ijs + c;
        g.yr[o] = sr[d];
        g.yi[o] = sr[plane + d];
      }
    }
  } else if ((n & 7) == 0) {  // lines of n points
    const int per = n >> 3;
    for (int e = threadIdx.x; e < tl.valid * per; e += blockDim.x) {
      const int l = e / per, p8 = (e - l * per) * 8;
      const int d = at<false>(g.ly, l, p8);
      const long long o = tl.ib + l * g.ils + p8;
      *reinterpret_cast<uint4*>(g.yr + o) =
          *reinterpret_cast<const uint4*>(sr + d);
      *reinterpret_cast<uint4*>(g.yi + o) =
          *reinterpret_cast<const uint4*>(sr + plane + d);
    }
  } else {
    for (int e = threadIdx.x; e < tl.valid * n; e += blockDim.x) {
      const int l = e / n, p = e - l * n;
      const int d = at<false>(g.ly, l, p);
      const long long o = tl.ib + l * g.ils + p;
      g.yr[o] = sr[d];
      g.yi[o] = sr[plane + d];
    }
  }
}

// Copy tile `tl` into the plane pair at b (im at + g.plane0): 16-byte
// cp.async chunks, or element by element (zero-filled) for lines of 2 or 4
// points and images of fewer than 8 columns.
template <bool C>
__device__ void load(const Args& g, const Tile& tl, half_t* b) {
  const int n = g.n;
  if (C) {  // n rows of g.lines columns
    const int wc = g.lx.wc, ch = 1 << wc;
    if (tl.valid >= 8) {
      for (int e = threadIdx.x; e < n * ch; e += blockDim.x) {
        const int j = e >> wc, c8 = (e & (ch - 1)) * 8;
        const int d = at<true>(g.lx, j, c8);
        const long long o = tl.ib + j * g.ijs + c8;
        cg::cp16(b + d, g.xr + o, 16);
        cg::cp16(b + g.plane0 + d, g.xi + o, 16);
      }
    } else {
      for (int e = threadIdx.x; e < n * 8; e += blockDim.x) {
        const int j = e >> 3, c = e & 7;
        const int d = at<true>(g.lx, j, c);
        const long long o = tl.ib + j * g.ijs + c;
        b[d] = c < tl.valid ? g.xr[o] : (half_t)0;
        b[g.plane0 + d] = c < tl.valid ? g.xi[o] : (half_t)0;
      }
    }
  } else if (n >= 8) {  // g.lines lines of n points; past the last, zeros
    const int per = n >> 3;
    for (int e = threadIdx.x; e < g.lines * per; e += blockDim.x) {
      const int l = e / per, p8 = (e - l * per) * 8;
      const int d = at<false>(g.lx, l, p8);
      const bool in = l < tl.valid;
      const long long o = in ? tl.ib + l * g.ils + p8 : tl.ib;
      cg::cp16(b + d, g.xr + o, in ? 16 : 0);
      cg::cp16(b + g.plane0 + d, g.xi + o, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < g.lines * 8; e += blockDim.x) {
      const int l = e >> 3, p = e & 7;
      const int d = at<false>(g.lx, l, p);
      const bool in = l < tl.valid && p < n;
      const long long o = tl.ib + l * g.ils + p;
      b[d] = in ? g.xr[o] : (half_t)0;
      b[g.plane0 + d] = in ? g.xi[o] : (half_t)0;
    }
  }
}

// A persistent block walks tiles blockIdx.x, + gridDim.x, ...: with two
// input buffers (g.nbuf) the next tile's copy (cp.async) is in flight
// while the block runs this tile's steps and copies it out.  A four-step
// axis' twiddle is copied to shared memory once a block (g.tws).
template <bool F16, bool C>
__global__ void __launch_bounds__(NT) dft_tile(const Args g) {
  extern __shared__ uint4 dft_smem[];
  half_t* const xb = reinterpret_cast<half_t*>(dft_smem);
  half_t* const b1 = xb + 2 * g.nbuf * g.plane0;
  half_t* const tws = b1 + 2 * g.plane1;
  half_t* const zero = tws + 2 * g.tws;
  if (threadIdx.x < 8) zero[threadIdx.x] = 0;
  const half_t *tr = g.s1.tr, *ti = g.s1.ti;
  if (g.tws) {  // the twiddle's two (n1, n2) planes, 16-byte chunks
    const int per = g.tws / 8;
    for (int e = threadIdx.x; e < 2 * per; e += blockDim.x) {
      const int im = e >= per, k = 8 * (e - (im ? per : 0));
      cg::cp16(tws + (im ? g.tws : 0) + k, (im ? g.s1.ti : g.s1.tr) + k, 16);
    }
    tr = tws;
    ti = tws + g.tws;
  }
  long long t = blockIdx.x;
  if (t < g.tiles) load<C>(g, tile<C>(g, t), xb);
  cg::cp_commit();
  for (int i = 0; t < g.tiles; t += gridDim.x, ++i) {
    const Tile tl = tile<C>(g, t);
    half_t* const b0 = xb + 2 * (i % g.nbuf) * g.plane0;
    if (g.nbuf == 2) {
      if (t + gridDim.x < g.tiles)
        load<C>(g, tile<C>(g, t + gridDim.x),
                xb + 2 * ((i + 1) % 2) * g.plane0);
      cg::cp_commit();
      cg::cp_wait<1>();
    } else {
      if (i > 0) {
        load<C>(g, tl, b0);
        cg::cp_commit();
      }
      cg::cp_wait<0>();
    }
    __syncthreads();
    if (g.two) {  // U = T * (W1 X) into buffer 1, then W2 U into b0
      run_step<F16, true, C>(g.s1, g.lx, g.lu, b0, g.plane0, b1, g.plane1,
                             tr, ti, zero);
      __syncthreads();
      run_step<F16, C, C>(g.s2, g.lu, g.ly, b1, g.plane1, b0, g.plane0,
                          nullptr, nullptr, zero);
      __syncthreads();
      copy_out<C>(g, b0, g.plane0, tl);
    } else {
      run_step<F16, C, C>(g.s2, g.lx, g.ly, b0, g.plane0, b1, g.plane1,
                          nullptr, nullptr, zero);
      __syncthreads();
      copy_out<C>(g, b1, g.plane1, tl);
    }
    __syncthreads();
  }
}

// One long-axis step: out(img, k, c) = sum_j W[k, j] in(img, j, c) for an
// f-point W (f >= 16, a multiple of 16), in(img, j, c) at img*ihs + j*ijs
// + c*ics, out(img, k, c) at (img >> osh)*oha + (img & (2^osh - 1))*ohb +
// k*oks + c.
struct Gemm {
  const half_t *xr, *xi;
  half_t *yr, *yi;
  const uint4* a;          // the real table, fragment order (p = f)
  const half_t *tr, *ti;   // the twiddle T (f, tn) or null
  int f, tsh, tn;          // twiddle column (c >> tsh) & (tn - 1)
  long long cols;          // columns an image
  long long ihs, ijs, ics;
  long long oha, ohb, oks;
  int osh;
  long long cblocks;       // column blocks an image
  int rblocks;             // row blocks an image
  float scale;
};

// Chunk element (j, c) of a [GBK][GBN] plane: 8 chunks of 8 columns a row,
// chunk q stored at q ^ (j & 7), so an ldmatrix phase's eight rows fall on
// distinct banks.
__device__ __forceinline__ int gat(int j, int c) {
  return j * GBN + ((((c >> 3) ^ j) & 7) << 3) + (c & 7);
}

// Data rows j0 .. j0 + jn - 1 of the block's GBN columns from c0 into the
// plane pair at b (im at + GBK*GBN), zeros past the image's columns:
// 16-byte cp.async chunks where columns are contiguous, else element by
// element (consecutive threads along the contiguous index).
__device__ void gemm_load(const Gemm& m, long long base, int j0, int jn,
                          long long c0, half_t* b) {
  if (m.ics == 1 && m.cols >= 8) {
    for (int e = threadIdx.x; e < jn * (GBN / 8); e += blockDim.x) {
      const int j = e >> 3, c = (e & 7) * 8;
      const bool in = c0 + c < m.cols;
      const long long o = in ? base + (j0 + j) * m.ijs + c0 + c : base;
      cg::cp16(b + gat(j, c), m.xr + o, in ? 16 : 0);
      cg::cp16(b + GBK * GBN + gat(j, c), m.xi + o, in ? 16 : 0);
    }
    return;
  }
  for (int e = threadIdx.x; e < jn * GBN; e += blockDim.x) {
    const int j = m.ics == 1 ? e / GBN : e % jn;
    const int c = m.ics == 1 ? e % GBN : e / jn;
    const bool in = c0 + c < m.cols;
    const long long o = base + (j0 + j) * m.ijs + (c0 + c) * m.ics;
    b[gat(j, c)] = in ? m.xr[o] : (half_t)0;
    b[GBK * GBN + gat(j, c)] = in ? m.xi[o] : (half_t)0;
  }
}

// Block b computes rows GBM*rb .. + GBM - 1 by columns GBN*cb .. + GBN - 1
// of image img (b = (img*rblocks + rb)*cblocks + cb); warp w owns rows
// 16*(w & 3) .. + 15 by columns 32*(w >> 2) .. + 31 of them.  The
// contraction walks the factor in chunks of GBK data rows, the next
// chunk's copy in flight while a chunk's products run.  A chunk's
// products (64 real terms) sum on the tensor cores into fresh
// accumulators, which are added to the running sums on the CUDA cores:
// the tensor cores' own sums do not round to nearest, and over a whole
// factor of 1024 or 4096 points they moved outputs by two storage ulps
// from the plain version's.
template <bool F16>
__global__ void __launch_bounds__(GT) dft_gemm(const Gemm m) {
  __shared__ uint4 gemm_smem[2 * 2 * GBK * GBN / 8];
  half_t* const buf = reinterpret_cast<half_t*>(gemm_smem);
  const long long b = blockIdx.x;
  const long long cb = b % m.cblocks, rest = b / m.cblocks;
  const int rb = (int)(rest % m.rblocks);
  const long long img = rest / m.rblocks;
  const long long base = img * m.ihs, c0 = cb * GBN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mb = rb * (GBM / 16) + (warp & 3), grp = warp >> 2;
  const bool active = mb * 16 < m.f;
  const int q = lane >> 3, r = lane & 7;
  const int kcs = m.f >> 3;  // 16-deep chunks of the 2f real columns
  const uint4* fa = m.a + (long long)(2 * mb) * kcs * 32 + lane;
  float acc[NB][2][4];
#pragma unroll
  for (int t = 0; t < NB; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][0][i] = acc[t][1][i] = 0.f;
  const int chunks = (m.f + GBK - 1) / GBK;
  gemm_load(m, base, 0, m.f < GBK ? m.f : GBK, c0, buf);
  cg::cp_commit();
  for (int i = 0; i < chunks; ++i) {
    const int j0 = i * GBK, jn = m.f - j0 < GBK ? m.f - j0 : GBK;
    if (i + 1 < chunks) {
      const int j1 = j0 + GBK;
      gemm_load(m, base, j1, m.f - j1 < GBK ? m.f - j1 : GBK, c0,
                buf + ((i + 1) & 1) * 2 * GBK * GBN);
    }
    cg::cp_commit();
    cg::cp_wait<1>();
    __syncthreads();
    const half_t* const cur = buf + (i & 1) * 2 * GBK * GBN;
    if (active) {
      float sum[NB][2][4];
#pragma unroll
      for (int t = 0; t < NB; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[t][0][i] = sum[t][1][i] = 0.f;
      for (int s = 0; s < jn / 16; ++s) {
#pragma unroll
        for (int part = 0; part < 2; ++part) {  // the Xr rows, then Xi
          const int kc = part * (m.f >> 4) + (j0 >> 4) + s;
          const uint4 fr = fa[kc * 32], fi = fa[(kcs + kc) * 32];
          const unsigned ar[4] = {fr.x, fr.y, fr.z, fr.w};
          const unsigned ai[4] = {fi.x, fi.y, fi.z, fi.w};
#pragma unroll
          for (int h = 0; h < NB / 2; ++h) {
            const int nt = grp * NB + 2 * h + (q >> 1);
            unsigned bb[4];
            cg::ldsm4<true>(bb, cur + part * GBK * GBN +
                                    gat(s * 16 + (q & 1) * 8 + r, nt * 8));
            cg::mma<F16>(sum[2 * h][0], ar, bb[0], bb[1]);
            cg::mma<F16>(sum[2 * h][1], ai, bb[0], bb[1]);
            cg::mma<F16>(sum[2 * h + 1][0], ar, bb[2], bb[3]);
            cg::mma<F16>(sum[2 * h + 1][1], ai, bb[2], bb[3]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < NB; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[t][0][i] += sum[t][0][i];
          acc[t][1][i] += sum[t][1][i];
        }
    }
    __syncthreads();
  }
  if (!active) return;
  const long long ob = (img >> m.osh) * m.oha +
                       (img & ((1LL << m.osh) - 1)) * m.ohb;
#pragma unroll
  for (int t = 0; t < NB; ++t) {
    const long long col = c0 + (grp * NB + t) * 8 + 2 * (lane & 3);
    if (col >= m.cols) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int k = mb * 16 + (lane >> 2) + hh * 8;
      if (k >= m.f) continue;
      const uint2 v = finish<F16>(
          &acc[t][0][2 * hh], &acc[t][1][2 * hh], m.tr, m.ti,
          k * m.tn + (int)((col >> m.tsh) & (m.tn - 1)), m.tsh == 0,
          m.scale);
      const long long o = ob + k * m.oks + col;
      *reinterpret_cast<unsigned*>(m.yr + o) = v.x;
      *reinterpret_cast<unsigned*>(m.yi + o) = v.y;
    }
  }
}

// -- host side -----------------------------------------------------------

inline int lg(long long v) {
  int s = 0;
  while ((1LL << s) < v) ++s;
  return s;
}

inline bool pow2(long long v) { return v >= 1 && (v & (v - 1)) == 0; }

// x rounded up to a multiple of 8 whose count of 8s is odd: line pitches
// whose eight rows of an ldmatrix phase fall on distinct banks
inline int odd8(int x) {
  int c = (x + 7) / 8;
  if (c % 2 == 0) ++c;
  return 8 * c;
}

inline int r64(long long x) { return (int)((x + 63) / 64 * 64); }

inline Step dense(int f, int ncol, Opd in, Opd out) {
  Step st{};
  st.f = f;
  st.p = f < 8 ? 8 : f;
  st.ncol = ncol;
  st.in = in;
  st.out = out;
  st.tsh = 0;
  st.tn = 1;
  st.scale = 1.f;
  return st;
}

// What a launch takes on the card: dynamic shared memory a block, threads
// a block, blocks, and the tiles (dft_tile) or block tiles (dft_gemm) the
// blocks walk.
struct Geometry {
  int smem, nbuf, threads;
  long long blocks, tiles;
};

// The tiles of a rows (ROUTE_ROWS) or columns (ROUTE_COLS) launch over
// the (outer, n, inner) view, n = n1 * n2 (n1 == 1: one dense DFT), tiles
// of `lines` lines (G rows, or C >= 8 columns), on `sms` SMs: g's strides,
// layouts and steps (no pointers) and the launch's geometry.  Two input
// buffers where they fit (else one), and the twiddle of a four-step axis
// of up to TWIDDLE_SMEM points in shared memory.
inline cudaError_t tile_plan(int route, long long outer, int n,
                             long long inner, int n1, int lines, int sms,
                             Args& g, Geometry& geo) {
  const int n2 = n / n1;
  g = Args{};
  g.n = n;
  g.lines = lines;
  if (n1 > 1 && (n1 < 16 || n2 < 16)) return cudaErrorInvalidValue;
  g.two = n1 > 1;
  if (route == ROUTE_ROWS) {  // G = lines rows of n points
    if (inner != 1) return cudaErrorInvalidValue;
    g.tiles = (outer + lines - 1) / lines;
    g.is = 0;
    g.iha = (long long)lines * n;
    g.ijs = 1;
    g.ils = n;
    g.lmax = outer;
    if (g.two) {
      g.lx = g.lu = Lay{n, lg(n2 / 8), 0, 0};
      g.ly = Lay{n, lg(n1 / 8), 0, 0};
      g.plane0 = g.plane1 = r64((long long)lines * n);
      g.s1 = dense(n1, lines * n2, Opd{lg(n2), 1, n2}, Opd{lg(n2), 1, n2});
      g.s2 = dense(n2, lines * n1, Opd{lg(n1), n2, 1}, Opd{lg(n1), 1, n1});
    } else {
      g.lx = Lay{odd8(n < 8 ? 8 : n), NONE, 0, 0};
      g.ly = Lay{odd8(n), NONE, 0, 0};
      g.plane0 = r64((long long)lines * g.lx.pitch);
      g.plane1 = r64((long long)lines * g.ly.pitch);
      g.s2 = dense(n, lines, Opd{0, 0, 1}, Opd{0, 0, 1});
    }
  } else if (route == ROUTE_COLS) {
    // tiles of C = lines adjacent columns of all n rows of an image
    if (lines < 8 || (inner >= 8 && inner < lines))
      return cudaErrorInvalidValue;
    const long long per = inner > lines ? inner / lines : 1;
    g.tiles = outer * per;
    g.is = lg(per);
    g.iha = (long long)n * inner;
    g.ihc = lines;
    g.ijs = inner;
    g.ils = 1;
    g.lmax = inner;
    const int wc = lg(lines / 8), lc = lg(lines);
    g.plane0 = g.plane1 = r64((long long)n * lines);
    if (g.two) {
      g.lx = g.lu = Lay{0, 0, wc, lg(n2)};
      g.ly = Lay{0, 0, wc, lg(n1)};
      g.s1 = dense(n1, n2 * lines, Opd{lc, 1, n2}, Opd{lc, 1, n2});
      g.s1.tsh = lc;
      g.s2 = dense(n2, n1 * lines, Opd{lc, n2, 1}, Opd{lc, 1, n1});
    } else {
      g.lx = g.ly = Lay{0, 0, wc, NONE};
      g.s2 = dense(n, lines, Opd{lc, 0, 1}, Opd{lc, 0, 1});
    }
  } else {
    return cudaErrorInvalidValue;
  }
  g.s1.tn = g.two ? n2 : 1;
  g.tws = g.two && n <= TWIDDLE_SMEM ? n : 0;
  const long long one = 4LL * (g.plane0 + g.plane1 + g.tws) + 16;
  g.nbuf = one + 4LL * g.plane0 <= SMEM_MAX ? 2 : 1;
  const long long smem = one + 4LL * (g.nbuf - 1) * g.plane0;
  if (smem > SMEM_MAX || g.tiles <= 0) return cudaErrorInvalidValue;
  // two blocks of 256 threads an SM where their shared memory fits, else
  // one of 512: 16 warps an SM either way (at most 128 registers a thread)
  const bool twice = SM_SHARED / (smem + 1024) >= 2;
  geo.smem = (int)smem;
  geo.nbuf = g.nbuf;
  geo.threads = twice ? NT / 2 : NT;
  geo.tiles = g.tiles;
  const long long most = (long long)sms * (twice ? 2 : 1);
  geo.blocks = g.tiles < most ? g.tiles : most;
  return cudaSuccess;
}

// The product of a long-axis step (ROUTE_LONG1: the n1-point DFT and the
// twiddle along the (outer, n1, n2*inner) view; ROUTE_LONG2: the n2-point
// DFT of the (outer*n1, n2, inner) view stored at X[k2*n1 + k1], its
// images of one column (inner == 1) folded into the columns of an
// (outer, n2, n1) view): m's strides (no pointers) and its geometry.
inline cudaError_t gemm_plan(int route, long long outer, int n,
                             long long inner, int n1, Gemm& m,
                             Geometry& geo) {
  const int n2 = n / n1;
  m = Gemm{};
  long long images;
  if (n1 < 16 || n2 < 16) return cudaErrorInvalidValue;
  if (route == ROUTE_LONG1) {
    images = outer;
    m.f = n1;
    m.cols = (long long)n2 * inner;
    m.ihs = m.oha = (long long)n * inner;
    m.ijs = m.oks = m.cols;
    m.ics = 1;
    m.tn = n2;
    m.tsh = lg(inner);
  } else if (route == ROUTE_LONG2 && inner > 1) {
    images = outer * n1;
    m.f = n2;
    m.cols = inner;
    m.ihs = (long long)n2 * inner;
    m.ijs = inner;
    m.ics = 1;
    m.osh = lg(n1);
    m.oha = (long long)n * inner;
    m.ohb = inner;
    m.oks = (long long)n1 * inner;
  } else if (route == ROUTE_LONG2) {
    images = outer;
    m.f = n2;
    m.cols = n1;
    m.ihs = m.oha = n;
    m.ijs = 1;
    m.ics = n2;
    m.oks = n1;
  } else {
    return cudaErrorInvalidValue;
  }
  m.tn = m.tn ? m.tn : 1;
  m.scale = 1.f;
  m.cblocks = (m.cols + GBN - 1) / GBN;
  m.rblocks = (m.f + GBM - 1) / GBM;
  geo.smem = 0;  // static: two chunks of two planes
  geo.nbuf = 2;
  geo.threads = GT;
  geo.tiles = geo.blocks = images * m.rblocks * m.cblocks;
  return geo.blocks < (1LL << 31) ? cudaSuccess : cudaErrorInvalidValue;
}

inline cudaError_t plan(int route, long long outer, int n, long long inner,
                        int n1, int lines, int sms, Args& g, Gemm& m,
                        Geometry& geo) {
  if (outer <= 0 || !pow2(inner) || n < 2 || !pow2(n) || !pow2(n1) ||
      n % n1 || (route < ROUTE_LONG1 && !pow2(lines)) || sms < 1)
    return cudaErrorInvalidValue;
  return route >= ROUTE_LONG1 ? gemm_plan(route, outer, n, inner, n1, m, geo)
                              : tile_plan(route, outer, n, inner, n1, lines,
                                          sms, g, geo);
}

// Raise `kernel`'s dynamic shared memory limit to `bytes` on the current
// device once; `done` is the instance's own record of what it allows.
template <class K>
cudaError_t allow(K kernel, int bytes, int* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 16 && done[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < 16) done[dev] = bytes;
  return e;
}

template <bool F16, bool C>
cudaError_t start(const Args& g, const Geometry& geo, cudaStream_t s) {
  static int done[16];
  const cudaError_t e = allow(dft_tile<F16, C>, geo.smem, done);
  if (e != cudaSuccess) return e;
  dft_tile<F16, C><<<(unsigned)geo.blocks, geo.threads, geo.smem, s>>>(g);
  return cudaGetLastError();
}

// The geometry of one launch of the host plan (kernels/dft_mma.py): out =
// {dynamic shared memory a block, input buffers, threads a block, blocks,
// tiles}.  The arguments as dft_launch's.
inline cudaError_t dft_geometry(int route, long long outer, int n,
                                long long inner, int n1, int lines, int sms,
                                long long* out) {
  Args g;
  Gemm m;
  Geometry geo{};
  const cudaError_t e =
      plan(route, outer, n, inner, n1, lines, sms, g, m, geo);
  if (e != cudaSuccess) return e;
  out[0] = geo.smem;
  out[1] = geo.nbuf;
  out[2] = geo.threads;
  out[3] = geo.blocks;
  out[4] = geo.tiles;
  return cudaSuccess;
}

// One launch of the host plan (kernels/dft_mma.py): `route` over the
// (outer, n, inner) view of the planes x (read) and y (written), n = n1 *
// n2 (n1 == 1: one dense DFT), tiles of `lines` lines (the tile routes),
// on `sms` SMs; a1, the twiddle (tr, ti) and a2 are the axis' tables (a2
// alone where n1 == 1), `scale` the last step's factor.
inline cudaError_t dft_launch(const void* xr, const void* xi, void* yr,
                              void* yi, const void* a1, const void* tr,
                              const void* ti, const void* a2, int route,
                              long long outer, int n, long long inner,
                              int n1, int lines, int sms, float scale,
                              int f16, cudaStream_t stream) {
  Args g;
  Gemm m;
  Geometry geo{};
  const cudaError_t e =
      plan(route, outer, n, inner, n1, lines, sms, g, m, geo);
  if (e != cudaSuccess) return e;
  const half_t* const twr = static_cast<const half_t*>(tr);
  const half_t* const twi = static_cast<const half_t*>(ti);
  if (route >= ROUTE_LONG1) {
    m.xr = static_cast<const half_t*>(xr);
    m.xi = static_cast<const half_t*>(xi);
    m.yr = static_cast<half_t*>(yr);
    m.yi = static_cast<half_t*>(yi);
    if (route == ROUTE_LONG1) {
      m.a = static_cast<const uint4*>(a1);
      m.tr = twr;
      m.ti = twi;
    } else {
      m.a = static_cast<const uint4*>(a2);
      m.scale = scale;
    }
    if (f16)
      dft_gemm<true><<<(unsigned)geo.blocks, GT, 0, stream>>>(m);
    else
      dft_gemm<false><<<(unsigned)geo.blocks, GT, 0, stream>>>(m);
    return cudaGetLastError();
  }
  g.xr = static_cast<const half_t*>(xr);
  g.xi = static_cast<const half_t*>(xi);
  g.yr = static_cast<half_t*>(yr);
  g.yi = static_cast<half_t*>(yi);
  if (g.two) {
    g.s1.a = static_cast<const uint4*>(a1);
    g.s1.tr = twr;
    g.s1.ti = twi;
  }
  g.s2.a = static_cast<const uint4*>(a2);
  g.s2.scale = scale;
  const bool c = route == ROUTE_COLS;
  if (f16)
    return c ? start<true, true>(g, geo, stream)
             : start<true, false>(g, geo, stream);
  return c ? start<false, true>(g, geo, stream)
           : start<false, false>(g, geo, stream);
}

}  // namespace
}  // namespace dm

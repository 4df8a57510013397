// Batched complex 2-D FFT over (batch, h, w) split fp32 planes, h and w
// powers of two in [2, 4096], as two shared-memory Stockham passes.
//
// Replaces the Pallas kernel repro/kernels/fft2d_fused.py::_fft2d_kernel,
// the algo="fused_stockham" oracle (plain version:
// repro_torch/kernels/fft2d_fused.py::fft2d_fused_plain).  The TPU kernel
// runs the mixed radix-4/radix-2 Stockham stages of
// repro_torch/core/fft1d.py::stockham_stages on the rows of a VMEM-resident
// (bb, h, w) tile, transposes the tile in VMEM, runs the same stages on
// the columns and transposes back.  A 1024^2 fp32 image is 8 MB against
// 227 KB of shared memory a block, so here the two passes are two
// launches, each holding a tile of TILE points on chip for all its stages:
//   rows     a block loads TILE/w whole rows (coalesced), runs every stage
//            in shared memory with a barrier each, stores into out;
//   columns  a block loads c = TILE/h adjacent columns of one image
//            (c-float segments of each row), runs the same stages along h
//            in shared memory and stores the tile back in place, scaled by
//            the inverse's 1/(h*w).  The transpose is the indexing: element
//            i of column l sits at i*c + l, so neighbouring threads take
//            neighbouring columns of one butterfly and share its twiddle.
// Stage arithmetic is stockham_stages': radix-4 stage s reads the four
// quarter slices, twiddles by row s of the packed (s4, 3, n/4) table and
// stores at the autosort positions; the radix-2 tail runs last (twiddle 1).
// TILE = 4096 points is 64 KB of ping-pong planes, three blocks an SM.
// Bound on the card: bytes (16 per complex point in and out, 0.080 ms at
// 16x1024^2); this design moves the planes twice (0.160 ms), and its
// column segments are c floats wide (16 bytes at h = 1024).
#include <cuda_runtime.h>

namespace {

constexpr int NT = 512;      // threads a block
constexpr int TILE = 4096;   // complex points a block holds
constexpr int MAX_DIM = 4096;

// Element i of line l of the block's tile sits at l*ls + i*es.  Thread
// index t maps to (line, butterfly j) with the line fastest (columns) or
// the butterfly fastest (rows).
struct Lines {
  int count, lcount, ls, es;
  bool line_fast;
  __device__ __forceinline__ void split(int t, int lj, int& l, int& j) const {
    if (line_fast) {
      l = t & (count - 1);
      j = t >> lcount;
    } else {
      l = t >> lj;
      j = t & ((1 << lj) - 1);
    }
  }
};

// One radix-4 stage over every line of n = 4q points, s -> d; w points at
// the stage's table row, (w1, w2, w3) at j, q + j, 2q + j; stride = 4^st.
__device__ __forceinline__ void r4(const float* sr, const float* si,
                                   float* dr, float* di,
                                   const float* __restrict__ wr,
                                   const float* __restrict__ wi,
                                   const Lines& ln_, int lq, int lstride,
                                   int inverse) {
  const int q = 1 << lq, stride = 1 << lstride;
  for (int t = threadIdx.x; t < ln_.count * q; t += NT) {
    int l, j;
    ln_.split(t, lq, l, j);
    const int b = l * ln_.ls, es = ln_.es;
    const float a0r = sr[b + j * es], a1r = sr[b + (j + q) * es];
    const float a2r = sr[b + (j + 2 * q) * es], a3r = sr[b + (j + 3 * q) * es];
    const float a0i = si[b + j * es], a1i = si[b + (j + q) * es];
    const float a2i = si[b + (j + 2 * q) * es], a3i = si[b + (j + 3 * q) * es];
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
    const float w1r = wr[j], w2r = wr[q + j], w3r = wr[2 * q + j];
    const float w1i = wi[j], w2i = wi[q + j], w3i = wi[2 * q + j];
    const float b1r = y1r * w1r - y1i * w1i, b1i = y1r * w1i + y1i * w1r;
    const float b2r = y2r * w2r - y2i * w2i, b2i = y2r * w2i + y2i * w2r;
    const float b3r = y3r * w3r - y3i * w3i, b3i = y3r * w3i + y3i * w3r;
    // autosort store: j = p*stride + k  ->  p*4*stride + r*stride + k
    const int o = ((j >> lstride) << (lstride + 2)) + (j & (stride - 1));
    dr[b + o * es] = y0r;                 di[b + o * es] = y0i;
    dr[b + (o + stride) * es] = b1r;      di[b + (o + stride) * es] = b1i;
    dr[b + (o + 2 * stride) * es] = b2r;  di[b + (o + 2 * stride) * es] = b2i;
    dr[b + (o + 3 * stride) * es] = b3r;  di[b + (o + 3 * stride) * es] = b3i;
  }
}

// The radix-2 tail over every line of n = 2h points: (a + b, a - b) of the
// contiguous halves.
__device__ __forceinline__ void r2(const float* sr, const float* si,
                                   float* dr, float* di, const Lines& ln_,
                                   int lh) {
  const int h = 1 << lh;
  for (int t = threadIdx.x; t < ln_.count * h; t += NT) {
    int l, j;
    ln_.split(t, lh, l, j);
    const int i = l * ln_.ls + j * ln_.es, k = i + h * ln_.es;
    const float ar = sr[i], ai = si[i], br = sr[k], bi = si[k];
    dr[i] = ar + br; di[i] = ai + bi;
    dr[k] = ar - br; di[k] = ai - bi;
  }
}

// Every stage on lines of n = 2^ln points, ping-ponging between (ar, ai)
// and (br, bi); returns with the result in (ar, ai).
__device__ __forceinline__ void stages(float*& ar, float*& ai, float*& br,
                                       float*& bi,
                                       const float* __restrict__ wr,
                                       const float* __restrict__ wi, int ln,
                                       const Lines& lines, int inverse) {
  const int s4 = ln / 2;
  for (int st = 0; st < s4; ++st) {
    const int q3 = 3 << (ln - 2);
    r4(ar, ai, br, bi, wr + st * q3, wi + st * q3, lines, ln - 2, 2 * st,
       inverse);
    __syncthreads();
    float* t = ar; ar = br; br = t;
    t = ai; ai = bi; bi = t;
  }
  if (ln & 1) {
    r2(ar, ai, br, bi, lines, ln - 1);
    __syncthreads();
    float* t = ar; ar = br; br = t;
    t = ai; ai = bi; bi = t;
  }
}

// Row pass: block b holds rows [b*lines, b*lines + lines) of `rows` rows of
// w = 2^lw points (a ragged last block loads zeros and stores nothing).
__global__ void __launch_bounds__(NT)
rows_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
            float* __restrict__ yr, float* __restrict__ yi,
            const float* __restrict__ wr, const float* __restrict__ wi,
            long long rows, int lw, int lines, int inverse) {
  extern __shared__ float sm[];
  const int w = 1 << lw, pts = lines * w;
  float *ar = sm, *ai = sm + pts, *br = sm + 2 * pts, *bi = sm + 3 * pts;
  const long long r0 = (long long)blockIdx.x * lines;
  const long long left = rows - r0;
  const int valid = (int)((left < lines ? left : lines) * w);
  const long long base = r0 * w;
  for (int e = threadIdx.x; e < pts; e += NT) {
    ar[e] = e < valid ? xr[base + e] : 0.f;
    ai[e] = e < valid ? xi[base + e] : 0.f;
  }
  __syncthreads();
  const Lines ln_{lines, 0, w, 1, false};
  stages(ar, ai, br, bi, wr, wi, lw, ln_, inverse);
  for (int e = threadIdx.x; e < valid; e += NT) {
    yr[base + e] = ar[e];
    yi[base + e] = ai[e];
  }
}

// Column pass, in place: block b holds columns [c0, c0 + c) of image
// b / (w / c), c = 2^lc, as an (h, c) tile with element i of column l at
// i*c + l; the store is scaled by `scale`.
__global__ void __launch_bounds__(NT)
cols_kernel(float* __restrict__ yr, float* __restrict__ yi,
            const float* __restrict__ wr, const float* __restrict__ wi,
            int lh, int lw, int lc, int inverse, float scale) {
  extern __shared__ float sm[];
  const int h = 1 << lh, c = 1 << lc, pts = h * c;
  float *ar = sm, *ai = sm + pts, *br = sm + 2 * pts, *bi = sm + 3 * pts;
  const long long tiles = 1LL << (lw - lc);
  const long long img = blockIdx.x / tiles;
  const long long base = (img << (lh + lw)) + ((blockIdx.x % tiles) << lc);
  for (int e = threadIdx.x; e < pts; e += NT) {
    const long long g = base + ((long long)(e >> lc) << lw) + (e & (c - 1));
    ar[e] = yr[g];
    ai[e] = yi[g];
  }
  __syncthreads();
  const Lines ln_{c, lc, 1, c, true};
  stages(ar, ai, br, bi, wr, wi, lh, ln_, inverse);
  for (int e = threadIdx.x; e < pts; e += NT) {
    const long long g = base + ((long long)(e >> lc) << lw) + (e & (c - 1));
    yr[g] = ar[e] * scale;
    yi[g] = ai[e] * scale;
  }
}

int log2i(int v) {
  int s = 0;
  while ((1 << s) < v) ++s;
  return s;
}

}  // namespace

// x (batch, h, w) -> out, fp32 planes; (wwr, wwi) and (whr, whi) are the
// packed (s4, 3, n/4) Stockham tables of w and h.
extern "C" int fft2d_fused_f32(const float* xr, const float* xi, float* outr,
                               float* outi, const float* wwr,
                               const float* wwi, const float* whr,
                               const float* whi, long long batch, int h,
                               int w, int inverse, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (batch <= 0 || h < 2 || w < 2 || h > MAX_DIM || w > MAX_DIM ||
      (h & (h - 1)) || (w & (w - 1)))
    return (int)cudaErrorInvalidValue;
  const int lh = log2i(h), lw = log2i(w);
  const long long rows = batch * h;
  const int lines = (int)(TILE / w < rows ? TILE / w : rows);
  const long long row_blocks = (rows + lines - 1) / lines;
  const int c = TILE / h < w ? TILE / h : w;
  const long long col_blocks = batch * (w / c);
  if (row_blocks > 2147483647LL || col_blocks > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int row_smem = 16 * lines * w, col_smem = 16 * h * c;
  cudaError_t e = cudaFuncSetAttribute(
      rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, row_smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(cols_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           col_smem);
  if (e != cudaSuccess) return (int)e;
  rows_kernel<<<(unsigned)row_blocks, NT, row_smem, s>>>(
      xr, xi, outr, outi, wwr, wwi, rows, lw, lines, inverse);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float scale = inverse ? (float)(1.0 / ((double)h * w)) : 1.f;
  cols_kernel<<<(unsigned)col_blocks, NT, col_smem, s>>>(
      outr, outi, whr, whi, lh, lw, log2i(c), inverse, scale);
  return (int)cudaGetLastError();
}
